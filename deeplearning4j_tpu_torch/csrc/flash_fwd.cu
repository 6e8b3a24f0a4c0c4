// Flash-attention forward for Hopper (sm_90a): the online-softmax attention of one query tile
// against every key tile, O and the per-row log-sum-exp out, no Sq x Sk matrix in device memory.
//
// Replaces the TPU kernel of the JAX package:
//   deeplearning4j_tpu/ops/attention.py::_flash_fwd_kernel (launched by _flash_fwd_pallas)
// The TPU kernel runs on grid (B*H, Sq/bq, Sk/bk) with the key-block axis sequential, carrying the
// running max m, sum l and the fp32 accumulator in VMEM scratch from one grid step to the next.
// Here one block owns (b*h, a tile of 64 query rows) and loops over the key tiles itself, with m,
// l and the accumulator in registers; blocks of a grid share nothing.
//
// What it computes, for q (B, H, Sq, D) and k, v (B, H, Sk, D), D a multiple of 8 up to 128:
//   s = (q . k) * scale in fp32; causal: s = NEG_BIG where key > query + (Sk - Sq); padding mask
//   (B, Sk) float: s = NEG_BIG where mask[b][key] <= 0 (b = bh / H, the head folded away as in
//   the TPU kernel's index map); m' = max(m, max_j s), corr = exp(m - m'),
//   p = exp(s - m') and p = 0 where s <= NEG_BIG / 2 (a fully-masked row keeps l = 0),
//   l' = corr * l + sum_j p, acc' = corr * acc + p @ v; at the end safe_l = l == 0 ? 1 : l,
//   o = acc / safe_l in q's type, lse = m + log(safe_l) in fp32. Keys past Sk (the ragged last
//   tile) are left out entirely. With the causal mask, key tiles past the tile's last query
//   position are not visited (every score there would be NEG_BIG: skipping them changes nothing).
// q, k, v and o are addressed through (batch, head, sequence) strides in elements with the head
// dim contiguous, so the transposed views of the projections are read in place and o can be
// written straight into a (B, Sq, H, D) buffer. Every stride and base is 16-byte aligned (the
// wrapper guarantees it).
//
// Two bodies, one per input type:
//   - fp32: FMA on the CUDA cores, no TF32 (the port holds fp32 to fp32 parity with the
//     reference). 256 threads as a 16 x 16 grid; each thread owns 4 query rows x 4 keys of the
//     64 x 64 score tile and 4 rows x D/16 columns of the accumulator. Q and K are staged
//     transposed in shared memory ([d][row]) so a thread reads its 4 rows / 4 keys as one
//     float4; P goes through shared memory ([key][row]) for the P @ V product.
//   - bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, fp32 accumulate). 4 warps, each
//     owning 16 query rows of the 64-row tile: S = Q K^T per warp in registers, the softmax on
//     the accumulator fragments, then P (rounded to bf16: the one rounding the fp32 plain
//     version does not make; l is summed from the fp32 p) as the A operand of P @ V, with V
//     staged transposed in shared memory. Q fragments stay in registers for the whole loop.
// D is padded with zeros to a tile of 64 or 128 (exact: a zero adds nothing to q . k).
//
// What bounds it on the card: at BERT-base geometry (S = 512, D = 64) a launch does
// 4 * B*H*S^2*D operations on 4 * B*H*S*D elements, some 256 operations per element read:
// fp32 is bound by operations (the 67 TFLOP/s non-tensor rate); bf16 by both (989 TFLOP/s
// against 3.35 TB/s lands near the ridge). Left on the table: wgmma and TMA, a cp.async ring
// that overlaps the next K/V tile with this tile's products, exp2 with the log2(e) scale folded
// in, and a persistent schedule.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile

struct AttnGeom {
  int b, h, sq, sk, d;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal;
};

// [k_begin, k_end) of the keys this query tile visits
__device__ __forceinline__ int key_end(const AttnGeom& g, int q0) {
  if (!g.causal) return g.sk;
  const long long last = (long long)q0 + BQ - 1 + (g.sk - g.sq);  // last row's last key
  if (last < 0) return 0;
  return last + 1 < g.sk ? (int)(last + 1) : g.sk;
}

// the score after the masks: NEG_BIG where masked, -inf past Sk
__device__ __forceinline__ float masked_score(const AttnGeom& g, const float* mask_row, float s,
                                              int q, int key) {
  if (key >= g.sk) return -INFINITY;
  if (g.causal && key > q + (g.sk - g.sq)) return NEG_BIG;
  if (mask_row != nullptr && !(mask_row[key] > 0.f)) return NEG_BIG;
  return s;
}

__device__ __forceinline__ float softmax_p(float s, float m) {
  return s <= NEG_BIG * 0.5f ? 0.f : expf(s - m);
}

// ------------------------------------------------------------------------------ fp32 body

constexpr int F_THREADS = 256;
constexpr int F_PS = BQ + 4;  // P row stride ([key][row])

template <int DT>
struct F32Smem {
  static constexpr int qt = DT * BQ;   // Qt[d][row]
  static constexpr int kt = DT * BK;   // Kt[d][key]
  static constexpr int vs = BK * DT;   // Vs[key][d]
  static constexpr int ps = BK * F_PS; // Ps[key][row]
  static constexpr int bytes = (qt + kt + vs + ps) * (int)sizeof(float);
};

template <int DT>
__global__ void __launch_bounds__(F_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              float* __restrict__ o, float* __restrict__ lse, AttnGeom g) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* Qt = smem;
  float* Kt = Qt + F32Smem<DT>::qt;
  float* Vs = Kt + F32Smem<DT>::kt;
  float* Ps = Vs + F32Smem<DT>::vs;
  constexpr int NC = DT / 64;  // float4 column chunks of the accumulator per thread

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int bi = bh / g.h, hi = bh - bi * g.h;
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + bi * g.q_sb + hi * g.q_sh;
  const float* kb = k + bi * g.k_sb + hi * g.k_sh;
  const float* vb = v + bi * g.v_sb + hi * g.v_sh;
  const float* mask_row = mask == nullptr ? nullptr : mask + (long long)bi * g.sk;

  // Q tile, transposed: thread (row = tid % 64) loads float4 chunks of its row
  for (int c = tid / BQ; c < DT / 4; c += F_THREADS / BQ) {
    const int row = tid % BQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < g.sq && 4 * c < g.d)
      x = *reinterpret_cast<const float4*>(qb + (long long)(q0 + row) * g.q_ss + 4 * c);
    Qt[(4 * c + 0) * BQ + row] = x.x;
    Qt[(4 * c + 1) * BQ + row] = x.y;
    Qt[(4 * c + 2) * BQ + row] = x.z;
    Qt[(4 * c + 3) * BQ + row] = x.w;
  }

  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  const int k_end = key_end(g, q0);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's Kt/Vs/Ps reads are done
    for (int c = tid / BK; c < DT / 4; c += F_THREADS / BK) {
      const int key = tid % BK;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + key < g.sk && 4 * c < g.d)
        x = *reinterpret_cast<const float4*>(kb + (long long)(k0 + key) * g.k_ss + 4 * c);
      Kt[(4 * c + 0) * BK + key] = x.x;
      Kt[(4 * c + 1) * BK + key] = x.y;
      Kt[(4 * c + 2) * BK + key] = x.z;
      Kt[(4 * c + 3) * BK + key] = x.w;
    }
    for (int idx = tid; idx < BK * DT / 4; idx += F_THREADS) {
      const int key = idx / (DT / 4), c = idx - key * (DT / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + key < g.sk && 4 * c < g.d)
        x = *reinterpret_cast<const float4*>(vb + (long long)(k0 + key) * g.v_ss + 4 * c);
      *reinterpret_cast<float4*>(Vs + key * DT + 4 * c) = x;
    }
    __syncthreads();

    // S = Q K^T for rows ty*4+i, keys tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DT; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * BQ + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(Kt + d * BK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // online softmax: a row's 64 keys sit in the 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(g, mask_row, s[i][j] * g.scale, qrow, k0 + tx * 4 + j);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = softmax_p(s[i][j], m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (tx * 4 + j) * F_PS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V for rows ty*4+i, columns c*64 + tx*4 + e
    const int kn = min(BK, g.sk - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(Ps + kk * F_PS + ty * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(Vs + kk * DT + c * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c][0] = fmaf(pv[i], x.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(pv[i], x.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(pv[i], x.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(pv[i], x.w, acc[i][c][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty * 4 + i;
    if (qrow >= g.sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + bi * g.o_sb + hi * g.o_sh + (long long)qrow * g.o_ss;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c * 64 + tx * 4;
      if (col < g.d)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][c][0] / safe_l, acc[i][c][1] / safe_l, acc[i][c][2] / safe_l,
                        acc[i][c][3] / safe_l);
    }
    if (tx == 0) lse[(long long)bh * g.sq + qrow] = m[i] + logf(safe_l);
  }
}

// ------------------------------------------------------------------------------ bf16 body

constexpr int T_THREADS = 128;  // 4 warps x 16 query rows

// c += a * b for one m16n8k16 tile on the tensor cores: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DT>
struct Bf16Smem {
  static constexpr int row = DT + 8;  // Qs/Ks row stride in bf16 (conflict-free fragment loads)
  static constexpr int vrow = BK + 8; // Vt row stride
  static constexpr int qs = BQ * row;
  static constexpr int ks = BK * row;
  static constexpr int vt = DT * vrow;
  static constexpr int bytes = (qs + ks + vt) * 2;
};

template <int DT>
__global__ void __launch_bounds__(T_THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, AttnGeom g) {
  using S = Bf16Smem<DT>;
  extern __shared__ uint4 smem_u4[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_u4);  // [row][d]
  uint16_t* Ks = Qs + S::qs;                             // [key][d]
  uint16_t* Vt = Ks + S::ks;                             // [d][key]
  constexpr int NT = DT / 8;   // n-tiles of the output (8 columns each)
  constexpr int KC = DT / 16;  // k-chunks of Q K^T

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y;
  const int bi = bh / g.h, hi = bh - bi * g.h;
  const int q0 = blockIdx.x * BQ;
  const uint16_t* qb = reinterpret_cast<const uint16_t*>(q) + bi * g.q_sb + hi * g.q_sh;
  const uint16_t* kb = reinterpret_cast<const uint16_t*>(k) + bi * g.k_sb + hi * g.k_sh;
  const uint16_t* vb = reinterpret_cast<const uint16_t*>(v) + bi * g.v_sb + hi * g.v_sh;
  const float* mask_row = mask == nullptr ? nullptr : mask + (long long)bi * g.sk;

  for (int idx = tid; idx < BQ * DT / 8; idx += T_THREADS) {
    const int row = idx / (DT / 8), c = idx - row * (DT / 8);
    uint4 x = make_uint4(0, 0, 0, 0);
    if (q0 + row < g.sq && 8 * c < g.d)
      x = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + row) * g.q_ss + 8 * c);
    *reinterpret_cast<uint4*>(Qs + row * S::row + 8 * c) = x;
  }
  __syncthreads();
  const int wrow = warp * 16;
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const uint16_t* r0 = Qs + (wrow + gq) * S::row + kc * 16 + 2 * tq;
    const uint16_t* r8 = r0 + 8 * S::row;
    qf[kc][0] = *reinterpret_cast<const uint32_t*>(r0);
    qf[kc][1] = *reinterpret_cast<const uint32_t*>(r8);
    qf[kc][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    qf[kc][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
  }

  // rows wrow + gq (half 0) and wrow + gq + 8 (half 1) of this thread's fragments
  float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};
  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  const int k_end = key_end(g, q0);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vt reads are done
    for (int idx = tid; idx < BK * DT / 8; idx += T_THREADS) {
      const int key = idx / (DT / 8), c = idx - key * (DT / 8);
      uint4 x = make_uint4(0, 0, 0, 0);
      if (k0 + key < g.sk && 8 * c < g.d)
        x = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + key) * g.k_ss + 8 * c);
      *reinterpret_cast<uint4*>(Ks + key * S::row + 8 * c) = x;
    }
    for (int idx = tid; idx < BK * DT / 8; idx += T_THREADS) {
      const int key = idx % BK, c = idx / BK;  // neighbouring lanes: neighbouring keys
      uint4 x = make_uint4(0, 0, 0, 0);
      if (k0 + key < g.sk && 8 * c < g.d)
        x = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + key) * g.v_ss + 8 * c);
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(8 * c + j) * S::vrow + key] = e[j];
    }
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys; element e of tile j is (row half e/2, key j*8 + 2tq + e%2)
    float sacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint16_t* kr = Ks + (j * 8 + gq) * S::row + kc * 16 + 2 * tq;
        const uint32_t bfr[2] = {*reinterpret_cast<const uint32_t*>(kr),
                                 *reinterpret_cast<const uint32_t*>(kr + 8)};
        mma_bf16_16816(sacc[j], qf[kc], bfr);
      }

    // online softmax per row half: a row's keys sit in the 4 lanes that share gq
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qrow = q0 + wrow + gq + 8 * half;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& sv = sacc[j][2 * half + e];
          sv = masked_score(g, mask_row, sv * g.scale, qrow, k0 + j * 8 + 2 * tq + e);
          mx = fmaxf(mx, sv);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      const float corr = expf(m[half] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& sv = sacc[j][2 * half + e];
          sv = softmax_p(sv, m_new);
          sum += sv;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[half] = corr * l[half] + sum;
      m[half] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        oacc[n][2 * half] *= corr;
        oacc[n][2 * half + 1] *= corr;
      }
    }

    // O += P V: the S fragments of key tiles 2t, 2t+1 are the A fragment of k-chunk t
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint32_t pa[4] = {pack_bf16(sacc[2 * t][0], sacc[2 * t][1]),
                              pack_bf16(sacc[2 * t][2], sacc[2 * t][3]),
                              pack_bf16(sacc[2 * t + 1][0], sacc[2 * t + 1][1]),
                              pack_bf16(sacc[2 * t + 1][2], sacc[2 * t + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint16_t* vr = Vt + (n * 8 + gq) * S::vrow + t * 16 + 2 * tq;
        const uint32_t bfr[2] = {*reinterpret_cast<const uint32_t*>(vr),
                                 *reinterpret_cast<const uint32_t*>(vr + 8)};
        mma_bf16_16816(oacc[n], pa, bfr);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qrow = q0 + wrow + gq + 8 * half;
    if (qrow >= g.sq) continue;
    const float safe_l = l[half] == 0.f ? 1.f : l[half];
    uint16_t* orow =
        reinterpret_cast<uint16_t*>(o) + bi * g.o_sb + hi * g.o_sh + (long long)qrow * g.o_ss;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col < g.d)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(oacc[n][2 * half] / safe_l, oacc[n][2 * half + 1] / safe_l);
    }
    if (tq == 0) lse[(long long)bh * g.sq + qrow] = m[half] + logf(safe_l);
  }
}

// ------------------------------------------------------------------------------ launch

constexpr int MAX_DEVICES = 64;

// Lift `kernel`'s dynamic shared-memory limit to `bytes` on the current device, once per device
// (`done` holds one flag per device for this kernel; a repeated set is harmless), so a launch
// inside a CUDA-graph capture makes no attribute call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true, std::memory_order_relaxed);
  return e;
}

template <int DT>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const float* mask,
                   void* o, float* lse, const AttnGeom& g, cudaStream_t s) {
  const dim3 grid((unsigned)((g.sq + BQ - 1) / BQ), (unsigned)(g.b * g.h));
  cudaError_t e;
  if (dtype == 0) {
    static std::atomic<bool> done[MAX_DEVICES];
    const int bytes = F32Smem<DT>::bytes;
    e = allow_smem(flash_fwd_f32<DT>, bytes, done);
    if (e != cudaSuccess) return e;
    flash_fwd_f32<DT><<<grid, F_THREADS, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        mask, static_cast<float*>(o), lse, g);
  } else {
    static std::atomic<bool> done[MAX_DEVICES];
    const int bytes = Bf16Smem<DT>::bytes;
    e = allow_smem(flash_fwd_bf16<DT>, bytes, done);
    if (e != cudaSuccess) return e;
    flash_fwd_bf16<DT><<<grid, T_THREADS, bytes, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(o), lse, g);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (B, H, Sq, D), k and v (B, H, Sk, D) and o (B, H, Sq, D)
// by (batch, head, sequence) strides in elements, head dim contiguous; lse (B, H, Sq) fp32
// contiguous; mask (B, Sk) fp32 contiguous (> 0 = attend) or null; causal 0/1 with the key
// offset Sk - Sq. D a multiple of 8 up to 128. Returns the cudaError_t of the launch (0 on
// success).
int dl4j_flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* lse, int dtype, int b, int h, int sq, int sk, int d,
                   long long q_sb, long long q_sh, long long q_ss,
                   long long k_sb, long long k_sh, long long k_ss,
                   long long v_sb, long long v_sh, long long v_ss,
                   long long o_sb, long long o_sh, long long o_ss,
                   float scale, int causal, void* stream) {
  if ((dtype != 0 && dtype != 1) || d < 8 || d > 128 || d % 8 || b < 1 || h < 1 || sq < 1 ||
      sk < 1 || (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  AttnGeom g;
  g.b = b; g.h = h; g.sq = sq; g.sk = sk; g.d = d;
  g.q_sb = q_sb; g.q_sh = q_sh; g.q_ss = q_ss;
  g.k_sb = k_sb; g.k_sh = k_sh; g.k_ss = k_ss;
  g.v_sb = v_sb; g.v_sh = v_sh; g.v_ss = v_ss;
  g.o_sb = o_sb; g.o_sh = o_sh; g.o_ss = o_ss;
  g.scale = scale;
  g.causal = causal != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(mask);
  float* lf = static_cast<float*>(lse);
  (void)cudaGetLastError();  // report this launch's error, not an older one
  const cudaError_t e = d <= 64 ? launch<64>(dtype, q, k, v, mf, o, lf, g, s)
                                : launch<128>(dtype, q, k, v, mf, o, lf, g, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
