// Flash-attention forward for Hopper (sm_90a): the online-softmax attention of one query tile
// against every key tile, O and the per-row log-sum-exp out, no Sq x Sk matrix in device memory.
//
// Replaces the TPU kernel of the JAX package:
//   deeplearning4j_tpu/ops/attention.py::_flash_fwd_kernel (launched by _flash_fwd_pallas)
// The TPU kernel runs on grid (B*H, Sq/bq, Sk/bk) with the key-block axis sequential, carrying the
// running max m, sum l and the fp32 accumulator in VMEM scratch from one grid step to the next.
// Here a block owns a tile of query rows of one (b, h) and loops over the key tiles itself, with
// m, l and the accumulator in registers; blocks share nothing. The grid is one-dimensional, so
// B*H is not capped at 65535.
//
// What it computes, for q (B, H, Sq, D) and k, v (B, H, Sk, D), D a multiple of 8 up to 128:
//   s = (q . k) * scale in fp32; causal: s = NEG_BIG where key > query + (Sk - Sq); padding mask
//   (B, Sk) float: s = NEG_BIG where mask[b][key] <= 0 (b = bh / H, the head folded away as in
//   the TPU kernel's index map); m' = max(m, max_j s), corr = exp(m - m'),
//   p = exp(s - m') and p = 0 where s <= NEG_BIG / 2 (a fully-masked row keeps l = 0),
//   l' = corr * l + sum_j p, acc' = corr * acc + p @ v; at the end safe_l = l == 0 ? 1 : l,
//   o = acc / safe_l in q's type, lse = m + log(safe_l) in fp32. Keys past Sk (the ragged last
//   tile) get p = 0. With the causal mask, key tiles past the tile's last query position are not
//   visited (every score there would be NEG_BIG: skipping them changes nothing).
// Both bodies work in log2 units: t = (q . k) * (scale * log2 e), one multiply, p = 2^(t - m) on
// the SFU (ex2.approx); the p = 0 test is the same threshold scaled (t <= NEG_BIG / 2 * log2 e),
// and the LSE goes back to the natural log as (m + log2 l) * ln 2, except that a row with l = 0
// (fully masked) writes NEG_BIG itself, so it stays exactly -1e30 with O exactly 0. Each body
// comes in two instantiations, picked by the inputs: with a causal or padding mask (the masks
// built per tile from one ballot per 32 keys), and without (no mask code at all, which leaves
// the unmasked case its registers; tools/flash_ablation.py times the masked body on unmasked
// data beside it).
// q, k, v and o are addressed through (batch, head, sequence) strides in elements with the head
// dim contiguous, so the transposed views of the projections are read in place and o is written
// straight into a (B, Sq, H, D) buffer. Every stride and base is 16-byte aligned (the wrapper
// guarantees it).
//
// What bounds it on the card: at BERT-base geometry (S = 512, D = 64) a launch does
// 4 * B*H*S^2*D operations on 4 * B*H*S*D elements read or written, 256 operations per element:
// fp32 is bound by operations (the 67 TFLOP/s non-tensor rate). bf16 sits near the ridge of 989
// TFLOP/s against 3.35 TB/s, and what bounds this body is neither: it is the K/V pipeline
// (every item of 64 query rows streams its head's K and V through L2 again; the products hide
// under it) plus the softmax's exps on the SFUs (16 a clock an SM), which nothing overlaps with
// the tensor cores yet (tools/flash_ablation.py cuts each out in turn).
//
// bf16 body (Hopper: TMA, mbarriers, wgmma), persistent: as many blocks as fit on the card, each
// walking work items (b*h, a tile of 64 query rows; 128 for D > 64, two consumer warpgroups),
// so a block's producer loads the next item's Q and first K/V tiles while its consumers finish
// this one. A block is its consumer warpgroups (64 query rows each) and one producer
// warpgroup; setmaxnreg moves registers from the producer (40) to the consumers. One producer
// thread issues TMA loads (cp.async.bulk.tensor, one CUtensorMap per operand, encoded on the
// host per call over dims (D, and S, H, B in stride order) with the view's own strides, 128-byte
// swizzle, passed as __grid_constant__ so a launch inside a CUDA-graph capture stays valid):
// each item's Q into one of two Q buffers, and K and V tiles of 128 keys into a ring of two
// stages. Every buffer has a full mbarrier (the TMA's transaction bytes) and an empty one (one
// arrival per consumer warp); the producer runs ahead of the consumers by the ring's depth. D
// that is not 64 or 128 rides on TMA's zero fill of the columns past D (a zero adds nothing to
// q . k); at D = 128 each row is two 64-column boxes, since a swizzled box is at most 128 bytes
// wide. Keys past Sk are zero-filled too. Each consumer warpgroup, per key tile:
//   S = Q K^T: wgmma.mma_async m64n128k16, both operands from shared memory by descriptor (Q and
//     K as stored, K-major); the tile's mask bits are built while it runs;
//   the softmax in registers on the wgmma accumulator (rows 16 * warp + lane / 4 and + 8 of the
//     warpgroup's 64, the four lanes of a quad holding a row's keys), l kept per thread and
//     summed over the quad once at the end;
//   O += P V: wgmma.mma_async m64n{D}k16 with A = P from registers (the S accumulator rounded
//     to bf16 and packed pairwise: the one rounding the fp32 plain version does not make; l is
//     summed from the fp32 p) and B = the V tile in its natural [key][d] layout, read through
//     the descriptor's transpose (MN-major) bit: V is never transposed in shared memory;
//   then releases the stage. The epilogue divides by safe_l and stores O in bf16 straight into
//   the strided view. 64 rows an item at D <= 64: two such blocks share an SM (128 registers a
//   thread) with independent rings, which measured faster than one block of two consumer
//   warpgroups sharing each K/V tile, with a ring of two to four stages, at every batch from 1
//   to 32 (tools/flash_ablation.py, PERF.md).
//
// fp32 body (CUDA cores, no TF32: the port holds fp32 to fp32 parity with the reference). 128
// threads own 64 query rows as an 8 x 16 grid: thread (ty, tx) holds rows ty + 8i (i < 8) and keys
// tx + 16j of each key tile (64 keys at D <= 64, 32 at D = 128), and rows ty + 8i x columns
// 4 tx + 64c of the accumulator. Per four columns of D it reads 8 + 4 float4 from shared memory
// for 128 FMAs (twice the ratio of a 4 x 4 tile), conflict-free (row strides of D + 4 floats).
// K and V tiles are double-buffered with cp.async (zero fill past Sk and D): the next tile's copy
// is in flight while this tile's products run, and a tile costs two barriers. P goes through
// shared memory ([key][row]) for P @ V, where the thread partition changes to rows x columns.
//
// Left on the table: overlapping the next tile's Q K^T with this tile's softmax inside a
// warpgroup (it needs a second S accumulator: 64 more registers than the 64-row body has), a
// TMA store of O, and tensor cores for fp32 (ruled out by the fp32 parity gate).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <mutex>

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// p = 0 where the score is at or below NEG_BIG / 2, in the log2 units the bodies work in
constexpr float P_ZERO_AT = NEG_BIG * 0.5f * LOG2E;

struct AttnGeom {
  int b, h, sq, sk, d;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale_log2;  // scale * log2(e)
  int causal;
  int n_qt;  // query tiles per (batch, head)
};

// The work of a query tile: (b, h) from the grid's folded index w (query tiles fastest), its
// first row, and the key tiles of bk keys it visits (with the causal mask, none past the tile's
// last row's last key).
struct QueryTile {
  int bh, bi, hi, q0, n_tiles;
};
__device__ __forceinline__ QueryTile query_tile(const AttnGeom& g, int w, int bq, int bk) {
  QueryTile qt;
  qt.bh = w / g.n_qt;
  qt.q0 = (w - qt.bh * g.n_qt) * bq;
  qt.bi = qt.bh / g.h;
  qt.hi = qt.bh - qt.bi * g.h;
  int keys = g.sk;
  if (g.causal) {
    const long long last = (long long)qt.q0 + bq - 1 + (g.sk - g.sq);  // last row's last key
    keys = last < 0 ? 0 : (last + 1 < g.sk ? (int)(last + 1) : g.sk);
  }
  qt.n_tiles = (keys + bk - 1) / bk;
  return qt;
}

// 2^x on the SFU (relative error about 2^-22; results below 2^-126 flush to 0, which the
// softmax's sums do not see next to its largest term, 1)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float softmax_p(float t, float m) {
  return t <= P_ZERO_AT ? 0.f : fast_exp2(t - m);
}

// Bits of the keys k0 + 32 w + lane (w < WORDS) that are real (< Sk) and not padding-masked,
// one ballot per word: every lane of the warp gets all of them, from one coalesced load each.
template <int WORDS>
__device__ __forceinline__ void key_bits(uint32_t (&bits)[WORDS], const AttnGeom& g,
                                         const float* mask_row, int k0, int lane) {
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    const int key = k0 + 32 * w + lane;
    const bool keep = key < g.sk && (mask_row == nullptr || mask_row[key] > 0.f);
    bits[w] = __ballot_sync(0xffffffffu, keep);
  }
}

// natural-log LSE of a row from its max m (log2 units) and sum l; exactly NEG_BIG when l = 0
__device__ __forceinline__ float row_lse(float m, float l) {
  return l == 0.f ? NEG_BIG : (m + log2f(l)) * LN2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------------------------ fp32 body

constexpr int F_THREADS = 128;
constexpr int F_BQ = 64;  // query rows per block

template <int DT>
struct F32Tile {
  static constexpr int BK = DT == 64 ? 64 : 32;  // keys per tile
  static constexpr int KPT = BK / 16;            // keys per thread
  static constexpr int NC = DT / 64;             // 64-column chunks of the accumulator
  static constexpr int ROW = DT + 4;             // Q and K row stride in floats
  static constexpr int PROW = F_BQ + 4;          // P row stride ([key][ty * 8 + i])
  static constexpr int Q = F_BQ * ROW;
  static constexpr int K = BK * ROW;  // one stage
  static constexpr int V = BK * DT;   // one stage
  static constexpr int P = BK * PROW;
  static constexpr int BYTES = (Q + 2 * K + 2 * V + P) * (int)sizeof(float);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + N) of one (batch, head) slab into dst[row][0, DT) at `stride` floats, 16 bytes a
// copy, neighbouring threads on neighbouring chunks; zeros past `limit` rows or d columns
template <int DT, int N>
__device__ __forceinline__ void f32_stage(float* dst, int stride, const float* src, long long ss,
                                          int r0, int limit, int d, int tid) {
  constexpr int CH = DT / 4;
#pragma unroll 4
  for (int idx = tid; idx < N * CH; idx += F_THREADS) {
    const int r = idx / CH, c = idx - r * CH;
    const bool ok = r0 + r < limit && 4 * c < d;
    cp_async16(dst + r * stride + 4 * c, ok ? src + (long long)(r0 + r) * ss + 4 * c : src, ok);
  }
}

template <int DT, bool MASKED>
__global__ void __launch_bounds__(F_THREADS, 2)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ mask,
              float* __restrict__ o, float* __restrict__ lse, AttnGeom g) {
  using T = F32Tile<DT>;
  constexpr int BK = T::BK, KPT = T::KPT, NC = T::NC;
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);  // [row][d]
  float* Ks = Qs + T::Q;                           // [stage][key][d]
  float* Vs = Ks + 2 * T::K;                       // [stage][key][d]
  float* Ps = Vs + 2 * T::V;                       // [key][ty * 8 + i]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const QueryTile qt = query_tile(g, blockIdx.x, F_BQ, BK);
  const int bh = qt.bh, bi = qt.bi, hi = qt.hi, q0 = qt.q0, n_tiles = qt.n_tiles;
  const float* qb = q + bi * g.q_sb + hi * g.q_sh;
  const float* kb = k + bi * g.k_sb + hi * g.k_sh;
  const float* vb = v + bi * g.v_sb + hi * g.v_sh;
  const float* mask_row = mask == nullptr ? nullptr : mask + (long long)bi * g.sk;

  f32_stage<DT, F_BQ>(Qs, T::ROW, qb, g.q_ss, q0, g.sq, g.d, tid);
  if (n_tiles > 0) {
    f32_stage<DT, BK>(Ks, T::ROW, kb, g.k_ss, 0, g.sk, g.d, tid);
    f32_stage<DT, BK>(Vs, DT, vb, g.v_ss, 0, g.sk, g.d, tid);
  }
  cp_async_commit();

  float m[8], l[8], acc[8][NC][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK, cur = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed for every thread; everyone is done with tile t - 1
    if (t + 1 < n_tiles) {
      f32_stage<DT, BK>(Ks + (cur ^ 1) * T::K, T::ROW, kb, g.k_ss, k0 + BK, g.sk, g.d, tid);
      f32_stage<DT, BK>(Vs + (cur ^ 1) * T::V, DT, vb, g.v_ss, k0 + BK, g.sk, g.d, tid);
    }
    cp_async_commit();
    const float* Kc = Ks + cur * T::K;
    const float* Vc = Vs + cur * T::V;

    // S = Q K^T for rows ty + 8i, keys tx + 16j, summed over d in order
    float s[8][KPT];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < DT / 4; ++c) {
      float4 kv[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Kc + (tx + 16 * j) * T::ROW + 4 * c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(Qs + (ty + 8 * i) * T::ROW + 4 * c);
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          float x = fmaf(a.x, kv[j].x, s[i][j]);
          x = fmaf(a.y, kv[j].y, x);
          x = fmaf(a.z, kv[j].z, x);
          s[i][j] = fmaf(a.w, kv[j].w, x);
        }
      }
    }

    // online softmax: a row's keys sit in the 16 lanes of one half-warp. A masked key, or one
    // past Sk, scores NEG_BIG: p = 0 there, and a row with no key keeps m = NEG_BIG, l = 0.
    uint32_t bits[BK / 32];  // this thread's key tx + 16j at bit 16 (j & 1) of word j / 2
    if constexpr (MASKED) {
      key_bits(bits, g, mask_row, k0, tid & 31);
#pragma unroll
      for (int w = 0; w < BK / 32; ++w) bits[w] >>= tx;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] *= g.scale_log2;
    if constexpr (MASKED) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // causal: the row's last key, relative to the tile
        const int last = g.causal ? q0 + ty + 8 * i + (g.sk - g.sq) - k0 : BK;
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          if (!((bits[j >> 1] >> (16 * (j & 1))) & 1u) || tx + 16 * j > last) s[i][j] = NEG_BIG;
      }
    } else if (k0 + BK > g.sk) {  // the ragged last tile
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          if (k0 + tx + 16 * j >= g.sk) s[i][j] = NEG_BIG;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = fast_exp2(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = softmax_p(s[i][j], m_new);
        sum += s[i][j];
      }
      l[i] = corr * l[i] + sum;  // this thread's keys; summed over the half-warp at the end
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      float* pr = Ps + (tx + 16 * j) * T::PROW + ty * 8;
      *reinterpret_cast<float4*>(pr) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(pr + 4) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncthreads();  // P complete

    // acc += P V for rows ty + 8i, columns 4 tx + 64c (P = 0 and V = 0 past Sk)
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(Ps + kk * T::PROW + ty * 8);
      const float4 p1 = *reinterpret_cast<const float4*>(Ps + kk * T::PROW + ty * 8 + 4);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(Vc + kk * DT + 64 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][c][0] = fmaf(pv[i], x.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(pv[i], x.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(pv[i], x.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(pv[i], x.w, acc[i][c][3]);
        }
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the block (n_tiles = 0 leaves Q's in flight)

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int qrow = q0 + ty + 8 * i;
    if (qrow >= g.sq) continue;
    const float safe_l = lt == 0.f ? 1.f : lt;
    float* orow = o + bi * g.o_sb + hi * g.o_sh + (long long)qrow * g.o_ss;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 64 * c + 4 * tx;
      if (col < g.d)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][c][0] / safe_l, acc[i][c][1] / safe_l, acc[i][c][2] / safe_l,
                        acc[i][c][3] / safe_l);
    }
    if (tx == 0) lse[(long long)bh * g.sq + qrow] = row_lse(m[i], lt);
  }
}

// ------------------------------------------------------------------------------ bf16 body

constexpr int BK = 128;    // keys per tile
constexpr int STAGES = 2;  // K/V ring depth

template <int NWG, int DT>
struct Bf16Tile {
  static constexpr int BQ = 64 * NWG;                // query rows per block
  static constexpr int THREADS = 128 * (NWG + 1);    // NWG consumer warpgroups + the producer
  static constexpr int ATOM_Q = BQ * 128;            // one 64-column (128-byte) atom of Q
  static constexpr int ATOM_KV = BK * 128;           // one atom of a K or V tile
  static constexpr int Q_BYTES = ATOM_Q * (DT / 64);
  static constexpr int KV_BYTES = ATOM_KV * (DT / 64);  // one K or V tile
  // two Q buffers (the next item's Q loads while this one's runs), the K/V ring, mbarriers
  static constexpr int BARS = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BYTES = BARS + 8 * (2 * STAGES + 4) + 1024;  // + 1024-byte alignment
  // registers a thread: 65,536 an SM over THREADS x blocks an SM, producer down, consumers up
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = NWG == 1 ? 216 : 232;
  static_assert((PRODUCER_REGS + NWG * CONSUMER_REGS) * 128 * MIN_BLOCKS <= 65536,
                "register split exceeds the SM's file");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// wait until the phase of parity `parity` has completed; a wait of 2^34 cycles (some 10 s) is a
// lost copy or arrival, and traps, so the launch fails with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// which of a tensor map's coordinates 1..3 is the sequence, the head and the batch
struct TmaOrder {
  int seq, head, batch;
};

// one box (64 columns from col, the map's rows from row) of (bi, hi) into shared memory at dst,
// completing on the mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, TmaOrder ord,
                                         uint32_t bar, int col, int row, int hi, int bi) {
  const int c1 = ord.seq == 1 ? row : ord.head == 1 ? hi : bi;
  const int c2 = ord.seq == 2 ? row : ord.head == 2 ? hi : bi;
  const int c3 = ord.seq == 3 ? row : ord.head == 3 ? hi : bi;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptors for 128-byte-swizzled tiles whose base is 1024-byte aligned:
// rows of 64 bf16 at 128 bytes, groups of 8 rows at 1024 bytes (the stride byte offset).
// K-major (Q, K: the reduction dim contiguous): the leading byte offset is unused (1).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
// MN-major (V as [key][d]: the output dim contiguous): 64-column atoms `atom` bytes apart (the
// leading byte offset), 8-key groups at 1024 bytes
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t atom) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(atom >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pin the accumulators in place around the asynchronous products: nothing reads or writes them
// across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128) (+)= A (64 x 16, shared, K-major) * B (128 x 16, shared, K-major); fp32 accumulate
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int NWG, int DT, bool MASKED>
__global__ void __launch_bounds__(Bf16Tile<NWG, DT>::THREADS, Bf16Tile<NWG, DT>::MIN_BLOCKS)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, TmaOrder oq, TmaOrder ok, TmaOrder ov,
               const float* __restrict__ mask, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, AttnGeom g) {
  using T = Bf16Tile<NWG, DT>;
  constexpr int ATOMS = DT / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  const uint32_t s_kv = base + 2 * T::Q_BYTES;   // stage st: K at + 2 st KV_BYTES, V after it
  const uint32_t bar_full = base + T::BARS;      // 8 bytes each
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_q_full = bar_empty + 8 * STAGES;  // one per Q buffer
  const uint32_t bar_q_empty = bar_q_full + 16;
  const int n_items = g.b * g.h * g.n_qt;  // (b*h, query tile) pairs, query tiles fastest

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 4 * NWG);
    }
#pragma unroll
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(bar_q_full + 8 * qb, 1);
      mbar_init(bar_q_empty + 8 * qb, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer warpgroup: one thread keeps the ring full, across this block's items
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::PRODUCER_REGS));
    if (tid == NWG * 128) {
      int it = 0;  // K/V tiles issued
      int i = 0;   // items of this block
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++i) {
        const QueryTile qt = query_tile(g, w, T::BQ, BK);
        const int bi = qt.bi, hi = qt.hi, q0 = qt.q0, n_tiles = qt.n_tiles;
        const int qb = i & 1;
        mbar_wait(bar_q_empty + 8 * qb, ((i >> 1) & 1) ^ 1);  // the first two pass at once
        mbar_expect_tx(bar_q_full + 8 * qb, T::Q_BYTES);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a)
          tma_load(base + qb * T::Q_BYTES + a * T::ATOM_Q, &tm_q, oq, bar_q_full + 8 * qb,
                   64 * a, q0, hi, bi);
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int st = it % STAGES;
          const uint32_t s_k = s_kv + st * 2 * T::KV_BYTES;
          const uint32_t s_v = s_k + T::KV_BYTES;
          mbar_wait(bar_empty + 8 * st, ((it / STAGES) & 1) ^ 1);  // the first lap passes
          mbar_expect_tx(bar_full + 8 * st, 2 * T::KV_BYTES);
#pragma unroll
          for (int a = 0; a < ATOMS; ++a) {
            tma_load(s_k + a * T::ATOM_KV, &tm_k, ok, bar_full + 8 * st, 64 * a, t * BK, hi, bi);
            tma_load(s_v + a * T::ATOM_KV, &tm_v, ov, bar_full + 8 * st, 64 * a, t * BK, hi, bi);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::CONSUMER_REGS));
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int tq = lane & 3;
    const int row_in = 64 * wg + 16 * warp + (lane >> 2);  // rows row_in and row_in + 8
    int it = 0, i = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++i) {
      const QueryTile qt = query_tile(g, w, T::BQ, BK);
      const int bh = qt.bh, bi = qt.bi, hi = qt.hi, q0 = qt.q0, n_tiles = qt.n_tiles;
      const int row0 = q0 + row_in;
      const float* mask_row = mask == nullptr ? nullptr : mask + (long long)bi * g.sk;
      const int qb = i & 1;
      const uint32_t s_q = base + qb * T::Q_BYTES;

      // accumulator element 4n + 2h + e: row row0 + 8h, column (key or d) 8n + 2 tq + e
      float oacc[DT / 2];
#pragma unroll
      for (int x = 0; x < DT / 2; ++x) oacc[x] = 0.f;
      float m[2] = {NEG_BIG, NEG_BIG}, l[2] = {0.f, 0.f};

      mbar_wait(bar_q_full + 8 * qb, (i >> 1) & 1);
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int st = it % STAGES;
        const int k0 = t * BK;
        const uint32_t s_k = s_kv + st * 2 * T::KV_BYTES;
        const uint32_t s_v = s_k + T::KV_BYTES;
        mbar_wait(bar_full + 8 * st, (it / STAGES) & 1);

        // S = Q K^T over D in k-steps of 16 (32 bytes inside a 64-column atom)
        float s[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DT / 16; ++kk) {
          const uint32_t a = s_q + (kk / 4) * T::ATOM_Q + wg * 64 * 128 + (kk % 4) * 32;
          const uint32_t b = s_k + (kk / 4) * T::ATOM_KV + (kk % 4) * 32;
          wgmma_ss_n128(s, desc_k_major(a), desc_k_major(b), kk > 0);
        }
        wgmma_commit();

        // the masks, while the product runs: a masked key, or one past Sk, scores NEG_BIG
        // (p = 0; a row with no key keeps m = NEG_BIG and l = 0)
        uint32_t bits[BK / 32];  // key 8n + 2 tq + e of the tile at bit 8 (n & 3) + e of word n / 4
        if constexpr (MASKED) {
          key_bits(bits, g, mask_row, k0, lane);
#pragma unroll
          for (int x = 0; x < BK / 32; ++x) bits[x] >>= 2 * tq;
        }
        wgmma_wait_all();
        fence_regs(s);

#pragma unroll
        for (int x = 0; x < BK / 2; ++x) s[x] *= g.scale_log2;
        if constexpr (MASKED) {
          // causal: row row0's last key, relative to the tile (row0 + 8's is 8 further)
          const int last = g.causal ? row0 + (g.sk - g.sq) - k0 : BK;
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kk = 8 * n + 2 * tq + e;
              const bool real = (bits[n >> 2] >> (8 * (n & 3) + e)) & 1u;
              if (!real || kk > last) s[4 * n + e] = NEG_BIG;
              if (!real || kk > last + 8) s[4 * n + 2 + e] = NEG_BIG;
            }
        } else if (k0 + BK > g.sk) {  // the ragged last tile
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (k0 + 8 * n + 2 * tq + e >= g.sk) s[4 * n + e] = s[4 * n + 2 + e] = NEG_BIG;
        }

        // online softmax per row half h: a row's keys sit in the 4 lanes of a quad
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) mx = fmaxf(mx, s[4 * n + 2 * h + e]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[h], mx);
          const float corr = fast_exp2(m[h] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * n + 2 * h + e];
              x = softmax_p(x, m_new);
              sum += x;
            }
          l[h] = corr * l[h] + sum;  // this thread's keys; summed over the quad at the end
          m[h] = m_new;
#pragma unroll
          for (int n = 0; n < DT / 8; ++n) {
            oacc[4 * n + 2 * h] *= corr;
            oacc[4 * n + 2 * h + 1] *= corr;
          }
        }

        // P in bf16 as the A fragments of P V: keys 16c .. 16c + 15 are n-tiles 2c and 2c + 1
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int c = 0; c < BK / 16; ++c) {
          pa[c][0] = pack_bf16(s[8 * c + 0], s[8 * c + 1]);
          pa[c][1] = pack_bf16(s[8 * c + 2], s[8 * c + 3]);
          pa[c][2] = pack_bf16(s[8 * c + 4], s[8 * c + 5]);
          pa[c][3] = pack_bf16(s[8 * c + 6], s[8 * c + 7]);
        }

        // O += P V over the tile's keys in k-steps of 16 (16 rows of V, 2048 bytes)
        fence_regs(oacc);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < BK / 16; ++c) {
          const uint64_t desc = desc_mn_major(s_v + c * 16 * 128, T::ATOM_KV);
          if constexpr (DT == 64)
            wgmma_rs_n64(oacc, pa[c], desc);
          else
            wgmma_rs_n128(oacc, pa[c], desc);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(oacc);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // this warp is done with the stage
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_q_empty + 8 * qb);  // and with this item's Q

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lt = l[h];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const int qrow = row0 + 8 * h;
        if (qrow >= g.sq) continue;
        const float safe_l = lt == 0.f ? 1.f : lt;
        uint16_t* orow = reinterpret_cast<uint16_t*>(o) + bi * g.o_sb + hi * g.o_sh +
                         (long long)qrow * g.o_ss;
#pragma unroll
        for (int n = 0; n < DT / 8; ++n) {
          const int col = 8 * n + 2 * tq;
          if (col < g.d)
            *reinterpret_cast<uint32_t*>(orow + col) =
                pack_bf16(oacc[4 * n + 2 * h] / safe_l, oacc[4 * n + 2 * h + 1] / safe_l);
        }
        if (tq == 0) lse[(long long)bh * g.sq + qrow] = row_lse(m[h], lt);
      }
    }
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

// the current device's SM count, read once per device (before any capture: the first launch)
int sm_count() {
  static std::atomic<int> sms[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < MAX_DEVICES) {
    const int n = sms[dev].load(std::memory_order_relaxed);
    if (n > 0) return n;
  }
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    n = 132;
  if (dev < MAX_DEVICES) sms[dev].store(n, std::memory_order_relaxed);
  return n;
}

// query rows per item of the bf16 body: 64 (one consumer warpgroup, two blocks an SM) up to
// D = 64; 128 above (two consumer warpgroups, one block an SM: 64 rows of a D = 128 accumulator
// do not fit the 64-row body's 128 registers a thread)
constexpr int bf16_rows(int d) { return d <= 64 ? 64 : 128; }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library links no libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// The tensor map of a bf16 (batch, head, sequence)-strided view with the head dim contiguous:
// dims (D, and S, H, B in order of stride, any of size 1 last at a packed stride), boxes of 64
// columns x `rows` of the sequence, 128-byte swizzle, zeros outside the tensor.
bool encode_view(CUtensorMap* map, TmaOrder* ord, const void* base, int d, int s, int h, int b,
                 long long sb, long long sh, long long ss, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  struct Dim {
    long long size, stride;
    int which;  // 0 sequence, 1 head, 2 batch
  } dims[3] = {{s, 2 * ss, 0}, {h, 2 * sh, 1}, {b, 2 * sb, 2}};
  std::sort(dims, dims + 3, [](const Dim& x, const Dim& y) {
    if ((x.size == 1) != (y.size == 1)) return y.size == 1;
    return x.stride < y.stride;
  });
  cuuint64_t gdim[4] = {(cuuint64_t)d, 1, 1, 1};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int slot[3];
  long long extent = 2LL * d;  // bytes spanned by the dims placed so far
  for (int i = 0; i < 3; ++i) {
    const long long stride = dims[i].size == 1 ? extent : dims[i].stride;
    if (stride <= 0 || stride % 16 || stride >= (1LL << 40)) return false;
    gdim[i + 1] = (cuuint64_t)dims[i].size;
    gstride[i] = (cuuint64_t)stride;
    box[i + 1] = dims[i].which == 0 ? (cuuint32_t)rows : 1;
    slot[dims[i].which] = i + 1;
    extent = std::max(extent, stride * dims[i].size);
  }
  ord->seq = slot[0];
  ord->head = slot[1];
  ord->batch = slot[2];
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), gdim, gstride,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool grid_of(AttnGeom& g, int bq, unsigned* blocks) {
  g.n_qt = (g.sq + bq - 1) / bq;
  const long long n = (long long)g.b * g.h * g.n_qt;
  if (n > INT_MAX) return false;
  *blocks = (unsigned)n;
  return true;
}

template <int DT, bool MASKED>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* mask,
                       float* o, float* lse, AttnGeom g, cudaStream_t s) {
  using T = F32Tile<DT>;
  unsigned blocks;
  if (!grid_of(g, F_BQ, &blocks)) return cudaErrorInvalidValue;
  static std::atomic<bool> done[MAX_DEVICES];
  const cudaError_t e = allow_smem(flash_fwd_f32<DT, MASKED>, T::BYTES, done);
  if (e != cudaSuccess) return e;
  flash_fwd_f32<DT, MASKED><<<blocks, F_THREADS, T::BYTES, s>>>(q, k, v, mask, o, lse, g);
  return cudaSuccess;
}

// The bf16 body is persistent: as many blocks as fit on the card at once (read once per device,
// with the smem limit), each walking items blockIdx.x, + gridDim.x, ... so the producer loads
// the next item's Q and first K/V tiles while the consumers finish this one.
template <int NWG, int DT, bool MASKED>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const float* mask, void* o,
                        float* lse, AttnGeom g, cudaStream_t s) {
  using T = Bf16Tile<NWG, DT>;
  const auto kernel = flash_fwd_bf16<NWG, DT, MASKED>;
  unsigned items;
  if (!grid_of(g, T::BQ, &items)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  TmaOrder oq, ok, ov;
  if (!encode_view(&mq, &oq, q, g.d, g.sq, g.h, g.b, g.q_sb, g.q_sh, g.q_ss, T::BQ) ||
      !encode_view(&mk, &ok, k, g.d, g.sk, g.h, g.b, g.k_sb, g.k_sh, g.k_ss, BK) ||
      !encode_view(&mv, &ov, v, g.d, g.sk, g.h, g.b, g.v_sb, g.v_sh, g.v_ss, BK))
    return cudaErrorInvalidValue;
  static std::atomic<bool> done[MAX_DEVICES];
  cudaError_t e = allow_smem(kernel, T::BYTES, done);
  if (e != cudaSuccess) return e;
  static std::atomic<int> resident[MAX_DEVICES];  // blocks an SM holds
  int dev = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES) per_sm = resident[dev].load(std::memory_order_relaxed);
  if (per_sm <= 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::THREADS, T::BYTES);
    if (e != cudaSuccess) return e;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    if (dev < MAX_DEVICES) resident[dev].store(per_sm, std::memory_order_relaxed);
  }
  const unsigned blocks = std::min<unsigned>(items, (unsigned)(per_sm * sm_count()));
  kernel<<<blocks, T::THREADS, T::BYTES, s>>>(mq, mk, mv, oq, ok, ov, mask,
                                               static_cast<__nv_bfloat16*>(o), lse, g);
  return cudaSuccess;
}

template <bool MASKED>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const float* mask,
                   void* o, float* lse, const AttnGeom& g, cudaStream_t s) {
  if (dtype == 0) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
    return g.d <= 64 ? launch_f32<64, MASKED>(qf, kf, vf, mask, of, lse, g, s)
                     : launch_f32<128, MASKED>(qf, kf, vf, mask, of, lse, g, s);
  }
  return bf16_rows(g.d) == 64 ? launch_bf16<1, 64, MASKED>(q, k, v, mask, o, lse, g, s)
                              : launch_bf16<2, 128, MASKED>(q, k, v, mask, o, lse, g, s);
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
      sk < 1)
    return (int)cudaErrorInvalidValue;
  AttnGeom g;
  g.b = b; g.h = h; g.sq = sq; g.sk = sk; g.d = d;
  g.q_sb = q_sb; g.q_sh = q_sh; g.q_ss = q_ss;
  g.k_sb = k_sb; g.k_sh = k_sh; g.k_ss = k_ss;
  g.v_sb = v_sb; g.v_sh = v_sh; g.v_ss = v_ss;
  g.o_sb = o_sb; g.o_sh = o_sh; g.o_ss = o_ss;
  g.scale_log2 = scale * LOG2E;
  g.causal = causal != 0;
  g.n_qt = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(mask);
  float* lf = static_cast<float*>(lse);
  (void)cudaGetLastError();  // report this launch's error, not an older one
  // the masked bodies only where a mask is: the unmasked ones carry no mask code at all
  const cudaError_t e = g.causal || mf != nullptr
                            ? launch<true>(dtype, q, k, v, mf, o, lf, g, s)
                            : launch<false>(dtype, q, k, v, mf, o, lf, g, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Query rows per block (fp32) or per work item (bf16) that dl4j_flash_fwd takes for head dim d.
int dl4j_flash_fwd_rows(int dtype, int d) { return dtype == 0 ? F_BQ : bf16_rows(d); }

}  // extern "C"
