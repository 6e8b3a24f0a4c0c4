// NHWC x HWIO 2-D convolution forward for Hopper (sm_90a), as an implicit GEMM.
//
// Replaces the TPU forward kernels of the JAX package:
//   deeplearning4j_tpu/ops/kernels/conv.py::_fwd_kernel        (one program per (image, group))
//   deeplearning4j_tpu/ops/kernels/conv.py::_fwd_kernel_tiled  (the same, row_tile output rows per program)
// The TPU kernels read a pre-padded image into VMEM and, for each kernel tap, do one strided
// window x (Cg, Og) matmul on the MXU. Here the same sum is one GEMM per group:
//   M = N*OH*OW output positions, N = Og = Cout/groups, K = kh*kw*Cg (tap-major, channel-minor,
//   which is the HWIO weight layout, so a row of B is a contiguous run of Cout).
// A block owns a BM x BN output tile of one group and loops over its K range, staging gathered
// input patches (A) and weights (B) in shared memory. The padding is applied by masking
// out-of-range input rows and columns to 0 while gathering, so no padded copy exists in HBM.
// Stride, dilation and groups are index arithmetic. Products are summed in fp32 and the output
// is written in the input type.
//
// Two bodies, one per input type:
//   - fp32: FMA on the CUDA cores, 128x128 tiles (128x64 when Og <= 64), 8x8 outputs per thread,
//     double-buffered. TF32 tensor cores are not used: the port holds fp32 to fp32 parity with
//     the reference.
//   - bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, fp32 accumulate), 128x64 tiles,
//     8 warps of 32x32; channel runs of 16 are gathered with 16-byte loads.
//
// row_tile (the TPU kernel's tuning knob) cuts M into segments of row_tile*OW positions (row_tile
// output rows of one image); no M tile crosses a segment. 0 means one segment over all of M.
//
// dgrad: the JAX package reuses _fwd_kernel for the input gradient (_conv_vjp_bwd runs it on the
// stride-dilated dy with flipped, I/O-transposed weights); the port's conv2d_dgrad launches
// dl4j_conv2d_fwd the same way.
//
// Split-K: when a geometry gives too few output tiles to fill the card (ResNet-50's res4/res5 at
// small batch), dl4j_conv2d_fwd_plan asks for `splits` > 1, sized to one wave of resident blocks
// (the occupancy calculator's count for the body the launch uses). blockIdx.z then walks
// (group, split); each split sums its own slice of K into an fp32 workspace [splits][M][Cout],
// and a second kernel adds the slices in a fixed order and writes the output, so the result does
// not depend on scheduling.
//
// What bounds it on the card: ResNet-50's 3x3 and 1x1 convolutions at batch >= 8 do hundreds of
// operations per byte moved, so the bound is arithmetic: the fp32 non-tensor rate for fp32, the
// bf16 tensor-core rate for bf16. Left on the table: wgmma and TMA (the only way to the full
// tensor-core rate), a multi-stage cp.async/TMA ring that overlaps the gather with the products
// (the bf16 body loads, syncs, then computes; the fp32 body overlaps one stage through
// registers), ldmatrix fragment loads, and a persistent schedule in place of split-K.

#include "conv_common.cuh"

namespace {

// fp32 FMA body (BN is 128 or 64, see conv2d_fwd_f32)
constexpr int F_BM = 128;
constexpr int F_BK = 8;
// bf16 tensor-core body
constexpr int T_BM = 128;
constexpr int T_BN = 64;
constexpr int T_BK = 32;
// split-K: most K slices
constexpr int MAX_SPLITS = 16;

struct ConvGeom {
  int n, h, w, cin;
  int kh, kw, cout, groups;
  int oh, ow;
  int sh, sw, dh, dw;
  int pad_top, pad_left;
  long long seg;      // output positions per M segment
  int tiles_per_seg;  // BM tiles per segment
  int splits;         // K slices (blockIdx.z = group * splits + split)
  int k_per_split;    // K elements per slice, a multiple of the body's BK
};

struct OutputRow {  // decomposition of one output position m
  long long img;
  int ih0, iw0;
};

__device__ __forceinline__ OutputRow output_row(const ConvGeom& g, long long m) {
  const long long ohw = (long long)g.oh * g.ow;
  OutputRow r;
  r.img = m / ohw;
  const int rem = (int)(m - r.img * ohw);
  const int oy = rem / g.ow;
  const int ox = rem - oy * g.ow;
  r.ih0 = oy * g.sh - g.pad_top;
  r.iw0 = ox * g.sw - g.pad_left;
  return r;
}

// The block's M range: [m0, m_end) within its row_tile segment.
__device__ __forceinline__ void block_rows(const ConvGeom& g, int bm, long long* m0,
                                           long long* m_end) {
  const long long M = (long long)g.n * g.oh * g.ow;
  const long long seg_start = (long long)(blockIdx.x / g.tiles_per_seg) * g.seg;
  *m0 = seg_start + (long long)(blockIdx.x % g.tiles_per_seg) * bm;
  *m_end = seg_start + g.seg < M ? seg_start + g.seg : M;
}

// ------------------------------------------------------------------ fp32, FMA on the CUDA cores

// Block tile F_BM x BN (BN = 128, or 64 when Og <= 64 so that res2's 64-channel layers waste no
// columns), BK = 8, double-buffered in shared memory: the next stage's global loads are in flight
// while this stage's products run. Thread (ty, tx) = (tid / 16, tid % 16) owns the 8 rows
// {ty*4 + i, 64 + ty*4 + i} and the TN = BN/16 columns {tx*HN + j, BN/2 + tx*HN + j}, so each
// k step reads its operands with two vector loads per side and does 8 * TN FMAs.
// vec_a: Cg % 4 == 0, Cin % 4 == 0 and x 16-byte aligned (4 channels of one tap = one float4);
// vec_b: Og % 4 == 0, Cout % 4 == 0 and w 16-byte aligned.
template <int BN>
__global__ void __launch_bounds__(THREADS)
conv2d_fwd_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
               float* __restrict__ ws, ConvGeom g, int vec_a, int vec_b) {
  constexpr int TN = BN / 16;
  constexpr int HN = TN / 2;
  constexpr int B_CHUNKS = F_BK * BN / 4;  // float4 chunks of a B stage
  __shared__ __align__(16) float As[2][F_BK][F_BM];
  __shared__ __align__(16) float Bs[2][F_BK][BN];

  const int tid = threadIdx.x;
  const int group = blockIdx.z / g.splits;
  const int split = blockIdx.z - group * g.splits;
  const int cg = g.cin / g.groups;
  const int og = g.cout / g.groups;
  const int K = g.kh * g.kw * cg;
  const int kbeg = split * g.k_per_split;
  const int kend = min(K, kbeg + g.k_per_split);
  long long m0, m_end;
  block_rows(g, F_BM, &m0, &m_end);
  const int n0 = blockIdx.y * BN;

  // A gather: each thread owns one output position (row a_m) and 4 consecutive k.
  const int a_m = tid & (F_BM - 1);
  const int a_k = (tid >> 7) * 4;
  const bool a_valid = m0 + a_m < m_end;
  OutputRow r = {0, 0, 0};
  if (a_valid) r = output_row(g, m0 + a_m);
  const float* x_img = x + r.img * g.h * g.w * g.cin + (long long)group * cg;

  // B load: thread tid < B_CHUNKS owns one k row (b_k) and 4 consecutive output channels.
  const int b_k = tid / (BN / 4);
  const int b_n = (tid % (BN / 4)) * 4;
  const float* w_grp = w + (long long)group * og;

  float ra[4], rb[4];
  auto load = [&](int k0) {
    const int k = k0 + a_k;
    if (vec_a) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a_valid && k < kend) {
        const int tap = k / cg;
        const int ki = tap / g.kw;
        const int ih = r.ih0 + ki * g.dh;
        const int iw = r.iw0 + (tap - ki * g.kw) * g.dw;
        if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
          v = *reinterpret_cast<const float4*>(
              x_img + ((long long)ih * g.w + iw) * g.cin + (k - tap * cg));
      }
      ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k + j;
        float v = 0.f;
        if (a_valid && kk < kend) {
          const int tap = kk / cg;
          const int ki = tap / g.kw;
          const int ih = r.ih0 + ki * g.dh;
          const int iw = r.iw0 + (tap - ki * g.kw) * g.dw;
          if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
            v = x_img[((long long)ih * g.w + iw) * g.cin + (kk - tap * cg)];
        }
        ra[j] = v;
      }
    }
    if (tid < B_CHUNKS) {
      const int kb = k0 + b_k;
      if (vec_b) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kb < kend && n0 + b_n < og)
          v = *reinterpret_cast<const float4*>(w_grp + (long long)kb * g.cout + n0 + b_n);
        rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nn = n0 + b_n + j;
          rb[j] = (kb < kend && nn < og) ? w_grp[(long long)kb * g.cout + nn] : 0.f;
        }
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) As[buf][a_k + j][a_m] = ra[j];
    if (tid < B_CHUNKS)
      *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  const int ty = tid >> 4;
  const int tx = tid & 15;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  int buf = 0;
  if (kbeg < kend) {
    load(kbeg);
    store(0);
  }
  __syncthreads();
  for (int k0 = kbeg; k0 < kend; k0 += F_BK) {
    const bool more = k0 + F_BK < kend;
    if (more) load(k0 + F_BK);
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[8], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* bp = &Bs[buf][kk][h * (BN / 2) + tx * HN];
        if constexpr (HN == 4) {
          const float4 v = *reinterpret_cast<const float4*>(bp);
          b[h * 4 + 0] = v.x; b[h * 4 + 1] = v.y; b[h * 4 + 2] = v.z; b[h * 4 + 3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(bp);
          b[h * 2 + 0] = v.x; b[h * 2 + 1] = v.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  const long long M = (long long)g.n * g.oh * g.ow;
  float* dst = g.splits > 1 ? ws + (long long)split * M * g.cout : out;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= m_end) continue;
    float* orow = dst + m * g.cout + (long long)group * og;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int nn = n0 + (j < HN ? tx * HN + j : BN / 2 + tx * HN + j - HN);
      if (nn < og) orow[nn] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------ bf16, mma.sync on the tensor cores

// vec_a: Cg % 16 == 0, Cin % 8 == 0 and x 16-byte aligned, so a 16-long K run is 16 contiguous
// channels of one tap (two 16-byte loads). vec_b: Og % 8 == 0, Cout % 8 == 0 and w 16-byte
// aligned, so 8 output channels of one weight row are one 16-byte load.
__global__ void __launch_bounds__(THREADS)
conv2d_fwd_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ out, float* __restrict__ ws, ConvGeom g, int vec_a,
                int vec_b) {
  // rows padded to 40 halves (80 bytes): the fragment reads below hit 32 distinct banks
  __shared__ __align__(16) uint16_t As[T_BM][T_BK + 8];
  __shared__ __align__(16) uint16_t Bs[T_BN][T_BK + 8];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = blockIdx.z / g.splits;
  const int split = blockIdx.z - group * g.splits;
  const int cg = g.cin / g.groups;
  const int og = g.cout / g.groups;
  const int K = g.kh * g.kw * cg;
  const int kbeg = split * g.k_per_split;
  const int kend = min(K, kbeg + g.k_per_split);
  long long m0, m_end;
  block_rows(g, T_BM, &m0, &m_end);
  const int n0 = blockIdx.y * T_BN;

  // A gather: each thread owns one output position (row a_m) and 16 consecutive k.
  const int a_m = tid >> 1;
  const int a_k = (tid & 1) * 16;
  const bool a_valid = m0 + a_m < m_end;
  OutputRow r = {0, 0, 0};
  if (a_valid) r = output_row(g, m0 + a_m);
  const uint16_t* x_img = reinterpret_cast<const uint16_t*>(x) + r.img * g.h * g.w * g.cin +
                          (long long)group * cg;

  // B load: each thread owns one k row (b_k) and 8 consecutive output channels.
  const int b_k = tid >> 3;
  const int b_n = (tid & 7) * 8;
  const uint16_t* w_grp = reinterpret_cast<const uint16_t*>(w) + (long long)group * og;

  // warp tile: 32 rows x 32 columns at (wm, wn) of the block's 4 x 2 warp grid
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int gq = lane >> 2;  // fragment row / column group
  const int tq = lane & 3;   // fragment k pair
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += T_BK) {
    const int ka = k0 + a_k;
    if (vec_a) {
      uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0;
      if (a_valid && ka < kend) {
        const int tap = ka / cg;
        const int c = ka - tap * cg;
        const int ki = tap / g.kw;
        const int ih = r.ih0 + ki * g.dh;
        const int iw = r.iw0 + (tap - ki * g.kw) * g.dw;
        if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w) {
          const uint4* p =
              reinterpret_cast<const uint4*>(x_img + ((long long)ih * g.w + iw) * g.cin + c);
          v0 = p[0];
          v1 = p[1];
        }
      }
      *reinterpret_cast<uint4*>(&As[a_m][a_k]) = v0;
      *reinterpret_cast<uint4*>(&As[a_m][a_k + 8]) = v1;
    } else {
      int tap = ka / cg;
      int c = ka - tap * cg;
      int ki = tap / g.kw;
      int kj = tap - ki * g.kw;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint16_t v = 0;
        if (a_valid && ka + j < kend) {
          const int ih = r.ih0 + ki * g.dh;
          const int iw = r.iw0 + kj * g.dw;
          if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
            v = x_img[((long long)ih * g.w + iw) * g.cin + c];
        }
        As[a_m][a_k + j] = v;
        if (++c == cg) {
          c = 0;
          if (++kj == g.kw) {
            kj = 0;
            ++ki;
          }
        }
      }
    }
    const int kb = k0 + b_k;
    if (vec_b) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (kb < kend && n0 + b_n < og)
        v = *reinterpret_cast<const uint4*>(w_grp + (long long)kb * g.cout + n0 + b_n);
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) Bs[b_n + j][b_k] = e[j];
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nn = n0 + b_n + j;
        Bs[b_n + j][b_k] = (kb < kend && nn < og) ? w_grp[(long long)kb * g.cout + nn] : 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < T_BK; ks += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm + i * 16 + gq;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&As[row][ks + 2 * tq]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&As[row + 8][ks + 2 * tq]);
        af[i][2] = *reinterpret_cast<const uint32_t*>(&As[row][ks + 2 * tq + 8]);
        af[i][3] = *reinterpret_cast<const uint32_t*>(&As[row + 8][ks + 2 * tq + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn + j * 8 + gq;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[col][ks + 2 * tq]);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[col][ks + 2 * tq + 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
  }

  // accumulator fragment: elements 0,1 at (row gq, cols 2tq, 2tq+1), 2,3 at row gq + 8
  const long long M = (long long)g.n * g.oh * g.ow;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm + i * 16 + gq + half * 8;
      if (m >= m_end) continue;
      const long long row = m * g.cout + (long long)group * og;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = n0 + wn + j * 8 + 2 * tq;
        const float v0 = acc[i][j][half * 2];
        const float v1 = acc[i][j][half * 2 + 1];
        if (g.splits > 1) {
          float* dst = ws + (long long)split * M * g.cout + row;
          if (nn < og) dst[nn] = v0;
          if (nn + 1 < og) dst[nn + 1] = v1;
        } else {
          if (nn < og) out[row + nn] = __float2bfloat16_rn(v0);
          if (nn + 1 < og) out[row + nn + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// ------------------------------------------------------------------ launch shape and plan

// The grid of one launch: the body's block tile, M cut into row_tile segments of BM tiles, Og
// into BN tiles, K into BK stages.
struct LaunchShape {
  int bm, bn, bk;
  long long seg;       // output positions per M segment
  int tiles_per_seg;   // BM tiles per segment
  long long segments;  // M segments
  int n_tiles;         // BN tiles over Og
  int stages;          // BK stages over K
};

LaunchShape launch_shape(int dtype, int n, int cin, int kh, int kw, int cout, int groups, int oh,
                         int ow, int row_tile) {
  const int og = cout / groups;
  LaunchShape l;
  l.bm = dtype == 0 ? F_BM : T_BM;
  l.bn = dtype == 0 ? (og > 64 ? 128 : 64) : T_BN;
  l.bk = dtype == 0 ? F_BK : T_BK;
  const long long M = (long long)n * oh * ow;
  l.seg = row_tile > 0 ? (long long)row_tile * ow : M;
  l.tiles_per_seg = (int)((l.seg + l.bm - 1) / l.bm);
  l.segments = (M + l.seg - 1) / l.seg;
  l.n_tiles = (og + l.bn - 1) / l.bn;
  l.stages = (kh * kw * (cin / groups) + l.bk - 1) / l.bk;
  return l;
}

// Blocks of one wave on the current device for the body a launch with this dtype and Og uses.
cudaError_t body_slots(int dtype, int og, int* slots) {
  static std::atomic<int> cache[3][MAX_DEVICES];
  if (dtype != 0) return wave_slots(conv2d_fwd_bf16, cache[2], slots);
  if (og > 64) return wave_slots(conv2d_fwd_f32<128>, cache[0], slots);
  return wave_slots(conv2d_fwd_f32<64>, cache[1], slots);
}

}  // namespace

extern "C" {

// The K slices of one launch (dtype 0 = float32, 1 = bfloat16; row_tile 0 = whole output
// height) on the current device: as many as fit its output tiles (BM x BN tiles of every group)
// into one wave of resident blocks, never past it (a second, partial wave costs a whole wave),
// keeping at least MIN_STAGES_PER_SPLIT BK stages in each slice and at most MAX_SPLITS slices.
// splits > 1 means dl4j_conv2d_fwd needs a workspace of splits * N*OH*OW * Cout floats.
// Returns a cudaError_t (0 on success).
int dl4j_conv2d_fwd_plan(int dtype, int n, int cin, int kh, int kw, int cout, int groups, int oh,
                         int ow, int row_tile, int* splits) {
  if ((dtype != 0 && dtype != 1) || groups < 1 || splits == nullptr)
    return (int)cudaErrorInvalidValue;
  const LaunchShape l = launch_shape(dtype, n, cin, kh, kw, cout, groups, oh, ow, row_tile);
  int slots = 0;
  const cudaError_t e = body_slots(dtype, cout / groups, &slots);
  if (e != cudaSuccess) return (int)e;
  *splits = plan_splits(slots, l.segments * l.tiles_per_seg * l.n_tiles * groups, l.stages,
                        MAX_SPLITS);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. Pads are the explicit (top, left) of the SAME/VALID/numeric
// resolution; the bottom/right pads are implied by oh/ow. row_tile 0 = whole output height.
// `splits` comes from dl4j_conv2d_fwd_plan; splits > 1 needs `workspace`: splits * N*OH*OW *
// Cout floats. Returns the cudaError_t of the launches (0 on success).
int dl4j_conv2d_fwd(const void* x, const void* w, void* out, int dtype,
                    int n, int h, int wd, int cin, int kh, int kw, int cout, int groups,
                    int oh, int ow, int sh, int sw, int dh, int dw,
                    int pad_top, int pad_left, int row_tile, int splits, void* workspace,
                    void* stream) {
  if ((dtype != 0 && dtype != 1) || splits < 1 || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const int og = cout / groups;
  const int cg = cin / groups;
  const LaunchShape l = launch_shape(dtype, n, cin, kh, kw, cout, groups, oh, ow, row_tile);
  ConvGeom g;
  g.n = n; g.h = h; g.w = wd; g.cin = cin;
  g.kh = kh; g.kw = kw; g.cout = cout; g.groups = groups;
  g.oh = oh; g.ow = ow;
  g.sh = sh; g.sw = sw; g.dh = dh; g.dw = dw;
  g.pad_top = pad_top; g.pad_left = pad_left;
  g.seg = l.seg;
  g.tiles_per_seg = l.tiles_per_seg;
  g.splits = splits;
  g.k_per_split = ((l.stages + splits - 1) / splits) * l.bk;
  dim3 grid((unsigned)(l.segments * l.tiles_per_seg), (unsigned)l.n_tiles,
            (unsigned)(groups * splits));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  (void)cudaGetLastError();  // report these launches' errors, not an older one
  const bool x16 = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool w16 = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  if (dtype == 0) {
    const int vec_a = cg % 4 == 0 && cin % 4 == 0 && x16;
    const int vec_b = og % 4 == 0 && cout % 4 == 0 && w16;
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* of = static_cast<float*>(out);
    if (l.bn == 128)
      conv2d_fwd_f32<128><<<grid, THREADS, 0, s>>>(xf, wf, of, ws, g, vec_a, vec_b);
    else
      conv2d_fwd_f32<64><<<grid, THREADS, 0, s>>>(xf, wf, of, ws, g, vec_a, vec_b);
  } else {
    const int vec_a = cg % 16 == 0 && cin % 8 == 0 && x16;
    const int vec_b = og % 8 == 0 && cout % 8 == 0 && w16;
    conv2d_fwd_bf16<<<grid, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                             static_cast<const __nv_bfloat16*>(w),
                                             static_cast<__nv_bfloat16*>(out), ws, g, vec_a,
                                             vec_b);
  }
  if (splits > 1) {
    const long long total = (long long)n * oh * ow * cout;
    if (dtype == 0)
      launch_reduce_splits(ws, static_cast<float*>(out), total, splits, s);
    else
      launch_reduce_splits(ws, static_cast<__nv_bfloat16*>(out), total, splits, s);
  }
  return (int)cudaGetLastError();
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
