// NHWC 2-D convolution filter gradient (wgrad) for Hopper (sm_90a), as an implicit GEMM.
//
// Replaces the TPU filter-gradient kernel of the JAX package:
//   deeplearning4j_tpu/ops/kernels/conv.py::_wgrad_kernel  (launched by _wgrad_pallas, grid (groups, N))
// The TPU kernel revisits one fp32 (kh, kw, Cg, Og) output block image after image on its sequential
// grid and adds, for each tap, patch(ki, kj)^T @ dY. Here the same sum is one GEMM per group:
//   M = kh*kw*Cg filter rows (tap-major, channel-minor: the HWIO layout, so the output is written in
//   place as (kh, kw, Cg, Cout)), N = Og = Cout/groups, and the reduction runs over the P = N*OH*OW
//   output positions. A block owns a BM x BN tile of dW and loops over its range of positions,
//   gathering input patches (A, masked to 0 outside the image: the padding is never materialised)
//   and dY rows (B) into shared memory. Sums are fp32 and the output is fp32 whatever the input type,
//   as the TPU kernel's.
//
// The TPU grid's carry across images has no counterpart on the card (blocks run in parallel, in no
// order), so the reduction over P is split across blocks instead: dl4j_conv2d_wgrad_plan sizes the
// split to one wave of resident blocks; each split writes its partial dW into an fp32 workspace
// [splits][kh*kw*Cg][Cout], and a second kernel adds the slices in split order. No atomics, so the
// result does not depend on scheduling.
//
// Two bodies, one per input type:
//   - fp32: FMA on the CUDA cores (TF32 stays off for fp32 parity), 128x128 tiles (128x64 when
//     Og <= 64), 8x8 outputs per thread, 8 positions per stage, register-staged double buffer.
//   - bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, fp32 accumulate), 128x64 tiles, 32
//     positions per stage; the patch and dY rows are gathered along channels and stored transposed
//     (position-contiguous) for the fragment loads.
//
// What bounds it on the card: ResNet-50's layers do hundreds of operations per byte, so the bound is
// arithmetic (the fp32 non-tensor rate, or the bf16 tensor-core rate). Left on the table: wgmma and
// TMA, a multi-stage cp.async ring (the bf16 body loads, syncs, then computes), ldmatrix.trans in
// place of the transposed shared-memory stores, and a persistent schedule in place of the split.

#include "conv_common.cuh"

namespace {

// fp32 FMA body (BN is 128 or 64)
constexpr int F_BM = 128;
constexpr int F_BK = 8;
// bf16 tensor-core body
constexpr int T_BM = 128;
constexpr int T_BN = 64;
constexpr int T_BK = 32;
// split over positions: most slices
constexpr int MAX_SPLITS = 128;

struct WgradGeom {
  int n, h, w, cin;
  int kh, kw, cout, groups;
  int oh, ow;
  int sh, sw, dh, dw;
  int pad_top, pad_left;
  int splits;         // position slices (blockIdx.z = group * splits + split)
  int p_per_split;    // positions per slice, a multiple of the body's BK
};

// Decomposition of one filter row r = (ki*kw + kj)*Cg + c: its input offsets and channel.
struct FilterRow {
  int dy_off, dx_off, c;
};

__device__ __forceinline__ FilterRow filter_row(const WgradGeom& g, int cg, int r) {
  const int tap = r / cg;
  const int ki = tap / g.kw;
  FilterRow f;
  f.c = r - tap * cg;
  f.dy_off = ki * g.dh - g.pad_top;
  f.dx_off = (tap - ki * g.kw) * g.dw - g.pad_left;
  return f;
}

// Output position p -> (image, oy*sh, ox*sw).
struct Position {
  long long img;
  int iy, ix;
};

__device__ __forceinline__ Position position(const WgradGeom& g, long long p) {
  const long long ohw = (long long)g.oh * g.ow;
  Position q;
  q.img = p / ohw;
  const int rem = (int)(p - q.img * ohw);
  const int oy = rem / g.ow;
  q.iy = oy * g.sh;
  q.ix = (rem - oy * g.ow) * g.sw;
  return q;
}

// ------------------------------------------------------------------ fp32, FMA on the CUDA cores

// Block tile F_BM filter rows x BN output channels, F_BK positions per stage, double-buffered: the
// next stage's global loads are in flight while this stage's products run. Thread (ty, tx) = (tid /
// 16, tid % 16) owns the 8 rows {ty*4 + i, 64 + ty*4 + i} and the TN = BN/16 columns {tx*HN + j,
// BN/2 + tx*HN + j}, as in the forward kernel.
// vec_a: Cg % 4 == 0, Cin % 4 == 0 and x 16-byte aligned (4 filter rows = 4 channels of one tap);
// vec_b: Og % 4 == 0, Cout % 4 == 0 and dy 16-byte aligned.
template <int BN>
__global__ void __launch_bounds__(THREADS)
conv2d_wgrad_f32(const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ out,
                 float* __restrict__ ws, WgradGeom g, int vec_a, int vec_b) {
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
  const int R = g.kh * g.kw * cg;
  const long long P = (long long)g.n * g.oh * g.ow;
  const long long pbeg = (long long)split * g.p_per_split;
  const long long pend = pbeg + g.p_per_split < P ? pbeg + g.p_per_split : P;
  const int r0 = blockIdx.x * F_BM;
  const int n0 = blockIdx.y * BN;

  // A gather: each thread owns one position (a_p) and 4 consecutive filter rows (a_r).
  const int a_p = tid >> 5;
  const int a_r = (tid & 31) * 4;
  FilterRow fr[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) fr[j] = filter_row(g, cg, r0 + a_r + j < R ? r0 + a_r + j : 0);
  const bool rows_valid = r0 + a_r < R;
  const float* x_grp = x + (long long)group * cg;

  // B load: thread tid < B_CHUNKS owns one position (b_p) and 4 consecutive output channels.
  const int b_p = tid / (BN / 4);
  const int b_n = (tid % (BN / 4)) * 4;
  const float* dy_grp = dy + (long long)group * og;

  float ra[4], rb[4];
  auto load = [&](long long p0) {
    const long long p = p0 + a_p;
    if (vec_a) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (rows_valid && p < pend) {
        const Position q = position(g, p);
        const int ih = q.iy + fr[0].dy_off;
        const int iw = q.ix + fr[0].dx_off;
        if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
          v = *reinterpret_cast<const float4*>(
              x_grp + ((q.img * g.h + ih) * g.w + iw) * g.cin + fr[0].c);
      }
      ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
    } else {
      Position q = {0, 0, 0};
      const bool pv = p < pend;
      if (pv) q = position(g, p);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = 0.f;
        if (pv && r0 + a_r + j < R) {
          const int ih = q.iy + fr[j].dy_off;
          const int iw = q.ix + fr[j].dx_off;
          if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
            v = x_grp[((q.img * g.h + ih) * g.w + iw) * g.cin + fr[j].c];
        }
        ra[j] = v;
      }
    }
    if (tid < B_CHUNKS) {
      const long long pb = p0 + b_p;
      const float* row = dy_grp + pb * g.cout;
      if (vec_b) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (pb < pend && n0 + b_n < og) v = *reinterpret_cast<const float4*>(row + n0 + b_n);
        rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nn = n0 + b_n + j;
          rb[j] = (pb < pend && nn < og) ? row[nn] : 0.f;
        }
      }
    }
  };
  auto store = [&](int buf) {
    *reinterpret_cast<float4*>(&As[buf][a_p][a_r]) = make_float4(ra[0], ra[1], ra[2], ra[3]);
    if (tid < B_CHUNKS)
      *reinterpret_cast<float4*>(&Bs[buf][b_p][b_n]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  const int ty = tid >> 4;
  const int tx = tid & 15;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  int buf = 0;
  if (pbeg < pend) {
    load(pbeg);
    store(0);
  }
  __syncthreads();
  for (long long p0 = pbeg; p0 < pend; p0 += F_BK) {
    const bool more = p0 + F_BK < pend;
    if (more) load(p0 + F_BK);
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

  float* dst = g.splits > 1 ? ws + (long long)split * R * g.cout : out;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= R) continue;
    float* orow = dst + (long long)r * g.cout + (long long)group * og;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int nn = n0 + (j < HN ? tx * HN + j : BN / 2 + tx * HN + j - HN);
      if (nn < og) orow[nn] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------ bf16, mma.sync on the tensor cores

// Shared tiles are stored position-minor (As[row][p], Bs[col][p]) so that the fragment reads are
// the forward kernel's; the global reads run along channels, so the stores transpose. Warp w
// gathers positions 0..31 of the stage for the rows (tid >> 5) * 16 .. +15 (A) and the columns
// (tid >> 5) * 8 .. +7 (B): for one j the 32 lanes write 32 consecutive halves of one row.
// vec_a: Cg % 16 == 0, Cin % 8 == 0 and x 16-byte aligned (16 rows = 16 channels of one tap,
// two 16-byte loads); vec_b: Og % 8 == 0, Cout % 8 == 0 and dy 16-byte aligned.
__global__ void __launch_bounds__(THREADS)
conv2d_wgrad_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                  float* __restrict__ out, float* __restrict__ ws, WgradGeom g, int vec_a,
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
  const int R = g.kh * g.kw * cg;
  const long long P = (long long)g.n * g.oh * g.ow;
  const long long pbeg = (long long)split * g.p_per_split;
  const long long pend = pbeg + g.p_per_split < P ? pbeg + g.p_per_split : P;
  const int r0 = blockIdx.x * T_BM;
  const int n0 = blockIdx.y * T_BN;

  // A gather: position a_p (the lane) and the 16 filter rows a_r .. a_r + 15 (the warp).
  const int a_p = lane;
  const int a_r = warp * 16;
  const FilterRow f0 = filter_row(g, cg, r0 + a_r < R ? r0 + a_r : 0);
  const uint16_t* x_grp = reinterpret_cast<const uint16_t*>(x) + (long long)group * cg;
  // B load: position b_p (the lane) and the 8 output channels b_n .. b_n + 7 (the warp).
  const int b_p = lane;
  const int b_n = warp * 8;
  const uint16_t* dy_grp = reinterpret_cast<const uint16_t*>(dy) + (long long)group * og;

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

  for (long long p0 = pbeg; p0 < pend; p0 += T_BK) {
    const long long p = p0 + a_p;
    const bool pv = p < pend;
    Position q = {0, 0, 0};
    if (pv) q = position(g, p);
    if (vec_a) {
      uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0;
      if (pv && r0 + a_r < R) {
        const int ih = q.iy + f0.dy_off;
        const int iw = q.ix + f0.dx_off;
        if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w) {
          const uint4* src = reinterpret_cast<const uint4*>(
              x_grp + ((q.img * g.h + ih) * g.w + iw) * g.cin + f0.c);
          v0 = src[0];
          v1 = src[1];
        }
      }
      const uint16_t* e0 = reinterpret_cast<const uint16_t*>(&v0);
      const uint16_t* e1 = reinterpret_cast<const uint16_t*>(&v1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        As[a_r + j][a_p] = e0[j];
        As[a_r + 8 + j][a_p] = e1[j];
      }
    } else {
      // walk the 16 rows from (tap, c) of row r0 + a_r, wrapping c into the next tap
      int c = f0.c;
      int tap = (r0 + a_r < R ? r0 + a_r : 0) / cg;
      int ki = tap / g.kw;
      int kj = tap - ki * g.kw;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint16_t v = 0;
        if (pv && r0 + a_r + j < R) {
          const int ih = q.iy + ki * g.dh - g.pad_top;
          const int iw = q.ix + kj * g.dw - g.pad_left;
          if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
            v = x_grp[((q.img * g.h + ih) * g.w + iw) * g.cin + c];
        }
        As[a_r + j][a_p] = v;
        if (++c == cg) {
          c = 0;
          if (++kj == g.kw) {
            kj = 0;
            ++ki;
          }
        }
      }
    }
    const long long pb = p0 + b_p;
    const uint16_t* row = dy_grp + pb * g.cout;
    if (vec_b) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (pb < pend && n0 + b_n < og) v = *reinterpret_cast<const uint4*>(row + n0 + b_n);
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) Bs[b_n + j][b_p] = e[j];
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nn = n0 + b_n + j;
        Bs[b_n + j][b_p] = (pb < pend && nn < og) ? row[nn] : 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < T_BK; ks += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = wm + i * 16 + gq;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&As[rr][ks + 2 * tq]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&As[rr + 8][ks + 2 * tq]);
        af[i][2] = *reinterpret_cast<const uint32_t*>(&As[rr][ks + 2 * tq + 8]);
        af[i][3] = *reinterpret_cast<const uint32_t*>(&As[rr + 8][ks + 2 * tq + 8]);
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
  float* dst = g.splits > 1 ? ws + (long long)split * R * g.cout : out;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + wm + i * 16 + gq + half * 8;
      if (r >= R) continue;
      float* orow = dst + (long long)r * g.cout + (long long)group * og;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = n0 + wn + j * 8 + 2 * tq;
        if (nn < og) orow[nn] = acc[i][j][half * 2];
        if (nn + 1 < og) orow[nn + 1] = acc[i][j][half * 2 + 1];
      }
    }
}

// ------------------------------------------------------------------ launch shape and plan

// The grid of one launch: the body's block tile over filter rows (BM) and Og (BN), and the
// positions in stages of BK.
struct LaunchShape {
  int bm, bn, bk;
  int r_tiles;         // BM tiles over kh*kw*Cg
  int n_tiles;         // BN tiles over Og
  long long stages;    // BK stages over N*OH*OW
};

LaunchShape launch_shape(int dtype, int n, int cin, int kh, int kw, int cout, int groups, int oh,
                         int ow) {
  const int og = cout / groups;
  LaunchShape l;
  l.bm = dtype == 0 ? F_BM : T_BM;
  l.bn = dtype == 0 ? (og > 64 ? 128 : 64) : T_BN;
  l.bk = dtype == 0 ? F_BK : T_BK;
  const int rows = kh * kw * (cin / groups);
  l.r_tiles = (rows + l.bm - 1) / l.bm;
  l.n_tiles = (og + l.bn - 1) / l.bn;
  l.stages = ((long long)n * oh * ow + l.bk - 1) / l.bk;
  return l;
}

// Blocks of one wave on the current device for the body a launch with this dtype and Og uses.
cudaError_t body_slots(int dtype, int og, int* slots) {
  static std::atomic<int> cache[3][MAX_DEVICES];
  if (dtype != 0) return wave_slots(conv2d_wgrad_bf16, cache[2], slots);
  if (og > 64) return wave_slots(conv2d_wgrad_f32<128>, cache[0], slots);
  return wave_slots(conv2d_wgrad_f32<64>, cache[1], slots);
}

}  // namespace

extern "C" {

// The position slices of one launch (dtype 0 = float32, 1 = bfloat16) on the current device: as
// many as fit its output tiles (BM x BN tiles of every group) into one wave of resident blocks,
// keeping at least MIN_STAGES_PER_SPLIT BK stages in each slice and at most MAX_SPLITS slices.
// splits > 1 means dl4j_conv2d_wgrad needs a workspace of splits * kh*kw*Cg * Cout floats.
// Returns a cudaError_t (0 on success).
int dl4j_conv2d_wgrad_plan(int dtype, int n, int cin, int kh, int kw, int cout, int groups, int oh,
                           int ow, int* splits) {
  if ((dtype != 0 && dtype != 1) || groups < 1 || splits == nullptr)
    return (int)cudaErrorInvalidValue;
  const LaunchShape l = launch_shape(dtype, n, cin, kh, kw, cout, groups, oh, ow);
  int slots = 0;
  const cudaError_t e = body_slots(dtype, cout / groups, &slots);
  if (e != cudaSuccess) return (int)e;
  *splits = plan_splits(slots, (long long)l.r_tiles * l.n_tiles * groups, l.stages, MAX_SPLITS);
  return 0;
}

// dW (kh, kw, Cin/groups, Cout) in fp32 from x (N, H, W, Cin) and dy (N, OH, OW, Cout), both NHWC
// in one type (dtype 0 = float32, 1 = bfloat16). Pads are the forward's explicit (top, left); the
// bottom/right pads are implied by oh/ow. `splits` comes from dl4j_conv2d_wgrad_plan; splits > 1
// needs `workspace`: splits * kh*kw*Cg * Cout floats. Returns the cudaError_t of the launches.
int dl4j_conv2d_wgrad(const void* x, const void* dy, void* out, int dtype,
                      int n, int h, int wd, int cin, int kh, int kw, int cout, int groups,
                      int oh, int ow, int sh, int sw, int dh, int dw,
                      int pad_top, int pad_left, int splits, void* workspace, void* stream) {
  if ((dtype != 0 && dtype != 1) || splits < 1 || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const int og = cout / groups;
  const int cg = cin / groups;
  const LaunchShape l = launch_shape(dtype, n, cin, kh, kw, cout, groups, oh, ow);
  WgradGeom g;
  g.n = n; g.h = h; g.w = wd; g.cin = cin;
  g.kh = kh; g.kw = kw; g.cout = cout; g.groups = groups;
  g.oh = oh; g.ow = ow;
  g.sh = sh; g.sw = sw; g.dh = dh; g.dw = dw;
  g.pad_top = pad_top; g.pad_left = pad_left;
  g.splits = splits;
  g.p_per_split = (int)(((l.stages + splits - 1) / splits) * l.bk);
  dim3 grid((unsigned)l.r_tiles, (unsigned)l.n_tiles, (unsigned)(groups * splits));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* of = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  (void)cudaGetLastError();  // report these launches' errors, not an older one
  const bool x16 = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool d16 = (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  if (dtype == 0) {
    const int vec_a = cg % 4 == 0 && cin % 4 == 0 && x16;
    const int vec_b = og % 4 == 0 && cout % 4 == 0 && d16;
    const float* xf = static_cast<const float*>(x);
    const float* df = static_cast<const float*>(dy);
    if (l.bn == 128)
      conv2d_wgrad_f32<128><<<grid, THREADS, 0, s>>>(xf, df, of, ws, g, vec_a, vec_b);
    else
      conv2d_wgrad_f32<64><<<grid, THREADS, 0, s>>>(xf, df, of, ws, g, vec_a, vec_b);
  } else {
    const int vec_a = cg % 16 == 0 && cin % 8 == 0 && x16;
    const int vec_b = og % 8 == 0 && cout % 8 == 0 && d16;
    conv2d_wgrad_bf16<<<grid, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                               static_cast<const __nv_bfloat16*>(dy), of, ws, g,
                                               vec_a, vec_b);
  }
  if (splits > 1) launch_reduce_splits(ws, of, (long long)kh * kw * cg * cout, splits, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
