// NHWC 2-D convolution filter gradient (wgrad) for Hopper (sm_90a), as an implicit GEMM.
//
// Replaces the TPU filter-gradient kernel of the JAX package:
//   deeplearning4j_tpu/ops/kernels/conv.py::_wgrad_kernel  (launched by _wgrad_pallas, grid (groups, N))
// The TPU kernel revisits one fp32 (kh, kw, Cg, Og) output block image after image on its sequential
// grid and adds, for each tap, patch(ki, kj)^T @ dY. Here the same sum is one GEMM per group:
//   M = kh*kw*Cg filter rows (tap-major, channel-minor: the HWIO layout, so the output is written in
//   place as (kh, kw, Cg, Cout)), N = Og = Cout/groups, and the reduction (K) runs over the
//   P = N*OH*OW output positions. Patches are gathered with the padding masked to 0 (never
//   materialised). Sums are fp32 and the output is fp32 whatever the input type, as the TPU
//   kernel's.
//
// The TPU grid's carry across images has no counterpart on the card (blocks run in parallel, in no
// order), so the reduction over P is split across blocks: each split writes its partial dW into an
// fp32 workspace [splits][kh*kw*Cg][Cout], and a second kernel (reduce_splits, below) adds
// the slices in an order fixed by the geometry. No atomics, so two runs are equal to the bit.
// dl4j_conv2d_wgrad_plan sizes the split and reports the body.
//
// Three bodies; which one runs is a pure function of the type and the geometry (pick_body):
//   - fp32: FMA on the CUDA cores (TF32 stays off for fp32 parity), 128x128 tiles (128x64 when
//     Og <= 64), 8x8 outputs per thread, 8 positions per stage, register-staged double buffer.
//   - bf16 wgmma (groups 1, Cin and Cout multiples of 64: every ResNet-50 wgrad but the stem's): a
//     persistent, warp-specialised block of one producer and two consumer warpgroups over a ring of
//     stages in shared memory (as many as 192 KB holds, up to eight), with a full and an empty
//     mbarrier per stage; the ring runs on across work items (M tile, N tile, split), so the next
//     item's loads overlap this one's products and epilogue. A chunk is 64 positions (K):
//       A (x's patch rows): for one tap, the 64 channels of one position are 128 bytes of an NHWC
//         pixel, one row of a 128-byte swizzle atom. One TMA load in im2col mode fetches a chunk's
//         64 positions of one A atom: x's im2col tensor map walks the output positions' base pixels
//         (a bounding box from (-pad_left, -pad_top) at the conv's strides, W, then H, then N) and
//         reads each at the tap's offset, so padding and positions past P read as 0 and no thread
//         gathers anything. The positions are K, so the tile is MN-major and wgmma reads it
//         through the transpose bit: no transposing stores. (A gather by 16-byte cp.async into the
//         same layout ran at some 15 GB/s an SM, two thirds of the kernel's time: PERF.md.)
//       B (dy's rows): dy as a 2-D [P, Cout] matrix, one TMA box of 64 positions x 64 channels per
//         64 columns, 128-byte swizzle, MN-major like A; the tensor map is encoded per call and
//         passed as __grid_constant__ (valid inside a CUDA-graph capture). Rows past P read as 0.
//       Tiles: a consumer owns 64 filter rows x CN columns (CN 128 where it divides the tile's
//         width, else 64). The two consumers split the tile over M (128 rows: two taps of 64
//         channels, or 128 channels of one tap) or, where kh*kw*Cg is 64 (ResNet-50's 1x1 convs
//         from 64 channels), over N (64 rows x 2 CN), so no tile is half empty in M. A consumer
//         with no rows or columns in the tile (an odd last M tile, Og 64 over N) skips its
//         products.
//       Producer: one thread in each of the producer warpgroup's four warps issues a chunk's loads
//         side by side (A atom 0, A atom 1, B atoms 0-1, B atoms 2-3), each with its own
//         expect_tx on the stage's full barrier (four arrivals); one thread issuing them all held
//         the ring back (PERF.md).
//       Consumers: wgmma.mma_async m64nCNk16, fp32 accumulators in registers; a stage is released
//         (one arrival per consumer warp) when the next chunk's products have started and its own
//         have completed (wait_group 1). The epilogue writes fp32 straight from the registers, to
//         dW or to the split's slice (a TMA store from a staging area in shared memory timed
//         slower: the staging costs the ring a stage; PERF.md).
//   - bf16 mma.sync (the rest: the stem's Cin 3, odd channel counts, groups > 1): mma.sync.m16n8k16
//     (bf16 in, fp32 accumulate), 128x64 tiles, 32 positions per stage; the patch and dY rows are
//     gathered along channels and stored transposed (position-contiguous) for the fragment loads.
//
// The split, per body. FMA and mma.sync: as many position slices as fit the output tiles into one
// wave of resident blocks, at least MIN_STAGES_PER_SPLIT stages each, at most MAX_SPLITS. wgmma:
// as many as fit its tiles into one wave, at least MIN_CHUNKS_PER_SPLIT chunks each: a slice
// writes BM x BN fp32 that the second launch reads back, so shorter slices cost the reduction
// more than they save in loads (2, 8 and 16 timed no better than 4 on ResNet-50's convs:
// tools/wgrad_ablation.py). The slices are reduced by that second launch (reduce_splits) rather
// than in the kernel by the block that completes a tile (an arrival counter): ResNet-50's dW is
// small and its P long, so a 1x1 conv from 64 channels runs its one tile in ninety-eight slices
// at batch 8; a last arriver would read all of them (6 MB) through one SM, where the second
// launch spreads the read over the card: four elements a thread, and where the slices are many,
// up to 32 threads an element, each summing its run of slices in split order before the
// element's first thread adds the runs in order.
//
// What bounds it on the card (ResNet-50 at batch 8): the bound is bytes for the 1x1 convs (x and
// dy read once: 0.0009-0.0048 ms at 3.35 TB/s, against 0.0002-0.0012 ms of bf16 tensor-core
// time), operations for the 3x3 convs at 14x14 and 28x28, and writing the fp32 dW for 7x7 512 ->
// 512 (9.4 MB). The wgmma body stays 3-10x above it, on fixed costs (tools/wgrad_ablation.py,
// PERF.md): some 1 us of launch, 2-3 us of second launch where there are slices, 1-1.5 us of
// epilogue stores, and about 0.3 us for each 64-position chunk an item walks even with no load
// and no product (the ring's handshake); the loads add 2-3 us, the products 1. Left on the table:
// the slices reduced in the kernel across a thread-block cluster (distributed shared memory, no
// second launch), a TMA store of the epilogue, longer chunks or 64 x 256 consumer tiles to cut
// the handshakes per product, and the fp32 body on TF32 tensor cores (refused for fp32 parity).

#include <climits>

#include "hopper.cuh"

namespace {

// fp32 FMA body (BN is 128 or 64)
constexpr int F_BM = 128;
constexpr int F_BK = 8;
// bf16 mma.sync body
constexpr int T_BM = 128;
constexpr int T_BN = 64;
constexpr int T_BK = 32;
// split over positions (FMA and mma.sync): most slices
constexpr int MAX_SPLITS = 128;
// bf16 wgmma body: one producer and two consumer warpgroups, 64 positions a chunk
constexpr int G_THREADS = 384;
constexpr int G_BK = 64;
// a wgmma split keeps at least this many chunks
constexpr int MIN_CHUNKS_PER_SPLIT = 4;
// threads of a split-reduction block
constexpr int R_THREADS = 64;

enum Body { BODY_FMA = 0, BODY_MMA = 1, BODY_WGMMA = 2 };

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

// ------------------------------------------------------------------ split reduction

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ float shfl(float v, int lane) { return __shfl_sync(~0u, v, lane); }
__device__ __forceinline__ float4 shfl(const float4& v, int lane) {
  return make_float4(shfl(v.x, lane), shfl(v.y, lane), shfl(v.z, lane), shfl(v.w, lane));
}

// out[i] = the sum over s of ws[s][i], for `total` elements of V (float, or float4: four
// consecutive floats). A group of `lanes` threads (a power of two up to 32, inside one warp) shares
// an element: lane j sums the slices [j*per, (j+1)*per) in split order, eight loads in flight, and
// the group's first lane adds the lanes' sums in lane order. The order depends only on `splits`
// and `lanes`, which the plan fixes per geometry, so two runs are equal to the bit.
template <typename V>
__global__ void __launch_bounds__(R_THREADS)
reduce_splits(const V* __restrict__ ws, V* __restrict__ out, long long total, int splits,
              int lanes) {
  constexpr int ILP = 8;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = t / lanes;
  const int j = (int)(t & (lanes - 1));
  const int per = (splits + lanes - 1) / lanes;
  const int k_end = min(splits, (j + 1) * per);
  V s = V();  // zero
  if (i < total && j * per < k_end) {
    int k = j * per;
    s = ws[(long long)k * total + i];
    for (++k; k + ILP <= k_end; k += ILP) {
      V v[ILP];
#pragma unroll
      for (int u = 0; u < ILP; ++u) v[u] = ws[(long long)(k + u) * total + i];
#pragma unroll
      for (int u = 0; u < ILP; ++u) add_to(s, v[u]);
    }
    for (; k < k_end; ++k) add_to(s, ws[(long long)k * total + i]);
  }
  V sum = s;
  const int first = (threadIdx.x & 31) & ~(lanes - 1);
  for (int m = 1; m < lanes; ++m) {
    const V o = shfl(s, first + m);  // every lane of the warp takes part
    if (j == 0) add_to(sum, o);
  }
  if (i < total && j == 0) out[i] = sum;
}

// The second pass of a split launch: the `splits` fp32 slices of `ws`, `total` elements each,
// summed into `out` in a fixed order (no atomics, so the result does not depend on scheduling);
// by float4 where `total` and both pointers allow it, with as many lanes an element (up to 32,
// eight slices a lane or more) as bring the threads to some 2^18, so a small dW of many slices
// still spreads over the card.
inline void launch_reduce_splits(const float* ws, float* out, long long total, int splits,
                                 cudaStream_t s) {
  const bool vec = total % 4 == 0 && (reinterpret_cast<uintptr_t>(ws) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const long long n = vec ? total / 4 : total;
  int lanes = 1;
  while (lanes < 32 && 16 * lanes <= splits && n * lanes < (1 << 18)) lanes *= 2;
  const unsigned grid = (unsigned)((n * lanes + R_THREADS - 1) / R_THREADS);
  if (vec)
    reduce_splits<float4><<<grid, R_THREADS, 0, s>>>(reinterpret_cast<const float4*>(ws),
                                                     reinterpret_cast<float4*>(out), n, splits,
                                                     lanes);
  else
    reduce_splits<float><<<grid, R_THREADS, 0, s>>>(ws, out, n, splits, lanes);
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

// ------------------------------------------------------------ bf16, wgmma + TMA + an mbarrier ring

// A consumer's 64 filter rows x CN columns; SPLIT_N: the two consumers split the tile over N
// (64 x 2 CN), else over M (128 x CN).
template <int CN, int SPLIT_N>
struct GTile {
  static constexpr int ATOM = G_BK * 128;                       // 64 positions x 64 channels
  static constexpr int A_BYTES = (SPLIT_N ? 1 : 2) * ATOM;        // the tile's filter rows
  static constexpr int B_BYTES = (SPLIT_N ? 2 : 1) * CN / 64 * ATOM;  // its output channels
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // as many stages as 192 KB holds, at most 8: one block an SM
  static constexpr int STAGES = 192 * 1024 / STAGE < 8 ? 192 * 1024 / STAGE : 8;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BYTES = RING + 16 * STAGES + 1024;  // + barriers, 1024-byte alignment
  static constexpr int ACC = CN / 2;  // fp32 accumulators a consumer thread holds
};

// What the wgmma body's blocks read (groups 1, so Cg = Cin and Og = Cout).
struct WgmmaGeom {
  int cin, cout, kw;
  int oh, ow, sh, sw, dh, dw, pad_top, pad_left;
  int rows;       // R = kh*kw*Cin
  int positions;  // P = N*OH*OW (< 2^31)
  int bm, bn;     // the block tile: 128 x CN (split over M) or 64 x 2 CN (split over N)
  int split_n;
  int m_tiles, n_tiles, splits;
  int chunks_per_split;
};

// Cin and Cout are multiples of 64 (pick_body), so an A atom (64 filter rows) is 64 channels of
// one tap and a consumer's rows and columns are all inside dW or all outside. x and dy are
// 16-byte aligned (the wrapper's copy). Persistent: the grid is what fits on the card, and each
// block walks the work items (M tile fastest, then N tile, then split) blockIdx.x, + gridDim.x, ...
template <int CN, int SPLIT_N>
__global__ void __launch_bounds__(G_THREADS, 1)
conv2d_wgrad_wgmma(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_dy,
                   float* __restrict__ out, float* __restrict__ ws,
                   const __grid_constant__ WgmmaGeom g) {
  using T = GTile<CN, SPLIT_N>;
  constexpr int S = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle repeats at 1 KB
  const uint32_t bar_full = base + T::RING;                       // 8 bytes each
  const uint32_t bar_empty = bar_full + 8 * S;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // 0: producer; 1, 2: consumers
  const int items = g.m_tiles * g.n_tiles * g.splits;
  const int chunks_total = (g.positions + G_BK - 1) / G_BK;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < S; ++st) {
      mbar_init(bar_full + 8 * st, 4);   // one arrival per producer warp
      mbar_init(bar_empty + 8 * st, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int ring_pos = 0;  // chunks through the ring so far, this block's items together
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int m_tile = item % g.m_tiles;
    const int rest = item / g.m_tiles;
    const int n_tile = rest % g.n_tiles;
    const int split = rest / g.n_tiles;
    const int r0 = m_tile * g.bm;
    const int n0 = n_tile * g.bn;
    const int c_beg = split * g.chunks_per_split;
    const int chunks = max(0, min(chunks_total, c_beg + g.chunks_per_split) - c_beg);
    const int a_atoms = min(g.bm, g.rows - r0) / 64;  // 64-row A atoms in this tile: 1 or 2
    const int b_atoms = min(g.bn, g.cout - n0) / 64;  // 64-column B atoms: 1 to 4

    if (wg == 0) {
      // ---- producer warpgroup: lane 0 of warp w issues A atom w (w < 2) or B atoms 2 (w - 2)
      // and 2 (w - 2) + 1 (w >= 2), so four threads issue a chunk's loads side by side
      const int w = tid >> 5;
      if ((tid & 31) != 0) continue;
      const int first = w < 2 ? w : 2 * (w - 2);
      const int count = w < 2 ? (w < a_atoms ? 1 : 0) : max(0, min(2, b_atoms - first));
      int c0 = 0, off_w = 0, off_h = 0;
      if (w < 2) {
        const int r = min(r0 + 64 * w, g.rows - 64);
        const int tap = r / g.cin;
        const int ki = tap / g.kw;
        c0 = r - tap * g.cin;
        off_h = ki * g.dh;
        off_w = (tap - ki * g.kw) * g.dw;
      }
      const int ohw = g.oh * g.ow;
      for (int c = 0; c < chunks; ++c, ++ring_pos) {
        const int st = ring_pos % S;
        const uint32_t full = bar_full + 8 * st;
        mbar_wait(bar_empty + 8 * st, ((ring_pos / S) & 1) ^ 1);  // the first lap passes
        if (count == 0) {
          mbar_arrive(full);
          continue;
        }
        mbar_expect_tx(full, count * T::ATOM);
        const int p0 = (c_beg + c) * G_BK;  // the chunk's first position
        if (w < 2) {
          // the input pixel the first position's window starts at
          const int img = p0 / ohw;
          const int oy = (p0 - img * ohw) / g.ow;
          const int ox = p0 - img * ohw - oy * g.ow;
          tma_load_im2col(base + st * T::STAGE + w * T::ATOM, &tm_x, full, c0,
                          ox * g.sw - g.pad_left, oy * g.sh - g.pad_top, img, (uint16_t)off_w,
                          (uint16_t)off_h);
        } else {
          for (int b = first; b < first + count; ++b)
            tma_load_2d(base + st * T::STAGE + T::A_BYTES + b * T::ATOM, &tm_dy, full,
                        n0 + 64 * b, p0);
        }
      }
    } else {
      // ---- consumer warpgroup cw: 64 filter rows x CN columns of the tile
      const int cw = wg - 1;
      const int lane = tid & 31, warp = (tid >> 5) & 3;
      const int a_atom = SPLIT_N ? 0 : cw;
      const int b_atom0 = SPLIT_N ? cw * (CN / 64) : 0;
      const bool active = a_atom < a_atoms && b_atom0 < b_atoms;  // uniform over the warpgroup
      float acc[T::ACC];
#pragma unroll
      for (int i = 0; i < T::ACC; ++i) acc[i] = 0.f;
      for (int c = 0; c < chunks; ++c, ++ring_pos) {
        const int st = ring_pos % S;
        const uint32_t s_a = base + st * T::STAGE + a_atom * T::ATOM;
        const uint32_t s_b = base + st * T::STAGE + T::A_BYTES + b_atom0 * T::ATOM;
        mbar_wait(bar_full + 8 * st, (ring_pos / S) & 1);
        if (!active) {  // nothing of this tile is ours: hand the stage straight back
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_empty + 8 * st);
          continue;
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G_BK / 16; ++kk) {
          const uint64_t da = desc_mn_major(s_a + kk * 16 * 128, T::ATOM);
          const uint64_t db = desc_mn_major(s_b + kk * 16 * 128, T::ATOM);
          if constexpr (CN == 64)
            wgmma_n64<1, 1>(acc, da, db);
          else
            wgmma_n128<1, 1>(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's products are done: release its stage
        fence_regs(acc);
        if (c > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_empty + 8 * ((ring_pos - 1) % S));
        }
      }
      if (active) {
        wgmma_wait<0>();
        fence_regs(acc);
        if (chunks > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_empty + 8 * ((ring_pos - 1) % S));
        }
        // Epilogue, fp32 from the registers. Accumulator element 4n + 2h + e is row 16 warp +
        // lane / 4 + 8 h, column 8 n + 2 (lane % 4) + e of the consumer's 64 x CN.
        float* dst = g.splits > 1 ? ws + (long long)split * g.rows * g.cout : out;
        const int row0 = r0 + 64 * a_atom + 16 * warp + (lane >> 2);
        const int col0 = n0 + 64 * b_atom0 + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* drow = dst + (long long)(row0 + 8 * h) * g.cout + col0;
#pragma unroll
          for (int n = 0; n < CN / 8; ++n)
            *reinterpret_cast<float2*>(drow + 8 * n) =
                make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ body, plan and launch

// One launch's geometry, as the C entries take it: x (n, h, w, cin), dW (kh, kw, cin / groups,
// cout), dy (n, oh, ow, cout), the forward's strides, dilation and explicit (top, left) pads.
struct WgradArgs {
  int n, h, w, cin, kh, kw, cout, groups, oh, ow, sh, sw, dh, dw, pad_top, pad_left;
};

// The bounding box of x's im2col tensor map (lower, upper: w then h), whose corners and the taps'
// offsets a 4-D map holds within [-128, 127] and [0, 127], at element strides up to 8: the base
// pixels run from (-pad_left, -pad_top) in steps of the stride, OW (OH) of them a row (column).
void im2col_box(const WgradArgs& a, int* lower, int* upper) {
  lower[0] = -a.pad_left;
  lower[1] = -a.pad_top;
  upper[0] = -a.pad_left + (a.ow - 1) * a.sw + 1 - a.w;
  upper[1] = -a.pad_top + (a.oh - 1) * a.sh + 1 - a.h;
}

bool im2col_fits(const WgradArgs& a) {
  int lower[2], upper[2];
  im2col_box(a, lower, upper);
  for (int i = 0; i < 2; ++i)
    if (lower[i] < -128 || lower[i] > 127 || upper[i] < -128 || upper[i] > 127) return false;
  return a.sh <= 8 && a.sw <= 8 && (a.kh - 1) * a.dh <= 127 && (a.kw - 1) * a.dw <= 127;
}

// The body a launch of this type and geometry runs: the one place that decides it
// (ops/kernels/conv.py::wgrad_body mirrors it).
Body pick_body(int dtype, const WgradArgs& a) {
  if (dtype == 0) return BODY_FMA;
  return a.groups == 1 && a.cin % 64 == 0 && a.cout % 64 == 0 && im2col_fits(a) ? BODY_WGMMA
                                                                                  : BODY_MMA;
}

// The geometry checks of dl4j_conv2d_wgrad_plan and dl4j_conv2d_wgrad.
bool valid_geometry(int dtype, const WgradArgs& a) {
  return (dtype == 0 || dtype == 1) && a.n >= 1 && a.h >= 1 && a.w >= 1 && a.groups >= 1 &&
         a.cin >= a.groups && a.cout >= a.groups && a.cin % a.groups == 0 &&
         a.cout % a.groups == 0 && a.kh >= 1 && a.kw >= 1 && a.oh >= 1 && a.ow >= 1 &&
         a.sh >= 1 && a.sw >= 1 && a.dh >= 1 && a.dw >= 1 && a.pad_top >= 0 && a.pad_left >= 0 &&
         (long long)a.n * a.oh * a.ow <= INT_MAX &&
         (long long)a.kh * a.kw * (a.cin / a.groups) <= INT_MAX / 2;
}

// The FMA and mma.sync grids: the block tile over filter rows (BM) and Og (BN), and the
// positions in stages of BK.
struct LaunchShape {
  int bm, bn, bk;
  int r_tiles;         // BM tiles over kh*kw*Cg
  int n_tiles;         // BN tiles over Og
  long long stages;    // BK stages over N*OH*OW
};

LaunchShape launch_shape(int dtype, const WgradArgs& a) {
  const int og = a.cout / a.groups;
  LaunchShape l;
  l.bm = dtype == 0 ? F_BM : T_BM;
  l.bn = dtype == 0 ? (og > 64 ? 128 : 64) : T_BN;
  l.bk = dtype == 0 ? F_BK : T_BK;
  const int rows = a.kh * a.kw * (a.cin / a.groups);
  l.r_tiles = (rows + l.bm - 1) / l.bm;
  l.n_tiles = (og + l.bn - 1) / l.bn;
  l.stages = ((long long)a.n * a.oh * a.ow + l.bk - 1) / l.bk;
  return l;
}

// The wgmma body's geometry, before the split: CN columns a consumer, the two consumers over M,
// or over N where R is one A atom.
WgmmaGeom wgmma_geom(const WgradArgs& a) {
  WgmmaGeom g;
  g.cin = a.cin; g.cout = a.cout; g.kw = a.kw;
  g.oh = a.oh; g.ow = a.ow; g.sh = a.sh; g.sw = a.sw; g.dh = a.dh; g.dw = a.dw;
  g.pad_top = a.pad_top; g.pad_left = a.pad_left;
  g.rows = a.kh * a.kw * a.cin;
  g.positions = a.n * a.oh * a.ow;
  g.split_n = g.rows == 64;
  const int cn = g.cout % (g.split_n ? 256 : 128) == 0 ? 128 : 64;
  g.bm = g.split_n ? 64 : 128;
  g.bn = g.split_n ? 2 * cn : cn;
  g.m_tiles = (g.rows + g.bm - 1) / g.bm;
  g.n_tiles = (g.cout + g.bn - 1) / g.bn;
  g.splits = 1;
  g.chunks_per_split = 0;
  return g;
}

int consumer_cols(const WgmmaGeom& g) { return g.split_n ? g.bn / 2 : g.bn; }

template <int CN, int SN>
cudaError_t wgmma_slots(std::atomic<int>* cache, int* slots) {
  static std::atomic<bool> done[MAX_DEVICES];
  const cudaError_t e = allow_smem(conv2d_wgrad_wgmma<CN, SN>, GTile<CN, SN>::BYTES, done);
  if (e != cudaSuccess) return e;
  return wave_slots(conv2d_wgrad_wgmma<CN, SN>, cache, slots, G_THREADS, GTile<CN, SN>::BYTES);
}

// Blocks of one wave on the current device for the body (and, for wgmma, its consumer width and
// split) a launch uses.
cudaError_t body_slots(Body body, int og, int cn, bool split_n, int* slots) {
  static std::atomic<int> cache[7][MAX_DEVICES];
  if (body == BODY_WGMMA) {
    if (cn == 128)
      return split_n ? wgmma_slots<128, 1>(cache[3], slots) : wgmma_slots<128, 0>(cache[4], slots);
    return split_n ? wgmma_slots<64, 1>(cache[5], slots) : wgmma_slots<64, 0>(cache[6], slots);
  }
  if (body == BODY_MMA) return wave_slots(conv2d_wgrad_bf16, cache[2], slots);
  if (og > 64) return wave_slots(conv2d_wgrad_f32<128>, cache[0], slots);
  return wave_slots(conv2d_wgrad_f32<64>, cache[1], slots);
}

// The wgmma body's position slices: as many as fit its tiles into one wave of `slots` blocks, at
// least MIN_CHUNKS_PER_SPLIT chunks each, then as few as hold the chunks at that many a slice.
int wgmma_splits(int slots, long long tiles, long long chunks) {
  long long s = slots / tiles;
  if (s > chunks / MIN_CHUNKS_PER_SPLIT) s = chunks / MIN_CHUNKS_PER_SPLIT;
  if (s <= 1) return 1;
  const long long per = (chunks + s - 1) / s;
  return (int)((chunks + per - 1) / per);
}

template <int CN, int SN>
void launch_wgmma(const CUtensorMap& map_x, const CUtensorMap& map_dy, float* out, float* ws,
                  const WgmmaGeom& g, unsigned blocks, cudaStream_t s) {
  conv2d_wgrad_wgmma<CN, SN><<<blocks, G_THREADS, GTile<CN, SN>::BYTES, s>>>(map_x, map_dy, out,
                                                                            ws, g);
}

// The wgmma body's launch: x's im2col map and dy's [P, Cout] map (boxes of 64 channels x 64
// positions), encoded per call, and a persistent grid of what fits on the card.
cudaError_t launch_wgmma_body(const void* x, const void* dy, float* out, float* ws,
                              const WgradArgs& a, int splits, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(x) & 15) != 0 || (reinterpret_cast<uintptr_t>(dy) & 15) != 0)
    return cudaErrorMisalignedAddress;
  WgmmaGeom g = wgmma_geom(a);
  const long long chunks = ((long long)g.positions + G_BK - 1) / G_BK;
  g.splits = splits;
  g.chunks_per_split = (int)((chunks + splits - 1) / splits);
  const long long items = (long long)g.m_tiles * g.n_tiles * splits;
  if (items > INT_MAX) return cudaErrorInvalidConfiguration;
  int lower[2], upper[2];
  im2col_box(a, lower, upper);
  CUtensorMap map_x, map_dy;
  if (!encode_im2col(&map_x, x, a.n, a.h, a.w, a.cin, lower, upper, a.sh, a.sw, G_BK) ||
      !encode_2d(&map_dy, dy, g.positions, a.cout, G_BK))
    return cudaErrorInvalidValue;
  const int cn = consumer_cols(g);
  int slots = 0;
  const cudaError_t e = body_slots(BODY_WGMMA, a.cout, cn, g.split_n, &slots);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)(items < slots ? items : slots);
  if (cn == 128 && g.split_n)
    launch_wgmma<128, 1>(map_x, map_dy, out, ws, g, blocks, s);
  else if (cn == 128)
    launch_wgmma<128, 0>(map_x, map_dy, out, ws, g, blocks, s);
  else if (g.split_n)
    launch_wgmma<64, 1>(map_x, map_dy, out, ws, g, blocks, s);
  else
    launch_wgmma<64, 0>(map_x, map_dy, out, ws, g, blocks, s);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The plan of one launch (dtype 0 = float32, 1 = bfloat16; the geometry as dl4j_conv2d_wgrad
// takes it) on the current device: the body it runs (*body: 0 fp32 FMA, 1 bf16 mma.sync, 2 bf16
// wgmma) and its position slices (*splits), sized to one wave of resident blocks of that body
// (see the note at the top). splits > 1 means dl4j_conv2d_wgrad needs a workspace of splits *
// kh*kw*Cg * Cout floats. Returns a cudaError_t (0 on success).
int dl4j_conv2d_wgrad_plan(int dtype, int n, int h, int wd, int cin, int kh, int kw, int cout,
                           int groups, int oh, int ow, int sh, int sw, int dh, int dw,
                           int pad_top, int pad_left, int* splits, int* body) {
  const WgradArgs a = {n, h, wd, cin, kh, kw, cout, groups, oh, ow, sh, sw, dh, dw, pad_top,
                       pad_left};
  if (!valid_geometry(dtype, a) || splits == nullptr || body == nullptr)
    return (int)cudaErrorInvalidValue;
  const Body b = pick_body(dtype, a);
  int slots = 0;
  if (b == BODY_WGMMA) {
    const WgmmaGeom g = wgmma_geom(a);
    const cudaError_t e = body_slots(b, cout, consumer_cols(g), g.split_n, &slots);
    if (e != cudaSuccess) return (int)e;
    *splits = wgmma_splits(slots, (long long)g.m_tiles * g.n_tiles,
                           ((long long)g.positions + G_BK - 1) / G_BK);
  } else {
    const LaunchShape l = launch_shape(dtype, a);
    const cudaError_t e = body_slots(b, cout / groups, 0, false, &slots);
    if (e != cudaSuccess) return (int)e;
    *splits = plan_splits(slots, (long long)l.r_tiles * l.n_tiles * groups, l.stages, MAX_SPLITS);
  }
  *body = (int)b;
  return 0;
}

// dW (kh, kw, Cin/groups, Cout) in fp32 from x (N, H, W, Cin) and dy (N, OH, OW, Cout), both NHWC
// in one type (dtype 0 = float32, 1 = bfloat16). Pads are the forward's explicit (top, left); the
// bottom/right pads are implied by oh/ow. `splits` comes from dl4j_conv2d_wgrad_plan; splits > 1
// needs `workspace`: splits * kh*kw*Cg * Cout floats. The bf16 wgmma body needs x and dy 16-byte
// aligned. Returns the cudaError_t of the launches.
int dl4j_conv2d_wgrad(const void* x, const void* dy, void* out, int dtype,
                      int n, int h, int wd, int cin, int kh, int kw, int cout, int groups,
                      int oh, int ow, int sh, int sw, int dh, int dw,
                      int pad_top, int pad_left, int splits, void* workspace, void* stream) {
  const WgradArgs a = {n, h, wd, cin, kh, kw, cout, groups, oh, ow, sh, sw, dh, dw, pad_top,
                       pad_left};
  if (!valid_geometry(dtype, a) || splits < 1 || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const int og = cout / groups;
  const int cg = cin / groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* of = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  (void)cudaGetLastError();  // report these launches' errors, not an older one
  const Body body = pick_body(dtype, a);
  if (body == BODY_WGMMA) {
    const cudaError_t e = launch_wgmma_body(x, dy, of, ws, a, splits, s);
    if (e != cudaSuccess) return (int)e;
  } else {
    const LaunchShape l = launch_shape(dtype, a);
    WgradGeom g;
    g.n = n; g.h = h; g.w = wd; g.cin = cin;
    g.kh = kh; g.kw = kw; g.cout = cout; g.groups = groups;
    g.oh = oh; g.ow = ow;
    g.sh = sh; g.sw = sw; g.dh = dh; g.dw = dw;
    g.pad_top = pad_top; g.pad_left = pad_left;
    g.splits = splits;
    g.p_per_split = (int)(((l.stages + splits - 1) / splits) * l.bk);
    dim3 grid((unsigned)l.r_tiles, (unsigned)l.n_tiles, (unsigned)(groups * splits));
    const bool x16 = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const bool d16 = (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
    if (body == BODY_FMA) {
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
  }
  if (splits > 1) launch_reduce_splits(ws, of, (long long)kh * kw * cg * cout, splits, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
