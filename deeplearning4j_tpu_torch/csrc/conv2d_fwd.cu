// NHWC x HWIO 2-D convolution for Hopper (sm_90a), as an implicit GEMM: the forward, and the
// input gradient (dgrad) split by stride phase.
//
// Replaces the TPU forward kernels of the JAX package:
//   deeplearning4j_tpu/ops/kernels/conv.py::_fwd_kernel        (one program per (image, group))
//   deeplearning4j_tpu/ops/kernels/conv.py::_fwd_kernel_tiled  (the same, row_tile output rows per program)
// and their reuse for the input gradient in _conv_vjp_bwd.
// The TPU kernels read a pre-padded image into VMEM and, for each kernel tap, do one strided
// window x (Cg, Og) matmul on the MXU. Here the same sum is one GEMM per group:
//   M = output positions, N = Og = Cout/groups, K = taps*Cg (tap-major, channel-minor, which is
//   the HWIO weight layout, so a row of B is a contiguous run of Cout).
// A block owns a BM x BN output tile of one group and loops over its K range, staging gathered
// input patches (A) and weights (B) in shared memory. Out-of-range input rows and columns (the
// padding) are zero-filled while gathering, so no padded copy exists in HBM. Stride, dilation and
// groups are index arithmetic. Products are summed in fp32 and the output written in the input
// type.
//
// The gather is driven by a phase plan (ConvSpec, built by ops/kernels/conv.py), one per spatial
// axis: the outputs fall into phases; phase r has n_out[r] outputs at out0[r] + o * out_step, and
// taps tap0[r] .. tap0[r+1]-1, tap t reading input o * in_step + off[t] with weight index wk[t].
// A 2-D phase is a pair of axis phases; the M walk runs over the 2-D phases one after the other
// (tile0[p] is phase p's first M tile), so every phase is part of one launch.
//   - forward: one phase per axis, in_step = stride, out_step = 1, off[ki] = ki * dil - pad_lo,
//     wk[ki] = ki.
//   - dgrad (dx of a conv with stride s, dilation d, low pad lo): dx row ih gets dy row oh through
//     tap ki exactly when oh * s - lo + ki * d = ih, so the rows with (ih + lo) mod s = r form a
//     phase whose taps are the ki with ki * d = r (mod s), each at dy offset (r - ki * d) / s:
//     a stride-1 gather over the undilated dy (in_step 1, out_step s). The flipped,
//     I/O-transposed weights of the reference's _flip_transpose_w are not copied: the kernel
//     reads the forward's weights in place (ConvSpec::b_trans), tap ki at weight index ki. No
//     zero-dilated dy exists and no product with one of its zeros is computed. A phase with no
//     taps (three of the four of a 1x1 stride-2 conv) has K = 0: its blocks write zeros in their
//     epilogue, since the output comes from torch.empty and nothing else clears it.
//
// Three bodies; which one runs is a pure function of the type and the geometry (pick_body, the
// one place; dl4j_conv2d_plan reports it):
//   - fp32: FMA on the CUDA cores, 128x128 tiles (128x64 when Og <= 64), 8x8 outputs per thread,
//     double-buffered. TF32 tensor cores are not used: the port holds fp32 to fp32 parity with
//     the reference. A forward's plan runs it in its plain form (conv_fwd_plain.cuh: stride,
//     dilation and pads as arithmetic); any other plan in the phased form below, where each
//     thread walks its taps and looks a tap's offsets up once.
//   - bf16 wgmma (Cg and Og multiples of 64, every ResNet-50 conv but the stem, and every one of
//     its dgrads): a persistent, warp-specialised block of one producer and two consumer
//     warpgroups over a ring in shared memory (four stages at BN 128, three at BN 64 with two
//     blocks an SM), with a full and an empty mbarrier per stage. Each block walks work items
//     (M tile, BN tile, group, split); the ring runs on across them, so the next item's loads
//     overlap this one's products and epilogue.
//       B (the weights, [K][Cout] row-major, so MN-major): TMA (cp.async.bulk.tensor) on a 2-D
//         tensor map over (Cout, K rows), boxes of 64 columns x 64 K rows, 128-byte swizzle,
//         encoded on the host per call and passed as __grid_constant__ (valid inside a CUDA-graph
//         capture); wgmma reads it through the descriptor's transpose bit. For dgrad (b_trans)
//         the forward's weights are read as stored: B's rows are then the output channels and
//         the tile is K-major, one box of 64 K columns x BN rows.
//       A (the gathered patches): a 64-deep K chunk is 64 contiguous channels of one tap, 128
//         bytes of one NHWC pixel: one row of a 128-byte swizzle atom. The producer warpgroup
//         fills it with 16-byte cp.async into the swizzled layout (src-size 0 zero-fills padding
//         and rows past M), then cp.async.mbarrier.arrive.noinc on the stage's full barrier; the
//         full barrier counts those 128 arrivals and the TMA's expect_tx.
//       Consumers: wgmma.mma_async m64nNk16 (N = 128 where Og is a multiple of 128, else 64), A
//         and B from shared memory by descriptor, 64 output rows each, fp32 accumulators in
//         registers; a stage is released (one arrival per consumer warp) when the product of the
//         next chunk has been started and the stage's own has completed (wait_group 1). The
//         epilogue stages each warp's 16 rows in shared memory of its own and writes whole
//         output rows, 16 bytes a lane (split slices go out as fp32 from the registers).
//   - bf16 mma.sync (the rest: the stem's Cin 3, odd channel counts): mma.sync.m16n8k16, 128x64
//     tiles, 8 warps of 32x32; channel runs of 16 are gathered with 16-byte loads. Plain and
//     phased forms as for fp32.
//
// row_tile (the TPU kernel's tuning knob) cuts a phase's M into segments of row_tile output rows
// of one image; no M tile crosses a segment, in any body. 0 means one segment over the phase.
//
// Split-K: when a geometry gives too few output tiles to fill the card (ResNet-50's res4/res5 at
// small batch), dl4j_conv2d_plan asks for `splits` > 1, sized to one wave of resident blocks of
// the body the launch uses (the occupancy calculator's count). blockIdx.z (or the wgmma body's
// item walk) then covers (group, split); each split sums its own slice of K into an fp32
// workspace [splits][rows][Cout] whose rows are the positions of the phases with taps (a slice
// past a phase's K writes zeros there; a tapless phase's blocks of split 0 write their zeros to
// the output, the others exit), and a second kernel (reduce_conv_splits) adds the slices in a
// fixed order and writes each row to its output position, so the result does not depend on
// scheduling.
//
// What bounds it on the card: ResNet-50's 3x3 and 1x1 convolutions at batch >= 8 do hundreds of
// operations per byte moved, so the bound is arithmetic: the fp32 non-tensor rate for fp32, the
// bf16 tensor-core rate for bf16. Left on the table in the wgmma body: TMA im2col for A (the
// producer spends 8 cp.async per thread per chunk), a TMA store of the output, two consumer
// warpgroups taking turns (one's epilogue under the other's products), and a stream-K walk in
// place of split-K for the small-M layers.

#include <cuda.h>

#include <algorithm>
#include <climits>
#include <mutex>

#include "conv_fwd_plain.cuh"
#include "hopper.cuh"

// The plan structs cross the C interface (dl4j_conv2d takes a ConvSpec), so they live outside the
// anonymous namespace: an extern "C" function whose parameter type has internal linkage would
// have internal linkage itself.
// phase plan limits: phases (the stride) and taps (the kernel extent) per axis
constexpr int MAX_AXIS_PHASES = 8;
constexpr int MAX_AXIS_TAPS = 32;
// One spatial axis of the phase plan (ops/kernels/conv.py builds it; see the note at the top).
struct ConvAxis {
  int phases;
  int in_size, out_size;  // input and output extent along the axis
  int in_step, out_step;
  int n_out[MAX_AXIS_PHASES];
  int out0[MAX_AXIS_PHASES];
  int tap0[MAX_AXIS_PHASES + 1];
  int off[MAX_AXIS_TAPS];
  int wk[MAX_AXIS_TAPS];
};

// A launch as the host describes it: x (n, ax[0].in_size, ax[1].in_size, cin), w (kh, kw,
// cin / groups, cout) or, with b_trans, the forward's weights of the conv whose input gradient
// this is, (kh, kw, cout / groups, cin), read as B(k = (tap, c), n) = w[tap][n][group * Cg + c]
// with no transposed copy; out (n, ax[0].out_size, ax[1].out_size, cout).
struct ConvSpec {
  int n, cin, cout, groups, kh, kw, row_tile;
  int b_trans;  // 0: w (kh, kw, Cg, Cout); 1: w (kh, kw, Og, Cin), read transposed (dgrad)
  ConvAxis ax[2];
};

namespace {

// The FMA and mma.sync bodies' tiles (F_BM, F_BK; T_BM, T_BN, T_BK) are conv_fwd_plain.cuh's.
// bf16 wgmma body: two consumer warpgroups of 64 rows, one producer warpgroup
constexpr int W_BM = 128;
constexpr int W_BK = 64;  // one 128-byte swizzle row of A: 64 channels of one tap
constexpr int W_THREADS = 384;
// split-K: most K slices
constexpr int MAX_SPLITS = 16;
constexpr int MAX_PHASES = MAX_AXIS_PHASES * MAX_AXIS_PHASES;

enum Body { BODY_FMA = 0, BODY_MMA = 1, BODY_WGMMA = 2 };

// What a block reads: the spec, the split, and the M tiles of each 2-D phase for the body's BM.
struct ConvGeom {
  ConvSpec s;
  int splits, k_per_split;
  int phases;        // ax[0].phases * ax[1].phases
  int identity_out;  // one phase whose outputs are the output tensor's positions in order
  long long tile0[MAX_PHASES + 1];
  // The split workspace holds only the positions of phases with taps: phase p's rows start at
  // wpos0[p] of work_positions (a tapless phase's blocks write their zeros to the output).
  long long wpos0[MAX_PHASES + 1];
  long long work_positions;
  long long m_tiles;  // M tiles of every phase (tile0[phases])
  int n_tiles;        // BN tiles over Og
};

// The block's 2-D phase and its M range [m0, m_end) within the phase.
struct Phase {
  int th0, tw0, nth, ntw;  // the phase's taps along each axis
  int nh, nw;              // its outputs per image along each axis
  int oh0, ow0;            // its first output row and column
  long long wpos0;         // its first row of the split workspace
  long long m0, m_end;
};

// 2-D phase p (row phase p / ax[1].phases, column phase p % ax[1].phases), without an M range
__device__ __forceinline__ Phase phase_at(const ConvGeom& g, int p) {
  const ConvAxis& ah = g.s.ax[0];
  const ConvAxis& aw = g.s.ax[1];
  const int ph = p / aw.phases, pw = p - ph * aw.phases;
  Phase q;
  q.th0 = ah.tap0[ph];
  q.nth = ah.tap0[ph + 1] - q.th0;
  q.tw0 = aw.tap0[pw];
  q.ntw = aw.tap0[pw + 1] - q.tw0;
  q.nh = ah.n_out[ph];
  q.nw = aw.n_out[pw];
  q.oh0 = ah.out0[ph];
  q.ow0 = aw.out0[pw];
  q.wpos0 = g.wpos0[p];
  q.m0 = q.m_end = 0;
  return q;
}

// The 2-D phase of M tile `bx` (of every phase's tiles in order) and its M range.
__device__ __forceinline__ Phase tile_phase(const ConvGeom& g, int bm, long long bx) {
  int p = 0;
  while (p + 1 < g.phases && g.tile0[p + 1] <= bx) ++p;
  Phase q = phase_at(g, p);
  const long long M = (long long)g.s.n * q.nh * q.nw;
  const long long seg = g.s.row_tile > 0 ? (long long)g.s.row_tile * q.nw : M;
  const long long tiles_per_seg = (seg + bm - 1) / bm;
  const long long t = bx - g.tile0[p];
  const long long seg_start = (t / tiles_per_seg) * seg;
  q.m0 = seg_start + (t % tiles_per_seg) * bm;
  q.m_end = seg_start + seg < M ? seg_start + seg : M;
  return q;
}

struct OutputRow {  // one output position m of a phase
  long long img;
  int ih0, iw0;   // input position of offset 0
  long long pos;  // its position in the output tensor (n, out_size, out_size)
};

// (32-bit division: the host refuses a launch of 2^31 output positions or more)
__device__ __forceinline__ OutputRow output_row(const ConvGeom& g, const Phase& q, long long m) {
  const int per = q.nh * q.nw;
  const int img = (int)m / per;
  const int rem = (int)m - img * per;
  OutputRow r;
  r.img = img;
  const int oy = rem / q.nw;
  const int ox = rem - oy * q.nw;
  r.ih0 = oy * g.s.ax[0].in_step;
  r.iw0 = ox * g.s.ax[1].in_step;
  r.pos = g.identity_out ? m
                         : (r.img * g.s.ax[0].out_size + q.oh0 + oy * g.s.ax[0].out_step) *
                                   g.s.ax[1].out_size +
                               q.ow0 + ox * g.s.ax[1].out_step;
  return r;
}

// the output position of m alone (the epilogues)
__device__ __forceinline__ long long output_pos(const ConvGeom& g, const Phase& q, long long m) {
  return g.identity_out ? m : output_row(g, q, m).pos;
}

// Tap `tap` of the phase (tap-major over (row tap, column tap)): its input offsets along each
// axis, and its weight tap index ki * kw + kj.
__device__ __forceinline__ int phase_tap(const ConvGeom& g, const Phase& q, int tap, int* dh,
                                         int* dw) {
  const int ti = tap / q.ntw;
  const int tj = tap - ti * q.ntw;
  *dh = g.s.ax[0].off[q.th0 + ti];
  *dw = g.s.ax[1].off[q.tw0 + tj];
  return g.s.ax[0].wk[q.th0 + ti] * g.s.kw + g.s.ax[1].wk[q.tw0 + tj];
}

// the weight row (of the kh*kw*Cg rows) of K index k of the phase
__device__ __forceinline__ long long weight_row(const ConvGeom& g, const Phase& q, int k,
                                                int cg) {
  const int tap = k / cg;
  int dh, dw;
  return (long long)phase_tap(g, q, tap, &dh, &dw) * cg + (k - tap * cg);
}

// A thread's position (tap, channel c) in a phase's K walk, with the tap's input offsets and
// weight tap; advance() steps k on, looking the offsets up only when k enters a new tap.
struct TapWalk {
  int tap, c, dh, dw, wtap;
  __device__ __forceinline__ TapWalk(const ConvGeom& g, const Phase& q, int k0, int cg) {
    tap = k0 / cg;
    c = k0 - tap * cg;
    load(g, q);
  }
  __device__ __forceinline__ void load(const ConvGeom& g, const Phase& q) {
    dh = dw = wtap = 0;
    if (tap < q.nth * q.ntw) wtap = phase_tap(g, q, tap, &dh, &dw);
  }
  // k_next: the k the walk is at after the step
  __device__ __forceinline__ void advance(const ConvGeom& g, const Phase& q, int cg, int step,
                                          int k_next, int kend) {
    c += step;
    if (c < cg) return;
    while (c >= cg) {
      c -= cg;
      ++tap;
    }
    if (k_next < kend) load(g, q);
  }
};

__device__ __forceinline__ bool inside(const ConvGeom& g, int ih, int iw) {
  return ih >= 0 && ih < g.s.ax[0].in_size && iw >= 0 && iw < g.s.ax[1].in_size;
}

// ------------------------------------------------------------------ fp32, FMA on the CUDA cores

// Block tile F_BM x BN (BN = 128, or 64 when Og <= 64 so that res2's 64-channel layers waste no
// columns), BK = 8, two blocks an SM at BN 128 and three at 64 (registers capped to fit),
// double-buffered in shared memory: the next stage's global loads are in flight
// while this stage's products run. Thread (ty, tx) = (tid / 16, tid % 16) owns the 8 rows
// {ty*4 + i, 64 + ty*4 + i} and the TN = BN/16 columns {tx*HN + j, BN/2 + tx*HN + j}, so each
// k step reads its operands with two vector loads per side and does 8 * TN FMAs.
// vec_a: Cg % 4 == 0, Cin % 4 == 0 and x 16-byte aligned (4 channels of one tap = one float4);
// vec_b: Og % 4 == 0, Cout % 4 == 0 and w 16-byte aligned.
template <int BN>
__global__ void __launch_bounds__(THREADS, BN == 128 ? 2 : 3)
conv2d_fwd_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
               float* __restrict__ ws, const ConvGeom g, int vec_a, int vec_b) {
  constexpr int TN = BN / 16;
  constexpr int HN = TN / 2;
  constexpr int B_CHUNKS = F_BK * BN / 4;  // float4 chunks of a B stage
  __shared__ __align__(16) float As[2][F_BK][F_BM];
  __shared__ __align__(16) float Bs[2][F_BK][BN];

  const int tid = threadIdx.x;
  const int group = blockIdx.z / g.splits;
  const int split = blockIdx.z - group * g.splits;
  const int cin = g.s.cin, cout = g.s.cout;
  const int cg = cin / g.s.groups;
  const int og = cout / g.s.groups;
  const Phase q = tile_phase(g, F_BM, blockIdx.x);
  const int K = q.nth * q.ntw * cg;
  if (K == 0 && split > 0) return;  // a tapless phase: split 0 writes its zeros
  const int kbeg = split * g.k_per_split;
  const int kend = min(K, kbeg + g.k_per_split);
  const long long m0 = q.m0, m_end = q.m_end;
  const int n0 = blockIdx.y * BN;
  const int H = g.s.ax[0].in_size, W = g.s.ax[1].in_size;

  // A gather: each thread owns one output position (row a_m) and 4 consecutive k.
  const int a_m = tid & (F_BM - 1);
  const int a_k = (tid >> 7) * 4;
  const bool a_valid = m0 + a_m < m_end;
  OutputRow r = {0, 0, 0, 0};
  if (a_valid) r = output_row(g, q, m0 + a_m);
  const float* x_img = x + r.img * H * W * cin + (long long)group * cg;

  // B load: thread tid < B_CHUNKS owns one k row (b_k) and 4 consecutive output channels; with
  // b_trans, one output channel (bt_n) and 4 consecutive k (bt_k), contiguous in w.
  const int b_k = tid / (BN / 4);
  const int b_n = (tid % (BN / 4)) * 4;
  const int bt_n = tid >> 1;
  const int bt_k = (tid & 1) * 4;
  const bool trans = g.s.b_trans != 0;

  // Each thread's k advances by F_BK a stage: its (tap, channel) pairs are walked, not divided
  // out, and a tap's offsets are looked up only when the walk enters it.
  TapWalk wa(g, q, kbeg + a_k, cg), wb(g, q, kbeg + (trans ? bt_k : b_k), cg);
  float ra[4], rb[4];
  auto load = [&](int k0) {
    const int k = k0 + a_k;
    if (vec_a) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a_valid && k < kend) {
        const int ih = r.ih0 + wa.dh;
        const int iw = r.iw0 + wa.dw;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W)
          v = *reinterpret_cast<const float4*>(x_img + ((long long)ih * W + iw) * cin + wa.c);
      }
      ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k + j;
        float v = 0.f;
        if (a_valid && kk < kend) {
          const int tap = kk / cg;
          int dh, dw;
          phase_tap(g, q, tap, &dh, &dw);
          const int ih = r.ih0 + dh;
          const int iw = r.iw0 + dw;
          if (inside(g, ih, iw)) v = x_img[((long long)ih * W + iw) * cin + (kk - tap * cg)];
        }
        ra[j] = v;
      }
    }
    if (tid < B_CHUNKS && !trans) {
      const int kb = k0 + b_k;
      const float* wrow =
          w + ((long long)wb.wtap * cg + wb.c) * cout +
          (long long)group * og;
      if (vec_b) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kb < kend && n0 + b_n < og) v = *reinterpret_cast<const float4*>(wrow + n0 + b_n);
        rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nn = n0 + b_n + j;
          rb[j] = (kb < kend && nn < og) ? wrow[nn] : 0.f;
        }
      }
    } else if (tid < B_CHUNKS) {
      // w[tap][n][group * Cg + c]: row wtap * Og + n of w
      const int kb = k0 + bt_k;
      const int nn = n0 + bt_n;
      const long long row = (long long)wb.wtap * og + nn;
      const float* wp = w + row * cin + (long long)group * cg;
      if (vec_b) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kb < kend && nn < og) v = *reinterpret_cast<const float4*>(wp + wb.c);
        rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = 0.f;
          if (kb + j < kend && nn < og) {
            const int tap = (kb + j) / cg;
            int dh, dw;
            const long long r2 = (long long)phase_tap(g, q, tap, &dh, &dw) * og + nn;
            v = w[r2 * cin + (long long)group * cg + (kb + j - tap * cg)];
          }
          rb[j] = v;
        }
      }
    }
    wa.advance(g, q, cg, F_BK, k + F_BK, kend);
    wb.advance(g, q, cg, F_BK, k0 + (trans ? bt_k : b_k) + F_BK, kend);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) As[buf][a_k + j][a_m] = ra[j];
    if (tid < B_CHUNKS && !trans)
      *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
    else if (tid < B_CHUNKS)
#pragma unroll
      for (int j = 0; j < 4; ++j) Bs[buf][bt_k + j][bt_n] = rb[j];
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

  const bool to_ws = g.splits > 1 && K > 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= m_end) continue;
    float* orow = (to_ws ? ws + (split * g.work_positions + q.wpos0 + m) * cout
                         : out + output_pos(g, q, m) * cout) +
                  (long long)group * og;
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
__global__ void __launch_bounds__(THREADS, 3)
conv2d_fwd_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                __nv_bfloat16* __restrict__ out, float* __restrict__ ws, const ConvGeom g,
                int vec_a, int vec_b) {
  // rows padded to 40 halves (80 bytes): the fragment reads below hit 32 distinct banks
  __shared__ __align__(16) uint16_t As[T_BM][T_BK + 8];
  __shared__ __align__(16) uint16_t Bs[T_BN][T_BK + 8];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = blockIdx.z / g.splits;
  const int split = blockIdx.z - group * g.splits;
  const int cin = g.s.cin, cout = g.s.cout;
  const int cg = cin / g.s.groups;
  const int og = cout / g.s.groups;
  const Phase q = tile_phase(g, T_BM, blockIdx.x);
  const int K = q.nth * q.ntw * cg;
  if (K == 0 && split > 0) return;  // a tapless phase: split 0 writes its zeros
  const int kbeg = split * g.k_per_split;
  const int kend = min(K, kbeg + g.k_per_split);
  const long long m0 = q.m0, m_end = q.m_end;
  const int n0 = blockIdx.y * T_BN;
  const int W = g.s.ax[1].in_size;

  // A gather: each thread owns one output position (row a_m) and 16 consecutive k.
  const int a_m = tid >> 1;
  const int a_k = (tid & 1) * 16;
  const bool a_valid = m0 + a_m < m_end;
  OutputRow r = {0, 0, 0, 0};
  if (a_valid) r = output_row(g, q, m0 + a_m);
  const uint16_t* x_img = reinterpret_cast<const uint16_t*>(x) +
                          r.img * g.s.ax[0].in_size * W * cin + (long long)group * cg;

  // B load: each thread owns one k row (b_k) and 8 consecutive output channels; with b_trans,
  // one output channel (bt_n) and 8 consecutive k (bt_k), contiguous in w.
  const int b_k = tid >> 3;
  const int b_n = (tid & 7) * 8;
  const int bt_n = tid >> 2;
  const int bt_k = (tid & 3) * 8;
  const bool trans = g.s.b_trans != 0;
  const uint16_t* w16 = reinterpret_cast<const uint16_t*>(w);
  const uint16_t* w_grp = w16 + (long long)group * og;

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
        int dh, dw;
        phase_tap(g, q, tap, &dh, &dw);
        const int ih = r.ih0 + dh;
        const int iw = r.iw0 + dw;
        if (inside(g, ih, iw)) {
          const uint4* p = reinterpret_cast<const uint4*>(x_img + ((long long)ih * W + iw) * cin +
                                                          (ka - tap * cg));
          v0 = p[0];
          v1 = p[1];
        }
      }
      *reinterpret_cast<uint4*>(&As[a_m][a_k]) = v0;
      *reinterpret_cast<uint4*>(&As[a_m][a_k + 8]) = v1;
    } else {
      // walk (row tap ti, column tap tj, channel c) from ka
      const int ntw = q.ntw;
      int tap = ka / cg;
      int c = ka - tap * cg;
      int ti = ntw > 0 ? tap / ntw : 0;
      int tj = tap - ti * ntw;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint16_t v = 0;
        if (a_valid && ka + j < kend) {
          const int ih = r.ih0 + g.s.ax[0].off[q.th0 + ti];
          const int iw = r.iw0 + g.s.ax[1].off[q.tw0 + tj];
          if (inside(g, ih, iw)) v = x_img[((long long)ih * W + iw) * cin + c];
        }
        As[a_m][a_k + j] = v;
        if (++c == cg) {
          c = 0;
          if (++tj == ntw) {
            tj = 0;
            ++ti;
          }
        }
      }
    }
    if (trans) {
      // w[tap][n][group * Cg + c], 8 k a thread
      const int kb = k0 + bt_k;
      const int nn = n0 + bt_n;
      if (vec_b) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (kb < kend && nn < og) {
          const int tap = kb / cg;
          int dh, dw;
          const long long row = (long long)phase_tap(g, q, tap, &dh, &dw) * og + nn;
          v = *reinterpret_cast<const uint4*>(w16 + row * cin + (long long)group * cg +
                                              (kb - tap * cg));
        }
        *reinterpret_cast<uint4*>(&Bs[bt_n][bt_k]) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint16_t v = 0;
          if (kb + j < kend && nn < og) {
            const int tap = (kb + j) / cg;
            int dh, dw;
            const long long row = (long long)phase_tap(g, q, tap, &dh, &dw) * og + nn;
            v = w16[row * cin + (long long)group * cg + (kb + j - tap * cg)];
          }
          Bs[bt_n][bt_k + j] = v;
        }
      }
    } else {
      const int kb = k0 + b_k;
      const uint16_t* wrow = kb < kend ? w_grp + weight_row(g, q, kb, cg) * cout : w_grp;
      if (vec_b) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (kb < kend && n0 + b_n < og) v = *reinterpret_cast<const uint4*>(wrow + n0 + b_n);
        const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j) Bs[b_n + j][b_k] = e[j];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int nn = n0 + b_n + j;
          Bs[b_n + j][b_k] = (kb < kend && nn < og) ? wrow[nn] : 0;
        }
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
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm + i * 16 + gq + half * 8;
      if (m >= m_end) continue;
      const bool to_ws = g.splits > 1 && K > 0;
      const long long row =
          (to_ws ? split * g.work_positions + q.wpos0 + m : output_pos(g, q, m)) * cout +
          (long long)group * og;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = n0 + wn + j * 8 + 2 * tq;
        const float v0 = acc[i][j][half * 2];
        const float v1 = acc[i][j][half * 2 + 1];
        if (to_ws) {
          float* dst = ws + row;
          if (nn < og) dst[nn] = v0;
          if (nn + 1 < og) dst[nn + 1] = v1;
        } else {
          if (nn < og) out[row + nn] = __float2bfloat16_rn(v0);
          if (nn + 1 < og) out[row + nn + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// ------------------------------------------------------- bf16, wgmma + TMA + an mbarrier ring

template <int BN>
struct WTile {
  // BN 64: three stages and two blocks an SM (85 registers a thread); BN 128: four stages and
  // one block (168 registers)
  static constexpr int STAGES = BN == 64 ? 3 : 4;
  static constexpr int MIN_BLOCKS = BN == 64 ? 2 : 1;
  static constexpr int A_BYTES = W_BM * W_BK * 2;  // 128 rows x 128 bytes
  static constexpr int B_ATOM = W_BK * 128;        // 64 K rows x 64 columns (128 bytes)
  static constexpr int B_BYTES = (BN / 64) * B_ATOM;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int OUT_ROW = BN * 2 + 16;        // a staged bf16 output row, padded
  static constexpr int OUT_BYTES = 8 * 16 * OUT_ROW;  // 16 rows for each consumer warp
  static constexpr int BARS = RING + OUT_BYTES;
  static constexpr int BYTES = BARS + 16 * STAGES + 1024;  // + 1024-byte alignment
  static constexpr int ACC = BN / 2;  // fp32 accumulators a consumer thread holds
};

// Cg and Og are multiples of 64 (pick_body), so a K chunk of 64 is 64 channels of one tap and a
// BN tile never crosses a group. x and the weights are 16-byte aligned (the wrapper's copy).
// BT (the spec's b_trans): the weights are read as stored, B's rows the output channels, so
// the B tile is K-major: one TMA box of W_BK columns x BN rows, read by wgmma as it reads A.
// Persistent: the grid is what fits on the card, and each block walks the work items
// (M tile fastest, then BN tile, then group and split) blockIdx.x, + gridDim.x, ...; the ring
// runs on across items, so the producer loads the next item's chunks while the consumers finish
// this one's products and epilogue.
template <int BN, bool BT>
__global__ void __launch_bounds__(W_THREADS, WTile<BN>::MIN_BLOCKS)
conv2d_fwd_wgmma(const __grid_constant__ CUtensorMap tm_w, const __nv_bfloat16* __restrict__ x,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                 const __grid_constant__ ConvGeom g) {
  using T = WTile<BN>;
  constexpr int S = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle repeats at 1 KB
  const uint32_t bar_full = base + T::BARS;                       // 8 bytes each
  const uint32_t bar_empty = bar_full + 8 * S;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // 0: producer; 1, 2: consumers
  const int cin = g.s.cin, cout = g.s.cout;
  const int cg = cin / g.s.groups;
  const int og = cout / g.s.groups;
  const long long items = g.m_tiles * g.n_tiles * g.s.groups * g.splits;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < S; ++st) {
      mbar_init(bar_full + 8 * st, 128 + 1);  // the producers' cp.async arrivals + expect_tx
      mbar_init(bar_empty + 8 * st, 8);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int ring_pos = 0;  // K chunks through the ring so far, this block's items together
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long m_tile = item % g.m_tiles;
    const long long rest = item / g.m_tiles;
    const int n0 = (int)(rest % g.n_tiles) * BN;
    const int gs = (int)(rest / g.n_tiles);
    const int group = gs / g.splits;
    const int split = gs - group * g.splits;
    const Phase q = tile_phase(g, W_BM, m_tile);
    const int K = q.nth * q.ntw * cg;
    if (K == 0 && split > 0) continue;  // a tapless phase: split 0 writes its zeros
    const int kbeg = split * g.k_per_split;
    const int kend = min(K, kbeg + g.k_per_split);
    const int chunks = kend > kbeg ? (kend - kbeg) / W_BK : 0;

    if (wg == 0) {
      // ---- producer warpgroup: thread t fills the 16-byte chunk t % 8 of rows t / 8 + 16 j
      const int chunk = tid & 7;
      const int row0 = tid >> 3;
      const int swz = (chunk ^ (row0 & 7)) << 4;  // rows row0 + 16 j share row0's swizzle
      const int H = g.s.ax[0].in_size, W = g.s.ax[1].in_size;
      long long xoff[8];
      int ih0[8], iw0[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long m = q.m0 + row0 + 16 * j;
        xoff[j] = 0;
        ih0[j] = INT_MIN / 2;  // a row past M reads nothing: always above or below the input
        iw0[j] = 0;
        if (m < q.m_end) {
          const OutputRow r = output_row(g, q, m);
          xoff[j] = r.img * H * W * cin + (long long)group * cg + chunk * 8;
          ih0[j] = r.ih0;
          iw0[j] = r.iw0;
        }
      }
      for (int c = 0; c < chunks; ++c, ++ring_pos) {
        const int st = ring_pos % S;
        const uint32_t s_a = base + st * T::STAGE;
        const uint32_t s_b = s_a + T::A_BYTES;
        mbar_wait(bar_empty + 8 * st, ((ring_pos / S) & 1) ^ 1);  // the first lap passes
        const int k0 = kbeg + c * W_BK;
        const int tap = k0 / cg;
        const int c0 = k0 - tap * cg;
        int dh, dw;
        const int wtap = phase_tap(g, q, tap, &dh, &dw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ih = ih0[j] + dh, iw = iw0[j] + dw;
          const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W;
          const __nv_bfloat16* src = ok ? x + xoff[j] + ((long long)ih * W + iw) * cin + c0 : x;
          cp_async16(s_a + (row0 + 16 * j) * 128 + swz, src, ok);
        }
        mbar_arrive_cp_async(bar_full + 8 * st);
        if (tid == 0) {
          mbar_expect_tx(bar_full + 8 * st, T::B_BYTES);
          if constexpr (BT) {
            tma_load_2d(s_b, &tm_w, bar_full + 8 * st, group * cg + c0, wtap * og + n0);
          } else {
#pragma unroll
            for (int a = 0; a < BN / 64; ++a)
              tma_load_2d(s_b + a * T::B_ATOM, &tm_w, bar_full + 8 * st,
                          group * og + n0 + 64 * a, wtap * cg + c0);
          }
        }
      }
    } else {
      // ---- consumer warpgroup cw: rows 64 cw .. 64 cw + 63 of the tile
      const int cw = wg - 1;
      const int lane = tid & 31, warp = (tid >> 5) & 3;
      float acc[T::ACC];
#pragma unroll
      for (int i = 0; i < T::ACC; ++i) acc[i] = 0.f;
      for (int c = 0; c < chunks; ++c, ++ring_pos) {
        const int st = ring_pos % S;
        const uint32_t s_a = base + st * T::STAGE + cw * 64 * 128;
        const uint32_t s_b = base + st * T::STAGE + T::A_BYTES;
        mbar_wait(bar_full + 8 * st, (ring_pos / S) & 1);
        // the A rows came through the generic proxy (cp.async); wgmma reads through the async one
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W_BK / 16; ++kk) {
          const uint64_t da = desc_k_major(s_a + kk * 32);
          const uint64_t db = BT ? desc_k_major(s_b + kk * 32)
                                 : desc_mn_major(s_b + kk * 16 * 128, T::B_ATOM);
          if constexpr (BN == 64)
            wgmma_n64<0, BT ? 0 : 1>(acc, da, db);
          else
            wgmma_n128<0, BT ? 0 : 1>(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous chunk's products are done: release its stage
        fence_regs(acc);
        if (c > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_empty + 8 * ((ring_pos - 1) % S));
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (chunks > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * ((ring_pos - 1) % S));
      }

      // Epilogue. Accumulator element 4n + 2h + e is row 16 warp + lane / 4 + 8 h, column
      // 8 n + 2 (lane % 4) + e of the warpgroup's 64 x BN.
      const int tq = lane & 3;
      const long long m_warp = q.m0 + 64 * cw + 16 * warp;
      if (g.splits > 1 && K > 0) {
        // an fp32 slice of the split workspace, straight from the registers
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long m = m_warp + (lane >> 2) + 8 * h;
          if (m >= q.m_end) continue;
          float* dst = ws + (split * g.work_positions + q.wpos0 + m) * cout +
                       (long long)group * og + n0 + 2 * tq;
#pragma unroll
          for (int n = 0; n < BN / 8; ++n)
            *reinterpret_cast<float2*>(dst + 8 * n) =
                make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
        }
      } else {
        // bf16 output: the warp stages its 16 rows in its own part of shared memory, then
        // writes whole rows (BN contiguous channels of one output position), 16 bytes a lane
        uint8_t* stage =
            smem_raw + (base - smem_u32(smem_raw)) + T::RING + (4 * cw + warp) * 16 * T::OUT_ROW;
        __syncwarp();  // the warp's reads of its previous item's rows are done
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint8_t* srow = stage + ((lane >> 2) + 8 * h) * T::OUT_ROW;
#pragma unroll
          for (int n = 0; n < BN / 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(srow + (8 * n + 2 * tq) * 2) =
                __floats2bfloat162_rn(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
        }
        __syncwarp();
        constexpr int PER_ROW = BN * 2 / 16;  // 16-byte pieces of a row
        const int piece = lane % PER_ROW;
        for (int r = lane / PER_ROW; r < 16; r += 32 / PER_ROW) {
          const long long m = m_warp + r;
          if (m >= q.m_end) continue;
          const long long col = output_pos(g, q, m) * cout + (long long)group * og + n0;
          *reinterpret_cast<uint4*>(out + col + piece * 8) =
              *reinterpret_cast<const uint4*>(stage + r * T::OUT_ROW + piece * 16);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ split reduction

// out[position][c] = sum over s of ws[s][row][c], in split order, for every workspace row (the
// positions of phases with taps; a tapless phase's blocks wrote the output themselves)
template <typename T>
__global__ void __launch_bounds__(THREADS)
reduce_conv_splits(const float* __restrict__ ws, T* __restrict__ out, const ConvGeom g) {
  const int cout = g.s.cout;
  const long long total = g.work_positions * cout;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < g.splits; ++k) s += ws[(long long)k * total + i];
    if (g.identity_out) {  // the rows are the output's positions
      out[i] = from_f32<T>(s);
      continue;
    }
    // < 2^31 output positions (dl4j_conv2d checks); 32-bit division where i fits
    const int row = total <= INT_MAX ? (int)i / cout : (int)(i / cout);
    int p = 0;
    while (p + 1 < g.phases && g.wpos0[p + 1] <= row) ++p;
    const long long pos = output_row(g, phase_at(g, p), row - g.wpos0[p]).pos;
    out[pos * cout + (i - (long long)row * cout)] = from_f32<T>(s);
  }
}

template <typename T>
void launch_reduce_conv_splits(const float* ws, T* out, const ConvGeom& g, cudaStream_t s) {
  const long long need = (g.work_positions * g.s.cout + THREADS - 1) / THREADS;
  reduce_conv_splits<T><<<(unsigned)(need < 4096 ? need : 4096), THREADS, 0, s>>>(ws, out, g);
}

// ------------------------------------------------------------------ body, plan and launch

// The body a launch of this type and geometry runs: the one place that decides it.
Body pick_body(int dtype, const ConvSpec& s) {
  if (dtype == 0) return BODY_FMA;
  const int cg = s.cin / s.groups, og = s.cout / s.groups;
  return cg % 64 == 0 && og % 64 == 0 ? BODY_WGMMA : BODY_MMA;
}

// The block tile of a body: BM x BN outputs, BK deep stages.
struct Tile {
  int bm, bn, bk;
};
Tile body_tile(Body body, int og) {
  switch (body) {
    case BODY_FMA: return {F_BM, og > 64 ? 128 : 64, F_BK};
    case BODY_MMA: return {T_BM, T_BN, T_BK};
    default: return {W_BM, og % 128 == 0 ? 128 : 64, W_BK};
  }
}

bool valid_axis(const ConvAxis& a, int k) {
  if (a.phases < 1 || a.phases > MAX_AXIS_PHASES || a.in_size < 1 || a.out_size < 1 ||
      a.in_step < 1 || a.out_step < 1 || a.tap0[0] != 0)
    return false;
  for (int r = 0; r < a.phases; ++r)
    if (a.n_out[r] < 0 || a.tap0[r + 1] < a.tap0[r] || a.tap0[r + 1] > MAX_AXIS_TAPS ||
        (a.n_out[r] > 0 && (a.out0[r] < 0 ||
                            a.out0[r] + (long long)(a.n_out[r] - 1) * a.out_step >= a.out_size)))
      return false;
  for (int t = 0; t < a.tap0[a.phases]; ++t)
    if (a.wk[t] < 0 || a.wk[t] >= k) return false;
  return true;
}

bool valid_spec(const ConvSpec& s) {
  return s.n >= 1 && s.groups >= 1 && (s.b_trans == 0 || s.b_trans == 1) &&
         s.cin >= s.groups && s.cout >= s.groups && s.cin % s.groups == 0 &&
         s.cout % s.groups == 0 && s.kh >= 1 && s.kw >= 1 && s.row_tile >= 0 &&
         valid_axis(s.ax[0], s.kh) && valid_axis(s.ax[1], s.kw);
}

// The geometry blocks read: the M tiles of each 2-D phase for this tile (*tiles in all, *work of
// them in phases with taps: a tapless phase's tiles only write zeros), and the largest K of a
// phase in BK stages (*stages), which the split plan divides.
void make_geom(ConvGeom* g, const ConvSpec& s, const Tile& t, long long* tiles, long long* work,
               long long* stages) {
  g->s = s;
  g->splits = 1;
  g->k_per_split = 0;
  const ConvAxis& ah = s.ax[0];
  const ConvAxis& aw = s.ax[1];
  g->phases = ah.phases * aw.phases;
  g->identity_out = g->phases == 1 && ah.out_step == 1 && aw.out_step == 1 && ah.out0[0] == 0 &&
                    aw.out0[0] == 0 && ah.n_out[0] == ah.out_size && aw.n_out[0] == aw.out_size;
  const int cg = s.cin / s.groups;
  long long total = 0, with_taps = 0, k_max = 0, rows = 0;
  for (int p = 0; p < g->phases; ++p) {
    const int ph = p / aw.phases, pw = p - ph * aw.phases;
    const long long M = (long long)s.n * ah.n_out[ph] * aw.n_out[pw];
    const long long seg = s.row_tile > 0 ? (long long)s.row_tile * aw.n_out[pw] : M;
    g->tile0[p] = total;
    const long long n = M > 0 && seg > 0 ? ((M + seg - 1) / seg) * ((seg + t.bm - 1) / t.bm) : 0;
    const long long K = (long long)(ah.tap0[ph + 1] - ah.tap0[ph]) *
                        (aw.tap0[pw + 1] - aw.tap0[pw]) * cg;
    total += n;
    g->wpos0[p] = rows;
    if (K > 0) {
      with_taps += n;
      rows += M;
    }
    k_max = std::max(k_max, K);
  }
  g->tile0[g->phases] = total;
  g->m_tiles = total;
  g->n_tiles = (s.cout / s.groups + t.bn - 1) / t.bn;
  g->wpos0[g->phases] = rows;
  g->work_positions = rows;
  *tiles = total;
  *work = with_taps;
  *stages = (k_max + t.bk - 1) / t.bk;
}


template <int BN, bool BT>
cudaError_t wgmma_ready() {
  static std::atomic<bool> done[MAX_DEVICES];
  return allow_smem(conv2d_fwd_wgmma<BN, BT>, WTile<BN>::BYTES, done);
}

template <int BN, bool BT>
cudaError_t wgmma_slots(std::atomic<int>* cache, int* slots) {
  const cudaError_t e = wgmma_ready<BN, BT>();
  if (e != cudaSuccess) return e;
  return wave_slots(conv2d_fwd_wgmma<BN, BT>, cache, slots, W_THREADS, WTile<BN>::BYTES);
}

// The plan's plain form (conv_fwd_plain.cuh) where it is a forward's: one phase per axis over
// every output in order, all kh x kw taps in HWIO order, evenly spaced, weights as stored.
// Fills all but the tiles and the split; false for any other plan.
bool plain_geom(const ConvSpec& s, PlainGeom* p) {
  if (s.b_trans) return false;
  int pad[2], dil[2];
  for (int i = 0; i < 2; ++i) {
    const ConvAxis& a = s.ax[i];
    const int k = i == 0 ? s.kh : s.kw;
    if (a.phases != 1 || a.out_step != 1 || a.out0[0] != 0 || a.n_out[0] != a.out_size ||
        a.tap0[1] != k)
      return false;
    dil[i] = k > 1 ? a.off[1] - a.off[0] : 1;
    if (dil[i] < 1) return false;
    for (int t = 0; t < k; ++t)
      if (a.wk[t] != t || a.off[t] != a.off[0] + t * dil[i]) return false;
    pad[i] = -a.off[0];
  }
  p->n = s.n;
  p->h = s.ax[0].in_size;
  p->w = s.ax[1].in_size;
  p->cin = s.cin;
  p->kh = s.kh;
  p->kw = s.kw;
  p->cout = s.cout;
  p->groups = s.groups;
  p->oh = s.ax[0].out_size;
  p->ow = s.ax[1].out_size;
  p->sh = s.ax[0].in_step;
  p->sw = s.ax[1].in_step;
  p->dh = dil[0];
  p->dw = dil[1];
  p->pad_top = pad[0];
  p->pad_left = pad[1];
  return true;
}

// Blocks of one wave on the current device for the body (tile width, weight layout, plain or
// phased form) a launch uses.
cudaError_t body_slots(Body body, int bn, bool trans, bool plain, int* slots) {
  static std::atomic<int> cache[10][MAX_DEVICES];
  if (body == BODY_FMA) {
    if (bn == 128)
      return plain ? wave_slots(conv2d_fwd_f32_plain<128>, cache[0], slots)
                   : wave_slots(conv2d_fwd_f32<128>, cache[1], slots);
    return plain ? wave_slots(conv2d_fwd_f32_plain<64>, cache[2], slots)
                 : wave_slots(conv2d_fwd_f32<64>, cache[3], slots);
  }
  if (body == BODY_MMA)
    return plain ? wave_slots(conv2d_fwd_bf16_plain, cache[4], slots)
                 : wave_slots(conv2d_fwd_bf16, cache[5], slots);
  if (bn == 128)
    return trans ? wgmma_slots<128, true>(cache[6], slots)
                 : wgmma_slots<128, false>(cache[7], slots);
  return trans ? wgmma_slots<64, true>(cache[8], slots) : wgmma_slots<64, false>(cache[9], slots);
}


// w (kh, kw, Cg, Cout): boxes of 64 output channels x W_BK K rows; with BT, w (kh, kw, Og, Cin):
// boxes of W_BK K columns x BN output-channel rows.
template <int BN, bool BT>
cudaError_t launch_wgmma(const void* x, const void* w, void* out, float* ws, const ConvGeom& g,
                         dim3 grid, cudaStream_t s) {
  cudaError_t e = wgmma_ready<BN, BT>();
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  const long long taps = (long long)g.s.kh * g.s.kw;
  const bool ok = BT ? encode_2d(&map, w, taps * (g.s.cout / g.s.groups), g.s.cin, BN)
                     : encode_2d(&map, w, taps * (g.s.cin / g.s.groups), g.s.cout, W_BK);
  if (!ok) return cudaErrorInvalidValue;
  int slots = 0;  // persistent: as many blocks as fit, each walking the work items
  e = body_slots(BODY_WGMMA, BN, BT, false, &slots);
  if (e != cudaSuccess) return e;
  const unsigned blocks =
      (unsigned)std::min<long long>((long long)grid.x * grid.y * grid.z, slots);
  conv2d_fwd_wgmma<BN, BT><<<blocks, W_THREADS, WTile<BN>::BYTES, s>>>(
      map, static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), ws, g);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The plan of one launch (dtype 0 = float32, 1 = bfloat16) on the current device: the body it
// runs (*body: 0 fp32 FMA, 1 bf16 mma.sync, 2 bf16 wgmma) and its K slices (*splits): as many as
// fit its output tiles (BM x BN tiles of every phase with taps and group) into one wave of
// resident blocks of that body, never past it (a second, partial wave costs a whole wave),
// keeping at least MIN_STAGES_PER_SPLIT BK stages of the largest phase's K in each slice and
// at most MAX_SPLITS. splits > 1 means dl4j_conv2d needs a workspace of splits *
// N*out_h*out_w * Cout floats. Returns a cudaError_t (0 on success).
int dl4j_conv2d_plan(int dtype, const ConvSpec* spec, int* splits, int* body) {
  if ((dtype != 0 && dtype != 1) || spec == nullptr || splits == nullptr || body == nullptr ||
      !valid_spec(*spec))
    return (int)cudaErrorInvalidValue;
  const Body b = pick_body(dtype, *spec);
  const Tile t = body_tile(b, spec->cout / spec->groups);
  ConvGeom g;
  long long tiles, work, stages;
  make_geom(&g, *spec, t, &tiles, &work, &stages);
  int slots = 0;
  PlainGeom pg;
  const cudaError_t e = body_slots(b, t.bn, spec->b_trans != 0, plain_geom(*spec, &pg), &slots);
  if (e != cudaSuccess) return (int)e;
  const long long n_tiles = (spec->cout / spec->groups + t.bn - 1) / t.bn;
  *splits = work > 0 ? plan_splits(slots, work * n_tiles * spec->groups, stages, MAX_SPLITS) : 1;
  *body = (int)b;
  return 0;
}

// One convolution launch on `spec` (see ConvSpec): x NHWC, w HWIO, out NHWC, all contiguous, in
// `dtype` (0 = float32, 1 = bfloat16); the bf16 wgmma body needs x and w 16-byte aligned.
// `splits` comes from dl4j_conv2d_plan; splits > 1 needs `workspace`: splits * N*out_h*out_w *
// Cout floats. Returns the cudaError_t of the launches (0 on success).
int dl4j_conv2d(const void* x, const void* w, void* out, int dtype, const ConvSpec* spec,
                int splits, void* workspace, void* stream) {
  if ((dtype != 0 && dtype != 1) || spec == nullptr || !valid_spec(*spec) || splits < 1 ||
      splits > MAX_SPLITS || (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const Body body = pick_body(dtype, *spec);
  const int og = spec->cout / spec->groups;
  const int cg = spec->cin / spec->groups;
  const Tile t = body_tile(body, og);
  ConvGeom g;
  long long tiles, work, stages;
  make_geom(&g, *spec, t, &tiles, &work, &stages);
  const long long n_tiles = (og + t.bn - 1) / t.bn;
  if (tiles == 0) return 0;  // no output position
  if (tiles > INT_MAX || n_tiles > 65535 || (long long)spec->groups * splits > 65535 ||
      (long long)spec->n * spec->ax[0].out_size * spec->ax[1].out_size > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  g.splits = splits;
  g.k_per_split = (int)(((stages + splits - 1) / splits) * t.bk);
  const dim3 grid((unsigned)tiles, (unsigned)n_tiles, (unsigned)(spec->groups * splits));
  // the plain form of a forward's plan, for the FMA and mma.sync bodies (conv_fwd_plain.cuh)
  PlainGeom pg;
  const bool plain = body != BODY_WGMMA && plain_geom(*spec, &pg);
  if (plain) {
    const long long rt = spec->row_tile;
    pg.seg = rt > 0 ? rt * pg.ow : (long long)pg.n * pg.oh * pg.ow;
    pg.tiles_per_seg = (int)((pg.seg + t.bm - 1) / t.bm);
    pg.splits = splits;
    pg.k_per_split = g.k_per_split;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  (void)cudaGetLastError();  // report these launches' errors, not an older one
  const bool x16 = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool w16 = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int cin = spec->cin, cout = spec->cout;
  if (body == BODY_FMA) {
    const int vec_a = cg % 4 == 0 && cin % 4 == 0 && x16;
    const int vec_b = (spec->b_trans ? cg % 4 == 0 && cin % 4 == 0
                                     : og % 4 == 0 && cout % 4 == 0) && w16;
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* of = static_cast<float*>(out);
    if (t.bn == 128 && plain)
      conv2d_fwd_f32_plain<128><<<grid, THREADS, 0, s>>>(xf, wf, of, ws, pg, vec_a, vec_b);
    else if (t.bn == 128)
      conv2d_fwd_f32<128><<<grid, THREADS, 0, s>>>(xf, wf, of, ws, g, vec_a, vec_b);
    else if (plain)
      conv2d_fwd_f32_plain<64><<<grid, THREADS, 0, s>>>(xf, wf, of, ws, pg, vec_a, vec_b);
    else
      conv2d_fwd_f32<64><<<grid, THREADS, 0, s>>>(xf, wf, of, ws, g, vec_a, vec_b);
  } else if (body == BODY_MMA) {
    const int vec_a = cg % 16 == 0 && cin % 8 == 0 && x16;
    const int vec_b = (spec->b_trans ? cg % 8 == 0 && cin % 8 == 0
                                     : og % 8 == 0 && cout % 8 == 0) && w16;
    const auto xb = static_cast<const __nv_bfloat16*>(x);
    const auto wb = static_cast<const __nv_bfloat16*>(w);
    const auto ob = static_cast<__nv_bfloat16*>(out);
    if (plain)
      conv2d_fwd_bf16_plain<<<grid, THREADS, 0, s>>>(xb, wb, ob, ws, pg, vec_a, vec_b);
    else
      conv2d_fwd_bf16<<<grid, THREADS, 0, s>>>(xb, wb, ob, ws, g, vec_a, vec_b);
  } else {
    if (!x16 || !w16) return (int)cudaErrorMisalignedAddress;
    const bool bt = spec->b_trans != 0;
    const cudaError_t e =
        t.bn == 128 ? (bt ? launch_wgmma<128, true>(x, w, out, ws, g, grid, s)
                          : launch_wgmma<128, false>(x, w, out, ws, g, grid, s))
                    : (bt ? launch_wgmma<64, true>(x, w, out, ws, g, grid, s)
                          : launch_wgmma<64, false>(x, w, out, ws, g, grid, s));
    if (e != cudaSuccess) return (int)e;
  }
  if (splits > 1) {
    if (dtype == 0)
      launch_reduce_conv_splits(ws, static_cast<float*>(out), g, s);
    else
      launch_reduce_conv_splits(ws, static_cast<__nv_bfloat16*>(out), g, s);
  }
  return (int)cudaGetLastError();
}

// sizeof(ConvSpec), so the binding can check its mirror of the struct
int dl4j_conv2d_spec_bytes() { return (int)sizeof(ConvSpec); }

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
