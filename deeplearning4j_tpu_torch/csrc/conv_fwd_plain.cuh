// The conv kernel's plain forward: its FMA (fp32) and mma.sync (bf16) bodies for a launch whose
// phase plan is a forward's single phase (ConvSpec with no b_trans, taps in HWIO order, evenly
// spaced), written with the stride, dilation and pads as arithmetic instead of the plan's tables.
// conv2d_fwd.cu includes it and runs these bodies for such a launch (the fp32 forward and the
// bf16 forward of the convs the wgmma body does not take, such as ResNet-50's stem); dgrad and
// any other plan run the phased bodies there. The sums are the same, and the plain forms are
// faster on a forward's plan (H100, per 224x224 ResNet-50 pass at batch 8; PERF.md §6): the
// phased FMA body (a tap walk and a phase in registers) runs the fp32 forward in 2.79 against
// 2.684 ms; the phased mma.sync body keeps three blocks an SM (80 registers against 69) but runs
// the stem in 0.0719 against 0.0644 ms (tools/conv_compare.py, the two forms in turns).
//
// Each block owns a BM x BN output tile of one group; M = N*OH*OW positions, cut into row_tile
// segments (seg positions, tiles_per_seg tiles each) that no tile crosses; K = kh*kw*Cg. Split-K
// slices write fp32 to ws [splits][M][Cout], which conv2d_fwd.cu's reduce_conv_splits adds in
// split order.

#pragma once

#include "conv_common.cuh"

namespace {

// fp32 FMA body (BN is 128 or 64, see conv2d_fwd_f32)
constexpr int F_BM = 128;
constexpr int F_BK = 8;
// bf16 tensor-core body
constexpr int T_BM = 128;
constexpr int T_BN = 64;
constexpr int T_BK = 32;

struct PlainGeom {
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

struct PlainRow {  // decomposition of one output position m
  long long img;
  int ih0, iw0;
};

__device__ __forceinline__ PlainRow plain_output_row(const PlainGeom& g, long long m) {
  const long long ohw = (long long)g.oh * g.ow;
  PlainRow r;
  r.img = m / ohw;
  const int rem = (int)(m - r.img * ohw);
  const int oy = rem / g.ow;
  const int ox = rem - oy * g.ow;
  r.ih0 = oy * g.sh - g.pad_top;
  r.iw0 = ox * g.sw - g.pad_left;
  return r;
}

// The block's M range: [m0, m_end) within its row_tile segment.
__device__ __forceinline__ void plain_block_rows(const PlainGeom& g, int bm, long long* m0,
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
conv2d_fwd_f32_plain(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, float* __restrict__ ws, PlainGeom g, int vec_a,
                     int vec_b) {
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
  plain_block_rows(g, F_BM, &m0, &m_end);
  const int n0 = blockIdx.y * BN;

  // A gather: each thread owns one output position (row a_m) and 4 consecutive k.
  const int a_m = tid & (F_BM - 1);
  const int a_k = (tid >> 7) * 4;
  const bool a_valid = m0 + a_m < m_end;
  PlainRow r = {0, 0, 0};
  if (a_valid) r = plain_output_row(g, m0 + a_m);
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
conv2d_fwd_bf16_plain(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ ws, PlainGeom g,
                      int vec_a, int vec_b) {
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
  plain_block_rows(g, T_BM, &m0, &m_end);
  const int n0 = blockIdx.y * T_BN;

  // A gather: each thread owns one output position (row a_m) and 16 consecutive k.
  const int a_m = tid >> 1;
  const int a_k = (tid & 1) * 16;
  const bool a_valid = m0 + a_m < m_end;
  PlainRow r = {0, 0, 0};
  if (a_valid) r = plain_output_row(g, m0 + a_m);
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

}  // namespace
