// Fused LSTM cell for Hopper (sm_90a): one time step, z = xp + h @ U, the gate block and the
// state update in one kernel, h' and c' out.
//
// Replaces the TPU kernel of the JAX package:
//   deeplearning4j_tpu/ops/kernels/lstm.py::_cell_kernel (launched by _cell_pallas)
// The TPU kernel runs as one program over the whole batch (or over batch tiles), the (B, H) x
// (H, 4H) product on the matrix unit and the gates on the vector unit in the same program. Here
// one block owns a tile of BT batch rows x JT hidden units j and computes, for them, all four
// gate columns r*H + j (r = 0..3) of z: the gate block and the c/h update then run in the
// block's epilogue on values already in registers, fused with the product. No z ever reaches
// device memory, and there is no separate pointwise pass.
//
// What it computes, for xp (B, 4H) (row stride given, so a time slice of the layer's (B, T, 4H)
// input projection is read in place), h and c (B, H) and U (H, 4H), all of one type:
//   z[b, r*H + j] = xp[b, r*H + j] + sum_k h[b, k] * U[k, r*H + j]   (fp32 accumulation)
//   i = sigmoid(z_i), f = sigmoid(z_f), o = sigmoid(z_o), g = tanh(z_g), the column block of
//   each role given by the gate order (IFOG for nn/recurrent.py's layers, IOFG for the ONNX
//   lstm_layer op): col[0..3] = block of i, f, o, g;
//   c' = f * c + i * g,  h' = o * tanh(c'), both written in xp's type from the fp32 values.
// sigmoid is 1 / (1 + expf(-x)); expf and tanhf are the accurate library functions: this source
// is built without fast math (ops/kernels/_build.py passes no -use_fast_math).
//
// Layout of a block: 256 threads = BT * JT (row, unit) pairs x KSPLIT slices of k. Each k chunk
// of KC rows stages h[rows, chunk] and U[chunk, the tile's 4 x JT columns] in shared memory, in
// fp32 (bf16 operands are widened on the load: their products are exact in fp32, so this is
// "FMA on bf16 operands with fp32 accumulation"). A thread accumulates the four gate columns of
// its (row, unit) over its slice of each chunk; the KSPLIT partial sums meet in shared memory,
// and the first slice's threads add xp and run the gates and the state update.
//
// What bounds it on the card: at the char-RNN's training geometry (B 32, H 256, fp32) a launch
// does 2 * B * H * 4H = 16.8 MFLOP on 1.3 MB (U is 1 MB of it), so it is bound by bytes
// (0.39 us at 3.35 TB/s against 0.25 us of fp32 FMA at 67 TFLOP/s), and at that size by the
// launch itself (a few microseconds). BT = JT = 8 gives (H / 8) x (B / 8) = 128 blocks at B 32,
// H 256: one wave over the 132 SMs. Left on the table: the persistent time loop (U kept in
// shared memory across steps, one launch per segment), tensor cores (mma.sync / wgmma) for
// bf16, and vector loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BT = 8;                         // batch rows per block
constexpr int JT = 8;                         // hidden units per block (x 4 gate columns)
constexpr int KSPLIT = 4;                     // threads sharing one (row, unit) along k
constexpr int KC = 64;                        // k rows staged per chunk
constexpr int PAIRS = BT * JT;                // (row, unit) pairs per block
constexpr int THREADS = PAIRS * KSPLIT;       // 256
constexpr int COLS = 4 * JT;                  // z columns a block computes

struct CellGeom {
  int b, h;
  long long xp_stride;  // elements between consecutive rows of xp
  int col_i, col_f, col_o, col_g;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid_acc(float x) { return 1.0f / (1.0f + expf(-x)); }

// z[c] for a runtime block index c in 0..3, kept in registers
__device__ __forceinline__ float pick(const float (&z)[4], int c) {
  return c == 0 ? z[0] : c == 1 ? z[1] : c == 2 ? z[2] : z[3];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lstm_cell_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ h_prev,
                     const T* __restrict__ c_prev, const T* __restrict__ u,
                     T* __restrict__ h_out, T* __restrict__ c_out, CellGeom g) {
  __shared__ float hs[BT][KC + 1];           // +1: the BT rows fall in distinct banks
  __shared__ float us[KC][COLS];
  __shared__ float part[KSPLIT - 1][4][PAIRS];

  const int tid = threadIdx.x;
  const int pair = tid % PAIRS;
  const int ks = tid / PAIRS;                // a warp shares one slice: no divergence
  const int rb = pair / JT, jj = pair % JT;
  const int b0 = blockIdx.y * BT, j0 = blockIdx.x * JT;
  const int H = g.h;
  const long long four_h = 4LL * H;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < H; k0 += KC) {
    for (int e = tid; e < BT * KC; e += THREADS) {
      const int r = e / KC, k = e % KC;
      const int b = b0 + r, kk = k0 + k;
      hs[r][k] = (b < g.b && kk < H) ? to_f(h_prev[(long long)b * H + kk]) : 0.f;
    }
    for (int e = tid; e < KC * COLS; e += THREADS) {
      const int k = e / COLS, col = e % COLS;
      const int blk = col / JT, j = j0 + col % JT, kk = k0 + k;
      us[k][col] = (kk < H && j < H)
                       ? to_f(u[(long long)kk * four_h + (long long)blk * H + j]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < KC / KSPLIT; ++i) {
      const int k = i * KSPLIT + ks;
      const float hv = hs[rb][k];
#pragma unroll
      for (int blk = 0; blk < 4; ++blk) acc[blk] = fmaf(hv, us[k][blk * JT + jj], acc[blk]);
    }
    __syncthreads();
  }

  if (ks > 0) {
#pragma unroll
    for (int blk = 0; blk < 4; ++blk) part[ks - 1][blk][pair] = acc[blk];
  }
  __syncthreads();
  if (ks != 0) return;
#pragma unroll
  for (int s = 0; s < KSPLIT - 1; ++s) {
#pragma unroll
    for (int blk = 0; blk < 4; ++blk) acc[blk] += part[s][blk][pair];
  }
  const int b = b0 + rb, j = j0 + jj;
  if (b >= g.b || j >= H) return;
  const T* xr = xp + (long long)b * g.xp_stride;
  float z[4];
#pragma unroll
  for (int blk = 0; blk < 4; ++blk) z[blk] = to_f(xr[(long long)blk * H + j]) + acc[blk];
  const float ig = sigmoid_acc(pick(z, g.col_i));
  const float fg = sigmoid_acc(pick(z, g.col_f));
  const float og = sigmoid_acc(pick(z, g.col_o));
  const float gg = tanhf(pick(z, g.col_g));
  const long long at = (long long)b * H + j;
  const float c_new = fg * to_f(c_prev[at]) + ig * gg;
  c_out[at] = from_f<T>(c_new);
  h_out[at] = from_f<T>(og * tanhf(c_new));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (every tensor of one type). xp (B, 4H) rows xp_stride
// elements apart, each row contiguous; h, c, h_out, c_out (B, H) and U (H, 4H) contiguous.
// col_i, col_f, col_o, col_g: the z column block (0..3) of each gate, a permutation of 0..3.
// Launches on `stream` without synchronising; returns the cudaError_t of the launch (0 on
// success).
int dl4j_lstm_cell_fwd(const void* xp, const void* h, const void* c, const void* u,
                       void* h_out, void* c_out, int dtype, int b, int hidden,
                       long long xp_stride, int col_i, int col_f, int col_o, int col_g,
                       void* stream) {
  const int seen = (1 << col_i) | (1 << col_f) | (1 << col_o) | (1 << col_g);
  if ((dtype != 0 && dtype != 1) || b < 1 || hidden < 1 || xp_stride < 4LL * hidden ||
      col_i < 0 || col_i > 3 || col_f < 0 || col_f > 3 || col_o < 0 || col_o > 3 ||
      col_g < 0 || col_g > 3 || seen != 0xF || (b + BT - 1) / BT > 65535)
    return (int)cudaErrorInvalidValue;
  CellGeom g;
  g.b = b; g.h = hidden; g.xp_stride = xp_stride;
  g.col_i = col_i; g.col_f = col_f; g.col_o = col_o; g.col_g = col_g;
  const dim3 grid((unsigned)((hidden + JT - 1) / JT), (unsigned)((b + BT - 1) / BT));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (dtype == 0) {
    lstm_cell_fwd_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(xp), static_cast<const float*>(h),
        static_cast<const float*>(c), static_cast<const float*>(u), static_cast<float*>(h_out),
        static_cast<float*>(c_out), g);
  } else {
    lstm_cell_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(xp), static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(c), static_cast<const __nv_bfloat16*>(u),
        static_cast<__nv_bfloat16*>(h_out), static_cast<__nv_bfloat16*>(c_out), g);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
