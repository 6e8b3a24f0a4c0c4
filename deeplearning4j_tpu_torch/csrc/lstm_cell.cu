// Fused LSTM cell for Hopper (sm_90a): one time step, z = xp + h @ U, the gate block and the
// state update in one kernel, h' and c' out. It is also the step body of the sequence entry
// (lstm_seq.cu's dl4j_lstm_seq_fwd), which launches it once per time step where the resident body
// does not fit, with the states read and written at row strides and _scan's mask rule applied in
// the epilogue (lstm_common.cuh's blend).
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
// bf16, and vector loads: lstm_seq.cu's resident body has the first two.

#include "lstm_common.cuh"

namespace {

constexpr int BT = 8;                         // batch rows per block
constexpr int JT = 8;                         // hidden units per block (x 4 gate columns)
constexpr int KSPLIT = 4;                     // threads sharing one (row, unit) along k
constexpr int KC = 64;                        // k rows staged per chunk
constexpr int PAIRS = BT * JT;                // (row, unit) pairs per block
constexpr int THREADS = PAIRS * KSPLIT;       // 256
constexpr int COLS = 4 * JT;                  // z columns a block computes

template <typename T>
__global__ void __launch_bounds__(THREADS) lstm_cell_fwd_kernel(const StepArgs g) {
  __shared__ float hs[BT][KC + 1];           // +1: the BT rows fall in distinct banks
  __shared__ float us[KC][COLS];
  __shared__ float part[KSPLIT - 1][4][PAIRS];

  const T* __restrict__ xp = static_cast<const T*>(g.xp);
  const T* __restrict__ h_prev = static_cast<const T*>(g.h_prev);
  const T* __restrict__ c_prev = static_cast<const T*>(g.c_prev);
  const T* __restrict__ u = static_cast<const T*>(g.u);
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
      hs[r][k] = (b < g.b && kk < H) ? to_f(h_prev[(long long)b * g.h_stride + kk]) : 0.f;
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
  const float c_old = to_f(c_prev[(long long)b * g.c_stride + j]);
  const float c_new = __fadd_rn(__fmul_rn(fg, c_old), __fmul_rn(ig, gg));  // as torch's ops
  float h_car = rt<T>(og * tanhf(c_new)), c_car = rt<T>(c_new), y = h_car;
  if (g.mask != nullptr) {
    const float m = to_f(static_cast<const T*>(g.mask)[(long long)b * g.m_stride]);
    y = rt<T>(__fmul_rn(m, h_car));
    h_car = blend<T>(m, h_car, to_f(h_prev[(long long)b * g.h_stride + j]));
    c_car = blend<T>(m, c_car, c_old);
    static_cast<T*>(g.hc_out)[(long long)b * g.hc_stride + j] = from_f<T>(h_car);
  }
  static_cast<T*>(g.c_out)[(long long)b * g.c_out_stride + j] = from_f<T>(c_car);
  static_cast<T*>(g.y)[(long long)b * g.y_stride + j] = from_f<T>(y);
}

}  // namespace

extern "C" {

int dl4j_lstm_step_launch(const StepArgs* a, int dtype, void* stream) {
  const int seen = (1 << a->col_i) | (1 << a->col_f) | (1 << a->col_o) | (1 << a->col_g);
  if ((dtype != 0 && dtype != 1) || a->b < 1 || a->h < 1 || a->xp_stride < 4LL * a->h ||
      a->col_i < 0 || a->col_i > 3 || a->col_f < 0 || a->col_f > 3 || a->col_o < 0 ||
      a->col_o > 3 || a->col_g < 0 || a->col_g > 3 || seen != 0xF ||
      (a->b + BT - 1) / BT > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a->h + JT - 1) / JT), (unsigned)((a->b + BT - 1) / BT));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (void)cudaGetLastError();  // report this launch's error, not an older one
  if (dtype == 0)
    lstm_cell_fwd_kernel<float><<<grid, THREADS, 0, s>>>(*a);
  else
    lstm_cell_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(*a);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (every tensor of one type). xp (B, 4H) rows xp_stride
// elements apart, each row contiguous; h, c, h_out, c_out (B, H) and U (H, 4H) contiguous.
// col_i, col_f, col_o, col_g: the z column block (0..3) of each gate, a permutation of 0..3.
// Launches on `stream` without synchronising; returns the cudaError_t of the launch (0 on
// success).
int dl4j_lstm_cell_fwd(const void* xp, const void* h, const void* c, const void* u,
                       void* h_out, void* c_out, int dtype, int b, int hidden,
                       long long xp_stride, int col_i, int col_f, int col_o, int col_g,
                       void* stream) {
  StepArgs a{};
  a.xp = xp; a.h_prev = h; a.c_prev = c; a.u = u; a.mask = nullptr;
  a.y = h_out; a.c_out = c_out; a.hc_out = nullptr;
  a.b = b; a.h = hidden;
  a.xp_stride = xp_stride;
  a.h_stride = a.c_stride = a.y_stride = a.c_out_stride = a.hc_stride = hidden;
  a.m_stride = 0;
  a.col_i = col_i; a.col_f = col_f; a.col_o = col_o; a.col_g = col_g;
  return dl4j_lstm_step_launch(&a, dtype, stream);
}

}  // extern "C"
