// What the LSTM kernels share: lstm_cell.cu's step kernel (one time step; the cell entry and the
// sequence entry's step body) and lstm_seq.cu's resident body (a whole segment in one launch).
// Both compute the reference's cell (deeplearning4j_tpu/ops/kernels/lstm.py::_cell_kernel) with
// its roundings, and the sequence entry adds nn/recurrent.py's _scan mask rule. Internal linkage,
// as conv_common.cuh's, except the step launcher, which lstm_seq.cu calls across objects.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

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

// v rounded to T and back: the value a tensor of type T holds
template <typename T>
__device__ __forceinline__ float rt(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float sigmoid_acc(float x) { return 1.0f / (1.0f + expf(-x)); }

// z[c] for a runtime block index c in 0..3, kept in registers
__device__ __forceinline__ float pick(const float (&z)[4], int c) {
  return c == 0 ? z[0] : c == 1 ? z[1] : c == 2 ? z[2] : z[3];
}

// _scan's carry blend m * n + (1 - m) * o in T, each operation rounded to T as PyTorch's
// elementwise ops on T tensors round it (the _rn intrinsics are never contracted into an FMA)
template <typename T>
__device__ __forceinline__ float blend(float m, float n, float o) {
  const float a = rt<T>(__fmul_rn(m, n));
  const float b = rt<T>(__fmul_rn(rt<T>(__fsub_rn(1.0f, m)), o));
  return rt<T>(__fadd_rn(a, b));
}

}  // namespace

// One step of a sequence for the step kernel (lstm_cell.cu), every row stride in elements:
// reads xp (B, 4H), h_prev and c_prev (B, H), U (H, 4H) and, where `mask` is not null, the
// step's mask value of each row; writes y (m * h' under a mask, else h'), the c carry and,
// under a mask, the h carry to hc_out.
struct StepArgs {
  const void* xp;
  const void* h_prev;
  const void* c_prev;
  const void* u;
  const void* mask;  // (B,) at m_stride, or nullptr
  void* y;
  void* c_out;
  void* hc_out;      // used only with a mask
  int b, h;
  long long xp_stride, h_stride, c_stride, m_stride, y_stride, c_out_stride, hc_stride;
  int col_i, col_f, col_o, col_g;
};

// Launches the step kernel for one StepArgs (dtype 0 = float32, 1 = bfloat16) on `stream`;
// returns the cudaError_t of the launch.
extern "C" int dl4j_lstm_step_launch(const StepArgs* a, int dtype, void* stream);
