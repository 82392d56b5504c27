// The recurrent cell's arithmetic, shared by the step kernels of
// rnn_cell.cu and the whole-layer kernels of rnn_layer.cu: the modes and
// activations, the float32 conversions, and one element of the cell's
// forward and backward, every product and sum rounded on its own (no fused
// multiply-add), in the order of incubator_mxnet_tpu_torch/ops/rnn.py ::
// cell_fwd_ref and cell_bwd_ref. On the host, `on_device`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

enum Mode { kLstm = 0, kGru = 1, kRnn = 2 };
enum Act {
  kTanh = 0,
  kRelu = 1,
  kSigmoid = 2,
  kSoftrelu = 3,
  kSoftsign = 4,
  kLogSigmoid = 5
};

template <int MODE>
struct Gates {
  static constexpr int G = MODE == kLstm ? 4 : (MODE == kGru ? 3 : 1);
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float sigmoid(float u) {
  return __fdiv_rn(1.f, __fadd_rn(expf(-u), 1.f));
}

// log(1 + exp(-|u|)), the tail both softplus forms share
__device__ __forceinline__ float softplus_tail(float u) {
  return log1pf(expf(-fabsf(u)));
}

__device__ __forceinline__ float act(float u, int a) {
  switch (a) {
    case kTanh:
      return tanhf(u);
    case kRelu:
      return fmaxf(u, 0.f);
    case kSigmoid:
      return sigmoid(u);
    case kSoftrelu:
      return __fadd_rn(fmaxf(u, 0.f), softplus_tail(u));
    case kSoftsign:
      return __fdiv_rn(u, __fadd_rn(fabsf(u), 1.f));
    default:
      return __fsub_rn(fminf(u, 0.f), softplus_tail(u));
  }
}

// s (1 - s), the sigmoid's derivative from its output
__device__ __forceinline__ float sig_grad(float s) {
  return __fmul_rn(s, __fsub_rn(1.f, s));
}

// the activation's derivative from its output y
__device__ __forceinline__ float act_grad(float y, int a) {
  switch (a) {
    case kTanh:
      return __fsub_rn(1.f, __fmul_rn(y, y));
    case kRelu:
      return y > 0.f ? 1.f : 0.f;
    case kSigmoid:
      return sig_grad(y);
    case kSoftrelu:
      return -expm1f(-y);  // sigmoid(u) = 1 - exp(-softplus(u))
    case kSoftsign: {
      const float r = __fsub_rn(1.f, fabsf(y));  // 1 / (1 + |u|)
      return __fmul_rn(r, r);
    }
    default:
      return -expm1f(y);  // 1 - sigmoid(u) = 1 - exp(log_sigmoid(u))
  }
}

// One element of the forward from the gate pre-activations a (of gx) and b
// (of gh), G each: the gate activations into gate (LSTM i f g o, GRU r z n;
// the RNN none), the new state into hn (and the LSTM's cn). cp is the
// LSTM's previous c, hp the GRU's previous h.
template <int MODE>
__device__ __forceinline__ void cell_fwd(const float* a, const float* b,
                                         float cp, float hp, int act_code,
                                         float* gate, float& cn, float& hn) {
  if constexpr (MODE == kLstm) {
    gate[0] = sigmoid(__fadd_rn(a[0], b[0]));
    gate[1] = sigmoid(__fadd_rn(a[1], b[1]));
    gate[2] = act(__fadd_rn(a[2], b[2]), act_code);
    gate[3] = sigmoid(__fadd_rn(a[3], b[3]));
    cn = __fadd_rn(__fmul_rn(gate[1], cp), __fmul_rn(gate[0], gate[2]));
    hn = __fmul_rn(gate[3], act(cn, act_code));
  } else if constexpr (MODE == kGru) {
    gate[0] = sigmoid(__fadd_rn(a[0], b[0]));
    gate[1] = sigmoid(__fadd_rn(a[1], b[1]));
    gate[2] = act(__fadd_rn(a[2], __fmul_rn(gate[0], b[2])), act_code);
    hn = __fadd_rn(__fmul_rn(__fsub_rn(1.f, gate[1]), gate[2]),
                   __fmul_rn(gate[1], hp));
  } else {
    hn = act(__fadd_rn(a[0], b[0]), act_code);
  }
}

// One element of the backward, from the output gradient d (and the LSTM's
// dc): the gate pre-activations' gradients into dg (G), the GRU's n block of
// the recurrent product's gradient (dn r) into dnh, and the elementwise part
// of the previous state's gradient into dprev (the LSTM's dc, the GRU's
// d z). gate holds the forward's activations (LSTM i f g o, GRU r z n); cp,
// cn the LSTM's c and c'; nh the GRU's n block of gh, hp its previous h; y
// the RNN's h'.
template <int MODE>
__device__ __forceinline__ void cell_bwd(const float* gate, float cp,
                                         float cn, float nh, float hp,
                                         float y, float d, float dc,
                                         int act_code, float* dg,
                                         float& dnh, float& dprev) {
  if constexpr (MODE == kLstm) {
    const float tc = act(cn, act_code);
    const float dct = __fadd_rn(
        dc, __fmul_rn(__fmul_rn(d, gate[3]), act_grad(tc, act_code)));
    dg[0] = __fmul_rn(__fmul_rn(dct, gate[2]), sig_grad(gate[0]));
    dg[1] = __fmul_rn(__fmul_rn(dct, cp), sig_grad(gate[1]));
    dg[2] = __fmul_rn(__fmul_rn(dct, gate[0]), act_grad(gate[2], act_code));
    dg[3] = __fmul_rn(__fmul_rn(d, tc), sig_grad(gate[3]));
    dprev = __fmul_rn(dct, gate[1]);
  } else if constexpr (MODE == kGru) {
    dg[2] = __fmul_rn(__fmul_rn(d, __fsub_rn(1.f, gate[1])),
                      act_grad(gate[2], act_code));
    dg[1] = __fmul_rn(__fmul_rn(d, __fsub_rn(hp, gate[2])),
                      sig_grad(gate[1]));
    dg[0] = __fmul_rn(__fmul_rn(dg[2], nh), sig_grad(gate[0]));
    dnh = __fmul_rn(dg[2], gate[0]);
    dprev = __fmul_rn(d, gate[1]);
  } else {
    dg[0] = __fmul_rn(d, act_grad(y, act_code));
  }
}

// run fn on `device`, putting the caller's current device back
template <typename F>
int on_device(int device, F fn) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = fn();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace
