// The recurrent cell's elementwise step, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package's cells
// (incubator_mxnet_tpu/ops/nn.py :: lstm_cell, gru_cell, rnn_relu_cell,
// scanned by ops/nn.py :: rnn) are jnp, and XLA fuses their elementwise
// part inside lax.scan. PyTorch runs eagerly, so without this kernel each
// step of gluon.rnn and npx.rnn would be about ten elementwise launches.
// It computes what incubator_mxnet_tpu_torch/ops/rnn.py :: cell_fwd_ref and
// cell_bwd_ref compute (rnn_gates.cuh :: cell_fwd / cell_bwd, shared with
// the whole-layer kernels of rnn_layer.cu), in the same order (each product and sum rounded
// on its own: no fused multiply-add), from the gate pre-activations of one
// step, gx = x Wx^T + bias and gh = h Wh^T (+ bh for the GRU), (N, G H)
// row-major with the gate blocks in the reference's order:
//
//   LSTM (G 4, [i f g o])  i, f, o = sigmoid(gx + gh), g = act(gx + gh)
//                          c' = f c + i g, h' = o act(c')
//   GRU  (G 3, [r z n])    r = sigmoid(rx + rh), z = sigmoid(zx + zh)
//                          n = act(nx + r nh), h' = (1 - z) n + z h
//   RNN  (G 1)             h' = act(gx + gh)
//
// with act one of npx.activation's tanh, relu, sigmoid, softrelu (softplus),
// softsign and log_sigmoid (a launch argument: every thread takes the same
// branch), and sigmoid(u) = 1 / (exp(-u) + 1). The forward
// writes h' (and c'), and, when the step is taped, the gate activations
// (LSTM i f g o, GRU r z n) for the backward. The backward takes them with
// dh' (and dc'; a null gradient reads as zeros) and writes dgx, dgh (the
// same values but for the GRU's n block, dn_pre r, so it is written for
// the GRU only) and the elementwise part of the previous state's gradient
// (the LSTM's dc, the GRU's dh' z). Every value is computed in float32 from
// the inputs' type (float32, bfloat16 or float16) and rounded once to it.
//
// What bounds it on the card: bytes. A thread reads each of its gate
// values once and does a few dozen operations on them, far under the
// card's balance point. The LSTM forward moves 15 N H values (gx, gh: 4
// each; c; h', c'; the 4 activations), the backward 13 N H; at the word
// language model's step (N 32, H 650, float32) that is 1.25 MB, 0.37 us
// at 3.35 TB/s, far below a launch's own cost: at this shape the kernel
// reads as launch latency, and the path's gain is the launches it saves.
// What the design does about the bytes: one pass, no intermediate in
// device memory; a thread takes V consecutive columns of one row (V = 16
// bytes' worth, 4 float32 or 8 bfloat16 / float16, halved down to 1 until
// V divides H and every pointer is aligned to V values), so each of its G
// gate loads is one vector load and neighbouring threads read neighbouring
// addresses; a grid-stride loop over a grid sized to fill every SM.
//
// The caller guarantees: every tensor contiguous, of one dtype, on one
// card; gx, gh, the activations, dgx and dgh (N, G H), the rest (N, H).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rnn_gates.cuh"

namespace {

constexpr int kThreads = 256;

// V values of T in one aligned load or store
template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float* d) {
  const Chunk<T, V> c = *reinterpret_cast<const Chunk<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) d[i] = to_f(c.v[i]);
}

// V values, or zeros for a null gradient
template <typename T, int V>
__device__ __forceinline__ void load_or_zero(const T* p, long long at,
                                             float* d) {
  if (p != nullptr) {
    load<T, V>(p + at, d);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) d[i] = 0.f;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float* s) {
  Chunk<T, V> c;
#pragma unroll
  for (int i = 0; i < V; ++i) c.v[i] = from_f<T>(s[i]);
  *reinterpret_cast<Chunk<T, V>*>(p) = c;
}

template <typename T, int MODE, int V>
__global__ void __launch_bounds__(kThreads)
    rnn_cell_fwd_kernel(const T* __restrict__ gx, const T* __restrict__ gh,
                        const T* __restrict__ h, const T* __restrict__ c,
                        T* __restrict__ h_out, T* __restrict__ c_out,
                        T* __restrict__ saved, long long N, long long H,
                        int act_code) {
  constexpr int G = Gates<MODE>::G;
  const long long hv = H / V;
  const long long n_vec = N * hv;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < n_vec; e += step) {
    const long long n = e / hv;
    const long long j = (e - n * hv) * V;
    const long long row = n * G * H + j;  // gate block 0 at (n, j)
    const long long s = n * H + j;        // the state at (n, j)
    float a[G][V], b[G][V], hn[V], cn[V], cp[V] = {}, hp[V] = {};
#pragma unroll
    for (int k = 0; k < G; ++k) {
      load<T, V>(gx + row + k * H, a[k]);
      load<T, V>(gh + row + k * H, b[k]);
    }
    if constexpr (MODE == kLstm) load<T, V>(c + s, cp);
    if constexpr (MODE == kGru) load<T, V>(h + s, hp);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float ai[G], bi[G], gate[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        ai[k] = a[k][i];
        bi[k] = b[k][i];
      }
      cell_fwd<MODE>(ai, bi, cp[i], hp[i], act_code, gate, cn[i], hn[i]);
      if constexpr (MODE != kRnn) {
#pragma unroll
        for (int k = 0; k < G; ++k) a[k][i] = gate[k];
      }
    }
    if constexpr (MODE == kLstm) store<T, V>(c_out + s, cn);
    store<T, V>(h_out + s, hn);
    if (MODE != kRnn && saved != nullptr) {
#pragma unroll
      for (int k = 0; k < G; ++k) store<T, V>(saved + row + k * H, a[k]);
    }
  }
}

template <typename T, int MODE, int V>
__global__ void __launch_bounds__(kThreads)
    rnn_cell_bwd_kernel(const T* __restrict__ saved,
                        const T* __restrict__ gh, const T* __restrict__ h,
                        const T* __restrict__ c, const T* __restrict__ h_new,
                        const T* __restrict__ c_new,
                        const T* __restrict__ dh, const T* __restrict__ dc,
                        T* __restrict__ dgx, T* __restrict__ dgh,
                        T* __restrict__ dstate, long long N, long long H,
                        int act_code) {
  constexpr int G = Gates<MODE>::G;
  const long long hv = H / V;
  const long long n_vec = N * hv;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < n_vec; e += step) {
    const long long n = e / hv;
    const long long j = (e - n * hv) * V;
    const long long row = n * G * H + j;
    const long long s = n * H + j;
    float d[V], gate[G][V] = {}, cp[V] = {}, cn[V] = {}, dcv[V] = {},
                nh[V] = {}, hp[V] = {}, y[V] = {};
    load_or_zero<T, V>(dh, s, d);
    if constexpr (MODE == kLstm) {
#pragma unroll
      for (int k = 0; k < G; ++k) load<T, V>(saved + row + k * H, gate[k]);
      load<T, V>(c + s, cp);
      load<T, V>(c_new + s, cn);
      load_or_zero<T, V>(dc, s, dcv);
    } else if constexpr (MODE == kGru) {
#pragma unroll
      for (int k = 0; k < G; ++k) load<T, V>(saved + row + k * H, gate[k]);
      load<T, V>(gh + row + 2 * H, nh);
      load<T, V>(h + s, hp);
    } else {
      load<T, V>(h_new + s, y);
    }
    float dg[G][V], dnh[V], dprev[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float gi[G], dgi[G];
#pragma unroll
      for (int k = 0; k < G; ++k) gi[k] = gate[k][i];
      cell_bwd<MODE>(gi, cp[i], cn[i], nh[i], hp[i], y[i], d[i], dcv[i],
                     act_code, dgi, dnh[i], dprev[i]);
#pragma unroll
      for (int k = 0; k < G; ++k) dg[k][i] = dgi[k];
    }
#pragma unroll
    for (int k = 0; k < G; ++k) store<T, V>(dgx + row + k * H, dg[k]);
    if constexpr (MODE == kGru) {
      store<T, V>(dgh + row, dg[0]);
      store<T, V>(dgh + row + H, dg[1]);
      store<T, V>(dgh + row + 2 * H, dnh);
    }
    if constexpr (MODE != kRnn) store<T, V>(dstate + s, dprev);
  }
}

int grid_for(long long n_vec, int device) {
  static int sms[64] = {0};
  int n_sm = device >= 0 && device < 64 ? sms[device] : 0;
  if (n_sm == 0) {
    if (cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess || n_sm <= 0)
      n_sm = 132;
    if (device >= 0 && device < 64) sms[device] = n_sm;
  }
  // enough resident blocks for every SM (2048 threads each), no more
  const long long most = (long long)n_sm * (2048 / kThreads);
  const long long need = (n_vec + kThreads - 1) / kThreads;
  return (int)(need < most ? need : most);
}

// the largest V of 16 bytes' worth that divides H and to whose alignment
// every pointer keeps
template <typename T>
int pick_vec(long long H, const void* const* ptrs, int n_ptrs) {
  int v = 16 / (int)sizeof(T);
  while (v > 1) {
    bool ok = H % v == 0;
    for (int k = 0; ok && k < n_ptrs; ++k)
      ok = reinterpret_cast<uintptr_t>(ptrs[k]) % (v * sizeof(T)) == 0;
    if (ok) break;
    v /= 2;
  }
  return v;
}

struct Fwd {
  const void *gx, *gh, *h, *c;
  void *h_out, *c_out, *saved;
  long long N, H;
  int act;
};

struct Bwd {
  const void *saved, *gh, *h, *c, *h_new, *c_new, *dh, *dc;
  void *dgx, *dgh, *dstate;
  long long N, H;
  int act;
};

template <typename T, int MODE, int V>
void fwd_v(const Fwd& a, int grid, cudaStream_t st) {
  rnn_cell_fwd_kernel<T, MODE, V><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(a.gx), static_cast<const T*>(a.gh),
      static_cast<const T*>(a.h), static_cast<const T*>(a.c),
      static_cast<T*>(a.h_out), static_cast<T*>(a.c_out),
      static_cast<T*>(a.saved), a.N, a.H, a.act);
}

template <typename T, int MODE, int V>
void bwd_v(const Bwd& a, int grid, cudaStream_t st) {
  rnn_cell_bwd_kernel<T, MODE, V><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(a.saved), static_cast<const T*>(a.gh),
      static_cast<const T*>(a.h), static_cast<const T*>(a.c),
      static_cast<const T*>(a.h_new), static_cast<const T*>(a.c_new),
      static_cast<const T*>(a.dh), static_cast<const T*>(a.dc),
      static_cast<T*>(a.dgx), static_cast<T*>(a.dgh),
      static_cast<T*>(a.dstate), a.N, a.H, a.act);
}

template <typename T, int MODE>
cudaError_t fwd_mode(const Fwd& a, int device, cudaStream_t st) {
  const void* ptrs[] = {a.gx, a.gh, a.h, a.c, a.h_out, a.c_out, a.saved};
  const int v = pick_vec<T>(a.H, ptrs, 7);
  const int grid = grid_for(a.N * (a.H / v), device);
  switch (v) {
    case 8:
      if constexpr (sizeof(T) == 2) fwd_v<T, MODE, 8>(a, grid, st);
      break;
    case 4:
      fwd_v<T, MODE, 4>(a, grid, st);
      break;
    case 2:
      fwd_v<T, MODE, 2>(a, grid, st);
      break;
    default:
      fwd_v<T, MODE, 1>(a, grid, st);
  }
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t bwd_mode(const Bwd& a, int device, cudaStream_t st) {
  const void* ptrs[] = {a.saved, a.gh,  a.h,   a.c,   a.h_new, a.c_new,
                        a.dh,    a.dc,  a.dgx, a.dgh, a.dstate};
  const int v = pick_vec<T>(a.H, ptrs, 11);
  const int grid = grid_for(a.N * (a.H / v), device);
  switch (v) {
    case 8:
      if constexpr (sizeof(T) == 2) bwd_v<T, MODE, 8>(a, grid, st);
      break;
    case 4:
      bwd_v<T, MODE, 4>(a, grid, st);
      break;
    case 2:
      bwd_v<T, MODE, 2>(a, grid, st);
      break;
    default:
      bwd_v<T, MODE, 1>(a, grid, st);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_dtype(int mode, const Fwd& a, int device, cudaStream_t st) {
  switch (mode) {
    case kLstm:
      return fwd_mode<T, kLstm>(a, device, st);
    case kGru:
      return fwd_mode<T, kGru>(a, device, st);
    default:
      return fwd_mode<T, kRnn>(a, device, st);
  }
}

template <typename T>
cudaError_t bwd_dtype(int mode, const Bwd& a, int device, cudaStream_t st) {
  switch (mode) {
    case kLstm:
      return bwd_mode<T, kLstm>(a, device, st);
    case kGru:
      return bwd_mode<T, kGru>(a, device, st);
    default:
      return bwd_mode<T, kRnn>(a, device, st);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (the codes of ops/kernels.py ::
// DTYPE_CODES). mode: 0 LSTM, 1 GRU, 2 RNN; act_code: 0 tanh, 1 relu,
// 2 sigmoid, 3 softrelu, 4 softsign, 5 log_sigmoid. h is read
// by the GRU only, c by the LSTM only, c_out written by the LSTM only;
// saved may be null (nothing written), and the RNN writes none. N, H >= 1.
// Returns cudaGetLastError() after the launch (0 on success), never
// synchronises.
extern "C" int mx_rnn_cell_fwd(int dtype, int mode, int act_code, int device,
                               const void* gx, const void* gh, const void* h,
                               const void* c, void* h_out, void* c_out,
                               void* saved, long long N, long long H,
                               void* stream) {
  if (N <= 0 || H <= 0 || dtype < 0 || dtype > 2 || mode < 0 || mode > 2 ||
      act_code < kTanh || act_code > kLogSigmoid)
    return (int)cudaErrorInvalidValue;
  if ((mode == kLstm && (c == nullptr || c_out == nullptr)) ||
      (mode == kGru && h == nullptr))
    return (int)cudaErrorInvalidValue;
  const Fwd a{gx, gh, h, c, h_out, c_out, saved, N, H, act_code};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    switch (dtype) {
      case 0:
        return fwd_dtype<float>(mode, a, device, st);
      case 1:
        return fwd_dtype<__nv_bfloat16>(mode, a, device, st);
      default:
        return fwd_dtype<__half>(mode, a, device, st);
    }
  });
}

// The backward: the LSTM reads saved, c, c_new, dh and dc; the GRU saved,
// gh, h and dh; the RNN h_new and dh (dh and dc may be null: zeros). dgx
// is always written, dgh by the GRU only, dstate by the LSTM and the GRU.
extern "C" int mx_rnn_cell_bwd(int dtype, int mode, int act_code, int device,
                               const void* saved, const void* gh,
                               const void* h, const void* c,
                               const void* h_new, const void* c_new,
                               const void* dh, const void* dc, void* dgx,
                               void* dgh, void* dstate, long long N,
                               long long H, void* stream) {
  if (N <= 0 || H <= 0 || dtype < 0 || dtype > 2 || mode < 0 || mode > 2 ||
      act_code < kTanh || act_code > kLogSigmoid || dgx == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((mode == kLstm && (saved == nullptr || c == nullptr ||
                         c_new == nullptr || dstate == nullptr)) ||
      (mode == kGru && (saved == nullptr || gh == nullptr || h == nullptr ||
                        dgh == nullptr || dstate == nullptr)) ||
      (mode == kRnn && h_new == nullptr))
    return (int)cudaErrorInvalidValue;
  const Bwd a{saved, gh, h, c, h_new, c_new, dh, dc, dgx, dgh, dstate, N, H,
              act_code};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    switch (dtype) {
      case 0:
        return bwd_dtype<float>(mode, a, device, st);
      case 1:
        return bwd_dtype<__nv_bfloat16>(mode, a, device, st);
      default:
        return bwd_dtype<__half>(mode, a, device, st);
    }
  });
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
