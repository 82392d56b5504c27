// Fused per-channel scale / shift / residual / activation over a row-major
// (M, C) view, for Hopper (sm_90a).
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/pallas_kernels.py ::
// apply_scale_shift_act (_apply_kernel). It computes what
// incubator_mxnet_tpu_torch/ops/fused.py :: apply_ref computes:
//
//   out[m, c] = act(x[m, c] * scale[c] + shift[c] + residual[m, c])
//
// with f32 arithmetic inside (in that order, multiply then adds, each
// rounded: no fused multiply-add, so the result is the plain version's),
// and the output in x's dtype (float32, bfloat16 or float16). scale, shift
// and residual may each be absent.
// act is one of none, relu, sigmoid, tanh, silu and the exact (erf) gelu.
//
// What bounds it on the card: bytes. It reads x (and the residual) once and
// writes out once, about 0.25 operations a byte, far below the card's
// balance point, so the least time is (x + residual + out bytes) / 3.35 TB/s.
// What the design does about it: one pass, no intermediate in device memory
// (the chain of elementwise kernels it replaces reads and writes the tensor
// once per op); every thread moves 16 bytes at a time (4 float32, or 8
// bfloat16 or float16), neighbouring threads on neighbouring addresses, in a
// grid-stride loop over a grid sized to keep every SM full. The per-channel
// scale and shift rows are small and stay in L1/L2.
//
// Any C: where C * itemsize is a multiple of 16 and every pointer is 16-byte
// aligned (no 16-byte vector crosses a row; every ResNet-50 shape), the
// vector instance above; otherwise a scalar instance, one element a thread
// with the same arithmetic (Dense(10) in float32, 4 channels in bfloat16).
//
// The caller guarantees: x / residual / out contiguous and of one dtype,
// scale and shift float32 of C elements.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3, kSilu = 4, kGelu = 5 };

template <int ACT>
__device__ __forceinline__ float activate(float u) {
  if (ACT == kRelu) return fmaxf(u, 0.f);
  if (ACT == kSigmoid) return 1.f / (1.f + expf(-u));
  if (ACT == kTanh) return tanhf(u);
  if (ACT == kSilu) return u * (1.f / (1.f + expf(-u)));
  if (ACT == kGelu) return u * (erff(u * 0.70710678118654752f) + 1.f) * 0.5f;
  return u;
}

// 16 bytes of T, widened to floats on load and rounded back on store.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* d) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* s) {
    *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
  }
  __device__ __forceinline__ static float one(const float* p) {
    return __ldg(p);
  }
  __device__ __forceinline__ static void put(float* p, float x) { *p = x; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* d) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      d[2 * i] = f.x;
      d[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* s) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static void put(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

template <>
struct Pack<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __half* p, float* d) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      d[2 * i] = f.x;
      d[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__half* p, const float* s) {
    uint4 v;
    __half2* h = reinterpret_cast<__half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(s[2 * i], s[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
  __device__ __forceinline__ static float one(const __half* p) {
    return __half2float(*p);
  }
  __device__ __forceinline__ static void put(__half* p, float x) {
    *p = __float2half_rn(x);
  }
};

// n float32 values of a per-channel row (n = 4 or 8, 16-byte aligned)
template <int N>
__device__ __forceinline__ void load_row(const float* p, float* d) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
    d[i] = v.x;
    d[i + 1] = v.y;
    d[i + 2] = v.z;
    d[i + 3] = v.w;
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
    scale_shift_act_kernel(const T* __restrict__ x,
                           const float* __restrict__ scale,
                           const float* __restrict__ shift,
                           const T* __restrict__ res, T* __restrict__ out,
                           long long n_vec, long long c_vec) {
  constexpr int N = Pack<T>::N;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < n_vec;
       v += step) {
    const long long c0 = (v % c_vec) * N;
    float u[N];
    Pack<T>::load(x + v * N, u);
    if (scale != nullptr) {
      float s[N];
      load_row<N>(scale + c0, s);
#pragma unroll
      for (int i = 0; i < N; ++i) u[i] = __fmul_rn(u[i], s[i]);
    }
    if (shift != nullptr) {
      float b[N];
      load_row<N>(shift + c0, b);
#pragma unroll
      for (int i = 0; i < N; ++i) u[i] = __fadd_rn(u[i], b[i]);
    }
    if (res != nullptr) {
      float r[N];
      Pack<T>::load(res + v * N, r);
#pragma unroll
      for (int i = 0; i < N; ++i) u[i] = __fadd_rn(u[i], r[i]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) u[i] = activate<ACT>(u[i]);
    Pack<T>::store(out + v * N, u);
  }
}

// the same function one element a thread, for rows that are not whole
// aligned 16-byte vectors
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
    scale_shift_act_scalar_kernel(const T* __restrict__ x,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ shift,
                                  const T* __restrict__ res,
                                  T* __restrict__ out, long long n,
                                  long long C) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += step) {
    const long long c = e % C;
    float u = Pack<T>::one(x + e);
    if (scale != nullptr) u = __fmul_rn(u, __ldg(scale + c));
    if (shift != nullptr) u = __fadd_rn(u, __ldg(shift + c));
    if (res != nullptr) u = __fadd_rn(u, Pack<T>::one(res + e));
    Pack<T>::put(out + e, activate<ACT>(u));
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(int act, const void* x, const float* scale,
                   const float* shift, const void* res, void* out,
                   long long M, long long C, int device, cudaStream_t st) {
  constexpr int N = Pack<T>::N;
  const bool vec = C % N == 0 && aligned16(x) && aligned16(out) &&
                   aligned16(scale) && aligned16(shift) && aligned16(res);
  const long long c_vec = C / N;
  const long long n_vec = M * c_vec;
  const long long n = M * C;
  const int grid = grid_for(vec ? n_vec : n, device);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  T* op = static_cast<T*>(out);
  switch (act) {
#define MX_SSA_CASE(A)                                                  \
  case A:                                                               \
    if (vec)                                                            \
      scale_shift_act_kernel<T, A><<<grid, kThreads, 0, st>>>(          \
          xp, scale, shift, rp, op, n_vec, c_vec);                      \
    else                                                                \
      scale_shift_act_scalar_kernel<T, A><<<grid, kThreads, 0, st>>>(   \
          xp, scale, shift, rp, op, n, C);                              \
    break;
    MX_SSA_CASE(kNone)
    MX_SSA_CASE(kRelu)
    MX_SSA_CASE(kSigmoid)
    MX_SSA_CASE(kTanh)
    MX_SSA_CASE(kSilu)
    MX_SSA_CASE(kGelu)
#undef MX_SSA_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (x, residual and out; the codes
// of ops/kernels.py :: DTYPE_CODES). act: 0 none, 1 relu,
// 2 sigmoid, 3 tanh, 4 silu, 5 gelu. scale, shift and residual may be null.
// M >= 1, C >= 1. Returns cudaGetLastError() after the launch (0 on
// success), never synchronises.
extern "C" int mx_scale_shift_act(int dtype, int act, int device,
                                  const void* x, const void* scale,
                                  const void* shift, const void* residual,
                                  void* out, long long M, long long C,
                                  void* stream) {
  if (M <= 0 || C <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch<float>(act, x, sc, sh, residual, out, M, C, device, st);
      break;
    case 1:
      err = launch<__nv_bfloat16>(act, x, sc, sh, residual, out, M, C, device,
                                  st);
      break;
    default:
      err = launch<__half>(act, x, sc, sh, residual, out, M, C, device, st);
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
