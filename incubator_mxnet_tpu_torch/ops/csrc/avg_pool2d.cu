// Non-overlapping NHWC average pooling (kernel == stride, no padding), its
// forward and its backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels incubator_mxnet_tpu/ops/pallas_kernels.py ::
// avg_pool2d_fwd (_pool_fwd_kernel) and avg_pool2d_bwd (_pool_bwd_kernel).
// They compute what incubator_mxnet_tpu_torch/ops/fused.py :: avg_pool2d_ref
// and its gradient compute:
//
//   forward   y[n, i, j, c] = mean over the (ph, pw) window at (i*ph, j*pw)
//             of x[n, ., ., c]      (sum in f32, then / (ph*pw), as jnp.mean)
//   backward  dx[n, h, w, c] = dy[n, h/ph, w/pw, c] * (1 / (ph*pw))
//
// with f32 arithmetic inside and the output in the input's dtype. The
// global pool of ResNet (7x7 over 7x7) is the case ph = H, pw = W.
//
// What bounds them on the card: bytes (one add or one multiply per element
// moved). The forward reads x once and writes y once; the backward reads dy
// once and writes dx once, so the least time is (input + output bytes) /
// 3.35 TB/s. What the design does about it: one thread per (n, output
// pixel, 8-channel vector) in the forward, looping over its window, and one
// thread per 8-channel vector of dx in the backward (the broadcast the TPU
// kernel made in VMEM, with no scatter); each thread moves 16 bytes of
// bfloat16 or 32 bytes of float32 at a time, neighbouring threads on
// neighbouring channels. Small blocks (64 threads) spread the global pool's
// few output vectors over all SMs. Left for later: splitting a large window
// over several threads with a warp reduction.
//
// Any C: the kernels are templated on the channels a thread moves, V = 8
// (C a multiple of 8 and both pointers 16-byte aligned; every ResNet shape)
// or V = 1 (one channel a thread, C = 12 for example), with the same
// arithmetic.
//
// The caller guarantees: contiguous NHWC tensors, H = Ho * ph and W = Wo * pw.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 64;
constexpr int kBwdThreads = 256;

// 8 channels of T, widened to floats on load and rounded back on store.
template <typename T>
struct Pack8;

template <>
struct Pack8<float> {
  __device__ __forceinline__ static void load(const float* p, float* d) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
    d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
    d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* s) {
    reinterpret_cast<float4*>(p)[0] = make_float4(s[0], s[1], s[2], s[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(s[4], s[5], s[6], s[7]);
  }
};

template <>
struct Pack8<__nv_bfloat16> {
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
};

// V channels of T: the 8-channel vector above, or one channel
template <typename T, int V>
struct PackV : Pack8<T> {};

template <typename T>
struct PackV<T, 1> {
  __device__ __forceinline__ static void load(const T* p, float* d) {
    d[0] = to_float(p[0]);
  }
  __device__ __forceinline__ static void store(T* p, const float* s) {
    p[0] = from_float(s[0], p);
  }
  __device__ __forceinline__ static float to_float(float x) { return x; }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static float from_float(float x, float*) {
    return x;
  }
  __device__ __forceinline__ static __nv_bfloat16 from_float(
      float x, __nv_bfloat16*) {
    return __float2bfloat16_rn(x);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kFwdThreads)
    avg_pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int H,
                        int W, int C, int Ho, int Wo, int ph, int pw,
                        long long total) {
  const int c8 = C / V;
  const float count = (float)(ph * pw);
  const long long step = (long long)gridDim.x * kFwdThreads;
  for (long long idx = (long long)blockIdx.x * kFwdThreads + threadIdx.x;
       idx < total; idx += step) {
    const int cv = (int)(idx % c8);
    long long r = idx / c8;
    const int ow = (int)(r % Wo);
    r /= Wo;
    const int oh = (int)(r % Ho);
    const long long n = r / Ho;
    const T* base =
        x + ((n * H + (long long)oh * ph) * W + (long long)ow * pw) * C + cv * V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    for (int i = 0; i < ph; ++i) {
      const T* row = base + (long long)i * W * C;
      for (int j = 0; j < pw; ++j) {
        float v[V];
        PackV<T, V>::load(row + (long long)j * C, v);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] += v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = acc[k] / count;
    PackV<T, V>::store(y + idx * V, acc);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kBwdThreads)
    avg_pool_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx, int H,
                        int W, int C, int Ho, int Wo, int ph, int pw,
                        float inv, long long total) {
  const int c8 = C / V;
  const long long step = (long long)gridDim.x * kBwdThreads;
  for (long long idx = (long long)blockIdx.x * kBwdThreads + threadIdx.x;
       idx < total; idx += step) {
    const int cv = (int)(idx % c8);
    long long r = idx / c8;
    const int w = (int)(r % W);
    r /= W;
    const int h = (int)(r % H);
    const long long n = r / H;
    float g[V];
    PackV<T, V>::load(
        dy + ((n * Ho + h / ph) * Wo + w / pw) * C + (long long)cv * V, g);
#pragma unroll
    for (int k = 0; k < V; ++k) g[k] = g[k] * inv;
    PackV<T, V>::store(dx + idx * V, g);
  }
}

int grid_for(long long total, int threads, int device) {
  static int sms[64] = {0};
  int n_sm = device >= 0 && device < 64 ? sms[device] : 0;
  if (n_sm == 0) {
    if (cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess || n_sm <= 0)
      n_sm = 132;
    if (device >= 0 && device < 64) sms[device] = n_sm;
  }
  const long long most = (long long)n_sm * (2048 / threads);
  const long long need = (total + threads - 1) / threads;
  return (int)(need < most ? need : most);
}

struct Device {
  int prev = 0;
  int dev = 0;
  cudaError_t err = cudaSuccess;
  explicit Device(int device) : dev(device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  }
  ~Device() {
    if (err == cudaSuccess && prev != dev) cudaSetDevice(prev);
  }
};

bool bad_shape(int dtype, int N, int H, int W, int C, int ph, int pw) {
  return (dtype != 0 && dtype != 1) || N <= 0 || C <= 0 || ph <= 0 ||
         pw <= 0 || H <= 0 || W <= 0 || H % ph != 0 || W % pw != 0;
}

// 8-channel vectors where C is a multiple of 8 and both buffers are aligned
bool vec8(int C, const void* a, const void* b) {
  return C % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T, int V>
void fwd(const void* x, void* y, int N, int H, int W, int C, int ph, int pw,
         int device, cudaStream_t st) {
  const int Ho = H / ph, Wo = W / pw;
  const long long total = (long long)N * Ho * Wo * (C / V);
  avg_pool_fwd_kernel<T, V>
      <<<grid_for(total, kFwdThreads, device), kFwdThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<T*>(y), H, W, C, Ho, Wo, ph,
          pw, total);
}

template <typename T, int V>
void bwd(const void* dy, void* dx, int N, int H, int W, int C, int ph, int pw,
         float inv, int device, cudaStream_t st) {
  const int Ho = H / ph, Wo = W / pw;
  const long long total = (long long)N * H * W * (C / V);
  avg_pool_bwd_kernel<T, V>
      <<<grid_for(total, kBwdThreads, device), kBwdThreads, 0, st>>>(
          static_cast<const T*>(dy), static_cast<T*>(dx), H, W, C, Ho, Wo, ph,
          pw, inv, total);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x is (N, H, W, C), y is (N, H/ph, W/pw, C).
// Returns cudaGetLastError() after the launch, never synchronises.
extern "C" int mx_avg_pool2d_fwd(int dtype, int device, const void* x,
                                 void* y, int N, int H, int W, int C, int ph,
                                 int pw, void* stream) {
  if (bad_shape(dtype, N, H, W, C, ph, pw)) return (int)cudaErrorInvalidValue;
  Device guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v8 = vec8(C, x, y);
  if (dtype == 0)
    (v8 ? fwd<float, 8> : fwd<float, 1>)(x, y, N, H, W, C, ph, pw, device,
                                         st);
  else
    (v8 ? fwd<__nv_bfloat16, 8> : fwd<__nv_bfloat16, 1>)(
        x, y, N, H, W, C, ph, pw, device, st);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16. dy is (N, H/ph, W/pw, C), dx is
// (N, H, W, C); inv is 1 / (ph * pw) rounded to float32 by the caller.
// Returns cudaGetLastError() after the launch, never synchronises.
extern "C" int mx_avg_pool2d_bwd(int dtype, int device, const void* dy,
                                 void* dx, int N, int H, int W, int C, int ph,
                                 int pw, float inv, void* stream) {
  if (bad_shape(dtype, N, H, W, C, ph, pw)) return (int)cudaErrorInvalidValue;
  Device guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v8 = vec8(C, dy, dx);
  if (dtype == 0)
    (v8 ? bwd<float, 8> : bwd<float, 1>)(dy, dx, N, H, W, C, ph, pw, inv,
                                         device, st);
  else
    (v8 ? bwd<__nv_bfloat16, 8> : bwd<__nv_bfloat16, 1>)(
        dy, dx, N, H, W, C, ph, pw, inv, device, st);
  return (int)cudaGetLastError();
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
