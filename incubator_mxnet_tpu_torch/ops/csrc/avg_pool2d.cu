// Non-overlapping NHWC average pooling (kernel == stride, no padding), its
// forward and its backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels incubator_mxnet_tpu/ops/pallas_kernels.py ::
// avg_pool2d_fwd (_pool_fwd_kernel) and avg_pool2d_bwd (_pool_bwd_kernel).
// They compute what incubator_mxnet_tpu_torch/ops/fused.py :: avg_pool2d_ref
// and avg_pool2d_bwd_ref compute:
//
//   forward   y[n, i, j, c] = (sum over the (ph, pw) window at (i*ph, j*pw)
//             of x[n, ., ., c]) / (ph*pw)   (f32 sum, one division, one
//             rounding to x's dtype, as jnp.mean)
//   backward  dx[n, h, w, c] = dy[n, h/ph, w/pw, c] * inv, inv =
//             float32(1 / (ph*pw)), one multiply and one rounding
//
// in float32, bfloat16 or float16. The global pool of ResNet (7x7 over 7x7)
// is the case ph = H, pw = W.
//
// What bounds them: bytes. The forward reads x once and writes y once, the
// backward reads dy once and writes dx once, one f32 operation per element:
// the least time is (input + output bytes) / 3.35 TB/s. Two routes, named by
// incubator_mxnet_tpu_torch/ops/kernels.py :: pool_route from the window
// (ph, pw), the channels, the dtype and the buffers' alignment alone; this
// file launches the route it is given and holds no rule of its own.
//
//   "window" (more than 16 window positions; the global pool). A block is
//   8 channel words (x) by 16 slices of the window (y) of one output
//   pixel. Forward: slice s sums positions s, s + 16, s + 32, ... in that
//   order, issuing up to 4 loads before its first add; the 16 partial sums
//   meet in shared memory and are added in slice order 0..15, then divided
//   once. The order is fixed by (ph, pw) alone, not by the grid or the
//   number of SMs, so the same input gives the same bits on every run; no
//   atomics. Backward: slice 0 reads each dy word once, scales and rounds
//   it into shared memory, and the 16 slices store it to their positions,
//   16 bytes a store, neighbouring threads on neighbouring channels.
//   At (32, 7, 7, 2048) bfloat16 that is a (32, 32) grid: 1,024 blocks of
//   128 threads, 7.8 a SM, all resident in one wave (64 registers a
//   thread); the forward's 131,072 threads each issue 3 or 4 16-byte loads
//   at once, so the whole 6.42 MB input is in flight over 132 SMs, 48.6 KB
//   a SM (one thread an output word would give 8,192 threads walking the
//   window a load or two at a time: about 1 KB a SM, latency-bound).
//
//   "per_output" (at most 16 positions; the 2x2 pools). One thread an
//   output word (forward) or a dy word (backward) on a 2-D grid of channel
//   words (x, up to 32 threads) by output pixels (y): the pixel count
//   gives plenty of threads, so splitting the window would only add a
//   shared-memory reduction. The forward issues its window's loads four at
//   a time before adding them in window order; the backward reads its dy
//   word once, rounds it once and makes ph*pw 16-byte stores.
//
// Any C: each route is templated on the channels a thread moves, one
// 16-byte word (V = 8 for bfloat16 and float16, 4 for float32; C a multiple
// of V and both pointers 16-byte aligned; every ResNet shape) or V = 1 (one
// channel a thread, C = 12 in bfloat16 for example), with the same
// arithmetic. One word a thread keeps each load and store instruction of a
// warp on one contiguous run; two float4 a thread at a 32-byte stride
// write half sectors per store instruction, and were the slower of the
// two layouts on the float32 backward. Index arithmetic: the pixel
// index p = (n*Ho + oh)*Wo + ow gives the window's first input row as
// (p / Wo) * ph, because H = Ho*ph; one division a thread, in 32 bits while
// p < 2^32, none per element.
//
// The caller guarantees: contiguous NHWC tensors, H = Ho * ph, W = Wo * pw.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWinX = 8;        // window route: channel words a block
constexpr int kWinY = 16;       // window route: slices of the window
constexpr int kWinLoads = 4;    // window route: loads a slice issues at once
constexpr int kOutLoads = 4;    // per-output route: loads issued at once
constexpr int kMaxGridY = 65535;
enum Route { kWindow = 0, kPerOutput = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// V channels of T as they lie in memory: one 16-byte word (V = 8 for
// bfloat16 and float16, 4 for float32), or one element (V = 1)
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  Vec<T, V> r;
  if constexpr (V == 1)
    r.v[0] = p[0];
  else
    *reinterpret_cast<uint4*>(&r) = __ldg(reinterpret_cast<const uint4*>(p));
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Vec<T, V>& r) {
  if constexpr (V == 1)
    p[0] = r.v[0];
  else
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&r);
}

template <typename T, int V>
__device__ __forceinline__ void add(float* acc, const Vec<T, V>& r) {
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] += to_f(r.v[k]);
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> round_to(const float* s) {
  Vec<T, V> r;
#pragma unroll
  for (int k = 0; k < V; ++k) r.v[k] = from_f<T>(s[k]);
  return r;
}

// p / Wo, in 32 bits while p fits
__device__ __forceinline__ long long row_of(long long p, int Wo) {
  return p <= 0xffffffffLL ? (long long)((unsigned)p / (unsigned)Wo)
                           : p / Wo;
}

// Offset of the window's first element of output (or dy) pixel p.
__device__ __forceinline__ long long window_origin(long long p, int W, int C,
                                                   int Wo, int ph, int pw) {
  const long long r = row_of(p, Wo);  // n * Ho + oh
  const int ow = (int)(p - r * Wo);
  return (r * ph * W + (long long)ow * pw) * C;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    mx_pool_fwd_window_kernel(const T* __restrict__ x, T* __restrict__ y,
                              int W, int C, int Wo, int ph, int pw,
                              long long P) {
  __shared__ float part[kWinY][kWinX][V];
  const int cv = blockIdx.x * kWinX + threadIdx.x;
  const bool live = cv < C / V;
  const int win = ph * pw;
  for (long long p = blockIdx.y; p < P; p += gridDim.y) {
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    if (live) {
      const T* base =
          x + window_origin(p, W, C, Wo, ph, pw) + (long long)cv * V;
      for (int k0 = threadIdx.y; k0 < win; k0 += kWinY * kWinLoads) {
        Vec<T, V> v[kWinLoads];
#pragma unroll
        for (int i = 0; i < kWinLoads; ++i) {
          const int k = k0 + i * kWinY;
          if (k < win) {
            const int a = k / pw;
            v[i] = load<T, V>(base + ((long long)a * W + (k - a * pw)) * C);
          }
        }
#pragma unroll
        for (int i = 0; i < kWinLoads; ++i)
          if (k0 + i * kWinY < win) add<T, V>(acc, v[i]);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) part[threadIdx.y][threadIdx.x][k] = acc[k];
    __syncthreads();
    if (threadIdx.y == 0 && live) {
      float s[V];
#pragma unroll
      for (int k = 0; k < V; ++k) s[k] = part[0][threadIdx.x][k];
#pragma unroll
      for (int j = 1; j < kWinY; ++j)
#pragma unroll
        for (int k = 0; k < V; ++k) s[k] += part[j][threadIdx.x][k];
#pragma unroll
      for (int k = 0; k < V; ++k) s[k] = s[k] / (float)win;
      store<T, V>(y + p * C + (long long)cv * V, round_to<T, V>(s));
    }
    __syncthreads();
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    mx_pool_fwd_per_output_kernel(const T* __restrict__ x,
                                  T* __restrict__ y, int W, int C, int Wo,
                                  int ph, int pw, long long P) {
  const int cv = blockIdx.x * blockDim.x + threadIdx.x;
  if (cv >= C / V) return;
  const int win = ph * pw;
  const long long step = (long long)gridDim.y * blockDim.y;
  for (long long p = (long long)blockIdx.y * blockDim.y + threadIdx.y; p < P;
       p += step) {
    const T* base = x + window_origin(p, W, C, Wo, ph, pw) + (long long)cv * V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    int a = 0, b = 0;  // window row and column of position k0 + i
    for (int k0 = 0; k0 < win; k0 += kOutLoads) {
      Vec<T, V> v[kOutLoads];
#pragma unroll
      for (int i = 0; i < kOutLoads; ++i) {
        if (k0 + i < win) {
          v[i] = load<T, V>(base + ((long long)a * W + b) * C);
          if (++b == pw) b = 0, ++a;
        }
      }
#pragma unroll
      for (int i = 0; i < kOutLoads; ++i)
        if (k0 + i < win) add<T, V>(acc, v[i]);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = acc[k] / (float)win;
    store<T, V>(y + p * C + (long long)cv * V, round_to<T, V>(acc));
  }
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> scaled(const T* dy, float inv) {
  const Vec<T, V> g = load<T, V>(dy);
  float s[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = to_f(g.v[k]) * inv;
  return round_to<T, V>(s);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    mx_pool_bwd_window_kernel(const T* __restrict__ dy, T* __restrict__ dx,
                              int W, int C, int Wo, int ph, int pw, float inv,
                              long long P) {
  // the scaled dy vectors, in raw words: a __shared__ array takes no type
  // with constructors
  __shared__ uint4 raw[(kWinX * sizeof(Vec<T, V>) + 15) / 16];
  Vec<T, V>* val = reinterpret_cast<Vec<T, V>*>(raw);
  const int cv = blockIdx.x * kWinX + threadIdx.x;
  const bool live = cv < C / V;
  const int win = ph * pw;
  for (long long p = blockIdx.y; p < P; p += gridDim.y) {
    if (threadIdx.y == 0 && live)
      val[threadIdx.x] = scaled<T, V>(dy + p * C + (long long)cv * V, inv);
    __syncthreads();
    if (live) {
      const Vec<T, V> g = val[threadIdx.x];
      T* base = dx + window_origin(p, W, C, Wo, ph, pw) + (long long)cv * V;
      for (int k = threadIdx.y; k < win; k += kWinY) {
        const int a = k / pw;
        store<T, V>(base + ((long long)a * W + (k - a * pw)) * C, g);
      }
    }
    __syncthreads();
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    mx_pool_bwd_per_output_kernel(const T* __restrict__ dy,
                                  T* __restrict__ dx, int W, int C, int Wo,
                                  int ph, int pw, float inv, long long P) {
  const int cv = blockIdx.x * blockDim.x + threadIdx.x;
  if (cv >= C / V) return;
  const long long step = (long long)gridDim.y * blockDim.y;
  for (long long p = (long long)blockIdx.y * blockDim.y + threadIdx.y; p < P;
       p += step) {
    const Vec<T, V> g = scaled<T, V>(dy + p * C + (long long)cv * V, inv);
    T* base = dx + window_origin(p, W, C, Wo, ph, pw) + (long long)cv * V;
    for (int a = 0; a < ph; ++a)
      for (int b = 0; b < pw; ++b)
        store<T, V>(base + ((long long)a * W + b) * C, g);
  }
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

unsigned grid_y(long long need) {
  return (unsigned)(need < kMaxGridY ? need : kMaxGridY);
}

// One pass (fwd: x -> y; else dy -> dx) on the route it is given. The
// per-output block is tx channel vectors by 128 / tx pixels, tx the least
// power of two >= C / V, at most 32.
template <typename T, int V>
void launch(bool fwd, int route, const void* in, void* out, int N, int H,
            int W, int C, int ph, int pw, float inv, cudaStream_t st) {
  const int Ho = H / ph, Wo = W / pw, cvn = C / V;
  const long long P = (long long)N * Ho * Wo;
  const T* src = static_cast<const T*>(in);
  T* dst = static_cast<T*>(out);
  if (route == kWindow) {
    const dim3 block(kWinX, kWinY), grid((cvn + kWinX - 1) / kWinX, grid_y(P));
    if (fwd)
      mx_pool_fwd_window_kernel<T, V>
          <<<grid, block, 0, st>>>(src, dst, W, C, Wo, ph, pw, P);
    else
      mx_pool_bwd_window_kernel<T, V>
          <<<grid, block, 0, st>>>(src, dst, W, C, Wo, ph, pw, inv, P);
    return;
  }
  int tx = 1;
  while (tx < cvn && tx < 32) tx *= 2;
  const int ty = kThreads / tx;
  const dim3 block(tx, ty),
      grid((cvn + tx - 1) / tx, grid_y((P + ty - 1) / ty));
  if (fwd)
    mx_pool_fwd_per_output_kernel<T, V>
        <<<grid, block, 0, st>>>(src, dst, W, C, Wo, ph, pw, P);
  else
    mx_pool_bwd_per_output_kernel<T, V>
        <<<grid, block, 0, st>>>(src, dst, W, C, Wo, ph, pw, inv, P);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int pass(bool fwd, int dtype, int route, int vec, int device, const void* in,
         void* out, int N, int H, int W, int C, int ph, int pw, float inv,
         void* stream) {
  if (dtype < 0 || dtype > 2 || (route != kWindow && route != kPerOutput) ||
      N <= 0 || C <= 0 || ph <= 0 || pw <= 0 || H <= 0 || W <= 0 ||
      H % ph != 0 || W % pw != 0)
    return (int)cudaErrorInvalidValue;
  const int word = dtype == 0 ? 4 : 8;  // channels in 16 bytes
  if (vec != 1 && (vec != word || C % word != 0 || !aligned16(in) ||
                   !aligned16(out)))
    return (int)cudaErrorInvalidValue;
  Device guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Fn = void (*)(bool, int, const void*, void*, int, int, int, int, int,
                      int, float, cudaStream_t);
  static const Fn table[3][2] = {
      {launch<float, 1>, launch<float, 4>},
      {launch<__nv_bfloat16, 1>, launch<__nv_bfloat16, 8>},
      {launch<__half, 1>, launch<__half, 8>}};
  table[dtype][vec != 1](fwd, route, in, out, N, H, W, C, ph, pw, inv, st);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16; route: 0 window, 1 per-output
// (kernels.pool_route); vec: channels a thread, a 16-byte word (4 float32
// or 8 16-bit channels; C a multiple of it, both buffers 16-byte aligned)
// or 1. x is (N, H, W, C), y is (N, H/ph, W/pw, C).
// Returns cudaGetLastError() after the launch, never synchronises.
extern "C" int mx_avg_pool2d_fwd(int dtype, int route, int vec, int device,
                                 const void* x, void* y, int N, int H, int W,
                                 int C, int ph, int pw, void* stream) {
  return pass(true, dtype, route, vec, device, x, y, N, H, W, C, ph, pw, 0.f,
              stream);
}

// As the forward; dy is (N, H/ph, W/pw, C), dx is (N, H, W, C), inv is
// 1 / (ph * pw) rounded to float32 by the caller.
extern "C" int mx_avg_pool2d_bwd(int dtype, int route, int vec, int device,
                                 const void* dy, void* dx, int N, int H, int W,
                                 int C, int ph, int pw, float inv,
                                 void* stream) {
  return pass(false, dtype, route, vec, device, dy, dx, N, H, W, C, ph, pw,
              inv, stream);
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
