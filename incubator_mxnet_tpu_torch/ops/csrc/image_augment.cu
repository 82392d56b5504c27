// The card half of the input pipeline, for Hopper (sm_90a): per-image crop,
// horizontal mirror, 1/255 scale, per-channel mean/std and the cast, in one
// pass over an NHWC batch.
//
// Replaces no TPU kernel: the JAX package computes this chain in jnp
// (incubator_mxnet_tpu/ops/fused.py :: image_augment), which XLA fuses into
// one program. Run eagerly in PyTorch the chain is six kernels, each reading
// and writing the whole batch. It computes what
// incubator_mxnet_tpu_torch/ops/fused.py :: image_augment_ref computes:
//
//   out[n, i, j, c] = cast((v * (1/255) - mean[c]) / std[c]),
//   v = x[n, y0[n] + i, x0[n] + (flip[n] ? cw - 1 - j : j), c]
//
// for uint8 x (a float32 x skips the 1/255), in that order, each step
// rounded on its own (__fmul_rn, __fsub_rn, __fdiv_rn, which the compiler
// never contracts), as PyTorch's separate ops and the JAX package's jnp
// chain round them; mean and std may each be absent. An offset is read as
// lax.dynamic_slice reads a start (a negative one from the end, then
// clamped so the crop fits). The cast
// rounds to nearest even (float32, bfloat16 or float16 out).
//
// What bounds it on the card: bytes. One byte (or four) read and two or
// four written for each output element, a handful of operations between:
// (N ch cw 3) (in + out bytes) / 3.35 TB/s, about 4.3 us for bfloat16 at
// 32 x 224^2. What the design does about it: one pass with no intermediate
// in device memory; a block an output row, whose threads take neighbouring
// pixels, so the reads of a row (forward, or backward under a mirror) and
// the writes are contiguous across a warp; the per-channel constants are
// arguments, held in registers. A faster version would move 16 bytes a
// thread; this first one moves a pixel (3 to 12 bytes in, 6 to 12 out).
//
// The caller guarantees: x (N, H, W, 3) contiguous uint8 or float32, out
// (N, ch, cw, 3) contiguous, ch <= H, cw <= W; y0 and x0 (N,) int32 or null
// (the centre crop is the caller's to pass), flip (N,) bytes or null.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float load(const uint8_t* p) {
  return __fmul_rn(static_cast<float>(*p), 1.0f / 255.0f);
}
__device__ __forceinline__ float load(const float* p) { return *p; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

// lax.dynamic_slice's start: negative from the end, then clamped into
// [0, size - window]
__device__ __forceinline__ int start(int v, int size, int window) {
  if (v < 0) v += size;
  return min(max(v, 0), size - window);
}

struct Norm {
  float mean[3];
  float std[3];
  int has_mean;
  int has_std;
};

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
image_augment_kernel(const In* __restrict__ x, const int* __restrict__ y0,
                     const int* __restrict__ x0,
                     const uint8_t* __restrict__ flip, Out* __restrict__ out,
                     int H, int W, int ch, int cw, Norm norm) {
  const long long row = blockIdx.x;          // n * ch + i
  const int n = static_cast<int>(row / ch);
  const int i = static_cast<int>(row - static_cast<long long>(n) * ch);
  const int oy = y0 ? start(__ldg(y0 + n), H, ch) : 0;
  const int ox = x0 ? start(__ldg(x0 + n), W, cw) : 0;
  const bool mirror = flip && __ldg(flip + n);
  const In* src = x + ((static_cast<long long>(n) * H + oy + i) * W + ox) * 3;
  Out* dst = out + row * cw * 3;
  for (int j = threadIdx.x; j < cw; j += kThreads) {
    const int col = mirror ? cw - 1 - j : j;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = load(src + col * 3 + c);
      if (norm.has_mean) v = __fsub_rn(v, norm.mean[c]);
      if (norm.has_std) v = __fdiv_rn(v, norm.std[c]);
      store(dst + j * 3 + c, v);
    }
  }
}

template <typename In, typename Out>
cudaError_t launch(const void* x, const int* y0, const int* x0,
                   const uint8_t* flip, void* out, int N, int H, int W,
                   int ch, int cw, const Norm& norm, cudaStream_t st) {
  const long long rows = static_cast<long long>(N) * ch;
  image_augment_kernel<In, Out><<<static_cast<unsigned>(rows), kThreads, 0,
                                  st>>>(
      static_cast<const In*>(x), y0, x0, flip, static_cast<Out*>(out), H, W,
      ch, cw, norm);
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch_out(int out_dtype, const void* x, const int* y0,
                       const int* x0, const uint8_t* flip, void* out, int N,
                       int H, int W, int ch, int cw, const Norm& norm,
                       cudaStream_t st) {
  switch (out_dtype) {
    case 0:
      return launch<In, float>(x, y0, x0, flip, out, N, H, W, ch, cw, norm,
                               st);
    case 1:
      return launch<In, __nv_bfloat16>(x, y0, x0, flip, out, N, H, W, ch, cw,
                                       norm, st);
    default:
      return launch<In, __half>(x, y0, x0, flip, out, N, H, W, ch, cw, norm,
                                st);
  }
}

}  // namespace

// Codes of ops/kernels.py DTYPE_CODES: in_dtype: 0 float32, 4 uint8;
// out_dtype: 0 float32, 1 bfloat16, 2 float16. mean / std: 3 floats each,
// or null.
// N, H, W, ch, cw >= 1, ch <= H, cw <= W, N * ch < 2^31. Returns
// cudaGetLastError() after the launch (0 on success), never synchronises.
extern "C" int mx_image_augment(int in_dtype, int out_dtype, int device,
                                const void* x, const void* y0, const void* x0,
                                const void* flip, void* out, int N, int H,
                                int W, int ch, int cw, const float* mean,
                                const float* std, void* stream) {
  if (N <= 0 || ch <= 0 || cw <= 0 || ch > H || cw > W
      || static_cast<long long>(N) * ch >= (1LL << 31)
      || (in_dtype != 0 && in_dtype != 4) || out_dtype < 0 || out_dtype > 2)
    return (int)cudaErrorInvalidValue;
  Norm norm = {};
  norm.has_mean = mean != nullptr;
  norm.has_std = std != nullptr;
  for (int c = 0; c < 3; ++c) {
    norm.mean[c] = mean ? mean[c] : 0.f;
    norm.std[c] = std ? std[c] : 1.f;
  }
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* py0 = static_cast<const int*>(y0);
  const int* px0 = static_cast<const int*>(x0);
  const uint8_t* pf = static_cast<const uint8_t*>(flip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 4)
    err = launch_out<uint8_t>(out_dtype, x, py0, px0, pf, out, N, H, W, ch,
                              cw, norm, st);
  else
    err = launch_out<float>(out_dtype, x, py0, px0, pf, out, N, H, W, ch, cw,
                            norm, st);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
