// The greedy NMS sweep of SSD's detection tail, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this sweep as one
// lax.fori_loop inside a jitted program (incubator_mxnet_tpu/ops/contrib.py
// :: box_nms and _multibox_detection_body). Run eagerly, that loop would
// cost a few launches a row, tens of thousands for SSD300's 8732 anchors.
// It computes what incubator_mxnet_tpu_torch/ops/contrib.py ::
// nms_sweep_ref computes:
//
//   for i in 0 .. A-1, in order:
//     if keep[i]: for every j > i with keep[j] (and ids[j] == ids[i]):
//       if iou(box i, box j) > thresh: keep[j] = 0
//
// over rows already sorted by score, one image a block.
//
// Exactness: the keep set must be the plain version's bit for bit, and an
// IoU compared against a threshold flips a row at one ulp. So the IoU is
// PyTorch's op by op: each product, sum and quotient rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, which the compiler never
// contracts into a fused multiply-add), in box_iou's order.
//
// What bounds it on the card: the chain. Row i's test needs the keep flags
// that rows before it left, so the A steps run one after another, each a
// block-wide barrier; the operations (about A^2 / 2 IoU tests an image) sit
// far below the card's rate. What the design does about it: a step costs
// one pass of the block's 1024 threads over the later rows (about 9 each
// at A = 8732), a row already suppressed costs no step and no barrier, and
// the flags live in the output buffer, which the block's own L1 holds. A
// faster design (a suppression bitmask computed in parallel, then a
// one-warp sweep over it) is later work.
//
// The caller guarantees: boxes (B, A, 4) float32 and ids (B, A) float32
// contiguous, keep (B, A) one byte a row (0 or 1), all on one device.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// box_iou's value: intersection over union, 0 where the union is not
// positive.
__device__ __forceinline__ float iou(float4 a, float area_a, float4 b) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area(b)), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
nms_sweep_kernel(const float4* __restrict__ boxes,
                 const float* __restrict__ ids, uint8_t* keep, int A,
                 float thresh) {
  const size_t base = (size_t)blockIdx.x * A;
  const float4* bx = boxes + base;
  const float* id = ids ? ids + base : nullptr;
  uint8_t* kp = keep + base;
  for (int i = 0; i < A - 1; ++i) {
    // every thread reads the same flag: the last barrier published it
    if (!kp[i]) continue;
    const float4 bi = __ldg(bx + i);
    const float ai = area(bi);
    const float idi = id ? __ldg(id + i) : 0.f;
    for (int j = i + 1 + threadIdx.x; j < A; j += kThreads) {
      if (!kp[j] || (id && __ldg(id + j) != idi)) continue;
      if (iou(bi, ai, __ldg(bx + j)) > thresh) kp[j] = 0;
    }
    __syncthreads();
  }
}

}  // namespace

// boxes (B, A, 4) float32, ids (B, A) float32 or null (every row one
// class), keep (B, A) bytes, read as the rows alive at the start and
// written with the rows kept. B >= 1, A >= 1. Returns cudaGetLastError()
// after the launch (0 on success), never synchronises.
extern "C" int mx_nms_sweep(int device, const void* boxes, const void* ids,
                            void* keep, int B, int A, float thresh,
                            void* stream) {
  if (B <= 0 || A <= 0) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  nms_sweep_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(ids),
      static_cast<uint8_t*>(keep), A, thresh);
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
