// Hopper (sm_90a) machinery shared by the tensor-core kernels of
// flash_attention.cu and paged_attention.cu: mbarriers (whose waits trap
// instead of hanging), TMA loads, 128-byte-swizzled wgmma descriptors,
// wgmma issue/fence/commit/wait, named barriers between two consumer
// warpgroups, the 16-bit (bf16 or float16) hi + lo split of an f32 operand,
// setmaxnreg, and on
// the host the device guard, the CUDA driver's tensor-map encoder
// (through the runtime, so no -lcuda) and the SM count of the persistent grids.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the phase of parity `parity` to complete; a wait that outlasts
// ~2^34 cycles (seconds: a fault in the pipeline, never a slow tile) traps,
// so the launch fails instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// make this thread's generic-proxy writes to shared memory visible to the
// async proxy (a wgmma reading a tile that threads, not TMA, wrote)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory operand descriptor, 128-byte swizzle: start address,
// leading byte offset (between 64-column atoms of an MN-major operand; unused
// for a K-major one), stride byte offset 1024 (between groups of 8 rows)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// named barriers between the two consumer warpgroups (256 threads: one
// warpgroup syncs, the other arrives); barrier 0 is __syncthreads'
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across a
// wgmma fence or wait
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x N f32, the accumulator fragment) (+)= A (64 x 16, K-major, shared
// memory) . B (16 x N, K-major, shared memory); accumulate = 0 overwrites.
// T is the operands' 16-bit type: __nv_bfloat16 (the default) or __half;
// both take the same fragments, descriptors and shapes
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate);
// d (64 x N f32) += A (64 x 16 of T in registers, 4 x 2 values a thread) .
// B (16 x N, N-major (transposed), shared memory)
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

// each shape once for bf16 and once for float16: the instruction's
// operand type is the only difference
#define MX_WGMMA_SS_64(T, TY) \
template <> \
__device__ __forceinline__ void wgmma_ss<64, T>(float* d, uint64_t da, \
                                             uint64_t db, int accumulate) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31}" \
      ", %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(accumulate)); \
}

#define MX_WGMMA_SS_128(T, TY) \
template <> \
__device__ __forceinline__ void wgmma_ss<128, T>(float* d, uint64_t da, \
                                             uint64_t db, int accumulate) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31," \
      " %32, %33, %34, %35, %36, %37, %38, %39," \
      " %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55," \
      " %56, %57, %58, %59, %60, %61, %62, %63}" \
      ", %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(accumulate)); \
}

#define MX_WGMMA_RS_64(T, TY) \
template <> \
__device__ __forceinline__ void wgmma_rs<64, T>(float* d, const uint32_t* a, \
                                             uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31}" \
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), \
        "r"(1)); \
}

#define MX_WGMMA_RS_128(T, TY) \
template <> \
__device__ __forceinline__ void wgmma_rs<128, T>(float* d, const uint32_t* a, \
                                             uint64_t db) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31," \
      " %32, %33, %34, %35, %36, %37, %38, %39," \
      " %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55," \
      " %56, %57, %58, %59, %60, %61, %62, %63}" \
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), \
        "r"(1)); \
}

MX_WGMMA_SS_64(__nv_bfloat16, "bf16")
MX_WGMMA_SS_64(__half, "f16")
MX_WGMMA_SS_128(__nv_bfloat16, "bf16")
MX_WGMMA_SS_128(__half, "f16")
MX_WGMMA_RS_64(__nv_bfloat16, "bf16")
MX_WGMMA_RS_64(__half, "f16")
MX_WGMMA_RS_128(__nv_bfloat16, "bf16")
MX_WGMMA_RS_128(__half, "f16")
#undef MX_WGMMA_SS_64
#undef MX_WGMMA_SS_128
#undef MX_WGMMA_RS_64
#undef MX_WGMMA_RS_128

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// x = hi + lo, each a bf16 pair in the register A-fragment's packing
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ uint32_t pack_f16(float a, float b) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// x = hi + lo, each a float16 pair; lo (and hi below 2^-14) is subnormal
// more often than not, which the tensor cores take as it is
__device__ __forceinline__ void split_f16(float a, float b, uint32_t* hi,
                                          uint32_t* lo) {
  const __half2 h = __floats2half2_rn(a, b);
  const float2 hf = __half22float2(h);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack_f16(a - hf.x, b - hf.y);
}

// what a tensor-core kernel over 16-bit type T needs of it: the TMA data
// type, the hi + lo split of an f32 pair, a pair rounded and packed as a
// register operand, and the rounded store of a pair
template <typename T>
struct Elem16;

template <>
struct Elem16<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static void split(float a, float b,
                                               uint32_t* hi, uint32_t* lo) {
    split_bf16(a, b, hi, lo);
  }
  __device__ __forceinline__ static uint32_t pack(float a, float b) {
    return pack_bf16(a, b);
  }
  __device__ __forceinline__ static void store2(__nv_bfloat16* p, float a,
                                                float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

template <>
struct Elem16<__half> {
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ __forceinline__ static void split(float a, float b,
                                               uint32_t* hi, uint32_t* lo) {
    split_f16(a, b, hi, lo);
  }
  __device__ __forceinline__ static uint32_t pack(float a, float b) {
    return pack_f16(a, b);
  }
  __device__ __forceinline__ static void store2(__half* p, float a, float b) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
  }
};

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

// cuTensorMapEncodeTiled from the CUDA driver through the runtime, so the
// library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 16-bit tensor of `type` (bf16 unless given) as a `rank`-D map (dims[0]
// contiguous; strides in bytes of dims 1..rank-1), read in `box` boxes with
// 128-byte swizzle; outside the map reads as zero
bool tensor_map_bf16(CUtensorMap* map, const void* ptr, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box,
                     CUtensorMapDataType type =
                         CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, type, rank,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// streaming multiprocessors of the current device (the persistent grid)
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  int n = dev >= 0 && dev < 64 ? counts[dev] : 0;
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
    if (dev >= 0 && dev < 64) counts[dev] = n;
  }
  return n;
}

}  // namespace
