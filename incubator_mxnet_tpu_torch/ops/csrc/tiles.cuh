// CUDA-core tile helpers shared by the flash-attention kernels
// (flash_attention.cu) and the paged-attention chunk route
// (paged_attention.cu): 256 threads as 16 row groups x 16 column groups, a
// (16 RM x D) f32 tile against (64 x D) tiles in shared memory, rows padded
// to D + 4 elements so a row group's reads fall on distinct banks. The
// second operand of a product (B in tile_dot, M in tile_pm) is f32, or int8
// codes (rows of D + 4 bytes, read four codes at a time), which the paged
// kernel keeps as codes and scales outside the product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // query rows and key rows per tile
constexpr int kLdS = kTile + 4;      // padded row of a (64 x 64) score tile
constexpr float kMasked = -1e30f;    // the mask value and the LSE sentinel

template <int D>
struct Dims {
  static constexpr int kLd = D + 4;         // padded row of a (64 x D) tile
                                            // (elements: f32 or int8)
  static constexpr int kTD = D / 16;        // output columns per thread
  static constexpr int kTileFloats = kTile * kLd;
};

// output column t of column group cg: float4 runs interleaved over the
// groups, so each vector read of a row is contiguous across the groups
template <int D>
__device__ __forceinline__ int out_col(int cg, int t) {
  if constexpr (Dims<D>::kTD < 4) return cg * Dims<D>::kTD + t;
  else return (t / 4) * 64 + cg * 4 + (t % 4);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

// four consecutive elements of an operand tile as f32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}

// acc[i][j] += A[rg*RM+i] . B[cg+16j] over D (A a padded (16 RM x D) f32
// tile, B a padded (64 x D) one of TB)
template <int D, int RM = 4, typename TB = float>
__device__ __forceinline__ void tile_dot(const float* A, const TB* B,
                                         int rg, int cg, float acc[RM][4]) {
  constexpr int L = Dims<D>::kLd;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[RM], b[4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (rg * RM + i) * L + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = ld4(B + (cg + 16 * j) * L + d);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// the thread's TD columns of row `row` of a padded (64 x D) tile
template <int D, typename TM>
__device__ __forceinline__ void load_cols(const TM* M, int row, int cg,
                                          float* m) {
  constexpr int TD = Dims<D>::kTD;
  const TM* p = M + row * Dims<D>::kLd;
  if constexpr (TD < 4) {
#pragma unroll
    for (int t = 0; t < TD; ++t) m[t] = (float)p[out_col<D>(cg, t)];
  } else {
#pragma unroll
    for (int u = 0; u < TD / 4; ++u) {
      const float4 x = ld4(p + u * 64 + cg * 4);
      m[4 * u] = x.x;
      m[4 * u + 1] = x.y;
      m[4 * u + 2] = x.z;
      m[4 * u + 3] = x.w;
    }
  }
}

// out[i][t] += sum_k P[rg*RM+i][k] * M[k][col(cg, t)]   (P a (16 RM x 64)
// f32 score tile, M a padded (64 x D) tile of TM)
template <int D, int RM = 4, typename TM = float>
__device__ __forceinline__ void tile_pm(const float* P, const TM* M, int rg,
                                        int cg, float out[RM][Dims<D>::kTD]) {
  constexpr int TD = Dims<D>::kTD;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float p[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(P + (rg * RM + i) * kLdS + k);
      p[i][0] = x.x;
      p[i][1] = x.y;
      p[i][2] = x.z;
      p[i][3] = x.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float m[TD];
      load_cols<D, TM>(M, k + kk, cg, m);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int t = 0; t < TD; ++t) out[i][t] = fmaf(p[i][kk], m[t], out[i][t]);
      }
    }
  }
}

// reductions over the 16 threads of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace
