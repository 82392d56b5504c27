// Flash attention over (batch*heads, T, d): the forward (with or without the
// per-row log-sum-exp) and the two backward sweeps, for Hopper (sm_90a).
//
// Replaces the TPU kernels of incubator_mxnet_tpu/ops/pallas_attention.py:
//   flash_fwd        _flash_forward_kernel (_kernel)            B5
//   flash_fwd (lse)  _flash_forward_lse (_kernel_with_lse)      B6
//   flash_bwd_dq     _flash_backward, dq sweep (_bwd_dq_kernel)  B7
//   flash_bwd_dkv    _flash_backward, dk/dv sweep (_bwd_dkv_kernel) B8
// They compute what incubator_mxnet_tpu_torch/ops/attention.py ::
// flash_attention_ref, flash_forward_lse_ref, flash_bwd_dq_ref and
// flash_bwd_dkv_ref compute, for q (bh, Tq, d) and k, v (bh, Tk, d):
//
//   s[i, j]  = (q_i . k_j) * scale,  live iff j < Tk and, when causal,
//              j <= i + (Tk - Tq)                  (end-aligned causality)
//   o_i      = sum_j softmax_j(s[i, .])[j] v_j over live j; 0 for a row with
//              no live key
//   lse_i    = m_i + log(l_i), -1e30 for a row with no live key
//   p[i, j]  = exp(s[i, j] - lse_i) on live j where lse_i > -5e29, else 0
//   ds[i, j] = p[i, j] * (dO_i . v_j - delta_i),  delta_i = dO_i . o_i
//   dq_i     = scale * sum_j ds[i, j] k_j
//   dk_j     = scale * sum_i ds[i, j] q_i,  dv_j = sum_i p[i, j] dO_i
//
// with f32 arithmetic and accumulators inside, and q, k, v, o, dO, dq, dk, dv
// in float32, bfloat16 or float16 (lse and delta float32), for every head dim d >= 1
// and any bh. delta is computed by the caller, as the JAX package
// computes it outside Pallas.
//
// Two routes. At d a multiple of 8 up to 128, bfloat16 and float16 run on
// the tensor cores (flash_fwd_wgmma_kernel, flash_bwd_dq_wgmma_kernel and
// flash_bwd_dkv_wgmma_kernel, below, each a template over the 16-bit type);
// float32 inputs, and 16-bit inputs at other d, run on the CUDA cores
// (flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel). The
// wrappers choose by dtype and d alone. float32 stays off the tensor cores
// because they would take it as TF32 (about three digits); d % 8 != 0
// because a row of d 16-bit values is then no multiple of 16 bytes, the
// least global stride a TMA tensor map can describe; d > 128 because a
// 64 x d f32 accumulator is d / 2 registers a thread in each of O, dK and
// dV, which at d = 256 leaves no room for the rest.
//
// What bounds them on the card. At the BERT-base shape (bh 192, T 512, d 64)
// the forward does 12.9 GFLOP on 50.3 MB of bf16 inputs and outputs, so on
// the tensor cores (989 TFLOP/s bf16) its bound is the bytes (0.015 ms at
// 3.35 TB/s); the dq sweep does 19.3 GFLOP and the dk/dv sweep 25.8, which
// make their bound on any cores (0.020 and 0.026 ms on the tensor cores,
// 0.29 and 0.39 ms on the f32 CUDA cores). What the designs do about it:
//   * tensor-core forward: a producer warp streams K and V tiles by TMA into
//     a ring of shared-memory stages (mbarriers), two consumer warpgroups of
//     64 query rows each run S = Q K^T and O += P V as wgmma with f32
//     accumulators in registers, the online softmax runs on those registers,
//     and the (128 x Tk) score block never leaves the chip. P is split into
//     two bf16 terms (hi + lo), so P V keeps the f32 P of the plain version
//     to about 2^-17 (see the kernel's note).
//   * tensor-core backward: the same machinery, each sweep its own kernel
//     (see their note): the resident side (Q, dO or K, V) loads once per
//     128-row item, the other streams through the ring, every product is a
//     wgmma, and P and dS go to their products from registers in two terms
//     (in float16 P shifted by 2^15 and dS scaled per output row by a
//     power of two, so that neither falls into float16's subnormals).
//   * CUDA-core kernels (the CUDA-core forward and both backward sweeps):
//     every tile lives in shared memory as f32 after one 16-byte-vector load
//     from device memory (a scalar one where a row is not a whole number of
//     16-byte vectors), the (64 x 64) score tile never leaves the chip, each
//     thread computes a 4 x 4 block of scores from float4 reads of padded
//     rows (conflict-free banks), and the running max, normaliser and
//     accumulators stay in registers.
// Causal tiles wholly above the diagonal are skipped, as the TPU kernels skip
// them.
//
// Head dims. Each kernel is instantiated for a capacity D (32, 64, 128, 256
// on the CUDA cores; 64, 128 on the tensor cores) and takes the real d at run
// time: columns d..D-1 of every tile are zero (masked loads, or TMA's
// out-of-bounds fill) and are never stored, so they add nothing to a dot
// product. Past 256 the CUDA-core kernels take d in 128-column slices of the
// capacity-128 instances (see Slice below); nothing grows with d.
//
// Unlike the TPU grid, blocks run in parallel and share nothing: the loop over
// key tiles (forward, dq) or query tiles (dk/dv) inside one block takes the
// place of the TPU grid's sequential axis, so both backward sweeps accumulate
// without atomics and are deterministic. Ragged Tq and Tk are masked per tile.
// The grid is one-dimensional, head-major: block b serves head b / tiles and
// row tile b % tiles, so bh is bounded by nothing but memory.
//
// CUDA-core threads: 256 a block, as 16 row groups x 16 column groups. Thread
// (rg, cg) owns rows rg*RM .. rg*RM+RM-1 of a 16 RM-row tile (RM = 4, but 2
// in the backward sweeps at capacity 256: bwd_rm); its scores are the
// columns cg + 16*j (j < 4) of a 64-row tile and its output columns col(cg,
// t) below.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tiles.cuh"

namespace {

constexpr float kSentinelCut = -5e29f;  // lse at or below: a fully masked row

template <typename T>
struct Load8;

template <>
struct Load8<float> {
  __device__ __forceinline__ static float one(const float* p) { return *p; }
  __device__ __forceinline__ static void load(const float* p, float* d) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
    d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
  }
};

template <>
struct Load8<__nv_bfloat16> {
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* d) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      d[2 * i] = f.x;
      d[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Load8<__half> {
  __device__ __forceinline__ static float one(const __half* p) {
    return __half2float(*p);
  }
  __device__ __forceinline__ static void load(const __half* p, float* d) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      d[2 * i] = f.x;
      d[2 * i + 1] = f.y;
    }
  }
};

// rows [row0, row0 + R) of a row-major matrix (rows `ld` elements apart),
// columns [0, width), into a padded f32 tile of capacity D >= width; rows at
// or past `rows` and columns at or past width read as zeros. kVec: every
// 8-value chunk that starts inside a row is whole and 16-byte aligned, one
// vector load; else element by element.
template <typename T, int D, int R, bool kVec>
__device__ __forceinline__ void load_tile_path(const T* __restrict__ src,
                                               int row0, int rows, int ld,
                                               int hd, float* dst) {
  constexpr int kPerRow = D / 8;
  constexpr int kChunks = R * kPerRow;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / kPerRow;
    const int d = (c % kPerRow) * 8;
    float v[8];
    const T* p = src + (long long)(row0 + r) * ld + d;
    if (row0 + r >= rows || d >= hd) {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    } else if constexpr (kVec) {
      Load8<T>::load(p, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = d + i < hd ? Load8<T>::one(p + i) : 0.f;
    }
    float4* o = reinterpret_cast<float4*>(dst + r * Dims<D>::kLd + d);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// the path is chosen once per call (a uniform branch), so the vector loop's
// loads stay straight-line. A contiguous (rows, hd) matrix is ld = width =
// hd; a column piece of one (a slice past capacity 256) is src + c0, ld =
// hd, width = min(D, hd - c0).
template <typename T, int D, int R = kTile>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0,
                                          int rows, int ld, int width,
                                          float* dst) {
  if (ld % 8 == 0 && width % 8 == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0)
    load_tile_path<T, D, R, true>(src, row0, rows, ld, width, dst);
  else
    load_tile_path<T, D, R, false>(src, row0, rows, ld, width, dst);
}

__device__ __forceinline__ bool live(int qi, int kj, int Tq, int Tk,
                                     int causal) {
  return qi < Tq && kj < Tk && (!causal || kj <= qi + (Tk - Tq));
}

// key tiles of `bn` rows a query tile of `bm` rows at q0 reads: all, or, when
// causal, those not wholly above the diagonal (the TPU kernels' skip rule)
__device__ __forceinline__ int key_tiles(int q0, int Tq, int Tk, int causal,
                                         int bm = kTile, int bn = kTile) {
  const int nk = (Tk + bn - 1) / bn;
  if (!causal) return nk;
  const int last = min(q0 + bm, Tq) - 1 + (Tk - Tq);
  if (last < 0) return 0;
  return min(nk, last / bn + 1);
}

// the first query tile that sees a key tile at k0 (causal)
__device__ __forceinline__ int first_query_tile(int k0, int Tq, int Tk) {
  const int first = k0 - (Tk - Tq);
  return first <= 0 ? 0 : first / kTile;
}

// ---------------------------------------------------------------------------
// Head dims past 256 (any d): a block takes a slice of at most D = 128 output
// columns (the slice index is the fastest part of the 1-D grid), and the
// full-d products it needs first (S = Q K^T, and dP = dO V^T in the
// backward) are accumulated over 128-column pieces through the same
// capacity-128 tiles, reloaded piece by piece. Shared memory and registers
// stay those of capacity 128 whatever d is; the scores are recomputed once
// per slice (ceil(d / 128) x the score work), and every slice computes them
// in the same order, so the slices agree on the softmax bit for bit.
template <bool kSliced, int D>
struct Slice {
  int n;      // slices of the output columns
  int col0;   // this block's first output column
  int width;  // its columns
  __device__ Slice(int hd, int index) {
    n = kSliced ? (hd + D - 1) / D : 1;
    col0 = kSliced ? (index % n) * D : 0;
    width = kSliced ? min(D, hd - col0) : hd;
  }
};

// acc[i][j] += X[x0 + rg*RM + i, :] . Y[y0 + cg + 16j, :] over every column
// of two contiguous (rows, hd) matrices, one 128-column piece at a time
// through the tiles sX (16 RM rows) and sY (64 rows); leaves the block
// synchronised and both tiles free
template <typename T, int D, int RM>
__device__ __forceinline__ void sliced_dot(const T* X, int x0, int xrows,
                                           const T* Y, int y0, int yrows,
                                           int hd, float* sX, float* sY,
                                           int rg, int cg,
                                           float acc[RM][4]) {
  for (int c0 = 0; c0 < hd; c0 += D) {
    const int w = min(D, hd - c0);
    load_tile<T, D, 16 * RM>(X + c0, x0, xrows, hd, w, sX);
    load_tile<T, D>(Y + c0, y0, yrows, hd, w, sY);
    __syncthreads();
    tile_dot<D, RM>(sX, sY, rg, cg, acc);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// B5 / B6 on the CUDA cores (float32; bfloat16 at d % 8 != 0 or d > 128):
// one block per (bh, query tile[, slice]), online softmax over the key tiles
// ---------------------------------------------------------------------------
template <typename T, int D, bool kWithLse, bool kSliced>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Tq, int Tk, int causal,
                     float scale, int hd) {
  constexpr int TD = Dims<D>::kTD;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + Dims<D>::kTileFloats;
  float* sV = sK + Dims<D>::kTileFloats;
  float* sP = sV + Dims<D>::kTileFloats;
  const Slice<kSliced, D> sl(hd, blockIdx.x);
  const int n_qt = (Tq + kTile - 1) / kTile;
  const int item = blockIdx.x / sl.n;
  const long long bh = item / n_qt;
  const int q0 = (item % n_qt) * kTile;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  q += bh * Tq * hd;
  k += bh * Tk * hd;
  v += bh * Tk * hd;
  o += bh * Tq * hd;

  if constexpr (!kSliced) load_tile<T, D>(q, q0, Tq, hd, hd, sQ);
  float m[4], l[4], acc[4][TD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < TD; ++t) acc[i][t] = 0.f;
  }
  const int nk = key_tiles(q0, Tq, Tk, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's P.V is done with sK, sV, sP
    float s[4][4] = {};
    if constexpr (kSliced) {
      sliced_dot<T, D, 4>(q, q0, Tq, k, k0, Tk, hd, sQ, sK, rg, cg, s);
      load_tile<T, D>(v + sl.col0, k0, Tk, hd, sl.width, sV);
      __syncthreads();
    } else {
      load_tile<T, D>(k, k0, Tk, hd, hd, sK);
      load_tile<T, D>(v, k0, Tk, hd, hd, sV);
      __syncthreads();
      tile_dot<D>(sQ, sK, rg, cg, s);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      bool on[4];
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        on[j] = live(qi, k0 + cg + 16 * j, Tq, Tk, causal);
        s[i][j] *= scale;
        if (on[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = on[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(rg * 4 + i) * kLdS + cg + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < TD; ++t) acc[i][t] *= alpha;
    }
    __syncthreads();
    tile_pm<D>(sP, sV, rg, cg, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= Tq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      const int col = out_col<D>(cg, t);
      if (col < sl.width)
        store(o + (long long)qi * hd + sl.col0 + col, acc[i][t] / denom);
    }
    if (kWithLse && cg == 0 && sl.col0 == 0)
      lse[bh * Tq + qi] =
          l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-37f)) : kMasked;
  }
}

// Rows a thread owns in the backward sweeps' own tile (query rows in dq, key
// rows in dk/dv): 4, a 64-row tile, up to capacity 128; 2, a 32-row tile, at
// capacity 256, so the f32 tiles fit a block's shared memory (see dq_smem /
// dkv_smem below). The streamed tile keeps 64 rows.
template <int D>
__host__ __device__ constexpr int bwd_rm() {
  return D <= 128 ? 4 : 2;
}

// ---------------------------------------------------------------------------
// B7: dq sweep, one block per (query tile[, slice], bh), accumulating over
// key tiles
// ---------------------------------------------------------------------------
template <typename T, int D, bool kSliced>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Tq, int Tk, int causal, float scale, int hd) {
  constexpr int TD = Dims<D>::kTD;
  constexpr int RM = bwd_rm<D>();
  constexpr int BM = 16 * RM;               // query rows a block
  constexpr int L = Dims<D>::kLd;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + BM * L;  // dO
  float* sK = sO + BM * L;
  float* sV = sK + Dims<D>::kTileFloats;
  float* sS = sV + Dims<D>::kTileFloats;  // ds
  const Slice<kSliced, D> sl(hd, blockIdx.x);
  const int n_qt = (Tq + BM - 1) / BM;
  const int item = blockIdx.x / sl.n;
  const long long bh = item / n_qt;
  const int q0 = (item % n_qt) * BM;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  q += bh * Tq * hd;
  dout += bh * Tq * hd;
  dq += bh * Tq * hd;
  k += bh * Tk * hd;
  v += bh * Tk * hd;

  if constexpr (!kSliced) {
    load_tile<T, D, BM>(q, q0, Tq, hd, hd, sQ);
    load_tile<T, D, BM>(dout, q0, Tq, hd, hd, sO);
  }
  float lse_r[RM], del_r[RM], acc[RM][TD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + rg * RM + i;
    lse_r[i] = qi < Tq ? lse[bh * Tq + qi] : kMasked;
    del_r[i] = qi < Tq ? delta[bh * Tq + qi] : 0.f;
#pragma unroll
    for (int t = 0; t < TD; ++t) acc[i][t] = 0.f;
  }
  const int nk = key_tiles(q0, Tq, Tk, causal, BM);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    float s[RM][4] = {}, dp[RM][4] = {};
    if constexpr (kSliced) {
      sliced_dot<T, D, RM>(q, q0, Tq, k, k0, Tk, hd, sQ, sK, rg, cg, s);
      sliced_dot<T, D, RM>(dout, q0, Tq, v, k0, Tk, hd, sO, sV, rg, cg, dp);
      load_tile<T, D>(k + sl.col0, k0, Tk, hd, sl.width, sK);
      __syncthreads();
    } else {
      load_tile<T, D>(k, k0, Tk, hd, hd, sK);
      load_tile<T, D>(v, k0, Tk, hd, hd, sV);
      __syncthreads();
      tile_dot<D, RM>(sQ, sK, rg, cg, s);
      tile_dot<D, RM>(sO, sV, rg, cg, dp);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + rg * RM + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live(qi, k0 + cg + 16 * j, Tq, Tk, causal) &&
                                lse_r[i] > kSentinelCut
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.f;
        sS[(rg * RM + i) * kLdS + cg + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    }
    __syncthreads();
    tile_pm<D, RM>(sS, sK, rg, cg, acc);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + rg * RM + i;
    if (qi >= Tq) continue;
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      const int col = out_col<D>(cg, t);
      if (col < sl.width)
        store(dq + (long long)qi * hd + sl.col0 + col, acc[i][t] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// B8: dk/dv sweep, one block per (key tile[, slice], bh), accumulating over
// query tiles. Thread rows are key rows here; its score columns are query
// rows.
// ---------------------------------------------------------------------------
template <typename T, int D, bool kSliced>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int Tq, int Tk, int causal,
                         float scale, int hd) {
  constexpr int TD = Dims<D>::kTD;
  constexpr int RM = bwd_rm<D>();
  constexpr int BM = 16 * RM;               // key rows a block
  constexpr int L = Dims<D>::kLd;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BM * L;
  float* sQ = sV + BM * L;
  float* sO = sQ + Dims<D>::kTileFloats;  // dO
  float* sP = sO + Dims<D>::kTileFloats;  // p, (key row, query row)
  float* sS = sP + BM * kLdS;             // ds, (key row, query row)
  float* sL = sS + BM * kLdS;             // lse of the query tile
  float* sD = sL + kTile;                 // delta of the query tile
  const Slice<kSliced, D> sl(hd, blockIdx.x);
  const int n_kt = (Tk + BM - 1) / BM;
  const int item = blockIdx.x / sl.n;
  const long long bh = item / n_kt;
  const int k0 = (item % n_kt) * BM;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  q += bh * Tq * hd;
  dout += bh * Tq * hd;
  k += bh * Tk * hd;
  v += bh * Tk * hd;
  dk += bh * Tk * hd;
  dv += bh * Tk * hd;

  if constexpr (!kSliced) {
    load_tile<T, D, BM>(k, k0, Tk, hd, hd, sK);
    load_tile<T, D, BM>(v, k0, Tk, hd, hd, sV);
  }
  float dk_acc[RM][TD], dv_acc[RM][TD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      dk_acc[i][t] = 0.f;
      dv_acc[i][t] = 0.f;
    }
  }
  const int nq = (Tq + kTile - 1) / kTile;
  for (int qt = causal ? first_query_tile(k0, Tq, Tk) : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    float s[RM][4] = {}, dp[RM][4] = {};
    if constexpr (kSliced) {
      sliced_dot<T, D, RM>(k, k0, Tk, q, q0, Tq, hd, sK, sQ, rg, cg, s);
      sliced_dot<T, D, RM>(v, k0, Tk, dout, q0, Tq, hd, sV, sO, rg, cg, dp);
      load_tile<T, D>(q + sl.col0, q0, Tq, hd, sl.width, sQ);
      load_tile<T, D>(dout + sl.col0, q0, Tq, hd, sl.width, sO);
    } else {
      load_tile<T, D>(q, q0, Tq, hd, hd, sQ);
      load_tile<T, D>(dout, q0, Tq, hd, hd, sO);
    }
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool in = q0 + r < Tq;
      sL[r] = in ? lse[bh * Tq + q0 + r] : kMasked;
      sD[r] = in ? delta[bh * Tq + q0 + r] : 0.f;
    }
    __syncthreads();
    if constexpr (!kSliced) {
      tile_dot<D, RM>(sK, sQ, rg, cg, s);
      tile_dot<D, RM>(sV, sO, rg, cg, dp);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int kj = k0 + rg * RM + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        const float lq = sL[c];
        const float p = live(q0 + c, kj, Tq, Tk, causal) && lq > kSentinelCut
                            ? expf(s[i][j] * scale - lq)
                            : 0.f;
        sP[(rg * RM + i) * kLdS + c] = p;
        sS[(rg * RM + i) * kLdS + c] = p * (dp[i][j] - sD[c]);
      }
    }
    __syncthreads();
    tile_pm<D, RM>(sP, sO, rg, cg, dv_acc);
    tile_pm<D, RM>(sS, sQ, rg, cg, dk_acc);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kj = k0 + rg * RM + i;
    if (kj >= Tk) continue;
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      const int col = out_col<D>(cg, t);
      if (col >= sl.width) continue;
      const long long at = (long long)kj * hd + sl.col0 + col;
      store(dk + at, dk_acc[i][t] * scale);
      store(dv + at, dv_acc[i][t]);
    }
  }
}

// ---------------------------------------------------------------------------
// B5 / B6 on the tensor cores: bfloat16 or float16, d a multiple of 8 (<= 128)
// ---------------------------------------------------------------------------
// Replaces _flash_forward_kernel / _flash_forward_lse
// (incubator_mxnet_tpu/ops/pallas_attention.py:279, :313) for bfloat16 and
// float16 inputs whose rows are whole 16-byte vectors. Bound: bytes,
// (2 Tq + 2 Tk) d bh x 2 bytes (+ 4 Tq bh for the lse) over 3.35 TB/s, 0.015
// ms at (192, 512, 64); its 12.9 GFLOP (19.3 with the two-term P) need
// 0.013-0.020 ms at the 16-bit peak (the same for both types). The element
// type T is a template argument: it sets the TMA maps' data type, the wgmma
// operand type (.bf16 or .f16), the two-term split of P and the stores;
// nothing else differs. What the design does about it:
//   * a persistent grid, one block of 288 threads per SM (its registers
//     leave room for no second), each walking work items of (head, 128
//     query rows): warps 0-3 and 4-7 are two consumer warpgroups of 64 rows
//     each, warp 8 the producer. A block of T = 512 has only 4 key tiles,
//     so the producer loading the next item's Q (into a second Q buffer)
//     and first tiles under this item's last products is what keeps the
//     tensor cores fed between items.
//   * the producer's lane 0 loads each item's Q once and then K and V tiles
//     of BN key rows into a ring of kTcStages stages by TMA
//     (cp.async.bulk.tensor over a 3-D tensor map (d, T, bh) with 128-byte
//     swizzle, in 64-column boxes), each stage guarded by a full mbarrier
//     (transaction bytes) and an empty one (the 256 consumer threads). A
//     row past T, or a column past d, is outside the map and reads as zero,
//     so a head never reads the next head's rows and the pad adds nothing.
//   * a consumer warpgroup computes S = Q K^T (64 x BN) by wgmma from the
//     swizzled tiles (16-bit operands, f32 accumulators), runs the online
//     softmax on the accumulator registers (row max by two lane shuffles,
//     the row sum kept per thread until the end), and accumulates
//     O += P V by wgmma with P from registers and V from shared memory
//     (transposed operand).
//   * P in bf16 alone would part from the f32 P by up to 2^-9 relative per
//     term, and the bf16 O from the plain version's by rms_rel ~2.4e-3 at
//     (192, 512, 64) (chip_smoke.py phase 6 reads it), over the 5e-4 limit
//     the smoke holds bf16 outputs to; P = P_hi + P_lo, both bf16, issued
//     as two wgmma into the same accumulator, keeps P to about 2^-17 for
//     1.5x the forward's products. float16 misses its own limit (6.25e-5,
//     the bf16 one scaled by the step) by the same factor with one term
//     (an emulation reads rms_rel ~3e-4), so it keeps both; P <= 1 cannot
//     overflow float16, and P_lo, mostly below 2^-14, goes in subnormal.
//   * the two consumer warpgroups take turns issuing S = Q K^T (named
//     barriers), so one's softmax overlaps the other's products.
//   * BN = 128 key rows at D = 64, 64 at D = 128, so S, O and the two P
//     terms fit the 168 registers ptxas gives a thread of a 288-thread
//     block that issues wgmma.
// The 128-row block and the causal skip of key tiles wholly above the
// diagonal follow the CUDA-core forward; the function is the same.
constexpr int kTcThreads = 288;   // 2 consumer warpgroups + 1 producer warp
constexpr int kTcRows = 128;      // query rows a work item
constexpr int kTcStages = 3;      // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Tc {
  static constexpr int kBN = D <= 64 ? 128 : 64;      // key rows a tile
  static constexpr int kAtoms = D / 64;               // 64-column boxes
  static constexpr int kQBytes = 2 * kAtoms * 64 * 128;   // both warpgroups
  static constexpr int kTileBytes = kAtoms * kBN * 128;   // K or V, a stage
  // two Q buffers (the next item's Q loads under this item's tiles), the
  // K and V ring, then the barriers: q_full[2], q_empty[2], full[stages],
  // empty[stages]
  static constexpr int kBarOff = 2 * kQBytes + 2 * kTcStages * kTileBytes;
  static constexpr int kSmem = 1024 + kBarOff + 8 * (4 + 2 * kTcStages);
};

// Accumulator fragment of a 64 x N wgmma in a consumer thread (warp w of
// its warpgroup, lane = 4 g + t): register 4 j + e holds row
// 16 w + g + 8 (e / 2), column 8 j + 2 t + (e % 2).
template <typename T, int D, bool kWithLse>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           T* __restrict__ o,
                           float* __restrict__ lse, int n_heads, int Tq,
                           int Tk, int causal, float scale_log2, int hd) {
  using C = Tc<D>;
  constexpr int BN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                          // Q buffer b: + b kQBytes
  const uint32_t sK = sQ + 2 * C::kQBytes;
  const uint32_t sV = sK + kTcStages * C::kTileBytes;
  const uint32_t q_full0 = base + C::kBarOff;        // q_full[b] = + 8 b
  const uint32_t q_empty0 = q_full0 + 16;
  const uint32_t full0 = q_empty0 + 16;              // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kTcStages;     // empty[s]

  // work item i = (head i % n_heads, 128-row query tile n_qt - 1 - i /
  // n_heads): the last query tiles, which a causal mask gives the most key
  // tiles, come first, so each round of the blocks' walk (items blockIdx.x,
  // + gridDim.x, ...) takes items of one size and the light ones fill the
  // last, partial round
  const int n_qt = (Tq + kTcRows - 1) / kTcRows;
  const int n_items = n_heads * n_qt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full0 + 8 * b, 1);
      mbar_init(q_empty0 + 8 * b, 256);
    }
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // producer: each item's Q into the free Q buffer, then its K/V tiles
    // through the ring; the ring's stage and phase run on across items
    if (lane == 0) {
      int st = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x, it = 0; item < n_items;
           item += gridDim.x, ++it) {
        const int bh = item % n_heads;
        const int q0 = (n_qt - 1 - item / n_heads) * kTcRows;
        const int nk = key_tiles(q0, Tq, Tk, causal, kTcRows, BN);
        const int qb = it & 1;
        mbar_wait(q_empty0 + 8 * qb, ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full0 + 8 * qb, C::kQBytes);
        for (int w = 0; w < 2; ++w)
          for (int a = 0; a < C::kAtoms; ++a)
            tma_load(sQ + qb * C::kQBytes + (w * C::kAtoms + a) * 8192,
                     &tm_q, q_full0 + 8 * qb, a * 64, q0 + 64 * w, bh);
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty0 + 8 * st, phase ^ 1);
          const uint32_t bar = full0 + 8 * st;
          mbar_expect_tx(bar, 2 * C::kTileBytes);
          for (int a = 0; a < C::kAtoms; ++a) {
            const uint32_t off = st * C::kTileBytes + a * BN * 128;
            tma_load(sK + off, &tm_k, bar, a * 64, kt * BN, bh);
            tma_load(sV + off, &tm_v, bar, a * 64, kt * BN, bh);
          }
          if (++st == kTcStages) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers. The two warpgroups take turns issuing S = Q K^T (named
  // barriers 1 and 2), so one's softmax runs while the other's products
  // hold the tensor cores: warpgroup 1 lets warpgroup 0 go first, and
  // warpgroup 0 takes warpgroup 1's last turn signal at the end, so both
  // barriers end balanced.
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  if (wg == 1) named_arrive(1);
  int st = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x, it = 0; item < n_items;
       item += gridDim.x, ++it) {
    const int bh = item % n_heads;
    const int q0 = (n_qt - 1 - item / n_heads) * kTcRows;
    const int nk = key_tiles(q0, Tq, Tk, causal, kTcRows, BN);
    const int qb = it & 1;
    const int row0 = q0 + 64 * wg + 16 * (warp % 4) + g;  // and row0 + 8
    const int wg_first = q0 + 64 * wg;
    const uint32_t sQw = sQ + qb * C::kQBytes + wg * C::kAtoms * 8192;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};  // m in log2 units
    mbar_wait(q_full0 + 8 * qb, (it >> 1) & 1);
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * BN;
      mbar_wait(full0 + 8 * st, phase);
      const uint32_t sKs = sK + st * C::kTileBytes;
      const uint32_t sVs = sV + st * C::kTileBytes;
      float s[BN / 2];
      named_sync(1 + wg);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns: 32 bytes
        wgmma_ss<BN, T>(s, sw128_desc(sQw + (kk / 4) * 8192 + off, 16),
                        sw128_desc(sKs + (kk / 4) * BN * 128 + off, 16),
                        kk > 0);
      }
      wg_commit();
      named_arrive(2 - wg);
      wg_wait0();
      pin<BN / 2>(s);

      // online softmax on the fragment: masked scores to -inf (exp2 gives
      // 0), the row max of the raw scores over the 4 lanes of a row, then
      // p = exp2(s * scale * log2(e) - m) with m in log2 units
      const bool masked = k0 + BN > Tk ||
                          (causal && k0 + BN - 1 > wg_first + (Tk - Tq));
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        if (masked) {
          const int kj = k0 + 8 * (i / 4) + 2 * t + (i % 2);
          const int qi = row0 + 8 * ((i % 4) / 2);
          if (!(kj < Tk && (!causal || kj <= qi + (Tk - Tq))))
            s[i] = -INFINITY;
        }
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kb + 2 * r;  // rows: r even row0, odd row0 + 8
          const float a = exp2f(fmaf(s[i], scale_log2, -m[r % 2]));
          const float b = exp2f(fmaf(s[i + 1], scale_log2, -m[r % 2]));
          l[r % 2] += a + b;
          Elem16<T>::split(a, b, &p_hi[kb][r], &p_lo[kb][r]);
        }
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i % 4) / 2];
      pin<D / 2>(acc);
      wg_fence();
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb)
        wgmma_rs<D, T>(acc, p_hi[kb],
                       sw128_desc(sVs + kb * 2048, BN * 128));
#pragma unroll
      for (int kb = 0; kb < BN / 16; ++kb)
        wgmma_rs<D, T>(acc, p_lo[kb],
                       sw128_desc(sVs + kb * 2048, BN * 128));
      wg_commit();
      wg_wait0();
      pin<D / 2>(acc);
      mbar_arrive(empty0 + 8 * st);
      if (++st == kTcStages) {
        st = 0;
        phase ^= 1;
      }
    }
    mbar_arrive(q_empty0 + 8 * qb);   // this item's S products are done

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const long long head = (long long)bh * Tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      if (qi >= Tq) continue;
      const float den = l[r] == 0.f ? 1.f : l[r];
      T* orow = o + (head + qi) * hd;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < hd)
          Elem16<T>::store2(orow + col, acc[4 * j + 2 * r] / den,
                            acc[4 * j + 2 * r + 1] / den);
      }
      if (kWithLse && t == 0)
        lse[head + qi] = l[r] > 0.f
                             ? m[r] * kLn2 + logf(fmaxf(l[r], 1e-37f))
                             : kMasked;
    }
  }
  if (wg == 0) named_sync(1);
}

// ---------------------------------------------------------------------------
// B7 / B8 on the tensor cores: bfloat16 or float16, d a multiple of 8 (<= 128)
// ---------------------------------------------------------------------------
// flash_bwd_dq_wgmma_kernel replaces _bwd_dq_kernel (the dq sweep of
// _flash_backward, incubator_mxnet_tpu/ops/pallas_attention.py:107, its
// pallas_call :366), flash_bwd_dkv_wgmma_kernel _bwd_dkv_kernel (:162, its
// pallas_call :385), for 16-bit inputs (T: __nv_bfloat16 or __half, the
// forward's Elem16<T> and wgmma_ss/rs<N, T>) whose rows are whole 16-byte
// vectors. Bound: operations. The dq sweep does 3 products of 2 d
// operations a live pair (S = Q K^T, dP = dO V^T, dQ = dS K) and the dk/dv
// sweep 4 (S^T, dP^T, dV = P^T dO, dK = dS^T Q): 19.3 and 25.8 GFLOP at
// (192, 512, 64), 0.0195 and 0.0261 ms at the bf16 peak, over their bytes
// (15.8 and 18.0 MB, ~0.005 ms). What the design does about it: every
// product is a wgmma with f32 accumulators, the tiles the forward's machinery
// brings (TMA over 3-D tensor maps (d, T, bh), 128-byte swizzle, an mbarrier
// ring, a persistent grid walking 128-row work items heaviest first), and
// nothing of the (128 x T) P or dS blocks leaves the chip:
//   * dq: a work item is (head, 128 query rows), two consumer warpgroups of
//     64 rows each. Q and dO stay resident (two buffers: the next item's
//     load under this item's products); K and V stream through the ring in
//     64-row tiles. Per tile S = Q K^T and dP = dO V^T (K-major operands),
//     P = exp2(S scale log2(e) - lse log2(e)) and dS = P (dP - delta) on the
//     accumulator registers, then dQ += dS K with dS as the register
//     A-fragment and K through the transposed (N-major) descriptor, as V is
//     in the forward's P V.
//   * dk/dv: a work item is (head, 128 key rows). K and V stay resident; Q,
//     dO and the rows' lse and delta stream in 64-row tiles (the producer
//     warp writes lse log2(e), +inf on rows past Tq and on the -1e30
//     sentinel, and delta into the stage beside the TMA tiles). Per tile
//     S^T = K Q^T and dP^T = V dO^T, P^T and dS^T on the registers, then
//     dV += P^T dO and dK += dS^T Q with dO and Q through the transposed
//     descriptor. Under causal a key item starts at first_query_tile.
//   * P and dS go into their products as two terms of T (x = x_hi + x_lo,
//     two wgmma into one accumulator), as P does in the forward: in bf16
//     one term reads rms_rel ~2.6e-3 on dq, dk and dv at (192, 512, 64),
//     over the 5e-4 limit chip_smoke.py holds bf16 outputs to, two terms
//     ~9e-5 (emulated; phase 6 records the reading on the card). The split
//     costs 4/3 the dq sweep's products and 6/4 the dk/dv sweep's.
//   * float16 has bf16's step / 8 but not its range: a term below 2^-14
//     loses bits in the subnormals. The backward's P is normalised (about
//     1 / Tk), and dS scales with dO (tiny without loss scaling, large with
//     it), so two plain terms read rms_rel up to 7.9e-4 on dq and dk at dO
//     ~ 2^-10 (emulated), 12x the float16 limit 6.25e-5. Only float16's
//     instances (if constexpr) shift P by 2^15 into dV's product and scale
//     dS by a running power of two per output row (ds_rescale below), all
//     exact, which reads 1.1e-5 to 1.7e-5 at every dO from 2^-10 to 2^12
//     (ops/attention.py :: flash_bwd_split_ref emulates it; phase 6 holds
//     the card to the limits at 2^-10, 1 and 2^12).
//   * the tensor cores round each addition into the f32 accumulator toward
//     zero at the accumulator's precision, and under causal a key row's
//     terms fall with the query's distance (p ~ 1 / (q + 1)): summed first
//     to last, the small tail is cut at the large head's precision. The
//     float16 dk/dv sweep takes a key item's query tiles last to first,
//     which keeps dv to rms_rel 2.7e-5 where first to last reads 8.2e-5 at
//     T 2048, d 128 (a model of that rounding,
//     tests/test_torch_flash_f16_backward.py); the card read dk and dv at
//     7.1e-5 and 7.4e-5 first to last, 3.5e-5 and 3.1e-5 last to first
//     (phase 6, causal (48, 2048, 128)), against float16's 6.25e-5. bf16's
//     order is unchanged (its limit is 8x wider).
//   * registers: dK and dV at d = 128 are 128 f32 accumulators a thread,
//     and S^T, dP^T 64 more, over the 168 ptxas gives a thread of a block
//     of three warpgroups. The producer warpgroup gives its registers to the
//     consumers (setmaxnreg: 24 and 240, which the block's 384 x 168 cover
//     exactly); the launch refuses a build whose register count would leave
//     the raise unmet instead of waiting on it forever.
//   * the two consumer warpgroups take turns issuing S and dP (named
//     barriers), so one's exponentials overlap the other's products.
constexpr int kBwThreads = 384;    // 2 consumer warpgroups + a producer one
constexpr int kBwRows = 128;       // rows of a work item (2 x 64)
constexpr int kBwTile = 64;        // streamed rows a stage
constexpr int kBwStages = 3;       // ring depth
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct Bw {
  static constexpr int kAtoms = D / 64;              // 64-column boxes
  static constexpr int kHalf = kAtoms * 8192;        // 64 rows of one operand
  static constexpr int kOperand = 2 * kHalf;         // 128 rows (both groups)
  static constexpr int kItem = 2 * kOperand;         // the resident pair
  static constexpr int kTile = kHalf;                // a streamed operand
  // two buffers of the resident pair (Q, dO or K, V), the ring of the
  // streamed pair (K, V or Q, dO: first operand's stages, then the
  // second's), each stage's lse and delta rows (dk/dv), then the barriers:
  // res_full[2], res_empty[2], full[stages], empty[stages]
  static constexpr int kRing = 2 * kItem;
  static constexpr int kStats = kRing + 2 * kBwStages * kTile;
  static constexpr int kBarOff = kStats + kBwStages * 2 * kBwTile * 4;
  static constexpr int kSmem = 1024 + kBarOff + 8 * (4 + 2 * kBwStages);
};
static_assert(Bw<128>::kSmem <= 232448, "the backward's tiles fit");

// the backward's barriers: res_full[b] (count res_count), res_empty[b] (the
// 256 consumer threads), full[s] (count full_count), empty[s] (256)
__device__ __forceinline__ void bw_init(uint32_t bars, int full_count) {
  for (int b = 0; b < 2; ++b) {
    mbar_init(bars + 8 * b, 1);
    mbar_init(bars + 16 + 8 * b, 256);
  }
  for (int st = 0; st < kBwStages; ++st) {
    mbar_init(bars + 32 + 8 * st, full_count);
    mbar_init(bars + 32 + 8 * kBwStages + 8 * st, 256);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// S (64 x 64) = A . B^T over D for one warpgroup: A 64 rows at a (K-major,
// atoms 8192 bytes apart), B 64 rows at b (the same)
template <typename T, int D>
__device__ __forceinline__ void bw_scores(float* s, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
    wgmma_ss<64, T>(s, sw128_desc(a + off, 16), sw128_desc(b + off, 16),
                    kk > 0);
  }
}

// acc (64 x D) += X (64 x 64, two terms of T in registers) . M (64 rows x
// D at m, through the transposed descriptor)
template <typename T, int D>
__device__ __forceinline__ void bw_product(float* acc, uint32_t (*hi)[4],
                                           uint32_t (*lo)[4], uint32_t m) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
    wgmma_rs<D, T>(acc, hi[kb], sw128_desc(m + kb * 2048, kBwTile * 128));
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
    wgmma_rs<D, T>(acc, lo[kb], sw128_desc(m + kb * 2048, kBwTile * 128));
}

// float16's operand ranges (ops/attention.py :: flash_bwd_split_ref
// emulates them). P enters dV's product as P 2^15 (P <= 1 < 65504 / 2^15)
// and dV's accumulator is scaled by 2^-15 at the store. dS = P (dP - delta)
// has no fixed range (it scales with dO), so each output row (its quad of
// lanes) keeps a power-of-two exponent e, as the forward keeps its running
// max: after each tile e = min(e, 14 - floor(log2 max |dS|)), which puts
// the row's largest |dS| so far in [2^14, 2^15); the row's accumulator is
// scaled by 2^(e_new - e_old) before the tile's product and by 2^-e at the
// store, all exact. A tile of zeros (or subnormals) keeps e; e starts at,
// and is clamped to, +-56 (float16 inputs bound |dS| by about 2^40).
constexpr float kPShift = 32768.f;           // 2^15
constexpr float kPUnshift = 1.f / 32768.f;
constexpr int kDsTop = 14;
constexpr int kDsExp = 56;

__device__ __forceinline__ float pow2(int e) {  // e in [-126, 127]
  return __int_as_float((127 + e) << 23);
}

// the row's exponent after a tile whose largest |dS| in this lane is mx
__device__ __forceinline__ int ds_exponent(float mx, int e) {
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const int top = ((__float_as_int(mx) >> 23) & 0xff) - 127;  // -127 at 0
  return min(e, max(kDsTop - top, -kDsExp));
}

// scales acc's two rows (fragment register i: row (i % 4) / 2) by
// 2^(e_new - e_old), moves e to e_new and sets up[r] = 2^e_new[r], the
// factor row r's dS takes before its split
template <int N>
__device__ __forceinline__ void ds_rescale(float* acc, int* e,
                                           const float* mx, float* up) {
  float down[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e_new = ds_exponent(mx[r], e[r]);
    down[r] = pow2(e_new - e[r]);
    up[r] = pow2(e_new);
    e[r] = e_new;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= down[(i % 4) / 2];
}

// lse in log2 units for the exponentials: +inf on a row past Tq or on the
// -1e30 sentinel of a row with no live key, so its p is exp2(-inf) = 0
__device__ __forceinline__ float lse_log2(const float* lse, long long at,
                                          bool in) {
  if (!in) return INFINITY;
  const float l = lse[at];
  return l > kSentinelCut ? l * kLog2e : INFINITY;
}

// Accumulator fragment of a 64 x N wgmma in a consumer thread (warp w of its
// warpgroup, lane = 4 g + t): register 4 j + e holds row 16 w + g + 8 (e /
// 2), column 8 j + 2 t + (e % 2), as in the forward.
template <typename T, int D>
__global__ void __launch_bounds__(kBwThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dq, int n_heads,
                              int Tq, int Tk, int causal, float scale_log2,
                              float scale, int hd) {
  using C = Bw<D>;
  constexpr bool kF16 = std::is_same<T, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + C::kBarOff;
  const uint32_t res_full0 = bars, res_empty0 = bars + 16;
  const uint32_t full0 = bars + 32, empty0 = full0 + 8 * kBwStages;
  const uint32_t ringK = base + C::kRing;
  const uint32_t ringV = ringK + kBwStages * C::kTile;

  // work item i = (head i % n_heads, 128-row query tile n_qt - 1 - i /
  // n_heads): under causal the last query tiles see the most key tiles
  const int n_qt = (Tq + kBwRows - 1) / kBwRows;
  const int n_items = n_heads * n_qt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) bw_init(bars, 1);
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: its lane 0 of warp 8 loads each item's Q and dO
    // into the free resident buffer, then the K/V tiles through the ring
    regs_dec<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      int st = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x, it = 0; item < n_items;
           item += gridDim.x, ++it) {
        const int bh = item % n_heads;
        const int q0 = (n_qt - 1 - item / n_heads) * kBwRows;
        const int nk = key_tiles(q0, Tq, Tk, causal, kBwRows, kBwTile);
        const int b = it & 1;
        mbar_wait(res_empty0 + 8 * b, ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(res_full0 + 8 * b, C::kItem);
        for (int w = 0; w < 2; ++w)
          for (int a = 0; a < C::kAtoms; ++a) {
            const uint32_t dst = base + b * C::kItem + w * C::kHalf + a * 8192;
            tma_load(dst, &tm_q, res_full0 + 8 * b, a * 64, q0 + 64 * w, bh);
            tma_load(dst + C::kOperand, &tm_do, res_full0 + 8 * b, a * 64,
                     q0 + 64 * w, bh);
          }
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty0 + 8 * st, phase ^ 1);
          const uint32_t bar = full0 + 8 * st;
          mbar_expect_tx(bar, 2 * C::kTile);
          for (int a = 0; a < C::kAtoms; ++a) {
            const uint32_t off = st * C::kTile + a * 8192;
            tma_load(ringK + off, &tm_k, bar, a * 64, kt * kBwTile, bh);
            tma_load(ringV + off, &tm_v, bar, a * 64, kt * kBwTile, bh);
          }
          if (++st == kBwStages) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const int g = lane / 4, t = lane % 4;
    if (wg == 1) named_arrive(1);
    int st = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x, it = 0; item < n_items;
         item += gridDim.x, ++it) {
      const int bh = item % n_heads;
      const int q0 = (n_qt - 1 - item / n_heads) * kBwRows;
      const int nk = key_tiles(q0, Tq, Tk, causal, kBwRows, kBwTile);
      const int b = it & 1;
      const int wg_first = q0 + 64 * wg;
      const int row0 = wg_first + 16 * (warp % 4) + g;  // and row0 + 8
      const long long head = (long long)bh * Tq;
      float l2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = row0 + 8 * r;
        l2[r] = lse_log2(lse, head + qi, qi < Tq);
        dl[r] = qi < Tq ? delta[head + qi] : 0.f;
      }
      const uint32_t sQw = base + b * C::kItem + wg * C::kHalf;
      const uint32_t sOw = sQw + C::kOperand;
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      int ex[2] = {kDsExp, kDsExp};  // float16: the rows' dS exponents
      mbar_wait(res_full0 + 8 * b, (it >> 1) & 1);
      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * kBwTile;
        mbar_wait(full0 + 8 * st, phase);
        const uint32_t sKs = ringK + st * C::kTile;
        const uint32_t sVs = ringV + st * C::kTile;
        float s[32], dp[32];
        named_sync(1 + wg);
        wg_fence();
        bw_scores<T, D>(s, sQw, sKs);
        bw_scores<T, D>(dp, sOw, sVs);
        wg_commit();
        named_arrive(2 - wg);
        wg_wait0();
        pin<32>(s);
        pin<32>(dp);

        const bool masked = k0 + kBwTile > Tk ||
                            (causal && k0 + kBwTile - 1 >
                                           wg_first + (Tk - Tq));
        // dS = P (dP - delta) into dp, and its row maxima (float16)
        float mx[2] = {0.f, 0.f};
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 8 * kb + 2 * r;  // rows: r even row0, odd row0 + 8
            const int h = r % 2;
            float x = exp2f(fmaf(s[i], scale_log2, -l2[h]));
            float y = exp2f(fmaf(s[i + 1], scale_log2, -l2[h]));
            if (masked) {
              const int kj = k0 + 16 * kb + 8 * (r / 2) + 2 * t;
              const int qi = row0 + 8 * h;
              if (!live(qi, kj, Tq, Tk, causal)) x = 0.f;
              if (!live(qi, kj + 1, Tq, Tk, causal)) y = 0.f;
            }
            dp[i] = x * (dp[i] - dl[h]);
            dp[i + 1] = y * (dp[i + 1] - dl[h]);
            if constexpr (kF16)
              mx[h] = fmaxf(mx[h], fmaxf(fabsf(dp[i]), fabsf(dp[i + 1])));
          }
        }
        float up[2] = {1.f, 1.f};
        if constexpr (kF16) {
          ds_rescale<D / 2>(acc, ex, mx, up);
          pin<D / 2>(acc);
        }
        uint32_t d_hi[4][4], d_lo[4][4];
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 8 * kb + 2 * r;
            Elem16<T>::split(dp[i] * up[r % 2], dp[i + 1] * up[r % 2],
                             &d_hi[kb][r], &d_lo[kb][r]);
          }
        }
        wg_fence();
        bw_product<T, D>(acc, d_hi, d_lo, sKs);
        wg_commit();
        wg_wait0();
        pin<D / 2>(acc);
        mbar_arrive(empty0 + 8 * st);
        if (++st == kBwStages) {
          st = 0;
          phase ^= 1;
        }
      }
      mbar_arrive(res_empty0 + 8 * b);  // this item's S and dP are done

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = row0 + 8 * r;
        if (qi >= Tq) continue;
        const float f = kF16 ? scale * pow2(-ex[r]) : scale;
        T* orow = dq + (head + qi) * hd;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int col = 8 * j + 2 * t;
          if (col < hd)
            Elem16<T>::store2(orow + col, acc[4 * j + 2 * r] * f,
                              acc[4 * j + 2 * r + 1] * f);
        }
      }
    }
    if (wg == 0) named_sync(1);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv,
                               int n_heads, int Tq, int Tk, int causal,
                               float scale_log2, float scale, int hd) {
  using C = Bw<D>;
  constexpr bool kF16 = std::is_same<T, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_p = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + C::kBarOff;
  const uint32_t res_full0 = bars, res_empty0 = bars + 16;
  const uint32_t full0 = bars + 32, empty0 = full0 + 8 * kBwStages;
  const uint32_t ringQ = base + C::kRing;
  const uint32_t ringO = ringQ + kBwStages * C::kTile;
  // stage s: lse log2(e) of its 64 query rows, then their delta
  float* const stats = reinterpret_cast<float*>(base_p + C::kStats);

  // work item i = (head i % n_heads, 128-row key tile i / n_heads): under
  // causal the first key tiles are seen by the most query tiles
  const int n_kt = (Tk + kBwRows - 1) / kBwRows;
  const int n_items = n_heads * n_kt;
  const int nq = (Tq + kBwTile - 1) / kBwTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) bw_init(bars, 32);
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: warp 8 loads each item's K and V into the free
    // resident buffer (lane 0), then for each query tile its 64 rows' lse
    // and delta (every lane, two rows each) and its Q and dO tiles (lane 0)
    // into a ring stage; the stage's full barrier takes one arrival a lane
    regs_dec<kProducerRegs>();
    if (warp == 8) {
      int st = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x, it = 0; item < n_items;
           item += gridDim.x, ++it) {
        const int bh = item % n_heads;
        const int k0 = (item / n_heads) * kBwRows;
        const int b = it & 1;
        if (lane == 0) {
          mbar_wait(res_empty0 + 8 * b, ((it >> 1) & 1) ^ 1);
          mbar_expect_tx(res_full0 + 8 * b, C::kItem);
          for (int w = 0; w < 2; ++w)
            for (int a = 0; a < C::kAtoms; ++a) {
              const uint32_t dst =
                  base + b * C::kItem + w * C::kHalf + a * 8192;
              tma_load(dst, &tm_k, res_full0 + 8 * b, a * 64, k0 + 64 * w,
                       bh);
              tma_load(dst + C::kOperand, &tm_v, res_full0 + 8 * b, a * 64,
                       k0 + 64 * w, bh);
            }
        }
        const long long head = (long long)bh * Tq;
        // the live query tiles qt0 .. nq - 1, in float16 last to first
        const int qt0 = causal ? first_query_tile(k0, Tq, Tk) : 0;
        for (int qt = kF16 ? nq - 1 : qt0; kF16 ? qt >= qt0 : qt < nq;
             qt += kF16 ? -1 : 1) {
          const int q0 = qt * kBwTile;
          mbar_wait(empty0 + 8 * st, phase ^ 1);
          float* sl = stats + st * 2 * kBwTile;
          for (int r = lane; r < kBwTile; r += 32) {
            const int qi = q0 + r;
            sl[r] = lse_log2(lse, head + qi, qi < Tq);
            sl[kBwTile + r] = qi < Tq ? delta[head + qi] : 0.f;
          }
          const uint32_t bar = full0 + 8 * st;
          if (lane == 0) {
            mbar_expect_tx(bar, 2 * C::kTile);
            for (int a = 0; a < C::kAtoms; ++a) {
              const uint32_t off = st * C::kTile + a * 8192;
              tma_load(ringQ + off, &tm_q, bar, a * 64, q0, bh);
              tma_load(ringO + off, &tm_do, bar, a * 64, q0, bh);
            }
          } else {
            mbar_arrive(bar);
          }
          if (++st == kBwStages) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const int g = lane / 4, t = lane % 4;
    if (wg == 1) named_arrive(1);
    int st = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x, it = 0; item < n_items;
         item += gridDim.x, ++it) {
      const int bh = item % n_heads;
      const int k0 = (item / n_heads) * kBwRows;
      const int b = it & 1;
      const int wg_first = k0 + 64 * wg;
      const int row0 = wg_first + 16 * (warp % 4) + g;  // and row0 + 8
      const uint32_t sKw = base + b * C::kItem + wg * C::kHalf;
      const uint32_t sVw = sKw + C::kOperand;
      float dka[D / 2], dva[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        dka[i] = 0.f;
        dva[i] = 0.f;
      }
      int ex[2] = {kDsExp, kDsExp};  // float16: the key rows' dS exponents
      mbar_wait(res_full0 + 8 * b, (it >> 1) & 1);
      // the producer's order (float16: last to first)
      const int qt0 = causal ? first_query_tile(k0, Tq, Tk) : 0;
      for (int qt = kF16 ? nq - 1 : qt0; kF16 ? qt >= qt0 : qt < nq;
           qt += kF16 ? -1 : 1) {
        const int q0 = qt * kBwTile;
        mbar_wait(full0 + 8 * st, phase);
        const uint32_t sQs = ringQ + st * C::kTile;
        const uint32_t sOs = ringO + st * C::kTile;
        const float* sl = stats + st * 2 * kBwTile;
        float s[32], dp[32];
        named_sync(1 + wg);
        wg_fence();
        bw_scores<T, D>(s, sKw, sQs);   // S^T: key rows x query columns
        bw_scores<T, D>(dp, sVw, sOs);  // dP^T
        wg_commit();
        named_arrive(2 - wg);
        wg_wait0();
        pin<32>(s);
        pin<32>(dp);

        const bool masked = wg_first + 64 > Tk ||
                            (causal && wg_first + 63 > q0 + (Tk - Tq));
        // P^T split (float16: shifted by 2^15), dS^T into dp, and its row
        // maxima (float16)
        uint32_t p_hi[4][4], p_lo[4][4], d_hi[4][4], d_lo[4][4];
        float mx[2] = {0.f, 0.f};
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 8 * kb + 2 * r;  // rows: r even row0, odd row0 + 8
            const int c = 16 * kb + 8 * (r / 2) + 2 * t;  // query column
            const float2 l2 = *reinterpret_cast<const float2*>(sl + c);
            const float2 dl =
                *reinterpret_cast<const float2*>(sl + kBwTile + c);
            float x = exp2f(fmaf(s[i], scale_log2, -l2.x));
            float y = exp2f(fmaf(s[i + 1], scale_log2, -l2.y));
            if (masked) {
              const int kj = row0 + 8 * (r % 2);
              if (!live(q0 + c, kj, Tq, Tk, causal)) x = 0.f;
              if (!live(q0 + c + 1, kj, Tq, Tk, causal)) y = 0.f;
            }
            const float shift = kF16 ? kPShift : 1.f;
            Elem16<T>::split(x * shift, y * shift, &p_hi[kb][r],
                             &p_lo[kb][r]);
            dp[i] = x * (dp[i] - dl.x);
            dp[i + 1] = y * (dp[i + 1] - dl.y);
            if constexpr (kF16)
              mx[r % 2] = fmaxf(mx[r % 2],
                                fmaxf(fabsf(dp[i]), fabsf(dp[i + 1])));
          }
        }
        float up[2] = {1.f, 1.f};
        if constexpr (kF16) {
          ds_rescale<D / 2>(dka, ex, mx, up);
          pin<D / 2>(dka);
        }
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 8 * kb + 2 * r;
            Elem16<T>::split(dp[i] * up[r % 2], dp[i + 1] * up[r % 2],
                             &d_hi[kb][r], &d_lo[kb][r]);
          }
        }
        wg_fence();
        bw_product<T, D>(dva, p_hi, p_lo, sOs);
        bw_product<T, D>(dka, d_hi, d_lo, sQs);
        wg_commit();
        wg_wait0();
        pin<D / 2>(dva);
        pin<D / 2>(dka);
        mbar_arrive(empty0 + 8 * st);
        if (++st == kBwStages) {
          st = 0;
          phase ^= 1;
        }
      }
      mbar_arrive(res_empty0 + 8 * b);  // this item's S^T and dP^T are done

      const long long head = (long long)bh * Tk;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kj = row0 + 8 * r;
        if (kj >= Tk) continue;
        const float fk = kF16 ? scale * pow2(-ex[r]) : scale;
        T* krow = dk + (head + kj) * hd;
        T* vrow = dv + (head + kj) * hd;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int col = 8 * j + 2 * t;
          if (col >= hd) continue;
          Elem16<T>::store2(krow + col, dka[4 * j + 2 * r] * fk,
                            dka[4 * j + 2 * r + 1] * fk);
          if constexpr (kF16)
            Elem16<T>::store2(vrow + col, dva[4 * j + 2 * r] * kPUnshift,
                              dva[4 * j + 2 * r + 1] * kPUnshift);
          else
            Elem16<T>::store2(vrow + col, dva[4 * j + 2 * r],
                              dva[4 * j + 2 * r + 1]);
        }
      }
    }
    if (wg == 0) named_sync(1);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// Shared memory of the CUDA-core kernels, f32 tiles padded to D + 4. At
// capacity 256 (rows of 260 floats) the forward's 64-row tiles take 217,088
// bytes; 64-row backward tiles would take 283,648 (dq) and 301,568 (dk/dv),
// over the 232,448 a block can use, so the sweeps' own tile there is 32 rows
// (bwd_rm): 208,384 bytes for dq, 217,600 for dk/dv.
template <int D>
constexpr int fwd_smem() {
  return (3 * Dims<D>::kTileFloats + kTile * kLdS) * 4;
}
template <int D>
constexpr int dq_smem() {
  constexpr int BM = 16 * bwd_rm<D>();
  return ((2 * BM + 2 * kTile) * Dims<D>::kLd + BM * kLdS) * 4;
}
template <int D>
constexpr int dkv_smem() {
  constexpr int BM = 16 * bwd_rm<D>();
  return ((2 * BM + 2 * kTile) * Dims<D>::kLd + 2 * BM * kLdS + 2 * kTile) *
         4;
}
static_assert(fwd_smem<256>() == 217088 && dq_smem<256>() == 208384 &&
                  dkv_smem<256>() == 217600 && dkv_smem<128>() <= 232448,
              "the capacity-256 tiles fit a block's shared memory");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* o;     // o, dq or dk
  void* o2;    // dv
  float* lse;  // the forward's lse output
  int bh, tq, tk, causal, hd;
  float scale;
  cudaStream_t st;
};

template <typename K>
cudaError_t prepare(K kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// one block per (head, row tile[, slice]), head-major along grid x, the
// slice fastest (d > 256: ceil(d / 128) slices)
bool grid_1d(int bh, int rows, int tile, int hd, bool sliced, dim3* grid) {
  const long long n = (long long)bh * ((rows + tile - 1) / tile) *
                      (sliced ? (hd + 127) / 128 : 1);
  if (n <= 0 || n > 2147483647LL) return false;
  *grid = dim3((unsigned)n);
  return true;
}

template <typename T, int D, bool L, bool S>
cudaError_t run_fwd(const Args& a) {
  auto kern = flash_fwd_kernel<T, D, L, S>;
  constexpr int smem = fwd_smem<D>();
  dim3 grid;
  if (!grid_1d(a.bh, a.tq, kTile, a.hd, S, &grid))
    return cudaErrorInvalidValue;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.tq, a.tk,
      a.causal, a.scale, a.hd);
  return cudaGetLastError();
}

template <typename T, int D, bool S>
cudaError_t run_dq(const Args& a) {
  auto kern = flash_bwd_dq_kernel<T, D, S>;
  constexpr int smem = dq_smem<D>();
  dim3 grid;
  if (!grid_1d(a.bh, a.tq, 16 * bwd_rm<D>(), a.hd, S, &grid))
    return cudaErrorInvalidValue;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, static_cast<T*>(a.o), a.tq, a.tk, a.causal, a.scale, a.hd);
  return cudaGetLastError();
}

template <typename T, int D, bool S>
cudaError_t run_dkv(const Args& a) {
  auto kern = flash_bwd_dkv_kernel<T, D, S>;
  constexpr int smem = dkv_smem<D>();
  dim3 grid;
  if (!grid_1d(a.bh, a.tk, 16 * bwd_rm<D>(), a.hd, S, &grid))
    return cudaErrorInvalidValue;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, static_cast<T*>(a.o), static_cast<T*>(a.o2), a.tq, a.tk,
      a.causal, a.scale, a.hd);
  return cudaGetLastError();
}

// which: 0 forward, 1 forward + lse, 2 dq sweep, 3 dk/dv sweep; S: the
// 128-column slices of a head dim past 256
template <typename T, int D, bool S = false>
cudaError_t run(int which, const Args& a) {
  switch (which) {
    case 0: return run_fwd<T, D, false, S>(a);
    case 1: return run_fwd<T, D, true, S>(a);
    case 2: return run_dq<T, D, S>(a);
    case 3: return run_dkv<T, D, S>(a);
  }
  return cudaErrorInvalidValue;
}

// the capacity instance that holds head dim hd, or capacity 128's slices
template <typename T>
cudaError_t run_dim(int which, const Args& a) {
  if (a.hd <= 32) return run<T, 32>(which, a);
  if (a.hd <= 64) return run<T, 64>(which, a);
  if (a.hd <= 128) return run<T, 128>(which, a);
  if (a.hd <= 256) return run<T, 256>(which, a);
  return run<T, 128, true>(which, a);
}

int dispatch(int dtype, int device, int which, const Args& a) {
  if (dtype < 0 || dtype > 2 || a.bh <= 0 || a.tq < 0 || a.tk < 0 ||
      a.hd < 1)
    return (int)cudaErrorInvalidValue;
  // at d % 8 == 0 up to 128, bfloat16 and float16 are the tensor-core
  // kernels'
  if (a.hd % 8 == 0 && a.hd <= 128 && dtype != 0)
    return (int)cudaErrorInvalidValue;
  Device guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  switch (dtype) {
    case 0: return (int)run_dim<float>(which, a);
    case 1: return (int)run_dim<__nv_bfloat16>(which, a);
    default: return (int)run_dim<__half>(which, a);
  }
}

// a 16-bit (bh, rows, hd) contiguous tensor of `type` (bf16 unless given)
// as a 3-D map (hd, rows, bh), read in (64 columns, box_rows rows, 1 head)
// boxes with 128-byte swizzle; outside the map reads as zero
bool tensor_map(CUtensorMap* map, const void* ptr, int hd, int rows, int bh,
                int box_rows,
                CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)hd * 2 * rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return tensor_map_bf16(map, ptr, 3, dims, strides, box, type);
}

template <typename T, int D, bool L>
cudaError_t run_fwd_wgmma(const Args& a) {
  using C = Tc<D>;
  auto kern = flash_fwd_wgmma_kernel<T, D, L>;
  constexpr CUtensorMapDataType ty = Elem16<T>::kTma;
  const long long items = (long long)a.bh * ((a.tq + kTcRows - 1) / kTcRows);
  if (items <= 0 || items > 2147483647LL) return cudaErrorInvalidValue;
  // persistent: one block per SM (its registers allow no second), each
  // walking items blockIdx.x, + gridDim.x, ...
  const int grid = (int)(items < sm_count() ? items : sm_count());
  CUtensorMap mq, mk, mv;
  // Tk == 0: no key tile is read; the maps only need to be valid
  const void* kp = a.tk > 0 ? a.k : a.q;
  const void* vp = a.tk > 0 ? a.v : a.q;
  const int tk = a.tk > 0 ? a.tk : a.tq;
  if (!tensor_map(&mq, a.q, a.hd, a.tq, a.bh, 64, ty) ||
      !tensor_map(&mk, kp, a.hd, tk, a.bh, C::kBN, ty) ||
      !tensor_map(&mv, vp, a.hd, tk, a.bh, C::kBN, ty))
    return cudaErrorInvalidValue;
  cudaError_t e = prepare(kern, C::kSmem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kTcThreads, C::kSmem, a.st>>>(
      mq, mk, mv, static_cast<T*>(a.o), a.lse, a.bh, a.tq, a.tk, a.causal,
      a.scale * kLog2e, a.hd);
  return cudaGetLastError();
}

// setmaxnreg moves registers within the block's launch allocation: the
// producer warpgroup's release has to cover the consumers' raise, or the
// raise would wait for ever. A build whose register count falls short is
// refused before it launches.
template <typename K>
cudaError_t prepare_rebalanced(K kern, int smem) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  if (attr.numRegs * kBwThreads <
      256 * kConsumerRegs + 128 * kProducerRegs)
    return cudaErrorLaunchOutOfResources;
  return prepare(kern, smem);
}

// the persistent grid of a backward sweep over `rows` (tq for dq, tk for
// dk/dv) in 128-row items: one block per SM at most
bool bw_grid(const Args& a, int rows, int* grid) {
  const long long items = (long long)a.bh * ((rows + kBwRows - 1) / kBwRows);
  if (items <= 0 || items > 2147483647LL) return false;
  *grid = (int)(items < sm_count() ? items : sm_count());
  return true;
}

// the four maps of a backward sweep; a side with no rows (tk == 0 for dq,
// tq == 0 for dk/dv) is never read, and its maps only need to be valid
template <typename T>
bool bw_maps(const Args& a, CUtensorMap* mq, CUtensorMap* mk, CUtensorMap* mv,
             CUtensorMap* mo) {
  constexpr CUtensorMapDataType ty = Elem16<T>::kTma;
  const bool qs = a.tq > 0, ks = a.tk > 0;
  const int nq = qs ? a.tq : a.tk, nk = ks ? a.tk : a.tq;
  return tensor_map(mq, qs ? a.q : a.k, a.hd, nq, a.bh, 64, ty) &&
         tensor_map(mo, qs ? a.dout : a.k, a.hd, nq, a.bh, 64, ty) &&
         tensor_map(mk, ks ? a.k : a.q, a.hd, nk, a.bh, 64, ty) &&
         tensor_map(mv, ks ? a.v : a.q, a.hd, nk, a.bh, 64, ty);
}

template <typename T, int D>
cudaError_t run_dq_wgmma(const Args& a) {
  auto kern = flash_bwd_dq_wgmma_kernel<T, D>;
  int grid = 0;
  CUtensorMap mq, mk, mv, mo;
  if (!bw_grid(a, a.tq, &grid) || !bw_maps<T>(a, &mq, &mk, &mv, &mo))
    return cudaErrorInvalidValue;
  cudaError_t e = prepare_rebalanced(kern, Bw<D>::kSmem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kBwThreads, Bw<D>::kSmem, a.st>>>(
      mq, mk, mv, mo, a.lse_in, a.delta, static_cast<T*>(a.o), a.bh, a.tq,
      a.tk, a.causal, a.scale * kLog2e, a.scale, a.hd);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dkv_wgmma(const Args& a) {
  auto kern = flash_bwd_dkv_wgmma_kernel<T, D>;
  int grid = 0;
  CUtensorMap mq, mk, mv, mo;
  if (!bw_grid(a, a.tk, &grid) || !bw_maps<T>(a, &mq, &mk, &mv, &mo))
    return cudaErrorInvalidValue;
  cudaError_t e = prepare_rebalanced(kern, Bw<D>::kSmem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kBwThreads, Bw<D>::kSmem, a.st>>>(
      mq, mk, mv, mo, a.lse_in, a.delta, static_cast<T*>(a.o),
      static_cast<T*>(a.o2), a.bh, a.tq, a.tk, a.causal, a.scale * kLog2e,
      a.scale, a.hd);
  return cudaGetLastError();
}

// which: 2 the dq sweep, 3 the dk/dv sweep, at the capacity that holds d
template <typename T>
cudaError_t bwd_wgmma(int which, const Args& a) {
  if (which == 2)
    return a.hd <= 64 ? run_dq_wgmma<T, 64>(a) : run_dq_wgmma<T, 128>(a);
  return a.hd <= 64 ? run_dkv_wgmma<T, 64>(a) : run_dkv_wgmma<T, 128>(a);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (ops/kernels.py :: DTYPE_CODES);
// head_dim >= 1 (at a multiple of 8 up to 128, bfloat16, and float16's
// forward, are refused: the tensor-core entry points serve them). q (bh, tq, d), k and v
// (bh, tk, d), o (bh, tq, d), all contiguous and 16-byte aligned; lse
// (bh, tq) float32, written when with_lse. Returns cudaGetLastError() after
// the launch, never synchronises.
extern "C" int mx_flash_fwd(int dtype, int device, int head_dim, int with_lse,
                            const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int tq, int tk,
                            int causal, float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr,
         static_cast<float*>(lse), bh, tq, tk, causal, head_dim, scale,
         static_cast<cudaStream_t>(stream)};
  if (with_lse && lse == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, device, with_lse ? 1 : 0, a);
}

template <typename T>
cudaError_t fwd_wgmma(int head_dim, int with_lse, const Args& a) {
  if (head_dim <= 64)
    return with_lse ? run_fwd_wgmma<T, 64, true>(a)
                    : run_fwd_wgmma<T, 64, false>(a);
  return with_lse ? run_fwd_wgmma<T, 128, true>(a)
                  : run_fwd_wgmma<T, 128, false>(a);
}

// The tensor-core forward. dtype: 0 float32, 1 bfloat16, 2 float16
// (ops/kernels.py :: DTYPE_CODES); only 1 and 2 are taken. q, k, v, o of
// that type as above, 16-byte aligned, head_dim a multiple of 8 up to 128,
// tq >= 1.
extern "C" int mx_flash_fwd_wgmma(int dtype, int device, int head_dim,
                                  int with_lse, const void* q, const void* k,
                                  const void* v, void* o, void* lse, int bh,
                                  int tq, int tk, int causal, float scale,
                                  void* stream) {
  if ((dtype != 1 && dtype != 2) || head_dim < 8 || head_dim > 128 ||
      head_dim % 8 || bh <= 0 || tq <= 0 || tk < 0 ||
      (with_lse && lse == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr,
         static_cast<float*>(lse), bh, tq, tk, causal, head_dim, scale,
         static_cast<cudaStream_t>(stream)};
  Device guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  return (int)(dtype == 1 ? fwd_wgmma<__nv_bfloat16>(head_dim, with_lse, a)
                          : fwd_wgmma<__half>(head_dim, with_lse, a));
}

// dq (bh, tq, d) from q, k, v, dout and the float32 (bh, tq) lse and delta
// (dtype and head_dim as mx_flash_fwd's).
extern "C" int mx_flash_bwd_dq(int dtype, int device, int head_dim,
                               const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int tq,
                               int tk, int causal, float scale, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, nullptr, bh, tq, tk,
         causal, head_dim, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, device, 2, a);
}

// dk and dv (bh, tk, d) from q, k, v, dout and the float32 (bh, tq) lse and
// delta.
extern "C" int mx_flash_bwd_dkv(int dtype, int device, int head_dim,
                                const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int tq, int tk, int causal, float scale,
                                void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dk, dv, nullptr, bh, tq, tk,
         causal, head_dim, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, device, 3, a);
}

// The tensor-core backward sweeps. dtype: 0 float32, 1 bfloat16, 2 float16
// (ops/kernels.py :: DTYPE_CODES); only 1 and 2 are taken. q, k, v, dout
// and outputs of that type as above, 16-byte aligned, head_dim a multiple
// of 8 up to 128; tq >= 1 for dq, tk >= 1 for dk/dv (the other side may be
// empty).
static int bwd_wgmma_entry(int dtype, int device, int which, const Args& a) {
  if ((dtype != 1 && dtype != 2) || a.hd < 8 || a.hd > 128 || a.hd % 8 ||
      a.bh <= 0 || a.tq < 0 || a.tk < 0 || a.lse_in == nullptr ||
      a.delta == nullptr || (which == 2 ? a.tq : a.tk) < 1)
    return (int)cudaErrorInvalidValue;
  Device guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  return (int)(dtype == 1 ? bwd_wgmma<__nv_bfloat16>(which, a)
                          : bwd_wgmma<__half>(which, a));
}

extern "C" int mx_flash_bwd_dq_wgmma(int dtype, int device, int head_dim,
                                     const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int bh, int tq, int tk,
                                     int causal, float scale, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, nullptr, bh, tq, tk,
         causal, head_dim, scale, static_cast<cudaStream_t>(stream)};
  return bwd_wgmma_entry(dtype, device, 2, a);
}

extern "C" int mx_flash_bwd_dkv_wgmma(int dtype, int device, int head_dim,
                                      const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int bh, int tq,
                                      int tk, int causal, float scale,
                                      void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dk, dv, nullptr, bh, tq, tk,
         causal, head_dim, scale, static_cast<cudaStream_t>(stream)};
  return bwd_wgmma_entry(dtype, device, 3, a);
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}