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
// in float32 or bfloat16 (lse and delta float32). delta is computed by the
// caller, as the JAX package computes it outside Pallas.
//
// What bounds them on the card: operations. At the BERT-base shape (bh 192,
// T 512, d 64) the forward does 12.9 GFLOP on 50.7 MB of bf16 inputs and
// outputs, the dq sweep 19.3 GFLOP and the dk/dv sweep 25.8 GFLOP; this first
// version runs its products on the CUDA cores in f32 (67 TFLOP/s at most),
// not on the tensor cores (989 TFLOP/s bf16), so it sits far above the bound
// the bytes set. What the design does about it: every tile lives in shared
// memory as f32 after one 16-byte-vector load from device memory, the
// (64 x 64) score tile never leaves the chip, each thread computes a 4 x 4
// block of scores from float4 reads of padded rows (conflict-free banks), and
// the running max, normaliser and accumulators stay in registers. Causal tiles
// wholly above the diagonal are skipped, as the TPU kernels skip them.
// Left for later: wgmma/TMA tensor-core tiles in bf16.
//
// Unlike the TPU grid, blocks run in parallel and share nothing: the loop over
// key tiles (forward, dq) or query tiles (dk/dv) inside one block takes the
// place of the TPU grid's sequential axis, so both backward sweeps accumulate
// without atomics and are deterministic. Ragged Tq and Tk are masked per tile.
//
// Threads: 256 a block, as 16 row groups x 16 column groups. Thread (rg, cg)
// owns rows rg*4 .. rg*4+3 of a 64-row tile; its scores are the columns
// cg + 16*j (j < 4) and its output columns col(cg, t) below.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // query rows and key rows per tile
constexpr int kLdS = kTile + 4;      // padded row of a (64 x 64) score tile
constexpr float kMasked = -1e30f;    // the mask value and the LSE sentinel
constexpr float kSentinelCut = -5e29f;  // lse at or below: a fully masked row

template <int D>
struct Dims {
  static constexpr int kLd = D + 4;         // padded row of a (64 x D) tile
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

template <typename T>
struct Load8;

template <>
struct Load8<float> {
  __device__ __forceinline__ static void load(const float* p, float* d) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
    d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
  }
};

template <>
struct Load8<__nv_bfloat16> {
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// rows [row0, row0 + 64) of a contiguous (rows, D) matrix into a padded f32
// tile; rows at or past `rows` read as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0,
                                          int rows, float* dst) {
  constexpr int kPerRow = D / 8;
  constexpr int kChunks = kTile * kPerRow;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / kPerRow;
    const int d = (c % kPerRow) * 8;
    float v[8];
    if (row0 + r < rows) {
      Load8<T>::load(src + (long long)(row0 + r) * D + d, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
    float4* o = reinterpret_cast<float4*>(dst + r * Dims<D>::kLd + d);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// acc[i][j] += A[rg*4+i] . B[cg+16j] over D (A, B padded (64 x D) tiles)
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         int rg, int cg, float acc[4][4]) {
  constexpr int L = Dims<D>::kLd;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (rg * 4 + i) * L + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (cg + 16 * j) * L + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
template <int D>
__device__ __forceinline__ void load_cols(const float* M, int row, int cg,
                                          float* m) {
  constexpr int TD = Dims<D>::kTD;
  const float* p = M + row * Dims<D>::kLd;
  if constexpr (TD < 4) {
#pragma unroll
    for (int t = 0; t < TD; ++t) m[t] = p[out_col<D>(cg, t)];
  } else {
#pragma unroll
    for (int u = 0; u < TD / 4; ++u) {
      const float4 x = *reinterpret_cast<const float4*>(p + u * 64 + cg * 4);
      m[4 * u] = x.x;
      m[4 * u + 1] = x.y;
      m[4 * u + 2] = x.z;
      m[4 * u + 3] = x.w;
    }
  }
}

// out[i][t] += sum_k P[rg*4+i][k] * M[k][col(cg, t)]   (P a (64 x 64) score
// tile, M a padded (64 x D) tile)
template <int D>
__device__ __forceinline__ void tile_pm(const float* P, const float* M, int rg,
                                        int cg, float out[4][Dims<D>::kTD]) {
  constexpr int TD = Dims<D>::kTD;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(P + (rg * 4 + i) * kLdS + k);
      p[i][0] = x.x;
      p[i][1] = x.y;
      p[i][2] = x.z;
      p[i][3] = x.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float m[TD];
      load_cols<D>(M, k + kk, cg, m);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
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

__device__ __forceinline__ bool live(int qi, int kj, int Tq, int Tk,
                                     int causal) {
  return qi < Tq && kj < Tk && (!causal || kj <= qi + (Tk - Tq));
}

// key tiles a query tile at q0 reads: all, or, when causal, those not wholly
// above the diagonal (the TPU kernels' skip rule)
__device__ __forceinline__ int key_tiles(int q0, int Tq, int Tk, int causal) {
  const int nk = (Tk + kTile - 1) / kTile;
  if (!causal) return nk;
  const int last = min(q0 + kTile, Tq) - 1 + (Tk - Tq);
  if (last < 0) return 0;
  return min(nk, last / kTile + 1);
}

// the first query tile that sees a key tile at k0 (causal)
__device__ __forceinline__ int first_query_tile(int k0, int Tq, int Tk) {
  const int first = k0 - (Tk - Tq);
  return first <= 0 ? 0 : first / kTile;
}

// ---------------------------------------------------------------------------
// B5 / B6: forward, one block per (query tile, bh), online softmax over the
// key tiles
// ---------------------------------------------------------------------------
template <typename T, int D, bool kWithLse>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Tq, int Tk, int causal,
                     float scale) {
  constexpr int TD = Dims<D>::kTD;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + Dims<D>::kTileFloats;
  float* sV = sK + Dims<D>::kTileFloats;
  float* sP = sV + Dims<D>::kTileFloats;
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  q += bh * Tq * D;
  k += bh * Tk * D;
  v += bh * Tk * D;
  o += bh * Tq * D;

  load_tile<T, D>(q, q0, Tq, sQ);
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
    load_tile<T, D>(k, k0, Tk, sK);
    load_tile<T, D>(v, k0, Tk, sV);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(sQ, sK, rg, cg, s);
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
    for (int t = 0; t < TD; ++t)
      store(o + (long long)qi * D + out_col<D>(cg, t), acc[i][t] / denom);
    if (kWithLse && cg == 0)
      lse[bh * Tq + qi] =
          l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-37f)) : kMasked;
  }
}

// ---------------------------------------------------------------------------
// B7: dq sweep, one block per (query tile, bh), accumulating over key tiles
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Tq, int Tk, int causal, float scale) {
  constexpr int TD = Dims<D>::kTD;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + Dims<D>::kTileFloats;  // dO
  float* sK = sO + Dims<D>::kTileFloats;
  float* sV = sK + Dims<D>::kTileFloats;
  float* sS = sV + Dims<D>::kTileFloats;  // ds
  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  q += bh * Tq * D;
  dout += bh * Tq * D;
  dq += bh * Tq * D;
  k += bh * Tk * D;
  v += bh * Tk * D;

  load_tile<T, D>(q, q0, Tq, sQ);
  load_tile<T, D>(dout, q0, Tq, sO);
  float lse_r[4], del_r[4], acc[4][TD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    lse_r[i] = qi < Tq ? lse[bh * Tq + qi] : kMasked;
    del_r[i] = qi < Tq ? delta[bh * Tq + qi] : 0.f;
#pragma unroll
    for (int t = 0; t < TD; ++t) acc[i][t] = 0.f;
  }
  const int nk = key_tiles(q0, Tq, Tk, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(k, k0, Tk, sK);
    load_tile<T, D>(v, k0, Tk, sV);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(sQ, sK, rg, cg, s);
    tile_dot<D>(sO, sV, rg, cg, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live(qi, k0 + cg + 16 * j, Tq, Tk, causal) &&
                                lse_r[i] > kSentinelCut
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.f;
        sS[(rg * 4 + i) * kLdS + cg + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    }
    __syncthreads();
    tile_pm<D>(sS, sK, rg, cg, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= Tq) continue;
#pragma unroll
    for (int t = 0; t < TD; ++t)
      store(dq + (long long)qi * D + out_col<D>(cg, t), acc[i][t] * scale);
  }
}

// ---------------------------------------------------------------------------
// B8: dk/dv sweep, one block per (key tile, bh), accumulating over query
// tiles. Thread rows are key rows here; its score columns are query rows.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int Tq, int Tk, int causal,
                         float scale) {
  constexpr int TD = Dims<D>::kTD;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + Dims<D>::kTileFloats;
  float* sQ = sV + Dims<D>::kTileFloats;
  float* sO = sQ + Dims<D>::kTileFloats;  // dO
  float* sP = sO + Dims<D>::kTileFloats;  // p, (key row, query row)
  float* sS = sP + kTile * kLdS;          // ds, (key row, query row)
  float* sL = sS + kTile * kLdS;          // lse of the query tile
  float* sD = sL + kTile;                 // delta of the query tile
  const long long bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  q += bh * Tq * D;
  dout += bh * Tq * D;
  k += bh * Tk * D;
  v += bh * Tk * D;
  dk += bh * Tk * D;
  dv += bh * Tk * D;

  load_tile<T, D>(k, k0, Tk, sK);
  load_tile<T, D>(v, k0, Tk, sV);
  float dk_acc[4][TD], dv_acc[4][TD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
    load_tile<T, D>(q, q0, Tq, sQ);
    load_tile<T, D>(dout, q0, Tq, sO);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool in = q0 + r < Tq;
      sL[r] = in ? lse[bh * Tq + q0 + r] : kMasked;
      sD[r] = in ? delta[bh * Tq + q0 + r] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(sK, sQ, rg, cg, s);
    tile_dot<D>(sV, sO, rg, cg, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        const float lq = sL[c];
        const float p = live(q0 + c, kj, Tq, Tk, causal) && lq > kSentinelCut
                            ? expf(s[i][j] * scale - lq)
                            : 0.f;
        sP[(rg * 4 + i) * kLdS + c] = p;
        sS[(rg * 4 + i) * kLdS + c] = p * (dp[i][j] - sD[c]);
      }
    }
    __syncthreads();
    tile_pm<D>(sP, sO, rg, cg, dv_acc);
    tile_pm<D>(sS, sQ, rg, cg, dk_acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + rg * 4 + i;
    if (kj >= Tk) continue;
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      const long long at = (long long)kj * D + out_col<D>(cg, t);
      store(dk + at, dk_acc[i][t] * scale);
      store(dv + at, dv_acc[i][t]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <int D>
constexpr int fwd_smem() {
  return (3 * Dims<D>::kTileFloats + kTile * kLdS) * 4;
}
template <int D>
constexpr int dq_smem() {
  return (4 * Dims<D>::kTileFloats + kTile * kLdS) * 4;
}
template <int D>
constexpr int dkv_smem() {
  return (4 * Dims<D>::kTileFloats + 2 * kTile * kLdS + 2 * kTile) * 4;
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
  int bh, tq, tk, causal;
  float scale;
  cudaStream_t st;
};

template <typename K>
cudaError_t prepare(K kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename T, int D, bool L>
cudaError_t run_fwd(const Args& a) {
  auto kern = flash_fwd_kernel<T, D, L>;
  constexpr int smem = fwd_smem<D>();
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.tq + kTile - 1) / kTile, a.bh);
  kern<<<grid, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.tq, a.tk,
      a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dq(const Args& a) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  constexpr int smem = dq_smem<D>();
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.tq + kTile - 1) / kTile, a.bh);
  kern<<<grid, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, static_cast<T*>(a.o), a.tq, a.tk, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dkv(const Args& a) {
  auto kern = flash_bwd_dkv_kernel<T, D>;
  constexpr int smem = dkv_smem<D>();
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.tk + kTile - 1) / kTile, a.bh);
  kern<<<grid, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse_in,
      a.delta, static_cast<T*>(a.o), static_cast<T*>(a.o2), a.tq, a.tk,
      a.causal, a.scale);
  return cudaGetLastError();
}

// which: 0 forward, 1 forward + lse, 2 dq sweep, 3 dk/dv sweep
template <typename T, int D>
cudaError_t run(int which, const Args& a) {
  switch (which) {
    case 0: return run_fwd<T, D, false>(a);
    case 1: return run_fwd<T, D, true>(a);
    case 2: return run_dq<T, D>(a);
    case 3: return run_dkv<T, D>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t run_dim(int head_dim, int which, const Args& a) {
  switch (head_dim) {
    case 32: return run<T, 32>(which, a);
    case 64: return run<T, 64>(which, a);
    case 128: return run<T, 128>(which, a);
  }
  return cudaErrorInvalidValue;
}

int dispatch(int dtype, int device, int head_dim, int which, const Args& a) {
  if ((dtype != 0 && dtype != 1) || a.bh <= 0 || a.bh > 65535 || a.tq < 0 ||
      a.tk < 0)
    return (int)cudaErrorInvalidValue;
  Device guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  return (int)(dtype == 0 ? run_dim<float>(head_dim, which, a)
                          : run_dim<__nv_bfloat16>(head_dim, which, a));
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; head_dim 32, 64 or 128. q (bh, tq, d), k and
// v (bh, tk, d), o (bh, tq, d), all contiguous and 16-byte aligned; lse
// (bh, tq) float32, written when with_lse. Returns cudaGetLastError() after
// the launch, never synchronises.
extern "C" int mx_flash_fwd(int dtype, int device, int head_dim, int with_lse,
                            const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int tq, int tk,
                            int causal, float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr,
         static_cast<float*>(lse), bh, tq, tk, causal, scale,
         static_cast<cudaStream_t>(stream)};
  if (with_lse && lse == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, device, head_dim, with_lse ? 1 : 0, a);
}

// dq (bh, tq, d) from q, k, v, dout and the float32 (bh, tq) lse and delta.
extern "C" int mx_flash_bwd_dq(int dtype, int device, int head_dim,
                               const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int tq,
                               int tk, int causal, float scale, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, nullptr, bh, tq, tk,
         causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, device, head_dim, 2, a);
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
         causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, device, head_dim, 3, a);
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
