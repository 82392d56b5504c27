// Paged decode / chunk attention over the slotted KV slab, for Hopper (sm_90a).
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/pallas_kernels.py ::
// paged_attention_fwd (_paged_attn_kernel) for float32 and bfloat16 slabs.
// It computes what incubator_mxnet_tpu_torch/ops/fused.py ::
// paged_attention_ref computes:
//
//   out[s, j, h] = softmax_t(q[s,j,h] . k[s,l,t,h] / sqrt(D)) . v[s,l,t,h]
//                  over t <= len_s + j and t < T,
//
// with f32 arithmetic inside and the output in q's dtype. Lane s reads row s
// of the slab; the slab may be a view (the engine's `extent` slice keeps the
// full slab's strides), so rows and positions are addressed by strides.
//
// What bounds it on the card: the live KV bytes it must read,
// sum_s min(T, len_s + C) * H * D * 2 * itemsize, over 3.35 TB/s. For the
// chunk case (C = the prefill window) the f32 multiply-adds come close too.
// What the design does about it: a block reads only its lane's live prefix
// (the token loop stops at min(T, len_s + last query row + 1), the clamp the
// TPU kernel made through its index map), loads K and V with 16-byte vector
// loads once per (lane, head, query tile), and keeps the running max,
// normaliser and accumulator on chip in f32. Left for later: tensor-core
// (wgmma) products for the chunk case, TMA with double-buffered tiles, and a
// split over tokens when lanes x heads are too few to fill the card.
//
// Grid (ceil(C / QT), H, S), 128 threads a block. Blocks run in any order and
// share nothing: the token loop inside a block takes the place of the TPU
// grid's sequential token axis.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;  // the mask value of the plain version

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* dst) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* dst) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(b[e]);
      dst[2 * e] = f.x;
      dst[2 * e + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One block: lane s, head h, query rows [q0, q0 + QT) of the chunk.
template <typename T, int D, int QT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int C, int H, int T_ext, long long row_stride,
                       long long tok_stride, float scale) {
  constexpr int BT = D <= 64 ? 64 : 32;  // token positions per K/V tile
  constexpr int VN = Vec16<T>::N;
  constexpr int DV = D / VN;  // 16-byte vectors per head row
  constexpr int ACC = (QT * D + kThreads - 1) / kThreads;

  __shared__ float qs[QT][D];
  __shared__ float ks[BT][D + 1];  // +1: the score loop reads ks down a column
  __shared__ float vs[BT][D];
  __shared__ float ps[QT][BT];
  __shared__ float m_s[QT], l_s[QT], alpha_s[QT];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int len = lengths[s];
  const int q_end = min(C, q0 + QT);
  // positions some row of this tile may read: [0, len + q_end - 1] within T
  const int n_pos = min(T_ext, len + q_end);

  // the q tile in f32; rows past C are zero and never written out
  for (int c = tid; c < QT * DV; c += kThreads) {
    const int i = c / DV, d = (c % DV) * VN;
    float x[VN];
    if (q0 + i < C) {
      Vec16<T>::load(q + ((long long)(s * C + q0 + i) * H + h) * D + d, x);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) qs[i][d + e] = x[e];
  }
  for (int i = tid; i < QT; i += kThreads) {
    m_s[i] = kMasked;
    l_s[i] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int r = 0; r < ACC; ++r) acc[r] = 0.f;
  __syncthreads();

  const T* kb = k + (long long)s * row_stride + (long long)h * D;
  const T* vb = v + (long long)s * row_stride + (long long)h * D;
  for (int t0 = 0; t0 < n_pos; t0 += BT) {
    // K/V tile in f32; positions at or past n_pos are zero and masked below
    for (int c = tid; c < BT * DV; c += kThreads) {
      const int j = c / DV, d = (c % DV) * VN;
      float kx[VN], vx[VN];
      if (t0 + j < n_pos) {
        const long long off = (long long)(t0 + j) * tok_stride + d;
        Vec16<T>::load(kb + off, kx);
        Vec16<T>::load(vb + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        ks[j][d + e] = kx[e];
        vs[j][d + e] = vx[e];
      }
    }
    __syncthreads();

    // scores; query row q0 + i may read positions [0, len + q0 + i]
    for (int c = tid; c < QT * BT; c += kThreads) {
      const int i = c / BT, j = c % BT;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qs[i][d], ks[j][d], dot);
      const int pos = t0 + j;
      const bool live = pos < n_pos && pos <= len + q0 + i;
      ps[i][j] = live ? dot * scale : kMasked;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int i = warp; i < QT; i += kWarps) {
      float mx = kMasked;
      for (int j = lane; j < BT; j += 32) mx = fmaxf(mx, ps[i][j]);
      mx = warp_max(mx);
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BT; j += 32) {
        const float p = expf(ps[i][j] - m_new);
        ps[i][j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha_s[i] = a;
        l_s[i] = l_s[i] * a + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V, one (row, dim) output element per slot
#pragma unroll
    for (int r = 0; r < ACC; ++r) {
      const int p = tid + r * kThreads;
      if (p < QT * D) {
        const int i = p / D, d = p % D;
        float a = acc[r] * alpha_s[i];
#pragma unroll 16
        for (int j = 0; j < BT; ++j) a = fmaf(ps[i][j], vs[j][d], a);
        acc[r] = a;
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs and ps
  }

#pragma unroll
  for (int r = 0; r < ACC; ++r) {
    const int p = tid + r * kThreads;
    if (p < QT * D) {
      const int i = p / D, d = p % D;
      if (q0 + i < C) {
        store(acc[r] / l_s[i],
              out + ((long long)(s * C + q0 + i) * H + h) * D + d);
      }
    }
  }
}

template <typename T, int D, int QT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int S, int C, int H,
                   int T_ext, long long row_stride, long long tok_stride,
                   cudaStream_t stream) {
  const dim3 grid((C + QT - 1) / QT, H, S);
  const float scale = 1.0f / sqrtf((float)D);
  paged_attention_kernel<T, D, QT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), C, H, T_ext,
      row_stride, tok_stride, scale);
  return cudaGetLastError();
}

// decode (C == 1) takes a one-row query tile; chunks take 16-row tiles
template <typename T, int D>
cudaError_t launch_tile(const void* q, const void* k, const void* v,
                        const int* lengths, void* out, int S, int C, int H,
                        int T_ext, long long row_stride, long long tok_stride,
                        cudaStream_t stream) {
  if (C == 1)
    return launch<T, D, 1>(q, k, v, lengths, out, S, C, H, T_ext, row_stride,
                           tok_stride, stream);
  return launch<T, D, 16>(q, k, v, lengths, out, S, C, H, T_ext, row_stride,
                          tok_stride, stream);
}

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v,
                       const int* lengths, void* out, int S, int C, int H,
                       int T_ext, long long row_stride, long long tok_stride,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_tile<T, 32>(q, k, v, lengths, out, S, C, H, T_ext,
                                row_stride, tok_stride, stream);
    case 64:
      return launch_tile<T, 64>(q, k, v, lengths, out, S, C, H, T_ext,
                                row_stride, tok_stride, stream);
    case 128:
      return launch_tile<T, 128>(q, k, v, lengths, out, S, C, H, T_ext,
                                 row_stride, tok_stride, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q and out are contiguous (S, C, H, D); k and
// v point at [row 0, layer, position 0] of the slab, whose rows and positions
// are row_stride and tok_stride elements apart (heads and dims contiguous).
// lengths is (S,) int32 on the device. S, C and H are at least 1. Returns
// cudaGetLastError() after the launch (0 on success), never synchronises.
extern "C" int mx_paged_attention_fwd(int dtype, int device, const void* q,
                                      const void* k, const void* v,
                                      const void* lengths, void* out, int S,
                                      int C, int H, int D, int T_ext,
                                      long long row_stride,
                                      long long tok_stride, void* stream) {
  if (S <= 0 || C <= 0 || H <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  // launch on the tensors' device, and leave the caller's current device
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? launch_dim<float>(D, q, k, v, lens, out, S, C, H, T_ext,
                                row_stride, tok_stride, st)
            : launch_dim<__nv_bfloat16>(D, q, k, v, lens, out, S, C, H,
                                        T_ext, row_stride, tok_stride, st);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
