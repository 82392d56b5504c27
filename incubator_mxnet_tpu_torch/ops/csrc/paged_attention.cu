// Paged decode / chunk attention over the slotted KV slab, for Hopper (sm_90a).
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/pallas_kernels.py ::
// paged_attention_fwd (_paged_attn_kernel), both its float variant and its
// quantized one (int8 codes with per-position f32 scales, the dequant at
// pallas_kernels.py:246-248). It computes what
// incubator_mxnet_tpu_torch/ops/fused.py :: paged_attention_ref computes:
//
//   out[s, j, h] = softmax_t(q[s,j,h] . k'[s,l,t,h] / sqrt(D)) . v'[s,l,t,h]
//                  over t <= len_s + j and t < T,
//   k' = k (float slabs) or float(code_k) * k_scale[s,l,t] (int8 slabs),
//
// with f32 arithmetic inside and the output in q's dtype. q and out are
// float32 or bfloat16; the slab is float32, bfloat16 or int8, independent of
// q's type. Lane s reads row s of the slab; the slab and the scales may be
// views (the engine's `extent` slice keeps the full slab's strides), so rows
// and positions are addressed by strides.
//
// What bounds it on the card: the live KV bytes it must read,
// sum_s min(T, len_s + C) * H * D * 2 * itemsize (plus 2 * 4 bytes a
// position of scales for int8), over 3.35 TB/s. For the chunk case (C = the
// prefill window) the f32 multiply-adds come close too. What the design does
// about it: a block reads only its lane's live prefix (the token loop stops
// at min(T, len_s + last query row + 1), the clamp the TPU kernel made
// through its index map), loads K and V with 16-byte vector loads once per
// (lane, head, query tile), dequantizes as it loads (a tile's scales are
// staged in shared memory once), and keeps the running max, normaliser and
// accumulator on chip in f32. Left for later: tensor-core (wgmma) products
// for the chunk case, TMA with double-buffered tiles, and a split over tokens
// when lanes x heads are too few to fill the card.
//
// Head dims: each instance has a capacity D (32, 64, 128, 256) and takes the
// real head dim d <= D at run time; columns d..D-1 of its tiles are zero and
// never stored. Every tile is static shared memory, at most 48 KB a block:
// at capacity 256 a K/V tile holds 16 positions and a chunk's query tile 8
// rows (41,760 bytes; 32 positions and 16 rows would take ~83 KB). Rows are read with 16-byte vector loads where every q and slab row
// is a whole number of aligned 16-byte vectors (d * itemsize a multiple of 16,
// strides and pointers aligned), and element by element otherwise (int8 codes
// at d = 24, bf16 at d = 12, for example).
//
// Grid (ceil(C / QT), H, S), 128 threads a block. Blocks run in any order and
// share nothing: the token loop inside a block takes the place of the TPU
// grid's sequential token axis.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;  // the mask value of the plain version

// 16 bytes of T converted to f32
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static float one(const float* p) { return *p; }
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
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
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

template <>
struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static float one(const int8_t* p) {
    return (float)*p;
  }
  __device__ __forceinline__ static void load(const int8_t* p, float* dst) {
    const int4 x = *reinterpret_cast<const int4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[e] = (float)b[e];
  }
};

// the N = Vec16<T>::N values at p whose first n (>= 1) are in the row: one
// vector load on the vector path (where every chunk is whole), else element
// by element. The kernel picks the path once per block (a uniform branch
// around each tile loop), so the vector path's loads stay straight-line.
template <bool kVec, typename T>
__device__ __forceinline__ void load_chunk(const T* p, int n, float* dst) {
  constexpr int N = Vec16<T>::N;
  if constexpr (kVec) {
    Vec16<T>::load(p, dst);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) dst[e] = e < n ? Vec16<T>::one(p + e) : 0.f;
  }
}

template <bool V>
using Path = std::integral_constant<bool, V>;

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

// Pointers and sizes of one launch. k, v, k_scale and v_scale point at
// [row 0, layer, position 0]; slab rows and positions are row_stride and
// tok_stride elements apart, scale rows scale_row_stride floats (positions
// contiguous). The scales are null for float slabs.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* lengths;
  void* out;
  int S, C, H, T_ext;
  int d;    // the head dim, <= the instance's capacity D
  int vec;  // every q and slab row is whole aligned 16-byte vectors
  long long row_stride, tok_stride, scale_row_stride;
};

// One block: lane s, head h, query rows [q0, q0 + QT) of the chunk; D is
// the capacity, a.d the head dim.
template <typename Tq, typename Tkv, int D, int QT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Args a, float scale) {
  constexpr bool kQuant = std::is_same<Tkv, int8_t>::value;
  // token positions per K/V tile
  constexpr int BT = D <= 64 ? 64 : (D <= 128 ? 32 : 16);
  constexpr int QN = Vec16<Tq>::N;
  constexpr int QV = D / QN;  // 16-byte vectors per q row
  constexpr int KN = Vec16<Tkv>::N;
  constexpr int KV = D / KN;  // 16-byte vectors per slab head row
  constexpr int ACC = (QT * D + kThreads - 1) / kThreads;

  __shared__ float qs[QT][D];
  __shared__ float ks[BT][D + 1];  // +1: the score loop reads ks down a column
  __shared__ float vs[BT][D];
  __shared__ float ps[QT][BT];
  __shared__ float m_s[QT], l_s[QT], alpha_s[QT];
  __shared__ float ksc[kQuant ? BT : 1], vsc[kQuant ? BT : 1];

  const Tq* q = static_cast<const Tq*>(a.q);
  Tq* out = static_cast<Tq*>(a.out);
  const int C = a.C, H = a.H, hd = a.d;
  const bool vec = a.vec != 0;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int len = a.lengths[s];
  const int q_end = min(C, q0 + QT);
  // positions some row of this tile may read: [0, len + q_end - 1] within T
  const int n_pos = min(a.T_ext, len + q_end);

  // the q tile in f32; rows past C are zero and never written out
  auto q_tile = [&](auto path) {
    for (int c = tid; c < QT * QV; c += kThreads) {
      const int i = c / QV, d = (c % QV) * QN;
      float x[QN];
      if (q0 + i < C && d < hd) {
        load_chunk<decltype(path)::value>(
            q + ((long long)(s * C + q0 + i) * H + h) * hd + d, hd - d, x);
      } else {
#pragma unroll
        for (int e = 0; e < QN; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < QN; ++e) qs[i][d + e] = x[e];
    }
  };
  if (vec) q_tile(Path<true>{});
  else q_tile(Path<false>{});
  for (int i = tid; i < QT; i += kThreads) {
    m_s[i] = kMasked;
    l_s[i] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int r = 0; r < ACC; ++r) acc[r] = 0.f;
  __syncthreads();

  const Tkv* kb = static_cast<const Tkv*>(a.k) + (long long)s * a.row_stride +
                  (long long)h * hd;
  const Tkv* vb = static_cast<const Tkv*>(a.v) + (long long)s * a.row_stride +
                  (long long)h * hd;
  const float* ksb = kQuant ? a.k_scale + (long long)s * a.scale_row_stride
                            : nullptr;
  const float* vsb = kQuant ? a.v_scale + (long long)s * a.scale_row_stride
                            : nullptr;
  for (int t0 = 0; t0 < n_pos; t0 += BT) {
    if constexpr (kQuant) {
      // this tile's scales, once; positions at or past n_pos are masked
      for (int j = tid; j < BT; j += kThreads) {
        const bool in = t0 + j < n_pos;
        ksc[j] = in ? ksb[t0 + j] : 0.f;
        vsc[j] = in ? vsb[t0 + j] : 0.f;
      }
      __syncthreads();
    }
    // K/V tile in f32 (dequantized as it loads: code * scale, the plain
    // version's order); positions at or past n_pos are zero and masked below
    auto kv_tile = [&](auto path) {
      for (int c = tid; c < BT * KV; c += kThreads) {
        const int j = c / KV, d = (c % KV) * KN;
        float kx[KN], vx[KN];
        if (t0 + j < n_pos && d < hd) {
          const long long off = (long long)(t0 + j) * a.tok_stride + d;
          load_chunk<decltype(path)::value>(kb + off, hd - d, kx);
          load_chunk<decltype(path)::value>(vb + off, hd - d, vx);
          if constexpr (kQuant) {
            const float sk = ksc[j], sv = vsc[j];
#pragma unroll
            for (int e = 0; e < KN; ++e) {
              kx[e] *= sk;
              vx[e] *= sv;
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < KN; ++e) kx[e] = vx[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < KN; ++e) {
          ks[j][d + e] = kx[e];
          vs[j][d + e] = vx[e];
        }
      }
    };
    if (vec) kv_tile(Path<true>{});
    else kv_tile(Path<false>{});
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
        const float al = expf(m_old - m_new);
        alpha_s[i] = al;
        l_s[i] = l_s[i] * al + sum;
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
        float x = acc[r] * alpha_s[i];
#pragma unroll 16
        for (int j = 0; j < BT; ++j) x = fmaf(ps[i][j], vs[j][d], x);
        acc[r] = x;
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs, ps and the scales
  }

#pragma unroll
  for (int r = 0; r < ACC; ++r) {
    const int p = tid + r * kThreads;
    if (p < QT * D) {
      const int i = p / D, d = p % D;
      if (q0 + i < C && d < hd) {
        store(acc[r] / l_s[i],
              out + ((long long)(s * C + q0 + i) * H + h) * hd + d);
      }
    }
  }
}

// decode (C == 1) takes a one-row query tile; chunks take 16-row tiles (8
// at capacity 256, within static shared memory)
template <typename Tq, typename Tkv, int D>
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  constexpr int QT = D <= 128 ? 16 : 8;
  const float scale = 1.0f / sqrtf((float)a.d);
  if (a.C == 1) {
    paged_attention_kernel<Tq, Tkv, D, 1>
        <<<dim3(a.C, a.H, a.S), kThreads, 0, stream>>>(a, scale);
  } else {
    paged_attention_kernel<Tq, Tkv, D, QT>
        <<<dim3((a.C + QT - 1) / QT, a.H, a.S), kThreads, 0, stream>>>(a,
                                                                      scale);
  }
  return cudaGetLastError();
}

// the capacity instance that holds head dim a.d
template <typename Tq, typename Tkv>
cudaError_t launch_dim(const Args& a, cudaStream_t stream) {
  if (a.d <= 32) return launch_tile<Tq, Tkv, 32>(a, stream);
  if (a.d <= 64) return launch_tile<Tq, Tkv, 64>(a, stream);
  if (a.d <= 128) return launch_tile<Tq, Tkv, 128>(a, stream);
  return launch_tile<Tq, Tkv, 256>(a, stream);
}

template <typename Tq>
cudaError_t launch_kv(int kv_dtype, const Args& a, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_dim<Tq, float>(a, stream);
    case 1:
      return launch_dim<Tq, __nv_bfloat16>(a, stream);
    case 2:
      return launch_dim<Tq, int8_t>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16 (q and out). kv_dtype: 0 float32,
// 1 bfloat16, 2 int8 (the slab; int8 needs k_scale and v_scale, f32). q and
// out are contiguous (S, C, H, D); k and v point at [row 0, layer,
// position 0] of the slab, whose rows and positions are row_stride and
// tok_stride elements apart (heads and dims contiguous); k_scale and v_scale
// point at [row 0, layer, position 0] of the scales, whose rows are
// scale_row_stride floats apart (positions contiguous). lengths is (S,)
// int32 on the device. S, C and H are at least 1, D from 1 to 256. Returns
// cudaGetLastError() after the launch (0 on success), never synchronises.
extern "C" int mx_paged_attention_fwd(
    int q_dtype, int kv_dtype, int device, const void* q, const void* k,
    const void* v, const void* k_scale, const void* v_scale,
    const void* lengths, void* out, int S, int C, int H, int D, int T_ext,
    long long row_stride, long long tok_stride, long long scale_row_stride,
    void* stream) {
  if (S <= 0 || C <= 0 || H <= 0 || D < 1 || D > 256 ||
      (q_dtype != 0 && q_dtype != 1) || kv_dtype < 0 || kv_dtype > 2)
    return (int)cudaErrorInvalidValue;
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  // launch on the tensors' device, and leave the caller's current device
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.S = S;
  a.C = C;
  a.H = H;
  a.T_ext = T_ext;
  a.d = D;
  // 16-byte vectors where every row of q and out (D values), and of the slab
  // (D values at each row, layer and position offset), is whole and aligned
  const int q_item = q_dtype == 0 ? 4 : 2;
  const int kv_item = kv_dtype == 0 ? 4 : (kv_dtype == 1 ? 2 : 1);
  const long long kv_vec = 16 / kv_item;
  a.vec = (D * q_item) % 16 == 0 && (D * kv_item) % 16 == 0 &&
          row_stride % kv_vec == 0 && tok_stride % kv_vec == 0 &&
          aligned16(q) && aligned16(out) && aligned16(k) && aligned16(v);
  a.row_stride = row_stride;
  a.tok_stride = tok_stride;
  a.scale_row_stride = scale_row_stride;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = q_dtype == 0 ? launch_kv<float>(kv_dtype, a, st)
                     : launch_kv<__nv_bfloat16>(kv_dtype, a, st);
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
