// Paged decode / verify / chunk attention over the slotted KV slab, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel incubator_mxnet_tpu/ops/pallas_kernels.py ::
// paged_attention_fwd (_paged_attn_kernel), both its float variant and its
// quantized one (int8 codes with per-position f32 scales, the dequant at
// pallas_kernels.py:246-248). It computes what
// incubator_mxnet_tpu_torch/ops/fused.py :: paged_attention_ref computes:
//
//   out[s, j, h] = softmax_t(q[s,j,h] . k'[s,l,t,h] / sqrt(d)) . v'[s,l,t,h]
//                  over t <= len_s + j and t < T_ext,
//   k' = k (float slabs) or float(code_k) * k_scale[s,l,t] (int8 slabs),
//
// with f32 arithmetic inside and the output in q's dtype. q and out are
// float32, bfloat16 or float16; the slab is float32, bfloat16, float16 or
// int8, independent of q's type. Lane s reads row s of the slab; the slab and the scales may be
// views (the engine's `extent` slice keeps the full slab's strides), so rows
// and positions are addressed by strides.
//
// What bounds it on the card: the live KV bytes it must read,
// sum_s min(T, len_s + C) * H * d * 2 * itemsize (plus 2 * 4 bytes a
// position of scales for int8), over 3.35 TB/s; for a long chunk (C = the
// prefill window) the multiply-adds come close too. Three routes, chosen by
// (q dtype, slab dtype, d, C) alone (ops/kernels.py :: paged_route):
//
//   split (C <= 16: decode, the speculative verify, short windows), CUDA
//     cores. Memory-bound, so no tensor cores: each lane's token axis is cut
//     into fixed pieces of kPiece positions from position 0, the grid is
//     (pieces [x slices], H, S), and a block whose piece starts at or past
//     min(T_ext, len + C) exits at once. One block holds all C query rows.
//     Lanes read K/V rows as 16-byte vectors, several loads in flight a
//     thread (the V rows of the piece are prefetched to L2 while K is read),
//     dot products reduce by warp shuffles, and every warp works. Each block
//     writes its partial (max, normaliser, accumulator) in f32 to a
//     workspace; a second kernel combines the pieces in piece order
//     (deterministic) and gives acc / l exactly where a lane has one piece.
//   wgmma (C > 16, 16-bit q of type Tq (bf16 or float16) over a slab of
//     the same type at d % 8 == 0 or an int8 one at d % 16 == 0, d <= 128),
//     tensor cores: 128-row items of one (lane, head), two consumer
//     warpgroups of 64 rows, K/V tiles of 64 positions in a ring of stages.
//     A 16-bit slab comes by TMA from a 4-D tensor map (d, H, T_ext, S) over
//     the layer view; an int8 one is loaded by the producer warpgroup, whose
//     threads write the codes as Tq (exact: codes lie in [-128, 127]) into
//     the swizzled layout TMA would give. S = Q K^T and O += P V by wgmma
//     with f32 accumulators; on int8, S[i, j] = k_scale[j] (q_i . code_k[j])
//     and P'[i, j] = P[i, j] v_scale[j] enters P' code_v, the normaliser
//     summing P before the fold. P (P') enters as two Tq terms (hi + lo). A
//     persistent grid walks the items heaviest first.
//     float16 over int8: P' <= v_scale, and v_scale (absmax / 127) may lie
//     near or under float16's normal range (2^-14), where the lo term (and
//     then hi) underflows. So the rows carry a power-of-two exponent e
//     beside their running max: P' enters as P' 2^e, e chosen from the
//     tile's largest v_scale so that it lands in [2^14, 2^15), and e only
//     ever falls (a fall folds 2^(e_new - e_old) <= 1 into the accumulator's
//     rescale exp(m_old - m_new)); the division by l 2^e undoes it. e
//     depends on the lane's scales alone, so one register a thread serves
//     both its rows, computed while S's wgmma runs: off the softmax's chain.
//     Powers of two scale exactly, so this changes no rounding but the
//     16-bit one. bf16 has f32's exponent range and takes no shift; over a
//     float slab P <= 1 and l >= 1, so neither does float16.
//   cuda_cores (every other chunk case: f32 q or slab, mixed pairs, d off the
//     TMA alignment, d > 128): one 64-row query tile of one (lane, head)
//     reads each K/V tile once, 4 x 4 register micro-tiles as the flash
//     kernel's (tiles.cuh); int8 codes stay int8 in shared memory, the
//     scales applied to S and folded into P as above.
//
// Every tile and piece boundary is a fixed position (multiples of 64 or of
// kPiece from 0), never derived from T_ext, S or H, and a masked position
// adds an exact zero: a read through slab[:, :, :extent] is bit-equal to the
// full-slab read, and a lane's arithmetic does not depend on the lanes or
// heads that share the launch.
//
// Head dims: instances of capacity 32, 64, 128, 256 take the real d at run
// time (columns past d are zero and never stored). Past 256 (any d) a block
// takes a slice of at most 128 output columns of the capacity-128 instance
// (the slice index on grid x), and accumulates q . k over 128-column pieces;
// shared memory and registers do not grow with d, and the scores are
// recomputed once per slice.
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

constexpr int kPiece = 256;       // positions of a split piece
constexpr int kSliceCols = 128;   // output columns of a slice past d = 256
constexpr int kSplitThreads = 128;
constexpr int kSplitRows = 16;    // the most query rows the split route takes
constexpr int kUnroll = 4;        // 16-byte loads in flight a thread and chunk

// 16 bytes of T converted to f32
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

template <>
struct Vec16<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __half* p, float* dst) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __half2* b = reinterpret_cast<const __half2*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __half22float2(b[e]);
      dst[2 * e] = f.x;
      dst[2 * e + 1] = f.y;
    }
  }
};

template <>
struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* p, float* dst) {
    const int4 x = *reinterpret_cast<const int4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[e] = (float)b[e];
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// the 16 bytes at p whose first n (>= 1) elements are in the row: one vector
// load (kVec: every chunk whole and aligned), else element by element with
// zeros past n
template <bool kVec, typename T>
__device__ __forceinline__ uint4 load_raw(const T* p, int n) {
  if constexpr (kVec) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    uint4 r = make_uint4(0, 0, 0, 0);
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < Vec16<T>::N; ++i)
      if (i < n) e[i] = p[i];
    return r;
  }
}

template <typename T>
__device__ __forceinline__ bool vec_ok(const T* p, long long ld, int width) {
  constexpr int N = Vec16<T>::N;
  return ld % N == 0 && width % N == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <bool V>
using Path = std::integral_constant<bool, V>;

// Pointers and sizes of one launch. k, v, k_scale and v_scale point at
// [row 0, layer, position 0]; slab rows and positions are row_stride and
// tok_stride elements apart, scale rows scale_row_stride floats (positions
// contiguous). The scales are null for float slabs, the workspace for the
// routes other than split.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* lengths;
  void* out;
  float* ws_acc;  // split: (S, H, pieces, C, d) partial accumulators
  float* ws_ml;   // split: (S, H, pieces, C, 2) partial max and normaliser
  int S, C, H, T_ext;
  int d;          // the head dim
  int pieces;     // ceil(T_ext / kPiece)
  long long row_stride, tok_stride, scale_row_stride;
};

// ---------------------------------------------------------------------------
// route split: a piece of kPiece positions of one (lane, head[, slice])
// ---------------------------------------------------------------------------
// Lane l of a warp reads chunks (l % G) + G cc (cc < CPL) of row slot l / G:
// a warp covers RPW positions a step, the block NR.
template <typename Tkv, int D>
struct SplitMap {
  static constexpr int N = Vec16<Tkv>::N;      // elements of a chunk
  static constexpr int KV = D / N;             // chunks of a row
  static constexpr int G = KV < 32 ? KV : 32;  // lanes a row
  static constexpr int RPW = 32 / G;           // positions a warp a step
  static constexpr int CPL = KV / G;           // chunks a lane
  static constexpr int NR = 4 * RPW;           // positions a block a step
  static constexpr int E = CPL * N;            // elements a lane
};

// RG: query rows a pass of the P.V phase (1 for decode; 4, with
// ceil(C / 4) passes, otherwise)
template <typename Tq, typename Tkv, int D, int RG, bool kSliced>
__global__ void __launch_bounds__(kSplitThreads)
    paged_split_kernel(const Args a, float scale) {
  using M = SplitMap<Tkv, D>;
  constexpr bool kQuant = std::is_same<Tkv, int8_t>::value;
  constexpr int CM = RG == 1 ? 1 : kSplitRows;   // the most query rows
  constexpr int QR = CM > 4 * RG ? CM : 4 * RG;
  // q rows (one column piece) in the score phase, the four warps' partial
  // accumulators in the P.V phase
  __shared__ __align__(16) float sq[QR * D];
  __shared__ float ss[CM][kPiece];  // scores, then P (P' on int8)

  const int n_sl = kSliced ? (a.d + D - 1) / D : 1;
  const int piece = blockIdx.x / n_sl;
  const int col0 = kSliced ? (blockIdx.x % n_sl) * D : 0;
  const int width = kSliced ? min(D, a.d - col0) : a.d;
  const int h = blockIdx.y, s = blockIdx.z;
  const int C = a.C, H = a.H, hd = a.d;
  const int len = a.lengths[s];
  const int p0 = piece * kPiece;
  const int n_end = min(a.T_ext, len + C);
  if (p0 >= n_end) return;
  const int np = min(kPiece, n_end - p0);  // positions any row here reads
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = lane / M::G, j = lane % M::G;
  const int n_steps = (np + M::NR - 1) / M::NR;
  const long long head = (long long)s * a.row_stride + (long long)h * hd;
  const Tkv* kb = static_cast<const Tkv*>(a.k) + head;
  const Tkv* vb = static_cast<const Tkv*>(a.v) + head;
  const Tq* q = static_cast<const Tq*>(a.q);
  const long long ws_row = ((long long)(s * H + h) * a.pieces + piece) * C;

  // scores: q . k summed over the column pieces [c0, c0 + D) (one piece
  // below capacity 256)
  for (int c0 = 0; c0 < hd; c0 += D) {
    const int w = min(D, hd - c0);
    __syncthreads();  // the last piece's reads of sq are done
    for (int i = tid; i < C * D; i += kSplitThreads) {
      const int c = i / D, e = i % D;
      sq[i] = e < w ? to_f32(q[((long long)(s * C + c) * H + h) * hd + c0 + e])
                    : 0.f;
    }
    __syncthreads();
    auto scores = [&](auto path) {
      constexpr bool kVec = decltype(path)::value;
      for (int st0 = 0; st0 < n_steps; st0 += kUnroll) {
        uint4 raw[kUnroll][M::CPL];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = p0 + (st0 + u) * M::NR + warp * M::RPW + slot;
#pragma unroll
          for (int cc = 0; cc < M::CPL; ++cc) {
            const int e = (j + M::G * cc) * M::N;
            if (t < p0 + np && e < w) {
              const long long off = (long long)t * a.tok_stride + c0 + e;
              raw[u][cc] = load_raw<kVec>(kb + off, w - e);
              if (c0 == 0 && (!kSliced || e < width)) prefetch_l2(vb + off + col0);
            } else {
              raw[u][cc] = make_uint4(0, 0, 0, 0);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = p0 + (st0 + u) * M::NR + warp * M::RPW + slot;
          float kx[M::E];
#pragma unroll
          for (int cc = 0; cc < M::CPL; ++cc)
            Vec16<Tkv>::load(reinterpret_cast<const Tkv*>(&raw[u][cc]),
                             kx + cc * M::N);
          for (int c = 0; c < C; ++c) {
            float dot = 0.f;
#pragma unroll
            for (int cc = 0; cc < M::CPL; ++cc) {
              const float* qr = sq + c * D + (j + M::G * cc) * M::N;
#pragma unroll
              for (int e = 0; e < M::N; e += 4) {
                const float4 x = *reinterpret_cast<const float4*>(qr + e);
                dot = fmaf(kx[cc * M::N + e], x.x, dot);
                dot = fmaf(kx[cc * M::N + e + 1], x.y, dot);
                dot = fmaf(kx[cc * M::N + e + 2], x.z, dot);
                dot = fmaf(kx[cc * M::N + e + 3], x.w, dot);
              }
            }
#pragma unroll
            for (int o = M::G / 2; o > 0; o >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, o);
            if (j == 0 && t < p0 + np) {
              if (c0 == 0) ss[c][t - p0] = dot;
              else ss[c][t - p0] += dot;
            }
          }
        }
      }
    };
    if (vec_ok(kb + c0, a.tok_stride, w)) scores(Path<true>{});
    else scores(Path<false>{});
  }
  __syncthreads();

  // softmax over the piece, one warp a row: S (scaled by k_scale on int8,
  // masked to -inf), its max m and normaliser l = sum P; P' = P v_scale
  const float* ksr = kQuant ? a.k_scale + (long long)s * a.scale_row_stride
                            : nullptr;
  const float* vsr = kQuant ? a.v_scale + (long long)s * a.scale_row_stride
                            : nullptr;
  for (int c = warp; c < C; c += 4) {
    float mx = -INFINITY;
    for (int i = lane; i < np; i += 32) {
      const int t = p0 + i;
      float x = ss[c][i];
      if constexpr (kQuant) x *= ksr[t];
      x = t <= len + c ? x * scale : -INFINITY;
      ss[c][i] = x;
      mx = fmaxf(mx, x);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < np; i += 32) {
      const float p = mx == -INFINITY ? 0.f : expf(ss[c][i] - mx);
      sum += p;
      if constexpr (kQuant) ss[c][i] = p * vsr[p0 + i];
      else ss[c][i] = p;
    }
    sum = warp_sum(sum);
    if (lane == 0 && col0 == 0) {
      a.ws_ml[(ws_row + c) * 2] = mx;
      a.ws_ml[(ws_row + c) * 2 + 1] = sum;
    }
  }

  // P.V over the slice's columns, RG rows a pass
  float* red = sq;
  for (int g0 = 0; g0 < C; g0 += RG) {
    __syncthreads();  // P is in ss; the last pass's sums are read
    float acc[RG][M::E];
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int e = 0; e < M::E; ++e) acc[r][e] = 0.f;
    auto pv = [&](auto path) {
      constexpr bool kVec = decltype(path)::value;
      for (int st0 = 0; st0 < n_steps; st0 += kUnroll) {
        uint4 raw[kUnroll][M::CPL];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = p0 + (st0 + u) * M::NR + warp * M::RPW + slot;
#pragma unroll
          for (int cc = 0; cc < M::CPL; ++cc) {
            const int e = (j + M::G * cc) * M::N;
            raw[u][cc] = t < p0 + np && e < width
                             ? load_raw<kVec>(vb + (long long)t * a.tok_stride +
                                                  col0 + e,
                                              width - e)
                             : make_uint4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = p0 + (st0 + u) * M::NR + warp * M::RPW + slot;
          const bool in = t < p0 + np;
          float vx[M::E];
#pragma unroll
          for (int cc = 0; cc < M::CPL; ++cc)
            Vec16<Tkv>::load(reinterpret_cast<const Tkv*>(&raw[u][cc]),
                             vx + cc * M::N);
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            const float p = in && g0 + r < C ? ss[g0 + r][t - p0] : 0.f;
#pragma unroll
            for (int e = 0; e < M::E; ++e) acc[r][e] = fmaf(p, vx[e], acc[r][e]);
          }
        }
      }
    };
    if (vec_ok(vb + col0, a.tok_stride, width)) pv(Path<true>{});
    else pv(Path<false>{});
    // sum over the warp's position slots, then over the four warps in order
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int e = 0; e < M::E; ++e)
#pragma unroll
        for (int o = M::G; o < 32; o <<= 1)
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    if (slot == 0) {
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int cc = 0; cc < M::CPL; ++cc)
#pragma unroll
          for (int e = 0; e < M::N; ++e)
            red[(warp * RG + r) * D + (j + M::G * cc) * M::N + e] =
                acc[r][cc * M::N + e];
    }
    __syncthreads();
    for (int i = tid; i < RG * D; i += kSplitThreads) {
      const int r = i / D, e = i % D;
      if (g0 + r < C && e < width) {
        const float x = ((red[r * D + e] + red[(RG + r) * D + e]) +
                         red[(2 * RG + r) * D + e]) +
                        red[(3 * RG + r) * D + e];
        a.ws_acc[(ws_row + g0 + r) * hd + col0 + e] = x;
      }
    }
  }
}

// the split route's second kernel: one block per output row (s, c, h),
// the pieces that ran combined in piece order
template <typename Tq>
__global__ void __launch_bounds__(128) paged_combine_kernel(const Args a) {
  const int h = blockIdx.x % a.H;
  const int sc = blockIdx.x / a.H;
  const int c = sc % a.C, s = sc / a.C;
  const int n_end = min(a.T_ext, a.lengths[s] + a.C);
  const int live = (n_end + kPiece - 1) / kPiece;
  const long long row0 = (long long)(s * a.H + h) * a.pieces * a.C + c;
  float mx = -INFINITY;
  for (int p = 0; p < live; ++p)
    mx = fmaxf(mx, a.ws_ml[(row0 + (long long)p * a.C) * 2]);
  float l = 0.f;
  for (int p = 0; p < live; ++p) {
    const long long r = row0 + (long long)p * a.C;
    l = fmaf(expf(a.ws_ml[r * 2] - mx), a.ws_ml[r * 2 + 1], l);
  }
  Tq* out = static_cast<Tq*>(a.out) +
            ((long long)(s * a.C + c) * a.H + h) * a.d;
  for (int e = threadIdx.x; e < a.d; e += blockDim.x) {
    float x = 0.f;
    for (int p = 0; p < live; ++p) {
      const long long r = row0 + (long long)p * a.C;
      x = fmaf(expf(a.ws_ml[r * 2] - mx), a.ws_acc[r * a.d + e], x);
    }
    store(out + e, x / l);
  }
}

// ---------------------------------------------------------------------------
// route cuda_cores: a 64-row query tile of one (lane, head[, slice])
// ---------------------------------------------------------------------------
// rows [row0, row0 + 64) of a strided matrix (rows `ld` elements apart),
// columns [0, width), into a padded tile of capacity D: f32, or the int8
// codes as they are. Rows at or past `rows`, columns at or past width, are
// zero.
template <typename Ts, typename Td, int D, bool kVec>
__device__ __forceinline__ void load_rows_path(const Ts* src, int row0,
                                               int rows, long long ld,
                                               int width, Td* dst) {
  constexpr int N = Vec16<Ts>::N;
  constexpr int PER = D / N;
  for (int c = threadIdx.x; c < kTile * PER; c += kThreads) {
    const int r = c / PER, e = (c % PER) * N;
    const uint4 raw = row0 + r < rows && e < width
                          ? load_raw<kVec>(src + (long long)(row0 + r) * ld + e,
                                           width - e)
                          : make_uint4(0, 0, 0, 0);
    Td* o = dst + r * Dims<D>::kLd + e;
    if constexpr (std::is_same<Td, int8_t>::value) {
      uint32_t* w = reinterpret_cast<uint32_t*>(o);  // rows of D + 4 bytes
      w[0] = raw.x;
      w[1] = raw.y;
      w[2] = raw.z;
      w[3] = raw.w;
    } else {
      float f[N];
      Vec16<Ts>::load(reinterpret_cast<const Ts*>(&raw), f);
#pragma unroll
      for (int i = 0; i < N; i += 4)
        *reinterpret_cast<float4*>(o + i) =
            make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
    }
  }
}

template <typename Ts, typename Td, int D>
__device__ __forceinline__ void load_rows(const Ts* src, int row0, int rows,
                                          long long ld, int width, Td* dst) {
  if (vec_ok(src, ld, width))
    load_rows_path<Ts, Td, D, true>(src, row0, rows, ld, width, dst);
  else
    load_rows_path<Ts, Td, D, false>(src, row0, rows, ld, width, dst);
}

template <typename Tkv, int D>
struct ChunkSmem {
  using TS = typename std::conditional<std::is_same<Tkv, int8_t>::value,
                                       int8_t, float>::type;
  // sQ (f32), sP, the tile's k and v scales, then sK and sV (TS)
  static constexpr int kBytes = (kTile * Dims<D>::kLd + kTile * kLdS +
                                 2 * kTile) * 4 +
                                2 * kTile * Dims<D>::kLd * (int)sizeof(TS);
};
static_assert(ChunkSmem<float, 256>::kBytes <= 232448, "chunk tiles fit");

template <typename Tq, typename Tkv, int D, bool kSliced>
__global__ void __launch_bounds__(kThreads)
    paged_chunk_kernel(const Args a, float scale) {
  constexpr bool kQuant = std::is_same<Tkv, int8_t>::value;
  using TS = typename ChunkSmem<Tkv, D>::TS;
  constexpr int TD = Dims<D>::kTD;
  constexpr int L = Dims<D>::kLd;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sP = sQ + kTile * L;
  float* sKs = sP + kTile * kLdS;
  float* sVs = sKs + kTile;
  TS* sK = reinterpret_cast<TS*>(sVs + kTile);
  TS* sV = sK + kTile * L;

  const int C = a.C, H = a.H, hd = a.d;
  const int n_sl = kSliced ? (hd + D - 1) / D : 1;
  const int n_qt = (C + kTile - 1) / kTile;
  const int col0 = kSliced ? (blockIdx.x % n_sl) * D : 0;
  const int width = kSliced ? min(D, hd - col0) : hd;
  int item = blockIdx.x / n_sl;
  const int q0 = (item % n_qt) * kTile;
  item /= n_qt;
  const int h = item % H, s = item / H;
  const int len = a.lengths[s];
  const int n_end = min(a.T_ext, len + min(C, q0 + kTile));
  const int nk = (n_end + kTile - 1) / kTile;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const long long head = (long long)s * a.row_stride + (long long)h * hd;
  const Tkv* kb = static_cast<const Tkv*>(a.k) + head;
  const Tkv* vb = static_cast<const Tkv*>(a.v) + head;
  const Tq* qs = static_cast<const Tq*>(a.q) + (long long)s * C * H * hd +
                 (long long)h * hd;  // row i at i * H * hd
  const long long q_ld = (long long)H * hd;

  if constexpr (!kSliced) load_rows<Tq, float, D>(qs, q0, C, q_ld, hd, sQ);
  float m[4], l[4], acc[4][TD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < TD; ++t) acc[i][t] = 0.f;
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's P.V is done with sK, sV, sP
    float sc[4][4] = {};
    if constexpr (kSliced) {
      for (int c0 = 0; c0 < hd; c0 += D) {
        const int w = min(D, hd - c0);
        load_rows<Tq, float, D>(qs + c0, q0, C, q_ld, w, sQ);
        load_rows<Tkv, TS, D>(kb + c0, k0, n_end, a.tok_stride, w, sK);
        __syncthreads();
        tile_dot<D, 4, TS>(sQ, sK, rg, cg, sc);
        __syncthreads();
      }
      load_rows<Tkv, TS, D>(vb + col0, k0, n_end, a.tok_stride, width, sV);
    } else {
      load_rows<Tkv, TS, D>(kb, k0, n_end, a.tok_stride, hd, sK);
      load_rows<Tkv, TS, D>(vb, k0, n_end, a.tok_stride, hd, sV);
    }
    if constexpr (kQuant) {
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const bool in = k0 + i < n_end;
        const long long at = (long long)s * a.scale_row_stride + k0 + i;
        sKs[i] = in ? a.k_scale[at] : 0.f;
        sVs[i] = in ? a.v_scale[at] : 0.f;
      }
    }
    __syncthreads();
    if constexpr (!kSliced) tile_dot<D, 4, TS>(sQ, sK, rg, cg, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      bool on[4];
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j, kj = k0 + c;
        on[j] = qi < C && kj < n_end && kj <= len + qi;
        if constexpr (kQuant) sc[i][j] *= sKs[c];
        sc[i][j] *= scale;
        if (on[j]) mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        const float p = on[j] ? expf(sc[i][j] - m_new) : 0.f;
        sP[(rg * 4 + i) * kLdS + c] = kQuant ? p * sVs[c] : p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < TD; ++t) acc[i][t] *= alpha;
    }
    __syncthreads();
    tile_pm<D, 4, TS>(sP, sV, rg, cg, acc);
  }
  Tq* out = static_cast<Tq*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= C) continue;
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      const int col = out_col<D>(cg, t);
      if (col < width)
        store(out + ((long long)(s * C + qi) * H + h) * hd + col0 + col,
              acc[i][t] / l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// route wgmma: 128 query rows of one (lane, head) on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kPgThreads = 384;   // 2 consumer warpgroups + a producer one
constexpr int kPgRows = 128;      // query rows of a work item (2 x 64)
constexpr int kPgBN = 64;         // positions of a K/V tile
constexpr int kPgStages = 4;      // K/V ring depth
constexpr int kPgMaxGroups = 1024;  // (lane, row tile) groups the walk sorts

template <int D>
struct Pg {
  static constexpr int kAtoms = D / 64;                  // 64-column boxes
  static constexpr int kQBytes = 2 * kAtoms * 8192;      // both warpgroups
  static constexpr int kTileBytes = kAtoms * kPgBN * 128;  // K or V, a stage
  // two Q buffers, the K ring, the V ring, each stage's 64 k and 64 v
  // scales (int8), the walk's weights and order, then the barriers:
  // q_full[2], q_empty[2], full[stages], empty[stages]
  static constexpr int kRing = 2 * kQBytes;
  static constexpr int kStats = kRing + 2 * kPgStages * kTileBytes;
  static constexpr int kWeights = kStats + kPgStages * 2 * kPgBN * 4;
  static constexpr int kOrder = kWeights + kPgMaxGroups * 4;
  static constexpr int kBarOff = kOrder + kPgMaxGroups * 4;
  static constexpr int kSmem = 1024 + kBarOff + 8 * (4 + 2 * kPgStages);
};
static_assert(Pg<128>::kSmem <= 232448, "the paged tensor-core tiles fit");
static_assert(2 * kPgBN == kPgThreads - 256,
              "a producer thread loads one scale of each stage");

// float16 over int8: the bounds of the exponent e (P' enters as P' 2^e),
// so that every 2^e and every fall 2^(e_new - e_old) is a normal f32
constexpr int kShiftMax = 60;
constexpr int kShiftMin = -60;

// the exponent that puts v (> 0) in [2^14, 2^15), within the bounds
__device__ __forceinline__ int shift_for(float v) {
  const int e = 141 - ((__float_as_int(v) >> 23) & 0xff);
  return max(kShiftMin, min(kShiftMax, e));
}

// 2^e for kShiftMin - kShiftMax <= e <= kShiftMax - kShiftMin, exactly
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

// Accumulator fragment of a 64 x N wgmma in a consumer thread (warp w of its
// warpgroup, lane = 4 g + t): register 4 j + e holds row 16 w + g + 8 (e /
// 2), column 8 j + 2 t + (e % 2), as in the flash kernels. Tq is q's and the
// operands' 16-bit type (bf16 or float16).
template <typename Tq, bool kQuant, int D>
__global__ void __launch_bounds__(kPgThreads, 1)
    paged_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const Args a,
                       float scale_log2) {
  using P = Pg<D>;
  // the exponent of P' (see the header): float16 over int8 only
  constexpr bool kShift = kQuant && std::is_same<Tq, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_p = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base;  // Q buffer b: + b kQBytes
  const uint32_t sK = base + P::kRing;
  const uint32_t sV = sK + kPgStages * P::kTileBytes;
  float* const stats = reinterpret_cast<float*>(base_p + P::kStats);
  int* const weights = reinterpret_cast<int*>(base_p + P::kWeights);
  int* const order = reinterpret_cast<int*>(base_p + P::kOrder);
  const uint32_t q_full0 = base + P::kBarOff;
  const uint32_t q_empty0 = q_full0 + 16;
  const uint32_t full0 = q_empty0 + 16;
  const uint32_t empty0 = full0 + 8 * kPgStages;

  const int C = a.C, H = a.H, T = a.T_ext, hd = a.d;
  const int n_rt = (C + kPgRows - 1) / kPgRows;
  const int n_groups = a.S * n_rt;
  const int n_items = n_groups * H;
  const bool sorted = n_groups <= kPgMaxGroups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // K/V tiles of group g = (lane g / n_rt, row tile g % n_rt): positions
  // [0, min(T, len + its last row + 1))
  auto tiles_of = [&](int g) {
    const int q_end = min(C, (g % n_rt + 1) * kPgRows);
    return (min(T, a.lengths[g / n_rt] + q_end) + kPgBN - 1) / kPgBN;
  };
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full0 + 8 * b, 1);
      mbar_init(q_empty0 + 8 * b, 256);
    }
    for (int st = 0; st < kPgStages; ++st) {
      mbar_init(full0 + 8 * st, kQuant ? 128 : 1);
      mbar_init(empty0 + 8 * st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the walk: groups by tiles, most first (ties by index), heads fastest;
  // every block computes the same order
  if (sorted) {
    for (int g = threadIdx.x; g < n_groups; g += kPgThreads)
      weights[g] = tiles_of(g);
    __syncthreads();
    for (int g = threadIdx.x; g < n_groups; g += kPgThreads) {
      const int w = weights[g];
      int rank = 0;
      for (int g2 = 0; g2 < n_groups; ++g2) {
        const int w2 = weights[g2];
        rank += w2 > w || (w2 == w && g2 < g);
      }
      order[rank] = g;
    }
  }
  __syncthreads();
  auto group_of = [&](int item) {
    return sorted ? order[item / H] : item / H;
  };

  if (warp >= 8) {
    // producer warpgroup. Thread 0 loads each item's Q (TMA) into the free
    // Q buffer; the K/V tiles come by TMA (16-bit slabs, thread 0) or from
    // the producer's 128 threads (int8: codes to Tq in the swizzled layout,
    // and the tile's scales). The ring's stage and phase run on across
    // items.
    const int pt = threadIdx.x - 256;
    if (!kQuant && pt != 0) return;
    int st = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x, it = 0; item < n_items;
         item += gridDim.x, ++it) {
      const int g = group_of(item);
      const int h = item % H, s = g / n_rt;
      const int q0 = (g % n_rt) * kPgRows;
      const int nk = tiles_of(g);
      const int b = it & 1;
      if (pt == 0) {
        mbar_wait(q_empty0 + 8 * b, ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full0 + 8 * b, P::kQBytes);
        for (int w = 0; w < 2; ++w)
          for (int at = 0; at < P::kAtoms; ++at)
            tma_load_4d(sQ + b * P::kQBytes + (w * P::kAtoms + at) * 8192,
                        &tm_q, q_full0 + 8 * b, at * 64, h, q0 + 64 * w, s);
      }
      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * kPgBN;
        const uint32_t bar = full0 + 8 * st;
        if constexpr (!kQuant) {
          mbar_wait(empty0 + 8 * st, phase ^ 1);
          mbar_expect_tx(bar, 2 * P::kTileBytes);
          for (int at = 0; at < P::kAtoms; ++at) {
            const uint32_t off = st * P::kTileBytes + at * kPgBN * 128;
            tma_load_4d(sK + off, &tm_k, bar, at * 64, h, k0, s);
            tma_load_4d(sV + off, &tm_v, bar, at * 64, h, k0, s);
          }
        } else {
          // 16 codes (one int4) a task: task c is row r, columns 16 ch ..
          // 16 ch + 15 of K (c < kChunks) or V; a thread's kPer loads and
          // its scale are all issued before it waits for the stage to be
          // free, so they are in flight together
          constexpr int kChunks = kPgBN * (D / 16);
          constexpr int kPer = 2 * kChunks / 128;
          const long long head = (long long)s * a.row_stride +
                                 (long long)h * hd;
          int4 codes[kPer];
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int c = pt + 128 * u;
            const int r = (c % kChunks) / (D / 16);
            const int col = (c % (D / 16)) * 16;
            codes[u] = make_int4(0, 0, 0, 0);
            if (k0 + r < T && col < hd)
              codes[u] = *reinterpret_cast<const int4*>(
                  static_cast<const int8_t*>(c >= kChunks ? a.v : a.k) +
                  head + (long long)(k0 + r) * a.tok_stride + col);
          }
          // one scale a thread: k_scale of position pt, v_scale of pt - 64
          const int ts = k0 + pt % kPgBN;
          const float scl =
              ts < T ? (pt < kPgBN ? a.k_scale : a.v_scale)
                           [(long long)s * a.scale_row_stride + ts]
                     : 0.f;
          mbar_wait(empty0 + 8 * st, phase ^ 1);
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int c = pt + 128 * u;
            const int r = (c % kChunks) / (D / 16);
            const int col = (c % (D / 16)) * 16;
            const int8_t* cb = reinterpret_cast<const int8_t*>(&codes[u]);
            uint32_t w[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              w[e] = Elem16<Tq>::pack((float)cb[2 * e], (float)cb[2 * e + 1]);
            // 128-byte swizzle: the 16-byte chunk c8 of row r sits at
            // c8 ^ (r % 8) of the row's 128 bytes
            uint8_t* row = base_p + P::kRing +
                           (c >= kChunks ? kPgStages * P::kTileBytes : 0) +
                           st * P::kTileBytes + (col / 64) * kPgBN * 128 +
                           r * 128;
            const int c8 = (col % 64) / 8;
            *reinterpret_cast<uint4*>(row + ((c8 ^ (r & 7)) * 16)) =
                make_uint4(w[0], w[1], w[2], w[3]);
            *reinterpret_cast<uint4*>(row + (((c8 + 1) ^ (r & 7)) * 16)) =
                make_uint4(w[4], w[5], w[6], w[7]);
          }
          stats[st * 2 * kPgBN + pt] = scl;
          fence_proxy_async();  // the codes are read by wgmma
          mbar_arrive(bar);
        }
        if (++st == kPgStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: the two warpgroups take turns issuing S = Q K^T (named
  // barriers 1 and 2), as in the flash forward
  const int wg = warp / 4;
  const int g4 = lane / 4, t4 = lane % 4;
  if (wg == 1) named_arrive(1);
  int st = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x, it = 0; item < n_items;
       item += gridDim.x, ++it) {
    const int g = group_of(item);
    const int h = item % H, s = g / n_rt;
    const int q0 = (g % n_rt) * kPgRows;
    const int nk = tiles_of(g);
    const int len = a.lengths[s];
    const int b = it & 1;
    const int wg_first = q0 + 64 * wg;
    const int row0 = wg_first + 16 * (warp % 4) + g4;  // and row0 + 8
    const uint32_t sQw = sQ + b * P::kQBytes + wg * P::kAtoms * 8192;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};  // m in log2 units
    int e = kShiftMax;  // kShift: P' enters as P' 2^e
    float f = pow2(kShiftMax);
    mbar_wait(q_full0 + 8 * b, (it >> 1) & 1);
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kPgBN;
      mbar_wait(full0 + 8 * st, phase);
      const uint32_t sKs = sK + st * P::kTileBytes;
      const uint32_t sVs = sV + st * P::kTileBytes;
      const float* sc = stats + st * 2 * kPgBN;
      float sv[kPgBN / 2];
      named_sync(1 + wg);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns: 32 bytes
        wgmma_ss<kPgBN, Tq>(sv, sw128_desc(sQw + (kk / 4) * 8192 + off, 16),
                           sw128_desc(sKs + (kk / 4) * kPgBN * 128 + off, 16),
                           kk > 0);
      }
      wg_commit();
      named_arrive(2 - wg);
      float g = 1.f;  // kShift: the accumulator's factor for a fall of e
      if constexpr (kShift) {
        // the tile's largest v_scale (0 past T), while the wgmma runs: this
        // thread's 16 columns, then the row's four threads'
        float mv = 0.f;
#pragma unroll
        for (int q = 0; q < kPgBN / 8; ++q)
          mv = fmaxf(mv, fmaxf(sc[kPgBN + 8 * q + 2 * t4],
                               sc[kPgBN + 8 * q + 2 * t4 + 1]));
        mv = fmaxf(mv, __shfl_xor_sync(0xffffffffu, mv, 1));
        mv = fmaxf(mv, __shfl_xor_sync(0xffffffffu, mv, 2));
        if (mv > 0.f) {
          const int e_new = min(e, shift_for(mv));
          g = pow2(e_new - e);
          e = e_new;
          f = pow2(e);
        }
      }
      wg_wait0();
      pin<kPgBN / 2>(sv);

      // the tile needs the mask where it reaches past the warpgroup's first
      // row's last position, or past T
      const bool masked = k0 + kPgBN - 1 > len + wg_first || k0 + kPgBN > T;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kPgBN / 2; ++i) {
        const int c = 8 * (i / 4) + 2 * t4 + (i % 2);
        if constexpr (kQuant) sv[i] *= sc[c];
        if (masked) {
          const int qi = row0 + 8 * ((i % 4) / 2);
          if (!(k0 + c <= len + qi && k0 + c < T)) sv[i] = -INFINITY;
        }
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sv[i]);
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
        if constexpr (kShift) alpha[r] *= g;  // the accumulator's, not l's
      }
      uint32_t p_hi[kPgBN / 16][4], p_lo[kPgBN / 16][4];
#pragma unroll
      for (int kb = 0; kb < kPgBN / 16; ++kb) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kb + 2 * r;  // rows: r even row0, odd row0 + 8
          float x = exp2f(fmaf(sv[i], scale_log2, -m[r % 2]));
          float y = exp2f(fmaf(sv[i + 1], scale_log2, -m[r % 2]));
          l[r % 2] += x + y;
          if constexpr (kShift) {
            const int c = 16 * kb + 8 * (r / 2) + 2 * t4;
            x *= sc[kPgBN + c] * f;
            y *= sc[kPgBN + c + 1] * f;
          } else if constexpr (kQuant) {
            const int c = 16 * kb + 8 * (r / 2) + 2 * t4;
            x *= sc[kPgBN + c];
            y *= sc[kPgBN + c + 1];
          }
          Elem16<Tq>::split(x, y, &p_hi[kb][r], &p_lo[kb][r]);
        }
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i % 4) / 2];
      pin<D / 2>(acc);
      wg_fence();
#pragma unroll
      for (int kb = 0; kb < kPgBN / 16; ++kb)
        wgmma_rs<D, Tq>(acc, p_hi[kb],
                       sw128_desc(sVs + kb * 2048, kPgBN * 128));
#pragma unroll
      for (int kb = 0; kb < kPgBN / 16; ++kb)
        wgmma_rs<D, Tq>(acc, p_lo[kb],
                       sw128_desc(sVs + kb * 2048, kPgBN * 128));
      wg_commit();
      wg_wait0();
      pin<D / 2>(acc);
      mbar_arrive(empty0 + 8 * st);
      if (++st == kPgStages) {
        st = 0;
        phase ^= 1;
      }
    }
    mbar_arrive(q_empty0 + 8 * b);  // this item's S products are done

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if constexpr (kShift) l[r] *= f;  // undo the shift: exact
    }
    Tq* out = static_cast<Tq*>(a.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      if (qi >= C) continue;
      Tq* orow = out + ((long long)(s * C + qi) * H + h) * hd;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col < hd)
          Elem16<Tq>::store2(orow + col, acc[4 * j + 2 * r] / l[r],
                            acc[4 * j + 2 * r + 1] / l[r]);
      }
    }
  }
  if (wg == 0) named_sync(1);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t prepare(K kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename Tq, typename Tkv, int D, bool S>
cudaError_t run_split(const Args& a, float scale, cudaStream_t st) {
  const int n_sl = S ? (a.d + D - 1) / D : 1;
  const dim3 grid(a.pieces * n_sl, a.H, a.S);
  if (a.C == 1)
    paged_split_kernel<Tq, Tkv, D, 1, S>
        <<<grid, kSplitThreads, 0, st>>>(a, scale);
  else
    paged_split_kernel<Tq, Tkv, D, 4, S>
        <<<grid, kSplitThreads, 0, st>>>(a, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_combine_kernel<Tq><<<a.S * a.C * a.H, 128, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename Tq, typename Tkv, int D, bool S>
cudaError_t run_chunk(const Args& a, float scale, cudaStream_t st) {
  auto kern = paged_chunk_kernel<Tq, Tkv, D, S>;
  constexpr int smem = ChunkSmem<Tkv, D>::kBytes;
  const long long n = (long long)a.S * a.H * ((a.C + kTile - 1) / kTile) *
                      (S ? (a.d + D - 1) / D : 1);
  if (n > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)n, kThreads, smem, st>>>(a, scale);
  return cudaGetLastError();
}

// route 0 split, 2 cuda_cores: the capacity instance that holds head dim d,
// or capacity 128's slices past 256
template <typename Tq, typename Tkv>
cudaError_t run_cores(int route, const Args& a, float scale,
                      cudaStream_t st) {
  if (route == 0) {
    if (a.d <= 32) return run_split<Tq, Tkv, 32, false>(a, scale, st);
    if (a.d <= 64) return run_split<Tq, Tkv, 64, false>(a, scale, st);
    if (a.d <= 128) return run_split<Tq, Tkv, 128, false>(a, scale, st);
    if (a.d <= 256) return run_split<Tq, Tkv, 256, false>(a, scale, st);
    return run_split<Tq, Tkv, kSliceCols, true>(a, scale, st);
  }
  if (a.d <= 32) return run_chunk<Tq, Tkv, 32, false>(a, scale, st);
  if (a.d <= 64) return run_chunk<Tq, Tkv, 64, false>(a, scale, st);
  if (a.d <= 128) return run_chunk<Tq, Tkv, 128, false>(a, scale, st);
  if (a.d <= 256) return run_chunk<Tq, Tkv, 256, false>(a, scale, st);
  return run_chunk<Tq, Tkv, kSliceCols, true>(a, scale, st);
}

template <typename Tq>
cudaError_t run_kv(int route, int kv_dtype, const Args& a, float scale,
                   cudaStream_t st) {
  switch (kv_dtype) {
    case 0: return run_cores<Tq, float>(route, a, scale, st);
    case 1: return run_cores<Tq, __nv_bfloat16>(route, a, scale, st);
    case 2: return run_cores<Tq, __half>(route, a, scale, st);
    case 3: return run_cores<Tq, int8_t>(route, a, scale, st);
  }
  return cudaErrorInvalidValue;
}

template <typename Tq, bool kQuant, int D>
cudaError_t run_wgmma(const Args& a, float scale, cudaStream_t st) {
  auto kern = paged_wgmma_kernel<Tq, kQuant, D>;
  constexpr CUtensorMapDataType ty = Elem16<Tq>::kTma;
  const cuuint32_t box[4] = {64, 1, 64, 1};
  // q (S, C, H, d) as the map (d, H, C, S)
  const cuuint64_t q_dims[4] = {(cuuint64_t)a.d, (cuuint64_t)a.H,
                                (cuuint64_t)a.C, (cuuint64_t)a.S};
  const cuuint64_t q_strides[3] = {(cuuint64_t)a.d * 2,
                                   (cuuint64_t)a.H * a.d * 2,
                                   (cuuint64_t)a.C * a.H * a.d * 2};
  CUtensorMap mq, mk, mv;
  if (!tensor_map_bf16(&mq, a.q, 4, q_dims, q_strides, box, ty))
    return cudaErrorInvalidValue;
  mk = mv = mq;
  if (!kQuant) {
    // the layer view (S rows, T_ext positions, H heads, d) as (d, H, T, S)
    const cuuint64_t dims[4] = {(cuuint64_t)a.d, (cuuint64_t)a.H,
                                (cuuint64_t)a.T_ext, (cuuint64_t)a.S};
    const cuuint64_t strides[3] = {(cuuint64_t)a.d * 2,
                                   (cuuint64_t)a.tok_stride * 2,
                                   (cuuint64_t)a.row_stride * 2};
    if (!tensor_map_bf16(&mk, a.k, 4, dims, strides, box, ty) ||
        !tensor_map_bf16(&mv, a.v, 4, dims, strides, box, ty))
      return cudaErrorInvalidValue;
  }
  const long long items =
      (long long)a.S * ((a.C + kPgRows - 1) / kPgRows) * a.H;
  if (items > 2147483647LL) return cudaErrorInvalidValue;
  const int grid = (int)(items < sm_count() ? items : sm_count());
  cudaError_t e = prepare(kern, Pg<D>::kSmem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kPgThreads, Pg<D>::kSmem, st>>>(mq, mk, mv, a,
                                                scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// route wgmma over q's 16-bit type Tq: the int8 or the Tq slab, capacity
// 64 or 128
template <typename Tq>
cudaError_t run_wgmma16(int kv_dtype, const Args& a, float scale,
                        cudaStream_t st) {
  if (kv_dtype == 3)
    return a.d <= 64 ? run_wgmma<Tq, true, 64>(a, scale, st)
                     : run_wgmma<Tq, true, 128>(a, scale, st);
  return a.d <= 64 ? run_wgmma<Tq, false, 64>(a, scale, st)
                   : run_wgmma<Tq, false, 128>(a, scale, st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// route: 0 split (C <= 16), 1 wgmma, 2 cuda_cores (ops/kernels.py ::
// paged_route). q_dtype: 0 float32, 1 bfloat16, 2 float16 (q and out).
// kv_dtype: 0 float32, 1 bfloat16, 2 float16, 3 int8 (the slab; int8 needs
// k_scale and v_scale, f32). The codes are ops/kernels.py :: DTYPE_CODES. q and out are contiguous (S, C, H, D); k and v point at [row 0,
// layer, position 0] of the slab, whose rows and positions are row_stride
// and tok_stride elements apart (heads and dims contiguous); k_scale and
// v_scale point at [row 0, layer, position 0] of the scales, whose rows are
// scale_row_stride floats apart (positions contiguous). lengths is (S,)
// int32 on the device. ws: the split route's f32 workspace of
// S * H * ceil(T_ext / piece) * C * (D + 2) floats (null otherwise). piece
// and slice must be this build's kPiece and kSliceCols (the caller sized ws
// by them). The wgmma route takes bf16 (float16) q over a bf16 (float16)
// slab (D % 8 == 0) or an int8 one (D % 16 == 0), D <= 128, every pointer
// and slab stride 16-byte aligned. S, C, H, T_ext and D are at least 1.
// Returns cudaGetLastError()
// after the launch (0 on success), never synchronises.
extern "C" int mx_paged_attention_fwd(
    int route, int q_dtype, int kv_dtype, int device, const void* q,
    const void* k, const void* v, const void* k_scale, const void* v_scale,
    const void* lengths, void* out, void* ws, int S, int C, int H, int D,
    int T_ext, long long row_stride, long long tok_stride,
    long long scale_row_stride, int piece, int slice, void* stream) {
  if (S <= 0 || C <= 0 || H <= 0 || D < 1 || T_ext < 1 || route < 0 ||
      route > 2 || q_dtype < 0 || q_dtype > 2 || kv_dtype < 0 ||
      kv_dtype > 3 || piece != kPiece || slice != kSliceCols)
    return (int)cudaErrorInvalidValue;
  if ((kv_dtype == 3) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  if (route == 0 && (C > kSplitRows || ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int kv_item = kv_dtype == 0 ? 4 : (kv_dtype == 3 ? 1 : 2);
  if (route == 1 &&
      (q_dtype == 0 || (kv_dtype != q_dtype && kv_dtype != 3) || D > 128 ||
       (D * kv_item) % 16 != 0 || (row_stride * kv_item) % 16 != 0 ||
       (tok_stride * kv_item) % 16 != 0 || !aligned16(q) || !aligned16(out) ||
       !aligned16(k) || !aligned16(v)))
    return (int)cudaErrorInvalidValue;
  Device guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
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
  a.pieces = (T_ext + kPiece - 1) / kPiece;
  a.ws_acc = static_cast<float*>(ws);
  a.ws_ml = ws == nullptr ? nullptr
                          : a.ws_acc + (long long)S * H * a.pieces * C * D;
  a.row_stride = row_stride;
  a.tok_stride = tok_stride;
  a.scale_row_stride = scale_row_stride;
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 1)
    err = q_dtype == 1 ? run_wgmma16<__nv_bfloat16>(kv_dtype, a, scale, st)
                       : run_wgmma16<__half>(kv_dtype, a, scale, st);
  else
    switch (q_dtype) {
      case 0: err = run_kv<float>(route, kv_dtype, a, scale, st); break;
      case 1: err = run_kv<__nv_bfloat16>(route, kv_dtype, a, scale, st); break;
      default: err = run_kv<__half>(route, kv_dtype, a, scale, st);
    }
  return (int)err;
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
