// The greedy NMS sweep of SSD's detection tail, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this sweep as one
// lax.fori_loop inside a jitted program (incubator_mxnet_tpu/ops/contrib.py
// :: box_nms and _multibox_detection_body), after box_nms has built the
// whole (n, n) IoU matrix. Run eagerly, that loop would cost a few launches
// a row, tens of thousands for SSD300's 8732 anchors. It computes what
// incubator_mxnet_tpu_torch/ops/contrib.py :: nms_sweep_ref computes:
//
//   for i in 0 .. A-1, in order:
//     if keep[i]: for every j > i with keep[j] (and ids[j] == ids[i]):
//       if iou(box i, box j) > thresh: keep[j] = 0
//
// over rows already sorted by score.
//
// Exactness: the keep set must be the plain version's bit for bit, and an
// IoU compared against a threshold flips a row at one ulp. So the IoU is
// PyTorch's op by op: each product, sum and quotient rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, which the compiler never
// contracts into a fused multiply-add), in box_iou's order.
//
// What bounds it on the card: the chain. Row i's test needs the keep flags
// that rows before it left, so the rows resolve one after another; the
// operations the sweep needs (a test for each later alive row of each kept
// row) sit far below the card's rate. The design takes the tests off the
// chain, as the JAX package's IoU matrix does, packed into bits:
//
//   nms_mask_kernel, over the whole card: for each image, each row i alive
//     at the start and each 64-row word w holding rows after i, one 64-bit
//     word whose bit t is set where row j = 64 w + t lies after i, has row
//     i's class (when ids are given) and iou(i, j) > thresh. A block takes
//     64 rows and walks their words 8 at a time, the 512 column boxes (and
//     their areas and ids) staged in shared memory. Comparisons alone pick
//     the pairs whose boxes overlap; the IoU runs on those only. Rows dead
//     at the start write nothing (the sweep never reads their words), and
//     columns dead at the start take no IoU.
//   nms_resolve_kernel, one block an image: walk the 64-row blocks in
//     order. Warp 0 resolves a block's rows (a row is kept if it was alive
//     at the start and no kept row before it removes it) from their
//     diagonal words and the removed bits so far, as a fixed point of warp
//     reductions, and folds the block's kept rows into the next word
//     itself; the other 31 warps fold the previous block's kept rows into
//     the words after that, a word a warp. Every load is issued a step
//     before it is used. One block barrier a 64-row block, none a row.
//
// The mask lives in a workspace the caller allocates: (images, words, A)
// 64-bit words, word w of row i at [w][i], so a warp's 32 rows write 256
// contiguous bytes and a block's kept rows of one word lie within 512.
//
// The caller guarantees: boxes (B, A, 4) float32 and ids (B, A) float32
// contiguous, keep (B, A) one byte a row (0 or 1), mask B * ceil(A / 64) *
// A 64-bit words, all on one device.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaskThreads = 256;                  // a warp a word
constexpr int kMaskWords = kMaskThreads / 32;      // words a step
constexpr int kMaskCols = 64 * kMaskWords;         // columns a step
constexpr int kMaskBlocks = 3;                     // resident a SM, at least
constexpr int kResolveThreads = 1024;              // warp 0 + 31 ORing
constexpr int kOrWarps = kResolveThreads / 32 - 1;
constexpr int kGroup = 5;                          // words a warp loads ahead
constexpr int kMaxSmem = 232448;  // also keeps the row blocks under 65536

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// box_iou's value: intersection over union, 0 where the union is not
// positive
__device__ __forceinline__ float iou(float4 a, float area_a, float4 b,
                                     float area_b) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// a box with positive width and height (false where a coordinate is NaN)
__device__ __forceinline__ bool proper(float4 b) {
  return b.z > b.x && b.w > b.y;
}

// grid (images, row blocks): the heaviest row blocks (the first, whose
// rows meet the most later ones) of every image start first. Lane
// l of warp c takes rows 64 rb + l and 64 rb + 32 + l of the block and
// word w0 + c of the step, so each column box read from shared memory
// serves two rows.
//
// Which pairs need the IoU: two proper boxes intersect in a positive area
// iff each one's max edge lies past the other's min edge (a difference of
// two floats is positive iff the first is larger: no flush to zero here).
// Every other pair's IoU is 0 in box_iou's arithmetic: its width or
// height clamps to 0 (an improper box's own extent bounds the overlap),
// or a NaN makes the union NaN and the where() gives 0. So a word is
// built in two passes: comparisons over all 64 columns give the
// candidates, the IoU (op by op) runs on the candidates alone, and every
// other column of the row's class hits iff 0 > thresh. A column dead at
// the start is no candidate either: no kept row's bit for it is ever read.
template <bool kIds>
__global__ void __launch_bounds__(kMaskThreads, kMaskBlocks)
nms_mask_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ ids,
                const uint8_t* __restrict__ keep, u64* __restrict__ mask,
                int A, int n_words, float thresh) {
  __shared__ float4 col_box[kMaskCols];
  __shared__ float4 col_test[kMaskCols];  // NaN: improper, or dead
  __shared__ float col_area[kMaskCols];
  __shared__ float col_id[kMaskCols];
  const long long img = blockIdx.x;
  const float4* bx = boxes + img * A;
  const float* id = kIds ? ids + img * A : nullptr;
  u64* mk = mask + img * n_words * (long long)A;
  const int rb = blockIdx.y;
  const int lane = threadIdx.x % 32, c = threadIdx.x / 32;
  int row[2];
  bool live[2], pi[2];
  float4 bi[2];
  float ai[2], idi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = rb * 64 + 32 * h + lane;
    live[h] = row[h] < A && keep[img * A + row[h]];
    bi[h] = live[h] ? __ldg(bx + row[h]) : make_float4(0.f, 0.f, 0.f, 0.f);
    ai[h] = area(bi[h]);
    pi[h] = proper(bi[h]);
    idi[h] = kIds && live[h] ? __ldg(id + row[h]) : 0.f;
  }
  // a block none of whose rows is alive has nothing to write
  if (!__syncthreads_or(live[0] || live[1])) return;
  const bool zero_hits = 0.f > thresh;
  for (int w0 = rb; w0 < n_words; w0 += kMaskWords) {
    __syncthreads();  // the last step's column boxes are read
    for (int q = threadIdx.x; q < kMaskCols; q += kMaskThreads) {
      const int j = w0 * 64 + q;
      if (j < A) {
        const float4 bj = __ldg(bx + j);
        col_box[q] = bj;
        col_test[q] = proper(bj) && keep[img * A + j]
                          ? bj
                          : make_float4(NAN, NAN, NAN, NAN);
        col_area[q] = area(bj);
        col_id[q] = kIds ? __ldg(id + j) : 0.f;
      }
    }
    __syncthreads();
    const int w = w0 + c;
    if (w >= n_words) continue;
    const float4* ct = col_test + c * 64;
    const float* cid = col_id + c * 64;
    unsigned cand[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll 8
      for (int t = 0; t < 32; ++t) {
        const float4 b = ct[32 * half + t];
        const float bid = kIds ? cid[32 * half + t] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool x = b.z > bi[h].x && bi[h].z > b.x && b.w > bi[h].y &&
                         bi[h].w > b.y && (!kIds || bid == idi[h]);
          cand[h][half] |= x ? 1u << t : 0u;
        }
      }
    // columns of word w inside the image
    const int tn = min(64, A - w * 64);
    const u64 inside = tn >= 64 ? ~0ull : (1ull << tn) - 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live[h]) continue;
      // and after the row
      const int t0 = w == rb ? 32 * h + lane + 1 : 0;
      const u64 range = (t0 >= 64 ? 0ull : ~0ull << t0) & inside;
      u64 cb = pi[h] ? (((u64)cand[h][1] << 32) | cand[h][0]) & range : 0;
      u64 bits = 0;
      if (zero_hits) {
        u64 same = 0;
        for (int t = 0; t < 64; ++t)
          if (!kIds || cid[t] == idi[h]) same |= 1ull << t;
        bits = same & range & ~cb;
      }
      while (cb) {
        const int t = __ffsll((long long)cb) - 1;
        cb &= cb - 1;
        if (iou(bi[h], ai[h], col_box[c * 64 + t], col_area[c * 64 + t]) >
            thresh)
          bits |= 1ull << t;
      }
      mk[(long long)w * A + row[h]] = bits;
    }
  }
}

// One block an image; dynamic shared memory: n_words removed-bit words.
// Step s: warp 0 resolves block s from its diagonal words and removed[s] |
// the cross term of block s - 1, then reduces the cross term of block s
// into word s + 1; meanwhile warps 1-31 fold block s - 1's kept rows into
// words s + 1 onwards (a word a warp, rows 64 (s - 1) + lane and + 32 + lane
// in each lane) from words they loaded a step before, and load block s's.
// So no load waits on the chain: warp 0's words are loaded a step ahead
// too. One barrier a step: removed[s + 1] and the kept rows of block s are
// complete when they are read.
//
// Resolving a block: the kept set K is the fixed point of
// K = cand & ~OR_{k in K} diag[k] (cand: alive and not removed), unique
// because a row's diagonal word holds later rows only (bit j of the right
// side depends on bits < j of K). Iterating from K = cand fixes one more
// leading bit each time at worst, and a repeat is that fixed point: a
// greedy run in a few rounds of two warp reductions, not a step a row.
__global__ void __launch_bounds__(kResolveThreads)
nms_resolve_kernel(const u64* __restrict__ mask, uint8_t* keep, int A,
                   int n_words) {
  extern __shared__ u64 removed[];
  __shared__ u64 kept_word[2];
  const long long img = blockIdx.x;
  const u64* mk = mask + img * n_words * (long long)A;
  uint8_t* kp = keep + img * A;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int w = threadIdx.x; w < n_words; w += kResolveThreads)
    removed[w] = 0;
  auto load_row = [&](int w, int row) -> u64 {
    return w < n_words && row < A ? mk[(long long)w * A + row] : 0ull;
  };
  auto or_all = [](u64 v) -> u64 {
    return ((u64)__reduce_or_sync(0xffffffffu, (unsigned)(v >> 32)) << 32) |
           __reduce_or_sync(0xffffffffu, (unsigned)v);
  };
  // warp 0: block s's alive flags and diagonal words, the words of block
  // s's rows in word s + 1, the cross term into word s. Warps 1-31: block
  // b's rows (lane, 32 + lane) in words b + 2 + (warp - 1) + kOrWarps u.
  bool a0 = false, a1 = false;
  u64 d0 = 0, d1 = 0, c0 = 0, c1 = 0, cross = 0;
  u64 x0[kGroup], x1[kGroup];
  auto load_group = [&](int b) {
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int w = b + 1 + warp + kOrWarps * u;
      x0[u] = load_row(w, 64 * b + lane);
      x1[u] = load_row(w, 64 * b + 32 + lane);
    }
  };
  if (warp == 0) {
    a0 = lane < A && kp[lane];
    a1 = 32 + lane < A && kp[32 + lane];
    d0 = load_row(0, lane);
    d1 = load_row(0, 32 + lane);
    c0 = load_row(1, lane);
    c1 = load_row(1, 32 + lane);
  } else {
    load_group(0);
  }
  __syncthreads();
  for (int s = 0; s < n_words; ++s) {
    const int base = s * 64;
    if (warp == 0) {
      // the next block's flags and words, in flight during this step
      const int n0 = base + 64 + lane, n1 = base + 96 + lane;
      const bool na0 = n0 < A && kp[n0], na1 = n1 < A && kp[n1];
      const u64 nd0 = load_row(s + 1, n0), nd1 = load_row(s + 1, n1);
      const u64 nc0 = load_row(s + 2, n0), nc1 = load_row(s + 2, n1);
      const u64 alive = (u64)__ballot_sync(0xffffffffu, a0) |
                        ((u64)__ballot_sync(0xffffffffu, a1) << 32);
      const u64 cand = alive & ~(removed[s] | cross);
      u64 kept = cand;
      while (true) {
        const u64 next = cand & ~or_all(((kept >> lane) & 1 ? d0 : 0ull) |
                                        ((kept >> (32 + lane)) & 1 ? d1
                                                                   : 0ull));
        if (next == kept) break;
        kept = next;
      }
      const bool k0 = (kept >> lane) & 1, k1 = (kept >> (32 + lane)) & 1;
      if (base + lane < A) kp[base + lane] = k0;
      if (base + 32 + lane < A) kp[base + 32 + lane] = k1;
      if (lane == 0) kept_word[s & 1] = kept;
      // block s's kept rows into word s + 1
      cross = or_all((k0 ? c0 : 0ull) | (k1 ? c1 : 0ull));
      a0 = na0;
      a1 = na1;
      d0 = nd0;
      d1 = nd1;
      c0 = nc0;
      c1 = nc1;
    } else if (s >= 1) {
      // block b = s - 1's kept rows into words s + 1 onwards
      const int b = s - 1;
      const u64 kept = kept_word[b & 1];
      const bool k0 = (kept >> lane) & 1, k1 = (kept >> (32 + lane)) & 1;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int w = b + 1 + warp + kOrWarps * u;
        const u64 v = or_all((k0 ? x0[u] : 0ull) | (k1 ? x1[u] : 0ull));
        if (lane == 0 && w < n_words) removed[w] |= v;
      }
      // words past the loaded group (more than kOrWarps kGroup words on)
      for (int w = b + 1 + warp + kOrWarps * kGroup; kept && w < n_words;
           w += kOrWarps) {
        const u64 v = or_all((k0 ? load_row(w, 64 * b + lane) : 0ull) |
                             (k1 ? load_row(w, 64 * b + 32 + lane) : 0ull));
        if (lane == 0) removed[w] |= v;
      }
      load_group(s);   // block s's rows, folded next step
    }
    __syncthreads();
  }
}

}  // namespace

// boxes (B, A, 4) float32, ids (B, A) float32 or null (every row one
// class), keep (B, A) bytes, read as the rows alive at the start and
// written with the rows kept, mask the workspace of B * ceil(A / 64) * A
// 64-bit words. B >= 1, A >= 1. Two kernels on `stream`; returns
// cudaGetLastError() after the launches (0 on success), never synchronises.
extern "C" int mx_nms_sweep(int device, const void* boxes, const void* ids,
                            void* keep, void* mask, int B, int A,
                            float thresh, void* stream) {
  if (B <= 0 || A <= 0 || mask == nullptr) return (int)cudaErrorInvalidValue;
  const int n_words = (A + 63) / 64;
  const size_t smem = (size_t)n_words * sizeof(u64);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(nms_resolve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess) {
    auto kern = ids ? nms_mask_kernel<true> : nms_mask_kernel<false>;
    kern<<<dim3(B, n_words), kMaskThreads, 0, st>>>(
        static_cast<const float4*>(boxes), static_cast<const float*>(ids),
        static_cast<const uint8_t*>(keep), static_cast<u64*>(mask), A,
        n_words, thresh);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    nms_resolve_kernel<<<B, kResolveThreads, smem, st>>>(
        static_cast<const u64*>(mask), static_cast<uint8_t*>(keep), A,
        n_words);
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
