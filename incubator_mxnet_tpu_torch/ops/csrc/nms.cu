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
//     one tile: 64 rows and a range of 8 of their words, the 512 column
//     boxes (and their areas and ids) staged in shared memory. Comparisons
//     alone pick the pairs whose boxes overlap; the IoU runs on those only.
//     Rows dead at the start write nothing (the sweep never reads their
//     words), and columns dead at the start take no IoU.
//   nms_resolve_kernel, one block an image: walk the 64-row blocks in
//     order. Warp 0 resolves a block's rows (a row is kept if it was alive
//     at the start and no kept row before it removes it) from their
//     diagonal words and the removed bits so far, as a fixed point of warp
//     reductions, and folds the block's kept rows into the next word
//     itself; the other 31 warps fold the previous block's kept rows into
//     the words after that, a word a warp. Every load is issued a step
//     before it is used. One block barrier a 64-row block, none a row.
//
// A second convention, for the Faster-RCNN proposal op's sweep
// (incubator_mxnet_tpu_torch/ops/contrib.py :: proposal_sweep_ref; the JAX
// package's proposal sweep, incubator_mxnet_tpu/ops/contrib.py ::
// _proposal_body, again a lax.fori_loop): kPlusOne measures IoU pixel-
// inclusive, as the reference's proposal op does. Every width and height
// is (x2 - x1) + 1, the overlap's clamped at 0 (NaN-propagating max and
// min, as torch.maximum and jnp.maximum), and the quotient inter / ((a_i +
// a_j) - inter) has no guard: x / 0 is inf and 0 / 0 NaN, as on the CPU.
// There are no class ids. Its prefilter: a pair is a candidate where its
// overlap's (x2 - x1) + 1 and (y2 - y1) + 1, computed as the IoU computes
// them, are both positive. Any other pair's overlap clamps to 0 (or is
// NaN), so its IoU is +-0 or NaN, above no threshold >= 0; under a
// negative threshold the prefilter proves nothing and every later column
// takes the IoU. A box need not be proper here: boxes inverted by less
// than a pixel (rpn_min_size 0) still have a positive + 1 extent.
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
constexpr int kMaskWords = kMaskThreads / 32;      // words a tile
constexpr int kMaskCols = 64 * kMaskWords;         // columns a tile
constexpr int kColsAThread = kMaskCols / kMaskThreads;
constexpr int kMaskBlocks = 3;                     // resident a SM, at least
constexpr int kResolveThreads = 1024;              // warp 0 + 31 ORing
constexpr int kOrWarps = kResolveThreads / 32 - 1;
constexpr int kGroup = 5;                          // words a warp loads ahead
constexpr int kMaxSmem = 232448;  // also keeps the row blocks under 65536
static_assert(kMaxSmem / sizeof(u64) <= 65535,
              "the mask grid's y and z extents hold every row block");

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

// torch.maximum / torch.minimum: NaN if either operand is NaN (fmaxf and
// fminf return the other operand)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// the pixel-inclusive extent of the overlap of [lo_a, hi_a] and [lo_b,
// hi_b]: (min(hi) - max(lo)) + 1, not clamped
__device__ __forceinline__ float extent1(float lo_a, float hi_a, float lo_b,
                                         float hi_b) {
  return __fadd_rn(__fsub_rn(min_nan(hi_a, hi_b), max_nan(lo_a, lo_b)), 1.f);
}

// the pixel-inclusive area ((x2 - x1) + 1) ((y2 - y1) + 1), not clamped
__device__ __forceinline__ float area1(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.f));
}

// proposal_sweep_ref's IoU: inter / ((area_a + area_b) - inter), unguarded
__device__ __forceinline__ float iou1(float4 a, float area_a, float4 b,
                                      float area_b) {
  const float iw = max_nan(0.f, extent1(a.x, a.z, b.x, b.z));
  const float ih = max_nan(0.f, extent1(a.y, a.w, b.y, b.w));
  const float inter = __fmul_rn(iw, ih);
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(area_a, area_b), inter));
}

// What bounds the mask pass on the card: where the work lies, not how much
// of it there is. Its pairs are few (proposal's (1, 6000): 17,997,000, a
// few tens of microseconds of the card's issue rate even if each took the
// IoU), but a tile's IoUs run serially in each lane, about 25 us for 8
// words alone on a SM, so the pass lasts as long as the longest chain of
// tiles on one SM. A block that walked a row block to its last word would
// make that chain the first row block's 12 tiles at (1, 6000), on 94 of
// the 132 SMs. So the grid is one block a tile of 8 words:
//
//   grid (images, row blocks, runs of 8 words): block (b, rb, k) takes
//   image b's row block rb and its words rb + 8 k .. rb + 8 k + 7, cut at
//   the last word; a block whose run starts past the last word returns at
//   once. At (1, 6000): 94 row blocks, 94 x 12 = 1,128 blocks, 600 of them
//   tiles; at detect()'s (32, 8732): 137 row blocks, 78,912 blocks, 39,744
//   of them tiles. The waves they take depend on the blocks resident a SM,
//   which __launch_bounds__ only holds at 3 or more; mx_nms_mask_grid reads
//   it from the occupancy calculator (chip_smoke.py phases 13 and 21 log
//   it). On an H100 (sm_90a, 132 SMs) it gives 4 blocks a SM of each
//   kernel (50-64 registers a thread), 528 resident: 2 waves at (1, 6000),
//   76 at (32, 8732). A flat index over the tiles alone needs no empty
//   blocks, but its decode (a search over the row blocks) cost more at
//   (32, 8732) than the empty blocks do.
//
// Blocks run in no order, so a tile carries nothing from another: it loads
// its own rows' boxes, areas and liveness, and its columns'. The column
// loads are issued before the dead-block barrier, so a tile waits for one
// round trip to memory, not two. Each (row, word) is written by exactly
// one tile, at [w][row], by the same arithmetic on the same pairs whatever
// the grid: the words, and so the keep mask, are the same bits.
//
// Lane l of warp c takes rows 64 rb + l and 64 rb + 32 + l of the block
// and word w0 + c of the tile, so each column box read from shared memory
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
// kPlusOne (never with ids): the pixel-inclusive IoU and its prefilter.
template <bool kIds, bool kPlusOne>
__global__ void __launch_bounds__(kMaskThreads, kMaskBlocks)
nms_mask_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ ids,
                const uint8_t* __restrict__ keep, u64* __restrict__ mask,
                int A, int n_words, float thresh) {
  __shared__ float4 col_box[kMaskCols];
  __shared__ float4 col_test[kMaskCols];  // NaN: improper, or dead
  __shared__ float col_area[kMaskCols];
  __shared__ float col_id[kMaskCols];
  // the tile: image img, row block rb, words w0 .. w0 + kMaskWords - 1
  const long long img = blockIdx.x;
  const int rb = blockIdx.y;
  const int w0 = rb + blockIdx.z * kMaskWords;
  if (w0 >= n_words) return;
  const float4* bx = boxes + img * A;
  const float* id = kIds ? ids + img * A : nullptr;
  u64* mk = mask + img * n_words * (long long)A;
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
    ai[h] = kPlusOne ? area1(bi[h]) : area(bi[h]);
    pi[h] = proper(bi[h]);
    idi[h] = kIds && live[h] ? __ldg(id + row[h]) : 0.f;
  }
  // the tile's columns, in flight with the rows
  float4 bc[kColsAThread];
  bool kc[kColsAThread];
  float idc[kColsAThread];
#pragma unroll
  for (int u = 0; u < kColsAThread; ++u) {
    const int j = w0 * 64 + threadIdx.x + kMaskThreads * u;
    bc[u] = j < A ? __ldg(bx + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    kc[u] = j < A && keep[img * A + j];
    idc[u] = kIds && j < A ? __ldg(id + j) : 0.f;
  }
  // a block none of whose rows is alive has nothing to write
  if (!__syncthreads_or(live[0] || live[1])) return;
  const bool zero_hits = 0.f > thresh;
#pragma unroll
  for (int u = 0; u < kColsAThread; ++u) {
    const int q = threadIdx.x + kMaskThreads * u;
    if (w0 * 64 + q < A) {
      col_box[q] = bc[u];
      col_test[q] = (kPlusOne || proper(bc[u])) && kc[u]
                        ? bc[u]
                        : make_float4(NAN, NAN, NAN, NAN);
      col_area[q] = kPlusOne ? area1(bc[u]) : area(bc[u]);
      col_id[q] = idc[u];
    }
  }
  __syncthreads();
  const int w = w0 + c;
  if (w >= n_words) return;
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
        const bool x =
            kPlusOne ? extent1(bi[h].x, bi[h].z, b.x, b.z) > 0.f &&
                           extent1(bi[h].y, bi[h].w, b.y, b.w) > 0.f
                     : b.z > bi[h].x && bi[h].z > b.x && b.w > bi[h].y &&
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
    u64 cb = (((u64)cand[h][1] << 32) | cand[h][0]) & range;
    u64 bits = 0;
    if (kPlusOne) {
      // a negative threshold: the prefilter proves nothing
      if (zero_hits) cb = range;
    } else if (!pi[h]) {
      cb = 0;
    }
    if (!kPlusOne && zero_hits) {
      u64 same = 0;
      for (int t = 0; t < 64; ++t)
        if (!kIds || cid[t] == idi[h]) same |= 1ull << t;
      bits = same & range & ~cb;
    }
    while (cb) {
      const int t = __ffsll((long long)cb) - 1;
      cb &= cb - 1;
      const float4 bj = col_box[c * 64 + t];
      const float aj = col_area[c * 64 + t];
      if ((kPlusOne ? iou1(bi[h], ai[h], bj, aj)
                    : iou(bi[h], ai[h], bj, aj)) > thresh)
        bits |= 1ull << t;
    }
    mk[(long long)w * A + row[h]] = bits;
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

typedef void (*MaskKernel)(const float4*, const float*, const uint8_t*,
                           u64*, int, int, float);

MaskKernel mask_kernel(bool plus_one, bool ids) {
  return plus_one ? nms_mask_kernel<false, true>
         : ids    ? nms_mask_kernel<true, false>
                  : nms_mask_kernel<false, false>;
}

// the mask pass's grid for B images of n_words words: (images, row blocks,
// runs of kMaskWords words), a block a run
dim3 mask_grid(int B, int n_words) {
  return dim3(B, n_words, (n_words + kMaskWords - 1) / kMaskWords);
}

// The two kernels on `stream` for B images of A rows: the mask pass of
// the given convention, then the resolve pass. Returns cudaGetLastError()
// after the launches (0 on success); never synchronises.
int launch_sweep(bool plus_one, int device, const void* boxes,
                 const void* ids, void* keep, void* mask, int B, int A,
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
    mask_kernel(plus_one, ids != nullptr)<<<mask_grid(B, n_words),
                                            kMaskThreads, 0, st>>>(
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

}  // namespace

// boxes (B, A, 4) float32, ids (B, A) float32 or null (every row one
// class), keep (B, A) bytes, read as the rows alive at the start and
// written with the rows kept, mask the workspace of B * ceil(A / 64) * A
// 64-bit words. B >= 1, A >= 1. Two kernels on `stream`; returns
// cudaGetLastError() after the launches (0 on success), never synchronises.
extern "C" int mx_nms_sweep(int device, const void* boxes, const void* ids,
                            void* keep, void* mask, int B, int A,
                            float thresh, void* stream) {
  return launch_sweep(false, device, boxes, ids, keep, mask, B, A, thresh,
                      stream);
}

// mx_nms_sweep's contract under the pixel-inclusive IoU of the proposal
// op, without class ids.
extern "C" int mx_proposal_sweep(int device, const void* boxes, void* keep,
                                 void* mask, int B, int A, float thresh,
                                 void* stream) {
  return launch_sweep(true, device, boxes, nullptr, keep, mask, B, A, thresh,
                      stream);
}

// The mask pass's launch for B images of A rows, as the sweeps make it,
// and what `device` holds of it: out[0..2] the grid (images, row blocks,
// runs of words), out[3] the words a run, out[4] the blocks that hold a
// tile (the others return at once), out[5] the blocks of the convention's
// kernel (plus_one: the proposal op's; else ids: with class ids) resident
// a SM, from the occupancy calculator, out[6] its registers a thread.
// Returns a cudaError_t (0 on success).
extern "C" int mx_nms_mask_grid(int device, int plus_one, int ids, int B,
                                int A, long long* out) {
  if (B <= 0 || A <= 0 || out == nullptr) return (int)cudaErrorInvalidValue;
  const int n_words = (A + 63) / 64;
  const dim3 grid = mask_grid(B, n_words);
  long long tiles = 0;
  for (int rb = 0; rb < n_words; ++rb)
    tiles += (n_words - rb + kMaskWords - 1) / kMaskWords;
  int prev = 0, resident = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const MaskKernel kern = mask_kernel(plus_one != 0, ids != 0);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kern,
                                                      kMaskThreads, 0);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (prev != device) cudaSetDevice(prev);
  if (err != cudaSuccess) return (int)err;
  const long long got[7] = {grid.x, grid.y,   grid.z,      kMaskWords,
                            B * tiles, resident, attr.numRegs};
  for (int i = 0; i < 7; ++i) out[i] = got[i];
  return 0;
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
