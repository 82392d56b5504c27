// The card half of the input pipeline, for Hopper (sm_90a): per-image crop,
// horizontal mirror, 1/255 scale, per-channel mean/std and the cast, in one
// pass over an NHWC batch.
//
// Replaces no TPU kernel: the JAX package computes this chain in jnp
// (incubator_mxnet_tpu/ops/fused.py :: image_augment), which XLA fuses into
// one program. Run eagerly in PyTorch the chain is six kernels, each reading
// and writing the whole batch. It computes what
// incubator_mxnet_tpu_torch/ops/fused.py :: image_augment_ref computes:
//
//   out[n, i, j, c] = cast((v * s - mean[c]) / std[c]),
//   v = x[n, y0[n] + i, x0[n] + (flip[n] ? cw - 1 - j : j), cr == 1 ? 0 : c]
//
// with s = 1/255 for integer x (uint8, int8, int16, int32) and no scale for
// bool (0 or 1) and float32 x, in that order, each step rounded on its own
// (__fmul_rn, __fsub_rn, __fdiv_rn, which the compiler never contracts), as
// PyTorch's separate ops and the JAX package's jnp chain round them; mean
// and std may each be absent, and one of length 1 applies to every
// channel. The channels read, cr, are all C, or the first 3 when the crop
// cuts (lax.dynamic_slice's (ch, cw, 3) window); the output has cout
// channels, the numpy broadcast of cr with the lengths of mean and std (a
// 1-channel image under a 3-entry mean gives 3). An offset is read as
// lax.dynamic_slice reads a start (a negative one from the end, then
// clamped so the crop fits). The cast rounds to nearest even (float32,
// bfloat16 or float16 out).
//
// What bounds it on the card: bytes, (N ch cw cout) (in + out bytes) /
// 3.35 TB/s, about 4.3 us for uint8 to bfloat16 at 32 x 224^2 x 3, and
// close behind them the issue: an element computed directly is a
// conversion, __fmul_rn, __fsub_rn, the IEEE __fdiv_rn and the cast, ~20
// instructions on each of its 4.8 M elements (~3 us of the 132 SMs' issue).
// The first version (a block an output row, a pixel a thread, 1-byte loads
// and 2-byte stores) kept ~11 KB of loads in flight an SM where the rate
// needs ~20 KB. What this design does about it:
//  * A lookup table for 8-bit inputs (route "table": uint8, int8 and bool
//    x, cout <= kTableChannels). Each block first builds
//    table[c][v] = cast(affine(v, c)) for the 256 bit patterns v of each
//    output channel c in shared memory (1.5 KB for bfloat16 at cout 3),
//    with the rounded operations above, so a table read is the direct
//    computation bit for bit by construction. Other types and channel
//    counts compute each element directly (route "direct").
//  * Staged, wide copies. A persistent grid of one wave (kBlocksPerSM
//    blocks of kThreads an SM) walks tiles of whole output rows (or pieces
//    of one row too wide for a stage). Each block brings the input span of
//    each row of its next tile into a kStages-deep ring in shared memory
//    with 16-byte cp.async from the 16-byte-aligned chunks that cover it
//    (a chunk that overhangs the tensor is copied byte by byte), a warp a
//    row, while it computes the tile before. A span of whole rows does not
//    wait for the mirror bit. The mirror and the channel broadcast are
//    resolved on the shared side.
//  * Runs (the 3-channel images the input path feeds, read and written
//    whole, crop width a multiple of the run, 1- or 2-byte items): a
//    thread takes 8 output pixels (4 for float32 out), 48 output bytes.
//    It reads their source span as 32-bit words realigned by funnel
//    shifts; every pixel and channel index is then a constant, the mirror
//    a branch a run, so an element costs a byte extract and a table read
//    (~4 instructions). A warp's 32 runs pass through 1.5 KB of shared
//    memory so that each of its 16-byte stores covers 512 contiguous
//    bytes, not 32 pieces 48 bytes apart.
//  * Other shapes: 16-byte stores over the flat (N, ch, cw, cout) output,
//    a vector a thread, each element's pixel and channel worked out; the
//    elements of a tile before its first and after its last whole vector
//    are stored one by one.
//  * Any data_ptr stages: a view's first chunk overhangs the tensor and is
//    copied byte by byte. Route "scalar", for a pixel too wide to stage
//    (C * item > kStageBytes - 30) or a row of 2^31 or more elements: an
//    element a thread, read straight from device memory.
// What is left (PERF.md §6 row 10): at batch 32 a fixed cost a launch
// (the wave's ramp, a load round trip before the first tile, the table's
// build, the tail) stands beside the bytes.
//
// The caller guarantees: x (N, H, W, C) contiguous, out (N, ch, cw, cout)
// contiguous, ch <= H, cw <= W; y0 and x0 (N,) int32 or null (the centre
// crop is the caller's to pass), flip (N,) bytes or null.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;
constexpr int kStages = 2;
// ops/kernels.py: AUGMENT_TABLE_CHANNELS, AUGMENT_PARAM_CHANNELS,
// AUGMENT_PIXEL_BYTES (= kStageBytes - 30)
constexpr int kTableChannels = 4;
constexpr int kParamChannels = 64;
constexpr int kStageBytes = 12288;    // a tile's staged input, at most
constexpr int kTileOutBytes = 16384;  // a tile's output, about
constexpr int kMaxTileRows = 64;
static_assert(kMaxTileRows <= kThreads, "issue() takes a row a thread");
constexpr int kRunC = 3;              // channels of the runs' path
// the runs' exchange: 48 bytes a lane, in 16-byte vectors
constexpr int kXchg = kThreads * kRunC;

enum Route { kTable = 0, kDirect = 1, kScalar = 2 };

struct Params {
  long long total;       // output elements
  long long tiles;
  long long x_bytes;
  long long rowlen;      // cw * cout
  int H, W, C, ch, cw, cr, cout;
  int rows;              // N * ch
  int pb;                // bytes a pixel: C * item
  int tile_rows;         // rows a tile (1 when a row is cut in pieces)
  int pieces;            // pieces a row
  int piece_px;          // output columns a piece
  int slot_bytes;        // shared bytes a staged row, a multiple of 16
  int lm, ls;            // lengths of mean and std, 0 when absent
  int scale;             // 1: times 1/255 (integer x)
  int runs;              // 1: compute_runs takes the tiles
  const float* far_mean;  // device copies past kParamChannels, else null
  const float* far_std;
  float mean[kParamChannels];
  float stdv[kParamChannels];
};

// the output type's cast, as raw bits
template <typename Out> struct Cast;
template <> struct Cast<float> {
  using Bits = uint32_t;
  __device__ static Bits of(float v) { return __float_as_uint(v); }
};
template <> struct Cast<__nv_bfloat16> {
  using Bits = uint16_t;
  __device__ static Bits of(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <> struct Cast<__half> {
  using Bits = uint16_t;
  __device__ static Bits of(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

// lax.dynamic_slice's start: negative from the end, then clamped into
// [0, size - window]
__device__ __forceinline__ int start(int v, int size, int window) {
  if (v < 0) v += size;
  return min(max(v, 0), size - window);
}

// the chain after the load: 1/255, mean, std, each rounded on its own
__device__ __forceinline__ float affine(float v, const Params& p,
                                       const float* mean, const float* stdv,
                                       int c) {
  if (p.scale) v = __fmul_rn(v, 1.0f / 255.0f);
  if (p.lm) v = __fsub_rn(v, mean[p.lm == 1 ? 0 : c]);
  if (p.ls) v = __fdiv_rn(v, stdv[p.ls == 1 ? 0 : c]);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mean and std in shared memory (or the device copies past
// kParamChannels), for every thread of the block
__device__ __forceinline__ void load_norm(const Params& p, float* s_mean,
                                          float* s_std, const float** mean,
                                          const float** stdv) {
  if (threadIdx.x < kParamChannels) {
    s_mean[threadIdx.x] = p.mean[threadIdx.x];
    s_std[threadIdx.x] = p.stdv[threadIdx.x];
  }
  __syncthreads();
  *mean = p.far_mean ? p.far_mean : s_mean;
  *stdv = p.far_std ? p.far_std : s_std;
}

// A staged row: where its span lies in x and where its pixels lie in the
// stage (source pixel sp, channel ci at base + (sp - s0) * pb + ci * item).
struct RowInfo {
  long long src;   // byte offset in x of the span's first byte
  int len;         // bytes of the span
  int base;        // stage byte of the span's first byte
  int s0;          // the span's first source pixel
  int mirror;
  int pad[2];      // 32 bytes: the regions after the infos stay 16-aligned
};

struct Tile {
  long long r0;    // first output row (n * ch + i)
  long long e0;    // first and one-past-last output element
  long long e1;
  int nrows;
  int j0, j1;      // output columns [j0, j1) of each row
};

__device__ __forceinline__ Tile tile_of(const Params& p, long long t) {
  Tile T;
  if (p.pieces == 1) {
    T.r0 = t * p.tile_rows;
    T.nrows = static_cast<int>(
        min(static_cast<long long>(p.tile_rows), p.rows - T.r0));
    T.j0 = 0;
    T.j1 = p.cw;
  } else {
    T.r0 = t / p.pieces;
    const int q = static_cast<int>(t - T.r0 * p.pieces);
    T.nrows = 1;
    T.j0 = q * p.piece_px;
    T.j1 = min(p.cw, T.j0 + p.piece_px);
  }
  T.e0 = T.r0 * p.rowlen + static_cast<long long>(T.j0) * p.cout;
  T.e1 = (T.r0 + T.nrows - 1) * p.rowlen
         + static_cast<long long>(T.j1) * p.cout;
  return T;
}

// Bring tile T's input spans into a stage: the rows' places first (a
// thread a row), then their 16-byte chunks (a warp a row). Every thread
// of the block calls it.
__device__ void issue(const Params& p, const Tile& T, uint8_t* stage,
                      RowInfo* info, const uint8_t* x, const int* y0,
                      const int* x0, const uint8_t* flip) {
  // a row a thread (T.nrows <= kMaxTileRows < kThreads); a span of whole
  // rows is the same mirrored or not, so its copies do not wait for the
  // mirror bit's load, which lands in the row's place after them
  const int k = threadIdx.x;
  const bool whole = T.j0 == 0 && T.j1 == p.cw;
  int m = 0;
  if (k < T.nrows) {
    const int r = static_cast<int>(T.r0) + k;
    const int n = r / p.ch;
    const int i = r - n * p.ch;
    const int oy = y0 ? start(__ldg(y0 + n), p.H, p.ch) : 0;
    const int ox = x0 ? start(__ldg(x0 + n), p.W, p.cw) : 0;
    if (flip) m = __ldg(flip + n);
    int s0 = 0;   // the span's source pixels [s0, s0 + j1 - j0)
    if (!whole) s0 = m ? p.cw - T.j1 : T.j0;
    RowInfo& ri = info[k];
    ri.src = ((static_cast<long long>(n) * p.H + oy + i) * p.W + ox + s0)
             * p.pb;
    ri.len = (T.j1 - T.j0) * p.pb;
    ri.base = k * p.slot_bytes
              + static_cast<int>((reinterpret_cast<uintptr_t>(x) + ri.src)
                                 & 15);
    ri.s0 = s0;
  }
  __syncthreads();
  const uintptr_t xb = reinterpret_cast<uintptr_t>(x);
  const uintptr_t xe = xb + static_cast<uintptr_t>(p.x_bytes);
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < T.nrows; row += kThreads / 32) {
    const uintptr_t a = xb + static_cast<uintptr_t>(info[row].src);
    const uintptr_t a0 = a & ~static_cast<uintptr_t>(15);
    const int chunks = static_cast<int>(
        (a + static_cast<uintptr_t>(info[row].len) - a0 + 15) >> 4);
    uint8_t* slot = stage + row * p.slot_bytes;
    for (int q = lane; q < chunks; q += 32) {
      const uintptr_t g = a0 + (static_cast<uintptr_t>(q) << 4);
      uint8_t* dst = slot + (q << 4);
      if (g >= xb && g + 16 <= xe) {
        cp_async16(dst, reinterpret_cast<const void*>(g));
      } else {   // the allocation's first or last bytes
        for (int b = 0; b < 16; ++b)
          if (g + b >= xb && g + b < xe)
            dst[b] = *reinterpret_cast<const uint8_t*>(g + b);
      }
    }
  }
  if (k < T.nrows) info[k].mirror = m;
}

// `count` output elements from element e of tile T, into vals
template <typename In, typename Out, bool kUseTable>
__device__ __forceinline__ void elements(
    const Params& p, const Tile& T, const uint8_t* stage,
    const RowInfo* info, const typename Cast<Out>::Bits* table,
    const float* mean, const float* stdv, long long e, int count,
    typename Cast<Out>::Bits* vals) {
  const int rowlen = static_cast<int>(p.rowlen);
  const int l = static_cast<int>(e - T.r0 * p.rowlen);
  int k = l / rowlen;
  const int q = l - k * rowlen;
  int j = q / p.cout;
  int c = q - j * p.cout;
  int base = info[k].base;
  int s0 = info[k].s0;
  int mirror = info[k].mirror;
#pragma unroll
  for (int u = 0; u < 16 / static_cast<int>(sizeof(vals[0])); ++u) {
    if (u >= count) break;
    const int sp = mirror ? p.cw - 1 - j : j;
    const int ci = p.cr == 1 ? 0 : c;
    const uint8_t* src = stage + base + (sp - s0) * p.pb
                         + ci * static_cast<int>(sizeof(In));
    if (kUseTable)
      vals[u] = table[(c << 8) | *src];
    else
      vals[u] = Cast<Out>::of(affine(
          static_cast<float>(*reinterpret_cast<const In*>(src)), p, mean,
          stdv, c));
    if (++c == p.cout) {
      c = 0;
      if (++j == p.cw) {
        j = 0;
        if (++k < T.nrows) {
          base = info[k].base;
          s0 = info[k].s0;
          mirror = info[k].mirror;
        }
      }
    }
  }
}

// The element of type In at compile-time byte `idx` of a word array
template <typename In>
__device__ __forceinline__ In extract(const uint32_t* B, int idx) {
  static_assert(sizeof(In) <= 2, "runs read 1- and 2-byte items");
  const uint32_t w = B[idx >> 2] >> ((idx & 3) * 8);
  if constexpr (sizeof(In) == 1)
    return static_cast<In>(static_cast<uint8_t>(w));
  else
    return static_cast<In>(static_cast<uint16_t>(w));
}

// A run's kP pixels of kRunC channels, read from its realigned span B in
// mirrored or plain pixel order; every index is a constant.
template <typename In, typename Out, bool kUseTable, bool kMirror, int kP>
__device__ __forceinline__ void fill_run(
    const Params& p, const uint32_t* B,
    const typename Cast<Out>::Bits* table, const float* mean,
    const float* stdv, typename Cast<Out>::Bits* vals) {
#pragma unroll
  for (int u = 0; u < kP; ++u) {
#pragma unroll
    for (int c = 0; c < kRunC; ++c) {
      constexpr int kItem = sizeof(In);
      const int idx = ((kMirror ? kP - 1 - u : u) * kRunC + c) * kItem;
      const In v = extract<In>(B, idx);
      if constexpr (kUseTable)
        vals[u * kRunC + c] = (table + (c << 8))[static_cast<uint8_t>(v)];
      else
        vals[u * kRunC + c] = Cast<Out>::of(
            affine(static_cast<float>(v), p, mean, stdv, c));
    }
  }
}

// Tile T in runs: kP output pixels of kRunC channels a thread (48 output
// bytes), read from the run's source span as 32-bit words realigned with
// funnel shifts; the mirror is a branch a run, every pixel and channel
// index a constant. A warp's 32 runs pass through `xchg` (its 1.5 KB of
// shared memory: 16-byte writes 48 bytes apart, which no two lanes of a
// quarter-warp share a bank in) so that each 16-byte store of the warp
// covers 512 contiguous bytes. Taken where the images have kRunC
// channels, read and written all (no cut, no broadcast), the crop width
// is a multiple of kP and the input item is 1 or 2 bytes.
template <typename In, typename Out, bool kUseTable>
__device__ void compute_runs(const Params& p, const Tile& T,
                             const uint8_t* stage, const RowInfo* info,
                             const typename Cast<Out>::Bits* table,
                             const float* mean, const float* stdv,
                             uint4* xchg, typename Cast<Out>::Bits* out) {
  using Bits = typename Cast<Out>::Bits;
  constexpr int kP = sizeof(Bits) == 2 ? 8 : 4;
  constexpr int kItem = sizeof(In);
  constexpr int kWords = kP * kRunC * kItem / 4 + 1;
  constexpr int kVecs = kP * kRunC * sizeof(Bits) / 16;
  const int per_row = (T.j1 - T.j0) / kP;
  const int runs = T.nrows * per_row;
  // r / per_row as a product: exact for r, per_row < 2^16 (kStageBytes
  // keeps a tile's runs far below); per_row 1 wraps it to 0
  const unsigned magic = 0xFFFFFFFFu / per_row + 1;
  const int lane = threadIdx.x & 31;
  uint4* xs = xchg + (threadIdx.x >> 5) * 32 * kVecs;
  uint4* dst = reinterpret_cast<uint4*>(out + T.e0);
  for (int rb = threadIdx.x & ~31; rb < runs; rb += kThreads) {
    const int r = rb + lane;
    if (r < runs) {
      const int k = per_row == 1 ? r : static_cast<int>(__umulhi(r, magic));
      const int j = T.j0 + (r - k * per_row) * kP;
      const int mirror = info[k].mirror;
      const int sp = mirror ? p.cw - j - kP : j;
      const int s = info[k].base + (sp - info[k].s0) * kRunC * kItem;
      const uint32_t* w =
          reinterpret_cast<const uint32_t*>(stage + (s & ~3));
      const int shift = (s & 3) * 8;
      uint32_t B[kWords - 1];
      uint32_t prev = w[0];
#pragma unroll
      for (int i = 0; i < kWords - 1; ++i) {
        const uint32_t next = w[i + 1];
        B[i] = __funnelshift_r(prev, next, shift);
        prev = next;
      }
      union {
        uint4 u[kVecs];
        Bits b[kP * kRunC];
      } pack;
      if (mirror)
        fill_run<In, Out, kUseTable, true, kP>(p, B, table, mean, stdv,
                                               pack.b);
      else
        fill_run<In, Out, kUseTable, false, kP>(p, B, table, mean, stdv,
                                                pack.b);
#pragma unroll
      for (int i = 0; i < kVecs; ++i) xs[lane * kVecs + i] = pack.u[i];
    }
    __syncwarp();
    const int valid = min(32, runs - rb) * kVecs;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = i * 32 + lane;
      if (v < valid) dst[rb * kVecs + v] = xs[v];
    }
    __syncwarp();
  }
}

// Tile T from its stage: whole 16-byte vectors, then the elements before
// the first and after the last one by one.
template <typename In, typename Out, bool kUseTable>
__device__ void compute(const Params& p, const Tile& T,
                        const uint8_t* stage, const RowInfo* info,
                        const typename Cast<Out>::Bits* table,
                        const float* mean, const float* stdv,
                        typename Cast<Out>::Bits* out) {
  using Bits = typename Cast<Out>::Bits;
  constexpr int kVec = 16 / sizeof(Bits);
  const long long v0 = (T.e0 + kVec - 1) / kVec;
  const long long v1 = T.e1 / kVec;
  for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) {
    union {
      uint4 u;
      Bits b[kVec];
    } pack;
    elements<In, Out, kUseTable>(p, T, stage, info, table, mean, stdv,
                                 v * kVec, kVec, pack.b);
    reinterpret_cast<uint4*>(out)[v] = pack.u;
  }
  const long long h1 = min(v0 * kVec, T.e1);
  const long long t0 = max(v1 * kVec, h1);
  const int nh = static_cast<int>(h1 - T.e0);
  const int nt = static_cast<int>(T.e1 - t0);
  for (int s = threadIdx.x; s < nh + nt; s += kThreads) {
    const long long e = s < nh ? T.e0 + s : t0 + (s - nh);
    Bits b[kVec];
    elements<In, Out, kUseTable>(p, T, stage, info, table, mean, stdv, e,
                                 1, b);
    out[e] = b[0];
  }
}

template <typename In, typename Out, bool kUseTable>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
augment_staged_kernel(const uint8_t* __restrict__ x,
                      const int* __restrict__ y0,
                      const int* __restrict__ x0,
                      const uint8_t* __restrict__ flip,
                      typename Cast<Out>::Bits* __restrict__ out,
                      const __grid_constant__ Params p) {
  using Bits = typename Cast<Out>::Bits;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float s_mean[kParamChannels];
  __shared__ float s_std[kParamChannels];
  const int stage_bytes = p.tile_rows * p.slot_bytes;
  RowInfo* infos = reinterpret_cast<RowInfo*>(smem + kStages * stage_bytes);
  uint4* xchg = reinterpret_cast<uint4*>(infos + kStages * p.tile_rows);
  Bits* table = reinterpret_cast<Bits*>(xchg + (p.runs ? kXchg : 0));
  const float* mean;
  const float* stdv;
  load_norm(p, s_mean, s_std, &mean, &stdv);
  const long long count =
      (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto tile = [&](long long it) {
    return tile_of(p, blockIdx.x + it * gridDim.x);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < count)
      issue(p, tile(s), smem + s * stage_bytes, infos + s * p.tile_rows, x,
            y0, x0, flip);
    cp_async_commit();
  }
  if constexpr (kUseTable) {   // built while the first tile's loads fly
    for (int idx = threadIdx.x; idx < p.cout * 256; idx += kThreads) {
      const In v = static_cast<In>(static_cast<uint8_t>(idx & 255));
      table[idx] = Cast<Out>::of(
          affine(static_cast<float>(v), p, mean, stdv, idx >> 8));
    }
  }
  for (long long it = 0; it < count; ++it) {
    const long long nx = it + kStages - 1;
    if (nx < count) {
      const int sn = static_cast<int>(nx % kStages);
      issue(p, tile(nx), smem + sn * stage_bytes, infos + sn * p.tile_rows,
            x, y0, x0, flip);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int sc = static_cast<int>(it % kStages);
    if constexpr (sizeof(In) <= 2) {
      if (p.runs) {
        compute_runs<In, Out, kUseTable>(p, tile(it), smem + sc * stage_bytes,
                                         infos + sc * p.tile_rows, table,
                                         mean, stdv, xchg, out);
        __syncthreads();
        continue;
      }
    }
    compute<In, Out, kUseTable>(p, tile(it), smem + sc * stage_bytes,
                                infos + sc * p.tile_rows, table, mean, stdv,
                                out);
    __syncthreads();
  }
}

template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
augment_scalar_kernel(const In* __restrict__ x, const int* __restrict__ y0,
                      const int* __restrict__ x0,
                      const uint8_t* __restrict__ flip,
                      typename Cast<Out>::Bits* __restrict__ out,
                      const __grid_constant__ Params p) {
  __shared__ float s_mean[kParamChannels];
  __shared__ float s_std[kParamChannels];
  const float* mean;
  const float* stdv;
  load_norm(p, s_mean, s_std, &mean, &stdv);
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads
                     + threadIdx.x;
       e < p.total; e += step) {
    const long long r = e / p.rowlen;
    const long long q = e - r * p.rowlen;
    const long long j = q / p.cout;
    const int c = static_cast<int>(q - j * p.cout);
    const int n = static_cast<int>(r / p.ch);
    const int i = static_cast<int>(r - static_cast<long long>(n) * p.ch);
    const int oy = y0 ? start(__ldg(y0 + n), p.H, p.ch) : 0;
    const int ox = x0 ? start(__ldg(x0 + n), p.W, p.cw) : 0;
    const long long sp = flip && __ldg(flip + n) ? p.cw - 1 - j : j;
    const In v = x[((static_cast<long long>(n) * p.H + oy + i) * p.W + ox
                    + sp) * p.C + (p.cr == 1 ? 0 : c)];
    out[e] = Cast<Out>::of(affine(static_cast<float>(v), p, mean, stdv, c));
  }
}

// tiles: whole rows while a row's span fits a stage, else pieces of a row
void plan(Params& p, int out_item) {
  const int out_elems = kTileOutBytes / out_item;
  const long long span = static_cast<long long>(p.cw) * p.pb;
  if (span + 30 <= kStageBytes) {
    p.slot_bytes = static_cast<int>((span + 30) / 16 * 16);
    long long rows = out_elems / p.rowlen;
    rows = min(rows, static_cast<long long>(kStageBytes / p.slot_bytes));
    rows = min(rows, static_cast<long long>(kMaxTileRows));
    p.tile_rows = static_cast<int>(max(rows, 1LL));
    p.pieces = 1;
    p.piece_px = p.cw;
    p.tiles = (static_cast<long long>(p.rows) + p.tile_rows - 1)
              / p.tile_rows;
  } else {
    int px = (kStageBytes - 30) / p.pb;
    px = min(px, max(1, out_elems / p.cout));
    if (px >= 16) px &= ~15;
    p.piece_px = px;
    p.pieces = (p.cw + px - 1) / px;
    p.tile_rows = 1;
    p.slot_bytes = (px * p.pb + 30) / 16 * 16;
    p.tiles = static_cast<long long>(p.rows) * p.pieces;
  }
}

template <typename In, typename Out>
cudaError_t launch(int route, const void* x, const int* y0, const int* x0,
                   const uint8_t* flip, void* out, Params& p, int sms,
                   cudaStream_t st) {
  using Bits = typename Cast<Out>::Bits;
  Bits* o = static_cast<Bits*>(out);
  if (route == kScalar) {
    const long long blocks =
        min((p.total + kThreads - 1) / kThreads,
            static_cast<long long>(sms) * 8);
    augment_scalar_kernel<In, Out><<<static_cast<unsigned>(blocks),
                                     kThreads, 0, st>>>(
        static_cast<const In*>(x), y0, x0, flip, o, p);
    return cudaGetLastError();
  }
  plan(p, sizeof(Bits));
  p.runs = sizeof(In) <= 2 && p.C == kRunC && p.cr == kRunC
           && p.cout == kRunC && p.cw % (sizeof(Bits) == 2 ? 8 : 4) == 0;
  const long long blocks =
      min(p.tiles, static_cast<long long>(sms) * kBlocksPerSM);
  size_t smem = static_cast<size_t>(kStages)
                * (static_cast<size_t>(p.tile_rows) * p.slot_bytes
                   + p.tile_rows * sizeof(RowInfo))
                + (p.runs ? kXchg * sizeof(uint4) : 0);
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  if (route == kTable) {
    if constexpr (sizeof(In) == 1) {
      smem += static_cast<size_t>(p.cout) * 256 * sizeof(Bits);
      augment_staged_kernel<In, Out, true>
          <<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
              xb, y0, x0, flip, o, p);
      return cudaGetLastError();
    }
    return cudaErrorInvalidValue;
  }
  augment_staged_kernel<In, Out, false>
      <<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(xb, y0, x0,
                                                              flip, o, p);
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch_out(int out_dtype, int route, const void* x,
                       const int* y0, const int* x0, const uint8_t* flip,
                       void* out, Params& p, int sms, cudaStream_t st) {
  switch (out_dtype) {
    case 0:
      return launch<In, float>(route, x, y0, x0, flip, out, p, sms, st);
    case 1:
      return launch<In, __nv_bfloat16>(route, x, y0, x0, flip, out, p, sms,
                                       st);
    default:
      return launch<In, __half>(route, x, y0, x0, flip, out, p, sms, st);
  }
}

int item_of(int in_dtype) {
  switch (in_dtype) {
    case 0: case 7: return 4;    // float32, int32
    case 6: return 2;            // int16
    case 3: case 4: case 5: return 1;   // int8, uint8, bool
    default: return 0;
  }
}

}  // namespace

// Codes of ops/kernels.py DTYPE_CODES:
// in_dtype: 0 float32, 3 int8, 4 uint8, 5 bool, 6 int16, 7 int32;
// out_dtype: 0 float32, 1 bfloat16, 2 float16.
// route: 0 table, 1 direct, 2 scalar (ops/kernels.py augment_route). x_bytes: the bytes of x. cr: channels read (C, or 3 of
// C >= 3 under a crop that cuts); cout: output channels (cr, or the
// length of mean / std where cr is 1). mean / std: lm / ls floats (0: that
// step is skipped), 1 or cout each; past kParamChannels the host arrays
// give only the first kParamChannels and `far` holds all of mean then all
// of std on the device. N, H, W, C, ch, cw >= 1, ch <= H, cw <= W,
// N * ch < 2^31. Returns cudaGetLastError() after the launch (0 on
// success), never synchronises.
extern "C" int mx_image_augment(int in_dtype, int out_dtype, int route,
                                int device, const void* x, long long x_bytes,
                                const void* y0, const void* x0,
                                const void* flip, void* out, int N, int H,
                                int W, int C, int ch, int cw, int cr,
                                int cout, const float* mean, int lm,
                                const float* std, int ls, const void* far,
                                void* stream) {
  const int item = item_of(in_dtype);
  const bool cut = ch != H || cw != W;
  const bool bytes = in_dtype == 3 || in_dtype == 4 || in_dtype == 5;
  const bool wide = lm > kParamChannels || ls > kParamChannels;
  if (N <= 0 || C <= 0 || ch <= 0 || cw <= 0 || ch > H || cw > W
      || static_cast<long long>(N) * ch >= (1LL << 31) || item == 0
      || out_dtype < 0 || out_dtype > 2 || route < 0 || route > 2
      || cr != (cut ? 3 : C) || C < cr || cout <= 0
      || (cr != 1 && cr != cout) || (lm != 0 && lm != 1 && lm != cout)
      || (ls != 0 && ls != 1 && ls != cout) || (lm && !mean)
      || (ls && !std) || wide != (far != nullptr)
      || (route == kTable && (!bytes || cout > kTableChannels))
      || (route != kScalar
          && (static_cast<long long>(C) * item + 30 > kStageBytes
              || static_cast<long long>(cw) * cout >= (1LL << 31))))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.x_bytes = x_bytes;
  p.H = H;
  p.W = W;
  p.C = C;
  p.ch = ch;
  p.cw = cw;
  p.cr = cr;
  p.cout = cout;
  p.rows = N * ch;
  p.rowlen = static_cast<long long>(cw) * cout;
  p.total = p.rows * p.rowlen;
  p.pb = C * item;
  p.lm = lm;
  p.ls = ls;
  p.scale = in_dtype != 0 && in_dtype != 5;
  for (int c = 0; c < kParamChannels; ++c) {
    p.mean[c] = c < lm ? mean[c] : 0.f;
    p.stdv[c] = c < ls ? std[c] : 1.f;
  }
  if (wide) {
    p.far_mean = lm > kParamChannels ? static_cast<const float*>(far)
                                     : nullptr;
    p.far_std = ls > kParamChannels ? static_cast<const float*>(far) + lm
                                    : nullptr;
  }
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    const int* py0 = static_cast<const int*>(y0);
    const int* px0 = static_cast<const int*>(x0);
    const uint8_t* pf = static_cast<const uint8_t*>(flip);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (in_dtype) {
      case 3:
        err = launch_out<int8_t>(out_dtype, route, x, py0, px0, pf, out, p,
                                 sms, st);
        break;
      case 4:
      case 5:
        err = launch_out<uint8_t>(out_dtype, route, x, py0, px0, pf, out, p,
                                  sms, st);
        break;
      case 6:
        err = launch_out<int16_t>(out_dtype, route, x, py0, px0, pf, out, p,
                                  sms, st);
        break;
      case 7:
        err = launch_out<int32_t>(out_dtype, route, x, py0, px0, pf, out, p,
                                  sms, st);
        break;
      default:
        err = launch_out<float>(out_dtype, route, x, py0, px0, pf, out, p,
                                sms, st);
    }
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
