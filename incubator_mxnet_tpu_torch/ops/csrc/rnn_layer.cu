// The recurrent layer's whole time loop, forward and backward, for Hopper
// (sm_90a): one cooperative launch runs every step of one (layer,
// direction) of ops/nn.py :: rnn.
//
// Replaces no TPU kernel: the JAX package runs the loop as lax.scan
// (incubator_mxnet_tpu/ops/nn.py :: rnn, _scan_layer), which XLA compiles
// into one program. PyTorch runs eagerly, so the port's per-step route
// (csrc/rnn_cell.cu) launches a recurrent product and a cell kernel for
// every step and three more on the way back; at the word language model's
// shape those launches, not the arithmetic, were the layer's time. This
// source computes what incubator_mxnet_tpu_torch/ops/rnn.py ::
// layer_fwd_ref and layer_bwd_ref compute: the recurrent product of each
// step in float32 from the stored values (its sum in another order than
// torch.matmul's), the cell element by element with rnn_gates.cuh's
// functions, and only h, c and the saved activations rounded to the type.
//
// Forward. gx (T, N, G H) holds the input product over all T N rows (plus
// the bias: bx + bh, or bx for the GRU, whose bh joins the recurrent
// product). Block k owns hidden units [k U, k U + U) and all G gate rows of
// them: it loads those rows of W_hh (G H, H) into shared memory once and
// keeps them for the whole loop. Each step it reads h_{t-1} (h0, or ys of
// the previous step, written by every block) from L2, forms its units' gate
// pre-activations for all N rows, applies the cell and writes h_t straight
// into ys[t] (and h_T, c_T at the last step); c stays with the block that
// owns its unit (c_out carries it). When the layer is taped it also writes
// the gate activations (T, N, G H) and, per step, the LSTM's c or the GRU's
// n block of the recurrent product (T, N, H). A grid-wide barrier ends each
// step. Backward, in reverse time: block k keeps W_hh[:, units] (G H x U)
// in shared memory, reads all of the next step's dGh (N, G H) from L2 to
// form its units' recurrent dh, adds dys (and dh_T at the first step),
// runs the cell backward and writes its columns of dGx and, for the GRU,
// dGh (whose n block is dn r); dc and the GRU's elementwise dh z stay with
// the block (carried in dc0 and dh0). After the last step one more product
// gives dh0. The weight products (dW_hh = dGh^T [h0; ys], dW_ih, dX, the
// bias sums) stay large torch.matmul calls outside, as the JAX package
// leaves them to XLA.
//
// The product of a block, out[n][r] = sum_k A[n][k] B[r][k] (forward: A
// h_{t-1}, B the block's W rows, K = H; backward: A dGh, B the transposed
// W columns, K = G H), runs over tiles of 32 batch rows, one a lane. A is
// streamed in K-chunks of 512 bytes a row through a 2-stage shared ring,
// loaded with L2-only (.cg) loads staged in registers: rows are not 16-byte
// aligned in general, and data other blocks wrote during this launch must
// not come from the (incoherent) L1. Each warp takes every eighth 16-byte
// column vector of a chunk for all rows of B (float32 sums in registers,
// fused multiply-adds), and the eight warps' partial sums are added in
// warp order through shared memory: no atomics, so two launches are
// bit-equal. Every block, one owning no unit included, reaches every
// barrier.
//
// What bounds it on the card: operations. At the word language model's
// shape (T 35, N 32, H 650, LSTM, float32) the recurrent products are
// 3.79 GFLOP each way against ~36 MB moved, 0.057 ms at the 67 TFLOP/s of
// the CUDA cores. What the design does about it: the products run on every
// SM at once with W_hh read from shared memory, not device memory; the
// step's serial chain (one barrier, h or dG through L2) replaces a launch
// per step. No tensor cores and no TMA yet.
//
// The caller guarantees: every tensor contiguous, of one dtype, on one
// card; gx, the activations, dgx and dgh (T, N, G H); ys, aux, dys
// (T, N, H); w (G H, H); the states (N, H); bh (G H); a grid of ceil(H / U)
// blocks co-resident (checked before the launch).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rnn_gates.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // batch rows of a product pass: a lane each
constexpr int kChunkBytes = 512;   // bytes of an A row in one ring stage
// a stage's row stride: 33 16-byte units, so the 8 rows a quarter-warp
// reads fall in 8 different bank groups
constexpr int kChunkStride = kChunkBytes + 16;
constexpr int kRing = 2 * kTile * kChunkStride;
// the most rows a block's product takes: the forward's G U (padded to 4),
// the backward's U
constexpr int kFwdRows = 64;
constexpr int kBwdRows = 16;

struct LayerFwd {
  const void *gx, *w, *h0, *c0, *bh;
  void *ys, *h_out, *c_out, *acts, *aux;
  long long T, N, H;
  int units, act, reverse, ub;
};

struct LayerBwd {
  const void *w, *acts, *aux, *ys, *h0, *c0, *dys, *dh_T, *dc_T;
  void *dgx, *dgh, *dh0, *dc0;
  long long T, N, H;
  int units, act, reverse, ub;
};

__host__ __device__ __forceinline__ long long round_up(long long a,
                                                       long long b) {
  return (a + b - 1) / b * b;
}

// shared bytes of a block: `rows` rows of K values of B (a row padded to 16
// bytes), then the ring, which the warps' partial sums reuse
__host__ __device__ __forceinline__ long long layer_smem(int rows, long long K,
                                                         int item) {
  const long long red = (long long)kWarps * rows * kTile * 4;
  return rows * round_up(K, 16 / item) * item + (red > kRing ? red : kRing);
}

// a value written by another block during this launch: from L2
template <typename T>
__device__ __forceinline__ float ld_l2(const T* p) {
  return to_f(__ldcg(p));
}

// 16 bytes of shared memory as 16 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ void load16(const void* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) x[i] = to_f(e[i]);
}

// One ring stage through registers: 32 rows x 512 bytes, 64 bytes a thread
// in units of UB bytes (rows past nrows and columns past the row: zeros).
template <int UB>
struct Unit;
template <>
struct Unit<16> {
  using type = uint4;
};
template <>
struct Unit<8> {
  using type = uint2;
};
template <>
struct Unit<4> {
  using type = unsigned int;
};
template <>
struct Unit<2> {
  using type = unsigned short;
};

template <int UB>
__device__ __forceinline__ void stage_load_ub(uint32_t* st,
                                              const unsigned char* A,
                                              long long row_bytes, int nrows,
                                              long long c0) {
  using U = typename Unit<UB>::type;
  constexpr int per_row = kChunkBytes / UB;
  constexpr int per_thread = 64 / UB;
#pragma unroll
  for (int i = 0; i < per_thread; ++i) {
    const int q = threadIdx.x + i * kThreads;
    const int row = q / per_row;
    const long long col = c0 + (long long)(q % per_row) * UB;
    U v{};
    if (row < nrows && col < row_bytes)
      v = __ldcg(reinterpret_cast<const U*>(A + row * row_bytes + col));
    if constexpr (UB == 16) {
      st[4 * i] = v.x;
      st[4 * i + 1] = v.y;
      st[4 * i + 2] = v.z;
      st[4 * i + 3] = v.w;
    } else if constexpr (UB == 8) {
      st[2 * i] = v.x;
      st[2 * i + 1] = v.y;
    } else if constexpr (UB == 4) {
      st[i] = v;
    } else {
      if (i % 2 == 0)
        st[i / 2] = v;
      else
        st[i / 2] |= (uint32_t)v << 16;
    }
  }
}

template <int UB>
__device__ __forceinline__ void stage_store_ub(const uint32_t* st,
                                               unsigned char* ring) {
  using U = typename Unit<UB>::type;
  constexpr int per_row = kChunkBytes / UB;
  constexpr int per_thread = 64 / UB;
#pragma unroll
  for (int i = 0; i < per_thread; ++i) {
    const int q = threadIdx.x + i * kThreads;
    U* dst = reinterpret_cast<U*>(ring + (q / per_row) * kChunkStride +
                                  (q % per_row) * UB);
    if constexpr (UB == 16) {
      *dst = make_uint4(st[4 * i], st[4 * i + 1], st[4 * i + 2],
                        st[4 * i + 3]);
    } else if constexpr (UB == 8) {
      *dst = make_uint2(st[2 * i], st[2 * i + 1]);
    } else if constexpr (UB == 4) {
      *dst = st[i];
    } else {
      *dst = (unsigned short)(i % 2 == 0 ? st[i / 2] : st[i / 2] >> 16);
    }
  }
}

__device__ __forceinline__ void stage_load(uint32_t* st, const void* A,
                                           long long row_bytes, int nrows,
                                           long long c0, int ub) {
  const unsigned char* a = static_cast<const unsigned char*>(A);
  switch (ub) {
    case 16:
      stage_load_ub<16>(st, a, row_bytes, nrows, c0);
      break;
    case 8:
      stage_load_ub<8>(st, a, row_bytes, nrows, c0);
      break;
    case 4:
      stage_load_ub<4>(st, a, row_bytes, nrows, c0);
      break;
    default:
      stage_load_ub<2>(st, a, row_bytes, nrows, c0);
  }
}

__device__ __forceinline__ void stage_store(const uint32_t* st,
                                            unsigned char* ring, int ub) {
  switch (ub) {
    case 16:
      stage_store_ub<16>(st, ring);
      break;
    case 8:
      stage_store_ub<8>(st, ring);
      break;
    case 4:
      stage_store_ub<4>(st, ring);
      break;
    default:
      stage_store_ub<2>(st, ring);
  }
}

// out[r][n] = sum_k A[n][k] B[r][k] for the nrows (<= 32) rows of A (row
// stride = K, read in units of ub bytes) and the R rows of B (shared, row
// stride ks, zeros past K); R <= RT, a multiple of RG. Leaves out, R x 32
// floats, at the start of `scratch`, and ends on a block barrier.
template <typename T, int RT, int RG>
__device__ __forceinline__ void product(const T* A, int nrows, long long K,
                                        int ub, const T* B, long long ks,
                                        int R, unsigned char* scratch) {
  constexpr int VK = 16 / (int)sizeof(T);
  constexpr int KC = kChunkBytes / (int)sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row_bytes = K * (long long)sizeof(T);
  const int nchunks = (int)((K + KC - 1) / KC);
  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;
  uint32_t st[16];
  stage_load(st, A, row_bytes, nrows, 0, ub);
  stage_store(st, scratch, ub);
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks)
      stage_load(st, A, row_bytes, nrows, (long long)(c + 1) * kChunkBytes,
                 ub);
    const unsigned char* ring = scratch + (c & 1) * (kTile * kChunkStride);
    const long long k0 = (long long)c * KC;
    const int nkv = (int)((min((long long)KC, K - k0) + VK - 1) / VK);
    for (int kv = warp; kv < nkv; kv += kWarps) {
      float x[VK];
      load16<T>(ring + lane * kChunkStride + kv * 16, x);
      const T* b = B + k0 + kv * VK;
#pragma unroll
      for (int r0 = 0; r0 < RT; r0 += RG) {
        if (r0 >= R) break;
#pragma unroll
        for (int j = 0; j < RG; ++j) {
          float w[VK];
          load16<T>(b + (r0 + j) * ks, w);
#pragma unroll
          for (int e = 0; e < VK; ++e)
            acc[r0 + j] = fmaf(x[e], w[e], acc[r0 + j]);
        }
      }
    }
    if (c + 1 < nchunks)
      stage_store(st, scratch + ((c + 1) & 1) * (kTile * kChunkStride), ub);
    __syncthreads();
  }
  float* red = reinterpret_cast<float*>(scratch);
#pragma unroll
  for (int r = 0; r < RT; ++r)
    if (r < R) red[(warp * R + r) * kTile + lane] = acc[r];
  __syncthreads();
  for (int i = threadIdx.x; i < R * kTile; i += kThreads) {
    float s = red[i];
    for (int w = 1; w < kWarps; ++w) s += red[w * R * kTile + i];
    red[i] = s;
  }
  __syncthreads();
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    rnn_layer_fwd_kernel(LayerFwd p) {
  constexpr int G = Gates<MODE>::G;
  constexpr int VK = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const long long steps = p.T, N = p.N, H = p.H, GH = G * H;
  const int U = p.units;
  const long long u0 = (long long)blockIdx.x * U;
  const int nu = (int)max(0LL, min((long long)U, H - u0));
  const int R = (int)round_up(G * U, 4);
  const long long ks = round_up(H, VK);
  T* Ws = reinterpret_cast<T*>(smem);
  unsigned char* scratch = smem + R * ks * (long long)sizeof(T);
  const T* gx = static_cast<const T*>(p.gx);
  const T* w = static_cast<const T*>(p.w);
  const T* h0 = static_cast<const T*>(p.h0);
  const T* c0 = static_cast<const T*>(p.c0);
  const T* bh = static_cast<const T*>(p.bh);
  T* ys = static_cast<T*>(p.ys);
  T* h_out = static_cast<T*>(p.h_out);
  T* c_out = static_cast<T*>(p.c_out);
  T* acts = static_cast<T*>(p.acts);
  T* aux = static_cast<T*>(p.aux);

  // the rows of W_hh this block's units take, gate-major (row g U + j is
  // W row g H + u0 + j); zeros past the units and past H
  for (long long i = threadIdx.x; i < R * ks; i += kThreads) {
    const int r = (int)(i / ks);
    const long long k = i - r * ks;
    const int g = r / U, j = r - g * U;
    Ws[i] = g < G && j < nu && k < H ? w[(g * H + u0 + j) * H + k]
                                     : from_f<T>(0.f);
  }
  __syncthreads();

  for (long long s = 0; s < steps; ++s) {
    const long long t = p.reverse ? steps - 1 - s : s;
    const long long tp = p.reverse ? t + 1 : t - 1;  // the previous step's
    const T* hprev = s == 0 ? h0 : ys + tp * N * H;
    for (long long n0 = 0; nu > 0 && n0 < N; n0 += kTile) {
      const int nrows = (int)min((long long)kTile, N - n0);
      product<T, kFwdRows, 4>(hprev + n0 * H, nrows, H, p.ub, Ws, ks, R,
                              scratch);
      const float* out = reinterpret_cast<const float*>(scratch);
      for (int q = threadIdx.x; q < nrows * nu; q += kThreads) {
        const int n = q / nu, j = q - n * nu;
        const long long row = n0 + n, u = u0 + j, si = row * H + u;
        const long long gi = (t * N + row) * GH + u;
        float a[G], b[G], gate[G], cp = 0.f, hp = 0.f, cn = 0.f, hn;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          a[g] = to_f(gx[gi + g * H]);
          b[g] = out[(g * U + j) * kTile + n];
          if constexpr (MODE == kGru)
            b[g] = __fadd_rn(b[g], to_f(bh[g * H + u]));
        }
        if constexpr (MODE == kLstm)
          cp = s == 0 ? to_f(c0[si]) : ld_l2(c_out + si);
        if constexpr (MODE == kGru)
          hp = s == 0 ? to_f(h0[si]) : ld_l2(ys + tp * N * H + si);
        cell_fwd<MODE>(a, b, cp, hp, p.act, gate, cn, hn);
        const T hv = from_f<T>(hn);
        ys[t * N * H + si] = hv;
        if (s + 1 == steps) h_out[si] = hv;
        if constexpr (MODE == kLstm) c_out[si] = from_f<T>(cn);
        if constexpr (MODE != kRnn) {
          if (acts != nullptr) {
#pragma unroll
            for (int g = 0; g < G; ++g) acts[gi + g * H] = from_f<T>(gate[g]);
            aux[t * N * H + si] = from_f<T>(MODE == kLstm ? cn : b[2]);
          }
        }
      }
      __syncthreads();
    }
    if (s + 1 < steps) grid.sync();
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    rnn_layer_bwd_kernel(LayerBwd p) {
  constexpr int G = Gates<MODE>::G;
  constexpr int VK = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const long long steps = p.T, N = p.N, H = p.H, GH = G * H;
  const int U = p.units;
  const long long u0 = (long long)blockIdx.x * U;
  const int nu = (int)max(0LL, min((long long)U, H - u0));
  const long long ks = round_up(GH, VK);
  T* Wt = reinterpret_cast<T*>(smem);
  unsigned char* scratch = smem + U * ks * (long long)sizeof(T);
  const T* w = static_cast<const T*>(p.w);
  const T* acts = static_cast<const T*>(p.acts);
  const T* aux = static_cast<const T*>(p.aux);
  const T* ys = static_cast<const T*>(p.ys);
  const T* h0 = static_cast<const T*>(p.h0);
  const T* c0 = static_cast<const T*>(p.c0);
  const T* dys = static_cast<const T*>(p.dys);
  const T* dh_T = static_cast<const T*>(p.dh_T);
  const T* dc_T = static_cast<const T*>(p.dc_T);
  T* dgx = static_cast<T*>(p.dgx);
  T* dgh = static_cast<T*>(MODE == kGru ? p.dgh : p.dgx);
  T* dh0 = static_cast<T*>(p.dh0);
  T* dc0 = static_cast<T*>(p.dc0);

  // W_hh's columns of this block's units, transposed (row j, column k is
  // W[k][u0 + j]); zeros past the units and past G H
  for (long long i = threadIdx.x; i < U * ks; i += kThreads) {
    const long long k = i / U;
    const int j = (int)(i - k * U);
    Wt[j * ks + k] =
        j < nu && k < GH ? w[k * H + u0 + j] : from_f<T>(0.f);
  }
  __syncthreads();

  for (long long s = steps - 1; s >= 0; --s) {
    const long long t = p.reverse ? steps - 1 - s : s;
    const long long tn = p.reverse ? t - 1 : t + 1;  // step s + 1's time
    const long long tp = p.reverse ? t + 1 : t - 1;  // step s - 1's time
    const bool first = s + 1 == steps;
    for (long long n0 = 0; nu > 0 && n0 < N; n0 += kTile) {
      const int nrows = (int)min((long long)kTile, N - n0);
      if (!first)
        product<T, kBwdRows, 1>(dgh + (tn * N + n0) * GH, nrows, GH, p.ub,
                                Wt, ks, U, scratch);
      const float* rec = reinterpret_cast<const float*>(scratch);
      for (int q = threadIdx.x; q < nrows * nu; q += kThreads) {
        const int n = q / nu, j = q - n * nu;
        const long long row = n0 + n, u = u0 + j, si = row * H + u;
        const long long gi = (t * N + row) * GH + u;
        float d = first ? 0.f : rec[j * kTile + n];
        if (dys != nullptr) d = __fadd_rn(d, to_f(dys[t * N * H + si]));
        if (first && dh_T != nullptr) d = __fadd_rn(d, to_f(dh_T[si]));
        if (MODE == kGru && !first) d = __fadd_rn(d, ld_l2(dh0 + si));
        float gate[G], dg[G], cp = 0.f, cn = 0.f, nh = 0.f, hp = 0.f,
                             y = 0.f, dc = 0.f, dnh = 0.f, dprev = 0.f;
        if constexpr (MODE != kRnn) {
#pragma unroll
          for (int g = 0; g < G; ++g) gate[g] = to_f(acts[gi + g * H]);
        }
        if constexpr (MODE == kLstm) {
          cp = s == 0 ? to_f(c0[si]) : to_f(aux[tp * N * H + si]);
          cn = to_f(aux[t * N * H + si]);
          dc = !first ? ld_l2(dc0 + si)
                      : (dc_T != nullptr ? to_f(dc_T[si]) : 0.f);
        } else if constexpr (MODE == kGru) {
          nh = to_f(aux[t * N * H + si]);
          hp = s == 0 ? to_f(h0[si]) : to_f(ys[tp * N * H + si]);
        } else {
          y = to_f(ys[t * N * H + si]);
        }
        cell_bwd<MODE>(gate, cp, cn, nh, hp, y, d, dc, p.act, dg, dnh,
                       dprev);
#pragma unroll
        for (int g = 0; g < G; ++g) dgx[gi + g * H] = from_f<T>(dg[g]);
        if constexpr (MODE == kGru) {
          dgh[gi] = from_f<T>(dg[0]);
          dgh[gi + H] = from_f<T>(dg[1]);
          dgh[gi + 2 * H] = from_f<T>(dnh);
          dh0[si] = from_f<T>(dprev);
        }
        if constexpr (MODE == kLstm) dc0[si] = from_f<T>(dprev);
      }
      __syncthreads();
    }
    grid.sync();
  }

  // dh0: the first step's recurrent gradient (plus the GRU's elementwise
  // part, carried in dh0)
  const long long t0 = p.reverse ? steps - 1 : 0;
  for (long long n0 = 0; nu > 0 && n0 < N; n0 += kTile) {
    const int nrows = (int)min((long long)kTile, N - n0);
    product<T, kBwdRows, 1>(dgh + (t0 * N + n0) * GH, nrows, GH, p.ub, Wt, ks,
                            U, scratch);
    const float* rec = reinterpret_cast<const float*>(scratch);
    for (int q = threadIdx.x; q < nrows * nu; q += kThreads) {
      const int n = q / nu, j = q - n * nu;
      const long long si = (n0 + n) * H + u0 + j;
      float d = rec[j * kTile + n];
      if constexpr (MODE == kGru) d = __fadd_rn(d, ld_l2(dh0 + si));
      dh0[si] = from_f<T>(d);
    }
    __syncthreads();
  }
}

// the widest unit (16 bytes down to one value) that divides a row of A and
// to which every base A is read from is aligned
int unit_bytes(long long row_bytes, const void* const* bases, int n,
               int item) {
  int ub = 16;
  for (; ub > item; ub /= 2) {
    bool ok = row_bytes % ub == 0;
    for (int i = 0; ok && i < n; ++i)
      ok = reinterpret_cast<uintptr_t>(bases[i]) % ub == 0;
    if (ok) break;
  }
  return ub;
}

// a cooperative launch of ceil(H / units) blocks, after checking that they
// fit on the card at once
template <typename Args>
cudaError_t launch(const void* kernel, const Args& args, long long H,
                   long long smem, int device, cudaStream_t st) {
  const int grid = (int)((H + args.units - 1) / args.units);
  int sms = 0, optin = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  Args a = args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, grid, kThreads, params,
                                    (size_t)smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int gates_of(int mode) { return mode == kLstm ? 4 : (mode == kGru ? 3 : 1); }

long long fwd_smem(int item, int mode, long long H, int units) {
  return layer_smem((int)round_up(gates_of(mode) * units, 4), H, item);
}

long long bwd_smem(int item, int mode, long long H, int units) {
  return layer_smem(units, gates_of(mode) * H, item);
}

template <typename T>
cudaError_t fwd_dtype(int mode, const LayerFwd& a, int device,
                      cudaStream_t st) {
  const long long smem = fwd_smem(sizeof(T), mode, a.H, a.units);
  switch (mode) {
    case kLstm:
      return launch((const void*)rnn_layer_fwd_kernel<T, kLstm>, a, a.H, smem,
                    device, st);
    case kGru:
      return launch((const void*)rnn_layer_fwd_kernel<T, kGru>, a, a.H, smem,
                    device, st);
    default:
      return launch((const void*)rnn_layer_fwd_kernel<T, kRnn>, a, a.H, smem,
                    device, st);
  }
}

template <typename T>
cudaError_t bwd_dtype(int mode, const LayerBwd& a, int device,
                      cudaStream_t st) {
  const long long smem = bwd_smem(sizeof(T), mode, a.H, a.units);
  switch (mode) {
    case kLstm:
      return launch((const void*)rnn_layer_bwd_kernel<T, kLstm>, a, a.H, smem,
                    device, st);
    case kGru:
      return launch((const void*)rnn_layer_bwd_kernel<T, kGru>, a, a.H, smem,
                    device, st);
    default:
      return launch((const void*)rnn_layer_bwd_kernel<T, kRnn>, a, a.H, smem,
                    device, st);
  }
}

int item_of(int dtype) { return dtype == 0 ? 4 : 2; }

bool units_ok(int mode, int units) {
  return units >= 1 && units <= kBwdRows &&
         round_up(gates_of(mode) * units, 4) <= kFwdRows;
}

}  // namespace

// Shared bytes a block of the forward (backward = 0) or the backward (1)
// takes at (dtype, mode, H, units); -1 for units the kernels do not take.
extern "C" long long mx_rnn_layer_smem(int dtype, int mode, long long H,
                                       int units, int backward) {
  if (!units_ok(mode, units) || H <= 0) return -1;
  return backward ? bwd_smem(item_of(dtype), mode, H, units)
                  : fwd_smem(item_of(dtype), mode, H, units);
}

// dtype: 0 float32, 1 bfloat16, 2 float16 (ops/kernels.py :: DTYPE_CODES);
// mode: 0 LSTM, 1 GRU, 2 RNN; act_code as csrc/rnn_cell.cu's. Every step of
// one (layer, direction), the time axis walked backwards with `reverse`;
// `units` hidden units a block. c0, c_out the LSTM's only, bh the GRU's;
// acts and aux both null (inference: nothing saved) or both given (the
// LSTM and the GRU only). T, N, H >= 1. Returns the launch's error (0 on
// success), never synchronises.
extern "C" int mx_rnn_layer_fwd(int dtype, int mode, int act_code, int device,
                                int reverse, int units, const void* gx,
                                const void* w, const void* h0, const void* c0,
                                const void* bh, void* ys, void* h_out,
                                void* c_out, void* acts, void* aux,
                                long long T, long long N, long long H,
                                void* stream) {
  if (T <= 0 || N <= 0 || H <= 0 || dtype < 0 || dtype > 2 || mode < 0 ||
      mode > 2 || act_code < kTanh || act_code > kLogSigmoid ||
      !units_ok(mode, units) || gx == nullptr || w == nullptr ||
      h0 == nullptr || ys == nullptr || h_out == nullptr ||
      (acts == nullptr) != (aux == nullptr) ||
      (mode == kRnn && acts != nullptr))
    return (int)cudaErrorInvalidValue;
  if ((mode == kLstm && (c0 == nullptr || c_out == nullptr)) ||
      (mode == kGru && bh == nullptr))
    return (int)cudaErrorInvalidValue;
  const int item = item_of(dtype);
  const void* bases[] = {h0, ys};
  const LayerFwd a{gx, w, h0, c0, bh, ys, h_out, c_out, acts, aux, T, N, H,
                   units, act_code, reverse != 0,
                   unit_bytes(H * item, bases, 2, item)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    switch (dtype) {
      case 0:
        return fwd_dtype<float>(mode, a, device, st);
      case 1:
        return fwd_dtype<__nv_bfloat16>(mode, a, device, st);
      default:
        return fwd_dtype<__half>(mode, a, device, st);
    }
  });
}

// The backward of mx_rnn_layer_fwd. Reads w, what the forward saved (acts
// and aux: the LSTM's and the GRU's), ys (the GRU's and the RNN's), h0 (the
// GRU's), c0 (the LSTM's) and the output gradients dys, dh_T, dc_T (any of
// them null: zeros); writes dgx (T, N, G H), dgh (the GRU's: its n block is
// dn r; the others' recurrent gradient is dgx itself), dh0 and the LSTM's
// dc0 (N, H).
extern "C" int mx_rnn_layer_bwd(int dtype, int mode, int act_code, int device,
                                int reverse, int units, const void* w,
                                const void* acts, const void* aux,
                                const void* ys, const void* h0,
                                const void* c0, const void* dys,
                                const void* dh_T, const void* dc_T, void* dgx,
                                void* dgh, void* dh0, void* dc0, long long T,
                                long long N, long long H, void* stream) {
  if (T <= 0 || N <= 0 || H <= 0 || dtype < 0 || dtype > 2 || mode < 0 ||
      mode > 2 || act_code < kTanh || act_code > kLogSigmoid ||
      !units_ok(mode, units) || w == nullptr || dgx == nullptr ||
      dh0 == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((mode == kLstm && (acts == nullptr || aux == nullptr ||
                         c0 == nullptr || dc0 == nullptr)) ||
      (mode == kGru && (acts == nullptr || aux == nullptr || ys == nullptr ||
                        h0 == nullptr || dgh == nullptr)) ||
      (mode == kRnn && ys == nullptr))
    return (int)cudaErrorInvalidValue;
  const int item = item_of(dtype);
  const void* bases[] = {mode == kGru ? dgh : dgx};
  const long long G = gates_of(mode);
  const LayerBwd a{w, acts, aux, ys, h0, c0, dys, dh_T, dc_T, dgx, dgh, dh0,
                   dc0, T, N, H, units, act_code, reverse != 0,
                   unit_bytes(G * H * item, bases, 1, item)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    switch (dtype) {
      case 0:
        return bwd_dtype<float>(mode, a, device, st);
      case 1:
        return bwd_dtype<__nv_bfloat16>(mode, a, device, st);
      default:
        return bwd_dtype<__half>(mode, a, device, st);
    }
  });
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
