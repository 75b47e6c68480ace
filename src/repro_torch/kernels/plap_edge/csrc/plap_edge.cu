// Fused p-Laplacian kernels over BSR tiles for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernels of
// src/repro/kernels/plap_edge/plap_edge.py:
//
//   kind 1  plap_apply_pallas (:76)  y_i = sum_j w_ij phi_p(x_i - x_j)
//           (the gradient op of every trust-region step)
//   kind 2  plap_hvp_pallas (:96)    y_i = sum_j w_ij phi'_p(u_i - u_j)(e_i - e_j)
//           (the matrix-free Hessian apply)
//
// where j runs over the columns of the stored (bs, bs) tiles of row i's
// row-block.  The TPU kernels evaluate the nonlinearity on every entry of
// every tile, over a (bs, bs, k) broadcast in VMEM.
//
// What bounds it on this card: bytes.  Every stored tile is streamed once
// per launch: 4.66 GB of fp32 tiles for delaunay_graph(20) at bs = 128,
// 1.40 ms at 3.35 TB/s.  But 99.46% of those values are zero weights
// (about 88 non-zeros in a tile of 16,384), and evaluating phi (one pow)
// or phi' (two pows) on each of them costs about 110 instructions a term:
// issue-bound at 12x and 18x the byte bound.  What the design does:
//
// * The tile stream of bsr_spmm (../../csrc/bsr_ring.cuh), off the
//   threads that compute: one thread block per row-block looping over its
//   tiles (no atomics).  A producer warp has the TMA copy each tile into a
//   double-buffered ring (one stage for fp64 at bs = 128) and copies the
//   tile's (bs, KC) column slices of X (and E) by cp.async, all onto the
//   stage's "full" mbarrier; it refills a stage once the 16 consumer
//   warps have each arrived on its "empty" mbarrier.  No block-wide
//   barrier per tile: the consumer warps drift apart within the ring, so
//   one warp's phi latency hides behind another's scan.  The row-block's
//   own rows of X (and E) are staged once.
// * phi only where a weight is non-zero, lane-dense.  Consumer warp w
//   owns the tile rows of every 16th row group (w, w + 16, ... at
//   bs = 128) for the whole row-block.  It scans its rows of the tile 16
//   bytes a lane, four rows loaded at once (a lane's rows all sit at the
//   same swizzle phase, so each is a fixed offset: no address arithmetic
//   in the loop), rejects a row without non-zeros with one __any_sync,
//   and appends the non-zeros, (row, column, weight), to its list in
//   shared memory in the tile's row-major order (__ballot_sync and
//   __popc give each lane its place).  The list is then evaluated one
//   lane per (entry, column of the window): every lane of a round of 32
//   does phi work.
// * A fixed order of summation: within a round, the terms of one (row,
//   column) are summed in fp64 by a segmented shuffle scan (stride KC,
//   the list being sorted by row), and the segment's last lane adds the
//   sum to the row's fp64 sum in shared memory, which only that warp
//   touches; rounds, lists and tiles follow in order, and the sum is
//   rounded to T once, when written.  The same call gives the same bits
//   on every run.
//
// Skipping zero weights is exact where their term is exactly +-0: then
// adding it leaves every partial sum unchanged, and only the order in
// which the non-zero terms are summed differs from the reference.  The
// host routes each call (plap_edge.py, ``phi_mode``):
//
//   skip mode (kSkip)  apply at any eps >= 0 and hvp at eps > 0, for
//       1 <= p <= 2 and an eps whose pows stay finite in T.  For finite
//       inputs with |v| < 2^62 (fp32) or 2^510 (fp64), every difference
//       squares without overflow, so phi(d) and phi'(d) are finite,
//       0 * phi(d) = +-0 and (0 * phi'(d)) * (e_i - e_j) = +-0.  A tile
//       whose staged values (its column slices, or the row-block's own
//       rows) hold a non-finite value or one at or above that threshold
//       is evaluated in full instead: the producer checks each tile's
//       slices and publishes a flag on the stage's "checked" mbarrier, so
//       a NaN or inf reached only through zero weights gives NaN exactly
//       where the reference has it.
//   full mode (kFull)  hvp at eps = 0 (and any call outside skip mode's
//       conditions): every entry of every tile goes through the same
//       list, the weight test compiled out.  At eps = 0, phi'(0) = inf for
//       p < 2 and 0 * inf = NaN: the product is formed in the reference's
//       order (w * phi'(du) * de), so the kernel returns NaN wherever the
//       reference does: in every row whose tiles hold a column j with
//       u_j = u_i, the row's own column included.
//   kDivergent  measurement only (chip_smoke.py): each lane tests its own
//       weights and evaluates phi where they are non-zero, without
//       compaction; fp32 at KC = 4.
//
// The multivector is (rows, ld) row-major and one launch covers the column
// window [c0, c0 + kc), kc <= KC (the template width, 1/2/4/8 for fp32,
// 1/2/4 for fp64).  Columns past n_x of the last column-block read as 0
// and rows past n_rows of the last row-block are not written, as the
// reference pads X with zero rows.  A row-block without tiles is written
// as zeros.  bs is at most 128.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bsr_ring.cuh"
#include "phi.cuh"

namespace {

using namespace bsr_ring;
using phi_p::abs_t;

enum Kind { kApply = 1, kHvp = 2 };
enum Mode { kSkip = 0, kFull = 1, kDivergent = 2 };

constexpr int kConsumers = 16;  // warps that scan and evaluate
constexpr int kThreads = 32 * (kConsumers + 1);  // + the producer warp
constexpr int kCap = 256;        // entries of a consumer warp's list
constexpr int kBatch = 4;        // tile rows a lane loads at once
constexpr int kMaxBlock = 128;   // (row, column) packed in 8 bits each

// |v| from which a difference of two values could overflow when squared
template <typename T>
struct Limit;
template <>
struct Limit<float> {
  static constexpr float value = 0x1p62f;
};
template <>
struct Limit<double> {
  static constexpr double value = 0x1p510;
};

// Shared memory of one launch from a 1024-byte aligned base: the ring (a
// stage is one tile, as boxes of bs rows rounded to 8, then its (bsv, KC)
// slices of X and, for the hvp, E), then (bs, KC) arrays of the output's
// fp64 sums and of the own rows of X (and E), the consumer warps' lists
// (weights, then packed (row, column)), then per stage three mbarriers
// (full, checked, empty) and a flag.
struct Layout {
  Ring ring;
  int ys, xr, er, wl, pl, bars, bytes;
};

template <typename T, int KIND, int KC>
__host__ __device__ Layout layout(int bs) {
  constexpr int kSlices = KIND == kHvp ? 2 : 1;
  const int rows = (bs * KC * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  const int sums = bs * KC * static_cast<int>(sizeof(double));
  const int lists = kConsumers * kCap * (static_cast<int>(sizeof(T)) + 2);
  Layout L;
  L.ring = ring_layout<T>(bs, (bs + 7) / 8 * 8, KC, kSlices,
                          kSlices * rows + sums + lists + 48);
  int off = L.ring.stages * L.ring.stage;
  L.ys = off;
  off += sums;
  L.xr = off;
  off += rows;
  L.er = off;
  if (KIND == kHvp) off += rows;
  L.wl = off;
  off += kConsumers * kCap * static_cast<int>(sizeof(T));
  L.pl = off;
  off += kConsumers * kCap * 2;
  L.bars = (off + 7) / 8 * 8;
  L.bytes = L.bars + 28 * L.ring.stages + 1024;  // + alignment slack
  return L;
}

template <typename T, int KIND>
__device__ __forceinline__ T term(T w, T xi, T xj, T ei, T ej,
                                  const phi_p::Ring<T>& ring) {
  if constexpr (KIND == kApply) {
    return w * phi_p::phi(xi - xj, ring);
  } else {
    return w * phi_p::phi_prime(xi - xj, ring) * (ei - ej);
  }
}

template <typename T>
__device__ __forceinline__ bool beyond(T v) {
  return !(abs_t(v) < Limit<T>::value);  // NaN included
}

template <typename T, int KIND, int MODE, int KC>
__global__ void __launch_bounds__(kThreads, 1) phi_kernel(
    const __grid_constant__ CUtensorMap tm_tiles, int tma,
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    const T* __restrict__ blocks, const T* __restrict__ X,
    const T* __restrict__ E, T* __restrict__ Y, int32_t n_rows, int32_t n_x,
    int32_t bs, int32_t ld, int32_t c0, int32_t kc, phi_p::Ring<T> ring) {
  using VecT = typename Vec<T>::type;
  constexpr int V = 16 / sizeof(T);
  constexpr bool kE = KIND == kHvp;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Layout L = layout<T, KIND, KC>(bs);
  const Ring& G = L.ring;
  const int S = G.stages;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  // per stage st: full + 8 st, checked + 8 st, empty + 8 st, flags[st]
  const uint32_t full = base + L.bars;
  const uint32_t checked = full + 8 * S;
  const uint32_t empty = checked + 8 * S;
  int* flags = reinterpret_cast<int*>(smem + L.bars + 24 * S);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile_bytes = G.boxes * G.box_bytes;  // the slices follow
  double* ys = reinterpret_cast<double*>(smem + L.ys);
  T* xr = reinterpret_cast<T*>(smem + L.xr);
  T* er = reinterpret_cast<T*>(smem + L.er);

  // the row-block's own rows of X (and E), staged once; the sums zeroed
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * bs;
  bool bad = false;
  for (int e = tid; e < bs * KC; e += kThreads) {
    const int i = e / KC, c = e - i * KC;
    const bool in = row0 + i < n_x && c < kc;
    const int64_t g = (row0 + i) * ld + c0 + c;
    const T x = in ? X[g] : T(0);
    xr[e] = x;
    ys[e] = 0.0;
    bad |= beyond(x);
    if constexpr (kE) {
      const T v = in ? E[g] : T(0);
      er[e] = v;
      bad |= beyond(v);
    }
  }
  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full + 8 * st, 1 + 32);
      mbar_init(checked + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const bool own_dirty = __syncthreads_or(bad);

  const int32_t b_begin = indptr[blockIdx.x];
  const int n = indptr[blockIdx.x + 1] - b_begin;

  if (warp == kConsumers) {
    // ---- the producer warp: the tile stream and the skip-mode check
    const bool x16 = slice16<T>(X, ld, c0, kc);
    const bool e16 = slice16<T>(E, ld, c0, kc);
    // tile t and its slices of X (and E) into stage t % S, on full
    auto issue = [&](int t) {
      const int st = t % S;
      const uint32_t stage = base + st * G.stage;
      const uint32_t bar = full + 8 * st;
      const int32_t b = b_begin + t;
      const int64_t col0 = static_cast<int64_t>(indices[b]) * bs;
      load_tile<T, 32>(tma, &tm_tiles, blocks, b, bs, stage, bar, G, lane);
      load_slice<T, KC, 32>(X, x16, col0, n_x, ld, c0, kc, bs,
                            stage + tile_bytes, lane);
      if constexpr (kE)
        load_slice<T, KC, 32>(E, e16, col0, n_x, ld, c0, kc, bs,
                              stage + tile_bytes + G.x_bytes, lane);
      cp_async_arrive(bar);
    };
    // skip mode: whether tile t's slices hold a value that could give a
    // zero weight a term other than +-0; published on checked
    auto check = [&](int t) {
      if constexpr (MODE != kFull) {
        const int st = t % S;
        mbar_wait(full + 8 * st, (t / S) & 1);
        const unsigned char* stage = smem + st * G.stage;
        const T* xc = reinterpret_cast<const T*>(stage + tile_bytes);
        const T* ec =
            reinterpret_cast<const T*>(stage + tile_bytes + G.x_bytes);
        bool b = false;
        for (int e = lane; e < bs * KC; e += 32) {
          b |= beyond(xc[e]);
          if constexpr (kE) b |= beyond(ec[e]);
        }
        b = __any_sync(0xffffffffu, b);
        if (lane == 0) {
          flags[st] = b;
          mbar_arrive(checked + 8 * st);
        }
      }
    };
    for (int t = 0; t < S && t < n; ++t) issue(t);
    if (n > 0) check(0);
    for (int t = 0; t < n; ++t) {
      if (S > 1 && t + 1 < n) check(t + 1);  // issued one tile ago
      if (t + S < n) {
        // every consumer warp is done with tile t: its stage takes t + S
        mbar_wait(empty + 8 * (t % S), (t / S) & 1);
        issue(t + S);
      }
      if (S == 1 && t + 1 < n) check(t + 1);
    }
  } else {
    // ---- a consumer warp: its rows of every tile
    T* wl = reinterpret_cast<T*>(smem + L.wl) + warp * kCap;
    uint16_t* pl = reinterpret_cast<uint16_t*>(smem + L.pl) + warp * kCap;

    // Evaluate the list's ``cnt`` entries, one lane per (entry, column),
    // 32 a round, and add each round's terms to ys in a fixed order
    auto evaluate = [&](int cnt, const T* xc, const T* ec) {
      __syncwarp();
      const int items = cnt * KC;
      for (int b0 = 0; b0 < items; b0 += 32) {
        const int it = b0 + lane;
        const bool valid = it < items;
        const int e = it / KC, c = it % KC;
        int row = 1 << 16;  // past every row: no segment of its own
        double v = 0.0;
        if (valid) {
          const int pos = pl[e];
          row = pos >> 8;
          if (c < kc) {
            const int j = pos & 255;
            T ei = T(0), ej = T(0);
            if constexpr (kE) {
              ei = er[row * KC + c];
              ej = ec[j * KC + c];
            }
            v = term<T, KIND>(wl[e], xr[row * KC + c], xc[j * KC + c], ei,
                              ej, ring);
          }
        }
        // segmented inclusive scan over the lanes of one column (stride
        // KC): the list is sorted by row, so equal rows are one segment
#pragma unroll
        for (int s = KC; s < 32; s <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, s);
          const int ru = __shfl_up_sync(0xffffffffu, row, s);
          if (lane >= s && ru == row) v += u;
        }
        const int rn = __shfl_down_sync(0xffffffffu, row, KC);
        if (valid && c < kc && (lane + KC >= 32 || rn != row))
          ys[row * KC + c] += v;
        __syncwarp();
      }
    };

    // The warp's units: tile rows in groups of rpu (lpr lanes a row, 16
    // bytes a lane), groups warp, warp + kConsumers, ...; upr units a
    // group.  A lane's rows all sit at the same swizzle phase (groups are
    // a multiple of 8 rows apart), so its unit f is at a fixed offset
    // plus f's row step.
    const int cpr = G.bsv / V;  // 16-byte chunks per tile row
    int lpr = 1;
    while (lpr < cpr && lpr < 32) lpr <<= 1;
    const int rpu = 32 / lpr;
    const int ush = cpr > 32 ? 1 : 0;  // units per group: 1 << ush
    const int n_groups = (bs + rpu - 1) / rpu;
    const int n_units =
        warp < n_groups ? ((n_groups - 1 - warp) / kConsumers + 1) << ush : 0;
    const int m0 = warp * rpu + lane / lpr;
    const int row_step = kConsumers * rpu;
    // per unit of a group (q = 0, 1): the lane's offset in the stage and
    // the bits v of its 16 bytes that lie inside the tile
    uint32_t at_q0 = 0, at_q1 = 0;
    unsigned cols_q0 = 0, cols_q1 = 0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int chunk = q * 32 + (lane & (lpr - 1));
      const uint32_t at = tile_at<T>(m0, chunk * V, G.box_bytes);
      unsigned cols = 0;
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (chunk < cpr && chunk * V + v < bs) cols |= 1u << v;
      if (q == 0) {
        at_q0 = at;
        cols_q0 = cols;
      } else {
        at_q1 = at;
        cols_q1 = cols;
      }
    }
    const unsigned below = (1u << lane) - 1u;

    for (int t = 0; t < n; ++t) {
      const int st = t % S;
      mbar_wait(full + 8 * st, (t / S) & 1);
      bool dirty = true;
      if constexpr (MODE != kFull) {
        mbar_wait(checked + 8 * st, (t / S) & 1);
        dirty = flags[st] || own_dirty;
      }
      const unsigned char* stage = smem + st * G.stage;
      const T* xc = reinterpret_cast<const T*>(stage + tile_bytes);
      const T* ec = reinterpret_cast<const T*>(stage + tile_bytes + G.x_bytes);

      int cnt = 0;  // entries on the list
      for (int f0 = 0; f0 < n_units; f0 += kBatch) {
        VecT wb[kBatch];
        unsigned inb[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int f = f0 + u, i = f >> ush, q = f & ush;
          const int m = m0 + i * row_step;
          inb[u] = f < n_units && m < bs ? (q ? cols_q1 : cols_q0) : 0u;
          wb[u] = inb[u] ? *reinterpret_cast<const VecT*>(
                               stage + (q ? at_q1 : at_q0) +
                               i * row_step * kRowBytes)
                         : VecT{};
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int f = f0 + u;
          if (f >= n_units) break;
          const int m = m0 + (f >> ush) * row_step;
          const T* w = reinterpret_cast<const T*>(&wb[u]);
          unsigned keep = inb[u];
          if constexpr (MODE != kFull) {
            if (!dirty) {
#pragma unroll
              for (int v = 0; v < V; ++v)
                if (w[v] == T(0)) keep &= ~(1u << v);
            }
          }
          if (!__any_sync(0xffffffffu, keep != 0u)) continue;
          const int j0 = (lane & (lpr - 1)) * V + (f & ush) * 32 * V;

          if constexpr (MODE == kDivergent) {
            // each lane evaluates its own non-zero entries (the warp runs
            // phi as often as its busiest lane has entries), then the
            // lanes of a row are summed
            double acc[KC];
#pragma unroll
            for (int c = 0; c < KC; ++c) acc[c] = 0.0;
            for (unsigned rest = keep; rest != 0u; rest &= rest - 1u) {
              const int v = __ffs(rest) - 1;
              T wv = w[0];
#pragma unroll
              for (int k = 1; k < V; ++k)
                if (v == k) wv = w[k];
              const int j = j0 + v;
#pragma unroll
              for (int c = 0; c < KC; ++c) {
                if (c < kc) {
                  T ei = T(0), ej = T(0);
                  if constexpr (kE) {
                    ei = er[m * KC + c];
                    ej = ec[j * KC + c];
                  }
                  acc[c] += term<T, KIND>(wv, xr[m * KC + c], xc[j * KC + c],
                                          ei, ej, ring);
                }
              }
            }
#pragma unroll
            for (int c = 0; c < KC; ++c)
              for (int off = lpr / 2; off > 0; off >>= 1)
                acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
            if ((lane & (lpr - 1)) == 0 && m < bs) {
#pragma unroll
              for (int c = 0; c < KC; ++c)
                if (c < kc) ys[m * KC + c] += acc[c];
            }
          } else {
            // compact the kept entries onto the list, in row-major order
            int total = 0, before = 0;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const unsigned ball =
                  __ballot_sync(0xffffffffu, (keep >> v) & 1u);
              total += __popc(ball);
              before += __popc(ball & below);
            }
            if (cnt + total > kCap) {
              evaluate(cnt, xc, ec);
              cnt = 0;
            }
            int at = cnt + before;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              if ((keep >> v) & 1u) {
                pl[at] = static_cast<uint16_t>((m << 8) | (j0 + v));
                wl[at] = w[v];
                ++at;
              }
            }
            cnt += total;
          }
        }
      }
      if constexpr (MODE != kDivergent) evaluate(cnt, xc, ec);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);  // done with stage st
    }
  }

  __syncthreads();
  for (int e = tid; e < bs * kc; e += kThreads) {
    const int i = e / kc, c = e - i * kc;
    if (row0 + i < n_rows)
      Y[(row0 + i) * ld + c0 + c] = static_cast<T>(ys[i * KC + c]);
  }
}

struct Args {
  const int32_t* indptr;
  const int32_t* indices;
  const void* blocks;
  int64_t n_blocks;
  const void* X;
  const void* E;
  void* Y;
  int32_t n_rb, n_rows, n_x, bs, ld, c0, kc;
  double p, eps;
  cudaStream_t stream;
};

template <typename T, int KIND, int MODE, int KC>
int launch(const Args& a) {
  const Layout L = layout<T, KIND, KC>(a.bs);
  if (a.bs > kMaxBlock || L.bytes > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm;
  int tma = 0;
  const int err = encode_tiles<T>(&tm, a.blocks, a.n_blocks, a.bs, &tma);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      phi_kernel<T, KIND, MODE, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  phi_kernel<T, KIND, MODE, KC><<<a.n_rb, kThreads, L.bytes, a.stream>>>(
      tm, tma, a.indptr, a.indices, static_cast<const T*>(a.blocks),
      static_cast<const T*>(a.X), static_cast<const T*>(a.E),
      static_cast<T*>(a.Y), a.n_rows, a.n_x, a.bs, a.ld, a.c0, a.kc,
      phi_p::make_ring<T>(a.p, a.eps));
  return static_cast<int>(cudaGetLastError());
}

// the compiled widths: 1, 2, 4, 8 for fp32; 1, 2, 4 for fp64
template <typename T, int KIND, int MODE>
int launch_width(int width, const Args& a) {
  switch (width) {
    case 1:
      return launch<T, KIND, MODE, 1>(a);
    case 2:
      return launch<T, KIND, MODE, 2>(a);
    case 4:
      return launch<T, KIND, MODE, 4>(a);
    case 8:
      if constexpr (sizeof(T) == 4) return launch<T, KIND, MODE, 8>(a);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int KIND>
int launch_mode(int mode, int width, const Args& a) {
  if (mode == kSkip) return launch_width<T, KIND, kSkip>(width, a);
  if (mode == kFull) return launch_width<T, KIND, kFull>(width, a);
  if constexpr (sizeof(T) == 4) {
    if (mode == kDivergent && width == 4)
      return launch<T, KIND, kDivergent, 4>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_kind(int kind, int mode, int width, const Args& a) {
  if (kind == kApply) return launch_mode<T, kApply>(mode, width, a);
  if (kind == kHvp) return launch_mode<T, kHvp>(mode, width, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (bound with ctypes): enqueues one launch on
// ``stream`` of ``device`` for the column window [c0, c0 + kc), whose
// width the wrapper rounded up to ``width`` (a template instance), over
// ``n_blocks`` tiles, in ``mode`` (0 skip, 1 full, 2 divergent); returns
// 0, a CUDA error code or one of the tensor-map encoder's codes
// (error_string names each).  For the apply, E is X.
extern "C" int plap_edge_launch(int kind, int mode, int is_f64, int device,
                                const int32_t* indptr, const int32_t* indices,
                                const void* blocks, const void* X,
                                const void* E, void* Y, int32_t n_rb,
                                int32_t n, int32_t bs, int32_t ld, int32_t c0,
                                int32_t kc, int32_t width, int64_t n_blocks,
                                double p, double eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rb == 0 || kc == 0) return 0;
  if (kc > width) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{indptr, indices, blocks, n_blocks, X, E, Y, n_rb, n, n, bs,
               ld, c0, kc, p, eps, static_cast<cudaStream_t>(stream)};
  return is_f64 ? launch_kind<double>(kind, mode, width, a)
                : launch_kind<float>(kind, mode, width, a);
}

extern "C" const char* error_string(int code) { return error_name(code); }
