// SELL-C-sigma SpMM kernels for Hopper (sm_90a), one launch per layout.
//
// Replaces the three Pallas kernels of the reference
// (src/repro/kernels/sellcs_spmm/sellcs_spmm.py), which run one
// pallas_call per width run of equal-width slices:
//
//   kind 0  reals ring   y_i = sum_j a_ij x_j                 <- _reals_kernel
//           (sellcs_spmm_pallas; here also for (slots, k) multivalues,
//           the Algorithm-1 W-hat SpMM the reference ran as jnp)
//   kind 1  plap apply   y_i = sum_j w_ij phi_p(x_i - x_j)    <- _apply_kernel
//           (sellcs_plap_apply_pallas, the gradient op)
//   kind 2  plap hvp     y_i = sum_j w_ij phi'_p(u_i - u_j) (e_i - e_j)
//                                                              <- _hvp_kernel
//           (sellcs_plap_hvp_pallas, the matrix-free Hessian apply)
//
// Layout (containers.SellKernelLayout): slice s of C permuted rows stores
// its slot j at slice_ptr[s] + j*C + lane, so the C rows of one slot are
// consecutive in memory.  Column ids are ORIGINAL row ids and perm[r] is
// the original id of permuted row r, so the kernels read X and write Y in
// the caller's order: no permuted copies, one launch for all width runs.
//
// What bounds them on this card: bytes.  Each stored slot streams a
// 4-byte column id and one value (k values for multivalues); each slot
// gathers one row of X (and of E for kind 2) from wherever its column
// lies, mostly from L2; each output row is written once.
//
// All three kinds run sell_row_kernel: G lanes own one permuted row, each
// lane at most two 16-byte pieces of it (lane g: pieces g, g + G, ...),
// with the row's column sums in registers (and, for the apply and the
// HVP, the row's own values of X, and of E); G is 1 up to 32-byte rows
// (k <= 8 fp32, k <= 4 fp64).  At C = 32 and G = 1 a warp is one slice;
// other C and G span or share warps, and any C works.  So one slot step
// of a warp is one coalesced load of column ids and one of values (a
// multivalue row is read as pieces of one contiguous k-value vector), and
// the gathers (X, and E for the HVP) are 16-byte loads through the
// read-only path, the G lanes of a row reading its contiguous pieces in
// one instruction: the L1 handles one cache line per row and instruction
// instead of one per 16 bytes, which is what a lane per row costs at
// k = 24.  The slots are taken U at a time: the U
// column ids and values are loaded, then the U gathers issued, before the
// arithmetic of any of them; w is uniform across a slice, so the masked
// group at a row's end diverges no warp whose rows lie in one slice.  The
// streamed column ids and values are loaded with the evict-first hint, to
// leave L2 to X.
//
// The reals ring walks the blocks in the order ``order`` gives (the
// wrapper sorts them by the original id of their first row): the global
// degree sort interleaves rows from all over X, and visiting the blocks
// in original-id order keeps the rows they gather in L2.  The apply and
// the HVP keep launch order, which measured faster for the apply and the
// same, within 1%, for the HVP.  G, U and the order were chosen by timing
// variants at the main path's shapes on an H100 (PERF.md); the apply
// spends about half its time in powf, the HVP more (two a term), both
// phi.cuh's.
//
// Widths 1, 4, 8, 16 and 24 (the main path's) are compiled; any other k,
// or operands of widths 4-24 off a 16-byte boundary, run the generic
// variant: one lane per row and chunk of 4 columns (grid y), scalar
// loads.  Width 1 (the inverse_power solver's one column) holds one
// value a lane: one 4- or 8-byte gather a slot, which needs only element
// alignment, and phi once a slot where the generic variant's chunk of 4
// evaluates it on three dead columns too.  One gather a slot leaves a
// thread little in flight, so width 1 takes kUnrollOne slots at once
// (U = 2: the apply's device time 0.032 ms against 0.036 at U = 4 and
// 0.039 at U = 8, the HVP's likewise, on delaunay_graph(20) on an H100,
// PERF.md).  Its slot expression and slot order are the generic
// variant's, so the two give the same bits.
//
// Each output is owned by one thread and summed over the slots in order,
// j = 0 .. w-1, with one expression per slot (acc += v * x,
// acc += v * phi(x_i - x_j), acc += v * phi'(u_i - u_j) * (e_i - e_j)),
// the expressions of the first design of these kernels, in which a thread
// owned one output element (r, c) and so read each slot k times: the
// results are those of that design, and the same bit for bit from run to
// run.  Pads store (col = own row, val = 0) and are evaluated like any
// slot (the layout stores about 6 in 10^5 on the Delaunay graphs), so NaN
// and inf land where the plain versions put them.
//
// p and eps are runtime arguments (the Pallas kernels bake them in as
// static values, which retraces per continuation level); phi and phi'
// live in ../../csrc/phi.cuh, shared with the BSR kernels.  Pads store
// (col = own row, val = 0): x_i - x_j = 0 there, phi_p(0) = 0, and
// phi'_p(0) = eps^((p-2)/2) is finite for eps > 0 (about 1.6e3 at
// p = 1.2, eps = 1e-8); its second term, eps^((p-4)/2) (about 1.6e11,
// still finite in fp32), is multiplied by x^2 = 0.  So val * phi' * 0
// stays exactly 0.  pow/powf are used as is and nothing is built with
// fast-math.
#include <cuda_runtime.h>

#include <cstdint>

#include "phi.cuh"

namespace {

enum Kind { kReals = 0, kApply = 1, kHvp = 2 };

using phi_p::Ring;
using phi_p::phi;
using phi_p::phi_prime;

constexpr int kThreads = 256;
constexpr int kChunk = 4;  // columns per thread of the generic variant

// Lanes per row: one per 32 bytes of the row.  sellcs_spmm.launch_plan
// plans the grid for these lanes and passes them in as a check.
__host__ __device__ constexpr int lanes_for(int row_bytes) {
  return row_bytes <= 32 ? 1 : row_bytes / 32;
}
// Slots per step: kUnrollOne for one value a lane (width 1, every kind);
// else 2 while a lane holds at most 16 bytes of a row on the reals ring,
// and 1.
constexpr int kUnrollOne = 2;
__host__ __device__ constexpr int unroll_for(int kind, int lane_values,
                                             int lane_bytes) {
  return lane_values == 1                      ? kUnrollOne
         : kind == kReals && lane_bytes <= 16 ? 2
                                               : 1;
}

template <typename T, int VW>
struct Vec;
template <>
struct Vec<float, 4> {
  using type = float4;
};
template <>
struct Vec<double, 2> {
  using type = double2;
};
template <typename T>
struct Vec<T, 1> {
  using type = T;
};

// VW values from p (VW > 1: one aligned vector load), through the
// read-only path or evict-first.
template <typename T, int VW, bool STREAM>
__device__ __forceinline__ void load_piece(const T* __restrict__ p, T* out) {
  using V = typename Vec<T, VW>::type;
  const V* q = reinterpret_cast<const V*>(p);
  const V v = STREAM ? __ldcs(q) : __ldg(q);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < VW; ++i) out[i] = e[i];
}

template <typename T, int VW>
__device__ __forceinline__ void store_piece(T* __restrict__ p, const T* in) {
  using V = typename Vec<T, VW>::type;
  V v;
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int i = 0; i < VW; ++i) e[i] = in[i];
  *reinterpret_cast<V*>(p) = v;
}

// The NP pieces of VW values a lane owns in one row of k values: piece i
// starts at column c0 + (g + i G) VW; VEC: every piece lies below k and is
// aligned to its VW values (16 bytes, or one value at width 1), else
// pieces are single columns, masked at k.
template <typename T, int NP, int VW, int G, bool VEC, bool STREAM>
__device__ __forceinline__ void load_lane(const T* __restrict__ row, int c0,
                                          int g, int k, T* out) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int col = c0 + (g + i * G) * VW;
    if (VEC || col < k) {
      load_piece<T, VW, STREAM>(row + col, out + i * VW);
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) out[i * VW + e] = T(0);
    }
  }
}

// Every kind.  VEC: k == KW, lanes G = lanes_for(KW bytes), pieces of
// 16 bytes (width 1: one value).  Generic (!VEC): KW = kChunk columns c0 = blockIdx.y * KW
// onwards, one lane per row, single-column pieces.  MV: (slots, k)
// multivalues.  E: the HVP's second multivector (kind 2 only).
// ``order``: the blocks' visiting order, or null.
template <typename T, int KIND, bool MV, int KW, bool VEC>
__global__ void __launch_bounds__(kThreads) sell_row_kernel(
    const int32_t* __restrict__ slice_ptr, const int32_t* __restrict__ slice_w,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ cols,
    const T* __restrict__ vals, const T* __restrict__ X,
    const T* __restrict__ E, T* __restrict__ Y, int32_t n, int32_t C,
    int32_t k, Ring<T> ring, const int32_t* __restrict__ order) {
  constexpr int VW = VEC && KW > 1 ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int G = VEC ? lanes_for(KW * static_cast<int>(sizeof(T))) : 1;
  constexpr int NP = KW / (VW * G);   // pieces per lane
  constexpr int L = NP * VW;          // values per lane
  static_assert(NP * VW * G == KW, "a row splits into whole pieces");
  constexpr int U = unroll_for(KIND, L, L * static_cast<int>(sizeof(T)));
  constexpr int V = MV ? L : 1;
  constexpr int LE = KIND == kHvp ? L : 1;   // values of E a lane holds

  const int32_t blk = order != nullptr
                          ? __ldg(order + blockIdx.x)
                          : static_cast<int32_t>(blockIdx.x);
  const int64_t t = static_cast<int64_t>(blk) * kThreads + threadIdx.x;
  const int32_t r = static_cast<int32_t>(t / G);
  const int g = static_cast<int>(t - static_cast<int64_t>(r) * G);
  if (r >= n) return;
  const int c0 = VEC ? 0 : static_cast<int>(blockIdx.y) * KW;
  const int32_t s = r / C;
  const int32_t w = __ldg(slice_w + s);
  const int64_t slot0 = static_cast<int64_t>(__ldg(slice_ptr + s)) + (r - s * C);
  const int32_t* __restrict__ cp = cols + slot0;             // slot j: cp[j C]
  const int64_t own = static_cast<int64_t>(__ldg(perm + r)) * k;

  T xi[L];
  T ei[LE];
  if constexpr (KIND != kReals)
    load_lane<T, NP, VW, G, VEC, false>(X + own, c0, g, k, xi);
  if constexpr (KIND == kHvp)
    load_lane<T, NP, VW, G, VEC, false>(E + own, c0, g, k, ei);
  T acc[L];
#pragma unroll
  for (int c = 0; c < L; ++c) acc[c] = T(0);

  for (int32_t j = 0; j < w; j += U) {
    int32_t col[U];
    T v[U][V];
    T xj[U][L];
    T ej[U][LE];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = j + u < w;
      const int64_t slot = static_cast<int64_t>(j + u) * C;
      col[u] = live ? __ldcs(cp + slot) : 0;
      if constexpr (MV) {
        if (live)
          load_lane<T, NP, VW, G, VEC, true>(vals + (slot0 + slot) * k, c0, g,
                                             k, v[u]);
      } else {
        v[u][0] = live ? __ldcs(vals + slot0 + slot) : T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j + u < w) {
        const int64_t src = static_cast<int64_t>(col[u]) * k;
        load_lane<T, NP, VW, G, VEC, false>(X + src, c0, g, k, xj[u]);
        if constexpr (KIND == kHvp)
          load_lane<T, NP, VW, G, VEC, false>(E + src, c0, g, k, ej[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j + u < w) {
#pragma unroll
        for (int c = 0; c < L; ++c) {
          const T vv = v[u][MV ? c : 0];
          if constexpr (KIND == kReals) {
            acc[c] += vv * xj[u][c];
          } else if constexpr (KIND == kApply) {
            acc[c] += vv * phi(xi[c] - xj[u][c], ring);
          } else {
            acc[c] += vv * phi_prime(xi[c] - xj[u][c], ring) *
                      (ei[c] - ej[u][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int col = c0 + (g + i * G) * VW;
    if (VEC || col < k) store_piece<T, VW>(Y + own + col, acc + i * VW);
  }
}

struct Args {
  const int32_t* slice_ptr;
  const int32_t* slice_w;
  const int32_t* perm;
  const int32_t* cols;
  const void* vals;
  const void* X;
  const void* E;
  void* Y;
  const int32_t* order;
  int32_t n, C, k;
  double p, eps;
  cudaStream_t stream;
};

template <typename T, int KIND, bool MV, int KW, bool VEC>
cudaError_t launch_row(const Args& a, int lanes) {
  constexpr int G = VEC ? lanes_for(KW * static_cast<int>(sizeof(T))) : 1;
  if (lanes != G) return cudaErrorInvalidValue;
  const int64_t threads = static_cast<int64_t>(a.n) * G;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  VEC ? 1u : static_cast<unsigned>((a.k + KW - 1) / KW));
  sell_row_kernel<T, KIND, MV, KW, VEC><<<grid, kThreads, 0, a.stream>>>(
      a.slice_ptr, a.slice_w, a.perm, a.cols, static_cast<const T*>(a.vals),
      static_cast<const T*>(a.X), static_cast<const T*>(a.E),
      static_cast<T*>(a.Y), a.n, a.C, a.k, phi_p::make_ring<T>(a.p, a.eps),
      a.order);
  return cudaGetLastError();
}

// The compiled (kind, multivalue, width) instances; width 0 is the
// generic variant.  Returns cudaErrorInvalidValue for anything else.
template <typename T, int KIND, bool MV>
cudaError_t dispatch_width(int width, int lanes, const Args& a) {
  switch (width) {
    case 0: return launch_row<T, KIND, MV, kChunk, false>(a, lanes);
    case 1: return launch_row<T, KIND, MV, 1, true>(a, lanes);
    case 4: return launch_row<T, KIND, MV, 4, true>(a, lanes);
    case 8: return launch_row<T, KIND, MV, 8, true>(a, lanes);
    case 16: return launch_row<T, KIND, MV, 16, true>(a, lanes);
    case 24: return launch_row<T, KIND, MV, 24, true>(a, lanes);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int kind, int multivalue, int width, int lanes,
                     const Args& a) {
  if (a.n == 0 || a.k == 0) return cudaSuccess;
  if (kind == kReals) {
    return multivalue ? dispatch_width<T, kReals, true>(width, lanes, a)
                      : dispatch_width<T, kReals, false>(width, lanes, a);
  }
  if (multivalue) return cudaErrorInvalidValue;
  if (kind == kApply) return dispatch_width<T, kApply, false>(width, lanes, a);
  if (kind == kHvp) return dispatch_width<T, kHvp, false>(width, lanes, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes): enqueues one launch of
// ``kind`` on ``stream`` of ``device`` and returns the CUDA error code
// (0 = accepted).  ``width`` and ``lanes`` come from the wrapper's launch
// plan (width 0: the generic variant), ``E`` is the HVP's second
// multivector (read by kind 2 only), and ``order`` is the blocks'
// visiting order or null.  The
// wrapper has checked the operands' devices, dtypes, shapes, contiguity
// and, for a compiled width above 1, their 16-byte alignment.
extern "C" int sellcs_launch(int kind, int is_f64, int multivalue, int width,
                             int lanes, int device,
                             const void* slice_ptr, const void* slice_w,
                             const void* perm, const void* cols,
                             const void* vals, const void* X, const void* E,
                             void* Y, const void* order, int32_t n, int32_t C,
                             int32_t k, double p, double eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const int32_t*>(slice_ptr),
               static_cast<const int32_t*>(slice_w),
               static_cast<const int32_t*>(perm),
               static_cast<const int32_t*>(cols),
               vals, X, E, Y, static_cast<const int32_t*>(order), n, C, k, p,
               eps, static_cast<cudaStream_t>(stream)};
  err = is_f64 ? dispatch<double>(kind, multivalue, width, lanes, a)
               : dispatch<float>(kind, multivalue, width, lanes, a);
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
