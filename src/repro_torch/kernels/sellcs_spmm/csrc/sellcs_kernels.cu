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
// the original id of permuted row r, so the kernel reads X and writes Y in
// the caller's order: no permuted copies, one launch for all width runs.
//
// What bounds it on this card: bytes.  Each stored slot streams a 4-byte
// column id and one value (k values for multivalues); each slot gathers
// one row of X (and of E for kind 2) from wherever its column lies; each
// output row is written once.  The arithmetic (one pow per slot and
// column for kinds 1 and 2) is far below the card's fp32 rate.  The design
// keeps the streamed part coalesced: thread t owns output element
// (r, c) = (t / k, t % k), so the k threads of a row read the same slot
// (one broadcast) and neighbouring rows read neighbouring slots; the
// gathers of the k columns of one neighbour row are one contiguous
// k-value segment.  Each output element is owned by exactly one thread:
// no atomics, and the sum runs over the slots in order, so the result is
// deterministic.
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

template <typename T, int KIND>
__global__ void __launch_bounds__(256) sellcs_kernel(
    const int32_t* __restrict__ slice_ptr, const int32_t* __restrict__ slice_w,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ cols,
    const T* __restrict__ vals, int64_t v_row, int64_t v_col,
    const T* __restrict__ X, const T* __restrict__ E, T* __restrict__ Y,
    int32_t n, int32_t C, int32_t k, Ring<T> ring) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(n) * k) return;
  const int32_t r = static_cast<int32_t>(t / k);
  const int32_t c = static_cast<int32_t>(t - static_cast<int64_t>(r) * k);
  const int32_t s = r / C;
  const int32_t w = slice_w[s];
  const int64_t slot0 = static_cast<int64_t>(slice_ptr[s]) + (r - s * C);
  const int64_t own = static_cast<int64_t>(perm[r]) * k + c;
  T xi = T(0);
  T ei = T(0);
  if constexpr (KIND != kReals) xi = X[own];
  if constexpr (KIND == kHvp) ei = E[own];
  T acc = T(0);
  for (int32_t j = 0; j < w; ++j) {
    const int64_t slot = slot0 + static_cast<int64_t>(j) * C;
    const int64_t src = static_cast<int64_t>(cols[slot]) * k + c;
    const T v = vals[slot * v_row + c * v_col];
    if constexpr (KIND == kReals) {
      acc += v * X[src];
    } else if constexpr (KIND == kApply) {
      acc += v * phi(xi - X[src], ring);
    } else {
      acc += v * phi_prime(xi - X[src], ring) * (ei - E[src]);
    }
  }
  Y[own] = acc;
}

template <typename T, int KIND>
void launch(const int32_t* slice_ptr, const int32_t* slice_w,
            const int32_t* perm, const int32_t* cols, const void* vals,
            int64_t v_row, int64_t v_col, const void* X, const void* E,
            void* Y, int32_t n, int32_t C, int32_t k, double p, double eps,
            cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(n) * k;
  if (total == 0) return;
  const Ring<T> ring = phi_p::make_ring<T>(p, eps);
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  sellcs_kernel<T, KIND><<<blocks, kThreads, 0, stream>>>(
      slice_ptr, slice_w, perm, cols, static_cast<const T*>(vals), v_row,
      v_col, static_cast<const T*>(X), static_cast<const T*>(E),
      static_cast<T*>(Y), n, C, k, ring);
}

template <typename T>
void launch_kind(int kind, const int32_t* slice_ptr, const int32_t* slice_w,
                 const int32_t* perm, const int32_t* cols, const void* vals,
                 int64_t v_row, int64_t v_col, const void* X, const void* E,
                 void* Y, int32_t n, int32_t C, int32_t k, double p,
                 double eps, cudaStream_t stream) {
  switch (kind) {
    case kReals:
      launch<T, kReals>(slice_ptr, slice_w, perm, cols, vals, v_row, v_col, X,
                        E, Y, n, C, k, p, eps, stream);
      break;
    case kApply:
      launch<T, kApply>(slice_ptr, slice_w, perm, cols, vals, v_row, v_col, X,
                        E, Y, n, C, k, p, eps, stream);
      break;
    default:
      launch<T, kHvp>(slice_ptr, slice_w, perm, cols, vals, v_row, v_col, X,
                      E, Y, n, C, k, p, eps, stream);
      break;
  }
}

}  // namespace

// Plain C entry point for the binding file.  Enqueues one kernel on
// ``stream`` and returns; the caller checks cudaGetLastError() right after.
extern "C" void sellcs_launch(int kind, int is_f64, const int32_t* slice_ptr,
                              const int32_t* slice_w, const int32_t* perm,
                              const int32_t* cols, const void* vals,
                              int64_t v_row, int64_t v_col, const void* X,
                              const void* E, void* Y, int32_t n, int32_t C,
                              int32_t k, double p, double eps,
                              cudaStream_t stream) {
  if (is_f64) {
    launch_kind<double>(kind, slice_ptr, slice_w, perm, cols, vals, v_row,
                        v_col, X, E, Y, n, C, k, p, eps, stream);
  } else {
    launch_kind<float>(kind, slice_ptr, slice_w, perm, cols, vals, v_row,
                       v_col, X, E, Y, n, C, k, p, eps, stream);
  }
}
