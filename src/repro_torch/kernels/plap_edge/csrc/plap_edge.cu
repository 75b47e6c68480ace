// Fused p-Laplacian kernels over BSR tiles for Hopper (sm_90a).
//
// Replaces the reference's Pallas kernels of
// src/repro/kernels/plap_edge/plap_edge.py:
//
//   kind 1  plap_apply_pallas  y_i = sum_j w_ij phi_p(x_i - x_j)
//           (the gradient op of every trust-region step)
//   kind 2  plap_hvp_pallas    y_i = sum_j w_ij phi'_p(u_i - u_j)(e_i - e_j)
//           (the matrix-free Hessian apply)
//
// Both evaluate the nonlinearity on every (i, j) of every stored tile,
// zero weights included, as the reference does over its (bs, bs, k)
// broadcast in VMEM; nothing is materialised in device memory.  The
// design is the tile skeleton of ../../csrc/bsr_tiles.cuh: one thread
// block per row-block, looping over its tiles.
//
// What bounds it on this card.  By the byte count, the tiles (4.66 GB of
// fp32 for delaunay_graph(20) at bs = 128, one pass) give about 1.4 ms a
// call at 3.35 TB/s.  But each stored value costs k evaluations of phi
// (one pow) or phi' (two pows) on the CUDA cores, and pow is a sequence
// of instructions, not one: the kernels may well be bound by that
// arithmetic instead, which this simple design does nothing to shrink
// (it evaluates the same terms as the reference; skipping zero weights
// is a later optimisation).  The design keeps everything else off the
// critical path: the tile is read once, coalesced, each value reused for
// all k columns from a register, and x_i, x_j (u, e) come from shared
// memory.
//
// Zero weights.  With eps > 0 every term is finite: at x_i = x_j,
// phi(0) = 0 and phi'(0) = eps^((p-2)/2) (about 1.6e3 at p = 1.2,
// eps = 1e-8), so a zero weight contributes exactly 0, as in the
// reference.  At eps = 0, phi'(0) = inf for p < 2 and 0 * inf = NaN: the
// port evaluates the same product in the same order as the reference's
// oracle (w * phi'(du) * de), so it returns NaN wherever the reference
// does: in every row whose tiles hold a column j with u_j = u_i, the
// row's own column included.
#include <cuda_runtime.h>

#include <cstdint>

#include "bsr_tiles.cuh"

// Plain C entry point (bound with ctypes): enqueues one launch on
// ``stream`` of ``device`` and returns the CUDA error code (0 = accepted).
extern "C" int plap_edge_launch(int kind, int is_f64, int device,
                                const int32_t* indptr, const int32_t* indices,
                                const void* blocks, const void* X,
                                const void* E, void* Y, int32_t n_rb,
                                int32_t n, int32_t bs, int32_t ld, int32_t c0,
                                int32_t kc, double p, double eps,
                                void* stream) {
  using namespace bsr_tiles;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kind == kApply) {
    err = is_f64 ? launch<double, kApply>(indptr, indices, blocks, X, X, Y,
                                          n_rb, n, n, bs, ld, c0, kc, p, eps,
                                          s)
                 : launch<float, kApply>(indptr, indices, blocks, X, X, Y,
                                         n_rb, n, n, bs, ld, c0, kc, p, eps,
                                         s);
  } else if (kind == kHvp) {
    err = is_f64 ? launch<double, kHvp>(indptr, indices, blocks, X, E, Y,
                                        n_rb, n, n, bs, ld, c0, kc, p, eps, s)
                 : launch<float, kHvp>(indptr, indices, blocks, X, E, Y,
                                       n_rb, n, n, bs, ld, c0, kc, p, eps, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
