// One kernel skeleton over the BSR layout (containers._build_bsr), used by
// plap_edge/csrc/plap_edge.cu (bsr_spmm/csrc/bsr_spmm.cu has its own).
//
//   kApply  y_i = sum_j w_ij phi_p(x_i - x_j)             (plap_apply)
//   kHvp    y_i = sum_j w_ij phi'_p(u_i - u_j) (e_i - e_j) (plap_hvp)
//
// where j runs over every column of every stored (bs, bs) tile of row i's
// row-block, zero weights included: the terms the reference evaluates.
//
// The TPU kernels run one grid step per stored tile on a sequential grid
// and keep the output row-block in VMEM across the consecutive tiles of a
// row-block.  Hopper's blocks run in parallel and in no order, so here one
// thread block owns one row-block and loops over its tiles
// [indptr[rb], indptr[rb+1]): no atomics, no second pass, and each output
// element is summed in the same order on every run (deterministic).
//
// Per tile the block stages the tile's (bs, kc) slice of X (and of E) in
// shared memory, column-major so the 32 lanes of a warp read 32
// consecutive words; the row-block's own rows of X (and E) are staged
// once.  Warp w takes tile rows i = w, w + 8, ...: its lanes read the
// tile row w_i,: coalesced (lane l takes columns l, l + 32, ...), each
// lane sums its terms for up to kColChunk output columns in registers, a
// shuffle tree sums the warp, and lane 0 adds the total to the
// row-block's output in shared memory (row i is only ever touched by
// warp i % 8).  The output is written once, after the last tile.
//
// The multivector is (rows, ld) row-major and one launch covers the column
// window [c0, c0 + kc), so the wrapper can split a wide multivector into
// windows whose staging fits in shared memory.  Columns past n_x of the
// last column-block read as 0 and rows past n_rows of the last row-block
// are not written: the ragged edge is masked, nothing is copied, and the
// terms equal the reference's, which pads X with zero rows.  A row-block
// without tiles is written as zeros.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "phi.cuh"

namespace bsr_tiles {

enum Kind { kApply = 1, kHvp = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColChunk = 4;

// (bs, kc) buffers staged in shared memory: the output, then X's
// neighbour slice, X's own rows, E's neighbour slice, E's own rows
template <int KIND>
constexpr int staged_buffers() {
  return KIND == kApply ? 3 : 5;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads) tile_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    const T* __restrict__ blocks, const T* __restrict__ X,
    const T* __restrict__ E, T* __restrict__ Y, int32_t n_rows, int32_t n_x,
    int32_t bs, int32_t ld, int32_t c0, int32_t kc, phi_p::Ring<T> ring) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bk = bs * kc;
  T* ys = reinterpret_cast<T*>(smem_raw);  // (bs, kc) output, row-major
  T* xc = ys + bk;                         // (kc, bs) X neighbours
  T* xr = xc + bk;                         // (bs, kc) X own rows
  T* ec = xr + bk;                         // (kc, bs) E neighbours
  T* er = ec + bk;                         // (bs, kc) E own rows
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * bs;

  for (int t = threadIdx.x; t < bk; t += kThreads) {
    ys[t] = T(0);
    const int r = t / kc;
    const int64_t g = (row0 + r) * ld + c0 + (t - r * kc);
    const bool in = row0 + r < n_x;
    xr[t] = in ? X[g] : T(0);
    if constexpr (KIND == kHvp) er[t] = in ? E[g] : T(0);
  }

  const int32_t b_end = indptr[blockIdx.x + 1];
  for (int32_t b = indptr[blockIdx.x]; b < b_end; ++b) {
    const int64_t col0 = static_cast<int64_t>(indices[b]) * bs;
    __syncthreads();  // the last tile's reads of xc / ec are done
    for (int t = threadIdx.x; t < bk; t += kThreads) {
      const int j = t / kc;
      const int c = t - j * kc;
      const int64_t g = (col0 + j) * ld + c0 + c;
      const bool in = col0 + j < n_x;
      xc[c * bs + j] = in ? X[g] : T(0);
      if constexpr (KIND == kHvp) ec[c * bs + j] = in ? E[g] : T(0);
    }
    __syncthreads();
    const T* tile = blocks + static_cast<int64_t>(b) * bs * bs;
    for (int i = warp; i < bs; i += kWarps) {
      const T* w_row = tile + static_cast<int64_t>(i) * bs;
      for (int cb = 0; cb < kc; cb += kColChunk) {
        T acc[kColChunk];
#pragma unroll
        for (int q = 0; q < kColChunk; ++q) acc[q] = T(0);
        for (int j = lane; j < bs; j += 32) {
          const T w = w_row[j];
#pragma unroll
          for (int q = 0; q < kColChunk; ++q) {
            const int c = cb + q;
            if (c < kc) {
              const T xi = xr[i * kc + c];
              T ei = T(0), ej = T(0);
              if constexpr (KIND == kHvp) {
                ei = er[i * kc + c];
                ej = ec[c * bs + j];
              }
              acc[q] += term<T, KIND>(w, xi, xc[c * bs + j], ei, ej, ring);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kColChunk; ++q) {
          if (cb + q < kc) {  // uniform across the warp
            const T s = warp_sum(acc[q]);
            if (lane == 0) ys[i * kc + cb + q] += s;
          }
        }
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < bk; t += kThreads) {
    const int r = t / kc;
    if (row0 + r < n_rows) Y[(row0 + r) * ld + c0 + (t - r * kc)] = ys[t];
  }
}

// Enqueue one launch on ``stream``: one block per row-block.  Returns the
// CUDA error of the launch (cudaSuccess when it was accepted).
template <typename T, int KIND>
cudaError_t launch(const int32_t* indptr, const int32_t* indices,
                   const void* blocks, const void* X, const void* E, void* Y,
                   int32_t n_rb, int32_t n_rows, int32_t n_x, int32_t bs,
                   int32_t ld, int32_t c0, int32_t kc, double p, double eps,
                   cudaStream_t stream) {
  if (n_rb == 0 || kc == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(staged_buffers<KIND>()) * bs * kc *
                      sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_kernel<T, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  tile_kernel<T, KIND><<<n_rb, kThreads, smem, stream>>>(
      indptr, indices, static_cast<const T*>(blocks),
      static_cast<const T*>(X), static_cast<const T*>(E),
      static_cast<T*>(Y), n_rows, n_x, bs, ld, c0, kc,
      phi_p::make_ring<T>(p, eps));
  return cudaGetLastError();
}

}  // namespace bsr_tiles
