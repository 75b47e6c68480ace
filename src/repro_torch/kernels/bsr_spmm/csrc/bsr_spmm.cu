// BSR SpMM for Hopper (sm_90a): Y = A X over dense (bs, bs) tiles.
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/bsr_spmm/bsr_spmm.py::bsr_spmm_pallas (one grid step
// and one (bs, bs) @ (bs, k) MXU product per stored tile, the output
// row-block revisited across the tiles of its row-block).  The design is
// the tile skeleton of ../../csrc/bsr_tiles.cuh: one thread block per
// row-block, looping over its tiles.
//
// What bounds it on this card: bytes.  Every stored tile is streamed once
// (bs^2 values, 4.66 GB of fp32 tiles for delaunay_graph(20) at bs = 128,
// where 0.54% of the stored values are non-zero), against 2 k operations
// per stored value.  The tile rows are read coalesced by whole warps and
// each tile value is used for all k columns from a register; the
// (bs, k) slice of X a tile multiplies comes from shared memory.  Products
// are plain fp32 (or fp64) FMAs: no TF32 and no tensor cores, so the fp32
// result holds the reference's 1e-5 bound against a dense product.
#include <cuda_runtime.h>

#include <cstdint>

#include "bsr_tiles.cuh"

// Plain C entry point (bound with ctypes): enqueues one launch on
// ``stream`` of ``device`` and returns the CUDA error code (0 = accepted).
extern "C" int bsr_spmm_launch(int is_f64, int device, const int32_t* indptr,
                               const int32_t* indices, const void* blocks,
                               const void* X, void* Y, int32_t n_rb,
                               int32_t n_rows, int32_t n_cols, int32_t bs,
                               int32_t ld, int32_t c0, int32_t kc,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err =
      is_f64 ? bsr_tiles::launch<double, bsr_tiles::kReals>(
                   indptr, indices, blocks, X, X, Y, n_rb, n_rows, n_cols, bs,
                   ld, c0, kc, 0.0, 0.0, s)
             : bsr_tiles::launch<float, bsr_tiles::kReals>(
                   indptr, indices, blocks, X, X, Y, n_rb, n_rows, n_cols, bs,
                   ld, c0, kc, 0.0, 0.0, s);
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
