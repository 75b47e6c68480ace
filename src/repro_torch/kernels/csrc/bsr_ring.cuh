// The tile stream of the BSR kernels for Hopper, shared by
// bsr_spmm/csrc/bsr_spmm.cu and plap_edge/csrc/plap_edge.cu.
//
// One thread block owns one row-block and walks its tiles
// [indptr[rb], indptr[rb+1]) through a ring of one or two stages in shared
// memory.  A stage holds one (bs, bs) tile, as ``boxes`` boxes of
// ``box_rows`` rows x 128 bytes (the TMA's 128-byte swizzle: the 16-byte
// chunk c of row m sits at chunk c ^ (m % 8), so 8 consecutive rows of one
// column land on 8 different bank groups), then the tile's (bsv, KC)
// column slices of the multivectors (row-major, KC values a row).  Thread
// 0 has the TMA copy the tile (a 2-D tensor map over the tiles, encoded on
// the host by ``encode_tiles``); every thread copies its share of each
// slice with cp.async; all of it lands on the stage's mbarrier, which
// expects 1 + (threads) arrivals.  Tiles the TMA cannot take (rows that
// are not whole 16-byte units, an unaligned base) are copied value by
// value with cp.async instead.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma.cuh"

namespace bsr_ring {

using namespace tma;

constexpr int kSmemLimit = 232448;  // shared memory of one block
constexpr int kRowBytes = 128;      // a tile box's row: 32 fp32, 16 fp64

template <typename T>
struct Vec;  // 16 bytes of T
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// ``N`` bytes, of which the first ``src_bytes`` are read and the rest
// zero-filled
template <int N>
__device__ __forceinline__ void cp_async_fill(uint32_t dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(N), "r"(src_bytes)
               : "memory");
}

// arrive on ``bar`` once this thread's earlier cp.async copies have
// landed (counted among the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// The ring's share of a launch's shared memory (bytes from a 1024-byte
// aligned base).  ``slices`` (bsv, kc_alloc) slices follow the tile in a
// stage; two stages when they fit beside ``extra`` bytes of the kernel's
// own.
struct Ring {
  int boxes, bsv, box_bytes, x_bytes, stage, stages;
};

template <typename T>
__host__ __device__ Ring ring_layout(int bs, int box_rows, int kc_alloc,
                                     int slices, int extra) {
  constexpr int V = 16 / sizeof(T);
  constexpr int E = kRowBytes / sizeof(T);  // values per box row
  Ring r;
  r.boxes = (bs + E - 1) / E;
  r.bsv = (bs + V - 1) / V * V;
  r.box_bytes = box_rows * kRowBytes;
  r.x_bytes = (r.bsv * kc_alloc * static_cast<int>(sizeof(T)) + 1023) /
              1024 * 1024;
  r.stage = r.boxes * r.box_bytes + slices * r.x_bytes;
  r.stages = 2 * r.stage + extra + 1024 + 16 <= kSmemLimit ? 2 : 1;
  return r;
}

// Byte offset of tile value (m, j) in a stage: box j / E, row m, its
// 16-byte chunk XOR-ed with m % 8 (the TMA's 128-byte swizzle).
template <typename T>
__device__ __forceinline__ uint32_t tile_at(int m, int j, int box_bytes) {
  constexpr int V = 16 / sizeof(T);
  constexpr int E = kRowBytes / sizeof(T);
  const int box = j / E, w = j - box * E;
  return box * box_bytes + m * kRowBytes +
         ((((w / V) ^ (m & 7)) * 16) | ((w % V) * sizeof(T)));
}

// Tile b into the stage at shared address ``stage``, counted on ``bar``:
// thread 0 issues the TMA boxes (or, for tiles the TMA cannot take, every
// thread copies values).
template <typename T, int NTHREADS>
__device__ __forceinline__ void load_tile(int tma, const CUtensorMap* tm,
                                          const T* blocks, int32_t b, int bs,
                                          uint32_t stage, uint32_t bar,
                                          const Ring& r, int tid) {
  if (tma) {
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, r.boxes * bs * kRowBytes);
      for (int bx = 0; bx < r.boxes; ++bx)
        load_2d(stage + bx * r.box_bytes, tm, bar,
                bx * (kRowBytes / static_cast<int>(sizeof(T))), b * bs);
    }
  } else {
    const T* tile = blocks + static_cast<int64_t>(b) * bs * bs;
    for (int e = tid; e < bs * bs; e += NTHREADS) {
      const int m = e / bs;
      cp_async_fill<sizeof(T)>(stage + tile_at<T>(m, e - m * bs, r.box_bytes),
                               tile + e, sizeof(T));
    }
    if (tid == 0) mbar_expect_tx(bar, 0);
  }
}

// Rows [col0, col0 + bs) x columns [c0, c0 + KC) of the (rows, ld)
// row-major X into the (bs, KC) slice at ``xs``: zero past n_x rows and
// kc columns.  16-byte copies when ``x16`` (``slice16``), else value by
// value.
template <typename T, int KC, int NTHREADS>
__device__ __forceinline__ void load_slice(const T* X, bool x16,
                                           int64_t col0, int n_x, int ld,
                                           int c0, int kc, int bs,
                                           uint32_t xs, int tid) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (KC % V == 0) {
    if (x16) {
      constexpr int kChunks = KC / V;
      for (int e = tid; e < bs * kChunks; e += NTHREADS) {
        const int j = e / kChunks, c = (e - j * kChunks) * V;
        const bool in = col0 + j < n_x && c < kc;
        cp_async16(xs + (j * KC + c) * sizeof(T),
                   in ? X + (col0 + j) * ld + c0 + c : X, in ? 16 : 0);
      }
      return;
    }
  }
  for (int e = tid; e < bs * KC; e += NTHREADS) {
    const int j = e / KC, c = e - j * KC;
    const bool in = col0 + j < n_x && c < kc;
    cp_async_fill<sizeof(T)>(xs + e * sizeof(T),
                             in ? X + (col0 + j) * ld + c0 + c : X,
                             in ? sizeof(T) : 0);
  }
}

// whether the slices of X can take 16-byte copies: its rows and the
// window 16-byte aligned
template <typename T>
__device__ __forceinline__ bool slice16(const T* X, int ld, int c0, int kc) {
  constexpr int V = 16 / sizeof(T);
  return (ld * sizeof(T)) % 16 == 0 && (c0 * sizeof(T)) % 16 == 0 &&
         kc % V == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
}

// The tiles as a 2-D tensor (bs columns, n_blocks bs rows): boxes of 128
// bytes by bs rows, 128-byte swizzle.  Encoded only when the TMA can take
// the tiles (16-byte rows); returns 0 or an encoder error code.
template <typename T>
int encode_tiles(CUtensorMap* map, const void* blocks, int64_t n_blocks,
                 int bs, int* tma) {
  *tma = (bs * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(blocks) % 16 == 0 && n_blocks > 0;
  if (!*tma) return 0;
  EncodeTiled fn;
  const int err = encoder(&fn);
  if (err != 0) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(bs),
                              static_cast<cuuint64_t>(n_blocks) * bs};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(bs) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowBytes / sizeof(T)),
                             static_cast<cuuint32_t>(bs)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(
      map,
      sizeof(T) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(blocks), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return encode_result(r);
}

}  // namespace bsr_ring
