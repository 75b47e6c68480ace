// BSR SpMM for Hopper (sm_90a): Y = A X over dense (bs, bs) tiles.
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/bsr_spmm/bsr_spmm.py:46 (bsr_spmm_pallas: one grid
// step and one (bs, bs) @ (bs, k) MXU product per stored tile, the output
// row-block revisited across the tiles of its row-block).
//
// What bounds it on this card: bytes.  Every stored tile is streamed once
// per launch (bs^2 values, 4.66 GB of fp32 tiles for delaunay_graph(20) at
// bs = 128, where 0.54% of the stored values are non-zero): 1.4 ms at
// 3.35 TB/s, against 2 k operations per stored value (0.83 ms of fp32
// FMAs at 67 TFLOP/s for the k = 24 columns of LOBPCG's [X, R, P] block).
// What the design does about it:
//
// * Each tile is read from device memory exactly once per launch, for
//   every column of the launch's window.  One thread block owns one
//   row-block and loops over its tiles (no atomics: every output is
//   summed in the same order on every run).  Tiles pass through a
//   double-buffered ring in shared memory: while tile t is multiplied,
//   thread 0 has the TMA copy tile t + 1 (a 2-D tensor map over the
//   tiles, boxes of 128 bytes by bs rows, 128-byte swizzle) and every
//   thread copies its share of the tile's (bs, kc) slice of X with
//   cp.async (16-byte copies where the window is aligned), zero-filled
//   past the matrix's columns and the window's width; all of it lands on
//   one mbarrier.  With the copies off the threads' instruction stream,
//   loads and FMAs overlap.  (fp64 at bs = 128 has room for one stage;
//   tiles whose rows are not whole 16-byte units take element copies.)
// * Register-blocked outputs.  Lane l of every warp owns rows l, l + 32,
//   ... (R = bs / 32 of them) and all KC columns of the window, kept in
//   registers across the row-block's tiles; warp w takes the tile columns
//   j of every 8th group of 16 bytes (4 fp32 values).  Per group a lane
//   reads R vectors of the tile (the swizzle puts 8 consecutive rows on 8
//   different bank groups) and, broadcast to the whole warp, the 4 rows
//   of X, for 4 R KC FMAs: no per-term shuffle reduction.  The 8 warps'
//   partial sums are added once per row-block, in warp order, through
//   shared memory.  KC (the window's width rounded up to 4, 8, 16, 24 or
//   32 for fp32; 2, 4, 8 or 16 for fp64) and R are template parameters,
//   so k = 4, 8 and 24 each compile to a fixed unroll; the wrapper cuts
//   wider multivectors into windows (``spmm_windows``).
// * Plain fp32 (fp64) FMAs: no TF32, so the fp32 result holds the
//   reference's 1e-5 bound against a dense product.
//
// The multivector is (rows, ld) row-major and one launch covers the column
// window [c0, c0 + kc).  Columns past n_x of the last column-block read as
// 0 and rows past n_rows of the last row-block are not written.  A
// row-block without tiles is written as zeros.  bs is at most 128.  The
// ring, its loads and the tensor map (encoded on the host at every launch)
// are shared with the phi kernels (../../csrc/bsr_ring.cuh).
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bsr_ring.cuh"

namespace {

using namespace bsr_ring;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Shared memory of one launch from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes): the ring
// (../../csrc/bsr_ring.cuh), a stage being one tile as ``boxes`` boxes of
// 32 R rows x 128 bytes (rows past bs zero) and its (bsv, KC) slice of X;
// after the last tile the ring holds the warps' partial sums,
// (kWarps, KC, 32 R + 1); the stages' mbarriers follow.
struct Layout {
  Ring ring;
  int bars, bytes;
};

template <typename T, int KC, int R>
__host__ __device__ Layout layout(int bs) {
  Layout L;
  L.ring = ring_layout<T>(bs, 32 * R, KC, 1, 0);
  const int ring = L.ring.stages * L.ring.stage;
  const int red = kWarps * KC * (32 * R + 1) * static_cast<int>(sizeof(T));
  L.bars = ring > red ? ring : red;
  L.bytes = L.bars + 8 * L.ring.stages + 1024;  // + alignment slack
  return L;
}

template <typename T, int KC, int R>
__global__ void __launch_bounds__(kThreads) spmm_kernel(
    const __grid_constant__ CUtensorMap tm_tiles, int tma,
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    const T* __restrict__ blocks, const T* __restrict__ X,
    T* __restrict__ Y, int32_t n_rows, int32_t n_x, int32_t bs, int32_t ld,
    int32_t c0, int32_t kc) {
  using VecT = typename Vec<T>::type;
  constexpr int V = 16 / sizeof(T);
  constexpr int kRows = 32 * R;
  constexpr int kBoxBytes = kRows * kRowBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Layout L = layout<T, KC, R>(bs);
  const Ring& G = L.ring;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  const uint32_t full = base + L.bars;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x_off = G.boxes * kBoxBytes;
  const bool x16 = slice16<T>(X, ld, c0, kc);

  // the pads are never copied into: zero them once (tile rows
  // [bs, 32 R) and, without the TMA, columns [bs, boxes E); X rows
  // [bs, bsv))
  for (int st = 0; st < G.stages; ++st) {
    unsigned char* stage = smem + st * G.stage;
    const int width = G.boxes * (kRowBytes / sizeof(T));
    for (int e = tid; e < kRows * width; e += kThreads) {
      const int m = e / width, j = e - m * width;
      if (m >= bs || (!tma && j >= bs))
        *reinterpret_cast<T*>(stage + tile_at<T>(m, j, kBoxBytes)) = T(0);
    }
    T* xs = reinterpret_cast<T*>(stage + x_off);
    for (int e = bs * KC + tid; e < G.bsv * KC; e += kThreads) xs[e] = T(0);
  }
  if (tid == 0) {
    for (int st = 0; st < G.stages; ++st)
      mbar_init(full + 8 * st, 1 + kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int32_t b_begin = indptr[blockIdx.x];
  const int n = indptr[blockIdx.x + 1] - b_begin;

  // Tile t and its slice of X into stage st, landing on full[st]
  auto load = [&](int t, int st) {
    const uint32_t stage = base + st * G.stage;
    const uint32_t bar = full + 8 * st;
    const int32_t b = b_begin + t;
    load_tile<T, kThreads>(tma, &tm_tiles, blocks, b, bs, stage, bar, G, tid);
    load_slice<T, KC, kThreads>(X, x16, static_cast<int64_t>(indices[b]) * bs,
                                n_x, ld, c0, kc, bs, stage + x_off, tid);
    cp_async_arrive(bar);
  };

  T acc[R][KC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[r][c] = T(0);

  if (n > 0) load(0, 0);
  for (int t = 0; t < n; ++t) {
    const int st = t % G.stages;
    // the stage tile t - 1 used, freed by the barrier that ended it
    if (G.stages > 1 && t + 1 < n) load(t + 1, (t + 1) % G.stages);
    mbar_wait(full + 8 * st, (t / G.stages) & 1);

    const unsigned char* stage = smem + st * G.stage;
    const T* xs = reinterpret_cast<const T*>(stage + x_off);
    for (int q = warp; q < G.bsv / V; q += kWarps) {
      const int j0 = q * V;
      VecT w[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        w[r] = *reinterpret_cast<const VecT*>(
            stage + tile_at<T>(lane + 32 * r, j0, kBoxBytes));
#pragma unroll
      for (int jj = 0; jj < V; ++jj) {
        const T* xr = xs + (j0 + jj) * KC;
#pragma unroll
        for (int cv = 0; cv < KC / V; ++cv) {
          const VecT x = *reinterpret_cast<const VecT*>(xr + cv * V);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const T wv = reinterpret_cast<const T*>(&w[r])[jj];
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[r][cv * V + e] =
                  fma(wv, reinterpret_cast<const T*>(&x)[e],
                      acc[r][cv * V + e]);
          }
        }
      }
    }
    __syncthreads();  // stage st is free for tile t + stages
    if (G.stages == 1 && t + 1 < n) load(t + 1, 0);
  }

  // the warps' partial sums, added in warp order
  __syncthreads();
  constexpr int kRed = kRows + 1;
  T* red = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < KC; ++c)
      red[(warp * KC + c) * kRed + lane + 32 * r] = acc[r][c];
  __syncthreads();
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * bs;
  for (int e = tid; e < bs * kc; e += kThreads) {
    const int i = e / kc, c = e - i * kc;
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * KC + c) * kRed + i];
    if (row0 + i < n_rows) Y[(row0 + i) * ld + c0 + c] = s;
  }
}

template <typename T, int KC, int R>
int launch(const int32_t* indptr, const int32_t* indices, const void* blocks,
           int64_t n_blocks, const void* X, void* Y, int32_t n_rb,
           int32_t n_rows, int32_t n_x, int32_t bs, int32_t ld, int32_t c0,
           int32_t kc, cudaStream_t stream) {
  const Layout L = layout<T, KC, R>(bs);
  if (L.bytes > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm;
  int tma = 0;
  const int err = encode_tiles<T>(&tm, blocks, n_blocks, bs, &tma);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      spmm_kernel<T, KC, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L.bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  spmm_kernel<T, KC, R><<<n_rb, kThreads, L.bytes, stream>>>(
      tm, tma, indptr, indices, static_cast<const T*>(blocks),
      static_cast<const T*>(X), static_cast<T*>(Y), n_rows, n_x, bs, ld, c0,
      kc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KC>
int launch_rows(const int32_t* indptr, const int32_t* indices,
                const void* blocks, int64_t n_blocks, const void* X, void* Y,
                int32_t n_rb, int32_t n_rows, int32_t n_x, int32_t bs,
                int32_t ld, int32_t c0, int32_t kc, cudaStream_t stream) {
  if (bs <= 32)
    return launch<T, KC, 1>(indptr, indices, blocks, n_blocks, X, Y, n_rb,
                            n_rows, n_x, bs, ld, c0, kc, stream);
  if (bs <= 64)
    return launch<T, KC, 2>(indptr, indices, blocks, n_blocks, X, Y, n_rb,
                            n_rows, n_x, bs, ld, c0, kc, stream);
  if (bs <= 128)
    return launch<T, KC, 4>(indptr, indices, blocks, n_blocks, X, Y, n_rb,
                            n_rows, n_x, bs, ld, c0, kc, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (bound with ctypes): enqueues one launch on
// ``stream`` of ``device`` for the column window [c0, c0 + kc), whose
// width the wrapper rounded up to ``width`` (a template instance), over
// ``n_blocks`` tiles, and returns 0, a CUDA error code or one of this
// library's codes (error_string names each).
extern "C" int bsr_spmm_launch(int is_f64, int device, const int32_t* indptr,
                               const int32_t* indices, const void* blocks,
                               const void* X, void* Y, int32_t n_rb,
                               int32_t n_rows, int32_t n_cols, int32_t bs,
                               int32_t ld, int32_t c0, int32_t kc,
                               int32_t width, int64_t n_blocks,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rb == 0 || kc == 0) return 0;
  if (kc > width) return static_cast<int>(cudaErrorInvalidValue);
#define BSR_SPMM_WIDTH(T, W)                                                \
  case W:                                                                   \
    return launch_rows<T, W>(indptr, indices, blocks, n_blocks, X, Y, n_rb, \
                             n_rows, n_cols, bs, ld, c0, kc, s);
  if (is_f64) {
    switch (width) {
      BSR_SPMM_WIDTH(double, 2)
      BSR_SPMM_WIDTH(double, 4)
      BSR_SPMM_WIDTH(double, 8)
      BSR_SPMM_WIDTH(double, 16)
      default:
        err = cudaErrorInvalidValue;
    }
  } else {
    switch (width) {
      BSR_SPMM_WIDTH(float, 4)
      BSR_SPMM_WIDTH(float, 8)
      BSR_SPMM_WIDTH(float, 16)
      BSR_SPMM_WIDTH(float, 24)
      BSR_SPMM_WIDTH(float, 32)
      default:
        err = cudaErrorInvalidValue;
    }
  }
#undef BSR_SPMM_WIDTH
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) { return error_name(code); }
