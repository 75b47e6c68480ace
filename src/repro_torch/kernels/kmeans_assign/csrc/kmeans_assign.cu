// Fused kmeans assignment for Hopper (sm_90a): for every row x of X and
// every centroid set r of C (R, kc, d),
//
//   d2(x, c) = max(||x||^2 + ||c||^2 - 2 x.c, 0),
//   label = argmin_c d2 (lowest index on ties),  dist = min_c d2.
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/kmeans_assign/kmeans_assign.py::kmeans_assign_pallas
// (a grid over row tiles of X, the centroids VMEM-resident across the
// grid, one (bm, d) x (d, kc) MXU product and an iota/min-select argmin
// per step).  It computes the same identity, not (x - c)^2, so it
// differs from the plain version only by rounding.  The reference
// ``vmap``s its restarts; here a batch of R centroid sets runs in one
// launch, and X is read once for all of them.
//
// What bounds it on this card: bytes.  At the main path's shape (X of
// 2^20 rows and d = 4, 8 restarts of 4 centroids) it reads 16 MB of X and
// writes 64 MB of labels and distances, against ~11 operations per
// (row, centroid) pair.  So: the centroids and their norms live in shared
// memory; each block stages its rows of X through shared memory with
// consecutive threads on consecutive addresses (row stride padded to an
// odd number of words, so the per-row reads are conflict-free); one
// thread owns one row and keeps it in registers; outputs are written
// (R, n)-major, so a warp's stores are coalesced.  Products are plain
// FMAs in the input type: no TF32.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 256;  // rows of X per block, one per thread

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int MAXD>
__global__ void __launch_bounds__(kRows)
    kmeans_assign_kernel(const T* __restrict__ X, const T* __restrict__ C,
                         int32_t* __restrict__ labels, T* __restrict__ dist,
                         int32_t n, int32_t d, int32_t kc, int32_t R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Cs = reinterpret_cast<T*>(smem_raw);   // (R, kc, d) centroids
  T* cc = Cs + static_cast<int64_t>(R) * kc * d;   // (R, kc) |c|^2
  T* Xs = cc + R * kc;                       // (kRows, ldx) rows of X
  const int ldx = d | 1;

  const int n_cent = R * kc;
  for (int t = threadIdx.x; t < n_cent * d; t += kRows) Cs[t] = C[t];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kRows),
                                        static_cast<int64_t>(n) - row0));
  const T* Xb = X + row0 * d;
  for (int t = threadIdx.x; t < rows * d; t += kRows)
    Xs[(t / d) * ldx + t % d] = Xb[t];
  __syncthreads();
  for (int t = threadIdx.x; t < n_cent; t += kRows) {
    const T* c = Cs + static_cast<int64_t>(t) * d;
    T s = T(0);
    for (int e = 0; e < d; ++e) s = fma_t(c[e], c[e], s);
    cc[t] = s;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= rows) return;

  T x[MAXD];
  T xx = T(0);
#pragma unroll
  for (int e = 0; e < MAXD; ++e) {
    x[e] = e < d ? Xs[threadIdx.x * ldx + e] : T(0);
    xx = fma_t(x[e], x[e], xx);
  }
  const int64_t i = row0 + threadIdx.x;
  for (int r = 0; r < R; ++r) {
    const T* Cr = Cs + static_cast<int64_t>(r) * kc * d;
    const T* ccr = cc + r * kc;
    T best = T(0);
    int32_t arg = 0;
    for (int c = 0; c < kc; ++c) {
      T dot = T(0);
#pragma unroll
      for (int e = 0; e < MAXD; ++e)
        if (e < d) dot = fma_t(x[e], Cr[c * d + e], dot);
      T d2 = xx + ccr[c] - T(2) * dot;
      d2 = d2 < T(0) ? T(0) : d2;  // clamp at 0; a NaN stays NaN
      if (c == 0 || d2 < best) {    // strict: ties keep the lowest index
        best = d2;
        arg = c;
      }
    }
    labels[static_cast<int64_t>(r) * n + i] = arg;
    dist[static_cast<int64_t>(r) * n + i] = best;
  }
}

template <typename T, int MAXD>
cudaError_t launch(const void* X, const void* C, void* labels, void* dist,
                   int32_t n, int32_t d, int32_t kc, int32_t R,
                   cudaStream_t stream) {
  auto kernel = kmeans_assign_kernel<T, MAXD>;
  const size_t smem =
      sizeof(T) * (static_cast<size_t>(R) * kc * (d + 1) +
                   static_cast<size_t>(kRows) * (d | 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>((n + kRows - 1) / kRows);
  kernel<<<blocks, kRows, smem, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(C),
      static_cast<int32_t*>(labels), static_cast<T*>(dist), n, d, kc, R);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* X, const void* C, void* labels, void* dist,
                     int32_t n, int32_t d, int32_t kc, int32_t R,
                     cudaStream_t s) {
  if (d <= 4) return launch<T, 4>(X, C, labels, dist, n, d, kc, R, s);
  if (d <= 16) return launch<T, 16>(X, C, labels, dist, n, d, kc, R, s);
  return launch<T, 64>(X, C, labels, dist, n, d, kc, R, s);
}

}  // namespace

// Plain C entry point (bound with ctypes): enqueues one launch on
// ``stream`` of ``device`` and returns the CUDA error code (0 = accepted).
// The wrapper has checked n >= 1, 1 <= d <= 64, 1 <= kc <= 128 and that
// the shared memory fits one block.
extern "C" int kmeans_assign_launch(int is_f64, int device, const void* X,
                                    const void* C, void* labels, void* dist,
                                    int32_t n, int32_t d, int32_t kc,
                                    int32_t R, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_f64 ? dispatch<double>(X, C, labels, dist, n, d, kc, R, s)
               : dispatch<float>(X, C, labels, dist, n, d, kc, R, s);
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
