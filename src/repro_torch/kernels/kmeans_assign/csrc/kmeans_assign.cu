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
//
// The wide variant (kmeans_assign_wide_kernel) takes what the narrow one
// cannot: rows wider than 64 values or more than 128 centroids, as
// stage 3 gives at k > 64 (d = kc = k).  A block of 128 threads owns 128
// rows, one each, and walks the centroids of one set in chunks of 32,
// the row and each chunk's centroids staged through shared memory in
// chunks of 32 dimensions; a thread keeps its 32 partial dot products in
// registers and reads the centroids as 16-byte broadcasts.  Like the
// narrow variant it adds every product dimension by dimension from 0,
// clamps at 0, and compares the centroids in index order with a strict
// <, carrying (min, argmin) from one chunk to the next, so the lowest
// index wins a tie.  It is bound by operations at stage 3's shapes
// (kc (2d + 4) per row and set against 4 d bytes read), and re-reads X
// once per centroid chunk and set, mostly from L2.
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

constexpr int kWRows = 128;  // wide variant: rows per block, one per thread
constexpr int kWCent = 32;   // centroids per chunk (partial sums in registers)
constexpr int kWDim = 32;    // dimensions per staged chunk

// Centroid chunk's values as 16-byte broadcasts: Cs is (kWDim, kWCent),
// dimension-major, so one load gives 16 / sizeof(T) centroids at one
// dimension.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename T>
__device__ __forceinline__ void unpack(const typename Vec16<T>::type& v,
                                       T* out);
template <>
__device__ __forceinline__ void unpack<float>(const float4& v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
template <>
__device__ __forceinline__ void unpack<double>(const double2& v,
                                               double* out) {
  out[0] = v.x;
  out[1] = v.y;
}

template <typename T>
__global__ void __launch_bounds__(kWRows)
    kmeans_assign_wide_kernel(const T* __restrict__ X,
                              const T* __restrict__ C,
                              int32_t* __restrict__ labels,
                              T* __restrict__ dist, int32_t n, int32_t d,
                              int32_t kc) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::n;
  __shared__ T Xs[kWRows][kWDim + 1];                  // rows x dims
  // dims x centroids; 4 spare columns spread the staging stores' banks
  __shared__ __align__(16) T Cs[kWDim][kWCent + 4];
  __shared__ T ccs[kWCent];                            // |c|^2 of the chunk

  const int r = blockIdx.y;                            // centroid set
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kWRows;
  const int rows = static_cast<int>(min(static_cast<int64_t>(kWRows),
                                        static_cast<int64_t>(n) - row0));
  const int tid = threadIdx.x;
  const T* Cr = C + static_cast<int64_t>(r) * kc * d;
  const T* Xb = X + row0 * d;

  T xx = T(0);
  T best = T(0);
  int32_t arg = 0;
  for (int cb = 0; cb < kc; cb += kWCent) {
    const int nc = min(kWCent, kc - cb);
    T acc[kWCent];
#pragma unroll
    for (int c = 0; c < kWCent; ++c) acc[c] = T(0);
    T cc = T(0);  // thread tid < nc: |c_(cb + tid)|^2
    for (int e0 = 0; e0 < d; e0 += kWDim) {
      const int ne = min(kWDim, d - e0);
      __syncthreads();  // the previous chunk's readers are done
      for (int t = tid; t < rows * ne; t += kWRows) {
        const int i = t / ne;
        const int e = t - i * ne;
        Xs[i][e] = Xb[static_cast<int64_t>(i) * d + e0 + e];
      }
      for (int t = tid; t < kWDim * kWCent; t += kWRows) {
        const int c = t / kWDim;
        const int e = t - c * kWDim;
        Cs[e][c] = (c < nc && e < ne)
                       ? Cr[static_cast<int64_t>(cb + c) * d + e0 + e]
                       : T(0);
      }
      __syncthreads();
      if (tid < nc) {
        for (int e = 0; e < ne; ++e) cc = fma_t(Cs[e][tid], Cs[e][tid], cc);
      }
      if (tid < rows) {
        for (int e = 0; e < ne; ++e) {
          const T xe = Xs[tid][e];
          if (cb == 0) xx = fma_t(xe, xe, xx);
#pragma unroll
          for (int c4 = 0; c4 < kWCent; c4 += kV) {
            T cv[kV];
            unpack<T>(*reinterpret_cast<const V*>(&Cs[e][c4]), cv);
#pragma unroll
            for (int q = 0; q < kV; ++q) acc[c4 + q] = fma_t(xe, cv[q], acc[c4 + q]);
          }
        }
      }
    }
    if (tid < nc) ccs[tid] = cc;
    __syncthreads();
    if (tid < rows) {
      for (int c = 0; c < nc; ++c) {
        T d2 = xx + ccs[c] - T(2) * acc[c];
        d2 = d2 < T(0) ? T(0) : d2;  // clamp at 0; a NaN stays NaN
        if (cb + c == 0 || d2 < best) {  // strict: ties keep the lowest
          best = d2;
          arg = cb + c;
        }
      }
    }
  }
  if (tid < rows) {
    const int64_t i = static_cast<int64_t>(r) * n + row0 + tid;
    labels[i] = arg;
    dist[i] = best;
  }
}

template <typename T>
cudaError_t launch_wide(const void* X, const void* C, void* labels,
                        void* dist, int32_t n, int32_t d, int32_t kc,
                        int32_t R, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kWRows - 1) / kWRows),
                  static_cast<unsigned>(R));
  kmeans_assign_wide_kernel<T><<<grid, kWRows, 0, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(C),
      static_cast<int32_t*>(labels), static_cast<T*>(dist), n, d, kc);
  return cudaGetLastError();
}

}  // namespace

// The wide variant's C entry point, as kmeans_assign_launch; any n >= 1,
// d >= 1, kc >= 1 and R <= 65535 (the grid's y extent).
extern "C" int kmeans_assign_wide_launch(int is_f64, int device,
                                         const void* X, const void* C,
                                         void* labels, void* dist, int32_t n,
                                         int32_t d, int32_t kc, int32_t R,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_f64 ? launch_wide<double>(X, C, labels, dist, n, d, kc, R, s)
               : launch_wide<float>(X, C, labels, dist, n, d, kc, R, s);
  return static_cast<int>(err);
}

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
