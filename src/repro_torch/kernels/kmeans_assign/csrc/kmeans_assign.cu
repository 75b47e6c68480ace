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
// Two variants, routed by kmeans_assign.launch_plan:
//
// The narrow variant (d <= 16, kc <= 128) is bound by bytes.  At the main
// path's shape (X of 2^20 rows and d = 4, 8 restarts of 4 centroids) it
// reads 16 MB of X and writes 64 MB of labels and distances, against ~11
// operations per (row, centroid) pair.  So: a grid of at most as many
// blocks as the SMs hold at once strides over tiles of rows, each block
// loading every centroid set of the launch and its norms into shared
// memory once;
// a thread takes RPT consecutive rows straight into registers (16-byte
// loads where a row is 16 or 64 bytes), so each centroid read from shared
// memory serves RPT rows, and each set's labels and distances leave as
// one RPT-wide store per array with the streaming hint (__stcs, int4 and
// float4 at d <= 4), still (R, n)-major.
//
// The tiled variant (d > 16 or kc > 128: stage 3 at k > 16, d = kc = k)
// is bound by operations: kc (2d + 4) per row and set.  It is shaped like
// the product X (n x d) . C^T (d x R kc) with an argmin epilogue.  A
// block of 8 warps owns 128 rows, 16 a warp, and stages them once in
// shared memory (every dimension up to 96 fp32 / 64 fp64; beyond that in
// chunks, re-read per centroid tile); the R kc centroids of all sets,
// concatenated, pass over them in tiles of 64 centroids and chunks of at
// most 32 dimensions, each chunk copied by cp.async, transposed, into one
// of two shared buffers while the other is in use.  fp32 takes FMAs,
// each thread a register micro-tile of 4 rows x 8 centroids (one 16-byte
// load of rows and two of centroids per 32 FMAs); fp64 takes the tensor
// cores (mma.m16n8k4, DMMA: the H100's fp64 peak is twice its FMA rate,
// and at stage 3's k = 48 DMMA measured 2.2x faster than the same tiles
// on FMAs).  After a tile's last chunk each warp turns its accumulators
// into distances (the centroid norms come from a kernel launched just
// before, so a tiled call is two launches) and folds each set's part of
// the tile into its rows' (min, argmin) in registers: each lane's first
// minimum, then a butterfly over the lanes of a row.  So X is read from device memory
// once for all the sets, and no (n, R kc) distance ever leaves the SM.
// No TF32.
//
// Both variants keep the arithmetic of each (row, centroid) pair of the
// first design of this kernel: |x|^2, |c|^2 and x.c each an fma chain
// over the dimensions in order from 0 (the fp64 tiled variant: DMMA sums
// x.c four dimensions a step), d2 = xx + cc - 2 dot, clamped at 0 with a
// NaN kept, and the argmin rule
// "c == 0 or d2 < best" in index order: the lowest index wins a tie, and
// a NaN distance to centroid 0 sticks.  So a set's result does not depend
// on R or on how the sets are grouped, and is the same bit for bit from
// run to run.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

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

// N consecutive values (N a multiple of 16 bytes) from 16-byte-aligned p.
template <typename T, int N>
__device__ __forceinline__ void load16(const T* p, T* out) {
  using V = typename Vec16<T>::type;
  constexpr int VW = Vec16<T>::n;
  static_assert(N % VW == 0, "whole 16-byte pieces");
#pragma unroll
  for (int q = 0; q < N / VW; ++q) {
    const V v = reinterpret_cast<const V*>(p)[q];
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < VW; ++i) out[q * VW + i] = e[i];
  }
}

// RPT (2 or 4) values as one streaming vector store (__stcs); fp64 as
// 16-byte pieces.
template <int RPT>
__device__ __forceinline__ void store_rows(int32_t* p, const int32_t* v) {
  static_assert(RPT == 2 || RPT == 4, "two or four rows a thread");
  if constexpr (RPT == 4) {
    __stcs(reinterpret_cast<int4*>(p), make_int4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(reinterpret_cast<int2*>(p), make_int2(v[0], v[1]));
  }
}
template <int RPT>
__device__ __forceinline__ void store_rows(float* p, const float* v) {
  static_assert(RPT == 2 || RPT == 4, "two or four rows a thread");
  if constexpr (RPT == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  }
}
template <int RPT>
__device__ __forceinline__ void store_rows(double* p, const double* v) {
#pragma unroll
  for (int q = 0; q < RPT / 2; ++q)
    __stcs(reinterpret_cast<double2*>(p) + q,
           make_double2(v[2 * q], v[2 * q + 1]));
}

// ------------------------------------------------------------- narrow

// MAXD: the widest row an instance keeps in registers (centroids stored
// with that stride, zero past d); RPT: rows a thread takes at once.
// vec_in: d == MAXD and X on a 16-byte boundary; vec_out: n % RPT == 0
// and both outputs on a 16-byte boundary.
template <typename T, int MAXD, int RPT>
__global__ void __launch_bounds__(kThreads) kmeans_narrow_kernel(
    const T* __restrict__ X, const T* __restrict__ C,
    int32_t* __restrict__ labels, T* __restrict__ dist, int32_t n, int32_t d,
    int32_t kc, int32_t R, bool vec_in, bool vec_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Cs = reinterpret_cast<T*>(smem_raw);   // (R kc, MAXD) centroids
  const int n_cent = R * kc;
  T* cc = Cs + static_cast<int64_t>(n_cent) * MAXD;   // (R kc) |c|^2

  for (int t = threadIdx.x; t < n_cent * MAXD; t += kThreads) {
    const int c = t / MAXD;
    const int e = t - c * MAXD;
    Cs[t] = e < d ? C[static_cast<int64_t>(c) * d + e] : T(0);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_cent; t += kThreads) {
    const T* c = Cs + static_cast<int64_t>(t) * MAXD;
    T s = T(0);
    for (int e = 0; e < d; ++e) s = fma_t(c[e], c[e], s);
    cc[t] = s;
  }
  __syncthreads();

  constexpr int64_t kTile = static_cast<int64_t>(kThreads) * RPT;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kTile; base < n;
       base += static_cast<int64_t>(gridDim.x) * kTile) {
    const int64_t i0 = base + static_cast<int64_t>(threadIdx.x) * RPT;
    if (i0 >= n) break;
    const int nr = static_cast<int>(min(static_cast<int64_t>(RPT), n - i0));
    T x[RPT][MAXD];
    if (vec_in && nr == RPT) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) load16<T, MAXD>(X + (i0 + r) * MAXD, x[r]);
    } else {
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int e = 0; e < MAXD; ++e)
          x[r][e] = (r < nr && e < d) ? X[(i0 + r) * d + e] : T(0);
    }
    T xx[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      xx[r] = T(0);
#pragma unroll
      for (int e = 0; e < MAXD; ++e)
        if (e < d) xx[r] = fma_t(x[r][e], x[r][e], xx[r]);
    }
    for (int s = 0; s < R; ++s) {
      T best[RPT];
      int32_t arg[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        best[r] = T(0);
        arg[r] = 0;
      }
      for (int c = 0; c < kc; ++c) {
        const int j = s * kc + c;
        T cv[MAXD];
        load16<T, MAXD>(Cs + static_cast<int64_t>(j) * MAXD, cv);
        const T ccj = cc[j];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          T dot = T(0);
#pragma unroll
          for (int e = 0; e < MAXD; ++e)
            if (e < d) dot = fma_t(x[r][e], cv[e], dot);
          T d2 = xx[r] + ccj - T(2) * dot;
          d2 = d2 < T(0) ? T(0) : d2;  // clamp at 0; a NaN stays NaN
          if (c == 0 || d2 < best[r]) {  // strict: ties keep the lowest
            best[r] = d2;
            arg[r] = c;
          }
        }
      }
      const int64_t o = static_cast<int64_t>(s) * n + i0;
      if (vec_out && nr == RPT) {
        store_rows<RPT>(labels + o, arg);
        store_rows<RPT>(dist + o, best);
      } else {
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          if (r < nr) {
            __stcs(labels + o + r, arg[r]);
            __stcs(dist + o + r, best[r]);
          }
        }
      }
    }
  }
}

template <typename T, int MAXD, int RPT>
cudaError_t launch_narrow(const void* X, const void* C, void* labels,
                          void* dist, int32_t n, int32_t d, int32_t kc,
                          int32_t R, int device, cudaStream_t stream) {
  auto kernel = kmeans_narrow_kernel<T, MAXD, RPT>;
  const size_t smem = sizeof(T) * static_cast<size_t>(R) * kc * (MAXD + 1);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // as many blocks as an SM's 2048 threads hold; fewer fit where the
  // centroids take much shared memory, and the rest wait their turn
  const int64_t tiles = (static_cast<int64_t>(n) + kThreads * RPT - 1) /
                        (static_cast<int64_t>(kThreads) * RPT);
  const unsigned blocks = static_cast<unsigned>(
      min(tiles, static_cast<int64_t>(sms) * (2048 / kThreads)));
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec_in = d == MAXD && aligned(X);
  const bool vec_out = n % RPT == 0 && aligned(labels) && aligned(dist);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(C),
      static_cast<int32_t*>(labels), static_cast<T*>(dist), n, d, kc, R,
      vec_in, vec_out);
  return cudaGetLastError();
}

// ------------------------------------------------------------- tiled

constexpr int kBM = 128;          // rows per block, 16 per warp
constexpr int kBN = 64;           // centroids per tile
constexpr int kPad = 4;           // row padding of Xs and Cs (elements)

// How a block's threads own its (kBM x kBN) tile of distances; warp w
// always owns rows 16w .. 16w + 15 and all kBN centroids.  fp32 (FMAs):
// a thread 4 rows x 8 centroids (centroids tx 4 .. + 4 and 32 + tx 4 ..
// + 4, tx = lane % 8, so the 8 column groups read 128 contiguous bytes:
// one 16-byte load of rows and two of centroids per 32 fp32 FMAs).  fp64
// (DMMA): eight n8 tiles of mma.m16n8k4, a thread the
// accumulator elements (rows g and g + 8, centroids 2t, 2t + 1) of each,
// g = lane / 4, t = lane % 4.  row(): the row within the warp's 16;
// ``lanes`` lanes (lane % lanes) share a row; owner(col): which of them
// holds a column.
template <typename T>
struct Owner;
template <>
struct Owner<float> {
  static constexpr int RT = 4, CT = 8, lanes = 8;
  __device__ static int row(int lane, int i) { return (lane / 8) * RT + i; }
  __device__ static int col(int lane, int j) {
    return (j / 4) * 32 + (lane % 8) * 4 + j % 4;
  }
  __device__ static int owner(int col) { return (col % 32) / 4; }
};
template <>
struct Owner<double> {
  static constexpr int RT = 2, CT = 16, lanes = 4;
  __device__ static int row(int lane, int i) { return i * 8 + lane / 4; }
  __device__ static int col(int lane, int j) {
    return (j / 2) * 8 + (lane % 4) * 2 + j % 2;
  }
  __device__ static int owner(int col) { return (col % 8) / 2; }
};

template <typename T>
struct Tiled {
  static constexpr int XD = sizeof(T) == 4 ? 96 : 64;   // X dims resident
  static constexpr int KC = 32;                         // dims a chunk, most
  static constexpr int LDX = kBM + kPad;   // Xs row stride (16-byte rows)
  static constexpr int LDC = kBN + kPad;   // Cs row stride
  static constexpr int CS = KC * LDC;      // one Cs buffer
  static constexpr size_t smem =
      sizeof(T) * (static_cast<size_t>(XD) * LDX + 2 * CS + kBM);
};

// |c|^2 of the R kc centroids (a pass before the tiled kernel): an fma
// chain over the dimensions in order from 0.
template <typename T>
__global__ void __launch_bounds__(kThreads) centroid_norms_kernel(
    const T* __restrict__ C, T* __restrict__ cc, int32_t N, int32_t d) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= N) return;
  const T* c = C + static_cast<int64_t>(j) * d;
  T s = T(0);
  for (int e = 0; e < d; ++e) s = fma_t(c[e], c[e], s);
  cc[j] = s;
}

// One element global -> shared, asynchronously (cp.async; zeros where
// !valid).
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? static_cast<int>(sizeof(T)) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(bytes));
  }
}

// D (16 x 8) += A (16 x 4) B (4 x 8) in fp64 on the tensor cores, the
// sm_90 shape: a thread holds A (g, t) and (g + 8, t), B (t, g), and D
// (g, 2t + {0, 1}) in d0, d1 and (g + 8, 2t + {0, 1}) in d2, d3.
__device__ __forceinline__ void dmma(double& d0, double& d1, double& d2,
                                     double& d3, double a0, double a1,
                                     double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(b));
}

// The products of one chunk: dims [0, ke) of Cs against dims
// [xoff, xoff + ke) of the warp's rows Xw of Xs, into the thread's
// accumulators.  fp32: an fma chain per pair in dimension order.  fp64
// (DMMA): steps of 4 dimensions (Xs and Cs hold zeros up to the next
// multiple of 4).
template <typename T>
__device__ __forceinline__ void chunk_products(
    T (&acc)[Owner<T>::RT][Owner<T>::CT], const T* Xw, const T* Cs,
    int xoff, int ke, int lane) {
  using P = Tiled<T>;
  if constexpr (sizeof(T) == 4) {
#pragma unroll 4
    for (int e = 0; e < ke; ++e) {
      T xv[4], cv[8];
      load16<T, 4>(Xw + (xoff + e) * P::LDX + (lane / 8) * 4, xv);
      load16<T, 4>(Cs + e * P::LDC + (lane % 8) * 4, cv);
      load16<T, 4>(Cs + e * P::LDC + 32 + (lane % 8) * 4, cv + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fma_t(xv[i], cv[j], acc[i][j]);
    }
  } else {
    const int g = lane / 4;
    const int t = lane % 4;
#pragma unroll 2
    for (int k0 = 0; k0 < ke; k0 += 4) {
      const T* xr = Xw + (xoff + k0 + t) * P::LDX + g;
      const T* cr = Cs + (k0 + t) * P::LDC + g;
      const T a0 = xr[0], a1 = xr[8];
      T b[8];
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) b[nj] = cr[nj * 8];
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
        dmma(acc[0][2 * nj], acc[0][2 * nj + 1], acc[1][2 * nj],
             acc[1][2 * nj + 1], a0, a1, b[nj]);
    }
  }
}

// fp64: registers capped at 128 a thread, so two blocks share an SM
// (their shared memory fits), one block's epilogue and barriers
// overlapping the other's products (measured faster, despite a few
// spills; fp32 with three blocks measured slower than with two)
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 8 ? 2 : 1)
    kmeans_tiled_kernel(
    const T* __restrict__ X, const T* __restrict__ C,
    const T* __restrict__ cc, int32_t* __restrict__ labels,
    T* __restrict__ dist, int32_t n, int32_t d, int32_t kc, int32_t R) {
  using P = Tiled<T>;
  using O = Owner<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);   // (XD, LDX): dims x rows
  T* Cs = Xs + P::XD * P::LDX;              // 2 x (KC, LDC): dims x cents
  T* xxs = Cs + 2 * P::CS;                  // (kBM) |x|^2

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int w = tid / 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int N = R * kc;
  const int d4 = (d + 3) & ~3;
  const bool resident = d4 <= P::XD;
  const int nch = (d + P::KC - 1) / P::KC;                  // chunks a tile
  const int kch = (((d + nch - 1) / nch) + 3) & ~3;         // dims a chunk
  const int ntiles = (N + kBN - 1) / kBN;
  const int steps = ntiles * nch;
  const T* Xw = Xs + 16 * w;                // the warp's rows

  // rows [row0, row0 + kBM) x dims [e0, e0 + ke) into Xs[e][m], zeros in
  // dims [ke, ke rounded up to 4)
  auto stage_x = [&](int e0, int ke) {
    for (int q = tid; q < kBM * ke; q += kThreads) {
      const int m = q / ke;
      const int e = q - m * ke;
      const int64_t row = row0 + m;
      Xs[e * P::LDX + m] = row < n ? X[row * d + e0 + e] : T(0);
    }
    for (int q = tid; q < kBM * (((ke + 3) & ~3) - ke); q += kThreads)
      Xs[(ke + q / kBM) * P::LDX + q % kBM] = T(0);
  };
  // the centroid chunk of step s into Cs buffer s % 2, transposed, by
  // cp.async: element q = (column q / KC, dimension q % KC), so a warp
  // reads consecutive dimensions of one centroid; zeros past the chunk
  // and past the last centroid
  auto fetch_c = [&](int s) {
    const int tile = s / nch;
    const int e0 = (s - tile * nch) * kch;
    const int ke = min(kch, d - e0);
    T* buf = Cs + (s % 2) * P::CS;
    for (int q = tid; q < P::KC * kBN; q += kThreads) {
      const int col = q / P::KC;
      const int e = q - col * P::KC;
      const int j = tile * kBN + col;
      const bool valid = e < ke && j < N;
      cp_async(buf + e * P::LDC + col,
               valid ? C + static_cast<int64_t>(j) * d + e0 + e : C, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  fetch_c(0);
  if (resident) stage_x(0, d);
  __syncthreads();
  // |x|^2 of the block's rows: an fma chain in dimension order
  if (tid < kBM) {
    const int64_t row = row0 + tid;
    T s = T(0);
    if (resident) {
#pragma unroll 8
      for (int e = 0; e < d; ++e) s = fma_t(Xs[e * P::LDX + tid],
                                            Xs[e * P::LDX + tid], s);
    } else if (row < n) {
      for (int e = 0; e < d; ++e) s = fma_t(X[row * d + e], X[row * d + e], s);
    }
    xxs[tid] = s;
  }

  T acc[O::RT][O::CT];
#pragma unroll
  for (int i = 0; i < O::RT; ++i)
#pragma unroll
    for (int j = 0; j < O::CT; ++j) acc[i][j] = T(0);
  // (min, argmin) so far of the thread's rows in the open set, the same
  // in every lane that shares the row
  T best[O::RT];
  int32_t arg[O::RT];
#pragma unroll
  for (int i = 0; i < O::RT; ++i) {
    best[i] = T(0);
    arg[i] = 0;
  }

  for (int s = 0; s < steps; ++s) {
    const int tile = s / nch;
    const int ch = s - tile * nch;
    const int e0 = ch * kch;
    const int ke = min(kch, d - e0);
    const int xoff = resident ? e0 : 0;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // chunk s has landed, and every reader of chunk s - 1 (and of Xs) is
    // done
    __syncthreads();
    if (s + 1 < steps) fetch_c(s + 1);   // in flight during the products
    if (!resident) {
      stage_x(e0, ke);
      __syncthreads();
    }
    chunk_products<T>(acc, Xw, Cs + (s % 2) * P::CS, xoff, ke, lane);
    if (ch != nch - 1) continue;

    // the tile's last chunk: the distances, then each row's fold of each
    // set's part of the tile, in registers and shuffles
    const int t0 = tile * kBN;
#pragma unroll
    for (int i = 0; i < O::RT; ++i) {
      const T xx = xxs[16 * w + O::row(lane, i)];
#pragma unroll
      for (int j = 0; j < O::CT; ++j) {
        const int col = t0 + O::col(lane, j);
        const T d2 = xx + (col < N ? __ldg(cc + col) : T(0)) -
                     T(2) * acc[i][j];
        acc[i][j] = d2 < T(0) ? T(0) : d2;  // clamp at 0; a NaN stays NaN
      }
    }
    const int t1 = min(N, t0 + kBN);
    for (int s0 = t0; s0 < t1;) {
      const int set = s0 / kc;      // the set of columns [s0, s1)
      const int col0 = set * kc;    // its centroid 0
      const int end = col0 + kc;
      const int s1 = min(t1, end);
#pragma unroll
      for (int i = 0; i < O::RT; ++i) {
        // the rule "c == 0 or d2 < best" in index order: centroid 0 sets
        // (best, arg); past it the first occurrence of the minimum, if
        // below best.  Each lane finds the first minimum of its columns
        // (strict <, in order), the lanes of the row the smallest value,
        // then the lowest column, of theirs.
        T m = T(INFINITY), v0 = T(0);
        int32_t mc = end;
#pragma unroll
        for (int j = 0; j < O::CT; ++j) {
          const int col = t0 + O::col(lane, j);
          if (col == col0) v0 = acc[i][j];
          if (col > col0 && col >= s0 && col < s1 && acc[i][j] < m) {
            m = acc[i][j];
            mc = col;
          }
        }
#pragma unroll
        for (int off = O::lanes / 2; off > 0; off >>= 1) {
          const T om = __shfl_xor_sync(0xffffffffu, m, off);
          const int32_t oc = __shfl_xor_sync(0xffffffffu, mc, off);
          if (om < m || (om == m && oc < mc)) {
            m = om;
            mc = oc;
          }
        }
        if (col0 >= s0) {   // centroid 0 lies in this tile
          best[i] = __shfl_sync(0xffffffffu, v0,
                                lane - lane % O::lanes +
                                    O::owner(col0 - t0));
          arg[i] = 0;
        }
        if (m < best[i]) {  // a NaN best (from centroid 0) sticks
          best[i] = m;
          arg[i] = mc - col0;
        }
        const int64_t row = row0 + 16 * w + O::row(lane, i);
        if (s1 == end && lane % O::lanes == i && row < n) {
          const int64_t o = static_cast<int64_t>(set) * n + row;
          __stcs(labels + o, arg[i]);
          __stcs(dist + o, best[i]);
        }
      }
      s0 = s1;
    }
#pragma unroll
    for (int i = 0; i < O::RT; ++i)
#pragma unroll
      for (int j = 0; j < O::CT; ++j) acc[i][j] = T(0);
  }
}

// The norms pass, then the tiled kernel: two launches on ``stream``.
template <typename T>
cudaError_t launch_tiled(const void* X, const void* C, void* cc,
                         void* labels, void* dist, int32_t n, int32_t d,
                         int32_t kc, int32_t R, cudaStream_t stream) {
  const int32_t N = R * kc;
  centroid_norms_kernel<T><<<(N + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(static_cast<const T*>(C),
                                       static_cast<T*>(cc), N, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = kmeans_tiled_kernel<T>;
  const size_t smem = Tiled<T>::smem;
  // the function's attributes, once a device (the calls are not free)
  static bool configured[64] = {};
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || !configured[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (device < 64) configured[device] = true;
  }
  const unsigned blocks = static_cast<unsigned>((n + kBM - 1) / kBM);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(C),
      static_cast<const T*>(cc), static_cast<int32_t*>(labels),
      static_cast<T*>(dist), n, d, kc, R);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_narrow(const void* X, const void* C, void* labels,
                            void* dist, int32_t n, int32_t d, int32_t kc,
                            int32_t R, int device, cudaStream_t s) {
  if (d <= 4)
    return launch_narrow<T, 4, 4>(X, C, labels, dist, n, d, kc, R, device, s);
  return launch_narrow<T, 16, 2>(X, C, labels, dist, n, d, kc, R, device, s);
}

}  // namespace

// Plain C entry points (bound with ctypes): each enqueues one launch on
// ``stream`` of ``device`` and returns the CUDA error code (0 =
// accepted).  The wrapper has checked the operands: n >= 1, d >= 1,
// kc >= 1, R >= 1, R kc < 2^31; for the narrow variant d <= 16,
// kc <= 128 and that the centroids fit one block's shared memory.
extern "C" int kmeans_assign_launch(int is_f64, int device, const void* X,
                                    const void* C, void* labels, void* dist,
                                    int32_t n, int32_t d, int32_t kc,
                                    int32_t R, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_f64
            ? dispatch_narrow<double>(X, C, labels, dist, n, d, kc, R, device, s)
            : dispatch_narrow<float>(X, C, labels, dist, n, d, kc, R, device, s);
  return static_cast<int>(err);
}

// The tiled variant: fp32 products on FMAs, fp64 on the tensor cores
// (DMMA).  ``cc``: scratch for the R kc centroid norms.
extern "C" int kmeans_assign_tiled_launch(int is_f64, int device,
                                          const void* X, const void* C,
                                          void* labels, void* dist, int32_t n,
                                          int32_t d, int32_t kc, int32_t R,
                                          void* stream, void* cc) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_f64
            ? launch_tiled<double>(X, C, cc, labels, dist, n, d, kc, R, s)
            : launch_tiled<float>(X, C, cc, labels, dist, n, d, kc, R, s);
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
