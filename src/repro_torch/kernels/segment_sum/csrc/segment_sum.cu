// Fixed-order segmented float sum for Hopper (sm_90a):
//
//   out[s, c] = sum over entries e of segment s, in entry order, of
//               values[e, c]
//
// The COO backend's reals-ring reduction and SparseMatrix.row_sums.  A
// float index_add_ on the card adds with atomics, in an order that
// changes from run to run, so two runs of one solve could differ in the
// last bits and then in their iteration counts.  Here every output is
// owned by one thread, which adds its segment's entries one after the
// other from 0, in entry order: the result is the same on every run, and
// equal bit for bit to the CPU's sequential index_add_ over the same
// entries.  Not a port of a TPU kernel (the reference's segment_sum is an
// XLA scatter-add); a helper of the port.
//
// Entries arrive grouped by segment: segment s holds entries
// [ptr[s], ptr[s+1]) of ``order`` (or of the entries themselves when
// ``order`` is null): the CSR row pointers of a matrix whose entries are
// sorted by row, or pointers the wrapper builds by a stable sort of the
// segment ids, so each segment keeps its entries' original order.
//
// What bounds it on this card: bytes.  Each value is read once and each
// output written once.  Thread t owns output element (s, c) =
// (t / m, t % m), so the m threads of a segment read the m contiguous
// values of each of its entries together.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
    segment_sum_kernel(const T* __restrict__ values,
                       const int64_t* __restrict__ ptr,
                       const int64_t* __restrict__ order, T* __restrict__ out,
                       int64_t n_seg, int64_t m) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_seg * m) return;
  const int64_t s = t / m;
  const int64_t c = t - s * m;
  const int64_t end = ptr[s + 1];
  T acc = T(0);
  for (int64_t e = ptr[s]; e < end; ++e) {
    const int64_t row = order == nullptr ? e : order[e];
    acc += values[row * m + c];
  }
  out[t] = acc;
}

template <typename T>
cudaError_t launch(const void* values, const int64_t* ptr,
                   const int64_t* order, void* out, int64_t n_seg, int64_t m,
                   cudaStream_t stream) {
  const int64_t total = n_seg * m;
  if (total == 0) return cudaSuccess;
  constexpr int kThreads = 256;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  segment_sum_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(values), ptr, order, static_cast<T*>(out), n_seg,
      m);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes): enqueues one launch on
// ``stream`` of ``device`` and returns the CUDA error code (0 = accepted).
// ``order`` may be null.
extern "C" int segment_sum_launch(int is_f64, int device, const void* values,
                                  const void* ptr, const void* order,
                                  void* out, int64_t n_seg, int64_t m,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const int64_t*>(ptr);
  const auto* o = static_cast<const int64_t*>(order);
  err = is_f64 ? launch<double>(values, p, o, out, n_seg, m, s)
               : launch<float>(values, p, o, out, n_seg, m, s);
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
