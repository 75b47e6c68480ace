// Hopper's asynchronous copies, shared by flash_attention_wgmma.cu and
// bsr_spmm.cu: mbarriers, TMA loads through a tensor map, and the host's
// tensor-map encoder.
//
// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime; the
// libraries look it up at run time (cudaGetDriverEntryPoint), so they are
// built by nvcc alone (no -lcuda).  Its failures come back as this
// header's error codes beyond the CUDA runtime's, named by
// ``error_name``.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects ``bytes`` of copies on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 2-D / 3-D tensor map at the given coordinates (innermost
// first) into shared memory, counted on ``bar``'s transaction bytes.
__device__ __forceinline__ void load_2d(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void load_3d(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int c0, int c1,
                                        int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int kErrEntryPoint = 100000;  // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 200000;      // + the encoder's CUresult

// cuTensorMapEncodeTiled, looked up once; returns 0 or an error code
inline int encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (status != cudaDriverEntryPointSuccess || ptr == nullptr)
      return kErrEntryPoint;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return 0;
}

// 0 for success, else an encoder error code
inline int encode_result(CUresult r) {
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

inline const char* error_name(int code) {
  if (code == kErrEntryPoint)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (code >= kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace tma
