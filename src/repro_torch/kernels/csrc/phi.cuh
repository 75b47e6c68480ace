// phi_p and phi'_p on the device, shared by the p-Laplacian kernels of
// sellcs_spmm/csrc/sellcs_kernels.cu and plap_edge/csrc/plap_edge.cu
// (the port of repro/core/phi.py).
//
// p and eps are runtime values: Ring<T> carries the exponents derived
// from them, and eps == 0 takes the exact |x|^(p-1) sign(x) branch at
// run time.  pow/powf are used as is; nothing is built with fast-math.
#pragma once

#include <cuda_runtime.h>

namespace phi_p {

template <typename T>
struct Ring {
  T pm1;      // p - 1
  T pm2;      // p - 2
  T half2;    // (p - 2) / 2
  T half4;    // (p - 4) / 2
  T eps;
  bool exact;  // eps == 0
};

template <typename T>
inline Ring<T> make_ring(double p, double eps) {
  Ring<T> ring;
  ring.pm1 = static_cast<T>(p - 1.0);
  ring.pm2 = static_cast<T>(p - 2.0);
  ring.half2 = static_cast<T>((p - 2.0) / 2.0);
  ring.half4 = static_cast<T>((p - 4.0) / 2.0);
  ring.eps = static_cast<T>(eps);
  ring.exact = eps == 0.0;
  return ring;
}

__device__ __forceinline__ float pow_t(float b, float e) { return powf(b, e); }
__device__ __forceinline__ double pow_t(double b, double e) { return pow(b, e); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T sign_t(T x) {
  return T(x > T(0)) - T(x < T(0));
}

// phi_p(x) = |x|^(p-1) sign(x); smoothed (x^2 + eps)^((p-2)/2) x
template <typename T>
__device__ __forceinline__ T phi(T x, const Ring<T>& g) {
  if (g.exact) return pow_t(abs_t(x), g.pm1) * sign_t(x);
  return pow_t(x * x + g.eps, g.half2) * x;
}

// phi'_p(x) = (p-1)|x|^(p-2); smoothed
// (x^2+eps)^((p-2)/2) + (p-2) x^2 (x^2+eps)^((p-4)/2)
template <typename T>
__device__ __forceinline__ T phi_prime(T x, const Ring<T>& g) {
  if (g.exact) return g.pm1 * pow_t(abs_t(x), g.pm2);
  const T x2e = x * x + g.eps;
  return pow_t(x2e, g.half2) + g.pm2 * x * x * pow_t(x2e, g.half4);
}

}  // namespace phi_p
