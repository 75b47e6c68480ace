// Causal / sliding-window GQA flash attention, forward, for Hopper
// (sm_90a).
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas
// (grid (B*Hq, Sq/128); each program streams the K/V blocks one Q tile
// can see with the online-softmax recurrence, skipping fully masked K
// blocks; q head h reads kv head h // group through the BlockSpec).  It
// computes the same function: scores s = (q.k) / sqrt(D) in fp32, masked
// by ``causal`` (key <= query) and ``window`` (key > query - window), a
// running max m and sum l in fp32, the probabilities cast to V's type
// before the P V product, fp32 accumulation, and O / max(l, 1e-30) cast
// to Q's type.  It differs in one way: it masks a ragged sequence itself
// (keys >= Sk contribute nothing, query rows >= Sq are not written), so
// any Sq and Sk are right; the TPU kernel reads only Sq // 128 query
// tiles and Sk // 128 key blocks.
//
// Two kernels:
//
// * bf16 (the model's compute type), tensor cores.  One block of 4 warps
//   owns a 64-row Q tile (16 rows per warp) of one (batch, q head) and
//   loops over the 64-key K/V tiles its rows can see.  Q, K and V tiles
//   sit in dynamic shared memory (row stride DP + 8 values, so the
//   fragment loads are conflict-free; 99 KB at DP = 256).  S = Q K^T and
//   O += P V are mma.sync m16n8k16 bf16 products with fp32 accumulation;
//   the S accumulator is re-packed in registers as the A operand of P V,
//   and V's B fragments come from ldmatrix.trans.  The head dim D (a
//   multiple of 8, at most 256) is zero-padded to DP in shared memory.
//
// * fp32, CUDA cores.  One block of 8 warps owns 8 query rows, one per
//   warp; K/V tiles of 32 keys are staged in shared memory; lane j scores
//   key j of the tile, the warp shares the softmax with shuffles, and
//   each lane accumulates D / 32 columns of O in fp32 FMAs.  This is the
//   reference's float32 path (no TF32).
//
// What bounds it on this card: operations.  At Gemma-2B's serve shape
// (B 4, Hq 8, Hkv 1, S 2048, D 256, causal) the visible (query, key) pairs
// need 68.7 GFLOP of products, 69 us at 989 TFLOP/s bf16, against 75 MB
// of q/k/v/o, 22 us at 3.35 TB/s.  This first version is simple: no
// wgmma, no TMA, no cp.async pipeline, and the K/V tiles of one kv head
// are read again by each of its q heads (through L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Params {
  const void* q;  // (B, Hq, Sq, D)
  const void* k;  // (B, Hkv, Sk, D)
  const void* v;  // (B, Hkv, Sk, D)
  void* o;        // (B, Hq, Sq, D)
  int B, Hq, Hkv, Sq, Sk, D;
  int causal;
  int window;  // <= 0: no window
  float scale;  // 1 / sqrt(D)
};

// The first key block a Q tile [q0, q0 + rows) can see, and one past the
// last, for key blocks of ``bn`` keys.
__device__ __forceinline__ void key_range(const Params& p, int q0, int rows,
                                          int bn, int* kb_begin,
                                          int* kb_end) {
  int end = (p.Sk + bn - 1) / bn;
  if (p.causal) end = min(end, (q0 + rows - 1) / bn + 1);
  int begin = 0;
  if (p.window > 0) begin = max(q0 - p.window + 1, 0) / bn;
  *kb_begin = begin;
  *kb_end = end;
}

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  bool ok = j < p.Sk;
  if (p.causal) ok = ok && j <= i;
  if (p.window > 0) ok = ok && j > i - p.window;
  return ok;
}

// ------------------------------------------------------------------ bf16

constexpr int kBM = 64;  // query rows per block (16 per warp)
constexpr int kBN = 64;  // keys per K/V tile
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Copy ``rows`` rows of D values (D a multiple of 8) into a (kBM or kBN,
// DP + 8) shared tile, 16 bytes a thread, zero-filling the rest.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* g, int rows,
                                          int D) {
  constexpr int kLd = DP + 8;
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && col < D)
      val = *reinterpret_cast<const uint4*>(g + static_cast<int64_t>(r) * D +
                                            col);
    *reinterpret_cast<uint4*>(s + r * kLd + col) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const Params p) {
  constexpr int kLd = DP + 8;
  constexpr int kNT = DP / 8;  // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBM * kLd;
  __nv_bfloat16* Vs = Ks + kBN * kLd;

  // the tiles with the most visible keys first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);
  const int q0 = qb * kBM;
  const int D = p.D;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           (static_cast<int64_t>(bh) * p.Sq + q0) * D;
  const int64_t kv_off = static_cast<int64_t>(b * p.Hkv + kvh) * p.Sk * D;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + kv_off;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) +
                     (static_cast<int64_t>(bh) * p.Sq + q0) * D;

  load_tile<DP>(Qs, q, min(kBM, p.Sq - q0), D);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int rw = warp * 16 + g;  // this thread's rows: rw and rw + 8
  const int i0 = q0 + rw, i1 = i0 + 8;
  // log2 domain: exp(x) = exp2(x * log2(e))
  const float sl2 = p.scale * 1.4426950408889634f;

  float acc[kNT][4];
#pragma unroll
  for (int t = 0; t < kNT; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int kb_begin, kb_end;
  key_range(p, q0, kBM, kBN, &kb_begin, &kb_end);
  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * kBN;
    __syncthreads();  // the previous tiles are consumed (and Q is stored)
    load_tile<DP>(Ks, k + static_cast<int64_t>(k0) * D, min(kBN, p.Sk - k0),
                  D);
    load_tile<DP>(Vs, v + static_cast<int64_t>(k0) * D, min(kBN, p.Sk - k0),
                  D);
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x 64 keys, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const __nv_bfloat16* qa = Qs + rw * kLd + kk + tig * 2;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * kLd);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 8);
      const uint32_t a3 =
          *reinterpret_cast<const uint32_t*>(qa + 8 * kLd + 8);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const __nv_bfloat16* kp = Ks + (t * 8 + g) * kLd + kk + tig * 2;
        mma_bf16(s[t], a0, a1, a2, a3,
                 *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // mask, scale into the log2 domain, and the running row max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + t * 8 + tig * 2 + (e & 1);
        const int i = e < 2 ? i0 : i1;
        s[t][e] = visible(p, i, j) ? s[t][e] * sl2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
      mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // a row with no visible key yet keeps m = -inf: exponentiate against
    // 0, so exp2(-inf) = 0 and nothing is NaN
    const float r0 = mx0 == -INFINITY ? 0.f : mx0;
    const float r1 = mx1 == -INFINITY ? 0.f : mx1;
    const float alpha0 = exp2f(m0 - r0), alpha1 = exp2f(m1 - r1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      acc[t][0] *= alpha0;
      acc[t][1] *= alpha0;
      acc[t][2] *= alpha1;
      acc[t][3] *= alpha1;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s[t][0] = exp2f(s[t][0] - r0);
      s[t][1] = exp2f(s[t][1] - r0);
      s[t][2] = exp2f(s[t][2] - r1);
      s[t][3] = exp2f(s[t][3] - r1);
      l0 += s[t][0] + s[t][1];  // this thread's share; summed at the end
      l1 += s[t][2] + s[t][3];
    }

    // O += P V: P (bf16) re-packed from the S accumulator as the A
    // operand, 16 keys per product
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const uint32_t pa0 = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      const uint32_t pa1 = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      const uint32_t pa2 = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      const uint32_t pa3 = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
      const int mi = lane >> 3;
      const __nv_bfloat16* vrow =
          Vs + (kt * 16 + (mi & 1) * 8 + (lane & 7)) * kLd + (mi >> 1) * 8;
#pragma unroll
      for (int t = 0; t < kNT; t += 2) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, vrow + t * 8);
        mma_bf16(acc[t], pa0, pa1, pa2, pa3, bfr[0], bfr[1]);
        mma_bf16(acc[t + 1], pa0, pa1, pa2, pa3, bfr[2], bfr[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
    const int col = t * 8 + tig * 2;
    if (col >= D) continue;
    if (i0 < p.Sq)
      *reinterpret_cast<uint32_t*>(o + static_cast<int64_t>(rw) * D + col) =
          pack_bf16(acc[t][0] * inv0, acc[t][1] * inv0);
    if (i1 < p.Sq)
      *reinterpret_cast<uint32_t*>(o + static_cast<int64_t>(rw + 8) * D +
                                   col) =
          pack_bf16(acc[t][2] * inv1, acc[t][3] * inv1);
  }
}

// ------------------------------------------------------------------ fp32

constexpr int kRowsF = 8;   // query rows per block, one per warp
constexpr int kKeysF = 32;  // keys per K/V tile, one per lane

template <int NPL>  // columns of O per lane: D <= 32 * NPL
__global__ void __launch_bounds__(32 * kRowsF)
    flash_fwd_f32(const Params p) {
  constexpr int kLd = 32 * NPL + 1;  // odd: lane j's key row is its own bank
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kKeysF * kLd;
  float* Qs = Vs + kKeysF * kLd;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);
  const int q0 = qb * kRowsF;
  const int D = p.D;
  const float* q =
      static_cast<const float*>(p.q) + (static_cast<int64_t>(bh) * p.Sq) * D;
  const int64_t kv_off = static_cast<int64_t>(b * p.Hkv + kvh) * p.Sk * D;
  const float* k = static_cast<const float*>(p.k) + kv_off;
  const float* v = static_cast<const float*>(p.v) + kv_off;
  float* o = static_cast<float*>(p.o) + (static_cast<int64_t>(bh) * p.Sq) * D;

  for (int c = threadIdx.x; c < kRowsF * kLd; c += blockDim.x) {
    const int r = c / kLd, col = c % kLd;
    Qs[c] = (q0 + r < p.Sq && col < D)
                ? q[static_cast<int64_t>(q0 + r) * D + col]
                : 0.f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = q0 + warp;
  float acc[NPL];
#pragma unroll
  for (int t = 0; t < NPL; ++t) acc[t] = 0.f;
  float m = -INFINITY, l = 0.f;

  int kb_begin, kb_end;
  key_range(p, q0, kRowsF, kKeysF, &kb_begin, &kb_end);
  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * kKeysF;
    __syncthreads();
    for (int c = threadIdx.x; c < kKeysF * D; c += blockDim.x) {
      const int r = c / D, col = c % D;
      const bool in = k0 + r < p.Sk;
      const int64_t at = static_cast<int64_t>(k0 + r) * D + col;
      Ks[r * kLd + col] = in ? k[at] : 0.f;
      Vs[r * kLd + col] = in ? v[at] : 0.f;
    }
    __syncthreads();

    const int j = k0 + lane;
    float s = 0.f;
    for (int d = 0; d < D; ++d)
      s = fmaf(Qs[warp * kLd + d], Ks[lane * kLd + d], s);
    s = visible(p, i, j) ? s * p.scale : -INFINITY;
    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    mx = fmaxf(m, mx);
    const float ref = mx == -INFINITY ? 0.f : mx;
    const float alpha = expf(m - ref);
    const float pj = expf(s - ref);
    float ps = pj;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    l = l * alpha + ps;
    m = mx;
#pragma unroll
    for (int t = 0; t < NPL; ++t) acc[t] *= alpha;
    for (int jj = 0; jj < kKeysF; ++jj) {
      const float pjj = __shfl_sync(0xffffffffu, pj, jj);
#pragma unroll
      for (int t = 0; t < NPL; ++t)
        acc[t] = fmaf(pjj, Vs[jj * kLd + lane + 32 * t], acc[t]);
    }
  }
  if (i >= p.Sq) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int t = 0; t < NPL; ++t) {
    const int col = lane + 32 * t;
    if (col < D) o[static_cast<int64_t>(i) * D + col] = acc[t] * inv;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(const Params& p, cudaStream_t s) {
  const dim3 grid((p.Sq + kBM - 1) / kBM, p.B * p.Hq);
  const size_t smem = sizeof(__nv_bfloat16) * (kBM + 2 * kBN) * (DP + 8);
  return launch(flash_fwd_bf16<DP>, grid, kThreads, smem, p, s);
}

template <int NPL>
cudaError_t launch_f32(const Params& p, cudaStream_t s) {
  const dim3 grid((p.Sq + kRowsF - 1) / kRowsF, p.B * p.Hq);
  const size_t smem = sizeof(float) * (2 * kKeysF + kRowsF) * (32 * NPL + 1);
  return launch(flash_fwd_f32<NPL>, grid, 32 * kRowsF, smem, p, s);
}

}  // namespace

// Plain C entry point (bound with ctypes): enqueues one launch on
// ``stream`` of ``device`` and returns the CUDA error code (0 = accepted).
// ``is_bf16`` selects the kernel; the wrapper has checked the shapes
// (Hq % Hkv == 0, 1 <= D <= 256, D % 8 == 0 for bf16), contiguity and the
// 16-byte alignment of the bf16 operands.
extern "C" int flash_attention_launch(int is_bf16, int device, const void* q,
                                      const void* k, const void* v, void* o,
                                      int B, int Hq, int Hkv, int Sq, int Sk,
                                      int D, int causal, int window,
                                      float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p{q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D <= 32) err = launch_bf16<32>(p, s);
    else if (D <= 64) err = launch_bf16<64>(p, s);
    else if (D <= 128) err = launch_bf16<128>(p, s);
    else err = launch_bf16<256>(p, s);
  } else {
    if (D <= 32) err = launch_f32<1>(p, s);
    else if (D <= 64) err = launch_f32<2>(p, s);
    else if (D <= 128) err = launch_f32<4>(p, s);
    else err = launch_f32<8>(p, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
