// Causal / sliding-window GQA flash attention, bf16 forward, for Hopper
// (sm_90a): TMA loads, wgmma products, warp-specialised.
//
// Replaces the reference's Pallas kernel
// src/repro/kernels/flash_attention/flash_attention.py:74
// (flash_attention_pallas) for bf16 at (q/k head dim D, value head dim
// Dv) in {(64, 64), (128, 128), (256, 256), (192, 192), (192, 128)}: every
// dense config the port serves (Gemma-2B 256; Granite, InternLM2, ChatGLM3,
// Mixtral, Jamba 128; InternVL2 64) and DeepSeek-V3's MLA (q/k 128 + 64
// rotary, v 128).  Other head dims (bf16) and fp32 stay on
// flash_attention.cu's mma.sync and CUDA-core kernels; the wrapper routes
// by dtype and D, never on failure.  It computes the same function as
// those kernels, with the same numerics: scores (q.k) / sqrt(D) scaled
// into the log2 domain in fp32, masked by ``causal`` (key <= query) and
// ``window`` (key > query - window); a running max and sum in fp32, a row
// with no visible key yet exponentiated against 0 (nothing is NaN); P cast
// to bf16 before the P V product; fp32 accumulation; O / max(l, 1e-30)
// cast to bf16; query rows >= Sq never written.
//
// What bounds it on this card: operations.  At Gemma-2B's serve shape
// (B 4, Hq 8, Hkv 1, S 2048, D 256, causal) the visible (query, key)
// pairs need 68.7 GFLOP of products, 69 us at 989 TFLOP/s, against 75 MB
// of q/k/v/o (22 us at 3.35 TB/s); at MLA's (B 4, Hq = Hkv = 128, S 2048,
// D 192, Dv 128) 687.5 GFLOP, 0.695 ms.  What the design does about it:
//
// * Products on wgmma.  S = Q K^T is m64n64k16 with both operands in
//   shared memory (K-major), D / 16 steps over D / 64 boxes; O += P V is
//   m64nDvk16 with P in registers as the A operand and the V tile in
//   shared memory (MN-major).  fp32 accumulators throughout; O holds
//   Dv / 2 registers a thread, so a narrower V costs neither products
//   nor registers.
// * Warp specialisation.  A block is three warpgroups: one producer,
//   which gives its registers away (setmaxnreg.dec to 24) and keeps TMA
//   loads in flight from one thread, and two consumers (setmaxnreg.inc to
//   240), each owning one 64-row Q tile.
// * Both consumers busy, every K/V tile in shared memory feeding 128
//   query rows.  At a GQA group of 2 or more the two consumers of a block
//   take two q heads of the same kv head at the same query tile, so their
//   visible key ranges are identical under any mask; for an odd group
//   (InternVL2: 14 q heads over 2 kv heads, group 7) the second consumer
//   of each kv head's last pair is idle.  At group 1 (MLA: one q head a
//   kv head) the block's one head fills both: consumer c takes the query
//   rows [128 t + 64 c, 128 t + 64 c + 64) of its 128-row tile t.  Their
//   key ranges differ at the edges (under causal masking the lower tile
//   sees one K tile fewer; under a window the upper one starts later), so
//   the producer loads the union and each consumer waits for and
//   releases every stage of it, computing on its own range only: the
//   empty barriers count the same arrivals whatever a consumer used.
//   The loop runs over the union, whose bounds do not depend on the
//   consumer, so the compiler forms the ring addresses and wgmma
//   descriptors on the uniform datapath, as with the GQA pairing.
//   When Sq has an odd number of 64-row tiles the upper consumer of the
//   last tile has no rows and is idle.  An idle consumer returns at once,
//   its Q tile is not loaded and the empty barriers do not count it.
// * Each consumer runs Q K^T, the softmax and P V of a tile in turn; the
//   two consumers of a block interleave on the tensor cores.  Issuing
//   tile j+1's Q K^T before tile j's softmax (a second score
//   accumulator) measured 5-35% slower at Gemma's, Mixtral's and Jamba's
//   shapes and no faster at MLA's on an H100 (PERF.md), and is not built.
// * The softmax masks only tiles that reach past a mask's edge, in a
//   block of its own (see the comment there).
// * TMA loads (cp.async.bulk.tensor) over 3-D tensor maps (D or Dv, S,
//   B*H), boxes of 64 head-dim values (128 bytes) by 64 rows with the
//   128-byte swizzle that wgmma reads.  Q is loaded once per block; K and
//   V tiles of 64 keys pass through a ring of as many stages (at most 4)
//   as the 227 KB of a block hold beside the two Q tiles: 2 at (256,
//   256), 3 at (192, 192), 4 at (192, 128) (Q 2 x 24 KB, K 4 x 24 KB, V
//   4 x 16 KB: 208 KB) and below; full/empty mbarriers.  A ragged S tail
//   is zero-filled by the hardware inside its own head (a 2-D map over
//   (B*H*S, D) would read the next head's rows); the kernel masks keys
//   >= Sk as before.
// * Heaviest query tiles first: the query tile is taken from the end of
//   the grid's y axis, all heads of the longest tiles scheduled before the
//   short ones.  Grid: (B * Hkv * pairs, Sq / 64) at group >= 2,
//   (B * Hq, Sq / 128) at group 1.
//
// The tensor maps are encoded on the host at every call (../../csrc/
// tma.cuh: cuTensorMapEncodeTiled, looked up without -lcuda) and passed
// as __grid_constant__ parameters.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma.cuh"

namespace {

using namespace tma;

constexpr int kRows = 64;             // query rows per consumer, keys per tile
constexpr int kBox = 64;              // head-dim values per TMA box (128 B)
constexpr int kBoxBytes = kRows * 128;  // one (64 rows, 64 values) box
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kMaxSmem = 232448;      // dynamic shared memory of a block
constexpr int kMaxStages = 4;

// Shared memory of one block, from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes): the consumers' Q tiles, the
// K ring, the V ring, then the mbarriers full[stages], empty[stages], q.
template <int D, int DV>
struct Smem {
  static constexpr int kBoxesQK = D / kBox;
  static constexpr int kBoxesV = DV / kBox;
  static constexpr int kTileQK = kBoxesQK * kBoxBytes;  // one Q or K tile
  static constexpr int kTileV = kBoxesV * kBoxBytes;    // one V tile
  static constexpr int kFit =
      (kMaxSmem - kConsumers * kTileQK - 1024 - 8 * (2 * kMaxStages + 1)) /
      (kTileQK + kTileV);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kQ = 0;
  static constexpr int kK = kConsumers * kTileQK;
  static constexpr int kV = kK + kStages * kTileQK;
  static constexpr int kBar = kV + kStages * kTileV;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + 1024;
  static_assert(D % kBox == 0 && DV % kBox == 0, "whole boxes");
  static_assert(kStages >= 2 && kBytes <= kMaxSmem, "a ring of 2 or more");
};

struct Params {
  __nv_bfloat16* o;  // (B, Hq, Sq, Dv)
  int Hq, Hkv, Sq, Sk;
  int group;  // Hq / Hkv
  int pairs;  // ceil(group / 2): blocks per kv head and query tile (group > 1)
  int causal;
  int window;        // <= 0: no window
  float scale_log2;  // log2(e) * scale, scale = 1 / sqrt(D)
};

// --------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (SWIZZLE_128B).  K-major tiles (Q, K): rows of 128 bytes, 8-row
// groups 1024 bytes apart (the stride offset), the leading offset unused.
// MN-major V: the 8-key groups 1024 bytes apart, the next 64 head-dim
// values one box (8 KB) further (the leading offset).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from touching accumulators across the asynchronous
// products: each register is "written" here, after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, fp32) (+)= A (64 x 16, smem, K-major) B (64 x 16, smem,
// K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, registers) B (16 x 64, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, registers) B (16 x 128, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 192, fp32) += A (64 x 16, registers) B (16 x 192, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_m64n192(float (&d)[96],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 256, fp32) += A (64 x 16, registers) B (16 x 256, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&o)[DV / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (DV == 64) {
    wgmma_rs_m64n64(o, a, b);
  } else if constexpr (DV == 128) {
    wgmma_rs_m64n128(o, a, b);
  } else if constexpr (DV == 192) {
    wgmma_rs_m64n192(o, a, b);
  } else {
    wgmma_rs_m64n256(o, a, b);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  bool ok = j < p.Sk;
  if (p.causal) ok = ok && j <= i;
  if (p.window > 0) ok = ok && j > i - p.window;
  return ok;
}

// x as lane 0 holds it.  The compiler forms the wgmma descriptors and
// ring addresses in uniform registers only from values it knows to be
// warp-uniform; from threadIdx / 128 it forms them per thread and moves
// each over (R2UR) before its wgmma.
__device__ __forceinline__ int warp_uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

// The K/V tiles [begin, end) that the 64 query rows from q0 see; empty
// (begin == end) where none is visible.
__device__ __forceinline__ void key_tiles(const Params& p, int q0,
                                          int& begin, int& end) {
  end = (p.Sk + kRows - 1) / kRows;
  if (p.causal) end = min(end, (q0 + kRows - 1) / kRows + 1);
  begin = p.window > 0 ? max(q0 - p.window + 1, 0) / kRows : 0;
  begin = min(begin, end);
}

// ------------------------------------------------------------ the kernel

// One consumer warpgroup: the 64 query rows [q0, q0 + 64) of head ``h``.
// The ring holds the block's K/V tiles [lo, hi); this consumer waits for
// and releases each of them, and computes on those in [begin, end) only
// (all of them at a GQA group of 2 or more).  Warp w holds rows 16 w + g
// and 16 w + g + 8 (g = lane / 4) of every accumulator, in wgmma's
// fragment order: element 4 j + e is row g + 8 (e / 2), column
// 8 j + 2 (lane % 4) + e % 2.
template <int D, int DV>
__device__ __forceinline__ void consume(const Params& p, uint32_t base,
                                        int c, int b, int h, int q0, int lo,
                                        int hi, int begin, int end) {
  using S = Smem<D, DV>;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int i0 = q0 + warp * 16 + g, i1 = i0 + 8;
  const uint32_t q_s = base + S::kQ + c * S::kTileQK;
  const uint32_t full = base + S::kBar, empty = full + 8 * S::kStages;
  const uint32_t q_bar = empty + 8 * S::kStages;

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_bar, 0);  // this consumer's Q tile
  for (int kb = lo, it = 0; kb < hi; ++kb, ++it) {
    const int s = it % S::kStages;
    mbar_wait(full + 8 * s, (it / S::kStages) & 1);
    if (kb >= begin && kb < end) {  // else a tile only the other one sees
      const uint32_t k_s = base + S::kK + s * S::kTileQK;
      const uint32_t v_s = base + S::kV + s * S::kTileV;

      // S = Q K^T over D / 16 steps of 16 head-dim values
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_m64n64(sc, desc_sw128(q_s + off, 16, 1024),
                        desc_sw128(k_s + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale into the log2 domain, mask (only tiles that reach past a
      // mask's edge), and the running row max.  The masking is a block of
      // its own: inline, the compiler hoists its 32 visibility tests above
      // the product to hide the wait and spills the predicates.
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= p.scale_log2;
      const int k0 = kb * kRows;
      const bool edge = (p.causal && k0 + kRows - 1 > q0) ||
                        k0 + kRows > p.Sk ||
                        (p.window > 0 && k0 <= q0 + kRows - 1 - p.window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible(p, e < 2 ? i0 : i1, k0 + j * 8 + tig * 2 + (e & 1)))
              sc[4 * j + e] = -INFINITY;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // a row with no visible key yet keeps m = -inf: exponentiate
      // against 0, so exp2(-inf) = 0 and nothing is NaN
      const float r0 = mx0 == -INFINITY ? 0.f : mx0;
      const float r1 = mx1 == -INFINITY ? 0.f : mx1;
      const float alpha0 = exp2f(m0 - r0), alpha1 = exp2f(m1 - r1);
      m0 = mx0;
      m1 = mx1;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int i = 0; i < DV / 2; i += 4) {
        o[i] *= alpha0;
        o[i + 1] *= alpha0;
        o[i + 2] *= alpha1;
        o[i + 3] *= alpha1;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[4 * j] = exp2f(sc[4 * j] - r0);
        sc[4 * j + 1] = exp2f(sc[4 * j + 1] - r0);
        sc[4 * j + 2] = exp2f(sc[4 * j + 2] - r1);
        sc[4 * j + 3] = exp2f(sc[4 * j + 3] - r1);
        l0 += sc[4 * j] + sc[4 * j + 1];  // this thread's share
        l1 += sc[4 * j + 2] + sc[4 * j + 3];
      }

      // O += P V: P (bf16) from the S accumulator as the A operand, 16
      // keys (two 8-key column groups of S) per product
      uint32_t pa[4][4];
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        pa[kt][0] = pack_bf16(sc[8 * kt], sc[8 * kt + 1]);
        pa[kt][1] = pack_bf16(sc[8 * kt + 2], sc[8 * kt + 3]);
        pa[kt][2] = pack_bf16(sc[8 * kt + 4], sc[8 * kt + 5]);
        pa[kt][3] = pack_bf16(sc[8 * kt + 6], sc[8 * kt + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 4; ++kt)
        wgmma_pv<DV>(o, pa[kt],
                     desc_sw128(v_s + kt * 16 * 128, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }

    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with s
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* out = p.o + (static_cast<int64_t>(b) * p.Hq + h) * p.Sq * DV;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int col = j * 8 + tig * 2;
    if (i0 < p.Sq)
      *reinterpret_cast<uint32_t*>(out + static_cast<int64_t>(i0) * DV + col) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (i1 < p.Sq)
      *reinterpret_cast<uint32_t*>(out + static_cast<int64_t>(i1) * DV + col) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const Params p) {
  using S = Smem<D, DV>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t full = base + S::kBar, empty = full + 8 * S::kStages;
  const uint32_t q_bar = empty + 8 * S::kStages;

  // blockIdx.y: the query tile, the longest (most visible keys) first.
  // Consumer 0 takes head h0 from query row q0a, consumer 1 head h1 from
  // row q0b; ``active`` consumers have rows.
  const int tile = gridDim.y - 1 - blockIdx.y;
  int b, kvh, h0, h1, q0a, q0b, active;
  if (p.group == 1) {
    // blockIdx.x: (batch, head); two 64-row tiles of one head
    b = blockIdx.x / p.Hq;
    kvh = h0 = h1 = blockIdx.x % p.Hq;
    q0a = tile * kConsumers * kRows;
    q0b = q0a + kRows;
    active = q0b < p.Sq ? 2 : 1;
  } else {
    // blockIdx.x: (batch, kv head, pair of q heads); one 64-row tile
    const int per_b = p.Hkv * p.pairs;
    b = blockIdx.x / per_b;
    kvh = (blockIdx.x % per_b) / p.pairs;
    const int pair = blockIdx.x % p.pairs;
    h0 = kvh * p.group + 2 * pair;
    h1 = h0 + 1;
    q0a = q0b = tile * kRows;
    active = 2 * pair + 1 < p.group ? 2 : 1;
  }
  // each active consumer's key tiles [ba, ea) and [bb, eb), and their
  // union [lo, hi) (an empty range widens nothing)
  int ba, ea, bb = 0, eb = 0;
  key_tiles(p, q0a, ba, ea);
  if (active == 2) key_tiles(p, q0b, bb, eb);
  int lo = 0, hi = 0;
  if (ba < ea && bb < eb) {
    lo = min(ba, bb);
    hi = max(ea, eb);
  } else if (ba < ea) {
    lo = ba;
    hi = ea;
  } else if (bb < eb) {
    lo = bb;
    hi = eb;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * active);  // one arrival per warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = warp_uniform(threadIdx.x / 128);
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, active * S::kTileQK);
      for (int c = 0; c < active; ++c)
        for (int bx = 0; bx < S::kBoxesQK; ++bx)
          load_3d(base + S::kQ + c * S::kTileQK + bx * kBoxBytes, &tm_q,
                  q_bar, bx * kBox, c ? q0b : q0a, b * p.Hq + (c ? h1 : h0));
      const int kv_head = b * p.Hkv + kvh;
      for (int kb = lo, it = 0; kb < hi; ++kb, ++it) {
        const int s = it % S::kStages;
        mbar_wait(empty + 8 * s, ((it / S::kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, S::kTileQK + S::kTileV);
        for (int bx = 0; bx < S::kBoxesQK; ++bx)
          load_3d(base + S::kK + s * S::kTileQK + bx * kBoxBytes, &tm_k,
                  full + 8 * s, bx * kBox, kb * kRows, kv_head);
        for (int bx = 0; bx < S::kBoxesV; ++bx)
          load_3d(base + S::kV + s * S::kTileV + bx * kBoxBytes, &tm_v,
                  full + 8 * s, bx * kBox, kb * kRows, kv_head);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    if (c < active)
      consume<D, DV>(p, base, c, b, c ? h1 : h0, c ? q0b : q0a, lo, hi,
                     c ? bb : ba, c ? eb : ea);
  }
}

// ---------------------------------------------------------------- host

// (W, S, BH) bf16, row-major (B, H, S, W): boxes of 64 head-dim values by
// 64 rows of one head, 128-byte swizzle, out-of-bounds rows read as zero.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int W, int S,
           int BH) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * 2,
                                 static_cast<cuuint64_t>(S) * W * 2};
  const cuuint32_t box[3] = {kBox, kRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return encode_result(r);
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int causal, int window,
           float scale, cudaStream_t stream) {
  EncodeTiled fn;
  int err = encoder(&fn);
  if (err != 0) return err;
  CUtensorMap tm_q, tm_k, tm_v;
  if ((err = encode(fn, &tm_q, q, D, Sq, B * Hq)) != 0) return err;
  if ((err = encode(fn, &tm_k, k, D, Sk, B * Hkv)) != 0) return err;
  if ((err = encode(fn, &tm_v, v, DV, Sk, B * Hkv)) != 0) return err;
  const int group = Hq / Hkv;
  const Params p{static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Sk, group,
                 (group + 1) / 2, causal, window,
                 scale * 1.4426950408889634f};
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<D, DV>::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int rows = group == 1 ? kConsumers * kRows : kRows;
  const dim3 grid(group == 1 ? B * Hq : B * Hkv * p.pairs,
                  (Sq + rows - 1) / rows);
  flash_fwd_wgmma<D, DV><<<grid, kThreads, Smem<D, DV>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes): enqueues one launch on
// ``stream`` of ``device`` and returns 0, a CUDA error code, or one of
// this library's codes (error_string names each).  The wrapper has
// checked the shapes (bf16, (D, Dv) compiled, Hq % Hkv == 0), the
// contiguity and the 16-byte alignment of q, k and v.
extern "C" int flash_attention_wgmma_launch(int device, const void* q,
                                            const void* k, const void* v,
                                            void* o, int B, int Hq, int Hkv,
                                            int Sq, int Sk, int D, int Dv,
                                            int causal, int window,
                                            float scale, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && Dv == 64)
    return launch<64, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                          scale, s);
  if (D == 128 && Dv == 128)
    return launch<128, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                            scale, s);
  if (D == 192 && Dv == 192)
    return launch<192, 192>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                            scale, s);
  if (D == 192 && Dv == 128)
    return launch<192, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                            scale, s);
  if (D == 256 && Dv == 256)
    return launch<256, 256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                            scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int code) { return error_name(code); }
