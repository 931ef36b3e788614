// H-fwd-wg: the channels-first SAME 3x3x3 convolution (stride 1) on bf16
// activations, built on Hopper's own instructions (sm_90a): TMA
// (cp.async.bulk.tensor) with mbarrier rings for the loads, wgmma.mma_async
// for the products, a TMA store for the output.  Replaces, for bf16, the TPU
// kernels K2 (_plane_kernel, synthsr_tpu/ops/conv_pallas.py:270), K3
// (conv3d_cf_grouped :920), K4 (_flat_kernel :1297) and K5 (_kernel :127),
// which multiply bf16 operands into float32 sums (conv_pallas.py:471-480), as
// wgmma does here.  It takes every bf16 call that passes
// ops/conv_cf.fwd_wg_ok (no accum, C_out % 8 == 0); the wrapper hands it
// sources with W % 8 == 0 and 16-byte aligned (ops/conv_cf.wg_sources), as
// TMA's strides and base addresses need.  H-fwd-mma (conv3d_fwd_mma.cu)
// keeps the rest.  The launcher runs on the stream it is given, allocates
// nothing and returns 0 once the kernel is launched (else a CUDA error, or
// WG_ERR_* below).
//
// Bound: 2*27*C_in FLOPs per output value against 2 bytes per input value,
// so operations bound at every U-Net width (989 TFLOP/s dense bf16 on an
// H100 SXM, reached only through wgmma).  At N = C_out = 24 a m64n24k16
// reads 2 KB of A and 0.75 KB of B from shared memory per 24.6 K MACs, so
// shared memory (128 B/clk/SM) caps it near half the tensor rate.
//
// Design: implicit GEMM with M = voxels, N = output channels, K = 27 taps x
// input channels.  Persistent blocks, one per SM, walk the tiles: a tile is
// a TX x TY (W x H) column of NZ output planes and N output channels (one N
// tile of C_out); the loads of a block's next tile run while its consumers
// finish the last one.  A tile walks K as
// (8-channel group, input plane) stages: 8 channels of the NZ + 2 input
// planes z0-1 .. z0+NZ, each staged once and used by up to three output
// planes (its taps dz = 0, 1, 2).  Three warpgroups:
//
// - warp 0 (one lane) is the producer: per stage one 4-D TMA box of the
//   channels-first source (x0-8 .. x0+TX+7, y0-1 .. y0+TY, one plane, 8
//   channels; a box's innermost start must be 16-byte aligned, so the x
//   halo is read from x0-8, and raw_row pads the box so that the transposes
//   are free of bank conflicts; TMA's out-of-bounds zero fill is SAME
//   padding and the channel padding of each source, at ragged edges too),
//   and per (group, dz) the weight slice by bulk copies, into rings of RS
//   and WS slots with full / empty mbarriers.  Two sources ([skip, up]) are
//   two tensor maps: the concatenation never exists.
// - warps 1-3 transpose each stage in shared memory from channels-first rows
//   (8 voxels of one channel, 16 bytes) into channels-last rows (8 channels
//   of one voxel): ldmatrix.trans + stmatrix, 8 x 8 blocks, into a ring of
//   CLS slots, then fence.proxy.async so that wgmma sees the writes.  In
//   channels-last rows every tap shift (dy, dx) is a whole 16-byte row, so
//   A is the canonical K-major no-swizzle layout (core matrix = 8 voxels x 8
//   channels, 128 contiguous bytes) for every tap, one descriptor each.
// - warpgroups 1-2 are the consumers, MTW M tiles of 8 x 8 voxels each per
//   output plane (SBO = one staged row): per stage, for each output plane
//   it feeds and each of 5 k16 steps (taps paired (0,1) (2,3) (4,5) (6,7)
//   (8, zero weights) within the plane: the second K half of an A
//   descriptor is the second tap, LBO = the two taps' distance), one
//   wgmma.m64nNk16 per M tile, B (weights, K-major no-swizzle, packed once
//   per weight set by ops/conv_cf._wg_weights) from the weight ring.  One
//   commit group per stage, at most one in flight while the next stage is
//   awaited; a stage's slots are released when wait_group(1) returns.
//
// Epilogue from the accumulator registers: bias, activation (ELU as
// exp(x) - 1 by __expf, ReLU, LeakyReLU(0.2)), the post affine; then either
// the folded 1x1x1 head (summed over the quad by shuffles) stored as (1, D,
// H, W) float32, or the bf16 tile staged channels-first in shared memory
// and written by one TMA store, which clips the ragged edges.  The sums are
// in a fixed order: two calls are bit-equal.

#include <cuda.h>  // CUtensorMap and the encode function's types; no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { ACT_NONE = 0, ACT_ELU = 1, ACT_RELU = 2, ACT_LEAKY = 3 };
// launcher errors past the CUDA error codes (conv3d_error_string names them)
enum { WG_ERR_ENCODE = 20000, WG_ERR_ENTRY = 20001, WG_ERR_ARGS = 20002 };

constexpr int WG_THREADS = 384;  // warpgroup 0: loads and transposes; 1-2: wgmma
constexpr int RS = 4;            // raw (channels-first) TMA stages
constexpr int CLS = 5;           // channels-last stages
constexpr int WS = 4;            // weight slices
constexpr int PAIRS = 5;         // k16 steps per (8-channel group, input plane)
constexpr int TRANSPOSERS = 3;   // warps 1-3
constexpr int CONSUMER_WARPS = 8;
constexpr int MAX_SMEM = 232448;

struct WgArgs {
  const unsigned char* wg;  // (groups, 3 dz, PAIRS, j_total, 2, 8, 8) bf16 + a tail
  int groups0, groups;      // 8-channel groups of source 0, of both
  int j_total;              // n8 blocks of one k16 step in wg (C_out / 8)
  int d, h, w;
  int tiles_x, tiles_y;
  int n_tiles;              // N tiles of C_out
  int cout;
  unsigned out_off;         // byte offset of the output tile's staging in shared memory
  unsigned bar_off;         // byte offset of the mbarriers
  const float* bias;
  const float* post;
  const float* head;  // (C_out + 1) float32: weights, then the bias; or null
  float* out_head;    // (1, D, H, W) float32 output with head
  int act;
};

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// waits for the phase of parity ``parity`` to complete; a wait that outlasts
// 2^28 polls is a broken ring, and traps instead of hanging the card.  The
// threads of a warp leave the loop apart: a warp that then runs an .aligned
// instruction reconverges first (__syncwarp)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 28)) __trap();
  }
}

// one 4-D TMA box (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one 4-D TMA box from shared memory to the tensor (a bulk group's member)
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_WARPS * 32) : "memory");
}

// four 8 x 8 b16 blocks: rows at src (lanes 8i..8i+7 give block i's rows)
// read transposed, written as rows at dst
__device__ __forceinline__ void transpose_x4(uint32_t src, uint32_t dst) {
  uint32_t r0, r1, r2, r3;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(src)
               : "memory");
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(dst),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, LBO (the K
// direction's core-matrix step) and SBO (the M / N direction's), in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int K>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(K) : "memory");
}

// keeps the compiler from moving accesses of the accumulators across wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, float32, N/2 registers a thread) += A (64 x 16) B (16 x N), both
// bf16 from shared memory through descriptors, K-major
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<24> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
        "}, %12, %13, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<72> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35"
        "}, %36, %37, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<144> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71"
        "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(1));
  }
};

// ---- the kernel ------------------------------------------------------------

__device__ __forceinline__ float activate(float v, int act) {
  // ELU by ex2.approx: ~2^-21 relative, under the bf16 output's 2^-9
  if (act == ACT_ELU) return v > 0.f ? v : __expf(v) - 1.f;
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_LEAKY) return v >= 0.f ? v : 0.2f * v;
  return v;
}

// one output channel's epilogue, its parameters read once: bias, activation,
// then the post affine (channel -1, past C_out: zeros)
struct Channel {
  float bias, scale, shift;
  __device__ __forceinline__ float apply(float v, int act) const {
    return activate(v + bias, act) * scale + shift;
  }
};

__device__ __forceinline__ Channel channel(const WgArgs& a, int co) {
  if (co < 0) return Channel{0.f, 0.f, 0.f};
  return Channel{a.bias ? a.bias[co] : 0.f, a.post ? a.post[co] : 1.f,
                 a.post ? a.post[a.cout + co] : 0.f};
}

// voxels of a raw (TMA) row: x0-8 .. x0+TX+7, and 8 more where that many is
// an even number of 16-byte groups.  With TY + 3 rows (TY is a multiple of
// 8) a channel's rows then span an odd number of 16-byte groups, so the 8
// channel rows that one ldmatrix.trans reads fall on 8 different bank groups
__host__ __device__ constexpr int raw_row(int tx) {
  return tx + 16 + ((tx + 16) / 8 % 2 == 0 ? 8 : 0);
}

// a tile's width: 32 voxels, 16 where a warpgroup has one M tile (2 M tiles
// of 8 x 8 voxels per tile); its height makes 2·MTW M tiles
__host__ __device__ constexpr int tile_x(int mtw) { return mtw >= 2 ? 32 : 16; }

// mbarriers: raw full / empty, channels-last full / empty, weights full / empty
enum { RAW_FULL = 0, RAW_EMPTY = RS, CL_FULL = 2 * RS, CL_EMPTY = 2 * RS + CLS,
       W_FULL = 2 * RS + 2 * CLS, W_EMPTY = 2 * RS + 2 * CLS + WS, N_BARS = 2 * (RS + CLS + WS) };

template <int N, int MTW, int NZ>
__global__ void __launch_bounds__(WG_THREADS, 1)
    conv3d_fwd_wg_kernel(const __grid_constant__ CUtensorMap src0,
                         const __grid_constant__ CUtensorMap src1,
                         const __grid_constant__ CUtensorMap dst, const WgArgs a) {
  constexpr int R = N / 2;                // accumulator registers of one M tile
  constexpr int WSLICE = PAIRS * N * 32;  // bytes of one (group, dz) weight slice
  constexpr int STEPS = NZ + 2;           // input planes per group
  extern __shared__ __align__(1024) unsigned char smem[];

  constexpr int TX = tile_x(MTW), TY = 128 * MTW / TX;
  constexpr int rowc = TX + 16;       // voxels of a channels-last row: x0-8 .. x0+TX+7
  constexpr int rowx = raw_row(TX);   // voxels of a raw row
  constexpr uint32_t stage = 16u * (TY + 3) * rowx;
  constexpr uint32_t cstage = 16u * (TY + 2) * rowc;
  const uint32_t raw0 = smem_u32(smem);
  const uint32_t cl0 = raw0 + RS * stage;  // the rings, then the output staging
  const uint32_t w0 = cl0 + CLS * cstage;
  const uint32_t bars = raw0 + a.bar_off;
  auto bar = [&](int kind, int i) { return bars + 8u * (kind + i); };

  // the block's tiles: blockIdx.x, + gridDim.x, ... of (x, y, z, N) tiles, x fastest
  const int tiles_z = (a.d + NZ - 1) / NZ;
  const int n_tiles = a.tiles_x * a.tiles_y * tiles_z * a.n_tiles;
  auto origin = [&](int t, int& x0, int& y0, int& z0, int& nt) {
    x0 = (t % a.tiles_x) * TX;
    t /= a.tiles_x;
    y0 = (t % a.tiles_y) * TY;
    t /= a.tiles_y;
    z0 = (t % tiles_z) * NZ;
    nt = t / tiles_z;
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < RS; ++i) {
      mbar_init(bar(RAW_FULL, i), 1);
      mbar_init(bar(RAW_EMPTY, i), TRANSPOSERS);
    }
    for (int i = 0; i < CLS; ++i) {
      mbar_init(bar(CL_FULL, i), TRANSPOSERS);
      mbar_init(bar(CL_EMPTY, i), CONSUMER_WARPS);
    }
    for (int i = 0; i < WS; ++i) {
      mbar_init(bar(W_FULL, i), 1);
      mbar_init(bar(W_EMPTY, i), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {  // the producer: stages s and weight slices k run on over the tiles
    if (lane == 0) {
      int s = 0, k = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int x0, y0, z0, nt;
        origin(t, x0, y0, z0, nt);
        for (int c = 0; c < a.groups; ++c) {
          const bool first = c < a.groups0;
          const CUtensorMap* map = first ? &src0 : &src1;
          const int ch = 8 * (first ? c : c - a.groups0);
          for (int ip = 0; ip < STEPS; ++ip, ++s) {
            const int rs = s % RS;
            if (s >= RS) mbar_wait(bar(RAW_EMPTY, rs), ((s / RS) - 1) & 1);
            mbar_expect_tx(bar(RAW_FULL, rs), stage);
            tma_load_4d(raw0 + rs * stage, map, x0 - 8, y0 - 1, z0 - 1 + ip, ch, bar(RAW_FULL, rs));
            if (ip < 3) {
              const int ws = k % WS;
              if (k >= WS) mbar_wait(bar(W_EMPTY, ws), ((k / WS) - 1) & 1);
              mbar_expect_tx(bar(W_FULL, ws), WSLICE);
              const unsigned char* src =
                  a.wg + ((size_t)(3 * c + ip) * PAIRS * a.j_total + (size_t)nt * (N / 8)) * 256;
              if (a.j_total == N / 8) {  // one N tile: the slice's k16 steps are contiguous
                bulk_load(w0 + ws * WSLICE, src, WSLICE, bar(W_FULL, ws));
              } else {
                for (int p = 0; p < PAIRS; ++p)
                  bulk_load(w0 + ws * WSLICE + p * N * 32, src + (size_t)p * a.j_total * 256,
                            N * 32, bar(W_FULL, ws));
              }
              ++k;
            }
          }
        }
      }
    }
    return;
  }

  if (warp < 4) {  // the transposers
    const int xg = rowc / 8;           // 8-voxel groups of a row
    const int nblk = (TY + 2) * xg;  // 8 x 8 blocks of a stage
    const int rr = lane & 7, bi = lane >> 3;
    const int total = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
                      a.groups * STEPS;
    for (int s = 0; s < total; ++s) {
      const int rs = s % RS, cs = s % CLS;
      mbar_wait(bar(RAW_FULL, rs), (s / RS) & 1);
      if (s >= CLS) mbar_wait(bar(CL_EMPTY, cs), ((s / CLS) - 1) & 1);
      __syncwarp();
      const uint32_t src = raw0 + rs * stage, dsts = cl0 + cs * cstage;
      for (int q = 4 * (warp - 1); q < nblk; q += 4 * TRANSPOSERS) {
        const int b = min(q + bi, nblk - 1);
        const int yy = b / xg, xx = 8 * (b % xg);
        // raw: [channel rr][row yy][x], channels-last: [row yy][x][8 channels]
        transpose_x4(src + 2u * ((rr * (TY + 3) + yy) * rowx + xx),
                     dsts + 16u * (yy * rowc + xx + rr));
      }
      fence_async_smem();
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(bar(RAW_EMPTY, rs));
        mbar_arrive(bar(CL_FULL, cs));
      }
    }
    return;
  }

  // the consumers: warpgroup cw owns M tiles cw*MTW .. cw*MTW + MTW-1 of each output plane
  const int cw = (warp - 4) >> 2, wi = warp & 3;
  constexpr int tcols = TX / 8;
  constexpr uint32_t sbo = 16u * rowc;
  uint32_t a_off[MTW];
#pragma unroll
  for (int m = 0; m < MTW; ++m) {
    const int mt = cw * MTW + m;
    a_off[m] = 16u * ((mt / tcols) * 8 * rowc + (mt % tcols) * 8);
  }
  const int g = lane >> 2, tq = lane & 3;
  float acc[NZ][MTW][R];
  int s = 0, k0 = 0;  // the tile's first stage and first weight slice
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
#pragma unroll
    for (int zo = 0; zo < NZ; ++zo)
#pragma unroll
      for (int m = 0; m < MTW; ++m) {
#pragma unroll
        for (int i = 0; i < R; ++i) acc[zo][m][i] = 0.f;
        fence_regs<R>(acc[zo][m]);
      }
#pragma unroll 1
    for (int c = 0; c < a.groups; ++c) {
#pragma unroll
      for (int ip = 0; ip < STEPS; ++ip, ++s) {
        const int cs = s % CLS;
        mbar_wait(bar(CL_FULL, cs), (s / CLS) & 1);
        if (ip < 3) {
          const int k = k0 + 3 * c + ip;
          mbar_wait(bar(W_FULL, k % WS), (k / WS) & 1);
        }
        __syncwarp();
        const uint32_t cl = cl0 + cs * cstage;
        wg_fence();
#pragma unroll
        for (int zo = 0; zo < NZ; ++zo) {
          const int dz = ip - zo;  // the tap plane this input plane is for output plane zo
          if (dz < 0 || dz > 2) continue;
          const uint32_t wb = w0 + ((k0 + 3 * c + dz) % WS) * WSLICE;
#pragma unroll
          for (int p = 0; p < PAIRS; ++p) {
            // taps 3*dy + dx; t1 = 9 has zero weights.  Output voxel (y, x) of
            // the tile reads staged row y + dy, column x + dx + 7 (column 0 is x0-8)
            const int t0 = 2 * p, t1 = 2 * p + 1;
            const uint32_t o0 = 16u * ((t0 / 3) * rowc + t0 % 3 + 7);
            const uint32_t lbo = p < 4 ? 16u * ((t1 / 3) * rowc + t1 % 3 + 7) - o0 : 16u;
            const uint64_t bd = gmma_desc(wb + p * N * 32, 128, 256);
#pragma unroll
            for (int m = 0; m < MTW; ++m)
              Wgmma<N>::mma(acc[zo][m], gmma_desc(cl + a_off[m] + o0, lbo, sbo), bd);
          }
        }
        wg_commit();
        wg_wait<1>();
        // the stage before this one is complete: release its channels-last
        // slot and the weight slice it used last (slice (c, dz) is last used
        // by input plane dz + NZ - 1); a tile's last stage is released at its end
        if (lane == 0 && (c > 0 || ip > 0)) {
          mbar_arrive(bar(CL_EMPTY, (s - 1) % CLS));
          const int dzl = ip > 0 ? ip - NZ : 2;
          const int cp = ip > 0 ? c : c - 1;
          if (dzl >= 0 && dzl <= 2) mbar_arrive(bar(W_EMPTY, (k0 + 3 * cp + dzl) % WS));
        }
        __syncwarp();
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int zo = 0; zo < NZ; ++zo)
#pragma unroll
      for (int m = 0; m < MTW; ++m) fence_regs<R>(acc[zo][m]);
    k0 += 3 * a.groups;
    if (lane == 0) {
      mbar_arrive(bar(CL_EMPTY, (s - 1) % CLS));
      mbar_arrive(bar(W_EMPTY, (k0 - 1) % WS));
    }

    int x0, y0, z0, nt;  // found again here: fewer registers live across the K loop
    origin(t, x0, y0, z0, nt);
    // accumulator (zo, m, 4j + e): M row 16*wi + g + 8*(e >> 1) of tile m, i.e.
    // voxel row 2*wi + (e >> 1), column g of the 8 x 8 tile; channel 8j + 2tq + (e & 1)
    const int co0 = nt * N;
    if (a.head) {  // uniform over the grid; the launcher guarantees one N tile
      float v[NZ][MTW][2];
#pragma unroll
      for (int zo = 0; zo < NZ; ++zo)
#pragma unroll
        for (int m = 0; m < MTW; ++m) v[zo][m][0] = v[zo][m][1] = 0.f;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + 8 * j + 2 * tq + e;
          if (co >= a.cout) continue;
          const Channel ch = channel(a, co);
#pragma unroll
          for (int zo = 0; zo < NZ; ++zo)
#pragma unroll
            for (int m = 0; m < MTW; ++m)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                v[zo][m][hh] += ch.apply(acc[zo][m][4 * j + 2 * hh + e], a.act) * a.head[co];
        }
#pragma unroll
      for (int zo = 0; zo < NZ; ++zo)
#pragma unroll
        for (int m = 0; m < MTW; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float u = v[zo][m][hh];
            u += __shfl_xor_sync(0xffffffffu, u, 1);
            u += __shfl_xor_sync(0xffffffffu, u, 2);
            const int mt = cw * MTW + m;
            const int z = z0 + zo, y = y0 + (mt / tcols) * 8 + 2 * wi + hh;
            const int x = x0 + (mt % tcols) * 8 + g;
            if (tq == 0 && z < a.d && y < a.h && x < a.w)
              a.out_head[((long long)z * a.h + y) * a.w + x] = u + a.head[a.cout];
          }
      continue;
    }

    // the bf16 tile, staged channels-first (N, NZ, TY, TX) for one TMA store;
    // the store of the block's previous tile has read the staging first
    if (threadIdx.x == 4 * 32) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    consumers_sync();
    __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(smem + a.out_off);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * tq + e, co = co0 + n;
        const Channel ch = channel(a, co < a.cout ? co : -1);
#pragma unroll
        for (int zo = 0; zo < NZ; ++zo)
#pragma unroll
          for (int m = 0; m < MTW; ++m) {
            const int mt = cw * MTW + m;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int y = (mt / tcols) * 8 + 2 * wi + hh, x = (mt % tcols) * 8 + g;
              so[((n * NZ + zo) * TY + y) * TX + x] =
                  __float2bfloat16_rn(ch.apply(acc[zo][m][4 * j + 2 * hh + e], a.act));
            }
          }
      }
    fence_async_smem();
    consumers_sync();
    if (threadIdx.x == 4 * 32) {  // the storer
      tma_store_4d(&dst, raw0 + a.out_off, x0, y0, z0, co0);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (threadIdx.x == 4 * 32) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---- the launcher ----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a 4-D map (W, H, D, C) over a channels-first (C, D, H, W) bf16 tensor
int encode_cf(EncodeTiled fn, CUtensorMap* map, const void* base, int c, int d, int h, int w,
              int bx, int by, int bz, int bc) {
  const cuuint64_t dims[4] = {(cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)d, (cuuint64_t)c};
  const cuuint64_t strides[3] = {2ull * w, 2ull * w * h, 2ull * w * h * d};
  const cuuint32_t box[4] = {(cuuint32_t)bx, (cuuint32_t)by, (cuuint32_t)bz, (cuuint32_t)bc};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : WG_ERR_ENCODE;
}

struct Launch {
  CUtensorMap m0, m1, mo;
  WgArgs a;
  dim3 grid;
  size_t smem;
};

template <int N, int MTW, int NZ>
int launch_wg(const Launch& l, cudaStream_t stream) {
  static bool attr = false;  // the most shared memory any launch may ask for, set once
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(conv3d_fwd_wg_kernel<N, MTW, NZ>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              MAX_SMEM);
    if (err) return err;
    attr = true;
  }
  conv3d_fwd_wg_kernel<N, MTW, NZ><<<l.grid, WG_THREADS, l.smem, stream>>>(l.m0, l.m1, l.mo, l.a);
  return (int)cudaGetLastError();
}

// (N, M tiles per consumer warpgroup, output planes per block); ops/conv_cf.WG_CONFIGS agrees
#define WG_CONFIGS(X)                                                                       \
  X(8, 4, 2) X(16, 4, 2) X(24, 4, 2) X(32, 4, 1) X(48, 2, 2) X(64, 2, 1) X(72, 2, 1) X(96, 2, 1) \
      X(128, 1, 1) X(144, 1, 1) X(192, 1, 1)

int config(int n, int* mtw, int* nz) {
#define WG_CASE(N_, MTW_, NZ_) \
  if (n == N_) {               \
    *mtw = MTW_;               \
    *nz = NZ_;                 \
    return 1;                  \
  }
  WG_CONFIGS(WG_CASE)
#undef WG_CASE
  return 0;
}

}  // namespace

extern "C" {

// 16 * (M tiles per consumer warpgroup) + (output planes per block) of an N
// tile, 0 for an N the kernel has no instance for
int conv3d_fwd_wg_config(int n) {
  int mtw, nz;
  return config(n, &mtw, &nz) ? 16 * mtw + nz : 0;
}

// out = epilogue(conv(concat(src0, src1), wg)), bf16 (C_out, D, H, W), or
// float32 (1, D, H, W) with head.  n: the N tile (C_out channels per tile);
// tx, ty: the tile (W x H) of the N tile's instance (tile_x);
// blocks: the most persistent blocks to launch (one per SM).
int conv3d_fwd_wg_launch(const void* src0, int c0, const void* src1, int c1, int d, int h, int w,
                         const void* wg, int cout, int n, int tx, int ty, const float* bias,
                         const float* post, const float* head, int act, int blocks, void* out,
                         void* stream) {
  int mtw, nz;
  if (!config(n, &mtw, &nz) || tx != tile_x(mtw) || ty != 128 * mtw / tx || w % 8 || cout % 8 ||
      (head && cout > n) || blocks < 1)
    return WG_ERR_ARGS;
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return WG_ERR_ENTRY;
  Launch l;
  const int g0 = (c0 + 7) / 8;
  const int tiles_x = (w + tx - 1) / tx, tiles_y = (h + ty - 1) / ty, n_tiles = (cout + n - 1) / n;
  const size_t stage = 16ull * (ty + 3) * raw_row(tx);
  const size_t cstage = 16ull * (ty + 2) * (tx + 16);
  const size_t rings = RS * stage + CLS * cstage + WS * (size_t)PAIRS * n * 32;
  const size_t outb = head ? 0 : 2ull * n * nz * ty * tx;
  l.a = WgArgs{static_cast<const unsigned char*>(wg),
               g0,
               g0 + (c1 + 7) / 8,
               cout / 8,
               d,
               h,
               w,
               tiles_x,
               tiles_y,
               n_tiles,
               cout,
               (unsigned)rings,
               (unsigned)(rings + outb),
               bias,
               post,
               head,
               head ? static_cast<float*>(out) : nullptr,
               act};
  l.smem = rings + outb + 8 * N_BARS;
  if (l.smem > MAX_SMEM) return WG_ERR_ARGS;
  int err = encode_cf(fn, &l.m0, src0, c0, d, h, w, raw_row(tx), ty + 3, 1, 8);
  if (!err) err = encode_cf(fn, &l.m1, src1 ? src1 : src0, src1 ? c1 : c0, d, h, w, raw_row(tx),
                            ty + 3, 1, 8);
  if (!err && !head) err = encode_cf(fn, &l.mo, out, cout, d, h, w, tx, ty, nz, n);
  if (head) l.mo = l.m0;  // unused
  if (err) return err;
  const long long tiles = (long long)tiles_x * tiles_y * ((d + nz - 1) / nz) * n_tiles;
  l.grid = dim3((unsigned)(tiles < blocks ? tiles : blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WG_LAUNCH(N_, MTW_, NZ_) \
  if (n == N_) return launch_wg<N_, MTW_, NZ_>(l, s);
  WG_CONFIGS(WG_LAUNCH)
#undef WG_LAUNCH
  return WG_ERR_ARGS;
}

}  // extern "C"
