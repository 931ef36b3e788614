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
// wg_common.cuh's WG_ERR_*).
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

#include "wg_common.cuh"

namespace {

using namespace hopper;

enum { ACT_NONE = 0, ACT_ELU = 1, ACT_RELU = 2, ACT_LEAKY = 3 };

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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_WARPS * 32) : "memory");
}

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
