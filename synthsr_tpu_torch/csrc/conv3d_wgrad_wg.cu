// H-wgrad-wg: the weight gradient of the channels-first SAME 3x3x3
// convolution (stride 1) on bf16 operands, built on Hopper's own
// instructions (sm_90a): TMA (cp.async.bulk.tensor) with mbarrier rings for
// the loads, wgmma.mma_async for the products.  Replaces, for bf16, the TPU
// kernels K6 (_wgrad_kernel, synthsr_tpu/ops/conv_pallas.py:1090) and K7
// (_wgrad_flat_kernel, :1705), which multiply bf16 operands into float32
// sums (conv_pallas.py:1187-1191), as wgmma does here.
//
//   dw[tap, ci, co] = sum_vox x[ci, vox + tap] * g[co, vox]
//
// with zero padding at every face.  It takes every bf16 call that passes
// ops/conv_cf.wgrad_wg_ok (W >= 8); the wrapper hands it x and g with W % 8
// == 0 and 16-byte aligned (ops/conv_cf.wg_sources), as TMA's strides and
// base addresses need, and a call whose C_out is not a multiple of 8 but
// C_in is (the penalty's 32->1) as the weight gradient of (g, x), whose taps
// it then mirrors.  H-wgrad-mma (conv3d_wgrad_mma.cu) keeps volumes narrower than
// 8.  The launcher runs on the stream it is given, allocates nothing and
// returns 0 once the kernels are launched (else a CUDA error, or
// wg_common.cuh's WG_ERR_*).
//
// Bound: 2*27*ci*co FLOPs per voxel against 2*(ci + co) bytes, so operations
// bound at every U-Net width (989 TFLOP/s dense bf16 on an H100 SXM, reached
// only through wgmma).  With 27*ci*co outputs over up to millions of voxels
// (K), the work is split over K at 128^3 and over the outputs at 8^3.
//
// Design: 27 GEMMs over one K = the voxels of g, M = output channels (one
// tile of CT <= 64 a block), N = 24 = the three dx taps of one 8-channel
// group of x, one accumulator tile per (dz, dy): 9 x 12 float32 a thread (6
// x 12 in the stacked layout).
//
// - Items: a block walks a contiguous range of (column tile of TX x TY
//   voxels, plane) items, planes fastest, cut into runs at column ends.  A
//   run of n g planes z0 .. z0+n-1 stages the n + 2 x planes z0-1 .. z0+n
//   once each: x plane z0-1+i feeds the g planes of taps dz = 0, 1, 2.
//   TX follows W (32, 16 or 8 voxels, conv_cf.wgrad_wg_plan): a narrow
//   volume's items are not mostly masked.
// - Loads: warp 0 (one lane) issues per x plane one 4-D TMA box of the
//   channels-first x (x0-8 .. x0+TX+7, y0-1 .. y0+TY, one plane, the
//   block's 8 channels: a box's innermost start must be 16-byte aligned, so
//   the x halo is read from x0-8; TMA's zero fill is SAME padding and the
//   channel padding), and per g plane one box of g through a map ordered
//   (W, C, H, D), so that shared memory holds it as [row][channel][voxel]:
//   TXG voxels a channel row, an odd number of 16-byte groups, so the 8
//   rows of an ldmatrix fall on 8 bank groups.  Rings of RS raw x, CLS
//   channels-last x and GS g slots with full / empty mbarriers (deeper rings
//   ran slower on the card: tools/ab_wgrad_wg_variants.py).  A g slot has a
//   full barrier for each consumer warpgroup, so that each waits on every
//   phase of the barriers it reads: with one barrier, GS = 3 slots shared by
//   two warpgroups that take the planes in turns let a warpgroup wait on a
//   phase two ahead of the slot's, which a parity wait takes for complete
//   (the ring is then right only if TMA boxes land in the order they were
//   issued, which PTX does not promise).
// - Warps 1-3 transpose each x plane from channels-first rows into
//   channels-last rows (8 channels of one voxel, 16 bytes; ldmatrix.trans +
//   stmatrix), then fence.proxy.async so that wgmma sees the writes.
// - B = x shifted by the tap, from shared memory (K = voxels, N = 8 dx
//   channels x 3), MN-major (trans-b): a core matrix is 8 consecutive
//   voxel slots, 128 contiguous bytes; LBO = the step to the k16 step's
//   second 8 voxels (128 bytes, or one staged row where TX = 8); SBO = 16
//   bytes, one voxel, so the three N core matrices are the dx taps 0, 1, 2
//   and one wgmma.m64n24k16 covers them.  (dz, dy) pick the slot and row,
//   so a tap is a descriptor start address.
// - A = g from registers: per k16 step each consumer warp loads its 16
//   output channels x 16 voxels by one ldmatrix.x4 from the g box (no
//   transpose: channels-first rows are K-major when K is the voxels) and
//   feeds the 9 (dz, dy) wgmmas of the step with it.  Rows past CT give
//   rows of the sums that are never stored.
// - M at CT <= 32 (level 0's C_out 24 fills 37.5% of it): the stacked
//   layout.  The g box holds rows y0-1 .. y0+TY; one product's A is g rows r
//   (M rows 0-31) and r + 1 (32-63) against x at the dy 1 descriptor, which
//   gives taps dy 1 and dy 0; a second product's A is g rows r - 1 (tap dy
//   2).  Two products a dz, not three.  A shifted block misses one g row a
//   tile column, and that row meets zero padding (row 0 for dy 0; for dy 2
//   the row past the last, or a row past H).  Stacking three planes instead
//   needs 72 rows.  On the card it bought 13% at (48,24) @128^3 and nothing
//   at (24,24) @128^3, whose time the loads set (without the x loads 0.244
//   ms, without the g loads 0.250, of 0.30: tools/ab_wgrad_wg_variants.py).
// - Two consumer warpgroups take the g planes in turns (even and odd) with
//   accumulators of their own: per k16 step one commit group, at most one in
//   flight while the next step's A is loaded; after a plane's last step the
//   warpgroup waits for its products and releases the plane's slots at once
//   (held until its next plane, they would deadlock the ring where runs are
//   one plane long), while the other warpgroup keeps the tensor cores fed.
//   Each x plane's empty barrier counts 3 users x 4 warps; the transposers
//   arrive for the users a plane has not (the first and last planes of a
//   run).
// - End: warpgroup 1 hands its sums to warpgroup 0 through shared memory,
//   which adds them (0 + 1, a fixed order) and writes the block's partial
//   (n_split, 27, ci_pad, co_pad); conv3d_wgrad.cu's reduce sums the
//   partials over the splits in a fixed order (with one split and no
//   padding the block writes dw itself).  Two calls are bit-equal.
// Volume offsets are TMA coordinates; partial offsets 64-bit.

#include "mma_common.cuh"  // ldsm_x4
#include "wg_common.cuh"

extern "C" int conv3d_wgrad_reduce(const float* partial, int n_split, int ci, int co, int ci_pad,
                                   int co_pad, float* dw, void* stream);

namespace {

using namespace hopper;

constexpr int WW_THREADS = 384;  // warpgroup 0: loads and transposes; 1-2: wgmma
constexpr int RS = 3;            // raw (channels-first) x planes
constexpr int CLS = 6;           // channels-last x planes: more than 4 (a g plane holds 3)
constexpr int GS = 3;            // g planes: at least 3
// g planes between two uses of one (slot, warpgroup) full barrier
constexpr int G_CYCLE = GS % 2 ? 2 * GS : GS;
constexpr int TRANSPOSERS = 3;   // warps 1-3
constexpr int CONSUMER_WARPS = 8;
constexpr int MAX_CT = 64;       // output channels a block: the wgmma M
constexpr int ACC = 12;          // float32 a thread of one m64n24 tile
constexpr int MAX_SMEM = 232448;

struct WwArgs {
  int d;
  int tiles_x, tiles_y;
  int n_split;
  int ct;              // output channels of a block's tile (rows of the g box)
  int ci_pad, co_pad;
  float* partial;      // (n_split, 27, ci_pad, co_pad)
  unsigned g_off;      // byte offsets in shared memory: the g ring, the mbarriers
  unsigned bar_off;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_WARPS * 32) : "memory");
}

// D (64 x 24, float32) += A (64 x 16, bf16, registers: the mma.m16n8k16 A
// fragment of each warp's 16 rows) B (16 x 24, bf16, shared memory,
// MN-major: trans-b)
__device__ __forceinline__ void wgmma_rs24(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// voxels of a raw x row: x0-8 .. x0+TX+7, unpadded.  (Padded as H-fwd-wg's
// raw rows, so that the transposes' ldmatrix.trans are free of bank
// conflicts, the box read 16% more bytes and ran slower where the loads
// bound: tools/ab_wgrad_wg_variants.py.)
__host__ __device__ constexpr int x_row(int tx) { return tx + 16; }

// voxels of a g channel row: TX, and 8 more where TX / 8 is even (odd
// 16-byte groups: the 8 channel rows of an ldmatrix on 8 bank groups)
__host__ __device__ constexpr int g_row(int tx) { return tx + (tx / 8 % 2 == 0 ? 8 : 0); }

// x planes of a run of n g planes that g plane j (0 .. n-1) does not read:
// x plane i is read by g planes i-2 .. i
__device__ __forceinline__ int missing_users(int i, int n) {
  const int lo = i - 2 > 0 ? i - 2 : 0, hi = i < n - 1 ? i : n - 1;
  return 3 - (hi - lo + 1);
}

// the mbarriers' places: full / empty of each ring; the g ring's full
// barriers are (warpgroup, slot): G_FULL + GS * cw + slot
enum { RAW_FULL = 0, RAW_EMPTY = RS, CL_FULL = 2 * RS, CL_EMPTY = 2 * RS + CLS,
       G_FULL = 2 * RS + 2 * CLS, G_EMPTY = G_FULL + 2 * GS, N_BARS = G_EMPTY + GS };

// g channels a slot holds: 32 in the stacked layout (CT <= 32), else 64
__host__ __device__ constexpr int g_channels(bool stack) { return stack ? 32 : MAX_CT; }
// g rows a box holds: y0-1 .. y0+TY in the stacked layout, else y0 .. y0+TY-1
__host__ __device__ constexpr int g_rows(int ty, bool stack) { return stack ? ty + 2 : ty; }
// accumulator tiles: (dz, dy), or in the stacked layout (dz, the dy 1 / 0 pair or dy 2)
__host__ __device__ constexpr int tiles(bool stack) { return stack ? 6 : 9; }

template <int TX, int TY, bool STACK>
__global__ void __launch_bounds__(WW_THREADS, 1)
    conv3d_wgrad_wg_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap gmap, const WwArgs a) {
  constexpr int TXG = g_row(TX);
  constexpr int GR = g_rows(TY, STACK);
  constexpr int TILES = tiles(STACK);
  constexpr int rowx = x_row(TX);    // voxels of a raw x row
  constexpr int rowc = TX + 16;      // voxel slots of a channels-last row: x0-8 .. x0+TX+7
  constexpr uint32_t xstage = 16u * (TY + 2) * rowx;
  constexpr uint32_t cstage = 16u * (TY + 2) * rowc;
  constexpr uint32_t gstage = 2u * GR * g_channels(STACK) * TXG;
  constexpr int STEPS = TX * TY / 16;  // k16 steps of a g plane
  // a k16 step's second 8 voxels: the next 8 of its row, or the next row where TX = 8
  constexpr int DR = TX >= 16 ? 0 : 1, DC = TX >= 16 ? 8 : 0;
  extern __shared__ __align__(1024) unsigned char smem[];

  const uint32_t raw0 = smem_u32(smem);
  const uint32_t cl0 = raw0 + RS * xstage;
  const uint32_t g0 = raw0 + a.g_off;
  const uint32_t bars = raw0 + a.bar_off;
  auto bar = [&](int kind, int i) { return bars + 8u * (kind + i); };

  const int split = blockIdx.x, cg = blockIdx.y, co0 = blockIdx.z * a.ct;
  const int items = a.tiles_x * a.tiles_y * a.d;
  const int i0 = (int)((long long)items * split / a.n_split);
  const int i1 = (int)((long long)items * (split + 1) / a.n_split);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < RS; ++i) {
      mbar_init(bar(RAW_FULL, i), 1);
      mbar_init(bar(RAW_EMPTY, i), TRANSPOSERS);
    }
    for (int i = 0; i < CLS; ++i) {
      mbar_init(bar(CL_FULL, i), TRANSPOSERS);
      mbar_init(bar(CL_EMPTY, i), 3 * 4);  // 3 g planes read an x plane, 4 warps each
    }
    for (int i = 0; i < GS; ++i) {
      mbar_init(bar(G_FULL, i), 1);
      mbar_init(bar(G_FULL, GS + i), 1);
      mbar_init(bar(G_EMPTY, i), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {  // the producer: x planes xs and g planes gs in the order they are read
    if (lane == 0) {
      const uint32_t gbytes = 2u * TXG * a.ct * GR;
      int xs = 0, gs = 0;
      for (int it = i0; it < i1;) {
        const int tile = it / a.d, za = it % a.d;
        const int n = min(i1, (tile + 1) * a.d) - it;
        const int x0 = (tile % a.tiles_x) * TX, y0 = (tile / a.tiles_x) * TY;
        auto load_g = [&](int k, int z) {  // the block's g plane k: plane z of the tile
          const int sl = k % GS;
          const uint32_t full = bar(G_FULL, GS * (k & 1) + sl);
          if (k >= GS) mbar_wait(bar(G_EMPTY, sl), ((k / GS) - 1) & 1);
          mbar_expect_tx(full, gbytes);
          tma_load_4d(g0 + sl * gstage, &gmap, x0, co0, y0 - (STACK ? 1 : 0), z, full);
        };
        for (int i = 0; i < n + 2; ++i) {
          const int rs = xs % RS;
          if (xs >= RS) mbar_wait(bar(RAW_EMPTY, rs), ((xs / RS) - 1) & 1);
          mbar_expect_tx(bar(RAW_FULL, rs), xstage);
          tma_load_4d(raw0 + rs * xstage, &xmap, x0 - 8, y0 - 1, za - 1 + i, 8 * cg,
                      bar(RAW_FULL, rs));
          ++xs;
          if (i >= 2) {  // g plane za + i - 2 reads x planes up to this one
            load_g(gs, za + i - 2);
            ++gs;
          }
        }
        it += n;
      }
    }
    return;
  }

  if (warp < 4) {  // the transposers
    constexpr int xg = rowc / 8;       // 8-voxel groups of a row
    constexpr int nblk = (TY + 2) * xg;  // 8 x 8 blocks of a plane
    const int rr = lane & 7, bi = lane >> 3;
    int s = 0;
    for (int it = i0; it < i1;) {
      const int tile = it / a.d;
      const int n = min(i1, (tile + 1) * a.d) - it;
      for (int i = 0; i < n + 2; ++i, ++s) {
        const int rs = s % RS, cs = s % CLS;
        mbar_wait(bar(RAW_FULL, rs), (s / RS) & 1);
        if (s >= CLS) mbar_wait(bar(CL_EMPTY, cs), ((s / CLS) - 1) & 1);
        __syncwarp();
        const uint32_t src = raw0 + rs * xstage, dsts = cl0 + cs * cstage;
        for (int q = 4 * (warp - 1); q < nblk; q += 4 * TRANSPOSERS) {
          const int b = min(q + bi, nblk - 1);
          const int yy = b / xg, xx = 8 * (b % xg);
          // raw: [channel rr][row yy][x], channels-last: [row yy][x][8 channels]
          transpose_x4(src + 2u * ((rr * (TY + 2) + yy) * rowx + xx),
                       dsts + 16u * (yy * rowc + xx + rr));
        }
        fence_async_smem();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(bar(RAW_EMPTY, rs));
          mbar_arrive(bar(CL_FULL, cs));
          const int miss = missing_users(i, n);
          if (warp == 1 && miss > 0) mbar_arrive_cnt(bar(CL_EMPTY, cs), 4 * miss);
        }
      }
      it += n;
    }
    return;
  }

  // the consumers: warpgroup cw takes the g planes gs with gs % 2 == cw.
  // A rows: 16 wi + the lane's ldmatrix row (lane & 7) + 8 ((lane >> 3) & 1),
  // in the step's first 8 voxels (lanes 0-15) or its second (16-31).  Plain
  // layout: row = output channel, g row r of the step.  Stacked (CT <= 32):
  // first product rows 0-31 = channel, g row r (tap dy 1), rows 32-63 =
  // channel, g row r + 1 (tap dy 0: x row r is g's row minus one); second
  // product rows 0-31 = channel, g row r - 1 (tap dy 2); all read x at the dy
  // 1 descriptor.  A shifted row block is complete over the volume: the one
  // g row it misses meets an x row of zero padding.
  const int cw = (warp - 4) >> 2, wi = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t gy = 2u * a.ct * TXG;  // bytes of a g row: ct channel rows
  const int co_l = (STACK ? 16 * (wi & 1) : 16 * wi) + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t a_lane =
      2u * (co_l < a.ct ? co_l : 0) * TXG + ((lane >> 4) ? DR * gy + 2u * DC : 0u);
  // a warp whose 16 rows are all past CT (or in the unused block) loads nothing
  const bool load_a = STACK ? 16 * (wi & 1) < a.ct : 16 * wi < a.ct;
  const bool load_b = STACK && wi < 2;
  const int a_row = STACK ? 1 + (wi >> 1) : 0;  // g box row of the step's row r, first product
  float acc[TILES][ACC];
#pragma unroll
  for (int t = 0; t < TILES; ++t) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[t][i] = 0.f;
    fence_regs<ACC>(acc[t]);
  }
  uint32_t af[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
  uint32_t bf[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};  // the stacked second product's A
  int xs = 0, gs = 0;
  for (int it = i0; it < i1;) {
    const int tile = it / a.d;
    const int n = min(i1, (tile + 1) * a.d) - it;
    for (int j = 0; j < n; ++j, ++gs) {
      if ((gs & 1) != cw) continue;
      const int sl = gs % GS;
      mbar_wait(bar(G_FULL, GS * cw + sl), (gs / G_CYCLE) & 1);
      uint32_t cl[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {  // x planes za-1+j+q: tap dz = q
        const int x = xs + j + q;
        mbar_wait(bar(CL_FULL, x % CLS), (x / CLS) & 1);
        cl[q] = cl0 + (x % CLS) * cstage;
      }
      __syncwarp();
      const uint32_t gb = g0 + sl * gstage + a_lane;
#pragma unroll
      for (int c = 0; c < STEPS; ++c) {
        // step c: voxels 16c .. 16c+15 of the tile, row r0, columns c0 ..
        const int r0 = 16 * c / TX, c0 = 16 * c % TX;
        wg_wait<1>();  // the step before the last one has retired: its A is free
        if (load_a) tc::ldsm_x4(af[c & 1], gb + (r0 + a_row) * gy + 2u * c0);
        if (load_b) tc::ldsm_x4(bf[c & 1], gb + r0 * gy + 2u * c0);
        wg_fence();
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          // output voxel (r, x) of the tile reads staged row r + dy, column x + dx + 7
          // (column 0 is x0-8); N core matrices dx = 0, 1, 2 one slot apart
          const uint32_t lbo = 16u * (DR * rowc + DC);
          if (STACK) {
            const uint64_t desc = gmma_desc(cl[dz] + 16u * ((r0 + 1) * rowc + c0 + 7), lbo, 16u);
            wgmma_rs24(acc[2 * dz], af[c & 1], desc);
            wgmma_rs24(acc[2 * dz + 1], bf[c & 1], desc);
          } else {
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
              wgmma_rs24(acc[3 * dz + dy], af[c & 1],
                         gmma_desc(cl[dz] + 16u * ((r0 + dy) * rowc + c0 + 7), lbo, 16u));
          }
        }
        wg_commit();
      }
      wg_wait<0>();  // the plane's products have read its slots: release them
      if (lane == 0) {
        mbar_arrive(bar(G_EMPTY, sl));
#pragma unroll
        for (int q = 0; q < 3; ++q) mbar_arrive(bar(CL_EMPTY, (xs + j + q) % CLS));
      }
      __syncwarp();
    }
    xs += n + 2;
    it += n;
  }
#pragma unroll
  for (int t = 0; t < TILES; ++t) fence_regs<ACC>(acc[t]);

  // warpgroup 1's sums to warpgroup 0 through the rings, which every load has left
  consumers_sync();
  fence_async_smem();
  float* hand = reinterpret_cast<float*>(smem);
  const int tl = threadIdx.x & 127;
  if (cw == 1) {
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int i = 0; i < ACC; ++i) hand[(t * ACC + i) * 128 + tl] = acc[t][i];
  }
  consumers_sync();
  if (cw == 1) return;
  // accumulator (t, 4 dx + e): M row 16 wi + g + 8 (e >> 1), input channel
  // 8 cg + 2 tq + (e & 1); t = 3 dz + dy, or stacked 2 dz + (0: dy 1 | dy 0 by
  // row block, 1: dy 2 | unused)
  float* out = a.partial + (long long)split * 27 * a.ci_pad * a.co_pad;
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      int row = 16 * wi + g + 8 * ((i & 3) >> 1), dz, dy;
      if (STACK) {
        const int blk = row >> 5;
        if ((t & 1) && blk) continue;
        dz = t >> 1;
        dy = (t & 1) ? 2 : 1 - blk;
        row &= 31;
      } else {
        dz = t / 3;
        dy = t % 3;
      }
      if (row >= a.ct) continue;
      const int ci = 8 * cg + 2 * tq + (i & 1), tap = 9 * dz + 3 * dy + (i >> 2);
      out[((long long)tap * a.ci_pad + ci) * a.co_pad + co0 + row] =
          acc[t][i] + hand[(t * ACC + i) * 128 + tl];
    }
}

template <int TX, int TY, bool STACK>
int launch_ww(const CUtensorMap& xm, const CUtensorMap& gm, const WwArgs& a, dim3 grid,
              size_t smem, cudaStream_t stream) {
  static bool attr = false;  // the most shared memory any launch may ask for, set once
  if (!attr) {
    const int err = (int)cudaFuncSetAttribute(conv3d_wgrad_wg_kernel<TX, TY, STACK>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              MAX_SMEM);
    if (err) return err;
    attr = true;
  }
  conv3d_wgrad_wg_kernel<TX, TY, STACK><<<grid, WW_THREADS, smem, stream>>>(xm, gm, a);
  return (int)cudaGetLastError();
}

// (TX, TY): a tile's width and height of one plane; ops/conv_cf.WGRAD_WG_TILES agrees
#define WW_CONFIGS(X) X(32, 8) X(16, 8) X(8, 8)

int config(int tx) {
#define WW_CASE(TX_, TY_) \
  if (tx == TX_) return TY_;
  WW_CONFIGS(WW_CASE)
#undef WW_CASE
  return 0;
}

}  // namespace

extern "C" {

// the tile height of tile width tx, 0 for a width the kernel has no instance for
int conv3d_wgrad_wg_config(int tx) { return config(tx); }

// dw (27, ci, co) float32 = the weight gradient of bf16 x (ci, D, H, W) and g
// (co, D, H, W), W % 8 == 0, any ci and co (the boxes are zero-filled past
// them); tx: the tile width (WW_CONFIGS); ct: output channels a block (a
// multiple of 8, <= 64); stack: the stacked layout (ct <= 32); n_split:
// blocks over the volume per (8-channel group, ct tile);
// partial: (n_split, 27, ci_pad, co_pad) float32 scratch, unused where
// n_split == 1 and ci, co need no padding.
int conv3d_wgrad_wg_launch(const void* x, const void* g, int ci, int co, int d, int h, int w,
                           int tx, int ct, int stack, int n_split, float* partial, float* dw,
                           void* stream) {
  const int ty = config(tx);
  const bool st = stack != 0;
  if (!ty || w % 8 || ct % 8 || ct < 8 || ct > g_channels(st) || n_split < 1)
    return WG_ERR_ARGS;
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return WG_ERR_ENTRY;
  const int groups = (ci + 7) / 8, co_tiles = (co + ct - 1) / ct;
  const int ci_pad = 8 * groups, co_pad = ct * co_tiles;
  const bool direct = n_split == 1 && ci_pad == ci && co_pad == co;
  const size_t xrings = RS * 16ull * (ty + 2) * x_row(tx) + CLS * 16ull * (ty + 2) * (tx + 16);
  const size_t rings = xrings + GS * 2ull * g_rows(ty, st) * g_channels(st) * g_row(tx);
  const size_t hand = 4ull * tiles(st) * ACC * 128;
  const size_t body = rings > hand ? rings : hand;
  const size_t smem = body + 8 * N_BARS;
  if (smem > MAX_SMEM) return WG_ERR_ARGS;
  WwArgs a{d, (w + tx - 1) / tx, (h + ty - 1) / ty, n_split, ct, ci_pad, co_pad,
           direct ? dw : partial, (unsigned)xrings, (unsigned)body};
  if ((long long)a.tiles_x * a.tiles_y * d > (1ll << 30)) return WG_ERR_ARGS;
  CUtensorMap xm, gm;
  int err = encode_cf(fn, &xm, x, ci, d, h, w, x_row(tx), ty + 2, 1, 8);
  if (!err) {  // g as (W, C, H, D): a box lands as [row][channel][voxel]
    const cuuint64_t dims[4] = {(cuuint64_t)w, (cuuint64_t)co, (cuuint64_t)h, (cuuint64_t)d};
    const cuuint64_t strides[3] = {2ull * w * h * d, 2ull * w, 2ull * w * h};
    const cuuint32_t box[4] = {(cuuint32_t)g_row(tx), (cuuint32_t)ct,
                               (cuuint32_t)g_rows(ty, st), 1};
    err = encode_4d(fn, &gm, g, dims, strides, box);
  }
  if (err) return err;
  const dim3 grid((unsigned)n_split, (unsigned)groups, (unsigned)co_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WW_LAUNCH(TX_, TY_)                                                       \
  if (tx == TX_) {                                                                \
    err = st ? launch_ww<TX_, TY_, true>(xm, gm, a, grid, smem, s)                \
             : launch_ww<TX_, TY_, false>(xm, gm, a, grid, smem, s);              \
  }
  WW_CONFIGS(WW_LAUNCH)
#undef WW_LAUNCH
  if (err || direct) return err;
  return conv3d_wgrad_reduce(partial, n_split, ci, co, ci_pad, co_pad, dw, stream);
}

}  // extern "C"
