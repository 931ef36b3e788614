// H-wgrad-x3: the weight gradient of the channels-first SAME 3x3x3
// convolution (stride 1) on float32 operands, on Hopper's tensor cores
// (sm_90a) at float32 accuracy by split TF32 (mma_common.cuh).  Replaces the
// TPU kernels K6 (_wgrad_kernel, synthsr_tpu/ops/conv_pallas.py:1090) and K7
// (_wgrad_flat_kernel, :1705) on the float32 path; bf16 operands run on
// H-wgrad-mma (conv3d_wgrad_mma.cu).
//
//   dw[tap, ci, co] = sum_vox x[ci, vox + tap] * g[co, vox]
//
// as 27 GEMMs that share one K = the volume's voxels, with zero padding at
// every face by predicate.  The launcher allocates nothing, runs on the
// stream it is given and returns cudaGetLastError() (0 = launched).
//
// Bound: 2*27*ci*co FLOPs per voxel against 4*(ci + co) bytes, so operations
// bound; float32-accurate work takes three TF32 products, so the ceiling is
// 495 / 3 = 165 TFLOP/s on an H100 SXM (67 on the CUDA cores).  With only
// 27*ci*co outputs over millions of voxels the work is split over the volume
// to fill the card.
//
// Design: H-wgrad-mma's grid.  A grid of (n_split, 8-channel groups of x, co
// tiles of 16*MT) (ops/conv_cf.py:wgrad_plan); each block walks a contiguous
// range of items of 128 voxels (K), 16 m16n8k8 steps each: (plane, 4 x 32
// tile), or on a narrow volume (plane, 8 x 16 tile) where W is 9-16 and (2
// planes, 8 x 8 tile) where W <= 8 (X3_ITEMS), so that no lane computes the
// zeros past a narrow volume's edge.  Warp (dz, m) (3*MT warps) owns the 9
// taps (dz, ., .) of the m16 tile m of output channels.  Per item
// the block stages, by cp.async and double-buffered (the next item's copies
// are in flight during this item's mma):
//
// - A = g (M = co, K = voxels): the (16*MT, 128) tile, channels-first as it
//   lies, rows padded to G_STRIDE = 132 words (33 16-byte units, odd) so the
//   8 rows of an ldmatrix matrix hit distinct banks.  On the b16 view an
//   8 x 8 matrix is 8 co rows x 4 float32 voxels, so ldmatrix.x4 gives lane
//   4g + tq exactly the tf32 A fragment: co 0-7 / 8-15 x voxels 0-3 / 4-7.
// - B = x shifted by the tap (K = voxels, N = 8 channels): a lane needs
//   (voxel tq, channel g), the transpose of what ldmatrix gives, and
//   ldmatrix.trans moves 16-bit elements only.  So x is staged channels-first
//   too, the (8, planes + 2, rows + 2, width + 2) halo slab with a channel
//   stride of 4 mod 32 words (740 for 4 x 32 items), and read with scalar
//   ld.shared: the dx = +-1 shift is a 4-byte offset, and the 32 lanes
//   (g * stride + tq) hit 32 distinct banks.
//
// Both operands are split into big and small in registers after the load; a
// g fragment serves 9 taps.  Per step: small_g*big_x over the 9 taps, then
// big_g*small_x, then big_g*big_x (each pass 9 independent mma), chained on
// the tensor cores into the item's partial sums (48 mma a sum), which are
// then added to the float32 sums by a rounding add: the tensor cores' own
// accumulation truncates (mma_common.cuh), and a block's range is thousands
// of steps.  9 m16n8 sums and as many partials live in a warp's registers
// (with one warp for all MT m16 tiles, MT = 2 took 227 registers a thread,
// two blocks of 3 warps an SM).
// Shared memory: 2 x (20,608-23,680 + 8,448*MT) bytes, 58-81 KB: two blocks
// an SM (three at MT = 1), MT <= 2.  The block writes its partial once to (n_split, 27,
// ci_pad, co_pad); the reduce of conv3d_wgrad.cu sums the partials over the
// splits in a fixed order, so dw is bit-reproducible run to run (no
// atomics).  Volume offsets are 64-bit.

#include "mma_common.cuh"

extern "C" int conv3d_wgrad_reduce(const float* partial, int n_split, int ci, int co, int ci_pad,
                                   int co_pad, float* dw, void* stream);

namespace {

using tc::Volume;

constexpr int WX_VOX = 128;  // K per item
constexpr int WX_WARPS = 3;  // warps per m16 tile of output channels, one per dz
constexpr int G_STRIDE = WX_VOX + 4;  // floats per co row of the staged g tile
static_assert((G_STRIDE / 4) % 2 == 1, "ldmatrix rows on distinct bank groups");

// an item of NZ planes x TY rows x TX voxels and its x halo slab
template <int NZ, int TY, int TX>
struct Item {
  static_assert(NZ * TY * TX == WX_VOX && TX % 8 == 0, "128 voxels, whole 8-voxel steps");
  // floats a halo row: [3] = x0 - 1, [4 ..] = x0 .., [4 + TX] = x0 + TX
  static constexpr int ROW = TX + 8;
  static constexpr int PLANE = (TY + 2) * ROW;
  static constexpr int CH = ((NZ + 2) * PLANE + 27) / 32 * 32 + 4;  // floats a channel, 4 mod 32
  static constexpr int HALO = 8 * CH * 4;  // bytes of an item's x slab
  static_assert(CH >= (NZ + 2) * PLANE && CH % 32 == 4 && CH % 4 == 0,
                "conflict-free, 16-byte aligned channel slabs");
};

template <int MT, int NZ, int TY, int TX>
__host__ __device__ constexpr int item_bytes() {
  return Item<NZ, TY, TX>::HALO + 16 * MT * G_STRIDE * 4;
}

struct WgradX3Args {
  const float* x;
  const float* g;
  int ci, co;
  int d, h, w;
  int ci_pad, co_pad, n_split, vec;
  float* partial;  // (n_split, 27, ci_pad, co_pad)
};

template <int MT, int NZ, int TY, int TX>
__global__ void __launch_bounds__(32 * WX_WARPS * MT) conv3d_wgrad_x3_kernel(const WgradX3Args a) {
  using It = Item<NZ, TY, TX>;
  constexpr int CT = 16 * MT;
  constexpr int NTH = 32 * WX_WARPS * MT;
  constexpr int IBYTES = item_bytes<MT, NZ, TY, TX>();
  extern __shared__ __align__(128) unsigned char smem[];

  const int split = blockIdx.x;
  const int cg = blockIdx.y;
  const int co0 = blockIdx.z * CT;
  const int t = threadIdx.x, lane = t & 31, dz = (t >> 5) % 3, m = (t >> 5) / 3;
  const long long hw = (long long)a.h * a.w;
  const Volume vol{a.d, a.h, a.w, hw, hw * a.d};
  const bool vec = a.vec != 0;
  const int tiles_x = (a.w + TX - 1) / TX;
  const int tiles = tiles_x * ((a.h + TY - 1) / TY);
  const long long items = (long long)((a.d + NZ - 1) / NZ) * tiles;
  const long long i0 = items * split / a.n_split;
  const long long i1 = items * (split + 1) / a.n_split;
  const float* xp = a.x + 8 * cg * vol.dhw;
  const int nc = min(8, a.ci - 8 * cg);

  // item `it` into buffer `buf`, one commit group
  auto issue = [&](long long it, int buf) {
    const int z = (int)(it / tiles) * NZ;
    const int tile = (int)(it % tiles);
    const int x0 = (tile % tiles_x) * TX;
    const int y0 = (tile / tiles_x) * TY;
    const uint32_t xs = tc::smem_u32(smem + buf * IBYTES);
    const uint32_t gs = xs + It::HALO;
    // x slab: channel, plane z - 1 + pl, row y0 - 1 + r, voxels x0 - 1 .. x0 + TX
    constexpr int XROWS = 8 * (NZ + 2) * (TY + 2);
    constexpr int SEGS = TX / 4 + 2;  // 16-byte segments of a row, then its two edge voxels
    if (vec) {
      for (int e = t; e < XROWS * SEGS; e += NTH) {
        const int seg = e % SEGS, r = (e / SEGS) % (TY + 2);
        const int pl = (e / (SEGS * (TY + 2))) % (NZ + 2);
        const int ch = e / (SEGS * (NZ + 2) * (TY + 2));
        const int gz = z - 1 + pl, gy = y0 - 1 + r;
        const bool ok = ch < nc && gz >= 0 && gz < a.d && gy >= 0 && gy < a.h;
        const float* rp = xp + ch * vol.dhw + (long long)gz * hw + (long long)gy * a.w;
        const uint32_t dst = xs + 4u * (ch * It::CH + pl * It::PLANE + r * It::ROW);
        if (seg < TX / 4) {
          const int x = x0 + 4 * seg;
          const bool in = ok && x < a.w;
          tc::cp_async16(dst + 16u * (1 + seg), in ? rp + x : a.x, in);
        } else {
          const int x = seg == TX / 4 ? x0 - 1 : x0 + TX;
          const bool in = ok && x >= 0 && x < a.w;
          tc::cp_async4(dst + 4u * (seg == TX / 4 ? 3 : 4 + TX), in ? rp + x : a.x, in);
        }
      }
      for (int e = t; e < CT * WX_VOX / 4; e += NTH) {  // g: CT rows x 32 segments of 4 voxels
        const int row = e >> 5, v = 4 * (e & 31);
        const int zz = z + v / (TY * TX), y = y0 + v / TX % TY, x = x0 + v % TX;
        const int co = co0 + row;
        const bool in = co < a.co && zz < a.d && y < a.h && x < a.w;
        const float* src = in ? a.g + co * vol.dhw + (long long)zz * hw + (long long)y * a.w + x
                              : a.g;
        tc::cp_async16(gs + 4u * (row * G_STRIDE + v), src, in);
      }
    } else {
      for (int e = t; e < XROWS * (TX + 2); e += NTH) {
        const int xi = e % (TX + 2), r = (e / (TX + 2)) % (TY + 2);
        const int pl = (e / ((TX + 2) * (TY + 2))) % (NZ + 2);
        const int ch = e / ((TX + 2) * (TY + 2) * (NZ + 2));
        const int gz = z - 1 + pl, gy = y0 - 1 + r, x = x0 - 1 + xi;
        const bool in = ch < nc && gz >= 0 && gz < a.d && gy >= 0 && gy < a.h && x >= 0 &&
                        x < a.w;
        const float* src =
            in ? xp + ch * vol.dhw + (long long)gz * hw + (long long)gy * a.w + x : a.x;
        tc::cp_async4(xs + 4u * (ch * It::CH + pl * It::PLANE + r * It::ROW + 3 + xi), src, in);
      }
      for (int e = t; e < CT * WX_VOX; e += NTH) {
        const int row = e >> 7, v = e & 127;
        const int zz = z + v / (TY * TX), y = y0 + v / TX % TY, x = x0 + v % TX;
        const int co = co0 + row;
        const bool in = co < a.co && zz < a.d && y < a.h && x < a.w;
        const float* src = in ? a.g + co * vol.dhw + (long long)zz * hw + (long long)y * a.w + x
                              : a.g;
        tc::cp_async4(gs + 4u * (row * G_STRIDE + v), src, in);
      }
    }
    tc::cp_async_commit();
  };

  float acc[9][4], part[9][4];
#pragma unroll
  for (int p = 0; p < 9; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[p][e] = 0.f;

  const int g = lane >> 2, tq = lane & 3;
  // A (g): the lane's ldmatrix row co 16*m + (lane & 7) + 8*((lane >> 3) & 1), voxels
  // 4*(lane >> 4)..+3
  const uint32_t g_lane =
      4u * ((16 * m + (lane & 7) + ((lane >> 3) & 1) * 8) * G_STRIDE + 4 * (lane >> 4));
  // B (x): the lane's element, channel g, voxel tq of the step, at tap (dz, 0, 0)
  const int x_lane = g * It::CH + dz * It::PLANE + 3 + tq;

  if (i0 < i1) issue(i0, 0);
#pragma unroll 1
  for (long long it = i0; it < i1; ++it) {
    const int buf = (int)((it - i0) & 1);
    if (it + 1 < i1) {
      issue(it + 1, buf ^ 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const float* xb = reinterpret_cast<const float*>(smem + buf * IBYTES) + x_lane;
    const uint32_t gb = tc::smem_u32(smem + buf * IBYTES + It::HALO) + g_lane;
#pragma unroll
    for (int p = 0; p < 9; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[p][e] = 0.f;
#pragma unroll 2
    for (int s = 0; s < WX_VOX / 8; ++s) {  // voxels 8s..8s+7 of the item: one row's 8
      uint32_t r[4], ab[4], as[4];
      tc::ldsm_x4(r, gb + 4u * (8 * s));
#pragma unroll
      for (int e = 0; e < 4; ++e) tc::split_tf32(__uint_as_float(r[e]), ab[e], as[e]);
      const float* xq =
          xb + 8 * s / (TY * TX) * It::PLANE + 8 * s / TX % TY * It::ROW + 8 * s % TX;
      uint32_t bb[9][2], bs[9][2];
#pragma unroll
      for (int p = 0; p < 9; ++p) {  // tap (dz, p / 3, p % 3)
        const float* q = xq + (p / 3) * It::ROW + p % 3;
        tc::split_tf32(q[0], bb[p][0], bs[p][0]);
        tc::split_tf32(q[4], bb[p][1], bs[p][1]);
      }
#pragma unroll
      for (int p = 0; p < 9; ++p) tc::mma_tf32(part[p], as, bb[p][0], bb[p][1]);
#pragma unroll
      for (int p = 0; p < 9; ++p) tc::mma_tf32(part[p], ab, bs[p][0], bs[p][1]);
#pragma unroll
      for (int p = 0; p < 9; ++p) tc::mma_tf32(part[p], ab, bb[p][0], bb[p][1]);
    }
#pragma unroll
    for (int p = 0; p < 9; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][e] += part[p][e];
    __syncthreads();
  }

  // accumulator (p, e): tap dz*9 + p, co = co0 + 16*m + g + 8*(e >> 1),
  // ci = 8*cg + 2*tq + (e & 1)
  float* out = a.partial + (long long)split * 27 * a.ci_pad * a.co_pad;
#pragma unroll
  for (int p = 0; p < 9; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = co0 + 16 * m + g + 8 * (e >> 1);
      const int ci = 8 * cg + 2 * tq + (e & 1);
      out[((long long)(dz * 9 + p) * a.ci_pad + ci) * a.co_pad + co] = acc[p][e];
    }
}

template <int MT, int NZ, int TY, int TX>
int launch_wgrad_x3(const WgradX3Args& a, float* dw, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)item_bytes<MT, NZ, TY, TX>();
  int err = (int)cudaFuncSetAttribute(conv3d_wgrad_x3_kernel<MT, NZ, TY, TX>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid(a.n_split, a.ci_pad / 8, a.co_pad / (16 * MT));
  conv3d_wgrad_x3_kernel<MT, NZ, TY, TX><<<grid, 32 * WX_WARPS * MT, smem, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  return conv3d_wgrad_reduce(a.partial, a.n_split, a.ci, a.co, a.ci_pad, a.co_pad, dw, stream);
}

// (item width, planes, rows) of the items by the volume's width;
// ops/conv_cf.WGRAD_X3_ITEMS agrees
#define X3_ITEMS(X) X(32, 1, 4) X(16, 1, 8) X(8, 2, 8)

}  // namespace

extern "C" {

// tx: the item width (X3_ITEMS)
int conv3d_wgrad_x3_launch(const void* x, const void* g, int ci, int co, int d, int h, int w,
                           int mt, int tx, int n_split, int vec, float* partial, float* dw,
                           void* stream) {
  if (n_split < 1 || mt < 1 || mt > 2) return (int)cudaErrorInvalidValue;
  const int ci_pad = (ci + 7) / 8 * 8;
  const int co_pad = (co + 16 * mt - 1) / (16 * mt) * (16 * mt);
  const WgradX3Args a{static_cast<const float*>(x), static_cast<const float*>(g), ci, co,
                      d, h, w, ci_pad, co_pad, n_split, vec, partial};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define X3_LAUNCH(TX_, NZ_, TY_)                                        \
  if (tx == TX_) {                                                      \
    return mt == 1 ? launch_wgrad_x3<1, NZ_, TY_, TX_>(a, dw, s)        \
                   : launch_wgrad_x3<2, NZ_, TY_, TX_>(a, dw, s);       \
  }
  X3_ITEMS(X3_LAUNCH)
#undef X3_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
