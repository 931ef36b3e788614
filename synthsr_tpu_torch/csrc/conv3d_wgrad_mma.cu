// H-wgrad-mma: the weight gradient of the channels-first SAME 3x3x3
// convolution (stride 1) on bf16 operands, on Hopper's tensor cores
// (sm_90a).  Replaces the TPU kernels K6 (_wgrad_kernel,
// synthsr_tpu/ops/conv_pallas.py:1090) and K7 (_wgrad_flat_kernel, :1705),
// which multiply bf16 operands into float32 sums (conv_pallas.py:1187-1191)
// as mma.sync does here.  Float32 operands run on H-wgrad-x3
// (conv3d_wgrad_x3.cu).
//
//   dw[tap, ci, co] = sum_vox x[ci, vox + tap] * g[co, vox]
//
// as 27 GEMMs that share one K = the volume's voxels, with zero padding at
// every face by predicate.  The launcher allocates nothing, runs on the
// stream it is given and returns cudaGetLastError() (0 = launched).
//
// Bound: 2*27*ci*co FLOPs per voxel against 2*(ci + co) bytes, so operations
// bound (989 TFLOP/s dense bf16 on an H100 SXM); with only 27*ci*co outputs
// over millions of voxels the work is split over the volume to fill the card.
//
// Design: a grid of (n_split, 8-channel groups of x, co tiles of 16*MT)
// (ops/conv_cf.py:wgrad_plan).  Each block walks a contiguous range of
// (z-plane, 4 x 32 tile) items, K = 128 voxels each: per item it stages the
// channels-last halo tile of its 8 x channels (mma_common.cuh) and the
// (16*MT, 128) tile of g, channels-first (no shift, so cp.async copies it
// as it lies; rows padded to 136 bf16 so ldmatrix rows hit distinct banks),
// both double-buffered so the next item's copies are in flight during this
// item's mma.  Warp dz (3 warps) owns the 9 taps (dz, dy, dx): per k16 step
// it loads the g fragments (A = g, M = co) once and, for each tap, the x
// fragments (B = x shifted by the tap, N = 8 channels) by ldmatrix.trans
// from the halo, two taps per ldmatrix.x4; 9 * MT m16n8 sums live in its
// registers for the whole range.  The block writes its partial once to
// (n_split, 27, ci_pad, co_pad); the reduce of conv3d_wgrad.cu sums the
// partials over the splits in a fixed order, so dw is bit-reproducible run
// to run (no atomics).  Volume offsets are 64-bit.

#include "mma_common.cuh"

extern "C" int conv3d_wgrad_reduce(const float* partial, int n_split, int ci, int co, int ci_pad,
                                   int co_pad, float* dw, void* stream);

namespace {

using tc::Halo;
using tc::HaloRegs;
using tc::Volume;

constexpr int WM_TY = 4;
constexpr int WM_TX = 32;
constexpr int WM_VOX = WM_TY * WM_TX;  // K per item
constexpr int WM_THREADS = 96;         // 3 warps, one per dz
constexpr int G_STRIDE = WM_VOX + 8;   // bf16 per channel row of the staged g tile
using WHalo = Halo<WM_TY>;
static_assert(WHalo::ITEMS <= WM_THREADS, "one halo item per thread");

struct WgradMmaArgs {
  const uint16_t* x;
  const uint16_t* g;
  int ci, co;
  int d, h, w;
  int ci_pad, co_pad, n_split, vec;
  float* partial;  // (n_split, 27, ci_pad, co_pad)
};

template <int MT>
__global__ void __launch_bounds__(WM_THREADS) conv3d_wgrad_mma_kernel(const WgradMmaArgs a) {
  constexpr int CT = 16 * MT;
  constexpr int GBYTES = CT * G_STRIDE * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_g = smem + 2 * WHalo::BYTES;

  const int split = blockIdx.x;
  const int cg = blockIdx.y;
  const int co0 = blockIdx.z * CT;
  const int t = threadIdx.x, lane = t & 31, dz = t >> 5;
  const long long hw = (long long)a.h * a.w;
  const Volume vol{a.d, a.h, a.w, hw, hw * a.d};
  const bool vec = a.vec != 0;
  const int tiles_x = (a.w + WM_TX - 1) / WM_TX;
  const int tiles = tiles_x * ((a.h + WM_TY - 1) / WM_TY);
  const long long items = (long long)a.d * tiles;
  const long long i0 = items * split / a.n_split;
  const long long i1 = items * (split + 1) / a.n_split;
  const uint16_t* xp = a.x + 8 * cg * vol.dhw;
  const int nc = min(8, a.ci - 8 * cg);

  auto origin = [&](long long it, int& z, int& y0, int& x0) {
    z = (int)(it / tiles);
    const int tile = (int)(it % tiles);
    x0 = (tile % tiles_x) * WM_TX;
    y0 = (tile / tiles_x) * WM_TY;
  };
  // the g tile: CT rows x 16 segments of 8 voxels; zero outside the volume and beyond co
  auto stage_g = [&](int z, int y0, int x0, int buf) {
    unsigned char* dst = s_g + buf * GBYTES;
    for (int e = t; e < CT * 16; e += WM_THREADS) {
      const int row = e >> 4, vy = (e >> 2) & 3, xs = e & 3;
      const int co = co0 + row, y = y0 + vy, x = x0 + 8 * xs;
      const bool ok = co < a.co && y < a.h;
      const long long off = co * vol.dhw + (long long)z * hw + (long long)y * a.w + x;
      unsigned char* d8 = dst + row * G_STRIDE * 2 + (vy * WM_TX + 8 * xs) * 2;
      if (vec) {
        const bool in = ok && x < a.w;
        tc::cp_async16(tc::smem_u32(d8), in ? a.g + off : a.g, in);
      } else {
        uint16_t* d16 = reinterpret_cast<uint16_t*>(d8);
        for (int i = 0; i < 8; ++i) d16[i] = ok && x + i < a.w ? a.g[off + i] : (uint16_t)0;
      }
    }
  };

  float acc[9][MT][4];
#pragma unroll
  for (int p = 0; p < 9; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][mt][e] = 0.f;

  // A (g): lane's row co (lane & 7) + 8*((lane >> 3) & 1), columns 8*(lane >> 4)
  const uint32_t g_lane = 2u * (((lane & 7) + ((lane >> 3) & 1) * 8) * G_STRIDE + 8 * (lane >> 4));
  // B (x, transposed): lane's row = voxel (lane & 15) of the k16 step; lanes 16-31 the second tap
  const int vb = lane & 15, second = lane >> 4;

  HaloRegs st;
  int z, y0, x0;
  if (i0 < i1) {
    origin(i0, z, y0, x0);
    tc::halo_load<WM_TY>(st, xp, nc, vol, z, y0, x0, vec, t);
    stage_g(z, y0, x0, 0);
    tc::cp_async_commit();
    tc::halo_store<WM_TY>(st, smem, t);
    tc::cp_async_wait_all();
    __syncthreads();
  }
#pragma unroll 1
  for (long long it = i0; it < i1; ++it) {
    const int buf = (int)((it - i0) & 1);
    const bool more = it + 1 < i1;
    if (more) {
      origin(it + 1, z, y0, x0);
      tc::halo_load<WM_TY>(st, xp, nc, vol, z, y0, x0, vec, t);
      if (vec) stage_g(z, y0, x0, buf ^ 1);
    }
    tc::cp_async_commit();
    const uint32_t hb = tc::smem_u32(smem + buf * WHalo::BYTES);
    const uint32_t gb = tc::smem_u32(s_g + buf * GBYTES) + g_lane;
#pragma unroll
    for (int s = 0; s < WM_VOX / 16; ++s) {
      const int vy = s >> 1, vx = (s & 1) * 16 + vb;
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) tc::ldsm_x4(af[mt], gb + 2u * (16 * mt * G_STRIDE + 16 * s));
      const uint32_t xb = hb + 16u * (dz * WHalo::PLANE + vy * WHalo::ROW + vx);
#pragma unroll
      for (int p = 0; p < 9; p += 2) {
        const int q = p + 1 < 9 ? p + 1 : p;
        const int pl = second ? q : p;  // this lane's tap (dy, dx) = (pl / 3, pl % 3)
        uint32_t b[4];
        tc::ldsm_x4_t(b, xb + 16u * ((pl / 3) * WHalo::ROW + pl % 3));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) tc::mma_bf16(acc[p][mt], af[mt], b[0], b[1]);
        if (p + 1 < 9) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) tc::mma_bf16(acc[p + 1][mt], af[mt], b[2], b[3]);
        }
      }
    }
    if (more) {
      tc::halo_store<WM_TY>(st, smem + (buf ^ 1) * WHalo::BYTES, t);
      if (!vec) stage_g(z, y0, x0, buf ^ 1);
    }
    tc::cp_async_wait_all();
    __syncthreads();
  }

  // accumulator (p, mt, e): tap dz*9 + p, co = co0 + 16*mt + g + 8*(e >> 1),
  // ci = 8*cg + 2*tq + (e & 1)
  const int g = lane >> 2, tq = lane & 3;
  float* out = a.partial + (long long)split * 27 * a.ci_pad * a.co_pad;
#pragma unroll
  for (int p = 0; p < 9; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = co0 + 16 * mt + g + 8 * (e >> 1);
        const int ci = 8 * cg + 2 * tq + (e & 1);
        out[((long long)(dz * 9 + p) * a.ci_pad + ci) * a.co_pad + co] = acc[p][mt][e];
      }
}

template <int MT>
int launch_wgrad_mma(const WgradMmaArgs& a, float* dw, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)WHalo::BYTES + 2 * (size_t)16 * MT * G_STRIDE * 2;
  int err = (int)cudaFuncSetAttribute(conv3d_wgrad_mma_kernel<MT>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid(a.n_split, a.ci_pad / 8, a.co_pad / (16 * MT));
  conv3d_wgrad_mma_kernel<MT><<<grid, WM_THREADS, smem, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  return conv3d_wgrad_reduce(a.partial, a.n_split, a.ci, a.co, a.ci_pad, a.co_pad, dw, stream);
}

}  // namespace

extern "C" {

int conv3d_wgrad_mma_launch(const void* x, const void* g, int ci, int co, int d, int h, int w,
                            int mt, int n_split, int vec, float* partial, float* dw,
                            void* stream) {
  if (n_split < 1 || mt < 1 || mt > 3) return (int)cudaErrorInvalidValue;
  const int ci_pad = (ci + 7) / 8 * 8;
  const int co_pad = (co + 16 * mt - 1) / (16 * mt) * (16 * mt);
  const WgradMmaArgs a{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(g), ci, co,
                       d, h, w, ci_pad, co_pad, n_split, vec, partial};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 1: return launch_wgrad_mma<1>(a, dw, s);
    case 2: return launch_wgrad_mma<2>(a, dw, s);
    case 3: return launch_wgrad_mma<3>(a, dw, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
