// H-fwd-mma: the channels-first SAME 3x3x3 convolution (stride 1) on bf16
// activations, on Hopper's tensor cores (sm_90a).  Replaces the TPU kernels
// K2 (_plane_kernel, synthsr_tpu/ops/conv_pallas.py:270), K3
// (conv3d_cf_grouped :920), K4 (_flat_kernel :1297) and K5 (_kernel :127),
// which multiply bf16 operands into float32 sums (conv_pallas.py:471-480) as
// mma.sync does here.  Float32 activations keep the CUDA-core H-fwd of
// conv3d_cf.cu.  The launcher runs on the stream it is given, allocates
// nothing and returns cudaGetLastError() (0 = launched).
//
// Bound: 2*27*C_in FLOPs per output value against 2 bytes per input value,
// so operations bound at every U-Net width (989 TFLOP/s dense bf16 on an
// H100 SXM; mma.sync reaches a part of it, wgmma the rest).  In practice the
// staging of the halo (three planes per output plane) and the shared-memory
// reads of the fragments limit it before the tensor cores do.
//
// Design: implicit GEMM.  A block owns one output plane z, an 8 x 32 (H x W)
// tile of it (M = 256 voxels, 4 warps of 2 rows = 4 m16 tiles each) and
// NT = 8*NG output channels (N = NG n8 tiles, all held by every warp).  K =
// 27 taps x input channels, walked in 8-channel groups: the two sources
// ([skip, up], concatenated only in concept) are each padded to a multiple
// of 8 channels in shared memory, never in device memory.  Per group the
// kernel stages the channels-last halo tile (mma_common.cuh) and the group's
// prepacked weight fragments (cp.async), double-buffered: the loads of group
// k+1 are in flight while the tensor cores run group k.  A group is 14 k16
// steps: step s pairs tap 2s (k 0-7) with tap 2s+1 (k 8-15), each lane
// giving ldmatrix the slot of its own voxel shifted by its own tap; step 13
// pairs tap 26 with a zero weight.  B comes from weights that the host packs
// once per weight set in exactly the order the lanes read them
// ((n_tile, group, step, n8, lane, 4 bf16), ops/conv_cf.py:_mma_fragments),
// so one ld.shared.v2 per lane is a conflict-free B fragment.
//
// Epilogue, in registers: + accum, + bias, ELU as exp(x) - 1 / ReLU /
// LeakyReLU(0.2) (v >= 0 ? v : 0.2v, as conv_pallas.py:368), the
// post affine; then either the folded 1x1x1 head (summed over the thread's
// channels, over the quad by shuffles; every warp holds all of the block's
// channels) stored as (1, D, H, W) float32, or the tile staged through shared
// memory so the channels-first stores are 16-byte and coalesced.  Ragged
// tiles are masked at the store; offsets into a volume are 64-bit.

#include "mma_common.cuh"

namespace {

using tc::Halo;
using tc::HaloRegs;
using tc::Volume;

enum { ACT_NONE = 0, ACT_ELU = 1, ACT_RELU = 2, ACT_LEAKY = 3 };

constexpr int FM_TY = 8;
constexpr int FM_TX = 32;
constexpr int FM_THREADS = 128;
constexpr int FM_STEPS = 14;  // k16 steps per 8-channel group
using FHalo = Halo<FM_TY>;
constexpr int OUT_STRIDE = FM_TY * FM_TX + 8;  // bf16 per channel row of the staged output
static_assert(FHalo::ITEMS <= FM_THREADS, "one halo item per thread");

struct FwdMmaArgs {
  const uint16_t* src0;
  const uint16_t* src1;
  int c0, c1;      // channels of each source
  int g0, groups;  // 8-channel groups of source 0, of both
  int d, h, w;
  const unsigned char* wpk;  // (n_tiles, groups, FM_STEPS, NG, 32 lanes, 4 bf16)
  int cout;
  const float* bias;
  const uint16_t* accum;
  const float* post;
  const float* head;
  int act, vec;
  void* out;
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_ELU) return v > 0.f ? v : expf(v) - 1.f;
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_LEAKY) return v >= 0.f ? v : 0.2f * v;
  return v;
}

template <int NG>
__global__ void __launch_bounds__(FM_THREADS) conv3d_fwd_mma_kernel(const FwdMmaArgs a) {
  constexpr int NT = 8 * NG;
  constexpr int WCHUNK = FM_STEPS * NG * 32 * 8;  // bytes of one group's B fragments
  static_assert(NT * OUT_STRIDE * 2 <= 2 * FHalo::BYTES, "output tile fits the halo buffers");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_w = smem + 2 * FHalo::BYTES;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tiles_x = (a.w + FM_TX - 1) / FM_TX;
  const int tx0 = (blockIdx.x % tiles_x) * FM_TX;
  const int ty0 = (blockIdx.x / tiles_x) * FM_TY;
  const int z = blockIdx.y;
  const int co0 = blockIdx.z * NT;
  const long long hw = (long long)a.h * a.w;
  const Volume vol{a.d, a.h, a.w, hw, hw * a.d};
  const bool vec = a.vec != 0;
  const unsigned char* wg = a.wpk + (size_t)blockIdx.z * a.groups * WCHUNK;

  auto load_group = [&](HaloRegs& st, int k) {
    const bool first = k < a.g0;
    const int c = 8 * (first ? k : k - a.g0);
    const int nc = min(8, (first ? a.c0 : a.c1) - c);
    const uint16_t* p = (first ? a.src0 : a.src1) + c * vol.dhw;
    tc::halo_load<FM_TY>(st, p, nc, vol, z, ty0, tx0, vec, t);
  };
  auto stage_w = [&](int k, int buf) {
    const unsigned char* src = wg + (size_t)k * WCHUNK;
    const uint32_t dst = tc::smem_u32(s_w + buf * WCHUNK);
    for (int e = t; e < WCHUNK / 16; e += FM_THREADS)
      tc::cp_async16(dst + 16 * e, src + 16 * e, true);
    tc::cp_async_commit();
  };

  float acc[4][NG][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  HaloRegs st;
  load_group(st, 0);
  stage_w(0, 0);
  tc::halo_store<FM_TY>(st, smem, t);
  tc::cp_async_wait_all();
  __syncthreads();

  // lane's ldmatrix row: voxel (row 2*warp, column mrow) of m-tile 0, tap half khalf
  const int mrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int khalf = lane >> 4;
  const uint32_t a_lane = 16u * (2 * warp * FHalo::ROW + mrow);

#pragma unroll 1
  for (int k = 0; k < a.groups; ++k) {
    const int buf = k & 1;
    const bool more = k + 1 < a.groups;
    if (more) {
      load_group(st, k + 1);
      stage_w(k + 1, buf ^ 1);
    }
    const uint32_t hb = tc::smem_u32(smem + buf * FHalo::BYTES) + a_lane;
    const uint32_t wb = tc::smem_u32(s_w + buf * WCHUNK) + 8u * lane;
#pragma unroll
    for (int s = 0; s < FM_STEPS; ++s) {
      const int t1 = 2 * s + 1 < 27 ? 2 * s + 1 : 26;
      const uint32_t toff = 16u * (khalf ? FHalo::tap(t1) : FHalo::tap(2 * s));
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        tc::ldsm_x4(af[mt], hb + toff + 16u * ((mt >> 1) * FHalo::ROW + (mt & 1) * 16));
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        uint32_t b0, b1;
        tc::lds64(b0, b1, wb + 256u * (s * NG + j));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) tc::mma_bf16(acc[mt][j], af[mt], b0, b1);
      }
    }
    if (more) tc::halo_store<FM_TY>(st, smem + (buf ^ 1) * FHalo::BYTES, t);
    tc::cp_async_wait_all();
    __syncthreads();
  }

  // accumulator (mt, j, e): voxel row 2*warp + (mt >> 1), column (mt & 1)*16 + g + 8*(e >> 1),
  // channel co0 + 8*j + 2*tq + (e & 1)
  const int g = lane >> 2, tq = lane & 3;
  auto epilogue = [&](float v, int co, long long vox) {
    if (a.accum) v += __bfloat162float(__ushort_as_bfloat16(a.accum[co * vol.dhw + vox]));
    if (a.bias) v += a.bias[co];
    v = activate(v, a.act);
    if (a.post) v = v * a.post[co] + a.post[a.cout + co];
    return v;
  };

  if (a.head) {  // uniform over the grid; the launcher guarantees cout <= NT
    float hs[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int y = ty0 + 2 * warp + (mt >> 1);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = tx0 + (mt & 1) * 16 + g + 8 * hh;
        const long long vox = (long long)z * hw + (long long)y * a.w + x;
        float s = 0.f;
        if (y < a.h && x < a.w) {
#pragma unroll
          for (int j = 0; j < NG; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int co = co0 + 8 * j + 2 * tq + e;
              if (co < a.cout) s += epilogue(acc[mt][j][2 * hh + e], co, vox) * a.head[co];
            }
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        hs[mt][hh] = s;
      }
    }
    if (tq == 0) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int y = ty0 + 2 * warp + (mt >> 1);
          const int x = tx0 + (mt & 1) * 16 + g + 8 * hh;
          if (y < a.h && x < a.w)
            static_cast<float*>(a.out)[(long long)z * hw + (long long)y * a.w + x] =
                hs[mt][hh] + a.head[a.cout];
        }
    }
    return;
  }

  uint16_t* so = reinterpret_cast<uint16_t*>(smem);  // NT x OUT_STRIDE, the halo is free now
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int vy = 2 * warp + (mt >> 1);
    const int y = ty0 + vy;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int vx = (mt & 1) * 16 + g + 8 * hh;
      const int x = tx0 + vx;
      const bool inside = y < a.h && x < a.w;
      const long long vox = (long long)z * hw + (long long)y * a.w + x;
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 8 * j + 2 * tq + e;
          float v = 0.f;
          if (inside && co0 + cl < a.cout) v = epilogue(acc[mt][j][2 * hh + e], co0 + cl, vox);
          so[cl * OUT_STRIDE + vy * FM_TX + vx] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
        }
    }
  }
  __syncthreads();
  uint16_t* out = static_cast<uint16_t*>(a.out);
  for (int q = t; q < NT * (FM_TY * FM_TX / 8); q += FM_THREADS) {
    const int cl = q / (FM_TY * FM_TX / 8), r = q % (FM_TY * FM_TX / 8);
    const int vy = r >> 2, xs = r & 3;
    const int co = co0 + cl, y = ty0 + vy, x = tx0 + 8 * xs;
    if (co >= a.cout || y >= a.h || x >= a.w) continue;
    const uint16_t* sp = so + cl * OUT_STRIDE + vy * FM_TX + 8 * xs;
    const long long off = co * vol.dhw + (long long)z * hw + (long long)y * a.w + x;
    if (vec) {
      *reinterpret_cast<uint4*>(out + off) = *reinterpret_cast<const uint4*>(sp);
    } else {
      for (int i = 0; i < 8 && x + i < a.w; ++i) out[off + i] = sp[i];
    }
  }
}

template <int NG>
int launch_fwd_mma(const FwdMmaArgs& a, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)FHalo::BYTES + 2 * (size_t)FM_STEPS * NG * 256;
  int err = (int)cudaFuncSetAttribute(conv3d_fwd_mma_kernel<NG>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int tiles = ((a.w + FM_TX - 1) / FM_TX) * ((a.h + FM_TY - 1) / FM_TY);
  const dim3 grid(tiles, a.d, (a.cout + 8 * NG - 1) / (8 * NG));
  conv3d_fwd_mma_kernel<NG><<<grid, FM_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// k16 steps per 8-channel group: the host packs the weight fragments to match.
int conv3d_fwd_mma_steps() { return FM_STEPS; }

int conv3d_fwd_mma_launch(const void* src0, int c0, const void* src1, int c1, int d, int h, int w,
                          const void* wpk, int cout, int ng, const float* bias, const void* accum,
                          const float* post, const float* head, int act, int vec, void* out,
                          void* stream) {
  const int g0 = (c0 + 7) / 8;
  const FwdMmaArgs a{static_cast<const uint16_t*>(src0), static_cast<const uint16_t*>(src1),
                     c0, c1, g0, g0 + (c1 + 7) / 8, d, h, w,
                     static_cast<const unsigned char*>(wpk), cout, bias,
                     static_cast<const uint16_t*>(accum), post, head, act, vec, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ng) {
    case 1: return launch_fwd_mma<1>(a, s);
    case 2: return launch_fwd_mma<2>(a, s);
    case 3: return launch_fwd_mma<3>(a, s);
    case 4: return launch_fwd_mma<4>(a, s);
    case 6: return launch_fwd_mma<6>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
