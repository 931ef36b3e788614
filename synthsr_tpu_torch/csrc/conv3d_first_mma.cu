// H-first-mma: the U-Net's first SAME 3x3x3 convolution (1 or 2 input
// channels, stride 1) on bf16 activations, on Hopper's tensor cores (sm_90a).
// Replaces the TPU kernel K1 (_first_kernel, synthsr_tpu/ops/conv_pallas.py:
// 569), which multiplies a 27*cin-tap patch matrix with a ones row for the
// bias by (cout, 27*cin + 1) bf16 weights into float32 sums, as mma.sync does
// here.  Float32 activations run on H-first-x3 (conv3d_first_x3.cu).  The
// launcher runs on the stream it is given, allocates nothing and returns
// cudaGetLastError() (0 = launched).
//
// Bound: bytes.  A voxel reads 2*cin bytes and writes 2*cout = 48 bytes, and
// takes 2*27*cin*cout FLOPs, far below the tensor cores' 295 FLOPs per byte,
// so the 48-byte write per voxel is the limit (0.25 ms at 256^3 on an H100
// SXM).  On the CUDA cores the 648 (cin = 2: 1296) float32 FMAs per voxel
// took longer to issue than the write takes; here they are a tiny GEMM.
//
// Design: one GEMM per block, M = output channels (at most 32: two m16
// tiles; 24 in both shipped nets), N = voxels, K = 27*cin taps in DHWIO order
// (k = tap*cin + c), then one column of ones that carries the bias (as K1's
// bias row), zero-padded to 32 (cin = 1: 2 k16 steps) or 64 (cin = 2: 4).
// - A (weights x bias) is packed once per weight set by the host in the
//   lanes' fragment order ((m-tile, step, lane) x 16 bytes, ops/conv_cf.py:
//   _first_mma_fragments); each lane loads its fragments into registers once
//   per block and writes the bias into the ones column's slot.
// - A block owns an 8 x 32 (H x W) tile of FF_NZ = 8 consecutive planes: it
//   stages their 10 input planes of the halo tile, 10 rows x 34 voxels each,
//   in shared memory once, so an input plane is loaded 10 / 8 times per tile,
//   not 3 times; nothing is carried between blocks, so no ring is needed
//   (8 planes measured faster than 1 and 2 and no slower than 4,
//   tools/ab_first_mma_variants.py).  cin = 1 stages one
//   bf16 per voxel, the interior of each halo row by 16-byte cp.async.
//   cin = 2 stages both channels of a voxel in one 32-bit word (channel 0
//   low): the two channels of a tap are the k pair of one B register, so one
//   load gathers both; 16-byte loads of each channel's row are interleaved
//   in registers by byte permutes.  `vec` (W % 8 == 0 and aligned pointers, set by the host)
//   selects the 16-byte loads, else 2-byte loads.  Zeros outside the volume
//   come by predicate, with no per-element index arithmetic.
// - B (taps x voxels) is built in registers: lane 4g + tq gathers, for voxel
//   g of an n8 tile, its k = 2tq, 2tq+1, 2tq+8, 2tq+9 of each k16 step from
//   the halo by per-lane offsets computed once (cin = 1: 4 16-bit loads per
//   step; cin = 2: 2 32-bit loads); the last step's ones column and zero
//   padding are set by two lane masks.  The halo strides are chosen so that
//   no gather has a bank conflict.  An 8-voxel x 32-channel block costs 4
//   (cin = 2: 8) mma.
// - Epilogue in float32 registers: activation (ELU as exp(x) - 1, ReLU, or
//   LeakyReLU(0.2) as v >= 0 ? v : 0.2v, as conv_pallas.py:628), the post affine, rounding to bf16 two voxels at a time.  Each warp owns
//   two rows of the tile: it stages its 24 x 2 x 32 outputs in shared memory
//   (a channel row of 132 words = 4 mod 32 keeps the stores free of bank
//   conflicts) and writes them with 16-byte stores, one tile row of one
//   channel per 4 lanes, then goes on to the next plane with no block-wide
//   barrier, so one warp's stores overlap another's mma.  Ragged tiles are
//   masked at the store.  Offsets into a volume are 64-bit.
// The 32-wide tile divides every main-path width (160, 192, 256, 512).

#include "mma_common.cuh"

namespace {

enum { ACT_NONE = 0, ACT_ELU = 1, ACT_RELU = 2, ACT_LEAKY = 3 };

constexpr int FF_TX = 32;        // tile width (W)
constexpr int FF_TY = 8;         // tile height (H)
constexpr int FF_THREADS = 128;  // 4 warps, 2 tile rows each
constexpr int FF_NZ = 8;         // consecutive planes per block
constexpr int FF_MAX_COUT = 32;  // two m16 tiles of output channels
constexpr int FF_OUT = FF_TY * FF_TX + 8;  // bf16 per channel row of the staged output tile
static_assert(FF_THREADS == 4 * 32 && FF_TY == 2 * 4, "each warp owns two tile rows");

template <int CIN>
__host__ __device__ constexpr int first_steps() { return (27 * CIN + 1 + 15) / 16; }

// The halo tile's element and strides: a row is [7] = x0 - 1, [8..39] = x0..x0+31,
// [40] = x0+32; ROW and PLANE make every gather of the mma loop free of bank conflicts.
template <int CIN>
struct FirstHalo;
template <>
struct FirstHalo<1> {
  using E = uint16_t;  // one bf16
  static constexpr int ROW = 48, PLANE = (FF_TY + 2) * ROW + 32;
};
template <>
struct FirstHalo<2> {
  using E = uint32_t;  // channel 0 | channel 1 << 16
  static constexpr int ROW = 44, PLANE = (FF_TY + 2) * ROW + 16;
};

struct FirstMmaArgs {
  const uint16_t* x;
  int d, h, w;
  const uint4* frags;  // (2 m-tiles, steps, 32 lanes) x 4 registers of 2 bf16
  int cout;
  const float* bias;
  const float* post;
  int vec;
  uint16_t* out;
};

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_ELU) return v > 0.f ? v : __expf(v) - 1.f;
  if (ACT == ACT_RELU) return fmaxf(v, 0.f);
  if (ACT == ACT_LEAKY) return v >= 0.f ? v : 0.2f * v;
  return v;
}

// 8 voxels x .. x + 7 of one channel's row `xr`, zero past w or when !ok.
__device__ __forceinline__ uint4 load8(const uint16_t* xr, int x, int w, bool ok, bool vec) {
  if (vec)
    return ok && x < w ? __ldg(reinterpret_cast<const uint4*>(xr + x)) : make_uint4(0, 0, 0, 0);
  uint32_t s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t lo = ok && x + 2 * k < w ? xr[x + 2 * k] : 0u;
    const uint32_t hi = ok && x + 2 * k + 1 < w ? xr[x + 2 * k + 1] : 0u;
    s[k] = lo | (hi << 16);
  }
  return make_uint4(s[0], s[1], s[2], s[3]);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 5 blocks per SM (at most 102 registers): measured faster than 4 and 6 at every
// main-path shape (tools/ab_first_mma_variants.py)
template <int CIN, int ACT>
__global__ void __launch_bounds__(FF_THREADS, 5) conv3d_first_mma_kernel(const FirstMmaArgs a) {
  using H = FirstHalo<CIN>;
  using E = typename H::E;
  constexpr int TAPS = 27 * CIN;  // the ones column is k = TAPS
  constexpr int STEPS = first_steps<CIN>();
  extern __shared__ __align__(128) unsigned char smem[];
  E* s_in = reinterpret_cast<E*>(smem);  // (FF_NZ + 2) x PLANE
  uint16_t* stage = reinterpret_cast<uint16_t*>(s_in + (FF_NZ + 2) * H::PLANE);  // cout x FF_OUT

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int tiles_x = (a.w + FF_TX - 1) / FF_TX;
  const int x0 = (blockIdx.x % tiles_x) * FF_TX;
  const int y0 = (blockIdx.x / tiles_x) * FF_TY;
  const int z0 = blockIdx.y * FF_NZ;
  const int nzb = min(FF_NZ, a.d - z0);
  const long long hw = (long long)a.h * a.w, dhw = hw * a.d;

  // halo: (plane zz, row yy) rows of 4 8-voxel segments and 2 edge voxels
  constexpr int items = (FF_NZ + 2) * (FF_TY + 2) * 4;
  for (int i = t; i < items; i += FF_THREADS) {
    const int seg = i & 3, r = i >> 2;
    const int yy = r % (FF_TY + 2), zz = r / (FF_TY + 2);
    const int gz = z0 - 1 + zz, gy = y0 - 1 + yy;
    const bool row_ok = gz >= 0 && gz < a.d && gy >= 0 && gy < a.h;
    const uint16_t* xr = a.x + (row_ok ? (long long)gz * hw + (long long)gy * a.w : 0ll);
    E* srow = s_in + zz * H::PLANE + yy * H::ROW;
    const int x = x0 + 8 * seg;
    const int ex = seg == 0 ? x0 - 1 : x0 + FF_TX;
    const bool edge = (seg == 0 || seg == 3) && row_ok && ex >= 0 && ex < a.w;
    E* sedge = srow + (seg == 0 ? 7 : 8 + FF_TX);
    if constexpr (CIN == 1) {
      if (a.vec) {
        const bool ok = row_ok && x < a.w;
        tc::cp_async16(tc::smem_u32(srow + 8 + 8 * seg), ok ? xr + x : a.x, ok);
      } else {
        *reinterpret_cast<uint4*>(srow + 8 + 8 * seg) = load8(xr, x, a.w, row_ok, false);
      }
      if (seg == 0 || seg == 3) *sedge = edge ? xr[ex] : 0;
    } else {
      const uint4 v0 = load8(xr, x, a.w, row_ok, a.vec);
      const uint4 v1 = load8(xr + dhw, x, a.w, row_ok, a.vec);
      uint4 o[2];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t lo = tc::word(v0, m), hi = tc::word(v1, m);
        reinterpret_cast<uint32_t*>(o)[2 * m] = __byte_perm(lo, hi, 0x5410);
        reinterpret_cast<uint32_t*>(o)[2 * m + 1] = __byte_perm(lo, hi, 0x7632);
      }
      uint4* dst = reinterpret_cast<uint4*>(srow + 8 + 8 * seg);
      dst[0] = o[0];
      dst[1] = o[1];
      if (seg == 0 || seg == 3)
        *sedge = edge ? (uint32_t)xr[ex] | ((uint32_t)xr[dhw + ex] << 16) : 0u;
    }
  }
  tc::cp_async_commit();

  // A: the packed weights, and the bias in the ones column (step TAPS / 16)
  uint32_t af[2][STEPS][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const uint4 v = __ldg(a.frags + (mt * STEPS + s) * 32 + lane);
      af[mt][s][0] = v.x;
      af[mt][s][1] = v.y;
      af[mt][s][2] = v.z;
      af[mt][s][3] = v.w;
    }
  if (a.bias) {
    constexpr int SB = TAPS / 16, KB = TAPS % 16;
    constexpr int RB = KB >= 8 ? 2 : 0, TB = (KB & 7) >> 1, EB = KB & 1;
    if (tq == TB) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int ch = 16 * mt + 8 * rh + g;
          const uint32_t b =
              ch < a.cout ? __bfloat16_as_ushort(__float2bfloat16_rn(a.bias[ch])) : 0u;
          uint32_t& r = af[mt][SB][RB + rh];
          r = EB ? (r & 0xffffu) | (b << 16) : (r & 0xffff0000u) | b;
        }
    }
  }

  // B: the halo offsets, from the voxel's tap 0, of the lane's loads: cin = 1, the taps
  // k = 16s + 2tq + (j & 1) + 8(j >> 1); cin = 2, the taps k / 2 of k = 16s + 8j + 2tq
  // (both channels at once).  Then the last step's masks for the ones column and padding.
  constexpr int LOADS = CIN == 1 ? 4 : 2;
  int off[STEPS][LOADS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int tap = CIN == 1 ? 16 * s + 2 * tq + (j & 1) + 8 * (j >> 1) : 8 * s + 4 * j + tq;
      off[s][j] = tap < 27 ? (tap / 9) * H::PLANE + (tap / 3 % 3) * H::ROW + tap % 3 : 0;
    }
  uint32_t keep[2] = {0u, 0u}, ones[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 16 * (STEPS - 1) + 8 * j + 2 * tq + e;
      if (k < TAPS) keep[j] |= 0xffffu << (16 * e);
      if (k == TAPS) ones[j] |= 0x3f80u << (16 * e);  // bf16 1.0
    }

  // post affine of the lane's channels 16mt + 8rh + g
  float ps[2][2], pb[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int ch = 16 * mt + 8 * rh + g;
      const bool p = a.post && ch < a.cout;
      ps[mt][rh] = p ? a.post[ch] : 1.f;
      pb[mt][rh] = p ? a.post[a.cout + ch] : 0.f;
    }

  tc::cp_async_wait_all();
  __syncthreads();

  uint16_t* const outp = a.out;
#pragma unroll 1
  for (int zl = 0; zl < nzb; ++zl) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int yl = 2 * warp + rr;
#pragma unroll
      for (int nt = 0; nt < FF_TX / 8; ++nt) {
        const int xl = 8 * nt;
        const E* vb = s_in + zl * H::PLANE + yl * H::ROW + 7 + xl + g;
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
          uint32_t b0, b1;
          if constexpr (CIN == 1) {
            b0 = (uint32_t)vb[off[s][0]] | ((uint32_t)vb[off[s][1]] << 16);
            b1 = (uint32_t)vb[off[s][2]] | ((uint32_t)vb[off[s][3]] << 16);
          } else {
            b0 = vb[off[s][0]];
            b1 = vb[off[s][1]];
          }
          if (s == STEPS - 1) {
            b0 = (b0 & keep[0]) | ones[0];
            b1 = (b1 & keep[1]) | ones[1];
          }
          tc::mma_bf16(acc[0], af[0][s], b0, b1);
          tc::mma_bf16(acc[1], af[1][s], b0, b1);
        }
        // acc[mt][2rh + e]: channel 16mt + 8rh + g, voxel xl + 2tq + e of row yl
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int ch = 16 * mt + 8 * rh + g;
            if (ch >= a.cout) continue;
            const float v0 = fmaf(activate<ACT>(acc[mt][2 * rh]), ps[mt][rh], pb[mt][rh]);
            const float v1 = fmaf(activate<ACT>(acc[mt][2 * rh + 1]), ps[mt][rh], pb[mt][rh]);
            *reinterpret_cast<uint32_t*>(stage + ch * FF_OUT + yl * FF_TX + xl + 2 * tq) =
                pack_bf16x2(v0, v1);
          }
      }
    }
    __syncwarp();
    const long long zoff = (long long)(z0 + zl) * hw;
    if (a.vec) {  // the warp's two rows of 4 channels per step: 4 lanes of 16 bytes per row
      for (int q = lane; q < a.cout * 8; q += 32) {
        const int ch = q >> 3, yl = 2 * warp + ((q >> 2) & 1), xs = q & 3;
        const int y = y0 + yl, x = x0 + 8 * xs;
        if (y >= a.h || x >= a.w) continue;
        *reinterpret_cast<uint4*>(outp + ch * dhw + zoff + (long long)y * a.w + x) =
            *reinterpret_cast<const uint4*>(stage + ch * FF_OUT + yl * FF_TX + 8 * xs);
      }
    } else {  // 2-byte stores, one tile row of one channel per step
      for (int q = lane; q < a.cout * 2 * FF_TX; q += 32) {
        const int ch = q >> 6, yl = 2 * warp + ((q >> 5) & 1), xl = q & 31;
        const int y = y0 + yl, x = x0 + xl;
        if (y < a.h && x < a.w)
          outp[ch * dhw + zoff + (long long)y * a.w + x] = stage[ch * FF_OUT + yl * FF_TX + xl];
      }
    }
    __syncwarp();
  }
}

template <int CIN, int ACT>
int launch_first_mma(const FirstMmaArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(typename FirstHalo<CIN>::E) * (FF_NZ + 2) * FirstHalo<CIN>::PLANE +
                      2 * (size_t)a.cout * FF_OUT;
  int err = (int)cudaFuncSetAttribute(conv3d_first_mma_kernel<CIN, ACT>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int tiles = ((a.w + FF_TX - 1) / FF_TX) * ((a.h + FF_TY - 1) / FF_TY);
  const dim3 grid(tiles, (a.d + FF_NZ - 1) / FF_NZ);
  conv3d_first_mma_kernel<CIN, ACT><<<grid, FF_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int CIN>
int launch_first_mma_act(const FirstMmaArgs& a, int act, cudaStream_t stream) {
  switch (act) {
    case ACT_NONE: return launch_first_mma<CIN, ACT_NONE>(a, stream);
    case ACT_ELU: return launch_first_mma<CIN, ACT_ELU>(a, stream);
    case ACT_RELU: return launch_first_mma<CIN, ACT_RELU>(a, stream);
    case ACT_LEAKY: return launch_first_mma<CIN, ACT_LEAKY>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K padded to k16 steps (32 for cin = 1, 64 for cin = 2), and the most output
// channels: the host packs the A fragments to match.
int conv3d_first_mma_kpad(int cin) {
  return cin == 1 ? 16 * first_steps<1>() : cin == 2 ? 16 * first_steps<2>() : 0;
}

int conv3d_first_mma_max_cout() { return FF_MAX_COUT; }

int conv3d_first_mma_launch(const void* x, int cin, int d, int h, int w, const void* frags,
                            int cout, const float* bias, const float* post, int act, int vec,
                            void* out, void* stream) {
  if (cout < 1 || cout > FF_MAX_COUT) return (int)cudaErrorInvalidValue;
  const FirstMmaArgs a{static_cast<const uint16_t*>(x), d, h, w,
                       static_cast<const uint4*>(frags), cout, bias, post, vec,
                       static_cast<uint16_t*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 1) return launch_first_mma_act<1>(a, act, s);
  if (cin == 2) return launch_first_mma_act<2>(a, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
