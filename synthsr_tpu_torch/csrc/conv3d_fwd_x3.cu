// H-fwd-x3: the channels-first SAME 3x3x3 convolution (stride 1) on float32
// activations, on Hopper's tensor cores (sm_90a) at float32 accuracy by
// split TF32 (mma_common.cuh).  Replaces the TPU kernels K2 (_plane_kernel,
// synthsr_tpu/ops/conv_pallas.py:270), K3 (conv3d_cf_grouped :920), K4
// (_flat_kernel :1297) and K5 (_kernel :127) on the float32 path, whose
// products and sums are float32.  bf16 activations run on H-fwd-mma
// (conv3d_fwd_mma.cu).  The launcher runs on the stream it is given,
// allocates nothing and returns cudaGetLastError() (0 = launched).
//
// Bound: 2*27*C_in FLOPs per output value against 4 bytes per input value,
// so operations bound at every U-Net width.  Float32-accurate work takes
// three TF32 products, so the card's ceiling is 495 / 3 = 165 TFLOP/s (dense
// TF32 on an H100 SXM), 2.5x the CUDA cores' 67 TFLOP/s float32 FMA rate;
// mma.sync reaches a part of it, wgmma the rest.
//
// Design: implicit GEMM, tiled as H-fwd-mma.  A block owns one output plane
// z, an 8 x 32 (H x W) tile of it (M = 256 voxels) and NT = 8*NG output
// channels (NG n8 tiles, all held by every warp).  8 warps own one row each,
// 2 m16 tiles: the partial sums below double the accumulators, and 4 warps
// of 4 m16 tiles took 234 registers a thread at NG = 3, two blocks of 4
// warps an SM.  K = 27 taps x input channels, walked in 8-channel groups of
// one source each ([skip, up] are never concatenated in memory; each source
// is padded to a multiple of 8 channels by zero fill), and within a group in
// three stages, one per dz, of 9 m16n8k8 steps: one step is one tap of the
// group's 8 channels.
//
// - A (activations) is staged channels-first, as the volume lies: one stage
//   holds the (8 channels, 10 rows, 34 voxels) slab of input plane z - 1 + dz,
//   copied by cp.async (16 bytes where W % 4 == 0 and the pointers are
//   aligned, else 4), zero-filled outside the volume and beyond the source's
//   channels.  In float32 a dx = +-1 tap is a 4-byte shift that a scalar
//   ld.shared addresses freely, so no channels-last transpose (the bf16
//   kernels' register staging) is needed.  Lane 4g + tq reads (voxel g,
//   channel tq) of the fragment; a channel's slab is FX_CH = 408 words,
//   24 mod 32, so the 32 lanes hit 32 distinct banks.  The lane splits each
//   value into big and small right after the load; each A fragment then
//   serves all NG n8 tiles.
// - B (weights) is split on the host, once per weight set
//   (ops/conv_cf.py:_x3_fragments): per (group, tap, n8 tile) each lane holds
//   (big b0, big b1, small b0, small b1), read with one conflict-free
//   ld.shared.v4.  A stage's 9 taps are 9*NG*512 bytes.
// - Products: per step small_a*big_b over the NG n8 tiles, then
//   big_a*small_b, then big_a*big_b (each pass NG independent mma), chained
//   on the tensor cores into a partial sum of the stage (27 mma a sum), which
//   is then added to the float32 sums by a rounding add: the tensor cores'
//   own accumulation truncates (mma_common.cuh), and one chain over all of K
//   drifts past the float32 bound at 72 input channels.  The partials double
//   the accumulator registers, 16*NG a thread.
// - Staging is double-buffered: stage s + 1 is in flight while the tensor
//   cores run stage s.  Shared memory: 2 x (13,056 + 4,608*NG) bytes, 35-63 KB,
//   so 3-6 blocks fit on an SM (227 KB) at NG = 4..1; registers (at most 128
//   a thread) hold two.  A stage of one dz
//   plane (and not all three) is what keeps it there: the three-plane halo
//   of one group and its 27 taps' split weights would take 38.7 + 13.8*NG KB
//   a buffer, one block an SM at NG = 3.
//
// Epilogue, in registers, as H-fwd-mma's: + accum, + bias, ELU as exp(x) - 1
// / ReLU / LeakyReLU(0.2), the post affine; then either the folded 1x1x1 head
// (summed over the thread's channels and the quad by shuffles) stored as
// (1, D, H, W) float32, or the tile staged through shared memory so the
// channels-first stores are 16-byte and coalesced.  Ragged tiles are masked
// at the store; offsets into a volume are 64-bit.

#include "mma_common.cuh"

namespace {

using tc::Volume;

enum { ACT_NONE = 0, ACT_ELU = 1, ACT_RELU = 2, ACT_LEAKY = 3 };

constexpr int FX_TY = 8;
constexpr int FX_TX = 32;
constexpr int FX_THREADS = 256;
constexpr int FX_ROW = 40;  // floats per halo row: [3] = x0 - 1, [4..35] = x0..x0+31, [36] = x0+32
constexpr int FX_CH = 408;  // floats per channel of a stage: 10 rows, padded to 24 mod 32
constexpr int FX_HALO = 8 * FX_CH * 4;          // bytes of a stage's activations
constexpr int OUT_STRIDE = FX_TY * FX_TX + 4;   // floats per channel row of the staged output
static_assert(FX_CH >= (FX_TY + 2) * FX_ROW && FX_CH % 32 == 24 && FX_CH % 4 == 0,
              "conflict-free, 16-byte aligned channel slabs");

template <int NG>
__host__ __device__ constexpr int stage_bytes() { return FX_HALO + 9 * NG * 32 * 16; }

struct FwdX3Args {
  const float* src0;
  const float* src1;
  int c0, c1;      // channels of each source
  int g0, groups;  // 8-channel groups of source 0, of both
  int d, h, w;
  const float4* wpk;  // (n_tiles, groups, 27, NG, 32 lanes) x (big b0, big b1, small b0, small b1)
  int cout;
  const float* bias;
  const float* accum;
  const float* post;
  const float* head;
  int act, vec;
  float* out;
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_ELU) return v > 0.f ? v : expf(v) - 1.f;
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_LEAKY) return v >= 0.f ? v : 0.2f * v;
  return v;
}

template <int NG>
__global__ void __launch_bounds__(FX_THREADS, 2) conv3d_fwd_x3_kernel(const FwdX3Args a) {
  constexpr int NT = 8 * NG;
  constexpr int SBYTES = stage_bytes<NG>();
  static_assert(NT * OUT_STRIDE * 4 <= 2 * SBYTES, "output tile fits the stage buffers");
  extern __shared__ __align__(128) unsigned char smem[];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tiles_x = (a.w + FX_TX - 1) / FX_TX;
  const int tx0 = (blockIdx.x % tiles_x) * FX_TX;
  const int ty0 = (blockIdx.x / tiles_x) * FX_TY;
  const int z = blockIdx.y;
  const int co0 = blockIdx.z * NT;
  const long long hw = (long long)a.h * a.w;
  const Volume vol{a.d, a.h, a.w, hw, hw * a.d};
  const bool vec = a.vec != 0;
  const float4* wg = a.wpk + (size_t)blockIdx.z * a.groups * 27 * NG * 32;
  const int n_stages = 3 * a.groups;

  // stage s = (group s / 3, dz = s % 3) into buffer `buf`, one commit group
  auto issue = [&](int s, int buf) {
    const int k = s / 3, dz = s % 3;
    const bool first = k < a.g0;
    const int c = 8 * (first ? k : k - a.g0);
    const int nc = min(8, (first ? a.c0 : a.c1) - c);
    const float* p = (first ? a.src0 : a.src1) + c * vol.dhw;
    const uint32_t hs = tc::smem_u32(smem + buf * SBYTES);
    const int gz = z - 1 + dz;
    const bool z_ok = gz >= 0 && gz < a.d;
    if (vec) {  // per (channel, row): 8 segments of 4 voxels, then the two edge voxels
      for (int e = t; e < 8 * (FX_TY + 2) * 10; e += FX_THREADS) {
        const int seg = e % 10, row = (e / 10) % (FX_TY + 2), ch = e / (10 * (FX_TY + 2));
        const int gy = ty0 - 1 + row;
        const bool ok = z_ok && ch < nc && gy >= 0 && gy < a.h;
        const float* rp = p + ch * vol.dhw + (long long)gz * hw + (long long)gy * a.w;
        const uint32_t dst = hs + 4u * (ch * FX_CH + row * FX_ROW);
        if (seg < 8) {
          const int x = tx0 + 4 * seg;
          const bool in = ok && x < a.w;
          tc::cp_async16(dst + 16u * (1 + seg), in ? rp + x : a.src0, in);
        } else {
          const int x = seg == 8 ? tx0 - 1 : tx0 + FX_TX;
          const bool in = ok && x >= 0 && x < a.w;
          tc::cp_async4(dst + 4u * (seg == 8 ? 3 : 4 + FX_TX), in ? rp + x : a.src0, in);
        }
      }
    } else {
      for (int e = t; e < 8 * (FX_TY + 2) * (FX_TX + 2); e += FX_THREADS) {
        const int xi = e % (FX_TX + 2), row = (e / (FX_TX + 2)) % (FX_TY + 2);
        const int ch = e / ((FX_TX + 2) * (FX_TY + 2));
        const int gy = ty0 - 1 + row, x = tx0 - 1 + xi;
        const bool in = z_ok && ch < nc && gy >= 0 && gy < a.h && x >= 0 && x < a.w;
        const float* src = in ? p + ch * vol.dhw + (long long)gz * hw + (long long)gy * a.w + x
                              : a.src0;
        tc::cp_async4(hs + 4u * (ch * FX_CH + row * FX_ROW + 3 + xi), src, in);
      }
    }
    const float4* ws = wg + ((size_t)k * 27 + 9 * dz) * NG * 32;
    for (int e = t; e < 9 * NG * 32; e += FX_THREADS)
      tc::cp_async16(hs + FX_HALO + 16u * e, ws + e, true);
    tc::cp_async_commit();
  };

  float acc[2][NG][4], part[2][NG][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  const int g = lane >> 2, tq = lane & 3;
  // the lane's A element at tap (dz, 0, 0): channel tq, voxel (row warp, column g) of
  // m-tile 0, i.e. halo row warp + dy, index 3 + column + dx
  const int a_lane = tq * FX_CH + warp * FX_ROW + 3 + g;

  issue(0, 0);
#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_stages) {
      issue(s + 1, buf ^ 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const float* hs = reinterpret_cast<const float*>(smem + buf * SBYTES) + a_lane;
    const float4* ws = reinterpret_cast<const float4*>(smem + buf * SBYTES + FX_HALO) + lane;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;
#pragma unroll
    for (int p = 0; p < 9; ++p) {  // tap (dz, p / 3, p % 3)
      uint32_t bb[NG][2], bs[NG][2];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const float4 v = ws[(p * NG + j) * 32];
        bb[j][0] = __float_as_uint(v.x);
        bb[j][1] = __float_as_uint(v.y);
        bs[j][0] = __float_as_uint(v.z);
        bs[j][1] = __float_as_uint(v.w);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* q = hs + (p / 3) * FX_ROW + p % 3 + mt * 16;
        const float av[4] = {q[0], q[8], q[4 * FX_CH], q[4 * FX_CH + 8]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tc::split_tf32(av[e], ab[e], as[e]);
#pragma unroll
        for (int j = 0; j < NG; ++j) tc::mma_tf32(part[mt][j], as, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < NG; ++j) tc::mma_tf32(part[mt][j], ab, bs[j][0], bs[j][1]);
#pragma unroll
        for (int j = 0; j < NG; ++j) tc::mma_tf32(part[mt][j], ab, bb[j][0], bb[j][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
    __syncthreads();
  }

  // accumulator (mt, j, e): voxel row warp, column mt*16 + g + 8*(e >> 1),
  // channel co0 + 8*j + 2*tq + (e & 1)
  auto epilogue = [&](float v, int co, long long vox) {
    if (a.accum) v += a.accum[co * vol.dhw + vox];
    if (a.bias) v += a.bias[co];
    v = activate(v, a.act);
    if (a.post) v = v * a.post[co] + a.post[a.cout + co];
    return v;
  };

  if (a.head) {  // uniform over the grid; the launcher guarantees cout <= NT
    float hsum[2][2];
    const int y = ty0 + warp;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int x = tx0 + mt * 16 + g + 8 * hh;
        const long long vox = (long long)z * hw + (long long)y * a.w + x;
        float sum = 0.f;
        if (y < a.h && x < a.w) {
#pragma unroll
          for (int j = 0; j < NG; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int co = co0 + 8 * j + 2 * tq + e;
              if (co < a.cout) sum += epilogue(acc[mt][j][2 * hh + e], co, vox) * a.head[co];
            }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        hsum[mt][hh] = sum;
      }
    }
    if (tq == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = tx0 + mt * 16 + g + 8 * hh;
          if (y < a.h && x < a.w)
            a.out[(long long)z * hw + (long long)y * a.w + x] = hsum[mt][hh] + a.head[a.cout];
        }
    }
    return;
  }

  float* so = reinterpret_cast<float*>(smem);  // NT x OUT_STRIDE; the stages are free now
  const int vy = warp;
  const int y = ty0 + vy;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int vx = mt * 16 + g + 8 * hh;
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
          so[cl * OUT_STRIDE + vy * FX_TX + vx] = v;
        }
    }
  }
  __syncthreads();
  for (int q = t; q < NT * (FX_TY * FX_TX / 4); q += FX_THREADS) {
    const int cl = q / (FX_TY * FX_TX / 4), r = q % (FX_TY * FX_TX / 4);
    const int vy = r >> 3, xs = r & 7;
    const int co = co0 + cl, y = ty0 + vy, x = tx0 + 4 * xs;
    if (co >= a.cout || y >= a.h || x >= a.w) continue;
    const float* sp = so + cl * OUT_STRIDE + vy * FX_TX + 4 * xs;
    const long long off = co * vol.dhw + (long long)z * hw + (long long)y * a.w + x;
    if (vec) {
      *reinterpret_cast<float4*>(a.out + off) = *reinterpret_cast<const float4*>(sp);
    } else {
      for (int i = 0; i < 4 && x + i < a.w; ++i) a.out[off + i] = sp[i];
    }
  }
}

template <int NG>
int launch_fwd_x3(const FwdX3Args& a, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)stage_bytes<NG>();
  int err = (int)cudaFuncSetAttribute(conv3d_fwd_x3_kernel<NG>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int tiles = ((a.w + FX_TX - 1) / FX_TX) * ((a.h + FX_TY - 1) / FX_TY);
  const dim3 grid(tiles, a.d, (a.cout + 8 * NG - 1) / (8 * NG));
  conv3d_fwd_x3_kernel<NG><<<grid, FX_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int conv3d_fwd_x3_launch(const void* src0, int c0, const void* src1, int c1, int d, int h, int w,
                         const void* wpk, int cout, int ng, const float* bias, const void* accum,
                         const float* post, const float* head, int act, int vec, void* out,
                         void* stream) {
  const int g0 = (c0 + 7) / 8;
  const FwdX3Args a{static_cast<const float*>(src0), static_cast<const float*>(src1), c0, c1,
                    g0, g0 + (c1 + 7) / 8, d, h, w, static_cast<const float4*>(wpk), cout, bias,
                    static_cast<const float*>(accum), post, head, act, vec,
                    static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ng) {
    case 1: return launch_fwd_x3<1>(a, s);
    case 2: return launch_fwd_x3<2>(a, s);
    case 3: return launch_fwd_x3<3>(a, s);
    case 4: return launch_fwd_x3<4>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
