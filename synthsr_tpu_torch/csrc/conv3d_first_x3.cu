// H-first-x3: the U-Net's first SAME 3x3x3 convolution (1 or 2 input
// channels, stride 1) on float32 activations, on Hopper's tensor cores
// (sm_90a) at float32 accuracy by split TF32 (mma_common.cuh).  Replaces the
// TPU kernel K1 (_first_kernel, synthsr_tpu/ops/conv_pallas.py:569, reached
// through conv3d_cf_planes :756) on the float32 path: a 27*cin-tap patch
// times (cout, 27*cin) weights into float32 sums, then the bias, the
// activation and the post affine.  bf16 activations run on H-first-mma
// (conv3d_first_mma.cu), whose tiling this kernel keeps.  The launcher runs on
// the stream it is given, allocates nothing and returns cudaGetLastError()
// (0 = launched).
//
// Bound: bytes.  A voxel reads 4*cin bytes and writes 4*cout = 96 (cout 24)
// to 128 bytes; its 2*27*cin*cout FLOPs, three TF32 products each, sit below
// the tensor cores' rate per byte, so the float32 write is the limit (0.063 ms
// at 128^3, 1 -> 24, on an H100 SXM).  The CUDA-core kernel this replaces
// issued 648 FMAs and 162 weight broadcasts per voxel one thread at a time,
// as long as the write takes.  Here the products are a small GEMM per tile,
// but split TF32 triples them, and mma.sync's TF32 rate on this card puts
// them near the write's time (at cin = 2 they add their time to the halo's
// and the stores' instead of hiding under it): the design spends as few as
// it can.
//
// Design: one GEMM per 16-voxel run on mma.sync.m16n8k8 (tf32 in, f32 sums):
// M = 16 voxels of a tile row, N = the output channels in n8 tiles (NT =
// ceil(cout / 8): 24 channels take three; with the channels as M, as
// H-first-mma has them, two m16 tiles pad 24 to 32 and take a third more mma,
// which this kernel's time follows: see the tool's plain-TF32 ablation), K =
// the 27*cin taps in k8 steps (cin = 1: 4 steps, K = 32; cin = 2: 7 steps, K =
// 56), zero-padded.  Column k = 8s + kk of step s is tap TPS*s + kk % TPS,
// channel kk / TPS (TPS = 8 / cin taps a step).  Products: per step
// small_a*big_b, big_a*small_b, then big_a*big_b (split TF32), chained on the
// tensor cores over all of K: 12 (cin = 1) or 21 (cin = 2) mma a sum, shorter
// than the 27-mma stages that H-fwd-x3 flushes, so the sums need no rounding
// flush.  The bias is a float32 add in the epilogue, once per output.
// - B (weights) is packed and split once per weight set by the host in the
//   lanes' fragment order ((n8 tile, step, lane) x 16 bytes,
//   ops/conv_cf.py:_first_x3_fragments); each lane holds its big and small
//   fragments in registers for the whole block.
// - A (activations) is gathered from the halo, which is split once, as it is
//   staged.  A block owns an 8 x 32 (H x W) tile of nz consecutive planes
//   (nz <= 8, chosen by the host from the grid size: conv_cf.first_x3_planes)
//   and stages their nz + 2 input planes, 10 rows x 34 voxels each, in shared
//   memory, each voxel as its big and small parts: cin = 1 an 8-byte slot
//   (big, small); cin = 2 a 16-byte slot (big c0, big c1, small c0, small c1),
//   so a lane's a0 and a2 are the two channels of one tap.  Row r of the m16
//   tile is voxel 2r (r < 8) or 2(r - 8) + 1 of the run, so a lane's a0 / a1
//   and its sums d0 / d2 are two neighbouring voxels: the gathers are
//   ld.shared.v2 (cin = 1: four a step) or ld.shared.v4 (cin = 2: two a step)
//   with no cvt, and the epilogue writes 8 bytes per channel.  Every global
//   load of a thread is issued before the first is split, so a block waits
//   for memory once: 16-byte __ldg of 4 voxels when `vec` (W % 4 == 0 and
//   aligned pointers, set by the host), else 4-byte loads; zeros outside the
//   volume come by predicate.  ROW and PLANE make every gather free of bank
//   conflicts (8-byte slots: distinct slots mod 16 per half-warp; 16-byte
//   slots: mod 8 per quarter-warp; the padding taps k >= 27*cin read tap 26's
//   slot, which B multiplies by zero).
// - Warp w owns rows 2w and 2w + 1 of the tile, one m16 run after the other
//   (NT independent mma chains each; the sums of two runs at once do not fit
//   beside B's registers at three blocks an SM).
// - Epilogue in float32 registers: + bias, ELU as __expf(x) - 1 (ex2.approx:
//   a few 1e-7 absolute where x <= 0; expf costs more than a tenth of the
//   kernel's time, tools/ab_first_x3_variants.py), ReLU or LeakyReLU(0.2) as
//   v >= 0 ? v : 0.2v (conv_pallas.py:628), the post affine.  At cin = 1 with
//   `vec` each lane writes its two neighbouring voxels of each channel
//   straight from registers, 8 bytes (64 contiguous bytes of a channel row per
//   8 lanes): staging them in shared memory for 16-byte stores, as
//   H-first-mma does, cost a tenth more time at 128^3 (the same tool).  At
//   cin = 2, where staging measured faster, and without `vec`, each warp stages
//   its cout x 2 x 32 outputs in shared memory (a channel row of 260 words = 4
//   mod 32 keeps the 8-byte writes free of bank conflicts) and writes them
//   with 16-byte stores, 32 voxels of one channel row per 8 lanes (without
//   `vec`: 4-byte stores, a channel row per 32 lanes).  No block-wide barrier
//   follows the halo's, so one warp's stores overlap another's mma.  Ragged
//   tiles are masked at the store; offsets into a volume are 64-bit.

#include "mma_common.cuh"

namespace {

enum { ACT_NONE = 0, ACT_ELU = 1, ACT_RELU = 2, ACT_LEAKY = 3 };

constexpr int X1_TX = 32;          // tile width (W)
constexpr int X1_TY = 8;           // tile height (H)
constexpr int X1_THREADS = 128;    // 4 warps, 2 tile rows each
constexpr int X1_MAX_NZ = 8;       // planes per block, at most
constexpr int X1_MAX_COUT = 32;    // four n8 tiles of output channels
// Whether the outputs go through shared memory (then 16-byte stores, or 4-byte
// ones unless vec) or straight from the mma's registers (8 bytes of two
// neighbouring voxels a lane): straight where vec at cin = 1, where the stores
// compete with the least tensor work
template <int CIN>
__host__ __device__ constexpr bool x3_staged(bool vec) { return CIN == 2 || !vec; }
constexpr int X1_OUT = X1_TY * X1_TX + 4;  // floats per channel row of the staged output tile
static_assert(X1_THREADS == 4 * 32 && X1_TY == 2 * 4, "each warp owns two tile rows");
static_assert(X1_OUT % 32 == 4, "conflict-free 8-byte writes, 16-byte aligned rows");

template <int CIN>
__host__ __device__ constexpr int x3_steps() { return (27 * CIN + 7) / 8; }

// The split halo tile: slot [X0 - 1] of a row is x0 - 1, [X0 .. X0 + 31] are
// x0 .. x0 + 31, [X0 + 32] is x0 + 32; ROW and PLANE (in slots) keep the
// gathers free of bank conflicts.
template <int CIN>
struct X3Halo;
template <>
struct X3Halo<1> {
  using E = float2;  // (big, small)
  static constexpr int X0 = 1, ROW = 41, PLANE = 411;
};
template <>
struct X3Halo<2> {
  using E = float4;  // (big c0, big c1, small c0, small c1)
  static constexpr int X0 = 1, ROW = 37, PLANE = 375;
};

// Bytes of the halo of nz planes, rounded up so that the staged output after it
// is 16-byte aligned
template <int CIN>
__host__ __device__ constexpr int halo_bytes(int nz) {
  return ((nz + 2) * X3Halo<CIN>::PLANE * (int)sizeof(typename X3Halo<CIN>::E) + 15) / 16 * 16;
}

struct FirstX3Args {
  const float* x;
  int d, h, w, nz;
  const float4* frags;  // (NT n8 tiles, steps, 32 lanes) x (big b0, big b1, small b0, small b1)
  int cout;
  const float* bias;
  const float* post;
  int vec;
  float* out;
};

__device__ __forceinline__ float4 load4(const float* xr, int x, int w, bool ok, bool vec) {
  if (vec) return ok && x < w ? __ldg(reinterpret_cast<const float4*>(xr + x)) : float4{};
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = ok && x + i < w ? __ldg(xr + x + i) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float2 split2(float v) {
  uint32_t big, small;
  tc::split_tf32(v, big, small);
  return make_float2(__uint_as_float(big), __uint_as_float(small));
}

// The split slot of one voxel: channel 0's value v0 and (cin = 2) channel 1's v1.
template <int CIN>
__device__ __forceinline__ typename X3Halo<CIN>::E split_slot(float v0, float v1) {
  if constexpr (CIN == 1) {
    return split2(v0);
  } else {
    const float2 p = split2(v0), q = split2(v1);
    return make_float4(p.x, q.x, p.y, q.y);
  }
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_ELU) return v > 0.f ? v : __expf(v) - 1.f;
  if (ACT == ACT_RELU) return fmaxf(v, 0.f);
  if (ACT == ACT_LEAKY) return v >= 0.f ? v : 0.2f * v;
  return v;
}

// Halo items per thread, at most: (planes, rows) x (8 segments + 1 for the edges)
constexpr int X1_ITEMS = ((X1_MAX_NZ + 2) * (X1_TY + 2) * 9 + X1_THREADS - 1) / X1_THREADS;

// __launch_bounds__(128, 3): three blocks fill the shared memory at cin = 1;
// cin = 2 with 32 channels holds 112 registers of B and gets two
template <int CIN, int NT, int ACT>
__global__ void __launch_bounds__(X1_THREADS, CIN == 2 && NT == 4 ? 2 : 3)
    conv3d_first_x3_kernel(const FirstX3Args a) {
  using H = X3Halo<CIN>;
  using E = typename H::E;
  constexpr int STEPS = x3_steps<CIN>();
  constexpr int TPS = 8 / CIN;             // taps per k8 step
  constexpr int LOADS = CIN == 1 ? 2 : 1;  // halo taps per lane and step
  extern __shared__ __align__(16) unsigned char smem[];
  E* s_in = reinterpret_cast<E*>(smem);                                   // (nz + 2) x PLANE
  float* stage = reinterpret_cast<float*>(smem + halo_bytes<CIN>(a.nz));  // cout x X1_OUT

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int tiles_x = (a.w + X1_TX - 1) / X1_TX;
  const int x0 = (blockIdx.x % tiles_x) * X1_TX;
  const int y0 = (blockIdx.x / tiles_x) * X1_TY;
  const int z0 = blockIdx.y * a.nz;
  const int nzb = min(a.nz, a.d - z0);
  const long long hw = (long long)a.h * a.w, dhw = hw * a.d;
  const bool vec = a.vec != 0;
  const bool staged = x3_staged<CIN>(vec);

  // halo: per (plane zz, row yy) 8 segments of 4 voxels and one item for the two
  // edge voxels (.x left, .y right); every load of the thread is issued before
  // the first is split and stored
  const int items = (nzb + 2) * (X1_TY + 2) * 9;
  float4 v0[X1_ITEMS], v1[X1_ITEMS];
#pragma unroll
  for (int k = 0; k < X1_ITEMS; ++k) {
    const int i = t + k * X1_THREADS;
    v0[k] = v1[k] = float4{};
    if (i >= items) continue;
    const int seg = i % 9, r = i / 9;
    const int yy = r % (X1_TY + 2), zz = r / (X1_TY + 2);
    const int gz = z0 - 1 + zz, gy = y0 - 1 + yy;
    const bool row_ok = gz >= 0 && gz < a.d && gy >= 0 && gy < a.h;
    const float* xr = a.x + (row_ok ? (long long)gz * hw + (long long)gy * a.w : 0ll);
    if (seg < 8) {
      v0[k] = load4(xr, x0 + 4 * seg, a.w, row_ok, vec);
      if (CIN == 2) v1[k] = load4(xr + dhw, x0 + 4 * seg, a.w, row_ok, vec);
    } else {
      const bool lo = row_ok && x0 > 0, hi = row_ok && x0 + X1_TX < a.w;
      v0[k].x = lo ? __ldg(xr + x0 - 1) : 0.f;
      v0[k].y = hi ? __ldg(xr + x0 + X1_TX) : 0.f;
      if (CIN == 2) {
        v1[k].x = lo ? __ldg(xr + dhw + x0 - 1) : 0.f;
        v1[k].y = hi ? __ldg(xr + dhw + x0 + X1_TX) : 0.f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < X1_ITEMS; ++k) {
    const int i = t + k * X1_THREADS;
    if (i >= items) continue;
    const int seg = i % 9, r = i / 9;
    E* srow = s_in + (r / (X1_TY + 2)) * H::PLANE + (r % (X1_TY + 2)) * H::ROW;
    if (seg < 8) {
      E* dst = srow + H::X0 + 4 * seg;
      dst[0] = split_slot<CIN>(v0[k].x, v1[k].x);
      dst[1] = split_slot<CIN>(v0[k].y, v1[k].y);
      dst[2] = split_slot<CIN>(v0[k].z, v1[k].z);
      dst[3] = split_slot<CIN>(v0[k].w, v1[k].w);
    } else {
      srow[H::X0 - 1] = split_slot<CIN>(v0[k].x, v1[k].x);
      srow[H::X0 + X1_TX] = split_slot<CIN>(v0[k].y, v1[k].y);
    }
  }

  // B: the split weight fragments, (big, small) of b0 = (k tq, n g) and
  // b1 = (k tq + 4, n g) per n8 tile and step
  uint32_t bb[NT][STEPS][2], bs[NT][STEPS][2];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const float4 f = __ldg(a.frags + (jn * STEPS + s) * 32 + lane);
      bb[jn][s][0] = __float_as_uint(f.x);
      bb[jn][s][1] = __float_as_uint(f.y);
      bs[jn][s][0] = __float_as_uint(f.z);
      bs[jn][s][1] = __float_as_uint(f.w);
    }

  // A: the halo offsets, from the run's voxel 2g at tap 0, of the lane's
  // gathers: tap TPS*s + tq (+ 4 for cin = 1's a2, a3); padding taps read tap 26
  int off[STEPS][LOADS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int tap = min(TPS * s + tq + 4 * j, 26);
      off[s][j] = (tap / 9) * H::PLANE + (tap / 3 % 3) * H::ROW + tap % 3;
    }

  // bias and post affine of the lane's channels 8jn + 2tq + c
  float bv[NT][2], ps[NT][2], pb[NT][2];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int ch = 8 * jn + 2 * tq + c;
      const bool in = ch < a.cout;
      bv[jn][c] = a.bias && in ? a.bias[ch] : 0.f;
      ps[jn][c] = a.post && in ? a.post[ch] : 1.f;
      pb[jn][c] = a.post && in ? a.post[a.cout + ch] : 0.f;
    }

  __syncthreads();

#pragma unroll 1
  for (int zl = 0; zl < nzb; ++zl) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int yl = 2 * warp + rr;
#pragma unroll
      for (int run = 0; run < 2; ++run) {
        // voxels 16 run .. of row yl; the lane's rows g and g + 8 are voxels 2g and
        // 2g + 1 of the run
        const E* va = s_in + zl * H::PLANE + yl * H::ROW + H::X0 - 1 + 16 * run + 2 * g;
        float acc[NT][4];
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
          // (big, small) of a0 = (voxel 2g, k tq), a1 = (2g + 1, tq), a2 = (2g, tq + 4),
          // a3 = (2g + 1, tq + 4)
          uint32_t ab[4], as[4];
          if constexpr (CIN == 1) {
            const float2 p0 = va[off[s][0]], p1 = va[1 + off[s][0]];
            const float2 p2 = va[off[s][1]], p3 = va[1 + off[s][1]];
            ab[0] = __float_as_uint(p0.x);
            ab[1] = __float_as_uint(p1.x);
            ab[2] = __float_as_uint(p2.x);
            ab[3] = __float_as_uint(p3.x);
            as[0] = __float_as_uint(p0.y);
            as[1] = __float_as_uint(p1.y);
            as[2] = __float_as_uint(p2.y);
            as[3] = __float_as_uint(p3.y);
          } else {
            const float4 p = va[off[s][0]], q = va[1 + off[s][0]];
            ab[0] = __float_as_uint(p.x);
            ab[1] = __float_as_uint(q.x);
            ab[2] = __float_as_uint(p.y);
            ab[3] = __float_as_uint(q.y);
            as[0] = __float_as_uint(p.z);
            as[1] = __float_as_uint(q.z);
            as[2] = __float_as_uint(p.w);
            as[3] = __float_as_uint(q.w);
          }
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) tc::mma_tf32(acc[jn], as, bb[jn][s][0], bb[jn][s][1]);
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) tc::mma_tf32(acc[jn], ab, bs[jn][s][0], bs[jn][s][1]);
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) tc::mma_tf32(acc[jn], ab, bb[jn][s][0], bb[jn][s][1]);
        }
        // acc[jn][2r + c]: voxel 16 run + 2g + r of row yl, channel 8jn + 2tq + c
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int ch = 8 * jn + 2 * tq + c;
            if (ch >= a.cout) continue;
            const float r0 = fmaf(activate<ACT>(acc[jn][c] + bv[jn][c]), ps[jn][c], pb[jn][c]);
            const float r1 =
                fmaf(activate<ACT>(acc[jn][2 + c] + bv[jn][c]), ps[jn][c], pb[jn][c]);
            if (staged) {
              *reinterpret_cast<float2*>(stage + ch * X1_OUT + yl * X1_TX + 16 * run + 2 * g) =
                  make_float2(r0, r1);
            } else {
              const int y = y0 + yl, x = x0 + 16 * run + 2 * g;
              if (y >= a.h || x >= a.w) continue;
              float* op = a.out + ch * dhw + (long long)(z0 + zl) * hw + (long long)y * a.w + x;
              if (vec) {
                *reinterpret_cast<float2*>(op) = make_float2(r0, r1);
              } else {
                op[0] = r0;
                if (x + 1 < a.w) op[1] = r1;
              }
            }
          }
      }
    }
    if (!staged) continue;
    __syncwarp();
    const long long zoff = (long long)(z0 + zl) * hw;
    if (vec) {  // the warp's two rows: per channel, 8 lanes of 16 bytes per row
#pragma unroll 4
      for (int q = lane; q < a.cout * 16; q += 32) {
        const int ch = q >> 4, yl = 2 * warp + ((q >> 3) & 1), xs = q & 7;
        const int y = y0 + yl, x = x0 + 4 * xs;
        if (y >= a.h || x >= a.w) continue;
        *reinterpret_cast<float4*>(a.out + ch * dhw + zoff + (long long)y * a.w + x) =
            *reinterpret_cast<const float4*>(stage + ch * X1_OUT + yl * X1_TX + 4 * xs);
      }
    } else {  // 4-byte stores, one tile row of one channel per step
#pragma unroll 4
      for (int q = lane; q < a.cout * 2 * X1_TX; q += 32) {
        const int ch = q >> 6, yl = 2 * warp + ((q >> 5) & 1), xl = q & 31;
        const int y = y0 + yl, x = x0 + xl;
        if (y < a.h && x < a.w)
          a.out[ch * dhw + zoff + (long long)y * a.w + x] = stage[ch * X1_OUT + yl * X1_TX + xl];
      }
    }
    __syncwarp();
  }
}

template <int CIN, int NT, int ACT>
int launch_first_x3(const FirstX3Args& a, cudaStream_t stream) {
  const size_t smem = halo_bytes<CIN>(a.nz) +
                      (x3_staged<CIN>(a.vec) ? sizeof(float) * (size_t)a.cout * X1_OUT : 0);
  int err = (int)cudaFuncSetAttribute(conv3d_first_x3_kernel<CIN, NT, ACT>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int tiles = ((a.w + X1_TX - 1) / X1_TX) * ((a.h + X1_TY - 1) / X1_TY);
  const dim3 grid(tiles, (a.d + a.nz - 1) / a.nz);
  conv3d_first_x3_kernel<CIN, NT, ACT><<<grid, X1_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int CIN, int NT>
int launch_first_x3_act(const FirstX3Args& a, int act, cudaStream_t stream) {
  switch (act) {
    case ACT_NONE: return launch_first_x3<CIN, NT, ACT_NONE>(a, stream);
    case ACT_ELU: return launch_first_x3<CIN, NT, ACT_ELU>(a, stream);
    case ACT_RELU: return launch_first_x3<CIN, NT, ACT_RELU>(a, stream);
    case ACT_LEAKY: return launch_first_x3<CIN, NT, ACT_LEAKY>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int CIN>
int launch_first_x3_cin(const FirstX3Args& a, int act, cudaStream_t stream) {
  switch ((a.cout + 7) / 8) {
    case 1: return launch_first_x3_act<CIN, 1>(a, act, stream);
    case 2: return launch_first_x3_act<CIN, 2>(a, act, stream);
    case 3: return launch_first_x3_act<CIN, 3>(a, act, stream);
    case 4: return launch_first_x3_act<CIN, 4>(a, act, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// k8 steps of K (4 for cin = 1, 7 for cin = 2), the most output channels and
// the most planes per block: the host packs B and picks nz to match.
int conv3d_first_x3_steps(int cin) {
  return cin == 1 ? x3_steps<1>() : cin == 2 ? x3_steps<2>() : 0;
}

int conv3d_first_x3_max_cout() { return X1_MAX_COUT; }

int conv3d_first_x3_max_planes() { return X1_MAX_NZ; }

int conv3d_first_x3_launch(const void* x, int cin, int d, int h, int w, int nz, const void* frags,
                           int cout, const float* bias, const float* post, int act, int vec,
                           void* out, void* stream) {
  if (cout < 1 || cout > X1_MAX_COUT || nz < 1 || nz > X1_MAX_NZ)
    return (int)cudaErrorInvalidValue;
  const FirstX3Args a{static_cast<const float*>(x), d, h, w, nz,
                      static_cast<const float4*>(frags), cout, bias, post, vec,
                      static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 1) return launch_first_x3_cin<1>(a, act, s);
  if (cin == 2) return launch_first_x3_cin<2>(a, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
