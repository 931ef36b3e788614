// Channels-first SAME 3x3x3 convolution (stride 1) for the SynthSR U-Net's
// inference forward, written by hand for Hopper (sm_90a).
//
// Two kernels, each with an `extern "C"` launcher that synthsr_tpu_torch/ops/
// conv_cf.py loads through ctypes.  Every launcher runs on the stream it is
// given, allocates nothing, and returns cudaGetLastError() right after the
// launch (0 = launched).
//
// Layouts (all contiguous):
//   activations  (C, D, H, W) float32 (bf16 runs on the tensor-core kernels
//                conv3d_*_mma.cu)
//   weights      (cin_pad, 27, cout_pad) float32, tap = kd*9 + kh*3 + kw,
//                packed once per weight set on the host (zero padding:
//                cin_pad to a multiple of FWD_CK, cout_pad to a multiple of
//                the cout tile); values already rounded to the compute dtype
//   bias (cout) f32, post (2, cout) f32 = (scale, shift) applied AFTER the
//   activation, head (cout + 1) f32 = 1x1x1 likelihood weights then its bias
//
// Every sum runs in float32; offsets into a volume are 64-bit (a 256^3
// decoder source holds 48 x 16.7M elements).  ELU is exp(x) - 1 for x <= 0,
// as in the TPU kernels (conv_pallas.py:77-78); LeakyReLU(0.2) is v >= 0 ? v :
// 0.2v (conv_pallas.py:368, :628).  The bias is added exactly
// once per output in the epilogue (the TPU kernels' centre-tap bias column is
// a lane trick that has no purpose here).

#include <cuda_runtime.h>

namespace {

enum { ACT_NONE = 0, ACT_ELU = 1, ACT_RELU = 2, ACT_LEAKY = 3 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_ELU) return v > 0.f ? v : expf(v) - 1.f;
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_LEAKY) return v >= 0.f ? v : 0.2f * v;
  return v;
}

// ---------------------------------------------------------------------------
// H-fwd: the general conv.  Replaces the TPU kernels K2 (_plane_kernel,
// synthsr_tpu/ops/conv_pallas.py:270), K3 (conv3d_cf_grouped :920, channel-
// group chaining through `accum`), K4 (_flat_kernel :1297) and K5 (_kernel
// :127, the blocked halo-slab conv of the large-field-of-view level-0 convs,
// e.g. 24->24 at 192x256x512; its 128-aligned W padding and (td, th) blocks
// are VMEM artefacts with no counterpart here).
//
// Bound: at the U-Net's widths (24..384 channels) the conv does 27*cin FMAs
// per output value against 2 bytes read per input value, so it is bound by
// arithmetic; this kernel uses the CUDA cores' float32 FMA (67 TFLOP/s
// published peak).  It runs float32 activations only; bf16 activations run
// on the tensor cores in H-fwd-mma (conv3d_fwd_mma.cu).
// Design: one block owns one output plane z, an 8 x 32 (H x W) tile of it and
// CT = 8*NG output channels.  It walks the input channels in chunks of FWD_CK:
// the chunk's (3, 10, 34) halo tile, zero-filled outside the volume, and its
// (FWD_CK, 27, CT) weights are staged in shared memory as float32, so no
// concatenated [skip, up] tensor, padded copy or channel group ever exists in
// device memory and the whole K = 27*cin sum stays in registers.  Each thread
// keeps 4 neighbouring x voxels x 8 output channels (32 float32 sums); per
// (channel, dz, dy) it reads 6 input values once and reuses them for the 3 dx
// taps, and each warp reads one channel group's weights as a broadcast.
// Optional epilogue, in registers: + accum, + bias, activation, post affine,
// and the folded 1x1x1 head, which reduces the CT channels across the block
// in shared memory and stores only (1, D, H, W) float32.
// ---------------------------------------------------------------------------
constexpr int FWD_TX = 32;                        // tile width (W)
constexpr int FWD_TY = 8;                         // tile height (H)
constexpr int FWD_CK = 8;                         // input channels per chunk
constexpr int FWD_ROW = 40;                       // smem row: [3] = x0-1, [4..35] = x0..x0+31, [36] = x0+32
constexpr int FWD_PLANE = (FWD_TY + 2) * FWD_ROW; // 10 halo rows
constexpr int FWD_CH = 3 * FWD_PLANE;             // 3 halo planes

struct FwdArgs {
  const float* src0;
  const float* src1;
  int c0, c1;
  int d, h, w;
  const float* wpk;
  int cout, cout_pad;
  const float* bias;
  const float* accum;
  const float* post;
  const float* head;
  int act;
  float* out;
};

template <int NG>
constexpr int fwd_smem_floats() { return FWD_CK * FWD_CH + FWD_CK * 27 * 8 * NG; }

template <int NG>
__global__ void __launch_bounds__(64 * NG) conv3d_fwd_kernel(const FwdArgs a) {
  constexpr int CT = 8 * NG;
  constexpr int NT = 64 * NG;
  extern __shared__ __align__(16) float smem[];
  float* s_in = smem;                    // FWD_CK x FWD_CH
  float* s_w = smem + FWD_CK * FWD_CH;   // FWD_CK x 27 x CT

  const int tiles_x = (a.w + FWD_TX - 1) / FWD_TX;
  const int tx0 = (blockIdx.x % tiles_x) * FWD_TX;
  const int ty0 = (blockIdx.x / tiles_x) * FWD_TY;
  const int z = blockIdx.y;
  const int co0 = blockIdx.z * CT;

  const int t = threadIdx.x;
  const int cg = t >> 6;   // channel group, uniform within a warp
  const int vy = (t & 63) >> 3;
  const int vx = t & 7;    // voxels x0 .. x0+3 with x0 = tx0 + 4*vx

  const long long hw = (long long)a.h * a.w;
  const long long dhw = hw * a.d;
  const int cin = a.c0 + a.c1;

  float acc[4][8];
#pragma unroll
  for (int v = 0; v < 4; ++v)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[v][q] = 0.f;

  for (int ci0 = 0; ci0 < cin; ci0 += FWD_CK) {
    // stage the halo tile of FWD_CK channels: 3 planes x 10 rows x 34 columns
    for (int e = t; e < FWD_CK * 3 * (FWD_TY + 2) * (FWD_TX + 2); e += NT) {
      const int xi = e % (FWD_TX + 2);
      int rest = e / (FWD_TX + 2);
      const int yy = rest % (FWD_TY + 2);
      rest /= (FWD_TY + 2);
      const int dz = rest % 3;
      const int c = rest / 3;
      const int ci = ci0 + c;
      const int gx = tx0 - 1 + xi, gy = ty0 - 1 + yy, gz = z - 1 + dz;
      float v = 0.f;
      if (ci < cin && gx >= 0 && gx < a.w && gy >= 0 && gy < a.h && gz >= 0 && gz < a.d) {
        const long long off = (long long)gz * hw + (long long)gy * a.w + gx;
        v = ci < a.c0 ? a.src0[(long long)ci * dhw + off]
                      : a.src1[(long long)(ci - a.c0) * dhw + off];
      }
      s_in[c * FWD_CH + dz * FWD_PLANE + yy * FWD_ROW + xi + 3] = v;
    }
    // stage the chunk's weights for this block's CT output channels
    for (int e = t; e < FWD_CK * 27 * (CT / 4); e += NT) {
      const int q4 = e % (CT / 4);
      const int row = e / (CT / 4);  // c*27 + tap
      const float4* g = reinterpret_cast<const float4*>(
          a.wpk + ((long long)ci0 * 27 + row) * a.cout_pad + co0);
      reinterpret_cast<float4*>(s_w + row * CT)[q4] = g[q4];
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < FWD_CK; ++c) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* row = s_in + c * FWD_CH + dz * FWD_PLANE + (vy + dy) * FWD_ROW + 4 * vx;
          const float4 mid = *reinterpret_cast<const float4*>(row + 4);
          const float in[6] = {row[3], mid.x, mid.y, mid.z, mid.w, row[8]};
          const float* wrow = s_w + (c * 27 + dz * 9 + dy * 3) * CT + cg * 8;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4 wa = *reinterpret_cast<const float4*>(wrow + dx * CT);
            const float4 wb = *reinterpret_cast<const float4*>(wrow + dx * CT + 4);
            const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int v = 0; v < 4; ++v)
#pragma unroll
              for (int q = 0; q < 8; ++q) acc[v][q] = fmaf(in[v + dx], wv[q], acc[v][q]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue
  const int x0 = tx0 + 4 * vx;
  const int y = ty0 + vy;
  const bool row_ok = y < a.h;
  const long long vox0 = (long long)z * hw + (long long)y * a.w + x0;
  float hsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int co = co0 + cg * 8 + q;
    if (co >= a.cout) continue;
    const float b = a.bias ? a.bias[co] : 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (!row_ok || x0 + v >= a.w) continue;
      float val = acc[v][q];
      if (a.accum) val += a.accum[(long long)co * dhw + vox0 + v];
      val = activate(val + b, a.act);
      if (a.post) val = val * a.post[co] + a.post[a.cout + co];
      if (a.head)
        hsum[v] += val * a.head[co];
      else
        a.out[(long long)co * dhw + vox0 + v] = val;
    }
  }
  if (a.head) {  // uniform over the block; the launcher guarantees cout <= CT
    float* red = smem;  // NG x 256 partial sums; s_in is free after the last sync
#pragma unroll
    for (int v = 0; v < 4; ++v) red[cg * 256 + vy * 32 + 4 * vx + v] = hsum[v];
    __syncthreads();
    if (cg == 0) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (!row_ok || x0 + v >= a.w) continue;
        float s = 0.f;
#pragma unroll
        for (int g = 0; g < NG; ++g) s += red[g * 256 + vy * 32 + 4 * vx + v];
        a.out[vox0 + v] = s + a.head[a.cout];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// H-first: the U-Net's first conv (1 or 2 input channels) on float32
// activations.  Replaces K1 (_first_kernel, synthsr_tpu/ops/conv_pallas.py:
// 569) on the float32 path; bf16 activations run on the tensor cores in
// H-first-mma (conv3d_first_mma.cu).
//
// Bound: with cin <= 2 there are only 27*cin FMAs per output value, and each
// voxel writes cout float32 values but reads 4*cin bytes, so the kernel sits
// near the balance of the card's float32 FMA rate and its store bandwidth.
// Design: output-stationary, as on the TPU.  A block owns one plane z and a
// 2 x 128 (H x W) tile; the (cin, 3, 4, 130) halo and the (27*cin, cout_pad)
// weights are staged in shared memory once.  Each thread owns one voxel: it
// loads its 27*cin taps into registers once, then walks the output channels
// eight at a time (weights read as warp-wide broadcasts) and stores each
// channel plane with warp-contiguous writes.  Epilogue: bias, activation,
// post affine.
// ---------------------------------------------------------------------------
constexpr int FIRST_TX = 128;
constexpr int FIRST_TY = 2;
constexpr int FIRST_ROW = 132;  // [xi] = x0 - 1 + xi for xi in [0, 130)
constexpr int FIRST_PLANE = (FIRST_TY + 2) * FIRST_ROW;
constexpr int FIRST_CH = 3 * FIRST_PLANE;

template <int CIN>
__global__ void __launch_bounds__(FIRST_TX * FIRST_TY)
conv3d_first_kernel(const float* __restrict__ x, int d, int h, int w,
                    const float* __restrict__ wpk, int cout, int cout_pad,
                    const float* __restrict__ bias, const float* __restrict__ post, int act,
                    float* __restrict__ out) {
  constexpr int K = 27 * CIN;
  extern __shared__ __align__(16) float smem[];
  float* s_in = smem;                 // CIN x FIRST_CH
  float* s_w = smem + CIN * FIRST_CH;  // K x cout_pad

  const int tiles_x = (w + FIRST_TX - 1) / FIRST_TX;
  const int tx0 = (blockIdx.x % tiles_x) * FIRST_TX;
  const int ty0 = (blockIdx.x / tiles_x) * FIRST_TY;
  const int z = blockIdx.y;
  const int t = threadIdx.x;
  const long long hw = (long long)h * w;
  const long long dhw = hw * d;

  for (int e = t; e < CIN * 3 * (FIRST_TY + 2) * (FIRST_TX + 2); e += FIRST_TX * FIRST_TY) {
    const int xi = e % (FIRST_TX + 2);
    int rest = e / (FIRST_TX + 2);
    const int yy = rest % (FIRST_TY + 2);
    rest /= (FIRST_TY + 2);
    const int dz = rest % 3;
    const int c = rest / 3;
    const int gx = tx0 - 1 + xi, gy = ty0 - 1 + yy, gz = z - 1 + dz;
    float v = 0.f;
    if (gx >= 0 && gx < w && gy >= 0 && gy < h && gz >= 0 && gz < d)
      v = x[(long long)c * dhw + (long long)gz * hw + (long long)gy * w + gx];
    s_in[c * FIRST_CH + dz * FIRST_PLANE + yy * FIRST_ROW + xi] = v;
  }
  for (int e = t; e < K * cout_pad; e += FIRST_TX * FIRST_TY) s_w[e] = wpk[e];
  __syncthreads();

  const int lx = t % FIRST_TX, ly = t / FIRST_TX;
  float tap[K];
#pragma unroll
  for (int c = 0; c < CIN; ++c)
#pragma unroll
    for (int dz = 0; dz < 3; ++dz)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          tap[c * 27 + dz * 9 + dy * 3 + dx] =
              s_in[c * FIRST_CH + dz * FIRST_PLANE + (ly + dy) * FIRST_ROW + lx + dx];

  const int gx = tx0 + lx, gy = ty0 + ly;
  const bool ok = gx < w && gy < h;
  const long long vox = (long long)z * hw + (long long)gy * w + gx;
#pragma unroll 1
  for (int c8 = 0; c8 < cout_pad; c8 += 8) {
    float acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 wa = *reinterpret_cast<const float4*>(s_w + k * cout_pad + c8);
      const float4 wb = *reinterpret_cast<const float4*>(s_w + k * cout_pad + c8 + 4);
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[q] = fmaf(tap[k], wv[q], acc[q]);
    }
    if (!ok) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int co = c8 + q;
      if (co >= cout) break;
      float val = activate(acc[q] + (bias ? bias[co] : 0.f), act);
      if (post) val = val * post[co] + post[cout + co];
      out[(long long)co * dhw + vox] = val;
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NG>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats<NG>();
  int err = set_smem(conv3d_fwd_kernel<NG>, smem);
  if (err) return err;
  const int tiles = ((a.w + FWD_TX - 1) / FWD_TX) * ((a.h + FWD_TY - 1) / FWD_TY);
  const dim3 grid(tiles, a.d, a.cout_pad / (8 * NG));
  conv3d_fwd_kernel<NG><<<grid, 64 * NG, smem, stream>>>(a);
  return (int)cudaGetLastError();
}


template <int CIN>
int launch_first(const float* x, int d, int h, int w, const float* wpk, int cout, int cout_pad,
                 const float* bias, const float* post, int act, float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)CIN * FIRST_CH + (size_t)27 * CIN * cout_pad);
  int err = set_smem(conv3d_first_kernel<CIN>, smem);
  if (err) return err;
  const int tiles = ((w + FIRST_TX - 1) / FIRST_TX) * ((h + FIRST_TY - 1) / FIRST_TY);
  conv3d_first_kernel<CIN><<<dim3(tiles, d), FIRST_TX * FIRST_TY, smem, stream>>>(
      x, d, h, w, wpk, cout, cout_pad, bias, post, act, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Input channels per H-fwd chunk: the host pads packed weights to a multiple.
int conv3d_fwd_chunk() { return FWD_CK; }

const char* conv3d_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// float32 activations only: bf16 goes to H-fwd-mma (conv3d_fwd_mma.cu).
int conv3d_fwd_launch(const void* src0, int c0, const void* src1, int c1, int d, int h, int w,
                      const float* wpk, int cout, int cout_pad, int ng, const float* bias,
                      const void* accum, const float* post, const float* head, int act,
                      void* out, void* stream) {
  const FwdArgs a{static_cast<const float*>(src0), static_cast<const float*>(src1), c0, c1,
                  d, h, w, wpk, cout, cout_pad, bias, static_cast<const float*>(accum), post,
                  head, act, static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ng) {
    case 1: return launch_fwd<1>(a, s);
    case 2: return launch_fwd<2>(a, s);
    case 3: return launch_fwd<3>(a, s);
    case 4: return launch_fwd<4>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// float32 activations only: bf16 goes to H-first-mma (conv3d_first_mma.cu).
int conv3d_first_launch(const void* x, int cin, int d, int h, int w, const float* wpk, int cout,
                        int cout_pad, const float* bias, const float* post, int act, void* out,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (cin == 1) return launch_first<1>(xf, d, h, w, wpk, cout, cout_pad, bias, post, act, of, s);
  if (cin == 2) return launch_first<2>(xf, d, h, w, wpk, cout, cout_pad, bias, post, act, of, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
