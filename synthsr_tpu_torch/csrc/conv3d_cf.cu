// The first conv of the U-Net (1 or 2 input channels) on float32
// activations, written by hand for Hopper (sm_90a): H-first.  Also the
// library's shared entry points (the error string).  The other float32 convs
// run on the tensor cores in H-fwd-x3 (conv3d_fwd_x3.cu), bf16 ones in the
// conv3d_*_mma.cu kernels.
//
// The launcher, loaded through ctypes by synthsr_tpu_torch/ops/conv_cf.py,
// runs on the stream it is given, allocates nothing, and returns
// cudaGetLastError() right after the launch (0 = launched).
//
// Layouts (all contiguous):
//   activations  (C, D, H, W) float32
//   weights      (cin_pad, 27, cout_pad) float32, tap = kd*9 + kh*3 + kw,
//                packed once per weight set on the host (zero padding:
//                cin_pad to a multiple of 8, cout_pad to a multiple of the
//                cout tile)
//   bias (cout) f32, post (2, cout) f32 = (scale, shift) applied AFTER the
//   activation
//
// Every sum runs in float32; offsets into a volume are 64-bit.  ELU is
// exp(x) - 1 for x <= 0, as in the TPU kernels (conv_pallas.py:77-78);
// LeakyReLU(0.2) is v >= 0 ? v : 0.2v (conv_pallas.py:628).  The bias is
// added exactly once per output in the epilogue (the TPU kernels' centre-tap
// bias column is a lane trick that has no purpose here).

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

const char* conv3d_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

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
