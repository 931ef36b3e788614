// Weight gradient of the channels-first SAME 3x3x3 convolution (stride 1),
// written by hand for Hopper (sm_90a): H-wgrad.  Replaces the TPU kernels K6
// (_wgrad_kernel, synthsr_tpu/ops/conv_pallas.py:1090) and K7
// (_wgrad_flat_kernel, :1705); on this card their plane-vs-folded split (a
// 128-lane artefact) collapses into one kernel that takes any D, H, W, ci, co.
//
//   dw[dz, dy, dx, ci, co] = sum_{z,h,w} x[ci, z+dz-1, h+dy-1, w+dx-1] * g[co, z, h, w]
//
// with zero padding at every face, done by predicate while staging (nothing
// is padded in device memory).  x (ci, D, H, W) and g (co, D, H, W) are both
// bf16 or both float32 (the host rounds g to x's type first, as K6 does);
// every product and sum is float32.  The launcher allocates nothing, runs on
// the stream it is given and returns cudaGetLastError() (0 = launched).
//
// Bound: each output sums over the whole volume (at 128^3 and (ci, co) =
// (4, 24) that is 2 592 outputs over 2.1 M voxels), so the work has to be
// split over the volume (split-S) to fill 132 SMs; per voxel a thread does
// 72 float32 FMAs against 5 shared-memory loads, so the kernel is bound by
// the CUDA cores' float32 FMA rate (67 TFLOP/s published peak).  Tensor
// cores, wgmma and TMA are later work.
//
// Design: a grid of (n_split, ci chunks of WG_CK, co tiles of 8*NG), about
// eight blocks per SM (the host's plan, ops/conv_cf.py:wgrad_plan).  Each
// block walks a contiguous range of (z-plane, th x tw tile) items; per item
// it stages the zero-filled (WG_CK, 3, th+2, tw+2) halo tile of x and the
// (th*tw, 8*NG) tile of g (voxel-major, so a thread reads its 8 output
// channels as two float4) in shared memory as float32.  A thread owns one
// input channel, one dz and 8 output channels: 9 (dy, dx) taps x 8 = 72
// float32 sums in registers for the whole range, and slides a 3x3 window of
// x along each tile row so each voxel costs 3 x loads + 2 g loads.  The
// block writes its partial once to (n_split, 27, ci_pad, co_pad); a second
// launch sums the partials over the splits in a fixed order, so dw is
// bit-reproducible run to run.  Volume offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int WG_CK = 8;        // input channels per block
constexpr int WG_MAXVOX = 128;  // voxels per tile: th * tw <= 128

struct WgradArgs {
  const void* x;
  const void* g;
  int ci, co;
  int d, h, w;
  int th, tw;      // tile rows and columns
  int row, plane;  // shared-memory strides of the x halo tile (floats)
  int ci_pad, co_pad;
  int n_split;
  float* partial;  // (n_split, 27, ci_pad, co_pad)
};

template <typename T, int NG>
__global__ void __launch_bounds__(WG_CK * 3 * NG) conv3d_wgrad_kernel(const WgradArgs a) {
  constexpr int CT = 8 * NG;
  constexpr int NT = WG_CK * 3 * NG;  // threads: (input channel, dz, output group)
  extern __shared__ __align__(16) float smem[];
  float* s_g = smem;                    // WG_MAXVOX x CT, voxel-major
  float* s_x = smem + WG_MAXVOX * CT;   // WG_CK x 3 x plane

  const int split = blockIdx.x;
  const int ci0 = blockIdx.y * WG_CK;
  const int co0 = blockIdx.z * CT;
  const int t = threadIdx.x;
  const int c = t % WG_CK;           // input channel of this thread
  const int dz = (t / WG_CK) % 3;    // its z tap
  const int cg = t / (3 * WG_CK);    // its group of 8 output channels

  const long long hw = (long long)a.h * a.w;
  const long long dhw = hw * a.d;
  const int tiles_x = (a.w + a.tw - 1) / a.tw;
  const int tiles = tiles_x * ((a.h + a.th - 1) / a.th);
  const long long items = (long long)a.d * tiles;
  const long long i0 = items * split / a.n_split;
  const long long i1 = items * (split + 1) / a.n_split;
  const int nvox = a.th * a.tw;
  const int hx = a.tw + 2, hy = a.th + 2;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);

  float acc[3][3][8];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[dy][dx][q] = 0.f;

  for (long long it = i0; it < i1; ++it) {
    const int z = (int)(it / tiles);
    const int tile = (int)(it % tiles);
    const int tx0 = (tile % tiles_x) * a.tw;
    const int ty0 = (tile / tiles_x) * a.th;
    // x halo: WG_CK channels x 3 planes (z-1, z, z+1) x (th+2) x (tw+2)
    for (int e = t; e < WG_CK * 3 * hy * hx; e += NT) {
      const int xi = e % hx;
      int rest = e / hx;
      const int yy = rest % hy;
      rest /= hy;
      const int k = rest % 3;
      const int cc = rest / 3;
      const int ci = ci0 + cc;
      const int gx = tx0 - 1 + xi, gy = ty0 - 1 + yy, gz = z - 1 + k;
      float v = 0.f;
      if (ci < a.ci && gx >= 0 && gx < a.w && gy >= 0 && gy < a.h && gz >= 0 && gz < a.d)
        v = to_f32(x[(long long)ci * dhw + (long long)gz * hw + (long long)gy * a.w + gx]);
      s_x[(cc * 3 + k) * a.plane + yy * a.row + xi] = v;
    }
    // g tile of plane z, zero outside the volume and beyond co
    for (int e = t; e < CT * nvox; e += NT) {
      const int vox = e % nvox;
      const int q = e / nvox;
      const int co = co0 + q;
      const int gx = tx0 + vox % a.tw, gy = ty0 + vox / a.tw;
      float v = 0.f;
      if (co < a.co && gx < a.w && gy < a.h)
        v = to_f32(g[(long long)co * dhw + (long long)z * hw + (long long)gy * a.w + gx]);
      s_g[vox * CT + q] = v;
    }
    __syncthreads();

    const float* xs = s_x + (c * 3 + dz) * a.plane;
#pragma unroll 1
    for (int r = 0; r < a.th; ++r) {
      const float* xr = xs + r * a.row;   // halo row r + dy holds h = ty0 + r + dy - 1
      const float* gr = s_g + r * a.tw * CT + cg * 8;
      float win[3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        win[dy][0] = xr[dy * a.row];
        win[dy][1] = xr[dy * a.row + 1];
      }
#pragma unroll 2
      for (int wv = 0; wv < a.tw; ++wv) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) win[dy][2] = xr[dy * a.row + wv + 2];
        const float4 ga = *reinterpret_cast<const float4*>(gr + wv * CT);
        const float4 gb = *reinterpret_cast<const float4*>(gr + wv * CT + 4);
        const float gq[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[dy][dx][q] = fmaf(win[dy][dx], gq[q], acc[dy][dx][q]);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          win[dy][0] = win[dy][1];
          win[dy][1] = win[dy][2];
        }
      }
    }
    __syncthreads();
  }

  float* out = a.partial + (long long)split * 27 * a.ci_pad * a.co_pad;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int tap = dz * 9 + dy * 3 + dx;
      float4* o = reinterpret_cast<float4*>(
          out + ((long long)tap * a.ci_pad + ci0 + c) * a.co_pad + co0 + cg * 8);
      o[0] = make_float4(acc[dy][dx][0], acc[dy][dx][1], acc[dy][dx][2], acc[dy][dx][3]);
      o[1] = make_float4(acc[dy][dx][4], acc[dy][dx][5], acc[dy][dx][6], acc[dy][dx][7]);
    }
}

// Sums the partials over the splits, in split order, into dw (27, ci, co).
__global__ void conv3d_wgrad_reduce_kernel(const float* __restrict__ partial, int n_split, int ci,
                                           int co, int ci_pad, int co_pad, float* __restrict__ dw) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 27LL * ci * co) return;
  const int o = (int)(i % co);
  const long long rest = i / co;
  const int c = (int)(rest % ci);
  const int tap = (int)(rest / ci);
  const long long stride = 27LL * ci_pad * co_pad;
  const float* p = partial + ((long long)tap * ci_pad + c) * co_pad + o;
  float s = 0.f;
  for (int k = 0; k < n_split; ++k) s += p[k * stride];
  dw[i] = s;
}

template <typename T, int NG>
int launch_wgrad(const WgradArgs& a, float* dw, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)WG_MAXVOX * 8 * NG + (size_t)WG_CK * 3 * a.plane);
  int err = (int)cudaFuncSetAttribute(conv3d_wgrad_kernel<T, NG>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid(a.n_split, a.ci_pad / WG_CK, a.co_pad / (8 * NG));
  conv3d_wgrad_kernel<T, NG><<<grid, WG_CK * 3 * NG, smem, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = 27LL * a.ci * a.co;
  conv3d_wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      a.partial, a.n_split, a.ci, a.co, a.ci_pad, a.co_pad, dw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad_ng(const WgradArgs& a, int ng, float* dw, cudaStream_t stream) {
  switch (ng) {
    case 1: return launch_wgrad<T, 1>(a, dw, stream);
    case 2: return launch_wgrad<T, 2>(a, dw, stream);
    case 3: return launch_wgrad<T, 3>(a, dw, stream);
    case 4: return launch_wgrad<T, 4>(a, dw, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Input channels per H-wgrad block and voxels per tile: the host pads the
// partials' ci axis to a multiple of the former and sizes tiles by the latter.
int conv3d_wgrad_chunk() { return WG_CK; }
int conv3d_wgrad_max_tile() { return WG_MAXVOX; }

int conv3d_wgrad_launch(const void* x, const void* g, int ci, int co, int d, int h, int w, int th,
                        int tw, int ng, int n_split, float* partial, float* dw, int bf16,
                        void* stream) {
  if (th * tw > WG_MAXVOX || th < 1 || tw < 1 || n_split < 1) return (int)cudaErrorInvalidValue;
  const int row = tw + 2;
  const int plane = ((th + 2) * row) | 1;  // odd: the 24 (channel, dz) planes of a warp hit 24 banks
  const int ci_pad = (ci + WG_CK - 1) / WG_CK * WG_CK;
  const int co_pad = (co + 8 * ng - 1) / (8 * ng) * (8 * ng);
  const WgradArgs a{x, g, ci, co, d, h, w, th, tw, row, plane, ci_pad, co_pad, n_split, partial};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_wgrad_ng<__nv_bfloat16>(a, ng, dw, s) : launch_wgrad_ng<float>(a, ng, dw, s);
}

}  // extern "C"
