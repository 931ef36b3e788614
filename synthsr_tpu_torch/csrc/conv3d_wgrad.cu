// The second pass of the weight-gradient kernels H-wgrad-wg
// (conv3d_wgrad_wg.cu) and H-wgrad-mma (conv3d_wgrad_mma.cu), bf16, and
// H-wgrad-x3 (conv3d_wgrad_x3.cu, float32), which replace the TPU kernels K6 (_wgrad_kernel,
// synthsr_tpu/ops/conv_pallas.py:1090) and K7 (_wgrad_flat_kernel, :1705).
// Each of their blocks writes the partial weight gradient of its share of the
// volume to (n_split, 27, ci_pad, co_pad); this kernel sums the partials over
// the splits in split order into dw (27, ci, co), so dw is bit-reproducible
// run to run (no atomics).  Bound by bytes: it reads the partials once.  The
// launcher runs on the stream it is given, allocates nothing and returns
// cudaGetLastError() (0 = launched).  Also the library's shared entry point:
// conv3d_error_string, the message of a launcher's error code.

#include <cuda_runtime.h>

namespace {

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

}  // namespace

extern "C" {

// CUDA's message, or the wgmma kernels' launcher errors (wg_common.cuh's WG_ERR_*)
const char* conv3d_error_string(int err) {
  switch (err) {
    case 20000: return "cuTensorMapEncodeTiled refused a tensor map";
    case 20001: return "cuTensorMapEncodeTiled not found in the driver";
    case 20002: return "H-fwd-wg / H-wgrad-wg launch arguments out of range";
  }
  return cudaGetErrorString((cudaError_t)err);
}

// Sums (n_split, 27, ci_pad, co_pad) partials in split order into dw (27, ci, co);
// the second pass of H-wgrad-wg, H-wgrad-mma and H-wgrad-x3.
int conv3d_wgrad_reduce(const float* partial, int n_split, int ci, int co, int ci_pad, int co_pad,
                        float* dw, void* stream) {
  const long long n = 27LL * ci * co;
  conv3d_wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                               static_cast<cudaStream_t>(stream)>>>(partial, n_split, ci, co,
                                                                    ci_pad, co_pad, dw);
  return (int)cudaGetLastError();
}

}  // extern "C"
