// Building blocks shared by the tensor-core kernels H-fwd-mma
// (conv3d_fwd_mma.cu), H-wgrad-mma (conv3d_wgrad_mma.cu), H-first-mma
// (conv3d_first_mma.cu), H-fwd-x3 (conv3d_fwd_x3.cu), H-wgrad-x3
// (conv3d_wgrad_x3.cu) and H-first-x3 (conv3d_first_x3.cu), sm_90a;
// H-wgrad-wg (conv3d_wgrad_wg.cu) loads its wgmma A fragments with ldsm_x4.
//
// - PTX wrappers: ldmatrix (.x4, .x4.trans), ld.shared.v2, the bf16 tensor-core
//   product mma.sync.m16n8k16 and the tf32 one mma.sync.m16n8k8, both with
//   float32 sums, cp.async (16 and 4 bytes) with zero fill and its commit /
//   wait.
// - Split TF32 ("3xTF32") for the float32 kernels: a float32 value a is
//   big = tf32(a) (cvt.rna: round to nearest, ties away from zero) plus
//   small = tf32(a - big); the subtraction is exact in float32.  A product
//   a*b is taken as small_a*big_b + big_a*small_b + big_a*big_b on the tensor
//   cores; the dropped small*small term and the rounding of small are each
//   about 2^-22 relative, so the sums keep float32 accuracy at a third of the
//   TF32 rate.  The tensor cores add into their accumulator with truncation
//   (round toward zero), so a chain of mma over all of K biases the sum
//   (1.5e-5 relative at 72 input channels on the card, 5e-6 at 24, in the
//   first card runs of H-fwd-x3): the kernels chain a few dozen products
//   into a partial sum, then add it to their float32 sums with a rounding add.
// - The channels-last halo tile.  Both kernels read a 3x3x3 neighbourhood of a
//   channels-first (C, D, H, W) bf16 volume.  In a channels-first row a
//   dx = +-1 tap is a 2-byte shift, which neither ldmatrix nor cp.async can
//   address, so one 8-channel group of the tile is staged in shared memory
//   channels-last: one 16-byte slot per voxel holding its 8 channels.  Every
//   one of the 27 taps is then a 16-byte-aligned shifted view, and an 8 x 8
//   ldmatrix matrix is 8 consecutive voxels of one halo row: 8 consecutive
//   slots, which cover all 32 banks whatever the shift, so the reads are free
//   of bank conflicts with no swizzle.
// - The staging is split in two so that a kernel can overlap it with the
//   previous chunk's mma: halo_load issues the 16-byte global loads (8
//   channels x 8 voxels per thread) into registers; halo_store, called after
//   the mma, transposes the 8 x 8 block with byte permutes and writes 8
//   slots.  A halo row is ROW = 35 slots (34 used): 35 = 3 mod 8, so the 8
//   threads of a store phase, which own 8 consecutive rows, hit 8 distinct
//   16-byte bank groups.
//
// Voxels outside the volume and channels beyond a source's count are zero
// (by predicate: nothing is padded in device memory).  Volume offsets are
// 64-bit.  `vec` selects 16-byte global loads; the host sets it only when
// W % 8 == 0 and every pointer is 16-byte aligned, else 2-byte loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void lds64(uint32_t& a, uint32_t& b, uint32_t addr) {
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(a), "=r"(b) : "r"(addr));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

// d += a (16x8, row-major) * b (8x8, column-major), tf32 operands (the low 13
// bits of each register zero), f32 sums.  a: (row g, col tq), (g + 8, tq),
// (g, tq + 4), (g + 8, tq + 4); b: (row tq, col g), (tq + 4, g); d as mma_bf16's.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// The split of split TF32: v = big + small, each a tf32 value.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

// Waits until at most N of this thread's committed cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Volume {
  int d, h, w;
  long long hw, dhw;
};

// Halo tile of a TY x 32 output tile of one plane: 3 planes x (TY + 2) rows x
// 34 voxels, slot (dz, yy, xi) = voxel (z - 1 + dz, y0 - 1 + yy, x0 - 1 + xi).
template <int TY>
struct Halo {
  static constexpr int ROW = 35;
  static constexpr int PLANE = (TY + 2) * ROW;
  static constexpr int ROWS = 3 * (TY + 2);
  static constexpr int BYTES = 3 * PLANE * 16;
  static constexpr int ITEMS = ROWS * 4;  // (row, 8-voxel segment) pairs, one per thread
  // slot offset of tap (dz, dy, dx), tap = dz*9 + dy*3 + dx, from the output voxel's (0,0,0)
  __host__ __device__ static constexpr int tap(int t) {
    return (t / 9) * PLANE + (t / 3 % 3) * ROW + t % 3;
  }
};

struct HaloRegs {
  uint4 v[8];      // channel c: voxels x .. x + 7 of the thread's segment
  uint32_t e[4];   // the row's edge voxel (x0 - 1 or x0 + 32), channels 2j | 2j+1 << 16
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Loads thread t's part of the halo of one 8-channel group: `p` is its first
// channel (channel-first, stride dhw), `nc` (1..8) the channels present.
template <int TY>
__device__ __forceinline__ void halo_load(HaloRegs& r, const uint16_t* p, int nc,
                                          const Volume& vol, int z, int y0, int x0, bool vec,
                                          int t) {
  if (t >= Halo<TY>::ITEMS) return;
  const int row = t % Halo<TY>::ROWS, seg = t / Halo<TY>::ROWS;
  const int gz = z - 1 + row / (TY + 2), gy = y0 - 1 + row % (TY + 2);
  const bool row_ok = gz >= 0 && gz < vol.d && gy >= 0 && gy < vol.h;
  const long long roff = (long long)gz * vol.hw + (long long)gy * vol.w;
  const int x = x0 + 8 * seg;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row_ok && c < nc) {
      const uint16_t* q = p + c * vol.dhw + roff;
      if (vec) {
        if (x < vol.w) v = __ldg(reinterpret_cast<const uint4*>(q + x));
      } else {
        uint32_t s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t lo = x + 2 * i < vol.w ? q[x + 2 * i] : 0u;
          const uint32_t hi = x + 2 * i + 1 < vol.w ? q[x + 2 * i + 1] : 0u;
          s[i] = lo | (hi << 16);
        }
        v = make_uint4(s[0], s[1], s[2], s[3]);
      }
    }
    r.v[c] = v;
  }
  const int ex = seg == 0 ? x0 - 1 : x0 + 32;
  const bool edge_ok = (seg == 0 || seg == 3) && row_ok && ex >= 0 && ex < vol.w;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t lo = 0u, hi = 0u;
    if (edge_ok && 2 * j < nc) lo = p[(2 * j) * vol.dhw + roff + ex];
    if (edge_ok && 2 * j + 1 < nc) hi = p[(2 * j + 1) * vol.dhw + roff + ex];
    r.e[j] = lo | (hi << 16);
  }
}

// Transposes what halo_load loaded and writes it channels-last to the tile `s`.
template <int TY>
__device__ __forceinline__ void halo_store(const HaloRegs& r, unsigned char* s, int t) {
  if (t >= Halo<TY>::ITEMS) return;
  const int row = t % Halo<TY>::ROWS, seg = t / Halo<TY>::ROWS;
  uint4* s4 = reinterpret_cast<uint4*>(s) + row * Halo<TY>::ROW;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t sel = (i & 1) ? 0x7632u : 0x5410u;  // high or low halves of the two words
    uint4 o;
    o.x = __byte_perm(word(r.v[0], i >> 1), word(r.v[1], i >> 1), sel);
    o.y = __byte_perm(word(r.v[2], i >> 1), word(r.v[3], i >> 1), sel);
    o.z = __byte_perm(word(r.v[4], i >> 1), word(r.v[5], i >> 1), sel);
    o.w = __byte_perm(word(r.v[6], i >> 1), word(r.v[7], i >> 1), sel);
    s4[1 + 8 * seg + i] = o;
  }
  if (seg == 0) s4[0] = make_uint4(r.e[0], r.e[1], r.e[2], r.e[3]);
  if (seg == 3) s4[33] = make_uint4(r.e[0], r.e[1], r.e[2], r.e[3]);
}

}  // namespace tc
