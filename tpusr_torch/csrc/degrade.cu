// Fused image degradation with an in-kernel Philox4x32-10, written by hand
// for Hopper (sm_90a).
//
// Kernel D, gauss_kernel, replaces tpusr/ops/pallas_degrade.py::_gauss_kernel:
//   out = floor(clip(img + z * std255, 0, 255)), z = sqrt(-2 ln max(u1, 1e-7))
//   * cos(2 pi u2) (Box-Muller, cosine branch only, as the TPU kernel).
// Kernel E, salt_pepper_kernel, replaces pallas_degrade.py::_saltpepper_kernel:
//   255 where u_s < s, then 0 where u_p < p (pepper wins), one (u_s, u_p) per
//   pixel shared by its channels.
//
// Random bits. The TPU kernels draw from the TPU's own generator, seeded per
// row tile; those bits cannot be reproduced here. Both kernels instead run
// Philox4x32-10 (Random123's constants and round function) keyed by
// (seed mod 2^32, 0), with the counter layout of tpusr_torch/ops/
// fused_degrade.py, which its plain PyTorch version uses too, so the two
// agree bit for bit on the uniforms:
//   kernel D: counter (e / 2, 0, 0, 0) for flat HWC element e; element 2j
//     takes words 0 and 1 as (u1, u2), element 2j + 1 words 2 and 3;
//   kernel E: counter (h * W + w, 1, 0, 0) for pixel (h, w); word 0 is u_s,
//     word 1 is u_p.
// Uniforms: ((b >> 9) | 0x3F800000) read as f32, minus 1, in [0, 1 - 2^-23],
// as pallas_degrade.py::_uniform_from_bits.
//
// Numerics. The arithmetic follows the plain version step by step in f32:
// every product and sum is rounded on its own (__fmul_rn / __fadd_rn), so
// nvcc cannot contract img + z * std255 into one FMA, which would round
// differently and move elements across the floor. logf, cosf and sqrtf are
// the full-accuracy library functions (no fast math); they can still differ
// from another library's by an ulp, which after the floor moves a rare
// element by exactly 1.
//
// What bounds them on the H100: a full DIV2K HR frame (1356 x 2040 x 3 f32)
// is read once and written once, 66.4 MB, 0.0198 ms at 3.35 TB/s. Each
// Philox call is 10 rounds; a round is, per thread, 2 32-bit products kept
// whole (a high and a low multiply each: 4 integer instructions) and 2
// three-input XORs (one LOP3 each): at most 60 integer instructions per
// call. The key schedule is no per-thread work: k1 is the constant 0, so
// its bumps fold at compile time, and the k0 bumps are the same for every
// thread. Kernel D makes one call per element pair (4.15 M calls, 0.25 G
// integer instructions), kernel E one per pixel (2.77 M calls, 0.17 G).
// Even at 16.7 T integer instructions per second (132 SMs x 64 INT32 lanes
// x 1.98 GHz, the lowest rate they could issue at) that is 0.0149 and
// 0.0100 ms, under the byte bound: both kernels are bounded by their bytes,
// 0.0198 ms. The design: one thread per element pair (D) or per pixel
// (E), so each Philox call is spent once and its four words all used (D) or
// its two masks shared by the pixel's channels (E); the image is streamed
// once, with neighbouring threads on neighbouring addresses, and nothing is
// staged or kept: no noise tensor exists in memory. Every H, W, C >= 1; the
// ragged edge (an odd element count, a partial last block) is masked.
//
// Interface: plain C entry points (loaded with ctypes). They launch on the
// caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr unsigned PHILOX_M0 = 0xD2511F53u;
constexpr unsigned PHILOX_M1 = 0xCD9E8D57u;
constexpr unsigned PHILOX_W0 = 0x9E3779B9u;
constexpr unsigned PHILOX_W1 = 0xBB67AE85u;
constexpr float TWO_PI = 6.283185307179586f;  // f32(2 pi), as 2.0 * pi * u2 rounds it

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const unsigned hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const unsigned hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform_from_bits(unsigned b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ float gauss_one(float img, float u1, float u2, float std255) {
  u1 = fmaxf(u1, 1e-7f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float z = __fmul_rn(r, cosf(__fmul_rn(TWO_PI, u2)));
  const float v = __fadd_rn(img, __fmul_rn(z, std255));
  return floorf(fminf(fmaxf(v, 0.0f), 255.0f));
}

// One thread per element pair j: elements 2j and 2j + 1 of the flat image.
__global__ void __launch_bounds__(NTHREADS)
    gauss_kernel(const float* __restrict__ img, float* __restrict__ out, int n,
                 unsigned key0, float std255) {
  const int j = blockIdx.x * NTHREADS + threadIdx.x;
  const int e = 2 * j;
  if (e >= n) return;
  const uint4 r = philox4x32_10(make_uint4(static_cast<unsigned>(j), 0u, 0u, 0u), key0, 0u);
  out[e] = gauss_one(img[e], uniform_from_bits(r.x), uniform_from_bits(r.y), std255);
  if (e + 1 < n) {
    out[e + 1] = gauss_one(img[e + 1], uniform_from_bits(r.z), uniform_from_bits(r.w), std255);
  }
}

// One thread per pixel: both masks from one Philox call, applied to all C
// channels of the pixel.
__global__ void __launch_bounds__(NTHREADS)
    salt_pepper_kernel(const float* __restrict__ img, float* __restrict__ out, int hw, int C,
                       unsigned key0, float s, float p) {
  const int px = blockIdx.x * NTHREADS + threadIdx.x;
  if (px >= hw) return;
  const uint4 r = philox4x32_10(make_uint4(static_cast<unsigned>(px), 1u, 0u, 0u), key0, 0u);
  const bool salt = uniform_from_bits(r.x) < s;
  const bool pepper = uniform_from_bits(r.y) < p;
  const size_t base = static_cast<size_t>(px) * C;
  for (int c = 0; c < C; ++c) {
    float v = salt ? 255.0f : img[base + c];
    out[base + c] = pepper ? 0.0f : v;
  }
}

}  // namespace

extern "C" {

// device: the CUDA ordinal the tensors and the stream belong to. img and out
// are contiguous f32 HWC images of n = H * W * C elements, n < 2^31.
int tpusr_gaussian_noise(int device, const void* img, void* out, int n, unsigned key0,
                         float std255, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = n / 2 + n % 2;
  const int blocks = (pairs + NTHREADS - 1) / NTHREADS;
  gauss_kernel<<<blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(out), n, key0, std255);
  return static_cast<int>(cudaGetLastError());
}

// hw = H * W pixels of C channels each, hw * C < 2^31.
int tpusr_salt_pepper_noise(int device, const void* img, void* out, int hw, int C,
                            unsigned key0, float s, float p, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (hw + NTHREADS - 1) / NTHREADS;
  salt_pepper_kernel<<<blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(out), hw, C, key0, s, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
