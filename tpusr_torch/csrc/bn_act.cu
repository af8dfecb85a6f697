// The BatchNorm + LeakyReLU glue of the DIP skip net's fused dataflow,
// written by hand for Hopper (sm_90a), on channels_last (NHWC) activations.
//
// These kernels replace no TPU kernel. The JAX package leaves a train-mode
// BatchNorm's moments, its normalize, the LeakyReLU after it and their
// backward to XLA, which fuses each into a pass or two over the
// activation; eager PyTorch runs each as a chain of ATen kernels (mean,
// square, mean; mul, add, leaky_relu; and autograd's chain backward), and a
// per-channel broadcast over a channels_last tensor takes TensorIterator's
// non-vectorised path. These kernels take that work back to the passes the
// arithmetic needs. An activation is read as a (P, C) row-major matrix,
// P = N * H * W pixels:
//   channel_moments_kernel  per-block partial [sum x, sum x^2] per channel;
//   partials_sum_kernel     those partials summed in a fixed order, times a
//                           scale, into two (C,) vectors: no float atomics,
//                           so every result is deterministic;
//   affine_act_kernel       y = act(x * es + eb), act LeakyReLU 0.2 or none;
//   affine_act_grad_kernel  d = g * act'(x * es + eb), recomputed from x;
//                           per-block partial [sum d * x, sum d] per channel
//                           (des, deb) and, where asked, dx = d * es;
//   moments_grad_kernel     dx = (dm1 + 2 x dm2) / n, plus the normalize's
//                           d * es where a consumer left its backward to it
//                           (ops/bn_act.py's Fold): the second pass of the
//                           classic two-pass BatchNorm backward.
// x * es + eb is the expression kernel A's prologue evaluates, so the
// gradient of that prologue (FusedConv3x3's backward) is the same function
// of (g, x, es, eb, act) and runs on affine_act_grad_kernel too.
//
// What bounds them on the H100: bytes. Each does at most a few flops per
// element it moves (affine_act_grad: 6 a channel against 8 or 12 bytes in
// f32), far below the ~20 flops per byte where the card's 67 TFLOP/s of
// f32 FMA would start to bound; at 512^2 x 128 channels in f32 an
// activation is 134 MB, 0.040 ms at 3.35 TB/s. The design therefore only
// moves the bytes once and keeps them moving: a thread owns one vector of
// VEC channels (16 bytes where C and the pointers allow it) for the whole
// launch, so es, eb and the moments' gradients sit in its registers, and
// walks pixels with a grid-sized stride, UNROLL loads in flight; the
// threads of a block that own the same channels sum their partials in a
// fixed tree in shared memory, and the few hundred block partials are
// summed by partials_sum_kernel, one small launch. Every P >= 1 and C >= 1
// is taken; the ragged edges are masked. Math is f32 for f32 and bf16
// storage; bf16 rounds once on the store.
//
// Interface: plain C entry points (loaded with ctypes). They launch on the
// caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;     // threads a block: (threads over channel vectors) x (over pixels)
constexpr int UNROLL = 4;         // pixels a thread has in flight
constexpr int SUM_LANES = 32;     // partials_sum_kernel: values a block ...
constexpr int SUM_ROWS = 16;      // ... x partials summed side by side
constexpr float SLOPE = 0.2f;     // LeakyReLU's negative slope

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// One load or store of VEC elements as a single access of their width.
template <int BYTES>
struct Raw;
template <>
struct Raw<16> { typedef uint4 type; };
template <>
struct Raw<8> { typedef uint2 type; };
template <>
struct Raw<4> { typedef unsigned int type; };
template <>
struct Raw<2> { typedef unsigned short type; };

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&f)[VEC]) {
  typedef typename Raw<sizeof(T) * VEC>::type R;
  const R r = __ldg(reinterpret_cast<const R*>(p));
  const T* v = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int j = 0; j < VEC; ++j) f[j] = to_f(v[j]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&f)[VEC]) {
  typedef typename Raw<sizeof(T) * VEC>::type R;
  R r;
  T* v = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = from_f<T>(f[j]);
  *reinterpret_cast<R*>(p) = r;
}

// A thread's place: threads tx < bx of a block run over channel vectors
// (bx a power of 2 up to 32, so a warp reads whole pixel rows), ty < by
// over pixels. Its channels [c0, c0 + VEC) are fixed for the launch.
struct Place {
  int tx, ty, by, c0;
  bool on;  // its channel vector exists (C / VEC need not fill the grid's)
  long long p0, step;
};

template <int VEC>
__device__ __forceinline__ Place place(int C, int bx) {
  Place t;
  t.tx = threadIdx.x & (bx - 1);
  t.ty = threadIdx.x / bx;
  t.by = NTHREADS / bx;
  const int cv = blockIdx.y * bx + t.tx;
  t.on = cv * VEC < C;
  t.c0 = t.on ? cv * VEC : 0;
  t.p0 = (long long)blockIdx.x * t.by + t.ty;
  t.step = (long long)gridDim.x * t.by;
  return t;
}

// Sums each of a thread's K values over the by threads of its block that
// own the same channels, in a fixed tree; the ty == 0 threads get the sums.
// Every thread of the block calls it.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red, const Place& t, int bx) {
#pragma unroll
  for (int k = 0; k < K; ++k) red[(k * t.by + t.ty) * bx + t.tx] = v[k];
  __syncthreads();
  for (int h = t.by >> 1; h > 0; h >>= 1) {
    if (t.ty < h) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        red[(k * t.by + t.ty) * bx + t.tx] += red[(k * t.by + t.ty + h) * bx + t.tx];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = red[k * t.by * bx + t.tx];
}

// part[blockIdx.x][0][c0 + j] = a[j], part[blockIdx.x][1][c0 + j] = a[VEC + j]
template <int VEC>
__device__ __forceinline__ void write_partial(float* __restrict__ part, const float (&a)[2 * VEC],
                                              const Place& t, int C) {
  if (t.ty != 0 || !t.on) return;
  float* out = part + (long long)blockIdx.x * 2 * C + t.c0;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    out[j] = a[j];
    out[C + j] = a[VEC + j];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NTHREADS)
    channel_moments_kernel(const T* __restrict__ x, float* __restrict__ part, long long P, int C,
                           int bx) {
  __shared__ float red[2 * VEC * NTHREADS];
  const Place t = place<VEC>(C, bx);
  float acc[2 * VEC];
#pragma unroll
  for (int k = 0; k < 2 * VEC; ++k) acc[k] = 0.f;
  if (t.on) {
    for (long long p = t.p0; p < P; p += UNROLL * t.step) {
      float v[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (p + u * t.step < P) load_vec<T, VEC>(x + (p + u * t.step) * C + t.c0, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p + u * t.step >= P) continue;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          acc[j] += v[u][j];
          acc[VEC + j] += v[u][j] * v[u][j];
        }
      }
    }
  }
  block_sum<2 * VEC>(acc, red, t, bx);
  write_partial<VEC>(part, acc, t, C);
}

// out_a[k] = scale * sum_b part[b][0][k], out_b[k] = scale * sum_b part[b][1][k]:
// each thread sums every SUM_ROWS-th partial of one value, then a fixed tree.
__global__ void __launch_bounds__(SUM_LANES * SUM_ROWS)
    partials_sum_kernel(const float* __restrict__ part, float* __restrict__ out_a,
                        float* __restrict__ out_b, int nparts, int C, float scale) {
  __shared__ float red[SUM_LANES * SUM_ROWS];
  const int lane = threadIdx.x % SUM_LANES, row = threadIdx.x / SUM_LANES;
  const int k = blockIdx.x * SUM_LANES + lane;  // into the (2, C) of a partial
  float s = 0.f;
  if (k < 2 * C) {
#pragma unroll 4
    for (int b = row; b < nparts; b += SUM_ROWS) s += part[(long long)b * 2 * C + k];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = SUM_ROWS / 2; h > 0; h >>= 1) {
    if (row < h) red[threadIdx.x] += red[threadIdx.x + h * SUM_LANES];
    __syncthreads();
  }
  if (row == 0 && k < 2 * C) {
    const float v = red[lane] * scale;
    if (k < C) {
      out_a[k] = v;
    } else {
      out_b[k - C] = v;
    }
  }
}

template <typename T, int VEC, bool LEAKY>
__global__ void __launch_bounds__(NTHREADS)
    affine_act_kernel(const T* __restrict__ x, const float* __restrict__ es,
                      const float* __restrict__ eb, T* __restrict__ y, long long P, int C, int bx) {
  const Place t = place<VEC>(C, bx);
  if (!t.on) return;
  float s[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s[j] = es[t.c0 + j];
    b[j] = eb[t.c0 + j];
  }
  for (long long p = t.p0; p < P; p += UNROLL * t.step) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p + u * t.step < P) load_vec<T, VEC>(x + (p + u * t.step) * C + t.c0, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p + u * t.step >= P) continue;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float a = v[u][j] * s[j] + b[j];
        v[u][j] = LEAKY && a < 0.f ? SLOPE * a : a;
      }
      store_vec<T, VEC>(y + (p + u * t.step) * C + t.c0, v[u]);
    }
  }
}

template <typename T, int VEC, bool LEAKY, bool DX>
__global__ void __launch_bounds__(NTHREADS)
    affine_act_grad_kernel(const T* __restrict__ g, const T* __restrict__ x,
                           const float* __restrict__ es, const float* __restrict__ eb,
                           T* __restrict__ dx, float* __restrict__ part, long long P, int C,
                           int bx) {
  __shared__ float red[2 * VEC * NTHREADS];
  const Place t = place<VEC>(C, bx);
  float acc[2 * VEC];  // [sum d * x | sum d]
#pragma unroll
  for (int k = 0; k < 2 * VEC; ++k) acc[k] = 0.f;
  if (t.on) {
    float s[VEC], b[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s[j] = es[t.c0 + j];
      b[j] = eb[t.c0 + j];
    }
    for (long long p = t.p0; p < P; p += UNROLL * t.step) {
      float gv[UNROLL][VEC], xv[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p + u * t.step >= P) continue;
        const long long off = (p + u * t.step) * C + t.c0;
        load_vec<T, VEC>(g + off, gv[u]);
        load_vec<T, VEC>(x + off, xv[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p + u * t.step >= P) continue;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float d = gv[u][j];
          if (LEAKY && xv[u][j] * s[j] + b[j] < 0.f) d *= SLOPE;
          acc[j] += d * xv[u][j];
          acc[VEC + j] += d;
          gv[u][j] = d * s[j];
        }
        if (DX) store_vec<T, VEC>(dx + (p + u * t.step) * C + t.c0, gv[u]);
      }
    }
  }
  block_sum<2 * VEC>(acc, red, t, bx);
  write_partial<VEC>(part, acc, t, C);
}

template <typename T, int VEC, bool G, bool LEAKY>
__global__ void __launch_bounds__(NTHREADS)
    moments_grad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ es, const float* __restrict__ eb,
                        const float* __restrict__ dm1, const float* __restrict__ dm2,
                        T* __restrict__ dx, long long P, int C, int bx, float inv_n) {
  const Place t = place<VEC>(C, bx);
  if (!t.on) return;
  float a[VEC], b2[VEC], s[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    a[j] = dm1[t.c0 + j] * inv_n;
    b2[j] = 2.f * dm2[t.c0 + j] * inv_n;
    s[j] = G ? es[t.c0 + j] : 0.f;
    b[j] = G ? eb[t.c0 + j] : 0.f;
  }
  for (long long p = t.p0; p < P; p += UNROLL * t.step) {
    float xv[UNROLL][VEC], gv[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p + u * t.step >= P) continue;
      const long long off = (p + u * t.step) * C + t.c0;
      load_vec<T, VEC>(x + off, xv[u]);
      if (G) load_vec<T, VEC>(g + off, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p + u * t.step >= P) continue;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float o = a[j] + b2[j] * xv[u][j];
        if (G) {
          float d = gv[u][j];
          if (LEAKY && xv[u][j] * s[j] + b[j] < 0.f) d *= SLOPE;
          o += d * s[j];
        }
        xv[u][j] = o;
      }
      store_vec<T, VEC>(dx + (p + u * t.step) * C + t.c0, xv[u]);
    }
  }
}

dim3 grid_of(int C, int vec, int bx, int grid_x) {
  const int cv = C / vec;
  return dim3(grid_x, (cv + bx - 1) / bx);
}

cudaError_t sum_partials(const float* part, void* out_a, void* out_b, int nparts, int C,
                         float scale, cudaStream_t s) {
  const int blocks = (2 * C + SUM_LANES - 1) / SUM_LANES;
  partials_sum_kernel<<<blocks, SUM_LANES * SUM_ROWS, 0, s>>>(
      part, static_cast<float*>(out_a), static_cast<float*>(out_b), nparts, C, scale);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_moments(const void* x, float* part, long long P, int C, int bx, dim3 grid,
                           cudaStream_t s) {
  channel_moments_kernel<T, V><<<grid, NTHREADS, 0, s>>>(static_cast<const T*>(x), part, P, C, bx);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_affine_act(const void* x, const float* es, const float* eb, void* y,
                              long long P, int C, int bx, dim3 grid, bool leaky, cudaStream_t s) {
  const T* tx = static_cast<const T*>(x);
  T* ty = static_cast<T*>(y);
  if (leaky) {
    affine_act_kernel<T, V, true><<<grid, NTHREADS, 0, s>>>(tx, es, eb, ty, P, C, bx);
  } else {
    affine_act_kernel<T, V, false><<<grid, NTHREADS, 0, s>>>(tx, es, eb, ty, P, C, bx);
  }
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_affine_act_grad(const void* g, const void* x, const float* es,
                                   const float* eb, void* dx, float* part, long long P, int C,
                                   int bx, dim3 grid, bool leaky, cudaStream_t s) {
  const T* tg = static_cast<const T*>(g);
  const T* tx = static_cast<const T*>(x);
  T* tdx = static_cast<T*>(dx);
  if (leaky && dx != nullptr) {
    affine_act_grad_kernel<T, V, true, true><<<grid, NTHREADS, 0, s>>>(tg, tx, es, eb, tdx, part, P, C, bx);
  } else if (leaky) {
    affine_act_grad_kernel<T, V, true, false><<<grid, NTHREADS, 0, s>>>(tg, tx, es, eb, tdx, part, P, C, bx);
  } else if (dx != nullptr) {
    affine_act_grad_kernel<T, V, false, true><<<grid, NTHREADS, 0, s>>>(tg, tx, es, eb, tdx, part, P, C, bx);
  } else {
    affine_act_grad_kernel<T, V, false, false><<<grid, NTHREADS, 0, s>>>(tg, tx, es, eb, tdx, part, P, C, bx);
  }
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_moments_grad(const void* x, const void* g, const float* es, const float* eb,
                                const float* dm1, const float* dm2, void* dx, long long P, int C,
                                int bx, dim3 grid, float inv_n, bool leaky, cudaStream_t s) {
  const T* tx = static_cast<const T*>(x);
  const T* tg = static_cast<const T*>(g);
  T* tdx = static_cast<T*>(dx);
  if (g == nullptr) {
    moments_grad_kernel<T, V, false, false><<<grid, NTHREADS, 0, s>>>(tx, tg, es, eb, dm1, dm2, tdx, P, C, bx, inv_n);
  } else if (leaky) {
    moments_grad_kernel<T, V, true, true><<<grid, NTHREADS, 0, s>>>(tx, tg, es, eb, dm1, dm2, tdx, P, C, bx, inv_n);
  } else {
    moments_grad_kernel<T, V, true, false><<<grid, NTHREADS, 0, s>>>(tx, tg, es, eb, dm1, dm2, tdx, P, C, bx, inv_n);
  }
  return cudaGetLastError();
}

// The (dtype, vec) pairs the kernels are built for: float32 at 4 or 1
// channels a thread, bfloat16 at 8, 4 or 1 (16, 8 or the element's bytes).
// Reads dtype and vec, sets err, returns cudaErrorInvalidValue on another.
#define TPUSR_DISPATCH(LAUNCH, ...)                   \
  if (dtype == 0 && vec == 4) {                       \
    err = LAUNCH<float, 4>(__VA_ARGS__);              \
  } else if (dtype == 0 && vec == 1) {                \
    err = LAUNCH<float, 1>(__VA_ARGS__);              \
  } else if (dtype == 1 && vec == 8) {                \
    err = LAUNCH<bf16, 8>(__VA_ARGS__);               \
  } else if (dtype == 1 && vec == 4) {                \
    err = LAUNCH<bf16, 4>(__VA_ARGS__);               \
  } else if (dtype == 1 && vec == 1) {                \
    err = LAUNCH<bf16, 1>(__VA_ARGS__);               \
  } else {                                            \
    return static_cast<int>(cudaErrorInvalidValue);   \
  }

bool valid(long long P, int C, int vec, int bx, int grid_x) {
  return P >= 1 && C >= 1 && vec >= 1 && C % vec == 0 && bx >= 1 && bx <= 32 &&
         (bx & (bx - 1)) == 0 && grid_x >= 1;
}

}  // namespace

extern "C" {

// device: the CUDA ordinal the tensors and the stream belong to.
// dtype: 0 = float32, 1 = bfloat16. P pixels of C channels, row-major.
// vec: channels a thread owns (C % vec == 0, the tensors aligned to vec
// elements); bx: threads of a block over channel vectors (a power of 2 up
// to 32); grid_x: blocks over pixels, and so the number of partials in
// part (grid_x x 2 x C floats). es, eb, dm1, dm2, m1, m2, des, deb: (C,)
// float32.

// m1 = inv_n * sum x, m2 = inv_n * sum x^2 per channel.
int tpusr_channel_moments(int device, int dtype, const void* x, void* part, void* m1, void* m2,
                          long long P, int C, int vec, int bx, int grid_x, float inv_n,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid(P, C, vec, bx, grid_x)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fpart = static_cast<float*>(part);
  TPUSR_DISPATCH(launch_moments, x, fpart, P, C, bx, grid_of(C, vec, bx, grid_x), s)
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_partials(fpart, m1, m2, grid_x, C, inv_n, s));
}

// y = act(x * es + eb), act LeakyReLU 0.2 where leaky != 0.
int tpusr_affine_act(int device, int dtype, const void* x, const void* es, const void* eb,
                     void* y, long long P, int C, int vec, int bx, int grid_x, int leaky,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid(P, C, vec, bx, grid_x)) return static_cast<int>(cudaErrorInvalidValue);
  TPUSR_DISPATCH(launch_affine_act, x, static_cast<const float*>(es),
                 static_cast<const float*>(eb), y, P, C, bx, grid_of(C, vec, bx, grid_x),
                 leaky != 0, static_cast<cudaStream_t>(stream))
  return static_cast<int>(err);
}

// d = g * act'(x * es + eb): des = sum d * x, deb = sum d per channel, and
// dx = d * es unless dx is null.
int tpusr_affine_act_grad(int device, int dtype, const void* g, const void* x, const void* es,
                          const void* eb, void* dx, void* part, void* des, void* deb,
                          long long P, int C, int vec, int bx, int grid_x, int leaky,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid(P, C, vec, bx, grid_x)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fpart = static_cast<float*>(part);
  TPUSR_DISPATCH(launch_affine_act_grad, g, x, static_cast<const float*>(es),
                 static_cast<const float*>(eb), dx, fpart, P, C, bx,
                 grid_of(C, vec, bx, grid_x), leaky != 0, s)
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_partials(fpart, des, deb, grid_x, C, 1.0f, s));
}

// dx = (dm1 + 2 x dm2) * inv_n, plus g * act'(x * es + eb) * es unless g is
// null (es, eb are then not read).
int tpusr_moments_grad(int device, int dtype, const void* x, const void* g, const void* es,
                       const void* eb, const void* dm1, const void* dm2, void* dx, long long P,
                       int C, int vec, int bx, int grid_x, float inv_n, int leaky,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid(P, C, vec, bx, grid_x)) return static_cast<int>(cudaErrorInvalidValue);
  TPUSR_DISPATCH(launch_moments_grad, x, g, static_cast<const float*>(es),
                 static_cast<const float*>(eb), static_cast<const float*>(dm1),
                 static_cast<const float*>(dm2), dx, P, C, bx, grid_of(C, vec, bx, grid_x),
                 inv_n, leaky != 0, static_cast<cudaStream_t>(stream))
  return static_cast<int>(err);
}

}  // extern "C"
