// One whole ESRGAN dense block, written by hand for Hopper (sm_90a).
//
// Kernel C, dense_block_kernel, replaces tpusr/ops/pallas_dense.py::_db_kernel:
//   c1 = lrelu(conv3x3(x) + b1)
//   c2 = lrelu(conv3x3([x, c1]) + b2)
//   c3 = lrelu(conv3x3([x, c1, c2]) + b3)
//   c4 = lrelu(conv3x3([x, c1, c2, c3]) + b4)
//   c5 = conv3x3([x, c1, c2, c3, c4]) + b5
//   y  = x + 0.2 * c5
// on NHWC x and y (N, H, W, 64), growth 32, LeakyReLU slope 0.2, zero-SAME
// halos at the image edges, in ONE launch: x is read once, y is written once,
// and the four 32-channel intermediates c1..c4 never leave shared memory.
// Accumulation is f32 for f32 and bf16 inputs; in bf16, c1..c4 are rounded
// to bf16 where they are stored and the weights are rounded to bf16 as they
// are staged (the JAX kernel casts its packed weights to the input dtype).
//
// Design: halo recompute. The TPU kernel walked rows through ring buffers on
// a sequential grid; CUDA blocks run in no order, so each block here owns an
// 8 x 8 output tile and computes every stage it needs from scratch:
//   x  on 18 x 18 pixels (5-pixel halo: five chained 3x3 convs),
//   c1 on 16 x 16, c2 on 14 x 14, c3 on 12 x 12, c4 on 10 x 10,
//   c5 and y on the 8 x 8 tile.
// Shared memory, all f32 (bf16 values are held exactly in f32):
//   x 18*18*65 + c1..c4 (16^2 + 14^2 + 12^2 + 10^2)*33 floats = 172 KB,
//   one weight stage 9 x 16 x 64 floats = 36 KB; 212,976 bytes in all, one
//   block per SM. The channel strides 65 and 33 spread a warp's reads over
//   the banks. Pixels of a stage outside the image are stored as exact zeros,
//   which is the zero padding the next conv needs.
// Recompute: the useful work is 239,616 multiply-adds per output pixel; the
// tile does 423,936 (1.77x), the price of keeping c1..c4 on chip with no
// ordering between blocks.
//
// What bounds it on the H100: 2 * 239,616 FLOPs per pixel against 512 bytes
// in and out (f32): far above the ridge point, so it is bounded by
// operations. This first version uses f32 FMAs (67 TFLOP/s peak), not the
// tensor cores. Each stage loops over 16-channel chunks of its concatenated
// input; a chunk's 9 x 16 x Cout weight slab (the 958 KB of weights per
// block do not fit in shared memory) is staged in shared memory while the
// next chunk's slab is already being fetched into registers. Each thread
// owns a register tile of PX pixels of one row by 4 output channels
// (PX = 8, 7, 6, 5, 4 for stages 1..5): PX + 2 activation reads and 3 float4
// weight reads feed 12 * PX FMAs.
//
// Interface: a plain C entry point (loaded with ctypes). It launches on the
// caller's stream, allocates nothing, uses no atomics (each output is written
// by one thread, so results are deterministic), and returns the CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NF = 64;    // trunk width
constexpr int GC = 32;    // growth
constexpr int TILE = 8;   // output tile edge
constexpr int HALO = 5;   // five chained 3x3 convs
constexpr int XW = TILE + 2 * HALO;
constexpr int KC = 16;    // input channels per weight stage
constexpr int NTHREADS = 256;
constexpr int XS = NF + 1;  // channel stride of x in shared memory
constexpr int CS = GC + 1;  // channel stride of c1..c4

// width of c_k's region (k = 1..4): 16, 14, 12, 10
constexpr int cw(int k) { return TILE + 2 * (HALO - k); }

constexpr int OFF_W = 0;
constexpr int OFF_X = OFF_W + 9 * KC * NF;
constexpr int OFF_C1 = OFF_X + XW * XW * XS;
constexpr int OFF_C2 = OFF_C1 + cw(1) * cw(1) * CS;
constexpr int OFF_C3 = OFF_C2 + cw(2) * cw(2) * CS;
constexpr int OFF_C4 = OFF_C3 + cw(3) * cw(3) * CS;
constexpr int SMEM_FLOATS = OFF_C4 + cw(4) * cw(4) * CS;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);
static_assert(SMEM_BYTES <= 232448, "over the H100's shared memory per block");

struct Params {
  const float* k[5];  // HWIO (3, 3, 64 + 32 * (s - 1), 32 or 64), f32
  const float* b[5];  // (32,) x 4 and (64,), f32
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v as the storage type T holds it
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// shared-memory offset of c_{j+1}
__device__ __forceinline__ int c_off(int j) {
  return j == 0 ? OFF_C1 : j == 1 ? OFF_C2 : j == 2 ? OFF_C3 : OFF_C4;
}

// Stage S (1..5) of the block: c_S on its (TILE + 2 (5 - S))^2 region, or,
// for S = 5, y on the tile. Every thread of the block must call it (it
// synchronises); thread tid owns item tid: row, pixel half g, channel group.
template <typename T, int S>
__device__ __forceinline__ void stage(const Params& p, float* __restrict__ smem, int n,
                                      int h0, int w0, int H, int W, T* __restrict__ y) {
  constexpr int HO = HALO - S;      // halo of this stage's region
  constexpr int R = TILE + 2 * HO;  // region edge
  constexpr int PX = R / 2;         // pixels per item (two items per row)
  constexpr int CO = S < 5 ? GC : NF;
  constexpr int CG = CO / 4;
  constexpr int CIN = NF + GC * (S - 1);
  constexpr int NCH = CIN / KC;
  constexpr int NITEMS = R * 2 * CG;
  constexpr int SLAB = 9 * KC * CO;
  constexpr int WPT = SLAB / NTHREADS;  // slab floats each thread fetches
  static_assert(NITEMS <= NTHREADS, "one item per thread");
  static_assert(SLAB % NTHREADS == 0, "slab splits evenly over the threads");

  const int tid = threadIdx.x;
  const bool active = tid < NITEMS;
  const int cg = tid % CG;
  const int g = (tid / CG) % 2;
  const int row = tid / (2 * CG);
  const float* __restrict__ wk = p.k[S - 1];
  float* __restrict__ s_w = smem + OFF_W;

  float acc[PX][4];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[j][o] = 0.f;

  // slab element idx = (t * KC + k) * CO + o holds w[t][ci0 + k][o]
  float pre[WPT];
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    const int idx = tid + i * NTHREADS;
    const int o = idx % CO;
    const int k = (idx / CO) % KC;
    const int t = idx / (CO * KC);
    pre[i] = wk[((size_t)t * CIN + k) * CO + o];
  }

  for (int ch = 0; ch < NCH; ++ch) {
    __syncthreads();  // the previous chunk (or stage) is done with s_w and wrote its c
#pragma unroll
    for (int i = 0; i < WPT; ++i) s_w[tid + i * NTHREADS] = round_to<T>(pre[i]);
    __syncthreads();
    if (ch + 1 < NCH) {  // next slab into registers while this one is used
      const int ci0 = (ch + 1) * KC;
#pragma unroll
      for (int i = 0; i < WPT; ++i) {
        const int idx = tid + i * NTHREADS;
        const int o = idx % CO;
        const int k = (idx / CO) % KC;
        const int t = idx / (CO * KC);
        pre[i] = wk[((size_t)t * CIN + ci0 + k) * CO + o];
      }
    }
    if (active) {
      // the chunk's source: x (channels 0..63) or c_{j+1} (64 + 32 j ..)
      const int ci0 = ch * KC;
      const float* src;
      int hs, cs, coff;
      if (ci0 < NF) {
        src = smem + OFF_X;
        hs = HALO;
        cs = XS;
        coff = ci0;
      } else {
        const int j = (ci0 - NF) / GC;
        src = smem + c_off(j);
        hs = HALO - 1 - j;
        cs = CS;
        coff = (ci0 - NF) % GC;
      }
      const int sw = TILE + 2 * hs;   // source region edge
      const int off = hs - HO - 1;    // >= 0: sources have the wider halo
      const float* a0 = src + ((row + off) * sw + g * PX + off) * cs + coff;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* ar = a0 + dy * sw * cs;
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
          float a[PX + 2];
#pragma unroll
          for (int j = 0; j < PX + 2; ++j) a[j] = ar[j * cs + k];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4 wv =
                *reinterpret_cast<const float4*>(s_w + ((dy * 3 + dx) * KC + k) * CO + cg * 4);
#pragma unroll
            for (int j = 0; j < PX; ++j) {
              acc[j][0] = fmaf(a[j + dx], wv.x, acc[j][0]);
              acc[j][1] = fmaf(a[j + dx], wv.y, acc[j][1]);
              acc[j][2] = fmaf(a[j + dx], wv.z, acc[j][2]);
              acc[j][3] = fmaf(a[j + dx], wv.w, acc[j][3]);
            }
          }
        }
      }
    }
  }

  if (!active) return;
  const float* __restrict__ bias = p.b[S - 1];
  if constexpr (S < 5) {
    // c_S, zero outside the image (the next conv's zero padding)
    float* dst = smem + c_off(S - 1);
    const int gh = h0 - HO + row;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int col = g * PX + j;
      const int gw = w0 - HO + col;
      const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int co = cg * 4 + o;
        float v = acc[j][o] + bias[co];
        v = v >= 0.f ? v : 0.2f * v;
        dst[(row * R + col) * CS + co] = inside ? round_to<T>(v) : 0.f;
      }
    }
  } else {
    const int gh = h0 + row;
    if (gh >= H) return;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int col = g * PX + j;
      const int gw = w0 + col;
      if (gw >= W) continue;
      const float* xs = smem + OFF_X + ((row + HALO) * XW + col + HALO) * XS;
      T* out = y + (((size_t)n * H + gh) * W + gw) * NF;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int co = cg * 4 + o;
        out[co] = from_f32<T>(xs[co] + 0.2f * (acc[j][o] + bias[co]));
      }
    }
  }
}

// grid: (ceil(H / 8) * ceil(W / 8), N); block: NTHREADS; SMEM_BYTES dynamic.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
dense_block_kernel(const T* __restrict__ x, Params p, T* __restrict__ y, int H, int W,
                   int tiles_w) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x;
  const int n = blockIdx.y;
  const int h0 = (tile / tiles_w) * TILE;
  const int w0 = (tile % tiles_w) * TILE;

  float* sx = smem + OFF_X;
  for (int i = threadIdx.x; i < XW * XW * NF; i += NTHREADS) {
    const int k = i % NF;
    const int q = i / NF;
    const int gh = h0 - HALO + q / XW;
    const int gw = w0 - HALO + q % XW;
    float v = 0.f;
    if (gh >= 0 && gh < H && gw >= 0 && gw < W)
      v = to_f32(x[(((size_t)n * H + gh) * W + gw) * NF + k]);
    sx[q * XS + k] = v;
  }

  stage<T, 1>(p, smem, n, h0, w0, H, W, y);
  stage<T, 2>(p, smem, n, h0, w0, H, W, y);
  stage<T, 3>(p, smem, n, h0, w0, H, W, y);
  stage<T, 4>(p, smem, n, h0, w0, H, W, y);
  stage<T, 5>(p, smem, n, h0, w0, H, W, y);
}

template <typename T>
cudaError_t launch(const void* x, const Params& p, void* y, int N, int H, int W,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      dense_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TILE - 1) / TILE;
  const int tiles_h = (H + TILE - 1) / TILE;
  const dim3 grid(tiles_w * tiles_h, N);
  dense_block_kernel<T><<<grid, NTHREADS, SMEM_BYTES, s>>>(
      static_cast<const T*>(x), p, static_cast<T*>(y), H, W, tiles_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of the tensors and the stream.
// dtype: 0 = float32, 1 = bfloat16 (x and y). k1..k5 are the canonical HWIO
// kernels and b1..b5 the biases, all contiguous f32.
int tpusr_dense_block(int device, int dtype, const void* x, const void* k1, const void* k2,
                      const void* k3, const void* k4, const void* k5, const void* b1,
                      const void* b2, const void* b3, const void* b4, const void* b5,
                      void* y, int N, int H, int W, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p = {{static_cast<const float*>(k1), static_cast<const float*>(k2),
                     static_cast<const float*>(k3), static_cast<const float*>(k4),
                     static_cast<const float*>(k5)},
                    {static_cast<const float*>(b1), static_cast<const float*>(b2),
                     static_cast<const float*>(b3), static_cast<const float*>(b4),
                     static_cast<const float*>(b5)}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? launch<float>(x, p, y, N, H, W, s)
                   : launch<__nv_bfloat16>(x, p, y, N, H, W, s);
  return static_cast<int>(err);
}

}  // extern "C"
