// Fused 3x3 conv for the DIP skip network, written by hand for Hopper (sm_90a).
//
// Kernel A, fwd_kernel, replaces tpusr/ops/pallas_conv.py::_fwd_kernel:
//   y = conv3x3(act(x * es + eb)) [+ base], with optional per-block partial
//   [sum y, sum y^2] per output channel taken from the f32 values before the
//   store. Reflect halos map indices to real pixels BEFORE the prologue; zero
//   halos are exact zeros AFTER it, so eb never leaks into the halo. The same
//   kernel computes dgrad: it runs over the output cotangent with rotated,
//   transposed weights, zero padding, no prologue and no stats.
//
// Kernel B, wgrad_kernel, replaces pallas_conv.py::_wgrad_kernel:
//   dw[dy][dx][ci][co] = sum over pixels of pa_pad[h-1+dy][w-1+dx][ci] * G[h][w][co],
//   where pa_pad is the prologued, padded input recomputed from x with the
//   same halo rules as kernel A (no padded copy of x exists in memory). The
//   TPU kernel carried dw across its sequential grid; here blocks run in no
//   order, so each block owns a slice of rows and writes its own partial dw,
//   and the wrapper sums the partials in a second, deterministic pass.
//
// What bounds them on the H100: at the DIP shapes (128 -> 128 channels,
// 16^2 .. 512^2) a 3x3 conv does 2*9*128 = 2304 FLOPs per output element
// against 8 bytes moved, far above the card's ridge point, so both are
// bounded by operations. This first version does the arithmetic in f32 FMAs
// (67 TFLOP/s peak) rather than the tensor cores, so that f32 results match
// the plain PyTorch version to 1e-4. The design keeps the FMA units fed from
// shared memory: kernel A stages a (TH+2) x (TW+2) x KC input window and a
// 9 x KC x TCO weight slab per channel chunk and gives each thread an 8-pixel
// x 4-channel register tile (10 window reads + 3 float4 weight reads feed 96
// FMAs); kernel B slides a 3x3 window along a staged row so that 3 window
// reads + 1 float4 read of G feed 36 FMAs. Both accept every H, W >= 2 and
// every channel count; ragged tiles are masked. No float atomics anywhere:
// the stats and dw partials are reduced by the wrapper, so results are
// deterministic.
//
// Interface: plain C entry points (loaded with ctypes). They launch on the
// caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NTHREADS = 256;

// kernel A tiling
constexpr int TH = 8;    // output rows per block
constexpr int TW = 16;   // output columns per block
constexpr int TCO = 64;  // output channels per block
constexpr int KC = 16;   // input channels per shared-memory stage
constexpr int WIN_H = TH + 2;
constexpr int WIN_W = TW + 2;

// kernel B tiling
constexpr int WG_CI = 16;  // input channels per block (one per thread row)
constexpr int WG_CO = 64;  // output channels per block
constexpr int WG_PW = 64;  // pixels of one row staged at a time

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

// -1 -> 1 and n -> n-2; indices further out only feed outputs that are never
// stored, and the bounds check in load_act turns them into zeros.
__device__ __forceinline__ int reflect_idx(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// The prologued, padded input at (n, h, w, c) with h in [-1, H] and w in
// [-1, W], in f32 but rounded through T as the input dtype would hold it.
template <typename T>
__device__ __forceinline__ float load_act(const T* __restrict__ x, int n, int h, int w,
                                          int c, int H, int W, int C,
                                          const float* __restrict__ es,
                                          const float* __restrict__ eb, bool affine,
                                          bool leaky, bool reflect) {
  if (c >= C) return 0.f;
  if (reflect) {
    h = reflect_idx(h, H);
    w = reflect_idx(w, W);
  }
  if (h < 0 || h >= H || w < 0 || w >= W) return 0.f;  // zero halo, after the prologue
  float v = to_f32(x[(((size_t)n * H + h) * W + w) * C + c]);
  if (affine) v = v * es[c] + eb[c];
  if (leaky) v = v >= 0.f ? v : 0.2f * v;
  return to_f32(from_f32<T>(v));
}

// grid: (tiles_h * tiles_w, ceil(Cout / TCO), N); block: NTHREADS.
// x (N,H,W,Cin), w (3,3,Cin,Cout), base/y (N,H,W,Cout), part (N*tiles, 2, Cout).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const float* __restrict__ es, const float* __restrict__ eb,
           const T* __restrict__ base, T* __restrict__ y, float* __restrict__ part,
           int H, int W, int Cin, int Cout, int tiles_w, bool affine, bool leaky,
           bool reflect) {
  // +1 on the channel axis spreads the two pixel rows a warp reads over banks
  __shared__ float s_in[WIN_H][WIN_W][KC + 1];
  __shared__ __align__(16) float s_w[9][KC][TCO];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // pixels: row ty/2, columns (ty%2)*8 .. +7
  const int tile = blockIdx.x;
  const int n = blockIdx.z;
  const int h0 = (tile / tiles_w) * TH;
  const int w0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * TCO;
  const int pr = ty >> 1;
  const int pc = (ty & 1) * 8;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[j][o] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    for (int i = tid; i < WIN_H * WIN_W * KC; i += NTHREADS) {
      const int k = i % KC;
      const int p = i / KC;
      const int c = p % WIN_W;
      const int r = p / WIN_W;
      s_in[r][c][k] = load_act(x, n, h0 - 1 + r, w0 - 1 + c, c0 + k, H, W, Cin, es, eb,
                               affine, leaky, reflect);
    }
    for (int i = tid; i < 9 * KC * TCO; i += NTHREADS) {
      const int o = i % TCO;
      const int q = i / TCO;
      const int k = q % KC;
      const int t = q / KC;
      const int ci = c0 + k;
      const int co = co0 + o;
      s_w[t][k][o] = (ci < Cin && co < Cout)
                         ? to_f32(w[((size_t)t * Cin + ci) * Cout + co])
                         : 0.f;
    }
    __syncthreads();

    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float a[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) a[j] = s_in[pr + dy][pc + j][k];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(&s_w[dy * 3 + dx][k][tx * 4]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[j][0] = fmaf(a[j + dx], wv.x, acc[j][0]);
            acc[j][1] = fmaf(a[j + dx], wv.y, acc[j][1]);
            acc[j][2] = fmaf(a[j + dx], wv.z, acc[j][2]);
            acc[j][3] = fmaf(a[j + dx], wv.w, acc[j][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: + base in f32, store in T, stats from the f32 values
  float ssum[4] = {0.f, 0.f, 0.f, 0.f};
  float ssq[4] = {0.f, 0.f, 0.f, 0.f};
  const int h = h0 + pr;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int wc = w0 + pc + j;
    if (h >= H || wc >= W) continue;
    const size_t pix = (((size_t)n * H + h) * W + wc) * Cout;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int co = co0 + tx * 4 + o;
      if (co >= Cout) continue;
      float v = acc[j][o];
      if (base != nullptr) v += to_f32(base[pix + co]);
      y[pix + co] = from_f32<T>(v);
      ssum[o] += v;
      ssq[o] += v * v;
    }
  }

  if (part != nullptr) {  // uniform over the block
    float* red = &s_w[0][0][0];  // 16 x TCO x 2 floats; the main loop is done with s_w
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      red[(ty * TCO + tx * 4 + o) * 2 + 0] = ssum[o];
      red[(ty * TCO + tx * 4 + o) * 2 + 1] = ssq[o];
    }
    __syncthreads();
    if (tid < TCO && co0 + tid < Cout) {
      float s = 0.f, q = 0.f;
      for (int r = 0; r < 16; ++r) {
        s += red[(r * TCO + tid) * 2 + 0];
        q += red[(r * TCO + tid) * 2 + 1];
      }
      const size_t blk = (size_t)n * gridDim.x + tile;
      part[(blk * 2 + 0) * Cout + co0 + tid] = s;
      part[(blk * 2 + 1) * Cout + co0 + tid] = q;
    }
  }
}

// grid: (nslices, ceil(Cout / WG_CO), ceil(Cin / WG_CI)); block: NTHREADS.
// x (N,H,W,Cin), g (N,H,W,Cout), part (nslices, 9, Cin, Cout) f32.
// Slice s covers the flattened rows [s*rows, min((s+1)*rows, N*H)).
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
             const float* __restrict__ es, const float* __restrict__ eb,
             float* __restrict__ part, int N, int H, int W, int Cin, int Cout,
             int rows_per_slice, bool affine, bool leaky, bool reflect) {
  __shared__ float s_in[3][WG_PW + 2][WG_CI + 1];
  __shared__ __align__(16) float s_g[WG_PW][WG_CO];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // input channel ci0 + ty
  const int slice = blockIdx.x;
  const int co0 = blockIdx.y * WG_CO;
  const int ci0 = blockIdx.z * WG_CI;

  float acc[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[t][o] = 0.f;

  const int r0 = slice * rows_per_slice;
  const int r1 = min(r0 + rows_per_slice, N * H);
  for (int row = r0; row < r1; ++row) {
    const int n = row / H;
    const int h = row % H;
    for (int w0 = 0; w0 < W; w0 += WG_PW) {
      for (int i = tid; i < 3 * (WG_PW + 2) * WG_CI; i += NTHREADS) {
        const int k = i % WG_CI;
        const int p = i / WG_CI;
        const int c = p % (WG_PW + 2);
        const int r = p / (WG_PW + 2);
        s_in[r][c][k] = load_act(x, n, h - 1 + r, w0 - 1 + c, ci0 + k, H, W, Cin, es, eb,
                                 affine, leaky, reflect);
      }
      for (int i = tid; i < WG_PW * WG_CO; i += NTHREADS) {
        const int o = i % WG_CO;
        const int p = i / WG_CO;
        const int wc = w0 + p;
        const int co = co0 + o;
        s_g[p][o] = (wc < W && co < Cout)
                        ? to_f32(g[(((size_t)n * H + h) * W + wc) * Cout + co])
                        : 0.f;
      }
      __syncthreads();

      float a[3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        a[dy][0] = s_in[dy][0][ty];
        a[dy][1] = s_in[dy][1][ty];
      }
#pragma unroll 2
      for (int p = 0; p < WG_PW; ++p) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) a[dy][2] = s_in[dy][p + 2][ty];
        const float4 gv = *reinterpret_cast<const float4*>(&s_g[p][tx * 4]);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float v = a[dy][dx];
            acc[dy * 3 + dx][0] = fmaf(v, gv.x, acc[dy * 3 + dx][0]);
            acc[dy * 3 + dx][1] = fmaf(v, gv.y, acc[dy * 3 + dx][1]);
            acc[dy * 3 + dx][2] = fmaf(v, gv.z, acc[dy * 3 + dx][2]);
            acc[dy * 3 + dx][3] = fmaf(v, gv.w, acc[dy * 3 + dx][3]);
          }
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          a[dy][0] = a[dy][1];
          a[dy][1] = a[dy][2];
        }
      }
      __syncthreads();
    }
  }

  const int ci = ci0 + ty;
  if (ci >= Cin) return;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int co = co0 + tx * 4 + o;
      if (co < Cout) part[(((size_t)slice * 9 + t) * Cin + ci) * Cout + co] = acc[t][o];
    }
}

}  // namespace

extern "C" {

// device: the CUDA ordinal the tensors and the stream belong to.
// dtype: 0 = float32, 1 = bfloat16. es/eb may be null when affine == 0,
// base may be null, part is null when no stats are wanted.
int tpusr_conv3x3_fwd(int device, int dtype, const void* x, const void* w, const void* es,
                      const void* eb, const void* base, void* y, void* part, int N,
                      int H, int W, int Cin, int Cout, int affine, int leaky,
                      int reflect, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_h * tiles_w, (Cout + TCO - 1) / TCO, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fes = static_cast<const float*>(es);
  const float* feb = static_cast<const float*>(eb);
  float* fpart = static_cast<float*>(part);
  if (dtype == 0) {
    fwd_kernel<float><<<grid, NTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), fes, feb,
        static_cast<const float*>(base), static_cast<float*>(y), fpart, H, W, Cin, Cout,
        tiles_w, affine != 0, leaky != 0, reflect != 0);
  } else {
    fwd_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), fes,
        feb, static_cast<const __nv_bfloat16*>(base), static_cast<__nv_bfloat16*>(y),
        fpart, H, W, Cin, Cout, tiles_w, affine != 0, leaky != 0, reflect != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

int tpusr_conv3x3_wgrad(int device, int dtype, const void* x, const void* g, const void* es,
                        const void* eb, void* part, int N, int H, int W, int Cin,
                        int Cout, int rows_per_slice, int nslices, int affine,
                        int leaky, int reflect, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nslices, (Cout + WG_CO - 1) / WG_CO, (Cin + WG_CI - 1) / WG_CI);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fes = static_cast<const float*>(es);
  const float* feb = static_cast<const float*>(eb);
  float* fpart = static_cast<float*>(part);
  if (dtype == 0) {
    wgrad_kernel<float><<<grid, NTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), fes, feb, fpart, N, H,
        W, Cin, Cout, rows_per_slice, affine != 0, leaky != 0, reflect != 0);
  } else {
    wgrad_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), fes,
        feb, fpart, N, H, W, Cin, Cout, rows_per_slice, affine != 0, leaky != 0,
        reflect != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
