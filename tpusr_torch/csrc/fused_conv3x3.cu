// Fused 3x3 conv for the DIP skip network and the SRGAN/RRDB generators,
// written by hand for Hopper (sm_90a), on the tensor cores.
//
// Kernel A replaces tpusr/ops/pallas_conv.py::_fwd_kernel:
//   y = conv3x3(act(x * es + eb)) [+ base], with optional per-tile partial
//   [sum y, sum y^2] per output channel taken from the f32 values before the
//   store. Reflect halos map indices to real pixels BEFORE the prologue; zero
//   halos are exact zeros AFTER it, so eb never leaks into the halo. The
//   prologue runs in f32 and is rounded once to the input dtype. The same
//   kernel computes dgrad: it runs over the output cotangent with rotated,
//   transposed weights, zero padding, no prologue and no stats.
// Kernel B replaces pallas_conv.py::_wgrad_kernel (and computes the function
// of tools/bench_wgrad.py::_wgrad_kernel_t, a bench-only variant of it):
//   dw[dy][dx][ci][co] = sum over pixels of pa_pad[h-1+dy][w-1+dx][ci] * G[h][w][co],
//   where pa_pad is the prologued, padded input recomputed from x with the
//   same halo rules as kernel A (no padded copy of x exists in memory). The
//   TPU kernel carried dw across its sequential grid; here blocks run in no
//   order, so each block owns a slice of rows of one image (split-K) and
//   writes its own partial dw, and the wrapper sums the partials with one
//   torch.sum. The stats partials are per tile too: no float atomics, so
//   results are deterministic.
//
// What bounds them on the H100: a 3x3 conv at the main paths' widths (64 or
// 128 channels) does 2*9*Cin = 1152 to 2304 FLOPs per output element against
// 4 to 8 bytes moved, above the card's ridge point, so both are bounded by
// the tensor cores (989 TFLOP/s bf16; 495 TF32, so 165 for the three TF32
// products that f32 accuracy takes), except kernel A at 64 -> 64 on a 2K
// frame, which is near its bytes. The TPU kernel ran 9 matmuls on the MXU
// with f32 accumulation; the design here does the same on Hopper's units:
//
//   bf16: implicit GEMM on wgmma (m64nNk16, f32 accumulators). A block
//   stages the (TH+2) x (TW+2) halo window of one 16-channel chunk in shared
//   memory in 8-channel core-matrix order [c/8][row][col][8 ch], 16 bytes
//   per pixel, so the 9 taps are 9 matrix descriptors into the same window:
//   tap (dy, dx) starts at window pixel (dy, dx), a core matrix is 8 pixels
//   of one window row (128 contiguous bytes), the next core matrix along M
//   is one window row on (SBO) and along K the next channel plane (LBO). No
//   im2col. Kernel A: a 16 x 16 output tile, four warpgroups, each 8 x 8
//   output pixels (M = 64) by N = 64 or 128 output channels (N = 128 past 64
//   outputs); the weights, (9 x Cin) x N, are an N-major B operand. The
//   grid is persistent (one wave, each block walking a list of tiles) and
//   keeps the whole weight slab in shared memory where it fits (up to 160
//   KB), else restages each chunk's slab. Kernel B: dw_t = A_t^T G with M =
//   Cin (64), K = pixels, N = Cout (64); A_t^T is the same window read
//   M-major, the dx shift again a 16-byte offset, and G the N-major B
//   operand; three warpgroups, one per kernel row dy, each holding its three
//   taps (96 accumulator registers a thread).
//   Both keep three steps in flight: the copies of step s + 2 (cp.async,
//   zero-filled for halos and channels past Cin) are issued while step s's
//   wgmmas run, and each thread applies the prologue in place, in f32,
//   rounded once to bf16, to its own copies of step s + 1 when they land.
//   Measured on the card, what bounds them is the latency of those loads,
//   not the tensor cores: without the wgmmas kernel A takes about as long.
//
//   f32: 3xTF32 on mma.sync.m16n8k8. Each operand is split once while it is
//   staged, big = tf32(a), small = tf32(a - big), and each product is
//   accumulated in f32 as small*big + big*small + big*big: about 2^-21
//   relative per product, where plain TF32 keeps 2^-11. mma.sync loads its
//   fragments at per-lane addresses, so the dx shift needs no alignment
//   (wgmma takes tf32 only K-major from 16-byte-aligned starts, which a
//   4-byte shift breaks). Shared-memory strides are chosen so that every
//   fragment load is free of bank conflicts. Kernel A stages each chunk in
//   one buffer (16 warps a block); kernel B keeps three steps in flight as
//   the bf16 kernels do, splitting its own landed copies in place. The
//   tensor cores' f32 accumulation adds about 2^-24 per product, so the
//   wrapper keeps kernel B's slices short in f32.
//
// Every N, H, W >= 2 (>= 1 with zero pad) and every channel count is taken:
// channels that do not fill a tile are zero-filled in shared memory, ragged
// tiles are masked. 16-byte vector loads are used when the channel counts
// and pointers allow, element loads otherwise.
//
// Interface: plain C entry points (loaded with ctypes). They launch on the
// caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// kernel A's output tile, both dtypes (the wrapper sizes the stats
// partials from it: one partial per tile)
constexpr int TH = 16;  // output rows per block
constexpr int TW = 16;  // output columns per block
constexpr int WIN_H = TH + 2;
constexpr int WIN_W = TW + 2;
constexpr int WIN_PIX = WIN_H * WIN_W;

// kernel A, bf16 (wgmma)
constexpr int A16_THREADS = 512;  // four warpgroups, 8 x 8 pixels each
constexpr int A16_KC = 16;        // input channels per stage (k16 steps of 16)
constexpr int A16_PL = A16_KC / 8;  // 8-channel planes per stage
constexpr int A16_STAGES = 3;     // steps in flight: copies issued two steps ahead

// kernel A, f32 (3xTF32)
constexpr int A32_THREADS = 512;  // 16 warps: 8 (two output rows each) x 2 (32 channels)
constexpr int A32_KC = 16;        // input channels per stage
constexpr int A32_TCO = 64;       // output channels per block
constexpr int A32_PLANE = 328;    // window channel-plane stride, = 8 mod 32
constexpr int A32_WS = 72;        // weight row stride, = 8 mod 32

// kernel B, both dtypes: a block owns 64 input x 64 output channels of one
// slice of rows, three groups of 4 warps (one per kernel row dy)
constexpr int WG_THREADS = 384;
constexpr int WG_CI = 64;
constexpr int WG_CO = 64;
constexpr int WG_R = 2;          // output rows per step
constexpr int B16_PW = 64;       // pixels of a row per step, bf16
constexpr int B16_STAGES = 3;    // steps in flight: copies issued two steps ahead
constexpr int B16_WPIX = (WG_R + 2) * (B16_PW + 2) + 1;  // window plane, +1 pixel
constexpr int B16_GPIX = WG_R * B16_PW + 1;              // G plane, +1 pixel
constexpr int B32_PW = 16;       // pixels of a row per step, f32
constexpr int B32_STAGES = 3;    // steps in flight: copies issued two steps ahead
constexpr int B32_WPIX = (WG_R + 2) * (B32_PW + 2);
constexpr int B32_CS = 72;       // channel stride of a staged pixel, = 8 mod 32

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

// -1 -> 1 and n -> n-2; indices further out only feed outputs that are never
// stored (or G rows that are zero), and the bounds check turns them into zeros.
__device__ __forceinline__ int reflect_idx(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// The source pixel of padded position (h, w), or -1 where the halo is zero.
__device__ __forceinline__ long long src_pixel(int n, int h, int w, int H, int W,
                                               bool reflect) {
  if (reflect) {
    h = reflect_idx(h, H);
    w = reflect_idx(w, W);
  }
  if (h < 0 || h >= H || w < 0 || w >= W) return -1;
  return ((long long)n * H + h) * W + w;
}

__device__ __forceinline__ float prologue(float v, const float* __restrict__ es,
                                          const float* __restrict__ eb, int c,
                                          bool affine, bool leaky) {
  if (affine) v = v * es[c] + eb[c];
  if (leaky) v = v >= 0.f ? v : 0.2f * v;
  return v;
}

// The prologue of 8 raw bf16 channels [c, c+8) (all < C), rounded to bf16.
__device__ __forceinline__ uint4 act8_from_raw(uint4 raw, int c, const float* __restrict__ es,
                                               const float* __restrict__ eb, bool affine,
                                               bool leaky) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 out;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p2[j]);
    o2[j] = __floats2bfloat162_rn(prologue(f.x, es, eb, c + 2 * j, affine, leaky),
                                  prologue(f.y, es, eb, c + 2 * j + 1, affine, leaky));
  }
  return out;
}

// 8 channels [c, c+8) of one padded pixel by element loads (for channel
// counts or pointers that 16-byte copies cannot take), prologued in f32,
// rounded to bf16, packed for one 16-byte shared store. Channels >= C and
// zero halos are 0.
__device__ __forceinline__ uint4 act8_bf16(const bf16* __restrict__ x, long long pix,
                                           int c, int C, const float* __restrict__ es,
                                           const float* __restrict__ eb, bool affine,
                                           bool leaky) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = pix >= 0 && c + j < C
               ? prologue(bf2f(x[pix * C + c + j]), es, eb, c + j, affine, leaky)
               : 0.f;
  uint4 out;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) o2[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return out;
}

// 4 channels [c, c+4) of one padded pixel in f32, prologued (zero halos and
// channels >= C are 0).
__device__ __forceinline__ float4 act4_f32(const float* __restrict__ x, long long pix,
                                           int c, int C, const float* __restrict__ es,
                                           const float* __restrict__ eb, bool affine,
                                           bool leaky, bool vec) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (pix >= 0 && c < C) {
    const float* src = x + pix * C + c;
    if (vec) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(src));
      v[0] = r.x;
      v[1] = r.y;
      v[2] = r.z;
      v[3] = r.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = c + j < C ? src[j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = c + j < C ? prologue(v[j], es, eb, c + j, affine, leaky) : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// 4 values [c, c+4) of a row of a (rows x C) f32 matrix; zero where c >= C
// or where the row is out of range (ok == false).
__device__ __forceinline__ float4 load4_f32(const float* __restrict__ p, bool ok, int c,
                                            int C, bool vec) {
  if (!ok || c >= C) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) return __ldg(reinterpret_cast<const float4*>(p + c));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = c + j < C ? p[c + j] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// 16 bytes global -> shared, asynchronously; the bytes past `bytes` are
// zero-filled (bytes = 0: a zero fill that reads nothing)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// 8 bf16 values [c, c+8) of a row of a (rows x C) matrix into shared memory:
// cp.async (zero-filled when out of range) when vec, element loads otherwise.
__device__ __forceinline__ void stage8_bf16(bf16* dst, const bf16* __restrict__ row,
                                            bool ok, int c, int C, bool vec) {
  const bool in = ok && c < C;
  if (vec) {
    cp_async16((uint32_t)__cvta_generic_to_shared(dst), in ? row + c : row, in ? 16 : 0);
  } else {
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = in && c + j < C ? row[c + j] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest N committed groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across wgmma
template <int NR>
__device__ __forceinline__ void fence_acc(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, LBO (stride
// between core matrices along K) and SBO (along M or N), all in bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// bf16 x bf16 -> f32, A and B from shared memory; TA / TB = 1 for an M- or
// N-major operand, 0 for a K-major one.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[32], uint64_t da, uint64_t db) {
  wgmma_m64n64k16<TA, TB>(d, da, db, 1);
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t da, uint64_t db) {
  wgmma_m64n128k16<TA, TB>(d, da, db, 1);
}

// The TF32 part of v (cvt.rna, low 13 bits zero): v = big + small exactly,
// and tf32(small) carries the next 11 bits.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xffffe000u);
}

__device__ __forceinline__ void split_tf32(float v, float& big, float& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - big);
}

__device__ __forceinline__ void split_store4(float* big, float* small, float4 v) {
  float4 b, s;
  split_tf32(v.x, b.x, s.x);
  split_tf32(v.y, b.y, s.y);
  split_tf32(v.z, b.z, s.z);
  split_tf32(v.w, b.w, s.w);
  *reinterpret_cast<float4*>(big) = b;
  *reinterpret_cast<float4*>(small) = s;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32 from the split operands
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

__device__ __forceinline__ float warp_sum_over_rows(float v) {
  // lanes 4 apart hold the same columns of other rows
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// ---------------------------------------------------------------- kernel A
// grid: (blocks, ceil(Cout / TCO)); block: A16_THREADS. Persistent: block b
// computes tiles b, b + gridDim.x, ... of all N images (tile T is tile
// T % tiles of image T / tiles). x (N,H,W,Cin), w (3,3,Cin,Cout), base/y
// (N,H,W,Cout), part (N*tiles, 2, Cout).
// Shared: window [A16_STAGES][A16_PL][WIN_PIX][8]; weights, RESIDENT: all of
// the block's (9 x Cin) x TCO, staged once, [chunk][9][A16_PL][TCO/8][8][8],
// else [A16_STAGES][9][A16_PL][TCO/8][8][8] staged with each step; then the
// stats scratch [warp][TCO][2] f32.
template <int TCO, bool RESIDENT>
__global__ void __launch_bounds__(A16_THREADS)
fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ es, const float* __restrict__ eb,
                const bf16* __restrict__ base, bf16* __restrict__ y,
                float* __restrict__ part, int H, int W, int Cin, int Cout, int tiles,
                int tiles_w, int total_tiles, bool affine, bool leaky, bool reflect,
                bool vec_x, bool vec_w) {
  constexpr int WIN_ELEMS = A16_PL * WIN_PIX * 8;
  constexpr int WT_ELEMS = 9 * A16_KC * TCO;  // one chunk's weights
  constexpr int NB = TCO / 8;
  constexpr int NWARP = A16_THREADS / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int nchunks = (Cin + A16_KC - 1) / A16_KC;
  bf16* s_win = reinterpret_cast<bf16*>(smem);
  bf16* s_wt = s_win + A16_STAGES * WIN_ELEMS;
  float* red = reinterpret_cast<float*>(s_wt + (RESIDENT ? nchunks : A16_STAGES) * WT_ELEMS);

  const int tid = threadIdx.x;
  const int wg = tid / 128;         // warpgroup: rows 8(wg/2) .. +7, columns 8(wg%2) .. +7
  const int wq = (tid % 128) / 32;  // warp in the warpgroup: its rows 2wq, 2wq+1
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int co0 = blockIdx.y * TCO;
  const int ntiles = total_tiles > (int)blockIdx.x
                         ? (total_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                         : 0;
  const int nsteps = ntiles * nchunks;

  auto stage_weights = [&](int chunk, bf16* wt) {
    const int c0 = chunk * A16_KC;
    // u runs over [tap][k/8][n/8][k%8]: neighbouring lanes fill one core
    // matrix, 16 contiguous bytes each, and read 8 weight rows 64
    // contiguous bytes at a time
    for (int u = tid; u < 9 * A16_KC * NB; u += A16_THREADS) {
      const int nb = (u / 8) % NB;
      const int k = (u / (8 * NB)) % A16_PL * 8 + u % 8;
      const int t = u / (8 * NB * A16_PL);
      const int ci = c0 + k;
      stage8_bf16(wt + u * 8, w + ((size_t)t * Cin + (ci < Cin ? ci : 0)) * Cout, ci < Cin,
                  co0 + nb * 8, Cout, vec_w);
    }
  };
  // step s: chunk s % nchunks of this block's tile s / nchunks. Window
  // unit u is 8 channels of one window pixel; neighbouring lanes take the
  // planes of a pixel.
  constexpr int UNITS = A16_PL * WIN_PIX;
  auto unit_src = [&](int step, int u, long long& pix, int& c) {
    const int T = blockIdx.x + (step / nchunks) * gridDim.x;
    const int n = T / tiles, tile = T % tiles;
    const int q = u / A16_PL;
    pix = src_pixel(n, tile / tiles_w * TH - 1 + q / WIN_W, tile % tiles_w * TW - 1 + q % WIN_W,
                    H, W, reflect);
    c = (step % nchunks) * A16_KC + 8 * (u % A16_PL);
  };
  auto unit_dst = [&](int buf, int u) {
    return s_win + buf * WIN_ELEMS + ((u % A16_PL) * WIN_PIX + u / A16_PL) * 8;
  };
  // start the copies of a step: the window's raw bytes (zero-filled halo
  // and channels >= Cin) and, unless resident, the chunk's weights
  auto issue = [&](int step, int buf) {
    if (vec_x)
      for (int u = tid; u < UNITS; u += A16_THREADS) {
        long long pix;
        int c;
        unit_src(step, u, pix, c);
        const bool in = pix >= 0 && c < Cin;
        cp_async16((uint32_t)__cvta_generic_to_shared(unit_dst(buf, u)),
                   in ? x + pix * Cin + c : x, in ? 16 : 0);
      }
    if (!RESIDENT) stage_weights(step % nchunks, s_wt + buf * WT_ELEMS);
  };
  // once a thread's own copies of a step have landed: the prologue in
  // place (zeros stay zeros), or, without vector loads, the whole unit
  auto finish = [&](int step, int buf) {
    if (vec_x && !affine && !leaky) return;
    for (int u = tid; u < UNITS; u += A16_THREADS) {
      long long pix;
      int c;
      unit_src(step, u, pix, c);
      uint4* dst = reinterpret_cast<uint4*>(unit_dst(buf, u));
      if (!vec_x)
        *dst = act8_bf16(x, pix, c, Cin, es, eb, affine, leaky);
      else if (pix >= 0 && c < Cin)
        *dst = act8_from_raw(*dst, c, es, eb, affine, leaky);
    }
  };

  float acc[TCO / 2];
#pragma unroll
  for (int i = 0; i < TCO / 2; ++i) acc[i] = 0.f;

  // cp.async group j holds step j's copies (and group 0 the resident weights)
  if (RESIDENT && ntiles > 0)
    for (int c = 0; c < nchunks; ++c) stage_weights(c, s_wt + c * WT_ELEMS);
#pragma unroll
  for (int j = 0; j < A16_STAGES - 1; ++j) {
    if (j < nsteps) issue(j, j);
    cp_async_commit();
  }
  cp_async_wait<A16_STAGES - 2>();
  if (nsteps > 0) finish(0, 0);
  fence_proxy_async();
  __syncthreads();
  const bool pair = (Cout & 1) == 0;
  for (int s = 0; s < nsteps; ++s) {
    const int buf = s % A16_STAGES, chunk = s % nchunks;
    const uint32_t a_base = (uint32_t)__cvta_generic_to_shared(s_win + buf * WIN_ELEMS);
    const uint32_t b_base =
        (uint32_t)__cvta_generic_to_shared(s_wt + (RESIDENT ? chunk : buf) * WT_ELEMS);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int ks = 0; ks < A16_KC / 16; ++ks) {
        const int dy = t / 3, dx = t % 3;
        // A: pixels (K-major), core matrix = 8 pixels of a window row
        const uint64_t da = gmma_desc(
            a_base + (2 * ks * WIN_PIX + (8 * (wg / 2) + dy) * WIN_W + 8 * (wg % 2) + dx) * 16,
            WIN_PIX * 16, WIN_W * 16);
        // B: weights (N-major), core matrix = 8 channels x 8 outputs
        const uint64_t db = gmma_desc(b_base + (t * A16_PL + 2 * ks) * NB * 128, NB * 128, 128);
        wgmma_tile<0, 1>(acc, da, db);
      }
    wgmma_commit();
    // into the buffer of step s - 1, whose wgmmas were waited for last round
    const int ahead = s + A16_STAGES - 1;
    if (ahead < nsteps) issue(ahead, ahead % A16_STAGES);
    cp_async_commit();
    wgmma_wait_all();
    fence_acc(acc);

    if (chunk == nchunks - 1) {
      // epilogue of tile T on the accumulator fragments: acc[4j + 2i + e] is
      // output row 8(wg/2) + 2wq + i, column 8(wg%2) + lane/4, channel
      // co0 + 8j + 2(lane%4) + e
      const int T = blockIdx.x + (s / nchunks) * gridDim.x;
      const int n = T / tiles, tile = T % tiles;
      const int h0 = tile / tiles_w * TH, w0 = tile % tiles_w * TW;
      const int pc = w0 + 8 * (wg % 2) + lane / 4;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int co = co0 + 8 * j + 2 * (lane % 4);
        float sm[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int pr = h0 + 8 * (wg / 2) + 2 * wq + i;
          if (pr >= H || pc >= W || co >= Cout) continue;
          const size_t off = (((size_t)n * H + pr) * W + pc) * Cout + co;
          float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
          if (pair) {
            if (base != nullptr) {
              const float2 b =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(base + off));
              v0 += b.x;
              v1 += b.y;
            }
            *reinterpret_cast<__nv_bfloat162*>(y + off) = __floats2bfloat162_rn(v0, v1);
            sm[1] += v1;
            sq[1] += v1 * v1;
          } else {
            if (base != nullptr) v0 += bf2f(base[off]);
            y[off] = __float2bfloat16(v0);
            if (co + 1 < Cout) {
              if (base != nullptr) v1 += bf2f(base[off + 1]);
              y[off + 1] = __float2bfloat16(v1);
              sm[1] += v1;
              sq[1] += v1 * v1;
            }
          }
          sm[0] += v0;
          sq[0] += v0 * v0;
        }
        if (part != nullptr) {  // uniform over the block
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sm[e] = warp_sum_over_rows(sm[e]);
            sq[e] = warp_sum_over_rows(sq[e]);
          }
          if (lane < 4) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              red[(warp * TCO + 8 * j + 2 * lane + e) * 2 + 0] = sm[e];
              red[(warp * TCO + 8 * j + 2 * lane + e) * 2 + 1] = sq[e];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TCO / 2; ++i) acc[i] = 0.f;
      if (part != nullptr) {
        __syncthreads();
        if (tid < TCO && co0 + tid < Cout) {
          float sum = 0.f, sumsq = 0.f;
          for (int r = 0; r < NWARP; ++r) {
            sum += red[(r * TCO + tid) * 2 + 0];
            sumsq += red[(r * TCO + tid) * 2 + 1];
          }
          part[((size_t)T * 2 + 0) * Cout + co0 + tid] = sum;
          part[((size_t)T * 2 + 1) * Cout + co0 + tid] = sumsq;
        }
      }
    }
    cp_async_wait<A16_STAGES - 2>();  // this thread's copies of step s + 1
    if (s + 1 < nsteps) finish(s + 1, (s + 1) % A16_STAGES);
    fence_proxy_async();
    __syncthreads();
  }
}

// grid: (tiles_h * tiles_w, ceil(Cout / A32_TCO), N); block: A32_THREADS.
// Shared (one buffer): window big/small [A32_KC][A32_PLANE], weights
// big/small [9][A32_KC][A32_WS].
__global__ void __launch_bounds__(A32_THREADS, 1)
fwd_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ es, const float* __restrict__ eb,
                const float* __restrict__ base, float* __restrict__ y,
                float* __restrict__ part, int H, int W, int Cin, int Cout, int tiles_w,
                bool affine, bool leaky, bool reflect, bool vec_x, bool vec_w) {
  extern __shared__ __align__(16) float smf[];
  float* win_b = smf;
  float* win_s = win_b + A32_KC * A32_PLANE;
  float* wt_b = win_s + A32_KC * A32_PLANE;
  float* wt_s = wt_b + 9 * A32_KC * A32_WS;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp / 2;  // output rows 2wm, 2wm+1 (one m16 tile each)
  constexpr int NROWG = A32_THREADS / 64;  // warps along the rows
  const int wn = warp % 2;  // output channels wn*32 .. +31 (four n8 tiles)
  const int tile = blockIdx.x;
  const int n = blockIdx.z;
  const int h0 = (tile / tiles_w) * TH;
  const int w0 = (tile % tiles_w) * TW;
  const int co0 = blockIdx.y * A32_TCO;

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += A32_KC) {
    for (int u = tid; u < WIN_PIX * (A32_KC / 4); u += A32_THREADS) {
      const int grp = u % (A32_KC / 4), q = u / (A32_KC / 4);
      const long long pix = src_pixel(n, h0 - 1 + q / WIN_W, w0 - 1 + q % WIN_W, H, W, reflect);
      const float4 v = act4_f32(x, pix, c0 + 4 * grp, Cin, es, eb, affine, leaky, vec_x);
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float b, s;
        split_tf32(vv[j], b, s);
        win_b[(4 * grp + j) * A32_PLANE + q] = b;
        win_s[(4 * grp + j) * A32_PLANE + q] = s;
      }
    }
    for (int u = tid; u < 9 * A32_KC * (A32_TCO / 4); u += A32_THREADS) {
      const int grp = u % (A32_TCO / 4);
      const int k = (u / (A32_TCO / 4)) % A32_KC;
      const int t = u / ((A32_TCO / 4) * A32_KC);
      const int ci = c0 + k;
      const float4 v = load4_f32(w + ((size_t)t * Cin + (ci < Cin ? ci : 0)) * Cout, ci < Cin,
                                 co0 + 4 * grp, Cout, vec_w);
      const int o = (t * A32_KC + k) * A32_WS + 4 * grp;
      split_store4(wt_b + o, wt_s + o, v);
    }
    __syncthreads();

    // the chunk's 9 x 16 products go to fresh accumulators, added to acc
    // with f32 adds: the tensor cores' own f32 accumulation is coarser than
    // round-to-nearest, and a chain of 9 x Cin products would show it
    float cacc[2][4][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) cacc[a][b][c] = 0.f;
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t % 3;
#pragma unroll
      for (int ks = 0; ks < A32_KC / 8; ++ks) {
        uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int px = (2 * wm + mt + dy) * WIN_W + dx + g;
          const int c = (8 * ks + t4) * A32_PLANE;
          const int idx[4] = {c + px, c + px + 8, c + 4 * A32_PLANE + px,
                              c + 4 * A32_PLANE + px + 8};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ab[mt][r] = __float_as_uint(win_b[idx[r]]);
            as[mt][r] = __float_as_uint(win_s[idx[r]]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int o = (t * A32_KC + 8 * ks + t4) * A32_WS + wn * 32 + nt * 8 + g;
          bb[nt][0] = __float_as_uint(wt_b[o]);
          bb[nt][1] = __float_as_uint(wt_b[o + 4 * A32_WS]);
          bs[nt][0] = __float_as_uint(wt_s[o]);
          bs[nt][1] = __float_as_uint(wt_s[o + 4 * A32_WS]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_3xtf32(cacc[mt][nt], ab[mt], as[mt], bb[nt], bs[nt]);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][b][c] += cacc[a][b][c];
    __syncthreads();
  }

  // epilogue: acc[mt][nt][2r + e] is output row 2wm + mt, column g + 8r,
  // channel co0 + wn*32 + nt*8 + 2*t4 + e
  float* red = smf;  // NROWG x A32_TCO x 2
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pr = h0 + 2 * wm + mt, pc = w0 + g + 8 * r;
        if (pr >= H || pc >= W) continue;
        const size_t pix = (((size_t)n * H + pr) * W + pc) * Cout;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co0 + wn * 32 + nt * 8 + 2 * t4 + e;
          if (co >= Cout) continue;
          float v = acc[mt][nt][2 * r + e];
          if (base != nullptr) v += base[pix + co];
          y[pix + co] = v;
          s[e] += v;
          q[e] += v * v;
        }
      }
    if (part != nullptr) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[e] = warp_sum_over_rows(s[e]);
        q[e] = warp_sum_over_rows(q[e]);
      }
      if (lane < 4) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wn * 32 + nt * 8 + 2 * lane + e;
          red[(wm * A32_TCO + c) * 2 + 0] = s[e];
          red[(wm * A32_TCO + c) * 2 + 1] = q[e];
        }
      }
    }
  }
  if (part != nullptr) {
    __syncthreads();
    if (tid < A32_TCO && co0 + tid < Cout) {
      float s = 0.f, q = 0.f;
      for (int r = 0; r < NROWG; ++r) {
        s += red[(r * A32_TCO + tid) * 2 + 0];
        q += red[(r * A32_TCO + tid) * 2 + 1];
      }
      const size_t blk = (size_t)n * gridDim.x + tile;
      part[(blk * 2 + 0) * Cout + co0 + tid] = s;
      part[(blk * 2 + 1) * Cout + co0 + tid] = q;
    }
  }
}

// ---------------------------------------------------------------- kernel B
// grid: (N * slices_per_img, ceil(Cout / WG_CO), ceil(Cin / WG_CI)); block:
// WG_THREADS. x (N,H,W,Cin), g (N,H,W,Cout), part (nslices, 9, Cin, Cout) f32.
// Slice s covers rows [j*rows, min((j+1)*rows, H)) of image s / slices_per_img,
// j = s % slices_per_img; a step is WG_R rows x PW pixels of them.

// Shared: window [B16_STAGES][8 planes][B16_WPIX][8], G [B16_STAGES][8 planes][B16_GPIX][8].
__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  const float* __restrict__ es, const float* __restrict__ eb,
                  float* __restrict__ part, int H, int W, int Cin, int Cout,
                  int rows_per_slice, int slices_per_img, bool affine, bool leaky,
                  bool reflect, bool vec_x, bool vec_g) {
  constexpr int WIN_ELEMS = 8 * B16_WPIX * 8;
  constexpr int G_ELEMS = 8 * B16_GPIX * 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_win = reinterpret_cast<bf16*>(smem);
  bf16* s_g = s_win + B16_STAGES * WIN_ELEMS;

  const int tid = threadIdx.x;
  const int dy = tid / 128;  // this warpgroup's kernel row
  const int wq = (tid % 128) / 32;
  const int lane = tid % 32;
  const int slice = blockIdx.x;
  const int n = slice / slices_per_img;
  const int hs = (slice % slices_per_img) * rows_per_slice;
  const int he = min(hs + rows_per_slice, H);
  const int co0 = blockIdx.y * WG_CO;
  const int ci0 = blockIdx.z * WG_CI;
  const int ncol = (W + B16_PW - 1) / B16_PW;
  const int nsteps = max(0, (he - hs + WG_R - 1) / WG_R) * ncol;

  // window unit u: 8 channels of one window pixel; neighbouring lanes take
  // the planes of a pixel
  constexpr int UNITS = 8 * (WG_R + 2) * (B16_PW + 2);
  auto unit_src = [&](int step, int u) {
    const int q = u / 8;
    return src_pixel(n, hs + (step / ncol) * WG_R - 1 + q / (B16_PW + 2),
                     (step % ncol) * B16_PW - 1 + q % (B16_PW + 2), H, W, reflect);
  };
  auto unit_dst = [&](int buf, int u) {
    return s_win + buf * WIN_ELEMS + ((u % 8) * B16_WPIX + u / 8) * 8;
  };
  // start the copies of a step: the window's raw bytes (zero-filled halo
  // and channels >= Cin) and G's rows
  auto issue = [&](int step, int buf) {
    const int h = hs + (step / ncol) * WG_R;
    const int w0 = (step % ncol) * B16_PW;
    if (vec_x)
      for (int u = tid; u < UNITS; u += WG_THREADS) {
        const long long pix = unit_src(step, u);
        const int c = ci0 + 8 * (u % 8);
        const bool in = pix >= 0 && c < Cin;
        cp_async16((uint32_t)__cvta_generic_to_shared(unit_dst(buf, u)),
                   in ? x + pix * Cin + c : x, in ? 16 : 0);
      }
    bf16* gs = s_g + buf * G_ELEMS;
    for (int u = tid; u < 8 * WG_R * B16_PW; u += WG_THREADS) {
      const int p = u % 8, q = u / 8;
      const int r = h + q / B16_PW, c = w0 + q % B16_PW;
      const bool ok = r < he && c < W;
      stage8_bf16(gs + (p * B16_GPIX + q) * 8,
                  g + (ok ? (((size_t)n * H + r) * W + c) * Cout : 0), ok, co0 + 8 * p, Cout,
                  vec_g);
    }
  };
  // once a thread's own copies of a step have landed: the prologue in
  // place (zeros stay zeros), or, without vector loads, the whole unit
  auto finish = [&](int step, int buf) {
    if (vec_x && !affine && !leaky) return;
    for (int u = tid; u < UNITS; u += WG_THREADS) {
      const long long pix = unit_src(step, u);
      const int c = ci0 + 8 * (u % 8);
      uint4* dst = reinterpret_cast<uint4*>(unit_dst(buf, u));
      if (!vec_x)
        *dst = act8_bf16(x, pix, c, Cin, es, eb, affine, leaky);
      else if (pix >= 0 && c < Cin)
        *dst = act8_from_raw(*dst, c, es, eb, affine, leaky);
    }
  };

  float acc[3][32];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[d][i] = 0.f;

  // cp.async group j holds step j's copies
#pragma unroll
  for (int j = 0; j < B16_STAGES - 1; ++j) {
    if (j < nsteps) issue(j, j);
    cp_async_commit();
  }
  cp_async_wait<B16_STAGES - 2>();
  if (nsteps > 0) finish(0, 0);
  fence_proxy_async();
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    const int buf = s % B16_STAGES;
    const uint32_t a_base = (uint32_t)__cvta_generic_to_shared(s_win + buf * WIN_ELEMS);
    const uint32_t b_base = (uint32_t)__cvta_generic_to_shared(s_g + buf * G_ELEMS);
#pragma unroll
    for (int d = 0; d < 3; ++d) fence_acc(acc[d]);
    wgmma_fence();
#pragma unroll
    for (int r = 0; r < WG_R; ++r)
#pragma unroll
      for (int kc = 0; kc < B16_PW / 16; ++kc) {
        // B: G (N-major), core matrix = 8 pixels x 8 output channels
        const uint64_t db = gmma_desc(b_base + (r * B16_PW + kc * 16) * 16, 128, B16_GPIX * 16);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          // A^T: the window (M-major), core matrix = 8 pixels x 8 input channels
          const uint64_t da = gmma_desc(
              a_base + ((r + dy) * (B16_PW + 2) + kc * 16 + dx) * 16, 128, B16_WPIX * 16);
          wgmma_tile<1, 1>(acc[dx], da, db);
        }
      }
    wgmma_commit();
    // into the buffers of step s - 1, whose wgmmas were waited for last round
    const int ahead = s + B16_STAGES - 1;
    if (ahead < nsteps) issue(ahead, ahead % B16_STAGES);
    cp_async_commit();
    wgmma_wait_all();
#pragma unroll
    for (int d = 0; d < 3; ++d) fence_acc(acc[d]);
    cp_async_wait<B16_STAGES - 2>();  // this thread's copies of step s + 1
    if (s + 1 < nsteps) finish(s + 1, (s + 1) % B16_STAGES);
    fence_proxy_async();
    __syncthreads();
  }

  // acc[dx][4j + 2i + e] is input channel ci0 + 16wq + lane/4 + 8i, output
  // channel co0 + 8j + 2(lane%4) + e
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float* dst = part + ((size_t)slice * 9 + dy * 3 + dx) * Cin * Cout;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ci = ci0 + 16 * wq + lane / 4 + 8 * i;
        const int co = co0 + 8 * j + 2 * (lane % 4);
        if (ci >= Cin) continue;
        if (co < Cout) dst[(size_t)ci * Cout + co] = acc[dx][4 * j + 2 * i];
        if (co + 1 < Cout) dst[(size_t)ci * Cout + co + 1] = acc[dx][4 * j + 2 * i + 1];
      }
  }
}

// Shared: B32_STAGES x (window big, small [B32_WPIX][B32_CS]; G big, small
// [WG_R * B32_PW][B32_CS]). Warp: kernel row dy = warp / 4, input channels
// ci0 + 32*((warp%4)/2) .. +31, output channels co0 + 32*(warp%2) .. +31.
__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_tf32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ es, const float* __restrict__ eb,
                  float* __restrict__ part, int H, int W, int Cin, int Cout,
                  int rows_per_slice, int slices_per_img, bool affine, bool leaky,
                  bool reflect, bool vec_x, bool vec_g) {
  constexpr int WIN_F = B32_WPIX * B32_CS;    // floats of one window copy
  constexpr int G_F = WG_R * B32_PW * B32_CS;  // floats of one G copy
  constexpr int STAGE_F = 2 * (WIN_F + G_F);   // big and small of both
  extern __shared__ __align__(16) float smf[];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int dy = warp / 4;
  const int wm = (warp % 4) / 2, wn = warp % 2;
  const int slice = blockIdx.x;
  const int n = slice / slices_per_img;
  const int hs = (slice % slices_per_img) * rows_per_slice;
  const int he = min(hs + rows_per_slice, H);
  const int co0 = blockIdx.y * WG_CO;
  const int ci0 = blockIdx.z * WG_CI;
  const int ncol = (W + B32_PW - 1) / B32_PW;
  const int nsteps = max(0, (he - hs + WG_R - 1) / WG_R) * ncol;

  // stage buffers: [window big][window small][G big][G small]
  auto win_b = [&](int buf) { return smf + buf * STAGE_F; };
  auto g_b = [&](int buf) { return smf + buf * STAGE_F + 2 * WIN_F; };
  // unit u: 4 channels of one window pixel (u < WUNITS) or of one G pixel
  constexpr int WUNITS = B32_WPIX * (WG_CI / 4);
  constexpr int GUNITS = WG_R * B32_PW * (WG_CO / 4);
  auto win_src = [&](int step, int q) {
    return src_pixel(n, hs + (step / ncol) * WG_R - 1 + q / (B32_PW + 2),
                     (step % ncol) * B32_PW - 1 + q % (B32_PW + 2), H, W, reflect);
  };
  auto g_row = [&](int step, int q, bool& ok) {
    const int r = hs + (step / ncol) * WG_R + q / B32_PW;
    const int c = (step % ncol) * B32_PW + q % B32_PW;
    ok = r < he && c < W;
    return g + (ok ? (((size_t)n * H + r) * W + c) * Cout : 0);
  };
  // start the raw copies of a step into the big halves (zero-filled where
  // out of range)
  auto issue = [&](int step, int buf) {
    if (vec_x)
      for (int u = tid; u < WUNITS; u += WG_THREADS) {
        const int grp = u % (WG_CI / 4), q = u / (WG_CI / 4);
        const long long pix = win_src(step, q);
        const int c = ci0 + 4 * grp;
        const bool in = pix >= 0 && c < Cin;
        cp_async16((uint32_t)__cvta_generic_to_shared(win_b(buf) + q * B32_CS + 4 * grp),
                   in ? x + pix * Cin + c : x, in ? 16 : 0);
      }
    if (vec_g)
      for (int u = tid; u < GUNITS; u += WG_THREADS) {
        const int grp = u % (WG_CO / 4), q = u / (WG_CO / 4);
        bool ok;
        const float* row = g_row(step, q, ok);
        const bool in = ok && co0 + 4 * grp < Cout;
        cp_async16((uint32_t)__cvta_generic_to_shared(g_b(buf) + q * B32_CS + 4 * grp),
                   in ? row + co0 + 4 * grp : g, in ? 16 : 0);
      }
  };
  // once a thread's own copies have landed: the prologue and the split in
  // place (or, without vector loads, element loads first)
  auto finish = [&](int step, int buf) {
    for (int u = tid; u < WUNITS; u += WG_THREADS) {
      const int grp = u % (WG_CI / 4), q = u / (WG_CI / 4);
      const long long pix = win_src(step, q);
      const int c = ci0 + 4 * grp;
      float* big = win_b(buf) + q * B32_CS + 4 * grp;
      float4 v = *reinterpret_cast<const float4*>(big);
      if (!vec_x) {
        v = act4_f32(x, pix, c, Cin, es, eb, affine, leaky, false);
      } else if (pix >= 0 && c < Cin) {
        v.x = prologue(v.x, es, eb, c, affine, leaky);
        v.y = prologue(v.y, es, eb, c + 1, affine, leaky);
        v.z = prologue(v.z, es, eb, c + 2, affine, leaky);
        v.w = prologue(v.w, es, eb, c + 3, affine, leaky);
      }
      split_store4(big, big + WIN_F, v);
    }
    for (int u = tid; u < GUNITS; u += WG_THREADS) {
      const int grp = u % (WG_CO / 4), q = u / (WG_CO / 4);
      float* big = g_b(buf) + q * B32_CS + 4 * grp;
      float4 v = *reinterpret_cast<const float4*>(big);
      if (!vec_g) {
        bool ok;
        const float* row = g_row(step, q, ok);
        v = load4_f32(row, ok, co0 + 4 * grp, Cout, false);
      }
      split_store4(big, big + G_F, v);
    }
  };

  float acc[3][2][4][4];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int d = 0; d < 4; ++d) acc[a][b][c][d] = 0.f;

  // cp.async group j holds step j's copies
#pragma unroll
  for (int j = 0; j < B32_STAGES - 1; ++j) {
    if (j < nsteps) issue(j, j);
    cp_async_commit();
  }
  cp_async_wait<B32_STAGES - 2>();
  if (nsteps > 0) finish(0, 0);
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    const int buf = s % B32_STAGES;
    // into the buffers of step s - 1, which every warp left at the last barrier
    const int ahead = s + B32_STAGES - 1;
    if (ahead < nsteps) issue(ahead, ahead % B32_STAGES);
    cp_async_commit();
    const float* wb = win_b(buf);
    const float* ws = wb + WIN_F;
    const float* gb = g_b(buf);
    const float* gs = gb + G_F;
#pragma unroll 1
    for (int r = 0; r < WG_R; ++r)
#pragma unroll 1
      for (int kc = 0; kc < B32_PW / 8; ++kc) {
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          // b0 = (pixel t4, channel gq), b1 = (pixel t4 + 4, channel gq)
          const int o = (r * B32_PW + kc * 8 + t4) * B32_CS + wn * 32 + nt * 8 + gq;
          bb[nt][0] = __float_as_uint(gb[o]);
          bb[nt][1] = __float_as_uint(gb[o + 4 * B32_CS]);
          bs[nt][0] = __float_as_uint(gs[o]);
          bs[nt][1] = __float_as_uint(gs[o + 4 * B32_CS]);
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            // a0 = (channel gq, pixel t4), a1 = (gq + 8, t4), a2 = (gq, t4 + 4), a3 = (gq + 8, t4 + 4)
            const int o = ((r + dy) * (B32_PW + 2) + kc * 8 + t4 + dx) * B32_CS + wm * 32 +
                          mt * 16 + gq;
            const int idx[4] = {o, o + 8, o + 4 * B32_CS, o + 4 * B32_CS + 8};
            uint32_t ab[4], as[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              ab[k] = __float_as_uint(wb[idx[k]]);
              as[k] = __float_as_uint(ws[idx[k]]);
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_3xtf32(acc[dx][mt][nt], ab, as, bb[nt], bs[nt]);
          }
      }
    cp_async_wait<B32_STAGES - 2>();  // this thread's copies of step s + 1
    if (s + 1 < nsteps) finish(s + 1, (s + 1) % B32_STAGES);
    __syncthreads();
  }

  // acc[dx][mt][nt][2r + e] is input channel ci0 + wm*32 + mt*16 + gq + 8r,
  // output channel co0 + wn*32 + nt*8 + 2*t4 + e
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float* dst = part + ((size_t)slice * 9 + dy * 3 + dx) * Cin * Cout;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int ci = ci0 + wm * 32 + mt * 16 + gq + 8 * r;
          if (ci >= Cin) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = co0 + wn * 32 + nt * 8 + 2 * t4 + e;
            if (co < Cout) dst[(size_t)ci * Cout + co] = acc[dx][mt][nt][2 * r + e];
          }
        }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int sm_count(int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

// kernel A bf16 keeps its weights resident up to this slab size
constexpr int A16_RESIDENT_MAX = 160 * 1024;

template <int TCO, bool RESIDENT>
cudaError_t launch_fwd_bf16(const bf16* x, const bf16* w, const float* es, const float* eb,
                            const bf16* base, bf16* y, float* part, int N, int H, int W,
                            int Cin, int Cout, int affine, int leaky, int reflect, bool vec_x,
                            bool vec_w, int device, cudaStream_t s) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = ((H + TH - 1) / TH) * tiles_w;
  const int total = tiles * N;
  const int nchunks = (Cin + A16_KC - 1) / A16_KC;
  const int wt_elems = 9 * A16_KC * TCO;
  const int smem =
      (A16_STAGES * A16_PL * WIN_PIX * 8 + (RESIDENT ? nchunks : A16_STAGES) * wt_elems) * 2 +
      (A16_THREADS / 32) * TCO * 2 * 4;
  cudaError_t err = set_smem(fwd_bf16_kernel<TCO, RESIDENT>, smem);
  if (err != cudaSuccess) return err;
  int occ = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fwd_bf16_kernel<TCO, RESIDENT>,
                                                A16_THREADS, smem);
  const int co_tiles = (Cout + TCO - 1) / TCO;
  // one wave: every block resident at once, each walking its list of tiles
  const int wave = (occ > 0 ? occ : 1) * sm_count(device) / co_tiles;
  const int blocks = wave < 1 ? 1 : (wave < total ? wave : total);
  fwd_bf16_kernel<TCO, RESIDENT><<<dim3(blocks, co_tiles), A16_THREADS, smem, s>>>(
      x, w, es, eb, base, y, part, H, W, Cin, Cout, tiles, tiles_w, total, affine != 0,
      leaky != 0, reflect != 0, vec_x, vec_w);
  return cudaSuccess;
}

constexpr int A32_SMEM = (2 * A32_KC * A32_PLANE + 2 * 9 * A32_KC * A32_WS) * 4;
constexpr int B16_SMEM = B16_STAGES * (8 * B16_WPIX * 8 + 8 * B16_GPIX * 8) * 2;
constexpr int B32_SMEM = B32_STAGES * (2 * B32_WPIX * B32_CS + 2 * WG_R * B32_PW * B32_CS) * 4;

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
  const int tiles = ((H + TH - 1) / TH) * tiles_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fes = static_cast<const float*>(es);
  const float* feb = static_cast<const float*>(eb);
  float* fpart = static_cast<float*>(part);
  if (dtype == 0) {
    const bool vec_x = Cin % 4 == 0 && aligned16(x);
    const bool vec_w = Cout % 4 == 0 && aligned16(w);
    if ((err = set_smem(fwd_tf32_kernel, A32_SMEM)) != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(tiles, (Cout + A32_TCO - 1) / A32_TCO, N);
    fwd_tf32_kernel<<<grid, A32_THREADS, A32_SMEM, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), fes, feb,
        static_cast<const float*>(base), static_cast<float*>(y), fpart, H, W, Cin, Cout,
        tiles_w, affine != 0, leaky != 0, reflect != 0, vec_x, vec_w);
  } else {
    const bool vec_x = Cin % 8 == 0 && aligned16(x);
    const bool vec_w = Cout % 8 == 0 && aligned16(w);
    const bf16* bx = static_cast<const bf16*>(x);
    const bf16* bw = static_cast<const bf16*>(w);
    const bf16* bb = static_cast<const bf16*>(base);
    bf16* by = static_cast<bf16*>(y);
    // N = 128 past 64 output channels (half the window staging per output).
    // The weights stay in shared memory for the whole launch where they fit
    // and each block has two tiles or more to amortise them over; a block
    // with one tile starts sooner on one chunk's weights at a time.
    const int nchunks = (Cin + A16_KC - 1) / A16_KC;
    const int tco = Cout > 64 ? 128 : 64;
    const long long blocks_if_one_each = (long long)tiles * N * ((Cout + tco - 1) / tco);
    const bool resident = nchunks * 9 * A16_KC * tco * 2 <= A16_RESIDENT_MAX &&
                          blocks_if_one_each >= 2LL * sm_count(device);
    if (tco == 128 && resident)
      err = launch_fwd_bf16<128, true>(bx, bw, fes, feb, bb, by, fpart, N, H, W, Cin, Cout,
                                       affine, leaky, reflect, vec_x, vec_w, device, s);
    else if (tco == 128)
      err = launch_fwd_bf16<128, false>(bx, bw, fes, feb, bb, by, fpart, N, H, W, Cin, Cout,
                                        affine, leaky, reflect, vec_x, vec_w, device, s);
    else if (resident)
      err = launch_fwd_bf16<64, true>(bx, bw, fes, feb, bb, by, fpart, N, H, W, Cin, Cout,
                                      affine, leaky, reflect, vec_x, vec_w, device, s);
    else
      err = launch_fwd_bf16<64, false>(bx, bw, fes, feb, bb, by, fpart, N, H, W, Cin, Cout,
                                       affine, leaky, reflect, vec_x, vec_w, device, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

int tpusr_conv3x3_wgrad(int device, int dtype, const void* x, const void* g, const void* es,
                        const void* eb, void* part, int N, int H, int W, int Cin,
                        int Cout, int rows_per_slice, int slices_per_img, int affine,
                        int leaky, int reflect, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N * slices_per_img, (Cout + WG_CO - 1) / WG_CO, (Cin + WG_CI - 1) / WG_CI);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fes = static_cast<const float*>(es);
  const float* feb = static_cast<const float*>(eb);
  float* fpart = static_cast<float*>(part);
  if (dtype == 0) {
    const bool vec_x = Cin % 4 == 0 && aligned16(x);
    const bool vec_g = Cout % 4 == 0 && aligned16(g);
    if ((err = set_smem(wgrad_tf32_kernel, B32_SMEM)) != cudaSuccess)
      return static_cast<int>(err);
    wgrad_tf32_kernel<<<grid, WG_THREADS, B32_SMEM, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), fes, feb, fpart, H, W,
        Cin, Cout, rows_per_slice, slices_per_img, affine != 0, leaky != 0, reflect != 0,
        vec_x, vec_g);
  } else {
    const bool vec_x = Cin % 8 == 0 && aligned16(x);
    const bool vec_g = Cout % 8 == 0 && aligned16(g);
    if ((err = set_smem(wgrad_bf16_kernel, B16_SMEM)) != cudaSuccess)
      return static_cast<int>(err);
    wgrad_bf16_kernel<<<grid, WG_THREADS, B16_SMEM, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g), fes, feb, fpart, H, W, Cin,
        Cout, rows_per_slice, slices_per_img, affine != 0, leaky != 0, reflect != 0, vec_x,
        vec_g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
