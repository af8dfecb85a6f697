// Windowed multi-head self-attention of SwinIR's Swin layers, written by hand
// for Hopper (sm_90a), on the tensor cores.
//
// It replaces no TPU kernel: the JAX package has no transformer. It was added
// for SwinIR (models/swinir.py), whose every Swin layer would otherwise write
// and read its (windows x heads x 64 x 64) scores several times and copy the
// activation through roll, window partition, window reverse and the roll
// back. Per image of Hp x Wp tokens (Hp, Wp multiples of 8), in the image's
// own token order on both sides:
//
//   qkv (B, Hp*Wp, 3C), C = heads * hd, split q | k | v, each head's hd
//   channels contiguous (the published Linear(C, 3C) reshaped to
//   (3, heads, hd)); the image rolled by (-shift, -shift) and cut into 8 x 8
//   windows of 64 tokens; per window and head
//     A = softmax(q k^T * scale + B + M) v
//   B[i][j] = table[(ri - rj + 7) * 15 + (ci - cj + 7)][head] (the published
//   relative_position_index over the (15^2, heads) table), M = -100 between
//   tokens of different regions of the published 3 x 3 slicing of the
//   shifted image (shift > 0 only; -100, not -inf, as published); out (B,
//   Hp*Wp, C) holds each token's A at the token's own place, so the roll
//   back is the same addressing and no copy of the activation is made.
//
// What bounds it on the H100: per window and head 2 x 64 x 64 x 30
// multiply-adds against 64 x 90 values read and 64 x 30 written: ~22
// operations a byte in bf16, far under the card's ~295, so bytes bound it
// (qkv read once, A written once: ~56 us at 272 x 480 x 180 in bf16).
// The design keeps everything between those two passes on chip:
//
//   A block owns one window (grid: windows x images) and its 128 threads
//   copy the window's 64 qkv rows, each read at its rolled image position,
//   into shared memory with cp.async (all of them in flight at once), in a
//   row stride chosen so that every fragment load below is free of bank
//   conflicts. Each of the four warps owns 16 query rows and walks the
//   heads: S = Q K^T on mma.sync (bf16: m16n8k16, P kept in registers as
//   the A operand of P V, as flash attention does; f32: 3xTF32 m16n8k8,
//   each operand split into two TF32 parts and three products, P through
//   a per-warp shared buffer), the scale, bias and mask added and the
//   softmax taken in f32 registers (row max and sum across the quad by
//   shuffles), P V accumulated in f32 and divided by the row sum. The head
//   dimension is padded to 32 inside (zero operands; the padding is no
//   useful work). A head's result overwrites that head's q columns of the
//   warp's own rows, which nothing reads again, and the block writes the
//   64 result rows back to their image positions, 8 or 16 bytes a thread.
//
// Interface: a plain C entry point (loaded with ctypes). It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WS = 8;              // window side
constexpr int NT = WS * WS;        // tokens of a window
constexpr int WARPS = NT / 16;     // a warp owns 16 query rows
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_HD = 32;         // head dimension, padded to 32 inside
constexpr int TABLE_SIDE = 2 * WS - 1;
constexpr int P_LD = NT + 4;       // f32 P buffer row stride (conflict-free)
constexpr float MASK = -100.f;     // the published mask value
constexpr int SMEM_MAX = 227 * 1024;

struct Params {
  const void* qkv;      // (B, Hp*Wp, 3C)
  const float* table;   // (TABLE_SIDE^2, heads)
  void* out;            // (B, Hp*Wp, C)
  int Hp, Wp, heads, hd, shift, stride;  // stride: staged row, in elements
  float scale;
};

// Row stride of the staged qkv rows, in elements: at least 3C, a multiple
// of 4 elements (8 or 16 bytes, the copies' size), and 4 mod 8 in 32-bit
// words, so that the 8 rows x 4 words of a fragment load fall in 32
// distinct banks.
template <typename T>
int row_stride(int c3) {
  const int per_word = 4 / sizeof(T);  // elements per 32-bit word
  int s = (c3 + 3) / 4 * 4;
  while ((s / per_word) % 8 != 4) s += 4;
  return s;
}

template <typename T>
int smem_bytes(int stride) {
  const int p = sizeof(T) == 4 ? WARPS * 16 * P_LD * 4 : 0;
  return NT * stride * (int)sizeof(T) + p;
}

// 4 elements global -> shared, asynchronously (8 bytes in bf16, 16 in f32)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The TF32 part of v (cvt.rna, low 13 bits zero): v = big + small exactly,
// and tf32(small) carries the next 11 bits.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32 from four f32 A values and two f32 B values
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float (&a)[4],
                                           const float (&b)[2]) {
  uint32_t ab[4], as[4], bb[2], bs[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[e], as[e]);
#pragma unroll
  for (int e = 0; e < 2; ++e) split_tf32(b[e], bb[e], bs[e]);
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S (16 rows x 64 keys) = Q_h K_h^T for the warp's rows, as 8 C fragments
template <typename T>
__device__ __forceinline__ void scores(float (&acc)[8][4], const T* s, int stride, int r_lo,
                                       int qo, int ko, int hd, int g, int t) {
  const T* q_lo = s + r_lo * stride + qo;
  const T* q_hi = q_lo + 8 * stride;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < MAX_HD / 16; ++kk) {
      const int d0 = 16 * kk + 2 * t, d1 = d0 + 8;
      const uint32_t a[4] = {d0 < hd ? ld32(q_lo + d0) : 0u, d0 < hd ? ld32(q_hi + d0) : 0u,
                             d1 < hd ? ld32(q_lo + d1) : 0u, d1 < hd ? ld32(q_hi + d1) : 0u};
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const T* kr = s + (8 * j + g) * stride + ko;
        const uint32_t b[2] = {d0 < hd ? ld32(kr + d0) : 0u, d1 < hd ? ld32(kr + d1) : 0u};
        mma_bf16(acc[j], a, b);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < MAX_HD / 8; ++kk) {
      const int d0 = 8 * kk + t, d1 = d0 + 4;
      const float a[4] = {d0 < hd ? q_lo[d0] : 0.f, d0 < hd ? q_hi[d0] : 0.f,
                          d1 < hd ? q_lo[d1] : 0.f, d1 < hd ? q_hi[d1] : 0.f};
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const T* kr = s + (8 * j + g) * stride + ko;
        const float b[2] = {d0 < hd ? kr[d0] : 0.f, d1 < hd ? kr[d1] : 0.f};
        mma_3xtf32(acc[j], a, b);
      }
    }
  }
}

// O (16 rows x 32 dims) = P V_h for the warp's rows; P unnormalised in acc
template <typename T>
__device__ __forceinline__ void values(float (&o)[MAX_HD / 8][4], const float (&acc)[8][4],
                                       const T* s, float* sp, int stride, int vo, int hd,
                                       int g, int t) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < NT / 16; ++kk) {
      // the C fragments of key tiles 2kk and 2kk+1 are the A fragment of
      // keys 16kk .. 16kk+15
      const uint32_t a[4] = {pack2(acc[2 * kk][0], acc[2 * kk][1]),
                             pack2(acc[2 * kk][2], acc[2 * kk][3]),
                             pack2(acc[2 * kk + 1][0], acc[2 * kk + 1][1]),
                             pack2(acc[2 * kk + 1][2], acc[2 * kk + 1][3])};
      const T* v0 = s + (16 * kk + 2 * t) * stride + vo;
#pragma unroll
      for (int n = 0; n < MAX_HD / 8; ++n) {
        const int d = 8 * n + g;
        uint32_t b[2] = {0u, 0u};
        if (d < hd) {
          b[0] = pack2(v0[d], v0[stride + d]);
          b[1] = pack2(v0[8 * stride + d], v0[9 * stride + d]);
        }
        mma_bf16(o[n], a, b);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      *reinterpret_cast<float2*>(sp + g * P_LD + 8 * j + 2 * t) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(sp + (g + 8) * P_LD + 8 * j + 2 * t) =
          make_float2(acc[j][2], acc[j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < NT / 8; ++kk) {
      const int k0 = 8 * kk + t;
      const float a[4] = {sp[g * P_LD + k0], sp[(g + 8) * P_LD + k0], sp[g * P_LD + k0 + 4],
                          sp[(g + 8) * P_LD + k0 + 4]};
      const T* v0 = s + k0 * stride + vo;
#pragma unroll
      for (int n = 0; n < MAX_HD / 8; ++n) {
        const int d = 8 * n + g;
        const float b[2] = {d < hd ? v0[d] : 0.f, d < hd ? v0[4 * stride + d] : 0.f};
        mma_3xtf32(o[n], a, b);
      }
    }
    __syncwarp();  // P is read before the next head writes it
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) window_attention_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_tok[NT];  // image position of each window token
  __shared__ int8_t s_rid[NT];    // its region of the shifted image
  T* s = reinterpret_cast<T*>(smem);
  const int C = p.heads * p.hd, C3 = 3 * C;
  const int stride = p.stride;
  const int nww = p.Wp / WS;
  const int wr = blockIdx.x / nww, wc = blockIdx.x - (blockIdx.x / nww) * nww;
  const size_t L = (size_t)p.Hp * p.Wp;
  const T* qkv = static_cast<const T*>(p.qkv) + blockIdx.y * L * C3;
  T* out = static_cast<T*>(p.out) + blockIdx.y * L * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid < NT) {
    const int qr = wr * WS + tid / WS, qc = wc * WS + tid % WS;  // shifted image
    int r = qr + p.shift, c = qc + p.shift;                      // the image
    if (r >= p.Hp) r -= p.Hp;
    if (c >= p.Wp) c -= p.Wp;
    s_tok[tid] = (uint32_t)(r * p.Wp + c);
    const int hr = qr < p.Hp - WS ? 0 : (qr < p.Hp - p.shift ? 1 : 2);
    const int hc = qc < p.Wp - WS ? 0 : (qc < p.Wp - p.shift ? 1 : 2);
    s_rid[tid] = (int8_t)(3 * hr + hc);
  }
  __syncthreads();

  // the window's qkv rows, all copies in flight at once
  const int chunks = C3 / 4;
  for (int u = tid; u < NT * chunks; u += THREADS) {
    const int i = u / chunks, k = (u - i * chunks) * 4;
    cp_async<4 * sizeof(T)>(s + i * stride + k, qkv + (size_t)s_tok[i] * C3 + k);
  }
  cp_async_wait_all();
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  float* sp = reinterpret_cast<float*>(smem + (size_t)NT * stride * sizeof(T)) +
              warp * 16 * P_LD;
  const bool masked = p.shift > 0;
  const int rid_lo = s_rid[r_lo], rid_hi = s_rid[r_hi];
  for (int h = 0; h < p.heads; ++h) {
    const int qo = h * p.hd, ko = C + h * p.hd, vo = 2 * C + h * p.hd;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    scores<T>(acc, s, stride, r_lo, qo, ko, p.hd, g, t);

    // scale, relative-position bias, mask; then the softmax's numerators
    float m_lo = -FLT_MAX, m_hi = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? r_lo : r_hi, k = 8 * j + 2 * t + (e & 1);
        const int idx = (i / WS - k / WS + WS - 1) * TABLE_SIDE + (i % WS - k % WS + WS - 1);
        float v = acc[j][e] * p.scale + __ldg(p.table + idx * p.heads + h);
        if (masked && (e < 2 ? rid_lo : rid_hi) != s_rid[k]) v += MASK;
        acc[j][e] = v;
        if (e < 2)
          m_lo = fmaxf(m_lo, v);
        else
          m_hi = fmaxf(m_hi, v);
      }
    m_lo = quad_max(m_lo);
    m_hi = quad_max(m_hi);
    float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = expf(acc[j][e] - (e < 2 ? m_lo : m_hi));
        acc[j][e] = v;
        if (e < 2)
          l_lo += v;
        else
          l_hi += v;
      }
    const float inv_lo = 1.f / quad_sum(l_lo), inv_hi = 1.f / quad_sum(l_hi);

    float o[MAX_HD / 8][4];
#pragma unroll
    for (int n = 0; n < MAX_HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    values<T>(o, acc, s, sp, stride, vo, p.hd, g, t);

    // this head's q columns of the warp's own rows take its result
    __syncwarp();
#pragma unroll
    for (int n = 0; n < MAX_HD / 8; ++n) {
      const int d = 8 * n + 2 * t;
      if (d >= p.hd) continue;
      T* lo = s + r_lo * stride + qo + d;
      T* hi = s + r_hi * stride + qo + d;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(lo) =
            __floats2bfloat162_rn(o[n][0] * inv_lo, o[n][1] * inv_lo);
        *reinterpret_cast<__nv_bfloat162*>(hi) =
            __floats2bfloat162_rn(o[n][2] * inv_hi, o[n][3] * inv_hi);
      } else {
        *reinterpret_cast<float2*>(lo) = make_float2(o[n][0] * inv_lo, o[n][1] * inv_lo);
        *reinterpret_cast<float2*>(hi) = make_float2(o[n][2] * inv_hi, o[n][3] * inv_hi);
      }
    }
  }
  __syncthreads();

  // the 64 result rows to their image positions
  const int out_chunks = C / 4;
  for (int u = tid; u < NT * out_chunks; u += THREADS) {
    const int i = u / out_chunks, k = (u - i * out_chunks) * 4;
    const T* src = s + i * stride + k;
    T* dst = out + (size_t)s_tok[i] * C + k;
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    else
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  }
}

template <typename T>
cudaError_t launch(const Params& p, int images, cudaStream_t stream) {
  const int smem = smem_bytes<T>(p.stride);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Hp / WS) * (p.Wp / WS), images);
  window_attention_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of the tensors and the stream. dtype: 0 =
// float32, 1 = bfloat16. qkv (B, Hp*Wp, 3 * heads * hd) and out (B, Hp*Wp,
// heads * hd) in that dtype, contiguous and 16-byte aligned; table
// (15^2, heads) float32. Hp and Wp multiples of 8; hd even, at most 32;
// heads * hd a multiple of 4; 0 <= shift < 8; scale = hd^-1/2.
int tpusr_window_attention(int device, int dtype, const void* qkv, const void* table, void* out,
                           int B, int Hp, int Wp, int heads, int hd, int shift, float scale,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int C = heads * hd;
  const long long nw = (long long)(Hp / WS) * (Wp / WS);
  if (B < 1 || B > 65535 || Hp < WS || Wp < WS || Hp % WS || Wp % WS || heads < 1 || hd < 2 ||
      hd > MAX_HD || hd % 2 || C % 4 || shift < 0 || shift >= WS || nw > 0x7fffffffLL ||
      (long long)Hp * Wp * 3 * C >= (1LL << 31) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{qkv, static_cast<const float*>(table), out, Hp, Wp, heads, hd, shift, 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    p.stride = row_stride<float>(3 * C);
    return static_cast<int>(launch<float>(p, B, s));
  }
  p.stride = row_stride<bf16>(3 * C);
  return static_cast<int>(launch<bf16>(p, B, s));
}

}  // extern "C"
