// One whole ESRGAN dense block, written by hand for Hopper (sm_90a), on the
// tensor cores.
//
// Kernel C, dense_block_kernel, replaces tpusr/ops/pallas_dense.py:103
// (_db_kernel):
//   c1 = lrelu(conv3x3(x) + b1)
//   c2 = lrelu(conv3x3([x, c1]) + b2)
//   c3 = lrelu(conv3x3([x, c1, c2]) + b3)
//   c4 = lrelu(conv3x3([x, c1, c2, c3]) + b4)
//   c5 = conv3x3([x, c1, c2, c3, c4]) + b5
//   y  = x + 0.2 * c5
// on NHWC x and y (N, H, W, 64), growth 32, LeakyReLU slope 0.2, zero-SAME
// halos at the image edges, in ONE launch: x is read once, y is written once,
// and the four 32-channel intermediates c1..c4 never leave shared memory.
// Accumulation is f32 in both dtypes; in bf16, c1..c4 and y are rounded to
// bf16 where they are stored, the weights are bf16 and the biases f32.
//
// What bounds it on the H100: 2 * 239,616 FLOPs per output pixel against
// 256 bytes in and out (bf16; 512 in f32): some 1,900 FLOPs a byte, far
// above the ridge point, so the tensor cores bound it (989 TFLOP/s bf16;
// 495 TF32, 165 for the three TF32 products of an f32 product).
//
// Design. The TPU kernel walked rows through ring buffers on a sequential
// grid; CUDA blocks run in no order, so each block owns one output tile and
// computes every stage it needs from scratch (halo recompute): stage s
// (c_s, s = 1..4, then y) on its region, the tile grown by 5 - s pixels on
// each side, from x on the tile grown by 5. Each stage is an implicit GEMM:
// M = the region's pixels, N = 32 (c1..c4) or 64 (y, as two halves of 32),
// K = 9 x Cin (Cin = 64, 96, 128, 160, 192), in 16-channel chunks.
//
//   Layout. x and c1..c4 sit in shared memory as [16-byte channel plane]
//   [pixel][16 bytes], each on its own region at its own row pitch (no
//   padding): 8 bf16 or 4 f32 channels a plane. A warp takes its A fragment
//   for 16 pixels with one ldmatrix.x4 whose 32 lanes each give the address
//   of one pixel's 16 bytes, so a row of M maps to any pixel: M runs over
//   the region's pixels in row order, is padded only at its end (to 64 rows
//   for wgmma, 16 for mma.sync; padding rows read the last pixel and are
//   dropped), and a tap (dy, dx) is a pixel offset, (dy + d) * pitch + dx + d,
//   into the source (d = the source's extra halo). No im2col, no wrap
//   columns, no region rounded to 8.
//
//   Weights. The wrapper packs them once per parameter version, in the
//   dtype, in the order the kernel consumes them: 52 units of 9 taps x 16
//   input channels x 32 outputs (stages 1-4: one unit per chunk; stage 5:
//   two per chunk, one per half of N), each laid out as its shared-memory
//   slot. A ring of RING slots takes them by cp.async, two units ahead of
//   the one in use, beside the compute. The biases are read as f32.
//
//   bf16: wgmma m64n32k16, f32 accumulators, A from registers (the
//   ldmatrix fragments: the M mapping is free), B from the slot as an
//   N-major operand (8 x 8 core matrices: K plane along LBO, N block along
//   SBO). A 16 x 16 output tile; two warpgroups take the stage's 64-row
//   M tiles in turn. Each warpgroup keeps one group of three wgmmas (one
//   kernel row) in flight while it loads the next row's fragments.
//
//   f32: 3xTF32 on mma.sync.m16n8k8 (big = v cut to TF32's 19 bits, small
//   = v - big; small*big + big*small + big*big per product, about 2^-20
//   relative). Operands are split at fragment load, two instructions a
//   value: storing both halves would double the shared memory, which in
//   f32 is already four times bf16's per pixel.
//   The tensor cores' own f32 accumulation is coarser than round-to-nearest
//   (kernel A's finding), so each 16-channel chunk (144 products) is summed
//   in fresh registers and added to the f32 total. An 8 x 8 output tile (a
//   16 x 16 tile would need 401,408 bytes for x and c1..c4 in f32); eight
//   warps take (16-pixel, 32-channel) items of c1..c4 and (16-pixel,
//   16-channel) items of y in turn.
//
//   Recompute, with M padding (the useful work is 239,616 multiply-adds a
//   pixel): bf16 16 x 16 tile 1.423x (341,091 a pixel; regions 26^2 x,
//   24^2, 22^2, 20^2, 18^2, 16^2; the only waste beyond the halo is M
//   padded to 64 rows: 0, 28, 48, 60 and 0 rows for c1..c4 and y), 1.481x
//   with the two warpgroups' turns; f32 8 x 8 tile 1.827x (regions 18^2 ..
//   8^2, M padded to 16: 0, 12, 0, 12, 0 rows), 2.231x with the warps'
//   turns. Shared memory: bf16 200,704 bytes for x and c1..c4 + 3 x 9,216
//   for the weight ring = 228,352; f32 172,032 + 3 x 18,432 = 227,328.
//   Occupancy: one block of 256 threads (8 warps) per SM, 142 registers a
//   thread in bf16 and 115 in f32 (ptxas -v for sm_90a, no spills).

// Every N, H, W >= 1 is taken; x is read by 16-byte cp.async (zero-filled
// outside the image), so the wrapper hands over 16-byte-aligned tensors.
// Pixels of a stage outside the image are stored as exact zeros, the zero
// padding the next conv needs.
//
// Interface: a plain C entry point (loaded with ctypes). It launches on the
// caller's stream, allocates nothing, uses no atomics (each output is written
// by one thread, so results are deterministic), and returns the CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NF = 64;       // trunk width
constexpr int GC = 32;       // growth
constexpr int HALO = 5;      // five chained 3x3 convs
constexpr int KC = 16;       // input channels per chunk
constexpr int UNIT_N = 32;   // output channels per weight unit
constexpr int NUNITS = 52;   // 4 + 6 + 8 + 10 + 2 x 12 weight units a tile
constexpr int THREADS = 256;
constexpr int RING = 3;      // weight slots: units issued two ahead

// bf16 kernel (wgmma)
constexpr int B16_TH = 16;   // output tile rows
constexpr int B16_TW = 16;   // output tile columns
// f32 kernel (3xTF32 mma.sync)
constexpr int F32_TH = 8;
constexpr int F32_TW = 8;

// A tile's geometry for storage type T: stage s = 0 (x), 1..4 (c_s), 5 (y).
template <typename T, int TH, int TW>
struct Geo {
  static constexpr int CPP = 16 / (int)sizeof(T);  // channels per 16-byte plane
  __host__ __device__ static constexpr int rw(int s) { return TW + 2 * (HALO - s); }
  __host__ __device__ static constexpr int rh(int s) { return TH + 2 * (HALO - s); }
  __host__ __device__ static constexpr int npix(int s) { return rw(s) * rh(s); }
  __host__ __device__ static constexpr int planes(int s) { return (s == 0 ? NF : GC) / CPP; }
  __host__ __device__ static constexpr int unit_bytes() { return 9 * KC * UNIT_N * (int)sizeof(T); }
  __host__ __device__ static constexpr int ring_bytes() { return RING * unit_bytes(); }
  // byte offset of buffer s (0 = x, 1..4 = c_s); the ring is at 0
  __host__ __device__ static constexpr int buf(int s) {
    return s == 0 ? ring_bytes() : buf(s - 1) + npix(s - 1) * planes(s - 1) * 16;
  }
  __host__ __device__ static constexpr int smem_bytes() { return buf(5); }
};
static_assert(Geo<bf16, B16_TH, B16_TW>::smem_bytes() <= 232448, "bf16 over 227 KB");
static_assert(Geo<float, F32_TH, F32_TW>::smem_bytes() <= 232448, "f32 over 227 KB");

struct Params {
  const void* w;       // packed weight units (bf16 or f32), NUNITS x unit
  const float* b[5];   // (32,) x 4 and (64,), f32
};

// ------------------------------------------------------------- primitives
// 16 bytes global -> shared, asynchronously; bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest N committed groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async) made visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across wgmma
template <int NR>
__device__ __forceinline__ void fence_acc(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// wgmma shared-memory descriptor, no swizzle: start address, LBO (stride
// between core matrices along K) and SBO (along M or N), all in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
// d += A (registers, the m64k16 fragment) x B (shared, N-major), bf16 -> f32
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// v = big + small exactly: big keeps v's sign, exponent and top 10
// mantissa bits (the 19 bits a TF32 operand holds), small the rest, of
// which the tensor core reads the top 11: each product loses about 2^-20
// of itself, where plain TF32 loses 2^-11. Two instructions a value.
template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&v)[N], uint32_t (&big)[N],
                                           uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    big[i] = v[i] & 0xffffe000u;
    small[i] = __float_as_uint(__uint_as_float(v[i]) - __uint_as_float(big[i]));
  }
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.2f * v; }

// -------------------------------------------------------- shared pipeline
// Per block: the tile's origin, the shared-memory base and the ring.
template <typename T, int TH, int TW>
struct Tile {
  using G = Geo<T, TH, TW>;
  const T* x;
  T* y;
  Params p;
  int n, h0, w0, H, W;
  uint32_t sbase;  // shared address of the dynamic shared memory

  __device__ __forceinline__ uint32_t buf_addr(int j) const {
    switch (j) {
      case 0: return sbase + G::buf(0);
      case 1: return sbase + G::buf(1);
      case 2: return sbase + G::buf(2);
      case 3: return sbase + G::buf(3);
      default: return sbase + G::buf(4);
    }
  }
  __device__ __forceinline__ uint32_t slot(int u) const {
    return sbase + (u % RING) * G::unit_bytes();
  }
  __device__ __forceinline__ void issue_unit(int u) const {
    const char* src = static_cast<const char*>(p.w) + (size_t)u * G::unit_bytes();
    const uint32_t dst = slot(u);
    for (int i = threadIdx.x; i < G::unit_bytes() / 16; i += THREADS)
      cp_async16(dst + 16 * i, src + 16 * i, 16);
  }
  // x on the tile grown by HALO, zero outside the image: neighbouring lanes
  // take the planes of one pixel (contiguous global bytes)
  __device__ __forceinline__ void issue_x() const {
    constexpr int PL = G::planes(0), RW = G::rw(0), NPIX = G::npix(0);
    const uint32_t dst = sbase + G::buf(0);
    for (int i = threadIdx.x; i < NPIX * PL; i += THREADS) {
      const int pl = i % PL, q = i / PL;
      const int gh = h0 - HALO + q / RW, gw = w0 - HALO + q % RW;
      const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
      const T* src = in ? x + (((size_t)n * H + gh) * W + gw) * NF + pl * G::CPP : x;
      cp_async16(dst + (pl * NPIX + q) * 16, src, in ? 16 : 0);
    }
  }
  // before unit u: it has landed for every thread, every thread is done
  // with unit u - 1 (whose slot unit u + RING - 1 takes) and with the
  // previous stage's stores; then unit u + RING - 1 is issued
  __device__ __forceinline__ void ring_step(int u) const {
    cp_async_wait<RING - 2>();
    fence_proxy_async();
    __syncthreads();
    if (u + RING - 1 < NUNITS) issue_unit(u + RING - 1);
    cp_async_commit();
  }
  __device__ __forceinline__ void start() const {
    issue_x();
#pragma unroll
    for (int v = 0; v < RING - 1; ++v) {
      issue_unit(v);  // group 0 also holds x
      cp_async_commit();
    }
  }
  // chunk c of a stage S reads source j at 16-byte plane pl0 onward, with
  // extra halo d = S - j - 1 over the stage's region
  __device__ __forceinline__ void chunk_source(int c, int& j, int& pl0) const {
    constexpr int XCH = NF / KC;  // chunks of x
    constexpr int CH_PL = KC / G::CPP;
    if (c < XCH) {
      j = 0;
      pl0 = c * CH_PL;
    } else {
      j = (c - XCH) / (GC / KC) + 1;
      pl0 = ((c - XCH) % (GC / KC)) * CH_PL;
    }
  }
  // store of output row m (a region pixel), channels co, co + 1 of stage S
  // (S < 5: into c_S; S = 5: y = x + 0.2 * (v + b5) to global memory)
  template <int S>
  __device__ __forceinline__ void store_pair(int m, int co, float v0, float v1) const {
    constexpr int RW = G::rw(S), HS = HALO - S;
    const int oy = m / RW, ox = m % RW;
    const int gh = h0 - HS + oy, gw = w0 - HS + ox;
    const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
    if constexpr (S < 5) {
      const float* b = p.b[S - 1];
      v0 = inside ? lrelu(v0 + __ldg(b + co)) : 0.f;
      v1 = inside ? lrelu(v1 + __ldg(b + co + 1)) : 0.f;
      T* dst = reinterpret_cast<T*>(
          reinterpret_cast<char*>(smem_ptr()) + G::buf(S) +
          ((co / G::CPP) * G::npix(S) + m) * 16) + co % G::CPP;
      store2(dst, v0, v1);
    } else {
      if (!inside) return;
      const float* b = p.b[4];
      const T* xs = reinterpret_cast<const T*>(
          reinterpret_cast<const char*>(smem_ptr()) + G::buf(0) +
          ((co / G::CPP) * G::npix(0) + (oy + HALO) * G::rw(0) + ox + HALO) * 16) + co % G::CPP;
      float x0, x1;
      load2(xs, x0, x1);
      T* out = y + (((size_t)n * H + gh) * W + gw) * NF + co;
      store2(out, x0 + 0.2f * (v0 + __ldg(b + co)), x1 + 0.2f * (v1 + __ldg(b + co + 1)));
    }
  }
  __device__ __forceinline__ static void* smem_ptr() {
    extern __shared__ __align__(128) unsigned char smem[];
    return smem;
  }
  __device__ __forceinline__ static void store2(float* d, float a, float b) {
    *reinterpret_cast<float2*>(d) = make_float2(a, b);
  }
  __device__ __forceinline__ static void store2(bf16* d, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(a, b);
  }
  __device__ __forceinline__ static void load2(const float* s, float& a, float& b) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    a = v.x;
    b = v.y;
  }
  __device__ __forceinline__ static void load2(const bf16* s, float& a, float& b) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s));
    a = v.x;
    b = v.y;
  }
};

// ------------------------------------------------------------- bf16 stages
// Stage S on wgmma: the two warpgroups take the region's 64-row M tiles in
// turn (warpgroup g: tiles g, g + 2, ...). u counts the weight units.
template <int S>
__device__ __forceinline__ void stage_bf16(const Tile<bf16, B16_TH, B16_TW>& t, int& u) {
  using G = Geo<bf16, B16_TH, B16_TW>;
  constexpr int NPIX = G::npix(S), RW = G::rw(S);
  constexpr int MTILES = (NPIX + 63) / 64, MT = (MTILES + 1) / 2;
  constexpr int NCH = (NF + GC * (S - 1)) / KC, NH = S == 5 ? 2 : 1;
  const int tid = threadIdx.x, wg = tid / 128, wq = (tid % 128) / 32, lane = tid % 32;

  float acc[MT][NH][16];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[i][h][e] = 0.f;

  // this lane's ldmatrix row in each of its M tiles: padding rows read the
  // region's last pixel
  int oy[MT], ox[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = min(64 * (wg + 2 * i) + 16 * wq + lane % 8 + 8 * ((lane / 8) % 2), NPIX - 1);
    oy[i] = m / RW;
    ox[i] = m % RW;
  }
  const int kp = lane / 16;  // K plane (channels 0-7 or 8-15 of the chunk)

  for (int c = 0; c < NCH; ++c) {
    int j, pl0;
    t.chunk_source(c, j, pl0);
    const int d = S - j - 1, rwj = G::rw(j);
    const uint32_t abase = t.buf_addr(j) + (pl0 + kp) * G::npix(j) * 16;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      t.ring_step(u);
      const uint32_t bbase = t.slot(u);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (wg + 2 * i >= MTILES) continue;  // uniform over the warpgroup
        const uint32_t arow = abase + ((oy[i] + d) * rwj + ox[i] + d) * 16;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          uint32_t a[3][4];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) ldmatrix_x4(a[dx], arow + (dy * rwj + dx) * 16);
          wgmma_fence();
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            // B: tap 3dy+dx of the unit, [K plane][N block][8 k][8 n]
            wgmma_m64n32k16_rs(acc[i][h], a[dx],
                               gmma_desc(bbase + (3 * dy + dx) * 1024, 512, 128));
          wgmma_commit();
          wgmma_wait<1>();  // the previous row's group: its fragments are free
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < MT; ++i) fence_acc(acc[i][h]);
      ++u;
    }
  }

  // epilogue on the fragments: acc[i][h][4 nb + 2 r + e] is M row 64 mt +
  // 16 wq + lane / 4 + 8 r, channel 32 h + 8 nb + 2 (lane % 4) + e
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mt = wg + 2 * i;
    if (mt >= MTILES) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = 64 * mt + 16 * wq + lane / 4 + 8 * r;
      if (m >= NPIX) continue;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          t.template store_pair<S>(m, 32 * h + 8 * nb + 2 * (lane % 4),
                                   acc[i][h][4 * nb + 2 * r], acc[i][h][4 * nb + 2 * r + 1]);
    }
  }
}

// -------------------------------------------------------------- f32 stages
// Stage S on 3xTF32 mma.sync: items are (16-row M tile, 8 NT output
// channels of the unit's 32), taken by the 8 warps in turn (warp w: items
// w, w + 8, ...), one item at a time. NT = 4 for c1..c4, whose M tiles
// outnumber the warps; 2 for y, whose 4 M tiles would leave half the warps
// idle. (Loading each B fragment once for all of a warp's items measured
// slower, as did cutting the last, partial round of items into single n8
// tiles, which balances the warps but splits each A fragment for 3
// products instead of 12.)
template <int S>
__device__ __forceinline__ void stage_f32(const Tile<float, F32_TH, F32_TW>& t, int& u) {
  using G = Geo<float, F32_TH, F32_TW>;
  constexpr int NPIX = G::npix(S), RW = G::rw(S);
  constexpr int NT = S < 5 ? 4 : 2, NG = UNIT_N / (8 * NT);
  constexpr int MTILES = (NPIX + 15) / 16, ITEMS = NG * MTILES;
  constexpr int NWARP = THREADS / 32, WI = (ITEMS + NWARP - 1) / NWARP;
  constexpr int NCH = (NF + GC * (S - 1)) / KC, NH = S == 5 ? 2 : 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  float acc[NH][WI][NT][4];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < WI; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][i][nt][e] = 0.f;

  // A: this lane's ldmatrix row (padding rows read the last pixel) and K
  // plane; B: its output channel row (of a pair of n8 tiles) and K plane
  int oy[WI], ox[WI];
#pragma unroll
  for (int i = 0; i < WI; ++i) {
    const int q = warp + NWARP * i;
    const int m = min(16 * (q / NG) + lane % 8 + 8 * ((lane / 8) % 2), NPIX - 1);
    oy[i] = m / RW;
    ox[i] = m % RW;
  }
  const int kpa = lane / 16;
  const int kpb = (lane / 8) % 2, nrow = 8 * (lane / 16) + lane % 8;

  for (int c = 0; c < NCH; ++c) {
    int j, pl0;
    t.chunk_source(c, j, pl0);
    const int d = S - j - 1, rwj = G::rw(j);
    const uint32_t pb = G::npix(j) * 16;
    const uint32_t abase = t.buf_addr(j) + (pl0 + kpa) * pb;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      t.ring_step(u);
      // slot: [tap][K plane of 4][32 n][4 k] f32
      const uint32_t bbase = t.slot(u) + (kpb * 32 + nrow) * 16;
#pragma unroll
      for (int i = 0; i < WI; ++i) {
        const int q = warp + NWARP * i;
        if (q >= ITEMS) continue;
        const uint32_t arow = abase + ((oy[i] + d) * rwj + ox[i] + d) * 16;
        const uint32_t brow = bbase + (q % NG) * 8 * NT * 16;
        // the chunk's 144 products in fresh registers
        float cacc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) cacc[nt][e] = 0.f;
#pragma unroll 3  // one kernel row at a time: the loads run ahead
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            uint32_t a[4], ab[4], as[4], b[NT][2], bb[NT][2], bs[NT][2];
            ldmatrix_x4(a, arow + 2 * ks * pb + (dy * rwj + dx) * 16);
#pragma unroll
            for (int pr = 0; pr < NT / 2; ++pr) {
              uint32_t r[4];
              ldmatrix_x4(r, brow + ((tap * 4 + 2 * ks) * 32 + 16 * pr) * 16);
              b[2 * pr][0] = r[0];
              b[2 * pr][1] = r[1];
              b[2 * pr + 1][0] = r[2];
              b[2 * pr + 1][1] = r[3];
            }
            split_tf32(a, ab, as);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) split_tf32(b[nt], bb[nt], bs[nt]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              mma_tf32(cacc[nt], as, bb[nt][0], bb[nt][1]);
              mma_tf32(cacc[nt], ab, bs[nt][0], bs[nt][1]);
              mma_tf32(cacc[nt], ab, bb[nt][0], bb[nt][1]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][i][nt][e] += cacc[nt][e];
      }
      ++u;
    }
  }

  // epilogue: acc[h][i][nt][2 r + e] is M row 16 (q / NG) + lane / 4 + 8 r,
  // channel 32 h + 8 NT (q % NG) + 8 nt + 2 (lane % 4) + e
#pragma unroll
  for (int i = 0; i < WI; ++i) {
    const int q = warp + NWARP * i;
    if (q >= ITEMS) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = 16 * (q / NG) + lane / 4 + 8 * r;
      if (m >= NPIX) continue;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          t.template store_pair<S>(m, 32 * h + 8 * NT * (q % NG) + 8 * nt + 2 * (lane % 4),
                                   acc[h][i][nt][2 * r], acc[h][i][nt][2 * r + 1]);
    }
  }
}

// grid: (tiles_h * tiles_w, N); block: THREADS; Geo::smem_bytes() dynamic.
__global__ void __launch_bounds__(THREADS, 1)
dense_block_kernel_bf16(const bf16* __restrict__ x, Params p, bf16* __restrict__ y, int H,
                        int W, int tiles_w) {
  Tile<bf16, B16_TH, B16_TW> t{x, y, p, (int)blockIdx.y,
                               (int)(blockIdx.x / tiles_w) * B16_TH,
                               (int)(blockIdx.x % tiles_w) * B16_TW, H, W,
                               (uint32_t)__cvta_generic_to_shared(
                                   Tile<bf16, B16_TH, B16_TW>::smem_ptr())};
  t.start();
  int u = 0;
  stage_bf16<1>(t, u);
  stage_bf16<2>(t, u);
  stage_bf16<3>(t, u);
  stage_bf16<4>(t, u);
  stage_bf16<5>(t, u);
}

__global__ void __launch_bounds__(THREADS, 1)
dense_block_kernel_f32(const float* __restrict__ x, Params p, float* __restrict__ y, int H,
                       int W, int tiles_w) {
  Tile<float, F32_TH, F32_TW> t{x, y, p, (int)blockIdx.y,
                                (int)(blockIdx.x / tiles_w) * F32_TH,
                                (int)(blockIdx.x % tiles_w) * F32_TW, H, W,
                                (uint32_t)__cvta_generic_to_shared(
                                    Tile<float, F32_TH, F32_TW>::smem_ptr())};
  t.start();
  int u = 0;
  stage_f32<1>(t, u);
  stage_f32<2>(t, u);
  stage_f32<3>(t, u);
  stage_f32<4>(t, u);
  stage_f32<5>(t, u);
}

template <typename T, int TH, int TW, typename K>
cudaError_t launch(K kernel, const void* x, const Params& p, void* y, int N, int H, int W,
                   cudaStream_t s) {
  constexpr int SMEM = Geo<T, TH, TW>::smem_bytes();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  kernel<<<dim3(tiles_w * tiles_h, N), THREADS, SMEM, s>>>(
      static_cast<const T*>(x), p, static_cast<T*>(y), H, W, tiles_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of the tensors and the stream.
// dtype: 0 = float32, 1 = bfloat16 (x, y and the packed weights w, which
// the wrapper lays out as the kernel's weight units). b1..b5 are the
// biases, contiguous f32. x, y and w are 16-byte aligned.
int tpusr_dense_block(int device, int dtype, const void* x, const void* w, const void* b1,
                      const void* b2, const void* b3, const void* b4, const void* b5,
                      void* y, int N, int H, int W, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p = {w,
                    {static_cast<const float*>(b1), static_cast<const float*>(b2),
                     static_cast<const float*>(b3), static_cast<const float*>(b4),
                     static_cast<const float*>(b5)}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? launch<float, F32_TH, F32_TW>(dense_block_kernel_f32, x, p, y, N, H, W, s)
            : launch<bf16, B16_TH, B16_TW>(dense_block_kernel_bf16, x, p, y, N, H, W, s);
  return static_cast<int>(err);
}

}  // extern "C"
