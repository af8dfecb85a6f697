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
// M = the region's pixels, N = 32 (c1..c4) or 64 (y), K = 9 x Cin (Cin =
// 64, 96, 128, 160, 192), in 16-channel chunks. bf16 and f32 are two
// kernels that share the layout below and no main loop.
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
//   columns, no region rounded to 8. The biases are read as f32.
//
//   bf16: a 16 x 16 output tile on wgmma, f32 accumulators. B comes from a
//   weight slot as an N-major operand (8 x 8 core matrices, K plane along
//   LBO, N block along SBO). c1..c4 take m64n32k16, y one m64n64k16 over
//   all 64 outputs, so each of y's A operands is read once. A comes
//   straight from shared memory where 8 x 8 pixel blocks tile the region
//   (c1's 24^2, y's 16^2: an M tile is one block, 8 pixels of a row a core
//   matrix, the block's rows SBO = pitch apart, the chunk's two planes LBO
//   apart), and from ldmatrix fragments in registers elsewhere (c2..c4,
//   whose regions 22^2, 20^2, 18^2 no 8 x 8 blocks tile: an M tile is 64
//   region pixels in row order).
//   What bounds it: shared memory's 128 bytes a clock. A m64n32k16 reads 2
//   KB of A and 1 KB of B for 16 clocks of the SM's tensor cores, so c1..c4
//   can reach 67 % of the tensor rate; y's m64n64k16 reads 4 KB in 32
//   clocks and can reach all of it. Measured on the H100, two warpgroups
//   of one SM, 3-wgmma groups: m64n32k16 24 clocks a wgmma with A in shared
//   memory, 29 with A by ldmatrix, 16 with A left in registers; m64n64k16
//   32 with A in shared memory, 41 by ldmatrix.
//   Roles: 384 threads, one block per SM. Warpgroup 0 is the producer
//   (setmaxnreg down to 40): lane 0 of its warp 0 streams the weight units
//   into the ring, one 1-D bulk async copy (cp.async.bulk, completing a
//   transaction count on the slot's mbarrier) per unit; its warps 1-3 and
//   the consumers load x by 16-byte cp.async (zero-filled outside the
//   image), one chunk of two planes after the other, each chunk behind its
//   own mbarrier, so c1 starts on the first chunk (352 loaders: the
//   consumers have nothing else to do before x lands; 96 measured 0.015 ms
//   a launch slower). Warpgroups 1 and 2 are the consumers (setmaxnreg up
//   to 232): they take the stage's M tiles in turn (0, 2, ... and 1, 3,
//   ...) and keep one 3-wgmma group (one kernel row of one M tile) in
//   flight while they set up the next, across unit and chunk boundaries.
//   Where a stage has an odd number of M tiles (c1's nine, c3's seven) the
//   second consumer computes a padding tile, so both run one copy of the
//   loop with no branch among the groups (a branch there makes ptxas
//   serialise the wgmmas; two copies of the loop measured slower).
//   Weights: the wrapper packs them once per frame, in the order the kernel
//   consumes them: 120 units, one per stage, 16-channel chunk and kernel
//   row, 3 taps x 16 input channels x 32 outputs (c1..c4, 3,072 bytes) or
//   x 64 (y, 6,144), each laid out as its slot, [tap][K plane][N block]
//   [8 k][8 n]. The ring holds B16_RING slots of 6,144 bytes, each with a
//   full mbarrier (the producer's expect_tx, completed by the copy's bytes)
//   and an empty one (one arrival per consumer warp, made once the wgmma
//   group that read the slot last has retired: wgmma.wait_group 1 after the
//   next unit's first group, never 0). A consumer waits only on the full
//   barrier of the slot it is about to read; the producer only on the
//   empty barrier of the slot it refills, so units run five ahead.
//   Stages: c_s must be whole before a stage reads it. Each consumer thread
//   stores its part of c_s, fences it for wgmma's reads (the async proxy)
//   and arrives on c_s's mbarrier; a consumer waits on it only before its
//   first chunk of c_s. Every stage reads x first (4 chunks), so a
//   warpgroup that finishes a stage early goes on. No block-wide barrier
//   after the barriers' set-up.
//   Shared memory: 256 bytes of mbarriers + 5 x 6,144 for the weight ring +
//   200,704 for x and c1..c4 = 231,680 of the 232,448 a block may use.
//   Registers (ptxas -v for sm_90a): 168 a thread at launch (384 threads,
//   one block per SM), then 40 in the producer and up to 232 in the
//   consumers; no spills.
//   Time (clock64 in two blocks of a 270 x 480 frame, each consumer): x's
//   first chunk lands 7,600-8,600 clocks after the start; then c1 takes
//   9,000-11,300 clocks, c2 16,000-17,500, c3 21,000-21,700, c4 19,400-
//   20,500, y 17,500-18,800 (each with the previous stage's stores) and y's
//   stores 2,000-3,000: ~96,000 clocks, 53 us at 1.8 GHz, where the wgmmas
//   alone at the rates above take ~68,000 (360 of c1 at 24, 1,548 of c2..c4
//   at 29, 432 of y at 32).
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
//   16-channel) items of y in turn. Its weights are 52 units of 9 taps x 16
//   input channels x 32 outputs (stage 5: two per chunk, one per half of
//   N), [tap][K plane of 4][32 n][4 k], which a ring of RING slots takes by
//   cp.async, two units ahead of the one in use, beside the compute.
//
//   Recompute, with M padding (the useful work is 239,616 multiply-adds a
//   pixel): bf16 16 x 16 tile 1.481x (354,816 a pixel; regions 26^2 x,
//   24^2, 22^2, 20^2, 18^2, 16^2; the waste beyond the halo is M padded to
//   64 rows, 0, 28, 48, 60 and 0 rows for c1..c4 and y, and the padding
//   tiles of c1 and c3; 1.423x, 340,992 a pixel, without those two tiles);
//   f32 8 x 8 tile 1.827x (regions
//   18^2 .. 8^2, M padded to 16: 0, 12, 0, 12, 0 rows), 2.231x with the
//   warps' turns. Shared memory in f32: 172,032
//   bytes for x and c1..c4 + 3 x 18,432 for the weight ring = 227,328; one
//   block of 256 threads (8 warps) per SM, 113 registers a thread (ptxas -v
//   for sm_90a, no spills).

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

// bf16 kernel (wgmma, warp-specialised)
constexpr int B16_TH = 16;        // output tile rows
constexpr int B16_TW = 16;        // output tile columns
constexpr int B16_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int B16_NUNITS = 120;   // (4 + 6 + 8 + 10 + 12 chunks) x 3 kernel rows
constexpr int B16_RING = 5;       // weight slots
constexpr int B16_SLOT = 6144;    // bytes a slot: the largest unit, 3 x 16 x 64 bf16
constexpr int B16_BARS = 256;     // bytes of mbarriers at the head of shared memory
constexpr int B16_XLOADERS = 352;  // threads that load x: all but the producer's warp 0
constexpr int B16_PRODUCER_REGS = 40;
constexpr int B16_CONSUMER_REGS = 232;

// f32 kernel (3xTF32 mma.sync)
constexpr int F32_TH = 8;
constexpr int F32_TW = 8;
constexpr int UNIT_N = 32;   // output channels per weight unit
constexpr int NUNITS = 52;   // 4 + 6 + 8 + 10 + 2 x 12 weight units a tile
constexpr int THREADS = 256;
constexpr int RING = 3;      // weight slots: units issued two ahead

// A tile's geometry for storage type T: stage s = 0 (x), 1..4 (c_s), 5 (y);
// x's buffer starts HEAD bytes into shared memory.
template <typename T, int TH, int TW, int HEAD>
struct Geo {
  static constexpr int CPP = 16 / (int)sizeof(T);  // channels per 16-byte plane
  __host__ __device__ static constexpr int rw(int s) { return TW + 2 * (HALO - s); }
  __host__ __device__ static constexpr int rh(int s) { return TH + 2 * (HALO - s); }
  __host__ __device__ static constexpr int npix(int s) { return rw(s) * rh(s); }
  __host__ __device__ static constexpr int planes(int s) { return (s == 0 ? NF : GC) / CPP; }
  // byte offset of buffer s (0 = x, 1..4 = c_s)
  __host__ __device__ static constexpr int buf(int s) {
    return s == 0 ? HEAD : buf(s - 1) + npix(s - 1) * planes(s - 1) * 16;
  }
  __host__ __device__ static constexpr int smem_bytes() { return buf(5); }
};

constexpr int F32_UNIT_BYTES = 9 * KC * UNIT_N * 4;
using GB = Geo<bf16, B16_TH, B16_TW, B16_BARS + B16_RING * B16_SLOT>;
using GF = Geo<float, F32_TH, F32_TW, RING * F32_UNIT_BYTES>;
static_assert(GB::smem_bytes() <= 232448, "bf16 over 227 KB");
static_assert(GF::smem_bytes() <= 232448, "f32 over 227 KB");
static_assert(B16_PRODUCER_REGS * 128 + B16_CONSUMER_REGS * 256 <= 65536, "bf16 registers");

// bf16 units: stages 1-4 one per chunk and kernel row at N = 32, then stage
// 5 at N = 64
constexpr int B16_SMALL = 3 * (4 + 6 + 8 + 10);
constexpr int B16_SMALL_BYTES = 3 * KC * GC * 2;
static_assert(B16_NUNITS == B16_SMALL + 3 * 12, "bf16 units");
static_assert(B16_SLOT == 2 * B16_SMALL_BYTES, "bf16 slot");

struct Params {
  const void* w;       // packed weight units (bf16 or f32)
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
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
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
// d += A (shared, K-major) x B (shared, N-major), bf16 -> f32
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
// mbarriers (shared addresses) and the copies that complete them
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes global -> shared in one bulk copy, counted on bar's transactions
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
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

// ------------------------------------------------------------- the tile
// Per block: the tile's origin, the shared-memory base and where each
// chunk's operand lies.
template <typename T, typename G>
struct Tile {
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
  __device__ __forceinline__ static void* smem_ptr() {
    extern __shared__ __align__(128) unsigned char smem[];
    return smem;
  }
};

// ------------------------------------------------------------- bf16 kernel
// The ring, x and c1..c4 behind mbarriers at the head of shared memory, 8
// bytes each: full[r] and empty[r] of slot r, x_ready[c] of x's chunk c,
// c_ready[s] of c_s; the slots follow.
struct B16Tile : Tile<bf16, GB> {
  __device__ __forceinline__ uint32_t full(int r) const { return sbase + 8 * r; }
  __device__ __forceinline__ uint32_t empty(int r) const { return sbase + 8 * (B16_RING + r); }
  __device__ __forceinline__ uint32_t x_ready(int c) const {
    return sbase + 8 * (2 * B16_RING + c);
  }
  __device__ __forceinline__ uint32_t c_ready(int s) const {
    return sbase + 8 * (2 * B16_RING + NF / KC + s - 1);
  }
  __device__ __forceinline__ uint32_t slot(int r) const {
    return sbase + B16_BARS + r * B16_SLOT;
  }
  __device__ __forceinline__ void init_barriers() const {
    for (int r = 0; r < B16_RING; ++r) {
      mbar_init(full(r), 1);  // the producer's expect_tx
      mbar_init(empty(r), (B16_THREADS - 128) / 32);  // one arrival per consumer warp
    }
    for (int c = 0; c < NF / KC; ++c) mbar_init(x_ready(c), B16_XLOADERS);
    for (int s = 1; s <= 4; ++s) mbar_init(c_ready(s), B16_THREADS - 128);
    mbar_init_fence();
  }
  // the producer: unit u into slot u % B16_RING once the consumers have
  // released the unit that slot held
  __device__ __forceinline__ void produce() const {
    const char* w = static_cast<const char*>(p.w);
    for (int u = 0; u < B16_NUNITS; ++u) {
      const int r = u % B16_RING;
      if (u >= B16_RING) mbar_wait(empty(r), ((u / B16_RING) & 1) ^ 1);
      const bool small = u < B16_SMALL;
      const int bytes = small ? B16_SMALL_BYTES : 2 * B16_SMALL_BYTES;
      const size_t off = small ? (size_t)u * B16_SMALL_BYTES
                               : (size_t)(2 * u - B16_SMALL) * B16_SMALL_BYTES;
      mbar_expect_tx(full(r), bytes);
      bulk_copy(slot(r), w + off, bytes, full(r));
    }
  }
  // x on the tile grown by HALO, zero outside the image, chunk by chunk
  // (two planes), each chunk signalled on its own barrier so that c1 starts
  // on the first: loader thread first takes plane first % 2 of the chunk
  // and the pixels first / 2, + stride / 2, ... (neighbouring threads take
  // one pixel's 32 contiguous bytes), its place in the image kept by
  // additions. A chunk is signalled once the thread's copies of it have
  // landed and been fenced for wgmma's reads (the async proxy), while the
  // next chunk's copies are in flight.
  __device__ __forceinline__ void load_x(int first, int stride) const {
    using G = GB;
    constexpr int RW = G::rw(0), NPIX = G::npix(0), CP = KC / G::CPP;
    const int step = stride / CP, q0 = first / CP;
    const bf16* img = x + (size_t)n * H * W * NF + (first % CP) * G::CPP;
#pragma unroll 1
    for (int c = 0; c < NF / KC; ++c) {
      const uint32_t dst = sbase + G::buf(0) + (c * CP + first % CP) * NPIX * 16;
      int gy = h0 - HALO + q0 / RW, qx = q0 % RW;
      for (int q = q0; q < NPIX; q += step) {
        const int gx = w0 - HALO + qx;
        const bool in = (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W;
        cp_async16(dst + q * 16, in ? img + ((size_t)gy * W + gx) * NF + c * KC : x,
                   in ? 16 : 0);
        for (qx += step; qx >= RW; qx -= RW) ++gy;
      }
      cp_async_commit();
      if (c > 0) {
        cp_async_wait<1>();
        fence_proxy_async();
        mbar_arrive(x_ready(c - 1));
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    mbar_arrive(x_ready(NF / KC - 1));
  }
};

// The stage's M tiles: where 8 x 8 pixel blocks tile the region (c1's 24^2,
// y's 16^2), a tile is one block and wgmma reads A straight from shared
// memory (8 pixels of a row are a core matrix, the block's rows SBO =
// pitch apart, the chunk's two planes LBO apart); elsewhere a tile is 64
// region pixels in row order, padded at the end, and A comes from ldmatrix
// fragments in registers. Tile mt's accumulator row 16 wq + lane / 4 + 8 r
// is region pixel pixel(mt, wq, lane, r).
template <int S>
struct Tiling {
  static constexpr int RW = GB::rw(S), RH = GB::rh(S), NPIX = GB::npix(S);
  static constexpr bool SS = RW % 8 == 0 && RH % 8 == 0;
  static constexpr int MTILES = SS ? (RW / 8) * (RH / 8) : (NPIX + 63) / 64;
  __device__ __forceinline__ static int pixel(int mt, int wq, int lane, int r) {
    return SS ? (8 * (mt / (RW / 8)) + 2 * wq + r) * RW + 8 * (mt % (RW / 8)) + lane / 4
              : 64 * mt + 16 * wq + lane / 4 + 8 * r;
  }
};

// Stage S's outputs in this consumer's channels 8 nb + 2 (lane % 4) + e:
// their biases, read once a stage.
template <int S, int NB>
__device__ __forceinline__ void load_bias(const B16Tile& t, int lane, float2 (&bias)[NB]) {
  const float* b = t.p.b[S - 1] + 2 * (lane % 4);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) bias[nb] = make_float2(__ldg(b + 8 * nb), __ldg(b + 8 * nb + 1));
}

// Tile mt's stores from one consumer warpgroup's accumulators: acc[4 nb + 2
// r + e] is row 16 wq + lane / 4 + 8 r, channel 8 nb + 2 (lane % 4) + e. c_S
// goes to shared memory (lrelu(v + b), zero outside the image), y = x + 0.2
// (v + b5) to global memory. Each row's place is found once; its stores
// differ by constant offsets.
template <int S, int NB>
__device__ __forceinline__ void store_tile(const B16Tile& t, const float (&acc)[4 * NB],
                                           const float2 (&bias)[NB], int mt, int wq,
                                           int lane) {
  using G = GB;
  using TL = Tiling<S>;
  constexpr int NPIX = G::npix(S), RW = G::rw(S), HS = HALO - S;
  if (mt >= TL::MTILES) return;  // a padding tile
  const int cq = 2 * (lane % 4);  // this lane's channels in each block of 8
  char* smem = static_cast<char*>(B16Tile::smem_ptr());
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = TL::pixel(mt, wq, lane, r);
    if (m >= NPIX) continue;
    const int oy = m / RW, ox = m % RW;
    const int gh = t.h0 - HS + oy, gw = t.w0 - HS + ox;
    const bool inside = gh >= 0 && gh < t.H && gw >= 0 && gw < t.W;
    if constexpr (S < 5) {
      char* dst = smem + G::buf(S) + m * 16 + 2 * cq;  // plane nb at + nb * NPIX * 16
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float v0 = inside ? lrelu(acc[4 * nb + 2 * r] + bias[nb].x) : 0.f;
        const float v1 = inside ? lrelu(acc[4 * nb + 2 * r + 1] + bias[nb].y) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(dst + nb * NPIX * 16) = __floats2bfloat162_rn(v0, v1);
      }
    } else {
      if (!inside) continue;
      const char* xs = smem + G::buf(0) + ((oy + HALO) * G::rw(0) + ox + HALO) * 16 + 2 * cq;
      bf16* out = t.y + (((size_t)t.n * t.H + gh) * t.W + gw) * NF + cq;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + nb * G::npix(0) * 16));
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * nb) =
            __floats2bfloat162_rn(xv.x + 0.2f * (acc[4 * nb + 2 * r] + bias[nb].x),
                                  xv.y + 0.2f * (acc[4 * nb + 2 * r + 1] + bias[nb].y));
      }
    }
  }
}

// Stage S on one consumer warpgroup: M tiles first, first + 2, ... (first =
// the warpgroup, 0 or 1), unit by unit (a chunk's kernel row dy: 3 taps),
// one 3-wgmma group per (unit, M tile), one group left in flight at each
// wait (two measured no faster). u counts the units. Where the stage has an odd number of M
// tiles (c1's nine, c3's seven), the second warpgroup computes a padding
// tile (it repeats the last tile's reads, nothing is stored), so both run
// one copy of the loop with no branch among the groups: a warpgroup-uniform
// branch there makes ptxas serialise the wgmmas, and a second copy of the
// loop for the smaller count measured slower than the padding tile.
template <int S>
__device__ __forceinline__ void stage_bf16(const B16Tile& t, int& u) {
  using G = GB;
  using TL = Tiling<S>;
  constexpr int MT = (TL::MTILES + 1) / 2;
  constexpr int NCH = (NF + GC * (S - 1)) / KC;
  constexpr int N = S == 5 ? NF : GC;  // outputs: all of them in one product
  constexpr int TAP = 2 * KC * N;      // bytes of a tap in a unit
  const int ct = threadIdx.x - 128, first = ct / 128, wq = (ct % 128) / 32, lane = ct % 32;
  const int kp = TL::SS ? 0 : lane / 16;  // ldmatrix: K plane, channels 0-7 or 8-15

  // per tile, its accumulators and where its A starts: with A in shared
  // memory, the block's first pixel; by ldmatrix, this lane's row (padding
  // rows read the region's last pixel)
  float acc[MT][N / 2];
  int oy[MT], ox[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[i][e] = 0.f;
    const int m = TL::SS ? TL::pixel(min(first + 2 * i, TL::MTILES - 1), 0, 0, 0)
                         : min(64 * (first + 2 * i) + 16 * wq + lane % 8 + 8 * ((lane / 8) % 2),
                               TL::NPIX - 1);
    oy[i] = m / TL::RW;
    ox[i] = m % TL::RW;
    fence_acc(acc[i]);
  }

  for (int c = 0; c < NCH; ++c) {
    int j, pl0;
    t.chunk_source(c, j, pl0);
    if (S == 1) mbar_wait(t.x_ready(c), 0);
    if (S > 1 && c == 2 * S) mbar_wait(t.c_ready(S - 1), 0);  // first chunk of c_{S-1}
    const int d = S - j - 1, rwj = G::rw(j);
    const uint32_t abase = t.buf_addr(j) + (pl0 + kp) * G::npix(j) * 16;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy, ++u) {
      const int r = u % B16_RING;
      const uint32_t bslot = t.slot(r);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint32_t arow = abase + ((oy[i] + d + dy) * rwj + ox[i] + d) * 16;
        if constexpr (TL::SS) {
          if (i == 0) mbar_wait(t.full(r), (u / B16_RING) & 1);
          wgmma_fence();
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            wgmma_ss(acc[i], gmma_desc(arow + dx * 16, G::npix(j) * 16, rwj * 16),
                     gmma_desc(bslot + dx * TAP, TAP / 2, 128));
        } else {
          uint32_t a[3][4];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) ldmatrix_x4(a[dx], arow + dx * 16);
          if (i == 0) mbar_wait(t.full(r), (u / B16_RING) & 1);
          wgmma_fence();
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            // B: tap dx of the unit, [K plane][N block][8 k][8 n]
            wgmma_rs(acc[i], a[dx], gmma_desc(bslot + dx * TAP, TAP / 2, 128));
        }
        wgmma_commit();
        wgmma_wait<1>();  // older groups have retired: their fragments are free
        // ... and with them the previous unit: its slot goes back to the producer
        if (i == 0 && (c > 0 || dy > 0) && lane == 0)
          mbar_arrive(t.empty((u + B16_RING - 1) % B16_RING));
      }
    }
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(t.empty((u + B16_RING - 1) % B16_RING));

  float2 bias[N / 8];
  load_bias<S>(t, lane, bias);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    fence_acc(acc[i]);
    store_tile<S>(t, acc[i], bias, first + 2 * i, wq, lane);
  }
  if (S < 5) {
    fence_proxy_async();  // c_S is read by wgmma (y's products) as well as ldmatrix
    mbar_arrive(t.c_ready(S));
  }
}

// grid: (tiles_h * tiles_w, N); block: B16_THREADS; GB::smem_bytes() dynamic.
__global__ void __launch_bounds__(B16_THREADS, 1)
dense_block_kernel_bf16(const bf16* __restrict__ x, Params p, bf16* __restrict__ y, int H,
                        int W, int tiles_w) {
  const B16Tile t{{x, y, p, (int)blockIdx.y, (int)(blockIdx.x / tiles_w) * B16_TH,
                   (int)(blockIdx.x % tiles_w) * B16_TW, H, W,
                   (uint32_t)__cvta_generic_to_shared(B16Tile::smem_ptr())}};
  const int tid = threadIdx.x;
  if (tid == 0) t.init_barriers();
  __syncthreads();
  if (tid < 128) {  // the producer warpgroup
    setmaxnreg_dec<B16_PRODUCER_REGS>();
    if (tid == 0) {
      t.produce();
    } else if (tid >= 32) {
      t.load_x(tid - 32, B16_XLOADERS);  // x's first 96 loaders
    }
  } else {  // the consumer warpgroups
    setmaxnreg_inc<B16_CONSUMER_REGS>();
    t.load_x(tid - 32, B16_XLOADERS);  // x's other 256: nothing else to do before it lands
    int u = 0;
    stage_bf16<1>(t, u);
    stage_bf16<2>(t, u);
    stage_bf16<3>(t, u);
    stage_bf16<4>(t, u);
    stage_bf16<5>(t, u);
  }
}

// -------------------------------------------------------------- f32 kernel
// x's load, the stores of every stage and the weight ring: RING slots of
// one unit, filled by cp.async from every thread, behind block-wide
// barriers.
struct F32Tile : Tile<float, GF> {
  using G = GF;
  // x on the tile grown by HALO, zero outside the image, by threads first,
  // first + stride, ...: neighbouring threads take the planes of one pixel
  // (contiguous global bytes)
  __device__ __forceinline__ void issue_x(int first, int stride) const {
    constexpr int PL = G::planes(0), RW = G::rw(0), NPIX = G::npix(0);
    const uint32_t dst = sbase + G::buf(0);
    for (int i = first; i < NPIX * PL; i += stride) {
      const int pl = i % PL, q = i / PL;
      const int gh = h0 - HALO + q / RW, gw = w0 - HALO + q % RW;
      const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
      const float* src = in ? x + (((size_t)n * H + gh) * W + gw) * NF + pl * G::CPP : x;
      cp_async16(dst + (pl * NPIX + q) * 16, src, in ? 16 : 0);
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
      float* dst = reinterpret_cast<float*>(
          reinterpret_cast<char*>(smem_ptr()) + G::buf(S) +
          ((co / G::CPP) * G::npix(S) + m) * 16) + co % G::CPP;
      store2(dst, v0, v1);
    } else {
      if (!inside) return;
      const float* b = p.b[4];
      const float* xs = reinterpret_cast<const float*>(
          reinterpret_cast<const char*>(smem_ptr()) + G::buf(0) +
          ((co / G::CPP) * G::npix(0) + (oy + HALO) * G::rw(0) + ox + HALO) * 16) + co % G::CPP;
      float x0, x1;
      load2(xs, x0, x1);
      float* out = y + (((size_t)n * H + gh) * W + gw) * NF + co;
      store2(out, x0 + 0.2f * (v0 + __ldg(b + co)), x1 + 0.2f * (v1 + __ldg(b + co + 1)));
    }
  }
  __device__ __forceinline__ static void store2(float* d, float a, float b) {
    *reinterpret_cast<float2*>(d) = make_float2(a, b);
  }
  __device__ __forceinline__ static void load2(const float* s, float& a, float& b) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    a = v.x;
    b = v.y;
  }
  __device__ __forceinline__ uint32_t slot(int u) const {
    return sbase + (u % RING) * F32_UNIT_BYTES;
  }
  __device__ __forceinline__ void issue_unit(int u) const {
    const char* src = static_cast<const char*>(p.w) + (size_t)u * F32_UNIT_BYTES;
    const uint32_t dst = slot(u);
    for (int i = threadIdx.x; i < F32_UNIT_BYTES / 16; i += THREADS)
      cp_async16(dst + 16 * i, src + 16 * i, 16);
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
    issue_x(threadIdx.x, THREADS);
#pragma unroll
    for (int v = 0; v < RING - 1; ++v) {
      issue_unit(v);  // group 0 also holds x
      cp_async_commit();
    }
  }
};

// Stage S on 3xTF32 mma.sync: items are (16-row M tile, 8 NT output
// channels of the unit's 32), taken by the 8 warps in turn (warp w: items
// w, w + 8, ...), one item at a time. NT = 4 for c1..c4, whose M tiles
// outnumber the warps; 2 for y, whose 4 M tiles would leave half the warps
// idle. (Loading each B fragment once for all of a warp's items measured
// slower, as did cutting the last, partial round of items into single n8
// tiles, which balances the warps but splits each A fragment for 3
// products instead of 12.)
template <int S>
__device__ __forceinline__ void stage_f32(const F32Tile& t, int& u) {
  using G = GF;
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

// grid: (tiles_h * tiles_w, N); block: THREADS; GF::smem_bytes() dynamic.
__global__ void __launch_bounds__(THREADS, 1)
dense_block_kernel_f32(const float* __restrict__ x, Params p, float* __restrict__ y, int H,
                       int W, int tiles_w) {
  const F32Tile t{{x, y, p, (int)blockIdx.y, (int)(blockIdx.x / tiles_w) * F32_TH,
                   (int)(blockIdx.x % tiles_w) * F32_TW, H, W,
                   (uint32_t)__cvta_generic_to_shared(F32Tile::smem_ptr())}};
  t.start();
  int u = 0;
  stage_f32<1>(t, u);
  stage_f32<2>(t, u);
  stage_f32<3>(t, u);
  stage_f32<4>(t, u);
  stage_f32<5>(t, u);
}

template <typename T, typename G, int TH, int TW, int NTHREADS, typename K>
cudaError_t launch(K kernel, const void* x, const Params& p, void* y, int N, int H, int W,
                   cudaStream_t s) {
  constexpr int SMEM = G::smem_bytes();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  kernel<<<dim3(tiles_w * tiles_h, N), NTHREADS, SMEM, s>>>(
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
  err = dtype == 0 ? launch<float, GF, F32_TH, F32_TW, THREADS>(dense_block_kernel_f32, x, p,
                                                                y, N, H, W, s)
                   : launch<bf16, GB, B16_TH, B16_TW, B16_THREADS>(dense_block_kernel_bf16, x,
                                                                   p, y, N, H, W, s);
  return static_cast<int>(err);
}

}  // extern "C"
