// SwinIR's token linears, written by hand for Hopper (sm_90a), on the tensor
// cores: the four products of every Swin layer, each with its pointwise work
// finished in the epilogue before its single store,
//
//   qkv = LN1(x) W_qkv^T + b                       (K 180 -> N 540)
//   x'  = x + A W_proj^T + b                       (180 -> 180, A the attention)
//   h   = GELU(LN2(x') W_fc1^T + b)                (180 -> 360, erf's GELU)
//   out = x' + h W_fc2^T + b                       (360 -> 180)
//
// on bf16 token rows (M = B * H * W rows of K values, row-major), bf16
// weights, bias and residual, f32 accumulation: the bias and the residual
// are added to the f32 accumulator, GELU is x * 0.5 * (1 + erff(x / sqrt 2))
// in f32 (F.gelu's default, not the tanh form), and the result is rounded to
// bf16 once, at the store.
//
// It replaces no TPU kernel: tpusr has no transformer. It was added because
// cuBLAS runs these products as sm80 `align2` kernels (a 360-byte token row
// is 8-byte but not 16-byte aligned), 23 ms of a 1080p frame, with GELU and
// the residual adds as separate ATen passes besides.
//
// What bounds it on the H100: bytes. At M = 130,560 (a 272 x 480 frame) the
// four products do 2 M (540 + 180 + 360) 180 + 2 M 360 180 = 67.7 GFLOP a
// layer, 68 us at 989 TFLOP/s, against 658 MB a layer moved once (x 47 MB
// read and qkv 141 MB written; A, x and x' 47 MB each; LN2(x') 47 MB read
// and h 94 MB written; h 94, x' 47 read and the output 47 written), 196 us
// at 3.35 TB/s: ~103 operations a byte, under the card's 295. So the design
// reads each A row and each residual row once, writes each output once, and
// keeps the weights in shared memory.
//
// Design. One persistent block per SM walks 64-row tiles of A; a block owns
// one slice of N (``splits`` slices: the weights of a whole product do not
// fit beside the ring, 540 x 192 bf16 is 207 KB) and keeps that slice's
// weights resident in shared memory, loaded once by one bulk copy. Blocks
// i and i + 1 own the two slices of one tile walk, so a tile's second read
// comes from L2. Two warpgroups, 256 threads, take the walk's tiles in turn
// (0, 2, ... and 1, 3, ...); no producer warp, so that each thread may hold
// 255 registers (a third, producer warpgroup held them to 168: ptxas
// serialised the wgmmas and spilled).
//
//   A tiles. A tile of 64 consecutive rows is one contiguous run of
//   64 x K x 2 bytes (23,040 at K = 180, a multiple of 16 although each row
//   is only 8-byte aligned), so thread 0 of a warpgroup brings it into a
//   ring slot with ONE 1-D bulk copy (cp.async.bulk, completing bytes on the
//   slot's mbarrier); a ragged last tile of an odd row count ends on 8 bytes
//   that it moves by hand before it arrives. The slot keeps the rows as
//   they lie in memory (row pitch 2K bytes): no re-layout, no padding. The
//   ring has an even number of slots (as many as fit, at most 6), so slot s
//   belongs to warpgroup s % 2, which refills it with its tile j + slots as
//   soon as it holds tile j's fragments: each mbarrier has one waiter that
//   walks its phases in order, and no slot needs an empty barrier.
//   A in registers. A 64-row tile's whole K sits in the warpgroup's
//   registers as wgmma's m64k16 A fragments (12 k-steps at K <= 192 are 48
//   registers; 23 at K <= 368 are 92), read from the raw rows by 32-bit
//   shared loads, and the slot is refilled at once. The K
//   tail (K = 180 is 11 x 16 + 4; 360 is 22 x 16 + 8) is zero: a fragment
//   register whose k is at or beyond K is never loaded and holds 0, so the
//   last step sees no byte of the next row; the weights' padded K rows are
//   zero too.
//   Products. wgmma m64n96k16, A from registers, B (the weights) from
//   shared memory, K-major without swizzle: the wrapper packs each slice as
//   [k-step][8-column group][k half][8 n][8 k], so a k-step's B for 96
//   columns is 12 x 2 core matrices of 128 bytes (LBO 128 along K, SBO 256
//   along N). A slice is ``chunks`` products of 96 columns; with two or
//   three, the next chunk's k-steps are issued before this chunk's epilogue
//   (two accumulator sets), so its tensor work overlaps the epilogue.
//   Epilogue. Each thread adds the bias (kept in shared memory as f32), the
//   residual (its pairs of every chunk loaded from device memory at the
//   tile's start, so the loads land while the products run) and applies
//   GELU, rounds to bf16, and writes the pair into its warpgroup's staging
//   tile (64 x 96, pitch 208 bytes: conflict-free); then the warpgroup
//   copies the staging tile out with coalesced 8-byte stores, all 12 of a
//   thread's loads before its stores, the column range masked at N (the
//   slices pad N to 96-column multiples) and the rows at M.
//   Shared memory: 128 bytes of mbarriers, the weight slice (96 to 288
//   columns x 12 or 23 k-steps x 32 bytes, at most 110,592 bytes), its
//   bias, two staging tiles of 13,312 bytes and the ring: qkv 4 slots of
//   23,040 (230,656 in all), proj and fc1 4, fc2 2 of 46,080.
//
// Measured on an H100 (700 W), the cell's 130,560 tokens, device time a
// launch against the bytes moved once: qkv 102 us (55 % of 56.1), proj 58
// (73 % of 42.1), fc1 112 (38 % of 42.1), fc2 74 (76 % of 56.1). Where it
// falls short: the stores. The same kernel with its stores left out takes
// qkv 56 us; with them, 102: a warpgroup's copy-out stalls on them and does
// not overlap its neighbour's products enough (qkv writes 141 MB). And
// fc1's GELU: erff is ~26 instructions (branch-free, its two polynomials'
// coefficients selected per element), 47M of them a launch, 40-50 us of
// issue; without it fc1 takes 62 us. Tried and slower: a producer warp
// (168 registers a thread, serialised wgmmas), each row's output by a bulk
// copy from a double-buffered staging tile, a third warpgroup (spills), a
// store warpgroup fed through named barriers (setmaxnreg left the math at
// 168 registers), 16-byte stores with 8-byte heads and tails.
//
// Every M >= 1 is taken; K a multiple of 4 up to 192 (12 k-steps) or up to
// 368 (23), N a multiple of 4; the instances below are the four products of
// a Swin layer at embed 180 and mlp ratio 2. x, the residual, the output and
// the packed weights are 16-byte aligned (the bulk copies need it).
//
// Interface: a plain C entry point (loaded with ctypes). It launches on the
// caller's stream, allocates nothing, uses no atomics (each output is
// written by one thread), and returns the CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;                      // rows of a tile: wgmma's M
constexpr int NC = 96;                      // columns of one product
constexpr int THREADS = 2 * 128;           // two warpgroups
constexpr int STAGE_PITCH = 2 * NC + 16;    // bytes of a staging row
constexpr int STAGE_TILE = BM * STAGE_PITCH;
constexpr int PIECES = NC / 4;              // 8-byte pieces of a staging row
constexpr int PASSES = BM * PIECES / 128;   // of a warpgroup over its staging tile
constexpr int BARS = 128;                   // bytes of mbarriers at the head
constexpr int MAX_SLOTS = 6;
constexpr int SMEM_MAX = 232448;            // what a block may opt in to

enum Epilogue { EPI_BIAS = 0, EPI_RESIDUAL = 1, EPI_GELU = 2 };

struct Args {
  const bf16* x;     // (M, K)
  const bf16* w;     // packed: (splits, KS, chunks * NC / 8, 2, 8, 8)
  const bf16* bias;  // (N,)
  const bf16* res;   // (M, N), EPI_RESIDUAL only
  bf16* out;         // (M, N)
  int M, N, K, splits, slots;
};

// ------------------------------------------------------------- primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
// a named barrier over n threads
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
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
// between core matrices along K) and SBO (along N), all in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
// d (+)= A (registers, the m64k16 fragment) x B (shared, K-major), bf16 -> f32;
// accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// F.gelu's default: x * 0.5 * (1 + erf(x / sqrt 2)), in ATen's order
__device__ __forceinline__ float gelu(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752440f));
}

// The shared-memory plan of one instance: mbarriers, the weight slice, its
// bias, two staging tiles, then the ring.
template <int KS, int CHUNKS>
struct Plan {
  static constexpr int NR = CHUNKS * NC;       // columns of a slice
  static constexpr int B_BYTES = NR * KS * 32;  // 16 k a step, 2 bytes each
  static constexpr int BIAS = BARS + B_BYTES;
  static constexpr int STAGING = BIAS + NR * 4;
  static constexpr int RING = STAGING + 2 * STAGE_TILE;
  static_assert(B_BYTES % 16 == 0 && RING % 16 == 0, "16-byte aligned regions");
};

// ------------------------------------------------------------------ kernel
// Tile j of the walk into ring slot j % slots: one bulk copy of its rows
// (16-byte multiples), and an odd row count's last 8 bytes by hand before
// the arrival that carries the copy's byte count.
__device__ __forceinline__ void load_tile(const Args& a, unsigned char* ring, uint32_t bars,
                                          int walk, int walks, int j) {
  const int t = walk + j * walks, s = j % a.slots;
  if (t >= (a.M + BM - 1) / BM) return;
  const int row_bytes = 2 * a.K, slot_bytes = BM * row_bytes;
  const int bytes = min(BM, a.M - t * BM) * row_bytes, bulk = bytes & ~15;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(a.x) + (size_t)t * slot_bytes;
  unsigned char* dst = ring + s * slot_bytes;
  if (bulk < bytes)
    *reinterpret_cast<uint2*>(dst + bulk) = *reinterpret_cast<const uint2*>(src + bulk);
  mbar_expect_tx(bars + 8 * s, bulk);
  bulk_copy(smem_u32(dst), src, bulk, bars + 8 * s);
}

// grid: splits x walkers (block i owns slice i % splits of walk i / splits);
// block: THREADS; Plan::RING + slots x 64 x 2K bytes of dynamic shared memory.
template <int KS, int CHUNKS, int EPI>
__global__ void __launch_bounds__(THREADS, 1) token_gemm_kernel(const Args a) {
  using P = Plan<KS, CHUNKS>;
  constexpr int NR = P::NR, NG = NR / 8;
  constexpr int SETS = CHUNKS > 1 ? 2 : 1;  // accumulator sets
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  unsigned char* ring = smem + P::RING;
  const int row_bytes = 2 * a.K, slot_bytes = BM * row_bytes;
  const int split = blockIdx.x % a.splits;
  const int walk = blockIdx.x / a.splits, walks = gridDim.x / a.splits;
  const int tiles = (a.M + BM - 1) / BM;
  const int tid = threadIdx.x;
  // full[s] at 8 s, the weight slice's at 64
  const uint32_t b_ready = base + 64;

  if (tid == 0) {
    for (int s = 0; s < a.slots; ++s) mbar_init(base + 8 * s, 1);
    mbar_init(b_ready, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // warpgroup wg takes the walk's tiles wg, wg + 2, ... and so the ring's
  // slots wg, wg + 2, ...: its thread 0 fills them, first here, then each
  // again as soon as the warpgroup holds the tile's fragments
  const int wg = tid / 128, t128 = tid % 128, warp = t128 / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  if (tid == 0) {
    mbar_expect_tx(b_ready, P::B_BYTES);
    bulk_copy(base + BARS, a.w + (size_t)split * (P::B_BYTES / 2), P::B_BYTES, b_ready);
  }
  if (t128 == 0)
    for (int j = wg; j < a.slots; j += 2) load_tile(a, ring, base, walk, walks, j);
  float* bias_s = reinterpret_cast<float*>(smem + P::BIAS);
  unsigned char* staging = smem + P::STAGING + wg * STAGE_TILE;
  for (int i = tid; i < NR; i += 256) {
    const int col = split * NR + i;
    bias_s[i] = col < a.N ? __bfloat162float(a.bias[col]) : 0.f;
  }
  bar_sync(1, 256);
  mbar_wait(b_ready, 0);
  const uint64_t b_desc = gmma_desc(base + BARS, 128, 256);

  for (int j = wg;; j += 2) {
    const int t = walk + j * walks;
    if (t >= tiles) break;
    const int s = j % a.slots;
    const int m0 = t * BM, rows = min(BM, a.M - m0);
    // the residual's pairs of every chunk, (group, row half), loaded first
    // so that they land while the tile's products run
    uint32_t rv[EPI == EPI_RESIDUAL ? CHUNKS : 1][NC / 4];
    if constexpr (EPI == EPI_RESIDUAL) {
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int nb = 0; nb < NC / 8; ++nb) {
          const int col = split * NR + c * NC + 8 * nb + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + warp * 16 + g + 8 * h;
            rv[c][2 * nb + h] = row < a.M && col < a.N
                                    ? __ldg(reinterpret_cast<const unsigned int*>(
                                          a.res + (size_t)row * a.N + col))
                                    : 0u;
          }
        }
    }
    mbar_wait(base + 8 * s, (j / a.slots) & 1);

    // A's fragments for the whole K: register r of step ks holds row
    // 16 warp + g + 8 (r & 1), k = 16 ks + 2 q + 8 (r >> 1) and k + 1
    uint32_t af[KS][4];
    const unsigned char* arow = ring + s * slot_bytes + (warp * 16 + g) * row_bytes;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = 16 * ks + 2 * q + 8 * (r >> 1);
        af[ks][r] = k < a.K ? *reinterpret_cast<const uint32_t*>(arow + (r & 1) * 8 * row_bytes +
                                                                   2 * k)
                            : 0u;
      }
    }
    bar_sync(2 + wg, 128);  // the whole warpgroup holds its fragments: the slot is free
    if (t128 == 0) load_tile(a, ring, base, walk, walks, j + a.slots);

    float acc[SETS][NC / 2];
    wgmma_fence();
    auto issue = [&](float (&d)[NC / 2], int c) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_n96(d, af[ks], b_desc + (uint64_t)(((ks * NG + c * (NC / 8)) * 256) >> 4), ks > 0);
      wgmma_commit();
    };

    issue(acc[0], 0);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      if (c + 1 < CHUNKS) {
        issue(acc[(c + 1) % SETS], c + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      float(&d)[NC / 2] = acc[c % SETS];
      fence_acc(d);
#pragma unroll
      for (int nb = 0; nb < NC / 8; ++nb) {
        const int cl = c * NC + 8 * nb + 2 * q;  // the slice's column
        const float2 b = *reinterpret_cast<const float2*>(bias_s + cl);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = d[4 * nb + 2 * h] + b.x, v1 = d[4 * nb + 2 * h + 1] + b.y;
          if constexpr (EPI == EPI_RESIDUAL) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&rv[c][2 * nb + h]));
            v0 += r.x;
            v1 += r.y;
          }
          if constexpr (EPI == EPI_GELU) {
            v0 = gelu(v0);
            v1 = gelu(v1);
          }
          *reinterpret_cast<__nv_bfloat162*>(staging + (warp * 16 + g + 8 * h) * STAGE_PITCH +
                                             2 * (8 * nb + 2 * q)) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      bar_sync(2 + wg, 128);
      // the staging tile out, 8 bytes a thread and pass: all its loads,
      // then the stores, the columns masked at N and the rows at M
      const int n0 = split * NR + c * NC, valid = min(NC, a.N - n0) / 4;
      uint2 v[PASSES];
#pragma unroll
      for (int u = 0; u < PASSES; ++u) {
        const int i = t128 + 128 * u, r = i / PIECES, p = i % PIECES;
        v[u] = *reinterpret_cast<const uint2*>(staging + r * STAGE_PITCH + 8 * p);
      }
#pragma unroll
      for (int u = 0; u < PASSES; ++u) {
        const int i = t128 + 128 * u, r = i / PIECES, p = i % PIECES;
        if (r < rows && p < valid)
          *reinterpret_cast<uint2*>(a.out + (size_t)(m0 + r) * a.N + n0 + 4 * p) = v[u];
      }
      bar_sync(2 + wg, 128);  // before the next chunk writes the staging tile
    }
  }
}

// Each instance opts in to SMEM_MAX bytes of shared memory once a device
// (an attribute of the function, which every later launch keeps), and the
// SM count is read once a device: neither is asked again on the 144
// launches of a frame. Two host threads racing on a first launch both
// write the same values.
constexpr int MAX_DEVICES = 64;

template <int KS, int CHUNKS, int EPI>
cudaError_t launch(Args a, int device, int sms, cudaStream_t stream) {
  using P = Plan<KS, CHUNKS>;
  const int slot_bytes = BM * 2 * a.K;
  a.slots = min(MAX_SLOTS, (SMEM_MAX - P::RING) / slot_bytes) & ~1;
  if (a.slots < 2) return cudaErrorInvalidConfiguration;
  const int smem = P::RING + a.slots * slot_bytes;
  auto kernel = token_gemm_kernel<KS, CHUNKS, EPI>;
  static bool opted_in[MAX_DEVICES];
  if (!opted_in[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  const int tiles = (a.M + BM - 1) / BM;
  const int walks = max(1, min(tiles, sms / a.splits));
  kernel<<<walks * a.splits, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of the tensors and the stream (made current if
// it is not). ksteps, chunks, splits: the wrapper's plan (k-steps of 16,
// 96-column products a slice, slices of N), which the packed weights
// follow. epilogue: 0 bias, 1 bias + residual, 2 bias then GELU. Returns
// the CUDA error, cudaErrorInvalidValue for a plan no instance takes.
int tpusr_token_gemm(int device, int ksteps, int chunks, int splits, int epilogue,
                     const void* x, const void* w, const void* bias, const void* res, void* out,
                     int M, int N, int K, void* stream) {
  if (device < 0 || device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int sms_of[MAX_DEVICES];
  if (sms_of[device] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sms = sms_of[device];
  const Args a = {static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                  static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
                  static_cast<bf16*>(out), M, N, K, splits, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ksteps == 12 && chunks == 3 && epilogue == EPI_BIAS)
    err = launch<12, 3, EPI_BIAS>(a, device, sms, s);  // qkv
  else if (ksteps == 12 && chunks == 2 && epilogue == EPI_RESIDUAL)
    err = launch<12, 2, EPI_RESIDUAL>(a, device, sms, s);  // proj
  else if (ksteps == 12 && chunks == 2 && epilogue == EPI_GELU)
    err = launch<12, 2, EPI_GELU>(a, device, sms, s);  // fc1
  else if (ksteps == 23 && chunks == 1 && epilogue == EPI_RESIDUAL)
    err = launch<23, 1, EPI_RESIDUAL>(a, device, sms, s);  // fc2
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
