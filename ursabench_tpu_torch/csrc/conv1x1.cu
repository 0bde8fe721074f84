// The two halves of a 1x1 convolution as bf16 tensor-core GEMMs with float32
// accumulation, on channels-last tensors flattened to rows (M = N*H*W):
//
//   op 0, conv1x1_mm (K3a):    y (M, N) = bf16( x (M, K) @ w (K, N) )
//   op 1, conv1x1_wgrad (K3b): dw (K, N) = bf16( x (M, K)^T @ g (M, N) )
//
// Replaces the two TPU kernels of benchmarks/rn50_conv1x1_pallas_probe.py:
//   - pallas_mm: the M axis gridded, all of w resident in VMEM, an f32 dot
//     rounded once to x.dtype;
//   - pallas_wgrad: the M axis gridded, x^T g accumulated over the
//     sequential grid in an f32 VMEM scratch, written once at the last step.
//
// What bounds it: at the probe's shape (M = 401408 = 128*56*56, K = 256,
// N = 64: the 256->64 1x1 conv of ResNet-50's layer1 at batch 128) bytes.
// Each op moves 205.5 + 51.4 = 256.9 MB (the big operand once, the other
// once; w and dw are 32 KB), 76.7 us at the H100's 3.35 TB/s, against 13.15
// GFLOP, 13.3 us at the 989 TFLOP/s bf16 peak. Five of ResNet-50's sixteen
// 1x1 shapes at batch 128 lie above the ridge (~295 FLOP/byte) and are bound
// by the tensor cores instead: (M, K, N) = (25088, 512, 1024) and (25088,
// 1024, 512), 26.3 GFLOP, 26.6 us against 23.3 us of bytes; (6272, 1024,
// 2048), 26.6 us against 12.8; (6272, 2048, 512) and (6272, 512, 2048), 13.3
// us against 10.2. So one design has to stream a big operand at the memory's
// rate and keep the tensor cores busy where the operands are wide.
//
// The design, against what held the first (wmma, cp.async) version back:
//  1. TMA copies into a deep ring. x, w, g and y are described by 2-D tensor
//     maps with 128-byte swizzle and boxes of 64 bf16 along the contiguous
//     axis, so every copy moves whole 128-byte lines (the first version read
//     x in 64-byte pieces, 16 bytes a thread, and spent issue slots on
//     addresses). One producer thread issues every copy; full/empty mbarrier
//     pairs guard 6 or 8 stages of 16-32 KB (3 of 48 KB for K3a's 256-column
//     tiles), ~200-230 KB of dynamic shared memory a CTA, so 128-192 KB are
//     in flight on each SM (first version:
//     ~50 KB for K3b). TMA zero-fills reads past the tensor's edge and clips
//     stores, so a ragged M and K or N below a tile need no masks on the
//     load path. The maps are encoded on the host at every call
//     (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//     the library does not link libcuda).
//  2. wgmma from shared memory. Two consumer warpgroups issue
//     wgmma.mma_async m64nNk16 (N = the tile's 64, 128 or, in K3a, 256
//     columns) on
//     descriptors of the swizzled tiles; w and g are MN-major B operands and,
//     in K3b, x^T is an MN-major A operand: transpose bits, no transpose in
//     memory. setmaxnreg moves registers from the producer warpgroup (40) to
//     the consumers (232). This replaces mma.sync 16x16x16 fragments loaded
//     from padded shared memory, which cannot reach the bf16 peak that the
//     five wide shapes need.
//  3. A persistent grid. One CTA per SM (at most the SM count). K3a's CTAs
//     walk the output tiles t = cta, cta + ctas, ... numbered row tile by row
//     tile, so the N tiles of one row tile of x run at once on neighbouring
//     CTAs and x comes from HBM once, from L2 after that (the first version
//     launched 3,136 short blocks at the probe's shape, each with its own
//     pipeline fill and epilogue). The epilogue rounds the float32
//     accumulators to bf16 (_rn, as .to(torch.bfloat16) rounds), writes them
//     into a swizzled staging tile and stores it with TMA, while the producer
//     already loads the next tile's stages. Where the grid has one N tile and
//     w's K steps fit the ring's w slots (the probe's 256 x 64 = 32 KB), w is
//     loaded once and stays, as the TPU kernel keeps it in VMEM.
//  4. K3b in one launch, deterministic. A CTA owns a dw tile (128 rows of K x
//     64 or 128 of N) and one contiguous range of M, and accumulates over it
//     in registers; the splits are as long as one unit per SM allows, since
//     every split adds a float32 partial of dw (256-row tiles, which read x
//     once at the probe's shape, measured slower: twice the partials, and
//     two m64 blocks a warpgroup). With one split a CTA rounds and stores dw
//     directly. With more it writes a float32 partial; the launch
//     is cooperative (every CTA resident), the CTAs meet at a grid barrier
//     whose counter wraps back to 0 by itself (two calls and a CUDA-graph
//     replay find it at 0), and then each CTA sums its own slice of dw's
//     elements over the splits in split order and rounds once. Every sum
//     has a fixed order, so two runs give the same bits. At the probe's shape
//     that is 66 splits of 6,144 rows, 4.3 MB of partials; the first version
//     summed 8.65 MB in a second launch.
// The host side (kernels/conv1x1.py) chooses the tiles, the grid and the
// splits and passes them in; K and N must be multiples of 16 and the
// pointers 16-byte aligned (the wrapper checks both; TMA needs row strides
// in multiples of 16 bytes).
//
// The kernels launch on the caller's stream, allocate nothing (the K3b
// partials and the barrier counter are the wrapper's) and do not synchronise.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBox = 64;                // bf16 along the contiguous axis of a box: one 128-byte line
constexpr int kLine = 128;              // bytes
constexpr int kBoxBytes = 64 * kLine;   // a box of 64 lines
constexpr int kConsumers = 2;           // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSmemLimit = 232448;      // dynamic shared memory a block may use on sm_90
constexpr int kStep = 64;               // K3b: rows of M per stage; a split is a multiple of it

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  // the 128-byte swizzle repeats every 1024 bytes; descriptors assume tiles start on it
  const uint32_t s = smem_u32(p);
  return p + ((1024 - (s & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint64_t* bar, void* dst, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
  // keeps the compiler from moving accumulator reads or writes across wgmma
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A shared-memory matrix descriptor for a 128-byte-swizzled tile: start
// address, leading byte offset (between 64-element atoms along M or N of an
// MN-major operand; unused for K-major), stride byte offset (between groups of
// 8 lines), layout 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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

// A consumer warp's release of a ring stage whose wgmma group has completed.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// D (64 x N, f32) (+)= A (64 x 16) . B (16 x N), both bf16 from shared
// memory; B MN-major (transposed), A K-major (TA = 0) or MN-major (TA = 1);
// acc = 0 overwrites D.
template <int TA>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc), "n"(TA));
}

template <int BN, int TA>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 64)
    wgmma_n64<TA>(d, da, db, acc);
  else if constexpr (BN == 128)
    wgmma_n128<TA>(d, da, db, acc);
  else
    wgmma_n256<TA>(d, da, db, acc);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator layout of wgmma m64nN: in warp w of the warpgroup, lane l
// holds rows 16w + l/4 and 16w + l/4 + 8, columns 8j + 2(l%4) + {0, 1}, in
// registers 4j + 2i + {0, 1} for row 16w + l/4 + 8i.

// ------------------------------------------------------------------ K3a

template <int BN, int STAGES>
struct MmShape {
  static constexpr int kBM = 64 * kConsumers;             // rows of y a tile
  static constexpr int kXBytes = kBM * kLine;             // x: kBM rows x 64 of K
  static constexpr int kWBytes = (BN / kBox) * kBoxBytes;  // w: 64 rows of K x BN
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kOutBytes = kConsumers * (BN / kBox) * kBoxBytes;  // y staging
  static constexpr int kSmem = 1024 + STAGES * kStageBytes + kOutBytes + (2 * STAGES + 1) * 8;
  static_assert(kSmem <= kSmemLimit, "K3a shared memory");
};

template <int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
    conv1x1_mm_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_y, int m, int k, int n) {
  using S = MmShape<BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  uint8_t* staging = ring + STAGES * S::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + S::kOutBytes);
  uint64_t* empty = full + STAGES;
  uint64_t* w_ready = empty + STAGES;

  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = (m + S::kBM - 1) / S::kBM * tiles_n;
  const int k_steps = (k + kBox - 1) / kBox;
  // w stays resident in stage ks's w slot when every tile has the same N
  // columns and the K steps fit the ring
  const bool resident = tiles_n == 1 && k_steps <= STAGES;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival a consumer warp
    }
    mbar_init(w_ready, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      if (resident) {
        mbar_expect_tx(w_ready, k_steps * S::kWBytes);
        for (int ks = 0; ks < k_steps; ++ks)
          for (int j = 0; j < BN / kBox; ++j)
            tma_load(&map_w, w_ready, ring + ks * S::kStageBytes + S::kXBytes + j * kBoxBytes,
                     j * kBox, ks * kBox);
      }
      const uint32_t stage_tx = resident ? S::kXBytes : S::kStageBytes;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * S::kBM, n0 = t % tiles_n * BN;
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = ring + stage * S::kStageBytes;
          mbar_expect_tx(&full[stage], stage_tx);
          tma_load(&map_x, &full[stage], st, ks * kBox, m0);
          if (!resident)
            for (int j = 0; j < BN / kBox; ++j)
              tma_load(&map_w, &full[stage], st + S::kXBytes + j * kBoxBytes, n0 + j * kBox,
                       ks * kBox);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // two consumer warpgroups, 64 rows of the tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    uint8_t* out = staging + wg * (BN / kBox) * kBoxBytes;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    if (resident) mbar_wait(w_ready, 0);
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * S::kBM, n0 = t % tiles_n * BN;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(&full[stage], phase);
        // x: K-major A, a k16 step is 32 bytes along the swizzled line; w:
        // MN-major B, a k16 step is 16 lines, its 64-column boxes 8 KB apart
        const uint32_t a = smem_u32(ring + stage * S::kStageBytes) + wg * 64 * kLine;
        const uint32_t b = smem_u32(ring + (resident ? ks : stage) * S::kStageBytes + S::kXBytes);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kBox / 16; ++s)
          wgmma<BN, 0>(acc, sw128_desc(a + 32 * s, 16, 1024),
                       sw128_desc(b + 16 * kLine * s, kBoxBytes, 1024), ks > 0 || s > 0);
        wgmma_commit();
        // one group stays in flight: the one before it is done with its stage
        wgmma_wait<1>();
        if (ks > 0) release(&empty[prev], lane);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(&empty[prev], lane);
      // epilogue: bf16 into the swizzled staging tile, then one TMA store
      // per 64 columns; the staging tile is free once the last store read it
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint8_t* box = out + (j / 8) * kBoxBytes;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = warp * 16 + lane / 4 + 8 * i;
          *reinterpret_cast<uint32_t*>(box + r * kLine + (((j % 8) ^ (r & 7)) << 4) +
                                       (lane % 4) * 4) =
              pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + wg, 128);
      if (tid == 0) {
        for (int j = 0; j < BN / kBox; ++j)
          tma_store(&map_y, out + j * kBoxBytes, n0 + j * kBox, m0 + wg * 64);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ------------------------------------------------------------------ K3b

template <int BN, int STAGES>
struct WgShape {
  static constexpr int kBK = 64 * kConsumers;  // rows of dw a tile: 64 a consumer warpgroup
  static constexpr int kXBoxes = kBK / kBox, kGBoxes = BN / kBox;
  static constexpr int kStageBytes = (kXBoxes + kGBoxes) * kBoxBytes;  // kStep rows of x and g
  static constexpr int kSmem = 1024 + STAGES * kStageBytes + 2 * STAGES * 8;
  static_assert(kSmem <= kSmemLimit, "K3b shared memory");
};

// All CTAs of a cooperative launch meet here (one thread each). The counter
// counts arrivals and wraps to 0 at the last, which releases the others and
// leaves it ready for the next launch.
__device__ __forceinline__ void grid_barrier(unsigned* arrivals) {
  __threadfence();
  if (atomicInc(arrivals, gridDim.x - 1) != gridDim.x - 1) {
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(arrivals) : "memory");
    } while (v != 0);
  }
  __threadfence();
}

template <int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
    conv1x1_wgrad_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_g, float* __restrict__ partial,
                         bf16* __restrict__ dw, unsigned* arrivals, int m, int k, int n,
                         int splits, int chunk) {
  using S = WgShape<BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * S::kStageBytes);
  uint64_t* empty = full + STAGES;

  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = (k + S::kBK - 1) / S::kBK * tiles_n;
  const int units = tiles * splits;  // unit u: split u / tiles, tile u % tiles
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int split = u / tiles, tile = u % tiles;
        const int k0 = tile / tiles_n * S::kBK, n0 = tile % tiles_n * BN;
        const int r_end = min(static_cast<long long>(m), (split + 1LL) * chunk);
        for (int r = split * chunk; r < r_end; r += kStep) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = ring + stage * S::kStageBytes;
          mbar_expect_tx(&full[stage], S::kStageBytes);
          for (int b = 0; b < S::kXBoxes; ++b)
            tma_load(&map_x, &full[stage], st + b * kBoxBytes, k0 + b * kBox, r);
          for (int j = 0; j < S::kGBoxes; ++j)
            tma_load(&map_g, &full[stage], st + (S::kXBoxes + j) * kBoxBytes, n0 + j * kBox, r);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int split = u / tiles, tile = u % tiles;
    const int k0 = tile / tiles_n * S::kBK, n0 = tile % tiles_n * BN;
    const int r_end = min(static_cast<long long>(m), (split + 1LL) * chunk);
    for (int r = split * chunk; r < r_end; r += kStep) {
      mbar_wait(&full[stage], phase);
      // x^T and g: MN-major operands, a k16 step is 16 lines of both; the
      // warpgroup's 64 rows of dw are x's box wg
      const uint32_t base = smem_u32(ring + stage * S::kStageBytes);
      const uint32_t g = base + S::kXBoxes * kBoxBytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kStep / 16; ++s)
        wgmma<BN, 1>(acc, sw128_desc(base + wg * kBoxBytes + 16 * kLine * s, kBoxBytes, 1024),
                     sw128_desc(g + 16 * kLine * s, kBoxBytes, 1024), r > split * chunk || s > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (r > split * chunk) release(&empty[prev], lane);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(&empty[prev], lane);
    // K and N are multiples of 16: a column pair is wholly inside or outside
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = k0 + wg * 64 + warp * 16 + lane / 4 + 8 * i;
      if (row >= k) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col >= n) continue;
        const float lo = acc[4 * j + 2 * i], hi = acc[4 * j + 2 * i + 1];
        if (splits == 1)
          *reinterpret_cast<uint32_t*>(dw + static_cast<size_t>(row) * n + col) = pack_bf16(lo, hi);
        else
          *reinterpret_cast<float2*>(partial + (static_cast<size_t>(split) * k + row) * n + col) =
              make_float2(lo, hi);
      }
    }
  }
  if (splits == 1) return;

  // every partial is written: meet the other CTAs, then sum this CTA's
  // slice of dw over the splits, in split order, and round once
  __threadfence();
  named_sync(1, 128 * kConsumers);
  if (threadIdx.x == 0) grid_barrier(arrivals);
  named_sync(1, 128 * kConsumers);
  const long long groups = static_cast<long long>(k) * n / 4;  // float4s of dw
  const long long per = (groups + gridDim.x - 1) / gridDim.x;
  const long long end = min(groups, (blockIdx.x + 1) * per);
  const float4* p4 = reinterpret_cast<const float4*>(partial);
  for (long long q = blockIdx.x * per + threadIdx.x; q < end; q += 128 * kConsumers) {
    // the loads do not wait on the sums: 32 of them are in flight at a time
    float4 t = __ldcg(p4 + q);
#pragma unroll 32
    for (int s = 1; s < splits; ++s) {
      const float4 v = __ldcg(p4 + s * groups + q);
      t.x = __fadd_rn(t.x, v.x);
      t.y = __fadd_rn(t.y, v.y);
      t.z = __fadd_rn(t.z, v.z);
      t.w = __fadd_rn(t.w, v.w);
    }
    *reinterpret_cast<uint2*>(dw + 4 * q) = make_uint2(pack_bf16(t.x, t.y), pack_bf16(t.z, t.w));
  }
}

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major bf16 (rows, cols) tensor as boxes of box_rows x 64 with the
// 128-byte swizzle; reads past the edges give zeros, stores past them are
// dropped.
bool encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows, bool load) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBox), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            load ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B : CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Each kernel variant asks for its dynamic shared memory once on each device
// (bit d of `ready`): the attribute costs host time at every call otherwise.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), std::atomic<unsigned long long>& ready, int smem, int ctas,
           bool cooperative, cudaStream_t s, Args... args) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready.fetch_or(bit);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = cooperative ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int BN, int STAGES>
int launch_mm(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& my, int m, int k,
              int n, int ctas, cudaStream_t s) {
  static std::atomic<unsigned long long> ready{0};
  return launch(conv1x1_mm_kernel<BN, STAGES>, ready, MmShape<BN, STAGES>::kSmem, ctas, false, s,
                mx, mw, my, m, k, n);
}

template <int BN, int STAGES>
int launch_wgrad(const CUtensorMap& mx, const CUtensorMap& mg, void* partial, void* out,
                 void* arrivals, int m, int k, int n, int ctas, int splits, int chunk,
                 cudaStream_t s) {
  static std::atomic<unsigned long long> ready{0};
  return launch(conv1x1_wgrad_kernel<BN, STAGES>, ready, WgShape<BN, STAGES>::kSmem, ctas,
                splits > 1, s, mx, mg, static_cast<float*>(partial), static_cast<bf16*>(out),
                static_cast<unsigned*>(arrivals), m, k, n, splits, chunk);
}

}  // namespace

// op 0 (K3a): a = x (m, k), b = w (k, n), out = y (m, n); tile = (128, 64,
//   128 or 256) of y; partial, arrivals, splits and chunk unused.
// op 1 (K3b): a = x (m, k), b = g (m, n), out = dw (k, n); tile = (128, 64
//   or 128) of dw; M cut into `splits` ranges of `chunk` rows (a
//   multiple of 64; the last range ends at m, none is empty). With more than
//   one split, partial is float32 scratch of splits * k * n, arrivals a
//   zeroed unsigned counter kept between calls, and the launch cooperative.
// ctas: the persistent grid, at most one CTA per SM. All bf16 row-major,
// 16-byte aligned; k and n multiples of 16. Returns a cudaError_t (0 on
// success).
extern "C" int conv1x1(int op, const void* a, const void* b, void* out, void* partial,
                       void* arrivals, int m, int k, int n, int tile_rows, int tile_cols,
                       int ctas, int splits, int chunk, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || k <= 0 || n <= 0 || k % 16 || n % 16 || ctas <= 0) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap mx, mb, my;
  if (op == 0) {
    if (tile_rows != MmShape<64, 8>::kBM || !encode(&mx, a, m, k, tile_rows, true) ||
        !encode(&mb, b, k, n, kBox, true) || !encode(&my, out, m, n, 64, false))
      return bad;
    if (tile_cols == 64) return launch_mm<64, 8>(mx, mb, my, m, k, n, ctas, s);
    if (tile_cols == 128) return launch_mm<128, 6>(mx, mb, my, m, k, n, ctas, s);
    if (tile_cols == 256) return launch_mm<256, 3>(mx, mb, my, m, k, n, ctas, s);
    return bad;
  }
  if (op != 1 || splits <= 0 || chunk <= 0 || chunk % kStep ||
      static_cast<long long>(splits - 1) * chunk >= m || static_cast<long long>(splits) * chunk < m)
    return bad;
  if (splits > 1 && (partial == nullptr || arrivals == nullptr)) return bad;
  if (!encode(&mx, a, m, k, kStep, true) || !encode(&mb, b, m, n, kStep, true)) return bad;
  if (tile_rows != WgShape<64, 8>::kBK) return bad;
  if (tile_cols == 64)
    return launch_wgrad<64, 8>(mx, mb, partial, out, arrivals, m, k, n, ctas, splits, chunk, s);
  if (tile_cols == 128)
    return launch_wgrad<128, 6>(mx, mb, partial, out, arrivals, m, k, n, ctas, splits, chunk, s);
  return bad;
}
