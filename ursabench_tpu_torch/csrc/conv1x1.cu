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
// What bounds it: bytes. At the probe's shape (M = 401408 = 128*56*56, K =
// 256, N = 64: the 256->64 1x1 conv of ResNet-50's layer1 at batch 128)
// each op moves 205.5 + 51.4 = 256.9 MB (the big operand once, the other
// once, w and dw are tiny), 76.7 us at the H100's 3.35 TB/s, against 13.15
// GFLOP, 13.3 us at the 989 TFLOP/s bf16 peak. So the design aims at one
// pass over the big operand with enough bytes in flight, and the tensor
// cores only have to keep up:
//  - tiles stream through shared memory in a 3-stage cp.async ring (16-byte
//    copies, zero-filled past the edges), so two tiles are in flight while
//    the warps multiply the third;
//  - the products are wmma 16x16x16 bf16 fragments with float32
//    accumulators, 8 warps a block, each warp a 32x32 piece of the tile;
//  - K3a: a block owns 128 rows of x and 64 columns of w, and loops over K
//    in steps of 32. Unlike the TPU kernel it does not hold all of w: the
//    model's largest 1x1 weight (2048 x 512 bf16, 2 MB) is far beyond a
//    block's shared memory, so K and N are tiled too. Blocks are numbered
//    row tile by row tile, so the blocks that share a row tile of x run
//    together and read it from L2. The float32 tile goes through shared
//    memory and is rounded once with __float2bfloat16_rn, as
//    .to(torch.bfloat16) rounds;
//  - K3b: GPU blocks run in parallel and in no order, so the TPU's
//    sequential accumulation over the M grid has no counterpart. M is split
//    into `splits` chunks instead; block (tile, split) accumulates a 128 x 64
//    tile of x^T g over its chunk (x tile loaded as rows, read as a
//    column-major matrix_a) and stores the float32 partial; a second kernel
//    sums the partials of each element in split order and rounds once.
//    Every sum is taken in a fixed order, so two runs are bit-equal.
// Rows past M are masked (zero-filled on load, not written); K and N must be
// multiples of 16 (whole fragments) and the pointers 16-byte aligned (the
// wrapper kernels/conv1x1.py checks both).
//
// The kernels launch on the caller's stream, allocate nothing (the K3b
// partials are the wrapper's scratch) and do not synchronise.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps: a 4 x 2 grid of 32 x 32 warp tiles
constexpr int kStages = 3;     // cp.async ring depth

// K3a: block tile 128 (M) x 64 (N), K in steps of 32
constexpr int kMmBM = 128, kMmBN = 64, kMmBK = 32;
constexpr int kMmALd = kMmBK + 8;  // padded row lengths (elements): rows stay
constexpr int kMmBLd = kMmBN + 8;  // 32-byte aligned, banks spread
constexpr int kMmCLd = kMmBN + 4;
constexpr int kMmABytes = kStages * kMmBM * kMmALd * 2;
constexpr int kMmBBytes = kStages * kMmBK * kMmBLd * 2;
constexpr int kMmCBytes = kMmBM * kMmCLd * 4;
constexpr int kMmSmem = kMmABytes + kMmBBytes > kMmCBytes ? kMmABytes + kMmBBytes : kMmCBytes;

// K3b: block tile 128 (K) x 64 (N) of dw, M in steps of 32
constexpr int kWgBK = 128, kWgBN = 64, kWgBM = 32;
constexpr int kWgXLd = kWgBK + 8;
constexpr int kWgGLd = kWgBN + 8;
constexpr int kWgXBytes = kStages * kWgBM * kWgXLd * 2;
constexpr int kWgGBytes = kStages * kWgBM * kWgGLd * 2;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: no read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// ---------------------------------------------------------------- K3a

__global__ void __launch_bounds__(kThreads)
conv1x1_mm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  bf16* __restrict__ y, int m, int k, int n) {
  __shared__ __align__(128) unsigned char smem[kMmSmem];
  auto as = reinterpret_cast<bf16(*)[kMmBM][kMmALd]>(smem);
  auto bs = reinterpret_cast<bf16(*)[kMmBK][kMmBLd]>(smem + kMmABytes);
  auto cs = reinterpret_cast<float(*)[kMmCLd]>(smem);  // after the main loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n_tiles = (n + kMmBN - 1) / kMmBN;
  const int m0 = (blockIdx.x / n_tiles) * kMmBM;
  const int n0 = (blockIdx.x % n_tiles) * kMmBN;
  const int k_tiles = (k + kMmBK - 1) / kMmBK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kMmBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // x: 128 rows x 4 chunks of 8
      const int c = tid + i * kThreads, r = c >> 2, col = (c & 3) * 8;
      const bool ok = m0 + r < m && k0 + col < k;
      cp_async16(&as[stage][r][col], ok ? x + (size_t)(m0 + r) * k + k0 + col : x, ok);
    }
    {  // w: 32 rows x 8 chunks of 8
      const int r = tid >> 3, col = (tid & 7) * 8;
      const bool ok = k0 + r < k && n0 + col < n;
      cp_async16(&bs[stage][r][col], ok ? w + (size_t)(k0 + r) * n + n0 + col : w, ok);
    }
  };

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... for every thread; stage (kt-1) is free
    const int next = kt + kStages - 1;
    if (next < k_tiles) load(next % kStages, next);
    cp_async_commit();
    const int st = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < kMmBK; kk += 16) {
      FragA a[2];
      FragB b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &as[st][wm * 32 + i * 16][kk], kMmALd);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &bs[st][kk][wn * 32 + j * 16], kMmBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before cs overwrites it

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&cs[wm * 32 + i * 16][wn * 32 + j * 16], acc[i][j], kMmCLd,
                              wmma::mem_row_major);
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {  // 128 rows x 8 chunks of 8 outputs
    const int c = tid + i * kThreads, r = c >> 3, col = (c & 7) * 8;
    if (m0 + r >= m || n0 + col >= n) continue;
    __align__(16) bf16 out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16_rn(cs[r][col + e]);
    *reinterpret_cast<uint4*>(y + (size_t)(m0 + r) * n + n0 + col) =
        *reinterpret_cast<const uint4*>(out);
  }
}

// ---------------------------------------------------------------- K3b

// partial[split] (k, n) f32 = x[rows of split]^T @ g[rows of split]
__global__ void __launch_bounds__(kThreads)
conv1x1_wgrad_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                             float* __restrict__ partial, int m, int k, int n, int chunk) {
  __shared__ __align__(128) unsigned char smem[kWgXBytes + kWgGBytes];
  auto xs = reinterpret_cast<bf16(*)[kWgBM][kWgXLd]>(smem);
  auto gs = reinterpret_cast<bf16(*)[kWgBM][kWgGLd]>(smem + kWgXBytes);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wk = warp >> 1, wn = warp & 1;
  const int n_tiles = (n + kWgBN - 1) / kWgBN;
  const int k0 = (blockIdx.x / n_tiles) * kWgBK;
  const int n0 = (blockIdx.x % n_tiles) * kWgBN;
  const int split = blockIdx.y;
  const long long begin = (long long)split * chunk;
  const int m_begin = begin < m ? (int)begin : m;
  const int m_end = begin + chunk < m ? (int)(begin + chunk) : m;
  const int m_tiles = (m_end - m_begin + kWgBM - 1) / kWgBM;

  auto load = [&](int stage, int mt) {
    const int r0 = m_begin + mt * kWgBM;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // x: 32 rows x 16 chunks of 8
      const int c = tid + i * kThreads, r = c >> 4, col = (c & 15) * 8;
      const bool ok = r0 + r < m_end && k0 + col < k;
      cp_async16(&xs[stage][r][col], ok ? x + (size_t)(r0 + r) * k + k0 + col : x, ok);
    }
    {  // g: 32 rows x 8 chunks of 8
      const int r = tid >> 3, col = (tid & 7) * 8;
      const bool ok = r0 + r < m_end && n0 + col < n;
      cp_async16(&gs[stage][r][col], ok ? g + (size_t)(r0 + r) * n + n0 + col : g, ok);
    }
  };

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < m_tiles) load(s, s);
    cp_async_commit();
  }
  for (int mt = 0; mt < m_tiles; ++mt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = mt + kStages - 1;
    if (next < m_tiles) load(next % kStages, next);
    cp_async_commit();
    const int st = mt % kStages;
#pragma unroll
    for (int mm = 0; mm < kWgBM; mm += 16) {
      // x^T as a column-major matrix_a: element (k, m) sits at xs[m][k]
      FragAT a[2];
      FragB b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &xs[st][mm][wk * 32 + i * 16], kWgXLd);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &gs[st][mm][wn * 32 + j * 16], kWgGLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // K and N are multiples of 16: each 16 x 16 fragment is wholly inside or
  // wholly outside (k, n), and goes straight to device memory
  float* out = partial + (size_t)split * k * n;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = k0 + wk * 32 + i * 16, c = n0 + wn * 32 + j * 16;
      if (r < k && c < n)
        wmma::store_matrix_sync(out + (size_t)r * n + c, acc[i][j], n, wmma::mem_row_major);
    }
}

// dw[e] = bf16(sum over splits, in order, of partial[split][e])
__global__ void __launch_bounds__(kReduceThreads)
conv1x1_wgrad_reduce_kernel(const float* __restrict__ partial, bf16* __restrict__ dw,
                            int kn, int splits) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= kn) return;
  float total = 0.0f;
  for (int s = 0; s < splits; ++s) total = __fadd_rn(total, partial[(size_t)s * kn + e]);
  dw[e] = __float2bfloat16_rn(total);
}

}  // namespace

// op 0 (K3a): a = x (m, k), b = w (k, n), out = y (m, n); partial, splits unused.
// op 1 (K3b): a = x (m, k), b = g (m, n), out = dw (k, n); partial is float32
//   scratch of splits * k * n, M is cut into splits chunks of
//   ceil(ceil(m / splits) / 32) * 32 rows.
// All bf16 row-major, 16-byte aligned; k and n multiples of 16. Returns a
// cudaError_t (0 on success).
extern "C" int conv1x1(int op, const void* a, const void* b, void* out, void* partial,
                       int m, int k, int n, int splits, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 16 || n % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* ap = static_cast<const bf16*>(a);
  const bf16* bp = static_cast<const bf16*>(b);
  bf16* op_out = static_cast<bf16*>(out);
  if (op == 0) {
    const long long blocks =
        (long long)((m + kMmBM - 1) / kMmBM) * ((n + kMmBN - 1) / kMmBN);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    conv1x1_mm_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(ap, bp, op_out, m, k, n);
    return (int)cudaGetLastError();
  }
  if (op != 1 || splits <= 0 || splits > 65535 || partial == nullptr)
    return (int)cudaErrorInvalidValue;
  const int per = (m + splits - 1) / splits;
  const int chunk = (per + kWgBM - 1) / kWgBM * kWgBM;
  const unsigned tiles = (unsigned)(((k + kWgBK - 1) / kWgBK) * ((n + kWgBN - 1) / kWgBN));
  float* pp = static_cast<float*>(partial);
  conv1x1_wgrad_partial_kernel<<<dim3(tiles, (unsigned)splits), kThreads, 0, s>>>(
      ap, bp, pp, m, k, n, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int kn = k * n;
  conv1x1_wgrad_reduce_kernel<<<(kn + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
                                s>>>(pp, op_out, kn, splits);
  return (int)cudaGetLastError();
}
