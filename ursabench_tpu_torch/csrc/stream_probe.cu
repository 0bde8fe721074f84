// Stream probe: read every byte of an int8 matrix, tile by tile.
//
// Replaces the TPU probes
//   - benchmarks/pallas_matvec_probe.py::dma_only (_dma_kernel), output
//     (G, 1)   -> out_cols = 1;
//   - benchmarks/pallas_matvec_probe2.py::dma_only (_dma_kernel), output
//     (G, 128) -> out_cols = 128.
// W (N, K) int8 is cut into G = N / tile_n row tiles of tile_n * K bytes. For
// tile g the probes write out[g, 0] = sum(W[g*tile_n : g*tile_n + 32, :128])
// + i. On the TPU that corner sum forces the pipeline to copy the whole tile
// into VMEM, so the probe times the stream. On this card a kernel that only
// summed the corner would read 4 KB a tile and time nothing, so this kernel
// reads every byte of the tile: it sums all of them as int32 into a second
// output, tile_sum[g], which keeps no load dead, and writes the TPU's
// out[g, 0] beside it. |corner| < 2^24, so out[g, 0] is exact in float32.
// With out_cols = 128 the kernel writes zeros into columns 1..127; the TPU
// kernel leaves them unset (they read as whatever the buffer held).
//
// What bounds it: bytes, N * K of them, and nothing else: at 6144 x 6144 that
// is 37.7 MB, 11.3 us at the H100's 3.35 TB/s. The design:
//  - 16-byte loads, neighbouring threads on neighbouring addresses (a tile is
//    one contiguous run of tile_n * K bytes), summed with __dp4a against
//    0x01010101, four signed bytes per instruction;
//  - the TPU walks its G tiles one after another on one core; here G = 12 for
//    6144 x 6144 at tile_n = 512, and twelve blocks would leave 120 of the
//    132 SMs idle. So each tile is split over `splits` blocks (grid (G,
//    splits), chosen by the wrapper to put about two blocks on every SM);
//    each adds its partial sum into tile_sum[g] with an integer atomicAdd,
//    which is exact and does not depend on the order. The wrapper zeroes
//    tile_sum first. Block (g, 0) also reads the 32 x 128 corner (4 KB, one
//    16-byte load per thread) and writes row g of out.
//
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise, so it can be captured in a CUDA graph.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOnes = 0x01010101;

__device__ __forceinline__ int byte_sum16(const int4& v, int c) {
  c = __dp4a(v.x, kOnes, c);
  c = __dp4a(v.y, kOnes, c);
  c = __dp4a(v.z, kOnes, c);
  return __dp4a(v.w, kOnes, c);
}

// Sum of v over the block; the result is valid in thread 0.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // scratch may still be read by an earlier call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads / 32; ++i) total += scratch[i];
  return total;
}

__global__ void __launch_bounds__(kThreads)
stream_probe_kernel(const int8_t* __restrict__ w, int tile_n, int k, int i_value,
                    int out_cols, float* __restrict__ out, int* __restrict__ tile_sum) {
  __shared__ int scratch[kThreads / 32];
  const int g = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int8_t* tile = w + (size_t)g * tile_n * k;
  const long long chunks = (long long)tile_n * k / 16;
  const long long begin = chunks * split / splits;
  const long long end = chunks * (split + 1) / splits;
  const int4* p = reinterpret_cast<const int4*>(tile);

  int acc = 0;
#pragma unroll 4
  for (long long c = begin + threadIdx.x; c < end; c += kThreads)
    acc = byte_sum16(__ldg(p + c), acc);
  const int total = block_sum(acc, scratch);
  if (threadIdx.x == 0) atomicAdd(tile_sum + g, total);

  if (split != 0) return;
  // the corner: 32 rows of 128 bytes, 8 threads to a row
  const int r = threadIdx.x >> 3, c = (threadIdx.x & 7) * 16;
  const int corner = block_sum(
      byte_sum16(__ldg(reinterpret_cast<const int4*>(tile + (size_t)r * k + c)), 0),
      scratch);
  float* row = out + (size_t)g * out_cols;
  if (threadIdx.x == 0)
    row[0] = __fadd_rn(__int2float_rn(corner), __int2float_rn(i_value));
  for (int j = 1 + threadIdx.x; j < out_cols; j += kThreads) row[j] = 0.0f;
}

}  // namespace

// out (g, out_cols) float32 and tile_sum (g) int32 (zeroed by the caller) for
// w (g * tile_n, k) int8, 16-byte aligned. Needs tile_n >= 32, k >= 128,
// k % 16 == 0 and 1 <= splits (the wrapper checks).
extern "C" int stream_probe(const void* w, void* out, void* tile_sum, int groups,
                            int tile_n, int k, int i_value, int out_cols, int splits,
                            void* stream) {
  if (groups <= 0 || tile_n < 32 || k < 128 || k % 16 != 0 || splits < 1 || out_cols < 1)
    return (int)cudaErrorInvalidValue;
  stream_probe_kernel<<<dim3((unsigned)groups, (unsigned)splits), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), tile_n, k, i_value, out_cols,
      static_cast<float*>(out), static_cast<int*>(tile_sum));
  return (int)cudaGetLastError();
}
