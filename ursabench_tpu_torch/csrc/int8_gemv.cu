// Batch-1 int8 weight-streaming GEMV with int32 accumulation:
//
//   y[n] = float(acc[n]) * scale[n] * x_scale,   acc[n] = sum_k w[n,k] * xq[k]
//
// Replaces three TPU kernels that compute the same thing and differ only in
// the inner product:
//   - benchmarks/pallas_int8.py::int8_matvec (_matvec_kernel): the matrix
//     unit, x as a (K, 1) column                    -> variant kMma;
//   - benchmarks/pallas_matvec_probe.py::matvec_row: _row_kernel, the matrix
//     unit with x as a (1, K) row                   -> variant kMmaRow;
//     _vpu_kernel, int32 multiply + row reduce     -> variant kDp4a;
//   - benchmarks/pallas_matvec_probe2.py::vpu_matvec (_vpu_kernel), the
//     vector unit                                   -> variant kDp4a.
// x is quantized per tensor outside the kernel (xq int8, x_scale a device
// float32[1]), as it is outside the Pallas kernels.
//
// What bounds it: bytes. Every weight is used once, for 2 integer operations,
// so the kernel reads N*K + 4N + K bytes and writes 4N; at 6144 x 6144 that is
// 37.8 MB, 11.3 us at the H100's 3.35 TB/s, against 0.04 us of int8 tensor-core
// work. The design therefore aims at one clean pass over W:
//  - W is read once, with 16-byte loads: in a warp step, the four threads of
//    a quad read 64 consecutive bytes of one row (threads t = 0..3 of the quad
//    at byte offsets 16t), for two rows g and g + 8 of the block's 16 rows;
//  - xq (K bytes) is staged in shared memory once per block, and each thread
//    reads the 16 bytes of xq that match its 16 bytes of W;
//  - a block owns 16 rows and its 8 warps split K between them (warp w takes
//    the 64-byte k-steps w, w + 8, ...), so N = 6144 gives 384 blocks of 256
//    threads, enough loads in flight to cover the device memory's latency;
//  - the warps' partial sums meet in shared memory and one thread per row
//    writes the result.
// The inner products:
//  - kMma: mma.sync m16n8k32 s8 x s8 -> s32 with A = the 16 rows of W and B =
//    xq repeated in all 8 columns (column 0 is read, the others are ignored).
//    The k order inside a 64-byte step is permuted the same way for A and B,
//    so that each thread's 16 loaded bytes are exactly its A fragment's bytes
//    for two k32 steps; an integer sum does not depend on the order of its
//    terms.
//  - kMmaRow: the transposed product y^T = xq^T W^T: A = xq repeated in all
//    16 rows, B = 8 rows of W as its 8 columns; two mma per 8 rows.
//  - kDp4a: __dp4a on the CUDA cores, four byte products per instruction,
//    then a reduction over the quad with warp shuffles.
// Rows past N are masked: their loads are replaced by zeros and their
// results are not written.
//
// Exactness: the integer sum is exact whatever the order of the adds (the
// wrapper keeps |acc| < 2^31), and the epilogue rounds in the JAX order,
// f32(acc) * scale, then * x_scale, with __fmul_rn, which the compiler never
// contracts into an FMA. So every variant equals the plain PyTorch version
// (kernels/int8_gemv.py::int8_gemv_reference) bit for bit.
//
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise, so it can be captured in a CUDA graph.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;               // output rows per block (one m16 tile)
constexpr int kWarps = 8;               // warps per block, splitting K
constexpr int kThreads = kWarps * 32;
constexpr int kStep = 64;               // bytes of K per warp step: 4 x 16 B
constexpr int kStaticSmem = 48 * 1024;  // above this, opt in to more

enum Variant { kMma = 0, kMmaRow = 1, kDp4a = 2 };

__device__ __forceinline__ void mma_s8(int (&d)[4], int a0, int a1, int a2, int a3,
                                       int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int dp4a16(const int4& a, const int4& b, int c) {
  c = __dp4a(a.x, b.x, c);
  c = __dp4a(a.y, b.y, c);
  c = __dp4a(a.z, b.z, c);
  return __dp4a(a.w, b.w, c);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
int8_gemv_kernel(const int8_t* __restrict__ w, const int8_t* __restrict__ xq,
                 const float* __restrict__ scale, const float* __restrict__ x_scale,
                 float* __restrict__ y, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem);          // k bytes
  int* partial = reinterpret_cast<int*>(smem + k);      // [kWarps][kRows]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // quad (group) and thread in quad
  const int row0 = blockIdx.x * kRows;

  for (int o = tid * 16; o < k; o += kThreads * 16)
    *reinterpret_cast<int4*>(xs + o) = *reinterpret_cast<const int4*>(xq + o);
  __syncthreads();

  const int ra = row0 + g, rb = row0 + g + 8;
  const bool va = ra < n, vb = rb < n;
  const int8_t* wa_row = w + (size_t)(va ? ra : 0) * k + t * 16;
  const int8_t* wb_row = w + (size_t)(vb ? rb : 0) * k + t * 16;
  const int8_t* x_row = xs + t * 16;
  const int4 zero = make_int4(0, 0, 0, 0);

  int acc[4] = {0, 0, 0, 0};   // kMma: D; kMmaRow: D of rows 0..7; kDp4a: [0], [2]
  int acc2[4] = {0, 0, 0, 0};  // kMmaRow: D of rows 8..15
  const int steps = k / kStep;
#pragma unroll 4
  for (int s = warp; s < steps; s += kWarps) {
    const int off = s * kStep;
    const int4 wa = va ? __ldg(reinterpret_cast<const int4*>(wa_row + off)) : zero;
    const int4 wb = vb ? __ldg(reinterpret_cast<const int4*>(wb_row + off)) : zero;
    const int4 xv = *reinterpret_cast<const int4*>(x_row + off);
    if constexpr (V == kDp4a) {
      acc[0] = dp4a16(wa, xv, acc[0]);
      acc[2] = dp4a16(wb, xv, acc[2]);
    } else if constexpr (V == kMma) {
      // A fragment (row g: a0, a2; row g + 8: a1, a3), B column = xq
      mma_s8(acc, wa.x, wb.x, wa.y, wb.y, xv.x, xv.y);
      mma_s8(acc, wa.z, wb.z, wa.w, wb.w, xv.z, xv.w);
    } else {
      // A = xq in every row; B column g = W row g (acc) or g + 8 (acc2)
      mma_s8(acc, xv.x, xv.x, xv.y, xv.y, wa.x, wa.y);
      mma_s8(acc2, xv.x, xv.x, xv.y, xv.y, wb.x, wb.y);
      mma_s8(acc, xv.z, xv.z, xv.w, xv.w, wa.z, wa.w);
      mma_s8(acc2, xv.z, xv.z, xv.w, xv.w, wb.z, wb.w);
    }
  }

  int* mine = partial + warp * kRows;
  if constexpr (V == kDp4a) {
    for (int m = 1; m < 4; m <<= 1) {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], m);
      acc[2] += __shfl_xor_sync(0xffffffffu, acc[2], m);
    }
  }
  if constexpr (V == kMmaRow) {
    // D row g holds the 8 row results of its column pair 2t, 2t + 1
    if (g == 0) {
      mine[2 * t] = acc[0];
      mine[2 * t + 1] = acc[1];
      mine[8 + 2 * t] = acc2[0];
      mine[8 + 2 * t + 1] = acc2[1];
    }
  } else if (t == 0) {
    // kMma: every column of D is the same, column 0 is read
    mine[g] = acc[0];
    mine[g + 8] = acc[2];
  }
  __syncthreads();

  if (tid < kRows) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += partial[i * kRows + tid];
    const int r = row0 + tid;
    if (r < n) y[r] = __fmul_rn(__fmul_rn(__int2float_rn(total), scale[r]), x_scale[0]);
  }
}

template <int V>
cudaError_t launch(const int8_t* w, const int8_t* xq, const float* scale,
                   const float* x_scale, float* y, int n, int k, cudaStream_t stream) {
  const size_t smem = (size_t)k + sizeof(int) * kWarps * kRows;
  if (smem > kStaticSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_gemv_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((n + kRows - 1) / kRows);
  int8_gemv_kernel<V><<<blocks, kThreads, smem, stream>>>(w, xq, scale, x_scale, y, n, k);
  return cudaGetLastError();
}

}  // namespace

// y (n) float32 = int8 GEMV of w (n, k) int8 row-major with xq (k) int8,
// scale (n) float32, x_scale float32[1]. Needs k % 64 == 0 and w, xq 16-byte
// aligned (the wrapper checks). variant: 0 mma, 1 mma_row, 2 dp4a.
extern "C" int int8_gemv(const void* w, const void* xq, const void* scale,
                         const void* x_scale, void* y, int n, int k, int variant,
                         void* stream) {
  if (n <= 0 || k <= 0 || k % kStep != 0) return (int)cudaErrorInvalidValue;
  const int8_t* wp = static_cast<const int8_t*>(w);
  const int8_t* xp = static_cast<const int8_t*>(xq);
  const float* sp = static_cast<const float*>(scale);
  const float* xsp = static_cast<const float*>(x_scale);
  float* yp = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kMma: return (int)launch<kMma>(wp, xp, sp, xsp, yp, n, k, s);
    case kMmaRow: return (int)launch<kMmaRow>(wp, xp, sp, xsp, yp, n, k, s);
    case kDp4a: return (int)launch<kDp4a>(wp, xp, sp, xsp, yp, n, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
