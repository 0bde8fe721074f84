// The eval-mode epilogue of a 16-bit WideResNet block, fused: two kernels
// over channels-last (NHWC) bf16 activations, seen as [rows, C] with
// rows = N * H * W.
//
// Replaces no TPU kernel: XLA fuses this chain on the TPU by itself. It was
// added because PyTorch runs it as separate kernels, each a pass over the
// activations: the eval BatchNorm casts its bf16 input to float32, normalizes
// float32 into float32 and casts back, ReLU is one more pass, and each conv's
// bias add and the residual add are one each: some 62 bytes an element of a
// block, where the work needs 14.
//
//   fused_batchnorm_eval_relu_kernel:
//     a = relu(bf16(w * (t - mean) * rsqrt(var + eps) + b))   (float32 inside)
//     t = the input x, or bf16(y + bf16(conv_bias)) where the previous conv's
//     bias is folded in (kConvBias)
//   bias_residual_add_elementwise_kernel:
//     out = bf16(bf16(y + bf16(bias)) + r)
//     r = the block input x, or bf16(s + bf16(s_bias)) for a shortcut conv's
//     raw output s (kShortcutBias)
//
// The roundings to bf16 fall where the unfused chain has them, and the
// normalization is aten's eval kernel's, w * (t - mean) * invstd + b with
// invstd = rsqrt(var + eps) and one fused multiply-add, written with the _rn
// intrinsics so the compiler contracts nothing else: bit for bit aten's.
// cuDNN's NHWC kernel, which the unfused chain runs on the card, rounds its
// float32 another way, and some 2e-5 of the bf16 results differ from it, by
// one ulp, or by a few where the normalization cancels to near 0.
//
// What bounds it: bytes (a handful of float operations an element). The
// design therefore reads each input once and writes the output once:
//  - each thread moves 8 channels (16 bytes) at a time, and its block's
//    threads cover whole rows in order, so a block reads contiguous memory;
//  - the launch gives the block a multiple of C / 8 threads and the grid
//    strides by whole rows, so a thread keeps the same 8 channels for every
//    row it visits and holds their parameters in registers, computed once;
//  - each thread has kUnroll rows in flight before it computes.
// Both launch on the caller's stream, allocate nothing and never synchronise,
// so a CUDA graph can capture them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;  // bf16 values in 16 bytes
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 8;  // the grid's cap: a thread then visits many rows
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack(uint4 u, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return u;
}

// The rows and the 8-channel group of this thread: a block holds
// blockDim.x / groups whole rows, and the grid strides by whole rows.
struct Rows {
  int group;
  long long first, stride;
  __device__ Rows(int groups) {
    const int per_block = blockDim.x / groups;
    group = threadIdx.x % groups;
    first = (long long)blockIdx.x * per_block + threadIdx.x / groups;
    stride = (long long)gridDim.x * per_block;
  }
};

template <bool kConvBias>
__global__ void __launch_bounds__(kThreads) fused_batchnorm_eval_relu_kernel(
    const uint4* __restrict__ t, const float* __restrict__ conv_bias,
    const float* __restrict__ weight, const float* __restrict__ bias,
    const float* __restrict__ mean, const float* __restrict__ var, float eps,
    uint4* __restrict__ out, long long rows, int groups) {
  const Rows r(groups);
  float w[kVec], m[kVec], inv[kVec], b[kVec], cb[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = r.group * kVec + j;
    w[j] = weight[c];
    m[j] = mean[c];
    inv[j] = rsqrtf(__fadd_rn(var[c], eps));
    b[j] = bias[c];
    cb[j] = kConvBias ? round_bf16(conv_bias[c]) : 0.0f;
  }
  for (long long row = r.first; row < rows; row += kUnroll * r.stride) {
    uint4 in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = row + u * r.stride;
      if (i < rows) in[u] = t[i * groups + r.group];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = row + u * r.stride;
      if (i >= rows) break;
      float f[kVec];
      unpack(in[u], f);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float x = kConvBias ? round_bf16(__fadd_rn(f[j], cb[j])) : f[j];
        const float y = __fmaf_rn(__fmul_rn(w[j], __fsub_rn(x, m[j])), inv[j], b[j]);
        f[j] = y < 0.0f ? 0.0f : y;  // NaN passes, as torch's relu
      }
      out[i * groups + r.group] = pack(f);
    }
  }
}

template <bool kShortcutBias>
__global__ void __launch_bounds__(kThreads) bias_residual_add_elementwise_kernel(
    const uint4* __restrict__ y, const float* __restrict__ bias, const uint4* __restrict__ res,
    const float* __restrict__ res_bias, uint4* __restrict__ out, long long rows, int groups) {
  const Rows r(groups);
  float b[kVec], rb[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = r.group * kVec + j;
    b[j] = round_bf16(bias[c]);
    rb[j] = kShortcutBias ? round_bf16(res_bias[c]) : 0.0f;
  }
  for (long long row = r.first; row < rows; row += kUnroll * r.stride) {
    uint4 in_y[kUnroll], in_r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = row + u * r.stride;
      if (i < rows) {
        in_y[u] = y[i * groups + r.group];
        in_r[u] = res[i * groups + r.group];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = row + u * r.stride;
      if (i >= rows) break;
      float fy[kVec], fr[kVec];
      unpack(in_y[u], fy);
      unpack(in_r[u], fr);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float a = round_bf16(__fadd_rn(fy[j], b[j]));
        const float s = kShortcutBias ? round_bf16(__fadd_rn(fr[j], rb[j])) : fr[j];
        fy[j] = __fadd_rn(a, s);
      }
      out[i * groups + r.group] = pack(fy);
    }
  }
}

// threads a block: a whole number of rows of `groups` threads
int block_threads(int groups) { return groups * (kThreads / groups); }

// blocks enough for kUnroll rows a thread, at most kBlocksPerSm a multiprocessor
cudaError_t grid_blocks(long long rows, int groups, unsigned* blocks) {
  static int sms_of[kMaxDevices] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int sms = device < kMaxDevices ? sms_of[device] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) sms_of[device] = sms;
  }
  const long long per_block = block_threads(groups) / groups * (long long)kUnroll;
  const long long wanted = (rows + per_block - 1) / per_block;
  const long long cap = (long long)sms * kBlocksPerSm;
  *blocks = (unsigned)(wanted < 1 ? 1 : (wanted > cap ? cap : wanted));
  return cudaSuccess;
}

}  // namespace

// groups = C / 8, at most kThreads (256); pointers 16-byte aligned, conv_bias may be null.
// Returns the launch's CUDA error (0 on success).
extern "C" int fused_batchnorm_eval_relu_bf16(const void* t, const float* conv_bias,
                                              const float* weight, const float* bias,
                                              const float* mean, const float* var, float eps,
                                              void* out, long long rows, int groups,
                                              void* stream) {
  unsigned blocks = 0;
  const cudaError_t err = grid_blocks(rows, groups, &blocks);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks), block(block_threads(groups));
  const cudaStream_t s = (cudaStream_t)stream;
  const uint4* in = (const uint4*)t;
  uint4* o = (uint4*)out;
  if (conv_bias != nullptr)
    fused_batchnorm_eval_relu_kernel<true><<<grid, block, 0, s>>>(
        in, conv_bias, weight, bias, mean, var, eps, o, rows, groups);
  else
    fused_batchnorm_eval_relu_kernel<false><<<grid, block, 0, s>>>(
        in, conv_bias, weight, bias, mean, var, eps, o, rows, groups);
  return (int)cudaGetLastError();
}

// res_bias may be null.
extern "C" int bias_residual_add_bf16(const void* y, const float* bias, const void* res,
                                      const float* res_bias, void* out, long long rows,
                                      int groups, void* stream) {
  unsigned blocks = 0;
  const cudaError_t err = grid_blocks(rows, groups, &blocks);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks), block(block_threads(groups));
  const cudaStream_t s = (cudaStream_t)stream;
  const uint4 *yy = (const uint4*)y, *rr = (const uint4*)res;
  uint4* o = (uint4*)out;
  if (res_bias != nullptr)
    bias_residual_add_elementwise_kernel<true><<<grid, block, 0, s>>>(yy, bias, rr, res_bias, o,
                                                                      rows, groups);
  else
    bias_residual_add_elementwise_kernel<false><<<grid, block, 0, s>>>(yy, bias, rr, res_bias, o,
                                                                       rows, groups);
  return (int)cudaGetLastError();
}
