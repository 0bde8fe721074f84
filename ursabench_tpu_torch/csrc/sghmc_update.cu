// Fused SGHMC / SGLD parameter update on flat float32 buffers, with the
// Langevin noise made inside the kernel.
//
// Replaces the TPU kernel benchmarks/pallas_sgmcmc.py::sghmc_update_flat
// (_sghmc_kernel, _normal_from_bits, _uniform_from_bits). Per element:
//
//   d  = g + wd_over_n * p
//   v  = momentum * (is_first ? d : v) - lr * d + noise_scale * N(0, 1)
//   p  = p + v
//
// What bounds it: bytes. Each element reads p, v, g and writes p, v: 20 bytes
// for some 40 integer and float operations (the update, a quarter of a Philox
// call, half a Box-Muller pair), about 2 per byte, where an H100 does some 20
// float32 operations per byte it reads. The design therefore makes one pass:
//  - p and v are updated in place, with no padding and no copies (the TPU
//    wrapper padded to (64, 128) tiles and sliced back);
//  - the normals never touch device memory: Philox4x32-10 is computed in
//    registers, keyed by a 64-bit per-step seed and counted by the element's
//    group of four, and Box-Muller turns its four uniforms into four normals;
//  - each thread handles four consecutive elements with 16-byte loads and
//    stores when all three buffers are 16-byte aligned, in a grid-stride loop.
// The random stream depends only on (seed, element index), not on the launch
// geometry, and distinct steps use distinct seeds, so no two steps or elements
// share a counter.
//
// The buffer may be a block of a larger one: `offset` is the global index of
// its first element (a rank of a device mesh holding chains c0.. of C launches
// on its own rows with offset c0 * P). Element i draws the normal of global
// element offset + i, component (offset + i) % 4 of group (offset + i) / 4,
// so a block gets exactly the noise that the whole buffer's launch gives it.
// Where offset % 4 != 0 a local group of four spans two global groups and
// costs two Philox calls; offset 0 draws as before, bit for bit. The loads
// stay aligned, since they are indexed by the local buffer.
//
// The scalars (lr, momentum, wd_over_n, noise_scale, is_first) are read from a
// device float32 table of R rows of 5, so changing a hyperparameter changes
// data, not code. The n elements are R rows of n / R (the (R, P) buffer of R
// chains or of R sweep configurations), and row r takes the table's row r;
// R = 1 is one set for the whole buffer. A group of four whose elements lie in
// two rows (P % 4 != 0) is updated element by element, each with its own
// row's scalars; the noise is on for a row whose noise_scale is not zero.
// The group's row costs one 64-bit division, and none when R = 1.
// The arithmetic uses the _rn intrinsics, which the compiler never contracts
// into fused multiply-adds, so the result rounds exactly like the plain
// PyTorch version (kernels/sghmc.py::sghmc_update_flat_reference).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  const uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  const uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

// 24 random bits -> [0, 1)
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float* z0, float* z1) {
  const float u1 = fmaxf(uniform01(a), 1e-12f);
  const float u2 = uniform01(b);
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincospif(2.0f * u2, &s, &c);
  *z0 = r * c;
  *z1 = r * s;
}

__device__ __forceinline__ float4 normals4(unsigned long long seed, unsigned long long group) {
  const uint4 bits = philox4x32_10(
      make_uint4((uint32_t)group, (uint32_t)(group >> 32), 0u, 0u),
      make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)));
  float4 z;
  box_muller(bits.x, bits.y, &z.x, &z.y);
  box_muller(bits.z, bits.w, &z.z, &z.w);
  return z;
}

// The normals of global elements g0 .. g0 + 3.
__device__ __forceinline__ float4 normals_at(unsigned long long seed, unsigned long long g0) {
  const float4 a = normals4(seed, g0 >> 2);
  switch (g0 & 3u) {
    case 0: return a;
    case 1: { const float4 b = normals4(seed, (g0 >> 2) + 1); return make_float4(a.y, a.z, a.w, b.x); }
    case 2: { const float4 b = normals4(seed, (g0 >> 2) + 1); return make_float4(a.z, a.w, b.x, b.y); }
    default: { const float4 b = normals4(seed, (g0 >> 2) + 1); return make_float4(a.w, b.x, b.y, b.z); }
  }
}

struct Scalars {
  float lr, momentum, wd_over_n, noise_scale;
  bool first;
};

__device__ __forceinline__ Scalars load_row(const float* __restrict__ table, long long row) {
  const float* t = table + row * 5;
  Scalars s;
  s.lr = t[0];
  s.momentum = t[1];
  s.wd_over_n = t[2];
  s.noise_scale = t[3];
  s.first = t[4] > 0.5f;
  return s;
}

__device__ __forceinline__ void update_one(float& p, float& v, float g, float z,
                                           const Scalars& s, bool noise) {
  const float d = __fadd_rn(g, __fmul_rn(s.wd_over_n, p));
  const float v_prev = s.first ? d : v;
  float v_new = __fsub_rn(__fmul_rn(s.momentum, v_prev), __fmul_rn(s.lr, d));
  if (noise) v_new = __fadd_rn(v_new, __fmul_rn(s.noise_scale, z));
  v = v_new;
  p = __fadd_rn(p, v_new);
}

__global__ void __launch_bounds__(kThreads)
sghmc_update_kernel(float* __restrict__ p, float* __restrict__ v,
                    const float* __restrict__ g, const float* __restrict__ scalars,
                    long long n, long long rows, unsigned long long seed,
                    unsigned long long offset, int vectorized) {
  const long long row_len = n / rows;
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long grp = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       grp < groups; grp += stride) {
    const long long base = grp * 4;
    long long row = rows == 1 ? 0 : base / row_len;
    long long row_end = (row + 1) * row_len;  // one past the row's last element
    Scalars s = load_row(scalars, row);
    const long long last = base + 4 < n ? base + 4 : n;
    if (last <= row_end) {  // the whole group lies in one row
      const bool noise = s.noise_scale != 0.0f;
      float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      if (noise) z = normals_at(seed, offset + (unsigned long long)base);
      if (vectorized && base + 4 <= n) {
        float4 pp = reinterpret_cast<const float4*>(p)[grp];
        float4 vv = reinterpret_cast<const float4*>(v)[grp];
        const float4 gg = reinterpret_cast<const float4*>(g)[grp];
        update_one(pp.x, vv.x, gg.x, z.x, s, noise);
        update_one(pp.y, vv.y, gg.y, z.y, s, noise);
        update_one(pp.z, vv.z, gg.z, z.z, s, noise);
        update_one(pp.w, vv.w, gg.w, z.w, s, noise);
        reinterpret_cast<float4*>(p)[grp] = pp;
        reinterpret_cast<float4*>(v)[grp] = vv;
      } else {
        const float zs[4] = {z.x, z.y, z.z, z.w};
        for (int j = 0; j < 4 && base + j < n; ++j) {
          float pj = p[base + j], vj = v[base + j];
          update_one(pj, vj, g[base + j], zs[j], s, noise);
          p[base + j] = pj;
          v[base + j] = vj;
        }
      }
    } else {  // the group straddles rows: element by element, each with its row
      const float4 z = normals_at(seed, offset + (unsigned long long)base);
      const float zs[4] = {z.x, z.y, z.z, z.w};
      for (int j = 0; j < 4 && base + j < n; ++j) {
        while (base + j >= row_end) {  // more than one step only when P < 4
          ++row;
          row_end += row_len;
          s = load_row(scalars, row);
        }
        float pj = p[base + j], vj = v[base + j];
        update_one(pj, vj, g[base + j], zs[j], s, s.noise_scale != 0.0f);
        p[base + j] = pj;
        v[base + j] = vj;
      }
    }
  }
}

}  // namespace

// Launch on `stream`; allocates nothing and does not synchronise. Returns the
// launch's cudaError_t (0 on success).
// `scalars` is a float32 table of `rows` rows of 5; `rows` must divide n.
// `offset` is the global index of element 0 (0 for a whole buffer).
extern "C" int sghmc_update_f32(void* p, void* v, const void* g, const void* scalars,
                                long long n, long long rows, unsigned long long seed,
                                unsigned long long offset, void* stream) {
  if (rows <= 0 || n % rows != 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  const int vectorized =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(v) |
        reinterpret_cast<uintptr_t>(g)) & 15u) == 0;
  // Enough blocks to cover every group of four, capped at 8 resident blocks
  // per SM (2048 threads); the grid-stride loop covers the rest. The SM
  // count is read once per device.
  static int sms_of[kMaxDevices] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int sms = device < kMaxDevices ? sms_of[device] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) sms_of[device] = sms;
  }
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  const long long max_blocks = (long long)sms * 8;
  if (blocks > max_blocks) blocks = max_blocks;
  sghmc_update_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<float*>(p), static_cast<float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(scalars), n, rows, seed, offset, vectorized);
  return (int)cudaGetLastError();
}
