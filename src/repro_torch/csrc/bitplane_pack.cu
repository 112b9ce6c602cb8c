// Hopper (sm_90a) kernel for TableNet input packing: quantize, extract
// bitplanes and pack chunk indices in one pass.
//
//   fixed : code = clip(rint(x * 2**frac), lo, hi), u its two's-complement
//           bits; out[b, j, c] = sum_i bit_j(u[b, c*m + i]) << i     (n = bits)
//   fp16  : h = fp16(max(x, 0)), e its 5 exponent bits, man its 10 stored
//           mantissa bits; field_j = (bit j of man) << 5 | e for j < 10,
//           field_10 = (e > 0) << 5 | e (the implicit bit);
//           out[b, j, c] = sum_i field_j(h[b, c*m + i]) << (6*i)      (n = 11)
//
// x (B, q) fp32, out (B, n, k) int32 with k = ceil(q / m).  Elements past
// q read as 0, which is what the reference wrapper's zero padding of q to
// k*m gives (code 0 and fp16 +0 both pack to 0), without a host-side copy.
// Subnormal halves keep e = 0 and their stored mantissa bits.
//
// Replaces the TPU kernel
//   src/repro/kernels/bitplane_pack/bitplane_pack.py:56 bitplane_pack_pallas
//     (_fixed_kernel :33, _float16_kernel :44, _pack :25) -> bitplane_pack_launch
//
// Rounding: rintf rounds half to even, as jnp.round and torch.round do, and
// x * 2**frac is exact wherever x / 2**-frac (the reference's form) is.
//
// Bound on an H100: bytes.  A call reads B*q*4 bytes and writes B*n*k*4;
// the work is a few integer operations per element and plane.  On the
// binary-matmul path of full-width granite_8b (decode: 4 rows x 4096, 8
// planes) that is 0.6 MB, well under a microsecond at 3.35 TB/s, so the
// launch itself is the cost.
//
// Design: one thread per output chunk (b, c), c fastest, so a warp reads
// consecutive inputs and writes 32 consecutive codes of each plane.  The
// thread quantizes each of its m elements once and ORs its bit (or field)
// into all n plane codes held in registers -- the plane loop is unrolled
// over a fixed maximum, so nothing goes to local memory -- then writes the
// n codes.  No shared memory, no reduction across threads.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 24;   // fixed point: at most 24 bits (FixedPointFormat)
constexpr int kF16Planes = 11;   // 10 stored mantissa bits + the implicit bit

template <bool kFloat16>
__global__ void __launch_bounds__(kThreads)
bitplane_pack_kernel(const float* __restrict__ x,   // (B, q)
                     int32_t* __restrict__ out,     // (B, n, k)
                     const long long chunks,        // B * k
                     const int q, const int k, const int m, const int n,
                     const float scale, const float lo, const float hi,
                     const unsigned wrap) {          // 2**bits for signed codes, else 0
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= chunks) return;
  const long long b = t / k;
  const int c = static_cast<int>(t - b * k);
  const float* __restrict__ xr = x + b * q;

  uint32_t code[kMaxPlanes];
#pragma unroll
  for (int j = 0; j < kMaxPlanes; ++j) code[j] = 0u;

  for (int i = 0; i < m; ++i) {
    const int e = c * m + i;
    const float v = e < q ? __ldg(xr + e) : 0.0f;
    if (kFloat16) {
      const uint32_t u = __half_as_ushort(__float2half_rn(fmaxf(v, 0.0f)));
      const uint32_t ex = (u >> 10) & 31u;
      const uint32_t man = u & 1023u;
      const int sh = 6 * i;
#pragma unroll
      for (int j = 0; j < 10; ++j) code[j] |= ((((man >> j) & 1u) << 5) | ex) << sh;
      code[10] |= ((ex > 0u ? 32u : 0u) | ex) << sh;
    } else {
      const float r = fminf(fmaxf(rintf(v * scale), lo), hi);
      const int ci = static_cast<int>(r);
      const uint32_t u = ci < 0 ? static_cast<uint32_t>(ci) + wrap : static_cast<uint32_t>(ci);
#pragma unroll
      for (int j = 0; j < kMaxPlanes; ++j) code[j] |= ((u >> j) & 1u) << i;
    }
  }

  int32_t* __restrict__ o = out + b * n * k + c;
#pragma unroll
  for (int j = 0; j < kMaxPlanes; ++j) {
    if (j < n) o[static_cast<long long>(j) * k] = static_cast<int32_t>(code[j]);
  }
}

}  // namespace

// kind: 0 fixed point (n = bits planes), 1 fp16 (n = 11).  x (B, q) fp32
// and out (B, n, ceil(q/m)) int32 on the device, both contiguous.  For
// fixed point, bits in [1, 24], m in [1, 24]; for fp16, m in [1, 4] (every
// packed code fits 24 bits, the LUT index limit).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int bitplane_pack_launch(const void* x, void* out, int kind, int B, int q, int m,
                                    int bits, int frac, int is_signed, void* stream) {
  if (B < 1 || q < 1 || m < 1 || (kind != 0 && kind != 1) ||
      (kind == 0 && (bits < 1 || bits > kMaxPlanes || m > 24 || frac < -126 || frac > 126)) ||
      (kind == 1 && m > 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k = (q + m - 1) / m;
  const int n = kind == 1 ? kF16Planes : bits;
  const long long chunks = static_cast<long long>(B) * k;
  const long long blocks = (chunks + kThreads - 1) / kThreads;
  if (blocks > INT_MAX || static_cast<long long>(B) * n * k > LLONG_MAX / 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 1) {
    bitplane_pack_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int32_t*>(out), chunks, q, k, m, n, 1.0f,
        0.0f, 0.0f, 0u);
  } else {
    const float lo = is_signed ? -static_cast<float>(1 << (bits - 1)) : 0.0f;
    const float hi = is_signed ? static_cast<float>((1 << (bits - 1)) - 1)
                               : static_cast<float>((1 << bits) - 1);
    const unsigned wrap = is_signed ? (1u << bits) : 0u;
    bitplane_pack_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int32_t*>(out), chunks, q, k, m, n,
        ldexpf(1.0f, frac), lo, hi, wrap);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bitplane_pack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
