// Hopper (sm_90a) kernel for TableNet input packing: quantize each input
// element and emit its LUT index codes, one int32 per plane and chunk, in
// one pass.  Three kinds, one per plan the kernel implements:
//
//   fixed : c = clip(rint(x * 2**frac), lo, hi), u its two's-complement
//           bits; out[b, j, c] = sum_i bit_j(u[b, c*m + i]) << i     (n = bits)
//   fp16  : h = fp16(max(x, 0)), e its 5 exponent bits, man its 11-bit
//           mantissa (10 stored bits, the implicit bit at 10 iff e > 0);
//           field_j = bit_j(man) << 5 | e;
//           out[b, j, c] = sum_i field_j(h[b, c*m + i]) << (6*i)      (n = 11)
//   shift : the bitplane_shift codes of a Float16Format(signed, radix = r)
//           plan at chunk 1; h = fp16(x) if signed, else fp16(max(x, 0))
//           with -0 taken to +0, u its 16 bits, e and man as above,
//           ib = r + signed (the index width);
//           out[b, j, c] = ((man >> r*j) & (2**r - 1))
//                          | (signed ? (u >> 15) << r : 0) | (e << ib)
//                                                       (n = ceil(11 / r))
//
// x (B, q) fp32 or bf16, out (B, n, k) int32 with k = ceil(q / m), both
// contiguous.  Elements past q read as 0, which is what the plain
// version's zero padding of q to k*m packs (code 0 and fp16 +0 both pack
// to 0), without a host-side copy.  Subnormal halves keep e = 0 and their
// stored mantissa bits.
//
// Replaces the TPU kernel
//   src/repro/kernels/bitplane_pack/bitplane_pack.py:56 bitplane_pack_pallas
//     (_fixed_kernel :33, _float16_kernel :44, _pack :25) -> bitplane_pack_launch
// and gives the shift kind, which the TPU kernel does not emit, the contract
// of core/lut.py::pack_codes' bitplane_shift branch.
//
// Rounding.  rintf rounds half to even, as torch.round does, and x * 2**frac
// is exact wherever x / 2**-frac (the plain version's form) is.  A bf16
// input is widened to fp32 exactly; for the fixed kind the launch then
// rounds the clip bounds to bf16, as torch.clamp of a bf16 tensor rounds its
// bounds (this changes a bound only at bits > 8).  __float2half_rn rounds
// to nearest even, overflows to +-inf and keeps +-inf, as torch's
// .to(float16) does.  NaN is outside the bit-for-bit contract: torch's CPU
// and CUDA conversions give it different bits (and fmaxf takes an unsigned
// NaN to 0).
//
// Bound on an H100: bytes.  A call reads B*q*itemsize bytes and writes
// B*n*k*4, with a few integer operations per element and plane.  At decode
// the bytes take well under a microsecond (4 rows x 4096 fp32, 3 planes:
// 0.26 MB, 0.08 us at 3.35 TB/s), so a call costs what a launch costs.
// Measured back to back on NVIDIA H100 80GB HBM3 cards at 700 W
// (chip_smoke.py, pack_kernel phase): every decode call of the served
// shapes took 2.48-2.75 us on one card and 3.07-3.37 us on another,
// 1.09-1.33x a one-row, 4-element pack of the same kind on the same card
// (2.26-2.38 and 2.42-2.58 us: the launch floor).  At prefill the stores
// are the cost: 128 rows x 14336, 8 planes (66 MB moved) took 25.3-25.8 us
// against a 19.7 us bound, 3 planes 8.8-9.0 us against 8.8 us.
//
// Design.  pack_kernel<Kind, InT, kVec>: a 2-D grid, blockIdx.y the row
// (rows past 65535 loop by gridDim.y), blockIdx.x a tile of 128 threads; no
// integer division anywhere.
//   kVec (chunk 1, q % 4 == 0, 16-byte-aligned fp32 / 8-byte-aligned bf16
//   input): a thread owns 4 consecutive elements -- one 16-byte (fp32) or
//   8-byte (bf16) ld.global.nc load, then one 16-byte store per plane, so a
//   warp writes 512 contiguous bytes of each plane.
//   scalar: one thread per output chunk (any m; at chunk 1 where q or the
//   base rules kVec out), its n codes in registers.
// The plane loop is unrolled to the kind's maximum (24 fixed, 11 the
// others) with a guard on n, so the codes stay in registers.  No shared
// memory, no reduction across threads.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kFixedPlanes = 24;  // fixed point: at most 24 bits (FixedPointFormat)
constexpr int kHalfPlanes = 11;   // 10 stored mantissa bits + the implicit bit
constexpr int kMaxGridY = 65535;

enum Kind : int { kFixed = 0, kFloat16 = 1, kShift = 2 };
enum InType : int { kF32 = 0, kBF16 = 1 };

struct Params {
  int B, q, k, m, n;
  float scale, lo, hi;  // fixed: x * scale, clipped to [lo, hi]
  uint32_t wrap;        // fixed: 2**bits for signed codes, else 0
  int radix, index_bits, is_signed;  // shift
};

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  const uint32_t b = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(b << 16);
}
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(t.x << 16); v[1] = __uint_as_float(t.x & 0xFFFF0000u);
  v[2] = __uint_as_float(t.y << 16); v[3] = __uint_as_float(t.y & 0xFFFF0000u);
}

// An element's word: its fixed-point code's two's-complement bits, or its
// half's 16 bits.
template <int K>
__device__ __forceinline__ uint32_t word(float v, const Params& p) {
  if (K == kFixed) {
    const int c = static_cast<int>(fminf(fmaxf(rintf(v * p.scale), p.lo), p.hi));
    return c < 0 ? static_cast<uint32_t>(c) + p.wrap : static_cast<uint32_t>(c);
  }
  // unsigned: max(x, 0), and -0 + +0 = +0
  const float h = (K == kShift && p.is_signed) ? v : fmaxf(v, 0.0f) + 0.0f;
  return __half_as_ushort(__float2half_rn(h));
}

// Plane j's field of one element's word.
template <int K>
__device__ __forceinline__ uint32_t field(uint32_t u, int j, const Params& p) {
  if (K == kFixed) return (u >> j) & 1u;
  const uint32_t e = (u >> 10) & 31u;
  const uint32_t man = (u & 1023u) | (e != 0u ? 1024u : 0u);
  if (K == kFloat16) return (((man >> j) & 1u) << 5) | e;
  const uint32_t sign = p.is_signed ? (u >> 15) << p.radix : 0u;
  return ((man >> (p.radix * j)) & ((1u << p.radix) - 1u)) | sign | (e << p.index_bits);
}

template <int K, typename InT, bool kVec>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const InT* __restrict__ x, int32_t* __restrict__ out, const Params p) {
  constexpr int kPlanes = K == kFixed ? kFixedPlanes : kHalfPlanes;
  constexpr int kFieldBits = K == kFixed ? 1 : 6;  // per element of a chunk
  const int unit = blockIdx.x * kThreads + threadIdx.x;  // 4 elements, or a chunk
  if (kVec ? unit >= (p.q >> 2) : unit >= p.k) return;
  for (int b = blockIdx.y; b < p.B; b += gridDim.y) {
    const InT* __restrict__ xr = x + static_cast<long long>(b) * p.q;
    int32_t* __restrict__ o = out + static_cast<long long>(b) * p.n * p.k;
    if (kVec) {
      const int e0 = unit << 2;
      float v[4];
      load4(xr + e0, v);
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = word<K>(v[i], p);
#pragma unroll
      for (int j = 0; j < kPlanes; ++j) {
        if (j < p.n) {
          const int4 c = make_int4(static_cast<int>(field<K>(u[0], j, p)),
                                   static_cast<int>(field<K>(u[1], j, p)),
                                   static_cast<int>(field<K>(u[2], j, p)),
                                   static_cast<int>(field<K>(u[3], j, p)));
          *reinterpret_cast<int4*>(o + static_cast<long long>(j) * p.k + e0) = c;
        }
      }
    } else {
      uint32_t code[kPlanes];
#pragma unroll
      for (int j = 0; j < kPlanes; ++j) code[j] = 0u;
      const int first = unit * p.m;
      for (int i = 0; i < p.m; ++i) {
        const int e = first + i;
        const uint32_t u = word<K>(e < p.q ? load1(xr + e) : 0.0f, p);
#pragma unroll
        for (int j = 0; j < kPlanes; ++j) code[j] |= field<K>(u, j, p) << (kFieldBits * i);
      }
#pragma unroll
      for (int j = 0; j < kPlanes; ++j) {
        if (j < p.n) o[static_cast<long long>(j) * p.k + unit] = static_cast<int32_t>(code[j]);
      }
    }
  }
}

template <int K, typename InT>
void launch(const void* x, void* out, const Params& p, bool vec, cudaStream_t s) {
  const int units = vec ? p.q / 4 : p.k;
  const dim3 grid((units + kThreads - 1) / kThreads, p.B < kMaxGridY ? p.B : kMaxGridY);
  const InT* xi = static_cast<const InT*>(x);
  int32_t* o = static_cast<int32_t*>(out);
  if (vec) {
    pack_kernel<K, InT, true><<<grid, kThreads, 0, s>>>(xi, o, p);
  } else {
    pack_kernel<K, InT, false><<<grid, kThreads, 0, s>>>(xi, o, p);
  }
}

template <int K>
void launch_kind(const void* x, void* out, int dtype, const Params& p, bool vec,
                 cudaStream_t s) {
  if (dtype == kBF16) {
    launch<K, __nv_bfloat16>(x, out, p, vec, s);
  } else {
    launch<K, float>(x, out, p, vec, s);
  }
}

// A finite float rounded to the nearest bf16 (ties to even), as a float.
float round_to_bf16(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  memcpy(&f, &u, 4);
  return f;
}

}  // namespace

// kind: 0 fixed point (n = bits planes), 1 fp16 (n = 11), 2 bitplane_shift
// (n = ceil(11 / radix)).  dtype: 0 fp32, 1 bf16.  x (B, q) and out
// (B, n, ceil(q/m)) int32 on the device, both contiguous.  Fixed point:
// bits in [1, 24], m in [1, 24], frac in [-126, 126].  fp16: m in [1, 4]
// (every packed code fits 24 bits, the LUT index limit).  shift: m = 1,
// radix in [1, 11].  vec asks for the 4-element path: chunk 1, q % 4 == 0,
// x 16-byte (fp32) or 8-byte (bf16) aligned and out 16-byte aligned.
// Returns cudaErrorInvalidValue for anything else, or cudaGetLastError()
// after the launch (0 = launched).
extern "C" int bitplane_pack_launch(const void* x, void* out, int kind, int dtype, int B,
                                    int q, int m, int bits, int frac, int is_signed, int radix,
                                    int vec, void* stream) {
  const bool bad_kind =
      (kind == kFixed && (bits < 1 || bits > kFixedPlanes || m > 24 || frac < -126 ||
                          frac > 126)) ||
      (kind == kFloat16 && m > 4) || (kind == kShift && (m != 1 || radix < 1 || radix > 11)) ||
      (kind != kFixed && kind != kFloat16 && kind != kShift);
  const int in_bytes = dtype == kBF16 ? 2 : 4;
  const bool bad_vec =
      vec && (m != 1 || q % 4 != 0 || reinterpret_cast<uintptr_t>(x) % (4 * in_bytes) != 0 ||
              reinterpret_cast<uintptr_t>(out) % 16 != 0);
  if (x == nullptr || out == nullptr || B < 1 || q < 1 || m < 1 || bad_kind || bad_vec ||
      (dtype != kF32 && dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.B = B;
  p.q = q;
  p.m = m;
  p.k = (q + m - 1) / m;
  p.n = kind == kFixed ? bits : kind == kFloat16 ? kHalfPlanes : (kHalfPlanes + radix - 1) / radix;
  if (static_cast<long long>(B) * p.n * p.k > LLONG_MAX / 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kFixed) {
    p.scale = ldexpf(1.0f, frac);
    p.lo = is_signed ? -static_cast<float>(1 << (bits - 1)) : 0.0f;
    p.hi = is_signed ? static_cast<float>((1 << (bits - 1)) - 1)
                     : static_cast<float>((1 << bits) - 1);
    if (dtype == kBF16) {
      p.lo = round_to_bf16(p.lo);
      p.hi = round_to_bf16(p.hi);
    }
    p.wrap = is_signed ? (1u << bits) : 0u;
    launch_kind<kFixed>(x, out, dtype, p, vec != 0, s);
  } else if (kind == kFloat16) {
    launch_kind<kFloat16>(x, out, dtype, p, vec != 0, s);
  } else {
    p.radix = radix;
    p.is_signed = is_signed != 0;
    p.index_bits = radix + p.is_signed;
    launch_kind<kShift>(x, out, dtype, p, vec != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bitplane_pack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
