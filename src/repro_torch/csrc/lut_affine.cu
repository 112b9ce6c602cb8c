// Hopper (sm_90a) kernels for the TableNet LUT affine map.
//
//   out[g, b, :] = sum_j s_j * sum_c T[g, c, idx(b, j, c), :]
//
// with codes (B, n, k) int32 shared by all G table sets, tables
// (G, k, E, p) in f32 / bf16 / i8 / i16 and out (G, B, p) fp32.  With
// shift_bits > 0 (the bitplane_shift contract) idx = code & (E - 1) and
// each gathered row is scaled by 2**(max(code >> shift_bits, 1) - 25).
//
// Replaces the TPU kernels
//   src/repro/kernels/lut_affine/lut_affine.py:275 lut_affine_pallas
//     (body _kernel :52, _gather_row :41)              -> lut_affine_launch
//   src/repro/kernels/lut_affine/lut_affine.py:239 lut_affine_grouped_pallas
//     (body _grouped_kernel :88)                       -> lut_affine_grouped_launch
// Both entries run the one kernel template below; the lone projection is
// the G = 1 case of the grouped grid.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// at decode (B = 4, n = 3 planes, E = 32, i8) a chunk's B*n codes touch at
// most min(E, B*n) = 12 of its 32 rows, so the least traffic is
// k * 12 * p bytes per table set -- memory-bound (wq: ~60 us).  At prefill
// (B = 128) every row is touched and the B*n*k*p shift-adds make it
// operation-bound instead.
//
// Design, simple and correct first:
// * A block owns a tile of 4 batch rows x 32 output columns of one table
//   set g.  Lane l serves row l / 8 and the 4 consecutive columns of quad
//   l % 8, so a warp reads each gathered row slice as 32-byte sectors
//   (one 4-byte i8 / 8-byte bf16, i16 / 16-byte f32 load per lane).  The
//   narrow tile gives decode enough blocks to cover the card (wq: 128).
//   No table is zero-padded: ragged p and B edges are masked here.
// * The Pallas kernel carried its output tile across sequential k grid
//   steps; Hopper blocks run in no order, so a block walks its k range
//   itself.  Its 16 warps take contiguous chunk ranges of each staged tile
//   and their partial sums are added in shared memory in a fixed warp
//   order.  When the output tiles alone are too few to fill the card (a
//   decode batch), the wrapper asks for `splits` k ranges, each its own
//   blocks writing fp32 partials, and a second small kernel adds them in
//   split order: no atomics, deterministic.
// * Memory-level parallelism: the block stages its codes in shared memory,
//   each split once into {table row, total exponent and sign}, laid out so
//   a thread's work is one flat run of entries.  The unrolled loop over
//   that run issues 8 independent row loads before it needs the first.
// * Batch tiles vary fastest in the grid, so the blocks in flight share
//   column tiles and a prefill's repeated row reads hit L2, not HBM.
// * Shifts, not multiplies: a gathered value is scaled by adding to its
//   fp32 exponent field, the barrel shift of the paper's arithmetic.  For
//   integer tables (|v| <= 32767) one range test per launch on the plane
//   exponents proves every nonzero result normal, and the loop carries no
//   branch (accumulate_int); otherwise zeros, subnormals and out-of-range
//   results go through ldexpf, which is exact as well.  The plane scale's
//   sign flips the sign bit.  The accumulate is fp32 adds only.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;                // output columns per lane
constexpr int kQuads = 8;               // column quads per batch row
constexpr int kRows = 32 / kQuads;      // batch rows per block
constexpr int kTileP = kQuads * kCols;  // output columns per block
constexpr int kWarps = 16;              // warps per block, splitting k
constexpr int kMaxPlanes = 32;
constexpr int kCodeSmemBytes = 32 * 1024;

struct PlaneShift {
  int exp[kMaxPlanes];  // plane j scale = (bit j of neg ? -1 : 1) * 2**exp[j]
  unsigned neg;
};

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<uint16_t> { using type = ushort4; };  // bf16 bits
template <> struct Vec4<int8_t> { using type = char4; };
template <> struct Vec4<int16_t> { using type = short4; };

template <typename T> struct IsInt { static constexpr bool value = false; };
template <> struct IsInt<int8_t> { static constexpr bool value = true; };
template <> struct IsInt<int16_t> { static constexpr bool value = true; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(uint16_t x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(int16_t x) { return static_cast<float>(x); }

// 4 consecutive entries as fp32; `full` = aligned and in range.
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ src, float v[kCols],
                                      bool full, int valid) {
  if (full) {
    const typename Vec4<T>::type w =
        __ldg(reinterpret_cast<const typename Vec4<T>::type*>(src));
    v[0] = to_f(w.x);
    v[1] = to_f(w.y);
    v[2] = to_f(w.z);
    v[3] = to_f(w.w);
  } else {
#pragma unroll
    for (int q = 0; q < kCols; ++q) v[q] = q < valid ? to_f(src[q]) : 0.f;
  }
}

// x * 2**e by an add to the exponent field when x and the result are
// normal; exact in every case.
__device__ __forceinline__ float shift_f(float x, int e) {
  const unsigned u = __float_as_uint(x);
  const int ex = static_cast<int>((u >> 23) & 0xFFu);
  const int ne = ex + e;
  if (ex != 0 && ex != 255 && ne > 0 && ne < 255) {
    return __uint_as_float(u + (static_cast<unsigned>(e) << 23));
  }
  return x == 0.f ? x : ldexpf(x, e);
}

// The general step: acc += (-1)**neg * 2**e * v for any table type and
// exponent, one row slice at a time.
template <typename T>
__device__ __forceinline__ void accumulate_general(float acc[kCols], const int2* run,
                                                   int t0, int t1, const T* tcol, int p,
                                                   bool full, int valid) {
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    const int2 ie = run[t];
    float v[kCols];
    load4(tcol + static_cast<size_t>(ie.x) * p, v, full, valid);
    const unsigned sign = static_cast<unsigned>(ie.y & 1) << 31;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      acc[q] += __uint_as_float(__float_as_uint(shift_f(v[q], ie.y >> 1)) ^ sign);
    }
  }
}

// The main path's step, for integer tables whose every exponent the host
// proved in [-126, 113]: |v| <= 32767 has an exponent field <= 141, so each
// nonzero 2**e * v is normal and the shift is one integer add, the sign one
// xor -- no branch in the loop, so the unrolled body issues all its row
// loads before it needs the first.
template <typename T>
__device__ __forceinline__ void accumulate_int(float acc[kCols], const int2* run, int t0,
                                               int t1, const T* tcol, int p) {
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    const int2 ie = run[t];
    const typename Vec4<T>::type w = __ldg(
        reinterpret_cast<const typename Vec4<T>::type*>(tcol + static_cast<size_t>(ie.x) * p));
    const unsigned e23 = static_cast<unsigned>(ie.y >> 1) << 23;
    const unsigned sign = static_cast<unsigned>(ie.y & 1) << 31;
    const float v[kCols] = {to_f(w.x), to_f(w.y), to_f(w.z), to_f(w.w)};
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      acc[q] += v[q] == 0.f ? 0.f : __uint_as_float((__float_as_uint(v[q]) + e23) ^ sign);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lut_affine_kernel(const int32_t* __restrict__ codes,  // (B, n, k)
                  const T* __restrict__ tables,       // (G, k, E, p)
                  float* __restrict__ out,            // (splits, G, B, p)
                  const PlaneShift ps, const int B, const int n, const int k,
                  const int E, const int p, const int shift_bits,
                  const int kt_max, const int vec, const int fast_int,
                  const int splits) {
  // staged codes, [row][chunk][plane] of {table row, (exponent << 1) | sign};
  // reused for the warp partials at the end
  extern __shared__ int2 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rb = lane / kQuads;
  const int b0 = blockIdx.x * kRows;
  const int nb = min(kRows, B - b0);
  const int G = gridDim.z / splits;
  const int g = blockIdx.z / splits;
  const int split = blockIdx.z - g * splits;
  const int k0 = static_cast<int>(static_cast<long long>(k) * split / splits);
  const int k1 = static_cast<int>(static_cast<long long>(k) * (split + 1) / splits);
  const int col = blockIdx.y * kTileP + (lane % kQuads) * kCols;
  const int valid = min(kCols, p - col);
  const bool live = rb < nb && valid > 0;
  const bool full = vec && valid == kCols;
  const T* __restrict__ tcol = tables + static_cast<size_t>(g) * k * E * p + col;
  const int per_chunk = kRows * n;

  float acc[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) acc[q] = 0.f;

  for (int c0 = k0; c0 < k1; c0 += kt_max) {
    const int kt = min(kt_max, k1 - c0);
    // stage: consecutive threads read consecutive chunks of one code row
    for (int i = threadIdx.x; i < kt * per_chunk; i += blockDim.x) {
      const int r = i / kt;
      const int c = i - r * kt;
      const int br = r / n;
      const int j = r - br * n;
      int row = 0, ye = 0;
      if (br < nb) {
        const int code = codes[(static_cast<size_t>(b0 + br) * n + j) * k + c0 + c];
        int idx = code, e = ps.exp[j];
        if (shift_bits) {
          idx = code & (E - 1);
          e += max(code >> shift_bits, 1) - 25;
        }
        row = (c0 + c) * E + idx;
        ye = e * 2 + static_cast<int>((ps.neg >> j) & 1u);
      }
      smem[(br * kt + c) * n + j] = make_int2(row, ye);
    }
    __syncthreads();
    if (live) {
      const int2* run = smem + rb * kt * n;
      const int t0 = (kt * warp) / kWarps * n;
      const int t1 = (kt * (warp + 1)) / kWarps * n;
      if (IsInt<T>::value && fast_int && full) {
        accumulate_int<T>(acc, run, t0, t1, tcol, p);
      } else {
        accumulate_general<T>(acc, run, t0, t1, tcol, p, full, valid);
      }
    }
    __syncthreads();
  }

  // fixed-order reduction of the warps' partial sums
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int q = 0; q < kCols; ++q) red[warp * 32 * kCols + lane * kCols + q] = acc[q];
  __syncthreads();
  for (int t = threadIdx.x; t < 32 * kCols; t += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * 32 * kCols + t];
    const int l = t / kCols;
    const int br = l / kQuads;
    const int cc = blockIdx.y * kTileP + (l % kQuads) * kCols + t % kCols;
    if (br < nb && cc < p) {
      out[((static_cast<size_t>(split) * G + g) * B + b0 + br) * p + cc] = s;
    }
  }
}

// out[i] = sum of the k-splits' partials, in split order (deterministic)
__global__ void sum_splits(const float* __restrict__ part, float* __restrict__ out,
                           const size_t count, const int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) {
    float s = 0.f;
    for (int j = 0; j < splits; ++j) s += part[j * count + i];
    out[i] = s;
  }
}

template <typename T>
void launch(const void* codes, const void* tables, void* out, void* part,
            const PlaneShift& ps, int G, int B, int n, int k, int E, int p, int shift_bits,
            int vec, int fast_int, int splits, cudaStream_t stream) {
  const int per_chunk = kRows * n;
  const int ks = (k + splits - 1) / splits;  // chunks of the largest split
  int kt = kCodeSmemBytes / (per_chunk * static_cast<int>(sizeof(int2)));
  kt = kt < 512 ? kt : 512;
  kt = kt < ks ? kt : ks;
  if (kt >= kWarps) kt -= kt % kWarps;
  kt = kt > 1 ? kt : 1;
  const size_t code_bytes = static_cast<size_t>(kt) * per_chunk * sizeof(int2);
  const size_t red_bytes = static_cast<size_t>(kWarps) * 32 * kCols * sizeof(float);
  const size_t smem = code_bytes > red_bytes ? code_bytes : red_bytes;
  const dim3 grid((B + kRows - 1) / kRows, (p + kTileP - 1) / kTileP, G * splits);
  lut_affine_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int32_t*>(codes), static_cast<const T*>(tables),
      static_cast<float*>(splits > 1 ? part : out), ps, B, n, k, E, p, shift_bits, kt,
      vec, fast_int, splits);
  if (splits > 1) {
    const size_t count = static_cast<size_t>(G) * B * p;
    sum_splits<<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(part), static_cast<float*>(out), count, splits);
  }
}

int run(const void* codes, const void* tables, void* out, void* part,
        const int* plane_exp, unsigned plane_neg, int dtype, int G, int B, int n, int k,
        int E, int p, int shift_bits, int vec, int splits, void* stream) {
  if (n < 1 || n > kMaxPlanes || G < 1 || B < 1 || k < 1 || E < 1 || p < 1 ||
      splits < 1 || splits > k || (splits > 1 && part == nullptr) ||
      static_cast<long long>(G) * splits > 65535 || static_cast<long long>(k) * E > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PlaneShift ps;
  for (int j = 0; j < kMaxPlanes; ++j) ps.exp[j] = j < n ? plane_exp[j] : 0;
  ps.neg = plane_neg;
  // every total exponent is a plane exponent plus, with shift_bits, a
  // sigma exponent max(e, 1) - 25 in [-24, 6]
  int lo = plane_exp[0], hi = plane_exp[0];
  for (int j = 1; j < n; ++j) {
    lo = plane_exp[j] < lo ? plane_exp[j] : lo;
    hi = plane_exp[j] > hi ? plane_exp[j] : hi;
  }
  if (shift_bits) {
    lo -= 24;
    hi += 6;
  }
  const int fast_int = lo >= -126 && hi <= 113;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(codes, tables, out, part, ps, G, B, n, k, E, p, shift_bits, vec, fast_int, splits, s); break;
    case 1: launch<uint16_t>(codes, tables, out, part, ps, G, B, n, k, E, p, shift_bits, vec, fast_int, splits, s); break;
    case 2: launch<int8_t>(codes, tables, out, part, ps, G, B, n, k, E, p, shift_bits, vec, fast_int, splits, s); break;
    case 3: launch<int16_t>(codes, tables, out, part, ps, G, B, n, k, E, p, shift_bits, vec, fast_int, splits, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 i8, 3 i16.  plane_exp is a HOST array of n ints.
// splits > 1 cuts k into that many slices, each its own blocks, writing
// (splits, G, B, p) fp32 partials to `part` (allocated by the caller), then
// sum_splits adds them into `out`.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int lut_affine_launch(const void* codes, const void* tables, void* out,
                                 void* part, const int* plane_exp, unsigned plane_neg,
                                 int dtype, int B, int n, int k, int E, int p,
                                 int shift_bits, int vec, int splits, void* stream) {
  return run(codes, tables, out, part, plane_exp, plane_neg, dtype, 1, B, n, k, E, p,
             shift_bits, vec, splits, stream);
}

extern "C" int lut_affine_grouped_launch(const void* codes, const void* tables, void* out,
                                         void* part, const int* plane_exp,
                                         unsigned plane_neg, int dtype, int G, int B, int n,
                                         int k, int E, int p, int shift_bits, int vec,
                                         int splits, void* stream) {
  return run(codes, tables, out, part, plane_exp, plane_neg, dtype, G, B, n, k, E, p,
             shift_bits, vec, splits, stream);
}

extern "C" const char* lut_affine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
