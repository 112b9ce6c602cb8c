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
//   src/repro/kernels/lut_affine/lut_affine.py:181 lut_affine_experts_pallas
//     (body _experts_kernel :128)                      -> lut_affine_experts_launch
// All three run one tile function (lut_tile); the lone projection is the
// G = 1 case of the grouped grid.  The ragged MoE form evaluates each row,
// sorted by expert, against its own expert's (G, k, E, p) tables: the TPU
// kernel walked every (token block x expert) pair and masked the rows a
// block shared with a neighbour; here each block owns one segment of at
// most 4 rows of ONE expert, found on the device from the expert offsets
// (no read-back), so empty experts cost nothing and no row is masked.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// at decode (B = 4, n = 3 planes, E = 32, i8) a chunk's B*n codes touch at
// most min(E, B*n) = 12 of its 32 rows, so the least traffic is
// k * 12 * p bytes per table set -- memory-bound (wq: ~60 us).  At prefill
// (B = 128) every row is touched and the B*n*k*p shift-adds make it
// operation-bound instead.  The MoE form at decode (4 slots x top-4 = 16
// rows, mostly one per expert) touches up to 16 x 3 rows per chunk of
// different experts' tables: bytes-bound (expert w_gate+w_up of
// qwen2_moe_a2_7b: <= 277 MB, ~83 us); at prefill operation-bound.
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

// One block's output tile: rows [b0, b0 + nb) x the 32 columns of column
// tile `ct`, accumulated over chunks [k0, k1) of one table set `tset`
// (k, E, p) and written to `out` (rows of p fp32).  An empty chunk range
// writes zeros.
template <typename T>
__device__ __forceinline__ void lut_tile(const int32_t* __restrict__ codes,  // (B, n, k)
                                         const T* __restrict__ tset,
                                         float* __restrict__ out, const PlaneShift& ps,
                                         const int b0, const int nb, const int ct,
                                         const int n, const int k, const int k0,
                                         const int k1, const int E, const int p,
                                         const int shift_bits, const int kt_max,
                                         const int vec, const int fast_int) {
  // staged codes, [row][chunk][plane] of {table row, (exponent << 1) | sign};
  // reused for the warp partials at the end
  extern __shared__ int2 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rb = lane / kQuads;
  const int col = ct * kTileP + (lane % kQuads) * kCols;
  const int valid = min(kCols, p - col);
  const bool live = rb < nb && valid > 0;
  const bool full = vec && valid == kCols;
  const T* __restrict__ tcol = tset + col;
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
    const int cc = ct * kTileP + (l % kQuads) * kCols + t % kCols;
    if (br < nb && cc < p) out[static_cast<size_t>(b0 + br) * p + cc] = s;
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
  const int b0 = blockIdx.x * kRows;
  const int G = gridDim.z / splits;
  const int g = blockIdx.z / splits;
  const int split = blockIdx.z - g * splits;
  const int k0 = static_cast<int>(static_cast<long long>(k) * split / splits);
  const int k1 = static_cast<int>(static_cast<long long>(k) * (split + 1) / splits);
  lut_tile<T>(codes, tables + static_cast<size_t>(g) * k * E * p,
              out + (static_cast<size_t>(split) * G + g) * B * p, ps, b0,
              min(kRows, B - b0), blockIdx.y, n, k, k0, k1, E, p, shift_bits, kt_max,
              vec, fast_int);
}

// The ragged MoE form.  Rows arrive sorted by expert: expert e owns rows
// [offsets[e], offsets[e+1]), and the rows past offsets[E] (a ragged
// tail) are a last pseudo-expert whose output is zero.  Each expert's rows
// are cut into segments of at most kRows, so a segment never crosses an
// expert boundary; blockIdx.x numbers the segments in expert order and
// varies fastest, so the blocks in flight share a column tile and a
// prefill's segments of one expert re-read its tables from L2.  Each
// block finds its segment from the offsets itself (warp 0: a prefix sum
// of the segment counts over 32 experts at a time), with no read-back to
// the host; blocks past the last segment exit at once, and an empty
// expert costs nothing.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
lut_affine_experts_kernel(const int32_t* __restrict__ codes,   // (T, n, k)
                          const T* __restrict__ tables,        // (E, G, k, En, p)
                          const int32_t* __restrict__ offsets, // (E + 1,)
                          float* __restrict__ out,             // (G, T, p)
                          const PlaneShift ps, const int num_experts, const int G,
                          const int T_rows, const int n, const int k, const int En,
                          const int p, const int shift_bits, const int kt_max,
                          const int vec, const int fast_int) {
  __shared__ int seg[3];  // expert (num_experts = the zero tail), first row, rows
  const int s = blockIdx.x;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    bool found = false;
    for (int base = 0; base <= num_experts && !found; base += 32) {
      const int e = base + lane;
      int start = T_rows, end = T_rows;
      if (e < num_experts) {
        start = min(offsets[e], T_rows);
        end = min(offsets[e + 1], T_rows);
      } else if (e == num_experts) {
        start = min(offsets[num_experts], T_rows);
      }
      const int cnt = max(end - start, 0) / kRows + (max(end - start, 0) % kRows != 0);
      int inc = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += v;
      }
      const int lo = carry + inc - cnt;
      const unsigned hit = __ballot_sync(0xffffffffu, cnt > 0 && s >= lo && s < lo + cnt);
      if (hit) {
        found = true;
        if (lane == __ffs(hit) - 1) {
          const int row0 = start + (s - lo) * kRows;
          seg[0] = e;
          seg[1] = row0;
          seg[2] = min(kRows, end - row0);
        }
      }
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (!found && lane == 0) seg[2] = 0;
  }
  __syncthreads();
  const int nb = seg[2];
  if (nb <= 0) return;  // past the last segment: uniform over the block
  const int e = seg[0];
  const int ptiles = (p + kTileP - 1) / kTileP;
  const int g = blockIdx.y / ptiles;
  const int ct = blockIdx.y - g * ptiles;
  const bool tail = e == num_experts;
  // the tail's rows have no expert: an empty chunk range writes zeros
  lut_tile<T>(codes, tables + (static_cast<size_t>(tail ? 0 : e) * G + g) * k * En * p,
              out + static_cast<size_t>(g) * T_rows * p, ps, seg[1], nb, ct, n, k, 0,
              tail ? 0 : k, En, p, shift_bits, kt_max, vec, fast_int);
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

// Staged chunks per pass: as many as kCodeSmemBytes holds (at most 512 and
// at most the chunks of the largest k range), a multiple of the warps.
int staged_chunks(int n, int ks) {
  int kt = kCodeSmemBytes / (kRows * n * static_cast<int>(sizeof(int2)));
  kt = kt < 512 ? kt : 512;
  kt = kt < ks ? kt : ks;
  if (kt >= kWarps) kt -= kt % kWarps;
  return kt > 1 ? kt : 1;
}

size_t smem_bytes(int n, int kt) {
  const size_t code_bytes = static_cast<size_t>(kt) * kRows * n * sizeof(int2);
  const size_t red_bytes = static_cast<size_t>(kWarps) * 32 * kCols * sizeof(float);
  return code_bytes > red_bytes ? code_bytes : red_bytes;
}

// The shapes of one launch.  `offsets` non-null selects the ragged MoE
// form: `E` experts' tables (E, G, k, En, p) over B expert-sorted rows.
struct Launch {
  const void* codes;
  const void* tables;
  const void* offsets;
  void* out;
  void* part;
  int E, G, B, n, k, En, p, shift_bits, vec, splits;
};

template <typename T>
void launch(const Launch& a, const PlaneShift& ps, int fast_int, cudaStream_t stream) {
  const int ptiles = (a.p + kTileP - 1) / kTileP;
  if (a.offsets != nullptr) {
    const int kt = staged_chunks(a.n, a.k);
    // at most ceil(rows / kRows) + 1 segments per expert, the tail included
    const unsigned segs = static_cast<unsigned>(a.E + 1 + (a.B + kRows - 1) / kRows);
    lut_affine_experts_kernel<T><<<dim3(segs, a.G * ptiles), kWarps * 32,
                                   smem_bytes(a.n, kt), stream>>>(
        static_cast<const int32_t*>(a.codes), static_cast<const T*>(a.tables),
        static_cast<const int32_t*>(a.offsets), static_cast<float*>(a.out), ps, a.E, a.G,
        a.B, a.n, a.k, a.En, a.p, a.shift_bits, kt, a.vec, fast_int);
    return;
  }
  const int kt = staged_chunks(a.n, (a.k + a.splits - 1) / a.splits);
  const dim3 grid((a.B + kRows - 1) / kRows, ptiles, a.G * a.splits);
  lut_affine_kernel<T><<<grid, kWarps * 32, smem_bytes(a.n, kt), stream>>>(
      static_cast<const int32_t*>(a.codes), static_cast<const T*>(a.tables),
      static_cast<float*>(a.splits > 1 ? a.part : a.out), ps, a.B, a.n, a.k, a.En, a.p,
      a.shift_bits, kt, a.vec, fast_int, a.splits);
  if (a.splits > 1) {
    const size_t count = static_cast<size_t>(a.G) * a.B * a.p;
    sum_splits<<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(a.part), static_cast<float*>(a.out), count, a.splits);
  }
}

int run(const Launch& a, const int* plane_exp, unsigned plane_neg, int dtype,
        void* stream) {
  const int ptiles = (a.p + kTileP - 1) / kTileP;
  if (a.n < 1 || a.n > kMaxPlanes || a.G < 1 || a.B < 1 || a.k < 1 || a.En < 1 ||
      a.p < 1 || a.splits < 1 || a.splits > a.k || (a.splits > 1 && a.part == nullptr) ||
      static_cast<long long>(a.G) * a.splits > 65535 ||
      static_cast<long long>(a.k) * a.En > INT_MAX ||
      (a.offsets != nullptr &&
       (a.E < 1 || a.splits != 1 || static_cast<long long>(a.G) * ptiles > 65535))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PlaneShift ps;
  for (int j = 0; j < kMaxPlanes; ++j) ps.exp[j] = j < a.n ? plane_exp[j] : 0;
  ps.neg = plane_neg;
  // every total exponent is a plane exponent plus, with shift_bits, a
  // sigma exponent max(e, 1) - 25 in [-24, 6]
  int lo = plane_exp[0], hi = plane_exp[0];
  for (int j = 1; j < a.n; ++j) {
    lo = plane_exp[j] < lo ? plane_exp[j] : lo;
    hi = plane_exp[j] > hi ? plane_exp[j] : hi;
  }
  if (a.shift_bits) {
    lo -= 24;
    hi += 6;
  }
  const int fast_int = lo >= -126 && hi <= 113;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(a, ps, fast_int, s); break;
    case 1: launch<uint16_t>(a, ps, fast_int, s); break;
    case 2: launch<int8_t>(a, ps, fast_int, s); break;
    case 3: launch<int16_t>(a, ps, fast_int, s); break;
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
  const Launch a{codes, tables, nullptr, out, part, 0, 1, B, n, k, E, p, shift_bits, vec, splits};
  return run(a, plane_exp, plane_neg, dtype, stream);
}

extern "C" int lut_affine_grouped_launch(const void* codes, const void* tables, void* out,
                                         void* part, const int* plane_exp,
                                         unsigned plane_neg, int dtype, int G, int B, int n,
                                         int k, int E, int p, int shift_bits, int vec,
                                         int splits, void* stream) {
  const Launch a{codes, tables, nullptr, out, part, 0, G, B, n, k, E, p, shift_bits, vec, splits};
  return run(a, plane_exp, plane_neg, dtype, stream);
}

// The ragged MoE form: codes (T, n, k) sorted by expert, tables
// (num_experts, G, k, En, p), offsets (num_experts + 1,) int32 on the
// device (offsets[0] = 0, offsets[e + 1] = rows of experts 0..e), out
// (G, T, p) fp32; rows past offsets[num_experts] come out 0.  No k-split.
extern "C" int lut_affine_experts_launch(const void* codes, const void* tables,
                                         const void* offsets, void* out,
                                         const int* plane_exp, unsigned plane_neg,
                                         int dtype, int num_experts, int G, int T, int n,
                                         int k, int En, int p, int shift_bits, int vec,
                                         void* stream) {
  const Launch a{codes, tables, offsets, out, nullptr, num_experts, G, T, n, k, En, p,
                 shift_bits, vec, 1};
  return run(a, plane_exp, plane_neg, dtype, stream);
}

extern "C" const char* lut_affine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
