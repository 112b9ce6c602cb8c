// Hopper (sm_90a) kernels for the TL1 activation-side LUT family.
//
//   out[g, b, :] = sum_c lut_b[c, widx[g, c, :]]
//
// acts (B, 4*kb) holds each token's activation codes (int32, or fp32 on
// the exact path), element 4c + j in the j-th slot of packed row c.
// tables (G, kb, p) uint8 holds two base-3 weight-pair indices per byte,
// low nibble first: the low nibble of row c indexes the LUT of the pair
// (a[4c], a[4c+1]), the high nibble that of (a[4c+2], a[4c+3]).  A pair's
// LUT is [-a0-a1, -a0, a1-a0, -a1, 0, a1, a0-a1, a0, a0+a1].  On the int
// path the accumulator is int32, so the result is exact and independent of
// the order of the adds; on the exact path it is fp32 and the order is
// fixed (see below).  out (G, B, p) is int32 or fp32: scales and bias are
// applied by the wrapper.
//
// Replaces the TPU kernels
//   src/repro/kernels/lut_tl1/lut_tl1.py:125 lut_tl1_pallas
//     (body _kernel :70, _accum_block :52, _pair_lut :43) -> lut_tl1_launch
//   src/repro/kernels/lut_tl1/lut_tl1.py:154 lut_tl1_grouped_pallas
//     (body _grouped_kernel :95)                          -> lut_tl1_grouped_launch
// Both entries run the one kernel template below; the lone projection is
// the G = 1 case of the grouped grid.
//
// Bound on an H100: the least work is one add per packed byte per column
// and token (an 81-entry LUT per packed byte folds its two pair lookups),
// and an SM retires 128 int32 adds per clock (64 INT32 lanes, each a
// three-input IADD3), 33.5 T adds/s for the card.  So the kb * p table
// bytes at 3.35 TB/s bound a call up to about 10 tokens (decode), and the
// B * kb * p adds above that (prefill).
//
// Multiplier-free: the LUT entries are sums and differences of codes, the
// accumulate is a gather and an add.  No dp4a, IMMA or wgmma; the only
// products are address arithmetic.
//
// Design: one lookup and one add per packed byte.
// * Per packed row c and token b a block stages the folded LUT
//     F[byte] = pairLUT_lo[byte & 15] + pairLUT_hi[byte >> 4]
//   in shared memory, built with adds only (the two 9-entry pair LUTs, then
//   81 adds), in 256 slots addressed by the byte itself, 81 of them used.
//   The main loop then does, per packed byte and column, one shared-memory
//   load that brings every token's entry and one add per token.
// * Slots are laid out [c][slot][b]: the TB tokens' entries of one byte are
//   adjacent, so one 8-byte load (TB = 4, int16) or 16-byte load (TB = 8)
//   brings them all.  A row's slot for byte v is v ^ (v >> 4) within the
//   row's 256: a warp's 32 lanes look up random bytes of one row, and with
//   the byte itself the low bits of the slot would be the low nibble alone
//   (9 values), so the lookups would pile onto 9 of 16 bank pairs; the XOR
//   spreads them over all 16 (three operations per 4 packed bytes).  Rows
//   are 257 slots apart, so a warp building one slot across 8 rows writes
//   8 different bank pairs.
// * Entry width, decided on the host from the plan: an entry is bounded by
//   4 * qa (qa = 2**(act_bits-1) - 1).  Where the plan proves 4 * qa <= 511
//   (every TL1 plan: act_bits <= 8 gives 508) entries are stored as uint16
//   biased by +512, two tokens to a 32-bit word, so one 32-bit add serves
//   two tokens: a biased entry lies in [1, 1023] (at most 1020 at int8
//   codes), so a 16-bit half holds 64 rows (64 * 1023 = 65472 < 65536)
//   before it is widened into the int32 accumulators and rows << 9 is
//   subtracted; a stage holds at most 64 rows and is flushed at its end.
//   That is adds and shifts only, and exact.  Without such a plan entries
//   are int32 (one add per token); on the exact path fp32.
// * A block owns 1024 output columns of one table set g: each of its 8
//   warps 128 of them (lane l: the 4 consecutive columns of one 32-bit load
//   of packed bytes, so a warp reads 128 contiguous bytes of a row), over
//   every row of the block's range, 8 rows' loads in flight; TB batch rows
//   (4 at decode, else 8).  So every warp reuses the stage's LUTs for its
//   own 128 columns and no reduction across warps is needed; the build is
//   amortised over 1024 columns and stays inside the block (a separate
//   pre-pass would add a launch to a host-bound step).
// * The TPU kernel carried its output tile across sequential k grid steps;
//   Hopper blocks run in no order, so a block walks its packed-row range
//   itself, and each column's sum is taken in row order.  A decode batch
//   has too few output tiles to fill 132 SMs, so the wrapper cuts the
//   packed rows into `splits` ranges, each its own blocks writing partials
//   that a second small kernel adds in split order: exact on the int path
//   and deterministic on both.  (Adding the int32 sums into a zeroed output
//   with atomics instead was measured slower: the splits of a column
//   contend for one address.)
// * Batch tiles vary fastest in the grid, so the blocks in flight share
//   column tiles and a prefill's re-reads of a table tile hit L2.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kCols = 4;                 // output columns per lane (one u32 load)
constexpr int kWarps = 8;                // warps per block, each 128 columns
constexpr int kTileP = kWarps * 32 * kCols;  // output columns per block
constexpr int kSlots = 256;              // folded-LUT slots per packed row (by byte)
constexpr int kRowSlots = kSlots + 1;    // a row's pitch in slots (bank spread)
constexpr int kLutSmemBytes = 64 * 1024;  // the staged LUTs of one slice of rows
constexpr int kInFlight = 8;             // packed rows loaded ahead per lane
constexpr int kBias = 512;               // biased int16 entries: entry + 512
constexpr int kBiasShift = 9;
constexpr int kFlushRows = 64;           // rows a biased 16-bit half holds

// entry formats (the `entry` argument of the C entries)
constexpr int kEntryInt32 = 0;   // int32 codes, int32 entries
constexpr int kEntryFloat = 1;   // fp32 values, fp32 entries (exact path)
constexpr int kEntryBiased = 2;  // int32 codes, uint16 entries biased by kBias

template <typename A> struct AccOf;
template <> struct AccOf<int32_t> { using T = int32_t; };
template <> struct AccOf<float> { using T = float; };

// The four bytes of packed row r for this lane's columns; zero past p.
__device__ __forceinline__ uint32_t load_row(const uint8_t* __restrict__ tcol, int r,
                                             int p, bool full, int valid) {
  const uint8_t* src = tcol + static_cast<size_t>(r) * p;
  if (full) return __ldg(reinterpret_cast<const uint32_t*>(src));
  uint32_t w = 0;
  for (int q = 0; q < valid; ++q) w |= static_cast<uint32_t>(__ldg(src + q)) << (8 * q);
  return w;
}

// value of the pair LUT at digit pair (d0, d1), digits 0..2 for -1, 0, +1
template <typename A>
__device__ __forceinline__ A pair_value(int d0, int d1, A x, A y) {
  const A vx = d0 == 0 ? -x : (d0 == 2 ? x : A(0));
  const A vy = d1 == 0 ? -y : (d1 == 2 ? y : A(0));
  return vx + vy;
}

template <typename E, typename A>
__device__ __forceinline__ E to_entry(A v) {
  if constexpr (sizeof(E) == 2) {
    return static_cast<E>(v + kBias);
  } else {
    return static_cast<E>(v);
  }
}

// a 32-bit entry loaded as int bits
template <typename T>
__device__ __forceinline__ T from_bits(int v) {
  if constexpr (std::is_floating_point<T>::value) {
    return __int_as_float(v);
  } else {
    return v;
  }
}

// Per-lane accumulate of one packed byte's TB entries into this column's
// accumulators: biased words add two tokens each, wide entries one.
template <typename E, typename Acc, int TB>
struct Accum {
  static constexpr bool kBiased = sizeof(E) == 2;
  static constexpr int kWords = kBiased ? TB / 2 : 1;
  uint32_t half[kCols][kWords];  // biased pairs (unused when wide)
  Acc wide[kCols][TB];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
#pragma unroll
      for (int b = 0; b < TB; ++b) wide[q][b] = Acc(0);
#pragma unroll
      for (int k = 0; k < kWords; ++k) half[q][k] = 0u;
    }
  }

  __device__ __forceinline__ void add(int q, const E* __restrict__ e) {
    if constexpr (kBiased) {
      if constexpr (TB == 4) {
        const uint2 v = *reinterpret_cast<const uint2*>(e);
        half[q][0] += v.x;
        half[q][1] += v.y;
      } else {
        const uint4 v = *reinterpret_cast<const uint4*>(e);
        half[q][0] += v.x;
        half[q][1] += v.y;
        half[q][2] += v.z;
        half[q][3] += v.w;
      }
    } else {
      // int32 or fp32 entries: 16-byte loads of four tokens each
#pragma unroll
      for (int b0 = 0; b0 < TB; b0 += 4) {
        const int4 v = *reinterpret_cast<const int4*>(e + b0);
        wide[q][b0 + 0] += from_bits<Acc>(v.x);
        wide[q][b0 + 1] += from_bits<Acc>(v.y);
        wide[q][b0 + 2] += from_bits<Acc>(v.z);
        wide[q][b0 + 3] += from_bits<Acc>(v.w);
      }
    }
  }

  // widen the biased halves after `rows` (<= kFlushRows) rows: each half
  // holds sum(entry + kBias) over those rows
  __device__ __forceinline__ void flush(int rows) {
    if constexpr (kBiased) {
      const int offset = rows << kBiasShift;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          wide[q][2 * k] += static_cast<int>(half[q][k] & 0xFFFFu) - offset;
          wide[q][2 * k + 1] += static_cast<int>(half[q][k] >> 16) - offset;
          half[q][k] = 0u;
        }
      }
    }
  }
};

template <typename A, typename E, int TB>
__global__ void __launch_bounds__(kWarps * 32)
lut_tl1_kernel(const A* __restrict__ acts,                      // (B, 4*kb)
               const uint8_t* __restrict__ tables,              // (G, kb, p)
               typename AccOf<A>::T* __restrict__ out,          // (splits, G, B, p)
               const int B, const int kb, const int p, const int kt_max,
               const int vec, const int splits) {
  using Acc = typename AccOf<A>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* lut = reinterpret_cast<E*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * TB;
  const int nb = min(TB, B - b0);
  const int G = gridDim.z / splits;
  const int g = blockIdx.z / splits;
  const int split = blockIdx.z - g * splits;
  const int k0 = static_cast<int>(static_cast<long long>(kb) * split / splits);
  const int k1 = static_cast<int>(static_cast<long long>(kb) * (split + 1) / splits);
  const int col = blockIdx.y * kTileP + warp * 32 * kCols + lane * kCols;
  const int valid = min(kCols, p - col);
  const bool full = vec && valid == kCols;
  const uint8_t* __restrict__ tcol = tables + static_cast<size_t>(g) * kb * p + col;

  Accum<E, Acc, TB> acc;
  acc.zero();

  for (int c0 = k0; c0 < k1; c0 += kt_max) {
    const int kt = min(kt_max, k1 - c0);
    // Stage the slice's folded LUTs.  Work item (row c, token b, high digit
    // h): the low pair's 9 values and the high pair's value at h, then the
    // 9 slots of bytes (h << 4) | l.  Items of one warp span 9 high digits,
    // so their slots fall in different bank pairs.
    for (int i = threadIdx.x; i < kt * TB * 9; i += blockDim.x) {
      const int h = i % 9;
      const int cb = i / 9;
      const int b = cb % TB;
      const int c = cb / TB;
      A a0 = A(0), a1 = A(0), a2 = A(0), a3 = A(0);
      if (b < nb) {
        const A* src = acts + static_cast<size_t>(b0 + b) * 4 * kb + 4 * static_cast<size_t>(c0 + c);
        a0 = src[0];
        a1 = src[1];
        a2 = src[2];
        a3 = src[3];
      }
      const int hd0 = h >= 6 ? 2 : (h >= 3 ? 1 : 0);
      const A hi = pair_value<A>(hd0, h - hd0 - hd0 - hd0, a2, a3);
      const A s = a0 + a1;
      const A d = a1 - a0;
      const A lo[9] = {-s, -a0, d, -a1, A(0), a1, -d, a0, s};
      E* row = lut + static_cast<size_t>(c) * kRowSlots * TB + b;
#pragma unroll
      for (int l = 0; l < 9; ++l) {
        const int slot = (h << 4) | (l ^ h);  // byte (h << 4) | l, swizzled
        row[slot * TB] = to_entry<E, A>(lo[l] + hi);
      }
    }
    __syncthreads();
    if (valid > 0) {
      for (int t = 0; t < kt; t += kInFlight) {
        uint32_t w[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          w[u] = t + u < kt ? load_row(tcol, c0 + t + u, p, full, valid) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (t + u < kt) {
            // slot of byte v: v ^ (v >> 4), for the four bytes at once
            const uint32_t sw = w[u] ^ ((w[u] >> 4) & 0x0F0F0F0Fu);
            const E* row = lut + static_cast<size_t>(t + u) * kRowSlots * TB;
#pragma unroll
            for (int q = 0; q < kCols; ++q) acc.add(q, row + ((sw >> (8 * q)) & 0xFFu) * TB);
          }
        }
      }
      acc.flush(kt);
    }
    __syncthreads();
  }

  if (valid > 0) {
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      Acc* dst = out + ((static_cast<size_t>(split) * G + g) * B + b0 + b) * p + col;
      if constexpr (TB == 4) {
        if (b < nb) {
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            if (q < valid) dst[q] = acc.wide[q][b];
          }
        }
      } else {
        // one predicate per store: with the row test outside, ptxas kept the
        // 32 accumulators of the 8-row tile in local memory (measured)
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          if (b < nb && q < valid) dst[q] = acc.wide[q][b];
        }
      }
    }
  }
}

// out[i] = sum of the splits' partials, in split order (deterministic);
// eight partials' loads in flight at a time
template <typename Acc>
__global__ void sum_splits(const Acc* __restrict__ part, Acc* __restrict__ out,
                           const size_t count, const int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) {
    Acc s = Acc(0);
    int j = 0;
    for (; j + 8 <= splits; j += 8) {
      Acc v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = part[(j + u) * count + i];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; j < splits; ++j) s += part[j * count + i];
    out[i] = s;
  }
}

template <typename A, typename E, int TB>
int launch(const void* acts, const void* tables, void* out, void* part, int G, int B, int kb,
           int p, int vec, int splits, cudaStream_t stream) {
  using Acc = typename AccOf<A>::T;
  const int row_bytes = kRowSlots * TB * static_cast<int>(sizeof(E));
  const int ks = (kb + splits - 1) / splits;  // packed rows of the largest split
  int kt = kLutSmemBytes / row_bytes;
  if (sizeof(E) == 2 && kt > kFlushRows) kt = kFlushRows;
  kt = kt < ks ? kt : ks;
  const size_t smem = static_cast<size_t>(kt) * row_bytes;
  auto* kern = lut_tl1_kernel<A, E, TB>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kLutSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((B + TB - 1) / TB, (p + kTileP - 1) / kTileP, G * splits);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const A*>(acts), static_cast<const uint8_t*>(tables),
      static_cast<Acc*>(splits > 1 ? part : out), B, kb, p, kt, vec, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const size_t count = static_cast<size_t>(G) * B * p;
    sum_splits<Acc><<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
        static_cast<const Acc*>(part), static_cast<Acc*>(out), count, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int TB>
int launch_entry(int entry, const void* acts, const void* tables, void* out, void* part, int G,
                 int B, int kb, int p, int vec, int splits, cudaStream_t s) {
  switch (entry) {
    case kEntryInt32:
      return launch<int32_t, int32_t, TB>(acts, tables, out, part, G, B, kb, p, vec, splits, s);
    case kEntryFloat:
      return launch<float, float, TB>(acts, tables, out, part, G, B, kb, p, vec, splits, s);
    case kEntryBiased:
      return launch<int32_t, uint16_t, TB>(acts, tables, out, part, G, B, kb, p, vec, splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(const void* acts, const void* tables, void* out, void* part, int G, int entry, int B,
        int kb, int p, int tile_rows, int vec, int splits, void* stream) {
  if (G < 1 || B < 1 || kb < 1 || p < 1 || splits < 1 || splits > kb ||
      (splits > 1 && part == nullptr) || (tile_rows != 4 && tile_rows != 8) ||
      static_cast<long long>(G) * splits > 65535 ||
      static_cast<long long>(B) * 4 * kb > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_rows == 4) return launch_entry<4>(entry, acts, tables, out, part, G, B, kb, p, vec, splits, s);
  return launch_entry<8>(entry, acts, tables, out, part, G, B, kb, p, vec, splits, s);
}

}  // namespace

// entry: 0 = int32 codes, int32 entries -> int32 out; 1 = fp32 values ->
// fp32 out; 2 = int32 codes whose folded entries the caller's plan bounds
// by 511 (uint16 entries biased by +512) -> int32 out.  tile_rows: batch
// rows per block, 4 or 8.  splits > 1 cuts the packed rows into that many
// ranges, each its own blocks, writing (splits, G, B, p) partials to `part`
// (allocated by the caller) that sum_splits adds into `out` in split order.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int lut_tl1_launch(const void* acts, const void* tables, void* out, void* part,
                              int entry, int B, int kb, int p, int tile_rows, int vec,
                              int splits, void* stream) {
  return run(acts, tables, out, part, 1, entry, B, kb, p, tile_rows, vec, splits, stream);
}

extern "C" int lut_tl1_grouped_launch(const void* acts, const void* tables, void* out,
                                      void* part, int G, int entry, int B, int kb, int p,
                                      int tile_rows, int vec, int splits, void* stream) {
  return run(acts, tables, out, part, G, entry, B, kb, p, tile_rows, vec, splits, stream);
}

extern "C" const char* lut_tl1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most dynamic shared memory a block stages (its slice of folded
// LUTs), for the build report.
extern "C" int lut_tl1_smem_bytes() { return kLutSmemBytes; }
