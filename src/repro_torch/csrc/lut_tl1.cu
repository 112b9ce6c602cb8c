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
// path its entries are int16 and the accumulator int32, so the result is
// exact and independent of the order of the adds; on the exact path both
// are fp32 and the order is fixed (see below).  out (G, B, p) is int32 or
// fp32: scales and bias are applied by the wrapper.
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
// (an 81-entry LUT per packed byte folds its two pair lookups), and an SM
// retires 128 int32 adds per clock (64 INT32 lanes, each a three-input
// IADD3), 33.5 T adds/s for the card.  So the kb * p table bytes at
// 3.35 TB/s bound a call up to about 10 tokens (decode), and the B * kb * p
// adds above that (prefill).  This kernel does two adds per packed byte,
// one per pair, and leaves the folding to the compiler.
//
// Multiplier-free: the LUT entries are sums and differences of two codes,
// the accumulate is a gather and an add.  No dp4a, IMMA or wgmma; the only
// products are address arithmetic.
//
// Design, simple and correct first:
// * A block owns 128 output columns (lane l: the 4 consecutive columns of
//   one 32-bit load of packed bytes, so a warp reads 128 contiguous bytes
//   of a row) x TB batch rows (4 at decode, else 8) of one table set g.
// * It stages, for a slice of up to kt packed rows, every (row, pair) LUT
//   in shared memory ONCE; all 128 columns reuse it -- TL1's point.  The
//   layout [c][half][b][9] puts the TB rows of one (c, half, nibble) at a
//   fixed stride, so one address serves all TB rows by immediate offsets,
//   and the lanes of a warp read one pair's 9 entries: no bank conflicts.
// * The TPU kernel carried its output tile across sequential k grid steps;
//   Hopper blocks run in no order, so a block walks its packed-row range
//   itself, its 8 warps take contiguous shares of each staged slice, and
//   their partials meet in shared memory in warp order.  A decode batch
//   has too few output tiles to fill 132 SMs (wq: 32), so the wrapper cuts
//   the packed rows into `splits` ranges, each its own blocks writing
//   partials that a second small kernel adds in split order: exact on the
//   int path and deterministic on both, without atomics.
// * Batch tiles vary fastest in the grid, so the blocks in flight share
//   column tiles and a prefill's re-reads of a table tile hit L2.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;              // output columns per lane (one u32 load)
constexpr int kTileP = 32 * kCols;    // output columns per block
constexpr int kWarps = 8;             // warps per block, splitting packed rows
constexpr int kLutSmemBytes = 40 * 1024;
constexpr int kLutPad = 16;           // entries past the last LUT (nibbles <= 15)

template <typename A> struct Types;
template <> struct Types<int32_t> { using E = int16_t; using Acc = int32_t; };
template <> struct Types<float> { using E = float; using Acc = float; };

// The four bytes of packed row r for this lane's columns; zero past p.
__device__ __forceinline__ uint32_t load_row(const uint8_t* __restrict__ tcol, int r,
                                             int p, bool full, int valid) {
  const uint8_t* src = tcol + static_cast<size_t>(r) * p;
  if (full) return __ldg(reinterpret_cast<const uint32_t*>(src));
  uint32_t w = 0;
  for (int q = 0; q < valid; ++q) w |= static_cast<uint32_t>(__ldg(src + q)) << (8 * q);
  return w;
}

template <typename A, int TB>
__global__ void __launch_bounds__(kWarps * 32)
lut_tl1_kernel(const A* __restrict__ acts,                      // (B, 4*kb)
               const uint8_t* __restrict__ tables,              // (G, kb, p)
               typename Types<A>::Acc* __restrict__ out,        // (splits, G, B, p)
               const int B, const int kb, const int p, const int kt_max,
               const int vec, const int splits) {
  using E = typename Types<A>::E;
  using Acc = typename Types<A>::Acc;
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
  const int col = blockIdx.y * kTileP + lane * kCols;
  const int valid = min(kCols, p - col);
  const bool full = vec && valid == kCols;
  const uint8_t* __restrict__ tcol = tables + static_cast<size_t>(g) * kb * p + col;

  Acc acc[TB][kCols];
#pragma unroll
  for (int b = 0; b < TB; ++b)
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[b][q] = Acc(0);

  for (int c0 = k0; c0 < k1; c0 += kt_max) {
    const int kt = min(kt_max, k1 - c0);
    // stage the slice's LUTs: item i = (c * 2 + half) * TB + b
    for (int i = threadIdx.x; i < kt * 2 * TB; i += blockDim.x) {
      const int b = i % TB;
      const int ch = i / TB;
      A a0 = A(0), a1 = A(0);
      if (b < nb) {
        const A* src = acts + static_cast<size_t>(b0 + b) * 4 * kb +
                       4 * static_cast<size_t>(c0 + (ch >> 1)) + 2 * (ch & 1);
        a0 = src[0];
        a1 = src[1];
      }
      E* dst = lut + static_cast<size_t>(i) * 9;
      dst[0] = static_cast<E>(-a0 - a1);
      dst[1] = static_cast<E>(-a0);
      dst[2] = static_cast<E>(a1 - a0);
      dst[3] = static_cast<E>(-a1);
      dst[4] = static_cast<E>(0);
      dst[5] = static_cast<E>(a1);
      dst[6] = static_cast<E>(a0 - a1);
      dst[7] = static_cast<E>(a0);
      dst[8] = static_cast<E>(a0 + a1);
    }
    __syncthreads();
    if (valid > 0) {
      const int t0 = (kt * warp) / kWarps;
      const int t1 = (kt * (warp + 1)) / kWarps;
      // four rows' loads in flight before the first is needed
      for (int t = t0; t < t1; t += 4) {
        uint32_t w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          w[u] = t + u < t1 ? load_row(tcol, c0 + t + u, p, full, valid) : 0u;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (t + u < t1) {
            const E* lo_lut = lut + static_cast<size_t>(t + u) * 2 * TB * 9;
            const E* hi_lut = lo_lut + TB * 9;
#pragma unroll
            for (int q = 0; q < kCols; ++q) {
              const E* plo = lo_lut + ((w[u] >> (8 * q)) & 15u);
              const E* phi = hi_lut + ((w[u] >> (8 * q + 4)) & 15u);
#pragma unroll
              for (int b = 0; b < TB; ++b) {
                acc[b][q] += static_cast<Acc>(plo[b * 9]);
                acc[b][q] += static_cast<Acc>(phi[b * 9]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // fixed-order reduction of the warps' partials: red[warp][b][column]
  Acc* red = reinterpret_cast<Acc*>(smem_raw);
#pragma unroll
  for (int b = 0; b < TB; ++b)
#pragma unroll
    for (int q = 0; q < kCols; ++q) red[(warp * TB + b) * kTileP + lane * kCols + q] = acc[b][q];
  __syncthreads();
  for (int t = threadIdx.x; t < TB * kTileP; t += blockDim.x) {
    const int b = t / kTileP;
    const int cc = blockIdx.y * kTileP + (t - b * kTileP);
    if (b < nb && cc < p) {
      Acc s = Acc(0);
      for (int w = 0; w < kWarps; ++w) s += red[(w * TB + b) * kTileP + (t - b * kTileP)];
      out[((static_cast<size_t>(split) * G + g) * B + b0 + b) * p + cc] = s;
    }
  }
}

// out[i] = sum of the splits' partials, in split order (deterministic)
template <typename Acc>
__global__ void sum_splits(const Acc* __restrict__ part, Acc* __restrict__ out,
                           const size_t count, const int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) {
    Acc s = Acc(0);
    for (int j = 0; j < splits; ++j) s += part[j * count + i];
    out[i] = s;
  }
}

template <typename A, int TB>
void launch(const void* acts, const void* tables, void* out, void* part, int G, int B,
            int kb, int p, int vec, int splits, cudaStream_t stream) {
  using E = typename Types<A>::E;
  using Acc = typename Types<A>::Acc;
  const int per_row = 2 * TB * 9 * static_cast<int>(sizeof(E));
  const int ks = (kb + splits - 1) / splits;  // packed rows of the largest split
  int kt = kLutSmemBytes / per_row;
  kt = kt < ks ? kt : ks;
  if (kt >= kWarps) kt -= kt % kWarps;
  kt = kt > 1 ? kt : 1;
  const size_t lut_bytes = (static_cast<size_t>(kt) * 2 * TB * 9 + kLutPad) * sizeof(E);
  const size_t red_bytes = static_cast<size_t>(kWarps) * TB * kTileP * sizeof(Acc);
  const size_t smem = lut_bytes > red_bytes ? lut_bytes : red_bytes;
  const dim3 grid((B + TB - 1) / TB, (p + kTileP - 1) / kTileP, G * splits);
  lut_tl1_kernel<A, TB><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const A*>(acts), static_cast<const uint8_t*>(tables),
      static_cast<Acc*>(splits > 1 ? part : out), B, kb, p, kt, vec, splits);
  if (splits > 1) {
    const size_t count = static_cast<size_t>(G) * B * p;
    sum_splits<Acc><<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
        static_cast<const Acc*>(part), static_cast<Acc*>(out), count, splits);
  }
}

int run(const void* acts, const void* tables, void* out, void* part, int G, int is_float,
        int B, int kb, int p, int tile_rows, int vec, int splits, void* stream) {
  if (G < 1 || B < 1 || kb < 1 || p < 1 || splits < 1 || splits > kb ||
      (splits > 1 && part == nullptr) || (tile_rows != 4 && tile_rows != 8) ||
      static_cast<long long>(G) * splits > 65535 ||
      static_cast<long long>(B) * 4 * kb > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) {
    if (tile_rows == 4) launch<float, 4>(acts, tables, out, part, G, B, kb, p, vec, splits, s);
    else launch<float, 8>(acts, tables, out, part, G, B, kb, p, vec, splits, s);
  } else {
    if (tile_rows == 4) launch<int32_t, 4>(acts, tables, out, part, G, B, kb, p, vec, splits, s);
    else launch<int32_t, 8>(acts, tables, out, part, G, B, kb, p, vec, splits, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_float: 0 = int32 codes -> int32 out, 1 = fp32 values -> fp32 out.
// tile_rows: batch rows per block, 4 or 8.  splits > 1 cuts the packed
// rows into that many ranges, each its own blocks, writing (splits, G, B,
// p) partials to `part` (allocated by the caller) that sum_splits adds
// into `out`.  Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int lut_tl1_launch(const void* acts, const void* tables, void* out, void* part,
                              int is_float, int B, int kb, int p, int tile_rows, int vec,
                              int splits, void* stream) {
  return run(acts, tables, out, part, 1, is_float, B, kb, p, tile_rows, vec, splits,
             stream);
}

extern "C" int lut_tl1_grouped_launch(const void* acts, const void* tables, void* out,
                                      void* part, int G, int is_float, int B, int kb,
                                      int p, int tile_rows, int vec, int splits,
                                      void* stream) {
  return run(acts, tables, out, part, G, is_float, B, kb, p, tile_rows, vec, splits,
             stream);
}

extern "C" const char* lut_tl1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
