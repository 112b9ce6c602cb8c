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
//
// Which entry runs which tile:
// * lut_affine_launch and lut_affine_grouped_launch (the lone projection is
//   the G = 1 case) run decode_kernel or prefill_kernel, picked by the
//   wrapper from the shapes alone (kernels/lut_affine/ops.py::tiling):
//   prefill when a chunk's B * n codes are at least its E rows and E <= 64,
//   decode otherwise.
// * lut_affine_experts_launch (the ragged MoE form: codes sorted by expert,
//   tables (E, G, k, En, p)) runs experts_kernel at every shape, its grid
//   picked by kernels/lut_affine/ops.py::experts_tiling.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s fp32 outside the tensor cores,
// one fp32 add per lane per clock).  At decode (B = 4, n = 3 planes,
// E = 32, i8) a chunk's 12 codes touch ~9.5 of its 32 rows: the least
// traffic is those rows once each, and bytes bound it (wq: ~48 us).  At
// prefill (B = 128) every row is touched, each table byte feeds ~12
// references, and the B*n*k*p gathered entries, each a shift and an add,
// bound it (wq: 0.19 ms).
//
// decode_kernel (bytes-bound):
// * A block owns up to 4 batch rows (4 * n <= 32 references a chunk) x one
//   512-byte slab of every table row (512 i8 columns) of one table set, over
//   a k range.  Warp (r, h) owns batch row r and half of the block's chunks;
//   lane l reads bytes [16 l, 16 l + 16) of each referenced row slab, so a
//   warp reads a row as one contiguous 512-byte run: full lines.
// * Bytes in flight: the block stages its references {table row, shift
//   word} in shared memory, a flat run per warp, and the warp issues 8 row
//   loads (ld.global.nc, 16 bytes a lane) before it applies the first; two
//   blocks of 8 warps an SM keep ~64 KB of rows in flight.
// * Measured on an H100 and given up: a producer warp that found each
//   chunk's distinct rows (__match_any_sync) and copied each once by a 1-D
//   cp.async.bulk into a ring of stages ran 1.6-2.4x slower -- one warp
//   issuing ~10 copies of 512 bytes a chunk bounded it, not the bytes.
// * Decode output tiles are few (wq: 8), so the wrapper splits k into
//   enough ranges for one wave of blocks; each range writes fp32 partials
//   and sum_splits adds them in split order: no atomics, the same operands
//   give the same bits.  (A sum by the last block of each tile, on an
//   integer arrival counter, measured 2 % slower and was taken out.)
//
// prefill_kernel (operation-bound):
// * A block owns 64 batch rows x one 512-byte slab.  A producer warp brings
//   each chunk's whole E x 512-byte table tile into a ring of 3-4 stages by
//   TMA (a 2-D tensor map over the tables seen as (G*k*E, row bytes / 4)
//   uint32, box 128 x E), so each table byte leaves L2 once per block;
//   sixteen consumer warps own 4 batch rows each.
// * All lanes of a warp read one reference's row, 16 contiguous bytes each
//   (no bank conflict); the next reference's word and row load while this
//   one is applied.  The references' {row offset, shift word} are staged
//   once per 16 chunks.
// * The instruction count bounds it: the integer loop is 61 SASS
//   instructions per 16 entries (3.8 an entry; the floor is 3: permute,
//   subtract, add) and issues at ~64 % of one instruction a cycle on an
//   H100.
//
// experts_kernel (bytes-bound at decode and prefill):
// * decode_kernel's block and access pattern, on 4 consecutive expert-sorted
//   rows whatever their experts (a block of one expert's rows held one live
//   row at decode: 16 rows on ~15 experts).  Each warp finds its row's expert
//   on the device from the offsets (a ballot over 32 experts a step), so
//   nothing is read back; its table set's base is a 64-bit offset (a
//   full-width expert stack passes 2**31 bytes).  The row tile varies
//   fastest, so the blocks on one expert's rows run together and share its
//   rows in L2 at prefill.  k splits as at decode, summed by sum_splits.
// * No TMA ring at prefill: 512 rows on 60 experts give an expert ~8.5 rows,
//   so its chunk tile of 32 rows feeds ~25 references, fewer than its rows;
//   prefill_kernel's ring pays where each row feeds ~12.  Gathering only the
//   referenced rows moves fewer bytes.
//
// The accumulate: gathers, fp32 adds, and power-of-two shifts as exponent-
// field adds with the plane sign as the sign bit; no multiply instruction.
// * Integer tables (the main path, i8): each reference's total exponent e
//   and sign go once into the exponent field and sign bit of a magic word K
//   = sign << 31 | (e + bias) << 23.  An entry x, biased to x + 128 (i8,
//   placed at bits 8..15) or x + 32768 (i16, bits 0..15), is dropped into
//   K's mantissa by one byte permute; the fp32 value of that word less the
//   value of K's word for x = 0 (K | 0x8000) is exactly +-x * 2**e (both
//   lie in one binade, so the subtraction is exact), and one fp32 add takes
//   it into the sum: permute, subtract, add.  The host proves once per
//   launch that every exponent keeps K's exponent field in [1, 254]: e in
//   [-141, 112] for i8 (bias 142), [-149, 104] for i16 (bias 150).
// * Otherwise (f32, bf16, or integer exponents outside that range) each
//   entry is converted, shifted by an exponent-field add where the value
//   and the result are normal (ldexpf, exact too, where not), and its sign
//   bit flipped (shift_f).
// kernels/lut_affine/ref.py::lut_affine_kernel_ref mirrors both paths;
// experts_kernel_ref also experts_kernel's grid and order of sums.
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <unordered_map>

namespace {

constexpr int kMaxPlanes = 32;

struct PlaneShift {
  int exp[kMaxPlanes];  // plane j scale = (bit j of neg ? -1 : 1) * 2**exp[j]
  unsigned neg;
};

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

// ---------------------------------------------------------------------------
// The kernels: decode_kernel, prefill_kernel and experts_kernel
// ---------------------------------------------------------------------------

constexpr int kSlab = 512;          // bytes of every table row a block owns
constexpr int kLaneBytes = 16;      // of the slab, per lane
constexpr int kDecodeRows = 4;      // batch-row slots of a decode block
constexpr int kDecodeHalves = 2;    // consumer groups taking alternate chunks
constexpr int kDecodeWarps = kDecodeRows * kDecodeHalves;
constexpr int kDecodeRefs = 32;     // references per chunk and block, at most
constexpr int kPrefillWarpRows = 4;  // batch rows per consumer warp
constexpr int kPrefillWarps = 16;
constexpr int kPrefillRows = kPrefillWarpRows * kPrefillWarps;
constexpr int kPrefillRingBytes = 96 * 1024;
constexpr int kMetaBytes = 24 * 1024;
constexpr int kPrefillMaxE = 64;    // a chunk's tile, E x 512 bytes, fits a stage
// the decode halves' sum: 4 rows x 32 lanes x 16 bytes' worth of fp32
constexpr int kRedBytes = kDecodeRows * 32 * kLaneBytes * 4;
// the dynamic shared memory prefill_kernel may ask for: above any launch's
// need (<= 121 KB, at E = 64), below the 227 KB a block has beside its
// static bytes (decode_kernel needs at most 24 KB)
constexpr int kMaxSmem = 200 * 1024;
// error codes past the CUDA runtime's: the tensor map could not be made
constexpr int kErrNoEncoder = 10000;
constexpr int kErrEncode = 10001;

// Integer tables: K = sign << 31 | (e + kBias) << 23 must keep its exponent
// field in [1, 254] for every total exponent e (the host's range proof).
template <typename T> struct Magic {};
template <> struct Magic<int8_t> { static constexpr int kBias = 142, kLo = -141, kHi = 112; };
template <> struct Magic<int16_t> { static constexpr int kBias = 150, kLo = -149, kHi = 104; };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the phase of parity `parity` to complete.  A wait that outlasts
// 2**36 cycles (~35 s) can only be a fault: it traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) {
      start = now;
    } else if (now - start > (1ll << 36)) {
      __trap();
    }
  }
}

// one box of the tensor map at (column c0, row c1) into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A reference's shift word: the magic word K on the integer fast path, else
// (e << 1) | sign
template <typename T, bool kFast>
__device__ __forceinline__ int shift_word(int e, unsigned sign) {
  if constexpr (kFast) {
    return static_cast<int>((sign << 31) | (static_cast<unsigned>(e + Magic<T>::kBias) << 23));
  } else {
    return e * 2 + static_cast<int>(sign);
  }
}

// entry q of a lane's 16 bytes as fp32
template <typename T>
__device__ __forceinline__ float entry(const uint32_t (&w)[4], int q) {
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));
  const uint32_t word = w[q / kPer];
  const int sh = 8 * static_cast<int>(sizeof(T)) * (q % kPer);
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(word);
  } else if constexpr (std::is_same<T, uint16_t>::value) {  // bf16 bits
    return __uint_as_float((word >> sh) << 16);
  } else if constexpr (std::is_same<T, int8_t>::value) {
    return static_cast<float>(static_cast<int8_t>(word >> sh));
  } else {
    return static_cast<float>(static_cast<int16_t>(word >> sh));
  }
}

// acc += (-1)**sign * 2**e * (a lane's 16 bytes of one gathered row).  The
// fast path: one byte permute drops the biased entry into K's mantissa, one
// exact subtraction takes off the word of entry 0, one add accumulates.
template <typename T, bool kFast>
__device__ __forceinline__ void add_row(float (&acc)[kLaneBytes / sizeof(T)], const uint4 v,
                                        const int sw) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (kFast) {
    const uint32_t K = static_cast<uint32_t>(sw);
    const float zero = __uint_as_float(K | 0x8000u);
    if constexpr (sizeof(T) == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t b = w[i] ^ 0x80808080u;  // x + 128, per byte
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // byte q to bits 8..15, K's bytes elsewhere
          acc[4 * i + q] += __uint_as_float(__byte_perm(b, K, 0x7604u | (q << 4))) - zero;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t b = w[i] ^ 0x80008000u;  // x + 32768, per half
        acc[2 * i] += __uint_as_float(__byte_perm(b, K, 0x7610u)) - zero;
        acc[2 * i + 1] += __uint_as_float(__byte_perm(b, K, 0x7632u)) - zero;
      }
    }
  } else {
    const int e = sw >> 1;
    const uint32_t sign = static_cast<uint32_t>(sw & 1) << 31;
#pragma unroll
    for (int q = 0; q < static_cast<int>(kLaneBytes / sizeof(T)); ++q) {
      acc[q] += __uint_as_float(__float_as_uint(shift_f(entry<T>(w, q), e)) ^ sign);
    }
  }
}

// The block's place in the grid: (batch tile, slab, table set x split).
struct Tile {
  int b0, nb, g, G, split, k0, nk, col_byte, slab_bytes, col0, ncols;

  __device__ __forceinline__ Tile(int rows, int B, int k, int p, int row_bytes, int splits,
                                  int elem) {
    b0 = blockIdx.x * rows;
    nb = min(rows, B - b0);
    G = gridDim.z / splits;
    g = blockIdx.z / splits;
    split = blockIdx.z - g * splits;
    k0 = static_cast<int>(static_cast<long long>(k) * split / splits);
    nk = static_cast<int>(static_cast<long long>(k) * (split + 1) / splits) - k0;
    col_byte = blockIdx.y * kSlab;
    slab_bytes = min(kSlab, row_bytes - col_byte);
    col0 = col_byte / elem;
    ncols = min(kSlab / elem, p - col0);
  }
};

// Writes `acc` (row r of the tile, this lane's columns) to `out` or to the
// split's partials.
template <typename T>
__device__ __forceinline__ void store_row(const float (&acc)[kLaneBytes / sizeof(T)],
                                          float* __restrict__ dst, const Tile& t, int r,
                                          int lane, int p) {
  constexpr int kEl = kLaneBytes / sizeof(T);
  float* drow = dst + static_cast<size_t>(t.b0 + r) * p + t.col0 + lane * kEl;
  const int valid = t.ncols - lane * kEl;
#pragma unroll
  for (int q = 0; q < kEl; ++q) {
    if (q < valid) drow[q] = acc[q];
  }
}

// Decode: each warp owns one batch row and half the block's chunks; each
// lane loads its 16 bytes of every referenced row slab straight from global
// memory (ld.global.nc), eight row loads issued before the first is used.
// The block first stages the references of up to kt_max chunks, [row][chunk]
// [plane] {table row, shift word}, in shared memory; at least kRedBytes, as
// the halves' sum reuses it.
template <typename T, bool kFast>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_kernel(const int32_t* __restrict__ codes,         // (B, n, k)
              const unsigned char* __restrict__ tables,  // (G, k, E, row_bytes)
              float* __restrict__ out,                   // (G, B, p)
              float* __restrict__ part,                  // (splits, G, B, p)
              const PlaneShift ps, const int B, const int n, const int k, const int E,
              const int p, const int row_bytes, const int shift_bits, const int rows,
              const int splits, const int kt_max) {
  constexpr int kEl = kLaneBytes / sizeof(T);
  extern __shared__ __align__(128) unsigned char dyn[];
  int2* run = reinterpret_cast<int2*>(dyn);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Tile t(rows, B, k, p, row_bytes, splits, static_cast<int>(sizeof(T)));
  const int rb = warp % kDecodeRows;
  const int h = warp / kDecodeRows;
  const bool live = rb < t.nb && lane * kLaneBytes < t.slab_bytes;
  const unsigned char* tcol = tables + static_cast<size_t>(t.g) * k * E * row_bytes +
                              t.col_byte + lane * kLaneBytes;
  float acc[kEl];
#pragma unroll
  for (int q = 0; q < kEl; ++q) acc[q] = 0.f;
  for (int c0 = 0; c0 < t.nk; c0 += kt_max) {
    const int kt = min(kt_max, t.nk - c0);
    for (int i = threadIdx.x; i < kt * t.nb * n; i += blockDim.x) {
      const int r = i / kt;  // b * n + j
      const int c = i - r * kt;
      const int br = r / n;
      const int j = r - br * n;
      const int code = codes[static_cast<size_t>(t.b0 * n + r) * k + t.k0 + c0 + c];
      int idx = code, e = ps.exp[j];
      if (shift_bits) {
        idx = code & (E - 1);
        e += max(code >> shift_bits, 1) - 25;
      }
      run[(br * kt + c) * n + j] = make_int2((t.k0 + c0 + c) * E + idx,
                                             shift_word<T, kFast>(e, (ps.neg >> j) & 1u));
    }
    __syncthreads();
    if (live) {
      const int2* my = run + rb * kt * n;
      const int t0 = (kt * h) / kDecodeHalves * n;
      const int t1 = (kt * (h + 1)) / kDecodeHalves * n;
      for (int i = t0; i < t1; i += 8) {
        uint4 v[8];
        int sw[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int2 mm = my[min(i + u, t1 - 1)];
          sw[u] = mm.y;
          v[u] = __ldg(reinterpret_cast<const uint4*>(tcol + static_cast<size_t>(mm.x) * row_bytes));
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (i + u < t1) add_row<T, kFast>(acc, v[u], sw[u]);
        }
      }
    }
    __syncthreads();
  }
  float* red = reinterpret_cast<float*>(dyn) + (rb * 32 + lane) * kEl;
  const bool rows_live = rb < t.nb;
  if (rows_live && h == 1) {
#pragma unroll
    for (int q = 0; q < kEl; ++q) red[q] = acc[q];
  }
  __syncthreads();
  float* dst = splits > 1 ? part + (static_cast<size_t>(t.split) * t.G + t.g) * B * p
                          : out + static_cast<size_t>(t.g) * B * p;
  if (rows_live && h == 0) {
#pragma unroll
    for (int q = 0; q < kEl; ++q) acc[q] += red[q];
    store_row<T>(acc, dst, t, rb, lane, p);
  }
}

// Prefill: one producer warp (lane 0) keeps each chunk's E x 512-byte table
// tile coming into a ring of stages by TMA; sixteen consumer warps own 4
// batch rows each and apply their references from shared memory.  A warp's
// references of one chunk lie contiguous, [row][plane]: the next one's word
// and row load while this one is applied (a one-deep software pipeline).
// A tile's rows lie `pitch` bytes apart: 512, or the whole row where rows
// are shorter (the TMA box never exceeds the tensor).  Shared memory: the
// ring (128-byte aligned), the staged references [chunk][row * n + plane]
// {row byte offset, shift word} of kt_max chunks, the full and empty
// mbarriers.
template <typename T, bool kFast>
__global__ void __launch_bounds__((kPrefillWarps + 1) * 32, 1)
prefill_kernel(const __grid_constant__ CUtensorMap tmap,  // tables, (G*k*E, row_bytes/4) u32
               const int32_t* __restrict__ codes, float* __restrict__ out,
               float* __restrict__ part, const PlaneShift ps, const int B, const int n,
               const int k, const int E, const int p, const int row_bytes, const int shift_bits,
               const int splits, const int stages, const int kt_max, const int pitch) {
  constexpr int kEl = kLaneBytes / sizeof(T);
  constexpr int kConsumers = kPrefillWarps * 32;
  extern __shared__ __align__(128) unsigned char dyn[];
  const int tile_bytes = E * kSlab;
  const int refs = kPrefillRows * n;
  // the ring starts at a 128-byte boundary (TMA's destination alignment)
  const uint32_t ring = (smem_u32(dyn) + 127u) & ~127u;
  unsigned char* base = dyn + (ring - smem_u32(dyn));
  int2* meta = reinterpret_cast<int2*>(base + stages * tile_bytes);
  const uint32_t full0 = smem_u32(meta + kt_max * refs);
  const uint32_t empty0 = full0 + 8 * stages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Tile t(kPrefillRows, B, k, p, row_bytes, splits, static_cast<int>(sizeof(T)));

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kPrefillWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kPrefillWarps) {
    // producer: chunk i's tile into stage i % stages once the block left it
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmap))
                   : "memory");
      const int row0 = (t.g * k + t.k0) * E;  // the tensor map's row of chunk k0, entry 0
      int s = 0, round = 0;
      for (int i = 0; i < t.nk; ++i) {
        mbar_wait(empty0 + 8 * s, (round & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, E * pitch);
        tma_load_2d(ring + s * tile_bytes, &tmap, t.col_byte / 4, row0 + i * E, full0 + 8 * s);
        if (++s == stages) {
          s = 0;
          ++round;
        }
      }
    }
    return;  // the consumers synchronise among themselves from here on
  }

  float acc[kPrefillWarpRows][kEl];
#pragma unroll
  for (int r = 0; r < kPrefillWarpRows; ++r) {
#pragma unroll
    for (int q = 0; q < kEl; ++q) acc[r][q] = 0.f;
  }
  const int nr = min(kPrefillWarpRows, t.nb - warp * kPrefillWarpRows);  // live rows
  int s = 0, round = 0;
  for (int c0 = 0; c0 < t.nk; c0 += kt_max) {
    const int kt = min(kt_max, t.nk - c0);
    // stage: consecutive threads read consecutive chunks of one code row
    for (int i = threadIdx.x; i < kt * t.nb * n; i += kConsumers) {
      const int r = i / kt;  // b * n + j
      const int c = i - r * kt;
      const int j = r % n;
      const int code = __ldg(codes + static_cast<size_t>(t.b0 * n + r) * k + t.k0 + c0 + c);
      int idx = code, e = ps.exp[j];
      if (shift_bits) {
        idx = code & (E - 1);
        e += max(code >> shift_bits, 1) - 25;
      }
      meta[c * refs + r] = make_int2(idx * pitch, shift_word<T, kFast>(e, (ps.neg >> j) & 1u));
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    for (int c = 0; c < kt; ++c) {
      mbar_wait(full0 + 8 * s, round & 1);
      if (nr > 0) {
        const int2* m = meta + c * refs + warp * kPrefillWarpRows * n;
        const unsigned char* st = base + s * tile_bytes + lane * kLaneBytes;
        const int last = nr * n - 1;
        int2 mm = m[0];
        uint4 v = *reinterpret_cast<const uint4*>(st + mm.x);
#pragma unroll
        for (int r = 0; r < kPrefillWarpRows; ++r) {
          if (r < nr) {
            for (int jj = 0; jj < n; ++jj) {
              const int2 mn = m[min(r * n + jj + 1, last)];
              const uint4 vn = *reinterpret_cast<const uint4*>(st + mn.x);
              add_row<T, kFast>(acc[r], v, mm.y);
              mm = mn;
              v = vn;
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      if (++s == stages) {
        s = 0;
        ++round;
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  }
  float* dst = splits > 1 ? part + (static_cast<size_t>(t.split) * t.G + t.g) * B * p
                          : out + static_cast<size_t>(t.g) * B * p;
#pragma unroll
  for (int r = 0; r < kPrefillWarpRows; ++r) {
    if (r < nr) store_row<T>(acc[r], dst, t, warp * kPrefillWarpRows + r, lane, p);
  }
}

// The ragged MoE form: decode_kernel's block (4 rows x one 512-byte slab
// of one table set over a k range, warp (r, h) on row r and half the
// chunks, lane l on bytes [16 l, 16 l + 16) of each referenced row slab,
// eight loads in flight) on 4 consecutive expert-sorted rows, whatever
// their experts.  Expert e owns rows [offsets[e], offsets[e + 1]); each warp
// counts the experts whose rows end at or before its row, 32 a ballot, and
// reads that expert's table set.  Rows at or past offsets[num_experts] have
// no expert: they stage nothing, read no table and write 0.  A loop of its
// own, so that decode_kernel's code stays as it was.
template <typename T, bool kFast>
__global__ void __launch_bounds__(kDecodeWarps * 32)
experts_kernel(const int32_t* __restrict__ codes,         // (T, n, k)
               const unsigned char* __restrict__ tables,  // (num_experts, G, k, En, row_bytes)
               const int32_t* __restrict__ offsets,       // (num_experts + 1,)
               float* __restrict__ out,                   // (G, T, p)
               float* __restrict__ part,                  // (splits, G, T, p)
               const PlaneShift ps, const int num_experts, const int T_rows, const int n,
               const int k, const int En, const int p, const int row_bytes,
               const int shift_bits, const int splits, const int kt_max) {
  constexpr int kEl = kLaneBytes / sizeof(T);
  extern __shared__ __align__(128) unsigned char dyn[];
  int2* run = reinterpret_cast<int2*>(dyn);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Tile t(kDecodeRows, T_rows, k, p, row_bytes, splits, static_cast<int>(sizeof(T)));
  const int rb = warp % kDecodeRows;
  const int h = warp / kDecodeRows;
  // the tile's rows that have an expert: a prefix, as the rows are sorted
  const int nlive = min(t.nb, max(0, __ldg(offsets + num_experts) - t.b0));
  int e = 0;
  for (int base = 0; base < num_experts; base += 32) {
    const int x = base + lane;
    e += __popc(__ballot_sync(0xffffffffu,
                              x < num_experts && __ldg(offsets + x + 1) <= t.b0 + rb));
  }
  const bool live = rb < nlive && e < num_experts && lane * kLaneBytes < t.slab_bytes;
  // an expert stack of full width passes 2**31 bytes: 64-bit offsets
  const unsigned char* tcol =
      tables + (static_cast<size_t>(live ? e : 0) * t.G + t.g) * k * En * row_bytes +
      t.col_byte + lane * kLaneBytes;
  float acc[kEl];
#pragma unroll
  for (int q = 0; q < kEl; ++q) acc[q] = 0.f;
  const int nk = nlive > 0 ? t.nk : 0;
  for (int c0 = 0; c0 < nk; c0 += kt_max) {
    const int kt = min(kt_max, nk - c0);
    for (int i = threadIdx.x; i < kt * nlive * n; i += blockDim.x) {
      const int r = i / kt;  // b * n + j
      const int c = i - r * kt;
      const int br = r / n;
      const int j = r - br * n;
      const int code = __ldg(codes + static_cast<size_t>(t.b0 * n + r) * k + t.k0 + c0 + c);
      int idx = code, ex = ps.exp[j];
      if (shift_bits) {
        idx = code & (En - 1);
        ex += max(code >> shift_bits, 1) - 25;
      }
      run[(br * kt + c) * n + j] = make_int2((t.k0 + c0 + c) * En + idx,
                                             shift_word<T, kFast>(ex, (ps.neg >> j) & 1u));
    }
    __syncthreads();
    if (live) {
      const int2* my = run + rb * kt * n;
      const int t0 = (kt * h) / kDecodeHalves * n;
      const int t1 = (kt * (h + 1)) / kDecodeHalves * n;
      for (int i = t0; i < t1; i += 8) {
        uint4 v[8];
        int sw[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int2 mm = my[min(i + u, t1 - 1)];
          sw[u] = mm.y;
          v[u] = __ldg(reinterpret_cast<const uint4*>(tcol + static_cast<size_t>(mm.x) * row_bytes));
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (i + u < t1) add_row<T, kFast>(acc, v[u], sw[u]);
        }
      }
    }
    __syncthreads();
  }
  // the halves' sum; rows without an expert write their zeros
  float* red = reinterpret_cast<float*>(dyn) + (rb * 32 + lane) * kEl;
  const bool rows_live = rb < t.nb;
  if (rows_live && h == 1) {
#pragma unroll
    for (int q = 0; q < kEl; ++q) red[q] = acc[q];
  }
  __syncthreads();
  float* dst = splits > 1 ? part + (static_cast<size_t>(t.split) * t.G + t.g) * T_rows * p
                          : out + static_cast<size_t>(t.g) * T_rows * p;
  if (rows_live && h == 0) {
#pragma unroll
    for (int q = 0; q < kEl; ++q) acc[q] += red[q];
    store_row<T>(acc, dst, t, rb, lane, p);
  }
}

// out[i] = sum of the k-splits' partials, in split order (deterministic);
// eight partials' loads in flight at a time
__global__ void sum_splits(const float* __restrict__ part, float* __restrict__ out,
                           const size_t count, const int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) {
    float s = 0.f;
    int j = 0;
    for (; j + 8 <= splits; j += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = part[(j + u) * count + i];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; j < splits; ++j) s += part[j * count + i];
    out[i] = s;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Every total exponent is a plane exponent plus, with shift_bits, a sigma
// exponent max(e, 1) - 25 in [-24, 6].
void exponent_range(const int* plane_exp, int n, int shift_bits, int* lo, int* hi) {
  *lo = plane_exp[0];
  *hi = plane_exp[0];
  for (int j = 1; j < n; ++j) {
    *lo = plane_exp[j] < *lo ? plane_exp[j] : *lo;
    *hi = plane_exp[j] > *hi ? plane_exp[j] : *hi;
  }
  if (shift_bits) {
    *lo -= 24;
    *hi += 6;
  }
}

PlaneShift plane_shift(const int* plane_exp, unsigned plane_neg, int n) {
  PlaneShift ps;
  for (int j = 0; j < kMaxPlanes; ++j) ps.exp[j] = j < n ? plane_exp[j] : 0;
  ps.neg = plane_neg;
  return ps;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &res);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &res);
#endif
    return (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

struct MapKey {
  const void* ptr;
  long long rows;
  int words, box_words, box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && words == o.words && box_words == o.box_words &&
           box_rows == o.box_rows;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (const long long v : {k.rows, static_cast<long long>(k.words),
                              static_cast<long long>(k.box_words),
                              static_cast<long long>(k.box_rows)}) {
      h = h * 0x100000001B3ull ^ static_cast<size_t>(v);
    }
    return h;
  }
};

// The tensor map of the tables seen as a row-major (rows, words) uint32
// matrix, one table row per row: box_words x box_rows boxes, no swizzle,
// zero fill past the last column.  Cached per (pointer, shape,
// box), which is all a map encodes: a prefill encodes nothing new once the
// allocator's addresses repeat.  Returns 0 or an error code.
int tensor_map(const void* ptr, long long rows, int words, int box_words, int box_rows,
               CUtensorMap* map) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{ptr, rows, words, box_words, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return 0;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(words), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(words) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_words),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(ptr),
                              dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kErrEncode;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

// The tiling rules, mirrored by kernels/lut_affine/ops.py::tiling.
int decode_rows(int n) { return kDecodeRows < kDecodeRefs / n ? kDecodeRows : kDecodeRefs / n; }

// staged chunks per pass, and the block's shared memory
int decode_chunks(int n) {
  const int kt = kMetaBytes / (decode_rows(n) * n * 8);
  return kt < 512 ? kt : 512;
}

int decode_smem(int n) {
  const int meta = decode_chunks(n) * decode_rows(n) * n * 8;
  return meta > kRedBytes ? meta : kRedBytes;
}

// 3 or 4 stages of E x 512 bytes (E <= 64)
int prefill_stages(int E) {
  const int s = kPrefillRingBytes / (E * kSlab);
  return s < 4 ? 3 : 4;
}

int prefill_chunks(int n) {
  const int kt = kMetaBytes / (kPrefillRows * n * 8);
  return kt > 1 ? kt : 1;
}

int prefill_smem(int n, int E) {
  return 128 + prefill_stages(E) * (E * kSlab + 16) + prefill_chunks(n) * kPrefillRows * n * 8;
}

// One dense launch: tables (G, k, E, ldt) of one type, 16-byte aligned with
// ldt * size a multiple of 16; regime 0 decode, 1 prefill.
struct Dense {
  const void* codes;
  const void* tables;
  void* out;
  void* part;
  int G, B, n, k, E, p, ldt, shift_bits, regime, splits;
};

template <typename T, bool kFast>
int launch_dense(const Dense& a, const PlaneShift& ps, cudaStream_t st) {
  const int row_bytes = a.ldt * static_cast<int>(sizeof(T));
  const int slabs = (row_bytes + kSlab - 1) / kSlab;
  const auto* codes = static_cast<const int32_t*>(a.codes);
  const auto* tables = static_cast<const unsigned char*>(a.tables);
  auto* out = static_cast<float*>(a.out);
  auto* part = static_cast<float*>(a.part);
  if (a.regime == 1) {
    CUtensorMap map;
    const int pitch = row_bytes < kSlab ? row_bytes : kSlab;
    const int merr = tensor_map(a.tables, static_cast<long long>(a.G) * a.k * a.E, row_bytes / 4,
                                pitch / 4, a.E, &map);
    if (merr != 0) return merr;
    const dim3 grid((a.B + kPrefillRows - 1) / kPrefillRows, slabs, a.G * a.splits);
    static const cudaError_t attr = cudaFuncSetAttribute(
        prefill_kernel<T, kFast>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    prefill_kernel<T, kFast><<<grid, (kPrefillWarps + 1) * 32, prefill_smem(a.n, a.E), st>>>(
        map, codes, out, part, ps, a.B, a.n, a.k, a.E, a.p, row_bytes, a.shift_bits, a.splits,
        prefill_stages(a.E), prefill_chunks(a.n), pitch);
  } else {
    const int rows = decode_rows(a.n);
    const dim3 grid((a.B + rows - 1) / rows, slabs, a.G * a.splits);
    decode_kernel<T, kFast><<<grid, kDecodeWarps * 32, decode_smem(a.n), st>>>(
        codes, tables, out, part, ps, a.B, a.n, a.k, a.E, a.p, row_bytes,
        a.shift_bits, rows, a.splits, decode_chunks(a.n));
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.splits > 1) {
    const size_t count = static_cast<size_t>(a.G) * a.B * a.p;
    sum_splits<<<static_cast<unsigned>((count + 255) / 256), 256, 0, st>>>(part, out, count,
                                                                         a.splits);
  }
  return static_cast<int>(cudaGetLastError());
}

int run_dense(const Dense& a, const int* plane_exp, unsigned plane_neg, int dtype,
              void* stream) {
  static const int kSize[4] = {4, 2, 1, 2};
  if (dtype < 0 || dtype > 3) return static_cast<int>(cudaErrorInvalidValue);
  const long long row_bytes = static_cast<long long>(a.ldt) * kSize[dtype];
  const long long rows = static_cast<long long>(a.G) * a.k * a.E;
  if (a.n < 1 || a.n > kMaxPlanes || a.G < 1 || a.B < 1 || a.k < 1 || a.E < 1 || a.p < 1 ||
      a.ldt < a.p || row_bytes % 16 != 0 || row_bytes > 65535LL * kSlab ||
      reinterpret_cast<uintptr_t>(a.tables) % 16 != 0 || a.splits < 1 || a.splits > a.k ||
      (a.splits > 1 && a.part == nullptr) ||
      static_cast<long long>(a.G) * a.splits > 65535 || rows > INT_MAX ||
      (a.shift_bits && (a.E & (a.E - 1))) || a.regime < 0 || a.regime > 1 ||
      (a.regime == 1 && a.E > kPrefillMaxE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PlaneShift ps = plane_shift(plane_exp, plane_neg, a.n);
  int lo, hi;
  exponent_range(plane_exp, a.n, a.shift_bits, &lo, &hi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dense<float, false>(a, ps, s);
    case 1: return launch_dense<uint16_t, false>(a, ps, s);
    case 2:
      return lo >= Magic<int8_t>::kLo && hi <= Magic<int8_t>::kHi
                 ? launch_dense<int8_t, true>(a, ps, s)
                 : launch_dense<int8_t, false>(a, ps, s);
    default:
      return lo >= Magic<int16_t>::kLo && hi <= Magic<int16_t>::kHi
                 ? launch_dense<int16_t, true>(a, ps, s)
                 : launch_dense<int16_t, false>(a, ps, s);
  }
}

// The ragged form's staged chunks per pass (4 rows a block at every n), and
// the block's shared memory
int experts_chunks(int n) {
  const int kt = kMetaBytes / (kDecodeRows * n * 8);
  return kt < 512 ? kt : 512;
}

int experts_smem(int n) {
  const int meta = experts_chunks(n) * kDecodeRows * n * 8;
  return meta > kRedBytes ? meta : kRedBytes;
}

// One ragged launch: `E` experts' tables (E, G, k, En, ldt) over B
// expert-sorted rows, aligned as the dense launch's.
struct Experts {
  const void* codes;
  const void* tables;
  const void* offsets;
  void* out;
  void* part;
  int E, G, B, n, k, En, p, ldt, shift_bits, splits;
};

template <typename T, bool kFast>
int launch_experts(const Experts& a, const PlaneShift& ps, cudaStream_t st) {
  const int row_bytes = a.ldt * static_cast<int>(sizeof(T));
  const dim3 grid((a.B + kDecodeRows - 1) / kDecodeRows, (row_bytes + kSlab - 1) / kSlab,
                  a.G * a.splits);
  experts_kernel<T, kFast><<<grid, kDecodeWarps * 32, experts_smem(a.n), st>>>(
      static_cast<const int32_t*>(a.codes), static_cast<const unsigned char*>(a.tables),
      static_cast<const int32_t*>(a.offsets), static_cast<float*>(a.out),
      static_cast<float*>(a.part), ps, a.E, a.B, a.n, a.k, a.En, a.p, row_bytes, a.shift_bits,
      a.splits, experts_chunks(a.n));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.splits > 1) {
    const size_t count = static_cast<size_t>(a.G) * a.B * a.p;
    sum_splits<<<static_cast<unsigned>((count + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(a.part), static_cast<float*>(a.out), count, a.splits);
  }
  return static_cast<int>(cudaGetLastError());
}

int run_experts(const Experts& a, const int* plane_exp, unsigned plane_neg, int dtype,
                void* stream) {
  static const int kSize[4] = {4, 2, 1, 2};
  if (dtype < 0 || dtype > 3) return static_cast<int>(cudaErrorInvalidValue);
  const long long row_bytes = static_cast<long long>(a.ldt) * kSize[dtype];
  if (a.n < 1 || a.n > kMaxPlanes || a.E < 1 || a.G < 1 || a.B < 1 || a.k < 1 || a.En < 1 ||
      a.p < 1 || a.ldt < a.p || row_bytes % 16 != 0 || row_bytes > 65535LL * kSlab ||
      reinterpret_cast<uintptr_t>(a.tables) % 16 != 0 || a.splits < 1 || a.splits > a.k ||
      (a.splits > 1 && a.part == nullptr) || static_cast<long long>(a.G) * a.splits > 65535 ||
      static_cast<long long>(a.k) * a.En > INT_MAX ||
      static_cast<long long>(a.B) * a.n > INT_MAX || (a.shift_bits && (a.En & (a.En - 1)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PlaneShift ps = plane_shift(plane_exp, plane_neg, a.n);
  int lo, hi;
  exponent_range(plane_exp, a.n, a.shift_bits, &lo, &hi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_experts<float, false>(a, ps, s);
    case 1: return launch_experts<uint16_t, false>(a, ps, s);
    case 2:
      return lo >= Magic<int8_t>::kLo && hi <= Magic<int8_t>::kHi
                 ? launch_experts<int8_t, true>(a, ps, s)
                 : launch_experts<int8_t, false>(a, ps, s);
    default:
      return lo >= Magic<int16_t>::kLo && hi <= Magic<int16_t>::kHi
                 ? launch_experts<int16_t, true>(a, ps, s)
                 : launch_experts<int16_t, false>(a, ps, s);
  }
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 i8, 3 i16.  plane_exp is a HOST array of n ints.
// tables (G, k, E, ldt) with ldt >= p: a 16-byte aligned base and ldt *
// size a multiple of 16 (the wrapper copies any other tables into such a
// buffer).  regime 0 runs decode_kernel, 1 prefill_kernel (E <= 64);
// splits > 1 cuts k into that many ranges, each its own blocks, writing
// (splits, G, B, p) fp32 partials to `part` (allocated by the caller), then
// sum_splits adds them into `out` in split order.  Returns 0 when launched,
// else a CUDA error code or one of this file's own (lut_affine_error_string).
extern "C" int lut_affine_launch(const void* codes, const void* tables, void* out, void* part,
                                 const int* plane_exp, unsigned plane_neg,
                                 int dtype, int B, int n, int k, int E, int p, int ldt,
                                 int shift_bits, int regime, int splits, void* stream) {
  const Dense a{codes, tables, out, part, 1, B, n, k, E, p, ldt, shift_bits, regime,
                splits};
  return run_dense(a, plane_exp, plane_neg, dtype, stream);
}

extern "C" int lut_affine_grouped_launch(const void* codes, const void* tables, void* out,
                                         void* part, const int* plane_exp,
                                         unsigned plane_neg, int dtype, int G, int B, int n,
                                         int k, int E, int p, int ldt, int shift_bits,
                                         int regime, int splits, void* stream) {
  const Dense a{codes, tables, out, part, G, B, n, k, E, p, ldt, shift_bits, regime,
                splits};
  return run_dense(a, plane_exp, plane_neg, dtype, stream);
}

// The ragged MoE form: codes (T, n, k) sorted by expert, tables
// (num_experts, G, k, En, ldt) aligned as lut_affine_launch's, offsets
// (num_experts + 1,) int32 on the device (offsets[0] = 0, offsets[e + 1] =
// rows of experts 0..e), out (G, T, p) fp32; rows past
// offsets[num_experts] come out 0.  splits as lut_affine_launch's, with
// (splits, G, T, p) partials.
extern "C" int lut_affine_experts_launch(const void* codes, const void* tables,
                                         const void* offsets, void* out, void* part,
                                         const int* plane_exp, unsigned plane_neg,
                                         int dtype, int num_experts, int G, int T, int n,
                                         int k, int En, int p, int ldt, int shift_bits,
                                         int splits, void* stream) {
  const Experts a{codes, tables, offsets, out, part, num_experts, G, T, n, k, En, p, ldt,
                  shift_bits, splits};
  return run_experts(a, plane_exp, plane_neg, dtype, stream);
}

// Dynamic shared memory of a dense block: regime 0 decode, 1 prefill.
extern "C" int lut_affine_smem_bytes(int regime, int n, int E) {
  return regime ? prefill_smem(n, E) : decode_smem(n);
}

extern "C" const char* lut_affine_error_string(int err) {
  if (err == kErrNoEncoder) return "cuTensorMapEncodeTiled could not be resolved";
  if (err == kErrEncode) return "cuTensorMapEncodeTiled refused the tables' tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
