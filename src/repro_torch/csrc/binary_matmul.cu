// Hopper (sm_90a) kernel for the bitplane binary matmul, the beyond-paper
// mode that lets the tensor cores do the LUT path's adds:
//
//   out[b, :] = sum_j s_j * (planes[b, j, :] @ W)
//
// planes (B, n, q) int8 or int32 {0, 1} bits (chunk-1 bitplane codes, as
// bitplane_pack writes them), W (q, p) fp32 or bf16, s_j the n plane scales
// (host values, +-2**e), out (B, p) fp32.  W is rounded to bf16 as it is
// loaded, as the TPU kernel casts it in its body; a product of a bit and a
// bf16 value is exact, and the accumulation is fp32, so the result differs
// from the plain version only in the order of its fp32 sums.
//
// Replaces the TPU kernel
//   src/repro/kernels/binary_matmul/binary_matmul.py:47 binary_matmul_pallas
//     (body _kernel :27) -> binary_matmul_launch
//
// Bound on an H100 (3.35 TB/s; 989 TFLOP/s dense bf16 on the tensor
// cores): the product is 2*B*n*q*p operations over W's q*p elements.  At
// decode (B = 4 slots, n = 8: 32 folded rows) that is 16 operations per W
// element, far under the card's ~295 per byte, so reading W bounds it
// (full-width granite_8b w_gate in fp32: 235 MB, 0.070 ms).  At prefill
// (128 rows, 1024 folded rows) the operations bound it (w_gate: 120 GFLOP,
// 0.12 ms).
//
// Design, simple and correct first (no TMA, no wgmma: a later redesign):
// * The n plane rows of a batch row fold into the M dimension, as on the
//   TPU: a block owns tb = 64 / n whole batch rows (tb * n <= 64 folded
//   rows, the rest of its 64-row tile masked) x 64 output columns, so the
//   per-plane scale sum of every output it writes is inside the block.
// * 4 warps, each a 32 x 32 quarter of the tile as 2 x 2 nvcuda::wmma bf16
//   m16n16k16 fragments with fp32 accumulators.  Each 32-deep step stages
//   the planes tile (64 x 32) and the W tile (32 x 64) in shared memory as
//   bf16, converting as it stores; the next step's tiles are loaded into
//   registers (16-byte loads) while the tensor cores work on this one, and
//   stored into the other of two shared buffers: one barrier per step.
// * The TPU grid revisited its output tile over sequential q steps; Hopper
//   blocks run in no order, so a block walks its q range itself.  When the
//   output tiles alone are too few to fill the card (a decode batch), the
//   wrapper asks for `splits` q ranges, each its own blocks writing (B, p)
//   partials (the plane sum is linear, so each split applies it), and a
//   second small kernel adds them in split order: deterministic, no atomics.
// * Epilogue: the accumulators go to shared memory (aliasing the operand
//   buffers) and each output is sum_j s_j * C[row(b, j)], in plane order, in
//   registers; the bias is the wrapper's.
// * Ragged B*n, q and p are masked here: rows past the batch, columns past p
//   and depths past q load as 0; nothing is padded on the host.
// * Batch tiles vary fastest in the grid, so the blocks in flight share W
//   column tiles and a prefill's re-reads of W hit L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBM = 64;          // folded rows per block tile
constexpr int kBN = 64;          // output columns per block tile
constexpr int kBK = 32;          // depth per step
constexpr int kThreads = 128;    // 4 warps, 2 x 2 over the tile
constexpr int kMaxPlanes = 32;
constexpr int kLdA = kBK + 8;    // bf16 pitch of the planes tile (80 bytes)
constexpr int kLdB = kBN + 8;    // bf16 pitch of the W tile (144 bytes)
constexpr int kLdC = kBN + 4;    // fp32 pitch of the staged accumulators
constexpr int kABytes = kBM * kLdA * 2;
constexpr int kBBytes = kBK * kLdB * 2;
constexpr int kSmemBytes = 2 * (kABytes + kBBytes);
static_assert(kBM * kLdC * 4 <= kSmemBytes, "the staged accumulators alias the operands");

struct PlaneScales {
  float s[kMaxPlanes];
};

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(uint16_t v) { return __ushort_as_bfloat16(v); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(int32_t v) {
  return __float2bfloat16_rn(static_cast<float>(v));
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(int8_t v) {
  return __float2bfloat16_rn(static_cast<float>(v));
}

// A thread's share of one kRows x kCols operand tile: kLoads runs of kVec
// consecutive elements of one row, each one 16-byte load when it is
// aligned and inside the matrix, else loaded element by element with the
// edges read as 0.  Held raw in registers until stored to shared memory.
template <typename T, int kRows, int kCols>
struct Tile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kPerRow = kCols / kVec;
  static constexpr int kLoads = kRows * kCols / (kThreads * kVec);
  static_assert(kLoads * kThreads * kVec == kRows * kCols, "tile not covered");
  union Run {
    uint4 v;
    T e[kVec];
  };
  Run run[kLoads];

  // rows [r0, r0 + kRows) x cols [c0, c0 + kCols) of a row-major matrix of
  // `rows` x `cols` valid elements and pitch `ld`
  __device__ __forceinline__ void load(const T* __restrict__ src, size_t ld, int r0, int rows,
                                       int c0, int cols, bool vec) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = threadIdx.x + kThreads * u;
      const int r = r0 + i / kPerRow;
      const int c = c0 + (i % kPerRow) * kVec;
      const T* p = src + static_cast<size_t>(r) * ld + c;
      if (r < rows && vec && c + kVec <= cols) {
        run[u].v = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          run[u].e[e] = (r < rows && c + e < cols) ? p[e] : T(0);
        }
      }
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ dst, int ld) const {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = threadIdx.x + kThreads * u;
      __nv_bfloat16* d = dst + (i / kPerRow) * ld + (i % kPerRow) * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) d[e] = to_bf16(run[u].e[e]);
    }
  }
};

template <typename P, typename W>
__global__ void __launch_bounds__(kThreads)
binary_matmul_kernel(const P* __restrict__ planes,   // (B, n, q)
                     const W* __restrict__ w,        // (q, p)
                     float* __restrict__ out,        // (splits, B, p)
                     const PlaneScales ps, const int B, const int n, const int q,
                     const int p, const int tb, const int vec_a, const int vec_b,
                     const int splits) {
  // two buffers of each operand tile: [A0][A1][B0][B1]
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  auto a_s = [&](int buf) { return reinterpret_cast<__nv_bfloat16*>(smem + buf * kABytes); };
  auto b_s = [&](int buf) {
    return reinterpret_cast<__nv_bfloat16*>(smem + 2 * kABytes + buf * kBBytes);
  };

  const int b0 = blockIdx.x * tb;
  const int nb = min(tb, B - b0);
  const int rows = nb * n;  // valid folded rows of this tile
  const P* __restrict__ a_src = planes + static_cast<size_t>(b0) * n * q;
  const int n0 = blockIdx.y * kBN;
  const int split = blockIdx.z;
  const int steps = (q + kBK - 1) / kBK;
  const int t0 = static_cast<int>(static_cast<long long>(steps) * split / splits);
  const int t1 = static_cast<int>(static_cast<long long>(steps) * (split + 1) / splits);
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  Tile<P, kBM, kBK> ta;
  Tile<W, kBK, kBN> tw;
  if (t0 < t1) {
    ta.load(a_src, q, 0, rows, t0 * kBK, q, vec_a);
    tw.load(w, p, t0 * kBK, q, n0, p, vec_b);
    ta.store(a_s(0), kLdA);
    tw.store(b_s(0), kLdB);
  }
  __syncthreads();
  for (int t = t0; t < t1; ++t) {
    const int cur = (t - t0) & 1;
    const bool next = t + 1 < t1;
    if (next) {
      ta.load(a_src, q, 0, rows, (t + 1) * kBK, q, vec_a);
      tw.load(w, p, (t + 1) * kBK, q, n0, p, vec_b);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], a_s(cur) + (wm * 32 + i * 16) * kLdA + kk, kLdA);
        wmma::load_matrix_sync(fb[i], b_s(cur) + kk * kLdB + wn * 32 + i * 16, kLdB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (next) {
      ta.store(a_s(cur ^ 1), kLdA);
      tw.store(b_s(cur ^ 1), kLdB);
    }
    __syncthreads();
  }

  // the loop's last barrier (or the one before it) has retired every read
  // of the operand buffers, so the accumulators may take their place
  float* c_s = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_s + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();
  float* __restrict__ dst = out + static_cast<size_t>(split) * B * p;
  for (int e = threadIdx.x; e < nb * kBN; e += kThreads) {
    const int r = e / kBN;
    const int c = e - r * kBN;
    const int col = n0 + c;
    if (col < p) {
      const float* src = c_s + r * n * kLdC + c;
      float s = 0.0f;
      // unrolled over the most planes, so each scale is read at a constant
      // offset of the parameter block (a dynamic index would copy it to
      // the stack)
#pragma unroll
      for (int j = 0; j < kMaxPlanes; ++j) {
        if (j < n) s += ps.s[j] * src[j * kLdC];
      }
      dst[static_cast<size_t>(b0 + r) * p + col] = s;
    }
  }
}

// out[i] = sum of the splits' partials, in split order (deterministic)
__global__ void sum_splits(const float* __restrict__ part, float* __restrict__ out,
                           const size_t count, const int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) {
    float s = 0.0f;
    for (int j = 0; j < splits; ++j) s += part[j * count + i];
    out[i] = s;
  }
}

template <typename P, typename W>
void launch(const void* planes, const void* w, void* out, void* part, const PlaneScales& ps,
            int B, int n, int q, int p, int vec_a, int vec_b, int splits, cudaStream_t s) {
  const int tb = kBM / n;
  const dim3 grid((B + tb - 1) / tb, (p + kBN - 1) / kBN, splits);
  binary_matmul_kernel<P, W><<<grid, kThreads, 0, s>>>(
      static_cast<const P*>(planes), static_cast<const W*>(w),
      static_cast<float*>(splits > 1 ? part : out), ps, B, n, q, p, tb, vec_a, vec_b, splits);
  if (splits > 1) {
    const size_t count = static_cast<size_t>(B) * p;
    sum_splits<<<static_cast<unsigned>((count + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(out), count, splits);
  }
}

}  // namespace

// planes (B, n, q): plane_type 0 int8, 1 int32.  w (q, p): w_type 0 fp32,
// 1 bf16.  Both contiguous on the device; scales a HOST array of n floats.
// vec_a / vec_b: the rows of planes / W may be read in 16-byte loads
// (aligned base, q / p a multiple of the load's elements).  splits > 1
// cuts q into that many ranges, each its own blocks, writing (splits, B,
// p) fp32 partials to `part` (allocated by the caller), then sum_splits
// adds them into `out` (B, p).  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int binary_matmul_launch(const void* planes, const void* w, void* out, void* part,
                                    const float* scales, int plane_type, int w_type, int B,
                                    int n, int q, int p, int vec_a, int vec_b, int splits,
                                    void* stream) {
  const int steps = (q + kBK - 1) / kBK;
  if (B < 1 || n < 1 || n > kMaxPlanes || q < 1 || p < 1 || splits < 1 || splits > steps ||
      splits > 65535 || (splits > 1 && part == nullptr) ||
      (p + kBN - 1) / kBN > 65535 || static_cast<long long>(B) * n * q > LLONG_MAX / 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PlaneScales ps;
  for (int j = 0; j < kMaxPlanes; ++j) ps.s[j] = j < n ? scales[j] : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = plane_type * 2 + w_type;
  switch (code) {
    case 0: launch<int8_t, float>(planes, w, out, part, ps, B, n, q, p, vec_a, vec_b, splits, s); break;
    case 1: launch<int8_t, uint16_t>(planes, w, out, part, ps, B, n, q, p, vec_a, vec_b, splits, s); break;
    case 2: launch<int32_t, float>(planes, w, out, part, ps, B, n, q, p, vec_a, vec_b, splits, s); break;
    case 3: launch<int32_t, uint16_t>(planes, w, out, part, ps, B, n, q, p, vec_a, vec_b, splits, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* binary_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
