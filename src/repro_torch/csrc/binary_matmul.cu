// Hopper (sm_90a) kernel for the bitplane binary matmul, the beyond-paper
// mode that lets the tensor cores do the LUT path's adds:
//
//   out[b, :] = sum_j s_j * (planes[b, j, :] @ W)
//
// planes (B, n, q) int32 {0, 1} bits (chunk-1 bitplane codes, as
// bitplane_pack writes them), W (q, p) bf16, s_j the n plane scales (host
// values, +-2**e), out (B, p) fp32.  Both packages round W to bf16 before
// the product; the wrapper rounds an fp32 W once before the launch (the
// serve path holds its weights in bf16 already) and casts int8 planes.  A
// product of a bit and a bf16 value is exact and the accumulation is fp32,
// so the result differs from the plain version only in the order of its
// fp32 sums.
//
// Replaces the TPU kernel
//   src/repro/kernels/binary_matmul/binary_matmul.py:47 binary_matmul_pallas
//     (body _kernel :27) -> binary_matmul_launch
//
// Bound on an H100 (3.35 TB/s; 989 TFLOP/s dense bf16 on the tensor
// cores): the product is 2*B*n*q*p operations over W's q*p elements.  At
// decode (B = 4 slots, n = 8: 32 folded rows) that is 16 operations per W
// element, far under the card's ~295 per byte, so reading W bounds it
// (full-width granite_8b w_gate in bf16: 117 MB, 0.035 ms).  At prefill
// (128 rows, 1024 folded rows) the operations bound it (w_gate: 120 GFLOP,
// 0.12 ms).
//
// Design (TMA + wgmma, warp-specialised):
// * The n plane rows of a batch row fold into the M dimension, as on the
//   TPU: a block owns tb = BM / n whole batch rows (the rest of its BM-row
//   tile is never written out) x BN output columns, so the plane sum of
//   every output it writes is inside the block.
// * One producer thread keeps a ring of shared-memory stages filled by TMA,
//   completion on an mbarrier per stage; an empty mbarrier per stage hands
//   a stage back.  Operand B (W, bf16): 64-column x 64-deep boxes under the
//   128-byte swizzle, read MN-major as W lies in memory (no transpose on
//   the host).  TMA zero-fills depths past q and columns past p.
// * Operand A (planes): TMA cannot turn {0, 1} integers into bf16.  The
//   int32 planes come raw through the same ring (two 32-deep boxes of the
//   block's rows per stage, 128-byte swizzle; rows past the batch and
//   depths past q zero-filled); each consumer thread reads its wgmma
//   A-fragment elements from the stage, converts them to bf16 in registers
//   and feeds wgmma from registers.  Measured on an H100 at decode, loading
//   those elements from global memory instead, even a stage ahead, cost
//   half the kernel's time: the loads queue behind the W stream.  The
//   planes' rows must be describable by TMA (16-byte aligned base, q a
//   multiple of 4): bitplane_pack's output at the served shapes is, and the
//   wrapper copies any other planes (int8, a ragged q) into such a buffer.
// * Consumer warpgroups issue wgmma.mma_async m64nNk16 bf16 -> fp32, four
//   per 64-deep stage, keep one stage's group in flight while the next
//   stage's A is converted into the other fragment buffer, and release a
//   stage when its group retires.  Beside two consumer warpgroups the
//   producer is a whole warpgroup that gives its registers up (setmaxnreg).
// * Two tiles, picked from the folded row count B*n: a decode batch (<= 64
//   folded rows) takes one consumer warpgroup and BN = 128 (a 3-stage ring
//   of 32 KB stages; two blocks per SM): the byte bound needs bytes in
//   flight, not tensor-core width, and the m64 tile, half empty at 32 rows,
//   costs nothing at a byte bound.  Anything larger takes two consumer
//   warpgroups and a 128 x 256 tile (3 stages of 64 KB).
// * The TPU grid revisited its output tile over sequential q steps; Hopper
//   blocks run in no order, so a block walks its q range itself.  When the
//   output tiles alone are too few to fill the card (a decode batch), the
//   wrapper asks for `splits` q ranges, each its own blocks writing (B, p)
//   partials (the plane sum is linear, so each split applies it), and a
//   second small kernel adds them in split order: deterministic, no atomics.
// * Epilogue: the accumulators go to shared memory (aliasing the ring) and
//   each output is sum_j s_j * C[row(b, j)], in plane order, in registers;
//   the bias is the wrapper's.
// * Batch tiles vary fastest in the grid, so the blocks in flight share W
//   column tiles and a prefill's re-reads of W hit L2.
// * Tensor maps are encoded on the host with cuTensorMapEncodeTiled
//   (reached through cudaGetDriverEntryPoint, so no -lcuda) and cached per
//   (pointer, shape, box): a decode step re-encodes nothing once the
//   allocator's addresses repeat.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

namespace {

constexpr int kBK = 64;          // depth per stage (128 bytes of bf16 W per row)
constexpr int kPanel = 64;       // W columns per TMA box (128 bytes, the swizzle span)
constexpr int kMaxPlanes = 32;
// error codes past the CUDA runtime's: the tensor map could not be made
constexpr int kErrNoEncoder = 10000;
constexpr int kErrEncode = 10001;

struct PlaneScales {
  float s[kMaxPlanes];
};

template <int kWG, int kBN, int kStages>
struct Cfg {
  static constexpr int kBM = 64 * kWG;               // folded rows per block tile
  // consumer warpgroups + a producer: one warp beside one consumer
  // warpgroup; a whole warpgroup beside two, so that setmaxnreg can move
  // its registers to the consumers (232 each for 128 accumulators)
  static constexpr int kProducerThreads = kWG == 1 ? 32 : 128;
  static constexpr int kThreads = 128 * kWG + kProducerThreads;
  static constexpr int kPanels = kBN / kPanel;
  static constexpr int kPanelBytes = kBK * kPanel * 2;
  static constexpr int kWBytes = kPanels * kPanelBytes;
  // int32 planes by TMA: two 32-deep boxes (128-byte rows) of up to kBM rows
  static constexpr int kABoxBytes = kBM * 128;
  static constexpr int kStageBytes = kWBytes + 2 * kABoxBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kLdC = kBN + 4;               // fp32 pitch of the staged accumulators
  static constexpr int kCBytes = kBM * kLdC * 4;
  static constexpr int kBodyBytes = kRingBytes > kCBytes ? kRingBytes : kCBytes;
  // 1024 bytes of slack to align the ring to the swizzle atom, then the
  // full and empty mbarriers
  static constexpr int kSmemBytes = 1024 + kBodyBytes + 2 * kStages * 8;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of the tensor map at (column c0, row c1) into shared memory,
// completing `bytes` on the mbarrier
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory descriptor of an MN-major bf16 B operand under the 128-byte
// swizzle: 64-column panels (the swizzle atom's width) kBK * 128 bytes
// apart (leading byte offset), 8-deep row groups 1024 bytes apart (stride
// byte offset); `addr` 1024-byte aligned.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  constexpr uint64_t lbo = (kBK * 128) >> 4;
  constexpr uint64_t sbo = 1024 >> 4;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (lbo << 16) | (sbo << 32) | (1ull << 62);
}

// d[0..64) += A (4 bf16x2 registers) x B (descriptor), m64n128k16
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[0..128) += A (4 bf16x2 registers) x B (descriptor), m64n256k16
__device__ __forceinline__ void wgmma_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int kBN>
__device__ __forceinline__ void wgmma(float (&d)[kBN / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (kBN == 128) {
    wgmma_n128(d, a, desc);
  } else {
    static_assert(kBN == 256, "BN is 128 or 256");
    wgmma_n256(d, a, desc);
  }
}

__device__ __forceinline__ uint32_t bf16x2(int lo, int hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

// This thread's A-fragment elements of one 64-deep stage: rows r and r + 8
// (h2), for each 16-deep step kk the columns c, c + 1 (h = 0) and c + 8,
// c + 9 (h = 1), c = 16 kk + lc, lc = 2 (lane % 4).
struct AFrag {
  int raw[2][4][2][2];

  // from a stage's two TMA boxes of int32 planes (rows past a_rows were not
  // loaded and read as 0): box c / 32, 128-byte rows whose 16-byte chunks
  // the 128-byte swizzle placed at chunk ^ (row % 8)
  __device__ __forceinline__ void load_staged(const unsigned char* __restrict__ a_s,
                                              int box_bytes, int a_rows, int r, int lc) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = r + 8 * h2;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * kk + 8 * h + lc;
          const int kc = c & 31;
          int2 v = make_int2(0, 0);
          if (row < a_rows) {
            v = *reinterpret_cast<const int2*>(
                a_s + (c >> 5) * box_bytes + row * 128 + ((((kc >> 2) ^ (row & 7)) << 4) | ((kc & 3) << 2)));
          }
          raw[h2][kk][h][0] = v.x;
          raw[h2][kk][h][1] = v.y;
        }
      }
    }
  }

  // bf16 pairs in the m64k16 register-A order: {r, c}, {r + 8, c},
  // {r, c + 8}, {r + 8, c + 8}
  __device__ __forceinline__ void convert(uint32_t (&frag)[4][4]) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      frag[kk][0] = bf16x2(raw[0][kk][0][0], raw[0][kk][0][1]);
      frag[kk][1] = bf16x2(raw[1][kk][0][0], raw[1][kk][0][1]);
      frag[kk][2] = bf16x2(raw[0][kk][1][0], raw[0][kk][1][1]);
      frag[kk][3] = bf16x2(raw[1][kk][1][0], raw[1][kk][1][1]);
    }
  }
};

template <int kWG, int kBN, int kStages>
__global__ void __launch_bounds__(Cfg<kWG, kBN, kStages>::kThreads, kWG == 1 ? 2 : 1)
binary_matmul_kernel(const __grid_constant__ CUtensorMap wmap,  // W (q, p) bf16
                     const __grid_constant__ CUtensorMap amap,  // planes (B*n, q) int32
                     float* __restrict__ out,                   // (splits, B, p)
                     const PlaneScales ps, const int B, const int n, const int q,
                     const int p, const int tb, const int a_rows, const int splits) {
  using C = Cfg<kWG, kBN, kStages>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw_addr);
  const uint32_t full0 = base + C::kBodyBytes;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int b0 = blockIdx.x * tb;
  const int nb = min(tb, B - b0);
  const int n0 = blockIdx.y * kBN;
  const int split = blockIdx.z;
  const int steps = (q + kBK - 1) / kBK;
  const int t0 = static_cast<int>(static_cast<long long>(steps) * split / splits);
  const int t1 = static_cast<int>(static_cast<long long>(steps) * (split + 1) / splits);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kWG) {
    // producer: one thread keeps the ring's TMA loads in flight
    if constexpr (kWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 128 * kWG) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
      const uint32_t tx = C::kWBytes + 2 * a_rows * 128;
      for (int t = t0; t < t1; ++t) {
        const int it = t - t0;
        const int s = it % kStages;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, tx);
#pragma unroll
        for (int c = 0; c < C::kPanels; ++c) {
          tma_load_2d(base + s * C::kStageBytes + c * C::kPanelBytes, &wmap, n0 + c * kPanel,
                      t * kBK, full0 + 8 * s);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tma_load_2d(base + s * C::kStageBytes + C::kWBytes + h * C::kABoxBytes, &amap,
                      t * kBK + 32 * h, b0 * n, full0 + 8 * s);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns block rows [64 wg, 64 wg + 64)
  if constexpr (kWG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2;
  const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int lc = (lane & 3) * 2;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;

  // Stage t's wgmmas stay in flight while stage t + 1's A elements are
  // converted into the other fragment buffer; waiting until at most one
  // group is pending retires stage t - 1, whose ring slot goes back to the
  // producer and whose fragment buffer is then free.
  AFrag a;
  uint32_t frag0[4][4], frag1[4][4];
  auto step = [&](int t, uint32_t (&cur)[4][4]) {
    const int it = t - t0;
    const int s = it % kStages;
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    // this stage's A came with its W; `cur` is free (stage t - 1's group
    // reads the other buffer)
    a.load_staged(smem + s * C::kStageBytes + C::kWBytes, C::kABoxBytes, a_rows, r, lc);
    a.convert(cur);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma<kBN>(acc, cur[kk], desc_b(base + s * C::kStageBytes + kk * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc);
    if (it > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
  };
  for (int t = t0; t < t1; t += 2) {
    step(t, frag0);
    if (t + 1 < t1) step(t + 1, frag1);
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // every consumer has retired its last wgmma, so the accumulators may take
  // the ring's place (the producer's loads all completed: each was waited on)
  constexpr int kConsumers = 128 * kWG;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float* c_s = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = 8 * j + lc;
    *reinterpret_cast<float2*>(c_s + r * C::kLdC + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(c_s + (r + 8) * C::kLdC + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  float* __restrict__ dst = out + static_cast<size_t>(split) * B * p;
  for (int e = threadIdx.x; e < nb * kBN; e += kConsumers) {
    const int rb = e / kBN;
    const int c = e - rb * kBN;
    const int col = n0 + c;
    if (col < p) {
      const float* src = c_s + rb * n * C::kLdC + c;
      float sum = 0.0f;
      // unrolled over the most planes, so each scale is read at a constant
      // offset of the parameter block (a dynamic index would copy it to
      // the stack)
#pragma unroll
      for (int j = 0; j < kMaxPlanes; ++j) {
        if (j < n) sum += ps.s[j] * src[j * C::kLdC];
      }
      dst[static_cast<size_t>(b0 + rb) * p + col] = sum;
    }
  }
}

// out[i] = sum of the splits' partials, in split order (deterministic);
// eight partials' loads in flight at a time
__global__ void sum_splits(const float* __restrict__ part, float* __restrict__ out,
                           const size_t count, const int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) {
    float s = 0.0f;
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
  int rows, cols, box_rows, type;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && box_rows == o.box_rows &&
           type == o.type;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (const int v : {k.rows, k.cols, k.box_rows, k.type}) {
      h = h * 0x100000001B3ull ^ static_cast<size_t>(v);
    }
    return h;
  }
};

// The tensor map of a contiguous row-major (rows, cols) matrix: W in bf16
// (type 0; 64-column x kBK-row boxes) or planes in int32 (type 1; 32-column
// x box_rows boxes), 128-byte swizzle, zero fill out of bounds.  Cached per
// (pointer, shape, box), which is all a map encodes: a decode step encodes
// nothing new once the allocator's addresses repeat.  Returns 0 or an error
// code.
int tensor_map(const void* ptr, int type, int rows, int cols, int box_rows, CUtensorMap* map) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{ptr, rows, cols, box_rows, type};
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return 0;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const int elem = type == 0 ? 2 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(type == 0 ? kBK : box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult res = encode(
      map, type == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_INT32, 2,
      const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kErrEncode;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

template <int kWG, int kBN, int kStages>
int launch(const CUtensorMap& wmap, const void* planes, void* out, void* part,
           const PlaneScales& ps, int B, int n, int q, int p, int splits, cudaStream_t s) {
  using C = Cfg<kWG, kBN, kStages>;
  auto* kern = binary_matmul_kernel<kWG, kBN, kStages>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int folded = B * n;
  // the A boxes hold every row a block reads: its tile, or the whole batch
  const int a_rows = C::kBM < folded ? C::kBM : folded;
  CUtensorMap amap;
  const int merr = tensor_map(planes, 1, folded, q, a_rows, &amap);
  if (merr != 0) return merr;
  const int tb = C::kBM / n;
  const dim3 grid((B + tb - 1) / tb, (p + kBN - 1) / kBN, splits);
  kern<<<grid, C::kThreads, C::kSmemBytes, s>>>(wmap, amap,
                                                static_cast<float*>(splits > 1 ? part : out), ps,
                                                B, n, q, p, tb, a_rows, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const size_t count = static_cast<size_t>(B) * p;
    sum_splits<<<static_cast<unsigned>((count + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(out), count, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// Tiles, by the wrapper's rule (kernels/binary_matmul/ops.py::tile): a
// decode batch of <= 64 folded rows takes the one-warpgroup tile.
#define BMM_DECODE 1, 128, 3
#define BMM_PREFILL 2, 256, 3

}  // namespace

// planes (B, n, q): plane_type must be 1 (int32; the wrapper casts int8
// planes first) and vec_a 1 (TMA can describe them: 16-byte aligned base, q
// a multiple of 4; the wrapper copies any other planes into such a buffer,
// depths zero-padded, and W's rows with them).  w (q, p): w_type must be 1
// (bf16; the wrapper rounds an fp32 W first) and vec_b 1 (16-byte aligned
// base, p a multiple of 8; the wrapper copies any other W into such a
// buffer).  Both contiguous on the device; scales a HOST array of n floats.
// splits > 1 cuts q into that many ranges, each its own blocks, writing
// (splits, B, p) fp32 partials to `part` (allocated by the caller), then
// sum_splits adds them into `out` (B, p).  Returns 0 when launched, else a
// CUDA error code or one of this file's own (binary_matmul_error_string).
extern "C" int binary_matmul_launch(const void* planes, const void* w, void* out, void* part,
                                    const float* scales, int plane_type, int w_type, int B,
                                    int n, int q, int p, int vec_a, int vec_b, int splits,
                                    void* stream) {
  const int steps = (q + kBK - 1) / kBK;
  if (B < 1 || n < 1 || n > kMaxPlanes || q < 1 || p < 1 || splits < 1 || splits > steps ||
      splits > 65535 || (splits > 1 && part == nullptr) || plane_type != 1 || vec_a != 1 ||
      w_type != 1 || vec_b != 1 || q % 4 != 0 || reinterpret_cast<uintptr_t>(planes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || p % 8 != 0 ||
      (p + 127) / 128 > 65535 || static_cast<long long>(B) * n * q > LLONG_MAX / 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  const int merr = tensor_map(w, 0, q, p, 0, &map);
  if (merr != 0) return merr;
  PlaneScales ps;
  for (int j = 0; j < kMaxPlanes; ++j) ps.s[j] = j < n ? scales[j] : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<long long>(B) * n <= 64
             ? launch<BMM_DECODE>(map, planes, out, part, ps, B, n, q, p, splits, s)
             : launch<BMM_PREFILL>(map, planes, out, part, ps, B, n, q, p, splits, s);
}

extern "C" const char* binary_matmul_error_string(int err) {
  if (err == kErrNoEncoder) return "cuTensorMapEncodeTiled could not be resolved";
  if (err == kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map (W or planes)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of a block of the decode (0) or the prefill (1)
// tile, for the build report.
extern "C" int binary_matmul_smem_bytes(int prefill) {
  return prefill ? Cfg<BMM_PREFILL>::kSmemBytes : Cfg<BMM_DECODE>::kSmemBytes;
}
