// Hopper (sm_90a) counterparts of the repo's Pallas probes, plain C interface.
//
// Replaces the 15 layout probes of tools/proto_mosaic_caps.py (probe_a ...
// probe_m, one pl.pallas_call each) and the two diagnostic variants of
// tools/pallas_conv_probe.py::pallas_conv3x3_int8 that compute another
// function than the int8 conv (variant="mmonly" and variant="taps9bf16").
// The probes were the TPU team's census of the in-kernel primitives the fused
// SPADE kernel is built from; here each is computed by one of four kernel
// families, written for this card rather than carried over block by block:
//
//  1. movement (B, B2, C, C2, E, F, G, H, K, L): gather32_kernel maps each
//     output unit through a collapsed strided map to its input, then
//     optionally y = a*x (+ b) with a constant a or a per-channel one,
//     rounded as a multiply and then an add (never contracted into an FMA).
//     What bounds it at the probes' sizes (12 KB to 3 MB): the bytes, then
//     the launch and the first load's latency. The host (ops/probes.py)
//     merges the dims whose strides chain and computes each remaining
//     divisor as a multiply-shift pair, so a unit's address is one 32-bit
//     multiply-high a dim, with no division on the critical path (B, F, G
//     and H are one contiguous run). Rank, unit and affine mode are template
//     parameters. A unit is 16 bytes wherever the last dim is contiguous and
//     its length a multiple of 16 bytes: loaded as one aligned piece, or,
//     where every row starts at the same offset past 16-byte alignment (K: 12
//     bytes into 224-byte rows), as the two aligned pieces around it,
//     funnel-shifted in registers; one element only where the map has no
//     contiguous last dim. A thread moves four units a pass and issues all
//     four loads before its first store; the grid is capped at four blocks
//     an SM (a grid-stride loop beyond), and E's channel scales are read
//     into shared memory once a block. transpose_kernel (C, C2) goes
//     through a 32 x 33 f32 tile in shared memory, so reads and writes are
//     both coalesced and neither conflicts on a bank; ragged edges are
//     masked.
//  2. contraction (A, A2, D, I): gemm_wgmma, C[M,N] = sum_k A[m,k] B[k,N],
//     bf16 operands, f32 sums, out f32 or bf16 rounded once from the f32 sum
//     (A). What bounds it at K <= 32: the bytes (0.1-0.6 us of HBM) under a
//     chain of one load latency, one product and one store, then the launch;
//     the operations are 1-3% of the bytes' time. So a block of 64 x 64
//     outputs (wgmma's 64 rows, one warpgroup) loads all of K (at most 64:
//     one 128-byte row of bf16) in one stage with one wait on one mbarrier,
//     runs ceil(K / 16) wgmma m64n64k16 with f32 sums, stages the sums in
//     shared memory and stores them in coalesced 16-byte pieces. The 64-
//     column tile gives D and I 126 blocks on the 132 SMs (A 32, A2 36),
//     and halves each block's store against 64 x 128. Operands come by TMA
//     wherever their global row pitch is a multiple of 16 bytes: B (K, N)
//     always (N a multiple of 8), as 128-byte-swizzled boxes of 64 columns
//     read MN-major through wgmma's transpose bit; A (M, K) with K a
//     multiple of 8 as K-major boxes of 64 K (probe A's 64-byte rows, the K
//     past 32 zero filled); A2's (K, M) operand as M-major boxes through the
//     transpose bit for A, with no transposing stage. A (M, K) with rows off
//     16 bytes (D and I: K = 12, 24-byte rows, which TMA refuses) is copied
//     as the block's flat slab of 64 rows (1536 contiguous 16-byte-aligned
//     bytes) by one bulk copy on the same mbarrier, and each thread builds
//     its A fragment from it with 32-bit shared loads for a register-A
//     wgmma. K tails and ragged M or N are zero filled by the boxes (never
//     read past) or masked. K > 64 streams through a ring of two stages.
//  3. mini chain (M): chain_kernel, one block per (grid index i, 8 columns).
//     Stage one takes the nine K = 3 taps of the hidden map on CUDA cores in
//     f32, each tap a product sum over the 3 channels and the taps summed in
//     the reference's (di, dj) order, then ReLU and one rounding to bf16 after
//     the full sum. As in the reference, every dj of a row tap contracts the
//     same rows: the probe has no column shift. Stage two is three row-tap
//     products h[di + r] . wgb[di] (K = 128) on mma.sync with f32 sums. The
//     three 128 x 128 wgb slabs (104 KB padded) are copied with cp.async while
//     stage one runs; only the 10 hidden rows the output needs are computed.
//  4. tap products (mmonly, taps9bf16): taps_kernel, an implicit GEMM over
//     the zero-padded int8 input (B, H+2, W+2, Cin) on the tile loop that
//     the int8 conv runs (conv3x3_tile.cuh), with an input stage that copies
//     the padded int8 tile. mmonly multiplies the centre tap [1:1+th, 1:1+w]
//     by all nine weight taps on s8 mma.sync m16n8k32 with int32 sums (the
//     int8 product rate with no relayout at all); taps9bf16 takes the nine
//     shifted taps as bf16 operands on m16n8k16 with f32 sums, the input
//     tile and each weight slice converted to bf16 (exact for int8 values)
//     as they are staged into shared memory. Both dequantize acc * scale[c]
//     + bias[c] (uncontracted) and store bf16. Bound: mmonly's function is
//     one product with the summed weights, so bytes; taps9bf16 computes the
//     int8 conv, so operations at the int8 peak.

#include <string.h>

#include "conv3x3_tile.cuh"
#include "tma.cuh"

namespace {

// ------------------------------------------------------------ 1. movement

constexpr int GT = 128;  // threads a gather block
constexpr int GU = 4;    // units a thread a pass, all loaded before the first store
constexpr int G_BLOCKS_PER_SM = 4;
constexpr uint32_t MAX_CHANNELS = 4 * GT;  // channel scales held in shared memory

enum GatherMode { kElem = 0, kVec = 1, kShift = 2 };
enum Affine { kCopy = 0, kScale = 1, kScaleAdd = 2, kChanScaleAdd = 3 };

// A collapsed map (ops/probes.py::gather_plan). Unit u of the output (one
// element in kElem, 16 bytes otherwise; the output is contiguous) reads the
// input from base + sum_k i_k s[k], where i_k are u's digits over the dims d
// (outermost first, the last in units); u / d[k] = (u * mul[k]) >> shr[k]
// for every u < 2^31.
struct GatherArgs {
  uint32_t d[4], mul[4], shr[4], s[4];
  uint32_t base;      // input offset of unit 0; kShift: aligned down by off
  uint32_t off;       // kShift: elements past 16-byte alignment of every unit's source
  uint32_t units;     // units in all, < 2^31
  uint32_t channels;  // kChanScaleAdd: scales, one an element of the last dim
  const float* chan;
  float a, b;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Unit u's input offset, and its index along the last dim.
template <int R>
__device__ __forceinline__ uint32_t unit_source(uint32_t u, const GatherArgs& g, uint32_t& last) {
  uint32_t src = g.base, rest = u;
#pragma unroll
  for (int k = R - 1; k >= 1; --k) {
    const uint32_t q = (uint32_t)(((unsigned long long)rest * g.mul[k]) >> g.shr[k]);
    const uint32_t i = rest - q * g.d[k];
    if (k == R - 1) last = i;
    src += i * g.s[k];
    rest = q;
  }
  if (R == 1) last = rest;
  return src + rest * g.s[0];
}

// The 16 bytes that start sh bytes (0 < sh < 16) into the 32 bytes lo:hi.
__device__ __forceinline__ uint4 funnel16(uint4 lo, uint4 hi, uint32_t sh) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const uint32_t k = sh / 4, r = 8 * (sh % 4);
  uint32_t o[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    o[i] = k == 0 ? w[i] : k == 1 ? w[i + 1] : k == 2 ? w[i + 2] : w[i + 3];
  return make_uint4(__funnelshift_r(o[0], o[1], r), __funnelshift_r(o[1], o[2], r),
                    __funnelshift_r(o[2], o[3], r), __funnelshift_r(o[3], o[4], r));
}

// A thread moves GU units a pass, u0 + j GT, and issues every load of a
// pass before its first store. kChanScaleAdd: the channel scales are loaded
// into registers before the first pass's loads and stored into shared
// memory after them, so the two wait together.
template <typename T, int R, int MODE, int AFF>
__global__ void __launch_bounds__(GT)
gather32_kernel(const T* __restrict__ x, T* __restrict__ y, const GatherArgs g) {
  constexpr int U = MODE == kElem ? 1 : 16 / (int)sizeof(T);  // elements a unit
  constexpr int CPT = MAX_CHANNELS / GT;                       // channel scales a thread
  __shared__ float chan_s[AFF == kChanScaleAdd ? MAX_CHANNELS : 1];
  float cr[CPT];
  if constexpr (AFF == kChanScaleAdd) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const uint32_t c = threadIdx.x + i * GT;
      cr[i] = c < g.channels ? __ldg(g.chan + c) : 0.f;
    }
  }
  __align__(16) T v[GU][U];
  uint4 hi[GU];
  uint32_t last[GU];
  auto load = [&](uint32_t u0) {
#pragma unroll
    for (int j = 0; j < GU; ++j) {
      const uint32_t u = u0 + j * GT;
      if (u >= g.units) continue;
      const uint32_t src = unit_source<R>(u, g, last[j]);
      if constexpr (MODE == kElem) {
        v[j][0] = x[src];
      } else {
        *reinterpret_cast<uint4*>(v[j]) = __ldg(reinterpret_cast<const uint4*>(x + src));
        if constexpr (MODE == kShift) hi[j] = __ldg(reinterpret_cast<const uint4*>(x + src + U));
      }
    }
  };
  auto store = [&](uint32_t u0) {
#pragma unroll
    for (int j = 0; j < GU; ++j) {
      const uint32_t u = u0 + j * GT;
      if (u >= g.units) continue;
      if constexpr (MODE == kShift)
        *reinterpret_cast<uint4*>(v[j]) =
            funnel16(*reinterpret_cast<const uint4*>(v[j]), hi[j], g.off * (uint32_t)sizeof(T));
      if constexpr (AFF != kCopy) {
#pragma unroll
        for (int e = 0; e < U; ++e) {
          const float a = AFF == kChanScaleAdd ? chan_s[last[j] * U + e] : g.a;
          float f = __fmul_rn(to_f(v[j][e]), a);
          if (AFF != kScale) f = __fadd_rn(f, g.b);
          v[j][e] = from_f<T>(f);
        }
      }
      T* dst = y + (size_t)u * U;
      if constexpr (MODE == kElem)
        *dst = v[j][0];
      else
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v[j]);
    }
  };
  const uint32_t step = gridDim.x * GT * GU;
  uint32_t u0 = blockIdx.x * GT * GU + threadIdx.x;
  load(u0);
  if constexpr (AFF == kChanScaleAdd) {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      if (threadIdx.x + i * GT < g.channels) chan_s[threadIdx.x + i * GT] = cr[i];
    __syncthreads();
  }
  while (u0 < g.units) {
    store(u0);
    u0 += step;
    if (u0 < g.units) load(u0);
  }
}

struct GatherLaunch {
  const void* x;
  void* y;
  GatherArgs g;
  unsigned blocks;
  cudaStream_t stream;
};

template <typename T, int R, int MODE, int AFF>
cudaError_t launch_gather(const GatherLaunch& l) {
  gather32_kernel<T, R, MODE, AFF><<<l.blocks, GT, 0, l.stream>>>(
      static_cast<const T*>(l.x), static_cast<T*>(l.y), l.g);
  return cudaGetLastError();
}
template <typename T, int R, int MODE>
cudaError_t gather_affine(const GatherLaunch& l, int affine) {
  switch (affine) {
    case kCopy: return launch_gather<T, R, MODE, kCopy>(l);
    case kScale: return launch_gather<T, R, MODE, kScale>(l);
    case kScaleAdd: return launch_gather<T, R, MODE, kScaleAdd>(l);
    default: return launch_gather<T, R, MODE, kChanScaleAdd>(l);
  }
}
template <typename T, int R>
cudaError_t gather_mode(const GatherLaunch& l, int mode, int affine) {
  switch (mode) {
    case kElem: return gather_affine<T, R, kElem>(l, affine);
    case kVec: return gather_affine<T, R, kVec>(l, affine);
    default: return gather_affine<T, R, kShift>(l, affine);
  }
}
template <typename T>
cudaError_t gather_rank(const GatherLaunch& l, int rank, int mode, int affine) {
  switch (rank) {
    case 1: return gather_mode<T, 1>(l, mode, affine);
    case 2: return gather_mode<T, 2>(l, mode, affine);
    case 3: return gather_mode<T, 3>(l, mode, affine);
    default: return gather_mode<T, 4>(l, mode, affine);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

constexpr int TT = 32;  // transpose tile

// y (C, R) = x (R, C)^T, bf16.
__global__ void transpose_kernel(const __nv_bfloat16* __restrict__ x,
                                 __nv_bfloat16* __restrict__ y, int R, int C) {
  __shared__ float tile[TT][TT + 1];
  const int c = blockIdx.x * TT + threadIdx.x;
  const int r0 = blockIdx.y * TT;
  for (int j = threadIdx.y; j < TT; j += blockDim.y) {
    const int r = r0 + j;
    if (r < R && c < C) tile[j][threadIdx.x] = __bfloat162float(x[(size_t)r * C + c]);
  }
  __syncthreads();
  const int r = r0 + threadIdx.x;
  const int c0 = blockIdx.x * TT;
  for (int j = threadIdx.y; j < TT; j += blockDim.y) {
    const int cc = c0 + j;
    if (cc < C && r < R) y[(size_t)cc * R + r] = __float2bfloat16_rn(tile[threadIdx.x][j]);
  }
}

// ---------------------------------------------------------- 2. contraction

constexpr int GM = 64, GN = 64;     // block tile: wgmma's 64 rows (one warpgroup) x 64 columns
constexpr int GKS = 64;             // K a stage at most: one 128-byte row of bf16
constexpr int G_THREADS = 128;      // one warpgroup
constexpr int G_BOX = 64 * 128;     // a 128-byte-swizzled box of 64 rows (8 KB)
constexpr int G_STAGE = 2 * G_BOX;  // a stage: A's box, then B's
constexpr int G_PITCH = GN + 4;     // floats a staged output row (272 bytes)
constexpr int G_FLAT_MAX_K = 256;   // a flat A slab: 64 rows of at most 512 bytes

// How A reaches shared memory (ops/probes.py::gemm_plan): TMA boxes of
// (M, K) K-major, of (K, M) M-major (A transposed), or the flat slab.
enum GemmRoute { kATma = 0, kATmaT = 1, kAFlat = 2 };

struct GemmArgs {
  int M, N, K;
  int bk;          // K a stage: K rounded up to 16, at most GKS
  int nchunks;     // stages of K to run, ceil(K / bk)
  int flat_bytes;  // room of a flat slab (64 rows of K, 16-byte multiple); else 0
};

__host__ __device__ constexpr int gemm_stages(int nchunks) { return nchunks > 1 ? 2 : 1; }

size_t gemm_smem(const GemmArgs& g) {
  return 1024 + (size_t)gemm_stages(g.nchunks) * G_STAGE + g.flat_bytes +
         (size_t)GM * G_PITCH * sizeof(float) + 2 * sizeof(uint64_t);
}

// MN-major 128-byte-swizzle descriptor: rows of 64 bf16 along M or N, one
// k a row, 8-row groups 1024 bytes apart (stride byte offset); a 64-wide
// tile is one atom wide (leading byte offset G_BOX, unused).
__device__ __forceinline__ uint64_t gemm_desc_mn(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(G_BOX >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

#define GEMM_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define GEMM_OUT32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D(64x64, f32) += A(64x16 bf16) * B(16x64 bf16), both from shared memory;
// TA / TB: 1 for an MN-major operand (wgmma's transpose bit), 0 K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GEMM_OUT32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : GEMM_D8(0), GEMM_D8(8), GEMM_D8(16), GEMM_D8(24)
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB));
}

// The same with A from registers (this warp's 16 rows as for mma.sync
// m16n8k16).
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GEMM_OUT32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : GEMM_D8(0), GEMM_D8(8), GEMM_D8(16), GEMM_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TB));
}
#undef GEMM_D8
#undef GEMM_OUT32

// Two consecutive k (k even) of row r of a flat slab (rows of K bf16,
// `rows` of them loaded) as one 32-bit fragment register; zero past K and
// past the loaded rows.
__device__ __forceinline__ uint32_t flat_pair(const __nv_bfloat16* f, int r, int k, int rows,
                                              int K) {
  if (r >= rows || k >= K) return 0u;
  const __nv_bfloat16* p = f + r * K + k;
  if (K % 2 == 0) return *reinterpret_cast<const uint32_t*>(p);  // k + 1 < K, 4-byte aligned
  const uint32_t lo = __bfloat16_as_ushort(p[0]);
  return k + 1 < K ? lo | ((uint32_t)__bfloat16_as_ushort(p[1]) << 16) : lo;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// out (M, N) = A . B for one 64 x 64 tile a block. Thread 0 issues every
// copy of the block's first one or two stages before anyone waits: A's box
// (or, kAFlat, the block's slab of A, which holds all of K) and B's box on
// the stage's mbarrier. Then each stage's ceil(k / 16) products, one
// commit, one wait; a stage is refilled (K > 2 * bk) after a block barrier.
// A = (M, K) row-major, or (K, M) for kATmaT; B = (K, N) row-major.
template <int ROUTE, bool OUT_BF16>
__global__ void __launch_bounds__(G_THREADS)
gemm_wgmma(const __nv_bfloat16* __restrict__ A, void* __restrict__ out, const GemmArgs g,
           const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nst = gemm_stages(g.nchunks);
  __nv_bfloat16* flat = reinterpret_cast<__nv_bfloat16*>(smem + nst * G_STAGE);
  float* staged = reinterpret_cast<float*>(smem + nst * G_STAGE + g.flat_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + GM * G_PITCH);
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = min(GM, g.M - m0);
  // kAFlat: the slab's 16-byte pieces come by one bulk copy, its last
  // bytes (under 16, a ragged M's) from threads
  const uint32_t slab = 2u * rows * g.K, slab_bulk = slab & ~15u;

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) mbar_init(&full[s], 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  auto load = [&](int c) {  // thread 0: chunk c's copies into stage c % 2
    unsigned char* st = smem + (c % 2) * G_STAGE;
    uint64_t* bar = &full[c % 2];
    const uint32_t b_bytes = 128u * g.bk;
    uint32_t bytes = b_bytes;
    if (ROUTE == kATma) bytes += G_BOX;
    if (ROUTE == kATmaT) bytes += b_bytes;
    if (ROUTE == kAFlat && c == 0) bytes += slab_bulk;
    mbar_arrive_expect_tx(bar, bytes);
    if constexpr (ROUTE == kATma) tma_load_3d(st, &amap, c * g.bk, m0, 0, bar);
    if constexpr (ROUTE == kATmaT) tma_load_3d(st, &amap, m0, c * g.bk, 0, bar);
    if constexpr (ROUTE == kAFlat)
      if (c == 0 && slab_bulk) bulk_copy(flat, A + (size_t)m0 * g.K, slab_bulk, bar);
    tma_load_3d(st + G_BOX, &bmap, n0, c * g.bk, 0, bar);
  };
  if (tid == 0) {
    load(0);
    if (g.nchunks > 1) load(1);
  }
  if constexpr (ROUTE == kAFlat) {
    const uint32_t tail = (slab - slab_bulk) / 2, at = slab_bulk / 2;
    if ((uint32_t)tid < tail) flat[at + tid] = A[(size_t)m0 * g.K + at + tid];
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const int g8 = lane / 4, t4 = lane % 4, r0 = 16 * warp + g8;
  for (int c = 0; c < g.nchunks; ++c) {
    const unsigned char* st = smem + (c % 2) * G_STAGE;
    const int ksteps = (min(g.bk, g.K - c * g.bk) + 15) / 16;
    mbar_wait(&full[c % 2], (c / 2) & 1);
    uint32_t af[GKS / 16][4];
    if constexpr (ROUTE == kAFlat) {
      if (c == 0) __syncthreads();  // the slab's tail, stored by threads
#pragma unroll
      for (int s = 0; s < GKS / 16; ++s) {
        const int k = c * g.bk + 16 * s + 2 * t4;
        af[s][0] = flat_pair(flat, r0, k, rows, g.K);
        af[s][1] = flat_pair(flat, r0 + 8, k, rows, g.K);
        af[s][2] = flat_pair(flat, r0, k + 8, rows, g.K);
        af[s][3] = flat_pair(flat, r0 + 8, k + 8, rows, g.K);
      }
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < GKS / 16; ++s) {
      if (s < ksteps) {
        const uint64_t bd = gemm_desc_mn(st + G_BOX + s * 2048);
        if constexpr (ROUTE == kATma)
          wgmma_m64n64k16_ss<0, 1>(acc, wgmma_desc_sw128(st) + 2 * s, bd);
        else if constexpr (ROUTE == kATmaT)
          wgmma_m64n64k16_ss<1, 1>(acc, gemm_desc_mn(st + s * 2048), bd);
        else
          wgmma_m64n64k16_rs<1>(acc, af[s], bd);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (ROUTE == kAFlat)
#pragma unroll
      for (int s = 0; s < GKS / 16; ++s) fence_regs(af[s]);
    if (c + 2 < g.nchunks) {
      __syncthreads();  // every warp is done with stage c % 2
      if (tid == 0) load(c + 2);
    }
  }

  // sum i of this thread: row 16 warp + g + 8 ((i / 2) % 2), column
  // 8 (i / 4) + 2t + i % 2
#pragma unroll
  for (int j = 0; j < GN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(staged + (r0 + 8 * h) * G_PITCH + 8 * j + 2 * t4) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncthreads();
  // 16-byte pieces, consecutive threads along a row; N is a multiple of 8,
  // so a piece is all inside the output or all outside
  if constexpr (OUT_BF16) {
    auto* o = static_cast<__nv_bfloat16*>(out);
#pragma unroll
    for (int i = 0; i < GM * GN / 8 / G_THREADS; ++i) {
      const int p = tid + G_THREADS * i, r = p / (GN / 8), col = 8 * (p % (GN / 8));
      if (m0 + r >= g.M || n0 + col >= g.N) continue;
      const float4 lo = *reinterpret_cast<const float4*>(staged + r * G_PITCH + col);
      const float4 hi = *reinterpret_cast<const float4*>(staged + r * G_PITCH + col + 4);
      *reinterpret_cast<uint4*>(o + (size_t)(m0 + r) * g.N + n0 + col) =
          make_uint4(bf16x2_bits(lo.x, lo.y), bf16x2_bits(lo.z, lo.w), bf16x2_bits(hi.x, hi.y),
                     bf16x2_bits(hi.z, hi.w));
    }
  } else {
    auto* o = static_cast<float*>(out);
#pragma unroll
    for (int i = 0; i < GM * GN / 4 / G_THREADS; ++i) {
      const int p = tid + G_THREADS * i, r = p / (GN / 4), col = 4 * (p % (GN / 4));
      if (m0 + r >= g.M || n0 + col >= g.N) continue;
      *reinterpret_cast<float4*>(o + (size_t)(m0 + r) * g.N + n0 + col) =
          *reinterpret_cast<const float4*>(staged + r * G_PITCH + col);
    }
  }
}

template <int ROUTE, bool OUT_BF16>
cudaError_t launch_gemm_route(const __nv_bfloat16* A, void* out, const GemmArgs& g,
                              const CUtensorMap& amap, const CUtensorMap& bmap,
                              cudaStream_t stream) {
  const size_t smem = gemm_smem(g);
  const auto kernel = gemm_wgmma<ROUTE, OUT_BF16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.N + GN - 1) / GN, (g.M + GM - 1) / GM);
  kernel<<<grid, G_THREADS, smem, stream>>>(A, out, g, amap, bmap);
  return cudaGetLastError();
}

template <bool OUT_BF16>
cudaError_t launch_gemm(int route, const __nv_bfloat16* A, void* out, const GemmArgs& g,
                        const CUtensorMap& amap, const CUtensorMap& bmap, cudaStream_t stream) {
  if (route == kATma) return launch_gemm_route<kATma, OUT_BF16>(A, out, g, amap, bmap, stream);
  if (route == kATmaT) return launch_gemm_route<kATmaT, OUT_BF16>(A, out, g, amap, bmap, stream);
  return launch_gemm_route<kAFlat, OUT_BF16>(A, out, g, amap, bmap, stream);
}

// A 3-d bf16 tensor map over a row-major (rows, cols) matrix (the third
// dim 1), boxes of (box_cols, box_rows), 128-byte swizzle.
bool matrix_map(CUtensorMap* map, const void* base, int rows, int cols, int box_cols,
                int box_rows) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, 1};
  const uint64_t strides[2] = {2ull * cols, 2ull * cols * rows};
  const uint32_t box[3] = {(uint32_t)box_cols, (uint32_t)box_rows, 1};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 3, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// ----------------------------------------------------------- 3. mini chain

constexpr int MCS = 3, MTH = 8, MNH = 128, MC2 = 128;  // the probe's widths
constexpr int MTW = 8;                  // pixel columns a block
constexpr int MHR = MTH + 2;            // hidden rows the output needs
constexpr int MSR = MHR + 2;            // segmap rows they need
constexpr int MHS = MNH + 8;            // 272-byte rows of h and wgb: conflict-free ldmatrix
constexpr size_t CHAIN_SMEM = (size_t)3 * MNH * MHS * 2 + (size_t)MHR * MTW * MHS * 2 +
                              (size_t)MCS * MSR * MTW * 4 + (size_t)9 * MCS * MNH * 4;

// s (CS, rows, W2), wsh (9, CS, NH), wgb (3, NH, C2) bf16 -> out (G, TH, W2, C2) f32.
__global__ void __launch_bounds__(128)
chain_kernel(const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ wsh,
             const __nv_bfloat16* __restrict__ wgb, float* __restrict__ out, int rows, int W2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wgb_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [3][NH][MHS]
  __nv_bfloat16* h_s = wgb_s + 3 * MNH * MHS;                       // [MHR * MTW][MHS]
  float* seg_s = reinterpret_cast<float*>(h_s + MHR * MTW * MHS);    // [CS][MSR][MTW]
  float* wsh_s = seg_s + MCS * MSR * MTW;                            // [9][CS][NH]
  const int w0 = blockIdx.x * MTW, i = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  for (int j = tid; j < 3 * MNH * (MC2 / 8); j += blockDim.x) {  // 16-byte pieces
    const int row = j / (MC2 / 8), piece = j % (MC2 / 8);
    cp_async16(wgb_s + row * MHS + 8 * piece, wgb + (size_t)row * MC2 + 8 * piece);
  }
  cp_async_commit();
  for (int j = tid; j < MCS * MSR * MTW; j += blockDim.x) {
    const int c = j / (MSR * MTW), r = (j / MTW) % MSR, w = j % MTW;
    seg_s[j] = __bfloat162float(s[((size_t)c * rows + MTH * i + r) * W2 + w0 + w]);
  }
  for (int j = tid; j < 9 * MCS * MNH; j += blockDim.x) wsh_s[j] = __bfloat162float(wsh[j]);
  __syncthreads();

  // stage one: h[hr, w, n] = relu(sum_di sum_dj sum_c seg[c, di + hr, w] wsh[3di+dj, c, n])
  for (int j = tid; j < MHR * MTW * MNH; j += blockDim.x) {
    const int p = j / MNH, n = j % MNH, hr = p / MTW, w = p % MTW;
    float h = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const float s0 = seg_s[(0 * MSR + di + hr) * MTW + w];
      const float s1 = seg_s[(1 * MSR + di + hr) * MTW + w];
      const float s2 = seg_s[(2 * MSR + di + hr) * MTW + w];
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const float* wt = wsh_s + (3 * di + dj) * MCS * MNH + n;
        const float tap = __fadd_rn(__fadd_rn(__fmul_rn(s0, wt[0]), __fmul_rn(s1, wt[MNH])),
                                    __fmul_rn(s2, wt[2 * MNH]));
        h = (di == 0 && dj == 0) ? tap : __fadd_rn(h, tap);
      }
    }
    h_s[p * MHS + n] = __float2bfloat16_rn(fmaxf(h, 0.f));
  }
  cp_async_wait<0>();
  __syncthreads();

  // stage two: warp w owns output pixels 16w .. 16w + 15 (rows 2w, 2w + 1 of
  // the tile); tap di reads hidden pixels 8 di further on
  const int l_row = lane % 16, l_col = 8 * (lane / 16);
  float acc[MC2 / 8][4];
#pragma unroll
  for (int nt = 0; nt < MC2 / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int di = 0; di < 3; ++di) {
    const __nv_bfloat16* wd = wgb_s + di * MNH * MHS;
#pragma unroll 2
    for (int ks = 0; ks < MNH / 16; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, h_s + (16 * warp + MTW * di + l_row) * MHS + 16 * ks + l_col);
#pragma unroll
      for (int np = 0; np < MC2 / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, wd + (16 * ks + l_row) * MHS + 16 * np + l_col);
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }
  // element e of n-tile nt: tile row 2*warp + e/2, column g, channel 8nt + 2t + e%2
#pragma unroll
  for (int nt = 0; nt < MC2 / 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 2 * warp + half;
      store2(out + (((size_t)i * MTH + r) * W2 + w0 + g) * MC2 + 8 * nt + 2 * t,
             acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
}

// --------------------------------------------------------- 4. tap products

// The input stage: the chunk's tile of the zero-padded int8 input (padded
// row r0 + p is image row r0 - 1 + p), as E; zero past a ragged edge.
template <typename E>
struct PaddedInput {
  const int8_t* __restrict__ xp;
  int Hp, Wp, Cin;

  __device__ __forceinline__ void operator()(unsigned char* a_s, int b, int r0, int c0,
                                             int ci0) const {
    using namespace conv_tile;
    for (int i = threadIdx.x; i < NPOS * (KC / 16); i += NTHREADS) {
      const int pos = i / (KC / 16), piece = i % (KC / 16);
      const int r = r0 + pos / WT, c = c0 + pos % WT;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (r < Hp && c < Wp)
        raw = *reinterpret_cast<const uint4*>(xp + (((size_t)b * Hp + r) * Wp + c) * Cin + ci0 +
                                              16 * piece);
      unsigned char* row = a_s + pos * Operand<E>::RS;
      if constexpr (Operand<E>::kInt8)
        *reinterpret_cast<uint4*>(row + 16 * piece) = raw;
      else
        store_s8x16_as_bf16(row + 32 * piece, raw);
    }
  }
};

struct ChannelAffine {
  const float* __restrict__ scale;
  const float* __restrict__ bias;

  __device__ __forceinline__ float2 operator()(int co) const {
    return make_float2(scale[co], bias[co]);
  }
};

// xp: (B, H+2, W+2, Cin) int8, zero halo. wq: (9, Cout, Cin) int8, tap =
// 3*dy + dx. scale, bias: (Cout,) f32. y: (B, H, W, Cout) bf16. E = int8_t:
// mmonly (the centre tap for all nine weight taps); E = bf16: taps9bf16.
template <typename E, int TN>
__global__ void __launch_bounds__(conv_tile::NTHREADS)
taps_kernel(const int8_t* __restrict__ xp, const int8_t* __restrict__ wq,
            const float* __restrict__ scale, const float* __restrict__ bias,
            __nv_bfloat16* __restrict__ y, int H, int W, int Cin, int Cout) {
  conv_tile::conv3x3_tile<E, TN, conv_tile::Operand<E>::kInt8>(
      wq, y, H, W, Cin, Cout, PaddedInput<E>{xp, H + 2, W + 2, Cin}, ChannelAffine{scale, bias});
}

template <typename E, int TN>
cudaError_t launch_taps(const int8_t* xp, const int8_t* wq, const float* scale,
                        const float* bias, __nv_bfloat16* y, int B, int H, int W, int Cin,
                        int Cout, cudaStream_t stream) {
  using namespace conv_tile;
  constexpr size_t smem = smem_bytes<E, TN>();
  cudaError_t err = cudaFuncSetAttribute(taps_kernel<E, TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), Cout / TN, B);
  taps_kernel<E, TN><<<grid, NTHREADS, smem, stream>>>(xp, wq, scale, bias, y, H, W, Cin, Cout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns a cudaError_t (0 on success).

// Family 1, gather: y (contiguous) from x through the collapsed map `plan`
// (23 words, ops/probes.py::gather_plan: rank, mode, affine, base, off,
// units, channels, then dims, multipliers, shifts and strides, 4 each).
// chan: the channel scales (kChanScaleAdd), else null.
int probe_gather(int is_bf16, const void* x, void* y, const uint32_t* plan, const void* chan,
                 float a, float b, void* stream) {
  const int rank = (int)plan[0], mode = (int)plan[1], affine = (int)plan[2];
  GatherArgs g;
  g.base = plan[3];
  g.off = plan[4];
  g.units = plan[5];
  g.channels = plan[6];
  for (int k = 0; k < 4; ++k) {
    g.d[k] = plan[7 + k];
    g.mul[k] = plan[11 + k];
    g.shr[k] = plan[15 + k];
    g.s[k] = plan[19 + k];
  }
  g.chan = static_cast<const float*>(chan);
  g.a = a;
  g.b = b;
  const uint32_t unit = mode == kElem ? 1u : (is_bf16 ? 8u : 4u);
  const bool has_chan = affine == kChanScaleAdd;
  if (rank < 1 || rank > 4 || mode < kElem || mode > kShift || affine < kCopy ||
      affine > kChanScaleAdd || g.units < 1 || g.units >= (1u << 31) ||
      has_chan != (chan != nullptr) ||
      (has_chan && (g.channels < 1 || g.channels > MAX_CHANNELS)) ||
      (mode == kShift) != (g.off != 0) || g.off >= unit ||
      (mode != kElem && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15)))
    return (int)cudaErrorInvalidValue;
  const unsigned per_block = GT * GU;
  const unsigned need = (g.units + per_block - 1) / per_block;
  const unsigned cap = (unsigned)(G_BLOCKS_PER_SM * sm_count());
  const GatherLaunch l = {x, y, g, need < cap ? need : cap, static_cast<cudaStream_t>(stream)};
  return (int)(is_bf16 ? gather_rank<__nv_bfloat16>(l, rank, mode, affine)
                       : gather_rank<float>(l, rank, mode, affine));
}

// Family 1, transpose: y (C, R) = x (R, C)^T, bf16.
int probe_transpose(const void* x, void* y, int R, int C, void* stream) {
  if (R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + TT - 1) / TT, (R + TT - 1) / TT);
  transpose_kernel<<<grid, dim3(TT, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), R, C);
  return (int)cudaGetLastError();
}

// Family 2: out (M, N) = A . B with B (K, N) and A (M, K), or (K, M) for
// route kATmaT; bf16 operands, f32 sums, out f32 or (out_bf16) bf16. The
// route is ops/probes.py::gemm_plan's: kATma needs K and kATmaT M a multiple
// of 8 (TMA's 16-byte row pitch), kAFlat K <= 256. N a multiple of 8, every
// pointer 16-byte aligned.
int probe_gemm(const void* a, const void* b, void* out, int M, int N, int K, int route,
               int out_bf16, void* stream) {
  if (M < 1 || K < 1 || N < 8 || N % 8 != 0 || (M + GM - 1) / GM > 65535 ||
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(out)) & 15) ||
      (route == kATma && K % 8 != 0) || (route == kATmaT && M % 8 != 0) ||
      (route == kAFlat && K > G_FLAT_MAX_K) || route < kATma || route > kAFlat)
    return (int)cudaErrorInvalidValue;
  GemmArgs g;
  g.M = M;
  g.N = N;
  g.K = K;
  g.bk = (K + 15) / 16 * 16 < GKS ? (K + 15) / 16 * 16 : GKS;
  g.nchunks = (K + g.bk - 1) / g.bk;
  g.flat_bytes = route == kAFlat ? (2 * GM * K + 15) / 16 * 16 : 0;
  CUtensorMap amap, bmap;
  memset(&amap, 0, sizeof(amap));
  const bool maps = matrix_map(&bmap, b, K, N, 64, g.bk) &&
                    (route == kAFlat || (route == kATma ? matrix_map(&amap, a, M, K, GKS, GM)
                                                        : matrix_map(&amap, a, K, M, 64, g.bk)));
  if (!maps) return (int)cudaErrorInvalidValue;
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(out_bf16 ? launch_gemm<true>(route, A, out, g, amap, bmap, st)
                        : launch_gemm<false>(route, A, out, g, amap, bmap, st));
}

// Family 3: s (3, rows, W2), wsh (9, 3, 128), wgb (3, 128, 128) bf16 ->
// out (G, 8, W2, 128) f32, rows >= 8 G + 4, W2 a multiple of 8.
int probe_chain(const void* s, const void* wsh, const void* wgb, void* out, int G, int rows,
                int W2, void* stream) {
  if (G < 1 || W2 < MTW || W2 % MTW != 0 || rows < MTH * G + MSR - MTH)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)CHAIN_SMEM);
  if (err != cudaSuccess) return (int)err;
  chain_kernel<<<dim3(W2 / MTW, G), 128, CHAIN_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(s), static_cast<const __nv_bfloat16*>(wsh),
      static_cast<const __nv_bfloat16*>(wgb), static_cast<float*>(out), rows, W2);
  return (int)cudaGetLastError();
}

// Family 4: xp (B, H+2, W+2, Cin) int8 with a zero halo, wq (9, Cout, Cin)
// int8, scale and bias (Cout,) f32 -> y (B, H, W, Cout) bf16. taps9bf16
// selects the nine shifted taps in bf16; else mmonly.
int probe_taps(int taps9bf16, const void* xp, const void* wq, const void* scale,
               const void* bias, void* y, int B, int H, int W, int Cin, int Cout, void* stream) {
  using conv_tile::KC;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || Cin < KC || Cin % KC != 0 || Cout < 64 ||
      Cout % 64 != 0 || Cout / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const int8_t*>(xp);
  const auto* w = static_cast<const int8_t*>(wq);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* out = static_cast<__nv_bfloat16*>(y);
  const bool wide = Cout % 128 == 0;
  cudaError_t err;
  if (taps9bf16)
    err = wide ? launch_taps<__nv_bfloat16, 128>(x, w, sc, bi, out, B, H, W, Cin, Cout, st)
               : launch_taps<__nv_bfloat16, 64>(x, w, sc, bi, out, B, H, W, Cin, Cout, st);
  else
    err = wide ? launch_taps<int8_t, 128>(x, w, sc, bi, out, B, H, W, Cin, Cout, st)
               : launch_taps<int8_t, 64>(x, w, sc, bi, out, B, H, W, Cin, Cout, st);
  return (int)err;
}

const char* probes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
