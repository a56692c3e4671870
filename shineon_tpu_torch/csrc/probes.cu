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
//     into shared memory once a block. The transposes (C, C2) move 16-byte
//     pieces too. Where R and C are multiples of 8 (C2: 128 x 4000),
//     transpose8_kernel gives each thread one 8 x 8 block: eight 16-byte
//     loads, the transpose in registers by byte permutes, eight 16-byte
//     stores, row groups fastest across a warp so that its stores fill
//     whole 256-byte output rows; no shared memory, no barrier. Where R is
//     12 (C: 12 x 4000, 24-byte output rows, which no 16-byte piece of a
//     row fits), transpose_cols_kernel gives each thread 8 columns of the
//     12 rows, whose output is one contiguous 192-byte run: 12 16-byte
//     loads and stores, the transpose by byte permutes. Any other R and C
//     (no probe's) take transpose_slab_kernel: a slab of up to 64 input
//     rows staged in shared memory an element at a time, masked at ragged
//     edges.
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
//  3. mini chain (M): chain_wgmma. What bounds it: the bytes of its f32
//     output (1.84 MB; the operations take two thirds of that time at the
//     bf16 peak), under a chain of copies, two stages and a store. Stage
//     one stays on CUDA cores: tensor cores sum the 27 products of a hidden
//     value in their own order, and where that sum lies at a bf16 rounding
//     boundary the hidden value flips by a bf16 step against the
//     reference's, which moves an output by up to 2^-8 of one of its 384
//     terms (measured 1.6e-3 of |ref| + rms, over probe M's 1e-3 limit). So
//     stage one takes the reference's f32 roundings one for one, 35
//     operations a value, and is what the kernel's time is made of. A block
//     owns a strip of 8 columns and 64 output channels (112 blocks of two
//     warpgroups): with no column shift, a strip needs the hidden map of its
//     own 8 columns only (10 rows, 80 positions), computed once a block
//     (the two channel halves of a strip each compute it: sharing it through
//     global memory or a cluster's shared memory measured slower than the
//     work it saves), and tap di's A is its hidden positions 8 di .. 8 di +
//     63, one descriptor at an 8-row boundary. Stage two: three taps of 8
//     wgmma m64n64k16, both operands by descriptor. The segmap strip, wsh and
//     wgb's slices come by TMA, all issued at once; the sums are staged and
//     stored in 16-byte pieces.
//  4. tap products (mmonly, taps9bf16), over the zero-padded int8 input xp
//     (B, H+2, W+2, Cin); both dequantize acc * scale[c] + bias[c]
//     (__fmul_rn, then __fadd_rn: never contracted) and store bf16. Blocks
//     are persistent (one an SM): two consumer warpgroups and a producer
//     warp, one lane of which issues every copy on full/empty mbarriers, so
//     one tile's epilogue and stores overlap the next tile's loads.
//     mmonly_wgmma: the TPU variant multiplies the centre tap xc = xp[1:1+H,
//     1:1+W] by each of the nine weight taps and sums them, which in int32
//     is exactly xc . S with S = sum_t wq[t] in [-1143, 1143]; S splits
//     exactly into S = 128 hi + lo, lo = ((S + 64) & 127) - 64 in [-64, 63]
//     and hi = (S - lo) / 128 in [-9, 9], both int8. So this kernel computes
//     the same function in two int8 products instead of nine: acc = xc . hi,
//     acc *= 128, acc += xc . lo, every partial sum within 127 (1152 + 64)
//     Cin < 2^31. Its bound is the bytes (most of them the bf16 output).
//     The hi and lo images of the block's NT output channels (128, or 64
//     where Cout is not a multiple of 128) stay resident in shared memory;
//     the producer copies each 128-pixel tile's centre tap (TW x TH pixels
//     at (1, 1) of xp, 128 channels a box, 128-byte swizzle) by TMA, half a
//     tile to each warpgroup's own ring of 2-4, so that the two drift apart
//     and one's epilogue runs beside the other's products; each warpgroup
//     runs s8 wgmma m64nNTk32 on its 64 pixels with A and B from shared
//     memory by descriptor (the centre tap has plain rows: no ldmatrix).
//     Cin at most 512 (the images and two tiles in flight must fit).
//     taps9_wgmma: the 3x3 conv with the int8 values as bf16 operands and
//     f32 sums (the int8 conv's function; int8 values are exact in bf16).
//     Within a band of at most 64 image columns, outputs are computed at
//     flat positions P = r WT + c of the band's padded width WT (the two
//     halo columns of each row computed and dropped), so that a tap's 64
//     consecutive outputs read 64 consecutive rows of the staged input:
//     both operands come from shared memory by descriptor (the 128-byte
//     swizzle follows the address bits, so a tap's descriptor may start at
//     any row), with no ldmatrix and no A fragments in registers. Each item
//     is 128 positions x NT channels (NT = 128, or 64 where Cout is not a
//     multiple of 128: under the 168 registers a thread that a copy warp
//     beside two warpgroups leaves, a warpgroup holds 64 x 128 f32 sums).
//     The producer copies each 64-channel chunk's int8 rows of xp with
//     their halo by one tensor-map copy (zero filled past the image), and
//     each tap's bf16 slice image (64 channels x NT, made once per weight
//     by ops/probes.py::tap_images) by a bulk copy into a ring of 6 (10 at
//     NT = 64); the consumers convert the rows to bf16 in shared memory once
//     a chunk, then run the nine taps on wgmma m64nNTk16 with up to three
//     taps in flight. Bound: the operations; the bf16 peak is half the int8
//     peak the bound states.

#include <string.h>

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

// ---- transposes (C, C2): y (C, R) = x (R, C)^T, bf16

constexpr int T8_THREADS = 64;    // transpose8_kernel: threads a block
constexpr int TC_THREADS = 32;    // transpose_cols_kernel: threads a block
constexpr int TC_R = 12;          // its rows (probe C's)
constexpr int TS_THREADS = 128;   // transpose_slab_kernel: threads a block
constexpr int TS_ROWS = 64;       // a slab's input rows at most
constexpr int TS_ELEMS = 3072;    // a slab's elements at most (6 KB)
constexpr int TS_MAX_COLS = 256;  // a slab's input columns at most

// probe_transpose's routes, as it reports them (ops/probes.py::TRANSPOSE_ROUTES)
enum TransposeRoute { kTiles = 0, kCols = 1, kSlab = 2 };

// Element k of each of the eight 8-element rows in[0..7] (one input row
// each) as out[k]: word w of out[k] packs rows 2w and 2w + 1.
__device__ __forceinline__ void transpose8x8(const uint4 (&in)[8], uint4 (&out)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t sel = k % 2 ? 0x7632u : 0x5410u;
    uint32_t w[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const uint32_t* lo = reinterpret_cast<const uint32_t*>(&in[2 * v]);
      const uint32_t* hi = reinterpret_cast<const uint32_t*>(&in[2 * v + 1]);
      w[v] = __byte_perm(lo[k / 2], hi[k / 2], sel);
    }
    out[k] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// R and C multiples of 8, x and y 16-byte aligned (C2): thread t moves the
// 8 x 8 block of row group t % (R / 8) and column group t / (R / 8): eight
// 16-byte loads, all issued before its first store, 32 byte permutes in
// registers, eight 16-byte stores. Row groups run fastest, so a warp's
// stores fill whole output rows and its loads whole 32-byte sectors.
__global__ void __launch_bounds__(T8_THREADS)
transpose8_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, int R,
                  int C) {
  const uint32_t rgs = (uint32_t)R / 8;
  const uint32_t t = blockIdx.x * T8_THREADS + threadIdx.x;
  if (t >= rgs * ((uint32_t)C / 8)) return;
  const uint32_t rg = t % rgs, cg = t / rgs;
  const __nv_bfloat16* src = x + (size_t)8 * rg * C + 8 * cg;
  uint4 in[8], out[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) in[i] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)i * C));
  transpose8x8(in, out);
  __nv_bfloat16* dst = y + (size_t)8 * cg * R + 8 * rg;
#pragma unroll
  for (int k = 0; k < 8; ++k) *reinterpret_cast<uint4*>(dst + (size_t)k * R) = out[k];
}

// R = 12, C a multiple of 8, x and y 16-byte aligned (C: 24-byte output
// rows): thread t moves columns 8 t .. 8 t + 7 of the 12 rows: 12 16-byte
// loads, all issued before its first store; its output is the contiguous
// run of 96 elements from output row 8 t (192 bytes, 16-byte aligned),
// whose word w packs rows r and r + 1 (r = 2 w % 12) of column 2 w / 12,
// taken from the loads by byte permutes; 12 16-byte stores.
__global__ void __launch_bounds__(TC_THREADS)
transpose_cols_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
                      int C) {
  const int t = blockIdx.x * TC_THREADS + threadIdx.x;
  if (t >= C / 8) return;
  uint4 in[TC_R];
#pragma unroll
  for (int r = 0; r < TC_R; ++r)
    in[r] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * C + 8 * t));
  uint4* dst = reinterpret_cast<uint4*>(y + (size_t)8 * t * TC_R);
#pragma unroll
  for (int j = 0; j < TC_R; ++j) {  // output piece j: words 4 j .. 4 j + 3
    uint32_t w[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int k = 2 * (4 * j + v), c = k / TC_R, r = k % TC_R;
      const uint32_t* lo = reinterpret_cast<const uint32_t*>(&in[r]);
      const uint32_t* hi = reinterpret_cast<const uint32_t*>(&in[r + 1]);
      w[v] = __byte_perm(lo[c / 2], hi[c / 2], c % 2 ? 0x7632u : 0x5410u);
    }
    dst[j] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The slab route's input columns a block at TR rows (mirrored by
// ops/probes.py::transpose_plan).
__host__ __device__ constexpr int slab_cols(int TR) {
  return TS_ELEMS / TR < TS_MAX_COLS ? TS_ELEMS / TR : TS_MAX_COLS;
}

// Any R and C: block b stages the slab of input rows r0 .. r0 + TR - 1
// (TR = min(R, 64)) and columns c0 .. c0 + TC - 1 (column slabs fastest)
// in shared memory an element at a time, columns fastest across threads,
// and writes element (r, c) to output (c0 + c, r0 + r), rows fastest
// across threads: where TR = R one contiguous run of tc R elements.
// Ragged slabs are masked.
__global__ void __launch_bounds__(TS_THREADS)
transpose_slab_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, int R,
                      int C) {
  __shared__ __nv_bfloat16 tile[TS_ELEMS + TS_ROWS];  // a row's pitch TC + 1
  const int TR = R < TS_ROWS ? R : TS_ROWS, TC = slab_cols(TR), TP = TC + 1;
  const uint32_t cblocks = ((uint32_t)C + TC - 1) / TC;
  const int c0 = (int)(blockIdx.x % cblocks) * TC, r0 = (int)(blockIdx.x / cblocks) * TR;
  const int tr = min(TR, R - r0), tc = min(TC, C - c0);  // this slab's rows and columns
  for (int e = threadIdx.x; e < tr * tc; e += TS_THREADS) {
    const int r = e / tc, c = e % tc;
    tile[r * TP + c] = x[(size_t)(r0 + r) * C + c0 + c];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < tr * tc; e += TS_THREADS) {
    const int c = e / tr, r = e % tr;
    y[(size_t)(c0 + c) * R + r0 + r] = tile[r * TP + c];
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

// The first 1024-byte boundary at or after p (the 128-byte swizzle's atom).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

constexpr int MCS = 3, MTH = 8, MNH = 128, MC2 = 128;  // the probe's widths
constexpr int MSR = MTH + 4;      // segmap rows a grid index reads: hidden rows 0..9, taps 0..2
constexpr int MHR = MTH + 2;      // hidden rows a grid index's output reads
constexpr int MK1 = 9 * MCS;      // stage one's products a hidden value: 9 taps x 3 channels
constexpr int MTW = 8;            // columns a strip: 8 x 8 = 64 output positions (wgmma's rows)
constexpr int MNT = 64;           // output channels a block: half of C2
constexpr int M_THREADS = 256;    // two warpgroups: both take stage one, the first stage two
constexpr int M_WGB_BOX = MNH * 128;       // wgb[di]'s 64 output channels, 128 k rows (16 KB)
constexpr int M_HCHUNK = MHR * MTW * 128;  // 64 hidden channels of a strip's 80 rows (10 KB)
constexpr int M_OPITCH = MNT + 4;          // floats a staged output row (272 bytes)
constexpr size_t M_H = 3 * M_WGB_BOX, M_OUT = M_H + 2 * M_HCHUNK,
                 M_SEGF = M_OUT + (size_t)MTH * MTW * M_OPITCH * 4,
                 M_SEG = M_SEGF + (size_t)MCS * MSR * MTW * 4,
                 M_WSH = M_SEG + 1024,  // the segmap strip (576 bytes), then 128-byte aligned
                 M_BARS = M_WSH + (size_t)MK1 * MNH * 2,
                 CHAIN_SMEM = M_BARS + 4 * sizeof(uint64_t) + 1024;
static_assert(MCS * MSR * MTW * 2 <= 1024 && M_SEG % 128 == 0, "the strip's room");

__device__ __forceinline__ float lane4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// out (G, 8, W2, 128) f32 from s (3, rows, W2), wsh (9, 3, 128) and wgb (3,
// 128, 128) bf16. Block (nh, a, i) computes grid index i's output rows 0..7
// at columns 8 a .. 8 a + 7 (64 positions, position 8 r + wl) and channels
// 64 nh .. 64 nh + 63. Its hidden map is the strip's rows hr = 0..9 (80
// positions, position 8 hr + wl), all 128 channels: h = bf16(relu(sum over
// taps t = 3 di + dj in order of ((s0 w0 + s1 w1) + s2 w2))), sc = s[c, 8 i
// + di + hr, 8 a + wl], wc = wsh[t, c]: the reference's f32 roundings one
// for one (every product of two bf16 values is exact in f32, so an FMA
// rounds as the separate add does; every dj reads the same rows: the probe
// has no column shift); thread t computes channel t % 128 of hidden rows
// 5 (t / 128) .. + 4, four positions at a time, into K-major
// 128-byte-swizzled rows. Stage two, the first warpgroup: position 8 r + wl
// is sum_di h[8 (r + di) + wl] . wgb[di], so tap di's A is the strip's
// hidden positions 8 di .. 8 di + 63: three taps of 8 wgmma m64n64k16, both
// operands by descriptor. By TMA, all issued at once: the segmap's 12 rows
// of the strip (smap: s as (3 rows, W2), boxes of 8 x 12 x 3) and wsh
// (wshmap: as (27, 128), one box) on one barrier, wgb's three 64-channel
// slices (wgbmap: wgb as (384, 128), boxes of 64 x 128, 128-byte swizzled,
// read MN-major through wgmma's transpose bit) on one barrier each.
__global__ void __launch_bounds__(M_THREADS, 1)
chain_wgmma(float* __restrict__ out, int W2, const __grid_constant__ CUtensorMap smap,
            const __grid_constant__ CUtensorMap wshmap,
            const __grid_constant__ CUtensorMap wgbmap) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* wgb_s = smem;      // [di][k 128][n 64]
  unsigned char* h_s = smem + M_H;  // [k half][row 80][k 64], K-major
  float* staged = reinterpret_cast<float*>(smem + M_OUT);
  float* segf = reinterpret_cast<float*>(smem + M_SEGF);                // [c][row 12][wl 8]
  __nv_bfloat16* seg = reinterpret_cast<__nv_bfloat16*>(smem + M_SEG);  // the same, as copied
  const __nv_bfloat16* wsh_s = reinterpret_cast<const __nv_bfloat16*>(smem + M_WSH);  // [k][n]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + M_BARS);  // segmap and wsh, wgb[di]
  const int nh = blockIdx.x, a = blockIdx.y, i = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;

  if (tid == 0) {
    for (int b = 0; b < 4; ++b) mbar_init(&bars[b], 1);
    fence_mbarrier_init();
    mbar_arrive_expect_tx(&bars[0], MCS * MSR * MTW * 2 + MK1 * MNH * 2);
    tma_load_3d(seg, &smap, MTW * a, MTH * i, 0, &bars[0]);
    tma_load_3d(smem + M_WSH, &wshmap, 0, 0, 0, &bars[0]);
    for (int di = 0; di < 3; ++di) {
      mbar_arrive_expect_tx(&bars[1 + di], M_WGB_BOX);
      tma_load_3d(wgb_s + di * M_WGB_BOX, &wgbmap, MNT * nh, MNH * di, 0, &bars[1 + di]);
    }
  }
  __syncthreads();  // the barriers' initialisation before any wait

  // stage one: thread t holds wsh[tap, c, t % 128] for every (tap, c), k = 3 tap + c
  const int n = tid % MNH, hr0 = (tid / MNH) * (MHR / 2);
  mbar_wait(&bars[0], 0);
  float wr[MK1];
#pragma unroll
  for (int k = 0; k < MK1; ++k) wr[k] = __bfloat162float(wsh_s[k * MNH + n]);
  for (int e = tid; e < MCS * MSR * MTW; e += M_THREADS) segf[e] = __bfloat162float(seg[e]);
  __syncthreads();
  // segf[(12 c + row) 8 + wl] = s[c, 8 i + row, 8 a + wl]: four positions of
  // a tap are one 16-byte load
  const float4* sp = reinterpret_cast<const float4*>(segf);
  unsigned char* hcol = h_s + (n / 64) * M_HCHUNK + 2 * (n % 8);
#pragma unroll
  for (int p4 = 0; p4 < MHR; ++p4) {
    const int hr = hr0 + p4 / 2, wl0 = 4 * (p4 % 2);
    float4 sv[3][MCS];
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int c = 0; c < MCS; ++c) sv[di][c] = sp[((c * MSR + di + hr) * MTW + wl0) / 4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float h = 0.f;
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        const float s0 = lane4(sv[di][0], j), s1 = lane4(sv[di][1], j), s2 = lane4(sv[di][2], j);
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) {
          const float* w = wr + 3 * (3 * di + dj);
          const float tap = __fmaf_rn(s2, w[2], __fmaf_rn(s1, w[1], __fmul_rn(s0, w[0])));
          h = di == 0 && dj == 0 ? tap : __fadd_rn(h, tap);
        }
      }
      const int row = MTW * hr + wl0 + j;
      *reinterpret_cast<__nv_bfloat16*>(hcol + row * 128 + ((((n % 64) / 8) ^ (row & 7)) << 4)) =
          __float2bfloat16_rn(fmaxf(h, 0.f));
    }
  }
  fence_proxy_async();  // h's generic stores before the products' reads
  __syncthreads();

  // stage two, the first warpgroup: tap di's A is h's rows 8 di .. 8 di + 63
  if (warp < 4) {
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    fence_regs(acc);
    for (int di = 0; di < 3; ++di) mbar_wait(&bars[1 + di], 0);
    wgmma_fence();
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int ks = 0; ks < MNH / 16; ++ks)
        wgmma_m64n64k16_ss<0, 1>(
            acc, wgmma_desc_sw128(h_s + (ks / 4) * M_HCHUNK + MTW * di * 128) + 2 * (ks % 4),
            gemm_desc_mn(wgb_s + di * M_WGB_BOX + ks * 2048));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    // sum e is position 16 warp + g + 8 ((e / 2) % 2), channel 8 (e / 4) + 2 t4 + e % 2
#pragma unroll
    for (int j = 0; j < MNT / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(staged + (16 * warp + g + 8 * hh) * M_OPITCH + 8 * j +
                                   2 * t4) = make_float2(acc[4 * j + 2 * hh],
                                                         acc[4 * j + 2 * hh + 1]);
  }
  __syncthreads();
  // the sums in 16-byte pieces: position 8 r + wl is output row r, column 8 a + wl
#pragma unroll
  for (int it = 0; it < MTH * MTW * MNT / 4 / M_THREADS; ++it) {
    const int p = tid + M_THREADS * it, pos = p / (MNT / 4), c = 4 * (p % (MNT / 4));
    float* o = out + (((size_t)i * MTH + pos / MTW) * W2 + MTW * a + pos % MTW) * MC2 + MNT * nh;
    *reinterpret_cast<float4*>(o + c) = *reinterpret_cast<const float4*>(staged + pos * M_OPITCH + c);
  }
}

// --------------------------------------------------------- 4. tap products

namespace taps {

constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and a producer warp
constexpr int M_T = 128;                 // pixels a tile: 64 a warpgroup
constexpr int MAX_SMEM = 232448;
constexpr int MM_KC = 128;           // mmonly: input channels a chunk (one 128-byte row)
constexpr int MM_BOX = 64 * MM_KC;   // mmonly: a chunk of a warpgroup's half tile (8 KB)
constexpr int T9_KC = 64;            // taps9bf16: input channels a chunk (one tap a slice)
constexpr int T9_TAPS = 9;

// A launch's geometry (plan_mmonly, plan_taps9).
struct TapArgs {
  int H, W, Cin, Cout;
  int nt;       // output channels a block (NT)
  int nblk;     // blocks of NT output channels
  int nchunks;  // input-channel chunks
  int TW, TH;   // mmonly: a tile is a box of TW x TH pixels; taps9bf16: bands TW wide
  int bands;    // column bands of TW
  int tiles;    // mmonly: tiles in all; taps9bf16: tiles a band
  int nrows;    // taps9bf16: input rows staged for a tile, halo included
  int items;    // taps9bf16: B x bands x tiles x nblk
  int stages;   // mmonly: half tiles in flight a warpgroup
};

#define TP_D8(C, i) \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define TP_D32(C, i) TP_D8(C, i), TP_D8(C, i + 8), TP_D8(C, i + 16), TP_D8(C, i + 24)
#define TP_S32(v) "+r"(v)
#define TP_F32(v) "+f"(v)
#define TP_OUT32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TP_OUT64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D(64 x N, s32) += A(64 x 32 s8) B(32 x N s8), both K-major in shared
// memory through 128-byte-swizzle descriptors; N = 64 or 128 (d holds N / 2
// sums a thread).
template <int N>
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " TP_OUT32 ", %32, %33, p;\n}\n"
        : TP_D32(TP_S32, 0)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " TP_OUT64 ", %64, %65, p;\n}\n"
        : TP_D32(TP_S32, 0), TP_D32(TP_S32, 32)
        : "l"(da), "l"(db), "r"(1));
  }
}

// D(64 x N, f32) += A(64 x 16 bf16) B(16 x N bf16), both K-major in shared
// memory through 128-byte-swizzle descriptors; N = 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TP_OUT32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : TP_D32(TP_F32, 0)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TP_OUT64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : TP_D32(TP_F32, 0), TP_D32(TP_F32, 32)
        : "l"(da), "l"(db), "r"(1));
  }
}
#undef TP_D8
#undef TP_D32
#undef TP_S32
#undef TP_F32
#undef TP_OUT32
#undef TP_OUT64

// ---- mmonly: two exact int8 products of the centre tap, streamed

// Shared memory, from the 1024-aligned base: the block's hi and lo images
// (resident), each warpgroup's ring of half tiles, the epilogue tile, the
// block's scales and biases, the barriers.
template <int NT>
struct MmLayout {
  static constexpr int OS = 2 * NT + 16;  // bytes an output row of the epilogue tile
  size_t stage, a, out, par, bars, total;
  __host__ __device__ explicit MmLayout(const TapArgs& g) {
    stage = (size_t)g.nchunks * MM_BOX;
    a = (size_t)2 * g.nchunks * NT * 128;
    out = a + 2 * g.stages * stage;
    par = out + (size_t)M_T * OS;
    bars = par + 2 * NT * sizeof(float);
    total = bars + (1 + 4 * g.stages) * sizeof(uint64_t) + 1024;
  }
};

// y = (xc . S) * scale + bias with xc the centre tap (B, H, W, Cin) of xp
// and S = hi * 128 + lo the summed weights: acc = xc . hi, acc *= 128, acc
// += xc . lo, all in int32. xmap: xp as (Cin, W+2, H+2, B), boxes of (128
// channels, TW, TH / 2, 1), 128-byte swizzle. hilo: (2, nchunks, Cout, 128)
// int8, part 0 hi, part 1 lo. Block j takes output channels (j % nblk) NT
// and every (gridDim.x / nblk)-th tile from j / nblk; warpgroup wg the
// tile's rows wg TH / 2 .. (wg + 1) TH / 2 - 1 (64 pixels), through a ring
// of its own, so that the two drift apart and one's epilogue runs beside
// the other's products.
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
mmonly_wgmma(const unsigned char* __restrict__ hilo, const float* __restrict__ scale,
             const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, const TapArgs a,
             const __grid_constant__ CUtensorMap xmap) {
  using L = MmLayout<NT>;
  constexpr int OS = L::OS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const L lay(a);
  const int nch = a.nchunks;
  unsigned char* w_s = smem;  // [hi, lo][chunk][NT][128]
  unsigned char* a_ring = smem + lay.a;
  unsigned char* out_s = smem + lay.out;
  float* sc_s = reinterpret_cast<float*>(smem + lay.par);
  float* bi_s = sc_s + NT;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* a_full = wbar + 1;             // [warpgroup][stage]
  uint64_t* a_empty = a_full + 2 * a.stages;
  const int nb = blockIdx.x % a.nblk, first = blockIdx.x / a.nblk, stride = gridDim.x / a.nblk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(wbar, 1);
    for (int i = 0; i < 2 * a.stages; ++i) {
      mbar_init(&a_full[i], 1);
      mbar_init(&a_empty[i], 4);
    }
    fence_mbarrier_init();
  }
  for (int i = tid; i < NT; i += THREADS) {
    sc_s[i] = scale[nb * NT + i];
    bi_s[i] = bias[nb * NT + i];
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // producer: one lane copies the block's weight images once, then each
    // tile's centre tap, one box a chunk and warpgroup
    if (lane != 0) return;
    mbar_arrive_expect_tx(wbar, (uint32_t)(2 * nch * NT * 128));
    for (int p = 0; p < 2 * nch; ++p)
      bulk_copy(w_s + (size_t)p * NT * 128, hilo + ((size_t)p * a.Cout + (size_t)nb * NT) * 128,
                NT * 128, wbar);
    int s = 0;
    for (int t = first; t < a.tiles; t += stride, ++s) {
      const int st = s % a.stages;
      const int band = t % a.bands, rt = (t / a.bands) % ((a.H + a.TH - 1) / a.TH);
      const int b = t / a.bands / ((a.H + a.TH - 1) / a.TH);
      for (int w = 0; w < 2; ++w) {
        const int k = w * a.stages + st;
        mbar_wait(&a_empty[k], ((s / a.stages) & 1) ^ 1);
        mbar_arrive_expect_tx(&a_full[k], (uint32_t)lay.stage);
        for (int c = 0; c < nch; ++c)
          tma_load_4d(a_ring + k * lay.stage + c * MM_BOX, &xmap, c * MM_KC, band * a.TW + 1,
                      rt * a.TH + w * a.TH / 2 + 1, b, &a_full[k]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile pixels 64 wg .. 64 wg + 63
  const int wg = warp / 4, q = warp % 4, g = lane / 4, t4 = lane % 4;
  const int last_ksteps = (a.Cin - (nch - 1) * MM_KC) / 32;  // 32-channel steps of the last chunk
  const int rtiles = (a.H + a.TH - 1) / a.TH, tw_shift = __ffs(a.TW) - 1;  // TW a power of 2
  mbar_wait(wbar, 0);
  int acc[NT / 2];
  int s = 0;
  for (int t = first; t < a.tiles; t += stride, ++s) {
    const int k = wg * a.stages + s % a.stages;
    const unsigned char* at = a_ring + k * lay.stage;
    mbar_wait(&a_full[k], (s / a.stages) & 1);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
    // part 0: acc = xc . hi; part 1: acc = 128 acc + xc . lo
    for (int part = 0; part < 2; ++part) {
      if (part == 1) {
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[i] *= 128;
      }
      fence_regs(acc);
      wgmma_fence();
      for (int c = 0; c < nch; ++c) {
        const int ks = c + 1 < nch ? 4 : last_ksteps;
        const uint64_t da = wgmma_desc_sw128(at + c * MM_BOX);
        const uint64_t db = wgmma_desc_sw128(w_s + ((size_t)part * nch + c) * NT * 128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < ks) wgmma_s8_ss<NT>(acc, da + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (lane == 0) mbar_arrive(&a_empty[k]);  // this warp is done with its half tile

    // epilogue: sum i is pixel 16q + g + 8 ((i / 2) % 2) of the warpgroup,
    // channel 8 (i / 4) + 2 t4 + i % 2; dequantized, staged, stored 16
    // bytes a thread while the next tile's products run
    const int band = t % a.bands, rt = (t / a.bands) % rtiles, b = t / a.bands / rtiles;
    const int row0 = 64 * wg + 16 * q + g;
    named_sync(1 + wg, 128);  // the warpgroup's previous stores are done with its rows
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float s0 = sc_s[col], s1 = sc_s[col + 1], b0 = bi_s[col], b1 = bi_s[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(out_s + (row0 + 8 * h) * OS + 2 * col) =
            __floats2bfloat162_rn(dequant(acc[4 * j + 2 * h], s0, b0),
                                  dequant(acc[4 * j + 2 * h + 1], s1, b1));
    }
    named_sync(1 + wg, 128);
    for (int i = tid % 128; i < 64 * (NT / 8); i += 128) {
      const int p = 64 * wg + i / (NT / 8), col = 8 * (i % (NT / 8));
      const int r = rt * a.TH + (p >> tw_shift), c = band * a.TW + (p & (a.TW - 1));
      if (r >= a.H || c >= a.W) continue;
      *reinterpret_cast<uint4*>(y + (((size_t)b * a.H + r) * a.W + c) * a.Cout + nb * NT + col) =
          *reinterpret_cast<const uint4*>(out_s + p * OS + 2 * col);
    }
  }
}

size_t mm_smem(int nt, const TapArgs& a) {
  return nt == 128 ? MmLayout<128>(a).total : MmLayout<64>(a).total;
}

// Tiles of TW x TH pixels (TW the smallest of 8, 16, 32, 64 at least W, at
// most 64); NT the widest of 256, 128, 64 that divides Cout and leaves room
// for two tiles in flight (three where they fit). False where none fits
// (Cin above 512).
bool plan_mmonly(TapArgs& a, int B) {
  a.nchunks = (a.Cin + MM_KC - 1) / MM_KC;
  a.TW = a.W > 32 ? 64 : a.W > 16 ? 32 : a.W > 8 ? 16 : 8;
  a.TH = M_T / a.TW;
  a.bands = (a.W + a.TW - 1) / a.TW;
  const long long tiles = (long long)B * a.bands * ((a.H + a.TH - 1) / a.TH);
  a.nt = 0;
  for (int nt = 128; nt >= 64; nt /= 2) {
    if (a.Cout % nt) continue;
    for (a.stages = 4; a.stages > 2; --a.stages)
      if (mm_smem(nt, a) <= (size_t)MAX_SMEM) break;
    if (mm_smem(nt, a) <= (size_t)MAX_SMEM) {
      a.nt = nt;
      break;
    }
  }
  if (a.nt == 0) return false;
  a.nblk = a.Cout / a.nt;
  if (tiles * a.nblk > (1ll << 30)) return false;
  a.tiles = (int)tiles;
  return true;
}

template <int NT>
cudaError_t launch_mmonly(const unsigned char* hilo, const float* scale, const float* bias,
                          __nv_bfloat16* y, const TapArgs& a, const CUtensorMap& xmap, int nsm,
                          cudaStream_t stream) {
  const size_t smem = MmLayout<NT>(a).total;
  cudaError_t err = cudaFuncSetAttribute(mmonly_wgmma<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // one block an SM, a whole number of blocks for each channel block
  const int per_nb = nsm / a.nblk > 0 ? nsm / a.nblk : 1;
  const int grid = (a.tiles < per_nb ? a.tiles : per_nb) * a.nblk;
  mmonly_wgmma<NT><<<grid, THREADS, smem, stream>>>(hilo, scale, bias, y, a, xmap);
  return cudaGetLastError();
}

cudaError_t run_mmonly(const void* xp, const void* hilo, const float* scale, const float* bias,
                       __nv_bfloat16* y, int B, TapArgs& a, cudaStream_t stream) {
  if (!plan_mmonly(a, B)) return cudaErrorInvalidValue;
  const int nsm = sm_count();
  CUtensorMap xmap;
  const uint64_t dims[4] = {(uint64_t)a.Cin, (uint64_t)a.W + 2, (uint64_t)a.H + 2, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)a.Cin, (uint64_t)a.Cin * (a.W + 2),
                               (uint64_t)a.Cin * (a.W + 2) * (a.H + 2)};
  const uint32_t box[4] = {(uint32_t)MM_KC, (uint32_t)a.TW, (uint32_t)a.TH / 2, 1};
  if (!make_tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xp, 4, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const auto* w = static_cast<const unsigned char*>(hilo);
  if (a.nt == 128) return launch_mmonly<128>(w, scale, bias, y, a, xmap, nsm, stream);
  return launch_mmonly<64>(w, scale, bias, y, a, xmap, nsm, stream);
}

// ---- taps9bf16: the int8 conv on bf16 wgmma

// The int8 pairs (b0, b1) and (b2, b3) of w as two bf16x2 words, exactly:
// byte b + 128 becomes the f32 2^23 + b + 128 by its bits, less 2^23 + 128;
// the bf16 of so small an integer is the top half of its f32 bits.
__device__ __forceinline__ void s8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Shared memory: the ring of weight slices (NST of NT x 128 bytes), the
// epilogue tile, the barriers, the int8 input tile as its tensor-map copy
// lands it ([nrows][WT][64] bytes), and the same tile in bf16 as the
// products read it (a 128-byte row of 64 channels a position, 128-byte
// swizzled).
template <int NT>
struct T9Layout {
  static constexpr int SLICE = NT * 128;  // bytes of a slice image: one tap, 64 channels
  static constexpr int NST = NT == 128 ? 6 : 10;  // ring stages
  static constexpr int OS = 2 * NT + 16;
  static constexpr size_t OUT = (size_t)NST * SLICE;
  static constexpr size_t BARS = OUT + (size_t)M_T * OS;
  static constexpr size_t IN = (BARS + 256 + 1023) / 1024 * 1024;
  size_t tile, total;
  __host__ __device__ explicit T9Layout(const TapArgs& g) {
    const size_t pos = (size_t)g.nrows * (g.TW + 2);
    tile = IN + (pos * T9_KC + 1023) / 1024 * 1024;
    total = tile + pos * 128 + 1024;
  }
};

// An item's indices, the channel block fastest (blocks that run together
// share the input tile through L2).
struct T9Item {
  int b, band, tile, nb;
  __device__ __forceinline__ T9Item(int item, const TapArgs& a) {
    nb = item % a.nblk;
    item /= a.nblk;
    tile = item % a.tiles;
    item /= a.tiles;
    band = item % a.bands;
    b = item / a.bands;
  }
};

// y = conv3x3(xp, wq) * scale + bias, the int8 values as bf16 operands,
// f32 sums. Within a band of TW image columns the outputs are taken at flat
// positions P = r WT + c of the band's padded width WT = TW + 2 (c >= TW,
// and past the image, computed and dropped), so that output P's tap (di,
// dj) is input position P + di WT + dj of the band's padded rows: 64
// consecutive outputs of a tap are 64 consecutive rows of the staged tile,
// one descriptor (the swizzle follows the address bits, so a descriptor
// may start at any row). xmap: xp as (Cin, W+2, H+2, B), boxes of (64
// channels, WT, nrows, 1). wimg: (Cin / 64, 9, Cout, 64) bf16 slice images
// (ops/probes.py::tap_images), rows 128-byte swizzled.
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
taps9_wgmma(const unsigned char* __restrict__ wimg, const float* __restrict__ scale,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, const TapArgs a,
            const __grid_constant__ CUtensorMap xmap) {
  using L = T9Layout<NT>;
  constexpr int SLICE = L::SLICE, NST = L::NST, OS = L::OS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const L lay(a);
  unsigned char* ring = smem;
  unsigned char* out_s = smem + L::OUT;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + NST;
  uint64_t* in_full = empty + NST;
  uint64_t* in_empty = in_full + 1;
  const unsigned char* in_s = smem + L::IN;
  unsigned char* tile_s = smem + lay.tile;
  const int WT = a.TW + 2, npos = a.nrows * WT;
  const uint64_t wt_mul = ((1ull << 40) + WT - 1) / WT;  // P / WT = P wt_mul >> 40 for P < 2^34

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    mbar_init(in_full, 1);
    mbar_init(in_empty, CONSUMERS / 32);
    fence_mbarrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // producer: one lane copies each chunk's int8 input rows (one
    // tensor-map copy, zero filled past the image) once the consumers have
    // converted the previous chunk's, and the chunk's nine slice images
    if (lane != 0) return;
    int step = 0, cstep = 0;
    for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
      const T9Item it(item, a);
      const int r_lo = it.tile * M_T / WT;
      for (int c = 0; c < a.nchunks; ++c, ++cstep) {
        mbar_wait(in_empty, (cstep & 1) ^ 1);
        mbar_arrive_expect_tx(in_full, (uint32_t)(npos * T9_KC));
        tma_load_4d(smem + L::IN, &xmap, c * T9_KC, it.band * a.TW, r_lo, it.b, in_full);
        for (int tap = 0; tap < T9_TAPS; ++tap, ++step) {
          const int st = step % NST;
          mbar_wait(&empty[st], ((step / NST) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], SLICE);
          bulk_copy(ring + st * SLICE,
                    wimg + (((size_t)c * T9_TAPS + tap) * a.Cout + (size_t)it.nb * NT) * 128,
                    SLICE, &full[st]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns the item's flat positions 64 wg .. 64 wg +
  // 63, all NT channels
  const int wg = warp / 4, q = warp % 4, g = lane / 4, t4 = lane % 4;
  int step = 0, cstep = 0;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const T9Item it(item, a);
    const int P0 = it.tile * M_T, r_lo = P0 / WT;
    const int s0 = P0 - r_lo * WT + 64 * wg;  // staged row of this warpgroup's first output

    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < a.nchunks; ++c, ++cstep) {
      mbar_wait(in_full, cstep & 1);
      named_sync(3, CONSUMERS);  // every warp's products of the previous chunk have retired
      // the int8 rows into the bf16 tile, 8 channels a thread and step
      for (int i = tid; i < npos * 8; i += CONSUMERS) {
        const int pos = i >> 3, j = i & 7;
        const uint2 v = *reinterpret_cast<const uint2*>(in_s + pos * 64 + 8 * j);
        uint4 o;
        s8x4_to_bf16(v.x, o.x, o.y);
        s8x4_to_bf16(v.y, o.z, o.w);
        *reinterpret_cast<uint4*>(tile_s + pos * 128 + ((j ^ (pos & 7)) << 4)) = o;
      }
      fence_proxy_async();  // the tile's generic writes before the products' reads
      named_sync(3, CONSUMERS);
      if (lane == 0) mbar_arrive(in_empty);  // the producer may copy the next chunk's rows
      fence_regs(acc);
#pragma unroll
      for (int tap = 0; tap < T9_TAPS; ++tap, ++step) {
        const int st = step % NST;
        mbar_wait(&full[st], (step / NST) & 1);
        wgmma_fence();
        const uint64_t da = wgmma_desc_sw128(tile_s + (s0 + (tap / 3) * WT + tap % 3) * 128);
        const uint64_t db = wgmma_desc_sw128(ring + st * SLICE);
#pragma unroll
        for (int k = 0; k < 4; ++k) wgmma_bf16_ss<NT>(acc, da + 2 * k, db + 2 * k);
        wgmma_commit();
        if (tap >= 2) {  // at most three taps' products in flight
          wgmma_wait<2>();
          if (lane == 0) mbar_arrive(&empty[(step - 2) % NST]);  // this warp is done with it
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) {
        mbar_arrive(&empty[(step - 2) % NST]);
        mbar_arrive(&empty[(step - 1) % NST]);
      }
    }

    // epilogue: sum i is position 64 wg + 16 q + g + 8 ((i / 2) % 2) of the
    // item, channel 8 (i / 4) + 2 t4 + i % 2; dequantized, staged, stored
    // 16 bytes a thread while the producer copies the next item's rows (the
    // chunk barriers above have ordered the previous item's stores before
    // these writes)
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int col = 8 * j + 2 * t4, co = it.nb * NT + col;
      const float s0c = __ldg(scale + co), s1c = __ldg(scale + co + 1);
      const float b0c = __ldg(bias + co), b1c = __ldg(bias + co + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(out_s + (64 * wg + 16 * q + g + 8 * h) * OS +
                                           2 * col) =
            __floats2bfloat162_rn(__fadd_rn(__fmul_rn(acc[4 * j + 2 * h], s0c), b0c),
                                  __fadd_rn(__fmul_rn(acc[4 * j + 2 * h + 1], s1c), b1c));
    }
    named_sync(3, CONSUMERS);
    for (int i = tid; i < M_T * (NT / 8); i += CONSUMERS) {
      const int p = i / (NT / 8), col = 8 * (i % (NT / 8));
      const uint32_t P = P0 + p, r = (uint32_t)((P * wt_mul) >> 40), cc = P - r * WT;
      const int x = it.band * a.TW + cc;
      if (r >= (uint32_t)a.H || cc >= (uint32_t)a.TW || x >= a.W) continue;
      *reinterpret_cast<uint4*>(y + (((size_t)it.b * a.H + r) * a.W + x) * a.Cout +
                                it.nb * NT + col) =
          *reinterpret_cast<const uint4*>(out_s + p * OS + 2 * col);
    }
  }
}

size_t t9_smem(int nt, const TapArgs& a) {
  return nt == 128 ? T9Layout<128>(a).total : T9Layout<64>(a).total;
}

// Bands of at most 64 columns, as even as W allows; tiles of M_T flat
// positions (nrows padded rows staged a tile); NT 128 where it divides
// Cout, else 64.
bool plan_taps9(TapArgs& a, int B) {
  a.nchunks = a.Cin / T9_KC;
  a.nt = a.Cout % 128 == 0 ? 128 : 64;
  a.nblk = a.Cout / a.nt;
  const int nb = (a.W + 63) / 64, WT = (a.W + nb - 1) / nb + 2;
  a.TW = WT - 2;
  a.bands = (a.W + a.TW - 1) / a.TW;
  a.nrows = (WT - 1 + M_T + 2 * WT + 2 + WT - 1) / WT;  // rows a window of M_T + 2 WT + 2 spans
  a.tiles = (a.H * WT + M_T - 1) / M_T;
  if (t9_smem(a.nt, a) > (size_t)MAX_SMEM || (long long)a.H * WT >= (1ll << 30)) return false;
  const long long items = (long long)B * a.bands * a.tiles * a.nblk;
  if (items > (1ll << 30)) return false;
  a.items = (int)items;
  return true;
}

template <int NT>
cudaError_t launch_taps9(const unsigned char* wimg, const float* scale, const float* bias,
                         __nv_bfloat16* y, const TapArgs& a, const CUtensorMap& xmap, int nsm,
                         cudaStream_t stream) {
  const size_t smem = T9Layout<NT>(a).total;
  cudaError_t err = cudaFuncSetAttribute(taps9_wgmma<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  taps9_wgmma<NT><<<a.items < nsm ? a.items : nsm, THREADS, smem, stream>>>(wimg, scale, bias,
                                                                            y, a, xmap);
  return cudaGetLastError();
}

cudaError_t run_taps9(const void* xp, const void* wimg, const float* scale, const float* bias,
                      __nv_bfloat16* y, int B, TapArgs& a, cudaStream_t stream) {
  if (!plan_taps9(a, B)) return cudaErrorInvalidValue;
  CUtensorMap xmap;
  const uint64_t dims[4] = {(uint64_t)a.Cin, (uint64_t)a.W + 2, (uint64_t)a.H + 2, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)a.Cin, (uint64_t)a.Cin * (a.W + 2),
                               (uint64_t)a.Cin * (a.W + 2) * (a.H + 2)};
  const uint32_t box[4] = {(uint32_t)T9_KC, (uint32_t)(a.TW + 2), (uint32_t)a.nrows, 1};
  if (!make_tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xp, 4, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const auto* w = static_cast<const unsigned char*>(wimg);
  const int nsm = sm_count();
  if (a.nt == 128) return launch_taps9<128>(w, scale, bias, y, a, xmap, nsm, stream);
  return launch_taps9<64>(w, scale, bias, y, a, xmap, nsm, stream);
}

}  // namespace taps

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

// Family 1, transpose: y (C, R) = x (R, C)^T, bf16, R C < 2^31; *route
// is set to the kernel launched. With both pointers 16-byte aligned and C
// a multiple of 8, R a multiple of 8 takes transpose8_kernel and R = 12
// transpose_cols_kernel; the rest transpose_slab_kernel
// (ops/probes.py::transpose_plan mirrors the choice).
int probe_transpose(const void* x, void* y, int R, int C, int* route, void* stream) {
  if (R < 1 || C < 1 || (long long)R * C >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const auto* X = static_cast<const __nv_bfloat16*>(x);
  auto* Y = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = !((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) &&
                       C % 8 == 0;
  if (aligned && R % 8 == 0) {
    *route = kTiles;
    const long long blocks = ((long long)R * C / 64 + T8_THREADS - 1) / T8_THREADS;
    transpose8_kernel<<<(unsigned)blocks, T8_THREADS, 0, st>>>(X, Y, R, C);
  } else if (aligned && R == TC_R) {
    *route = kCols;
    transpose_cols_kernel<<<(C / 8 + TC_THREADS - 1) / TC_THREADS, TC_THREADS, 0, st>>>(X, Y, C);
  } else {
    *route = kSlab;
    const int TR = R < TS_ROWS ? R : TS_ROWS, TC = slab_cols(TR);
    const long long blocks = (long long)((C + TC - 1) / TC) * ((R + TR - 1) / TR);
    transpose_slab_kernel<<<(unsigned)blocks, TS_THREADS, 0, st>>>(X, Y, R, C);
  }
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
// out (G, 8, W2, 128) f32; rows >= 8 G + 4, W2 a multiple of 8, G <= 65535,
// every pointer 16-byte aligned.
int probe_chain(const void* s, const void* wsh, const void* wgb, void* out, int G, int rows,
                int W2, void* stream) {
  if (G < 1 || G > 65535 || W2 < MTW || W2 % MTW != 0 || W2 / MTW > 65535 ||
      rows < MTH * G + MSR - MTH ||
      ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(wsh) |
        reinterpret_cast<uintptr_t>(wgb) | reinterpret_cast<uintptr_t>(out)) & 15))
    return (int)cudaErrorInvalidValue;
  CUtensorMap smap, wshmap, wgbmap;
  const uint64_t sdims[3] = {(uint64_t)W2, (uint64_t)rows, (uint64_t)MCS};
  const uint64_t sstrides[2] = {2ull * W2, 2ull * W2 * rows};
  const uint32_t sbox[3] = {(uint32_t)MTW, (uint32_t)MSR, (uint32_t)MCS};
  const uint64_t wdims[3] = {(uint64_t)MNH, (uint64_t)MK1, 1};
  const uint64_t wstrides[2] = {2ull * MNH, 2ull * MNH * MK1};
  const uint32_t wbox[3] = {(uint32_t)MNH, (uint32_t)MK1, 1};
  if (!make_tensor_map(&smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s, 3, sdims, sstrides, sbox,
                       CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_tensor_map(&wshmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wsh, 3, wdims, wstrides, wbox,
                       CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !matrix_map(&wgbmap, wgb, 3 * MNH, MC2, 64, MNH))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chain_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)CHAIN_SMEM);
  if (err != cudaSuccess) return (int)err;
  chain_wgmma<<<dim3(MC2 / MNT, W2 / MTW, G), M_THREADS, CHAIN_SMEM,
                 static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out), W2, smap, wshmap,
                                                      wgbmap);
  return (int)cudaGetLastError();
}

// Family 4: xp (B, H+2, W+2, Cin) int8 with a zero halo, scale and bias
// (Cout,) f32 -> y (B, H, W, Cout) bf16; Cin and Cout multiples of 64,
// every pointer 16-byte aligned. images: ops/probes.py::tap_images, the
// bf16 slice images (Cin / 64, 9, Cout, 64) for taps9bf16, else mmonly's hi
// and lo images (2, ceil(Cin / 128), Cout, 128) int8 (Cin at most 512).
int probe_taps(int taps9bf16, const void* xp, const void* images, const void* scale,
               const void* bias, void* y, int B, int H, int W, int Cin, int Cout, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 64 || Cin % 64 != 0 || Cout < 64 || Cout % 64 != 0 ||
      ((reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(images) |
        reinterpret_cast<uintptr_t>(y)) & 15))
    return (int)cudaErrorInvalidValue;
  taps::TapArgs a;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* out = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(taps9bf16 ? taps::run_taps9(xp, images, sc, bi, out, B, a, st)
                         : taps::run_mmonly(xp, images, sc, bi, out, B, a, st));
}

const char* probes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
