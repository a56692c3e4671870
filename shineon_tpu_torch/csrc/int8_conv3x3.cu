// Int8 3x3 SAME convolution for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel tools/pallas_conv_probe.py:
// pallas_conv3x3_int8 (the int8 conv of shineon_tpu/networks/sams/spade.py::
// Int8Conv, _conv_same_int8). On NHWC input x (B, H, W, Cin) with zero
// padding:
//   s    = absmax / 127 + 1e-30             (per tensor; absmax is a device scalar)
//   q    = clip(rint(x / s), -127, 127)     (int8, round half to even)
//   acc  = sum over taps and Cin of q * wq  (int32, exact)
//   y    = acc * (s * ksc[co]) + bias[co]   (f32, then the output dtype)
// with wq the int8 weights (scale ksc per output channel). x / s is rounded
// exactly as an IEEE division (quant_level, sm90_common.cuh, shared with the
// quantized MultiSPADE chain), and the dequantization products and bias sum
// are round-to-nearest (__fmul_rn, __fadd_rn), never contracted, so y
// matches the reference formulation bit for bit. Any Cin, Cout, H and W.
//
// What bounds it on this card: 2*9*Cin*Cout operations a pixel against
// (Cin + Cout) activation bytes and the 9*Cin*Cout weight bytes: at the
// serving clip's shapes hundreds to thousands of operations a byte, above
// the ~590 op/B ridge of the int8 tensor cores at the larger widths and
// below it at the 256x192 sites (64 and 128 channels), so both bounds
// matter; chip_smoke.py prints the larger one for every shape.
//
// bf16 serving body: a quantize pass, then the conv (conv_wgmma).
//  * The quantize pass (quantize_kernel) writes the int8 copy xq of x, its
//    channels padded to a multiple of 16 with zeros (so its rows are
//    16-byte multiples, as tensor maps need), every thread of the card
//    quantizing 8 channels at a time in full-rate arithmetic: each byte of
//    x is read once and each byte of xq written once (the TPU route,
//    tools/pallas_conv_probe.py:233-235). (A first draft quantized inside
//    the conv, by three warps of each block: they could not quantize a
//    tile as fast as the tensor cores consumed it.)
//  * The conv, an implicit GEMM, M = pixels, N = Cout, K = 9 * Cin, on
//    wgmma m64nNk32 s8 with int32 sums, warp specialised: 288 threads, two
//    consumer warpgroups and a producer warp, one lane of which copies each
//    input-channel chunk's int8 tile of xq with its halo by one tensor-map
//    copy (zero filled outside the image; 64- or 128-byte swizzled rows,
//    so the consumers' ldmatrix reads are free of bank conflicts) into a
//    2-deep ring, and the chunk's weight slices by bulk copies into a ring
//    of NST stages, all on full/empty mbarriers. xq is read once per (tile,
//    output-channel block), with the tile's halo.
//  * Weights: a slice is 128 bytes of K for N_T output channels, a
//    pre-swizzled K-major image (ops/int8_conv.py::conv_slice_images, made
//    once per conv) read through a 128-byte-swizzle descriptor. Input
//    channels come in chunks of KC = 128 (one tap a slice, 9 slices a
//    chunk) or, where Cin <= 64, KC = 64 (two taps a slice, the tenth tap
//    zero: 5 slices), so Cin = 64 wastes a tenth of the products, not half.
//    Channels past Cin and outputs past Cout are zero weights.
//  * A comes from registers by ldmatrix, one 16-row piece a warp: a tap's
//    shifted rows have no descriptor. Per-lane row addresses let a tile be
//    any M_T consecutive pixels of a band of TW columns (row-major within
//    the band): 16-wide bands where W is a multiple of 16, the whole width
//    where W <= 32 (16 x 12 is 192 pixels: three 64-pixel tiles, no waste),
//    8-wide where W is a multiple of 8. Each slice's products run while the
//    next slice's fragments load.
//  * Tiles: M_T = 128 pixels (a warpgroup each) x N_T = Cout up to 128
//    channels, or M_T = 64 x N_T = 256 (128 a warpgroup) where Cout > 128.
//    Blocks are persistent (one an SM), walking (tile, channel block, K
//    split) items, so one item's epilogue overlaps the next one's loads.
//  * Small images that leave half the SMs idle: there the chunks of K are
//    split across blocks; each writes its int32 sums to its own slot of a
//    workspace and the last split of a tile to finish (a counter) adds the
//    others' to its own (int32 sums: exact in any order) and dequantizes.
//  * Epilogue: dequantized bf16 through a shared-memory tile, stored 16
//    bytes a thread (per element where Cout is not a multiple of 8).
//
// f32 parity body: the first design, an implicit GEMM on mma.sync m16n8k32
// with the tile loop of conv3x3_tile.cuh, quantizing on load; it takes Cin
// and Cout in multiples of 64 (ops/int8_conv.py zero-pads other widths).

#include "conv3x3_tile.cuh"
#include "tma.cuh"

namespace {

using namespace conv_tile;

// 4 consecutive values (16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// quant_level as the low byte of an int.
__device__ __forceinline__ uint32_t quant_byte(float v, float s, float r) {
  return static_cast<uint32_t>(quant_level(v, s, r)) & 0xffu;
}

// The input stage: the chunk's tile of x quantized on load, zero outside
// the image.
template <typename T>
struct QuantizeOnLoad {
  const T* __restrict__ x;
  float s, rs;  // the scale and its reciprocal
  int H, W, Cin;

  __device__ __forceinline__ void operator()(unsigned char* a_s, int b, int r0, int c0,
                                             int ci0) const {
    constexpr int RS = Operand<int8_t>::RS;
    for (int i = threadIdx.x; i < NPOS * (KC / 4); i += NTHREADS) {
      const int pos = i / (KC / 4), j = i % (KC / 4);
      const int r = r0 - 1 + pos / WT, c = c0 - 1 + pos % WT;
      uint32_t packed = 0;
      if (r >= 0 && r < H && c >= 0 && c < W) {
        float v[4];
        load4(x + (((size_t)b * H + r) * W + c) * Cin + ci0 + 4 * j, v);
        packed = quant_byte(v[0], s, rs) | (quant_byte(v[1], s, rs) << 8) |
                 (quant_byte(v[2], s, rs) << 16) | (quant_byte(v[3], s, rs) << 24);
      }
      *reinterpret_cast<uint32_t*>(a_s + pos * RS + 4 * j) = packed;
    }
  }
};

// The epilogue's (scale, bias) of channel co: s * ksc[co] and bias[co].
struct ConvAffine {
  float s;
  const float* __restrict__ ksc;
  const float* __restrict__ bias;  // may be null

  __device__ __forceinline__ float2 operator()(int co) const {
    return make_float2(__fmul_rn(s, ksc[co]), bias ? bias[co] : 0.f);
  }
};

// x, y: (B, H, W, Cin) and (B, H, W, Cout) in T.  absmax: one f32 (device).
// wq: (9, Cout, Cin) int8, tap = 3*di + dj.  ksc, bias: (Cout,) f32; bias
// may be null.
template <typename T, int TN>
__global__ void __launch_bounds__(NTHREADS)
int8_conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ absmax,
                    const int8_t* __restrict__ wq, const float* __restrict__ ksc,
                    const float* __restrict__ bias, T* __restrict__ y, int H, int W, int Cin,
                    int Cout) {
  const float s = int8_scale(*absmax);
  conv3x3_tile<int8_t, TN, false>(wq, y, H, W, Cin, Cout,
                                  QuantizeOnLoad<T>{x, s, __frcp_rn(s), H, W, Cin},
                                  ConvAffine{s, ksc, bias});
}

template <int TN>
cudaError_t launch_f32(const void* x, const float* absmax, const int8_t* wq, const float* ksc,
                       const float* bias, void* y, int B, int H, int W, int Cin, int Cout,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<int8_t, TN>();
  cudaError_t err = cudaFuncSetAttribute(int8_conv3x3_kernel<float, TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), Cout / TN, B);
  int8_conv3x3_kernel<float, TN><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(x), absmax, wq, ksc, bias, static_cast<float*>(y), H, W, Cin,
      Cout);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16 serving body (wgmma)
namespace igemm {

constexpr int CONSUMERS = 256;             // two consumer warpgroups
constexpr int NTHREADS = CONSUMERS + 32;   // and a producer warp
constexpr int A_STAGES = 2;                // input tiles in flight
constexpr int MAX_SMEM = 232448;

// The launch's geometry (see the header): bands of TW columns, tiles of M_T
// consecutive band pixels, nrows staged input rows a tile (halo included).
struct ConvArgs {
  int H, W, Cin, Cout;
  int Cs;       // channels of a pixel of the int8 copy: Cin rounded up to 16
  int TW, bands, tiles, nrows;
  int nblk;     // output-channel blocks of N_T
  int nchunks;  // input-channel chunks of KC
  int ksplit;   // chunk groups a tile's K is split into
  int items;    // B * bands * tiles * nblk * ksplit
  int Coutp;    // nblk * N_T: a workspace row
  int pixels;   // B * H * W
  long long ws_ints;  // ksplit > 1: the tiles' counters, then each split's int32 sums
};

template <int TN, bool SPLIT_M, int KC>
struct Cfg {
  static constexpr int M_T = SPLIT_M ? 128 : 64;   // pixels a tile
  static constexpr int N_T = SPLIT_M ? TN : 2 * TN;  // output channels a block
  static constexpr int NS = KC == 128 ? 9 : 5;      // slices a chunk
  static constexpr int SLICE = N_T * 128;           // bytes of a slice image
  static constexpr int NST = SLICE >= 32768 ? 4 : 6;  // ring stages
  static constexpr int OS = 2 * N_T + 16;  // bytes an output row of the epilogue tile
  static constexpr size_t BARS = (size_t)NST * SLICE;
  static constexpr size_t OUT = BARS + 256;
  static constexpr size_t A = (OUT + (size_t)M_T * OS + 1023) / 1024 * 1024;
  // an input tile as its tensor-map copy lands it: [nrows][TW + 2][KC]
  // int8, swizzled (128 bytes a row for KC = 128, 64 for KC = 64)
  __host__ __device__ static size_t a_bytes(const ConvArgs& a) {
    return ((size_t)a.nrows * (a.TW + 2) * KC + 1023) / 1024 * 1024;
  }
  __host__ __device__ static size_t bytes(const ConvArgs& a) {
    return A + A_STAGES * a_bytes(a) + 1024;
  }
};

// An item's indices, channel block fastest but for the K split.
struct Item {
  int b, band, tile, nb, ks;
  __device__ __forceinline__ Item(int item, const ConvArgs& a) {
    ks = item % a.ksplit;
    item /= a.ksplit;
    nb = item % a.nblk;
    item /= a.nblk;
    tile = item % a.tiles;
    item /= a.tiles;
    band = item % a.bands;
    b = item / a.bands;
  }
  __device__ __forceinline__ int c0(const ConvArgs& a) const { return ks * a.nchunks / a.ksplit; }
  __device__ __forceinline__ int c1(const ConvArgs& a) const {
    return (ks + 1) * a.nchunks / a.ksplit;
  }
};

// quant_level's byte in full-rate arithmetic (no conversion unit): the
// clipped quotient plus 1.5 * 2^23 rounds to the nearest even integer,
// whose low byte is the level; next to a half-integer, from the IEEE
// quotient, as quant_level. The same byte as quant_level
// (fused_multispade.cu: HidQuant::level).
__device__ __forceinline__ uint32_t quant_byte_fast(float v, float s, float r) {
  const float yc = fminf(fmaxf(v * r, -127.f), 127.f);
  float t = __fadd_rn(yc, 12582912.f);
  if (fabsf(fabsf(yc - __fadd_rn(t, -12582912.f)) - 0.5f) < 1e-4f)
    t = __fadd_rn(fminf(fmaxf(__fdiv_rn(v, s), -127.f), 127.f), 12582912.f);
  return __float_as_uint(t) & 0xffu;
}

// The quantize pass: xq (pixels, Cs) int8 from x (pixels, Cin) bf16, zero
// past Cin; 8 channels a thread and step. Every byte of x is read once and
// every byte of xq written once.
__global__ void __launch_bounds__(256)
quantize_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ absmax,
                int8_t* __restrict__ xq, long long pixels, int Cin, int Cs) {
  const float s = int8_scale(*absmax), r = __frcp_rn(s);
  const int per_px = Cs / 8;
  const long long n = pixels * per_px;
  const bool vec = Cin % 8 == 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long px = i / per_px;
    const int ch = 8 * (int)(i % per_px);
    const __nv_bfloat16* src = x + px * Cin + ch;
    float v[8];
    if (vec && ch + 8 <= Cin) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        v[2 * e] = f.x;
        v[2 * e + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = ch + e < Cin ? __bfloat162float(src[e]) : 0.f;
    }
    uint32_t w[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < 8; ++e) w[e / 4] |= quant_byte_fast(v[e], s, r) << (8 * (e % 4));
    *reinterpret_cast<uint2*>(xq + px * Cs + ch) = make_uint2(w[0], w[1]);
  }
}

// Byte offset of 16-byte chunk c of input position pos in a swizzled tile
// (the tensor map's swizzle: chunk c ^ (pos % 8) of 128-byte rows, c ^
// ((pos / 2) % 4) of 64-byte rows).
template <int KC>
__device__ __forceinline__ int tile_byte(int pos, int c) {
  return KC == 128 ? pos * 128 + ((c ^ (pos % 8)) << 4) : pos * 64 + ((c ^ ((pos >> 1) & 3)) << 4);
}

// y: (B, H, W, Cout) bf16. xq: the int8 copy of x through its tensor map
// (Cs, W, H, B). absmax: one f32 (device). wimg: the slice images (nblk,
// nchunks, NS, N_T, 128) int8. ksc, bias: (Cout,) f32 (bias may be null).
// ws: with ksplit > 1, the tiles' counters (items / ksplit ints, zeroed),
// then each split's int32 sums (ksplit x B * H * W * Coutp).
template <int TN, bool SPLIT_M, int KC>
__global__ void __launch_bounds__(NTHREADS, 1)
conv_wgmma(const float* __restrict__ absmax, const unsigned char* __restrict__ wimg,
           const float* __restrict__ ksc, const float* __restrict__ bias,
           __nv_bfloat16* __restrict__ y, int* ws, const ConvArgs a,
           const __grid_constant__ CUtensorMap xmap) {
  using C = Cfg<TN, SPLIT_M, KC>;
  constexpr int M_T = C::M_T, N_T = C::N_T, NS = C::NS, SLICE = C::SLICE, NST = C::NST;
  constexpr int OS = C::OS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* empty = full + NST;
  uint64_t* a_full = empty + NST;
  uint64_t* a_empty = a_full + A_STAGES;
  int* last_flag = reinterpret_cast<int*>(a_empty + A_STAGES);
  unsigned char* out_s = smem + C::OUT;
  unsigned char* a_ring = smem + C::A;
  const size_t a_bytes = C::a_bytes(a);
  const uint32_t a_copy = static_cast<uint32_t>(a.nrows * (a.TW + 2) * KC);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    for (int i = 0; i < A_STAGES; ++i) {
      mbar_init(&a_full[i], 1);
      mbar_init(&a_empty[i], CONSUMERS / 32);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // producer: one lane copies each chunk's int8 input tile (its halo and
    // zeros outside the image by the tensor map) and then its weight slices
    if (lane != 0) return;
    int step = 0, astep = 0;
    for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
      const Item it(item, a);
      for (int c = it.c0(a); c < it.c1(a); ++c, ++astep) {
        const int ast = astep % A_STAGES;
        mbar_wait(&a_empty[ast], ((astep / A_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&a_full[ast], a_copy);
        tma_load_4d(a_ring + ast * a_bytes, &xmap, c * KC, it.band * a.TW - 1,
                    it.tile * M_T / a.TW - 1, it.b, &a_full[ast]);
        const unsigned char* src = wimg + ((size_t)it.nb * a.nchunks + c) * NS * SLICE;
        for (int sl = 0; sl < NS; ++sl, ++step) {
          const int st = step % NST;
          mbar_wait(&empty[st], ((step / NST) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], SLICE);
          bulk_copy(ring + st * SLICE, src + (size_t)sl * SLICE, SLICE, &full[st]);
        }
      }
    }
    return;
  }

  // consumers
  const float s = int8_scale(*absmax);
  const int wg = warp / 4, q = warp % 4, g = lane / 4, t = lane % 4;
  const int prow = (SPLIT_M ? 64 * wg : 0) + 16 * q;  // this warp's first tile pixel
  const int ncol = SPLIT_M ? 0 : TN * wg;              // this warpgroup's first block channel
  const int WT = a.TW + 2;
  const int a_c = lane / 16;  // the 16-byte chunk of a k-step this lane's ldmatrix row reads
  const bool vec_out = a.Cout % 8 == 0;
  int step = 0, astep = 0;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    const Item it(item, a);
    const int base = it.tile * M_T, rt = base / a.TW;
    // this lane's ldmatrix row: tile pixel prow + lane % 16, at tap (0, 0)
    const int gp = base + prow + lane % 16;
    const int arow = (gp / a.TW - rt) * WT + gp % a.TW;

    int acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0;
    for (int c = it.c0(a); c < it.c1(a); ++c, ++astep) {
      const int ast = astep % A_STAGES;
      const unsigned char* at = a_ring + ast * a_bytes;
      mbar_wait(&a_full[ast], (astep / A_STAGES) & 1);
      // The slices' products run one group behind the next slice's A
      // fragments: two sets of them, each fenced until its group retired.
      uint32_t afr[2][4][4];
      auto load_a = [&](uint32_t (&f)[4][4], int sl) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // k-step kk of slice sl: (tap, 16-byte chunk of the position)
          const int tap = KC == 128 ? sl : min(2 * sl + kk / 2, 8);  // tap 9: zero weights
          const int ck = KC == 128 ? 2 * kk : 2 * (kk % 2);
          const int pos = arow + (tap / 3) * WT + tap % 3;
          ldmatrix_x4(f[kk], at + tile_byte<KC>(pos, ck + a_c));
        }
      };
      load_a(afr[0], 0);
      int prev = -1;  // the ring stage of the group in flight
#pragma unroll
      for (int sl = 0; sl < NS; ++sl, ++step) {
        const int st = step % NST, cur = sl & 1;
        mbar_wait(&full[st], (step / NST) & 1);
        wgmma_fence();
        const unsigned char* slice = ring + st * SLICE + ncol * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8_rs<TN>(acc, afr[cur][kk], wgmma_desc_sw128(slice) + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's group has retired
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(afr[cur ^ 1][kk]);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);  // this warp is done with it
        if (sl + 1 < NS) load_a(afr[cur ^ 1], sl + 1);
        prev = st;
      }
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(afr[0][kk]);
        fence_regs(afr[1][kk]);
      }
      if (lane == 0) {
        mbar_arrive(&empty[prev]);
        mbar_arrive(&a_empty[ast]);  // ... and with the input tile
      }
    }

    // accumulator i: n8 tile i / 4, element e = i % 4: tile pixel prow + g +
    // 8 * (e / 2), block channel ncol + 8 * (i / 4) + 2t + e % 2
    auto pixel = [&](int p, int& off) {  // tile pixel p: valid, and its offset in pixels
      const int gq = base + p, rr = gq / a.TW, cc = it.band * a.TW + gq % a.TW;
      off = (it.b * a.H + rr) * a.W + cc;
      return rr < a.H && cc < a.W;
    };
    if (a.ksplit > 1) {
      // this split's partial sums into its slot of the workspace; the last
      // split of the tile to finish adds the others' to its own
      const size_t slot = (size_t)a.pixels * a.Coutp;
      int* part = ws + a.items / a.ksplit;
      const int col0 = it.nb * N_T + ncol + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int off;
        if (!pixel(prow + g + 8 * half, off)) continue;
        int* row = part + it.ks * slot + (size_t)off * a.Coutp + col0;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j)
          *reinterpret_cast<int2*>(row + 8 * j) =
              make_int2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
      __threadfence();
      named_sync(3, CONSUMERS);
      if (tid == 0) *last_flag = atomicAdd(ws + item / a.ksplit, 1) == a.ksplit - 1;
      named_sync(3, CONSUMERS);
      if (!*last_flag) continue;  // another split of this tile finishes it
      __threadfence();
      for (int o = 0; o < a.ksplit; ++o) {
        if (o == it.ks) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          int off;
          if (!pixel(prow + g + 8 * half, off)) continue;
          const int* row = part + o * slot + (size_t)off * a.Coutp + col0;
#pragma unroll
          for (int j = 0; j < TN / 8; ++j) {
            const int2 v = __ldcg(reinterpret_cast<const int2*>(row + 8 * j));
            acc[4 * j + 2 * half] += v.x;
            acc[4 * j + 2 * half + 1] += v.y;
          }
        }
      }
    }
    named_sync(3, CONSUMERS);  // the previous item's stores are done with out_s
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = ncol + 8 * j + 2 * t + e, co = it.nb * N_T + col;
        const float sc = co < a.Cout ? __fmul_rn(s, ksc[co]) : 0.f;
        const float bi = co < a.Cout && bias ? bias[co] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = prow + g + 8 * half;
          reinterpret_cast<__nv_bfloat16*>(out_s + p * OS)[col] =
              __float2bfloat16_rn(dequant(acc[4 * j + 2 * half + e], sc, bi));
        }
      }
    }
    named_sync(3, CONSUMERS);
    for (int i = tid; i < M_T * (N_T / 8); i += CONSUMERS) {
      const int p = i / (N_T / 8), col = 8 * (i % (N_T / 8)), co = it.nb * N_T + col;
      int off;
      if (!pixel(p, off) || co >= a.Cout) continue;
      const unsigned char* src = out_s + p * OS + 2 * col;
      __nv_bfloat16* dst = y + (size_t)off * a.Cout + co;
      if (vec_out && co + 8 <= a.Cout) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && co + e < a.Cout; ++e)
          dst[e] = reinterpret_cast<const __nv_bfloat16*>(src)[e];
      }
    }
  }
}

// The geometry of a launch: band width, tiles, K split (see the header).
template <int TN, bool SPLIT_M, int KC>
bool plan(ConvArgs& a, int B, int H, int W, int Cin, int Cout, int nsm) {
  using C = Cfg<TN, SPLIT_M, KC>;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.nblk = (Cout + C::N_T - 1) / C::N_T;
  a.Coutp = a.nblk * C::N_T;
  a.nchunks = (Cin + KC - 1) / KC;
  a.Cs = (Cin + 15) / 16 * 16;
  auto set_band = [&](int tw) {
    a.TW = tw;
    a.bands = (W + tw - 1) / tw;
    a.tiles = (H * tw + C::M_T - 1) / C::M_T;
    a.nrows = C::M_T % tw == 0 ? C::M_T / tw + 2 : (C::M_T - 1) / tw + 4;
  };
  set_band(W % 16 == 0 ? 16 : W <= 32 ? W : W % 8 == 0 ? 8 : 16);
  if (C::bytes(a) > MAX_SMEM) set_band(16);
  if (C::bytes(a) > MAX_SMEM) return false;
  // split K where the items leave half the SMs idle or more: the fewest
  // waves x chunks an item, at most 4 splits, each a divisor of the chunks
  const long long base = (long long)B * a.bands * a.tiles * a.nblk;
  a.ksplit = 1;
  long long best = -1;
  for (int d = 1; d <= (2 * base < nsm ? 4 : 1) && d <= a.nchunks; ++d) {
    if (a.nchunks % d) continue;
    const long long cost = (base * d + nsm - 1) / nsm * (a.nchunks / d);
    if (best < 0 || cost < best) {
      best = cost;
      a.ksplit = d;
    }
  }
  const long long items = base * a.ksplit;
  if (items > (1ll << 30) || (long long)B * H * W * a.Coutp * a.ksplit > (1ll << 31))
    return false;
  a.items = (int)items;
  a.pixels = B * H * W;
  a.ws_ints = a.ksplit > 1 ? base + (long long)a.ksplit * a.pixels * a.Coutp : 0;
  return true;
}

template <int TN, bool SPLIT_M, int KC>
cudaError_t launch(const void* xq, const float* absmax, const void* wimg, const float* ksc,
                   const float* bias, void* y, void* ws, const ConvArgs& a, int B, int nsm,
                   cudaStream_t stream) {
  using C = Cfg<TN, SPLIT_M, KC>;
  const size_t smem = C::bytes(a);
  cudaError_t err = cudaFuncSetAttribute(conv_wgmma<TN, SPLIT_M, KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.ksplit > 1) {
    err = cudaMemsetAsync(ws, 0, sizeof(int) * (size_t)(a.items / a.ksplit), stream);
    if (err != cudaSuccess) return err;
  }
  // the int8 copy as (Cs, W, H, B), boxes of one chunk's staged rows and
  // columns, swizzled as the consumers' ldmatrix reads them (tile_byte)
  CUtensorMap xmap;
  const uint64_t dims[4] = {(uint64_t)a.Cs, (uint64_t)a.W, (uint64_t)a.H, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)a.Cs, (uint64_t)a.Cs * a.W,
                               (uint64_t)a.Cs * a.W * a.H};
  const uint32_t box[4] = {(uint32_t)KC, (uint32_t)(a.TW + 2), (uint32_t)a.nrows, 1};
  if (!make_tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, 4, dims, strides, box,
                       KC == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  conv_wgmma<TN, SPLIT_M, KC><<<a.items < nsm ? a.items : nsm, NTHREADS, smem, stream>>>(
      absmax, static_cast<const unsigned char*>(wimg), ksc, bias, static_cast<__nv_bfloat16*>(y),
      static_cast<int*>(ws), a, xmap);
  return cudaGetLastError();
}

}  // namespace igemm

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

// Plan the bf16 body for these shapes into a and, with xq (the int8 copy
// of x) non-null, launch it.
template <int TN, bool SPLIT_M, int KC>
cudaError_t run(igemm::ConvArgs& a, const void* xq, const float* absmax, const void* w,
                const float* ksc, const float* bias, void* y, void* ws, int B, int H, int W,
                int Cin, int Cout, cudaStream_t stream) {
  const int nsm = sm_count();
  if (nsm < 1) return cudaErrorNoDevice;
  if (!igemm::plan<TN, SPLIT_M, KC>(a, B, H, W, Cin, Cout, nsm)) return cudaErrorInvalidValue;
  if (xq == nullptr) return cudaSuccess;
  if (a.ksplit > 1 && ws == nullptr) return cudaErrorInvalidValue;
  return igemm::launch<TN, SPLIT_M, KC>(xq, absmax, w, ksc, bias, y, ws, a, B, nsm, stream);
}

using RunFn = cudaError_t (*)(igemm::ConvArgs&, const void*, const float*, const void*,
                              const float*, const float*, void*, void*, int, int, int, int, int,
                              cudaStream_t);

// The bf16 body's tile configuration for these widths, as
// ops/int8_conv.py::conv_mode lays out the slice images: KC = 64 where Cin
// <= 64, else 128; N_T = 64 (Cout <= 64) or 128 (Cout <= 128), the
// warpgroups splitting the pixels, else 256, split between them.
RunFn config(int Cin, int Cout) {
  const bool narrow = Cin <= 64;
  if (Cout <= 64) return narrow ? run<64, true, 64> : run<64, true, 128>;
  if (Cout <= 128) return narrow ? run<128, true, 64> : run<128, true, 128>;
  return narrow ? run<128, false, 64> : run<128, false, 128>;
}

}  // namespace

extern "C" {

// The bf16 body's plan for these shapes: the int32 workspace it needs
// (ints, 0 without a K split) and its K split; returns a cudaError_t.
int int8_conv3x3_plan(int B, int H, int W, int Cin, int Cout, long long* ws_ints, int* ksplit) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1) return (int)cudaErrorInvalidValue;
  igemm::ConvArgs a;
  const cudaError_t err = config(Cin, Cout)(a, nullptr, nullptr, nullptr, nullptr, nullptr,
                                            nullptr, nullptr, B, H, W, Cin, Cout, nullptr);
  if (err != cudaSuccess) return (int)err;
  *ws_ints = a.ws_ints;
  *ksplit = a.ksplit;
  return 0;
}

// The bf16 body's quantize pass on `stream`: xq (pixels, Cs) int8, Cs =
// Cin rounded up to 16, from x (pixels, Cin) bf16 and the abs-max (one f32,
// device); returns a cudaError_t.
int int8_conv3x3_quantize(const void* x, const void* absmax, void* xq, long long pixels, int Cin,
                          void* stream) {
  if (pixels < 1 || Cin < 1) return (int)cudaErrorInvalidValue;
  const int Cs = (Cin + 15) / 16 * 16, nsm = sm_count();
  if (nsm < 1) return (int)cudaErrorNoDevice;
  const long long work = pixels * (Cs / 8);
  const long long blocks = (work + 255) / 256;
  igemm::quantize_kernel<<<(int)(blocks < 8ll * nsm ? blocks : 8ll * nsm), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(absmax),
      static_cast<int8_t*>(xq), pixels, Cin, Cs);
  return (int)cudaGetLastError();
}

// Launches the conv on `stream`; returns a cudaError_t (0 on success).
// is_bf16 = 1: x the int8 copy of int8_conv3x3_quantize, y bf16, w the
// slice images (conv_slice_images), ws the int32 workspace of
// int8_conv3x3_plan (may be null without a K split); any Cin and Cout.
// is_bf16 = 0 (the f32 parity body): x, y f32, w the weights (9, Cout,
// Cin) int8, Cin and Cout multiples of 64.
int int8_conv3x3_forward(int is_bf16, const void* x, const void* absmax, const void* w,
                         const void* ksc, const void* bias, void* y, void* ws, int B, int H,
                         int W, int Cin, int Cout, void* stream) {
  if (x == nullptr || B < 1 || B > 65535 || H < 1 || W < 1 || Cin < 1 || Cout < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* am = static_cast<const float*>(absmax);
  const float* sc = static_cast<const float*>(ksc);
  const float* bi = static_cast<const float*>(bias);
  if (!is_bf16) {
    if (Cin % KC != 0 || Cout % 64 != 0 || Cout / 64 > 65535) return (int)cudaErrorInvalidValue;
    const int8_t* wq = static_cast<const int8_t*>(w);
    return (int)(Cout % 128 == 0 ? launch_f32<128>(x, am, wq, sc, bi, y, B, H, W, Cin, Cout, s)
                                 : launch_f32<64>(x, am, wq, sc, bi, y, B, H, W, Cin, Cout, s));
  }
  igemm::ConvArgs a;
  return (int)config(Cin, Cout)(a, x, am, w, sc, bi, y, ws, B, H, W, Cin, Cout, s);
}

const char* int8_conv3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
