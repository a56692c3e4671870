// The tile loop of the 3x3 implicit-GEMM convolutions on mma.sync, the
// first design of the int8 conv: the int8 conv's f32 parity body runs on
// it. The int8 conv's bf16 serving body (kernel 4, int8_conv3x3.cu:
// conv_wgmma) and the conv probe's tap-product kernels (probes.cu:
// mmonly_wgmma, taps9_wgmma) no longer use it: they run on wgmma.
//
// A block owns (sample, TH x TW pixel tile, TN = 128 output channels, or 64
// where Cout is not a multiple of 128). It walks Cin in chunks of KC: an
// input stage (the caller's functor) fills shared memory with the chunk's
// (TH + 2) x (TW + 2) tile with its 1-pixel halo; then the nine (tap, chunk)
// steps each multiply a (128 pixels) x (TN channels) slice of it by a
// (TN x KC) weight slice. The int8 weight slices stream through a ring of
// NSTAGE buffers, NSTAGE - 1 steps ahead: with cp.async for int8 operands,
// and for bf16 operands (int8 values convert to bf16 exactly) as 16-byte
// loads held in registers across the step's products, then converted and
// stored. The 8 warps split the tile 4 (pixel rows) x 2 (channel halves).
// Operands: int8 on s8 m16n8k32 with int32 sums, or bf16 on m16n8k16 with
// f32 sums; ldmatrix addresses are in bytes, a k-step is 32 bytes either
// way. Any H and W are taken (ragged tiles are masked); Cin and Cout must
// be multiples of 64.
#pragma once

#include <type_traits>

#include "sm90_common.cuh"

namespace {
namespace conv_tile {

constexpr int TH = 8;          // pixel tile rows
constexpr int TW = 16;         // pixel tile columns (one m16 tile a row)
constexpr int HT = TH + 2;     // input tile rows (1-pixel halo)
constexpr int WT = TW + 2;     // input tile columns
constexpr int NPOS = HT * WT;  // 180 input positions
constexpr int KC = 64;         // input channels a chunk
constexpr int NSTAGE = 4;      // weight slices in flight
constexpr int NTHREADS = 256;
constexpr int WARPS_M = 4;           // warps along the pixel rows
constexpr int MT = TH / WARPS_M;     // m16 tiles (tile rows) a warp (2)

// E, the operand type in shared memory: int8_t or __nv_bfloat16.
template <typename E>
struct Operand {
  static constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  static constexpr int ROW = KC * (int)sizeof(E);  // bytes of a chunk row
  static constexpr int RS = ROW + 16;              // padded: 16-byte aligned, conflict-free ldmatrix
};

template <typename E, int TN>
constexpr size_t smem_bytes() {
  return (size_t)(NPOS + NSTAGE * TN) * Operand<E>::RS;
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  mma_s8(d, a, b0, b1);
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  mma_bf16(d, a, b0, b1);
}

// acc * scale + bias of the int32 or f32 sum, never contracted.
__device__ __forceinline__ float dequant_acc(int acc, float scale, float bias) {
  return dequant(acc, scale, bias);
}
__device__ __forceinline__ float dequant_acc(float acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(acc, scale), bias);
}

// 16 int8 values (raw) as 16 bf16 values at dst (32 bytes, 16-byte aligned).
__device__ __forceinline__ void store_s8x16_as_bf16(unsigned char* dst, uint4 raw) {
  const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) __nv_bfloat162 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __floats2bfloat162_rn(q[2 * j], q[2 * j + 1]);
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(v)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(v)[1];
}

// The 16-byte int8 pieces of a (TN x KC) weight slice each thread moves.
template <int TN>
__host__ __device__ constexpr int w_pieces() {
  return TN * (KC / 16) / NTHREADS;
}

// Start moving the (tap, chunk) weight slice into buf: row n receives
// wq[tap][co0 + n][ci0 .. ci0 + KC). int8: cp.async straight into buf.
// bf16: 16-byte loads into held, which place_w_slice converts and stores.
template <typename E, int TN>
__device__ __forceinline__ void fetch_w_slice(uint4 (&held)[w_pieces<TN>()], unsigned char* buf,
                                              const int8_t* __restrict__ wq, int Cin, int Cout,
                                              int tap, int ci0, int co0) {
#pragma unroll
  for (int j = 0; j < w_pieces<TN>(); ++j) {
    const int i = threadIdx.x + j * NTHREADS;
    const int n = i / (KC / 16), piece = i % (KC / 16);
    const int8_t* src = wq + ((size_t)tap * Cout + co0 + n) * Cin + ci0 + 16 * piece;
    if constexpr (Operand<E>::kInt8)
      cp_async16(buf + n * Operand<E>::RS + 16 * piece, src);
    else
      held[j] = *reinterpret_cast<const uint4*>(src);
  }
}

template <typename E, int TN>
__device__ __forceinline__ void place_w_slice(const uint4 (&held)[w_pieces<TN>()],
                                              unsigned char* buf) {
  if constexpr (!Operand<E>::kInt8) {
#pragma unroll
    for (int j = 0; j < w_pieces<TN>(); ++j) {
      const int i = threadIdx.x + j * NTHREADS;
      const int n = i / (KC / 16), piece = i % (KC / 16);
      store_s8x16_as_bf16(buf + n * Operand<E>::RS + 32 * piece, held[j]);
    }
  }
}

// The block's tile of y (B, H, W, Cout), y = dequant(acc, affine(co)):
// wq (9, Cout, Cin) int8, tap = 3*dy + dx. stage(a_s, b, r0, c0, ci0) fills
// a_s with the chunk's input tile: row pos (of Operand<E>::RS bytes) holds
// channels ci0 .. ci0 + KC of image pixel (r0 - 1 + pos / WT, c0 - 1 + pos %
// WT), zero outside the image. affine(co) gives (scale, bias) of channel co.
// CENTRE: every weight tap multiplies the centre tap (1, 1) of the tile (the
// conv probe's mmonly variant); else tap (dy, dx) reads offset (dy, dx).
template <typename E, int TN, bool CENTRE, typename T, typename Stage, typename Affine>
__device__ __forceinline__ void conv3x3_tile(const int8_t* __restrict__ wq, T* __restrict__ y,
                                             int H, int W, int Cin, int Cout, const Stage& stage,
                                             const Affine& affine) {
  using Op = Operand<E>;
  constexpr int NT = TN / 8 / 2;  // n8 tiles a warp
  constexpr int RS = Op::RS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* a_s = smem;             // [NPOS][RS]
  unsigned char* w_s = a_s + NPOS * RS;  // NSTAGE x [TN][RS]

  const int tiles_w = (W + TW - 1) / TW;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane / 4, t = lane % 4;

  // ldmatrix row addresses of this lane (bytes)
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_k = 16 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16);
  const int b_k = 16 * ((lane / 8) % 2);

  typename Op::Acc acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0;

  uint4 held[w_pieces<TN>()];
  const int nsteps = (Cin / KC) * 9;
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < nsteps) {
      unsigned char* buf = w_s + i * TN * RS;
      fetch_w_slice<E, TN>(held, buf, wq, Cin, Cout, i % 9, (i / 9) * KC, co0);
      place_w_slice<E, TN>(held, buf);
    }
    cp_async_commit();  // (an empty group keeps the group count uniform)
  }
  for (int step = 0; step < nsteps; ++step) {
    const int tap = step % 9, ci0 = (step / 9) * KC;
    if (tap == 0) stage(a_s, b, r0, c0, ci0);  // (the previous step's closing barrier freed a_s)
    const int ahead = step + NSTAGE - 1;
    unsigned char* w_next = w_s + (ahead % NSTAGE) * TN * RS;
    if (ahead < nsteps)
      fetch_w_slice<E, TN>(held, w_next, wq, Cin, Cout, ahead % 9, (ahead / 9) * KC, co0);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();  // this step's weight slice has landed
    __syncthreads();              // ... for every thread (and so has the input tile)

    const unsigned char* w_cur = w_s + (step % NSTAGE) * TN * RS;
    const int di = CENTRE ? 1 : tap / 3, dj = CENTRE ? 1 : tap % 3;
#pragma unroll
    for (int ks = 0; ks < Op::ROW / 32; ++ks) {
      uint32_t afr[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int pos = (MT * wm + mi + di) * WT + a_row + dj;
        ldmatrix_x4(afr[mi], a_s + pos * RS + 32 * ks + a_k);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, w_cur + (8 * NT * wn + 16 * np + b_row) * RS + 32 * ks + b_k);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma(acc[mi][2 * np], afr[mi], bfr[0], bfr[1]);
          mma(acc[mi][2 * np + 1], afr[mi], bfr[2], bfr[3]);
        }
      }
    }
    // bf16: the slice fetched above lands in its buffer (last read the step
    // before, which ended in a barrier) while this one's products retire
    if (ahead < nsteps) place_w_slice<E, TN>(held, w_next);
    __syncthreads();  // everyone is done with this slice (and tile) before refills
  }

  // accumulator element e of (m-tile mi, n-tile nt): pixel (tile row
  // MT*wm + mi, tile column g + 8*(e/2)), channel co0 + 8*(NT*wn + nt) + 2t + e%2
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int co = co0 + 8 * (NT * wn + nt) + 2 * t;
    const float2 a0 = affine(co), a1 = affine(co + 1);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int r = r0 + MT * wm + mi;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + g + 8 * half;
        if (r >= H || c >= W) continue;
        store2(y + (((size_t)b * H + r) * W + c) * Cout + co,
               dequant_acc(acc[mi][nt][2 * half], a0.x, a0.y),
               dequant_acc(acc[mi][nt][2 * half + 1], a1.x, a1.y));
      }
    }
  }
}

}  // namespace conv_tile
}  // namespace
