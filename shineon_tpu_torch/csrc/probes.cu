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
//  1. movement (B, B2, C, C2, E, F, G, H, K, L): gather_kernel maps each
//     output element through a 4-D strided index map (a base offset and four
//     strides, which also express a per-grid-index offset) to its input
//     element, then optionally y = a*x (+ b) with a per-channel or constant a,
//     rounded as a multiply and then an add (never contracted into an FMA).
//     A thread moves 16 bytes where the map keeps them contiguous and 16-byte
//     aligned, one element otherwise: an unaligned lane offset (K's 3:51) is
//     what the scalar path is for. transpose_kernel (C, C2) goes through a
//     32 x 33 f32 tile in shared memory, so reads and writes are both
//     coalesced and neither conflicts on a bank; ragged edges are masked.
//     Bound: bytes; at the probes' sizes (under 2 MB) the launch.
//  2. contraction (A, A2, D, I): gemm_kernel, C[M,N] = sum_k A[m,k] B[k,N],
//     bf16 operands on mma.sync m16n8k16 with f32 sums. A is (M, K) row-major
//     or, for A2's contraction over the major dim, (K, M): it is staged into
//     shared memory as (m, k) either way (the transposing stage). K tails (K =
//     12) and ragged M or N (4000) are zero-filled or masked in shared memory,
//     never read past the operand. Output f32, or bf16 rounded once from the
//     f32 sum (A). Bound: bytes at these K; then the launch.
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

#include "conv3x3_tile.cuh"

namespace {

// ------------------------------------------------------------ 1. movement

struct GatherMap {
  int d[4];         // output dims; the output is contiguous
  long long s[4];   // input strides (elements) of each output dim
  long long base;   // input offset of output element 0
};

enum Affine { kCopy = 0, kScale = 1, kScaleAdd = 2 };

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

// VEC consecutive output elements a thread, along the last dim (VEC = 1, or
// 16 bytes when the host found the map contiguous and aligned there).
template <typename T, int VEC>
__global__ void gather_kernel(const T* __restrict__ x, T* __restrict__ y, GatherMap m,
                              const float* __restrict__ chan, float a, float b, int affine,
                              long long n_groups) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_groups) return;
  const long long e = gid * VEC;
  const int i3 = (int)(e % m.d[3]);
  long long rest = e / m.d[3];
  const int i2 = (int)(rest % m.d[2]);
  rest /= m.d[2];
  const int i1 = (int)(rest % m.d[1]);
  const int i0 = (int)(rest / m.d[1]);
  const long long src = m.base + i0 * m.s[0] + i1 * m.s[1] + i2 * m.s[2] + i3 * m.s[3];
  __align__(16) T v[VEC];
  if constexpr (VEC > 1)
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(x + src);
  else
    v[0] = x[src];
  if (affine != kCopy) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float f = __fmul_rn(to_f(v[j]), chan ? chan[i3 + j] : a);
      if (affine == kScaleAdd) f = __fadd_rn(f, b);
      v[j] = from_f<T>(f);
    }
  }
  if constexpr (VEC > 1)
    *reinterpret_cast<uint4*>(y + e) = *reinterpret_cast<const uint4*>(v);
  else
    y[e] = v[0];
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

constexpr int GM = 64, GN = 64, GK = 16;  // block tile; 4 warps of 16 rows x 64 columns
constexpr int GAS = GK + 8;               // 48-byte A rows: aligned, conflict-free ldmatrix
constexpr int GBS = GN + 8;               // 144-byte B rows

template <bool A_TRANS, bool OUT_BF16>
__global__ void __launch_bounds__(128)
gemm_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
            void* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 a_s[GM * GAS];
  __shared__ __align__(16) __nv_bfloat16 b_s[GK * GBS];
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int l_row = lane % 16, l_col = 8 * (lane / 16);  // ldmatrix row addresses
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  float acc[GN / 8][4];
#pragma unroll
  for (int nt = 0; nt < GN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GK) {
    // A as (m, k) in shared memory whatever its layout; consecutive threads
    // read consecutive addresses of either layout
    for (int i = tid; i < GM * GK; i += blockDim.x) {
      const int m = A_TRANS ? i % GM : i / GK, k = A_TRANS ? i / GM : i % GK;
      const int gm = m0 + m, gk = k0 + k;
      __nv_bfloat16 v = zero;
      if (gm < M && gk < K) v = A_TRANS ? A[(size_t)gk * M + gm] : A[(size_t)gm * K + gk];
      a_s[m * GAS + k] = v;
    }
    for (int i = tid; i < GK * GN; i += blockDim.x) {
      const int k = i / GN, n = i % GN, gk = k0 + k, gn = n0 + n;
      b_s[k * GBS + n] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : zero;
    }
    __syncthreads();
    uint32_t af[4];
    ldmatrix_x4(af, a_s + (16 * warp + l_row) * GAS + l_col);
#pragma unroll
    for (int np = 0; np < GN / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b_s + l_row * GBS + 16 * np + l_col);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
    __syncthreads();
  }
  // element e of n-tile nt: row 16*warp + g + 8*(e/2), column 8*nt + 2t + e%2
#pragma unroll
  for (int nt = 0; nt < GN / 8; ++nt) {
    const int col = n0 + 8 * nt + 2 * t;
    if (col >= N) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + 16 * warp + g + 8 * half;
      if (row >= M) continue;
      const size_t at = (size_t)row * N + col;
      if constexpr (OUT_BF16)
        store2(static_cast<__nv_bfloat16*>(out) + at, acc[nt][2 * half], acc[nt][2 * half + 1]);
      else
        store2(static_cast<float*>(out) + at, acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
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

// Family 1, gather: y (d0, d1, d2, d3) contiguous; chan (d3,) f32 or null.
// vec selects 16-byte accesses (the caller checked contiguity and alignment).
int probe_gather(int is_bf16, const void* x, void* y, int d0, int d1, int d2, int d3,
                 long long s0, long long s1, long long s2, long long s3, long long base,
                 const void* chan, float a, float b, int affine, int vec, void* stream) {
  if (d0 < 1 || d1 < 1 || d2 < 1 || d3 < 1 || affine < kCopy || affine > kScaleAdd)
    return (int)cudaErrorInvalidValue;
  const GatherMap m = {{d0, d1, d2, d3}, {s0, s1, s2, s3}, base};
  const long long n = (long long)d0 * d1 * d2 * d3;
  const int width = vec ? (is_bf16 ? 8 : 4) : 1;
  if (d3 % width != 0) return (int)cudaErrorInvalidValue;
  const long long groups = n / width;
  const int threads = 256;
  const unsigned blocks = (unsigned)((groups + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ch = static_cast<const float*>(chan);
  if (is_bf16) {
    const auto* xi = static_cast<const __nv_bfloat16*>(x);
    auto* yo = static_cast<__nv_bfloat16*>(y);
    if (vec)
      gather_kernel<__nv_bfloat16, 8><<<blocks, threads, 0, st>>>(xi, yo, m, ch, a, b, affine,
                                                                   groups);
    else
      gather_kernel<__nv_bfloat16, 1><<<blocks, threads, 0, st>>>(xi, yo, m, ch, a, b, affine,
                                                                   groups);
  } else {
    const auto* xi = static_cast<const float*>(x);
    auto* yo = static_cast<float*>(y);
    if (vec)
      gather_kernel<float, 4><<<blocks, threads, 0, st>>>(xi, yo, m, ch, a, b, affine, groups);
    else
      gather_kernel<float, 1><<<blocks, threads, 0, st>>>(xi, yo, m, ch, a, b, affine, groups);
  }
  return (int)cudaGetLastError();
}

// Family 1, transpose: y (C, R) = x (R, C)^T, bf16.
int probe_transpose(const void* x, void* y, int R, int C, void* stream) {
  if (R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + TT - 1) / TT, (R + TT - 1) / TT);
  transpose_kernel<<<grid, dim3(TT, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), R, C);
  return (int)cudaGetLastError();
}

// Family 2: out (M, N) = A . B with B (K, N) and A (M, K), or (K, M) when
// a_trans; bf16 operands, f32 sums, out f32 or (out_bf16) bf16. N even.
int probe_gemm(const void* a, const void* b, void* out, int M, int N, int K, int a_trans,
               int out_bf16, void* stream) {
  if (M < 1 || N < 2 || N % 2 != 0 || K < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* B = static_cast<const __nv_bfloat16*>(b);
  if (a_trans && out_bf16)
    gemm_kernel<true, true><<<grid, 128, 0, st>>>(A, B, out, M, N, K);
  else if (a_trans)
    gemm_kernel<true, false><<<grid, 128, 0, st>>>(A, B, out, M, N, K);
  else if (out_bf16)
    gemm_kernel<false, true><<<grid, 128, 0, st>>>(A, B, out, M, N, K);
  else
    gemm_kernel<false, false><<<grid, 128, 0, st>>>(A, B, out, M, N, K);
  return (int)cudaGetLastError();
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
