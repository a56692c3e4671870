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
// matches the reference formulation bit for bit.
//
// What bounds it on this card: 2*9*Cin*Cout operations a pixel against
// (Cin + Cout) activation bytes and the 9*Cin*Cout weight bytes: at the
// serving clip's shapes hundreds to thousands of operations a byte, above
// the ~590 op/B ridge of the int8 tensor cores at the larger widths and
// below it at Cin = Cout = 64, so both bounds matter; chip_smoke.py prints
// the larger one for every shape.
//
// Design: an implicit GEMM, M = pixels, N = Cout, K = 9*Cin, on
// mma.sync m16n8k32 s8*s8 -> s32. A block owns (sample, 8x16 pixel tile,
// TN = 128 output channels, or 64 where Cout is not a multiple of 128). It
// walks Cin in chunks of 64: the chunk's input tile with its 1-pixel halo
// is read from device memory, quantized on load (so no int8 copy of the
// activation is ever written) and kept in shared memory; then the nine taps
// each multiply a (128 pixels) x (TN channels) slice of it by a (TN x 64)
// weight slice. A tap is a short product, so the weight slices stream
// through a ring of NSTAGE buffers with cp.async, NSTAGE - 1 (chunk, tap)
// steps ahead. The quantization takes the product with the reciprocal of s
// and falls back to the IEEE division only next to a half-integer, where
// the two could round apart. The 8 warps split the tile 4 (pixel rows) x 2
// (channel halves). Any H and W are taken (ragged tiles are masked); Cin
// and Cout must be multiples of 64. wgmma and TMA are later work.

#include "sm90_common.cuh"

namespace {

constexpr int TH = 8;             // pixel tile rows
constexpr int TW = 16;            // pixel tile columns (one m16 tile a row)
constexpr int HT = TH + 2;        // input tile rows (1-pixel halo)
constexpr int WT = TW + 2;        // input tile columns
constexpr int NPOS = HT * WT;     // 180 input positions
constexpr int KC = 64;            // input channels a chunk
constexpr int AS = KC + 16;       // 80-byte rows: 16-byte aligned, conflict-free ldmatrix
constexpr int WS = KC + 16;
constexpr int NSTAGE = 4;         // weight slices in flight
constexpr int NTHREADS = 256;
constexpr int WARPS_M = 4;                  // warps along the pixel rows
constexpr int MT = TH / WARPS_M;            // m16 tiles (tile rows) a warp (2)

template <int TN>
constexpr size_t smem_bytes() {
  return (size_t)NPOS * AS + (size_t)NSTAGE * TN * WS;
}

// 4 consecutive values as f32 (8- or 16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// quant_level as the low byte of an int.
__device__ __forceinline__ uint32_t quant_byte(float v, float s, float r) {
  return static_cast<uint32_t>(quant_level(v, s, r)) & 0xffu;
}

// Start copying the weight slice of (tap, input chunk) for this block's
// output channels: shared row n holds wq[tap][co0 + n][ci0 .. ci0 + KC).
template <int TN>
__device__ __forceinline__ void load_w_slice(int8_t* w_buf, const int8_t* __restrict__ wq,
                                             int Cin, int Cout, int tap, int ci0, int co0) {
  for (int i = threadIdx.x; i < TN * (KC / 16); i += NTHREADS) {
    const int n = i / (KC / 16), chunk = i % (KC / 16);
    cp_async16(w_buf + n * WS + 16 * chunk,
               wq + ((size_t)tap * Cout + co0 + n) * Cin + ci0 + 16 * chunk);
  }
  cp_async_commit();
}

// x, y: (B, H, W, Cin) and (B, H, W, Cout) in T.  absmax: one f32 (device).
// wq: (9, Cout, Cin) int8, tap = 3*di + dj.  ksc, bias: (Cout,) f32; bias
// may be null.
template <typename T, int TN>
__global__ void __launch_bounds__(NTHREADS)
int8_conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ absmax,
                    const int8_t* __restrict__ wq, const float* __restrict__ ksc,
                    const float* __restrict__ bias, T* __restrict__ y, int H, int W, int Cin,
                    int Cout) {
  constexpr int NT = TN / 8 / 2;  // n8 tiles a warp
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* a_s = reinterpret_cast<int8_t*>(smem);  // [NPOS][AS]
  int8_t* w_s = a_s + NPOS * AS;                   // NSTAGE x [TN][WS]

  const int tiles_w = (W + TW - 1) / TW;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * TN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane / 4, t = lane % 4;
  const float s = int8_scale(*absmax);
  const float rs = __frcp_rn(s);

  // ldmatrix row addresses of this lane (bytes; an int8 k32 step is 32 bytes)
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_k = 16 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16);
  const int b_k = 16 * ((lane / 8) % 2);

  int acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0;

  const int nsteps = (Cin / KC) * 9;
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < nsteps)
      load_w_slice<TN>(w_s + i * TN * WS, wq, Cin, Cout, i % 9, (i / 9) * KC, co0);
    else
      cp_async_commit();  // an empty group keeps the group count uniform
  }
  for (int step = 0; step < nsteps; ++step) {
    const int tap = step % 9, ci0 = (step / 9) * KC;
    if (tap == 0) {
      // quantize this chunk's input tile on load; zero outside the image.
      // (The previous step's closing barrier freed a_s.)
      for (int i = tid; i < NPOS * (KC / 4); i += NTHREADS) {
        const int pos = i / (KC / 4), j = i % (KC / 4);
        const int r = r0 - 1 + pos / WT, c = c0 - 1 + pos % WT;
        uint32_t packed = 0;
        if (r >= 0 && r < H && c >= 0 && c < W) {
          float v[4];
          load4(x + (((size_t)b * H + r) * W + c) * Cin + ci0 + 4 * j, v);
          packed = quant_byte(v[0], s, rs) | (quant_byte(v[1], s, rs) << 8) |
                   (quant_byte(v[2], s, rs) << 16) | (quant_byte(v[3], s, rs) << 24);
        }
        *reinterpret_cast<uint32_t*>(a_s + pos * AS + 4 * j) = packed;
      }
    }
    const int ahead = step + NSTAGE - 1;
    if (ahead < nsteps)
      load_w_slice<TN>(w_s + (ahead % NSTAGE) * TN * WS, wq, Cin, Cout, ahead % 9,
                       (ahead / 9) * KC, co0);
    else
      cp_async_commit();
    cp_async_wait<NSTAGE - 1>();  // this step's weight slice has landed
    __syncthreads();  // ... for every thread (and so has the input tile)

    const int8_t* w_cur = w_s + (step % NSTAGE) * TN * WS;
    const int di = tap / 3, dj = tap % 3;
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      uint32_t afr[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int pos = (MT * wm + mi + di) * WT + a_row + dj;
        ldmatrix_x4(afr[mi], a_s + pos * AS + 32 * ks + a_k);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, w_cur + (8 * NT * wn + 16 * np + b_row) * WS + 32 * ks + b_k);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          mma_s8(acc[mi][2 * np], afr[mi], bfr[0], bfr[1]);
          mma_s8(acc[mi][2 * np + 1], afr[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // everyone is done with this slice (and tile) before refills
  }

  // accumulator element e of (m-tile mi, n-tile nt): pixel (tile row
  // MT*wm + mi, tile column g + 8*(e/2)), channel co0 + 8*(NT*wn + nt) + 2t + e%2
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int co = co0 + 8 * (NT * wn + nt) + 2 * t;
    const float sc0 = __fmul_rn(s, ksc[co]), sc1 = __fmul_rn(s, ksc[co + 1]);
    const float b0 = bias ? bias[co] : 0.f, b1 = bias ? bias[co + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int r = r0 + MT * wm + mi;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + g + 8 * half;
        if (r >= H || c >= W) continue;
        store2(y + (((size_t)b * H + r) * W + c) * Cout + co,
               dequant(acc[mi][nt][2 * half], sc0, b0), dequant(acc[mi][nt][2 * half + 1], sc1, b1));
      }
    }
  }
}

template <typename T, int TN>
cudaError_t launch(const void* x, const float* absmax, const int8_t* wq, const float* ksc,
                   const float* bias, void* y, int B, int H, int W, int Cin, int Cout,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<TN>();
  cudaError_t err = cudaFuncSetAttribute(int8_conv3x3_kernel<T, TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), Cout / TN, B);
  int8_conv3x3_kernel<T, TN><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), absmax, wq, ksc, bias, static_cast<T*>(y), H, W, Cin, Cout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the conv on `stream`; returns a cudaError_t (0 on success).
// is_bf16 selects bf16 (1) or f32 (0) for x and y.
int int8_conv3x3_forward(int is_bf16, const void* x, const void* absmax, const void* wq,
                         const void* ksc, const void* bias, void* y, int B, int H, int W,
                         int Cin, int Cout, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || Cin < KC || Cin % KC != 0 || Cout < 64 ||
      Cout % 64 != 0 || Cout / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* am = static_cast<const float*>(absmax);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(ksc);
  const float* bi = static_cast<const float*>(bias);
  const bool wide = Cout % 128 == 0;
  cudaError_t err;
  if (is_bf16)
    err = wide ? launch<__nv_bfloat16, 128>(x, am, w, sc, bi, y, B, H, W, Cin, Cout, s)
               : launch<__nv_bfloat16, 64>(x, am, w, sc, bi, y, B, H, W, Cin, Cout, s);
  else
    err = wide ? launch<float, 128>(x, am, w, sc, bi, y, B, H, W, Cin, Cout, s)
               : launch<float, 64>(x, am, w, sc, bi, y, B, H, W, Cin, Cout, s);
  return (int)err;
}

const char* int8_conv3x3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
