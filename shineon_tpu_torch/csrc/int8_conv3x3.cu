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
// mma.sync m16n8k32 s8*s8 -> s32, with the tile loop of conv3x3_tile.cuh
// (8x16-pixel tiles, 64- or 128-channel blocks, Cin in chunks of 64, the
// weight slices through a 4-deep cp.async ring), which the conv probe's
// tap-product kernels share. Its input stage reads the chunk's tile with
// its halo from x and quantizes it on load, so no int8 copy of the
// activation is ever written. The quantization takes the product with the
// reciprocal of s and falls back to the IEEE division only next to a
// half-integer, where the two could round apart. Any H and W are taken
// (ragged tiles are masked); Cin and Cout must be multiples of 64. wgmma
// and TMA are later work.

#include "conv3x3_tile.cuh"

namespace {

using namespace conv_tile;

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

template <typename T, int TN>
cudaError_t launch(const void* x, const float* absmax, const int8_t* wq, const float* ksc,
                   const float* bias, void* y, int B, int H, int W, int Cin, int Cout,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<int8_t, TN>();
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
