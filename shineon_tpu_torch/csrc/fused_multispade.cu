// Fused MultiSPADE modulation chain for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of shineon_tpu/ops/fused_spade.py:
// _make_kernel, launched by _fused_forward, with quant=False (kernel 1) and
// quant=True (kernel 2). For each label l in sorted order:
//   hidden_l = relu(conv3x3(segmap_l, wsh_l) + bsh_l), zero outside the image,
//              rounded to the compute dtype;
//   [gamma_l | beta_l] = conv3x3(hidden_l, wgb_l) + bgb_l;
//   x <- (x * a_l + b_l) * (1 + gamma_l) + beta_l          (x carried in f32)
// Like the TPU kernel, it reads x and writes y and nothing else of activation
// size: the hidden maps and gamma/beta never leave the block.
//
// Quantized (kernel 2): the gamma/beta conv runs in int8 with int32 sums.
//   s_l = absmax_l / 127 + 1e-30,  q = clip(rint(hidden_l / s_l), -127, 127),
//   [gamma_l | beta_l] = acc * (s_l * sgb_l[c]) + bgb_l[c]
// with int8 weights wgb_l (scale sgb_l per output channel). absmax_l is
// max |hidden_l| over the WHOLE batch tensor (one scale a label, as the JAX
// package's XLA int8 formulation takes it; the TPU kernel body takes one a
// 32-row tile instead). That is a grid-wide dependency, so a pre-pass
// (hidden_absmax_kernel) recomputes each label's hidden map with the same
// device code the chain uses, reduces max |h| with an atomicMax on the float
// bits (valid: the values are >= 0), and the chain reads the result. In
// bf16 the hidden map is rounded as the plain version rounds it (the conv's
// sum, then its sum with the bias: hidden_value), so both quantize the same
// values. h / s_l is rounded exactly as an IEEE division (quant_level,
// sm90_common.cuh, shared with the int8 conv), and the dequantization
// products and bias sum are round-to-nearest (__fmul_rn, __fadd_rn), never
// contracted.
//
// What bounds it on this card: each pixel and label costs 2*9*128*2C
// operations of gamma/beta product against ~4 bytes a channel of x/y
// traffic, thousands of operations a byte, far above the H100's ridge (~295
// FLOP/B in bf16, ~590 op/B in int8): the kernel is bound by operations. In
// bf16, the serving dtype, both convolutions run on the tensor cores: the
// hidden-map conv as an im2col GEMM (mma.sync m16n8k16, f32 accumulation),
// the gamma/beta conv as one GEMM a tap (m16n8k16 bf16 or, quantized,
// m16n8k32 s8 with s32 accumulation), with the taps' weight slices streamed
// through shared memory by cp.async (two buffers in bf16, a ring of four in
// int8) so the next slices load while the current one computes. The f32 path, kept for parity checks, computes
// the hidden map with scalar FMAs (and, unquantized, gamma/beta too). wgmma
// and TMA are later work.
//
// Design: the TPU kernel keeps the whole image's segmaps and every label's
// gamma/beta weights (18.9 MB in bf16 at C=1024, L=4) resident in 100 MB of
// VMEM. A Hopper block has 227 KB, so this kernel blocks over space AND
// output channels, which is exact because gamma_l[c] and beta_l[c] only
// modulate x[..., c]. One block owns (sample, 8x16 pixel tile, 64 channels).
// Per label it recomputes the tile's 128-channel hidden map with a 1-pixel
// halo into shared memory (about 9*cs*128 MACs a pixel against 9*128*128 for
// the block's gamma/beta), then streams the label's weights one 3x3 tap (a
// 128 x 128 slice: 32 KB in bf16, 16 KB in int8) at a time through shared
// memory, accumulating gamma and beta in registers. x stays in registers
// across labels and y is written once. Any H and W are taken (ragged tiles
// are masked); C must be a multiple of 64.

#include <type_traits>

#include "sm90_common.cuh"

namespace {

constexpr int NHID = 128;     // hidden width of the SPADE MLP
constexpr int TH = 8;         // pixel tile rows
constexpr int TW = 16;        // pixel tile columns
constexpr int TC = 64;        // output channels a block
constexpr int HT = TH + 2;    // hidden tile rows (1-pixel halo)
constexpr int WT = TW + 2;    // hidden tile columns
constexpr int ST = TH + 4;    // segmap tile rows (2-pixel halo)
constexpr int SWT = TW + 4;   // segmap tile columns
constexpr int MAX_L = 8;      // labels
constexpr int MAX_CS = 8;     // segmap channels of one label
constexpr int NTHREADS = 256;
constexpr int CPT = 8;                   // channels a thread
constexpr int NCG = TC / CPT;            // channel groups (8)
constexpr int NPG = NTHREADS / NCG;      // pixel groups (32)
constexpr int PX = TH * TW / NPG;        // pixels a thread (4)

struct ChainArgs {
  int H, W, C, L, cs_tot;
  int kp;  // bf16 path: hidden-conv depth 9*max(cs) padded to a multiple of 16
  int cs[MAX_L];
  int cs_off[MAX_L];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// 8 consecutive floats (32-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&o)[CPT]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[CPT]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
// Segmap tile of label l into s_s ([ST*SWT][cs] floats): image rows
// r0-2 .. r0+TH+1, columns c0-2 .. c0+TW+1, zero outside the image.
template <typename T>
__device__ __forceinline__ void load_segmap_tile(float* s_s, const T* __restrict__ seg,
                                                 const ChainArgs& args, int l, int b,
                                                 int r0, int c0) {
  const int cs = args.cs[l];
  for (int i = threadIdx.x; i < ST * SWT * cs; i += NTHREADS) {
    const int ci = i % cs, pos = i / cs;
    const int sr = r0 - 2 + pos / SWT, sc = c0 - 2 + pos % SWT;
    float v = 0.f;
    if (sr >= 0 && sr < args.H && sc >= 0 && sc < args.W)
      v = to_f(seg[(((size_t)b * args.H + sr) * args.W + sc) * args.cs_tot + args.cs_off[l] + ci]);
    s_s[i] = v;
  }
}

// The value of a hidden position: relu(conv + bias) from the conv's f32 sum.
// Full precision keeps that f32 value (the bf16 chain rounds it once as it
// stores the tile). The quantized chain and its pre-pass in bf16 round as
// the chain's plain version (and flax's bf16 conv) does: the conv's sum to
// bf16, plus the bias in bf16, rounded again. So kernel and plain version
// quantize the same hidden values wherever their f32 sums round alike, and
// the pre-pass's abs-max is the one the chain divides by.
template <bool ROUND_BF16>
__device__ __forceinline__ float hidden_value(float acc, float bias) {
  if (!ROUND_BF16) return fmaxf(acc + bias, 0.f);
  const float v = __bfloat162float(__float2bfloat16_rn(acc)) +
                  __bfloat162float(__float2bfloat16_rn(bias));
  return fmaxf(__bfloat162float(__float2bfloat16_rn(v)), 0.f);
}

// Where the hidden conv puts its values: each policy gives the value of a
// position (hidden) and takes it at hidden position p, channel k (put, put2).
template <int HS>
struct HidStoreF32 {  // f32 chain: the f32 tile [HT*WT][HS]
  float* h;
  static __device__ __forceinline__ float hidden(float acc, float bias) {
    return hidden_value<false>(acc, bias);
  }
  __device__ __forceinline__ void put(int p, int k, float v) { h[p * HS + k] = v; }
};

template <int HS>
struct HidStoreBf16 {  // bf16 chain: the bf16 tile [HT*WT][HS]
  __nv_bfloat16* h;
  static __device__ __forceinline__ float hidden(float acc, float bias) {
    return hidden_value<false>(acc, bias);
  }
  __device__ __forceinline__ void put2(int p, int k, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(h + p * HS + k) = __floats2bfloat162_rn(v0, v1);
  }
};

template <bool BF16, int HS>
struct HidQuant {  // quantized chain: the int8 tile [HT*WT][HS], scale s = 1 / r
  int8_t* h;
  float s, r;
  static __device__ __forceinline__ float hidden(float acc, float bias) {
    return hidden_value<BF16>(acc, bias);
  }
  __device__ __forceinline__ void put(int p, int k, float v) {
    h[p * HS + k] = static_cast<int8_t>(quant_level(v, s, r));
  }
  __device__ __forceinline__ void put2(int p, int k, float v0, float v1) {
    *reinterpret_cast<char2*>(h + p * HS + k) = make_char2(
        static_cast<int8_t>(quant_level(v0, s, r)), static_cast<int8_t>(quant_level(v1, s, r)));
  }
};

template <bool BF16>
struct HidMax {  // pre-pass: this thread's max |v|
  float m;
  static __device__ __forceinline__ float hidden(float acc, float bias) {
    return hidden_value<BF16>(acc, bias);
  }
  __device__ __forceinline__ void put(int, int, float v) { m = fmaxf(m, fabsf(v)); }
  __device__ __forceinline__ void put2(int, int, float v0, float v1) {
    m = fmaxf(m, fmaxf(fabsf(v0), fabsf(v1)));
  }
};

// f32 path: hidden tile of label l into `out` with scalar FMAs: hidden
// (hr, hc) is image pixel (r0-1+hr, c0-1+hc); Out::hidden of the conv's sum
// and the bias, zero outside the image (the reference zero-pads the hidden
// map).
template <typename Out>
__device__ __forceinline__ void compute_hidden_f32(Out& out, const float* s_s,
                                                   const float* __restrict__ wsh,
                                                   const float* __restrict__ bsh,
                                                   const ChainArgs& args, int l, int r0,
                                                   int c0) {
  const int cs = args.cs[l];
  const int k = threadIdx.x % NHID;
  const float* wl = wsh + (size_t)9 * NHID * args.cs_off[l];
  const float bias = bsh[l * NHID + k];
  for (int pos = threadIdx.x / NHID; pos < HT * WT; pos += NTHREADS / NHID) {
    const int hr = pos / WT, hc = pos % WT;
    const int ir = r0 - 1 + hr, ic = c0 - 1 + hc;
    float v = 0.f;
    if (ir >= 0 && ir < args.H && ic >= 0 && ic < args.W) {
      float acc = 0.f;
      for (int di = 0; di < 3; ++di) {
        for (int dj = 0; dj < 3; ++dj) {
          const float* sp = s_s + ((hr + di) * SWT + (hc + dj)) * cs;
          const float* wp = wl + (size_t)((di * 3 + dj) * cs) * NHID + k;
          for (int ci = 0; ci < cs; ++ci) acc = fmaf(sp[ci], __ldg(wp + ci * NHID), acc);
        }
      }
      v = Out::hidden(acc, bias);
    }
    out.put(pos, k, v);
  }
}

// ---------------------------------------------------------------- f32 path
// Scalar FMAs. x, y: (B, H, W, C) f32.  ab: (B, L, 2C) f32 folded norm [a | b].
// seg: (B, H, W, cs_tot) f32, labels concatenated on channels.
// wsh: per label (9, cs_l, NHID) f32, labels concatenated (offset 9*NHID*cs_off).
// bsh: (L, NHID).  wgb: (L, 9, NHID, 2C), [gamma | beta] columns.  bgb: (L, 2C).
constexpr int HS_F32 = NHID + 1;  // odd row stride: a warp's pixels in distinct banks

constexpr size_t smem_f32() {
  return sizeof(float) * ((size_t)HT * WT * HS_F32 + NHID * 2 * TC + ST * SWT * MAX_CS);
}

__global__ void __launch_bounds__(NTHREADS, 1)
chain_kernel_f32(const float* __restrict__ x, const float* __restrict__ ab,
                 const float* __restrict__ seg, const float* __restrict__ wsh,
                 const float* __restrict__ bsh, const float* __restrict__ wgb,
                 const float* __restrict__ bgb, float* __restrict__ y, const ChainArgs args) {
  constexpr int HS = HS_F32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* h_s = reinterpret_cast<float*>(smem);  // [HT*WT][HS]
  float* w_s = h_s + HT * WT * HS;              // [NHID][2*TC]
  float* s_s = w_s + NHID * 2 * TC;             // [ST*SWT][cs]

  const int H = args.H, W = args.W, C = args.C, L = args.L;
  const size_t twoC = 2 * (size_t)C;
  const int tiles_w = (W + TW - 1) / TW;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int ch0 = blockIdx.y * TC;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ch = ch0 + (tid % NCG) * CPT;  // this thread's first channel
  const int pg = tid / NCG;                // pixels pg + NPG*j of the tile

  bool valid[PX];
  size_t xoff[PX];
  int hoff[PX];
  float xr[PX][CPT];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int p = pg + NPG * j;
    const int r = r0 + p / TW, c = c0 + p % TW;
    valid[j] = r < H && c < W;
    xoff[j] = (((size_t)b * H + r) * W + c) * C + ch;
    hoff[j] = ((p / TW) * WT + (p % TW)) * HS;
    if (valid[j]) {
      load8(x + xoff[j], xr[j]);
    } else {
#pragma unroll
      for (int i = 0; i < CPT; ++i) xr[j][i] = 0.f;
    }
  }

  for (int l = 0; l < L; ++l) {
    load_segmap_tile(s_s, seg, args, l, b, r0, c0);
    __syncthreads();
    HidStoreF32<HS> hid{h_s};
    compute_hidden_f32(hid, s_s, wsh, bsh, args, l, r0, c0);

    float gam[PX][CPT], bet[PX][CPT];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        gam[j][i] = 0.f;
        bet[j][i] = 0.f;
      }
    }
    const float* wl = wgb + (size_t)l * 9 * NHID * twoC;
    for (int tap = 0; tap < 9; ++tap) {
      __syncthreads();  // hidden tile written / previous tap's slice consumed
      const float* wt = wl + (size_t)tap * NHID * twoC;
      for (int i = tid; i < NHID * 2 * TC / 4; i += NTHREADS) {
        const int e = i * 4;
        const int k = e / (2 * TC), jj = e % (2 * TC);
        const size_t col = jj < TC ? (size_t)ch0 + jj : (size_t)C + ch0 + (jj - TC);
        *reinterpret_cast<float4*>(w_s + e) =
            __ldg(reinterpret_cast<const float4*>(wt + k * twoC + col));
      }
      __syncthreads();
      const int toff = ((tap / 3) * WT + (tap % 3)) * HS;
      const float* ws = w_s + (ch - ch0);
#pragma unroll 4
      for (int k = 0; k < NHID; ++k) {
        float hv[PX];
#pragma unroll
        for (int j = 0; j < PX; ++j) hv[j] = h_s[hoff[j] + toff + k];
        float wg[CPT], wb[CPT];
        load8(ws + k * 2 * TC, wg);
        load8(ws + k * 2 * TC + TC, wb);
#pragma unroll
        for (int j = 0; j < PX; ++j) {
#pragma unroll
          for (int i = 0; i < CPT; ++i) {
            gam[j][i] = fmaf(hv[j], wg[i], gam[j][i]);
            bet[j][i] = fmaf(hv[j], wb[i], bet[j][i]);
          }
        }
      }
    }

    // ---- x <- (x * a + b) * (1 + gamma) + beta
    const float* abl = ab + ((size_t)b * L + l) * twoC;
    const float* bgl = bgb + (size_t)l * twoC;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float a = abl[ch + i], bb = abl[C + ch + i];
      const float g0 = bgl[ch + i], b0 = bgl[C + ch + i];
#pragma unroll
      for (int j = 0; j < PX; ++j)
        xr[j][i] = (xr[j][i] * a + bb) * (1.f + (gam[j][i] + g0)) + (bet[j][i] + b0);
    }
    __syncthreads();  // hidden and segmap tiles are free for the next label
  }

#pragma unroll
  for (int j = 0; j < PX; ++j)
    if (valid[j]) store8(y + xoff[j], xr[j]);
}

// --------------------------------------------------------------- bf16 path
// Tensor cores for both convolutions, mma.sync m16n8k16 bf16 -> f32 with
// ldmatrix fragments.
//  * hidden conv: an im2col GEMM per label, (192 = 180 hidden positions
//    padded) x (9*cs padded to kp) x (128 hidden channels);
//  * [gamma | beta] conv: per tap a (128 pixels) x (128 hidden) x (128 =
//    64 gamma + 64 beta columns) product. The 8 warps split it 4 (pixel
//    rows) x 2 (channel halves); each warp holds a 32 x 64 accumulator. The
//    weight slice in shared memory interleaves gamma and beta n-tiles
//    (gamma channels 8p..8p+7, then beta channels 8p..8p+7), so one thread's
//    accumulators hold gamma and beta of the same pixels and channels and
//    the modulation runs on them in registers. Weight slices are double
//    buffered with cp.async: the next tap's slice (and a label's first
//    slice, during its hidden conv) loads while the current one computes.
// x, y, seg: bf16.  wsh: (L, NHID, kp) bf16, k = tap*cs_l + ci, zero padded.
// wgb: (L, 9, 2C, NHID) bf16 (hidden index contiguous).
constexpr int HS_BF16 = NHID + 8;  // 272-byte rows: 16-byte aligned, conflict-free ldmatrix
constexpr int WS_BF16 = NHID + 8;
constexpr int KP_MAX = (9 * MAX_CS + 15) / 16 * 16;  // 80
constexpr int AS_MAX = KP_MAX + 8;                   // im2col row stride bound
constexpr int HM = (HT * WT + 15) / 16 * 16;         // hidden positions padded (192)
constexpr int WARPS = NTHREADS / 32;
constexpr int WARPS_M = 4;         // warps along the pixel rows of the tile
constexpr int MT = TH / WARPS_M;   // m16 tiles (tile rows) a warp (2)
constexpr int NPAIR = TC / 8 / (WARPS / WARPS_M);  // gamma/beta n-tile pairs a warp (4)
constexpr int HID_MCHUNK = 4;      // hidden-conv m-tiles a warp holds at once

// The chain bodies on the tensor cores (bf16, quantized) share one layout of
// a thread's accumulators: element e of (m-tile mi, gamma/beta pair pi) is
//   pixel (tile row MT*wm + mi, tile column g + 8*(e/2)),
//   channel chw + 8*pi + e%2,  chw = ch0 + 8*NPAIR*wn + 2*t
// (warp (wm, wn), mma group g, thread t in the group) in the block's
// (sample b, pixel tile at r0, c0, channels ch0..ch0+TC). x is carried in
// f32 registers of that layout across the labels.
struct Frag {
  int b, r0, c0, ch0, wm, wn, g, chw;
  static __device__ __forceinline__ Frag of_thread(const ChainArgs& args) {
    const int tiles_w = (args.W + TW - 1) / TW;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    Frag f;
    f.b = blockIdx.z;
    f.r0 = (blockIdx.x / tiles_w) * TH;
    f.c0 = (blockIdx.x % tiles_w) * TW;
    f.ch0 = blockIdx.y * TC;
    f.wm = warp % WARPS_M;
    f.wn = warp / WARPS_M;
    f.g = lane / 4;
    f.chw = f.ch0 + 8 * NPAIR * f.wn + 2 * (lane % 4);
    return f;
  }
  __device__ __forceinline__ int row(int mi) const { return r0 + MT * wm + mi; }
  __device__ __forceinline__ int col(int half) const { return c0 + g + 8 * half; }
};

template <typename T>
__device__ __forceinline__ void load_x_frag(float (&xr)[MT][NPAIR][4], bool (&valid)[MT][2],
                                            const T* __restrict__ x, const ChainArgs& args,
                                            const Frag& f) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = f.row(mi), c = f.col(half);
      valid[mi][half] = r < args.H && c < args.W;
#pragma unroll
      for (int pi = 0; pi < NPAIR; ++pi) {
        float2 v = make_float2(0.f, 0.f);
        if (valid[mi][half])
          v = load2(x + (((size_t)f.b * args.H + r) * args.W + c) * args.C + f.chw + 8 * pi);
        xr[mi][pi][2 * half] = v.x;
        xr[mi][pi][2 * half + 1] = v.y;
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_y_frag(T* __restrict__ y, const float (&xr)[MT][NPAIR][4],
                                             const bool (&valid)[MT][2], const ChainArgs& args,
                                             const Frag& f) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!valid[mi][half]) continue;
      const int r = f.row(mi), c = f.col(half);
#pragma unroll
      for (int pi = 0; pi < NPAIR; ++pi)
        store2(y + (((size_t)f.b * args.H + r) * args.W + c) * args.C + f.chw + 8 * pi,
               xr[mi][pi][2 * half], xr[mi][pi][2 * half + 1]);
    }
  }
}

// gamma or beta from its accumulator: an f32 sum takes its bias; an int32
// sum is dequantized (dequant, scale s * sgb[c]).
__device__ __forceinline__ float dequant(float acc, float, float bias) { return acc + bias; }

// x <- (x * a + b) * (1 + gamma) + beta for label l on the accumulators.
// sgb (the weight scales, (L, 2C)) and s (the label's activation scale)
// serve the quantized chain; the bf16 chain passes sgb = nullptr.
template <typename Acc>
__device__ __forceinline__ void modulate_frag(float (&xr)[MT][NPAIR][4],
                                              const Acc (&acc)[MT][2 * NPAIR][4],
                                              const float* __restrict__ ab,
                                              const float* __restrict__ bgb,
                                              const float* __restrict__ sgb, float s,
                                              const ChainArgs& args, int l, const Frag& f) {
  const int C = args.C;
  const size_t twoC = 2 * (size_t)C;
  const float* abl = ab + ((size_t)f.b * args.L + l) * twoC;
  const float* bgl = bgb + (size_t)l * twoC;
#pragma unroll
  for (int pi = 0; pi < NPAIR; ++pi) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int c = f.chw + 8 * pi + e2;
      const float a = abl[c], bb = abl[C + c], g0 = bgl[c], b0 = bgl[C + c];
      const float sg = sgb ? __fmul_rn(s, sgb[l * twoC + c]) : 0.f;
      const float sb = sgb ? __fmul_rn(s, sgb[l * twoC + C + c]) : 0.f;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 2 * half + e2;
          const float gam = dequant(acc[mi][2 * pi][e], sg, g0);
          const float bet = dequant(acc[mi][2 * pi + 1][e], sb, b0);
          float& v = xr[mi][pi][e];
          v = (v * a + bb) * (1.f + gam) + bet;
        }
      }
    }
  }
}

constexpr size_t smem_bf16() {
  return sizeof(__nv_bfloat16) *
             ((size_t)HT * WT * HS_BF16 + 2 * 2 * TC * WS_BF16 + (HM + NHID) * AS_MAX) +
         sizeof(float) * (size_t)(ST * SWT * MAX_CS);
}

// Start copying one tap's [gamma | beta] weight slice into w_buf: shared row
// n (0..2TC) holds output column (n/8 odd ? C : 0) + ch0 + 8*(n/16) + n%8.
__device__ __forceinline__ void load_gb_slice(__nv_bfloat16* w_buf,
                                              const __nv_bfloat16* __restrict__ wgb,
                                              const ChainArgs& args, int l, int tap, int ch0) {
  const size_t twoC = 2 * (size_t)args.C;
  const __nv_bfloat16* wt = wgb + ((size_t)l * 9 + tap) * twoC * NHID;
  for (int i = threadIdx.x; i < 2 * TC * (NHID / 8); i += NTHREADS) {
    const int n = i / (NHID / 8), chunk = i % (NHID / 8);
    const size_t col = ((n / 8) % 2 ? (size_t)args.C : 0) + ch0 + 8 * (n / 16) + n % 8;
    cp_async16(w_buf + n * WS_BF16 + 8 * chunk, wt + col * NHID + 8 * chunk);
  }
  cp_async_commit();
}

// Hidden tile of label l on the tensor cores: im2col of the segmap tile
// (a_s, [HM][kp+8]) times the label's hidden weights (b_s, [NHID][kp+8]),
// then Out::hidden with the bias, zero outside the image, into `out`.
template <typename Out>
__device__ __forceinline__ void hidden_mma(Out& out, __nv_bfloat16* a_s,
                                           __nv_bfloat16* b_s, const float* s_s,
                                           const __nv_bfloat16* __restrict__ wsh,
                                           const float* __restrict__ bsh,
                                           const ChainArgs& args, int l, int r0, int c0) {
  const int cs = args.cs[l], kp = args.kp, as = kp + 8, k9 = 9 * cs;
  for (int i = threadIdx.x; i < HM * kp; i += NTHREADS) {
    const int p = i / kp, k = i % kp;
    float v = 0.f;
    if (p < HT * WT && k < k9) {
      const int tap = k / cs, ci = k % cs;
      v = s_s[((p / WT + tap / 3) * SWT + p % WT + tap % 3) * cs + ci];
    }
    a_s[p * as + k] = __float2bfloat16(v);
  }
  const __nv_bfloat16* wl = wsh + (size_t)l * NHID * kp;
  for (int i = threadIdx.x; i < NHID * kp / 8; i += NTHREADS) {
    const int n = i / (kp / 8), chunk = i % (kp / 8);
    *reinterpret_cast<uint4*>(b_s + n * as + 8 * chunk) =
        __ldg(reinterpret_cast<const uint4*>(wl + (size_t)n * kp) + chunk);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2), a_k = 8 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16), b_k = 8 * ((lane / 8) % 2);
  const int n0 = 16 * warp;  // this warp's two n-tiles of the 128 hidden channels
  float bias[2][2];
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[nj][e] = bsh[l * NHID + n0 + 8 * nj + 2 * t + e];

  for (int m0 = 0; m0 < HM / 16; m0 += HID_MCHUNK) {
    float acc[HID_MCHUNK][2][4];
#pragma unroll
    for (int mi = 0; mi < HID_MCHUNK; ++mi)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    for (int ks = 0; ks < kp / 16; ++ks) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, b_s + (n0 + b_row) * as + 16 * ks + b_k);
#pragma unroll
      for (int mi = 0; mi < HID_MCHUNK; ++mi) {
        uint32_t afr[4];
        ldmatrix_x4(afr, a_s + (16 * (m0 + mi) + a_row) * as + 16 * ks + a_k);
        mma_bf16(acc[mi][0], afr, bfr[0], bfr[1]);
        mma_bf16(acc[mi][1], afr, bfr[2], bfr[3]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < HID_MCHUNK; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * (m0 + mi) + g + 8 * half;
        if (p >= HT * WT) continue;
        const int ir = r0 - 1 + p / WT, ic = c0 - 1 + p % WT;
        const bool inside = ir >= 0 && ir < args.H && ic >= 0 && ic < args.W;
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          float v0 = Out::hidden(acc[mi][nj][2 * half], bias[nj][0]);
          float v1 = Out::hidden(acc[mi][nj][2 * half + 1], bias[nj][1]);
          if (!inside) v0 = v1 = 0.f;
          out.put2(p, n0 + 8 * nj + 2 * t, v0, v1);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
chain_kernel_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ab,
                  const __nv_bfloat16* __restrict__ seg, const __nv_bfloat16* __restrict__ wsh,
                  const float* __restrict__ bsh, const __nv_bfloat16* __restrict__ wgb,
                  const float* __restrict__ bgb, __nv_bfloat16* __restrict__ y,
                  const ChainArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [HT*WT][HS_BF16]
  __nv_bfloat16* w_s = h_s + HT * WT * HS_BF16;                 // 2 x [2*TC][WS_BF16]
  __nv_bfloat16* a_s = w_s + 2 * 2 * TC * WS_BF16;              // [HM][kp+8]
  __nv_bfloat16* b_s = a_s + HM * AS_MAX;                       // [NHID][kp+8]
  float* s_s = reinterpret_cast<float*>(b_s + NHID * AS_MAX);   // [ST*SWT][cs]

  const Frag frag = Frag::of_thread(args);
  const int b = frag.b, r0 = frag.r0, c0 = frag.c0, ch0 = frag.ch0, wm = frag.wm, wn = frag.wn;
  const int L = args.L, lane = threadIdx.x % 32;

  float xr[MT][NPAIR][4];
  bool valid[MT][2];
  load_x_frag(xr, valid, x, args, frag);

  // ldmatrix row addresses of this lane
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2);  // pixel column in the m-tile
  const int a_k = 8 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16);       // row in a gamma/beta n-tile pair
  const int b_k = 8 * ((lane / 8) % 2);

  for (int l = 0; l < L; ++l) {
    load_gb_slice(w_s, wgb, args, l, 0, ch0);  // overlaps the hidden conv
    load_segmap_tile(s_s, seg, args, l, b, r0, c0);
    __syncthreads();
    HidStoreBf16<HS_BF16> hid{h_s};
    hidden_mma(hid, a_s, b_s, s_s, wsh, bsh, args, l, r0, c0);

    float acc[MT][2 * NPAIR][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int n = 0; n < 2 * NPAIR; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;

    for (int tap = 0; tap < 9; ++tap) {
      __nv_bfloat16* w_cur = w_s + (tap % 2) * 2 * TC * WS_BF16;
      if (tap + 1 < 9) {
        load_gb_slice(w_s + ((tap + 1) % 2) * 2 * TC * WS_BF16, wgb, args, l, tap + 1, ch0);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // this tap's slice (and, at tap 0, the hidden tile) visible to all
      const int di = tap / 3, dj = tap % 3;
#pragma unroll 2
      for (int ks = 0; ks < NHID / 16; ++ks) {
        uint32_t afr[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int pos = (MT * wm + mi + di) * WT + a_row + dj;
          ldmatrix_x4(afr[mi], h_s + pos * HS_BF16 + 16 * ks + a_k);
        }
#pragma unroll
        for (int pi = 0; pi < NPAIR; ++pi) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, w_cur + (16 * (NPAIR * wn + pi) + b_row) * WS_BF16 + 16 * ks + b_k);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma_bf16(acc[mi][2 * pi], afr[mi], bfr[0], bfr[1]);
            mma_bf16(acc[mi][2 * pi + 1], afr[mi], bfr[2], bfr[3]);
          }
        }
      }
      __syncthreads();  // everyone is done with w_cur before it is refilled
    }

    modulate_frag(xr, acc, ab, bgb, nullptr, 0.f, args, l, frag);
  }
  store_y_frag(y, xr, valid, args, frag);
}

// ---------------------------------------------------------- quantized path
// The hidden tile is quantized into int8 ([HT*WT][HSQ] bytes) as it is
// computed; the [gamma | beta] conv runs on mma.sync m16n8k32 s8 -> s32 with
// ldmatrix fragments (an int8 k32 step is 32 bytes, laid out as a bf16 k16
// step, so the bf16 path's fragment addressing carries over in bytes). The
// weight slice interleaves gamma and beta n-tiles as in the bf16 path. An
// int8 tap is half the bf16 tap's work, too short to hide one slice's load,
// so the slices stream through a ring of NSTAGE_Q buffers, NSTAGE_Q - 1
// (label, tap) steps ahead, across label boundaries.
// wgb: (L, 9, 2C, NHID) int8 (hidden index contiguous); sgb: (L, 2C) f32.
constexpr int HSQ = NHID + 16;  // 144-byte rows: 16-byte aligned, conflict-free ldmatrix
constexpr int WSQ = NHID + 16;
constexpr int NSTAGE_Q = 4;
constexpr int SLICE_Q = 2 * TC * WSQ;  // bytes of one slice buffer

template <typename T>
constexpr bool is_bf16_v = std::is_same<T, __nv_bfloat16>::value;

// Shared memory of the quantized chain: int8 hidden tile, the ring of int8
// weight slices, (bf16 only) the hidden conv's im2col operands, the segmap
// tile.
template <typename T>
constexpr size_t smem_q() {
  return (size_t)HT * WT * HSQ + (size_t)NSTAGE_Q * SLICE_Q +
         (is_bf16_v<T> ? sizeof(__nv_bfloat16) * (size_t)(HM + NHID) * AS_MAX : 0) +
         sizeof(float) * (size_t)(ST * SWT * MAX_CS);
}

// Shared memory of the pre-pass: the hidden conv's operands only.
template <typename T>
constexpr size_t smem_absmax() {
  return (is_bf16_v<T> ? sizeof(__nv_bfloat16) * (size_t)(HM + NHID) * AS_MAX : 0) +
         sizeof(float) * (size_t)(ST * SWT * MAX_CS);
}

// int8 counterpart of load_gb_slice: the same rows, NHID bytes each.
__device__ __forceinline__ void load_gb_slice_q(int8_t* w_buf, const int8_t* __restrict__ wgb,
                                                const ChainArgs& args, int l, int tap,
                                                int ch0) {
  const size_t twoC = 2 * (size_t)args.C;
  const int8_t* wt = wgb + ((size_t)l * 9 + tap) * twoC * NHID;
  for (int i = threadIdx.x; i < 2 * TC * (NHID / 16); i += NTHREADS) {
    const int n = i / (NHID / 16), chunk = i % (NHID / 16);
    const size_t col = ((n / 8) % 2 ? (size_t)args.C : 0) + ch0 + 8 * (n / 16) + n % 8;
    cp_async16(w_buf + n * WSQ + 16 * chunk, wt + col * NHID + 16 * chunk);
  }
  cp_async_commit();
}

// Pre-pass: absmax[l] = max |hidden_l| over the batch (absmax zeroed by the
// caller). One block a (sample, pixel tile), all labels.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
hidden_absmax_kernel(const T* __restrict__ seg, const T* __restrict__ wsh,
                     const float* __restrict__ bsh, float* __restrict__ absmax,
                     const ChainArgs args) {
  constexpr bool BF16 = is_bf16_v<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[NTHREADS / 32];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);  // bf16 only
  __nv_bfloat16* b_s = a_s + HM * AS_MAX;
  float* s_s = BF16 ? reinterpret_cast<float*>(b_s + NHID * AS_MAX)
                    : reinterpret_cast<float*>(smem);
  const int tiles_w = (args.W + TW - 1) / TW;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int l = 0; l < args.L; ++l) {
    load_segmap_tile(s_s, seg, args, l, b, r0, c0);
    __syncthreads();
    HidMax<BF16> hid{0.f};
    if constexpr (BF16)
      hidden_mma(hid, a_s, b_s, s_s, wsh, bsh, args, l, r0, c0);
    else
      compute_hidden_f32(hid, s_s, wsh, bsh, args, l, r0, c0);
    float m = hid.m;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) red[warp] = m;
    __syncthreads();  // also: every warp is done with s_s and the im2col operands
    if (threadIdx.x == 0) {
      for (int w = 1; w < NTHREADS / 32; ++w) m = fmaxf(m, red[w]);
      // non-negative floats order as their bit patterns do
      atomicMax(reinterpret_cast<int*>(absmax + l), __float_as_int(m));
    }
  }
}

// The quantized chain. x, y, seg, wsh in T (bf16: wsh (L, NHID, kp); f32:
// per label (9, cs_l, NHID), flat). absmax: (L,) from the pre-pass.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
chain_kernel_q(const T* __restrict__ x, const float* __restrict__ ab, const T* __restrict__ seg,
               const T* __restrict__ wsh, const float* __restrict__ bsh,
               const int8_t* __restrict__ wgb, const float* __restrict__ sgb,
               const float* __restrict__ bgb, const float* __restrict__ absmax,
               T* __restrict__ y, const ChainArgs args) {
  constexpr bool BF16 = is_bf16_v<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* h_q = reinterpret_cast<int8_t*>(smem);  // [HT*WT][HSQ]
  int8_t* w_s = h_q + HT * WT * HSQ;              // NSTAGE_Q x [2*TC][WSQ]
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(w_s + NSTAGE_Q * SLICE_Q);  // bf16 only
  __nv_bfloat16* b_s = a_s + HM * AS_MAX;
  float* s_s = BF16 ? reinterpret_cast<float*>(b_s + NHID * AS_MAX)
                    : reinterpret_cast<float*>(a_s);

  const Frag frag = Frag::of_thread(args);
  const int b = frag.b, r0 = frag.r0, c0 = frag.c0, ch0 = frag.ch0, wm = frag.wm, wn = frag.wn;
  const int L = args.L, lane = threadIdx.x % 32;

  float xr[MT][NPAIR][4];
  bool valid[MT][2];
  load_x_frag(xr, valid, x, args, frag);

  // ldmatrix row addresses of this lane, in bytes
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_k = 16 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16);
  const int b_k = 16 * ((lane / 8) % 2);

  // the ring's first NSTAGE_Q - 1 slices (they load during the first hidden conv)
  const int nsteps = 9 * L;
#pragma unroll
  for (int i = 0; i < NSTAGE_Q - 1; ++i) {
    if (i < nsteps)
      load_gb_slice_q(w_s + i * SLICE_Q, wgb, args, i / 9, i % 9, ch0);
    else
      cp_async_commit();  // an empty group keeps the group count uniform
  }

  for (int l = 0; l < L; ++l) {
    const float s = int8_scale(absmax[l]);
    load_segmap_tile(s_s, seg, args, l, b, r0, c0);
    __syncthreads();
    HidQuant<BF16, HSQ> hid{h_q, s, __frcp_rn(s)};
    if constexpr (BF16)
      hidden_mma(hid, a_s, b_s, s_s, wsh, bsh, args, l, r0, c0);
    else
      compute_hidden_f32(hid, s_s, wsh, bsh, args, l, r0, c0);

    int acc[MT][2 * NPAIR][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int n = 0; n < 2 * NPAIR; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0;

    for (int tap = 0; tap < 9; ++tap) {
      const int step = 9 * l + tap, ahead = step + NSTAGE_Q - 1;
      const int8_t* w_cur = w_s + (step % NSTAGE_Q) * SLICE_Q;
      if (ahead < nsteps)
        load_gb_slice_q(w_s + (ahead % NSTAGE_Q) * SLICE_Q, wgb, args, ahead / 9, ahead % 9, ch0);
      else
        cp_async_commit();
      cp_async_wait<NSTAGE_Q - 1>();  // this step's slice has landed
      __syncthreads();  // ... for every thread (and, at tap 0, the hidden tile)
      const int di = tap / 3, dj = tap % 3;
#pragma unroll
      for (int ks = 0; ks < NHID / 32; ++ks) {
        uint32_t afr[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int pos = (MT * wm + mi + di) * WT + a_row + dj;
          ldmatrix_x4(afr[mi], h_q + pos * HSQ + 32 * ks + a_k);
        }
#pragma unroll
        for (int pi = 0; pi < NPAIR; ++pi) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, w_cur + (16 * (NPAIR * wn + pi) + b_row) * WSQ + 32 * ks + b_k);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma_s8(acc[mi][2 * pi], afr[mi], bfr[0], bfr[1]);
            mma_s8(acc[mi][2 * pi + 1], afr[mi], bfr[2], bfr[3]);
          }
        }
      }
      __syncthreads();  // everyone is done with w_cur (and h_q) before refills
    }

    modulate_frag(xr, acc, ab, bgb, sgb, s, args, l, frag);
  }
  store_y_frag(y, xr, valid, args, frag);
}

template <typename T, typename WshT, typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, const void* x, const void* ab, const void* seg,
                   const void* wsh, const void* bsh, const void* wgb, const void* bgb, void* y,
                   int B, const ChainArgs& args, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((args.H + TH - 1) / TH) * ((args.W + TW - 1) / TW), args.C / TC, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ab), static_cast<const T*>(seg),
      static_cast<const WshT*>(wsh), static_cast<const float*>(bsh),
      static_cast<const T*>(wgb), static_cast<const float*>(bgb), static_cast<T*>(y), args);
  return cudaGetLastError();
}

// The chain's shape arguments; false if the kernel does not take them.
bool fill_args(ChainArgs& args, int B, int H, int W, int C, int L, const int* cs) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < TC || C % TC != 0 || L < 1 || L > MAX_L)
    return false;
  args.H = H;
  args.W = W;
  args.C = C;
  args.L = L;
  int off = 0;
  for (int l = 0; l < MAX_L; ++l) {
    args.cs[l] = 0;
    args.cs_off[l] = 0;
  }
  int max_cs = 0;
  for (int l = 0; l < L; ++l) {
    if (cs[l] < 1 || cs[l] > MAX_CS) return false;
    args.cs[l] = cs[l];
    args.cs_off[l] = off;
    off += cs[l];
    max_cs = cs[l] > max_cs ? cs[l] : max_cs;
  }
  args.cs_tot = off;
  args.kp = (9 * max_cs + 15) / 16 * 16;
  return true;
}

dim3 chain_grid(int B, const ChainArgs& args, int channel_tiles) {
  return dim3(((args.H + TH - 1) / TH) * ((args.W + TW - 1) / TW), channel_tiles, B);
}

template <typename T>
cudaError_t launch_absmax(const void* seg, const void* wsh, const void* bsh, void* absmax,
                          int B, const ChainArgs& args, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(absmax, 0, sizeof(float) * args.L, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_absmax<T>();
  err = cudaFuncSetAttribute(hidden_absmax_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  hidden_absmax_kernel<T><<<chain_grid(B, args, 1), NTHREADS, smem, stream>>>(
      static_cast<const T*>(seg), static_cast<const T*>(wsh), static_cast<const float*>(bsh),
      static_cast<float*>(absmax), args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_q(const void* x, const void* ab, const void* seg, const void* wsh,
                     const void* bsh, const void* wgb, const void* sgb, const void* bgb,
                     const void* absmax, void* y, int B, const ChainArgs& args,
                     cudaStream_t stream) {
  const size_t smem = smem_q<T>();
  cudaError_t err = cudaFuncSetAttribute(chain_kernel_q<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  chain_kernel_q<T><<<chain_grid(B, args, args.C / TC), NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ab), static_cast<const T*>(seg),
      static_cast<const T*>(wsh), static_cast<const float*>(bsh),
      static_cast<const int8_t*>(wgb), static_cast<const float*>(sgb),
      static_cast<const float*>(bgb), static_cast<const float*>(absmax), static_cast<T*>(y),
      args);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the chain on `stream`; returns a cudaError_t (0 on success).
// is_bf16 selects bf16 (1) or f32 (0) for x, y, seg and wgb. cs holds the L
// labels' segmap channel counts (host memory).
int multispade_chain_forward(int is_bf16, const void* x, const void* ab, const void* seg,
                             const void* wsh, const void* bsh, const void* wgb,
                             const void* bgb, void* y, int B, int H, int W, int C, int L,
                             const int* cs, void* stream) {
  ChainArgs args;
  if (!fill_args(args, B, H, W, C, L, cs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(chain_kernel_bf16, smem_bf16(), x, ab, seg,
                                                     wsh, bsh, wgb, bgb, y, B, args, s)
              : launch<float, float>(chain_kernel_f32, smem_f32(), x, ab, seg, wsh, bsh, wgb,
                                     bgb, y, B, args, s);
  return (int)err;
}

// Pre-pass of the quantized chain: zeroes absmax (L f32, device) and fills
// it with max |hidden_l| over the batch. is_bf16 selects seg's and wsh's
// dtype (and the hidden conv) as for the chain.
int multispade_hidden_absmax(int is_bf16, const void* seg, const void* wsh, const void* bsh,
                             void* absmax, int B, int H, int W, int L, const int* cs,
                             void* stream) {
  ChainArgs args;
  if (!fill_args(args, B, H, W, TC, L, cs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_absmax<__nv_bfloat16>(seg, wsh, bsh, absmax, B, args, s)
              : launch_absmax<float>(seg, wsh, bsh, absmax, B, args, s);
  return (int)err;
}

// The quantized chain: as multispade_chain_forward, with wgb int8 (L, 9,
// 2C, NHID), sgb (L, 2C) f32 weight scales and absmax from the pre-pass.
int multispade_chain_forward_int8(int is_bf16, const void* x, const void* ab, const void* seg,
                                  const void* wsh, const void* bsh, const void* wgb,
                                  const void* sgb, const void* bgb, const void* absmax,
                                  void* y, int B, int H, int W, int C, int L, const int* cs,
                                  void* stream) {
  ChainArgs args;
  if (!fill_args(args, B, H, W, C, L, cs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_q<__nv_bfloat16>(x, ab, seg, wsh, bsh, wgb, sgb, bgb, absmax, y, B,
                                        args, s)
              : launch_q<float>(x, ab, seg, wsh, bsh, wgb, sgb, bgb, absmax, y, B, args, s);
  return (int)err;
}

const char* multispade_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
