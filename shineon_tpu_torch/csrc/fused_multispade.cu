// Fused MultiSPADE modulation chain for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of shineon_tpu/ops/fused_spade.py:
// _make_kernel, launched by _fused_forward, with quant=False (kernel 1) and
// quant=True (kernel 2). For each label l in sorted order:
//   hidden_l = act(conv3x3(segmap_l, wsh_l) + bsh_l), zero outside the image,
//              rounded to the compute dtype, act one of relu, gelu (tanh
//              form), swish and sine = sin(30 v) (a template parameter of
//              every body, chosen by the entry points' `act` code);
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
// bits of |h| (valid: they are >= 0; gelu, swish and sine go negative), and
// the chain reads the result. In
// bf16 the hidden map is rounded as the plain version rounds it (the conv's
// sum, then its sum with the bias: hidden_value), so both quantize the same
// values. h / s_l is rounded exactly as an IEEE division (quant_level,
// sm90_common.cuh, shared with the int8 conv), and the dequantization
// products and bias sum are round-to-nearest (__fmul_rn, __fadd_rn), never
// contracted.
//
// Blocking: the TPU kernel keeps the whole image's segmaps and every
// label's gamma/beta weights (18.9 MB in bf16 at C=1024, L=4) resident in
// 100 MB of VMEM. A Hopper block has 227 KB, so this kernel blocks over
// space AND output channels, which is exact because gamma_l[c] and beta_l[c]
// only modulate x[..., c]. One block owns (sample, 8x16 pixel tile, 64
// channels). Per label it recomputes the tile's 128-channel hidden map with
// a 1-pixel halo into shared memory (9*8*128 MACs a hidden position against
// 9*128*128 a pixel for the block's gamma/beta), then streams the label's
// weights one 3x3 tap (a 128 x 128 slice: 32 KB in bf16, 16 KB in int8) at
// a time through shared memory, accumulating gamma and beta in registers.
// x stays in registers across labels and y is written once. Any H and W are
// taken (ragged tiles are masked); C must be a multiple of 64 (the wrapper
// zero-pads other widths); a label may have any number of segmap channels.
//
// The bf16 serving bodies (chain_kernel_bf16, chain_kernel_q_bf16; design
// at chain_wgmma below) run the gamma/beta conv on wgmma (m64n128k16 bf16,
// or m64n128k32 s8, A from registers, B a 128-byte-swizzled slice image in
// shared memory) with warp specialisation: a producer lane keeps a ring of
// 4 (bf16) or 6 (int8) slices in flight by bulk async copies on mbarriers,
// two consumer warpgroups compute. The hidden conv runs on mma.sync
// straight from a segmap tile padded to 8 channels a label (no im2col); the
// pre-pass takes the same code. The f32 bodies, kept for parity checks, are
// the first design: scalar FMAs for the hidden map, its segmap read from
// global memory (and, unquantized, gamma/beta), mma.sync s8 for the
// quantized gamma/beta conv from a cp.async ring.
//
// What bounds it on this card: each pixel and label costs 2*9*128*2C
// operations of gamma/beta product against ~4 bytes a channel of x/y
// traffic, thousands of operations a byte, far above the H100's ridge (~295
// FLOP/B in bf16, ~590 op/B in int8): the kernel is bound by operations in
// device memory terms. Its weight slices come from L2: a slice serves a
// block's 128 pixels, 128 FLOP a byte of L2 traffic in bf16 (256 int8 ops a
// byte in int8), so the tensor cores at their peak would draw about 7.7
// TB/s from L2 in either type, beyond what the L2 delivers: at 256x192,
// C=128, L=4, batch 4 the slices are 3.6 GB a call. Two blocks of a cluster
// sharing each slice by multicast halved that and measured slower on an
// H100 (PERF.md): each pair waited on its slowest warpgroup at every
// refill. With the products on wgmma, the kernel is held by what runs
// beside them: the slice stream, the hidden conv (recomputed for each
// 64-channel tile) and, quantized, its quantizing epilogue.

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
constexpr int NTHREADS = 256;
constexpr int CPT = 8;                   // channels a thread
constexpr int NCG = TC / CPT;            // channel groups (8)
constexpr int NPG = NTHREADS / NCG;      // pixel groups (32)
constexpr int PX = TH * TW / NPG;        // pixels a thread (4)

struct ChainArgs {
  int H, W, C, L, cs_tot;
  int tiles_w;   // pixel tiles along W
  int segs_tot;  // 8-channel segments of the bf16 segmap operand, all labels
  int seg_buf;   // segments a bf16 body's segmap buffer holds
  int cs[MAX_L];
  int cs_off[MAX_L];
  int nseg[MAX_L];     // segments of each label: ceil(cs / 8)
  int seg_off[MAX_L];  // its first segment
};

__device__ __forceinline__ float to_f(float v) { return v; }

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
// The hidden activations (ops/fused_spade.py::ACTIVATIONS holds the same
// codes): relu, gelu in its tanh form (jax.nn.gelu's default), swish v *
// sigmoid(v), sine sin(30 v). Full-range tanhf, expf and sinf, never the
// fast intrinsics: 30 v reaches tens of radians, where __sinf's error grows.
enum Act { ACT_RELU = 0, ACT_GELU = 1, ACT_SWISH = 2, ACT_SINE = 3 };

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  static_assert(ACT >= ACT_RELU && ACT <= ACT_SINE, "no such activation");
  if constexpr (ACT == ACT_RELU)
    return fmaxf(v, 0.f);
  else if constexpr (ACT == ACT_GELU)
    return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  else if constexpr (ACT == ACT_SWISH)  // v * sigmoid(v), as the plain version takes it
    return v * __frcp_rn(1.f + expf(-v));
  else
    return sinf(30.f * v);
}

// The value of a hidden position: act(conv + bias) from the conv's f32 sum.
// Full precision keeps that f32 value (the bf16 relu chain rounds it once
// as it stores the tile). The quantized chain and its pre-pass in bf16, and
// the bf16 chain with any other activation, round as the chain's plain
// version (and flax's bf16 conv) does: the conv's sum to bf16, plus the
// bias in bf16, rounded again, the activation of that value, rounded again
// (relu of a bf16 value is one). So kernel and plain version take the
// activation of the same inputs, and quantize the same hidden values,
// wherever their f32 sums round alike, and the pre-pass's abs-max is the one
// the chain divides by.
// v rounded to bf16 (nearest, ties to even) and back, for finite v, in
// integer operations: the same value as __float2bfloat16_rn, without the
// conversion unit, which the quantized chain's epilogue would saturate.
__device__ __forceinline__ float round_bf16(float v) {
  uint32_t u = __float_as_uint(v);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

template <bool ROUND_BF16, int ACT>
__device__ __forceinline__ float hidden_value(float acc, float bias) {
  if (!ROUND_BF16) return activate<ACT>(acc + bias);
  const float v = round_bf16(round_bf16(acc) + round_bf16(bias));
  return ACT == ACT_RELU ? fmaxf(v, 0.f) : round_bf16(activate<ACT>(v));
}

// Where the hidden conv puts its values: each policy gives the value of a
// position (hidden) and takes it at hidden position p, channel k (put, put2).
template <int HS, int ACT>
struct HidStoreF32 {  // f32 chain: the f32 tile [HT*WT][HS]
  float* h;
  static __device__ __forceinline__ float hidden(float acc, float bias) {
    return hidden_value<false, ACT>(acc, bias);
  }
  __device__ __forceinline__ void put(int p, int k, float v) { h[p * HS + k] = v; }
};

template <int HS, int ACT>
struct HidStoreBf16 {  // bf16 chain: the bf16 tile [HT*WT][HS]
  __nv_bfloat16* h;
  static __device__ __forceinline__ float hidden(float acc, float bias) {
    return hidden_value<ACT != ACT_RELU, ACT>(acc, bias);
  }
  __device__ __forceinline__ void put2(int p, int k, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(h + p * HS + k) = __floats2bfloat162_rn(v0, v1);
  }
};

template <bool BF16, int HS, int ACT>
struct HidQuant {  // quantized chain: the int8 tile [HT*WT][HS], scale s = 1 / r
  int8_t* h;
  float s, r;
  static __device__ __forceinline__ float hidden(float acc, float bias) {
    return hidden_value<BF16, ACT>(acc, bias);
  }
  __device__ __forceinline__ void put(int p, int k, float v) {
    h[p * HS + k] = static_cast<int8_t>(quant_level(v, s, r));
  }
  // quant_level in full-rate arithmetic: clip(y, -127, 127) rounds to
  // nearest even as y + 1.5 * 2^23 (whose low byte is then the level), the
  // same integer as rintf and then the clip; near a half-integer, from the
  // IEEE quotient, as quant_level.
  static __device__ __forceinline__ float shifted(float y) {
    return __fadd_rn(fminf(fmaxf(y, -127.f), 127.f), 12582912.f);
  }
  __device__ __forceinline__ int8_t level(float v) const {
    const float y = v * r;
    float t = shifted(y);
    const float q = __fadd_rn(t, -12582912.f);
    if (fabsf(fabsf(fminf(fmaxf(y, -127.f), 127.f) - q) - 0.5f) < 1e-4f)
      t = shifted(__fdiv_rn(v, s));
    return static_cast<int8_t>(__float_as_int(t) & 0xFF);
  }
  __device__ __forceinline__ void put2(int p, int k, float v0, float v1) {
    *reinterpret_cast<char2*>(h + p * HS + k) = make_char2(level(v0), level(v1));
  }
};

template <bool BF16, int ACT>
struct HidMax {  // pre-pass: this thread's max |v|
  float m;
  static __device__ __forceinline__ float hidden(float acc, float bias) {
    return hidden_value<BF16, ACT>(acc, bias);
  }
  __device__ __forceinline__ void put(int, int, float v) { m = fmaxf(m, fabsf(v)); }
  __device__ __forceinline__ void put2(int, int, float v0, float v1) {
    m = fmaxf(m, fmaxf(fabsf(v0), fabsf(v1)));
  }
};

// f32 path: hidden tile of label l into `out` with scalar FMAs: hidden
// (hr, hc) is image pixel (r0-1+hr, c0-1+hc); Out::hidden of the conv's sum
// and the bias, zero outside the image (the reference zero-pads the hidden
// map). The segmap is read from global memory (seg (B, H, W, cs_tot) f32),
// so a label may have any number of channels; taps outside the image add
// nothing to the sum.
template <typename Out>
__device__ __forceinline__ void compute_hidden_f32(Out& out, const float* __restrict__ seg,
                                                   const float* __restrict__ wsh,
                                                   const float* __restrict__ bsh,
                                                   const ChainArgs& args, int l, int b, int r0,
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
        const int sr = ir - 1 + di;
        if (sr < 0 || sr >= args.H) continue;
        for (int dj = 0; dj < 3; ++dj) {
          const int sc = ic - 1 + dj;
          if (sc < 0 || sc >= args.W) continue;
          const float* sp =
              seg + (((size_t)b * args.H + sr) * args.W + sc) * args.cs_tot + args.cs_off[l];
          const float* wp = wl + (size_t)((di * 3 + dj) * cs) * NHID + k;
          for (int ci = 0; ci < cs; ++ci) acc = fmaf(__ldg(sp + ci), __ldg(wp + ci * NHID), acc);
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
  return sizeof(float) * ((size_t)HT * WT * HS_F32 + NHID * 2 * TC);
}

template <int ACT>
__global__ void __launch_bounds__(NTHREADS, 1)
chain_kernel_f32(const float* __restrict__ x, const float* __restrict__ ab,
                 const float* __restrict__ seg, const float* __restrict__ wsh,
                 const float* __restrict__ bsh, const float* __restrict__ wgb,
                 const float* __restrict__ bgb, float* __restrict__ y, const ChainArgs args) {
  constexpr int HS = HS_F32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* h_s = reinterpret_cast<float*>(smem);  // [HT*WT][HS]
  float* w_s = h_s + HT * WT * HS;              // [NHID][2*TC]

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
    HidStoreF32<HS, ACT> hid{h_s};
    compute_hidden_f32(hid, seg, wsh, bsh, args, l, b, r0, c0);

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
    __syncthreads();  // the hidden tile is free for the next label
  }

#pragma unroll
  for (int j = 0; j < PX; ++j)
    if (valid[j]) store8(y + xoff[j], xr[j]);
}

// ------------------------------------- f32 quantized chain: mma.sync fragments
constexpr int WARPS = NTHREADS / 32;
constexpr int WARPS_M = 4;         // warps along the pixel rows of the tile
constexpr int MT = TH / WARPS_M;   // m16 tiles (tile rows) a warp (2)
constexpr int NPAIR = TC / 8 / (WARPS / WARPS_M);  // gamma/beta n-tile pairs a warp (4)

// The f32 quantized chain's mma.sync layout of a thread's accumulators:
// element e of (m-tile mi, gamma/beta pair pi) is
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

// ------------------------------------------------ bf16 serving bodies (wgmma)
// chain_kernel_bf16 (kernel 1) and chain_kernel_q_bf16 (kernel 2) share one
// body, chain_wgmma<QUANT, ACT> (ACT: the hidden activation):
//  * 384 threads: two consumer warpgroups (warps 0-7) and a producer
//    warpgroup, one lane of which issues the copies. Warpgroup w owns tile
//    rows 4w..4w+3, its warp q tile row 4w+q: the 64 rows of the
//    warpgroup's products are 4 x 16 pixels.
//  * Each tap's [gamma | beta] weight slice is one contiguous, pre-swizzled
//    image (pack_weights), copied by one bulk copy. The ring has NST
//    stages with a full and an empty mbarrier each; a stage is refilled
//    once all 8 consumer warps have released it.
//  * Hidden conv (per label, mma.sync m16n8k16): the segmap is padded to
//    segments of SEG_C = 8 channels, ceil(cs / 8) a label, 16 bytes a
//    position, so each 8-element k-half of A (k = seg*KH + tap*8 + ci) is
//    one segmap position of one segment at a tap's offset in the segmap
//    tile, read straight by ldmatrix: no im2col. The hidden weights (one
//    (128, KH) block a segment) come from global memory into registers.
//    Each consumer warpgroup computes the 6 hidden rows its taps read (rows
//    4-5 by both) behind its own named barrier, so that one warpgroup's
//    hidden conv overlaps the other's taps, and the next label's segmap rows
//    load during the current label's taps. The segmap buffer holds up to
//    SEG_GROUP segments; a label of more is streamed through it in groups,
//    reloaded for each pass of the hidden conv (any cs is taken).
//  * [gamma | beta] conv (per tap, wgmma m64n128, A from registers): A is
//    the hidden tile shifted by the tap, whose 8-row groups sit at uneven
//    strides (+8 positions, then +WT), so no descriptor names it; each
//    warp's 16 rows are one tile row, contiguous, loaded by ldmatrix. B is
//    the slice through a 128-byte-swizzle descriptor. Columns 0..63 of the
//    product are gamma, 64..127 beta: thread (g, t) of warp q holds gamma
//    and beta of channels 8i + 2t (+1), i = 0..7, at pixels g and g + 8 of
//    its tile row, and the modulation runs in registers.
constexpr int CONSUMERS = 256;             // two consumer warpgroups
constexpr int NTHREADS_WG = CONSUMERS + 128;  // and a producer warpgroup
constexpr int SEG_C = 8;                   // segmap channels a segment
constexpr int SEG_GROUP = 4;               // segments a segmap buffer holds at most
constexpr int KH = (9 * SEG_C + 15) / 16 * 16;  // hidden-conv depth a segment (80)
constexpr int HS_BF16 = NHID + 8;          // 272-byte rows: conflict-free ldmatrix
constexpr int HSQ = NHID + 16;             // 144-byte int8 rows
constexpr int SLICE_B = 2 * TC * NHID * 2;  // bytes of a bf16 slice image (32 KB)
constexpr int SLICE_Q8 = 2 * TC * NHID;     // bytes of an int8 slice image (16 KB)
constexpr int NST_B = 4;                   // ring stages, bf16
constexpr int NST_Q8 = 6;                  // ring stages, int8
constexpr int SEG_TILE_BYTES = ST * SWT * SEG_C * 2;  // the pre-pass's segmap tile, a segment
constexpr int NH_WG = 4 + 2;  // hidden rows a consumer warpgroup computes (4 + halo)
constexpr int SEG_WG = (NH_WG + 2) * SWT * SEG_C;  // elements of a warpgroup's segmap rows

// Who loads a label's segmap rows into a segmap buffer: the NT threads of
// this thread's group (a warpgroup or the block), synchronised on named
// barrier 1 + group, for sample blockIdx.z. Read from the special
// registers where used, to hold no registers across the chain.
template <int NT>
struct SegLoader {
  const __nv_bfloat16* __restrict__ seg;  // (B, H, W, SEG_C * segs_tot)
  static constexpr int n = NT;
  __device__ __forceinline__ int tid() const { return threadIdx.x % NT; }
  __device__ __forceinline__ int bar() const { return 1 + threadIdx.x / NT; }
  __device__ __forceinline__ int b() const { return blockIdx.z; }
};

// Segmap rows of segments s0..s0+ns-1 of label l for hidden rows
// h0..h0+nh-1 of the tile: segmap tile rows h0..h0+nh+1 (image rows
// r0-2+h0 ..), bf16, SEG_C channels a position, into s_seg
// ([ns][(nh+2)*SWT][SEG_C]) by 16-byte cp.async, zero outside the image.
// Committed.
template <int NT>
__device__ __forceinline__ void load_seg_rows(__nv_bfloat16* s_seg, const SegLoader<NT>& ld,
                                              const ChainArgs& args, int l, int s0, int ns,
                                              int r0, int c0, int h0, int nh) {
  const size_t stride = (size_t)SEG_C * args.segs_tot;
  const int npos = (nh + 2) * SWT;
  const __nv_bfloat16* src = ld.seg + SEG_C * (args.seg_off[l] + s0);
  for (int i = ld.tid(); i < ns * npos; i += NT) {
    const int s = i / npos, pos = i % npos;
    const int sr = r0 - 2 + h0 + pos / SWT, sc = c0 - 2 + pos % SWT;
    const bool inside = sr >= 0 && sr < args.H && sc >= 0 && sc < args.W;
    const size_t at = inside ? ((size_t)ld.b() * args.H + sr) * args.W + sc : 0;
    cp_async16_zfill(s_seg + i * SEG_C, src + at * stride + SEG_C * s, inside);
  }
  cp_async_commit();
}

// The first group of label l's segments (what the buffer holds when its
// label has at most seg_buf of them).
template <int NT>
__device__ __forceinline__ void load_seg_group0(__nv_bfloat16* s_seg, const SegLoader<NT>& ld,
                                                const ChainArgs& args, int l, int r0, int c0,
                                                int h0, int nh) {
  load_seg_rows(s_seg, ld, args, l, 0, min(args.nseg[l], args.seg_buf), r0, c0, h0, nh);
}

// One pass of hidden_mma: hidden channels n0..n0+8*NJ-1. s_seg holds the
// label's first segments (load_seg_group0). MULTI (a label of more than one
// segment): the B fragments are loaded again for each segment, and a label
// of more than seg_buf segments is streamed through s_seg again here, a
// group at a time; else (one segment) the B fragments are loaded once.
template <int NJ, int MCH, bool MULTI, int NT, typename Out>
__device__ __forceinline__ void hidden_mma_pass(Out& out, __nv_bfloat16* s_seg,
                                                const SegLoader<NT>& ld,
                                                const __nv_bfloat16* __restrict__ wsh,
                                                const float* __restrict__ bsh,
                                                const ChainArgs& args, int l, int r0, int c0,
                                                int h0, int nh, int n0, int lane) {
  const int g = lane / 4, t = lane % 4;
  const int S = MULTI ? args.nseg[l] : 1, G = MULTI ? args.seg_buf : 1;
  const int seg_elems = (nh + 2) * SWT * SEG_C;  // a segment's rows in s_seg
  uint32_t bfr[KH / 16][NJ][2];
  auto load_b = [&](int s) {  // the weights of segment s of the label
    const __nv_bfloat16* wl = wsh + (size_t)(args.seg_off[l] + s) * NHID * KH;
#pragma unroll
    for (int ks = 0; ks < KH / 16; ++ks)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const __nv_bfloat16* w = wl + (size_t)(n0 + 8 * nj + g) * KH + 16 * ks + 2 * t;
        bfr[ks][nj][0] = __ldg(reinterpret_cast<const unsigned int*>(w));
        bfr[ks][nj][1] = __ldg(reinterpret_cast<const unsigned int*>(w + 8));
      }
  };
  if (!MULTI) load_b(0);
  float bias[NJ][2];
#pragma unroll
  for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[nj][e] = bsh[l * NHID + n0 + 8 * nj + 2 * t + e];

  const int npos = nh * WT;
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2), a_half = lane / 16;
  for (int m0 = 0; 16 * m0 < npos; m0 += MCH) {
    float acc[MCH][NJ][4];
    int base[MCH];  // segmap position of this lane's A row at tap (0, 0)
#pragma unroll
    for (int mi = 0; mi < MCH; ++mi) {
      const int p = min(16 * (m0 + mi) + a_row, npos - 1);
      base[mi] = (p / WT) * SWT + p % WT;
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    }
    for (int s0 = 0; s0 < S; s0 += G) {
      if (MULTI && S > G) {  // stream this group of segments through the buffer
        named_sync(ld.bar(), NT);  // every warp is done with the buffer
        load_seg_rows(s_seg, ld, args, l, s0, min(G, S - s0), r0, c0, h0, nh);
        cp_async_wait<0>();
        named_sync(ld.bar(), NT);
      }
      for (int s = s0; s < min(s0 + G, S); ++s) {
        if (MULTI) load_b(s);  // (one segment: loaded once, above)
        const __nv_bfloat16* sg = s_seg + (s - s0) * seg_elems;
#pragma unroll
        for (int ks = 0; ks < KH / 16; ++ks) {
          const int tap = min(2 * ks + a_half, 8);  // k >= 72: zero weights
          const int off = (tap / 3) * SWT + tap % 3;
#pragma unroll
          for (int mi = 0; mi < MCH; ++mi) {
            uint32_t afr[4];
            ldmatrix_x4(afr, sg + (base[mi] + off) * SEG_C);
#pragma unroll
            for (int nj = 0; nj < NJ; ++nj)
              mma_bf16(acc[mi][nj], afr, bfr[ks][nj][0], bfr[ks][nj][1]);
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MCH; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * (m0 + mi) + g + 8 * half;
        if (p >= npos) continue;
        const int ir = r0 - 1 + h0 + p / WT, ic = c0 - 1 + p % WT;
        const bool inside = ir >= 0 && ir < args.H && ic >= 0 && ic < args.W;
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) {
          float v0 = Out::hidden(acc[mi][nj][2 * half], bias[nj][0]);
          float v1 = Out::hidden(acc[mi][nj][2 * half + 1], bias[nj][1]);
          if (!inside) v0 = v1 = 0.f;
          out.put2(p, n0 + 8 * nj + 2 * t, v0, v1);
        }
      }
    }
  }
}

// Hidden rows h0..h0+nh-1 of the tile of label l on the tensor cores, read
// from s_seg (segmap rows h0..h0+nh+1, load_seg_group0), by NW warps: warp
// `warp` computes hidden channels (128/NW)*warp.. of the nh*WT positions
// (local position p = (hr - h0)*WT + hc; rows past them are clamped and
// dropped), then Out::hidden with the bias, zero outside the image, into
// `out` at p. Every warp of ld's barrier calls it.
template <int NW, int NT, typename Out>
__device__ __forceinline__ void hidden_mma(Out& out, __nv_bfloat16* s_seg, const SegLoader<NT>& ld,
                                           const __nv_bfloat16* __restrict__ wsh,
                                           const float* __restrict__ bsh, const ChainArgs& args,
                                           int l, int r0, int c0, int h0, int nh, int warp,
                                           int lane) {
  // a warp's 128/NW channels in passes of 16 (two n8 tiles), to bound the
  // registers the B fragments and sums hold beside the chain's own; a
  // label of several segments holds half the m16 tiles at once
  constexpr int NJ = 2, MCH = 4;  // n8 tiles a pass, m16 tiles held at once
  const bool multi = args.nseg[l] > 1;
  for (int pass = 0; pass < NHID / 16 / NW; ++pass) {
    const int n0 = 16 * (NHID / 16 / NW * warp + pass);
    if (multi)
      hidden_mma_pass<NJ, MCH / 2, true>(out, s_seg, ld, wsh, bsh, args, l, r0, c0, h0, nh, n0,
                                         lane);
    else
      hidden_mma_pass<NJ, MCH, false>(out, s_seg, ld, wsh, bsh, args, l, r0, c0, h0, nh, n0,
                                      lane);
  }
}

// Shared memory of a wgmma chain body: the weight ring (1024-byte aligned
// stages), each consumer warpgroup's hidden rows, the ring's barriers, each
// consumer warpgroup's segmap buffer of seg_buf segments (the next label's
// rows load into it during the current label's taps: the hidden conv that
// read it is done); plus slack to align the dynamic buffer's base to 1024
// bytes.
template <bool QUANT>
struct WgLayout {
  static constexpr int SLICE = QUANT ? SLICE_Q8 : SLICE_B;
  static constexpr int NST = QUANT ? NST_Q8 : NST_B;
  static constexpr int HROW = QUANT ? HSQ : 2 * HS_BF16;  // bytes a hidden position
  static constexpr size_t HID = (size_t)NST * SLICE;
  static constexpr size_t BARS = HID + 2 * (size_t)NH_WG * WT * HROW;  // a tile a warpgroup
  static constexpr size_t SEG = BARS + 2 * NST * sizeof(uint64_t);
  static constexpr size_t bytes(int seg_buf) {
    return SEG + 2 * (size_t)seg_buf * sizeof(__nv_bfloat16) * SEG_WG + 1024;
  }
};

// x <- (x * a + b) * (1 + gamma) + beta for label l from a wgmma
// accumulator (gamma in columns 0..63, beta in 64..127). xr[i][2*half + e]
// is channel ch0 + 8i + 2t + e at pixel column g + 8*half.
template <typename Acc>
__device__ __forceinline__ void modulate_wg(float (&xr)[8][4], const Acc (&acc)[64],
                                            const float* __restrict__ ab,
                                            const float* __restrict__ bgb,
                                            const float* __restrict__ sgb, float s,
                                            const ChainArgs& args, int l, int b, int ch) {
  const int C = args.C;
  const size_t twoC = 2 * (size_t)C;
  const float* abl = ab + ((size_t)b * args.L + l) * twoC;
  const float* bgl = bgb + (size_t)l * twoC;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = ch + 8 * i + e;
      const float a = abl[c], bb = abl[C + c], g0 = bgl[c], b0 = bgl[C + c];
      const float sg = sgb ? __fmul_rn(s, sgb[l * twoC + c]) : 0.f;
      const float sb = sgb ? __fmul_rn(s, sgb[l * twoC + C + c]) : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float gam = dequant(acc[4 * i + 2 * half + e], sg, g0);
        const float bet = dequant(acc[4 * (i + 8) + 2 * half + e], sb, b0);
        float& v = xr[i][2 * half + e];
        v = (v * a + bb) * (1.f + gam) + bet;
      }
    }
  }
}

// The bf16 serving chain, full precision (QUANT = false; wgb: bf16 slice
// images, sgb and absmax unused) or quantized (wgb: int8 slice images, sgb
// (L, 2C) weight scales, absmax (L,) from the pre-pass). x, y, seg, wsh
// bf16: seg (B, H, W, SEG_C * segs_tot), wsh (segs_tot, NHID, KH).
template <bool QUANT, int ACT>
__device__ __forceinline__ void chain_wgmma(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ ab,
    const __nv_bfloat16* __restrict__ seg, const __nv_bfloat16* __restrict__ wsh,
    const float* __restrict__ bsh, const unsigned char* __restrict__ wgb,
    const float* __restrict__ sgb, const float* __restrict__ bgb,
    const float* __restrict__ absmax, __nv_bfloat16* __restrict__ y, const ChainArgs& args) {
  using Lay = WgLayout<QUANT>;
  using Acc = typename std::conditional<QUANT, int, float>::type;
  constexpr int SLICE = Lay::SLICE, NST = Lay::NST, HROW = Lay::HROW;
  constexpr int KSTEPS = QUANT ? NHID / 32 : NHID / 16;  // 32-byte k-steps of a tap
  constexpr int KPART = 4;  // k-steps whose A fragments are held at once
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = smem;
  unsigned char* h_s = smem + Lay::HID;
  __nv_bfloat16* s_seg = reinterpret_cast<__nv_bfloat16*>(smem + Lay::SEG);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::BARS);
  uint64_t* empty = full + NST;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = (blockIdx.x / args.tiles_w) * TH;
  const int c0 = (blockIdx.x % args.tiles_w) * TW;
  const int ch0 = blockIdx.y * TC, b = blockIdx.z;
  const int nsteps = 9 * args.L;

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  // The two roles never reconverge. Of the 168 registers a thread of the
  // 384-thread launch, the producer warpgroup gives back 128 and the
  // consumers ask for 232 a thread (setmaxnreg); ptxas still budgets the
  // consumer code at 168, which the one-tap A fragments and the 16-channel
  // hidden passes keep free of spills. The producer may return early: the
  // consumers wait on every copy it issues.
  if (warp >= CONSUMERS / 32) {
    // producer: one lane streams every (label, tap) slice of the block's
    // channel tile
    setmaxnreg_dec<40>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      const unsigned char* src = wgb + (size_t)blockIdx.y * SLICE;
      const size_t step = (size_t)(args.C / TC) * SLICE;  // from one (label, tap) to the next
      for (int s = 0; s < nsteps; ++s) {
        const int st = s % NST;
        mbar_wait(&empty[st], ((s / NST) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], SLICE);
        bulk_copy(ring + st * SLICE, src + s * step, SLICE, &full[st]);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int wg = warp / 4, q = warp % 4, g = lane / 4, t = lane % 4;
    const int trow = 4 * wg + q;  // this warp's tile row
    const int r = r0 + trow, ch = ch0 + 2 * t;
    // this warpgroup's hidden rows 4wg..4wg+5 and segmap rows, its own
    unsigned char* h_wg = h_s + wg * NH_WG * WT * HROW;
    __nv_bfloat16* seg_wg = s_seg + wg * args.seg_buf * SEG_WG;
    const int h0 = 4 * wg;
    const SegLoader<128> ld{seg};
    load_seg_group0(seg_wg, ld, args, 0, r0, c0, h0, NH_WG);  // loads beside x
    float xr[8][4];
    bool valid[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = c0 + g + 8 * half;
      valid[half] = r < args.H && c < args.W;
      const __nv_bfloat16* xp = x + (((size_t)b * args.H + r) * args.W + c) * args.C + ch;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 v = valid[half] ? load2(xp + 8 * i) : make_float2(0.f, 0.f);
        xr[i][2 * half] = v.x;
        xr[i][2 * half + 1] = v.y;
      }
    }
    // ldmatrix row of this lane in the hidden tile, and its k-half in bytes
    const int a_row = (lane % 8) + 8 * ((lane / 8) % 2), a_k = 16 * (lane / 16);

    // the A fragments of k-steps k0..k0+KPART-1 of one tap from the hidden
    // tile (32 bytes of K a step)
    auto load_a = [&](uint32_t (&a)[KPART][4], int tap, int k0) {
      const unsigned char* arow = h_wg + ((q + tap / 3) * WT + a_row + tap % 3) * HROW + a_k;
#pragma unroll
      for (int ks = 0; ks < KPART; ++ks) ldmatrix_x4(a[ks], arow + 32 * (k0 + ks));
    };

    // The two warpgroups run apart: each computes its own hidden rows
    // (rows 4-5 twice) behind its own named barrier, so one's hidden conv
    // overlaps the other's taps; the ring lets them drift NST steps apart.
    for (int l = 0; l < args.L; ++l) {
      cp_async_wait<0>();
      named_sync(1 + wg, 128);  // segmap rows in; the warpgroup is done with the last taps
      float s = 0.f;
      if constexpr (QUANT) {
        s = int8_scale(absmax[l]);
        HidQuant<true, HSQ, ACT> hid{reinterpret_cast<int8_t*>(h_wg), s, __frcp_rn(s)};
        hidden_mma<4>(hid, seg_wg, ld, wsh, bsh, args, l, r0, c0, h0, NH_WG, q, lane);
      } else {
        HidStoreBf16<HS_BF16, ACT> hid{reinterpret_cast<__nv_bfloat16*>(h_wg)};
        hidden_mma<4>(hid, seg_wg, ld, wsh, bsh, args, l, r0, c0, h0, NH_WG, q, lane);
      }
      named_sync(1 + wg, 128);  // hidden rows complete; the segmap buffer is free
      if (l + 1 < args.L)  // the next label's segmap rows load during the taps
        load_seg_group0(seg_wg, ld, args, l + 1, r0, c0, h0, NH_WG);

      // A tap's products run in parts of KPART k-steps, each waiting for its
      // own (wait_group 0) before the next part's A fragments overwrite the
      // registers they read: 16 registers of A at a time. (A second set, to
      // keep two taps in flight, measured no faster and spills.)
      Acc acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      for (int tap = 0; tap < 9; ++tap) {
        const int step = 9 * l + tap, st = step % NST;
        const unsigned char* slice = ring + st * SLICE;
#pragma unroll
        for (int k0 = 0; k0 < KSTEPS; k0 += KPART) {
          uint32_t afr[KPART][4];
          load_a(afr, tap, k0);
          if (k0 == 0) mbar_wait(&full[st], (step / NST) & 1);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KPART; ++kk) {
            // bf16: K-halves of 64 (16 KB apart), k16 steps of 32 bytes in a
            // 128-byte row; int8: one 128-byte row, k32 steps of 32 bytes
            const int ks = k0 + kk;
            const uint64_t desc =
                wgmma_desc_sw128(slice + (ks / 4) * (SLICE / 2)) + 2 * (ks % 4);
            if constexpr (QUANT)
              wgmma_m64n128k32_s8_rs(acc, afr[kk], desc);
            else
              wgmma_m64n128k16_bf16_rs(acc, afr[kk], desc);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
#pragma unroll
          for (int kk = 0; kk < KPART; ++kk) fence_regs(afr[kk]);
        }
        if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the slice
      }
      modulate_wg(xr, acc, ab, bgb, QUANT ? sgb : nullptr, s, args, l, b, ch);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!valid[half]) continue;
      __nv_bfloat16* yp = y + (((size_t)b * args.H + r) * args.W + c0 + g + 8 * half) * args.C + ch;
#pragma unroll
      for (int i = 0; i < 8; ++i) store2(yp + 8 * i, xr[i][2 * half], xr[i][2 * half + 1]);
    }
  }
}

template <int ACT>
__global__ void __launch_bounds__(NTHREADS_WG, 1)
chain_kernel_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ab,
                  const __nv_bfloat16* __restrict__ seg, const __nv_bfloat16* __restrict__ wsh,
                  const float* __restrict__ bsh, const unsigned char* __restrict__ wgb,
                  const float* __restrict__ bgb, __nv_bfloat16* __restrict__ y,
                  const ChainArgs args) {
  chain_wgmma<false, ACT>(x, ab, seg, wsh, bsh, wgb, nullptr, bgb, nullptr, y, args);
}

template <int ACT>
__global__ void __launch_bounds__(NTHREADS_WG, 1)
chain_kernel_q_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ab,
                    const __nv_bfloat16* __restrict__ seg, const __nv_bfloat16* __restrict__ wsh,
                    const float* __restrict__ bsh, const unsigned char* __restrict__ wgb,
                    const float* __restrict__ sgb, const float* __restrict__ bgb,
                    const float* __restrict__ absmax, __nv_bfloat16* __restrict__ y,
                    const ChainArgs args) {
  chain_wgmma<true, ACT>(x, ab, seg, wsh, bsh, wgb, sgb, bgb, absmax, y, args);
}

// ----------------------------------------------- quantized path, f32 parity
// The hidden tile is quantized into int8 ([HT*WT][HSQ] bytes) as it is
// computed (scalar FMAs); the [gamma | beta] conv runs on mma.sync m16n8k32
// s8 -> s32 with ldmatrix fragments. The weight slice interleaves gamma and
// beta n-tiles (gamma channels 8p..8p+7, then beta channels 8p..8p+7), so
// one thread's accumulators hold gamma and beta of the same pixels and
// channels. The slices stream through a ring of NSTAGE_Q cp.async buffers,
// NSTAGE_Q - 1 (label, tap) steps ahead, across label boundaries.
// wgb: (L, 9, 2C, NHID) int8 (hidden index contiguous); sgb: (L, 2C) f32.
constexpr int WSQ = NHID + 16;
constexpr int NSTAGE_Q = 4;
constexpr int SLICE_Q = 2 * TC * WSQ;  // bytes of one slice buffer

template <typename T>
constexpr bool is_bf16_v = std::is_same<T, __nv_bfloat16>::value;

// Shared memory of the f32 quantized chain: int8 hidden tile, the ring of
// int8 weight slices.
constexpr size_t smem_q_f32() {
  return (size_t)HT * WT * HSQ + (size_t)NSTAGE_Q * SLICE_Q;
}

// Shared memory of the pre-pass: bf16, the segmap buffer of seg_buf
// segments; f32 none (the segmap is read from global memory).
template <typename T>
size_t smem_absmax(const ChainArgs& args) {
  return is_bf16_v<T> ? (size_t)args.seg_buf * SEG_TILE_BYTES : 0;
}

// Start copying one tap's int8 [gamma | beta] weight slice into w_buf:
// shared row n (0..2TC) holds output column (n/8 odd ? C : 0) + ch0 +
// 8*(n/16) + n%8, NHID bytes.
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
// caller). One block a (sample, pixel tile), all labels. bf16: the hidden
// conv of the bf16 chains (segmap padded to SEG_C channels, wsh (L, NHID,
// KH)); f32: the f32 chain's scalar one.
template <typename T, int ACT>
__global__ void __launch_bounds__(NTHREADS)
hidden_absmax_kernel(const T* __restrict__ seg, const T* __restrict__ wsh,
                     const float* __restrict__ bsh, float* __restrict__ absmax,
                     const ChainArgs args) {
  constexpr bool BF16 = is_bf16_v<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[NTHREADS / 32];
  const int tiles_w = (args.W + TW - 1) / TW;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int l = 0; l < args.L; ++l) {
    HidMax<BF16, ACT> hid{0.f};
    if constexpr (BF16) {
      __nv_bfloat16* s_seg = reinterpret_cast<__nv_bfloat16*>(smem);
      const SegLoader<NTHREADS> ld{seg};
      load_seg_group0(s_seg, ld, args, l, r0, c0, 0, HT);
      cp_async_wait<0>();
      __syncthreads();
      hidden_mma<NTHREADS / 32>(hid, s_seg, ld, wsh, bsh, args, l, r0, c0, 0, HT, warp, lane);
    } else {
      compute_hidden_f32(hid, seg, wsh, bsh, args, l, b, r0, c0);
    }
    float m = hid.m;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) red[warp] = m;
    __syncthreads();  // also: every warp is done with the segmap tile
    if (threadIdx.x == 0) {
      for (int w = 1; w < NTHREADS / 32; ++w) m = fmaxf(m, red[w]);
      // non-negative floats (m is a max of fabsf) order as their bit patterns do
      atomicMax(reinterpret_cast<int*>(absmax + l), __float_as_int(m));
    }
  }
}

// The f32 quantized chain. x, y, seg, wsh f32 (wsh per label (9, cs_l,
// NHID), flat). absmax: (L,) from the pre-pass.
template <int ACT>
__global__ void __launch_bounds__(NTHREADS, 1)
chain_kernel_q_f32(const float* __restrict__ x, const float* __restrict__ ab,
                   const float* __restrict__ seg, const float* __restrict__ wsh,
                   const float* __restrict__ bsh, const int8_t* __restrict__ wgb,
                   const float* __restrict__ sgb, const float* __restrict__ bgb,
                   const float* __restrict__ absmax, float* __restrict__ y,
                   const ChainArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* h_q = reinterpret_cast<int8_t*>(smem);  // [HT*WT][HSQ]
  int8_t* w_s = h_q + HT * WT * HSQ;              // NSTAGE_Q x [2*TC][WSQ]

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
    HidQuant<false, HSQ, ACT> hid{h_q, s, __frcp_rn(s)};
    compute_hidden_f32(hid, seg, wsh, bsh, args, l, b, r0, c0);

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

// The chain's shape arguments; false if the kernel does not take them.
// Each label may have any number of segmap channels (cs >= 1): the bf16
// bodies take them in 8-channel segments, seg_buf = min(max segments,
// SEG_GROUP) of them resident at once.
bool fill_args(ChainArgs& args, int B, int H, int W, int C, int L, const int* cs) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < TC || C % TC != 0 || L < 1 || L > MAX_L)
    return false;
  args.H = H;
  args.W = W;
  args.C = C;
  args.L = L;
  args.tiles_w = (W + TW - 1) / TW;
  for (int l = 0; l < MAX_L; ++l) args.cs[l] = args.cs_off[l] = args.nseg[l] = args.seg_off[l] = 0;
  int off = 0, soff = 0, smax = 0;
  for (int l = 0; l < L; ++l) {
    if (cs[l] < 1) return false;
    args.cs[l] = cs[l];
    args.cs_off[l] = off;
    args.nseg[l] = (cs[l] + SEG_C - 1) / SEG_C;
    args.seg_off[l] = soff;
    off += cs[l];
    soff += args.nseg[l];
    smax = max(smax, args.nseg[l]);
  }
  args.cs_tot = off;
  args.segs_tot = soff;
  args.seg_buf = min(smax, SEG_GROUP);
  return true;
}

dim3 chain_grid(int B, const ChainArgs& args, int channel_tiles) {
  return dim3(((args.H + TH - 1) / TH) * args.tiles_w, channel_tiles, B);
}

// Launch a chain body on the (pixel tiles, channel tiles, B) grid with
// `threads` threads a block: NTHREADS (f32 parity kernels, the pre-pass)
// or NTHREADS_WG (the wgmma bodies). A refused launch (too much shared
// memory) returns its error.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), size_t smem, dim3 grid, int threads,
                   cudaStream_t stream, Args... a) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a...);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;

// f(std::integral_constant<int, ACT>) for the activation code `act`; an
// unknown code is an invalid value.
template <typename F>
cudaError_t with_act(int act, F f) {
  switch (act) {
    case ACT_RELU: return f(std::integral_constant<int, ACT_RELU>());
    case ACT_GELU: return f(std::integral_constant<int, ACT_GELU>());
    case ACT_SWISH: return f(std::integral_constant<int, ACT_SWISH>());
    case ACT_SINE: return f(std::integral_constant<int, ACT_SINE>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the chain on `stream`; returns a cudaError_t (0 on success).
// is_bf16 selects the bf16 serving kernel (x, y bf16; seg (B, H, W, 8S)
// bf16, S the labels' 8-channel segments, ceil(cs_l / 8) a label; wsh
// (S, NHID, KH) bf16; wgb the slice images) or the f32 parity
// kernel (f32 operands in the f32 layout). act is the hidden activation's
// code (Act). cs holds the L labels' segmap channel counts (host memory).
int multispade_chain_forward(int is_bf16, int act, const void* x, const void* ab, const void* seg,
                             const void* wsh, const void* bsh, const void* wgb,
                             const void* bgb, void* y, int B, int H, int W, int C, int L,
                             const int* cs, void* stream) {
  ChainArgs args;
  if (!fill_args(args, B, H, W, C, L, cs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* abf = static_cast<const float*>(ab);
  const float* bshf = static_cast<const float*>(bsh);
  const float* bgbf = static_cast<const float*>(bgb);
  const dim3 grid = chain_grid(B, args, C / TC);
  return (int)with_act(act, [&](auto a) {
    constexpr int ACT = decltype(a)::value;
    return is_bf16
               ? launch(chain_kernel_bf16<ACT>, WgLayout<false>::bytes(args.seg_buf), grid,
                        NTHREADS_WG, s, static_cast<const bf16*>(x), abf,
                        static_cast<const bf16*>(seg), static_cast<const bf16*>(wsh), bshf,
                        static_cast<const unsigned char*>(wgb), bgbf, static_cast<bf16*>(y),
                        args)
               : launch(chain_kernel_f32<ACT>, smem_f32(), grid, NTHREADS, s,
                        static_cast<const float*>(x), abf, static_cast<const float*>(seg),
                        static_cast<const float*>(wsh), bshf, static_cast<const float*>(wgb),
                        bgbf, static_cast<float*>(y), args);
  });
}

// Pre-pass of the quantized chain: zeroes absmax (L f32, device) and fills
// it with max |hidden_l| over the batch. is_bf16 selects seg's and wsh's
// dtype and layout (and the hidden conv), and act the activation, as for
// the chain.
int multispade_hidden_absmax(int is_bf16, int act, const void* seg, const void* wsh, const void* bsh,
                             void* absmax, int B, int H, int W, int L, const int* cs,
                             void* stream) {
  ChainArgs args;
  if (!fill_args(args, B, H, W, TC, L, cs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(absmax, 0, sizeof(float) * L, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = chain_grid(B, args, 1);
  const float* bshf = static_cast<const float*>(bsh);
  float* am = static_cast<float*>(absmax);
  return (int)with_act(act, [&](auto a) {
    constexpr int ACT = decltype(a)::value;
    return is_bf16 ? launch(hidden_absmax_kernel<bf16, ACT>, smem_absmax<bf16>(args), grid,
                            NTHREADS, s, static_cast<const bf16*>(seg),
                            static_cast<const bf16*>(wsh), bshf, am, args)
                   : launch(hidden_absmax_kernel<float, ACT>, smem_absmax<float>(args), grid,
                            NTHREADS, s, static_cast<const float*>(seg),
                            static_cast<const float*>(wsh), bshf, am, args);
  });
}

// The quantized chain: as multispade_chain_forward, with wgb int8 (bf16:
// the int8 slice images; f32: (L, 9, 2C, NHID)), sgb (L, 2C) f32 weight
// scales and absmax from the pre-pass.
int multispade_chain_forward_int8(int is_bf16, int act, const void* x, const void* ab, const void* seg,
                                  const void* wsh, const void* bsh, const void* wgb,
                                  const void* sgb, const void* bgb, const void* absmax,
                                  void* y, int B, int H, int W, int C, int L, const int* cs,
                                  void* stream) {
  ChainArgs args;
  if (!fill_args(args, B, H, W, C, L, cs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* abf = static_cast<const float*>(ab);
  const float* bshf = static_cast<const float*>(bsh);
  const float* sgbf = static_cast<const float*>(sgb);
  const float* bgbf = static_cast<const float*>(bgb);
  const float* am = static_cast<const float*>(absmax);
  const dim3 grid = chain_grid(B, args, C / TC);
  return (int)with_act(act, [&](auto a) {
    constexpr int ACT = decltype(a)::value;
    return is_bf16
               ? launch(chain_kernel_q_bf16<ACT>, WgLayout<true>::bytes(args.seg_buf), grid,
                        NTHREADS_WG, s, static_cast<const bf16*>(x), abf,
                        static_cast<const bf16*>(seg), static_cast<const bf16*>(wsh), bshf,
                        static_cast<const unsigned char*>(wgb), sgbf, bgbf, am,
                        static_cast<bf16*>(y), args)
               : launch(chain_kernel_q_f32<ACT>, smem_q_f32(), grid, NTHREADS, s,
                        static_cast<const float*>(x), abf, static_cast<const float*>(seg),
                        static_cast<const float*>(wsh), bshf, static_cast<const int8_t*>(wgb),
                        sgbf, bgbf, am, static_cast<float*>(y), args);
  });
}

const char* multispade_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
