// Fused MultiSPADE modulation chain for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of shineon_tpu/ops/fused_spade.py:
// _make_kernel(quant=False), launched by _fused_forward. For each label l in
// sorted order:
//   hidden_l = relu(conv3x3(segmap_l, wsh_l) + bsh_l), zero outside the image,
//              rounded to the compute dtype;
//   [gamma_l | beta_l] = conv3x3(hidden_l, wgb_l) + bgb_l;
//   x <- (x * a_l + b_l) * (1 + gamma_l) + beta_l          (x carried in f32)
// Like the TPU kernel, it reads x and writes y and nothing else of activation
// size: the hidden maps and gamma/beta never leave the block.
//
// What bounds it on this card: each pixel and label costs 2*9*128*2C FLOPs
// of gamma/beta product against ~4 bytes a channel of x/y traffic, thousands
// of FLOPs a byte, far above the H100's ~295 FLOP/B ridge: the kernel is bound
// by operations. In bf16, the serving dtype, both convolutions run on the
// tensor cores (mma.sync m16n8k16, f32 accumulation): the hidden-map conv as
// an im2col GEMM, the gamma/beta conv as one GEMM a tap, with each tap's
// weight slice double buffered through shared memory by cp.async so the next
// slice loads while the current one computes. The f32 path, kept for parity
// checks, uses scalar FMAs for both convolutions. wgmma and TMA are later
// work.
//
// Design: the TPU kernel keeps the whole image's segmaps and every label's
// gamma/beta weights (18.9 MB in bf16 at C=1024, L=4) resident in 100 MB of
// VMEM. A Hopper block has 227 KB, so this kernel blocks over space AND
// output channels, which is exact because gamma_l[c] and beta_l[c] only
// modulate x[..., c]. One block owns (sample, 8x16 pixel tile, 64 channels).
// Per label it recomputes the tile's 128-channel hidden map with a 1-pixel
// halo into shared memory (about 9*cs*128 MACs a pixel against 9*128*128 for
// the block's gamma/beta), then streams the label's weights one 3x3 tap (a
// 128 x 128 slice) at a time through shared memory (two buffers in bf16),
// accumulating gamma and beta in registers. x stays in registers across labels and y is written
// once. Any H and W are taken (ragged tiles are masked); C must be a
// multiple of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// f32 path: hidden tile of label l into h_s ([HT*WT][HS] floats) with
// scalar FMAs: hidden (hr, hc) is image pixel (r0-1+hr, c0-1+hc);
// relu(conv3x3(segmap) + bias), zero outside the image (the reference
// zero-pads the hidden map).
template <int HS>
__device__ __forceinline__ void compute_hidden_f32(float* h_s, const float* s_s,
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
      float acc = bias;
      for (int di = 0; di < 3; ++di) {
        for (int dj = 0; dj < 3; ++dj) {
          const float* sp = s_s + ((hr + di) * SWT + (hc + dj)) * cs;
          const float* wp = wl + (size_t)((di * 3 + dj) * cs) * NHID + k;
          for (int ci = 0; ci < cs; ++ci) acc = fmaf(sp[ci], __ldg(wp + ci * NHID), acc);
        }
      }
      v = fmaxf(acc, 0.f);
    }
    h_s[pos * HS + k] = v;
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
    compute_hidden_f32<HS>(h_s, s_s, wsh, bsh, args, l, r0, c0);

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

constexpr size_t smem_bf16() {
  return sizeof(__nv_bfloat16) *
             ((size_t)HT * WT * HS_BF16 + 2 * 2 * TC * WS_BF16 + (HM + NHID) * AS_MAX) +
         sizeof(float) * (size_t)(ST * SWT * MAX_CS);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
// then bias, relu, zero outside the image, bf16, into h_s.
__device__ __forceinline__ void hidden_mma(__nv_bfloat16* h_s, __nv_bfloat16* a_s,
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
          float v0 = fmaxf(acc[mi][nj][2 * half] + bias[nj][0], 0.f);
          float v1 = fmaxf(acc[mi][nj][2 * half + 1] + bias[nj][1], 0.f);
          if (!inside) v0 = v1 = 0.f;
          *reinterpret_cast<__nv_bfloat162*>(h_s + p * HS_BF16 + n0 + 8 * nj + 2 * t) =
              __floats2bfloat162_rn(v0, v1);
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

  const int H = args.H, W = args.W, C = args.C, L = args.L;
  const size_t twoC = 2 * (size_t)C;
  const int tiles_w = (W + TW - 1) / TW;
  const int r0 = (blockIdx.x / tiles_w) * TH;
  const int c0 = (blockIdx.x % tiles_w) * TW;
  const int ch0 = blockIdx.y * TC;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane / 4, t = lane % 4;  // mma group and thread in group
  // accumulator element e of (m-tile mi, gamma/beta pair pi) is
  //   pixel (tile row MT*wm + mi, tile column g + 8*(e/2)),
  //   channel ch0 + 8*(NPAIR*wn + pi) + 2*t + e%2
  const int chw = ch0 + 8 * NPAIR * wn + 2 * t;

  float xr[MT][NPAIR][4];
  bool valid[MT][2];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + MT * wm + mi, c = c0 + g + 8 * half;
      valid[mi][half] = r < H && c < W;
#pragma unroll
      for (int pi = 0; pi < NPAIR; ++pi) {
        float2 v = make_float2(0.f, 0.f);
        if (valid[mi][half])
          v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              x + (((size_t)b * H + r) * W + c) * C + chw + 8 * pi));
        xr[mi][pi][2 * half] = v.x;
        xr[mi][pi][2 * half + 1] = v.y;
      }
    }
  }

  // ldmatrix row addresses of this lane
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2);  // pixel column in the m-tile
  const int a_k = 8 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16);       // row in a gamma/beta n-tile pair
  const int b_k = 8 * ((lane / 8) % 2);

  for (int l = 0; l < L; ++l) {
    load_gb_slice(w_s, wgb, args, l, 0, ch0);  // overlaps the hidden conv
    load_segmap_tile(s_s, seg, args, l, b, r0, c0);
    __syncthreads();
    hidden_mma(h_s, a_s, b_s, s_s, wsh, bsh, args, l, r0, c0);

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

    // ---- x <- (x * a + b) * (1 + gamma) + beta, on the accumulators
    const float* abl = ab + ((size_t)b * L + l) * twoC;
    const float* bgl = bgb + (size_t)l * twoC;
#pragma unroll
    for (int pi = 0; pi < NPAIR; ++pi) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int c = chw + 8 * pi + e2;
        const float a = abl[c], bb = abl[C + c], g0 = bgl[c], b0 = bgl[C + c];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 2 * half + e2;
            float& v = xr[mi][pi][e];
            v = (v * a + bb) * (1.f + (acc[mi][2 * pi][e] + g0)) + (acc[mi][2 * pi + 1][e] + b0);
          }
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!valid[mi][half]) continue;
      const int r = r0 + MT * wm + mi, c = c0 + g + 8 * half;
#pragma unroll
      for (int pi = 0; pi < NPAIR; ++pi)
        *reinterpret_cast<__nv_bfloat162*>(y + (((size_t)b * H + r) * W + c) * C + chw + 8 * pi) =
            __floats2bfloat162_rn(xr[mi][pi][2 * half], xr[mi][pi][2 * half + 1]);
    }
  }
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

}  // namespace

extern "C" {

// Launches the chain on `stream`; returns a cudaError_t (0 on success).
// is_bf16 selects bf16 (1) or f32 (0) for x, y, seg and wgb. cs holds the L
// labels' segmap channel counts (host memory).
int multispade_chain_forward(int is_bf16, const void* x, const void* ab, const void* seg,
                             const void* wsh, const void* bsh, const void* wgb,
                             const void* bgb, void* y, int B, int H, int W, int C, int L,
                             const int* cs, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < TC || C % TC != 0 || L < 1 || L > MAX_L)
    return (int)cudaErrorInvalidValue;
  ChainArgs args;
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
    if (cs[l] < 1 || cs[l] > MAX_CS) return (int)cudaErrorInvalidValue;
    args.cs[l] = cs[l];
    args.cs_off[l] = off;
    off += cs[l];
    max_cs = cs[l] > max_cs ? cs[l] : max_cs;
  }
  args.cs_tot = off;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  args.kp = (9 * max_cs + 15) / 16 * 16;
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(chain_kernel_bf16, smem_bf16(), x, ab, seg,
                                                     wsh, bsh, wgb, bgb, y, B, args, s)
              : launch<float, float>(chain_kernel_f32, smem_f32(), x, ab, seg, wsh, bsh, wgb,
                                     bgb, y, B, args, s);
  return (int)err;
}

const char* multispade_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
