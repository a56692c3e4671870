// SAGAN self-attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of shineon_tpu/ops/fused_attention.py:
// _kernel, launched by _pallas_attention_single and dispatched by
// sagan_attention (kernel 3). For each sample b:
//   o[b] = softmax(q[b] k[b]^T) v[b]      (softmax over the keys, no 1/sqrt(d))
// with q, k (N, d), v and o (N, dv), row-major, one (N, N) score matrix a
// sample that never leaves the block.
//
// What bounds it on this card: 2 N^2 (d + dv) operations against N (2d +
// 2dv) elements moved once; at the serving clip's 64x48 sites (N = 3072,
// d = 128..256, dv = 1024..2048) that is about 1,500 operations a byte,
// far above the ~295 FLOP/B ridge of the bf16 tensor cores, so operations
// bound it there; at 16x12 (N = 192, d = 512, dv = 4096) it is bytes.
//
// Design: the TPU kernel keeps all of K and V resident (V alone is 12.6 MB
// in bf16 at N = 3072, dv = 2048) and takes an exact row softmax over a
// (256, N) score tile. A Hopper block has 227 KB, so this kernel streams K
// and V through shared memory in key tiles with an online softmax (running
// max and sum in f32), and blocks over dv as well as over queries: the grid
// is (query tile of 128, dv chunk, sample). Each block recomputes its
// queries' scores for its dv chunk, so chunking dv multiplies the QK^T
// work by dv / chunk. The chunk is as wide as registers allow: 256 (one
// warp's f32 output accumulator is 16 x 256, 128 registers a thread; the
// kernel takes 245 without spilling), 128 where d = 512 leaves no shared
// memory for 256-wide V tiles, or where dv is not a multiple of 256, and 64
// where dv is not a multiple of 128. At the 64x48 sites that is 1.78x
// (d = 256) and 1.33x (d = 128) the minimum work, against 2.67x and 1.78x
// with 128-wide chunks (their times on the card are in PERF.md).
//
// bf16 (the serving dtype): 8 warps, 16 queries each. The block's Q tile
// stays in shared memory; K and V tiles (64 keys, or 32 where d > 368
// would overflow shared memory) are double buffered with cp.async. S = Q K^T
// runs on mma.sync m16n8k16 with f32 accumulation; the masked, running-max
// shifted exponentials are rounded to bf16 and fed from registers straight
// into the PV mma.sync as A operands (V via ldmatrix.trans); O accumulates
// in f32, is divided by the row sum at the end and stored in bf16. The
// plain version rounds the NORMALISED probabilities to bf16; this kernel
// rounds them before normalising (ops/fused_attention.py::ATTENTION_TOLERANCE).
//
// f32 (kept for parity checks): a scalar FMA path, 32 queries x 64 value
// columns a block, keys in tiles of 32, f32 throughout.
//
// Any N is taken: a ragged last key tile is zero filled and its scores are
// masked with -inf, a ragged last query tile is zero filled and not stored.
// d must be a multiple of 16 up to 512, dv a multiple of 64. wgmma, TMA and
// a P tile kept in shared memory across dv chunks are later work.

#include <math.h>

#include "sm90_common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BQ = 16 * NWARPS;  // queries a block (16 a warp)
constexpr int PAD = 8;           // row padding (elements): 16-byte rows, conflict-free ldmatrix
constexpr int MAX_SMEM = 232448;
constexpr float LOG2E = 1.4426950408889634f;

template <int BK, int DVC>
constexpr size_t smem_bf16(int d) {
  return sizeof(__nv_bfloat16) *
         ((size_t)BQ * (d + PAD) + 2 * (size_t)BK * (d + PAD) + 2 * (size_t)BK * (DVC + PAD));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Start copying rows [r0, r0 + rows) x columns [0, cols) of a row-major
// matrix with leading dimension ld into shared rows of `stride` elements;
// rows at or beyond N are zero filled. cols is a multiple of 8.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int stride,
                                          const __nv_bfloat16* __restrict__ src, int ld, int r0,
                                          int rows, int cols, int N) {
  const int cpr = cols / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * cpr; i += NTHREADS) {
    const int r = i / cpr, c = 8 * (i % cpr);
    __nv_bfloat16* d = dst + r * stride + c;
    if (r0 + r < N)
      cp_async16(d, src + (size_t)(r0 + r) * ld + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// q, k: (B, N, d); v, o: (B, N, dv); bf16. Block (query tile, dv chunk, sample).
template <int BK, int DVC>
__global__ void __launch_bounds__(NTHREADS)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int N,
                      int d, int dv) {
  constexpr int NT_S = BK / 8;   // score n8 tiles a warp
  constexpr int NT_O = DVC / 8;  // output n8 tiles a warp
  constexpr int VS = DVC + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  const int DS = d + PAD;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][DS]
  __nv_bfloat16* k_s = q_s + BQ * DS;                            // 2 x [BK][DS]
  __nv_bfloat16* v_s = k_s + 2 * BK * DS;                        // 2 x [BK][VS]

  const int q0 = blockIdx.x * BQ, c0 = blockIdx.y * DVC, b = blockIdx.z;
  q += (size_t)b * N * d;
  k += (size_t)b * N * d;
  v += (size_t)b * N * dv + c0;
  o += (size_t)b * N * dv + c0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // ldmatrix row addresses of this lane (elements)
  const int a_row = lane % 16, a_k = 8 * (lane / 16);                 // A (16 x 16)
  const int b_row = (lane % 8) + 8 * (lane / 16), b_k = 8 * ((lane / 8) % 2);  // B, n-major
  const int v_row = lane % 16, v_col = 8 * (lane / 16);               // B, k-major (trans)

  load_rows(q_s, DS, q, d, q0, BQ, d, N);
  load_rows(k_s, DS, k, d, 0, BK, d, N);
  load_rows(v_s, VS, v, dv, 0, BK, DVC, N);
  cp_async_commit();

  float acc[NT_O][4];
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};              // this lane's share of their running sums

  const int ntiles = (N + BK - 1) / BK;
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      const int nxt = (j + 1) & 1;
      load_rows(k_s + nxt * BK * DS, DS, k, d, (j + 1) * BK, BK, d, N);
      load_rows(v_s + nxt * BK * VS, VS, v, dv, (j + 1) * BK, BK, DVC, N);
    }
    cp_async_commit();  // (empty on the last tile: the group count stays uniform)
    cp_async_wait<1>();  // this tile (and Q) has landed ...
    __syncthreads();     // ... for every thread
    const __nv_bfloat16* kt = k_s + (j & 1) * BK * DS;
    const __nv_bfloat16* vt = v_s + (j & 1) * BK * VS;

    // S = Q K^T for this warp's 16 queries and the tile's BK keys
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    for (int kk = 0; kk < d; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + (16 * warp + a_row) * DS + kk + a_k);
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kt + (16 * np + b_row) * DS + kk + b_k);
        mma_bf16(s[2 * np], a, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    // element e of n-tile nt: row g + 8 * (e / 2), key j * BK + 8 * nt + 2t + e % 2
    const int key0 = j * BK;
    if (key0 + BK > N) {
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * nt + 2 * t + (e & 1) >= N) s[nt][e] = -INFINITY;
    }

    // online softmax: the new running max (every tile holds a valid key,
    // so it is finite), the old sums' rescale, the shifted exponentials
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f((m[h] - mx[h]) * LOG2E);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    // P as bf16 A operands of the PV product: keys 16kk..16kk+15 are the
    // score n-tiles 2kk (k 0..7) and 2kk + 1 (k 8..15)
    uint32_t p[NT_S / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      const float p0 = exp2f((s[nt][0] - m[0]) * LOG2E);
      const float p1 = exp2f((s[nt][1] - m[0]) * LOG2E);
      const float p2 = exp2f((s[nt][2] - m[1]) * LOG2E);
      const float p3 = exp2f((s[nt][3] - m[1]) * LOG2E);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      p[nt / 2][2 * (nt % 2)] = pack_bf16(p0, p1);
      p[nt / 2][2 * (nt % 2) + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vt + (16 * kk + v_row) * VS + 16 * np + v_col);
        mma_bf16(acc[2 * np], p[kk], bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], p[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / l[h];
  }
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) {
    const int col = 8 * nt + 2 * t;
    if (r0 < N) store2(o + (size_t)r0 * dv + col, acc[nt][0] * inv[0], acc[nt][1] * inv[0]);
    if (r1 < N) store2(o + (size_t)r1 * dv + col, acc[nt][2] * inv[1], acc[nt][3] * inv[1]);
  }
}

// ------------------------------------------------------------------ f32

constexpr int FQ = 32;    // queries a block
constexpr int FK = 32;    // keys a tile
constexpr int FDV = 64;   // value columns a block
constexpr int FSUB = NTHREADS / FQ;  // threads a query (8), FDV / FSUB columns each

size_t smem_f32(int d) {
  return sizeof(float) * ((size_t)FQ * (d + 1) + (size_t)FK * (d + 1) + FK * FDV + FQ * (FK + 1));
}

__global__ void __launch_bounds__(NTHREADS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int N, int d, int dv) {
  constexpr int CPT = FDV / FSUB;  // value columns a thread (8)
  extern __shared__ __align__(16) unsigned char smem[];
  const int DS = d + 1;  // odd row stride: conflict-free column walks
  float* q_s = reinterpret_cast<float*>(smem);  // [FQ][DS]
  float* k_s = q_s + FQ * DS;                   // [FK][DS]
  float* v_s = k_s + FK * DS;                   // [FK][FDV]
  float* s_s = v_s + FK * FDV;                  // [FQ][FK + 1]

  const int q0 = blockIdx.x * FQ, c0 = blockIdx.y * FDV, b = blockIdx.z;
  q += (size_t)b * N * d;
  k += (size_t)b * N * d;
  v += (size_t)b * N * dv + c0;
  o += (size_t)b * N * dv + c0;
  const int tid = threadIdx.x;
  const int qi = tid / FSUB, sub = tid % FSUB;

  for (int i = tid; i < FQ * d; i += NTHREADS) {
    const int r = i / d, c = i % d;
    q_s[r * DS + c] = q0 + r < N ? q[(size_t)(q0 + r) * d + c] : 0.f;
  }
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < N; j0 += FK) {
    __syncthreads();  // the previous tile is no longer read (and Q has landed)
    for (int i = tid; i < FK * d; i += NTHREADS) {
      const int r = i / d, c = i % d;
      k_s[r * DS + c] = j0 + r < N ? k[(size_t)(j0 + r) * d + c] : 0.f;
    }
    for (int i = tid; i < FK * FDV; i += NTHREADS) {
      const int r = i / FDV, c = i % FDV;
      v_s[i] = j0 + r < N ? v[(size_t)(j0 + r) * dv + c] : 0.f;
    }
    __syncthreads();
    for (int key = sub; key < FK; key += FSUB) {
      float sacc = 0.f;
      for (int c = 0; c < d; ++c) sacc = fmaf(q_s[qi * DS + c], k_s[key * DS + c], sacc);
      s_s[qi * (FK + 1) + key] = j0 + key < N ? sacc : -INFINITY;
    }
    __syncthreads();
    float mx = m;
    for (int key = 0; key < FK; ++key) mx = fmaxf(mx, s_s[qi * (FK + 1) + key]);
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] *= alpha;
    for (int key = 0; key < FK; ++key) {
      const float p = expf(s_s[qi * (FK + 1) + key] - m);
      l += p;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = fmaf(p, v_s[key * FDV + CPT * sub + c], acc[c]);
    }
  }
  if (q0 + qi < N) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[(size_t)(q0 + qi) * dv + CPT * sub + c] = acc[c] / l;
  }
}

// ------------------------------------------------------------------ host

template <int BK, int DVC>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int N,
                        int d, int dv, cudaStream_t stream) {
  const size_t smem = smem_bf16<BK, DVC>(d);
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_kernel<BK, DVC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, dv / DVC, B);
  attention_bf16_kernel<BK, DVC><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), N, d, dv);
  return cudaGetLastError();
}

// The dv chunk of the bf16 kernel (see the header): 256 where dv and
// shared memory allow, else 128 where dv allows, else 64.
int value_chunk(int d, int dv) {
  if (dv % 256 == 0 && smem_bf16<32, 256>(d) <= MAX_SMEM) return 256;
  return dv % 128 == 0 ? 128 : 64;
}

template <int DVC>
cudaError_t launch_bf16_any_d(const void* q, const void* k, const void* v, void* o, int B,
                              int N, int d, int dv, cudaStream_t stream) {
  if (smem_bf16<64, DVC>(d) <= MAX_SMEM)
    return launch_bf16<64, DVC>(q, k, v, o, B, N, d, dv, stream);
  return launch_bf16<32, DVC>(q, k, v, o, B, N, d, dv, stream);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int N,
                       int d, int dv, cudaStream_t stream) {
  const size_t smem = smem_f32(d);
  cudaError_t err = cudaFuncSetAttribute(attention_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + FQ - 1) / FQ, dv / FDV, B);
  attention_f32_kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), N, d, dv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches o = softmax(q k^T) v on `stream`; returns a cudaError_t (0 on
// success). is_bf16 selects bf16 (1) or f32 (0) for q, k, v and o.
int sagan_attention_forward(int is_bf16, const void* q, const void* k, const void* v, void* o,
                            int B, int N, int d, int dv, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || d < 16 || d > 512 || d % 16 != 0 || dv < 64 ||
      dv % 64 != 0 || dv / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!is_bf16)
    err = launch_f32(q, k, v, o, B, N, d, dv, s);
  else if (value_chunk(d, dv) == 256)
    err = launch_bf16_any_d<256>(q, k, v, o, B, N, d, dv, s);
  else if (value_chunk(d, dv) == 128)
    err = launch_bf16_any_d<128>(q, k, v, o, B, N, d, dv, s);
  else
    err = launch_bf16_any_d<64>(q, k, v, o, B, N, d, dv, s);
  return (int)err;
}

// The dv chunk the bf16 kernel takes for these widths: its QK^T work is
// dv / chunk times the minimum.
int sagan_attention_value_chunk(int d, int dv) { return value_chunk(d, dv); }

const char* sagan_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
