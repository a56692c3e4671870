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
// is (64 queries, 512 value columns, sample). Each block computes its
// queries' scores once for its 512 columns, so the QK^T work is ceil(dv /
// 512) times the minimum: 1.33x at d = 256, dv = 2048 and 1.78x at d = 512,
// dv = 4096 (the first design's 256- and 128-column blocks: 1.78x, 4.4x).
// Each warpgroup holds 256 columns of f32 output (128 registers a thread)
// beside its scores and softmax state, more than the 168 a thread that a
// copy warp or warpgroup beside two warpgroups leaves: ptxas compiles to
// the launch's budget whatever setmaxnreg later grants (a producer
// warpgroup with setmaxnreg 40 / 232 spilled, and ran slower). So the
// block is the two warpgroups alone, 255 registers a thread, and thread 0
// issues the copies between its products.
//
// bf16 (the serving dtype, attention_wgmma), 256 threads: two
// warpgroups. Thread 0 copies tiles by TMA (tensor maps over q, k, v as
// (d | dv, N, B), 128-byte swizzled boxes of 64 rows x 64 elements, zero
// filled past N, d and dv): Q once (resident; or, where d leaves no room,
// one d-chunk with each K tile), the K tiles of each 64-key tile d-chunk
// by d-chunk through a ring, and each key tile's V (64 keys x 512 columns)
// through a ring of one or two stages, on full mbarriers (a stage is
// refilled after a block barrier, or on an empty mbarrier; below). TMA rather than cp.async to
// software-swizzled addresses: one instruction a tile from one thread, its
// bytes counted on the barrier, the zero fill of ragged N, d and dv free.
// Per key tile, warpgroup w computes S for keys 32w..32w+31 of the tile
// (wgmma m64n32k16, Q and K K-major from shared memory, d streamed in
// 64-wide chunks, so any d runs); the two exchange row maxima through
// shared memory, write P = exp(S - running max), rounded to bf16, into one
// shared 64 x 64 tile (the 128-byte-swizzled A layout), and each
// multiplies the whole P tile by its 256 columns of V (wgmma m64n256k16,
// V the transposed, MN-major B operand): one S tile for 512 columns. The
// output accumulates in f32 registers (128 a thread), is divided by the
// row sum at the end and stored in bf16. The plain version rounds the
// NORMALISED probabilities to bf16; this kernel rounds them before
// normalising (ops/fused_attention.py::ATTENTION_TOLERANCE). d and dv are
// taken in multiples of 8 (TMA's 16-byte strides; the wrapper zero-pads
// other widths, exact), any N.
//
// f32 (kept for parity checks): a scalar FMA path, 32 queries x 64 value
// columns a block (the last masked past dv), keys in tiles of 32, d in
// chunks of 64, f32 throughout; any N, d and dv.

#include <math.h>

#include "tma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_SMEM = 232448;

// D(64x32, f32) += A(64x16 bf16) * B(16x32 bf16), both from shared memory
// through K-major descriptors.
__device__ __forceinline__ void wgmma_m64n32k16_bf16_ss(float (&d)[16], uint64_t desc_a,
                                                        uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D(64x256, f32) += A(64x16 bf16, shared memory, K-major descriptor) *
// B(16x256 bf16, shared memory, MN-major: the transposed operand).
__device__ __forceinline__ void wgmma_m64n256k16_bf16_ss_tb(float (&d)[128], uint64_t desc_a,
                                                            uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// ------------------------------------------------------------ bf16 (wgmma)
constexpr int BQ = 64;                 // queries a block
constexpr int BK = 64;                 // keys a tile
constexpr int WG_COLS = 256;           // value columns a consumer warpgroup
constexpr int BLOCK_COLS = 2 * WG_COLS;
constexpr int NTHREADS_WG = 256;       // two warpgroups; thread 0 also issues the copies
constexpr int PIECE = 64 * 128;        // a TMA box: 64 rows of 64 bf16 (8 KB)
constexpr int V_STAGE = BLOCK_COLS / 64 * PIECE;  // a key tile's V (64 KB)
constexpr int MAX_NV = 2;              // V stages at most
constexpr int MAX_NK = 16;             // K stages at most

struct AttnArgs {
  int N, d, dv;
  int nd;          // 64-wide chunks of d
  int q_resident;  // Q held for the block, else one chunk streamed with each K chunk
  int nk;          // K ring stages
  int kstage;      // bytes a K stage: a K piece (and, streamed, a Q piece)
  int nv;          // V ring stages
};

// Shared memory (1024-byte aligned base): V ring, P tile, K ring, resident
// Q, barriers, the row statistics the warpgroups exchange.
struct AttnLayout {
  static constexpr size_t BARS = 512;
  static constexpr size_t STATS = 4 * 64 * sizeof(float);
  __host__ __device__ static size_t p(const AttnArgs& a) { return (size_t)a.nv * V_STAGE; }
  __host__ __device__ static size_t k(const AttnArgs& a) { return p(a) + PIECE; }
  __host__ __device__ static size_t fixed(const AttnArgs& a) { return k(a) + BARS + STATS + 1024; }
  __host__ __device__ static size_t q(const AttnArgs& a) { return k(a) + (size_t)a.nk * a.kstage; }
  __host__ __device__ static size_t bars(const AttnArgs& a) {
    return q(a) + (a.q_resident ? (size_t)a.nd * PIECE : 0);
  }
  __host__ __device__ static size_t stats(const AttnArgs& a) { return bars(a) + BARS; }
  __host__ __device__ static size_t bytes(const AttnArgs& a) { return stats(a) + STATS + 1024; }
};

// The K ring and Q beside a V ring of nv stages: Q resident where it
// leaves two K stages, else streamed (see the header).
bool attn_ring(AttnArgs& a, int nv) {
  a.nv = nv;
  const long long room = (long long)MAX_SMEM - (long long)AttnLayout::fixed(a);
  a.q_resident = (long long)(a.nd + 2) * PIECE <= room;
  a.kstage = a.q_resident ? PIECE : 2 * PIECE;
  const long long nk = (room - (a.q_resident ? (long long)a.nd * PIECE : 0)) / a.kstage;
  a.nk = (int)(nk < MAX_NK ? nk : MAX_NK);
  return a.nk >= 2 && AttnLayout::bytes(a) <= (size_t)MAX_SMEM;
}

// Two V stages where the K ring then holds a key tile's d-chunks, else one
// V stage and a deeper K ring.
bool attn_args(AttnArgs& a, int N, int d, int dv) {
  a.N = N;
  a.d = d;
  a.dv = dv;
  a.nd = (d + 63) / 64;
  if (attn_ring(a, 2) && a.nk >= a.nd) return true;
  return attn_ring(a, 1);
}

// MN-major 128-byte-swizzle descriptor of V: 64-column atoms PIECE apart
// (leading byte offset), 8-key groups 1024 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t desc_mn_sw128(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(PIECE >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// o: (B, N, dv) bf16; q, k, v through their tensor maps. Block (64
// queries, 512 columns, sample).
//
// The copies: thread 0 issues Q, the first K stages and the first nv key
// tiles' V before the loop, then refills at the first block barrier of
// each key tile j, when every warp is past tile j's scores and tile j - 1's
// PV products: K up to nk chunks past tile j's (a tile ahead), V of tile j
// + nv - 1 into tile j - 1's stage. The V ring has two stages where the K
// ring then still holds a key tile's d-chunks, else one (d = 512: a ring
// of 11 K stages rather than 3). Where the K ring is shorter than a tile's
// chunks all the same (d > 576), a K stage is instead refilled within the
// scores, once every warp has released it (its empty barrier), just after
// thread 0's own warp has.
template <int NV>  // V stages (a.nv)
__global__ void __launch_bounds__(NTHREADS_WG, 1)
attention_wgmma(__nv_bfloat16* __restrict__ o, const AttnArgs a,
                const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* v_ring = smem;
  unsigned char* p_s = smem + AttnLayout::p(a);
  unsigned char* k_ring = smem + AttnLayout::k(a);
  unsigned char* q_s = smem + AttnLayout::q(a);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + AttnLayout::bars(a));
  uint64_t* k_empty = k_full + MAX_NK;
  uint64_t* v_full = k_empty + MAX_NK;
  uint64_t* q_full = v_full + MAX_NV;
  float* red_max = reinterpret_cast<float*>(smem + AttnLayout::stats(a));  // [2][64]
  float* red_sum = red_max + 2 * 64;                                         // [2][64]

  const int q0 = blockIdx.x * BQ, col0 = blockIdx.y * BLOCK_COLS, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ntiles = (a.N + BK - 1) / BK;
  if (tid == 0) {
    for (int i = 0; i < a.nk; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&k_empty[i], NTHREADS_WG / 32);
    }
    for (int i = 0; i < NV; ++i) mbar_init(&v_full[i], 1);
    mbar_init(q_full, 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  const int nksteps = ntiles * a.nd;
  const bool short_ring = a.nk < a.nd;  // K refilled within a tile's scores
  int issued = 0;                       // K chunks issued (thread 0)
  // K chunk `ks` (tile ks / nd, d-chunk ks % nd), and with a streamed Q its
  // Q chunk, into stage ks % nk
  auto load_k = [&](int ks) {
    const int st = ks % a.nk, c = ks % a.nd;
    unsigned char* stage = k_ring + st * a.kstage;
    mbar_arrive_expect_tx(&k_full[st], a.kstage);
    tma_load_3d(stage, &tk, 64 * c, BK * (ks / a.nd), b, &k_full[st]);
    if (!a.q_resident) tma_load_3d(stage + PIECE, &tq, 64 * c, q0, b, &k_full[st]);
  };
  // a short ring: this warp is done with K chunk ks; thread 0, once every
  // warp is, loads chunk ks + nk into its stage
  auto release_k = [&](int ks) {
    if (!short_ring) return;
    if (lane == 0) mbar_arrive(&k_empty[ks % a.nk]);
    if (tid != 0 || ks + a.nk >= nksteps) return;
    mbar_wait(&k_empty[ks % a.nk], (ks / a.nk) & 1);
    load_k(ks + a.nk);
  };
  auto load_v = [&](int j) {
    const int vs = j % NV;
    mbar_arrive_expect_tx(&v_full[vs], V_STAGE);
    for (int w = 0; w < BLOCK_COLS / 64; ++w)
      tma_load_3d(v_ring + vs * V_STAGE + w * PIECE, &tv, col0 + 64 * w, BK * j, b, &v_full[vs]);
  };
  if (tid == 0) {
    if (a.q_resident) {
      mbar_arrive_expect_tx(q_full, a.nd * PIECE);
      for (int c = 0; c < a.nd; ++c) tma_load_3d(q_s + c * PIECE, &tq, 64 * c, q0, b, q_full);
    }
    for (; issued < a.nk && issued < nksteps; ++issued) load_k(issued);
    for (int j = 0; j < NV && j < ntiles; ++j) load_v(j);
  }

  // warp q of warpgroup wg holds rows 16q + g (+ 8) of the 64 queries (h =
  // 0, 1), S for keys 32wg + 8jj + 2t (+ 1), its 256 output columns 8jj +
  // 2t (+ 1)
  const int wg = warp / 4, qw = warp % 4, g = lane / 4, t = lane % 4;
  float acc[WG_COLS / 2];
#pragma unroll
  for (int i = 0; i < WG_COLS / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of this thread's rows
  float l[2] = {0.f, 0.f};              // this thread's share of their running sums
  if (a.q_resident) mbar_wait(q_full, 0);
  const uint64_t p_desc = wgmma_desc_sw128(p_s);
  int kstep = 0;
  for (int j = 0; j < ntiles; ++j) {
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    // the d-chunks' products one group deep: a K stage is released when
    // the group after it is issued and it has retired
    int prev = -1;
    for (int c = 0; c < a.nd; ++c, ++kstep) {
      const int st = kstep % a.nk;
      const unsigned char* stage = k_ring + st * a.kstage;
      mbar_wait(&k_full[st], (kstep / a.nk) & 1);
      const uint64_t qd = wgmma_desc_sw128(a.q_resident ? q_s + c * PIECE : stage + PIECE);
      const uint64_t kd = wgmma_desc_sw128(stage + wg * 32 * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n32k16_bf16_ss(s, qd + 2 * kk, kd + 2 * kk);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();
        release_k(prev);
      }
      prev = kstep;
    }
    wgmma_wait<0>();
    fence_regs(s);
    release_k(prev);
    // element i of s: row 16qw + g + 8 * ((i % 4) / 2), key 32wg + 8 * (i / 4) + 2t + i % 2
    const int key0 = BK * j + 32 * wg;
    if (BK * j + BK > a.N) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (key0 + 8 * (i / 4) + 2 * t + (i % 2) >= a.N) s[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 16; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t == 0) red_max[64 * wg + 16 * qw + g + 8 * h] = mx[h];
    }
    named_sync(1, NTHREADS_WG);  // both halves' maxima; both are done with the last P tile
    if (tid == 0) {  // every warp is past tile j's scores and tile j - 1's PV products
      if (!short_ring) {
        const int upto = min(nksteps, (j + 1) * a.nd + a.nk);
        for (; issued < upto; ++issued) load_k(issued);
      }
      if (j >= 1 && j + NV - 1 < ntiles) load_v(j + NV - 1);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the tile holds a valid key, so the new running max is finite
      const float mn = fmaxf(m[h], fmaxf(mx[h], red_max[64 * (1 - wg) + 16 * qw + g + 8 * h]));
      alpha[h] = exp2f((m[h] - mn) * LOG2E);
      m[h] = mn;
      l[h] *= alpha[h];
    }
    // P, rounded to bf16, into the shared tile: row r, key k at byte r * 128
    // + ((k / 8) ^ (r % 8)) * 16 + (k % 8) * 2
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f((s[4 * jj + 2 * h] - m[h]) * LOG2E);
        const float p1 = exp2f((s[4 * jj + 2 * h + 1] - m[h]) * LOG2E);
        l[h] += p0 + p1;
        const int r = 16 * qw + g + 8 * h, kc = 4 * wg + jj;
        *reinterpret_cast<__nv_bfloat162*>(p_s + r * 128 + ((kc ^ (r % 8)) * 16) + 4 * t) =
            __floats2bfloat162_rn(p0, p1);
      }
    }
#pragma unroll
    for (int i = 0; i < WG_COLS / 2; ++i) acc[i] *= alpha[(i % 4) / 2];
    fence_proxy_async();         // P's writes before the products read it
    named_sync(1, NTHREADS_WG);  // the whole P tile is written
    const int vs = j % NV;
    mbar_wait(&v_full[vs], (j / NV) & 1);
    const unsigned char* vt = v_ring + vs * V_STAGE + wg * (WG_COLS / 64) * PIECE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16_bf16_ss_tb(acc, p_desc + 2 * kk, desc_mn_sw128(vt + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // the row sums: this thread's share, its quad's, the other warpgroup's
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (t == 0) red_sum[64 * wg + 16 * qw + g + 8 * h] = l[h];
  }
  named_sync(1, NTHREADS_WG);
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / (l[h] + red_sum[64 * (1 - wg) + 16 * qw + g + 8 * h]);
  const int cbase = col0 + WG_COLS * wg + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * qw + g + 8 * h;
    if (r >= a.N) continue;
    __nv_bfloat16* orow = o + ((size_t)b * a.N + r) * a.dv;
#pragma unroll
    for (int jj = 0; jj < WG_COLS / 8; ++jj) {
      const int col = cbase + 8 * jj;
      if (col < a.dv)
        store2(orow + col, acc[4 * jj + 2 * h] * inv[h], acc[4 * jj + 2 * h + 1] * inv[h]);
    }
  }
}

// ------------------------------------------------------------------ f32

constexpr int NTHREADS = 256;
constexpr int FQ = 32;    // queries a block
constexpr int FK = 32;    // keys a tile
constexpr int FDV = 64;   // value columns a block
constexpr int FD = 64;    // d in chunks of this
constexpr int FSUB = NTHREADS / FQ;  // threads a query (8): keys sub + 8i, FDV / FSUB columns

constexpr size_t smem_f32() {
  return sizeof(float) * ((size_t)FQ * (FD + 1) + FK * (FD + 1) + FK * FDV + FQ * (FK + 1));
}

__global__ void __launch_bounds__(NTHREADS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int N, int d, int dv) {
  constexpr int CPT = FDV / FSUB;  // value columns a thread (8)
  constexpr int KPT = FK / FSUB;   // keys a thread (4)
  constexpr int DS = FD + 1;       // odd row stride: conflict-free column walks
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [FQ][DS], a chunk of d
  float* k_s = q_s + FQ * DS;                   // [FK][DS]
  float* v_s = k_s + FK * DS;                   // [FK][FDV]
  float* s_s = v_s + FK * FDV;                  // [FQ][FK + 1]

  const int q0 = blockIdx.x * FQ, c0 = blockIdx.y * FDV, b = blockIdx.z;
  q += (size_t)b * N * d;
  k += (size_t)b * N * d;
  v += (size_t)b * N * dv;
  o += (size_t)b * N * dv;
  const int tid = threadIdx.x;
  const int qi = tid / FSUB, sub = tid % FSUB;

  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < N; j0 += FK) {
    // scores of this thread's query and keys sub + 8i, summed over d in order
    float sacc[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) sacc[i] = 0.f;
    for (int d0 = 0; d0 < d; d0 += FD) {
      __syncthreads();  // the previous chunk (and tile) is no longer read
      for (int i = tid; i < FQ * FD; i += NTHREADS) {
        const int r = i / FD, c = i % FD;
        q_s[r * DS + c] = q0 + r < N && d0 + c < d ? q[(size_t)(q0 + r) * d + d0 + c] : 0.f;
        k_s[r * DS + c] = j0 + r < N && d0 + c < d ? k[(size_t)(j0 + r) * d + d0 + c] : 0.f;
      }
      __syncthreads();
      const int dc = min(FD, d - d0);
#pragma unroll
      for (int i = 0; i < KPT; ++i)
        for (int c = 0; c < dc; ++c)
          sacc[i] = fmaf(q_s[qi * DS + c], k_s[(sub + FSUB * i) * DS + c], sacc[i]);
    }
    for (int i = tid; i < FK * FDV; i += NTHREADS) {
      const int r = i / FDV, c = i % FDV;
      v_s[i] = j0 + r < N && c0 + c < dv ? v[(size_t)(j0 + r) * dv + c0 + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      s_s[qi * (FK + 1) + sub + FSUB * i] = j0 + sub + FSUB * i < N ? sacc[i] : -INFINITY;
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
    for (int c = 0; c < CPT; ++c) {
      const int col = c0 + CPT * sub + c;
      if (col < dv) o[(size_t)(q0 + qi) * dv + col] = acc[c] / l;
    }
  }
}

// ------------------------------------------------------------------ host

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int N,
                        int d, int dv, cudaStream_t stream) {
  if (d % 8 != 0 || dv % 8 != 0) return cudaErrorInvalidValue;  // TMA strides: 16 bytes
  AttnArgs a;
  if (!attn_args(a, N, d, dv)) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  constexpr CUtensorMapDataType BF16_MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle SW128 = CU_TENSOR_MAP_SWIZZLE_128B;
  const uint32_t box[3] = {64, 64, 1};
  const uint64_t qk_dims[3] = {(uint64_t)d, (uint64_t)N, (uint64_t)B};
  const uint64_t qk_strides[2] = {2ull * d, 2ull * d * N};
  const uint64_t v_dims[3] = {(uint64_t)dv, (uint64_t)N, (uint64_t)B};
  const uint64_t v_strides[2] = {2ull * dv, 2ull * dv * N};
  if (!make_tensor_map(&tq, BF16_MAP, q, 3, qk_dims, qk_strides, box, SW128) ||
      !make_tensor_map(&tk, BF16_MAP, k, 3, qk_dims, qk_strides, box, SW128) ||
      !make_tensor_map(&tv, BF16_MAP, v, 3, v_dims, v_strides, box, SW128))
    return cudaErrorInvalidValue;
  const size_t smem = AttnLayout::bytes(a);
  const auto kernel = a.nv == 2 ? attention_wgmma<2> : attention_wgmma<1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, (dv + BLOCK_COLS - 1) / BLOCK_COLS, B);
  kernel<<<grid, NTHREADS_WG, smem, stream>>>(static_cast<__nv_bfloat16*>(o), a, tq, tk, tv);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int N,
                       int d, int dv, cudaStream_t stream) {
  constexpr size_t smem = smem_f32();
  cudaError_t err = cudaFuncSetAttribute(attention_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + FQ - 1) / FQ, (dv + FDV - 1) / FDV, B);
  attention_f32_kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), N, d, dv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches o = softmax(q k^T) v on `stream`; returns a cudaError_t (0 on
// success). is_bf16 selects bf16 (1; d and dv multiples of 8) or f32 (0;
// any d and dv) for q, k, v and o.
int sagan_attention_forward(int is_bf16, const void* q, const void* k, const void* v, void* o,
                            int B, int N, int d, int dv, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || d < 1 || dv < 1 || (dv + FDV - 1) / FDV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_bf16(q, k, v, o, B, N, d, dv, s)
                       : launch_f32(q, k, v, o, B, N, d, dv, s));
}

// The value columns a bf16 block owns (ops/fused_attention.py:BLOCK_COLS).
int sagan_attention_block_cols() { return BLOCK_COLS; }

const char* sagan_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
