// The ViT's attention core, softmax(Q K^T / sqrt(d), keys masked) V, with
// its backward, for the short sequences of the DINO ViT.
//
// Replaces no TPU kernel: the JAX package leaves attention to XLA
// (ssv_tpu/models/vit.py, SelfAttention). On the H100 aten ran it, per layer
// and call, as a dozen passes over device memory: q, k and v transposed,
// q and k cast to float32 and copied contiguous, the score product on
// float32 SIMT cores, the scale, the float32 softmax, the probabilities
// cast to bf16, a batched bf16 probs @ V on cuBLAS's small-batch kernels
// and the transpose back, and the same again in the backward (7.5 ms of a
// 20.35 ms DINO step). The work itself is small: at the shipped shapes (65
// or 5 tokens, 6 heads of 64) it is about 33 FLOP a byte, far under the
// card's 295, so what bounds this file is bytes: q, k and v read and o
// written forward; q, k, v and dO read and dq, dk and dv written backward
// (about 1.4 GB a DINO step, 0.43 ms at 3.35 TB/s).
//
// Design. A whole sequence of one head fits one CTA (n <= 128 tokens), so
// one CTA owns a (sequence, head) pair in both passes (or 2 or 4 pairs for
// sequences of at most 32 or 16 tokens), and nothing is reduced across
// CTAs: no online softmax, no second pass, no atomics. The CTA copies the
// pair's rows of q, k and v (and dO) into shared memory with 16-byte
// cp.async loads, straight from the (b, n, h * 64) Linear outputs through a
// row stride, so the fused QKV product's strided views pass without a copy;
// rows past n are zero-filled up to a multiple of 16. Tiles are 64 bf16 = 128
// bytes a row, their 16-byte chunks XOR-swizzled by the row so ldmatrix reads
// them without bank conflicts. Products are mma.sync m16n8k16 (bf16 in,
// float32 accumulate): wgmma's 64-row tile would leave 1 of 65 rows in a
// second tile, and the tensor cores are not the limit here.
//
// Forward (vit_attn_fwd): a warp owns 16 query rows and holds the whole
// score row (up to 128 keys) in registers: S = Q K^T, times 1/8 (exact at
// d = 64), keys at or past `valid` set to -1e9 as the module masks them,
// tile padding past n left out, an exact two-pass softmax in float32; P
// rounded to bf16 in registers (where the composition rounds `probs.to(dt)`)
// is the A operand of O = P V, and O is rounded to bf16 once and stored to
// (b, n, h * 64). It writes the row's float32 log-sum-exp for the backward,
// and the float32 probabilities where asked (`return_attn`).
//
// Backward (vit_attn_bwd): the CTA loads Q, K, V, dO and the LSE. Phase A, a
// warp a 16-row query tile, 16 keys at a time: S and P = exp(S / 8 - lse)
// recomputed in float32 and P kept in registers, dP = dO V^T (float32; the
// composition rounds it to bf16), D = rowsum(P dP) over the row (so O is not
// read), to shared memory; then dP formed again, dS = P (dP - D) / 8 in
// float32 and dQ = dS K. Phase B, a warp a 16-row key tile, over the query
// tiles: S^T = K Q^T, P^T and dP^T = V dO^T recomputed, dS^T from the shared
// D; dV = P_bf16^T dO (P rounded as the composition rounds it) and dK = dS^T
// Q. Forming dP twice, and no operand held across a loop, keeps the kernel
// under 136 registers, so three CTAs of the global crops share an SM and one
// CTA's loads overlap another's products. dQ and dK take float32 dS, as the composition's float32
// products do: dS is split into bf16 hi + lo (lo = dS - hi, rounded), two
// MMAs into one float32 accumulator (K and Q are exact in bf16), about 16
// bits of dS's mantissa against bf16's 8. dQ, dK and dV are rounded to bf16
// once. No TF32, no fp8; no atomics, so a call and its CUDA-graph replay
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;               // head width, the only one taken
constexpr float kScale = 0.125f;     // 1 / sqrt(kD), exact
constexpr float kNegMask = -1e9f;    // the module's mask value (exact in float32)
constexpr int kTileBytes = 16 * kD * 2;   // one 16-row bf16 tile

typedef __nv_bfloat16 bf16;

template <int NT>  // NT 16-row tiles: sequences of up to 16 * NT tokens
struct Shape {
  static constexpr int kRows = 16 * NT;
  static constexpr int kPairs = NT == 1 ? 4 : (NT == 2 ? 2 : 1);  // (sequence, head) a CTA
  static constexpr int kWarps = kPairs * NT;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTile = NT * kTileBytes;                     // one pair's (rows, 64)
  static constexpr int kFwdSmem = kPairs * 3 * kTile;
  static constexpr int kBwdSmem = kPairs * (4 * kTile + 2 * kRows * 4);
  // CTAs of the backward an SM holds at least (the register cap): three up
  // to the global crops' n = 65, so that one CTA's loads overlap another's
  // products
  static constexpr int kBwdBlocks = NT <= 5 ? 3 : 1;
};

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), float32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- fragments ---------------------------------------------------------------
//
// A warp's lane l = 4 g + t. An m16n8 float accumulator holds (row g, cols
// 2t, 2t + 1) in c[0], c[1] and (row g + 8, the same cols) in c[2], c[3]; a
// 16x16 bf16 A operand holds (row g, k 2t..) in a[0], (row g + 8) in a[1],
// and the same at k + 8 in a[2], a[3]; so two neighbouring accumulators
// (16 columns) are one A operand once rounded to bf16.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A operand of columns [16 j, 16 j + 16) of accumulators c
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c0)[4],
                                     const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// x = hi + lo to about 16 bits: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(r0, r1);
}

__device__ __forceinline__ void to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           const float (&c0)[4], const float (&c1)[4]) {
  split(c0[0], c0[1], hi[0], lo[0]);
  split(c0[2], c0[3], hi[1], lo[1]);
  split(c1[0], c1[1], hi[2], lo[2]);
  split(c1[2], c1[3], hi[3], lo[3]);
}

// the shared address of 16-byte chunk c (of 8) in row r of a tile at base
__device__ __forceinline__ uint32_t at(uint32_t base, int r, int c) {
  return base + r * (kD * 2) + ((c ^ (r & 7)) << 4);
}

// ldmatrix addresses a lane gives, for 16 rows from row0 and k16 step kk:
// an A operand (rows are the product's rows), a non-transposed B operand
// (rows are the product's columns, two n8 tiles) and a transposed B
// operand (rows are the product's k, chunks 2 kk and 2 kk + 1 the two n8
// tiles of d)
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int row0, int kk, int lane) {
  return at(base, row0 + (lane & 15), 2 * kk + (lane >> 4));
}
__device__ __forceinline__ uint32_t b_addr(uint32_t base, int row0, int kk, int lane) {
  return at(base, row0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1));
}
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int row0, int jj, int lane) {
  return at(base, row0 + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * jj + (lane >> 4));
}

// rows [0, 16 NT) of one head's (n, 64) slice at src, row stride sn
// elements, into the tile at dst; rows at or past n are zero
template <int NT, int kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int sn, int n) {
  for (int i = threadIdx.x; i < NT * 16 * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r < n;
    cp_async16(at(dst, r, c), ok ? src + static_cast<long long>(r) * sn + c * 8 : src, ok);
  }
}

// acc (16 rows x 64) as bf16 rows [row0, row0 + 16) of a (n, ld) slice at
// dst, rows at or past n left out
__device__ __forceinline__ void store_rows(bf16* dst, long long ld, int row0, int n,
                                           const float (&acc)[8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + g + 8 * hr;
    if (r >= n) continue;
    bf16* p = dst + r * ld + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) = pack_bf16(acc[j][2 * hr], acc[j][2 * hr + 1]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// s[2 NT] = (16 rows of A from row0) x (all 16 NT rows of B)^T over d = 64
template <int NT>
__device__ __forceinline__ void rows_by_all(float (&s)[2 * NT][4], uint32_t A, int row0,
                                            uint32_t Bm, int lane) {
  zero(s);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_addr(A, row0, kk, lane));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b[4];
      ldsm_x4(b, b_addr(Bm, 16 * j, kk, lane));
      mma(s[2 * j], a, b[0], b[1]);
      mma(s[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// c[2] = (16 rows of A from arow0) x (16 rows of B from brow0)^T over d = 64
__device__ __forceinline__ void tile_products(float (&c)[2][4], uint32_t A, int arow0, uint32_t Bm,
                                              int brow0, int lane) {
  zero(c);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t a[4], b[4];
    ldsm_x4(a, a_addr(A, arow0, kk, lane));
    ldsm_x4(b, b_addr(Bm, brow0, kk, lane));
    mma(c[0], a, b[0], b[1]);
    mma(c[1], a, b[2], b[3]);
  }
}

// ---- forward ---------------------------------------------------------------

template <int NT>
__global__ void __launch_bounds__(Shape<NT>::kThreads)
    vit_attn_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, long long sb, int sn, int B, int H, int n,
                 int valid, bf16* __restrict__ o, float* __restrict__ lse,
                 float* __restrict__ probs) {
  using S = Shape<NT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int pairs = B * H;
  const uint32_t base = smem_u32(smem);
#pragma unroll
  for (int p = 0; p < S::kPairs; ++p) {
    const int pidx = blockIdx.x * S::kPairs + p;
    const bool live = pidx < pairs;
    const long long off = live ? (pidx / H) * sb + (pidx % H) * kD : 0;
    const int rows = live ? n : 0;
    const uint32_t tiles = base + p * 3 * S::kTile;
    load_tile<NT, S::kThreads>(tiles, q + off, sn, rows);
    load_tile<NT, S::kThreads>(tiles + S::kTile, k + off, sn, rows);
    load_tile<NT, S::kThreads>(tiles + 2 * S::kTile, v + off, sn, rows);
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = warp / NT, qt = warp % NT;
  const int pidx = blockIdx.x * S::kPairs + p;
  if (pidx >= pairs) return;  // past the only barrier
  const int g = lane >> 2, t = lane & 3;
  const uint32_t Qs = base + p * 3 * S::kTile, Ks = Qs + S::kTile, Vs = Ks + S::kTile;

  float s[2 * NT][4];
  rows_by_all<NT>(s, Qs, 16 * qt, Ks, lane);

  // scale, mask, exact softmax over the row (a row's 4 lanes share it)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 8 * j + 2 * t + (i & 1);
      float x = s[j][i] * kScale;
      x = col >= n ? -INFINITY : (col >= valid ? kNegMask : x);
      s[j][i] = x;
      mx[i >> 1] = fmaxf(mx[i >> 1], x);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
  }
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = expf(s[j][i] - mx[i >> 1]);
      s[j][i] = e;
      sum[i >> 1] += e;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
  }
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = s[j][i] / sum[i >> 1];
  }

  const int r0 = 16 * qt + g;
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if (r0 + 8 * hr < n) lse[static_cast<long long>(pidx) * n + r0 + 8 * hr] =
          mx[hr] + logf(sum[hr]);
  }
  if (probs != nullptr) {
    float* pp = probs + static_cast<long long>(pidx) * n * n;
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + 8 * (i >> 1), col = 8 * j + 2 * t + (i & 1);
        if (r < n && col < n) pp[r * n + col] = s[j][i];
      }
    }
  }

  // O = bf16(P) V
  float acc[8][4];
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t a[4];
    to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      ldsm_x4_t(b, bt_addr(Vs, 16 * kk, jj, lane));
      mma(acc[2 * jj], a, b[0], b[1]);
      mma(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
  const long long ld = static_cast<long long>(H) * kD;
  store_rows(o + (pidx / H) * n * ld + (pidx % H) * kD, ld, 16 * qt, n, acc, lane);
}

// ---- backward --------------------------------------------------------------

template <int NT>
__global__ void __launch_bounds__(Shape<NT>::kThreads, Shape<NT>::kBwdBlocks)
    vit_attn_bwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, long long sb, int sn,
                 const bf16* __restrict__ dout, const float* __restrict__ lse, int B, int H,
                 int n, int valid, bf16* __restrict__ dq, bf16* __restrict__ dk,
                 bf16* __restrict__ dv) {
  using S = Shape<NT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int pairs = B * H;
  const long long ld = static_cast<long long>(H) * kD;  // dO, dq, dk, dv: (B, n, H * 64)
  const uint32_t base = smem_u32(smem);
  float* stats = reinterpret_cast<float*>(smem + S::kPairs * 4 * S::kTile);
#pragma unroll
  for (int p = 0; p < S::kPairs; ++p) {
    const int pidx = blockIdx.x * S::kPairs + p;
    const bool live = pidx < pairs;
    const long long off = live ? (pidx / H) * sb + (pidx % H) * kD : 0;
    const long long doff = live ? (pidx / H) * n * ld + (pidx % H) * kD : 0;
    const int rows = live ? n : 0;
    const uint32_t tiles = base + p * 4 * S::kTile;
    load_tile<NT, S::kThreads>(tiles, q + off, sn, rows);
    load_tile<NT, S::kThreads>(tiles + S::kTile, k + off, sn, rows);
    load_tile<NT, S::kThreads>(tiles + 2 * S::kTile, v + off, sn, rows);
    load_tile<NT, S::kThreads>(tiles + 3 * S::kTile, dout + doff, static_cast<int>(ld), rows);
    float* L = stats + p * 2 * S::kRows;
    for (int r = threadIdx.x; r < S::kRows; r += S::kThreads)
      L[r] = r < rows ? lse[static_cast<long long>(pidx) * n + r] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = warp / NT, tile = warp % NT;
  const int pidx = blockIdx.x * S::kPairs + p;
  const bool live = pidx < pairs;  // warp-uniform; every warp reaches the barrier
  const int g = lane >> 2, t = lane & 3;
  const uint32_t Qs = base + p * 4 * S::kTile, Ks = Qs + S::kTile, Vs = Ks + S::kTile,
                 dOs = Vs + S::kTile;
  const float* L = stats + p * 2 * S::kRows;
  float* Dsh = stats + p * 2 * S::kRows + S::kRows;
  const long long out_off = (pidx / H) * n * ld + (pidx % H) * kD;

  // phase A: query rows [16 tile, 16 tile + 16): D, then dQ, 16 keys at a
  // time; P stays in registers, dP is formed twice (once for D)
  if (live) {
    const int r0 = 16 * tile + g;
    const float l[2] = {L[r0], L[r0 + 8]};
    float pr[2 * NT][4];
    float D[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float sc[2][4], dp[2][4];
      tile_products(sc, Qs, 16 * tile, Ks, 16 * j, lane);
      tile_products(dp, dOs, 16 * tile, Vs, 16 * j, lane);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 16 * j + 8 * jj + 2 * t + (i & 1);
          const float p = col < valid ? expf(sc[jj][i] * kScale - l[i >> 1]) : 0.f;
          pr[2 * j + jj][i] = p;
          D[i >> 1] += p * dp[jj][i];
        }
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      D[hr] += __shfl_xor_sync(0xffffffffu, D[hr], 1);
      D[hr] += __shfl_xor_sync(0xffffffffu, D[hr], 2);
    }
    if (t == 0) {
      Dsh[r0] = D[0];
      Dsh[r0 + 8] = D[1];
    }
    float acc[8][4];
    zero(acc);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float ds[2][4];
      tile_products(ds, dOs, 16 * tile, Vs, 16 * j, lane);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds[jj][i] = pr[2 * j + jj][i] * (ds[jj][i] - D[i >> 1]) * kScale;
      }
      uint32_t hi[4], lo[4];
      to_a_split(hi, lo, ds[0], ds[1]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b[4];
        ldsm_x4_t(b, bt_addr(Ks, 16 * j, jj, lane));
        mma(acc[2 * jj], hi, b[0], b[1]);
        mma(acc[2 * jj], lo, b[0], b[1]);
        mma(acc[2 * jj + 1], hi, b[2], b[3]);
        mma(acc[2 * jj + 1], lo, b[2], b[3]);
      }
    }
    store_rows(dq + out_off, ld, 16 * tile, n, acc, lane);
  }
  __syncthreads();
  if (!live) return;

  // phase B: key rows [16 tile, 16 tile + 16): dV and dK over the query tiles
  float dva[8][4], dka[8][4];
  zero(dva);
  zero(dka);
  const int key0 = 16 * tile + g;
#pragma unroll 1
  for (int qc = 0; qc < NT; ++qc) {
    float st[2][4], dpt[2][4];
    tile_products(st, Ks, 16 * tile, Qs, 16 * qc, lane);
    tile_products(dpt, Vs, 16 * tile, dOs, 16 * qc, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = key0 + 8 * (i >> 1), qr = 16 * qc + 8 * j + 2 * t + (i & 1);
        const float p = key < valid && qr < n ? expf(st[j][i] * kScale - L[qr]) : 0.f;
        st[j][i] = p;
        dpt[j][i] = p * (dpt[j][i] - Dsh[qr]) * kScale;
      }
    }
    uint32_t a[4], hi[4], lo[4];
    to_a(a, st[0], st[1]);
    to_a_split(hi, lo, dpt[0], dpt[1]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      ldsm_x4_t(b, bt_addr(dOs, 16 * qc, jj, lane));
      mma(dva[2 * jj], a, b[0], b[1]);
      mma(dva[2 * jj + 1], a, b[2], b[3]);
      ldsm_x4_t(b, bt_addr(Qs, 16 * qc, jj, lane));
      mma(dka[2 * jj], hi, b[0], b[1]);
      mma(dka[2 * jj], lo, b[0], b[1]);
      mma(dka[2 * jj + 1], hi, b[2], b[3]);
      mma(dka[2 * jj + 1], lo, b[2], b[3]);
    }
  }
  store_rows(dk + out_off, ld, 16 * tile, n, dka, lane);
  store_rows(dv + out_off, ld, 16 * tile, n, dva, lane);
}

// ---- launches --------------------------------------------------------------

template <typename K>
int launch_prep(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int NT>
int fwd(const void* q, const void* k, const void* v, long long sb, int sn, int B, int H,
        int n, int valid, void* o, float* lse, float* probs, cudaStream_t s) {
  using S = Shape<NT>;
  const int err = launch_prep(vit_attn_fwd<NT>, S::kFwdSmem);
  if (err) return err;
  const int blocks = (B * H + S::kPairs - 1) / S::kPairs;
  vit_attn_fwd<NT><<<blocks, S::kThreads, S::kFwdSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      sb, sn, B, H, n, valid, static_cast<bf16*>(o), lse, probs);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int bwd(const void* q, const void* k, const void* v, long long sb, int sn, const void* dout,
        const float* lse, int B, int H, int n, int valid, void* dq, void* dk, void* dv,
        cudaStream_t s) {
  using S = Shape<NT>;
  const int err = launch_prep(vit_attn_bwd<NT>, S::kBwdSmem);
  if (err) return err;
  const int blocks = (B * H + S::kPairs - 1) / S::kPairs;
  vit_attn_bwd<NT><<<blocks, S::kThreads, S::kBwdSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      sb, sn, static_cast<const bf16*>(dout), lse, B, H, n, valid, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each function launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success). q, k and v are bf16 (B, n, H, 64) with
// strides (sb, sn, 64, 1) in elements, 16-byte aligned; o, dout, dq, dk and
// dv bf16 (B, n, H * 64) contiguous; lse and probs float32 (B, H, n) and
// (B, H, n, n), either may be null in the forward. 1 <= valid <= n <= 128.
// The wrapper (ops/attention.py) checks all of that; these trust it.
extern "C" {

int ssv_attn_fwd(const void* q, const void* k, const void* v, long long sb, int sn, int B,
                 int H, int n, int valid, void* o, float* lse, float* probs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((n + 15) / 16) {
    case 1: return fwd<1>(q, k, v, sb, sn, B, H, n, valid, o, lse, probs, s);
    case 2: return fwd<2>(q, k, v, sb, sn, B, H, n, valid, o, lse, probs, s);
    case 3: return fwd<3>(q, k, v, sb, sn, B, H, n, valid, o, lse, probs, s);
    case 4: return fwd<4>(q, k, v, sb, sn, B, H, n, valid, o, lse, probs, s);
    case 5: return fwd<5>(q, k, v, sb, sn, B, H, n, valid, o, lse, probs, s);
    case 6: return fwd<6>(q, k, v, sb, sn, B, H, n, valid, o, lse, probs, s);
    case 7: return fwd<7>(q, k, v, sb, sn, B, H, n, valid, o, lse, probs, s);
    case 8: return fwd<8>(q, k, v, sb, sn, B, H, n, valid, o, lse, probs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int ssv_attn_bwd(const void* q, const void* k, const void* v, long long sb, int sn,
                 const void* dout, const float* lse, int B, int H, int n, int valid, void* dq,
                 void* dk, void* dv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((n + 15) / 16) {
    case 1: return bwd<1>(q, k, v, sb, sn, dout, lse, B, H, n, valid, dq, dk, dv, s);
    case 2: return bwd<2>(q, k, v, sb, sn, dout, lse, B, H, n, valid, dq, dk, dv, s);
    case 3: return bwd<3>(q, k, v, sb, sn, dout, lse, B, H, n, valid, dq, dk, dv, s);
    case 4: return bwd<4>(q, k, v, sb, sn, dout, lse, B, H, n, valid, dq, dk, dv, s);
    case 5: return bwd<5>(q, k, v, sb, sn, dout, lse, B, H, n, valid, dq, dk, dv, s);
    case 6: return bwd<6>(q, k, v, sb, sn, dout, lse, B, H, n, valid, dq, dk, dv, s);
    case 7: return bwd<7>(q, k, v, sb, sn, dout, lse, B, H, n, valid, dq, dk, dv, s);
    case 8: return bwd<8>(q, k, v, sb, sn, dout, lse, B, H, n, valid, dq, dk, dv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
