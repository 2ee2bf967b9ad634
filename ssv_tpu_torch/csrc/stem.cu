// The ResNet stem's tail, maxpool3x3/s2/p1(relu(batchnorm(x))), fused.
//
// Replaces no TPU kernel: the JAX package leaves this tail to XLA, which
// fuses it on the TPU. On the H100, aten runs it as nine kernels over the
// network's largest activation (the stem's conv output, 134 MB in bf16 at
// batch 1,024 of 32x32 CIFAR views): BN statistics, BN transform, ReLU, the
// max-pool writing int64 indices, and in the backward a fill, the
// max-pool's scatter, the ReLU's mask, BN's reduce and BN's elementwise
// pass, 2.0 ms at that batch. Every pass is memory-bound (a few float
// operations a byte), so what bounds this file is bytes: it reads the conv
// output twice forward and twice backward, writes the pooled output and a
// 1-byte window offset, and keeps nothing else for the backward.
//
// Layout: x is (N, H, W, C) in memory (a channels-last (N, C, H, W)
// tensor), bf16 or float32, C a multiple of 8; every thread works on 8
// adjacent channels (16 bytes of bf16). The pooled output and the offsets
// are (N, Ho, Wo, C), Ho = (H - 1) / 2 + 1.
//
// Kernels (names hold bn_fw / bn_bw: profiles count them as normalisation):
//   stem_bn_fw_stats    per-CTA partial mean and M2 of each channel over a
//                       fixed range of rows: shifted sums a thread (shift =
//                       its first value), merged across the CTA's threads
//                       by Chan's formula in a fixed tree.
//   stem_bn_fw_merge    one CTA a channel: the partials merged in a fixed
//                       tree, then mean, biased variance, rstd, the affine
//                       scale and shift, and the running statistics
//                       (momentum; biased variance, as flax tracks it);
//                       in eval mode it takes the running statistics.
//   stem_bn_fw_relu_max a CTA normalises a band of input rows (the band's
//                       output rows plus the halo row) once into shared
//                       memory, y = relu(bf16(x * scale + shift)), then
//                       max-pools them with aten's rule: window order
//                       row-major, strict >, NaN wins. It writes the pooled
//                       output and, when autograd needs it, the window
//                       offset (0-8) of the max, with bit 7 set where that
//                       max is <= 0 (ReLU passes no gradient there).
//   stem_bn_bw_reduce   per input position, the gradient aten's max-pool
//                       backward gives it (the pooled gradients of the up to
//                       4 windows whose offset points to it, summed in fp32
//                       in aten's window order, rounded to the input type;
//                       zero where bit 7 is set), a thread taking 2x2
//                       positions and their 4 windows with every load in
//                       flight at once; then per-CTA sums of dy and
//                       dy * (x - mean) in a fixed tree.
//   stem_bn_bw_merge    one CTA a channel: the sums in a fixed tree, the
//                       gradients of the BN's weight and bias, and the
//                       elementwise pass's three coefficients.
//   stem_bn_bw_elemt    the same dy, then dx = (dy - sum_dy / n - (x - mean)
//                       * rstd^2 * sum_dy_xmu / n) * weight * rstd, aten's
//                       form.
// The statistics' and the reduce's CTAs each take a fixed range of rows; the
// wrapper sizes those grids to the CTAs the card holds at once. No atomics
// anywhere: every sum has a fixed order on a card, so two calls, and a
// CUDA-graph replay and the eager call, give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMergeThreads = 256;

// ---- 8 channels at a time -------------------------------------------------

template <typename T>
struct Pack;
template <>
struct Pack<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Pack<float> {
  float4 a, b;
};

__device__ __forceinline__ Pack<__nv_bfloat16> ld8(const __nv_bfloat16* p) {
  Pack<__nv_bfloat16> r;
  r.u = __ldg(reinterpret_cast<const uint4*>(p));
  return r;
}

__device__ __forceinline__ Pack<float> ld8(const float* p) {
  Pack<float> r;
  const float4* q = reinterpret_cast<const float4*>(p);
  r.a = __ldg(q);
  r.b = __ldg(q + 1);
  return r;
}

__device__ __forceinline__ void unpack(const Pack<__nv_bfloat16>& r, float (&v)[8]) {
  const uint32_t w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);  // the low half is the first channel
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const Pack<float>& r, float (&v)[8]) {
  v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
  v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  unpack(ld8(p), v);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// v rounded to T, as a float
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __uint_as_float(bf16_bits(v) << 16);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

// stores 8 floats that T represents exactly (or rounds them to T)
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  u.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  u.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Chan's formula: (na, ma, Ma) absorbs (nb, mb, Mb); M is the sum of
// squared deviations from the mean. The counts are float inside a CTA of
// the statistics (at most its range of rows, far below 2^24) and double in
// the merge, where they reach N * H * W.
template <typename Count>
__device__ __forceinline__ void chan(Count& na, float& ma, float& Ma, Count nb, float mb,
                                     float Mb) {
  const Count n = na + nb;
  if (n == Count(0)) return;
  const float d = mb - ma;
  const Count f = nb / n;
  ma = ma + d * static_cast<float>(f);
  Ma = Ma + Mb + d * d * static_cast<float>(na * f);
  na = n;
}

// ---- forward: statistics --------------------------------------------------

// s1 += v - K, s2 += (v - K)^2, channel by channel
template <typename T>
__device__ __forceinline__ void shifted_sums(const Pack<T>& pk, const float (&K)[8],
                                             float (&s1)[8], float (&s2)[8]) {
  float v[8];
  unpack(pk, v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float d = v[i] - K[i];
    s1[i] += d;
    s2[i] += d * d;
  }
}

// Rows (positions) [b * rpb, min(rows, (b + 1) * rpb)) of CTA b; a thread
// takes channel group g = tid % G and every `lanes`-th row from its lane.
// Writes part[b][0][c] = mean, part[b][1][c] = M2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stem_bn_fw_stats(const T* __restrict__ x, long long rows, int C, long long rpb,
                     float* __restrict__ part) {
  __shared__ float s_mean[8 * kThreads], s_m2[8 * kThreads], s_n[kThreads];
  const int G = C / 8, lanes = blockDim.x / G;
  const int g = threadIdx.x % G, lane = threadIdx.x / G;
  const long long r0 = blockIdx.x * rpb, r1 = min(rows, r0 + rpb);
  const T* xc = x + g * 8;

  float K[8], s1[8], s2[8];
  float n = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) K[i] = s1[i] = s2[i] = 0.f;
  long long r = r0 + lane;
  if (r < r1) load8(xc + r * C, K);

  for (; r + 3 * lanes < r1; r += 4 * lanes) {
    const Pack<T> p0 = ld8(xc + r * C), p1 = ld8(xc + (r + lanes) * C);
    const Pack<T> p2 = ld8(xc + (r + 2 * lanes) * C), p3 = ld8(xc + (r + 3 * lanes) * C);
    shifted_sums(p0, K, s1, s2);
    shifted_sums(p1, K, s1, s2);
    shifted_sums(p2, K, s1, s2);
    shifted_sums(p3, K, s1, s2);
    n += 4.f;
  }
  for (; r < r1; r += lanes) {
    shifted_sums(ld8(xc + r * C), K, s1, s2);
    n += 1.f;
  }

  float mean[8], m2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float q = n > 0.f ? s1[i] / n : 0.f;
    mean[i] = K[i] + q;
    m2[i] = fmaxf(s2[i] - s1[i] * q, 0.f);
  }
  if (lane < lanes) {
    s_n[lane] = n;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s_mean[lane * C + g * 8 + i] = mean[i];
      s_m2[lane * C + g * 8 + i] = m2[i];
    }
  }
  int half = 1;
  while (half < lanes) half <<= 1;
  for (half >>= 1; half >= 1; half >>= 1) {
    __syncthreads();
    if (lane < half && lane + half < lanes) {
      const int o = lane + half;
      const float nb = s_n[o];
      float na = n;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float nn = na;
        chan(nn, mean[i], m2[i], nb, s_mean[o * C + g * 8 + i], s_m2[o * C + g * 8 + i]);
        s_mean[lane * C + g * 8 + i] = mean[i];
        s_m2[lane * C + g * 8 + i] = m2[i];
      }
      n = na + nb;
      if (g == 0) s_n[lane] = n;
    }
  }
  if (lane == 0) {
    float* out = part + blockIdx.x * 2LL * C + g * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      out[i] = mean[i];
      out[C + i] = m2[i];
    }
  }
}

// One CTA per channel c. Training: merges the `nblocks` partials of
// stem_bn_fw_stats (CTA b holds min(rpb, rows - b * rpb) rows) in a fixed
// tree, updates the running statistics (running = (1 - momentum) * running
// + momentum * batch, the variance biased) and num_batches_tracked; eval:
// takes the running statistics. stats = [mean | rstd | scale | shift], C
// each; y = x * scale + shift is the affine BN.
__global__ void __launch_bounds__(kMergeThreads)
    stem_bn_fw_merge(const float* __restrict__ part, int nblocks, long long rows,
                     long long rpb, int C, const float* __restrict__ weight,
                     const float* __restrict__ bias, float* running_mean, float* running_var,
                     long long* num_batches_tracked, float momentum, float eps, int training,
                     float* __restrict__ stats) {
  __shared__ double s_n[kMergeThreads];
  __shared__ float s_mean[kMergeThreads], s_m2[kMergeThreads];
  const int c = blockIdx.x, t = threadIdx.x;
  float mean, var;
  if (training) {
    double n = 0.0;
    float m = 0.f, M = 0.f;
    for (int b = t; b < nblocks; b += kMergeThreads) {
      const long long left = rows - b * rpb;
      const double nb = static_cast<double>(left < rpb ? (left > 0 ? left : 0) : rpb);
      chan(n, m, M, nb, part[b * 2LL * C + c], part[b * 2LL * C + C + c]);
    }
    s_n[t] = n; s_mean[t] = m; s_m2[t] = M;
    for (int half = kMergeThreads / 2; half >= 1; half >>= 1) {
      __syncthreads();
      if (t < half) {
        chan(n, m, M, s_n[t + half], s_mean[t + half], s_m2[t + half]);
        s_n[t] = n; s_mean[t] = m; s_m2[t] = M;
      }
    }
    if (t != 0) return;
    mean = m;
    var = static_cast<float>(M / static_cast<double>(rows));
    running_mean[c] = (1.f - momentum) * running_mean[c] + momentum * mean;
    running_var[c] = (1.f - momentum) * running_var[c] + momentum * var;
    if (c == 0) *num_batches_tracked += 1;
  } else {
    if (t != 0) return;
    mean = running_mean[c];
    var = running_var[c];
  }
  const float rstd = 1.f / sqrtf(var + eps);
  const float scale = weight[c] * rstd;
  stats[c] = mean;
  stats[C + c] = rstd;
  stats[2 * C + c] = scale;
  stats[3 * C + c] = bias[c] - mean * scale;
}

// ---- forward: normalise, ReLU, max-pool -----------------------------------

// CTA (blockIdx.x, blockIdx.y) = (image n and band of R output rows, chunk
// of gc channel groups). blockDim.x is a multiple of gc, so a thread keeps
// one channel group: g = tid % gc.
template <typename T, bool kIdx>
__global__ void __launch_bounds__(kThreads)
    stem_bn_fw_relu_max(const T* __restrict__ x, int H, int W, int C, int Ho, int Wo, int R,
                        int gc, const float* __restrict__ stats, T* __restrict__ out,
                        uint8_t* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int G = C / 8;
  const int bands = (Ho + R - 1) / R;
  const int n = blockIdx.x / bands, band = blockIdx.x % bands;
  const int oh0 = band * R, oh1 = min(Ho, oh0 + R);
  const int ih0 = max(0, 2 * oh0 - 1), ih1 = min(H, 2 * oh1);  // rows [ih0, ih1)
  const int g0 = blockIdx.y * gc, ng = min(gc, G - g0);
  const int g = threadIdx.x % gc, t0 = threadIdx.x / gc, ts = blockDim.x / gc;
  const int c = (g0 + g) * 8, width = gc * 8;  // width: channels a position holds in smem
  const bool active = g < ng;

  float a[8], s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = active ? stats[2 * C + c + i] : 0.f;
    s[i] = active ? stats[3 * C + c + i] : 0.f;
  }
  const T* xb = x + ((static_cast<long long>(n) * H + ih0) * W) * C + c;
  const int P = (ih1 - ih0) * W;  // the band's positions, contiguous in x

  auto norm = [&](const Pack<T>& pk, int p) {
    float v[8];
    unpack(pk, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float y = round_to(__fadd_rn(__fmul_rn(v[i], a[i]), s[i]), x);
      v[i] = y < 0.f ? 0.f : y;  // aten's ReLU: NaN and -0 pass
    }
    store8(sm + p * width + g * 8, v);
  };
  if (active) {
    int p = t0;
    for (; p + 3 * ts < P; p += 4 * ts) {
      const Pack<T> p0 = ld8(xb + static_cast<long long>(p) * C);
      const Pack<T> p1 = ld8(xb + static_cast<long long>(p + ts) * C);
      const Pack<T> p2 = ld8(xb + static_cast<long long>(p + 2 * ts) * C);
      const Pack<T> p3 = ld8(xb + static_cast<long long>(p + 3 * ts) * C);
      norm(p0, p);
      norm(p1, p + ts);
      norm(p2, p + 2 * ts);
      norm(p3, p + 3 * ts);
    }
    for (; p < P; p += ts) norm(ld8(xb + static_cast<long long>(p) * C), p);
  }
  __syncthreads();
  if (!active) return;

  const int Q = (oh1 - oh0) * Wo;
  for (int q = t0; q < Q; q += ts) {
    const int oh = oh0 + q / Wo, ow = q % Wo;
    float best[8];
    uint32_t arg[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      best[i] = __uint_as_float(0xff800000u);  // -inf
      arg[i] = 0;
    }
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int ih = 2 * oh - 1 + kh;
      if (ih < 0 || ih >= H) continue;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int iw = 2 * ow - 1 + kw;
        if (iw < 0 || iw >= W) continue;
        float v[8];
        unpack(*reinterpret_cast<const Pack<T>*>(sm + ((ih - ih0) * W + iw) * width + g * 8), v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (v[i] > best[i] || isnan(v[i])) {
            best[i] = v[i];
            arg[i] = kh * 3 + kw;
          }
        }
      }
    }
    const long long o = ((static_cast<long long>(n) * Ho + oh) * Wo + ow) * C + c;
    store8(out + o, best);
    if (kIdx) {
      uint32_t b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) b[i] = arg[i] | (best[i] <= 0.f ? 0x80u : 0u);
      *reinterpret_cast<uint2*>(idx + o) =
          make_uint2(b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24),
                     b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24));
    }
  }
}

// ---- backward --------------------------------------------------------------

// A thread of the backward takes a 2x2 block of input positions, rows 2k,
// 2k + 1 and columns 2j, 2j + 1 (k < Ho, j < Wo), for its 8 channels. The
// pooling windows that hold them are (k + dr, j + dc), dr, dc in {0, 1}:
// row 2k lies in window row k alone, row 2k + 1 in rows k and k + 1 (aten's
// p_start / p_end for kernel 3, stride 2, pad 1), and likewise for
// columns. The thread loads the four windows' offsets and pooled gradients
// and the four positions' x at once, so each thread keeps 12 loads in
// flight; neighbouring threads share windows through L1.
template <typename T>
struct Block {
  uint2 m[4];     // window (k + t / 2, j + t % 2)'s offsets
  Pack<T> g[4];   // its pooled gradients
  Pack<T> x[4];   // input (2k + p / 2, 2j + p % 2)
  bool win[4], pos[4];
  long long at[4];  // the position's element offset in x
};

template <typename T>
__device__ __forceinline__ void load_block(Block<T>& blk, const T* __restrict__ x,
                                           const T* __restrict__ gy,
                                           const uint8_t* __restrict__ idx, int n, int k, int j,
                                           int H, int W, int Ho, int Wo, int C, int c) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int oh = k + (t >> 1), ow = j + (t & 1);
    blk.win[t] = oh < Ho && ow < Wo;
    const long long o =
        ((static_cast<long long>(n) * Ho + min(oh, Ho - 1)) * Wo + min(ow, Wo - 1)) * C + c;
    blk.m[t] = __ldg(reinterpret_cast<const uint2*>(idx + o));
    blk.g[t] = ld8(gy + o);
    const int ih = 2 * k + (t >> 1), iw = 2 * j + (t & 1);
    blk.pos[t] = ih < H && iw < W;
    blk.at[t] = ((static_cast<long long>(n) * H + min(ih, H - 1)) * W + min(iw, W - 1)) * C + c;
    blk.x[t] = ld8(x + blk.at[t]);
  }
}

// The gradient at input (2k + a, 2j + b) after the max-pool's and the
// ReLU's backward, as aten gives it: the pooled gradients of the windows
// whose offset is this position, summed in fp32 in aten's window order
// (row, then column), the sum rounded to T. An offset with bit 7 set never
// matches: the ReLU passed no gradient there.
template <typename T>
__device__ __forceinline__ void block_dy(const Block<T>& blk, int a, int b, float (&dy)[8]) {
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int dr = t >> 1, dc = t & 1;
    if ((dr && !a) || (dc && !b) || !blk.win[t]) continue;
    const uint32_t off = (a - 2 * dr + 1) * 3 + (b - 2 * dc + 1);
    const uint32_t w[2] = {blk.m[t].x, blk.m[t].y};
    float v[8];
    unpack(blk.g[t], v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (((w[i / 4] >> (8 * (i % 4))) & 0xffu) == off) acc[i] += v[i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) dy[i] = round_to(acc[i], static_cast<const T*>(nullptr));
}

// Blocks [b * bpb, min(B, (b + 1) * bpb)) of CTA b, B = N * Ho * Wo; a
// thread takes channel group g = tid % G and every `lanes`-th block.
// Writes part[b][0][c] = sum dy, part[b][1][c] = sum dy * (x - mean).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stem_bn_bw_reduce(const T* __restrict__ x, const T* __restrict__ gy,
                      const uint8_t* __restrict__ idx, int H, int W, int C, int Ho, int Wo,
                      long long B, long long bpb, const float* __restrict__ stats,
                      float* __restrict__ part) {
  __shared__ float s_dy[8 * kThreads], s_dyx[8 * kThreads];
  const int G = C / 8, lanes = blockDim.x / G;
  const int g = threadIdx.x % G, lane = threadIdx.x / G, c = g * 8;
  const long long b0 = blockIdx.x * bpb, b1 = min(B, b0 + bpb);
  float m[8], sdy[8], sdyx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = stats[c + i];
    sdy[i] = sdyx[i] = 0.f;
  }
  const int per_image = Ho * Wo;
  for (long long q = b0 + lane; q < b1; q += lanes) {
    const int n = static_cast<int>(q / per_image), r = static_cast<int>(q % per_image);
    Block<T> blk;
    load_block(blk, x, gy, idx, n, r / Wo, r % Wo, H, W, Ho, Wo, C, c);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (!blk.pos[p]) continue;
      float dy[8], v[8];
      block_dy(blk, p >> 1, p & 1, dy);
      unpack(blk.x[p], v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sdy[i] += dy[i];
        sdyx[i] += dy[i] * (v[i] - m[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s_dy[lane * C + c + i] = sdy[i];
    s_dyx[lane * C + c + i] = sdyx[i];
  }
  int half = 1;
  while (half < lanes) half <<= 1;
  for (half >>= 1; half >= 1; half >>= 1) {
    __syncthreads();
    if (lane < half && lane + half < lanes) {
      const int o = (lane + half) * C + c;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sdy[i] += s_dy[o + i];
        sdyx[i] += s_dyx[o + i];
        s_dy[lane * C + c + i] = sdy[i];
        s_dyx[lane * C + c + i] = sdyx[i];
      }
    }
  }
  if (lane == 0) {
    float* out = part + blockIdx.x * 2LL * C + c;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      out[i] = sdy[i];
      out[C + i] = sdyx[i];
    }
  }
}

// One CTA per channel c: the partials of stem_bn_bw_reduce summed in a
// fixed tree; grad_weight = sum_dy_xmu * rstd, grad_bias = sum_dy; coef =
// [mean dy | rstd^2 * sum_dy_xmu / n | weight * rstd], C each (the first
// two 0 in eval mode, where the statistics are constants).
__global__ void __launch_bounds__(kMergeThreads)
    stem_bn_bw_merge(const float* __restrict__ part, int nblocks, long long rows, int C,
                     const float* __restrict__ stats, const float* __restrict__ weight,
                     int training, float* __restrict__ grad_weight,
                     float* __restrict__ grad_bias, float* __restrict__ coef) {
  __shared__ float s_dy[kMergeThreads], s_dyx[kMergeThreads];
  const int c = blockIdx.x, t = threadIdx.x;
  float dy = 0.f, dyx = 0.f;
  for (int b = t; b < nblocks; b += kMergeThreads) {
    dy += part[b * 2LL * C + c];
    dyx += part[b * 2LL * C + C + c];
  }
  s_dy[t] = dy;
  s_dyx[t] = dyx;
  for (int half = kMergeThreads / 2; half >= 1; half >>= 1) {
    __syncthreads();
    if (t < half) {
      dy += s_dy[t + half];
      dyx += s_dyx[t + half];
      s_dy[t] = dy;
      s_dyx[t] = dyx;
    }
  }
  if (t != 0) return;
  const float rstd = stats[C + c];
  const float norm = static_cast<float>(1.0 / static_cast<double>(rows));
  grad_weight[c] = dyx * rstd;
  grad_bias[c] = dy;
  coef[c] = training ? dy * norm : 0.f;
  coef[C + c] = training ? rstd * rstd * dyx * norm : 0.f;
  coef[2 * C + c] = weight[c] * rstd;
}

// Blocks in a grid-stride loop; blockDim.x is a multiple of G, so a thread
// keeps its channel group.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stem_bn_bw_elemt(const T* __restrict__ x, const T* __restrict__ gy,
                     const uint8_t* __restrict__ idx, int H, int W, int C, int Ho, int Wo,
                     long long B, const float* __restrict__ stats,
                     const float* __restrict__ coef, T* __restrict__ dx) {
  const int G = C / 8, lanes = blockDim.x / G;
  const int g = threadIdx.x % G, lane = threadIdx.x / G, c = g * 8;
  float m[8], k0[8], k1[8], k2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = stats[c + i];
    k0[i] = coef[c + i];
    k1[i] = coef[C + c + i];
    k2[i] = coef[2 * C + c + i];
  }
  const int per_image = Ho * Wo;
  for (long long q = static_cast<long long>(blockIdx.x) * lanes + lane; q < B;
       q += static_cast<long long>(gridDim.x) * lanes) {
    const int n = static_cast<int>(q / per_image), r = static_cast<int>(q % per_image);
    Block<T> blk;
    load_block(blk, x, gy, idx, n, r / Wo, r % Wo, H, W, Ho, Wo, C, c);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (!blk.pos[p]) continue;
      float dy[8], v[8];
      block_dy(blk, p >> 1, p & 1, dy);
      unpack(blk.x[p], v);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = (dy[i] - k0[i] - (v[i] - m[i]) * k1[i]) * k2[i];
      store8(dx + blk.at[p], v);
    }
  }
}

// ---- launches --------------------------------------------------------------

inline int threads_for(int groups) { return (kThreads / groups) * groups; }

template <typename T>
int fw_stats(const void* x, long long rows, int C, int nblocks, long long rpb, float* part,
             cudaStream_t s) {
  stem_bn_fw_stats<T><<<nblocks, threads_for(C / 8), 0, s>>>(static_cast<const T*>(x), rows,
                                                               C, rpb, part);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kIdx>
int fw_apply(const void* x, int N, int H, int W, int C, int R, int gc, const float* stats,
             void* out, uint8_t* idx, cudaStream_t s) {
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const int bands = (Ho + R - 1) / R, G = C / 8;
  const int rows_in = min(H, 2 * R + 1);
  const size_t smem = static_cast<size_t>(rows_in) * W * gc * 8 * sizeof(T);
  auto kernel = stem_bn_fw_relu_max<T, kIdx>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(N * bands, (G + gc - 1) / gc);
  kernel<<<grid, threads_for(gc), smem, s>>>(static_cast<const T*>(x), H, W, C, Ho, Wo, R, gc,
                                             stats, static_cast<T*>(out), idx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bw_reduce(const void* x, const void* gy, const uint8_t* idx, int N, int H, int W, int C,
              int nblocks, long long bpb, const float* stats, float* part, cudaStream_t s) {
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long B = static_cast<long long>(N) * Ho * Wo;
  stem_bn_bw_reduce<T><<<nblocks, threads_for(C / 8), 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), idx, H, W, C, Ho, Wo, B, bpb, stats,
      part);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bw_elemt(const void* x, const void* gy, const uint8_t* idx, int N, int H, int W, int C,
             int nblocks, const float* stats, const float* coef, void* dx, cudaStream_t s) {
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long B = static_cast<long long>(N) * Ho * Wo;
  stem_bn_bw_elemt<T><<<nblocks, threads_for(C / 8), 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), idx, H, W, C, Ho, Wo, B, stats, coef,
      static_cast<T*>(dx));
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int resident(K kernel, int threads, int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, 0));
}

}  // namespace

// Each function launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success). `bf16` selects __nv_bfloat16 (1) or
// float (0) for x, out, gy and dx. The wrapper (ops/stem.py) checks shapes,
// types, alignment and sizes; these trust them.
extern "C" {

// The CTAs of `threads` threads one SM holds at once of kernel 0
// (stem_bn_fw_stats), 1 (stem_bn_bw_reduce) or 2 (stem_bn_bw_elemt), into
// *blocks: the wrapper sizes their grids to one full wave. Launches nothing.
int ssv_stem_resident(int kernel, int bf16, int threads, int* blocks) {
  switch (kernel * 2 + (bf16 ? 1 : 0)) {
    case 0: return resident(stem_bn_fw_stats<float>, threads, blocks);
    case 1: return resident(stem_bn_fw_stats<__nv_bfloat16>, threads, blocks);
    case 2: return resident(stem_bn_bw_reduce<float>, threads, blocks);
    case 3: return resident(stem_bn_bw_reduce<__nv_bfloat16>, threads, blocks);
    case 4: return resident(stem_bn_bw_elemt<float>, threads, blocks);
    case 5: return resident(stem_bn_bw_elemt<__nv_bfloat16>, threads, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int ssv_stem_bn_fw_stats(const void* x, int bf16, long long rows, int C, int nblocks,
                         long long rpb, float* part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? fw_stats<__nv_bfloat16>(x, rows, C, nblocks, rpb, part, s)
              : fw_stats<float>(x, rows, C, nblocks, rpb, part, s);
}

int ssv_stem_bn_fw_merge(const float* part, int nblocks, long long rows, long long rpb, int C,
                         const float* weight, const float* bias, float* running_mean,
                         float* running_var, long long* num_batches_tracked, float momentum,
                         float eps, int training, float* stats, void* stream) {
  stem_bn_fw_merge<<<C, kMergeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      part, nblocks, rows, rpb, C, weight, bias, running_mean, running_var,
      num_batches_tracked, momentum, eps, training, stats);
  return static_cast<int>(cudaGetLastError());
}

int ssv_stem_bn_fw_relu_max(const void* x, int bf16, int N, int H, int W, int C, int R, int gc,
                            const float* stats, void* out, uint8_t* idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return idx ? fw_apply<__nv_bfloat16, true>(x, N, H, W, C, R, gc, stats, out, idx, s)
               : fw_apply<__nv_bfloat16, false>(x, N, H, W, C, R, gc, stats, out, idx, s);
  }
  return idx ? fw_apply<float, true>(x, N, H, W, C, R, gc, stats, out, idx, s)
             : fw_apply<float, false>(x, N, H, W, C, R, gc, stats, out, idx, s);
}

int ssv_stem_bn_bw_reduce(const void* x, const void* gy, const uint8_t* idx, int bf16, int N,
                          int H, int W, int C, int nblocks, long long bpb, const float* stats,
                          float* part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bw_reduce<__nv_bfloat16>(x, gy, idx, N, H, W, C, nblocks, bpb, stats, part, s)
              : bw_reduce<float>(x, gy, idx, N, H, W, C, nblocks, bpb, stats, part, s);
}

int ssv_stem_bn_bw_merge(const float* part, int nblocks, long long rows, int C,
                         const float* stats, const float* weight, int training,
                         float* grad_weight, float* grad_bias, float* coef, void* stream) {
  stem_bn_bw_merge<<<C, kMergeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      part, nblocks, rows, C, stats, weight, training, grad_weight, grad_bias, coef);
  return static_cast<int>(cudaGetLastError());
}

int ssv_stem_bn_bw_elemt(const void* x, const void* gy, const uint8_t* idx, int bf16, int N,
                         int H, int W, int C, int nblocks, const float* stats, const float* coef,
                         void* dx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bw_elemt<__nv_bfloat16>(x, gy, idx, N, H, W, C, nblocks, stats, coef, dx, s)
              : bw_elemt<float>(x, gy, idx, N, H, W, C, nblocks, stats, coef, dx, s);
}

}  // extern "C"
