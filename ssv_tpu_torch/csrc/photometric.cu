// Fused photometric augmentation: RandomApply(ColorJitter) + RandomGrayscale.
//
// Replaces the Pallas TPU kernel `fused_photometric` (body `_kernel`) in
// ssv_tpu/ops/pallas/photometric.py. Per image it applies brightness,
// contrast, saturation and hue in the image's own random order, then the
// grayscale gate, with the image held in registers between the ops.
//
// What bounds it on an H100. The bytes: a 32x32 image is 12 KB read and
// 12 KB written, 12.6 MB per call at batch 512, 3.76 us at 3.35 TB/s. But
// the op chain is long (IEEE divisions, multiplies and adds kept apart,
// selects), and measured on the card (PERF.md) the chain, not memory, sets
// the time at batch 512: a call takes about as long as the SMs need to
// execute it with all the batch's images resident at once. Moving the bytes by bulk asynchronous copies through
// shared memory was measured slower at that batch, so the design stays:
// read each pixel once and write it once, one CTA per image, 256 threads,
// each thread keeping its ceil(H*W/256) pixels (3 channels each) in
// registers across all four ops (up to 16 a thread; a larger image makes
// each op a pass over `out`). The only cross-thread step is contrast's mean
// of the grayscale, a block reduction (warp shuffles, then one partial per
// warp in shared memory).
//
// Layout: images and out are (B, H*W, 3) float32, i.e. contiguous NHWC.
// order is (B, 4) int32, params is (B, 5) float32 =
// [brightness, contrast, saturation, hue_shift, gray_gate].
//
// Numerics follow the plain version op for op: IEEE division, no fast-math,
// no contracted multiply-adds, floor-mod for the hue wrap, and the hue op
// is skipped for a shift of exactly 0 so that identity factors return the
// input unchanged. The hue code is shorter than the plain version's but
// gives its bits; chip_smoke.py holds the kernel against it on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRegisterHW = 16 * kThreads;  // 64x64; larger runs from out

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

__device__ __forceinline__ float gray_of(float r, float g, float b) {
  return 0.299f * r + 0.587f * g + 0.114f * b;
}

__device__ __forceinline__ float blend(float a, float b, float f) {
  return clip01(f * a + (1.f - f) * b);
}

// Python/JAX float remainder with divisor 1 (the result has the divisor's
// sign). Equal in value to fmodf(x, 1) plus 1 when negative; the hue wrap
// only meets x in [-1, 2), where x - floor(x) is exact for x >= 0 and
// rounds x + 1 as the fmodf form does for x < 0. The one bit difference,
// +0 against -0 at x = -1, gives the same sector and the same pixel.
__device__ __forceinline__ float mod1(float x) {
  return x - floorf(x);
}

__device__ __forceinline__ void hue_shift(float& r, float& g, float& b,
                                          float shift) {
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float v = maxc;
  const float delta = maxc - minc;
  const float s = (maxc > 0.f) ? delta / fmaxf(maxc, 1e-12f) : 0.f;
  const float safe = fmaxf(delta, 1e-12f);
  // h = bc - gc, 2 + rc - bc or 4 + gc - rc (xc = (maxc - x) / safe) by the
  // channel that holds the max: only the two divisions that branch uses
  // (0 + bc is bc exactly).
  const bool rmax = maxc == r, gmax = !rmax && maxc == g;
  const float off = rmax ? 0.f : (gmax ? 2.f : 4.f);
  const float first = (maxc - (rmax ? b : (gmax ? r : g))) / safe;
  const float second = (maxc - (rmax ? g : (gmax ? b : r))) / safe;
  float h = (off + first) - second;
  h = mod1(h / 6.f);
  if (delta == 0.f) h = 0.f;

  h = mod1(h + shift);
  const float h6 = h * 6.f;
  const float fi = floorf(h6);
  const float f = h6 - fi;
  const float p = v * (1.f - s);
  const float q = v * (1.f - s * f);
  const float t = v * (1.f - s * (1.f - f));
  // h in [0, 1], so fi in [0, 6]; h may round to exactly 1.0, giving
  // sector 6, which wraps to 0. Selects rather than a switch, since
  // neighbouring pixels fall in different sectors.
  const int i = (fi >= 6.f) ? 0 : static_cast<int>(fi);
  r = (i == 0 || i == 5) ? v : (i == 1) ? q : (i <= 3) ? p : t;
  g = (i == 0) ? t : (i <= 2) ? v : (i == 3) ? q : p;
  b = (i <= 1) ? p : (i == 2) ? t : (i <= 4) ? v : q;
}

// Sum of v over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* partials) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partials[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += partials[w];
  __syncthreads();  // partials may be reused by a later reduction
  return total;
}

// One op of the jitter other than contrast, on one pixel. Ops: 0 brightness,
// 2 saturation, 3 hue (skipped for a shift of exactly 0).
__device__ __forceinline__ void pointwise_op(int op, float& r, float& g, float& b,
                                             float fb, float fs, float fh) {
  if (op == 0) {
    r = clip01(fb * r);
    g = clip01(fb * g);
    b = clip01(fb * b);
  } else if (op == 2) {
    const float y = gray_of(r, g, b);
    r = blend(r, y, fs);
    g = blend(g, y, fs);
    b = blend(b, y, fs);
  } else if (op == 3 && fh != 0.f) {
    hue_shift(r, g, b, fh);
  }
}

__device__ __forceinline__ void contrast_op(float& r, float& g, float& b,
                                            float mean, float fc) {
  r = blend(r, mean, fc);
  g = blend(g, mean, fc);
  b = blend(b, mean, fc);
}

__device__ __forceinline__ void gray_gate(float& r, float& g, float& b,
                                          float gate) {
  if (gate > 0.5f) r = g = b = gray_of(r, g, b);
}

// lax.switch clamps an out-of-range branch index; so does this.
__device__ __forceinline__ int op_at(const int* order, long long img, int j) {
  return min(max(order[img * 4 + j], 0), 3);
}

// The image in registers: thread t owns pixels t, t + 256, ... (PPT of them).
template <int PPT>
__global__ void __launch_bounds__(kThreads)
photometric_kernel(const float* __restrict__ images,
                   const int* __restrict__ order,
                   const float* __restrict__ params,
                   float* __restrict__ out, int hw) {
  __shared__ float partials[kWarps];
  const long long img = blockIdx.x;
  const float* src = images + img * hw * 3;
  float* dst = out + img * hw * 3;
  const float* prm = params + img * 5;

  float r[PPT], g[PPT], b[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p < hw) {
      r[k] = src[3 * p];
      g[k] = src[3 * p + 1];
      b[k] = src[3 * p + 2];
    } else {
      r[k] = g[k] = b[k] = 0.f;
    }
  }

  for (int j = 0; j < 4; ++j) {
    const int op = op_at(order, img, j);
    if (op == 1) {
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (threadIdx.x + k * kThreads < hw) part += gray_of(r[k], g[k], b[k]);
      }
      const float mean = block_sum(part, partials) / static_cast<float>(hw);
#pragma unroll
      for (int k = 0; k < PPT; ++k) contrast_op(r[k], g[k], b[k], mean, prm[1]);
    } else {
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        pointwise_op(op, r[k], g[k], b[k], prm[0], prm[2], prm[3]);
    }
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p < hw) {
      gray_gate(r[k], g[k], b[k], prm[4]);
      dst[3 * p] = r[k];
      dst[3 * p + 1] = g[k];
      dst[3 * p + 2] = b[k];
    }
  }
}

// Images too large for registers (H*W > kMaxRegisterHW): the same op chain,
// each op a pass over the image in `out`. A thread reads back only the
// pixels it wrote itself, so only contrast's reduction synchronises.
__global__ void __launch_bounds__(kThreads)
photometric_kernel_large(const float* __restrict__ images,
                         const int* __restrict__ order,
                         const float* __restrict__ params,
                         float* __restrict__ out, int hw) {
  __shared__ float partials[kWarps];
  const long long img = blockIdx.x;
  const float* src = images + img * hw * 3;
  float* dst = out + img * hw * 3;
  const float* prm = params + img * 5;

  for (int p = threadIdx.x; p < hw; p += kThreads) {
    dst[3 * p] = src[3 * p];
    dst[3 * p + 1] = src[3 * p + 1];
    dst[3 * p + 2] = src[3 * p + 2];
  }
  for (int j = 0; j < 4; ++j) {
    const int op = op_at(order, img, j);
    float mean = 0.f;
    if (op == 1) {
      float part = 0.f;
      for (int p = threadIdx.x; p < hw; p += kThreads)
        part += gray_of(dst[3 * p], dst[3 * p + 1], dst[3 * p + 2]);
      mean = block_sum(part, partials) / static_cast<float>(hw);
    }
    for (int p = threadIdx.x; p < hw; p += kThreads) {
      float r = dst[3 * p], g = dst[3 * p + 1], b = dst[3 * p + 2];
      if (op == 1) {
        contrast_op(r, g, b, mean, prm[1]);
      } else {
        pointwise_op(op, r, g, b, prm[0], prm[2], prm[3]);
      }
      dst[3 * p] = r;
      dst[3 * p + 1] = g;
      dst[3 * p + 2] = b;
    }
  }
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    float r = dst[3 * p], g = dst[3 * p + 1], b = dst[3 * p + 2];
    gray_gate(r, g, b, prm[4]);
    dst[3 * p] = r;
    dst[3 * p + 1] = g;
    dst[3 * p + 2] = b;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int ssv_fused_photometric(const float* images, const int* order,
                          const float* params, float* out, int batch, int hw,
                          void* stream) {
  if (batch <= 0 || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ppt = (hw + kThreads - 1) / kThreads;
  const dim3 grid(batch), block(kThreads);
  if (ppt <= 1) {
    photometric_kernel<1><<<grid, block, 0, s>>>(images, order, params, out, hw);
  } else if (ppt <= 2) {
    photometric_kernel<2><<<grid, block, 0, s>>>(images, order, params, out, hw);
  } else if (ppt <= 4) {
    photometric_kernel<4><<<grid, block, 0, s>>>(images, order, params, out, hw);
  } else if (ppt <= 8) {
    photometric_kernel<8><<<grid, block, 0, s>>>(images, order, params, out, hw);
  } else if (hw <= kMaxRegisterHW) {
    photometric_kernel<16><<<grid, block, 0, s>>>(images, order, params, out, hw);
  } else {
    photometric_kernel_large<<<grid, block, 0, s>>>(images, order, params, out, hw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
