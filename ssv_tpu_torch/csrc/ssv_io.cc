// ssv_io — native dataset IO for the PyTorch port (ssv_tpu_torch), a copy of
// native/ssv_io.cc with the same C entries, built by ssv_tpu_torch/ops/build.py
// and bound by ssv_tpu_torch/data/native_io.py.
//
// The reference delegates dataset IO to torchvision/PIL (C-backed): pickle
// batches are decoded per worker process every run (data_utils.py:99-131).
// Here the native layer owns the host-side data path that remains after
// moving augmentation on-device:
//
//   * read the published CIFAR *binary* format (data_batch_N.bin rows of
//     [label][3072 bytes CHW]) with CHW->HWC transposition,
//   * write/read a flat .raw cache (magic + dims + uint8 payload) so later
//     startups are a single sequential read straight into the numpy buffer
//     (no zlib/npz, no pickle),
//   * multithreaded uint8 CHW->HWC repacking for the pickle path, where
//     python hands us the raw decoded buffer.
//
// Exposed as a plain C ABI, loaded with ctypes (no Python headers needed).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// CHW (3,32,32) -> HWC (32,32,3) for n images, parallel over images.
// src: n*3072 bytes CHW; dst: n*3072 bytes HWC.
void chw_to_hwc_u8(const uint8_t* src, uint8_t* dst, int64_t n, int h, int w,
                   int c, int n_threads) {
  const int64_t img = (int64_t)h * w * c;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* s = src + i * img;
      uint8_t* d = dst + i * img;
      for (int ch = 0; ch < c; ++ch) {
        const uint8_t* plane = s + (int64_t)ch * h * w;
        for (int y = 0; y < h; ++y) {
          const uint8_t* row = plane + (int64_t)y * w;
          uint8_t* drow = d + ((int64_t)y * w) * c + ch;
          for (int x = 0; x < w; ++x) drow[(int64_t)x * c] = row[x];
        }
      }
    }
  };
  if (n_threads <= 1 || n < 64) {
    work(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// Read one CIFAR binary batch file: rows of [label(1B or 2B)][3072B CHW].
// coarse_bytes: 1 for cifar10, 2 for cifar100 (coarse+fine; fine kept).
// Returns number of images read, or -1 on error.
int64_t read_cifar_binary(const char* path, int label_bytes, uint8_t* images,
                          int32_t* labels, int64_t max_n) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const int64_t row = label_bytes + 3072;
  std::vector<uint8_t> buf(row);
  std::vector<uint8_t> chw(3072);
  int64_t n = 0;
  while (n < max_n && std::fread(buf.data(), 1, row, f) == (size_t)row) {
    labels[n] = buf[label_bytes - 1];  // fine label is the last label byte
    std::memcpy(chw.data(), buf.data() + label_bytes, 3072);
    chw_to_hwc_u8(chw.data(), images + n * 3072, 1, 32, 32, 3, 1);
    ++n;
  }
  std::fclose(f);
  return n;
}

// Flat raw cache: [magic u64][n u64][h u32][w u32][c u32][pad u32]
// [labels n*i32][images n*h*w*c u8]
static const uint64_t kMagic = 0x5353565f52415731ULL;  // "SSV_RAW1"

int write_raw_cache(const char* path, const uint8_t* images,
                    const int32_t* labels, int64_t n, int h, int w, int c) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint64_t n64 = (uint64_t)n;
  uint32_t dims[4] = {(uint32_t)h, (uint32_t)w, (uint32_t)c, 0};
  bool ok = std::fwrite(&kMagic, 8, 1, f) == 1 &&
            std::fwrite(&n64, 8, 1, f) == 1 &&
            std::fwrite(dims, 4, 4, f) == 4 &&
            std::fwrite(labels, 4, (size_t)n, f) == (size_t)n &&
            std::fwrite(images, 1, (size_t)(n * h * w * c), f) ==
                (size_t)(n * h * w * c);
  std::fclose(f);
  return ok ? 0 : -1;
}

// Returns n on success (after filling header fields), -1 on failure.
int64_t read_raw_cache_header(const char* path, int32_t* hwc) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint64_t magic = 0, n = 0;
  uint32_t dims[4];
  bool ok = std::fread(&magic, 8, 1, f) == 1 && magic == kMagic &&
            std::fread(&n, 8, 1, f) == 1 && std::fread(dims, 4, 4, f) == 4;
  std::fclose(f);
  if (!ok) return -1;
  hwc[0] = (int32_t)dims[0];
  hwc[1] = (int32_t)dims[1];
  hwc[2] = (int32_t)dims[2];
  return (int64_t)n;
}

int read_raw_cache(const char* path, uint8_t* images, int32_t* labels,
                   int64_t n, int h, int w, int c) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 8 + 8 + 16, SEEK_SET);
  bool ok = std::fread(labels, 4, (size_t)n, f) == (size_t)n &&
            std::fread(images, 1, (size_t)(n * h * w * c), f) ==
                (size_t)(n * h * w * c);
  std::fclose(f);
  return ok ? 0 : -1;
}

}  // extern "C"
