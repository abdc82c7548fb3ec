// Host-side image feeder functions for the glimpse_tpu_torch device pipeline.
//
// Multithreaded conversion and tile preparation that keeps the host ahead of
// the device stream (frame feeding in track_stream). Exposed via ctypes and
// built with g++ at first use (see ../__init__.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(begin, end) over [0, n) split across hardware threads.
template <typename F>
void parallel_for(int64_t n, int nthreads, F fn) {
  if (nthreads <= 0) {
    nthreads = static_cast<int>(std::thread::hardware_concurrency());
    if (nthreads <= 0) nthreads = 4;
  }
  nthreads = static_cast<int>(
      std::min<int64_t>(nthreads, std::max<int64_t>(n, 1)));
  if (nthreads == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = std::min<int64_t>(begin + chunk, n);
    if (begin >= end) break;
    threads.emplace_back([=] { fn(begin, end); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// RGB(A)/gray uint8 -> grayscale float32 (channel mean, matching the
// tracker's grayscale reduction). `channels` may be 1, 3, or 4 (alpha
// ignored). Rows are processed in parallel.
void gray_f32(const uint8_t* src, int64_t height, int64_t width,
              int64_t channels, float* dst, int nthreads) {
  int64_t used = channels >= 3 ? 3 : channels;
  float inv = 1.0f / static_cast<float>(used);
  parallel_for(height, nthreads, [=](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      const uint8_t* row = src + r * width * channels;
      float* out = dst + r * width;
      for (int64_t c = 0; c < width; ++c) {
        int32_t acc = 0;
        for (int64_t k = 0; k < used; ++k) acc += row[c * channels + k];
        out[c] = static_cast<float>(acc) * inv;
      }
    }
  });
}

// Gather n fixed-size (th x tw) float32 tiles from an (H x W) image at
// integer upper-left corners (row, col) pairs, clamped to stay in bounds.
void extract_tiles_f32(const float* img, int64_t H, int64_t W,
                       const int32_t* corners, int64_t n, int64_t th,
                       int64_t tw, float* out, int nthreads) {
  parallel_for(n, nthreads, [=](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      int64_t r0 = corners[2 * i];
      int64_t c0 = corners[2 * i + 1];
      r0 = std::max<int64_t>(0, std::min<int64_t>(r0, H - th));
      c0 = std::max<int64_t>(0, std::min<int64_t>(c0, W - tw));
      float* tile = out + i * th * tw;
      for (int64_t r = 0; r < th; ++r) {
        std::memcpy(tile + r * tw, img + (r0 + r) * W + c0,
                    sizeof(float) * tw);
      }
    }
  });
}

// In-place mean-0 / std-1 normalization of n stacked (th x tw) tiles.
void normalize_tiles_f32(float* tiles, int64_t n, int64_t size,
                         int nthreads) {
  parallel_for(n, nthreads, [=](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      float* t = tiles + i * size;
      double sum = 0;
      for (int64_t k = 0; k < size; ++k) sum += t[k];
      double mean = sum / size;
      double var = 0;
      for (int64_t k = 0; k < size; ++k) {
        double d = t[k] - mean;
        var += d * d;
      }
      float inv_std = var > 0 ? static_cast<float>(1.0 / std::sqrt(var / size))
                              : 0.0f;
      for (int64_t k = 0; k < size; ++k) {
        t[k] = (t[k] - static_cast<float>(mean)) * inv_std;
      }
    }
  });
}

// Median high-pass with reflect boundary over n stacked (H x W) tiles:
// out = tile - median_{ky x kx}(tile). Matches scipy.ndimage.median_filter
// (mode='reflect') composed as in the tracker's preprocessing.
void median_highpass_f32(const float* tiles, int64_t n, int64_t H, int64_t W,
                         int64_t ky, int64_t kx, float* out, int nthreads) {
  int64_t py = ky / 2, px = kx / 2;
  parallel_for(n, nthreads, [=](int64_t i0, int64_t i1) {
    std::vector<float> window(ky * kx);
    for (int64_t i = i0; i < i1; ++i) {
      const float* t = tiles + i * H * W;
      float* o = out + i * H * W;
      for (int64_t r = 0; r < H; ++r) {
        for (int64_t c = 0; c < W; ++c) {
          int64_t m = 0;
          for (int64_t dy = -py; dy < ky - py; ++dy) {
            int64_t rr = r + dy;
            if (rr < 0) rr = -rr - 1;      // reflect ('symmetric')
            if (rr >= H) rr = 2 * H - rr - 1;
            for (int64_t dx = -px; dx < kx - px; ++dx) {
              int64_t cc = c + dx;
              if (cc < 0) cc = -cc - 1;
              if (cc >= W) cc = 2 * W - cc - 1;
              window[m++] = t[rr * W + cc];
            }
          }
          auto mid = window.begin() + m / 2;
          std::nth_element(window.begin(), mid, window.begin() + m);
          float median = *mid;
          if (m % 2 == 0) {
            // Even window: scipy uses the average of the two middle values.
            float lower =
                *std::max_element(window.begin(), window.begin() + m / 2);
            median = 0.5f * (median + lower);
          }
          o[r * W + c] = t[r * W + c] - median;
        }
      }
    }
  });
}

}  // extern "C"
