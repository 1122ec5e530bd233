// Native ray-bank builder: the host-side data pipeline as C++ (the port's
// copy of nerf_replication_tpu/native/raybank.cpp).
//
// For every frame, generate pinhole rays (datasets/rays.get_rays_np math),
// composite RGBA onto white, and write the flat [N,6]/[N,3] banks the
// trainer uploads to the device once. A plain C ABI for ctypes; work is
// split across std::thread by frame.
//
// Two roundings differ from the JAX package's copy, so that the bank is
// bit for bit the numpy builder's (native/__init__.py): a pixel's value is
// divided by 255 (not multiplied by its float reciprocal), and R @ dir is
// the chain numpy's matmul evaluates, fma(dy, r_1, dx * r_0) - r_2.

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// rays for one frame: dirs = K^-1 pixel dirs rotated by c2w; origin = c2w[:,3]
// (blender.py:13-32: x right, y up, camera looks down -z, dirs unnormalized)
void frame_rays(const float* c2w /*[16] row-major 4x4*/, int H, int W,
                float focal, float* rays /*[H*W*6]*/) {
  const float cx = 0.5f * static_cast<float>(W);
  const float cy = 0.5f * static_cast<float>(H);
  const float r00 = c2w[0], r01 = c2w[1], r02 = c2w[2], tx = c2w[3];
  const float r10 = c2w[4], r11 = c2w[5], r12 = c2w[6], ty = c2w[7];
  const float r20 = c2w[8], r21 = c2w[9], r22 = c2w[10], tz = c2w[11];
  for (int j = 0; j < H; ++j) {
    const float dy = -(static_cast<float>(j) - cy) / focal;
    float* row = rays + static_cast<size_t>(j) * W * 6;
    for (int i = 0; i < W; ++i) {
      const float dx = (static_cast<float>(i) - cx) / focal;
      // dir = R @ [dx, dy, -1]
      const float wx = std::fma(dy, r01, dx * r00) - r02;
      const float wy = std::fma(dy, r11, dx * r10) - r12;
      const float wz = std::fma(dy, r21, dx * r20) - r22;
      float* p = row + static_cast<size_t>(i) * 6;
      p[0] = tx;
      p[1] = ty;
      p[2] = tz;
      p[3] = wx;
      p[4] = wy;
      p[5] = wz;
    }
  }
}

// RGBA uint8 -> float rgb composited onto white (blender.py:92-93);
// 3-channel input is a plain [0,1] scale.
void frame_rgbs(const uint8_t* img, int n_pixels, int channels,
                float* rgbs /*[n_pixels*3]*/) {
  if (channels == 4) {
    for (int p = 0; p < n_pixels; ++p) {
      const uint8_t* px = img + static_cast<size_t>(p) * 4;
      const float a = static_cast<float>(px[3]) / 255.0f;
      float* out = rgbs + static_cast<size_t>(p) * 3;
      for (int c = 0; c < 3; ++c) {
        const float v = static_cast<float>(px[c]) / 255.0f;
        out[c] = v * a + (1.0f - a);
      }
    }
  } else {
    for (int p = 0; p < n_pixels; ++p) {
      const uint8_t* px = img + static_cast<size_t>(p) * channels;
      float* out = rgbs + static_cast<size_t>(p) * 3;
      for (int c = 0; c < 3; ++c) {
        out[c] = static_cast<float>(px[c]) / 255.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

// poses: [n_images, 16] row-major c2w; images: [n_images, H*W*channels] u8;
// rays_out: [n_images*H*W, 6]; rgbs_out: [n_images*H*W, 3].
void build_ray_bank(const float* poses, const uint8_t* images, int n_images,
                    int H, int W, int channels, float focal, int n_threads,
                    float* rays_out, float* rgbs_out) {
  const size_t n_pixels = static_cast<size_t>(H) * W;
  auto work = [&](int begin, int end) {
    for (int f = begin; f < end; ++f) {
      frame_rays(poses + static_cast<size_t>(f) * 16, H, W, focal,
                 rays_out + static_cast<size_t>(f) * n_pixels * 6);
      frame_rgbs(images + static_cast<size_t>(f) * n_pixels * channels,
                 static_cast<int>(n_pixels), channels,
                 rgbs_out + static_cast<size_t>(f) * n_pixels * 3);
    }
  };
  if (n_threads <= 1 || n_images <= 1) {
    work(0, n_images);
    return;
  }
  const int workers = n_threads < n_images ? n_threads : n_images;
  std::vector<std::thread> threads;
  threads.reserve(workers);
  const int per = (n_images + workers - 1) / workers;
  for (int t = 0; t < workers; ++t) {
    const int begin = t * per;
    const int end = begin + per < n_images ? begin + per : n_images;
    if (begin >= end) break;
    threads.emplace_back(work, begin, end);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
