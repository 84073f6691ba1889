// Native scanline mesh rasterizer for demo overlay rendering.
//
// The port's own copy of whmr_tpu's native/rasterizer.cpp (the same
// functions and arguments). It replaces the reference's pyrender/EGL
// offscreen renderer (utils/renderer_cam.py:26-33,130-136) for the demo
// output path: project a camera-space SMPL mesh with a pinhole camera,
// z-buffer rasterize with flat Lambert shading, and alpha-blend over the
// input image. Host-side by design: overlay rendering happens at full image
// resolution per *person* while the card runs the next batch.
//
// Build: whmr_tpu_torch/inference/renderer.py compiles it at first use with
// `g++ -O3 -fPIC -shared -fopenmp` into build/whmr_tpu_torch/ and binds it
// with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Render a triangle mesh over an RGB image (in place).
//
// verts:  n_verts * 3 floats, camera-space (x right, y down, z forward).
// faces:  n_faces * 3 int32 indices.
// focal, cx, cy: pinhole intrinsics in pixels.
// color:  RGBA in [0,1]; alpha blends the shaded mesh over the image.
// image:  h * w * 3 uint8, modified in place.
// zbuf:   caller-provided h * w floats; pass the same buffer across calls
//         to depth-compose multiple meshes. Initialize to +inf (or call
//         whmr_clear_zbuf).
void whmr_render_overlay(
    const float* verts, int n_verts,
    const int32_t* faces, int n_faces,
    float focal, float cx, float cy,
    const float* color,
    uint8_t* image, float* zbuf,
    int h, int w) {
  // Project all vertices once.
  std::vector<float> px(n_verts), py(n_verts), pz(n_verts);
  for (int i = 0; i < n_verts; ++i) {
    float x = verts[i * 3 + 0];
    float y = verts[i * 3 + 1];
    float z = verts[i * 3 + 2];
    pz[i] = z;
    float inv_z = (z > 1e-6f) ? 1.0f / z : 0.0f;
    px[i] = x * inv_z * focal + cx;
    py[i] = y * inv_z * focal + cy;
  }

  const float light_dir[3] = {0.0f, -0.4f, -0.9f};  // towards camera, above
  const float ambient = 0.45f;

  // Per-face precompute: bbox, shading. Parallelize over row bands so each
  // thread owns a disjoint slice of the z-buffer (no races).
#if defined(_OPENMP)
  int n_threads = omp_get_max_threads();
#else
  int n_threads = 1;
#endif
  int band_h = (h + n_threads - 1) / n_threads;

#if defined(_OPENMP)
#pragma omp parallel num_threads(n_threads)
#endif
  {
#if defined(_OPENMP)
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    int y_lo = tid * band_h;
    int y_hi = std::min(h, y_lo + band_h);

    for (int f = 0; f < n_faces; ++f) {
      int i0 = faces[f * 3 + 0];
      int i1 = faces[f * 3 + 1];
      int i2 = faces[f * 3 + 2];
      if (pz[i0] <= 1e-6f || pz[i1] <= 1e-6f || pz[i2] <= 1e-6f) continue;

      float x0 = px[i0], y0 = py[i0];
      float x1 = px[i1], y1 = py[i1];
      float x2 = px[i2], y2 = py[i2];

      float minx = std::min({x0, x1, x2});
      float maxx = std::max({x0, x1, x2});
      float miny = std::max(static_cast<float>(y_lo), std::min({y0, y1, y2}));
      float maxy = std::min(static_cast<float>(y_hi - 1), std::max({y0, y1, y2}));
      if (miny > maxy || maxx < 0 || minx > w - 1) continue;

      float area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0);
      if (std::fabs(area) < 1e-9f) continue;
      float inv_area = 1.0f / area;

      // Flat normal in camera space for Lambert shading.
      float ax = verts[i1 * 3] - verts[i0 * 3];
      float ay = verts[i1 * 3 + 1] - verts[i0 * 3 + 1];
      float az = verts[i1 * 3 + 2] - verts[i0 * 3 + 2];
      float bx = verts[i2 * 3] - verts[i0 * 3];
      float by = verts[i2 * 3 + 1] - verts[i0 * 3 + 1];
      float bz = verts[i2 * 3 + 2] - verts[i0 * 3 + 2];
      float nx = ay * bz - az * by;
      float ny = az * bx - ax * bz;
      float nz = ax * by - ay * bx;
      float nlen = std::sqrt(nx * nx + ny * ny + nz * nz);
      float shade = ambient;
      if (nlen > 1e-12f) {
        float ndl = (nx * light_dir[0] + ny * light_dir[1] + nz * light_dir[2]) / nlen;
        shade = ambient + (1.0f - ambient) * std::fabs(ndl);
      }
      float r = std::min(1.0f, color[0] * shade) * 255.0f;
      float g = std::min(1.0f, color[1] * shade) * 255.0f;
      float b = std::min(1.0f, color[2] * shade) * 255.0f;
      float alpha = color[3];

      int ix0 = std::max(0, static_cast<int>(std::floor(minx)));
      int ix1 = std::min(w - 1, static_cast<int>(std::ceil(maxx)));
      int iy0 = static_cast<int>(std::floor(miny));
      int iy1 = static_cast<int>(std::ceil(maxy));
      iy0 = std::max(iy0, y_lo);
      iy1 = std::min(iy1, y_hi - 1);

      for (int y = iy0; y <= iy1; ++y) {
        float fy = y + 0.5f;
        for (int x = ix0; x <= ix1; ++x) {
          float fx = x + 0.5f;
          float w0 = ((x1 - fx) * (y2 - fy) - (y1 - fy) * (x2 - fx)) * inv_area;
          float w1 = ((x2 - fx) * (y0 - fy) - (y2 - fy) * (x0 - fx)) * inv_area;
          float w2 = 1.0f - w0 - w1;
          if (w0 < 0 || w1 < 0 || w2 < 0) continue;
          float z = w0 * pz[i0] + w1 * pz[i1] + w2 * pz[i2];
          int idx = y * w + x;
          if (z >= zbuf[idx]) continue;
          zbuf[idx] = z;
          uint8_t* p = image + idx * 3;
          p[0] = static_cast<uint8_t>(alpha * r + (1 - alpha) * p[0]);
          p[1] = static_cast<uint8_t>(alpha * g + (1 - alpha) * p[1]);
          p[2] = static_cast<uint8_t>(alpha * b + (1 - alpha) * p[2]);
        }
      }
    }
  }
}

void whmr_clear_zbuf(float* zbuf, int n) {
  for (int i = 0; i < n; ++i) zbuf[i] = 1e30f;
}

// Batched bilinear bbox crop+resize (uint8 HWC) — native fallback of the
// loader's warpAffine path for environments without cv2. dst is
// n * out_h * out_w * 3.
void whmr_crop_resize(
    const uint8_t* src, int src_h, int src_w,
    const float* boxes,  // n * 4: cx, cy, box_h, box_w
    int n, uint8_t* dst, int out_h, int out_w) {
#if defined(_OPENMP)
#pragma omp parallel for
#endif
  for (int i = 0; i < n; ++i) {
    float cx = boxes[i * 4 + 0];
    float cy = boxes[i * 4 + 1];
    float bh = boxes[i * 4 + 2];
    float bw = boxes[i * 4 + 3];
    uint8_t* out = dst + static_cast<long>(i) * out_h * out_w * 3;
    for (int y = 0; y < out_h; ++y) {
      float sy = cy - bh / 2 + (y + 0.5f) * bh / out_h - 0.5f;
      int y0 = static_cast<int>(std::floor(sy));
      float wy = sy - y0;
      for (int x = 0; x < out_w; ++x) {
        float sx = cx - bw / 2 + (x + 0.5f) * bw / out_w - 0.5f;
        int x0 = static_cast<int>(std::floor(sx));
        float wx = sx - x0;
        for (int c = 0; c < 3; ++c) {
          float acc = 0.0f;
          for (int dy = 0; dy < 2; ++dy) {
            int yy = y0 + dy;
            if (yy < 0 || yy >= src_h) continue;
            float fy = dy ? wy : 1 - wy;
            for (int dx = 0; dx < 2; ++dx) {
              int xx = x0 + dx;
              if (xx < 0 || xx >= src_w) continue;
              float fx = dx ? wx : 1 - wx;
              acc += fy * fx * src[(static_cast<long>(yy) * src_w + xx) * 3 + c];
            }
          }
          out[(static_cast<long>(y) * out_w + x) * 3 + c] =
              static_cast<uint8_t>(std::min(255.0f, std::max(0.0f, acc)));
        }
      }
    }
  }
}

}  // extern "C"
