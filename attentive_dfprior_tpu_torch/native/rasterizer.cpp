// Native mesh depth rasterizer (z-buffer).
//
// Role: replaces the open3d / pyrender offscreen depth renders the reference
// uses in evaluation (ref: src/tools/eval_recon.py:163-212,
// src/tools/evaluate_scannet.py:120-152) — neither library is available in
// this environment, and a tight C++ loop rasterizes a 500x500 view of a
// million-triangle mesh in milliseconds.
//
// Convention: OpenCV camera (+z forward). Callers flip OpenGL poses first.
// Exposed via ctypes (attentive_dfprior_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

extern "C" {

// Rasterize triangle depth into depth_out (H*W, row-major), which must be
// pre-filled with 0 (meaning "no hit"). Depth written is camera z (meters).
void rasterize_depth(const float* verts, int64_t n_verts,
                     const int32_t* faces, int64_t n_faces,
                     const float* w2c,  // 4x4 row-major world->camera
                     float fx, float fy, float cx, float cy,
                     int32_t H, int32_t W,
                     float* depth_out) {
  // transform vertices to camera space and project
  float* xs = new float[n_verts];
  float* ys = new float[n_verts];
  float* zs = new float[n_verts];
  for (int64_t i = 0; i < n_verts; ++i) {
    const float X = verts[3 * i], Y = verts[3 * i + 1], Z = verts[3 * i + 2];
    const float x = w2c[0] * X + w2c[1] * Y + w2c[2] * Z + w2c[3];
    const float y = w2c[4] * X + w2c[5] * Y + w2c[6] * Z + w2c[7];
    const float z = w2c[8] * X + w2c[9] * Y + w2c[10] * Z + w2c[11];
    zs[i] = z;
    if (z > 1e-6f) {
      xs[i] = fx * x / z + cx;
      ys[i] = fy * y / z + cy;
    } else {
      xs[i] = std::numeric_limits<float>::quiet_NaN();
      ys[i] = std::numeric_limits<float>::quiet_NaN();
    }
  }

  const float INF = std::numeric_limits<float>::infinity();
  float* zbuf = new float[(size_t)H * W];
  for (int64_t i = 0; i < (int64_t)H * W; ++i) zbuf[i] = INF;

  for (int64_t f = 0; f < n_faces; ++f) {
    const int32_t a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
    const float za = zs[a], zb = zs[b], zc = zs[c];
    if (!(za > 1e-6f && zb > 1e-6f && zc > 1e-6f)) continue;  // clip near
    const float xa = xs[a], ya = ys[a];
    const float xb = xs[b], yb = ys[b];
    const float xc = xs[c], yc = ys[c];
    int x0 = (int)std::floor(std::min({xa, xb, xc}));
    int x1 = (int)std::ceil(std::max({xa, xb, xc}));
    int y0 = (int)std::floor(std::min({ya, yb, yc}));
    int y1 = (int)std::ceil(std::max({ya, yb, yc}));
    x0 = std::max(x0, 0); y0 = std::max(y0, 0);
    x1 = std::min(x1, W - 1); y1 = std::min(y1, H - 1);
    if (x0 > x1 || y0 > y1) continue;

    const float d = (xb - xa) * (yc - ya) - (xc - xa) * (yb - ya);
    if (std::fabs(d) < 1e-12f) continue;
    const float inv_d = 1.0f / d;
    // perspective-correct interpolation of depth via 1/z
    const float iza = 1.0f / za, izb = 1.0f / zb, izc = 1.0f / zc;

    for (int py = y0; py <= y1; ++py) {
      for (int px = x0; px <= x1; ++px) {
        const float qx = px + 0.0f, qy = py + 0.0f;
        float w1 = ((qx - xa) * (yc - ya) - (xc - xa) * (qy - ya)) * inv_d;
        float w2 = ((xb - xa) * (qy - ya) - (qx - xa) * (yb - ya)) * inv_d;
        float w0 = 1.0f - w1 - w2;
        if (w0 < -1e-6f || w1 < -1e-6f || w2 < -1e-6f) continue;
        const float iz = w0 * iza + w1 * izb + w2 * izc;
        const float z = 1.0f / iz;
        float* zp = &zbuf[(size_t)py * W + px];
        if (z < *zp) *zp = z;
      }
    }
  }

  for (int64_t i = 0; i < (int64_t)H * W; ++i)
    depth_out[i] = (zbuf[i] == INF) ? 0.0f : zbuf[i];

  delete[] xs; delete[] ys; delete[] zs; delete[] zbuf;
}

}  // extern "C"
