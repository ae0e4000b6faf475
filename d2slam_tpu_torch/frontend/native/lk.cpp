// Native pyramidal Lucas-Kanade tracker for the frontend's host path.
//
// The association glue runs on the host CPU. This is the same job the reference does with OpenCV's
// SparsePyrLKOpticalFlow (reference:
// d2frontend/src/opticaltrack_utils.cpp:44-170 opticalflowTrackPyr)
// at 20 Hz on a Jetson CPU. Semantics: 2x2 average-pool pyramid, bilinear sampling
// with border clamp, central-difference template gradients,
// fixed-Hessian forward-additive iterations, det gate, forward-
// backward consistency check.
//
// Key layout trick: every sample of a patch shares ONE fractional
// offset, so the 4 bilinear weights hoist out of the loop and patch
// extraction becomes a pure FMA sweep over 4 shifted rows — the
// compiler vectorizes it; no per-sample floor/clamp on the fast path.
//
// Build: g++ -O3 -fPIC -shared -o liblk.so lk.cpp -lpthread

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Level {
  std::vector<float> img, dx, dy;  // image + central-difference grads
  int H, W;
};

// 2x2 average pooling, VALID padding,
// then central-difference gradient images (0.5*(I[x+1]-I[x-1]) with
// border clamp — identical to bilinear-of-shifted-samples away from
// borders because bilinear interpolation is linear in the image).
static void build_pyramid(const float* img, int H, int W, int levels,
                          std::vector<Level>& pyr) {
  pyr.resize(levels + 1);
  pyr[0].img.assign(img, img + (size_t)H * W);
  pyr[0].H = H;
  pyr[0].W = W;
  for (int l = 1; l <= levels; ++l) {
    const Level& a = pyr[l - 1];
    Level& b = pyr[l];
    b.H = a.H / 2;
    b.W = a.W / 2;
    b.img.resize((size_t)b.H * b.W);
    for (int y = 0; y < b.H; ++y) {
      const float* r0 = a.img.data() + (size_t)(2 * y) * a.W;
      const float* r1 = r0 + a.W;
      float* o = b.img.data() + (size_t)y * b.W;
      for (int x = 0; x < b.W; ++x) {
        o[x] = 0.25f * (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] +
                        r1[2 * x + 1]);
      }
    }
  }
  for (auto& lv : pyr) {
    const int h = lv.H, w = lv.W;
    lv.dx.resize((size_t)h * w);
    lv.dy.resize((size_t)h * w);
    const float* im = lv.img.data();
    for (int y = 0; y < h; ++y) {
      const int ym = y > 0 ? y - 1 : 0;
      const int yp = y < h - 1 ? y + 1 : h - 1;
      float* ox = lv.dx.data() + (size_t)y * w;
      float* oy = lv.dy.data() + (size_t)y * w;
      const float* rm = im + (size_t)ym * w;
      const float* rp = im + (size_t)yp * w;
      const float* rc = im + (size_t)y * w;
      for (int x = 0; x < w; ++x) {
        const int xm = x > 0 ? x - 1 : 0;
        const int xp = x < w - 1 ? x + 1 : w - 1;
        ox[x] = 0.5f * (rc[xp] - rc[xm]);
        oy[x] = 0.5f * (rp[x] - rm[x]);
      }
    }
  }
}

static inline float bilinear(const float* img, int H, int W, float x,
                             float y) {
  int x0 = (int)std::floor(x);
  int y0 = (int)std::floor(y);
  if (x0 < 0) x0 = 0;
  if (x0 > W - 2) x0 = W - 2;
  if (y0 < 0) y0 = 0;
  if (y0 > H - 2) y0 = H - 2;
  float wx = x - x0;
  float wy = y - y0;
  if (wx < 0.f) wx = 0.f;
  if (wx > 1.f) wx = 1.f;
  if (wy < 0.f) wy = 0.f;
  if (wy > 1.f) wy = 1.f;
  const float* p = img + (size_t)y0 * W + x0;
  float v00 = p[0], v01 = p[1], v10 = p[W], v11 = p[W + 1];
  return v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) +
         v10 * (1 - wx) * wy + v11 * wx * wy;
}

// Extract a win x win patch centered at (cx, cy) with bilinear
// sampling. Fast path when the whole (win+1)^2 support is interior:
// hoisted weights + contiguous FMA rows. Border fallback per sample.
static void sample_patch(const float* img, int H, int W, float cx,
                         float cy, int win, float* out) {
  const int r = win / 2;
  const float xs = cx - r, ys = cy - r;
  const int x0 = (int)std::floor(xs);
  const int y0 = (int)std::floor(ys);
  if (x0 >= 0 && y0 >= 0 && x0 + win < W && y0 + win < H) {
    const float wx = xs - x0, wy = ys - y0;
    const float w00 = (1 - wx) * (1 - wy), w01 = wx * (1 - wy);
    const float w10 = (1 - wx) * wy, w11 = wx * wy;
    for (int iy = 0; iy < win; ++iy) {
      const float* p = img + (size_t)(y0 + iy) * W + x0;
      const float* q = p + W;
      float* o = out + (size_t)iy * win;
      for (int ix = 0; ix < win; ++ix) {
        o[ix] = w00 * p[ix] + w01 * p[ix + 1] + w10 * q[ix] +
                w11 * q[ix + 1];
      }
    }
    return;
  }
  for (int iy = 0; iy < win; ++iy) {
    for (int ix = 0; ix < win; ++ix) {
      out[(size_t)iy * win + ix] =
          bilinear(img, H, W, xs + ix, ys + iy);
    }
  }
}

// One direction's coarse-to-fine track of a single point.
static void track_point(const std::vector<Level>& pa,
                        const std::vector<Level>& pb, float px0, float py0,
                        int win, int iters, float* tI, float* tIx,
                        float* tIy, float* tJ, float* out_dx,
                        float* out_dy, bool* out_good) {
  const int np = win * win;
  float gx = 0.f, gy = 0.f;  // flow at full resolution
  bool good = true;
  for (int lvl = (int)pa.size() - 1; lvl >= 0; --lvl) {
    const Level& A = pa[lvl];
    const Level& B = pb[lvl];
    const float scale = (float)(1 << lvl);
    const float cx = px0 / scale, cy = py0 / scale;
    float lgx = gx / scale, lgy = gy / scale;
    sample_patch(A.img.data(), A.H, A.W, cx, cy, win, tI);
    sample_patch(A.dx.data(), A.H, A.W, cx, cy, win, tIx);
    sample_patch(A.dy.data(), A.H, A.W, cx, cy, win, tIy);
    float A11 = 0.f, A12 = 0.f, A22 = 0.f;
    for (int k = 0; k < np; ++k) {
      A11 += tIx[k] * tIx[k];
      A12 += tIx[k] * tIy[k];
      A22 += tIy[k] * tIy[k];
    }
    const float det = A11 * A22 - A12 * A12;
    if (det <= 1e-6f) good = false;
    const float inv_det = 1.0f / (det > 1e-9f ? det : 1e-9f);
    for (int it = 0; it < iters; ++it) {
      sample_patch(B.img.data(), B.H, B.W, cx + lgx, cy + lgy, win, tJ);
      float b1 = 0.f, b2 = 0.f;
      for (int k = 0; k < np; ++k) {
        const float err = tJ[k] - tI[k];
        b1 += err * tIx[k];
        b2 += err * tIy[k];
      }
      const float ddx = -(A22 * b1 - A12 * b2) * inv_det;
      const float ddy = -(-A12 * b1 + A11 * b2) * inv_det;
      lgx += ddx;
      lgy += ddy;
      if (ddx * ddx + ddy * ddy < 1e-4f) break;  // < 0.01 px step
    }
    gx = lgx * scale;
    gy = lgy * scale;
  }
  *out_dx = gx;
  *out_dy = gy;
  *out_good = good;
}

}  // namespace

extern "C" int lk_pyr_track(const float* prev_img, const float* next_img,
                            int H, int W, const float* pts,
                            const uint8_t* valid, int n, int levels,
                            int win, int iters, float fb_thresh,
                            int n_threads, float* out_pts,
                            uint8_t* out_ok) {
  if (levels < 0 || win < 3 || n < 0) return -1;
  std::vector<Level> pa, pb;
  build_pyramid(prev_img, H, W, levels, pa);
  build_pyramid(next_img, H, W, levels, pb);

  auto work = [&](int lo, int hi) {
    const int np = win * win;
    std::vector<float> buf(4 * (size_t)np);
    float* tI = buf.data();
    float* tIx = tI + np;
    float* tIy = tIx + np;
    float* tJ = tIy + np;
    for (int i = lo; i < hi; ++i) {
      const float px = pts[2 * i], py = pts[2 * i + 1];
      if (!valid[i]) {
        out_pts[2 * i] = px;
        out_pts[2 * i + 1] = py;
        out_ok[i] = 0;
        continue;
      }
      float dx, dy;
      bool gf;
      track_point(pa, pb, px, py, win, iters, tI, tIx, tIy, tJ, &dx,
                  &dy, &gf);
      const float fx = px + dx, fy = py + dy;
      // backward pass from the forward endpoint
      float bdx, bdy;
      bool gb;
      track_point(pb, pa, fx, fy, win, iters, tI, tIx, tIy, tJ, &bdx,
                  &bdy, &gb);
      const float ex = fx + bdx - px, ey = fy + bdy - py;
      const bool inb = fx >= 1.f && fx < W - 1 && fy >= 1.f && fy < H - 1;
      out_pts[2 * i] = fx;
      out_pts[2 * i + 1] = fy;
      out_ok[i] = (gf && gb && inb &&
                   ex * ex + ey * ey < fb_thresh * fb_thresh)
                      ? 1
                      : 0;
    }
  };

  if (n_threads <= 1 || n < 32) {
    work(0, n);
  } else {
    std::vector<std::thread> ts;
    const int per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      const int lo = t * per;
      const int hi = lo + per < n ? lo + per : n;
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  return 0;
}
