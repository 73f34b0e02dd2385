// rangeproj — the host-side range-image kernels of dusty_gan_torch's data
// path, bound with ctypes by dusty_gan_torch/data/native.py.
//
// The arithmetic equals native/rangeproj.cpp's, the JAX package's library,
// operation for operation, so items and projections agree bit for bit
// between the two packages; the numpy paths of data/datasets.py and
// data/preprocess.py repeat the same float32 operations.
//   - rangeproj_project_scan: quadrant-transition scan-line segmentation +
//     yaw binning + far-to-near painter scatter (nearest point wins).
//   - rangeproj_preprocess_item: the per-item dataset pipeline
//     (depth/mask/unit-xyz + optional flip + NEAREST subsample) in one pass
//     over the scan.
//
// Built by data/native.py with g++ -O3 -fPIC -shared -std=c++17
// -ffp-contract=off: a contracted x*x + y*y + z*z (one FMA) rounds
// differently from numpy's, and -march=native would tie the library to
// the host that built it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// points: (n, c) float32 with xyz in the first 3 channels; out: (h, w, c)
// zero-initialized by the caller or here.  Returns number of scan lines.
int rangeproj_project_scan(const float* points, int64_t n, int c, int h,
                           int w, float* out) {
  std::memset(out, 0, sizeof(float) * (size_t)h * w * c);
  if (n <= 0) return 0;

  std::vector<int32_t> grid_h((size_t)n), grid_w((size_t)n);
  std::vector<float> depth((size_t)n);
  std::vector<int64_t> order((size_t)n);

  // quadrant ids and scan-line starts (4th -> 1st quadrant transition)
  std::vector<int8_t> quads((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    const float x = points[i * c + 0];
    const float y = points[i * c + 1];
    const float z = points[i * c + 2];
    depth[i] = std::sqrt(x * x + y * y + z * z);
    int8_t q;
    if (x >= 0.f) q = (y >= 0.f) ? 0 : 3;
    else          q = (y >= 0.f) ? 1 : 2;
    quads[i] = q;
  }
  // start indices where quads[i-1] - quads[i] == 3 (with wraparound roll)
  std::vector<int64_t> starts;
  for (int64_t i = 0; i < n; ++i) {
    const int8_t prev = quads[(i + n - 1) % n];
    if ((int)prev - (int)quads[i] == 3) starts.push_back(i);
  }
  const int n_lines = (int)starts.size();

  // vertical rows: segment s -> row (h - n_lines + s); pre-start points -> 0
  {
    int64_t si = 0;
    for (int64_t i = 0; i < n; ++i) {
      while (si < (int64_t)starts.size() && starts[si] <= i) ++si;
      const int64_t seg = si - 1;  // index of last start <= i
      int row = (seg < 0) ? 0 : (h - n_lines + (int)seg);
      row = std::min(std::max(row, 0), h - 1);
      grid_h[i] = row;
    }
  }

  // horizontal bins from yaw
  for (int64_t i = 0; i < n; ++i) {
    const float x = points[i * c + 0];
    const float y = points[i * c + 1];
    const float yaw = -std::atan2(y, x);
    float u = (yaw / (float)M_PI + 1.0f) * 0.5f;
    u = u - std::floor(u);  // mod 1
    int col = (int)std::floor(u * w);
    col = std::min(std::max(col, 0), w - 1);
    grid_w[i] = col;
  }

  // painter's order: far first, near overwrites (stable sort matches
  // numpy argsort(-depth, kind='stable')? numpy default is quicksort;
  // ties are measure-zero for real scans — use stable for determinism)
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return depth[a] > depth[b]; });

  for (int64_t k = 0; k < n; ++k) {
    const int64_t i = order[k];
    float* dst = out + ((size_t)grid_h[i] * w + grid_w[i]) * c;
    std::memcpy(dst, points + i * c, sizeof(float) * c);
  }
  return n_lines;
}

// Full-res (h0, w0, >=3) xyz range image -> model-res depth/mask/xyz.
// depth_out: (h, w) normalized [0,1]; mask_out: (h, w); xyz_out: (h, w, 3)
// unit space. flip: horizontal flip at FULL resolution before subsample.
void rangeproj_preprocess_item(const float* scan, int h0, int w0, int c,
                               float min_depth, float max_depth, int flip,
                               int h, int w, float* depth_out,
                               float* mask_out, float* xyz_out) {
  const float inv_range = 1.0f / (max_depth - min_depth);
  const float inv_max = 1.0f / max_depth;
  for (int i = 0; i < h; ++i) {
    const int si = (int)((int64_t)i * h0 / h);  // floor(i * h0 / h)
    for (int j = 0; j < w; ++j) {
      int sj = (int)((int64_t)j * w0 / w);
      if (flip) sj = w0 - 1 - sj;
      const float* p = scan + ((size_t)si * w0 + sj) * c;
      const float x = p[0], y = p[1], z = p[2];
      const float d = std::sqrt(x * x + y * y + z * z);
      const bool valid = (d > 0.f) && (d > min_depth) && (d < max_depth);
      const size_t o = (size_t)i * w + j;
      depth_out[o] = valid ? (d - min_depth) * inv_range : 0.f;
      mask_out[o] = valid ? 1.f : 0.f;
      xyz_out[o * 3 + 0] = valid ? x * inv_max : 0.f;
      xyz_out[o * 3 + 1] = valid ? y * inv_max : 0.f;
      xyz_out[o * 3 + 2] = valid ? z * inv_max : 0.f;
    }
  }
}

}  // extern "C"
