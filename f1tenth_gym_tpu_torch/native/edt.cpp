// Native preprocessing kernels for f1tenth_gym_tpu.
//
// Exact Euclidean distance transform (Felzenszwalb & Huttenlocher,
// "Distance Transforms of Sampled Functions", Theory of Computing 2012):
// separable lower-envelope-of-parabolas passes over rows and columns,
// O(n) per 1D pass, exact squared distances.
//
// The reference does this with scipy.ndimage (laser_models.py:40-53); this
// is the framework's native replacement for the map-pipeline hot path
// (multi-thousand-map dataset preprocessing / random track generation).
//
// Build: see build.sh (g++ -O3 -shared -fPIC). ABI: plain C, used via ctypes.

#include <cstdint>
#include <cmath>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();
// Large-but-finite seed for free cells: true infinity breaks the envelope
// recurrence (inf - inf = NaN, and (finite - inf)/x = -inf underflows the
// stack index k below 0).
constexpr double kBig = 1e18;

// 1D squared distance transform of f (length n) into d.
// v: parabola sites, z: boundaries. Scratch arrays provided by caller.
void dt_1d(const double* f, double* d, int* v, double* z, int64_t n) {
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int64_t q = 1; q < n; ++q) {
    double s;
    for (;;) {
      s = ((f[q] + q * (double)q) - (f[v[k]] + v[k] * (double)v[k])) /
          (2.0 * q - 2.0 * v[k]);
      if (s <= z[k]) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = (int)q;
    z[k] = s;
    z[k + 1] = kInf;
  }
  k = 0;
  for (int64_t q = 0; q < n; ++q) {
    while (z[k + 1] < (double)q) ++k;
    double dq = (double)q - v[k];
    d[q] = dq * dq + f[v[k]];
  }
}

}  // namespace

extern "C" {

// mask: (h, w) row-major, nonzero = free space. out: (h, w) distance in
// cells from each free cell to the nearest non-free cell (0 on obstacles).
void edt_2d(const uint8_t* mask, double* out, int64_t h, int64_t w) {
  std::vector<double> f(std::max(h, w));
  std::vector<double> d(std::max(h, w));
  std::vector<int> v(std::max(h, w));
  std::vector<double> z(std::max(h, w) + 1);

  // pass 1: columns. Seed 0 at obstacles, inf at free cells.
  std::vector<double> tmp((size_t)h * w);
  for (int64_t x = 0; x < w; ++x) {
    for (int64_t y = 0; y < h; ++y) {
      f[y] = mask[y * w + x] ? kBig : 0.0;
    }
    dt_1d(f.data(), d.data(), v.data(), z.data(), h);
    for (int64_t y = 0; y < h; ++y) {
      tmp[y * w + x] = d[y];
    }
  }

  // pass 2: rows.
  for (int64_t y = 0; y < h; ++y) {
    dt_1d(&tmp[y * w], d.data(), v.data(), z.data(), w);
    for (int64_t x = 0; x < w; ++x) {
      out[y * w + x] = std::sqrt(d[x]);
    }
  }
}

}  // extern "C"
