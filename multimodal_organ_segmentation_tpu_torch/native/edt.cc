// Felzenszwalb & Huttenlocher exact Euclidean distance transform, 3D,
// anisotropic sampling, multi-threaded over scan lines.
//
// A copy of the JAX package's native/edt.cc for the PyTorch port's surface
// metrics (HD95, NSD, ASSD): the squared-distance lower-envelope transform
// applied separably per axis. ops/edt.py builds it with g++ at first use.
//
// C ABI (ctypes):
//   edt_3d(const uint8_t* mask, double* out,
//          int64_t nx, int64_t ny, int64_t nz,
//          double sx, double sy, double sz, int n_threads)
// computes, for every voxel, the Euclidean distance to the nearest voxel
// where mask != 0 (scipy semantics: distance_transform_edt(~fg) ==
// edt_3d(fg)).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// 1D squared-distance transform (lower envelope of parabolas).
// f: input squared distances; d: output; spacing w between samples.
void dt1d(const double* f, double* d, int64_t n, double w,
          int* v, double* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  const double w2 = w * w;
  for (int64_t q = 1; q < n; ++q) {
    if (f[q] == kInf) continue;
    double s;
    while (true) {
      const int p = v[k];
      if (f[p] == kInf) {
        // previous parabola is infinite: replace it
        if (--k < 0) break;
        continue;
      }
      s = ((f[q] + w2 * q * q) - (f[p] + w2 * p * p)) / (2 * w2 * (q - p));
      if (s > z[k]) break;
      if (--k < 0) break;
    }
    ++k;
    v[k] = static_cast<int>(q);
    z[k] = (k == 0) ? -kInf : s;
    z[k + 1] = kInf;
  }
  if (f[v[0]] == kInf) {
    // no finite parabola on this line
    for (int64_t q = 0; q < n; ++q) d[q] = kInf;
    return;
  }
  k = 0;
  for (int64_t q = 0; q < n; ++q) {
    while (z[k + 1] < static_cast<double>(q)) ++k;
    const double dq = w * (q - v[k]);
    d[q] = dq * dq + f[v[k]];
  }
}

// Apply dt1d along one axis of a 3D volume stored C-contiguous (x, y, z).
void transform_axis(double* vol, int64_t nx, int64_t ny, int64_t nz,
                    int axis, double spacing, int n_threads) {
  const int64_t strides[3] = {ny * nz, nz, 1};
  const int64_t dims[3] = {nx, ny, nz};
  const int64_t n = dims[axis];
  const int64_t stride = strides[axis];

  // enumerate lines: all (i, j) over the two other axes
  int a1 = (axis + 1) % 3, a2 = (axis + 2) % 3;
  const int64_t n_lines = dims[a1] * dims[a2];

  auto worker = [&](int64_t lo, int64_t hi) {
    std::vector<double> f(n), d(n), z(n + 1);
    std::vector<int> v(n);
    for (int64_t line = lo; line < hi; ++line) {
      const int64_t i = line / dims[a2];
      const int64_t j = line % dims[a2];
      const int64_t base = i * strides[a1] + j * strides[a2];
      double* p = vol + base;
      for (int64_t q = 0; q < n; ++q) f[q] = p[q * stride];
      dt1d(f.data(), d.data(), n, spacing, v.data(), z.data());
      for (int64_t q = 0; q < n; ++q) p[q * stride] = d[q];
    }
  };

  if (n_threads <= 1 || n_lines < 64) {
    worker(0, n_lines);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n_lines + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(n_lines, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void edt_3d(const uint8_t* mask, double* out, int64_t nx, int64_t ny,
            int64_t nz, double sx, double sy, double sz, int n_threads) {
  const int64_t total = nx * ny * nz;
  for (int64_t i = 0; i < total; ++i) {
    out[i] = mask[i] ? 0.0 : kInf;
  }
  transform_axis(out, nx, ny, nz, 2, sz, n_threads);
  transform_axis(out, nx, ny, nz, 1, sy, n_threads);
  transform_axis(out, nx, ny, nz, 0, sx, n_threads);
  for (int64_t i = 0; i < total; ++i) {
    out[i] = std::sqrt(out[i]);
  }
}

}  // extern "C"
