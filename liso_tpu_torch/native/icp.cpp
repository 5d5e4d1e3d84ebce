// Native LiDAR odometry + nearest-neighbor kernels (C ABI, loaded via
// ctypes from liso_tpu_torch.data.icp). The port's copy of the JAX
// package's native/icp.cpp.
//
// Replaces the reference's external C++ deps for the offline ETL:
//   * kiss-icp (point-to-point voxel-hash ICP odometry,
//     reference datasets/kitti/create_kitti_raw.py:39-177 uses the pip
//     package) -> icp_register(): voxel-downsampled source vs voxel-hash
//     map of the target, Gauss-Newton point-to-point with outlier
//     threshold, constant-velocity initialisation handled by the caller;
//   * pynanoflann 1-NN (slim_loss/knn_graph.py) for host-side consumers ->
//     nn1_query(): grid-hash accelerated nearest neighbor.
//
// Build: liso_tpu_torch.data.icp builds it with g++ at first use.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct VoxelKey {
  int32_t x, y, z;
  bool operator==(const VoxelKey &o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

struct VoxelKeyHash {
  size_t operator()(const VoxelKey &k) const {
    // large-prime spatial hash
    return static_cast<size_t>(k.x) * 73856093u ^
           static_cast<size_t>(k.y) * 19349669u ^
           static_cast<size_t>(k.z) * 83492791u;
  }
};

using VoxelMap = std::unordered_map<VoxelKey, std::vector<int>, VoxelKeyHash>;

VoxelKey key_of(const double *p, double inv_voxel) {
  return VoxelKey{static_cast<int32_t>(std::floor(p[0] * inv_voxel)),
                  static_cast<int32_t>(std::floor(p[1] * inv_voxel)),
                  static_cast<int32_t>(std::floor(p[2] * inv_voxel))};
}

VoxelMap build_map(const double *pts, int n, double voxel) {
  VoxelMap m;
  m.reserve(static_cast<size_t>(n));
  const double inv = 1.0 / voxel;
  for (int i = 0; i < n; ++i) {
    m[key_of(pts + 3 * i, inv)].push_back(i);
  }
  return m;
}

// nearest neighbor of q in (map, pts) searching the 3x3x3 voxel shell
int nn_in_map(const VoxelMap &map, const double *pts, const double *q,
              double voxel, double max_dist, double *best_d2_out) {
  const double inv = 1.0 / voxel;
  VoxelKey c = key_of(q, inv);
  int best = -1;
  double best_d2 = max_dist * max_dist;
  for (int dx = -1; dx <= 1; ++dx)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dz = -1; dz <= 1; ++dz) {
        auto it = map.find(VoxelKey{c.x + dx, c.y + dy, c.z + dz});
        if (it == map.end()) continue;
        for (int i : it->second) {
          const double *p = pts + 3 * i;
          double d2 = (p[0] - q[0]) * (p[0] - q[0]) +
                      (p[1] - q[1]) * (p[1] - q[1]) +
                      (p[2] - q[2]) * (p[2] - q[2]);
          if (d2 < best_d2) {
            best_d2 = d2;
            best = i;
          }
        }
      }
  if (best_d2_out) *best_d2_out = best_d2;
  return best;
}

void transform_point(const double *T, const double *p, double *out) {
  for (int r = 0; r < 3; ++r)
    out[r] = T[4 * r] * p[0] + T[4 * r + 1] * p[1] + T[4 * r + 2] * p[2] +
             T[4 * r + 3];
}

// solve 6x6 normal equations via Cholesky (LDL^T without pivoting)
bool solve6(double A[36], double b[6], double x[6]) {
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) {
      double s = A[6 * i + j];
      for (int k = 0; k < i; ++k) s -= A[6 * i + k] * A[6 * j + k];
      if (i == j) {
        if (s <= 1e-12) return false;
        A[6 * i + i] = std::sqrt(s);
      } else {
        A[6 * j + i] = s / A[6 * i + i];
      }
    }
  }
  for (int i = 0; i < 6; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= A[6 * i + k] * x[k];
    x[i] = s / A[6 * i + i];
  }
  for (int i = 5; i >= 0; --i) {
    double s = x[i];
    for (int k = i + 1; k < 6; ++k) s -= A[6 * k + i] * x[k];
    x[i] = s / A[6 * i + i];
  }
  return true;
}

void se3_exp_apply(const double xi[6], double *T /*4x4 row-major, in-out*/) {
  // first-order-exact exponential: R = exp([w]), t = v (small updates)
  const double *w = xi;  // rotation
  const double *v = xi + 3;
  double th = std::sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  double R[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
  if (th > 1e-12) {
    double a = std::sin(th) / th;
    double b = (1 - std::cos(th)) / (th * th);
    double W[9] = {0, -w[2], w[1], w[2], 0, -w[0], -w[1], w[0], 0};
    double W2[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        W2[3 * i + j] = 0;
        for (int k = 0; k < 3; ++k) W2[3 * i + j] += W[3 * i + k] * W[3 * k + j];
      }
    for (int i = 0; i < 9; ++i) R[i] += a * W[i] + b * W2[i];
  }
  double Tn[16];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 4; ++c) {
      Tn[4 * r + c] = R[3 * r] * T[c] + R[3 * r + 1] * T[4 + c] +
                      R[3 * r + 2] * T[8 + c];
    }
    Tn[4 * r + 3] += v[r];
  }
  Tn[12] = Tn[13] = Tn[14] = 0;
  Tn[15] = 1;
  std::memcpy(T, Tn, sizeof(Tn));
}

}  // namespace

extern "C" {

// Register `source` [ns,3] against `target` [nt,3] (both in the same frame
// guess: T_init [4,4] row-major maps source -> target). Writes the refined
// transform into T_out. Returns number of inliers in the final iteration.
int icp_register(const double *source, int ns, const double *target, int nt,
                 const double *T_init, double voxel, double max_corr_dist,
                 int max_iters, double *T_out) {
  VoxelMap map = build_map(target, nt, voxel);
  double T[16];
  std::memcpy(T, T_init, sizeof(T));
  int inliers = 0;
  for (int it = 0; it < max_iters; ++it) {
    double A[36] = {0};
    double b[6] = {0};
    inliers = 0;
    for (int i = 0; i < ns; ++i) {
      double q[3];
      transform_point(T, source + 3 * i, q);
      double d2;
      int j = nn_in_map(map, target, q, voxel, max_corr_dist, &d2);
      if (j < 0) continue;
      const double *p = target + 3 * j;
      double r[3] = {q[0] - p[0], q[1] - p[1], q[2] - p[2]};
      // jacobian of residual wrt [w, v]: J = [-[q]_x | I]
      double J[3][6] = {
          {0, q[2], -q[1], 1, 0, 0},
          {-q[2], 0, q[0], 0, 1, 0},
          {q[1], -q[0], 0, 0, 0, 1},
      };
      for (int r_i = 0; r_i < 3; ++r_i) {
        for (int a = 0; a < 6; ++a) {
          b[a] -= J[r_i][a] * r[r_i];
          for (int c = a; c < 6; ++c) A[6 * a + c] += J[r_i][a] * J[r_i][c];
        }
      }
      ++inliers;
    }
    if (inliers < 10) break;
    for (int a = 0; a < 6; ++a)
      for (int c = 0; c < a; ++c) A[6 * a + c] = A[6 * c + a];
    double x[6];
    double Acopy[36];
    std::memcpy(Acopy, A, sizeof(A));
    if (!solve6(Acopy, b, x)) break;
    se3_exp_apply(x, T);
    double step = 0;
    for (int a = 0; a < 6; ++a) step += x[a] * x[a];
    if (step < 1e-12) break;
  }
  std::memcpy(T_out, T, sizeof(T));
  return inliers;
}

// Voxel-downsample: keep the first point per voxel. Returns count written.
int voxel_downsample(const double *pts, int n, double voxel, double *out,
                     int max_out) {
  VoxelMap seen;
  seen.reserve(static_cast<size_t>(n));
  const double inv = 1.0 / voxel;
  int m = 0;
  for (int i = 0; i < n && m < max_out; ++i) {
    VoxelKey k = key_of(pts + 3 * i, inv);
    auto it = seen.find(k);
    if (it == seen.end()) {
      seen[k] = {};
      std::memcpy(out + 3 * m, pts + 3 * i, 3 * sizeof(double));
      ++m;
    }
  }
  return m;
}

// 1-NN of each query in refs (grid-hash accelerated; dist2 = +inf -> -1).
void nn1_query(const double *refs, int nr, const double *queries, int nq,
               double voxel, double max_dist, int64_t *idx_out,
               double *d2_out) {
  VoxelMap map = build_map(refs, nr, voxel);
  for (int i = 0; i < nq; ++i) {
    double d2 = max_dist * max_dist;
    int j = nn_in_map(map, refs, queries + 3 * i, voxel, max_dist, &d2);
    idx_out[i] = j;
    d2_out[i] = d2;
  }
}
}
