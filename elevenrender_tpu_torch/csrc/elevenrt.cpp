// elevenrt: the host runtime of the PyTorch port (C++, not a CUDA kernel).
//
// The port's own copy of the JAX package's C++ host layer, with its
// arithmetic unchanged, so both packages build the same trees and read
// the same meshes:
//   - er_build_bvh: binned-SAH complete-tree BVH build with the reference
//     renderer's split policy (BVH.cpp:327-415: 14 bins, first-minimum
//     (axis, bin) tie-break, left = bin < bestBin, empty == area <= 0
//     union semantics), the preorder node layout (children at idx+1 /
//     idx + 2^(D-d), BVH.cpp:122-130) and the leaf-order triangle
//     permutation.  Bit for bit the numpy build of ops/bvh.py.
//   - er_obj_count / er_obj_fill: two-pass Wavefront OBJ tokenizer (counts,
//     then fill), emitting flat triangle arrays with the reference's Z
//     negation.  Shapes are keyed by name: two 'o' blocks of one name
//     are one shape.
//
// A plain C ABI for ctypes; every buffer is allocated by the Python
// caller (ops/native.py), so no ownership crosses the boundary.
//
// Built by kernels.py with the host compiler (c++ -O3 -std=c++17 -shared
// -fPIC -ffp-contract=off) into build/kernels/ at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int SAH_BINS = 14;  // Definitions.h:14

struct V3 {
  double x = 0, y = 0, z = 0;
};

static inline double bounds_area(const V3& b1, const V3& b2) {
  const double x = b2.x - b1.x, y = b2.y - b1.y, z = b2.z - b1.z;
  return 2.0 * (x * y + x * z + y * z);
}

// boundsUnion with the reference's "empty iff area <= 0" skip semantics
// (BVH.cpp:447-472).
static inline void union_accum(V3& amin, V3& amax, bool& aempty,
                               const V3& bmin, const V3& bmax, bool bempty) {
  if (bempty) return;
  if (aempty) {
    amin = bmin;
    amax = bmax;
    aempty = false;
    return;
  }
  amin.x = std::min(amin.x, bmin.x);
  amin.y = std::min(amin.y, bmin.y);
  amin.z = std::min(amin.z, bmin.z);
  amax.x = std::max(amax.x, bmax.x);
  amax.y = std::max(amax.y, bmax.y);
  amax.z = std::max(amax.z, bmax.z);
}

struct BuildCtx {
  const float* verts;  // [T,3,3]
  std::vector<V3> tbmin, tbmax, cent;
  float* node_bmin;    // [NN,3]
  float* node_bmax;
  int32_t* node_from;  // [NN]
  int32_t* node_to;
  int32_t* perm;       // [T]
  int depth;
  int node_idx = 0;
  int tri_idx = 0;
};

static void build_rec(BuildCtx& c, int d, std::vector<int32_t>& tris) {
  // Node vertex bounds (empty -> zeros, matching default Vector3).
  V3 b1, b2;
  if (!tris.empty()) {
    b1 = c.tbmin[tris[0]];
    b2 = c.tbmax[tris[0]];
    for (int32_t t : tris) {
      const V3& lo = c.tbmin[t];
      const V3& hi = c.tbmax[t];
      b1.x = std::min(b1.x, lo.x);
      b1.y = std::min(b1.y, lo.y);
      b1.z = std::min(b1.z, lo.z);
      b2.x = std::max(b2.x, hi.x);
      b2.y = std::max(b2.y, hi.y);
      b2.z = std::max(b2.z, hi.z);
    }
  }
  const int idx = c.node_idx++;
  c.node_bmin[idx * 3 + 0] = static_cast<float>(b1.x);
  c.node_bmin[idx * 3 + 1] = static_cast<float>(b1.y);
  c.node_bmin[idx * 3 + 2] = static_cast<float>(b1.z);
  c.node_bmax[idx * 3 + 0] = static_cast<float>(b2.x);
  c.node_bmax[idx * 3 + 1] = static_cast<float>(b2.y);
  c.node_bmax[idx * 3 + 2] = static_cast<float>(b2.z);

  if (d == c.depth) {  // leaf
    c.node_from[idx] = c.tri_idx;
    c.node_to[idx] = c.tri_idx + static_cast<int32_t>(tris.size());
    for (int32_t t : tris) c.perm[c.tri_idx++] = t;
    return;
  }
  c.node_from[idx] = 0;
  c.node_to[idx] = 0;

  // --- divideSAH (BVH.cpp:327-415) -----------------------------------
  int best_bin = 0, best_axis = 0;
  double best_heur = std::numeric_limits<double>::max();
  const double tb1[3] = {b1.x, b1.y, b1.z};
  const double tb2[3] = {b2.x, b2.y, b2.z};

  if (!tris.empty()) {
    for (int axis = 0; axis < 3; axis++) {
      V3 bmin[SAH_BINS], bmax[SAH_BINS];
      bool bempty[SAH_BINS];
      int count[SAH_BINS] = {0};
      for (int i = 0; i < SAH_BINS; i++) bempty[i] = true;

      const double lo = tb1[axis], hi = tb2[axis];
      for (int32_t t : tris) {
        int bin = 0;
        if (lo != hi) {
          const double cv =
              (axis == 0 ? c.cent[t].x : axis == 1 ? c.cent[t].y : c.cent[t].z);
          bin = static_cast<int>((cv - lo) / (hi - lo) * (SAH_BINS - 1));
          bin = std::clamp(bin, 0, SAH_BINS - 1);
        }
        count[bin]++;
        union_accum(bmin[bin], bmax[bin], bempty[bin], c.tbmin[t], c.tbmax[t],
                    /*bempty=*/false);
      }
      // A filled bin whose box is degenerate (area <= 0) is treated as
      // empty by the reference union; recompute the flag.
      for (int i = 0; i < SAH_BINS; i++)
        if (!bempty[i] && bounds_area(bmin[i], bmax[i]) <= 0.0) bempty[i] = true;

      for (int i = 0; i < SAH_BINS; i++) {
        V3 l1, l2, r1v, r2v;
        bool lempty = true, rempty = true;
        long c1 = 0, c2 = 0;
        for (int j = 0; j < i; j++) {
          c1 += count[j];
          union_accum(l1, l2, lempty, bmin[j], bmax[j], bempty[j]);
        }
        for (int k = i; k < SAH_BINS; k++) {
          c2 += count[k];
          union_accum(r1v, r2v, rempty, bmin[k], bmax[k], bempty[k]);
        }
        const double heur = bounds_area(l1, l2) * static_cast<double>(c1) +
                            bounds_area(r1v, r2v) * static_cast<double>(c2);
        if (heur < best_heur) {
          best_heur = heur;
          best_bin = i;
          best_axis = axis;
        }
      }
    }
  }

  std::vector<int32_t> left, right;
  left.reserve(tris.size());
  right.reserve(tris.size());
  const double lo = tb1[best_axis], hi = tb2[best_axis];
  for (int32_t t : tris) {
    int bin = 0;
    if (lo != hi) {
      const double cv = (best_axis == 0   ? c.cent[t].x
                         : best_axis == 1 ? c.cent[t].y
                                          : c.cent[t].z);
      bin = static_cast<int>((cv - lo) / (hi - lo) * (SAH_BINS - 1));
      bin = std::clamp(bin, 0, SAH_BINS - 1);
    }
    (bin < best_bin ? left : right).push_back(t);
  }
  tris.clear();
  tris.shrink_to_fit();

  build_rec(c, d + 1, left);
  build_rec(c, d + 1, right);
}

}  // namespace

extern "C" {

// verts: [T*9] floats.  Outputs must be preallocated:
//   node_bmin/node_bmax: [(2^(depth+1)-1) * 3] floats
//   node_from/node_to:   [2^(depth+1)-1] int32
//   perm:                [T] int32
// Returns max leaf size.
int er_build_bvh(const float* verts, int T, int depth, float* node_bmin,
                 float* node_bmax, int32_t* node_from, int32_t* node_to,
                 int32_t* perm) {
  BuildCtx c;
  c.verts = verts;
  c.depth = depth;
  c.node_bmin = node_bmin;
  c.node_bmax = node_bmax;
  c.node_from = node_from;
  c.node_to = node_to;
  c.perm = perm;
  const int64_t nn = (int64_t{1} << (depth + 1)) - 1;
  std::memset(node_bmin, 0, nn * 3 * sizeof(float));
  std::memset(node_bmax, 0, nn * 3 * sizeof(float));
  std::memset(node_from, 0, nn * sizeof(int32_t));
  std::memset(node_to, 0, nn * sizeof(int32_t));

  c.tbmin.resize(T);
  c.tbmax.resize(T);
  c.cent.resize(T);
  for (int t = 0; t < T; t++) {
    const float* v = verts + t * 9;
    c.tbmin[t] = {std::min({v[0], v[3], v[6]}), std::min({v[1], v[4], v[7]}),
                  std::min({v[2], v[5], v[8]})};
    c.tbmax[t] = {std::max({v[0], v[3], v[6]}), std::max({v[1], v[4], v[7]}),
                  std::max({v[2], v[5], v[8]})};
    // Reference centroid: component sum / 3 in float (Tri.h:30-35).
    c.cent[t] = {(double(v[0]) + v[3] + v[6]) / 3.0,
                 (double(v[1]) + v[4] + v[7]) / 3.0,
                 (double(v[2]) + v[5] + v[8]) / 3.0};
  }

  std::vector<int32_t> all(T);
  for (int t = 0; t < T; t++) all[t] = t;
  build_rec(c, 0, all);

  // Max leaf occupancy for the traversal's static scan bound.
  int max_leaf = 1;
  // Leaves are the last level; walk all nodes and use from/to deltas of
  // leaf nodes.  Leaf nodes are exactly those with to > from OR at the
  // leaf preorder positions; since internal nodes store 0/0, scanning all
  // is safe (delta 0 ignored).
  for (int64_t i = 0; i < nn; i++) {
    const int d = node_to[i] - node_from[i];
    if (d > max_leaf) max_leaf = d;
  }
  return max_leaf;
}

// ---------------------------------------------------------------------
// OBJ parsing: pass 1 counts, pass 2 fills.
// ---------------------------------------------------------------------

struct ObjCounts {
  int64_t n_pos;
  int64_t n_nrm;
  int64_t n_uv;
  int64_t n_tri;    // after fan triangulation
  int64_t n_shape;  // o/g groups with faces
};

static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
  return p;
}

static inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') p++;
  return p < end ? p + 1 : end;
}

int er_obj_count(const char* text, int64_t len, ObjCounts* out) {
  const char* p = text;
  const char* end = text + len;
  std::memset(out, 0, sizeof(*out));
  int64_t faces_in_shape = 0;
  while (p < end) {
    p = skip_ws(p, end);
    if (p + 1 < end && p[0] == 'v') {
      if (p[1] == ' ' || p[1] == '\t')
        out->n_pos++;
      else if (p[1] == 'n')
        out->n_nrm++;
      else if (p[1] == 't')
        out->n_uv++;
    } else if (p < end && p[0] == 'f' && p + 1 < end &&
               (p[1] == ' ' || p[1] == '\t')) {
      // count corners
      int corners = 0;
      const char* q = p + 1;
      while (q < end && *q != '\n') {
        q = skip_ws(q, end);
        if (q < end && *q != '\n' && *q != '\r') {
          corners++;
          while (q < end && *q != ' ' && *q != '\t' && *q != '\n' &&
                 *q != '\r')
            q++;
        } else
          break;
      }
      if (corners >= 3) {
        out->n_tri += corners - 2;
        faces_in_shape += corners - 2;
      }
    } else if (p < end && (p[0] == 'o' || p[0] == 'g') && p + 1 < end &&
               (p[1] == ' ' || p[1] == '\t')) {
      if (faces_in_shape > 0) {
        out->n_shape++;
        faces_in_shape = 0;
      }
    }
    p = next_line(p, end);
  }
  if (faces_in_shape > 0) out->n_shape++;
  if (out->n_shape == 0 && out->n_tri > 0) out->n_shape = 1;
  return 0;
}

static inline float parse_float(const char*& p, const char* end) {
  p = skip_ws(p, end);
  return std::strtof(p, const_cast<char**>(&p));
}

static inline long parse_int(const char*& p, const char* end) {
  char* q;
  long v = std::strtol(p, &q, 10);
  p = q;
  return v;
}

// Fill pass.  Buffers sized from er_obj_count:
//   positions [n_pos*3], normals [n_nrm*3], uvs [n_uv*2] temp attribute
//   pools are internal; outputs are flat per-corner arrays:
//   tri_pos [n_tri*9], tri_nrm [n_tri*9] (NaN where missing),
//   tri_uv [n_tri*6] (0 where missing), tri_shape [n_tri] int32,
//   tri_mat [n_tri] int32 (index into the usemtl name table),
//   mat_names: concatenated NUL-separated usemtl names (cap given),
//   shape_names: same for shapes.
// Z negation applied to positions and normals (ObjLoader.cpp:111-112).
int er_obj_fill(const char* text, int64_t len, float* tri_pos, float* tri_nrm,
                float* tri_uv, int32_t* tri_shape, int32_t* tri_mat,
                char* mat_names, int64_t mat_cap, char* shape_names,
                int64_t shape_cap) {
  const char* p = text;
  const char* end = text + len;
  std::vector<float> P, N, UV;
  P.reserve(1024);
  N.reserve(1024);
  UV.reserve(1024);

  int64_t tri = 0;
  int32_t cur_shape = -1;
  int32_t cur_mat = -1;
  int64_t mat_off = 0, shape_off = 0;
  int64_t shape_faces = 0;

  auto intern = [&](const char* s, int64_t n, char* pool, int64_t cap,
                    int64_t& off) -> int32_t {
    // Linear scan over pool entries (few materials/shapes in practice).
    int32_t idx = 0;
    int64_t i = 0;
    while (i < off) {
      int64_t l = std::strlen(pool + i);
      if (l == n && std::memcmp(pool + i, s, n) == 0) return idx;
      i += l + 1;
      idx++;
    }
    if (off + n + 1 <= cap) {
      std::memcpy(pool + off, s, n);
      pool[off + n] = 0;
      off += n + 1;
    }
    return idx;
  };

  while (p < end) {
    p = skip_ws(p, end);
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') line_end++;

    if (p + 1 < end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      const char* q = p + 1;
      float x = parse_float(q, line_end), y = parse_float(q, line_end),
            z = parse_float(q, line_end);
      P.push_back(x);
      P.push_back(y);
      P.push_back(-z);
    } else if (p + 2 < end && p[0] == 'v' && p[1] == 'n') {
      const char* q = p + 2;
      float x = parse_float(q, line_end), y = parse_float(q, line_end),
            z = parse_float(q, line_end);
      N.push_back(x);
      N.push_back(y);
      N.push_back(-z);
    } else if (p + 2 < end && p[0] == 'v' && p[1] == 't') {
      const char* q = p + 2;
      float u = parse_float(q, line_end), v = parse_float(q, line_end);
      UV.push_back(u);
      UV.push_back(v);
    } else if (p < end && p[0] == 'f' && p + 1 < end &&
               (p[1] == ' ' || p[1] == '\t')) {
      // parse corners: up to 64-gon fan
      long vi[64], ti[64], ni[64];
      int corners = 0;
      const char* q = p + 1;
      while (q < line_end && corners < 64) {
        q = skip_ws(q, line_end);
        if (q >= line_end || *q == '\r') break;
        long a = parse_int(q, line_end);
        long b = 0, cidx = 0;
        bool has_t = false, has_n = false;
        if (q < line_end && *q == '/') {
          q++;
          if (q < line_end && *q != '/') {
            b = parse_int(q, line_end);
            has_t = true;
          }
          if (q < line_end && *q == '/') {
            q++;
            cidx = parse_int(q, line_end);
            has_n = true;
          }
        }
        vi[corners] = a;
        ti[corners] = has_t ? b : 0;
        ni[corners] = has_n ? cidx : 0;
        corners++;
      }
      if (cur_shape < 0) {
        cur_shape = intern("", 0, shape_names, shape_cap, shape_off);
        shape_faces = 0;
      }
      auto res = [&](long idx, int64_t n) -> int64_t {
        return idx > 0 ? idx - 1 : (idx < 0 ? (n + idx) : -1);
      };
      for (int k = 1; k + 1 < corners; k++) {
        const int cs[3] = {0, k, k + 1};
        for (int j = 0; j < 3; j++) {
          const int cc = cs[j];
          int64_t pv = res(vi[cc], P.size() / 3);
          for (int d = 0; d < 3; d++)
            tri_pos[tri * 9 + j * 3 + d] =
                (pv >= 0 && pv * 3 + d < (int64_t)P.size()) ? P[pv * 3 + d]
                                                            : 0.0f;
          int64_t pn = res(ni[cc], N.size() / 3);
          for (int d = 0; d < 3; d++)
            tri_nrm[tri * 9 + j * 3 + d] =
                (pn >= 0 && pn * 3 + d < (int64_t)N.size())
                    ? N[pn * 3 + d]
                    : std::numeric_limits<float>::quiet_NaN();
          int64_t pt = res(ti[cc], UV.size() / 2);
          for (int d = 0; d < 2; d++)
            tri_uv[tri * 6 + j * 2 + d] =
                (pt >= 0 && pt * 2 + d < (int64_t)UV.size()) ? UV[pt * 2 + d]
                                                             : 0.0f;
        }
        tri_shape[tri] = cur_shape;
        tri_mat[tri] = cur_mat;
        tri++;
        shape_faces++;
      }
    } else if (p < end && (p[0] == 'o' || p[0] == 'g') && p + 1 < end &&
               (p[1] == ' ' || p[1] == '\t')) {
      const char* q = skip_ws(p + 1, line_end);
      int64_t n = line_end - q;
      while (n > 0 && (q[n - 1] == '\r' || q[n - 1] == ' ')) n--;
      if (shape_faces > 0 || cur_shape < 0) {
        cur_shape = intern(q, n, shape_names, shape_cap, shape_off);
        shape_faces = 0;
      } else {
        // rename empty current shape
        cur_shape = intern(q, n, shape_names, shape_cap, shape_off);
      }
    } else if (line_end - p > 7 && std::memcmp(p, "usemtl", 6) == 0) {
      const char* q = skip_ws(p + 6, line_end);
      int64_t n = line_end - q;
      while (n > 0 && (q[n - 1] == '\r' || q[n - 1] == ' ')) n--;
      cur_mat = intern(q, n, mat_names, mat_cap, mat_off);
    }
    p = line_end < end ? line_end + 1 : end;
  }
  return static_cast<int>(tri);
}

}  // extern "C"
