// What the traversal kernels share: the ray, the slab test and the
// triangle scan.  bvh_traverse.cu (the binary walk), bvh_frontier.cu (the
// frontier-K walk) and bvh_wide.cu (the 8-wide collapsed BVH) include it,
// so the three do the same float operations in the same order and their
// distances are equal bit for bit.  Every source that includes it is
// compiled with --fmad=false: each float op is rounded on its own, as in
// the plain PyTorch versions (ops/traverse.py, experiments/bvh_wide.py).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace bvh {

__device__ __forceinline__ float mn(float a, float b) { return a < b ? a : b; }
__device__ __forceinline__ float mx(float a, float b) { return a > b ? a : b; }

struct Ray {
  float ox, oy, oz;
  float dx, dy, dz;
  float ix, iy, iz;
};

// Ray i of the [N, 3] origin and direction arrays, with 1 / d.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ ray_o,
                                        const float* __restrict__ ray_d,
                                        int i) {
  Ray r;
  r.ox = ray_o[3 * i + 0];
  r.oy = ray_o[3 * i + 1];
  r.oz = ray_o[3 * i + 2];
  r.dx = ray_d[3 * i + 0];
  r.dy = ray_d[3 * i + 1];
  r.dz = ray_d[3 * i + 2];
  r.ix = 1.0f / r.dx;
  r.iy = 1.0f / r.dy;
  r.iz = 1.0f / r.dz;
  return r;
}

// Slab test of one box; entry = its entry distance when it passes, else inf.
__device__ __forceinline__ bool slab(float x1, float y1, float z1, float x2,
                                     float y2, float z2, const Ray& r,
                                     float best_t, float& entry) {
  float t1 = (x1 - r.ox) * r.ix;
  float t2 = (x2 - r.ox) * r.ix;
  float t3 = (y1 - r.oy) * r.iy;
  float t4 = (y2 - r.oy) * r.iy;
  float t5 = (z1 - r.oz) * r.iz;
  float t6 = (z2 - r.oz) * r.iz;
  float tmin = mx(mx(mn(t1, t2), mn(t3, t4)), mn(t5, t6));
  float tmax = mn(mn(mx(t1, t2), mx(t3, t4)), mx(t5, t6));
  bool hit = !((tmax < 0.0f) || (tmin > tmax)) && (tmin < best_t);
  entry = hit ? tmin : CUDART_INF_F;
  return hit;
}

// Moller-Trumbore of leaf-order tri `slot` (rows v0, e1 = v1 - v0,
// e2 = v2 - v0): whether the ray meets it at t >= 0, before any best_t
// test, and that t.
__device__ __forceinline__ bool moller_trumbore(
    const float4* __restrict__ tris, int slot, const Ray& r, float& t) {
  const float4 a = __ldg(&tris[3 * slot + 0]);  // v0
  const float4 b = __ldg(&tris[3 * slot + 1]);  // e1 = v1 - v0
  const float4 c = __ldg(&tris[3 * slot + 2]);  // e2 = v2 - v0
  float px = r.dy * c.z - r.dz * c.y;
  float py = r.dz * c.x - r.dx * c.z;
  float pz = r.dx * c.y - r.dy * c.x;
  float det = b.x * px + b.y * py + b.z * pz;
  float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
  float tx = r.ox - a.x;
  float ty = r.oy - a.y;
  float tz = r.oz - a.z;
  float u = (tx * px + ty * py + tz * pz) * inv_det;
  float qx = ty * b.z - tz * b.y;
  float qy = tz * b.x - tx * b.z;
  float qz = tx * b.y - ty * b.x;
  float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (c.x * qx + c.y * qy + c.z * qz) * inv_det;
  return (fabsf(det) > 1e-7f) && (u >= 0.0f) && (u <= 1.0f) &&
         (v >= 0.0f) && (u + v <= 1.0f) && (t >= 0.0f);
}

// Tests leaf-order tris [from, to).  Returns true when an any-hit ray is
// resolved.
template <bool kCount>
__device__ __forceinline__ bool test_tris(const float4* __restrict__ tris,
                                          int from, int to, const Ray& r,
                                          int any_hit, int excl, int& best_idx,
                                          float& best_t, int& tests) {
  for (int slot = from; slot < to; ++slot) {
    if constexpr (kCount) ++tests;
    float t;
    const bool ok = moller_trumbore(tris, slot, r, t) && (t < best_t);
    if (any_hit) {
      if (ok && slot != excl) {
        best_idx = slot;
        best_t = -CUDART_INF_F;
        return true;
      }
    } else if (ok) {
      best_idx = slot;
      best_t = t;
    }
  }
  return false;
}

// 8-aligned slot groups that the leaf range [from, to) touches.
__device__ __forceinline__ int groups_of_8(int from, int to) {
  return to > from ? ((to - 1) >> 3) - (from >> 3) + 1 : 0;
}

}  // namespace bvh
