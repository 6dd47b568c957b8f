// BVH traversal for Hopper (sm_90a): closest-hit and any-hit in one kernel.
//
// Replaces the TPU kernel elevenrender_tpu/ops/bvh_pallas.py:_kernel
// (reached through traverse_pallas -> pl.pallas_call), in both of the
// modes the forward render step uses: closest-hit for path rays and
// any-hit (exclude / t_max) for shadow rays.  It also serves the TPU
// kernel's stream residency (stream=True: the tri table in HBM, one DMA
// per leaf-parent visit), which exists only because VMEM cannot hold
// the tris of a large scene; here every table is read from global
// memory through the read-only path, at any tri count the wrapper
// admits (its 32-bit 3*i row indexing bounds tris and rays).
//
// Design: one thread per ray walks the implicit complete binary BVH
// (preorder, left = node+1, right = node + 2^(D-depth)) with a private
// stack of (node, depth).  The visit and accept rules are the TPU
// kernel's, applied per ray instead of per 4096-ray tile:
//   - each visit reads both children's boxes from the parent-indexed
//     table (3 float4) and slab-tests them with the prune tmin < best_t;
//   - when both overlap, the nearer child is taken first
//     (l_near <= r_near -> left) and the other is pushed;
//   - at a leaf parent, the right child's tris are scanned before the
//     left's, by Moller-Trumbore on precomputed edges (v0, e1, e2), with
//     |det| > 1e-7, 0 <= u <= 1, v >= 0, u + v <= 1, t >= 0 and strict
//     t < best_t;
//   - any-hit: best_t starts at t_max[i]; the first accepted hit on a tri
//     other than exclude[i] stores (tri, -inf) and ends the ray.
// Compiled with --fmad=false so every float op is rounded on its own, as
// in the plain PyTorch version (ops/traverse.py), which it must equal.
//
// What bounds it on this card: the work is fp32 arithmetic on the CUDA
// cores (about 50 ops per interior visit, 55 per triangle test), against
// a few tens of MB of rays and tables; so operations, counted from the
// visits and tests of the run's own rays, set the bound of a closest-hit
// launch, and divergence between the rays of a warp is what keeps the
// kernel from it.  The tables stay in L2 at 66k tris (3.2 MiB); at 1M
// tris the 45.8 MiB tri table shares the 50 MB L2 with the wavefront
// and the shading's attribute rows, and the kernel does 1.4-2.2x less
// work per millisecond (PERF.md, config 5).  Warp-coherent traversal, a
// wide (4- or 8-ary) BVH, compressed nodes and FMA are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kStack = 32;  // the wrapper refuses depth + 2 > kStack

__device__ __forceinline__ float mn(float a, float b) { return a < b ? a : b; }
__device__ __forceinline__ float mx(float a, float b) { return a > b ? a : b; }

// Slab test of one box; entry = its entry distance when it passes, else inf.
__device__ __forceinline__ bool slab(float x1, float y1, float z1, float x2,
                                     float y2, float z2, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float best_t, float& entry) {
  float t1 = (x1 - ox) * ix;
  float t2 = (x2 - ox) * ix;
  float t3 = (y1 - oy) * iy;
  float t4 = (y2 - oy) * iy;
  float t5 = (z1 - oz) * iz;
  float t6 = (z2 - oz) * iz;
  float tmin = mx(mx(mn(t1, t2), mn(t3, t4)), mn(t5, t6));
  float tmax = mn(mn(mx(t1, t2), mx(t3, t4)), mx(t5, t6));
  bool hit = !((tmax < 0.0f) || (tmin > tmax)) && (tmin < best_t);
  entry = hit ? tmin : CUDART_INF_F;
  return hit;
}

// Scans leaf-order tris [from, to).  Returns true when an any-hit ray
// is resolved.
__device__ __forceinline__ bool scan(const float4* __restrict__ tris, int from,
                                     int to, float ox, float oy, float oz,
                                     float dx, float dy, float dz, int any_hit,
                                     int excl, int& best_idx, float& best_t) {
  for (int slot = from; slot < to; ++slot) {
    const float4 a = __ldg(&tris[3 * slot + 0]);  // v0
    const float4 b = __ldg(&tris[3 * slot + 1]);  // e1 = v1 - v0
    const float4 c = __ldg(&tris[3 * slot + 2]);  // e2 = v2 - v0
    float px = dy * c.z - dz * c.y;
    float py = dz * c.x - dx * c.z;
    float pz = dx * c.y - dy * c.x;
    float det = b.x * px + b.y * py + b.z * pz;
    float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
    float tx = ox - a.x;
    float ty = oy - a.y;
    float tz = oz - a.z;
    float u = (tx * px + ty * py + tz * pz) * inv_det;
    float qx = ty * b.z - tz * b.y;
    float qy = tz * b.x - tx * b.z;
    float qz = tx * b.y - ty * b.x;
    float v = (dx * qx + dy * qy + dz * qz) * inv_det;
    float t = (c.x * qx + c.y * qy + c.z * qz) * inv_det;
    bool ok = (fabsf(det) > 1e-7f) && (u >= 0.0f) && (u <= 1.0f) &&
              (v >= 0.0f) && (u + v <= 1.0f) && (t >= 0.0f) && (t < best_t);
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

__global__ void __launch_bounds__(128)
bvh_traverse_kernel(const float4* __restrict__ boxes,
                    const int4* __restrict__ leaves,
                    const float4* __restrict__ tris,
                    const float* __restrict__ ray_o,
                    const float* __restrict__ ray_d,
                    const int* __restrict__ exclude,
                    const float* __restrict__ t_max, int* __restrict__ out_idx,
                    float* __restrict__ out_t, int n, int depth, int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = ray_o[3 * i + 0], oy = ray_o[3 * i + 1],
              oz = ray_o[3 * i + 2];
  const float dx = ray_d[3 * i + 0], dy = ray_d[3 * i + 1],
              dz = ray_d[3 * i + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const int excl = any_hit ? exclude[i] : -1;
  float best_t = any_hit ? t_max[i] : CUDART_INF_F;
  int best_idx = -1;

  int stack_node[kStack];
  int stack_dep[kStack];
  stack_node[0] = -1;  // sentinel: popping it ends the walk
  stack_dep[0] = 0;
  int sp = 1;
  int node = 0;
  int ndep = 0;
  while (true) {
    const float4 b0 = __ldg(&boxes[3 * node + 0]);
    const float4 b1 = __ldg(&boxes[3 * node + 1]);
    const float4 b2 = __ldg(&boxes[3 * node + 2]);
    float l_near, r_near;
    const bool l_over = slab(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, ox, oy, oz,
                             ix, iy, iz, best_t, l_near);
    const bool r_over = slab(b1.z, b1.w, b2.x, b2.y, b2.z, b2.w, ox, oy, oz,
                             ix, iy, iz, best_t, r_near);
    const bool at_leaf_parent = ndep == depth - 1;
    if (at_leaf_parent && (l_over || r_over)) {
      const int4 lf = __ldg(&leaves[node]);  // (l_from, l_to, r_from, r_to)
      if (r_over && scan(tris, lf.z, lf.w, ox, oy, oz, dx, dy, dz, any_hit,
                         excl, best_idx, best_t))
        break;
      if (l_over && scan(tris, lf.x, lf.y, ox, oy, oz, dx, dy, dz, any_hit,
                         excl, best_idx, best_t))
        break;
    }
    const bool trav_l = l_over && !at_leaf_parent;
    const bool trav_r = r_over && !at_leaf_parent;
    const int l_idx = node + 1;
    const int r_idx = node + (1 << (depth - ndep));
    if (trav_l && trav_r) {
      const bool l_first = l_near <= r_near;
      stack_node[sp] = l_first ? r_idx : l_idx;
      stack_dep[sp] = ndep + 1;
      ++sp;
      node = l_first ? l_idx : r_idx;
      ++ndep;
    } else if (trav_l || trav_r) {
      node = trav_l ? l_idx : r_idx;
      ++ndep;
    } else {
      --sp;
      node = stack_node[sp];
      ndep = stack_dep[sp];
      if (node < 0) break;
    }
  }
  out_idx[i] = best_idx;
  out_t[i] = best_t;
}

}  // namespace

extern "C" {

// All pointers are device pointers; exclude and t_max may be null when
// any_hit == 0.  Launches on `stream` and returns the cudaError_t of the
// launch (0 on success).
int bvh_traverse(const void* boxes, const void* leaves, const void* tris,
                 const void* ray_o, const void* ray_d, const void* exclude,
                 const void* t_max, void* out_idx, void* out_t, int n,
                 int depth, int any_hit, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  bvh_traverse_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int4*>(leaves),
      static_cast<const float4*>(tris), static_cast<const float*>(ray_o),
      static_cast<const float*>(ray_d), static_cast<const int*>(exclude),
      static_cast<const float*>(t_max), static_cast<int*>(out_idx),
      static_cast<float*>(out_t), n, depth, any_hit);
  return static_cast<int>(cudaGetLastError());
}

const char* bvh_traverse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
