// The binary BVH walk as it was first written for this card (one thread per
// ray, a private stack in local memory), kept as the baseline that the
// traversal sweep (sweep_traverse.py, walk "binary-v1") times the present
// kernel, bvh_traverse.cu, against on the same rays.  No render path
// launches it.
//
// It serves the same function as bvh_traverse.cu's default variant: the
// port of the TPU kernel elevenrender_tpu/ops/bvh_pallas.py:_kernel, in
// closest-hit and any-hit mode, with or without its count_steps counters.
// The walk, per ray, with the prune tmin < best_t:
//   - each visit reads both children's boxes from the parent-indexed
//     table (3 float4) and slab-tests them;
//   - when both overlap, the nearer child is taken first
//     (l_near <= r_near -> left) and the other is pushed;
//   - at a leaf parent, the right child's tris are scanned before the
//     left's (bvh_common.cuh test_tris), with strict t < best_t;
//   - any-hit: best_t starts at t_max[i]; the first accepted hit on a tri
//     other than exclude[i] stores (tri, -inf) and ends the ray.
// Compiled with --fmad=false, as its plain version (ops/traverse.py
// traverse_plain) rounds every op; the two are equal bit for bit.
//
// Design: a grid of one thread per ray, 128-thread blocks; the stack is
// two int[32] arrays (node, depth) in local memory; each loop iteration is
// one visit, with the leaf scans inline, so the lanes of a warp scan their
// leaves at different iterations while the others wait.

#include "bvh_common.cuh"

namespace {

using namespace bvh;

constexpr int kStack = 32;  // the wrapper refuses depth + 2 > kStack

template <bool kCount>
__global__ void __launch_bounds__(128)
bvh_traverse_v1_kernel(const float4* __restrict__ boxes,
                       const int4* __restrict__ leaves,
                       const float4* __restrict__ tris,
                       const float* __restrict__ ray_o,
                       const float* __restrict__ ray_d,
                       const int* __restrict__ exclude,
                       const float* __restrict__ t_max,
                       int* __restrict__ out_idx, float* __restrict__ out_t,
                       int4* __restrict__ out_counts, int n, int depth,
                       int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ray_o, ray_d, i);
  const int excl = any_hit ? exclude[i] : -1;
  float best_t = any_hit ? t_max[i] : CUDART_INF_F;
  int best_idx = -1;
  int c_visits = 0, c_leaf = 0, c_groups = 0, c_tests = 0;

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
    if constexpr (kCount) ++c_visits;
    float l_near, r_near;
    const bool l_over =
        slab(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, r, best_t, l_near);
    const bool r_over =
        slab(b1.z, b1.w, b2.x, b2.y, b2.z, b2.w, r, best_t, r_near);
    const bool at_leaf_parent = ndep == depth - 1;
    if (at_leaf_parent && (l_over || r_over)) {
      const int4 lf = __ldg(&leaves[node]);  // (l_from, l_to, r_from, r_to)
      if constexpr (kCount) ++c_leaf;
      if (r_over) {
        if constexpr (kCount) c_groups += groups_of_8(lf.z, lf.w);
        if (test_tris<kCount>(tris, lf.z, lf.w, r, any_hit, excl, best_idx,
                              best_t, c_tests))
          break;
      }
      if (l_over) {
        if constexpr (kCount) c_groups += groups_of_8(lf.x, lf.y);
        if (test_tris<kCount>(tris, lf.x, lf.y, r, any_hit, excl, best_idx,
                              best_t, c_tests))
          break;
      }
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
  if constexpr (kCount)
    out_counts[i] = make_int4(c_visits, c_leaf, c_groups, c_tests);
}

}  // namespace

extern "C" {

// All pointers are device pointers.  exclude and t_max may be null when
// any_hit == 0, out_counts when count_steps == 0.  Launches on `stream`
// and returns the cudaError_t of the launch (0 on success).
int bvh_traverse_v1(const void* boxes, const void* leaves, const void* tris,
                    const void* ray_o, const void* ray_d, const void* exclude,
                    const void* t_max, void* out_idx, void* out_t,
                    void* out_counts, int n, int depth, int any_hit,
                    int count_steps, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  auto kernel = count_steps ? &bvh_traverse_v1_kernel<true>
                            : &bvh_traverse_v1_kernel<false>;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int4*>(leaves),
      static_cast<const float4*>(tris), static_cast<const float*>(ray_o),
      static_cast<const float*>(ray_d), static_cast<const int*>(exclude),
      static_cast<const float*>(t_max), static_cast<int*>(out_idx),
      static_cast<float*>(out_t), static_cast<int4*>(out_counts), n, depth,
      any_hit);
  return static_cast<int>(cudaGetLastError());
}

const char* bvh_traverse_v1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
