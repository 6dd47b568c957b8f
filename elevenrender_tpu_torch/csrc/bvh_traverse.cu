// BVH traversal for Hopper (sm_90a): closest-hit and any-hit in one kernel,
// with the TPU kernel's measurement and ordering variants as compile-time
// instantiations.
//
// Replaces the TPU kernel elevenrender_tpu/ops/bvh_pallas.py:_kernel
// (reached through traverse_pallas -> pl.pallas_call), in both of the
// modes the render step uses: closest-hit for path rays and any-hit
// (exclude / t_max) for shadow rays.  It also serves the TPU kernel's
// stream residency (stream=True: the tri table in HBM, one DMA per
// leaf-parent visit), which exists only because VMEM cannot hold the tris
// of a large scene; here every table is read from global memory through
// the read-only path, at any tri count the wrapper admits (its 32-bit 3*i
// row indexing bounds tris and rays).
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
// Variants (template parameters; the default instantiation <false, false,
// 0, 0> is the walk above and nothing else):
//   kCount     (the TPU kernel's count_steps): a fourth output, int32
//              [N, 4] per ray: node visits, leaf-parent visits, 8-aligned
//              slot groups of the leaf ranges entered
//              (((to-1)>>3) - (from>>3) + 1 each), Moller-Trumbore tests
//              executed.  The TPU kernel keeps these per 4096-ray tile.
//   kSign      (order="sign"): when both children overlap, the first is
//              picked from a per-node code (axis of largest child-centre
//              separation, +3 if the left child is on its positive side)
//              and the sign of the ray's own direction on that axis; the
//              entry distances are not compared.  Hits are those of the
//              near order up to equal-t ties; only the visit count moves.
//   kLeafAabb  (leaf_aabb=1/2): before the tests of each aligned group of
//              8 (mode 1) or 4 (mode 2) leaf-order slots, a slab test of
//              the group's box, tmin < best_t included; a failed test
//              skips the group.  A pure cull: ids and t are mode 0's.
//   kLeafMode  (leaf_mode): 1 = "noscan", the leaf step without its
//              triangle tests; 2 = "skip", no leaf step at all.  Timing
//              probes: every ray misses, by design.
//
// What bounds it on this card: the work is fp32 arithmetic on the CUDA
// cores (about 50 ops per interior visit, 55 per triangle test, 25 per
// group box), against a few tens of MB of rays and tables; so operations,
// counted by kCount from the run's own rays, set the bound of a
// closest-hit launch, and divergence between the rays of a warp is what
// keeps the kernel from it.  The tables stay in L2 at 66k tris (3.2 MiB);
// at 1M tris the 45.8 MiB tri table shares the 50 MB L2 with the wavefront
// and the shading's attribute rows, and the kernel does 1.4-2.2x less
// work per millisecond (PERF.md, config 5).  The frontier-K walk and the
// 8-wide collapsed BVH (bvh_frontier.cu, bvh_wide.cu) are measured beside
// this walk by sweep_traverse.py; one thread per ray, neither beats it on
// closest-hit rays (PERF.md).  Warp-coherent traversal, compressed nodes
// and FMA are later work.

#include "bvh_common.cuh"

namespace {

using namespace bvh;  // Ray, slab, test_tris, groups_of_8 (bvh_common.cuh)

constexpr int kStack = 32;  // the wrapper refuses depth + 2 > kStack

// Scans one leaf's range [from, to): every slot (kLeafAabb == 0), or
// group by group behind each group's box test.  Group g covers slots
// [g << shift, (g + 1) << shift) of the leaf order; its box is rows 2g
// and 2g + 1 of `groups` (bmin.xyz, -, bmax.xyz, -).
template <bool kCount, int kLeafAabb>
__device__ __forceinline__ bool scan(const float4* __restrict__ tris,
                                     const float4* __restrict__ groups,
                                     int from, int to, const Ray& r,
                                     int any_hit, int excl, int& best_idx,
                                     float& best_t, int& tests) {
  if constexpr (kLeafAabb == 0) {
    return test_tris<kCount>(tris, from, to, r, any_hit, excl, best_idx,
                             best_t, tests);
  } else {
    constexpr int kShift = kLeafAabb == 1 ? 3 : 2;
    if (to <= from) return false;
    const int g_last = (to - 1) >> kShift;
    for (int g = from >> kShift; g <= g_last; ++g) {
      const float4 lo = __ldg(&groups[2 * g + 0]);
      const float4 hi = __ldg(&groups[2 * g + 1]);
      float entry;
      if (!slab(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, r, best_t, entry))
        continue;
      const int s0 = max(from, g << kShift);
      const int s1 = min(to, (g + 1) << kShift);
      if (test_tris<kCount>(tris, s0, s1, r, any_hit, excl, best_idx, best_t,
                            tests))
        return true;
    }
    return false;
  }
}

template <bool kCount, bool kSign, int kLeafAabb, int kLeafMode>
__global__ void __launch_bounds__(128)
bvh_traverse_kernel(const float4* __restrict__ boxes,
                    const int4* __restrict__ leaves,
                    const float4* __restrict__ tris,
                    const int* __restrict__ order_code,
                    const float4* __restrict__ groups,
                    const float* __restrict__ ray_o,
                    const float* __restrict__ ray_d,
                    const int* __restrict__ exclude,
                    const float* __restrict__ t_max, int* __restrict__ out_idx,
                    float* __restrict__ out_t, int4* __restrict__ out_counts,
                    int n, int depth, int any_hit) {
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
    if constexpr (kLeafMode != 2) {
      if (at_leaf_parent && (l_over || r_over)) {
        const int4 lf = __ldg(&leaves[node]);  // (l_from, l_to, r_from, r_to)
        if constexpr (kCount) ++c_leaf;
        if (r_over) {
          if constexpr (kCount) c_groups += groups_of_8(lf.z, lf.w);
          if constexpr (kLeafMode == 0) {
            if (scan<kCount, kLeafAabb>(tris, groups, lf.z, lf.w, r, any_hit,
                                        excl, best_idx, best_t, c_tests))
              break;
          }
        }
        if (l_over) {
          if constexpr (kCount) c_groups += groups_of_8(lf.x, lf.y);
          if constexpr (kLeafMode == 0) {
            if (scan<kCount, kLeafAabb>(tris, groups, lf.x, lf.y, r, any_hit,
                                        excl, best_idx, best_t, c_tests))
              break;
          }
        }
      }
    }
    const bool trav_l = l_over && !at_leaf_parent;
    const bool trav_r = r_over && !at_leaf_parent;
    const int l_idx = node + 1;
    const int r_idx = node + (1 << (depth - ndep));
    if (trav_l && trav_r) {
      bool l_first;
      if constexpr (kSign) {
        const int code = __ldg(&order_code[node]);
        const bool left_pos = code >= 3;
        const int ax = left_pos ? code - 3 : code;
        const float dir = ax == 0 ? r.dx : (ax == 1 ? r.dy : r.dz);
        l_first = (dir >= 0.0f) != left_pos;
      } else {
        l_first = l_near <= r_near;
      }
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

using Kernel = void (*)(const float4*, const int4*, const float4*, const int*,
                        const float4*, const float*, const float*, const int*,
                        const float*, int*, float*, int4*, int, int, int);

// The leaf variants a launch can ask for: the full scan with leaf_aabb 0,
// 1 or 2, then the two probes (which make no tests, so have no box mode).
#define LEAF_VARIANTS(C, S)                                         \
  {                                                                 \
    &bvh_traverse_kernel<C, S, 0, 0>, &bvh_traverse_kernel<C, S, 1, 0>, \
        &bvh_traverse_kernel<C, S, 2, 0>, &bvh_traverse_kernel<C, S, 0, 1>, \
        &bvh_traverse_kernel<C, S, 0, 2>                            \
  }

const Kernel kKernels[2][2][5] = {
    {LEAF_VARIANTS(false, false), LEAF_VARIANTS(false, true)},
    {LEAF_VARIANTS(true, false), LEAF_VARIANTS(true, true)}};

}  // namespace

extern "C" {

// All pointers are device pointers.  exclude and t_max may be null when
// any_hit == 0, order_code when sign_order == 0, groups (the box table of
// the leaf_aabb mode asked for) when leaf_aabb == 0 or leaf_mode != 0,
// out_counts when count_steps == 0.  leaf_mode: 0 full, 1 noscan, 2 skip.
// Launches on `stream` and returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue for a variant that does not exist).
int bvh_traverse(const void* boxes, const void* leaves, const void* tris,
                 const void* order_code, const void* groups, const void* ray_o,
                 const void* ray_d, const void* exclude, const void* t_max,
                 void* out_idx, void* out_t, void* out_counts, int n,
                 int depth, int any_hit, int count_steps, int sign_order,
                 int leaf_aabb, int leaf_mode, void* stream) {
  if (leaf_aabb < 0 || leaf_aabb > 2 || leaf_mode < 0 || leaf_mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int variant = leaf_mode == 0 ? leaf_aabb : 2 + leaf_mode;
  const Kernel kernel =
      kKernels[count_steps ? 1 : 0][sign_order ? 1 : 0][variant];
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int4*>(leaves),
      static_cast<const float4*>(tris), static_cast<const int*>(order_code),
      static_cast<const float4*>(groups), static_cast<const float*>(ray_o),
      static_cast<const float*>(ray_d), static_cast<const int*>(exclude),
      static_cast<const float*>(t_max), static_cast<int*>(out_idx),
      static_cast<float*>(out_t), static_cast<int4*>(out_counts), n, depth,
      any_hit);
  return static_cast<int>(cudaGetLastError());
}

const char* bvh_traverse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
