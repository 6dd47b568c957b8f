// Frontier-K BVH traversal for Hopper (sm_90a): closest-hit and any-hit.
//
// Replaces the TPU kernel
// elevenrender_tpu/ops/bvh_pallas.py:_kernel_frontier (reached through
// traverse_pallas(frontier=K) -> pl.pallas_call), in its closest-hit and
// any-hit modes, with its count_steps instrument, in both residencies (the
// TPU kernel's stream=True exists because VMEM cannot hold a large tri
// table; here every table is read from global memory at any tri count).
//
// The rule, per ray (the TPU kernel applies it to a tile of rays with one
// shared stack; this is the tile of one ray): the same implicit complete
// binary BVH and tables as bvh_traverse.cu, walked from a stack of
// (node, depth) that starts with the root.  While the stack is not empty:
//   - pop k = min(sp, K) entries, the top first;
//   - phase 1: slab-test both children of every popped entry with the
//     best_t of the block's START (so the prune inside a block is weaker
//     than the binary walk's, and a block may visit nodes that walk would
//     have cut: that is the design, and the visit counter shows it);
//   - phase 2, entries in pop order: at a leaf parent whose test passed,
//     scan the right child's tris if it overlapped, then the left's, with
//     the running best_t; elsewhere push the farther overlapping child,
//     then the nearer (left first when l_near <= r_near), so the nearer
//     pops first.  A push into a full stack (capacity 4 * K * depth + 8
//     entries, the TPU kernel's allocation) is refused, never written out
//     of bounds; the refusals are counted.
//   - any-hit: best_t starts at t_max[i]; the first accepted hit on a tri
//     other than exclude[i] stores (tri, -inf) and ends the thread (the
//     tile kernel pops on, but nothing passes tmin < -inf).
// Distances equal the binary walk's bit for bit (the least t under strict
// '<' does not depend on the order of the tests); ids equal it up to
// equal-t ties.
//
// Design: one thread per ray.  K is a template parameter (2..8), so the K
// popped entries and their 2K slab results live in registers and both
// phases unroll; the K box fetches of phase 1 are independent loads in
// flight together, which is what the frontier buys a thread.  The stack is
// thread-local memory, one int per entry ((node << 5) | depth; the wrapper
// refuses depth > kMaxDepth).  kCount adds the binary kernel's four
// per-ray counters (node visits, leaf-parent visits, 8-aligned slot groups
// entered, tri tests) and, through atomics on a two-int scratch, the
// deepest stack any ray reached and the number of refused pushes.
//
// What bounds it: as bvh_traverse.cu, fp32 operations on the CUDA cores
// (50 per visit, 55 per tri test, counted by kCount), far above the bytes
// of rays and tables; divergence between the rays of a warp keeps it from
// that bound.

#include "bvh_common.cuh"

namespace {

using namespace bvh;

constexpr int kMaxDepth = 20;
constexpr int kDepthBits = 5;

template <int K, bool kCount>
__global__ void __launch_bounds__(128)
bvh_frontier_kernel(const float4* __restrict__ boxes,
                    const int4* __restrict__ leaves,
                    const float4* __restrict__ tris,
                    const float* __restrict__ ray_o,
                    const float* __restrict__ ray_d,
                    const int* __restrict__ exclude,
                    const float* __restrict__ t_max, int* __restrict__ out_idx,
                    float* __restrict__ out_t, int4* __restrict__ out_counts,
                    int* __restrict__ stack_stats, int n, int depth,
                    int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ray_o, ray_d, i);
  const int excl = any_hit ? exclude[i] : -1;
  float best_t = any_hit ? t_max[i] : CUDART_INF_F;
  int best_idx = -1;
  int c_visits = 0, c_leaf = 0, c_groups = 0, c_tests = 0;
  int deepest = 1, refused = 0;

  constexpr int kCap = 4 * K * kMaxDepth + 8;
  const int cap = 4 * K * depth + 8;  // <= kCap: depth <= kMaxDepth
  int stack[kCap];
  stack[0] = 0;  // the root, at depth 0
  int sp = 1;
  bool resolved = false;
  while (sp > 0 && !resolved) {
    const int k = sp < K ? sp : K;
    int ent[K];
    bool l_over[K], r_over[K];
    float l_near[K], r_near[K];
#pragma unroll
    for (int j = 0; j < K; ++j) ent[j] = j < k ? stack[sp - 1 - j] : 0;
    sp -= k;
    // Phase 1: every popped entry's two slab tests, with the best_t of
    // the block's start.
#pragma unroll
    for (int j = 0; j < K; ++j) {
      l_over[j] = false;
      r_over[j] = false;
      l_near[j] = CUDART_INF_F;
      r_near[j] = CUDART_INF_F;
      if (j < k) {
        const int node = ent[j] >> kDepthBits;
        const float4 b0 = __ldg(&boxes[3 * node + 0]);
        const float4 b1 = __ldg(&boxes[3 * node + 1]);
        const float4 b2 = __ldg(&boxes[3 * node + 2]);
        if constexpr (kCount) ++c_visits;
        l_over[j] =
            slab(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, r, best_t, l_near[j]);
        r_over[j] =
            slab(b1.z, b1.w, b2.x, b2.y, b2.z, b2.w, r, best_t, r_near[j]);
      }
    }
    // Phase 2: leaf scans and pushes, entry by entry in pop order.
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j >= k || resolved) continue;
      const int node = ent[j] >> kDepthBits;
      const int ndep = ent[j] & ((1 << kDepthBits) - 1);
      if (ndep == depth - 1) {
        if (l_over[j] || r_over[j]) {
          const int4 lf = __ldg(&leaves[node]);  // (l_from, l_to, r_from, r_to)
          if constexpr (kCount) ++c_leaf;
          if (r_over[j]) {
            if constexpr (kCount) c_groups += groups_of_8(lf.z, lf.w);
            resolved = test_tris<kCount>(tris, lf.z, lf.w, r, any_hit, excl,
                                         best_idx, best_t, c_tests);
          }
          if (l_over[j] && !resolved) {
            if constexpr (kCount) c_groups += groups_of_8(lf.x, lf.y);
            resolved = test_tris<kCount>(tris, lf.x, lf.y, r, any_hit, excl,
                                         best_idx, best_t, c_tests);
          }
        }
        continue;
      }
      const int l_idx = node + 1;
      const int r_idx = node + (1 << (depth - ndep));
      const bool l_first = l_near[j] <= r_near[j];
      const int first_idx = l_first ? l_idx : r_idx;
      const int second_idx = l_first ? r_idx : l_idx;
      const bool first_ok = l_first ? l_over[j] : r_over[j];
      const bool second_ok = l_first ? r_over[j] : l_over[j];
      // The farther child first, the nearer last: it pops first.
      if (second_ok) {
        if (sp < cap - 1)
          stack[sp++] = (second_idx << kDepthBits) | (ndep + 1);
        else
          ++refused;
      }
      if (first_ok) {
        if (sp < cap - 1)
          stack[sp++] = (first_idx << kDepthBits) | (ndep + 1);
        else
          ++refused;
      }
      if constexpr (kCount) deepest = sp > deepest ? sp : deepest;
    }
  }
  out_idx[i] = best_idx;
  out_t[i] = best_t;
  if constexpr (kCount) {
    out_counts[i] = make_int4(c_visits, c_leaf, c_groups, c_tests);
    atomicMax(&stack_stats[0], deepest);
    if (refused) atomicAdd(&stack_stats[1], refused);
  }
}

using Kernel = void (*)(const float4*, const int4*, const float4*,
                        const float*, const float*, const int*, const float*,
                        int*, float*, int4*, int*, int, int, int);

#define FRONTIER(K) \
  { &bvh_frontier_kernel<K, false>, &bvh_frontier_kernel<K, true> }

// kKernels[K - 2][count_steps]
const Kernel kKernels[7][2] = {FRONTIER(2), FRONTIER(3), FRONTIER(4),
                               FRONTIER(5), FRONTIER(6), FRONTIER(7),
                               FRONTIER(8)};

}  // namespace

extern "C" {

// All pointers are device pointers.  exclude and t_max may be null when
// any_hit == 0; out_counts ([n] int4) and stack_stats (two ints the caller
// zeroed: the deepest stack of any ray, the refused pushes) when
// count_steps == 0.  Launches on `stream` and returns the cudaError_t of
// the launch (0 on success; cudaErrorInvalidValue for a frontier outside
// [2, 8] or a depth outside [1, kMaxDepth]).
int bvh_frontier(const void* boxes, const void* leaves, const void* tris,
                 const void* ray_o, const void* ray_d, const void* exclude,
                 const void* t_max, void* out_idx, void* out_t,
                 void* out_counts, void* stack_stats, int n, int depth,
                 int frontier, int any_hit, int count_steps, void* stream) {
  if (frontier < 2 || frontier > 8 || depth < 1 || depth > kMaxDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const Kernel kernel = kKernels[frontier - 2][count_steps ? 1 : 0];
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int4*>(leaves),
      static_cast<const float4*>(tris), static_cast<const float*>(ray_o),
      static_cast<const float*>(ray_d), static_cast<const int*>(exclude),
      static_cast<const float*>(t_max), static_cast<int*>(out_idx),
      static_cast<float*>(out_t), static_cast<int4*>(out_counts),
      static_cast<int*>(stack_stats), n, depth, any_hit);
  return static_cast<int>(cudaGetLastError());
}

int bvh_frontier_max_depth() { return kMaxDepth; }

const char* bvh_frontier_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
