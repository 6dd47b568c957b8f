// 8-wide collapsed BVH traversal for Hopper (sm_90a): closest-hit.
//
// Replaces the TPU kernel elevenrender_tpu/experiments/bvh_wide.py:_kernel
// (reached through traverse_wide -> pl.pallas_call), with its count_steps
// instrument, in both residencies (its stream=True exists because VMEM
// cannot hold a large tri table; here every table is read from global
// memory at any tri count).  Like the TPU kernel it has no any-hit mode.
//
// The tree is the binary kernel's, unchanged: three binary levels collapse
// into one wide level at pack time (experiments/bvh_wide.py
// pack_bvh_wide).  Wide level k sits at binary depth levels[k] = 0, r,
// r + 3, ..., D - 3 (r = D mod 3, or 3 when that is 0); node (k, i) stores
// the boxes of its 8 binary descendants three levels down, left to right,
// so its children are (k + 1, 8 i + e).  A root with 2^r < 8 children pads
// the rest with far point boxes.  The last level's children are the
// leaves: row i of leaf8 holds their 8 tri ranges [from, to) in the
// binary kernel's own tri table.
//
// The rule, per ray (the TPU kernel applies it to a tile of rays):
//   - a visit reads the node's 8 boxes and slab-tests each with the
//     current best_t;
//   - at the last level, every child that passed (as tested BEFORE any of
//     this visit's scans) has its tris scanned, e = 0..7, with the running
//     best_t; then pop;
//   - elsewhere descend into the passing child of least entry distance
//     (the lowest e on a tie) after pushing the other passing children,
//     e = 7 down to 0, so the lowest pops first; with none passing, pop;
//   - popping the sentinel ends the walk.
// Distances equal the binary walk's bit for bit; ids equal it up to
// equal-t ties.
//
// Design: one thread per ray; a stack of 7 per level + 4 ints
// ((k << 28) | i) in thread-local memory.  A node is a row of 16 float4
// (child e: bmin.xyz, -, bmax.xyz, -), read two float4 at a time, so only
// the 8 entry distances and a hit mask stay live; the padded entries of a
// short root are also masked by index, so a child index never leaves its
// level whatever the ray.  kCount adds the four per-ray counters in the
// binary kernel's layout: wide-node visits, last-level visits that scanned
// (the TPU kernel's DMA bursts), 8-aligned slot groups entered, tri tests.
//
// What bounds it: fp32 operations (8 slab tests of 25 ops per visit, 55
// per tri test, counted by kCount), far above the bytes of rays and
// tables; divergence between the rays of a warp keeps it from that bound.

#include "bvh_common.cuh"

namespace {

using namespace bvh;

constexpr int kMaxLevels = 8;  // depth <= 24
constexpr int kStack = 7 * kMaxLevels + 4;
constexpr int kIndexBits = 28;

struct Levels {
  int off[kMaxLevels];  // first row of each wide level in nodes8
  int count;            // number of wide levels, M
  int root_children;    // 2^levels[1], or 8 when the root is the last level
};

template <bool kCount>
__global__ void __launch_bounds__(128)
bvh_wide_kernel(const float4* __restrict__ nodes8,
                const int4* __restrict__ leaf8,
                const float4* __restrict__ tris,
                const float* __restrict__ ray_o,
                const float* __restrict__ ray_d, int* __restrict__ out_idx,
                float* __restrict__ out_t, int4* __restrict__ out_counts,
                int n, Levels levels) {
  const int i_ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (i_ray >= n) return;
  const Ray r = load_ray(ray_o, ray_d, i_ray);
  float best_t = CUDART_INF_F;
  int best_idx = -1;
  int c_visits = 0, c_leaf = 0, c_groups = 0, c_tests = 0;
  const unsigned root_mask = (1u << levels.root_children) - 1u;

  int stack[kStack];
  stack[0] = -1;  // sentinel: popping it ends the walk
  int sp = 1;
  int k = 0;
  int i = 0;
  while (true) {
    const float4* row = nodes8 + 16 * (levels.off[k] + i);
    if constexpr (kCount) ++c_visits;
    unsigned hits = 0;
    float nears[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float4 lo = __ldg(&row[2 * e + 0]);
      const float4 hi = __ldg(&row[2 * e + 1]);
      if (slab(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, r, best_t, nears[e]))
        hits |= 1u << e;
    }
    if (k == 0) hits &= root_mask;
    const bool is_last = k == levels.count - 1;
    if (hits != 0 && !is_last) {
      int e_star = 0;
      float n_star = (hits & 1u) ? nears[0] : CUDART_INF_F;
#pragma unroll
      for (int e = 1; e < 8; ++e) {
        const float ne = (hits >> e & 1u) ? nears[e] : CUDART_INF_F;
        if (ne < n_star) {
          e_star = e;
          n_star = ne;
        }
      }
      const int child_base = i * 8;
#pragma unroll
      for (int e = 7; e >= 0; --e) {
        if ((hits >> e & 1u) && e != e_star)
          stack[sp++] = ((k + 1) << kIndexBits) | (child_base + e);
      }
      ++k;
      i = child_base + e_star;
      continue;
    }
    if (hits != 0) {
      if constexpr (kCount) ++c_leaf;
      const int4* lrow = leaf8 + 4 * i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 lf = __ldg(&lrow[q]);  // ranges of children 2q, 2q + 1
        if (hits >> (2 * q) & 1u) {
          if constexpr (kCount) c_groups += groups_of_8(lf.x, lf.y);
          test_tris<kCount>(tris, lf.x, lf.y, r, 0, -1, best_idx, best_t,
                            c_tests);
        }
        if (hits >> (2 * q + 1) & 1u) {
          if constexpr (kCount) c_groups += groups_of_8(lf.z, lf.w);
          test_tris<kCount>(tris, lf.z, lf.w, r, 0, -1, best_idx, best_t,
                            c_tests);
        }
      }
    }
    const int ent = stack[--sp];
    if (ent < 0) break;
    k = ent >> kIndexBits;
    i = ent & ((1 << kIndexBits) - 1);
  }
  out_idx[i_ray] = best_idx;
  out_t[i_ray] = best_t;
  if constexpr (kCount)
    out_counts[i_ray] = make_int4(c_visits, c_leaf, c_groups, c_tests);
}

}  // namespace

extern "C" {

// All pointers are device pointers.  level_off holds the first row of each
// of the n_levels wide levels (host memory, at most 8 entries);
// root_children is the number of real children of the root.  out_counts
// ([n] int4) may be null when count_steps == 0.  Launches on `stream` and
// returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a level count outside [1, 8]).
int bvh_wide(const void* nodes8, const void* leaf8, const void* tris,
             const void* ray_o, const void* ray_d, void* out_idx, void* out_t,
             void* out_counts, int n, const int* level_off, int n_levels,
             int root_children, int count_steps, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || root_children < 1 ||
      root_children > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  Levels levels;
  for (int k = 0; k < kMaxLevels; ++k)
    levels.off[k] = k < n_levels ? level_off[k] : 0;
  levels.count = n_levels;
  levels.root_children = root_children;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  auto kernel = count_steps ? &bvh_wide_kernel<true> : &bvh_wide_kernel<false>;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(nodes8), static_cast<const int4*>(leaf8),
      static_cast<const float4*>(tris), static_cast<const float*>(ray_o),
      static_cast<const float*>(ray_d), static_cast<int*>(out_idx),
      static_cast<float*>(out_t), static_cast<int4*>(out_counts), n, levels);
  return static_cast<int>(cudaGetLastError());
}

int bvh_wide_max_levels() { return kMaxLevels; }

const char* bvh_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
