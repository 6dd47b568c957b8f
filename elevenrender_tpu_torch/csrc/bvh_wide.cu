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
// The rule, per ray (the TPU kernel applies it to a tile of rays; its
// plain version is experiments/bvh_wide.py traverse_wide_plain):
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
// Design: one ray per tile of 8 lanes (cooperative_groups::
// tiled_partition<8>), lane e owning child e of every node the ray visits,
// and a warp's 4 tiles step together.  A step of the warp:
//   - a visit in each tile: lane e reads its child's 2 float4 (child e:
//     bmin.xyz, -, bmax.xyz, -), so the tile reads the node's 256
//     contiguous bytes at once, and makes its slab test; a ballot gives the
//     hit mask (the padded children of a short root masked by index, so a
//     child index never leaves its level whatever the ray);
//   - the next node: three xor-shuffle steps find the least (entry
//     distance, e); each other passing child e is pushed by its own lane
//     at sp + (passing children above e), the reference's push order;
//   - the last level, shared by the warp: the passing children's tri
//     ranges, e = 0..7, tile by tile, are one list, whose range table (one
//     range a lane) sits in shared memory; rounds of 32 positions make one
//     Moller-Trumbore test a lane with the ray (by shuffles) and best_t of
//     the tile that owns the position, and an accepted test lowers that
//     tile's (t, position) key by a shared-memory atomicMin: the least key
//     is the one-by-one scan's result, and every counter its count;
//   - the stack: 7 per wide level + 4 ints a ray ((k << 28) | i) in
//     dynamic shared memory, after the warps' scan scratch;
//   - the schedule: a persistent grid; a tile whose ray has ended takes
//     the next (sorted) ray from a work counter at the next step.
// kCount adds the four per-ray counters in the binary kernel's layout:
// wide-node visits, last-level visits that scanned (the TPU kernel's DMA
// bursts), 8-aligned slot groups entered, tri tests.
//
// What bounds it: fp32 operations (8 slab tests of 25 ops per visit, 55
// per tri test, counted by kCount), far above the bytes of rays and
// tables.  The first design (one thread per ray, the 8 boxes tested and
// the up to 8 leaf ranges scanned one after another, a 60-int stack in
// local memory) ran at 2-3% of that bound; scanning within each tile (8
// lanes on one ray's list) left a warp's tiles waiting on its longest
// list: PERF.md has its times.

#include <cooperative_groups.h>

#include "bvh_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bvh;  // Ray, slab, moller_trumbore, groups_of_8, the
                      // pooled scan

constexpr int kMaxLevels = 8;  // depth <= 24
constexpr int kIndexBits = 28;
constexpr int kThreads = 128;
constexpr int kWide = 8;   // lanes of a ray's tile: one a child

__host__ __device__ constexpr int stack_rows(int n_levels) {
  return 7 * n_levels + 4;
}

// Dynamic shared memory of one block: each warp's scan scratch (two ints
// for each of its 32 lanes' ranges, a key of 8 bytes for each of its 4
// tiles), then its tiles' stacks.
constexpr int kScratchBytes = 2 * 32 * 4 + (32 / kWide) * 8;
size_t shared_bytes(int n_levels) {
  return static_cast<size_t>(kThreads / 32) * kScratchBytes +
         static_cast<size_t>(kThreads / kWide) * stack_rows(n_levels) *
             sizeof(int);
}

struct Levels {
  int off[kMaxLevels];  // first row of each wide level in nodes8
  int count;            // number of wide levels, M
  int root_children;    // 2^levels[1], or 8 when the root is the last level
};

// The first row of wide level k, by selects (a dynamic index into the
// kernel's parameters would copy them to local memory).
__device__ __forceinline__ int level_off(const Levels& lv, int k) {
  int off = 0;
#pragma unroll
  for (int m = 0; m < kMaxLevels; ++m) off = m == k ? lv.off[m] : off;
  return off;
}

struct Rays {
  const float* __restrict__ o;
  const float* __restrict__ d;
  int* __restrict__ out_idx;
  float* __restrict__ out_t;
  int4* __restrict__ out_counts;
};

// One warp's scan scratch: the range table of a step (lane e of tile w
// holds child e's range, range 8 w + e) and each tile's key.
using Scratch = ScanScratch<32, 32 / kWide>;
static_assert(sizeof(Scratch) == kScratchBytes, "scan scratch layout");

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
bvh_wide_walk(const float4* __restrict__ nodes8,
              const int2* __restrict__ leaf8,
              const float4* __restrict__ tris, Rays io,
              int* __restrict__ next_ray, int n, Levels lv) {
  extern __shared__ unsigned long long smem[];
  Scratch* const scratch =
      reinterpret_cast<Scratch*>(smem) + (threadIdx.x >> 5);
  int* const stacks =
      reinterpret_cast<int*>(reinterpret_cast<Scratch*>(smem) + kThreads / 32);
  cg::thread_block_tile<kWide> tile =
      cg::tiled_partition<kWide>(cg::this_thread_block());
  const int e = tile.thread_rank();  // the child this lane owns
  const int wl = threadIdx.x & 31;
  const int tw = wl / kWide;
  const int leader = wl & ~(kWide - 1);
  int* const stack = stacks + tile.meta_group_rank() * stack_rows(lv.count);
  const bool real_root_child = e < lv.root_children;
  // The tile's ray (ray < 0: none) and where its walk stands, the same on
  // all of its lanes: wide node (k, i) is the next to visit.
  Ray r = {};
  int ray = -1, best_idx = -1, sp = 0, k = 0, i = 0;
  float best_t = 0.0f;
  int visits = 0, leaf = 0, groups = 0, tests = 0;
  bool drained = false;
  for (;;) {
    // A tile without a ray takes the next one from the work counter.
    if (ray < 0 && !drained) {
      const int taken = take_ray(tile, next_ray);
      drained = taken >= n;
      if (!drained) {
        ray = taken;
        r = load_ray(io.o, io.d, ray);
        best_t = CUDART_INF_F;
        best_idx = -1;
        visits = leaf = groups = tests = 0;
        if (e == 0) stack[0] = -1;  // sentinel: popping it ends the walk
        sp = 1;
        k = 0;
        i = 0;
      }
    }
    if (!__any_sync(kAllLanes, ray >= 0)) break;
    __syncwarp();  // a new sentinel is written before it is popped
    // The visit: lane e tests child e of node (k, i).
    const bool active = ray >= 0;
    bool hit = false;
    float near = CUDART_INF_F;
    if (active) {
      const float4* row = nodes8 + 16 * (level_off(lv, k) + i);
      const float4 lo = __ldg(&row[2 * e + 0]);
      const float4 hi = __ldg(&row[2 * e + 1]);
      hit = slab(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, r, best_t, near) &&
            (k > 0 || real_root_child);
    }
    const unsigned hits = tile.ballot(hit);
    if constexpr (kCount) visits += active ? 1 : 0;
    const bool is_last = k == lv.count - 1;
    const bool descend = hits != 0 && !is_last;
    const bool scan = hits != 0 && is_last;
    // Above the last level: the passing child of least entry distance,
    // the lowest e on a tie; each other passing child is pushed by its
    // own lane, e = 7 deepest.
    float n_star = hit ? near : CUDART_INF_F;
    int e_star = e;
#pragma unroll
    for (int s = 1; s < kWide; s <<= 1) {
      const float n2 = tile.shfl_xor(n_star, s);
      const int e2 = tile.shfl_xor(e_star, s);
      const bool take = n2 < n_star || (n2 == n_star && e2 < e_star);
      n_star = take ? n2 : n_star;
      e_star = take ? e2 : e_star;
    }
    if (descend) {
      const unsigned others = hits & ~(1u << e_star);
      const int child_base = i * kWide;
      if ((others >> e) & 1u)
        stack[sp + __popc(others >> (e + 1))] =
            ((k + 1) << kIndexBits) | (child_base + e);
      sp += __popc(others);
      ++k;
      i = child_base + e_star;
    }
    // The last level: the passing children's ranges, e = 0..7, tile by
    // tile, are one list of the warp for the pooled scan (bvh_common.cuh).
    // Each tile's least key is what the one-by-one scan keeps (the visit's
    // best_t admits all it would accept, and more).
    int2 lf = make_int2(0, 0);
    if (scan && hit) lf = __ldg(&leaf8[kWide * i + e]);  // [from, to)
    const int len = lf.y - lf.x;
    const int incl = warp_inclusive_sum(len);
    const int pooled = __shfl_sync(kAllLanes, incl, 31);
    const int first = incl - len;
    const int tile_list =
        __shfl_sync(kAllLanes, incl, leader + kWide - 1) -
        __shfl_sync(kAllLanes, first, leader);
    scratch->start[wl] = first;
    scratch->shift[wl] = lf.x - first;
    if (e == 0) scratch->key[tw] = kNoKey;
    __syncwarp();
    pooled_scan<kWide>(scratch, pooled, tris, r, best_t, false, -1);
    const unsigned long long key = scratch->key[tw];
    if (key != kNoKey) {
      const int p = static_cast<int>(key & 0xffffffffu);
      best_idx = p + scratch->shift[scratch->find(p)];
      moller_trumbore(tris, best_idx, r, best_t);  // its t, bit for bit
    }
    if constexpr (kCount) {
      int g = scan && hit ? groups_of_8(lf.x, lf.y) : 0;
#pragma unroll
      for (int s = 1; s < kWide; s <<= 1) g += tile.shfl_xor(g, s);
      groups += g;
      leaf += scan ? 1 : 0;
      tests += tile_list;
    }
    // Pop, unless the visit descended; popping the sentinel ends the ray.
    if (active && !descend) {
      const int ent = stack[--sp];
      if (ent < 0) {
        if (e == 0) {
          io.out_idx[ray] = best_idx;
          io.out_t[ray] = best_t;
          if constexpr (kCount)
            io.out_counts[ray] = make_int4(visits, leaf, groups, tests);
        }
        ray = -1;
      } else {
        k = ent >> kIndexBits;
        i = ent & ((1 << kIndexBits) - 1);
      }
    }
    __syncwarp();  // pushes seen, pops and keys read, before the next step
  }
}

using Kernel = void (*)(const float4*, const int2*, const float4*, Rays, int*,
                        int, Levels);

const Kernel kKernels[2] = {&bvh_wide_walk<false>, &bvh_wide_walk<true>};

}  // namespace

extern "C" {

int bvh_wide_max_levels() { return kMaxLevels; }
int bvh_wide_threads() { return kThreads; }

// The dynamic shared memory of one block (its tiles' stacks), in bytes.
int bvh_wide_shared_bytes(int n_levels) {
  return static_cast<int>(shared_bytes(n_levels));
}

// The blocks of the kernel that fit on one SM together for a tree of
// n_levels wide levels, into *blocks; returns the cudaError_t of the query.
int bvh_wide_blocks_per_sm(int count_steps, int n_levels, int* blocks) {
  if (n_levels < 1 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kKernels[count_steps ? 1 : 0], kThreads,
      shared_bytes(n_levels)));
}

// All pointers are device pointers.  level_off holds the first row of each
// of the n_levels wide levels (host memory, at most 8 entries);
// root_children is the number of real children of the root.  out_counts
// ([n] int4) may be null when count_steps == 0.  next_ray: one int of
// device memory, the work counter, which this call zeroes on the stream
// before the launch; grid: the blocks of the persistent grid
// (bvh_wide_blocks_per_sm x the SMs, or fewer for few rays).  Launches on
// `stream` and returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a level count outside [1, 8], a root with
// other than 1..8 children or a grid < 1).
int bvh_wide(const void* nodes8, const void* leaf8, const void* tris,
             const void* ray_o, const void* ray_d, void* out_idx, void* out_t,
             void* out_counts, void* next_ray, int n, const int* level_off,
             int n_levels, int root_children, int count_steps, int grid,
             void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || root_children < 1 ||
      root_children > 8 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  Levels lv;
  for (int k = 0; k < kMaxLevels; ++k)
    lv.off[k] = k < n_levels ? level_off[k] : 0;
  lv.count = n_levels;
  lv.root_children = root_children;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const Rays io{static_cast<const float*>(ray_o),
                static_cast<const float*>(ray_d), static_cast<int*>(out_idx),
                static_cast<float*>(out_t), static_cast<int4*>(out_counts)};
  kKernels[count_steps ? 1 : 0]<<<grid, kThreads, shared_bytes(n_levels), s>>>(
      static_cast<const float4*>(nodes8), static_cast<const int2*>(leaf8),
      static_cast<const float4*>(tris), io, static_cast<int*>(next_ray), n,
      lv);
  return static_cast<int>(cudaGetLastError());
}

const char* bvh_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
