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
// shared stack; this is the tile of one ray; its plain version is
// ops/traverse.py traverse_frontier_plain): the same implicit complete
// binary BVH and tables as bvh_traverse.cu, walked from a stack of
// (node, depth) that starts with the root.  While the stack is not empty:
//   - pop k = min(sp, K) entries, the top first;
//   - phase 1: slab-test both children of every popped entry with the
//     best_t of the step's START (so the prune inside a step is weaker
//     than the binary walk's, and a step may visit nodes that walk would
//     have cut: that is the design, and the visit counter shows it);
//   - phase 2, entries in pop order: at a leaf parent whose test passed,
//     scan the right child's tris if it overlapped, then the left's, with
//     the running best_t; elsewhere push the farther overlapping child,
//     then the nearer (left first when l_near <= r_near), so the nearer
//     pops first.  A push into a full stack (capacity 4 * K * depth + 8
//     entries, the TPU kernel's allocation; a push needs sp < cap - 1) is
//     refused, never written out of bounds; the refusals are counted.
//   - any-hit: best_t starts at t_max[i]; the first accepted hit on a tri
//     other than exclude[i] stores (tri, -inf) and ends the ray: the
//     entries after it in pop order neither scan nor push.
// Distances equal the binary walk's bit for bit (the least t under strict
// '<' does not depend on the order of the tests); ids equal it up to
// equal-t ties.
//
// Design: one ray per tile of G lanes, G = K rounded up to a power of two
// (2, 4, 4, 8, 8, 8, 8 for K = 2..8; cooperative_groups::tiled_partition),
// and a warp's tiles step together, so no tile's scan waits on another's.
// Every value of a ray's walk (best_t, best_idx, sp, the counters) is the
// same on all of its tile's lanes.  A step of the warp:
//   - phase 1: in each tile, lane j < k pops entry j and makes its two
//     slab tests, so the K box fetches and 2K tests run side by side;
//   - the leaf scans, shared by the warp: each leaf-parent entry that
//     passed lists its right range, then its left; the warp's lists, tile
//     by tile and entry by entry in pop order, are one list, whose range
//     table (64 ranges: two a lane) sits in shared memory.  Rounds of 32
//     positions make one Moller-Trumbore test a lane, with the ray (by
//     shuffles from its tile) and the step's starting best_t of the tile
//     that owns the position; an accepted test lowers the tile's key by a
//     shared-memory atomicMin: (t, position) for closest-hit, the position
//     for any-hit.  The least key is what the one-by-one scan keeps, and
//     the counters follow from positions, so ids, t and counters equal it;
//   - pushes: 0-2 per interior entry before the any-hit cut; an exclusive
//     prefix sum over the tile, in pop order, gives each push its stack
//     slot, and push q of a step is taken while sp0 + q < cap - 1 (the
//     sequential rule: once one is refused, so is every later one);
//   - the stack: 4 * K * depth + 8 ints a ray ((node << 5) | depth), in
//     dynamic shared memory, one block of cap ints a tile, rotated so that
//     entry e of tile t sits in bank (e + t * G) mod 32 and the tiles of a
//     warp at equal depth fall in other banks.  With the scan scratch,
//     2,560 + (128 / G) * cap * 4 bytes a block: at most 45,568 (K = 2,
//     depth 20), under the 48 KB that needs no opt-in;
//   - the schedule: a persistent grid (as many blocks as fit on the SMs
//     together); a tile whose ray has ended takes the next (sorted) ray
//     from a work counter at the next step, so the tiles of a warp walk
//     rays taken at about the same time, neighbours in the sort, and the
//     card does not wait on a last wave.  (Runs of 4 or 16 rays a take
//     were slower: PERF.md.)
// kCount adds the binary kernel's four per-ray counters (node visits,
// leaf-parent visits, 8-aligned slot groups entered, tri tests) and,
// through one atomic a tile at its end, the deepest stack any ray reached
// and the number of refused pushes.
//
// What bounds it: as bvh_traverse.cu, fp32 operations on the CUDA cores
// (50 per visit, 55 per tri test, counted by kCount), far above the bytes
// of rays and tables.  What kept the first design (one ray per thread, its
// stack of up to 648 ints in local memory, the K entries' tests, scans and
// pushes one after another in that thread) at 2-3% of that bound was the
// local-memory stack and a warp's lanes waiting on each other's leaves.
// Scanning within each tile instead (G lanes on one ray's list) left the
// tiles of a warp waiting on the longest list: PERF.md has its times.

#include <cooperative_groups.h>

#include "bvh_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bvh;  // Ray, slab, groups_of_8, the pooled scan

constexpr int kMaxDepth = 20;
constexpr int kDepthBits = 5;
constexpr int kThreads = 128;
constexpr int kSharedLimit = 48 * 1024;
constexpr int kRanges = 64;  // two leaf ranges a lane of a warp

// The lanes of a ray's tile.
__host__ __device__ constexpr int tile_width(int k) {
  return k <= 2 ? 2 : (k <= 4 ? 4 : 8);
}

__host__ __device__ constexpr int stack_rows(int k, int depth) {
  return 4 * k * depth + 8;
}

// Dynamic shared memory of one block: each warp's scan scratch (two ints
// for each of 64 ranges, a key of 8 bytes for each of at most 16 tiles),
// then its tiles' stacks.
constexpr int kScratchBytes = 2 * kRanges * 4 + 16 * 8;
size_t shared_bytes(int k, int depth) {
  return static_cast<size_t>(kThreads / 32) * kScratchBytes +
         static_cast<size_t>(kThreads / tile_width(k)) *
             stack_rows(k, depth) * sizeof(int);
}

struct Tables {
  const float4* __restrict__ boxes;
  const int4* __restrict__ leaves;
  const float4* __restrict__ tris;
};

struct Rays {
  const float* __restrict__ o;
  const float* __restrict__ d;
  const int* __restrict__ exclude;
  const float* __restrict__ t_max;
  int* __restrict__ out_idx;
  float* __restrict__ out_t;
  int4* __restrict__ out_counts;
};

// A tile's stack: cap ints of shared memory, entry e at (e + rot) mod cap.
struct Stack {
  int* base;
  int cap;
  int rot;
  __device__ __forceinline__ int& operator[](int e) const {
    const int p = e + rot;
    return base[p >= cap ? p - cap : p];
  }
};

// One warp's scan scratch: the range table of a step (two ranges a lane,
// right then left: range d at lane d >> 1) and the key of each of up to
// 16 tiles.
using Scratch = ScanScratch<kRanges, 32 / 2>;
static_assert(sizeof(Scratch) == kScratchBytes, "scan scratch layout");

template <int K, bool kCount>
__global__ void __launch_bounds__(kThreads)
bvh_frontier_walk(Tables tb, Rays io, int* __restrict__ next_ray,
                  int* __restrict__ stack_stats, int n, int depth,
                  int any_hit) {
  constexpr int G = tile_width(K);
  extern __shared__ unsigned long long smem[];
  Scratch* const scratch = reinterpret_cast<Scratch*>(smem) + (threadIdx.x >> 5);
  int* const stacks = reinterpret_cast<int*>(reinterpret_cast<Scratch*>(smem) +
                                             kThreads / 32);
  cg::thread_block_tile<G> tile =
      cg::tiled_partition<G>(cg::this_thread_block());
  const int lane = tile.thread_rank();  // in the tile: entry `lane`
  const int wl = threadIdx.x & 31;      // in the warp
  const int tw = wl / G;                // the tile in the warp
  const int leader = wl & ~(G - 1);     // the tile's lane 0, in the warp
  const int t = tile.meta_group_rank();
  const int cap = stack_rows(K, depth);
  int rot = (t * (G - cap)) & 31;  // bank (e + t * G) mod 32
  if (rot >= cap) rot %= cap;
  const Stack st{stacks + t * cap, cap, rot};
  // The tile's ray (ray < 0: none) and where its walk stands; every value
  // is the same on all of the tile's lanes.
  Ray r = {};
  int ray = -1, excl = -1, best_idx = -1, sp = 0;
  float best_t = 0.0f;
  int visits = 0, leaf = 0, groups = 0, tests = 0;
  bool drained = false;
  int deepest_all = 0, refused_all = 0;
  for (;;) {
    // A tile without a ray takes the next one from the work counter.
    if (ray < 0 && !drained) {
      const int taken = take_ray(tile, next_ray);
      drained = taken >= n;
      if (!drained) {
        ray = taken;
        r = load_ray(io.o, io.d, ray);
        excl = any_hit ? io.exclude[ray] : -1;
        best_t = any_hit ? io.t_max[ray] : CUDART_INF_F;
        best_idx = -1;
        visits = leaf = groups = tests = 0;
        if (lane == 0) st[0] = 0;  // the root, at depth 0
        sp = 1;
        deepest_all = deepest_all > 1 ? deepest_all : 1;
      }
    }
    if (!__any_sync(kAllLanes, ray >= 0)) break;
    __syncwarp();  // a new root is written before it is popped
    // Phase 1: lane j < k pops entry j and tests its two children with
    // the best_t of the step's start.
    const int k = ray < 0 ? 0 : (sp < K ? sp : K);
    const int sp0 = sp - k;
    const bool mine = lane < k;
    int node = 0, ndep = 0;
    bool l_over = false, r_over = false;
    float l_near = CUDART_INF_F, r_near = CUDART_INF_F;
    if (mine) {
      const int e = st[sp - 1 - lane];
      node = e >> kDepthBits;
      ndep = e & ((1 << kDepthBits) - 1);
      const float4 b0 = __ldg(&tb.boxes[3 * node + 0]);
      const float4 b1 = __ldg(&tb.boxes[3 * node + 1]);
      const float4 b2 = __ldg(&tb.boxes[3 * node + 2]);
      l_over = slab(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, r, best_t, l_near);
      r_over = slab(b1.z, b1.w, b2.x, b2.y, b2.z, b2.w, r, best_t, r_near);
    }
    if constexpr (kCount) visits += k;
    // Phase 2, the leaf scans: every leaf-parent entry that passed lists
    // its right range, then its left; the warp's lists, tile by tile and
    // entry by entry in pop order, are one list of `pooled` positions.
    const bool at_leaf = mine && ndep == depth - 1;
    const bool scans = at_leaf && (l_over || r_over);
    int4 lf = make_int4(0, 0, 0, 0);
    if (scans) lf = __ldg(&tb.leaves[node]);  // (l_from, l_to, r_from, r_to)
    const int a_len = scans && r_over ? lf.w - lf.z : 0;
    const int list = a_len + (scans && l_over ? lf.y - lf.x : 0);
    const int incl = warp_inclusive_sum(list);
    const int pooled = __shfl_sync(kAllLanes, incl, 31);
    const int first = incl - list;
    const int tile_first = __shfl_sync(kAllLanes, first, leader);
    const int tile_list =
        __shfl_sync(kAllLanes, incl, leader + G - 1) - tile_first;
    scratch->start[2 * wl] = first;
    scratch->start[2 * wl + 1] = first + a_len;
    scratch->shift[2 * wl] = lf.z - first;
    scratch->shift[2 * wl + 1] = lf.x - (first + a_len);
    if (lane == 0) scratch->key[tw] = kNoKey;
    __syncwarp();  // the pops are read and the range table is written
    // The pooled scan (bvh_common.cuh): the least key of each tile is the
    // one-by-one scan's result.
    pooled_scan<G>(scratch, pooled, tb.tris, r, best_t, any_hit != 0, excl);
    // The tile's result: its least key, if any.
    const unsigned long long key = scratch->key[tw];
    bool resolved = false;
    int cut = K;  // entries from `cut` on are cut off by an any-hit
    int tested = tile_list;
    bool in_right = false;
    if (key != kNoKey) {
      const int p = static_cast<int>(key & 0xffffffffu);
      const int d = scratch->find(p);
      best_idx = p + scratch->shift[d];
      if (any_hit) {
        best_t = -CUDART_INF_F;
        resolved = true;
        cut = (d >> 1) & (G - 1);
        in_right = (d & 1) == 0;
        tested = p - tile_first + 1;
      } else {
        moller_trumbore(tb.tris, best_idx, r, best_t);  // its t, bit for bit
      }
    }
    if constexpr (kCount) {
      // Leaf entries and groups up to the cut; a ray resolved in the
      // right child never enters the left.
      const bool counted = scans && lane <= cut;
      int g = 0;
      if (counted) {
        g = scans && r_over ? groups_of_8(lf.z, lf.w) : 0;
        if (l_over && (lane < cut || !in_right)) g += groups_of_8(lf.x, lf.y);
      }
      int c = counted ? 1 : 0;
#pragma unroll
      for (int s = 1; s < G; s <<= 1) {
        g += tile.shfl_xor(g, s);
        c += tile.shfl_xor(c, s);
      }
      groups += g;
      leaf += c;
      tests += tested;
    }
    // Phase 2, the pushes of the interior entries before the cut: the
    // farther child, then the nearer, entry by entry in pop order.
    const bool pushes = mine && !at_leaf && lane < cut;
    const bool l_first = l_near <= r_near;
    const int l_idx = node + 1;
    const int r_idx = node + (1 << (depth - ndep));
    const bool far_ok = pushes && (l_first ? r_over : l_over);
    const bool near_ok = pushes && (l_first ? l_over : r_over);
    const int own = static_cast<int>(far_ok) + static_cast<int>(near_ok);
    int pre = own;
#pragma unroll
    for (int s = 1; s < G; s <<= 1) {
      const int v = tile.shfl_up(pre, s);
      if (lane >= s) pre += v;
    }
    const int total = tile.shfl(pre, G - 1);
    int qs = sp0 + pre - own;
    if (far_ok) {
      if (qs < cap - 1)
        st[qs] = ((l_first ? r_idx : l_idx) << kDepthBits) | (ndep + 1);
      ++qs;
    }
    if (near_ok && qs < cap - 1)
      st[qs] = ((l_first ? l_idx : r_idx) << kDepthBits) | (ndep + 1);
    const int room = cap - 1 - sp0;
    const int taken = total < room ? total : room;
    refused_all += total - taken;
    sp = sp0 + taken;
    deepest_all = sp > deepest_all ? sp : deepest_all;
    if (ray >= 0 && (sp == 0 || resolved)) {
      if (lane == 0) {
        io.out_idx[ray] = best_idx;
        io.out_t[ray] = best_t;
        if constexpr (kCount)
          io.out_counts[ray] = make_int4(visits, leaf, groups, tests);
      }
      ray = -1;
    }
    __syncwarp();  // the pushes are seen, and the keys read, before the next step
  }
  if constexpr (kCount) {
    if (lane == 0) {
      atomicMax(&stack_stats[0], deepest_all);
      if (refused_all) atomicAdd(&stack_stats[1], refused_all);
    }
  }
}

using Kernel = void (*)(Tables, Rays, int*, int*, int, int, int);

#define FRONTIER(K) \
  { &bvh_frontier_walk<K, false>, &bvh_frontier_walk<K, true> }

// kKernels[K - 2][count_steps]
const Kernel kKernels[7][2] = {FRONTIER(2), FRONTIER(3), FRONTIER(4),
                               FRONTIER(5), FRONTIER(6), FRONTIER(7),
                               FRONTIER(8)};

bool admits(int frontier, int depth) {
  return frontier >= 2 && frontier <= 8 && depth >= 1 &&
         depth <= kMaxDepth && shared_bytes(frontier, depth) <= kSharedLimit;
}

}  // namespace

extern "C" {

int bvh_frontier_max_depth() { return kMaxDepth; }
int bvh_frontier_threads() { return kThreads; }

// The lanes of a ray's tile for this K, or 0 for a K outside [2, 8].
int bvh_frontier_tile_width(int frontier) {
  return frontier >= 2 && frontier <= 8 ? tile_width(frontier) : 0;
}

// The dynamic shared memory of one block (its tiles' stacks), in bytes.
int bvh_frontier_shared_bytes(int frontier, int depth) {
  return static_cast<int>(shared_bytes(frontier, depth));
}

// The blocks of the kernel for this K that fit on one SM together at this
// depth, into *blocks; returns the cudaError_t of the query.
int bvh_frontier_blocks_per_sm(int frontier, int count_steps, int depth,
                               int* blocks) {
  if (!admits(frontier, depth)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kKernels[frontier - 2][count_steps ? 1 : 0], kThreads,
      shared_bytes(frontier, depth)));
}

// All pointers are device pointers.  exclude and t_max may be null when
// any_hit == 0; out_counts ([n] int4) and stack_stats (two ints the caller
// zeroed: the deepest stack of any ray, the refused pushes) when
// count_steps == 0.  next_ray: one int of device memory, the work
// counter, which this call zeroes on the stream before the launch; grid:
// the blocks of the persistent grid (bvh_frontier_blocks_per_sm x the
// SMs, or fewer for few rays).  Launches on `stream` and returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a
// frontier outside [2, 8], a depth outside [1, kMaxDepth] or a grid < 1).
int bvh_frontier(const void* boxes, const void* leaves, const void* tris,
                 const void* ray_o, const void* ray_d, const void* exclude,
                 const void* t_max, void* out_idx, void* out_t,
                 void* out_counts, void* stack_stats, void* next_ray, int n,
                 int depth, int frontier, int any_hit, int count_steps,
                 int grid, void* stream) {
  if (!admits(frontier, depth) || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const Tables tb{static_cast<const float4*>(boxes),
                  static_cast<const int4*>(leaves),
                  static_cast<const float4*>(tris)};
  const Rays io{static_cast<const float*>(ray_o),
                static_cast<const float*>(ray_d),
                static_cast<const int*>(exclude),
                static_cast<const float*>(t_max),
                static_cast<int*>(out_idx),
                static_cast<float*>(out_t),
                static_cast<int4*>(out_counts)};
  const Kernel kernel = kKernels[frontier - 2][count_steps ? 1 : 0];
  kernel<<<grid, kThreads, shared_bytes(frontier, depth), s>>>(
      tb, io, static_cast<int*>(next_ray), static_cast<int*>(stack_stats), n,
      depth, any_hit);
  return static_cast<int>(cudaGetLastError());
}

const char* bvh_frontier_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
