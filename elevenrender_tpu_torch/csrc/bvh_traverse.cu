// BVH traversal for Hopper (sm_90a): the binary walk's closest-hit and
// any-hit kernels, with the TPU kernel's measurement and ordering variants
// as compile-time instantiations.
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
// The walk, per ray (the contract; its plain version is ops/traverse.py
// traverse_plain, which it equals bit for bit): the implicit complete
// binary BVH (preorder, left = node+1, right = node + 2^(D-depth)) from a
// stack of (node, depth), with the TPU kernel's visit and accept rules
// applied per ray instead of per 4096-ray tile:
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
// in the plain version.
//
// Variants (template parameters; <kAny, false, false, 0, 0> is the walk
// above and nothing else):
//   kAny       any-hit (true) or closest-hit (false): two kernels, so the
//              any-hit one carries no running best_t through its scans;
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
//              probes: every ray misses, by design.  A probe keeps the
//              full scan's schedule (a lane waits at every leaf parent
//              that a child's box passes, and its warp makes the scan
//              round with empty lists) and is launched on the full scan's
//              grid, so what it saves is the scans' (and the leaf row's)
//              share of that kernel's time.
//
// What bounds it on this card: fp32 arithmetic on the CUDA cores (about
// 50 ops per visit, 55 per triangle test, 25 per group box) against a few
// tens of MB of rays and tables, so operations, counted by kCount from the
// run's own rays, set the bound of a closest-hit launch.  What kept the
// first version (bvh_traverse_v1.cu, kept for the A/B sweep) at 2-3% of it
// was where and when the steps ran, not how many there were: a warp's
// lanes scanned their leaves at different loop iterations, each while the
// others waited, and each scan ran as long as its lane's range or until
// its any-hit; a warp waited on its slowest ray and the card on its last
// wave; the stack sat in local memory.  The design changes only that:
//   - persistent warps with ray refill (Aila and Laine, "Understanding the
//     Efficiency of Ray Traversal on GPUs", HPG 2009): the grid is as many
//     blocks as fit on the SMs together; a warp takes runs of 32
//     consecutive (sorted) rays from a work counter, and lanes whose rays
//     have ended take the next rays of the run at the top of a round, once
//     eight of them are idle;
//   - while-while: a round first walks each lane's nodes (interior visits,
//     and leaf-parent visits that scan nothing) until its next step is a
//     scan or its ray ends, so the lanes of a warp make their scans
//     together;
//   - warp-shared scans (kLeafAabb 0, the render paths' default): the
//     waiting lanes' scan lists are spread over the whole warp, a lane's
//     next 2..32 positions on an aligned group of lanes once 16 or fewer
//     lanes have work left, reduced by shuffles (shared_scans), so no lane
//     idles while another scans and neighbouring lanes read neighbouring
//     tri rows;
//   - the stack: one int per entry, (node << 5) | depth, in shared memory
//     laid out [entry][thread] (a warp's 32 entries of one level fall in
//     32 banks), depth - 1 entries a thread (entries on the stack have
//     strictly rising depths in [1, depth - 1]).
// Tried and dropped (PERF.md): an L1 prefetch of both children's box rows;
// __launch_bounds__ for 10-16 blocks an SM (spills); refilling a lane
// during the walk, and scanning once 1-16 lanes wait instead of all (more
// registers, one block less an SM): each slower.

#include "bvh_common.cuh"

namespace {

using namespace bvh;  // Ray, slab, test_tris, groups_of_8 (bvh_common.cuh)

constexpr int kThreads = 128;
constexpr int kDepthBits = 5;
// A warp refills its idle lanes once this many are idle: fewer, larger
// refills keep a warp's rays neighbours in the sort (the ladder's last
// step against refilling every idle lane at once, PERF.md).
constexpr int kRefillAt = 8;
constexpr unsigned kFull = 0xffffffffu;

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

struct Tables {
  const float4* __restrict__ boxes;
  const int4* __restrict__ leaves;
  const float4* __restrict__ tris;
  const int* __restrict__ order_code;
  const float4* __restrict__ groups;
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

// One lane's ray and where its walk stands.  ray < 0: the lane has none.
struct Lane {
  Ray r;
  int ray;
  int excl;
  float best_t;
  int best_idx;
  int node, ndep, sp;
  int visits, leaf, groups, tests;
};

template <bool kAny>
__device__ __forceinline__ void start(Lane& w, int ray, const Rays& io) {
  w.ray = ray;
  w.r = load_ray(io.o, io.d, ray);
  w.excl = kAny ? io.exclude[ray] : -1;
  w.best_t = kAny ? io.t_max[ray] : CUDART_INF_F;
  w.best_idx = -1;
  w.node = 0;
  w.ndep = 0;
  w.sp = 0;
  w.visits = w.leaf = w.groups = w.tests = 0;
}

template <bool kCount>
__device__ __forceinline__ void finish(Lane& w, const Rays& io) {
  io.out_idx[w.ray] = w.best_idx;
  io.out_t[w.ray] = w.best_t;
  if constexpr (kCount)
    io.out_counts[w.ray] = make_int4(w.visits, w.leaf, w.groups, w.tests);
  w.ray = -1;
}

// The next node from the stack; false when the stack is empty (the walk
// is over).  stack points at this thread's column, entry e at
// stack[e * kThreads].
__device__ __forceinline__ bool pop(Lane& w, const int* stack) {
  if (w.sp == 0) return false;
  const int e = stack[--w.sp * kThreads];
  w.node = e >> kDepthBits;
  w.ndep = e & ((1 << kDepthBits) - 1);
  return true;
}

// Both children's boxes of w.node against the ray, pruned by best_t.
__device__ __forceinline__ void children(const Tables& tb, Lane& w,
                                         bool& l_over, float& l_near,
                                         bool& r_over, float& r_near) {
  const float4 b0 = __ldg(&tb.boxes[3 * w.node + 0]);
  const float4 b1 = __ldg(&tb.boxes[3 * w.node + 1]);
  const float4 b2 = __ldg(&tb.boxes[3 * w.node + 2]);
  l_over = slab(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, w.r, w.best_t, l_near);
  r_over = slab(b1.z, b1.w, b2.x, b2.y, b2.z, b2.w, w.r, w.best_t, r_near);
}

// A visit of an interior node above the leaf parents.  False when the
// walk is over.
template <bool kCount, bool kSign>
__device__ __forceinline__ bool interior(const Tables& tb, Lane& w,
                                         int* stack, int depth) {
  const int l_idx = w.node + 1;
  const int r_idx = w.node + (1 << (depth - w.ndep));
  bool l_over, r_over;
  float l_near, r_near;
  children(tb, w, l_over, l_near, r_over, r_near);
  if constexpr (kCount) ++w.visits;
  if (l_over && r_over) {
    bool l_first;
    if constexpr (kSign) {
      const int code = __ldg(&tb.order_code[w.node]);
      const bool left_pos = code >= 3;
      const int ax = left_pos ? code - 3 : code;
      const float dir = ax == 0 ? w.r.dx : (ax == 1 ? w.r.dy : w.r.dz);
      l_first = (dir >= 0.0f) != left_pos;
    } else {
      l_first = l_near <= r_near;
    }
    stack[w.sp++ * kThreads] =
        ((l_first ? r_idx : l_idx) << kDepthBits) | (w.ndep + 1);
    w.node = l_first ? l_idx : r_idx;
    ++w.ndep;
    return true;
  }
  if (l_over || r_over) {
    w.node = l_over ? l_idx : r_idx;
    ++w.ndep;
    return true;
  }
  return pop(w, stack);
}

// The part of a leaf-parent visit before its scans: both children's box
// tests and the leaf row.  Where the probe skips the leaf step (kLeafMode
// 2), the leaf row is not read and the step is not counted; l_over and
// r_over still say where the full scan would wait.
template <bool kCount, int kLeafMode>
__device__ __forceinline__ void leaf_boxes(const Tables& tb, Lane& w,
                                           int4& lf, bool& l_over,
                                           bool& r_over) {
  if constexpr (kLeafMode != 2) lf = __ldg(&tb.leaves[w.node]);
  float l_near, r_near;
  children(tb, w, l_over, l_near, r_over, r_near);
  if constexpr (kCount) ++w.visits;
  if constexpr (kCount && kLeafMode != 2) w.leaf += (l_over || r_over) ? 1 : 0;
}

// A lane's own scans at a leaf parent (leaf_aabb 1 and 2): the right
// child's range, then the left's.  True when an any-hit ray is resolved.
template <bool kAny, bool kCount, int kLeafAabb>
__device__ __forceinline__ bool own_scans(const Tables& tb, Lane& w,
                                          int4 lf, bool l_over, bool r_over) {
  if (r_over) {
    if constexpr (kCount) w.groups += groups_of_8(lf.z, lf.w);
    if (scan<kCount, kLeafAabb>(tb.tris, tb.groups, lf.z, lf.w, w.r, kAny,
                                w.excl, w.best_idx, w.best_t, w.tests))
      return true;
  }
  if (l_over) {
    if constexpr (kCount) w.groups += groups_of_8(lf.x, lf.y);
    if (scan<kCount, kLeafAabb>(tb.tris, tb.groups, lf.x, lf.y, w.r, kAny,
                                w.excl, w.best_idx, w.best_t, w.tests))
      return true;
  }
  return false;
}

// The scans of a leaf round shared by the warp (kLeafAabb 0, full scan).
// Each lane's scan list is its right child's range (if it overlapped),
// then its left child's: positions [0, total).  A round of the loop
// below tests, for every lane with work left, its next positions: one
// (its own, on its own lane) while more than 16 lanes have work; else
// q = 2, 4, .. 32 of them, on q lanes of an aligned group given to it
// (its rank among the busy lanes), which then reduce their results
// together.  Nothing of a ray's arithmetic or rule moves: each test is
// moller_trumbore with the ray's own best_t; a round takes, of its
// accepted positions, the least t and, among equal t, the first
// position (closest-hit; strict t < best_t, so an equal t later in the
// list never replaces), or the first position (any-hit, which ends the
// scan there): what testing the positions one by one gives.  The tests
// counter counts what the one-by-one scan would have tested (the whole
// list, or up to the any-hit), not the tests past an any-hit that a
// group round also made.  True when an any-hit ray is resolved.  Every
// lane of the warp calls it; lanes without a scan pass l_over = r_over =
// false.  The probes (kLeafMode 1, 2) make the round with every list
// empty; "noscan" still counts the groups it would have entered.
template <bool kAny, bool kCount, int kLeafMode>
__device__ __forceinline__ bool shared_scans(const float4* __restrict__ tris,
                                             Lane& w, int4 lf, bool l_over,
                                             bool r_over) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int len_a = kLeafMode == 0 && r_over ? lf.w - lf.z : 0;
  const int total = len_a + (kLeafMode == 0 && l_over ? lf.y - lf.x : 0);
  int next = 0;
  bool resolved = false;
  for (;;) {
    const unsigned busy = __ballot_sync(kFull, next < total && !resolved);
    if (busy == 0) break;
    const int n_busy = __popc(busy);
    if (n_busy > 16) {
      if (next < total && !resolved) {
        const int slot = next < len_a ? lf.z + next : lf.x + (next - len_a);
        float t;
        const bool ok = moller_trumbore(tris, slot, w.r, t) && t < w.best_t;
        if (kAny && ok && slot != w.excl) {
          w.best_idx = slot;
          w.best_t = -CUDART_INF_F;
          resolved = true;
        } else if (!kAny && ok) {
          w.best_idx = slot;
          w.best_t = t;
        }
        ++next;
      }
      continue;
    }
    // q = 32 >> ceil(log2(n_busy)) lanes for each busy lane.
    const int shift = 5 - (32 - __clz(n_busy - 1));
    const int q = 1 << shift;
    const int group = lane >> shift;
    const int owner = group < n_busy ? __fns(busy, 0, group + 1) : lane;
    Ray r;
    r.ox = __shfl_sync(kFull, w.r.ox, owner);
    r.oy = __shfl_sync(kFull, w.r.oy, owner);
    r.oz = __shfl_sync(kFull, w.r.oz, owner);
    r.dx = __shfl_sync(kFull, w.r.dx, owner);
    r.dy = __shfl_sync(kFull, w.r.dy, owner);
    r.dz = __shfl_sync(kFull, w.r.dz, owner);
    const float o_best = __shfl_sync(kFull, w.best_t, owner);
    const int o_excl = kAny ? __shfl_sync(kFull, w.excl, owner) : -1;
    const int o_next = __shfl_sync(kFull, next, owner);
    const int o_total = __shfl_sync(kFull, total, owner);
    const int o_len_a = __shfl_sync(kFull, len_a, owner);
    const int o_a = __shfl_sync(kFull, lf.z, owner);
    const int o_b = __shfl_sync(kFull, lf.x, owner);
    const int pos = o_next + (lane & (q - 1));
    float t = CUDART_INF_F;
    int at = 0x7fffffff;  // the position of an accepted test, else max
    if (group < n_busy && pos < o_total) {
      const int slot = pos < o_len_a ? o_a + pos : o_b + (pos - o_len_a);
      float tt;
      if (moller_trumbore(tris, slot, r, tt) && tt < o_best &&
          (!kAny || slot != o_excl)) {
        t = tt;
        at = pos;
      }
    }
    // The group's least (t, position), or least position (any-hit).
    for (int s = 1; s < q; s <<= 1) {
      const float t2 = __shfl_xor_sync(kFull, t, s);
      const int at2 = __shfl_xor_sync(kFull, at, s);
      const bool take = kAny ? at2 < at : (t2 < t || (t2 == t && at2 < at));
      t = take ? t2 : t;
      at = take ? at2 : at;
    }
    const int lead = __popc(busy & below) << shift;
    t = __shfl_sync(kFull, t, lead);
    at = __shfl_sync(kFull, at, lead);
    if ((busy >> lane) & 1u) {
      if (at != 0x7fffffff) {
        const int slot = at < len_a ? lf.z + at : lf.x + (at - len_a);
        w.best_idx = slot;
        w.best_t = kAny ? -CUDART_INF_F : t;
        if (kAny) {
          resolved = true;
          next = at + 1;
        }
      }
      if (!resolved) next = min(next + q, total);
    }
  }
  if constexpr (kCount && kLeafMode != 2) {
    w.tests += resolved ? next : total;
    if (r_over) w.groups += groups_of_8(lf.z, lf.w);
    // An any-hit ray resolved in the right child never enters the left.
    if (l_over && !(resolved && next <= len_a))
      w.groups += groups_of_8(lf.x, lf.y);
  }
  return resolved;
}

// The warp's run of rays: [next, end) are not taken yet; drained once the
// work counter has none left.
struct Run {
  int next = 0, end = 0;
  bool drained = false;
};

// Once kRefillAt lanes are without a ray, they take the next ones of the
// run, in lane order; a spent run is followed by the next 32 rays of the
// work counter.  Every lane of the warp calls it.
template <bool kAny>
__device__ __forceinline__ void refill(Lane& w, Run& run,
                                       int* __restrict__ next_ray, int n,
                                       const Rays& io) {
  const int lane = threadIdx.x & 31;
  unsigned idle = __ballot_sync(kFull, w.ray < 0);
  if (__popc(idle) < kRefillAt) return;
  while (idle && !run.drained) {
    if (run.next == run.end) {
      int base = 0;
      if (lane == 0) base = atomicAdd(next_ray, 32);
      base = __shfl_sync(kFull, base, 0);
      if (base >= n) {
        run.drained = true;
        break;
      }
      run.next = base;
      run.end = min(base + 32, n);
    }
    const int rank = __popc(idle & ((1u << lane) - 1u));
    if (((idle >> lane) & 1u) && rank < run.end - run.next)
      start<kAny>(w, run.next + rank, io);
    run.next = min(run.next + __popc(idle), run.end);
    idle = __ballot_sync(kFull, w.ray < 0);
  }
}

template <bool kAny, bool kCount, bool kSign, int kLeafAabb, int kLeafMode>
__global__ void __launch_bounds__(kThreads)
bvh_traverse_walk(Tables tb, Rays io, int* __restrict__ next_ray, int n,
                  int depth) {
  extern __shared__ int stack_columns[];
  int* const stack = stack_columns + threadIdx.x;
  Lane w;
  w.ray = -1;
  Run run;
  for (;;) {
    refill<kAny>(w, run, next_ray, n, io);
    if (!__any_sync(kFull, w.ray >= 0)) break;
    // The walk: interior visits, and leaf-parent visits that scan nothing,
    // until the lane's next step is a scan (it waits there for the rest
    // of the warp) or its ray ends.
    int4 lf = make_int4(0, 0, 0, 0);
    bool l_over = false, r_over = false, waits = false;
    while (w.ray >= 0 && !waits) {
      if (w.ndep != depth - 1) {
        if (!interior<kCount, kSign>(tb, w, stack, depth))
          finish<kCount>(w, io);
        continue;
      }
      leaf_boxes<kCount, kLeafMode>(tb, w, lf, l_over, r_over);
      waits = l_over || r_over;
      if (!waits && !pop(w, stack)) finish<kCount>(w, io);
    }
    __syncwarp();
    // The scans, made by the waiting lanes together: shared across the
    // warp for the full scan of kLeafAabb 0 (and the probes' empty one),
    // else each lane's own.
    bool resolved = false;
    if constexpr (kLeafAabb == 0) {
      resolved = shared_scans<kAny, kCount, kLeafMode>(
          tb.tris, w, lf, l_over && waits, r_over && waits);
    } else if (waits) {
      resolved = own_scans<kAny, kCount, kLeafAabb>(tb, w, lf, l_over,
                                                    r_over);
    }
    if (waits && (resolved || !pop(w, stack))) finish<kCount>(w, io);
  }
}

using Kernel = void (*)(Tables, Rays, int*, int, int);

// The leaf variants a launch can ask for: the full scan with leaf_aabb 0,
// 1 or 2, then the two probes (which make no tests, so have no box mode).
#define LEAF_VARIANTS(A, C, S)                                            \
  {                                                                       \
    &bvh_traverse_walk<A, C, S, 0, 0>, &bvh_traverse_walk<A, C, S, 1, 0>, \
        &bvh_traverse_walk<A, C, S, 2, 0>,                                \
        &bvh_traverse_walk<A, C, S, 0, 1>, &bvh_traverse_walk<A, C, S, 0, 2> \
  }
#define SIGN_VARIANTS(A, C) \
  { LEAF_VARIANTS(A, C, false), LEAF_VARIANTS(A, C, true) }

// kKernels[any_hit][count_steps][sign_order][leaf variant]
const Kernel kKernels[2][2][2][5] = {
    {SIGN_VARIANTS(false, false), SIGN_VARIANTS(false, true)},
    {SIGN_VARIANTS(true, false), SIGN_VARIANTS(true, true)}};

Kernel pick(int any_hit, int count_steps, int sign_order, int leaf_aabb,
            int leaf_mode) {
  if (leaf_aabb < 0 || leaf_aabb > 2 || leaf_mode < 0 || leaf_mode > 2)
    return nullptr;
  const int variant = leaf_mode == 0 ? leaf_aabb : 2 + leaf_mode;
  return kKernels[any_hit ? 1 : 0][count_steps ? 1 : 0][sign_order ? 1 : 0]
                 [variant];
}

// Dynamic shared memory of a block: its threads' stacks.
size_t stack_bytes(int depth) {
  return static_cast<size_t>(depth > 2 ? depth - 1 : 1) * kThreads *
         sizeof(int);
}

}  // namespace

extern "C" {

// The blocks of the variant that fit on one SM together at this depth,
// into *blocks; returns the cudaError_t of the query.  A probe (leaf_mode
// 1, 2) answers for the full scan it probes, whose grid it is launched on:
// with fewer registers more of its blocks would fit, and the probe would
// then time another occupancy.
int bvh_traverse_blocks_per_sm(int any_hit, int count_steps, int sign_order,
                               int leaf_aabb, int leaf_mode, int depth,
                               int* blocks) {
  if (leaf_mode < 0 || leaf_mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = pick(any_hit, count_steps, sign_order,
                             leaf_mode == 0 ? leaf_aabb : 0, 0);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, stack_bytes(depth)));
}

int bvh_traverse_threads() { return kThreads; }

// The dynamic shared memory of one block at this depth (its threads'
// stacks), in bytes.
int bvh_traverse_stack_bytes(int depth) {
  return static_cast<int>(stack_bytes(depth));
}

// (node << 5) | depth in an int: nodes below 2^26, so depth <= 25.
int bvh_traverse_max_depth() { return 25; }

// All pointers are device pointers.  exclude and t_max may be null when
// any_hit == 0, order_code when sign_order == 0, groups (the box table of
// the leaf_aabb mode asked for) when leaf_aabb == 0 or leaf_mode != 0,
// out_counts when count_steps == 0.  leaf_mode: 0 full, 1 noscan, 2 skip.
// next_ray: one int of device memory, the work counter, which this call
// zeroes on the stream before the launch; grid: the
// blocks of the persistent grid (bvh_traverse_blocks_per_sm x the SMs, or
// fewer for few rays).  Launches on `stream` and returns the cudaError_t
// of the launch (0 on success; cudaErrorInvalidValue for a variant that
// does not exist, a depth outside [1, bvh_traverse_max_depth()] or a grid
// < 1).
int bvh_traverse(const void* boxes, const void* leaves, const void* tris,
                 const void* order_code, const void* groups, const void* ray_o,
                 const void* ray_d, const void* exclude, const void* t_max,
                 void* out_idx, void* out_t, void* out_counts, void* next_ray,
                 int n, int depth, int any_hit, int count_steps,
                 int sign_order, int leaf_aabb, int leaf_mode, int grid,
                 void* stream) {
  const Kernel kernel =
      pick(any_hit, count_steps, sign_order, leaf_aabb, leaf_mode);
  if (kernel == nullptr || depth < 1 || depth > bvh_traverse_max_depth() ||
      grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const cudaError_t zeroed = cudaMemsetAsync(
      next_ray, 0, sizeof(int), static_cast<cudaStream_t>(stream));
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const Tables tb{static_cast<const float4*>(boxes),
                  static_cast<const int4*>(leaves),
                  static_cast<const float4*>(tris),
                  static_cast<const int*>(order_code),
                  static_cast<const float4*>(groups)};
  const Rays io{static_cast<const float*>(ray_o),
                static_cast<const float*>(ray_d),
                static_cast<const int*>(exclude),
                static_cast<const float*>(t_max),
                static_cast<int*>(out_idx),
                static_cast<float*>(out_t),
                static_cast<int4*>(out_counts)};
  kernel<<<grid, kThreads, stack_bytes(depth),
           static_cast<cudaStream_t>(stream)>>>(
      tb, io, static_cast<int*>(next_ray), n, depth);
  return static_cast<int>(cudaGetLastError());
}

const char* bvh_traverse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
