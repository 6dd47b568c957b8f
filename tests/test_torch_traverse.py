"""PyTorch port, traversal: the plain version of the CUDA kernel (what
``traverse`` runs on a CPU tensor) against the JAX package's Pallas
kernel, run in interpret mode on the same numpy rays and tables: in VMEM
residency, and in stream residency (``stream=True``, the tri table in
HBM with one DMA per leaf-parent visit), whose hits the same kernel
serves on the card.

Ids must be equal except on equal-t ties (a per-ray walk and the TPU's
4096-ray packets may visit tied tris in another order).  t agrees to
rtol 2e-6 on hits, not 1e-6: the port rounds every op, as the CUDA
kernel built with --fmad=false does, while XLA's CPU backend contracts
a*b+c into one FMA in the interpreted kernel; on grazing heightfield
rays that alone moved t by up to 1.03e-6 relative.  The any-hit
occlusion flag must be equal on every ray.

The same holds for the kernel's variants (``order="sign"``,
``leaf_aabb`` 1 and 2, the ``leaf_mode`` probes), each against the
Pallas kernel under the same flag; ``leaf_aabb`` must be a pure cull;
and the ``count_steps`` counters must equal the Pallas kernel's where
the two count the same thing: a tile filled with copies of one ray makes
the TPU kernel's per-tile node visits, leaf-parent visits and leaf rows
that ray's own.

The frontier-K walk (``traverse(..., frontier=K)``, on the CPU
``traverse_frontier_plain``) is held the same way to
``traverse_pallas(frontier=K, interpret=True)``, K = 2 and 4, in both
residencies, closest-hit and any-hit, and its closest-hit counters to the
Pallas kernel's on a one-ray tile.  Any-hit counters are compared with
nothing here: a one-ray tile of the TPU kernel goes on popping after the
ray is resolved, a ray of the port stops.

``traverse_v1`` (the kernel's first version, the sweep's "binary-v1") is on
the CPU the same plain walk, held to the Pallas kernel the same way; the
persistent grid's shape and the work counter are checked as host-side
pure functions, and the plain walk at the ray counts whose hand-out
the card checks (a short last run of 32, a single ray).
"""

import torch_threads  # noqa: F401  (first: torch's threads a worker)

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from elevenrender_tpu.ops.bvh import brute_force as jax_brute_force
from elevenrender_tpu.ops.bvh import build_bvh as jax_build_bvh
from elevenrender_tpu.ops.bvh_pallas import (pack_bvh_for_pallas,
                                             traverse_pallas)
from elevenrender_tpu_torch import sweep_traverse as sweep
from elevenrender_tpu_torch.convert import ir_from_numpy
from elevenrender_tpu_torch.ops import traverse as tt

from scenes import heightfield_scene, textured_heightfield_scene
from test_pallas import random_scene


def _random_case():
    tris, o, d = random_scene(300, 1500, seed=0)
    bvh = jax_build_bvh(tris, use_native=False)
    st = tris[bvh["perm"]]
    nodes, leaf, tris9 = pack_bvh_for_pallas(bvh, st)
    tables = {k: torch.tensor(v) for k, v in tt.pack_tables(
        bvh["node_bmin"], bvh["node_bmax"], bvh["node_from"],
        bvh["node_to"], st, bvh["depth"]).items()}
    return dict(packed=(nodes, leaf, tris9), depth=bvh["depth"],
                max_leaf=bvh["max_leaf"], tables=tables, verts=st,
                o=np.asarray(o), d=np.asarray(d))


def _heightfield_case(textured=False):
    if textured:
        # Config 5's scene in miniature, with a tree two levels deeper
        # than the automatic depth (6): smaller leaves, more DMA bursts.
        _, config, ir = textured_heightfield_scene(grid=24, res=16,
                                                   bvh_depth=8)
        assert config.bvh_depth == 8
    else:
        _, config, ir = heightfield_scene(grid=24, res=16, compat=False)
    cfg, tir = ir_from_numpy(dataclasses.asdict(config),
                             jax.tree.map(np.asarray, ir), device="cpu")
    rng = np.random.default_rng(3)
    n = 2000
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.3, 2.0, n)
    o[:200] = [0.0, 1.5, -4.0]  # camera-like rays share one origin
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[:, 1] -= 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    bp = ir["bvh_packed"]
    return dict(packed=(bp["nodes"], bp["leaf"], bp["tris9"]),
                depth=cfg.bvh_depth, max_leaf=cfg.bvh_max_leaf,
                tables=tir["kernel"], verts=np.asarray(ir["tris"]["verts"]),
                o=o, d=d)


_CASES = {"random300": _random_case, "heightfield24": _heightfield_case}
_STREAM_CASES = {"random300": _random_case,
                 "textured24_depth8": lambda: _heightfield_case(True)}


def _jax_case(c, stream):
    c["stream"] = stream
    c["jax"] = traverse_pallas(*c["packed"], jnp.asarray(c["o"]),
                               jnp.asarray(c["d"]), depth=c["depth"],
                               max_leaf=c["max_leaf"], interpret=True,
                               stream=stream)
    return c


@pytest.fixture(scope="module", params=sorted(_CASES))
def case(request):
    return _jax_case(_CASES[request.param](), stream=False)


@pytest.fixture(scope="module", params=sorted(_STREAM_CASES))
def stream_case(request):
    return _jax_case(_STREAM_CASES[request.param](), stream=True)


def _tri_t(tables, ids, o, d):
    """t of each ray against one given tri, by the kernel's arithmetic."""
    _, t = tt._mt(tables["tris"][torch.as_tensor(ids).long()],
                  torch.tensor(o), torch.tensor(d))
    return t.numpy()


def test_closest_hit_matches_jax_pallas(case):
    _check_closest(case)


def test_stream_closest_hit_matches_jax_pallas(stream_case):
    _check_closest(stream_case)


@pytest.mark.parametrize("t_max_kind", ["inf", "mixed"])
def test_any_hit_flag_matches_jax_pallas(case, t_max_kind):
    _check_any_hit(case, t_max_kind)


def test_stream_any_hit_flag_matches_jax_pallas(stream_case):
    _check_any_hit(stream_case, "mixed")


def _check_closest(case):
    ji, jt = (np.asarray(a) for a in case["jax"])
    ti, tt_ = tt.traverse_plain(case["tables"], torch.tensor(case["o"]),
                                torch.tensor(case["d"]), case["depth"])
    ti, tt_ = ti.numpy(), tt_.numpy()
    assert (ji >= 0).sum() > 100
    np.testing.assert_array_equal(ti >= 0, ji >= 0)
    diff = np.nonzero(ti != ji)[0]
    # Any id mismatch must be an equal-t tie: the JAX-chosen tri gives
    # the same t within 1e-6 relative.
    if diff.size:
        t_alt = _tri_t(case["tables"], ji[diff], case["o"][diff],
                       case["d"][diff])
        np.testing.assert_allclose(t_alt, tt_[diff], rtol=1e-6)
    hit = ji >= 0
    np.testing.assert_allclose(tt_[hit], jt[hit], rtol=2e-6)


def _check_any_hit(case, t_max_kind):
    n = case["o"].shape[0]
    rng = np.random.default_rng(5)
    closest = np.asarray(case["jax"][0]).astype(np.int32)
    # Exclude each ray's own closest hit (a shadow ray's source tri) on
    # most rays, nothing on the rest.
    exclude = np.where(rng.uniform(size=n) < 0.8, closest, -1).astype(
        np.int32)
    t_max = np.full(n, np.inf, np.float32)
    if t_max_kind == "mixed":
        t_max = np.where(rng.uniform(size=n) < 0.5, t_max,
                         rng.uniform(0.05, 4.0, n)).astype(np.float32)
    ji, _ = traverse_pallas(*case["packed"], jnp.asarray(case["o"]),
                            jnp.asarray(case["d"]), depth=case["depth"],
                            max_leaf=case["max_leaf"], interpret=True,
                            stream=case["stream"],
                            exclude=jnp.asarray(exclude),
                            t_max=jnp.asarray(t_max))
    ti, tt_ = tt.traverse_plain(case["tables"], torch.tensor(case["o"]),
                                torch.tensor(case["d"]), case["depth"],
                                torch.tensor(exclude), torch.tensor(t_max))
    flag = np.asarray(ji) >= 0
    assert 0 < flag.sum() < n
    np.testing.assert_array_equal(ti.numpy() >= 0, flag)
    assert np.all(tt_.numpy()[flag] == -np.inf)
    # Every reported occluder is a real one: not excluded, in range.
    ids = ti.numpy()[flag]
    assert np.all(ids != exclude[flag])
    t_occ = _tri_t(case["tables"], ids, case["o"][flag], case["d"][flag])
    assert np.all((t_occ >= 0) & (t_occ < t_max[flag]))


def test_counters_and_dispatch(case):
    """traverse() on CPU tensors is the plain version and launches no
    kernel; the counters see every ray and leave the results alone."""
    tt.reset_counts()
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    i1, t1 = tt.traverse(case["tables"], o, d, case["depth"])
    i2, t2, cnt = tt.traverse(case["tables"], o, d, case["depth"],
                              count_steps=True)
    assert tt.launches == 0 and tt.any_hit_launches == 0
    assert not tt.variant_launches
    assert torch.equal(i1, i2) and torch.equal(t1, t2)
    assert cnt.shape == (o.shape[0], 4) and cnt.dtype == torch.int32
    visits, leaf_visits, groups, tests = cnt.unbind(1)
    assert int(visits.min()) >= 1
    assert bool((leaf_visits <= visits).all())
    assert bool((groups >= leaf_visits).all())
    assert int(tests[i2 >= 0].min()) >= 1
    assert bool((tests <= 8 * groups).all())


_VARIANTS = [("sign", 0), ("near", 1), ("near", 2), ("sign", 1)]


def _jax_variant(c, **kw):
    return traverse_pallas(*c["packed"], jnp.asarray(c["o"]),
                           jnp.asarray(c["d"]), depth=c["depth"],
                           max_leaf=c["max_leaf"], interpret=True,
                           stream=c["stream"], **kw)


def _any_hit_inputs(c):
    n = c["o"].shape[0]
    rng = np.random.default_rng(5)
    closest = np.asarray(c["jax"][0]).astype(np.int32)
    exclude = np.where(rng.uniform(size=n) < 0.8, closest, -1).astype(
        np.int32)
    t_max = np.where(rng.uniform(size=n) < 0.5, np.inf,
                     rng.uniform(0.05, 4.0, n)).astype(np.float32)
    return exclude, t_max


def _check_variant(c, order, leaf_aabb):
    """The plain version under (order, leaf_aabb) against the Pallas
    kernel under the same flags: closest-hit ids up to ties and t to
    2e-6, the any-hit flag on every ray."""
    o, d = torch.tensor(c["o"]), torch.tensor(c["d"])
    ji, jt = (np.asarray(a) for a in _jax_variant(
        c, order=order, leaf_aabb=leaf_aabb))
    ti, tt_ = (a.numpy() for a in tt.traverse(
        c["tables"], o, d, c["depth"], order=order, leaf_aabb=leaf_aabb))
    np.testing.assert_array_equal(ti >= 0, ji >= 0)
    diff = np.nonzero(ti != ji)[0]
    if diff.size:
        t_alt = _tri_t(c["tables"], ji[diff], c["o"][diff], c["d"][diff])
        np.testing.assert_allclose(t_alt, tt_[diff], rtol=1e-6)
    hit = ji >= 0
    np.testing.assert_allclose(tt_[hit], jt[hit], rtol=2e-6)
    exclude, t_max = _any_hit_inputs(c)
    ja, _ = _jax_variant(c, order=order, leaf_aabb=leaf_aabb,
                         exclude=jnp.asarray(exclude),
                         t_max=jnp.asarray(t_max))
    ta, _ = tt.traverse(c["tables"], o, d, c["depth"], torch.tensor(exclude),
                        torch.tensor(t_max), order=order,
                        leaf_aabb=leaf_aabb)
    flag = np.asarray(ja) >= 0
    assert 0 < flag.sum() < flag.size
    np.testing.assert_array_equal(ta.numpy() >= 0, flag)


@pytest.mark.parametrize("order,leaf_aabb", _VARIANTS)
def test_variants_match_jax_pallas(case, order, leaf_aabb):
    _check_variant(case, order, leaf_aabb)


def test_stream_variant_matches_jax_pallas(stream_case):
    _check_variant(stream_case, "sign", 2)


@pytest.mark.parametrize("order", tt.ORDERS)
def test_leaf_aabb_is_a_pure_cull(case, order):
    """leaf_aabb 1 and 2 give exactly the ids and t of 0, in closest-hit
    and in any-hit mode, visit what 0 visits, and test fewer tris."""
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    exclude, t_max = map(torch.tensor, _any_hit_inputs(case))
    for query in ((), (exclude, t_max)):
        i0, t0, c0 = tt.traverse_plain(case["tables"], o, d, case["depth"],
                                       *query, order=order, count_steps=True)
        for leaf_aabb in (1, 2):
            i1, t1, c1 = tt.traverse_plain(
                case["tables"], o, d, case["depth"], *query, order=order,
                leaf_aabb=leaf_aabb, count_steps=True)
            assert torch.equal(i0, i1) and torch.equal(t0, t1)
            assert torch.equal(c0[:, :3], c1[:, :3])
            assert bool((c1[:, 3] <= c0[:, 3]).all())
            assert int(c1[:, 3].sum()) < int(c0[:, 3].sum())


def test_sign_order_gives_the_near_order_hits(case):
    """The two orders find the same hits, equal-t ties apart (they may
    visit other nodes on the way)."""
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    i0, t0, c0 = tt.traverse_plain(case["tables"], o, d, case["depth"],
                                   count_steps=True)
    i1, t1, c1 = tt.traverse_plain(case["tables"], o, d, case["depth"],
                                   order="sign", count_steps=True)
    assert torch.equal(t0, t1)
    diff = (i0 != i1).nonzero()[:, 0].numpy()
    if diff.size:
        t_alt = _tri_t(case["tables"], i1.numpy()[diff], case["o"][diff],
                       case["d"][diff])
        np.testing.assert_allclose(t_alt, t0.numpy()[diff], rtol=1e-6)
    assert torch.equal(c0[:, 0] >= 1, c1[:, 0] >= 1)


@pytest.mark.parametrize("order,leaf_aabb", [("near", 0), ("sign", 1)])
def test_counters_match_jax_count_steps(case, order, leaf_aabb):
    """A tile of 1024 copies of one ray: the Pallas kernel's per-tile
    node visits (row 0), leaf rows (row 1) and leaf-parent visits (row 2)
    are that ray's, and equal the plain version's visits, 8-aligned
    groups and leaf-parent visits.  The fourth counter differs by
    design: the TPU kernel tests all 8 slots of a row, the per-ray walk
    only those of the leaf."""
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    _, _, cnt = tt.traverse_plain(case["tables"], o, d, case["depth"],
                                  order=order, leaf_aabb=leaf_aabb,
                                  count_steps=True)
    busiest = int(cnt[:, 0].argmax())
    assert int(cnt[busiest, 1]) >= 2
    tile = dict(case, o=np.repeat(case["o"][busiest:busiest + 1], 1024, 0),
                d=np.repeat(case["d"][busiest:busiest + 1], 1024, 0))
    _, _, jc = _jax_variant(tile, order=order, leaf_aabb=leaf_aabb, sub=8,
                            count_steps=True)
    jc = np.asarray(jc)
    assert jc.shape == (1, 4)
    visits, leaf_visits, groups, tests = cnt[busiest].tolist()
    assert (visits, groups, leaf_visits) == tuple(jc[0, :3])
    assert tests <= jc[0, 3]


@pytest.mark.parametrize("leaf_mode", ["noscan", "skip"])
def test_probes_match_jax_pallas(case, leaf_mode):
    """The timing probes miss every ray, as the Pallas kernel's do, and
    walk what it walks (one ray against a tile of its copies)."""
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    ti, tt_, cnt = tt.traverse(case["tables"], o, d, case["depth"],
                               leaf_mode=leaf_mode, count_steps=True)
    ji, jt = _jax_variant(case, leaf_mode=leaf_mode)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(jt))
    assert bool((ti == -1).all()) and bool(torch.isinf(tt_).all())
    assert int(cnt[:, 3].sum()) == 0
    assert (int(cnt[:, 1].sum()) == 0) == (leaf_mode == "skip")
    busiest = int(cnt[:, 0].argmax())
    tile = dict(case, o=np.repeat(case["o"][busiest:busiest + 1], 1024, 0),
                d=np.repeat(case["d"][busiest:busiest + 1], 1024, 0))
    _, _, jc = _jax_variant(tile, leaf_mode=leaf_mode, sub=8,
                            count_steps=True)
    visits, leaf_visits, groups, _ = cnt[busiest].tolist()
    assert (visits, groups, leaf_visits) == tuple(np.asarray(jc)[0, :3])


def test_ordering_codes_equal_the_pallas_lane_12(case):
    """pack_tables' ``order`` table holds, for every interior node, the
    code pack_bvh_for_pallas writes into lane 12 of the node's entry."""
    nodes = np.asarray(case["packed"][0])
    codes = nodes.reshape(-1, 8, 16)[:, :, 12].reshape(-1)
    order = case["tables"]["order"].numpy()
    depth = case["depth"]
    from elevenrender_tpu_torch.ops.bvh import preorder_indices
    interior = np.concatenate([preorder_indices(depth)[k]
                               for k in range(depth)])
    assert interior.size == (1 << depth) - 1
    np.testing.assert_array_equal(order[interior],
                                  codes[interior].astype(np.int32))
    assert set(np.unique(order[interior])) <= set(range(6))
    assert len(np.unique(order[interior])) >= 2


def test_group_boxes_hold_their_tris(case):
    tables = case["tables"]
    tris = tables["tris"].numpy()
    corners = np.stack([tris[:, 0:3], tris[:, 0:3] + tris[:, 4:7],
                        tris[:, 0:3] + tris[:, 8:11]], axis=1)
    for name, size in (("groups8", 8), ("groups4", 4)):
        box = tables[name].numpy()
        assert box.shape == (-(-tris.shape[0] // size), 8)
        g = np.arange(tris.shape[0]) // size
        assert (corners.min(axis=1) >= box[g, 0:3]).all()
        assert (corners.max(axis=1) <= box[g, 4:7]).all()


@pytest.mark.parametrize("bad", [dict(order="far"), dict(leaf_aabb=3),
                                 dict(leaf_mode="fast")])
def test_unknown_variant_raises(case, bad):
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    for fn in (tt.traverse, tt.traverse_plain):
        with pytest.raises(ValueError):
            fn(case["tables"], o, d, case["depth"], **bad)
    with pytest.raises(ValueError):
        tt._launch(case["tables"], o, d, case["depth"], None, None, **bad)


def _check_frontier(c, frontier):
    """The plain frontier walk against the Pallas frontier kernel:
    closest-hit ids up to equal-t ties and t to 2e-6, the any-hit flag on
    every ray; and against the port's own binary walk: t bit-equal."""
    o, d = torch.tensor(c["o"]), torch.tensor(c["d"])
    ji, jt = (np.asarray(a) for a in _jax_variant(c, frontier=frontier,
                                                  sub=8))
    tt.reset_counts()
    ti, tt_ = tt.traverse(c["tables"], o, d, c["depth"], frontier=frontier)
    assert tt.frontier_launches == 0 and not tt.variant_launches
    assert tt.frontier_stack["refused"] == 0
    assert 1 <= tt.frontier_stack["deepest"] < tt.frontier_stack_rows(
        frontier, c["depth"])
    bi, bt = tt.traverse_plain(c["tables"], o, d, c["depth"])
    assert torch.equal(tt_, bt)
    ti, tt_ = ti.numpy(), tt_.numpy()
    assert (ji >= 0).sum() > 100
    np.testing.assert_array_equal(ti >= 0, ji >= 0)
    diff = np.nonzero(ti != ji)[0]
    if diff.size:
        t_alt = _tri_t(c["tables"], ji[diff], c["o"][diff], c["d"][diff])
        np.testing.assert_allclose(t_alt, tt_[diff], rtol=1e-6)
    hit = ji >= 0
    np.testing.assert_allclose(tt_[hit], jt[hit], rtol=2e-6)
    exclude, t_max = _any_hit_inputs(c)
    ja, _ = _jax_variant(c, frontier=frontier, sub=8,
                         exclude=jnp.asarray(exclude),
                         t_max=jnp.asarray(t_max))
    ta, tat = tt.traverse(c["tables"], o, d, c["depth"],
                          torch.tensor(exclude), torch.tensor(t_max),
                          frontier=frontier)
    flag = np.asarray(ja) >= 0
    assert 0 < flag.sum() < flag.size
    np.testing.assert_array_equal(ta.numpy() >= 0, flag)
    assert np.all(tat.numpy()[flag] == -np.inf)
    np.testing.assert_array_equal(tat.numpy()[~flag], t_max[~flag])
    ids = ta.numpy()[flag]
    assert np.all(ids != exclude[flag])
    t_occ = _tri_t(c["tables"], ids, c["o"][flag], c["d"][flag])
    assert np.all((t_occ >= 0) & (t_occ < t_max[flag]))


@pytest.mark.parametrize("frontier", [2, 4])
def test_frontier_matches_jax_pallas(case, frontier):
    _check_frontier(case, frontier)


@pytest.mark.parametrize("frontier", [2, 4])
def test_stream_frontier_matches_jax_pallas(stream_case, frontier):
    _check_frontier(stream_case, frontier)


@pytest.mark.parametrize("frontier", [2, 4])
def test_frontier_counters_match_jax_count_steps(case, frontier):
    """A tile of 1024 copies of one ray: the Pallas frontier kernel's
    per-tile node visits (column 0), leaf rows (1) and leaf-parent visits
    (2) are that ray's, and equal the plain version's visits, 8-aligned
    groups and leaf-parent visits; its fourth column is 0.  The frontier
    visits at least what the binary walk visits (a weaker prune)."""
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    i1, t1 = tt.traverse_frontier_plain(case["tables"], o, d, case["depth"],
                                        frontier)
    i2, t2, cnt = tt.traverse_frontier_plain(case["tables"], o, d,
                                             case["depth"], frontier,
                                             count_steps=True)
    assert torch.equal(i1, i2) and torch.equal(t1, t2)
    assert cnt.shape == (o.shape[0], 4) and cnt.dtype == torch.int32
    _, _, binary = tt.traverse_plain(case["tables"], o, d, case["depth"],
                                     count_steps=True)
    assert int(cnt[:, 0].sum()) >= int(binary[:, 0].sum())
    assert int(cnt[:, 3].sum()) >= int(binary[:, 3].sum())
    busiest = int(cnt[:, 0].argmax())
    assert int(cnt[busiest, 1]) >= 2
    tile = dict(case, o=np.repeat(case["o"][busiest:busiest + 1], 1024, 0),
                d=np.repeat(case["d"][busiest:busiest + 1], 1024, 0))
    _, _, jc = _jax_variant(tile, frontier=frontier, sub=8, count_steps=True)
    jc = np.asarray(jc)
    assert jc.shape == (1, 4)
    visits, leaf_visits, groups, tests = cnt[busiest].tolist()
    assert (visits, groups, leaf_visits, 0) == tuple(jc[0])
    assert tests >= 1


def test_frontier_refuses_a_push_into_a_full_stack(case, monkeypatch):
    """The stack's capacity is part of the contract the kernel and the
    plain version share (a push needs ``sp < rows - 1``): with one
    row, which the root fills, every push is
    refused and counted, nothing is written out of bounds, and the walk
    ends having tested nothing below the root."""
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    monkeypatch.setattr(tt, "frontier_stack_rows", lambda k, depth: 1)
    idx, t, cnt = tt.traverse_frontier_plain(case["tables"], o, d,
                                             case["depth"], 2,
                                             count_steps=True)
    assert tt.frontier_stack["refused"] > 0
    assert tt.frontier_stack["deepest"] == 1
    assert bool((cnt[:, 0] == 1).all()) and bool((idx == -1).all())


@pytest.mark.parametrize("bad", [0, 9, -1, 2.5])
def test_unknown_frontier_raises(case, bad):
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    with pytest.raises(ValueError, match="frontier"):
        tt.traverse(case["tables"], o, d, case["depth"], frontier=bad)
    with pytest.raises(ValueError, match="frontier"):
        tt._launch_frontier(case["tables"], o, d, case["depth"], bad, None,
                            None)
    with pytest.raises(ValueError, match="depth"):
        tt.traverse(case["tables"], o, d, tt.FRONTIER_MAX_DEPTH + 1,
                    frontier=2)


def test_brute_force_matches_jax(case):
    verts = case["verts"]
    ji, jt = jax_brute_force(jnp.asarray(verts), jnp.asarray(case["o"]),
                             jnp.asarray(case["d"]))
    ti, tt_ = tt.brute_force(torch.tensor(verts), torch.tensor(case["o"]),
                             torch.tensor(case["d"]))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    hit = np.asarray(ji) >= 0
    np.testing.assert_allclose(tt_.numpy()[hit], np.asarray(jt)[hit],
                               rtol=1e-6)


def test_wrapper_refuses_other_devices():
    z = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError):
        tt.traverse({}, z, z, 3)
    with pytest.raises(ValueError):
        tt.traverse({}, torch.zeros((4, 3)), torch.zeros((4, 3)), 3,
                    exclude=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        tt.traverse({}, z, z, 3, frontier=4)


def test_wrapper_refuses_tables_it_cannot_serve(case, monkeypatch):
    """The launch path checks the tables before it loads the kernel: a
    leaf range outside the tri table, or more tris or rays than the
    kernel's 32-bit indexing addresses, raise instead of truncating."""
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    bad = dict(case["tables"])
    bad["leaves"] = bad["leaves"].clone()
    bad["leaves"][bad["leaves"][:, 3].argmax(), 3] += 1
    with pytest.raises(ValueError, match="leaf table"):
        tt._launch(bad, o, d, case["depth"], None, None)
    monkeypatch.setattr(tt, "MAX_ROWS", o.shape[0] - 1)
    with pytest.raises(ValueError, match="32-bit"):
        tt._launch(case["tables"], o, d, case["depth"], None, None)


def test_leaf_range_check_sees_a_new_table_at_a_freed_address():
    """A checked table is dropped and a bad one is made over the same
    memory: the new tensor has the old one's address and ``_version`` 0,
    and must still be checked.  Then an in-place edit of a checked table
    is checked again."""
    arr = np.array([[0, 4, 4, 8]] * 4, np.int32)
    good = torch.from_numpy(arr)
    ptr = good.data_ptr()
    tt._check_leaf_ranges(good, 8)
    del good
    arr[1] = [0, 4, 4, 9]
    bad = torch.from_numpy(arr)
    assert bad.data_ptr() == ptr and bad._version == 0
    with pytest.raises(ValueError, match="leaf table"):
        tt._check_leaf_ranges(bad, 8)
    arr[1] = [0, 4, 4, 8]
    fixed = torch.from_numpy(arr)
    tt._check_leaf_ranges(fixed, 8)
    fixed[2, 3] = 9
    with pytest.raises(ValueError, match="leaf table"):
        tt._check_leaf_ranges(fixed, 8)


def test_v1_walk_on_the_cpu_is_the_plain_walk(case):
    """The first version's wrapper runs ``traverse_plain`` on CPU tensors
    (and launches nothing): the same ids, t and counters as ``traverse``,
    closest-hit and any-hit, and so the Pallas kernel's hits."""
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    exclude, t_max = map(torch.tensor, _any_hit_inputs(case))
    tt.reset_counts()
    for query in ((None, None), (exclude, t_max)):
        got = tt.traverse_v1(case["tables"], o, d, case["depth"], *query,
                             count_steps=True)
        ref = tt.traverse(case["tables"], o, d, case["depth"], *query,
                          count_steps=True)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert tt.v1_launches == 0 and not tt.variant_launches
    ji, jt = (np.asarray(a) for a in case["jax"])
    vi, vt = (a.numpy() for a in tt.traverse_v1(case["tables"], o, d,
                                                case["depth"]))
    np.testing.assert_array_equal(vi >= 0, ji >= 0)
    hit = ji >= 0
    np.testing.assert_allclose(vt[hit], jt[hit], rtol=2e-6)
    with pytest.raises(ValueError, match="together"):
        tt.traverse_v1(case["tables"], o, d, case["depth"], exclude)


@pytest.mark.parametrize("n,sms,blocks,grid", [
    (1 << 20, 132, 9, 132 * 9),   # a full launch: every block that fits
    (1 << 20, 132, 16, 132 * 16),
    (5 * 128, 132, 9, 5),         # few rays: a block per 4 runs of 32
    (5 * 128 + 1, 132, 9, 6),
    (100, 132, 9, 1),
    (0, 132, 9, 1)])
def test_persistent_grid_shape(n, sms, blocks, grid):
    assert tt.persistent_grid(n, sms, blocks) == grid
    assert tt.THREADS == 128 and tt.RUN == 32


def test_persistent_grid_refuses_a_kernel_that_does_not_fit():
    with pytest.raises(ValueError, match="fit"):
        tt.persistent_grid(1024, 132, 0)


def test_work_counter_and_stack_bytes():
    """The work counter is one int32 on the rays' device.  A stack entry
    is (node << 5) | depth in an int32, so the deepest tree the wrapper
    admits fits it.  (A block's stack bytes are the C library's own,
    ``bvh_traverse_stack_bytes``, reported by chip_smoke.py on the card.)"""
    w = tt.work_counter("cpu")
    assert w.shape == (1,) and w.dtype == torch.int32
    assert w.device.type == "cpu"
    nodes = (1 << (tt.MAX_DEPTH + 1)) - 1
    assert (nodes - 1) << 5 | tt.MAX_DEPTH < 2**31


@pytest.mark.parametrize("frontier,tile", [(2, 2), (3, 4), (4, 4), (5, 8),
                                           (6, 8), (7, 8), (8, 8)])
def test_frontier_tile_width(frontier, tile):
    """The frontier-K kernel walks a ray on K lanes rounded up to a power
    of two, so a warp holds whole tiles."""
    assert tt.frontier_tile(frontier) == tile
    assert 32 % tile == 0 and tile >= frontier


@pytest.mark.parametrize("bad", [1, 9])
def test_frontier_tile_width_refuses_other_frontiers(bad):
    with pytest.raises(ValueError, match="frontier"):
        tt.frontier_tile(bad)


@pytest.mark.parametrize("frontier,depth,nbytes", [
    (2, 20, 4 * 640 + 64 * 168 * 4),   # the largest block: 45,568 B
    (3, 11, 4 * 640 + 32 * 140 * 4),
    (4, 11, 4 * 640 + 32 * 184 * 4),   # the main scene's depth
    (4, 15, 4 * 640 + 32 * 248 * 4),   # config 5's depth
    (8, 20, 4 * 640 + 16 * 648 * 4),
    (5, 1, 4 * 640 + 16 * 28 * 4)])
def test_frontier_shared_bytes(frontier, depth, nbytes):
    """A block's shared memory: four warps' scan scratch (a range table of
    64 int32 pairs and 16 keys of 8 bytes), then a stack of 4 K depth + 8
    int32 for each of its 128 / tile tiles."""
    assert tt.FRONTIER_SCRATCH == 640
    assert tt.frontier_shared_bytes(frontier, depth) == nbytes


def test_frontier_shared_bytes_fit_every_depth_the_wrapper_admits():
    """Every (K, depth) the wrapper admits fits a block in the 48 KB that
    needs no opt-in; the first depth past the limit at K = 2 would not,
    and is refused."""
    for k in tt.FRONTIERS:
        for depth in range(1, tt.FRONTIER_MAX_DEPTH + 1):
            assert tt.frontier_shared_bytes(k, depth) <= tt.SHARED_LIMIT
    assert tt.frontier_shared_bytes(2, 21) <= tt.SHARED_LIMIT
    with pytest.raises(ValueError, match="bytes a block"):
        tt.frontier_shared_bytes(2, 22)


@pytest.mark.parametrize("n,sms,blocks,tile,grid", [
    (1 << 20, 132, 7, 4, 132 * 7),   # a full launch: every block that fits
    (1 << 20, 132, 8, 8, 132 * 8),
    (65535, 132, 8, 2, 1024),         # 64 tiles a block, under 132 x 8
    (33, 132, 8, 8, 3),               # 16 tiles a block
    (32 * 5, 132, 7, 4, 5),           # 32 tiles a block
    (32 * 5 + 1, 132, 7, 4, 6),
    (1, 132, 7, 4, 1),
    (0, 132, 7, 4, 1)])
def test_frontier_and_wide_tile_grid_shape(n, sms, blocks, tile, grid):
    """The lane-tile kernels' persistent grid: every block that fits on the
    card, but no more than the rays fill at one ray a tile."""
    assert tt.tile_grid(n, sms, blocks, tile) == grid
    assert tt.THREADS == 128


def test_frontier_and_wide_tile_grid_refuses_a_kernel_that_does_not_fit():
    with pytest.raises(ValueError, match="fit"):
        tt.tile_grid(1024, 132, 0, 4)


@pytest.mark.parametrize("depth", [0, tt.MAX_DEPTH + 1])
def test_launch_refuses_a_depth_the_stack_cannot_hold(case, depth):
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    for launch in (tt._launch, tt._launch_v1):
        with pytest.raises(ValueError, match="depth"):
            launch(case["tables"], o, d, depth, None, None)


@pytest.mark.parametrize("n", [1, 31, 33])
def test_plain_walk_at_ragged_ray_counts(case, n):
    """The walk is a function of each ray: the first n rays alone (a
    single ray, less than a run of 32, one run and one ray) get the rows
    of the whole launch, closest-hit and any-hit, counters included; and
    the Pallas kernel's hits."""
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    exclude, t_max = map(torch.tensor, _any_hit_inputs(case))
    parts = []
    for ex, tm in ((None, None), (exclude, t_max)):
        full = tt.traverse(case["tables"], o, d, case["depth"], ex, tm,
                           count_steps=True)
        part = tt.traverse(case["tables"], o[:n], d[:n], case["depth"],
                           None if ex is None else ex[:n],
                           None if tm is None else tm[:n], count_steps=True)
        for a, b in zip(part, full):
            assert torch.equal(a, b[:n])
        parts.append(part)
    ji = np.asarray(case["jax"][0])[:n]
    np.testing.assert_array_equal(parts[0][0].numpy() >= 0, ji >= 0)


def test_times_in_turns_gives_every_call():
    """The sweep's one timing helper returns each call's time, round by
    round, every function once a round (host clock on the CPU)."""
    calls = []
    times = sweep.times_in_turns({"a": lambda: calls.append("a"),
                                  "b": lambda: calls.append("b")}, 3, False)
    assert calls == ["a", "b"] * 3
    assert {k: len(v) for k, v in times.items()} == {"a": 3, "b": 3}
    assert all(t >= 0 for v in times.values() for t in v)


def test_sweep_holds_binary_v1_to_the_binary_walk_exactly(case):
    """On the CPU the sweep runs binary-v1's plain walk beside the binary
    walk's and holds the two to each other: ids, t and counters equal;
    a single changed counter is refused."""
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    walk = dict(tables=case["tables"], depth=case["depth"])
    rows = sweep.sweep_ray_set(walk, "case", "rays", (o, d, None, None),
                               [sweep.BINARY, sweep.V1], reps=1)
    assert [r["kernel"] for r in rows] == [sweep.BINARY, sweep.V1]
    assert rows[0]["counters"] == rows[1]["counters"]
    assert rows[1]["ties"] == rows[1]["near_ties"] == 0
    ref = tt.traverse(case["tables"], o, d, case["depth"], count_steps=True)
    bad = ref[2].clone()
    bad[0, 3] += 1
    with pytest.raises(RuntimeError, match="counters"):
        sweep.same_walk("case", ref, (ref[0], ref[1], bad))
