"""PyTorch port, the 8-wide collapsed BVH and the traversal sweep.

``experiments/bvh_wide.py`` against the JAX package's module of the same
name on the same numpy BVHs and rays, at depths with D mod 3 = 0, 1 and 2
(a full root, a root of 2 and a root of 4 children):

- ``pack_bvh_wide``'s tables hold the reference's content, box by box and
  range by range (the layout is the port's: [R, 8, 8] and [R_last, 16]
  where the reference has 128-lane rows of 8 x 16 lanes);
- ``traverse_wide_plain`` (what ``traverse_wide`` runs on a CPU tensor)
  against ``traverse_wide(interpret=True)``, VMEM and stream residency:
  ids equal up to equal-t ties; t within 2e-6 relative on at least 99%
  of the hits and within rtol 1e-5 / atol 1e-6, tests/test_pallas.py's own
  tolerance for this kernel, on all of them (XLA's CPU backend contracts
  a*b+c into one FMA in the interpreted kernel, the port rounds every op;
  on these random scenes of fat, often grazing tris a small determinant
  amplifies that: 1 hit of 339 differed by 3.3e-6 relative, and one at
  t = 0.003 by 1.7e-8 absolute, 5e-6 of it); and against the port's own
  binary walk: t bit-equal;
- the ``count_steps`` counters against the Pallas kernel's on a tile
  filled with copies of one ray, where its per-tile counts are that ray's.

Then ``convert.ir_from_numpy(wide=True)``, the wrapper's refusals, and the
sweep entry point end to end on the CPU at grid 12, 32 x 32 rays.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from elevenrender_tpu.experiments import bvh_wide as jw
from elevenrender_tpu.ops.bvh import build_bvh as jax_build_bvh
from elevenrender_tpu.ops.bvh_pallas import pack_bvh_for_pallas
from elevenrender_tpu_torch import sweep_traverse
from elevenrender_tpu_torch.convert import ir_from_numpy
from elevenrender_tpu_torch.experiments import bvh_wide as tw
from elevenrender_tpu_torch.ops import traverse as tt

from scenes import heightfield_scene
from test_pallas import random_scene

# (tris, rays, depth or None for build_bvh's automatic one, seed): tests/
# test_pallas.py's wide cases.  Depths 4, 5 and 6 are D mod 3 = 1, 2, 0.
_CASES = {"auto": (300, 1500, None, 0), "depth4": (500, 2000, 4, 3),
          "depth5": (700, 2000, 5, 5), "depth6": (900, 2000, 6, 1)}


@pytest.fixture(scope="module", params=sorted(_CASES))
def case(request):
    n_tris, n_rays, depth, seed = _CASES[request.param]
    tris, o, d = random_scene(n_tris, n_rays, seed=seed)
    bvh = jax_build_bvh(tris, depth=depth, use_native=False)
    assert bvh["depth"] >= 3
    st = tris[bvh["perm"]]
    _, _, tris9 = pack_bvh_for_pallas(bvh, st)
    tables = {k: torch.tensor(v) for k, v in tt.pack_tables(
        bvh["node_bmin"], bvh["node_bmax"], bvh["node_from"],
        bvh["node_to"], st, bvh["depth"]).items()}
    wide = {k: torch.tensor(v) for k, v in tw.pack_bvh_wide(bvh).items()}
    return dict(bvh=bvh, depth=bvh["depth"], max_leaf=bvh["max_leaf"],
                jax_wide=jw.pack_bvh_wide(bvh), tris9=tris9, tables=tables,
                wide=wide, o=np.asarray(o), d=np.asarray(d))


def _jax_wide(c, o=None, d=None, **kw):
    return jw.traverse_wide(*c["jax_wide"], c["tris9"],
                            jnp.asarray(c["o"] if o is None else o),
                            jnp.asarray(c["d"] if d is None else d),
                            depth=c["depth"], max_leaf=c["max_leaf"],
                            interpret=True, **kw)


def _port_wide(c, **kw):
    return tw.traverse_wide(c["wide"]["nodes8"], c["wide"]["leaf8"],
                            c["tables"]["tris"], torch.tensor(c["o"]),
                            torch.tensor(c["d"]), c["depth"], **kw)


def test_wide_levels_and_offsets_match_jax():
    for depth in range(3, 25):
        levels = tw.wide_levels(depth)
        assert levels == jw.wide_levels(depth)
        off = tw.level_offsets(depth)
        assert off == [sum(1 << d for d in levels[:k])
                       for k in range(len(levels))]
        assert len(off) <= tw.MAX_LEVELS
        assert tw.root_children(depth) == (
            8 if len(levels) == 1 else 1 << levels[1])
    with pytest.raises(ValueError):
        tw.wide_levels(2)


def test_pack_bvh_wide_holds_the_reference_tables(case):
    nodes_j, leaf_j = (np.asarray(a) for a in case["jax_wide"])
    nodes = case["wide"]["nodes8"].numpy()
    leaf = case["wide"]["leaf8"].numpy()
    rows = nodes_j.shape[0]
    assert nodes.shape == (rows, 8, 8) and nodes.dtype == np.float32
    assert leaf.shape == (leaf_j.shape[0], 16) and leaf.dtype == np.int32
    lanes = nodes_j.reshape(rows, 8, 16)
    np.testing.assert_array_equal(nodes[:, :, 0:3], lanes[:, :, 0:3])
    np.testing.assert_array_equal(nodes[:, :, 4:7], lanes[:, :, 3:6])
    ranges = leaf_j.reshape(leaf_j.shape[0], 8, 16)
    np.testing.assert_array_equal(leaf[:, 0::2], ranges[:, :, 0])
    np.testing.assert_array_equal(leaf[:, 1::2], ranges[:, :, 1])
    # A short root pads with far point boxes; every other box is real.
    n_root = tw.root_children(case["depth"])
    assert (nodes[0, n_root:, 0:3] == tw.FAR).all()
    assert (nodes[0, n_root:, 4:7] == tw.FAR).all()
    assert {4: 2, 5: 4, 6: 8}.get(case["depth"], n_root) == n_root
    # The last level's ranges tile the leaf order.
    assert leaf[0, 0] == 0 and leaf[-1, -1] == case["tables"]["tris"].shape[0]
    flat = leaf.reshape(-1)
    np.testing.assert_array_equal(flat[1:-1:2], flat[2::2])


@pytest.mark.parametrize("stream", [False, True])
def test_wide_plain_matches_jax_wide(case, stream):
    ji, jt = (np.asarray(a) for a in _jax_wide(case, stream=stream))
    tt.reset_counts()
    ti, tt_ = _port_wide(case)
    assert tt.wide_launches == 0 and not tt.variant_launches
    bi, bt = tt.traverse_plain(case["tables"], torch.tensor(case["o"]),
                               torch.tensor(case["d"]), case["depth"])
    assert torch.equal(tt_, bt)
    ti, tt_ = ti.numpy(), tt_.numpy()
    assert (ji >= 0).sum() > 100
    np.testing.assert_array_equal(ti >= 0, ji >= 0)
    for other in (ji, bi.numpy()):
        diff = np.nonzero(ti != other)[0]
        if diff.size:  # an equal-t tie: the other tri gives the same t
            _, t_alt = tt._mt(case["tables"]["tris"][
                torch.as_tensor(other[diff]).long()],
                torch.tensor(case["o"][diff]), torch.tensor(case["d"][diff]))
            np.testing.assert_allclose(t_alt.numpy(), tt_[diff], rtol=1e-6)
    hit = ji >= 0
    np.testing.assert_allclose(tt_[hit], jt[hit], rtol=1e-5, atol=1e-6)
    assert np.isclose(tt_[hit], jt[hit], rtol=2e-6, atol=0).mean() >= 0.99


def test_wide_counters_match_jax_count_steps(case):
    """A tile of 1024 copies of one ray: the Pallas kernel's per-tile wide
    visits (column 0), leaf rows (1) and last-level visits that scanned
    (2) are that ray's, and equal the plain version's visits, 8-aligned
    groups and leaf visits.  The wide walk tests the tris of every child
    that passed at the visit's start, so at least the binary walk's."""
    i1, t1 = _port_wide(case)
    i2, t2, cnt = _port_wide(case, count_steps=True)
    assert torch.equal(i1, i2) and torch.equal(t1, t2)
    assert cnt.shape == (case["o"].shape[0], 4) and cnt.dtype == torch.int32
    assert int(cnt[:, 0].min()) >= 1
    assert bool((cnt[:, 1] <= cnt[:, 0]).all())
    assert bool((cnt[:, 3] <= 8 * cnt[:, 2]).all())
    _, _, binary = tt.traverse_plain(case["tables"], torch.tensor(case["o"]),
                                     torch.tensor(case["d"]), case["depth"],
                                     count_steps=True)
    assert int(cnt[:, 0].sum()) < int(binary[:, 0].sum())
    busiest = int(cnt[:, 0].argmax())
    o = np.repeat(case["o"][busiest:busiest + 1], 1024, 0)
    d = np.repeat(case["d"][busiest:busiest + 1], 1024, 0)
    _, _, jc = _jax_wide(case, o, d, sub=8, count_steps=True)
    jc = np.asarray(jc)
    assert jc.shape == (1, 3)
    visits, leaf_visits, groups, tests = cnt[busiest].tolist()
    assert (visits, groups, leaf_visits) == tuple(jc[0])
    assert visits >= 2


def test_padded_root_entries_are_never_entered():
    """A ray whose three slab distances to the far pad box coincide
    (equal direction components) passes the pad's slab test; the walk
    masks the pads by index, so no child index leaves its level."""
    tris, _, _ = random_scene(500, 8, seed=3)
    bvh = jax_build_bvh(tris, depth=4, use_native=False)
    st = tris[bvh["perm"]]
    tables = {k: torch.tensor(v) for k, v in tt.pack_tables(
        bvh["node_bmin"], bvh["node_bmax"], bvh["node_from"],
        bvh["node_to"], st, 4).items()}
    wide = {k: torch.tensor(v) for k, v in tw.pack_bvh_wide(bvh).items()}
    assert wide["nodes8"].shape[0] == 3  # a pad's child row would be 3..8
    o = torch.tensor([[-6.0, -6.0, -6.0], [1.0, 1.0, 1.0]])
    d = torch.full((2, 3), float(np.float32(1.0) / np.sqrt(np.float32(3.0))))
    pad = wide["nodes8"][0, 2]
    passes, _ = tt._slab(pad[0:3], pad[4:7], o, 1.0 / d,
                         torch.full((2,), float("inf")))
    assert bool(passes.all())
    wi, wt = tw.traverse_wide_plain(wide["nodes8"], wide["leaf8"],
                                    tables["tris"], o, d, 4)
    bi, bt = tt.traverse_plain(tables, o, d, 4)
    assert torch.equal(wt, bt) and torch.equal(wi, bi)


def test_wrapper_refuses_what_it_cannot_serve(case):
    w, tris = case["wide"], case["tables"]["tris"]
    z = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tw.traverse_wide(w["nodes8"], w["leaf8"], tris, z, z, case["depth"])
    o, d = torch.tensor(case["o"]), torch.tensor(case["d"])
    # The launch path checks before it loads the kernel.
    with pytest.raises(ValueError, match="nodes8"):
        tw._launch(w["nodes8"][:-1], w["leaf8"], tris, o, d, case["depth"])
    bad = w["leaf8"].clone()
    bad[-1, -1] += 1
    with pytest.raises(ValueError, match="leaf8"):
        tw._launch(w["nodes8"], bad, tris, o, d, case["depth"])
    with pytest.raises(ValueError, match="depth"):
        tw._launch(w["nodes8"], w["leaf8"], tris, o, d, 2)
    with pytest.raises(ValueError, match="wide levels"):
        tw._launch(w["nodes8"], w["leaf8"], tris, o, d, 25)


@pytest.mark.parametrize("levels,nbytes", [
    (1, 4 * 288 + 16 * 11 * 4), (4, 4 * 288 + 16 * 32 * 4),
    (5, 4 * 288 + 16 * 39 * 4), (8, 4 * 288 + 16 * 60 * 4)])
def test_wide_stack_and_shared_bytes(levels, nbytes):
    """The wide kernel's block: four warps' scan scratch (32 int32 pairs
    and 4 keys of 8 bytes), then a stack of 7 per wide level + 4 int32 for
    each of its 16 tiles of 8 lanes; the plain walk's stack has the same
    rows.  Depth 11 (the main scene) has 4 wide levels, depth 15 (config
    5) 5."""
    assert tw.stack_rows(levels) == 7 * levels + 4
    assert tw.SCRATCH == 288
    assert tw.shared_bytes(levels) == nbytes
    assert len(tw.level_offsets(11)) == 4 and len(tw.level_offsets(15)) == 5


@pytest.mark.parametrize("bad", [0, tw.MAX_LEVELS + 1])
def test_wide_shared_bytes_refuses_other_level_counts(bad):
    with pytest.raises(ValueError, match="wide levels"):
        tw.shared_bytes(bad)


def test_convert_carries_the_wide_tables():
    _, config, ir = heightfield_scene(grid=12, res=16, compat=False)
    fields = dataclasses.asdict(config)
    ir_np = jax.tree.map(np.asarray, ir)
    cfg, plain = ir_from_numpy(fields, ir_np, device="cpu")
    assert "wide" not in plain
    cfg, tir = ir_from_numpy(fields, ir_np, device="cpu", wide=True)
    bvh = {k: np.asarray(v) for k, v in ir_np["bvh"].items()}
    bvh["depth"] = cfg.bvh_depth
    nodes_j, leaf_j = (np.asarray(a) for a in jw.pack_bvh_wide(bvh))
    lanes = nodes_j.reshape(nodes_j.shape[0], 8, 16)
    np.testing.assert_array_equal(tir["wide"]["nodes8"].numpy()[:, :, 0:3],
                                  lanes[:, :, 0:3])
    np.testing.assert_array_equal(tir["wide"]["leaf8"].numpy()[:, 0::2],
                                  leaf_j.reshape(-1, 8, 16)[:, :, 0])
    # The sweep takes the carried tables instead of packing its own.
    walk = sweep_traverse.make_walk(tir, cfg.bvh_depth)
    assert walk["wide"] is tir["wide"]


def test_sweep_entry_point_runs_on_the_cpu(capsys):
    rows = sweep_traverse.main(["--device", "cpu", "--grids", "12", "--res",
                                "32", "--reps", "1"])
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1].startswith('{"sweep": [')
    closest = ["binary", "binary-v1", "frontier=2", "frontier=4",
               "frontier=8", "wide"]
    by_set = {}
    for r in rows:
        by_set.setdefault(r["ray_set"], []).append(r["kernel"])
        assert r["rays"] == 32 * 32 and r["device"] == "cpu"
        assert r["ms"] > 0 and r["bound_ms"] > 0 and r["ties"] >= 0
        assert r["near_ties"] == 0
        assert len(r["counters"]) == 4 and r["counters"][0] >= 1
    assert by_set == {"coherent": closest, "sorted-incoherent": closest,
                      "recorded bounce 1": closest,
                      "recorded shadow": ["binary", "binary-v1",
                                          "frontier=4"]}
    assert tt.launches == 0 and tt.frontier_launches == 0
    assert tt.v1_launches == 0
