"""The yardstick of ``traverse_roofline_pct``: the benchmark's binned-SAH
tree is the port's numpy build, and its walk finds what a brute-force
test of every triangle finds."""

import json

import numpy as np
import pytest
import torch

from renderbench import manifest, scene, walkcount
from renderbench.reference.boxtree import _mt

SEED = 2**31 + 41


def _mesh(grid):
    bench = manifest.load()
    entry = {c["name"]: c for c in bench["configs"]}["heightfield_hdri_65k"]
    with open(f"{manifest.ROOT}/{entry['file']}") as f:
        cfg = json.load(f)
    cfg["heightfield"] = dict(cfg["heightfield"], grid=grid)
    cfg["resolution"] = [16, 16]
    return scene.make(cfg, SEED)["mesh"]["verts"]


@pytest.mark.parametrize("grid", [12, 40])
def test_the_tree_is_the_ports_numpy_build(grid):
    from elevenrender_tpu_torch.ops.bvh import (build_bvh, default_depth,
                                                preorder_indices)
    verts = _mesh(grid)
    tree = walkcount.sah_tree(verts, torch.device("cpu"))
    port = build_bvh(np.asarray(verts, np.float32), use_native=False)
    depth = port["depth"]
    assert tree["depth"] == depth == default_depth(len(verts))
    assert np.array_equal(tree["ids"].numpy(), port["perm"])
    pre = preorder_indices(depth)
    leaves = pre[depth]
    assert np.array_equal(tree["starts"][:-1].numpy(),
                          port["node_from"][leaves])
    assert np.array_equal(tree["starts"][1:].numpy(), port["node_to"][leaves])
    for d in range(depth + 1):
        lo = tree["lo"][(1 << d) - 1:(1 << (d + 1)) - 1].numpy()
        full = np.isfinite(lo).all(axis=1)
        assert np.array_equal(lo[full], port["node_bmin"][pre[d]][full])


def test_the_walk_finds_what_every_triangle_finds():
    verts = _mesh(20)
    dev = torch.device("cpu")
    tree = walkcount.sah_tree(verts, dev)
    gen = torch.Generator().manual_seed(3)
    n = 512
    o = torch.tensor([0.0, 1.5, -4.0]).expand(n, 3) \
        + 0.1 * torch.randn((n, 3), generator=gen)
    d = torch.nn.functional.normalize(
        torch.tensor([0.0, -0.35, 1.0]) + 0.3 * torch.randn(
            (n, 3), generator=gen), dim=1)
    v = torch.tensor(np.asarray(verts, np.float32))
    table = torch.cat([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], dim=1)
    ok, t = _mt(table[None], o[:, None], d[:, None])
    brute = torch.where(ok, t, torch.full_like(t, float("inf"))).amin(dim=1)
    closest = walkcount.count(tree, o, d)
    assert torch.equal(closest["hit"], brute)
    hit = torch.isfinite(brute)
    assert 0 < int(hit.sum()) < n
    # Each ray that hits walks down the tree's depth at least.
    assert closest["visits"] >= int(hit.sum()) * tree["depth"]
    exclude = torch.full((n,), -1, dtype=torch.int64)
    t_max = torch.where(hit, brute * 1.5, torch.full_like(brute, 1e3))
    any_hit = walkcount.count(tree, o, d, exclude, t_max)
    assert torch.equal(any_hit["hit"], hit)
    assert any_hit["tests"] <= closest["tests"] + 32 * n
