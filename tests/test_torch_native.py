"""PyTorch port, the host runtime against the JAX package's.

The port's C++ library (``csrc/elevenrt.cpp`` built by ``kernels.py``
with the host compiler, bound by ``ops/native.py``) is held to:
- the port's numpy SAH build and the JAX package's C++ and numpy builds,
  bit for bit: perm, node ranges and max leaf exact, boxes bit-equal;
- the JAX package's C++ tokenizer, bit for bit on every output;
- ``load_objs``: above 2,000,000 characters both packages hand the text
  to the C++ tokenizer, whose shapes are keyed by name, so the port's
  meshes equal the JAX package's there too (names, verts, normals, uvs,
  tangents and material names; exactly).

The host compiler is in the test environment, so nothing here skips.
"""

import torch_threads  # noqa: F401  (first: torch's threads a worker)

import shutil

import numpy as np
import pytest

from elevenrender_tpu.ops import bvh as jax_bvh
from elevenrender_tpu.ops import native as jax_native
from elevenrender_tpu.scene import objloader as jax_obj
from elevenrender_tpu_torch import kernels
from elevenrender_tpu_torch.ops import bvh as tb
from elevenrender_tpu_torch.ops import native as tn
from elevenrender_tpu_torch.scene import objloader as tobj

from scenes import CORNELL_OBJ

BVH_KEYS = ("perm", "node_from", "node_to", "node_bmin", "node_bmax")


def random_tris(n, seed=0):
    """tests/test_native.py's triangles."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, (n, 1, 3))
    return (centers + rng.normal(0, 0.4, (n, 3, 3))).astype(np.float32)


def _edge_case(name):
    if name == "coincident centroids":
        # Every tri has its centroid at the origin: each split bins them
        # all alike, so one child takes everything.
        rng = np.random.default_rng(4)
        half = rng.normal(0, 1, (40, 1, 3)).astype(np.float32)
        return np.concatenate([half, -half, np.zeros_like(half)], axis=1)
    if name == "flat axis":
        tris = random_tris(200, seed=5)
        tris[..., 1] = 0.25  # every vertex on the plane y = 0.25
        return tris
    n = int(name.split()[0])
    return random_tris(n, seed=10 + n)


CASES = ([(f"seed {s}, {n} tris", random_tris(n, s), None)
          for s, n in ((0, 37), (1, 300), (2, 1000))]
         + [(f"{n} tris", _edge_case(f"{n} tris"), None) for n in (1, 2, 3, 4)]
         + [(c, _edge_case(c), None)
            for c in ("coincident centroids", "flat axis")]
         + [("4 tris at depth 5 (empty leaves)", _edge_case("4 tris"), 5),
            ("1000 tris at depth 3", random_tris(1000, 2), 3)])


def _assert_same_bvh(got, want, label):
    assert got["depth"] == want["depth"], label
    assert got["max_leaf"] == want["max_leaf"], label
    for k in BVH_KEYS:
        assert got[k].dtype == want[k].dtype, (label, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label} {k}")


@pytest.mark.parametrize("name,tris,depth", CASES,
                         ids=[c[0] for c in CASES])
def test_native_build_equals_numpy_and_jax(name, tris, depth):
    got = tb.build_bvh(tris, depth)
    d = got["depth"]
    assert d == (tb.default_depth(len(tris)) if depth is None else depth)
    _assert_same_bvh(got, tb.build_bvh(tris, depth, use_native=False),
                     "port numpy")
    _assert_same_bvh(got, jax_bvh.build_bvh(tris, depth, use_native=False),
                     "JAX numpy")
    jax_out = jax_native.build_bvh_native(tris, d)
    assert jax_out is not None, "the JAX package's library did not load"
    _assert_same_bvh(got, jax_out, "JAX C++")
    assert sorted(got["perm"].tolist()) == list(range(len(tris)))


def test_native_build_is_the_default_and_the_switch_turns_it_off(
        monkeypatch):
    tris = random_tris(300, 1)
    calls = []
    real = tn.build_bvh_native

    def spy(*args):
        calls.append(args[1])
        return real(*args)

    monkeypatch.setattr(tn, "build_bvh_native", spy)
    monkeypatch.delenv("ELEVENRT_NATIVE", raising=False)
    tb.build_bvh(tris)
    assert calls == [tb.default_depth(300)]
    tb.build_bvh(tris, use_native=False)
    monkeypatch.setenv("ELEVENRT_NATIVE", "0")
    tb.build_bvh(tris)
    out = tb.build_bvh(np.zeros((0, 3, 3), np.float32), use_native=True)
    assert len(calls) == 1
    assert out["perm"].shape == (0,) and out["max_leaf"] == 1
    with pytest.raises(ValueError):
        tn.build_bvh_native(tris, 31)


def _obj_text(n_faces=(300, 200, 250), names=("A", "B", "A"), crlf=False,
              seed=0):
    """An OBJ text whose blocks exercise the tokenizers: ``o`` blocks of
    repeated names, a block of faces without normals, negative
    (relative) indices, quads and pentagons (fans), ``usemtl`` switches
    inside a block, a ``g`` line, comments and blank lines."""
    rng = np.random.default_rng(seed)
    lines = ["# generated", "mtllib scene.mtl", ""]
    nv = 0
    nn = 0
    nt = 0
    for b, (name, nf) in enumerate(zip(names, n_faces)):
        lines.append(f"o {name}" if b != 1 else f"g {name}")
        with_normals = b % 3 != 1
        relative = b % 2 == 1
        for f in range(nf):
            if f % 97 == 0:
                lines.append(f"usemtl mat{(b + f) % 3}")
            k = 3 + f % 3  # tri, quad, pentagon
            pos = rng.uniform(-2, 2, (k, 3))
            for p in pos:
                lines.append("v %.6f %.6f %.6f" % tuple(p))
            for p in rng.uniform(0, 1, (k, 2)):
                lines.append("vt %.6f %.6f" % tuple(p))
            if with_normals:
                nrm = rng.normal(0, 1, 3)
                lines.append("vn %.6f %.6f %.6f" % tuple(nrm))
                nn += 1
            corners = []
            for c in range(k):
                vi = -(k - c) if relative else nv + c + 1
                ti = -(k - c) if relative else nt + c + 1
                if with_normals:
                    ni = -1 if relative else nn
                    corners.append(f"{vi}/{ti}/{ni}")
                else:
                    corners.append(f"{vi}/{ti}")
            nv += k
            nt += k
            lines.append("f " + " ".join(corners))
        lines.append("")
    return ("\r\n" if crlf else "\n").join(lines) + "\n"


def _assert_same_parse(got, want):
    assert len(got) == len(want) == 7
    for i, (a, b) in enumerate(zip(got[:5], want[:5])):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"output {i}")
    assert got[5:] == want[5:]


@pytest.mark.parametrize("which", ["cornell", "generated", "generated crlf"])
def test_parse_obj_native_equals_jax(which):
    text = (CORNELL_OBJ if which == "cornell"
            else _obj_text(crlf=which.endswith("crlf"), seed=3))
    got = tn.parse_obj_native(text)
    _assert_same_parse(got, jax_native.parse_obj_native(text))
    _assert_same_parse(tn.parse_obj_native(text.encode()), got)
    if which != "cornell":
        # Shapes keyed by name: A (its two blocks) and B.
        assert got[6] == ["A", "B"]
        assert sorted(set(got[5])) == ["mat0", "mat1", "mat2"]
        assert np.isnan(got[1][got[3] == 1]).all()  # B has no normals
        assert np.isfinite(got[1][got[3] == 0]).all()
    else:
        assert got[6] == ["floor", "ceiling", "back", "left", "right",
                          "lamp"]


def _assert_same_meshes(got, want):
    assert [m.name for m in got] == [m.name for m in want]
    for a, b in zip(got, want):
        for k in ("verts", "normals", "uvs", "tangents", "tangent_signs"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype, (a.name, k)
            np.testing.assert_array_equal(x, y, err_msg=f"{a.name} {k}")
        assert a.mat_names == b.mat_names, a.name


def _big_text(chars):
    """Blocks A, B, A whose text passes ``chars`` characters."""
    unit = len(_obj_text((60, 40, 50), seed=1))
    scale = chars / unit * 1.02
    faces = (int(60 * scale), int(40 * scale), int(50 * scale))
    return _obj_text(faces, seed=1)


def test_load_objs_above_2mb_equals_jax():
    """The repaired fault: above 2,000,000 characters the JAX package
    merges the two blocks named A into one shape (its C++ tokenizer keys
    shapes by name); the port's loader once always ran the Python
    tokenizer and kept three shapes."""
    text = _big_text(2_100_000)
    assert len(text) > tobj.NATIVE_MIN_CHARS == 2_000_000
    got, mats = tobj.load_objs(text, mtl_text="newmtl mat0\n")
    want, jax_mats = jax_obj.load_objs(text, mtl_text="newmtl mat0\n")
    assert [m.name for m in got] == ["A", "B"]
    assert [m.name for m in mats] == [m.name for m in jax_mats] == ["mat0"]
    _assert_same_meshes(got, want)
    # B's faces carry no normal index: face normals on every tri.
    b = got[1]
    assert np.array_equal(b.normals[:, 0], b.normals[:, 1])
    # recompute_normals goes through the same switch.
    _assert_same_meshes(tobj.load_objs(text, recompute_normals=True)[0],
                        jax_obj.load_objs(text, recompute_normals=True)[0])


def test_load_objs_below_2mb_keeps_the_python_tokenizer():
    text = _obj_text(seed=2)
    assert len(text) < tobj.NATIVE_MIN_CHARS
    got, _ = tobj.load_objs(text)
    assert [m.name for m in got] == ["A", "B", "A"]
    _assert_same_meshes(got, jax_obj.load_objs(text)[0])


def test_load_library_reuses_its_build_and_rebuilds_an_edited_source(
        tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    shutil.copy(kernels.CSRC / "elevenrt.cpp", csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels, "build_info", {})
    builds = []
    real = kernels.build_all
    monkeypatch.setattr(kernels, "build_all",
                        lambda names=None: builds.append(names)
                        or real(names))

    lib = tn.load_library()
    assert builds == [["elevenrt"]]
    assert kernels.build_info["elevenrt"]["seconds"] > 0
    assert tn.load_library() is lib and len(builds) == 1
    tris = random_tris(300, 1)
    first = tn.build_bvh_native(tris, 4)

    with open(csrc / "elevenrt.cpp", "a") as f:
        f.write("// edited\n")
    lib2 = tn.load_library()
    assert lib2 is not lib and builds == [["elevenrt"], ["elevenrt"]]
    assert len(list((tmp_path / "build").glob("libelevenrt-*.so"))) == 2
    _assert_same_bvh(tn.build_bvh_native(tris, 4), first, "rebuilt")


def test_a_failed_host_build_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "elevenrt.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels, "build_info", {})
    with pytest.raises(RuntimeError, match="failed for elevenrt"):
        tn.load_library()
    with pytest.raises(RuntimeError):
        tb.build_bvh(random_tris(10))
    assert not list((tmp_path / "build").glob("*.so"))
