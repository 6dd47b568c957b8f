"""The hit data's two hand CUDA kernels (``ops/hitdata.py``,
``csrc/hitdata.cu``) against the PyTorch ops they stand in for, and the
rule that picks between them.

On the CPU:
(a) the rule: the PyTorch ops on the CPU, under ``enable_grad`` with a
    material that requires grad, and with a forward-mode dual tensor
    under ``no_grad``; the kernels for tensors on a card under
    ``no_grad`` (the card faked by ``hitdata.on_card`` and the two
    launches stood in for by the PyTorch ops, so the integrator's
    assembly of their outputs is held to the PyTorch path's dict);
(b) the counters ``hitdata_fused`` and ``hitdata_eager``: one a bounce,
    by the path the bounce took; the launch counters, one a launch;
(c) what the wrappers hand the C entry points: every pointer, size,
    slot mask and filter, and the views they return.

On a card (``-m card``; skipped without one): the kernels against the
PyTorch ops bit for bit on every lane and every field (a NaN where the
ops give NaN): the main path's heightfield and config 5's textured
heightfield at 262,144 lanes, traced hits, misses (-1), arbitrary tris
and NaN rays among them; atlases of mixed, bilinear-only and
nearest-only filters with textures of 1, 2, 3 and 4 channels, unbound
slots, and u, v negative, above 1, huge, infinite and NaN; the kernels
captured in a CUDA graph and replayed on new inputs; and a progressive
render by graph replays against the PyTorch ops' render.

    python -m pytest tests/test_torch_hitdata.py -q
    python -m pytest tests/test_torch_hitdata.py -q -m card --noconftest
"""

import torch_threads  # noqa: F401  (first: torch's threads a worker)

import ctypes

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from elevenrender_tpu_torch.core import spans
from elevenrender_tpu_torch.ops import hitdata as hitdata_ops
from elevenrender_tpu_torch.ops.intersect import full_hit, gather_tri
from elevenrender_tpu_torch.ops.texture import FILTER_BILINEAR, FILTER_NONE
from elevenrender_tpu_torch.render import integrator as ti
from elevenrender_tpu_torch.render.renderer import Renderer
from elevenrender_tpu_torch.scene import demo
from elevenrender_tpu_torch.scene.hdri import HDRI
from elevenrender_tpu_torch.scene.ir import RenderConfig
from elevenrender_tpu_torch.scene.material import Material
from elevenrender_tpu_torch.scene.scene import Scene
from elevenrender_tpu_torch.scene.texture import Texture

# hd's keys for the scalars of the material row, by hitdata.SCALARS name.
_HD_NAME = {"clearcoat_gloss": "clearcoatGloss",
            "specular_tint": "specularTint", "sheen_tint": "sheenTint"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def counters():
    """The two path counters, from zero."""
    spans.reset(["hitdata_fused", "hitdata_eager"])
    yield lambda: (spans.counter("hitdata_fused"),
                   spans.counter("hitdata_eager"))
    spans.reset(["hitdata_fused", "hitdata_eager"])


def _eager(config, ir, hit_idx, ray_o, ray_d):
    """(hit, hd) by the PyTorch ops, as the integrator computes them off
    the card."""
    hit = full_hit(ray_o, ray_d, gather_tri(ir["tris"],
                                            torch.clamp(hit_idx, min=0)))
    return hit, ti._generate_hitdata(config, ir, hit, ray_d)


def _stand_ins(monkeypatch):
    """CPU tensors count as a card's, and the two launches are stood in
    for by the PyTorch ops, in the kernels' output format; returns the
    launches made."""
    calls = []
    monkeypatch.setattr(hitdata_ops, "on_card", lambda device: True)

    def tri(tris, hit_idx, ray_o, ray_d):
        calls.append("tri")
        hit = full_hit(ray_o, ray_d,
                       gather_tri(tris, torch.clamp(hit_idx, min=0)))
        return {k: v for k, v in hit.items() if k not in ("valid", "t")}

    def material(mats, atlas, hit, used, uniform_filter):
        calls.append("material")
        cfg = RenderConfig(tex_slots_used=used,
                           tex_uniform_filter=uniform_filter,
                           use_shaders=False)
        hd = ti._generate_hitdata(cfg, {"materials": mats, "atlas": atlas},
                                  hit, None)
        out = {k: hd[_HD_NAME.get(k, k)] for k in
               ("albedo", "emission", *hitdata_ops.SCALARS)}
        if used[hitdata_ops.NORMAL_SLOT]:
            out["normal"] = hd["normal"]
        return out

    monkeypatch.setattr(hitdata_ops, "tri", tri)
    monkeypatch.setattr(hitdata_ops, "material", material)
    return calls


@pytest.fixture
def fake_card(monkeypatch):
    return _stand_ins(monkeypatch)


def _lanes(config, ir, n, seed=0):
    """(hit_idx, ray_o, ray_d) of n lanes: rays from above the scene
    toward it, traced (hits and misses), then an eighth of the lanes
    given an arbitrary tri (uv far outside the tri), an eighth a miss
    (-1) and a few a NaN or infinite ray."""
    g = torch.Generator().manual_seed(seed)
    dev = ir["tris"]["packed"].device
    o = torch.empty((n, 3)).uniform_(-2.0, 2.0, generator=g)
    o[:, 1] = torch.empty(n).uniform_(1.0, 3.0, generator=g)
    d = torch.randn((n, 3), generator=g)
    d[:, 1] = -d[:, 1].abs() - 0.2
    d = d / d.norm(dim=1, keepdim=True)
    o, d = o.to(dev), d.to(dev)
    idx, _ = ti._trace(config, ir, o, d, sort=False)
    t_rows = ir["tris"]["verts"].shape[0]
    pick = torch.randint(0, 8, (n,), generator=g).to(dev)
    arbitrary = torch.randint(0, t_rows, (n,), generator=g).to(dev)
    idx = torch.where(pick == 0, arbitrary, idx)
    idx = torch.where(pick == 1, torch.full_like(idx, -1), idx)
    bad = torch.tensor([float("nan"), float("inf"), -float("inf")],
                       device=dev)
    for k in range(3):
        o[k::997, k] = bad[k]
        d[5 + k::1009, (k + 1) % 3] = bad[k]
    return idx, o.contiguous(), d.contiguous()


def _roughen(ir, seed=1, mats=1):
    """The IR with its packed tri rows' normals and tangents perturbed
    (so the interpolation and the terminator projection have work), the
    bitangent signs drawn from +-1 and the material ids from ``mats``
    materials."""
    g = torch.Generator().manual_seed(seed)
    packed = ir["tris"]["packed"].cpu().clone()
    t = packed.shape[0]
    packed[:, 9:18] += 0.3 * torch.randn((t, 9), generator=g)
    packed[:, 24:33] += 0.3 * torch.randn((t, 9), generator=g)
    packed[:, 33] = torch.where(torch.rand(t, generator=g) < 0.5, -1.0, 1.0)
    packed[:, 34] = torch.randint(0, mats, (t,), generator=g).float()
    return {**ir, "tris": {**ir["tris"],
                           "packed": packed.to(ir["tris"]["packed"].device)}}


def _same(got, want, where):
    """Equal bit for bit, a NaN where the other has NaN."""
    assert got.shape == want.shape and got.dtype == want.dtype, where
    if not want.is_floating_point():
        assert torch.equal(got, want), where
        return
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), where
    bits_got = got.contiguous().view(torch.int32)[~nan]
    bits_want = want.contiguous().view(torch.int32)[~nan]
    off = (bits_got != bits_want).sum().item()
    assert off == 0, f"{where}: {off} lanes differ"


def _same_hitdata(got, want):
    hit, hd = got
    hit_e, hd_e = want
    keys = set(hit_e) - {"valid", "t"}  # which nothing downstream reads
    assert set(hit) - {"valid", "t"} == keys
    for k in keys:
        _same(hit[k], hit_e[k], f"hit[{k!r}]")
    assert list(hd) == list(hd_e)
    for k in hd:
        _same(hd[k], hd_e[k], f"hd[{k!r}]")


def _atlas_scene(filters, device, grid=6):
    """A small heightfield whose materials bind textures of 1, 2, 3 and 4
    channels in every slot, each texture of the filter ``filters`` gives
    it, their texels negative, above 1 and -0.0 among them.  Material 0
    binds every slot, 1 none (its lanes keep the constants of every
    bound slot), 2 some.  Returns (config, ir) with the tris' material
    ids drawn from the three."""
    scene = Scene()
    scene.add_mesh(demo.heightfield_mesh(grid))
    rng = np.random.default_rng(11)
    shapes = [(5, 7, 1), (4, 3, 2), (6, 8, 3), (3, 5, 4), (1, 1, 3),
              (2, 9, 1), (7, 4, 3)]
    for k, (h, w, c) in enumerate(shapes):
        data = rng.uniform(-0.5, 1.5, (h, w, c)).astype(np.float32)
        data.reshape(-1)[::5] = -0.0
        scene.add_texture(Texture(f"t{k}", data,
                                  filters[k % len(filters)]))
    maps = [
        {"albedo": "t2", "emission": "t0", "roughness": "t1",
         "metallic": "t3", "normal": "t6", "opacity": "t5",
         "transmission": "t4"},
        {},
        {"albedo": "t0", "emission": "t1", "metallic": "t5",
         "normal": "t4"},
    ]
    for k, slots in enumerate(maps):
        mat = Material(name=f"m{k}",
                       albedo=rng.uniform(0, 1, 3).astype(np.float32),
                       emission=rng.uniform(0, 1, 3).astype(np.float32),
                       roughness=float(rng.uniform(0.1, 0.9)),
                       metallic=float(rng.uniform(0, 1)),
                       opacity=float(rng.uniform(0.5, 1)),
                       transmission=float(rng.uniform(0, 0.5)),
                       sheen=float(rng.uniform(0, 1)),
                       clearcoat=float(rng.uniform(0, 1)))
        for slot, name in slots.items():
            setattr(mat, f"{slot}_map", name)
        scene.add_material(mat)
    scene.pair_textures()
    scene.add_hdri(HDRI(Texture("sky", demo.sky_image())))
    scene.x_res = scene.y_res = 8
    config, ir = scene.build(device=device)
    assert all(config.tex_slots_used)
    return config.replace(compat=False), _roughen(ir, mats=len(maps))


# ---------------------------------------------------------------------------
# CPU: the rule, the counters, the launch arguments
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    _, cfg, ir = demo.textured_heightfield_scene(grid=10, res=8,
                                                 device="cpu")
    return cfg, _roughen(ir)


def _no_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a hit-data kernel was launched")
    monkeypatch.setattr(hitdata_ops, "_library", refuse)


def test_the_pytorch_ops_run_on_the_cpu(small, counters, monkeypatch):
    cfg, ir = small
    _no_kernel(monkeypatch)
    lanes = _lanes(cfg, ir, 64)
    with torch.no_grad():
        got = ti._hitdata(cfg, ir, *lanes)
    _same_hitdata(got, _eager(cfg, ir, *lanes))
    assert counters() == (0, 1)


def test_the_kernels_serve_a_card_under_no_grad(small, counters, fake_card):
    cfg, ir = small
    lanes = _lanes(cfg, ir, 64)
    with torch.no_grad():
        got = ti._hitdata(cfg, ir, *lanes)
    assert fake_card == ["tri", "material"]
    assert counters() == (1, 0)
    _same_hitdata(got, _eager(cfg, ir, *lanes))


def test_the_kernels_serve_a_card_under_grad_mode_with_no_leaf(
        small, counters, fake_card):
    cfg, ir = small
    with torch.enable_grad():
        ti._hitdata(cfg, ir, *_lanes(cfg, ir, 16))
    assert fake_card == ["tri", "material"]
    assert counters() == (1, 0)


@pytest.mark.parametrize("leaf", ["albedo", "roughness", "ray_d", "atlas"])
def test_the_pytorch_ops_run_under_enable_grad_with_a_leaf(
        small, counters, fake_card, leaf):
    cfg, ir = small
    idx, o, d = _lanes(cfg, ir, 16)
    mats = dict(ir["materials"])
    atlas = dict(ir["atlas"])
    if leaf == "ray_d":
        d = d.clone().requires_grad_()
    elif leaf == "atlas":
        atlas["data"] = atlas["data"].clone().requires_grad_()
    else:
        mats[leaf] = mats[leaf].clone().requires_grad_()
    ir = {**ir, "materials": mats, "atlas": atlas}
    with torch.enable_grad():
        ti._hitdata(cfg, ir, idx, o, d)
    assert fake_card == []
    assert counters() == (0, 1)
    with torch.no_grad():
        ti._hitdata(cfg, ir, idx, o, d)
    assert fake_card == ["tri", "material"]
    assert counters() == (1, 1)


@pytest.mark.parametrize("dual", ["ray_o", "albedo"])
def test_the_pytorch_ops_run_with_a_dual_tensor_under_no_grad(
        small, counters, fake_card, dual):
    cfg, ir = small
    idx, o, d = _lanes(cfg, ir, 16)
    with fwAD.dual_level(), torch.no_grad():
        if dual == "ray_o":
            o = fwAD.make_dual(o, torch.ones_like(o))
            run_ir = ir
        else:
            alb = ir["materials"]["albedo"]
            run_ir = {**ir, "materials": {
                **ir["materials"],
                "albedo": fwAD.make_dual(alb, torch.ones_like(alb))}}
        hit, hd = ti._hitdata(cfg, run_ir, idx, o, d)
        tangent = fwAD.unpack_dual(
            hit["position"] if dual == "ray_o" else hd["emission"]).tangent
    assert fake_card == []
    assert counters() == (0, 1)
    assert tangent is not None


@pytest.mark.parametrize("what", ["float64", "cpu", "card"])
def test_the_rule_reads_the_device_and_the_dtype(small, monkeypatch, what):
    """The rule reads the device alone; a dtype other than float32 on a
    card reaches the kernels' wrappers, which refuse it."""
    x = torch.zeros(3, dtype=torch.float64 if what == "float64"
                    else torch.float32)
    if what != "cpu":
        monkeypatch.setattr(hitdata_ops, "on_card", lambda device: True)
    assert hitdata_ops.serves([x, torch.ones(2)]) == (what != "cpu")
    if what == "float64":
        cfg, ir = small
        lib = _record(monkeypatch)
        idx, o, d = _lanes(cfg, ir, 8)
        with pytest.raises(TypeError, match="ray_o"):
            hitdata_ops.tri(ir["tris"], idx, o.double(), d)
        assert lib.calls == {}


def test_every_bounce_counts_its_path(counters, fake_card):
    _, cfg, ir = demo.heightfield_scene(grid=8, res=6, device="cpu")
    Renderer(cfg, ir, device="cpu").step(2)
    assert counters() == (2 * cfg.max_bounces, 0)
    assert fake_card == ["tri", "material"] * 2 * cfg.max_bounces


def test_every_bounce_counts_the_pytorch_ops_on_the_cpu(counters,
                                                        monkeypatch):
    _no_kernel(monkeypatch)
    _, cfg, ir = demo.textured_heightfield_scene(grid=8, res=6,
                                                 device="cpu")
    Renderer(cfg, ir, device="cpu").step(3)
    assert counters() == (0, 3 * cfg.max_bounces)


def test_a_render_on_the_stand_ins_equals_the_pytorch_ops(monkeypatch):
    """The integrator reads the kernels' outputs where the PyTorch ops'
    would be: a sample rendered through the stand-ins equals one by the
    ops, pass for pass."""
    _, cfg, ir = demo.textured_heightfield_scene(grid=8, res=6,
                                                 device="cpu")
    want = Renderer(cfg, ir, device="cpu")
    want.step(2)
    _stand_ins(monkeypatch)
    got = Renderer(cfg, ir, device="cpu")
    got.step(2)
    assert torch.equal(got.state["passes"], want.state["passes"])
    assert torch.equal(got.state["rng"], want.state["rng"])


class _Recorder:
    """A stand-in for the loaded library: each entry point records its
    arguments and returns 0."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            if name == "hitdata_material":  # the pointer table, read now
                args = list(args)
                args[9] = list((ctypes.c_void_p * len(hitdata_ops.SCALARS))
                               .from_address(args[9]))
            self.calls[name] = tuple(args)
            return 0
        entry.__name__ = name
        return entry


def _record(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(hitdata_ops, "_library", lambda: lib)
    monkeypatch.setattr(hitdata_ops, "_run",
                        lambda fn, dev, *args: fn(*args, None))
    return lib


def test_the_tri_launch_arguments(small, monkeypatch):
    cfg, ir = small
    lib = _record(monkeypatch)
    idx, o, d = _lanes(cfg, ir, 40)
    hit = hitdata_ops.tri(ir["tris"], idx, o, d)
    (packed, t_rows, p_rows, hit_p, o_p, d_p, n, vec, uv, mat,
     stream) = lib.calls["hitdata_tri"]
    tris = ir["tris"]
    assert (packed, t_rows, p_rows) == (tris["packed"].data_ptr(),
                                        tris["verts"].shape[0],
                                        tris["packed"].shape[0])
    assert (hit_p, o_p, d_p, n) == (idx.data_ptr(), o.data_ptr(),
                                    d.data_ptr(), 40)
    names = ("position", "normal", "gnormal", "tangent", "bitangent")
    for k, name in enumerate(names):
        assert hit[name].shape == (40, 3) and hit[name].is_contiguous()
        assert hit[name].data_ptr() == vec + 4 * 3 * 40 * k
    assert (hit["tu"].data_ptr(), hit["tv"].data_ptr()) == (uv, uv + 160)
    assert hit["mat"].data_ptr() == mat and hit["mat"].dtype == torch.int64


@pytest.mark.parametrize("used", [(True,) * 7,
                                  (True, False, True, False, False, True,
                                   False)])
def test_the_material_launch_arguments(small, monkeypatch, used):
    cfg, ir = small
    lib = _record(monkeypatch)
    n = 24
    hit = {"mat": torch.zeros(n, dtype=torch.int64),
           "tu": torch.rand(n), "tv": torch.rand(n),
           **{k: torch.rand(n, 3) for k in ("normal", "tangent",
                                            "bitangent")}}
    mats, atlas = ir["materials"], ir["atlas"]
    got = hitdata_ops.material(mats, atlas, hit, used, -1)
    args = lib.calls["hitdata_material"]
    (mat, tu, tv, nrm, tan, bit, n_arg, alb, emi, scalars, tex, rows,
     data, p_rows, off, w, h, ch, filt, count, bits, uniform, vec, out,
     stream) = args
    assert (mat, tu, tv, nrm, tan, bit, n_arg) == (
        hit["mat"].data_ptr(), hit["tu"].data_ptr(), hit["tv"].data_ptr(),
        hit["normal"].data_ptr(), hit["tangent"].data_ptr(),
        hit["bitangent"].data_ptr(), n)
    assert (alb, emi, tex, rows) == (
        mats["albedo"].data_ptr(), mats["emission"].data_ptr(),
        mats["tex"].data_ptr(), mats["albedo"].shape[0])
    assert scalars == [mats[s].data_ptr() for s in hitdata_ops.SCALARS]
    assert (data, p_rows, count) == (atlas["data"].data_ptr(),
                                     atlas["data"].shape[0],
                                     atlas["off"].shape[0])
    assert [off, w, h, ch, filt] == [atlas[k].data_ptr() for k in
                                     ("off", "w", "h", "ch", "filter")]
    assert bits == sum(1 << s for s in range(7) if used[s])
    assert uniform == -1
    assert got["albedo"].data_ptr() == vec
    assert got["emission"].data_ptr() == vec + 4 * 3 * n
    assert ("normal" in got) == used[hitdata_ops.NORMAL_SLOT]
    if "normal" in got:
        assert got["normal"].data_ptr() == vec + 2 * 4 * 3 * n
    for k, s in enumerate(hitdata_ops.SCALARS):
        assert got[s].shape == (n,) and got[s].data_ptr() == out + 4 * n * k


@pytest.fixture
def launches():
    """The two kernels' launch counters, from zero."""
    names = list(hitdata_ops.LAUNCHES.values())
    spans.reset(names)
    yield lambda: {k: spans.counter(v)
                   for k, v in hitdata_ops.LAUNCHES.items()}
    spans.reset(names)


def test_an_empty_wavefront_launches_nothing(small, monkeypatch, launches):
    cfg, ir = small
    lib = _record(monkeypatch)
    empty = torch.zeros((0, 3))
    hit = hitdata_ops.tri(ir["tris"], torch.zeros(0, dtype=torch.int64),
                          empty, empty)
    got = hitdata_ops.material(ir["materials"], ir["atlas"], hit,
                               cfg.tex_slots_used, cfg.tex_uniform_filter)
    assert lib.calls == {}
    assert hit["position"].shape == (0, 3) and got["roughness"].shape == (0,)
    assert launches() == {"tri": 0, "material": 0}


def test_each_launch_counts_where_the_wrapper_launches(small, monkeypatch,
                                                        launches):
    cfg, ir = small
    _record(monkeypatch)
    idx, o, d = _lanes(cfg, ir, 40)
    for _ in range(3):
        hit = hitdata_ops.tri(ir["tris"], idx, o, d)
    hitdata_ops.material(ir["materials"], ir["atlas"], hit,
                         cfg.tex_slots_used, cfg.tex_uniform_filter)
    assert launches() == {"tri": 3, "material": 1}


def test_a_refused_input_counts_no_launch(small, monkeypatch, launches):
    cfg, ir = small
    _record(monkeypatch)
    idx, o, d = _lanes(cfg, ir, 40)
    with pytest.raises(ValueError, match="ray_d"):
        hitdata_ops.tri(ir["tris"], idx, o, d[:20])
    assert launches() == {"tri": 0, "material": 0}


# ---------------------------------------------------------------------------
# The card: bit for bit against the PyTorch ops
# ---------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("which", ["heightfield", "config5"])
def test_the_kernels_equal_the_pytorch_ops_on_the_cells_scenes(card,
                                                              counters,
                                                              which):
    if which == "heightfield":
        _, cfg, ir = demo.heightfield_scene(grid=182, res=64, device=card)
    else:
        _, cfg, ir = demo.textured_heightfield_scene(grid=708, res=64,
                                                     device=card)
    ir = _roughen(ir)
    lanes = _lanes(cfg, ir, 262144)
    with torch.no_grad():
        got = ti._hitdata(cfg, ir, *lanes)
        want = _eager(cfg, ir, *lanes)
    assert counters() == (1, 0)
    _same_hitdata(got, want)


_ATLASES = {"mixed": (FILTER_BILINEAR, FILTER_NONE),
            "bilinear": (FILTER_BILINEAR,), "nearest": (FILTER_NONE,)}


def _special_hit(ir, n, seed):
    """A hit of n lanes over the atlas scene's three materials, with u
    and v negative, above 1, huge, infinite, NaN and -0.0 among them, and
    frames random, zero or NaN in places."""
    g = torch.Generator().manual_seed(seed)
    dev = ir["tris"]["packed"].device
    uv = torch.empty((2, n)).uniform_(-3.0, 4.0, generator=g)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                            0.0, 1.0, -1.0, 1e10, -1e10, 0.999999, 3e9,
                            -2.5])
    uv[0, ::7] = special[torch.randint(0, 12, (uv[0, ::7].numel(),),
                                       generator=g)]
    uv[1, ::5] = special[torch.randint(0, 12, (uv[1, ::5].numel(),),
                                       generator=g)]
    frame = torch.randn((3, n, 3), generator=g)
    frame[:, ::31] = 0.0
    frame[1, ::37, 1] = float("nan")
    return {"mat": torch.randint(0, 3, (n,), generator=g).to(dev),
            "tu": uv[0].to(dev), "tv": uv[1].to(dev),
            "normal": frame[0].to(dev), "tangent": frame[1].to(dev),
            "bitangent": frame[2].to(dev)}


@pytest.mark.card
@pytest.mark.parametrize("atlas", list(_ATLASES))
def test_the_kernels_equal_the_pytorch_ops_on_every_atlas(card, monkeypatch,
                                                          atlas):
    cfg, ir = _atlas_scene(_ATLASES[atlas], card)
    assert cfg.tex_uniform_filter == (-1 if atlas == "mixed" else
                                      _ATLASES[atlas][0])
    # The whole phase on traced and arbitrary hits.
    lanes = _lanes(cfg, ir, 65536, seed=3)
    with torch.no_grad():
        _same_hitdata(ti._hitdata(cfg, ir, *lanes), _eager(cfg, ir, *lanes))
    # The material kernel on hits made to its corners.
    hit = _special_hit(ir, 65536, seed=4)
    hit["position"] = hit["gnormal"] = hit["normal"]
    monkeypatch.setattr(hitdata_ops, "tri", lambda *a: hit)
    with torch.no_grad():
        got = ti._hitdata(cfg, ir, *lanes)
        want = (hit, ti._generate_hitdata(cfg, ir, hit, lanes[2]))
    _same_hitdata(got, want)


@pytest.mark.card
def test_the_kernels_replay_from_a_cuda_graph(card, counters):
    cfg, ir = _atlas_scene(_ATLASES["mixed"], card)
    idx, o, d = (x.clone() for x in _lanes(cfg, ir, 65536, seed=5))
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.no_grad(), torch.cuda.stream(stream):
        ti._hitdata(cfg, ir, idx, o, d)  # loads the library
        graph = torch.cuda.CUDAGraph()
        with spans.deferred() as taken, torch.cuda.graph(graph,
                                                         stream=stream):
            captured = ti._hitdata(cfg, ir, idx, o, d)
    torch.cuda.current_stream(card).wait_stream(stream)
    assert taken == {"hitdata_fused": 1, "hitdata_tri_launches": 1,
                     "hitdata_material_launches": 1}
    for seed in (6, 7):
        new = _lanes(cfg, ir, 65536, seed=seed)
        for buf, x in zip((idx, o, d), new):
            buf.copy_(x)
        graph.replay()
        spans.add(taken)
        with torch.no_grad():
            _same_hitdata(captured, _eager(cfg, ir, *new))
    assert counters() == (3, 0)


@pytest.mark.card
def test_a_progressive_render_on_the_kernels_equals_the_pytorch_ops(
        card, counters, monkeypatch):
    _, cfg, ir = demo.textured_heightfield_scene(grid=64, res=96,
                                                 device=card)
    r = Renderer(cfg, ir, device=card)
    r.step(2)  # the eager sample, the capture, a replay
    spans.reset(["hitdata_fused", "hitdata_eager",
                 *hitdata_ops.LAUNCHES.values()])
    r.step(3)
    assert counters() == (3 * cfg.max_bounces, 0)
    assert [spans.counter(v) for v in hitdata_ops.LAUNCHES.values()] == [
        3 * cfg.max_bounces] * 2
    monkeypatch.setattr(hitdata_ops, "serves", lambda tensors: False)
    state = ti.init_state(cfg, card)
    with torch.no_grad():
        for _ in range(5):
            state = ti.render_sample(cfg, ir, state, device=card)
    assert counters() == (3 * cfg.max_bounces, 5 * cfg.max_bounces)
    for k in ("passes", "samples", "rng"):
        assert torch.equal(r.state[k], state[k]), k
