"""PyTorch port, the showcase applications on the CPU against the JAX
package: ``elevenrender_tpu_torch/denoise_showcase.py`` (the port of
``scripts/denoise_showcase.py``) and ``elevenrender_tpu_torch/demo.py``
(the port of ``scripts/demo.py``).

Neither JAX script is run (they import jax at module level); each is
rebuilt from the JAX package's functions on the same inputs.

(iv) The denoise showcase on one checkpoint (config 5's scene in
     miniature, 64x64, 2 samples: three levels of the multi-scale
     NL-means): the port's denoised image against
     ``elevenrender_tpu.render.denoise.nlm_denoise_ms`` of the same
     passes to rtol 1e-4 / atol 1e-5 on >= 99.9% of values (the
     denoiser tests' tolerance), and the two PNGs within 1/255.
(v)  The demo at res 16, 2 samples: each of its six PNGs against the JAX
     ``Renderer``'s ``save_pass`` of the same scene (``tests/scenes.py``
     ``cornell_scene`` and ``heightfield_scene(grid=96)``, native), within
     1/255 on >= 99% of pixels.
"""

import torch_threads  # noqa: F401  (first: torch's threads a worker)

import jax.numpy as jnp
import numpy as np
import pytest

from elevenrender_tpu.render.denoise import nlm_denoise_ms as jax_nlm
from elevenrender_tpu.render.renderer import Renderer as JaxRenderer
from elevenrender_tpu.utils.image import write_png as jax_write_png
from elevenrender_tpu_torch import demo, denoise_showcase
from elevenrender_tpu_torch import render_config5 as rc5
from elevenrender_tpu_torch.scene import demo as demo_scenes
from elevenrender_tpu_torch.utils.image import read_png

from scenes import cornell_scene, heightfield_scene

RES = 64
ONE = 1.0 / 255 + 1e-6


def test_the_denoise_showcase_matches_jax(tmp_path, monkeypatch, capsys):
    _, cfg, ir = demo_scenes.textured_heightfield_scene(
        grid=8, res=RES, compat=False, device="cpu")
    ckpt = str(tmp_path / "c5")
    rc5.render(cfg, ir, 2, 2, ckpt, resume=False, device="cpu")
    out, raw = tmp_path / "denoised.png", tmp_path / "denoised.npy"
    monkeypatch.setenv("CKPT", f"{ckpt}.npz")
    monkeypatch.setenv("OUT", str(out))
    denoise_showcase.main(["--device", "cpu", "--raw", str(raw)])
    assert f"{out}: {RES}x{RES} at 2 spp, denoised" in capsys.readouterr().out
    got = np.load(raw)

    passes = np.load(f"{ckpt}.npz")["passes"]
    beauty, albedo, normal = (passes[i, :, :3].reshape(RES, RES, 3)
                              for i in range(3))
    want = np.asarray(jax_nlm(jnp.asarray(beauty), jnp.asarray(normal),
                              jnp.asarray(albedo)))
    assert got.shape == want.shape == (RES, RES, 3)
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).mean()
    assert close >= 0.999, close
    assert np.abs(got - beauty).max() > 1e-3  # it denoised something
    img = np.clip(np.abs(np.concatenate(
        [want, np.ones((RES, RES, 1), np.float32)], -1)), 0.0, None) \
        ** (1 / 2.2)
    jax_write_png(str(tmp_path / "jax.png"), np.clip(img, 0.0, 1.0))
    assert np.abs(read_png(str(out))
                  - read_png(str(tmp_path / "jax.png"))).max() <= ONE


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("demo")
    scenes = demo.main([str(outdir), "16", "2", "--device", "cpu"])
    return outdir, scenes


@pytest.mark.parametrize("scene", ["cornell", "heightfield"])
def test_the_demo_matches_the_jax_renderer(demo_run, scene, tmp_path):
    outdir, scenes = demo_run
    assert scenes[scene]["s"] > 0
    if scene == "cornell":
        _, config, ir = cornell_scene(res=16, spp=2, compat=False)
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ELEVENRT_NATIVE", "0")  # the numpy build, bit-equal
            _, config, ir = heightfield_scene(grid=96, res=16, spp=2,
                                              compat=False)
    r = JaxRenderer(config, ir)
    r.step(2)
    for name, suffix in (("beauty", ""), ("normal", "_normal"),
                         ("denoise", "_denoised")):
        path = tmp_path / f"{scene}{suffix}.png"
        r.save_pass(name, str(path))
        got = read_png(str(outdir / f"{scene}{suffix}.png"))
        want = read_png(str(path))
        assert got.shape == want.shape == (16, 16, 4), name
        near = (np.abs(got - want) <= ONE).all(axis=-1).mean()
        assert near >= 0.99, (scene, name, near)
        assert got[..., :3].max() > 0, (scene, name)


def test_the_demo_writes_six_pngs_and_counts_its_launches(demo_run):
    """Six files, and each scene's traversal launches (the plain walker on
    the CPU launches no kernel)."""
    outdir, scenes = demo_run
    assert set(scenes) == {"cornell", "heightfield"}
    assert all(s["launches"] == [0, 0] for s in scenes.values())
    assert all(s["finite"] is True for s in scenes.values())
    assert sorted(p.name for p in outdir.iterdir()) == sorted(
        f"{n}{s}.png" for n in scenes for s in ("", "_normal", "_denoised"))
