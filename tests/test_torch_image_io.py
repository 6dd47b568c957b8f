"""PyTorch port, image I/O: the port's copies of the PNG/HDR writers and
the PNG/HDR/BMP/TGA/JPEG decoders on ``tests/test_image_io.py``'s cases,
each held to the JAX package's output exactly (bytes written, arrays
read), and ``Texture.from_file`` against the JAX package's."""

import numpy as np
import pytest
from PIL import Image

from elevenrender_tpu.scene.texture import Texture as JaxTexture
from elevenrender_tpu.utils import image as jax_image
from elevenrender_tpu.utils import jpeg as jax_jpeg
from elevenrender_tpu_torch.scene.texture import Texture
from elevenrender_tpu_torch.utils import image
from elevenrender_tpu_torch.utils import jpeg

from test_image_io import _gradient_img


def _pair(name, *args):
    return getattr(image, name)(*args), getattr(jax_image, name)(*args)


def _png_cases():
    rng = np.random.default_rng(0)
    rgba = np.zeros((4, 4, 4), np.float32)
    rgba[..., 0] = 0.5
    rgba[..., 3] = 1.0
    return {"rgb8": (rng.uniform(0, 1, (13, 17, 3)) * 255).astype(np.uint8),
            "rgba_float": rgba,
            "grey_float": rng.uniform(-0.2, 1.2, (5, 9, 1)).astype(
                np.float32)}


@pytest.mark.parametrize("case", sorted(_png_cases()))
def test_png_write_and_read_equal_jax(tmp_path, case):
    img = _png_cases()[case]
    ours, theirs = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    image.write_png(ours, img)
    jax_image.write_png(theirs, img)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got, ref = _pair("read_png", ours)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype == np.float32


def test_hdr_write_and_read_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = (rng.uniform(0, 1, (8, 12, 3)) ** 2 * 50.0).astype(np.float32)
    img[0, 0] = 0.0
    ours, theirs = str(tmp_path / "a.hdr"), str(tmp_path / "b.hdr")
    image.write_hdr(ours, img)
    jax_image.write_hdr(theirs, img)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got, ref = _pair("read_hdr", ours)
    np.testing.assert_array_equal(got, ref)


def _jpeg_cases(tmp_path):
    rng = np.random.default_rng(3)
    out = []
    for name, img, subs in (
            ("smooth444", _gradient_img(24, 40), "4:4:4"),
            ("smooth420", _gradient_img(33, 35), "4:2:0"),
            ("noise444", rng.uniform(0, 255, (16, 16, 3)).astype(np.uint8),
             "4:4:4")):
        p = str(tmp_path / f"{name}.jpg")
        Image.fromarray(img).save(p, quality=95, subsampling=subs)
        out.append(p)
    p = str(tmp_path / "grey_restart.jpg")
    Image.fromarray(_gradient_img(19, 23)[:, :, 0], mode="L").save(
        p, quality=92, restart_marker_rows=1)
    out.append(p)
    return out


def test_jpeg_decoder_equals_jax(tmp_path):
    for p in _jpeg_cases(tmp_path):
        got, ref = jpeg.read_jpeg(p), jax_jpeg.read_jpeg(p)
        np.testing.assert_array_equal(got, ref, err_msg=p)
        pil = np.asarray(Image.open(p)).astype(np.float32) / 255.0
        assert np.abs(got.reshape(pil.shape) - pil).mean() < 0.06, p


def test_bmp_tga_decoders_equal_jax(tmp_path):
    img = _gradient_img(11, 14)
    files = {"t.bmp": {}, "t.tga": {}, "r.tga": {"compression": "tga_rle"}}
    for name, kw in files.items():
        p = str(tmp_path / name)
        Image.fromarray(img).save(p, **kw)
        reader = "read_bmp" if name.endswith(".bmp") else "read_tga"
        got, ref = _pair(reader, p)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, img.astype(np.float32) / 255.0)
        got, ref = _pair("read_image", p)
        np.testing.assert_array_equal(got, ref)


def test_corrupt_files_raise_as_jax_does(tmp_path):
    img = _gradient_img(12, 12)
    for ext in ("jpg", "bmp", "tga"):
        whole = str(tmp_path / f"ok.{ext}")
        Image.fromarray(img).save(whole)
        blob = open(whole, "rb").read()
        for label, data in (("trunc", blob[:len(blob) // 3]),
                            ("garbage", b"\x00\x01nonsense" * 16)):
            p = str(tmp_path / f"{label}.{ext}")
            with open(p, "wb") as f:
                f.write(data)
            kinds = []
            for reader in (image.read_image, jax_image.read_image):
                with pytest.raises(Exception) as ei:
                    reader(p)
                kinds.append(type(ei.value))
            assert kinds[0] is kinds[1], (p, kinds)


@pytest.mark.parametrize("ext,srgb", [("png", True), ("png", False),
                                      ("jpg", True), ("hdr", False)])
def test_texture_from_file_equals_jax(tmp_path, ext, srgb):
    """Vertical flip, then ** 2.2 when sRGB."""
    img = _gradient_img(9, 13)
    p = str(tmp_path / f"t.{ext}")
    if ext == "hdr":
        image.write_hdr(p, img.astype(np.float32) / 64.0)
    else:
        Image.fromarray(img).save(p)
    got = Texture.from_file(p, srgb=srgb)
    ref = JaxTexture.from_file(p, srgb=srgb)
    assert got.name == ref.name == p
    np.testing.assert_array_equal(got.data, ref.data)
    raw = image.read_image(p)
    np.testing.assert_array_equal(
        got.data, (raw[::-1] ** 2.2 if srgb else raw[::-1]).astype(
            np.float32))
