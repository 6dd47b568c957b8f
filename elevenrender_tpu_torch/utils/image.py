"""Minimal PNG/PPM image IO (no external deps beyond numpy/stdlib).
The port's copy of ``elevenrender_tpu/utils/image.py``.

Replaces the reference's stb_image / stb_image_write usage
(Texture.cpp:8-38, CommandManager.cpp:403-422).  PNG encode/decode is
implemented directly over zlib — enough for RGB(A) 8-bit assets and
outputs; HDR float inputs arrive over the wire as raw float buffers.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H, W, C] uint8 (C in 1,2,3,4) or float in [0,1]."""
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Decode 8-bit PNG -> [H, W, C] float32 in [0,1].  Supports color
    types 0/2/4/6, bit depth 8, no interlace."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = ct = 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ct, comp, filt, inter = struct.unpack(">IIBBBBB", body)
            assert depth == 8 and inter == 0, "unsupported PNG variant"
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    c = {0: 1, 2: 3, 4: 2, 6: 4}[ct]
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft = raw[y * (stride + 1)]
        line = np.frombuffer(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)],
                             np.uint8).astype(np.int32)
        if ft == 0:
            cur = line
        elif ft == 2:  # up
            cur = (line + prev) & 0xFF
        else:  # sub/avg/paeth need sequential scan
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - c] if x >= c else 0
                b = int(prev[x])
                cc = int(prev[x - c]) if x >= c else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) // 2
                else:  # paeth
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
        prev = out[y]
    return (out.reshape(h, w, c).astype(np.float32)) / 255.0


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write a Radiance RGBE (.hdr) image; img: [H, W, 3] float32 HDR."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w), np.float32)
    nz = maxc > 1e-32
    m, e = np.frexp(np.where(nz, maxc, 1.0))
    exp[nz] = e[nz]
    mant[nz] = m[nz]
    scale = np.where(nz, mant * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())  # flat (non-RLE) scanlines


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance RGBE (.hdr) image -> [H, W, 3] float32.

    Supports flat and adaptive-RLE scanlines (the stb-compatible format
    the reference reads via stbi_loadf, Texture.cpp:26)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    pos = data.index(b"\n\n") + 2 if b"\n\n" in data[:500] else 0
    if pos == 0:  # headers separated by single blank line variants
        pos = data.index(b"\n-Y")
        pos = data.rindex(b"\n", 0, pos) + 1
    dim_end = data.index(b"\n", pos)
    dims = data[pos:dim_end].split()
    assert dims[0] == b"-Y" and dims[2] == b"+X", "unsupported orientation"
    h, w = int(dims[1]), int(dims[3])
    pos = dim_end + 1

    rgbe = np.zeros((h, w, 4), np.uint8)
    buf = memoryview(data)
    for y in range(h):
        if pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2 \
                and (data[pos + 2] << 8 | data[pos + 3]) == w:
            pos += 4  # adaptive RLE scanline, per-component
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, c] = data[pos]
                        x += count - 128
                        pos += 1
                    else:  # literal
                        rgbe[y, x:x + count, c] = np.frombuffer(
                            buf[pos:pos + count], np.uint8)
                        x += count
                        pos += count
        else:  # flat scanline
            row = np.frombuffer(buf[pos:pos + w * 4], np.uint8)
            rgbe[y] = row.reshape(w, 4)
            pos += w * 4

    # stb convention: value = c * 2^(e-136), zero when e == 0.
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def read_bmp(path: str) -> np.ndarray:
    """Decode an uncompressed BMP (24/32-bit, BITMAPINFOHEADER) ->
    [H, W, C] float32 in [0, 1] (stb coverage, Texture.cpp:9-38)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    (off,) = struct.unpack("<I", data[10:14])
    (hsz,) = struct.unpack("<I", data[14:18])
    if hsz < 40:
        raise ValueError("BMP: unsupported core header")
    w, h = struct.unpack("<ii", data[18:26])
    planes, bpp = struct.unpack("<HH", data[26:30])
    (comp,) = struct.unpack("<I", data[30:34])
    if comp not in (0, 3) or bpp not in (24, 32):
        raise ValueError(f"BMP: unsupported bpp={bpp} compression={comp}")
    if comp == 3:
        # BI_BITFIELDS carries explicit channel masks; this decoder
        # assumes the standard BGRA layout — honor it only when the
        # masks actually say so, rather than silently swapping channels.
        # Masks sit at absolute offset 54 both for the classic
        # 40-byte-header+appended-masks layout and for V2+ headers that
        # embed them.
        if len(data) < 66:
            raise ValueError("BMP: BITFIELDS header truncated")
        rm, gm, bm = struct.unpack("<III", data[54:66])
        if (rm, gm, bm) != (0x00FF0000, 0x0000FF00, 0x000000FF):
            raise ValueError("BMP: non-BGRA BITFIELDS masks unsupported "
                             f"(r=0x{rm:08x} g=0x{gm:08x} b=0x{bm:08x})")
    flip = h > 0  # positive height = bottom-up rows
    h = abs(h)
    c = bpp // 8
    stride = (w * c + 3) & ~3
    if off + stride * h > len(data):
        raise ValueError("BMP: truncated pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, off)
    img = rows.reshape(h, stride)[:, :w * c].reshape(h, w, c)
    if flip:
        img = img[::-1]
    img = img[..., [2, 1, 0, 3] if c == 4 else [2, 1, 0]]  # BGR(A)->RGB(A)
    return img.astype(np.float32) / 255.0


def read_tga(path: str) -> np.ndarray:
    """Decode a TGA (types 2/10 truecolor incl. RLE, 3 grayscale) ->
    [H, W, C] float32 in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 18:
        raise ValueError("TGA: truncated header")
    idlen, cmap_type, img_type = data[0], data[1], data[2]
    w, h = struct.unpack("<HH", data[12:16])
    bpp, desc = data[16], data[17]
    if cmap_type != 0 or img_type not in (2, 3, 10):
        raise ValueError(f"TGA: unsupported type {img_type}")
    if bpp not in (8, 24, 32) or (img_type == 3) != (bpp == 8):
        raise ValueError(f"TGA: unsupported bpp {bpp}")
    c = bpp // 8
    pos = 18 + idlen
    n = w * h
    if img_type == 10:  # RLE
        out = np.empty((n, c), np.uint8)
        i = 0
        while i < n:
            if pos >= len(data):
                raise ValueError("TGA: truncated RLE data")
            hdr = data[pos]
            pos += 1
            cnt = (hdr & 0x7F) + 1
            if hdr & 0x80:  # run packet
                out[i:i + cnt] = np.frombuffer(data, np.uint8, c, pos)
                pos += c
            else:  # raw packet
                out[i:i + cnt] = np.frombuffer(
                    data, np.uint8, c * cnt, pos).reshape(cnt, c)
                pos += c * cnt
            i += cnt
        img = out.reshape(h, w, c)
    else:
        if pos + n * c > len(data):
            raise ValueError("TGA: truncated pixel data")
        img = np.frombuffer(data, np.uint8, n * c, pos).reshape(h, w, c)
    if not (desc & 0x20):  # bit 5 clear = bottom-up origin
        img = img[::-1]
    if c >= 3:
        img = img[..., [2, 1, 0, 3] if c == 4 else [2, 1, 0]]  # BGR->RGB
    return img.astype(np.float32) / 255.0


def read_image(path: str) -> np.ndarray:
    """Dispatch by extension — PNG, Radiance HDR, baseline JPEG, BMP and
    TGA natively (the formats the reference reaches through stb_image,
    Texture.cpp:9-38); PIL as a last-resort fallback for anything else."""
    low = path.lower()
    if low.endswith(".png"):
        return read_png(path)
    if low.endswith(".hdr") or low.endswith(".rgbe"):
        return read_hdr(path)
    if low.endswith(".jpg") or low.endswith(".jpeg"):
        from .jpeg import read_jpeg
        return read_jpeg(path)
    if low.endswith(".bmp"):
        return read_bmp(path)
    if low.endswith(".tga"):
        return read_tga(path)
    try:
        from PIL import Image
        arr = np.asarray(Image.open(path)).astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr
    except ImportError as e:
        raise ValueError(f"unsupported image format: {path}") from e
