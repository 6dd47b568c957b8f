"""Minimal baseline JPEG decoder (pure numpy/stdlib, clean-room from the
ITU-T T.81 spec).  The port's copy of ``elevenrender_tpu/utils/jpeg.py``.

Gives `load_texture --path x.jpg` the stb_image coverage the reference
gets for free (Texture.cpp:9-38) without external
deps.  Scope: baseline + extended sequential DCT (SOF0/SOF1), 8-bit,
grayscale or YCbCr with any sampling factors up to 2x2 (4:4:4, 4:2:2,
4:2:0), restart intervals, byte stuffing.  Progressive (SOF2) and
arithmetic coding are rejected with a clear error.

Decode pipeline per the spec: marker parse -> per-MCU Huffman decode
(DC diff + AC run/size) -> dequantize -> dezigzag -> 8x8 IDCT
(separable orthonormal DCT-III as a matrix product) -> plane assembly ->
chroma upsample -> YCbCr->RGB (JFIF full-range).
"""

from __future__ import annotations

import struct

import numpy as np

# Zigzag order: index z -> (row, col) of the 8x8 block (T.81 Figure 5).
_ZZ = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# Orthonormal 8-point DCT-II matrix; IDCT(block) = A.T @ block @ A.
_A = np.zeros((8, 8), np.float32)
for _u in range(8):
    _c = np.sqrt(0.125) if _u == 0 else 0.5
    for _x in range(8):
        _A[_u, _x] = _c * np.cos((2 * _x + 1) * _u * np.pi / 16.0)


class _BitReader:
    """MSB-first bit reader over the entropy-coded segment, handling
    0xFF00 byte stuffing; stops at any real marker (T.81 B.1.1.5)."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0
        self.marker = None

    def _fill(self):
        d = self.data
        b = d[self.pos] if self.pos < len(d) else None
        if b is None:
            raise ValueError("JPEG: truncated entropy data")
        self.pos += 1
        if b == 0xFF:
            nxt = d[self.pos] if self.pos < len(d) else 0xD9
            if nxt == 0x00:
                self.pos += 1
            else:  # a real marker terminates the segment
                self.marker = nxt
                b = 0  # pad with zero bits (spec allows it at segment end)
                self.pos -= 1
        self.acc = (self.acc << 8) | b
        self.nbits += 8

    def bits(self, n: int) -> int:
        while self.nbits < n:
            self._fill()
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        return v

    def bit(self) -> int:
        return self.bits(1)

    def align_restart(self):
        """Consume a restart marker (FFD0-FFD7) and realign."""
        self.acc = 0
        self.nbits = 0
        d = self.data
        while self.pos + 1 < len(d):
            if d[self.pos] == 0xFF and 0xD0 <= d[self.pos + 1] <= 0xD7:
                self.pos += 2
                self.marker = None
                return
            self.pos += 1
        raise ValueError("JPEG: missing restart marker")


def _build_huffman(counts, symbols):
    """(code, length) -> symbol map per T.81 C.2 canonical code assign."""
    table = {}
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            table[(ln, code)] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return table


def _huff_decode(br: _BitReader, table) -> int:
    code = 0
    for ln in range(1, 17):
        code = (code << 1) | br.bit()
        sym = table.get((ln, code))
        if sym is not None:
            return sym
    raise ValueError("JPEG: invalid Huffman code")


def _extend(v: int, t: int) -> int:
    """DC/AC magnitude category decode (T.81 F.12)."""
    return v - (1 << t) + 1 if t and v < (1 << (t - 1)) else v


def decode_jpeg(data: bytes) -> np.ndarray:
    """bytes -> [H, W, C] uint8 (C = 1 grayscale or 3 RGB).

    Raises ValueError on corrupt/truncated/unsupported input."""
    try:
        return _decode_jpeg(data)
    except (IndexError, struct.error, KeyError) as e:
        raise ValueError(f"JPEG: corrupt or truncated stream ({e})") from e


def _decode_jpeg(data: bytes) -> np.ndarray:
    if len(data) < 4 or data[0:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (missing SOI)")
    pos = 2
    qt = {}          # id -> [64] int quant table (natural order)
    huff = {}        # (class, id) -> code table
    comps = None     # [(id, h, v, tq)]
    H = W = 0
    restart = 0
    scan = None

    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError("JPEG: marker expected")
        # 0xFF fill bytes before a marker are legal padding (T.81
        # B.1.1.2) — skip them, or the 0xFF would be read as a marker
        # with a bogus length that derails the whole parse.
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1
        m = data[pos + 1]
        pos += 2
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        if m == 0xD9:  # EOI
            break
        (seglen,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + seglen]
        if m == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                if pq:
                    q = np.frombuffer(seg[p:p + 128], ">u2").astype(np.int32)
                    p += 128
                else:
                    q = np.frombuffer(seg[p:p + 64], np.uint8).astype(np.int32)
                    p += 64
                qt[tq] = q
        elif m in (0xC0, 0xC1):  # SOF0/1: baseline / extended sequential
            prec, H, W, nc = seg[0], *struct.unpack(">HH", seg[1:5]), seg[5]
            if prec != 8:
                raise ValueError("JPEG: only 8-bit precision supported")
            comps = []
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i], seg[7 + 3 * i], seg[8 + 3 * i]
                comps.append((cid, hv >> 4, hv & 15, tq))
        elif m in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                   0xCD, 0xCE, 0xCF):
            raise ValueError("JPEG: only baseline/extended sequential "
                             f"supported (SOF marker 0x{m:02x})")
        elif m == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = list(seg[p + 1:p + 17])
                n = sum(counts)
                symbols = list(seg[p + 17:p + 17 + n])
                huff[(tc, th)] = _build_huffman(counts, symbols)
                p += 17 + n
        elif m == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", seg[0:2])
        elif m == 0xDA:  # SOS
            ns = seg[0]
            scan = []
            for i in range(ns):
                cs, tdta = seg[1 + 2 * i], seg[2 + 2 * i]
                scan.append((cs, tdta >> 4, tdta & 15))
            pos += seglen
            break  # entropy data follows
        pos += seglen

    if comps is None or scan is None:
        raise ValueError("JPEG: missing SOF/SOS")
    if len(scan) != len(comps):
        # Baseline sequential may legally split components over several
        # scans (non-interleaved); this decoder only implements the
        # single interleaved scan — decoding the first scan with
        # interleaved MCU geometry would silently garble the image.
        raise ValueError("JPEG: multi-scan (non-interleaved) baseline "
                         "not supported")

    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux = -(-W // (8 * hmax))
    mcuy = -(-H // (8 * vmax))

    # Per-component block planes (MCU-padded).
    planes = {c[0]: np.zeros((mcuy * c[2] * 8, mcux * c[1] * 8), np.float32)
              for c in comps}
    cinfo = {c[0]: c for c in comps}

    br = _BitReader(data, pos)
    pred = {c[0]: 0 for c in comps}
    mcu_count = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and mcu_count and mcu_count % restart == 0:
                br.align_restart()
                pred = {c[0]: 0 for c in comps}
            for cs, td, ta in scan:
                _, ch, cv, tq = cinfo[cs]
                q = qt[tq]
                for by in range(cv):
                    for bx in range(ch):
                        zz = np.zeros(64, np.int32)
                        t = _huff_decode(br, huff[(0, td)])
                        diff = _extend(br.bits(t), t) if t else 0
                        pred[cs] += diff
                        zz[0] = pred[cs]
                        k = 1
                        while k < 64:
                            rs = _huff_decode(br, huff[(1, ta)])
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r == 15:  # ZRL
                                    k += 16
                                    continue
                                break  # EOB
                            k += r
                            if k > 63:
                                raise ValueError("JPEG: AC index overflow")
                            zz[k] = _extend(br.bits(s), s)
                            k += 1
                        blk = np.zeros(64, np.float32)
                        blk[_ZZ] = (zz * q).astype(np.float32)
                        blk = blk.reshape(8, 8)
                        px = _A.T @ blk @ _A + 128.0
                        y0 = (my * cv + by) * 8
                        x0 = (mx * ch + bx) * 8
                        planes[cs][y0:y0 + 8, x0:x0 + 8] = px
            mcu_count += 1

    # Upsample each component to full resolution (nearest; stb uses a
    # bilinear "fancy" filter — visually close, not bit-identical).
    out = []
    for cid, ch, cv, _ in comps:
        p = planes[cid]
        if ch != hmax or cv != vmax:
            p = np.repeat(np.repeat(p, vmax // cv, axis=0), hmax // ch,
                          axis=1)
        out.append(p[:H, :W])

    if len(out) == 1:
        return np.clip(out[0], 0, 255).astype(np.uint8)[:, :, None]
    if len(out) != 3:
        raise ValueError(f"JPEG: unsupported component count {len(out)}")
    y, cb, cr = out[0], out[1] - 128.0, out[2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def read_jpeg(path: str) -> np.ndarray:
    """Decode a JPEG file -> [H, W, C] float32 in [0, 1]."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read()).astype(np.float32) / 255.0
