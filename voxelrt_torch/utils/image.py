"""Image output: the headless framebuffer boundary (the PyTorch port of
voxelrt/utils/image.py). Buffers are (W, H, 3) with v=0 at the bottom (GL
convention); PNG rows run top-down. PNGs are encoded here, in Python,
whether or not the native runtime is built (utils/native.py)."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def to_uint8_rows(img_wh3: np.ndarray) -> np.ndarray:
    """(W, H, 3) float [0,1], v-up  ->  (H, W, 3) uint8 rows top-down."""
    img = np.clip(np.asarray(img_wh3, dtype=np.float32), 0.0, 1.0)
    img = (img * 255.0 + 0.5).astype(np.uint8)
    return img.transpose(1, 0, 2)[::-1]


def encode_png(rgb_topdown: np.ndarray, w: int, h: int, level: int = 6) -> bytes:
    """8-bit RGB PNG bytes from (h, w, 3) uint8 rows, top-down."""
    raw = b"".join(b"\x00" + rgb_topdown[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def write_png(path: str, img_wh3: np.ndarray) -> str:
    rows = np.ascontiguousarray(to_uint8_rows(img_wh3))
    h, w, _ = rows.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(encode_png(rows, w, h))
    return path


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB(A) PNG back to (W, H, 3) float v-up (for golden
    tests). Uses PIL when available, else a minimal decoder for our own
    writer's output."""
    try:
        from PIL import Image

        arr = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
    except ImportError:
        arr = _read_png_minimal(path).astype(np.float32) / 255.0
    return arr[::-1].transpose(1, 0, 2)


def _read_png_minimal(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bits, ctype = struct.unpack(">IIBB", payload[:10])
            if bits != 8 or ctype != 2:
                raise ValueError("minimal reader: 8-bit RGB only")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    out = np.zeros((h, w, 3), np.uint8)
    prev = np.zeros(w * 3, np.int32)
    for y in range(h):
        row = raw[y * stride : (y + 1) * stride]
        filt, body = row[0], np.frombuffer(row[1:], np.uint8).astype(np.int32)
        if filt == 0:
            cur = body
        elif filt == 1:  # Sub: a running sum of each channel along the row
            cur = (np.cumsum(body.reshape(w, 3), axis=0) & 0xFF).reshape(-1)
        elif filt == 2:
            cur = (body + prev) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        prev = cur
        out[y] = cur.reshape(w, 3).astype(np.uint8)
    return out
