"""Crash-safe PNG output (counterpart of raytracer_tpu/utils/png.py).

Encode RGB8, write to a temp file next to the target, then rename
atomically, so a killed progressive render always leaves a valid image
(src/main.rs:764-776).  write_png_atomic takes the C++ writer
(utils/native.py) when its library loads, as the JAX package does; this
module's encoder is the pure-Python path and what the native writer is
tested against.  Inside a unit that utils/tracing records, the phases are
spans: `rt.png.encode` (the Python encoder) and `rt.png.write` (the temp
file written, fsynced and renamed; the native writer's encode too).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from raytracer_tpu_torch.utils import tracing


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png_rgb8(rgb: np.ndarray) -> bytes:
    """Encode an [H, W, 3] uint8 array as PNG bytes (color type 2)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    raw = np.empty((h, 1 + w * 3), dtype=np.uint8)
    raw[:, 0] = 0  # filter type None on every scanline
    raw[:, 1:] = rgb.reshape(h, w * 3)
    return b"".join([
        b"\x89PNG\r\n\x1a\n",
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
        _chunk(b"IEND", b""),
    ])


def decode_png_rgb8(data: bytes) -> np.ndarray:
    """Decode what encode_png_rgb8 writes (RGB8, filter type 0)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, w, h, idat = 8, None, None, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if depth != 8 or ctype != 2:
                raise ValueError("only RGB8 PNGs are supported")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), dtype=np.uint8).reshape(h, 1 + w * 3)
    if np.any(raw[:, 0] != 0):
        raise ValueError("only filter type 0 is supported")
    return raw[:, 1:].reshape(h, w, 3).copy()


def write_png_atomic(path: str, rgb: np.ndarray) -> None:
    """Write [H, W, 3] uint8 to `path` via tmp file + atomic rename."""
    from raytracer_tpu_torch.utils import native

    if native.available():
        with tracing.span("rt.png.write"):
            native.write_png_atomic(path, rgb)
        return
    with tracing.span("rt.png.encode"):
        data = encode_png_rgb8(rgb)
    with tracing.span("rt.png.write"):
        os.replace(write_tmp(path, data), path)


def write_tmp(path: str, data: bytes) -> str:
    """Write `data` to the temp file beside `path`, flushed and fsynced,
    and return the temp file's path (write_png_atomic renames it)."""
    directory = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(directory, f".{os.path.basename(path)}.tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    return tmp


def read_png_rgb8(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png_rgb8(f.read())
