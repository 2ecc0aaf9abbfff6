"""Image output: gamma mapping, vertical flip, PPM/PNG writers (PyTorch
port of smallpt_tpu/utils/image.py, numpy only).

The reference's output path (smallpt.cpp:52,125-142): toInt applies clamp +
gamma 2.2 + rounding to 8-bit, flipY reverses rows, writeImage emits ASCII
`P3` PPM.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_int(x: np.ndarray) -> np.ndarray:
    """Gamma 2.2 + [0,1] clamp to 8-bit, int(pow(clamp(x),1/2.2)*255+.5)
    (smallpt.cpp:52)."""
    return (np.power(np.clip(x, 0.0, 1.0), 1.0 / 2.2) * 255.0 + 0.5).astype(
        np.uint8)


def flip_y(img: np.ndarray) -> np.ndarray:
    """Vertical flip (smallpt.cpp:125-134)."""
    return img[::-1]


def _to_bytes(img, flip: bool) -> np.ndarray:
    """Writers take LINEAR (H,W,3) float and gamma-map via to_int; an
    integer array is treated as already tone-mapped 8-bit."""
    arr = np.asarray(img)
    if np.issubdtype(arr.dtype, np.integer):
        data = np.clip(arr, 0, 255).astype(np.uint8)
        return flip_y(data) if flip else data
    data = arr.astype(np.float32)
    if flip:
        data = flip_y(data)
    return to_int(data)


def write_ppm(path: str, img, flip: bool = True) -> None:
    """ASCII P3 PPM matching writeImage (smallpt.cpp:136-142). img: (H,W,3)
    linear float; flipped + gamma-mapped like the reference's save path."""
    b = _to_bytes(img, flip)
    h, w = b.shape[:2]
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write(" ".join(str(v) for v in b.reshape(-1).tolist()))
        f.write(" ")


def write_ppm_binary(path: str, img, flip: bool = True) -> None:
    """Binary P6 PPM (fast path for large frames)."""
    b = _to_bytes(img, flip)
    h, w = b.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(b.tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Read P3/P6 PPM back to uint8 (H,W,3)."""
    with open(path, "rb") as f:
        raw = f.read()
    parts = raw.split(maxsplit=4)
    magic = parts[0]
    w, h = int(parts[1]), int(parts[2])
    if magic == b"P6":
        return np.frombuffer(parts[4], dtype=np.uint8,
                             count=w * h * 3).reshape(h, w, 3)
    if magic == b"P3":
        vals = np.array(parts[4].split(), dtype=np.uint8)
        return vals[: w * h * 3].reshape(h, w, 3)
    raise ValueError(f"not a PPM: {magic!r}")


def write_png(path: str, img, flip: bool = True) -> None:
    """Minimal dependency-free PNG writer (8-bit RGB), via zlib."""
    rgb = _to_bytes(img, flip)
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
