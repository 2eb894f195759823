"""Framebuffer output. Reference analog: `saveToFile` / PPM P6 writer (SURVEY §2.2).

Device [H,W,3] float in [0,1] → PPM (P6, binary) or PNG (8-bit RGB, written
with zlib + struct alone, so no imaging package is needed).
"""

import struct
import zlib

import numpy as np


def to_u8(img) -> np.ndarray:
    arr = np.asarray(img, np.float64)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_ppm(path: str, img) -> None:
    u8 = to_u8(img)
    h, w, _ = u8.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())


def load_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # P6 header: magic, whitespace-separated w h maxval, single whitespace, raster
    parts = []
    i = 0
    while len(parts) < 4:
        while data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while not data[j : j + 1].isspace():
            j += 1
        parts.append(data[i:j])
        i = j
    assert parts[0] == b"P6", f"not a P6 ppm: {parts[0]!r}"
    w, h, maxv = int(parts[1]), int(parts[2]), int(parts[3])
    i += 1  # single whitespace after maxval
    raster = np.frombuffer(data[i : i + w * h * 3], np.uint8)
    return raster.reshape(h, w, 3).astype(np.float32) / float(maxv)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path: str, img) -> None:
    """8-bit RGB PNG: one IHDR, one zlib IDAT of filter-0 scanlines, IEND."""
    u8 = to_u8(img)
    h, w, _ = u8.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, w * 3)],
                         axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))
