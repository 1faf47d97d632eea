"""Image file output: BMP and PNG writers, dependency-free.

Replaces the reference's GDI+ bitmap path (``Image.toBitmap``/``saveBitmap``,
Image.fs:52-90): the reference pins a BGR24 buffer and hands it to
``System.Drawing``; here we emit the files directly — BMP24 with the same
bottom-up row order quirk handled internally, and PNG via zlib (stdlib).

Input is always an ``[H, W, 3]`` uint8 RGB array with row 0 at the top.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_bmp", "write_png", "save_image"]


def _as_rgb_u8(image) -> np.ndarray:
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise TypeError(f"expected uint8 image, got {arr.dtype} "
                        "(tonemap first)")
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {arr.shape}")
    return arr


def write_bmp(path: str, image) -> None:
    """Write a 24-bit uncompressed BMP (the reference's output format,
    Image.fs:88-90).  BMP stores rows bottom-up in BGR order; we flip and
    swap here (the reference does the same flip in toBitmap, Image.fs:69)."""
    arr = _as_rgb_u8(image)
    h, w, _ = arr.shape
    row_bytes = w * 3
    pad = (-row_bytes) % 4
    stride = row_bytes + pad
    image_size = stride * h
    file_size = 14 + 40 + image_size

    bgr = arr[::-1, :, ::-1]  # bottom-up rows, BGR channels
    rows = bgr.reshape(h, row_bytes)
    if pad:
        rows = np.concatenate(
            [rows, np.zeros((h, pad), np.uint8)], axis=1)

    with open(path, "wb") as f:
        f.write(b"BM")
        f.write(struct.pack("<IHHI", file_size, 0, 0, 14 + 40))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0,
                            image_size, 2835, 2835, 0, 0))
        f.write(rows.tobytes())


def write_png(path: str, image) -> None:
    """Write an 8-bit RGB PNG (zlib from the stdlib; no Pillow)."""
    arr = _as_rgb_u8(image)
    h, w, _ = arr.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    # filter byte 0 (None) per scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)],
        axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def save_image(path: str, image) -> None:
    """Dispatch on extension: .bmp or .png."""
    lower = path.lower()
    if lower.endswith(".bmp"):
        write_bmp(path, image)
    elif lower.endswith(".png"):
        write_png(path, image)
    else:
        raise ValueError(f"unsupported image format: {path} (use .bmp/.png)")
