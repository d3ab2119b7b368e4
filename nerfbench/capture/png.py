"""8-bit RGB and RGBA PNGs with the standard library: the writer of the
captures and a reader for the files it writes (one or more IDAT chunks, row
filter 0 only)."""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray) -> None:
    """Write an [H, W, 3] or [H, W, 4] uint8 image, rows unfiltered."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected an [H, W, 3|4] image, got {img.shape}")
    h, w, ch = img.shape
    rows = np.zeros((h, 1 + w * ch), np.uint8)
    rows[:, 1:] = img.reshape(h, -1)
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                            2 if ch == 3 else 6, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """The uint8 [H, W, 3|4] image of a PNG that :func:`write_png` wrote.
    Raises ValueError on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in (2, 6) or interlace:
        raise ValueError(f"{path}: not an 8-bit RGB/RGBA PNG of this writer")
    ch = 3 if color == 2 else 4
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * ch)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows (this reader takes filter 0)")
    return rows[:, 1:].reshape(h, w, ch).copy()
