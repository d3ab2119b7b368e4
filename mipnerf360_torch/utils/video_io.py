"""MJPEG-AVI writer, and a structural reader for tests (a copy of
``mipnerf360_tpu/utils/video_io.py``).

The video app writes ``video.mp4`` through imageio where it can; without
ffmpeg it writes an MJPEG AVI instead, which needs nothing but a JPEG
encoder (PIL's) and a RIFF container, and plays in every mainstream player.

Container layout (standard AVI 1.0, single 'vids'/'MJPG' stream):

    RIFF 'AVI '
      LIST 'hdrl'  { avih(56), LIST 'strl' { strh(56), strf(BITMAPINFOHEADER) } }
      LIST 'movi'  { '00dc' <jpeg> ... }   (chunks padded to even length)
      'idx1'       { ('00dc', AVIIF_KEYFRAME, offset-from-'movi', size) ... }
"""
from __future__ import annotations

import io
import struct
from typing import List, Sequence

import numpy as np

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    body = fourcc + payload
    return b"LIST" + struct.pack("<I", len(body)) + body


def write_mjpeg_avi(path: str, frames: Sequence[np.ndarray], fps: int = 30,
                    quality: int = 92) -> str:
    """Write uint8 [H, W, 3] frames as an MJPEG AVI; returns ``path``."""
    from PIL import Image

    assert len(frames) > 0, "no frames"
    h, w = frames[0].shape[:2]
    jpegs = []
    for f in frames:
        assert f.shape[:2] == (h, w), (f.shape, (h, w))
        buf = io.BytesIO()
        Image.fromarray(np.asarray(f, dtype=np.uint8)).save(
            buf, format="JPEG", quality=quality)
        jpegs.append(buf.getvalue())
    n = len(jpegs)
    max_size = max(len(j) for j in jpegs)

    avih = struct.pack(
        "<14I",
        int(1_000_000 // max(1, fps)),   # dwMicroSecPerFrame
        max_size * fps,                  # dwMaxBytesPerSec (upper bound)
        0, _AVIF_HASINDEX, n, 0,
        1,                               # dwStreams
        max_size, w, h, 0, 0, 0, 0)
    strh = struct.pack(
        "<4s4sIHHIIIIIIiI4h",
        b"vids", b"MJPG", 0, 0, 0, 0,
        1, max(1, fps),                  # dwScale / dwRate -> fps
        0, n, max_size,
        -1,                              # dwQuality (the codec's default)
        0, 0, 0, w, h)                   # rcFrame
    strf = struct.pack(                  # BITMAPINFOHEADER
        "<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)

    movi_chunks: List[bytes] = []
    idx_entries: List[bytes] = []
    offset = 4  # idx1 offsets are measured from the 'movi' fourcc
    for j in jpegs:
        c = _chunk(b"00dc", j)
        idx_entries.append(struct.pack(
            "<4sIII", b"00dc", _AVIIF_KEYFRAME, offset, len(j)))
        offset += len(c)
        movi_chunks.append(c)

    hdrl = _list(b"hdrl",
                 _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi = _list(b"movi", b"".join(movi_chunks))
    idx1 = _chunk(b"idx1", b"".join(idx_entries))
    riff_body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body)
    return path


def read_mjpeg_avi(path: str) -> List[np.ndarray]:
    """Structural reader: walk the RIFF tree, decode every 00dc JPEG (for
    tests, and for inspecting written videos)."""
    from PIL import Image

    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI ", data[:12]

    frames: List[np.ndarray] = []

    def walk(buf: bytes):
        pos = 0
        while pos + 8 <= len(buf):
            fourcc = buf[pos:pos + 4]
            size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
            payload = buf[pos + 8:pos + 8 + size]
            if fourcc == b"LIST":
                walk(payload[4:])
            elif fourcc == b"00dc":
                frames.append(np.asarray(Image.open(io.BytesIO(payload))))
            pos += 8 + size + (size % 2)

    walk(data[12:])
    return frames
