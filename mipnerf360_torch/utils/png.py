"""Images on disk without an imaging library: a PNG reader and writer on the
standard library (``zlib``, ``struct``) and NumPy.

The data loaders read images through :func:`load_image`. Where PIL imports
it reads them, so the port's arrays are exactly the JAX package's (whose
loaders use PIL); elsewhere :func:`read_png` decodes non-interlaced 8-bit
PNGs of colour types grey, grey + alpha, RGB and RGBA, with all five row
filters (``native.png_unfilter``). Anything else, JPEG included, needs PIL
and raises ImportError.

The apps write their images with :func:`save_png`, which needs nothing but
the standard library.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (grey, RGB, grey + alpha, RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _needs_pil(path: str, what: str) -> ImportError:
    return ImportError(
        f"{path}: {what}; reading it needs PIL (Pillow), which is not "
        "installed (without it only 8-bit non-interlaced PNGs are read)")


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file into what ``np.array(PIL.Image.open(path))`` gives
    for it: uint8 [H, W] for grey, [H, W, 2], [H, W, 3] or [H, W, 4] for
    grey + alpha, RGB and RGBA. Raises ImportError for what only PIL reads
    (another format, a palette, 1-, 2-, 4- or 16-bit samples, interlacing)
    and ValueError for a damaged file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise _needs_pil(path, "not a PNG file")
    pos, header, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise _needs_pil(path, f"PNG of bit depth {depth}, colour type "
                               f"{colour}")
    if interlace:
        raise _needs_pil(path, "interlaced PNG")
    if compression or filtering:
        raise ValueError(f"{path}: unknown PNG compression {compression} or "
                         f"filter method {filtering}")
    ch = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected "
                         f"{h * (1 + w * ch)} for {w}x{h}x{ch}")
    from ..native import png_unfilter

    img = png_unfilter(raw.reshape(h, 1 + w * ch), ch)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def pil_available() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def load_image(path: str) -> np.ndarray:
    """An image file as float32 in [0, 1]: ``np.array(Image.open(f),
    dtype=np.float32) / 255`` through PIL where it imports, else through
    :func:`read_png`."""
    if pil_available():
        from PIL import Image

        with open(path, "rb") as f:
            return np.array(Image.open(f), dtype=np.float32) / 255.0
    return read_png(path).astype(np.float32) / 255.0


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, img_u8: np.ndarray):
    """Write an [H, W, 3] or [H, W, 4] uint8 image as an 8-bit RGB or RGBA
    PNG, with the standard library only (one IDAT chunk, no row filters)."""
    img = np.ascontiguousarray(img_u8, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected an [H, W, 3] or [H, W, 4] image, got "
                         f"{img.shape}")
    h, w, ch = img.shape
    rows = np.zeros((h, 1 + w * ch), np.uint8)   # filter type 0 per row
    rows[:, 1:] = img.reshape(h, -1)
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                            2 if ch == 3 else 6, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
