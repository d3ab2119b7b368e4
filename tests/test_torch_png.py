"""The port's PNG reader and writer (``mipnerf360_torch/utils/png.py``) and
the row unfilter (``native.png_unfilter``: the g++ build and its NumPy
reference) against PIL, for every filter type and every colour type the
reader takes."""
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from mipnerf360_torch import native
from mipnerf360_torch.utils import png

# colour type -> (PIL mode, samples per pixel)
COLOURS = {0: ("L", 1), 4: ("LA", 2), 2: ("RGB", 3), 6: ("RGBA", 4)}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind, cur, prev, bpp):
    """PNG encoder side: filter one row of bytes (ints) with ``kind``."""
    out = []
    for x, v in enumerate(cur):
        a = cur[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
        out.append((v - pred) % 256)
    return [kind] + out


def _encode(path, img, colour, kinds):
    """Write ``img`` as a PNG whose row y is filtered with kinds[y % len]."""
    h, w = img.shape[:2]
    bpp = COLOURS[colour][1]
    rows = img.reshape(h, w * bpp).astype(int).tolist()
    raw, prev = [], [0] * (w * bpp)
    for y, row in enumerate(rows):
        raw += _filter_row(kinds[y % len(kinds)], row, prev, bpp)
        prev = row

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(png.SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                           0, 0, 0)))
        f.write(chunk(b"tEXt", b"Comment\x00ignored"))
        data = zlib.compress(bytes(raw))
        f.write(chunk(b"IDAT", data[:7]))           # two IDAT chunks
        f.write(chunk(b"IDAT", data[7:]))
        f.write(chunk(b"IEND", b""))


def _image(colour, h=9, w=11, seed=0):
    bpp = COLOURS[colour][1]
    img = np.random.default_rng(seed).integers(0, 256, (h, w, bpp), np.uint8)
    return img[..., 0] if bpp == 1 else img


@pytest.mark.parametrize("colour", sorted(COLOURS))
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_decoder_matches_pil_for_each_filter(tmp_path, colour, kind):
    img = _image(colour, seed=kind)
    path = str(tmp_path / "x.png")
    _encode(path, img, colour, [kind])
    want = np.array(Image.open(path))
    np.testing.assert_array_equal(want, img)
    got = png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("colour", sorted(COLOURS))
def test_decoder_matches_pil_with_mixed_filters(tmp_path, colour):
    img = _image(colour, h=23, w=17, seed=5)
    path = str(tmp_path / "x.png")
    _encode(path, img, colour, [4, 0, 3, 1, 2, 4, 3])
    np.testing.assert_array_equal(png.read_png(path),
                                  np.array(Image.open(path)))
    # and a file PIL wrote with its own choice of filters
    Image.fromarray(img, COLOURS[colour][0]).save(path)
    np.testing.assert_array_equal(png.read_png(path),
                                  np.array(Image.open(path)))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_native_unfilter_matches_numpy_reference(bpp):
    assert native.native_available()
    rng = np.random.default_rng(bpp)
    rows = rng.integers(0, 256, (40, 1 + 13 * bpp), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, 40)
    got = native.png_unfilter(rows, bpp)
    np.testing.assert_array_equal(got, native._png_unfilter_np(rows, bpp))
    rows[7, 0] = 5
    for fn in (native.png_unfilter, native._png_unfilter_np):
        with pytest.raises(ValueError, match="row 7: unknown filter type 5"):
            fn(rows, bpp)


def test_load_image_without_pil_equals_pil(tmp_path, monkeypatch):
    img = _image(6, seed=9)
    path = str(tmp_path / "x.png")
    Image.fromarray(img).save(path)
    want = png.load_image(path)
    assert want.dtype == np.float32
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    assert not png.pil_available()
    np.testing.assert_array_equal(png.load_image(path), want)


@pytest.mark.parametrize("what", ["jpeg", "palette", "16-bit", "interlaced"])
def test_what_only_pil_reads_raises_import_error(tmp_path, monkeypatch, what):
    path = str(tmp_path / "x.img")
    img = _image(2)
    if what == "jpeg":
        Image.fromarray(img).save(path, format="JPEG")
    elif what == "palette":
        Image.fromarray(img).convert("P").save(path, format="PNG")
    elif what == "16-bit":
        Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(
            path, format="PNG")
    else:
        # PIL writes no interlaced PNG: set the IHDR flag of a plain one
        png.save_png(path, img)
        data = bytearray(open(path, "rb").read())
        data[28] = 1                                  # interlace method
        data[29:33] = struct.pack(
            ">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
        open(path, "wb").write(bytes(data))
    with pytest.raises(ImportError, match="PIL"):
        png.read_png(path)
    if what != "interlaced":
        assert png.load_image(path).shape[:2] == img.shape[:2]  # PIL reads it
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        png.load_image(path)


def test_damaged_png_raises_value_error(tmp_path):
    path = str(tmp_path / "x.png")
    png.save_png(path, _image(2))
    data = bytearray(open(path, "rb").read())
    data[40] ^= 0xFF                                  # inside the IDAT data
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(path)
    open(path, "wb").write(bytes(data[:30]))
    with pytest.raises(ValueError, match="truncated"):
        png.read_png(path)


@pytest.mark.parametrize("shape", [(5, 7, 3), (5, 7, 4), (64, 33, 4)])
def test_writer_round_trips_through_both_readers(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    png.save_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(png.read_png(path), img)
