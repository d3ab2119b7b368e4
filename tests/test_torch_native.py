"""Port parity for the batch stream: the port's native batcher
(``mipnerf360_torch/native``, g++ build and NumPy path) against the JAX
package's, bit for bit, and the port's ``RayDataset`` batch stream against
the JAX package's."""
import numpy as np
import pytest

from mipnerf360_torch import native as tnative
from mipnerf360_torch.config import DataConfig
from mipnerf360_torch.data import get_dataset as t_get_dataset
from mipnerf360_torch.ops import _build
from mipnerf360_tpu import native as jnative
from mipnerf360_tpu.config import DataConfig as JDataConfig
from mipnerf360_tpu.data import get_dataset as j_get_dataset

STREAMS = [(0, 0, 1, 1), (123, 7, 4096, 1000), (2**63 + 5, 2**40, 3000, 77),
           (-1, 0, 20000, 2**31 + 11), (9, 12345, 257, 3)]
DATA = dict(dataset="synthetic", synthetic_resolution=8, synthetic_views=2)


@pytest.fixture(params=["g++", "numpy"])
def path(request, monkeypatch):
    """Run the port on its g++ build or on its NumPy path."""
    if request.param == "numpy":
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "_build_failed", True)
    else:
        assert tnative.native_available()
    return request.param


def test_native_builds_into_the_build_dir():
    assert tnative.native_available()
    lib = tnative.library_path()
    assert lib.is_file() and lib.parent == _build.BUILD_DIR
    assert not list(tnative.SRC_PATH.parent.glob("*.so"))


def test_missing_compiler_takes_the_numpy_path(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(tnative, "library_path",
                        lambda: tmp_path / "build" / "libbatcher-x.so")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_failed", False)
    assert not tnative.native_available()
    np.testing.assert_array_equal(tnative.sample_indices(4, 5, 100, 17),
                                  jnative.sample_indices(4, 5, 100, 17))


@pytest.mark.parametrize("stream", STREAMS)
def test_sample_indices_match_jax(path, stream):
    seed, start, total, n = stream
    got = tnative.sample_indices(seed, start, total, n)
    want = jnative.sample_indices(seed, start, total, n)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < n


@pytest.mark.parametrize("stream", STREAMS[1:4])
def test_fill_batch_stack_matches_jax(path, stream):
    seed, start, total, _ = stream
    rng = np.random.default_rng(seed % 1000)
    arrays = [rng.normal(size=(501, d)).astype(np.float32) for d in (3, 1, 3)]
    got = tnative.fill_batch_stack(seed, start, total, arrays)
    want = jnative.fill_batch_stack(seed, start, total, arrays)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.flags.c_contiguous
        np.testing.assert_array_equal(g, w)


def test_fill_batch_stack_rejects_bad_arrays():
    assert tnative.native_available()
    bad = [np.zeros((10, 3), np.float32), np.zeros((10, 2), np.float64)]
    with pytest.raises(ValueError, match="float32"):
        tnative.fill_batch_stack(0, 0, 4, bad)


def test_counter_stream_is_chunk_invariant(path):
    whole = tnative.sample_indices(9, 0, 256, 777)
    first = tnative.sample_indices(9, 0, 128, 777)
    second = tnative.sample_indices(9, 128, 128, 777)
    np.testing.assert_array_equal(whole, np.concatenate([first, second]))


@pytest.mark.parametrize("white", [True, False])
def test_dataset_streams_match_jax(path, white):
    ds = t_get_dataset(DataConfig(**DATA), "train", white_bkgd=white)
    jds = j_get_dataset(JDataConfig(**DATA), "train", white_bkgd=white)
    np.testing.assert_array_equal(ds.pixels, jds.pixels)
    for k, b, seed, start in [(3, 16, 7, 5), (1, 64, 0, 0), (4, 8, 2, 1000)]:
        idx = ds.index_stack(k, b, seed, start)
        assert idx.shape == (k, b) and idx.dtype == np.int32
        np.testing.assert_array_equal(idx, jds.index_stack(k, b, seed, start))
        rays, pix = ds.batch_stack(k, b, seed, start)
        jrays, jpix = jds.batch_stack(k, b, seed, start)
        np.testing.assert_array_equal(pix, jpix)
        np.testing.assert_array_equal(pix, ds.pixels[idx])
        for a, w, bank in zip(rays, jrays, ds.rays):
            np.testing.assert_array_equal(a, w)
            np.testing.assert_array_equal(a, bank[idx])
    for (r, p), (jr, jp), _ in zip(ds.batches(16, seed=3),
                                   jds.batches(16, seed=3), range(3)):
        np.testing.assert_array_equal(p, jp)
        for a, w in zip(r, jr):
            np.testing.assert_array_equal(a, w)
