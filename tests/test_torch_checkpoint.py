"""Checkpoints of the port (``mipnerf360_torch/train/checkpoint.py``) and its
reader of the JAX package's checkpoints (``interop.read_jax_checkpoint``).

The msgpack decoder is held against ``msgpack.unpackb`` (with flax's ext
hook) on generated objects, and the reader against a file that the JAX
package's ``save_checkpoint`` wrote. The port's own checkpoints must restore
exactly, generator included, and an async save must write the bytes a
synchronous save writes, however the state steps on in place after it."""
import functools
import os
import shutil

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from mipnerf360_torch import interop
from mipnerf360_torch.config import ModelConfig, TrainConfig
from mipnerf360_torch.core.rays import dummy_rays, rays_to_device
from mipnerf360_torch.train import checkpoint as tckpt
from mipnerf360_torch.train.state import (init_train_state, leaves,
                                          load_state_dict, state_dict)
from mipnerf360_torch.train.step import make_train_step
from mipnerf360_tpu.config import Config as JConfig
from mipnerf360_tpu.config import ModelConfig as JModelConfig
from mipnerf360_tpu.config import TrainConfig as JTrainConfig
from mipnerf360_tpu.core.rays import dummy_rays as jax_dummy_rays
from mipnerf360_tpu.train.checkpoint import save_checkpoint as jax_save
from mipnerf360_tpu.train.state import init_train_state as jax_init_state
from mipnerf360_tpu.train.step import make_train_step as jax_make_step

torch.set_num_threads(1)

SMALL = dict(num_samples=8, hidden_proposal=16, hidden_nerf=16, nerf_depth=2,
             compute_dtype="float32")
B = 16


# --- the msgpack decoder ----------------------------------------------------

_EDGE_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
              2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
              -2**31 - 1, -2**63]
_EDGE_LENS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def _random_object(rng, depth=0):
    kind = rng.integers(0, 9 if depth < 3 else 6)
    if kind == 0:
        return _EDGE_INTS[rng.integers(len(_EDGE_INTS))] if rng.random() < 0.5 else int(
            rng.integers(-2**40, 2**40))
    if kind == 1:
        return float(rng.normal() * 10.0 ** rng.integers(-30, 30))
    if kind == 2:
        return [None, True, False][rng.integers(0, 3)]
    if kind == 3:
        n = int(rng.choice(_EDGE_LENS))
        return "".join(rng.choice(list("aé€z0 "), n))
    if kind == 4:
        return rng.bytes(int(rng.choice(_EDGE_LENS)))
    if kind == 5:
        dtype = rng.choice(["float32", "float64", "int32", "uint8", "bool"])
        shape = tuple(rng.integers(0, 4, rng.integers(0, 3)))
        return (rng.random(shape) * 100).astype(dtype)
    n = int(rng.choice([0, 1, 15, 16, 17]))
    if kind == 6:
        return [_random_object(rng, depth + 1) for _ in range(n)]
    if kind == 7:
        return {f"k{i}": _random_object(rng, depth + 1) for i in range(n)}
    return np.float32(rng.normal())          # a NumPy scalar: ext type 3


def _assert_same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert got.shape == want.shape
    elif isinstance(want, np.generic):
        assert type(got) is type(want) and got == want
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("seed", range(12))
def test_msgpack_decoder_matches_msgpack(seed):
    rng = np.random.default_rng(seed)
    obj = {f"o{i}": _random_object(rng) for i in range(8)}
    data = msgpack.packb(obj, default=serialization._msgpack_ext_pack,
                         use_bin_type=True)
    want = msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack,
                           raw=False, strict_map_key=False)
    _assert_same(interop.unpackb(data), want)


@pytest.mark.parametrize("value", _EDGE_INTS + [0.5, -2.5e-300, float("inf"),
                                                 None, True, False])
def test_msgpack_decoder_scalars(value):
    for packed in (msgpack.packb(value), msgpack.packb(value,
                                                       use_single_float=True)):
        assert interop.unpackb(packed) == msgpack.unpackb(packed)


@pytest.mark.parametrize("n", [15, 16, 65535, 65536])
def test_msgpack_decoder_long_containers(n):
    for obj in ([7] * n, {str(i): i for i in range(n)}, "x" * n, b"y" * n):
        packed = msgpack.packb(obj, use_bin_type=True)
        assert interop.unpackb(packed) == msgpack.unpackb(
            packed, raw=False, strict_map_key=False)


def test_msgpack_decoder_rejects_trailing_and_truncated_data():
    packed = msgpack.packb([1, 2, 3])
    with pytest.raises(ValueError, match="after"):
        interop.unpackb(packed + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        interop.unpackb(packed[:-1])


# --- the JAX package's checkpoints ------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_state_after_steps(n=2):
    jcfg = JConfig(model=JModelConfig(**SMALL),
                   train=JTrainConfig(batch_size=B, lr_delay_steps=0))
    state = jax_init_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train)
    step = jax_make_step(jcfg, donate=False)
    pixels = np.full((B, 3), 0.5, np.float32)
    for i in range(n):
        state, _ = step(state, jax_dummy_rays(B, seed=i), pixels)
    return state


def test_read_jax_checkpoint_is_the_jax_tree(tmp_path):
    state = _jax_state_after_steps(2)
    jax_save(str(tmp_path), state)
    got = interop.read_jax_checkpoint(str(tmp_path / "ckpt_2.msgpack"))
    want = jax.tree.map(np.asarray, state)
    got_leaves, got_def = jax.tree_util.tree_flatten_with_path(got)
    want_leaves, want_def = jax.tree_util.tree_flatten_with_path(want)
    assert got_def.num_leaves == want_def.num_leaves
    for (gp, g), (wp, w) in zip(got_leaves, want_leaves):
        assert jax.tree_util.keystr(gp) == jax.tree_util.keystr(wp)
        assert g.dtype == w.dtype and g.shape == w.shape, wp
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(wp))
    assert [type(s).__name__ for s in got.opt_state["nerf"]] == [
        type(s).__name__ for s in want.opt_state["nerf"]]
    assert int(got.opt_state["prop"][0].count) == 2


def test_restore_reads_jax_msgpack_unless_a_pt_exists(tmp_path):
    state = _jax_state_after_steps(2)
    jax_save(str(tmp_path), state)
    cfg_m, cfg_t = ModelConfig(**SMALL), TrainConfig(batch_size=B)
    template = init_train_state(cfg_m, cfg_t, device="cpu")
    assert tckpt.latest_checkpoint_step(str(tmp_path)) == 2
    restored = tckpt.restore_checkpoint(str(tmp_path), template)
    assert (restored.step, restored.sched_count) == (2, 2)
    assert restored.opt_state["nerf"].count == 2
    for g, w in zip(leaves(restored.params), jax.tree.leaves(state.params)):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    for g, w in zip(leaves(restored.opt_state["prop"].nu),
                    jax.tree.leaves(state.opt_state["prop"][0].nu)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a .pt of the same step takes precedence
    other = init_train_state(cfg_m, cfg_t, device="cpu")
    other.step = 2
    tckpt.save_checkpoint(str(tmp_path), other)
    again = tckpt.restore_checkpoint(
        str(tmp_path), init_train_state(cfg_m, cfg_t, device="cpu"))
    for g, w in zip(leaves(again.params), leaves(other.params)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# --- the port's checkpoints -------------------------------------------------

def _state(seed=0, randomized=True):
    cfg = _cfg(randomized)
    return init_train_state(cfg.model, cfg.train,
                            generator=torch.Generator().manual_seed(seed),
                            device="cpu")


def _cfg(randomized=True):
    from mipnerf360_torch.config import Config

    return Config(model=ModelConfig(**SMALL),
                  train=TrainConfig(batch_size=B, lr_delay_steps=0,
                                    randomized=randomized))


def _steps(state, n, cfg=None):
    step = make_train_step(cfg or _cfg())
    auxes = []
    for i in range(n):
        rays = rays_to_device(dummy_rays(B, seed=state.step), "cpu")
        pixels = torch.full((B, 3), 0.5)
        state, aux = step(state, rays, pixels)
        auxes.append(aux)
    return state, auxes


def _assert_states_equal(a, b):
    assert (a.step, a.sched_count) == (b.step, b.sched_count)
    for x, y in zip(leaves(a.params), leaves(b.params)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for k in ("prop", "nerf"):
        assert a.opt_state[k].count == b.opt_state[k].count
        for x, y in zip(leaves(a.opt_state[k].mu) + leaves(a.opt_state[k].nu),
                        leaves(b.opt_state[k].mu) + leaves(b.opt_state[k].nu)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_save_restore_is_exact_and_draws_the_same_noise(tmp_path):
    state, _ = _steps(_state(), 2)
    path = tckpt.save_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == "ckpt_2.pt"
    restored = tckpt.restore_checkpoint(str(tmp_path), _state(seed=1))
    _assert_states_equal(restored, state)
    assert restored.params["nerf"]["trunk"]["layers"][0]["w"].requires_grad
    _, aux_a = _steps(state, 2)
    _, aux_b = _steps(restored, 2)
    for a, b in zip(aux_a, aux_b):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_keep_prunes_numbered_checkpoints_only(tmp_path):
    state = _state()
    tckpt.save_checkpoint(str(tmp_path), state, name="best")
    shutil.copy(tmp_path / "ckpt_best.pt", tmp_path / "ckpt_1.msgpack")
    for s in [1, 2, 3, 4]:
        state.step = s
        tckpt.save_checkpoint(str(tmp_path), state, keep=2)
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_1.msgpack", "ckpt_3.pt", "ckpt_4.pt", "ckpt_best.pt",
        "manifest.json"]
    assert tckpt.latest_checkpoint_step(str(tmp_path)) == 4
    assert tckpt.latest_checkpoint_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), _state())


def test_best_and_manifest(tmp_path):
    import json

    state, _ = _steps(_state(), 1)
    tckpt.save_checkpoint(str(tmp_path), state, name="best",
                          manifest_extra={"best_psnr_image": 12.5})
    state, _ = _steps(state, 2)
    tckpt.save_checkpoint(str(tmp_path), state)
    with open(tmp_path / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest == {"best_step": 1, "best_psnr_image": 12.5,
                        "latest_step": 3}
    restored = tckpt.restore_checkpoint(str(tmp_path), _state(), step="best")
    assert restored.step == 1
    latest = tckpt.restore_checkpoint(str(tmp_path), _state())
    _assert_states_equal(latest, state)


def test_generator_restores_only_on_its_device(tmp_path):
    sd = state_dict(_state())
    sd["generator"]["device"] = "cuda"
    with pytest.raises(ValueError, match="generator was saved on 'cuda'"):
        load_state_dict(_state(), sd)
    state = _state(seed=1)
    state.generator = None          # a state that draws no noise
    assert load_state_dict(state, sd).generator is None
    for a, b in zip(leaves(state.params), leaves(sd["params"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_async_save_is_byte_identical_after_in_place_steps(tmp_path):
    state, _ = _steps(_state(), 1)
    sync_dir, async_dir = tmp_path / "sync", tmp_path / "async"
    tckpt.save_checkpoint(str(sync_dir), state)
    writer = tckpt.AsyncCheckpointer()
    writer.save(str(async_dir), state)
    state, _ = _steps(state, 3)           # in place, while the write runs
    writer.close()
    assert state.step == 4
    sync_bytes = (sync_dir / "ckpt_1.pt").read_bytes()
    assert (async_dir / "ckpt_1.pt").read_bytes() == sync_bytes
    # and the live state did move on
    tckpt.save_checkpoint(str(sync_dir), state)
    assert (sync_dir / "ckpt_4.pt").read_bytes() != sync_bytes


def test_wait_reraises_worker_errors(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    writer = tckpt.AsyncCheckpointer()
    writer.save(str(tmp_path / "file" / "ckpt"), _state())
    with pytest.raises(OSError):
        writer.wait()
    writer.close()
