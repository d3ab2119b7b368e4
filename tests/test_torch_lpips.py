"""The port's LPIPS (``mipnerf360_torch/utils/lpips.py``) and ``--lpips`` in
``apps.eval`` against the JAX package's on the same random weights, and
``checks.checkify_fn`` against the JAX package's checkify wrapper."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipnerf360_torch.apps import eval as eval_app
from mipnerf360_torch.utils import lpips as tl
from mipnerf360_torch.utils.checks import NonFiniteError, checkify_fn
from mipnerf360_tpu.apps import eval as jax_eval_app
from mipnerf360_tpu.apps import train as jax_train_app
from mipnerf360_tpu.utils import lpips as jl
from mipnerf360_tpu.utils.checks import checkify_fn as jax_checkify_fn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    """The JAX package's random weights as NumPy, with some negative lin
    entries so that the max(lin, 0) clamp matters."""
    w = {k: np.array(v) for k, v in
         jl.random_weights(jax.random.PRNGKey(3)).items()}
    rng = np.random.default_rng(0)
    for l in range(5):
        w[f"lin{l}"] = (w[f"lin{l}"] * rng.uniform(-1.0, 2.0, w[f"lin{l}"].shape)
                        ).astype(np.float32)
    w["conv3_b"] = rng.normal(0, 0.1, w["conv3_b"].shape).astype(np.float32)
    return w


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=shape).astype(np.float32),
            rng.uniform(size=shape).astype(np.float32))


# 32x32; 21x27 (odd sizes: every 2x2 pool drops an edge, down to 1x1);
# a batch of two
@pytest.mark.parametrize("shape", [(32, 32, 3), (21, 27, 3), (2, 18, 22, 3)])
def test_lpips_matches_jax(weights, shape):
    img, ref = _pair(shape, 1)
    got = tl.lpips(img, ref, weights)
    want = float(jl.lpips(img, ref, {k: jnp.asarray(v)
                                     for k, v in weights.items()}))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_lpips_is_zero_on_itself_and_symmetric(weights):
    x, y = _pair((24, 20, 3), 2)
    assert float(tl.lpips(x, x, weights)) < 1e-6
    np.testing.assert_allclose(float(tl.lpips(x, y, weights)),
                               float(tl.lpips(y, x, weights)), rtol=1e-6)
    tw = {k: torch.as_tensor(v) for k, v in weights.items()}
    np.testing.assert_allclose(float(tl.lpips(torch.as_tensor(x), y, tw)),
                               float(tl.lpips(x, y, weights)), rtol=0)


def test_random_weights_and_load_weights(tmp_path):
    ours = tl.random_weights(torch.Generator().manual_seed(0))
    theirs = jl.random_weights(jax.random.PRNGKey(0))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert tuple(ours[k].shape) == theirs[k].shape
        assert ours[k].dtype == torch.float32
    path = str(tmp_path / "w.npz")
    np.savez(path, **{k: v.numpy() for k, v in ours.items()})
    loaded = tl.load_weights(path)
    x, y = _pair((16, 16, 3), 4)
    assert float(tl.lpips(x, y, loaded)) == float(tl.lpips(x, y, ours))


def _argv(sets):
    return [a for s in sets for a in ("--set", s)]


def test_eval_lpips_matches_jax_eval(tmp_path, weights):
    """Both packages' ``apps.eval --lpips`` on one JAX run (16x16 views,
    large enough for VGG's four pools) report the same ``mean_lpips``; the
    renders agree to ~1e-5, so the scores agree to 1e-4."""
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **weights)
    ckpt = str(tmp_path / "ckpt")
    sets = ["model.num_samples=8", "model.hidden_proposal=16",
            "model.hidden_nerf=16", "model.nerf_depth=2",
            "model.compute_dtype=float32", "model.white_bkgd=true",
            "data.dataset=synthetic", "data.synthetic_resolution=16",
            "data.synthetic_views=2", "train.max_steps=2",
            "train.batch_size=8", "train.log_every=2", "train.save_every=0",
            "train.eval_every=0", "train.lr_delay_steps=0",
            f"train.checkpoint_dir={ckpt}"]
    old = sys.argv
    try:
        sys.argv = ["prog"] + _argv(sets)
        jax_train_app.main()
        sys.argv = ["prog", "--ckpt", ckpt, "--out", str(tmp_path / "jax"),
                    "--chunk", "256", "--lpips", npz]
        jax_eval_app.main()
    finally:
        sys.argv = old
    got = eval_app.main(["--ckpt", ckpt, "--out", str(tmp_path / "port"),
                         "--chunk", "256", "--lpips", npz, "--device", "cpu"])
    with open(tmp_path / "jax" / "eval.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "eval.json") as f:
        assert json.load(f) == got
    assert got["n_views"] == want["n_views"] == 2
    np.testing.assert_allclose(got["mean_lpips"], want["mean_lpips"],
                               rtol=1e-4)


def test_eval_without_lpips_says_so(tmp_path, capsys):
    from mipnerf360_torch.apps import train as train_app

    ckpt = str(tmp_path / "ckpt")
    train_app.main(["--device", "cpu"] + _argv([
        "model.num_samples=4", "model.hidden_proposal=8",
        "model.hidden_nerf=8", "model.nerf_depth=1",
        "model.compute_dtype=float32", "data.dataset=synthetic",
        "data.synthetic_resolution=4", "data.synthetic_views=2",
        "train.max_steps=1", "train.batch_size=4", "train.save_every=0",
        "train.eval_every=0", f"train.checkpoint_dir={ckpt}"]))
    summary = eval_app.main(["--ckpt", ckpt, "--chunk", "16",
                             "--device", "cpu"])
    assert "no --lpips weights file" in capsys.readouterr().out
    assert "mean_lpips" not in summary


# (name, torch function, jax function, input): where JAX's checkify raises
# (a NaN from any op, a division by zero) and where it does not (finite
# results, an overflow to Inf).
CHECK_CASES = [
    ("log of -1", torch.log, jnp.log, -1.0),
    ("sqrt of -1", torch.sqrt, jnp.sqrt, -1.0),
    ("1 / 0", lambda x: 1.0 / x, lambda x: 1.0 / x, 0.0),
    ("0 / 0", lambda x: x / x, lambda x: x / x, 0.0),
    ("x / 0.0", lambda x: x / 0.0, lambda x: x / 0.0, 2.0),
    ("inf * 0", lambda x: torch.exp(x) * 0, lambda x: jnp.exp(x) * 0, 1e3),
    ("NaN input", lambda x: x + 1, lambda x: x + 1, float("nan")),
    ("finite", lambda x: torch.sqrt(x) * 2 - torch.log(x),
     lambda x: jnp.sqrt(x) * 2 - jnp.log(x), 4.0),
    ("overflow to inf", torch.exp, jnp.exp, 1e3),
    ("vector, one bad entry", lambda x: torch.log(x - 1.5),
     lambda x: jnp.log(x - 1.5), [2.0, 3.0, 1.0]),
]


@pytest.mark.parametrize("name,tfn,jfn,x", CHECK_CASES,
                         ids=[c[0] for c in CHECK_CASES])
def test_checkify_fn_raises_where_jax_raises(name, tfn, jfn, x):
    try:
        want = np.asarray(jax_checkify_fn(jfn)(jnp.asarray(x, jnp.float32)))
    except Exception:          # JaxRuntimeError: checkify found an error
        want = None
    if want is None:
        with pytest.raises(NonFiniteError, match=r"aten\.|division by zero"):
            checkify_fn(tfn)(torch.tensor(x, dtype=torch.float32))
    else:
        got = checkify_fn(tfn)(torch.tensor(x, dtype=torch.float32))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_checkify_fn_names_the_op_and_passes_kwargs():
    def fn(x, *, shift):
        y = x * 2                      # fine
        return torch.log(y - shift)    # NaN where y < shift

    x = torch.tensor([1.0, 3.0])
    with pytest.raises(NonFiniteError, match=r"nan generated by aten\.log"):
        checkify_fn(fn)(x, shift=4.0)
    torch.testing.assert_close(checkify_fn(fn)(x, shift=1.0),
                               torch.log(x * 2 - 1.0))
