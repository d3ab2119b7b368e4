"""The port stands alone: no JAX and nothing of ``mipnerf360_tpu`` or of the
JAX package's ``tools/`` at import time, the card unless the caller asks for
the CPU, and no silent fallback when the card or the CUDA toolkit is
missing.

This file imports no JAX, so it also runs on a machine with a card and
without JAX (``--noconftest``: tests/conftest.py imports JAX), as the README
says.
"""
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from mipnerf360_torch.config import ModelConfig, TrainConfig
from mipnerf360_torch.core.rays import dummy_rays
from mipnerf360_torch.models import mipnerf360 as tm
from mipnerf360_torch.ops import _build, composite, fused
from mipnerf360_torch.train import init_train_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = ModelConfig(num_samples=8, hidden_proposal=16, hidden_nerf=16,
                    nerf_depth=2, compute_dtype="float32")


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_and_chip_smoke_import_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import mipnerf360_torch
        names = [m.name for m in pkgutil.walk_packages(
            mipnerf360_torch.__path__, "mipnerf360_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "mipnerf360_tpu", "tools"))
        required = {"mipnerf360_torch.parallel.mesh",
                    "mipnerf360_torch.parallel.collectives",
                    "mipnerf360_torch.parallel.sample_axis",
                    "mipnerf360_torch.tools.parity_psnr",
                    "mipnerf360_torch.tools.scaling",
                    "mipnerf360_torch.tools._scaling_worker",
                    "mipnerf360_torch.tools.preset_record"}
        print(len(names), bad, sorted(required - set(names)))
        sys.exit(1 if bad or len(names) < 20 or required - set(names) else 0)
    """)
    res = _run(["-c", code], cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("script", ["demo_synthetic.sh", "demo_360.sh"])
def test_demo_scripts_run_only_the_port(script):
    """The port's demo scripts call ``python -m mipnerf360_torch.*`` and
    nothing else: no JAX package, no script of the JAX package's."""
    text = (REPO / "mipnerf360_torch" / "demo" / script).read_text()
    code = [ln for ln in text.splitlines() if not ln.lstrip().startswith("#")]
    modules = re.findall(r"python -m (\S+)", "\n".join(code))
    assert modules == [f"mipnerf360_torch.apps.{m}"
                       for m in ("train", "eval", "video")]
    assert "mipnerf360_tpu" not in text and "jax" not in "\n".join(code)
    assert not re.search(r"\b(tools|demo)/", "\n".join(code))


def test_failed_process_group_raises(monkeypatch):
    """A rendezvous that fails raises; nothing goes on in one process."""
    import torch.distributed as dist

    from mipnerf360_torch.parallel import init_distributed

    with pytest.raises((RuntimeError, ValueError)):
        init_distributed("cpu", init_method="nowhere://rendezvous", rank=0,
                         world_size=2)
    assert not dist.is_initialized()
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        init_distributed("cpu")
    assert not dist.is_initialized()


def test_mesh_over_gloo_needs_its_device(tmp_path):
    """Gloo serves the CPU and the card alike, so a mesh over it is not
    placed on the CPU by default: its device must be given."""
    import torch.distributed as dist

    from mipnerf360_torch.parallel import init_distributed, make_mesh, shutdown

    init_distributed("cpu", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                     world_size=1)
    try:
        with pytest.raises(ValueError, match="needs its device"):
            make_mesh()
        mesh = make_mesh(device="cpu")
        assert (mesh.data, mesh.model, str(mesh.device)) == (1, 1, "cpu")
    finally:
        shutdown()
    assert not dist.is_initialized()


def test_render_image_needs_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    params = tm.init_model(SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.render_image(params, SMALL, dummy_rays(4), chunk=4)
    rgb, distance, acc = tm.render_image(params, SMALL, dummy_rays(4), chunk=4,
                                         device="cpu")
    assert rgb.shape == (4, 3) and distance.shape == acc.shape == (4,)


def test_init_train_state_needs_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(SMALL, TrainConfig())
    state = init_train_state(SMALL, TrainConfig(), device="cpu")
    assert (state.step, state.sched_count) == (0, 0)
    assert state.generator.device.type == "cpu"
    w = state.params["nerf"]["trunk"]["layers"][0]["w"]
    assert w.device.type == "cpu" and w.requires_grad and w.is_leaf
    again = init_train_state(SMALL, TrainConfig(), device="cpu")
    torch.testing.assert_close(again.params["nerf"]["trunk"]["layers"][0]["w"],
                               w, rtol=0, atol=0)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["composite"])
    assert _build.source_names() == ["composite", "encode", "hashgrid",
                                     "mlp_epilogue", "mlp_gemm"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["hashgrid"])


def test_chip_smoke_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], cwd=tmp_path)
    assert res.returncode != 0, res.stdout
    assert '"ok": true' not in res.stdout


def test_chip_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    res = _run(["chip_smoke.py"], cwd=REPO)
    assert res.returncode != 0, res.stdout
    assert '"ok": true' not in res.stdout


@pytest.mark.cuda
def test_use_pallas_off_with_a_cuda_tensor_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x = torch.ones(4, 8, device="cuda")
    t = torch.linspace(2.0, 6.0, 9, device="cuda").expand(4, 9).contiguous()
    d = torch.ones(4, 3, device="cuda")
    before = composite.launches
    with pytest.raises(ValueError, match="use_pallas='off'"):
        fused.compute_alpha_weights(x, t, d, "off")
    assert composite.launches == before
