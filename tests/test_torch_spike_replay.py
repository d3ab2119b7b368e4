"""The spike replay on a tiny model, on the CPU: its card half,
``tests/_spike_replay.py`` (here with its CPU rows), and its JAX half,
``tests/_spike_replay_jax.py`` (row e), on the card half's own output.

The model is a few layers wide and float32, so the rows agree at float32
tolerances: row d (the CPU) is row a itself here; row t (the TPU kernels'
composite arithmetic) within a relative L2 of 1e-4 per gradient leaf; the
JAX package's step (row e) against the port's at rtol 1e-5 on the losses and
1e-4 relative L2 on the gradients and the proposal's update, on the
fixture's rays and over the whole batch in chunks; and the JAX package's
``loss_prop`` of the next step, after its own update of the proposal, at
rtol 1e-5 against the card half's ``held``.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

HERE = Path(__file__).parent
TINY = dict(num_samples=8, hidden_proposal=16, hidden_nerf=16, nerf_depth=2,
            proposal_depth=2, compute_dtype="float32")
START, STEPS, BATCH = 4, 2, 32


def _load(name):
    spec = importlib.util.spec_from_file_location(name, HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault(name, mod)
    spec.loader.exec_module(mod)
    return mod


spike_replay = _load("_spike_replay")


@pytest.fixture(scope="module")
def replayed(tmp_path_factory):
    out = tmp_path_factory.mktemp("spike")
    kw = dict(device="cpu", batch_size=BATCH, res=8, model=TINY,
              max_steps=STEPS)
    report = spike_replay.run(0, START, str(out), **kw)
    spike_replay.run(0, START, str(out), nerf_moments=True, **kw)
    return out, report


def test_tool_logs_the_steps_and_replays_the_rows(replayed):
    out, report = replayed
    assert json.loads((out / "replay.json").read_text()) == report
    assert report["card"] == "cpu" and report["rows"] == ["d", "t"]
    # no spike in a tiny run: the last of the steps stands for it
    spike = START + STEPS
    assert report["spike"] == spike
    assert [e["k"] for e in report["steps"]] == list(
        range(START + 1, spike + spike_replay.AFTER + 1))
    first = report["steps"][0]
    names = list(first["leaves"])
    assert names[0].startswith("prop.") and names[-1].startswith("nerf.")
    assert set(first["leaves"][names[0]]) == {"g_max", "g_l2", "nu_max",
                                              "update_max"}
    assert first["regime"]["w_prop_plus_eps_min"] >= 1e-6
    assert len(first["regime"]["hinge_top_rays"]) == BATCH   # all, < 64
    for e in report["steps"][:STEPS]:
        rows = e["rows"]
        # on the CPU, row d is the run itself, bit for bit
        assert rows["d"]["grad_rel_l2_max"] == 0.0
        assert rows["d"]["loss_prop"] == e["a"]["loss_prop"]
        assert rows["t"]["grad_rel_l2_max"] < 1e-4
        assert set(rows) == {"d", "t"}   # b, c and p are card paths
    assert all("rows" not in e for e in report["steps"][STEPS:])
    roll = report["rollout"]
    assert roll["d"] == roll["a"]
    np.testing.assert_allclose([r["loss_prop"] for r in roll["t"]],
                               [r["loss_prop"] for r in roll["a"]], rtol=1e-5)
    # the state before the step ahead of the spike, with two steps' noise,
    # and (from the second run) the NeRF's moments there
    assert report["state_saved"] == report["held"]["k"] == spike - 1
    held = report["held"]
    for sub in ("prop_only", "nerf_only"):
        assert np.isfinite(list(held[sub].values())).all()
    assert list(held["nerf_leaf"]) == [n for n in names
                                       if n.startswith("nerf.")]
    z = np.load(out / f"state_{spike - 1}.npz")
    assert z["noise_sample_0"].shape == z["noise_sample_1"].shape == (BATCH,
                                                                      9)
    assert not np.array_equal(z["noise_sample_0"], z["noise_sample_1"])
    assert [f.name for f in sorted(out.glob("state_*"))] == [
        f"state_{spike - 1}.npz"]
    m = np.load(out / f"nerf_moments_{spike - 1}.npz")
    np.testing.assert_array_equal(m["params_sha256"], z["params_sha256"])
    assert {n.split(".")[1] for n in m.files if "." in n} == {"nerf"}
    for k in range(START + 1, spike + 1):
        fx = np.load(out / f"fixture_{k}.npz")
        assert fx["density_prop"].shape == (BATCH, 8)
        assert fx["t_nerf"].shape == fx["noise_resample"].shape == (BATCH, 9)


def test_jax_side_takes_its_own_step_and_agrees(replayed):
    out, report = replayed
    row_e = _load("_spike_replay_jax").main([str(out), "--full",
                                             "--chunk", "16"])
    assert json.loads((out / "row_e.json").read_text()) == row_e
    k = report["state_saved"]
    a = {e["k"]: e["a"] for e in report["steps"]}
    assert row_e["k"] == k and row_e["nerf_moments"]
    for mode in ("on", "off"):
        cmp = row_e["fixture"][f"e_{mode}"]
        np.testing.assert_allclose(*cmp["loss_prop"], rtol=1e-5)
        assert cmp["loss_rel"] <= 1e-5
        assert cmp["grad_rel_l2_max"] <= 1e-4
        assert cmp["update_rel_l2"] <= 1e-4
        full = row_e["full"][mode]
        assert full["grad_rel_l2_max"] <= 1e-4
        assert full["update_rel_l2"] <= 1e-4
        # the loaded state, the regenerated batches and the saved noise give
        # the run's own losses of step k, and each package's own step from
        # there (the whole batch in chunks) the run's losses of step k+1
        for side in (full, row_e["full"]["port"]):
            for at, step in (("k", k), ("k1", k + 1)):
                for loss in ("loss_prop", "loss_nerf", "loss"):
                    np.testing.assert_allclose(side[at][loss],
                                               a[step][loss], rtol=1e-5)


def test_row_p_rounds_each_f32_einsum_operand_to_bf16():
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.normal(size=(5, 7)), dtype=torch.float32,
                     requires_grad=True)
    b = torch.tensor(rng.normal(size=(7,)), dtype=torch.float32)
    r = lambda x: x.detach().to(torch.bfloat16).float()
    orig = torch.einsum
    with spike_replay.einsum_one_bf16_pass():
        got = torch.einsum("ij,j->i", a, b)
        (g,) = torch.autograd.grad(got.sum() * 1.001, a)
    torch.testing.assert_close(got, torch.einsum("ij,j->i", r(a), r(b)),
                               rtol=0, atol=0)
    torch.testing.assert_close(g, r(1.001 * r(b).expand(5, 7)), rtol=0, atol=0)
    assert not torch.equal(got, torch.einsum("ij,j->i", a, b))
    assert torch.einsum is orig
