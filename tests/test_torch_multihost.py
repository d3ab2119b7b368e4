"""The port's trainer on two ranks (counterpart of tests/test_multihost.py):
a gloo process group on the CPU (``_torch_ranks.py``) runs the real
``train/trainer.py::train`` on a data-parallel mesh, then resumes it.

Rank 0 alone writes ``metrics.jsonl``, ``config.json`` and checkpoints; the
ranks end bit-identical; the last checkpoint restores to the final state;
and the two-rank run trains as the one-process trainer does on the same
global batches (float32, rtol 2e-4 / atol 1e-6 on the params after 9 steps,
rtol 1e-4 on the logged losses: only summation orders differ).
"""
import json

import numpy as np
import pytest

from _torch_parallel_cases import trainer_config
from _torch_ranks import run_ranks
from mipnerf360_torch.train import trainer as tr
from mipnerf360_torch.train.state import leaves


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    ranks = run_ranks("_torch_trainer_worker.py", 2, root, root / "run")
    return root / "run", ranks


def _losses(ckpt_dir):
    with open(ckpt_dir / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


def test_only_rank_zero_writes(two_rank_run):
    ckpt_dir, (r0, r1) = two_rank_run
    wrote = set(p.name for p in ckpt_dir.iterdir())
    assert {"metrics.jsonl", "config.json", "manifest.json",
            "ckpt_best.pt", "ckpt_9.pt"} <= wrote, wrote
    assert int(r0["ckpt_writes"]) > 0 and int(r0["metrics_writes"]) > 0
    assert int(r1["ckpt_writes"]) == 0 and int(r1["metrics_writes"]) == 0
    assert sorted(_losses(ckpt_dir)) == [3, 6, 9]


def test_ranks_agree_and_the_checkpoint_restores(two_rank_run):
    _, (r0, r1) = two_rank_run
    assert int(r0["first_step"]) == int(r1["first_step"]) == 6
    assert int(r0["resumed_step"]) == int(r1["resumed_step"]) == 9
    assert int(r0["restored_step"]) == 9
    n = len([k for k in r0 if k.startswith("resumed_param_")])
    for i in range(n):
        for run in ("first", "resumed"):
            np.testing.assert_array_equal(r0[f"{run}_param_{i}"],
                                          r1[f"{run}_param_{i}"])
        np.testing.assert_array_equal(r0[f"restored_param_{i}"],
                                      r0[f"resumed_param_{i}"])


def test_ranks_resume_from_rank_zero_when_they_disagree(two_rank_run):
    # rank 1 found no checkpoint: it takes rank 0's state, step, counters
    # and noise generator, and both end at step 12 bit-identical
    _, (r0, r1) = two_rank_run
    assert int(r0["lone_step"]) == int(r1["lone_step"]) == 12
    n = len([k for k in r0 if k.startswith("lone_param_")])
    assert n == len([k for k in r0 if k.startswith("resumed_param_")])
    for i in range(n):
        np.testing.assert_array_equal(r0[f"lone_param_{i}"],
                                      r1[f"lone_param_{i}"])


def test_two_ranks_train_as_one_process(two_rank_run, tmp_path):
    ckpt_dir, (r0, _) = two_rank_run
    one = tmp_path / "one"
    tr.train(trainer_config(str(one), 1, 6), device="cpu")
    state = tr.train(trainer_config(str(one), 1, 9), resume=True, device="cpu")
    for i, p in enumerate(leaves(state.params)):
        np.testing.assert_allclose(r0[f"resumed_param_{i}"], p.detach().numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=f"param {i}")
    want, got = _losses(one), _losses(ckpt_dir)
    assert sorted(want) == sorted(got)
    for s in want:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-4, err_msg=s)
