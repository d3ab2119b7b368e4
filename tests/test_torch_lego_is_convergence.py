"""``blender_lego_quality`` on the exported sphere scene is the quality
tool's ``convergence`` run: the two configs differ only in cadences that
draw nothing from the training's random streams, so at the same seed the
two train the same trace. The preset record's R10 relies on it to stand the
shipped preset beside ``convergence``'s break on the card.

On the CPU at a tiny size: the two ``Config`` s field by field, then
``apps.train --preset blender_lego_quality`` against
``tools.parity_psnr --mode convergence`` for 12 steps, whose train losses
must be bit-identical at every step although only ``convergence`` has a
batch eval and an image eval (with its best checkpoint) at step 10, and
the preset's own log cadence (one chunk of 12 steps) ends on the same
losses.
"""
import dataclasses
import json
from pathlib import Path

import pytest

from mipnerf360_torch.apps import train as train_app
from mipnerf360_torch.apps.common import apply_overrides
from mipnerf360_torch.config import get_config
from mipnerf360_torch.tools import parity_psnr as pp

STEPS, RES, BATCH, SEED = 12, 8, 64, 0
TINY = dict(num_samples=8, hidden_proposal=16, hidden_nerf=16, nerf_depth=2)
# The cadence fields in which the two configs differ, (preset, convergence)
# at the record's 10,000 steps.
CADENCES = {"train.save_every": (1000, 0), "train.eval_every": (100, 10),
            "train.eval_image_every": (1000, 100),
            "train.eval_image_views": (4, -1), "train.log_every": (20, 10)}
LOSSES = ("train/loss", "train/loss_prop", "train/loss_nerf",
          "train/loss_dist", "train/avg_psnr", "train/lr")


def _flat(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{g.name}": getattr(v, g.name)
                        for g in dataclasses.fields(v)})
        else:
            out[f.name] = v
    return out


def test_configs_differ_only_in_cadences():
    scene, ckpt = "/data/sphere64", "/ckpt"
    preset = apply_overrides(get_config("blender_lego_quality"), [
        f"data.base_dir={scene}", "data.factor=1",
        f"train.checkpoint_dir={ckpt}", f"train.seed={SEED}"])
    conv = pp._ours_cfg(scene, 10_000, ckpt, cadence="joint",
                        batch_size=4096, eval_image_every=100, quality=True,
                        extra_train={"seed": SEED})
    a, b = _flat(preset), _flat(conv)
    diff = {k: (a[k], b[k]) for k in a if a[k] != b[k]}
    # the preset's name is a label: --resume --preset checks it, nothing
    # that trains or renders reads it
    assert diff.pop("preset") == ("blender_lego_quality", "")
    assert diff == CADENCES


def _losses(ckpt: Path) -> dict:
    recs = [json.loads(line)
            for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: tuple(r[k] for k in LOSSES) for r in recs
            if "train/loss" in r}, {r["step"] for r in recs
                                    if "eval/psnr_image" in r}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(convergence's per-step losses and image-eval steps, the preset's,
    the preset's at its own log cadence)."""
    tmp = tmp_path_factory.mktemp("lego")
    scene = tmp / "scene"
    args = pp.parse_args(["--mode", "convergence", "--device", "cpu",
                          "--steps", str(STEPS), "--res", str(RES),
                          "--batch", str(BATCH), "--seed", str(SEED),
                          "--scene-dir", str(scene), "--workdir",
                          str(tmp / "conv")])
    pp.run(args, base_model=TINY, base_train={"log_every": 1})
    conv = _losses(tmp / "conv" / "ours_ckpt_conv")
    tiny = [f"model.{k}={v}" for k, v in TINY.items()]

    def preset(name, *sets):
        ckpt = tmp / name
        argv = ["--preset", "blender_lego_quality", "--device", "cpu"]
        for s in (f"data.base_dir={scene}", "data.factor=1",
                  f"train.max_steps={STEPS}", f"train.batch_size={BATCH}",
                  f"train.seed={SEED}", f"train.checkpoint_dir={ckpt}",
                  *tiny, *sets):
            argv += ["--set", s]
        train_app.main(argv)
        return _losses(ckpt)

    return conv, preset("every_step", "train.log_every=1"), preset("own")


def test_preset_trains_convergence_bit_for_bit(runs):
    (conv, conv_evals), (ours, ours_evals), _ = runs
    assert sorted(conv) == sorted(ours) == list(range(1, STEPS + 1))
    # an eval boundary of one run and not the other
    assert conv_evals == {10} and ours_evals == set()
    parted = [s for s in sorted(conv) if conv[s] != ours[s]]
    assert not parted, (
        f"the runs part at step {parted[0]}: convergence "
        f"{dict(zip(LOSSES, conv[parted[0]]))}, preset "
        f"{dict(zip(LOSSES, ours[parted[0]]))}")


def test_preset_log_cadence_ends_on_the_same_losses(runs):
    (conv, _), _, (own, own_evals) = runs
    # log_every 20 > 12 steps: one chunk, logged at its last step
    assert sorted(own) == [STEPS] and own_evals == set()
    assert own[STEPS] == conv[STEPS]
