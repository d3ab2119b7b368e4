"""Subtractive A/B: the marginal cost of one piece inside the real train step
(counterpart of the JAX package's ``tools/ab_step.py``).

Timing a piece alone (``profile_step``) charges it its own launches and
syncs; this tool stubs one piece out of the production step and times the
step again over the bench's compute-only batch and windows.

    python -m mipnerf360_torch.tools.ab_step baseline
    python -m mipnerf360_torch.tools.ab_step no_distortion | no_distillation | no_resample | no_blur
    python -m mipnerf360_torch.tools.ab_step bounds_einsum|bounds_banded --samples 512 --batch 1024
    python -m mipnerf360_torch.tools.ab_step no_blur --device cpu --batch 64 --k 2

The ``bounds_*`` variants force one ``weight_bounds`` form whatever the
byte-budget dispatch (``losses/distillation.py``) picks. Each stub replaces
the function where the step looks it up at call time: ``train/step.py``'s
``distortion_loss`` and ``distillation_loss``, ``ops/fused.py``'s
``resample_along_rays`` (the model calls it through ``fused.``),
``core/sampling.py``'s ``blur_weights`` and ``losses/distillation.py``'s
``weight_bounds``. A variant whose stub the step does not hold, or does not
call in the first (untimed) call, exits non-zero before any window is
timed: it never reports the unstubbed step. The stub is undone on exit.

One JSON line: ``variant``, ``batch``, ``num_samples``, ``ms_per_step``
(median of the windows), ``rays_per_sec`` and ``card``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics

from ..config import Config, ModelConfig, TrainConfig
from ..core import sampling as samp_mod
from ..core.rays import resolve_device
from ..losses import distillation as dill_mod
from ..models import mipnerf360 as model_mod
from ..ops import fused as fused_mod
from ..train import step as step_mod
from ..train.state import init_train_state
from . import bench

# Warm-up calls (the first checks the stub) and timed windows of --k steps
# each.
WARMUP, REPEATS = 3, 5


class _Counted:
    """A stub that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


# variant -> (module, attribute, stub). Stubs take **kw: keyword-only knobs
# of the production signatures must not make them raise.
VARIANTS = {
    "baseline": None,
    "no_distortion": (step_mod, "distortion_loss",
                      lambda s_vals, weights, *a, **kw: weights.sum() * 0.0),
    "no_distillation": (step_mod, "distillation_loss",
                        lambda tf, wf, tc, wc, *a, **kw: wc.sum() * 0.0),
    "no_resample": (fused_mod, "resample_along_rays",
                    lambda t_vals, weights, *a, **kw: t_vals.detach()),
    "no_blur": (samp_mod, "blur_weights", lambda w: w),
    "bounds_einsum": (dill_mod, "weight_bounds",
                      dill_mod.weight_bounds_einsum),
    "bounds_banded": (dill_mod, "weight_bounds",
                      dill_mod.weight_bounds_banded),
}


def _bound(variant: str, stub) -> bool:
    """Whether the step reaches ``stub`` through the names it calls."""
    if variant in ("no_distortion", "no_distillation"):
        return getattr(step_mod, variant[3:] + "_loss") is stub
    if variant == "no_resample":
        return model_mod.fused.resample_along_rays is stub
    if variant == "no_blur":
        return fused_mod.sampling.blur_weights is stub
    return (dill_mod.weight_bounds is stub
            and step_mod.distillation_loss is dill_mod.distillation_loss)


@contextlib.contextmanager
def stubbed(variant: str):
    """Install ``variant``'s stub (a :class:`_Counted`, yielded; None for
    the baseline) for the duration of the block; an unknown variant or a
    stub the step does not hold exits non-zero."""
    if variant not in VARIANTS:
        raise SystemExit(f"unknown variant {variant!r} "
                         f"(one of {', '.join(VARIANTS)})")
    if VARIANTS[variant] is None:
        yield None
        return
    module, name, fn = VARIANTS[variant]
    stub, original = _Counted(fn), getattr(module, name)
    setattr(module, name, stub)
    try:
        if not _bound(variant, stub):
            raise SystemExit(f"stub not bound: the step does not reach "
                             f"{variant}'s {module.__name__}.{name}")
        yield stub
    finally:
        setattr(module, name, original)


def run(args, base: ModelConfig = ModelConfig()):
    """Time the step of ``base`` (at ``--samples``) with ``args.variant``
    stubbed out; prints and returns (the JSON line's dict, the aux of the
    last call)."""
    device = resolve_device(args.device)
    B, K = args.batch, args.k
    cfg = Config(model=dataclasses.replace(base, num_samples=args.samples),
                 train=TrainConfig(batch_size=B, cadence="joint"))
    with stubbed(args.variant) as stub:
        state = init_train_state(cfg.model, cfg.train, device=device)
        loop = step_mod.make_train_loop(cfg)
        batch = bench.fixed_batch(B, K, device)
        last = {}

        def call():
            nonlocal state
            state, last["aux"] = loop(state, *batch)
            float(last["aux"]["loss"][-1])

        call()
        if stub is not None and not stub.calls:
            raise SystemExit(f"stub not bound: the step did not call "
                             f"{args.variant}'s stub")
        times = bench.time_windows(call, WARMUP - 1, REPEATS)
    dt = statistics.median(times) / K
    out = {"variant": args.variant, "batch": B, "num_samples": args.samples,
           "ms_per_step": round(dt * 1e3, 2), "rays_per_sec": round(B / dt, 1),
           "card": bench.card_name(device)}
    print(json.dumps(out), flush=True)
    return out, last["aux"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variant", nargs="?", default="baseline")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--k", type=int, default=20, help="steps per window")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; cpu for the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
