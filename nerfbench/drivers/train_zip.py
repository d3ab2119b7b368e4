"""Training traffic of Zip-NeRF: ``drivers/train.py``'s chunk loop, first
steps, window and check, with that layout's weights and plain reference.

As ``drivers/train_paper.py`` does, this driver loads a copy of
``drivers/train.py`` of its own and points its module names ``weights`` and
``ref`` at ``nerfbench/zip.py``'s weights and ``reference/zip_model.py``.
The check compares the MLPs by the train driver's numbers, with the tables
left out of them, and each grid level of the tables by its own numbers:
its first gradient's relative L2 gap to the reference's
(``grid_grad_gap``) and the gap of the norms of its change after the steps
(``grid_delta_gap``; see ``Driver.readings``). The control runs add the
faults ``no_downweight`` (the reference with omega = 1 in the program's
place) and ``tables_unchanged`` (the reference's steps with the tables
left as they were).
The segment names the composite kernels' shapes of this layout and the
grid's work a step.
"""
from __future__ import annotations

import importlib.util
import math
import types
from pathlib import Path

import torch

from nerfbench import paper, weights, zip as zipnerf
from nerfbench.reference import zip_model


def _train_driver():
    path = Path(__file__).with_name("train.py")
    spec = importlib.util.spec_from_file_location(
        "nerfbench_driver_train_of_zip", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.ref = zip_model
    mod.weights = types.SimpleNamespace(
        make_params=zipnerf.make_params,
        noise_generator=weights.noise_generator, leaves=weights.leaves)
    return mod


_base = _train_driver()


# The least unit of a grid level's gap (see ``Driver.readings``).
GRID_UNIT_FLOOR = 1e-3


def _is_table(path: str) -> bool:
    return path.endswith("grid")


def _mlps(run: dict) -> dict:
    """``run`` with the tables left out of its gradient and parameters."""
    return dict(run, **{k: {n: v for n, v in run[k].items()
                            if not _is_table(n)}
                        for k in ("grad1", "params")})


def _grid_levels(model: dict, tree: dict):
    """(f"<table path>.<grid level>", table path, rows) of every grid level
    of every sampling level's table in ``tree``."""
    for path in tree:
        if not _is_table(path):
            continue
        level = (model["proposal_rounds"] if path.startswith("nerf.")
                 else int(path.split(".")[1]))
        first = 0
        for i, size in enumerate(zipnerf.grid(model, level)[0]):
            yield f"{path}.{i}", path, slice(first, first + size)
            first += size


def grid_grad_gaps(model: dict, prog: dict, want: dict) -> dict:
    """{"<table path>.<grid level>": relative L2 gap} between the program's
    and the reference's first gradient of each grid level of every
    sampling level's table."""
    gaps = {}
    for key, path, rows in _grid_levels(model, want["grad1"]):
        r, p = want["grad1"][path][rows], prog["grad1"][path][rows]
        norm = float(torch.linalg.norm(r))
        if norm > 0:
            gaps[key] = float(torch.linalg.norm(p - r)) / norm
    return gaps


def grid_delta_gaps(model: dict, prog: dict, want: dict, p0: dict) -> dict:
    """{"<table path>.<grid level>": relative gap} between the norms of the
    program's and the reference's change of each grid level of every
    sampling level's table after the steps (``p0`` the tables before)."""
    gaps = {}
    for key, path, rows in _grid_levels(model, want["params"]):
        d_ref = float(torch.linalg.norm(want["params"][path][rows]
                                        - p0[path][rows]))
        d_prog = float(torch.linalg.norm(prog["params"][path][rows]
                                         - p0[path][rows]))
        if d_ref > 0:
            gaps[key] = abs(d_prog - d_ref) / d_ref
    return gaps


def _in_units(gaps: dict, unit: dict) -> float:
    """The largest of ``gaps``, each over its ``unit`` (at least
    GRID_UNIT_FLOOR)."""
    return max(g / max(unit.get(k, 0.0), GRID_UNIT_FLOOR)
               for k, g in gaps.items())


class Driver(_base.Driver):
    def segment(self) -> dict:
        """The train driver's segment, with the [rays, samples] of each K1
        and K2 launch of a step (``paper.composite_shapes``) and each
        sampling level's grid work a step (``zip.grid_work``)."""
        work = super().segment()
        model = self.cell.config["model"]
        shapes = paper.composite_shapes(model, self.batch)
        work["composite"] = {"K1": shapes, "K2": shapes}
        work["grid"] = zipnerf.grid_work(model, self.batch)
        return work

    def readings(self, matmul: str = "", fault: str = "",
                 detail: bool = False) -> dict:
        """The train driver's readings of the MLPs, and ``grid_grad_gap``:
        the largest, over the grid levels of every table, relative L2 gap of
        the first gradient to the float32 reference's, each in units of the
        same gap of the reference with bfloat16 products (the
        configuration's precision; at least GRID_UNIT_FLOOR). The raw gap
        is that of bf16 products, not of the program: at the NeRF grid's
        finest levels it reads 0.15-0.26 from seed to seed, for the program
        and the bf16 reference alike to three digits; the unit takes that
        out (the raw largest gap is ``grid_grad_gap_raw``). And
        ``grid_delta_gap``: the largest, over the same grid levels, gap
        between the norms of the program's and the float32 reference's
        change of the level after the steps, relative to the reference's,
        in units of the same gap of the reference with bfloat16 products
        (the raw largest is ``grid_delta_gap_raw``): AdamW's first steps
        move every entry that takes a gradient by about the learning rate,
        so a table left as it was, or moved at another rate, reads about
        1 raw. With ``matmul`` or ``fault`` (the control runs:
        ``drop_half``, ``unchanged``, ``no_downweight``,
        ``tables_unchanged``), the reference in that precision or with that
        fault takes the program's place."""
        _base.ref.strict_float32()
        conf = self.cell.config
        model = conf["model"]
        batches = self._reference_batches()

        def steps(precision, **kw):
            out = zip_model.train_steps(
                model, conf["train"], self.params0, batches,
                weights.noise_generator(self.seed, self.device), precision,
                **kw)
            out["parts"] = [{n: s[n] for n in _base.PARTS}
                            for s in out["losses"]]
            out["losses"] = [s["loss"] for s in out["losses"]]
            return out

        want, want_bf16 = steps("float32"), steps("bfloat16")
        if matmul or fault == "drop_half":
            prog = steps(matmul or "float32", drop_half=fault == "drop_half")
        elif fault == "no_downweight":
            prog = steps("float32", downweight=False)
        elif fault == "unchanged":
            prog = dict(want, params=dict(weights.leaves(self.params0)))
        elif fault == "tables_unchanged":
            p0 = dict(weights.leaves(self.params0))
            prog = dict(want, params={k: p0[k] if _is_table(k) else v
                                      for k, v in want["params"].items()})
        elif fault:
            raise ValueError(f"unknown fault {fault!r}")
        else:
            prog = self.program
        out = _base.gap_readings(_mlps(prog), _mlps(want), _mlps(want_bf16),
                                 self.params0,
                                 conf["train"]["dist_loss_weight"], detail)
        gaps = grid_grad_gaps(model, prog, want)
        unit = grid_grad_gaps(model, want_bf16, want)
        out["grid_grad_gap"] = _in_units(gaps, unit)
        out["grid_grad_gap_raw"] = max(gaps.values())
        p0 = dict(weights.leaves(self.params0))
        moved = grid_delta_gaps(model, prog, want, p0)
        moved_unit = grid_delta_gaps(model, want_bf16, want, p0)
        out["grid_delta_gap"] = _in_units(moved, moved_unit)
        out["grid_delta_gap_raw"] = max(moved.values())
        if detail:
            out["grid_grad_gaps"] = gaps
            out["grid_grad_gaps_bf16"] = unit
            out["grid_delta_gaps"] = moved
            out["grid_delta_gaps_bf16"] = moved_unit
        return {k: (float("inf") if isinstance(v, float)
                    and not math.isfinite(v) else v) for k, v in out.items()}
