"""The port's quality tool (``mipnerf360_torch/tools/parity_psnr.py``) on the
CPU at a tiny size, held against the JAX package's ``tools/parity_psnr.py``,
whose functions are loaded from the file and never run through its
``main`` (which writes ``PARITY_PSNR.json``).

Tolerances: the exports, the configs and the metrics parsing are held
exactly; the probe's deterministic PSNR on the same converted params (a
float32 model) to the 1e-3 dB that both tools write.
"""
import importlib.util
import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mipnerf360_torch.config import Config
from mipnerf360_torch.tools import parity_psnr as pp
from mipnerf360_tpu.config import Config as JConfig
from mipnerf360_tpu.core.rays import dummy_rays as jax_dummy_rays
from mipnerf360_tpu.train.checkpoint import save_checkpoint as jax_save
from mipnerf360_tpu.train.state import init_train_state as jax_init_state
from mipnerf360_tpu.train.step import make_train_step as jax_make_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RECORD = REPO / "PARITY_PSNR.json"
TINY = dict(num_samples=8, hidden_proposal=16, hidden_nerf=16, nerf_depth=2,
            compute_dtype="float32")
STEPS, RES = 10, 8


@pytest.fixture(scope="module")
def jtool():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_psnr", REPO / "tools" / "parity_psnr.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nested(fn, name: str, *defaults):
    """The function ``name`` defined inside ``fn`` (the JAX tool keeps
    ``tail_mean`` inside ``main``), built from its code object."""
    code = next(c for c in fn.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == name)
    return types.FunctionType(code, fn.__globals__, name, defaults or None)


def _pixels(path: Path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im)


def _same_tree(a: Path, b: Path):
    files_a = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    files_b = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files_a == files_b
    for rel in files_a:
        if rel.suffix == ".png":
            pa, pb = _pixels(a / rel), _pixels(b / rel)
            assert pa.dtype == pb.dtype and pa.shape == pb.shape, rel
            np.testing.assert_array_equal(pa, pb, err_msg=str(rel))
        elif rel.suffix == ".npy":
            np.testing.assert_array_equal(np.load(a / rel), np.load(b / rel))
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    return files_a


# --- the scene exports --------------------------------------------------------

def test_export_blender_scene_matches_jax(jtool, tmp_path):
    jtool.export_blender_scene(str(tmp_path / "jax"), 16)
    pp.export_blender_scene(str(tmp_path / "torch"), 16)
    files = _same_tree(tmp_path / "jax", tmp_path / "torch")
    assert {f.parts[0] for f in files} == {
        "train", "test", "visualize", "transforms_train.json",
        "transforms_test.json", "transforms_visualize.json"}
    assert len([f for f in files if f.parts[0] == "train"]) == 28
    test, vis = (json.loads((tmp_path / "torch" / f"transforms_{s}.json")
                            .read_text()) for s in ("test", "visualize"))
    assert len(test["frames"]) == 4
    assert ([f["transform_matrix"] for f in test["frames"]]
            == [f["transform_matrix"] for f in vis["frames"]])
    img = _pixels(tmp_path / "torch" / "train" / "r_0.png")
    assert img.shape == (16, 16, 4) and (img[..., 3] == 255).all()


@pytest.mark.parametrize("arc", [None, 30.0], ids=["orbit", "arc30"])
def test_export_llff_scene_matches_jax(jtool, tmp_path, arc):
    jtool.export_llff_scene(str(tmp_path / "jax"), 16, 6, arc)
    pp.export_llff_scene(str(tmp_path / "torch"), 16, 6, arc)
    files = _same_tree(tmp_path / "jax", tmp_path / "torch")
    assert len(files) == 7
    assert np.load(tmp_path / "torch" / "poses_bounds.npy").shape == (6, 17)


# --- the configs of every mode ------------------------------------------------

# Each run's _ours_cfg keywords as the JAX tool's main builds them at its
# default --steps 1000 and --batch 4096 (tools/parity_psnr.py:470-472,
# 512-513, 546-548, 585-588).
CFG_CASES = {
    **{f"ablate_{name}": dict(cadence="reference", batch_size=64,
                              eval_image_every=250, extra_model=m,
                              extra_train=t)
       for name, (m, t) in pp.ABLATE_VARIANTS.items()},
    "quality_equal_batch": dict(cadence="reference", batch_size=64,
                                eval_image_every=250, quality=True),
    "convergence": dict(cadence="joint", batch_size=4096,
                        eval_image_every=100, quality=True),
    "parity": dict(eval_image_every=50),
}


@pytest.mark.parametrize("kw", CFG_CASES.values(), ids=CFG_CASES.keys())
def test_ours_cfg_matches_jax(jtool, kw):
    want = jtool._ours_cfg("/scene", 1000, "/ckpt", **kw).to_json()
    got = pp._ours_cfg("/scene", 1000, "/ckpt", **kw)
    assert isinstance(got, Config) and got.to_json() == want
    assert JConfig.from_json(want).train.save_every == 0


def test_ablate_variants_match_the_jax_tool():
    # tools/parity_psnr.py:450-456
    assert pp.ABLATE_VARIANTS == {
        "base": ({}, {}),
        "u_typo": ({"resample_u_typo": True}, {}),
        "collapsed_bounds": ({}, {"quirk_collapsed_bounds": True}),
        "both": ({"resample_u_typo": True},
                 {"quirk_collapsed_bounds": True})}


# --- metrics parsing and the summary arithmetic -------------------------------

def _write_metrics(path: Path):
    rng = np.random.default_rng(3)
    recs = [{"step": 0, "data/device_bank": 1.0}]
    for s in range(10, 210, 10):
        recs.append({"step": s, "train/avg_psnr": float(rng.uniform(5, 20)),
                     "perf/steps_per_sec": float(rng.uniform(50, 60))})
        # runs of the JAX package before its r5 logged "eval/psnr"
        key = "eval/psnr" if s < 50 else "eval/psnr_batch_noisy"
        recs.append({"step": s, key: float(rng.uniform(5, 20))})
        if s % 50 == 0:
            recs.append({"step": s, "eval/psnr_image": float(rng.uniform(15, 25)),
                         "eval/ssim": float(rng.uniform(0.5, 0.9))})
    path.mkdir(parents=True, exist_ok=True)
    (path / "metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))


def test_parse_ours_metrics_and_tail_mean_match_jax(jtool, tmp_path):
    _write_metrics(tmp_path)
    got = pp.parse_ours_metrics(str(tmp_path))
    assert got == jtool.parse_ours_metrics(str(tmp_path))
    assert sorted(got["eval_psnr"]) == list(range(10, 210, 10))
    assert sorted(got["image_psnr"]) == [50, 100, 150, 200]
    jax_tail_mean = _nested(jtool.main, "tail_mean", 0.2)
    for d in got.values():
        assert pp.tail_mean(d) == jax_tail_mean(d)
        for frac in (0.05, 0.5, 1.0):
            assert pp.tail_mean(d, frac) == jax_tail_mean(d, frac)
    assert pp.tail_mean({}) is None and jax_tail_mean({}) is None
    jax_last = _nested(jtool.main, "last")
    assert pp.last(got["train_psnr"]) == jax_last(got["train_psnr"])
    # chunks after the first, less the ones after an image eval (s = 60,
    # 110, 160): median of 16 rates
    rates = [r["perf/steps_per_sec"] for r in map(
        json.loads, (tmp_path / "metrics.jsonl").read_text().splitlines())
        if "perf/steps_per_sec" in r and r["step"] > 10
        and (r["step"] - 10) % 50]
    assert len(rates) == 16
    assert pp.ms_per_step(str(tmp_path)) == 1e3 / np.median(rates)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ge_frac_is_the_jax_tools_expression(seed):
    rng = np.random.default_rng(seed)
    ours = {s: float(rng.uniform(10, 20)) for s in range(0, 100, 10)}
    ref = {s: float(rng.uniform(10, 20)) for s in range(0, 100, 10)}
    shared = sorted(set(ours) & set(ref))
    # tools/parity_psnr.py:533-535, :686-688 and :694-696
    want = round(float(np.mean([ours[s] >= ref[s] for s in shared])), 4)
    assert pp.ge_frac(ours, ref, shared) == want
    assert pp.ge_frac(ours, ref, []) is None
    assert pp.ge_frac(ours, ours, shared) == 1.0


# --- the probe on the same params ---------------------------------------------

def test_train_psnr_probe_deterministic_matches_jax(jtool, tmp_path):
    scene, ckpt = str(tmp_path / "scene"), str(tmp_path / "ckpt")
    pp.export_blender_scene(scene, RES)
    jcfg = jtool._ours_cfg(scene, 2, ckpt, extra_model=TINY)
    state = jax_init_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train)
    step = jax_make_step(jcfg, donate=False)
    pixels = np.full((64, 3), 0.5, np.float32)
    for i in range(2):
        state, _ = step(state, jax_dummy_rays(64, seed=i), pixels)
    jax_save(ckpt, state)
    want = jtool.train_psnr_probe(jcfg, n_batches=3)
    got = pp.train_psnr_probe(pp._ours_cfg(scene, 2, ckpt, extra_model=TINY),
                              n_batches=3, device="cpu")
    assert set(got) == set(want) and got["n_batches"] == 3
    # both written to 3 places: one rounding step apart at most
    assert abs(got["train_psnr_deterministic"]
               - want["train_psnr_deterministic"]) <= 1e-3 + 1e-9
    assert np.isfinite(got["train_psnr_randomized"])


# --- every mode end to end ----------------------------------------------------

def _fixture_record(steps=STEPS, res=RES) -> dict:
    """The recorded parity section cut to ``steps``: the real record's keys
    with its reference's step-0 and final image evals at steps 0 and
    ``steps``."""
    par = json.loads(RECORD.read_text())["parity"]
    ref = par["reference"]
    image_eval = {"0": ref["image_eval"]["0"],
                  str(steps): ref["image_eval"][str(par["steps"])]}
    reference = {**ref,
                 "train_psnr": {str(s): ref["train_psnr"][str(s)]
                                for s in range(steps)},
                 "eval_psnr": {str(steps): 1.0},
                 "image_eval": image_eval}
    summary = {**par["summary"], "image_psnr_at_shared_checkpoints": {
        str(steps): {"ours": 0.0, "reference": 30.0}}}
    return {"parity": {**par, "steps": steps,
                       "scene": {**par["scene"], "res": res},
                       "reference": reference, "summary": summary}}


def _args(mode, tmp_path, *extra):
    record = tmp_path / "record.json"
    if not record.exists():
        record.write_text(json.dumps(_fixture_record()))
    return pp.parse_args(["--mode", mode, "--device", "cpu", "--steps",
                          str(STEPS), "--res", str(RES), "--batch", "64",
                          "--record", str(record), *extra])


@pytest.mark.parametrize("mode", list(pp.SECTIONS))
def test_mode_runs_and_keeps_the_record_keys(mode, tmp_path):
    out = tmp_path / "out.json"
    section = pp.run(_args(mode, tmp_path, "--out", str(out)), TINY)
    key = pp.SECTIONS[mode]
    want = json.loads(RECORD.read_text())[key]
    assert set(section) - {"card"} == set(want)
    assert section["card"] == "cpu" and section["steps"] == STEPS
    assert json.loads(out.read_text()) == json.loads(json.dumps({key: section}))
    if mode == "ablate":
        assert set(section["variants"]) == set(want["variants"])
        for name, v in section["variants"].items():
            assert set(v) == set(want["variants"][name])
            assert set(v["probe"]) == set(want["variants"][name]["probe"])
            assert np.isfinite(v["final_image_psnr"]) and v["wall_s"] > 0
    elif mode == "quality-equal-batch":
        # the fixture's reference image PSNR (30 dB) at step 10
        assert section["image_psnr_at_shared_checkpoints"][STEPS][
            "reference"] == 30.0
        assert section["ours_ge_ref_frac"] == 0.0
    elif mode == "convergence":
        assert set(section["ours"]) == set(want["ours"])
        assert set(section["summary"]) == set(want["summary"])
        final = section["summary"]["final_checkpoint"]
        assert final["step"] == STEPS and set(final) == {
            "eval/psnr_image", "step",
            *(f"eval/psnr_view_{i}" for i in range(4))}
        assert section["summary"]["best_checkpoint"]["step"] == STEPS
        assert final["eval/psnr_image"] == pytest.approx(
            section["ours"]["image_psnr"][STEPS], rel=1e-6)
    else:
        assert set(section["summary"]) == set(want["summary"])
        assert section["reference"] == _fixture_record()["parity"]["reference"]
        assert section["summary"]["shared_eval_checkpoints"] == 1
        assert list(section["summary"]["image_psnr_at_shared_checkpoints"]) \
            == [STEPS]
        assert section["summary"]["ours_ge_ref_image_frac"] == float(
            section["ours"]["image_psnr"][STEPS]
            >= section["reference"]["image_eval"][str(STEPS)]["image_psnr"])


def test_parity_reuses_a_run_and_refuses_other_steps(tmp_path):
    work = tmp_path / "work"
    first = pp.run(_args("parity", tmp_path, "--workdir", str(work)), TINY)
    again = pp.run(_args("parity", tmp_path, "--reuse-ours",
                         str(work / "ours_ckpt")), TINY)
    want = json.loads(RECORD.read_text())["parity"]
    assert set(again["ours"]) == set(want["ours"])   # reused_from included
    assert again["ours"]["wall_s"] == 0.0 and first["ours"]["wall_s"] > 0
    assert again["summary"] == first["summary"]
    for bad in (["--steps", "20"], ["--res", "16"]):
        with pytest.raises(SystemExit, match="recorded reference"):
            pp.run(_args("parity", tmp_path, *bad), TINY)


def test_writes_nothing_into_the_repo_without_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = RECORD.read_bytes()
    pp.run(_args("quality-equal-batch", tmp_path), TINY)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["record.json"]
    assert RECORD.read_bytes() == before
    for out in (str(RECORD), str(tmp_path / "record.json")):
        with pytest.raises(SystemExit, match="recorded run"):
            pp.run(_args("quality-equal-batch", tmp_path, "--out", out), TINY)
    assert RECORD.read_bytes() == before


def test_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pp.main(["--mode", "convergence", "--steps", "1"])
