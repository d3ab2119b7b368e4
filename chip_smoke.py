"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Builds every CUDA kernel of ``mipnerf360_torch`` from ``mipnerf360_torch/csrc``
with ``nvcc``, holds each kernel (K1, the composite forward, and K2, its
backward) against its plain PyTorch version on the card, then drives the
port's two paths at the full width of the ``synthetic_quality`` preset:

- the render: the synthetic scene's held-out views through ``render_image``;
- training: joint-cadence train steps (``joint_cadence_step``) of 4096 rays
  drawn from the synthetic train split;
- the trainer and its entry points: ``apps.train.main`` straight to 120
  steps (run A), and to 60 steps then ``--resume`` to 120 (run B), with
  logs, evals, ``keep_best`` and async checkpoints on their cadences; B's
  restored state must equal A's checkpoint at step 60 exactly and its later
  losses A's; then ``apps.eval.main`` renders the held-out views of A's
  checkpoint and must beat the PSNR of the random-init render. Before it,
  two steps of the train loop run under CUDA's sync debug mode, which names
  each line that makes the host wait for the card;
- ``garden_quality`` on an LLFF-layout capture of the analytic sphere at
  the size of garden at factor 8, which the script writes (185 views of
  648x420): a sixth of the held-out views at random init, ``apps.train``
  with host staging (as ``stage_mode=auto`` picks for its 2.45 GiB of train
  rays) and with the bank on the card, ``apps.eval --lpips`` (random VGG
  weights) on every held-out view, which must beat the random-init PSNR on
  the same views, and ``apps.video --depth --normals`` on the spherified
  orbit;
- ``blender_lego_quality`` on an 800x800 RGBA Blender-layout capture:
  ``apps.train`` and ``apps.video`` on the synthesized render path;
- ``apps.video`` on the synthetic scene's render split, the port's PNG
  decoder against the loaders' image reader, LPIPS and ``checkify_fn``;
- the parallel layer under torchrun: ``apps.train --multihost`` at world
  size 1 over NCCL, whose losses must be run A's; then two ranks sharing
  the card over gloo: a data-parallel and a tensor-parallel train step
  against the one-process step, and the render with data=2 and with
  sample_shards=2 against the one-process render. The script starts
  itself under torchrun (``--worker``) for these ranks;
- the measuring layer (``mipnerf360_torch.tools``): the bench's quality
  compute, bank and host staging and render in process, whose compute rate
  must be near phase 6's bare step, the bench's default line in a
  subprocess, ``profile_step`` and one ``ab_step`` variant;
- the quality layer (``mipnerf360_torch.tools.parity_psnr``) on the
  exported 64x64 sphere scene: ``convergence`` for 300 steps, which must
  come within 2 dB of the JAX package's recorded run at step 300, then
  ``quality-equal-batch`` and ``ablate``'s ``both`` variant with its probe
  on the reference cadence (2 proposal updates and 1 NeRF update per
  step); each run's held-out PSNR must beat its model's random-init render;
- the spike regime of the proposal-distillation loss: K1 and K2 against
  their plain versions on the committed rays of ``convergence``'s spike
  (``tests/data/convergence_spike_seed0.npz``) and on synthetic rays of the
  same regime, then the distillation part of the step on those rays, card
  against CPU.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after. The card is checked against the CPU on the render (the
synthetic and the garden rays), the train step and LPIPS. Any failure exits
non-zero. It needs one CUDA device, and
refuses to run without one or without the package beside it.

Each kernel is timed with its inputs hot in L2 (as the main path leaves
them), cold in L2 (a 128 MiB write between calls, its own time taken out),
and with inputs that are not 16-byte aligned (no 16-byte accesses), beside the
floor of the timing harness (a one-element ``zero_()``), its byte bound and
its plain version.

Each kernel's register, spill and SASS instruction counts are printed after
the build. Output, one line per phase; the line before the last is the
per-kernel JSON record and the last line is ``{"ok": true, "device":
{...}}``. With
``--profile DIR`` it also profiles one warm render and one warm train step,
writes their traces and kernel tables to DIR, and reads K1's and K2's
per-launch device time in the train step from the trace.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Render-path settings: the synthetic_quality preset's held-out views.
RENDER_CHUNK = 4096
PARITY_RAYS = 128
# Train-path settings: one warm step, then TRAIN_STEPS timed steps of the
# preset's batch (4096 rays).
TRAIN_STEPS = 6
# Trainer-path settings: run A trains straight to TRAINER_STEPS, run B to
# half of it and then resumes. Logs, saves and evals at these cadences; both
# runs take the preset's own LR horizon (its max_steps), so that B's first
# half is A's. B's losses after the resume are held to A's at
# TRAINER_LOSS_RTOL: bit-identical when the card repeats itself exactly, and
# otherwise apart by float32 summation orders grown over 60 steps.
TRAINER_STEPS = 120
TRAINER_SETS = ["train.log_every=20", "train.save_every=60",
                "train.eval_every=60", "train.eval_image_every=60",
                "train.lr_max_steps=10000"]
TRAINER_LOSS_RTOL = 1e-2

# Phase 9: garden_quality at full width on an LLFF-layout capture of the
# analytic sphere at the size of garden at factor 8: 185 views of 648x420,
# every 8th (24) held out. Its 161 train views hold 43.8 M rays, 2.45 GiB
# with their pixels: above the trainer's 2 GiB bank threshold, so
# stage_mode=auto stages from the host (at 131 train views it would not).
# Run A trains GARDEN_STEPS with a batch eval and one image eval (4 views,
# the preset's eval_image_views) at its last step and no periodic save; run
# B takes the first GARDEN_BANK_STEPS with the bank on the card, no eval or
# save in its window. The video renders GARDEN_VIDEO_POSES of the preset's
# 120 orbit poses. The random-init render, the eval's reference, takes
# every GARDEN_INIT_STRIDE-th held-out view (4 of the 24), and the eval's
# PSNR on those views must beat it. (Cut for time, in two rounds: the video
# from 8 to 4 and then 2 poses, run A from 120 to 60 steps with its image
# eval at 60 only, the random-init render from all 24 views to 8 and then
# 4. With phase 12 added and before the second round the script took 343 s
# on an H100.)
GARDEN_VIEWS, GARDEN_W, GARDEN_H, GARDEN_FACTOR = 185, 648, 420, 8
GARDEN_STEPS, GARDEN_BANK_STEPS, GARDEN_VIDEO_POSES = 60, 40, 2
GARDEN_INIT_STRIDE = 6
GARDEN_SETS = ["train.log_every=20", "train.eval_every=60",
               "train.eval_image_every=60", "train.lr_max_steps=10000"]
# Phase 10: blender_lego_quality at full width on a Blender-layout capture
# of 800x800 RGBA views (loaded at factor 2, 400x400): lego's 100 train
# views, its 200 test views cut to 8, LEGO_STEPS steps, and LEGO_VIDEO_POSES
# of the preset's 120 render-path poses at 800x800.
LEGO_TRAIN, LEGO_TEST, LEGO_RES = 100, 8, 800
LEGO_STEPS, LEGO_VIDEO_POSES = 20, 2
# Threads that render and write a capture's PNGs (NumPy and zlib release
# the interpreter lock).
CAPTURE_WORKERS = 8
# LPIPS on the card against the CPU: float32 convolutions with TF32 off,
# another summation order through 13 layers.
LPIPS_RTOL = 1e-4
# Phase 11 decodes this many garden PNGs with the port's own decoder and
# with the loaders' reader.
PNG_CHECK_VIEWS = 24

# Phase 12: the parallel layer. 12a trains through ``apps.train
# --multihost`` under torchrun at world size 1 over NCCL, PARALLEL_STEPS
# steps of phase 8's run A (same settings), whose losses it must repeat.
# 12b runs two ranks over gloo sharing the one card (NCCL refuses two ranks
# on one device): a data-parallel step of PARALLEL_DP_BATCH rays, a
# tensor-parallel step (data=1, model=2) of PARALLEL_TP_BATCH rays, both
# against the one-process step on the card at phase 7's bfloat16
# tolerances, and the render of phase 4 with data=2 and with
# sample_shards=2 at phase 5's. Gloo moves CUDA tensors through the host:
# 12b's times are correctness runs, not speeds. Each torchrun call stops
# at PARALLEL_TIMEOUT_S.
PARALLEL_STEPS = 40
PARALLEL_DP_BATCH, PARALLEL_TP_BATCH = 4096, 512
PARALLEL_TIMEOUT_S = 600
PARALLEL_BF16 = dict(rtol=2e-2, atol=2e-2)
PARALLEL_GRAD_REL_L2 = 5e-2

# Phase 13: the measuring layer (``mipnerf360_torch.tools``). In process,
# the bench's quality compute, bank staging, host staging and render at
# TOOLS_STEPS steps per window, TOOLS_WARMUP warm-ups and TOOLS_REPEATS
# windows, each with the kernels' counts checked; the quality compute rate
# must lie within TOOLS_RATE_RANGE of phase 6's bare step (a bench that
# times something else would not). Then the bench's default line in a
# subprocess, and profile_step and one ab_step variant at 2 steps.
TOOLS_STEPS, TOOLS_WARMUP, TOOLS_REPEATS = 4, 2, 2
TOOLS_RATE_RANGE = (0.7, 1.3)
TOOLS_TIMEOUT_S = 300

# Phase 14: the quality layer (``mipnerf360_torch.tools.parity_psnr``)
# through its ``run`` on the exported 64x64 scene (28 train, 4 held-out
# views): ``convergence`` (quality model, joint cadence, 4096 rays) for
# QUALITY_CONV_STEPS steps with an image eval every QUALITY_EVAL_EVERY and
# the LR horizon of the recorded 10,000-step run (so its first steps follow
# the record's schedule); ``quality-equal-batch`` (reference cadence, batch
# 64) for QUALITY_QEB_STEPS; ``ablate``'s ``both`` variant for
# QUALITY_ABLATE_STEPS, with its probe. Each run's image PSNR must beat the
# random-init render of its model on the same views, and convergence's at
# its last step must lie at most QUALITY_MARGIN_DB under the JAX package's
# record at that step (PARITY_PSNR.json, a TPU v5e run: 26.62 dB at 300).
# The reference cadence launches K1 twice and K2 once per update: 6 and 3
# per step at prop_inner_steps = 2.
QUALITY_CONV_STEPS, QUALITY_EVAL_EVERY, QUALITY_LR_STEPS = 300, 50, 10_000
QUALITY_QEB_STEPS, QUALITY_ABLATE_STEPS = 100, 20
QUALITY_RES = 64
QUALITY_MARGIN_DB = 2.0

# Phase 15: the spike regime of the proposal-distillation loss. The
# committed fixture holds the 64 rays of the largest hinge at steps 2,144
# and 2,145 of ``convergence`` seed 0 on the card (proposal weights down to
# 5e-23 under NeRF bounds near 1). K1 and K2 are held to their plain
# versions on its two levels, under the hinge's cotangent, and on
# SPIKE_SYNTH_RAYS synthetic rays of the same regime: density 0 or
# log-uniform from 1e-6 to 1e4 (transmittance underflows to 0, weights
# down to 0), cotangents 0 or of either sign, log-uniform from 1 to 1e12.
# K1 at its tolerance (the weights are at most 1); K2 within SPIKE_ROW_RTOL
# of each ray's largest |d_density| (entries span 20 orders of magnitude,
# so an absolute or entrywise tolerance says nothing there). Then the
# distillation part of the step on the fixture's rays, density -> K1 ->
# hinge -> K2 -> d_density, on the card against the CPU's plain path: the
# loss at SPIKE_LOSS_RTOL, d_density within SPIKE_ROW_RTOL of each ray's
# largest.
SPIKE_FIXTURE = Path("tests") / "data" / "convergence_spike_seed0.npz"
SPIKE_SYNTH_RAYS = 4096
SPIKE_ROW_RTOL = 1e-4
SPIKE_LOSS_RTOL = 1e-5

# K1 against its plain version: the JAX package's Pallas-vs-core tolerance
# (tests/test_pallas_ops.py). The two differ only in the order of the
# transmittance prefix sum (warp scan vs torch.cumsum) and in the last ulp
# of exp/expm1/sqrt.
K1_RTOL, K1_ATOL = 1e-5, 1e-6
# K2 against its plain version: the JAX package's Pallas-vs-core backward
# tolerance (tests/test_pallas_ops.py). Besides the prefix sum, the suffix
# sum of g*w is taken in another order (reverse warp scan vs flipped cumsum).
K2_RTOL, K2_ATOL = 1e-4, 1e-5

# The shapes each composite kernel is held at: (label, B, N, density range,
# storage offset of every input in floats). The train batch (and render
# chunk), ragged B with small N, one ray with N not a multiple of 4,
# near-zero density (dd < 1e-2, the expm1 region), opaque rays (T underflows
# to 0); then the edges of the kernels' tiles: one ray past a whole number of
# 16-ray tiles, rows that are not 16-byte multiples (N = 1, 3), the longest
# ray that one register chunk holds (N = 128), rays of 2 and 40 chunks of
# 128 samples (N = 256, 5000), and inputs 4 bytes into a larger buffer, so
# that no row is 16-byte aligned.
KERNEL_CASES = [
    ("train batch / render chunk", 4096, 64, (0.0, 3.0), 0),
    ("ragged B, small N", 300, 16, (0.0, 3.0), 0),
    ("one ray, N=65", 1, 65, (0.0, 3.0), 0),
    ("near-zero density (dd < 1e-2)", 1024, 64, (0.0, 1e-4), 0),
    ("large density", 1024, 64, (50.0, 500.0), 0),
    ("one ray past whole tiles", 4097, 64, (0.0, 3.0), 0),
    ("N=1", 300, 1, (0.0, 3.0), 0),
    ("N=3", 300, 3, (0.0, 3.0), 0),
    ("N=128, one whole chunk", 1024, 128, (0.0, 3.0), 0),
    ("N=256, two chunks", 512, 256, (0.0, 3.0), 0),
    ("N=5000, 40 chunks", 3, 5000, (0.0, 1.0), 0),
    ("4-byte storage offset", 4096, 64, (0.0, 3.0), 1),
    ("4-byte storage offset, N=3", 300, 3, (0.0, 3.0), 1),
]
# Cold-L2 timing: this many bytes are written between calls, more than twice
# the 50 MB L2.
FLUSH_BYTES = 128 * 2**20


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _graph(fn, calls: int):
    """``calls`` calls of ``fn`` captured into one CUDA graph, after three
    warm calls, so that replaying it leaves host overhead out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def _replay_ms(graph, calls: int) -> float:
    """Device ms per call of one replay of ``graph``, between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _device_ms(fn, calls: int = 50, reps: int = 21) -> float:
    """Median device time of one ``fn()`` call, in ms, over ``reps`` replays
    of a graph of ``calls`` calls."""
    graph = _graph(fn, calls)
    return statistics.median(_replay_ms(graph, calls) for _ in range(reps))


def _on_card(x: np.ndarray, offset: int = 0) -> torch.Tensor:
    """``x`` on the card; with ``offset``, as a contiguous view that many
    floats into a larger buffer."""
    buf = torch.empty(x.size + offset, device="cuda")
    view = buf[offset:].view(x.shape)
    view.copy_(torch.from_numpy(x))
    return view


def _k1_inputs(b: int, n: int, density_range, seed: int, offset: int = 0):
    rng = np.random.default_rng(seed)
    density = rng.uniform(*density_range, (b, n)).astype(np.float32)
    t_vals = np.sort(rng.uniform(0.1, 6.0, (b, n + 1)).astype(np.float32), -1)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    return [_on_card(x, offset) for x in (density, t_vals, dirs)]


def _cotangent(b: int, n: int, seed: int, offset: int = 0):
    return _on_card(np.random.default_rng(seed).normal(
        size=(b, n)).astype(np.float32), offset)


def _cold_ms(fn, flush, calls: int = 50, reps: int = 21) -> tuple:
    """Device ms of ``fn`` with its inputs cold in L2: (median, first and
    third quartile, ms of the flush alone). One graph runs ``flush`` (a write
    larger than L2) before each call of ``fn``, another the flush alone;
    their replays alternate, and each pair's difference is one reading, so
    that drift in the flush's time cancels within the pair."""
    both = _graph(lambda: (flush(), fn()), calls)
    alone = _graph(flush, calls)
    diffs, flush_ms = [], []
    for _ in range(reps):
        b, a = _replay_ms(both, calls), _replay_ms(alone, calls)
        diffs.append(b - a)
        flush_ms.append(a)
    q1, med, q3 = statistics.quantiles(diffs, n=4)
    return med, (q1, q3), statistics.median(flush_ms)


def _bound_ms(nbytes: int, flops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_name(mangled: str) -> str:
    """``composite_fwd_regs<16,true>`` from a kernel's mangled name."""
    m = re.search(r"(composite_[a-z]+_[a-z]+)(I((?:L[ib]\d+E)+)E)?", mangled)
    if not m:
        return mangled
    if not m.group(3):
        return m.group(1)
    return m.group(1) + "<" + ",".join(
        v if t == "i" else ("false", "true")[int(v)]
        for t, v in re.findall(r"L([ib])(\d+)E", m.group(3))) + ">"


def _ptxas_summary(log: str) -> list:
    """One line per kernel from ``nvcc -Xptxas -v``: its name (template
    arguments in brackets), registers, barriers and spills; other lines of
    the log (warnings) as they are."""
    out, name = [], None
    for line in log.strip().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = _kernel_name(entry.group(1))
            out.append(name + ":")
        elif name and ("registers" in line or "spill" in line):
            out[-1] += " " + line.split(":", 1)[-1].strip() + ";"
        elif "ptxas info" not in line and line.strip():
            out.append(line.strip())
    return out


# "/*0270*/  @!P0 MUFU.EX2 R17, R16 ;" -> "MUFU"
_SASS_OPCODE = re.compile(
    r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def _sass_summary(lib: Path, nvcc: str) -> list:
    """One line per kernel in ``lib``: its machine instructions (``cuobjdump
    -sass`` beside ``nvcc``, NOPs left out), and among them the
    transcendental (MUFU), shuffle (SHFL), global load (LDG) and store (STG)
    ones."""
    sass = subprocess.run(
        [str(Path(nvcc).with_name("cuobjdump")), "-sass", str(lib)],
        check=True, capture_output=True, text=True, timeout=300).stdout
    out, counts = [], None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            counts = dict.fromkeys(("all", "MUFU", "SHFL", "LDG", "STG"), 0)
            out.append((_kernel_name(head.group(1)), counts))
            continue
        ins = _SASS_OPCODE.match(line)
        if counts is None or not ins or ins.group(1) == "NOP":
            continue
        counts["all"] += 1
        if ins.group(1) in counts:
            counts[ins.group(1)] += 1
    return [f"{name}: {c['all']} instructions (MUFU {c['MUFU']}, SHFL "
            f"{c['SHFL']}, LDG {c['LDG']}, STG {c['STG']})"
            for name, c in out]


def _k1_bound_ms(b: int, n: int):
    """Least time for K1 at [b, n]: every input read once, w written once;
    ~8 f32 operations per sample (difference, two products, scan add,
    exp, expm1, carry add, product) beside the bytes."""
    nbytes = 4 * (b * n + b * (n + 1) + 3 * b) + 4 * b * n
    return _bound_ms(nbytes, 8 * b * n + 5 * b)


def _k2_bound_ms(b: int, n: int):
    """Least time for K2 at [b, n]: density, t_vals, dirs and g read once,
    d_density written once; ~16 f32 operations per sample (K1's 8 to
    recompute T and w, then exp, two products for g*w and the local term,
    the reverse scan add, carry add, subtraction, product by delta)."""
    nbytes = 4 * (b * n + b * (n + 1) + 3 * b + b * n) + 4 * b * n
    return _bound_ms(nbytes, 16 * b * n + 5 * b)


def _time_kernel(tag: str, launch, plain, make_args, bound, floor_ms, flush):
    """Times one kernel at the train batch B=4096, N=64: hot and cold in L2,
    with inputs at a 4-byte storage offset (no 16-byte accesses), and its plain
    version. ``make_args(offset)`` gives its inputs; ``bound`` is (ms, by)."""
    b, n = RENDER_CHUNK, 64
    args = make_args(0)
    ms = _device_ms(lambda: launch(*args))
    plain_ms = _device_ms(lambda: plain(*args))
    cold_ms, (cold_q1, cold_q3), flush_ms = _cold_ms(
        lambda: launch(*args), flush)
    shifted = make_args(1)
    unaligned_ms = _device_ms(lambda: launch(*shifted))
    bound_ms, bound_by = bound
    print(f"{tag} time B={b} N={n}: hot in L2 {ms * 1e3:.3f} us (less the "
          f"harness floor {floor_ms * 1e3:.3f} us: {(ms - floor_ms) * 1e3:.3f}"
          f" us), cold in L2 {cold_ms * 1e3:.3f} us (quartiles "
          f"{cold_q1 * 1e3:.3f}-{cold_q3 * 1e3:.3f} us; a "
          f"{FLUSH_BYTES >> 20} MiB write between calls, {flush_ms * 1e3:.2f}"
          f" us alone, taken out pair by pair), "
          f"inputs 4 bytes off 16-byte alignment (no 16-byte accesses, bounds "
          f"checked) {unaligned_ms * 1e3:.3f} us; "
          f"plain {plain_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.3f} us by "
          f"{bound_by}; no single PyTorch call computes {tag} (library_ms "
          "null)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, cold_ms=cold_ms,
                cold_quartiles_ms=[cold_q1, cold_q3], floor_ms=floor_ms,
                unaligned_ms=unaligned_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_k1(composite, floor_ms, flush):
    """Phase 3: K1 against its plain version on the card, then timed."""
    max_err = 0.0
    for seed, (label, b, n, rng, offset) in enumerate(KERNEL_CASES):
        density, t_vals, dirs = _k1_inputs(b, n, rng, seed, offset)
        w = composite.composite_weights(density, t_vals, dirs)
        ref = composite.plain_composite_weights(density, t_vals, dirs)
        torch.cuda.synchronize()
        err = (w - ref).abs().max().item()
        max_err = max(max_err, err)
        ok = torch.allclose(w, ref, rtol=K1_RTOL, atol=K1_ATOL)
        print(f"K1 vs plain [{label}] B={b} N={n} offset={offset}: "
              f"max_abs_err={err:.3e} rtol={K1_RTOL} atol={K1_ATOL} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok or not torch.isfinite(w).all():
            _fail(f"K1 disagrees with its plain version ({label})")
    times = _time_kernel(
        "K1", composite.composite_weights, composite.plain_composite_weights,
        lambda off: _k1_inputs(RENDER_CHUNK, 64, (0.0, 3.0), 99, off),
        _k1_bound_ms(RENDER_CHUNK, 64), floor_ms, flush)
    return dict(max_abs_err=max_err, **times)


def check_k2(composite, floor_ms, flush):
    """Phase 3b: K2 against its plain version on the card, with a seeded
    random cotangent, then timed."""
    max_err = 0.0
    for seed, (label, b, n, rng, offset) in enumerate(KERNEL_CASES):
        density, t_vals, dirs = _k1_inputs(b, n, rng, 100 + seed, offset)
        g = _cotangent(b, n, 200 + seed, offset)
        got = composite._launch_bwd(density, t_vals, dirs, g)
        ref = composite.plain_composite_weights_bwd(density, t_vals, dirs, g)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        max_err = max(max_err, err)
        ok = torch.allclose(got, ref, rtol=K2_RTOL, atol=K2_ATOL)
        print(f"K2 vs plain [{label}] B={b} N={n} offset={offset}: "
              f"max_abs_err={err:.3e} rtol={K2_RTOL} atol={K2_ATOL} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok or not torch.isfinite(got).all():
            _fail(f"K2 disagrees with its plain version ({label})")
    times = _time_kernel(
        "K2", composite._launch_bwd, composite.plain_composite_weights_bwd,
        lambda off: _k1_inputs(RENDER_CHUNK, 64, (0.0, 3.0), 98, off)
        + [_cotangent(RENDER_CHUNK, 64, 97, off)],
        _k2_bound_ms(RENDER_CHUNK, 64), floor_ms, flush)
    return dict(max_abs_err=max_err, **times)


def _kernel_class(name: str) -> str:
    if "composite_fwd" in name:
        return "K1 composite"
    if "composite_bwd" in name:
        return "K2 composite backward"
    if any(s in name.lower() for s in ("gemm", "nvjet", "cutlass", "sm90_xmma")):
        return "matmul (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def profile_call(fn, out_dir: Path, tag: str) -> dict:
    """``--profile DIR``: one warm call of ``fn`` (a render or a train step)
    under ``torch.profiler``; prints the device's busy share and its time by
    kernel class and by kernel, and writes the Chrome trace and the kernel
    table to ``out_dir`` as ``<tag>_trace.json`` and ``<tag>_kernels.txt``.
    Returns {kernel name: (launches, device us)}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, by_class = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        count, total = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, total + us)
        cls = _kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + us
    busy = sum(by_class.values())
    print(f"profile [{tag}]: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms "
          f"({100 * busy / wall_us:.1f}%), idle {100 * (1 - busy / wall_us):.1f}%",
          flush=True)
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"profile [{tag}]: {cls}: {us / 1e3:.2f} ms "
              f"({100 * us / busy:.1f}% of busy)", flush=True)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{tag}_kernels.txt", "w") as f:
        for name, (count, us) in rows:
            f.write(f"{us:12.1f} us {count:6d}x  {name}\n")
    for name, (count, us) in rows[:12]:
        print(f"profile [{tag}]: {us / 1e3:8.2f} ms {count:5d}x {name[:100]}",
              flush=True)
    prof.export_chrome_trace(str(out_dir / f"{tag}_trace.json"))
    return by_name


def _trace_ms(by_name: dict, key: str):
    """Per-launch device ms, and launches, of the kernels whose name holds
    ``key`` in a profile's {name: (launches, us)}."""
    hits = [(c, us) for name, (c, us) in by_name.items() if key in name]
    count = sum(c for c, _ in hits)
    return (sum(us for _, us in hits) / count / 1e3 if count else None), count


def _mlp_flops_per_sample(params) -> tuple:
    """GEMM FLOPs per sample of both MLPs: forward (2*in*out per layer) and
    backward (dW for every layer, dX for every layer whose input needs a
    gradient: all but the first layers of the proposal MLP and the trunk,
    whose input is the encoded rays)."""
    nerf = params["nerf"]
    towers = [(params["prop"], False), (nerf["trunk"], False),
              (nerf["density"], True), (nerf["rgb"], True)]
    fwd = bwd = 0
    for mlp, input_needs_grad in towers:
        for i, layer in enumerate(mlp["layers"]):
            gemm = 2 * layer["w"].shape[0] * layer["w"].shape[1]
            fwd += gemm
            bwd += gemm * (2 if i > 0 or input_needs_grad else 1)
    return fwd, bwd


def check_render_card_vs_cpu(mcfg, params_cpu, params, rays, tag: str):
    """Phases 5 and 9: the deterministic render of ``rays`` on the card
    against the CPU, same params, in float32 and in bfloat16."""
    from mipnerf360_torch.core.rays import rays_to_device
    from mipnerf360_torch.models.mipnerf360 import render_rays

    # float32, TF32 off: the paths differ only in summation order (cuBLAS vs
    # the CPU's GEMM over 1024-wide layers, warp scan vs cumsum), ~1e-6
    # relative per layer; resampling moves t by the same relative amount.
    # bfloat16: each layer's output is rounded to bf16 (8 bits, 4e-3
    # relative), and a different f32 summation order flips that rounding for
    # some units; the flips pass through 8 layers and both composites.
    checks = [("float32", dict(rtol=1e-4, atol=1e-4)),
              ("bfloat16", dict(rtol=2e-2, atol=2e-2))]
    for dtype, tol in checks:
        pcfg = dataclasses.replace(mcfg, compute_dtype=dtype)
        outs = {}
        for dev, p in (("cpu", params_cpu), ("cuda", params)):
            r = rays_to_device(rays, dev)
            with torch.inference_mode():
                out = render_rays(p, pcfg, r, randomized=False)
            outs[dev] = {k: out[k].float().cpu() for k in
                         ("rgb", "distance", "acc", "weights", "t_vals")}
        for k in outs["cpu"]:
            a, b = outs["cuda"][k], outs["cpu"][k]
            err = (a - b).abs().max().item()
            ok = torch.allclose(a, b, **tol)
            print(f"card vs cpu [{tag}, {dtype}] {k}: max_abs_err={err:.3e} "
                  f"rtol={tol['rtol']} atol={tol['atol']} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                _fail(f"card and CPU disagree on {k} in {dtype} ({tag})")


def drive_train(cfg, composite, card: str, profile_dir):
    """Phase 6: joint-cadence train steps at full width on the card: one warm
    step, then TRAIN_STEPS timed steps with the kernels' counts set to 0
    just before and read just after. Returns (K1 launches, K2 launches,
    the median rays/s of the timed steps, the profiled step's {kernel:
    (launches, us)} or None)."""
    from mipnerf360_torch.core.rays import rays_to_device, take_rays
    from mipnerf360_torch.data.synthetic import synthetic_dataset
    from mipnerf360_torch.train import init_train_state, make_train_step
    from mipnerf360_torch.train.state import leaves

    mcfg, batch = cfg.model, cfg.train.batch_size
    state = init_train_state(mcfg, cfg.train,
                             generator=torch.Generator().manual_seed(0),
                             device="cuda")
    train = synthetic_dataset(cfg.data, "train",
                              background=1.0 if mcfg.white_bkgd else 0.0)
    bank = rays_to_device(train.rays, "cuda")
    bank_pixels = torch.as_tensor(train.pixels, device="cuda")
    gen = torch.Generator().manual_seed(1)
    batches = []
    for _ in range(TRAIN_STEPS + 1):
        idx = torch.randint(train.n_rays, (batch,), generator=gen).cuda()
        batches.append((take_rays(bank, idx), bank_pixels[idx]))
    step = make_train_step(cfg)
    print(f"train: synthetic_quality, {cfg.train.cadence} cadence, "
          f"{batch} rays/step drawn from {train.n_images} train views "
          f"{train.h}x{train.w} ({train.n_rays} rays)", flush=True)
    before = [p.detach().clone() for p in leaves(state.params)]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, aux = step(state, *batches[0])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0

    composite.launches = composite.bwd_launches = 0
    times, auxes = [], []
    for rays, pixels in batches[1:]:
        t0 = time.perf_counter()
        state, aux = step(state, rays, pixels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        auxes.append(aux)
    k1, k2 = composite.launches, composite.bwd_launches
    peak = torch.cuda.max_memory_allocated()

    med = statistics.median(times)
    fwd, bwd = _mlp_flops_per_sample(state.params)
    flops = (fwd + bwd) * batch * mcfg.num_samples
    print(f"train step: first {warm * 1e3:.1f} ms; median of {len(times)} "
          f"timed steps {med * 1e3:.2f} ms/step (min {min(times) * 1e3:.2f}, "
          f"max {max(times) * 1e3:.2f}), {batch / med:.0f} rays/s; MLP GEMMs "
          f"{flops / 1e12:.2f} TFLOP/step ({fwd / 1e6:.2f} + {bwd / 1e6:.2f} "
          f"MFLOP/sample fwd + bwd), {flops / med / 1e12:.1f} TFLOP/s over "
          f"the step; peak memory {peak / 2**30:.2f} GiB; on {card}", flush=True)
    print(f"train step times (ms): {[round(t * 1e3, 3) for t in times]}",
          flush=True)
    print("train aux, last step: " + ", ".join(
        f"{k}={v.item():.6g}" for k, v in auxes[-1].items()), flush=True)
    print(f"train: K1 launches {k1}, K2 launches {k2} over {len(times)} steps "
          f"(expected {2 * len(times)} each)", flush=True)
    if (k1, k2) != (2 * len(times), 2 * len(times)):
        _fail(f"train steps launched K1 {k1} and K2 {k2} times, expected "
              f"{2 * len(times)} each")
    for i, aux in enumerate(auxes):
        bad = [k for k, v in aux.items() if not torch.isfinite(v).all()]
        if bad:
            _fail(f"train step {i}: aux {bad} not finite")
    unchanged = [i for i, (a, b) in enumerate(zip(before, leaves(state.params)))
                 if torch.equal(a, b)]
    if unchanged:
        _fail(f"param leaves {unchanged} did not change over the train steps")
    print(f"train: all aux finite, all {len(before)} param leaves changed",
          flush=True)
    trace = None
    if profile_dir is not None:
        trace = profile_call(lambda: step(state, *batches[1]), profile_dir,
                             "train")
    return k1, k2, batch / med, trace


def _rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def check_train_card_vs_cpu(cfg):
    """Phase 7: one joint step's losses and per-leaf gradients at full width,
    card against CPU: same params, same 128 rays of the train split, same
    explicit noise."""
    from mipnerf360_torch.core.rays import rays_to_device, take_rays
    from mipnerf360_torch.data.synthetic import synthetic_dataset
    from mipnerf360_torch.models.mipnerf360 import RenderNoise
    from mipnerf360_torch.train import init_train_state, joint_cadence_grads
    from mipnerf360_torch.train.state import make_train_state

    train = synthetic_dataset(cfg.data, "train",
                              background=1.0 if cfg.model.white_bkgd else 0.0)
    rng = np.random.default_rng(3)
    idx = rng.choice(train.n_rays, PARITY_RAYS, replace=False)
    rays = take_rays(train.rays, idx)
    pixels = torch.from_numpy(train.pixels[idx])
    n = cfg.model.num_samples
    eps = np.finfo(np.float32).eps
    noise = RenderNoise(
        torch.from_numpy(rng.uniform(size=(PARITY_RAYS, n + 1)).astype(np.float32)),
        torch.from_numpy(rng.uniform(0.0, 1.0 / (n + 1) - eps,
                                     (PARITY_RAYS, n + 1)).astype(np.float32)))
    cpu = init_train_state(cfg.model, cfg.train,
                           generator=torch.Generator().manual_seed(2),
                           device="cpu")
    card = make_train_state(cpu.params, device="cuda",
                            generator=torch.Generator("cuda"))
    # float32, TF32 off: only summation orders differ (cuBLAS vs the CPU's
    # GEMM, warp scans vs cumsum), as for the render: the losses are held at
    # rtol 1e-4 / atol 1e-4. The gradients are held per leaf, by relative L2
    # error, at 2e-3: the resampled t of the NeRF level differ by ~1e-6 (as
    # the render check shows), so a few trunk pre-activations within ~1e-6
    # of zero flip their ReLU mask between the two, and each flip moves one
    # sample's whole term of a dW column. That puts trunk leaves at 2e-4 -
    # 7e-4 (the proposal MLP's and the heads' at ~1e-7) on the card this
    # was measured on, and single entries near atol 1e-4; a wrong formula
    # is off by 1e-2 or more. The largest entrywise ratio is printed too.
    # bfloat16: every hidden unit is rounded to bf16 forward, and dX and dW
    # are rounded to bf16 backward; another f32 summation order flips some
    # of those roundings (2^-8 relative each), and the flips pass through 8
    # layers both ways and both composites. Losses are held at rtol 2e-2 /
    # atol 2e-2 as the render's outputs, gradient leaves at a relative L2
    # error of 5e-2.
    checks = [("float32", dict(rtol=1e-4, atol=1e-4), 2e-3),
              ("bfloat16", dict(rtol=2e-2, atol=2e-2), 5e-2)]
    for dtype, tol, grad_rel_l2 in checks:
        dcfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype))
        outs = {}
        for dev, state in (("cpu", cpu), ("cuda", card)):
            grads, aux = joint_cadence_grads(
                dcfg, state, rays_to_device(rays, dev), pixels.to(dev),
                noise=RenderNoise(*(x.to(dev) for x in noise)))
            outs[dev] = ({k: v.cpu() for k, v in aux.items()},
                         [g.cpu() for k in ("prop", "nerf") for g in grads[k]])
        (aux_cpu, g_cpu), (aux_card, g_card) = outs["cpu"], outs["cuda"]
        for k in aux_cpu:
            err = (aux_card[k] - aux_cpu[k]).abs().item()
            ok = torch.allclose(aux_card[k], aux_cpu[k], **tol)
            print(f"train card vs cpu [{dtype}] {k}: card {aux_card[k].item():.7g} "
                  f"cpu {aux_cpu[k].item():.7g} abs_err={err:.3e} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                _fail(f"train step: card and CPU disagree on {k} in {dtype}")
        worst_abs = worst_rel = worst_frac = 0.0
        for i, (a, b) in enumerate(zip(g_card, g_cpu)):
            err, rel = (a - b).abs().max().item(), _rel_l2(a, b)
            # largest |a - b| / (atol + rtol * |b|), for the record
            frac = ((a - b).abs() / (tol["atol"] + tol["rtol"] * b.abs())).max().item()
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            worst_frac = max(worst_frac, frac)
            if rel > grad_rel_l2:
                print(f"train card vs cpu [{dtype}] grad leaf {i} "
                      f"{tuple(b.shape)}: max_abs_err={err:.3e} "
                      f"max|cpu|={b.abs().max().item():.3e} rel_l2={rel:.3e} "
                      "MISMATCH", flush=True)
                _fail(f"train step: card and CPU gradients disagree in {dtype}")
        print(f"train card vs cpu [{dtype}] {len(g_cpu)} grad leaves: "
              f"max_abs_err={worst_abs:.3e} max rel_l2={worst_rel:.3e} "
              f"(rel_l2<={grad_rel_l2}) ok; largest entry's err/(atol+rtol*"
              f"|cpu|) at rtol={tol['rtol']} atol={tol['atol']}: "
              f"{worst_frac:.3f}", flush=True)


def sync_sites(cfg, here: Path) -> Counter:
    """Phase 8a: two steps of the banked train loop under
    ``torch.cuda.set_sync_debug_mode("warn")``: {file:line: count} of the
    Python lines whose ops synchronized the host with the card."""
    from mipnerf360_torch.core.rays import rays_to_device
    from mipnerf360_torch.data import get_dataset
    from mipnerf360_torch.train import init_train_state, make_banked_train_loop

    ds = get_dataset(cfg.data, "train", white_bkgd=cfg.model.white_bkgd)
    bank = (rays_to_device(ds.rays, "cuda"),
            torch.as_tensor(ds.pixels, device="cuda"))
    idx = torch.as_tensor(ds.index_stack(2, cfg.train.batch_size, 0, 0)).cuda()
    state = init_train_state(cfg.model, cfg.train, device="cuda")
    loop = make_banked_train_loop(cfg)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            loop(state, *bank, idx)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sites = Counter()
    for w in caught:
        if "synchroniz" in str(w.message):
            path = Path(w.filename).resolve()
            name = (str(path.relative_to(here)) if path.is_relative_to(here)
                    else "/".join(path.parts[-3:]))
            sites[f"{name}:{w.lineno}"] += 1
    return sites


def _metric_records(ckpt: Path) -> list:
    with open(ckpt / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _cadences(cfg, sets) -> dict:
    """The trainer's log, save and eval cadences under ``sets`` (K=V)."""
    over = dict(s.split("=", 1) for s in sets)
    return {k: int(over.get(f"train.{k}", getattr(cfg.train, k)))
            for k in ("log_every", "save_every", "eval_every",
                      "eval_image_every")}


def _trainer_launches(cfg, every: dict, test, start: int, end: int):
    """K1 and K2 launches of a trainer run from ``start`` to ``end``: two of
    each per step; two K1 per forward of the eval_every batch, and per
    render chunk of each view of the image eval (``eval_image_views`` of the
    ``test`` split's views, all of them when -1)."""
    crossings = lambda n: (end // n - start // n) if n else 0
    k = cfg.train.eval_image_views
    views = test.n_images if k <= 0 or k >= test.n_images else k
    chunks = -(-test.h * test.w // cfg.train.eval_image_chunk)
    k1 = (2 * (end - start) + 2 * crossings(every["eval_every"])
          + 2 * views * chunks * crossings(every["eval_image_every"]))
    return k1, 2 * (end - start)


def _drive(label: str, composite, want, fn):
    """``fn()`` with the kernels' launch counts set to 0 just before and
    read just after; fails unless they are ``want`` (K1, K2). Returns (what
    ``fn`` returned, (K1, K2), wall seconds)."""
    composite.launches = composite.bwd_launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (composite.launches, composite.bwd_launches)
    print(f"{label}: {wall:.1f} s, start-up included; K1 launches {got[0]}, "
          f"K2 launches {got[1]} (expected {want[0]} and {want[1]})",
          flush=True)
    if got != tuple(want):
        _fail(f"{label} launched K1 {got[0]} and K2 {got[1]} times, "
              f"expected {tuple(want)}")
    return out, got, wall


def _clean_chunks(records: list, every: dict) -> list:
    """(step, perf/rays_per_sec) of the logged chunks whose timing window
    holds no eval and no save: those not right after a boundary where one
    ran."""
    chunks = [(r["step"], r["perf/rays_per_sec"]) for r in records
              if "perf/rays_per_sec" in r]
    busy = {s for s, _ in chunks for n in
            ("save_every", "eval_every", "eval_image_every")
            if every[n] and s % every[n] == 0}
    return [(s, v) for s, v in chunks if s - every["log_every"] not in busy]


def drive_trainer(cfg, composite, card: str, here: Path, work: Path,
                  step_rays_per_s: float, init_psnr: float):
    """Phase 8: the trainer path through ``apps.train.main`` in process, at
    full width: run A straight to TRAINER_STEPS, run B to half of it, then
    ``--resume`` to TRAINER_STEPS; then ``apps.eval.main`` on A. Each run
    is driven with the kernels' counts set to 0 just before and read just
    after. Checkpoints go to ``work``/A and ``work``/B. Returns (K1, K2)
    launches of run A."""
    from mipnerf360_torch import native
    from mipnerf360_torch.apps import eval as eval_app
    from mipnerf360_torch.apps import train as train_app
    from mipnerf360_torch.data import get_dataset
    from mipnerf360_torch.train import init_train_state
    from mipnerf360_torch.train.checkpoint import restore_checkpoint
    from mipnerf360_torch.train.state import leaves

    sites = sync_sites(cfg, here)
    print("train loop, host syncs in 2 banked steps by source line: "
          + (", ".join(f"{k} x{v}" for k, v in sorted(sites.items()))
             or "none"), flush=True)
    ours = [k for k in sites if k.startswith("mipnerf360_torch/train/")]
    if ours:
        _fail(f"the train loop syncs with the host at {ours}")

    test = get_dataset(cfg.data, "test", white_bkgd=cfg.model.white_bkgd)
    every = _cadences(cfg, TRAINER_SETS)

    def expected(start: int, end: int):
        return _trainer_launches(cfg, every, test, start, end)

    def run(name: str, ckpt: Path, steps: int, resume: bool = False):
        argv = ["--preset", "synthetic_quality",
                "--set", f"train.checkpoint_dir={ckpt}",
                "--set", f"train.max_steps={steps}"]
        argv += [a for s in TRAINER_SETS for a in ("--set", s)]
        argv += ["--resume"] if resume else []
        start = 0
        if resume:
            start = max(r["step"] for r in _metric_records(ckpt))
        return _drive(f"trainer run {name} (steps {start} -> {steps})",
                      composite, expected(start, steps),
                      lambda: train_app.main(argv))

    def same_state(a, b) -> bool:
        tensors = lambda s: leaves(s.params) + [
            t for k in ("prop", "nerf")
            for t in leaves(s.opt_state[k].mu) + leaves(s.opt_state[k].nu)]
        return ((a.step, a.sched_count) == (b.step, b.sched_count)
                and all(torch.equal(x, y)
                        for x, y in zip(tensors(a), tensors(b))))

    batcher = "g++ build" if native.native_available() else "NumPy (no g++)"
    print(f"trainer: batcher path {batcher}; {TRAINER_STEPS} steps of "
          f"{cfg.train.batch_size} rays, " + ", ".join(TRAINER_SETS),
          flush=True)
    dir_a, dir_b = work / "A", work / "B"
    half = TRAINER_STEPS // 2
    state_a, launches_a, _ = run("A", dir_a, TRAINER_STEPS)
    state_b, _, _ = run("B", dir_b, half)
    restored_b = restore_checkpoint(
        str(dir_b), init_train_state(cfg.model, cfg.train, device="cuda"))
    a_half = restore_checkpoint(
        str(dir_a), init_train_state(cfg.model, cfg.train, device="cuda"),
        step=half)
    exact_b = same_state(restored_b, state_b) and torch.equal(
        restored_b.generator.get_state(), state_b.generator.get_state())
    equal_a = same_state(restored_b, a_half)
    print(f"trainer: B's checkpoint at step {half} restores B's state "
          f"{'exactly' if exact_b else 'NOT exactly'} (generator "
          f"included); it equals A's ckpt_{half} "
          f"{'exactly' if equal_a else 'NOT exactly'}", flush=True)
    if not exact_b or not equal_a:
        _fail(f"the step-{half} restore is not exact")
    del state_b, restored_b, a_half
    state_b, _, _ = run("B resumed", dir_b, TRAINER_STEPS, resume=True)

    rec_a, rec_b = _metric_records(dir_a), _metric_records(dir_b)
    loss_a = {r["step"]: r["train/loss"] for r in rec_a if "train/loss" in r}
    loss_b = {r["step"]: r["train/loss"] for r in rec_b if "train/loss" in r}
    bad = [(s, v) for s, v in list(loss_a.items()) + list(loss_b.items())
           if not np.isfinite(v)]
    if bad or sorted(loss_a) != sorted(loss_b):
        _fail(f"trainer losses not finite or not logged alike: {bad}, "
              f"{sorted(loss_a)} vs {sorted(loss_b)}")
    print("trainer run A train/loss by step: " + ", ".join(
        f"{s}: {v:.5f}" for s, v in sorted(loss_a.items())), flush=True)
    after = [s for s in sorted(loss_a) if s > half]
    rel = max(abs(loss_b[s] - loss_a[s]) / abs(loss_a[s]) for s in after)
    identical = (all(loss_a[s] == loss_b[s] for s in loss_a)
                 and same_state(state_a, state_b))
    print(f"trainer: B's losses after the resume vs A's: largest relative "
          f"difference {rel:.3e} (rtol {TRAINER_LOSS_RTOL}); the card ran "
          f"A and B {'bit-identically' if identical else 'NOT bit-identically'}"
          " (every logged loss and the final state)", flush=True)
    if rel > TRAINER_LOSS_RTOL:
        _fail("B's losses after the resume disagree with A's")
    first, last = loss_a[min(loss_a)], loss_a[max(loss_a)]
    if not last < first:
        _fail(f"run A's loss did not fall: {first} -> {last}")

    clean = _clean_chunks(rec_a, every)
    trainer_rays = statistics.median(v for _, v in clean)
    print(f"trainer perf/rays_per_sec, run A, chunks of "
          f"{every['log_every']} steps without eval or save "
          f"{[(s, round(v)) for s, v in clean]}: median {trainer_rays:.0f}"
          f" rays/s, against {step_rays_per_s:.0f} rays/s for the bare "
          f"step of phase 6 ({trainer_rays / step_rays_per_s:.3f}x); on "
          f"{card}", flush=True)

    summary = eval_app.main(["--ckpt", str(dir_a), "--device", "cuda"])
    print(f"eval of run A (step {summary['step']}): mean PSNR "
          f"{summary['mean_psnr']:.3f} dB over {summary['n_views']} "
          f"views, against {init_psnr:.3f} dB for phase 4's render at "
          "random init", flush=True)
    if (summary["n_views"] != test.n_images
            or not summary["mean_psnr"] > init_psnr):
        _fail("the eval after training is not above the random-init PSNR")
    return launches_a


def write_llff_capture(out: Path, n_views: int, w: int, h: int,
                       factor: int) -> None:
    """An LLFF-layout capture of the synthetic scene's analytic sphere on a
    full orbit (the JAX package's ``tools/parity_psnr.py`` recipe, written
    with the port's modules): ``images_<factor>/NNN.png`` of w x h with a
    black background, and ``poses_bounds.npy``. The loader divides the
    stored focal by ``factor``, so the file holds ``factor`` times the focal
    of the written images; its rotation columns are [-up, right, back] (the
    inverse of the loader's swap), and its bounds bracket the sphere."""
    from mipnerf360_torch.data.rays_gen import pinhole_rays
    from mipnerf360_torch.data.synthetic import (_orbit_poses_at,
                                                 _shade_sphere, _train_angles)
    from mipnerf360_torch.utils.png import save_png

    focal = 0.9 * w
    poses = _orbit_poses_at(_train_angles(n_views))
    img_dir = out / f"images_{factor}"
    img_dir.mkdir(parents=True)

    def write(i):
        rays = pinhole_rays(poses[i:i + 1], h, w, focal, 2.0, 6.0)
        rgb = _shade_sphere(rays.origins[0], rays.viewdirs[0], background=0.0)
        save_png(str(img_dir / f"{i:03d}.png"),
                 np.clip(rgb * 255 + 0.5, 0, 255).astype(np.uint8))

    with ThreadPoolExecutor(CAPTURE_WORKERS) as pool:
        list(pool.map(write, range(n_views)))
    rows = []
    for pose in poses:
        right, up, back, t = pose.T
        hwf = np.array([h * factor, w * factor, focal * factor], np.float64)
        d = float(np.linalg.norm(t))
        rows.append(np.concatenate([
            np.stack([-up, right, back, t, hwf], axis=1).reshape(-1),
            [d - 1.3, d + 2.0]]))
    np.save(out / "poses_bounds.npy", np.asarray(rows, np.float64))


def write_blender_capture(out: Path, n_train: int, n_test: int,
                          res: int) -> None:
    """A Blender-layout capture of the analytic sphere: ``transforms_{train,
    test}.json`` and res x res RGBA PNGs, alpha 255 on the sphere and 0
    around it. The held-out views interleave with the train views on one
    orbit (the JAX package's ``tools/parity_psnr.py`` recipe)."""
    from mipnerf360_torch.data.rays_gen import pinhole_rays
    from mipnerf360_torch.data.synthetic import (_orbit_poses_at,
                                                 _shade_sphere, _train_angles)
    from mipnerf360_torch.utils.png import save_png

    focal = 0.9 * res
    n_total = n_train + n_test
    poses = _orbit_poses_at(_train_angles(n_total))
    test_idx = sorted(set(np.linspace(0, n_total, n_test, endpoint=False)
                          .astype(int).tolist()))
    splits = {"train": [i for i in range(n_total) if i not in test_idx],
              "test": test_idx}
    jobs = [(split, j, i) for split, idx in splits.items()
            for j, i in enumerate(idx)]

    def write(job):
        split, j, i = job
        rays = pinhole_rays(poses[i:i + 1], res, res, focal, 2.0, 6.0)
        rgb = _shade_sphere(rays.origins[0], rays.viewdirs[0], background=0.0)
        # no lit sphere pixel is black: the albedo 0.5 * (n + 1) never is
        alpha = np.where(rgb.any(-1, keepdims=True), 255, 0).astype(np.uint8)
        rgb8 = np.clip(rgb * 255 + 0.5, 0, 255).astype(np.uint8)
        save_png(str(out / split / f"r_{j}.png"),
                 np.concatenate([rgb8, alpha], -1))

    for split in splits:
        (out / split).mkdir(parents=True)
    with ThreadPoolExecutor(CAPTURE_WORKERS) as pool:
        list(pool.map(write, jobs))
    for split, idx in splits.items():
        frames = []
        for j, i in enumerate(idx):
            c2w = np.eye(4)
            c2w[:3, :4] = poses[i]
            frames.append({"file_path": f"{split}/r_{j}",
                           "transform_matrix": c2w.tolist()})
        with open(out / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": float(2 * np.arctan(0.5 * res / focal)),
                       "frames": frames}, f)


def _image_reader() -> str:
    from mipnerf360_torch import native
    from mipnerf360_torch.utils.png import pil_available

    if pil_available():
        return "PIL"
    return ("the port's PNG decoder, "
            + ("g++ unfilter" if native.native_available()
               else "NumPy unfilter"))


def drive_garden(composite, card: str, work: Path, step_rays_per_s: float):
    """Phase 9: ``garden_quality`` at full width on an LLFF-layout capture
    at garden's size at factor 8: load it, render a sixth of the held-out
    views at random init (card against CPU on 128 of their rays),
    ``apps.train`` (run A: host staging, as stage_mode=auto picks for this
    bank; run B: the first GARDEN_BANK_STEPS with the bank on the card),
    ``apps.eval --lpips`` on every held-out view, and ``apps.video --depth
    --normals`` on the spherified orbit. Returns ({path: (K1, K2)}, (rendered view 0 at
    random init, its target), the random LPIPS weights)."""
    import resource

    from mipnerf360_torch.apps import eval as eval_app
    from mipnerf360_torch.apps import train as train_app
    from mipnerf360_torch.apps import video as video_app
    from mipnerf360_torch.apps.common import apply_overrides
    from mipnerf360_torch.config import get_config
    from mipnerf360_torch.core.rays import take_rays
    from mipnerf360_torch.data import get_dataset
    from mipnerf360_torch.data.llff import _load_images
    from mipnerf360_torch.models.mipnerf360 import (init_model, map_params,
                                                    render_image)
    from mipnerf360_torch.utils import metrics
    from mipnerf360_torch.utils.lpips import random_weights

    capture = work / "garden"
    t0 = time.perf_counter()
    write_llff_capture(capture, GARDEN_VIEWS, GARDEN_W, GARDEN_H,
                       GARDEN_FACTOR)
    print(f"garden: capture of {GARDEN_VIEWS} views {GARDEN_W}x{GARDEN_H} "
          f"(images_{GARDEN_FACTOR}, poses_bounds.npy) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    base = [f"data.base_dir={capture}"]
    cfg = apply_overrides(get_config("garden_quality"), base)
    mcfg = cfg.model
    print(f"model: garden_quality, {mcfg.num_samples} samples/ray, proposal "
          f"{mcfg.hidden_proposal}x{mcfg.proposal_depth}, nerf "
          f"{mcfg.hidden_nerf}x{mcfg.nerf_depth}, {mcfg.ray_shape} rays, "
          f"white_bkgd={mcfg.white_bkgd}, use_ndc={cfg.data.use_ndc}, "
          f"{mcfg.compute_dtype} matmuls, {cfg.train.batch_size} rays/step",
          flush=True)

    # The host's load: every PNG decoded, then the rays of a split.
    t0 = time.perf_counter()
    n_png = _load_images(str(capture / f"images_{GARDEN_FACTOR}")).shape[0]
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    test = get_dataset(cfg.data, "test", white_bkgd=mcfg.white_bkgd)
    load_s = time.perf_counter() - t0
    print(f"garden load, image reader {_image_reader()}: {n_png} PNGs "
          f"decoded in {decode_s:.2f} s ({decode_s / n_png * 1e3:.1f} ms "
          f"each); the test split ({test.n_images} views, {test.n_rays} "
          f"rays, near {test.near:.4f}, far {test.far:.4f}) in {load_s:.2f} "
          f"s with the decode, {(load_s - decode_s) / test.n_images * 1e3:.1f}"
          " ms of ray generation per view", flush=True)
    if (test.n_images, test.h, test.w) != (
            len(range(0, GARDEN_VIEWS, 8)), GARDEN_H, GARDEN_W):
        _fail(f"garden test split {test.n_images} views {test.h}x{test.w}")
    n_train = GARDEN_VIEWS - test.n_images
    chunks_per_view = -(-test.h * test.w // cfg.train.eval_image_chunk)

    # Every GARDEN_INIT_STRIDE-th held-out view at random init (the
    # trainer's init: same seed).
    params_cpu = init_model(mcfg, torch.Generator().manual_seed(
        cfg.train.seed))
    params = map_params(lambda p: p.cuda(), params_cpu)
    hw = test.h * test.w
    init_views = np.arange(0, test.n_images, GARDEN_INIT_STRIDE)
    init_rays = take_rays(test.rays, (init_views[:, None] * hw
                                      + np.arange(hw)).reshape(-1))
    n_init_rays = len(init_views) * hw
    n_chunks = -(-n_init_rays // cfg.train.eval_image_chunk)
    (rgb, _, _), launches_init, dt = _drive(
        f"garden render of held-out views {init_views.tolist()} at random "
        f"init, chunk {cfg.train.eval_image_chunk}", composite,
        (2 * n_chunks, 0),
        lambda: render_image(params, mcfg, init_rays,
                             chunk=cfg.train.eval_image_chunk, device="cuda"))
    views = (-1, test.h, test.w, 3)
    rgb = rgb.cpu().numpy().reshape(views)
    targets = test.pixels.reshape(views)[init_views]
    if not np.isfinite(rgb).all():
        _fail("garden render at random init is not finite")
    init_psnr = float(np.mean([metrics.psnr(a, b) for a, b in
                               zip(rgb, targets)]))
    print(f"garden render at random init: {n_init_rays / dt:.0f} rays/s "
          f"({n_init_rays} rays, {len(init_views)} views of "
          f"{GARDEN_W}x{GARDEN_H}, first call); mean PSNR {init_psnr:.3f} "
          f"dB; on {card}", flush=True)
    idx = np.random.default_rng(9).choice(n_init_rays, PARITY_RAYS,
                                          replace=False)
    check_render_card_vs_cpu(mcfg, params_cpu, params,
                             take_rays(init_rays, idx), "garden_quality")
    lpips_view = (rgb[0], targets[0])
    del params, params_cpu, rgb, init_rays

    every = _cadences(cfg, GARDEN_SETS)

    def run(name: str, ckpt: Path, steps: int, extra=()):
        argv = ["--preset", "garden_quality", "--device", "cuda",
                "--set", f"train.checkpoint_dir={ckpt}",
                "--set", f"train.max_steps={steps}"]
        argv += [a for s in base + GARDEN_SETS + list(extra)
                 for a in ("--set", s)]
        torch.cuda.reset_peak_memory_stats()
        _, got, wall = _drive(
            f"garden trainer run {name} (steps 0 -> {steps})", composite,
            _trainer_launches(cfg, every, test, 0, steps),
            lambda: train_app.main(argv))
        recs = _metric_records(ckpt)
        staging = [r for r in recs if "data/device_bank" in r][0]
        print(f"garden trainer run {name}: staging "
              f"{'device bank' if staging['data/device_bank'] else 'host'} "
              f"({staging['data/train_bytes'] / 2**30:.3f} GiB of train "
              f"rays and pixels, {n_train} views); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        return recs, got, staging["data/device_bank"]

    dir_a, dir_b = work / "garden_A", work / "garden_B"
    rec_a, launches_a, bank_a = run("A", dir_a, GARDEN_STEPS)
    rec_b, launches_b, bank_b = run(
        "B", dir_b, GARDEN_BANK_STEPS, ["train.stage_mode=device_bank"])
    if bank_a or not bank_b:
        _fail("stage_mode=auto did not stage from the host, or device_bank "
              "did not use the bank")
    loss_a = {r["step"]: r["train/loss"] for r in rec_a if "train/loss" in r}
    loss_b = {r["step"]: r["train/loss"] for r in rec_b if "train/loss" in r}
    if not all(np.isfinite(v) for v in list(loss_a.values())
               + list(loss_b.values())):
        _fail("garden trainer losses are not finite")
    print("garden trainer run A train/loss by step: " + ", ".join(
        f"{s}: {v:.5f}" for s, v in sorted(loss_a.items())), flush=True)
    if not loss_a[max(loss_a)] < loss_a[min(loss_a)]:
        _fail("garden run A's loss did not fall")
    rel = max(abs(loss_b[s] - loss_a[s]) / abs(loss_a[s]) for s in loss_b)
    identical = all(loss_b[s] == loss_a[s] for s in loss_b)
    print(f"garden: the bank run's losses at steps {sorted(loss_b)} against "
          f"host staging's: largest relative difference {rel:.3e} (rtol "
          f"{TRAINER_LOSS_RTOL}), "
          f"{'bit-identical' if identical else 'NOT bit-identical'}",
          flush=True)
    if rel > TRAINER_LOSS_RTOL:
        _fail("host staging and the bank give different losses")
    clean_a, clean_b = _clean_chunks(rec_a, every), _clean_chunks(rec_b, every)
    host_rays = statistics.median(v for _, v in clean_a)
    print(f"garden trainer perf/rays_per_sec, chunks of {every['log_every']} "
          f"steps without eval or save: host staging (run A) "
          f"{[(s, round(v)) for s, v in clean_a]}, median {host_rays:.0f}; "
          f"the bank (run B) {[(s, round(v)) for s, v in clean_b]}; the bare "
          f"step of phase 6 {step_rays_per_s:.0f} rays/s (host staging "
          f"{host_rays / step_rays_per_s:.3f}x); on {card}", flush=True)

    weights = random_weights(torch.Generator().manual_seed(0))
    npz = work / "lpips_random_weights.npz"
    np.savez(npz, **{k: v.numpy() for k, v in weights.items()})
    summary, launches_eval, wall = _drive(
        f"garden apps.eval --lpips (random weights) on all {test.n_images} "
        "held-out views", composite,
        (2 * test.n_images * chunks_per_view, 0),
        lambda: eval_app.main(["--ckpt", str(dir_a), "--lpips", str(npz),
                               "--device", "cuda"]))
    eval_psnr = float(np.mean(
        [summary["per_view_psnr"][v] for v in init_views]))
    print(f"garden eval of run A (step {summary['step']}): mean PSNR "
          f"{summary['mean_psnr']:.3f} dB, SSIM {summary['mean_ssim']:.4f}, "
          f"LPIPS of random VGG weights (not LPIPS) "
          f"{summary['mean_lpips']:.4f} over {summary['n_views']} views; "
          f"{eval_psnr:.3f} dB on views {init_views.tolist()} against "
          f"{init_psnr:.3f} dB at random init; "
          f"{test.n_rays / wall:.0f} rays/s over the whole app (load, "
          "render, PNGs, metrics)", flush=True)
    if (summary["n_views"] != test.n_images
            or not eval_psnr > init_psnr
            or not np.isfinite(summary["mean_lpips"])):
        _fail("the garden eval is not above the random-init PSNR")

    video, launches_video, wall = _drive(
        f"garden apps.video --depth --normals, {GARDEN_VIDEO_POSES} poses",
        composite, (2 * GARDEN_VIDEO_POSES * chunks_per_view, 0),
        lambda: video_app.main([
            "--ckpt", str(dir_a), "--depth", "--normals", "--device", "cuda",
            "--set", f"data.n_render_poses={GARDEN_VIDEO_POSES}"]))
    _check_video(video, GARDEN_VIDEO_POSES, (GARDEN_H, GARDEN_W), "garden",
                 card)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"garden: peak host RSS of this process so far {rss:.2f} GiB",
          flush=True)
    launches = {"garden_init_render": launches_init,
                "garden_trainer_host": launches_a,
                "garden_trainer_bank": launches_b,
                "garden_eval": launches_eval, "garden_video": launches_video}
    return launches, lpips_view, weights


def _check_video(video: dict, n_frames: int, hw, tag: str, card: str):
    print(f"{tag} video: {video['n_frames']} frames of {video['h']}x"
          f"{video['w']}, {video['rays_per_sec']:.0f} rays/s over the render "
          f"loop; written: " + ", ".join(f"{k} -> {Path(v).name}" for k, v in
                                         video["outputs"].items())
          + f"; on {card}", flush=True)
    if (video["n_frames"], (video["h"], video["w"])) != (n_frames, tuple(hw)):
        _fail(f"{tag} video: {video['n_frames']} frames of {video['h']}x"
              f"{video['w']}")
    for name, path in video["outputs"].items():
        if not Path(path).exists():
            _fail(f"{tag} video: {name} not written")


def drive_lego(composite, card: str, work: Path):
    """Phase 10: ``blender_lego_quality`` at full width on a Blender-layout
    capture: ``apps.train`` for LEGO_STEPS steps, then ``apps.video`` on
    LEGO_VIDEO_POSES poses of the synthesized 800x800 render path. Returns
    {path: (K1, K2)}."""
    from mipnerf360_torch.apps import train as train_app
    from mipnerf360_torch.apps import video as video_app
    from mipnerf360_torch.config import get_config

    capture = work / "lego"
    t0 = time.perf_counter()
    write_blender_capture(capture, LEGO_TRAIN, LEGO_TEST, LEGO_RES)
    print(f"lego: capture of {LEGO_TRAIN} + {LEGO_TEST} RGBA views "
          f"{LEGO_RES}x{LEGO_RES} written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = get_config("blender_lego_quality")
    ckpt = work / "lego_A"
    argv = ["--preset", "blender_lego_quality", "--device", "cuda",
            "--set", f"data.base_dir={capture}",
            "--set", f"train.checkpoint_dir={ckpt}",
            "--set", f"train.max_steps={LEGO_STEPS}",
            "--set", "train.lr_max_steps=10000"]
    torch.cuda.reset_peak_memory_stats()
    every = _cadences(cfg, [])
    test = SimpleNamespace(n_images=LEGO_TEST, h=LEGO_RES // 2,
                           w=LEGO_RES // 2)
    _, launches_train, wall = _drive(
        f"lego trainer (blender_lego_quality, factor {cfg.data.factor}, "
        f"steps 0 -> {LEGO_STEPS})", composite,
        _trainer_launches(cfg, every, test, 0, LEGO_STEPS),
        lambda: train_app.main(argv))
    recs = _metric_records(ckpt)
    staging = [r for r in recs if "data/device_bank" in r][0]
    losses = [(r["step"], r["train/loss"]) for r in recs if "train/loss" in r]
    if not losses or not all(np.isfinite(v) for _, v in losses):
        _fail(f"lego trainer losses {losses}")
    print(f"lego trainer: staging "
          f"{'device bank' if staging['data/device_bank'] else 'host'} "
          f"({staging['data/train_bytes'] / 2**30:.3f} GiB); train/loss "
          f"{losses}; rays/s by chunk "
          f"{[round(r['perf/rays_per_sec']) for r in recs if 'perf/rays_per_sec' in r]}"
          f"; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    chunks = -(-cfg.data.render_h * cfg.data.render_w // 8192)
    video, launches_video, _ = _drive(
        f"lego apps.video, {LEGO_VIDEO_POSES} poses of the "
        f"{cfg.data.render_w}x{cfg.data.render_h} render path", composite,
        (2 * LEGO_VIDEO_POSES * chunks, 0),
        lambda: video_app.main([
            "--ckpt", str(ckpt), "--device", "cuda",
            "--set", f"data.n_render_poses={LEGO_VIDEO_POSES}"]))
    _check_video(video, LEGO_VIDEO_POSES,
                 (cfg.data.render_h, cfg.data.render_w), "lego", card)
    return {"lego_trainer": launches_train, "lego_video": launches_video}


def drive_small(composite, card: str, work: Path, lpips_view, weights):
    """Phase 11: ``apps.video`` on phase 8's run A (the synthetic render
    split), the port's PNG decoder against the loaders' reader on garden
    views, LPIPS on the card against the CPU on one garden view, and
    ``checkify_fn`` on the card. Returns {path: (K1, K2)}."""
    from mipnerf360_torch import native
    from mipnerf360_torch.apps import video as video_app
    from mipnerf360_torch.config import get_config
    from mipnerf360_torch.utils.checks import NonFiniteError, checkify_fn
    from mipnerf360_torch.utils.lpips import lpips

    data = get_config("synthetic_quality").data
    n, res = data.synthetic_views, data.synthetic_resolution
    video, launches, _ = _drive(
        f"synthetic apps.video on phase 8's run A, {n} poses", composite,
        (2 * n * -(-res * res // 8192), 0),
        lambda: video_app.main(["--ckpt", str(work / "A"), "--device",
                                "cuda"]))
    _check_video(video, n, (res, res), "synthetic", card)

    # The port's own PNG decoder against the reader the loaders used, on
    # the garden capture's first views.
    from mipnerf360_torch.utils.png import load_image, read_png

    pngs = sorted((work / "garden" / f"images_{GARDEN_FACTOR}").iterdir())
    pngs = pngs[:PNG_CHECK_VIEWS]
    t0 = time.perf_counter()
    ours = [read_png(str(f)).astype(np.float32) / 255.0 for f in pngs]
    ours_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    theirs = [load_image(str(f)) for f in pngs]
    theirs_s = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for a, b in zip(ours, theirs))
    unfilter = "g++" if native.native_available() else "NumPy"
    print(f"PNG: the port's decoder ({unfilter} unfilter) on {len(pngs)} "
          f"garden views: {ours_s / len(pngs) * 1e3:.1f} ms "
          f"each, {_image_reader()} {theirs_s / len(pngs) * 1e3:.1f} ms "
          f"each; arrays {'identical' if same else 'DIFFERENT'}", flush=True)
    if not same:
        _fail("the port's PNG decoder disagrees with the loaders' reader")

    img, ref = lpips_view
    cpu = float(lpips(img, ref, weights))
    on_card = {k: v.cuda() for k, v in weights.items()}
    got = float(lpips(torch.as_tensor(img, device="cuda"), ref, on_card))
    rel = abs(got - cpu) / abs(cpu)
    print(f"LPIPS (random VGG weights) of garden view 0 at random init, "
          f"{img.shape[1]}x{img.shape[0]}: card {got:.8f}, cpu {cpu:.8f}, "
          f"relative difference {rel:.3e} (rtol {LPIPS_RTOL}, TF32 off)",
          flush=True)
    if not rel <= LPIPS_RTOL:
        _fail("LPIPS on the card disagrees with the CPU")

    x = torch.tensor([1.0, 4.0], device="cuda")
    try:
        checkify_fn(lambda t: torch.log(t - 2.0))(x)
    except NonFiniteError as e:
        caught = str(e)
    else:
        _fail("checkify_fn let a NaN through on the card")
    ok = checkify_fn(lambda t: torch.sqrt(t) * 2.0)(x)
    if not torch.equal(ok, torch.sqrt(x) * 2.0):
        _fail("checkify_fn changed a finite result on the card")
    print(f"checkify_fn on the card: raised '{caught}' on log(x - 2); "
          "returned sqrt(x) * 2 unchanged", flush=True)
    return {"synthetic_video": launches}


def _params_sha256(params) -> str:
    """A digest of every byte of a params tree (to show ranks agree)."""
    from mipnerf360_torch.train.state import leaves

    h = hashlib.sha256()
    for p in leaves(params):
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _parallel_batch(cfg, n: int):
    """``n`` rays and pixels of the synthetic train split, drawn from a
    seed: the batch of phase 12b's steps (the tensor-parallel step takes its
    first PARALLEL_TP_BATCH)."""
    from mipnerf360_torch.core.rays import take_rays
    from mipnerf360_torch.data.synthetic import synthetic_dataset

    train = synthetic_dataset(cfg.data, "train",
                              background=1.0 if cfg.model.white_bkgd else 0.0)
    idx = np.random.default_rng(12).choice(train.n_rays, n, replace=False)
    return take_rays(train.rays, idx), train.pixels[idx]


def _counted(composite, fn):
    """(fn(), (K1, K2) launches of this process during it, wall s)."""
    composite.launches = composite.bwd_launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (composite.launches, composite.bwd_launches), \
        time.perf_counter() - t0


def _worker_12a(out: Path, argv: list) -> None:
    """Phase 12a's rank (under torchrun): ``apps.train.main(argv +
    ["--multihost"])``; writes the process group's backend and world size
    (read as the trainer leaves the group) and the run's K1 and K2
    launches."""
    import torch.distributed as dist

    from mipnerf360_torch.apps import train as train_app
    from mipnerf360_torch.ops import composite

    seen = {}
    leave = dist.destroy_process_group

    def destroy(*args, **kwargs):
        seen.update(backend=dist.get_backend(), world=dist.get_world_size())
        return leave(*args, **kwargs)

    dist.destroy_process_group = destroy
    _, (k1, k2), wall = _counted(composite,
                                 lambda: train_app.main(argv + ["--multihost"]))
    out.write_text(json.dumps(dict(seen, k1=k1, k2=k2, wall=wall)))


def _worker_12b(out_dir: Path, backend: str) -> None:
    """Phase 12b's rank under torchrun: over gloo every rank on cuda:0,
    over NCCL one card per rank (``--ranks``). On P ranks: the
    data-parallel step (data=P), the tensor-parallel step (data=P/2,
    model=2), and the render with data=P and with sample_shards=2 (data
    P/2). Rank r writes ``rank<r>.json`` (launch counts, times, digests of
    the params after each step) and rank 0 also ``rank0.npz`` (the global
    losses and gradients, the renders)."""
    import torch.distributed as dist

    from mipnerf360_torch.config import get_config
    from mipnerf360_torch.data.synthetic import synthetic_dataset
    from mipnerf360_torch.models.mipnerf360 import (init_model, map_params,
                                                    render_image)
    from mipnerf360_torch.ops import composite
    from mipnerf360_torch.parallel import init_distributed, make_mesh, shutdown
    from mipnerf360_torch.parallel.mesh import (broadcast_state_,
                                                gather_params, gather_state,
                                                shard_batch, shard_state)
    from mipnerf360_torch.train import (init_train_state, joint_cadence_grads,
                                        joint_cadence_step)
    from mipnerf360_torch.train.state import leaves

    dev = (init_distributed("cuda") if backend == "nccl"
           else init_distributed("cuda:0", backend="gloo"))
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = get_config("synthetic_quality")
    rays, pixels = _parallel_batch(cfg, PARALLEL_DP_BATCH)
    res = {"backend": dist.get_backend(), "world": world, "device": str(dev)}
    arrays = {}

    def state(mesh):
        s = init_train_state(cfg.model, cfg.train,
                             generator=torch.Generator().manual_seed(0),
                             device=dev)
        broadcast_state_(s)
        return shard_state(mesh, s)

    meshes = {"dp": make_mesh(world, 1, device=dev),
              "tp": make_mesh(world // 2, 2, device=dev)}
    for name, batch in (("dp", PARALLEL_DP_BATCH), ("tp", PARALLEL_TP_BATCH)):
        mesh = meshes[name]
        r, p = shard_batch(mesh, _first_rays(rays, batch), pixels[:batch])
        s = state(mesh)
        grads, aux = joint_cadence_grads(cfg, s, r, p, mesh=mesh)
        full = gather_params(mesh, {k: _tree_like(s.params[k], grads[k])
                                    for k in ("prop", "nerf")})
        arrays.update({f"{name}_aux_{k}": v.item() for k, v in aux.items()})
        arrays.update({f"{name}_grad_{i}": g.cpu().numpy() for i, g in
                       enumerate(leaves(full["prop"]) + leaves(full["nerf"]))})
        s = state(mesh)
        (s, _), launches, wall = _counted(
            composite, lambda: joint_cadence_step(cfg, s, r, p, mesh=mesh))
        res[f"{name}_step"] = dict(
            k1=launches[0], k2=launches[1], s=wall,
            sha256=_params_sha256(gather_state(mesh, s).params))
        del s, grads, full

    test = synthetic_dataset(cfg.data, "test",
                             background=1.0 if cfg.model.white_bkgd else 0.0)
    params = map_params(lambda x: x.to(dev), init_model(
        cfg.model, torch.Generator().manual_seed(0)))
    # The sample-sharded render gets no mesh: it builds its (P/2, 2) mesh on
    # the card it is asked for, whatever the backend.
    for name, mcfg, mesh in (
            ("render_dp", cfg.model, meshes["dp"]),
            ("render_samples", dataclasses.replace(cfg.model, sample_shards=2),
             None)):
        out, launches, wall = _counted(composite, lambda: render_image(
            params, mcfg, test.rays, chunk=RENDER_CHUNK, mesh=mesh,
            device="cuda"))
        if not all(x.is_cuda for x in out):
            _fail(f"12b {name}: rank {rank} rendered off the card")
        res[name] = dict(k1=launches[0], k2=launches[1], s=wall)
        arrays[name] = torch.cat([out[0], out[1][:, None], out[2][:, None]],
                                 -1).cpu().numpy()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(res))
    if rank == 0:
        np.savez(out_dir / "rank0.npz", **arrays)
    shutdown()


def _first_rays(rays, n: int):
    """The first ``n`` rays."""
    from mipnerf360_torch.core.rays import rays_map

    return rays_map(lambda x: x[:n], rays)


def _tree_like(tree, flat):
    """``flat`` (in ``leaves`` order) arranged as ``tree``."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


def _torchrun(nproc: int, args: list, here: Path, log: Path) -> None:
    """``python -m torch.distributed.run --standalone --nproc_per_node=nproc
    chip_smoke.py --worker *args``, its output to ``log``; the whole
    process group is killed at PARALLEL_TIMEOUT_S. Fails on a non-zero
    exit."""
    import os
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(here / "chip_smoke.py"),
           "--worker", *map(str, args)]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=here, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=PARALLEL_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "killed at the time limit"
    if rc != 0:
        print(log.read_text()[-6000:], flush=True)
        _fail(f"torchrun of {args[0]} on {nproc} rank(s) exited {rc}")


def _one_process_grads(cfg, n: int):
    """The one-process joint step's losses and gradients on the card, on
    the first ``n`` rays of phase 12b's batch, from the state 12b's ranks
    start from: ({loss: float}, [gradient leaves, prop then nerf])."""
    from mipnerf360_torch.core.rays import rays_to_device
    from mipnerf360_torch.train import init_train_state, joint_cadence_grads

    rays, pixels = _parallel_batch(cfg, PARALLEL_DP_BATCH)
    state = init_train_state(cfg.model, cfg.train,
                             generator=torch.Generator().manual_seed(0),
                             device="cuda")
    grads, aux = joint_cadence_grads(
        cfg, state, rays_to_device(_first_rays(rays, n), "cuda"),
        torch.as_tensor(pixels[:n], device="cuda"))
    return ({k: v.item() for k, v in aux.items()},
            [g.cpu() for k in ("prop", "nerf") for g in grads[k]])


def drive_parallel(cfg, card: str, here: Path, work: Path, render_ref,
                   step_rays_per_s: float) -> dict:
    """Phase 12: the parallel layer on the card. 12a: ``apps.train
    --multihost`` under torchrun at world size 1 over NCCL, against phase
    8's run A. 12b: two gloo ranks sharing the card, each check against
    the one-process result on the card. Returns {path: (K1, K2)}."""
    every = _cadences(cfg, TRAINER_SETS)
    ckpt = work / "P12a"
    argv = ["--preset", "synthetic_quality",
            "--set", f"train.checkpoint_dir={ckpt}",
            "--set", f"train.max_steps={PARALLEL_STEPS}"]
    argv += [a for s in TRAINER_SETS for a in ("--set", s)]
    seen_path = work / "p12a.json"
    _torchrun(1, ["12a", seen_path, *argv], here, work / "p12a.log")
    seen = json.loads(seen_path.read_text())
    loss_a = {r["step"]: r["train/loss"] for r in _metric_records(work / "A")
              if "train/loss" in r}
    rec = _metric_records(ckpt)
    loss = {r["step"]: r["train/loss"] for r in rec if "train/loss" in r}
    steps = sorted(loss)
    rel = max(abs(loss[s] - loss_a[s]) / abs(loss_a[s]) for s in steps)
    same = all(loss[s] == loss_a[s] for s in steps)
    want = (2 * PARALLEL_STEPS, 2 * PARALLEL_STEPS)
    print(f"parallel 12a: apps.train --multihost under torchrun, process "
          f"group backend {seen['backend']}, world size {seen['world']}, "
          f"{PARALLEL_STEPS} steps in {seen['wall']:.1f} s (start-up "
          f"included); train/loss " + ", ".join(
              f"step {s}: {loss[s]:.6f} (run A {loss_a[s]:.6f})"
              for s in steps)
          + f"; largest relative difference {rel:.3e} (rtol "
          f"{TRAINER_LOSS_RTOL}), {'bit-identical' if same else 'NOT bit-identical'}"
          f" to phase 8's run A; K1 launches {seen['k1']}, K2 launches "
          f"{seen['k2']} (expected {want[0]} and {want[1]})", flush=True)
    if (seen["backend"], seen["world"]) != ("nccl", 1):
        _fail(f"12a ran on {seen['backend']} with world size {seen['world']}")
    if steps != [s for s in sorted(loss_a) if s <= PARALLEL_STEPS]:
        _fail(f"12a logged losses at {steps}")
    if rel > TRAINER_LOSS_RTOL:
        _fail("12a's losses disagree with phase 8's run A")
    if (seen["k1"], seen["k2"]) != want:
        _fail(f"12a launched K1 {seen['k1']} and K2 {seen['k2']} times")
    clean = _clean_chunks(rec, every)
    clean = [(s, v) for s, v in clean if s > every["log_every"]]
    clean_a = _clean_chunks(_metric_records(work / "A"), every)
    rays_a = statistics.median(v for _, v in clean_a)
    print(f"parallel 12a: perf/rays_per_sec of the chunks after the first "
          f"{[(s, round(v)) for s, v in clean]} against run A's median "
          f"{rays_a:.0f} ({clean[-1][1] / rays_a:.3f}x) and the bare step's "
          f"{step_rays_per_s:.0f}; on {card}", flush=True)

    paths = {"parallel_12a_trainer_nccl_1rank": (seen["k1"], seen["k2"])}
    paths.update(_drive_ranks(cfg, here, work, render_ref, 2, "gloo"))
    return paths


def _drive_ranks(cfg, here: Path, work: Path, render_ref, nproc: int,
                 backend: str) -> dict:
    """Phase 12b on ``nproc`` ranks over ``backend`` (gloo: the ranks share
    cuda:0; NCCL: one card each), every check against the one-process
    result on the card. Returns {path: (K1, K2)} per rank."""
    refs = {name: _one_process_grads(cfg, n) for name, n in
            (("dp", PARALLEL_DP_BATCH), ("tp", PARALLEL_TP_BATCH))}
    torch.cuda.empty_cache()
    out = work / f"p12b_{backend}_{nproc}"
    out.mkdir()
    t0 = time.perf_counter()
    _torchrun(nproc, ["12b", out, backend], here, out.with_suffix(".log"))
    wall = time.perf_counter() - t0
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(nproc)]
    got = np.load(out / "rank0.npz")
    how = ("sharing the card: gloo moves CUDA tensors through the host, so "
           "these are correctness runs, not speeds" if backend == "gloo"
           else "one card each")
    print(f"parallel 12b: {nproc} ranks over {ranks[0]['backend']} on "
          f"{sorted({r['device'] for r in ranks})}, {wall:.1f} s with "
          f"start-up ({how})", flush=True)
    tag = f"parallel_12b_{backend}{nproc}"
    layouts = {"dp": f"data={nproc}", "tp": f"data={nproc // 2}, model=2",
               "render_dp": f"data={nproc}",
               "render_samples": f"data={nproc // 2}, sample_shards=2"}
    paths = {}
    for name, batch in (("dp", PARALLEL_DP_BATCH), ("tp", PARALLEL_TP_BATCH)):
        aux_ref, grads_ref = refs[name]
        worst = 0.0
        for k, v in aux_ref.items():
            g = float(got[f"{name}_aux_{k}"])
            if not np.isclose(g, v, **PARALLEL_BF16):
                _fail(f"12b {name}: {k} {g} against one process {v}")
        for i, ref in enumerate(grads_ref):
            rel = _rel_l2(torch.from_numpy(got[f"{name}_grad_{i}"]), ref)
            worst = max(worst, rel)
            if rel > PARALLEL_GRAD_REL_L2:
                _fail(f"12b {name}: gradient leaf {i} rel_l2 {rel:.3e}")
        digests = {r[f"{name}_step"]["sha256"] for r in ranks}
        steps = [r[f"{name}_step"] for r in ranks]
        print(f"parallel 12b {name} step ({layouts[name]}, {batch} rays at "
              "full width): losses " + ", ".join(
                  f"{k} {float(got[f'{name}_aux_{k}']):.6g} (one process "
                  f"{v:.6g})" for k, v in aux_ref.items())
              + f"; {len(grads_ref)} gradient leaves, largest rel_l2 "
              f"{worst:.3e} (<= {PARALLEL_GRAD_REL_L2}); params after the "
              f"step {'bit-identical' if len(digests) == 1 else 'DIFFERENT'}"
              f" on all {nproc} ranks; per rank K1/K2 launches "
              f"{[(s['k1'], s['k2']) for s in steps]} (expected 2/2), "
              f"{[round(s['s'], 3) for s in steps]} s", flush=True)
        if len(digests) != 1:
            _fail(f"12b {name}: the ranks' params differ after the step")
        for r, st in enumerate(steps):
            if (st["k1"], st["k2"]) != (2, 2):
                _fail(f"12b {name}: rank {r} launched K1 {st['k1']} and K2 "
                      f"{st['k2']} times in the step")
            paths[f"{tag}_{name}_step_rank{r}"] = (st["k1"], st["k2"])
    n_chunks = -(-render_ref.shape[0] // RENDER_CHUNK)
    for name, per_chunk in (("render_dp", 2), ("render_samples", 1)):
        diff = np.abs(got[name] - render_ref)
        ok = np.allclose(got[name], render_ref, **PARALLEL_BF16)
        counts = [(r[name]["k1"], r[name]["k2"]) for r in ranks]
        print(f"parallel 12b {name} ({layouts[name]}, {render_ref.shape[0]} "
              f"rays, chunk {RENDER_CHUNK}) against phase 4's render: "
              f"max_abs_err {diff.max():.3e} (rtol/atol "
              f"{PARALLEL_BF16['rtol']}) {'ok' if ok else 'MISMATCH'}; per "
              f"rank K1/K2 launches {counts} (expected {per_chunk * n_chunks}"
              f"/0), {[round(r[name]['s'], 3) for r in ranks]} s", flush=True)
        if not ok or not np.isfinite(got[name]).all():
            _fail(f"12b {name} disagrees with phase 4's render")
        for r, c in enumerate(counts):
            if c != (per_chunk * n_chunks, 0):
                _fail(f"12b {name}: rank {r} launched K1/K2 {c}")
            paths[f"{tag}_{name}_rank{r}"] = c
    return paths


def _multicard(nproc: int, card: str, here: Path) -> int:
    """``--ranks N``: phase 12b over NCCL with one card per rank, on a host
    with N cards; its reference render is phase 4's. Builds the kernels
    first (phase 2)."""
    from mipnerf360_torch.config import get_config
    from mipnerf360_torch.data.synthetic import synthetic_dataset
    from mipnerf360_torch.models.mipnerf360 import (init_model, map_params,
                                                    render_image)
    from mipnerf360_torch.ops import _build

    if torch.cuda.device_count() < nproc:
        _fail(f"--ranks {nproc} needs {nproc} cards, this host has "
              f"{torch.cuda.device_count()}")
    print(f"built {sorted(_build.build())}", flush=True)
    cfg = get_config("synthetic_quality")
    test = synthetic_dataset(cfg.data, "test",
                             background=1.0 if cfg.model.white_bkgd else 0.0)
    params = map_params(lambda p: p.cuda(), init_model(
        cfg.model, torch.Generator().manual_seed(0)))
    rgb, distance, acc = render_image(params, cfg.model, test.rays,
                                      chunk=RENDER_CHUNK, device="cuda")
    render_ref = torch.cat([rgb, distance[:, None], acc[:, None]],
                           -1).cpu().numpy()
    (here / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=here / "build"))
    try:
        paths = _drive_ranks(cfg, here, work, render_ref, nproc, "nccl")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"launches_by_path": paths}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def drive_tools(composite, card: str, here: Path,
                step_rays_per_s: float) -> dict:
    """Phase 13: the port's measuring layer through its entry points on the
    card, each path with the kernels' counts set to 0 just before it and
    read just after. Returns {path: (K1, K2)}."""
    from mipnerf360_torch.tools import ab_step, bench, profile_step

    t_start = time.perf_counter()
    window = ["--steps", str(TOOLS_STEPS), "--warmup", str(TOOLS_WARMUP),
              "--repeats", str(TOOLS_REPEATS)]
    calls = max(2, TOOLS_WARMUP) + TOOLS_REPEATS
    train_want = (2 * calls * TOOLS_STEPS,) * 2
    paths, rates = {}, {}
    for name, flags, want in (
            ("quality_compute", ["--quality"], train_want),
            ("bank_staging", ["--quality", "--staging"], train_want),
            ("host_staging", ["--quality", "--staging", "--stage-host"],
             train_want),
            # TOOLS_STEPS chunks of --batch rays per render, K1 twice each
            ("render", ["--mode", "render", "--quality"],
             (2 * calls * TOOLS_STEPS, 0))):
        out, got, _ = _drive(f"tools: bench {' '.join(flags)}", composite,
                             want, lambda: bench.main(window + flags))
        if out["card"] != card or not np.isfinite(out["value"]):
            _fail(f"tools: bench {name} gave {out}")
        paths[f"tools_bench_{name}"] = got
        rates[name] = out["value"]
    ratio = rates["quality_compute"] / step_rays_per_s
    print(f"tools: bench rays/s quality compute {rates['quality_compute']}, "
          f"bank staging {rates['bank_staging']}, host staging "
          f"{rates['host_staging']}, render {rates['render']} "
          f"({TOOLS_STEPS} steps per window, {TOOLS_REPEATS} windows); "
          f"quality compute {ratio:.3f}x phase 6's bare step "
          f"{step_rays_per_s:.0f} rays/s (allowed {TOOLS_RATE_RANGE}); on "
          f"{card}", flush=True)
    if not TOOLS_RATE_RANGE[0] <= ratio <= TOOLS_RATE_RANGE[1]:
        _fail(f"tools: the bench's quality compute is {ratio:.3f}x the "
              "bare step's rays/s")

    cmd = [sys.executable, "-m", "mipnerf360_torch.tools.bench", "--steps",
           "3", "--warmup", "2", "--repeats", "1"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                         timeout=TOOLS_TIMEOUT_S)
    if res.returncode != 0:
        print(res.stdout[-3000:] + res.stderr[-6000:], flush=True)
        _fail(f"tools: {' '.join(cmd[1:])} exited {res.returncode}")
    line = json.loads(res.stdout.strip().splitlines()[-1])
    detail = {"headline", "parity_compute", "quality_compute",
              "quality_staging", "mfu_matmul_headline", "spread"}
    print(f"tools: {' '.join(cmd[2:])} in {time.perf_counter() - t0:.1f} s "
          f"(start-up included): {json.dumps(line)}", flush=True)
    if (set(line) != {"metric", "value", "unit", "vs_baseline", "card",
                      "detail"} or set(line["detail"]) != detail
            or line["metric"] != "train_rays_per_sec_per_chip"
            or line["card"] != card or not np.isfinite(line["value"])):
        _fail("tools: the bench's default line lacks its keys or its card")

    # profile_step: prop_forward and nerf_forward launch K1 once per call,
    # the full step K1 and K2 twice, each piece once warm and then
    # REPEATS x 2 times; one more prop_forward makes the NeRF's inputs.
    n = 1 + profile_step.REPEATS * 2
    prof, got, _ = _drive("tools: profile_step --quality --steps 2",
                          composite, (4 * n + 1, 2 * n), lambda:
                          profile_step.main(["--quality", "--steps", "2"]))
    if not all(np.isfinite(r["device_ms"]) and r["device_ms"] > 0
               for r in prof["pieces"]):
        _fail(f"tools: profile_step gave {prof['pieces']}")
    paths["tools_profile_step"] = got
    steps = 2 * (1 + max(2, ab_step.WARMUP - 1) + ab_step.REPEATS)
    ab, got, _ = _drive("tools: ab_step no_distortion --k 2", composite,
                        (2 * steps, 2 * steps),
                        lambda: ab_step.main(["no_distortion", "--k", "2"]))
    if not np.isfinite(ab["ms_per_step"]) or ab["card"] != card:
        _fail(f"tools: ab_step gave {ab}")
    paths["tools_ab_step_no_distortion"] = got
    print(f"tools: phase 13 took {time.perf_counter() - t_start:.1f} s",
          flush=True)
    return paths


def _quality_launches(steps: int, per_step, every: dict, image_evals: int,
                      chunks: int, extra_k1: int = 0):
    """K1 and K2 launches of a parity_psnr run: ``per_step`` (K1, K2) per
    train step; two K1 per forward of each eval_every batch and of each of
    the ``chunks`` render chunks of the held-out views at each image eval
    (the trainer's and ``image_evals`` more); ``extra_k1`` for the probe."""
    k1 = (per_step[0] * steps + 2 * (steps // every["eval_every"])
          + 2 * chunks * (steps // every["eval_image_every"] + image_evals)
          + extra_k1)
    return k1, per_step[1] * steps


def _finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return bool(np.isfinite(tree))
    return True


def drive_quality(composite, card: str, here: Path) -> dict:
    """Phase 14: the quality layer through ``parity_psnr.run`` on the card,
    each run with the kernels' counts set to 0 just before it and read just
    after. Returns {path: (K1, K2)}."""
    from mipnerf360_torch.data import get_dataset
    from mipnerf360_torch.tools import parity_psnr as pp
    from mipnerf360_torch.train import init_train_state
    from mipnerf360_torch.train.trainer import evaluate_images

    t_start = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_quality_",
                                 dir=here / "build"))
    paths = {}
    try:
        scene = str(work / "scene")
        pp.export_blender_scene(scene, QUALITY_RES)
        base = pp._ours_cfg(scene, 1, "")
        test = get_dataset(base.data, "test", white_bkgd=True)
        chunks = test.n_images * -(-test.h * test.w
                                   // base.train.eval_image_chunk)
        init = {}
        for name, quality in (("quality", True), ("parity", False)):
            cfg = pp._ours_cfg(scene, 1, "", quality=quality)
            state = init_train_state(cfg.model, cfg.train, device="cuda")
            init[name] = evaluate_images(cfg, state.params, test,
                                         device="cuda")["eval/psnr_image"]
        print(f"quality: exported scene {QUALITY_RES}x{QUALITY_RES}, "
              f"{test.n_images} held-out views; random-init image PSNR "
              f"{init['quality']:.3f} dB (quality model), "
              f"{init['parity']:.3f} dB (parity model)", flush=True)

        def run(mode, steps, base_train=None):
            return pp.run(pp.parse_args([
                "--mode", mode, "--steps", str(steps), "--res",
                str(QUALITY_RES), "--scene-dir", scene, "--workdir",
                str(work / mode)]), base_train=base_train)

        def check(name, section, image_psnr, init_psnr):
            if section["card"] != card or not _finite(section):
                _fail(f"quality: {name} gave non-finite values or another "
                      f"card: {json.dumps(section)[:2000]}")
            if not image_psnr or not max(image_psnr.values()) > init_psnr:
                _fail(f"quality: {name}'s image PSNR {image_psnr} does not "
                      f"beat the random-init render's {init_psnr:.3f} dB")

        every = {"eval_every": 10, "eval_image_every": QUALITY_EVAL_EVERY}
        steps = QUALITY_CONV_STEPS
        conv, got, _ = _drive(
            f"quality: convergence {steps} steps", composite,
            _quality_launches(steps, (2, 2), every, 2, chunks),
            lambda: run("convergence", steps, base_train={
                "eval_image_every": QUALITY_EVAL_EVERY,
                "lr_max_steps": QUALITY_LR_STEPS}))
        paths["quality_convergence"] = got
        imgs = conv["ours"]["image_psnr"]
        check("convergence", conv, imgs, init["quality"])
        with open(here / "PARITY_PSNR.json") as f:
            recorded = json.load(f)["convergence"]["ours"]["image_psnr"]
        want = recorded[str(steps)]
        print(f"quality: convergence image PSNR by step "
              f"{ {s: round(v, 3) for s, v in sorted(imgs.items())} }; at "
              f"step {steps} {imgs[steps]:.3f} dB against the JAX record's "
              f"{want:.3f} dB (TPU v5e): {imgs[steps] - want:+.3f} dB "
              f"(allowed -{QUALITY_MARGIN_DB}); best checkpoint "
              f"{conv['summary']['best_checkpoint']['eval/psnr_image']:.3f}"
              f" dB at step {conv['summary']['best_checkpoint']['step']}; "
              f"on {card}", flush=True)
        if not imgs[steps] >= want - QUALITY_MARGIN_DB:
            _fail(f"quality: convergence at step {steps} is more than "
                  f"{QUALITY_MARGIN_DB} dB under the JAX record")

        steps = QUALITY_QEB_STEPS
        every = {"eval_every": 10, "eval_image_every": max(10, steps // 4)}
        qeb, got, _ = _drive(
            f"quality: quality-equal-batch {steps} steps", composite,
            _quality_launches(steps, (6, 3), every, 0, chunks),
            lambda: run("quality-equal-batch", steps))
        paths["quality_equal_batch"] = got
        qeb_imgs = pp.parse_ours_metrics(
            str(work / "quality-equal-batch" / "ours_ckpt_qeb"))["image_psnr"]
        check("quality-equal-batch", qeb, qeb_imgs, init["quality"])

        steps = QUALITY_ABLATE_STEPS
        every = {"eval_every": 10, "eval_image_every": max(10, steps // 4)}
        variants = pp.ABLATE_VARIANTS
        pp.ABLATE_VARIANTS = {"both": variants["both"]}
        try:
            abl, got, _ = _drive(
                f"quality: ablate both {steps} steps", composite,
                # the probe: 8 batches, each rendered randomized and not
                _quality_launches(steps, (6, 3), every, 0, chunks,
                                  extra_k1=8 * 2 * 2),
                lambda: run("ablate", steps))
        finally:
            pp.ABLATE_VARIANTS = variants
        paths["quality_ablate_both"] = got
        both = abl["variants"]["both"]
        check("ablate both", abl, {steps: both["final_image_psnr"]},
              init["parity"])
        gap = abs(both["probe"]["train_psnr_randomized"]
                  - both["probe"]["train_psnr_deterministic"])
        print(f"quality: quality-equal-batch image PSNR "
              f"{ {s: round(v, 3) for s, v in sorted(qeb_imgs.items())} }, "
              f"ours >= reference at {qeb['ours_ge_ref_frac']} of the shared "
              f"steps; ablate both {both}, probe gap {gap:.3f} dB; phase 14 "
              f"took {time.perf_counter() - t_start:.1f} s on {card}",
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return paths


def _row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over each row's largest |want|, in float64."""
    got, want = got.double().cpu(), want.double().cpu()
    scale = want.abs().amax(-1, keepdim=True)
    return float(((got - want).abs() / torch.where(scale > 0, scale, 1.0))
                 .max())


def _spike_synthetic(b: int, n: int, seed: int):
    """Inputs of the spike's regime: density 0 (a tenth) or log-uniform in
    [1e-6, 1e4]; cotangent 0 (a tenth) or +-10^U(0, 12)."""
    rng = np.random.default_rng(seed)
    density = np.where(rng.uniform(size=(b, n)) < 0.1, 0.0,
                       10.0 ** rng.uniform(-6, 4, (b, n))).astype(np.float32)
    t_vals = np.sort(rng.uniform(2.0, 6.0, (b, n + 1)), -1).astype(np.float32)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    g = np.where(rng.uniform(size=(b, n)) < 0.1, 0.0,
                 rng.choice([-1.0, 1.0], (b, n))
                 * 10.0 ** rng.uniform(0, 12, (b, n))).astype(np.float32)
    return [_on_card(x) for x in (density, t_vals, dirs, g)]


def drive_spike(composite, card: str, here: Path) -> dict:
    """Phase 15: K1 and K2 in the spike regime of the proposal-distillation
    loss, and the distillation part of the step on the card's spike rays,
    card against CPU. Returns {path: (K1, K2)}."""
    from mipnerf360_torch.losses.distillation import distillation_loss

    t_start = time.perf_counter()
    z = np.load(here / SPIKE_FIXTURE)
    steps = [int(s) for s in z["steps"]]
    fx = [{k: torch.from_numpy(np.ascontiguousarray(z[k][i])) for k in z.files
           if k != "steps"} for i in range(len(steps))]

    def hinge_cotangent(f):
        w = f["w_prop"].clone().requires_grad_()
        loss = distillation_loss(f["t_nerf"], f["w_nerf"], f["t_prop"], w)
        return torch.autograd.grad(loss, w)[0]

    cases = []
    for step, f in zip(steps, fx):
        g = hinge_cotangent(f)
        for level in ("prop", "nerf"):
            cases.append((f"step {step} {level}",
                          [f[f"density_{level}"].cuda(),
                           f[f"t_{level}"].cuda(), f["dirs"].cuda(),
                           g.cuda()]))
    cases.append((f"synthetic B={SPIKE_SYNTH_RAYS} N=64",
                  _spike_synthetic(SPIKE_SYNTH_RAYS, 64, 15)))
    for label, (density, t_vals, dirs, g) in cases:
        w = composite._launch(density, t_vals, dirs)
        w_ref = composite.plain_composite_weights(density, t_vals, dirs)
        dd = composite._launch_bwd(density, t_vals, dirs, g)
        dd_ref = composite.plain_composite_weights_bwd(density, t_vals,
                                                       dirs, g)
        torch.cuda.synchronize()
        k1_err = (w - w_ref).abs().max().item()
        k2_err = _row_err(dd, dd_ref)
        k1_ok = (torch.isfinite(w).all().item()
                 and torch.allclose(w, w_ref, rtol=K1_RTOL, atol=K1_ATOL))
        k2_ok = torch.isfinite(dd).all().item() and k2_err <= SPIKE_ROW_RTOL
        print(f"spike: K1 vs plain [{label}] max_abs_err={k1_err:.3e} "
              f"(rtol {K1_RTOL}, atol {K1_ATOL}) {'ok' if k1_ok else 'MISMATCH'};"
              f" K2 vs plain: {k2_err:.3e} of the ray's largest |d_density| "
              f"(<= {SPIKE_ROW_RTOL}; |g| up to "
              f"{g.abs().max().item():.2e}, |d_density| up to "
              f"{dd_ref.abs().max().item():.2e}) "
              f"{'ok' if k2_ok else 'MISMATCH'}", flush=True)
        if not k1_ok:
            _fail(f"spike: K1 disagrees with its plain version ({label})")
        if not k2_ok:
            _fail(f"spike: K2 disagrees with its plain version ({label})")

    def distill(device):
        """Each fixture step's loss and d_density through the composite
        (K1 and K2 on the card, the plain path on the CPU)."""
        out = []
        for f in fx:
            density = f["density_prop"].to(device).requires_grad_()
            w = composite.composite_weights(density, f["t_prop"].to(device),
                                            f["dirs"].to(device))
            loss = distillation_loss(f["t_nerf"].to(device),
                                     f["w_nerf"].to(device),
                                     f["t_prop"].to(device), w)
            out.append((loss.detach(),
                        torch.autograd.grad(loss, density)[0]))
        return out

    card_out, got, _ = _drive("spike: distillation on the fixture's rays",
                              composite, (len(fx), len(fx)),
                              lambda: distill("cuda"))
    for step, (loss, grad), (ref_loss, ref_grad) in zip(
            steps, card_out, distill("cpu")):
        rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
        err = _row_err(grad, ref_grad)
        ok = (torch.isfinite(grad).all().item() and rel <= SPIKE_LOSS_RTOL
              and err <= SPIKE_ROW_RTOL)
        print(f"spike: step {step} loss_prop on the fixture's 64 rays "
              f"{loss.item():.6g} on the card, {ref_loss.item():.6g} on the "
              f"CPU (rel {rel:.2e}, <= {SPIKE_LOSS_RTOL}); d_density "
              f"{err:.3e} of the ray's largest (<= {SPIKE_ROW_RTOL}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            _fail(f"spike: the card's distillation at step {step} disagrees "
                  "with the CPU's")
    print(f"spike: phase 15 took {time.perf_counter() - t_start:.1f} s on "
          f"{card}", flush=True)
    return {"spike": got}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        # A rank of phase 12, started by torchrun from drive_parallel.
        here = Path(__file__).resolve().parent
        sys.path.insert(0, str(here))
        if sys.argv[2] == "12a":
            _worker_12a(Path(sys.argv[3]), sys.argv[4:])
        else:
            _worker_12b(Path(sys.argv[3]), sys.argv[4])
        return 0
    profile_dir = ranks = None
    if len(sys.argv) == 3 and sys.argv[1] == "--profile":
        profile_dir = Path(sys.argv[2])
    elif (len(sys.argv) == 3 and sys.argv[1] == "--ranks"
          and sys.argv[2].isdigit() and int(sys.argv[2]) % 2 == 0):
        ranks = int(sys.argv[2])
    elif sys.argv[1:]:
        print("usage: python3 chip_smoke.py [--profile DIR | --ranks N]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    if not (here / "mipnerf360_torch" / "__init__.py").is_file():
        print(f"chip_smoke: mipnerf360_torch is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(here))
    import mipnerf360_torch
    from mipnerf360_torch.config import get_config
    from mipnerf360_torch.core.rays import take_rays
    from mipnerf360_torch.data.synthetic import synthetic_dataset
    from mipnerf360_torch.models.mipnerf360 import (init_model, map_params,
                                                    render_image)
    from mipnerf360_torch.ops import _build, composite
    from mipnerf360_torch.utils import metrics

    if Path(mipnerf360_torch.__file__).resolve().parents[1] != here:
        _fail(f"imported mipnerf360_torch from {mipnerf360_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    if ranks is not None:
        return _multicard(ranks, card, here)

    # Phase 2: build every kernel (one nvcc per source, all at once).
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in sorted(_build.BUILD_LOGS.items()):
        for line in _ptxas_summary(log):
            print(f"  nvcc[{name}]: {line}", flush=True)
    for name, lib in sorted(libs.items()):
        for line in _sass_summary(lib, _build.find_nvcc()):
            print(f"  sass[{name}]: {line}", flush=True)

    # Phase 3: each kernel against its plain version, then timed beside the
    # floor of the timing harness: a graph of one-element zero_() calls.
    tiny = torch.zeros(1, device="cuda")
    floor_ms = _device_ms(tiny.zero_)
    print(f"timing harness floor (one-element zero_(), CUDA graph of 50): "
          f"{floor_ms * 1e3:.3f} us per call", flush=True)
    scratch = torch.empty(FLUSH_BYTES // 4, device="cuda")
    k1 = check_k1(composite, floor_ms, scratch.zero_)
    k2 = check_k2(composite, floor_ms, scratch.zero_)
    del scratch

    # Phase 4: full-width render of the held-out views.
    cfg = get_config("synthetic_quality")
    mcfg = cfg.model
    print(f"model: synthetic_quality, {mcfg.num_samples} samples/ray, "
          f"proposal {mcfg.hidden_proposal}x{mcfg.proposal_depth}, "
          f"nerf {mcfg.hidden_nerf}x{mcfg.nerf_depth}, input {mcfg.input_dim}, "
          f"{mcfg.compute_dtype} matmuls", flush=True)
    params_cpu = init_model(mcfg, torch.Generator().manual_seed(0))
    params = map_params(lambda p: p.cuda(), params_cpu)
    test = synthetic_dataset(cfg.data, "test",
                             background=1.0 if mcfg.white_bkgd else 0.0)
    n_rays = test.n_rays
    n_chunks = -(-n_rays // RENDER_CHUNK)

    composite.launches = composite.bwd_launches = 0
    rgb, distance, acc = render_image(params, mcfg, test.rays,
                                      chunk=RENDER_CHUNK, device="cuda")
    torch.cuda.synchronize()
    k1_render, k2_render = composite.launches, composite.bwd_launches
    print(f"render: {test.n_images} views {test.h}x{test.w}, {n_rays} rays, "
          f"{n_chunks} chunks of {RENDER_CHUNK}; K1 launches {k1_render} "
          f"(expected {2 * n_chunks}), K2 launches {k2_render} (expected 0)",
          flush=True)
    if (k1_render, k2_render) != (2 * n_chunks, 0):
        _fail(f"render launched K1 {k1_render} and K2 {k2_render} times, "
              f"expected {2 * n_chunks} and 0")
    shapes = (tuple(rgb.shape), tuple(distance.shape), tuple(acc.shape))
    if shapes != ((n_rays, 3), (n_rays,), (n_rays,)):
        _fail(f"render output shapes {shapes}")
    for name, x in (("rgb", rgb), ("distance", distance), ("acc", acc)):
        if not torch.isfinite(x).all():
            _fail(f"render output {name} is not finite")
    # The trainer starts from these params (its init draws from the same
    # seed), so this is the PSNR phase 8's eval has to beat.
    views = (-1, test.h, test.w, 3)
    init_psnr = float(np.mean([
        metrics.psnr(a, b) for a, b in zip(rgb.cpu().numpy().reshape(views),
                                           test.pixels.reshape(views))]))
    # Phase 12b's renders are held to this one.
    render_ref = torch.cat([rgb, distance[:, None], acc[:, None]],
                           -1).cpu().numpy()
    print(f"render at random init: mean PSNR {init_psnr:.3f} dB over "
          f"{test.n_images} views", flush=True)

    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        render_image(params, mcfg, test.rays, chunk=RENDER_CHUNK, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    dt, med = times[0], statistics.median(times[1:])
    print(f"render warm (second call): {dt * 1e3:.1f} ms, "
          f"{n_rays / dt:.0f} rays/s; median of the next 5 calls "
          f"{med * 1e3:.1f} ms, {n_rays / med:.0f} rays/s; on {card}", flush=True)
    if profile_dir is not None:
        profile_call(lambda: render_image(params, mcfg, test.rays,
                                          chunk=RENDER_CHUNK, device="cuda"),
                     profile_dir, "render")

    # Phase 5: the card against the CPU on the whole path, first rays of the
    # test split, same params.
    check_render_card_vs_cpu(mcfg, params_cpu, params,
                             take_rays(test.rays, slice(0, PARITY_RAYS)),
                             "synthetic_quality")

    # Phase 6 and 7: the train path at full width, then card against CPU.
    k1_train, k2_train, step_rays_per_s, trace = drive_train(
        cfg, composite, card, profile_dir)
    check_train_card_vs_cpu(cfg)
    for k, key in ((k1, "composite_fwd"), (k2, "composite_bwd")):
        k["trace_ms"] = None
        if trace is not None:
            k["trace_ms"], count = _trace_ms(trace, key)
            if not count:
                _fail(f"the profiled train step shows no {key} launch")
            print(f"{key} in the profiled train step: {count} launches, "
                  f"{k['trace_ms'] * 1e3:.3f} us per launch (trace); hot "
                  f"{k['ms'] * 1e3:.3f} us, cold {k['cold_ms'] * 1e3:.3f} us "
                  "in the graph", flush=True)

    # Phases 8-11 keep their checkpoints and captures in one temporary
    # directory under build/, deleted at the end.
    (here / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=here / "build"))
    try:
        # Phase 8: the trainer and the entry points, train -> resume -> eval.
        trainer = drive_trainer(cfg, composite, card, here, work,
                                step_rays_per_s, init_psnr)
        # Phase 9: garden_quality on a capture of garden's size.
        paths, lpips_view, weights = drive_garden(composite, card, work,
                                                  step_rays_per_s)
        # Phase 10: blender_lego_quality on a Blender-layout capture.
        paths.update(drive_lego(composite, card, work))
        # Phase 11: the synthetic video, LPIPS and checkify_fn on the card.
        paths.update(drive_small(composite, card, work, lpips_view, weights))
        # Phase 12: the parallel layer, under torchrun.
        paths.update(drive_parallel(cfg, card, here, work, render_ref,
                                    step_rays_per_s))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # Phase 13: the measuring layer through its entry points.
    paths.update(drive_tools(composite, card, here, step_rays_per_s))
    # Phase 14: the quality layer through its entry point.
    paths.update(drive_quality(composite, card, here))
    # Phase 15: the spike regime of the distillation loss.
    paths.update(drive_spike(composite, card, here))
    paths = {"render": (k1_render, k2_render), "train": (k1_train, k2_train),
             "trainer": trainer, **paths}

    def entry(name, replaces, k, by_path):
        return {"name": name, "route": "cuda",
                "source": "mipnerf360_torch/csrc/composite.cu",
                "replaces": replaces, "result": "ok",
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "cold_ms": k["cold_ms"],
                "cold_quartiles_ms": k["cold_quartiles_ms"],
                "floor_ms": k["floor_ms"],
                "unaligned_ms": k["unaligned_ms"], "trace_ms": k["trace_ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": None}

    record = {"kernels": [
        entry("K1_composite_fwd", "mipnerf360_tpu/ops/pallas/composite.py:46",
              k1, {name: k[0] for name, k in paths.items()}),
        entry("K2_composite_bwd", "mipnerf360_tpu/ops/pallas/composite.py:59",
              k2, {name: k[1] for name, k in paths.items()}),
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
