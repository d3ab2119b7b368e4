"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Builds every CUDA kernel of ``mipnerf360_torch`` from ``mipnerf360_torch/csrc``
with ``nvcc``, holds each kernel against its plain PyTorch version on the
card, renders the synthetic scene's held-out views at the full width of the
``synthetic_quality`` preset through ``render_image``, and checks the card
against the CPU on the whole render path. Any failure exits non-zero. It
needs one CUDA device, and refuses to run without one or without the
package beside it.

Output, one line per phase; the line before the last is the per-kernel JSON
record and the last line is ``{"ok": true, "device": {...}}``. With
``--profile DIR`` it also profiles one warm render and writes the trace and
the kernel table to DIR.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Render-path settings: the synthetic_quality preset's held-out views.
RENDER_CHUNK = 4096
PARITY_RAYS = 128

# K1 against its plain version: the JAX package's Pallas-vs-core tolerance
# (tests/test_pallas_ops.py). The two differ only in the order of the
# transmittance prefix sum (warp scan vs torch.cumsum) and in the last ulp
# of exp/expm1/sqrt.
K1_RTOL, K1_ATOL = 1e-5, 1e-6


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _device_ms(fn, calls: int = 50, reps: int = 21) -> float:
    """Median device time of one ``fn()`` call, in ms: ``calls`` calls are
    captured into one CUDA graph, so host overhead is left out, and the graph
    is replayed ``reps`` times between CUDA events."""
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
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _k1_inputs(b: int, n: int, density_range, seed: int):
    rng = np.random.default_rng(seed)
    density = rng.uniform(*density_range, (b, n)).astype(np.float32)
    t_vals = np.sort(rng.uniform(0.1, 6.0, (b, n + 1)).astype(np.float32), -1)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    return [torch.from_numpy(x).cuda() for x in (density, t_vals, dirs)]


def _k1_bound_ms(b: int, n: int):
    """Least time for K1 at [b, n]: every input read once, w written once;
    ~8 f32 operations per sample (difference, two products, scan add,
    exp, expm1, carry add, product) beside the bytes."""
    nbytes = 4 * (b * n + b * (n + 1) + 3 * b) + 4 * b * n
    flops = 8 * b * n + 5 * b
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k1(composite):
    """Phase 3: K1 against its plain version on the card, then timed."""
    cases = [
        ("render chunk", 4096, 64, (0.0, 3.0)),
        ("ragged B, small N", 300, 16, (0.0, 3.0)),
        ("one ray, N=65", 1, 65, (0.0, 3.0)),
        ("near-zero density (dd < 1e-2)", 1024, 64, (0.0, 1e-4)),
        ("large density", 1024, 64, (50.0, 500.0)),
    ]
    max_err = 0.0
    for seed, (label, b, n, rng) in enumerate(cases):
        density, t_vals, dirs = _k1_inputs(b, n, rng, seed)
        w = composite.composite_weights(density, t_vals, dirs)
        ref = composite.plain_composite_weights(density, t_vals, dirs)
        torch.cuda.synchronize()
        err = (w - ref).abs().max().item()
        max_err = max(max_err, err)
        ok = torch.allclose(w, ref, rtol=K1_RTOL, atol=K1_ATOL)
        print(f"K1 vs plain [{label}] B={b} N={n}: max_abs_err={err:.3e} "
              f"rtol={K1_RTOL} atol={K1_ATOL} {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok or not torch.isfinite(w).all():
            _fail(f"K1 disagrees with its plain version ({label})")

    b, n = RENDER_CHUNK, 64
    density, t_vals, dirs = _k1_inputs(b, n, (0.0, 3.0), 99)
    ms = _device_ms(lambda: composite.composite_weights(density, t_vals, dirs))
    plain_ms = _device_ms(
        lambda: composite.plain_composite_weights(density, t_vals, dirs))
    bound_ms, bound_by = _k1_bound_ms(b, n)
    print(f"K1 time B={b} N={n} (inputs hot in L2, as in the render path): "
          f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
          f"bound {bound_ms * 1e3:.3f} us by {bound_by}; no single PyTorch "
          f"call computes K1 (library_ms null)", flush=True)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _kernel_class(name: str) -> str:
    if "composite_fwd" in name:
        return "K1 composite"
    if any(s in name.lower() for s in ("gemm", "nvjet", "cutlass", "sm90_xmma")):
        return "matmul (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def profile_render(render, out_dir: Path) -> None:
    """``--profile DIR``: one warm render under ``torch.profiler``; prints the
    device's busy share and its time by kernel class and by kernel, and
    writes the Chrome trace and the kernel table to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
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
    print(f"profile: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / wall_us:.1f}%), idle {100 * (1 - busy / wall_us):.1f}%",
          flush=True)
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"profile: {cls}: {us / 1e3:.2f} ms ({100 * us / busy:.1f}% of busy)",
              flush=True)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "render_kernels.txt", "w") as f:
        for name, (count, us) in rows:
            f.write(f"{us:12.1f} us {count:6d}x  {name}\n")
    for name, (count, us) in rows[:12]:
        print(f"profile: {us / 1e3:8.2f} ms {count:5d}x {name[:110]}", flush=True)
    prof.export_chrome_trace(str(out_dir / "render_trace.json"))


def main() -> int:
    profile_dir = None
    if len(sys.argv) == 3 and sys.argv[1] == "--profile":
        profile_dir = Path(sys.argv[2])
    elif sys.argv[1:]:
        print("usage: python3 chip_smoke.py [--profile DIR]", file=sys.stderr)
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
    import dataclasses

    import mipnerf360_torch
    from mipnerf360_torch.config import get_config
    from mipnerf360_torch.core.rays import rays_to_device, take_rays
    from mipnerf360_torch.data.synthetic import synthetic_dataset
    from mipnerf360_torch.models.mipnerf360 import (init_model, map_params,
                                                    render_image, render_rays)
    from mipnerf360_torch.ops import _build, composite

    if Path(mipnerf360_torch.__file__).resolve().parents[1] != here:
        _fail(f"imported mipnerf360_torch from {mipnerf360_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # Phase 2: build every kernel (one nvcc per source, all at once).
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in sorted(_build.BUILD_LOGS.items()):
        for line in log.strip().splitlines():
            print(f"  nvcc[{name}]: {line}", flush=True)

    # Phase 3: each kernel against its plain version.
    k1 = check_k1(composite)

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

    composite.launches = 0
    rgb, distance, acc = render_image(params, mcfg, test.rays,
                                      chunk=RENDER_CHUNK, device="cuda")
    torch.cuda.synchronize()
    k1_launches = composite.launches
    print(f"render: {test.n_images} views {test.h}x{test.w}, {n_rays} rays, "
          f"{n_chunks} chunks of {RENDER_CHUNK}; K1 launches {k1_launches} "
          f"(expected {2 * n_chunks})", flush=True)
    if k1_launches != 2 * n_chunks:
        _fail(f"K1 launched {k1_launches} times, expected {2 * n_chunks}")
    shapes = (tuple(rgb.shape), tuple(distance.shape), tuple(acc.shape))
    if shapes != ((n_rays, 3), (n_rays,), (n_rays,)):
        _fail(f"render output shapes {shapes}")
    for name, x in (("rgb", rgb), ("distance", distance), ("acc", acc)):
        if not torch.isfinite(x).all():
            _fail(f"render output {name} is not finite")

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
        profile_render(lambda: render_image(params, mcfg, test.rays,
                                            chunk=RENDER_CHUNK, device="cuda"),
                       profile_dir)

    # Phase 5: the card against the CPU on the whole path, first rays of the
    # test split, same params.
    sub = take_rays(test.rays, slice(0, PARITY_RAYS))
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
            r = rays_to_device(sub, dev)
            with torch.inference_mode():
                out = render_rays(p, pcfg, r, randomized=False)
            outs[dev] = {k: out[k].float().cpu() for k in
                         ("rgb", "distance", "acc", "weights", "t_vals")}
        for k in outs["cpu"]:
            a, b = outs["cuda"][k], outs["cpu"][k]
            err = (a - b).abs().max().item()
            ok = torch.allclose(a, b, **tol)
            print(f"card vs cpu [{dtype}] {k}: max_abs_err={err:.3e} "
                  f"rtol={tol['rtol']} atol={tol['atol']} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                _fail(f"card and CPU disagree on {k} in {dtype}")

    record = {"kernels": [{
        "name": "K1_composite_fwd",
        "route": "cuda",
        "source": "mipnerf360_torch/csrc/composite.cu",
        "replaces": "mipnerf360_tpu/ops/pallas/composite.py:46",
        "result": "ok",
        "launches": k1_launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
