"""Training driver: data -> device -> K-step loops -> metrics/checkpoints
(counterpart of ``mipnerf360_tpu/train/trainer.py``).

The batch stream is the JAX package's stateless index stream, so the port
trains on the same batches; a bank of every train ray is held on the device
and each chunk ships only its [K, B] index stack (or, in host mode, the
gathered rays). Steps run in chunks of ``log_every`` with one host sync per
chunk, where the per-step metrics come back in one transfer; evals,
``keep_best`` and async checkpoints land on chunk boundaries; exact resume
restores counters, params, moments and the noise generator.

In a process group (``apps.train --multihost`` under torchrun) the trainer
runs on the ``cfg.mesh`` mesh (``parallel/mesh.py``): each rank stages only
its rows of each batch, the params start from rank 0's (broadcast after
init and after a restore), the evals are collective, and only rank 0 writes
metrics, ``config.json`` and checkpoints. Every collective sits outside
any branch that one rank takes alone.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from ..core.rays import rays_to_device, resolve_device
from ..data import get_dataset
from ..losses.photometric import photometric_loss
from ..models.mipnerf360 import render_image, render_rays
from ..parallel.mesh import (any_rank, broadcast_state_, gather_params,
                             gather_state, is_primary, make_mesh, rank0_value,
                             rank_device, shard_batch, shard_state)
from ..utils import metrics
from ..utils.logging import MetricsLogger, Timer
from ..utils.trace import span
from .checkpoint import (AsyncCheckpointer, latest_checkpoint_step,
                         restore_checkpoint, save_checkpoint)
from .state import TrainState, init_train_state
from .step import make_banked_train_loop, make_train_loop

# Auto threshold for device-bank staging: keep the device's copy of the ray
# bank under this many bytes. Larger datasets fall back to host staging.
_BANK_AUTO_BYTES = 2 * 1024**3


def _bank_nbytes(dataset) -> int:
    width = sum(int(a.shape[-1]) for a in dataset.rays)
    if dataset.pixels is not None:
        width += int(dataset.pixels.shape[-1])
    return dataset.n_rays * width * 4


def use_device_bank(cfg: Config, dataset) -> bool:
    """Resolve train.stage_mode ("auto" picks device_bank while the bank
    fits _BANK_AUTO_BYTES)."""
    mode = cfg.train.stage_mode
    if mode == "host":
        return False
    if mode == "device_bank":
        return True
    if mode != "auto":
        raise ValueError(f"unknown train.stage_mode {mode!r}")
    return _bank_nbytes(dataset) <= _BANK_AUTO_BYTES


def evaluate_batch(cfg: Config, params, rays, pixels, device="cuda",
                   mesh=None) -> float:
    """Deterministic single-batch PSNR (the reference's in-training eval of
    one batch). ``rays`` and ``pixels`` are host arrays or tensors. On
    ``mesh`` each data rank renders its rows and the PSNR is the whole
    batch's (collective)."""
    group = tp_group = None
    if mesh is None:
        rays = rays_to_device(rays, resolve_device(device))
        pixels = torch.as_tensor(pixels, device=rays.origins.device)
    else:
        rays, pixels = shard_batch(mesh, rays, pixels)
        group, tp_group = mesh.data_group, mesh.model_group
    with torch.inference_mode():
        out = render_rays(params, cfg.model, rays, randomized=False,
                          tp_group=tp_group)
        _, psnr = photometric_loss(out["rgb"], pixels, group)
    return float(psnr)


def evaluate_image(cfg: Config, params, dataset, index: int,
                   device="cuda", mesh=None) -> dict:
    """Render one full held-out view and score it (PSNR, and SSIM when the
    view is large enough for the 11x11 SSIM window), through the chunked
    ``render_image`` of apps/eval (on ``mesh``: collective, and every rank
    scores the whole view)."""
    rays_np, pix = dataset.image(index)
    if mesh is not None and mesh.model > 1 and cfg.model.sample_shards > 1:
        # the sample-axis render takes whole params, not the trunk's shards
        params = gather_params(mesh, params)
    rgb, _, _ = render_image(params, cfg.model, rays_np,
                             chunk=cfg.train.eval_image_chunk, mesh=mesh,
                             device=device)
    rgb = rgb.cpu().numpy().reshape(dataset.h, dataset.w, 3)
    out = {}
    if pix is not None:
        target = pix.reshape(dataset.h, dataset.w, 3)
        out["eval/psnr_image"] = float(metrics.psnr(rgb, target))
        if min(dataset.h, dataset.w) >= 11:
            out["eval/ssim"] = float(metrics.ssim(rgb, target))
    return out


def evaluate_images(cfg: Config, params, dataset, *, device="cuda",
                    mesh=None) -> dict:
    """Score held-out views and return MEAN eval/psnr_image + eval/ssim.

    ``train.eval_image_views`` selects coverage: -1 renders ALL test views;
    k >= 1 renders a FIXED window of the first k views, so the mean is
    comparable across eval boundaries. Per-view PSNRs are returned under
    eval/psnr_view_<i>."""
    k = cfg.train.eval_image_views
    n = dataset.n_images
    indices = list(range(n if k <= 0 or k >= n else k))
    psnrs, ssims, out = {}, {}, {}
    for i in indices:
        one = evaluate_image(cfg, params, dataset, i, device=device,
                             mesh=mesh)
        if "eval/psnr_image" in one:
            psnrs[i] = one["eval/psnr_image"]
        if "eval/ssim" in one:
            ssims[i] = one["eval/ssim"]
    if psnrs:
        out["eval/psnr_image"] = float(np.mean(list(psnrs.values())))
        out.update({f"eval/psnr_view_{i}": v for i, v in psnrs.items()})
    if ssims:
        out["eval/ssim"] = float(np.mean(list(ssims.values())))
    return out


def stage_batch(device, dataset, k: int, batch_size: int, seed: int,
                at_step: int, mesh=None):
    """Assemble a [K, B, c] stack of k per-step batches (one native-batcher
    gather) and copy it to ``device``; on ``mesh``, only this rank's
    [K, B/P, c] rows of it (``RayDataset.batch_stack_local``)."""
    if mesh is None:
        rays_np, pix_np = dataset.batch_stack(k, batch_size, seed, at_step)
    else:
        rays_np, pix_np = dataset.batch_stack_local(
            k, batch_size, seed, at_step, mesh.data_index, mesh.data)
    return (rays_to_device(rays_np, device),
            torch.as_tensor(pix_np, device=device))


def upload_bank(dataset, device):
    """The device bank: every flattened train ray and pixel row of
    ``dataset`` on ``device`` (whole on every rank of a mesh)."""
    return (rays_to_device(dataset.rays, device),
            torch.as_tensor(dataset.pixels, device=device))


def stage_chunk(dataset, bank, device, k: int, batch_size: int, seed: int,
                at_step: int, mesh=None):
    """The loop args of the ``k``-step chunk starting at ``at_step``: with
    a ``bank`` (:func:`upload_bank`), the bank and the [K, B] int32 index
    stack (this rank's [K, B/P] on ``mesh``) for
    ``make_banked_train_loop``; without, the gathered [K, B, c] batch stack
    (:func:`stage_batch`) for ``make_train_loop``."""
    if bank is None:
        return stage_batch(device, dataset, k, batch_size, seed, at_step,
                           mesh)
    idx = (dataset.index_stack(k, batch_size, seed, at_step) if mesh is None
           else dataset.index_stack_local(k, batch_size, seed, at_step,
                                          mesh.data_index, mesh.data))
    return (*bank, torch.as_tensor(idx).to(device))


def stage_depth(bank) -> int:
    """Chunks the :class:`BackgroundStager` holds ahead of the loop. Host
    mode stages whole [K, B, c] stacks, so 1 (current + one ahead); bank
    mode ships only [K, B] indices, where a deeper queue is free."""
    return 2 if bank is not None else 1


def chunk_len(at_step: int, max_steps: int, chunk: int) -> int:
    """Steps in the chunk starting at ``at_step``: chunk boundaries align to
    multiples of ``chunk`` regardless of resume point. The single source of
    truth for chunk length: ``chunk_starts`` (the stager's schedule) and the
    trainer's ``stage`` must agree or the stateless ray-counter stream would
    silently gap or overlap."""
    return min(chunk - at_step % chunk, max_steps - at_step)


def chunk_starts(start_step: int, max_steps: int, chunk: int):
    """The deterministic sequence of chunk-start steps the train loop visits."""
    s = start_step
    while s < max_steps:
        yield s
        s += chunk_len(s, max_steps, chunk)


class BackgroundStager:
    """Double-buffered background staging: a worker thread assembles and
    uploads batch stacks AHEAD of the train loop, so the host gather and the
    copy to the device overlap device compute.

    Safe because the batch index stream is stateless in (seed, global ray
    counter): assembly order and thread do not change WHAT is staged. The
    worker copies with a synchronous ``.to(device)``, on the same stream the
    consumer runs on, so a step never reads a half-copied stack. The queue
    holds at most ``depth`` staged chunks. Worker exceptions re-raise in the
    consumer at the next get().
    """

    def __init__(self, stage_fn, steps, depth: int = 2):
        import queue

        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(stage_fn, list(steps)), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        import queue

        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _await_slot(self) -> bool:
        # Reserve a queue slot BEFORE assembling the next chunk: this is the
        # single producer, so a non-full queue guarantees the following put
        # succeeds, and the staged footprint stays at depth + 1 (queued + one
        # being assembled).
        while not self._stop.is_set():
            if not self._q.full():
                return True
            time.sleep(0.005)
        return False

    def _run(self, stage_fn, steps):
        try:
            for s in steps:
                if not self._await_slot():
                    return
                if not self._put((stage_fn(s), None)):
                    return
            self._put((None, None))  # end of stream
        except BaseException as e:  # re-raised in get()
            self._put((None, e))

    def get(self):
        """Next staged item, or None at end of stream; re-raises worker errors."""
        with span("trainer.wait"):
            item, exc = self._q.get()
        if exc is not None:
            raise exc
        return item

    def warm(self, timeout: float = 300.0) -> None:
        """Block until the queue is full, the worker has finished, or
        ``timeout`` seconds have passed. A timing window opened after it
        sees only the steady state, one assembly per consumed item, and not
        the cold-start assemblies. A worker error is not raised here: the
        next get() raises it."""
        deadline = time.monotonic() + timeout
        while (self._q.qsize() < self._q.maxsize and self._thread.is_alive()
               and time.monotonic() < deadline):
            time.sleep(0.005)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=30)


def install_preemption_handler(signals=(signal.SIGTERM, signal.SIGINT)):
    """SIGTERM/SIGINT (a preemption notice) set a flag; the train loop
    flushes a checkpoint at the next chunk boundary and exits cleanly.

    The FIRST signal sets the flag and immediately restores the previous
    handlers, so a second signal force-interrupts. Returns (flag, restore).
    Signal handlers only work in the main thread; elsewhere the flag is
    never set."""
    flag = threading.Event()
    if threading.current_thread() is not threading.main_thread():
        return flag, lambda: None
    prev = {}

    def restore():
        for s, h in prev.items():
            signal.signal(s, h)

    def handler(signum, frame):
        flag.set()
        restore()  # second signal gets the default/previous behavior

    prev.update({s: signal.signal(s, handler) for s in signals})
    return flag, restore


def _last_to_host(aux: dict) -> dict:
    """The last step's value of each [K] aux tensor as a Python float, in
    ONE device-to-host transfer (values already on the host stay there)."""
    last = {name: v[-1] for name, v in aux.items()}
    on_device = [n for n, v in last.items() if v.device.type != "cpu"]
    out = {n: float(v) for n, v in last.items() if n not in on_device}
    if on_device:
        vals = torch.stack([last[n].float() for n in on_device]).cpu()
        out.update(zip(on_device, vals.tolist()))
    return out


def _best_psnr_from_manifest(ckpt_dir: str) -> float:
    path = os.path.join(ckpt_dir, "manifest.json")
    if os.path.exists(path):
        try:
            with open(path) as f:
                return float(json.load(f).get("best_psnr_image", float("-inf")))
        except (OSError, ValueError):
            pass
    return float("-inf")


def train(cfg: Config, *, max_steps: Optional[int] = None,
          resume: bool = False,
          on_step: Optional[Callable[[int, dict], None]] = None,
          device="cuda") -> TrainState:
    """Run training on ``device`` (the card unless the caller passes
    ``device="cpu"``); returns the final TrainState (on a mesh with a
    model axis, this rank's shard of it).

    In a process group, on the ``cfg.mesh`` mesh over it (``data = -1`` is
    ``world_size // model``); without one, on one device, where a mesh of
    more than one rank raises."""
    mesh = None
    if torch.distributed.is_initialized():
        device = rank_device(device)
        mesh = make_mesh(cfg.mesh.data, cfg.mesh.model, device=device)
    else:
        device = resolve_device(device)
        if cfg.mesh.model != 1 or cfg.mesh.data not in (-1, 1):
            raise ValueError(
                f"mesh data={cfg.mesh.data} model={cfg.mesh.model} needs a "
                "process group of that many ranks: launch apps.train "
                "--multihost under torchrun")
    primary = is_primary()
    max_steps = max_steps if max_steps is not None else cfg.train.max_steps

    # Anchor the LR-decay horizon NOW so it survives resume-extension: the
    # resolved value lands in config.json (authoritative on resume), so
    # raising train.max_steps later extends training on the original
    # schedule instead of re-inflating the LR.
    if cfg.train.lr_max_steps == 0:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, lr_max_steps=max_steps))

    dataset = get_dataset(cfg.data, "train", white_bkgd=cfg.model.white_bkgd)
    try:
        eval_dataset = get_dataset(cfg.data, "test",
                                   white_bkgd=cfg.model.white_bkgd)
    except FileNotFoundError as e:
        # Only the expected missing-split case falls back, and loudly:
        # eval/* would otherwise silently score the TRAIN split.
        warnings.warn(
            f"no test split found ({e}); eval/* metrics will be computed on "
            "the TRAIN split", RuntimeWarning, stacklevel=2)
        eval_dataset = dataset

    ckpt_dir = cfg.train.checkpoint_dir
    state = init_train_state(cfg.model, cfg.train, device=device)
    if resume and latest_checkpoint_step(ckpt_dir) is not None:
        state = restore_checkpoint(ckpt_dir, state)
    if mesh is not None:
        # rank 0's state and step, whatever checkpoint each rank found
        broadcast_state_(state)
        state = shard_state(mesh, state)
    start_step = state.step

    def full_state():
        """The whole state for a checkpoint (collective on a model axis)."""
        return state if mesh is None else gather_state(mesh, state)

    bank = None
    if use_device_bank(cfg, dataset):
        bank = upload_bank(dataset, device)
        loop_fn = make_banked_train_loop(cfg, mesh=mesh)
    else:
        loop_fn = make_train_loop(cfg, mesh=mesh)
    logger = MetricsLogger(ckpt_dir)
    if primary:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
    # Which staging stage_mode resolved to, and for how many bytes of rays.
    logger.log(start_step, {"data/device_bank": float(bank is not None),
                            "data/train_bytes": float(_bank_nbytes(dataset))})

    eval_batches = eval_dataset.batches(cfg.train.batch_size,
                                        seed=cfg.train.seed + 1)
    timer = Timer()

    # Steps run in chunks of ``log_every`` with one host sync per chunk.
    # eval/save cadences land on the first chunk boundary at or past their
    # multiple (exact when they are multiples of log_every).
    chunk = max(1, cfg.train.log_every)

    def crossed(every: int, start: int, end: int) -> bool:
        return bool(every) and (end // every) > (start // every)

    def stage(at_step: int):
        """(k, loop_fn args) of the chunk starting at ``at_step``."""
        k = chunk_len(at_step, max_steps, chunk)
        return k, stage_chunk(dataset, bank, device, k, cfg.train.batch_size,
                              cfg.train.seed, at_step, mesh)

    step = start_step
    # Best-eval tracking persists across --resume via the manifest, so a
    # resumed run's first eval cannot overwrite a better ckpt_best.
    # On a mesh, rank 0's manifest decides for all ranks (the keep_best
    # branch holds a collective).
    best_eval_psnr = rank0_value(_best_psnr_from_manifest(ckpt_dir) if resume
                                 else float("-inf"), mesh)
    preempted, restore_signals = install_preemption_handler()
    ckpt_writer = AsyncCheckpointer()
    nonfinite_warned = False
    stager = None
    staged = None
    if cfg.train.async_staging:
        stager = BackgroundStager(stage, chunk_starts(step, max_steps, chunk),
                                  depth=stage_depth(bank))
    else:
        staged = stage(step) if step < max_steps else None
    try:
        # On a mesh every rank stops at the same boundary: a preemption
        # notice seen by any rank stops them all.
        while step < max_steps and not any_rank(preempted.is_set(), mesh):
            if stager is not None:
                staged = stager.get()
            if staged is None:
                break
            k, loop_args = staged

            profiler = None
            if (cfg.train.profile_dir
                    and step <= cfg.train.profile_start < step + k):
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                profiler = profile(activities=activities)
                profiler.start()
            state, aux = loop_fn(state, *loop_args)
            if profiler is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                profiler.stop()
                os.makedirs(cfg.train.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(
                    cfg.train.profile_dir, f"trace_steps_{step}_{step + k}.json"))

            # Inline staging: prepare the next chunk while the device runs
            # this one; the sync below waits for it.
            if stager is None:
                staged = stage(step + k) if step + k < max_steps else None

            # ONE transfer for all log scalars: a read per metric would be a
            # host round trip each.
            aux_host = _last_to_host(aux)
            if not nonfinite_warned and not all(
                    np.isfinite(v) for v in aux_host.values()):
                # Once per run: a NaN loss usually means training is dead.
                nonfinite_warned = True
                bad = {n: v for n, v in aux_host.items() if not np.isfinite(v)}
                if primary:
                    print(f"[warn] non-finite training metrics at step "
                          f"{step + k}: {bad} — training is likely dead; set "
                          "train.check_nans=true to abort with offending "
                          "params")
            if cfg.train.check_nans:
                from ..utils.checks import assert_tree_finite

                aux_t = {n: torch.tensor(v) for n, v in aux_host.items()}
                assert_tree_finite({"params": state.params, "aux": aux_t},
                                   context=f"at step {step + k}")
            dt = timer.lap()
            new_step = step + k
            scalars = {
                "train/loss": aux_host.get("loss", 0.0),
                "train/avg_psnr": aux_host.get("psnr", 0.0),
                "train/lr": aux_host.get("lr", 0.0),
                "train/loss_nerf": aux_host.get("loss_nerf", 0.0),
                "train/loss_dist": aux_host.get("loss_dist", 0.0),
                "train/loss_prop": aux_host.get("loss_prop", 0.0),
                "perf/steps_per_sec": k / dt,
                "perf/rays_per_sec": k * cfg.train.batch_size / dt,
            }
            logger.log(new_step, scalars)
            if on_step is not None:
                on_step(new_step, scalars)

            if crossed(cfg.train.eval_every, step, new_step):
                er, ep = next(eval_batches)
                psnr = evaluate_batch(cfg, state.params, er, ep, device, mesh)
                # Noise-dominated (one batch), kept for cadence parity with
                # the reference's eval; eval/psnr_image is the quality
                # signal. On the channel-summed MSE scale, 10*log10(3) dB
                # below image PSNR.
                logger.log(new_step, {"eval/psnr_batch_noisy": psnr})

            if (crossed(cfg.train.eval_image_every, step, new_step)
                    and eval_dataset.n_images > 0):
                img_metrics = evaluate_images(cfg, state.params, eval_dataset,
                                              device=device, mesh=mesh)
                logger.log(new_step, img_metrics)
                mean_psnr = img_metrics.get("eval/psnr_image")
                # Every rank scored the whole views alike, so every rank
                # takes this branch (and the gather in full_state) together.
                if (cfg.train.keep_best and mean_psnr is not None
                        and mean_psnr > best_eval_psnr):
                    best_eval_psnr = mean_psnr
                    ckpt_writer.save(
                        ckpt_dir, full_state(), cfg.train.keep_checkpoints,
                        name="best",
                        manifest_extra={"best_psnr_image": mean_psnr})

            if crossed(cfg.train.save_every, step, new_step):
                # Snapshot on the device + background write.
                ckpt_writer.save(ckpt_dir, full_state(),
                                 cfg.train.keep_checkpoints)
            step = new_step

    finally:
        # Always restore the signal handlers and stop the staging and
        # checkpoint workers, even when the loop raises.
        if stager is not None:
            stager.close()
        restore_signals()
        try:
            ckpt_writer.close()  # drain the in-flight write before the sync save
        except Exception:
            logger.close()
            raise
    if step < max_steps and primary:
        print(f"[preempted] flushing checkpoint at step {step}")
    save_checkpoint(ckpt_dir, full_state(), cfg.train.keep_checkpoints)
    logger.close()
    if mesh is not None:
        mesh.barrier()  # rank 0's files are complete when any rank returns
    return state
