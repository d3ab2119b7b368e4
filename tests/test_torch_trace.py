"""The port's spans (``mipnerf360_torch/utils/trace.py``) and their
attribution (``nerfbench/spans.py``), on the CPU.

- ``span`` is one shared no-op while no profiler records, and a
  function-scope profiler range while one does.
- A joint train step with its staging and a ``render_image`` open exactly
  the spans of ``nerfbench.spans.SPANS``, and change no value.
- On the CPU profile of a step, backward operations reach their forward
  span through ``sequence_nr``, the recompute of a checkpointed MLP opens
  ``model.mlp`` inside the backward, and AdamW's operations sit under
  ``step.adamw``.
- Device attribution, host-sync counting and idle-gap names on fabricated
  event lists (the CPU profiler records no device operations).
- The per-layer numbers read from a fabricated summary, and every existing
  reader of ``nerfbench/metrics/`` reads the same with the spans' keys in
  the summary.
"""
import importlib.util
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Interval
from torch.profiler import ProfilerActivity, profile

from mipnerf360_torch.config import (Config, DataConfig, MeshConfig,
                                     ModelConfig, TrainConfig)
from mipnerf360_torch.core.rays import rays_map
from mipnerf360_torch.data import get_dataset
from mipnerf360_torch.models.mipnerf360 import render_image
from mipnerf360_torch.train import trainer as tr
from mipnerf360_torch.train.state import init_train_state, leaves
from mipnerf360_torch.train.step import joint_cadence_grads, make_train_step
from mipnerf360_torch.utils import trace
from nerfbench import spans as sp

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def tiny_config(remat=False) -> Config:
    return Config(
        model=ModelConfig(num_samples=8, hidden_proposal=16, hidden_nerf=16,
                          nerf_depth=2, compute_dtype="float32", remat=remat),
        train=TrainConfig(max_steps=4, batch_size=16, log_every=2,
                          save_every=0, eval_every=0, lr_delay_steps=0,
                          checkpoint_dir=""),
        data=DataConfig(dataset="synthetic", synthetic_resolution=8,
                        synthetic_views=2),
        mesh=MeshConfig(data=1, model=1))


@pytest.fixture(scope="module")
def data():
    cfg = tiny_config()
    return (get_dataset(cfg.data, "train", white_bkgd=cfg.model.white_bkgd),
            get_dataset(cfg.data, "test", white_bkgd=cfg.model.white_bkgd))


def _batch(ds, cfg):
    rays, pix = tr.stage_chunk(ds, None, CPU, 1, cfg.train.batch_size,
                               cfg.train.seed, 0)
    return rays_map(lambda x: x[0], rays), pix[0]


def _state(cfg):
    return init_train_state(cfg.model, cfg.train, device="cpu")


def _profiled_step(cfg, ds):
    state, step = _state(cfg), make_train_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, *_batch(ds, cfg))
    return list(prof.events())


class _Recorder:
    """Stands in for the profiler range: records the names opened."""

    names = []

    def __init__(self, name):
        self.names.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------- the span


def test_span_is_one_shared_noop_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(trace, "_range", lambda name: opened.append(name))
    assert not trace._recording()
    contexts = {id(trace.span(f"s{i}")) for i in range(100)}
    assert len(contexts) == 1 and opened == []
    with trace.span("model.encode"):
        pass


def test_span_falls_back_to_public_names_where_torch_lacks_the_private(
        monkeypatch):
    """A torch without ``_profiler_enabled`` or ``_RecordFunctionFast``:
    the span reads the public flag and opens ``record_function``."""
    import importlib

    monkeypatch.delattr(torch._C._autograd, "_profiler_enabled")
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    try:
        fallback = importlib.reload(trace)
        assert fallback.span("model.mlp") is fallback._OFF
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert isinstance(fallback.span("model.mlp"),
                              torch.profiler.record_function)
            with fallback.span("model.mlp"):
                torch.ones(2).sin()
        assert [e.name for e in prof.events()].count("model.mlp") == 1
    finally:
        monkeypatch.undo()
        importlib.reload(trace)
    assert trace._range is torch._C._profiler._RecordFunctionFast


def test_span_is_a_function_scope_range_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("model.encode"):
            torch.ones(4).sin()
    ev = [e for e in prof.events() if e.name == "model.encode"]
    assert len(ev) == 1 and not ev[0].is_user_annotation
    assert [c.name for c in ev[0].cpu_children] == ["aten::ones", "aten::sin"]


def test_train_step_and_render_open_every_span_and_no_other(data,
                                                            monkeypatch):
    train_ds, test_ds = data
    cfg = tiny_config()
    state, step = _state(cfg), make_train_step(cfg)
    stage = lambda at: tr.stage_chunk(train_ds, None, CPU, 1,
                                      cfg.train.batch_size, 0, at)
    stager = tr.BackgroundStager(stage, [0], depth=1)
    _Recorder.names = []
    monkeypatch.setattr(trace, "_range", _Recorder)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            rays, pix = stager.get()
            state, _ = step(state, rays_map(lambda x: x[0], rays), pix[0])
            render_image(state.params, cfg.model, test_ds.image(0)[0],
                         chunk=32, device="cpu")
    finally:
        stager.close()
    assert set(_Recorder.names) == set(sp.SPANS)


def test_spans_change_no_loss_gradient_or_parameter(data):
    cfg = tiny_config(remat=True)
    rays, pix = _batch(data[0], cfg)

    def run(traced):
        state = _state(cfg)
        state.generator.manual_seed(7)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                grads, aux = joint_cadence_grads(cfg, state, rays, pix)
                make_train_step(cfg)(state, rays, pix)
        else:
            grads, aux = joint_cadence_grads(cfg, state, rays, pix)
            make_train_step(cfg)(state, rays, pix)
        return grads["prop"] + grads["nerf"], aux, leaves(state.params)

    (g0, a0, p0), (g1, a1, p1) = run(False), run(True)
    assert all(torch.equal(x, y) for x, y in zip(g0 + p0, g1 + p1))
    assert all(torch.equal(a0[k], a1[k]) for k in a0)


def test_spans_change_no_rendered_output(data):
    cfg = tiny_config()
    params = _state(cfg).params
    rays = data[1].image(1)[0]
    plain = render_image(params, cfg.model, rays, chunk=24, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        traced = render_image(params, cfg.model, rays, chunk=24, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(plain, traced))


# ------------------------------------------- attribution on a CPU profile


def _backward_nodes(events):
    return [e for e in events if e.name.startswith(sp.BACKWARD)]


def test_backward_reaches_its_forward_span_through_sequence_nr():
    """An encode-shaped forward under ``model.encode`` and a loss under
    ``step.losses``: their backward nodes, which run outside both spans,
    take them through the forward operation with their sequence number."""
    w = torch.randn(3, 5, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("model.encode"):
            z = (torch.ones(4, 3) @ w).sin()
        with trace.span("step.losses"):
            loss = (z * z).mean()
        torch.autograd.grad(loss, [w])
    events = list(prof.events())
    spans = sp._Spans(events)
    found = {e.name.split(": ")[1]: spans.of(e)
             for e in _backward_nodes(events)}
    assert found["SinBackward0"] == "model.encode"
    assert found["MmBackward0"] == "model.encode"
    assert found["MeanBackward0"] == "step.losses"
    assert found["MulBackward0"] == "step.losses"


def test_train_step_backward_maps_to_mlp_composite_and_losses(data):
    """In the model the encode and the sampling carry no gradient (their
    inputs are rays and stop-gradient samples): every backward node of a
    step maps to the MLPs, the composite or the losses."""
    events = _profiled_step(tiny_config(), data[0])
    spans = sp._Spans(events)
    mapped = {spans.of(e) for e in _backward_nodes(events)
              if "AccumulateGrad" not in e.name}
    assert mapped == {"model.mlp", "model.composite", "step.losses"}


def test_remat_recompute_opens_mlp_inside_the_backward(data):
    events = _profiled_step(tiny_config(remat=True), data[0])
    spans = sp._Spans(events)
    again = [e for e in events
             if e.name == "model.mlp" and spans.in_backward(e)]
    assert again, "the checkpointed tower was not recomputed"
    ops = [c for e in again for c in e.cpu_children]
    assert ops and all(spans.of(op) == "model.mlp" for op in ops)


def test_adamw_operations_sit_under_step_adamw(data):
    events = _profiled_step(tiny_config(), data[0])
    spans = sp._Spans(events)
    adamw = [e for e in events if e.name == "step.adamw"]
    assert len(adamw) == 2  # the proposal and the NeRF subtrees
    ops = [c for e in adamw for c in e.cpu_children]
    assert {c.name for c in ops} >= {"aten::sqrt", "aten::mul_"}
    assert all(spans.of(op) == "step.adamw" for op in ops)


# ------------------------------------------ fabricated device event lists


class Ev:
    """A profiler event with the fields the attribution reads."""

    def __init__(self, name, a, b, id=0, device=False, thread=1, seq=-1,
                 fwd_thread=0, link=0):
        self.name, self.id, self.linked_correlation_id = name, id, link
        self.time_range = Interval(a, b)
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.thread, self.sequence_nr, self.fwd_thread = thread, seq, fwd_thread


def _launch(op, call, kernel, a, b, corr, at):
    """``op`` (None: an untraced thread) makes runtime call ``call`` at
    ``at`` that runs device operation ``kernel`` over [a, b) µs; returns
    both events."""
    link, thread = (op.id, op.thread) if op is not None else (0, 9)
    return [Ev(call, at, at + 1, id=corr, thread=thread, link=link),
            Ev(kernel, a, b, id=corr, device=True, link=link)]


def _fabricated():
    """A forward under model.encode (a kernel and a blocking constant
    upload), its backward on thread 2, a GEMM under model.mlp, a copy of an
    untraced thread while an encode op runs, the chunk's transfer and the
    harness's synchronize."""
    enc = Ev("model.encode", 0, 100, id=1)
    sin = Ev("aten::sin", 10, 20, id=2, seq=5)
    upload = Ev("aten::copy_", 30, 60, id=3)
    mlp = Ev("model.mlp", 100, 200, id=4)
    mm = Ev("aten::mm", 110, 120, id=5, seq=6)
    node = Ev(sp.BACKWARD + "SinBackward0", 300, 340, id=6, thread=2, seq=5,
              fwd_thread=1)
    cos = Ev("aten::cos", 305, 315, id=7, thread=2)
    fetch = Ev("aten::_local_scalar_dense", 400, 420, id=8)
    ev = [enc, sin, upload, mlp, mm, node, cos, fetch]
    ev += _launch(sin, "cudaLaunchKernel", "sin_kernel", 20, 30, 11, 12)
    ev += _launch(upload, "cudaMemcpyAsync",
                  "Memcpy HtoD (Pageable -> Device)", 40, 41, 12, 32)
    ev.append(Ev("cudaStreamSynchronize", 42, 55, id=13, link=3))
    ev += _launch(mm, "cudaLaunchKernel", "nvjet_tss_256x128_gemm", 120, 160,
                  14, 112)
    ev += _launch(cos, "cudaLaunchKernel", "cos_kernel", 316, 326, 15, 306)
    ev += _launch(None, "cudaMemcpyAsync",
                  "Memcpy HtoD (Pageable -> Device)", 62, 90, 16, 50)
    ev += _launch(fetch, "cudaMemcpyAsync", "Memcpy DtoH (Device -> Pinned)",
                  405, 406, 17, 401)
    ev.append(Ev("cudaStreamSynchronize", 402, 418, id=18, link=8))
    ev.append(Ev("cudaMemsetAsync", 403, 404, id=19, link=8))
    ev.append(Ev("cudaDeviceSynchronize", 430, 440, id=30))
    return ev


def test_device_work_goes_to_the_launching_span_or_to_unassigned():
    split = sp.attribute(_fabricated())
    rows = split["spans"]
    assert rows["model.encode"]["other_s"] == pytest.approx((10 + 1 + 10) / 1e6)
    assert rows["model.encode"]["launches"] == 3        # sin, upload, cos
    assert rows["model.mlp"]["gemm_s"] == pytest.approx(40e-6)
    assert rows["model.mlp"]["other_s"] == 0.0
    # the untraced thread's copy and the chunk's transfer
    assert rows[sp.UNASSIGNED]["launches"] == 2
    assert split["unassigned_ops"][0] == ("Memcpy HtoD (Pageable -> Device)",
                                          pytest.approx(28e-6))
    assert split["busy_s"] == pytest.approx((10 + 1 + 28 + 40 + 10 + 1) / 1e6)
    assert split["assigned_busy_s"] == pytest.approx(61e-6)


def test_a_kernel_listed_by_two_operations_goes_to_its_launch():
    """Two operations launch a kernel of the same name and duration, the
    second launch while the first operation still runs by the clock: each
    launch goes to the operation its link names."""
    first, second = Ev("model.encode", 0, 90, id=1), Ev("model.sample", 40, 70,
                                                         id=2)
    a = Ev("aten::sin", 1, 80, id=3)
    b = Ev("aten::sin", 50, 60, id=4)
    ev = [first, second, a, b]
    ev += _launch(b, "cudaLaunchKernel", "sin_kernel", 80, 85, 10, 52)
    ev += _launch(a, "cudaLaunchKernel", "sin_kernel", 30, 35, 11, 75)
    rows = sp.attribute(ev)["spans"]
    assert rows["model.encode"]["launches"] == 1
    assert rows["model.sample"]["launches"] == 1
    assert sp.UNASSIGNED not in rows


def test_a_launch_stamped_just_before_its_operation_still_finds_it():
    """The runtime's clock and the operations' may differ by a few µs: a
    call stamped 2 µs before its operation starts is still that
    operation's, not an earlier one's that launches the same kernel."""
    first, second = Ev("model.encode", 0, 20, id=1), Ev("model.sample", 40, 70,
                                                         id=2)
    a = Ev("aten::sin", 1, 10, id=3)
    b = Ev("aten::sin", 50, 60, id=4)
    ev = [first, second, a, b]
    ev += _launch(a, "cudaLaunchKernel", "sin_kernel", 30, 35, 10, 2)
    ev += _launch(b, "cudaLaunchKernel", "sin_kernel", 80, 85, 11, 48)
    rows = sp.attribute(ev)["spans"]
    assert rows["model.sample"]["launches"] == 1
    assert rows["model.encode"]["launches"] == 1


def test_a_launch_under_an_unlisted_range_goes_to_the_operation_around_it():
    """A reduction launches its kernel inside a dispatch range the
    profiler does not list: the link names that range's id, and the
    kernel goes to the listed operation around the runtime call."""
    losses = Ev("step.losses", 0, 100, id=1)
    total = Ev("aten::sum", 10, 40, id=2)
    ev = [losses, total]
    ev += _launch(total, "cudaLaunchKernel", "reduce_kernel", 50, 60, 20, 20)
    for e in ev[2:]:
        e.linked_correlation_id = 3          # the unlisted range
    rows = sp.attribute(ev)["spans"]
    assert rows == {"step.losses": dict(sp._row(), other_s=pytest.approx(
        10e-6), launches=1)}


def test_a_profiler_event_with_an_operations_id_takes_nothing():
    """The profiler's own host events carry ids of their own numbering:
    one with a launching operation's id neither launches its kernel nor
    encloses an operation."""
    enc = Ev("model.encode", 0, 100, id=1)
    copy = Ev("aten::copy_", 10, 30, id=2)
    buffer = Ev("Activity Buffer Request", 5, 90, id=2)
    ev = [enc, copy, buffer]
    ev += _launch(copy, "cudaMemcpyAsync", "Memcpy HtoD (Pageable -> Device)",
                  40, 41, 20, 12)
    ev.append(Ev("cudaStreamSynchronize", 13, 29, id=21, link=2))
    split = sp.attribute(ev)
    assert split["spans"]["model.encode"]["launches"] == 1
    assert split["spans"]["model.encode"]["syncs"] == 1
    assert sp.name_gaps(ev, [(6e-6, 7e-6)]) == [
        "host in [model.encode] Activity Buffer Request"]


def test_host_syncs_count_once_per_blocking_copy_or_synchronize():
    split = sp.attribute(_fabricated())
    rows = split["spans"]
    # the upload's copy and its synchronize count once, under the encode;
    # the untraced thread's pageable copy, the chunk's transfer and the
    # harness's synchronize under no span
    assert rows["model.encode"]["syncs"] == 1
    assert rows[sp.UNASSIGNED]["syncs"] == 3
    assert rows["model.mlp"]["syncs"] == 0
    assert split["syncs"] == 4


def test_a_long_copy_of_an_untraced_thread_and_its_wait_count_once():
    """The stager's blocking copy runs while the traced thread launches
    kernels: its synchronize comes many correlation ids later, inside an
    encode operation by time. It is the copy's wait, under no span."""
    enc = Ev("model.encode", 0, 2000, id=1)
    op = Ev("aten::mul", 10, 1990, id=2)
    ev = [enc, op] + _launch(None, "cudaMemcpyAsync",
                             "Memcpy HtoD (Pageable -> Device)", 150, 880, 50,
                             100)
    for i in range(51, 61):
        ev += _launch(op, "cudaLaunchKernel", "mul_kernel", 1000 + 10 * i,
                      1005 + 10 * i, i, 100 + 70 * (i - 50))
    ev.append(Ev("cudaStreamSynchronize", 905, 950, id=61, thread=9))
    split = sp.attribute(ev)
    assert split["syncs"] == 1
    assert split["spans"][sp.UNASSIGNED]["syncs"] == 1
    assert split["spans"]["model.encode"]["launches"] == 10


class _Kineto:
    """A Kineto event: the fields ``events_of`` reads, as methods."""

    def __init__(self, e, link):
        self.e, self.link = e, link

    def correlation_id(self):
        return self.e.id

    def name(self):
        return self.e.name

    def linked_correlation_id(self):
        return self.link


def test_events_of_takes_the_link_from_kineto_where_events_lack_it():
    """Torch 2.11's events carry no ``linked_correlation_id``: it comes
    from the Kineto event of the same correlation id and name. A kernel
    and its launch share a correlation id; an operation with that id as
    well takes its own link, 0."""
    fabricated = _fabricated()
    links = [e.linked_correlation_id for e in fabricated]
    clash = Ev("aten::add", 5, 6, id=11)       # an op's id = a launch's
    kineto = [_Kineto(e, e.linked_correlation_id)
              for e in fabricated + [clash]]
    for e in fabricated + [clash]:
        del e.linked_correlation_id

    class Prof:
        def events(self):
            return fabricated + [clash]

    Prof.profiler = type("P", (), {"kineto_results": type(
        "R", (), {"events": staticmethod(lambda: kineto)})})
    got = sp.events_of(Prof())
    assert [e.linked_correlation_id for e in got] == links + [0]
    assert sp.attribute(got)["spans"]["model.encode"]["launches"] == 3


def test_events_of_keeps_the_events_own_link():
    w = torch.randn(3, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("model.mlp"):
            (w @ w).relu()
    events = sp.events_of(prof)
    assert [e.name for e in events] == [e.name for e in prof.events()]
    assert all(e.linked_correlation_id == 0 for e in events)


def test_idle_gaps_carry_the_span_before_the_host_operation():
    names = sp.name_gaps(_fabricated(), [(0.0000449, 0.0000451),
                                         (0.0000250, 0.0000250),
                                         (0.000104, 0.000106),
                                         (0.000309, 0.000311),
                                         (0.000380, 0.000390)])
    assert names == ["host in [model.encode] cudaStreamSynchronize",
                     "host in [model.encode] no host operation",
                     "host in [model.mlp] no host operation",
                     "host in [model.encode] aten::cos",
                     "host in no host operation"]


def test_shares_under_a_span():
    shares = sp.assigned_shares(sp.attribute(_fabricated()))
    other = (10 + 1 + 28 + 10 + 1) / 1e6
    assert shares["other_pct"] == pytest.approx(100 * 21e-6 / other)
    assert shares["busy_pct"] == pytest.approx(100 * 61 / 90)


# -------------------------------------------------- the per-layer numbers


def _rows(**seconds):
    out = {}
    for key, (gemm, other, syncs) in seconds.items():
        row = sp._row()
        row.update(gemm_s=gemm, other_s=other, syncs=syncs)
        out[key.replace("_", ".")] = row
    return out


def _summary(kind):
    model = {"num_samples": 64, "hidden_proposal": 256, "proposal_depth": 4,
             "hidden_nerf": 1024, "nerf_depth": 8, "ipe_min_deg": 0,
             "ipe_max_deg": 12, "viewdir_min_deg": 0, "viewdir_max_deg": 4}
    kernels = [("nvjet_tss_256x128", 40, 0.46), ("composite_fwd_regs", 20,
                                                 0.002),
               ("composite_bwd_regs", 20, 0.003), ("vectorized_elementwise",
                                                   900, 1.25)]
    if kind == "train":
        return {"kind": "train", "model": model,
                "window": {"rate": 45000.0, "chunk_s": [1.8, 1.9, 1.85]},
                "segment": {"steps": 20, "rays": 81920,
                            "composite": {"K1": [4096, 64], "K2": [4096, 64]}},
                "kernels": kernels, "busy_s": 1.72, "wall_s": 1.9}
    return {"kind": "render", "model": model,
            "window": {"rate": 111000.0, "view_s": [2.45, 2.5]},
            "segment": {"views": 1, "rays": 272160,
                        "composite": {"K1": [8192, 64]}},
            "kernels": kernels[:2] + kernels[3:], "busy_s": 2.35,
            "wall_s": 2.53}


SPLIT = _rows(model_encode=(0.001, 0.18, 80), model_mlp=(0.47, 1.04, 0),
              model_sample=(0.0, 0.011, 20), step_losses=(0.0, 0.007, 0),
              step_adamw=(0.0, 0.0155, 0), unassigned=(0.0, 0.001, 5))


def test_per_layer_reads_the_train_split():
    s = dict(_summary("train"), spans=SPLIT, syncs=105)
    assert sp.per_layer(s) == pytest.approx({
        "encode_ms_per_step.train": 1e3 * 0.181 / 20,
        "sampling_ms_per_step.train": 1e3 * 0.011 / 20,
        "losses_ms_per_step.train": 1e3 * 0.007 / 20,
        "adamw_ms_per_step.train": 1e3 * 0.0155 / 20,
        "epilogue_ms_per_step.train": 1e3 * 1.04 / 20,
        "syncs_per_step.train": 105 / 20})


def test_per_layer_reads_the_render_split():
    s = dict(_summary("render"), spans=SPLIT, syncs=215)
    assert sp.per_layer(s) == pytest.approx({
        "encode_ms_per_view.render": 181.0, "sampling_ms_per_view.render": 11.0,
        "epilogue_ms_per_view.render": 1040.0, "syncs_per_view.render": 215.0})


def test_per_layer_is_empty_without_spans():
    """A program without spans (or a harness that passes none on) reads
    nothing, and raises nothing."""
    assert sp.per_layer(_summary("train")) == {}
    assert sp.per_layer(_summary("render")) == {}


READERS = sorted((REPO / "nerfbench" / "metrics").glob("*.py"))


@pytest.mark.parametrize("path", READERS, ids=[p.stem for p in READERS])
def test_existing_readers_read_the_same_with_the_spans_keys(path):
    spec = importlib.util.spec_from_file_location(
        "reader_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for kind in ("train", "render"):
        plain = _summary(kind)
        value = mod.read(plain)
        assert mod.read(dict(plain, spans=SPLIT, syncs=105)) == value
        assert (value is None) == (path.stem.split(".")[-1] != kind)


def test_cli_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sp.main(["--workload", "garden_quality.train", "--seed", "1"]) == 2
    assert "CUDA" in capsys.readouterr().err


def test_span_table_matches_the_program():
    """Every span the program opens is a key of SPANS: the program's
    ``span("...")`` literals, read from its source."""
    import re

    src = REPO / "mipnerf360_torch"
    opened = {m for f in src.rglob("*.py")
              for m in re.findall(r'span\("([a-z_.]+)"\)', f.read_text())}
    assert opened == set(sp.SPANS)
