"""The port's tracer (`pillarnet_lts_torch/runtime/tracing.py`) on the CPU:
the serving and training spans of the demo config with their nesting and
request ids, the levels, the ring's bound, the counters (host syncs, the
kernels' launches), the no-op under `torch.export` and `torch.compile`,
the `pillarnet.*` ranges in a profiler's trace, and the readers that moved
onto it (`IterTimerHook`, `dist_test --speed_test`). The card's half of
the shared clock (the kernels' launches inside their layer's range) is in
`tests/test_torch_port_cuda.py`."""

import logging
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pillarnet_lts_torch.apis import (build_model_from_cfg,  # noqa: E402
                                      load_config, optimizer_from_cfg)
from pillarnet_lts_torch.datasets import (SynthDataset,  # noqa: E402
                                          collate_batch,
                                          synth_points_realistic)
from pillarnet_lts_torch.eval_utils import make_infer_fn  # noqa: E402
from pillarnet_lts_torch.ops import _kernels  # noqa: E402
from pillarnet_lts_torch.runtime import tracing  # noqa: E402
from pillarnet_lts_torch.runtime.serving import (  # noqa: E402
    ServingPipeline, to_host)
from pillarnet_lts_torch.runtime.train_step import (  # noqa: E402
    batch_to_device, train_step)

ROOT = os.path.join(os.path.dirname(__file__), "..")
DEMO = os.path.join(ROOT, "configs", "demo", "pillarnet18_demo.py")
LAYERS = ["reader", "backbone", "neck", "head", "predict"]
STAGES = [f"backbone.conv{i}" for i in range(1, 6)]


@pytest.fixture
def fresh():
    """An empty tracer at the `host` level, put back as found."""
    prev = tracing.configure("host")
    launches = dict(tracing.LAUNCHES)
    tracing.reset()
    yield tracing
    tracing.reset()
    tracing.LAUNCHES.update(launches)
    tracing.configure(prev)


@pytest.fixture(scope="module")
def demo():
    cfg = load_config(DEMO)
    model = build_model_from_cfg(cfg, device="cpu", seed=0)
    pts, msk = synth_points_realistic(2, 4096, cfg["point_cloud_range"],
                                      seed=5, nsweeps=10)
    return cfg, model, (torch.from_numpy(pts), torch.from_numpy(msk))


def _children(spans, parent):
    return sorted((s for s in spans if s["parent"] == parent),
                  key=lambda s: s["start_ns"])


@pytest.mark.parametrize("route", ["call", "pipeline"])
def test_serving_spans_nest_under_one_request(fresh, demo, route):
    """Each request of the demo f32 model, served alone or through the
    pipeline: `serving.request` over reader, backbone (over its five
    stages), neck, head, predict in that order under its id; one
    `serving.sync` after it, outside it; the counters."""
    _, model, (pts, msk) = demo
    infer = make_infer_fn(model)
    if route == "call":
        for _ in range(2):
            to_host(infer(pts, msk))
    else:
        assert len(list(ServingPipeline(infer, depth=1).map(
            [(pts, msk)] * 2))) == 2
    spans = tracing.snapshot()["spans"]
    reqs = sorted((s for s in spans if s["name"] == "serving.request"),
                  key=lambda s: s["start_ns"])
    syncs = sorted((s for s in spans if s["name"] == "serving.sync"),
                   key=lambda s: s["start_ns"])
    assert len(reqs) == len(syncs) == 2
    for req, sync in zip(reqs, syncs):
        assert req["request"] == req["id"] and req["parent"] is None
        kids = _children(spans, req["id"])
        assert [s["name"] for s in kids] == LAYERS
        backbone = kids[1]
        assert [s["name"] for s in _children(spans, backbone["id"])] \
            == STAGES
        inside = [s for s in spans if s["request"] == req["id"]]
        assert len(inside) == 1 + len(LAYERS) + len(STAGES)
        for s in inside:
            assert req["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= req["end_ns"]
            assert not s["profiled"] and s["device_ms"] is None
        assert sync["request"] is None and sync["parent"] is None
        assert sync["start_ns"] >= req["end_ns"]
    c = tracing.counters()
    assert (c["serving.requests"], c["serving.frames"], c["host_syncs"]) \
        == (2, 2 * pts.shape[0], 2)
    summary = tracing.summary("serving.request")
    assert set(summary) == {"serving.request", *LAYERS, *STAGES}
    assert all(v["requests"] == 2 and v["host_ms"] > 0
               and v["device_ms"] is None for v in summary.values())


def _demo_batch(cfg, n=2):
    ds = SynthDataset(cfg, n, 4096, seed=3)
    return collate_batch([ds[i] for i in range(n)], 4096)


@pytest.fixture
def group_of_one(tmp_path):
    """A gloo process group of one rank over a file store (no network)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("grouped", [False, True])
def test_train_step_spans(fresh, request, grouped):
    """A demo-config step: `train.feed` from `batch_to_device`, then one
    `train.step` over forward (over the model's layers), loss, backward,
    grad_sync (only in a process group) and optimizer, in that order;
    `train.steps` counted."""
    if grouped:
        request.getfixturevalue("group_of_one")
    cfg = load_config(DEMO)
    model = build_model_from_cfg(cfg, device="cpu", seed=0)
    opt = optimizer_from_cfg(model, cfg, 10)
    metrics = train_step(model, opt, batch_to_device(_demo_batch(cfg), "cpu"),
                         cfg["train_cfg"])
    assert torch.isfinite(metrics["loss"])
    spans = tracing.snapshot()["spans"]
    steps = [s for s in spans if s["name"] == "train.step"]
    assert len(steps) == 1
    step = steps[0]
    feed = [s for s in spans if s["name"] == "train.feed"]
    assert len(feed) == 1 and feed[0]["end_ns"] <= step["start_ns"]
    want = ["train.forward", "train.loss", "train.backward"] \
        + (["train.grad_sync"] if grouped else []) + ["train.optimizer"]
    kids = _children(spans, step["id"])
    assert [s["name"] for s in kids] == want
    assert [s["name"] for s in _children(spans, kids[0]["id"])] \
        == ["reader", "backbone", "neck", "head"]
    assert tracing.counters()["train.steps"] == 1


def test_off_records_nothing(fresh, demo):
    """At `off`, `span` and `request` hand back one shared object and no
    span is kept; the counters still count."""
    _, model, (pts, msk) = demo
    tracing.configure("off")
    assert tracing.span("a") is tracing.span("b") is tracing.request("c")
    to_host(make_infer_fn(model)(pts, msk))
    assert tracing.snapshot()["spans"] == []
    assert tracing.counters()["serving.requests"] == 1
    assert tracing.summary("serving.request") == {}


def test_ring_keeps_its_bound(fresh):
    for i in range(tracing.RING + 10):
        with tracing.span("s"):
            pass
    spans = tracing.snapshot()["spans"]
    assert len(spans) == tracing.RING
    assert spans[-1]["id"] - spans[0]["id"] == tracing.RING - 1


def test_host_syncs_count_one_per_to_host(fresh):
    """`to_host` recurses over a nested result: one count and one
    `serving.sync` span a call from outside."""
    out = {"a": torch.ones(2), "b": [torch.zeros(1), (torch.ones(3),)],
           "c": 4}
    host = to_host(out)
    assert isinstance(host["b"][1][0], np.ndarray) and host["c"] == 4
    to_host(torch.ones(1))
    assert tracing.counters()["host_syncs"] == 2
    assert [s["name"] for s in tracing.snapshot()["spans"]] \
        == ["serving.sync"] * 2


def test_launches_stay_the_launch_counter(fresh):
    """`_kernels.LAUNCHES` is the tracer's launch counters: one a
    successful launch, none for a failed one, shown as `launch.<name>`."""
    assert _kernels.LAUNCHES is tracing.LAUNCHES
    _kernels.launched("rotated_overlap", 0)
    with pytest.raises(RuntimeError):
        _kernels.launched("rotated_overlap", 700)
    assert _kernels.LAUNCHES["rotated_overlap"] == 1
    assert tracing.counters()["launch.rotated_overlap"] == 1
    _kernels.reset_launches()
    assert tracing.counters()["launch.rotated_overlap"] == 0


class _Traced(torch.nn.Module):
    def forward(self, x):
        with tracing.request("serving.request"):
            tracing.count("serving.frames", x.shape[0])
            with tracing.span("reader"):
                return x * 2


def test_no_op_under_export_and_compile(fresh):
    """`torch.export` and `torch.compile` (whole graph, no break) trace
    through the spans without recording or counting anything."""
    x = torch.ones(3, 2)
    torch.export.export(_Traced(), (x,))
    compiled = torch.compile(_Traced(), backend="eager", fullgraph=True)
    assert torch.equal(compiled(x), x * 2)
    assert tracing.snapshot()["spans"] == []
    assert "serving.frames" not in tracing.counters()
    _Traced()(x)
    assert len(tracing.snapshot()["spans"]) == 2


def test_profiled_spans_enter_named_ranges(fresh):
    """Under `torch.profiler` a span is marked `profiled` and its
    `pillarnet.<name>` range lies in the trace around its children's;
    `summary` keeps profiled and unprofiled requests apart."""
    with tracing.request("serving.request"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.request("serving.request"):
            with tracing.span("reader"):
                torch.ones(8).sum()
    spans = tracing.snapshot()["spans"]
    assert [s["profiled"] for s in spans] == [False, True, True]
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name.startswith("pillarnet.")}
    assert set(ranges) == {"pillarnet.serving.request", "pillarnet.reader"}
    outer, inner = ranges["pillarnet.serving.request"], \
        ranges["pillarnet.reader"]
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert set(tracing.summary("serving.request", profiled=True)) \
        == {"serving.request", "reader"}
    assert set(tracing.summary("serving.request")) == {"serving.request"}


def test_levels_and_names(fresh):
    """`device` on a process without a card records host spans only;
    an unknown level and a name a profiler reader takes for a launch
    call raise."""
    assert tracing.configure("device") == "host"
    with tracing.span("x"):
        pass
    assert tracing.last("x")["device_ms"] is None
    with pytest.raises(ValueError):
        tracing.configure("everything")
    for bad in ("cudaLaunchKernel", "x.Memcpy"):
        with pytest.raises(ValueError):
            tracing.span(bad)
    assert tracing.configure("host") == "device"


def test_summary_sums_a_name_within_a_request(fresh):
    for n in (1, 3, 5):
        with tracing.request("train.step"):
            for _ in range(n):
                with tracing.span("part"):
                    pass
    s = tracing.summary("train.step")
    assert s["part"]["requests"] == 3
    assert s["part"]["host_ms"] <= s["train.step"]["host_ms"]


def test_iter_timer_reads_the_spans(fresh):
    from pillarnet_lts_torch.runtime.hooks import IterTimerHook
    from pillarnet_lts_torch.runtime.log_buffer import LogBuffer

    trainer = type("T", (), {"log_buffer": LogBuffer()})()
    with tracing.span("train.iter"):
        with tracing.span("train.feed"):
            torch.ones(4).sum()
    IterTimerHook().after_train_iter(trainer)
    feed, it = tracing.last("train.feed"), tracing.last("train.iter")
    buf = trainer.log_buffer
    buf.average()
    assert buf.output["data_time"] == pytest.approx(
        (feed["end_ns"] - feed["start_ns"]) * 1e-9)
    assert buf.output["time"] == pytest.approx(
        (it["end_ns"] - it["start_ns"]) * 1e-9)


def test_speed_test_reports_the_layers(fresh, demo):
    """`dist_test.speed_test` at batch 1: a frame's host ms from its
    request and sync spans, each layer's medians, the level restored."""
    from pillarnet_lts_torch.tools import dist_test

    _, model, (pts, msk) = demo
    batches = [{"points": pts[i:i + 1].numpy(),
                "points_mask": msk[i:i + 1].numpy(),
                "metadata": [{"token": f"t{i}"}]} for i in range(2)]
    dets, rec = dist_test.speed_test(
        make_infer_fn(model), batches, torch.device("cpu"),
        lambda b: b["metadata"], logging.getLogger("test"))
    assert sorted(dets) == ["t0", "t1"]
    assert rec["frames"] == len(rec["host_ms_all"]) == 2
    assert rec["host_ms"] == pytest.approx(np.median(rec["host_ms_all"]))
    assert set(LAYERS + STAGES) <= set(rec["layers"])
    assert tracing.configure("host") == "host"
