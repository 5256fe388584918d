"""The per-layer metrics read from inside the system (`harness/inside.py`,
the port's tracer): a traced CPU run of each demo cell reads every one of
its cell's metrics and none of another cell's; the records keep the
window's requests and leave the profiled ones out; without the system's
tracer every one of them reads nothing."""

import types

import pytest
import torch

from benchmark.harness import inside, session

from .conftest import demo_cell, demo_train_cell

CPU = torch.device("cpu")
SEED = 2**31 + 211
LAYERS = ("reader", "backbone", "neck_head", "predict")
NEW = {"stream": [f"{k}_host_ms.stream" for k in LAYERS]
       + ["host_wait_ms.stream"],
       "offline": [f"{k}_host_ms.offline" for k in LAYERS]
       + ["host_wait_ms.offline"],
       "train": ["step_host_ms.train", "optimizer_host_ms.train"]}


@pytest.fixture(scope="module")
def traced():
    cells = {"stream": demo_cell("stream"), "offline": demo_cell("closed"),
             "train": demo_train_cell()}
    return {tag: session.run(cell, SEED, 0.3, True, CPU)[0]
            for tag, cell in cells.items()}


@pytest.mark.parametrize("tag", sorted(NEW))
def test_each_cell_reads_its_own_metrics(traced, tag):
    result = traced[tag]
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for other, names in NEW.items():
        for name in names:
            if other == tag:
                assert metrics[name]["unit"] == "ms"
                assert metrics[name]["value"] > 0, name
            else:
                assert name not in metrics, name
    if tag != "train":
        issue = metrics[f"host_issue_ms.{tag}"]["value"]
        for k in LAYERS:
            assert metrics[f"{k}_host_ms.{tag}"]["value"] < issue


def _span(sid, name, request, start, end, profiled=False):
    return {"name": name, "id": sid, "parent": None if sid == request
            else request, "request": request, "start_ns": start,
            "end_ns": end, "profiled": profiled, "device_ms": None}


def test_records_keep_the_window_and_leave_out_the_profiled(monkeypatch):
    """Three requests then a profiled one: a window of two reads the last
    two unprofiled ones, a span's occurrences in a request summed."""
    ms = 1_000_000
    spans = []
    for i, reader_ms in enumerate((9, 1, 3)):
        rid = 10 * (i + 1)
        spans += [_span(rid + 1, "reader", rid, 0, reader_ms * ms),
                  _span(rid + 2, "reader", rid, 0, ms),
                  _span(rid, "serving.request", rid, 0, 50 * ms)]
    spans += [_span(41, "reader", 40, 0, 100 * ms, True),
              _span(40, "serving.request", 40, 0, 200 * ms, True),
              _span(50, "serving.sync", None, 0, 7 * ms),
              _span(51, "serving.sync", None, 0, 5 * ms)]
    monkeypatch.setattr(inside, "snapshot",
                        lambda: {"spans": spans, "counters": {}})
    ctx = types.SimpleNamespace(tag="stream", host_issue_ms=[1.0, 1.0],
                                layer_ms={})
    assert [r["reader"] for r in inside.records(ctx, "serving.request")] \
        == [2.0, 4.0]
    assert inside.request_ms(ctx, "stream", "serving.request",
                             "reader") == 3.0
    assert inside.span_ms(ctx, "stream", "serving.sync") == 6.0
    assert inside.request_ms(ctx, "offline", "serving.request",
                             "reader") is None


def test_nothing_is_read_without_the_tracer(monkeypatch):
    monkeypatch.setattr(inside, "snapshot", lambda: None)
    readers = session.metric_readers()
    for tag, names in NEW.items():
        ctx = types.SimpleNamespace(tag=tag, host_issue_ms=[1.0],
                                    layer_ms={"forward": [1.0]})
        for name in names:
            assert readers[name].read(ctx) is None, name
