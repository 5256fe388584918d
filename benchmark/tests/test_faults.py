"""Runs of demo-sized cells on the CPU (the look for a card skipped) with
the timed path broken underneath: `correct` comes out false for each
fault a serving cell can have, and true for the unbroken path."""

import pytest
import torch

from benchmark.harness import session

from .conftest import demo_cell

CPU = torch.device("cpu")
SEED = 2**31 + 101


def _wrap(s, change):
    infer = s.infer

    def broken(points, mask):
        return change(infer(points, mask))

    s.infer = broken


def altered(s):
    """A served answer altered where it is produced: the scores moved."""
    _wrap(s, lambda det: dict(det, scores=det["scores"] + 0.01))


def stale(s):
    """A step that returns its state unchanged: every request gets the
    first request's detections."""
    first = {}

    def change(det):
        if not first:
            first.update({k: v.clone() for k, v in det.items()})
        return {k: v.clone() for k, v in first.items()}

    _wrap(s, change)


def half_batch(s):
    """Half of the batch left out: its slots carry the first frame's
    detections."""
    def change(det):
        out = {k: v.clone() for k, v in det.items()}
        n = out["mask"].shape[0]
        for k in out:
            out[k][n // 2:] = out[k][:1]
        return out

    _wrap(s, change)


def no_nms(s):
    """The suppression left out: an IoU threshold no pair exceeds."""
    from pillarnet_lts_torch.eval_utils import make_infer_fn

    cfg = s.model.processed_test_cfg()
    cfg["nms"] = dict(cfg["nms"], nms_iou_threshold=1.5)
    s.infer = make_infer_fn(s.model, cfg)


def _run(cell, fault):
    result, lines = session.run(cell, SEED, 0.3, False, CPU, fault=fault)
    assert lines[-1] == f"failed {result['failed']} limit 0"
    return result


@pytest.mark.parametrize("kind", ["stream", "closed"])
def test_sound_path_is_correct(kind):
    result = _run(demo_cell(kind), None)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("kind,fault", [
    ("stream", altered), ("stream", stale), ("stream", no_nms),
    ("closed", half_batch)])
def test_fault_is_caught(kind, fault):
    result = _run(demo_cell(kind), fault)
    assert not result["correct"], result["checks"]


def train_stale(s):
    """A step that returns its state unchanged: the losses and gradients
    are computed, the optimizer never steps."""
    def step(batch, generator=None):
        from pillarnet_lts_torch.runtime.train_step import step_losses

        total, _ = step_losses(s.model, batch, s.cell["config"]["train_cfg"])
        return {"loss": total.detach()}

    s.step = step


def train_half_batch(s):
    """Half of the batch left out, the mean taken over the rest."""
    step = s.step

    def half(batch, generator=None):
        n = batch["points"].shape[0] // 2
        return step({k: [t[:n] for t in v] if isinstance(v, list) else v[:n]
                     for k, v in batch.items()}, generator)

    s.step = half


def test_training_sound_step_is_correct():
    from .conftest import demo_train_cell

    result, lines = session.run(demo_train_cell(), SEED, 0.3, False, CPU)
    assert result["correct"], result["checks"]
    assert lines[-2] == "steps_compared 3 limit >= 1"


@pytest.mark.parametrize("fault", [train_stale, train_half_batch])
def test_training_fault_is_caught(fault):
    from .conftest import demo_train_cell

    result, _ = session.run(demo_train_cell(), SEED, 0.3, False, CPU,
                            fault=fault)
    assert not result["correct"], result["checks"]
