"""On the card: the control of each cell (the reference one precision
lower in the system's place) fails the cell's limits while the system
passes them, on one seed at the cell's own sizes with a short sample
(`tools/readings.py` reads a dozen seeds); a training cell's half-batch
fault fails them too."""

import pytest

from benchmark.harness import check, session
from benchmark.tools import readings

pytestmark = pytest.mark.cuda
SEED = 2**31 + 7


@pytest.mark.parametrize("workload", ["nusc_f32_stream",
                                      "nusc_int8_offline_b8"])
def test_serving_control_fails_and_system_passes(workload, cuda_device):
    cell = session.load_cell(workload)
    s = session.Setup(cell, SEED, cuda_device)
    reqs = readings.sample_indices(s)[:1]
    idx = [r * s.batch + b for r in reqs for b in range(s.batch)]
    served = readings.served(s, reqs)
    del s.model, s.infer
    control = readings.control_frames(s, idx)
    ref = session.reference_frames(s, session.reference_for(s), idx)
    offsets = session.class_offsets(cell["config"]["model"])
    limits = cell["limits"]
    got = check.readings(served, ref, offsets)
    ctl = check.readings(control, ref, offsets)
    assert all(got[k] <= limits[k] for k in limits), got
    assert any(ctl[k] > limits[k] for k in limits), ctl


def test_training_control_and_fault_fail(cuda_device):
    cell = session.load_cell("nusc_f32_train_b4")
    limits = cell["limits"]
    rows = dict(readings.train_rows(cell, SEED, cuda_device, True, True,
                                    True))
    assert all(rows["system"][k] <= limits[k] for k in limits), rows
    for side in ("control", "half_batch"):
        assert any(rows[side][k] > limits[k] for k in limits), rows[side]
