"""Shared pieces of the benchmark's tests: the demo-sized cells (the
repository's `configs/demo/pillarnet18_demo.py` network as a benchmark
configuration), and a fixture that decides whether a CUDA card is
there."""

import copy
import json
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def demo_config(quant=False):
    with open(os.path.join(HERE, "demo_config.json")) as f:
        cfg = json.load(f)
    if quant:
        cfg["model"]["dtype"] = "bfloat16"
        for k in ("reader", "backbone", "neck"):
            cfg["model"][k]["quant"] = True
    return cfg


def demo_cell(kind="stream", quant=False, limits=None):
    """A cell at the demo's size: a stream at 20 Hz, or batches of 4."""
    stream = kind == "stream"
    traffic = {"kind": kind, "tag": "stream" if stream else "offline",
               "batch": 1 if stream else 4, "rate_hz": 20.0, "pool": 3,
               "depth": 2, "points": 4096, "nsweeps": 10,
               "sample_frames": 3 if stream else 4}
    return {"name": f"demo_{kind}", "config": demo_config(quant),
            "traffic": traffic, "chips": 1,
            "limits": copy.deepcopy(limits or {"det_gap": 1e-4,
                                               "kept_mismatch": 0.0})}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)


def demo_train_cell(limits=None):
    """A training cell at the demo's size: batches of 2 scenes."""
    traffic = {"kind": "train", "tag": "train", "batch": 2, "pool": 3,
               "scene_points": 4096, "num_boxes": [3, 9],
               "checked_steps": 3}
    return {"name": "demo_train", "config": demo_config(), "traffic": traffic,
            "chips": 1,
            "limits": copy.deepcopy(limits or {"loss_gap": 1e-5,
                                               "grad_gap": 1e-3,
                                               "change_gap": 2e-2})}
