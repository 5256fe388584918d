"""PyTorch port, the config zoo: every config under `configs/` builds in
the port (`tests/test_config_zoo.py` asks it of the JAX package), as the
detector its `model.type` names, in eval mode, in its compute dtype, with
the int8 flags it sets; a demo config's weights go through
`runtime/convert.py`'s flax-layout tree (`variables_of`) into a model
built from another seed and come back equal (`load_jax_variables`,
strict; the full-width models share the demos' module types). No JAX
here: the JAX weight trees load strictly into the full-width two-stage
and RPNG configs in `test_torch_port_rcnn.py::
test_load_jax_variables_full_width`, into `pillarnet34_waymo` in
`test_torch_port_waymo.py`, and into the demo configs in the parity tests
(`test_torch_port_legacy.py`, `test_torch_port_rcnn.py`)."""

import glob
import os

import pytest
import torch

from pillarnet_lts_torch.apis import build_model_from_cfg, load_config
from pillarnet_lts_torch.models.registry import DETECTORS
from pillarnet_lts_torch.runtime.convert import (load_jax_variables,
                                                 variables_of)
import test_torch_port_threads  # noqa: F401  (one torch thread)

ROOT = os.path.join(os.path.dirname(__file__), "..", "configs")
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "*", "*.py")))


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_config_builds_in_the_port(path):
    cfg = load_config(path)
    model = cfg["model"]
    port = build_model_from_cfg(cfg, device="cpu")
    assert type(port) is DETECTORS.get(model["type"])
    assert not port.training
    want = (torch.bfloat16 if model.get("dtype") == "bfloat16"
            else torch.float32)
    assert port.dtype == want
    first = model.get("first_stage_cfg", model)
    quant = [m for m in port.modules() if getattr(m, "quant", False)]
    assert bool(quant) == bool(first["backbone"].get("quant"))
    if "first_stage_cfg" in model:
        assert port.single_det.dtype == want
        assert port.num_second_stage == len(model["second_stage_modules"])
    n = sum(p.numel() for p in port.parameters())
    assert n > 0 and all(torch.isfinite(p).all() for p in port.parameters())
    if os.path.basename(os.path.dirname(path)) == "demo":
        other = load_jax_variables(build_model_from_cfg(cfg, device="cpu",
                                                        seed=1),
                                   variables_of(port))
        want, got = port.state_dict(), other.state_dict()
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
