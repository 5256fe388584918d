"""Config -> module builders, reading the repo's `configs/*.py`.

Config keys that only select TPU layouts or XLA's remat policy
(space-to-depth, H-packing, W-chunking, `remat_policy`) are dropped: the
port runs the plain layout, which the JAX package pins equal to them.
`quant` (int8 deploy), `quant_scatter`, `s2d_pallas` (the fused int8
stride-1 stage), the backbone's `remat` (activation recompute in
training) and the compact sparse path (`reader.compact_kmax`,
`backbone.compact_kmax2`) are live. The compute dtype (`dtype`, float32 or
bfloat16) is a detector-level key, as in the JAX package.
"""

import torch

from .registry import (BACKBONES, DETECTORS, HEADS, NECKS, POINT_HEAD,
                       READERS, ROI_HEAD, SECOND_STAGE, build_from_cfg)

_DROPPED_KEYS = ("logger", "remat_policy", "s2d_stage1", "chunk_nc",
                 "chunk_min_w", "chunk_train", "hpack", "spatial_axis")

_DTYPES = {None: torch.float32, "float32": torch.float32,
           "fp32": torch.float32, torch.float32: torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           torch.bfloat16: torch.bfloat16}


def compute_dtype(value):
    """Config dtype -> torch dtype (float32 or bfloat16)."""
    if value not in _DTYPES:
        raise NotImplementedError(f"compute dtype {value!r} is not ported")
    return _DTYPES[value]


def _clean(cfg, device):
    cfg = dict(cfg)
    for k in _DROPPED_KEYS:
        cfg.pop(k, None)
    cfg["device"] = device
    return cfg


def _component(cfg, device):
    """A component's config: the compute dtype comes from the detector."""
    cfg = _clean(cfg, device)
    compute_dtype(cfg.pop("dtype", None))
    return cfg


def build_reader(cfg, device=None, dtype=torch.float32):
    return build_from_cfg(_component(cfg, device), READERS, dict(dtype=dtype))


def build_backbone(cfg, device=None):
    return build_from_cfg(_component(cfg, device), BACKBONES)


def build_neck(cfg, backbone_channels, device=None):
    return build_from_cfg(_component(cfg, device), NECKS,
                          dict(backbone_channels=backbone_channels))


def build_head(cfg, feat_channels, device=None):
    return build_from_cfg(_component(cfg, device), HEADS,
                          dict(feat_channels=feat_channels))


def build_second_stage_module(cfg, backbone_channels=None,
                              backbone_strides=None, device=None):
    """A second-stage module; the RoI-grid modules take the backbone's
    geometry, the box-centre extractor none (None: not passed)."""
    geometry = dict(backbone_channels=backbone_channels,
                    backbone_strides=backbone_strides)
    return build_from_cfg(
        _component(cfg, device), SECOND_STAGE,
        {k: v for k, v in geometry.items() if v is not None})


def build_roi_head(cfg, device=None, dtype=torch.float32):
    return build_from_cfg(_component(cfg, device), ROI_HEAD,
                          dict(dtype=dtype))


def build_point_head(cfg, device=None, dtype=torch.float32):
    return build_from_cfg(_component(cfg, device), POINT_HEAD,
                          dict(dtype=dtype))


def build_detector(cfg, train_cfg=None, test_cfg=None, device=None):
    """Build a detector from a model config, in eval mode.

    Sets full-f32 convs and matmuls for the process
    (`torch.backends.cudnn.allow_tf32` and `torch.backends.cuda.matmul.
    allow_tf32` False): cuDNN's default TF32 keeps only ~3 digits per conv,
    and the int8 reader's integer matmul must stay exact.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _clean(cfg, device)
    cfg["dtype"] = compute_dtype(cfg.get("dtype"))
    model = build_from_cfg(cfg, DETECTORS,
                           dict(train_cfg=train_cfg, test_cfg=test_cfg))
    return model.eval()
