"""Config -> module builders, reading the repo's `configs/*.py`.

Config keys that only select TPU layouts or training machinery (remat,
space-to-depth, H-packing, W-chunking, the Pallas s2d stage) are dropped:
the port runs the plain eval layout, which the JAX package pins equal to
them. Keys that select a path the port does not have yet (int8 deploy, the
compact sparse reader, bf16 compute) raise.
"""

import torch

from .registry import (BACKBONES, DETECTORS, HEADS, NECKS, READERS,
                       build_from_cfg)

_DROPPED_KEYS = ("logger", "remat", "remat_policy", "s2d_stage1", "chunk_nc",
                 "chunk_min_w", "chunk_train", "hpack", "s2d_pallas",
                 "quant_scatter", "spatial_axis")

# key -> the only value the port runs
_UNPORTED = {"quant": False, "compact_kmax": 0, "compact_kmax2": 0}

_F32 = (None, "float32", "fp32", torch.float32)


def _clean(cfg, device):
    cfg = dict(cfg)
    for k in _DROPPED_KEYS:
        cfg.pop(k, None)
    for k, only in _UNPORTED.items():
        if cfg.pop(k, only) != only:
            raise NotImplementedError(f"{cfg.get('type')}: {k} is not ported")
    if cfg.pop("dtype", None) not in _F32:
        raise NotImplementedError(f"{cfg.get('type')}: only float32 is ported")
    cfg["device"] = device
    return cfg


def build_reader(cfg, device=None):
    return build_from_cfg(_clean(cfg, device), READERS)


def build_backbone(cfg, device=None):
    return build_from_cfg(_clean(cfg, device), BACKBONES)


def build_neck(cfg, backbone_channels, device=None):
    return build_from_cfg(_clean(cfg, device), NECKS,
                          dict(backbone_channels=backbone_channels))


def build_head(cfg, feat_channels, device=None):
    return build_from_cfg(_clean(cfg, device), HEADS,
                          dict(feat_channels=feat_channels))


def build_detector(cfg, train_cfg=None, test_cfg=None, device=None):
    """Build a detector from a model config, in eval mode.

    Sets full-f32 convs and matmuls for the process
    (`torch.backends.cudnn.allow_tf32` and `torch.backends.cuda.matmul.
    allow_tf32` False): cuDNN's default TF32 keeps only ~3 digits per conv.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_from_cfg(_clean(cfg, device), DETECTORS,
                           dict(train_cfg=train_cfg, test_cfg=test_cfg))
    return model.eval()
