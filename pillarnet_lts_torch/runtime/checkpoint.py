"""Training checkpoints: `{work_dir}/epoch_{n}.pth` and a `latest` pointer.

Port of the JAX package's `runtime/checkpoint.py` (save / latest / load /
load_pretrained; orbax there, `torch.save` here). A checkpoint holds the
model's state (parameters and BN running statistics), the optimizer's
state (moments and step count) and the meta: epoch, global iteration, the
config text and the class names.
"""

import logging
import os

import torch


def save_checkpoint(work_dir, model, optimizer, epoch, meta):
    path = os.path.abspath(os.path.join(work_dir, f"epoch_{epoch}.pth"))
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "meta": dict(meta)},
               path)
    with open(os.path.join(work_dir, "latest"), "w") as f:
        f.write(os.path.basename(path))
    return path


def latest_checkpoint(work_dir):
    """The checkpoint `latest` names, or None."""
    pointer = os.path.join(work_dir, "latest")
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        path = os.path.join(work_dir, f.read().strip())
    return path if os.path.exists(path) else None


def load_checkpoint(path, model, optimizer=None):
    """Restore `model` (and `optimizer`) in place; returns the meta."""
    ckpt = torch.load(path, map_location=next(model.parameters()).device,
                      weights_only=True)
    model.load_state_dict(ckpt["model"])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    return ckpt["meta"]


def is_port_checkpoint(blob):
    """Whether a loaded `.pth` is a checkpoint that `save_checkpoint`
    wrote (else a bare state_dict, e.g. a reference det3d one)."""
    return isinstance(blob, dict) and "model" in blob and "meta" in blob


def load_pretrained(model, source, subtree=None, logger=None):
    """Non-strict load by name and shape, in place: every tensor of the
    source whose name (prefixed with `subtree` + ".") is in
    `model.state_dict()` with the same shape is copied; the rest of the
    model keeps its values. `subtree="single_det"` loads a PillarNet
    checkpoint into a PillarRCNN's first stage.

    source: a path to a checkpoint of `save_checkpoint` or to a state_dict
    in the port's names, or such a loaded dict. Returns the report
    {'loaded': model names, 'missing': model names under `subtree` the
    source did not give, 'unexpected': source names with no model tensor,
    'shape_mismatch': source names whose shape differs}."""
    log = logger or logging.getLogger("checkpoint")
    blob = (torch.load(source, map_location="cpu", weights_only=True)
            if isinstance(source, (str, os.PathLike)) else source)
    state = blob["model"] if is_port_checkpoint(blob) else blob
    if not isinstance(state, dict) or not all(
            isinstance(v, torch.Tensor) for v in state.values()):
        raise ValueError(f"{source} holds no state_dict of tensors")
    prefix = f"{subtree}." if subtree else ""
    target = model.state_dict()
    report = {"loaded": [], "missing": [], "unexpected": [],
              "shape_mismatch": []}
    with torch.no_grad():
        for name, value in state.items():
            tgt = prefix + name
            if tgt not in target:
                report["unexpected"].append(name)
            elif tuple(value.shape) != tuple(target[tgt].shape):
                report["shape_mismatch"].append(name)
            else:
                target[tgt].copy_(value)
                report["loaded"].append(tgt)
    loaded = set(report["loaded"])
    report["missing"] = [k for k in target
                         if k.startswith(prefix) and k not in loaded]
    log.info("pretrained %s: loaded %d tensors into %s (%d missing, %d "
             "unexpected, %d shape-mismatched)",
             source if isinstance(source, (str, os.PathLike)) else "dict",
             len(report["loaded"]), subtree or "/", len(report["missing"]),
             len(report["unexpected"]), len(report["shape_mismatch"]))
    return report
