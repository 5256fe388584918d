"""Training checkpoints: `{work_dir}/epoch_{n}.pth` and a `latest` pointer.

Port of the JAX package's `runtime/checkpoint.py` (save / latest / load;
orbax there, `torch.save` here). A checkpoint holds the model's state
(parameters and BN running statistics), the optimizer's state (moments and
step count) and the meta: epoch, global iteration, the config text and
the class names.
"""

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
