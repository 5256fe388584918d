"""The process group of a data-parallel run, and its collectives.

The counterpart of `pillarnet_lts_tpu/parallel/dist.py` (the host-object
gather and barrier of a multi-host eval) plus the process-group start-up
of the JAX package's `tools/train.py --multihost`, over
`torch.distributed`. A run is launched by `torchrun`, one process per
card:

    torchrun --nproc_per_node N -m pillarnet_lts_torch.tools.train CONFIG

`init_from_env` starts the group from torchrun's environment (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`,
`MASTER_PORT`). Without that environment nothing starts and every helper
here is the identity, so a plain `python -m ...` run is the one-process
run it always was.

In the JAX package the compiler inserts the data-parallel collectives;
here they are explicit, each at its own site: the masked BN's sums
(`models/utils/norm.py`, `sum_with_grad`), the losses' normalizers
(`sum_over_ranks`), the gradients and the logged metrics
(`runtime/train_step.py`, `sum_gradients_over_ranks`).

A group splits the batch (data parallel, the default) or the BEV grid
(`parallel/spatial.py`: a process that builds a detector with
`spatial_axis` calls `split_grid`). Under a grid split every rank holds
the whole batch, so the data-parallel collectives are off
(`splits_batch` is False: the losses' normalizers and the metrics are
not summed, the draws are not split), and only the sharded stages'
collectives run.
"""

import datetime
import os

import torch
import torch.distributed as dist

# a rank that waits this long for the others at the group's start or in a
# collective raises (a hung peer fails the run instead of stalling it)
INIT_TIMEOUT = datetime.timedelta(minutes=10)
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def launched():
    """Whether torchrun's environment is present."""
    return all(k in os.environ for k in _TORCHRUN_ENV)


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def init_from_env(device="cuda", backend=None, timeout=INIT_TIMEOUT):
    """Start the process group when torchrun's environment is present and
    return this rank's device; without it start nothing and return
    `torch.device(device)`.

    The card of a rank is `cuda:LOCAL_RANK`; a rank without one raises.
    backend: `nccl` for "cuda", `gloo` for "cpu", or the caller's. The
    NCCL group is started eagerly on the rank's card, so a failed start
    raises here; nothing falls back to another backend or device. A rank
    that waits longer than `timeout` for the others raises. Calling it
    again in a process whose group is up returns the device."""
    if not launched():
        return torch.device(device)
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        cards = torch.cuda.device_count()
        local = int(os.environ["LOCAL_RANK"])
        if local >= cards:
            raise RuntimeError(f"local rank {local} has no card of its own "
                               f"({cards} cards)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    elif device == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if not is_initialized():
        extra = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=timeout, **extra)
    return dev


def shutdown():
    """Tear the group down (nothing without one)."""
    if is_initialized():
        dist.destroy_process_group()


_SPLIT = {"grid": False}


def split_grid():
    """Declare that this process's group splits the BEV grid, not the
    batch (`parallel/spatial.py`); it stays so for the process."""
    _SPLIT["grid"] = True


def splits_batch():
    """Whether a group is up and splits the batch (data parallel)."""
    return is_initialized() and not _SPLIT["grid"]


def batch_process_count():
    """The ranks that split the batch: the group's size under data
    parallelism, 1 under a grid split or without a group."""
    return process_count() if splits_batch() else 1


def process_count():
    """The number of ranks (1 without a group)."""
    return dist.get_world_size() if is_initialized() else 1


def rank():
    return dist.get_rank() if is_initialized() else 0


def local_process_count():
    """The ranks on this node (torchrun's `LOCAL_WORLD_SIZE`; 1 without a
    group)."""
    if not is_initialized():
        return 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))


def barrier():
    """Wait for every rank (`sync_global_devices`)."""
    if is_initialized():
        dist.barrier()


def all_gather_objects(obj):
    """One picklable object per rank -> the list of all ranks' objects in
    rank order (`[obj]` without a group)."""
    n = process_count()
    if n <= 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj)
    return out


def merge_detection_dicts(per_rank_dicts):
    """Union of per-rank {token: sample} maps; a token that several ranks
    hold (a shard's wrap-around padding) is kept once."""
    merged = {}
    for d in per_rank_dicts:
        merged.update(d)
    return merged


def gather_detections(detections):
    """This rank's {token: sample} detections -> every rank's, gathered and
    merged by token (`merge_detection_dicts`), on every rank; the map
    itself without a group."""
    if process_count() <= 1:
        return detections
    return merge_detection_dicts(all_gather_objects(detections))


def sum_over_ranks(t):
    """The sum over the ranks of a tensor without gradient (a count that
    normalizes a loss, a logged metric): a new tensor, or `t` itself
    unless the group splits the batch."""
    if not splits_batch():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


class _SumOverRanks(torch.autograd.Function):
    """The all-reduce (sum) whose backward is the all-reduce (sum) of the
    output's gradient: d(sum over ranks of the losses)/d(rank's input)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def sum_with_grad(t):
    """The sum over the ranks of `t`, differentiable: the gradient of each
    rank's input is the sum over the ranks of the output's gradients
    (`t` itself without a group)."""
    if not is_initialized():
        return t
    return _SumOverRanks.apply(t)


def _flat_collective(params, collective):
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    collective(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_gradients(params):
    """Replace every `.grad` of `params` by rank 0's, in one collective
    (nothing without a group): gradients that every rank computes from
    the same inputs, which a nondeterministic backward kernel (cuDNN's
    weight gradients add with atomics) makes part in their last bits, so
    that the ranks' replicas stay identical."""
    if is_initialized():
        _flat_collective(params, lambda flat: dist.broadcast(flat, 0))


def sum_gradients_over_ranks(params):
    """Replace every `.grad` of `params` by its sum over the ranks, in one
    collective over the flattened gradients. A parameter without a
    gradient (a frozen one, on every rank alike) takes no part."""
    if is_initialized():
        _flat_collective(params, dist.all_reduce)
