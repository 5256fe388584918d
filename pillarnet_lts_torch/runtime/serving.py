"""Latency-hiding inference pipeline.

Port of `pillarnet_lts_tpu/runtime/serving.py`. PyTorch queues CUDA work
asynchronously and the port's inference path never syncs the host, so a
call returns once its work is queued. `ServingPipeline` keeps up to `depth`
calls in flight and syncs the oldest (`.cpu()`) once more are queued, so the
host prepares and launches request k+1 while the card still runs request k.
"""

from collections import deque

import torch

from . import tracing


def to_host(out):
    """Copy a (nested dict/list/tuple of) tensor result to numpy; the copy
    waits for the work that produced it. Traced as one `serving.sync`
    span and one `host_syncs` count a call: the host blocked on the
    card."""
    with tracing.span("serving.sync"):
        tracing.count("host_syncs")
        return _to_numpy(out)


def _to_numpy(out):
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    if isinstance(out, dict):
        return {k: _to_numpy(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_to_numpy(v) for v in out)
    return out


class ServingPipeline:
    """Order-preserving bounded-depth inference pipeline.

    infer_fn: callable returning tensors (typically `make_infer_fn(model)`).
    depth: max submissions in flight before the oldest is synced.
    """

    def __init__(self, infer_fn, depth=4):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.infer_fn = infer_fn
        self.depth = depth
        self._pending = deque()

    def __len__(self):
        return len(self._pending)

    def submit(self, *args, **kwargs):
        """Queue one call; returns the OLDEST result on the host once more
        than `depth` calls are outstanding, else None."""
        self._pending.append(self.infer_fn(*args, **kwargs))
        if len(self._pending) > self.depth:
            return to_host(self._pending.popleft())
        return None

    def drain(self):
        """Sync and yield all outstanding results in submission order."""
        while self._pending:
            yield to_host(self._pending.popleft())

    def map(self, arg_tuples):
        """Pipeline over an iterable of argument tuples; yields host results
        in submission order."""
        for args in arg_tuples:
            out = self.submit(*args)
            if out is not None:
                yield out
        yield from self.drain()
