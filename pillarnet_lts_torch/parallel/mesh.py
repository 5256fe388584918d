"""The data-parallel layout: one state on every rank, each rank its rows
of the global batch.

The counterpart of `pillarnet_lts_tpu/parallel/mesh.py` (`make_mesh`,
`shard_batch`, `replicate`). The JAX package shards the global batch on
a 1-D 'dp' mesh of all devices and replicates the state; here every rank
holds the whole model (`replicate`), loads its own rows of the global
batch (`rank_batch_size`, `train_shards`) and draws the random numbers
of the global batch, keeping its rows (`rank_rows`), so that its draws
are the one-process run's rows.

The batch follows the JAX package: a step consumes `samples_per_gpu`
frames per node (the JAX loader's batch per host, split over that host's
devices), so each of the node's ranks loads `samples_per_gpu /
LOCAL_WORLD_SIZE` frames, and the global batch is `samples_per_gpu`
times the number of nodes. Its rows in rank order are the JAX package's:
the nodes stripe the epoch as the JAX loader stripes its hosts, and a
node's ranks take contiguous blocks of the node's batch, as the JAX mesh
splits a host's batch over its devices (rank r of a node of n ranks, in
torchrun's layout, where node k holds ranks [k n, (k + 1) n)).
"""

import itertools

import torch
import torch.distributed as tdist

from . import dist


@torch.no_grad()
def replicate(model):
    """Broadcast `model`'s parameters and buffers from rank 0, in place, so
    that every rank holds one state; returns the model (unchanged without
    a group)."""
    if dist.is_initialized():
        for t in itertools.chain(model.parameters(), model.buffers()):
            tdist.broadcast(t, 0)
    return model


def rank_batch_size(samples_per_gpu):
    """The frames a rank loads per step: `samples_per_gpu` split over the
    ranks of its node; a split that leaves a remainder raises, as a JAX
    mesh that does not divide the batch does."""
    ranks = dist.local_process_count()
    if samples_per_gpu % ranks:
        raise ValueError(f"samples_per_gpu={samples_per_gpu} does not "
                         f"split over the node's {ranks} ranks")
    return samples_per_gpu // ranks


def train_shards():
    """The training loader's sharding of this rank (`DataLoader`'s
    `num_shards`, `shard_index`, `block`): the node's stripe of the epoch,
    and the rank's block of each of the node's batches."""
    n = dist.local_process_count()
    r = dist.rank()
    return dict(num_shards=dist.process_count() // n, shard_index=r // n,
                block=(r % n, n))


def rank_slice(n_global):
    """This rank's rows of a global batch of `n_global` rows (every rank
    the same count, in rank order; all of them unless the group splits
    the batch)."""
    ranks = dist.batch_process_count()
    if n_global % ranks:
        raise ValueError(f"{n_global} rows do not split over {ranks} ranks")
    n, r = n_global // ranks, dist.rank() if ranks > 1 else 0
    return slice(r * n, (r + 1) * n)


def rank_rows(draw, rows, *shape):
    """`draw(size)` made for the global batch, size (rows x ranks, *shape),
    and this rank's `rows` of it: a generator that every rank holds alike
    gives each rank the rows that one process drawing for the whole batch
    gives them (without a group, or under a grid split:
    `draw((rows, *shape))`)."""
    n = dist.batch_process_count()
    if n == 1:
        return draw((rows, *shape))
    return draw((rows * n, *shape))[rank_slice(rows * n)]
