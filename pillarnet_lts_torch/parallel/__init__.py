"""Data-parallel training and sharded evaluation over `torch.distributed`
(the counterpart of `pillarnet_lts_tpu/parallel/`).

- `dist`: the process group from torchrun's environment and the
  collectives (`parallel/dist.py` there);
- `mesh`: one state on every rank and each rank's rows of the global
  batch (`make_mesh` / `shard_batch` / `replicate` there);
- `spatial`: the BEV grid's rows split over the group, with halo
  exchanges and the gather (`spatial.py` there, and the detector's
  `spatial_axis`).

The rest of the JAX package's `parallel/` has its counterpart elsewhere:
`train_step.py` in `runtime/train_step.py`, `train_state.py` in the
module + optimizer pair, `collate.py` in `datasets/collate.py`.
"""
