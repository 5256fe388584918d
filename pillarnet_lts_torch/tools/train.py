"""Training CLI of the port (the JAX package's `tools/train.py`).

    python -m pillarnet_lts_torch.tools.train CONFIG [--work_dir D]
        [--resume_from CKPT] [--seed N] [--device cuda|cpu] [--validate]
    torchrun --nproc_per_node N -m pillarnet_lts_torch.tools.train CONFIG ...

The config's model (weights drawn from `--seed`, then its `pretrained`
ones) trains on its `data.train` set through `apis.train_detector`: the
train pipeline as written (augmentations, GT-AUG), the threaded loader,
the config's optimizer and schedule, a checkpoint every
`checkpoint_config.interval` epochs. The work dir (default the config's
`work_dir`) gets the config's text as `config.py`, `train.log`,
`log.json`, `epoch_{n}.pth` and `latest`. `--seed` seeds the weights,
the loader (shuffle and each sample's draws), the GT-AUG sampler and
each step's generator. It runs on the CUDA card unless `--device cpu` is
given; without a card it raises. `--validate` evaluates the config's
`data.val` set after every epoch (`Trainer.run`'s [('train', 1),
('val', 1)]).

Under `torchrun` the ranks train one model data-parallel
(`parallel/dist.py`: NCCL on the card `cuda:LOCAL_RANK`, gloo with
`--device cpu`): a step takes `samples_per_gpu` frames per node, split
over the node's ranks. Rank 0 writes the work dir's files; a failed start
of the group raises.
"""

import argparse
import logging
import os

import torch

from ..apis import build_model_from_cfg, load_config, train_detector
from ..parallel.spatial import refuse
from ..datasets import build_dataset
from ..parallel.dist import init_from_env, process_count, rank, shutdown


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a detector")
    parser.add_argument("config")
    parser.add_argument("--work_dir", default=None,
                        help="logs and checkpoints (default: the config's)")
    parser.add_argument("--resume_from", default=None,
                        help="a checkpoint of this trainer")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--validate", action="store_true",
                        help="evaluate data.val after every epoch")
    return parser.parse_args(argv)


def seed_config(cfg, seed):
    """Set `seed` as every GT-AUG sampler's in the train pipeline
    (`db_sampler.seed`, a key of the port's): the samplers are built with
    the dataset, before `train_detector` takes the seed."""
    for step in cfg["data"]["train"].get("pipeline") or []:
        sampler = (step.get("cfg") or {}).get("db_sampler")
        if step["type"] == "Preprocess" and sampler is not None:
            sampler["seed"] = seed


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass --device cpu to "
                           "train on the CPU")
    device = init_from_env(args.device)
    try:
        return _train(args, device)
    finally:
        shutdown()


def _train(args, device):
    cfg = load_config(args.config)
    refuse(cfg["model"], "tools.train")
    work_dir = args.work_dir or cfg["work_dir"]
    os.makedirs(work_dir, exist_ok=True)
    with open(args.config) as f:
        cfg_text = f.read()
    handlers = [logging.StreamHandler()]
    if rank() == 0:  # rank 0 writes the work dir's files
        handlers.append(
            logging.FileHandler(os.path.join(work_dir, "train.log")))
        with open(os.path.join(work_dir, "config.py"), "w") as f:
            f.write(cfg_text)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=handlers, force=True)
    logger = logging.getLogger("train")
    logger.info("Set random seed to %d", args.seed)
    if process_count() > 1:
        logger.info("rank %d of %d on %s", rank(), process_count(), device)

    model = build_model_from_cfg(cfg, device=device, seed=args.seed)
    logger.info("model parameters: %.2fM",
                sum(p.numel() for p in model.parameters()) / 1e6)
    seed_config(cfg, args.seed)
    dataset = build_dataset(cfg["data"]["train"])
    logger.info("dataset: %d frames", len(dataset))
    val_dataset = (build_dataset(cfg["data"]["val"]) if args.validate
                   else None)
    return train_detector(model, dataset, cfg, logger=logger,
                          resume_from=args.resume_from, cfg_text=cfg_text,
                          work_dir=work_dir, seed=args.seed,
                          val_dataset=val_dataset)


if __name__ == "__main__":
    main()
