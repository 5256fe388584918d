"""The system under test, `pillarnet_lts_torch`: the only module of the
benchmark that imports it. It builds the detector of a configuration over
the benchmark's weights and returns the serving entry that the timed
window drives (`eval_utils.make_infer_fn`, `runtime.serving`)."""

import copy

import torch


def build(config, weights, device, calib=None):
    """The detector of `config` (a benchmark configuration dict) on
    `device` with `weights` (a state dict the benchmark made), in eval
    mode; an int8 configuration is calibrated on `calib` ((points, mask)
    pairs on the device) by the system's own calibration. -> (model,
    infer)."""
    from pillarnet_lts_torch.eval_utils import make_infer_fn
    from pillarnet_lts_torch.models import build_detector

    model = build_detector(copy.deepcopy(config["model"]),
                           test_cfg=copy.deepcopy(config["test_cfg"]),
                           device=device)
    missing, unexpected = model.load_state_dict(weights, strict=False)
    # the int8 scales are the only tensors the benchmark does not make
    missing = [k for k in missing if not k.endswith("absmax")]
    if missing or unexpected:
        raise ValueError(f"weights do not fit the system's detector: "
                         f"missing {missing[:5]}, unexpected "
                         f"{unexpected[:5]}")
    model.eval()
    if calib is not None:
        from pillarnet_lts_torch.runtime.quantize import calibrate

        calibrate(model, calib)
    return model, make_infer_fn(model)


def pipeline(infer, depth):
    """The system's bounded-depth serving pipeline over `infer`."""
    from pillarnet_lts_torch.runtime.serving import ServingPipeline

    return ServingPipeline(infer, depth=depth)


def to_host(det):
    """The system's copy of a detection dict to the host (it waits for the
    work that produced it)."""
    from pillarnet_lts_torch.runtime.serving import to_host as _to_host

    return _to_host(det)


def layers(model):
    """(span name, first module, last module) of each layer the spans
    time, in execution order; `predict` is timed around the method."""
    return [("reader", model.reader_net, model.reader_net),
            ("backbone", model.backbone_net, model.backbone_net),
            ("neck_head", model.neck_net, model.head_net)]


def set_tf32(on):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def train_targets(config, scenes, max_points):
    """The system's own training pipeline (no augmentation) over the
    benchmark's scenes [(points, boxes, names)]: its collated numpy batch
    (points, mask, per-task targets)."""
    from pillarnet_lts_torch.datasets import collate_batch
    from pillarnet_lts_torch.datasets.pipelines import (AssignLabel,
                                                        Preprocess,
                                                        Reformat)

    stages = [Preprocess(dict(mode="train", shuffle_points=False,
                              no_augmentation=True,
                              class_names=config["class_names"])),
              AssignLabel(config["train_cfg"]["assigner"]), Reformat()]
    examples = []
    for i, (points, boxes, names) in enumerate(scenes):
        res = {"type": "DemoDataset", "mode": "train",
               "metadata": {"token": f"scene_{i}"},
               "lidar": {"combined": points,
                         "annotations": {"boxes": boxes, "names": names}}}
        info = None
        for stage in stages:
            res, info = stage(res, info)
        examples.append(res)
    return collate_batch(examples, max_points)


def build_train(config, weights, device, total_steps):
    """The detector in training mode with the configuration's optimizer
    over `total_steps` steps. -> (model, optimizer, step), step(batch,
    generator) one training step of the system on a device batch."""
    from pillarnet_lts_torch.apis import optimizer_from_cfg
    from pillarnet_lts_torch.models import build_detector
    from pillarnet_lts_torch.runtime.train_step import train_step

    model = build_detector(copy.deepcopy(config["model"]),
                           train_cfg=copy.deepcopy(config["train_cfg"]),
                           test_cfg=copy.deepcopy(config["test_cfg"]),
                           device=device)
    model.load_state_dict(weights)
    model.train()
    opt = optimizer_from_cfg(model, config, total_steps)

    def step(batch, generator=None):
        return train_step(model, opt, batch, config["train_cfg"], generator)

    return model, opt, step
