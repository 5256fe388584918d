"""Bundle pipeline outputs into the example dict (the JAX package's
`pipelines/formating.py::Reformat`)."""

from ..registry import PIPELINES


@PIPELINES.register_module
class Reformat:
    """metadata, points and (train mode) the targets; in val mode with
    `double_flip`, a group of 4 examples: the cloud, its y-flip, its
    x-flip and its xy-flip (`DoubleFlip`), which `collate_batch`
    flattens."""

    def __init__(self, double_flip=False, **kwargs):
        self.double_flip = double_flip

    def __call__(self, res, info):
        meta = res["metadata"]
        bundle = dict(metadata=meta)
        if res["lidar"]["points"] is not None:
            bundle.update(points=res["lidar"]["points"])
        if res["mode"] == "train":
            bundle.update(res["lidar"]["targets"])
        elif res["mode"] == "val" and self.double_flip:
            lidar = res["lidar"]
            return [bundle,
                    dict(metadata=meta, points=lidar["yflip_points"]),
                    dict(metadata=meta, points=lidar["xflip_points"]),
                    dict(metadata=meta, points=lidar["double_flip_points"]),
                    ], info
        return bundle, info
