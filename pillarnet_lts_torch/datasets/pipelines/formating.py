"""Bundle pipeline outputs into the example dict.

The port's copy of `pillarnet_lts_tpu/datasets/pipelines/formating.py::
Reformat` without double-flip TTA (not ported).
"""


class Reformat:
    def __call__(self, res, info):
        bundle = dict(metadata=res["metadata"])
        if res["lidar"]["points"] is not None:
            bundle.update(points=res["lidar"]["points"])
        if res["mode"] == "train":
            bundle.update(res["lidar"]["targets"])
        return bundle, info
