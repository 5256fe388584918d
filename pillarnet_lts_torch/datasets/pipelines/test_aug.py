"""Double-flip test-time augmentation (the JAX package's
`pipelines/test_aug.py`): three flipped copies of the cloud beside it."""

from ..registry import PIPELINES


@PIPELINES.register_module
class DoubleFlip:
    def __init__(self, **kwargs):
        pass

    def __call__(self, res, info):
        points = res["lidar"]["points"].copy()
        points[:, 1] = -points[:, 1]
        res["lidar"]["yflip_points"] = points

        points = res["lidar"]["points"].copy()
        points[:, 0] = -points[:, 0]
        res["lidar"]["xflip_points"] = points

        points = res["lidar"]["points"].copy()
        points[:, 0] = -points[:, 0]
        points[:, 1] = -points[:, 1]
        res["lidar"]["double_flip_points"] = points
        return res, info
