from .legacy import TwoStageDetector, VoxelNet, box_center_points
from .pillar_rcnn import PillarRCNN
from .pillarnet import PillarNet

__all__ = ["PillarNet", "PillarRCNN", "TwoStageDetector", "VoxelNet",
           "box_center_points"]
