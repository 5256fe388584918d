from .pillar_rcnn import PillarRCNN
from .pillarnet import PillarNet

__all__ = ["PillarNet", "PillarRCNN"]
