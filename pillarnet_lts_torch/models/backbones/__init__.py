from .pillar_resnet import (
    PillarResNet18,
    PillarResNet18S,
    PillarResNet34,
    PillarResNet34S,
)

__all__ = ["PillarResNet18", "PillarResNet18S", "PillarResNet34",
           "PillarResNet34S"]
