from ..registry import PIPELINES


@PIPELINES.register_module
class Empty:
    """No-op stage (what a config puts where a stage is switched off)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, res, info):
        return res, info
