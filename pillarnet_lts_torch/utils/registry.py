"""String-keyed registries (the port's copy of the JAX package's
`utils/registry.py`).

A component registers under its class name; a config dict's ``type`` key
selects it, so the repo's `configs/*.py` build the port unchanged.
"""


class Registry:
    def __init__(self, name):
        self.name = name
        self.module_dict = {}

    def get(self, key):
        return self.module_dict.get(key)

    def register_module(self, cls):
        if cls.__name__ in self.module_dict:
            raise KeyError(f"{cls.__name__} already registered in {self.name}")
        self.module_dict[cls.__name__] = cls
        return cls


def build_from_cfg(cfg, registry, default_args=None):
    """``registry[cfg['type']](**rest_of_cfg, **default_args)``; keys of
    `cfg` win over `default_args`."""
    args = dict(cfg)
    name = args.pop("type")
    cls = registry.get(name)
    if cls is None:
        raise KeyError(f"{name} is not in the {registry.name} registry")
    for k, v in (default_args or {}).items():
        args.setdefault(k, v)
    return cls(**args)
