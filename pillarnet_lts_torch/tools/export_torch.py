"""Export a port checkpoint to a reference-format torch .pth (the JAX
package's `tools/export_torch.py`).

    python -m pillarnet_lts_torch.tools.export_torch --checkpoint P
        --out model.pth [--spconv-layout KRSC|RSCK] [--config CONFIG]

The inverse of `tools/convert_torch.py`: writes `{'state_dict', 'meta'}`
in the reference's module naming and weight layouts
(`runtime/torch_convert.py::export_state_dict` of the model's weights in
flax layout, `runtime/convert.py::variables_of`), loadable by the
reference's `load_checkpoint` (`det3d/torchie/trainer/checkpoint.py`) for
cross-validation of trained models in the original framework. P is a
checkpoint of the port's trainer or of `tools/convert_torch.py`; the model
is built from the config text the checkpoint carries (`meta['config']`),
or from `--config` when it carries none. spconv weights go out in
`--spconv-layout` (KRSC = spconv 2.x, the reference's import).
"""

import argparse
import logging
import os
import tempfile

import torch

from ..apis import build_model_from_cfg, load_config
from ..runtime.checkpoint import is_port_checkpoint
from ..runtime.convert import variables_of
from ..runtime.torch_convert import export_state_dict
from .dist_test import load_weights


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Export a reference .pth")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out", required=True, help="output .pth path")
    parser.add_argument("--spconv-layout", default="KRSC",
                        choices=("KRSC", "RSCK"))
    parser.add_argument("--config", default=None,
                        help="the checkpoint's config, where its meta "
                             "carries none")
    return parser.parse_args(argv)


def checkpoint_config(blob, path):
    """The config of a port checkpoint: `path` if given, else the config
    text of its meta, read as a config file."""
    if path is not None:
        return load_config(path)
    text = blob["meta"].get("config")
    if not text:
        raise ValueError("the checkpoint carries no config text: pass "
                         "--config")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config.py")
        with open(path, "w") as f:
            f.write(text)
        return load_config(path)


def main(argv=None):
    """Run the CLI; returns the exported state_dict (numpy leaves)."""
    args = parse_args(argv)
    blob = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    if not is_port_checkpoint(blob):
        raise ValueError(f"{args.checkpoint} is not a port checkpoint")
    model = build_model_from_cfg(checkpoint_config(blob, args.config),
                                 device="cpu")
    load_weights(model, args.checkpoint, logging.getLogger("export_torch"))
    sd = export_state_dict(variables_of(model),
                           spconv_layout=args.spconv_layout)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "meta": {"exported_from": os.path.abspath(args.checkpoint)}},
               args.out)
    print(f"exported {len(sd)} tensors to {args.out}")
    return sd


if __name__ == "__main__":
    main()
