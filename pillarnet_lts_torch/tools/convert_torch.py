"""Convert a reference PyTorch checkpoint to a port checkpoint (the JAX
package's `tools/convert_torch.py`).

    python -m pillarnet_lts_torch.tools.convert_torch CONFIG
        --ckpt ref_model.pth --out model.pth
        [--spconv-layout KRSC|RSCK] [--non-strict]

CONFIG is the config of the model the reference checkpoint was trained
with (e.g. `configs/pillarnet/pillarnet34_nusc.py` for the reference's
released nuScenes PillarNet-34). The reference state_dict is mapped onto
the model's weights in flax layout (`runtime/torch_convert.py::
convert_state_dict` over `runtime/convert.py::variables_of`) and loaded
into the model; the output is a checkpoint in the port trainer's format
(`{'model', 'meta'}`, no optimizer state), which takes
`tools/dist_test.py --checkpoint`, `tools/export_serving.py --checkpoint`
and a config's `pretrained=`. `--spconv-layout` is the fallback spconv
weight layout (2.x = KRSC), auto-detected where shapes allow;
`--non-strict` leaves the leaves the checkpoint lacks at the seed-0
weights.
"""

import argparse
import os

import torch

from ..apis import build_model_from_cfg, load_config
from ..runtime.convert import load_jax_variables, variables_of
from ..runtime.torch_convert import convert_state_dict, load_torch_state_dict


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Convert a reference .pth")
    parser.add_argument("config")
    parser.add_argument("--ckpt", required=True, help="torch .pth checkpoint")
    parser.add_argument("--out", required=True, help="output .pth path")
    parser.add_argument("--spconv-layout", default="KRSC",
                        choices=("KRSC", "RSCK"),
                        help="fallback spconv weight layout (2.x = KRSC); "
                             "auto-detected when shapes allow")
    parser.add_argument("--non-strict", action="store_true",
                        help="allow missing sources (left at init values)")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns the conversion report."""
    args = parse_args(argv)
    cfg = load_config(args.config)
    model = build_model_from_cfg(cfg, device="cpu")
    variables, report = convert_state_dict(
        load_torch_state_dict(args.ckpt), variables_of(model),
        strict=not args.non_strict, spconv_layout=args.spconv_layout)
    load_jax_variables(model, variables)
    print(f"converted {len(report['converted'])} leaves "
          f"({len(report['missing'])} missing, "
          f"{len(report['unmapped'])} unmapped, "
          f"{len(report['unused'])} unused torch keys)")
    for k in report["unused"][:10]:
        print(f"  unused: {k}")
    with open(args.config) as f:
        cfg_text = f.read()
    torch.save({"model": model.state_dict(), "meta": {
        "format": "converted", "source": os.path.abspath(args.ckpt),
        "config": cfg_text, "converted": len(report["converted"]),
        "missing": len(report["missing"]),
        "unused": len(report["unused"])}}, args.out)
    print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
