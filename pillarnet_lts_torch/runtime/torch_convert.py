"""Convert reference PyTorch checkpoints (det3d `.pth`) to the flax-layout
variables tree that `runtime/convert.py::load_jax_variables` loads.

The port's copy of `pillarnet_lts_tpu/runtime/torch_convert.py` (numpy
only), with its inverse `export_state_dict` (flax-layout variables -> a
reference state_dict; `tools/export_torch.py`). The reference
releases trained weights as torch ``.pth`` state_dicts (saved by
``det3d/torchie/trainer/checkpoint.py:save_checkpoint``). This module maps
them onto the flax variables layout (``{'params': ..., 'batch_stats':
...}``), whose module paths the port's modules mirror, with exact
numerics; `load_reference_checkpoint` takes the target template from a
port model (`convert.variables_of`) and fills the model, so no JAX
hop is needed:

  torch module (state_dict key)                 ours (variables path)
  -------------------------------------------   ------------------------------
  reader.pfn_layers.shared_mlps.{3k}  Linear    reader_net/pfn_dense_{k}
  reader.pfn_layers.shared_mlps.{3k+1} BN1d     reader_net/pfn_bn_{k}
  backbone.conv1.{b}.conv{j}.{0,1}              backbone_net/conv1_block{b}/(conv{j},bn{j})
  backbone.conv{s}.0 / .1 (SparseConv2d + BN)   backbone_net/conv{s}/(down_conv,down_bn)
  backbone.conv{s}.{b+3}.conv{j}.{0,1}          backbone_net/conv{s}/block{b}/(conv{j},bn{j})
  backbone.conv5.0/.1, .{b+3}.0/.1 (dense)      backbone_net/conv5_down, conv5_block{b}
  neck.<name>.{1+3j}/{2+3j} (block convs)       neck_net/<name>/conv{j}/(Conv_0,MaskedBatchNorm_0)
  neck.<name>.0/.1 (deblock / reduce)           neck_net/<name>/(ConvTranspose_0|Conv_0, MaskedBatchNorm_0)
  bbox_head.share_convs.{k}.{0,1}               head_net/(share_conv{k},share_bn{k})
  bbox_head.task_heads.{k}.<h>.{3i,3i+1},last   head_net/task{k}/(<h>_conv{i},<h>_bn{i},<h>_out)

Sources for the torch-side naming: ``det3d/models/backbones/base.py:145-215``
(Sparse2DBasicBlock[V]), ``PillarResNet.py:14-60,100-117`` (stage layout and
the dense conv5), ``det3d/ops/pillar_ops/pillar_modules.py:22-33`` (reader
MLP), ``det3d/models/necks/rpn.py`` (RPN/RPNV1/RPNV2/RPNG/RPNGV2 — our neck
submodule names deliberately mirror the reference attribute names), and
``det3d/models/bbox_heads/center_head.py:14-112`` (SepHead/CenterHead).

Weight-layout transforms (torch -> flax):

  nn.Linear          (O, I)          -> (I, O)
  nn.Conv2d          (O, I, kh, kw)  -> (kh, kw, I, O)
  nn.ConvTranspose2d (I, O, kh, kw)  -> (kh, kw, I, O), spatially flipped
      [flax ConvTranspose correlates the zero-dilated input with an
      unflipped kernel; torch's conv_transpose places weights mirrored
      relative to that — pinned bitwise by tests/test_torch_convert.py]
  spconv SubM/SparseConv2d: layout differs by spconv major version —
      KRSC (O, kh, kw, I) in spconv 2.x (what the reference imports),
      RSCK (kh, kw, I, O) in 1.x.  Auto-detected per checkpoint from any
      conv whose in/out widths differ; defaults to KRSC.

All mapping is generated from the *target* tree, so it adapts to every
backbone/neck/head variant in ``configs/`` without per-config tables.
"""

import re

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "convert_state_dict",
    "export_state_dict",
    "load_reference_checkpoint",
    "load_torch_state_dict",
    "normalize_state_dict",
]


# ---------------------------------------------------------------------------
# source state_dict handling
# ---------------------------------------------------------------------------


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a torch ``.pth`` checkpoint into a flat {key: numpy} dict.

    Handles the reference's on-disk shapes: a bare state_dict, a dict with a
    ``state_dict`` entry (``det3d`` save format), and DDP ``module.``
    prefixes.
    """
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return normalize_state_dict(blob)


def normalize_state_dict(blob: Any) -> Dict[str, np.ndarray]:
    """Strip save-format wrappers and convert values to numpy (fp32)."""
    if isinstance(blob, dict) and "state_dict" in blob and isinstance(
        blob["state_dict"], dict
    ):
        blob = blob["state_dict"]
    out = {}
    for k, v in blob.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if hasattr(v, "detach"):  # torch tensor
            v = v.detach().cpu().numpy()
        v = np.asarray(v)
        if v.dtype == np.float16 or str(v.dtype) == "bfloat16":
            v = v.astype(np.float32)
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# layout transforms
# ---------------------------------------------------------------------------


def _t_linear(w):
    return np.transpose(w, (1, 0))


def _t_conv(w):  # torch OIHW -> flax HWIO
    return np.transpose(w, (2, 3, 1, 0))


def _t_convT(w):
    """torch ConvTranspose2d (I, O, kh, kw) -> flax ConvTranspose (kh, kw, I, O).

    flax's ConvTranspose (transpose_kernel=False) runs an unflipped
    correlation over the zero-dilated input, while torch's conv_transpose2d
    places ``w[:, :, i, j]`` at output offset (i, j) — mirrored relative to
    correlation.  The spatial flip makes them bitwise identical (pinned by
    tests/test_torch_convert.py::test_convtranspose_numeric_pin).
    """
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1])


class _SpconvLayout:
    """Per-checkpoint spconv weight layout, auto-detected lazily."""

    def __init__(self, default: str = "KRSC"):
        assert default in ("KRSC", "RSCK")
        self.layout: Optional[str] = None
        self.default = default

    def observe(self, src_shape: Tuple[int, ...], dst_shape: Tuple[int, ...]):
        """Learn the layout from a weight whose in/out widths differ."""
        if self.layout is not None:
            return
        kh, kw, ci, co = dst_shape
        if ci == co:
            return
        if tuple(src_shape) == (co, kh, kw, ci):
            self.layout = "KRSC"
        elif tuple(src_shape) == (kh, kw, ci, co):
            self.layout = "RSCK"

    def transform(self, w, dst_shape):
        self.observe(w.shape, dst_shape)
        layout = self.layout or self.default
        if layout == "KRSC":
            return np.transpose(w, (1, 2, 3, 0))
        return w


# ---------------------------------------------------------------------------
# rule generation (driven by the target tree)
# ---------------------------------------------------------------------------

_BN_MAP = {
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}

# transform tags; resolved in _apply (spconv needs per-checkpoint state)
_LINEAR, _CONV, _CONVT, _SPCONV, _IDENT, _CONV1D = (
    "linear", "conv", "convT", "spconv", "ident", "conv1d",
)


def _bn_rules(our: Tuple[str, ...], src: str, rules):
    """BN leaves live under both params (scale/bias) and batch_stats."""
    for leaf, tname in _BN_MAP.items():
        rules.append((our + (leaf,), f"{src}.{tname}", _IDENT))


def _conv_rules(our, src, rules, kind, bias_leaf="bias"):
    rules.append((our + ("kernel",), f"{src}.weight", kind))
    # bias presence is decided later by whether the target leaf exists
    rules.append((our + (bias_leaf,), f"{src}.bias", _IDENT))


def _reader_rules(tree: Dict, rules):
    for name in tree:
        if name.startswith("pfn_dense_"):
            k = int(name[len("pfn_dense_"):])
            rules.append(
                (("reader_net", name, "kernel"),
                 f"reader.pfn_layers.shared_mlps.{3 * k}.weight", _LINEAR)
            )
        elif name.startswith("pfn_bn_"):
            k = int(name[len("pfn_bn_"):])
            _bn_rules(("reader_net", name),
                      f"reader.pfn_layers.shared_mlps.{3 * k + 1}", rules)


def _res_block_rules(our_prefix, src_prefix, tree: Dict, rules):
    """Sparse2DBasicBlock[V]: conv{j} = SparseSequential(SubMConv2d, BN[, ReLU])."""
    for name in tree:
        if name.startswith("conv"):
            j = name[len("conv"):]
            _conv_rules(our_prefix + (name,), f"{src_prefix}.conv{j}.0",
                        rules, _SPCONV)
        elif name.startswith("bn"):
            j = name[len("bn"):]
            _bn_rules(our_prefix + (name,), f"{src_prefix}.conv{j}.1", rules)


def _backbone_rules(tree: Dict, rules):
    for name, sub in tree.items():
        if name.startswith("conv1_block"):
            b = int(name[len("conv1_block"):])
            _res_block_rules(("backbone_net", name),
                             f"backbone.conv1.{b}", sub, rules)
        elif name == "conv5_down":
            # dense nn.Conv2d stride 2 (PillarResNet.py:110-113)
            _conv_rules(("backbone_net", name, "conv"),
                        "backbone.conv5.0", rules, _CONV)
            _bn_rules(("backbone_net", name, "bn"), "backbone.conv5.1", rules)
        elif name.startswith("conv5_block"):
            b = int(name[len("conv5_block"):])
            _conv_rules(("backbone_net", name, "conv"),
                        f"backbone.conv5.{b + 3}.0", rules, _CONV)
            _bn_rules(("backbone_net", name, "bn"),
                      f"backbone.conv5.{b + 3}.1", rules)
        elif name.startswith("conv") and isinstance(sub, dict):
            s = name[len("conv"):]
            for child, csub in sub.items():
                if child == "down_conv":
                    rules.append(
                        (("backbone_net", name, child, "kernel"),
                         f"backbone.conv{s}.0.weight", _SPCONV)
                    )
                elif child == "down_bn":
                    _bn_rules(("backbone_net", name, child),
                              f"backbone.conv{s}.1", rules)
                elif child.startswith("block"):
                    b = int(child[len("block"):])
                    # SparseSequential(down, BN, ReLU, block0, block1, ...)
                    _res_block_rules(("backbone_net", name, child),
                                     f"backbone.conv{s}.{b + 3}", csub, rules)


def _fix_conv_rules(our_prefix, src_prefix, rules):
    """our _ConvBNReLU {Conv_0, MaskedBatchNorm_0} <- Sequential(Conv, BN, ReLU)."""
    rules.append((our_prefix + ("Conv_0", "kernel"),
                  f"{src_prefix}.0.weight", _CONV))
    _bn_rules(our_prefix + ("MaskedBatchNorm_0",), f"{src_prefix}.1", rules)


def _neck_rules(tree: Dict, rules):
    for name, sub in tree.items():
        if not isinstance(sub, dict):
            continue
        if "ConvTranspose_0" in sub:
            # deblock: Sequential(ConvTranspose2d, BN, ReLU) (rpn.py:150-154)
            rules.append((("neck_net", name, "ConvTranspose_0", "kernel"),
                          f"neck.{name}.0.weight", _CONVT))
            _bn_rules(("neck_net", name, "MaskedBatchNorm_0"),
                      f"neck.{name}.1", rules)
        elif "Conv_0" in sub:
            # reduce block: Sequential(Conv2d, BN, ReLU) (rpn.py:376-397)
            _fix_conv_rules(("neck_net", name), f"neck.{name}", rules)
        elif any(k.startswith("conv") for k in sub):
            # block: Sequential(ZeroPad2d, Conv, BN, ReLU, [Conv, BN, ReLU]*)
            for child in sub:
                if not child.startswith("conv"):
                    continue
                j = int(child[len("conv"):])
                rules.append(
                    (("neck_net", name, child, "Conv_0", "kernel"),
                     f"neck.{name}.{1 + 3 * j}.weight", _CONV)
                )
                _bn_rules(("neck_net", name, child, "MaskedBatchNorm_0"),
                          f"neck.{name}.{2 + 3 * j}", rules)


def _generic_rpn_rules(tree: Dict, rules):
    """Legacy flat RPN (`rpn.py:15-133`): blocks./deblocks. ModuleLists.
    A stage's units after its entry conv (`block{i}_conv{j}`, j >= 1, our
    `_ConvBNReLU` {Conv_0, MaskedBatchNorm_0}) sit in the same Sequential
    at 1 + 3j / 2 + 3j; the JAX package's converter maps only the entry
    conv's flat kernel there and leaves the units out."""
    for name in tree:
        if name.startswith("block") and "_conv" in name \
                and isinstance(tree[name], dict) and "Conv_0" in tree[name]:
            i, j = name[len("block"):].split("_conv")
            rules.append((("neck_net", name, "Conv_0", "kernel"),
                          f"neck.blocks.{i}.{1 + 3 * int(j)}.weight", _CONV))
            _bn_rules(("neck_net", name, "MaskedBatchNorm_0"),
                      f"neck.blocks.{i}.{2 + 3 * int(j)}", rules)
        elif name.startswith("block") and "_conv" in name:
            i, j = name[len("block"):].split("_conv")
            rules.append(
                (("neck_net", name, "kernel"),
                 f"neck.blocks.{i}.{1 + 3 * int(j)}.weight", _CONV)
            )
        elif name.startswith("block") and "_bn" in name:
            i, j = name[len("block"):].split("_bn")
            _bn_rules(("neck_net", name),
                      f"neck.blocks.{i}.{2 + 3 * int(j)}", rules)
        elif name.startswith("deblock") and name.endswith("_bn"):
            k = name[len("deblock"):-len("_bn")]
            _bn_rules(("neck_net", name), f"neck.deblocks.{k}.1", rules)
        elif name.startswith("deblock"):
            k = name[len("deblock"):]
            # ConvTranspose2d for upsampling strides > 1, Conv2d otherwise
            # (rpn.py:61-91); disambiguated by shape at apply time.
            rules.append((("neck_net", name, "kernel"),
                          f"neck.deblocks.{k}.0.weight", _CONVT))


def _head_rules(tree: Dict, rules):
    for name, sub in tree.items():
        if name.startswith("share_conv"):
            k = name[len("share_conv"):]
            _conv_rules(("head_net", name), f"bbox_head.share_convs.{k}.0",
                        rules, _CONV)
        elif name.startswith("share_bn"):
            k = name[len("share_bn"):]
            _bn_rules(("head_net", name), f"bbox_head.share_convs.{k}.1",
                      rules)
        elif name.startswith("task") and isinstance(sub, dict):
            k = int(name[len("task"):])
            # count hidden convs per branch to locate the final conv index
            branches: Dict[str, int] = {}
            for child in sub:
                if child.endswith("_out"):
                    branches.setdefault(child[:-len("_out")], 0)
                else:
                    base, _, idx = child.rpartition("_conv")
                    if base and idx.isdigit():
                        branches[base] = max(
                            branches.get(base, 0), int(idx) + 1)
            for child in sub:
                src_head = f"bbox_head.task_heads.{k}"
                if child.endswith("_out"):
                    h = child[:-len("_out")]
                    last = 3 * branches[h]
                    _conv_rules(("head_net", name, child),
                                f"{src_head}.{h}.{last}", rules, _CONV)
                elif "_conv" in child:
                    h, _, i = child.rpartition("_conv")
                    _conv_rules(("head_net", name, child),
                                f"{src_head}.{h}.{3 * int(i)}", rules, _CONV)
                elif "_bn" in child:
                    h, _, i = child.rpartition("_bn")
                    _bn_rules(("head_net", name, child),
                              f"{src_head}.{h}.{3 * int(i) + 1}", rules)


def _fc_stack_rules(our_prefix, src_prefix, tree: Dict, rules, kind,
                    conv_idx, bn_idx, final_idx, leaf_prefix=""):
    """Map our {fc{k}, bn{k}, out} stack onto a torch Sequential whose
    layer indices are given by the conv_idx/bn_idx/final_idx callables
    (index schemes differ across roi/point heads because of interleaved
    Dropout modules)."""
    n = sum(1 for k in tree if re.match(rf"{leaf_prefix}fc\d+$", k))
    for name in tree:
        if not name.startswith(leaf_prefix):
            continue
        tail = name[len(leaf_prefix):]
        if re.match(r"fc\d+$", tail):
            k = int(tail[2:])
            rules.append((our_prefix + (name, "kernel"),
                          _cands(src_prefix, conv_idx(k), "weight"), kind))
        elif re.match(r"bn\d+$", tail):
            k = int(tail[2:])
            for leaf, tname in _BN_MAP.items():
                rules.append((our_prefix + (name, leaf),
                              _cands(src_prefix, bn_idx(k), tname), _IDENT))
        elif tail == "out":
            rules.append((our_prefix + (name, "kernel"),
                          _cands(src_prefix, final_idx(n), "weight"), kind))
            rules.append((our_prefix + (name, "bias"),
                          _cands(src_prefix, final_idx(n), "bias"), _IDENT))


def _cands(prefix, idxs, leaf):
    """One source key, or a tuple of candidates (first present wins)."""
    idxs = idxs if isinstance(idxs, (list, tuple)) else [idxs]
    keys = tuple(f"{prefix}.{i}.{leaf}" for i in idxs)
    return keys[0] if len(keys) == 1 else keys


def _roi_head_rules(tree: Dict, rules):
    """RoIHead (`det3d/models/roi_heads/roi_head.py:15-48`,
    `roi_head_template.py:23-39`): Conv1d(k=1) stacks with interleaved
    Dropout.  shared_fc has a dropout after every non-final layer when
    DP_RATIO > 0 (conv at 4k) and none otherwise (conv at 3k) — both index
    schemes are tried.  cls/reg always drop out after layer 0 only
    (`DP_RATIO >= 0`), so conv k is at 0 / 3k+1 and the final conv at
    3n+1."""
    if "shared_fc" in tree:
        _fc_stack_rules(
            ("roi_head_net", "shared_fc"), "roi_head.shared_fc_layer",
            tree["shared_fc"], rules, _CONV1D,
            conv_idx=lambda k: [4 * k, 3 * k],
            bn_idx=lambda k: [4 * k + 1, 3 * k + 1],
            final_idx=lambda n: [],  # shared_fc has no final projection
        )
    for branch, src in (("cls", "roi_head.cls_layers"),
                        ("reg", "roi_head.reg_layers")):
        if branch in tree:
            _fc_stack_rules(
                ("roi_head_net", branch), src, tree[branch], rules, _CONV1D,
                conv_idx=lambda k: 0 if k == 0 else 3 * k + 1,
                bn_idx=lambda k: 1 if k == 0 else 3 * k + 2,
                final_idx=lambda n: 3 * n + 1,
            )


def _point_head_rules(tree: Dict, rules):
    """PointHead (`point_head_simple.py:14-22`,
    `point_head_template.py:37-49`): Linear stacks, no dropout."""
    _fc_stack_rules(
        ("point_head_net",), "point_head.cls_layers", tree, rules, _LINEAR,
        conv_idx=lambda k: 3 * k,
        bn_idx=lambda k: 3 * k + 1,
        final_idx=lambda n: 3 * n,
        leaf_prefix="cls_",
    )


def _second_stage_rules(idx: int, tree: Dict, rules):
    """BEVFeature / BEVStrideFeature (`bev_interpolation.py:18-90,162-230`).

    Reference lat convs are indexed by feature_sources order; our tree names
    them lat_{src}.  Sources are assigned indices in ascending conv order
    (how every shipped config lists them).  Dense laterals are
    ConvTranspose2d (bias-free); the sparse downsample lateral is a
    SparseConv2d with bias — distinguished here by bias presence."""
    src_base = f"second_stage.{idx}"
    lat_srcs = sorted(
        k[len("lat_"):] for k in tree
        if re.match(r"lat_conv\d$", k)
    )
    for name in tree:
        our = (f"second_stage_{idx}", name)
        if name == "top_down_conv":
            rules.append((our + ("kernel",),
                          f"{src_base}.top_down_conv.0.weight", _CONVT))
        elif name == "top_down_bn":
            _bn_rules(our, f"{src_base}.top_down_conv.1", rules)
        elif re.match(r"lat_conv\d$", name):
            k = lat_srcs.index(name[len("lat_"):])
            is_sparse = isinstance(tree[name], dict) and "bias" in tree[name]
            kind = _SPCONV if is_sparse else _CONVT
            rules.append((our + ("kernel",),
                          f"{src_base}.lat_conv.{k}.0.weight", kind))
            if is_sparse:
                rules.append((our + ("bias",),
                              f"{src_base}.lat_conv.{k}.0.bias", _IDENT))
        elif re.match(r"lat_bn_conv\d$", name):
            k = lat_srcs.index(name[len("lat_bn_"):])
            _bn_rules(our, f"{src_base}.lat_conv.{k}.1", rules)
        elif name == "fusion_conv":
            _conv_rules(our, f"{src_base}.fusion_conv.0", rules, _CONV)
        elif name == "fusion_bn":
            _bn_rules(our, f"{src_base}.fusion_conv.1", rules)


def _detector_rules(merged: Dict):
    """Rules for one (single-stage) detector subtree."""
    rules: List[Tuple[Tuple[str, ...], Any, str]] = []
    for top, sub in merged.items():
        if top == "reader_net":
            _reader_rules(sub, rules)
        elif top == "backbone_net":
            _backbone_rules(sub, rules)
        elif top == "neck_net":
            # legacy flat RPN names: block{i}_conv{j} / deblock{k} (digits,
            # no underscore) vs the V1/V2/G necks' block_5 / deblock_4 / ...
            if any(
                re.match(r"block\d+_(conv|bn)\d+$|deblock\d+(_bn)?$", k)
                for k in sub
            ):
                _generic_rpn_rules(sub, rules)
            else:
                _neck_rules(sub, rules)
        elif top == "head_net":
            _head_rules(sub, rules)
        elif top == "roi_head_net":
            _roi_head_rules(sub, rules)
        elif top == "point_head_net":
            _point_head_rules(sub, rules)
        elif re.match(r"second_stage_\d+$", top):
            _second_stage_rules(int(top.rsplit("_", 1)[1]), sub, rules)
    return rules


def _build_rules(params: Dict, batch_stats: Dict):
    """Rules keyed by our path *within a collection-merged view*."""
    merged: Dict[str, Dict] = {}

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                merge(dst.setdefault(k, {}), v)
            else:
                dst[k] = v

    for col in (params, batch_stats):
        merge(merged, col or {})

    rules = _detector_rules(merged)
    if "single_det" in merged:
        # PillarRCNN nests a full first-stage detector under single_det
        # (`det3d/models/detectors/pillar_rcnn.py:18`)
        def _prefix_src(src):
            if isinstance(src, tuple):
                return tuple(f"single_det.{s}" for s in src)
            return f"single_det.{src}"

        rules += [
            (("single_det",) + path, _prefix_src(src), kind)
            for path, src, kind in _detector_rules(merged["single_det"])
        ]
    return rules, merged


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------


def _tree_get(tree, path):
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node


def _tree_set(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def convert_state_dict(state_dict, variables, strict: bool = True,
                       spconv_layout: str = "KRSC"):
    """Convert a reference torch state_dict into our variables tree.

    Args:
      state_dict: flat {torch key: array} (see ``normalize_state_dict``).
      variables: target template ``{'params':..., 'batch_stats':...}``
        (arrays or ShapeDtypeStructs — only shapes/dtypes are read).
      strict: if True, raise when any target leaf has no source key.
        Unused *source* keys are always reported, never fatal (the torch
        checkpoint carries num_batches_tracked and optimizer extras).
      spconv_layout: fallback spconv weight layout when the checkpoint has
        no shape-distinguishable spconv conv (KRSC = spconv 2.x).

    Returns:
      (new_variables, report) where report has ``converted`` /
      ``missing`` (our paths with no source) / ``unused`` (torch keys).
    """
    state_dict = normalize_state_dict(state_dict)
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    rules, _ = _build_rules(params, stats)
    layout = _SpconvLayout(spconv_layout)

    def _resolve(src_key):
        """First present candidate (rules may carry alternates for torch
        Sequential index schemes that depend on config, e.g. dropout)."""
        if isinstance(src_key, tuple):
            for k in src_key:
                if k in state_dict:
                    return k
            return src_key[0]
        return src_key

    # pre-pass: lock the spconv layout from any width-changing spconv conv
    for our_path, src_key, kind in rules:
        src_key = _resolve(src_key)
        if kind != _SPCONV or src_key not in state_dict:
            continue
        leaf = _tree_get(params, our_path)
        if leaf is not None:
            layout.observe(state_dict[src_key].shape, tuple(leaf.shape))

    new_params: Dict = {}
    new_stats: Dict = {}
    used, converted, missing = set(), [], []

    def _cast_like(val, leaf):
        dtype = getattr(leaf, "dtype", None)
        return val.astype(dtype) if dtype is not None else val

    for our_path, src_key, kind in rules:
        src_key = _resolve(src_key)
        leaf, col, dst = _tree_get(params, our_path), "params", new_params
        if leaf is None:
            leaf, col, dst = _tree_get(stats, our_path), "batch_stats", new_stats
        if leaf is None:
            continue  # rule for an optional leaf the target doesn't have
        if src_key not in state_dict:
            missing.append("/".join((col,) + our_path) + f" <- {src_key}")
            continue
        w = state_dict[src_key]
        if kind == _LINEAR:
            w = _t_linear(w)
        elif kind == _CONV1D:
            w = np.transpose(w[..., 0], (1, 0))  # (O, I, 1) -> (I, O)
        elif kind == _CONV:
            w = _t_conv(w)
        elif kind == _CONVT:
            kh, kw, ci, co = tuple(leaf.shape)
            if tuple(w.shape) == (ci, co, kh, kw):
                w = _t_convT(w)
            elif tuple(w.shape) == (co, ci, kh, kw):
                w = _t_conv(w)  # legacy RPN deblock with stride-1 Conv2d
            else:
                w = _t_convT(w)
        elif kind == _SPCONV:
            w = layout.transform(w, tuple(leaf.shape))
        if tuple(w.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch converting {src_key} -> "
                f"{'/'.join(our_path)}: got {w.shape}, want {tuple(leaf.shape)}"
            )
        _tree_set(dst, our_path, _cast_like(w, leaf))
        used.add(src_key)
        converted.append(src_key)

    # template leaves no rule even tried to fill (e.g. a second-stage head
    # the converter doesn't map) — distinct from `missing` (rule existed,
    # torch key absent)
    covered = {("params",) + p for p, _, _ in rules} | {
        ("batch_stats",) + p for p, _, _ in rules
    }
    unmapped = [
        "/".join(path)
        for col, tree in (("params", params), ("batch_stats", stats))
        for path in _leaf_paths(tree, (col,))
        if path not in covered
    ]

    if strict and (missing or unmapped):
        raise KeyError(
            f"conversion incomplete: {len(missing)} target leaves missing a "
            f"source key, {len(unmapped)} leaves unmapped by any rule, e.g.:\n  "
            + "\n  ".join((missing + unmapped)[:12])
        )

    unused = [
        k for k in state_dict
        if k not in used and not k.endswith("num_batches_tracked")
    ]
    # keep any extra collections / unmapped leaves from the template
    out = dict(variables)
    out["params"] = _merge_with_template(params, new_params)
    out["batch_stats"] = _merge_with_template(stats, new_stats)
    report = {
        "converted": converted,
        "missing": missing,
        "unmapped": unmapped,
        "unused": unused,
    }
    return out, report


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix


def export_state_dict(variables, spconv_layout: str = "KRSC"):
    """Inverse of :func:`convert_state_dict`: flax-layout variables (e.g.
    `convert.variables_of(model)`) -> a torch state_dict in the reference's
    naming and weight layouts, numpy leaves.

    Round-trip safe: ``convert_state_dict(export_state_dict(v), v)``
    reproduces every leaf bitwise.  spconv weights are emitted in the
    requested layout (KRSC = spconv 2.x, the reference's import; RSCK =
    1.x, our HWIO as it is).
    """
    if spconv_layout not in ("KRSC", "RSCK"):
        raise ValueError(f"unknown spconv layout {spconv_layout!r}")
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    rules, _ = _build_rules(params, stats)
    out: Dict[str, np.ndarray] = {}
    for our_path, src_key, kind in rules:
        leaf = _tree_get(params, our_path)
        if leaf is None:
            leaf = _tree_get(stats, our_path)
        if leaf is None:
            continue
        if isinstance(src_key, tuple):
            src_key = src_key[0]
        w = np.asarray(leaf, dtype=np.float32)
        if kind == _LINEAR:
            w = np.transpose(w, (1, 0))
        elif kind == _CONV1D:
            w = np.transpose(w, (1, 0))[:, :, None]
        elif kind == _CONV:
            w = np.transpose(w, (3, 2, 0, 1))
        elif kind == _CONVT:
            w = np.transpose(
                np.ascontiguousarray(w[::-1, ::-1]), (2, 3, 0, 1))
        elif kind == _SPCONV and spconv_layout == "KRSC":
            w = np.transpose(w, (3, 0, 1, 2))
        # a fresh C array: a flipped kernel with a 1-wide axis is "contiguous"
        # with negative strides, which torch.from_numpy refuses
        out[src_key] = np.array(w, order="C")
    return out


def _merge_with_template(template, converted):
    """Converted leaves win; untouched template leaves pass through."""
    if not isinstance(template, dict):
        return converted if converted is not None else template
    out = {}
    for k, v in template.items():
        c = converted.get(k) if isinstance(converted, dict) else None
        out[k] = _merge_with_template(v, c) if isinstance(v, dict) else (
            c if c is not None else v
        )
    return out


def load_reference_checkpoint(model, path_or_state_dict, strict=True):
    """Fill port `model` from a reference det3d checkpoint (a `.pth` path
    or a loaded state_dict): convert onto the model's own weights in flax
    layout (`convert.variables_of`), then `convert.load_jax_variables`.
    With `strict=False` the leaves the checkpoint lacks keep the model's
    values. Returns the conversion report."""
    from .convert import load_jax_variables, variables_of

    sd = (load_torch_state_dict(path_or_state_dict)
          if isinstance(path_or_state_dict, str) else path_or_state_dict)
    variables, report = convert_state_dict(sd, variables_of(model),
                                           strict=strict)
    load_jax_variables(model, variables)
    return report
