"""Operation and byte counts of the detector from its configuration and its
input, and the least time one H100 needs for them.

`frame_ops` counts what the architecture needs on a frame's actual input,
whatever route executes it: a submanifold conv at its input's active
sites, a strided conv at the outputs whose window covers an active input,
dense stages, the neck and the head at every site, the pillar MLP per
point. Decode and NMS are left out. Each part carries the arithmetic the
configuration states for it, and `min_seconds` takes it at that
arithmetic's peak. `k4_calls` lists the int8 conv kernel's calls of a
request with `int8_conv_bound`'s bound for each: a copy of the
system's own bound arithmetic (bytes and operations from shapes and
active sites, against the published H100 SXM peaks).
"""

import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and
# operations/s by arithmetic (f32 outside the tensor cores: TF32 is off)
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
BLOCKS = {"PillarResNet18": (2, (2, 2, 2)), "PillarResNet34": (3, (4, 6, 3))}
HEAD_CONV = SHARE_CONV = 64


def bound(n_bytes, ops, peak):
    """(seconds, 'bytes' or 'operations'): the larger of `n_bytes` at the
    HBM rate and `ops` at `peak` operations/s."""
    t_bytes, t_ops = n_bytes / HBM_BPS, ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grid_shape(model_cfg):
    r = model_cfg["reader"]
    pc, s = r["pc_range"], r["pillar_size"]
    return (int(round((pc[4] - pc[1]) / s)), int(round((pc[3] - pc[0]) / s)))


def occupancy(points, points_mask, model_cfg):
    """(B, N, C) points -> (B, H, W) bool pillar occupancy and the valid
    point count per frame (the pillar rule of the reference)."""
    r = model_cfg["reader"]
    pc, size = r["pc_range"], float(r["pillar_size"])
    H, W = grid_shape(model_cfg)
    inv = float(torch.tensor(1.0 / size, dtype=torch.float32))
    cx = torch.floor((points[..., 0] - pc[0]) * inv).long()
    cy = torch.floor((points[..., 1] - pc[1]) * inv).long()
    valid = points_mask & (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
    ids = torch.where(valid, cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1),
                      H * W)
    B = points.shape[0]
    occ = torch.zeros((B, H * W + 1), dtype=torch.bool, device=points.device)
    occ.scatter_(1, ids, valid)
    return occ[:, :H * W].reshape(B, H, W), valid.sum(1)


def dilate(occ):
    """A strided 3x3 conv's active outputs (stride 2, padding 1)."""
    return F.max_pool2d(occ[:, None].float(), 3, 2, 1)[:, 0] > 0.5


def covered_inputs(out_occ, in_hw, stride):
    """Per frame, the input sites that the active outputs' 3x3 windows
    (padding 1) cover."""
    ones = torch.ones((1, 1, 3, 3), device=out_occ.device)
    m = out_occ[:, None].float()
    if stride == 1:
        cov = F.conv2d(m, ones, padding=1)
    else:
        H, W = in_hw
        cov = F.conv_transpose2d(m, ones, stride=2, padding=1,
                                 output_padding=(H - 2 * m.shape[2] + 1,
                                                 W - 2 * m.shape[3] + 1))
    return (cov[:, 0] > 0.5).flatten(1).sum(1)


def stage_sites(occ):
    """Active sites per frame at strides 1, 2, 4 and 8 of the backbone,
    and the occupancies themselves."""
    levels = [occ]
    for _ in range(3):
        levels.append(dilate(levels[-1]))
    return levels


def conv_list(model_cfg, levels):
    """The 3x3 convs of one batch of frames, in execution order:
    (name, cin, cout, stride, input occupancy, output occupancy, masked,
    part). Occupancies are (B, H, W) bool, all True for a dense map;
    `masked`: the conv keeps only its output's active sites (a sparse
    stage); part: 'backbone' or 'neck'."""
    b = model_cfg["backbone"]
    c = b["in_channels"]
    n1, stages = BLOCKS[b["type"]]
    out = []
    for i in range(n1):
        for j in (range(3) if i == 0 else (1, 2)):
            out.append((f"conv1_block{i}.conv{j}", c, c, 1, levels[0],
                        levels[0], True, "backbone"))
    cin = c
    for s, nb in zip((2, 3, 4), stages):
        cout = cin * 2
        lin, lout = levels[s - 2], levels[s - 1]
        out.append((f"conv{s}.down_conv", cin, cout, 2, lin, lout, True,
                    "backbone"))
        for i in range(nb):
            for j in (1, 2):
                out.append((f"conv{s}.block{i}.conv{j}", cout, cout, 1, lout,
                            lout, True, "backbone"))
        cin = cout
    B, H8, W8 = levels[3].shape
    d8 = torch.ones_like(levels[3])
    d16 = torch.ones((B, (H8 + 1) // 2, (W8 + 1) // 2), dtype=torch.bool,
                     device=d8.device)
    out.append(("conv5_down", cin, cin, 2, d8, d16, False, "backbone"))
    out += [(f"conv5_block{i}", cin, cin, 1, d16, d16, False, "backbone")
            for i in range(2)]
    n = model_cfg["neck"]
    f0, f1 = n["in_channels"]
    for i in range(n["layer_nums"][0] + 1):
        out.append((f"block_5.conv{i}", cin if i == 0 else f0, f0, 1, d16,
                    d16, False, "neck"))
    nf = n["num_filters"]
    for i in range(n["layer_nums"][1] + 1):
        out.append((f"block_4.conv{i}", c * 8 + f1 if i == 0 else nf, nf, 1,
                    d8, d8, False, "neck"))
    return out


def _count(occ):
    """Active sites per frame, float64."""
    return occ.flatten(1).sum(1).double().cpu()


def frame_ops(model_cfg, points, points_mask):
    """Per frame of a batch: {arithmetic: (B,) float64 operations} that
    the architecture needs on this input (a multiply-add counts 2)."""
    quant = {k: bool(model_cfg[k].get("quant"))
             for k in ("reader", "backbone", "neck", "bbox_head")}
    low = "bf16" if model_cfg.get("dtype") == "bfloat16" else "f32"
    occ, n_points = occupancy(points, points_mask, model_cfg)
    levels = stage_sites(occ)
    ops = {}

    def add(kind, v):
        ops[kind] = ops.get(kind, 0) + v

    r = model_cfg["reader"]
    dims = [2 + r["in_channels"]] + list(r["num_filters"])
    for a, b in zip(dims, dims[1:]):
        add("int8" if quant["reader"] else low,
            2.0 * a * b * n_points.double().cpu())
    convs = conv_list(model_cfg, levels)
    for _, cin, cout, _, _, lout, _, part in convs:
        add("int8" if quant[part] else low, 2.0 * 9 * cin * cout
            * _count(lout))
    n = model_cfg["neck"]
    f0, f1 = n["in_channels"]
    d16, d8 = convs[-1 - n["layer_nums"][1] - 1][5], convs[-1][5]
    add(low, 2.0 * 4 * f0 * f1 * _count(d16))  # the 2x2 stride-2 deconv
    h = model_cfg["bbox_head"]
    head = 2.0 * 9 * h["in_channels"][0] * SHARE_CONV
    for task in h["tasks"]:
        heads = dict(h["common_heads"])
        heads["hm"] = (len(task["class_names"]), 2)
        for cout, nconv in heads.values():
            width = SHARE_CONV
            for _ in range(nconv - 1):
                head += 2.0 * 9 * width * HEAD_CONV
                width = HEAD_CONV
            head += 2.0 * 9 * width * cout
    add("int8" if quant["bbox_head"] else low, head * _count(d8))
    return ops


def min_seconds(ops):
    """Per frame: the least time the chip needs for `frame_ops`' counts,
    each at the peak of its arithmetic."""
    return sum(v / PEAK_OPS[k] for k, v in ops.items())


def k4_calls(model_cfg, points, points_mask, act_bytes=2):
    """The int8 conv kernel's calls of one request (a batch of frames):
    [(name, bound seconds, bound by)], from `int8_conv_bound`'s
    arithmetic: the packed kernel, the scales and the mask read once, the
    input at the sites the active outputs' windows cover, the residual at
    the active sites, the whole output written; 2 * 9 * Cin * Cout
    operations per active output site (every site without a mask)."""
    occ, _ = occupancy(points, points_mask, model_cfg)
    calls = []
    for name, cin, cout, stride, lin, lout, masked, part in conv_list(
            model_cfg, stage_sites(occ)):
        if not model_cfg[part].get("quant"):
            continue
        B, Ho, Wo = lout.shape
        sites = int(lout.sum())
        if masked:
            sites_in = int(covered_inputs(lout, lin.shape[1:], stride).sum())
        else:
            sites_in = lin.numel()
        residual = masked and name.endswith(".conv2")
        n_bytes = (9 * cin * cout + 4 + 8 * cout
                   + (B * Ho * Wo * act_bytes if masked else 0)
                   + B * Ho * Wo * cout * act_bytes
                   + sites_in * cin * act_bytes
                   + (sites * cout * act_bytes if residual else 0))
        t, by = bound(n_bytes, 2.0 * 9 * cin * cout * sites,
                      PEAK_OPS["int8"])
        calls.append((name, t, by))
    return calls
