"""Plain PyTorch reference of the single-stage PillarNet detector served by
the benchmark: dynamic pillar encoder, PillarResNet backbone, RPNV1 neck,
CenterHead, decode and rotated NMS, in f32, or with the int8 deploy's
convs emulated in integers (bf16 activations between layers).

It reads a weight dict keyed by the names `param_spec` lists (the names a
state dict of the system under test also has, so one dict feeds both) and
imports nothing of the system under test. Every layer is written from its
published description (PillarNet, arXiv:2205.07403; CenterPoint,
arXiv:2006.11275) and the configuration dict:

- pillars: a point's pillar is floor((x - x_min) * f32(1 / size)) per axis
  (the reciprocal rounded to f32 first); its features are the offsets from
  the pillar centre, then the raw channels; a Linear + BN + ReLU, then the
  max over the pillar's points (an empty pillar is 0);
- submanifold 3x3 convs keep the active sites of their input; a strided
  3x3 conv's active outputs are those whose window covers an active input;
  an inactive site holds 0;
- eval BatchNorm is folded into the preceding conv (y = conv(x) * inv +
  (b * inv + shift));
- NMS is greedy suppression over the score-sorted candidates, computed as
  the fixpoint of `NMS_SWEEPS` parallel sweeps (exact for suppression
  chains of that depth or less: the system's stated semantics).

int8 (`quant` in the configuration): symmetric per-tensor activation
scales absmax / 127 from calibration forwards in the compute dtype, per
output channel weight scales, round half to even, clip to +-127, exact
integer sums, then acc * (s_x * s_w * inv) + shift in f32. `qmax` sets
the code range (127; the control runs 7, int4).
"""

import numpy as np
import torch
import torch.nn.functional as F

from .boxes import rotated_iou_bev, to_bev

NMS_SWEEPS = 16
BN_EPS = 1e-3
HEAD_CONV = 64
SHARE_CONV = 64
BACKBONE_BLOCKS = {"PillarResNet18": (2, (2, 2, 2)),
                   "PillarResNet34": (3, (4, 6, 3))}


def _f32(x):
    return float(np.float32(x))


def head_branches(task, common_heads):
    """(name, out channels, convs) of one task's SepHead, in order."""
    heads = dict(common_heads)
    heads["hm"] = (len(task["class_names"]), 2)
    return [(h, c, n) for h, (c, n) in heads.items()]


def param_spec(model_cfg):
    """[(name, shape, kind)] of every tensor the reference reads. kind is
    'conv' (fan = in * k * k), 'linear', 'deconv', 'bias', 'hm_bias' or a
    BN part: 'bn_w', 'bn_b', 'bn_mean', 'bn_var'."""
    spec = []

    def bn(prefix, c):
        spec.extend([(f"{prefix}.weight", (c,), "bn_w"),
                     (f"{prefix}.bias", (c,), "bn_b"),
                     (f"{prefix}.running_mean", (c,), "bn_mean"),
                     (f"{prefix}.running_var", (c,), "bn_var")])

    def conv(name, cout, cin, bias=True, kind="conv"):
        spec.append((f"{name}.weight", (cout, cin, 3, 3), kind))
        if bias:
            spec.append((f"{name}.bias", (cout,), "bias"))

    r = model_cfg["reader"]
    dims = [2 + r["in_channels"]] + list(r["num_filters"])
    for k in range(len(dims) - 1):
        spec.append((f"reader_net.pfn_dense_{k}.weight",
                     (dims[k + 1], dims[k]), "linear"))
        bn(f"reader_net.pfn_bn_{k}", dims[k + 1])
    b = model_cfg["backbone"]
    c = b["in_channels"]
    n1, stages = BACKBONE_BLOCKS[b["type"]]
    for i in range(n1):
        p = f"backbone_net.conv1_block{i}"
        for j in (range(3) if i == 0 else (1, 2)):
            conv(f"{p}.conv{j}", c, c)
            bn(f"{p}.bn{j}", c)
    cin = c
    for s, nb in zip((2, 3, 4), stages):
        cout = cin * 2
        p = f"backbone_net.conv{s}"
        conv(f"{p}.down_conv", cout, cin, bias=False)
        bn(f"{p}.down_bn", cout)
        for i in range(nb):
            for j in (1, 2):
                conv(f"{p}.block{i}.conv{j}", cout, cout)
                bn(f"{p}.block{i}.bn{j}", cout)
        cin = cout
    for name in ("conv5_down", "conv5_block0", "conv5_block1"):
        conv(f"backbone_net.{name}.conv", cin, cin, bias=False)
        bn(f"backbone_net.{name}.bn", cin)
    n = model_cfg["neck"]
    f0, f1 = n["in_channels"]
    for blk, width_in, width, num in (("block_5", cin, f0, n["layer_nums"][0]),
                                      ("block_4", c * 8 + f1,
                                       n["num_filters"], n["layer_nums"][1])):
        for i in range(num + 1):
            p = f"neck_net.{blk}.conv{i}"
            conv(f"{p}.Conv_0", width, width_in if i == 0 else width,
                 bias=False, kind="conv_xavier")
            bn(f"{p}.MaskedBatchNorm_0", width)
            if blk == "block_5" and i == num:
                spec.append(("neck_net.deblock_5.ConvTranspose_0.weight",
                             (f0, f1, 2, 2), "deconv"))
                bn("neck_net.deblock_5.MaskedBatchNorm_0", f1)
    h = model_cfg["bbox_head"]
    conv("head_net.share_conv0", SHARE_CONV, h["in_channels"][0])
    bn("head_net.share_bn0", SHARE_CONV)
    for t, task in enumerate(h["tasks"]):
        for name, cout, nconv in head_branches(task, h["common_heads"]):
            p = f"head_net.task{t}"
            for i in range(nconv - 1):
                conv(f"{p}.{name}_conv{i}", HEAD_CONV,
                     SHARE_CONV if i == 0 else HEAD_CONV)
                bn(f"{p}.{name}_bn{i}", HEAD_CONV)
            spec.append((f"{p}.{name}_out.weight",
                         (cout, HEAD_CONV if nconv > 1 else SHARE_CONV, 3, 3),
                         "conv"))
            spec.append((f"{p}.{name}_out.bias", (cout,),
                         "hm_bias" if name == "hm" else "bias"))
    # the neck's deconv sits between the two blocks in a state dict's
    # order, which `load_state_dict` does not need: keep spec order stable
    return spec


class Quant:
    """The calibrated int8 state of a reference forward: per site name,
    the absmax observed (calibration) or the scale it gives (serving)."""

    def __init__(self, qmax=127):
        self.qmax = qmax
        self.observing = False
        self.absmax = {}

    def observe(self, name, amax):
        old = self.absmax.get(name)
        self.absmax[name] = amax if old is None else torch.maximum(old, amax)

    def scale(self, name):
        # the system's scale: max(absmax, 1e-6) * f32(1 / 127)
        return (torch.clamp_min(self.absmax[name], 1e-6)
                * _f32(1.0 / self.qmax))

    def codes(self, x, inv_s, lo=None):
        q = torch.round(x.float() * inv_s)
        return q.clamp_(-self.qmax if lo is None else lo, self.qmax)


class Reference:
    """One configuration's reference detector over a weight dict."""

    def __init__(self, model_cfg, test_cfg, weights, quant=None):
        self.cfg = model_cfg
        self.test_cfg = test_cfg
        self.w = weights
        self.quant = quant  # a `Quant` for the int8 deploy, else None
        self.train = False  # BN with batch statistics (`train.py`)
        self.dtype = (torch.bfloat16 if model_cfg.get("dtype") == "bfloat16"
                      else torch.float32)
        r = model_cfg["reader"]
        self.pillar = float(r["pillar_size"])
        self.pc_range = [float(v) for v in r["pc_range"]]
        self.H = int(round((self.pc_range[4] - self.pc_range[1])
                           / self.pillar))
        self.W = int(round((self.pc_range[3] - self.pc_range[0])
                           / self.pillar))

    # ---- building blocks -------------------------------------------------

    def _bn_fold(self, prefix):
        w = self.w
        inv = (torch.rsqrt(w[f"{prefix}.running_var"] + BN_EPS)
               * w[f"{prefix}.weight"])
        shift = w[f"{prefix}.bias"] - w[f"{prefix}.running_mean"] * inv
        return inv, shift

    def bn_train(self, y, prefix, mask=None):
        """BatchNorm with the batch's statistics over the active sites
        (`mask`, broadcast over the channel axis; every site when None):
        biased variance, eps 1e-3, the inactive sites re-zeroed. The
        channel axis is 1 for maps and last for point rows."""
        cdim = 1 if y.dim() == 4 else y.dim() - 1
        dims = [d for d in range(y.dim()) if d != cdim]
        shape = [1] * y.dim()
        shape[cdim] = -1
        if mask is None:
            mean = y.mean(dims)
            var = torch.clamp_min((y * y).mean(dims) - mean * mean, 0.0)
        else:
            m = mask.to(y.dtype)
            cnt = torch.clamp_min(m.sum(), 1.0)
            mean = (y * m).sum(dims) / cnt
            var = torch.clamp_min((y * y * m).sum(dims) / cnt - mean * mean,
                                  0.0)
        inv = torch.rsqrt(var + BN_EPS) * self.w[f"{prefix}.weight"]
        out = (y - mean.view(shape)) * inv.view(shape) \
            + self.w[f"{prefix}.bias"].view(shape)
        return out if mask is None else out * mask.to(y.dtype)

    def _int8_on(self, site):
        q = self.quant
        return q is not None and not q.observing and site in q.absmax

    def conv_bn(self, x, conv, bn, stride=1, quant=False, mask=None,
                residual=None, act=True):
        """conv (3x3, padding 1) + folded eval BN [* mask] [+ residual]
        [ReLU], in x.dtype; the int8 core when `quant` and calibrated."""
        w = self.w[f"{conv}.weight"]
        b = self.w.get(f"{conv}.bias")
        inv, shift = self._bn_fold(bn)
        q = self.quant if quant else None
        if q is not None and q.observing:
            q.observe(conv, x.abs().amax().float())
        if self.train:
            y = self.bn_train(F.conv2d(x, w, b, stride=stride, padding=1),
                              bn, mask)
            if residual is not None:
                y = y + residual
            return F.relu(y) if act else y
        if q is not None and self._int8_on(conv):
            s_x = q.scale(conv)
            s_w = torch.clamp_min(w.abs().flatten(1).amax(1)
                                  * _f32(1.0 / q.qmax), 1e-12)
            w_q = q.codes(w, (1.0 / s_w)[:, None, None, None])
            acc = F.conv2d(q.codes(x, 1.0 / s_x).double(), w_q.double(),
                           stride=stride, padding=1).round()
            dq = s_x * s_w * inv
            sh = b * inv + shift if b is not None else shift
            y = (acc.float() * dq[:, None, None]
                 + sh[:, None, None]).to(x.dtype)
        else:
            wf = (w * inv[:, None, None, None]).to(x.dtype)
            bf = (b * inv + shift if b is not None else shift).to(x.dtype)
            y = F.conv2d(x, wf, bf, stride=stride, padding=1)
        if mask is not None:
            y = y * mask
        if residual is not None:
            y = y + residual
        return F.relu(y) if act else y

    # ---- layers ----------------------------------------------------------

    def pillars(self, points, points_mask):
        """(B, N, C) points -> PFE inputs (B, N, 2 + C), flat pillar ids
        (B, N) (H * W for a dropped point) and validity."""
        inv = _f32(1.0 / self.pillar)
        x0, y0 = self.pc_range[0], self.pc_range[1]
        cx = torch.floor((points[..., 0] - x0) * inv).long()
        cy = torch.floor((points[..., 1] - y0) * inv).long()
        valid = (points_mask & (cx >= 0) & (cx < self.W) & (cy >= 0)
                 & (cy < self.H))
        cx, cy = cx.clamp(0, self.W - 1), cy.clamp(0, self.H - 1)
        ctr_x = cx.float() * self.pillar + (self.pillar / 2 + x0)
        ctr_y = cy.float() * self.pillar + (self.pillar / 2 + y0)
        feats = torch.cat([torch.stack([points[..., 0] - ctr_x,
                                        points[..., 1] - ctr_y], -1),
                           points], -1) * valid[..., None]
        ids = torch.where(valid, cy * self.W + cx, self.H * self.W)
        return feats, ids, valid

    def scatter_max(self, feats, ids, valid):
        """Per-pillar max of nonnegative point features -> (B, C, H, W)
        and the (B, H, W) occupancy."""
        B, N, C = feats.shape
        hw = self.H * self.W
        grid = torch.zeros((B, hw + 1, C), dtype=feats.dtype,
                           device=feats.device)
        grid.scatter_reduce_(1, ids[..., None].expand(B, N, C),
                             feats * valid[..., None], "amax")
        occ = torch.zeros((B, hw + 1), dtype=torch.bool, device=feats.device)
        occ.scatter_(1, ids, valid)
        grid = grid[:, :hw].reshape(B, self.H, self.W, C)
        return grid.permute(0, 3, 1, 2), occ[:, :hw].reshape(B, self.H,
                                                              self.W)

    def reader(self, points, points_mask):
        feats, ids, valid = self.pillars(points, points_mask)
        x = feats.to(self.dtype)
        q = self.quant if self.cfg["reader"].get("quant") else None
        inv, shift = self._bn_fold("reader_net.pfn_bn_0")
        w = self.w["reader_net.pfn_dense_0.weight"]
        if q is not None and q.observing:
            q.observe("reader_in", (x.abs() * valid[..., None]).amax((0, 1))
                      .float())
        if self.train:
            y = self.bn_train(F.linear(x, w), "reader_net.pfn_bn_0",
                              valid[..., None])
        elif q is not None and self._int8_on("reader_in"):
            s_x = q.scale("reader_in")
            ws = w * s_x[None, :]
            s_w = torch.clamp_min(ws.abs().amax(1) * _f32(1.0 / q.qmax),
                                  1e-12)
            wq = q.codes(ws, (1.0 / s_w)[:, None])
            y = F.linear(q.codes(x, 1.0 / s_x), wq)
            y = (y * (s_w * inv) + shift).to(self.dtype)
        else:
            y = F.linear(x, (w * inv[:, None]).to(x.dtype), shift.to(x.dtype))
        y = F.relu(y)
        if q is not None and q.observing:
            q.observe("scatter", (y.abs() * valid[..., None]).amax().float())
        if q is not None and self._int8_on("scatter"):
            s = q.scale("scatter")
            codes = q.codes(y, 1.0 / s, lo=0)
            grid, occ = self.scatter_max(codes, ids, valid)
            return (grid * s).to(self.dtype), occ
        grid, occ = self.scatter_max(y.float(), ids, valid)
        return grid.to(self.dtype).contiguous(), occ

    def _ckpt(self, fn, *args):
        """fn(*args); in training its activations are recomputed in the
        backward (`torch.utils.checkpoint`), so the reference fits on the
        card at the timed batch. The mathematics is unchanged."""
        if self.train and torch.is_grad_enabled():
            import torch.utils.checkpoint as cp

            return cp.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def backbone(self, x, occ):
        b = self.cfg["backbone"]
        quant = bool(b.get("quant"))
        n1, stages = BACKBONE_BLOCKS[b["type"]]

        def block(p, x, mask, first=False):
            if first:
                x = self.conv_bn(x, f"{p}.conv0", f"{p}.bn0", quant=quant,
                                 mask=mask, act=False)
            out = self.conv_bn(x, f"{p}.conv1", f"{p}.bn1", quant=quant,
                               mask=mask)
            return self.conv_bn(out, f"{p}.conv2", f"{p}.bn2", quant=quant,
                                mask=mask, residual=x)

        def down(p, x, mask):
            return self.conv_bn(x, f"{p}.down_conv", f"{p}.down_bn",
                                stride=2, quant=quant, mask=mask)

        mask = occ[:, None].to(x.dtype)
        for i in range(n1):
            # the recomputation in the backward calls these again: every
            # value they read is bound now
            x = self._ckpt(lambda x, p=f"backbone_net.conv1_block{i}",
                           m=mask, f=i == 0: block(p, x, m, f), x)
        feats = {}
        for s, nb in zip((2, 3, 4), stages):
            occ = F.max_pool2d(occ[:, None].float(), 3, 2, 1)[:, 0] > 0.5
            mask = occ[:, None].to(x.dtype)
            p = f"backbone_net.conv{s}"
            x = self._ckpt(lambda x, p=p, m=mask: down(p, x, m), x)
            for i in range(nb):
                x = self._ckpt(lambda x, p=f"{p}.block{i}", m=mask:
                               block(p, x, m), x)
            feats[f"conv{s}"] = x
        for k, name in enumerate(("conv5_down", "conv5_block0",
                                  "conv5_block1")):
            x = self.conv_bn(x, f"backbone_net.{name}.conv",
                             f"backbone_net.{name}.bn",
                             stride=2 if k == 0 else 1, quant=quant)
        feats["conv5"] = x
        return feats

    def neck(self, feats):
        n = self.cfg["neck"]
        quant = bool(n.get("quant"))
        x = feats["conv5"]
        for i in range(n["layer_nums"][0] + 1):
            p = f"neck_net.block_5.conv{i}"
            x = self.conv_bn(x, f"{p}.Conv_0", f"{p}.MaskedBatchNorm_0",
                             quant=quant)
        # the transposed conv sums the compute dtype's operands in f32 and
        # its BN reads the sums unrounded (one rounding after the BN)
        w = self.w["neck_net.deblock_5.ConvTranspose_0.weight"]
        y = F.conv_transpose2d(x.float(), w.to(x.dtype).float(), stride=2)
        if self.train:
            up = F.relu(self.bn_train(y, "neck_net.deblock_5."
                                         "MaskedBatchNorm_0"))
        else:
            # eval BN on the unrounded sums: (y - mean) * inv + bias
            p = "neck_net.deblock_5.MaskedBatchNorm_0"
            inv = (torch.rsqrt(self.w[f"{p}.running_var"] + BN_EPS)
                   * self.w[f"{p}.weight"])
            up = F.relu(((y - self.w[f"{p}.running_mean"][:, None, None])
                         * inv[:, None, None]
                         + self.w[f"{p}.bias"][:, None, None]).to(x.dtype))
        x = torch.cat([feats["conv4"], up], 1)
        for i in range(n["layer_nums"][1] + 1):
            p = f"neck_net.block_4.conv{i}"
            x = self.conv_bn(x, f"{p}.Conv_0", f"{p}.MaskedBatchNorm_0",
                             quant=quant)
        return x

    def head(self, x):
        """-> per task {head: (B, H, W, C) f32}."""
        h = self.cfg["bbox_head"]
        x = self.conv_bn(x, "head_net.share_conv0", "head_net.share_bn0")
        out = []
        for t, task in enumerate(h["tasks"]):
            p = f"head_net.task{t}"
            preds = {}
            for name, _, nconv in head_branches(task, h["common_heads"]):
                z = x
                for i in range(nconv - 1):
                    z = self.conv_bn(z, f"{p}.{name}_conv{i}",
                                     f"{p}.{name}_bn{i}")
                w = self.w[f"{p}.{name}_out.weight"].to(z.dtype)
                b = self.w[f"{p}.{name}_out.bias"].to(z.dtype)
                preds[name] = (F.conv2d(z, w, b, padding=1)
                               .permute(0, 2, 3, 1).float())
            out.append(preds)
        return out

    def forward(self, points, points_mask):
        grid, occ = self.reader(points, points_mask)
        return self.head(self.neck(self.backbone(grid, occ)))

    @torch.no_grad()
    def calibrate(self, clouds):
        """Set the int8 scales from calibration forwards (the compute
        dtype's float path), the max over the clouds."""
        q = self.quant
        q.absmax, q.observing = {}, True
        try:
            for points, mask in clouds:
                self.forward(points, mask)
        finally:
            q.observing = False

    # ---- decode and NMS --------------------------------------------------

    def decode(self, preds):
        """Every location's box, score and label of each task:
        [(boxes (B, H*W, D), scores (B, H*W), labels (B, H*W), class
        scores (B, H*W, C))], labels counted over all tasks."""
        h = self.cfg["bbox_head"]
        out, offset = [], 0
        for task, p in zip(h["tasks"], preds):
            hm = torch.sigmoid(p["hm"])
            B, Hh, Wh, _ = hm.shape
            dev = hm.device
            stride = task["stride"] * self.pillar
            xs = (torch.arange(Wh, device=dev, dtype=torch.float32)[None, None]
                  + p["reg"][..., 0]) * stride + self.pc_range[0]
            ys = (torch.arange(Hh, device=dev, dtype=torch.float32)[None, :,
                                                                     None]
                  + p["reg"][..., 1]) * stride + self.pc_range[1]
            dim = torch.exp(p["dim"].clamp(-1.2, 3.2))
            rot = torch.atan2(p["rot"][..., 0], p["rot"][..., 1])
            parts = [xs[..., None], ys[..., None], p["height"], dim]
            if "vel" in p:
                parts.append(p["vel"])
            boxes = torch.cat(parts + [rot[..., None]], -1)
            scores, labels = hm.max(-1)
            out.append((boxes.reshape(B, Hh * Wh, -1),
                        scores.reshape(B, -1),
                        labels.reshape(B, -1) + offset,
                        hm.reshape(B, Hh * Wh, -1)))
            offset += len(task["class_names"])
        return out

    def nms(self, boxes, scores, labels):
        """One task of one frame: candidates over the score threshold with
        their centre inside `post_center_limit_range`, the top
        `nms_pre_max_size` by score (ties to the lower index), greedy
        rotated NMS, the first `nms_post_max_size` kept.
        -> the kept locations (K,), in score order."""
        cfg = self.test_cfg
        nms = cfg["nms"]
        lim = torch.tensor(cfg["post_center_limit_range"],
                           device=boxes.device)
        ok = ((scores > cfg["score_threshold"])
              & (boxes[:, :3] >= lim[:3]).all(-1)
              & (boxes[:, :3] <= lim[3:]).all(-1))
        idx = torch.nonzero(ok)[:, 0]
        order = torch.sort(scores[idx], descending=True, stable=True)[1]
        idx = idx[order][:nms["nms_pre_max_size"]]
        cand = boxes[idx]
        bev = to_bev(cand.double())
        iou = rotated_iou_bev(bev, bev)
        k = len(idx)
        ar = torch.arange(k, device=boxes.device)
        sup = ((ar[:, None] < ar[None, :])
               & (iou > nms["nms_iou_threshold"])).double()
        keep = torch.ones(k, dtype=torch.bool, device=boxes.device)
        for _ in range(NMS_SWEEPS):
            keep = ~((keep.double()[None] @ sup)[0] > 0)
        return idx[keep][:nms["nms_post_max_size"]]

    @torch.no_grad()
    def detect(self, points, points_mask):
        """Reference detections of a batch: per frame and task, every
        location's decoded box, score and label, the kept locations and
        every location's class scores."""
        dec = self.decode(self.forward(points, points_mask))
        return [[(bx[b], sc[b], lb[b], self.nms(bx[b], sc[b], lb[b]), cs[b])
                 for bx, sc, lb, cs in dec] for b in range(points.shape[0])]


def head_out_name(t, h):
    return f"head_net.task{t}.{h}_out"


def spread_head(weights, preds):
    """Rescale each head projection of a random-weight model in place so
    that, on the input `preds` came from, each output channel has median 0
    (heatmaps: -2.19, a prior of 0.1) and a robust spread (1.4826 x the
    median absolute deviation) of 1 (heatmaps: 2): decoded boxes then stay
    in range and NMS sees real candidates. The projection's weight is
    scaled and its bias replaced."""
    for t, p in enumerate(preds):
        for h, v in p.items():
            name = head_out_name(t, h)
            w, b = weights[f"{name}.weight"], weights[f"{name}.bias"]
            z = (v - b.to(v.dtype)).flatten(0, -2).double()
            med = z.median(0).values
            mad = 1.4826 * (z - med).abs().median(0).values
            scale = (2.0 if h == "hm" else 1.0) / torch.clamp_min(mad, 1e-6)
            target = -2.19 if h == "hm" else 0.0
            w.mul_(scale.to(w)[:, None, None, None])
            b.copy_((target - med * scale).to(b))
