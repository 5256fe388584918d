"""Spatial (BEV-grid) sharding over `torch.distributed`: each rank runs the
stride-1 and stride-2 stages (conv1, conv2) on its band of grid rows.

The counterpart of `pillarnet_lts_tpu/parallel/spatial.py` and of the
detector field `PillarNet.spatial_axis`. The JAX package shards the BEV
grid's H axis over a mesh axis, pins the conv1 and conv2 outputs
H-sharded and conv3 onward replicated, and XLA inserts a one-row halo
exchange per 3x3 conv (`halo_exchange_h`, `sharded_conv3x3` there write
the same pattern by hand). Here the spatial group is the
`torch.distributed` world (a group of one without a group), started by
the caller (`parallel/dist.py::init_from_env`); every rank holds the
whole model and the same points:

- `row_bands`: the bands, boundaries on even rows so that a stride-2
  conv's outputs split at whole rows; the last band takes the rest;
- `halo_exchange_h`: a band -> the band with `rows` halo rows from the
  ranks that own them on each side, zeros past the map's edge;
- `sharded_conv3x3`, `sharded_subm_conv3x3`: halo + a conv valid on H,
  the unsharded SAME conv's band (NCHW maps, torch weights);
- `gather_rows`: the bands -> the whole map on every rank, where the JAX
  package pins a stage output replicated.

Both collectives are `torch.autograd.Function`s whose backward is their
transpose: a halo row's gradient goes back to the rank that owns the row
and is added there; the gather's keeps the rank's own band. Each is one
`all_reduce` of a zeroed buffer of row slots, the only collective that
NCCL and gloo both take on CUDA tensors (two gloo ranks share one card
where NCCL refuses). In the forward every slot is written by one rank,
so the buffer is summed as bytes: each byte has one nonzero addend and
the sum is a bit copy in any dtype (-0, NaN and bf16 included). Every
rank issues the same collectives in the same order, the recomputation of
a checkpointed block (`models/backbones/base.py::remat`) included, since
every rank runs the same modules on the same shapes up to its band's
height.

The backbone's band execution is `models/backbones/band_exec.py`; this
module also says which parameters hold one band's share of their
gradient (`partial_parameters`, summed over the group by
`runtime/train_step.py`) and merges the calibration absmax of the int8
deploy over the group (`max_over_group`).
"""

import torch
import torch.distributed as tdist

from . import dist


def row_bands(height, ranks, align=2):
    """The bands [(start, stop)] of a map of `height` rows over `ranks`
    ranks, in rank order: each `ceil(height / ranks)` rows rounded up to a
    multiple of `align` (so every boundary falls on a multiple of it), the
    last the rest. Raises where a rank would get no row."""
    step = -(-height // ranks)
    step = -(-step // align) * align
    bands = [(min(k * step, height), min((k + 1) * step, height))
             for k in range(ranks)]
    if bands[-1][0] >= height:
        raise ValueError(
            f"spatial sharding: {height} rows do not split over {ranks} "
            f"ranks in bands of whole multiples of {align} rows")
    return bands


def coarse_bands(bands, height):
    """The bands of a stride-2 conv's output (ceil(height / 2) rows) over
    `bands` of its input, whose starts are even: output row i reads input
    rows 2i - 1 .. 2i + 1."""
    out = -(-height // 2)
    return [(start // 2, out if stop == height else stop // 2)
            for start, stop in bands]


def _all_reduce(buf):
    tdist.all_reduce(buf)
    return buf


def _copy_sum(buf):
    """Sum `buf` over the ranks as bytes (a bit copy where every element
    has one nonzero contributor)."""
    _all_reduce(buf.view(-1).view(torch.uint8))
    return buf


def _halo_rows(bands, r, above, below, height):
    """The global rows this rank takes from the others: above its band,
    then below it, clipped to the map."""
    start, stop = bands[r]
    return (list(range(max(start - above, 0), start)),
            list(range(stop, min(stop + below, height))))


def _slots(bands, above, below):
    """Every rank's halo rows, in one list of global rows (the buffer's
    row slots), and each rank's (top, bottom) rows."""
    height = bands[-1][1]
    per = [_halo_rows(bands, r, above, below, height)
           for r in range(len(bands))]
    rows = sorted({u for top, bot in per for u in top + bot})
    return rows, per


def _channels_last(x):
    """Whether a (B, C, H, W) map keeps its channels innermost (the
    port's bf16 maps): the collectives then hand back maps laid out so."""
    return x.shape[1] > 1 and x.stride(1) == 1


def _cat_rows(parts, channels_last):
    """(B, C, h_i, W) parts -> one map along H, in the parts' layout."""
    if not channels_last:
        return torch.cat(parts, dim=2)
    return torch.cat([p.permute(0, 2, 3, 1) for p in parts],
                     dim=1).permute(0, 3, 1, 2)


class _Halo(torch.autograd.Function):
    """x (B, C, h, W), this rank's band -> (B, C, above + h + below, W)."""

    @staticmethod
    def forward(ctx, x, bands, above, below):
        r = dist.rank()
        start, stop = bands[r]
        rows, per = _slots(bands, above, below)
        at = {u: i for i, u in enumerate(rows)}
        buf = x.new_zeros((x.shape[0], x.shape[1], len(rows), x.shape[3]))
        own = [u for u in rows if start <= u < stop]
        if own:
            buf[:, :, [at[u] for u in own]] = x[:, :, [u - start
                                                        for u in own]]
        if rows:
            _copy_sum(buf)
        top, bot = per[r]
        ctx.geometry = (bands, r, rows, top, bot, above, below)
        ctx.h = x.shape[2]
        zero = x.new_zeros((x.shape[0], x.shape[1], 1, x.shape[3]))
        pad_top = [zero] * (above - len(top))
        pad_bot = [zero] * (below - len(bot))
        parts = pad_top + [buf[:, :, at[u]:at[u] + 1] for u in top] + [x] \
            + [buf[:, :, at[u]:at[u] + 1] for u in bot] + pad_bot
        return _cat_rows(parts, _channels_last(x))

    @staticmethod
    def backward(ctx, grad):
        bands, r, rows, top, bot, above, below = ctx.geometry
        start, stop = bands[r]
        at = {u: i for i, u in enumerate(rows)}
        g_band = grad[:, :, above:above + ctx.h].float()
        if not rows:
            return g_band.to(grad.dtype), None, None, None
        buf = grad.new_zeros((grad.shape[0], grad.shape[1], len(rows),
                              grad.shape[3]), dtype=torch.float32)
        first = above - len(top)
        for i, u in enumerate(top):
            buf[:, :, at[u]] += grad[:, :, first + i].float()
        for i, u in enumerate(bot):
            buf[:, :, at[u]] += grad[:, :, above + ctx.h + i].float()
        _all_reduce(buf)
        own = [u for u in rows if start <= u < stop]
        if own:
            g_band = g_band.clone()
            g_band[:, :, [u - start for u in own]] += \
                buf[:, :, [at[u] for u in own]]
        return g_band.to(grad.dtype), None, None, None


def halo_exchange_h(x, bands, rows=1, above=None, below=None):
    """This rank's band x (B, C, h, W) of a map split in `bands` (every
    rank's, `row_bands`) -> (B, C, rows + h + rows, W): `rows` rows of the
    map above and below the band, taken from the ranks that own them, or
    zeros past the map's edge (`above` / `below` set either side's count
    apart). Differentiable: a halo row's gradient is added to its owner's.
    Without a group it pads zeros."""
    above = rows if above is None else above
    below = rows if below is None else below
    if not dist.is_initialized():
        return torch.nn.functional.pad(x, (0, 0, above, below))
    return _Halo.apply(x, bands, above, below)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bands):
        start, stop = bands[dist.rank()]
        ctx.band = (start, stop)
        b, c, _, w = x.shape
        if _channels_last(x):  # an NHWC buffer, handed back as its view
            buf = x.new_zeros((b, bands[-1][1], w, c))
            buf[:, start:stop] = x.permute(0, 2, 3, 1)
            return _copy_sum(buf).permute(0, 3, 1, 2)
        buf = x.new_zeros((b, c, bands[-1][1], w))
        buf[:, :, start:stop] = x
        return _copy_sum(buf)

    @staticmethod
    def backward(ctx, grad):
        start, stop = ctx.band
        return grad[:, :, start:stop], None


def gather_rows(x, bands):
    """This rank's band x (B, C, h, W) -> the whole map (B, C, H, W) on
    every rank, bit for bit. Its gradient is the rank's band of the
    map's (every rank computes the same loss from the gathered map).
    The map itself without a group (a group of one still runs the
    collective)."""
    if not dist.is_initialized():
        return x
    return _Gather.apply(x, bands)


def sharded_conv3x3(x, weight, bands):
    """The SAME 3x3 conv (stride 1, zero padding) of an H-sharded NCHW map
    on this rank's band: halo exchange, then a conv valid on H and SAME on
    W. weight: (Cout, Cin, 3, 3)."""
    xh = halo_exchange_h(x, bands)
    return torch.nn.functional.conv2d(xh, weight, padding=(0, 1))


def sharded_subm_conv3x3(x, mask, weight, bands):
    """The SubM counterpart: x zero at inactive sites, mask (B, h, W) the
    band's occupancy; the output is zero at inactive sites, and the halo
    carries the neighbours' activations, so a site at a band's edge sees
    the unsharded receptive field."""
    y = sharded_conv3x3(x, weight, bands)
    return y * mask[:, None].to(y.dtype)


def max_over_group(tensors):
    """Each of `tensors` (f32, any shapes) replaced by its elementwise max
    over the ranks, in one collective (the list itself without a group
    split by the grid): calibration under spatial sharding, where each
    rank observes the activations of its band."""
    if dist.splits_batch() or not dist.is_initialized():
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    tdist.all_reduce(flat, op=tdist.ReduceOp.MAX)
    return [f.view_as(t) for f, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def sharded_detectors(model):
    """The spatially sharded `PillarNet`s of `model` (itself, or a
    two-stage model's first stage)."""
    return [m for m in model.modules()
            if getattr(m, "spatial_axis", None)]


def partial_parameters(model):
    """The parameters whose gradient on a rank is one band's share, to be
    summed over the group: the reader's, conv1's and conv2's of each
    sharded detector (None where `model` has none). Every later
    parameter sees the gathered map and has its whole gradient on every
    rank."""
    dets = sharded_detectors(model)
    if not dets:
        return None
    out = []
    for det in dets:
        out += list(det.reader_net.parameters())
        for stage in det.backbone_net.sharded_stages():
            out += list(stage.parameters())
    return out


def refuse(model_cfg, tool):
    """Raise if a model config (single- or two-stage) sets
    `spatial_axis`: `tool` runs one model on each rank's own frames (or
    traces one request) and has no spatial group."""
    axis = (model_cfg.get("spatial_axis")
            or (model_cfg.get("first_stage_cfg") or {}).get("spatial_axis"))
    if axis:
        raise ValueError(
            f"{tool} does not run a spatially sharded model "
            f"(spatial_axis={axis!r}): serve it with eval_utils."
            "make_infer_fn on every rank of a group started by "
            "parallel.dist.init_from_env, or drop the key")
