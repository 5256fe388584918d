"""Compact (gather-based) sparse-site machinery for the early BEV stages.

Port of `pillarnet_lts_tpu/ops/compact.py`. The reference runs conv1/conv2
as true sparse convolutions over an active-site list (spconv SubM /
SparseConv2d, `det3d/models/backbones/base.py:38-63`,
`PillarResNet.py:73-108`); this module is that execution on static
shapes:

- active sites live in a COMPACT row table `(B, kmax, C)` sorted row-major
  by flat BEV id, padded to a static budget, with a zero sentinel row at
  index `kmax` (`(B, kmax + 1, C)` where a gather reads it);
- every irregular operation (neighbour lookup, occupancy dilation,
  densification) is a leftmost binary search into the sorted id table
  (`torch.searchsorted`, the JAX package's branchless search) plus row
  gathers: no scatter, no host sync;
- a SubM conv is an im2col gather `(B, k, 9 * Cin)` and one matmul.

Every function here is batched over a leading B (the JAX functions are
per sample and `jax.vmap`ped by their callers); integers are int32 and
bit-equal to the JAX package's, truncation by the budget included.
Offsets are row-major (dy, dx) in {-1, 0, 1}^2, the order of a
`(3, 3, Cin, Cout) -> (9 * Cin, Cout)` reshape of the dense kernels, so
compact and masked-dense execution share parameters.

The gathers are advanced indexing (`rows[b, idx]`). Their gradient is a
gather too (`gather_rows`): each row sums the gradients of the entries
that read it, listed in a reverse table, in a fixed order. Autograd's
own backward of an index, `index_put_(accumulate=True)`, is sorted and
deterministic on CUDA, but it walks each run of equal indices serially,
and the sentinel row and the padding slots form runs of ~10^6 entries (a
bs=4 training step of `pillarnet34_nusc` spent 10 of its 11 s there on
an H100). The reverse tables (`subm_reverse`, `down_conv_reverse`, and
those `compact_segment_max` and `compact_to_dense` build) list every
entry that can carry a gradient; the rest read the padded rows, whose
gradient is exactly 0.
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

_I32 = torch.int32


@dataclasses.dataclass
class Neighbors:
    """A gather conv's table: idx (B, Ko, 9) rows read per output row and
    offset; rev (B, K + 1, 9), or None where no gradient is taken, the
    entries (i * 9 + d) that read each row, Ko * 9 where none does."""

    idx: torch.Tensor
    rev: Optional[torch.Tensor] = None


class _RowGather(torch.autograd.Function):
    """rows[b, idx[b, ...]] whose backward gathers the output gradient back
    through `rev` ((B, N, R) flat entries of idx per row of rows; the
    number of idx entries for none) and sums over R."""

    @staticmethod
    def forward(ctx, rows, idx, rev):
        ctx.save_for_backward(rev)
        ctx.shape = (idx[0].numel(),) + rows.shape[2:]
        return _take(rows, idx)

    @staticmethod
    def backward(ctx, grad):
        (rev,) = ctx.saved_tensors
        flat = grad.reshape(grad.shape[0], *ctx.shape)
        flat = torch.cat([flat, flat.new_zeros(flat[:, :1].shape)], 1)
        return _take(flat, rev).sum(2), None, None


def gather_rows(rows, idx, rev=None):
    """rows[b, idx[b, ...]]; where `rev` is given and a gradient is taken,
    the gradient comes back through it (`_RowGather`)."""
    if rev is None or not (torch.is_grad_enabled() and rows.requires_grad):
        return _take(rows, idx)
    return _RowGather.apply(rows, idx, rev)


def searchsorted_left(table, queries):
    """Leftmost binary search: first i with table[b, i] >= q per sample.

    table: (B, n) ascending int32; queries: (B, ...) int32.
    Returns (B, ...) int32 positions in [0, n]."""
    b = table.shape[0]
    pos = torch.searchsorted(table, queries.reshape(b, -1).contiguous(),
                             side="left", out_int32=True)
    return pos.reshape(queries.shape)


def _take(table, idx):
    """table[b, idx[b, ...]] for a (B, n, ...) table: (B, ...) entries, or
    rows where the table has trailing dims."""
    b = torch.arange(table.shape[0], device=table.device)
    return table[b.view((-1,) + (1,) * (idx.dim() - 1)), idx.long()]


def lookup_ids(table, valid_n, queries, miss):
    """Exact-match lookup of `queries` (B, ...) in the sorted (B, n) `table`
    -> row index or `miss`. valid_n (B,) bounds the logically valid prefix
    (padding entries hold an id larger than every real query)."""
    pos = searchsorted_left(table, queries)
    n = table.shape[1]
    vn = valid_n.view((-1,) + (1,) * (queries.dim() - 1))
    hit = (_take(table, pos.clamp(max=n - 1)) == queries) & (pos < vn)
    return torch.where(hit, pos, torch.full_like(pos, miss))


def compact_ranks(flags):
    """ranks[b, i] = #flags[b, :i + 1] (int32); the j-th set flag is at
    `searchsorted_left(ranks, j + 1)`."""
    return torch.cumsum(flags.to(_I32), dim=-1, dtype=_I32)


def compact_segment_max(point_feats, flat_ids, valid, hw, kmax):
    """Sorted segment-max emitting COMPACT pillar rows (no dense grid).

    Points are sorted by pillar id (stable), a reverse segmented max scan
    of log2(N) doubling steps leaves each run head holding its pillar's
    max, and the run heads are extracted: the active sites, sorted
    row-major. The scan is the JAX package's, so its gradient is too: a
    tie splits the gradient in half at each step where the two values
    meet (`torch.maximum`'s backward, as `jnp.maximum`'s).

    Args:
      point_feats: (B, N, C) post-MLP features.
      flat_ids: (B, N) int32 in [0, hw]; hw = invalid sentinel.
      valid: (B, N) bool.
      kmax: static active-site budget.
    Returns:
      rows: (B, kmax + 1, C); padding and sentinel rows are 0.
      site_ids: (B, kmax) int32 sorted flat ids; padding = hw.
      k_valid: (B,) int32 active-site counts (clamped to kmax).
    """
    bsz, n, c = point_feats.shape
    dev = point_feats.device
    neg = torch.finfo(point_feats.dtype).min
    ids = torch.where(valid, flat_ids, hw).to(_I32)
    ids_s, order = torch.sort(ids, dim=1, stable=True)
    feats_s = torch.where(_take(valid, order)[..., None],
                          _take(point_feats, order), neg)

    d = 1
    while d < n:
        same = torch.cat([ids_s[:, d:] == ids_s[:, :-d],
                          torch.zeros((bsz, d), dtype=torch.bool,
                                      device=dev)], dim=1)
        shifted = torch.cat([feats_s[:, d:],
                             feats_s.new_full((bsz, d, c), neg)], dim=1)
        feats_s = torch.where(same[..., None],
                              torch.maximum(feats_s, shifted), feats_s)
        d *= 2

    head = torch.cat([torch.ones((bsz, 1), dtype=torch.bool, device=dev),
                      ids_s[:, 1:] != ids_s[:, :-1]], dim=1) & (ids_s < hw)
    ranks = compact_ranks(head)
    k_valid = ranks[:, -1].clamp(max=kmax)

    slot = torch.arange(kmax, dtype=_I32, device=dev).expand(bsz, kmax)
    src = searchsorted_left(ranks, slot + 1)
    ok = slot < k_valid[:, None]
    src_c = src.clamp(max=n - 1)
    site_ids = torch.where(ok, _take(ids_s, src_c), hw).to(_I32)
    # a run head of rank r <= kmax fills slot r - 1; nothing else is read
    rev = torch.where(head & (ranks <= kmax), ranks - 1, kmax)[..., None]
    vals = torch.where(ok[..., None], gather_rows(feats_s, src_c, rev), 0.0)
    rows = torch.cat([vals, vals.new_zeros((bsz, 1, c))], dim=1)
    return rows, site_ids, k_valid


def _offset_queries(ys, xs, height, width):
    """(B, K, 9) flat ids of the 3x3 window around (ys, xs), row-major
    offsets; out-of-grid positions query height * width."""
    cols = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            yy = ys + dy
            xx = xs + dx
            inb = (yy >= 0) & (yy < height) & (xx >= 0) & (xx < width)
            cols.append(torch.where(inb, yy * width + xx, height * width))
    return torch.stack(cols, dim=-1)


def subm_neighbor_table(site_ids, k_valid, height, width, kmax):
    """(B, kmax, 9) int32 neighbour row indices of a 3x3 SubM conv; an
    inactive or out-of-grid neighbour points at the zero sentinel row
    `kmax`. The x edges are checked via id % width, so id +- 1 cannot wrap
    across rows."""
    q = _offset_queries(site_ids // width, site_ids % width, height, width)
    return lookup_ids(site_ids, k_valid, q, kmax).to(_I32)


def subm_reverse(nbr, k_valid):
    """The reverse (B, K + 1, 9) of a SubM table (B, K, 9): a valid row j
    is read at offset d by its neighbour at the opposite offset,
    i = nbr[j, 8 - d], as entry i * 9 + d; K * 9 where there is none.
    Padding rows and the sentinel row are listed as read by none: only
    padding rows, whose gradient is 0, read them."""
    bsz, k, _ = nbr.shape
    opp = nbr.flip(-1).long()
    d = torch.arange(9, device=nbr.device)
    live = (opp < k) & (torch.arange(k, device=nbr.device)[None, :, None]
                        < k_valid[:, None, None])
    rev = torch.where(live, opp * 9 + d, k * 9)
    return torch.cat([rev, rev.new_full((bsz, 1, 9), k * 9)], 1)


def gather_conv(rows, nbr, weight, bias=None):
    """SubM (or strided) conv on compact rows: im2col gather + one matmul.

    rows: (B, K + 1, Cin) with the zero sentinel row; nbr: (B, Ko, 9)
    indices into rows, or `Neighbors` (with the reverse table the
    gradient takes); weight: (9 * Cin, Cout), row-major (dy, dx, Cin).
    Returns (B, Ko, Cout) in the dtype of rows and weight; the bias is
    cast to it and added after the matmul (the JAX package's order)."""
    if not isinstance(nbr, Neighbors):
        nbr = Neighbors(nbr)
    bsz, ko, _ = nbr.idx.shape
    cin = rows.shape[-1]
    g = gather_rows(rows, nbr.idx, nbr.rev)  # (B, Ko, 9, Cin)
    y = g.reshape(bsz, ko, 9 * cin) @ weight
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def downsample_site_ids(site_ids, k_valid, height, width, k2max):
    """Active coarse sites after a k=3 s=2 p=1 SparseConv2d (spconv's rule:
    coarse (yo, xo) is active iff a fine site lies in the 3x3 window at
    (2yo, 2xo)), scatter-free: per fine row an interval count on the
    sorted ids.

    Returns (site_ids2 (B, k2max) int32 sorted row-major on the
    (height // 2, width // 2) grid, padded with h2 * w2; k2_valid (B,))."""
    bsz = site_ids.shape[0]
    dev = site_ids.device
    h2, w2 = height // 2, width // 2
    hw2 = h2 * w2
    qy = torch.arange(h2, dtype=_I32, device=dev)
    qx = torch.arange(w2, dtype=_I32, device=dev)
    yy = qy[:, None] * 2
    kv = k_valid.view(-1, 1, 1)
    occ = torch.zeros((bsz, h2, w2), dtype=torch.bool, device=dev)
    for dy in (-1, 0, 1):
        ry = yy + dy
        inb = (ry >= 0) & (ry < height)
        base = ry * width
        lo = base + (qx[None, :] * 2 - 1).clamp(min=0)
        hi = base + (qx[None, :] * 2 + 1).clamp(max=width - 1)
        n_lo = searchsorted_left(site_ids, lo.expand(bsz, h2, w2))
        n_hi = searchsorted_left(site_ids, (hi + 1).expand(bsz, h2, w2))
        occ = occ | (inb & (n_hi > n_lo) & (n_lo < kv))

    ranks = compact_ranks(occ.reshape(bsz, hw2))
    k2_valid = ranks[:, -1].clamp(max=k2max)
    slot = torch.arange(k2max, dtype=_I32, device=dev).expand(bsz, k2max)
    src = searchsorted_left(ranks, slot + 1)
    ok = slot < k2_valid[:, None]
    ids2 = torch.where(ok, src.clamp(max=hw2 - 1), hw2).to(_I32)
    return ids2, k2_valid


def down_conv_neighbor_table(site_ids2, k2_valid, fine_site_ids, fine_k,
                             height, width, kmax_fine):
    """(B, k2max, 9) int32 fine-row indices feeding each coarse output site
    of the strided conv: fine positions (2yo + dy, 2xo + dx), row-major
    offsets; a miss points at the fine sentinel row `kmax_fine`."""
    del k2_valid  # the padding rows' entries are masked downstream
    w2 = width // 2
    q = _offset_queries((site_ids2 // w2) * 2, (site_ids2 % w2) * 2,
                        height, width)
    return lookup_ids(fine_site_ids, fine_k, q, kmax_fine).to(_I32)


def down_conv_reverse(fine_site_ids, fine_k, site_ids2, k2_valid, height,
                      width, k2max):
    """The reverse (B, Kf + 1, 9) of the strided table: the valid fine row
    at (y, x) is read at offset (dy, dx) by the coarse row at
    ((y - dy) / 2, (x - dx) / 2) where both halves are whole and that
    coarse site is in the table, as entry i * 9 + d; k2max * 9 where none
    reads it."""
    bsz, kf = fine_site_ids.shape
    h2, w2 = height // 2, width // 2
    ys, xs = fine_site_ids // width, fine_site_ids % width
    cols = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ty, tx = ys - dy, xs - dx
            yo, xo = ty // 2, tx // 2
            ok = ((ty % 2 == 0) & (tx % 2 == 0) & (ty >= 0) & (tx >= 0)
                  & (yo < h2) & (xo < w2))
            cols.append(torch.where(ok, yo * w2 + xo, h2 * w2))
    rows = lookup_ids(site_ids2, k2_valid, torch.stack(cols, -1),
                      k2max).long()
    d = torch.arange(9, device=rows.device)
    live = (rows < k2max) & (torch.arange(kf, device=rows.device)[
        None, :, None] < fine_k[:, None, None])
    rev = torch.where(live, rows * 9 + d, k2max * 9)
    return torch.cat([rev, rev.new_full((bsz, 1, 9), k2max * 9)], 1)


def compact_to_dense(rows, site_ids, k_valid, height, width):
    """The dense (B, height, width, C) NHWC map and (B, height, width) bool
    occupancy of compact rows (B, kmax + 1, C): one binary search per grid
    position and one row gather (the sentinel row is zero)."""
    bsz, kmax = site_ids.shape
    q = torch.arange(height * width, dtype=_I32, device=rows.device)
    q = q.expand(bsz, -1)
    pos = searchsorted_left(site_ids, q)
    hit = (_take(site_ids, pos.clamp(max=kmax - 1)) == q) \
        & (pos < k_valid[:, None])
    idx = torch.where(hit, pos, kmax)
    # a valid row is read once, at its site; the rest by none
    live = torch.arange(kmax + 1, device=rows.device)[None, :] \
        < k_valid[:, None]
    rev = torch.where(live, F.pad(site_ids, (0, 1)), height * width)
    grid = gather_rows(rows, idx, rev[..., None])
    return (grid.reshape(bsz, height, width, rows.shape[-1]),
            hit.reshape(bsz, height, width))

