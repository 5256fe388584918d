"""Bilinear interpolation of BEV feature maps at continuous coordinates.

Port of `pillarnet_lts_tpu/ops/bilinear.py::bilinear_interpolate`, with a
batch axis: the JAX package vmaps it over the batch. The corner indices
are clamped to the map; the weights come from the UNCLAMPED neighbours, as
in the reference (`bilinear_interpolate_torch`), so a point off the map
keeps weights that do not sum to the clamped corners' share.

The map is channels-last: each corner is one contiguous row of C floats,
gathered with `index_select` from the (B * H * W, C) view. The JAX package
computes this outside any Pallas kernel (XLA gathers), so it is torch ops
here too, on both devices.
"""

import torch


def bilinear_interpolate(im, x, y):
    """im: (B, H, W, C) channels-last map; x, y: (B, N) continuous pixel
    coordinates (x along W, y along H) -> (B, N, C) in im.dtype's
    promotion with f32."""
    B, H, W, C = im.shape
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    x1 = x0 + 1
    y1 = y0 + 1
    x0c, x1c = x0.clamp(0, W - 1), x1.clamp(0, W - 1)
    y0c, y1c = y0.clamp(0, H - 1), y1.clamp(0, H - 1)

    rows = im.reshape(B * H * W, C)
    base = (torch.arange(B, device=im.device, dtype=torch.int64)
            * (H * W))[:, None]

    def corner(yc, xc):
        idx = (base + yc.to(torch.int64) * W + xc).reshape(-1)
        return rows.index_select(0, idx).reshape(B, -1, C)

    Ia, Ib = corner(y0c, x0c), corner(y1c, x0c)
    Ic, Id = corner(y0c, x1c), corner(y1c, x1c)
    wa = (x1 - x) * (y1 - y)
    wb = (x1 - x) * (y - y0)
    wc = (x - x0) * (y1 - y)
    wd = (x - x0) * (y - y0)
    return (Ia * wa[..., None] + Ib * wb[..., None] + Ic * wc[..., None]
            + Id * wd[..., None])
