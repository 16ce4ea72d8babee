"""Image layers (counterpart of paddle_tpu/layers/image.py): the resize
family and ROI max pooling.

The JAX package resizes with ``jax.image.resize``; no Pallas kernel
stands behind these layers, so here they are torch ops with its
conventions:

* ``BILINEAR`` is the triangle filter over half-pixel centres with the
  weights renormalized at the edges, widened by the scale when it
  downsamples (antialiasing): ``F.interpolate(mode="bilinear",
  antialias=True)``, whose filter is that one in both directions.
* ``NEAREST`` takes source index ``floor((i + 0.5) * in / out)`` in f32
  as ``jax.image.resize`` compiles it (the ratio folded to ``in *
  f32(1 / out)``), gathered with ``index_select`` (``F.interpolate``'s
  ``nearest`` takes ``floor(i * in / out)``).

On the card the bilinear backward adds with atomics, so a program that
resizes is not bit-reproducible run to run.

``roi_pool`` is the JAX package's masked two-stage max: the rois'
integer bin bounds, then a max over columns and one over rows, with
empty bins 0. A bin's size is the roi's times ``f32(1 / pooled)``, the
product XLA compiles the division to (``ceil`` of a true quotient would
end some last bins a row short of it), on every device alike. Its
gradient goes, as ``jnp.max``'s does, in equal parts to the tied maxima
of a bin.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.enforce import enforce
from ..layer_helper import LayerHelper


def _resolve_hw(in_shape, out_shape, scale):
    enforce(out_shape is not None or scale is not None,
            "image_resize: pass out_shape or scale")
    if out_shape is not None:
        enforce(len(out_shape) == 2, "out_shape must be [H, W]")
        return int(out_shape[0]), int(out_shape[1])
    H, W = in_shape[2], in_shape[3]
    enforce(H != -1 and W != -1,
            "image_resize with scale needs static H/W")
    return int(H * scale), int(W * scale)


def _recip(n) -> float:
    """The f32 reciprocal of ``n`` (exactly representable as a float)."""
    return float(np.float32(1.0) / np.float32(n))


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """``floor((arange(n_out) + 0.5) * n_in / n_out)`` in f32, with the
    ratio folded as the JAX package's compiled program folds it: ``n_in
    * f32(1 / n_out)``."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
    ratio = float(np.float32(n_in) * np.float32(_recip(n_out)))
    return torch.floor(pos * ratio).to(torch.int64)


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample: str = "BILINEAR"):
    """Resize ``[B, C, H, W]`` images to ``out_shape`` (or ``scale``
    times their size)."""
    enforce(resample in ("BILINEAR", "NEAREST"),
            "resample must be BILINEAR or NEAREST")
    helper = LayerHelper("image_resize")
    oh, ow = _resolve_hw(input.shape, out_shape, scale)
    out = helper.create_tmp_variable(input.dtype)

    def fn(x):
        if resample == "BILINEAR":
            return F.interpolate(x, size=(oh, ow), mode="bilinear",
                                 align_corners=False, antialias=True)
        y = x.index_select(2, _nearest_index(x.shape[2], oh, x.device))
        return y.index_select(3, _nearest_index(x.shape[3], ow, x.device))

    helper.append_op(type="image_resize", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"out_h": oh, "out_w": ow, "resample": resample},
                     fn=fn)
    if input.shape is not None:
        out.shape = tuple(input.shape[:2]) + (oh, ow)
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    """Bilinear :func:`image_resize`."""
    return image_resize(input, out_shape, scale, name, resample="BILINEAR")


def image_resize_short(input, out_short_len: int, resample: str = "BILINEAR"):
    """Resize so the short side becomes ``out_short_len``, keeping the
    aspect ratio."""
    H, W = input.shape[2], input.shape[3]
    enforce(H != -1 and W != -1, "image_resize_short needs static H/W")
    short, is_h = (H, True) if H < W else (W, False)
    ratio = out_short_len / float(short)
    out_shape = ([out_short_len, int(round(W * ratio))] if is_h
                 else [int(round(H * ratio)), out_short_len])
    return image_resize(input, out_shape=out_shape, resample=resample)


def roi_pool(input, rois, pooled_height: int = 1, pooled_width: int = 1,
             spatial_scale: float = 1.0, rois_batch_idx=None):
    """ROI max pooling. ``input``: ``[B, C, H, W]``; ``rois``: ``[R, 4]``
    (x1, y1, x2, y2) in input-image coordinates; ``rois_batch_idx``:
    ``[R]`` image of each roi (default: all image 0). Returns ``[R, C,
    pooled_height, pooled_width]``."""
    helper = LayerHelper("roi_pool")
    out = helper.create_tmp_variable(input.dtype)
    ph, pw = int(pooled_height), int(pooled_width)

    inputs = {"X": [input.name], "ROIs": [rois.name]}
    if rois_batch_idx is not None:
        inputs["BatchIdx"] = [rois_batch_idx.name]

    def fn(x, r, bidx=None):
        _, _, H, W = x.shape
        dev = x.device
        if bidx is None:
            bidx = torch.zeros(r.shape[0], dtype=torch.int64, device=dev)
        bidx = bidx.reshape(-1).to(torch.int64)
        # the rois scaled and rounded (half to even), then the bins'
        # integer bounds by floor and ceil of the f32 bin size
        x1, y1, x2, y2 = (torch.round(r[:, i] * spatial_scale).to(
            torch.int32) for i in range(4))
        rh = torch.clamp(y2 - y1 + 1, min=1)
        rw = torch.clamp(x2 - x1 + 1, min=1)
        bin_h = rh.to(torch.float32) * _recip(ph)
        bin_w = rw.to(torch.float32) * _recip(pw)
        py = torch.arange(ph, dtype=torch.float32, device=dev)
        px = torch.arange(pw, dtype=torch.float32, device=dev)

        def bounds(start, size, p, n):
            lo = start[:, None] + torch.floor(p[None] * size[:, None]).to(
                torch.int32)
            hi = start[:, None] + torch.ceil((p[None] + 1) * size[:, None]
                                             ).to(torch.int32)
            return torch.clamp(lo, 0, n), torch.clamp(hi, 0, n)

        hstart, hend = bounds(y1, bin_h, py, H)          # [R, ph]
        wstart, wend = bounds(x1, bin_w, px, W)          # [R, pw]
        ys = torch.arange(H, device=dev)
        xs = torch.arange(W, device=dev)
        yin = (ys >= hstart[..., None]) & (ys < hend[..., None])  # [R,ph,H]
        xin = (xs >= wstart[..., None]) & (xs < wend[..., None])  # [R,pw,W]
        imgs = x[bidx]                                    # [R, C, H, W]
        neg = torch.finfo(torch.float32).min
        # column maxima bin by bin ([R, C, H] each), then row maxima:
        # no [R, C, pw, H, W] intermediate
        colmax = torch.stack([
            torch.where(xin[:, None, j, None, :], imgs, neg).amax(-1)
            for j in range(pw)], 2)                       # [R, C, pw, H]
        pooled = torch.stack([
            torch.where(yin[:, None, None, i, :], colmax, neg).amax(-1)
            for i in range(ph)], 2)                       # [R, C, ph, pw]
        empty = ((~yin.any(-1))[:, None, :, None]
                 | (~xin.any(-1))[:, None, None, :])
        return torch.where(empty, 0.0, pooled).to(x.dtype)

    helper.append_op(type="roi_pool", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"pooled_height": ph, "pooled_width": pw,
                            "spatial_scale": spatial_scale}, fn=fn)
    if input.shape is not None and rois.shape is not None:
        out.shape = (rois.shape[0], input.shape[1], ph, pw)
    return out
