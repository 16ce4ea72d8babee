"""Detection layers, the SSD and RPN family (counterpart of
paddle_tpu/layers/detection.py): priors and anchors, box coding,
matching and target assignment, the SSD loss, multi-class NMS and the
detection head, and the mAP op.

Ground truth comes padded per image, ``[B, G, ...]`` with the ``@LEN``
count of each image's rows (or ``gt_count=``), and every output has a
static shape: empty detection rows carry label -1, as in the JAX
package. No Pallas kernel stands behind these layers; they are torch
ops, batched where the JAX package ``vmap``s:

* NMS runs every (image, class) row at once: the candidates of all rows
  stacked into ``[B * (C - 1), k]``, their pairwise IoU formed once, and
  one suppression loop of ``k = nms_top_k`` steps over all rows, so the
  launches do not grow with the class count. ``lax.top_k`` and
  ``jnp.argsort`` give ties to the lower index: here a stable sort.
* Greedy bipartite matching loops ``min(K, M)`` times over all images
  at once, with no host read: each step's pick is masked where the
  best similarity is not positive, as ``jnp.where`` guards it there.
  A training step with ``ssd_loss`` and a ``detection_output`` program
  are therefore capturable as CUDA graphs.
* Constant tables (priors, anchors and their variances, which depend on
  shapes only) are made once per device and shape and then reused, so a
  captured step copies nothing from the host.

``detection_map`` computes the mAP on the host with the numpy
evaluator of ``metrics.DetectionMAP``, as the JAX package's
``pure_callback`` does: the op carries ``_host_sync``, and
``Executor.run_steps``/``run_graph`` refuse a program that holds it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.enforce import enforce
from ..layer_helper import LayerHelper

_NEG = -1e9


def _constants(cache: dict, key, device, make):
    """``make()``'s CPU tensors on ``device``, made once per ``key`` and
    device and kept in ``cache`` (on "meta", made each call)."""
    if device.type == "meta":
        return tuple(t.to(device) for t in make())
    k = (key, str(device))
    if k not in cache:
        cache[k] = tuple(t.to(device) for t in make())
    return cache[k]


def _iou(a, b):
    """Pairwise IoU of boxes ``a [..., N, 4]`` and ``b [..., M, 4]``
    (xmin, ymin, xmax, ymax): ``[..., N, M]``. The JAX package's
    arithmetic, an axis at a time (no ``[..., N, M, 2]`` corners)."""
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0))

    def overlap(lo, hi):
        return torch.clamp(
            torch.minimum(a[..., :, None, hi], b[..., None, :, hi])
            - torch.maximum(a[..., :, None, lo], b[..., None, :, lo]),
            min=0)

    inter = overlap(0, 2) * overlap(1, 3)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


def iou_similarity(x, y):
    """Pairwise IoU: ``x [N, 4]``, ``y [M, 4]`` to ``[N, M]``."""
    helper = LayerHelper("iou_similarity")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="iou_similarity",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, fn=_iou)
    return out


def _prior_whs(min_sizes, max_sizes, ars, min_max_aspect_ratios_order):
    """Each location's prior (w, h) list — shared by prior_box and
    multi_box_head so the head's channel count always agrees."""
    whs = []
    for ms in min_sizes:
        if min_max_aspect_ratios_order:
            # Caffe layout: [min, max, other aspect ratios]
            whs.append((float(ms), float(ms)))
            if max_sizes:
                mx = max_sizes[min_sizes.index(ms)]
                whs.append((math.sqrt(ms * mx), math.sqrt(ms * mx)))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
        else:
            for ar in ars:
                whs.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
            if max_sizes:
                mx = max_sizes[min_sizes.index(ms)]
                whs.append((math.sqrt(ms * mx), math.sqrt(ms * mx)))
    return whs


def _expand_ars(aspect_ratios, flip):
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    return ars


def _grid_boxes(H, W, step_w, step_h, offset, whs):
    """``[H, W, P, 4]`` boxes of (w, h) ``whs`` centred on the cells of
    an ``H x W`` grid, in f32 as the JAX package computes them."""
    cx = (torch.arange(W, dtype=torch.float32) + offset) * step_w
    cy = (torch.arange(H, dtype=torch.float32) + offset) * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")      # [H, W]
    wh = torch.tensor(whs, dtype=torch.float32)           # [P, 2]
    c = torch.stack([cxg, cyg], -1)[:, :, None, :]        # [H, W, 1, 2]
    half = wh[None, None] / 2.0
    return torch.cat([c - half, c + half], -1)


def prior_box(input, image, min_sizes: Sequence[float],
              max_sizes: Optional[Sequence[float]] = None,
              aspect_ratios: Sequence[float] = (1.0,),
              variance: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
              flip: bool = False, clip: bool = False,
              steps: Sequence[float] = (0.0, 0.0), offset: float = 0.5,
              min_max_aspect_ratios_order: bool = False):
    """SSD prior boxes of one feature map, normalized by the image
    size. Returns (boxes ``[H, W, P, 4]``, variances ``[H, W, P,
    4]``)."""
    helper = LayerHelper("prior_box")
    boxes_v = helper.create_tmp_variable(np.float32)
    vars_v = helper.create_tmp_variable(np.float32)
    ars = _expand_ars(aspect_ratios, flip)
    max_sizes = list(max_sizes or [])
    whs = _prior_whs(min_sizes, max_sizes, ars, min_max_aspect_ratios_order)
    cache = {}

    def fn(feat, img):
        H, W = feat.shape[2], feat.shape[3]
        img_h, img_w = img.shape[2], img.shape[3]

        def make():
            boxes = _grid_boxes(H, W, steps[0] or img_w / W,
                                steps[1] or img_h / H, offset, whs)
            # normalized as the JAX package's compiled program does it,
            # bit for bit (IoU ties between the same-area priors of one
            # cell break on these last bits): XLA turns the division by
            # the constant into a product with its f32 reciprocal, and
            # folds a 1x1 map's constant boxes with a true division
            size = torch.tensor([img_w, img_h, img_w, img_h],
                                dtype=torch.float32)
            boxes = boxes / size if H * W == 1 else boxes * (1.0 / size)
            if clip:
                boxes = torch.clamp(boxes, 0.0, 1.0)
            var = torch.tensor(variance, dtype=torch.float32).expand(
                H, W, len(whs), 4)
            return boxes, var

        return _constants(cache, (H, W, img_h, img_w), feat.device, make)

    helper.append_op(type="prior_box",
                     inputs={"Input": [input.name], "Image": [image.name]},
                     outputs={"Boxes": [boxes_v.name],
                              "Variances": [vars_v.name]},
                     attrs={"min_sizes": list(min_sizes)}, fn=fn)
    return boxes_v, vars_v


def _centre_size(box):
    """(w, h, cx, cy) of boxes ``[..., 4]``."""
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    return w, h, box[..., 0] + w * 0.5, box[..., 1] + h * 0.5


def _encode(tb, prior, pvar):
    """encode_center_size of target boxes against priors (broadcast)."""
    pw, ph, pcx, pcy = _centre_size(prior)
    tw, th, tcx, tcy = _centre_size(tb)
    dx = (tcx - pcx) / pw / pvar[..., 0]
    dy = (tcy - pcy) / ph / pvar[..., 1]
    dw = torch.log(torch.clamp(tw / pw, min=1e-10)) / pvar[..., 2]
    dh = torch.log(torch.clamp(th / ph, min=1e-10)) / pvar[..., 3]
    return torch.stack([dx, dy, dw, dh], -1)


def _decode(tb, prior, pvar):
    """decode_center_size of offsets against priors (broadcast)."""
    pw, ph, pcx, pcy = _centre_size(prior)
    dcx = pvar[..., 0] * tb[..., 0] * pw + pcx
    dcy = pvar[..., 1] * tb[..., 1] * ph + pcy
    dw = torch.exp(pvar[..., 2] * tb[..., 2]) * pw
    dh = torch.exp(pvar[..., 3] * tb[..., 3]) * ph
    return torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                        dcx + dw * 0.5, dcy + dh * 0.5], -1)


def box_coder(prior_box, prior_box_var, target_box,
              code_type: str = "encode_center_size", box_normalized=True):
    """Encode target boxes ``[N, 4]`` against the priors, or decode
    offsets (``code_type="decode_center_size"``)."""
    helper = LayerHelper("box_coder")
    out = helper.create_tmp_variable(np.float32)

    def fn(prior, pvar, tb):
        prior, pvar = prior.reshape(-1, 4), pvar.reshape(-1, 4)
        if code_type == "encode_center_size":
            return _encode(tb, prior, pvar)
        return _decode(tb, prior, pvar)

    helper.append_op(type="box_coder",
                     inputs={"PriorBox": [prior_box.name],
                             "PriorBoxVar": [prior_box_var.name],
                             "TargetBox": [target_box.name]},
                     outputs={"OutputBox": [out.name]},
                     attrs={"code_type": code_type}, fn=fn)
    return out


def _top(scores, k):
    """(values, indices) of the ``k`` largest along the last axis, ties
    to the lower index (``lax.top_k``'s order)."""
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _nms_alive(boxes, scores, iou_threshold, score_threshold):
    """NMS of ``R`` independent rows of ``k`` candidates each: ``boxes
    [R, k, 4]``, ``scores [R, k]``. Returns (the score order ``[R, k]``,
    the survivors in that order ``[R, k]``). One loop of ``k`` steps
    suppresses in every row at once."""
    k = scores.shape[-1]
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    scores_s = torch.gather(scores, 1, order)
    later = torch.ones(k, k, dtype=torch.bool,
                       device=scores.device).triu_(1)
    over = (_iou(boxes_s, boxes_s) > iou_threshold) & later   # [R, k, k]
    alive = scores_s > score_threshold
    for i in range(k):
        # everything a still-alive, higher-scored box overlaps goes
        alive = alive & ~(over[:, i] & alive[:, i, None])
    return order, alive


def _nms_rows(boxes, scores, iou_threshold, score_threshold):
    """:func:`_nms_alive`'s survivors as kept indices ``[R, k]`` (into
    the row's candidates, best first, then 0) and valid ``[R, k]``."""
    order, alive = _nms_alive(boxes, scores, iou_threshold,
                              score_threshold)
    k = scores.shape[-1]
    # the survivors in order first (a stable sort of the dead)
    keep = torch.argsort((~alive).to(torch.int32), dim=-1, stable=True)
    valid = (torch.arange(k, device=scores.device)[None]
             < alive.sum(-1, keepdim=True))
    keep = torch.where(valid, keep, 0)
    return torch.gather(order, 1, keep), valid


def nms_jax(boxes, scores, iou_threshold: float, max_out: int,
            score_threshold: float = -1.0):
    """Single-class NMS with a static output budget, under the JAX
    package's name: ``boxes [N, 4]``, ``scores [N]``. Returns (kept
    indices ``[max_out]``, best first; valid ``[max_out]``). Its slots
    are filled as the JAX package's clipped scatter fills them: every
    candidate past the budget, or suppressed, writes the last slot (the
    last such candidate wins), and an invalid slot holds the best-scored
    candidate's index."""
    order, alive = _nms_alive(boxes[None], scores[None], iou_threshold,
                              score_threshold)
    order, alive = order[0], alive[0]
    n = scores.shape[0]
    dev = scores.device
    rank = torch.cumsum(alive.to(torch.int64), 0) - 1
    src = torch.clamp(torch.where(alive, rank, max_out), 0, max_out - 1)
    pos = torch.arange(n, device=dev)
    hits = src[None, :] == torch.arange(max_out, device=dev)[:, None]
    keep = (torch.where(hits, pos + 1, 0).amax(1) - 1)
    valid = torch.arange(max_out, device=dev) < alive.sum()
    keep = torch.where(valid, keep, 0)
    return order[keep], valid


def _drop_class(t, dim, background_label):
    """``t`` without index ``background_label`` along ``dim``."""
    n = t.shape[dim]
    if not 0 <= background_label < n:
        return t
    return torch.cat([t.narrow(dim, 0, background_label),
                      t.narrow(dim, background_label + 1,
                               n - background_label - 1)], dim)


def _multiclass_nms(boxes, cls_scores, score_threshold, nms_top_k,
                    keep_top_k, nms_threshold, background_label):
    """Multi-class NMS of a batch: ``boxes [B, N, 4]``, ``cls_scores [B,
    C, N]`` to ``[B, keep_top_k, 6]`` rows (label, score, x1, y1, x2,
    y2), best first, empty rows -1. Every (image, class) row runs in one
    :func:`_nms_rows` call."""
    B, C, N = cls_scores.shape
    dev = cls_scores.device
    sc = _drop_class(cls_scores, 1, background_label)     # [B, C', N]
    labels = _drop_class(torch.arange(C, device=dev), 0, background_label)
    Cp = sc.shape[1]
    k = min(nms_top_k, N)
    top_s, top_i = _top(sc, k)                             # [B, C', k]
    cand = torch.gather(boxes[:, None].expand(B, Cp, *boxes.shape[1:]), 2,
                        top_i[..., None].expand(B, Cp, k, 4))
    keep, valid = _nms_rows(cand.reshape(B * Cp, k, 4),
                            top_s.reshape(B * Cp, k), nms_threshold,
                            score_threshold)
    keep, valid = keep.reshape(B, Cp, k), valid.reshape(B, Cp, k)
    score = torch.where(valid, torch.gather(top_s, 2, keep), 0.0)
    box = torch.where(valid[..., None], torch.gather(
        cand, 2, keep[..., None].expand(B, Cp, k, 4)), 0.0)
    label = torch.where(valid, labels[None, :, None].to(torch.float32), -1.0)
    rows = torch.cat([label[..., None], score[..., None], box],
                     -1).reshape(B, Cp * k, 6)
    key = torch.where(rows[..., 0] >= 0, rows[..., 1], -math.inf)
    order = torch.argsort(-key, dim=-1, stable=True)[:, :keep_top_k]
    out = torch.gather(rows, 1, order[..., None].expand(-1, -1, 6))
    pad = keep_top_k - out.shape[1]
    if pad > 0:
        out = torch.cat([out, torch.full((B, pad, 6), -1.0, device=dev,
                                         dtype=out.dtype)], 1)
    return out


def multiclass_nms(bboxes, scores, score_threshold: float,
                   nms_top_k: int, keep_top_k: int,
                   nms_threshold: float = 0.3, background_label: int = 0):
    """Multi-class NMS of one image: ``bboxes [N, 4]``, per-class
    ``scores [C, N]``. Returns ``[keep_top_k, 6]`` rows (label, score,
    x1, y1, x2, y2); empty rows have label -1."""
    helper = LayerHelper("multiclass_nms")
    out = helper.create_tmp_variable(np.float32)

    def fn(boxes, cls_scores):
        return _multiclass_nms(boxes[None], cls_scores[None],
                               score_threshold, nms_top_k, keep_top_k,
                               nms_threshold, background_label)[0]

    helper.append_op(type="multiclass_nms",
                     inputs={"BBoxes": [bboxes.name],
                             "Scores": [scores.name]},
                     outputs={"Out": [out.name]},
                     attrs={"nms_threshold": nms_threshold}, fn=fn)
    return out


def _bipartite_match(dist, nvalid, match_type, dist_threshold):
    """Greedy bipartite matching of a batch: ``dist [B, K, M]``, rows
    ``0 .. nvalid[b] - 1`` real. Returns (row of each column ``[B, M]``
    int32, its similarity ``[B, M]``), -1 / 0 where unmatched; with
    ``per_prediction``, unmatched columns whose best row reaches the
    threshold take it."""
    B, K, M = dist.shape
    dev = dist.device
    rows = torch.arange(K, device=dev)
    cols = torch.arange(M, device=dev)
    d0 = torch.where((rows[None] < nvalid[:, None])[..., None], dist, _NEG)
    dd = torch.where(d0 > 0, d0, _NEG)
    row_of_col = torch.full((B, M), -1, dtype=torch.int64, device=dev)
    dist_of_col = torch.zeros((B, M), dtype=dist.dtype, device=dev)
    for _ in range(min(K, M)):
        flat = dd.reshape(B, -1).argmax(1)
        best = torch.gather(dd.reshape(B, -1), 1, flat[:, None])[:, 0]
        ok = best > 0
        r, c = flat // M, flat % M
        hit = (cols[None] == c[:, None]) & ok[:, None]
        row_of_col = torch.where(hit, r[:, None], row_of_col)
        dist_of_col = torch.where(hit, best[:, None], dist_of_col)
        gone = (((rows[None] == r[:, None])[:, :, None]
                 | (cols[None] == c[:, None])[:, None, :])
                & ok[:, None, None])
        dd = torch.where(gone, _NEG, dd)
    if match_type == "per_prediction":
        thr = 0.5 if dist_threshold is None else float(dist_threshold)
        mx, am = d0.max(1)
        extra = (row_of_col < 0) & (mx >= thr)
        row_of_col = torch.where(extra, am, row_of_col)
        dist_of_col = torch.where(extra, mx, dist_of_col)
    return row_of_col.to(torch.int32), dist_of_col


def _counts(nvalid, B, K, device):
    """The per-image valid row counts as int64 ``[B]`` (all ``K`` when
    none are given)."""
    if nvalid is None:
        return torch.full((B,), K, dtype=torch.int64, device=device)
    return nvalid.reshape(-1).to(torch.int64)


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    gt_count=None, name=None):
    """Greedy bipartite matching of ``dist_matrix [B, K, M]`` (or ``[K,
    M]``), the valid row counts from its ``@LEN`` or ``gt_count [B]``.
    Returns (match indices ``[B, M]`` int32, match distances ``[B,
    M]``)."""
    from .sequence import length_var_of

    helper = LayerHelper("bipartite_match")
    idx_v = helper.create_tmp_variable(np.int32)
    dist_v = helper.create_tmp_variable(np.float32)
    lenv = gt_count if gt_count is not None else length_var_of(dist_matrix)

    def fn(dist, nvalid=None):
        if dist.dim() == 2:
            dist = dist[None]
        B, K, _ = dist.shape
        return _bipartite_match(dist, _counts(nvalid, B, K, dist.device),
                                match_type, dist_threshold)

    inputs = {"DistMat": [dist_matrix.name]}
    if lenv is not None:
        inputs["RowCount"] = [lenv.name]
    helper.append_op(type="bipartite_match", inputs=inputs,
                     outputs={"ColToRowMatchIndices": [idx_v.name],
                              "ColToRowMatchDist": [dist_v.name]},
                     attrs={"match_type": match_type,
                            "dist_threshold": dist_threshold}, fn=fn)
    return idx_v, dist_v


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    """Per-prediction targets by match index. ``input``: padded ground
    truth ``[B, G, K]`` (or ``[B, G, P, K]``, one target per column);
    ``matched_indices [B, P]``, -1 unmatched; ``negative_indices [B,
    Q]`` padded with -1: those columns get weight 1 and the mismatch
    value. Returns (out ``[B, P, K]``, weight ``[B, P, 1]``)."""
    helper = LayerHelper("target_assign")
    out_v = helper.create_tmp_variable(input.dtype)
    w_v = helper.create_tmp_variable(np.float32)
    mv = 0.0 if mismatch_value is None else float(mismatch_value)

    def fn(x, midx, neg=None):
        B, P = midx.shape
        idx = torch.clamp(midx, min=0).to(torch.int64)
        if x.dim() == 4:                 # [B, G, P, K]: x[b, idx[b, j], j]
            gathered = x[torch.arange(B, device=x.device)[:, None], idx,
                         torch.arange(P, device=x.device)[None]]
        else:                            # [B, G, K]
            gathered = torch.gather(x, 1, idx[..., None].expand(
                B, P, x.shape[-1]))
        matched = midx >= 0
        out = torch.where(matched[..., None], gathered, mv)
        w = matched.to(torch.float32)
        if neg is not None:
            hits = torch.zeros((B, P), dtype=torch.float32, device=x.device)
            hits = hits.scatter_add(1, torch.clamp(neg, 0, P - 1).to(
                torch.int64), (neg >= 0).to(torch.float32))
            negmask = hits > 0
            out = torch.where(negmask[..., None], mv, out)
            w = torch.where(negmask, 1.0, w)
        return out, w[..., None]

    inputs = {"X": [input.name], "MatchIndices": [matched_indices.name]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices.name]
    helper.append_op(type="target_assign", inputs=inputs,
                     outputs={"Out": [out_v.name],
                              "OutWeight": [w_v.name]},
                     attrs={"mismatch_value": mv}, fn=fn)
    return out_v, w_v


def _smooth_l1(x):
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _softmax_ce(logits, labels):
    """``logsumexp(logits) - logits[label]`` over the last axis, the
    log-sum-exp as ``jax.nn.logsumexp`` forms it."""
    mx = logits.detach().amax(-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    lse = torch.log(torch.exp(logits - mx).sum(-1)) + mx[..., 0]
    return lse - torch.gather(logits, -1, labels[..., None])[..., 0]


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0,
             overlap_threshold=0.5, neg_pos_ratio=3.0, neg_overlap=0.5,
             loc_loss_weight=1.0, conf_loss_weight=1.0,
             match_type="per_prediction", mining_type="max_negative",
             normalize=True, sample_size=None, gt_count=None):
    """SSD multibox loss: ``location [B, P, 4]``, ``confidence [B, P,
    C]``; ``gt_box [B, G, 4]`` and ``gt_label [B, G]`` (or ``[B, G, 1]``)
    padded, with an ``@LEN`` count (or ``gt_count [B]``). IoU, matching,
    hard-negative mining (the top confidence losses among unmatched
    priors, up to ``neg_pos_ratio`` times the positives), target
    assignment, smooth-L1 plus softmax cross entropy, in one op with
    static shapes. Returns the loss ``[B, 1]``."""
    from .sequence import length_var_of

    enforce(mining_type == "max_negative",
            "Only mining_type='max_negative' is supported (same as the "
            "reference at this snapshot)")
    helper = LayerHelper("ssd_loss")
    out_v = helper.create_tmp_variable(np.float32)
    lenv = gt_count if gt_count is not None else length_var_of(gt_box)
    enforce(lenv is not None,
            "ssd_loss needs per-image GT counts: declare gt_box with "
            "lod_level=1 or pass gt_count=")

    def fn(loc, conf, gtb, gtl, prior, pvar, nvalid):
        if pvar is None:
            pvar = torch.full_like(prior, 0.1)
        B, P, _ = conf.shape
        G = gtb.shape[1]
        gtl = gtl.reshape(B, G).to(torch.int64)
        midx, mdist = _bipartite_match(
            _iou(gtb, prior[None]), _counts(nvalid, B, G, conf.device),
            match_type, overlap_threshold)                      # [B, P]
        matched = midx >= 0
        safe = torch.clamp(midx, min=0).to(torch.int64)
        tlabel = torch.where(matched, torch.gather(gtl, 1, safe),
                             background_label)
        conf_loss0 = _softmax_ce(conf.detach(), tlabel)          # [B, P]
        num_pos = matched.sum(1)
        neg_cand = (~matched) & (mdist < neg_overlap)
        num_neg = torch.minimum((neg_pos_ratio * num_pos).to(torch.int64),
                                neg_cand.sum(1))
        if sample_size is not None:
            num_neg = torch.clamp(num_neg, max=int(sample_size))
        # the top num_neg candidates by confidence loss, as a rank mask
        cand_loss = torch.where(neg_cand, conf_loss0, -math.inf)
        rank = torch.argsort(torch.argsort(-cand_loss, dim=1, stable=True),
                             dim=1, stable=True)
        neg_mask = neg_cand & (rank < num_neg[:, None])
        conf_w = matched.to(torch.float32) + neg_mask.to(torch.float32)
        conf_loss = _softmax_ce(conf, tlabel) * conf_w
        matched_gt = torch.gather(gtb, 1, safe[..., None].expand(B, P, 4))
        tb = torch.where(matched[..., None],
                         _encode(matched_gt, prior, pvar), 0.0).detach()
        loc_w = matched.to(torch.float32)
        loc_loss = _smooth_l1(loc - tb).sum(-1) * loc_w
        loss = conf_loss_weight * conf_loss + loc_loss_weight * loc_loss
        loss = loss.sum(1, keepdim=True)                         # [B, 1]
        if normalize:
            loss = loss / torch.clamp(loc_w.sum(), min=1.0)
        return loss.to(torch.float32)

    inputs = {"Loc": [location.name], "Conf": [confidence.name],
              "GTBox": [gt_box.name], "GTLabel": [gt_label.name],
              "PriorBox": [prior_box.name]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var.name]
    inputs["GTCount"] = [lenv.name]

    def fn_dispatch(loc, conf, gtb, gtl, prior, *rest):
        if prior_box_var is not None:
            return fn(loc, conf, gtb, gtl, prior, rest[0], rest[1])
        return fn(loc, conf, gtb, gtl, prior, None, rest[0])

    helper.append_op(type="ssd_loss", inputs=inputs,
                     outputs={"Loss": [out_v.name]},
                     attrs={"overlap_threshold": overlap_threshold,
                            "neg_pos_ratio": neg_pos_ratio},
                     fn=fn_dispatch)
    return out_v


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """SSD inference head: decode ``loc [B, P, 4]`` against the priors,
    softmax ``scores [B, P, C]``, multi-class NMS. Returns ``[B,
    keep_top_k, 6]`` rows (label, score, x1, y1, x2, y2); empty rows
    have label -1."""
    helper = LayerHelper("detection_output")
    out_v = helper.create_tmp_variable(np.float32)

    def fn(locv, sc, prior, pvar):
        decoded = _decode(locv, prior.reshape(-1, 4), pvar.reshape(-1, 4))
        # jax.nn.softmax's arithmetic
        e = torch.exp(sc - sc.amax(-1, keepdim=True))
        probs = e / e.sum(-1, keepdim=True)
        return _multiclass_nms(decoded, probs.transpose(1, 2),
                               score_threshold, nms_top_k, keep_top_k,
                               nms_threshold, background_label)

    helper.append_op(type="detection_output",
                     inputs={"Loc": [loc.name], "Scores": [scores.name],
                             "PriorBox": [prior_box.name],
                             "PriorBoxVar": [prior_box_var.name]},
                     outputs={"Out": [out_v.name]},
                     attrs={"nms_threshold": nms_threshold,
                            "keep_top_k": keep_top_k}, fn=fn)
    return out_v


def update_map_from_padded(m, det, lab):
    """Feed a padded detection batch into a ``metrics.DetectionMAP``.

    ``det`` [B, D, 6] (label, score, x1..y2; label<0 = padding); ``lab``
    [B, G, 6] (label, difficult, x1..y2) or [B, G, 5] without the
    difficult flag. Shared by the in-graph detection_map op and
    ``evaluator.DetectionMAP`` so both parse one layout."""
    det = np.asarray(det)
    lab = np.asarray(lab)
    for b in range(det.shape[0]):
        dets = [row.tolist() for row in det[b] if row[0] >= 0]
        gts = []
        for row in lab[b]:
            if row[0] < 0:
                continue
            if lab.shape[-1] >= 6:
                # (label, difficult, x1, y1, x2, y2) → evaluator order
                gts.append([row[0], row[2], row[3], row[4], row[5],
                            row[1]])
            else:
                gts.append(row.tolist())
        m.update(dets, gts)


def _host_scalar(compute, det, lab):
    """``compute(det, lab)`` of the host's copies, as an f32 scalar on
    ``det``'s device (a meta scalar on "meta": nothing to compute)."""
    if det.device.type == "meta":
        return torch.empty((), dtype=torch.float32, device="meta")
    value = compute(det.detach().cpu().numpy(), lab.detach().cpu().numpy())
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=det.device)


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral"):
    """The mAP of padded detections ``[B, D, 6]`` (label, score, x1,
    y1, x2, y2; label -1 empty) against padded ground truth ``[B, G,
    6]`` (label, difficult, x1, y1, x2, y2) or ``[B, G, 5]`` (label -1
    padding), computed on the host by ``metrics.DetectionMAP``. The op
    reads the device on the host (``_host_sync``); streaming
    accumulation is ``evaluator.DetectionMAP``'s or
    ``metrics.DetectionMAP``'s, so ``input_states``/``out_states`` are
    refused, as in the JAX package."""
    enforce(input_states is None and out_states is None,
            "In-graph mAP accumulation states are not supported; use "
            "metrics.DetectionMAP for streaming evaluation (it is the "
            "idiomatic host-side path here)")
    helper = LayerHelper("detection_map")
    out_v = helper.create_tmp_variable(np.float32)

    def host_map(det, lab):
        from ..metrics import DetectionMAP

        m = DetectionMAP(overlap_threshold=overlap_threshold,
                         evaluate_difficult=evaluate_difficult,
                         ap_version=ap_version)
        update_map_from_padded(m, det, lab)
        return m.eval()

    helper.append_op(type="detection_map",
                     inputs={"DetectRes": [detect_res.name],
                             "Label": [label.name]},
                     outputs={"MAP": [out_v.name]},
                     attrs={"overlap_threshold": overlap_threshold,
                            "ap_version": ap_version, "_host_sync": True},
                     fn=lambda det, lab: _host_scalar(host_map, det, lab))
    return out_v


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD's multi-scale heads: a ``prior_box`` and a location and a
    confidence conv per feature map. Returns (mbox_loc ``[B, sum HWP,
    4]``, mbox_conf ``[B, sum HWP, C]``, boxes ``[sum HWP, 4]``,
    variances ``[sum HWP, 4]``)."""
    from .conv import conv2d
    from .nn import concat, reshape, transpose

    enforce(len(inputs) == len(aspect_ratios),
            "inputs and aspect_ratios must have equal length")
    n_layer = len(inputs)
    if min_sizes is None:
        # per-layer sizes from the ratio range (the reference's formula)
        enforce(n_layer > 2 and min_ratio is not None
                and max_ratio is not None,
                "either min_sizes/max_sizes or min_ratio/max_ratio "
                "(with >2 inputs) must be given")
        min_sizes, max_sizes = [], []
        step = int(math.floor((max_ratio - min_ratio) / (n_layer - 2)))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes
        max_sizes = [base_size * 0.20] + max_sizes

    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        msize = min_sizes[i]
        msize = msize if isinstance(msize, (list, tuple)) else [msize]
        mxsize = None
        if max_sizes is not None:
            mxsize = max_sizes[i]
            mxsize = mxsize if isinstance(mxsize, (list, tuple)) \
                else [mxsize]
        ar = aspect_ratios[i]
        ar = list(ar) if isinstance(ar, (list, tuple)) else [ar]
        if steps is not None:
            st = steps[i]
            st = tuple(st) if isinstance(st, (list, tuple)) else (st, st)
        elif step_w is not None or step_h is not None:
            st = (step_w[i] if step_w else 0.0,
                  step_h[i] if step_h else 0.0)
        else:
            st = (0.0, 0.0)

        box, var = prior_box(
            feat, image, msize, mxsize, ar, list(variance), flip, clip,
            st, offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        n_priors = len(_prior_whs(list(msize), list(mxsize or []),
                                  _expand_ars(ar, flip),
                                  min_max_aspect_ratios_order))

        loc = conv2d(feat, num_filters=n_priors * 4,
                     filter_size=kernel_size, padding=pad, stride=stride)
        loc = transpose(loc, perm=[0, 2, 3, 1])        # NCHW → NHWC
        loc = reshape(loc, shape=[0, -1, 4])
        conf = conv2d(feat, num_filters=n_priors * num_classes,
                      filter_size=kernel_size, padding=pad, stride=stride)
        conf = transpose(conf, perm=[0, 2, 3, 1])
        conf = reshape(conf, shape=[0, -1, num_classes])

        locs.append(loc)
        confs.append(conf)
        boxes_all.append(reshape(box, shape=[-1, 4]))
        vars_all.append(reshape(var, shape=[-1, 4]))

    mbox_loc = locs[0] if n_layer == 1 else concat(locs, axis=1)
    mbox_conf = confs[0] if n_layer == 1 else concat(confs, axis=1)
    boxes = boxes_all[0] if n_layer == 1 else concat(boxes_all, axis=0)
    variances = vars_all[0] if n_layer == 1 else concat(vars_all, axis=0)
    return mbox_loc, mbox_conf, boxes, variances


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None,
                     offset=0.5, name=None):
    """Faster-RCNN anchors of a feature map, in image coordinates.
    Returns (anchors ``[H, W, A, 4]``, variances ``[H, W, A, 4]``);
    within each aspect ratio the sizes vary fastest (the reference's
    loop nest)."""
    enforce(isinstance(stride, (list, tuple)) and len(stride) == 2,
            "stride must be (stride_w, stride_h)")
    helper = LayerHelper("anchor_generator")
    anchors_v = helper.create_tmp_variable(np.float32)
    vars_v = helper.create_tmp_variable(np.float32)
    sizes = [float(s) for s in (
        anchor_sizes if isinstance(anchor_sizes, (list, tuple))
        else [anchor_sizes])]
    ratios = [float(r) for r in (
        aspect_ratios if isinstance(aspect_ratios, (list, tuple))
        else [aspect_ratios])]
    sw, sh = float(stride[0]), float(stride[1])
    whs = []
    for r in ratios:              # ratios outer…
        for s in sizes:           # …sizes fastest (reference order)
            w = math.sqrt(s * s / r)
            whs.append((w, w * r))
    cache = {}

    def fn(feat):
        H, W = feat.shape[2], feat.shape[3]

        def make():
            var = torch.tensor(variance, dtype=torch.float32).expand(
                H, W, len(whs), 4)
            return _grid_boxes(H, W, sw, sh, offset, whs), var

        return _constants(cache, (H, W), feat.device, make)

    helper.append_op(type="anchor_generator",
                     inputs={"Input": [input.name]},
                     outputs={"Anchors": [anchors_v.name],
                              "Variances": [vars_v.name]},
                     attrs={"anchor_sizes": sizes,
                            "aspect_ratios": ratios}, fn=fn)
    anchors_v.stop_gradient = True
    vars_v.stop_gradient = True
    return anchors_v, vars_v


def rpn_target_assign(loc, scores, anchor_box, gt_box,
                      rpn_batch_size_per_im=256, fg_fraction=0.25,
                      rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, gt_count=None):
    """RPN training targets, with the JAX package's static shapes: every
    image gives ``S = rpn_batch_size_per_im`` score samples and ``F =
    int(S * fg_fraction)`` location samples, chosen deterministically
    (foregrounds by highest IoU, then the highest-IoU backgrounds),
    surplus location rows zero on both sides. ``loc [B, M, 4]``,
    ``scores [B, M, C]``, ``anchor_box [M, 4]`` (or ``[H, W, A, 4]``),
    ``gt_box [B, G, 4]`` with an ``@LEN`` count (or ``gt_count [B]``).
    Returns (predicted scores ``[B*S, 1]``, predicted locations ``[B*F,
    4]``, target labels ``[B*S, 1]``, target boxes ``[B*F, 4]``)."""
    from .sequence import length_var_of

    helper = LayerHelper("rpn_target_assign")
    score_pred_v = helper.create_tmp_variable(np.float32)
    loc_pred_v = helper.create_tmp_variable(np.float32)
    tlabel_v = helper.create_tmp_variable(np.float32)
    tbbox_v = helper.create_tmp_variable(np.float32)
    lenv = gt_count if gt_count is not None else length_var_of(gt_box)
    enforce(lenv is not None,
            "rpn_target_assign needs per-image GT counts: declare gt_box "
            "with lod_level=1 or pass gt_count=")
    S = int(rpn_batch_size_per_im)
    F = max(int(S * fg_fraction), 1)

    def fn(locv, sc, anchors, gtb, n):
        anchors = anchors.reshape(-1, 4)
        B, G = gtb.shape[:2]
        M = anchors.shape[0]
        dev = locv.device
        gvalid = (torch.arange(G, device=dev)[None]
                  < n.reshape(-1).to(torch.int64)[:, None])     # [B, G]
        iou = torch.where(gvalid[..., None], _iou(gtb, anchors[None]),
                          -1.0)                                  # [B, G, M]
        max_per_anchor, gt_of_anchor = iou.max(1)                # [B, M]
        # (i) the best anchor of each real GT is positive whatever its
        # overlap
        best_anchor = iou.argmax(2)                              # [B, G]
        is_best = ((best_anchor[..., None]
                    == torch.arange(M, device=dev)) & gvalid[..., None]
                   ).any(1)
        pos = is_best | (max_per_anchor >= rpn_positive_overlap)
        neg = ((~pos) & (max_per_anchor < rpn_negative_overlap)
               & (max_per_anchor >= 0))
        fg_val, fg_idx = _top(torch.where(pos, max_per_anchor, -math.inf),
                              F)
        fg_ok = torch.isfinite(fg_val)
        n_fg = fg_ok.sum(1, keepdim=True)
        bg_val, bg_idx = _top(torch.where(neg, max_per_anchor, -math.inf),
                              min(S, M))
        n_bg = torch.isfinite(bg_val).sum(1, keepdim=True)
        # all S score slots: the first n_fg foregrounds, then backgrounds
        slot = torch.arange(S, device=dev)[None]
        take_fg = slot < n_fg
        idx_fg = fg_idx[:, torch.clamp(slot[0], 0, F - 1)]
        idx_bg = torch.gather(bg_idx, 1, torch.clamp(
            slot - n_fg, 0, bg_idx.shape[1] - 1))
        samp_idx = torch.where(take_fg, idx_fg, idx_bg)
        samp_ok = take_fg | ((slot - n_fg) < n_bg)
        sc_obj = sc[..., -1] if sc.dim() == 3 else sc
        score_pred = torch.where(samp_ok, torch.gather(sc_obj, 1, samp_idx),
                                 0.0)[..., None]
        tlabel = torch.where(samp_ok, take_fg.to(torch.float32),
                             0.0)[..., None]
        # locations: the matched GT encoded against the fg anchors
        a = anchors[fg_idx]                                      # [B, F, 4]
        g = torch.gather(gtb, 1, torch.gather(gt_of_anchor, 1, fg_idx)[
            ..., None].expand(B, F, 4))
        aw, ah, acx, acy = _centre_size(a)
        gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-6)
        gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-6)
        gcx = g[..., 0] + gw * 0.5
        gcy = g[..., 1] + gh * 0.5
        tb = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                          torch.log(gw / aw), torch.log(gh / ah)], -1)
        loc_pred = torch.where(fg_ok[..., None], torch.gather(
            locv, 1, fg_idx[..., None].expand(B, F, 4)), 0.0)
        tbbox = torch.where(fg_ok[..., None], tb, 0.0)
        return (score_pred.reshape(B * S, 1), loc_pred.reshape(B * F, 4),
                tlabel.reshape(B * S, 1).detach(),
                tbbox.reshape(B * F, 4).detach())

    helper.append_op(
        type="rpn_target_assign",
        inputs={"Loc": [loc.name], "Scores": [scores.name],
                "AnchorBox": [anchor_box.name], "GTBox": [gt_box.name],
                "GTCount": [lenv.name]},
        outputs={"PredScores": [score_pred_v.name],
                 "PredLoc": [loc_pred_v.name],
                 "TargetLabel": [tlabel_v.name],
                 "TargetBBox": [tbbox_v.name]},
        attrs={"rpn_batch_size_per_im": S, "fg_fraction": fg_fraction},
        fn=fn)
    return score_pred_v, loc_pred_v, tlabel_v, tbbox_v


__all__ = ["iou_similarity", "prior_box", "box_coder", "nms_jax",
           "multiclass_nms",
           "bipartite_match", "target_assign", "ssd_loss",
           "detection_output", "detection_map", "multi_box_head",
           "anchor_generator", "rpn_target_assign",
           "update_map_from_padded"]
