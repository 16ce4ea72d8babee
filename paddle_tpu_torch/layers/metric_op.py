"""In-graph metric ops (counterpart of paddle_tpu/layers/metric_op.py):
``accuracy``, ``auc``, ``chunk_eval`` (over the padded sequences of
``layers/sequence.py``), ``mean_iou`` and ``precision_recall``."""

from __future__ import annotations

import torch

from ..layer_helper import LayerHelper


def accuracy(input, label, k: int = 1, correct=None, total=None):
    """Top-k accuracy of scores ``input`` against int labels: the share
    of rows whose label is among the ``k`` best (the lower index first
    among equal scores, as ``lax.top_k``)."""
    helper = LayerHelper("accuracy")
    out = helper.create_tmp_variable("float32", shape=())

    def fn(pred, y):
        idx = torch.sort(pred, dim=-1, descending=True,
                         stable=True)[1][..., :k]
        yv = y.to(torch.int64)
        if yv.dim() == pred.dim():
            yv = torch.squeeze(yv, -1)
        hit = torch.any(idx == yv[..., None], dim=-1)
        return torch.mean(hit.to(torch.float32))

    helper.append_op(type="accuracy",
                     inputs={"Out": [input.name], "Label": [label.name]},
                     outputs={"Accuracy": [out.name]}, attrs={"k": k}, fn=fn)
    return out


def auc(input, label, curve="ROC", num_thresholds=200, topk=1):
    """Single-batch ROC AUC by threshold binning: true and false
    positive rates at ``num_thresholds`` thresholds evenly spaced in
    [0, 1], then the trapezoid area under them."""
    helper = LayerHelper("auc")
    out = helper.create_tmp_variable("float32", shape=())

    def fn(pred, y):
        p = pred[..., -1] if pred.dim() > 1 else pred
        yv = torch.reshape(y.to(torch.float32), p.shape)
        # jnp.linspace(0, 1, n) bit for bit: i / (n - 1) rounded once
        thresholds = torch.arange(num_thresholds, dtype=torch.float32,
                                  device=p.device) / float(
                                      max(num_thresholds - 1, 1))
        predpos = (p[None, :] >= thresholds[:, None]).to(torch.float32)
        tp = torch.sum(predpos * yv[None, :], dim=1)
        fp = torch.sum(predpos * (1 - yv[None, :]), dim=1)
        pos = torch.sum(yv) + 1e-8
        neg = torch.sum(1 - yv) + 1e-8
        # the area over decreasing false positive rates
        return -torch.trapezoid(tp / pos, fp / neg)

    helper.append_op(type="auc",
                     inputs={"Predict": [input.name], "Label": [label.name]},
                     outputs={"AUC": [out.name]}, fn=fn)
    return out


# scheme -> (num_tag_types, tag_begin, tag_inside, tag_end, tag_single)
_CHUNK_SCHEMES = {
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _chunk_flags(labels, lengths, num_chunk_types, scheme):
    """Chunk boundaries of padded [B, T] tag ids, the reference's
    transition rules (operators/chunk_eval_op.h ChunkBegin/ChunkEnd) as
    per-position boolean algebra: tag = label % num_tag_types, type =
    label // num_tag_types; a position of type Other (num_chunk_types),
    or past its length, is in no chunk. Returns (begin [B, T] bool, the
    end position of the chunk beginning at each position [B, T], type
    [B, T])."""
    n_tags, t_beg, t_in, t_end, t_sgl = _CHUNK_SCHEMES[scheme]
    other = num_chunk_types
    B, T = labels.shape
    dev = labels.device
    valid = torch.arange(T, device=dev)[None, :] < \
        lengths.to(torch.int64).reshape(-1)[:, None]
    lab = labels.to(torch.int64)
    tag = lab % n_tags
    typ = torch.where(valid, lab // n_tags,
                      torch.full((), other, dtype=torch.int64, device=dev))

    def col(v):
        return torch.full((B, 1), v, dtype=torch.int64, device=dev)

    ptag = torch.cat([col(-1), tag[:, :-1]], dim=1)
    ptyp = torch.cat([col(other), typ[:, :-1]], dim=1)
    ntag = torch.cat([tag[:, 1:], col(-1)], dim=1)
    ntyp = torch.cat([typ[:, 1:], col(other)], dim=1)
    in_chunk = (typ != other) & valid
    begins_inside = ((tag == t_beg)
                     | ((tag == t_in) & ((ptag == t_end) | (ptag == t_sgl)))
                     | ((tag == t_end) & ((ptag == t_end) | (ptag == t_sgl)))
                     | (tag == t_sgl))
    beg = torch.where(ptyp == other, typ != other,
                      (typ != other) & ((typ != ptyp) | begins_inside))
    # the chunk open at i ends at i when the step into i+1 (past the end:
    # Other) closes it
    ends_inside = ((tag == t_end) | (tag == t_sgl)
                   | (((tag == t_beg) | (tag == t_in))
                      & ((ntag == t_beg) | (ntag == t_sgl))))
    end = (typ != other) & ((ntyp == other) | (ntyp != typ) | ends_inside)
    pos = torch.where(end & in_chunk, torch.arange(T, device=dev)[None, :],
                      torch.full((), T + 1, dtype=torch.int64, device=dev))
    # the nearest end at or after each position: a reversed running min
    end_pos = torch.flip(torch.cummin(torch.flip(pos, (1,)), dim=1)[0],
                         (1,))
    return beg & in_chunk, end_pos, typ


def chunk_eval(input, label, chunk_scheme: str, num_chunk_types: int,
               excluded_chunk_types=None, length=None):
    """Chunk-level precision, recall and F1 of padded [B, T] tag ids
    ``input`` against ``label`` with a length companion (or
    ``length=``): (precision, recall, f1, num_infer_chunks,
    num_label_chunks, num_correct_chunks), the reference op's six
    outputs (operators/chunk_eval_op.h)."""
    from .sequence import _require_len

    helper = LayerHelper("chunk_eval")
    excluded = sorted(set(excluded_chunk_types or []))
    lv = _require_len(input, length)
    outs = {n: helper.create_tmp_variable("float32")
            for n in ("Precision", "Recall", "F1")}
    counts = {n: helper.create_tmp_variable("int64")
              for n in ("NumInfer", "NumLabel", "NumCorrect")}

    def fn(inf, lab, lens):
        if inf.dim() == 3 and inf.shape[-1] == 1:
            inf = inf[..., 0]
        if lab.dim() == 3 and lab.shape[-1] == 1:
            lab = lab[..., 0]
        ib, ie, ity = _chunk_flags(inf, lens, num_chunk_types, chunk_scheme)
        lb, le, lty = _chunk_flags(lab, lens, num_chunk_types, chunk_scheme)

        def keep(ty):
            k = torch.ones(ty.shape, dtype=torch.bool, device=ty.device)
            for t in excluded:
                k = k & (ty != t)
            return k

        n_inf = (ib & keep(ity)).sum()
        n_lab = (lb & keep(lty)).sum()
        n_cor = (ib & lb & (ity == lty) & (ie == le) & keep(ity)).sum()
        zero = torch.zeros((), dtype=torch.float32, device=inf.device)
        p = torch.where(n_inf > 0, n_cor / torch.clamp(n_inf, min=1), zero)
        r = torch.where(n_lab > 0, n_cor / torch.clamp(n_lab, min=1), zero)
        f1 = torch.where(n_cor > 0, 2 * p * r / torch.clamp(p + r,
                                                            min=1e-12),
                         zero)
        return (p.to(torch.float32), r.to(torch.float32),
                f1.to(torch.float32), n_inf, n_lab, n_cor)

    helper.append_op(
        type="chunk_eval",
        inputs={"Inference": [input.name], "Label": [label.name],
                "Length": [lv.name]},
        outputs={"Precision": [outs["Precision"].name],
                 "Recall": [outs["Recall"].name],
                 "F1-Score": [outs["F1"].name],
                 "NumInferChunks": [counts["NumInfer"].name],
                 "NumLabelChunks": [counts["NumLabel"].name],
                 "NumCorrectChunks": [counts["NumCorrect"].name]},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": num_chunk_types,
               "excluded_chunk_types": excluded}, fn=fn)
    return (outs["Precision"], outs["Recall"], outs["F1"],
            counts["NumInfer"], counts["NumLabel"], counts["NumCorrect"])


def mean_iou(input, label, num_classes: int):
    """Mean intersection-over-union over the classes present, with the
    per-class wrong and correct counts: (mean_iou, out_wrong,
    out_correct). A miss counts against both the label's class and the
    prediction's."""
    helper = LayerHelper("mean_iou")
    miou = helper.create_tmp_variable("float32")
    wrong = helper.create_tmp_variable("int32")
    correct = helper.create_tmp_variable("int32")

    def fn(pred, lbl):
        pred = pred.to(torch.int64).reshape(-1)
        lbl = lbl.to(torch.int64).reshape(-1)
        hit = pred == lbl
        cls = torch.arange(num_classes, device=pred.device)
        pred_c = torch.sum(pred[None, :] == cls[:, None], dim=1)
        lbl_c = torch.sum(lbl[None, :] == cls[:, None], dim=1)
        cor_c = torch.sum((lbl[None, :] == cls[:, None]) & hit[None, :],
                          dim=1)
        union = pred_c + lbl_c - cor_c
        present = union > 0
        iou = torch.where(present, cor_c / torch.clamp(union, min=1),
                          torch.zeros((), device=pred.device))
        m = torch.sum(iou) / torch.clamp(torch.sum(present), min=1)
        wrong_c = (lbl_c - cor_c) + (pred_c - cor_c)
        return (m.to(torch.float32), wrong_c.to(torch.int32),
                cor_c.to(torch.int32))

    helper.append_op(type="mean_iou",
                     inputs={"Predictions": [input.name],
                             "Labels": [label.name]},
                     outputs={"OutMeanIou": [miou.name],
                              "OutWrong": [wrong.name],
                              "OutCorrect": [correct.name]},
                     attrs={"num_classes": num_classes}, fn=fn)
    return miou, wrong, correct


def _prf(tp, fp, fn_):
    """Precision, recall and F1 of (per-class or summed) counts, 0 where
    a denominator is 0."""
    zero = torch.zeros((), device=tp.device)
    p = torch.where(tp + fp > 0, tp / torch.clamp(tp + fp, min=1e-12), zero)
    r = torch.where(tp + fn_ > 0, tp / torch.clamp(tp + fn_, min=1e-12),
                    zero)
    f = torch.where(p + r > 0, 2 * p * r / torch.clamp(p + r, min=1e-12),
                    zero)
    return p, r, f


def precision_recall(input, label, num_classes: int, weights=None):
    """Multi-class precision, recall and F1 of the argmax of ``input``
    ``[B, C]`` against ``label``, as a ``[2, 3]`` tensor: rows (macro,
    micro), columns (precision, recall, F1)."""
    helper = LayerHelper("precision_recall")
    out = helper.create_tmp_variable("float32")

    def fn(scores, lbl, w=None):
        pred = torch.argmax(scores, dim=1)
        lbl = lbl.to(torch.int64).reshape(-1)
        wv = (torch.ones(lbl.shape, dtype=torch.float32, device=lbl.device)
              if w is None else w.to(torch.float32).reshape(-1))
        cls = torch.arange(num_classes, device=lbl.device)
        is_p = pred[None, :] == cls[:, None]      # [C, B]
        is_l = lbl[None, :] == cls[:, None]
        tp = torch.sum((is_p & is_l) * wv[None, :], dim=1)
        fp = torch.sum((is_p & ~is_l) * wv[None, :], dim=1)
        fn_ = torch.sum((~is_p & is_l) * wv[None, :], dim=1)
        mp, mr, mf = _prf(tp, fp, fn_)
        macro = torch.stack([torch.mean(mp), torch.mean(mr), torch.mean(mf)])
        micro = torch.stack(_prf(torch.sum(tp), torch.sum(fp),
                                 torch.sum(fn_)))
        return torch.stack([macro, micro]).to(torch.float32)

    inputs = {"MaxProbs": [input.name], "Labels": [label.name]}
    if weights is not None:
        inputs["Weights"] = [weights.name]
    helper.append_op(type="precision_recall", inputs=inputs,
                     outputs={"BatchMetrics": [out.name]},
                     attrs={"num_classes": num_classes}, fn=fn)
    out.shape = (2, 3)
    return out
