"""In-graph metric ops (counterpart of paddle_tpu/layers/metric_op.py):
``accuracy``, ``auc``, ``mean_iou`` and ``precision_recall``.
``chunk_eval`` reads the padded-sequence lengths of
``layers/sequence.py``, which is not ported yet."""

from __future__ import annotations

import torch

from ..core.enforce import not_ported
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


def chunk_eval(input, label, chunk_scheme: str, num_chunk_types: int,
               excluded_chunk_types=None, length=None):
    raise not_ported("chunk_eval (it reads layers/sequence.py's lengths)",
                     "Queue A 7, sequences")


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
