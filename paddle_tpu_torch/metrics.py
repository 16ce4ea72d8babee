"""Host-side streaming metrics (counterpart of paddle_tpu/metrics.py, a
copy of its numpy code; reference: python/paddle/fluid/metrics.py:49-538).
``DetectionMAP`` is also the mAP of the in-graph ``detection_map`` op and
of ``evaluator.DetectionMAP``."""

from __future__ import annotations

import numpy as np



class MetricBase:
    """reference: metrics.py:49."""

    def __init__(self, name=None):
        self._name = name or type(self).__name__

    def reset(self):
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            if isinstance(v, (int, float)):
                setattr(self, k, 0 if isinstance(v, int) else 0.0)
            elif isinstance(v, list):
                setattr(self, k, [])

    def update(self, *a, **kw):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    def get_config(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}


class CompositeMetric(MetricBase):
    """reference: metrics.py CompositeMetric."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    """reference: metrics.py Precision (binary)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0.0
        self.fp = 0.0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).ravel()
        labels = np.asarray(labels).astype(int).ravel()
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        ap = self.tp + self.fp
        return self.tp / ap if ap else 0.0


class Recall(MetricBase):
    """reference: metrics.py Recall."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0.0
        self.fn = 0.0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(int).ravel()
        labels = np.asarray(labels).astype(int).ravel()
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Accuracy(MetricBase):
    """reference: metrics.py Accuracy — weighted streaming mean of batch
    accuracies."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(value) * weight
        self.weight += weight

    def eval(self):
        return self.value / self.weight if self.weight else 0.0


class ChunkEvaluator(MetricBase):
    """Chunk F1 (reference: metrics.py ChunkEvaluator; pairs with the
    chunk_eval op for NER-style tasks)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(num_infer_chunks)
        self.num_label_chunks += int(num_label_chunks)
        self.num_correct_chunks += int(num_correct_chunks)

    def eval(self):
        p = (self.num_correct_chunks / self.num_infer_chunks
             if self.num_infer_chunks else 0.0)
        r = (self.num_correct_chunks / self.num_label_chunks
             if self.num_label_chunks else 0.0)
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        return p, r, f1


class EditDistance(MetricBase):
    """reference: metrics.py EditDistance."""

    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        d = np.asarray(distances, float)
        self.total_distance += float(d.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(d != 0))

    def eval(self):
        if not self.seq_num:
            return 0.0, 0.0
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class Auc(MetricBase):
    """Streaming AUC by threshold binning (reference: metrics.py Auc)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=200):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self.tp_list = np.zeros((num_thresholds,))
        self.fn_list = np.zeros((num_thresholds,))
        self.tn_list = np.zeros((num_thresholds,))
        self.fp_list = np.zeros((num_thresholds,))

    def reset(self):
        n = self._num_thresholds
        self.tp_list = np.zeros((n,))
        self.fn_list = np.zeros((n,))
        self.tn_list = np.zeros((n,))
        self.fp_list = np.zeros((n,))

    def update(self, preds, labels):
        preds = np.asarray(preds)
        p = preds[:, -1] if preds.ndim > 1 else preds
        y = np.asarray(labels).astype(int).ravel()
        thr = np.linspace(0.0, 1.0, self._num_thresholds)
        for i, t in enumerate(thr):
            pred_pos = p >= t
            self.tp_list[i] += np.sum(pred_pos & (y == 1))
            self.fp_list[i] += np.sum(pred_pos & (y == 0))
            self.tn_list[i] += np.sum(~pred_pos & (y == 0))
            self.fn_list[i] += np.sum(~pred_pos & (y == 1))

    def eval(self):
        tpr = self.tp_list / np.maximum(self.tp_list + self.fn_list, 1e-8)
        fpr = self.fp_list / np.maximum(self.fp_list + self.tn_list, 1e-8)
        order = np.argsort(fpr)
        return float(np.trapezoid(tpr[order], fpr[order]))


class DetectionMAP(MetricBase):
    """Mean average precision for detection (reference: metrics.py
    DetectionMAP, operators/detection_map_op.cc). 11-point interpolated
    or integral AP, averaged over classes.

    update() takes per-image detections [[label, score, x1, y1, x2, y2]]
    and ground truths [[label, x1, y1, x2, y2]] or
    [[label, x1, y1, x2, y2, difficult]]; with evaluate_difficult=False
    (the reference default) difficult GT boxes are excluded from the mAP
    denominator and matching them neither helps nor hurts."""

    def __init__(self, name=None, overlap_threshold=0.5,
                 evaluate_difficult=False, ap_version="integral"):
        super().__init__(name)
        self.overlap_threshold = overlap_threshold
        self.evaluate_difficult = evaluate_difficult
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        self._dets = {}    # class -> [(score, matched)]
        self._n_gt = {}    # class -> count

    @staticmethod
    def _iou(a, b):
        ax1, ay1, ax2, ay2 = a
        bx1, by1, bx2, by2 = b
        ix = max(0.0, min(ax2, bx2) - max(ax1, bx1))
        iy = max(0.0, min(ay2, by2) - max(ay1, by1))
        inter = ix * iy
        ua = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
        return inter / ua if ua > 0 else 0.0

    def update(self, detections, ground_truths):
        gts_by_cls = {}
        for g in ground_truths:
            c = int(g[0])
            difficult = bool(g[5]) if len(g) > 5 else False
            gts_by_cls.setdefault(c, []).append(
                [list(g[1:5]), False, difficult])
            if self.evaluate_difficult or not difficult:
                self._n_gt[c] = self._n_gt.get(c, 0) + 1
        for d in sorted(detections, key=lambda r: -r[1]):
            c, score = int(d[0]), float(d[1])
            box = list(d[2:])
            best, best_i = 0.0, -1
            for i, (gbox, used, diff) in enumerate(gts_by_cls.get(c, [])):
                o = self._iou(box, gbox)
                if o > best:
                    best, best_i = o, i
            if best >= self.overlap_threshold and best_i >= 0:
                gbox, used, diff = gts_by_cls[c][best_i]
                if diff and not self.evaluate_difficult:
                    continue  # matches to difficult GT are ignored entirely
                matched = not used
                gts_by_cls[c][best_i][1] = True
            else:
                matched = False
            self._dets.setdefault(c, []).append((score, matched))

    def eval(self):
        aps = []
        for c, n_gt in self._n_gt.items():
            dets = sorted(self._dets.get(c, []), key=lambda r: -r[0])
            if not dets or n_gt == 0:
                aps.append(0.0)
                continue
            tp = np.cumsum([1.0 if m else 0.0 for _, m in dets])
            fp = np.cumsum([0.0 if m else 1.0 for _, m in dets])
            rec = tp / n_gt
            prec = tp / np.maximum(tp + fp, 1e-8)
            if self.ap_version == "11point":
                ap = float(np.mean([
                    max([p for r, p in zip(rec, prec) if r >= t],
                        default=0.0)
                    for t in np.linspace(0, 1, 11)]))
            else:  # integral
                ap = 0.0
                prev_r = 0.0
                for r, p in zip(rec, prec):
                    ap += (r - prev_r) * p
                    prev_r = r
                ap = float(ap)
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0
