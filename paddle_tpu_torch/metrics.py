"""Host-side streaming metrics (counterpart of paddle_tpu/metrics.py, a
copy of its numpy code; reference: python/paddle/fluid/metrics.py:49-538).
``DetectionMAP`` waits for the detection layers (ROADMAP Queue A 7,
step (e)) and raises."""

from __future__ import annotations

import numpy as np

from .core.enforce import not_ported


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
    """Mean average precision for detection: not ported yet."""

    def __init__(self, *a, **kw):
        raise not_ported("metrics.DetectionMAP (it pairs with the "
                         "detection layers)", "Queue A 7")
