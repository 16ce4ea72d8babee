"""In-graph evaluators with accumulated state (counterpart of
paddle_tpu/evaluator.py; reference: python/paddle/fluid/evaluator.py:42
Evaluator and its ChunkEvaluator / EditDistance / Accuracy subclasses).

The metric state lives in persistable variables that ops of the
training program update each minibatch (the executor writes persistable
op outputs back to the scope), so one step updates the model and the
metric state; ``reset()`` zeroes them with a small program and
``eval()`` reads them. ``metrics.*`` is the host-side alternative;
``DetectionMAP`` keeps its statistics in one, updated by a host op."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import layers
from .core import unique_name
from .core.program import Program, Variable, program_guard
from .layer_helper import LayerHelper


class Evaluator:
    """reference: evaluator.py:42."""

    def __init__(self, name: str, **kwargs):
        self.helper = LayerHelper(name, **kwargs)
        self.states: List[Variable] = []
        self.metrics: List[Variable] = []

    def _create_state(self, suffix: str, dtype, shape) -> Variable:
        state = layers.create_global_var(
            shape=list(shape), value=0.0, dtype=dtype, persistable=True,
            name=unique_name.generate(
                f"{self.helper.layer_type}.{suffix}"))
        self.states.append(state)
        return state

    def _accumulate(self, state: Variable, delta: Variable) -> None:
        """state += delta, written back to the persistable state var."""
        summed = layers.elementwise_add(
            x=state, y=layers.cast(delta, state.dtype))
        layers.assign(summed, output=state)

    def reset(self, executor, reset_program: Optional[Program] = None):
        """Zero all states (reference: evaluator.py reset)."""
        if reset_program is None:
            reset_program = Program()
        with program_guard(reset_program):
            gb = reset_program.global_block()
            for state in self.states:
                # re-declare the state symbol here so the executor's
                # persistable write-back targets it in this program too
                v = gb.create_var(name=state.name, shape=state.shape,
                                  dtype=state.dtype, persistable=True)
                zeros = layers.fill_constant(
                    shape=[int(s) for s in state.shape],
                    dtype=state.dtype, value=0.0)
                layers.assign(zeros, output=v)
        executor.run(reset_program)

    def eval(self, executor, eval_program: Optional[Program] = None):
        raise NotImplementedError


class ChunkEvaluator(Evaluator):
    """Accumulated chunk precision/recall/F1 over batches (reference:
    evaluator.py ChunkEvaluator over chunk_eval's Num*Chunks outputs —
    the SRL book chapter's evaluation)."""

    def __init__(self, input, label, chunk_scheme: str,
                 num_chunk_types: int, excluded_chunk_types=None):
        super().__init__("chunk_evaluator")
        (precision, recall, f1, n_infer, n_label,
         n_correct) = layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types)
        self.num_infer_chunks = self._create_state(
            "num_infer", "int64", [])
        self.num_label_chunks = self._create_state(
            "num_label", "int64", [])
        self.num_correct_chunks = self._create_state(
            "num_correct", "int64", [])
        self._accumulate(self.num_infer_chunks, n_infer)
        self._accumulate(self.num_label_chunks, n_label)
        self._accumulate(self.num_correct_chunks, n_correct)
        self.metrics.extend([precision, recall, f1])

    def eval(self, executor, eval_program: Optional[Program] = None):
        ni, nl, nc = [float(np.ravel(v)[0]) for v in executor.run(
            eval_program or Program(),
            fetch_list=[s.name for s in self.states])]
        precision = nc / ni if ni else 0.0
        recall = nc / nl if nl else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if nc else 0.0)
        return np.array(precision), np.array(recall), np.array(f1)


class EditDistance(Evaluator):
    """Accumulated average edit distance + instance error rate
    (reference: evaluator.py EditDistance). ``edit_distance`` returns
    ([B, 1] distances, [B] per-sequence error indicator); the states are
    Σdistance, Σsequences, Σerrored-sequences."""

    def __init__(self, input, label, ignored_tokens=None,
                 normalized: bool = True):
        super().__init__("edit_distance_evaluator")
        distances, seq_err = layers.edit_distance(
            input, label, normalized=normalized,
            ignored_tokens=ignored_tokens)
        self.total_distance = self._create_state(
            "total_distance", "float32", [])
        self.seq_num = self._create_state("seq_num", "int64", [])
        self.instance_error = self._create_state(
            "instance_error", "int64", [])
        self._accumulate(self.total_distance,
                         layers.reduce_sum(distances))
        batch = layers.slice(layers.cast(layers.shape(distances),
                                         "int64"),
                             axes=[0], starts=[0], ends=[1])
        self._accumulate(self.seq_num, layers.reduce_sum(batch))
        self._accumulate(self.instance_error,
                         layers.reduce_sum(seq_err))
        self.metrics.append(distances)

    def eval(self, executor, eval_program: Optional[Program] = None):
        td, sn, ie = [float(np.ravel(v)[0]) for v in executor.run(
            eval_program or Program(),
            fetch_list=[s.name for s in self.states])]
        sn = max(sn, 1.0)
        return (np.array(td / sn, "float32"),
                np.array(ie / sn, "float32"))


class Accuracy(Evaluator):
    """Accumulated top-k accuracy (reference: evaluator.py Accuracy)."""

    def __init__(self, input, label, k: int = 1):
        super().__init__("accuracy_evaluator")
        acc = layers.accuracy(input=input, label=label, k=k)
        # exact integer hit count in-graph — reconstructing it from the
        # float mean (acc * B) undercounts when rounding lands below the
        # integer (5 * fl(1/25) * 25 == 4.9999995)
        _, top_idx = layers.topk(input, k=k)
        lbl = layers.reshape(layers.cast(label, top_idx.dtype),
                             shape=[-1, 1])
        hit = layers.reduce_max(
            layers.cast(layers.equal(top_idx, lbl), "int64"), dim=1)
        batch = layers.slice(layers.cast(layers.shape(input), "int64"),
                             axes=[0], starts=[0], ends=[1])
        self.total = self._create_state("total", "int64", [])
        self.correct = self._create_state("correct", "int64", [])
        self._accumulate(self.total, layers.reduce_sum(batch))
        self._accumulate(self.correct, layers.reduce_sum(hit))
        self.metrics.append(acc)

    def eval(self, executor, eval_program: Optional[Program] = None):
        total, correct = [float(np.ravel(v)[0]) for v in executor.run(
            eval_program or Program(),
            fetch_list=[s.name for s in self.states])]
        return np.array(correct / max(total, 1.0), "float32")


class DetectionMAP(Evaluator):
    """Accumulated detection mean average precision (reference:
    evaluator.py:296 DetectionMAP over detection_map ops).

    ``get_map_var()`` returns (cur_map, accum_map): the batch's mAP (the
    ``detection_map`` op) and the mAP accumulated since the last
    ``reset`` (a ``detection_map_accum`` op updating a host-side
    ``metrics.DetectionMAP``, once per executed run). Both ops read the
    device on the host (``_host_sync``): run the program with
    ``Executor.run``.

    Inputs follow the padded detection layout (layers/detection.py):
    ``input`` [B, D, 6] (label, score, x1, y1, x2, y2; label<0 = padding),
    ``gt_label`` [B, G, 1], ``gt_box`` [B, G, 4], optional
    ``gt_difficult`` [B, G, 1]."""

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral"):
        super().__init__("map_eval")
        from .layers.detection import _host_scalar, update_map_from_padded
        from .metrics import DetectionMAP as _HostMAP

        self._host = _HostMAP(overlap_threshold=overlap_threshold,
                              evaluate_difficult=evaluate_difficult,
                              ap_version=ap_version)

        gt_label = layers.cast(gt_label, gt_box.dtype)
        if gt_difficult is not None:
            gt_difficult = layers.cast(gt_difficult, gt_box.dtype)
            label = layers.concat([gt_label, gt_difficult, gt_box],
                                  axis=-1)
        else:
            label = layers.concat([gt_label, gt_box], axis=-1)

        self.cur_map = layers.detection_map(
            input, label, class_num, background_label,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult, ap_version=ap_version)

        out = self.helper.create_tmp_variable(np.float32)
        host = self._host

        def host_accum(det, lab):
            update_map_from_padded(host, det, lab)
            # the mAP of everything accumulated since reset()
            return host.eval()

        self.helper.append_op(
            type="detection_map_accum",
            inputs={"DetectRes": [input.name], "Label": [label.name]},
            outputs={"AccumMAP": [out.name]},
            attrs={"ap_version": ap_version, "_host_sync": True},
            fn=lambda det, lab: _host_scalar(host_accum, det, lab))
        self.accum_map = out
        self.metrics.extend([self.cur_map, self.accum_map])

    def get_map_var(self):
        """reference: evaluator.py get_map_var."""
        return self.cur_map, self.accum_map

    def reset(self, executor=None, reset_program=None):
        """Zero the accumulated statistics (host-side state; the executor
        arg is accepted for reference-API compatibility)."""
        self._host.reset()
