"""Host-side weighted averaging (counterpart of paddle_tpu/average.py;
reference: python/paddle/fluid/average.py).

A pure-Python accumulator: no program, no tensors, exactly like the
reference (which deprecates it in favor of ``fluid.metrics``)."""

from __future__ import annotations

import warnings

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number_or_matrix(var):
    return isinstance(var, (int, float, complex, np.ndarray)) and not \
        isinstance(var, bool)


class WeightedAverage:
    """Weighted running average: sum(value*weight)/sum(weight)
    (reference: average.py:38)."""

    def __init__(self):
        warnings.warn(
            "The %s is deprecated, please use fluid.metrics.Accuracy "
            "instead." % self.__class__.__name__, Warning)
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            raise ValueError(
                "The 'value' must be a number(int, float) or a numpy "
                "ndarray.")
        if not isinstance(weight, (int, float)):
            raise ValueError("The 'weight' must be a number(int, float).")
        if self.numerator is None or self.denominator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator += value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator is None:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage.")
        if self.denominator == 0:
            raise ValueError(
                "The denominator of WeightedAverage can not be 0.")
        return self.numerator / self.denominator
