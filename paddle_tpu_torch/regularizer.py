"""Weight-decay regularizers (counterpart of paddle_tpu/regularizer.py)."""

from __future__ import annotations

import warnings

import torch

from .core.program import Parameter


class WeightDecayRegularizer:
    def _grad_fn(self):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    """grad + coeff * param."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _grad_fn(self):
        c = self._coeff
        return lambda g, p: g + c * p


class L1Decay(WeightDecayRegularizer):
    """grad + coeff * sign(param)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _grad_fn(self):
        c = self._coeff
        return lambda g, p: g + c * torch.sign(p)


L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay


def append_regularization_ops(params_grads, regularization=None):
    """Add decay terms to gradients. A parameter's own regularizer (set
    on its ParamAttr) overrides the global one. A row-sparse gradient
    passes through undecayed, with a warning, as in the reference:
    decaying only the touched rows would be wrong, and densifying would
    defeat the sparse path."""
    out = []
    for p, g in params_grads:
        reg = p.regularizer if isinstance(p, Parameter) and p.regularizer \
            else regularization
        if g is None or reg is None:
            out.append((p, g))
            continue
        if getattr(g, "is_sparse_rows", False):
            warnings.warn(
                f"regularization skipped for sparse gradient of {p.name!r} "
                "(reference behavior for SelectedRows grads)")
            out.append((p, g))
            continue
        block = p.block.program.global_block()
        new_g = block.create_var(name=g.name + "@REG", shape=g.shape,
                                 dtype=g.dtype)
        block.append_op(type="regularize",
                        inputs={"Grad": [g.name], "Param": [p.name]},
                        outputs={"Out": [new_g.name]}, fn=reg._grad_fn())
        out.append((p, new_g))
    return out
