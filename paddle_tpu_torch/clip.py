"""Gradient and error clipping (counterpart of paddle_tpu/clip.py)."""

from __future__ import annotations

import warnings

import torch

from .core.program import Parameter, default_main_program


class BaseGradientClipAttr:
    def _clip_one(self, g, p):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    pass


class GradientClipByValue(BaseGradientClipAttr):
    """Clip each gradient element to [min, max]."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _clip_one(self, g, p):
        return torch.clamp(g, self.min, self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    """Per-tensor L2-norm clip."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip_one(self, g, p):
        norm = torch.sqrt(torch.sum(torch.square(g)))
        return g * torch.clamp(self.clip_norm / norm.clamp_min(1e-12),
                               max=1.0)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Joint L2-norm clip over every gradient carrying this attr."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm


def set_gradient_clip(clip, param_list=None, program=None):
    """Store the clip attr on parameters for append_gradient_clip_ops."""
    if not isinstance(clip, BaseGradientClipAttr):
        raise TypeError(
            "set_gradient_clip expects a BaseGradientClipAttr (e.g. "
            "GradientClipByGlobalNorm); got %r" % type(clip).__name__)
    program = program or default_main_program()
    gb = program.global_block()
    params = (gb.all_parameters() if param_list is None else
              [gb.var(p if isinstance(p, str) else p.name)
               for p in param_list])
    for p in params:
        p.gradient_clip = clip


def append_gradient_clip_ops(params_grads):
    """Apply per-parameter clip attrs; global-norm clips act jointly. A
    row-sparse gradient passes through unclipped, with a warning:
    duplicate rows make its value-space norm differ from the dense
    gradient's, and the reference does not clip it either."""
    if not params_grads:
        return params_grads
    block = params_grads[0][0].block.program.global_block()

    global_norm_groups = {}  # clip -> list of result indices
    out = []
    for i, (p, g) in enumerate(params_grads):
        clip = p.gradient_clip if isinstance(p, Parameter) else None
        if g is None or clip is None or isinstance(clip,
                                                   NullGradientClipAttr):
            out.append((p, g))
        elif getattr(g, "is_sparse_rows", False):
            warnings.warn(
                f"gradient clip skipped for sparse gradient of {p.name!r}")
            out.append((p, g))
        elif isinstance(clip, GradientClipByGlobalNorm):
            global_norm_groups.setdefault(clip, []).append(i)
            out.append((p, g))  # replaced below
        else:
            ng = block.create_var(name=g.name + "@CLIP", shape=g.shape,
                                  dtype=g.dtype)
            block.append_op(type="clip_grad",
                            inputs={"Grad": [g.name], "Param": [p.name]},
                            outputs={"Out": [ng.name]}, fn=clip._clip_one)
            out.append((p, ng))

    for clip, indices in global_norm_groups.items():
        grads = [params_grads[i][1] for i in indices]
        new_vars = [block.create_var(name=g.name + "@CLIP", shape=g.shape,
                                     dtype=g.dtype) for g in grads]
        cn = clip.clip_norm

        def fn(*gs, _cn=cn):
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in gs))
            scale = torch.clamp(_cn / gnorm.clamp_min(1e-12), max=1.0)
            return tuple(g * scale for g in gs)

        block.append_op(type="clip_by_global_norm",
                        inputs={"Grads": [g.name for g in grads]},
                        outputs={"Out": [v.name for v in new_vars]}, fn=fn)
        for i, nv in zip(indices, new_vars):
            out[i] = (out[i][0], nv)
    return out


class ErrorClipByValue:
    """Clips the error (the cotangent flowing backward through a
    variable), not the parameter gradient: set ``var.error_clip =
    ErrorClipByValue(max=...)`` before ``append_backward``, which clips
    that var's cotangent inside the backward pass."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def bounds(self):
        return float(self.min), float(self.max)
