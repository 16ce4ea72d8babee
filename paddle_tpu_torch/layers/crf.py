"""Linear-chain CRF: the negative log-likelihood and Viterbi decoding
(counterpart of paddle_tpu/layers/crf.py; reference:
operators/linear_chain_crf_op.cc, crf_decoding_op.cc).

The forward (log-sum-exp) and Viterbi (max-product) recursions walk
the padded time axis (``core.scan``) with per-example length masks, as
the JAX package's ``lax.scan``. The transition parameter is laid out as
the reference's: row 0 start weights, row 1 stop weights, rows 2.. the
[tag_from, tag_to] matrix, shape [num_tags + 2, num_tags].
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import initializer as init
from ..core import unique_name
from ..core.enforce import enforce
from ..core.scan import scan
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .sequence import length_var_of


def _lens_or_full(lens, em):
    if lens is None:
        return torch.full((em.shape[0],), em.shape[1], dtype=torch.int64,
                          device=em.device)
    return lens.to(torch.int64).reshape(-1)


def _crf_log_z(emission, lengths, transition):
    """The log partition function per example: the forward algorithm
    over [B, T, N] emissions."""
    start, stop, trans = transition[0], transition[1], transition[2:]
    T = emission.shape[1]
    alpha0 = start[None, :] + emission[:, 0, :]
    valid = (torch.arange(1, T, device=emission.device)[:, None]
             < lengths[None, :])                          # [T-1, B]

    def fwd(alpha, e_t, v):
        new = torch.logsumexp(alpha[:, :, None] + trans[None, :, :],
                              dim=1) + e_t
        return torch.where(v[:, None], new, alpha), ()

    if T > 1:
        alpha, _ = scan(fwd, alpha0,
                        (emission[:, 1:, :].transpose(0, 1), valid))
    else:
        alpha = alpha0
    return torch.logsumexp(alpha + stop[None, :], dim=1)


def _crf_path_score(emission, label, lengths, transition):
    """The score of the labelled path per example."""
    T = emission.shape[1]
    start, stop, trans = transition[0], transition[1], transition[2:]
    lbl = label.to(torch.int64)
    if lbl.dim() == 3:
        lbl = lbl.squeeze(-1)
    t_idx = torch.arange(T, device=emission.device)
    zero = torch.zeros((), dtype=emission.dtype, device=emission.device)
    unary = torch.take_along_dim(emission, lbl[..., None], dim=2)[..., 0]
    unary = torch.where(t_idx[None, :] < lengths[:, None], unary,
                        zero).sum(dim=1)
    pair = trans[lbl[:, :-1], lbl[:, 1:]]                 # [B, T-1]
    pair = torch.where(t_idx[None, 1:] < lengths[:, None], pair,
                       zero).sum(dim=1)
    last_idx = torch.clamp(lengths - 1, 0, T - 1)
    last_tag = torch.take_along_dim(lbl, last_idx[:, None], dim=1)[:, 0]
    return start[lbl[:, 0]] + unary + pair + stop[last_tag]


def linear_chain_crf(input, label, param_attr=None, length=None):
    """CRF negative log-likelihood of [B, T, N] emissions (a sequence
    var) and [B, T] int tags: [B, 1]. The transition parameter is
    ``crf_transition*`` [N+2, N] unless ``param_attr`` names it."""
    helper = LayerHelper("linear_chain_crf")
    N = input.shape[-1]
    attr = ParamAttr._to_attr(param_attr)
    if attr.name is None:
        attr.name = unique_name.generate("crf_transition")
    transition = helper.create_parameter(
        attr, [N + 2, N], input.dtype,
        default_initializer=init.Uniform(-0.1, 0.1))
    out = helper.create_tmp_variable(input.dtype)
    len_var = length or length_var_of(input)
    inputs = {"Emission": [input.name], "Label": [label.name],
              "Transition": [transition.name]}
    if len_var is not None:
        inputs["Length"] = [len_var.name]

    def fn(em, lbl, trans, lens=None):
        lens = _lens_or_full(lens, em)
        log_z = _crf_log_z(em, lens, trans)
        return (log_z - _crf_path_score(em, lbl, lens, trans))[:, None]

    helper.append_op(type="linear_chain_crf", inputs=inputs,
                     outputs={"LogLikelihood": [out.name]}, fn=fn)
    out.shape = (input.shape[0], 1) if input.shape else None
    out._crf_transition = transition
    return out


def viterbi(em, trans, lens):
    """Best tag paths [B, T] (int64; 0 past each length) of emissions
    [B, T, N] under ``trans`` [N+2, N]. Ties pick the lower tag, as
    ``jnp.argmax``."""
    B, T, N = em.shape
    start, stop, tr = trans[0], trans[1], trans[2:]
    ident = torch.arange(N, device=em.device)[None, :]
    delta0 = start[None, :] + em[:, 0, :]

    def vit(delta, e_t, v):
        scores = delta[:, :, None] + tr[None, :, :]       # [B, N, N]
        new = torch.amax(scores, dim=1) + e_t
        best_prev = torch.argmax(scores, dim=1)           # [B, N]
        return (torch.where(v[:, None], new, delta),
                (torch.where(v[:, None], best_prev, ident),))

    valid = (torch.arange(1, T, device=em.device)[:, None] < lens[None, :])
    if T > 1:
        delta, (bps,) = scan(vit, delta0, (em[:, 1:, :].transpose(0, 1),
                                           valid))
    else:
        delta, bps = delta0, None
    last = torch.argmax(delta + stop[None, :], dim=1)     # [B]

    def back(tag, bp):
        prev = torch.take_along_dim(bp, tag[:, None], dim=1)[:, 0]
        return prev, (prev,)

    if bps is not None:
        _, (path_rev,) = scan(back, last, (bps,), reverse=True)
        path = torch.cat([path_rev.transpose(0, 1), last[:, None]], dim=1)
    else:
        path = last[:, None]
    mask = torch.arange(T, device=em.device)[None, :] < lens[:, None]
    return torch.where(mask, path, torch.zeros((), dtype=path.dtype,
                                                device=path.device))


def crf_decoding(input, param_attr=None, label=None, length=None,
                 transition=None):
    """Viterbi decoding of [B, T, N] emissions: the best tag paths
    [B, T] (0 past each length); with ``label``, 0/1 per step for
    whether the path's tag is the label, as the reference. The
    transition is ``transition``, the parameter ``param_attr`` names
    (shared with the linear_chain_crf that made it), or the program's
    only ``crf_transition*``."""
    helper = LayerHelper("crf_decoding")
    gb = helper.main_program.global_block()
    if transition is not None:
        trans_var = transition
    else:
        attr = ParamAttr._to_attr(param_attr)
        if attr.name is not None:
            trans_var = gb.vars.get(attr.name)
            enforce(trans_var is not None,
                    f"crf_decoding: no parameter named '{attr.name}' — "
                    "build linear_chain_crf with the same param_attr first")
        else:
            cands = [v for n, v in gb.vars.items()
                     if n.startswith("crf_transition")]
            enforce(cands, "crf_decoding: no transition parameter found — "
                           "pass transition=/param_attr or build "
                           "linear_chain_crf first")
            enforce(len(cands) == 1,
                    "crf_decoding: multiple CRF transition parameters in "
                    "this program — disambiguate with param_attr=ParamAttr("
                    "name=...) or transition=")
            trans_var = cands[-1]
    out = helper.create_tmp_variable(np.int64)
    len_var = length or length_var_of(input)
    inputs = {"Emission": [input.name], "Transition": [trans_var.name]}
    if label is not None:
        inputs["Label"] = [label.name]
    if len_var is not None:
        inputs["Length"] = [len_var.name]
    has_label = label is not None

    def fn(em, trans, *rest):
        lbl = rest[0] if has_label else None
        lens = rest[-1] if len(rest) > int(has_label) else None
        path = viterbi(em, trans, _lens_or_full(lens, em))
        if lbl is None:
            return path
        if lbl.dim() == 3:
            lbl = lbl.squeeze(-1)
        return (path == lbl.to(torch.int64)).to(torch.int64)

    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [out.name]}, fn=fn)
    return out


__all__ = ["linear_chain_crf", "crf_decoding"]
