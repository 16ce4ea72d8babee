"""CTC loss (warpctc), edit distance and greedy CTC decoding
(counterpart of paddle_tpu/layers/ctc.py; reference:
operators/warpctc_op.cc over Baidu's warp-ctc, edit_distance_op.cc,
layers/nn.py ctc_greedy_decoder).

The CTC alpha recursion walks the padded time axis (``core.scan``) for
the whole batch at once, as the JAX package's ``lax.scan``; blank is
label 0, labels are 1..C-1, as warpctc's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.scan import scan
from ..layer_helper import LayerHelper
from .sequence import _require_len, _seq_mask, length_var_of

_NEG = -1e30


def _ctc_loss(log_probs, logit_lens, labels, label_lens, blank=0):
    """Negative log-likelihood [B] of (0-padded) ``labels`` [B, S] under
    log-softmaxed ``log_probs`` [B, T, C]."""
    B, T, C = log_probs.shape
    S = labels.shape[1]
    L = 2 * S + 1
    dev, dt = log_probs.device, log_probs.dtype
    labels = labels.to(torch.int64)
    logit_lens = logit_lens.to(torch.int64).reshape(-1)
    label_lens = label_lens.to(torch.int64).reshape(-1)
    neg = torch.full((), _NEG, dtype=dt, device=dev)
    # the extended sequence: blank, l1, blank, l2, ..., blank
    ext = torch.full((B, L), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    ext_m2 = F.pad(ext, (2, 0), value=blank)[:, :L]
    # a label may skip the blank before it when it differs from ext[s-2]
    can_skip = (ext != blank) & (ext != ext_m2)

    lp0 = log_probs[:, 0, :]
    first = [torch.take_along_dim(lp0, ext[:, 0:1], dim=1)]
    if L > 1:
        first.append(torch.where(
            label_lens[:, None] > 0,
            torch.take_along_dim(lp0, ext[:, 1:2], dim=1), neg))
    alpha0 = torch.cat(first + [neg.expand(B, max(L - 2, 0))], dim=1)

    def lse3(a, b, c):
        m = torch.maximum(torch.maximum(a, b), c)
        live = m > _NEG / 2
        m_safe = torch.where(live, m, torch.zeros((), dtype=dt, device=dev))
        out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                                 + torch.exp(c - m_safe))
        return torch.where(live, out, neg)

    def step(alpha, lp_t, valid):
        a_m1 = F.pad(alpha, (1, 0), value=_NEG)[:, :L]
        a_m2 = torch.where(can_skip, F.pad(alpha, (2, 0), value=_NEG)[:, :L],
                           neg)
        new = lse3(alpha, a_m1, a_m2) + torch.take_along_dim(lp_t, ext,
                                                             dim=1)
        return torch.where(valid[:, None], new, alpha), ()

    if T > 1:
        valid = (torch.arange(1, T, device=dev)[:, None]
                 < logit_lens[None, :])
        alpha, _ = scan(step, alpha0,
                        (log_probs[:, 1:, :].transpose(0, 1), valid))
    else:
        alpha = alpha0
    # final states: the trailing blank (2*len) and the last label
    iL = 2 * label_lens
    aL = torch.take_along_dim(alpha, iL[:, None], dim=1)[:, 0]
    aLm1 = torch.take_along_dim(alpha, torch.clamp(iL - 1, min=0)[:, None],
                                dim=1)[:, 0]
    aLm1 = torch.where(label_lens > 0, aLm1, neg)
    m = torch.maximum(aL, aLm1)
    m_safe = torch.where(m > _NEG / 2, m, torch.zeros((), dtype=dt,
                                                       device=dev))
    return -(m_safe + torch.log(torch.exp(aL - m_safe)
                                + torch.exp(aLm1 - m_safe)))


def warpctc(input, label, blank: int = 0, norm_by_times: bool = False,
            input_length=None, label_length=None):
    """CTC loss of unnormalized logits [B, T, C] (a sequence var) and
    0-padded int labels [B, S] (a sequence var): [B, 1]."""
    helper = LayerHelper("warpctc")
    out = helper.create_tmp_variable(np.float32)
    in_len = input_length or length_var_of(input)
    lbl_len = label_length or length_var_of(label)
    inputs = {"Logits": [input.name], "Label": [label.name]}
    if in_len is not None:
        inputs["LogitsLength"] = [in_len.name]
    if lbl_len is not None:
        inputs["LabelLength"] = [lbl_len.name]
    has_in, has_lbl = in_len is not None, lbl_len is not None

    def fn(logits, lbl, *rest):
        rest = list(rest)
        B, T, _ = logits.shape
        if lbl.dim() == 3:
            lbl = lbl.squeeze(-1)
        in_lens = rest.pop(0) if has_in else torch.full(
            (B,), T, dtype=torch.int64, device=logits.device)
        lbl_lens = rest.pop(0) if has_lbl else (lbl != 0).to(
            torch.int64).sum(dim=1)
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        loss = _ctc_loss(lp, in_lens, lbl, lbl_lens, blank)
        if norm_by_times:
            loss = loss / torch.clamp(
                in_lens.to(torch.float32).reshape(-1), min=1.0)
        return loss[:, None]

    helper.append_op(type="warpctc", inputs=inputs,
                     outputs={"Loss": [out.name]}, fn=fn)
    out.shape = (input.shape[0], 1) if input.shape else None
    return out


def edit_distance(input, label, normalized: bool = True,
                  ignored_tokens=None, input_length=None,
                  label_length=None):
    """Levenshtein distance of each (hypothesis, reference) pair of int
    sequences [B, S]: ([B, 1] float distances — divided by the
    reference length when ``normalized`` — and [B] 0/1 whether the pair
    differs). Tokens in ``ignored_tokens`` are erased first."""
    if ignored_tokens:
        from .sequence import sequence_erase

        input, _ = sequence_erase(input, tokens=list(ignored_tokens))
        label, _ = sequence_erase(label, tokens=list(ignored_tokens))
        input_length = label_length = None  # the erased lengths
    helper = LayerHelper("edit_distance")
    out = helper.create_tmp_variable(np.float32)
    seq_err = helper.create_tmp_variable(np.int64)
    in_len = input_length or length_var_of(input)
    lbl_len = label_length or length_var_of(label)
    inputs = {"Hyps": [input.name], "Refs": [label.name]}
    if in_len is not None:
        inputs["HypsLength"] = [in_len.name]
    if lbl_len is not None:
        inputs["RefsLength"] = [lbl_len.name]
    has_hl, has_rl = in_len is not None, lbl_len is not None

    def fn(hyp, ref, *rest):
        rest = list(rest)
        B, S1, S2 = hyp.shape[0], hyp.shape[1], ref.shape[1]
        dev = hyp.device
        hyp = hyp.reshape(B, S1).to(torch.int64)
        ref = ref.reshape(B, S2).to(torch.int64)
        hl = (rest.pop(0).to(torch.int64).reshape(-1) if has_hl
              else torch.full((B,), S1, dtype=torch.int64, device=dev))
        rl = (rest.pop(0).to(torch.int64).reshape(-1) if has_rl
              else torch.full((B,), S2, dtype=torch.int64, device=dev))
        if dev.type == "meta":   # shapes only: no S1 x S2 walk
            return (torch.empty((B, 1), dtype=torch.float32, device=dev),
                    torch.empty((B,), dtype=torch.int64, device=dev))
        # the DP over rows, each row a walk over the columns, for the
        # whole batch; the lengths pick the cell at the end
        row = torch.arange(S2 + 1, device=dev)[None, :].expand(B, S2 + 1)
        rows = [row]
        for i in range(1, S1 + 1):
            hy = hyp[:, i - 1]
            left = torch.full((B,), i, dtype=torch.int64, device=dev)
            cols = [left]
            for j in range(1, S2 + 1):
                sub = row[:, j - 1] + (hy != ref[:, j - 1]).to(torch.int64)
                left = torch.minimum(torch.minimum(left + 1, row[:, j] + 1),
                                     sub)
                cols.append(left)
            row = torch.stack(cols, dim=1)
            rows.append(row)
        dp = torch.stack(rows)                            # [S1+1, B, S2+1]
        dist = dp[hl, torch.arange(B, device=dev), rl].to(torch.float32)
        err = (dist > 0).to(torch.int64)
        if normalized:
            dist = dist / torch.clamp(rl.to(torch.float32), min=1.0)
        return dist[:, None], err

    helper.append_op(type="edit_distance", inputs=inputs,
                     outputs={"Out": [out.name],
                              "SequenceNum": [seq_err.name]}, fn=fn)
    return out, seq_err


def ctc_greedy_decoder(input, blank: int, name=None, length=None):
    """Best-path CTC decoding of [B, T, C] scores with a length
    companion: the argmax per step, repeats merged, blanks dropped.
    Returns (decoded [B, T] int64 ids, 0-padded, and lengths [B])."""
    helper = LayerHelper("ctc_greedy_decoder")
    lv = _require_len(input, length)
    out = helper.create_tmp_variable(np.int64)
    outlen = helper.create_tmp_variable(np.int32)

    def fn(x, lens):
        B, T = x.shape[0], x.shape[1]
        best = torch.argmax(x, dim=-1)                    # [B, T]
        prev = torch.cat([torch.full((B, 1), -1, dtype=best.dtype,
                                     device=best.device), best[:, :-1]], 1)
        keep = _seq_mask(lens, T) & (best != blank) & (best != prev)
        order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
        packed = torch.take_along_dim(best, order, dim=1)
        nl = keep.sum(dim=1).to(torch.int32)
        return torch.where(_seq_mask(nl, T), packed, torch.zeros(
            (), dtype=packed.dtype, device=packed.device)), nl

    helper.append_op(type="ctc_greedy_decoder",
                     inputs={"Input": [input.name], "Length": [lv.name]},
                     outputs={"Output": [out.name], "OutLen": [outlen.name]},
                     attrs={"blank": blank}, fn=fn)
    if input.shape is not None:
        out.shape = (input.shape[0], input.shape[1])
    out.seq_length_name = outlen.name
    return out, outlen


__all__ = ["warpctc", "edit_distance", "ctc_greedy_decoder"]
