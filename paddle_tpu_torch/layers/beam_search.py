"""Beam search (counterpart of paddle_tpu/layers/beam_search.py;
reference: operators/beam_search_op.cc, beam_search_decode_op.cc and the
While loop over LoD arrays that drove them).

As in the JAX package the whole decode is one loop over time with the
beam folded into the batch: candidate expansion, top-k pruning, beam
reordering and EOS handling are tensor ops of each step, and the
sequences are carried densely. ``step_fn`` is a torch function here.
Top-k and the final ranking sort stably (ties to the lower index, as
``lax.top_k`` and ``jnp.argsort``), so beams are the JAX package's bit
for bit on the same scores.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.scan import scan
from ..layer_helper import LayerHelper

_NEG = -1e9


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to
    the lower index (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search(step_fn: Callable, init_state, batch_size: int,
                beam_size: int, vocab_size: int, bos_id: int, eos_id: int,
                max_len: int, length_penalty: float = 0.0):
    """Run beam search; returns (sequences [B, K, max_len] int64,
    scores [B, K]) best-first.

    ``step_fn(tokens [B*K], state) -> (log_probs [B*K, V], new_state)``;
    ``state`` is a tree (dicts, lists, tuples) of tensors or Python
    values: a leaf with leading dim B*K follows the beams' reordering,
    others pass through. The search runs on the device of the state's
    first tensor (the CPU when it holds none)."""
    B, K, V = batch_size, beam_size, vocab_size
    leaves = []
    _tree_map(leaves.append, init_state)
    device = next((v.device for v in leaves
                   if isinstance(v, torch.Tensor)), None)

    def flat(x):
        return x.reshape((B * K,) + tuple(x.shape[2:]))

    def unflat(x):
        return x.reshape((B, K) + tuple(x.shape[1:]))

    tokens = torch.full((B, K), bos_id, dtype=torch.int64, device=device)
    # only beam 0 is live at the start (all beams start identical)
    scores = torch.tensor([[0.0] + [_NEG] * (K - 1)], dtype=torch.float32,
                          device=device).repeat(B, 1)
    finished = torch.zeros((B, K), dtype=torch.bool, device=device)
    seqs = torch.zeros((B, K, max_len), dtype=torch.int64, device=device)
    eos_only = torch.full((V,), _NEG, dtype=torch.float32, device=device)
    eos_only[eos_id] = 0.0

    def step(carry, t):
        tokens, scores, finished, seqs, state = carry
        logp, new_state = step_fn(flat(tokens), state)
        logp = unflat(logp)                              # [B, K, V]
        # a finished beam may only extend with EOS, at no cost
        logp = torch.where(finished[..., None], eos_only.to(logp.dtype),
                           logp)
        cand = (scores[..., None] + logp).reshape(B, K * V)
        top_scores, top_idx = _top_k(cand, K)
        beam_idx = top_idx // V                          # [B, K]
        tok_idx = top_idx % V

        def reorder(x):
            if not isinstance(x, torch.Tensor) or x.dim() == 0 \
                    or x.shape[0] != B * K:
                return x
            xk = unflat(x)
            return flat(torch.take_along_dim(
                xk, beam_idx.reshape((B, K) + (1,) * (xk.dim() - 2)),
                dim=1))

        state = _tree_map(reorder, new_state)
        seqs = torch.take_along_dim(seqs, beam_idx[..., None], dim=1)
        seqs = seqs.index_copy(2, t.reshape(1), tok_idx[..., None])
        finished = torch.take_along_dim(finished, beam_idx, dim=1) \
            | (tok_idx == eos_id)
        return (tok_idx, top_scores, finished, seqs, state), ()

    ts = torch.arange(max_len, device=device)
    (tokens, scores, finished, seqs, _), _ = scan(
        step, (tokens, scores, finished, seqs, init_state), (ts,))

    if length_penalty > 0:
        hit = torch.cat([seqs == eos_id,
                         torch.ones((B, K, 1), dtype=torch.bool,
                                    device=seqs.device)], -1)
        lens = torch.argmax(hit.to(torch.int32), dim=-1).to(
            torch.float32) + 1.0
        ranked = scores / ((5.0 + lens) / 6.0) ** length_penalty
    else:
        ranked = scores
    order = torch.argsort(-ranked, dim=1, stable=True)
    return (torch.take_along_dim(seqs, order[..., None], dim=1),
            torch.take_along_dim(ranked, order, dim=1))


def greedy_search(step_fn, init_state, batch_size: int, vocab_size: int,
                  bos_id: int, eos_id: int, max_len: int):
    """Greedy decoding: beam search with one beam."""
    seqs, scores = beam_search(step_fn, init_state, batch_size, 1,
                               vocab_size, bos_id, eos_id, max_len)
    return seqs[:, 0, :], scores[:, 0]


def beam_search_decode(ids, scores, beam_size: int, end_id: int,
                       parents=None, name=None):
    """Backtrack per-step beam selections into whole sequences
    (reference: operators/beam_search_decode_op.cc, whose parent
    pointers ride each step's LoD; here an explicit ``parents`` tensor).

    ``ids``/``scores``: [T, B, K] chosen token ids / cumulative scores
    per step; ``parents``: [T, B, K] the beam each selection extended
    (identity when omitted). Returns (sequences [B, K, T] int64 sorted
    best-first by final score, scores [B, K])."""
    helper = LayerHelper("beam_search_decode")
    out_seq = helper.create_tmp_variable("int64")
    out_sc = helper.create_tmp_variable(scores.dtype)
    inputs = {"Ids": [ids.name], "Scores": [scores.name]}
    if parents is not None:
        inputs["Parents"] = [parents.name]

    def fn(idv, scv, parv=None):
        T, B, K = idv.shape
        if parv is None:
            parv = torch.arange(K, device=idv.device)[None, None, :] \
                .expand(T, B, K)
        parv = parv.to(torch.int64)
        idv = idv.to(torch.int64)

        def back(beam, t):                 # beam: [B, K] at step t+1
            tok = torch.take_along_dim(idv[t], beam, dim=1)
            return torch.take_along_dim(parv[t], beam, dim=1), (tok,)

        beam_T = torch.arange(K, device=idv.device)[None, :].expand(B, K)
        _, (toks,) = scan(back, beam_T,
                          (torch.arange(T, device=idv.device),),
                          reverse=True)
        seqs = toks.permute(1, 2, 0)                       # [B, K, T]
        order = torch.argsort(-scv[-1], dim=1, stable=True)
        return (torch.take_along_dim(seqs, order[:, :, None], dim=1),
                torch.take_along_dim(scv[-1], order, dim=1))

    helper.append_op(type="beam_search_decode", inputs=inputs,
                     outputs={"SentenceIds": [out_seq.name],
                              "SentenceScores": [out_sc.name]},
                     attrs={"beam_size": beam_size, "end_id": end_id},
                     fn=fn)
    return out_seq, out_sc


def cross_entropy_over_beam(beam_ids, beam_scores, gold_ids,
                            beam_lengths=None, gold_length=None,
                            name=None):
    """Beam-training loss (reference: trainer_config_helpers
    cross_entropy_over_beam): the beam's scores as a categorical
    distribution, the negative log-likelihood of the gold sequence's
    slot. A candidate matches gold when it has gold's length and tokens;
    gold absent from the beam takes an extra slot of score 0. ``beam_ids``
    [B, K, T]; ``beam_scores`` [B, K]; ``gold_ids`` [B, T_g]; an omitted
    length defaults to its tensor's full width. Returns the mean loss."""
    helper = LayerHelper(name or "cross_entropy_over_beam")
    out = helper.create_tmp_variable("float32")
    inputs = {"Ids": [beam_ids.name], "Scores": [beam_scores.name],
              "Gold": [gold_ids.name]}
    opt = []
    if beam_lengths is not None:
        inputs["Lens"] = [beam_lengths.name]
        opt.append("lens")
    if gold_length is not None:
        inputs["GoldLen"] = [gold_length.name]
        opt.append("gold_len")

    def fn(ids, scores, gold, *rest):
        r = dict(zip(opt, rest))
        B, K, T = ids.shape
        Tg = gold.shape[1]
        W = min(T, Tg)
        dev = ids.device
        cand = ids[:, :, :W].to(torch.int64)
        gseq = gold[:, None, :W].to(torch.int64)
        clen = (r["lens"].to(torch.int64) if "lens" in r
                else torch.full((B, K), T, dtype=torch.int64, device=dev))
        glen = (r["gold_len"].to(torch.int64).reshape(-1)
                if "gold_len" in r
                else torch.full((B,), Tg, dtype=torch.int64, device=dev))
        within = torch.arange(W, device=dev)[None, None, :] < clen[..., None]
        tok_eq = torch.where(within, cand == gseq, torch.ones(
            (), dtype=torch.bool, device=dev))
        match = (clen == glen[:, None]) & tok_eq.all(-1)    # [B, K]
        in_beam = match.any(dim=1)
        label = torch.where(in_beam,
                            torch.argmax(match.to(torch.int32), dim=1),
                            torch.full((), K, dtype=torch.int64, device=dev))
        aug = torch.cat([scores.to(torch.float32), torch.where(
            in_beam, torch.full((), -1e9, device=dev),
            torch.zeros((), device=dev))[:, None]], dim=1)
        logp = torch.log_softmax(aug, dim=1)
        nll = -torch.take_along_dim(logp, label[:, None], dim=1)[:, 0]
        return torch.mean(nll)

    helper.append_op(type="cross_entropy_over_beam", inputs=inputs,
                     outputs={"Out": [out.name]}, fn=fn)
    out.shape = ()
    return out


__all__ = ["beam_search", "greedy_search", "beam_search_decode",
           "cross_entropy_over_beam"]
