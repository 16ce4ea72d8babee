"""Recurrent layers over padded sequences (counterpart of
paddle_tpu/layers/rnn.py; reference: layers/nn.py dynamic_lstm,
dynamic_gru, lstm_unit, gru_unit, dynamic_lstmp over operators/lstm_op.cc,
gru_op.cc, lstmp_op.cc and the legacy RecurrentLayer).

Each recurrence is one op whose fn walks the padded time axis
(``core.scan``) with the validity mask freezing finished sequences, as
the JAX package's ``lax.scan``: the gate input projection of every step
comes in precomputed (the reference's contract), the recurrent product
runs per step. The conventions are the JAX package's, exactly:

* ``dynamic_lstm``'s ``size`` is 4 x hidden, its gate order i, f, c, o,
  and its bias ``[7H]`` with peepholes, packed ``[b4 | w_ic | w_fc |
  w_oc]``;
* ``is_reverse`` flips the whole padded time axis, so the leading pads
  of a reversed row hold the initial state through the mask blend
  ``h = h_new where valid else h_prev`` — not a reversal of each
  sequence within its length;
* the outputs are multiplied by the mask at the end.

``torch.nn.LSTM``/cuDNN are not used: their peephole-free cell and
packed-sequence handling give other numbers at padded positions.
"""

from __future__ import annotations

import torch

from ..core.enforce import enforce
from ..core.scan import scan
from ..layer_helper import LayerHelper
from .sequence import _require_len, _seq_mask


def _act(name):
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
            "relu": lambda v: torch.maximum(v, torch.zeros(
                (), dtype=v.dtype, device=v.device)),
            "identity": lambda v: v}[name]


def _time_major(x, mask, is_reverse):
    """(x [T, B, ...], mask [T, B] bool) of [B, T, ...] inputs, the time
    axis flipped for a reverse recurrence."""
    if is_reverse:
        x, mask = torch.flip(x, (1,)), torch.flip(mask, (1,))
    return x.transpose(0, 1), mask.transpose(0, 1)


def _batch_major(ys, is_reverse):
    ys = ys.transpose(0, 1)
    return torch.flip(ys, (1,)) if is_reverse else ys


def _lstm_cell(gates, c_prev, peep, acts):
    """One LSTM cell from its gate pre-activations [B, 4H] (order i, f,
    c, o): (h, c)."""
    g_act, c_act, cand_act = acts
    gi, gf, gc, go = torch.chunk(gates, 4, dim=-1)
    if peep is not None:
        wic, wfc, woc = peep
        gi = gi + c_prev * wic
        gf = gf + c_prev * wfc
    c_new = g_act(gf) * c_prev + g_act(gi) * cand_act(gc)
    if peep is not None:
        go = go + c_new * woc
    return g_act(go) * c_act(c_new), c_new


def dynamic_lstm(input, size: int, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes: bool = True,
                 is_reverse: bool = False, gate_activation="sigmoid",
                 cell_activation="tanh", candidate_activation="tanh",
                 dtype="float32", name=None, length=None):
    """LSTM over a padded sequence. ``input`` is the projected gate input
    [B, T, 4*hidden] and ``size`` is 4*hidden. Returns (hidden [B,T,H],
    cell [B,T,H])."""
    helper = LayerHelper("dynamic_lstm")
    enforce(size % 4 == 0, "dynamic_lstm size must be 4*hidden")
    hidden = size // 4
    lv = _require_len(input, length)
    w = helper.create_parameter(param_attr, [hidden, 4 * hidden], dtype)
    b = helper.create_parameter(
        bias_attr, [7 * hidden] if use_peepholes else [4 * hidden], dtype,
        is_bias=True)
    h_out = helper.create_tmp_variable(dtype)
    c_out = helper.create_tmp_variable(dtype)
    acts = (_act(gate_activation), _act(cell_activation),
            _act(candidate_activation))
    has_init = h_0 is not None
    if has_init:
        enforce(c_0 is not None, "dynamic_lstm: pass both h_0 and c_0")

    def fn(x, lens, wv, bv, *init):
        B, T = x.shape[0], x.shape[1]
        mask = _seq_mask(lens, T)
        peep = ((bv[4 * hidden:5 * hidden], bv[5 * hidden:6 * hidden],
                 bv[6 * hidden:]) if use_peepholes else None)
        xs, ms = _time_major(x + bv[:4 * hidden], mask, is_reverse)
        if init:
            carry = tuple(init)
        else:
            z = torch.zeros((B, hidden), dtype=x.dtype, device=x.device)
            carry = (z, z)

        def step(carry, xt, mt):
            h_prev, c_prev = carry
            h_new, c_new = _lstm_cell(xt + h_prev @ wv, c_prev, peep, acts)
            mt = mt[:, None]
            h_new = torch.where(mt, h_new, h_prev)
            c_new = torch.where(mt, c_new, c_prev)
            return (h_new, c_new), (h_new, c_new)

        _, (hs, cs) = scan(step, carry, (xs, ms))
        m3 = mask[..., None].to(x.dtype)
        return (_batch_major(hs, is_reverse) * m3,
                _batch_major(cs, is_reverse) * m3)

    inputs = {"Input": [input.name], "Length": [lv.name],
              "Weight": [w.name], "Bias": [b.name]}
    if has_init:
        inputs["H0"] = [h_0.name]
        inputs["C0"] = [c_0.name]
    helper.append_op(type="lstm", inputs=inputs,
                     outputs={"Hidden": [h_out.name], "Cell": [c_out.name]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse}, fn=fn)
    return h_out, c_out


def dynamic_gru(input, size: int, param_attr=None, bias_attr=None,
                is_reverse: bool = False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, length=None,
                dtype="float32"):
    """GRU over a padded sequence; ``input`` is [B, T, 3*size]
    (projected). The weight packs update/reset [H, 2H] and candidate
    [H, H]."""
    helper = LayerHelper("dynamic_gru")
    hidden = size
    lv = _require_len(input, length)
    w = helper.create_parameter(param_attr, [hidden, 3 * hidden], dtype)
    b = helper.create_parameter(bias_attr, [3 * hidden], dtype, is_bias=True)
    out = helper.create_tmp_variable(dtype)
    g_act, cand_act = _act(gate_activation), _act(candidate_activation)
    has_init = h_0 is not None

    def fn(x, lens, wv, bv, *init):
        B, T = x.shape[0], x.shape[1]
        mask = _seq_mask(lens, T)
        xs, ms = _time_major(x + bv, mask, is_reverse)
        w_ur, w_c = wv[:, :2 * hidden], wv[:, 2 * hidden:]
        h0 = init[0] if init else torch.zeros((B, hidden), dtype=x.dtype,
                                              device=x.device)

        def step(h_prev, xt, mt):
            u, r = torch.chunk(g_act(xt[:, :2 * hidden] + h_prev @ w_ur), 2,
                               dim=-1)
            cand = cand_act(xt[:, 2 * hidden:] + (r * h_prev) @ w_c)
            h_new = u * h_prev + (1 - u) * cand
            h_new = torch.where(mt[:, None], h_new, h_prev)
            return h_new, (h_new,)

        _, (hs,) = scan(step, h0, (xs, ms))
        return _batch_major(hs, is_reverse) * mask[..., None].to(x.dtype)

    inputs = {"Input": [input.name], "Length": [lv.name],
              "Weight": [w.name], "Bias": [b.name]}
    if has_init:
        inputs["H0"] = [h_0.name]
    helper.append_op(type="gru", inputs=inputs,
                     outputs={"Hidden": [out.name]},
                     attrs={"is_reverse": is_reverse}, fn=fn)
    return out


def simple_rnn(input, size: int, act="tanh", param_attr=None,
               bias_attr=None, is_reverse: bool = False, length=None,
               dtype="float32"):
    """Elman recurrence ``h_t = act(x_t + h_{t-1} @ W + b)`` over a
    padded [B, T, size] (projected) sequence (reference: the legacy
    gserver RecurrentLayer)."""
    helper = LayerHelper("simple_rnn")
    lv = _require_len(input, length)
    w = helper.create_parameter(param_attr, [size, size], dtype)
    b = helper.create_parameter(bias_attr, [size], dtype, is_bias=True)
    out = helper.create_tmp_variable(dtype)
    a = _act(act)

    def fn(x, lens, wv, bv):
        B, T = x.shape[0], x.shape[1]
        mask = _seq_mask(lens, T)
        xs, ms = _time_major(x + bv, mask, is_reverse)

        def step(h_prev, xt, mt):
            h_new = torch.where(mt[:, None], a(xt + h_prev @ wv), h_prev)
            return h_new, (h_new,)

        h0 = torch.zeros((B, size), dtype=x.dtype, device=x.device)
        _, (hs,) = scan(step, h0, (xs, ms))
        return _batch_major(hs, is_reverse) * mask[..., None].to(x.dtype)

    helper.append_op(type="simple_rnn",
                     inputs={"Input": [input.name], "Length": [lv.name],
                             "Weight": [w.name], "Bias": [b.name]},
                     outputs={"Hidden": [out.name]},
                     attrs={"is_reverse": is_reverse}, fn=fn)
    out.shape = input.shape
    out.seq_length_name = getattr(input, "seq_length_name", None)
    return out


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias: float = 0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: ``[x, h_prev] @ W + b`` split i, f, c, o, the
    forget gate offset by ``forget_bias``. Returns (hidden, cell)."""
    helper = LayerHelper("lstm_unit")
    dtype = x_t.dtype
    in_dim = x_t.shape[-1]
    hid = hidden_t_prev.shape[-1]
    w = helper.create_parameter(param_attr, [in_dim + hid, 4 * hid], dtype)
    b = helper.create_parameter(bias_attr, [4 * hid], dtype, is_bias=True)
    h_out = helper.create_tmp_variable(dtype)
    c_out = helper.create_tmp_variable(dtype)

    def fn(x, h_prev, c_prev, wv, bv):
        gates = torch.cat([x, h_prev], -1) @ wv + bv
        gi, gf, gc, go = torch.chunk(gates, 4, dim=-1)
        c_new = torch.sigmoid(gf + forget_bias) * c_prev + \
            torch.sigmoid(gi) * torch.tanh(gc)
        return torch.sigmoid(go) * torch.tanh(c_new), c_new

    helper.append_op(
        type="lstm_unit",
        inputs={"X": [x_t.name], "HiddenPrev": [hidden_t_prev.name],
                "CellPrev": [cell_t_prev.name], "Weight": [w.name],
                "Bias": [b.name]},
        outputs={"Hidden": [h_out.name], "Cell": [c_out.name]}, fn=fn)
    return h_out, c_out


def gru_unit(input, hidden, size: int, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step of the projected [B, 3*H] gate input; returns
    (hidden, reset_hidden, gate)."""
    helper = LayerHelper("gru_unit")
    dtype = input.dtype
    hid = size // 3
    w = helper.create_parameter(param_attr, [hid, 3 * hid], dtype)
    b = helper.create_parameter(bias_attr, [3 * hid], dtype, is_bias=True)
    h_out = helper.create_tmp_variable(dtype)
    r_out = helper.create_tmp_variable(dtype)
    g_out = helper.create_tmp_variable(dtype)
    g_act, c_act = _act(gate_activation), _act(activation)

    def fn(x, h_prev, wv, bv):
        x = x + bv
        u, r = torch.chunk(g_act(x[:, :2 * hid] + h_prev @ wv[:, :2 * hid]),
                           2, dim=-1)
        r_h = r * h_prev
        cand = c_act(x[:, 2 * hid:] + r_h @ wv[:, 2 * hid:])
        h_new = u * h_prev + (1 - u) * cand
        return h_new, r_h, torch.cat([u, r, cand], dim=-1)

    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input.name], "HiddenPrev": [hidden.name],
                "Weight": [w.name], "Bias": [b.name]},
        outputs={"Hidden": [h_out.name], "ResetHiddenPrev": [r_out.name],
                 "Gate": [g_out.name]}, fn=fn)
    return h_out, r_out, g_out


def dynamic_lstmp(input, size: int, proj_size: int, param_attr=None,
                  bias_attr=None, use_peepholes: bool = True,
                  is_reverse: bool = False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", dtype="float32", name=None,
                  length=None):
    """LSTM with a recurrent projection: the cell output is projected to
    ``proj_size`` and the projection is the recurrent state (reference:
    operators/lstmp_op.cc). Returns (projection [B,T,P], cell
    [B,T,H])."""
    from ..param_attr import ParamAttr

    helper = LayerHelper("dynamic_lstmp")
    enforce(size % 4 == 0, "dynamic_lstmp size must be 4*hidden")
    hidden = size // 4
    lv = _require_len(input, length)
    w = helper.create_parameter(param_attr, [proj_size, 4 * hidden], dtype)
    # a named param_attr must not alias the projection onto the gate
    # weight (parameters are shared by name): the second weight gets its
    # own name, as the reference's ProjWeight
    proj_attr = ParamAttr._to_attr(param_attr)
    if proj_attr.name is not None:
        proj_attr.name += ".proj"
    w_proj = helper.create_parameter(proj_attr, [hidden, proj_size], dtype)
    b = helper.create_parameter(
        bias_attr, [7 * hidden] if use_peepholes else [4 * hidden], dtype,
        is_bias=True)
    p_out = helper.create_tmp_variable(dtype)
    c_out = helper.create_tmp_variable(dtype)
    acts = (_act(gate_activation), _act(cell_activation),
            _act(candidate_activation))
    p_act = _act(proj_activation)

    def fn(x, lens, wv, wpv, bv):
        B, T = x.shape[0], x.shape[1]
        mask = _seq_mask(lens, T)
        peep = ((bv[4 * hidden:5 * hidden], bv[5 * hidden:6 * hidden],
                 bv[6 * hidden:]) if use_peepholes else None)
        xs, ms = _time_major(x + bv[:4 * hidden], mask, is_reverse)

        def step(carry, xt, mt):
            r_prev, c_prev = carry
            h_new, c_new = _lstm_cell(xt + r_prev @ wv, c_prev, peep, acts)
            r_new = p_act(h_new @ wpv)
            mt = mt[:, None]
            r_new = torch.where(mt, r_new, r_prev)
            c_new = torch.where(mt, c_new, c_prev)
            return (r_new, c_new), (r_new, c_new)

        carry = (torch.zeros((B, proj_size), dtype=x.dtype, device=x.device),
                 torch.zeros((B, hidden), dtype=x.dtype, device=x.device))
        _, (rs, cs) = scan(step, carry, (xs, ms))
        m3 = mask[..., None].to(x.dtype)
        return (_batch_major(rs, is_reverse) * m3,
                _batch_major(cs, is_reverse) * m3)

    helper.append_op(type="lstmp",
                     inputs={"Input": [input.name], "Length": [lv.name],
                             "Weight": [w.name], "ProjWeight": [w_proj.name],
                             "Bias": [b.name]},
                     outputs={"Projection": [p_out.name],
                              "Cell": [c_out.name]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse}, fn=fn)
    return p_out, c_out


__all__ = ["dynamic_lstm", "dynamic_gru", "simple_rnn", "lstm_unit",
           "gru_unit", "dynamic_lstmp"]
