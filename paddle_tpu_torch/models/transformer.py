"""Transformer-base for NMT and its building blocks (counterpart of
paddle_tpu/models/transformer.py): the encoder-decoder that
``transformer_base`` trains, and the blocks the causal LM reuses.

Attention is one op (scale -> logits -> mask -> softmax -> context).
``attn_impl="fused"`` runs it as plain torch ops (the JAX package's
einsum path); ``"pallas"`` runs the hand-written flash-attention
kernels (``ops/flash_attention.py``), forward and backward. ``None``
resolves to ``"fused"``: the JAX package's crossover to its kernel at
2048 keys was measured on a TPU, and the card's own rule waits for its
measurements (PERF.md). Training dropout draws its masks with the
dropout kernel (``ops/dropout.py``); ``transformer_base(fused_ce=True)``
ends in the chunked projection + CE op (``ops/fused_ce.py``).

``tp=True`` annotates the weights as the JAX package does (``_tp``):
QKV and FFN-in column-parallel, the attention output and FFN-out
row-parallel over the ``mp`` axis. In a sharded run over a mesh with a
tensor-parallel axis (``mp``, else ``tp``) each rank computes its block
of the heads and of the FFN's hidden columns (``layers.fc``'s
tensor-parallel path); the attention op takes its heads from its
inputs' width, so the flash kernels run at the local heads.

The other model-parallel axes: ``attn_impl="ring"`` runs attention
sequence-parallel over the mesh's ``sp`` axis
(``parallel/ring_attention.py``); ``pp_encoder=True`` builds the encoder
as one GPipe op over ``pp`` (:func:`pipelined_encoder`,
``parallel/pipeline.py``); ``distributed_embedding=True`` splits both
word tables' rows over ``ep`` (``sharding/embedding.py``). Each runs
the plain math on a mesh without its axis.
"""

from __future__ import annotations

import math

import torch

from .. import layers
from ..core import flags
from ..core.dtype_utils import rounded_sqrt
from ..core.enforce import enforce
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


def _tp(axes, enable):
    """ParamAttr with a tensor-parallel sharding spec when enabled."""
    return ParamAttr(sharding=axes) if enable else None


def sinusoid_table(positions, d_model: int):
    """The fixed sinusoid encoding at float32 ``positions`` (any shape):
    ``[..., d_model]`` with the sines in the first half and the cosines
    in the second, as the reference's position_encoding_init lays them
    out."""
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=positions.device)
                    * -(math.log(10000.0) / d_model))
    ang = positions[..., None] * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def positional_encoding(x, max_length=2048):
    """Add the fixed sinusoid position encoding (positions 0..T-1)."""
    helper = LayerHelper("pos_encoding")
    out = helper.create_tmp_variable(x.dtype)

    def fn(v):
        pos = torch.arange(v.shape[1], dtype=torch.float32, device=v.device)
        pe = sinusoid_table(pos, v.shape[-1])
        return v + pe[None, :, :].to(v.dtype)

    helper.append_op(type="pos_encoding", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


def attention(qh, kh, vh, mask=None, causal=False):
    """Multi-head attention on head-split ``[B, T, H, D]`` tensors: the
    JAX package's fused math in the same order — logits divided by
    ``sqrt(D)`` rounded to q's dtype, ``-1e9`` masking, softmax in f32
    (f64 for f64 operands), cast back."""
    Tq, Tk = qh.shape[1], kh.shape[1]
    logits = (torch.einsum("bqhd,bkhd->bhqk", qh, kh)
              / rounded_sqrt(qh.shape[-1], qh.dtype))
    neg = torch.full((), -1e9, dtype=logits.dtype, device=logits.device)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :] > 0, logits, neg)
    if causal:
        cm = torch.ones((Tq, Tk), dtype=torch.bool,
                        device=logits.device).tril()
        logits = torch.where(cm[None, None, :, :], logits, neg)
    w = torch.softmax(logits.to(torch.promote_types(logits.dtype,
                                                    torch.float32)),
                      dim=-1).to(vh.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vh)


def multi_head_attention(queries, keys, values, d_key, d_value, d_model,
                         n_head=1, dropout_rate=0.0, is_test=False,
                         causal=False, kv_mask=None, tp=False, cache=None,
                         attn_impl=None):
    """Multi-head attention as one op. ``kv_mask`` is a ``[B, T_k]`` 0/1
    float var masking padded keys; ``causal`` adds the autoregressive
    mask. ``attn_impl``: ``"fused"`` (plain torch ops), ``"pallas"``
    (the flash-attention kernels), ``"ring"`` (sequence-parallel over
    the active mesh's ``sp`` axis, ``parallel/ring_attention.py``; the
    plain ring math without one) or ``None`` (``"fused"``). ``tp``:
    column-parallel QKV, row-parallel output projection (the op then
    runs on this rank's heads)."""
    if attn_impl not in (None, "fused", "pallas", "ring"):
        raise ValueError("multi_head_attention: unknown attn_impl %r"
                         % (attn_impl,))
    helper = LayerHelper("multi_head_attention")

    q = layers.fc(input=queries, size=d_key * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=_tp((None, "mp"), tp))
    k = layers.fc(input=keys, size=d_key * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=_tp((None, "mp"), tp))
    v = layers.fc(input=values, size=d_value * n_head, num_flatten_dims=2,
                  bias_attr=False, param_attr=_tp((None, "mp"), tp))

    out = helper.create_tmp_variable(queries.dtype)
    in_names = {"Q": [q.name], "K": [k.name], "V": [v.name]}
    if kv_mask is not None:
        in_names["Mask"] = [kv_mask.name]

    def fn(qv, kv, vv, mask=None):
        B, Tq, _ = qv.shape
        Tk = kv.shape[1]
        # n_head, or this rank's block of the heads under tensor
        # parallelism
        heads = qv.shape[-1] // d_key
        qh = torch.reshape(qv, (B, Tq, heads, d_key))
        kh = torch.reshape(kv, (B, Tk, heads, d_key))
        vh = torch.reshape(vv, (B, Tk, heads, d_value))
        if attn_impl == "pallas":
            from ..ops.flash_attention import flash_attention

            ctx = flash_attention(qh, kh, vh, causal=causal, kv_mask=mask)
        elif attn_impl == "ring":
            from ..core.trace_ctx import current_mesh
            from ..parallel.ring_attention import ring_attention

            ctx = ring_attention(qh, kh, vh, current_mesh(), causal=causal,
                                 kv_mask=mask)
        else:
            ctx = attention(qh, kh, vh, mask=mask, causal=causal)
        return torch.reshape(ctx, (B, Tq, heads * d_value))

    helper.append_op(type="fused_attention", inputs=in_names,
                     outputs={"Out": [out.name]},
                     attrs={"n_head": n_head, "causal": causal}, fn=fn)
    proj = layers.fc(input=out, size=d_model, num_flatten_dims=2,
                     bias_attr=False, param_attr=_tp(("mp", None), tp))
    if dropout_rate and not is_test:
        proj = layers.dropout(proj, dropout_prob=dropout_rate,
                              is_test=is_test)
    return proj


def positionwise_feed_forward(x, d_inner_hid, d_hid, dropout_rate=0.0,
                              is_test=False, tp=False):
    hidden = layers.fc(input=x, size=d_inner_hid, num_flatten_dims=2,
                       act="relu", param_attr=_tp((None, "mp"), tp))
    if dropout_rate and not is_test:
        hidden = layers.dropout(hidden, dropout_prob=dropout_rate,
                                is_test=is_test)
        if tp:
            # a rank holds a block of the hidden columns: it draws that
            # block of the whole width's mask
            op = hidden.block.ops[-1]
            op.attrs["tp_width"] = d_inner_hid
            op.attrs["_fn_attrs"] = list(op.attrs["_fn_attrs"]) + \
                ["tp_width"]
    return layers.fc(input=hidden, size=d_hid, num_flatten_dims=2,
                     param_attr=_tp(("mp", None), tp))


def pre_post_process_layer(prev_out, out, process_cmd, dropout_rate=0.0,
                           is_test=False):
    """'n' = layer_norm, 'a' = residual add, 'd' = dropout."""
    for cmd in process_cmd:
        if cmd == "a":
            out = layers.elementwise_add(x=out, y=prev_out) \
                if prev_out is not None else out
        elif cmd == "n":
            out = layers.layer_norm(out, begin_norm_axis=len(out.shape) - 1)
        elif cmd == "d":
            if dropout_rate and not is_test:
                out = layers.dropout(out, dropout_prob=dropout_rate,
                                     is_test=is_test)
    return out


def encoder_layer(enc_input, src_mask, n_head, d_key, d_value, d_model,
                  d_inner_hid, dropout_rate=0.0, is_test=False, tp=False,
                  attn_impl=None):
    attn = multi_head_attention(enc_input, enc_input, enc_input, d_key,
                                d_value, d_model, n_head, dropout_rate,
                                is_test=is_test, kv_mask=src_mask, tp=tp,
                                attn_impl=attn_impl)
    attn_out = pre_post_process_layer(enc_input, attn, "dan", dropout_rate,
                                      is_test)
    ffd = positionwise_feed_forward(attn_out, d_inner_hid, d_model,
                                    dropout_rate, is_test=is_test, tp=tp)
    return pre_post_process_layer(attn_out, ffd, "dan", dropout_rate,
                                  is_test)


def decoder_layer(dec_input, enc_output, src_mask, n_head, d_key, d_value,
                  d_model, d_inner_hid, dropout_rate=0.0, is_test=False,
                  tp=False, attn_impl=None):
    slf = multi_head_attention(dec_input, dec_input, dec_input, d_key,
                               d_value, d_model, n_head, dropout_rate,
                               is_test=is_test, causal=True, tp=tp,
                               attn_impl=attn_impl)
    slf_out = pre_post_process_layer(dec_input, slf, "dan", dropout_rate,
                                     is_test)
    ctx = multi_head_attention(slf_out, enc_output, enc_output, d_key,
                               d_value, d_model, n_head, dropout_rate,
                               is_test=is_test, kv_mask=src_mask, tp=tp,
                               attn_impl=attn_impl)
    ctx_out = pre_post_process_layer(slf_out, ctx, "dan", dropout_rate,
                                     is_test)
    ffd = positionwise_feed_forward(ctx_out, d_inner_hid, d_model,
                                    dropout_rate, is_test=is_test, tp=tp)
    return pre_post_process_layer(ctx_out, ffd, "dan", dropout_rate,
                                  is_test)


def pipelined_encoder(src_emb, src_mask, n_layer, n_head, d_key, d_value,
                      d_model, d_inner_hid, n_microbatches=2,
                      is_test=False, tp=False, attn_impl=None,
                      dropout_rate=0.0):
    """The encoder stack as one GPipe op over the mesh's ``pp`` axis
    (``parallel/pipeline.py``), the JAX package's: one STACKED parameter
    per role with a leading ``[n_layer]`` dim split over ``pp``, the
    JAX package's names, shapes and ``param_axes``. On a mesh without
    ``pp`` (or on one device) the same math runs as a sequential fold.
    Post-LN "dan" layers, encoder_layer's math:

      * ``tp=True``: QKV/FFN-in column-blocked and proj/FFN-out
        row-blocked over ``mp`` on top of ``pp``; a stage holding its
        ``mp`` blocks computes its local heads and hidden columns and
        sums the partial outputs over ``mp`` itself.
      * ``attn_impl``: ``"fused"`` (plain torch ops) or ``"pallas"`` (the
        flash kernels on the stage's heads); None is ``"fused"``.
        ``"ring"`` is refused: it claims the ``sp`` axis, which cannot
        nest inside the pipeline's schedule.
      * dropout at encoder_layer's four sites (proj, the first "d", the
        FFN hidden, the second "d"), each mask keyed
        ``fold_in(fold_in(fold_in(PRNGKey(base_seed), seed_m), layer),
        site)`` — the per-microbatch seeds ``counter * M + m`` — then
        folded with the ``dp`` index when the schedule runs over ``pp``
        and a ``dp`` axis, and with the ``mp`` index at the FFN hidden
        site under tensor parallelism, as the JAX package's manual
        shard_map folds them. The masks are drawn by the dropout
        kernel's keyed launch on a card (``ops.dropout.dropout_keyed``).

    Under the bf16 flags each product takes ``layers.fc``'s bf16 rule
    and the layer norms compute in f32 (ROADMAP Queue C 2)."""
    from ..core import initializer as init
    from ..core import unique_name
    from ..layers.nn import _dropout_counter, _mm, _mm_rule

    helper = LayerHelper("pipelined_encoder")
    L, H, dk, dv = n_layer, n_head, d_key, d_value
    d, f = d_model, d_inner_hid
    enforce(attn_impl in (None, "fused", "pallas"),
            "pipelined_encoder supports attn_impl None/'fused'/'pallas'; "
            "'ring' claims the sp axis, which cannot nest inside the "
            "pipeline's schedule")

    def mk(name, shape, spec, is_bias=False, default=None):
        attr = ParamAttr(name=unique_name.generate(f"pp_enc.{name}"),
                         sharding=spec)
        return helper.create_parameter(attr, shape, "float32",
                                       is_bias=is_bias,
                                       default_initializer=default)

    mp = "mp" if tp else None
    col3 = ("pp", None, mp)      # column-parallel: out-features blocked
    row3 = ("pp", mp, None)      # row-parallel: in-features blocked
    rep2 = ("pp", None)
    qw = mk("qw", [L, d, H * dk], col3)
    kw = mk("kw", [L, d, H * dk], col3)
    vw = mk("vw", [L, d, H * dv], col3)
    ow = mk("ow", [L, H * dv, d], row3)
    ln1g = mk("ln1g", [L, d], rep2, default=init.Constant(1.0))
    ln1b = mk("ln1b", [L, d], rep2, is_bias=True)
    f1 = mk("f1", [L, d, f], col3)
    f1b = mk("f1b", [L, f], ("pp", mp), is_bias=True)
    f2 = mk("f2", [L, f, d], row3)
    f2b = mk("f2b", [L, d], rep2, is_bias=True)
    ln2g = mk("ln2g", [L, d], rep2, default=init.Constant(1.0))
    ln2b = mk("ln2b", [L, d], rep2, is_bias=True)
    params = [qw, kw, vw, ow, ln1g, ln1b, f1, f1b, f2, f2b, ln2g, ln2b]

    use_dropout = bool(dropout_rate) and not is_test
    # downgrade_in_infer: the eval program scales each site by (1 - p)
    infer_scale = bool(dropout_rate) and is_test
    out = helper.create_tmp_variable(src_emb.dtype)
    in_names = {"X": [src_emb.name], "Mask": [src_mask.name],
                "Params": [p.name for p in params]}
    outputs = {"Out": [out.name]}
    base_seed = helper.main_program.next_param_seed()
    if use_dropout:
        counter = _dropout_counter(helper)
        in_names["Seed"] = [counter.name]
        outputs["SeedOut"] = [counter.name]
    rule = _mm_rule()

    def _ln(x, g, b, eps=1e-5):
        cdt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(cdt)
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        return ((xf - mean) * torch.rsqrt(var + eps) * g.to(cdt)
                + b.to(cdt)).to(x.dtype)

    def _bias(y, c):
        # the JAX package's promotion; under the bf16 rule fc's cast
        return y + (c if rule is None else c.to(y.dtype))

    def _res(x, y):
        return x + (y if rule is None else y.to(x.dtype))

    def make_stage(mesh, pp_manual, impl):
        from ..core import prng
        from ..ops.dropout import dropout_keyed
        from ..sharding import comm

        tp_ax = comm.tensor_axis(mesh) if tp else None
        mp_group = mesh.group(tp_ax[0]) if tp_ax is not None else None
        dp_i = dp_n = None
        if mesh is not None and mesh.live and mesh.size("dp") > 1:
            dp_i, dp_n = mesh.index(("dp",))
        dp_fold = pp_manual and dp_n is not None

        def drop(v, key, site, mp_block):
            if infer_scale:
                return v * (1.0 - dropout_rate)
            if not use_dropout:
                return v
            k = prng.fold_in(key, torch.tensor(site, device=v.device))
            offset = 0
            if dp_fold:
                k = prng.fold_in(k, torch.tensor(dp_i, device=v.device))
            elif dp_n is not None:
                # no pp schedule: the whole batch's mask, this rank's
                # block of it
                offset = dp_i * v.numel()
            if mp_block is not None and site == 2:
                if pp_manual:
                    k = prng.fold_in(k, torch.tensor(mp_block[0],
                                                     device=v.device))
                else:
                    # the whole width's mask, this rank's columns
                    i, n = mp_block
                    w = v.shape[-1]
                    ones = torch.ones(tuple(v.shape[:-1]) + (w * n,),
                                      dtype=v.dtype, device=v.device)
                    m = dropout_keyed(ones, k, dropout_rate,
                                      offset * n)[..., i * w:(i + 1) * w]
                    return v * m
            return dropout_keyed(v, k, dropout_rate, offset)

        def stage_fn(p, x, mask, seed_m):
            kloc = p[0].shape[0]
            lbase = mesh.index(("pp",))[0] * kloc if pp_manual else 0
            local = p[0].shape[-1] != H * dk  # holds mp blocks
            mp_block = (tp_ax[1], tp_ax[2]) if local else None
            key0 = None
            if use_dropout:
                key0 = prng.fold_in(prng.prng_key(torch.tensor(
                    base_seed, device=x.device)), seed_m)
            xc = x
            for li in range(kloc):
                (qw_, kw_, vw_, ow_, g1, b1, w1, c1, w2, c2, g2,
                 b2) = (t[li] for t in p)
                B, T, _ = xc.shape
                key = (prng.fold_in(key0, torch.tensor(
                    lbase + li, device=x.device)) if use_dropout else None)
                Hl = qw_.shape[-1] // dk          # mp-local head count
                xin = comm.CopyToGroup.apply(xc, mp_group) if local else xc
                q = _mm(xin, qw_, rule)
                k_ = _mm(xin, kw_, rule)
                v_ = _mm(xin, vw_, rule)
                qh = q.reshape(B, T, Hl, dk)
                kh = k_.reshape(B, T, Hl, dk)
                vh = v_.reshape(B, T, Hl, dv)
                if impl == "pallas":
                    from ..ops.flash_attention import flash_attention

                    ctx = flash_attention(qh, kh, vh, kv_mask=mask)
                else:
                    ctx = attention(qh, kh, vh, mask=mask)
                ctx = ctx.reshape(B, T, Hl * dv)
                proj = _mm(ctx, ow_, rule)
                if local:                         # row-parallel partials
                    proj = comm.ReduceFromGroup.apply(proj, mp_group)
                proj = drop(proj, key, 0, mp_block)
                proj = drop(proj, key, 1, mp_block)
                xc = _ln(_res(xc, proj), g1, b1)
                xin = comm.CopyToGroup.apply(xc, mp_group) if local else xc
                h = torch.relu(_bias(_mm(xin, w1, rule), c1))
                h = drop(h, key, 2, mp_block)
                ffo = _mm(h, w2, rule)
                if local:
                    ffo = comm.ReduceFromGroup.apply(ffo, mp_group)
                ffo = _bias(ffo, c2)
                ffo = drop(ffo, key, 3, mp_block)
                xc = _ln(_res(xc, ffo), g2, b2)
            return xc

        return stage_fn

    def fn(x, mask, *rest):
        from ..core.trace_ctx import current_mesh
        from ..parallel.pipeline import (_sequential, gpipe, microbatch,
                                         unmicrobatch)

        if use_dropout:
            pv, cnt = rest[:-1], rest[-1]
        else:
            pv, cnt = rest, None
        mesh = current_mesh()
        live = mesh is not None and mesh.live
        S = mesh.size("pp") if live else 1
        mp_size = mesh.size("mp") if live else 1
        M = n_microbatches if S > 1 else 1
        impl = attn_impl or "fused"
        pp_manual = S > 1
        if tp and mp_size > 1:
            enforce(H % mp_size == 0 and f % mp_size == 0,
                    f"tensor parallelism over mp={mp_size} requires "
                    f"n_head ({H}) and d_inner_hid ({f}) divisible by it")
        stage = make_stage(mesh if live else None, pp_manual, impl)
        xmb = microbatch(x, M)
        mmb = microbatch(mask.to(x.dtype), M)
        c0 = cnt.reshape(()).to(torch.int32) if cnt is not None else \
            torch.zeros((), dtype=torch.int32, device=x.device)
        seeds = c0 * M + torch.arange(M, dtype=torch.int32,
                                      device=x.device)
        if not pp_manual:
            y = _sequential(stage, tuple(pv), xmb, (mmb, seeds))
        else:
            y = gpipe(stage, tuple(pv), xmb, mesh, side_mb=(mmb, seeds),
                      local=pv[0].shape[0] != L)
        y = unmicrobatch(y)
        return (y, (c0 + 1).reshape(cnt.shape)) if cnt is not None else y

    # a sharded run hands the op this rank's blocks of the stacked
    # weights (its stage's layers, its mp columns or rows)
    fn.block_inputs = ("Params",)
    helper.append_op(
        type="pipelined_encoder", inputs=in_names, outputs=outputs,
        attrs={"n_layer": L, "n_microbatches": n_microbatches}, fn=fn)
    out.shape = src_emb.shape
    return out


def _embed(ids, vocab_size, d_model, name, is_sparse=False,
           is_distributed=False):
    emb = layers.embedding(input=ids, size=[vocab_size, d_model],
                           is_sparse=is_sparse,
                           is_distributed=is_distributed,
                           param_attr=ParamAttr(name=name))
    emb = layers.scale(x=emb, scale=d_model ** 0.5)
    if flags.bf16_stream():
        # enter the bf16 activation stream at the embedding output; the
        # table and every parameter stay f32
        emb = layers.cast(emb, "bfloat16")
    return emb


def transformer_model(src_word, trg_word, src_mask, src_vocab_size,
                      trg_vocab_size, max_length=256, n_layer=6, n_head=8,
                      d_key=64, d_value=64, d_model=512, d_inner_hid=2048,
                      dropout_rate=0.1, is_test=False, tp=False,
                      weight_sharing=False, attn_impl=None,
                      pp_encoder=False, pp_microbatches=2,
                      sparse_embedding=False, distributed_embedding=False,
                      return_hidden=False):
    """Encoder-decoder -> next-token logits ``[B, T_trg, V_trg]``, or
    the decoder's last hidden states with ``return_hidden`` (for a head
    of the caller's, such as the fused projection + CE op).
    ``sparse_embedding`` gives both word tables row-sparse gradients;
    ``dropout_rate`` drops at the JAX package's sites in training;
    ``tp`` makes the attention and FFN blocks tensor-parallel.
    ``pp_encoder=True`` builds the encoder as :func:`pipelined_encoder`
    (under ``attn_impl="ring"`` the ring goes to the decoder and the
    pipelined encoder takes the dense ``"fused"`` attention);
    ``distributed_embedding=True`` splits both word tables' rows over
    the mesh's ``ep`` axis."""
    src_emb = _embed(src_word, src_vocab_size, d_model,
                     "src_word_emb_table", is_sparse=sparse_embedding,
                     is_distributed=distributed_embedding)
    src_emb = positional_encoding(src_emb, max_length)
    enc_input = pre_post_process_layer(None, src_emb, "nd", dropout_rate,
                                       is_test)
    if pp_encoder:
        # ring attention claims the sp axis and cannot nest inside the
        # pipeline's schedule: the pipelined encoder takes the dense
        # attention while the decoder keeps the ring
        enc_impl = None if attn_impl == "ring" else attn_impl
        enc_input = pipelined_encoder(
            enc_input, src_mask, n_layer, n_head, d_key, d_value, d_model,
            d_inner_hid, n_microbatches=pp_microbatches, is_test=is_test,
            tp=tp, attn_impl=enc_impl, dropout_rate=dropout_rate)
    else:
        for _ in range(n_layer):
            enc_input = encoder_layer(enc_input, src_mask, n_head, d_key,
                                      d_value, d_model, d_inner_hid,
                                      dropout_rate, is_test, tp=tp,
                                      attn_impl=attn_impl)
    enc_output = enc_input

    trg_table = ("src_word_emb_table" if weight_sharing
                 else "trg_word_emb_table")
    trg_emb = _embed(trg_word, trg_vocab_size, d_model, trg_table,
                     is_sparse=sparse_embedding,
                     is_distributed=distributed_embedding)
    trg_emb = positional_encoding(trg_emb, max_length)
    dec_input = pre_post_process_layer(None, trg_emb, "nd", dropout_rate,
                                       is_test)
    for _ in range(n_layer):
        dec_input = decoder_layer(dec_input, enc_output, src_mask, n_head,
                                  d_key, d_value, d_model, d_inner_hid,
                                  dropout_rate, is_test, tp=tp,
                                  attn_impl=attn_impl)
    if return_hidden:
        return dec_input
    predict = layers.fc(input=dec_input, size=trg_vocab_size,
                        num_flatten_dims=2, act=None,
                        param_attr=_tp((None, "mp"), tp))
    if tp:
        _gather_tp_output(predict)
    return predict


def _gather_tp_output(out):
    """Make the column-parallel fc producing ``out`` gather its columns
    (the loss reads whole logits): its product all-gathers over the
    tensor axis, and its bias is added to the whole output."""
    mul = next(op for op in reversed(out.block.ops) if op.attrs.get("_tp"))
    mul.attrs["tp_gather"] = True
    mul.attrs["_fn_attrs"] = list(mul.attrs.get("_fn_attrs", ())) + \
        ["tp_gather"]


def transformer_base(src_vocab_size=10000, trg_vocab_size=10000,
                     max_length=256, n_layer=6, n_head=8, d_model=512,
                     d_inner_hid=2048, dropout_rate=0.1,
                     label_smooth_eps=0.1, is_test=False, tp=False,
                     attn_impl=None, pp_encoder=False, pp_microbatches=2,
                     sparse_embedding=False, distributed_embedding=False,
                     fused_ce=False):
    """Build the full training graph: data vars, model, smoothed CE loss
    averaged over the real target tokens (``trg_mask``).

    ``fused_ce=True`` replaces the vocab fc + softmax_with_cross_entropy
    pair with the chunked op (``layers.fused_linear_softmax_ce``) that
    never forms the ``[B, T, V]`` logits; ``predict`` is then its raw
    logits head, computed only when fetched.

    Returns (feed_vars, avg_cost, predict)."""
    src_word = layers.data(name="src_word", shape=[-1, -1], dtype="int64",
                           append_batch_size=False)
    trg_word = layers.data(name="trg_word", shape=[-1, -1], dtype="int64",
                           append_batch_size=False)
    lbl_word = layers.data(name="lbl_word", shape=[-1, -1], dtype="int64",
                           append_batch_size=False)
    src_mask = layers.data(name="src_mask", shape=[-1, -1],
                           dtype="float32", append_batch_size=False)
    trg_mask = layers.data(name="trg_mask", shape=[-1, -1],
                           dtype="float32", append_batch_size=False)

    out = transformer_model(
        src_word, trg_word, src_mask, src_vocab_size, trg_vocab_size,
        max_length, n_layer, n_head, d_model // n_head, d_model // n_head,
        d_model, d_inner_hid, dropout_rate, is_test=is_test, tp=tp,
        attn_impl=attn_impl, pp_encoder=pp_encoder,
        pp_microbatches=pp_microbatches, sparse_embedding=sparse_embedding,
        distributed_embedding=distributed_embedding, return_hidden=fused_ce)
    if fused_ce:
        cost, predict = layers.fused_linear_softmax_ce(
            out, lbl_word, size=trg_vocab_size,
            smooth_eps=label_smooth_eps)
    else:
        predict = out
        cost = layers.softmax_with_cross_entropy(
            logits=predict, label=lbl_word, soft_label=False,
            smooth_eps=label_smooth_eps)
    cost = layers.squeeze(cost, axes=[-1])
    # mask padded target positions, average over real tokens
    masked = layers.elementwise_mul(x=cost, y=trg_mask)
    sum_cost = layers.reduce_sum(masked)
    token_count = layers.reduce_sum(trg_mask)
    avg_cost = layers.elementwise_div(x=sum_cost, y=token_count)

    feeds = [src_word, trg_word, lbl_word, src_mask, trg_mask]
    return feeds, avg_cost, predict
