"""The port's kernels as torch.library custom ops, on the CPU.

Every kernel entry point is a ``paddle_tpu_torch::*`` op whose CPU
kernel is the plain version, whose CUDA kernel is the hand-written one,
and whose fake kernel gives tracing the shapes and dtypes. One
parametrised test over the seven ops:

* ``torch.library.opcheck`` (schema and declared mutations, the fake
  kernel against the real one, autograd registration, AOT dispatch with
  dynamic shapes) passes;
* for the four wrappers a traced program reaches (``flash_attention``
  with its backward, ``dropout``, ``fused_flat_update``,
  ``paged_window_attention``), a ``make_fx(tracing_mode="fake")`` trace
  holds the op and none of its plain body, which is what lets an
  exported graph run the kernel on a card;
* the launch counters do not move during the checks or the trace.
"""

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from paddle_tpu_torch.layers import nn as tnn
from paddle_tpu_torch.ops import _cuda
from paddle_tpu_torch.ops import dropout as dr
import importlib
fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
from paddle_tpu_torch.ops import fused_optimizer as fu
from paddle_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(1)

aten = torch.ops.aten


def _rand(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


def _flash_grads(q, k, v, do, mask):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    return torch.autograd.grad(fa.flash_attention(q, k, v, kv_mask=mask),
                               (q, k, v), do)


def _flash(rng):
    B, T, H, D = 2, 16, 2, 64
    q, k, v, do = (_rand(rng, B, T, H, D) for _ in range(4))
    mask = torch.ones(B, T)
    mask[1, 11:] = 0
    o, lse = fa.flash_fwd(q, k, v, False, None, mask)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, lse, do, False, None, mask)
    scale = D ** -0.5
    grad = [t.clone().requires_grad_() for t in (q, k, v)]
    return {
        "flash_fwd": ((*grad, mask, True, scale),
                      _flash_grads, (q, k, v, do, mask)),
        "flash_bwd_dq": ((q, k, v, o, lse, do, mask, False, scale), None,
                         None),
        "flash_bwd_dkv": ((q, k, v, lse, delta, do, mask, False, scale),
                          None, None),
    }


def _dropout(rng):
    x = _rand(rng, 4, 33)
    counter = torch.tensor(5, dtype=torch.int32)
    return {"dropout_apply": (
        (x, 7, counter, 0.25, torch.zeros((), dtype=torch.int32), False),
        lambda x, c: dr.dropout(x, 7, c, 0.25), (x, counter))}


def _fused(rng):
    n = 300
    p, g = _rand(rng, n), _rand(rng, n)
    lr = torch.tensor(0.01)
    accs = [_rand(rng, n).abs(), _rand(rng, n).abs()]
    shared = [torch.tensor(0.9), torch.tensor(0.999)]
    consts = [1.0, 0.9, 0.999, 1e-8]

    def update(p, g, lr, m1, m2, b1, b2):
        return fu.fused_flat_update("adam", p, g, lr, (m1, m2), (b1, b2),
                                    True, consts)

    return {"fused_flat_update": (
        ("adam", p, g, lr, accs, shared,
         [torch.empty(()), torch.empty(())], consts), update,
        (p, g, lr, *accs, *shared))}


def _paged(rng):
    B, T, H, D, nb, bs, mb = 2, 3, 2, 8, 6, 4, 3
    q = _rand(rng, B, T, H, D)
    kp, vp = _rand(rng, nb, bs, H, D), _rand(rng, nb, bs, H, D)
    tables = torch.tensor([[0, 2, -1], [4, 1, 3]], dtype=torch.int32)
    cached = torch.tensor([3, 7], dtype=torch.int32)
    return {"paged_window_attention": (
        (q, kp, vp, tables, cached, None, None, None),
        lambda *a: pa.paged_window_attention(*a), (q, kp, vp, tables, cached))}


def _mm(rng):
    a = _rand(rng, 5, 16, dtype=torch.bfloat16)
    b = _rand(rng, 16, 7, dtype=torch.bfloat16)
    return {"mm_f32": ((a, b), None, None)}


def _cases():
    rng = np.random.RandomState(0)
    out = {}
    for make in (_flash, _dropout, _fused, _paged, _mm):
        out.update(make(rng))
    return out


OPS = ("dropout_apply", "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd",
       "fused_flat_update", "mm_f32", "paged_window_attention")
# aten ops of each plain body that a trace of the wrapper must not hold
PLAIN_BODY = {
    "flash_fwd": (aten.exp.default, aten.bmm.default, aten.amax.default),
    "dropout_apply": (aten.bitwise_xor.Tensor, aten.bitwise_left_shift.Tensor),
    "fused_flat_update": (aten.sqrt.default,),
    "paged_window_attention": (aten._softmax.default, aten.bmm.default),
}


@pytest.mark.parametrize("name", OPS)
def test_kernel_is_a_custom_op(name):
    op = getattr(torch.ops.paddle_tpu_torch, name).default
    args, traced, example = _cases()[name]
    counts = _cuda.launch_counts()
    torch.library.opcheck(op, args)
    if traced is not None:
        gm = make_fx(traced, tracing_mode="fake")(*example)
        targets = [n.target for n in gm.graph.nodes
                   if n.op == "call_function"]
        assert op in targets, targets
        assert not set(PLAIN_BODY[name]) & set(targets), targets
        if name == "flash_fwd":  # the backward is the two backward ops
            assert torch.ops.paddle_tpu_torch.flash_bwd_dq.default \
                in targets
            assert torch.ops.paddle_tpu_torch.flash_bwd_dkv.default \
                in targets
    # nothing launched: CPU kernels and traces count nothing
    assert _cuda.launch_counts() == counts
