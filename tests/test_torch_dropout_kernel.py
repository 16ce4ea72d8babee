"""The dropout kernel (``paddle_tpu_torch/ops/dropout.py``) held to its
plain version, and its wrapper's dispatch.

On the CPU the wrapper runs ``plain_dropout`` (and fills
``counter_out``), and on a tensor it cannot take it raises. The tests
marked ``cuda`` need a card and skip here: the kernel's output, the
op's gradient and the counter's advance bit-equal to ``plain_dropout``
on the card, for f32 and bf16, a single element, an odd length and a
ragged length of 128*4099+37 elements, -0.0 and +-inf included. No JAX
here, so they run on a machine without it:

    python -m pytest tests/test_torch_dropout_kernel.py -m cuda --noconftest -q
"""

import pytest
import torch

from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.ops import dropout as dropout_ops

torch.set_num_threads(1)


def test_cpu_tensors_take_the_plain_version():
    x = torch.randn(5, 7)
    counter = torch.tensor(3, dtype=torch.int32)
    nxt = torch.empty((), dtype=torch.int32)
    before = dropout_ops.dropout_apply.launches
    out = dropout_ops.dropout_apply(x, 9, counter, 0.4, counter_out=nxt)
    assert torch.equal(out, dropout_ops.plain_dropout(x, 9, counter, 0.4))
    assert int(nxt) == 4 and dropout_ops.dropout_apply.launches == before


def test_the_threshold_is_one_minus_p_in_f32():
    assert dropout_ops.keep_threshold(0.1) == float(
        torch.tensor(1.0 - 0.1, dtype=torch.float32))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_kernel_refuses_what_it_does_not_take():
    dev = _card()
    counter = torch.tensor(0, dtype=torch.int32, device=dev)
    with pytest.raises(EnforceError):
        dropout_ops.dropout_apply(torch.zeros(4, dtype=torch.float16,
                                              device=dev), 1, counter, 0.5)
    with pytest.raises(EnforceError):
        dropout_ops.dropout_apply(torch.zeros(4, device=dev), 1,
                                  counter.to(torch.int64), 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 37, 128 * 4099 + 37])
def test_kernel_is_bit_equal_to_plain_dropout_on_the_card(dtype, n):
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(n)
    x = torch.randn(n, generator=g).to(dtype).to(dev)
    x[: min(n, 4)] = torch.tensor([-0.0, float("inf"), -1.5, 2.0][:n],
                                  dtype=dtype)
    counter = torch.tensor(9, dtype=torch.int32, device=dev)
    xt = x.clone().requires_grad_(True)
    out, nxt = dropout_ops.dropout(xt, 77, counter, 0.25)
    want = dropout_ops.plain_dropout(x, 77, counter, 0.25)
    torch.cuda.synchronize()
    assert int(nxt) == 10 and int(counter) == 9
    assert torch.equal(out.view(torch.uint8), want.view(torch.uint8))
    gr = torch.randn(n, generator=g).to(dtype).to(dev)
    out.backward(gr)
    want_g = dropout_ops.plain_dropout(gr, 77, counter, 0.25)
    assert torch.equal(xt.grad.view(torch.uint8), want_g.view(torch.uint8))
