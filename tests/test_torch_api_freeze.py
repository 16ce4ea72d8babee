"""The port's public-API freeze: ``paddle_tpu_torch.tools.print_signatures
.collect()`` against the checked-in ``tests/torch_api_spec.txt``.

To change the port's API on purpose, regenerate the spec —
    python -c "from paddle_tpu_torch.tools.print_signatures import \
collect; open('tests/torch_api_spec.txt','w').write(chr(10).join(\
collect())+chr(10))"
and commit it with the change.
"""

import os

import torch

from paddle_tpu_torch.tools.print_signatures import MODULES, collect

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))


def test_public_api_matches_spec():
    spec = open(os.path.join(_HERE, "torch_api_spec.txt")).read() \
        .splitlines()
    now = collect()
    added = sorted(set(now) - set(spec))
    removed = sorted(set(spec) - set(now))
    assert not added and not removed, (
        "public API surface changed — if intentional, regenerate "
        "tests/torch_api_spec.txt (see module docstring).\n"
        f"ADDED ({len(added)}):\n  " + "\n  ".join(added[:20]) +
        f"\nREMOVED ({len(removed)}):\n  " + "\n  ".join(removed[:20]))


def test_module_list_is_the_jax_package_list():
    from paddle_tpu.tools import print_signatures as jps

    assert MODULES == [m.replace("paddle_tpu", "paddle_tpu_torch", 1)
                       for m in jps.MODULES]
