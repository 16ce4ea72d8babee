"""DEPRECATION SHIM (counterpart of paddle_tpu/core/passes.py) — the
pass framework lives in ``paddle_tpu_torch.passes``.

The names re-exported here keep their ORIGINAL semantics:
``PassManager``/``apply_passes``/``inference_pass_pipeline`` run in
legacy mode (no invariant checks, no ``_passes_stamp``), so existing
callers — ``io.save_inference_model``'s export pipeline among them —
produce the programs and export keys they always did. New code should
import from ``paddle_tpu_torch.passes`` and use the checked, stamped
manager.
"""

from __future__ import annotations

from typing import Sequence, Union

from ..passes import (Pass, ProgramPass, get_pass, list_passes,  # noqa: F401
                      register_pass)
from ..passes import PassManager as _StrictPassManager
from ..passes.fusion import (AttentionFusePass,  # noqa: F401
                             DeadCodeEliminatePass, FcActFusePass,
                             TransposeEliminatePass, fuse_op_chain)
from ..passes.quantize import QuantizeInferencePass  # noqa: F401
from ..passes.transforms import (CastParamsBF16Pass,  # noqa: F401
                                 ConvBNFoldPass, MemoryOptimizePass)


class PassManager(_StrictPassManager):
    """Legacy ordered pipeline: no central invariant checks, no
    composed stamp."""

    def __init__(self, passes: Sequence[Union[str, Pass]]):
        super().__init__(passes, check=False, stamp=False)


def apply_passes(passes: Sequence[Union[str, Pass]], program,
                 scope=None):
    return PassManager(passes).apply(program, scope=scope)


def inference_pass_pipeline(fetch_names: Sequence[str]) -> "PassManager":
    """The default analysis pipeline applied to exported inference
    programs (reference: analyzer.h's ordered pass list), legacy mode
    (see ``passes.inference_pipeline`` for the checked/stamped
    variant)."""
    return PassManager([
        TransposeEliminatePass(keep=fetch_names),
        AttentionFusePass(keep=fetch_names),
        FcActFusePass(keep=fetch_names),
        DeadCodeEliminatePass(keep=fetch_names),
    ])
