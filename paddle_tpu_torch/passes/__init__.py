"""Program passes of paddle_tpu_torch (counterpart of paddle_tpu/passes).

Ported: the declarative pass API and its registry (``base``), the
inference fusion family (``fc_act_fuse``, ``attention_fuse``,
``transpose_eliminate``, ``dce``; ``fusion``), the checked and stamped
pass manager with the inference pipeline ``io.save_inference_model``
runs (``manager``), ``memory_optimize``/``release_memory`` at every
level (``transforms``) and the ``remat_policy`` scheduling pass
(``schedule``). The other transforms (conv+BN fold, bf16 cast,
quantization) and the ``host_offload`` pass are not (ROADMAP Queue
A 8), nor is ``comm_overlap`` (Queue A 9).
"""

from .base import (Pass, PassError, build_pipeline, get_pass, list_passes,
                   pass_class, register_pass)
from .fusion import (AttentionFusePass, DeadCodeEliminatePass,
                     FcActFusePass, TransposeEliminatePass, fuse_op_chain)
from .manager import PassManager, apply_passes, inference_pass_pipeline
from .schedule import RematPolicyPass, apply_remat_policy
from .transforms import memory_optimize, release_memory

#: legacy alias (core/passes.py ProgramPass) — same class
ProgramPass = Pass

__all__ = ["AttentionFusePass", "DeadCodeEliminatePass", "FcActFusePass",
           "Pass", "PassError", "PassManager", "ProgramPass",
           "RematPolicyPass", "TransposeEliminatePass", "apply_passes",
           "apply_remat_policy", "build_pipeline", "fuse_op_chain", "get_pass", "inference_pass_pipeline",
           "list_passes", "memory_optimize", "pass_class", "register_pass",
           "release_memory"]
