"""Program passes of paddle_tpu_torch (counterpart of paddle_tpu/passes).

Ported: the declarative pass API and its registry (``base``), the
inference fusion family (``fc_act_fuse``, ``attention_fuse``,
``transpose_eliminate``, ``dce``; ``fusion``), the checked and stamped
pass manager with the inference pipeline ``io.save_inference_model``
runs (``manager``), the conv+BN fold and bf16 cast transforms
(``conv_bn_fold``, ``cast_params_bf16``), the bf16 autocast rewrite
(``amp_bf16``), the SPMD ``sharding`` pass
(``sharding.shard_program``) and ``memory_optimize``/``release_memory`` at every
level, also as the registered ``memory_optimize`` pass
(``transforms``), int8 quantization — post-training for serving
(``ptq_int8``: :func:`calibrate_program` + :class:`QuantizePass`,
composed by :func:`quantize_for_serving`) and the QAT freeze
(``quantize_inference``, :class:`QuantizeTranspiler`; ``quantize``) —
and the ``remat_policy`` and ``host_offload`` scheduling passes
(``schedule``). ``comm_overlap`` waits for the communication analysis
(ROADMAP Queue A 9) and raises when constructed. ``python -m
paddle_tpu_torch.tools.passes`` is the CLI.
"""

from .base import (Pass, PassError, build_pipeline, get_pass, list_passes,
                   pass_class, register_pass)
from .fusion import (AttentionFusePass, DeadCodeEliminatePass,
                     FcActFusePass, TransposeEliminatePass, fuse_op_chain)
from .manager import (PassManager, apply_passes, inference_pass_pipeline,
                      refresh_program_types)
from .quantize import (DEFAULT_INT8_OP_TYPES, CalibrationResult,
                       QuantizeInferencePass, QuantizePass,
                       QuantizeTranspiler, calibrate_program,
                       quantizable_activations, quantize_for_serving)
from .schedule import (CommOverlapPass, HostOffloadPass, RematPolicyPass,
                       apply_remat_policy)
from .transforms import (AmpRewritePass, CastParamsBF16Pass, ConvBNFoldPass,
                         InferenceTranspiler, MemoryOptimizePass,
                         ShardingPass, memory_optimize, release_memory,
                         transpile_to_bfloat16)

#: legacy alias (core/passes.py ProgramPass) — same class
ProgramPass = Pass


def inference_pipeline(fetch_names, check: bool = True,
                       stamp: bool = True) -> PassManager:
    """The default pipeline for exported inference programs (reference:
    analyzer.h's ordered pass list): transpose elimination → attention
    fusion → fc+act fusion → DCE, with ``fetch_names`` as barriers.
    ``io.save_inference_model`` runs it in legacy mode (check=False,
    stamp=False)."""
    return PassManager([
        TransposeEliminatePass(keep=fetch_names),
        AttentionFusePass(keep=fetch_names),
        FcActFusePass(keep=fetch_names),
        DeadCodeEliminatePass(keep=fetch_names),
    ], check=check, stamp=stamp)


__all__ = [
    "Pass", "PassError", "PassManager", "ProgramPass",
    "apply_passes", "build_pipeline", "get_pass", "list_passes",
    "pass_class", "register_pass", "refresh_program_types",
    "inference_pipeline", "inference_pass_pipeline",
    # fusion family
    "AttentionFusePass", "DeadCodeEliminatePass", "FcActFusePass",
    "TransposeEliminatePass", "fuse_op_chain",
    # transforms
    "AmpRewritePass", "CastParamsBF16Pass", "ConvBNFoldPass",
    "InferenceTranspiler", "MemoryOptimizePass", "ShardingPass",
    "memory_optimize", "release_memory", "transpile_to_bfloat16",
    # quantization
    "DEFAULT_INT8_OP_TYPES", "CalibrationResult",
    "QuantizeInferencePass", "QuantizePass", "QuantizeTranspiler",
    "calibrate_program", "quantizable_activations",
    "quantize_for_serving",
    # scheduling
    "CommOverlapPass", "HostOffloadPass", "RematPolicyPass",
    "apply_remat_policy",
]
