"""Mesh construction, re-exported from paddle_tpu_torch.sharding (the
counterpart of paddle_tpu/parallel/mesh.py's compatibility shim); new
code should import from ``paddle_tpu_torch.sharding``."""

from __future__ import annotations

from ..sharding.mesh import (  # noqa: F401
    AXIS_ORDER, DeviceMesh, current_mesh, data_parallel_mesh,
    local_batch_slice, make_mesh, mesh_scope, sharding_for, training_mesh)
