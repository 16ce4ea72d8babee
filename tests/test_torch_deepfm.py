"""paddle_tpu_torch.models.deepfm held to paddle_tpu.models.deepfm on
the CPU.

DeepFM at its defaults but small, as tests/test_new_models.py builds
it: 1000 features, 10 fields, embed 8, MLP (32, 16), B=8, with
``is_distributed=True`` (the default: on one device both packages look
rows up in the plain table) and ``Adam(1e-3)``; the JAX package's start
state carried into the port with ``state_from_numpy``.

* Both packages build ``deepfm()`` at its full defaults (100000
  features, 39 fields, embed 16, MLP 400-400-400) to equal symbol
  tables, both tables annotated ``sharding_spec = ("ep", None)`` with
  dense gradients.
* At the small size: equal symbol tables; step 0's loss and
  probabilities within rtol 1e-5; three ``Adam`` steps' losses within
  rtol 1e-5 and every parameter update within 0.02 of the learning
  rate, element by element (tests/test_torch_dropout.py's bound);
  ``layers.auc`` on the probabilities within 1e-6 of the JAX package's
  and of the same threshold binning done in numpy.
"""

import numpy as np
import pytest
import torch

from _torch_port import package, symbol_table, train_both
from chip_smoke import numpy_auc

torch.set_num_threads(1)

SMALL = dict(num_features=1000, num_fields=10, embed_dim=8,
             mlp_dims=(32, 16))
B, LR, STEPS = 8, 1e-3, 3
UPDATE_TOL = 0.02  # |update_port - update_jax| / lr, element by element


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    F = SMALL["num_fields"]
    return {"feat_ids": rng.randint(0, SMALL["num_features"],
                                    (B, F)).astype(np.int64),
            "feat_vals": rng.rand(B, F).astype(np.float32),
            "label": rng.randint(0, 2, (B, 1)).astype(np.float32)}


def _deepfm(pkg):
    from importlib import import_module

    return import_module({"jax": "paddle_tpu.models.deepfm",
                          "torch": "paddle_tpu_torch.models.deepfm"}[pkg]
                         ).deepfm


def test_deepfm_defaults_build_distributed_tables():
    mains = {}
    for pkg in ("jax", "torch"):
        fluid, guard = package(pkg)
        mains[pkg] = fluid.Program()
        with guard(), fluid.program_guard(mains[pkg], fluid.Program()):
            _deepfm(pkg)()
    assert symbol_table(mains["torch"]) == symbol_table(mains["jax"])
    for main in mains.values():
        tables = [p for p in main.all_parameters()
                  if p.name.startswith("embedding")]
        assert [tuple(p.shape) for p in tables] == [(100000, 1),
                                                    (100000, 16)]
        for p in tables:
            assert p.sharding_spec == ("ep", None)
            assert not getattr(p, "sparse_grad", False)
        assert [op.attrs["is_distributed"] for op in main.global_block().ops
                if op.type == "lookup_table"] == [True, True]


@pytest.fixture(scope="module")
def run():
    def build(pkg, fluid):
        feeds, avg_cost, prob = _deepfm(pkg)(**SMALL)
        auc = fluid.layers.auc(prob, feeds[2])
        fluid.optimizer.Adam(learning_rate=LR).minimize(avg_cost)
        return [avg_cost, prob, auc]

    return train_both(build, _feed(), STEPS)


def test_deepfm_builds_the_jax_program(run):
    assert symbol_table(run["t_main"]) == symbol_table(run["j_main"])
    assert [op.type for op in run["t_main"].global_block().ops] == \
        [op.type for op in run["j_main"].global_block().ops]


def test_deepfm_step0_matches_the_jax_package(run):
    (j_cost, j_prob, _), (t_cost, t_prob, _) = run["j_out"][0], \
        run["t_out"][0]
    assert t_prob.shape == (B, 1)
    np.testing.assert_allclose(t_cost, j_cost, rtol=1e-5)
    np.testing.assert_allclose(t_prob, j_prob, rtol=1e-5)


def test_deepfm_trains_as_the_jax_package(run):
    losses = [float(o[0]) for o in run["t_out"]]
    np.testing.assert_allclose(losses, [float(o[0]) for o in run["j_out"]],
                               rtol=1e-5)
    assert losses[-1] < losses[0]
    for p in run["t_main"].all_parameters():
        p0 = run["state"][p.name]
        j_up = (run["j_state"][p.name] - p0) / LR
        t_up = (run["t_state"][p.name] - p0) / LR
        np.testing.assert_allclose(t_up, j_up, rtol=0, atol=UPDATE_TOL,
                                   err_msg=p.name)


@pytest.mark.parametrize("step", range(STEPS))
def test_deepfm_auc_matches_numpy_binning(run, step):
    feed = _feed()
    _, t_prob, t_auc = run["t_out"][step]
    _, _, j_auc = run["j_out"][step]
    assert abs(float(t_auc) - float(j_auc)) <= 1e-6
    assert abs(float(t_auc) - numpy_auc(t_prob, feed["label"])) <= 1e-6
