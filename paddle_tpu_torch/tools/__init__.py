"""Command-line tools of paddle_tpu_torch (counterpart of
paddle_tpu/tools): :mod:`tuning` (the kernel-tuning store), :mod:`cache`
(the compile cache), :mod:`trace` (chrome-trace exports),
:mod:`postmortem` (flight-recorder bundles), :mod:`top` (a training
steplog), :mod:`check_program` (the static verifier, ``--shard``/
``--comm`` included), :mod:`passes`, :mod:`launch` (the ranks of a
world), :mod:`ckpt` (checkpoint roots), :mod:`generate` (the decode
smoke), :mod:`fleet` (serving replicas: serve, status, drain),
:mod:`chaos` (fault plans against a workload) and
:mod:`print_signatures` (the public API surface)."""
