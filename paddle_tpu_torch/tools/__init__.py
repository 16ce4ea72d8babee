"""Command-line tools of paddle_tpu_torch (counterpart of
paddle_tpu/tools). Ported: :mod:`tuning` (the kernel-tuning store),
:mod:`cache` (the compile cache), :mod:`trace` (chrome-trace exports),
:mod:`postmortem` (flight-recorder bundles), :mod:`top` (a training
steplog), :mod:`check_program` (the static verifier, ``--shard``/
``--comm`` included), :mod:`passes`, :mod:`launch` (the ranks of a
world) and :mod:`ckpt` (checkpoint roots). ``chaos``, ``generate``,
``fleet`` and ``print_signatures`` wait for their modules (ROADMAP
Queue A item 10)."""
