"""Command-line tools of paddle_tpu_torch (counterpart of
paddle_tpu/tools). Ported: :mod:`tuning` (the kernel-tuning store),
:mod:`cache` (the compile cache), :mod:`trace` (chrome-trace exports),
:mod:`postmortem` (flight-recorder bundles) and :mod:`top` (a training
steplog). The rest of the JAX package's tools wait for their modules
(ROADMAP Queue A step (f4) and item 10)."""
