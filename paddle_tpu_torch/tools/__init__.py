"""Command-line tools of paddle_tpu_torch (counterpart of
paddle_tpu/tools). Ported: :mod:`tuning`, the kernel-tuning store's
maintenance and sweep CLI. The rest of the JAX package's tools wait
for their modules (ROADMAP Queue A step (f) and item 10)."""
