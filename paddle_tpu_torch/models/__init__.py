"""Models of paddle_tpu_torch: the causal LM and the Transformer blocks
it is built from."""

from .causal_lm import causal_lm

__all__ = ["causal_lm"]
