"""Layer functions of paddle_tpu_torch: the ones the causal LM reaches."""

from .conv import layer_norm
from .io import data
from .nn import dropout, embedding, fc
from .ops import elementwise_add, relu, scale

__all__ = ["data", "dropout", "elementwise_add", "embedding", "fc",
           "layer_norm", "relu", "scale"]
