"""Layer functions of paddle_tpu_torch: the ones the causal LM and
Transformer-base training reach."""

from .conv import layer_norm
from .io import data
from .nn import (cross_entropy, dropout, embedding, fc, reduce_sum, softmax,
                 softmax_with_cross_entropy, squeeze)
from .ops import elementwise_add, elementwise_div, elementwise_mul, relu, scale
from .tensor import cast

__all__ = ["cast", "cross_entropy", "data", "dropout", "elementwise_add",
           "elementwise_div", "elementwise_mul", "embedding", "fc",
           "layer_norm", "reduce_sum", "relu", "scale", "softmax",
           "softmax_with_cross_entropy", "squeeze"]
