"""Layer functions of paddle_tpu_torch: the ones the causal LM,
Transformer-base (training dropout and the fused projection + CE head
among them), ResNet and VGG training reach, and the learning-rate
schedules."""

from . import learning_rate_scheduler
from .conv import batch_norm, conv2d, layer_norm, pool2d
from .io import data
from .learning_rate_scheduler import (append_LARS, cosine_decay,
                                      exponential_decay, inverse_time_decay,
                                      natural_exp_decay, noam_decay,
                                      piecewise_decay, polynomial_decay)
from .nn import (cross_entropy, dropout, embedding, fc,
                 fused_linear_softmax_ce, mean, reduce_sum, softmax,
                 softmax_with_cross_entropy, square_error_cost, squeeze)
from .ops import elementwise_add, elementwise_div, elementwise_mul, relu, scale
from .tensor import cast

__all__ = ["append_LARS", "batch_norm", "cast", "conv2d", "cosine_decay",
           "cross_entropy", "data", "dropout", "elementwise_add",
           "elementwise_div", "elementwise_mul", "embedding",
           "exponential_decay", "fc", "fused_linear_softmax_ce",
           "inverse_time_decay", "layer_norm",
           "learning_rate_scheduler", "mean", "natural_exp_decay",
           "noam_decay", "piecewise_decay", "polynomial_decay", "pool2d",
           "reduce_sum", "relu", "scale", "softmax",
           "softmax_with_cross_entropy", "square_error_cost", "squeeze"]
