"""Layer functions of paddle_tpu_torch (counterpart of
paddle_tpu/layers): every function of the JAX package's
``layers/{ops,tensor,nn}.py``, its metrics (``accuracy``, ``auc``,
``mean_iou``, ``precision_recall``; ``chunk_eval`` raises), the conv
tier, ``data`` and the learning-rate schedules.
``layer_helper.append_activation`` finds an ``act=`` by its name
here."""

from . import learning_rate_scheduler
from .conv import batch_norm, conv2d, layer_norm, pool2d
from .io import data
from .learning_rate_scheduler import (append_LARS, cosine_decay,
                                      exponential_decay, inverse_time_decay,
                                      natural_exp_decay, noam_decay,
                                      piecewise_decay, polynomial_decay)
from .metric_op import accuracy, auc, chunk_eval, mean_iou, precision_recall
from .nn import (argmax, autoincreased_step_counter, concat, cos_sim, crop,
                 cross_entropy, dice_loss, dropout, embedding, fc,
                 fused_linear_softmax_ce, gather, l2_normalize, label_smooth,
                 log_softmax, matmul, mean, mul, multiplex, one_hot, pad,
                 random_crop, reduce_max, reduce_mean, reduce_min, reduce_prod,
                 reduce_sum, reshape, row_conv, sampling_id,
                 sigmoid_cross_entropy_with_logits, slice, smooth_l1, softmax,
                 softmax_with_cross_entropy, split, square_error_cost, squeeze,
                 stack, topk, transpose, unsqueeze)
from .ops import (abs, brelu, ceil, clip, clip_by_norm, cos, elementwise_add,
                  elementwise_div, elementwise_max, elementwise_min,
                  elementwise_mul, elementwise_pow, elementwise_sub, elu, exp,
                  floor, gaussian_random, gaussian_random_batch_size_like,
                  gelu, hard_shrink, hard_sigmoid, leaky_relu, log,
                  logical_xor, logsigmoid, maxout, polygon_box_transform, pow,
                  reciprocal, relu, relu6, round, rsqrt, scale, scatter,
                  sigmoid, sin, soft_relu, softplus, softshrink, softsign,
                  sqrt, square, stanh, sum, swish, tanh, tanh_shrink,
                  thresholded_relu, uniform_random,
                  uniform_random_batch_size_like)
from .tensor import (argmin, argsort, assign, cast, create_global_var,
                     create_parameter, create_tensor, cumsum, fill_constant,
                     fill_constant_batch_size_like, increment, ones, reverse,
                     shape, sums, zeros)

__all__ = ['abs', 'accuracy', 'append_LARS', 'argmax', 'argmin', 'argsort',
           'assign', 'auc', 'autoincreased_step_counter', 'batch_norm',
           'brelu', 'cast', 'ceil', 'chunk_eval', 'clip', 'clip_by_norm',
           'concat', 'conv2d', 'cos', 'cos_sim', 'cosine_decay',
           'create_global_var', 'create_parameter', 'create_tensor', 'crop',
           'cross_entropy', 'cumsum', 'data', 'dice_loss', 'dropout',
           'elementwise_add', 'elementwise_div', 'elementwise_max',
           'elementwise_min', 'elementwise_mul', 'elementwise_pow',
           'elementwise_sub', 'elu', 'embedding', 'exp', 'exponential_decay',
           'fc', 'fill_constant', 'fill_constant_batch_size_like', 'floor',
           'fused_linear_softmax_ce', 'gather', 'gaussian_random',
           'gaussian_random_batch_size_like', 'gelu', 'hard_shrink',
           'hard_sigmoid', 'increment', 'inverse_time_decay', 'l2_normalize',
           'label_smooth', 'layer_norm', 'leaky_relu',
           'learning_rate_scheduler', 'log', 'log_softmax', 'logical_xor',
           'logsigmoid', 'matmul', 'maxout', 'mean', 'mean_iou', 'mul',
           'multiplex', 'natural_exp_decay', 'noam_decay', 'one_hot', 'ones',
           'pad', 'piecewise_decay', 'polygon_box_transform',
           'polynomial_decay', 'pool2d', 'pow', 'precision_recall',
           'random_crop', 'reciprocal', 'reduce_max', 'reduce_mean',
           'reduce_min', 'reduce_prod', 'reduce_sum', 'relu', 'relu6',
           'reshape', 'reverse', 'round', 'row_conv', 'rsqrt', 'sampling_id',
           'scale', 'scatter', 'shape', 'sigmoid',
           'sigmoid_cross_entropy_with_logits', 'sin', 'slice', 'smooth_l1',
           'soft_relu', 'softmax', 'softmax_with_cross_entropy', 'softplus',
           'softshrink', 'softsign', 'split', 'sqrt', 'square',
           'square_error_cost', 'squeeze', 'stack', 'stanh', 'sum', 'sums',
           'swish', 'tanh', 'tanh_shrink', 'thresholded_relu', 'topk',
           'transpose', 'uniform_random', 'uniform_random_batch_size_like',
           'unsqueeze', 'zeros']
