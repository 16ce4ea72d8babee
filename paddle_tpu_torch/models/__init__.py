"""Models of paddle_tpu_torch: the causal LM and the Transformer blocks
it is built from, and ResNet for ImageNet and CIFAR-10."""

from .causal_lm import causal_lm
from .resnet import (basicblock, bottleneck, build_train, conv_bn_layer,
                     resnet_cifar10, resnet_imagenet, s2d_stem)

__all__ = ["basicblock", "bottleneck", "build_train", "causal_lm",
           "conv_bn_layer", "resnet_cifar10", "resnet_imagenet", "s2d_stem"]
