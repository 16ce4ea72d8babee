"""Models of paddle_tpu_torch: the causal LM and the Transformer blocks
it is built from, ResNet for ImageNet and CIFAR-10, VGG-16/19, and the
linear regression of book chapter 01 (``fit_a_line``)."""

from . import fit_a_line
from .causal_lm import causal_lm
from .resnet import (basicblock, bottleneck, build_train, conv_bn_layer,
                     resnet_cifar10, resnet_imagenet, s2d_stem)
from .vgg import vgg16, vgg19

__all__ = ["basicblock", "fit_a_line", "bottleneck", "build_train", "causal_lm",
           "conv_bn_layer", "resnet_cifar10", "resnet_imagenet", "s2d_stem",
           "vgg16", "vgg19"]
