"""Models of paddle_tpu_torch: the causal LM and the Transformer blocks
it is built from, ResNet for ImageNet and CIFAR-10, VGG-16/19,
SE-ResNeXt-50, the MNIST CNN and MLP, word2vec, DeepFM, BERT-base
pretraining, and the linear regression of book chapter 01
(``fit_a_line``)."""

from . import bert, deepfm, fit_a_line, mnist, se_resnext, word2vec
from .bert import bert_encoder, bert_pretrain
from .causal_lm import causal_lm
from .deepfm import deepfm as deepfm_model
from .mnist import mnist_cnn, mnist_mlp
from .resnet import (basicblock, bottleneck, build_train, conv_bn_layer,
                     resnet_cifar10, resnet_imagenet, s2d_stem)
from .se_resnext import se_resnext50
from .vgg import vgg16, vgg19

__all__ = ["basicblock", "bert", "bert_encoder", "bert_pretrain",
           "bottleneck", "build_train", "causal_lm", "conv_bn_layer",
           "deepfm", "deepfm_model", "fit_a_line", "mnist", "mnist_cnn",
           "mnist_mlp", "resnet_cifar10", "resnet_imagenet", "s2d_stem",
           "se_resnext", "se_resnext50", "vgg16", "vgg19", "word2vec"]
