"""ParamAttr (counterpart of paddle_tpu/param_attr.py).

``sharding`` is a parameter's mesh spec (``Parameter.sharding_spec``,
read by ``sharding.shard_program``'s plan). ``WeightNormParamAttr`` of
the JAX package is not ported yet.
"""

from __future__ import annotations


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 sharding=None):
        self.name = name
        self.sharding = sharding
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

    @staticmethod
    def _to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return ParamAttr(arg.name, arg.initializer, arg.learning_rate,
                             arg.regularizer, arg.trainable,
                             arg.gradient_clip, arg.sharding)
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, (list, tuple)):
            return ParamAttr._to_attr(arg[0])
        if arg is False:
            return ParamAttr(trainable=False)
        # an Initializer instance
        return ParamAttr(initializer=arg)
