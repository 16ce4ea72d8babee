"""The public ``fluid.initializer`` namespace (counterpart of
paddle_tpu/initializer_api.py; reference: python/paddle/fluid/
initializer.py ``__all__``)."""

from .core.initializer import (Bilinear, BilinearInitializer, Constant,
                               ConstantInitializer, Initializer, MSRA,
                               MSRAInitializer, Normal, NormalInitializer,
                               NumpyArrayInitializer, Uniform,
                               UniformInitializer, Xavier, XavierInitializer,
                               force_init_on_cpu, init_on_cpu)

__all__ = ["Bilinear", "BilinearInitializer", "Constant",
           "ConstantInitializer", "Initializer", "MSRA", "MSRAInitializer",
           "Normal", "NormalInitializer", "NumpyArrayInitializer", "Uniform",
           "UniformInitializer", "Xavier", "XavierInitializer",
           "force_init_on_cpu", "init_on_cpu"]
