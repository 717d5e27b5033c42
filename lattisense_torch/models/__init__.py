"""Reusable encrypted-workload builders (the framework's "model zoo").

Each model packages one of the reference's workload patterns
(examples/*_cpu) as an importable class: graph construction, required
rotation keys, input packing, and output decoding — so applications
compose workloads instead of re-writing example scripts.

Port of ``lattisense_tpu/models/``: each model compiles through the port's
frontend and ``load`` returns an ``FheTask`` on the context's device.
"""

from .logistic import LogisticRegressionScore
from .distance import PackedEuclideanDistance
from .polynomial import PolynomialEvaluator
from .convolution import PackedConv2d
from .matvec import EncryptedMatVec

__all__ = ['LogisticRegressionScore', 'PackedEuclideanDistance',
           'PolynomialEvaluator', 'PackedConv2d', 'EncryptedMatVec']
