from .distributions import DiagGaussian, Gamma, GaussianMixture, Uniform
from .flows import CouplingFlow
from .kde import KernelDensity
from .problems import ABCProblem, HighDimMixtureProblem, MixtureProblem

__all__ = [
    "Uniform",
    "Gamma",
    "DiagGaussian",
    "GaussianMixture",
    "KernelDensity",
    "CouplingFlow",
    "ABCProblem",
    "MixtureProblem",
    "HighDimMixtureProblem",
]
