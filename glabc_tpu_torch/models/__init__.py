from .distributions import DiagGaussian, Gamma, GaussianMixture, Uniform
from .flows import CouplingFlow
from .kde import KernelDensity
from .problems import (ABCProblem, GKProblem, HighDimMixtureProblem,
                       MA2Problem, MixtureProblem)

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
    "GKProblem",
    "MA2Problem",
]
