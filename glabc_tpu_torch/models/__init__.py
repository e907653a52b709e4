from .distributions import DiagGaussian, Gamma, GaussianMixture, Uniform
from .problems import ABCProblem, HighDimMixtureProblem, MixtureProblem

__all__ = [
    "Uniform",
    "Gamma",
    "DiagGaussian",
    "GaussianMixture",
    "ABCProblem",
    "MixtureProblem",
    "HighDimMixtureProblem",
]
