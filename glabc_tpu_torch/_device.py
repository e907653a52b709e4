"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_generator"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device.  Without a GPU and without ``device`` it raises: the
    port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "torch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def check_generator(generator: torch.Generator, device: torch.device):
    """Raise unless ``generator`` draws on ``device``'s type."""
    if not isinstance(generator, torch.Generator):
        raise TypeError("generator must be a torch.Generator, got "
                        f"{type(generator).__name__}")
    if generator.device.type != device.type:
        raise ValueError(f"generator is on {generator.device}, the run on "
                         f"{device}")
    return generator
