"""A rank's share of a multi-chain run under ``mesh=`` (the whole run
without one): its contiguous chain range, the gather of its results and its
own checkpoint file.  See ``glabc_tpu_torch/parallel/mesh.py``."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..parallel.mesh import chain_range, check_mesh, gather_chains
from ..parallel.sharded import rank_generator
from ..utils.io import carry_path

__all__ = ["ChainShard"]


class ChainShard:
    """Rank ``r`` of ``w`` owns chains ``[chain0, chain0 + local)`` of
    ``total``; without a mesh, ``chain0 = 0`` and ``local = total``."""

    def __init__(self, num_chains: int, mesh=None):
        self.mesh = mesh
        self.total = int(num_chains)
        if mesh is None:
            self.rank, self.world = 0, 1
            self.chain0, self.local = 0, self.total
        else:
            self.rank, self.world, _ = check_mesh(mesh)
            self.chain0, self.local = chain_range(self.total, mesh)

    def keep(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's chains of a full-width ``x`` along ``dim``
        (contiguous)."""
        if self.mesh is not None:
            x = x.narrow(dim, self.chain0, self.local)
        return x.contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` joined along dim 0 (the chain axis)."""
        return gather_chains(x, self.mesh)

    def gather_host(self, a: np.ndarray, device) -> np.ndarray:
        """Every rank's chains of a host array ``a`` (this rank's) joined
        over the group, through ``device``, which the backend takes."""
        if self.mesh is None:
            return a
        own = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return self.gather(own).cpu().numpy()

    def local_generator(self, generator: torch.Generator):
        """The generator of this rank's own chains: ``generator`` itself
        unsharded, else a :func:`~glabc_tpu_torch.parallel.sharded.
        rank_generator` (one draw of ``generator``).  Its draws match a
        one-device run in distribution only."""
        if self.mesh is None:
            return generator
        return rank_generator(generator, self.mesh)

    def rng_arrays(self, shared: torch.Generator, local: torch.Generator
                   ) -> dict:
        """The generators' states for a checkpoint."""
        out = {"rng_state": local.get_state()}
        if self.mesh is not None:
            out["shared_rng_state"] = shared.get_state()
        return out

    def restore_rngs(self, arrays: dict, shared: torch.Generator
                     ) -> torch.Generator:
        """Set ``shared`` (and, under a mesh, a new local generator) from
        :meth:`rng_arrays`' states; returns the local generator."""
        state = lambda k: torch.as_tensor(arrays[k])
        if self.mesh is None:
            shared.set_state(state("rng_state"))
            return shared
        shared.set_state(state("shared_rng_state"))
        local = torch.Generator(device=shared.device)
        local.set_state(state("rng_state"))
        return local

    @property
    def meta(self) -> dict:
        return {"world_size": self.world}

    def path(self, checkpoint_path, resume: bool = False):
        """This rank's checkpoint file: ``checkpoint_path`` itself
        unsharded, ``<base>.rank<r>.npz`` under a mesh.  On ``resume``,
        raises ``ValueError`` when the file is missing but a checkpoint of
        another world size lies beside it (the rank would start afresh
        while others resume); a file of this rank but another world size
        fails the ``world_size`` entry of the checkpoint's metadata."""
        if checkpoint_path is None:
            return None
        base = carry_path(checkpoint_path)[:-len(".npz")]
        sharded = self.mesh is not None
        own = base + (f".rank{self.rank}" if sharded else "")
        others = ([base] + ([base + ".rank0"] if self.rank else [])
                  if sharded else [base + ".rank0"])
        if resume and not os.path.exists(carry_path(own)):
            for other in others:
                if os.path.exists(carry_path(other)):
                    raise ValueError(
                        f"checkpoint {carry_path(other)} was saved on "
                        f"another world size than this run's {self.world}; "
                        "resume on the world size that saved it")
        return own
