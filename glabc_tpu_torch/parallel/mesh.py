"""The chain axis over a 1-D device mesh: one process per GPU.

Port of ``glabc_tpu/parallel/mesh.py``.  JAX runs one controller over a
``Mesh`` of devices; the port runs SPMD instead: every rank of a
``torch.distributed`` group calls the same entry point with the same
arguments and the same generator seed, and ``mesh=`` is a 1-D
:class:`~torch.distributed.device_mesh.DeviceMesh` over the group.  Rank
``r`` of ``w`` owns the contiguous chains ``[r C/w, (r+1) C/w)``: it runs
them on its own card, with its first chain's global index as every
sampling kernel's ``chain0``, so its random streams are the ones a
one-device run gives those chains.  Collectives appear only where results
are gathered and in the adaptation epochs (``sharded.py``).

Launch one process per GPU, e.g. ``torchrun --nproc-per-node 4 run.py``,
call :func:`initialize_distributed` and pass ``mesh=make_mesh()``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.profiling import annotate

__all__ = ["CHAIN_AXIS", "initialize_distributed", "make_mesh",
           "shard_chains", "chain_range", "check_mesh", "gather_chains"]

CHAIN_AXIS = "chains"
# a collective that waits longer than this fails instead of hanging
_TIMEOUT = datetime.timedelta(seconds=600)


def initialize_distributed(backend: Optional[str] = None, *, store=None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None) -> None:
    """Join the process group, once.  A no-op when it is already
    initialized, or in a single process (no ``store`` and no
    ``WORLD_SIZE`` in the environment).

    ``backend``: ``'nccl'`` when CUDA is available, else ``'gloo'``.  The
    rendezvous is the usual ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
    ``WORLD_SIZE`` (as ``torchrun`` sets them), or ``store`` with ``rank``
    and ``world_size``.  Under NCCL the rank's card is ``cuda:LOCAL_RANK``
    (``rank`` when ``LOCAL_RANK`` is unset)."""
    if dist.is_initialized():
        return
    if store is None and "WORLD_SIZE" not in os.environ:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = dict(backend=backend, timeout=_TIMEOUT)
    if store is not None:
        if rank is None or world_size is None:
            raise ValueError("a store needs rank and world_size")
        kw.update(store=store, rank=rank, world_size=world_size)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank if rank is not None
                                   else os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(**kw)


def make_mesh(n_devices: Optional[int] = None):
    """The 1-D mesh over every rank of the group, dim name
    ``(CHAIN_AXIS,)``, of device type ``'cuda'`` under NCCL, else
    ``'cpu'``.  ``n_devices``, if given, must be the world size (each rank
    is one device)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"n_devices={n_devices}, but the group has {world} "
                         "ranks (one device each)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(CHAIN_AXIS,))


def check_mesh(mesh):
    """``(rank, world size, process group)`` of a 1-D ``DeviceMesh``;
    raises ``TypeError`` for anything else."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError("mesh must be a 1-D torch.distributed DeviceMesh "
                        f"(see make_mesh), got {type(mesh).__name__}")
    if mesh.ndim != 1:
        raise TypeError(f"mesh must be 1-D, got {mesh.ndim} dimensions")
    return mesh.get_local_rank(), mesh.size(), mesh.get_group()


def chain_range(num_chains: int, mesh) -> tuple:
    """``(chain0, C_local)``: this rank's first global chain and its
    count.  ``num_chains`` must divide by the mesh size."""
    rank, world, _ = check_mesh(mesh)
    if num_chains % world:
        raise ValueError(f"num_chains={num_chains} must divide by the mesh "
                         f"size {world}")
    local = num_chains // world
    return rank * local, local


def shard_chains(tree, mesh):
    """This rank's contiguous range of the leading (chain) axis of every
    tensor in ``tree`` (a tensor, or a tuple, list, NamedTuple or dict of
    them); 0-d tensors and non-tensors are kept whole (replicated)."""
    if isinstance(tree, torch.Tensor):
        if tree.dim() == 0:
            return tree
        c0, n = chain_range(tree.shape[0], mesh)
        return tree[c0:c0 + n]
    if isinstance(tree, dict):
        return {k: shard_chains(v, mesh) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_chains(v, mesh) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_chains(v, mesh) for v in tree)
    return tree


def gather_chains(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` joined along the leading (chain) axis in rank
    order (``all_gather_into_tensor``), on ``x``'s device; ``x`` itself
    when ``mesh`` is None."""
    if mesh is None:
        return x
    _, world, group = check_mesh(mesh)
    x = x.contiguous()
    out = x.new_empty((world * x.shape[0], *x.shape[1:]))
    with annotate("glabc.mesh.gather", out.numel() * out.element_size()):
        dist.all_gather_into_tensor(out, x, group=group)
    return out
