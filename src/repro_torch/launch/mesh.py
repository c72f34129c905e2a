"""Meshes: ``torch.distributed`` device meshes over the process group.

The port of ``repro.launch.mesh``. JAX is single-controller: one process
sees every device and a mesh is an array of them. torch is
multi-controller: one process per device, all in one process group, and a
:class:`~torch.distributed.device_mesh.DeviceMesh` names the group's ranks
in the mesh's shape. So a mesh needs a process group first: ``torchrun``
(or a spawn that calls ``init_process_group``) for real devices,
:func:`card_group` for the one card of this process, and :func:`fake_group`
for the dry-run, whose fake group pretends to hold 256 or 512 ranks in one
CPU process (its collectives move nothing).

Every mesh is built by a function, never held as module state, so that
importing this module touches no process group (the reference's
docstring makes the same promise about jax's devices).
"""

from __future__ import annotations

import contextlib
import socket
from typing import Iterator, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_production_mesh", "make_mesh", "mesh_info", "card_group",
           "fake_group"]


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16×16 single pod (256 ranks) or 2×16×16 (two pods, 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> DeviceMesh:
    """A mesh over the group's first prod(shape) ranks (elastic: any group
    at least that large), its dims named ``axes``. On the card's group
    (NCCL) its device type is ``cuda``; on a gloo or fake group ``cpu``."""
    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {tuple(shape)}, have {have} — start "
            f"{n} processes (torchrun --nproc-per-node {n}), or run the "
            f"dry-run under fake_group({n})")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def mesh_info(mesh: DeviceMesh) -> dict:
    return {"axes": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "n_devices": int(np.prod(mesh.shape))}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def card_group() -> Iterator[None]:
    """A one-process NCCL group (world size 1) on this process's card, for
    a 1×1 mesh; destroyed on exit."""
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_group(world_size: int) -> Iterator[None]:
    """The dry-run's fake group: ``world_size`` ranks in this one process,
    this one rank 0; collectives return without moving data. Destroyed on
    exit, so another world size can follow."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
