"""Process groups and device meshes (counterpart of
``repro/launch/mesh.py``).

JAX is single-controller: one process sees every device and a mesh is a
grid of them. PyTorch is multi-controller: one process per rank, joined
in a ``torch.distributed`` process group, and a mesh is a
``DeviceMesh`` over the group's ranks with the reference's axis names
(``pod``, ``data``, ``model``, ``pipe``). The backend follows the
device: NCCL on the card, gloo on the CPU; a run never falls back from
one to the other.

Functions, not module-level constants: importing this module touches no
device and joins no group.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.device import resolve_device

#: How long a collective may wait for its peers before it raises.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device=None, *, init_method: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT
                     ) -> torch.device:
    """Join the default process group on ``device`` (``None`` = CUDA;
    raises without one) and return the rank's device.

    Under ``torchrun`` the rank, world size and rendezvous come from its
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``env://``).
    Otherwise pass ``init_method`` (a ``file://`` store, which needs no
    port) with ``rank`` and ``world_size``. Every collective gives up
    after ``timeout``. On CUDA the rank's device is ``cuda:LOCAL_RANK``
    (``cuda:0`` without torchrun). A group that is already joined is
    kept.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    if dist.is_initialized():
        return dev
    if init_method is None and "WORLD_SIZE" in os.environ:
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
    if init_method is None or rank is None or world_size is None:
        raise ValueError("no process group to join: run under torchrun, or "
                         "pass init_method (file://...), rank and "
                         "world_size")
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=timeout,
                            device_id=dev if dev.type == "cuda" else None)
    return dev


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """Join a *fake* process group of ``world_size`` ranks in this one
    process, as ``rank``: collectives return at once and move nothing,
    which is what a dry run over a production mesh (256 or 512 ranks)
    needs. The fake backend is PyTorch's testing module
    (``torch.testing._internal.distributed.fake_pg``), a private API:
    this is the one place that imports it. A group already joined
    raises; :func:`torch.distributed.destroy_process_group` leaves it."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:      # a torch without its testing modules
        raise RuntimeError(
            "this torch has no fake process group "
            "(torch.testing._internal.distributed.fake_pg): the dry run "
            f"over a production mesh needs it ({e})") from e
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed group is already joined; "
                           "destroy it before joining a fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def world_size() -> int:
    """The default group's size, or 1 outside a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape, axes, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the default group's ranks, with
    axis names ``axes`` (tests, examples, elastic rescale). The group must
    be joined (:func:`init_distributed`) and hold exactly prod(shape)
    ranks; ``device`` (``None`` = CUDA) gives the device type."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "repro_torch.launch.mesh.init_distributed() first "
                           "or run under torchrun")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the "
                         f"torch.distributed group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """Single pod: (16, 16) = 256 ranks (data, model). Multi-pod:
    (2, 16, 16) = 512 ranks (pod, data, model); the ``pod`` axis carries
    cross-pod data parallelism (the gradient all-reduce)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device)


def make_host_mesh(model: int = 1, device=None) -> DeviceMesh:
    """(world // model, model) over (data, model): whatever the group
    holds, ``model`` ranks wide."""
    n = world_size()
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"{n} rank(s) of the torch.distributed group")
    return make_mesh((n // model, model), ("data", "model"), device)
