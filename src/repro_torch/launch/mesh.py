"""Process groups and meshes (port of ``repro.launch.mesh``).

Nothing on a machine tells a program of its cluster, so ``init_process_group``
takes the backend, the rendezvous, the rank and the world size from its
caller: NCCL on the cards, gloo on the CPU.  It never falls back from one
backend to the other: a backend that does not start raises.

    init_process_group("nccl", "file:///tmp/pg", rank=0, world_size=1)
    info = small_mesh_info((1, 1), device_type="cuda")
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import MeshInfo

#: the production meshes: 16x16 over one pod (256 chips), 2x16x16 over two
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}
#: how long a collective or the rendezvous waits before the group fails
PG_TIMEOUT = datetime.timedelta(seconds=300)


def init_process_group(backend: str, init_method: str, *, rank: int,
                       world_size: int) -> None:
    """Start the default process group: ``init_method`` is a
    ``tcp://host:port`` or ``file://path`` rendezvous.  On ``"nccl"`` the
    rank's card is ``cuda:rank % device_count``."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl on the cards, gloo on "
                         "the CPU")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("nccl needs a CUDA device; none is available")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=PG_TIMEOUT)
    if dist.get_backend() != backend:
        raise RuntimeError(f"asked for {backend}, got {dist.get_backend()}")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default group's ranks, its dims
    named ``axes`` (the group must hold ``prod(shape)`` ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The assigned production meshes: 16x16 single pod (256 ranks) or
    2x16x16 multi-pod (512).  The 'pod' axis is pure DP; its gradient
    all-reduce crosses the slow inter-pod links (see grad compression).
    Raises unless the process group holds exactly that many ranks."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(f"the {'x'.join(map(str, shape))} production mesh "
                           f"needs a process group of {need} ranks, not {have}")
    return make_mesh(shape, axes, device_type)


def make_mesh_info(*, multi_pod: bool = False,
                   device_type: str = "cuda") -> MeshInfo:
    return MeshInfo(make_production_mesh(multi_pod=multi_pod,
                                         device_type=device_type))


def small_mesh_info(shape=(2, 2), axes=("data", "model"),
                    device_type: str = "cuda") -> MeshInfo:
    """A small mesh for tests and one-card runs (``(1, 1)`` on one card)."""
    return MeshInfo(make_mesh(shape, axes, device_type))
