"""Device meshes of the dry run and the launchers: a layout of named axes
(the JAX package's ``repro.launch.mesh``).

A ``Mesh`` records axis names and sizes and touches no device: building
one, as in the JAX package, never initialises a device.
``Mesh.device_mesh`` lays it over the ranks of an initialised process
group (``torch.distributed``): ``init_distributed`` starts the group of a
``torch.distributed.run`` launch (NCCL on ``cuda:LOCAL_RANK``, gloo on
the CPU), ``init_fake`` a fake one of any world size in one process (the
dry run's production meshes: collectives cost nothing and move nothing,
tensors are fake).  A process group is process-global, so the dry run
traces each sharded cell in a child process of its own.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

import torch


# (device type, sizes, names, world group) -> DeviceMesh: one set of
# process groups per layout and process group
_DEVICE_MESHES: dict = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        sizes = tuple(int(s) for s in self.axis_sizes)
        names = tuple(self.axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} do not match sizes {sizes}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"mesh sizes {sizes} must be positive")
        object.__setattr__(self, "axis_sizes", sizes)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    def device_mesh(self, device_type: str):
        """This layout as a ``torch.distributed`` ``DeviceMesh`` over the
        ranks of the initialised process group (ValueError unless one of
        world size ``size`` is)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size() if dist.is_initialized() else 1
        if not dist.is_initialized() or world != self.size:
            raise ValueError(
                f"mesh {self.axis_sizes} needs a process group of "
                f"{self.size} ranks, found "
                f"{world if dist.is_initialized() else 'none'}: start "
                f"{self.size} processes with python -m "
                "torch.distributed.run --nproc-per-node "
                f"{self.size}")
        key = (device_type, self.axis_sizes, self.axis_names,
               id(dist.group.WORLD))
        if key not in _DEVICE_MESHES:
            _DEVICE_MESHES[key] = init_device_mesh(
                device_type, self.axis_sizes, mesh_dim_names=self.axis_names)
        return _DEVICE_MESHES[key]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) with a "pod" axis."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    return Mesh(tuple(shape), tuple(axes))


def card_mesh() -> Mesh:
    """The one card's layout: (1, 1) ("data", "model")."""
    return make_test_mesh((1, 1))


def init_distributed(device=None) -> torch.device:
    """Start the process group of a ``torch.distributed.run`` launch (its
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT / LOCAL_RANK variables)
    unless one is running, and return this rank's device: NCCL on
    ``cuda:LOCAL_RANK`` for a CUDA ``device`` (None: CUDA), gloo on the
    CPU."""
    import torch.distributed as dist

    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device (pass "
                               "device='cpu' for gloo ranks)")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(kind)
    if not dist.is_initialized():
        if kind == "cuda":
            dist.init_process_group("nccl", device_id=dev)
        else:
            dist.init_process_group("gloo")
    return dev


def init_fake(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` ranks in this process (rank
    ``rank``): collectives return at once and move nothing.  For tracing
    a sharded step on fake tensors (the dry run)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
