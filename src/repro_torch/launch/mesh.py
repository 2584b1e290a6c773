"""Device meshes of the dry run and the launchers: a layout of named axes
(the JAX package's ``repro.launch.mesh``).

A ``Mesh`` records axis names and sizes and touches no device: building
one, as in the JAX package, never initialises a device.  The port runs
on one card; a mesh of more than one device is a layout the dry run and
the sharding rules reason about (ROADMAP Queue 1 item 13d runs one).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


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
