"""Device meshes for the port: a grid of `torch.device`s driven from one
process.

The JAX package's mesh is single-controller: `train_sharded(X, Y, cfg,
mesh)` returns the model and `CheckpointHandle.engine(serve, mesh=)` serves
from one process, with `shard_map` running one TRON loop per shard. The
port keeps those contracts with a plain grid: axes ("data", "model"), one
device per cell. The label shards (the columns) run their solves on
threads of their own (`core/dismec.py`), and the data axis lives inside
their solver ops.

A device may appear in several cells. That is the counterpart of the JAX
tests' `--xla_force_host_platform_device_count=8`: eight `cpu` entries run
a (2, 4) mesh in one process, and every cell `cuda:0` runs the whole mesh
logic on one card.

`make_production_mesh` gives the JAX package's production grid, (16, 16)
over ("data", "model") or (2, 16, 16) over ("pod", "data", "model"), as
axis names and sizes with no device behind a cell: the dry run
(`launch/dryrun.py`) reads per-device shapes off it through
`models/sharding.py`, whose spec functions handle `pod`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices: `devices[i][j]` is the cell at index i of
    `axis_names[0]` and j of `axis_names[1]`; `shape` maps each axis name
    to its extent, as a JAX mesh's does."""
    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, str] = AXES

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    def device(self, **coords: int) -> torch.device:
        """The device at the given index of each axis, by name (an axis
        left out is at index 0): `mesh.device(data=1, model=2)`."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh axes are {self.axis_names}; got "
                             f"{sorted(unknown)}")
        i, j = (coords.get(a, 0) for a in self.axis_names)
        return self.devices[i][j]

    @property
    def first(self) -> torch.device:
        """The device of cell (0, 0): where results are gathered."""
        return self.devices[0][0]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no device behind the cells: what the spec
    functions of `models/sharding.py` read (`shape`), for a grid larger
    than the machine."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def n_cells(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The JAX package's production grid (a TPU v5e-256 pod, or two):
    (16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model")."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(AXES, (16, 16))


def _check_device(dev: torch.device) -> torch.device:
    """A CUDA device must name a card that is present; nothing falls back
    to the CPU."""
    if dev.type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = 0 if dev.index is None else dev.index
        if index >= n:
            raise RuntimeError(
                f"mesh device {dev} is not present: this machine has {n} "
                "CUDA device(s); pass devices=['cpu'] * n for a mesh on "
                "the CPU")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"mesh devices are CUDA cards or the CPU; got {dev}")
    return dev


def make_host_mesh(data: int = 1, model: int = 1, *,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh. By default its cells are the distinct cards
    `cuda:0` ... `cuda:data*model-1`, and it raises when there are fewer.
    An explicit `devices` list (row-major, data * model entries) may
    repeat a device: `devices=["cpu"] * 8` is a (2, 4) mesh on the CPU,
    `["cuda:0"] * 4` a (1, 4) mesh on one card."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axis sizes must be >= 1, got "
                         f"({data}, {model})")
    n = data * model
    if devices is None:
        devices = [f"cuda:{i}" for i in range(n)]
    devices = [_check_device(torch.device(d)) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {n} devices; got "
                         f"{len(devices)}")
    grid = tuple(tuple(devices[i * model:(i + 1) * model])
                 for i in range(data))
    return Mesh(devices=grid)


def mesh_shape_dict(mesh: Mesh) -> dict:
    return dict(mesh.shape)
