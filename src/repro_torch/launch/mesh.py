"""Device meshes of the port (the reference's `repro.launch.mesh`).

Single pod: (16, 16), axes (data, model).  Multi-pod: (2, 16, 16), axes
(pod, data, model) — the pod axis carries pure data parallelism.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, one card a rank (``torchrun --nproc-per-node``
or ``init_process_group`` with an address, world size and rank).  One rank
needs no launcher: `ensure_process_group` makes a one-rank group over an
in-process ``HashStore``, which needs no TCP, so a mesh of one card (and
the policy over it) runs from a plain ``python`` process.  The dry run
resolves production meshes it cannot hold through `AbstractMesh`, the
shape alone, as the reference lowers against 256 forced host devices.

Functions, not module constants: importing this module touches no device
or process group.
"""
from __future__ import annotations

from dataclasses import dataclass

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes with no devices behind them."""
    axis_sizes: tuple
    mesh_dim_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.mesh_dim_names, self.axis_sizes))


def default_device_type() -> str:
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def ensure_process_group(n: int) -> None:
    """A default process group of ``n`` ranks: the one already made, or,
    for n = 1, a one-rank group over an in-process ``HashStore`` (gloo:
    nothing crosses a wire on one rank, so no backend's transport is
    set up)."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a mesh of {n} cards needs {n} ranks; the "
                               f"process group has {dist.get_world_size()}")
        return
    if n != 1:
        raise RuntimeError(
            f"a mesh of {n} cards needs {n} ranks: launch one process a "
            "card (torchrun --nproc-per-node) or call "
            "torch.distributed.init_process_group first")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(axis_sizes, names, device_type: str | None = None):
    """A DeviceMesh of ``axis_sizes`` named ``names`` over the process
    group's ranks (made for one rank if need be)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in axis_sizes:
        n *= s
    ensure_process_group(n)
    return init_device_mesh(device_type or default_device_type(),
                            tuple(axis_sizes), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, abstract: bool = False,
                         device_type: str | None = None):
    """The production mesh: a DeviceMesh over 256 (512) ranks, or with
    ``abstract`` its shape alone (the dry run's)."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    if abstract:
        return AbstractMesh(shape, names)
    return make_mesh(shape, names, device_type)


def make_local_mesh(data: int = 1, model: int = 1,
                    device_type: str | None = None):
    """A (data, model) mesh over the local ranks (tests, one card)."""
    return make_mesh((data, model), ("data", "model"), device_type)
