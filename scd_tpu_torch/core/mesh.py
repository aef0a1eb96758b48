"""The device mesh over ``torch.distributed`` ranks, and padding helpers.

Port of ``scd_tpu/core/mesh.py``.  Two logical axes, as in the JAX
package:

- ``data``: shards instance rows (images, feature vectors, vocabulary
  names);
- ``model``: shards wide columns (the vocabulary axis of [D, V]) and,
  in the trainers, the tensor-parallel layers (``models/params.py::
  tp_layout``: qkv and fc1 by columns, proj and fc2 by rows).

One rank per device (``core/multihost.py``), so the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of the world's ranks laid out
data-major; :class:`MeshContext` exposes each axis's size, this rank's
index on it, its process group and the global ranks in it.  Cross-rank
reductions (EM sums, k-means++ potentials, top-k merges) are explicit
collectives over one axis's group; :func:`model_group` is what a
tensor-parallel layer carries.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from scd_tpu_torch.core.config import MeshConfig
from scd_tpu_torch.core.multihost import local_device, process_count


@dataclasses.dataclass
class MeshContext:
    """A (data, model) mesh of the world's ranks and this rank's place in
    it.  ``device`` is the device this rank computes on."""

    device_mesh: "torch.distributed.device_mesh.DeviceMesh"
    device: torch.device
    axis_names: tuple = ("data", "model")

    def _dim(self, axis: str) -> int:
        names = {"data": 0, "model": 1, self.axis_names[0]: 0,
                 self.axis_names[1]: 1}
        return names[axis]

    def axis_size(self, axis: str) -> int:
        return self.device_mesh.size(self._dim(axis))

    def axis_index(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(self._dim(axis))

    def group(self, axis: str):
        return self.device_mesh.get_group(self._dim(axis))

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's group on ``axis``, in axis
        order."""
        grid = self.device_mesh.mesh
        if self._dim(axis) == 0:
            return grid[:, self.model_index].tolist()
        return grid[self.data_index, :].tolist()

    @property
    def n_data(self) -> int:
        return self.axis_size("data")

    @property
    def n_model(self) -> int:
        return self.axis_size("model")

    @property
    def data_index(self) -> int:
        return self.axis_index("data")

    @property
    def model_index(self) -> int:
        return self.axis_index("model")

    @property
    def data_group(self):
        return self.group("data")

    @property
    def model_group(self):
        return self.group("model")

    @property
    def size(self) -> int:
        return self.n_data * self.n_model


def make_mesh(cfg: Optional[MeshConfig] = None) -> MeshContext:
    """The (data, model) mesh over every rank of the initialized world
    (``core.multihost.initialize``): ``model = max(1, cfg.model)``,
    ``data = cfg.data`` when it is > 0, else ``world // model``.  A mesh
    larger than the world raises the JAX package's message; every rank
    must be on the mesh, so a smaller one raises too."""
    cfg = cfg or MeshConfig()
    n = process_count()
    model = max(1, cfg.model)
    data = cfg.data if cfg.data > 0 else max(1, n // model)
    use = data * model
    if use > n:
        raise ValueError(
            f"mesh {data}x{model} needs {use} devices but only {n} are "
            f"visible — lower --mesh_data/--mesh_model or add devices "
            f"(one rank per device: torchrun --nproc_per_node {use})")
    if use < n:
        raise ValueError(f"mesh {data}x{model} uses {use} of the world's {n} "
                         "ranks; every rank must be on the mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(scd_tpu_torch.core.multihost.initialize)")
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh only supplies process groups: gloo's live in host memory
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (data, model),
                          mesh_dim_names=tuple(cfg.axis_names))
    return MeshContext(dm, local_device(), tuple(cfg.axis_names))


def single_rank(mesh) -> bool:
    """True when ``mesh`` is None or a mesh of one rank."""
    return mesh is None or (isinstance(mesh, MeshContext) and mesh.size == 1)


def check_mesh(mesh) -> Optional[MeshContext]:
    """``mesh`` when it is None or a :class:`MeshContext`; anything else
    (a JAX mesh, say) raises."""
    if mesh is None or isinstance(mesh, MeshContext):
        return mesh
    raise NotImplementedError(
        f"a mesh must be a scd_tpu_torch.core.mesh.MeshContext (make_mesh: "
        f"multi-device runs over torch.distributed ranks), not "
        f"{type(mesh).__name__}")


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """What a tensor-parallel layer carries: the process group of this
    rank's ``model`` axis, its size and this rank's index on it."""

    group: Any
    size: int
    index: int


def train_mesh(mesh) -> Optional[MeshContext]:
    """The mesh a trainer runs over, at any ``data x model``: None for no
    mesh or a mesh of one rank (the single-device path), else ``mesh``."""
    mesh = check_mesh(mesh)
    return None if single_rank(mesh) else mesh


def data_mesh(mesh) -> Optional[MeshContext]:
    """``mesh`` when its ``data`` axis has more than one rank, else None:
    the data-parallel collectives (row gathers, the gradient
    ``all_reduce``) run over that axis only, and ranks that differ only
    on the ``model`` axis hold the same rows."""
    return mesh if mesh is not None and mesh.n_data > 1 else None


def model_group(mesh) -> Optional[ModelGroup]:
    """The tensor-parallel context of ``mesh``'s ``model`` axis, None
    without a mesh or at a ``model`` axis of one rank."""
    if mesh is None or mesh.n_model == 1:
        return None
    return ModelGroup(mesh.model_group, mesh.n_model, mesh.model_index)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_rows(x: np.ndarray, multiple: int, fill=0.0):
    """Pad dim-0 of ``x`` to a multiple (for even sharding); returns
    (padded, n_valid)."""
    n = x.shape[0]
    target = pad_to_multiple(max(n, 1), multiple)
    if target == n:
        return x, n
    pad_width = [(0, target - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, constant_values=fill), n
