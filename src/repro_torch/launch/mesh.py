"""Production mesh construction (function, never module-level state).

The port of the JAX package's ``launch/mesh.py``, with the reference's
shapes and axis names:

Single pod : (16, 16)    axes ("data", "model")          — 256 devices
Multi-pod  : (2, 16, 16) axes ("pod", "data", "model")   — 512 devices

Data parallelism spans ("pod","data") on the multi-pod mesh; the "model" axis
carries TP / vocab / expert sharding. A mesh is a ``DeviceMesh`` over the
default process group's ranks (``torch.distributed.init_device_mesh``, as
``distrib/sharding.py`` builds its meshes), which must hold exactly the
mesh's device count: the dry-run starts a ``"fake"`` group of that size.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distrib.sharding import _device_type
from repro_torch.models.common import MeshPolicy


def _axes(ndim: int) -> tuple[str, ...]:
    return ("pod", "data", "model") if ndim == 3 else ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return init_device_mesh(_device_type(), shape, mesh_dim_names=_axes(len(shape)))


def make_debug_mesh(shape=(2, 2), axes=None) -> DeviceMesh:
    """Small mesh (the world size must be prod(shape)); the axes default to
    ("data", "model"), or ("pod", "data", "model") for three dims."""
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes or _axes(len(shape))))


def policy_for(mesh: DeviceMesh) -> MeshPolicy:
    dp = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    return MeshPolicy(mesh=mesh, dp=dp, tp="model")
