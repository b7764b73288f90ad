"""The serving cloud stage's device mesh.

The counterpart of ``repro/launch/mesh.py``.  A ``CloudMesh`` names its
axes (at most two: the last ``"model"``, a leading one ``"data"``), its
shape and the ``torch.device`` of each shard in row-major order; the
tensor-parallel executor (``repro_torch.distributed.tp``) places one
shard's weights and decode state on each.

By default shard ``i`` lies on card ``cuda:i``, and a mesh needing more
cards than are visible raises.  ``set_mesh_devices`` is the counterpart
of the reference's fake-device flag
(``--xla_force_host_platform_device_count``): a process-level mapping of
shard ``i`` onto the ``i``-th listed device, so ``["cpu"] * 8`` runs an
8-way mesh on the CPU and ``["cuda:0"] * 2`` a 2-way mesh on one card.
Nothing maps several shards onto one device unless that setting says so.
``reset_mesh_devices`` clears it.  ``make_production_mesh`` is the
reference's production mesh as shapes only: every shard on the meta
device, for the dry run (``launch.dryrun``) to price.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

# the mapping ``set_mesh_devices`` installs: None = the visible cards
_MESH_DEVICES: Optional[Tuple[torch.device, ...]] = None


def set_mesh_devices(devices: Sequence) -> None:
    """Map shard ``i`` of every mesh made from now on onto
    ``devices[i]`` (e.g. ``["cpu"] * 8``, ``["cuda:0"] * 2``)."""
    global _MESH_DEVICES
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("set_mesh_devices needs at least one device")
    _MESH_DEVICES = devs


def reset_mesh_devices() -> None:
    """Back to one shard on each visible card."""
    global _MESH_DEVICES
    _MESH_DEVICES = None


def _mapped_devices() -> Tuple[torch.device, ...]:
    """The devices meshes are made over: ``set_mesh_devices``' list, else
    ``cuda:0 .. cuda:n-1`` (none without a card)."""
    if _MESH_DEVICES is not None:
        return _MESH_DEVICES
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return tuple(torch.device("cuda", i) for i in range(n))


@dataclass(frozen=True)
class CloudMesh:
    """Axis names, shape and one device per shard (row-major)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def tp(self) -> int:
        """Size of the ``"model"`` axis (1 without one)."""
        return dict(zip(self.axis_names, self.shape)).get("model", 1)

    def key(self) -> tuple:
        """Hashable identity: axis names, shape and devices."""
        return (self.axis_names, self.shape,
                tuple(str(d) for d in self.devices))


def make_cloud_mesh(shape) -> CloudMesh:
    """The cloud stage's mesh: the last axis is tensor-parallel
    (``"model"``), a leading axis (if any) is ``"data"``.  Raises with an
    actionable message when fewer devices are mapped than the shape
    needs."""
    shape = tuple(int(d) for d in shape)
    if not shape or any(d < 1 for d in shape):
        raise ValueError(f"bad mesh shape {shape!r}")
    if len(shape) > 2:
        raise ValueError(f"cloud mesh is at most (data, model); got {shape!r}")
    need = 1
    for d in shape:
        need *= d
    have = _mapped_devices()
    if need > len(have):
        raise ValueError(
            f"cloud mesh {shape} needs {need} devices, {len(have)} are "
            f"mapped (repro_torch.launch.mesh.set_mesh_devices(['cuda:0'] * "
            f"{need}) puts every shard on one card, ['cpu'] * {need} on the "
            f"CPU)")
    for d in set(have[:need]):
        resolve_device(d)                  # a CUDA entry needs a card
    axes = ("model",) if len(shape) == 1 else ("data", "model")
    return CloudMesh(axes, shape, tuple(have[:need]))


def make_host_mesh(device="cuda") -> CloudMesh:
    """A 1-device ``(data, model)`` mesh on ``device`` (the card unless the
    caller names the CPU)."""
    return CloudMesh(("data", "model"), (1, 1), (resolve_device(device),))


def make_production_mesh(*, multi_pod: bool = False) -> CloudMesh:
    """The reference's production meshes, shapes and axes only: one pod
    ``(16, 16)`` as ``("data", "model")`` (256 chips), two
    ``(2, 16, 16)`` as ``("pod", "data", "model")`` (512), the pod axis
    composing with data parallelism.  Every shard lies on the meta
    device: the dry run prices the mesh, nothing runs on it.

    On H100s a 16-way ``"model"`` axis spans two 8-card NVLink domains,
    so its collectives partly cross the slower network between them:
    the collective term the dry run prices at ``NVLINK_BW`` is a lower
    bound.  Serving meshes stay ``make_cloud_mesh``'s, at most two
    axes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for d in shape:
        n *= d
    return CloudMesh(axes, shape, (torch.device("meta"),) * n)

