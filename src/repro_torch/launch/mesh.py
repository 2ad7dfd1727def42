"""Device meshes on the port (counterpart of the reference's
``src/repro/launch/mesh.py``): device slots, stage meshes, the dry run's
abstract production meshes, placement of a tensor onto a mesh by a spec,
and the roofline constants of the card.

The reference lays its pipelines on a mesh of JAX devices; its tests
make eight "devices" out of one CPU
(``--xla_force_host_platform_device_count=8``). The port's counterpart
is a :class:`DeviceSlot`: a distinct ``id`` on a ``torch.device``.
Several slots may share one card, each then running its stage on its
own CUDA stream; on a machine with several cards the default pool
(:func:`default_pool`) is the cards themselves. A wire hop between two
slots is a copy only where their devices differ. Nothing falls back to
slots when cards are missing: a caller that wants slots asks for them
(:func:`device_slots`).

A spec is a tuple with one entry per leading dimension of a tensor: an
axis name, a tuple of axis names, or None (the dimension is whole on
every slot); ``()`` places the whole tensor on every slot (the
reference's ``P()``). :func:`place` cuts a tensor by a spec into one
:class:`Sharded` shard per slot, each a fresh copy on its slot's device.

The reference's ``mesh_context`` only bridges JAX versions (``jax.
set_mesh`` against a ``Mesh`` used as a context); torch has no ambient
mesh, so the port has no counterpart and its callers pass the mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.device import resolve_device

# NVIDIA H100 80GB HBM3 (SXM5, 700 W), NVIDIA's data sheet, dense rates:
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 on the tensor cores
HBM_BW = 3.35e12                # bytes/s, HBM3
NVLINK_BW = 450e9               # NVLink 4: 900 GB/s a card, 450 a direction
CHIP_HBM = 80 * 2**30           # 80 GB; on a card, chip_hbm() reads it


def chip_hbm() -> int:
    """The card's memory in bytes as ``torch.cuda.get_device_properties``
    reports it, or the data sheet's :data:`CHIP_HBM` without a card."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return CHIP_HBM


@dataclass(frozen=True)
class DeviceSlot:
    """One place a stage runs: a distinct ``id`` on ``device``."""
    id: int
    device: torch.device

    def __repr__(self) -> str:
        return f"DeviceSlot({self.id}, {self.device})"


def device_slots(n: int, device="cuda") -> list[DeviceSlot]:
    """n slots on one device (the card by default; raises without one).
    A CUDA device without an index takes the current one."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [DeviceSlot(i, dev) for i in range(n)]


def default_pool() -> list[DeviceSlot]:
    """One slot a card, for the cards ``torch.cuda.device_count()`` sees
    (none without a card)."""
    if not torch.cuda.is_available():
        return []
    return [DeviceSlot(i, torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


class Mesh:
    """A grid of device slots with named axes: ``axis_names``, ``shape``
    (axis -> size, in axis order, as JAX's ``mesh.shape``: ``mesh.shape.
    get("model", 1)`` reads the same), ``devices`` (a numpy object array
    of slots, or None for an abstract mesh, the dry run's) and
    ``size``."""

    def __init__(self, axis_names, sizes, devices=None):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in sizes)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"{len(sizes)} sizes for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, sizes))
        self.size = math.prod(sizes)
        if devices is not None:
            devices = np.asarray(devices, dtype=object).reshape(sizes)
        self.devices = devices

    def __repr__(self) -> str:
        kind = "abstract" if self.devices is None else "slots"
        return f"Mesh({self.shape}, {kind})"

    def slot(self, coords: dict) -> DeviceSlot:
        """The slot at ``coords`` (axis -> index; an axis left out is 0)."""
        if self.devices is None:
            raise ValueError(f"{self!r} is abstract: it has no device "
                             "slots to run on (a dry-run mesh)")
        return self.devices[tuple(coords.get(a, 0)
                                  for a in self.axis_names)]

    def indices(self):
        """Every slot's coordinates, in row-major order."""
        for index in np.ndindex(*self.shape.values()):
            yield dict(zip(self.axis_names, index))

    def device_set(self) -> set:
        return {self.devices[i].device for i in np.ndindex(
            *self.devices.shape)} if self.devices is not None else set()


def make_stage_mesh(n_stages: int, n_replicas: int = 1, *,
                    stage_axis: str = "stage", data_axis: str = "data",
                    devices=None) -> Mesh:
    """Mesh for the heterogeneous CNN layer pipeline: one slot a stage,
    replicated along a leading data axis when ``n_replicas`` > 1 (each
    data row a whole pipeline). 1-D ``(stage,)`` at R 1, ``(data,
    stage)`` above.

    ``devices``: exactly ``n_stages * n_replicas`` slots (the serving
    tier cuts one disjoint slice a replica out of its pool). Default:
    the first that many of :func:`default_pool`, raising when the cards
    are too few."""
    shape = (n_replicas, n_stages) if n_replicas > 1 else (n_stages,)
    axes = (data_axis, stage_axis) if n_replicas > 1 else (stage_axis,)
    need = n_stages * n_replicas
    if devices is not None:
        if len(devices) != need:
            raise ValueError(f"stage mesh needs exactly {need} devices "
                             f"({n_stages} stages x {n_replicas} "
                             f"replicas), got {len(devices)}")
        return Mesh(axes, shape, list(devices))
    pool = default_pool()
    if len(pool) < need:
        raise ValueError(
            f"stage mesh needs {need} devices ({n_stages} stages x "
            f"{n_replicas} replicas), have {len(pool)} cards; pass "
            "devices=device_slots(n, device) for slots on one device")
    return Mesh(axes, shape, pool[:need])


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as an abstract mesh: (16, 16)
    ``(data, model)``, or (2, 16, 16) ``(pod, data, model)``."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_test_mesh(*, n_data: int = 2, n_model: int = 2,
                   n_pod: int = 0) -> Mesh:
    """The reference's small test mesh, abstract."""
    if n_pod:
        return Mesh(("pod", "data", "model"), (n_pod, n_data, n_model))
    return Mesh(("data", "model"), (n_data, n_model))


# --- placement ---------------------------------------------------------------

def _norm_spec(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the "
                         f"tensor's {ndim} dimensions")
    return spec + (None,) * (ndim - len(spec))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _shard_slices(shape, mesh: Mesh, spec, coords: dict) -> tuple:
    """The slices of a tensor of ``shape`` that the slot at ``coords``
    holds under ``spec``."""
    out = []
    for dim, entry in zip(shape, _norm_spec(spec, len(shape))):
        axes = _axes(entry)
        n = math.prod(mesh.shape[a] for a in axes)
        if dim % n:
            raise ValueError(f"dimension {dim} does not divide over axes "
                             f"{axes} of {n} slots")
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + coords[a]
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


class Sharded:
    """A tensor placed on a mesh by a spec (the port's counterpart of a
    ``jax.Array`` with a ``NamedSharding``): ``shard(coords)`` is the
    slot's part, on the slot's device."""

    def __init__(self, mesh: Mesh, spec, shape, dtype, shards: dict):
        self.mesh, self.spec = mesh, tuple(spec)
        self.shape, self.dtype = tuple(shape), dtype
        self._shards = shards

    def shard(self, coords: dict) -> torch.Tensor:
        return self._shards[tuple(coords.get(a, 0)
                                  for a in self.mesh.axis_names)]

    def shards(self) -> list[torch.Tensor]:
        return list(self._shards.values())

    @property
    def nbytes_per_slot(self) -> int:
        return max(t.numel() * t.element_size() for t in self._shards.values())

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first slot's)."""
        first = next(iter(self._shards.values()))
        out = torch.empty(self.shape, dtype=self.dtype,
                          device=device or first.device)
        for coords in self.mesh.indices():
            out[_shard_slices(self.shape, self.mesh, self.spec, coords)] = \
                self.shard(coords)
        return out

    def __repr__(self) -> str:
        return (f"Sharded({self.shape}, {self.dtype}, spec={self.spec}, "
                f"{self.mesh!r})")


def place(t: torch.Tensor, mesh: Mesh, spec) -> Sharded:
    """``t`` cut by ``spec`` onto ``mesh``'s slots: one shard a slot, a
    fresh copy on the slot's device (never a view of ``t``), written on
    the current stream."""
    if mesh.devices is None:
        raise ValueError(f"{mesh!r} is abstract: nothing to place onto")
    if isinstance(t, Sharded):
        t = t.gather()
    spec = _norm_spec(spec, t.ndim)
    shards = {}
    for coords in mesh.indices():
        dev = mesh.slot(coords).device
        part = t[_shard_slices(t.shape, mesh, spec, coords)]
        shards[tuple(coords[a] for a in mesh.axis_names)] = torch.empty(
            part.shape, dtype=part.dtype, device=dev).copy_(part)
    return Sharded(mesh, spec, t.shape, t.dtype, shards)
