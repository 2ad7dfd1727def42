"""HPIPE heterogeneous layer pipeline (the reference's
``src/repro/core/pipeline.py``): the executors with and without a
device mesh, the stages on concurrent CUDA streams.

The FPGA streams activations producer->consumer through per-layer
hardware; the reference runs every stage of a tick in one program on a
``stage`` mesh axis. On one card the counterpart of a stage device is a
CUDA stream: one per (replica, stage) slot. A tick
(:func:`pipeline_step_hetero`, the primitive) injects a microbatch at
stage 0, forks the slots onto their streams, runs each stage program on
its own slot, joins, and rolls. The batch executor
(:func:`pipeline_apply_gspmd_hetero`) is M + S - 1 such ticks; the
continuous server (``launch/serve.py``) ticks once per microbatch.

Stage boundaries exchange a fixed-width f32 *wire* (:class:`WireFormat`)
that carries every live value crossing the cut, residual skips that
span stages included. f32 is the widening type: bf16 -> f32 -> bf16
round-trips exactly, so the pipelined result is bit-identical to the
sequential forward at the same microbatch size.

The roll costs no copy: the state lives in two (S[, R], mb, W) buffers
that alternate tick by tick, and stage k writes its output wire into
slot (k + 1) % S of the other buffer, which is then exactly the
reference's ``jnp.roll(ys, 1, axis=0)``: slot 0 holds the last stage's
output until the next injection overwrites it.

Every tensor that one stream writes and another reads (the two state
buffers, the injected wire, the emitted wire) is allocated by the
caller on its stream before the fork and freed there after the join,
so the caching allocator cannot hand a block back while a slot's
stream still reads it; a stage program's temporaries live and die on
its own stream.

Stage params come in two flavours, as in the reference's single-host
path: ``stage_params=None`` (each stage program closes over its own
weights), or the packed per-stage rows (:class:`PlacedParams`): stage k
is handed ``stage_params[k]``, one uint8 row that it unpacks its weights
from (:class:`ParamFormat`), so no stage program closes over a weight.

On a mesh (``launch/mesh.py``: a grid of device slots, several of which
may share one card) stage k of replica r runs on its slot
(:func:`mesh_slots`), on the slot's device and stream; a wire is copied
only where it crosses to another device. The even ``(S, width)``
buffer is placed by the spec ``(stage_axis,)`` (``launch.mesh.place``):
each slot holds only its stage's row, replicated across a data axis.
:func:`pipeline_apply_hetero` is the reference's shard_map executor,
the same ticks with each slot on its own stream.

Training (the HPIPE layer pipeline applied to an LM's train step,
``launch/steps.make_pipeline_train_step``): :func:`stack_stages` re-packs
(L, ...)-stacked layer params into (S, Lmax, ...) per-stage stacks with a
validity mask, :func:`make_stage_fn` turns a per-layer block into a stage
program over its valid layers, and :func:`pipeline_apply_gspmd` runs M
microbatches through the S stages in M + S - 1 ticks, the stages of a
tick in turn, under autograd; on a mesh (``mesh=``, or
:func:`pipeline_apply`, the reference's shard_map form) stage k runs on
slot k's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.core import pytree
from repro_torch.core.quant import quantize_tree


def microbatch(x, n_microbatches: int, *, pad: bool = False,
               n_replicas: int = 1):
    """(B, ...) -> (M, B/M, ...), or (R, M, B/(R*M), ...) when the
    pipeline is replicated (replica r runs microbatches
    ``x.reshape(R, M, mb)[r]``).

    A batch not divisible by ``n_replicas * n_microbatches`` raises
    ``ValueError`` naming both divisors, unless ``pad=True``: the batch
    is zero-padded up to the next multiple and the caller drops the
    trailing padded outputs."""
    b = x.shape[0]
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {n_microbatches}")
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    div = n_microbatches * n_replicas
    if b % div != 0:
        if not pad:
            if n_replicas > 1:
                raise ValueError(
                    f"batch {b} is not divisible by n_replicas "
                    f"{n_replicas} * n_microbatches {n_microbatches} "
                    f"= {div}; pass pad=True to zero-pad (and drop the "
                    "padded outputs) or choose a batch both divide")
            raise ValueError(
                f"batch {b} is not divisible by n_microbatches "
                f"{n_microbatches}; pass pad=True to zero-pad (and drop "
                "the padded outputs) or choose a divisor")
        b2 = -(-b // div) * div
        x = torch.cat([x, x.new_zeros((b2 - b,) + tuple(x.shape[1:]))])
        b = b2
    if n_replicas > 1:
        return x.reshape((n_replicas, n_microbatches, b // div)
                         + tuple(x.shape[1:]))
    return x.reshape((n_microbatches, b // n_microbatches)
                     + tuple(x.shape[1:]))


def bubble_fraction(n_microbatches: int, n_stages: int) -> float:
    """Pipeline fill/drain overhead (paper Table I 'Latency: Good')."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def steady_bubble_fraction(n_ticks_injected: int, n_stages: int) -> float:
    """Steady-state bubble of a CONTINUOUS pipeline: one fill of S-1
    ticks amortizes over every microbatch injected across the whole
    request stream, not one batch."""
    return (n_stages - 1) / (n_ticks_injected + n_stages - 1)


@dataclass(frozen=True)
class WireFormat:
    """Fixed layout of the values crossing one stage boundary: each
    value f32-widened, flattened per sample and concatenated into a
    (mb, width) f32 wire.

    entries: per value (name, shape, dtype); shape includes the leading
    microbatch dim, which all values must share.
    """
    entries: tuple

    @classmethod
    def for_values(cls, entries) -> "WireFormat":
        entries = tuple((n, tuple(s), d) for n, s, d in entries)
        if not entries:
            raise ValueError("a stage boundary must carry at least one value")
        mbs = {s[0] for _, s, _ in entries}
        if len(mbs) != 1:
            raise ValueError(f"mixed microbatch dims across wire: {mbs}")
        return cls(entries)

    @property
    def mb(self) -> int:
        return self.entries[0][1][0]

    def _sizes(self) -> list[int]:
        out = []
        for _, s, _ in self.entries:
            n = 1
            for d in s[1:]:
                n *= d
            out.append(n)
        return out

    @property
    def width(self) -> int:
        return sum(self._sizes())

    def pack(self, values, width: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """values (matching entries order) -> (mb, width) f32 wire,
        written into ``out`` when given (its columns past the payload
        are left as they are: no unpack reads them), else a new
        zero-padded wire."""
        if len(values) != len(self.entries):
            raise ValueError(f"expected {len(self.entries)} values, got "
                             f"{len(values)}")
        if self.width > width:
            raise ValueError(f"wire width {width} < payload {self.width}")
        if out is None:
            out = values[0].new_zeros((self.mb, width), dtype=torch.float32)
        off = 0
        for v, size in zip(values, self._sizes()):
            out[:, off:off + size].copy_(v.reshape(self.mb, size))
            off += size
        return out

    def unpack(self, wire: torch.Tensor) -> list[torch.Tensor]:
        """(mb, >=width) f32 wire -> contiguous values in entries order
        and dtype."""
        out, off = [], 0
        for (_, shape, dtype), size in zip(self.entries, self._sizes()):
            out.append(wire[:, off:off + size].to(dtype).reshape(shape)
                       .contiguous())
            off += size
        return out


def concat_hetero_outputs(out_wires, unpack_out, n_microbatches: int,
                          n_replicas: int = 1):
    """Reassemble an executor's output wires into one batch: unpack
    each microbatch wire and concatenate replica-major (replica r owns
    the contiguous batch slice r*B/R:(r+1)*B/R)."""
    if n_replicas > 1:
        mbs = [unpack_out(out_wires[r][i]) for r in range(n_replicas)
               for i in range(n_microbatches)]
    else:
        mbs = [unpack_out(out_wires[i]) for i in range(n_microbatches)]
    return torch.cat(mbs, dim=0)


#: byte alignment of every leaf in the rows a server holds on the card:
#: the ``mma`` kernels read weights, biases and scales as 16-byte vectors
ALIGN = 16


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class ParamFormat:
    """Fixed BYTE layout of one stage's parameter tree (reference
    ``core/pipeline.py:342``): every leaf reinterpreted as raw uint8 (a
    bit copy, never a value conversion: int32 indices and int8 codes
    keep every bit), flattened and concatenated in JAX's
    ``tree_flatten`` order (``core/pytree.py``), then zero-padded to the
    row width. Unpack is the exact inverse, so a stage program that runs
    on unpacked params is bit-identical to one closing over the
    originals.

    ``align``: the byte boundary each leaf starts on. 1 is the
    reference's layout (no gaps), byte for byte; :data:`ALIGN` puts
    every leaf on a 16-byte boundary, the layout of the rows a server
    holds on the card, where a leaf at an odd offset would make a kernel
    wrapper copy it on every launch.

    ``store_dtype`` (``core/quant.py``) re-stores float leaves narrow
    before the layout: int8 codes and their f32 scales become ordinary
    leaves of the (quantized) tree. Quantization is idempotent, so
    ``pack`` takes the original or the already quantized tree."""

    def __init__(self, template, leaves_meta, store_dtype: str = "native"):
        self.template = template                # structure, d_in, orig_dtype
        self.keys = [k for k, _ in pytree.keyed_leaves(template)]
        self.leaves_meta = tuple(leaves_meta)   # per leaf: (shape, dtype)
        self.store_dtype = store_dtype

    @classmethod
    def for_tree(cls, tree, store_dtype: str = "native") -> "ParamFormat":
        tree = quantize_tree(tree, store_dtype)
        meta = []
        for leaf in pytree.leaves(tree):
            if leaf.dtype == torch.bool:
                # no param tree carries bool leaves: fail loudly rather
                # than value-convert
                raise ValueError(f"unsupported param leaf dtype {leaf.dtype}")
            meta.append((tuple(leaf.shape), leaf.dtype))
        return cls(tree, meta, store_dtype)

    def _leaf_bytes(self) -> list[int]:
        out = []
        for shape, dt in self.leaves_meta:
            n = dt.itemsize
            for d in shape:
                n *= d
            out.append(n)
        return out

    @property
    def nbytes(self) -> int:
        """Live bytes of this stage's params: the sum of its leaves, not
        the padded row width."""
        return sum(self._leaf_bytes())

    def offsets(self, align: int = 1) -> list[int]:
        """Each leaf's byte offset in a row laid out at ``align``."""
        out, off = [], 0
        for size in self._leaf_bytes():
            off = _round_up(off, align)
            out.append(off)
            off += size
        return out

    def row_bytes(self, align: int = 1) -> int:
        """The bytes a row laid out at ``align`` needs, rounded up to
        ``align`` (:attr:`nbytes` at 1)."""
        sizes = self._leaf_bytes()
        if not sizes:
            return 0
        return _round_up(self.offsets(align)[-1] + sizes[-1], align)

    def pack(self, tree, width: int, align: int = 1) -> torch.Tensor:
        """Param tree -> (width,) uint8 row on the leaves' device,
        zero-padded."""
        leaves = pytree.leaves(quantize_tree(tree, self.store_dtype))
        if len(leaves) != len(self.leaves_meta):
            raise ValueError(f"expected {len(self.leaves_meta)} leaves, "
                             f"got {len(leaves)}")
        need = self.row_bytes(align)
        if need > width:
            raise ValueError(f"param width {width} < payload {need}")
        dev = leaves[0].device if leaves else "cpu"
        row = torch.zeros((width,), dtype=torch.uint8, device=dev)
        for leaf, (shape, dt), off, size in zip(
                leaves, self.leaves_meta, self.offsets(align),
                self._leaf_bytes()):
            if tuple(leaf.shape) != shape or leaf.dtype != dt:
                raise ValueError(f"leaf mismatch: {tuple(leaf.shape)}/"
                                 f"{leaf.dtype} vs {shape}/{dt}")
            if size:
                # a bit view, never .to(): .to(uint8) would convert values
                row[off:off + size].copy_(
                    leaf.detach().contiguous().reshape(-1).view(torch.uint8))
        return row

    def unpack(self, row: torch.Tensor, align: int = 1):
        """(>= row_bytes(align),) uint8 row -> the param tree, bit-exact.
        Each leaf is a view into ``row`` where its offset allows one (a
        multiple of its itemsize), else a copy of its bytes."""
        base = row.storage_offset()
        new = []
        for (shape, dt), off, size in zip(self.leaves_meta,
                                          self.offsets(align),
                                          self._leaf_bytes()):
            seg = row[off:off + size]
            if (base + off) % dt.itemsize:
                seg = seg.clone()
            new.append(seg.view(dt).reshape(shape))
        by_key = dict(zip(self.keys, new))
        return pytree.rebuild(self.template, by_key.__getitem__)


@dataclass(frozen=True)
class PlacedParams:
    """Per-stage parameter placement plan of a heterogeneous pipeline
    (reference ``core/pipeline.py:435``).

    ``formats[s]`` packs and unpacks stage s's param subtree,
    ``trees[s]`` (keyed by fused-node part names) is what ``pack()``
    serializes, ``width`` the largest stage's live bytes (the row width
    of the reference's even ``(S, width)`` buffer). ``align``: the
    layout of the rows ``pack()`` and ``pack_ragged()`` write and the
    placed stage programs read (:class:`ParamFormat`); at 1 they are the
    reference's bytes.

    ``stage_bytes``, ``stage_widths``, ``replicated_bytes``,
    ``padded_buffer_bytes`` and ``padding_bytes`` are the reference's
    accounting whatever ``align`` is; ``row_widths`` and ``align_bytes``
    report what the aligned layout adds."""
    formats: tuple
    trees: tuple
    width: int
    align: int = 1

    @property
    def stage_bytes(self) -> tuple[int, ...]:
        """Live (unpadded) param bytes per stage."""
        return tuple(f.nbytes for f in self.formats)

    @property
    def stage_widths(self) -> tuple[int, ...]:
        """The reference's ragged row widths: each stage's live bytes."""
        return self.stage_bytes

    @property
    def replicated_bytes(self) -> int:
        """Residency when one device holds every stage's params."""
        return sum(self.stage_bytes)

    @property
    def padded_buffer_bytes(self) -> int:
        """Total bytes of the reference's even-width (S, width) buffer."""
        return len(self.formats) * self.width

    @property
    def padding_bytes(self) -> int:
        """Bytes the even-width buffer pads beyond the live payloads."""
        return self.padded_buffer_bytes - sum(self.stage_widths)

    @property
    def row_widths(self) -> tuple[int, ...]:
        """Widths of the rows ``pack_ragged()`` returns: ``stage_widths``
        at align 1, each leaf on its boundary otherwise."""
        return tuple(f.row_bytes(self.align) for f in self.formats)

    @property
    def align_bytes(self) -> int:
        """Bytes the aligned layout adds to the live payloads, summed
        over the stages (0 at align 1)."""
        return sum(self.row_widths) - sum(self.stage_bytes)

    @property
    def buffer_width(self) -> int:
        """Row width of ``pack()``'s even buffer: ``width`` at align 1."""
        return _round_up(max((self.width,) + self.row_widths), self.align)

    def pack(self) -> torch.Tensor:
        """(n_stages, buffer_width) uint8 buffer: row s is stage s's
        params, every row as wide as the largest."""
        return torch.stack([f.pack(t, self.buffer_width, self.align)
                            for f, t in zip(self.formats, self.trees)])

    def pack_ragged(self) -> tuple:
        """Per-stage ``(row_widths[s],)`` uint8 rows, one tensor each:
        the payloads of :meth:`pack`'s rows without the even-width
        padding. The executors take this tuple (or the rows of
        ``pack()``) as ``stage_params``."""
        return tuple(f.pack(t, w, self.align) for f, t, w in
                     zip(self.formats, self.trees, self.row_widths))


def _check_hetero_params(stage_fns, n_stages, stage_params, mesh,
                         stage_axis):
    """Shared validation of the executors (reference
    ``_check_hetero_params``, its rules and texts). Returns ``(placed,
    ragged)``: ``ragged`` marks a tuple or list of per-stage rows, the
    placed form without a mesh; on a mesh with ``stage_axis`` the even
    ``(S, width)`` buffer is placed instead (a tensor, or a
    ``launch.mesh.Sharded`` placed already)."""
    if len(stage_fns) != n_stages:
        raise ValueError(f"{len(stage_fns)} stage programs for "
                         f"{n_stages} stages")
    placed = stage_params is not None
    ragged = placed and isinstance(stage_params, (tuple, list))
    on_axis = mesh is not None and stage_axis in mesh.shape
    if ragged:
        if len(stage_params) != n_stages:
            raise ValueError(f"{len(stage_params)} ragged param rows for "
                             f"{n_stages} stages")
        if on_axis:
            raise ValueError(
                "ragged per-stage param rows have unequal widths and "
                "cannot shard over the stage axis; pass the even "
                "(S, width) buffer from PlacedParams.pack() for "
                "placement on a mesh, or drop the mesh for the "
                "single-host packed path")
    elif placed and not on_axis:
        have = "no mesh" if mesh is None else \
            f"mesh axes {tuple(mesh.shape)}"
        raise ValueError(
            "per-stage weight placement (stage_params=...) requires a "
            f"mesh with a {stage_axis!r} axis to place each stage's "
            f"weights onto, got {have}; pass mesh=make_stage_mesh("
            f"{n_stages}, devices=...) with stage_axis={stage_axis!r}, "
            "drop stage_params to run with the stage programs' own "
            "params, or pass PlacedParams.pack_ragged() rows (or the "
            "rows of PlacedParams.pack()) for single-card packed params")
    return placed, ragged


def mesh_slots(mesh, n_stages: int, n_replicas: int = 1, *,
               stage_axis: str = "stage", data_axis: str = "data"):
    """``slots[k][r]``: the slot of stage k of replica r on ``mesh``.
    The mesh carries ``stage_axis`` with one slot a stage, a
    ``data_axis`` of size R when ``n_replicas`` > 1 (one stage column a
    replica; at R 1 the first column runs), and no other axis of more
    than one slot."""
    if stage_axis not in mesh.shape:
        raise ValueError(f"mesh has no {stage_axis!r} axis "
                         f"(axes: {tuple(mesh.shape)})")
    if mesh.shape[stage_axis] != n_stages:
        raise ValueError(
            f"mesh {stage_axis!r} axis has {mesh.shape[stage_axis]} "
            f"slots for {n_stages} stages; one stage per slot required")
    if n_replicas > 1 and mesh.shape.get(data_axis) != n_replicas:
        raise ValueError(
            f"n_replicas={n_replicas} needs a mesh with a {data_axis!r} "
            f"axis of that size (one stage column per replica), got mesh "
            f"axes {dict(mesh.shape)}")
    wide = [a for a, n in mesh.shape.items()
            if a not in (stage_axis, data_axis) and n > 1]
    if wide:
        raise ValueError(f"mesh axes {wide} hold more than one slot; a "
                         "stage runs on one slot (no tensor parallelism)")
    return [[mesh.slot({stage_axis: k, data_axis: r})
             for r in range(n_replicas)] for k in range(n_stages)]


def _placed_buffer(stage_params, mesh, stage_axis):
    """The even buffer placed on ``mesh`` by ``(stage_axis,)``: a
    ``launch.mesh.Sharded`` as it is, a tensor placed here (a copy)."""
    from repro_torch.launch.mesh import Sharded, place
    if isinstance(stage_params, Sharded):
        return stage_params
    return place(stage_params, mesh, (stage_axis,))


def _stage_rows(stage_params, mesh, stage_axis, data_axis):
    """``row(k, r)``: stage k's param row for replica r: a ragged row, or
    row k of the even buffer placed on ``mesh`` (its shard on the slot of
    stage k, replica r)."""
    if stage_params is None:
        return None
    if mesh is None:
        return lambda k, r: stage_params[k]
    buf = _placed_buffer(stage_params, mesh, stage_axis)
    return lambda k, r: buf.shard({stage_axis: k, data_axis: r})[0]


def slot_streams(n_stages: int, n_replicas: int = 1, device=None, *,
                 mesh=None, stage_axis: str = "stage",
                 data_axis: str = "data") -> list[list[torch.cuda.Stream]]:
    """One CUDA stream per (stage, replica) slot: ``streams[k][r]``, on
    ``device``, or on each slot's device of ``mesh``."""
    if mesh is None:
        return [[torch.cuda.Stream(device) for _ in range(n_replicas)]
                for _ in range(n_stages)]
    return [[torch.cuda.Stream(slot.device) for slot in row]
            for row in mesh_slots(mesh, n_stages, n_replicas,
                                  stage_axis=stage_axis,
                                  data_axis=data_axis)]


def slot_buffers(shape, slots, dtype=torch.float32):
    """Zeroed per-slot state buffers ``[k][r]``, each of ``shape`` on
    its slot's device: the state of a pipeline whose slots span several
    devices (a single (S[, R], ...) tensor lives on one)."""
    return [[torch.zeros(shape, dtype=dtype, device=slot.device)
             for slot in row] for row in slots]


def slot_at(buf, k: int, r: int, rep: bool) -> torch.Tensor:
    """Slot (k, r) of a state: a (S[, R], ...) tensor or per-slot lists."""
    if isinstance(buf, torch.Tensor):
        return buf[k, r] if rep else buf[k]
    return buf[k][r]


def pipeline_step_hetero(stage_fns: Sequence, state, in_wire, *,
                         n_stages: int, n_replicas: int = 1,
                         out=None, emit: Optional[torch.Tensor] = None,
                         streams=None, active=None,
                         stage_axis: str = "stage", mesh=None,
                         stage_params=None, data_axis: str = "data"):
    """ONE pipeline tick — the primitive of both executors.

    Injects ``in_wire`` into ``state[0]`` (in place: the caller hands
    the state over, as the reference's donated buffer; ``None`` when
    ``state[0]`` already holds the microbatch), runs stage k of every
    replica r on ``state[k, r]`` and writes its output wire into
    ``out[(k + 1) % S, r]``, so ``out`` is the rolled next state and
    ``out[0]`` the emitted wire (the microbatch injected S - 1 ticks
    earlier). ``emit``: a (mb, W) / (R, mb, W) buffer that takes the
    last stage's output instead of ``out[0]``.

    stage_fns[k](wire, out=buf) -> buf: stage k's whole program. state
    and out: (S, mb, W), or (S, R, mb, W) with ``n_replicas`` > 1; on a
    mesh whose slots span devices, per-slot buffers ``[k][r]``
    (:func:`slot_buffers`). ``streams``: ``streams[k][r]`` from
    :func:`slot_streams` (the slots run concurrently: each stream waits
    for the current stream, runs its stage, and the current stream
    waits for every slot before returning); ``None`` runs the slots one
    after another on the current stream. ``active``: the stages to run
    (default all): a stage that holds no microbatch on a fill or drain
    tick may be skipped, its output slot then left as it was.

    ``mesh``: a stage mesh (``launch/mesh.py``; :func:`mesh_slots`'s
    rules): stage k of replica r runs on its slot's device, and a wire
    that crosses to another device is copied there (a hop between slots
    of one device is no copy). ``stage_params``: None (the stage
    programs close over their weights), one uint8 row per stage without
    a mesh (:meth:`PlacedParams.pack_ragged`, or the rows of
    :meth:`PlacedParams.pack`), or on a mesh the even buffer placed by
    ``(stage_axis,)`` (``launch.mesh.place``; a tensor is placed on each
    call): stage k then runs ``stage_fns[k](row, wire, out=buf)``.

    Returns ``(out, emitted)``."""
    placed, _ = _check_hetero_params(stage_fns, n_stages, stage_params,
                                     mesh, stage_axis)
    rep = n_replicas > 1
    slots = None if mesh is None else mesh_slots(
        mesh, n_stages, n_replicas, stage_axis=stage_axis,
        data_axis=data_axis)
    rows = _stage_rows(stage_params, mesh, stage_axis, data_axis)
    if isinstance(state, torch.Tensor):
        want = (n_stages, n_replicas) if rep else (n_stages,)
        if tuple(state.shape[:len(want)]) != want:
            raise ValueError(
                f"state leading dims {tuple(state.shape[:len(want)])} != "
                f"(n_stages{', n_replicas' if rep else ''}) = {want}")
        if slots is not None and any(sl.device != state.device
                                     for row in slots for sl in row):
            raise ValueError(
                f"a state tensor lives on {state.device}; a mesh whose "
                "slots span devices takes per-slot buffers "
                "(pipeline.slot_buffers)")
        if out is None:
            out = torch.empty_like(state)
        if in_wire is not None:
            state[0].copy_(in_wire)
    else:
        if len(state) != n_stages or any(len(row) != n_replicas
                                         for row in state):
            raise ValueError(f"per-slot state of {len(state)} stages, "
                             f"need {n_stages} x {n_replicas} slots")
        if out is None:
            out = [[torch.empty_like(t) for t in row] for row in state]
        if in_wire is not None:
            for r in range(n_replicas):
                state[0][r].copy_(in_wire[r] if rep else in_wire)
    stages = range(n_stages) if active is None else active
    last = n_stages - 1

    def run(k: int, r: int) -> None:
        src = slot_at(state, k, r, rep)
        if k == last and emit is not None:
            dst = emit[r] if rep else emit
        else:
            dst = slot_at(out, (k + 1) % n_stages, r, rep)
        args = (rows(k, r),) if placed else ()
        if dst.device == src.device:
            stage_fns[k](*args, src, out=dst)
        else:                           # the hop to another device
            dst.copy_(stage_fns[k](*args, src))

    pairs = [(k, r) for k in stages for r in range(n_replicas)]
    if streams is None:
        for k, r in pairs:
            run(k, r)
    else:
        cur = torch.cuda.current_stream(slot_at(state, 0, 0, rep).device)
        for k, r in pairs:
            st = streams[k][r]
            st.wait_stream(cur)
            with torch.cuda.stream(st):
                run(k, r)
        for k, r in pairs:
            cur.wait_stream(streams[k][r])
    if emit is not None:
        return out, emit
    if isinstance(out, torch.Tensor):
        return out, out[0]
    return out, (list(out[0]) if rep else out[0][0])


def pipeline_apply_gspmd_hetero(stage_fns: Sequence, x_wire: torch.Tensor,
                                *, n_stages: int, stage_axis: str = "pod",
                                mesh=None, stage_params=None,
                                n_replicas: int = 1, data_axis: str = "data",
                                streams=None) -> torch.Tensor:
    """The batch executor: M microbatches through the S-stage pipeline
    in M + S - 1 ticks of :func:`pipeline_step_hetero`. The name is the
    reference's; one program runs every slot's stage (no GSPMD here).

    x_wire: (M, mb, W) packed input microbatches, or (R, M, mb, W) with
    ``n_replicas`` > 1 (``microbatch(..., n_replicas=R)``). Returns the
    last stage's wires, same shape, on x_wire's device. A stage runs only
    on the ticks where its slot holds a microbatch: M x S stage runs in
    all instead of (M + S - 1) x S, with the same outputs. ``mesh``,
    ``stage_params`` and ``streams`` as in :func:`pipeline_step_hetero`
    (on a mesh an even buffer given as a tensor is placed once)."""
    _check_hetero_params(stage_fns, n_stages, stage_params, mesh,
                         stage_axis)
    rep = n_replicas > 1
    if rep and x_wire.shape[0] != n_replicas:
        raise ValueError(
            f"x_wire leading dim {x_wire.shape[0]} != n_replicas "
            f"{n_replicas}; build it with microbatch(x, M, n_replicas=R)")
    m = x_wire.shape[1] if rep else x_wire.shape[0]
    s = n_stages
    mb_shape = tuple(x_wire.shape[2:] if rep else x_wire.shape[1:])
    lead = (s, n_replicas) if rep else (s,)
    bufs = [x_wire.new_zeros(lead + mb_shape) for _ in range(2)]
    if mesh is not None:
        slots = mesh_slots(mesh, s, n_replicas, stage_axis=stage_axis,
                           data_axis=data_axis)
        if any(sl.device != x_wire.device for row in slots for sl in row):
            bufs = [slot_buffers(mb_shape, slots, x_wire.dtype)
                    for _ in range(2)]
        if stage_params is not None:
            stage_params = _placed_buffer(stage_params, mesh, stage_axis)
    outs = torch.zeros_like(x_wire)
    for i in range(m + s - 1):
        inject = None
        if i < m:
            inject = x_wire[:, i] if rep else x_wire[i]
        j = i - (s - 1)
        emit = None
        if j >= 0:
            emit = outs[:, j] if rep else outs[j]
        active = [k for k in range(s) if 0 <= i - k < m]
        pipeline_step_hetero(stage_fns, bufs[i % 2], inject, n_stages=s,
                             n_replicas=n_replicas, out=bufs[(i + 1) % 2],
                             emit=emit, streams=streams, active=active,
                             stage_axis=stage_axis, mesh=mesh,
                             stage_params=stage_params, data_axis=data_axis)
    return outs


def pipeline_apply_hetero(stage_fns: Sequence, x_wire: torch.Tensor, *,
                          mesh, stage_axis: str, n_stages: int,
                          stage_params=None, n_replicas: int = 1,
                          data_axis: str = "data") -> torch.Tensor:
    """The reference's shard_map executor over heterogeneous stage
    programs (reference ``core/pipeline.py:560``): every slot of
    ``mesh`` runs its own stage on its own device and, on a card, its
    own CUDA stream (:func:`slot_streams`); wires hop stage to stage,
    copied only between devices. ``stage_params``: None (each program
    closes over its weights) or the even ``(S, width)`` buffer, placed
    by ``(stage_axis,)`` (a tensor is placed here), so each slot holds
    only its stage's row. ``n_replicas`` > 1 needs a ``data_axis`` of
    that size: each replica runs the whole pipeline on its own stage
    column, the rows replicated only across data. Returns the last
    stage's wires, (M, mb, W) or (R, M, mb, W): bit for bit
    :func:`pipeline_apply_gspmd_hetero` without a mesh."""
    _, ragged = _check_hetero_params(stage_fns, n_stages, stage_params,
                                     mesh, stage_axis)
    if ragged:
        raise ValueError(
            "the shard_map executor takes the placed buffer as one "
            "(S, width) array; ragged rows only run on the gspmd "
            "single-host path")
    if mesh is None:
        raise ValueError(
            f"pipeline_apply_hetero runs on a mesh with a {stage_axis!r} "
            "axis (one slot a stage), got no mesh")
    streams = None
    if all(d.type == "cuda" for d in mesh.device_set()):
        streams = slot_streams(n_stages, n_replicas, mesh=mesh,
                               stage_axis=stage_axis, data_axis=data_axis)
    return pipeline_apply_gspmd_hetero(
        stage_fns, x_wire, n_stages=n_stages, stage_axis=stage_axis,
        mesh=mesh, stage_params=stage_params, n_replicas=n_replicas,
        data_axis=data_axis, streams=streams)


# ---------------------------------------------------------------------------
# the stage-pipelined train step (LM layer stacks)
# ---------------------------------------------------------------------------

def stack_stages(blocks, stage_of: list, n_stages: int):
    """Re-pack per-layer stacked params (leading L axis) into per-stage
    stacks (S, Lmax, ...), zero-padded, with a validity mask (S, Lmax)
    (numpy bool, on the host). A SparseWeight stacks its vals and idx; a
    Python list (a host-side per-layer value, zamba2's ``_attn_flag``)
    becomes S lists of Lmax, padded with 0.

    Every stage must own at least one layer: an empty stage would run as
    a silent identity and waste a pipeline rung (``planner.assign_stages``
    clamps)."""
    n_l = len(stage_of)
    per_stage = [[l for l in range(n_l) if stage_of[l] == s]
                 for s in range(n_stages)]
    empty = [s for s, g in enumerate(per_stage) if not g]
    if empty:
        raise ValueError(
            f"stage(s) {empty} own no layers ({n_l} layers over {n_stages} "
            "stages); clamp n_stages to max(stage_of)+1 or rebalance")
    lmax = max(len(g) for g in per_stage)

    def leaf(a):
        if isinstance(a, list):
            return [[a[l] for l in g] + [0] * (lmax - len(g))
                    for g in per_stage]
        out = a.new_zeros((n_stages, lmax) + tuple(a.shape[1:]))
        for s, g in enumerate(per_stage):
            out[s, :len(g)] = a[torch.tensor(g, device=a.device)]
        return out

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, pytree.SparseWeight):
            return pytree.SparseWeight(leaf(t.vals), leaf(t.idx), t.d_in)
        return leaf(t)

    mask = np.zeros((n_stages, lmax), bool)
    for s, g in enumerate(per_stage):
        mask[s, :len(g)] = True
    return tree(blocks), mask


def index_tree(tree, i: int):
    """Entry i of every leaf's leading axis (views; list entries)."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, pytree.SparseWeight):
        return pytree.SparseWeight(tree.vals[i], tree.idx[i], tree.d_in)
    return tree[i]


def make_stage_fn(block_fn: Callable) -> Callable:
    """A per-layer ``block_fn(params_l, x) -> x`` as a stage program
    ``stage_fn(stage_params, mask, x)`` over the stage's (Lmax, ...)
    stack: each layer whose mask entry is true, in order; the padding
    layers do not run (the mask is on the host)."""

    def stage_fn(stage_params, mask, x):
        for l, valid in enumerate(mask):
            if valid:
                x = block_fn(index_tree(stage_params, l), x)
        return x

    return stage_fn


def _tree_to(tree, device):
    """``tree`` on ``device`` (autograd records the copies; a tensor
    already there is itself); host-side lists stay."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, pytree.SparseWeight):
        return pytree.SparseWeight(tree.vals.to(device),
                                   tree.idx.to(device), tree.d_in)
    if isinstance(tree, list):
        return tree
    return tree.to(device)


def pipeline_apply_gspmd(stage_fn: Callable, stage_params, mask, x_mb, *,
                         n_stages: int, stage_axis: str = "pod",
                         mesh=None, data_axis: str = "data",
                         remat: bool = True) -> torch.Tensor:
    """The reference's ``pipeline_apply_gspmd``: x_mb (M, mb, ...)
    through S stages in M + S - 1 ticks; at tick i stage k runs
    microbatch i - k where 0 <= i - k < M (the reference runs every
    stage each tick and discards the idle ones' outputs: the same
    results), the stages of a tick in turn, each stage program under a
    checkpoint when ``remat`` (the reference's ``jax.checkpoint``).
    ``stage_params``: (S, Lmax, ...) stacks (:func:`stack_stages`);
    ``mask``: (S, Lmax) host bools. Returns (M, mb, ...) on x_mb's
    device.

    ``mesh``: a mesh with ``stage_axis`` of S slots (:func:`mesh_slots`):
    stage k runs on its slot's device, its params and its input moved
    there where they lie elsewhere (a copy autograd carries back). The
    stages run in turn on their devices' current streams, so under
    autograd each stage's backward runs where its forward ran; slots of
    one card run one after another, slots of several cards overlap
    through the launches' asynchrony. On one card the result is the
    mesh-less step's, bit for bit."""
    m, s = x_mb.shape[0], n_stages
    devs = [None] * s
    if mesh is not None:
        devs = [row[0].device for row in mesh_slots(
            mesh, s, 1, stage_axis=stage_axis, data_axis=data_axis)]
    fn = stage_fn
    if remat:
        def fn(p, msk, x):
            return _ckpt.checkpoint(stage_fn, p, msk, x, use_reentrant=False)
    stages = [index_tree(stage_params, k) for k in range(s)]
    if mesh is not None:
        stages = [_tree_to(t, d) for t, d in zip(stages, devs)]
    masks = [list(np.asarray(mask)[k]) for k in range(s)]
    held = [None] * s                   # each stage's input this tick
    outs = [None] * m
    for i in range(m + s - 1):
        if i < m:
            held[0] = x_mb[i]
        ys = [None] * s
        for k in range(s):
            if 0 <= i - k < m:
                x = held[k] if devs[k] is None else held[k].to(devs[k])
                ys[k] = fn(stages[k], masks[k], x)
        if i - (s - 1) >= 0:
            outs[i - (s - 1)] = ys[s - 1]
        held = [None] + ys[:-1]          # stage k -> k + 1
    return torch.stack([o.to(x_mb.device) for o in outs])


def pipeline_apply(stage_fn: Callable, stage_params, mask, x_mb, *,
                   mesh, stage_axis: str, n_stages: int,
                   remat: bool = True) -> torch.Tensor:
    """The reference's shard_map pipeline over a ``stage_axis``
    (reference ``core/pipeline.py:130``): stage k of the (S, Lmax, ...)
    stacks runs on slot k of ``mesh``, microbatch i - k at tick i, the
    activations hopping slot to slot. The same schedule as
    :func:`pipeline_apply_gspmd` on a mesh, the same bits."""
    if mesh is None:
        raise ValueError(f"pipeline_apply runs on a mesh with a "
                         f"{stage_axis!r} axis, got no mesh")
    return pipeline_apply_gspmd(stage_fn, stage_params, mask, x_mb,
                                n_stages=n_stages, stage_axis=stage_axis,
                                mesh=mesh, remat=remat)


def sequential_apply(stage_fn: Callable, stage_params, mask, x_mb, *,
                     n_stages: int, remat: bool = True, **_) -> torch.Tensor:
    """What :func:`pipeline_apply_gspmd` computes, without the pipeline:
    each microbatch through every stage in order, then the next (each
    stage program under a checkpoint when ``remat``). The comparison the
    pipelined step is held to, bit for bit."""
    fn = stage_fn
    if remat:
        def fn(p, msk, x):
            return _ckpt.checkpoint(stage_fn, p, msk, x, use_reentrant=False)
    stages = [index_tree(stage_params, k) for k in range(n_stages)]
    masks = [list(np.asarray(mask)[k]) for k in range(n_stages)]
    outs = []
    for i in range(x_mb.shape[0]):
        h = x_mb[i]
        for k in range(n_stages):
            h = fn(stages[k], masks[k], h)
        outs.append(h)
    return torch.stack(outs)
