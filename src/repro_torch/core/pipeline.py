"""HPIPE heterogeneous layer pipeline on one card: the single-device
semantics of the reference's ``src/repro/core/pipeline.py``
(``pipeline_apply_gspmd_hetero(mesh=None)`` and
``pipeline_step_hetero``), with the stages on concurrent CUDA streams.

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

Per-stage weight placement (``stage_params``) and meshes are not
ported: one card holds every stage's weights.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch


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


def _check_hetero(stage_fns, n_stages, stage_params, mesh) -> None:
    if len(stage_fns) != n_stages:
        raise ValueError(f"{len(stage_fns)} stage programs for "
                         f"{n_stages} stages")
    if mesh is not None:
        raise NotImplementedError(
            "mesh=: one card has no device mesh (ROADMAP Queue 1 item 9, "
            "TPU-mesh tooling)")
    if stage_params is not None:
        raise ValueError(
            "per-stage weight placement (stage_params=...) requires a "
            "mesh with a 'stage' axis to place each stage's weights "
            "onto, got no mesh; drop stage_params to run with the "
            "stage programs' own params")


def slot_streams(n_stages: int, n_replicas: int = 1,
                 device=None) -> list[list[torch.cuda.Stream]]:
    """One CUDA stream per (stage, replica) slot: ``streams[k][r]``."""
    return [[torch.cuda.Stream(device) for _ in range(n_replicas)]
            for _ in range(n_stages)]


def pipeline_step_hetero(stage_fns: Sequence, state: torch.Tensor,
                         in_wire: Optional[torch.Tensor], *,
                         n_stages: int, n_replicas: int = 1,
                         out: Optional[torch.Tensor] = None,
                         emit: Optional[torch.Tensor] = None,
                         streams=None, active=None, mesh=None,
                         stage_params=None):
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
    and out: (S, mb, W), or (S, R, mb, W) with ``n_replicas`` > 1.
    ``streams``: ``streams[k][r]`` from :func:`slot_streams` (the
    slots run concurrently: each stream waits for the current stream,
    runs its stage, and the current stream waits for every slot before
    returning); ``None`` runs the slots one after another on the
    current stream. ``active``: the stages to run (default all): a
    stage that holds no microbatch on a fill or drain tick may be
    skipped, its output slot then left as it was.

    Returns ``(out, emitted)``."""
    _check_hetero(stage_fns, n_stages, stage_params, mesh)
    rep = n_replicas > 1
    want = (n_stages, n_replicas) if rep else (n_stages,)
    if tuple(state.shape[:len(want)]) != want:
        raise ValueError(f"state leading dims {tuple(state.shape[:len(want)])}"
                         f" != (n_stages{', n_replicas' if rep else ''}) "
                         f"= {want}")
    if out is None:
        out = torch.empty_like(state)
    if in_wire is not None:
        state[0].copy_(in_wire)
    stages = range(n_stages) if active is None else active
    last = n_stages - 1

    def run(k: int, r: int) -> None:
        src = state[k, r] if rep else state[k]
        if k == last and emit is not None:
            dst = emit[r] if rep else emit
        else:
            dst = out[(k + 1) % n_stages, r] if rep \
                else out[(k + 1) % n_stages]
        stage_fns[k](src, out=dst)

    slots = [(k, r) for k in stages for r in range(n_replicas)]
    if streams is None:
        for k, r in slots:
            run(k, r)
    else:
        cur = torch.cuda.current_stream(state.device)
        for k, r in slots:
            st = streams[k][r]
            st.wait_stream(cur)
            with torch.cuda.stream(st):
                run(k, r)
        for k, r in slots:
            cur.wait_stream(streams[k][r])
    emitted = emit if emit is not None else out[0]
    return out, emitted


def pipeline_apply_gspmd_hetero(stage_fns: Sequence, x_wire: torch.Tensor,
                                *, n_stages: int, n_replicas: int = 1,
                                streams=None, mesh=None,
                                stage_params=None) -> torch.Tensor:
    """The batch executor: M microbatches through the S-stage pipeline
    in M + S - 1 ticks of :func:`pipeline_step_hetero`. The name is the
    reference's; its semantics are the reference's without a mesh (no
    GSPMD here: one card).

    x_wire: (M, mb, W) packed input microbatches, or (R, M, mb, W) with
    ``n_replicas`` > 1 (``microbatch(..., n_replicas=R)``). Returns the
    last stage's wires, same shape. A stage runs only on the ticks where
    its slot holds a microbatch: M x S stage runs in all instead of
    (M + S - 1) x S, with the same outputs."""
    _check_hetero(stage_fns, n_stages, stage_params, mesh)
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
                             emit=emit, streams=streams, active=active)
    return outs
