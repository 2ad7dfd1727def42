"""Layer-graph IR — the network the HPIPE compiler walks.

Copy of the reference's ``src/repro/core/graph.py``; the port keeps its
own copy so that it imports nothing of the JAX package.

The paper's compiler consumes a TensorFlow graph and emits one hardware
stage per layer; our analogue is a small SSA-ish IR over the CNN layer
kinds (conv / dw / maxpool / avgpool / fc / add) with explicit residual
edges. The spec builders in ``repro_torch/models/cnn.py`` emit a flat
``ConvSpec`` list; :class:`LayerGraph` resolves it into nodes + edges
using three per-spec fields:

- the *primary* input of a node is the previous node's output, unless
  ``input_from`` names another producer (ResNet projection shortcuts
  read the block input, not the preceding conv);
- ``add`` nodes additionally consume ``residual_from`` (the skip edge);
- ``relu`` records whether the node fuses a ReLU epilogue (residual
  branches and MobileNet-V2 linear bottlenecks don't).

The graph is pure structure (numpy-free, torch-free): the interpreter
that executes it lives in ``repro_torch/models/cnn.py``; the stage
partitioner below computes, for any contiguous stage assignment, the
set of *live values* crossing each stage cut — the skip buffer the
heterogeneous pipeline (``core/pipeline.py``) must carry when a
residual edge spans stages.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

#: pseudo-value name for the graph input (the image batch)
INPUT = "__images__"


@dataclass(frozen=True)
class ConvSpec:
    name: str
    kind: str            # conv | dw | maxpool | avgpool | fc | add
                         # + fused super-node kinds emitted by
                         # core/fusion.py: dw_pw | avgpool_fc (and conv /
                         # dw_pw with a residual epilogue: residual_from
                         # set on a non-add node)
    cin: int = 0
    cout: int = 0
    k: int = 1
    stride: int = 1
    in_hw: int = 0       # input spatial size (square)
    residual_from: str = ""   # skip-edge producer (add nodes, or a fused
                              # residual epilogue on conv/dw_pw nodes)
    relu: bool = True         # fused ReLU epilogue
    input_from: str = ""      # primary input override ("" = previous node)
    parts: tuple = ()         # fused super-nodes: the original ConvSpecs
                              # in execution order (params stay keyed by
                              # the part names); () = not a fusion
    pool_k: int = 0           # fused pooling epilogue on a conv node
    pool_stride: int = 0      # (core/fusion.py R4: conv -> maxpool); 0 = none

    @property
    def conv_out_hw(self) -> int:
        """Spatial size the conv unit itself emits (pre-pool-epilogue)."""
        return -(-self.in_hw // self.stride)

    @property
    def out_hw(self) -> int:
        ohw = -(-self.in_hw // self.stride)
        if self.pool_stride:
            ohw = -(-ohw // self.pool_stride)
        return ohw

    def macs(self) -> int:
        """Dense multiply-accumulates for this op."""
        if self.kind == "conv":
            # MACs happen at the conv unit's own resolution — a fused
            # pooling epilogue shrinks the node OUTPUT, not the conv
            return self.conv_out_hw ** 2 * self.k ** 2 * self.cin * self.cout
        if self.kind == "dw":
            return self.out_hw ** 2 * self.k ** 2 * self.cin
        if self.kind == "fc":
            return self.cin * self.cout
        return 0


@dataclass(frozen=True)
class StageSlice:
    """One pipeline stage: nodes [start, stop) plus its wire contract.

    ``in_live`` / ``out_live`` are the value names crossing the stage's
    input / output cut, ordered by producer index (INPUT first). A
    residual edge whose producer and consumer land in different stages
    appears in every boundary in between — that is the skip buffer.
    """
    stage: int
    start: int
    stop: int
    in_live: tuple[str, ...]
    out_live: tuple[str, ...]


class LayerGraph:
    """Topologically ordered layer DAG with explicit residual edges."""

    def __init__(self, name: str, nodes: tuple[ConvSpec, ...],
                 inputs: tuple[tuple[str, ...], ...]):
        self.name = name
        self.nodes = nodes
        self.inputs = inputs          # per node: (primary[, residual])
        self._index = {n.name: i for i, n in enumerate(nodes)}

    @classmethod
    def from_specs(cls, name: str, specs: list[ConvSpec]) -> "LayerGraph":
        nodes = tuple(specs)
        inputs = []
        for i, s in enumerate(nodes):
            primary = s.input_from or (nodes[i - 1].name if i else INPUT)
            edge = (primary,)
            if s.kind == "add" and not s.residual_from:
                raise ValueError(f"add node {s.name!r} has no "
                                 "residual_from edge")
            if s.residual_from:
                # add nodes, or a fused residual epilogue on a conv/dw_pw
                # super-node (core/fusion.py)
                edge = (primary, s.residual_from)
            inputs.append(edge)
        g = cls(name, nodes, tuple(inputs))
        g.validate()
        return g

    # -- structure ---------------------------------------------------------

    def index(self, name: str) -> int:
        return self._index[name]

    @property
    def output(self) -> str:
        return self.nodes[-1].name

    #: node kinds whose executor consumes a residual edge (add nodes and
    #: the fused residual epilogues — see models/cnn.run_node)
    RESIDUAL_KINDS = ("add", "conv", "dw_pw")

    def validate(self) -> None:
        """Every edge references INPUT or an earlier node (topo order),
        and residual edges only appear on kinds that execute them."""
        seen = {INPUT}
        for node, edge in zip(self.nodes, self.inputs):
            if node.name in seen:
                raise ValueError(f"duplicate node name {node.name!r}")
            if node.residual_from and node.kind not in self.RESIDUAL_KINDS:
                raise ValueError(
                    f"{self.name}: {node.kind!r} node {node.name!r} has a "
                    f"residual_from edge, but only {self.RESIDUAL_KINDS} "
                    "consume one — it would be silently dropped")
            for src in edge:
                if src not in seen:
                    raise ValueError(
                        f"{self.name}: node {node.name!r} reads {src!r} "
                        "which is not produced earlier (or at all)")
            seen.add(node.name)

    def consumers(self) -> dict[str, list[int]]:
        """value name -> node indices that read it (graph output is
        consumed at index len(nodes))."""
        cons: dict[str, list[int]] = {INPUT: []}
        for i, edge in enumerate(self.inputs):
            for src in edge:
                cons.setdefault(src, []).append(i)
        cons.setdefault(self.output, []).append(len(self.nodes))
        return cons

    def live_at(self, boundary: int) -> tuple[str, ...]:
        """Values produced before node index ``boundary`` that some node
        at index >= boundary still reads, ordered by producer index
        (INPUT first). This is the wire content at a stage cut."""
        cons = self.consumers()
        live = []
        if boundary == 0 or any(c >= boundary for c in cons.get(INPUT, [])):
            live.append(INPUT)
        for i, node in enumerate(self.nodes):
            if i >= boundary:
                break
            if any(c >= boundary for c in cons.get(node.name, [])):
                live.append(node.name)
        return tuple(live)

    # -- stage partitioning ------------------------------------------------

    def partition(self, stage_of: list[int]) -> list[StageSlice]:
        """Split into contiguous stages per ``stage_of`` (one id per
        node, nondecreasing, starting at 0, no gaps). Returns one
        :class:`StageSlice` per stage with resolved wire contracts."""
        if len(stage_of) != len(self.nodes):
            raise ValueError(f"stage_of has {len(stage_of)} entries for "
                             f"{len(self.nodes)} nodes")
        if stage_of and stage_of[0] != 0:
            raise ValueError("stage ids must start at 0")
        for a, b in zip(stage_of, stage_of[1:]):
            if b - a not in (0, 1):
                raise ValueError("stage ids must be contiguous and "
                                 f"nondecreasing, got ...{a},{b}...")
        n_stages = (max(stage_of) + 1) if stage_of else 0
        bounds = [0]
        for s in range(n_stages):
            bounds.append(max(i for i, sid in enumerate(stage_of)
                              if sid == s) + 1)
        slices = []
        for s in range(n_stages):
            start, stop = bounds[s], bounds[s + 1]
            # live_at(0) == (INPUT,) and live_at(n) == (output,), so the
            # edge stages need no special-casing
            slices.append(StageSlice(stage=s, start=start, stop=stop,
                                     in_live=self.live_at(start),
                                     out_live=self.live_at(stop)))
        return slices


@functools.lru_cache(maxsize=None)
def graph_for(name: str) -> LayerGraph:
    """LayerGraph for one of the paper's CNNs (cached)."""
    from repro_torch.models import cnn
    return LayerGraph.from_specs(name, cnn.specs_for(name))
