"""Graph-level operator fusion: keep intra-stage activations out of HBM.

Copy of the rewrite rules of the reference's ``src/repro/core/fusion.py``
(the HBM-traffic model stays there). The kernels named below are the
reference's; the port's are under ``repro_torch/kernels/``.

HPIPE streams activations producer->consumer through dedicated
per-layer hardware; nothing inside the pipe ever touches DRAM. Our
stage pipeline (core/pipeline.py) got the *inter*-stage wires right,
but inside a stage every IR node still round-trips its full activation
through HBM: MobileNet's dw->pw pairs, ResNet's ``c3 -> add -> relu``
tails and the avgpool->fc head each cost 2-3 extra full-tensor HBM
passes per block. This pass rewrites the :class:`LayerGraph` into
fused *super-nodes* before interpretation, stage planning and costing,
so those intermediates live only in VMEM (DESIGN.md §5).

Rewrite rules (applied to fixpoint, each strictly shrinks the graph):

- **dw_pw** — a depthwise conv whose ONLY consumer is a 1x1 stride-1
  conv fuses into one node: the depthwise intermediate becomes a VMEM
  slab feeding the pointwise MXU matmul (kernels/dw_pw_fused.py). One
  HBM read and one write per MobileNet block instead of four.
- **residual epilogue** — a linear (relu=False) conv or dw_pw node
  whose ONLY consumer is an ``add`` folds the add (+ its relu) into
  its epilogue: the node keeps its kind, gains the add's
  ``residual_from`` edge and relu flag, and the skip tensor is gathered
  at the conv kernel's K-1 flush (kernels/sparse_conv.py) — ResNet
  block outputs never hit HBM just to be added.
- **avgpool_fc** — the global average pool folds into the fc head
  (one reduction feeding the classifier matmul).
- **pooled conv** — a conv whose ONLY consumer is a maxpool gains a
  pooling epilogue (``pool_k``/``pool_stride`` on the conv node): the
  ResNet stem's conv1->pool1 runs as one node, so the 112x112x64
  pre-pool tensor never round-trips HBM between nodes.

Legality: a fusion may only swallow a value with exactly ONE consumer
(anything read elsewhere — residual sources, multi-consumer taps —
must stay a node output), and the producer of a residual epilogue must
be linear (relu=False) so the add sees the pre-activation value.
Fused nodes are atomic for stage planning: the reference's
``planner.plan`` partitions the fused graph, so a stage cut can never
land inside a fusion.

The fused node's ``parts`` field keeps the original ConvSpecs in
execution order — params stay keyed by the part names, so
``models/cnn.init_cnn`` is fusion-agnostic.
"""
from __future__ import annotations

import dataclasses
import functools


from repro_torch.core.graph import LayerGraph


def conv_part(node: ConvSpec) -> ConvSpec:
    """The spec whose name keys this node's conv params (itself for
    unfused nodes, the original conv part for fused super-nodes)."""
    if not node.parts:
        return node
    return next(p for p in node.parts if p.kind in ("conv", "fc"))


def _consumer_counts(nodes, inputs):
    cons: dict[str, list[int]] = {}
    for i, edge in enumerate(inputs):
        for src in edge:
            cons.setdefault(src, []).append(i)
    return cons


def _fuse_once(nodes: list, inputs: list, output: str):
    """Apply the first applicable rewrite; True if the graph changed."""
    cons = _consumer_counts(nodes, inputs)
    index = {n.name: i for i, n in enumerate(nodes)}

    def only_consumer(name: str, j: int) -> bool:
        return name != output and cons.get(name, []) == [j]

    for j, (node, edge) in enumerate(zip(nodes, inputs)):
        src = edge[0]
        i = index.get(src)
        if i is None:                       # primary is INPUT
            continue
        prod = nodes[i]
        # R1: dw -> 1x1 conv (the MobileNet block body)
        if (node.kind == "conv" and node.k == 1 and node.stride == 1
                and prod.kind == "dw" and only_consumer(src, j)):
            fused = dataclasses.replace(
                node, kind="dw_pw", cin=prod.cin, k=prod.k,
                stride=prod.stride, in_hw=prod.in_hw,
                input_from=inputs[i][0],
                parts=(prod.parts or (prod,)) + (node.parts or (node,)))
            nodes[j] = fused
            # keep any residual edge the consumer already carried
            inputs[j] = (inputs[i][0],) + edge[1:]
            del nodes[i], inputs[i]
            return True
        # R2: linear conv / dw_pw -> add (+relu): residual epilogue.
        # A pooled conv (R4) may not take one: the epilogue order is
        # conv -> residual add -> pool, but the unfused graph pools
        # BEFORE the add — folding would reorder them.
        if (node.kind == "add" and prod.kind in ("conv", "dw_pw")
                and not prod.relu and not prod.residual_from
                and not prod.pool_k
                and only_consumer(src, j)):
            fused = dataclasses.replace(
                prod, name=node.name, relu=node.relu,
                residual_from=edge[1], input_from=inputs[i][0],
                parts=(prod.parts or (prod,)) + (node.parts or (node,)))
            nodes[j] = fused
            inputs[j] = (inputs[i][0], edge[1])
            del nodes[i], inputs[i]
            return True
        # R3: global avgpool -> fc head
        if (node.kind == "fc" and prod.kind == "avgpool"
                and only_consumer(src, j)):
            fused = dataclasses.replace(
                node, kind="avgpool_fc", in_hw=prod.in_hw, k=prod.k,
                input_from=inputs[i][0],
                parts=(prod.parts or (prod,)) + (node.parts or (node,)))
            nodes[j] = fused
            inputs[j] = (inputs[i][0],)
            del nodes[i], inputs[i]
            return True
        # R4: conv -> maxpool (the ResNet stem): pooling epilogue on the
        # conv unit. The fused node keeps the conv's arithmetic fields
        # plus pool_k/pool_stride; the executor pools after the conv's
        # own epilogue, which is exactly the unfused sequence, so this
        # is bitwise-identical while dropping a full-tensor HBM pass.
        if (node.kind == "maxpool" and prod.kind == "conv"
                and not prod.pool_k and only_consumer(src, j)):
            fused = dataclasses.replace(
                prod, name=node.name, pool_k=node.k,
                pool_stride=node.stride,
                parts=(prod.parts or (prod,)) + (node.parts or (node,)))
            nodes[j] = fused
            inputs[j] = inputs[i]       # keep the conv's edges (incl. any
            del nodes[i], inputs[i]     # residual epilogue it already has)
            return True
    return False


def fuse_graph(g: LayerGraph) -> LayerGraph:
    """Rewrite ``g`` into fused super-nodes (see module docstring).

    Structure-only (params-free): whether a fused node's pointwise
    weight is sparse or dense is a runtime dispatch inside the node
    executor, not a graph property. Idempotent: re-fusing a fused graph
    is a no-op."""
    nodes = list(g.nodes)
    inputs = [tuple(e) for e in g.inputs]
    while _fuse_once(nodes, inputs, g.output):
        pass
    fused = LayerGraph(g.name, tuple(nodes), tuple(inputs))
    fused.validate()
    return fused


@functools.lru_cache(maxsize=None)
def fused_graph_for(name: str) -> LayerGraph:
    """Fused LayerGraph for one of the paper's CNNs (cached). This is
    the graph the interpreter runs on by default; ``graph.graph_for``
    keeps the unfused view."""
    from repro_torch.core.graph import graph_for
    return fuse_graph(graph_for(name))
