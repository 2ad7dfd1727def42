"""The paper's own networks on the port: sparse ResNet-50 V1 and the
dense MobileNet-V1 and MobileNet-V2.

Counterpart of the reference's ``src/repro/models/cnn.py``, with its
layout (NHWC activations, HWIO-flattened (k*k*cin, cout) conv weights,
(k, k, C) depthwise weights) and its dtype boundaries: images are cast
to bf16 on entry, every conv accumulates in f32, adds its bias in f32
and rounds once to bf16, and the classifier runs in f32. Every pruned
conv goes through the fused implicit-GEMM block-sparse conv
(``kernels/ops.sparse_conv``) and the pruned classifier through
``kernels/ops.sparse_matmul``; every MobileNet dw->pw block goes
through the fused dw->pw conv (``kernels/ops.dw_pw_conv``) and every
standalone depthwise node through ``kernels/ops.depthwise_conv``. The
dense convs (the stems, ResNet-50's five stage-0 1x1 convs too narrow
to prune, MobileNet-V2's expansion convs and ``conv_last``) run through
``F.conv2d`` in full f32, as the reference leaves them to ``lax.conv``.

``cnn_forward`` is the graph interpreter over the FUSED layer graph
(``core/fusion.py``): dw->pw pairs are one node, residual ``add``(+relu)
tails, the stem's max-pool and the avgpool->fc head are epilogues of
the node before them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.core.fusion import conv_part, fused_graph_for
from repro_torch.core.graph import INPUT, ConvSpec, LayerGraph
from repro_torch.core.quant import QuantizedWeight
from repro_torch.kernels import ops as kops
from repro_torch.kernels.sparse_conv import same_pads
from repro_torch.models import layers as L
from repro_torch.models.layers import SparseWeight, tensor_from_numpy

# ---------------------------------------------------------------------------
# layer spec builders (the "TensorFlow graph" the compiler walks)
# ---------------------------------------------------------------------------

def resnet50_specs() -> list[ConvSpec]:
    specs = [ConvSpec("conv1", "conv", 3, 64, 7, 2, 224),
             ConvSpec("pool1", "maxpool", 64, 64, 3, 2, 112)]
    blocks = [(3, 64, 256, 56), (4, 128, 512, 28),
              (6, 256, 1024, 14), (3, 512, 2048, 7)]
    cin = 64
    for si, (n, mid, out, hw) in enumerate(blocks):
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            ihw = hw * stride      # input spatial before downsample
            pre = f"s{si}b{bi}"
            block_in = specs[-1].name
            specs += [
                ConvSpec(f"{pre}_c1", "conv", cin, mid, 1, stride, ihw),
                ConvSpec(f"{pre}_c2", "conv", mid, mid, 3, 1, hw),
                ConvSpec(f"{pre}_c3", "conv", mid, out, 1, 1, hw,
                         relu=False),
            ]
            resid = block_in
            if bi == 0:
                resid = f"{pre}_proj"
                specs.append(ConvSpec(f"{pre}_proj", "conv", cin, out, 1,
                                      stride, ihw, relu=False,
                                      input_from=block_in))
            specs.append(ConvSpec(f"{pre}_add", "add", out, out, 1, 1, hw,
                                  residual_from=resid,
                                  input_from=f"{pre}_c3"))
            cin = out
    specs += [ConvSpec("avgpool", "avgpool", 2048, 2048, 7, 1, 7),
              ConvSpec("fc", "fc", 2048, 1000, 1, 1, 1)]
    return specs


_MBV1 = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
         (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
        [(512, 1024, 2), (1024, 1024, 1)]


def mobilenet_v1_specs() -> list[ConvSpec]:
    specs = [ConvSpec("conv1", "conv", 3, 32, 3, 2, 224)]
    hw = 112
    for i, (cin, cout, s) in enumerate(_MBV1):
        specs += [ConvSpec(f"b{i}_dw", "dw", cin, cin, 3, s, hw),
                  ConvSpec(f"b{i}_pw", "conv", cin, cout, 1, 1, hw // s)]
        hw //= s
    specs += [ConvSpec("avgpool", "avgpool", 1024, 1024, 7, 1, 7),
              ConvSpec("fc", "fc", 1024, 1000, 1, 1, 1)]
    return specs


_MBV2 = [  # (expansion, cout, n, stride)
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


def mobilenet_v2_specs() -> list[ConvSpec]:
    specs = [ConvSpec("conv1", "conv", 3, 32, 3, 2, 224)]
    cin, hw = 32, 112
    for si, (t, cout, n, stride) in enumerate(_MBV2):
        for bi in range(n):
            s = stride if bi == 0 else 1
            mid = cin * t
            pre = f"s{si}b{bi}"
            block_in = specs[-1].name
            if t != 1:
                specs.append(ConvSpec(f"{pre}_exp", "conv", cin, mid, 1, 1, hw))
            specs += [ConvSpec(f"{pre}_dw", "dw", mid, mid, 3, s, hw),
                      ConvSpec(f"{pre}_pj", "conv", mid, cout, 1, 1, hw // s,
                               relu=False)]
            if s == 1 and cin == cout:
                # MobileNet-V2 linear bottleneck: residual add, NO relu
                specs.append(ConvSpec(f"{pre}_add", "add", cout, cout, 1, 1,
                                      hw // s, residual_from=block_in,
                                      relu=False))
            hw //= s
            cin = cout
    specs += [ConvSpec("conv_last", "conv", 320, 1280, 1, 1, 7),
              ConvSpec("avgpool", "avgpool", 1280, 1280, 7, 1, 7),
              ConvSpec("fc", "fc", 1280, 1000, 1, 1, 1)]
    return specs


def specs_for(name: str) -> list[ConvSpec]:
    return {"resnet50": resnet50_specs,
            "mobilenet_v1": mobilenet_v1_specs,
            "mobilenet_v2": mobilenet_v2_specs}[name]()


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _maybe_sparse(w2d, sp, cin: Optional[int] = None):
    """Prune a 2D weight block-balanced. For conv weights pass ``cin``:
    the block-row size must divide the input-channel count (not just
    k*k*cin) so every block is a single (ky, kx, channel-block) gather
    of the fused implicit-GEMM kernel."""
    if sp is None or not sp.enabled:
        return w2d
    d_in, d_out = w2d.shape
    unit = cin if cin is not None else d_in
    bm = sp.block_m if unit % sp.block_m == 0 else _largest_div(unit, sp.block_m)
    bn = sp.block_n if d_out % sp.block_n == 0 else _largest_div(d_out, sp.block_n)
    if bm < 4 or bn < 4 or d_in // bm < 4:
        return w2d                       # too small to prune blockwise
    from repro_torch.core import sparsity as S
    return S.to_block_balanced(
        w2d, dataclasses.replace(sp, block_m=bm, block_n=bn))


def _largest_div(n, cap):
    for b in range(min(cap, n), 0, -1):
        if n % b == 0:
            return b
    return 1


def params_to(p: dict, device) -> dict:
    """A CNN's params on ``device``: every leaf (tensor, SparseWeight,
    QuantizedWeight) moved, bits unchanged."""
    return {name: {"w": q["w"].to(device), "b": q["b"].to(device)}
            for name, q in p.items()}


def init_cnn(cfg, generator: torch.Generator, *, device="cuda") -> dict:
    """Random weights for ``cfg`` (the reference's ``init_cnn`` law:
    uniform +-1/sqrt(fan_in) in f32 then bf16, depthwise weights
    (k, k, C) with fan_in k*k, zero biases, convs and classifier pruned
    block-balanced where ``cfg.sparsity`` allows).

    Drawn in spec order from ``generator`` on the generator's device and
    then moved to ``device``, so one seed gives the same weights on the
    CPU and on the card. torch's generator is not ``jax.random``: to
    hold the port against the reference, carry the reference's weights
    across with :func:`params_from_numpy` instead."""
    dev = resolve_device(device)
    specs = [s for s in specs_for(cfg.name)
             if s.kind in ("conv", "dw", "fc")]
    sp = cfg.sparsity
    params = {}
    for s in specs:
        if s.kind == "conv":
            fan_in = s.k * s.k * s.cin
            w = L.dense_init(generator, (fan_in, s.cout), fan_in)
            w = _maybe_sparse(w, sp, cin=s.cin)
        elif s.kind == "dw":
            w = L.dense_init(generator, (s.k, s.k, s.cin), s.k * s.k)
        else:
            w = _maybe_sparse(L.dense_init(generator, (s.cin, s.cout), s.cin),
                              sp)
        params[s.name] = {"w": w, "b": torch.zeros((s.cout,),
                                                   dtype=torch.bfloat16)}
    return params_to(params, dev)


def params_from_numpy(tree: dict, *, device="cuda") -> dict:
    """The reference's CNN params, given as numpy, as the port's:
    ``{name: {"w": w, "b": ndarray}}`` with ``w`` an ndarray, a sparse
    ``{"vals", "idx", "d_in"[, "scale", "orig_dtype"]}`` or a quantized
    dense ``{"codes", "scale", "orig_dtype"}``, -> ``{name: {"w": Tensor
    | SparseWeight | QuantizedWeight, "b": Tensor}}`` on ``device``.
    Every leaf keeps its dtype and bits (int8 codes, f32 scales)."""
    dev = resolve_device(device)
    params = {}
    for name, p in tree.items():
        w = p["w"]
        if isinstance(w, dict) and "codes" in w:
            w = QuantizedWeight(tensor_from_numpy(w["codes"]),
                                tensor_from_numpy(w["scale"]),
                                str(w["orig_dtype"]))
        elif isinstance(w, dict):
            scale = w.get("scale")
            w = SparseWeight(tensor_from_numpy(w["vals"]),
                             tensor_from_numpy(w["idx"]).to(torch.int32),
                             int(w["d_in"]),
                             None if scale is None
                             else tensor_from_numpy(scale),
                             w.get("orig_dtype"))
        else:
            w = tensor_from_numpy(w)
        params[name] = {"w": w, "b": tensor_from_numpy(p["b"])}
    return params_to(params, dev)


# ---------------------------------------------------------------------------
# node executors
# ---------------------------------------------------------------------------

def _pad_same_nchw(x, k: int, stride: int, value: float = 0.0):
    """SAME padding of an NCHW tensor, lo = total // 2 as in lax (the
    stem's 7x7/2 conv at 224 px pads (2, 3); ``F.conv2d(padding=)``
    would pad (3, 3))."""
    _, ph_lo, ph_hi = same_pads(x.shape[2], k, stride)
    _, pw_lo, pw_hi = same_pads(x.shape[3], k, stride)
    return F.pad(x, (pw_lo, pw_hi, ph_lo, ph_hi), value=value)


def conv2d(x, p, s: ConvSpec, *, relu=True, residual=None):
    """The HPIPE convolution unit: the fused block-sparse conv kernel for
    pruned weights, ``F.conv2d`` for dense ones. No im2col tensor either
    way. ``residual``: optional skip tensor joined in the epilogue
    before the activation. An int8 SparseWeight goes to the kernel
    dispatch (which applies its scale in the epilogue); a dense
    QuantizedWeight is dequantized here, on every call, as in the
    reference (``F.conv2d`` has no epilogue to take the scale)."""
    w = p["w"]
    if isinstance(w, SparseWeight):
        return kops.sparse_conv(x, w, p["b"], k=s.k, stride=s.stride,
                                relu=relu, residual=residual)
    if isinstance(w, QuantizedWeight):
        w = w.dequant()
    # full-f32 operands: the products of bf16 values are exact, and the
    # sums are f32 as in the reference's preferred_element_type=f32
    xn = _pad_same_nchw(x.float().permute(0, 3, 1, 2), s.k, s.stride)
    w4 = w.float().reshape(s.k, s.k, s.cin, s.cout).permute(3, 2, 0, 1)
    with L.full_f32():
        y = F.conv2d(xn, w4, stride=s.stride)
    y = y.permute(0, 2, 3, 1) + p["b"].float()
    if residual is not None:
        # the reference's order: round to bf16, add the bf16 skip, relu
        y = y.to(x.dtype) + residual
        y = torch.relu(y) if relu else y
    else:
        if relu:
            y = torch.relu(y)
        y = y.to(x.dtype)
    return y.contiguous()


def depthwise(x, p, s: ConvSpec, *, relu=True):
    """A standalone depthwise node: the depthwise kernel's bf16 output,
    then bias and ReLU in bf16 (the reference's order, a second rounding
    that the fused dw->pw node does not have). A quantized weight is
    dequantized on entry: the depthwise has no wide accumulator whose
    epilogue could take a scale."""
    w = p["w"]
    if isinstance(w, QuantizedWeight):
        w = w.dequant()
    y = kops.depthwise_conv(x, w, stride=s.stride) + p["b"]
    return torch.relu(y) if relu else y


def _fused_dw_pw(x, params, node: ConvSpec, residual=None):
    """A fused dw_pw node: the depthwise intermediate never reaches
    device memory (``kernels/dw_pw_fused.py``). A pruned pointwise
    weight takes the two-op sequence inside the node instead, as in the
    reference: the fused kernel needs a dense (C, Cout) weight, and the
    paper runs the MobileNets dense, so that branch is reached only with
    a pruned pw weight."""
    dw_s, pw_s = node.parts[0], node.parts[1]
    dw_p, pw_p = params[dw_s.name], params[pw_s.name]
    if isinstance(pw_p["w"], SparseWeight):
        y = depthwise(x, dw_p, dw_s, relu=dw_s.relu)
        return conv2d(y, pw_p, pw_s, relu=node.relu, residual=residual)
    return kops.dw_pw_conv(x, dw_p["w"], dw_p["b"], pw_p["w"], pw_p["b"],
                           stride=node.stride, dw_relu=dw_s.relu,
                           relu=node.relu, residual=residual)


def _maxpool_same(x, k: int, stride: int):
    """``lax.reduce_window(max, SAME)``: -inf padding with lo = total // 2
    (at 112 px, 3x3/2: (0, 1); ``F.max_pool2d(padding=1)`` would pad
    (1, 1))."""
    xn = _pad_same_nchw(x.permute(0, 3, 1, 2), k, stride, float("-inf"))
    return F.max_pool2d(xn, k, stride).permute(0, 2, 3, 1).contiguous()


def _global_avgpool(x):
    """Mean over H, W of a bf16 tensor: summed in f32, divided, rounded
    to bf16 (what ``jnp.mean`` does on bf16)."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)


def fc_apply(p, x):
    """The classifier matmul, dense or pruned: f32 inputs and
    accumulation either way, so logits stay f32; the bias joins after,
    in f32. A dense QuantizedWeight: the code product, then the
    per-channel scale (dequantized at entry under
    ``ops.config(int8_fast_path=False)``), as in the reference."""
    w = p["w"]
    x32 = x.float()
    if isinstance(w, SparseWeight):
        y = kops.sparse_matmul(x32, w)
    elif isinstance(w, QuantizedWeight):
        if kops.int8_fast_path():
            y = (x32 @ w.codes.float()) * w.scale
        else:
            y = x32 @ w.dequant().float()
    else:
        y = x32 @ w.float()
    return y + p["b"].float()


def run_node(node: ConvSpec, params, *args):
    """Execute one IR node (original layer kinds + the fused super-nodes
    of core/fusion.py). ``args`` are the resolved input values
    (primary[, residual] — see LayerGraph.inputs).

    On the CPU a batch runs one image at a time: the CPU's conv and
    matmul libraries sum a row in another order at another batch size,
    and the layer pipeline's bitwise contract needs a microbatch to give
    the rows the whole batch gives. Each image's sums stay f32, in the
    order one image takes. On the card the kernels see the whole batch."""
    if args[0].device.type != "cuda" and args[0].shape[0] > 1:
        return torch.cat([_run_node(node, params, *one)
                          for one in zip(*(a.split(1) for a in args))])
    return _run_node(node, params, *args)


def _run_node(node: ConvSpec, params, *args):
    x = args[0]
    res = args[1] if (node.residual_from and node.kind != "add") else None
    if node.kind == "conv":
        p = params[conv_part(node).name]
        y = conv2d(x, p, node, relu=node.relu, residual=res)
        if node.pool_k:                  # fused pooling epilogue (R4)
            y = _maxpool_same(y, node.pool_k, node.pool_stride)
        return y
    if node.kind == "dw_pw":
        return _fused_dw_pw(x, params, node, residual=res)
    if node.kind == "dw":
        return depthwise(x, params[node.name], node, relu=node.relu)
    if node.kind == "maxpool":
        return _maxpool_same(x, node.k, node.stride)
    if node.kind == "avgpool":
        return _global_avgpool(x)
    if node.kind == "add":
        y = x + args[1]
        return torch.relu(y) if node.relu else y
    if node.kind in ("fc", "avgpool_fc"):
        if node.kind == "avgpool_fc":                    # fused head
            x = _global_avgpool(x)
        return fc_apply(params[conv_part(node).name], x)
    raise ValueError(f"unknown node kind {node.kind!r}")


# ---------------------------------------------------------------------------
# the graph interpreter
# ---------------------------------------------------------------------------

def _interpret(g: LayerGraph, params, x, *, start=0, stop=None,
               env=None) -> dict:
    """Execute nodes [start, stop) of ``g``. ``env`` maps value names to
    tensors and must contain every value the slice reads; returns the
    env extended with each executed node's output. Dead values are NOT
    freed here: slicing callers (stage programs) bound liveness via the
    wire contract instead."""
    env = dict(env or {})
    if x is not None:
        env[INPUT] = x
    stop = len(g.nodes) if stop is None else stop
    for i in range(start, stop):
        env[g.nodes[i].name] = run_node(g.nodes[i], params,
                                        *[env[s] for s in g.inputs[i]])
    return env


def cnn_forward(cfg, params, images, *, graph: Optional[LayerGraph] = None,
                device="cuda") -> torch.Tensor:
    """images: (N, H, W, 3) f32 (tensor or numpy) -> f32 logits
    (N, 1000) on ``device``, where ``params`` must live. Runs the FUSED
    graph by default; pass ``graph=graph_for(name)`` for the unfused
    view. The images are moved to ``device`` as they are and cast to
    bf16 there."""
    dev = resolve_device(device)
    g = graph if graph is not None else fused_graph_for(cfg.name)
    x = torch.as_tensor(images).to(dev).to(torch.bfloat16).contiguous()
    with torch.inference_mode():
        env = _interpret(g, params, x)
    return env[g.output]


# ---------------------------------------------------------------------------
# heterogeneous stage programs for the layer pipeline
# ---------------------------------------------------------------------------

class ValueShape(NamedTuple):
    """Shape and dtype of one IR value (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def _out_shape(node: ConvSpec, x: ValueShape) -> ValueShape:
    """The output of ``node`` on a primary input of shape ``x`` (NHWC
    bf16 activations; the classifier's logits f32): what ``run_node``
    returns, from the spec alone."""
    n, h, w, c = x.shape if len(x.shape) == 4 else (x.shape[0], 0, 0,
                                                    x.shape[-1])
    if node.kind in ("fc", "avgpool_fc"):
        return ValueShape((n, node.cout), torch.float32)
    if node.kind == "avgpool":
        return ValueShape((n, c), x.dtype)
    if node.kind == "add":
        return x
    ho, wo = -(-h // node.stride), -(-w // node.stride)
    if node.pool_stride:
        ho, wo = -(-ho // node.pool_stride), -(-wo // node.pool_stride)
    cout = c if node.kind in ("dw", "maxpool") else node.cout
    return ValueShape((n, ho, wo, cout), x.dtype)


def node_shapes(cfg, params, image_shape,
                graph: Optional[LayerGraph] = None) -> dict:
    """Shape and dtype of every IR value (INPUT + each node output) at a
    concrete image shape (N, H, W, 3): the shape inference the stage
    partitioner needs to size wires, derived from the specs (the
    reference evaluates its interpreter abstractly, ``jax.eval_shape``;
    the values are the same). Defaults to the fused graph; pass an
    explicit graph for the unfused view."""
    g = graph if graph is not None else fused_graph_for(cfg.name)
    shapes = {INPUT: ValueShape(tuple(image_shape), torch.bfloat16)}
    for node, srcs in zip(g.nodes, g.inputs):
        shapes[node.name] = _out_shape(node, shapes[srcs[0]])
    return shapes


def stage_part_names(g: LayerGraph, stage_of) -> list[list[str]]:
    """Per stage: the fused-node PART names owning parameters — the keys
    of the param dict each stage's weights live under."""
    out = []
    for sl in g.partition(list(stage_of)):
        names = []
        for node in g.nodes[sl.start:sl.stop]:
            for part in (node.parts or (node,)):
                if part.kind in ("conv", "dw", "fc"):
                    names.append(part.name)
        out.append(names)
    return out


def stage_param_trees(g: LayerGraph, stage_of, params) -> list[dict]:
    """Each stage's parameter slice of the full tree: exactly the part
    params its IR slice reads."""
    return [{n: params[n] for n in names}
            for names in stage_part_names(g, stage_of)]


def stage_programs(cfg, params, stage_of, image_shape, *,
                   graph: Optional[LayerGraph] = None,
                   placed: bool = False, quantize: str = "native",
                   align: int = 1):
    """Compile the IR into per-stage wire programs (reference
    ``models/cnn.py:400``).

    stage_of: stage id per IR node of the FUSED graph (contiguous, from
    ``planner.plan``). image_shape: (mb, H, W, 3) of ONE microbatch.
    Returns ``(stage_fns, pack_in, unpack_out, width)``:

    - stage_fns[s](wire, out=None): (mb, width) f32 wire -> (mb, width)
      f32 wire, written into ``out`` when given. The wire carries the
      stage boundary's live values (activations AND residual skips
      crossing the cut), each f32-widened (bf16 -> f32 is exact, so
      pipelined == sequential bit for bit).
    - pack_in(images, out=None): (mb, H, W, 3) f32 -> input wire for
      stage 0 (the images rounded to bf16, as ``cnn_forward`` does).
    - unpack_out(wire): last stage's wire -> (mb, 1000) f32 logits.

    ``placed=True`` compiles PLACED stage programs instead:
    ``stage_fns[s](row, wire, out=None)`` unpacks stage s's params from
    its own uint8 row (``pipeline.ParamFormat``: views, bit-exact, so
    placed == closures bitwise) and closes over no weight; a fifth
    return value, ``pipeline.PlacedParams``, plans the rows
    (``.pack_ragged()``, or the even buffer ``.pack()``). ``align``:
    the rows' layout (1, the reference's bytes; ``pipeline.ALIGN`` puts
    every leaf on a 16-byte boundary, as a server's rows on the card).

    ``quantize`` (``core/quant.py`` store dtype) re-stores the weights
    ONCE up front, so the placed trees, their formats and the closures
    all read the same stored bits."""
    from repro_torch.core import pipeline as pp
    from repro_torch.core.quant import quantize_tree
    g = graph if graph is not None else fused_graph_for(cfg.name)
    params = quantize_tree(params, quantize)
    slices = g.partition(list(stage_of))
    shapes = node_shapes(cfg, params, image_shape, graph=g)

    def fmt(names):
        return pp.WireFormat.for_values(
            [(n, shapes[n].shape, shapes[n].dtype) for n in names])

    in_fmts = [fmt(sl.in_live) for sl in slices]
    out_fmts = [fmt(sl.out_live) for sl in slices]
    width = max(f.width for f in in_fmts + out_fmts)

    placed_params = None
    if placed:
        trees = stage_param_trees(g, stage_of, params)
        pfmts = [pp.ParamFormat.for_tree(t, store_dtype=quantize)
                 for t in trees]
        pwidth = max(max((f.nbytes for f in pfmts), default=0), 1)
        placed_params = pp.PlacedParams(formats=tuple(pfmts),
                                        trees=tuple(trees), width=pwidth,
                                        align=align)

    def make_stage(sl, in_fmt, out_fmt, pfmt=None):
        def run(sparams, wire, out):
            with torch.no_grad():
                env = dict(zip(sl.in_live, in_fmt.unpack(wire)))
                env = _interpret(g, sparams, None, start=sl.start,
                                 stop=sl.stop, env=env)
                return out_fmt.pack([env[n] for n in sl.out_live], width,
                                    out=out)

        if pfmt is None:
            return lambda wire, out=None: run(params, wire, out)
        return lambda row, wire, out=None: run(pfmt.unpack(row, align),
                                               wire, out)

    pfmts = placed_params.formats if placed else [None] * len(slices)
    stage_fns = [make_stage(sl, fi, fo, pf)
                 for sl, fi, fo, pf in zip(slices, in_fmts, out_fmts, pfmts)]

    def pack_in(images, out=None):
        return in_fmts[0].pack([images.to(torch.bfloat16)], width, out=out)

    def unpack_out(wire):
        return out_fmts[-1].unpack(wire)[0]

    if placed:
        return stage_fns, pack_in, unpack_out, width, placed_params
    return stage_fns, pack_in, unpack_out, width


# ---------------------------------------------------------------------------
# frozen pre-IR reference (regression oracle)
# ---------------------------------------------------------------------------

def cnn_forward_reference(cfg, params, images, *, device="cuda"):
    """The reference's frozen per-model forward monoliths (reference
    ``models/cnn.py:496``), written without the layer graph: the oracle
    the graph interpreter is held to bit for bit, through the same node
    executors (``conv2d``, ``depthwise``, ``fc_apply``). It equals
    ``cnn_forward(graph=graph_for(name))``, the unfused view, bitwise. On
    the card its depthwise nodes launch ``depthwise_conv``, its pruned
    convs ``sparse_conv`` and its pruned classifier ``sparse_matmul``.
    On the CPU a batch runs one image at a time, as ``run_node`` does.
    Do not extend."""
    dev = resolve_device(device)
    x = torch.as_tensor(images).to(dev).to(torch.bfloat16).contiguous()
    with torch.inference_mode():
        if dev.type != "cuda" and x.shape[0] > 1:
            return torch.cat([_forward_reference(cfg.name, params, one)
                              for one in x.split(1)])
        return _forward_reference(cfg.name, params, x)


def _forward_reference(name: str, params, x):
    specs = {s.name: s for s in specs_for(name)}
    if name == "resnet50":
        x = conv2d(x, params["conv1"], specs["conv1"])
        x = _maxpool_same(x, 3, 2)
        blocks = [(3, 64, 256), (4, 128, 512), (6, 256, 1024), (3, 512, 2048)]
        for si, (nb, _mid, _out) in enumerate(blocks):
            for bi in range(nb):
                pre = f"s{si}b{bi}"
                resid = x
                y = conv2d(x, params[f"{pre}_c1"], specs[f"{pre}_c1"])
                y = conv2d(y, params[f"{pre}_c2"], specs[f"{pre}_c2"])
                y = conv2d(y, params[f"{pre}_c3"], specs[f"{pre}_c3"],
                           relu=False)
                if bi == 0:
                    resid = conv2d(x, params[f"{pre}_proj"],
                                   specs[f"{pre}_proj"], relu=False)
                x = torch.relu(y + resid)
        x = _global_avgpool(x)
    elif name == "mobilenet_v1":
        x = conv2d(x, params["conv1"], specs["conv1"])
        for i in range(len(_MBV1)):
            x = depthwise(x, params[f"b{i}_dw"], specs[f"b{i}_dw"])
            x = conv2d(x, params[f"b{i}_pw"], specs[f"b{i}_pw"])
        x = _global_avgpool(x)
    elif name == "mobilenet_v2":
        x = conv2d(x, params["conv1"], specs["conv1"])
        cin = 32
        for si, (t, cout, n, stride) in enumerate(_MBV2):
            for bi in range(n):
                pre = f"s{si}b{bi}"
                resid = x
                y = x
                if t != 1:
                    y = conv2d(y, params[f"{pre}_exp"], specs[f"{pre}_exp"])
                y = depthwise(y, params[f"{pre}_dw"], specs[f"{pre}_dw"])
                y = conv2d(y, params[f"{pre}_pj"], specs[f"{pre}_pj"],
                           relu=False)
                s = stride if bi == 0 else 1
                if s == 1 and cin == cout:
                    y = y + resid
                x = y
                cin = cout
        x = conv2d(x, params["conv_last"], specs["conv_last"])
        x = _global_avgpool(x)
    else:
        raise ValueError(name)
    # fc_apply is the one shared dispatch with the interpreter, as in the
    # reference: both sides run the identical classifier matmul
    return fc_apply(params["fc"], x)
