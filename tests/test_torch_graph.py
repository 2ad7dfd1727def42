"""The port's graph IR, fusion and pruning vs the JAX reference, and the
port's import boundary (no JAX, nothing of the reference package)."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SparsityConfig as RefSparsityConfig  # noqa: E402
from repro.core import fusion as ref_fusion  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.core import sparsity as ref_sparsity  # noqa: E402
from repro_torch.configs import SparsityConfig, get_config  # noqa: E402
from repro_torch.core import fusion, graph, sparsity  # noqa: E402
from repro_torch.models.cnn import tensor_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CNNS = [("resnet50", 72, 54), ("mobilenet_v1", 29, 15),
        ("mobilenet_v2", 64, 36)]


def _same_graph(port, ref):
    assert [dataclasses.asdict(n) for n in port.nodes] == \
        [dataclasses.asdict(n) for n in ref.nodes]
    assert port.inputs == ref.inputs
    assert port.output == ref.output


@pytest.mark.parametrize("name,n_nodes,n_fused", CNNS)
def test_graph_matches_reference(name, n_nodes, n_fused):
    _same_graph(graph.graph_for(name), ref_graph.graph_for(name))
    assert len(graph.graph_for(name).nodes) == n_nodes


@pytest.mark.parametrize("name,n_nodes,n_fused", CNNS)
def test_fused_graph_matches_reference(name, n_nodes, n_fused):
    _same_graph(fusion.fused_graph_for(name), ref_fusion.fused_graph_for(name))
    assert len(fusion.fused_graph_for(name).nodes) == n_fused


def test_resnet50_fused_node_kinds():
    """36 plain convs, 16 with a residual epilogue, the pooled stem, and
    the avgpool_fc head."""
    nodes = fusion.fused_graph_for("resnet50").nodes
    convs = [n for n in nodes if n.kind == "conv"]
    assert sum(1 for n in convs if n.residual_from) == 16
    assert sum(1 for n in convs if n.pool_k) == 1
    assert sum(1 for n in convs
               if not n.residual_from and not n.pool_k) == 36
    assert [n.kind for n in nodes].count("avgpool_fc") == 1


def test_configs_match_reference():
    from repro.configs import get_config as ref_get_config
    for name, _, _ in CNNS:
        port, ref = get_config(name), ref_get_config(name)
        assert (port.name, port.family) == (ref.name, ref.family)
        for f in ("enabled", "sparsity", "block_m", "block_n"):
            assert getattr(port.sparsity, f) == getattr(ref.sparsity, f)


@pytest.mark.parametrize("shape,bm,bn,sp", [
    ((9 * 64, 128), 32, 32, 0.85),     # a 3x3 conv weight, ResNet blocks
    ((2048, 1000), 32, 25, 0.85),      # the classifier: bn = 25
    ((256, 64), 16, 16, 0.5),
])
def test_to_block_balanced_matches_reference(shape, bm, bn, sp):
    rng = np.random.default_rng(sum(shape) + bm)
    w = np.asarray(jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32))
                   .astype(jnp.bfloat16))
    ref = ref_sparsity.to_block_balanced(
        jnp.asarray(w), RefSparsityConfig(enabled=True, sparsity=sp,
                                          block_m=bm, block_n=bn))
    got = sparsity.to_block_balanced(
        tensor_from_numpy(w), SparsityConfig(enabled=True, sparsity=sp,
                                             block_m=bm, block_n=bn))
    assert got.idx.dtype == torch.int32
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.vals.view(torch.int16).numpy(),
                                  np.asarray(ref.vals).view(np.int16))
    np.testing.assert_array_equal(
        sparsity.densify(got).view(torch.int16).numpy(),
        np.asarray(ref_sparsity.densify(ref)).view(np.int16))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 4
    files += examples
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (str(f), mod)


def test_port_loads_without_jax():
    """Importing every module of the port pulls in no JAX at run time."""
    mods = []
    for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        parts = p.relative_to(ROOT / "src").with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=env)
