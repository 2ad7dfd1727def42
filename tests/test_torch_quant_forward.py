"""The port's int8 and f32 stores through the whole CNN forward on the
CPU against the JAX reference, at full width, 32 px (split from
``tests/test_torch_quant.py`` so the two run side by side): the int8
forward against the reference's (XLA, and Pallas in interpret mode for
ResNet-50), node by node, the reference's own int8 bars held within the
port, and the f32 store."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_quant_ref import (  # noqa: E402
    ARCHS, FAST_RTOL, LOGIT_RTOL, ORACLE_RTOL, _assert_close, _forward,
    _images, _reference, _weights)
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import cnn  # noqa: E402


# --- the int8 forward -----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_int8_forward_matches_reference_xla(arch):
    """The port's int8 CPU forward vs the reference's int8 forward on the
    same codes: the native parity bar, top-1 equal, on 4 images."""
    _, ref8, native = _weights(arch)
    x = _images(4, seed=3)
    got = _forward(arch, quant.quantize_tree(native, "int8"), x)
    _assert_close(got.numpy(), _reference(arch, ref8, x, "xla"), LOGIT_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_nodes_match_reference_on_the_same_inputs(arch):
    """Every node of the fused graph, fed the port's own input to it,
    against the reference's node on the same input and int8 weights: the
    bf16 outputs within 1 bf16 ulp, the logits within the parity bar.
    Unlike the whole forward, this does not accumulate: a sum taken in
    another order that rounds one bf16 activation the other way moves
    random-init MobileNet logits by ~1e-3 of their maximum downstream."""
    from repro.core.fusion import fused_graph_for as ref_fused_graph_for
    from repro_torch.core.fusion import fused_graph_for
    from repro_torch.core.graph import INPUT
    _, ref8, native = _weights(arch)
    params = quant.quantize_tree(native, "int8")
    graph, ref_graph = fused_graph_for(arch), ref_fused_graph_for(arch)
    x = _images(4, seed=3)[3:]
    env = {INPUT: torch.from_numpy(x).to(torch.bfloat16)}
    with torch.inference_mode(), ref_ops.config(impl="xla"):
        for node, ref_node, srcs in zip(graph.nodes, ref_graph.nodes,
                                        graph.inputs):
            assert node.name == ref_node.name
            args = [env[s] for s in srcs]
            got = cnn.run_node(node, params, *args)
            ref_args = [jnp.asarray(a.float().numpy()).astype(
                jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32)
                for a in args]
            want = np.asarray(jax.jit(
                lambda *a, n=ref_node: ref_cnn.run_node(n, ref8, *a))(
                    *ref_args), np.float32)
            got32 = got.float().numpy()
            if got.dtype == torch.bfloat16:
                np.testing.assert_allclose(
                    got32, want, rtol=2 ** -7,
                    atol=2 ** -7 * np.abs(want).max(), err_msg=node.name)
            else:
                _assert_close(got32, want, LOGIT_RTOL)
            env[node.name] = got


def test_int8_forward_matches_reference_pallas():
    """ResNet-50 int8 against the reference's Pallas kernels (interpret
    mode): the int8 sparse_conv with its scale in the flush and the
    int8 classifier."""
    _, ref8, native = _weights("resnet50")
    x = _images(1, seed=4)
    got = _forward("resnet50", quant.quantize_tree(native, "int8"), x)
    _assert_close(got.numpy(), _reference("resnet50", ref8, x, "pallas"),
                  LOGIT_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_tracks_the_unquantized_forward(arch):
    """The reference's oracle bar within the port: int8 vs the native
    weights' forward within 0.05 of max |logit|, top-1 on every image."""
    _, _, native = _weights(arch)
    x = _images(4, seed=5)
    _assert_close(_forward(arch, quant.quantize_tree(native, "int8"), x),
                  _forward(arch, native, x), ORACLE_RTOL)


@pytest.mark.parametrize("arch", ["mobilenet_v1", "resnet50"])
def test_int8_fast_path_matches_dequant_at_entry(arch):
    """``ops.config(int8_fast_path=False)`` dequantizes at op entry;
    the fast path (codes into the kernels, scale in the epilogue) agrees
    within the reference's 0.02 of max |logit|, and the knob is scoped."""
    _, _, native = _weights(arch)
    params = quant.quantize_tree(native, "int8")
    x = _images(2, seed=6)
    fast = _forward(arch, params, x)
    with ops.config(int8_fast_path=False):
        assert not ops.int8_fast_path()
        slow = _forward(arch, params, x)
    assert ops.int8_fast_path()
    _assert_close(fast, slow, FAST_RTOL)
    assert not torch.equal(fast, slow)      # two routes, not one


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_store_forward(arch):
    """f32-stored weights hold the native bf16 values widened, so the
    CPU forward equals the native one bit for bit, and meets the parity
    bar against the reference's native forward. (The reference itself
    cannot run an f32 store: ``lax.conv_general_dilated`` refuses the
    bf16 activation with an f32 stem weight.)"""
    ref, _, native = _weights(arch)
    x = _images(2, seed=7)
    got = _forward(arch, quant.quantize_tree(native, "f32"), x)
    assert torch.equal(got, _forward(arch, native, x))
    _assert_close(got.numpy(), _reference(arch, ref, x, "xla"), LOGIT_RTOL)
