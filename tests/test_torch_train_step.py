"""One ``steps.make_train_step`` of the port against the JAX reference's
jitted ``make_train_step`` for every LM family at ``reduced()`` size
(B 2, T 16, the steps' default remat "full" and ``AdamWConfig()``), on
the reference's weights carried across bit for bit.

Bars, each 1 bf16 ulp: the loss and the global gradient norm within
2**-8 relative; every updated param within 1 bf16 ulp plus 2 lr (the
first update moves each element by lr times the sign of its gradient,
so an element whose tiny gradient the two packages sum to opposite signs
parts by 2 lr; tests/test_torch_optim.py holds the update itself within
1 ulp fed the same gradients); integer leaves and the step count equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm_ref import (TRAIN_LMS, bf16_ulp, model,  # noqa: E402
                           one_torch_thread, train_batch)
from repro.launch import steps as ref_steps  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ULP_RTOL = 2.0 ** -8


@pytest.mark.parametrize("arch", TRAIN_LMS)
def test_train_step_matches_reference(arch):
    rcfg, cfg, rparams, params = model(arch)
    batch, rbatch = train_batch(cfg, seed=5)
    rp, rst, rmet = jax.jit(ref_steps.make_train_step(rcfg))(
        rparams, ref_adamw.init(rparams), rbatch)
    p, st, met = steps.make_train_step(cfg)(params, adamw.init(params),
                                           batch)
    assert int(st.step) == int(rst.step) == 1
    for k in ("loss", "grad_norm"):
        assert abs(float(met[k]) - float(rmet[k])) <= \
            ULP_RTOL * abs(float(rmet[k])), (k, float(met[k]),
                                             float(rmet[k]))
    assert float(met["lr"]) == pytest.approx(float(rmet["lr"]), rel=1e-6)
    want = {"|".join(str(q) for q in path): np.asarray(
        jnp.asarray(leaf).astype(jnp.float32)
        if jnp.issubdtype(leaf.dtype, jnp.floating) else leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(rp)}
    got = dict(pytree.keyed_leaves(p))
    assert set(got) == set(want)
    lr = float(met["lr"])
    for key, t in got.items():
        if not t.is_floating_point():
            np.testing.assert_array_equal(t.numpy(), want[key])
            continue
        g = t.float().numpy()
        assert (np.abs(g - want[key]) <= bf16_ulp(want[key]) + 2 * lr
                ).all(), key
