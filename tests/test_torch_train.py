"""LM training on the port on the CPU: remat, masked labels, ``train()``
step by step against the JAX reference's, restarts from checkpoints and
int8 gradient compression (the loss and gradients of every family:
tests/test_torch_train_loss.py; one train step of every family:
tests/test_torch_train_step.py). The reference's weights are carried
across bit for bit (``tests/_torch_lm_ref.py``).

Bars: ``train()``'s loss within 1e-3 relative of the reference's
``train()`` from the same weights at every step; the masked loss within
1e-4 of the reference's run op by op with its attention as its Pallas
kernel computes it (``_torch_lm_ref.attention_as_pallas``); remat and
restarts bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_lm_ref import (attention_as_pallas, eager, model,  # noqa: E402
                           one_torch_thread, train_batch)
from repro.launch import train as ref_train  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402

LOSS_RTOL = 1e-4
TRAIN_RTOL = 1e-3


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m",
                                  "zamba2-7b", "whisper-large-v3"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_bitwise(arch, remat):
    _, cfg, _, params = model(arch)
    batch, _ = train_batch(cfg, seed=4)
    out = {}
    for r in ("none", remat):
        (loss, _), g = steps.value_and_grad(
            lambda p: lm.loss_fn(cfg, p, batch, remat=r), params)
        out[r] = (loss, dict(pytree.keyed_leaves(g)))
    assert torch.equal(out["none"][0], out[remat][0])
    for key, g in out["none"][1].items():
        if g is not None:
            assert torch.equal(g, out[remat][1][key]), key


def test_masked_labels(monkeypatch):
    """Labels < 0 carry no loss: the port's loss equals the reference's
    on the same masked labels, and the mean nll of the kept positions
    from the full logits."""
    rcfg, cfg, rparams, params = model("smollm-360m")
    attention_as_pallas(monkeypatch)
    masked = (0, 3, 4, 15)
    batch, rbatch = train_batch(cfg, masked=masked)
    loss, metrics = lm.loss_fn(cfg, params, batch, remat="none")
    want, _ = eager(ref_lm.loss_fn, rcfg, rparams, rbatch, remat="none")
    assert abs(float(loss) - float(want)) <= LOSS_RTOL * abs(float(want))
    logits, _ = lm.forward(cfg, params, torch.from_numpy(batch["tokens"]))
    labels = torch.from_numpy(batch["labels"]).long()
    keep = labels >= 0
    nll = -torch.log_softmax(logits, -1).gather(
        -1, labels.clamp_min(0)[..., None])[..., 0]
    assert int(keep.sum()) == labels.numel() - len(masked)
    assert float(loss) == pytest.approx(float(nll[keep].mean()), rel=1e-6)
    all_masked = dict(batch, labels=np.full_like(batch["labels"], -1))
    assert float(lm.loss_fn(cfg, params, all_masked)[0]) == 0.0


def test_train_matches_reference():
    rcfg, cfg, rparams, params = model("smollm-360m")
    kw = dict(steps=10, batch=4, seq=32, verbose=False)
    got = train("smollm-360m", device="cpu", params=params, **kw)
    want = ref_train.train("smollm-360m", **kw)
    np.testing.assert_array_equal(
        lm.tensor_from_numpy(np.asarray(jax.tree.leaves(
            ref_lm.init_params(rcfg, jax.random.PRNGKey(0)))[0])).float(),
        pytree.leaves(params)[0].float())          # the same weights
    assert [s for s, _ in got["losses"]] == list(range(10))
    for (_, a), (_, b) in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= TRAIN_RTOL * abs(b), (got["losses"],
                                                   want["losses"])
    assert got["restarts"] == 0


def test_restart_bitwise(tmp_path):
    """10 steps with failures at steps 4 and 7 and a checkpoint every 3:
    2 restarts, and the final params and moments bit for bit those of
    the clean run."""
    _, cfg, _, params = model("smollm-360m")
    kw = dict(steps=10, batch=4, seq=32, verbose=False, device="cpu",
              params=params)
    clean = train("smollm-360m", **kw)
    out = train("smollm-360m", ckpt_dir=str(tmp_path), ckpt_every=3,
                fail_at=(4, 7), **kw)
    assert out["restarts"] == 2
    assert [l for _, l in out["losses"]] == [l for _, l in clean["losses"]]
    got, want = (dict(pytree.keyed_leaves(r["state"])) for r in (out, clean))
    assert set(got) == set(want)
    for key, t in got.items():
        assert t.dtype == want[key].dtype and torch.equal(t, want[key]), key


def test_grad_compress_loss_falls():
    """The reference's own check (tests/test_integration.py): 30 steps
    of batch 8 x 64 with int8 gradients, the last 5 losses' mean below
    the first 3's."""
    _, cfg, _, params = model("smollm-360m")
    out = train("smollm-360m", steps=30, batch=8, seq=64, verbose=False,
                device="cpu", params=params, grad_compress=True, lr=3e-3)
    losses = [l for _, l in out["losses"]]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:3]), losses


def test_train_requires_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train("smollm-360m", steps=1, batch=2, seq=8, verbose=False)


def test_train_cfg_depth_cut():
    """``cfg=`` trains a cut config: the state has its layer count."""
    _, cfg, _, _ = model("smollm-360m")
    cut = dataclasses.replace(cfg, n_layers=1)
    out = train("smollm-360m", steps=2, batch=2, seq=8, verbose=False,
                device="cpu", cfg=cut)
    assert out["state"]["params"]["blocks"]["ln1"].shape[0] == 1
    assert int(out["state"]["opt"].step) == 2
