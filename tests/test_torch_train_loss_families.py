"""The LM loss (``lm.loss_fn``) and its gradients on the port against
the JAX reference on the CPU at ``reduced()`` size for the MoE, SSM and
hybrid families (the other families, and the bars with their reasons:
tests/test_torch_train_loss.py)."""
import pytest

torch = pytest.importorskip("torch")

from _torch_lm_ref import (check_loss_and_grads,  # noqa: E402
                           one_torch_thread)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b", "rwkv6-1.6b",
                                  "zamba2-7b"])
def test_loss_fn_matches_reference(arch, monkeypatch):
    check_loss_and_grads(arch, monkeypatch)
