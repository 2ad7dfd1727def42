"""The LM loss (``lm.loss_fn``) and its gradients on the port against
the JAX reference on the CPU at ``reduced()`` size (B 2, T 16, remat
"none"), on the reference's weights carried across bit for bit
(``tests/_torch_lm_ref.py::check_loss_and_grads``): the dense LMs, the
VLM and the encoder-decoder family here, the MoE, SSM and hybrid
families in tests/test_torch_train_loss_families.py (two files, so each
runs in about a minute in one process).

Bars.
- The loss within LOSS_RTOL (1e-4) relative of the reference's loss run
  op by op (``jax.disable_jit``, as the port runs) with its attention as
  its Pallas flash kernel computes it (``attention_as_pallas``: p in
  f32, as the port's kernel). Measured: 0 to 2.8e-6. The reference's
  XLA attention twin rounds p to bf16 and parts the loss from the port's
  by up to 1.3e-4 (granite-20b); its jitted program keeps f32 across ops
  that, run alone, round to bf16, by up to 2.3e-4 (zamba2).
- Each floating leaf's gradient within GRAD_RTOL (5e-2) relative L2 of
  the jitted reference's (its own attention). Measured worst: 3.0e-2
  (zamba2's ``A_log``), 1.6e-2 rwkv6, 1.5e-2 moonshot, 1.2e-2
  granite-moe, 0.7-1.0e-2 the dense LMs; against the reference run op by
  op rwkv6 (no flash, no pruned FFN) is 8e-6 and zamba2 1.4e-2: the
  jitted program's f32 fusions, the bf16 p, and bf16 gradients rounded
  at other ops.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_lm_ref import (check_loss_and_grads,  # noqa: E402
                           one_torch_thread)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-32b",
                                  "mistral-nemo-12b", "granite-20b",
                                  "llava-next-mistral-7b",
                                  "whisper-large-v3"])
def test_loss_fn_matches_reference(arch, monkeypatch):
    check_loss_and_grads(arch, monkeypatch)
