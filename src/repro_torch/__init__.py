"""PyTorch + CUDA port of the HPIPE reproduction (``src/repro/`` is the
JAX reference). Mirrors the reference's layout: ``configs``, ``core``,
``models``, ``kernels``, ``launch``. Imports ``torch``, never ``jax``,
and nothing of the reference package."""
