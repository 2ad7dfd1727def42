"""Plain PyTorch references of the benchmark's configurations, one module
a model (``<model>.py``: ``layers(cfg, image_size)``, ``forward(params,
x)`` and ``kernel_calls(cfg, raw, n, image_size)``)."""
