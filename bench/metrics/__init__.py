"""Per-layer metric readers: a metric named ``<quantity>.<suffix>`` is
read by ``metrics/<quantity>.py``, which defines ``read(ctx) -> float |
None`` (``trace.Context``) and returns None where its source holds
nothing."""
