"""Stored weight dtypes: the port's counterpart of the reference's
``core/quant.py``.

Only the list of store dtypes is here so far, for ``ServeConfig`` to
validate ``quantize`` against (reference ``core/quant.py:57``). The
quantizer itself (``QuantizedWeight``, ``quantize_tree``,
``tree_stored_bytes``) is ROADMAP Queue 1, "int8/bf16 storage"; until
then every store dtype but "native" raises ``NotImplementedError`` where
a CNN is served.
"""

#: "native" keeps each leaf's dtype; the others re-store the weights
STORE_DTYPES = ("native", "f32", "bf16", "int8")
