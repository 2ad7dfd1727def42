"""The operations and bytes of one call of each hand-written kernel,
``work/<kernel>.py``: ``work(call) -> (ops, bytes, dtype)`` from the
call's shapes (``reference/<model>.kernel_calls``). Each input byte is
counted read once and each output byte written once, whatever the kernel
reads again; a sparse kernel counts only its stored blocks."""
