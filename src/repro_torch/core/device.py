"""Device choice for the port's entry points: the card unless the caller
asks for the CPU, and never a silent move from one to the other; the
CUDA-graph capture that the serving paths and the profiler share; and
the cuDNN setting the serving tier's processes share."""
from __future__ import annotations

import contextlib
import gc

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and there is no
    card, instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available: the port "
            "runs on the card; pass device='cpu' for its plain CPU path")
    return dev


@contextlib.contextmanager
def deterministic_convs():
    """In scope, make cuDNN pick one algorithm for a convolution shape in
    every process: no timing-based choice (``benchmark`` off) and only
    deterministic algorithms; the previous setting comes back on exit.
    The serving tier builds each replica (its warm-up ticks and its tick
    captures, where cuDNN chooses) under this, in process and in its
    workers, so a microbatch's logits are the same bits whichever process
    computed them (the dense convs are cuDNN's, not the port's kernels).
    A captured tick keeps the algorithm it was captured with."""
    prev = (torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = prev


@contextlib.contextmanager
def graph_capture(cuda_graph: "torch.cuda.CUDAGraph", collect: bool = True):
    """``torch.cuda.graph(cuda_graph)`` with Python's cycle collector held
    off during the capture: a collection inside it could free an earlier
    graph and its memory pool, whose ``cudaFree`` invalidates the
    capture. ``collect`` runs the collector first, so that garbage held
    in cycles is freed before the capture and not after it (the serving
    paths; the profiler's many small captures skip it: one collection
    costs more than the capture)."""
    if collect:
        gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(cuda_graph):
            yield
    finally:
        if was_enabled:
            gc.enable()
