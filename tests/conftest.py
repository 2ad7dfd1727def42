import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "procfault: multi-process serving-tier fault tests (spawn real "
        "worker interpreters, send real SIGKILL/SIGSTOP; run on CI's "
        "process-fault leg, deselect elsewhere with -m 'not procfault')")
    config.addinivalue_line(
        "markers",
        "netfault: cross-host serving-tier network-fault tests (spawn "
        "real worker interpreters dialing in over localhost TCP, inject "
        "drops/partitions/bit-flips through a frame-aware proxy; run on "
        "CI's network-fault leg, deselect elsewhere with "
        "-m 'not netfault')")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the port's CUDA kernels); "
        "skips without one. On the card: python -m pytest -m cuda "
        "tests/test_torch_cuda.py")
