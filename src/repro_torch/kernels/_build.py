"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``lib<name>.so`` and loaded
with ``ctypes``; every source is compiled by its own ``nvcc``, all
started together. The libraries go under ``build/kernels/<hash>/`` at
the root of the checkout (``.gitignore`` lists ``build/``), keyed by a
hash of the sources and the flags, so a changed source is rebuilt and
an unchanged one is loaded as it is.

``LAUNCHES`` counts kernel launches: each wrapper adds one where it
launches its kernel, and nowhere else, so a run can show that its
main path went through the kernels. ``VARIANT_LAUNCHES`` counts the
same launches by (kernel, variant) for the kernels with variants
(``VARIANTS``): "mma" (tensor cores), "simt" (CUDA cores) and, for
``sparse_matmul`` at M <= 8, "gemv", which the wrapper's ``variant()``
picks by dtype and shape.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: sources whose kernels nvcc optimizes on all cores (--split-compile):
#: dw_pw.cu, the longest build (57 instances), builds in about half the
#: time with every instance's registers and shared memory unchanged
#: (ptxas, on the H100); for flash_attention.cu it changed register
#: allocation (flash_attention_mma<64> spilled), so the others build as
#: they are
SPLIT_COMPILE = ("dw_pw",)
SOURCES = ("sparse_conv", "sparse_matmul", "dw_pw", "depthwise_conv",
           "flash_attention")

LAUNCHES: dict[str, int] = {name: 0 for name in SOURCES}

#: the argument that selects a variant at the C entry points
VARIANT_CODES = {"simt": 0, "mma": 1, "gemv": 2}
#: the variants of each kernel that has more than one
VARIANTS = {"sparse_conv": ("simt", "mma"),
            "sparse_matmul": ("simt", "mma", "gemv"),
            "dw_pw": ("simt", "mma"),
            "flash_attention": ("simt", "mma")}
VARIANT_LAUNCHES: dict[tuple[str, str], int] = {
    (name, v): 0 for name, vs in VARIANTS.items() for v in vs}

#: the argument that names the stored weight type at the C entry points
#: of sparse_conv, sparse_matmul and dw_pw (a template argument inside)
WEIGHT_CODES = {"bfloat16": 0, "int8": 1, "float32": 2}


def weight_code(dtype) -> int:
    """The C entry points' code for a weight tensor's torch dtype."""
    return WEIGHT_CODES[str(dtype).removeprefix("torch.")]

#: ptxas's report (registers, shared memory, spills) of the last build
BUILD_LOG: dict[str, str] = {}
#: seconds each source of the last build took (its own nvcc, in parallel)
BUILD_SECONDS: dict[str, float] = {}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for key in counts:
            counts[key] = 0


def plain_acc(t: torch.Tensor) -> torch.dtype:
    """The dtype the plain version of a hand-written kernel sums its
    products in, rounding once to f32 after: f64 on the CPU, so the sum
    is the correctly rounded one whatever order the CPU's BLAS takes
    (the bf16 products are exact and their f64 sum all but always is);
    f32 on the card, where a plain version is the check its kernel is
    held to, in the kernel's own precision."""
    return torch.float32 if t.device.type == "cuda" else torch.float64


def aligned16(t):
    """``t``, or a copy of it if its data does not start on a 16-byte
    boundary: the mma variants copy 16-byte vectors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + SPLIT_COMPILE).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all in parallel. Returns the seconds spent."""
    t0 = time.perf_counter()
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        log = out_dir / f"{name}.{os.getpid()}.log"
        split = ("--split-compile=0",) if name in SPLIT_COMPILE else ()
        cmd = [_nvcc(), *NVCC_FLAGS, *split, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen(cmd, stdout=f,
                                            stderr=subprocess.STDOUT),
                           tmp, lib, log)
    pending = set(procs)
    while pending:                        # note when each one finishes
        for name in sorted(pending):
            if procs[name][0].poll() is not None:
                BUILD_SECONDS[name] = time.perf_counter() - t0
                pending.discard(name)
        time.sleep(0.05)
    failed = []
    for name, (proc, tmp, lib, log_path) in procs.items():
        log = log_path.read_text()
        log_path.unlink()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)          # atomic: a reader never sees half a .so
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _build_dir() / f"lib{name}.so"
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by ``name``'s entry
    point, with CUDA's own text for it."""
    if err != 0:
        text = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {text} "
                           f"(cudaError_t {err})")
