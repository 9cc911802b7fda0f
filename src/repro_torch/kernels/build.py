"""Build the CUDA sources in ``repro_torch/csrc`` with nvcc and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain
``extern "C"`` launcher, compiled for ``sm_90a`` into
``build/repro_torch_kernels/<hash>/`` under the repository root (listed
in ``.gitignore``). The hash covers every source and the flags, so an
edited kernel is rebuilt and an unchanged one is reused. The build runs
at first use; ``build_all`` starts one nvcc per source, all at once.
Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
SOURCES = ("paged_decode", "paged_prefill")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's report per source (ptxas registers, shared memory, spills)
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_dir() -> Path:
    """The directory this checkout's sources and flags build into."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(names=SOURCES) -> float:
    """Compile every missing library in parallel; returns the seconds
    spent. Raises with nvcc's output if any source fails to build."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs: List[tuple] = []
    for name in names:
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _libs:
        lib = build_dir() / f"lib{name}.so"
        if not lib.exists():
            build_all((name,))
        _libs[name] = ctypes.CDLL(str(lib))
    return _libs[name]


def dtype_code(t) -> int:
    """The launchers' dtype switch: 0 = fp32, 1 = bf16; raises otherwise."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"kernels take fp32 or bf16, got {t.dtype}")
    return codes[t.dtype]


def check_operands(kernel: str, *tensors) -> None:
    """Every operand on one CUDA device and contiguous, or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{kernel}: operands must share one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")


def raise_on_error(kernel: str, rc: int) -> None:
    """The launcher returned cudaGetLastError(); non-zero means the
    launch never ran."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
