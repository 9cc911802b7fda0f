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
from typing import Any, Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
SOURCES = ("paged_decode", "paged_prefill", "paged_tree_decode", "ssd_scan",
           "flash_prefill", "flash_prefill_sm90", "flash_prefill_bwd",
           "ssd_scan_bwd", "adamw", "sample_top_p")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the head widths every attention kernel (K1, K2, K3, K5) is built for
HEAD_DIMS = (32, 64, 128, 256)

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, Any] = {}
#: nvcc's report per source (ptxas registers, shared memory, spills)
build_log: Dict[str, str] = {}
#: seconds from the start of build_all to each source's nvcc finishing
build_seconds: Dict[str, float] = {}


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
        log = out_dir / f"{name}.{os.getpid()}.log"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "w") as f:
            procs.append((name, lib, tmp, log, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT)))
    pending = list(procs)
    while pending:                  # note when each one finishes
        for item in list(pending):
            if item[4].poll() is not None:
                build_seconds[item[0]] = time.perf_counter() - t0
                pending.remove(item)
        time.sleep(0.05)
    failed = []
    for name, lib, tmp, log, proc in procs:
        build_log[name] = log.read_text()
        log.unlink()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{build_log[name]}")
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


def function(name: str, fn_name: str, argtypes: Sequence) -> Any:
    """``csrc/<name>.cu``'s launcher ``fn_name`` with its argument types
    set (ctypes would otherwise pass pointers as 32-bit ints), loaded at
    first use and kept, so a launch pays no lookup."""
    key = f"{name}.{fn_name}"
    if key not in _fns:
        fn = getattr(load(name), fn_name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def dtype_code(t) -> int:
    """The launchers' dtype switch: 0 = fp32, 1 = bf16; raises otherwise."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"kernels take fp32 or bf16, got {t.dtype}")
    return codes[t.dtype]


def check_operands(kernel: str, *tensors) -> None:
    """Every operand on one CUDA device and contiguous, or raise."""
    dev = tensors[0].get_device()          # -1 on the CPU
    for t in tensors:
        if dev < 0 or t.get_device() != dev:
            raise ValueError(f"{kernel}: operands must share one CUDA "
                             f"device, got {t.device} and "
                             f"{tensors[0].device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")


def stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of ``t``'s device, for a
    launcher's last argument (the raw handle: building a
    ``torch.cuda.Stream`` object costs the host several microseconds on
    every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_paged_operands(kernel: str, q, k_pages, v_pages,
                         max_group: int) -> None:
    """q [..., H, hd] against K/V pools [kv, P, ps, hd] of q's dtype, with
    a head_dim of ``HEAD_DIMS`` and at most ``max_group`` query heads per
    KV head (what the paged attention launchers are built for), or
    raise."""
    q_heads, head_dim = q.shape[-2:]
    kv_heads, hd = k_pages.shape[0], k_pages.shape[-1]
    if k_pages.shape != v_pages.shape or hd != head_dim:
        raise ValueError(f"{kernel}: pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"{kernel}: q and the pages must share a dtype")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {head_dim} not in {HEAD_DIMS}")
    if q_heads % kv_heads or q_heads // kv_heads > max_group:
        raise ValueError(f"{kernel}: {q_heads} query heads over "
                         f"{kv_heads} KV heads")


def raise_on_error(kernel: str, rc: int) -> None:
    """The launcher returned cudaGetLastError(); non-zero means the
    launch never ran."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
