"""Reduces the traced slice of a window to what the metrics read.

The slice is ``torch.profiler`` over the last seconds of the window
(device activity and, on the host, only the proxy's named ranges and the
few host ops around each step). Kept in memory; no trace file is
written. The device runs one stream, so the union of its operations'
intervals is its busy time; each gap in that union is an idle gap,
named by the proxy range the host was in at the gap's middle.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Tuple

import torch

# kernel name patterns of the port's paged attention, by the kernel the
# per-layer metrics name: K1 (csrc/paged_decode*.cu*: the bf16 split-key
# core decode_mma_kernel<HD, false>, the fp32 loop) and K3
# (csrc/paged_tree_decode.cu: its shared pass, and its branch pass, which
# in bf16 is decode_mma_kernel<HD, true>)
KERNELS = {
    "k1": (r"paged_decode_kernel", r"decode_mma_kernel<\d+, ?(false|0)>"),
    "k3": (r"tree_shared", r"tree_branch_kernel",
           r"decode_mma_kernel<\d+, ?(true|1)>"),
}

# what the host was doing, by the proxy's range around the call
HOST_LABELS = {
    "bench.decode_step": "engine host part of decode_step",
    "bench.begin_prefill": "admission (begin_prefill)",
    "bench.finish_prefill": "admission (finish_prefill)",
    "bench.spawn_branch": "admission (spawn_branch)",
    "bench.free_branch": "branch release (free_branch)",
    "bench.release_prefix": "answer (release_prefix)",
}
OUTSIDE = "scheduler, PRM and bookkeeping (outside the engine)"


@dataclasses.dataclass
class TraceSummary:
    window_s: float               # the traced slice's length
    busy_s: float                 # union of device operation intervals
    device_s: Dict[str, float]    # device seconds by operation name
    idle_s: Dict[str, float]      # idle seconds by what the host was doing
    device_ops: int
    counts: Dict[str, int]        # device operations by name

    def kernel_s(self, kernel: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels ``KERNELS[kernel]``
        names, over the slice."""
        pats = [re.compile(p) for p in KERNELS[kernel]]
        s = n = 0
        for name, sec in self.device_s.items():
            if any(p.search(name) for p in pats):
                s += sec
        for name, cnt in self.counts.items():
            if any(p.search(name) for p in pats):
                n += cnt
        return s, n

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(((k, v) for k, v in self.idle_s.items() if v > 0),
                      key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(prof, window_s: float) -> TraceSummary:
    """The slice's device intervals from ``prof.events()`` (times in
    microseconds from the trace's start, host and device on one clock)."""
    cuda = torch.autograd.DeviceType.CUDA
    device: List[Tuple[float, float]] = []
    by_name: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    host: List[Tuple[float, float, str]] = []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if e.is_user_annotation:
                continue
            device.append((a, b))
            by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e6
            counts[e.name] = counts.get(e.name, 0) + 1
        elif e.name in HOST_LABELS:
            host.append((a, b, HOST_LABELS[e.name]))
    merged = _merge(device)
    busy = sum(b - a for a, b in merged) / 1e6
    idle: Dict[str, float] = {}
    host.sort()
    starts = [h[0] for h in host]
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        # the proxy's ranges follow one another on one thread
        label = host[i][2] if i >= 0 and host[i][1] >= mid else OUTSIDE
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return TraceSummary(window_s, busy, by_name, idle, len(device), counts)
