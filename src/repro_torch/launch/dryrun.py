"""Multi-pod dry-run: trace every (arch x shape x mesh) step on a fake
process group of 256 or 512 ranks under ``FakeTensorMode``.

Counterpart of ``repro.launch.dryrun``. Shows the distribution layer is
coherent without the hardware: every op of the sharded step must find a
DTensor sharding strategy (or run under ``local_map``) on the production
meshes, and a failure surfaces as an exception. Nothing is allocated: the
params, optimizer state, batch and cache are fake tensors, and rank 0's
local shards are what a device would hold. Per combo it records, from
rank 0's local ops:

  * ``flops_per_device``: the FLOPs of every local op that
    ``torch.utils.flop_counter`` has a formula for (matmuls, attention
    products);
  * ``bytes_per_device``: the bytes of every local op's tensor inputs and
    outputs (the counterpart of XLA's "bytes accessed": an upper bound,
    no fusion);
  * ``transcendentals``: the elements of every exp/log/tanh/... output;
  * collectives by kind: count and bytes of the outputs of the
    ``_c10d_functional`` ops DTensor emits (all-gather's output is the
    gathered tensor, as in an HLO shape);
  * memory: ``argument_bytes`` the local shards of the step's inputs,
    ``peak_bytes`` the peak that ``torch.distributed._tools.mem_tracker``
    sees under fake mode (arguments included), ``output_bytes`` the local
    outputs; ``temp_bytes`` the peak less the arguments; ``alias_bytes``
    0 (nothing is donated).

into ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``. The
step runs twice: the first run fills DTensor's sharding-propagation
caches (on a miss DTensor runs each op once more at its global shapes to
learn the output's), the second is the one counted.

These are torch's counters, not XLA's: DTensor chooses its collectives
op by op where GSPMD plans a whole program, and the two packages'
numbers are not compared. ``extrapolated`` keeps the reference's L=1/L=2
method and keys (the port's layer loop is unrolled, so it should agree
with the full trace). ``lower_s`` is the time to build and shard the
step, ``compile_s`` the two traced runs (there is no compile step).

Importing this module sets no environment variable and makes no process
group; ``run_one`` makes the fake group it needs.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_C10D_KINDS = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2",
                   "log_softmax", "_log_softmax", "softmax", "_softmax",
                   "tanh", "sigmoid", "sin", "cos", "rsqrt", "sqrt", "pow",
                   "softplus", "silu", "gelu", "erf"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class StepCounter(TorchDispatchMode):
    """Counts the local ops of a DTensor program: a call with a DTensor
    argument is handed back to DTensor (``NotImplemented``), whose local
    ops then come through here."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.collectives = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self._flops:
            self.flops += self._flops[packet](*args, **kwargs, out_val=out)
        ns, name = func.namespace, packet.__name__
        if ns == "_c10d_functional" and name in _C10D_KINDS:
            rec = self.collectives[_C10D_KINDS[name]]
            rec["count"] += 1
            rec["bytes"] += _nbytes(out)
        elif ns == "aten":
            flat_in = [a for a in torch.utils._pytree.tree_leaves(
                (args, kwargs)) if isinstance(a, torch.Tensor)]
            flat_out = [a for a in torch.utils._pytree.tree_leaves(out)
                        if isinstance(a, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in flat_in + flat_out)
            if name.rstrip("_") in _TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in flat_out)
        return out

    def measure(self) -> dict:
        out = {"flops": self.flops, "bytes": self.bytes,
               "transcendentals": self.transcendentals}
        for kind in _COLLECTIVES:
            out[f"coll_{kind}"] = float(self.collectives[kind]["bytes"])
        out["coll_total"] = float(sum(v["bytes"] for v in
                                      self.collectives.values()))
        return out

    def collective_record(self) -> dict:
        out = {k: dict(v) for k, v in self.collectives.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        out["total_count"] = sum(v["count"] for v in self.collectives.values())
        return out


def parse_collectives(counter: StepCounter) -> dict:
    """Per-kind counts and bytes of the collectives a counted run made
    (the counterpart of the reference's HLO parse)."""
    return counter.collective_record()


def fake_process_group(world_size: int) -> None:
    """Make the default process group a ``"fake"`` one of
    ``world_size`` ranks (this process is rank 0), replacing one of
    another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size \
                and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _trace(step, example_args) -> dict:
    """Build fake inputs of the example shapes, shard them, run the step
    twice (warm, then counted). Returns the counter, the memory record and
    the times."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    t0 = time.time()
    with FakeTensorMode():
        fake = tree_map_only(
            torch.Tensor, lambda m: torch.zeros(m.shape, dtype=m.dtype),
            example_args)
        sharded = step.shard(*fake)
        t_shard = time.time() - t0
        fn = step.fn.body if step.kind == "train" else step.fn
        with torch.no_grad() if step.kind != "train" else \
                torch.enable_grad():
            fn(*sharded)                              # warm the caches
            counter = StepCounter()
            tracker = MemTracker()
            tracker.track_external(*[t for t in torch.utils._pytree
                                     .tree_leaves(sharded)
                                     if isinstance(t, torch.Tensor)])
            with tracker, counter:
                out = fn(*sharded)
        peak = tracker.get_tracker_snapshot("peak")
        peak_bytes = max((v["Total"] for v in peak.values()), default=0)
        memory = {"argument_bytes": _local_bytes(sharded),
                  "output_bytes": _local_bytes(out),
                  "alias_bytes": 0, "peak_bytes": int(peak_bytes)}
        memory["temp_bytes"] = max(0, memory["peak_bytes"]
                                   - memory["argument_bytes"])
    return {"counter": counter, "memory": memory, "shard_s": t_shard,
            "run_s": time.time() - t0 - t_shard}


def run_one(arch: str, shape_name: str, mesh_kind: str,
            param_mode: str = "2d", tag: str = "", moe_dp: int = 0,
            out_dir: str = OUT_DIR, num_layers: int = 0) -> dict:
    """Trace one combo and write its record. ``num_layers`` > 0 cuts the
    config's depth (full width; the record's ``num_layers`` says so)."""
    from ..configs import get_config
    from .mesh import make_production_mesh
    from .shapes import SHAPES, adapt_config
    from .steps import build_step

    t0 = time.time()
    cfg = get_config(arch)
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    shape = SHAPES[shape_name]
    multi = mesh_kind == "multi"
    fake_process_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    step, example_args = build_step(cfg, shape, mesh, param_mode=param_mode,
                                    moe_dp=moe_dp)
    t_build = time.time() - t0
    traced = _trace(step, example_args)
    counter = traced["counter"]

    extrap: Dict[str, object] = {}
    try:
        m = {}
        for n_layers in (1, 2):
            if n_layers == cfg.num_layers:      # the full trace is it
                m[n_layers] = counter.measure()
                continue
            st, args = build_step(cfg.replace(num_layers=n_layers), shape,
                                  mesh, param_mode=param_mode,
                                  moe_dp=moe_dp)
            m[n_layers] = _trace(st, args)["counter"].measure()
        layers = cfg.num_layers
        for key in m[1]:
            extrap[key] = m[1][key] + (layers - 1) * (m[2][key] - m[1][key])
        extrap["per_layer_flops"] = m[2]["flops"] - m[1]["flops"]
        extrap["ok"] = True
    except Exception as e:  # keep the full trace even if analysis fails
        extrap = {"ok": False, "error": f"{type(e).__name__}: {e}"}

    acfg = adapt_config(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "param_mode": param_mode, "moe_dp": moe_dp, "tag": tag,
        "mesh_shape": list(mesh.shape), "num_devices": int(mesh.size()),
        "kind": shape.kind, "seq_len": shape.seq_len,
        "num_layers": cfg.num_layers,
        "global_batch": shape.global_batch,
        "params_total": acfg.param_count(),
        "params_active": acfg.active_param_count(),
        "sliding_window_adapted": bool(
            acfg.sliding_window and not cfg.sliding_window),
        "flops_per_device": counter.flops,
        "bytes_per_device": counter.bytes,
        "transcendentals": counter.transcendentals,
        "extrapolated": extrap,
        "memory": traced["memory"],
        "collectives": parse_collectives(counter),
        "lower_s": round(t_build + traced["shard_s"], 2),
        "compile_s": round(traced["run_s"], 2),
        "counters": "torch (FakeTensorMode, DTensor local ops, rank 0)",
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[
        None, "train_4k", "prefill_32k", "decode_32k", "long_500k"])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="every assigned arch x shape")
    ap.add_argument("--subprocess", action="store_true",
                    help="isolate each combo in a fresh process")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--param-mode", default="2d", choices=["2d", "tp"])
    ap.add_argument("--moe-dp", type=int, default=0)
    ap.add_argument("--tag", default="",
                    help="suffix for the output json (perf variants)")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut every config's depth to this (0: keep it)")
    args = ap.parse_args()

    from ..configs import ASSIGNED
    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = (["train_4k", "prefill_32k", "decode_32k", "long_500k"]
              if (args.all or args.shape is None) else [args.shape])
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                tag = f"{arch} x {shape} x {mesh}"
                out = os.path.join(args.out_dir,
                                   f"{arch}__{shape}__{mesh}.json")
                if args.skip_existing and os.path.exists(out):
                    print(f"[skip] {tag}", flush=True)
                    continue
                if args.subprocess:
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape, "--mesh", mesh,
                           "--param-mode", args.param_mode, "--moe-dp",
                           str(args.moe_dp), "--out-dir", args.out_dir,
                           "--layers", str(args.layers)]
                    r = subprocess.run(cmd, capture_output=True, text=True)
                    ok = r.returncode == 0
                    tail = (r.stdout + r.stderr).strip().splitlines()
                    print(f"[{'ok' if ok else 'FAIL'}] {tag}"
                          + ("" if ok else f"  {tail[-1] if tail else ''}"),
                          flush=True)
                    if not ok:
                        failures.append(tag)
                    continue
                try:
                    rec = run_one(arch, shape, mesh,
                                  param_mode=args.param_mode, tag=args.tag,
                                  moe_dp=args.moe_dp, out_dir=args.out_dir,
                                  num_layers=args.layers)
                    print(f"[ok] {tag}: "
                          f"flops/dev={rec['flops_per_device']:.3e} "
                          f"coll={rec['collectives']['total_bytes']:.3e}B "
                          f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}"
                          f"GiB trace={rec['compile_s']}s", flush=True)
                except Exception:
                    traceback.print_exc()
                    failures.append(tag)
                    print(f"[FAIL] {tag}", flush=True)
    if failures:
        print(f"{len(failures)} FAILURES: {failures}", flush=True)
        sys.exit(1)
    print("dry-run: all combinations traced", flush=True)


if __name__ == "__main__":
    main()
