"""The port's dry-run (``repro_torch.launch.dryrun``) on a fake process
group of 256 ranks, the production ``(16 data, 16 model)`` mesh, under
``FakeTensorMode``: qwen2-0.5b x ``train_4k`` and x ``decode_32k`` (2
kv heads over 16: a sequence-sharded cache), and stablelm-1.6b x
``long_500k`` (adapted to the 8,192 window, batch 1: the sequence over
both axes), each at full width with its depth cut to 2 layers (the full
depths trace in minutes; ``--all`` runs them). One subprocess runs the
three combos, with its own timeout. Each record has the reference's
keys; its argument bytes are the sum of the local shards' bytes the
specs give; its FLOPs per device lie within the band a step's FLOPs
from the config allow."""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
COMBOS = [("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k"),
          ("stablelm-1.6b", "long_500k")]
LAYERS = 2

# the keys of the reference's record (repro/launch/dryrun.py:run_one)
REF_KEYS = {"arch", "shape", "mesh", "param_mode", "moe_dp", "tag",
            "mesh_shape", "num_devices", "kind", "seq_len", "global_batch",
            "params_total", "params_active", "sliding_window_adapted",
            "flops_per_device", "bytes_per_device", "transcendentals",
            "extrapolated", "memory", "collectives", "lower_s", "compile_s"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_bytes"}
COLL_KEYS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute", "total_bytes", "total_count"}
EXTRAP_KEYS = {"flops", "bytes", "transcendentals", "coll_all-reduce",
               "coll_all-gather", "coll_reduce-scatter", "coll_all-to-all",
               "coll_collective-permute", "coll_total", "per_layer_flops",
               "ok"}

_SCRIPT = r'''
import json, sys
sys.modules["jax"] = None
import torch
from torch.utils._pytree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import local_bytes, mesh_axis_sizes
from repro_torch.launch.dryrun import run_one
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES
from repro_torch.launch.steps import build_step

out = {}
for arch, shape in json.loads(sys.argv[1]):
    rec = run_one(arch, shape, "single", out_dir=sys.argv[2],
                  num_layers=int(sys.argv[3]))
    mesh = make_production_mesh(device_type="cpu")
    cfg = get_config(arch).replace(num_layers=int(sys.argv[3]))
    step, args = build_step(cfg, SHAPES[shape], mesh)
    sizes = mesh_axis_sizes(mesh)

    def spec_bytes(arg, spec):
        if spec is None or not isinstance(arg, dict):
            if isinstance(arg, torch.Tensor):
                return local_bytes(arg.shape, arg.element_size(), spec or (),
                                   sizes)
            return 0
        return sum(spec_bytes(arg[k], spec.get(k)) for k in arg)
    rec["want_argument_bytes"] = sum(
        spec_bytes(a, s) for a, s in zip(args, step.in_specs))
    # the matrix products' params: the layers' >= 3-d leaves, and the head
    pshape = args[0]
    layers = sum(t.numel() for t in tree_leaves(pshape["layers"])
                 if t.dim() >= 3)
    emb = pshape["embed"]
    rec["mm_params"] = [layers, emb.get("lm_head", emb["embedding"]).numel()]
    out[f"{arch}/{shape}"] = rec
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _SCRIPT, json.dumps(COMBOS),
                        str(tmp), str(LAYERS)], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = json.loads(r.stdout.strip().splitlines()[-1])
    for arch, shape in COMBOS:      # and each record was written
        with open(tmp / f"{arch}__{shape}__single.json") as f:
            assert json.load(f)["flops_per_device"] == \
                recs[f"{arch}/{shape}"]["flops_per_device"]
    return recs


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_record_has_the_reference_keys(records, arch, shape):
    rec = records[f"{arch}/{shape}"]
    assert REF_KEYS <= set(rec)
    assert set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["collectives"]) == COLL_KEYS
    assert set(rec["extrapolated"]) == EXTRAP_KEYS
    assert rec["extrapolated"]["ok"] is True
    assert rec["num_devices"] == 256 and rec["mesh_shape"] == [16, 16]
    assert rec["num_layers"] == LAYERS
    assert rec["sliding_window_adapted"] == (shape == "long_500k")


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_argument_bytes_are_the_local_shards(records, arch, shape):
    """Per-device argument bytes equal the sum of the local shards' bytes
    that the step's specs give, and the peak holds them."""
    rec = records[f"{arch}/{shape}"]
    assert rec["memory"]["argument_bytes"] == rec["want_argument_bytes"]
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]


def _step_flops(rec) -> float:
    """A step's FLOPs from the config: 2 per param of the matrix products
    per token forward (6 with the backward, plus the layers' recompute in
    training), plus attention's 4 x head_dim x heads per (query, key)
    pair within the window (x 4.5 in training: the forward twice and the
    backward)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES, adapt_config
    shape = SHAPES[rec["shape"]]
    cfg = adapt_config(get_config(rec["arch"]), shape).replace(
        num_layers=rec["num_layers"])
    layers, head = rec["mm_params"]
    b, s = shape.global_batch, shape.seq_len
    window = cfg.sliding_window or s
    per_pair = 4 * cfg.resolved_head_dim * cfg.num_heads * cfg.num_layers
    if shape.kind == "train":
        w = min(window, s)      # sum over i < s of min(i + 1, window)
        pairs = (w * (w + 1) // 2 + (s - w) * w) * b
        return (6 * (layers + head) + 2 * layers) * b * s + 4.5 * per_pair \
            * pairs
    return 2 * (layers + head) * b + per_pair * min(s, window) * b


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_flops_within_the_config_band(records, arch, shape):
    """flops_per_device x 256 lies between the step's FLOPs (every device
    doing only its share) and 1.5 x 16 x them (the most a device does
    when a dim that the "model" axis cannot divide is replicated over
    it, with slack for the plain attention's masked blocks); the
    L=1/L=2 extrapolation agrees with the full trace within 1%."""
    rec = records[f"{arch}/{shape}"]
    want = _step_flops(rec)
    total = rec["flops_per_device"] * rec["num_devices"]
    assert want <= total * 1.01 and total <= 1.5 * 16 * want, (total, want)
    ex = rec["extrapolated"]["flops"]
    assert abs(ex - rec["flops_per_device"]) <= 0.01 * ex
