"""The port's sharded steps on 8 gloo ranks, a (2 data x 4 model) mesh.

Counterpart of ``tests/test_distributed_exec.py``. The parent process
writes the JAX package's weights and the inputs to an ``.npz``; one
subprocess (its own timeout) imports the port once and forks 8 CPU
ranks (``torch.distributed``, gloo, one thread each), which import no jax
and run on the port's DTensor params (``distributed/sharding.py`` specs,
``activation_rules`` of ``standard_rules``):

  * the sharded forward of the reference test's five archs;
  * one sharded train step (``launch/steps.py:build_step``, qwen2-0.5b
    smoke, and dbrx smoke with ``moe_dp=2``), its loss vocab-parallel;
  * the sharded prefill (22 tokens into a 32-slot cache) and 4 serve
    steps of qwen2-0.5b smoke (1 kv head: a sequence-sharded cache of 8
    slots a rank, the steps' slots crossing from one rank's slab to the
    next, partials merged across "model") and of mamba2-130m smoke.

Rank 0 writes the gathered results; every rank writes a checksum of
each. While the ranks run, the parent computes the references once on
the same weights and inputs: the JAX package's single-device forward,
train step (under ``activation_rules(None, {"_moe_dp": G})``, so dbrx's
shard-local dispatch meets the reference's), prefill and serve steps;
and, as the tighter second check, the port's unsharded train step (the
same ``_moe_dp`` rules on plain tensors) and ``Model`` prefill and decode
calls. Each test compares its part.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke
from repro.distributed.logical import activation_rules as jax_rules
from repro.models import Model as JModel
from repro.training import optimizer as jax_opt
from repro.training.checkpoint import _flatten
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch.configs import smoke as tsmoke
from repro_torch.distributed.logical import activation_rules
from repro_torch.models import Model, params_from_numpy
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_loop import make_train_step

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ["qwen2-0.5b", "mamba2-130m", "dbrx-132b", "hymba-1.5b",
         "musicgen-medium"]
TRAIN = [("qwen2-0.5b", 0), ("dbrx-132b", 2)]
SERVE = ["qwen2-0.5b", "mamba2-130m"]
WORLD = 8
B, S = 4, 32                 # batch and length of every input
SMAX, S0, N_DECODE = 32, 22, 4
OPT = dict(warmup_steps=1, lr=1e-2, eps=1e-3)

_RANKS = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.modules["jax"] = None          # the ranks import no jax
sys.modules["repro"] = None
from repro_torch.configs import smoke
from repro_torch.distributed.logical import activation_rules, standard_rules
from repro_torch.distributed.sharding import (P, distribute_params, full_tree,
                                              param_pspecs, sanitize_pspecs)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.launch.steps import build_step
from repro_torch.models import Model, params_from_numpy
from repro_torch.models import model as model_mod
from repro_torch.training.optimizer import AdamWConfig, init_opt_state

CFG = json.loads(sys.argv[3])
# the local logits' shapes that the vocab-parallel loss was given
NLL_CALLS = []
_nll_forward = model_mod._VocabParallelNLL.forward


def _counted_nll(ctx, logits, *args):
    NLL_CALLS.append(list(logits.shape))
    return _nll_forward(ctx, logits, *args)


model_mod._VocabParallelNLL.forward = staticmethod(_counted_nll)


def _tree(data, prefix):
    flat = {k[len(prefix):]: data[k] for k in data.files
            if k.startswith(prefix)}
    return params_from_numpy(flat, device="cpu")


def _flat(tree, prefix):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tree[k].detach().float().numpy()
    return out


def worker(rank, npz, out, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=CFG["world"])
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    data = np.load(npz)
    res, meta = {}, {"world": dist.get_world_size(), "mesh": list(mesh.shape)}
    b, s = CFG["batch"], CFG["seq"]
    # 1. the sharded forward
    for arch in CFG["archs"]:
        cfg = smoke(arch).replace(vocab_size=512)
        params = _tree(data, f"{arch}/param/")
        sp = distribute_params(params, mesh, sanitize_pspecs(
            param_pspecs(params), params, mesh))
        kw = ({"embeds": torch.from_numpy(data[f"{arch}/embeds"])}
              if cfg.multimodal else
              {"tokens": torch.from_numpy(data[f"{arch}/tokens"]).long()})
        kw = distribute_params(kw, mesh, {k: P(("data",)) for k in kw})
        with activation_rules(mesh, standard_rules(("data",))):
            logits, _ = Model(cfg, device="cpu").forward(sp, **kw)
        res[f"fwd/{arch}"] = logits.full_tensor().numpy()
    # 2. one sharded train step
    for arch, moe_dp in CFG["train"]:
        cfg = smoke(arch).replace(vocab_size=512)
        batch = {"tokens": torch.from_numpy(data[f"{arch}/tokens"]).long(),
                 "labels": torch.from_numpy(data[f"{arch}/labels"]).long(),
                 "mask": torch.from_numpy(data[f"{arch}/mask"])}
        step, _ = build_step(cfg, ShapeSpec("t", s, b, "train"), mesh,
                             dtype=torch.float32, moe_dp=moe_dp,
                             opt_cfg=AdamWConfig(**CFG["opt"]))
        params = _tree(data, f"{arch}/param/")
        sp, state, sb = step.shard(params, init_opt_state(params), batch)
        _, state, m = step(sp, state, sb)
        for k, v in m.items():
            res[f"train/{arch}/{k}"] = np.asarray(float(v))
        res.update(_flat(full_tree(sp), f"train/{arch}/param/"))
        res.update(_flat(full_tree(state["mu"]), f"train/{arch}/mu/"))
    meta["nll_local_shapes"] = NLL_CALLS
    # 3. the sharded prefill and serve steps
    s0, smax = CFG["s0"], CFG["smax"]
    for arch in CFG["serve"]:
        cfg = smoke(arch).replace(vocab_size=512)
        toks = torch.from_numpy(data[f"{arch}/tokens"]).long()
        pre, _ = build_step(cfg, ShapeSpec("p", smax, b, "prefill"), mesh,
                            dtype=torch.float32)
        dec, _ = build_step(cfg, ShapeSpec("d", smax, b, "decode"), mesh,
                            dtype=torch.float32)
        sp, batch = pre.shard(_tree(data, f"{arch}/param/"),
                              {"tokens": toks[:, :s0]})
        logits, cache = pre(sp, batch)
        res[f"serve/{arch}/logits0"] = logits.full_tensor().numpy()
        for k, v in cache.items():
            res[f"serve/{arch}/cache0/{k}"] = v.full_tensor().numpy()
        meta[f"serve/{arch}/placements"] = {
            k: str(tuple(v.placements)) for k, v in cache.items()}
        for i in range(CFG["decode"]):
            pos = torch.full((b,), s0 + i, dtype=torch.long)
            _, _, tok, pos = dec.shard(None, None, toks[:, s0 + i], pos)
            logits, cache, _ = dec(sp, cache, tok, pos)
            res[f"serve/{arch}/logits{i + 1}"] = logits.full_tensor().numpy()
        for k, v in cache.items():
            res[f"serve/{arch}/cache/{k}"] = v.full_tensor().numpy()
    meta["checksums"] = {k: float(np.abs(v).astype(np.float64).sum())
                         for k, v in res.items()}
    with open(f"{out}.{rank}", "w") as f:
        json.dump(meta, f)
    if rank == 0:
        np.savez(f"{out}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import socket
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    # the port is imported once here; the ranks fork from this process
    mp.start_processes(worker, args=(sys.argv[1], sys.argv[2], port),
                       nprocs=CFG["world"], start_method="fork")
'''


def _inputs(path):
    """Each arch's JAX weights and inputs, written for the ranks; returns
    the JAX models and params (for the references)."""
    out, jobs = {}, {}
    for arch in ARCHS:
        cfg = smoke(arch).replace(vocab_size=512)
        model = JModel(cfg)
        params = model.init_params(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        embeds = (rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
                  if cfg.multimodal else None)
        jobs[arch] = (model, params, toks, embeds)
        for k, v in _flatten(params).items():
            out[f"{arch}/param/{k}"] = np.asarray(v, np.float32)
        out[f"{arch}/tokens"] = toks
        if embeds is not None:
            out[f"{arch}/embeds"] = embeds
        out[f"{arch}/labels"] = rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        out[f"{arch}/mask"] = (rng.random((B, S)) < 0.9).astype(np.float32)
    np.savez(path, **out)
    return out, jobs


def _port_params(data, arch):
    prefix = f"{arch}/param/"
    return params_from_numpy({k[len(prefix):]: v for k, v in data.items()
                              if k.startswith(prefix)}, device="cpu")


def _flat(tree, prefix):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tree[k].detach().float().numpy()
    return out


def _jax_references(data, jobs):
    """The JAX package's forward logits, one train step, and the prefill
    and serve steps, keyed as the ranks' results under ``jax/``."""
    ref = {}
    for arch, (model, params, toks, embeds) in jobs.items():
        logits, _ = model.forward(
            params, tokens=None if embeds is not None else jnp.asarray(toks),
            embeds=None if embeds is None else jnp.asarray(embeds))
        ref[f"fwd/{arch}"] = np.asarray(logits, np.float32)
    for arch, moe_dp in TRAIN:
        model, params = jobs[arch][:2]
        batch = {k: jnp.asarray(data[f"{arch}/{k}"])
                 for k in ("tokens", "labels", "mask")}
        step = jax_train_step(model, jax_opt.AdamWConfig(**OPT))
        with jax_rules(None, {"_moe_dp": moe_dp}):
            new, state, m = jax.jit(step)(
                params, jax_opt.init_opt_state(params), batch)
        for k, v in m.items():
            ref[f"jax/train/{arch}/{k}"] = np.asarray(float(v))
        for k, v in _flatten(new).items():
            ref[f"jax/train/{arch}/param/{k}"] = np.asarray(v, np.float32)
        for k, v in _flatten(state["mu"]).items():
            ref[f"jax/train/{arch}/mu/{k}"] = np.asarray(v, np.float32)
    for arch in SERVE:
        model, params = jobs[arch][:2]
        toks = jnp.asarray(data[f"{arch}/tokens"])
        logits, cache = jax.jit(model.prefill, static_argnames="max_len")(
            params, tokens=toks[:, :S0], max_len=SMAX)
        ref[f"jax/serve/{arch}/logits0"] = np.asarray(logits, np.float32)
        for k, v in cache.items():
            ref[f"jax/serve/{arch}/cache0/{k}"] = np.asarray(v, np.float32)
        decode = jax.jit(model.decode_step)
        for i in range(N_DECODE):
            pos = jnp.full((B,), S0 + i, jnp.int32)
            logits, cache, _ = decode(params, toks[:, S0 + i], cache, pos)
            ref[f"jax/serve/{arch}/logits{i + 1}"] = np.asarray(
                logits, np.float32)
        for k, v in cache.items():
            ref[f"jax/serve/{arch}/cache/{k}"] = np.asarray(v, np.float32)
    return ref


def _references(data, jobs):
    """The JAX package's references (``_jax_references``), and the port's
    unsharded train step and prefill/decode calls on the same weights and
    inputs."""
    ref = _jax_references(data, jobs)
    for arch, moe_dp in TRAIN:
        cfg = tsmoke(arch).replace(vocab_size=512)
        params = _port_params(data, arch)
        state = init_opt_state(params)
        step = make_train_step(Model(cfg, device="cpu"), AdamWConfig(**OPT))
        batch = {"tokens": torch.from_numpy(data[f"{arch}/tokens"]).long(),
                 "labels": torch.from_numpy(data[f"{arch}/labels"]).long(),
                 "mask": torch.from_numpy(data[f"{arch}/mask"])}
        with activation_rules(None, {"_moe_dp": moe_dp}):
            _, _, m = step(params, state, batch)
        for k, v in m.items():
            ref[f"train/{arch}/{k}"] = np.asarray(float(v))
        ref.update(_flat(params, f"train/{arch}/param/"))
        ref.update(_flat(state["mu"], f"train/{arch}/mu/"))
    for arch in SERVE:
        cfg = tsmoke(arch).replace(vocab_size=512)
        model, params = Model(cfg, device="cpu"), _port_params(data, arch)
        toks = torch.from_numpy(data[f"{arch}/tokens"]).long()
        logits, cache = model.prefill(params, tokens=toks[:, :S0],
                                      max_len=SMAX)
        ref[f"serve/{arch}/logits0"] = logits.numpy()
        for k, v in cache.items():
            ref[f"serve/{arch}/cache0/{k}"] = v.clone().numpy()
        for i in range(N_DECODE):
            pos = torch.full((B,), S0 + i, dtype=torch.long)
            logits, cache, _ = model.decode_step(params, toks[:, S0 + i],
                                                 cache, pos)
            ref[f"serve/{arch}/logits{i + 1}"] = logits.numpy()
        for k, v in cache.items():
            ref[f"serve/{arch}/cache/{k}"] = v.numpy()
    return ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(rank 0's gathered results, every rank's record, the references,
    the inputs). The subprocess has its own timeout."""
    tmp = tmp_path_factory.mktemp("dist")
    npz, script, out = tmp / "in.npz", tmp / "ranks.py", tmp / "out"
    data, jobs = _inputs(npz)
    script.write_text(_RANKS)
    cfg = {"world": WORLD, "batch": B, "seq": S, "archs": ARCHS,
           "train": TRAIN, "serve": SERVE, "s0": S0, "smax": SMAX,
           "decode": N_DECODE, "opt": OPT}
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(script), str(npz), str(out), json.dumps(cfg)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ref = _references(data, jobs)
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    res = dict(np.load(f"{out}.npz"))
    recs = []
    for rank in range(WORLD):
        with open(f"{out}.{rank}") as f:
            recs.append(json.load(f))
    return res, recs, ref, data


def _err(res, ref, prefix, ref_prefix=None):
    """The largest gap between ``res[prefix...]`` and ``ref[ref_prefix...]``
    (``ref_prefix`` defaults to ``prefix``) over every key of ``ref``."""
    ref_prefix = ref_prefix or prefix
    keys = [k[len(ref_prefix):] for k in ref if k.startswith(ref_prefix)]
    assert keys and all(prefix + k in res for k in keys), prefix
    return max(float(np.abs(res[prefix + k] - ref[ref_prefix + k]).max())
               for k in keys)


def test_eight_ranks_agree_on_a_2x4_mesh(ranks):
    """8 ranks on a (2, 4) mesh; every rank gathered the same results."""
    res, recs, _, _ = ranks
    assert len(recs) == WORLD
    assert all(r["world"] == WORLD and r["mesh"] == [2, 4] for r in recs)
    assert set(recs[0]["checksums"]) == set(res)
    for r in recs[1:]:
        assert r["checksums"] == recs[0]["checksums"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_matches_jax(ranks, arch):
    """The gathered logits within the reference test's tolerance of the
    JAX package's single-device logits."""
    res, _, ref, _ = ranks
    err = _err(res, ref, f"fwd/{arch}")
    scale = float(np.abs(ref[f"fwd/{arch}"]).max())
    assert err <= max(2e-3 * max(scale, 1.0), 2e-3), (err, scale)


def test_sharded_loss_stays_vocab_parallel(ranks):
    """Each train step's loss ran vocab-parallel on every rank: the local
    logits of its 2-row batch shard and a quarter of the 512-way vocab."""
    _, recs, _, _ = ranks
    want = [[B // 2, S, 512 // 4]] * len(TRAIN)
    assert all(r["nll_local_shapes"] == want for r in recs)


@pytest.mark.parametrize("arch", [a for a, _ in TRAIN])
def test_sharded_train_step_matches_unsharded(ranks, arch):
    """One train step (AdamW lr 1e-2, eps 1e-3, no warmup): loss, aux loss
    and grad norm within rtol 1e-6, every param after the update within
    atol 2e-6 of the unsharded step's (the update itself moved them by
    more than 1e-3), mu within 1e-5 of its scale."""
    res, _, ref, data = ranks
    for key in ("loss", "aux_loss", "grad_norm"):
        a, b = float(res[f"train/{arch}/{key}"]), \
            float(ref[f"train/{arch}/{key}"])
        assert abs(a - b) <= 1e-6 * max(abs(b), 1e-6), (key, a, b)
    prefix = f"train/{arch}/param/"
    assert _err(res, ref, prefix) <= 2e-6
    moved = max(float(np.abs(ref[k] - data[k[len("train/"):]]).max())
                for k in ref if k.startswith(prefix))
    assert moved > 1e-3
    mu = f"train/{arch}/mu/"
    scale = max(float(np.abs(ref[k]).max()) for k in ref if k.startswith(mu))
    assert _err(res, ref, mu) <= 1e-5 * scale


@pytest.mark.parametrize("arch", SERVE)
def test_sharded_prefill_and_decode_match_unsharded(ranks, arch):
    """The prefill step's logits and cache, then 4 serve steps' logits and
    the final cache, within atol 2e-5 of the unsharded calls; the
    qwen2-0.5b cache's sequence is sharded over "model", the mamba2
    states' conv channels and head_dim."""
    res, recs, ref, _ = ranks
    assert _err(res, ref, f"serve/{arch}/logits") <= 2e-5
    assert _err(res, ref, f"serve/{arch}/cache0/") <= 2e-5
    assert _err(res, ref, f"serve/{arch}/cache/") <= 2e-5
    want = {"qwen2-0.5b": {"k": "(Shard(dim=1), Shard(dim=2))",
                           "v": "(Shard(dim=1), Shard(dim=2))"},
            "mamba2-130m": {"conv": "(Shard(dim=1), Shard(dim=3))",
                            "ssd": "(Shard(dim=1), Shard(dim=3))"}}[arch]
    assert recs[0][f"serve/{arch}/placements"] == want


@pytest.mark.parametrize("arch", [a for a, _ in TRAIN])
def test_sharded_train_step_matches_jax(ranks, arch):
    """The same train step against the JAX package's jitted step (dbrx's
    under ``_moe_dp`` 2 in both), at the unsharded check's tolerances:
    loss, aux loss and grad norm within rtol 1e-6, every param after the
    update within atol 2e-6, mu within 1e-5 of its scale."""
    res, _, ref, _ = ranks
    for key in ("loss", "aux_loss", "grad_norm"):
        a, b = float(res[f"train/{arch}/{key}"]), \
            float(ref[f"jax/train/{arch}/{key}"])
        assert abs(a - b) <= 1e-6 * max(abs(b), 1e-6), (key, a, b)
    assert _err(res, ref, f"train/{arch}/param/",
                f"jax/train/{arch}/param/") <= 2e-6
    mu = f"jax/train/{arch}/mu/"
    scale = max(float(np.abs(ref[k]).max()) for k in ref if k.startswith(mu))
    assert _err(res, ref, f"train/{arch}/mu/", mu) <= 1e-5 * scale


@pytest.mark.parametrize("arch", SERVE)
def test_sharded_prefill_and_decode_match_jax(ranks, arch):
    """The sharded prefill step's logits and cache, 4 serve steps' logits
    and the final cache (for qwen2-0.5b the slab-merged decode over a
    sequence-sharded cache) within atol 2e-5 of the JAX package's, as
    of the unsharded calls."""
    res, _, ref, _ = ranks
    for part in ("logits", "cache0/", "cache/"):
        err = _err(res, ref, f"serve/{arch}/{part}",
                   f"jax/serve/{arch}/{part}")
        assert err <= 2e-5, (part, err)
