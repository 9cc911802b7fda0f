"""The port's five examples (``examples/torch_*.py``) at smoke size on
the CPU.

Each is the counterpart of the reference's script of the same name
without ``torch_`` and runs through the port's entry points
(``repro_torch.core.Scheduler``, ``launch.serve.serve``,
``launch.train.train_reasoner``, ``configs``); each takes ``--device``,
which defaults to the card and raises without one, and smoke sizes as
arguments whose defaults are the reference's. The quickstart leaks no page; train -> serve round-trips
through a checkpoint in a temp dir; that checkpoint loads in the
reference's loader (``repro.launch.serve.load_reasoner``) and gives the
port's logits within fp32 tolerance (atol 1e-4, rtol 1e-4: two
frameworks' fp32 matmul orders).
"""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_assigned_archs_tour",
         "torch_train_tiny_reasoner", "torch_serve_reasoning",
         "torch_sart_vs_baselines")


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _example(name).main(list(argv))
    return rc, out.getvalue()


def test_every_reference_example_has_a_port():
    ref = {p.stem for p in EXAMPLES.glob("*.py")
           if not p.stem.startswith("torch_")}
    assert {f"torch_{n}" for n in ref} == set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_examples_default_to_the_card(name, monkeypatch):
    """Without ``--device`` each example runs on the CUDA card, and with
    no card it raises before any work, as ``resolve_device`` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(name)


def test_quickstart_serves_and_leaks_no_page():
    rc, out = _run("torch_quickstart", "--device", "cpu", "--requests", "2",
                   "--max-tokens", "12")
    assert rc == 0
    assert "all KV pages released — no leaks" in out
    assert out.count("completed=") == 2


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m",
                                  "qwen2-vl-72b"])
def test_archs_tour(arch):
    rc, out = _run("torch_assigned_archs_tour", "--device", "cpu", "--arch",
                   arch, "--new-tokens", "2")
    assert rc == 0 and f"== {arch}" in out and "smoke decode ok" in out


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The tiny reasoner trained for a few steps by the example, its
    checkpoint in a temp dir."""
    path = tmp_path_factory.mktemp("reasoner")
    rc, out = _run("torch_train_tiny_reasoner", "--device", "cpu",
                   "--steps", "3", "--prm-steps", "2", "--eval-problems",
                   "2", "--out", str(path))
    assert rc == 0 and "[eval] greedy accuracy" in out
    return path


def test_train_writes_the_reference_checkpoint_format(checkpoint):
    assert {p.name for p in checkpoint.iterdir()} >= {
        "lm.npz", "prm.npz", "config.json"}
    cfg = json.loads((checkpoint / "config.json").read_text())
    assert cfg["history"][-1]["step"] == 2 and cfg["prm_history"]
    assert (cfg["d_model"], cfg["num_layers"]) == (128, 2)


def test_serve_reads_the_trained_checkpoint(checkpoint):
    rc, out = _run("torch_serve_reasoning", "--device", "cpu", "--requests",
                   "2", "--n", "2", "--max-tokens", "8", "--ckpt",
                   str(checkpoint))
    assert rc == 0
    res = json.loads(out)
    assert res["policy"] == "sart" and res["n"] == 2
    assert res["completed_requests"] == 2


def test_sart_vs_baselines_over_the_checkpoint(checkpoint):
    rc, out = _run("torch_sart_vs_baselines", "--device", "cpu",
                   "--requests", "1", "--n", "2", "--max-tokens", "6",
                   "--ckpt", str(checkpoint))
    assert rc == 0
    rows = [l.split()[0] for l in out.splitlines()[1:]]
    assert rows == ["vanilla", "sc", "rebase", "sart"]


def test_checkpoint_loads_in_the_reference(checkpoint):
    """The JAX package's loader reads the port's checkpoint, and its
    model's logits equal the port's on the same tokens (fp32, atol = rtol
    = 1e-4)."""
    import jax.numpy as jnp
    from repro.launch.serve import load_reasoner as ref_load

    from repro_torch.launch.serve import load_reasoner
    jm, jp, jhead = ref_load(str(checkpoint))
    tm, tp, thead = load_reasoner(str(checkpoint), device="cpu")
    assert jhead is not None and thead is not None
    toks = np.random.default_rng(0).integers(0, tm.cfg.vocab_size, (2, 24))
    want = np.asarray(jm.forward(jp, jnp.asarray(toks, jnp.int32))[0])
    with torch.no_grad():
        got = tm.forward(tp, torch.as_tensor(toks, dtype=torch.int32))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
