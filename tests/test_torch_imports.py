"""The port stands alone: it imports neither ``jax`` nor ``repro``, and
importing it builds nothing, does not import ``triton``, sets no
environment variable and makes no process group (the dry-run's fake
group is made, and its store imported, when ``run_one`` runs). Its entry
points run on the CUDA card by default and raise without one."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.serve import load_reasoner
from repro_torch.models import Model, ModelConfig

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, os, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["repro"] = None        # ... and of the JAX package
env = dict(os.environ)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert "triton" not in sys.modules, "importing the port imported triton"
# the dry-run (and every other module) sets no variable, makes no process
# group and leaves the fake group's store unimported until it runs
import torch.distributed as dist
assert dict(os.environ) == env, "importing the port set a variable"
assert not dist.is_initialized(), "importing the port made a group"
assert "torch.testing._internal.distributed.fake_pg" not in sys.modules
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "repro" or m.startswith("repro.")]
assert not [m for m in bad if sys.modules[m] is not None], bad
print(" ".join(names))
"""


def test_every_module_imports_without_jax_or_repro():
    """Each repro_torch module imports in a fresh process where jax and
    repro cannot be imported; triton and the fake process group's store
    stay unimported, no environment variable changes and no process
    group exists."""
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=SRC,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 25
    assert {"repro_torch.models.mamba2", "repro_torch.kernels.ssd_scan.ops",
            "repro_torch.kernels.ssd_scan.ref",
            "repro_torch.kernels.ssd_scan.ssd_scan",
            "repro_torch.kernels.flash_prefill.flash_prefill",
            "repro_torch.kernels.flash_prefill.ops",
            "repro_torch.kernels.flash_prefill.ref",
            "repro_torch.models.attention", "repro_torch.models.model",
            "repro_torch.serving.engine", "repro_torch.serving.faults",
            "repro_torch.serving.simulator", "repro_torch.baselines",
            "repro_torch.data.pipeline", "repro_torch.training",
            "repro_torch.training.optimizer",
            "repro_torch.training.checkpoint",
            "repro_torch.training.train_loop", "repro_torch.launch.train",
            "repro_torch.kernels.flash_prefill.flash_prefill_bwd",
            "repro_torch.kernels.ssd_scan.ssd_scan_bwd",
            "repro_torch.distributed", "repro_torch.distributed.logical",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.local", "repro_torch.launch.mesh",
            "repro_torch.launch.shapes", "repro_torch.launch.steps",
            "repro_torch.launch.dryrun", "repro_torch.kernels.introspect",
            "repro_torch.stepcheck", "repro_torch.stepcheck.__main__",
            "repro_torch.stepcheck.bounds", "repro_torch.stepcheck.calls",
            "repro_torch.stepcheck.dispatch_rules",
            "repro_torch.stepcheck.findings",
            "repro_torch.stepcheck.harness",
            "repro_torch.stepcheck.manifest", "repro_torch.stepcheck.rules",
            "repro_torch.stepcheck.runner",
            "repro_torch.stepcheck.tracing"} <= names


_EXAMPLES_PROBE = """
import importlib.util, sys
from pathlib import Path
for banned in ("jax", "repro", "tools"):
    sys.modules[banned] = None     # any import of them now fails
for path in sorted(Path(sys.argv[1]).glob("torch_*.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)   # imports only: main() is not called
    assert callable(mod.main), path
    print(path.stem)
bad = [m for m in sys.modules if sys.modules[m] is not None and
       m.split(".")[0] in ("jax", "repro", "tools")]
assert not bad, bad
"""


def test_examples_import_without_jax_repro_or_tools():
    """The five ``examples/torch_*.py`` import in a fresh process where
    jax, the JAX package and ``tools`` cannot be imported, and none of
    their import lines names them."""
    examples = SRC.parent / "examples"
    res = subprocess.run([sys.executable, "-c", _EXAMPLES_PROBE,
                          str(examples)], cwd=SRC, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == sorted(
        p.stem for p in examples.glob("torch_*.py"))
    assert len(res.stdout.split()) == 5
    for path in examples.glob("torch_*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "repro", "tools"), f"{path}: {s}"





def test_no_source_mentions_jax_or_the_reference_package():
    """No import line of the port names jax or repro (only repro_torch)."""
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not (mod == "jax" or mod.startswith("jax.")
                            or mod == "repro" or mod.startswith("repro.")), \
                    f"{path}: {s}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_the_card(no_card):
    """Without a card, the default device raises instead of falling back
    to the CPU; naming the CPU works."""
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_a_card(no_card):
    """Model and the serve launcher default to the card and raise here."""
    cfg = ModelConfig(num_layers=1, d_model=64, num_heads=4, num_kv_heads=2,
                      d_ff=64, vocab_size=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_reasoner(None)
    assert Model(cfg, device="cpu").device == torch.device("cpu")
