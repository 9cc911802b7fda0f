"""The plain references against the program at smoke widths on the CPU
(fp32): the same weights and tokens, the program's Model.forward against
the reference's logits, dense with qkv bias and the MoE with drops."""
from __future__ import annotations

import pytest
import torch

from bench.conftest import TINY, TINY_MOE, tiny_cell
from bench.lib import spec
from bench.reference import dense, moe


def _both(config, seqs):
    from repro_torch.models import Model
    family = spec.family_module(tiny_cell(config))
    mc = family.model_config(config)
    params = family.make_params(mc, 2**31 + 5, "cpu", torch.float32)
    model = Model(mc, dtype=torch.float32, device="cpu")
    model.load_params(params)
    tok = torch.tensor(seqs)
    prog = model.forward(params, tok)
    prog = prog[0] if isinstance(prog, tuple) else prog
    return params, prog


@pytest.mark.parametrize("config,ref", [
    (TINY, dense), (TINY_MOE, moe),
    (dict(TINY_MOE, moe_capacity_factor=1.25), moe)],
    ids=["dense", "moe", "moe-drops"])
def test_reference_matches_the_program(config, ref):
    g = torch.Generator().manual_seed(1)
    seqs = torch.randint(0, config["vocab_size"], (3, 24), generator=g)
    params, prog = _both(config, seqs.tolist())
    # one call over every row of every sequence, as Model.forward's
    out = ref.logits(config, params, seqs.tolist(), [24] * 3)
    got = torch.stack(out)
    assert got.shape == prog.shape
    torch.testing.assert_close(got, prog.float(), rtol=1e-4, atol=1e-4)


def test_moe_capacity_drops_late_assignments():
    cfg = dict(TINY_MOE, moe_capacity_factor=1.25)
    assert moe.capacity(cfg, 24) == 8
    assert moe.capacity(cfg, 1000) == 312
    assert moe.capacity(dict(cfg, moe_capacity_factor=4.0), 333) == 336


def test_fp8_control_differs_from_fp32():
    g = torch.Generator().manual_seed(2)
    seqs = torch.randint(0, TINY["vocab_size"], (2, 16), generator=g)
    params, _ = _both(TINY, seqs.tolist())
    a = torch.stack(dense.logits(TINY, params, seqs.tolist(), [16] * 2))
    b = torch.stack(dense.logits(TINY, params, seqs.tolist(), [16] * 2,
                                 "fp8"))
    assert (a - b).abs().max() > 1e-2
