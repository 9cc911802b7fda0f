"""The top-p sampler's kept set against the JAX package's.

The plain version (``kernels/sampling/ref.py``), which the kernel is
bit-equal to on the card, keeps every token whose order key is at or above
its threshold key. Here that set is held against the set the JAX package
keeps, ``repro.serving.sampling.apply_top_p(x / T, p) > NEG_INF / 2``, on
the seeded rows of ``test_torch_sampling.py`` (Gaussian rows at three
scales, heavy ties, one-hot rows, rows with ``NEG_INF`` entries), in fp32
and bf16, at vocabularies of 97, 1,000 and 152,064, temperatures 0.7, 0.9
and 1.3 and p 0.5, 0.9, 0.95 and 1.0. Tokens at ``NEG_INF`` carry no mass
and are compared as dropped. Both sides divide the same fp32 logits by the
fp32 temperature, bit for bit. A row may differ only where the fp64 mass
at its boundary lies within 1e-5 of p, plus the row's own error of JAX's
fp32 softmax, which sums its probabilities to 1 only within that error;
such rows are counted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.sampling import NEG_INF, apply_top_p
from repro_torch.kernels.sampling import ref
from test_torch_sampling import (BOUNDARY, TEMPERATURES, TOP_PS, _definition,
                                 _kept, _rows)


def _jax_kept(x: torch.Tensor, temperature: float, p: float):
    """JAX's kept set of fp32 or bf16 rows ``x``, its scaled logits and
    each row's softmax normalisation error."""
    y = jnp.asarray(x.float().numpy()) / temperature
    kept = np.asarray(apply_top_p(y, p) > NEG_INF / 2)
    err = np.abs(np.asarray(jax.nn.softmax(y, axis=-1), np.float64)
                 .sum(-1) - 1.0)
    return torch.from_numpy(kept.copy()), torch.from_numpy(np.array(y)), err


def _close_rows(x: torch.Tensor, temperature: float, p: float) -> int:
    """Asserts that the plain version keeps what JAX keeps on every row of
    ``x``, but for boundary rows; returns how many rows differed."""
    keys = torch.arange(x.shape[0], dtype=torch.int64) * 7919 + 11
    _, thr = ref.sample_top_p_ref(x, temperature, p, keys)
    y = ref.scaled_logits(x, temperature)
    j_kept, j_y, j_err = _jax_kept(x, temperature, p)
    assert torch.equal(j_y, y)           # the same fp32 division
    kept = _kept(y, thr) & (y > NEG_INF / 2)
    close = 0
    for r in range(x.shape[0]):
        if torch.equal(kept[r], j_kept[r]):
            continue
        _, at, nxt = _definition(y[r], p)
        slack = BOUNDARY + float(j_err[r])
        assert abs(at - p) <= slack or abs(nxt - p) <= slack, \
            (r, at, nxt, float(j_err[r]))
        close += 1
    return close


@pytest.mark.parametrize("p", TOP_PS)
@pytest.mark.parametrize("temperature", TEMPERATURES)
@pytest.mark.parametrize("vocab", [97, 1000])
def test_kept_set_matches_jax(vocab, temperature, p):
    """Eight seeded rows in fp32 and in bf16: at most two boundary rows
    differ in all."""
    gen = torch.Generator().manual_seed(vocab * 100 + int(p * 100))
    x = _rows(gen, vocab)
    close = _close_rows(x, temperature, p)
    close += _close_rows(x.to(torch.bfloat16), temperature, p)
    assert close <= 2


@pytest.mark.parametrize("p", TOP_PS)
@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_kept_set_matches_jax_at_r1_vocab(temperature, p):
    """The same eight kinds of rows at r1-distill-14b's 152,064 tokens, in
    bf16 as the unembedding gives them: at most two boundary rows
    differ."""
    gen = torch.Generator().manual_seed(152064 + int(p * 100))
    x = _rows(gen, 152064).to(torch.bfloat16)
    assert _close_rows(x, temperature, p) <= 2
