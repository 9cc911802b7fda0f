"""The port's data pipeline (``repro_torch.data.pipeline``, a copy of
the reference's numpy code) against ``repro.data.pipeline``: the same
config gives the same batches, bit for bit, and the reference's own data
tests hold on the copy."""
import numpy as np
import pytest

from repro.data import pipeline as jax_pipeline
from repro_torch.data import DataConfig, padded_batches, prm_batches
from repro_torch.data import tokenizer as tk


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
@pytest.mark.parametrize("which", ["padded", "prm"])
def test_batches_bit_equal_to_the_reference(seed, which):
    """Three batches of each generator, every array equal (dtype too)."""
    kw = dict(batch_size=4, seq_len=96, seed=seed)
    if which == "padded":
        ours = padded_batches(DataConfig(**kw))
        ref = jax_pipeline.padded_batches(jax_pipeline.DataConfig(**kw))
    else:
        ours = prm_batches(DataConfig(**kw), error_p=0.4)
        ref = jax_pipeline.prm_batches(jax_pipeline.DataConfig(**kw),
                                       error_p=0.4)
    for _ in range(3):
        for a, b in zip(next(ours), next(ref)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_short_sequences_and_config_fields():
    """A seq_len shorter than most traces truncates them the same way, and
    every config knob reaches the generator (overthink and recheck)."""
    kw = dict(batch_size=3, seq_len=24, min_terms=5, max_terms=6,
              recheck_p=0.9, overthink_p=0.5, seed=3)
    for a, b in zip(next(padded_batches(DataConfig(**kw))),
                    next(jax_pipeline.padded_batches(
                        jax_pipeline.DataConfig(**kw)))):
        np.testing.assert_array_equal(a, b)


def test_padded_batches_shapes_and_mask():
    """``tests/test_tasks_data.py``'s check on the copy."""
    cfg = DataConfig(batch_size=4, seq_len=96)
    toks, labels, mask = next(padded_batches(cfg))
    assert toks.shape == labels.shape == mask.shape == (4, 96)
    assert (toks[mask.astype(bool)] != tk.PAD).all()
    np.testing.assert_array_equal(labels[:, :-1], toks[:, 1:])


def test_prm_batches_labels_binary():
    """``tests/test_tasks_data.py``'s check on the copy."""
    cfg = DataConfig(batch_size=4, seq_len=96)
    toks, labels, mask = next(prm_batches(cfg))
    assert set(np.unique(labels)) <= {0.0, 1.0}
    assert mask.sum() > 0
    assert ((mask == 0) | ((labels == 0) | (labels == 1))).all()
