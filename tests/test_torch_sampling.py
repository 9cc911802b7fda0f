"""The top-p sampler (``kernels/sampling``): its plain version on the CPU,
the wrapper's launch geometry, ``serving.sampling.sample``'s routes, and
on the card the kernel itself.

The plain version (``ref.sample_top_p_ref``) is held against the definition
of the threshold in fp64 and against ``serving.sampling.apply_top_p`` on
seeded rows: Gaussian rows, rows of heavy ties, one-hot rows and rows with
``NEG_INF`` entries, vocabularies of 97 and 1,000 and one row of 152,064,
temperatures 0.7, 0.9 and 1.3 and p 0.5, 0.9, 0.95 and 1.0. Where the fp64
mass at the boundary lies within 1e-5 of p (plus, against ``apply_top_p``,
its own fp32 softmax's error), either choice of the boundary is accepted;
such rows are counted. The race, given the same noise, is argmax(p / E).

This file imports no JAX, so that its ``gpu`` tests run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_sampling.py``;
``test_torch_sampling_parity.py`` holds the plain version's kept set
against the JAX package's ``apply_top_p``.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import introspect as ix
from repro_torch.kernels.launches import launch_counts, launches_since
from repro_torch.kernels.sampling import ref
from repro_torch.kernels.sampling import sample_top_p as sampler
from repro_torch.serving import sampling
from repro_torch.serving.sampling import (NEG_INF, SamplingParams,
                                          apply_top_k, apply_top_p, sample)

TEMPERATURES = (0.7, 0.9, 1.3)
TOP_PS = (0.5, 0.9, 0.95, 1.0)
BOUNDARY = 1e-5


def _rows(gen: torch.Generator, vocab: int) -> torch.Tensor:
    """Eight seeded rows [8, vocab] fp32: Gaussian at three scales, heavy
    ties (Gaussian rounded to halves), two-valued ties, one-hot, and
    Gaussian rows with a third of their entries at NEG_INF."""
    g = torch.randn(8, vocab, generator=gen, dtype=torch.float64)
    rows = torch.empty(8, vocab, dtype=torch.float64)
    rows[0], rows[1], rows[2] = g[0] * 0.5, g[1] * 2.0, g[2] * 6.0
    rows[3] = torch.round(g[3] * 4.0) / 2.0
    rows[4] = (g[4] > 0.8).double() * 3.0
    rows[5] = NEG_INF
    rows[5, vocab // 3] = 4.0
    rows[6], rows[7] = g[6] * 2.0, g[7] * 3.0
    dead = torch.rand(2, vocab, generator=gen) < 1 / 3
    dead[:, 0] = False
    rows[6:][dead] = NEG_INF
    return rows.float()


def _definition(y: torch.Tensor, p: float):
    """The threshold in fp64 for one row of fp32 ``y``: (t*, mass at or
    above t* / Z, mass at or above the next larger value / Z), t* the
    largest value whose mass at or above it reaches p (the smallest value
    for p >= 1)."""
    y64 = y.double()
    w = torch.exp(y64 - y64.max())
    vals, inv = torch.unique(y64, sorted=True, return_inverse=True)
    m = torch.zeros_like(vals).scatter_add_(0, inv, w)
    above = m.flip(0).cumsum(0).flip(0) / w.sum()
    if p >= 1.0:
        return vals[0], 1.0, float(above[1]) if len(vals) > 1 else 0.0
    i = int((above >= p).nonzero().max())
    nxt = float(above[i + 1]) if i + 1 < len(vals) else 0.0
    return vals[i], float(above[i]), nxt


def _kept(y: torch.Tensor, thr_key: torch.Tensor) -> torch.Tensor:
    return ref.order_key(y) >= (thr_key.to(torch.int64) & 0xFFFFFFFF)[:, None]


def _check_against_definition(x, temperature, p):
    """Every row's kept set from the plain version against the fp64
    definition and against ``apply_top_p``. Returns the rows where the
    boundary was within the accepted distance and the choices differed."""
    keys = torch.arange(x.shape[0], dtype=torch.int64) * 7919 + 11
    _, thr = ref.sample_top_p_ref(x, temperature, p, keys)
    y = ref.scaled_logits(x, temperature)
    kept = _kept(y, thr)
    old = apply_top_p(x.float() / temperature, p) > NEG_INF / 2
    # apply_top_p's probabilities carry its fp32 softmax's error
    old_err = (torch.softmax(x.float() / temperature, -1).double().sum(-1)
               - 1.0).abs()
    close = 0
    for r in range(x.shape[0]):
        t, at, nxt = _definition(y[r], p)
        want = y[r].double() >= t
        assert kept[r, y[r].argmax()]                # top-1 always kept
        if p >= 1.0:                                 # nothing dropped
            assert kept[r].all()
            continue
        # ties at the threshold are all kept or all dropped
        assert torch.equal(kept[r], y[r] >= y[r][kept[r]].min())
        near = abs(at - p) <= BOUNDARY or abs(nxt - p) <= BOUNDARY
        if not torch.equal(kept[r], want):
            assert near, (r, at, nxt)
            close += 1
        slack = BOUNDARY + float(old_err[r])
        if not torch.equal(kept[r], old[r]):
            assert abs(at - p) <= slack or abs(nxt - p) <= slack, \
                (r, at, nxt, float(old_err[r]))
            close += 1
    return close


# ------------------------------------------------ the plain version (CPU)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Philox4x32-10 gives the published known-answer vectors (Random123's
    kat_vectors)."""
    t = lambda v: torch.tensor(v, dtype=torch.int64)   # noqa: E731
    out = ref.philox4x32(tuple(map(t, ctr)), tuple(map(t, key)))
    assert tuple(int(w) for w in out) == want


def test_exp_det_follows_exp():
    """``exp_det`` is within 2e-7 of e**d over [-80, 0], exactly 1 at 0,
    0 below -80 and for NaN, and never above 1."""
    d = -torch.rand(200_000, generator=torch.Generator().manual_seed(3)) * 80
    e = ref.exp_det(d)
    rel = (e.double() / torch.exp(d.double()) - 1).abs().max()
    assert rel < 2e-7
    assert ref.exp_det(torch.zeros(1)).item() == 1.0
    assert (e <= 1).all()
    odd = ref.exp_det(torch.tensor([-80.5, -1e30, float("nan")]))
    assert odd.tolist() == [0.0, 0.0, 0.0]


def test_race_noise_is_exponential():
    """The race's noise is -log(u) within 3e-7 relative, never 0, and
    Exp(1) in mean and variance over 10**6 words."""
    bits = torch.randint(0, 2 ** 32, (1_000_000,),
                         generator=torch.Generator().manual_seed(4))
    e = ref.race_noise(bits)
    u = ((bits >> 9) * 2 + 1).double() / 2 ** 24
    assert ((e.double() + u.log()) / -u.log()).abs().max() < 3e-7
    assert (e > 0).all()
    assert abs(e.double().mean().item() - 1) < 5e-3
    assert abs(e.double().var().item() - 1) < 1e-2


def test_row_noise_uses_one_philox_word_a_token():
    """Token i of row r takes word i & 3 of Philox at counter (i >> 2, r,
    0, 0) under the row's key: the noise of a V = 10 row is that of the
    words, element by element."""
    keys = torch.tensor([0x0123456789ABCDEF, -5], dtype=torch.int64)
    e = ref.row_noise(keys, 10)
    for r, k in enumerate(keys.tolist()):
        k0, k1 = k & 0xFFFFFFFF, (k >> 32) & 0xFFFFFFFF
        for i in range(10):
            t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
            w = ref.philox4x32((t(i >> 2), t(r), t(0), t(0)), (t(k0), t(k1)))
            assert e[r, i] == ref.race_noise(w[i & 3].reshape(1))[0]


@pytest.mark.parametrize("p", TOP_PS)
@pytest.mark.parametrize("temperature", TEMPERATURES)
@pytest.mark.parametrize("vocab", [97, 1000])
def test_threshold_matches_definition(vocab, temperature, p):
    """The plain version keeps what the fp64 definition of t* keeps and
    what ``apply_top_p`` keeps, on eight seeded rows (ties, one-hot,
    NEG_INF entries), in fp32 and bf16; rows whose boundary lies within
    the accepted distance are counted, and few."""
    gen = torch.Generator().manual_seed(vocab * 100 + int(p * 100))
    x = _rows(gen, vocab)
    close = _check_against_definition(x, temperature, p)
    close += _check_against_definition(x.to(torch.bfloat16), temperature, p)
    assert close <= 2


@pytest.mark.parametrize("p", TOP_PS)
def test_threshold_one_row_of_r1_vocab(p):
    """One row of 152,064 bf16 logits (r1-distill-14b's vocabulary) at
    temperature 0.9, as the benchmark samples."""
    gen = torch.Generator().manual_seed(152064 + int(p * 100))
    x = (torch.randn(1, 152064, generator=gen) * 2.0).to(torch.bfloat16)
    assert _check_against_definition(x, 0.9, p) <= 1


@pytest.mark.parametrize("p", [0.5, 0.95, 1.0])
def test_race_is_argmax_of_p_over_noise(p):
    """Given the same noise, the plain version's token is argmax(p / E)
    with p the renormalised top-p probabilities of ``apply_top_p``'s
    softmax, on 32 rows of 1,000 tokens."""
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(32, 1000, generator=gen) * 2.0
    keys = torch.randint(0, 2 ** 62, (32,), generator=gen)
    tokens, thr = ref.sample_top_p_ref(x, 0.9, p, keys)
    y = ref.scaled_logits(x, 0.9)
    probs = torch.softmax(y.masked_fill(~_kept(y, thr), NEG_INF), -1)
    want = (probs / ref.row_noise(keys, 1000)).argmax(-1)
    assert torch.equal(tokens, want.to(torch.int32))


def test_plain_version_is_keyed_and_repeatable():
    """The same keys give the same tokens; other keys other draws; the
    tokens are kept ones."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(64, 1000, generator=gen)
    keys = torch.randint(0, 2 ** 62, (64,), generator=gen)
    a, thr = ref.sample_top_p_ref(x, 1.3, 0.9, keys)
    b, _ = ref.sample_top_p_ref(x, 1.3, 0.9, keys)
    c, _ = ref.sample_top_p_ref(x, 1.3, 0.9, keys + 1)
    assert torch.equal(a, b)
    assert (a != c).sum() > 32
    kept = _kept(ref.scaled_logits(x, 1.3), thr)
    assert kept.gather(1, a.long()[:, None]).all()


def _chi_square(counts: np.ndarray, probs: np.ndarray) -> float:
    n = counts.sum()
    live = probs > 0
    assert counts[~live].sum() == 0
    return float(((counts[live] - n * probs[live]) ** 2
                  / (n * probs[live])).sum())


def _top_p_probs(row: torch.Tensor, temperature: float, p: float):
    """The renormalised top-p probabilities of one row, in fp64 over the
    set ``apply_top_p`` keeps."""
    y = row.double() / temperature
    keep = apply_top_p(row.float()[None] / temperature, p)[0] > NEG_INF / 2
    w = torch.exp(y - y.max()) * keep
    return (w / w.sum()).numpy()


def test_plain_draws_follow_top_p():
    """20,000 draws of one row of 64 tokens (different keys) against the
    renormalised top-p probabilities: chi-square below its 0.999 quantile
    (Wilson-Hilferty), and nothing outside the kept set."""
    gen = torch.Generator().manual_seed(6)
    row = torch.randn(64, generator=gen) * 1.5
    n = 20_000
    keys = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=gen)
    tokens, _ = ref.sample_top_p_ref(row.expand(n, 64), 0.9, 0.9, keys)
    probs = _top_p_probs(row, 0.9, 0.9)
    counts = np.bincount(tokens.numpy(), minlength=64)
    df = int((probs > 0).sum()) - 1
    z = 3.0902   # the 0.999 quantile of N(0, 1)
    q = df * (1 - 2 / (9 * df) + z * (2 / (9 * df)) ** 0.5) ** 3
    assert _chi_square(counts, probs) < q


# ----------------------------------------------- the wrapper (no card)


def test_grid_is_one_cluster_a_row():
    """``sample_top_p_grid``: grid (rows x C, 1, 1), C = 2 CTAs a row at a
    step's 320 rows and 8 at a spawn's one; every CTA of cluster r reads
    row r of the logits and key r, its first CTA writes token r and
    threshold r; the route follows the dtype."""
    (lg,) = sampler.sample_top_p_grid(320, 152064, torch.bfloat16)
    assert lg.grid == (640, 1, 1) and lg.route == "bf16"
    assert dict(lg.host) == {"cluster": 2}
    for cta, writes in (((14, 0, 0), True), ((15, 0, 0), False)):
        acc = {op.name: op.ranges(cta) for op in lg.operands}
        out = [((7, 8),)] if writes else []
        assert acc == {"logits": [((7, 8), (0, 152064))],
                       "keys": [((7, 8),)], "tokens": out,
                       "thresholds": out}
    (one,) = sampler.sample_top_p_grid(1, 97, torch.float32)
    assert one.grid == (8, 1, 1) and one.route == "fp32"
    assert [sampler.cluster_ctas(n) for n in (1, 32, 33, 100_000)] == \
        [8, 8, 2, 2]
    assert "sample_top_p" in build.SOURCES
    assert (build.CSRC / "sample_top_p.cu").exists()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_passes_its_grid(monkeypatch, dtype):
    """The wrapper hands its launcher ``sample_top_p_grid``'s grid as the
    two arguments before the stream, with an argument list as long as the
    ``extern "C"`` signature, and counts the launch."""
    calls = []

    def function(source, fn_name, argtypes):
        assert (source, fn_name) == ("sample_top_p", "sample_top_p_launch")
        calls.append(list(argtypes))
        return lambda *args: calls.append(args) or 0
    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "check_operands", lambda *a: None)
    monkeypatch.setattr(build, "stream", lambda t: 0)
    launches = sampler.launches
    tok, thr = sampler.sample_top_p(torch.zeros(3, 5, 97, dtype=dtype), 0.9,
                                    0.95, torch.zeros(15, dtype=torch.int64))
    assert tok.shape == thr.shape == (3, 5) and tok.dtype == torch.int32
    argtypes, args = calls
    arr, n = args[-3], args[-2]
    got = [tuple((ctypes.c_int * 3).from_address(ctypes.addressof(arr)
                                                 + 12 * i)) for i in range(n)]
    assert got == [lg.grid for lg in sampler.sample_top_p_grid(15, 97, dtype)]
    assert args[0] == (1 if dtype == torch.bfloat16 else 0)
    assert args[5:9] == (15, 97, 0.9, 0.95)
    text = (build.CSRC / "sample_top_p.cu").read_text()
    m = re.search(r'extern "C" int sample_top_p_launch\((.*?)\)\s*\{',
                  text, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(argtypes) == len(args)
    assert params[-3:] == ["const int* grids", "int n_grids", "void* stream"]
    assert argtypes[-3:] == ix.GRID_ARGTYPES + [ctypes.c_void_p]
    assert sampler.launches == launches + 1
    assert launch_counts()["sample_top_p"] == sampler.launches


def test_wrapper_refuses():
    """CPU tensors, fp16 logits, a temperature of 0, a vocabulary of
    2**20 and keys that are not one int64 a row are refused."""
    x, k = torch.zeros(2, 8), torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        sampler.sample_top_p(x, 0.9, 0.9, k)
    with pytest.raises(TypeError):
        sampler.sample_top_p(x.half(), 0.9, 0.9, k)
    with pytest.raises(ValueError, match="temperature"):
        sampler.sample_top_p(x, 0.0, 0.9, k)
    with pytest.raises(ValueError, match="vocab"):
        sampler.sample_top_p(torch.zeros(1, ref.MAX_VOCAB), 0.9, 0.9, k[:1])
    with pytest.raises(ValueError, match="keys"):
        sampler.sample_top_p(x, 0.9, 0.9, k.int())
    with pytest.raises(ValueError, match="keys"):
        sampler.sample_top_p(x, 0.9, 0.9, k[:1])


def _old_sample(gen, logits, params):
    """``sample``'s plain path as it was written before the kernel."""
    if params.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / params.temperature
    logits = apply_top_k(logits, params.top_k)
    logits = apply_top_p(logits, params.top_p)
    probs = torch.softmax(logits, dim=-1)
    noise = torch.empty_like(probs).exponential_(1, generator=gen)
    return torch.argmax(probs / noise, dim=-1).to(torch.int32)


@pytest.mark.parametrize("params", [
    SamplingParams(temperature=0.0), SamplingParams(temperature=0.9,
                                                    top_p=0.95),
    SamplingParams(temperature=0.7, top_k=5, top_p=0.9),
    SamplingParams(temperature=1.3)])
def test_sample_keeps_its_plain_path_off_the_card(monkeypatch, params):
    """On the CPU (and for greedy and top-k sampling anywhere) ``sample``
    never reaches the kernel and draws what it drew before, leaving the
    generator where it left it."""
    def refuse(*a, **k):
        raise AssertionError("the kernel was called")
    monkeypatch.setattr(sampling, "sample_top_p", refuse)
    logits = torch.randn(6, 97, generator=torch.Generator().manual_seed(9))
    mine, old = (torch.Generator().manual_seed(3) for _ in range(2))
    got = sample(mine, logits, params)
    assert torch.equal(got, _old_sample(old, logits, params))
    assert torch.equal(mine.get_state(), old.get_state())


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that ``sample`` takes
    the kernel's route (to a stand-in for the kernel)."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("params,routed", [
    (SamplingParams(temperature=0.9, top_p=0.95), True),
    (SamplingParams(temperature=1.3), True),
    (SamplingParams(temperature=0.0), False),
    (SamplingParams(temperature=0.7, top_k=5, top_p=0.9), False)])
def test_sample_routes_card_logits_to_the_kernel(monkeypatch, params,
                                                 routed):
    """Logits on the card at temperature > 0 without top-k go to the
    kernel as they are, with the temperature, top-p and one int64 key a
    row drawn from ``gen`` (all the generator is advanced by); greedy and
    top-k sampling never reach it."""
    calls = []

    def kernel(logits, temperature, top_p, keys):
        calls.append((logits, temperature, top_p, keys))
        return torch.full(logits.shape[:-1], 7, dtype=torch.int32), None
    monkeypatch.setattr(sampling, "sample_top_p", kernel)
    logits = torch.randn(2, 3, 97, generator=torch.Generator().manual_seed(9)
                         ).to(torch.bfloat16).as_subclass(_OnCard)
    gen, mirror = (torch.Generator().manual_seed(4) for _ in range(2))
    got = sample(gen, logits, params)
    assert got.shape == (2, 3) and got.dtype == torch.int32
    if not routed:
        assert calls == []
        return
    ((x, temperature, top_p, keys),) = calls
    assert x is logits and (temperature, top_p) == (params.temperature,
                                                    params.top_p)
    want = torch.empty(6, dtype=torch.int64).random_(generator=mirror)
    assert keys.dtype == torch.int64 and torch.equal(keys, want)
    assert torch.equal(gen.get_state(), mirror.get_state())
    assert (got == 7).all()


def _tiny_sampled_engine(device: str):
    from repro_torch.models import Model, ModelConfig
    from repro_torch.serving import Engine, EngineConfig
    cfg = ModelConfig(name="tiny", arch_type="dense", num_layers=1,
                      d_model=32, vocab_size=97, num_heads=2, num_kv_heads=1,
                      head_dim=32, d_ff=64)     # a head width K1 serves
    model = Model(cfg, device=device)
    params = model.init_params(torch.Generator(device).manual_seed(0))
    return Engine(model, params, EngineConfig(
        max_slots=2, num_pages=16, page_size=16, max_pages_per_branch=4,
        sampling=SamplingParams(temperature=0.9, top_p=0.95)))


def _spawn_and_step(eng, steps: int):
    """A prefill, one spawn and ``steps`` decode steps; returns the
    sampler's launches around the spawn and its launches the steps ran
    (``Engine.step_launches``)."""
    blocks, lg, ssm = eng.prefill([2, 5, 9])
    before = launch_counts()
    assert eng.spawn_branch(0, blocks, lg, ssm, 3) is not None
    spawn = launches_since(before).get("sample_top_p", 0)
    ran = eng.step_launches().get("sample_top_p", 0)
    for _ in range(steps):
        eng.decode_step()
    return spawn, eng.step_launches().get("sample_top_p", 0) - ran


def test_cpu_engine_launches_no_sampler():
    """A sampled CPU engine's steps and spawns take the plain path: the
    launch counters show no sampler launch around a spawn and none among
    the steps' launches."""
    assert _spawn_and_step(_tiny_sampled_engine("cpu"), 2) == (0, 0)


# ------------------------------------------------------- on the card only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_logits(gen, rows, vocab, dtype):
    """Seeded logits on the card: Gaussian rows at three scales, one row
    of heavy ties and one of a single token above NEG_INF."""
    x = torch.randn(rows, vocab, generator=gen, device=gen.device)
    x *= torch.tensor([0.5, 2.0, 6.0], device=gen.device).repeat(
        -(-rows // 3))[:rows, None]
    if rows > 3:
        x[3] = torch.round(x[3] * 2.0) / 2.0
        x[4] = NEG_INF
        x[4, vocab // 2] = 1.0
    return x.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("vocab", [152064, 151936, 256000, 97])
@pytest.mark.parametrize("rows", [1, 320])
def test_kernel_bit_equal_to_plain_on_card(cuda, rows, vocab, dtype):
    """Tokens and thresholds bit-equal to the plain version (run on the
    card) on the same logits and keys, at p 0.95 and 1.0, and the same
    again on a second launch."""
    gen = torch.Generator(cuda).manual_seed(rows * 7 + vocab)
    x = _card_logits(gen, rows, vocab, dtype)
    keys = torch.randint(-2 ** 62, 2 ** 62, (rows,), generator=gen,
                         device=cuda)
    for p in (0.95, 1.0):
        tok, thr = sampler.sample_top_p(x, 0.9, p, keys)
        want_tok, want_thr = ref.sample_top_p_ref(x, 0.9, p, keys)
        torch.cuda.synchronize()
        assert torch.equal(thr, want_thr), p
        assert torch.equal(tok, want_tok), p
        again = sampler.sample_top_p(x, 0.9, p, keys)
        assert torch.equal(again[0], tok) and torch.equal(again[1], thr)


@pytest.mark.gpu
def test_kernel_draws_follow_top_p_on_card(cuda):
    """100,000 draws of one row of 64 tokens (one launch of 100,000 rows,
    each its own key) against the renormalised top-p probabilities:
    chi-square below its 0.999 quantile, nothing outside the kept set."""
    from scipy.stats import chi2
    gen = torch.Generator(cuda).manual_seed(8)
    row = torch.randn(64, generator=gen, device=cuda) * 1.5
    n = 100_000
    keys = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=gen, device=cuda)
    tok, _ = sampler.sample_top_p(row.expand(n, 64), 0.9, 0.95, keys)
    probs = _top_p_probs(row.cpu(), 0.9, 0.95)
    counts = np.bincount(tok.cpu().numpy(), minlength=64)
    df = int((probs > 0).sum()) - 1
    assert _chi_square(counts, probs) < chi2.ppf(0.999, df)


@pytest.mark.gpu
def test_captured_sample_draws_fresh_and_equals_eager(cuda):
    """``sample`` captured in a CUDA graph with the generator registered:
    two replays draw different tokens, and a replay equals the eager call
    from the same generator state."""
    gen = torch.Generator(cuda).manual_seed(12)
    logits = _card_logits(gen, 320, 152064, torch.bfloat16)
    params = SamplingParams(temperature=0.9, top_p=0.95)
    sample(gen, logits, params)          # warm-up: build, load, attribute
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = sample(gen, logits, params)
    state = gen.get_state()
    graph.replay()
    first = out.clone()
    graph.replay()
    second = out.clone()
    assert (first != second).sum() > 100
    gen.set_state(state)
    eager = sample(gen, logits, params)
    assert torch.equal(eager, first)


@pytest.mark.gpu
def test_launcher_refuses_a_bad_grid_on_card(cuda, monkeypatch):
    """A grid off by one in x is refused before the launch: the wrapper
    raises and counts no launch."""
    good = sampler.sample_top_p_grid

    def off_by_one(rows, vocab, dtype=torch.bfloat16):
        (lg,) = good(rows, vocab, dtype)
        return ix.Launches((ix.LaunchGrid(lg.kernel, lg.route,
                                          (rows + 1, 1, 1), lg.operands),))
    monkeypatch.setattr(sampler, "sample_top_p_grid", off_by_one)
    x = torch.zeros(4, 1000, dtype=torch.bfloat16, device=cuda)
    keys = torch.zeros(4, dtype=torch.int64, device=cuda)
    before = sampler.launches
    with pytest.raises(RuntimeError, match="sample_top_p"):
        sampler.sample_top_p(x, 0.9, 0.95, keys)
    assert sampler.launches == before


@pytest.mark.gpu
def test_engine_steps_and_spawns_take_the_kernel_on_card(cuda):
    """On the card a sampled engine's spawn launches the sampler once, and
    each of its decode steps (graph replays and their capture) runs one
    sampler launch: ``step_launches`` counts one a step."""
    assert _spawn_and_step(_tiny_sampled_engine("cuda"), 3) == (1, 3)
