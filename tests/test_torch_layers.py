"""The port's dense layers against the JAX package's, on the CPU.

Same numpy inputs (seeded) and the same weights go through
``repro.models`` and ``repro_torch.models``; fp32 outputs must agree to
atol=rtol=1e-5 (two frameworks' fp32 kernels sum in different orders),
bf16 outputs to 2e-2 (the two frameworks round at different places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS, tiny_config
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.training.checkpoint import _flatten
from repro_torch.models import Model, ModelConfig, params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl

DENSE = ["dense", "dense_bias", "swa", "gemma_like", "nemotron_like",
         "stablelm_like"]
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _cfgs(family):
    cfg = tiny_config(**FAMILY_CONFIGS[family])
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def _both(family, seed=0):
    """(jax cfg, port cfg, jax params, port params) with equal weights."""
    jcfg, tcfg = _cfgs(family)
    jp = JModel(jcfg).init_params(jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_numpy(_flatten(jp), device="cpu")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("family", DENSE)
def test_norm_matches_jax(family, rng):
    """RMSNorm/LayerNorm in fp32, with the model's trained-shape scale."""
    jcfg, tcfg, jp, tp = _both(family)
    x = rng.normal(size=(3, 5, jcfg.d_model)).astype(np.float32)
    scale = rng.normal(size=(jcfg.d_model,)).astype(np.float32)
    bias = rng.normal(size=(jcfg.d_model,)).astype(np.float32)
    jparams = {"scale": jnp.asarray(scale)}
    tparams = {"scale": _t(scale)}
    if jcfg.norm_type == "layernorm":
        jparams["bias"], tparams["bias"] = jnp.asarray(bias), _t(bias)
    ref = np.asarray(jl.apply_norm(jcfg, jparams, jnp.asarray(x)))
    out = tl.apply_norm(tcfg, tparams, _t(x)).numpy()
    np.testing.assert_allclose(out, ref, **F32)


@pytest.mark.parametrize("family", DENSE)
def test_norm_bf16_matches_jax(family, rng):
    """bf16 activations: both compute in fp32 and cast back."""
    jcfg, tcfg, _, _ = _both(family)
    x = rng.normal(size=(4, jcfg.d_model)).astype(np.float32)
    jparams = jl.init_norm(jcfg, jcfg.d_model)
    tparams = tl.init_norm(tcfg, tcfg.d_model)
    ref = jl.apply_norm(jcfg, jparams, jnp.asarray(x, jnp.bfloat16))
    out = tl.apply_norm(tcfg, tparams, _t(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **BF16)


@pytest.mark.parametrize("family", DENSE)
def test_rope_matches_jax(family, rng):
    """RoPE on absolute positions, full and partial rotary (rope_pct)."""
    jcfg, tcfg, _, _ = _both(family)
    hd = jcfg.resolved_head_dim
    x = rng.normal(size=(2, 6, jcfg.num_heads, hd)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 6)).astype(np.int32)
    ref = np.asarray(jl.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos)))
    out = tl.apply_rope(tcfg, _t(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(out, ref, **F32)


@pytest.mark.parametrize("family", DENSE)
def test_mlp_matches_jax(family, rng):
    """Gated and ungated MLPs with silu / gelu(tanh) / squared ReLU."""
    jcfg, tcfg, jp, tp = _both(family)
    x = rng.normal(size=(3, 2, jcfg.d_model)).astype(np.float32)
    jmlp = _layer0(jp["layers"])["mlp"]
    tmlp = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    ref = np.asarray(jl.apply_mlp(jcfg, jmlp, jnp.asarray(x)))
    out = tl.apply_mlp(tcfg, tmlp, _t(x)).numpy()
    np.testing.assert_allclose(out, ref, **F32)


@pytest.mark.parametrize("family", DENSE)
def test_embed_unembed_matches_jax(family, rng):
    """Embedding lookup (with gemma's sqrt(d) scale) and the untied or
    tied LM head."""
    jcfg, tcfg, jp, tp = _both(family)
    tok = rng.integers(0, jcfg.vocab_size, size=(3, 4)).astype(np.int32)
    ref = np.asarray(jl.embed_tokens(jcfg, jp["embed"], jnp.asarray(tok)))
    out = tl.embed_tokens(tcfg, tp["embed"], torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(out, ref, **F32)
    h = rng.normal(size=(3, jcfg.d_model)).astype(np.float32)
    ref = np.asarray(jl.unembed(jcfg, jp["embed"], jnp.asarray(h)))
    out = tl.unembed(tcfg, tp["embed"], _t(h)).numpy()
    np.testing.assert_allclose(out, ref, **F32)


@pytest.mark.parametrize("family", DENSE)
def test_project_qkv_and_rotate_match_jax(family, rng):
    """QKV projections (with the qkv bias where the family has one) and
    the RoPE rotation of q and k."""
    jcfg, tcfg, jp, tp = _both(family)
    if jcfg.qkv_bias:   # init makes zero biases; give them values
        for name in ("bq", "bk", "bv"):
            b = rng.normal(size=jp["layers"]["attn"][name].shape)
            jp["layers"]["attn"][name] = jnp.asarray(b, jnp.float32)
            tp["layers"]["attn"][name] = _t(b)
    x = rng.normal(size=(2, 3, jcfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 100, size=(2, 3)).astype(np.int32)
    ja = _layer0(jp["layers"])["attn"]
    ta = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    jq, jk, jv = jattn._project_qkv(jcfg, ja, jnp.asarray(x))
    tq, tk, tv = tattn._project_qkv(tcfg, ta, _t(x))
    for a, b in ((jq, tq), (jk, tk), (jv, tv)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)
    jq, jk = jattn._rotate(jcfg, jq, jk, jnp.asarray(pos))
    tq, tk = tattn._rotate(tcfg, tq, tk, torch.from_numpy(pos))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **F32)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **F32)


def test_params_from_numpy_round_trip():
    """Model.init_params -> slash-keyed numpy -> params_from_numpy gives
    back the same tensors under the same keys."""
    _, tcfg = _cfgs("dense_bias")
    model = Model(tcfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = v.numpy()
    walk(params)
    back = params_from_numpy(flat, device="cpu")
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for key, arr in flat.items():
        node = back
        for part in key.split("/"):
            node = node[part]
        np.testing.assert_array_equal(node.numpy(), arr)
    bound = dict(model.named_parameters())
    assert {k.replace(".", "/")[len("weights/"):] for k in bound} == \
        set(flat), "the module holds every weight under its JAX key path"
    assert bound["weights.layers.attn.wq"].data_ptr() == \
        params["layers"]["attn"]["wq"].data_ptr(), "binding must not copy"


def test_params_from_numpy_matches_jax_layout():
    """The JAX package's params convert key for key and shape for shape;
    under bf16 the norm scales stay fp32, as layers.init_norm makes them."""
    jcfg, _ = _cfgs("dense_bias")
    jp = JModel(jcfg, jnp.bfloat16).init_params(jax.random.PRNGKey(1))
    flat = _flatten(jp)
    tp = params_from_numpy(flat, device="cpu", dtype=torch.bfloat16)
    for key, arr in flat.items():
        node = tp
        for part in key.split("/"):
            node = node[part]
        assert tuple(node.shape) == arr.shape, key
        want = torch.float32 if "norm" in key else torch.bfloat16
        assert node.dtype == want, key
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(arr, np.float32))


def test_init_params_stacks_layers_and_keeps_norms_fp32():
    """Port init: stacked [L, ...] weights in [in, out] orientation, in
    the model dtype; norm scales fp32 ones."""
    _, tcfg = _cfgs("dense_bias")
    model = Model(tcfg, dtype=torch.bfloat16, device="cpu")
    p = model.init_params(torch.Generator().manual_seed(0))
    L, d, hd = tcfg.num_layers, tcfg.d_model, tcfg.resolved_head_dim
    assert p["layers"]["attn"]["wq"].shape == (L, d, tcfg.num_heads * hd)
    assert p["layers"]["mlp"]["w_down"].shape == (L, tcfg.d_ff, d)
    assert p["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert p["layers"]["norm1"]["scale"].dtype == torch.float32
    assert torch.equal(p["final_norm"]["scale"], torch.ones(d))
