"""The port's sharding rules (``repro_torch.distributed``) against the
reference's: the counterparts of every test in ``tests/test_sharding.py``,
and the sanitized param and cache spec trees of every assigned arch held
to the reference's leaf by leaf on the production meshes."""
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsh
from repro.launch.shapes import SHAPES as JSHAPES
from repro.launch.shapes import adapt_config as jadapt
from repro.models import Model as JModel
from repro_torch.configs import ASSIGNED, get_config, smoke
from repro_torch.distributed.sharding import (P, cache_pspecs, drop_fsdp,
                                              local_bytes, param_pspecs,
                                              param_spec, placements,
                                              sanitize_pspecs)
from repro_torch.launch.shapes import SHAPES, adapt_config
from repro_torch.launch.steps import params_shape
from repro_torch.models import Model
from torch.distributed.tensor import Replicate, Shard


def fake_mesh(**axes):
    """A mesh's names and shape as both packages read them (a JAX mesh's
    ``axis_names``/``devices.shape``, a ``DeviceMesh``'s
    ``mesh_dim_names``/``shape``), with no device or process group."""
    n = 1
    for v in axes.values():
        n *= v
    return types.SimpleNamespace(
        axis_names=tuple(axes), mesh_dim_names=tuple(axes),
        shape=tuple(axes.values()),
        devices=types.SimpleNamespace(shape=tuple(axes.values()), size=n))


MESHES = {"single": dict(data=16, model=16),
          "multi": dict(pod=2, data=16, model=16)}


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _as_tuple(spec):
    """A spec as a plain tuple, a one-name tuple as the name (JAX's
    ``PartitionSpec`` compares them equal)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def test_same_arch_registry():
    assert list(ASSIGNED) == list(JASSIGNED)


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_param_rules_cover_every_leaf(arch):
    """Every parameter of every architecture matches a sharding rule."""
    tree = Model(smoke(arch), device="meta").init_params(None)
    specs = param_pspecs(tree)   # raises KeyError on uncovered paths
    leaves, flat = _flat(specs), _flat(tree)
    assert set(leaves) == set(flat)
    for k, spec in leaves.items():
        assert isinstance(spec, P) and len(spec) == flat[k].dim()


def test_param_spec_examples():
    assert param_spec("layers/attn/wq", 3) == P(None, "data", "model")
    assert param_spec("layers/attn/wo", 3) == P(None, "model", "data")
    assert param_spec("layers/moe/w_up", 4) == P(None, "model", "data", None)
    assert param_spec("embed/embedding", 2) == P("model", None)
    assert param_spec("final_norm/scale", 1) == P(None)
    with pytest.raises(KeyError):
        param_spec("layers/unknown/w", 2)


@pytest.mark.parametrize("path,ndim", [
    ("layers/attn/wq", 3), ("layers/attn/bk", 2), ("layers/mlp/b_down", 2),
    ("layers/moe/router", 3), ("layers/moe/w_down", 4),
    ("layers/mamba/conv_w", 3), ("layers/mamba/norm/scale", 2),
    ("layers/mamba/a_log", 2), ("layers/norm2/bias", 2),
    ("embed/lm_head", 2), ("final_norm/bias", 1)])
def test_param_spec_equals_reference(path, ndim):
    assert _as_tuple(param_spec(path, ndim)) == \
        _as_tuple(jsh.param_spec(path, ndim))


def test_sanitize_drops_nondivisible():
    mesh = fake_mesh(data=16, model=16)
    shapes = {"ok": _meta((32, 64)), "bad_dim0": _meta((50280, 64)),
              "bad_dim1": _meta((32, 2))}
    specs = {"ok": P("data", "model"), "bad_dim0": P("model", None),
             "bad_dim1": P(None, "model")}
    out = sanitize_pspecs(specs, shapes, mesh)
    assert out["ok"] == P("data", "model")
    assert out["bad_dim0"] == P(None, None)
    assert out["bad_dim1"] == P(None, None)


def test_sanitize_handles_tuple_axes():
    mesh = fake_mesh(pod=2, data=16, model=16)
    specs = {"x": P(("pod", "data"), None)}
    out = sanitize_pspecs(specs, {"x": _meta((64, 8))}, mesh)
    assert out["x"] == P(("pod", "data"), None)      # 64 % 32 == 0
    out2 = sanitize_pspecs(specs, {"x": _meta((40, 8))}, mesh)
    assert out2["x"] == P(None, None)                # 40 % 32 != 0


def test_sanitize_replicates_size_one_dims():
    """A dim of size 1 is never sharded, even over an axis of size 1
    (DTensor cannot squeeze a sharded dim, as a matmul's fold of a batch
    of 1 would)."""
    mesh = fake_mesh(data=1, model=1)
    out = sanitize_pspecs({"x": P("data", "model")}, {"x": _meta((1, 8))},
                          mesh)
    assert out["x"] == P(None, "model")


def test_cache_specs_shape_aware():
    kshape = {"k": _meta((24, 128, 32768, 2, 64)),
              "v": _meta((24, 128, 32768, 2, 64))}
    specs = cache_pspecs(kshape, ("data",), tp_size=16)
    # kv=2 not divisible -> model axis lands on sequence
    assert specs["k"] == P(None, ("data",), "model", None, None)
    specs32 = cache_pspecs({"k": _meta((24, 128, 32768, 32, 64))},
                           ("data",), tp_size=16)
    assert specs32["k"] == P(None, ("data",), None, "model", None)


def test_drop_fsdp_removes_data_axis_only():
    specs = {"w": P("data", "model"), "o": P("model", "data"),
             "tup": P(("pod", "data"), None), "norm": P(None)}
    out = drop_fsdp(specs)
    assert out["w"] == P(None, "model")
    assert out["o"] == P("model", None)
    assert out["tup"] == P(("pod",), None)
    assert out["norm"] == P(None)


def test_constrain_is_identity_outside_context():
    from repro_torch.distributed.logical import (activation_rules,
                                                 constrain, standard_rules)
    x = torch.ones((4, 4))
    assert constrain(x, "btd") is x
    # a plain tensor, or a name without a rule, is left alone in a context
    with activation_rules(None, standard_rules(("data",))):
        assert constrain(x, "btd") is x
        assert constrain(x, "nope") is x


def test_moe_dp_chunks_reads_context():
    from repro_torch.distributed.logical import (activation_rules,
                                                 moe_dp_chunks)
    assert moe_dp_chunks() == 0
    with activation_rules(None, {"_moe_dp": 16}):
        assert moe_dp_chunks() == 16
    assert moe_dp_chunks() == 0


def test_standard_rules_equal_reference():
    from repro.distributed.logical import standard_rules as jrules
    from repro_torch.distributed.logical import standard_rules
    for dp, rb in ((("data",), False), (("pod", "data"), False),
                   (("data",), True)):
        ours, ref = standard_rules(dp, replicate_batch=rb), \
            jrules(dp, replicate_batch=rb)
        assert set(ours) == set(ref)
        for k in ref:
            assert _as_tuple(ours[k]) == _as_tuple(ref[k]), k


def _jax_pshape(cfg, dtype=jnp.bfloat16):
    model = JModel(cfg, dtype=dtype)
    pshape = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    return jax.tree.map(lambda l: jax.ShapeDtypeStruct(
        l.shape, dtype if l.dtype == jnp.float32 else l.dtype), pshape)


def _jax_flat(tree, prefix=""):
    out = {}
    for k in tree:
        v = tree[k]
        if isinstance(v, dict):
            out.update(_jax_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_param_specs_equal_reference(arch, mesh_kind):
    """The port's sanitized param spec tree of the full config equals the
    reference's leaf by leaf on the production mesh, and each leaf's
    local shard holds a whole share of the bytes."""
    mesh = fake_mesh(**MESHES[mesh_kind])
    jshape = _jax_pshape(jget_config(arch))
    ref = _jax_flat(jsh.sanitize_pspecs(jsh.param_pspecs(jshape), jshape,
                                        mesh))
    tshape = params_shape(get_config(arch), torch.bfloat16)
    ours = _flat(sanitize_pspecs(param_pspecs(tshape), tshape, mesh))
    assert set(ours) == set(ref)
    flat = _flat(tshape)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    for k in ref:
        assert _as_tuple(ours[k]) == _as_tuple(ref[k]), k
        n = local_bytes(flat[k].shape, 2, ours[k], sizes)
        assert flat[k].numel() * 2 % n == 0


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_cache_specs_equal_reference(arch, shape_name):
    """``cache_pspecs`` (sanitized) of the decode shapes' caches equals the
    reference's on the production mesh."""
    mesh = fake_mesh(**MESHES["single"])
    jcfg = jadapt(jget_config(arch), JSHAPES[shape_name])
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    jm = JModel(jcfg, dtype=jnp.bfloat16)
    jcache = jax.eval_shape(lambda: jm.init_cache(b, s))
    shard_seq = b == 1
    ref = jsh.sanitize_pspecs(jsh.cache_pspecs(
        jcache, ("data",), shard_seq=shard_seq, tp_size=16), jcache, mesh)
    tcfg = adapt_config(get_config(arch), shape)
    tcache = Model(tcfg, dtype=torch.bfloat16, device="meta").init_cache(b, s)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    ours = sanitize_pspecs(cache_pspecs(tcache, ("data",),
                                        shard_seq=shard_seq, tp_size=16),
                           tcache, mesh)
    assert set(ours) == set(ref)
    for k in ref:
        assert _as_tuple(ours[k]) == _as_tuple(ref[k]), k


def test_placements_cover_tuple_axes():
    """One placement per mesh dim: ``Shard(d)`` where the spec names the
    mesh dim on tensor dim d (both dims of a tuple, major first), else
    ``Replicate()``; an axis out of the mesh's order, or used twice,
    raises."""
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert placements(mesh, P(("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements(mesh, P(None, "data")) == \
        (Replicate(), Shard(1), Replicate())
    assert placements(mesh, P()) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        placements(mesh, P(("data", "pod")))
    with pytest.raises(ValueError):
        placements(mesh, P("data", "data"))


def test_local_bytes_counts_the_shard():
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert local_bytes((64, 32, 8), 2, P(("pod", "data"), "model", None),
                       sizes) == 2 * 2 * 2 * 8
    assert local_bytes((64, 32), 4, P(None, None), sizes) == 64 * 32 * 4


def test_spec_is_a_tuple():
    assert P(None, "data") == (None, "data")
    assert repr(P(None, ("pod", "data"))) == "P(None, ('pod', 'data'))"
