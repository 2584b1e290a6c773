"""The port's sharding rules (``repro_torch.parallel.sharding``, the
dry run's input layouts) against the JAX package's, exactly: the rules of
a mesh, every activation kind's spec, the spec of every parameter of the
ten published configurations (the reference's ``eval_shape`` of
``model.init`` beside the port's model built on fake tensors; a stacked
leaf's spec loses its leading ``None`` in the port; ``P()`` stays),
``fit_spec`` and the cache and batch layouts.  Meshes are device-free
on both sides (``jax.sharding.AbstractMesh``,
``repro_torch.launch.mesh.Mesh``)."""
import os

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs as JC
import repro_torch.configs as TC
from repro.parallel import sharding as JS
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TM
from repro_torch.models.transformer import build_model as port_build
from repro_torch.parallel import sharding as TS

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model")), ((4, 2), ("data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


def ref_dryrun():
    """The reference's dry-run module without its 512-device XLA_FLAGS
    (it sets them when imported, for the next backend start)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


def meshes(i):
    shape, names = MESHES[i]
    return AbstractMesh(shape, names), TM.Mesh(shape, names)


def rules(i):
    jm, tm = meshes(i)
    return JS.rules_for_mesh(jm), TS.rules_for_mesh(tm)


def test_production_and_test_meshes():
    assert TM.make_production_mesh().shape == {"data": 16, "model": 16}
    m = TM.make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.size == 512
    assert TM.make_test_mesh().axis_sizes == (2, 2)
    assert TM.card_mesh().size == 1
    with pytest.raises(ValueError):
        TM.Mesh((2,), ("data", "model"))


@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
def test_rules_for_mesh_equal_reference(i):
    jr, tr = rules(i)
    assert tuple(vars(tr).values()) == tuple(vars(jr).values())


ACT_SHAPES = [(8, 128, 4096), (3, 5, 7), (128, 1, 32000),
              (24, 128, 512, 16, 64), (24, 128, 512, 5, 128),
              (24, 128, 512, 3, 7), (32, 4, 40, 64, 64), (9, 16, 8)]


@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
def test_act_specs_equal_reference(i):
    jr, tr = rules(i)
    assert set(TS._ACT_SPECS) == set(JS._ACT_SPECS)
    for kind in JS._ACT_SPECS:
        for shape in ACT_SHAPES:
            if kind in ("cache", "cache_seqshard") and len(shape) != 5:
                continue
            if kind == "state" and len(shape) < 3:
                continue
            want = tuple(JS._ACT_SPECS[kind](jr, shape))
            assert tuple(TS._ACT_SPECS[kind](tr, shape)) == want, \
                (kind, shape)


def test_act_is_identity_and_checks_kind():
    x = torch.zeros(2, 3, 4)
    assert TS.act(x, "no-such-kind") is x          # no rules: identity
    with TS.use_rules(TS.rules_for_mesh(TM.card_mesh())):
        assert TS.current_rules().tp == "model"
        assert TS.act(x, "hidden") is x
        with pytest.raises(KeyError):
            TS.act(x, "no-such-kind")
    assert TS.current_rules() is None


def _ref_leaves(params_sds, specs):
    """(reference slash path, stacked?, spec tuple) of every leaf."""
    paths = jax.tree_util.tree_flatten_with_path(params_sds)[0]
    flat_specs = jax.tree.leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    out = []
    for (path, _), spec in zip(paths, flat_specs):
        ps = JS._path_str(path)
        stacked = ps.split("/")[0] in ("blocks", "enc_blocks", "dec_blocks",
                                       "superblocks")
        out.append((ps, stacked, tuple(spec)))
    return out


def _port_names(ref_path, stacked, cfg):
    """The port parameter names that slice the reference leaf."""
    parts = ref_path.split("/")
    if not stacked:
        return [".".join(parts)]
    if parts[0] == "superblocks":
        n = cfg.n_layers // cfg.attn_every
    elif parts[0] == "enc_blocks":
        n = cfg.n_enc_layers
    else:
        n = cfg.n_layers
    return [".".join([parts[0], str(g), *parts[1:]]) for g in range(n)]


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_param_specs_equal_reference(arch):
    from repro.models.transformer import build_model as jax_build

    jcfg, tcfg = JC.get(arch).CONFIG, TC.get(arch).CONFIG
    params_sds = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    with FakeTensorMode():
        named = dict(port_build(tcfg, device="cpu").named_parameters())
    seen = set()
    for i in (0, 1):                     # the single- and multi-pod meshes
        jr, tr = rules(i)
        got = TS.param_specs(named, tr)
        for ps, stacked, want in _ref_leaves(
                params_sds, JS.param_specs(params_sds, jr)):
            if stacked and want:         # P() replicates: nothing to drop
                assert want[0] is None, ps
                want = want[1:]
            for name in _port_names(ps, stacked, tcfg):
                assert tuple(got[name]) == want, (name, got[name], want)
                seen.add(name)
        shard = TS.param_shardings(named, meshes(i)[1])
        assert {n: s.spec for n, s in shard.items()} == got
    assert seen == set(named)


FIT_CASES = [((("data", "model"), None), (32, 48)),
             (("model", "data"), (8, 3)),
             ((None, ("pod", "data"), "model"), (5, 64, 16)),
             (("data",), (7, 2, 2))]


@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
def test_fit_spec_equal_reference(i):
    from jax.sharding import PartitionSpec

    ref = ref_dryrun()
    jm, tm = meshes(i)
    for spec, shape in FIT_CASES:
        if any(a not in tm.axis_names for p in spec if p
               for a in ((p,) if isinstance(p, str) else p)):
            continue
        want = tuple(ref._fit_spec(PartitionSpec(*spec), shape, jm))
        assert tuple(TS.fit_spec(TS.P(*spec), shape, tm.shape)) == want


@pytest.mark.parametrize("arch,seq", [("yi_6b", False), ("qwen1_5_32b", False),
                                      ("jamba_1_5_large", True),
                                      ("jamba_1_5_large", False),
                                      ("rwkv6_3b", False),
                                      ("whisper_small", False)])
def test_cache_and_batch_shardings_equal_reference(arch, seq):
    """The decode cache's and batch's layouts at SMOKE size (the specs
    depend on the rank and the head counts, not the widths)."""
    import jax.numpy as jnp

    from repro.models.transformer import build_model as jax_build

    ref = ref_dryrun()
    jcfg, tcfg = JC.get(arch).SMOKE, TC.get(arch).SMOKE
    jmodel = jax_build(jcfg)
    if jcfg.is_encoder_decoder:
        jcache = jax.eval_shape(lambda: jmodel.init_cache(
            4, 16, enc_len=16, dtype=jnp.bfloat16))
    elif jcfg.family == "ssm":
        jcache = jax.eval_shape(lambda: jmodel.init_cache(4))
    else:
        jcache = jax.eval_shape(lambda: jmodel.init_cache(
            4, 16, dtype=jnp.bfloat16))
    with FakeTensorMode():
        tmodel = port_build(tcfg, device="cpu")
        if tcfg.is_encoder_decoder:
            tcache = tmodel.init_cache(4, 16, enc_len=16)
        elif tcfg.family == "ssm":
            tcache = tmodel.init_cache(4)
        else:
            tcache = tmodel.init_cache(4, 16)
    assert set(tcache) == set(jcache)
    cell = TC.get(arch).CELLS["decode_32k"]
    batch = TC.input_specs(tcfg, cell)
    jbatch = {k: jax.ShapeDtypeStruct(v.shape, jnp.int32)
              for k, v in batch.items()}
    for i in range(len(MESHES)):
        jm, tm = meshes(i)
        jr, tr = rules(i)
        want = ref._cache_shardings(jcache, jm, jr, seq)
        got = TD._cache_shardings(tcache, tm, tr, seq)
        for k in jcache:
            assert tuple(got[k].spec) == tuple(want[k].spec), (k, i)
        want = ref._batch_shardings(jbatch, jm, jr)
        got = TD._batch_shardings(batch, tm, tr)
        for k in jbatch:
            assert tuple(got[k].spec) == tuple(want[k].spec), (k, i)
