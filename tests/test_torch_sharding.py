"""The port's sharding vocabulary (``repro_torch.dist.sharding``) against
the JAX package's: the spec trees of every family's reduced config equal
JAX's leaf by leaf (as tuples) on the (2, 4), (16, 16) and (2, 16, 16)
meshes, both sides given a duck-typed mesh (``axis_names``, ``shape``):
``param_pspecs`` under 'fsdp_tp', 'ddp' and 'serve', ``cache_pspecs``
with sequence sharding on and off, ``paged_cache_pspecs`` quantized and
not, and the batch pspecs.  ``local_block`` cuts blocks that tile the
whole tensor, which ``gather_block`` puts back together
(``test_torch_dist_decode.py`` runs that inverse over ranks).  The
ZeRO-1 specs (``optim.adamw.zero1_pspecs`` / ``opt_state_pspecs``) equal
JAX's over every family, strategy and mesh, and on the cases of JAX's
``test_zero1_pspecs_shard_replicated_dims``.  No ranks here."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import sharding as TSH  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

FAMILIES = ("tinyllama-1.1b", "qwen1.5-0.5b", "deepseek-v3-671b",
            "olmoe-1b-7b", "internvl2-2b", "seamless-m4t-large-v2",
            "zamba2-1.2b", "xlstm-350m")
MESHES = {"2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
PAGED = ("tinyllama-1.1b", "deepseek-v3-671b", "olmoe-1b-7b",
         "internvl2-2b", "seamless-m4t-large-v2")


def _mesh(shape):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def _cfgs(name):
    from repro import configs as jconfigs
    return (jconfigs.reduced(jconfigs.get_config(name)),
            tconfigs.reduced(tconfigs.get_config(name)))


def _flat(tree, path=()):
    """(path, spec tuple or None) of a spec tree: dicts by sorted key,
    NamedTuple states field by field."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _flat(v, path + (k,))
    else:
        yield path, None if tree is None else tuple(tree)


def _same(got, want):
    got, want = list(_flat(got)), list(_flat(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g == w, (path, g, w)
    return len(got)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", FAMILIES)
def test_spec_trees_equal_jax(name, mesh):
    from repro.dist import sharding as JSH

    jc, tc = _cfgs(name)
    m = _mesh(MESHES[mesh])
    for strategy in ("fsdp_tp", "ddp", "serve"):
        assert _same(TSH.param_pspecs(tc, m, strategy),
                     JSH.param_pspecs(jc, m, strategy)) > 0
    for batch in (4, 32, 3):
        for seq in (False, True):
            _same(TSH.cache_pspecs(tc, m, batch, seq_shard=seq),
                  JSH.cache_pspecs(jc, m, batch, seq_shard=seq))
            _same(TSH.decode_batch_pspecs(tc, m, batch, seq_shard=seq),
                  JSH.decode_batch_pspecs(jc, m, batch, seq_shard=seq))
            if name not in PAGED:
                continue
            for q8 in (False, True):
                if q8 and jc.family == "audio":
                    continue
                for n_pages in (None, 64, 30):
                    kw = dict(seq_shard=seq, n_pages=n_pages, quantized=q8)
                    _same(TSH.paged_cache_pspecs(tc, m, batch, **kw),
                          JSH.paged_cache_pspecs(jc, m, batch, **kw))
                    _same(TSH.paged_decode_batch_pspecs(tc, m, batch, **kw),
                          JSH.paged_decode_batch_pspecs(jc, m, batch, **kw))
    shapes = {"tokens": (32, 16), "labels": (32, 16), "mask": (3, 16),
              "cur_len": ()}
    _same(TSH.train_batch_pspecs(tc, m, {k: np.zeros(s) for k, s
                                         in shapes.items()}),
          JSH.train_batch_pspecs(jc, m, {k: np.zeros(s) for k, s
                                         in shapes.items()}))


SERVED = {"tinyllama-1.1b": {}, "qwen1.5-0.5b": {}, "olmoe-1b-7b": {},
          "olmoe-1b-7b-6": {"n_experts": 6}}


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)],
                         ids=["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("name", list(SERVED))
def test_served_spec_trees_equal_jax(name, mesh):
    """The layouts tensor-parallel serving cuts its parameters by:
    ``param_pspecs(..., 'serve')`` of the configs it serves, on the
    meshes its tests run, leaf by leaf JAX's (olmoe's 8 experts over
    every axis, 6 over none with ``expert_ff`` over 'model')."""
    import dataclasses

    from repro.dist import sharding as JSH

    jc, tc = _cfgs(name.rsplit("-", 1)[0] if SERVED[name] else name)
    if SERVED[name]:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, **SERVED[name]))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, **SERVED[name]))
    m = _mesh({"data": mesh[0], "model": mesh[1]})
    assert _same(TSH.param_pspecs(tc, m, "serve"),
                 JSH.param_pspecs(jc, m, "serve")) > 0
    for B in (4, 3):
        _same(TSH.cache_pspecs(tc, m, B), JSH.cache_pspecs(jc, m, B))
        for q8 in (False, True):
            _same(TSH.paged_cache_pspecs(tc, m, B, quantized=q8),
                  JSH.paged_cache_pspecs(jc, m, B, quantized=q8))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", FAMILIES)
def test_zero1_spec_trees_equal_jax(name, mesh):
    """``zero1_pspecs`` over each strategy's parameter specs, and
    ``opt_state_pspecs`` with ZeRO-1 on and off, in fp32 and bf16 (the
    master copies' subtree), leaf by leaf equal to JAX's."""
    from repro.dist import sharding as JSH
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw

    jc, tc = _cfgs(name)
    m = _mesh(MESHES[mesh])
    for dtype in ("float32", "bfloat16"):
        jcd, tcd = jc.replace(dtype=dtype), tc.replace(dtype=dtype)
        javals, tavals = jlm.abstract_init(jcd), tlm.model_spec(tcd)
        for strategy in ("fsdp_tp", "ddp", "serve"):
            tps = TSH.param_pspecs(tcd, m, strategy)
            jps = JSH.param_pspecs(jcd, m, strategy)
            assert _same(tadamw.zero1_pspecs(tps, tavals, m),
                         jadamw.zero1_pspecs(jps, javals, m)) > 0
            for zero1 in (True, False):
                _same(tadamw.opt_state_pspecs(
                    tadamw.OptConfig(), tps, tavals, m, zero1=zero1),
                    jadamw.opt_state_pspecs(
                    jadamw.OptConfig(), jps, javals, m, zero1=zero1))


def test_zero1_pspecs_jax_cases():
    """JAX's ``test_zero1_pspecs_shard_replicated_dims`` on the port, and
    the port's whole parameters (``adamw.replicated``) on (4, 2)."""
    from jax.sharding import PartitionSpec as JPS
    from repro.optim import adamw as jadamw

    m = _mesh({"data": 4, "model": 2})
    avals = {"w": types.SimpleNamespace(shape=(64, 32)),
             "b": types.SimpleNamespace(shape=(64,))}
    z = tadamw.zero1_pspecs({"w": TSH.PS(None, "model"),
                             "b": TSH.PS(None)}, avals, m)
    assert z["w"] == TSH.PS("data", "model") and z["b"] == TSH.PS("data")
    jz = jadamw.zero1_pspecs({"w": JPS(None, "model"), "b": JPS(None)},
                             avals, m)
    _same(z, jz)
    # a whole (64, 32) leaf: the larger dim; a (3,) one: no dim divides
    rep = {"w": torch.zeros(64, 32), "b": torch.zeros(3)}
    z = tadamw.zero1_pspecs(tadamw.replicated(rep), rep, m)
    assert z == {"w": TSH.PS("data", None), "b": TSH.PS(None)}
    assert tadamw.block_shape((64, 32), z["w"],
                              Mesh(m.shape, {"data": 1})) == (16, 32)


def test_rules_and_axes_equal_jax():
    from repro.dist import sharding as JSH

    jc, tc = _cfgs("deepseek-v3-671b")
    for shape in MESHES.values():
        m = _mesh(shape)
        assert TSH.data_axes(m) == JSH.data_axes(m)
        assert TSH.data_size(m) == JSH.data_size(m)
        assert TSH.model_axis(m) == JSH.model_axis(m)
        for strategy in ("fsdp_tp", "ddp", "serve"):
            assert TSH.rules(tc, m, strategy) == JSH.rules(jc, m, strategy)
    with pytest.raises(ValueError, match="unknown sharding strategy"):
        TSH.rules(tc, _mesh(MESHES["2x4"]), "zero3")


def test_production_mesh_is_abstract():
    m = make_production_mesh()
    assert m.axis_names == ("data", "model") and m.shape == {
        "data": 16, "model": 16} and not m.groups and m.size == 256
    m = make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.size == 512


@pytest.mark.parametrize("spec", [
    TSH.PS(None, "model", None), TSH.PS("data", "model", None),
    TSH.PS(("pod", "data"), None, "model"), TSH.PS(None, None, None)])
def test_local_blocks_tile_the_whole_tensor(spec):
    """Every coordinate's ``local_block`` is the tensor's block at that
    coordinate, and the blocks together cover it once."""
    shape = {"pod": 2, "data": 2, "model": 4}
    x = torch.arange(4 * 8 * 8, dtype=torch.float32).view(4, 8, 8)
    seen = torch.zeros_like(x)
    for p in range(2):
        for d in range(2):
            for mm in range(4):
                mesh = Mesh(shape, {"pod": p, "data": d, "model": mm})
                blk = TSH.local_block(x, spec, mesh)
                assert blk.is_contiguous()
                index = []
                for dim, entry in enumerate(spec):
                    i, n = TSH._block_index(mesh, TSH._flat(entry))
                    per = x.shape[dim] // n
                    index.append(slice(i * per, (i + 1) * per))
                torch.testing.assert_close(blk, x[tuple(index)],
                                           rtol=0, atol=0)
                seen[tuple(index)] += 1
    # replicated dims give every coordinate the same block
    copies = 16 // np.prod([TSH._block_index(mesh, TSH._flat(e))[1]
                            for e in spec])
    assert bool((seen == copies).all())
    with pytest.raises(ValueError, match="does not split"):
        TSH.local_block(torch.zeros(3, 5), TSH.PS(None, "model"),
                        Mesh(shape, {"pod": 0, "data": 0, "model": 1}))
