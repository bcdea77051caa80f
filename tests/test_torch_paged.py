"""The port's paged KV path against the JAX package's: the two paged
decode kernels (plain versions on the CPU), int8 quantization, the pool
writes, ``paged_decode_step`` and the paged engine.

Inputs are made with numpy from a seed and handed to both sides in
fp32.  Tolerances: 1e-5 (atol and rtol) on the decode partials, where
both sides accumulate in fp32 and differ only in summation order;
int8 values, scales and pools bit-equal (the same fp32 arithmetic, and
``torch.round`` rounds half to even as ``jnp.round`` does); logits 1e-4
of their scale (max |logit|, at least 1), as ``test_torch_lm.py``
holds them; greedy tokens identical.  The JAX side runs its Pallas
kernels in interpret mode and its engine on an explicit (1, 1) mesh
with Auto axes (the default mesh fails under JAX 0.9, ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.dist import decode as jdd  # noqa: E402
from repro.engine import DecodeEngine as JEngine  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import paged_cache as jpc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quant as jquant  # noqa: E402
from repro.kernels import vwr_decode as jvd  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.dist import decode as tdd  # noqa: E402
from repro_torch.engine import DecodeEngine, EngineConfig  # noqa: E402
from repro_torch.engine import paged_cache as tpc  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant as tquant  # noqa: E402
from repro_torch.kernels import vwr_decode as KD  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = 1e-4
NAMES = ["tinyllama-1.1b", "qwen1.5-0.5b"]


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _logits_close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= LOGIT_TOL * scale, \
        f"{what}: max|d| {err:.3g} > {LOGIT_TOL * scale:.3g}"


# ---------------------------------------------------------------- ops

# (B, G, KV, lens per slot, J): a slot with lens 0 (inactive), ragged
# last pages (lens not a page multiple), a table wider than the live
# pages (J past the longest slot), G = 1 and G = 4
OP_CASES = [
    (3, 4, 2, (13, 0, 7), 5),
    (2, 1, 4, (16, 9), 6),
    (4, 4, 1, (1, 4, 0, 17), 8),
]


def _op_case(B, G, KV, lens, J, q8, seed=0):
    """Pools, a permuted block table with junk past the live pages
    (out-of-range ids too: both wrappers clamp), counts and q."""
    rng = np.random.default_rng(seed)
    ps, D, n_pages = 4, 16, 24
    q = rng.standard_normal((B, KV * G, D)).astype(np.float32)
    shape = (n_pages, ps, KV, D)
    if q8:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (n_pages, KV)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (n_pages, KV)).astype(np.float32)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    perm = rng.permutation(n_pages)
    table = rng.integers(-3, n_pages + 3, (B, J)).astype(np.int32)
    k = 0
    for b, n in enumerate(lens):
        live = -(-n // ps)
        table[b, :live] = perm[k:k + live]
        k += live
    counts = tdd._page_counts(np.asarray(lens), J, ps)
    return q, kp, vp, ks, vs, table, counts


def test_page_counts_match_jax():
    lens = np.array([0, 1, 4, 5, 13, 16], np.int32)
    np.testing.assert_array_equal(
        tdd._page_counts(lens, 5, 4),
        np.asarray(jdd._page_counts(jnp.asarray(lens), 5, 4)))


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", OP_CASES, ids=["G4", "G1", "G4-KV1"])
def test_paged_decode_plain_matches_jax_kernel(case, q8):
    """The kernel-layout plain versions against the Pallas kernels
    (interpret mode) on the clamped table the JAX wrapper passes."""
    B, G, KV, lens, J = case
    q, kp, vp, ks, vs, table, counts = _op_case(*case, q8=q8)
    D = q.shape[-1]
    qg = q.reshape(B * KV, G, D)
    tbl = np.clip(table, 0, kp.shape[0] - 1)
    if q8:
        want = jvd.vwr_paged_flash_decode_q8_p(
            *(jnp.asarray(a) for a in (qg, kp, vp, ks, vs, tbl, counts)),
            interpret=True)
        got = KD.vwr_paged_flash_decode_q8(
            *(_t(a) for a in (qg, kp, vp, ks, vs, table, counts)))
    else:
        want = jvd.vwr_paged_flash_decode_p(
            *(jnp.asarray(a) for a in (qg, kp, vp, tbl, counts)),
            interpret=True)
        got = KD.vwr_paged_flash_decode(
            *(_t(a) for a in (qg, kp, vp, table, counts)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)
    # an inactive slot: m = -1e30, l = 0, o_tilde = 0
    for b, n in enumerate(lens):
        if n == 0:
            rows = slice(b * KV, (b + 1) * KV)
            assert torch.all(got[0][rows] == 0)
            assert torch.all(got[1][rows] == KD.NEG_INF)
            assert torch.all(got[2][rows] == 0)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", OP_CASES, ids=["G4", "G1", "G4-KV1"])
def test_paged_decode_ops_match_jax(case, q8):
    """The (B, H, D) wrappers and registry ops ('torch' and 'cuda')
    against the JAX wrappers and the XLA gather reference."""
    q, kp, vp, ks, vs, table, counts = _op_case(*case, q8=q8, seed=1)
    jq = [jnp.asarray(a) for a in (q, kp, vp)]
    tq = [_t(a) for a in (q, kp, vp)]
    jt, tt = (jnp.asarray(table), jnp.asarray(counts)), \
        (_t(table), _t(counts))
    if q8:
        jsc, tsc = (jnp.asarray(ks), jnp.asarray(vs)), (_t(ks), _t(vs))
        want = jops.vwr_paged_flash_decode_q8(*jq, *jsc, *jt)
        ref = jattn.paged_flash_decode_partial(
            jq[0], jq[1].astype(jnp.float32) * jsc[0][:, None, :, None],
            jq[2].astype(jnp.float32) * jsc[1][:, None, :, None], *jt)
        gots = [ops.vwr_paged_flash_decode_q8(*tq, *tsc, *tt)] + [
            tattn.D.dispatch("decode_partial_paged_q8", be, *tq, *tsc, *tt)
            for be in ("torch", "cuda")]
    else:
        want = jops.vwr_paged_flash_decode(*jq, *jt)
        ref = jattn.paged_flash_decode_partial(*jq, *jt)
        gots = [ops.vwr_paged_flash_decode(*tq, *tt),
                tattn.paged_flash_decode_partial(*tq, *tt)] + [
            tattn.D.dispatch("decode_partial_paged", be, *tq, *tt)
            for be in ("torch", "cuda")]
    for w, r in zip(want, ref):
        _close(w, r)
    for got in gots:
        for g, w in zip(got, want):
            _close(g.numpy(), w)


def test_paged_decode_cpu_runs_plain_version_uncounted():
    q, kp, vp, _, _, table, counts = _op_case(*OP_CASES[0], q8=False)
    build.reset_launches()
    ops.vwr_paged_flash_decode(*(_t(a) for a in (q, kp, vp, table,
                                                 counts)))
    assert all(n == 0 for n in build.LAUNCHES.values())


def test_paged_decode_non_cuda_device_raises():
    """Only CPU tensors take the plain version."""
    m = torch.empty(2, 4, 64, device="meta")
    pool = torch.empty(8, 4, 1, 64, device="meta")
    tbl = torch.empty(2, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        KD.vwr_paged_flash_decode(m, pool, pool, tbl, tbl)
    scale = torch.empty(8, 1, device="meta")
    pool8 = pool.to(torch.int8)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        KD.vwr_paged_flash_decode_q8(m, pool8, pool8, scale, scale, tbl,
                                     tbl)


# ---------------------------------------------------------------- quant

@pytest.mark.parametrize("axis", [None, -1, (1, 3)])
def test_quant_matches_jax_bit_exact(axis):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 2, 8)) * 3).astype(np.float32)
    x[0, 0] = 0.0                       # an all-zero group: QEPS floor
    x[1, 1, 0, :2] = 127 * 0.5          # exact .5 ties on the grid
    jq, js = jquant.quantize_int8(jnp.asarray(x), axis=axis)
    tq, ts = tquant.quantize_int8(_t(x), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tquant.dequantize_int8(tq, ts).numpy(),
        np.asarray(jquant.dequantize_int8(jq, js)))
    assert tquant.QEPS == jquant.QEPS


# ---------------------------------------------------------------- pools

def _pool_cfgs():
    jc = jconfigs.reduced(jconfigs.get_config("tinyllama-1.1b"))
    tc = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b"))
    return jc, tc


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_write_prefill_matches_jax(kv_dtype):
    """Prefill material of two requests (S = 7: a ragged last page)
    scattered into permuted pages of a pool that holds stale bytes: the
    pools and scales come out bit-equal."""
    jc, tc = _pool_cfgs()
    rng = np.random.default_rng(5)
    L, S, KV, Dh, ps, n_pages = jc.n_layers, 7, jc.n_kv_heads, \
        jc.d_head, 4, 9
    kv = [rng.standard_normal((L, 2, S, KV, Dh)).astype(np.float32)
          for _ in range(2)]
    table = np.zeros((2, 3), np.int32)
    table[:, :2] = rng.permutation(n_pages)[:4].reshape(2, 2)
    jcache = jpc.init_paged_cache(jc, n_pages, ps, 2, kv_dtype=kv_dtype)
    tcache = tpc.init_paged_cache(tc, n_pages, ps, kv_dtype=kv_dtype,
                                  device="cpu")
    stale = {k: rng.integers(-50, 50, v.shape).astype(v.dtype)
             for k, v in jcache.items()}
    jcache = {k: jnp.asarray(v) for k, v in stale.items()}
    for k, v in stale.items():
        tcache[k].copy_(_t(v))
    jcache = jpc.write_prefill(jc, jcache, tuple(map(jnp.asarray, kv)),
                               jnp.asarray(table))
    tpc.write_prefill(tc, tcache, tuple(map(_t, kv)), table)
    assert set(tcache) == set(jcache)
    for k in jcache:
        assert str(tcache[k].dtype) == f"torch.{jcache[k].dtype}"
        np.testing.assert_array_equal(tcache[k].numpy(),
                                      np.asarray(jcache[k]), err_msg=k)


def test_scatter_pages_q8_matches_jax():
    rng = np.random.default_rng(6)
    kv = rng.standard_normal((2, 1, 10, 3, 8)).astype(np.float32)
    table = np.array([[4, 1, 6, 0]], np.int32)
    pool = rng.integers(-9, 9, (2, 7, 4, 3, 8)).astype(np.int8)
    scales = rng.uniform(0.1, 1, (2, 7, 3)).astype(np.float32)
    jp, js = jpc._scatter_pages_q8(jnp.asarray(pool), jnp.asarray(scales),
                                   jnp.asarray(kv), jnp.asarray(table))
    tp, ts = _t(pool.copy()), _t(scales.copy())
    tpc._scatter_pages_q8(tp, ts, _t(kv), table)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the pad rows of the ragged last page (positions 10, 11) are zero
    assert torch.all(tp[:, 6, 2:] == 0)


def test_quantized_page_write_matches_jax():
    """Decode writes over a fill of two pages: slot 0 (length 3) crosses
    into a page holding stale bytes at offset 0 (scale reset, the rest of
    the page scrubbed), slot 1 (length 1) fills its pages with tokens
    that grow louder (the scale grows monotonically and resident rows
    requantize), slot 2 is inactive (length 0) and writes nothing.
    Pools and scales stay bit-equal to the JAX function's."""
    rng = np.random.default_rng(8)
    n_pages, ps, KV, Dh = 8, 4, 2, 8
    pool = rng.integers(-100, 100, (n_pages, ps, KV, Dh)).astype(np.int8)
    scales = rng.uniform(0.01, 0.2, (n_pages, KV)).astype(np.float32)
    table = np.array([[3, 5, 7], [1, 4, 6], [0, 2, 6]], np.int32)
    lens = np.array([3, 1, 0], np.int32)
    jp, js = jnp.asarray(pool), jnp.asarray(scales)
    tp, ts = _t(pool.copy()), _t(scales.copy())
    for step in range(7):
        x = (rng.standard_normal((3, KV, Dh)) * (1 + step)).astype(
            np.float32)
        jpages, joffs, _ = jlm._page_write_ids(
            jnp.asarray(table), jnp.asarray(lens), ps, n_pages)
        jp, js = jpc.quantized_page_write(jp, js, jpages, joffs,
                                          jnp.asarray(x))
        act, pages, offs, _ = lm._page_write_ids(table, lens, ps)
        tpc.quantized_page_write(tp, ts, _t(pages), _t(offs), _t(x[act]))
        lens = lens + (lens > 0)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp),
                                      err_msg=f"step {step}")
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js),
                                      err_msg=f"step {step}")
        if step == 1:                   # slot 0's offset-0 write
            assert torch.all(tp[5, 1:] == 0)
    np.testing.assert_array_equal(tp.numpy()[[0, 2]], pool[[0, 2]])
    np.testing.assert_array_equal(ts.numpy()[[0, 2]], scales[[0, 2]])


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("jimpl,timpl", [("xla", "torch"),
                                         ("pallas", "cuda")])
def test_paged_decode_step_matches_jax(name, kv_dtype, jimpl, timpl):
    """Two active slots of different lengths (prefilled batch 1 into
    permuted pages) and one inactive slot, 8 paged decode steps fed the
    JAX greedy tokens: the active rows' logits agree at 1e-4 of scale
    and pick the same tokens ('bf16' pools hold the fp32 model dtype)."""
    jc = jconfigs.reduced(jconfigs.get_config(name)).replace(
        kernel_impl=jimpl)
    tc = tconfigs.reduced(tconfigs.get_config(name)).replace(
        kernel_impl=timpl)
    params = jlm.init(jc, jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(9)
    ps, n_pages, J, steps = 4, 16, 5, 8
    prompts = [rng.integers(0, jc.vocab, (P,)).astype(np.int32)
               for P in (6, 9)]
    table = np.zeros((3, J), np.int32)
    table[:2] = rng.permutation(n_pages)[:2 * J].reshape(2, J)
    jcache = jpc.init_paged_cache(jc, n_pages, ps, 3, kv_dtype=kv_dtype)
    tcache = tpc.init_paged_cache(tc, n_pages, ps, kv_dtype=kv_dtype,
                                  device="cpu")
    tok = np.zeros((3,), np.int32)
    for b, p in enumerate(prompts):
        jl, jkv = jlm.prefill(params, {"tokens": jnp.asarray(p)[None]}, jc)
        _, tkv = lm.prefill(tp, {"tokens": _t(p)[None]}, tc)
        jcache = jpc.write_prefill(jc, jcache, jkv,
                                   jnp.asarray(table[b:b + 1]))
        tpc.write_prefill(tc, tcache, tkv, table[b:b + 1])
        tok[b] = int(jnp.argmax(jl[0]))
    lens = np.array([6, 9, 0], np.int32)
    jstep = jax.jit(lambda p, b: jlm.paged_decode_step(p, b, jc))
    for i in range(steps):
        jl, jcache = jstep(params, {
            "token": jnp.asarray(tok), "cur_len": jnp.asarray(lens),
            "block_table": jnp.asarray(table), "cache": jcache})
        tl, tcache = lm.decode_step(tp, {
            "token": tok, "cur_len": lens, "block_table": table,
            "cache": tcache}, tc)
        assert tl.dtype == torch.float32 and tl.shape == (3,
                                                          tc.vocab_padded)
        _logits_close(tl.numpy()[:2], np.asarray(jl)[:2], f"step {i}")
        want = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy()[:2], want[:2])
        tok = np.where(lens > 0, want, 0).astype(np.int32)
        lens = lens + (lens > 0)


def test_paged_seq_sharded_decode_raises():
    tc = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b")).replace(
        decode_shard="seq")
    tp = lm.init(tc, seed=0, device="cpu")
    cache = tpc.init_paged_cache(tc, 4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        lm.decode_step(tp, {"token": np.zeros(1, np.int32),
                            "cur_len": np.ones(1, np.int32),
                            "block_table": np.zeros((1, 2), np.int32),
                            "cache": cache}, tc)


@pytest.mark.parametrize("B,W", [(1, 1), (3, 5), (4, 4)])
def test_paged_metadata_and_cache_layers_are_16_byte_aligned(B, W):
    """The kernels take every operand 16-byte aligned: each view of the
    step's packed metadata and each layer of the pools and scales
    starts on a 16-byte boundary, whatever B, W, n_pages and KV are,
    and the packed views hold what they were built from."""
    lens = np.arange(B, dtype=np.int32) * 3          # slot 0 inactive
    table = np.arange(B * W, dtype=np.int32).reshape(B, W)
    token = np.arange(B, dtype=np.int32) + 7
    meta = lm.paged_step_meta(token, lens, table, 4, torch.device("cpu"))
    for t in (meta.token, meta.pos, meta.table, meta.counts, meta.act,
              meta.pages, meta.offs):
        assert t.data_ptr() % 16 == 0
    np.testing.assert_array_equal(meta.token.numpy(), token)
    np.testing.assert_array_equal(meta.pos.numpy(), lens)
    np.testing.assert_array_equal(meta.table.numpy(), table)
    np.testing.assert_array_equal(
        meta.counts.numpy(), tdd._page_counts(lens + (lens > 0), W, 4))
    np.testing.assert_array_equal(meta.act.numpy(), np.flatnonzero(lens))
    tc = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b")).replace(
        n_kv_heads=1, n_heads=2)
    cache = tpc.init_paged_cache(tc, 7, 4, kv_dtype="int8", device="cpu")
    for name, t in cache.items():
        assert tuple(t.shape[1:2]) == (7,) and not t.any()
        for i in range(tc.n_layers):
            assert t[i].is_contiguous() and t[i].data_ptr() % 16 == 0, name


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_paged_generate_matches_dense_and_jax(name, kv_dtype):
    """The port's paged ``generate`` (kernel backend) gives the JAX
    paged engine's greedy tokens; with model-dtype pools it also gives
    the port's dense ``generate``'s."""
    B, P, GEN, ps = 2, 9, 7, 4
    jc = jconfigs.reduced(jconfigs.get_config(name))
    tc = tconfigs.reduced(tconfigs.get_config(name))
    ekw = dict(batch=B, max_len=P + GEN, paged=True, page_size=ps,
               kv_dtype=kv_dtype)
    jeng = JEngine(jc, JEngineConfig(**ekw), mesh=_mesh())
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, P),
                                             dtype=np.int32)
    want, _ = jeng.generate({"tokens": jnp.asarray(toks)}, gen=GEN)
    params = bridge.from_jax(jax.tree.map(np.asarray, jeng.params), "cpu")
    eng = DecodeEngine(tc, EngineConfig(**ekw, kernel_impl="cuda"),
                       params=params, device="cpu")
    got, _ = eng.generate({"tokens": _t(toks)}, gen=GEN)
    assert got.dtype == torch.int32 and got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kv_dtype == "bf16":
        dense = DecodeEngine(tc, EngineConfig(batch=B, max_len=P + GEN),
                             params=params, device="cpu")
        np.testing.assert_array_equal(
            got.numpy(), dense.generate({"tokens": _t(toks)},
                                        gen=GEN)[0].numpy())


def test_paged_engine_input_checks():
    tc = tconfigs.reduced(tconfigs.get_config("tinyllama-1.1b"))
    eng = DecodeEngine(tc, EngineConfig(batch=2, max_len=8, paged=True,
                                        page_size=4, n_pages=3),
                       device="cpu")
    assert (eng.page_size, eng.max_pages, eng.n_pages) == (4, 2, 3)
    cache = eng.init_paged_cache()
    assert cache["k"].shape == (tc.n_layers, 3, 4, tc.n_kv_heads,
                                tc.d_head)
    with pytest.raises(ValueError, match="block_table"):
        eng.decode_step(np.zeros(2, np.int32), 4, cache)
    with pytest.raises(ValueError, match="n_pages >= batch"):
        eng.default_block_table()       # 3 pages < 2 slots x 2 pages
    with pytest.raises(ValueError, match="recurrent state"):
        tpc.check_family(tc.replace(family="ssm"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        tpc.check_family(tc.replace(family="moe"))
    with pytest.raises(NotImplementedError, match="item 7"):
        tpc.fork_page(tc, cache, 0, 1)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs these there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q8", [False, True], ids=["pool", "int8"])
def test_cuda_paged_kernels_match_plain(cuda, dtype, q8):
    """Both paged kernels against their plain versions, with a slot of
    length 0, ragged pages, a permuted table and junk past the live
    pages; fp32 partials at 1e-4 (the summation order differs)."""
    dt = getattr(torch, dtype)
    for case in OP_CASES:
        q, kp, vp, ks, vs, table, counts = _op_case(*case, q8=q8)
        B, G, KV = case[:3]
        D = 64
        qg = torch.randn(B * KV, G, D, device=cuda).to(dt)
        shape = (kp.shape[0], kp.shape[1], KV, D)
        if q8:
            pools = [torch.randint(-127, 128, shape, device=cuda,
                                   dtype=torch.int8) for _ in range(2)]
            scales = [_t(a).to(cuda) for a in (ks, vs)]
        else:
            pools = [torch.randn(shape, device=cuda).to(dt)
                     for _ in range(2)]
            scales = []
        ints = [_t(a).to(cuda) for a in (table, counts)]
        fn = (KD.vwr_paged_flash_decode_q8 if q8
              else KD.vwr_paged_flash_decode)
        ref = (KD.vwr_paged_flash_decode_q8_ref if q8
               else KD.vwr_paged_flash_decode_ref)
        got = fn(qg, *pools, *scales, *ints)
        torch.cuda.synchronize()
        for g, w in zip(got, ref(qg, *pools, *scales, *ints)):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
