"""The port's sequence-sharded decode ops (``repro_torch.dist.decode``)
on a (2, 2) world of gloo CPU ranks, against the JAX package's local
ops on the same numpy inputs, at the JAX test's 1e-5.

One world runs every check (``_world``) and hands rank 0's results back;
the JAX side runs in this process.  Each rank cuts its blocks of the
whole inputs (``dist.sharding.local_block``: the dense batch over
'data', the cache sequence or the page pool over 'model') and the
replicated block tables as it sees them (``own_pages``), runs the
sharded op, and puts the outputs back together (``gather_block``).  The
cases: the dense GQA and MLA slabs (bf16-path and int8), one of them
with rank 1's slab empty; the paged GQA and MLA pools (model dtype and
int8) over a permuted table whose pages lie on either rank, with an
inactive slot; the chunk-prefix partials (GQA and MLA, int8 too), one
with J = 0; the routers' local fallbacks; the outputs bitwise equal on
both ranks of each model group."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro_torch.dist import decode as TDD  # noqa: E402
from repro_torch.dist import sharding as TSH  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
B, H, KV, DH, T = 2, 4, 2, 16, 32
R, ROPE, SCALE = 16, 8, 0.3
PS, NP, J = 4, 16, 5
SLOTS, C = 3, 3
LENS = np.array([13, 0, 19], np.int32)


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    i8 = lambda *s: rng.integers(-127, 128, s).astype(np.int8)  # noqa: E731
    sc = lambda *s: rng.uniform(0.005, 0.02, s).astype(np.float32)  # noqa
    table = rng.permutation(NP)[:SLOTS * J].reshape(SLOTS, J).astype(np.int32)
    return {
        "q": f(B, H, DH), "k": f(B, T, KV, DH), "v": f(B, T, KV, DH),
        "k8": i8(B, T, KV, DH), "v8": i8(B, T, KV, DH),
        "ks": sc(B, KV), "vs": sc(B, KV),
        "qa": f(B, H, R), "qr": f(B, H, ROPE), "ckv": f(B, T, R),
        "kr": f(B, T, ROPE), "ckv8": i8(B, T, R), "kr8": i8(B, T, ROPE),
        "cs": sc(B), "rs": sc(B),
        "pq": f(SLOTS, H, DH), "kp": f(NP, PS, KV, DH),
        "vp": f(NP, PS, KV, DH), "kp8": i8(NP, PS, KV, DH),
        "vp8": i8(NP, PS, KV, DH), "kps": sc(NP, KV), "vps": sc(NP, KV),
        "pqa": f(SLOTS, H, R), "pqr": f(SLOTS, H, ROPE),
        "cp": f(NP, PS, R), "rp": f(NP, PS, ROPE), "cp8": i8(NP, PS, R),
        "rp8": i8(NP, PS, ROPE), "cps": sc(NP), "rps": sc(NP),
        "table": table,
        "counts": TDD._page_counts(LENS, J, PS),
        "cq": f(C, H, DH), "cqa": f(C, H, R), "cqr": f(C, H, ROPE),
        "ctable": rng.permutation(NP)[:J].astype(np.int32),
        "ccounts": np.array([4, 4, 0, 4, 2], np.int32),
    }


def _world(mesh, x):
    """Every sharded op on this rank's blocks; the whole outputs."""
    torch.set_num_threads(1)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    PSp = TSH.PS
    rows, slab = PSp("data", None, None, None), PSp("data", "model", None,
                                                    None)

    def cut(name, spec):
        return TSH.local_block(t[name], spec, mesh)

    def rows_out(o):
        return TSH.gather_block(o, PSp("data", None, None), mesh)

    out = {}
    q = cut("q", rows[:3])
    for cur in (21, 10):              # 10: rank 1's slab [16, 32) empty
        out[f"gqa{cur}"] = rows_out(TDD.sharded_flash_decode(
            mesh, q, cut("k", slab), cut("v", slab), cur))
    out["gqa_q8"] = rows_out(TDD.sharded_flash_decode(
        mesh, q, cut("k8", slab), cut("v8", slab), 21,
        k_scale=cut("ks", PSp("data", None)),
        v_scale=cut("vs", PSp("data", None))))
    qa, qr = cut("qa", rows[:3]), cut("qr", rows[:3])
    for cur in (21, 10):
        out[f"mla{cur}"] = rows_out(TDD.sharded_mla_flash_decode(
            mesh, qa, qr, cut("ckv", slab[:3]), cut("kr", slab[:3]), cur,
            scale=SCALE))
    out["mla_q8"] = rows_out(TDD.sharded_mla_flash_decode(
        mesh, qa, qr, cut("ckv8", slab[:3]), cut("kr8", slab[:3]), 21,
        scale=SCALE, ckv_scale=cut("cs", PSp("data")),
        krope_scale=cut("rs", PSp("data"))))

    # pools over 'model', tables replicated, seen through own_pages
    pool = PSp("model", None, None, None)
    p0, pp = TSH.block_span(mesh, pool[0], NP)
    tbl, cnt = (torch.from_numpy(a) for a in TDD.own_pages(
        x["table"], x["counts"], p0, pp))
    out["paged"] = TDD.sharded_paged_flash_decode(
        mesh, t["pq"], cut("kp", pool), cut("vp", pool), tbl, cnt)
    out["paged_q8"] = TDD.sharded_paged_flash_decode(
        mesh, t["pq"], cut("kp8", pool), cut("vp8", pool), tbl, cnt,
        k_scale=cut("kps", PSp("model", None)),
        v_scale=cut("vps", PSp("model", None)))
    out["mla_paged"] = TDD.sharded_mla_paged_flash_decode(
        mesh, t["pqa"], t["pqr"], cut("cp", pool[:3]), cut("rp", pool[:3]),
        tbl, cnt, scale=SCALE)
    out["mla_paged_q8"] = TDD.sharded_mla_paged_flash_decode(
        mesh, t["pqa"], t["pqr"], cut("cp8", pool[:3]), cut("rp8", pool[:3]),
        tbl, cnt, scale=SCALE, ckv_scale=cut("cps", PSp("model")),
        krope_scale=cut("rps", PSp("model")))
    ct, cc = (torch.from_numpy(a) for a in TDD.own_pages(
        x["ctable"], x["ccounts"], p0, pp))
    out["chunk"] = TDD.sharded_chunk_prefix_attend(
        mesh, t["cq"], cut("kp", pool), cut("vp", pool), ct, cc)
    out["chunk_q8"] = TDD.sharded_chunk_prefix_attend(
        mesh, t["cq"], cut("kp8", pool), cut("vp8", pool), ct, cc,
        k_scale=cut("kps", PSp("model", None)),
        v_scale=cut("vps", PSp("model", None)))
    out["chunk_j0"] = TDD.chunk_prefix_attend(
        t["cq"], cut("kp", pool), cut("vp", pool), ct[:0], cc[:0],
        mesh=mesh)
    out["mla_chunk"] = TDD.sharded_mla_chunk_prefix_attend(
        mesh, t["cqa"], t["cqr"], cut("cp", pool[:3]), cut("rp", pool[:3]),
        ct, cc, scale=SCALE)
    out["mla_chunk_q8"] = TDD.sharded_mla_chunk_prefix_attend(
        mesh, t["cqa"], t["cqr"], cut("cp8", pool[:3]),
        cut("rp8", pool[:3]), ct, cc, scale=SCALE,
        ckv_scale=cut("cps", PSp("model")),
        krope_scale=cut("rps", PSp("model")))

    # the routers: sharded over a slab, local over a whole cache
    out["router_seq"] = rows_out(TDD.decode_attend(
        q, cut("k", slab), cut("v", slab), 21, mesh=mesh))
    out["router_whole"] = TDD.decode_attend(
        t["q"], t["k"], t["v"], 21, mesh=mesh, seq_shard=False)
    out["router_model1"] = TDD.decode_attend(
        t["q"], t["k"], t["v"], 21, mesh=mesh.fold("model"))
    out["gathered"] = TSH.gather_block(cut("k", slab), slab, mesh)
    out = {k: tuple(v.numpy() for v in o) if isinstance(o, tuple)
           else o.numpy() for k, o in out.items()}
    # the combine gives every rank the same bits
    ranks = mesh.gather_objects(out)
    out["same_on_every_rank"] = all(
        all(np.array_equal(a, b) for a, b in zip(_leaves(r[k]),
                                                  _leaves(ranks[0][k])))
        for r in ranks for k in out)
    return out


def _leaves(o):
    return o if isinstance(o, tuple) else (o,)


@pytest.fixture(scope="module")
def world():
    x = _inputs()
    return x, run_ranks(_world, 2, 2, args=(x,), device="cpu", threads=1)


def _j(*a):
    import jax.numpy as jnp
    return [jnp.asarray(v) for v in a]


def _close(got, want):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("case", ["gqa21", "gqa10", "gqa_q8", "router_seq",
                                  "router_whole", "router_model1"])
def test_dense_gqa_matches_jax_local(world, case):
    from repro.dist import decode as JDD
    x, got = world
    cur = 10 if case == "gqa10" else 21
    kw = {}
    k, v = x["k"], x["v"]
    if case == "gqa_q8":
        k, v = x["k8"], x["v8"]
        kw = dict(zip(("k_scale", "v_scale"), _j(x["ks"], x["vs"])))
    want = JDD.local_decode_attend(*_j(x["q"], k, v), cur, **kw,
                                   backend="xla")
    _close(got[case], want)


@pytest.mark.parametrize("case", ["mla21", "mla10", "mla_q8"])
def test_dense_mla_matches_jax_local(world, case):
    from repro.dist import decode as JDD
    x, got = world
    cur = 10 if case == "mla10" else 21
    ops = _j(x["qa"], x["qr"], x["ckv"], x["kr"])
    kw = {}
    if case == "mla_q8":
        ops = _j(x["qa"], x["qr"], x["ckv8"], x["kr8"])
        kw = dict(zip(("ckv_scale", "krope_scale"), _j(x["cs"], x["rs"])))
    want = JDD.local_mla_decode_attend(*ops, cur, scale=SCALE, **kw,
                                       backend="xla")
    _close(got[case], want)


@pytest.mark.parametrize("case", ["paged", "paged_q8", "mla_paged",
                                  "mla_paged_q8"])
def test_paged_matches_jax_local(world, case):
    """A permuted table (pages on either rank), an inactive slot."""
    from repro.dist import decode as JDD
    x, got = world
    tl = _j(x["table"], LENS)
    if case == "paged":
        want = JDD.local_paged_decode_attend(*_j(x["pq"], x["kp"], x["vp"]),
                                             *tl, backend="xla")
    elif case == "paged_q8":
        want = JDD.local_paged_decode_attend(
            *_j(x["pq"], x["kp8"], x["vp8"]), *tl, k_scale=_j(x["kps"])[0],
            v_scale=_j(x["vps"])[0], backend="xla")
    elif case == "mla_paged":
        want = JDD.local_mla_paged_decode_attend(
            *_j(x["pqa"], x["pqr"], x["cp"], x["rp"]), *tl, scale=SCALE,
            backend="xla")
    else:
        want = JDD.local_mla_paged_decode_attend(
            *_j(x["pqa"], x["pqr"], x["cp8"], x["rp8"]), *tl, scale=SCALE,
            ckv_scale=_j(x["cps"])[0], krope_scale=_j(x["rps"])[0],
            backend="xla")
    _close(got[case], want)
    # the inactive slot attends to nothing
    assert not np.asarray(got[case])[1].any()


@pytest.mark.parametrize("case", ["chunk", "chunk_q8", "chunk_j0",
                                  "mla_chunk", "mla_chunk_q8"])
def test_chunk_prefix_matches_jax_local(world, case):
    """Unnormalized (o~, m, l), a zero-count page mid-table; J == 0 stays
    local and gives the empty partial."""
    from repro.dist import decode as JDD
    from repro.kernels import dispatch as JD
    x, got = world
    tc = _j(x["ctable"], x["ccounts"])
    if case == "chunk_j0":
        o, m, l = got[case]
        assert o.shape == (C, H, DH) and not o.any() and not l.any()
        np.testing.assert_array_equal(m, np.full((C, H), -1e30, np.float32))
        return
    if case == "chunk":
        want = JDD.local_chunk_prefix_attend(*_j(x["cq"], x["kp"], x["vp"]),
                                             *tc, backend="xla")
    elif case == "chunk_q8":
        want = JDD.local_chunk_prefix_attend(
            *_j(x["cq"], x["kp8"], x["vp8"]), *tc, k_scale=_j(x["kps"])[0],
            v_scale=_j(x["vps"])[0], backend="xla")
    elif case == "mla_chunk":
        want = JD.dispatch("chunk_prefix_mla_paged", "xla",
                           *_j(x["cqa"], x["cqr"], x["cp"], x["rp"]), *tc,
                           scale=SCALE)
    else:
        want = JD.dispatch("chunk_prefix_mla_paged_q8", "xla",
                           *_j(x["cqa"], x["cqr"], x["cp8"], x["rp8"],
                               x["cps"], x["rps"]), *tc, scale=SCALE)
    _close(got[case], want)


def test_blocks_gather_back_and_ranks_agree(world):
    x, got = world
    np.testing.assert_array_equal(got["gathered"], x["k"])
    assert got["same_on_every_rank"]


def test_routers_without_a_mesh_take_the_local_path():
    """``seq_shard`` without a mesh is the local path, not an error (the
    JAX routers' fallback)."""
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    want = TDD.local_decode_attend(x["q"], x["k"], x["v"], 21)
    torch.testing.assert_close(
        TDD.decode_attend(x["q"], x["k"], x["v"], 21, seq_shard=True), want,
        rtol=0, atol=0)
    counts = torch.from_numpy(x["counts"].numpy())
    torch.testing.assert_close(
        TDD.paged_decode_attend(x["pq"], x["kp"], x["vp"], x["table"],
                                counts, seq_shard=True),
        TDD.local_paged_decode_attend(x["pq"], x["kp"], x["vp"], x["table"],
                                      counts), rtol=0, atol=0)
    torch.testing.assert_close(
        TDD.mla_decode_attend(x["qa"], x["qr"], x["ckv"], x["kr"], 21,
                              scale=SCALE, seq_shard=True),
        TDD.local_mla_decode_attend(x["qa"], x["qr"], x["ckv"], x["kr"], 21,
                                    scale=SCALE), rtol=0, atol=0)
    torch.testing.assert_close(
        TDD.mla_paged_decode_attend(x["pqa"], x["pqr"], x["cp"], x["rp"],
                                    x["table"], counts, scale=SCALE,
                                    seq_shard=True),
        TDD.local_mla_paged_decode_attend(x["pqa"], x["pqr"], x["cp"],
                                          x["rp"], x["table"], counts,
                                          scale=SCALE), rtol=0, atol=0)
    for a, b in zip(
            TDD.chunk_prefix_attend(x["cq"], x["kp"], x["vp"], x["ctable"],
                                    x["ccounts"], seq_shard=True),
            TDD.local_chunk_prefix_attend(x["cq"], x["kp"], x["vp"],
                                          x["ctable"], x["ccounts"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_own_pages_clips_and_masks():
    table = np.array([[3, 9, 12, 0], [8, 7, 15, 4]], np.int32)
    counts = np.array([[4, 4, 2, 0], [4, 4, 4, 1]], np.int32)
    t, c = TDD.own_pages(table, counts, 8, 8)
    np.testing.assert_array_equal(t, [[0, 1, 4, 0], [0, 0, 7, 0]])
    np.testing.assert_array_equal(c, [[0, 4, 2, 0], [4, 0, 4, 0]])
