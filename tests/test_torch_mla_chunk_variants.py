"""Kernels 12 (``vwr_mla_chunk_prefix_attend``, bf16 pools) and 15 (its
``_q8`` sibling, int8 pools with fp32 page scales): the rule that picks
their wgmma variant, the walk of that variant over the table's pages,
and its arithmetic (the queries and P as two bf16 terms each, fp16 for
kernel 15, fp32 products and sums; on int8 pools the page scales applied
in fp32 outside the products, P times the latent scale and l over the
unscaled P) held against the plain versions at DeepSeek-V3's widths.
``chunk_split_emulation`` is that arithmetic in plain PyTorch; the cases
here hold the emulation and the plain versions, not the kernels, which
run only on the card (``cuda``-marked cases in ``test_torch_mla.py`` and
``chip_smoke.py``, both against the plain versions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import vwr_mla_decode as KM  # noqa: E402

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
H, R, RP, SCALE = 128, 512, 64, 1.0 / 192 ** 0.5


@pytest.mark.parametrize("r,rope,ps,dtype,want", [
    (512, 64, 16, BF16, "wgmma"),     # DeepSeek-V3 on its pages of 16
    (512, 64, 64, BF16, "wgmma"),     # larger pages are sub-tiled
    (512, 64, 8, BF16, "wgmma"),
    (256, 32, 16, BF16, "wgmma"),
    (128, 64, 16, BF16, "wgmma"),
    (512, 64, 16, F32, "fma"),        # fp32 pools keep the FMA kernel
    (32, 32, 4, BF16, "fma"),         # the reduced configs' padded widths
    (32, 32, 8, F32, "fma"),
    (64, 32, 16, BF16, "fma"),
    (512, 64, 4, BF16, "fma"),        # pages under 8 rows
    (512, 64, 12, BF16, "fma"),       # or off a multiple of 8
    (512, 64, 24, BF16, "wgmma"),
    # kernel 15: int8 pools take the same rule
    (512, 64, 16, I8, "wgmma"),
    (512, 64, 64, I8, "wgmma"),
    (256, 32, 16, I8, "wgmma"),
    (32, 32, 8, I8, "fma"),           # the reduced configs' padded widths
    (512, 64, 12, I8, "fma"),         # pages off a multiple of 8
])
def test_rule(r, rope, ps, dtype, want):
    assert KM.chunk_variant(r, rope, ps, dtype) == want


def test_key_tiles_skip_empty_pages_and_mask_past_counts():
    """Pages of 16: two pages a 32-slot tile, a count-0 page skipped, the
    slots past a partial page's count masked (-1)."""
    tiles = KM.chunk_key_tiles([3, 5, 1, 7], [16, 0, 7, 16], 16)
    assert len(tiles) == 2
    assert tiles[0] == list(range(48, 64)) + list(range(16, 23)) + [-1] * 9
    assert tiles[1] == list(range(112, 128)) + [-1] * 16


def test_key_tiles_sub_tile_large_pages():
    """Pages of 64: 32 rows of one page a tile."""
    tiles = KM.chunk_key_tiles([2, 0], [50, 64], 64)
    assert [t[0] for t in tiles] == [128, 160, 0, 32]
    assert tiles[1] == list(range(160, 178)) + [-1] * 14
    assert KM.chunk_key_tiles([2], [0], 64) == []


def _inputs(seed, C, pages, ps=16, n_pages=12):
    rng = np.random.default_rng(seed)
    qa = torch.from_numpy(rng.standard_normal((C, H, R), np.float32))
    qr = torch.from_numpy(rng.standard_normal((C, H, RP), np.float32))
    ckv = torch.from_numpy(rng.standard_normal((n_pages, ps, R),
                                               np.float32)).to(BF16)
    kr = torch.from_numpy(rng.standard_normal((n_pages, ps, RP),
                                              np.float32)).to(BF16)
    table = torch.tensor([p for p, _ in pages], dtype=torch.int32)
    counts = torch.tensor([c for _, c in pages], dtype=torch.int32)
    return qa, qr, ckv, kr, table, counts


def _inputs_q8(seed, C, pages, ps=16, n_pages=12):
    """Kernel 15's operands: int8 pools and fp32 (n_pages,) scales in the
    range of chip_smoke's (1e-3 .. 2.1e-2)."""
    qa, qr, _, _, table, counts = _inputs(seed, C, pages, ps, n_pages)
    rng = np.random.default_rng(seed + 100)
    ckv, kr = (torch.from_numpy(rng.integers(-127, 128, (n_pages, ps, w),
                                             dtype=np.int8))
               for w in (R, RP))
    cs, rs = (torch.from_numpy((rng.random(n_pages) * 0.02 + 1e-3)
                               .astype(np.float32)) for _ in range(2))
    return qa, qr, ckv, kr, cs, rs, table, counts


@pytest.mark.parametrize("seed,C,pages,ps", [
    # 3 pages of 16 at DeepSeek-V3's widths: a partial and a count-0 page,
    # and an entry past the pool (clamped)
    (0, 2, [(3, 16), (7, 0), (40, 9)], 16),
    (1, 2, [(0, 16), (5, 16), (2, 5)], 16),
    (2, 3, [(9, 16), (4, 16), (1, 16), (6, 16), (11, 16)], 16),
    (3, 1, [(2, 50), (0, 0), (1, 64)], 64),
])
def test_split_arithmetic_matches_the_plain_version(seed, C, pages, ps):
    """Within kernel 12's fp32 tolerance (atol 1e-4, rtol 1e-4)."""
    args = _inputs(seed, C, pages, ps)
    got = KM.chunk_split_emulation(*args, scale=SCALE)
    want = KM.vwr_mla_chunk_prefix_attend_ref(*args, scale=SCALE)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seed,C,pages,ps", [
    (0, 2, [(3, 16), (7, 0), (40, 9)], 16),
    (1, 2, [(0, 16), (5, 16), (2, 5)], 16),
    (2, 3, [(9, 16), (4, 16), (1, 16), (6, 16), (11, 16)], 16),
    (3, 1, [(2, 50), (0, 0), (1, 64)], 64),
])
def test_q8_split_arithmetic_matches_the_plain_version(seed, C, pages, ps):
    """Kernel 15's wgmma arithmetic (int8 keys exact in bf16, page scales
    in fp32 outside the products) within its fp32 tolerance (atol 1e-4,
    rtol 1e-4) on the layouts above."""
    qa, qr, ckv, kr, cs, rs, table, counts = _inputs_q8(seed, C, pages, ps)
    got = KM.chunk_split_emulation(qa, qr, ckv, kr, table, counts, cs, rs,
                                   scale=SCALE)
    want = KM.vwr_mla_chunk_prefix_attend_q8_ref(qa, qr, ckv, kr, cs, rs,
                                                 table, counts, scale=SCALE)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_q8_fp16_terms_keep_a_margin_at_256_keys():
    """Why kernel 15's terms are fp16: at 16 full pages of 16 its int8
    keys' products keep within a quarter of the tolerance (two bf16 terms,
    2^-18 of each product against fp16's 2^-22, used 0.76-1.11 of it on
    an H100 at this depth)."""
    args = _inputs_q8(6, 2, [(i, 16) for i in range(12)] + [(3, 16)] * 4)
    qa, qr, ckv, kr, cs, rs, table, counts = args
    got = KM.chunk_split_emulation(qa, qr, ckv, kr, table, counts, cs, rs,
                                   scale=SCALE)
    want = KM.vwr_mla_chunk_prefix_attend_q8_ref(*args, scale=SCALE)
    for g, w in zip(got, want):
        assert ((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max().item() < 0.25


def test_q8_split_arithmetic_without_a_valid_key():
    """int8 pools, every page counted 0: m = -1e30, l = 0, o_tilde = 0."""
    qa, qr, ckv, kr, cs, rs, table, counts = _inputs_q8(
        4, 2, [(1, 0), (2, 0), (5, 0)])
    o, m, l = KM.chunk_split_emulation(qa, qr, ckv, kr, table, counts, cs,
                                       rs, scale=SCALE)
    assert o.abs().max().item() == 0.0 and l.abs().max().item() == 0.0
    assert bool((m == torch.tensor(KM.NEG_INF)).all())


def test_q8_l_sums_the_unscaled_p():
    """Why l takes P before the latent scale: P times each key's page
    scale (the P c_kv operand) summed instead misses the tolerance.  This
    is a property of the plain version's l; the kernel's l is held
    against it on the card."""
    qa, qr, ckv, kr, cs, rs, table, counts = _inputs_q8(
        5, 2, [(3, 16), (5, 16), (8, 7)])
    _, m, l = KM.vwr_mla_chunk_prefix_attend_q8_ref(
        qa, qr, ckv, kr, cs, rs, table, counts, scale=SCALE)
    # the plain scores on the dequantized pages, and P at the same m
    tbl = table.long()
    valid = (torch.arange(16)[None, :] < counts[:, None]).reshape(-1)
    dq = [(p[tbl].float() * s[tbl][:, None, None]).reshape(-1, p.shape[-1])
          for p, s in ((ckv, cs), (kr, rs))]
    s = (torch.einsum("chr,tr->cht", qa, dq[0])
         + torch.einsum("chk,tk->cht", qr, dq[1])) * SCALE
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    torch.testing.assert_close(p.sum(-1), l, atol=1e-4, rtol=1e-4)
    scaled = (p * cs[tbl].repeat_interleave(16)).sum(-1)
    assert ((scaled - l).abs() - 1e-4 - 1e-4 * l.abs()).max().item() > 0


def test_split_arithmetic_without_a_valid_key():
    """Every page counted 0: m = -1e30, l = 0, o_tilde = 0."""
    args = _inputs(4, 2, [(1, 0), (2, 0)])
    o, m, l = KM.chunk_split_emulation(*args, scale=SCALE)
    assert o.abs().max().item() == 0.0 and l.abs().max().item() == 0.0
    assert bool((m == torch.tensor(KM.NEG_INF)).all())   # fp32 -1e30


def test_one_bf16_term_misses_the_tolerance():
    """Why two terms: the queries rounded once to bf16 (P and the sums
    kept in fp32) already leave the fp32 tolerance."""
    qa, qr, ckv, kr, table, counts = _inputs(0, 2, [(3, 16), (5, 16)])
    want = KM.vwr_mla_chunk_prefix_attend_ref(qa, qr, ckv, kr, table,
                                              counts, scale=SCALE)
    once = KM.vwr_mla_chunk_prefix_attend_ref(
        (qa * SCALE).bfloat16().float(), (qr * SCALE).bfloat16().float(),
        ckv, kr, table, counts, scale=1.0)
    excess = ((once[0] - want[0]).abs()
              - 1e-4 - 1e-4 * want[0].abs()).max().item()
    assert excess > 0


def test_variant_counts_stay_zero_on_the_cpu():
    build.reset_launches()
    args = _inputs(5, 1, [(1, 16)])
    KM.vwr_mla_chunk_prefix_attend(*args, scale=SCALE)
    KM.vwr_mla_chunk_prefix_attend_q8(*_inputs_q8(5, 1, [(1, 16)]),
                                      scale=SCALE)
    for kernel in ("vwr_mla_chunk_prefix_attend",
                   "vwr_mla_chunk_prefix_attend_q8"):
        assert build.VARIANTS[f"{kernel}.wgmma"] == 0
        assert build.VARIANTS[f"{kernel}.fma"] == 0
        assert build.LAUNCHES[kernel] == 0
