"""Kernel 14 (``vwr_mla_flash_decode_q8``, the dense int8 latent cache) on
its Hopper variant: kernel 10's wgmma decode over the int8 slab with
kernel 13's int8 arithmetic.  The slab has one scale pair a sequence, so
every 32-key tile of sequence b takes b's latent and rope scales, and P's
power of two is b's latent scale's wherever the key split has a key.
``decode_split_emulation`` with the (B,) scales is that arithmetic in plain
PyTorch (fp16 query and P terms, the int8 values exact, the scales in fp32
around the products); the cases here hold it against
``vwr_mla_flash_decode_q8_ref`` (dequantize, then attend) at DeepSeek-V3's
widths and against the JAX package's Pallas kernel (interpret mode) at
1e-4.  The kernel itself runs only on the card (``chip_smoke.py`` holds it
against both).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import vwr_mla_decode as KM  # noqa: E402
from repro_torch.kernels.vwr_decode import pow2_up  # noqa: E402

I8, F32 = torch.int8, torch.float32
H, R, RP, SCALE = 128, 512, 64, 1.0 / 192 ** 0.5
TOL = dict(atol=1e-4, rtol=1e-4)
STEP = 2.0 ** 12


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _use(got, want):
    """The largest share of the 1e-4 limit an output element uses."""
    return max(((g - w).abs() / (1e-4 + 1e-4 * w.abs())).max().item()
               for g, w in zip(got, want))


def _slab(seed, B, T, h=H, r=R, rope=RP, step=None):
    """fp32 queries, int8 latent and rope slabs (B, T, .), (B,) scales;
    with ``step`` the scales lie in [0.01, 0.012) and the even sequences'
    are divided by it."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    qa, qr = f(B, h, r), f(B, h, rope)
    ckv, kr = (torch.from_numpy(rng.integers(-127, 128, (B, T, w))
                                .astype(np.int8)) for w in (r, rope))
    lo, width = (0.01, 0.002) if step else (1e-3, 0.02)
    cs, rs = (torch.from_numpy((rng.random(B) * width + lo)
                               .astype(np.float32)) for _ in range(2))
    if step:
        cs[::2] /= step
        rs[::2] /= step
    return qa, qr, ckv, kr, cs, rs


def _emulate(ops_, cur, pos0=0, plan=None, terms=2):
    qa, qr, ckv, kr, cs, rs = ops_
    return KM.decode_split_emulation(qa, qr, ckv, kr, cur_len=cur,
                                     pos0=pos0, plan=plan, ckv_scale=cs,
                                     krope_scale=rs, terms=terms,
                                     scale=SCALE)


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == F32
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("r,rope,h", [(512, 64, 128), (256, 32, 192),
                                      (128, 64, 20), (128, 32, 1)])
def test_slab_rule(r, rope, h):
    """The dense int8 cache takes the wgmma variant at the widths it has
    instances for, any H; the padded reduced widths the FMA kernel."""
    assert KM.decode_variant(r, rope, h, None, I8) == "wgmma"
    assert KM.decode_variant(r // 8, 32, h, None, I8) == "fma"


SLAB_CASES = [
    # label, B, T, cur_len, pos0, plan (None: mla_decode_plan's)
    ("generate's step", 4, 160, 144, 0, None),
    ("pos0 > 0, keys past cur_len", 4, 160, 150, 30, None),
    ("batch 1, 2048 keys", 1, 2048, 2048, 0, None),
    ("splits of partial tiles", 3, 300, 300, 0, (3, 128, 1)),
    ("one key past a split", 2, 160, 33, 0, (2, 32, 4)),
    ("pos0 > 0, splits and column blocks", 2, 300, 290, 7, (3, 96, 4)),
    ("a split a tile, two column blocks", 2, 100, 97, 0, (4, 32, 2)),
    ("the last slab's tile past the tensor", 2, 40, 40, 0, None),
]


@pytest.mark.parametrize("label,B,T,cur,pos0,plan", SLAB_CASES,
                         ids=[c[0] for c in SLAB_CASES])
def test_slab_arithmetic_matches_the_plain_version(label, B, T, cur, pos0,
                                                   plan):
    """At DeepSeek-V3's widths, within the fp32 limit of dequantize-then-
    attend, with the rule's plan or forced splits and column blocks."""
    ops_ = _slab(len(label) + T, B, T)
    _close(_emulate(ops_, cur, pos0, plan),
           KM.vwr_mla_flash_decode_q8_ref(*ops_, cur, pos0, scale=SCALE))


@pytest.mark.parametrize("h,r,rope,T,cur", [(20, 128, 64, 37, 37),
                                            (192, 256, 32, 100, 90)])
def test_slab_arithmetic_at_other_widths(h, r, rope, T, cur):
    """Masked rows past H in a sequence's last row block, r 128 and 256,
    rope 32."""
    ops_ = _slab(h + r, 3, T, h, r, rope)
    _close(_emulate(ops_, cur),
           KM.vwr_mla_flash_decode_q8_ref(*ops_, cur, scale=SCALE))


@pytest.mark.parametrize("cur,pos0", [(3, 10), (10, 10), (0, 0)])
def test_slab_without_a_valid_key(cur, pos0):
    """cur_len <= pos0: m = -1e30, l = 0, o_tilde = 0 for every row, as
    the plain version gives."""
    ops_ = _slab(cur + pos0, 2, 40)
    o, m, l = _emulate(ops_, cur, pos0)
    assert o.abs().max().item() == 0.0 and l.abs().max().item() == 0.0
    assert bool((m == torch.tensor(KM.NEG_INF)).all())
    _close((o, m, l), KM.vwr_mla_flash_decode_q8_ref(*ops_, cur, pos0,
                                                     scale=SCALE))


RB, HB, RR, RPB = 2, 4, 32, 16    # test_torch_mla.py's reduced shape


@pytest.mark.parametrize("T,cur,pos0,plan,widths", [
    (24, 17, 0, None, (RR, RPB)), (24, 30, 10, None, (RR, RPB)),
    (20, 16, 9, None, (RR, RPB)), (64, 64, 0, (2, 32, 1), (RR, RPB)),
    (70, 70, 0, (3, 32, 1), (RR, RPB)), (20, 5, 8, None, (RR, RPB)),
    (70, 60, 3, (2, 32, 1), (128, 32))])
def test_slab_arithmetic_matches_jax(T, cur, pos0, plan, widths):
    """Against ``vwr_mla_flash_decode_q8_p`` (interpret mode) at the
    reduced shape and at r 128, pos0 > 0, keys past cur_len and forced
    splits included."""
    r, rope = widths
    ops_ = _slab(T + cur + r, RB, T, HB, r, rope)
    want = jops.vwr_mla_flash_decode_q8(
        *(jnp.asarray(t.numpy()) for t in ops_), cur, pos0, scale=SCALE,
        interpret=True)
    got = _emulate(ops_, cur, pos0, plan)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   **TOL)


def test_slab_power_of_two_is_the_sequences_own(monkeypatch):
    """Scales 2^12 apart between neighbouring sequences: P's power of two
    from each sequence's own latent scale holds the limit; from another
    sequence's, or the smallest over the batch, P times a 2^12 larger
    scale overflows fp16 in the terms.  The largest over the batch only
    scales the smaller sequences' P down by 2^12, inside fp16's range
    (its lo term keeps ~2^-22 of each value), and stays in the limit."""
    ops_ = _slab(12, 4, 160, step=STEP)
    cs = ops_[4]
    assert float(cs[1::2].min() / cs[::2].max()) > STEP / 1.2
    want = KM.vwr_mla_flash_decode_q8_ref(*ops_, 144, scale=SCALE)
    _close(_emulate(ops_, 144), want)
    own = KM.slab_p_up
    for wrong in (lambda s, b, k0, k1: own(s, (b + 1) % len(s), k0, k1),
                  lambda s, b, k0, k1: own(s, (b - 1) % len(s), k0, k1),
                  lambda s, b, k0, k1: pow2_up(s.abs().min())):
        monkeypatch.setattr(KM, "slab_p_up", wrong)
        assert not all(bool(torch.isfinite(x).all())
                       for x in _emulate(ops_, 144))
    monkeypatch.setattr(KM, "slab_p_up",
                        lambda s, b, k0, k1: pow2_up(s.abs().max()))
    _close(_emulate(ops_, 144), want)


def test_slab_power_of_two_of_an_empty_split():
    """A split without a key takes 1 (``pow2_up(0)``), not its sequence's
    scale; one with a key the power that brings b's scale into [2^14,
    2^15)."""
    cs = torch.tensor([3e-3, 2e-6])
    assert float(KM.slab_p_up(cs, 0, 64, 64)) == 1.0
    for b in range(2):
        up = KM.slab_p_up(cs, b, 0, 32)
        assert 2 ** 14 <= float(cs[b] * up) < 2 ** 15


@pytest.mark.parametrize("plan", [None, (16, 128, 4)])
def test_slab_one_p_term_misses_the_tolerance(plan):
    """Why P is split into two fp16 terms: P (times its latent scale and
    power of two) rounded once leaves the 1e-4 limit."""
    ops_ = _slab(5, 1, 2048)
    want = KM.vwr_mla_flash_decode_q8_ref(*ops_, 2048, scale=SCALE)
    assert _use(_emulate(ops_, 2048, plan=plan), want) <= 1
    assert _use(_emulate(ops_, 2048, plan=plan, terms=1), want) > 1


def test_slab_variant_counts_stay_zero_on_the_cpu():
    """CPU tensors run the plain version: no launch, no variant counted."""
    build.reset_launches()
    ops_ = _slab(3, 2, 40, HB, RR, RPB)
    got = KM.vwr_mla_flash_decode_q8(*ops_, 30, scale=SCALE)
    _close(got, KM.vwr_mla_flash_decode_q8_ref(*ops_, 30, scale=SCALE))
    for variant in ("wgmma", "fma"):
        assert build.VARIANTS[f"vwr_mla_flash_decode_q8.{variant}"] == 0
    assert build.LAUNCHES["vwr_mla_flash_decode_q8"] == 0
