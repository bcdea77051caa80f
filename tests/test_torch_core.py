"""The port's numpy-only ``core`` (Provet machine, ISA, CNN templates and
the section 7 analytical suite) against ``repro.core`` on the same
inputs: the same programs, outputs, counters, energies and suite
numbers, exactly (the port's copy differs only in its package imports).
The cases mirror ``tests/test_isa_conv.py`` and ``tests/test_machine.py``,
with ``hypothesis`` where they use it."""
import dataclasses

import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import analysis as JA  # noqa: E402
from repro.core import isa as JI  # noqa: E402
from repro.core import machine as JM  # noqa: E402
from repro.core import templates as JT  # noqa: E402
from repro_torch.core import analysis as TA  # noqa: E402
from repro_torch.core import isa as TI  # noqa: E402
from repro_torch.core import machine as TM  # noqa: E402
from repro_torch.core import ref_ops as TR  # noqa: E402
from repro_torch.core import templates as TT  # noqa: E402


def _program(p):
    return [(type(i).__name__, dataclasses.astuple(i)) for i in p]


def _same_run(jmap, tmap):
    """Both mappings carry the same program and SRAM image, and running
    them gives the same output and the same counters."""
    assert _program(jmap.program) == _program(tmap.program)
    np.testing.assert_array_equal(jmap.sram_image, tmap.sram_image)
    (jo, jm), (to, tm) = jmap.run(), tmap.run()
    np.testing.assert_array_equal(jo, to)
    assert jm.c.as_dict() == tm.c.as_dict()
    return to, tm


def _cfgs(**kw):
    return JM.ProvetConfig(**kw), TM.ProvetConfig(**kw)


def test_run_suite_equal_field_by_field():
    jsuite, tsuite = JA.run_suite(), TA.run_suite()
    assert list(jsuite) == list(tsuite) == [l.name for l in TA.LAYERS]
    for layer in jsuite:
        assert list(jsuite[layer]) == list(tsuite[layer])
        for arch in jsuite[layer]:
            j, t = jsuite[layer][arch], tsuite[layer][arch]
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
            assert j.latency_ms == t.latency_ms
    assert JA.improvement_table(jsuite) == TA.improvement_table(tsuite)


def test_layers_and_configs_equal():
    assert [dataclasses.asdict(l) for l in JA.LAYERS] == [
        dataclasses.asdict(l) for l in TA.LAYERS]
    for name in ("PROVET_FULL",):
        assert dataclasses.asdict(getattr(JA, name)) == dataclasses.asdict(
            getattr(TA, name))
    for name in ("PAPER_EXAMPLE", "PAPER_FULL"):
        j, t = getattr(JM, name), getattr(TM, name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.width_ratio, j.n_slices, j.total_lanes) == (
            t.width_ratio, t.n_slices, t.total_lanes)


def test_provet_cnn_config_reexports_the_core():
    from repro.configs import provet_cnn as jcfg
    from repro_torch.configs import provet_cnn as tcfg

    assert tcfg.CONFIG is None and jcfg.CONFIG is None
    assert tcfg.LAYERS is TA.LAYERS and tcfg.run_suite is TA.run_suite
    assert tcfg.PAPER_EXAMPLE is TM.PAPER_EXAMPLE
    assert tcfg.ProvetConfig is TM.ProvetConfig
    assert dataclasses.asdict(tcfg.PROVET_FULL) == dataclasses.asdict(
        jcfg.PROVET_FULL)


def test_conv_paper_example_6_1():
    """The paper's exact example: 5x5 kernel, 16x16 image, 16-lane VFU,
    64-operand SRAM; the same instruction mix, counters and metrics."""
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, 16, 16)).astype(np.float32)
    w = rng.standard_normal((1, 1, 5, 5)).astype(np.float32)
    jmap = JT.conv2d(JM.PAPER_EXAMPLE, img, w)
    tmap = TT.conv2d(TM.PAPER_EXAMPLE, img, w)
    out, m = _same_run(jmap, tmap)
    np.testing.assert_allclose(out, TR.conv2d_ref(img, w), rtol=1e-5,
                               atol=1e-5)
    assert m.c.instr_mix["VFUX"] == 12 * 25
    jm = jmap.run()[1]
    assert jm.cmr() == m.cmr()
    assert jm.utilization(jmap.meta["total_macs"]) == m.utilization(
        tmap.meta["total_macs"])


@settings(max_examples=12, deadline=None)
@given(
    h=st.integers(6, 14), w=st.integers(6, 16), k=st.integers(1, 5),
    cin=st.integers(1, 3), cout=st.integers(1, 3),
    seed=st.integers(0, 10_000),
)
def test_conv_template_property(h, w, k, cin, cout, seed):
    if k > min(h, w):
        return
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((cin, h, w)).astype(np.float32)
    wts = rng.standard_normal((cout, cin, k, k)).astype(np.float32)
    jcfg, tcfg = _cfgs()
    need = (-(-cin * h // 4) + -(-cout * cin * k * k // 64)
            + -(-cout * (h - k + 1) // 4))
    if need > tcfg.sram_depth:
        return
    _same_run(JT.conv2d(jcfg, img, wts), TT.conv2d(tcfg, img, wts))


def test_depthwise_fc_and_maxpool():
    rng = np.random.default_rng(1)
    jcfg, tcfg = _cfgs()
    img = rng.standard_normal((4, 12, 14)).astype(np.float32)
    wd = rng.standard_normal((4, 3, 3)).astype(np.float32)
    (jo, jm), (to, tm) = (JT.depthwise_conv2d(jcfg, img, wd).run(),
                          TT.depthwise_conv2d(tcfg, img, wd).run())
    np.testing.assert_array_equal(jo, to)
    assert jm.c.as_dict() == tm.c.as_dict()
    np.testing.assert_allclose(to, TR.depthwise_ref(img, wd), rtol=1e-4,
                               atol=1e-4)
    x = rng.standard_normal(48).astype(np.float32)
    w = rng.standard_normal((16, 48)).astype(np.float32)
    out, _ = _same_run(JT.fc(jcfg, x, w), TT.fc(tcfg, x, w))
    np.testing.assert_allclose(out, w @ x, rtol=1e-5, atol=1e-5)
    img = rng.standard_normal((8, 16)).astype(np.float32)
    out, _ = _same_run(JT.maxpool(jcfg, img, 2), TT.maxpool(tcfg, img, 2))
    np.testing.assert_allclose(out, TR.maxpool_ref(img, 2))


def test_partition_6_2_1_and_packing_6_2_2():
    rng = np.random.default_rng(5)
    jcfg, tcfg = _cfgs()
    img = rng.standard_normal((1, 8, 40)).astype(np.float32)
    w = rng.standard_normal((1, 1, 3, 3)).astype(np.float32)
    jparts, tparts = (JT.partition_image(img, 16, 3),
                      TT.partition_image(img, 16, 3))
    assert [o for _, o in jparts] == [o for _, o in tparts]
    outs = []
    for (js, off), (ts, _) in zip(jparts, tparts):
        np.testing.assert_array_equal(js, ts)
        o, _ = _same_run(JT.conv2d(jcfg, js, w), TT.conv2d(tcfg, ts, w))
        outs.append((o, off))
    stitched = TT.stitch_strips(outs, 38)
    np.testing.assert_array_equal(JT.stitch_strips(outs, 38), stitched)
    np.testing.assert_allclose(stitched, TR.conv2d_ref(img, w), rtol=1e-4,
                               atol=1e-4)
    imgs = [rng.standard_normal((1, 8, 6)).astype(np.float32)
            for _ in range(2)]
    (jp, jspans), (tp, tspans) = (JT.pack_width(imgs, 16, 3),
                                  TT.pack_width(imgs, 16, 3))
    np.testing.assert_array_equal(jp, tp)
    assert jspans == tspans
    _same_run(JT.conv2d(jcfg, jp, w), TT.conv2d(tcfg, tp, w))


@settings(max_examples=8, deadline=None)
@given(h=st.integers(8, 14), cout=st.integers(1, 4),
       cin=st.integers(1, 4), k=st.sampled_from([1, 3, 5]))
def test_closed_form_counts_equal(h, cout, cin, k):
    if k > h:
        return
    jcfg, tcfg = _cfgs()
    jl, tl = (JA.ConvLayer("t", h, 14, cin, cout, k),
              TA.ConvLayer("t", h, 14, cin, cout, k))
    assert JA.template_conv_counts(jcfg, jl) == TA.template_conv_counts(
        tcfg, tl)
    assert JA.provet_conv_counts(jcfg, jl) == TA.provet_conv_counts(
        tcfg, tl)


def test_energy_and_cost_functions_equal():
    cap = 64 * 1024 * 8
    assert JM.aspect_ratio_sweep(cap) == TM.aspect_ratio_sweep(cap)
    for w in (128, 1024, 4096):
        for d in (1, 8, 32):
            assert JM.sram_word_energy_fj(w, d) == TM.sram_word_energy_fj(
                w, d)
            assert JM.sram_bit_energy_fj(w, d) == TM.sram_bit_energy_fj(w, d)
    for bits in (64, 512, 4096):
        assert JM.vwr_access_energy_fj(bits) == TM.vwr_access_energy_fj(bits)
        for dist in (0, 1, 7):
            assert JM.shuffle_energy_fj(bits, dist) == \
                TM.shuffle_energy_fj(bits, dist)
    n, r = TM.PAPER_TABLE1_ENDPOINTS, TM.PAPER_TABLE1_REACH
    assert (n, r) == (JM.PAPER_TABLE1_ENDPOINTS, JM.PAPER_TABLE1_REACH)
    assert JM.shuffler_cost(n, r) == TM.shuffler_cost(n, r)
    assert JM.crossbar_cost(n) == TM.crossbar_cost(n)


def _machines(**kw):
    jcfg, tcfg = _cfgs(**kw)
    return JI.ProvetMachine(jcfg), TI.ProvetMachine(tcfg), tcfg


def _same_state(jm, tm):
    np.testing.assert_array_equal(jm.sram, tm.sram)
    np.testing.assert_array_equal(jm.vwr, tm.vwr)
    for r in tm.regs:
        np.testing.assert_array_equal(jm.regs[r], tm.regs[r])
    assert jm.c.as_dict() == tm.c.as_dict()


@settings(max_examples=20, deadline=None)
@given(shift=st.integers(-8, 8), seed=st.integers(0, 100))
def test_perm_shift(shift, seed):
    jm, tm, cfg = _machines(vfu_shuffle_range=8)
    vals = np.random.default_rng(seed).standard_normal(
        (1, cfg.vfu_width)).astype(np.float32)
    for m, I in ((jm, JI), (tm, TI)):
        m.regs["R1"] = vals.copy()
        m.step(I.PERM(src="R1", dst="R2", shift=shift))
        m.step(I.PERM(src="R2", dst="R3", shift=-shift))
    _same_state(jm, tm)


@settings(max_examples=20, deadline=None)
@given(row=st.integers(0, 31), seed=st.integers(0, 100))
def test_rlb_wlb_roundtrip(row, seed):
    jm, tm, cfg = _machines()
    data = np.random.default_rng(seed).standard_normal(
        cfg.sram_width).astype(np.float32)
    for m, I in ((jm, JI), (tm, TI)):
        m.sram[row] = data
        m.step(I.RLB(vwr=0, row=row))
        m.step(I.WLB(vwr=0, row=(row + 1) % cfg.sram_depth))
    _same_state(jm, tm)
    assert tm.c.sram_reads == 1 and tm.c.sram_writes == 1
    assert tm.c.energy_fj > 0


@settings(max_examples=15, deadline=None)
@given(shift=st.integers(-8, 8), seed=st.integers(0, 50))
def test_glmv_roll(shift, seed):
    jm, tm, cfg = _machines(tile_shuffle_range=8)
    data = np.random.default_rng(seed).standard_normal(
        cfg.sram_width).astype(np.float32)
    for m, I in ((jm, JI), (tm, TI)):
        m.vwr[0] = data
        m.step(I.GLMV(vwr=0, block_shift=shift))
    _same_state(jm, tm)
    np.testing.assert_array_equal(
        tm.vwr[0], np.roll(data, shift * cfg.vfu_width))


def test_vfux_modes_and_energy_accounting():
    jm, tm, cfg = _machines()
    a = np.linspace(-2, 2, cfg.vfu_width, dtype=np.float32)[None]
    b = np.full((1, cfg.vfu_width), 0.5, np.float32)
    for m, I in ((jm, JI), (tm, TI)):
        m.regs["R1"], m.regs["R4"] = a.copy(), b.copy()
        m.step(I.VFUX(mode="mult", in1="R1", in2="R4", out="R2"))
        m.step(I.VFUX(mode="relu", in1="R1", out="R2"))
        m.step(I.VFUX(mode="mac", in1="R1", in2="R4", out="R3", acc="R3"))
        m.step(I.VFUX(mode="sigmoid", in1="R1", out="R2"))
    _same_state(jm, tm)
    assert tm.c.compute_instrs == 4
    energies = []
    for M, I in ((JM, JI), (TM, TI)):
        m = I.ProvetMachine(M.PAPER_EXAMPLE)
        m.step(I.RLB(vwr=0, row=0))
        m2 = I.ProvetMachine(M.PAPER_EXAMPLE)
        m2.step(I.VMV(vwr=0, slice_idx=0, dst="R1"))
        energies.append((m.c.energy_fj, m2.c.energy_fj))
    assert energies[0] == energies[1]
    assert energies[1][0] > 5 * energies[1][1]
