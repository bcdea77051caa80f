"""The port's serving surfaces against the JAX package's: the
``launch/serve.py`` CLI (its flags, ``engine_config_from_args``,
``_stream_requests``, ``_serve_stream`` with and without ``--inject``,
``_serve_durable`` with ``--crash-at``), the 'auto' backend end to end,
and the examples on the CPU.

The JAX engines are built by the tests on an explicit (1, 1) mesh with
Auto axes (the JAX CLI's default mesh fails under JAX 0.9, ROADMAP
queue 3), from one parameter tree that the port's engines take through
the bridge; each side's ``_serve_stream`` / ``_serve_durable`` then runs
on its own engine.  Greedy streams are held equal, logits at 1e-4 of
their scale.
"""
import types

import jax
import numpy as np
import pytest
from jax.sharding import AxisType

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.engine import DecodeEngine as JEngine  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.config import ModelConfig  # noqa: E402
from repro_torch.engine import DecodeEngine, EngineConfig  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

NAME = "tinyllama-1.1b"
STREAM = ["--arch", NAME, "--reduce", "smoke", "--batch", "2",
          "--prompt-len", "8", "--gen", "6", "--stream", "6",
          "--page-size", "4"]


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    autotune.reset()
    yield path
    autotune.reset()


@pytest.fixture(scope="module")
def side():
    """The JAX paged and dense engines of reduced tinyllama on one
    parameter tree, and that tree bridged for the port."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    cfg = jconfigs.reduced(jconfigs.get_config(NAME))
    jargs = jserve.build_parser().parse_args(STREAM)
    paged = JEngine(cfg, jserve.engine_config_from_args(jargs, cfg),
                    mesh=mesh)
    dense = JEngine(cfg, jserve.engine_config_from_args(
        jserve.build_parser().parse_args(STREAM[:-4]), cfg),
        params=paged.params, mesh=mesh)
    params = jax.tree.map(np.asarray, paged.params)
    return types.SimpleNamespace(paged=paged, dense=dense, params=params,
                                 streams={})


def _port_engine(side, argv, **kw):
    args = serve.build_parser().parse_args(argv + ["--device", "cpu"])
    ecfg = serve.engine_config_from_args(args).replace(**kw)
    return DecodeEngine(tconfigs.reduced(tconfigs.get_config(NAME)), ecfg,
                        params=bridge.from_jax(side.params, "cpu"),
                        device="cpu"), args


def _jax_stream(side, extra, run=jserve._serve_stream):
    key = (run.__name__, tuple(extra))
    if key not in side.streams:
        args = jserve.build_parser().parse_args(STREAM + extra)
        side.streams[key] = run(side.paged, args)
    return side.streams[key]


def _same_results(got, want):
    assert set(got) == set(want)
    for rid in want:
        assert got[rid].status.value == want[rid].status.value, rid
        np.testing.assert_array_equal(np.asarray(got[rid]),
                                      np.asarray(want[rid]),
                                      err_msg=f"rid {rid}")


# ---------------------------------------------------------------- CLI

def _options(parser):
    return {o for a in parser._actions for o in a.option_strings} - {
        "-h", "--help"}


def test_parsers_share_option_strings():
    jp, tp = jserve.build_parser(), serve.build_parser()
    assert _options(tp) == _options(jp) | {"--device"}
    # --kernel-impl's choices map xla -> torch, pallas -> cuda
    choices = {a.dest: a.choices for a in tp._actions}
    jchoices = {a.dest: a.choices for a in jp._actions}
    names = {"xla": "torch", "pallas": "cuda", "auto": "auto"}
    assert choices["kernel_impl"] == [names[c]
                                      for c in jchoices["kernel_impl"]]
    for dest in ("reduce", "shard", "kv_dtype"):
        assert choices[dest] == jchoices[dest], dest


def test_serve_cli_maps_to_engine_config():
    args = serve.build_parser().parse_args(
        ["--arch", "qwen1.5-0.5b", "--batch", "3", "--prompt-len", "16",
         "--gen", "8", "--data-model", "2", "4", "--shard", "seq",
         "--kernel-impl", "cuda"])
    ecfg = serve.engine_config_from_args(args)
    assert ecfg == EngineConfig(batch=3, max_len=24, mesh_shape=(2, 4),
                                decode_shard="seq", kernel_impl="cuda")


def test_serve_cli_defaults_and_vlm_budget():
    args = serve.build_parser().parse_args(
        ["--arch", "internvl2-2b", "--prompt-len", "16", "--gen", "8"])
    ecfg = serve.engine_config_from_args(args)
    # one device: the (1, 1) mesh the JAX CLI gives a single device
    assert ecfg.mesh_shape == (1, 1) and args.device == "cuda"
    assert ecfg.decode_shard == "none" and ecfg.kernel_impl == "cuda"
    assert ecfg.max_len == 24
    # the vlm frontend prefix counts against the cache budget
    vlm = ModelConfig(name="t", family="vlm", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                      vocab=256, dtype="float32", frontend="vision",
                      frontend_tokens=8, frontend_dim=32)
    assert serve.engine_config_from_args(args, vlm).max_len == 32


@pytest.mark.parametrize("prefix", [False, True])
def test_stream_requests_match_jax(prefix):
    extra = ["--prefix-cache"] if prefix else []
    argv = ["--arch", NAME, "--stream", "9", "--prompt-len", "40",
            "--gen", "12", "--temperature", "0.5"] + extra
    eng = types.SimpleNamespace(
        cfg=tconfigs.reduced(tconfigs.get_config(NAME)), page_size=16)
    want = jserve._stream_requests(eng, jserve.build_parser().parse_args(
        argv))
    got = serve._stream_requests(eng, serve.build_parser().parse_args(argv))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.tokens.dtype == np.int32
        assert (g.rid, g.gen, g.temperature, g.seed) == \
            (w.rid, w.gen, w.temperature, w.seed)
    if prefix:      # the even requests open with one system prompt
        assert np.array_equal(got[0].tokens[:16], got[2].tokens[:16])


@pytest.mark.parametrize("extra", [[], ["--inject"]], ids=["plain",
                                                           "inject"])
def test_serve_stream_matches_jax(side, extra):
    want = _jax_stream(side, extra)
    eng, args = _port_engine(side, STREAM + extra)
    got = serve._serve_stream(eng, args)
    _same_results(got, want)
    if extra:
        assert {v.status.value for v in got.values()} == {
            "FINISHED", "FAILED", "CANCELLED"}


def test_serve_durable_crash_matches_jax(side, tmp_path):
    extra = ["--snapshot-every", "2", "--crash-at", "6"]
    jargs = jserve.build_parser().parse_args(
        STREAM + extra + ["--snapshot-dir", str(tmp_path / "jax")])
    want = jserve._serve_durable(side.paged, jargs)
    eng, args = _port_engine(
        side, STREAM + extra + ["--snapshot-dir", str(tmp_path / "port")])
    got = serve._serve_durable(eng, args)
    _same_results(got, want)
    # the results equal the crash-free run's
    eng, args = _port_engine(
        side, STREAM + ["--snapshot-dir", str(tmp_path / "clean")])
    _same_results(got, serve._serve_durable(eng, args))


@pytest.mark.parametrize("argv", [["--data-model", "1", "2", "--shard",
                                   "seq"],
                                  ["--data-model", "2", "1"],
                                  ["--data-model", "1", "2"]])
def test_distributed_flags_raise_item_14(argv, capfd):
    """Sharded serving from the CLI: ``--data-model 1 2 --shard seq``
    (the cache sequence-sharded over two ranks), ``--data-model 2 1``
    (the batch split) and ``--data-model 1 2`` (tensor-parallel: each
    rank its blocks of the weights) spawn their ranks and give ``1 1``'s
    tokens and output lines (the timings aside).  Durable serving under
    a mesh is still refused, naming ROADMAP queue 1 item 14."""
    base = ["--arch", NAME, "--reduce", "smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "4"]
    want = serve.main(base)
    lines = capfd.readouterr().out.splitlines()
    got = serve.main(base + argv)
    assert torch.equal(got, want.cpu())
    same = capfd.readouterr().out.splitlines()
    assert same[1:] == lines[1:] and same[0].split(":")[0] == \
        lines[0].split(":")[0]
    with pytest.raises(NotImplementedError, match="item 14"):
        serve.main(base + argv + ["--stream", "2", "--snapshot-dir", "x"])


# ---------------------------------------------------------------- 'auto'

def test_auto_logits_and_generate_match_jax(side, tuner):
    eng, _ = _port_engine(side, STREAM[:-4], kernel_impl="auto")
    ref, _ = _port_engine(side, STREAM[:-4], kernel_impl="torch")
    toks = np.random.default_rng(1).integers(
        2, eng.cfg.vocab, (2, 8)).astype(np.int32)
    jl, jcache = side.dense.prefill({"tokens": toks})
    logits, cache = eng.prefill({"tokens": toks})
    for step in range(3):
        want = np.asarray(jl)
        scale = np.abs(want).max()
        assert np.abs(logits.numpy() - want).max() <= 1e-4 * scale, step
        tok = want.argmax(-1).astype(np.int32)
        jl, jcache = side.dense.decode_step(tok, 8 + step, jcache)
        logits, cache = eng.decode_step(torch.from_numpy(tok), 8 + step,
                                        cache)
    assert autotune.stats["misses"] > 0       # 'auto' measured its ops
    jgen, _ = side.dense.generate({"tokens": toks}, 6)
    gen, _ = eng.generate({"tokens": toks}, 6)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
    np.testing.assert_array_equal(
        gen.numpy(), ref.generate({"tokens": toks}, 6)[0].numpy())


def test_auto_stream_matches_torch_and_jax(side, tuner):
    want = _jax_stream(side, [])
    for impl in ("auto", "torch"):
        eng, args = _port_engine(side, STREAM, kernel_impl=impl)
        _same_results(serve._serve_stream(eng, args), want)
    assert autotune.stats["measured"] > 0


# ---------------------------------------------------------------- examples

def test_serve_main_generates_on_the_cpu(tuner):
    gen = serve.main(["--arch", NAME, "--reduce", "smoke", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "8",
                      "--gen", "4", "--kernel-impl", "auto"])
    assert tuple(gen.shape) == (2, 4)


def test_quickstart_on_the_cpu():
    from repro_torch.examples import quickstart
    res = quickstart.main("cpu")
    assert np.isfinite(res["loss"]) and np.isfinite(res["step_loss"])
    assert res["isa_err"] < 1e-4 and res["matmul_err"] < 1e-4


def test_serve_batch_crash_recovery_demo_on_the_cpu(capsys):
    from repro_torch.examples import serve_batch
    serve_batch.main(["--stream", "--crash-at", "6", "--snapshot-every",
                      "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "stream example OK" in out and "crash-recovery example OK" in out


def test_train_100m_defaults_over_the_launcher(tmp_path):
    from repro_torch.examples import train_100m
    from repro_torch.launch.train import main
    d = train_100m.defaults()
    assert d[:d.index("--ckpt")] == [
        "--arch", "tinyllama-1.1b", "--reduce", "width", "--steps", "200",
        "--batch", "8", "--seq", "256"]
    losses = main(d + ["--reduce", "smoke", "--steps", "2", "--batch", "2",
                       "--seq", "16", "--device", "cpu", "--ckpt",
                       str(tmp_path / "ck"), "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(v) for _, v in losses)
