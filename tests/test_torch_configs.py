"""The PyTorch port's configs, import boundary and dispatch registry:
every arch (and its reduced shrink) is field-equal to the JAX package's
apart from ``kernel_impl``; ``import repro_torch`` never pulls in JAX;
no port source imports JAX or the JAX package."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import build, dispatch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("kernel_impl")
    return d


def test_registry_names_match():
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_arch_and_reduced_field_equal(name):
    j, t = jconfigs.get_config(name), tconfigs.get_config(name)
    assert _fields(t) == _fields(j)
    assert _fields(tconfigs.reduced(t)) == _fields(jconfigs.reduced(j))
    assert t.vocab_padded == j.vocab_padded and t.q_per_kv == j.q_per_kv
    assert t.kernel_impl == "cuda" and j.kernel_impl == "xla"


def test_get_config_unknown_raises():
    with pytest.raises(KeyError, match="tinyllama-1.1b"):
        tconfigs.get_config("tinyllama")


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import repro_torch, repro_torch.bridge, repro_torch.configs\n"
            "import repro_torch.engine, repro_torch.kernels.ops\n"
            "import repro_torch.kernels.build, repro_torch.models.lm\n"
            "import repro_torch.core, repro_torch.configs.provet_cnn\n"
            "import repro_torch.kernels.vwr_conv2d\n"
            "import repro_torch.kernels.vwr_depthwise\n"
            "import repro_torch.examples.provet_conv_demo\n"
            "import repro_torch.examples.quickstart\n"
            "import repro_torch.examples.serve_batch\n"
            "import repro_torch.examples.train_100m\n"
            "import repro_torch.kernels.autotune\n"
            "import repro_torch.launch.roofline\n"
            "import repro_torch.launch.serve\n"
            "import repro_torch.launch.train\n"
            "import repro_torch.dist.compression, repro_torch.dist.pipeline\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in (ROOT / "src" / "repro_torch").rglob(
        "*.py")] + [Path("chip_smoke.py")]), ids=str)
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(ROOT / path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_dispatch_registry_has_both_backends():
    from repro_torch.models import lm  # noqa: F401  (registers the ops)
    for op in ("qkv_proj", "o_proj", "attention", "mlp", "swiglu",
               "decode_partial", "decode_partial_mla",
               "decode_partial_mla_q8", "decode_partial_mla_paged",
               "decode_partial_mla_paged_q8"):
        assert dispatch.backends(op) == ("cuda", "torch"), op
    # 'auto' resolves at the registry; with nothing to key on (no
    # arguments) it takes the first of AUTO_ORDER
    assert dispatch.resolve("mlp", "auto") is dispatch.resolve("mlp", "cuda")
    with pytest.raises(KeyError, match="no 'pallas' backend"):
        dispatch.resolve("mlp", "pallas")
    with pytest.raises(KeyError, match="registered ops"):
        dispatch.resolve("nope", "torch")
    for name in ("pallas", "auto"):
        with pytest.raises(ValueError, match="unknown backend"):
            dispatch.register("mlp", name)


def test_kernel_build_paths_and_counters():
    assert set(build.LAUNCHES) == {"vwr_matmul", "vwr_swiglu",
                                   "vwr_attention", "vwr_flash_decode",
                                   "vwr_paged_flash_decode",
                                   "vwr_paged_flash_decode_q8",
                                   "vwr_chunk_prefix_attend",
                                   "vwr_chunk_prefix_attend_q8",
                                   "vwr_mla_flash_decode",
                                   "vwr_mla_paged_flash_decode",
                                   "vwr_mla_paged_flash_decode_q8",
                                   "vwr_mla_flash_decode_q8",
                                   "vwr_flash_decode_q8",
                                   "vwr_mla_chunk_prefix_attend",
                                   "vwr_mla_chunk_prefix_attend_q8",
                                   "vwr_conv2d", "vwr_depthwise"}
    assert {"vwr_conv2d", "vwr_depthwise"} <= set(build.SOURCES)
    for name in build.SOURCES:
        p = build.lib_path(name)
        assert (build.CSRC / f"{name}.cu").exists()
        assert p.parent == ROOT / "build" / "repro_torch"
        assert p.name.startswith(name + "-") and p.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
