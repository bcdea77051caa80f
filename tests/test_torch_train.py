"""The port's training loss against the JAX package: ``lm.train_loss`` /
``ce_loss`` (z-loss, the moe aux losses, chunked logits), its gradients
by ``steps.value_and_grad``, ``_maybe_remat`` and the forward-only
refusal (the train step and the launcher: ``test_torch_train_step.py``).

Reduced fp32 configs (the moe family at capacity factor 4, as the other
port tests), JAX parameters through the bridge, the launcher's own
batches (``make_batch_fn``: SyntheticLM, seed 0) at B 2, S 32 (a
multiple of the recurrent chunk 16).

Tolerances.  Loss and every metric: 1e-5 relative.  Gradients, per
leaf: ||d|| / ||ref|| and max|d| / max|ref| <= 2e-3 (seamless 1e-2),
and zeros exactly where JAX's are zero (deepseek-v3's ``e_bias``).
These random reduced models are ill-conditioned in fp32: at the first
batch the gaps are <= 8.1e-4 (seamless 5.2e-3); over the next two
batches they reach 3.3e-3 (tinyllama) and 1.15e-2 (seamless), and
there the port and JAX lie equally far from a float64 evaluation of
the port (tinyllama 1.2e-3 / 2.1e-3, seamless 7.6e-3 / 1.3e-2): fp32
noise on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one thread a test process: the suite's xdist workers share the cores
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.common.module import leaves  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

SERVED = ("tinyllama-1.1b", "qwen1.5-0.5b", "internvl2-2b",
          "seamless-m4t-large-v2", "zamba2-1.2b", "xlstm-350m",
          "olmoe-1b-7b", "deepseek-v3-671b")
GRAD_TOL = {"seamless-m4t-large-v2": 1e-2}


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _cfgs(name, **kw):
    """(JAX, port) reduced fp32 configs, the port's on 'torch'; the moe
    family at capacity factor 4 (no drops)."""
    j = jconfigs.reduced(jconfigs.get_config(name)).replace(**kw)
    t = tconfigs.reduced(tconfigs.get_config(name)).replace(
        kernel_impl="torch", **kw)
    if j.moe is not None:
        j = j.replace(moe=dataclasses.replace(j.moe, capacity_factor=4.0))
        t = t.replace(moe=dataclasses.replace(t.moe, capacity_factor=4.0))
    return j, t


def _jflat(tree):
    """{path tuple: numpy leaf} of a JAX tree, keyed as ``leaves``."""
    return {tuple(str(getattr(p, "key", getattr(p, "name", p)))
                  for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _hold_grads(got, want, tol):
    want = _jflat(want)
    mine = {k: g.detach().numpy() for k, g in leaves(got)}
    assert set(mine) == set(want)
    for k, r in want.items():
        g = mine[k]
        assert g.dtype == r.dtype and g.shape == r.shape, k
        if not r.any():
            assert not g.any(), k
            continue
        norm = np.linalg.norm(g - r) / np.linalg.norm(r)
        peak = np.abs(g - r).max() / np.abs(r).max()
        assert norm <= tol and peak <= tol, (k, norm, peak)


@pytest.mark.parametrize("name", SERVED)
def test_train_loss_and_grads_match_jax(name):
    jc, tc = _cfgs(name)
    jp = jlm.init(jc, jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), "cpu")
    b = train.make_batch_fn(tc, 2, 32)(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.train_loss(p, b, jc), has_aux=True))(jp, _jbatch(b))
    (tl, tm), tg = steps.value_and_grad(tp, b, tc)
    assert set(tm) == set(jm)
    if jc.family == "moe":
        assert {"lb_loss", "z_loss_router", "drop_frac"} <= set(tm)
    assert _rel(tl, jl) <= 1e-5
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * max(
            abs(float(jm[k])), 1e-6), k
    _hold_grads(tg, jg, GRAD_TOL.get(name, 2e-3))


def test_ce_loss_chunked_and_masked():
    """logits_chunk 8 over S 30 (a ragged tail of 6, padded and masked):
    equal to the unchunked loss and to JAX's ce_loss on the same hiddens,
    with a partly zero loss mask."""
    jc, tc = _cfgs("tinyllama-1.1b")
    jp = jlm.init(jc, jax.random.PRNGKey(0))
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 30, jc.d_model)).astype(np.float32)
    labels = rng.integers(0, jc.vocab, (2, 30)).astype(np.int32)
    mask = (rng.random((2, 30)) > 0.3).astype(np.float32)
    th, tl_, tm_ = (torch.from_numpy(a) for a in (h, labels, mask))
    whole, wz = lm.ce_loss(tp, th, tl_, tm_, tc)
    chunked, cz = lm.ce_loss(tp, th, tl_, tm_, tc.replace(logits_chunk=8))
    jl, jz = jax.jit(lambda p, h, l, m: jlm.ce_loss(
        p, h, l, m, jc.replace(logits_chunk=8)))(jp, h, labels, mask)
    assert _rel(chunked, whole) <= 1e-6
    assert _rel(cz["z_loss"], wz["z_loss"]) <= 1e-6
    assert _rel(chunked, jl) <= 1e-6
    assert _rel(cz["z_loss"], jz["z_loss"]) <= 1e-6
    # the masked positions take no part
    keep = mask.astype(bool)
    kept, _ = lm.ce_loss(tp, th, tl_, torch.ones_like(tm_) * tm_, tc)
    lz = torch.logsumexp(lm._logits(tp, th, tc).float(), -1)
    ll = torch.gather(lm._logits(tp, th, tc).float(), -1,
                      tl_.long()[..., None])[..., 0]
    want = (lz - ll)[torch.from_numpy(keep)].mean()
    assert _rel(kept, want) <= 1e-6


@pytest.mark.parametrize("name", SERVED)
def test_remat_modes_give_the_same_grads(name):
    """"none", "full" and "dots" give the same loss and grads (within 1e-6
    of each leaf's scale; bitwise on the CPU)."""
    _, tc = _cfgs(name)
    tp = lm.init(tc, seed=0, device="cpu")
    b = train.make_batch_fn(tc, 2, 32)(0)
    (l0, _), g0 = steps.value_and_grad(tp, b, tc.replace(remat="none"))
    for mode in ("full", "dots"):
        (l1, _), g1 = steps.value_and_grad(tp, b, tc.replace(remat=mode))
        assert float(l1) == float(l0)
        g1 = dict(leaves(g1))
        for k, g in leaves(g0):
            scale = max(float(g.abs().max()), 1e-30)
            assert float((g1[k] - g).abs().max()) <= 1e-6 * scale, (mode, k)


def test_remat_recomputes_under_autograd_only(monkeypatch):
    """"full" runs each layer body twice under autograd (the forward and
    the backward's recompute) and once without grad (prefill); "dots"
    keeps the products with no batch dims, so its backward recomputes
    none of them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = []
    body = lm._dense_body

    def counted(*a, **k):
        calls.append(1)
        return body(*a, **k)

    monkeypatch.setattr(lm, "_dense_body", counted)
    _, tc = _cfgs("tinyllama-1.1b")
    tp = lm.init(tc, seed=0, device="cpu")
    b = train.make_batch_fn(tc, 2, 32)(0)
    for mode, want in (("none", 4), ("full", 8)):
        calls.clear()
        steps.value_and_grad(tp, b, tc.replace(remat=mode))
        assert len(calls) == want, mode
    calls.clear()
    lm.prefill(tp, {"tokens": torch.as_tensor(b["tokens"])},
               tc.replace(remat="full"))
    assert len(calls) == 4

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.n += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for mode in ("none", "full", "dots"):
        live = {k: x.detach().requires_grad_(True) for k, x in leaves(tp)}
        loss, _ = lm.train_loss(steps._with_leaves(tp, live), b,
                                tc.replace(remat=mode))
        with CountMM() as mode_count:
            torch.autograd.grad(loss, list(live.values()))
        counts[mode] = mode_count.n
    assert counts["full"] > counts["none"]
    assert counts["dots"] == counts["none"]


def test_embedding_grad_sums_rows_in_fp32():
    """A bf16 table's gradient: each row's contributions summed in fp32
    and rounded once (a token repeated 3,000 times), where plain indexing
    sums them in bf16; without grad the lookup is plain indexing."""
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(0)
    table = torch.randn((16, 8), generator=gen).bfloat16()
    tokens = torch.randint(0, 16, (4, 1000), generator=gen)
    tokens[:, ::4] = 3
    g = torch.randn((4, 1000, 8), generator=gen).bfloat16()
    want = torch.zeros((16, 8)).index_add_(
        0, tokens.reshape(-1), g.reshape(-1, 8).float()).bfloat16()
    t = table.clone().requires_grad_(True)
    out = layers.embed({"table": t}, tokens)
    assert torch.equal(out, table[tokens])
    got, = torch.autograd.grad(out, t, g)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    t2 = table.clone().requires_grad_(True)
    plain, = torch.autograd.grad(t2[tokens], t2, g)
    assert not torch.equal(plain, want)     # bf16 sums drift
    with torch.no_grad():
        assert torch.equal(layers.embed({"table": t}, tokens), out)


def test_cuda_training_is_refused():
    """The kernels are forward-only: training on 'cuda' raises the JAX
    package's forward-only ValueError, nothing reroutes."""
    assert dispatch.DIFFERENTIABLE_BACKENDS == ("torch",)
    assert dispatch.training_backend("torch") == "torch"
    _, tc = _cfgs("tinyllama-1.1b")
    tp = lm.init(tc, seed=0, device="cpu")
    b = train.make_batch_fn(tc, 2, 32)(0)
    cuda = tc.replace(kernel_impl="cuda")
    with pytest.raises(ValueError, match="forward-only"):
        dispatch.training_backend(cuda)
    with pytest.raises(ValueError, match="forward-only"):
        lm.train_loss(tp, b, cuda)
    step = steps.build_train_step(cuda, adamw.OptConfig())
    with pytest.raises(ValueError, match="forward-only"):
        step(tp, adamw.init(adamw.OptConfig(), tp), b)
