"""Public wrappers for the hand-written kernels: the layouts the model
code uses, mapped onto each kernel's contract.

Counterpart of ``repro.kernels.ops`` for the kernels of the dense and
paged serving paths.  The JAX wrappers pad every operand to block multiples
(``ops.py`` ``_pad_dim``) and flatten heads to ``(B*H, S, D)``; the CUDA
kernels mask their ragged edges themselves and read the native head
layouts, so what is left here is reshaping: a bias to ``(1, N)``, a
decode query to its ``(B*KV, G, D)`` groups (heads are kv-major,
``h = kv*G + g``), and contiguity.  The JAX paged wrappers clamp the
block table to ``[0, n_pages)`` before the kernel; here the kernel
clamps each entry it reads (no clamped copy a layer).  There are no
block sizes to tune yet (the block autotuner is later work).
"""
from __future__ import annotations

from repro_torch.kernels.vwr_attention import vwr_attention as _attention
from repro_torch.kernels.vwr_decode import vwr_flash_decode as _decode
from repro_torch.kernels.vwr_decode import vwr_paged_flash_decode as _paged
from repro_torch.kernels.vwr_decode import \
    vwr_paged_flash_decode_q8 as _paged_q8
from repro_torch.kernels.vwr_matmul import vwr_matmul as _matmul
from repro_torch.kernels.vwr_matmul import vwr_swiglu as _swiglu


def vwr_matmul(x, w, bias=None, residual=None, *, activation=None):
    """``act(x @ w + bias) + residual`` in one kernel pass.

    x: (M, K) @ w: (K, N); bias: (N,) or (1, N); residual: (M, N);
    activation in {None, 'relu', 'gelu', 'silu'} (gelu is the tanh
    approximation, jax.nn.gelu's default)."""
    N = w.shape[1]
    b = None if bias is None else bias.reshape(1, N).contiguous()
    r = None if residual is None else residual.contiguous()
    return _matmul(x.contiguous(), w.contiguous(), b, r,
                   activation=activation)


def vwr_swiglu(x, wg, wi):
    """``silu(x @ wg) * (x @ wi)`` in one kernel pass; x: (M, K);
    wg, wi: (K, N)."""
    return _swiglu(x.contiguous(), wg.contiguous(), wi.contiguous())


def vwr_attention(q, k, v, *, causal=True):
    """q: (B, S, H, D); k, v: (B, S, KV, D), KV dividing H (zero-copy
    GQA).  Only causal attention has a kernel; the non-causal path
    stays on the plain blockwise version (``models.attention``)."""
    if not causal:
        raise ValueError("vwr_attention is causal-only; dispatch the "
                         "non-causal path to the blockwise version")
    return _attention(q.contiguous(), k.contiguous(), v.contiguous())


def _groups(q, n_kv):
    """(B, H, D) one token's heads -> (B*KV, G, D) kv-major groups."""
    B, H, D = q.shape
    return q.reshape(B * n_kv, H // n_kv, D).contiguous()


def _heads(o_t, m, l, B):
    """(B*KV, G, ...) partials -> (B, H, ...)."""
    return (o_t.reshape(B, -1, o_t.shape[-1]), m.reshape(B, -1),
            l.reshape(B, -1))


def vwr_flash_decode(q, k, v, cur_len, pos0=0):
    """Unnormalized flash-decode partials for one new token.

    q: (B, H, Dh); k, v: (B, T, KV, Dh) — a KV cache (slab) whose first
    position has global index ``pos0``; ``cur_len`` counts the globally
    valid positions.  Returns fp32 (o_tilde (B, H, Dh), m (B, H),
    l (B, H)); single-slab callers normalize with
    ``o_tilde / max(l, eps)``."""
    out = _decode(_groups(q, k.shape[2]), k.contiguous(), v.contiguous(),
                  cur_len, pos0)
    return _heads(*out, q.shape[0])


def vwr_paged_flash_decode(q, k_pool, v_pool, table, counts):
    """Unnormalized flash-decode partials against a paged KV pool.

    q: (B, H, Dh); k_pool, v_pool: (n_pages, page_size, KV, Dh);
    table: (B, J) int32 physical page per (slot, logical page), clamped
    to [0, n_pages) as the JAX wrapper clamps it (the kernel clamps each
    entry it reads); counts: (B, J) int32 valid tokens per (slot,
    logical page), 0 masking a page.  Returns fp32 (o_tilde (B, H, Dh),
    m (B, H), l (B, H))."""
    B = q.shape[0]
    out = _paged(_groups(q, k_pool.shape[2]), k_pool, v_pool, table,
                 counts)
    return _heads(*out, B)


def vwr_paged_flash_decode_q8(q, k_pool, v_pool, k_scale, v_scale, table,
                              counts):
    """``vwr_paged_flash_decode`` over int8 pools with fp32
    (n_pages, KV) per-(page, KV head) scales."""
    B = q.shape[0]
    out = _paged_q8(_groups(q, k_pool.shape[2]), k_pool, v_pool, k_scale,
                    v_scale, table, counts)
    return _heads(*out, B)
