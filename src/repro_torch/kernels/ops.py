"""Public wrappers for the hand-written kernels: the layouts the model
code uses, mapped onto each kernel's contract.

Counterpart of ``repro.kernels.ops`` for the kernels of the dense and
paged serving paths, of absorbed-MLA decode and of the paper's CNN
layers (conv2d, depthwise).  The JAX wrappers pad every operand to block
multiples
(``ops.py`` ``_pad_dim``) and flatten heads to ``(B*H, S, D)``; the CUDA
kernels mask their ragged edges themselves and read the native head
layouts, so what is left here is reshaping: a bias to ``(1, N)``, a
decode query to its ``(B*KV, G, D)`` groups (heads are kv-major,
``h = kv*G + g``), and contiguity (the absorbed MLA queries come out of
``einsum`` as permuted views).  The JAX paged wrappers clamp the
block table to ``[0, n_pages)`` before the kernel; the paged decode
wrappers leave that to the kernel, which clamps each entry it reads (no
clamped copy a layer), and the chunk-prefix wrappers clamp their (J,)
table on the device, as the JAX ones do.  There are no block sizes to
tune yet (the block autotuner is later work), so the conv wrappers have
no ``bh`` / ``bf`` knob: the JAX ones pad H_out and F to their blocks,
the CUDA conv kernels mask ragged C, F, H_out and W_out themselves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import vwr_mla_decode as _mla
from repro_torch.kernels.vwr_attention import vwr_attention as _attention
from repro_torch.kernels.vwr_chunk import vwr_chunk_prefix_attend as _chunk
from repro_torch.kernels.vwr_chunk import \
    vwr_chunk_prefix_attend_q8 as _chunk_q8
from repro_torch.kernels.vwr_conv2d import vwr_conv2d as _conv2d
from repro_torch.kernels.vwr_decode import vwr_flash_decode as _decode
from repro_torch.kernels.vwr_decode import vwr_flash_decode_q8 as _decode_q8
from repro_torch.kernels.vwr_decode import vwr_paged_flash_decode as _paged
from repro_torch.kernels.vwr_decode import \
    vwr_paged_flash_decode_q8 as _paged_q8
from repro_torch.kernels.vwr_depthwise import vwr_depthwise as _depthwise
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


def vwr_conv2d(x, w, bias=None, *, activation=None):
    """``act(conv2d(x, w) + bias)`` in one kernel pass.

    x: (N, H, W, C); w: (KH, KW, C, F); stride 1, VALID.  bias: (F,) (or
    (1, F)) and activation in {None, 'relu', 'gelu', 'silu'} are fused
    into the fp32 sum before the single output store.  Returns
    (N, H-KH+1, W-KW+1, F) in x.dtype."""
    b = None if bias is None else bias.reshape(w.shape[3]).contiguous()
    return _conv2d(x.contiguous(), w.contiguous(), b, activation=activation)


def vwr_depthwise(x, w):
    """Depthwise conv: x (N, H, W, C); w (KH, KW, C); stride 1, VALID.
    Returns (N, H-KH+1, W-KW+1, C) in x.dtype."""
    return _depthwise(x.contiguous(), w.contiguous())


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


def vwr_flash_decode_q8(q, k, v, k_scale, v_scale, cur_len, pos0=0):
    """``vwr_flash_decode`` over an int8 cache with fp32 (B, KV) scales,
    one a (batch, KV head) row."""
    B = q.shape[0]
    out = _decode_q8(_groups(q, k.shape[2]), k.contiguous(), v.contiguous(),
                     k_scale.reshape(-1).contiguous(),
                     v_scale.reshape(-1).contiguous(), cur_len, pos0)
    return _heads(*out, B)


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


def _chunk_rows(q, n_kv):
    """(C, H, D) chunk queries -> (KV, C*G, D): each KV head's rows,
    token-major (row c*G + g is token c's head kv*G + g)."""
    C, H, D = q.shape
    G = H // n_kv
    return q.reshape(C, n_kv, G, D).transpose(0, 1).reshape(
        n_kv, C * G, D).contiguous()


def _chunk_heads(o_t, m, l, C):
    """(KV, C*G, ...) partials -> (C, H, ...)."""
    KV, CG, D = o_t.shape
    G = CG // C
    return (o_t.reshape(KV, C, G, D).transpose(0, 1).reshape(C, KV * G, D),
            m.reshape(KV, C, G).transpose(0, 1).reshape(C, KV * G),
            l.reshape(KV, C, G).transpose(0, 1).reshape(C, KV * G))


def _chunk_index(table, counts, n_pages):
    """The (J,) table clamped to [0, n_pages) and both as contiguous
    int32, on their own device (no host scalar, no sync)."""
    return (table.clamp(0, n_pages - 1).to(torch.int32).contiguous(),
            counts.to(torch.int32).contiguous())


def vwr_chunk_prefix_attend(q, k_pool, v_pool, table, counts):
    """Chunked-prefill prefix partials: a (C, H, Dh) query chunk against
    its prompt's J prior pages, each page staged once for all C*G query
    rows of a KV head.

    k_pool, v_pool: (n_pages, page_size, KV, Dh); table: (J,) physical
    page ids in prefix order; counts: (J,) valid tokens per page, 0
    masking a page.  Returns fp32 (o_tilde (C, H, Dh), m (C, H),
    l (C, H)); the chunk's own causal block is merged downstream
    (``models.attention.merge_partials``)."""
    tbl, cnt = _chunk_index(table, counts, k_pool.shape[0])
    out = _chunk(_chunk_rows(q, k_pool.shape[2]), k_pool, v_pool, tbl, cnt)
    return _chunk_heads(*out, q.shape[0])


def vwr_chunk_prefix_attend_q8(q, k_pool, v_pool, k_scale, v_scale, table,
                               counts):
    """``vwr_chunk_prefix_attend`` over int8 pools with fp32
    (n_pages, KV) per-(page, KV head) scales."""
    tbl, cnt = _chunk_index(table, counts, k_pool.shape[0])
    out = _chunk_q8(_chunk_rows(q, k_pool.shape[2]), k_pool, v_pool,
                    k_scale, v_scale, tbl, cnt)
    return _chunk_heads(*out, q.shape[0])


# ----------------------------------------------------------------------
# absorbed MLA: decode kernels 10, 11, 13 and 14, chunk-prefix kernels 12
# and 15 (csrc/vwr_mla_decode.cu)
# ----------------------------------------------------------------------

def vwr_mla_flash_decode(q_abs, q_rope, c_kv, k_rope, cur_len, pos0=0, *,
                         scale):
    """Unnormalized split-operand MLA partials against a dense latent
    cache.  q_abs (B, H, r) and q_rope (B, H, rope) fp32, folded through
    wk_b; c_kv (B, T, r) and k_rope (B, T, rope), first position at
    global ``pos0``; ``scale`` the absorbed 1/sqrt(nope + rope).
    Returns fp32 (o_tilde (B, H, r), m (B, H), l (B, H))."""
    return _mla.vwr_mla_flash_decode(
        q_abs.contiguous(), q_rope.contiguous(), c_kv.contiguous(),
        k_rope.contiguous(), cur_len, pos0, scale=scale)


def vwr_mla_flash_decode_q8(q_abs, q_rope, c_kv, k_rope, ckv_scale,
                            krope_scale, cur_len, pos0=0, *, scale):
    """``vwr_mla_flash_decode`` over int8 caches with fp32 (B,) scales."""
    return _mla.vwr_mla_flash_decode_q8(
        q_abs.contiguous(), q_rope.contiguous(), c_kv.contiguous(),
        k_rope.contiguous(), ckv_scale.contiguous(),
        krope_scale.contiguous(), cur_len, pos0, scale=scale)


def vwr_mla_paged_flash_decode(q_abs, q_rope, ckv_pool, krope_pool, table,
                               counts, *, scale):
    """Unnormalized split-operand MLA partials over latent page pools
    (n_pages, page_size, r / rope); table, counts (B, J) int32, 0
    masking a page; the kernel clamps each table entry it reads."""
    return _mla.vwr_mla_paged_flash_decode(
        q_abs.contiguous(), q_rope.contiguous(), ckv_pool, krope_pool,
        table, counts, scale=scale)


def vwr_mla_paged_flash_decode_q8(q_abs, q_rope, ckv_pool, krope_pool,
                                  ckv_scale, krope_scale, table, counts, *,
                                  scale):
    """``vwr_mla_paged_flash_decode`` over int8 pools with fp32
    (n_pages,) latent and rope scales."""
    return _mla.vwr_mla_paged_flash_decode_q8(
        q_abs.contiguous(), q_rope.contiguous(), ckv_pool, krope_pool,
        ckv_scale, krope_scale, table, counts, scale=scale)


def vwr_mla_chunk_prefix_attend(q_abs, q_rope, ckv_pool, krope_pool, table,
                                counts, *, scale):
    """Unnormalized split-operand MLA partials of a prompt chunk: q_abs
    (C, H, r) and q_rope (C, H, rope) fp32 against its J prior pages of
    the latent pools (n_pages, page_size, r / rope); table, counts (J,),
    0 masking a page; the kernel clamps each table entry it reads.
    Returns fp32 (o_tilde (C, H, r), m (C, H), l (C, H))."""
    return _mla.vwr_mla_chunk_prefix_attend(
        q_abs.contiguous(), q_rope.contiguous(), ckv_pool, krope_pool,
        table.to(torch.int32).contiguous(),
        counts.to(torch.int32).contiguous(), scale=scale)


def vwr_mla_chunk_prefix_attend_q8(q_abs, q_rope, ckv_pool, krope_pool,
                                   ckv_scale, krope_scale, table, counts, *,
                                   scale):
    """``vwr_mla_chunk_prefix_attend`` over int8 pools with fp32
    (n_pages,) latent and rope scales."""
    return _mla.vwr_mla_chunk_prefix_attend_q8(
        q_abs.contiguous(), q_rope.contiguous(), ckv_pool, krope_pool,
        ckv_scale, krope_scale, table.to(torch.int32).contiguous(),
        counts.to(torch.int32).contiguous(), scale=scale)
