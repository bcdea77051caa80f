"""Absorbed-MLA flash-decode partials against a dense latent cache or
latent page pools, and a prompt chunk's partials against its prior latent
pages: plain versions and the CUDA kernel wrappers.

Counterparts of ``repro.kernels.vwr_decode``'s ``vwr_mla_flash_decode_p``,
``vwr_mla_flash_decode_q8_p``, ``vwr_mla_paged_flash_decode_p``,
``vwr_mla_paged_flash_decode_q8_p``, ``vwr_mla_chunk_prefix_attend_p``
and ``vwr_mla_chunk_prefix_attend_q8_p`` (all six in
``csrc/vwr_mla_decode.cu``).  The queries come folded through ``wk_b``
(``models.mla.mla_absorbed_queries``): ``q_abs`` (B, H, r) and
``q_rope`` (B, H, rope), fp32.  A key's score is
``(q_abs . c_kv + q_rope . k_rope) * scale`` and its value is the latent
row ``c_kv`` itself, so the two caches are read once each, as separate
operands.

The dense cache is ``c_kv`` (B, T, r) / ``k_rope`` (B, T, rope) whose
first position has global index ``pos0``; positions with
``pos0 + idx < cur_len`` are valid.  The pools are (n_pages, page_size,
r) / (n_pages, page_size, rope): logical page j of slot b is the
physical page ``table[b, j]`` (clamped to [0, n_pages)) holding
``counts[b, j]`` valid keys, 0 masking the page.  A chunk's C tokens
(``q_abs`` (C, H, r)) share one (J,) table and counts: the decode
contract of the pools with every token reading the same pages.  int8
caches carry fp32
scales, one a sequence (B,) for the dense cache and one a page
(n_pages,) for the pools, separately for the latent and the rope part.

Returns the unnormalized fp32 partials ``(o_tilde (B, H, r), m (B, H),
l (B, H))``; a head with no valid key gives ``m = -1e30, l = 0,
o_tilde = 0``.  The kernels take r in {32, ..., 512} and rope in {32,
64}; a narrower r or rope (the reduced configs' 16 and 8) is zero-padded
to the next of those, queries and caches, on each call (zeros change no
score, and the padded latent columns of o_tilde are sliced off): on the
pools of a reduced config that copies the whole pool a call, which is
acceptable at reduced widths.  Nothing is copied at DeepSeek-V3's r 512,
rope 64.  A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, widths

NEG_INF = -1e30
# the kernel holds a lane's share of r and rope in registers: r / 32
# and rope / 32 latent and rope features a lane
RANKS = (32, 64, 128, 256, 512)
ROPES = (32, 64)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def mla_partials(q_abs, q_rope, ckv, kr, valid, scale: float):
    """The plain arithmetic: q_abs (B, H, r), q_rope (B, H, rope); ckv
    (B, T, r), kr (B, T, rope) in any dtype; valid (B or 1, T) bool."""
    ckv, kr = ckv.float(), kr.float()
    s = torch.einsum("bhr,btr->bht", q_abs.float(), ckv)
    s = s + torch.einsum("bhk,btk->bht", q_rope.float(), kr)
    s = torch.where(valid[:, None, :], s * scale, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where((m > NEG_INF / 2)[..., None], p, 0.0)
    return torch.einsum("bht,btr->bhr", p, ckv), m, p.sum(-1)


def vwr_mla_flash_decode_ref(q_abs, q_rope, c_kv, k_rope, cur_len, pos0=0,
                             *, scale: float):
    """Plain version of kernel 10: c_kv (B, T, r), k_rope (B, T, rope)."""
    T = c_kv.shape[1]
    valid = pos0 + torch.arange(T, device=c_kv.device) < cur_len
    return mla_partials(q_abs, q_rope, c_kv, k_rope, valid[None], scale)


def vwr_mla_flash_decode_q8_ref(q_abs, q_rope, c_kv, k_rope, ckv_scale,
                                krope_scale, cur_len, pos0=0, *,
                                scale: float):
    """Plain version of kernel 14: the int8 caches dequantized with their
    fp32 (B,) scales, then as ``vwr_mla_flash_decode_ref``."""
    ckv = c_kv.float() * ckv_scale[:, None, None]
    kr = k_rope.float() * krope_scale[:, None, None]
    return vwr_mla_flash_decode_ref(q_abs, q_rope, ckv, kr, cur_len, pos0,
                                    scale=scale)


def _gather_pages(pool, table):
    """(n_pages, ps, X) pool -> (B, J*ps, X) the table's pages (clamped)."""
    B, J = table.shape
    tbl = table.long().clamp(0, pool.shape[0] - 1)
    return pool[tbl].reshape(B, J * pool.shape[1], pool.shape[2]), tbl


def _page_valid(counts, ps):
    B, J = counts.shape
    return (torch.arange(ps, device=counts.device)[None, None, :]
            < counts[..., None]).reshape(B, J * ps)


def vwr_mla_paged_flash_decode_ref(q_abs, q_rope, ckv_pool, krope_pool,
                                   table, counts, *, scale: float):
    """Plain version of kernel 11: gathers only the tables' pages."""
    ckv, _ = _gather_pages(ckv_pool, table)
    kr, _ = _gather_pages(krope_pool, table)
    return mla_partials(q_abs, q_rope, ckv, kr,
                        _page_valid(counts, ckv_pool.shape[1]), scale)


def vwr_mla_paged_flash_decode_q8_ref(q_abs, q_rope, ckv_pool, krope_pool,
                                      ckv_scale, krope_scale, table, counts,
                                      *, scale: float):
    """Plain version of kernel 13: the gathered int8 pages dequantized
    with their fp32 (n_pages,) scales, then as the bf16 version."""
    ckv, tbl = _gather_pages(ckv_pool, table)
    kr, _ = _gather_pages(krope_pool, table)
    ps = ckv_pool.shape[1]
    ckv = ckv.float() * ckv_scale[tbl].repeat_interleave(ps, 1)[..., None]
    kr = kr.float() * krope_scale[tbl].repeat_interleave(ps, 1)[..., None]
    return mla_partials(q_abs, q_rope, ckv, kr, _page_valid(counts, ps),
                        scale)


def vwr_mla_chunk_prefix_attend_ref(q_abs, q_rope, ckv_pool, krope_pool,
                                    table, counts, *, scale: float):
    """Plain version of kernel 12: q_abs (C, H, r), q_rope (C, H, rope)
    against the (J,) table's pages, as one (1, C*H) row block of kernel
    11's plain version.  Returns fp32 (o_tilde (C, H, r), m (C, H),
    l (C, H))."""
    C, H, r = q_abs.shape
    o, m, l = vwr_mla_paged_flash_decode_ref(
        q_abs.reshape(1, C * H, r), q_rope.reshape(1, C * H, -1), ckv_pool,
        krope_pool, table[None], counts[None], scale=scale)
    return o.reshape(C, H, r), m.reshape(C, H), l.reshape(C, H)


def vwr_mla_chunk_prefix_attend_q8_ref(q_abs, q_rope, ckv_pool, krope_pool,
                                       ckv_scale, krope_scale, table, counts,
                                       *, scale: float):
    """Plain version of kernel 15: kernel 12's over the table's int8 pages
    dequantized with their fp32 (n_pages,) scales."""
    C, H, r = q_abs.shape
    o, m, l = vwr_mla_paged_flash_decode_q8_ref(
        q_abs.reshape(1, C * H, r), q_rope.reshape(1, C * H, -1), ckv_pool,
        krope_pool, ckv_scale, krope_scale, table[None], counts[None],
        scale=scale)
    return o.reshape(C, H, r), m.reshape(C, H), l.reshape(C, H)


# ----------------------------------------------------------------------
# the kernels
# ----------------------------------------------------------------------

def _launch(kernel, q_abs, q_rope, ckv, kr, scales, index, n_keys, scale):
    """Check the operands' shapes and launch ``kernel`` at the widths it
    takes (``widths.at_widths``: r and rope zero-padded, o_tilde sliced
    back); ``index`` is (table, counts) for the pools, (B, J) a sequence
    or (J,) shared by the B chunk tokens, () for the dense cache
    (``n_keys`` valid keys from row 0 of each sequence's slab)."""
    B, H, r0 = q_abs.shape
    rope0 = q_rope.shape[2]
    lead = ckv.shape[:2]
    if (q_rope.shape[:2] != (B, H) or ckv.shape != (*lead, r0)
            or kr.shape != (*lead, rope0) or (not index and lead[0] != B)
            or lead[0] < 1):
        raise ValueError(
            f"{kernel}: needs q_abs (B, H, r) and q_rope (B, H, rope) "
            f"against latent/rope caches (B or n_pages, T or page_size, "
            f"r / rope); got q_abs {tuple(q_abs.shape)}, q_rope "
            f"{tuple(q_rope.shape)}, c_kv {tuple(ckv.shape)}, k_rope "
            f"{tuple(kr.shape)}")
    return widths.at_widths(
        lambda q_abs, ckv, q_rope, kr: _kernel(
            kernel, q_abs, q_rope, ckv, kr, scales, index, n_keys, scale),
        [((q_abs, ckv), RANKS), ((q_rope, kr), ROPES)], kernel)


def _kernel(kernel, q_abs, q_rope, ckv, kr, scales, index, n_keys, scale):
    B, H, r = q_abs.shape
    rope = q_rope.shape[2]
    paged = bool(index)
    lead = ckv.shape[:2]
    build.check_operands(kernel, torch.float32, q_abs=(q_abs, (B, H, r)),
                         q_rope=(q_rope, (B, H, rope)))
    cache_dt = torch.int8 if scales else ckv.dtype
    code = 0 if scales else build.dtype_code(cache_dt)
    build.check_operands(kernel, cache_dt, c_kv=(ckv, ckv.shape),
                         k_rope=(kr, kr.shape))
    if scales:
        build.check_operands(kernel, torch.float32,
                             ckv_scale=(scales[0], (lead[0],)),
                             krope_scale=(scales[1], (lead[0],)))
    J = 0
    if paged:
        J = index[0].shape[-1]
        # a chunk's B tokens share one (J,) table, a sequence has its row
        rows = () if kernel.startswith("vwr_mla_chunk") else (B,)
        build.check_operands(kernel, torch.int32,
                             table=(index[0], (*rows, J)),
                             counts=(index[1], (*rows, J)))
    f32 = dict(dtype=torch.float32, device=q_abs.device)
    o_t = torch.empty((B, H, r), **f32)
    m = torch.empty((B, H), **f32)
    l = torch.empty((B, H), **f32)
    ptrs = [q_abs, q_rope, ckv, kr, *scales, *index, o_t, m, l]
    lib, fn = build.kernel_fn("vwr_mla_decode", f"{kernel}_launch",
                              [_VP] * len(ptrs) + [_I] * 7
                              + [_F, _I, _VP])
    err = fn(*(t.data_ptr() for t in ptrs), B, H, r, rope, lead[0],
             lead[1], J if paged else n_keys, scale, code,
             build.stream_of(q_abs))
    build.check(lib, err, kernel)
    build.count_launch(kernel)
    return o_t, m, l


def vwr_mla_flash_decode(q_abs, q_rope, c_kv, k_rope, cur_len: int,
                         pos0: int = 0, *, scale: float):
    """Kernel 10.  q_abs (B, H, r), q_rope (B, H, rope) fp32; c_kv
    (B, T, r), k_rope (B, T, rope) bf16 or fp32; ``cur_len`` and
    ``pos0`` host integers on the kernel path.  Returns fp32 (o_tilde,
    m, l) as ``vwr_mla_flash_decode_ref``."""
    if q_abs.device.type == "cpu":
        return vwr_mla_flash_decode_ref(q_abs, q_rope, c_kv, k_rope,
                                        cur_len, pos0, scale=scale)
    n_keys = max(0, min(c_kv.shape[1], int(cur_len) - int(pos0)))
    return _launch("vwr_mla_flash_decode", q_abs, q_rope, c_kv, k_rope,
                   (), (), n_keys, scale)


def vwr_mla_flash_decode_q8(q_abs, q_rope, c_kv, k_rope, ckv_scale,
                            krope_scale, cur_len: int, pos0: int = 0, *,
                            scale: float):
    """Kernel 14: kernel 10 over int8 caches with fp32 (B,) scales."""
    if q_abs.device.type == "cpu":
        return vwr_mla_flash_decode_q8_ref(q_abs, q_rope, c_kv, k_rope,
                                           ckv_scale, krope_scale, cur_len,
                                           pos0, scale=scale)
    n_keys = max(0, min(c_kv.shape[1], int(cur_len) - int(pos0)))
    return _launch("vwr_mla_flash_decode_q8", q_abs, q_rope, c_kv, k_rope,
                   (ckv_scale, krope_scale), (), n_keys, scale)


def vwr_mla_paged_flash_decode(q_abs, q_rope, ckv_pool, krope_pool, table,
                               counts, *, scale: float):
    """Kernel 11.  Pools (n_pages, page_size, r / rope) bf16 or fp32;
    table, counts (B, J) int32.  The kernel clamps each table entry it
    reads, so no clamped copy of the table is made."""
    if q_abs.device.type == "cpu":
        return vwr_mla_paged_flash_decode_ref(q_abs, q_rope, ckv_pool,
                                              krope_pool, table, counts,
                                              scale=scale)
    return _launch("vwr_mla_paged_flash_decode", q_abs, q_rope, ckv_pool,
                   krope_pool, (), (table, counts), 0, scale)


def vwr_mla_paged_flash_decode_q8(q_abs, q_rope, ckv_pool, krope_pool,
                                  ckv_scale, krope_scale, table, counts, *,
                                  scale: float):
    """Kernel 13: kernel 11 over int8 pools with fp32 (n_pages,) scales."""
    if q_abs.device.type == "cpu":
        return vwr_mla_paged_flash_decode_q8_ref(
            q_abs, q_rope, ckv_pool, krope_pool, ckv_scale, krope_scale,
            table, counts, scale=scale)
    return _launch("vwr_mla_paged_flash_decode_q8", q_abs, q_rope, ckv_pool,
                   krope_pool, (ckv_scale, krope_scale), (table, counts), 0,
                   scale)


def vwr_mla_chunk_prefix_attend(q_abs, q_rope, ckv_pool, krope_pool, table,
                                counts, *, scale: float):
    """Kernel 12.  q_abs (C, H, r), q_rope (C, H, rope) fp32, a prompt
    chunk's absorbed queries; pools (n_pages, page_size, r / rope) bf16 or
    fp32; table, counts (J,) int32 the chunk's prior pages, shared by its
    C tokens (the kernel clamps each entry it reads).  Returns fp32
    (o_tilde (C, H, r), m (C, H), l (C, H))."""
    if q_abs.device.type == "cpu":
        return vwr_mla_chunk_prefix_attend_ref(q_abs, q_rope, ckv_pool,
                                               krope_pool, table, counts,
                                               scale=scale)
    return _launch("vwr_mla_chunk_prefix_attend", q_abs, q_rope, ckv_pool,
                   krope_pool, (), (table, counts), 0, scale)


def vwr_mla_chunk_prefix_attend_q8(q_abs, q_rope, ckv_pool, krope_pool,
                                   ckv_scale, krope_scale, table, counts, *,
                                   scale: float):
    """Kernel 15: kernel 12 over int8 pools with fp32 (n_pages,) scales."""
    if q_abs.device.type == "cpu":
        return vwr_mla_chunk_prefix_attend_q8_ref(
            q_abs, q_rope, ckv_pool, krope_pool, ckv_scale, krope_scale,
            table, counts, scale=scale)
    return _launch("vwr_mla_chunk_prefix_attend_q8", q_abs, q_rope,
                   ckv_pool, krope_pool, (ckv_scale, krope_scale),
                   (table, counts), 0, scale)
