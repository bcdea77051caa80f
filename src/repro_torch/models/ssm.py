"""Mamba2 (SSD) block, chunked formulation: the counterpart of
``repro.models.ssm``.

``mamba2_forward`` (prefill) splits the sequence into chunks of
``Q = min(chunk, S)`` positions (S must be a multiple of Q: padding would
change the recurrent state, so any other length raises) and evaluates
each chunk's intra-chunk terms as masked decay matmuls.  The inter-chunk
recurrence is either

  * ``_ssd_scan`` (the real program): a sequential loop over chunks
    carrying the (B, H, N, P) state, peak memory O(B * H * Q^2), or
  * ``_ssd_closed`` (``cfg.accounting``): the same recurrence in closed
    form as an (n_chunks x n_chunks) decay product (per-head decays are
    scalars), scan-free, as the JAX package's accounting program.

``mamba2_step`` is the O(1) single-token decode.  Every product is a
plain ``torch.einsum`` / matmul, as the JAX package's are plain einsums:
no kernel of the port runs here.  Casts follow the JAX code: the conv
taps sum in the model dtype, silu runs in fp32 and is cast back, the
gates and the state are fp32, the rmsnorm takes the model dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.module import (ParamDef, a_log_init, const_init,
                                       ones_init, zeros_init)
from repro_torch.models.layers import dt, rmsnorm, rmsnorm_spec


def _dims(cfg):
    """(d_inner, heads H, head_dim P, groups G, d_state N, d_xbc)."""
    mc = cfg.mamba2
    d_inner = mc.expand * cfg.d_model
    G, N = mc.n_groups, mc.d_state
    return (d_inner, d_inner // mc.head_dim, mc.head_dim, G, N,
            d_inner + 2 * G * N)


def mamba2_spec(cfg):
    mc = cfg.mamba2
    D = cfg.d_model
    d_inner, H, _, _, _, d_xbc = _dims(cfg)
    dtype = dt(cfg)
    f32 = torch.float32
    return {
        "in_proj": ParamDef((D, d_inner + d_xbc + H), dtype,
                            ("embed", "inner_all")),
        "conv_w": ParamDef((mc.d_conv, d_xbc), dtype, ("conv_k", "inner")),
        "conv_b": ParamDef((d_xbc,), dtype, ("inner",), zeros_init),
        "dt_bias": ParamDef((H,), f32, ("heads",), const_init(0.5)),
        "a_log": ParamDef((H,), f32, ("heads",), a_log_init),
        "d_skip": ParamDef((H,), f32, ("heads",), ones_init),
        "norm": rmsnorm_spec(d_inner, dtype),
        "out_proj": ParamDef((d_inner, D), dtype, ("inner", "embed")),
    }


class Mamba2State(NamedTuple):
    ssm: torch.Tensor      # (B, H, N, P) fp32
    conv: torch.Tensor     # (B, K-1, d_xbc) model dtype


def init_state(cfg, batch: int, device) -> Mamba2State:
    mc = cfg.mamba2
    _, H, P, _, N, d_xbc = _dims(cfg)
    return Mamba2State(
        ssm=torch.zeros((batch, H, N, P), dtype=torch.float32,
                        device=device),
        conv=torch.zeros((batch, mc.d_conv - 1, d_xbc), dtype=dt(cfg),
                         device=device))


def _split_proj(p, x, cfg):
    d_inner, H, _, G, N, _ = _dims(cfg)
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner: d_inner * 2 + 2 * G * N]
    dt_ = zxbcdt[..., -H:]
    return z, xbc, dt_


def _causal_conv(p, x, K: int, left_ctx=None):
    """Depthwise causal conv1d of x (B, S, C) along the sequence (taps
    ``conv_w`` (K, C), bias ``conv_b``), then silu; the JAX package's
    ``ssm._causal_conv`` and ``xlstm._mlstm_conv``, which are the same
    function.  ``left_ctx``: (B, K-1, C) carried context (a
    continuation); zeros at the sequence start."""
    if left_ctx is None:
        pad = F.pad(x, (0, 0, K - 1, 0))
    else:
        pad = torch.cat([left_ctx.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = sum(pad[:, i: i + S, :] * p["conv_w"][i][None, None, :]
              for i in range(K)) + p["conv_b"]
    return F.silu(out.float()).to(x.dtype)


def _conv_tail(x, tail: int):
    """The last ``tail`` raw conv inputs, the next call's left context; a
    sequence shorter than that is left-padded with zeros."""
    S = x.shape[1]
    if S >= tail:
        return x[:, S - tail:, :]
    return F.pad(x, (0, 0, tail - S, 0))


def _chunk_math(xq, Bq, Cq, dtq, aq, G, hpg):
    """Per-chunk quantities shared by both variants.

    xq (B,Q,H,P) fp32; Bq/Cq (B,Q,G,N) fp32; dtq/aq (B,Q,H) fp32.
    Returns y_intra (B,Q,G,hpg,P), S_chunk (B,G,hpg,N,P), cum (B,Q,H),
    g_tot (B,H)."""
    Bsz, Q = xq.shape[:2]
    cum = torch.cumsum(aq, dim=1)                                 # (B,Q,H)
    cb = torch.einsum("blgn,bsgn->bgls", Cq, Bq)                  # (B,G,l,s)
    # mask BEFORE exp: the upper triangle holds positive log-decays whose
    # exp overflows
    diff = cum[:, :, None, :] - cum[:, None, :, :]                # (B,l,s,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xq.device).tril()
    decay = torch.exp(torch.where(mask[None, :, :, None], diff, -1e30))
    xdt = xq * dtq[..., None]                                     # (B,Q,H,P)
    dec = decay.permute(0, 3, 1, 2).reshape(Bsz, G, hpg, Q, Q)
    att = cb[:, :, None] * dec                                    # (B,G,hpg,l,s)
    xdt_g = xdt.reshape(Bsz, Q, G, hpg, -1)
    y_intra = torch.einsum("bghls,bsghp->blghp", att, xdt_g)
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)                # (B,Q,H)
    xw_g = (xdt * decay_to_end[..., None]).reshape(Bsz, Q, G, hpg, -1)
    S_chunk = torch.einsum("bsgn,bsghp->bghnp", Bq, xw_g)
    return y_intra, S_chunk, cum, cum[:, -1, :]


def chunk_len(chunk: int, S: int) -> int:
    """The chunk length ``min(chunk, S)``; a sequence that is not a
    multiple of it raises (as the JAX package asserts)."""
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(
            f"a sequence of {S} positions is neither at most the chunk "
            f"({chunk}) nor a multiple of it: padding would change the "
            "recurrent state")
    return Q


def mamba2_forward(p, x, cfg, initial_state: Mamba2State | None = None
                   ) -> Tuple[torch.Tensor, Mamba2State]:
    """Prefill forward. x: (B, S, D). Returns (y, final_state)."""
    mc = cfg.mamba2
    Bsz, S, _ = x.shape
    d_inner, H, P, G, N, _ = _dims(cfg)
    Q = chunk_len(mc.chunk, S)
    nc = S // Q
    hpg = H // G

    z, xbc_raw, dt_ = _split_proj(p, x, cfg)
    conv_tail = _conv_tail(xbc_raw, mc.d_conv - 1)
    left = initial_state.conv if initial_state is not None else None
    xbc = _causal_conv(p, xbc_raw, mc.d_conv, left_ctx=left)
    xs = xbc[..., :d_inner].reshape(Bsz, S, H, P)
    Bmat = xbc[..., d_inner: d_inner + G * N].reshape(Bsz, S, G, N)
    Cmat = xbc[..., d_inner + G * N:].reshape(Bsz, S, G, N)

    dt_ = F.softplus(dt_.float() + p["dt_bias"])                  # (B,S,H)
    a = -torch.exp(p["a_log"]) * dt_                              # <= 0

    xf = xs.float().reshape(Bsz, nc, Q, H, P)
    Bf = Bmat.float().reshape(Bsz, nc, Q, G, N)
    Cf = Cmat.float().reshape(Bsz, nc, Q, G, N)
    dtf = dt_.reshape(Bsz, nc, Q, H)
    af = a.reshape(Bsz, nc, Q, H)

    S0 = (initial_state.ssm if initial_state is not None
          else torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                           device=x.device)).reshape(Bsz, G, hpg, N, P)
    ssd = _ssd_closed if cfg.accounting else _ssd_scan
    y, S_fin = ssd(xf, Bf, Cf, dtf, af, S0, G, hpg)

    y = y.reshape(Bsz, S, H, P)
    y = y + xs.float() * p["d_skip"][None, None, :, None]

    # gate + norm + out
    y = y.reshape(Bsz, S, d_inner) * F.silu(z.float())
    y = rmsnorm(p["norm"], y.to(x.dtype), cfg.norm_eps)
    out = y @ p["out_proj"]
    return out, Mamba2State(ssm=S_fin.reshape(Bsz, H, N, P), conv=conv_tail)


def _apply_state(Cq, cum, S_in, G, hpg):
    """y_inter[l] = C[l] . exp(cum[l]) . S_in."""
    Bsz, Q = Cq.shape[:2]
    return torch.einsum("blgn,bghnp,blgh->blghp", Cq, S_in,
                        torch.exp(cum).reshape(Bsz, Q, G, hpg))


def _ssd_scan(xf, Bf, Cf, dtf, af, S0, G, hpg):
    """Sequential chunk scan (the real program): bounded memory."""
    Bsz, nc = xf.shape[:2]
    S_prev, ys = S0, []
    for c in range(nc):
        xq, Bq, Cq, dtq, aq = (t[:, c] for t in (xf, Bf, Cf, dtf, af))
        y_intra, S_chunk, cum, g_tot = _chunk_math(xq, Bq, Cq, dtq, aq, G,
                                                   hpg)
        ys.append(y_intra + _apply_state(Cq, cum, S_prev, G, hpg))
        S_prev = (S_prev * torch.exp(g_tot).reshape(Bsz, G, hpg)[
            ..., None, None] + S_chunk)
    return torch.stack(ys, 1), S_prev          # (B,nc,Q,G,hpg,P)


def _ssd_closed(xf, Bf, Cf, dtf, af, S0, G, hpg):
    """Closed-form inter-chunk combination (the accounting program)."""
    Bsz, nc = xf.shape[:2]
    parts = [_chunk_math(*(t[:, c] for t in (xf, Bf, Cf, dtf, af)), G, hpg)
             for c in range(nc)]
    y_intra, S_chunk, cum, g_tot = (torch.stack(t, 1) for t in zip(*parts))
    # g_tot: (B,nc,H); cum: (B,nc,Q,H)
    Gcum = torch.cumsum(g_tot, dim=1)
    # M[c, c'] = exp(G[c-1] - G[c']) for c' < c (strictly lower triangular)
    diff = Gcum[:, :, None, :] - g_tot[:, :, None, :] - Gcum[:, None, :, :]
    cmask = torch.ones((nc, nc), dtype=torch.bool,
                       device=xf.device).tril(-1)
    M = torch.exp(torch.where(cmask[None, :, :, None], diff, -1e30))
    M_g = M.reshape(Bsz, nc, nc, G, hpg)
    S_in = torch.einsum("bczgh,bzghnp->bcghnp", M_g, S_chunk)
    # contribution of the initial state: decay G[c-1] from sequence start
    init_dec = torch.exp(Gcum - g_tot).reshape(Bsz, nc, G, hpg)
    S_in = S_in + S0[:, None] * init_dec[..., None, None]
    y_inter = torch.stack([_apply_state(Cf[:, c], cum[:, c], S_in[:, c], G,
                                        hpg) for c in range(nc)], 1)
    last_decay = torch.exp(g_tot[:, -1, :]).reshape(Bsz, G, hpg)
    S_fin = S_in[:, -1] * last_decay[..., None, None] + S_chunk[:, -1]
    return y_intra + y_inter, S_fin


def mamba2_step(p, x, state: Mamba2State, cfg
                ) -> Tuple[torch.Tensor, Mamba2State]:
    """Single-token decode. x: (B, D). O(1) in sequence length; returns
    a new state (the caller writes it back into its cache)."""
    Bsz = x.shape[0]
    d_inner, H, P, G, N, _ = _dims(cfg)

    z, xbc, dt_ = _split_proj(p, x, cfg)                          # (B, .)
    conv_in = torch.cat([state.conv, xbc[:, None, :]], dim=1)     # (B,K,dxbc)
    xbc_c = torch.einsum("bke,ke->be", conv_in, p["conv_w"]) + p["conv_b"]
    xbc_c = F.silu(xbc_c.float()).to(x.dtype)
    new_conv = conv_in[:, 1:, :]

    xs = xbc_c[..., :d_inner].reshape(Bsz, H, P).float()
    Bv = xbc_c[..., d_inner: d_inner + G * N].reshape(Bsz, G, N).float()
    Cv = xbc_c[..., d_inner + G * N:].reshape(Bsz, G, N).float()

    dt_ = F.softplus(dt_.float() + p["dt_bias"])                  # (B,H)
    decay = torch.exp(-torch.exp(p["a_log"]) * dt_)               # (B,H)

    Bh = torch.repeat_interleave(Bv, H // G, dim=1)               # (B,H,N)
    Ch = torch.repeat_interleave(Cv, H // G, dim=1)
    h = state.ssm * decay[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh * dt_[..., None], xs)
    y = torch.einsum("bhn,bhnp->bhp", Ch, h) \
        + xs * p["d_skip"][None, :, None]

    y = y.reshape(Bsz, d_inner) * F.silu(z.float())
    y = rmsnorm(p["norm"], y.to(x.dtype), cfg.norm_eps)
    return y @ p["out_proj"], Mamba2State(ssm=h, conv=new_conv)
