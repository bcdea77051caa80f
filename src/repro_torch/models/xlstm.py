"""xLSTM blocks, chunkwise-parallel mLSTM and sequential sLSTM: the
counterpart of ``repro.models.xlstm``.

mLSTM (matrix memory, per head of dim P):
    C_t = f_t C_{t-1} + i_t k_t v_t^T      n_t = f_t n_{t-1} + i_t k_t
    h_t = o_t * (C_t^T q_t) / max(|n_t . q_t|, exp(-m_t))
with an exponential input gate, a sigmoid forget gate and the log-domain
stabilizer m_t.  ``mlstm_chunkwise`` evaluates the within-chunk terms as
a masked attention-like product and carries (C, n, m) across chunks in a
loop; ``mlstm_ref`` is the per-timestep recurrence (the decode step, and
the oracle of the tests).

sLSTM (scalar memory, a block-diagonal recurrence R per head) feeds
h_{t-1} into its gates, so its prefill is a loop over time, as the JAX
package's ``lax.scan`` is.  1-in-N layers are sLSTM (xLSTM[m:s]).

Every product is a plain ``torch.einsum`` / matmul, as the JAX package's
are plain einsums: no kernel of the port runs here.  Gates and states
are fp32; the conv taps sum in the model dtype and silu runs in fp32.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.module import ParamDef, const_init, zeros_init
from repro_torch.models.layers import dt, rmsnorm, rmsnorm_spec
from repro_torch.models.ssm import _causal_conv, _conv_tail, chunk_len

# the stabilizers' start: -inf-ish, finite so that m + log f stays finite
M_START = -1e30

# ======================================================================
# mLSTM
# ======================================================================


def _mlstm_dims(cfg):
    """(d_inner, heads H, head dim P)."""
    d_inner = int(cfg.xlstm.proj_factor * cfg.d_model)
    return d_inner, cfg.n_heads, d_inner // cfg.n_heads


def mlstm_spec(cfg):
    xc = cfg.xlstm
    D = cfg.d_model
    d_inner, H, P = _mlstm_dims(cfg)
    K = xc.conv1d_kernel
    dtype = dt(cfg)
    f32 = torch.float32
    return {
        "in_proj": ParamDef((D, 2 * d_inner), dtype, ("embed", "inner_all")),
        "conv_w": ParamDef((K, d_inner), dtype, ("conv_k", "inner")),
        "conv_b": ParamDef((d_inner,), dtype, ("inner",), zeros_init),
        "wq": ParamDef((d_inner, H, P), dtype, ("inner", "heads", "head_dim")),
        "wk": ParamDef((d_inner, H, P), dtype, ("inner", "heads", "head_dim")),
        "wv": ParamDef((d_inner, H, P), dtype, ("inner", "heads", "head_dim")),
        "w_i": ParamDef((d_inner, H), f32, ("inner", "heads"), zeros_init),
        "b_i": ParamDef((H,), f32, ("heads",), zeros_init),
        "w_f": ParamDef((d_inner, H), f32, ("inner", "heads"), zeros_init),
        "b_f": ParamDef((H,), f32, ("heads",), const_init(3.0)),
        "norm": rmsnorm_spec(d_inner, dtype),
        "out_proj": ParamDef((d_inner, D), dtype, ("inner", "embed")),
    }


class MLSTMState(NamedTuple):
    C: torch.Tensor       # (B, H, P, P) fp32, stabilized matrix memory
    n: torch.Tensor       # (B, H, P) fp32
    m: torch.Tensor       # (B, H) fp32, log stabilizer
    conv: torch.Tensor    # (B, K-1, d_inner) model dtype


def mlstm_init_state(cfg, batch: int, device) -> MLSTMState:
    d_inner, H, P = _mlstm_dims(cfg)
    f32 = torch.float32
    return MLSTMState(
        C=torch.zeros((batch, H, P, P), dtype=f32, device=device),
        n=torch.zeros((batch, H, P), dtype=f32, device=device),
        m=torch.full((batch, H), M_START, dtype=f32, device=device),
        conv=torch.zeros((batch, cfg.xlstm.conv1d_kernel - 1, d_inner),
                         dtype=dt(cfg), device=device))


def _mlstm_qkvif(p, xc_act):
    """xc_act: (B,S,d_inner) conv-activated branch -> q, k, v and the log
    gates (li, lf) fp32."""
    q = torch.einsum("bse,ehp->bshp", xc_act, p["wq"])
    k = torch.einsum("bse,ehp->bshp", xc_act, p["wk"])
    v = torch.einsum("bse,ehp->bshp", xc_act, p["wv"])
    xf = xc_act.float()
    li = xf @ p["w_i"] + p["b_i"]                                 # log i-gate
    lf = F.logsigmoid(xf @ p["w_f"] + p["b_f"])                   # log f-gate
    return q, k, v, li, lf


def _mlstm_chunk(carry, qq, kk, vv, ii, ff):
    """One chunk of ``mlstm_chunkwise``: (new carry, h (B,Q,H,P))."""
    C0, n0, m0 = carry                      # C0/n0 stabilized by exp(-m0)
    Q = qq.shape[1]
    b = torch.cumsum(ff, dim=1)             # (B,Q,H) log-decay to chunk start
    a = ii - b                              # log i_s discounted to start
    g = torch.maximum(m0[:, None, :], torch.cummax(a, dim=1).values)
    m_t = b + g                             # per-position stabilizer

    # intra-chunk: Dmat[t,s] = exp(a_s - g_t) for s<=t.  Mask before exp:
    # upper-triangle log-weights can be positive and overflow.
    ldm = a[:, None, :, :] - g[:, :, None, :]                     # (B,t,s,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=qq.device).tril()
    dmat = torch.exp(torch.where(tri[None, :, :, None], ldm, -1e30))
    s_qk = torch.einsum("bthp,bshp->btsh", qq, kk)
    w = s_qk * dmat
    num = torch.einsum("btsh,bshp->bthp", w, vv)
    den = w.sum(dim=2)                                            # (B,t,H)

    # inter-chunk: the carry's contribution, weight exp(m0 - g_t)
    wc = torch.exp(m0[:, None, :] - g)                            # (B,t,H)
    num = num + wc[..., None] * torch.einsum("bthp,bhpj->bthj", qq, C0)
    den = den + wc * torch.einsum("bthp,bhp->bth", qq, n0)

    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]

    # end-of-chunk state
    bQ, gQ = b[:, -1, :], g[:, -1, :]                             # (B,H)
    m1 = bQ + gQ
    wS = torch.exp(a - gQ[:, None, :])                            # (B,s,H)
    kv = torch.einsum("bshp,bsh,bshj->bhpj", kk, wS, vv)          # (B,H,P,P)
    kn = torch.einsum("bshp,bsh->bhp", kk, wS)
    decay = torch.exp(m0 - gQ)                                    # (B,H)
    C1 = C0 * decay[..., None, None] + kv
    n1 = n0 * decay[..., None] + kn
    return (C1, n1, m1), h


def mlstm_chunkwise(q, k, v, li, lf, state: Tuple, chunk: int,
                    unroll: bool = False):
    """Chunkwise-parallel stabilized mLSTM over a sequence.

    q, k, v: (B,S,H,P); li, lf: (B,S,H) fp32; state: (C (B,H,P,P), n
    (B,H,P), m (B,H)) fp32.  Returns (h (B,S,H,P) fp32, new state).
    ``unroll`` is the JAX package's accounting switch (a Python loop in
    place of ``lax.scan``); the chunks always run as a Python loop here,
    so both settings compute the same thing."""
    del unroll
    B, S, H, P = q.shape
    Q = chunk_len(chunk, S)
    nc = S // Q
    scale = 1.0 / (P ** 0.5)
    qf = q.float().reshape(B, nc, Q, H, P)
    kf = (k.float() * scale).reshape(B, nc, Q, H, P)
    vf = v.float().reshape(B, nc, Q, H, P)
    lif = li.reshape(B, nc, Q, H)
    lff = lf.reshape(B, nc, Q, H)
    carry, hs = tuple(state), []
    for c in range(nc):
        carry, h = _mlstm_chunk(carry, *(t[:, c] for t in
                                         (qf, kf, vf, lif, lff)))
        hs.append(h)
    return torch.stack(hs, 1).reshape(B, S, H, P), carry


def mlstm_ref(q, k, v, li, lf, state):
    """The per-timestep recurrence (the decode step; the tests' oracle)."""
    B, S, H, P = q.shape
    scale = 1.0 / (P ** 0.5)
    qf, kf, vf = (t.float() for t in (q, k, v))
    kf = kf * scale
    C, n, m = state
    hs = []
    for t in range(S):
        qt, kt, vt, it, ft = (x[:, t] for x in (qf, kf, vf, li, lf))
        m1 = torch.maximum(ft + m, it)
        fp = torch.exp(ft + m - m1)
        ip = torch.exp(it - m1)
        C = C * fp[..., None, None] + ip[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = n * fp[..., None] + ip[..., None] * kt
        num = torch.einsum("bhp,bhpj->bhj", qt, C)
        den = torch.einsum("bhp,bhp->bh", qt, n)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m1))[..., None])
        m = m1
    return torch.stack(hs, 1), (C, n, m)


def mlstm_forward(p, x, cfg, state: MLSTMState | None = None):
    """The whole mLSTM block. x: (B,S,D) -> (y, new state)."""
    xc = cfg.xlstm
    B, S = x.shape[:2]
    d_inner = _mlstm_dims(cfg)[0]
    K = xc.conv1d_kernel

    proj = x @ p["in_proj"]
    xa, z = proj[..., :d_inner], proj[..., d_inner:]
    conv_tail = _conv_tail(xa, K - 1)
    left = state.conv if state is not None else None
    xc_act = _causal_conv(p, xa, K, left_ctx=left)
    q, k, v, li, lf = _mlstm_qkvif(p, xc_act)

    if state is None:
        state = mlstm_init_state(cfg, B, device=x.device)
    h, (C, n, m) = mlstm_chunkwise(q, k, v, li, lf,
                                   (state.C, state.n, state.m), xc.chunk,
                                   unroll=cfg.accounting)
    h = h.reshape(B, S, d_inner) * F.silu(z.float())
    h = rmsnorm(p["norm"], h.to(x.dtype), cfg.norm_eps)
    return h @ p["out_proj"], MLSTMState(C=C, n=n, m=m, conv=conv_tail)


def mlstm_step(p, x, state: MLSTMState, cfg):
    """Single-token decode. x: (B,D). O(P^2) a head, O(1) in sequence
    length; returns a new state (the caller writes it back)."""
    B = x.shape[0]
    d_inner = _mlstm_dims(cfg)[0]
    proj = x @ p["in_proj"]
    xa, z = proj[..., :d_inner], proj[..., d_inner:]
    conv_in = torch.cat([state.conv, xa[:, None, :]], dim=1)
    xc_act = torch.einsum("bke,ke->be", conv_in, p["conv_w"]) + p["conv_b"]
    xc_act = F.silu(xc_act.float()).to(x.dtype)

    q, k, v, li, lf = _mlstm_qkvif(p, xc_act[:, None, :])
    h, (C, n, m) = mlstm_ref(q, k, v, li, lf, (state.C, state.n, state.m))

    h = h[:, 0].reshape(B, d_inner) * F.silu(z.float())
    h = rmsnorm(p["norm"], h.to(x.dtype), cfg.norm_eps)
    return h @ p["out_proj"], MLSTMState(C=C, n=n, m=m,
                                         conv=conv_in[:, 1:, :])


# ======================================================================
# sLSTM
# ======================================================================


def slstm_spec(cfg):
    D, H = cfg.d_model, cfg.n_heads
    P = D // H
    dtype = dt(cfg)
    # proj factor 4/3 rounded up to a multiple of 64, as the released
    # xLSTM does
    ff = -(-int(D * 4 / 3) // 64) * 64
    return {
        # input weights of the 4 gates (z, i, f, o)
        "w_in": ParamDef((D, 4 * D), dtype, ("embed", "inner_all")),
        # block-diagonal recurrent weights, per head: (4, H, P, P)
        "r": ParamDef((4, H, P, P), dtype, ("gates", "heads", "head_dim",
                                            "head_dim2")),
        "b": ParamDef((4, D), torch.float32, ("gates", "embed"), zeros_init),
        "norm": rmsnorm_spec(D, dtype),
        # post-block gated FFN (proj factor 4/3)
        "ff_norm": rmsnorm_spec(D, dtype),
        "ff_wi": ParamDef((D, ff), dtype, ("embed", "ffn")),
        "ff_wg": ParamDef((D, ff), dtype, ("embed", "ffn")),
        "ff_wo": ParamDef((ff, D), dtype, ("ffn", "embed")),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor    # (B, D) fp32
    n: torch.Tensor    # (B, D) fp32
    h: torch.Tensor    # (B, D) fp32
    m: torch.Tensor    # (B, D) fp32


def slstm_init_state(cfg, batch: int, device) -> SLSTMState:
    def z():
        return torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                           device=device)
    return SLSTMState(c=z(), n=z(), h=z(),
                      m=torch.full((batch, cfg.d_model), M_START,
                                   dtype=torch.float32, device=device))


def _slstm_cell(r32, b, wx, st: SLSTMState, H, P):
    """One recurrent step.  r32: the recurrent weights (4, H, P, P) in
    fp32; b: the (4, D) fp32 biases; wx: (B, 4D) the precomputed input
    contribution."""
    B = wx.shape[0]
    D = H * P
    rh = torch.einsum("bhp,ghpj->gbhj", st.h.reshape(B, H, P),
                      r32).reshape(4, B, D)
    pre = wx.float().reshape(B, 4, D).transpose(0, 1) + rh + b[:, None, :]
    zt = torch.tanh(pre[0])
    it = pre[1]                                  # log-domain input gate
    ft = F.logsigmoid(pre[2])                    # log-domain forget gate
    ot = torch.sigmoid(pre[3])
    m1 = torch.maximum(ft + st.m, it)
    fp = torch.exp(ft + st.m - m1)
    ip = torch.exp(it - m1)
    c1 = fp * st.c + ip * zt
    n1 = fp * st.n + ip
    h1 = ot * c1 / torch.maximum(n1, torch.exp(-m1))
    return SLSTMState(c=c1, n=n1, h=h1, m=m1)


def _slstm_ffn(p, x, y, cfg):
    """The post-block gated FFN: y + ffn(rmsnorm(x + y))."""
    yn = rmsnorm(p["ff_norm"], x + y, cfg.norm_eps)
    f = yn @ p["ff_wi"]
    g = yn @ p["ff_wg"]
    f = F.silu(g.float()).to(f.dtype) * f
    return y + f @ p["ff_wo"]


def slstm_forward(p, x, cfg, state: SLSTMState | None = None):
    """The whole sLSTM block, a recurrent loop over time. x: (B,S,D)."""
    B, S, D = x.shape
    H = cfg.n_heads
    P = D // H
    if state is None:
        state = slstm_init_state(cfg, B, device=x.device)

    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    wx = xn @ p["w_in"]                                  # (B,S,4D) hoisted

    if cfg.accounting:
        # the JAX package's accounting program: the true recurrence
        # replaced by an operation-equivalent parallel one (its cost
        # analysis counts a scan body once); not the model's output
        xh = xn.reshape(B, S, H, P).float()
        rh = torch.einsum("bshp,ghpj->bsghj", xh,
                          p["r"].float()).reshape(B, S, 4 * D)
        pre = wx.float() + rh
        y = torch.tanh(pre[..., :D]).to(x.dtype)
        state = slstm_init_state(cfg, B, device=x.device)
    else:
        r32, hs = p["r"].float(), []
        for t in range(S):
            state = _slstm_cell(r32, p["b"], wx[:, t], state, H, P)
            hs.append(state.h)
        y = torch.stack(hs, 1).to(x.dtype)                # (B,S,D)
    return _slstm_ffn(p, x, y, cfg), state


def slstm_step(p, x, state: SLSTMState, cfg):
    """Single-token decode. x: (B,D); returns a new state."""
    H, P = cfg.n_heads, cfg.d_model // cfg.n_heads
    xn = rmsnorm(p["norm"], x, cfg.norm_eps)
    st = _slstm_cell(p["r"].float(), p["b"], xn @ p["w_in"], state, H, P)
    return _slstm_ffn(p, x, st.h.to(x.dtype), cfg), st
