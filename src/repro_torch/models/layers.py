"""Core layers: norms, rotary embeddings, MLPs, embeddings.

Counterpart of ``repro.models.layers`` (logical axis names kept).  The
``swiglu`` and ``mlp`` ops are registered here per dispatch backend:
'torch' is the plain formulation, 'cuda' goes through the hand-written
kernels (``repro_torch.kernels.ops``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.module import (ParamDef, embed_init, ones_init,
                                       zeros_init)
from repro_torch.kernels import dispatch as D


def dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------- norms ----------------

def rmsnorm_spec(d, dtype):
    return {"scale": ParamDef((d,), dtype, ("embed",), ones_init)}


def rmsnorm(p, x, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def layernorm_spec(d, dtype):
    return {
        "scale": ParamDef((d,), dtype, ("embed",), ones_init),
        "bias": ParamDef((d,), dtype, ("embed",), zeros_init),
    }


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


# ---------------- rotary ----------------

def rope_freqs(d_head: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def rope_tables(positions, d_head: int, theta: float):
    """(cos, sin), each (..., S, 1, Dh/2), for ``rotate``."""
    freqs = rope_freqs(d_head, theta, positions.device)     # (Dh/2,)
    ang = positions[..., None].float() * freqs              # (..., S, Dh/2)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x, cos, sin):
    """Split-halves rotary: the first and second halves of Dh are the
    (real, imaginary) parts, not interleaved pairs."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------- embedding / unembedding ----------------

def embedding_spec(vocab, d, dtype):
    return {"table": ParamDef((vocab, d), dtype, ("vocab", "embed"),
                              embed_init)}


def embed(p, tokens):
    return p["table"][tokens.long()]


def unembed_spec(vocab, d, dtype):
    return {"w": ParamDef((d, vocab), dtype, ("embed", "vocab"))}


def unembed(p, x):
    return x @ p["w"]


# ---------------- MLP ----------------

def mlp_spec(d, d_ff, act, dtype):
    if act == "swiglu":
        return {
            "wi": ParamDef((d, d_ff), dtype, ("embed", "ffn")),
            "wg": ParamDef((d, d_ff), dtype, ("embed", "ffn")),
            "wo": ParamDef((d_ff, d), dtype, ("ffn", "embed")),
        }
    return {
        "wi": ParamDef((d, d_ff), dtype, ("embed", "ffn")),
        "wo": ParamDef((d_ff, d), dtype, ("ffn", "embed")),
    }


@D.register("swiglu", "torch")
def _swiglu_torch(x2, wg, wi):
    h = x2 @ wi
    g = x2 @ wg
    return F.silu(g.float()).to(x2.dtype) * h


@D.register("swiglu", "cuda")
def _swiglu_cuda(x2, wg, wi):
    from repro_torch.kernels import ops
    return ops.vwr_swiglu(x2, wg, wi)


@D.register("mlp", "torch")
def _mlp_torch(p, x, act, residual=None):
    if act == "swiglu":
        lead, d = x.shape[:-1], x.shape[-1]
        h = D.dispatch("swiglu", "torch", x.reshape(-1, d),
                       p["wg"], p["wi"]).reshape(*lead, -1)
    else:
        h = x @ p["wi"]
        fn = ((lambda t: F.gelu(t, approximate="tanh")) if act == "gelu"
              else torch.relu)
        h = fn(h.float()).to(x.dtype)
    out = h @ p["wo"]
    return out if residual is None else residual + out


@D.register("mlp", "cuda")
def _mlp_cuda(p, x, act, residual=None):
    from repro_torch.kernels import ops
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    r2 = None if residual is None else residual.reshape(
        -1, residual.shape[-1])
    if act == "swiglu":
        # one staged x tile feeds both projections; silu(g) * h happens
        # on the fp32 accumulators before the single store
        h = D.dispatch("swiglu", "cuda", x2, p["wg"], p["wi"])
    else:
        h = ops.vwr_matmul(x2, p["wi"],
                           activation="gelu" if act == "gelu" else "relu")
    out = ops.vwr_matmul(h, p["wo"], residual=r2)
    return out.reshape(*lead, out.shape[-1])


def mlp(p, x, act: str, *, backend="cuda", residual=None):
    """FFN block via the dispatch registry.  With ``residual`` the
    residual add is part of the block (``residual + mlp(x)``); on the
    'cuda' path it is fused into the down-projection's epilogue.
    ``backend`` is a backend string or a ModelConfig."""
    return D.dispatch("mlp", backend, p, x, act, residual=residual)
