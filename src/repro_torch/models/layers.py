"""Core layers: norms, rotary embeddings, MLPs, embeddings.

Counterpart of ``repro.models.layers`` (logical axis names kept).  The
``swiglu`` and ``mlp`` ops are registered here per dispatch backend:
'torch' is the plain formulation, 'cuda' goes through the hand-written
kernels (``repro_torch.kernels.ops``).

Tensor parallelism: ``embed``, ``unembed`` and ``mlp`` take a ``mesh``
when their parameters are this rank's blocks over the mesh's 'model'
axis (``dist.sharding.param_pspecs``' 'serve' layout: the vocab, the ffn
dim), and add the collectives the one-device layer does not need; the
caller passes None for whole parameters.
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


class _Lookup(torch.autograd.Function):
    """``table[idx]`` whose backward sums each row's gradients in fp32
    and rounds the sum once to the table's dtype.  A bf16 table's plain
    indexing backward sums a frequent token's rows in bf16: its gradient
    sat 0.148 of its norm off the fp32 one on the card (tinyllama-1.1b,
    4 x 1024 SyntheticLM tokens, a third of them one token)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        d = g.shape[-1]
        acc = torch.zeros((ctx.rows, d), dtype=torch.float32,
                          device=g.device)
        acc.index_add_(0, idx.reshape(-1), g.reshape(-1, d).float())
        return acc.to(g.dtype), None


def embed(p, tokens, mesh=None):
    """The rows of ``tokens``.  With ``mesh`` the table is this rank's
    block of the vocab over 'model' (rows [v0, v0 + V_l)): the ids in
    that range take their rows, the others zeros, and one all-reduce over
    'model' sums the blocks (exact: each sum has one non-zero term)."""
    table = p["table"]
    if mesh is not None:
        n = table.shape[0]
        ids = tokens.long() - mesh.coord("model") * n
        mine = (ids >= 0) & (ids < n)
        rows = table[ids.clamp(0, n - 1)]
        return mesh.all_reduce(torch.where(mine[..., None], rows,
                                           rows.new_zeros(())), "model")
    if torch.is_grad_enabled() and table.requires_grad:
        return _Lookup.apply(table, tokens.long())
    return table[tokens.long()]


def unembed_spec(vocab, d, dtype):
    return {"w": ParamDef((d, vocab), dtype, ("embed", "vocab"))}


def unembed(p, x, mesh=None):
    """``x @ w``; with ``mesh`` ``w`` is this rank's vocab columns over
    'model', and the logits' blocks are gathered over 'model' into the
    whole vocab."""
    out = x @ p["w"]
    return out if mesh is None else mesh.all_gather(out, "model", -1)


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


def row_parallel(out, mesh):
    """A row-parallel product's partial ``out`` summed over ``mesh``'s
    'model' axis, in place, in the model dtype (unchanged without a
    mesh).  Summing fp32 partials with the residual added after the sum
    parted as many greedy streams from one device's at bf16 (PERF.md),
    and would unfuse the residual from kernel 1's epilogue."""
    return out if mesh is None else mesh.all_reduce(out, "model")


def rank_residual(residual, mesh):
    """The residual a row-parallel partial adds: the whole residual at
    'model' coordinate 0 only, so the sum over 'model' adds it once."""
    return None if mesh is not None and mesh.coord("model") else residual


def mlp(p, x, act: str, *, backend="cuda", residual=None, mesh=None):
    """FFN block via the dispatch registry.  With ``residual`` the
    residual add is part of the block (``residual + mlp(x)``); on the
    'cuda' path it is fused into the down-projection's epilogue.
    ``backend`` is a backend string or a ModelConfig.  With ``mesh`` the
    ffn dim is split over 'model': ``wi`` / ``wg`` are this rank's
    columns (column-parallel, kernel 2 on them) and ``wo`` its rows
    (row-parallel, kernel 1), and one all-reduce over 'model' sums the
    partials (``rank_residual``, ``row_parallel``)."""
    out = D.dispatch("mlp", backend, p, x, act,
                     residual=rank_residual(residual, mesh))
    return row_parallel(out, mesh)


# ---------------- frontends (stubs: precomputed embeddings) ----------------

def frontend_proj_spec(raw_dim, d, dtype):
    """Projects precomputed frame / patch embeddings into d_model."""
    return {"w": ParamDef((raw_dim, d), dtype, ("frontend_in", "embed"))}


def frontend_proj(p, emb):
    """emb (..., raw_dim) @ w (raw_dim, d): a plain product, as in the
    JAX package (an einsum outside any kernel), in the promoted dtype of
    the two (fp32 embeddings against bf16 weights multiply in fp32)."""
    w = p["w"]
    dtype = torch.promote_types(emb.dtype, w.dtype)
    return torch.matmul(emb.to(dtype), w.to(dtype))
