"""The one sharding surface: logical axes -> mesh partition specs.

Counterpart of ``repro.dist.sharding``, with its vocabulary and rules
unchanged: ``param_pspecs`` resolves the logical axes of ``lm.
model_spec``'s ``ParamDef``s per strategy, ``cache_pspecs`` /
``paged_cache_pspecs`` lay out the decode caches (with ``seq_shard``
the sequence or page dim takes 'model'), and the batch pspecs put dim 0
over the data axes where they divide it.

Strategies:
  'fsdp_tp'  TP over 'model' (vocab / heads / kv / ffn / expert-ffn /
             ssm-inner dims) + the largest remaining param dim
             ('embed') sharded over the data axes (FSDP).  Default.
  'ddp'      params replicated.
  'serve'    TP only: params stay gather-free on the data axes and the
             batch dim carries 'data'.

A dim is only assigned a mesh axis when its size divides the axis
(product) size; each mesh axis appears at most once per spec.

A spec is a ``PS``: a tuple with, per dim, None, an axis name or a tuple
of axis names.  ``local_block(x, spec, mesh)`` cuts this rank's block of
a whole tensor (the counterpart of ``device_put`` onto a
``NamedSharding``) and ``gather_block`` puts the whole tensor back
together from every rank's block; ``shard_params`` cuts a whole
parameter tree into this rank's blocks under ``param_pspecs`` (the
counterpart of ``device_put`` onto ``to_shardings``).  The serving path
lays out its decode caches by these specs, and on a mesh without
sequence sharding its parameters too: ``tp_layout`` reads off that spec
tree, once, which parts of the model a rank holds a block of, and the
tensor-parallel layers of ``models`` compute on those blocks with
explicit collectives where it says so (``engine``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.common.module import ParamDef, map_tree

# mesh axes that carry the batch / FSDP dim, in nesting order
DATA_AXES = ("pod", "data")

# logical axes that tensor-parallelize over 'model'
_TP_AXES = ("vocab", "heads", "kv", "ffn", "expert_ff", "inner",
            "inner_all", "q_lora", "kv_lora")


class PS(tuple):
    """A partition spec: per dim None, an axis name or a tuple of names
    (``jax.sharding.PartitionSpec``'s entries)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PS{tuple.__repr__(self)}"


def data_axes(mesh) -> tuple:
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def data_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh)) or 1


def model_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def _dp_entry(mesh):
    """The spec entry for the data dims: a single axis name or a tuple
    when the mesh also has a 'pod' axis."""
    dp = data_axes(mesh)
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


def rules(cfg, mesh, strategy: Optional[str] = None) -> Dict[str, Any]:
    """logical axis name -> mesh axis (str | tuple | None)."""
    strategy = strategy or cfg.sharding_strategy
    if strategy == "ddp":
        return {}
    mp = model_axis(mesh)
    table: Dict[str, Any] = {ax: mp for ax in _TP_AXES}
    dp = _dp_entry(mesh)
    # experts spread over EVERY axis, or not at all (full expert
    # parallelism: whole experts a device; a strict subset buys no memory
    # over it).  _resolve keeps them replicated when E does not cover the
    # full product.
    flat_dp = dp if isinstance(dp, tuple) else ((dp,) if dp else ())
    full = flat_dp + ((mp,) if mp else ())
    table["experts"] = (full if len(full) > 1
                        else (full[0] if full else None))
    if strategy == "serve":
        return table
    if strategy != "fsdp_tp":
        raise ValueError(f"unknown sharding strategy {strategy!r}")
    table["embed"] = dp
    return table


def _flat(entry) -> tuple:
    return (entry if isinstance(entry, tuple)
            else ((entry,) if entry is not None else ()))


def _resolve(d: ParamDef, table: Dict[str, Any], sizes: Dict[str, int]) -> PS:
    used = set()
    out = []
    for ax, size in zip(d.axes, d.shape):
        mesh_ax = table.get(ax)
        flat = _flat(mesh_ax)
        n = math.prod(sizes[a] for a in flat) if flat else 1
        if not flat or any(a in used for a in flat) or size % n:
            out.append(None)
            continue
        used.update(flat)
        out.append(mesh_ax)
    return PS(*out)


def param_pspecs(cfg, mesh, strategy: Optional[str] = None):
    """Spec tree matching ``lm.model_spec(cfg)``."""
    from repro_torch.models import lm  # local import: dist must not cycle

    table = rules(cfg, mesh, strategy)
    sizes = dict(mesh.shape)
    return map_tree(lambda d: _resolve(d, table, sizes), lm.model_spec(cfg))


# ----------------------------------------------------------------------
# batch pspecs
# ----------------------------------------------------------------------

def _batched(mesh, aval_or_ndim, batch: Optional[int] = None) -> PS:
    """dim 0 over the data axes (when divisible), rest replicated."""
    if hasattr(aval_or_ndim, "shape"):
        ndim = len(aval_or_ndim.shape)
        batch = aval_or_ndim.shape[0] if aval_or_ndim.shape else None
    else:
        ndim = aval_or_ndim
    dp = _dp_entry(mesh)
    if ndim == 0 or dp is None or batch is None \
            or batch % data_size(mesh):
        return PS(*([None] * ndim))
    return PS(dp, *([None] * (ndim - 1)))


def train_batch_pspecs(cfg, mesh, batch_specs):
    """Spec tree for a train / prefill batch dict of arrays (anything
    with a ``shape``): the global batch dim shards over the data axes,
    everything else is replicated."""
    return {k: _batched(mesh, v) for k, v in batch_specs.items()}


def cache_pspecs(cfg, mesh, batch: int, *, seq_shard: bool = False):
    """Spec tree matching ``lm.cache_spec(cfg, batch, T)``, branch for
    branch.

    Default: batch over the data axes, the kv-head dim of attention
    caches over 'model' when divisible.  With ``seq_shard=True`` the
    cache *sequence* dim takes 'model' instead: the layout
    ``dist.decode.sharded_flash_decode`` consumes (each model rank owns a
    contiguous slab of the context and never sees the rest).  Recurrent
    states (hybrid / ssm) shard their head dim over 'model'."""
    from repro_torch.models import lm, ssm as SSM, xlstm as XL

    mp = model_axis(mesh)
    dp = _dp_entry(mesh)
    bax = (dp if dp is not None and batch % data_size(mesh) == 0
           else None)
    sizes = dict(mesh.shape)
    seqax = mp if (seq_shard and mp is not None) else None
    kvax = (mp if (not seq_shard and mp is not None
                   and cfg.n_kv_heads % sizes[mp] == 0) else None)

    def heads_ax(n_heads):
        if mp is None or n_heads % sizes[mp]:
            return None
        return mp

    def kv_cache(lead: int) -> PS:
        # (*lead, B, T, KV, Dh)
        return PS(*([None] * lead), bax, seqax, kvax, None)

    fam = cfg.family
    if fam in ("dense", "vlm"):
        if cfg.mla is not None:
            latent = PS(None, bax, seqax, None)
            return {"ckv": latent, "krope": latent}
        return {"k": kv_cache(1), "v": kv_cache(1)}

    if fam == "moe":
        if cfg.mla is not None:
            latent = PS(None, bax, seqax, None)

            def group():
                return {"ckv": latent, "krope": latent}
        else:
            def group():
                return {"k": kv_cache(1), "v": kv_cache(1)}
        return {"dense": group() if cfg.moe.first_k_dense else None,
                "moe": group()}

    if fam == "hybrid":
        mc = cfg.mamba2
        _, _, tail, _ = lm._hybrid_groups(cfg)
        hax = heads_ax((mc.expand * cfg.d_model) // mc.head_dim)

        def mstate(lead: int):
            # ssm: (*lead, B, H, d_state, head_dim); conv: (*lead, B,
            # d_conv-1, d_xbc)
            return SSM.Mamba2State(
                ssm=PS(*([None] * lead), bax, hax, None, None),
                conv=PS(*([None] * lead), bax, None, None))
        return {
            "mamba_main": mstate(2),
            "mamba_tail": mstate(1) if tail else None,
            "attn_k": kv_cache(1), "attn_v": kv_cache(1),
        }

    if fam == "ssm":
        hax = heads_ax(cfg.n_heads)
        return {
            "mlstm": XL.MLSTMState(
                C=PS(None, None, bax, hax, None, None),
                n=PS(None, None, bax, hax, None),
                m=PS(None, None, bax, hax),
                conv=PS(None, None, bax, None, None)),
            "slstm": XL.SLSTMState(
                c=PS(None, bax, None), n=PS(None, bax, None),
                h=PS(None, bax, None), m=PS(None, bax, None)),
        }

    if fam == "audio":
        return {"self_k": kv_cache(1), "self_v": kv_cache(1),
                "cross_k": kv_cache(1), "cross_v": kv_cache(1)}

    raise ValueError(fam)


def paged_cache_pspecs(cfg, mesh, batch_slots: int, *,
                       seq_shard: bool = False,
                       n_pages: Optional[int] = None,
                       quantized: bool = False):
    """Spec tree matching ``engine.paged_cache.paged_cache_spec``.

    Pool leaves are ``(L, n_pages, page_size, ...)``: with
    ``seq_shard=True`` the *page* dim takes 'model' (each rank owns a
    contiguous slab of the pool; ``dist.decode.
    sharded_paged_flash_decode`` masks foreign pages by count and
    combines the statistics), else the kv-head dim takes 'model' when
    divisible.  The audio cross cache stays slot-dense (batch over data,
    replicated over 'model').  With ``quantized=True`` the tree grows
    the int8 pools' fp32 scale leaves, sharded on the same page (and,
    for GQA, kv-head) dims as their pools."""
    from repro_torch.engine import paged_cache as PC

    PC.check_family(cfg)
    mp = model_axis(mesh)
    dp = _dp_entry(mesh)
    sizes = dict(mesh.shape)
    bax = (dp if dp is not None and batch_slots % data_size(mesh) == 0
           else None)
    pageax = (mp if (seq_shard and mp is not None
                     and (n_pages is None or n_pages % sizes[mp] == 0))
              else None)
    kvax = (mp if (pageax is None and mp is not None
                   and cfg.n_kv_heads % sizes[mp] == 0) else None)

    def gqa_pool():
        sh = PS(None, pageax, None, kvax, None)
        pool = {"k": sh, "v": sh}
        if quantized:
            ssh = PS(None, pageax, kvax)       # (L, n_pages, KV)
            pool["k_scale"] = ssh
            pool["v_scale"] = ssh
        return pool

    def mla_pool():
        latent = PS(None, pageax, None, None)
        pool = {"ckv": latent, "krope": latent}
        if quantized:
            ssh = PS(None, pageax)             # (L, n_pages)
            pool["ckv_scale"] = ssh
            pool["krope_scale"] = ssh
        return pool

    fam = cfg.family
    if fam in ("dense", "vlm"):
        return mla_pool() if cfg.mla is not None else gqa_pool()
    if fam == "moe":
        mk = mla_pool if cfg.mla is not None else gqa_pool
        return {"dense": mk() if cfg.moe.first_k_dense else None,
                "moe": mk()}
    # audio
    pool = gqa_pool()
    cross = PS(None, bax, None, None, None)
    return {"self_k": pool["k"], "self_v": pool["v"],
            "cross_k": cross, "cross_v": cross}


def paged_decode_batch_pspecs(cfg, mesh, global_batch: int, *,
                              seq_shard: bool = False,
                              n_pages: Optional[int] = None,
                              quantized: bool = False):
    """Spec tree for a paged decode batch ({token, cur_len (B,),
    block_table, cache} [+ enc_lens for audio])."""
    out = {
        "token": _batched(mesh, 1, global_batch),
        "cur_len": _batched(mesh, 1, global_batch),
        "block_table": _batched(mesh, 2, global_batch),
        "cache": paged_cache_pspecs(cfg, mesh, global_batch,
                                    seq_shard=seq_shard, n_pages=n_pages,
                                    quantized=quantized),
    }
    if cfg.family == "audio":
        out["enc_lens"] = _batched(mesh, 1, global_batch)
    return out


def decode_batch_pspecs(cfg, mesh, global_batch: int, *,
                        seq_shard: bool = False):
    """Spec tree for a dense decode batch ({token, cur_len, cache})."""
    return {
        "token": _batched(mesh, 1, global_batch),
        "cur_len": PS(),
        "cache": cache_pspecs(cfg, mesh, global_batch,
                              seq_shard=seq_shard),
    }


# ----------------------------------------------------------------------
# blocks: the counterpart of device_put onto a NamedSharding
# ----------------------------------------------------------------------

def _block_index(mesh, axes) -> tuple:
    """(index, count) of this rank's block along a dim split over
    ``axes`` (row-major over them, as a JAX mesh orders devices)."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coord(a)
        n *= mesh.shape[a]
    return idx, n


def block_start(mesh, entry, local: int) -> int:
    """The first global index of this rank's block of ``local`` elements
    along a dim split over spec entry ``entry``'s axes."""
    return _block_index(mesh, _flat(entry))[0] * local


def block_span(mesh, entry, size: int) -> tuple:
    """(start, length) of this rank's block of a dim of ``size`` split
    over spec entry ``entry``'s axes; a size its axes do not divide
    raises (as ``device_put`` onto such a sharding does)."""
    n = _block_index(mesh, _flat(entry))[1]
    if size % n:
        raise ValueError(f"a dim of size {size} does not split over "
                         f"{_flat(entry)} ({n} ranks)")
    return block_start(mesh, entry, size // n), size // n


def local_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``, as a
    contiguous tensor of its own."""
    if spec is None:
        return x
    for dim, entry in enumerate(spec):
        start, n = block_span(mesh, entry, x.shape[dim])
        x = x.narrow(dim, start, n)
    return x.contiguous()


def gather_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` under ``spec``
    (the inverse of ``local_block``), on every rank."""
    if spec is None:
        return x
    for dim, entry in enumerate(spec):
        x = mesh.all_gather(x, _flat(entry), dim)
    return x


def shard_params(params, pspecs, mesh):
    """This rank's blocks of the parameter tree ``params`` (whole on every
    rank) under ``pspecs`` (``param_pspecs``): the counterpart of JAX's
    ``device_put(params, to_shardings(mesh, pspecs))``.  A block that is
    a view into its whole leaf is copied, so the rank keeps only its
    blocks' bytes once the whole tree is dropped."""
    def cut(x, spec):
        blk = local_block(x, spec, mesh)
        if blk.numel() != x.numel() and (blk.untyped_storage().data_ptr()
                                         == x.untyped_storage().data_ptr()):
            blk = blk.clone()
        return blk
    return {k: (shard_params(v, pspecs[k], mesh) if isinstance(v, dict)
                else cut(v, pspecs[k])) for k, v in params.items()}


class TPLayout(NamedTuple):
    """Which parts of the model a rank's parameters hold a block of,
    read off the spec tree they were cut by (``tp_layout``), and the mesh
    they are split over.  Each part but the experts is split over
    'model'; the experts over every axis (``models.moe.EP_AXES``)."""
    mesh: Any
    vocab: bool         # the embedding table and the head's columns
    heads: bool         # the attention's query heads
    kv: bool            # its kv heads (else whole beside split heads)
    ffn: bool           # the dense MLPs' ffn dim
    experts: bool       # the MoE experts
    expert_ff: bool     # the experts' ffn dim (where they stay whole)
    shared: bool        # the shared experts' ffn dim

    def on(self, part: str):
        """The mesh ``part``'s collectives run over, or None where the
        rank holds it whole (the one-device computation)."""
        return self.mesh if getattr(self, part) else None


def tp_layout(pspecs, mesh) -> TPLayout:
    """The ``TPLayout`` of parameters cut by ``pspecs`` (``param_pspecs``'
    tree for the dense and moe families) over ``mesh``: a part is split
    where its dim's spec entry spans more than one rank."""
    def split(group, leaf, dim) -> bool:
        spec = (group or {}).get(leaf)
        if spec is None:
            return False
        return math.prod(mesh.shape[a] for a in _flat(spec[dim])) > 1

    layers = pspecs["layers"]
    dense = pspecs.get("dense_layers") or layers   # the moe family's
    moe = layers.get("moe")
    return TPLayout(
        mesh, vocab=split(pspecs["embed"], "table", 0),
        # stacked leaves: (L, D, H, Dh) projections, (L, D, F) / (L, F, D)
        # MLPs, (L, D, E) router, (L, E, F, D) expert wo
        heads=split(layers["attn"], "wq", 2),
        kv=split(layers["attn"], "wk", 2),
        ffn=split(dense.get("mlp"), "wo", 1),
        experts=split(moe, "router", 2),
        expert_ff=split(moe, "wo", 2),
        shared=split((moe or {}).get("shared"), "wo", 1))
