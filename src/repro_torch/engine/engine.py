"""DecodeEngine: the serving surface on one device.

Counterpart of ``repro.engine.engine`` for the KV-cache families
(dense, moe, vlm and audio), with the dense ``(batch, max_len)`` decode
cache or, with ``EngineConfig(paged=True)``, a paged one
(``engine.paged_cache``: shared page pools in the model dtype or, with
``kv_dtype='int8'``, int8 with per-page scales, addressed through
per-slot block tables), which ``engine.scheduler`` runs continuous
batching on.  One object owns the config, the parameters on the device,
and the prefill/decode step functions::

    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, EngineConfig

    eng = DecodeEngine(get_config("tinyllama-1.1b"),
                       EngineConfig(batch=4, max_len=160))
    tokens, stats = eng.generate({"tokens": prompts}, gen=32)

DeepSeek-V3 (the moe family with MLA) serves the same way, on latent
caches and pools::

    eng = DecodeEngine(get_config("deepseek-v3-671b"),
                       EngineConfig(batch=8, max_len=288, paged=True,
                                    page_size=16, n_pages=128,
                                    kv_dtype="int8"))

A paged engine (dense or moe family, GQA or MLA) also carries
``suffix_prefill_fn`` (the suffix-only prefill of a prefix-cache hit)
and ``mixed_fn`` (one chunked-prefill chunk plus the decode batch in one
step), which the Scheduler's ``prefix_cache`` and ``chunked_prefill``
modes use.

The frontend families take their precomputed embeddings in the batch:
internvl2's 256 patch embeddings open each prompt, seamless-m4t's frames
are the encoder's input, and the cross cache is sized by them::

    eng = DecodeEngine(get_config("seamless-m4t-large-v2"),
                       EngineConfig(batch=4, max_len=48))
    tokens, stats = eng.generate({"tokens": prompts,
                                  "frontend_emb": frames}, gen=32)

The engine runs on ``device="cuda"`` by default and raises if there is
no GPU; pass ``device="cpu"`` to run the plain versions on the CPU.

Distributed serving (the dense and moe families, GQA or MLA): one
engine a rank of a ``(data, model)`` mesh of ``torch.distributed``
ranks (``launch.mesh``), every rank constructing it alike::

    def serve(mesh):
        eng = DecodeEngine(cfg, EngineConfig(batch=4, max_len=160,
                                             mesh_shape=(2, 2),
                                             decode_shard="seq"),
                           mesh=mesh)
        return eng.generate({"tokens": prompts}, gen=32)[0].cpu()

    tokens = run_ranks(serve, 2, 2, device="cuda")

Each rank holds its block of the decode cache (``dist.sharding.
cache_pspecs`` / ``paged_cache_pspecs``): its ``B / data`` rows of a
dense cache (all of them when ``data`` does not divide B), and

* with ``decode_shard='seq'``, its slab of the sequence (dense) or of
  the page pool (paged) over 'model', beside the whole parameters (built
  from the same seed on every rank).  Each decode step launches the
  decode kernels on the rank's own slab and stitches the shards together
  with one statistics combine (``dist.decode``);
* without it (tensor-parallel serving, the dense and moe families with
  GQA attention, ``param_strategy='serve'``), its kv heads over 'model'
  (all of them where 'model' does not divide them) and its blocks of the
  parameters under ``param_pspecs(cfg, mesh, 'serve')``
  (``dist.sharding.shard_params``): the vocab, heads and ffn dims over
  'model', the experts over every axis.  The layers compute on those
  blocks with explicit collectives where the layout read off the same
  spec tree says so (``dist.sharding.tp_layout``, ``models.lm``), so a
  rank holds about 1 / model of the weights.

Either way everything after a layer's collectives is replicated over
'model', and the host state (tokens, a Scheduler's tables) stays equal
across ranks by construction.  ``generate`` returns the whole (B, G)
tokens on every rank.  The frontend and recurrent families, MLA or a
``param_strategy`` other than 'serve' under a tensor-parallel 'model'
axis, a paged engine with a data axis, the prefix cache and chunked
prefill under a mesh, and durable serving under a mesh raise
``NotImplementedError`` (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.module import map_tree, resolve_device
from repro_torch.dist import sharding as SH
from repro_torch.engine import paged_cache
from repro_torch.engine.cache import pad_cache_from_prefill
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm

ITEM_14 = "ROADMAP.md queue 1 item 14"


class NonFiniteLogitsError(RuntimeError):
    """A decode step produced NaN/inf logits (``generate(check_finite=True)``)."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-shape knobs (everything model-side lives in ModelConfig);
    the fields of ``repro.engine.EngineConfig``.

    ``decode_shard`` / ``kernel_impl`` default to None = inherit the
    ModelConfig's setting.  ``paged=True`` replaces the dense cache with
    a pool of ``n_pages`` pages of ``page_size`` positions (None = a
    dense-equivalent ``batch * ceil(max_len / page_size)``); ``batch``
    then counts slots.  ``kv_dtype='int8'`` (paged only) stores the
    pools as int8 with fp32 per-(page, KV head) scales.
    ``prefix_cache`` / ``chunked_prefill`` / ``chunk_tokens`` are the
    Scheduler's defaults for those modes (paged token-only families;
    ``chunk_tokens`` a positive multiple of ``page_size``)."""
    batch: int = 1
    max_len: int = 128              # prompt + generation budget
    mesh_shape: Tuple[int, int] = (1, 1)      # (data, model)
    decode_shard: Optional[str] = None   # 'none' | 'seq'
    kernel_impl: Optional[str] = None    # 'torch' | 'cuda' | 'auto'
    param_strategy: str = "serve"
    paged: bool = False
    page_size: int = 16
    n_pages: Optional[int] = None
    kv_dtype: str = "bf16"          # 'bf16' (model dtype) | 'int8'
    prefix_cache: bool = False
    chunked_prefill: bool = False
    chunk_tokens: int = 32

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


def _unported(cfg, ecfg: EngineConfig, mesh_shape) -> Optional[str]:
    """The first distributed option the port does not serve yet, or
    None."""
    if ecfg.decode_shard != "seq" and tuple(mesh_shape) == (1, 1):
        return None
    if cfg.family not in ("dense", "moe"):
        return (f"the {cfg.family} family under a mesh or "
                "decode_shard='seq'")
    if ecfg.paged and mesh_shape[0] > 1:
        return "paged=True with a data axis of more than one rank"
    tp = ecfg.decode_shard != "seq" and mesh_shape[1] > 1
    if tp and ecfg.param_strategy != "serve":
        return (f"param_strategy={ecfg.param_strategy!r} on a "
                "tensor-parallel 'model' axis (tensor-parallel serving "
                "lays the weights out by 'serve')")
    if tp and cfg.mla is not None:
        return "MLA attention on a tensor-parallel 'model' axis"
    if ecfg.prefix_cache or ecfg.chunked_prefill:
        return "the prefix cache or chunked prefill under a mesh"
    return None


def refuse_distributed(engine, what: str) -> None:
    """Raise for ``what`` (an option the port serves on one rank only)
    on a distributed engine."""
    if getattr(engine, "distributed", False):
        raise NotImplementedError(
            f"{what} under a mesh ({engine.mesh!r}, decode_shard="
            f"{engine.ecfg.decode_shard!r}) is not ported to repro_torch "
            f"yet: {ITEM_14}")


def _check_prefix_and_chunks(cfg, ecfg: EngineConfig) -> None:
    """The JAX engine's checks of the prefix-cache and chunked-prefill
    options (``ValueError``)."""
    for on, what, why in (
            (ecfg.prefix_cache, "prefix_cache=True",
             "prefix sharing aliases physical pages through block tables"),
            (ecfg.chunked_prefill, "chunked_prefill=True",
             "chunks land in granted pages through the block table")):
        if not on:
            continue
        if not ecfg.paged:
            raise ValueError(f"{what} needs paged=True: {why}")
        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"{what} supports the token-only families ('dense', "
                f"'moe'); family {cfg.family!r} prepends frontend "
                "positions a token-keyed prefix cannot match")
    if ecfg.chunked_prefill and (ecfg.chunk_tokens < 1
                                 or ecfg.chunk_tokens % ecfg.page_size):
        raise ValueError(
            f"chunk_tokens={ecfg.chunk_tokens} must be a positive "
            f"multiple of page_size={ecfg.page_size}: every non-final "
            "chunk must end page-aligned so the next chunk's resident "
            "prefix is whole pages")


class DecodeEngine:
    """Owns config + parameters on one device + the step functions.

    ``params`` may be a ready parameter tree (moved to ``device``) or
    None to initialize random parameters from ``seed``; a whole tree
    either way, which a tensor-parallel engine cuts into its blocks
    (``params``).  ``mesh`` (a ``launch.mesh.Mesh`` of
    this rank) defaults to ``make_local_mesh(*ecfg.mesh_shape)``; a
    mesh's device is the engine's."""

    def __init__(self, cfg, ecfg: EngineConfig, params=None,
                 device="cuda", seed: int = 0, mesh=None):
        ecfg = ecfg.replace(
            kernel_impl=(ecfg.kernel_impl if ecfg.kernel_impl is not None
                         else cfg.kernel_impl),
            decode_shard=(ecfg.decode_shard
                          if ecfg.decode_shard is not None
                          else cfg.decode_shard))
        if ecfg.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"EngineConfig.kv_dtype must be 'bf16' or "
                             f"'int8', got {ecfg.kv_dtype!r}")
        if ecfg.kv_dtype == "int8" and not ecfg.paged:
            raise ValueError(
                "kv_dtype='int8' requires paged=True: the dense decode "
                "cache appends in place every step and a growing "
                "per-sequence scale would re-quantize the whole slab "
                "per token — per-page scales make the rewrite O(page)")
        _check_prefix_and_chunks(cfg, ecfg)
        shape = ((mesh.axis_size("data"), mesh.axis_size("model"))
                 if mesh is not None else tuple(ecfg.mesh_shape))
        unported = _unported(cfg, ecfg, shape)
        if unported is not None:
            raise NotImplementedError(
                f"{unported} is not ported to repro_torch yet: {ITEM_14}")
        cfg = cfg.replace(kernel_impl=ecfg.kernel_impl,
                          decode_shard=ecfg.decode_shard)
        self.cfg = cfg
        self.ecfg = ecfg
        if ecfg.paged:
            paged_cache.check_family(cfg)
            if ecfg.kv_dtype == "int8" and cfg.family == "audio":
                raise ValueError(
                    "kv_dtype='int8' is unsupported for the audio "
                    "family (slot-dense cross cache stays model-dtype)")
            self.page_size = ecfg.page_size
            self.max_pages = paged_cache.max_pages(ecfg.max_len,
                                                   ecfg.page_size)
            self.n_pages = (ecfg.n_pages if ecfg.n_pages is not None
                            else ecfg.batch * self.max_pages)
        seq, data, model = ecfg.decode_shard == "seq", *shape
        if seq:
            # the JAX engine's checks
            if ecfg.paged and self.n_pages % model:
                raise ValueError(
                    f"decode_shard='seq' needs n_pages={self.n_pages} "
                    f"divisible by the model axis ({model})")
            if not ecfg.paged and ecfg.max_len % model:
                raise ValueError(
                    f"decode_shard='seq' needs max_len={ecfg.max_len} "
                    f"divisible by the model axis ({model})")
        self.mesh = (mesh if mesh is not None
                     else make_local_mesh(data, model, device=device))
        self.distributed = seq or self.mesh.size > 1
        self.device = (self.mesh.device if self.mesh.device is not None
                       else resolve_device(device))
        self.rows, self.seq_slab, self.page_slab = self._blocks(cfg, seq)
        self.step_mesh = (self.mesh if self.rows != slice(0, ecfg.batch)
                          else self.mesh.fold("data"))
        if params is None:
            params = lm.init(cfg, seed=seed, device=self.device)
        self.params = map_tree(lambda t: t.to(self.device), params)
        # tensor-parallel serving: the rank's blocks of the parameters
        # under the 'serve' specs, the layout the layers read off them,
        # and a cache of its kv heads (the cache constructors read the
        # count from the config they are given); another strategy, which
        # only a data-only mesh lets through, keeps them whole
        self.cache_cfg, self.layout = cfg, None
        if self.distributed and not seq and ecfg.param_strategy == "serve":
            specs = SH.param_pspecs(cfg, self.mesh, "serve")
            self.params = SH.shard_params(self.params, specs, self.mesh)
            self.layout = SH.tp_layout(specs, self.mesh)
            if cfg.mla is None:     # MLA's latent caches have no heads
                self.cache_cfg = cfg.replace(n_kv_heads=self._kv_heads(cfg))
        self.prefill_fn = steps.build_prefill(cfg, self.step_mesh,
                                              self.layout)
        self.decode_fn = steps.build_decode(cfg, self.step_mesh,
                                            self.layout)
        # built for every paged token-only engine, so a Scheduler can
        # turn either mode on per stream whatever the EngineConfig
        # defaults
        suffix = ecfg.paged and cfg.family in ("dense", "moe")
        self.suffix_prefill_fn = (steps.build_suffix_prefill(cfg)
                                  if suffix else None)
        self.mixed_fn = steps.build_mixed_step(cfg) if suffix else None
        self._enc_len = 0       # audio: encoder positions at prefill

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _kv_heads(self, cfg) -> int:
        """This rank's kv heads under the cache's spec (the kv-head dim of
        ``paged_cache_pspecs`` / ``cache_pspecs``: 'model' where it
        divides them)."""
        if self.ecfg.paged:
            specs = SH.paged_cache_pspecs(cfg, self.mesh, self.ecfg.batch,
                                          n_pages=self.n_pages)
        else:
            specs = SH.cache_pspecs(cfg, self.mesh, self.ecfg.batch)
        kv = (specs["moe"] if cfg.family == "moe" else specs)["k"]
        return SH.block_span(self.mesh, kv[3], cfg.n_kv_heads)[1]

    @torch.no_grad()
    def _blocks(self, cfg, seq: bool):
        """This rank's block of the decode batch and cache under the JAX
        engine's specs (``dist.sharding.decode_batch_pspecs`` /
        ``paged_decode_batch_pspecs``): its rows of the batch as a slice
        (all of them where 'data' does not divide B), and with
        ``decode_shard='seq'`` its (start, length) slab of the dense
        cache's sequence or of the pool's pages, else None."""
        B = self.ecfg.batch
        if not self.distributed:
            return slice(0, B), None, None
        if self.ecfg.paged:
            specs = SH.paged_decode_batch_pspecs(
                cfg, self.mesh, B, seq_shard=seq, n_pages=self.n_pages,
                quantized=self.ecfg.kv_dtype == "int8")
        else:
            specs = SH.decode_batch_pspecs(cfg, self.mesh, B,
                                           seq_shard=seq)
        r0, n = SH.block_span(self.mesh, specs["token"][0], B)
        group = (specs["cache"]["moe"] if cfg.family == "moe"
                 else specs["cache"])
        kv = next(iter(group.values()))
        if not seq:
            return slice(r0, r0 + n), None, None
        if self.ecfg.paged:      # (L, n_pages, page_size, ...)
            return slice(r0, r0 + n), None, SH.block_span(
                self.mesh, kv[1], self.n_pages)
        # (L, B, T, ...)
        return slice(r0, r0 + n), SH.block_span(
            self.mesh, kv[2], self.ecfg.max_len), None

    def prefill(self, batch: Dict[str, Any]):
        """Prefill ``batch['tokens']`` (B, P) [+ ``frontend_emb`` (B, S_f,
        frontend_dim)] and build the fixed-size decode cache; an audio
        engine sizes the cross cache by the encoder's S_f, which need not
        equal the decoder prompt's P.  Returns (last-token logits (B,
        vocab_padded) fp32, cache): on a mesh, this rank's rows
        (``self.rows``) and its block of the cache."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, P = tokens.shape
        if B != self.ecfg.batch:
            raise ValueError(f"batch {B} != engine batch {self.ecfg.batch}")
        tokens = tokens[self.rows]
        B = tokens.shape[0]
        pbatch = {"tokens": tokens}
        if batch.get("frontend_emb") is not None:
            pbatch["frontend_emb"] = torch.as_tensor(batch["frontend_emb"],
                                                     device=self.device)
        enc_len = (pbatch["frontend_emb"].shape[1]
                   if self.cfg.is_encdec and "frontend_emb" in pbatch
                   else P)
        self._enc_len = enc_len
        logits, caches = self.prefill_fn(self.params, pbatch)
        if self.ecfg.paged:
            cache = self.init_paged_cache(enc_len=enc_len)
            paged_cache.write_prefill(self.cfg, cache, caches,
                                      self.default_block_table(),
                                      slab=self.page_slab)
        else:
            cache = pad_cache_from_prefill(self.cache_cfg, caches, B,
                                           self.ecfg.max_len,
                                           enc_len=enc_len,
                                           span=self.seq_slab)
        return logits, cache

    def init_paged_cache(self, enc_len: Optional[int] = None):
        """Zeroed page pools on the device: the starting cache of
        continuous batching (``engine.scheduler`` fills it per admitted
        request); on a seq-sharded engine this rank's slab of
        ``n_pages / model`` pages (``page_slab``).  ``enc_len`` budgets
        the audio cross cache (default: the engine's max_len), padded up
        to whole pages."""
        if not self.ecfg.paged:
            raise ValueError("init_paged_cache() needs paged=True")
        return paged_cache.init_paged_cache(
            self.cache_cfg, self.n_pages if self.page_slab is None
            else self.page_slab[1], self.page_size, self.ecfg.batch,
            enc_len=(enc_len if enc_len is not None
                     else self.ecfg.max_len),
            kv_dtype=self.ecfg.kv_dtype, device=self.device)

    def default_block_table(self) -> np.ndarray:
        """Whole-batch identity block table (host int32): slot b owns
        pages [b * max_pages, (b+1) * max_pages), the dense-equivalent
        layout ``generate`` uses.  The scheduler builds its own tables
        from the page allocator."""
        if not self.ecfg.paged:
            raise ValueError("default_block_table() needs paged=True")
        B, J = self.ecfg.batch, self.max_pages
        if self.n_pages < B * J:
            raise ValueError(
                f"whole-batch paged prefill needs n_pages >= "
                f"batch*max_pages = {B * J}, got {self.n_pages}; "
                "drive an oversubscribed pool through "
                "engine.scheduler.Scheduler instead")
        return np.arange(B * J, dtype=np.int32).reshape(B, J)

    @torch.no_grad()
    def decode_step(self, token, cur_len, cache, block_table=None):
        """One token for the whole batch: token (B,) int (this rank's
        rows, ``self.rows``, on a mesh).  Returns (logits (B,
        vocab_padded) fp32, cache) — the cache is updated in place.

        Dense cache: every slot at position ``cur_len`` (a host int).
        Paged: ``cur_len`` is an int or a per-slot (B,) host array and
        ``block_table`` a (B, W) host int32 table, W <= max_pages
        covering every slot's live pages (the scheduler passes the
        power-of-two bucket of the longest active slot).  An audio
        engine's slots all hold the last prefill's encoder positions."""
        if self.ecfg.paged:
            if block_table is None:
                raise ValueError(
                    "paged decode_step needs the block_table operand "
                    "(engine.default_block_table() for whole-batch "
                    "generation)")
            lens = np.broadcast_to(np.asarray(cur_len, np.int32),
                                   (self.ecfg.batch,))
            dbatch = {"token": token, "cur_len": lens,
                      "block_table": block_table, "cache": cache}
            if self.cfg.family == "audio":
                dbatch["enc_lens"] = np.full((self.ecfg.batch,),
                                             self._enc_len, np.int32)
            return self.decode_fn(self.params, dbatch)
        return self.decode_fn(self.params, {
            "token": torch.as_tensor(token, device=self.device),
            "cur_len": int(cur_len), "cache": cache})

    def prefill_positions(self, n_tokens: int) -> int:
        """Positions a prefill of ``n_tokens`` tokens occupies (vlm
        prepends its frontend tokens)."""
        if self.cfg.family == "vlm":
            return n_tokens + self.cfg.frontend_tokens
        return n_tokens

    def prefill_len(self, batch) -> int:
        """Positions the prefill of ``batch`` occupies."""
        return self.prefill_positions(batch["tokens"].shape[1])

    # ------------------------------------------------------------------
    # generation loop
    # ------------------------------------------------------------------

    def generate(self, batch: Dict[str, Any], gen: int,
                 temperature: float = 0.0, seed: int = 0,
                 check_finite: bool = False,
                 ) -> Tuple[torch.Tensor, Dict[str, float]]:
        """Prefill + ``gen`` greedy (or sampled) decode steps; ``batch``
        as ``prefill`` takes it.

        Sampling draws from a ``torch.Generator`` seeded with ``seed``:
        deterministic per seed, but not the JAX engine's stream (only
        greedy streams match it); a mesh draws for the whole batch, so
        its tokens are one rank's.  Returns (tokens (B, gen) int32,
        stats with prefill/decode wall times and tok/s)."""
        prefill_tokens = self.prefill_len(batch)
        if prefill_tokens + gen - 1 > self.ecfg.max_len:
            raise ValueError(
                f"prompt {prefill_tokens} + gen {gen} exceeds "
                f"max_len {self.ecfg.max_len}")
        B = batch["tokens"].shape[0]

        self._sync()
        t0 = time.perf_counter()
        logits, cache = self.prefill(batch)
        self._sync()
        t_prefill = time.perf_counter() - t0

        rng = None
        if temperature > 0:
            rng = torch.Generator(device=self.device).manual_seed(seed)

        def pick(logits):
            if rng is not None:
                # the whole batch's draw on every data rank, then this
                # rank's rows: each row gets the draw one rank gives it
                full = self.step_mesh.all_gather(logits, "data")
                probs = torch.softmax(full / temperature, dim=-1)
                return torch.multinomial(probs, 1, generator=rng)[
                    self.rows, 0].to(torch.int32)
            return logits.argmax(-1).to(torch.int32)

        # first token is always the argmax of the prefill logits
        tok = logits.argmax(-1).to(torch.int32)
        table = self.default_block_table() if self.ecfg.paged else None
        out = [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = self.decode_step(tok, prefill_tokens + i, cache,
                                             block_table=table)
            if check_finite and not bool(torch.isfinite(logits).all()):
                raise NonFiniteLogitsError(
                    f"non-finite logits at decode step {i}")
            tok = pick(logits)
            out.append(tok)
        tokens = self.step_mesh.all_gather(torch.stack(out, 1), "data")
        self._sync()
        t_decode = time.perf_counter() - t0
        stats = {
            "t_prefill_s": t_prefill,
            "t_decode_s": t_decode,
            "prefill_tok_s": B * prefill_tokens / max(t_prefill, 1e-9),
            "decode_tok_s": B * max(gen - 1, 0) / max(t_decode, 1e-9),
        }
        return tokens, stats
