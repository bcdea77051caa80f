"""DecodeEngine: the serving surface on one device.

Counterpart of ``repro.engine.engine`` for the dense family, with the
dense ``(batch, max_len)`` decode cache or, with ``EngineConfig(paged=
True)``, a paged one (``engine.paged_cache``: shared page pools in the
model dtype or, with ``kv_dtype='int8'``, int8 with per-page scales,
addressed through per-slot block tables), which ``engine.scheduler``
runs continuous batching on.  One object owns the config, the
parameters on the device, and the prefill/decode step functions::

    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, EngineConfig

    eng = DecodeEngine(get_config("tinyllama-1.1b"),
                       EngineConfig(batch=4, max_len=160))
    tokens, stats = eng.generate({"tokens": prompts}, gen=32)

The engine runs on ``device="cuda"`` by default and raises if there is
no GPU; pass ``device="cpu"`` to run the plain versions on the CPU.
The prefix cache, chunked prefill, sequence sharding, meshes other than
(1, 1) and the paged MoE/MLA/audio pools are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.module import map_tree, resolve_device
from repro_torch.engine import paged_cache
from repro_torch.engine.cache import pad_cache_from_prefill
from repro_torch.launch import steps
from repro_torch.models import lm


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
    pools as int8 with fp32 per-(page, KV head) scales."""
    batch: int = 1
    max_len: int = 128              # prompt + generation budget
    mesh_shape: Tuple[int, int] = (1, 1)      # (data, model)
    decode_shard: Optional[str] = None   # 'none' | 'seq'
    kernel_impl: Optional[str] = None    # 'torch' | 'cuda'
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


def _unported(ecfg: EngineConfig) -> Optional[str]:
    """The first option the port does not serve yet, with its ROADMAP
    place (queue 1), or None."""
    if ecfg.prefix_cache:
        return "prefix_cache=True (item 7)"
    if ecfg.chunked_prefill:
        return "chunked_prefill=True (item 7)"
    if ecfg.decode_shard == "seq":
        return "decode_shard='seq' (distributed decode: item 14)"
    if tuple(ecfg.mesh_shape) != (1, 1):
        return f"mesh_shape={ecfg.mesh_shape} (distributed: item 14)"
    return None


class DecodeEngine:
    """Owns config + parameters on one device + the step functions.

    ``params`` may be a ready parameter tree (moved to ``device``) or
    None to initialize random parameters from ``seed``."""

    def __init__(self, cfg, ecfg: EngineConfig, params=None,
                 device="cuda", seed: int = 0):
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
        unported = _unported(ecfg)
        if unported is not None:
            raise NotImplementedError(
                f"{unported} is not ported to repro_torch yet; see "
                "ROADMAP.md queue 1")
        cfg = cfg.replace(kernel_impl=ecfg.kernel_impl,
                          decode_shard=ecfg.decode_shard)
        self.cfg = cfg
        self.ecfg = ecfg
        if ecfg.paged:
            paged_cache.check_family(cfg)
            self.page_size = ecfg.page_size
            self.max_pages = paged_cache.max_pages(ecfg.max_len,
                                                   ecfg.page_size)
            self.n_pages = (ecfg.n_pages if ecfg.n_pages is not None
                            else ecfg.batch * self.max_pages)
        self.device = resolve_device(device)
        if params is None:
            params = lm.init(cfg, seed=seed, device=self.device)
        self.params = map_tree(lambda t: t.to(self.device), params)
        self.prefill_fn = steps.build_prefill(cfg)
        self.decode_fn = steps.build_decode(cfg)

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, Any]):
        """Prefill ``batch['tokens']`` (B, P) and build the fixed-size
        decode cache.  Returns (last-token logits (B, vocab_padded)
        fp32, cache)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B = tokens.shape[0]
        if B != self.ecfg.batch:
            raise ValueError(f"batch {B} != engine batch {self.ecfg.batch}")
        logits, caches = self.prefill_fn(self.params, {"tokens": tokens})
        if self.ecfg.paged:
            cache = self.init_paged_cache()
            paged_cache.write_prefill(self.cfg, cache, caches,
                                      self.default_block_table())
        else:
            cache = pad_cache_from_prefill(self.cfg, caches, B,
                                           self.ecfg.max_len)
        return logits, cache

    def init_paged_cache(self):
        """Zeroed page pools on the device: the starting cache of
        continuous batching (``engine.scheduler`` fills it per admitted
        request)."""
        if not self.ecfg.paged:
            raise ValueError("init_paged_cache() needs paged=True")
        return paged_cache.init_paged_cache(
            self.cfg, self.n_pages, self.page_size,
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
        """One token for the whole batch: token (B,) int.  Returns
        (logits (B, vocab_padded) fp32, cache) — the cache is updated in
        place.

        Dense cache: every slot at position ``cur_len`` (a host int).
        Paged: ``cur_len`` is an int or a per-slot (B,) host array and
        ``block_table`` a (B, W) host int32 table, W <= max_pages
        covering every slot's live pages (the scheduler passes the
        power-of-two bucket of the longest active slot)."""
        if self.ecfg.paged:
            if block_table is None:
                raise ValueError(
                    "paged decode_step needs the block_table operand "
                    "(engine.default_block_table() for whole-batch "
                    "generation)")
            lens = np.broadcast_to(np.asarray(cur_len, np.int32),
                                   (self.ecfg.batch,))
            return self.decode_fn(self.params, {
                "token": token, "cur_len": lens,
                "block_table": block_table, "cache": cache})
        return self.decode_fn(self.params, {
            "token": torch.as_tensor(token, device=self.device),
            "cur_len": int(cur_len), "cache": cache})

    def prefill_len(self, batch) -> int:
        return batch["tokens"].shape[1]

    # ------------------------------------------------------------------
    # generation loop
    # ------------------------------------------------------------------

    def generate(self, batch: Dict[str, Any], gen: int,
                 temperature: float = 0.0, seed: int = 0,
                 check_finite: bool = False,
                 ) -> Tuple[torch.Tensor, Dict[str, float]]:
        """Prefill + ``gen`` greedy (or sampled) decode steps.

        Sampling draws from a ``torch.Generator`` seeded with ``seed``:
        deterministic per seed, but not the JAX engine's stream (only
        greedy streams match it).  Returns (tokens (B, gen) int32,
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
                probs = torch.softmax(logits / temperature, dim=-1)
                return torch.multinomial(probs, 1, generator=rng)[:, 0].to(
                    torch.int32)
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
        self._sync()
        t_decode = time.perf_counter() - t0
        stats = {
            "t_prefill_s": t_prefill,
            "t_decode_s": t_decode,
            "prefill_tok_s": B * prefill_tokens / max(t_prefill, 1e-9),
            "decode_tok_s": B * max(gen - 1, 0) / max(t_decode, 1e-9),
        }
        return torch.stack(out, 1), stats
