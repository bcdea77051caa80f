"""Multi-device distribution layer (counterpart of ``repro.dist``).

The paper's hierarchy (local vector registers / intermediate SRAM /
global memory) maps onto a multi-device stack as on-chip memory /
per-device HBM / the interconnect, and the same discipline applies: keep
traffic in the near tier, and where it must cross the far tier, cross it
in the widest, fewest transactions.

  sharding     one vocabulary (logical axes -> mesh partition specs) for
               params, batches and decode caches, per model family and
               strategy ('fsdp_tp' | 'ddp' | 'serve'), and the blocks a
               rank holds under a spec
  decode       distributed FlashDecoding: a sequence-sharded KV cache,
               per-rank unnormalized softmax partials, one small
               (B, H)-sized combine across ranks instead of moving the
               cache
  compression  int8 all-reduce with error feedback (``compressed_psum``)
  pipeline     the GPipe microbatch schedule over a 'pipe' axis
               (``pipeline_apply``)

Data-parallel training with ZeRO-1 is ``launch.steps.build_train_step(
..., mesh=)`` over ``optim.adamw``'s sharded state.  Tensor- and
expert-parallel serving lives in the layers (``models``), which compute
on the blocks ``sharding.shard_params`` cuts, with ``common.hints`` for
the layout cuts.  Still left (ROADMAP queue 1 item 14): a 'model' axis
in training.
"""
from repro_torch.dist import compression, decode, pipeline, sharding  # noqa: F401
