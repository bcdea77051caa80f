#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, the exit is non-zero):

1. print the card (``nvidia-smi`` name and power limit) and build every
   kernel from ``src/repro_torch/csrc`` (into ``build/repro_torch``);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (plus ragged edges, bias, G = 1, bf16 and fp32;
   for the paged kernels permuted block tables, slots of length 0, 1,
   16, 17 and 255, int8 pools with random scales; kernel 9 at kernel
   4's shapes over int8 caches with (B*KV,) scales; the attention,
   decode and chunk kernels at the reduced configs' head dim 16, zero-
   padded by their wrappers, and decode groups of 32 and 40 query rows,
   launched in slices of 16; every MLA kernel at the reduced r 16 /
   rope 8) and time kernel, plain version and one PyTorch library call;
   ``vwr_matmul``'s bf16 variants (split-K, wgmma tiles) at M 1, 4, 8,
   16, the crossover +- 1 and 72, with bias, residual and every
   activation, K off the split's slice, K or N off 8 (the rule must send
   those to ``gemm_kernel``), each case served by the variant the rule
   names and each new variant bitwise equal over two launches; the
   crossover timed at M 1-72 and the tensor maps' host encoding cost;
   DeepSeek-V3's decode down projections timed; ``vwr_swiglu`` the same
   way (its wgmma variant reads wg and wi side by side, each case served
   by the variant the rule names, bitwise over two launches; a batch-1
   decode, the Scheduler's M 8, a mixed step's M 72 and DeepSeek-V3's
   shared expert and dense layers timed, beside the 4-call library and
   one cuBLAS product ``x @ [wg | wi]``; the wgmma tiles against the
   WMMA kernel at M 1-72 and its plans tabled; the host's enqueue time
   of a call on each kernel beside one ``torch.matmul``, and the tensor
   maps' share of it);
   ``vwr_attention`` timed
   at B1 S256 and S2048 (tinyllama widths) and S512 D128 (olmoe widths),
   and held at G 16, S 1 and S off the tile, bf16 bitwise over two
   launches; kernel 12 (the MLA chunk prefix) on bf16 pools by its
   wgmma variant (pages of 16 and 64, C 1, 3 and 64, partial and count-0
   pages), on fp32 pools by the FMA kernel, and kernel 15 on int8 pools
   by its wgmma variant at the same cases, each case served by the
   variant ``chunk_variant`` names and each wgmma output bitwise equal
   over two launches; kernel 5 on bf16 pools by its mma variant (each
   case's variant asserted, bitwise over two launches, held against the
   plain version and its emulation; partial and count-0 pages mid-table,
   a slot whose pages are all masked, entries past the pool, pages of 4
   and 8, J 18, forced plans, a J 128 table of up to 2048 keys a slot
   timed) and its plan table; kernels 10 and 11 on bf16 caches and pools
   by their wgmma variant (64 heads a block as M; key splits merged in
   the launch, column blocks; each case's variant asserted, bitwise over
   two launches, held against the plain version and its emulation:
   forced splits and column blocks, pos0 > 0, no valid key, H 20 and
   192, r 256 / 128, pages of 8, 24, 32 and 64, entries past the pool),
   B1 T2048 and a J 128 table timed beside the parent's FMA kernel, their
   plan tables and the host's enqueue of both wrappers; kernels 9 and 8
   on int8 caches and pools by kernel 4's split and kernel 6's wgmma
   variants (every int8 case on the variant its rule names, bitwise over
   two launches, held against the plain version and the emulation;
   kernels 4 and 6's split and tile edges over int8, B4 / B1 T2048 and
   124 pages timed, plan tables beside the FMA kernel forced through
   ``kind`` and dequantize-then-SDPA); kernels 7 and 13 on int8 pages by
   kernel 5's mma and kernel 11's wgmma variants (kernels 5 and 11's
   edges over int8, each case on its rule's variant, bitwise over two
   launches, held against the plain version and the emulation; a case
   whose splits' page scales lie 2^12 apart; the J 128 tables timed
   beside the FMA kernel forced and the library call; both plan tables);
   kernel 14 on the dense int8 slab by kernel 10's wgmma variant (its
   dense cases on the variant, bitwise over two launches, held against
   the plain version and the emulation; B1 T2048 timed and the headline
   beside the FMA kernel forced and the library call; a batch whose
   sequences' scales lie 2^12 apart; its plan tables at both shapes);
   the frontend families' shapes (``check_frontend_shapes``): kernel
   1's relu up projection and down + residual at seamless-m4t's widths,
   kernel 3 at internvl2's (B1 S384 H16 KV8 D128, and S 293), kernel 4
   over internvl2's dense cache (B4 T416 KV8 G2 D128) and seamless's
   cross cache (B4 T512 KV16 G1 D64, ragged T 500 and 961), kernel 5
   over the identity-paged cross pool (8 slots, 64 entries of 16,
   ragged encoder lengths, an inactive slot) and internvl2's pools,
   kernel 7 at internvl2's pool shape, each on its rule's variant,
   against the plain version and the emulation, bitwise twice, timed
   beside the bound and the library call;
   then kernels 1 (split-K), 4 (8 splits), 5 (8 splits), 11, 9 (8
   splits), 8 (16 splits), 7 and 13 (J 128) and 14 (B1 T2048, 16
   splits) launched in turns on two streams with no synchronisation,
   each stream's outputs bitwise equal to one stream's (the split
   buffers belong to one stream);
3. serve tinyllama-1.1b at full width (22 layers, d 2048, vocab 32000,
   bf16, random weights from a seed) through ``DecodeEngine.generate``
   on the kernels (after one warm-up generate), with every launch counter
   set to 0 just before the timed generate and read just after (the
   prefill's products must run on the wgmma variant, each decode step's
   down projection on the split-K one, swiglu on wgmma at both; the
   Scheduler and DeepSeek-V3 phases hold swiglu's variants too); then
   replay the same token stream teacher-forced
   through the plain 'torch' backend and hold each step's logits to it
   (the random weights are rescaled to a well-conditioned model first),
   and run kernel 9 through ``dist.decode.local_decode_attend`` with
   scales over the replay's dense cache quantized one scale a (batch,
   KV head) row, against dequantize-then-attend (its launches counted,
   every one on its split variant);
   the same for reduced fp32 configs, at a tight tolerance;
4. the same for qwen1.5-0.5b at full width (QKV bias, MHA, tied vocab);
5. continuous batching on the paged pools: on reduced fp32 configs the
   Scheduler's greedy streams on the kernels equal the plain backend's
   (model-dtype and int8 pools, a stream that preempts); then
   full-width tinyllama-1.1b through the ``Scheduler`` (8 slots, 128
   pages of 16, 24 requests with prompts of 32-256 tokens and gen 32,
   8 submitted at once and 2 more every 4 steps), once with bf16 and
   once with int8 pools: every request FINISHED (a Scheduler that stalls
   fails the run within twice the stream's tokens of rounds, with its
   state), every page free after the drain, the paged kernel launched 22
   times a decode step (every launch on the mma variant: kernel 5's on
   bf16 pools, 7's on int8), the dense decode kernel never,
   ``vwr_attention`` 22 times a (batch-1) prefill; the same stream
   again with 40 pages held, where growth must preempt and every request
   still finish; 4 requests replayed teacher-forced and held against the
   plain path; steps, preemptions, peak pages, table widths, generated
   tokens/s and p50/p99 latency and
   ITL printed;
6. the prefix cache and chunked prefill: kernels 6 and 8 are held and
   timed in phase 2 (tinyllama's 64-token chunk over 16 pages, partial
   and masked pages, the first chunk, C 1, qwen's G 1, D 32 and 128,
   fp32, page 8, int8 pools, tables past the pool); on reduced fp32
   configs the prefix + chunked Scheduler streams on the kernels equal
   the plain backend's (unchunked ones for model-dtype pools); at full
   width, tinyllama-1.1b layer 0's chunk rows through
   ``chunk_prefill_attend`` and ``local_chunk_prefix_attend`` (the
   phase whose launches of kernels 6 and 8 are counted, every one on
   its wgmma variant), a 256-token
   prompt's final-chunk logits through ``lm.prefill_chunk`` against the
   plain path, then the shared-prompt stream (16 of 24 requests open
   with one 128-token system prompt) through the Scheduler in six
   prefix / chunked modes, launch counts checked, the on/on streams
   replayed teacher-forced (each step whose pick is not the served
   token printed with its logit gaps beside its error);
6b. durable serving (``checkpoint.store``, ``engine.snapshot``,
   ``engine.journal``, ``runtime.resilience.serve_with_recovery``) on the
   kernels of phase 6's path: tinyllama-1.1b's shared-prompt stream (all
   24 requests submitted at once, prefix cache and chunks of 64 on) on
   bf16 and on int8 pools, crash-free, then through
   ``serve_with_recovery`` with a snapshot every 4 steps (into a
   temporary directory outside the repo, removed afterwards) and a
   ``CrashFault`` on the fresh run, twice: at a step whose journal
   suffix holds no finished result (the recovered run repeats the
   crash-free schedule) and at one whose suffix holds one (taken
   verbatim from the journal, its slot freed at the snapshot's step),
   each after at least two snapshots with a prompt mid-chunk; every
   request finished, the allocator and trie invariants, every page but
   the trie's free, the paged decode kernel launched 22 times a step
   over both processes (all on mma); the recovered streams equal the
   crash-free ones, except that on int8 pools a stream parting after
   the journal crash is replayed with its recovered tokens and held at
   5e-2 (``_hold_streams``), counted; then a snapshot of a live
   Scheduler (a prompt mid-chunk) restored into a fresh one: every pool
   leaf (bf16, int8, fp32 scales), the table, lengths, free-list order,
   trie and slots bitwise, and the next step's logits bitwise on both;
   the snapshot's cut, background write, restore and one fsynced
   journal append timed beside the card's name and power limit, and
   the recovered run's wall beside the crash-free run's.  Phase 8 ends
   with DeepSeek-V3 at depth 4 on int8 latent pools the same way
   (kernel 13 over restored pages and scales; the journal crash; parted
   streams replayed in the served slot layout, ``_replay_both``), and
   phase 6c with seamless-m4t-large-v2's Scheduler stream (a snapshot
   every 40 steps, ~0.9 GB of pools each with the cross cache; the
   crash after two, with no result since the last: restored slots keep
   their encoder rows, every stream equals the crash-free run's) and the
   fsynced journal append of an internvl2 request (256 x 1024 frontend
   floats as JSON) timed;
6c. the frontend families at full width, random conditioned weights:
   internvl2-2b (vlm: 24 layers, d 2048, 16 / 8 heads of 128, d_ff
   8192, 256 projected patch embeddings of 1024 ahead of each prompt)
   and seamless-m4t-large-v2 (audio: 24 encoder + 24 decoder layers, d
   1024, 16 heads of 64, layernorm, relu d_ff 8192, vocab 256206; frames
   of 1024); their reduced fp32 configs first (greedy streams identical,
   1e-3).  ``generate`` at batch 4 (internvl2: 128-token prompts;
   seamless: 512 frames, decoder prompts of 16), gen 32, launches and
   variants held (kernel 4 twice a seamless layer a step: self and
   cross), teacher-forced against the plain path at 5e-2; the Scheduler
   stream of phase 5 with frontends (internvl2's first 12 requests at
   gen 16 on bf16 and int8 pools over 160 pages, where growth preempts;
   seamless's first 12 requests
   with 160-960 frames under ``enc_len`` 1024 on bf16 pools, kernel 5
   twice a layer a step
   over the self pools and the identity-paged cross cache), every
   request finished, launches on kernels 1-5 and 7's Hopper variants
   only, finished requests replayed in the live slots against a batch-1
   plain engine at 5e-2; seamless's int8 pools refused;
6d. the recurrent families: phase 2 holds and times kernels 1-4 at
   zamba2-1.2b's shared-block shapes (``check_hybrid_shapes``); their
   reduced fp32 configs (prompts of 32: two chunks of 16) greedy streams
   identical to the plain path's at 1e-3; then at full width and depth,
   random conditioned bf16 weights, zamba2-1.2b (hybrid: 38 Mamba2
   blocks of d_inner 4096, 64 heads of 64, d_state 64, chunk 256; the
   shared attention + MLP block, 32 MHA heads of 64 and swiglu 8192,
   invoked 7 times) and xlstm-350m (ssm: 4 groups of 5 mLSTM + 1 sLSTM,
   d 1024, 4 heads of P 512): ``generate`` (batch 4, prompt 256, gen
   32), zamba2's launches and variants held at phase 3's dense per-layer
   counts times 7 invocations, xlstm's at zero for every kernel,
   teacher-forced against the plain path at 5e-2; a decode step and a
   prefill split by block kind (CUDA events: the Mamba2 / mLSTM / sLSTM
   blocks alone, zamba2's shared block and kernels 1-4 alone); the
   recurrence held in fp32 (a 512-token prefill's logits at positions
   255-511 against a 256-token prefill and 256 teacher-forced decode
   steps, 1e-3 of scale: the chunk carry and the one-token steps); the
   paged engine's refusal of both;
7. the moe family: kernels 10, 14 (dense latent cache) and 11, 13
   (latent page pools, int8 with page scales) are held and timed in
   phase 2 at DeepSeek-V3's widths (H 128, r 512, rope 64); on reduced
   fp32 deepseek-v3 (MLA) and olmoe (GQA) ``generate`` and the
   Scheduler's streams (model-dtype and int8 pools) on the kernels
   equal the plain path's; then deepseek-v3-671b at full width cut to
   4 layers (3 dense, 1 MoE of 256 experts; bf16, ~30 GB of random,
   conditioned weights): ``generate`` (batch 4, prompt 128, gen 32;
   kernel 10 four times a decode step, every launch on its wgmma
   variant) teacher-forced against the plain
   path with the routing of both compared, kernel 14 through
   ``dist.decode.local_mla_decode_attend`` over generate's latent cache
   quantized per sequence (every launch on its wgmma variant), and the
   Scheduler stream of phase 5 on bf16
   and int8 latent pools (kernels 11 and 13, every launch on the wgmma
   variant), its requests replayed in
   the live slots through both paths;
8. the prefix cache and chunked prefill of the MLA families: kernels 12
   and 15 (a chunk's C tokens against its prior latent pages, one (J,)
   table) are held and timed in phase 2 at DeepSeek-V3's widths (a
   64-token chunk over 16 pages of 16, a partial page, a count-0 page,
   a first chunk, C 1, fp32 pools, a table entry past the pool); on
   reduced fp32 deepseek-v3, olmoe and a dense config with MLA the
   prefix + chunked Scheduler streams on the kernels equal the plain
   path's (both pools); then deepseek-v3-671b at depth 4 serves the
   shared-prompt stream of phase 6 with the prefix cache and chunked
   prefill on (chunks of 64) on bf16 and int8 latent pools (kernel 11 or
   13 four times a decode or mixed step), every request finished and
   every page but the trie's free; kernels 12 and 15 run through
   ``chunk_prefix_mla_paged{,_q8}`` on the stream's system-prompt pages
   with each layer's true queries (the phase whose launches of 12 and
   15 are counted), and 8 requests are replayed, prompts in chunks,
   through both paths with the routing rule of phase 7.  A chunk or a
   suffix is its own MoE group, whose capacity (1.25 x its tokens x 8 /
   256) drops otherwise than the whole prompt's, so the chunked streams
   are held against the plain path's chunked ones, not the unchunked;
9. the paper's CNN path (``core``, ``configs.provet_cnn``, kernels 16
   ``vwr_conv2d`` and 17 ``vwr_depthwise``): phase 2 holds both against
   their plain versions at the JAX tests' ragged shapes (C 7 / 3, F 5 /
   9, 1x1, 5x5 and 7x7 taps, H_out and W_out off the tile, every
   epilogue with and without bias), at the edges of kernel 16's wgmma
   variant (C 96, row tiles across images, 1x1 and 5x5 taps, K split
   unevenly) and at every stride-1 layer of the suite (N 1 and 32, bf16
   and fp32), each served by the variant ``variant`` / ``dw_variant``
   names (bf16 wgmma bitwise over two launches; the depthwise layers on
   the row-streamed strips, whose ragged channel blocks, strips and
   column tiles are held too) and timed beside its bound, its plain
   version and cuDNN, and times the wgmma plans behind the split rule
   and the depthwise strips' plans beside the halo-tile kernel;
   here the suite runs through ``ops.vwr_conv2d`` (bias + relu) and
   ``ops.vwr_depthwise``, and the section 6.1 demo on the card, launches
   counted (``vwr_conv2d``'s per variant), outputs held against
   the plain versions, and the fused bias + relu conv is timed against
   the conv followed by separate bias and relu passes; RN_112x112
   (stride 2) and AN_55x55 (stride 4) are printed as not covered;
10. training, on the 'torch' backend (the kernels are forward-only, as
   the JAX package trains on 'xla'; no kernel launches here): (a)
   tinyllama-1.1b at full width and depth, bf16 weights from a seed
   (``_condition``ed), fp32 master copies and moments, remat "full",
   4 x 1024 SyntheticLM tokens a step: one warm-up step through
   ``build_train_step``, 5 timed (tok/s; forward + backward and the
   optimizer by CUDA events; peak memory), every loss and grad norm
   finite; (b) the first step again in fp32 (TF32 off): loss within
   1e-2, each grad leaf within 5e-2 of its norm; (c) remat "none" /
   "full" / "dots" at depth 2: the same grads; (d) each served family's
   reduced fp32 config, 3 steps on the card against the same steps on
   the CPU; (e) width_reduce(tinyllama): 50 steps, the loss falls by
   0.3, and n_microbatches 4 matches 1; (f) 6 steps straight equal 3 +
   a CheckpointStore save and restore + 3, bit for bit; (g) training
   on kernel_impl "cuda" raises the forward-only ValueError; (h)
   ``launch.train.main`` runs 20 steps and resumes to 30;
11. the serving surfaces (``launch/serve.py``, the "auto" backend,
   ``kernels/autotune.py``; the run starts from an empty autotuner cache
   of its own, ``chiprun_out/autotune.json``, and phases 3-6 print the
   tuner misses inside each timed window, which must be none (the plan
   hooks only look up outside a tuning pass), listed again here): (a)
   full-width tinyllama-1.1b built through ``serve.engine_config_from_args``
   with ``--kernel-impl auto``: ``generate`` (batch 4, prompt 128, gen
   32) after a warm-up that is a tuning pass (``autotune.tuning()``:
   'auto' measures the backends, the plan hooks the tiles; the rule's
   and the tuned plans' summed device us printed), each
   ``dispatch:<op>`` winner printed with both backends' measured us,
   launches by kernel and variant, teacher-forced logits against the
   plain path at 5e-2 of scale, the same on "cuda" beside it (its plans
   looked up), the host enqueue time of a decode step on each; phase
   5's stream shape (8 slots, 128 pages of 16, 24 requests) through
   ``serve._serve_stream`` on bf16 pools on each, a warm-up stream (a
   tuning pass on 'auto') before the timed one, which must miss
   nothing; (b) ``autotune.reset()`` and the same generate again: no
   miss, the same tokens; (c) in a tuning pass, kernels 1, 2 and 16 at
   phase 2's headline shapes through
   their wrappers: the tuner's plan and its time beside the rule's, the
   output on the rule's variant, held to the plain version at TOL and
   bitwise over two launches; (d) ``serve.main`` at the CLI's own
   ``--reduce width``: generate, ``--stream 24 --inject``, and a durable
   stream crashed at step 6 (a snapshot every 2 steps) equal to a
   crash-free one; ``examples.quickstart``, ``examples.serve_batch
   --stream --crash-at 6 --snapshot-every 2`` and ``examples.train_100m
   --steps 20`` as subprocesses, each to exit 0;
12. distributed serving (``serve_distributed``): ranks spawned on this
   card by ``launch.mesh.run_ranks`` (gloo between them: NCCL refuses two
   ranks on one GPU), each launching the decode kernels on its own slab:
   tinyllama-1.1b (full width, bf16) ``generate`` B4 P128 gen 16 on
   (1, 2) and (2, 2) with the cache sequence-sharded and on (2, 1) with
   the batch split, and P16 gen 16 on (1, 2) (rank 1's slab empty, kernel
   4 launched with no valid key), each held against the single rank in
   this process (teacher-forced logits at 5e-2 of scale, greedy tokens
   counted, tokens equal on every rank, the seeded parameters' digests
   equal), and a sampled P16 gen 16 on (2, 1) equal to the single
   rank's; the first 6 requests of phase 5's Scheduler stream on (1, 2)
   seq over bf16 and int8 pools (kernels 5 and 7 over tables of foreign pages at count 0; every
   parted request replayed with the single rank's tokens and held at
   5e-2); the
   reduced dense + MLA config (fp32) through generate and the Scheduler
   on (1, 2) seq (kernels 10, 11, 13; equal greedy streams on fp32
   pools, logits at 1e-3); kernels 10, 11, 13, 14 at DeepSeek-V3's widths
   and 9, 6, 8, 12, 15 at phase 2's shapes through ``dist.decode``'s
   sharded functions against the same kernels on the whole operands;
   decode tok/s of each mesh beside the single rank's, the combine's
   share of a decode step, the launches per rank; tensor-parallel
   serving on the (1, 2) world (``_tp_world``: each rank its blocks of
   the weights under ``param_pspecs(..., 'serve')``, no seq): phase 5's
   first 12 requests on bf16 pools against the single rank's streams,
   tinyllama-1.1b's generate B4 P128 gen 16 against the single rank's
   (teacher-forced logits at 5e-2 of scale, flipped rows, tok/s,
   collectives and their wait a decode step, parameter bytes and peak
   memory per rank, launches per rank), kernels 1 and 2 at each rank's
   shapes against their plain versions, and olmoe-1b-7b at full width
   cut to 2 layers with ``ep='full_ep'`` (32 of its 64 experts a rank)
   against the single rank, teacher-forced and routed as it (the sets
   that would differ counted), held at 5e-2;
13. distributed training (``serve_train_distributed``): one (2, 1) world
   of ranks on this card (gloo), the rank functions ``_dp_*``: (a)
   tinyllama-1.1b at full width, bf16, remat "full", global B4 S1024 of
   phase 10's conditioned weights: the data-parallel step with ZeRO-1
   (``build_train_step(mesh=)``) against rank 0's single-rank step on
   the same batch (loss within 1e-2, the fp32 master copies by
   ``_hold_adam``), each rank's peak memory with ZeRO-1 off and on, the
   step's wall, the gradient sync's wall and bytes, tok/s; (b) reduced
   fp32 tinyllama (rank 1's rows half masked) and olmoe (capacity factor
   4), n_microbatches 2, against the same step on one rank on the CPU;
   (c) ``compressed_psum`` of a 32000 x 2048 fp32 leaf against the exact
   mean, the error-feedback contract, its wire bytes beside the fp32
   ring's; (d) ``pipeline_apply`` over a ``{"pipe": 2}`` mesh, width
   2048, 8 microbatches, within 1e-5 of the sequential composition; (e)
   ``launch/train.py --reduce width --data-model 2 1`` with a
   checkpoint, its losses against ``1 1``'s, resumed on ``1 1``;
14. print ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.

Every phase prints ``phase <n> wall: <s> s`` on a line of its own when
it ends (``_phase``); ``chiprun_out/chip_smoke.json`` keeps the walls.

The reduced fp32 configs of phases 3-8 run at the CPU tests' widths
(head dim 16; MLA rank 16, rope 8): the kernel wrappers zero-pad them to
the kernels' widths.  Their greedy Scheduler streams equal the plain
path's; on int8 pools, where the pool write's int8 rounding can turn a
last-bit difference of two fp32 products into a step of the page's
scale and so part two streams at a near-tie, a stream that parts is
replayed with the plain path's tokens through both paths, the plain path
reading the kernel path's int8 pages, and held at the fp32 logits
tolerance to its end (``_hold_streams``).

Details go to ``chiprun_out/chip_smoke.json``.  Without a CUDA device
the script exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense; launch/roofline.py): the bound
# of each kernel is max(operations / peak rate of their type, bytes /
# memory rate)
from repro_torch.launch.roofline import HBM_BW as PEAK_BYTES  # noqa: E402
from repro_torch.launch.roofline import PEAK_FLOPS  # noqa: E402

# Tolerances of a kernel against its plain version on the same inputs.
# fp32: both accumulate in fp32, only the order of the sums differs.
# bf16 outputs: that plus one rounding of the output to bf16 (2^-8).
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1.6e-2)}   # atol, rtol
# End to end, teacher-forced logits of the kernel path against the plain
# path, both relative to the logits' scale.  fp32 reduced configs: 1e-3;
# these random models amplify fp32 rounding (the JAX package's own fp32
# logits are 1.6e-4 from a float64 evaluation on the CPU, and two fp32
# paths on the card differed by 1.3e-4 of scale), and the greedy tokens
# must still be identical.  bf16 full-width configs: 5e-2, since the
# two paths round to bf16 at different points in each of 22-24 layers.
E2E_FP32_TOL = 1e-3
E2E_BF16_REL = 5e-2
# int8 chunk rows through kernel 8 against the same math on the
# dequantized pools: fp32 against fp32 on the same int8 pages, only the
# order of the sums differs (as TOL's fp32 atol)
CHUNK_Q8_REL = 1e-4


def sh(cmd):
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------

def time_ms(torch, fn, reps=20):
    """Mean device time of ``fn`` over ``reps`` launches (``launch_ms``)."""
    return sum(launch_ms(torch, fn, reps)) / reps


def launch_ms(torch, fn, reps=20):
    """Device ms of each of ``reps`` launches of ``fn``, each timed with
    CUDA events after a 64 MB write that evicts the 50 MB L2 (the main
    path finds every weight cold).  A ~0.5 ms device sleep ahead of each
    launch keeps the device behind the host, so the events time queued
    device work, not the host's launch latency."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def bound_ms(flops, nbytes, dtype):
    return 1e3 * max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


# (timed window, autotuner misses inside it) of phases 3-6, printed again
# in phase 11: a miss would measure its candidates inside the window
TIMED_WINDOWS = []


def _tuner_misses():
    from repro_torch.kernels import autotune

    return autotune.stats["misses"]


def _window_misses(label, before):
    """Record and print the tuner misses since ``before`` (a
    ``_tuner_misses()`` taken as the timed window opened)."""
    n = _tuner_misses() - before
    TIMED_WINDOWS.append((label, n))
    print(f"    autotuner misses inside the timed window: {n}")
    if n:
        raise AssertionError(f"{label}: the tuner measured inside the "
                             "timed window")
    return n


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def _swiglu_case(torch, F, KM, build, x, wg, wi, label, compare, record,
                 timed, head):
    """One ``vwr_swiglu`` call held against its plain version, served by
    the variant the rule names (bf16 variants bitwise equal over two
    launches); timed, its row gets the 4-call yardstick as the library
    and, beside it, one cuBLAS product ``x @ [wg | wi]`` (what the two
    products alone cost)."""
    M, K = x.shape
    N = wg.shape[1]
    dt = x.dtype
    shape = f"{M}x{K}x{N}"
    kind = KM.swiglu_variant(M, N, K, dt, True)
    before = dict(build.VARIANTS)
    got = KM.vwr_swiglu(x, wg, wi)
    torch.cuda.synchronize()
    served = [k for k, n in build.VARIANTS.items() if n != before[k]]
    if served != [f"vwr_swiglu.{kind}"]:
        raise AssertionError(f"vwr_swiglu {shape}: the rule picks {kind}, "
                             f"the wrapper launched {served}")
    if (K % 8 or N % 8 or dt == torch.float32) and kind != "gemm":
        raise AssertionError(f"vwr_swiglu {shape}: {kind} cannot take this "
                             "shape")
    err = compare(f"vwr_swiglu {kind}", shape, dt, got,
                  KM.vwr_swiglu_ref(x, wg, wi))
    if kind != "gemm" and not torch.equal(got, KM.vwr_swiglu(x, wg, wi)):
        raise AssertionError(f"vwr_swiglu {kind} {shape}: two launches "
                             "differ")
    if timed:
        record("vwr_swiglu", label, shape, dt, err,
               lambda: KM.vwr_swiglu(x, wg, wi),
               lambda: KM.vwr_swiglu_ref(x, wg, wi),
               lambda: F.silu(x @ wg) * (x @ wi),
               4 * M * K * N,
               x.element_size() * (M * K + 2 * K * N + M * N), head)
        w_cat = torch.cat([wg, wi], 1)
        row = record.rows[-1]
        row["variant"] = kind
        row["cat_ms"] = time_ms(torch, lambda: x @ w_cat)
        print(f"      variant {kind}; one cuBLAS x @ [wg | wi] "
              f"{row['cat_ms']:.4f} ms")
        del w_cat


def check_swiglu(torch, F, gen, randn, compare, record):
    """``vwr_swiglu`` (kernel 2) at the main path's shapes, each served by
    the variant ``swiglu_variant`` names (wgmma tiles for bf16,
    ``gemm_kernel`` for fp32 and K or N off 8), the wgmma output bitwise
    over two launches; then, on inputs of their own generator (so every
    later case draws what it drew before), a batch-1 decode, the
    Scheduler's M 8, a mixed step's M 72 and DeepSeek-V3's shapes timed,
    the wgmma tiles against ``gemm_kernel`` (the WMMA kernel bf16 swiglu
    ran before them) and the library at M 1-72, the wgmma plans, and the
    host's enqueue time of a call on each kernel."""
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels import vwr_matmul as KM

    bf16, f32 = torch.bfloat16, torch.float32
    print("vwr_swiglu")
    sw_cases = [
        ("tinyllama gate/up", 512, 2048, 5632, bf16, True, True),
        ("tinyllama decode", 4, 2048, 5632, bf16, True, False),
        ("tinyllama (1, 2) gate/up", 512, 2048, 2816, bf16, True, False),
        ("tinyllama (1, 2) decode", 4, 2048, 2816, bf16, True, False),
        ("qwen gate/up", 512, 1024, 2816, bf16, True, False),
        ("fp32", 64, 256, 512, f32, False, False),
        ("ragged", 37, 100, 70, f32, False, False),
        ("ragged", 37, 104, 72, bf16, False, False),
    ]
    for label, M, K, N, dt, timed, head in sw_cases:
        x = randn(M, K, dtype=dt)
        wg = randn(K, N, dtype=dt, scale=K ** -0.5)
        wi = randn(K, N, dtype=dt, scale=K ** -0.5)
        _swiglu_case(torch, F, KM, build, x, wg, wi, label, compare, record,
                     timed, head)

    g = torch.Generator(device="cuda").manual_seed(19)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(bf16)

    for label, M, K, N, timed in (
            ("Scheduler decode (8 slots)", 8, 2048, 5632, True),
            ("mixed step (8 slots + 64-token chunk)", 72, 2048, 5632, True),
            ("qwen decode", 4, 1024, 2816, True),
            ("deepseek-v3 shared expert", 4, 7168, 2048, True),
            ("deepseek-v3 dense layers", 4, 7168, 18432, True),
            ("batch-1 decode", 1, 2048, 5632, True),
            ("wgmma, M 2, K off 64, N off 64", 2, 1000, 136, False),
            ("wgmma, N off 64", 300, 1000, 200, False),
            ("wgmma, M and N under a tile", 3, 512, 40, False),
            ("wgmma, M 2, N under a strip", 2, 512, 40, False)):
        _swiglu_case(torch, F, KM, build, rand(M, K),
                     rand(K, N, scale=K ** -0.5), rand(K, N, scale=K ** -0.5),
                     label, compare, record, timed, False)

    # the wgmma tiles against the WMMA kernel at tinyllama's K and N
    print("  swiglu by M (K 2048, N 5632; ms): M, gemm (WMMA), wgmma, "
          "library (4 calls), cuBLAS x @ [wg | wi]")
    K, N = 2048, 5632
    wg, wi = rand(K, N, scale=K ** -0.5), rand(K, N, scale=K ** -0.5)
    w_cat = torch.cat([wg, wi], 1)
    for M in (1, 2, 3, 4, 5, 8, 16, 32, 64, 72):
        x = rand(M, K)
        want = KM.vwr_swiglu_ref(x, wg, wi)
        row = {"kernel": "vwr_swiglu by M", "M": M,
               "bound_ms": bound_ms(4 * M * K * N,
                                    2 * (M * K + 2 * K * N + M * N),
                                    "bfloat16")}
        for kind in ("gemm", "wgmma"):
            compare(f"vwr_swiglu {kind}", f"{M}x{K}x{N}", bf16,
                    KM.swiglu_launch(x, wg, wi, kind), want)
            row[f"{kind}_ms"] = time_ms(
                torch, lambda: KM.swiglu_launch(x, wg, wi, kind))
        row["library_ms"] = time_ms(torch,
                                    lambda: F.silu(x @ wg) * (x @ wi))
        row["cat_ms"] = time_ms(torch, lambda: x @ w_cat)
        row["rule"] = KM.swiglu_variant(M, N, K, bf16, True)
        record.rows.append(row)
        print(f"    M {M:3d}: {row['gemm_ms']:.4f} {row['wgmma_ms']:.4f} "
              f"{row['library_ms']:.4f} {row['cat_ms']:.4f} "
              f"(rule: {row['rule']})")
    del w_cat
    # the plans behind the rule: each variant's plan (first) against the
    # alternatives, the wgmma tiles' 128-column strips among them
    print("  swiglu wgmma plans (ms; (bm, bn, splits, steps)):")
    for M, K, N in ((512, 2048, 5632), (512, 1024, 2816), (72, 2048, 5632),
                    (4, 2048, 5632), (4, 7168, 18432), (1, 2048, 5632)):
        x = rand(M, K)
        wg, wi = rand(K, N, scale=K ** -0.5), rand(K, N, scale=K ** -0.5)
        want = KM.vwr_swiglu_ref(x, wg, wi)
        row = {"kernel": "vwr_swiglu plans", "variant": "wgmma",
               "shape": f"{M}x{K}x{N}", "plans": []}
        for plan in autotune.swiglu_candidates(M, N, K):
            compare("vwr_swiglu wgmma", f"{M}x{K}x{N} {plan}", bf16,
                    KM.swiglu_launch(x, wg, wi, "wgmma", plan), want)
            ms = time_ms(torch, lambda: KM.swiglu_launch(x, wg, wi, "wgmma",
                                                         plan))
            row["plans"].append({"plan": plan, "ms": ms})
        row["library_ms"] = time_ms(torch,
                                    lambda: F.silu(x @ wg) * (x @ wi))
        record.rows.append(row)
        print(f"    {row['shape']}: " + ", ".join(
            f"{p['plan']} {p['ms']:.4f}" for p in row["plans"])
            + f"; library {row['library_ms']:.4f}")
        del x, wg, wi, want
    _swiglu_enqueue(torch, F, KM, rand, record)


def _enqueue_us(torch, fn, reps=200):
    """Host microseconds a call of ``fn`` takes to return (the mean of
    ``reps`` back to back after a warm-up, the device's work not waited
    for), and the same with the device's work waited for at the end."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return 1e6 * (t1 - t0) / reps, 1e6 * (t2 - t0) / reps


def _swiglu_enqueue(torch, F, KM, rand, record):
    """The host's time to enqueue one swiglu call at a decode step's shape
    (and a tiny one): ``gemm_kernel`` (the WMMA kernel bf16 swiglu ran
    before the wgmma tiles) and the wgmma tiles through ``swiglu_launch``,
    the same given the rule's plan, computed each call (the launch
    before the autotuner: the difference is the plan hook's cost), the
    operand checks with the
    ``gemm_kernel`` launch (the wrapper bf16 swiglu had before the wgmma
    tiles), the whole wrapper (``vwr_swiglu``: the checks, the plan
    lookup, the wgmma launch), one ``torch.matmul`` and the 4-call
    library, in three rounds; and the wgmma variant's three tensor maps'
    share of it (``encode_us``)."""
    from repro_torch.kernels import build

    def checked_gemm(x, wg, wi):
        M, K = x.shape
        N = wg.shape[1]
        build.check_operands("vwr_swiglu", x.dtype, x=(x, (M, K)),
                             wg=(wg, (K, N)), wi=(wi, (K, N)))
        return KM.swiglu_launch(x, wg, wi, "gemm")

    print("  swiglu host enqueue (us a call; enqueue, and with the device):")
    for M, K, N in ((4, 2048, 5632), (4, 64, 64)):
        x = rand(M, K)
        wg, wi = rand(K, N, scale=K ** -0.5), rand(K, N, scale=K ** -0.5)
        calls = {
            "gemm": lambda: KM.swiglu_launch(x, wg, wi, "gemm"),
            "wgmma": lambda: KM.swiglu_launch(x, wg, wi, "wgmma"),
            "wgmma, rule's plan given": lambda: KM.swiglu_launch(
                x, wg, wi, "wgmma", KM.swiglu_tile_plan(M, N, K)),
            "checks + gemm": lambda: checked_gemm(x, wg, wi),
            "vwr_swiglu": lambda: KM.vwr_swiglu(x, wg, wi),
            "torch.matmul": lambda: torch.matmul(x, wg),
            "library": lambda: F.silu(x @ wg) * (x @ wi),
        }
        row = {"kernel": "vwr_swiglu enqueue", "shape": f"{M}x{K}x{N}",
               **{k: [] for k in calls}}
        for _ in range(3):
            for name, fn in calls.items():
                row[name].append(_enqueue_us(torch, fn))
        row["encode_us"] = KM.encode_us(x, wg, weights=2)
        record.rows.append(row)
        for name in calls:
            print(f"    {row['shape']} {name}: " + ", ".join(
                f"{a:.2f} / {b:.2f}" for a, b in row[name]))
        print(f"    {row['shape']} wgmma tensor maps (x, wg, wi): "
              f"{row['encode_us']:.3f} us a call")
        del x, wg, wi


def _served(kernel, shape, before, build, want):
    """The variant of ``kernel`` that the launches since ``before`` (a
    copy of ``build.VARIANTS``) counted must be ``want`` alone."""
    served = {k.split(".")[-1] for k, n in build.VARIANTS.items()
              if k.startswith(kernel + ".") and n != before[k]}
    if served != {want}:
        raise AssertionError(f"{kernel} {shape}: the rule picks {want}, "
                             f"the wrapper launched {sorted(served)}")


def _bitwise(kernel, shape, got, again):
    """Two launches of a kernel on the same inputs give equal outputs."""
    if not all(a.equal(b) for a, b in zip(got, again)):
        raise AssertionError(f"{kernel} {shape}: two launches differ")


def check_kernels(torch, F):
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels import vwr_attention as KA
    from repro_torch.kernels import vwr_chunk as KC
    from repro_torch.kernels import vwr_decode as KD
    from repro_torch.kernels import vwr_matmul as KM
    from repro_torch.kernels import widths

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    def compare(name, shape, dtype, got, want):
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        got, want = [t if isinstance(t, tuple) else (t,) for t in
                     (got, want)]
        err, excess = 0.0, 0.0
        for g, w in zip(got, want):
            d = (g.float() - w.float()).abs()
            err = max(err, d.max().item())
            excess = max(excess, (d - atol - rtol * w.float().abs()).max()
                         .item())
        ok = excess <= 0
        print(f"  {name:18s} {shape:34s} {str(dtype)[6:]:9s} "
              f"max|err| {err:.3e} (atol {atol:g}, rtol {rtol:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {shape} {dtype}: kernel "
                                 "disagrees with its plain version")
        return err

    results = []

    def record(kernel, label, shape, dtype, err, fn, plain, library,
               flops, nbytes, headline=False, op_dtype=None):
        """``op_dtype``: the type the operations run in, for the bound
        (the input dtype unless given)."""
        ms = time_ms(torch, fn)
        ops_t = str(op_dtype or dtype)[6:]
        row = {"kernel": kernel, "case": label, "shape": shape,
               "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms,
               "plain_ms": time_ms(torch, plain),
               "library_ms": (None if library is None
                              else time_ms(torch, library)),
               "bound_ms": bound_ms(flops, nbytes, ops_t),
               "bound_by": ("operations" if flops / PEAK_FLOPS[ops_t]
                            > nbytes / PEAK_BYTES else "bytes"),
               "headline": headline}
        results.append(row)
        print(f"    {label}: kernel {ms:.4f} ms, plain {row['plain_ms']:.4f}"
              f" ms, library {row['library_ms']} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")

    record.rows = results   # the phase's rows, for the checks it calls

    # ---- vwr_matmul: act(x @ w + bias) + residual ----
    print("vwr_matmul")
    cross = KM.SPLITK_MAX_M
    mm_cases = [
        # label, M, K, N, dtype, bias, residual, act, timed, headline
        ("tinyllama q", 512, 2048, 2048, bf16, False, False, None, True, False),
        ("tinyllama k/v", 512, 2048, 256, bf16, False, False, None, True, False),
        ("tinyllama o+res", 512, 2048, 2048, bf16, False, True, None, True, False),
        ("tinyllama down+res", 512, 5632, 2048, bf16, False, True, None, True, True),
        ("tinyllama decode down", 4, 5632, 2048, bf16, False, False, None, True, False),
        # a rank's shapes of tinyllama on (1, 2) tensor-parallel (phase 12)
        ("tinyllama (1, 2) q", 512, 2048, 1024, bf16, False, False, None, True, False),
        ("tinyllama (1, 2) k/v", 512, 2048, 128, bf16, False, False, None, True, False),
        ("tinyllama (1, 2) o+res", 512, 1024, 2048, bf16, False, True, None, True, False),
        ("tinyllama (1, 2) down+res", 512, 2816, 2048, bf16, False, True, None, True, False),
        ("tinyllama (1, 2) decode down", 4, 2816, 2048, bf16, False, False, None, True, False),
        ("qwen qkv+bias", 512, 1024, 1024, bf16, True, False, None, True, False),
        ("qwen decode down", 4, 2816, 1024, bf16, False, False, None, True, False),
        ("deepseek-v3 decode down", 4, 18432, 7168, bf16, False, False, None, True, False),
        ("deepseek-v3 shared-expert down", 4, 2048, 7168, bf16, False, False, None, True, False),
        ("fp32 k/v", 512, 2048, 256, f32, False, False, None, False, False),
        ("ragged gelu", 100, 130, 50, f32, True, True, "gelu", False, False),
        ("ragged relu", 77, 200, 333, bf16, True, False, "relu", False, False),
        ("ragged silu", 5, 70, 19, f32, False, True, "silu", False, False),
        ("ragged silu", 5, 72, 24, bf16, True, True, "silu", False, False),
        # the rows the variant rule parts: decode batches, the crossover
        # +- 1, a mixed step (8 slots + a 64-token chunk)
        *[(f"M {m}", m, 5632, 2048, bf16, False, False, None, False, False)
          for m in sorted({1, 4, 8, 16, cross - 1, cross, cross + 1, 72})],
        # bias, residual and each activation on both bf16 variants
        ("split-K epilogue", 4, 2048, 256, bf16, True, True, "silu", False, False),
        ("split-K epilogue", 3, 1000, 136, bf16, True, False, "relu", False, False),
        ("split-K epilogue", 2, 4104, 264, bf16, False, True, "gelu", False, False),
        ("wgmma epilogue", 72, 2048, 256, bf16, True, True, "silu", False, False),
        ("wgmma epilogue", 100, 200, 136, bf16, True, False, "relu", False, False),
        ("wgmma epilogue", 300, 1000, 2056, bf16, False, True, "gelu", False, False),
        # K off the split's slice; K or N off 8 (these take gemm_kernel)
        ("K off the slice", 4, 1000, 2048, bf16, False, False, None, False, False),
        ("K off 8", 4, 70, 2048, bf16, True, False, None, False, False),
        ("N off 8", 512, 2048, 250, bf16, False, True, None, False, False),
    ]
    for label, M, K, N, dt, has_b, has_r, act, timed, head in mm_cases:
        x = randn(M, K, dtype=dt)
        w = randn(K, N, dtype=dt, scale=K ** -0.5)
        b = randn(1, N, dtype=dt) if has_b else None
        r = randn(M, N, dtype=dt) if has_r else None
        shape = f"{M}x{K}x{N}" + ("+bias" if has_b else "") + (
            "+res" if has_r else "") + (f"+{act}" if act else "")
        kind = KM.variant(M, N, K, dt, True)
        before = dict(build.VARIANTS)
        got = KM.vwr_matmul(x, w, b, r, activation=act)
        torch.cuda.synchronize()
        served = [k for k, n in build.VARIANTS.items() if n != before[k]]
        if served != [f"vwr_matmul.{kind}"]:
            raise AssertionError(f"vwr_matmul {shape}: the rule picks "
                                 f"{kind}, the wrapper launched {served}")
        if (K % 8 or N % 8 or dt == f32) and kind != "gemm":
            raise AssertionError(f"vwr_matmul {shape}: {kind} cannot take "
                                 "this shape")
        err = compare(f"vwr_matmul {kind}", shape, dt, got,
                      KM.vwr_matmul_ref(x, w, b, r, activation=act))
        if kind != "gemm" and not torch.equal(
                got, KM.vwr_matmul(x, w, b, r, activation=act)):
            raise AssertionError(f"vwr_matmul {kind} {shape}: two launches "
                                 "differ")
        if timed:
            elt = x.element_size()
            nbytes = elt * (M * K + K * N + M * N * (2 if has_r else 1)
                            + (N if has_b else 0))
            lib = None
            if act is None and not (has_b and has_r):
                add = b if has_b else r
                lib = ((lambda: torch.matmul(x, w)) if add is None
                       else (lambda: torch.addmm(add, x, w)))
            record("vwr_matmul", label, shape, dt, err,
                   lambda: KM.vwr_matmul(x, w, b, r, activation=act),
                   lambda: KM.vwr_matmul_ref(x, w, b, r, activation=act),
                   lib, 2 * M * K * N, nbytes, head)
            results[-1]["variant"] = kind

    # the crossover: both bf16 variants at the down projection's K and N
    print("  M crossover (K 5632, N 2048; ms): M, split-K, wgmma, cuBLAS")
    for M in (1, 4, 8, 16, 32, 64, 72):
        x = randn(M, 5632, dtype=bf16)
        w = randn(5632, 2048, dtype=bf16, scale=5632 ** -0.5)
        want = KM.vwr_matmul_ref(x, w)
        row = {"kernel": "vwr_matmul crossover", "M": M,
               "bound_ms": bound_ms(2 * M * 5632 * 2048,
                                    2 * (M * 5632 + 5632 * 2048 + M * 2048),
                                    "bfloat16")}
        for kind in ("splitk", "wgmma"):
            compare(f"vwr_matmul {kind}", f"{M}x5632x2048", bf16,
                    KM.launch(x, w, None, None, None, kind), want)
            row[f"{kind}_ms"] = time_ms(
                torch, lambda: KM.launch(x, w, None, None, None, kind))
        row["library_ms"] = time_ms(torch, lambda: torch.matmul(x, w))
        row["rule"] = KM.variant(M, 2048, 5632, bf16, True)
        results.append(row)
        print(f"    M {M:3d}: {row['splitk_ms']:.4f} {row['wgmma_ms']:.4f} "
              f"{row['library_ms']:.4f} (rule: {row['rule']})")
    # the plans behind the rule: each variant's plan (first) against the
    # alternatives at the main path's shapes
    print("  plans (ms; (tile, splits, depth)):")
    for kind, M, K, N in (("wgmma", 512, 5632, 2048), ("wgmma", 512, 2048, 256),
                          ("wgmma", 72, 5632, 2048), ("wgmma", 8, 5632, 2048),
                          ("splitk", 4, 5632, 2048), ("splitk", 4, 18432, 7168)):
        x = randn(M, K, dtype=bf16)
        w = randn(K, N, dtype=bf16, scale=K ** -0.5)
        row = {"kernel": "vwr_matmul plans", "variant": kind,
               "shape": f"{M}x{K}x{N}", "plans": []}
        for plan in autotune.matmul_candidates(kind, M, N, K):
            ms = time_ms(torch, lambda: KM.launch(x, w, None, None, None,
                                                  kind, plan))
            row["plans"].append({"plan": plan, "ms": ms})
        row["library_ms"] = time_ms(torch, lambda: torch.matmul(x, w))
        results.append(row)
        print(f"    {kind} {row['shape']}: " + ", ".join(
            f"{p['plan']} {p['ms']:.4f}" for p in row["plans"])
            + f"; cuBLAS {row['library_ms']:.4f}")
    x, w = randn(512, 5632, dtype=bf16), randn(5632, 2048, dtype=bf16)
    enc = KM.encode_us(x, w)
    results.append({"kernel": "vwr_matmul tensor maps",
                    "shape": "512x5632x2048", "encode_us": enc})
    print(f"  wgmma variant: encoding both tensor maps {enc:.3f} us a call "
          "(host)")

    # ---- vwr_swiglu: silu(x @ wg) * (x @ wi) ----
    check_swiglu(torch, F, gen, randn, compare, record)

    # ---- vwr_attention: causal, zero-copy GQA ----
    print("vwr_attention")
    at_cases = [
        ("tinyllama prefill", 4, 128, 32, 4, 64, bf16, True, True),
        ("tinyllama (1, 2) prefill", 4, 128, 16, 2, 64, bf16, True, False),
        ("qwen prefill (G=1)", 4, 128, 16, 16, 64, bf16, True, False),
        ("tinyllama batch-1 prefill", 1, 256, 32, 4, 64, bf16, True, False),
        ("tinyllama long prefill", 1, 2048, 32, 4, 64, bf16, True, False),
        ("olmoe prefill (D=128)", 1, 512, 16, 16, 128, bf16, True, False),
        ("G=16", 2, 100, 32, 2, 64, bf16, False, False),
        ("S=1", 1, 1, 16, 1, 64, bf16, False, False),
        ("S off the tile", 1, 130, 32, 4, 64, bf16, False, False),
        ("ragged S", 2, 100, 8, 2, 64, f32, False, False),
        ("ragged S", 1, 200, 4, 1, 64, bf16, False, False),
        ("D=128", 1, 70, 4, 2, 128, f32, False, False),
        ("D=32", 2, 33, 2, 2, 32, bf16, False, False),
        ("D=16 (reduced, padded)", 2, 33, 4, 2, 16, f32, False, False),
        ("D=16 (reduced, padded)", 1, 40, 4, 4, 16, bf16, False, False),
    ]
    for label, B, S, H, KV, D, dt, timed, head in at_cases:
        q = randn(B, S, H, D, dtype=dt)
        k = randn(B, S, KV, D, dtype=dt)
        v = randn(B, S, KV, D, dtype=dt)
        shape = f"B{B} S{S} H{H} KV{KV} D{D}"
        got = KA.vwr_attention(q, k, v)
        torch.cuda.synchronize()
        err = compare("vwr_attention", shape, dt, got,
                      KA.vwr_attention_ref(q, k, v))
        if dt == bf16 and not torch.equal(got, KA.vwr_attention(q, k, v)):
            raise AssertionError(f"vwr_attention {shape}: two launches "
                                 "differ")
        if timed:
            G = H // KV
            # the library call gets the heads expanded outside its time
            qt = q.transpose(1, 2)
            kt, vt = (t.transpose(1, 2).repeat_interleave(G, 1)
                      for t in (k, v))
            record("vwr_attention", label, shape, dt, err,
                   lambda: KA.vwr_attention(q, k, v),
                   lambda: KA.vwr_attention_ref(q, k, v),
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True),
                   4 * B * H * D * S * (S + 1) // 2,
                   q.element_size() * 2 * B * S * D * (H + KV), head)

    # ---- vwr_flash_decode: unnormalized partials vs a dense cache ----
    print("vwr_flash_decode")
    dc_cases = [
        # label, B, T, KV, G, D, cur_len, pos0, dtype, timed, headline
        ("tinyllama decode", 4, 160, 4, 8, 64, 144, 0, bf16, True, True),
        ("tinyllama decode full", 4, 160, 4, 8, 64, 160, 0, bf16, False, False),
        ("tinyllama (1, 2) decode", 4, 160, 2, 8, 64, 144, 0, bf16, True,
         False),
        ("qwen decode (G=1)", 4, 136, 16, 1, 64, 130, 0, bf16, True, False),
        ("ragged slab", 2, 77, 2, 4, 64, 50, 5, f32, False, False),
        ("masked row", 2, 40, 2, 4, 64, 3, 10, f32, False, False),
        ("D=128 G=16", 1, 65, 1, 16, 128, 65, 0, f32, False, False),
        ("D=32 G=3", 3, 33, 2, 3, 32, 20, 0, bf16, False, False),
        ("D=16 G=4 (reduced, padded)", 2, 40, 1, 4, 16, 37, 0, f32, False,
         False),
        ("D=16 G=32 (2 launches)", 2, 40, 2, 32, 16, 37, 0, bf16, False,
         False),
        ("D=64 G=40 (3 launches)", 1, 70, 1, 40, 64, 66, 2, f32, False,
         False),
    ]
    for label, B, T, KV, G, D, cur, pos0, dt, timed, head in dc_cases:
        q = randn(B * KV, G, D, dtype=dt)
        k = randn(B, T, KV, D, dtype=dt)
        v = randn(B, T, KV, D, dtype=dt)
        shape = f"B{B} T{T} KV{KV} G{G} D{D} cur{cur} pos0{pos0}"
        before = dict(build.VARIANTS)
        got = KD.vwr_flash_decode(q, k, v, cur, pos0)
        torch.cuda.synchronize()
        _served("vwr_flash_decode", shape, before, build,
                KD.decode_variant(dt, widths.native_width(
                    D, KD.HEAD_DIMS, "vwr_flash_decode"), min(G, 16)))
        # fp32 partials whatever the input type
        err = compare("vwr_flash_decode", shape, f32, got,
                      KD.vwr_flash_decode_ref(q, k, v, cur, pos0))
        if label == "masked row" and got[2].abs().max().item() != 0.0:
            raise AssertionError("a group with no valid key must give l=0")
        if dt == bf16:
            _bitwise("vwr_flash_decode", shape, got,
                     KD.vwr_flash_decode(q, k, v, cur, pos0))
        if timed:
            n = max(0, min(T, cur - pos0))
            qs = q.reshape(B, KV * G, 1, D)
            ks = k[:, :n].transpose(1, 2).repeat_interleave(G, 1)
            vs = v[:, :n].transpose(1, 2).repeat_interleave(G, 1)
            elt = q.element_size()
            record("vwr_flash_decode", label, shape, dt, err,
                   lambda: KD.vwr_flash_decode(q, k, v, cur, pos0),
                   lambda: KD.vwr_flash_decode_ref(q, k, v, cur, pos0),
                   lambda: F.scaled_dot_product_attention(qs, ks, vs),
                   4 * B * KV * G * D * n,
                   elt * (B * KV * G * D + 2 * B * n * KV * D)
                   + 4 * B * KV * G * (D + 2), head)

    # ---- vwr_flash_decode_q8: the same over an int8 cache, (B*KV,) scales
    print("vwr_flash_decode_q8")
    for label, B, T, KV, G, D, cur, pos0, dt, timed, head in dc_cases:
        q = randn(B * KV, G, D, dtype=dt)
        k, v = [torch.randint(-127, 128, (B, T, KV, D), generator=gen,
                              device="cuda", dtype=torch.int8)
                for _ in range(2)]
        ks, vs = [torch.rand(B * KV, generator=gen, device="cuda") * 0.02
                  + 1e-3 for _ in range(2)]
        args = (q, k, v, ks, vs, cur, pos0)
        shape = f"B{B} T{T} KV{KV} G{G} D{D} cur{cur} pos0{pos0}"
        before = dict(build.VARIANTS)
        got = KD.vwr_flash_decode_q8(*args)
        torch.cuda.synchronize()
        kind = KD.decode_variant(dt, widths.native_width(
            D, KD.HEAD_DIMS, "vwr_flash_decode_q8"), min(G, 16))
        _served("vwr_flash_decode_q8", shape, before, build, kind)
        err = compare("vwr_flash_decode_q8", shape, f32, got,
                      KD.vwr_flash_decode_q8_ref(*args))
        if kind == "split":
            compare("  vs emulation", shape, f32, got,
                    KD.decode_split_emulation(q, k, v, cur, pos0,
                                              scales=(ks, vs)))
            _bitwise("vwr_flash_decode_q8", shape, got,
                     KD.vwr_flash_decode_q8(*args))
        if label == "masked row" and got[2].abs().max().item() != 0.0:
            raise AssertionError("a group with no valid key must give l=0")
        if timed:
            n = max(0, min(T, cur - pos0))
            record("vwr_flash_decode_q8", label, shape, dt, err,
                   lambda: KD.vwr_flash_decode_q8(*args),
                   lambda: KD.vwr_flash_decode_q8_ref(*args),
                   _decode_q8_sdpa(F, q, k, v, ks, vs, n),
                   4 * B * KV * G * D * n,
                   q.element_size() * B * KV * G * D + 2 * B * n * KV * D
                   + 8 * B * KV + 4 * B * KV * G * (D + 2), head)

    # ---- vwr_paged_flash_decode[_q8]: partials through a block table ----
    tiny_lens = (0, 1, 16, 17, 255, 100, 200, 64)
    pg_cases = [
        # label, B, KV, G, D, page_size, n_pages, J, lens, dtype, timed,
        # headline
        ("tinyllama 8 slots", 8, 4, 8, 64, 16, 1024, 16, tiny_lens, bf16,
         True, True),
        ("qwen 8 slots (G=1)", 8, 16, 1, 64, 16, 1024, 16, tiny_lens, bf16,
         True, False),
        ("tinyllama (1, 2) 8 slots", 8, 2, 8, 64, 16, 1024, 16, tiny_lens,
         bf16, True, False),
        ("fp32", 4, 4, 8, 64, 16, 256, 16, (255, 0, 17, 16), f32, False,
         False),
        ("D=32 G=3", 3, 2, 3, 32, 16, 64, 6, (5, 0, 90), bf16, False,
         False),
        ("D=128 G=16", 2, 1, 16, 128, 16, 64, 5, (33, 64), f32, False,
         False),
        ("page 8, wide table", 3, 2, 4, 64, 8, 128, 12, (1, 40, 9), bf16,
         False, False),
        ("D=16 G=4 (reduced, padded)", 3, 1, 4, 16, 8, 12, 6, (40, 0, 9),
         f32, False, False),
        ("D=16 G=32 (2 launches)", 2, 2, 32, 16, 8, 32, 6, (33, 17), bf16,
         False, False),
    ]
    for q8 in (False, True):
        kname = "vwr_paged_flash_decode" + ("_q8" if q8 else "")
        print(kname)
        for (label, B, KV, G, D, ps, n_pages, J, lens, dt, timed,
             head) in pg_cases:
            q = randn(B * KV, G, D, dtype=dt)
            shape = (n_pages, ps, KV, D)
            if q8:
                pools = [torch.randint(-127, 128, shape, generator=gen,
                                       device="cuda", dtype=torch.int8)
                         for _ in range(2)]
                scales = [torch.rand((n_pages, KV), generator=gen,
                                     device="cuda") * 0.02 + 1e-3
                          for _ in range(2)]
            else:
                pools = [randn(*shape, dtype=dt) for _ in range(2)]
                scales = []
            table, counts, live = _paged_table(torch, gen, lens, J, ps,
                                               n_pages)
            ops_ = (q, *pools, *scales, table, counts)
            fn = KD.vwr_paged_flash_decode_q8 if q8 \
                else KD.vwr_paged_flash_decode
            ref = KD.vwr_paged_flash_decode_q8_ref if q8 \
                else KD.vwr_paged_flash_decode_ref
            shape_s = (f"B{B} KV{KV} G{G} D{D} ps{ps} J{J} "
                       f"pages{n_pages} lens{max(lens)}")
            before = dict(build.VARIANTS)
            got = fn(*ops_)
            torch.cuda.synchronize()
            kind = KD.paged_variant(
                dt, widths.native_width(D, KD.HEAD_DIMS, kname),
                min(G, KD.MAX_GROUP))
            _served(kname, shape_s, before, build, kind)
            err = compare(kname, shape_s, f32, got, ref(*ops_))
            if kind == "mma":
                compare("  vs emulation", shape_s, f32, got,
                        KD.paged_mma_emulation(
                            q, *pools, table, counts,
                            scales=tuple(scales) or None))
                _bitwise(kname, shape_s, got, fn(*ops_))
            for b, n in enumerate(lens):
                if n == 0 and got[2][b * KV:(b + 1) * KV].abs().max() != 0:
                    raise AssertionError("a slot with no valid key must "
                                         "give l=0")
            if timed:
                # the kernel reads only the valid keys of a live page,
                # but both scales of every live (page, head)
                n_keys = sum(lens)
                pool_elt = pools[0].element_size()
                nbytes = (pool_elt * 2 * n_keys * KV * D
                          + (8 * live * KV if q8 else 0)
                          + q.element_size() * q.numel()
                          + 8 * B * J + 4 * B * KV * G * (D + 2))
                record(kname, label, shape_s, dt, err,
                       lambda: fn(*ops_), lambda: ref(*ops_),
                       _paged_sdpa(torch, F, q, pools, scales, table,
                                   counts, KV, G, D),
                       4 * KV * G * D * n_keys, nbytes, head)
                row = record.rows[-1]
                row["variant"] = kind
                row["fma_ms"] = time_ms(torch, lambda: KD.paged_launch(
                    q, *pools, table, counts, "fma", scales=tuple(scales)))
                print(f"      variant {kind}; the FMA kernel (forced): "
                      f"{row['fma_ms']:.4f} ms")

    # ---- vwr_chunk_prefix_attend[_q8]: a prompt chunk vs its prior pages ----
    ck_cases = [
        # label, KV, G, D, page_size, C, counts, dtype, timed, headline
        ("tinyllama chunk 64, 16 pages", 4, 8, 64, 16, 64, (16,) * 16, bf16,
         True, True),
        ("partial tail", 4, 8, 64, 16, 64, (16,) * 5 + (7,), bf16, False,
         False),
        ("masked middle pages", 4, 8, 64, 16, 64, (16, 0, 0, 16, 3), bf16,
         False, False),
        ("first chunk: all masked", 4, 8, 64, 16, 64, (0, 0, 0), bf16, False,
         False),
        ("C=1", 4, 8, 64, 16, 1, (16, 16, 5), bf16, False, False),
        ("qwen chunk 64 (G=1)", 16, 1, 64, 16, 64, (16,) * 16, bf16, True,
         False),
        ("D=32", 2, 4, 32, 16, 8, (16, 9), bf16, False, False),
        ("D=128", 2, 4, 128, 16, 8, (16, 9), bf16, False, False),
        ("fp32", 4, 8, 64, 16, 16, (16, 16, 11), f32, False, False),
        ("page 8", 2, 3, 64, 8, 5, (8, 8, 0, 1), bf16, False, False),
        ("D=16 (reduced, padded)", 1, 4, 16, 8, 8, (8, 8, 5), f32, False,
         False),
        ("D=16 (reduced, padded)", 2, 2, 16, 8, 3, (8, 0, 3), bf16, False,
         False),
    ]
    for q8 in (False, True):
        kname = "vwr_chunk_prefix_attend" + ("_q8" if q8 else "")
        print(kname)
        for (label, KV, G, D, ps, C, counts, dt, timed,
             head) in ck_cases:
            n_pages = 64
            J = len(counts)
            q = randn(KV, C * G, D, dtype=dt)
            shape = (n_pages, ps, KV, D)
            if q8:
                pools = [torch.randint(-127, 128, shape, generator=gen,
                                       device="cuda", dtype=torch.int8)
                         for _ in range(2)]
                scales = [torch.rand((n_pages, KV), generator=gen,
                                     device="cuda") * 0.02 + 1e-3
                          for _ in range(2)]
            else:
                pools = [randn(*shape, dtype=dt) for _ in range(2)]
                scales = []
            # a permuted table whose last entry lies past the pool (the
            # kernel clamps it to the last page, as the plain version)
            table = torch.randperm(n_pages, generator=gen,
                                   device="cuda")[:J].to(torch.int32)
            table[-1] = n_pages + 5
            cnt = torch.tensor(counts, dtype=torch.int32, device="cuda")
            ops_ = (q, *pools, *scales, table, cnt)
            fn = KC.vwr_chunk_prefix_attend_q8 if q8 \
                else KC.vwr_chunk_prefix_attend
            ref = KC.vwr_chunk_prefix_attend_q8_ref if q8 \
                else KC.vwr_chunk_prefix_attend_ref
            shape_s = (f"KV{KV} G{G} D{D} ps{ps} C{C} J{J} "
                       f"keys{sum(counts)}")
            before = dict(build.VARIANTS)
            got = fn(*ops_)
            torch.cuda.synchronize()
            kind = KC.chunk_variant(
                C * G, widths.native_width(D, KC.HEAD_DIMS, kname), ps, dt)
            _served(kname, shape_s, before, build, kind)
            err = compare(kname, shape_s, f32, got, ref(*ops_))
            if kind == "wgmma" and q8:
                compare("  vs emulation", shape_s, f32, got,
                        KC.chunk_wgmma_emulation(q, *pools, table, cnt,
                                                 scales=scales))
            if kind == "wgmma":
                _bitwise(kname, shape_s, got, fn(*ops_))
            if not any(counts) and (got[2].abs().max().item() != 0.0
                                    or got[0].abs().max().item() != 0.0
                                    or got[1].max().item() > -1e29):
                raise AssertionError("a chunk with no valid prior key must "
                                     "give m=-1e30, l=0, o=0")
            if timed:
                # the kernel reads the valid keys of the live pages and
                # both scales of every live (page, head)
                n_keys = sum(counts)
                live = sum(1 for c in counts if c)
                nbytes = (pools[0].element_size() * 2 * n_keys * KV * D
                          + (8 * live * KV if q8 else 0)
                          + q.element_size() * q.numel() + 8 * J
                          + 4 * KV * C * G * (D + 2))
                record(kname, label, shape_s, dt, err,
                       lambda: fn(*ops_), lambda: ref(*ops_),
                       _chunk_sdpa(torch, F, q, pools, scales, table, cnt),
                       4 * KV * C * G * D * n_keys, nbytes, head)
    check_split_variants(torch, F, compare, record)
    check_q8_variants(torch, F, compare, record)
    check_paged_variants(torch, F, compare, record)
    check_mla_kernels(torch, F, gen, compare, record)
    check_mla_decode_variants(torch, F, compare, record)
    check_paged_q8_variants(torch, F, compare, record)
    check_frontend_shapes(torch, F, compare, record)
    check_hybrid_shapes(torch, F, compare, record)
    check_conv_kernels(torch, F, gen, compare, record)
    return results


# kernel 4's split variant at split and tile edges (plans forced through
# ``decode_launch``; None: ``decode_plan``'s), and the long caches
DECODE_EDGES = [
    # label, B, T, KV, G, D, cur_len, pos0, plan, timed
    ("nine splits of a slice", 4, 160, 4, 8, 64, 144, 0, (9, 16), False),
    ("one key past a split", 2, 160, 2, 8, 64, 17, 0, (2, 16), False),
    ("one key past a tile", 2, 160, 2, 8, 64, 65, 0, None, False),
    ("splits of partial tiles", 2, 300, 2, 8, 64, 300, 0, (3, 112), False),
    ("one key", 1, 40, 2, 4, 64, 1, 0, None, False),
    ("no key", 2, 40, 2, 4, 64, 3, 10, None, False),
    ("pos0 > 0, two splits", 2, 300, 2, 8, 64, 290, 7, (2, 144), False),
    ("D=128 G=16, two splits", 1, 200, 1, 16, 128, 200, 0, (2, 112), False),
    ("D=32 G=3, three splits", 3, 100, 2, 3, 32, 90, 0, (3, 32), False),
    ("G=1, three splits", 4, 136, 16, 1, 64, 130, 0, (3, 48), False),
    ("B4 T2048", 4, 2048, 4, 8, 64, 2048, 0, None, True),
    ("B1 T2048", 1, 2048, 4, 8, 64, 2048, 0, None, True),
    ("B4 T2048 cur 1000 pos0 300", 4, 2048, 4, 8, 64, 1000, 300, None,
     False),
]
# kernel 6's wgmma variant: C 1, J 0, partial pages mid-table, pages of
# 8, 24 and 64, D 32 / 128, forced splits, a 2048-token prompt's last
# chunk (124 prior pages of 16, 1,984 keys)
CHUNK_EDGES = [
    # label, KV, G, D, page_size, C, counts, plan, timed
    ("C=1", 4, 8, 64, 16, 1, (16, 16, 5), None, False),
    ("J=0", 4, 8, 64, 16, 64, (), None, False),
    ("partial pages mid-table", 4, 8, 64, 16, 64,
     (16, 9, 16, 16, 0, 16, 3, 16), None, False),
    ("partial pages, forced splits", 4, 8, 64, 16, 64,
     (16, 9, 16, 16, 0, 16, 3, 16), (2, 4), False),
    ("counts 8, 0, 1", 2, 4, 64, 16, 8, (8, 0, 1), None, False),
    ("page 8", 2, 3, 64, 8, 5, (8, 8, 0, 1) + (8,) * 12, None, False),
    ("page 24", 2, 4, 64, 24, 8, (24, 24, 5, 24, 0, 24), None, False),
    ("page 64", 2, 4, 64, 64, 8, (64, 50, 0, 64), None, False),
    ("D=32", 2, 4, 32, 16, 8, (16, 9, 16), None, False),
    ("D=128", 2, 4, 128, 16, 8, (16, 9, 16), None, False),
    ("tinyllama chunk 64, 124 pages", 4, 8, 64, 16, 64, (16,) * 124, None,
     True),
]


def _decode_plans(KD, BKV, n):
    """decode_plan's plan first, then splits of 16 .. 2048 keys (at most
    FIN_SPLITS of them)."""
    own = KD.decode_plan(BKV, n)
    alts = [(-(-n // kps), kps) for kps in
            (16, 32, 48, 64, 128, 256, 512, 1024, 2048)
            if kps <= max(n, 16) + 15 and -(-n // kps) <= 32]
    return [own] + [p for p in dict.fromkeys(alts) if p != own]


def _chunk_plans(KC, KV, CG, J, ps):
    """chunk_plan's plan first, then splits of 4 .. 64 pages (at most
    FIN_SPLITS of them)."""
    own = KC.chunk_plan(KV, CG, J, ps)
    alts = [(-(-J // jps), jps) for jps in (4, 8, 12, 16, 28, 64)
            if jps <= max(J, 4) and -(-J // jps) <= 32]
    return [own] + [p for p in dict.fromkeys(alts) if p != own]


def check_split_variants(torch, F, compare, record):
    """Kernel 4's split variant and kernel 6's wgmma variant at their split
    and tile edges (the variant counted, within the fp32 limit of the plain
    version and of the emulation of their arithmetic, bitwise over two
    launches), the long shapes timed beside their bounds, the plan tables
    and the host's enqueue of a kernel-4 call.  A generator of its own, so
    the cases before and after draw the inputs they drew before."""
    from repro_torch.kernels import build
    from repro_torch.kernels import vwr_chunk as KC
    from repro_torch.kernels import vwr_decode as KD

    gen = torch.Generator(device="cuda").manual_seed(20)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    print("vwr_flash_decode split edges")
    for (label, B, T, KV, G, D, cur, pos0, plan,
         timed) in DECODE_EDGES:
        q, k, v = randn(B * KV, G, D), randn(B, T, KV, D), randn(B, T, KV, D)
        n = max(0, min(T, cur - pos0))
        shape = (f"B{B} T{T} KV{KV} G{G} D{D} cur{cur} pos0{pos0} plan "
                 f"{plan or KD.decode_plan(B * KV, n)}")

        def run(q=q, k=k, v=v, cur=cur, pos0=pos0, n=n, plan=plan):
            if plan is None:
                return KD.vwr_flash_decode(q, k, v, cur, pos0)
            return KD.decode_launch(q, k, v, n, "split", plan)
        before = dict(build.VARIANTS)
        got = run()
        torch.cuda.synchronize()
        _served("vwr_flash_decode", shape, before, build, "split")
        err = compare("vwr_flash_decode", shape, f32, got,
                      KD.vwr_flash_decode_ref(q, k, v, cur, pos0))
        compare("  vs emulation", shape, f32, got,
                KD.decode_split_emulation(q, k, v, cur, pos0, plan=plan))
        _bitwise("vwr_flash_decode", shape, got, run())
        if n == 0 and (got[2].abs().max().item() != 0.0
                       or got[1].max().item() > -1e29):
            raise AssertionError("a group with no valid key must give "
                                 "m=-1e30, l=0")
        if timed:
            qs = q.reshape(B, KV * G, 1, D)
            ks, vs = (x[:, :n].transpose(1, 2).repeat_interleave(G, 1)
                      for x in (k, v))
            record("vwr_flash_decode", label, shape, bf16, err, run,
                   lambda q=q, k=k, v=v, cur=cur, pos0=pos0:
                   KD.vwr_flash_decode_ref(q, k, v, cur, pos0),
                   lambda qs=qs, ks=ks, vs=vs:
                   F.scaled_dot_product_attention(qs, ks, vs),
                   4 * B * KV * G * D * n,
                   2 * (B * KV * G * D + 2 * B * n * KV * D)
                   + 4 * B * KV * G * (D + 2))

    print("  vwr_flash_decode plans (ms; (splits, keys a split)), the FMA "
          "kernel, SDPA:")
    for label, B, T, KV, G, cur in (("tinyllama decode", 4, 160, 4, 8, 144),
                                    ("qwen decode (G=1)", 4, 136, 16, 1,
                                     130),
                                    ("tinyllama long", 4, 2048, 4, 8, 2048),
                                    ("tinyllama batch 1 long", 1, 2048, 4,
                                     8, 2048)):
        D = 64
        q, k, v = randn(B * KV, G, D), randn(B, T, KV, D), randn(B, T, KV, D)
        n = min(T, cur)
        row = {"kernel": "vwr_flash_decode plans", "case": label,
               "shape": f"B{B} T{T} KV{KV} G{G} D{D} cur{cur}",
               "plans": []}
        for plan in _decode_plans(KD, B * KV, n):
            ms = time_ms(torch, lambda: KD.decode_launch(q, k, v, n, "split",
                                                         plan))
            row["plans"].append({"plan": plan, "ms": ms})
        row["fma_ms"] = time_ms(torch, lambda: KD.decode_launch(q, k, v, n,
                                                                "fma"))
        qs = q.reshape(B, KV * G, 1, D)
        ks, vs = (x[:, :n].transpose(1, 2).repeat_interleave(G, 1)
                  for x in (k, v))
        row["library_ms"] = time_ms(
            torch, lambda: F.scaled_dot_product_attention(qs, ks, vs))
        record.rows.append(row)
        print(f"    {label} {row['shape']}: " + ", ".join(
            f"{p['plan']} {p['ms']:.4f}" for p in row["plans"])
            + f"; fma {row['fma_ms']:.4f}; SDPA {row['library_ms']:.4f}")
    _decode_enqueue(torch, F, KD, build, randn, record)

    print("vwr_chunk_prefix_attend wgmma edges")
    n_pages = 160
    for (label, KV, G, D, ps, C, counts, plan, timed) in CHUNK_EDGES:
        J = len(counts)
        q = randn(KV, C * G, D)
        pools = [randn(n_pages, ps, KV, D) for _ in range(2)]
        table = torch.randperm(n_pages, generator=gen,
                               device="cuda")[:J].to(torch.int32)
        if J:
            table[-1] = n_pages + 5
        cnt = torch.tensor(counts, dtype=torch.int32, device="cuda")
        ops_ = (q, *pools, table, cnt)
        shape = (f"KV{KV} G{G} D{D} ps{ps} C{C} J{J} keys{sum(counts)} plan "
                 f"{plan or KC.chunk_plan(KV, C * G, J, ps)}")

        def run(ops_=ops_, plan=plan):
            if plan is None:
                return KC.vwr_chunk_prefix_attend(*ops_)
            return KC.chunk_launch(*ops_, "wgmma", plan)
        before = dict(build.VARIANTS)
        got = run()
        torch.cuda.synchronize()
        _served("vwr_chunk_prefix_attend", shape, before, build, "wgmma")
        err = compare("vwr_chunk_prefix_attend", shape, f32, got,
                      KC.vwr_chunk_prefix_attend_ref(*ops_))
        compare("  vs emulation", shape, f32, got,
                KC.chunk_wgmma_emulation(*ops_, plan=plan))
        _bitwise("vwr_chunk_prefix_attend", shape, got, run())
        if not any(counts) and (got[2].abs().max().item() != 0.0
                                or got[0].abs().max().item() != 0.0
                                or got[1].max().item() > -1e29):
            raise AssertionError("a chunk with no valid prior key must "
                                 "give m=-1e30, l=0, o=0")
        if timed:
            n_keys = sum(counts)
            record("vwr_chunk_prefix_attend", label, shape, bf16, err, run,
                   lambda ops_=ops_: KC.vwr_chunk_prefix_attend_ref(*ops_),
                   _chunk_sdpa(torch, F, q, pools, [], table, cnt),
                   4 * KV * C * G * D * n_keys,
                   2 * (2 * n_keys * KV * D + q.numel()) + 8 * J
                   + 4 * KV * C * G * (D + 2))

    print("  vwr_chunk_prefix_attend plans (ms; (splits, pages a split)), "
          "the FMA kernel:")
    for label, KV, G, C, J in (("tinyllama chunk 64, 16 pages", 4, 8, 64, 16),
                               ("124 pages", 4, 8, 64, 124),
                               ("C=1, 16 pages", 4, 8, 1, 16),
                               ("qwen chunk 64 (G=1)", 16, 1, 64, 16)):
        D, ps = 64, 16
        q = randn(KV, C * G, D)
        pools = [randn(n_pages, ps, KV, D) for _ in range(2)]
        table = torch.randperm(n_pages, generator=gen,
                               device="cuda")[:J].to(torch.int32)
        cnt = torch.full((J,), ps, dtype=torch.int32, device="cuda")
        ops_ = (q, *pools, table, cnt)
        row = {"kernel": "vwr_chunk_prefix_attend plans", "case": label,
               "shape": f"KV{KV} G{G} D{D} C{C} J{J} of {ps}",
               "plans": []}
        for plan in _chunk_plans(KC, KV, C * G, J, ps):
            ms = time_ms(torch, lambda: KC.chunk_launch(*ops_, "wgmma",
                                                        plan))
            row["plans"].append({"plan": plan, "ms": ms})
        row["fma_ms"] = time_ms(torch, lambda: KC.chunk_launch(*ops_,
                                                               "fma"))
        row["rule"] = KC.chunk_variant(C * G, D, ps, bf16)
        record.rows.append(row)
        print(f"    {label} {row['shape']}: " + ", ".join(
            f"{p['plan']} {p['ms']:.4f}" for p in row["plans"])
            + f"; fma {row['fma_ms']:.4f} (rule: {row['rule']})")


def _decode_q8_sdpa(F, q, k, v, ks, vs, n):
    """The library yardstick of kernel 9: dequantize the n valid rows of
    the int8 cache to q's dtype with the (B*KV,) scales, then SDPA (GQA)
    with the G heads of a KV head as its query rows."""
    BKV, G, D = q.shape
    B, T, KV, _ = k.shape
    qs, dt = q.reshape(B, KV * G, 1, D), q.dtype

    def run():
        kd, vd = [(x[:, :n].to(dt) * s.reshape(B, 1, KV, 1).to(dt)
                   ).transpose(1, 2) for x, s in ((k, ks), (v, vs))]
        return F.scaled_dot_product_attention(qs, kd, vd, enable_gqa=True)
    return run


def check_q8_variants(torch, F, compare, record):
    """Kernel 9's split variant and kernel 8's wgmma variant (kernels 4
    and 6's over int8) at kernels 4 and 6's split and tile edges (the
    variant counted, within the fp32 limit of the plain version and of the
    emulation, bitwise over two launches), the long shapes timed beside
    their bounds, and the plan tables beside the parent's FMA kernel
    (forced through ``kind``) and the library call.  A generator of its
    own (seed 24), so the other cases keep their inputs."""
    from repro_torch.kernels import build
    from repro_torch.kernels import vwr_chunk as KC
    from repro_torch.kernels import vwr_decode as KD

    gen = torch.Generator(device="cuda").manual_seed(24)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def scales(*shape):
        return tuple(torch.rand(shape, generator=gen, device="cuda") * 0.02
                     + 1e-3 for _ in range(2))

    def cache(B, T, KV, G, D):
        return (randn(B * KV, G, D), int8(B, T, KV, D), int8(B, T, KV, D),
                scales(B * KV))

    kname = "vwr_flash_decode_q8"
    print(f"{kname} split edges")
    for (label, B, T, KV, G, D, cur, pos0, plan,
         timed) in DECODE_EDGES:
        q, k, v, sc = cache(B, T, KV, G, D)
        n = max(0, min(T, cur - pos0))
        shape = (f"B{B} T{T} KV{KV} G{G} D{D} cur{cur} pos0{pos0} plan "
                 f"{plan or KD.decode_plan(B * KV, n)}")

        def run(q=q, k=k, v=v, sc=sc, cur=cur, pos0=pos0, n=n, plan=plan):
            if plan is None:
                return KD.vwr_flash_decode_q8(q, k, v, *sc, cur, pos0)
            return KD.decode_launch(q, k, v, n, "split", plan, scales=sc)
        before = dict(build.VARIANTS)
        got = run()
        torch.cuda.synchronize()
        _served(kname, shape, before, build, "split")
        err = compare(kname, shape, f32, got,
                      KD.vwr_flash_decode_q8_ref(q, k, v, *sc, cur, pos0))
        compare("  vs emulation", shape, f32, got,
                KD.decode_split_emulation(q, k, v, cur, pos0, plan=plan,
                                          scales=sc))
        _bitwise(kname, shape, got, run())
        if n == 0 and (got[2].abs().max().item() != 0.0
                       or got[1].max().item() > -1e29):
            raise AssertionError("a group with no valid key must give "
                                 "m=-1e30, l=0")
        if timed:
            record(kname, label, shape, bf16, err, run,
                   lambda q=q, k=k, v=v, sc=sc, cur=cur, pos0=pos0:
                   KD.vwr_flash_decode_q8_ref(q, k, v, *sc, cur, pos0),
                   _decode_q8_sdpa(F, q, k, v, *sc, n),
                   4 * B * KV * G * D * n,
                   2 * B * KV * G * D + 2 * B * n * KV * D + 8 * B * KV
                   + 4 * B * KV * G * (D + 2))

    print(f"  {kname} plans (ms; (splits, keys a split)), the FMA kernel, "
          "SDPA:")
    for label, B, T, KV, G, cur in (("tinyllama decode", 4, 160, 4, 8, 144),
                                    ("qwen decode (G=1)", 4, 136, 16, 1,
                                     130),
                                    ("tinyllama long", 4, 2048, 4, 8, 2048),
                                    ("tinyllama batch 1 long", 1, 2048, 4,
                                     8, 2048)):
        D = 64
        q, k, v, sc = cache(B, T, KV, G, D)
        n = min(T, cur)
        row = {"kernel": f"{kname} plans", "case": label,
               "shape": f"B{B} T{T} KV{KV} G{G} D{D} cur{cur}",
               "plans": []}
        for plan in _decode_plans(KD, B * KV, n):
            ms = time_ms(torch, lambda: KD.decode_launch(
                q, k, v, n, "split", plan, scales=sc))
            row["plans"].append({"plan": plan, "ms": ms})
        row["fma_ms"] = time_ms(torch, lambda: KD.decode_launch(
            q, k, v, n, "fma", scales=sc))
        row["library_ms"] = time_ms(torch, _decode_q8_sdpa(F, q, k, v, *sc,
                                                           n))
        row["rule"] = KD.decode_variant(bf16, D, G)
        record.rows.append(row)
        print(f"    {label} {row['shape']}: " + ", ".join(
            f"{p['plan']} {p['ms']:.4f}" for p in row["plans"])
            + f"; fma {row['fma_ms']:.4f}; SDPA {row['library_ms']:.4f} "
            f"(rule: {row['rule']})")

    kname = "vwr_chunk_prefix_attend_q8"
    print(f"{kname} wgmma edges")
    n_pages = 160
    for (label, KV, G, D, ps, C, counts, plan, timed) in CHUNK_EDGES:
        J = len(counts)
        q = randn(KV, C * G, D)
        pools = [int8(n_pages, ps, KV, D) for _ in range(2)]
        sc = scales(n_pages, KV)
        table = torch.randperm(n_pages, generator=gen,
                               device="cuda")[:J].to(torch.int32)
        if J:
            table[-1] = n_pages + 5
        cnt = torch.tensor(counts, dtype=torch.int32, device="cuda")
        ops_ = (q, *pools, *sc, table, cnt)
        shape = (f"KV{KV} G{G} D{D} ps{ps} C{C} J{J} keys{sum(counts)} plan "
                 f"{plan or KC.chunk_plan(KV, C * G, J, ps)}")

        def run(ops_=ops_, pools=pools, sc=sc, table=table, cnt=cnt,
                plan=plan):
            if plan is None:
                return KC.vwr_chunk_prefix_attend_q8(*ops_)
            return KC.chunk_launch(ops_[0], *pools, table, cnt, "wgmma",
                                   plan, scales=sc)
        before = dict(build.VARIANTS)
        got = run()
        torch.cuda.synchronize()
        _served(kname, shape, before, build, "wgmma")
        err = compare(kname, shape, f32, got,
                      KC.vwr_chunk_prefix_attend_q8_ref(*ops_))
        compare("  vs emulation", shape, f32, got,
                KC.chunk_wgmma_emulation(q, *pools, table, cnt, plan=plan,
                                         scales=sc))
        _bitwise(kname, shape, got, run())
        if not any(counts) and (got[2].abs().max().item() != 0.0
                                or got[0].abs().max().item() != 0.0
                                or got[1].max().item() > -1e29):
            raise AssertionError("a chunk with no valid prior key must "
                                 "give m=-1e30, l=0, o=0")
        if timed:
            n_keys = sum(counts)
            live = sum(1 for c in counts if c)
            record(kname, label, shape, bf16, err, run,
                   lambda ops_=ops_: KC.vwr_chunk_prefix_attend_q8_ref(
                       *ops_),
                   _chunk_sdpa(torch, F, q, pools, sc, table, cnt),
                   4 * KV * C * G * D * n_keys,
                   2 * n_keys * KV * D + 8 * live * KV + 2 * q.numel()
                   + 8 * J + 4 * KV * C * G * (D + 2))

    print(f"  {kname} plans (ms; (splits, pages a split)), the FMA kernel, "
          "SDPA:")
    for label, KV, G, C, J in (("tinyllama chunk 64, 16 pages", 4, 8, 64, 16),
                               ("124 pages", 4, 8, 64, 124),
                               ("C=1, 16 pages", 4, 8, 1, 16),
                               ("qwen chunk 64 (G=1)", 16, 1, 64, 16)):
        D, ps = 64, 16
        q = randn(KV, C * G, D)
        pools = [int8(n_pages, ps, KV, D) for _ in range(2)]
        sc = scales(n_pages, KV)
        table = torch.randperm(n_pages, generator=gen,
                               device="cuda")[:J].to(torch.int32)
        cnt = torch.full((J,), ps, dtype=torch.int32, device="cuda")
        row = {"kernel": f"{kname} plans", "case": label,
               "shape": f"KV{KV} G{G} D{D} C{C} J{J} of {ps}",
               "plans": []}
        for plan in _chunk_plans(KC, KV, C * G, J, ps):
            ms = time_ms(torch, lambda: KC.chunk_launch(
                q, *pools, table, cnt, "wgmma", plan, scales=sc))
            row["plans"].append({"plan": plan, "ms": ms})
        row["fma_ms"] = time_ms(torch, lambda: KC.chunk_launch(
            q, *pools, table, cnt, "fma", scales=sc))
        row["library_ms"] = time_ms(
            torch, _chunk_sdpa(torch, F, q, pools, sc, table, cnt))
        row["rule"] = KC.chunk_variant(C * G, D, ps, bf16)
        record.rows.append(row)
        print(f"    {label} {row['shape']}: " + ", ".join(
            f"{p['plan']} {p['ms']:.4f}" for p in row["plans"])
            + f"; fma {row['fma_ms']:.4f}; SDPA {row['library_ms']:.4f} "
            f"(rule: {row['rule']})")


TWO_STREAM_ROUNDS = 16


def check_two_streams(torch):
    """The split buffers belong to one stream: launches of the kernels
    that merge splits through them (kernel 4's split variant at B4 T2048,
    8 splits a group; kernel 1's split-K at a decode shape; kernel 5's
    mma variant on a 128-entry table, 8 splits a group; kernel 11's wgmma
    variant on a 128-entry table at DeepSeek-V3's widths; kernel 9's split
    variant at B4 T2048 over an int8 cache; kernel 8's wgmma variant on
    124 int8 pages, 16 splits a row group; kernels 7 and 13 on the
    128-entry table over int8 pages; kernel 14's wgmma variant at B1
    T2048 over an int8 slab, 16 splits) issued in turns
    on two streams with no synchronisation between them, and each
    stream's outputs held bitwise to the same launches on one stream.
    With one buffer a device the two streams' blocks would count on the
    same counters and overwrite each other's partials."""
    from repro_torch.kernels import build
    from repro_torch.kernels import vwr_chunk as KC
    from repro_torch.kernels import vwr_decode as KD
    from repro_torch.kernels import vwr_matmul as KM
    from repro_torch.kernels import vwr_mla_decode as KMLA

    gen = torch.Generator(device="cuda").manual_seed(22)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(bf16)

    B, T, KV, G, D = 4, 2048, 4, 8, 64
    qd, kd, vd = randn(B * KV, G, D), randn(B, T, KV, D), randn(B, T, KV, D)
    xm, wm = randn(4, 5632), randn(5632, 2048, scale=0.02)
    qp = randn(8 * KV, G, D)
    pools = [randn(1200, 16, KV, D) for _ in range(2)]
    table, counts, _ = _paged_table(torch, gen, LONG_LENS, 128, 16, 1200)
    qm = [torch.randn(8, 128, w, generator=gen, device="cuda")
          for w in (512, 64)]
    mla_pools = [randn(1200, 16, w) for w in (512, 64)]
    k8, v8 = (torch.randint(-127, 128, (B, T, KV, D), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    dsc = tuple(torch.rand(B * KV, generator=gen, device="cuda") * 0.02
                + 1e-3 for _ in range(2))
    qc = randn(KV, 64 * G, D)
    cpools = [torch.randint(-127, 128, (160, 16, KV, D), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(2)]
    csc = tuple(torch.rand((160, KV), generator=gen, device="cuda") * 0.02
                + 1e-3 for _ in range(2))
    ctable = torch.randperm(160, generator=gen,
                            device="cuda")[:124].to(torch.int32)
    ccounts = torch.full((124,), 16, dtype=torch.int32, device="cuda")
    i8 = dict(generator=gen, device="cuda", dtype=torch.int8)
    pools8 = [torch.randint(-127, 128, (1200, 16, KV, D), **i8)
              for _ in range(2)]
    psc = tuple(torch.rand((1200, KV), generator=gen, device="cuda") * 0.02
                + 1e-3 for _ in range(2))
    mla_pools8 = [torch.randint(-127, 128, (1200, 16, w), **i8)
                  for w in (512, 64)]
    msc = tuple(torch.rand(1200, generator=gen, device="cuda") * 0.02 + 1e-3
                for _ in range(2))
    q1 = [torch.randn(1, 128, w, generator=gen, device="cuda")
          for w in (512, 64)]
    slab8 = [torch.randint(-127, 128, (1, 2048, w), **i8) for w in (512, 64)]
    ssc = tuple(torch.rand(1, generator=gen, device="cuda") * 0.02 + 1e-3
                for _ in range(2))
    calls = {
        "vwr_flash_decode split (8, 256)":
            (lambda: KD.vwr_flash_decode(qd, kd, vd, T),
             "vwr_flash_decode", "split"),
        "vwr_matmul splitk 4x5632x2048":
            (lambda: KM.vwr_matmul(xm, wm), "vwr_matmul", "splitk"),
        "vwr_paged_flash_decode mma J 128":
            (lambda: KD.vwr_paged_flash_decode(qp, *pools, table, counts),
             "vwr_paged_flash_decode", "mma"),
        "vwr_mla_paged_flash_decode wgmma J 128":
            (lambda: KMLA.vwr_mla_paged_flash_decode(
                *qm, *mla_pools, table, counts, scale=192 ** -0.5),
             "vwr_mla_paged_flash_decode", "wgmma"),
        "vwr_flash_decode_q8 split (8, 256)":
            (lambda: KD.vwr_flash_decode_q8(qd, k8, v8, *dsc, T),
             "vwr_flash_decode_q8", "split"),
        "vwr_chunk_prefix_attend_q8 wgmma 124 pages":
            (lambda: KC.vwr_chunk_prefix_attend_q8(qc, *cpools, *csc, ctable,
                                                   ccounts),
             "vwr_chunk_prefix_attend_q8", "wgmma"),
        "vwr_paged_flash_decode_q8 mma J 128":
            (lambda: KD.vwr_paged_flash_decode_q8(qp, *pools8, *psc, table,
                                                  counts),
             "vwr_paged_flash_decode_q8", "mma"),
        "vwr_mla_paged_flash_decode_q8 wgmma J 128":
            (lambda: KMLA.vwr_mla_paged_flash_decode_q8(
                *qm, *mla_pools8, *msc, table, counts, scale=192 ** -0.5),
             "vwr_mla_paged_flash_decode_q8", "wgmma"),
        "vwr_mla_flash_decode_q8 wgmma B1 T2048":
            (lambda: KMLA.vwr_mla_flash_decode_q8(
                *q1, *slab8, *ssc, 2048, scale=192 ** -0.5),
             "vwr_mla_flash_decode_q8", "wgmma"),
    }
    if (KD.decode_plan(B * KV, T)[0] < 2
            or KD.paged_plan(8 * KV, 128, 16)[0] < 2
            or KMLA.mla_decode_plan(8, 128, 128, 16)[0] < 2
            or KMLA.mla_decode_plan(1, 128, 2048)[0] < 2
            or KC.chunk_plan(KV, 64 * G, 124, 16)[0] < 2):
        raise AssertionError("the two-stream cases must split")
    print("two streams: split buffers per stream")
    one = {}
    for name, (fn, kernel, variant) in calls.items():
        before = dict(build.VARIANTS)
        one[name] = fn()
        torch.cuda.synchronize()
        _served(kernel, name, before, build, variant)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(TWO_STREAM_ROUNDS):
        for name, (fn, _, _) in calls.items():
            for i, st in enumerate(streams):
                with torch.cuda.stream(st):
                    got.append((name, i, fn()))
    torch.cuda.synchronize()
    handles = {st.cuda_stream for st in streams}
    keyed = {k[1] for k in build._SPLIT_COUNTERS if k[1] in handles}
    if keyed != handles:
        raise AssertionError("the two streams did not get counter buffers "
                             "of their own")
    differ = {}
    for name, i, out in got:
        out = out if isinstance(out, tuple) else (out,)
        ref = one[name] if isinstance(one[name], tuple) else (one[name],)
        if not all(a.equal(b) for a, b in zip(out, ref)):
            differ[name, i] = differ.get((name, i), 0) + 1
    print(f"  {len(got)} launches on 2 streams, {TWO_STREAM_ROUNDS} rounds "
          f"of {', '.join(calls)}: {sum(differ.values())} differ from one "
          "stream")
    if differ:
        raise AssertionError(f"two streams: outputs differ from one stream "
                             f"{differ}")
    return {"launches": len(got), "rounds": TWO_STREAM_ROUNDS,
            "kernels": list(calls), "differ": 0}


# kernel 5's mma variant at split and tile edges (plans forced through
# ``paged_launch``; None: ``paged_plan``'s), and the long table: counts
# and table entries overridden at (slot, entry) after ``_paged_table``
PAGED_LENS = (0, 1, 16, 17, 255, 100, 200, 64)
LONG_LENS = (2048, 1900, 1500, 1024, 777, 2000, 100, 1)
PAGED_EDGES = [
    # label, B, KV, G, D, page_size, n_pages, J, lens, counts set,
    # table set, plan, timed
    ("partial and count-0 pages mid-table", 4, 4, 8, 64, 16, 256, 16,
     (255, 200, 130, 64), {(0, 2): 5, (1, 7): 0, (2, 3): 9}, {}, None,
     False),
    ("a slot whose pages are all masked", 3, 4, 8, 64, 16, 128, 16,
     (200, 0, 90), {(2, j): 0 for j in range(6)}, {}, None, False),
    ("entries past the pool", 2, 4, 8, 64, 16, 64, 16, (255, 100), {},
     {(0, 0): 71, (1, 3): -3}, None, False),
    ("page 8", 3, 2, 4, 64, 8, 128, 12, (1, 40, 96), {(1, 2): 0}, {},
     None, False),
    ("page 4", 2, 2, 8, 64, 4, 160, 40, (160, 37), {(0, 5): 1}, {}, None,
     False),
    ("J 18", 8, 4, 8, 64, 16, 1024, 18, (288, 1, 17, 3, 100, 0, 250, 64),
     {}, {}, None, False),
    ("one block a group", 8, 4, 8, 64, 16, 1024, 16, PAGED_LENS, {}, {},
     (1, 16), False),
    ("splits of one entry", 2, 4, 8, 64, 16, 64, 16, (255, 130),
     {(0, 4): 3}, {}, (16, 1), False),
    ("uneven splits", 2, 4, 8, 64, 16, 64, 18, (288, 130), {}, {}, (5, 4),
     False),
    ("G 1", 8, 16, 1, 64, 16, 1024, 16, PAGED_LENS, {}, {}, None, False),
    ("G 3, D 32", 3, 2, 3, 32, 16, 64, 6, (5, 0, 90), {}, {}, None, False),
    ("G 16, D 128, two splits", 2, 1, 16, 128, 16, 64, 5, (33, 64), {}, {},
     (2, 3), False),
    ("long table: 8 slots, J 128", 8, 4, 8, 64, 16, 1200, 128, LONG_LENS,
     {}, {}, None, True),
]


def _paged_plans(KD, BKV, J):
    """paged_plan's plan first, then 1, 2, 3, 4, 6, 8, 16 or 32 even
    splits of the table."""
    own = KD.paged_plan(BKV, J, 16)
    alts = [(-(-J // -(-J // n)), -(-J // n)) for n in
            (1, 2, 3, 4, 6, 8, 16, 32) if n <= J]
    return [own] + [p for p in dict.fromkeys(alts) if p != own]


def check_paged_variants(torch, F, compare, record):
    """Kernel 5's mma variant at its split and tile edges (the variant
    counted, within the fp32 limit of the plain version and of the
    emulation of its arithmetic, bitwise over two launches, a slot
    without a valid key giving m = -1e30, l = 0, o = 0), the long table
    timed beside its bound, the plan table and the host's enqueue of a
    call.  A generator of its own, so the cases before and after draw the
    inputs they drew before."""
    from repro_torch.kernels import build
    from repro_torch.kernels import vwr_decode as KD

    gen = torch.Generator(device="cuda").manual_seed(21)
    bf16, f32 = torch.bfloat16, torch.float32

    def operands(B, KV, G, D, ps, n_pages, J, lens, counts_set=None,
                 table_set=None):
        q = torch.randn(B * KV, G, D, generator=gen, device="cuda").to(bf16)
        pools = [torch.randn(n_pages, ps, KV, D, generator=gen,
                             device="cuda").to(bf16) for _ in range(2)]
        table, counts, live = _paged_table(torch, gen, lens, J, ps, n_pages)
        for (b, j), c in (counts_set or {}).items():
            counts[b, j] = c
        for (b, j), t in (table_set or {}).items():
            table[b, j] = t
        return (q, *pools, table, counts), live

    print("vwr_paged_flash_decode mma edges")
    for (label, B, KV, G, D, ps, n_pages, J, lens, cset, tset, plan,
         timed) in PAGED_EDGES:
        ops_, live = operands(B, KV, G, D, ps, n_pages, J, lens, cset, tset)
        shape = (f"B{B} KV{KV} G{G} D{D} ps{ps} J{J} keys "
                 f"{int(ops_[4].sum())} plan "
                 f"{plan or KD.paged_plan(B * KV, J, ps)}")

        def run(ops_=ops_, plan=plan):
            if plan is None:
                return KD.vwr_paged_flash_decode(*ops_)
            return KD.paged_launch(*ops_, "mma", plan)
        before = dict(build.VARIANTS)
        got = run()
        torch.cuda.synchronize()
        _served("vwr_paged_flash_decode", shape, before, build, "mma")
        err = compare("vwr_paged_flash_decode", shape, f32, got,
                      KD.vwr_paged_flash_decode_ref(*ops_))
        compare("  vs emulation", shape, f32, got,
                KD.paged_mma_emulation(*ops_, plan=plan))
        _bitwise("vwr_paged_flash_decode", shape, got, run())
        empty = (ops_[4].sum(1) == 0).repeat_interleave(KV)
        if empty.any() and (got[2][empty].abs().max().item() != 0.0
                            or got[0][empty].abs().max().item() != 0.0
                            or got[1][empty].max().item() > -1e29):
            raise AssertionError("a slot with no valid key must give "
                                 "m=-1e30, l=0, o=0")
        if timed:
            n_keys = int(ops_[4].sum())
            q = ops_[0]
            record("vwr_paged_flash_decode", label, shape, bf16, err, run,
                   lambda ops_=ops_: KD.vwr_paged_flash_decode_ref(*ops_),
                   _paged_sdpa(torch, F, q, ops_[1:3], [], ops_[3], ops_[4],
                               KV, G, D),
                   4 * KV * G * D * n_keys,
                   2 * (2 * n_keys * KV * D + q.numel()) + 8 * B * J
                   + 4 * B * KV * G * (D + 2))

    print("  vwr_paged_flash_decode plans (ms; (splits, table entries a "
          "split)), the FMA kernel, SDPA:")
    for label, KV, G, J, lens in (
            ("tinyllama 8 slots, J 16", 4, 8, 16, PAGED_LENS),
            ("qwen 8 slots (G 1), J 16", 16, 1, 16, PAGED_LENS),
            ("tinyllama 8 slots, J 18", 4, 8, 18,
             (288, 1, 17, 3, 100, 0, 250, 64)),
            ("tinyllama 8 slots, J 128", 4, 8, 128, LONG_LENS)):
        B, D, ps = 8, 64, 16
        ops_, _ = operands(B, KV, G, D, ps, 1200, J, lens)
        row = {"kernel": "vwr_paged_flash_decode plans", "case": label,
               "shape": f"B{B} KV{KV} G{G} D{D} J{J} of {ps}, keys "
                        f"{sum(lens)}", "plans": []}
        for plan in _paged_plans(KD, B * KV, J):
            ms = time_ms(torch, lambda: KD.paged_launch(*ops_, "mma", plan))
            row["plans"].append({"plan": plan, "ms": ms})
        row["fma_ms"] = time_ms(torch, lambda: KD.paged_launch(*ops_,
                                                               "fma"))
        row["library_ms"] = time_ms(torch, _paged_sdpa(
            torch, F, ops_[0], ops_[1:3], [], ops_[3], ops_[4], KV, G, D))
        record.rows.append(row)
        print(f"    {label} {row['shape']}: " + ", ".join(
            f"{p['plan']} {p['ms']:.4f}" for p in row["plans"])
            + f"; fma {row['fma_ms']:.4f}; SDPA {row['library_ms']:.4f}")

    # the host's enqueue of a kernel-5 call at the headline
    ops_, _ = operands(8, 4, 8, 64, 16, 1024, 16, PAGED_LENS)
    calls = {
        "fma": lambda: KD.paged_launch(*ops_, "fma"),
        "mma": lambda: KD.paged_launch(*ops_, "mma"),
        "vwr_paged_flash_decode": lambda: KD.vwr_paged_flash_decode(*ops_),
        "SDPA": _paged_sdpa(torch, F, ops_[0], ops_[1:3], [], ops_[3],
                            ops_[4], 4, 8, 64),
    }
    row = {"kernel": "vwr_paged_flash_decode enqueue",
           "shape": "B8 KV4 G8 D64 J16 of 16",
           **{name: [] for name in calls}}
    for _ in range(3):
        for name, fn in calls.items():
            row[name].append(_enqueue_us(torch, fn))
    record.rows.append(row)
    print("  vwr_paged_flash_decode host enqueue (us a call; enqueue, and "
          "with the device): the FMA and mma launches, the whole wrapper "
          "(widths, checks, rule, plan, split buffers, mma launch), SDPA")
    for name in calls:
        print(f"    {name}: " + ", ".join(f"{a:.2f} / {b:.2f}"
                                          for a, b in row[name]))


def _parent_decode(torch, KD, build, q, k, v, cur_len, pos0=0):
    """The wrapper kernel 4 had before its split variant (the FMA kernel
    on every cache), line for line: the widths, the operand checks, the
    outputs, the launch, the count."""
    import ctypes

    from repro_torch.kernels import widths

    kernel = "vwr_flash_decode"
    _VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def dense_kernel(q, k, v):
        BKV, G, D = q.shape
        B, T, KV, _ = k.shape
        if BKV != B * KV:
            raise ValueError(f"{kernel}: needs q (B*KV, G, D)")
        code = build.dtype_code(q.dtype)
        build.check_operands(kernel, q.dtype, q=(q, (BKV, G, D)))
        build.check_operands(kernel, q.dtype, k=(k, (B, T, KV, D)),
                             v=(v, (B, T, KV, D)))
        n_keys = max(0, min(T, int(cur_len) - int(pos0)))
        f32 = dict(dtype=torch.float32, device=q.device)
        o_t = torch.empty((BKV, G, D), **f32)
        m = torch.empty((BKV, G), **f32)
        l = torch.empty((BKV, G), **f32)
        ptrs = [q, k, v, o_t, m, l]
        lib, fn = build.kernel_fn("vwr_decode", f"{kernel}_launch",
                                  [_VP] * len(ptrs) + [_I] * 6
                                  + [_F, _I, _VP])
        err = fn(*(t.data_ptr() for t in ptrs), B, T, KV, G, D, n_keys,
                 scale, code, build.stream_of(q))
        build.check(lib, err, kernel)
        build.count_launch(kernel)
        return o_t, m, l

    scale = 1.0 / q.shape[-1] ** 0.5
    return widths.at_widths(dense_kernel, [((q, k, v), KD.HEAD_DIMS)],
                            kernel, max_group=KD.MAX_GROUP)


def _decode_enqueue(torch, F, KD, build, randn, record):
    """The host's time to enqueue one kernel-4 call at tinyllama's decode
    shape (B4 T160 cur 144 KV4 G8 D64): the FMA kernel and the split
    variant through ``decode_launch``, the parent's wrapper (width
    handling, operand checks, the FMA launch: ``_parent_decode``), the
    whole wrapper (``vwr_flash_decode``: the same with the rule, the
    plan, the workspace and the split launch) and SDPA, in three
    rounds."""
    B, T, KV, G, D, cur = 4, 160, 4, 8, 64, 144
    q, k, v = randn(B * KV, G, D), randn(B, T, KV, D), randn(B, T, KV, D)
    qs = q.reshape(B, KV * G, 1, D)
    ks, vs = (x[:, :cur].transpose(1, 2).repeat_interleave(G, 1)
              for x in (k, v))
    calls = {
        "fma": lambda: KD.decode_launch(q, k, v, cur, "fma"),
        "split": lambda: KD.decode_launch(q, k, v, cur, "split"),
        "parent's wrapper (checks + fma)": lambda: _parent_decode(
            torch, KD, build, q, k, v, cur),
        "vwr_flash_decode": lambda: KD.vwr_flash_decode(q, k, v, cur),
        "SDPA": lambda: F.scaled_dot_product_attention(qs, ks, vs),
    }
    row = {"kernel": "vwr_flash_decode enqueue",
           "shape": f"B{B} T{T} KV{KV} G{G} D{D} cur{cur}",
           **{name: [] for name in calls}}
    for _ in range(3):
        for name, fn in calls.items():
            row[name].append(_enqueue_us(torch, fn))
    record.rows.append(row)
    print("  vwr_flash_decode host enqueue (us a call; enqueue, and with "
          "the device):")
    for name in calls:
        print(f"    {name}: " + ", ".join(f"{a:.2f} / {b:.2f}"
                                          for a, b in row[name]))


def _mla_sdpa(F, qa, qr, ckv, kr, valid, scale):
    """SDPA on the concatenated view of the valid keys: the heads as the
    query rows of one shared KV head, masked by ``valid`` (B, keys).
    Returns the call, timed as the MLA decode kernels' library."""
    from repro_torch.models.mla import mla_concat_view

    def run():
        q_cat, k_cat, v_cat, _ = mla_concat_view(qa, qr, ckv, kr, scale)
        return F.scaled_dot_product_attention(
            q_cat[:, None].to(ckv.dtype), k_cat.transpose(1, 2),
            v_cat.transpose(1, 2), attn_mask=valid[:, None, None, :])
    return run


def check_mla_kernels(torch, F, gen, compare, record):
    """Kernels 10, 14 (dense latent cache, bf16 / fp32 / int8 with (B,)
    scales), 11, 13 (latent page pools, int8 with (n_pages,) scales) and
    12, 15 (a prompt chunk against its prior latent pages) at
    DeepSeek-V3's widths (H 128, r 512, rope 64, fp32 queries) against
    their plain versions; the bound counts the fp32 queries and partials
    beside the valid keys, and fp32 operations (the queries are fp32),
    bf16 ones for the wgmma variants of kernels 10-15 (their terms are
    bf16 or fp16).  Kernels 10, 11, 13 and 14 on bf16 and int8 caches and
    pools run their wgmma variant, on fp32 ones the FMA kernel
    (``decode_variant``), each case's variant asserted and each wgmma
    output bitwise equal over two launches; the int8 ones are held to
    their emulation too, and the timed wgmma cases beside the FMA kernel
    forced.  Kernel 14 adds B1 T2048 (timed) and a batch whose sequences'
    scales lie ~2^12 apart, from a generator of their own (seed 26), so
    the cases after draw the inputs they drew before."""
    from repro_torch.kernels import build
    from repro_torch.kernels import vwr_mla_decode as KM

    f32, bf16 = torch.float32, torch.bfloat16
    H, R, RP, SCALE = 128, 512, 64, 1.0 / 192 ** 0.5
    g14 = torch.Generator(device="cuda").manual_seed(26)

    def queries(B, g=gen):
        return (torch.randn(B, H, R, generator=g, device="cuda"),
                torch.randn(B, H, RP, generator=g, device="cuda"))

    def caches(lead, dt, q8, g=gen):
        if q8:
            return ([torch.randint(-127, 128, (*lead, w), generator=g,
                                   device="cuda", dtype=torch.int8)
                     for w in (R, RP)],
                    [torch.rand(lead[0], generator=g, device="cuda")
                     * 0.02 + 1e-3 for _ in range(2)])
        return [torch.randn(*lead, w, generator=g, device="cuda").to(dt)
                for w in (R, RP)], []

    def split(B, keys, elt, scale_bytes, index_bytes):
        parts = {"queries": 4 * B * H * (R + RP),
                 "keys": elt * keys * (R + RP), "scales": scale_bytes,
                 "index": index_bytes, "partials": 4 * B * H * (R + 2)}
        print("      bytes: " + ", ".join(f"{k} {v:,}" for k, v in
                                          parts.items())
              + f"; total {sum(parts.values()):,}")
        return sum(parts.values())

    def library(qa, qr, ckv, kr, valid):
        return _mla_sdpa(F, qa, qr, ckv, kr, valid, SCALE)

    dense_cases = [
        # label, B, T, cur_len, pos0, dtype, timed, headline
        ("deepseek decode", 4, 160, 144, 0, bf16, True, True),
        ("slab pos0 30, keys past cur", 4, 160, 150, 30, bf16, False, False),
        ("fp32 cache", 2, 77, 77, 0, f32, False, False),
        ("no valid key", 2, 40, 3, 10, bf16, False, False),
    ]
    # kernel 14 alone (int8 slabs from g14); step: the even sequences'
    # scales divided by it, the others' in [0.01, 0.012)
    slab_cases = [
        # label, B, T, cur_len, pos0, dtype, timed, headline, step
        ("B1 T2048", 1, 2048, 2048, 0, bf16, True, False, None),
        ("sequences' scales 2^12 apart", 4, 160, 144, 0, bf16, False,
         False, SCALE_STEP),
    ]
    for q8 in (False, True):
        kname = "vwr_mla_flash_decode" + ("_q8" if q8 else "")
        print(kname)
        fn = KM.vwr_mla_flash_decode_q8 if q8 else KM.vwr_mla_flash_decode
        ref = (KM.vwr_mla_flash_decode_q8_ref if q8
               else KM.vwr_mla_flash_decode_ref)
        cases = [(*c, gen, None) for c in dense_cases]
        if q8:
            cases += [(*c[:-1], g14, c[-1]) for c in slab_cases]
        for label, B, T, cur, pos0, dt, timed, head, g, step in cases:
            qa, qr = queries(B, g)
            cache, scales = caches((B, T), dt, q8, g)
            if step:
                for s in scales:
                    s.copy_(torch.rand(B, generator=g, device="cuda")
                            * 0.002 + 0.01)
                    s[::2] /= step
                apart = scales[0][1::2].min() / scales[0][::2].max()
                print(f"  sequences' scales {float(apart):.0f}x apart")
            args = (qa, qr, *cache, *scales, cur, pos0)
            shape = f"B{B} H{H} r{R} rope{RP} T{T} cur{cur} pos0{pos0}"
            before = dict(build.VARIANTS)
            got = fn(*args, scale=SCALE)
            torch.cuda.synchronize()
            kind = KM.decode_variant(R, RP, H, None,
                                     torch.int8 if q8 else dt)
            _served(kname, shape, before, build, kind)
            if kind == "wgmma":
                _bitwise(kname, shape, got, fn(*args, scale=SCALE))
            err = compare(f"{kname} {kind}", shape, f32, got,
                          ref(*args, scale=SCALE))
            if kind == "wgmma" and q8:
                compare("  vs emulation", shape, f32, got,
                        KM.decode_split_emulation(
                            qa, qr, *cache, cur_len=cur, pos0=pos0,
                            ckv_scale=scales[0], krope_scale=scales[1],
                            scale=SCALE))
            if cur <= pos0 and (got[2].abs().max().item() != 0.0
                                or got[1].max().item() > -1e29):
                raise AssertionError("a head with no valid key must give "
                                     "m=-1e30, l=0")
            if timed:
                n = max(0, min(T, cur - pos0))
                elt = cache[0].element_size()
                nbytes = split(B, B * n, elt, 8 * B if q8 else 0, 0)
                valid = torch.ones(B, n, dtype=torch.bool, device="cuda")

                def sliced(qa=qa, qr=qr, cache=cache, scales=scales, n=n,
                           valid=valid):
                    kv = [c[:, :n] for c in cache]
                    if scales:
                        kv = [c.to(bf16) * s[:, None, None].to(bf16)
                              for c, s in zip(kv, scales)]
                    return library(qa, qr, *kv, valid)()
                record(kname, label, shape, dt, err,
                       lambda: fn(*args, scale=SCALE),
                       lambda: ref(*args, scale=SCALE), sliced,
                       2 * H * B * n * (2 * R + RP), nbytes, head,
                       op_dtype=bf16 if kind == "wgmma" else f32)
                row = record.rows[-1]
                row["variant"] = kind
                if kind == "wgmma":
                    row["fma_ms"] = time_ms(
                        torch, lambda: KM.mla_decode_launch(
                            qa, qr, *cache, (), n, "fma", scale=SCALE,
                            scales=tuple(scales)))
                    print(f"      the FMA kernel (forced): "
                          f"{row['fma_ms']:.4f} ms")

    # 8 slots, ragged: 653 keys in 44 live pages; slot 0 is inactive, a
    # page of slot 4 is counted 0 and slot 2's table entry lies past the
    # pool (the kernel clamps it to the last page, as the plain version)
    lens, ps, n_pages, J = (0, 1, 16, 17, 255, 100, 200, 64), 16, 1024, 17
    paged_cases = [
        # label, page_size, dtype, timed, headline
        ("deepseek 8 slots", ps, bf16, True, True),
        ("fp32 pools", ps, f32, False, False),
        ("page 8", 8, bf16, False, False),
    ]
    for q8 in (False, True):
        kname = "vwr_mla_paged_flash_decode" + ("_q8" if q8 else "")
        print(kname)
        fn = (KM.vwr_mla_paged_flash_decode_q8 if q8
              else KM.vwr_mla_paged_flash_decode)
        ref = (KM.vwr_mla_paged_flash_decode_q8_ref if q8
               else KM.vwr_mla_paged_flash_decode_ref)
        for label, pgs, dt, timed, head in paged_cases:
            B = len(lens)
            qa, qr = queries(B)
            pools, scales = caches((n_pages, pgs), dt, q8)
            table, counts, live = _paged_table(torch, gen, lens,
                                               J * ps // pgs, pgs, n_pages)
            counts[4, 3] = 0
            table[2, 0] = n_pages + 5
            args = (qa, qr, *pools, *scales, table, counts)
            n_keys = int(counts.sum())
            live = int((counts > 0).sum())
            shape = (f"B{B} H{H} r{R} rope{RP} ps{pgs} J{table.shape[1]} "
                     f"keys{n_keys} pages{live}")
            before = dict(build.VARIANTS)
            got = fn(*args, scale=SCALE)
            torch.cuda.synchronize()
            kind = KM.decode_variant(R, RP, H, pgs,
                                     torch.int8 if q8 else dt)
            _served(kname, shape, before, build, kind)
            if kind == "wgmma":
                _bitwise(kname, shape, got, fn(*args, scale=SCALE))
            err = compare(f"{kname} {kind}", shape, f32, got,
                          ref(*args, scale=SCALE))
            if kind == "wgmma" and q8:
                compare("  vs emulation", shape, f32, got,
                        KM.decode_split_emulation(
                            qa, qr, *pools, table, counts,
                            ckv_scale=scales[0], krope_scale=scales[1],
                            scale=SCALE))
            if got[2][0].abs().max().item() != 0.0:
                raise AssertionError("an inactive slot must give l=0")
            if timed:
                elt = pools[0].element_size()
                nbytes = split(B, n_keys, elt, 8 * live if q8 else 0,
                               8 * table.numel())
                tbl = table.long().clamp(0, n_pages - 1)
                valid = (torch.arange(pgs, device="cuda")[None, None, :]
                         < counts[..., None]).reshape(B, -1)

                def gathered(qa=qa, qr=qr, pools=pools, scales=scales,
                             tbl=tbl, valid=valid):
                    kv = []
                    for i, pool in enumerate(pools):
                        x = pool[tbl]
                        if scales:
                            x = (x.to(bf16) * scales[i][tbl][:, :, None,
                                                              None].to(bf16))
                        kv.append(x.reshape(B, -1, x.shape[-1]))
                    return library(qa, qr, *kv, valid)()
                record(kname, label, shape, dt, err,
                       lambda: fn(*args, scale=SCALE),
                       lambda: ref(*args, scale=SCALE), gathered,
                       2 * H * n_keys * (2 * R + RP), nbytes, head,
                       op_dtype=bf16 if kind == "wgmma" else f32)
                row = record.rows[-1]
                row["variant"] = kind
                if kind == "wgmma":
                    row["fma_ms"] = time_ms(
                        torch, lambda: KM.mla_decode_launch(
                            qa, qr, *pools, (table, counts), 0, "fma",
                            scale=SCALE, scales=tuple(scales)))
                    print(f"      the FMA kernel (forced): "
                          f"{row['fma_ms']:.4f} ms")

    # kernels 12 and 15: a prompt chunk's C tokens against its prior
    # pages, one (J,) table; each case's last table entry lies past the
    # pool (the kernel clamps it to the last page, as the plain version).
    # Kernel 12 on bf16 pools and kernel 15 on int8 pools run their wgmma
    # variant (chunk_variant), kernel 12 on fp32 pools the FMA kernel; each
    # wgmma output is bitwise equal over two launches.
    chunk_cases = [
        # label, C, counts, page size, dtype, timed, headline
        ("deepseek chunk 64, 16 pages of 16", 64, (16,) * 16, 16, bf16,
         True, True),
        ("partial page", 64, (16,) * 5 + (7,), 16, bf16, False, False),
        ("count-0 page", 64, (16, 0, 16, 3), 16, bf16, False, False),
        ("first chunk: all masked", 64, (0, 0), 16, bf16, False, False),
        ("C=1", 1, (16, 16, 5), 16, bf16, False, False),
        ("C=3", 3, (16, 0, 16, 9), 16, bf16, False, False),
        ("pages of 64: sub-tiled", 8, (64, 50, 0, 64), 64, bf16, False,
         False),
        ("fp32 pools", 16, (16, 16, 11), 16, f32, False, False),
    ]
    n_pages = 64
    for q8 in (False, True):
        kname = "vwr_mla_chunk_prefix_attend" + ("_q8" if q8 else "")
        print(kname)
        fn = (KM.vwr_mla_chunk_prefix_attend_q8 if q8
              else KM.vwr_mla_chunk_prefix_attend)
        ref = (KM.vwr_mla_chunk_prefix_attend_q8_ref if q8
               else KM.vwr_mla_chunk_prefix_attend_ref)
        for label, C, cnts, pgs, dt, timed, head in chunk_cases:
            qa, qr = queries(C)
            pools, scales = caches((n_pages, pgs), dt, q8)
            J = len(cnts)
            table = torch.randperm(n_pages, generator=gen,
                                   device="cuda")[:J].to(torch.int32)
            table[-1] = n_pages + 5
            counts = torch.tensor(cnts, dtype=torch.int32, device="cuda")
            args = (qa, qr, *pools, *scales, table, counts)
            n_keys, live = sum(cnts), sum(1 for c in cnts if c)
            shape = (f"C{C} H{H} r{R} rope{RP} ps{pgs} J{J} keys{n_keys}")
            before = dict(build.VARIANTS)
            got = fn(*args, scale=SCALE)
            torch.cuda.synchronize()
            kind = KM.chunk_variant(R, RP, pgs, pools[0].dtype)
            served = [k.split(".")[1] for k, v in build.VARIANTS.items()
                      if k.startswith(kname + ".") and v != before[k]]
            if served != [kind]:
                raise AssertionError(f"{kname} {shape}: the rule picks "
                                     f"{kind}, the wrapper launched "
                                     f"{served}")
            if kind == "wgmma" and not all(
                    torch.equal(a, b) for a, b in
                    zip(got, fn(*args, scale=SCALE))):
                raise AssertionError(f"{kname} wgmma {shape}: two "
                                     "launches differ")
            err = compare(f"{kname} {kind}", shape, f32, got,
                          ref(*args, scale=SCALE))
            if not any(cnts) and (got[2].abs().max().item() != 0.0
                                  or got[0].abs().max().item() != 0.0
                                  or got[1].max().item() > -1e29):
                raise AssertionError("a chunk with no valid prior key must "
                                     "give m=-1e30, l=0, o=0")
            if timed:
                elt = pools[0].element_size()
                nbytes = split(C, n_keys, elt, 8 * live if q8 else 0,
                               8 * J)
                tbl = table.long().clamp(0, n_pages - 1)
                valid = (torch.arange(pgs, device="cuda")[None, :]
                         < counts[:, None]).reshape(1, -1)

                def gathered(qa=qa, qr=qr, pools=pools, scales=scales,
                             tbl=tbl, valid=valid, C=C):
                    """The chunk's C*H rows as the queries of one
                    sequence over its gathered (dequantized) pages."""
                    kv = []
                    for i, pool in enumerate(pools):
                        x = pool[tbl]
                        if scales:
                            x = x.to(bf16) * scales[i][tbl][:, None,
                                                            None].to(bf16)
                        kv.append(x.reshape(1, -1, x.shape[-1]))
                    return library(qa.reshape(1, C * H, R),
                                   qr.reshape(1, C * H, RP), *kv, valid)()
                # the wgmma variant's operations are bf16 (the fp32
                # queries and P as two bf16 terms, int8 keys exact in
                # bf16); the FMA kernel's fp32
                record(kname, label, shape, dt, err,
                       lambda: fn(*args, scale=SCALE),
                       lambda: ref(*args, scale=SCALE), gathered,
                       2 * C * H * n_keys * (2 * R + RP), nbytes, head,
                       op_dtype=bf16 if kind == "wgmma" else f32)
                record.rows[-1]["variant"] = kind
                print(f"      variant {kind}")

    # the reduced configs' widths (r 16, rope 8: zero-padded to 32 / 32 by
    # the wrappers), every MLA kernel once, against its plain version
    h, r, rp, lead, ps8 = 4, 16, 8, 12, 8
    qa = torch.randn(3, h, r, generator=gen, device="cuda")
    qr = torch.randn(3, h, rp, generator=gen, device="cuda")
    table = torch.tensor([[3, 0], [11, 7], [5, 5]], dtype=torch.int32,
                         device="cuda")
    counts = torch.tensor([[8, 3], [8, 0], [0, 0]], dtype=torch.int32,
                          device="cuda")
    for q8 in (False, True):
        sfx = "_q8" if q8 else ""
        for kind, lead_shape, index in (
                ("flash_decode", (3, 20), ()),
                ("paged_flash_decode", (lead, ps8), (table, counts)),
                ("chunk_prefix_attend", (lead, ps8),
                 (table[1].clone(), counts[0].clone()))):
            kname = f"vwr_mla_{kind}{sfx}"
            if q8:
                cache = [torch.randint(-127, 128, (*lead_shape, w),
                                       generator=gen, device="cuda",
                                       dtype=torch.int8) for w in (r, rp)]
                scales = [torch.rand(lead_shape[0], generator=gen,
                                     device="cuda") * 0.02 + 1e-3
                          for _ in range(2)]
            else:
                cache = [torch.randn(*lead_shape, w, generator=gen,
                                     device="cuda") for w in (r, rp)]
                scales = []
            tail = (13, 0) if not index else index
            args = (qa, qr, *cache, *scales, *tail)
            got = getattr(KM, kname)(*args, scale=SCALE)
            torch.cuda.synchronize()
            compare(kname, f"H{h} r{r} rope{rp} (reduced, padded)", f32,
                    got, getattr(KM, kname + "_ref")(*args, scale=SCALE))


# kernels 10 and 11's wgmma variant at split, tile, column and row edges
# (plans (splits, keys or table entries a split, column blocks) forced
# through ``mla_decode_launch``; None: ``mla_decode_plan``'s)
MLA_DENSE_EDGES = [
    # label, B, H, r, rope, T, cur_len, pos0, plan, timed
    ("one block a group", 4, 128, 512, 64, 160, 144, 0, (1, 160, 1), False),
    ("two column blocks", 4, 128, 512, 64, 160, 144, 0, (1, 160, 2), False),
    ("splits of partial tiles", 3, 128, 512, 64, 300, 300, 0, (3, 128, 1),
     False),
    ("one key past a split", 2, 128, 512, 64, 160, 33, 0, (2, 32, 4), False),
    ("pos0 > 0, splits and column blocks", 2, 128, 512, 64, 300, 290, 7,
     (3, 96, 4), False),
    ("the last slab's boxes past the tensor", 2, 128, 512, 64, 40, 40, 0,
     None, False),
    ("no valid key", 2, 128, 512, 64, 40, 3, 10, None, False),
    ("H 20 (masked rows), r 128", 3, 20, 128, 64, 37, 37, 0, None, False),
    ("H 192, r 256, rope 32", 2, 192, 256, 32, 100, 90, 0, None, False),
    ("32 splits", 1, 128, 512, 64, 1024, 1024, 0, (32, 32, 4), False),
    ("B1 T2048", 1, 128, 512, 64, 2048, 2048, 0, None, True),
]
MLA_PAGED_EDGES = [
    # label, H, r, rope, page_size, n_pages, J, lens, counts set, table
    # set, plan, timed
    ("pages of 8", 128, 512, 64, 8, 256, 34, PAGED_LENS, {}, {}, None,
     False),
    ("pages of 24", 128, 512, 64, 24, 128, 11, (255, 30, 0, 100),
     {(0, 2): 5}, {}, None, False),
    ("pages of 32", 128, 512, 64, 32, 64, 9, (255, 100, 0, 33), {}, {},
     None, False),
    ("pages of 64: sub-tiled", 128, 512, 64, 64, 64, 5, (255, 64, 1),
     {(0, 1): 0}, {}, (2, 3, 4), False),
    ("count-0 pages, splits of one entry", 128, 512, 64, 16, 1024, 17,
     PAGED_LENS, {(4, 3): 0, (5, 2): 0}, {}, (17, 1, 1), False),
    ("entries past the pool", 128, 512, 64, 16, 64, 17, PAGED_LENS, {},
     {(2, 0): 69, (4, 5): -3}, None, False),
    ("uneven splits, two column blocks", 128, 512, 64, 16, 1024, 17,
     PAGED_LENS, {}, {}, (3, 6, 2), False),
    ("H 20 (masked rows), r 128", 20, 128, 64, 16, 64, 6, (90, 0, 33), {},
     {}, None, False),
    ("H 192, r 256, rope 32", 192, 256, 32, 16, 64, 7, (100, 17), {}, {},
     None, False),
    ("J 128, 8 slots", 128, 512, 64, 16, 1200, 128, LONG_LENS, {}, {}, None,
     True),
]


def _mla_plans(KM, B, H, n, ps, r):
    """mla_decode_plan's plan first, then 1-32 even key splits of the
    32-key tiles at each column count the kernel takes."""
    own = KM.mla_decode_plan(B, H, n, ps, r)
    unit = KM.CHUNK_KEYS if ps is None else max(1, KM.CHUNK_KEYS // ps)
    n_tiles = max(1, -(-n // unit))
    alts = []
    for ncol in KM.decode_columns(r):
        for k in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32):
            if k <= n_tiles:
                per = unit * -(-n_tiles // k)
                alts.append((-(-n // per), per, ncol))
    return [own] + [p for p in dict.fromkeys(alts) if p != own]


def _parent_mla(torch, KM, build, qa, qr, ckv, kr, index, n_keys, scale):
    """The wrapper kernels 10 and 11 had before their wgmma variant (the
    FMA kernel on every cache and pool): the shape check, the widths, the
    operand checks, the outputs, the launch, the count."""
    from repro_torch.kernels import widths

    kernel = ("vwr_mla_paged_flash_decode" if index
              else "vwr_mla_flash_decode")
    KM.check_shapes(kernel, qa, qr, ckv, kr, index)

    def fma(qa, ckv, qr, kr):
        B, H, r = qa.shape
        build.check_operands(kernel, torch.float32, q_abs=(qa, (B, H, r)),
                             q_rope=(qr, (B, H, qr.shape[2])))
        build.check_operands(kernel, ckv.dtype, c_kv=(ckv, ckv.shape),
                             k_rope=(kr, kr.shape))
        if index:
            J = index[0].shape[-1]
            build.check_operands(kernel, torch.int32,
                                 table=(index[0], (B, J)),
                                 counts=(index[1], (B, J)))
        out = KM._entry(kernel, "_launch", qa, qr, ckv, kr, (), index,
                        n_keys, scale, build.dtype_code(ckv.dtype))
        build.count_launch(kernel)
        return out

    return widths.at_widths(fma, [((qa, ckv), KM.RANKS),
                                  ((qr, kr), KM.ROPES)], kernel)


def check_mla_decode_variants(torch, F, compare, record):
    """Kernels 10 and 11's wgmma variant at its split, tile, column and
    row edges (the variant counted, within the fp32 limit of the plain
    version and of the emulation of its arithmetic, bitwise over two
    launches, a sequence without a valid key giving m = -1e30, l = 0,
    o = 0), the long shapes timed beside their bounds and the parent's
    kernel (the FMA one, forced), the plan tables (ms a plan, mean and
    median, the FMA kernel, SDPA), the time of a launch by keys (the
    plan's cost model) and the host's enqueue of a call; then kernel 14's
    plan tables over int8 slabs at both dense shapes (the rule's plan,
    from the bf16 cost model, first; the FMA kernel; dequantize-then-
    SDPA), with the rule's plan against the best by medians.  A generator
    of its own, so the cases before and after draw the inputs they drew
    before."""
    from repro_torch.kernels import build
    from repro_torch.kernels import vwr_mla_decode as KM

    gen = torch.Generator(device="cuda").manual_seed(23)
    bf16, f32 = torch.bfloat16, torch.float32
    scale = 1.0 / 192 ** 0.5

    def randn(*shape, dt=f32):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    def dense_ops(B, H, r, rope, T):
        return (randn(B, H, r), randn(B, H, rope), randn(B, T, r, dt=bf16),
                randn(B, T, rope, dt=bf16))

    def paged_ops(H, r, rope, ps, n_pages, J, lens, cset=None, tset=None):
        B = len(lens)
        table, counts, _ = _paged_table(torch, gen, lens, J, ps, n_pages)
        for (b, j), c in (cset or {}).items():
            counts[b, j] = c
        for (b, j), t in (tset or {}).items():
            table[b, j] = t
        return (randn(B, H, r), randn(B, H, rope),
                randn(n_pages, ps, r, dt=bf16),
                randn(n_pages, ps, rope, dt=bf16)), (table, counts)

    def nbytes(B, H, r, rope, n_keys, index_bytes):
        """fp32 queries in, the valid bf16 keys, the index, fp32 partials
        out."""
        return (4 * B * H * (r + rope) + 2 * n_keys * (r + rope)
                + index_bytes + 4 * B * H * (r + 2))

    def held(kname, shape, run, want, emul, empty):
        before = dict(build.VARIANTS)
        got = run()
        torch.cuda.synchronize()
        _served(kname, shape, before, build, "wgmma")
        err = compare(kname, shape, f32, got, want)
        compare("  vs emulation", shape, f32, got, emul)
        _bitwise(kname, shape, got, run())
        if bool(empty.any()) and (
                got[2][empty].abs().max().item() != 0.0
                or got[0][empty].abs().max().item() != 0.0
                or got[1][empty].max().item() > -1e29):
            raise AssertionError(f"{kname} {shape}: a sequence with no "
                                 "valid key must give m=-1e30, l=0, o=0")
        return err

    def timed(kname, label, shape, err, run, plain, fma, library, flops,
              n_bytes):
        record(kname, label, shape, bf16, err, run, plain, library, flops,
               n_bytes, op_dtype=bf16)
        record.rows[-1]["variant"] = "wgmma"
        record.rows[-1]["fma_ms"] = time_ms(torch, fma)
        print(f"      the parent's kernel (fma): "
              f"{record.rows[-1]['fma_ms']:.4f} ms")

    print("vwr_mla_flash_decode wgmma edges")
    kname = "vwr_mla_flash_decode"
    for (label, B, H, r, rope, T, cur, pos0, plan,
         is_timed) in MLA_DENSE_EDGES:
        ops_ = dense_ops(B, H, r, rope, T)
        n = max(0, min(T, cur - pos0))
        shape = (f"B{B} H{H} r{r} rope{rope} T{T} cur{cur} pos0{pos0} plan "
                 f"{plan or KM.mla_decode_plan(B, H, n, None, r)}")

        def run(ops_=ops_, cur=cur, pos0=pos0, n=n, plan=plan):
            if plan is None:
                return KM.vwr_mla_flash_decode(*ops_, cur, pos0, scale=scale)
            return KM.mla_decode_launch(*ops_, (), n, "wgmma", plan,
                                        scale=scale)

        def plain(ops_=ops_, cur=cur, pos0=pos0):
            return KM.vwr_mla_flash_decode_ref(*ops_, cur, pos0, scale=scale)
        err = held(kname, shape, run, plain(), KM.decode_split_emulation(
            *ops_, cur_len=cur, pos0=pos0, plan=plan, scale=scale),
            torch.full((B,), n == 0, device="cuda"))
        if is_timed:
            qa, qr, ckv, kr = ops_
            valid = torch.ones(B, n, dtype=torch.bool, device="cuda")
            timed(kname, label, shape, err, run, plain,
                  lambda ops_=ops_, n=n: KM.mla_decode_launch(
                      *ops_, (), n, "fma", scale=scale),
                  _mla_sdpa(F, qa, qr, ckv[:, :n], kr[:, :n], valid, scale),
                  2 * H * B * n * (2 * r + rope),
                  nbytes(B, H, r, rope, B * n, 0))

    print("vwr_mla_paged_flash_decode wgmma edges")
    kname = "vwr_mla_paged_flash_decode"
    for (label, H, r, rope, ps, n_pages, J, lens, cset, tset, plan,
         is_timed) in MLA_PAGED_EDGES:
        ops_, index = paged_ops(H, r, rope, ps, n_pages, J, lens, cset, tset)
        B, n_keys = len(lens), int(index[1].sum())
        shape = (f"B{B} H{H} r{r} rope{rope} ps{ps} J{J} keys{n_keys} plan "
                 f"{plan or KM.mla_decode_plan(B, H, J, ps, r)}")

        def run(ops_=ops_, index=index, plan=plan):
            if plan is None:
                return KM.vwr_mla_paged_flash_decode(*ops_, *index,
                                                     scale=scale)
            return KM.mla_decode_launch(*ops_, index, 0, "wgmma", plan,
                                        scale=scale)

        def plain(ops_=ops_, index=index):
            return KM.vwr_mla_paged_flash_decode_ref(*ops_, *index,
                                                     scale=scale)
        err = held(kname, shape, run, plain(), KM.decode_split_emulation(
            *ops_, *index, plan=plan, scale=scale),
            index[1].sum(1) == 0)
        if is_timed:
            qa, qr, ckv, kr = ops_
            tbl = index[0].long().clamp(0, n_pages - 1)
            valid = (torch.arange(ps, device="cuda")[None, None, :]
                     < index[1][..., None]).reshape(B, -1)
            timed(kname, label, shape, err, run, plain,
                  lambda ops_=ops_, index=index: KM.mla_decode_launch(
                      *ops_, index, 0, "fma", scale=scale),
                  _mla_sdpa(F, qa, qr, ckv[tbl].reshape(B, -1, r),
                            kr[tbl].reshape(B, -1, rope), valid, scale),
                  2 * H * n_keys * (2 * r + rope),
                  nbytes(B, H, r, rope, n_keys, 8 * B * J))

    # the plan tables and the host's enqueue, at the headlines and the
    # long shapes: generate's dense caches (B4, 144 keys; B1, 2048) and the
    # Scheduler's pools (8 slots, J 17 with a count-0 page and an entry
    # past the pool; J 128)
    shapes = []
    for label, B, T, n in (("generate B4 T160 cur 144", 4, 160, 144),
                           ("batch 1, 2048 keys", 1, 2048, 2048)):
        ops_ = dense_ops(B, 128, 512, 64, T)
        valid = torch.ones(B, n, dtype=torch.bool, device="cuda")
        shapes.append((label, ops_, (), n, None, _mla_sdpa(
            F, ops_[0], ops_[1], ops_[2][:, :n], ops_[3][:, :n], valid,
            scale)))
    for label, n_pages, J, lens, cset, tset in (
            ("Scheduler 8 slots, J 17", 1024, 17, PAGED_LENS, {(4, 3): 0},
             {(2, 0): 1029}),
            ("8 slots, J 128", 1200, 128, LONG_LENS, {}, {})):
        ops_, index = paged_ops(128, 512, 64, 16, n_pages, J, lens, cset,
                                tset)
        B = len(lens)
        tbl = index[0].long().clamp(0, n_pages - 1)
        valid = (torch.arange(16, device="cuda")[None, None, :]
                 < index[1][..., None]).reshape(B, -1)
        shapes.append((label, ops_, index, J, 16, _mla_sdpa(
            F, ops_[0], ops_[1], ops_[2][tbl].reshape(B, -1, 512),
            ops_[3][tbl].reshape(B, -1, 64), valid, scale)))
    print("  MLA decode plans (ms, mean / median of 20 launches; (splits, "
          "keys or table entries a split, column blocks)), the FMA kernel "
          "(the parent's), SDPA:")
    for label, ops_, index, n, ps, library in shapes:
        B = ops_[0].shape[0]
        kname = ("vwr_mla_paged_flash_decode" if index
                 else "vwr_mla_flash_decode")
        row = {"kernel": kname + " plans", "case": label,
               "shape": f"B{B} H128 r512 rope64 " + (
                   f"J{n} of {ps}, keys {int(index[1].sum())}" if index
                   else f"keys {n}"), "plans": []}
        for plan in _mla_plans(KM, B, 128, n, ps, 512):
            ts = launch_ms(torch, lambda: KM.mla_decode_launch(
                *ops_, index, 0 if index else n, "wgmma", plan,
                scale=scale))
            row["plans"].append({"plan": plan, "ms": sum(ts) / len(ts),
                                 "median_ms": statistics.median(ts)})
        row["fma_ms"] = time_ms(torch, lambda: KM.mla_decode_launch(
            *ops_, index, 0 if index else n, "fma", scale=scale))
        row["library_ms"] = time_ms(torch, library)
        record.rows.append(row)
        print(f"    {label} {row['shape']}: " + ", ".join(
            f"{p['plan']} {p['ms']:.4f} / {p['median_ms']:.4f}"
            for p in row["plans"])
            + f"; fma {row['fma_ms']:.4f}; SDPA {row['library_ms']:.4f}")

    # the terms of mla_decode_plan's cost model: a launch's time by keys
    # at one split, one and four column blocks (a block's fixed cost and a
    # 32-key tile's), beside a 4-byte fill kernel (the launch floor)
    ops_ = dense_ops(4, 128, 512, 64, 512)
    fill = torch.zeros(1, device="cuda")
    row = {"kernel": "vwr_mla_flash_decode anatomy",
           "shape": "B4 H128 r512 rope64, one split",
           "floor_ms": time_ms(torch, fill.zero_), "ms": {}}
    for ncol in (1, 4):
        for n in (0, 32, 128, 512):
            row["ms"][f"ncol {ncol}, {n} keys"] = time_ms(
                torch, lambda: KM.mla_decode_launch(
                    *ops_, (), n, "wgmma", (1, max(n, 32), ncol),
                    scale=scale))
    record.rows.append(row)
    print(f"  MLA decode anatomy (ms a launch, one split; fill kernel "
          f"{row['floor_ms']:.4f}): " + ", ".join(
              f"{k} {v:.4f}" for k, v in row["ms"].items()))

    print("  MLA decode host enqueue (us a call; enqueue, and with the "
          "device): the FMA and wgmma launches, the parent's wrapper "
          "(shapes, widths, checks, the FMA launch), the whole wrapper "
          "(shapes, widths, checks, rule, plan, split buffers, wgmma "
          "launch), SDPA")
    for label, ops_, index, n, ps, library in (shapes[0], shapes[2]):
        m = 0 if index else n
        calls = {
            "fma": lambda: KM.mla_decode_launch(*ops_, index, m, "fma",
                                                scale=scale),
            "wgmma": lambda: KM.mla_decode_launch(*ops_, index, m, "wgmma",
                                                  scale=scale),
            "parent's wrapper": lambda: _parent_mla(
                torch, KM, build, *ops_, index, m, scale),
            "wrapper": (
                (lambda: KM.vwr_mla_paged_flash_decode(*ops_, *index,
                                                       scale=scale))
                if index else (lambda: KM.vwr_mla_flash_decode(
                    *ops_, n, scale=scale))),
            "SDPA": library,
        }
        row = {"kernel": ("vwr_mla_paged_flash_decode" if index
                          else "vwr_mla_flash_decode") + " enqueue",
               "case": label, **{name: [] for name in calls}}
        for _ in range(3):
            for name, fn in calls.items():
                row[name].append(_enqueue_us(torch, fn))
        record.rows.append(row)
        print(f"    {label}:")
        for name in calls:
            print(f"      {name}: " + ", ".join(f"{a:.2f} / {b:.2f}"
                                                for a, b in row[name]))

    print("  vwr_mla_flash_decode_q8 plans (ms, mean / median of 20 "
          "launches; (splits, keys a split, column blocks); rule first), "
          "the FMA kernel (the parent's), dequantize-then-SDPA:")
    for label, B, T, n in (("generate B4 T160 cur 144", 4, 160, 144),
                           ("batch 1, 2048 keys", 1, 2048, 2048)):
        qa, qr = randn(B, 128, 512), randn(B, 128, 64)
        ckv, kr = (torch.randint(-127, 128, (B, T, w), generator=gen,
                                 device="cuda", dtype=torch.int8)
                   for w in (512, 64))
        cs, rs = (torch.rand(B, generator=gen, device="cuda") * 0.02 + 1e-3
                  for _ in range(2))
        rule = KM.mla_decode_plan(B, 128, n, None, 512)
        row = {"kernel": "vwr_mla_flash_decode_q8 plans", "case": label,
               "shape": f"B{B} H128 r512 rope64 keys {n}", "rule": rule,
               "plans": []}
        for plan in [rule] + [p for p in _mla_plans(KM, B, 128, n, None, 512)
                              if p != rule]:
            ts = launch_ms(torch, lambda: KM.mla_decode_launch(
                qa, qr, ckv, kr, (), n, "wgmma", plan, scale=scale,
                scales=(cs, rs)))
            row["plans"].append({"plan": plan, "ms": sum(ts) / len(ts),
                                 "median_ms": statistics.median(ts)})
        best = min(row["plans"], key=lambda p: p["median_ms"])
        row["rule_over_best"] = row["plans"][0]["median_ms"] / best[
            "median_ms"]
        row["fma_ms"] = time_ms(torch, lambda: KM.mla_decode_launch(
            qa, qr, ckv, kr, (), n, "fma", scale=scale, scales=(cs, rs)))
        valid = torch.ones(B, n, dtype=torch.bool, device="cuda")

        def library(qa=qa, qr=qr, ckv=ckv, kr=kr, cs=cs, rs=rs, n=n,
                    valid=valid):
            kv = [x[:, :n].to(bf16) * s[:, None, None].to(bf16)
                  for x, s in ((ckv, cs), (kr, rs))]
            return _mla_sdpa(F, qa, qr, *kv, valid, scale)()
        row["library_ms"] = time_ms(torch, library)
        record.rows.append(row)
        print(f"    {label} {row['shape']}: " + ", ".join(
            f"{p['plan']} {p['ms']:.4f} / {p['median_ms']:.4f}"
            for p in row["plans"])
            + f"; fma {row['fma_ms']:.4f}; SDPA {row['library_ms']:.4f}")
        print(f"      the rule's plan {rule} takes "
              f"{row['rule_over_best']:.3f}x the best int8 plan "
              f"{best['plan']} by medians: "
              + ("within" if row["rule_over_best"] <= 1.05 else "outside")
              + " 5%")


# kernels 7 and 13 with their page scales 2^12 apart between the first
# and the last split of a slot, and slot 0 in its first split alone: P's
# power of two must come from the block's own split (taken from slot 0's
# row or from a first split, P's fp16 terms overflow in the last ones)
SCALE_STEP = 2.0 ** 12


def _stepped_scales(torch, scales, table, counts, nsplit, per):
    """The page scales of the live pages that ``table`` holds before a
    slot's last split of ``per`` entries (``nsplit`` splits) divided by
    ``SCALE_STEP``, in place (the outputs keep their magnitude); returns
    the factor between the splits' largest counted scales, the smallest
    over the slots with both."""
    B, J = table.shape
    n_pages = scales[0].shape[0]
    tbl = table.long().clamp(0, n_pages - 1)
    late = torch.arange(J, device=table.device) >= (nsplit - 1) * per
    pages = tbl[:, ~late][counts[:, ~late] > 0].unique()
    for s in scales:
        s[pages] /= SCALE_STEP
    cs = scales[0].reshape(n_pages, -1)[:, 0]
    steps = []
    for b in range(B):
        live = counts[b] > 0
        first, last = live & ~late, live & late
        if bool(first.any()) and bool(last.any()):
            steps.append(float(cs[tbl[b][last]].max()
                               / cs[tbl[b][first]].max()))
    return min(steps)


def check_paged_q8_variants(torch, F, compare, record):
    """Kernel 7's mma variant and kernel 13's wgmma variant (kernels 5
    and 11's over int8 pages) at kernels 5 and 11's edges (masks, page
    sizes, widths, forced plans, J 128 tables; each case on the variant
    its rule names, within the fp32 limit of the plain version and of the
    emulation, bitwise over two launches, a slot without a valid key
    giving m = -1e30, l = 0, o = 0), a case whose splits' page scales lie
    2^12 apart, the J 128 tables timed beside their bounds, the parent's
    FMA kernel (forced through ``kind``) and the library call, and the
    plan tables.  A generator of its own (seed 25), so the other cases
    keep their inputs."""
    from repro_torch.kernels import build
    from repro_torch.kernels import vwr_decode as KD
    from repro_torch.kernels import vwr_mla_decode as KM

    gen = torch.Generator(device="cuda").manual_seed(25)
    bf16, f32 = torch.bfloat16, torch.float32
    i8 = dict(generator=gen, device="cuda", dtype=torch.int8)

    def scales(*shape):
        return tuple(torch.rand(shape, generator=gen, device="cuda") * 0.02
                     + 1e-3 for _ in range(2))

    def empty_ok(kname, shape, got, empty):
        if bool(empty.any()) and (
                got[2][empty].abs().max().item() != 0.0
                or got[0][empty].abs().max().item() != 0.0
                or got[1][empty].max().item() > -1e29):
            raise AssertionError(f"{kname} {shape}: a slot with no valid "
                                 "key must give m=-1e30, l=0, o=0")

    def held(kname, want_kind, shape, run, want, emul):
        before = dict(build.VARIANTS)
        got = run()
        torch.cuda.synchronize()
        _served(kname, shape, before, build, want_kind)
        err = compare(kname, shape, f32, got, want)
        compare("  vs emulation", shape, f32, got, emul)
        _bitwise(kname, shape, got, run())
        return got, err

    # ---- kernel 7: kernel 5's edges over int8 pages ----
    kname = "vwr_paged_flash_decode_q8"
    print(f"{kname} mma edges")

    def paged_ops(B, KV, G, D, ps, n_pages, J, lens, cset=None, tset=None):
        q = torch.randn(B * KV, G, D, generator=gen, device="cuda").to(bf16)
        pools = [torch.randint(-127, 128, (n_pages, ps, KV, D), **i8)
                 for _ in range(2)]
        sc = scales(n_pages, KV)
        table, counts, live = _paged_table(torch, gen, lens, J, ps, n_pages)
        for (b, j), c in (cset or {}).items():
            counts[b, j] = c
        for (b, j), t in (tset or {}).items():
            table[b, j] = t
        return (q, *pools, *sc, table, counts), live

    def paged_case(label, ops_, plan, KV, timed=False, live=0):
        q, kp, vp, ks, vs, table, counts = ops_
        B, J = table.shape
        G, D = q.shape[1:]
        ps = kp.shape[1]
        shape = (f"B{B} KV{KV} G{G} D{D} ps{ps} J{J} keys "
                 f"{int(counts.sum())} plan "
                 f"{plan or KD.paged_plan(B * KV, J, ps)}")

        def run(ops_=ops_, plan=plan):
            if plan is None:
                return KD.vwr_paged_flash_decode_q8(*ops_)
            return KD.paged_launch(q, kp, vp, table, counts, "mma", plan,
                                   scales=(ks, vs))

        def plain(ops_=ops_):
            return KD.vwr_paged_flash_decode_q8_ref(*ops_)
        got, err = held(kname, KD.paged_variant(bf16, D, G), shape, run,
                        plain(), KD.paged_mma_emulation(
                            q, kp, vp, table, counts, plan=plan,
                            scales=(ks, vs)))
        empty_ok(kname, shape, got, (counts.sum(1) == 0).repeat_interleave(
            KV))
        if timed:
            n_keys = int(counts.sum())
            record(kname, label, shape, bf16, err, run, plain,
                   _paged_sdpa(torch, F, q, (kp, vp), (ks, vs), table,
                               counts, KV, G, D),
                   4 * KV * G * D * n_keys,
                   2 * n_keys * KV * D + 8 * live * KV + 2 * q.numel()
                   + 8 * B * J + 4 * B * KV * G * (D + 2))
            row = record.rows[-1]
            row["variant"] = "mma"
            row["fma_ms"] = time_ms(torch, lambda: KD.paged_launch(
                q, kp, vp, table, counts, "fma", scales=(ks, vs)))
            print(f"      the parent's kernel (fma): {row['fma_ms']:.4f} ms")

    for (label, B, KV, G, D, ps, n_pages, J, lens, cset, tset, plan,
         timed) in PAGED_EDGES:
        ops_, live = paged_ops(B, KV, G, D, ps, n_pages, J, lens, cset, tset)
        paged_case(label, ops_, plan, KV, timed, live)
    # v scales 2^12 apart between a slot's first and last split
    ops_, _ = paged_ops(4, 4, 8, 64, 16, 256, 16, (64, 200, 255, 130))
    plan = (4, 4)
    step = _stepped_scales(torch, ops_[4:5], ops_[5], ops_[6], *plan)
    print(f"  splits' page scales {step:.0f}x apart")
    paged_case("split-dependent scales", ops_, plan, 4)

    print(f"  {kname} plans (ms; (splits, table entries a split)), the FMA "
          "kernel (the parent's), SDPA:")
    for label, KV, G, J, lens in (
            ("tinyllama 8 slots, J 16", 4, 8, 16, PAGED_LENS),
            ("tinyllama 8 slots, J 18", 4, 8, 18,
             (288, 1, 17, 3, 100, 0, 250, 64)),
            ("tinyllama 8 slots, J 128", 4, 8, 128, LONG_LENS)):
        B, D, ps = 8, 64, 16
        ops_, _ = paged_ops(B, KV, G, D, ps, 1200, J, lens)
        q, kp, vp, ks, vs, table, counts = ops_
        row = {"kernel": f"{kname} plans", "case": label,
               "shape": f"B{B} KV{KV} G{G} D{D} J{J} of {ps}, keys "
                        f"{sum(lens)}", "plans": []}
        for plan in _paged_plans(KD, B * KV, J):
            ms = time_ms(torch, lambda: KD.paged_launch(
                q, kp, vp, table, counts, "mma", plan, scales=(ks, vs)))
            row["plans"].append({"plan": plan, "ms": ms})
        row["fma_ms"] = time_ms(torch, lambda: KD.paged_launch(
            q, kp, vp, table, counts, "fma", scales=(ks, vs)))
        row["library_ms"] = time_ms(torch, _paged_sdpa(
            torch, F, q, (kp, vp), (ks, vs), table, counts, KV, G, D))
        record.rows.append(row)
        print(f"    {label} {row['shape']}: " + ", ".join(
            f"{p['plan']} {p['ms']:.4f}" for p in row["plans"])
            + f"; fma {row['fma_ms']:.4f}; SDPA {row['library_ms']:.4f}")

    # ---- kernel 13: kernel 11's edges over int8 pages ----
    kname = "vwr_mla_paged_flash_decode_q8"
    scale = 1.0 / 192 ** 0.5
    print(f"{kname} wgmma edges")

    def mla_ops(H, r, rope, ps, n_pages, J, lens, cset=None, tset=None):
        B = len(lens)
        table, counts, live = _paged_table(torch, gen, lens, J, ps, n_pages)
        for (b, j), c in (cset or {}).items():
            counts[b, j] = c
        for (b, j), t in (tset or {}).items():
            table[b, j] = t
        return (torch.randn(B, H, r, generator=gen, device="cuda"),
                torch.randn(B, H, rope, generator=gen, device="cuda"),
                torch.randint(-127, 128, (n_pages, ps, r), **i8),
                torch.randint(-127, 128, (n_pages, ps, rope), **i8),
                *scales(n_pages), table, counts)

    def mla_library(ops_):
        qa, qr, ckv, kr, cs, rs, table, counts = ops_
        B, J = table.shape
        ps = ckv.shape[1]
        tbl = table.long().clamp(0, ckv.shape[0] - 1)
        valid = (torch.arange(ps, device="cuda")[None, None, :]
                 < counts[..., None]).reshape(B, -1)
        kv = [(x[tbl].to(bf16) * s[tbl][:, :, None, None].to(bf16))
              .reshape(B, J * ps, -1) for x, s in ((ckv, cs), (kr, rs))]
        return _mla_sdpa(F, qa, qr, *kv, valid, scale)

    def mla_case(label, ops_, plan, timed=False):
        qa, qr, ckv, kr, cs, rs, table, counts = ops_
        B, J = table.shape
        H, r = qa.shape[1:]
        rope, ps = qr.shape[2], ckv.shape[1]
        n_keys = int(counts.sum())
        shape = (f"B{B} H{H} r{r} rope{rope} ps{ps} J{J} keys{n_keys} plan "
                 f"{plan or KM.mla_decode_plan(B, H, J, ps, r)}")

        def run(ops_=ops_, plan=plan):
            if plan is None:
                return KM.vwr_mla_paged_flash_decode_q8(*ops_, scale=scale)
            return KM.mla_decode_launch(qa, qr, ckv, kr, (table, counts), 0,
                                        "wgmma", plan, scale=scale,
                                        scales=(cs, rs))

        def plain(ops_=ops_):
            return KM.vwr_mla_paged_flash_decode_q8_ref(*ops_, scale=scale)
        got, err = held(kname, KM.decode_variant(r, rope, H, ps, torch.int8),
                        shape, run, plain(), KM.decode_split_emulation(
                            qa, qr, ckv, kr, table, counts, plan=plan,
                            ckv_scale=cs, krope_scale=rs, scale=scale))
        empty_ok(kname, shape, got, counts.sum(1) == 0)
        if timed:
            live = int((counts > 0).sum())
            record(kname, label, shape, bf16, err, run, plain,
                   mla_library(ops_), 2 * H * n_keys * (2 * r + rope),
                   4 * B * H * (r + rope) + n_keys * (r + rope) + 8 * live
                   + 8 * B * J + 4 * B * H * (r + 2), op_dtype=bf16)
            row = record.rows[-1]
            row["variant"] = "wgmma"
            row["fma_ms"] = time_ms(torch, lambda: KM.mla_decode_launch(
                qa, qr, ckv, kr, (table, counts), 0, "fma", scale=scale,
                scales=(cs, rs)))
            print(f"      the parent's kernel (fma): {row['fma_ms']:.4f} ms")

    for (label, H, r, rope, ps, n_pages, J, lens, cset, tset, plan,
         timed) in MLA_PAGED_EDGES:
        mla_case(label, mla_ops(H, r, rope, ps, n_pages, J, lens, cset,
                                tset), plan, timed)
    ops_ = mla_ops(128, 512, 64, 16, 1024, 17,
                   (90, 1, 16, 17, 255, 100, 200, 64), {(4, 3): 0})
    plan = (3, 6, 2)
    step = _stepped_scales(torch, ops_[4:6], ops_[6], ops_[7], 3, 6)
    print(f"  splits' page scales {step:.0f}x apart")
    mla_case("split-dependent scales", ops_, plan)

    print(f"  {kname} plans (ms, mean / median of 20 launches; (splits, "
          "table entries a split, column blocks)), the FMA kernel (the "
          "parent's), SDPA:")
    for label, n_pages, J, lens, cset, tset in (
            ("Scheduler 8 slots, J 17", 1024, 17, PAGED_LENS, {(4, 3): 0},
             {(2, 0): 1029}),
            ("8 slots, J 128", 1200, 128, LONG_LENS, {}, {})):
        ops_ = mla_ops(128, 512, 64, 16, n_pages, J, lens, cset, tset)
        qa, qr, ckv, kr, cs, rs, table, counts = ops_
        B = len(lens)
        row = {"kernel": f"{kname} plans", "case": label,
               "shape": f"B{B} H128 r512 rope64 J{J} of 16, keys "
                        f"{int(counts.sum())}", "plans": [],
               "rule": KM.mla_decode_plan(B, 128, J, 16, 512)}
        for plan in [row["rule"]] + [
                p for p in _mla_plans(KM, B, 128, J, 16, 512)
                if p != row["rule"]]:
            ts = launch_ms(torch, lambda: KM.mla_decode_launch(
                qa, qr, ckv, kr, (table, counts), 0, "wgmma", plan,
                scale=scale, scales=(cs, rs)))
            row["plans"].append({"plan": plan, "ms": sum(ts) / len(ts),
                                 "median_ms": statistics.median(ts)})
        row["fma_ms"] = time_ms(torch, lambda: KM.mla_decode_launch(
            qa, qr, ckv, kr, (table, counts), 0, "fma", scale=scale,
            scales=(cs, rs)))
        row["library_ms"] = time_ms(torch, mla_library(ops_))
        record.rows.append(row)
        print(f"    {label} {row['shape']} (rule {row['rule']}): "
              + ", ".join(f"{p['plan']} {p['ms']:.4f} / "
                          f"{p['median_ms']:.4f}" for p in row["plans"])
              + f"; fma {row['fma_ms']:.4f}; SDPA {row['library_ms']:.4f}")


# ----------------------------------------------------------------------
# phase 2: the frontend families' shapes (internvl2-2b, seamless-m4t)
# ----------------------------------------------------------------------

# the identity-paged cross pool: 8 slots of 64 entries of 16 (the
# Scheduler's enc_len 1024), ragged encoder lengths, slot 3 inactive
CROSS_LENS = (961, 160, 500, 0, 1024, 333, 17, 640)
# internvl2's self pools: 8 slots, 34 entries of 16 (max_len 544), the
# 256 frontend positions ahead of each prompt, slot 5 inactive
VLM_LENS = (544, 300, 417, 288, 512, 0, 399, 256)


def check_frontend_shapes(torch, F, compare, record):
    """The new shapes of the frontend families on kernels 1, 3, 4, 5 and
    7, each on the variant its rule names, held against the plain
    version (the decode kernels also against their emulation, bitwise
    over two launches) and timed beside the bound and the library call:
    kernel 1's relu up projection and its down projection + residual at
    seamless's widths (M 512), kernel 3 at internvl2's widths (B1 S384
    H16 KV8 D128; S 293 = 256 + 37 held too), kernel 4 over internvl2's
    dense cache (B4 T416 KV8 G2 D128) and seamless's cross cache (B4
    T512 KV16 G1 D64, and ragged T 500 and 961), kernel 5 over the
    identity-paged cross pool (``CROSS_LENS``) and internvl2's pools,
    kernel 7 at internvl2's pool shape.  A generator of its own (seed
    27), so the other cases keep their inputs."""
    from repro_torch.dist.decode import _page_counts
    from repro_torch.kernels import build
    from repro_torch.kernels import vwr_attention as KA
    from repro_torch.kernels import vwr_decode as KD
    from repro_torch.kernels import vwr_matmul as KM

    gen = torch.Generator(device="cuda").manual_seed(27)
    bf16, f32 = torch.bfloat16, torch.float32
    print("the frontend families' shapes")

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(bf16)

    for label, M, K, N, act, res in (
            ("seamless relu up", 512, 1024, 8192, "relu", False),
            ("seamless down+res", 512, 8192, 1024, None, True)):
        x, w = randn(M, K), randn(K, N, scale=K ** -0.5)
        r = randn(M, N) if res else None
        shape = f"{M}x{K}x{N}" + ("+res" if res else f"+{act}")
        before = dict(build.VARIANTS)
        got = KM.vwr_matmul(x, w, None, r, activation=act)
        torch.cuda.synchronize()
        _served("vwr_matmul", shape, before, build, "wgmma")
        err = compare("vwr_matmul wgmma", shape, bf16, got,
                      KM.vwr_matmul_ref(x, w, None, r, activation=act))
        _bitwise("vwr_matmul", shape, (got,),
                 (KM.vwr_matmul(x, w, None, r, activation=act),))
        if act:
            # relu(0 + x @ w) in one call: cuBLASLt's RELU epilogue,
            # held against the plain version like the kernel
            zero = torch.zeros(N, dtype=bf16, device="cuda")
            library = lambda: torch._addmm_activation(zero, x, w)
            compare("_addmm_activation", shape, bf16, library(),
                    KM.vwr_matmul_ref(x, w, None, r, activation=act))
        else:
            library = lambda: torch.addmm(r, x, w)
        record("vwr_matmul", label, shape, bf16, err,
               lambda: KM.vwr_matmul(x, w, None, r, activation=act),
               lambda: KM.vwr_matmul_ref(x, w, None, r, activation=act),
               library, 2 * M * K * N,
               2 * (M * K + K * N + M * N * (2 if res else 1)))
        row = record.rows[-1]
        row["variant"] = "wgmma"
        if act:
            row["matmul_alone_ms"] = time_ms(torch, lambda: x @ w)
            print(f"      x @ w alone (cuBLAS, no relu): "
                  f"{row['matmul_alone_ms']:.4f} ms")

    for label, B, S, H, KV, D, timed in (
            ("internvl2 prefill 256+128", 1, 384, 16, 8, 128, True),
            ("internvl2 prefill 256+37", 1, 293, 16, 8, 128, False),
            ("seamless decoder self", 4, 16, 16, 16, 64, False)):
        q, k, v = randn(B, S, H, D), randn(B, S, KV, D), randn(B, S, KV, D)
        shape = f"B{B} S{S} H{H} KV{KV} D{D}"
        got = KA.vwr_attention(q, k, v)
        torch.cuda.synchronize()
        err = compare("vwr_attention", shape, bf16, got,
                      KA.vwr_attention_ref(q, k, v))
        _bitwise("vwr_attention", shape, (got,), (KA.vwr_attention(q, k, v),))
        if timed:
            G = H // KV
            qt = q.transpose(1, 2)
            kt, vt = (t.transpose(1, 2).repeat_interleave(G, 1)
                      for t in (k, v))
            record("vwr_attention", label, shape, bf16, err,
                   lambda: KA.vwr_attention(q, k, v),
                   lambda: KA.vwr_attention_ref(q, k, v),
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True),
                   4 * B * H * D * S * (S + 1) // 2,
                   2 * 2 * B * S * D * (H + KV))

    for label, B, T, KV, G, D, timed in (
            ("internvl2 decode", 4, 416, 8, 2, 128, True),
            ("seamless cross", 4, 512, 16, 1, 64, True),
            ("seamless cross, ragged", 4, 500, 16, 1, 64, False),
            ("seamless cross, ragged", 4, 961, 16, 1, 64, True)):
        q = randn(B * KV, G, D)
        k, v = randn(B, T, KV, D), randn(B, T, KV, D)
        shape = f"B{B} T{T} KV{KV} G{G} D{D} cur{T}"
        before = dict(build.VARIANTS)
        got = KD.vwr_flash_decode(q, k, v, T)
        torch.cuda.synchronize()
        _served("vwr_flash_decode", shape, before, build, "split")
        err = compare("vwr_flash_decode", shape, f32, got,
                      KD.vwr_flash_decode_ref(q, k, v, T))
        compare("  vs emulation", shape, f32, got,
                KD.decode_split_emulation(q, k, v, T))
        _bitwise("vwr_flash_decode", shape, got,
                 KD.vwr_flash_decode(q, k, v, T))
        if timed:
            qs = q.reshape(B, KV * G, 1, D)
            ks, vs = (t.transpose(1, 2).repeat_interleave(G, 1)
                      for t in (k, v))
            record("vwr_flash_decode", label, shape, bf16, err,
                   lambda: KD.vwr_flash_decode(q, k, v, T),
                   lambda: KD.vwr_flash_decode_ref(q, k, v, T),
                   lambda: F.scaled_dot_product_attention(qs, ks, vs),
                   4 * B * KV * G * D * T,
                   2 * (B * KV * G * D + 2 * B * T * KV * D)
                   + 4 * B * KV * G * (D + 2))
            record.rows[-1]["plan"] = list(KD.decode_plan(B * KV, T))

    for q8, label, lens, KV, G, D, J, cross in (
            (False, "seamless identity-paged cross pool", CROSS_LENS, 16, 1,
             64, 64, True),
            (False, "internvl2 8 slots", VLM_LENS, 8, 2, 128, 34, False),
            (True, "internvl2 8 slots", VLM_LENS, 8, 2, 128, 34, False)):
        kname = "vwr_paged_flash_decode" + ("_q8" if q8 else "")
        B, ps = len(lens), 16
        q = randn(B * KV, G, D)
        if cross:
            # the slot-dense (B, J * 16, KV, D) cross cache viewed as B * J
            # pages: the identity table, the counts of the encoder lengths
            n_pages = B * J
            table = torch.arange(n_pages, dtype=torch.int32,
                                 device="cuda").view(B, J)
            counts = torch.from_numpy(_page_counts(lens, J, ps)).cuda()
            live = sum(-(-n // ps) for n in lens)
        else:
            n_pages = 320
            table, counts, live = _paged_table(torch, gen, lens, J, ps,
                                               n_pages)
        shape = (n_pages, ps, KV, D)
        if q8:
            pools = [torch.randint(-127, 128, shape, generator=gen,
                                   device="cuda", dtype=torch.int8)
                     for _ in range(2)]
            scales = [torch.rand((n_pages, KV), generator=gen,
                                 device="cuda") * 0.02 + 1e-3
                      for _ in range(2)]
        else:
            pools, scales = [randn(*shape) for _ in range(2)], []
        ops_ = (q, *pools, *scales, table, counts)
        fn = KD.vwr_paged_flash_decode_q8 if q8 \
            else KD.vwr_paged_flash_decode
        ref = KD.vwr_paged_flash_decode_q8_ref if q8 \
            else KD.vwr_paged_flash_decode_ref
        shape_s = (f"B{B} KV{KV} G{G} D{D} ps{ps} J{J} pages{n_pages} "
                   f"keys{sum(lens)}")
        before = dict(build.VARIANTS)
        got = fn(*ops_)
        torch.cuda.synchronize()
        _served(kname, shape_s, before, build, "mma")
        err = compare(kname, shape_s, f32, got, ref(*ops_))
        compare("  vs emulation", shape_s, f32, got,
                KD.paged_mma_emulation(q, *pools, table, counts,
                                       scales=tuple(scales) or None))
        _bitwise(kname, shape_s, got, fn(*ops_))
        for b, n in enumerate(lens):
            if n == 0 and got[2][b * KV:(b + 1) * KV].abs().max() != 0:
                raise AssertionError("a slot with no valid key must give "
                                     "l=0")
        n_keys = sum(lens)
        nbytes = (pools[0].element_size() * 2 * n_keys * KV * D
                  + (8 * live * KV if q8 else 0) + 2 * q.numel()
                  + 8 * B * J + 4 * B * KV * G * (D + 2))
        record(kname, label, shape_s, bf16, err, lambda: fn(*ops_),
               lambda: ref(*ops_),
               _paged_sdpa(torch, F, q, pools, scales, table, counts, KV,
                           G, D),
               4 * KV * G * D * n_keys, nbytes)
        row = record.rows[-1]
        row["variant"] = "mma"
        row["plan"] = list(KD.paged_plan(B * KV, J, ps))
        row["fma_ms"] = time_ms(torch, lambda: KD.paged_launch(
            q, *pools, table, counts, "fma", scales=tuple(scales)))
        print(f"      plan {row['plan']}; the FMA kernel (forced): "
              f"{row['fma_ms']:.4f} ms")


def check_hybrid_shapes(torch, F, compare, record):
    """Kernels 1-4 at the shapes zamba2-1.2b's shared block gives them in
    phase 6d's ``generate`` (batch 4, prompt 256, gen 32; d 2048, 32 MHA
    heads of 64, swiglu 8192): the prefill's products (M 1024) on wgmma
    tiles, the decode step's down projection (M 4) on split-K, swiglu on
    wgmma at both, the causal prefill attention, and kernel 4 over the
    invocation's dense cache at its last step (287 keys) on its split
    variant; each held against the plain version, bitwise over two
    launches, and timed beside the bound and the library call.  A
    generator of its own (seed 28), so the other cases keep their
    inputs."""
    from repro_torch.kernels import build
    from repro_torch.kernels import vwr_attention as KA
    from repro_torch.kernels import vwr_decode as KD
    from repro_torch.kernels import vwr_matmul as KM

    gen = torch.Generator(device="cuda").manual_seed(28)
    bf16, f32 = torch.bfloat16, torch.float32
    print("zamba2-1.2b's shared-block shapes")

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(bf16)

    for label, M, K, N, res, kind in (
            ("zamba2 q/k/v", 1024, 2048, 2048, False, "wgmma"),
            ("zamba2 o+res", 1024, 2048, 2048, True, "wgmma"),
            ("zamba2 down+res", 1024, 8192, 2048, True, "wgmma"),
            ("zamba2 decode down", 4, 8192, 2048, False, "splitk")):
        x, w = randn(M, K), randn(K, N, scale=K ** -0.5)
        r = randn(M, N) if res else None
        shape = f"{M}x{K}x{N}" + ("+res" if res else "")
        before = dict(build.VARIANTS)
        got = KM.vwr_matmul(x, w, None, r)
        torch.cuda.synchronize()
        _served("vwr_matmul", shape, before, build, kind)
        err = compare(f"vwr_matmul {kind}", shape, bf16, got,
                      KM.vwr_matmul_ref(x, w, None, r))
        _bitwise("vwr_matmul", shape, (got,), (KM.vwr_matmul(x, w, None, r),))
        record("vwr_matmul", label, shape, bf16, err,
               lambda: KM.vwr_matmul(x, w, None, r),
               lambda: KM.vwr_matmul_ref(x, w, None, r),
               (lambda: torch.addmm(r, x, w)) if res
               else (lambda: torch.matmul(x, w)),
               2 * M * K * N, 2 * (M * K + K * N + M * N * (2 if res else 1)))
        record.rows[-1]["variant"] = kind

    for label, M in (("zamba2 gate/up", 1024), ("zamba2 decode", 4)):
        x = randn(M, 2048)
        wg, wi = (randn(2048, 8192, scale=2048 ** -0.5) for _ in range(2))
        _swiglu_case(torch, F, KM, build, x, wg, wi, label, compare, record,
                     True, False)

    B, S, H, D = 4, 256, 32, 64
    q, k, v = (randn(B, S, H, D) for _ in range(3))
    shape = f"B{B} S{S} H{H} KV{H} D{D}"
    got = KA.vwr_attention(q, k, v)
    torch.cuda.synchronize()
    err = compare("vwr_attention", shape, bf16, got,
                  KA.vwr_attention_ref(q, k, v))
    _bitwise("vwr_attention", shape, (got,), (KA.vwr_attention(q, k, v),))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    record("vwr_attention", "zamba2 prefill", shape, bf16, err,
           lambda: KA.vwr_attention(q, k, v),
           lambda: KA.vwr_attention_ref(q, k, v),
           lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=True),
           4 * B * H * D * S * (S + 1) // 2, 2 * 4 * B * S * H * D)

    T = 288
    n = S + GEN - 1
    q = randn(B * H, 1, D)
    k, v = randn(B, T, H, D), randn(B, T, H, D)
    shape = f"B{B} T{T} KV{H} G1 D{D} cur{n}"
    before = dict(build.VARIANTS)
    got = KD.vwr_flash_decode(q, k, v, n)
    torch.cuda.synchronize()
    _served("vwr_flash_decode", shape, before, build, "split")
    err = compare("vwr_flash_decode", shape, f32, got,
                  KD.vwr_flash_decode_ref(q, k, v, n))
    _bitwise("vwr_flash_decode", shape, got, KD.vwr_flash_decode(q, k, v, n))
    qs = q.reshape(B, H, 1, D)
    ks, vs = (t[:, :n].transpose(1, 2) for t in (k, v))
    record("vwr_flash_decode", "zamba2 decode", shape, bf16, err,
           lambda: KD.vwr_flash_decode(q, k, v, n),
           lambda: KD.vwr_flash_decode_ref(q, k, v, n),
           lambda: F.scaled_dot_product_attention(qs, ks, vs),
           4 * B * H * D * n,
           2 * (B * H * D + 2 * B * n * H * D) + 4 * B * H * (D + 2))
    record.rows[-1]["plan"] = list(KD.decode_plan(B * H, n))


# ----------------------------------------------------------------------
# kernels 16 and 17: the paper's CNN layers (phase 2 and phase 9)
# ----------------------------------------------------------------------

# the paper's one image, and a batch of 32
CNN_BATCHES = (1, 32)
# the headline cases of the {"kernels"} line
CNN_HEADLINE = {"vwr_conv2d": ("RN_56x56", 32, "bfloat16"),
                "vwr_depthwise": ("MN_56x56", 32, "bfloat16")}


def _cnn_layers():
    """The provet_cnn suite's layers the kernels take (stride 1) and the
    ones they do not (RN_112x112 at stride 2, AN_55x55 at stride 4)."""
    from repro_torch.configs import provet_cnn

    return ([l for l in provet_cnn.LAYERS if l.stride == 1],
            [l for l in provet_cnn.LAYERS if l.stride != 1])


def _conv_operands(torch, gen, n, H, W, C, n_out, KH, KW, dt, bias=True,
                   depthwise=False):
    """x (n, H, W, C), w (KH, KW, C[, n_out]) scaled by 1/sqrt(fan-in),
    and a bias (n_out,) (None for depthwise or ``bias=False``)."""
    x = torch.randn(n, H, W, C, generator=gen, device="cuda").to(dt)
    if depthwise:
        w = torch.randn(KH, KW, C, generator=gen, device="cuda")
        return x, (w / (KH * KW) ** 0.5).to(dt), None
    w = torch.randn(KH, KW, C, n_out, generator=gen, device="cuda")
    b = (torch.randn(n_out, generator=gen, device="cuda") * 0.1).to(dt)
    return x, (w / (KH * KW * C) ** 0.5).to(dt), (b if bias else None)


def _conv_work(x, w, bias, act, depthwise=False):
    """(operations, bytes) of one conv: a multiply and an add a tap of
    each output (KH*KW*C taps, KH*KW depthwise), the bias and the
    activation one operation an output each; x, w, bias and the output
    moved once each."""
    N, H, W, C = x.shape
    KH, KW = w.shape[:2]
    outs = N * (H - KH + 1) * (W - KW + 1) * (C if depthwise else w.shape[3])
    ops_ = 2 * outs * KH * KW * (1 if depthwise else C)
    ops_ += outs * ((bias is not None) + (act is not None))
    nbytes = x.element_size() * (x.numel() + w.numel() + outs + (
        0 if bias is None else bias.numel()))
    return ops_, nbytes


def _cudnn(torch, F, x, w, bias, depthwise=False):
    """The library yardstick: one cuDNN ``F.conv2d`` on channels-last
    views of x (no copy) and of the weights (reformatted once, outside
    the timed call), with the bias; ``groups=C`` for depthwise."""
    xl = x.permute(0, 3, 1, 2)
    if depthwise:
        wl = w.permute(2, 0, 1).unsqueeze(1).contiguous(
            memory_format=torch.channels_last)
        return lambda: F.conv2d(xl, wl, groups=x.shape[3])
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(xl, wl, bias)


# the wgmma conv's plans: the rule's plan (first) against others of the
# same form at these layers (label, N, H, W, C, F, K)
CONV_PLAN_SHAPES = (("RN_56x56 N32", 32, 58, 58, 64, 64, 3),
                    ("RN_28x28 N32", 32, 30, 30, 128, 128, 3),
                    ("RN_14x14 N32", 32, 16, 16, 256, 256, 3),
                    ("RN_7x7 N32", 32, 9, 9, 512, 512, 3),
                    ("AN_27x27 N32", 32, 31, 31, 96, 256, 5),
                    ("RN_7x7 N1", 1, 9, 9, 512, 512, 3),
                    ("RN_28x28 N1", 1, 30, 30, 128, 128, 3),
                    ("AN_27x27 N1", 1, 31, 31, 96, 256, 5))


def _dw_alt_plans(K17, N, H, W, C):
    """dw_plan's (cb, sh, tw) first, then its cb and tw with strips of 4,
    8, 16, 32 rows or the whole height, and its sh with the other channel
    blocks (the widest column tiles their threads allow)."""
    cb, sh, tw = own = K17.dw_plan(N, H, W, C, 3, 3)
    Ho, Wo = H - 2, W - 2
    alts = [(cb, min(r, Ho), tw) for r in (4, 8, 16, 32, Ho)]
    for c in K17.DW_CBS:
        if c < 8 * -(-C // 8) and c != cb:
            tiles = -(-Wo // (K17.DW_THREADS // (c // 8)))
            alts.append((c, sh, -(-Wo // tiles)))
    return [own] + [p for p in dict.fromkeys(alts) if p != own]


def check_conv_kernels(torch, F, gen, compare, record):
    """Kernels 16 (vwr_conv2d) and 17 (vwr_depthwise) against their plain
    versions: the JAX tests' ragged shapes (C 7 / 3, F 5 / 9, a 1x1 and a
    5x5 conv), H_out and W_out off the tile, every epilogue with and
    without bias, in bf16 and fp32; the edges of kernel 16's wgmma
    variant (a ragged 64-channel slice, row tiles across images, 1x1 and
    5x5 taps, K split unevenly), each bitwise equal over two launches;
    then every stride-1 layer of the provet_cnn suite at N 1 and 32, bf16
    and fp32 (conv with bias + relu), each timed beside its bound, its
    plain version and cuDNN, with the variant that served it; and the
    wgmma plans behind the split rule."""
    from repro_torch.kernels import autotune, build
    from repro_torch.kernels import vwr_conv2d as K16
    from repro_torch.kernels import vwr_depthwise as K17

    f32, bf16 = torch.float32, torch.bfloat16

    def conv(x, w, b, act, plan=None):
        """One launch through the wrapper (or of ``plan``, forced), the
        variant that served it, and for wgmma a second launch that must
        equal the first bit for bit."""
        before = dict(build.VARIANTS)
        out = (K16.vwr_conv2d(x, w, b, activation=act) if plan is None
               else K16.launch(x, w, b, act, "wgmma", plan))
        torch.cuda.synchronize()
        served = [k[len("vwr_conv2d."):] for k, n in build.VARIANTS.items()
                  if k.startswith("vwr_conv2d.") and n != before[k]]
        N, H, W, C = x.shape
        KH, KW, _, Fo = w.shape
        want = ("wgmma" if plan is not None
                else K16.variant(N, H, W, C, KH, KW, Fo, x.dtype, True))
        if served != [want]:
            raise AssertionError(f"vwr_conv2d {tuple(x.shape)}: the rule "
                                 f"picks {want}, the wrapper launched "
                                 f"{served}")
        if want == "wgmma":
            again = (K16.vwr_conv2d(x, w, b, activation=act) if plan is None
                     else K16.launch(x, w, b, act, "wgmma", plan))
            if not torch.equal(out, again):
                raise AssertionError(f"vwr_conv2d wgmma {tuple(x.shape)}: "
                                     "two launches differ")
        return out, want

    print("vwr_conv2d")
    conv_edges = [
        # label, N, H, W, C, F, KH, KW, bias, activation, dtypes, plan
        ("3x3", 1, 9, 9, 8, 8, 3, 3, True, "relu", (f32, bf16), None),
        ("C 7 F 5", 2, 13, 11, 7, 5, 3, 3, True, "gelu", (f32, bf16), None),
        ("1x1, bias only", 1, 8, 8, 4, 16, 1, 1, True, None, (f32, bf16),
         None),
        ("5x5 C 3 F 9, no bias", 2, 12, 10, 3, 9, 5, 5, False, "relu",
         (f32, bf16), None),
        ("H_out 13 W_out 19", 2, 15, 21, 24, 70, 3, 3, True, "silu",
         (f32, bf16), None),
        ("F 130, no bias or act", 1, 10, 40, 64, 130, 3, 3, False, None,
         (f32, bf16), None),
        ("gelu, no bias", 1, 11, 18, 16, 24, 3, 3, False, "gelu",
         (f32, bf16), None),
        ("silu, no bias", 1, 11, 18, 16, 24, 3, 3, False, "silu",
         (f32, bf16), None),
        ("7x7 C 3, W_out 37", 1, 43, 43, 3, 64, 7, 7, True, "relu",
         (f32, bf16), None),
        # the wgmma variant's edges
        ("C 96: a ragged 64-channel slice", 2, 9, 9, 96, 64, 3, 3, True,
         "gelu", (bf16,), None),
        ("N 3, W_out 7: row tiles across images", 3, 9, 9, 64, 128, 3, 3,
         False, "silu", (bf16,), None),
        ("N 3, W_out 13", 3, 15, 15, 32, 64, 3, 3, True, None, (bf16,),
         None),
        ("1x1 on wgmma", 2, 8, 8, 64, 64, 1, 1, True, "relu", (bf16,), None),
        ("5x5 on wgmma", 1, 12, 12, 32, 64, 5, 5, False, None, (bf16,),
         None),
        ("F 192 C 8", 1, 10, 10, 8, 192, 3, 3, True, "relu", (bf16,), None),
        ("K split unevenly: 72 steps in 5 x 15", 1, 9, 9, 512, 512, 3, 3,
         True, "relu", (bf16,), (64, 64, 5, 15)),
        ("128-row tiles, 3 splits", 1, 9, 9, 512, 512, 3, 3, True, "relu",
         (bf16,), (128, 128, 3, 24)),
    ]
    for label, N, H, W, C, Fo, KH, KW, has_b, act, dts, plan in conv_edges:
        for dt in dts:
            x, w, b = _conv_operands(torch, gen, N, H, W, C, Fo, KH, KW, dt,
                                     bias=has_b)
            got, kind = conv(x, w, b, act, plan)
            compare(f"vwr_conv2d {kind}", f"{label} {act or ''}", dt, got,
                    K16.vwr_conv2d_ref(x, w, b, activation=act))
    def depthwise(x, w, plan=None):
        """One launch through the wrapper (or of the stream kernel with
        ``plan``, forced) and the variant that served it, which must be
        the one ``dw_variant`` names."""
        before = dict(build.VARIANTS)
        out = (K17.vwr_depthwise(x, w) if plan is None
               else K17.dw_launch(x, w, "stream", plan))
        torch.cuda.synchronize()
        want = ("stream" if plan is not None
                else K17.dw_variant(x.shape[3], *w.shape[:2]))
        _served("vwr_depthwise", tuple(x.shape), before, build, want)
        return out, want

    print("vwr_depthwise")
    dw_edges = [
        # label, N, H, W, C, K, plan (stream only; None: the rule's)
        ("3x3 C 8", 1, 10, 10, 8, 3, None),
        ("C 16, H_out 10 W_out 7", 2, 12, 9, 16, 3, None),
        ("5x5 C 4", 1, 9, 9, 4, 5, None),
        ("C 70 (past a 64-channel block, not 8-aligned)", 2, 13, 21, 70, 3,
         None),
        ("C 3, 7x7", 1, 20, 30, 3, 7, None),
        # the stream kernel's edges: a ragged channel block, strip and
        # column tile, whole-height strips, one output pixel
        ("stream: C 24 in 16s, 28 rows in 5s, 39 columns in 12s", 3, 30, 41,
         24, 3, (16, 5, 12)),
        ("stream: C 40 in 32s, W_out 73 in two tiles", 2, 20, 75, 40, 3,
         (32, 6, 37)),
        ("stream: MN_56x56 N1, whole-height strips", 1, 58, 58, 128, 3,
         (64, 56, 28)),
        ("stream: one output pixel", 2, 3, 3, 8, 3, None),
    ]
    for label, N, H, W, C, K, plan in dw_edges:
        for dt in (f32, bf16):
            x, w, _ = _conv_operands(torch, gen, N, H, W, C, C, K, K, dt,
                                     depthwise=True)
            got, kind = depthwise(x, w, plan)
            compare(f"vwr_depthwise {kind}", label, dt, got,
                    K17.vwr_depthwise_ref(x, w))

    covered, _ = _cnn_layers()
    for layer in covered:
        dw = layer.depthwise
        kname = "vwr_depthwise" if dw else "vwr_conv2d"
        print(f"{kname} {layer.name}")
        for n in CNN_BATCHES:
            for dt in (bf16, f32):
                x, w, b = _conv_operands(
                    torch, gen, n, layer.H_in, layer.W_in, layer.C_in,
                    layer.C_out, layer.K, layer.K, dt, depthwise=dw)
                act = None if dw else "relu"
                if dw:
                    fn = (lambda x=x, w=w: K17.vwr_depthwise(x, w))
                    plain = (lambda x=x, w=w: K17.vwr_depthwise_ref(x, w))
                    got, kind = depthwise(x, w)
                else:
                    fn = (lambda x=x, w=w, b=b:
                          K16.vwr_conv2d(x, w, b, activation="relu"))
                    plain = (lambda x=x, w=w, b=b:
                             K16.vwr_conv2d_ref(x, w, b, activation="relu"))
                    got, kind = conv(x, w, b, "relu")
                shape = (f"N{n} {layer.H_in}x{layer.W_in}x{layer.C_in}"
                         + ("" if dw else f" F{layer.C_out}")
                         + f" {layer.K}x{layer.K}"
                         + ("" if dw else " +bias+relu"))
                err = compare(f"{kname} {kind}", f"{layer.name} N{n}", dt,
                              got, plain())
                head = CNN_HEADLINE[kname] == (layer.name, n, str(dt)[6:])
                library = _cudnn(torch, F, x, w, b, depthwise=dw)
                if head:
                    # the yardstick computes the same function (the relu
                    # aside, which it leaves out)
                    lib = library()
                    lib = lib if dw else torch.relu(lib.float()).to(dt)
                    compare(f"{kname} (cuDNN)", layer.name, dt,
                            lib.permute(0, 2, 3, 1), got)
                flops, nbytes = _conv_work(x, w, b, act, depthwise=dw)
                # depthwise has no product to put on the tensor cores:
                # its operations are fp32 FMAs whatever the input type
                record(kname, f"{layer.name} N{n}", shape, dt, err, fn,
                       plain, library, flops, nbytes, head,
                       op_dtype=f32 if dw else None)
                if kind:
                    row = record.rows[-1]
                    row["variant"] = kind
                    if kind == "wgmma":
                        row["plan"] = autotune.conv_plan(x, w, b, "relu")
                    elif kind == "stream":
                        row["plan"] = K17.dw_plan(*x.shape, *w.shape[:2])
                    print(f"      variant {kind}"
                          + (f", plan {row['plan']}" if "plan" in row
                             else ""))

    # the plans behind the split rule: (bm, bn, nsplit, kt_split)
    print("  vwr_conv2d wgmma plans (ms; (bm, bn, nsplit, kt_split)), the "
          "tile kernel and cuDNN:")
    for label, N, H, W, C, Fo, KH in CONV_PLAN_SHAPES:
        x, w, b = _conv_operands(torch, gen, N, H, W, C, Fo, KH, KH, bf16)
        row = {"kernel": "vwr_conv2d plans", "case": label, "plans": []}
        for p in autotune.conv_candidates(N, H, W, C, KH, KH, Fo):
            ms = time_ms(torch, lambda p=p: K16.launch(x, w, b, "relu",
                                                       "wgmma", p))
            row["plans"].append({"plan": p, "ms": ms})
        row["tile_ms"] = time_ms(torch, lambda: K16.launch(x, w, b, "relu",
                                                           "tile"))
        row["library_ms"] = time_ms(torch, _cudnn(torch, F, x, w, b))
        best = min(row["plans"], key=lambda q: q["ms"])
        record.rows.append(row)
        print(f"    {label}: rule {row['plans'][0]['plan']} "
              f"{row['plans'][0]['ms']:.4f}, best {best['plan']} "
              f"{best['ms']:.4f} of {len(row['plans'])}; tile "
              f"{row['tile_ms']:.4f}; cuDNN {row['library_ms']:.4f}")

    # the stream kernel's plans: (cb, sh, tw)
    print("  vwr_depthwise stream plans (ms; (cb, sh, tw)), the tile "
          "kernel and cuDNN:")
    for layer in (l for l in covered if l.depthwise):
        for n, dt in ((32, bf16), (32, f32), (1, bf16)):
            x, w, _ = _conv_operands(torch, gen, n, layer.H_in, layer.W_in,
                                     layer.C_in, layer.C_in, 3, 3, dt,
                                     depthwise=True)
            row = {"kernel": "vwr_depthwise plans",
                   "case": f"{layer.name} N{n} {str(dt)[6:]}", "plans": []}
            for p in _dw_alt_plans(K17, *x.shape):
                ms = time_ms(torch, lambda p=p: K17.dw_launch(x, w, "stream",
                                                              p))
                row["plans"].append({"plan": p, "ms": ms})
            row["tile_ms"] = time_ms(torch, lambda: K17.dw_launch(x, w,
                                                                  "tile"))
            row["library_ms"] = time_ms(torch, _cudnn(torch, F, x, w, None,
                                                      depthwise=True))
            best = min(row["plans"], key=lambda q: q["ms"])
            record.rows.append(row)
            print(f"    {row['case']}: rule {row['plans'][0]['plan']} "
                  f"{row['plans'][0]['ms']:.4f}, best {best['plan']} "
                  f"{best['ms']:.4f} of {len(row['plans'])}; tile "
                  f"{row['tile_ms']:.4f}; cuDNN {row['library_ms']:.4f}")


def _paged_table(torch, gen, lens, J, ps, n_pages):
    """A block table of randomly permuted physical pages for each slot's
    live pages, zero past them, and its (B, J) counts; plus the number
    of live pages."""
    import numpy as np

    B = len(lens)
    perm = torch.randperm(n_pages, generator=gen, device="cuda").cpu()
    table = np.zeros((B, J), np.int32)
    counts = np.zeros((B, J), np.int32)
    k = 0
    for b, n in enumerate(lens):
        live = -(-n // ps)
        table[b, :live] = perm[k:k + live].numpy()
        counts[b, :live] = np.clip(n - ps * np.arange(live), 0, ps)
        k += live
    return (torch.from_numpy(table).cuda(), torch.from_numpy(counts).cuda(),
            k)


def _chunk_sdpa(torch, F, q, pools, scales, table, counts):
    """The library yardstick of a chunk-prefix partial: gather the prior
    pages into a dense (KV, T, D) prefix (dequantized for int8) and run
    SDPA with each KV head's C*G query rows, the counts as the mask."""
    J = table.shape[0]
    n_pages, ps, KV, D = pools[0].shape
    idx = table.long().clamp(0, n_pages - 1)
    mask = (torch.arange(ps, device="cuda")[None, :]
            < counts[:, None]).reshape(1, 1, 1, J * ps)

    def run():
        kv = []
        for i, pool in enumerate(pools):
            x = pool[idx]                          # (J, ps, KV, D)
            if scales:
                x = x.to(q.dtype) * scales[i][idx][:, None, :, None].to(
                    q.dtype)
            kv.append(x.reshape(1, J * ps, KV, D).transpose(1, 2))
        return F.scaled_dot_product_attention(q[None], kv[0], kv[1],
                                              attn_mask=mask)
    return run


def _paged_sdpa(torch, F, q, pools, scales, table, counts, KV, G, D):
    """The library yardstick of a paged decode: gather each slot's
    pages into a dense (B, KV, T, D) cache (dequantized for int8) and
    run SDPA with the G query heads of a KV head as its query rows and
    the counts as the mask."""
    B, J = table.shape
    ps = pools[0].shape[1]
    idx = table.long()
    mask = (torch.arange(ps, device="cuda")[None, None, :]
            < counts[..., None]).reshape(B, 1, 1, J * ps)
    qs = q.reshape(B, KV, G, D)

    def run():
        kv = []
        for i, pool in enumerate(pools):
            x = pool[idx]                          # (B, J, ps, KV, D)
            if scales:
                x = (x.to(q.dtype)
                     * scales[i][idx][:, :, None, :, None].to(q.dtype))
            kv.append(x.reshape(B, J * ps, KV, D).transpose(1, 2))
        return F.scaled_dot_product_attention(qs, kv[0], kv[1],
                                              attn_mask=mask)
    return run


# ----------------------------------------------------------------------
# phases 3-4: serving end to end
# ----------------------------------------------------------------------

def serve(torch, name, gen, expected_launches, expected_variants,
          kernel9=False):
    """Full-width generate on the kernels (launches counted, and
    ``vwr_matmul``'s and ``vwr_swiglu``'s per variant), then the
    same token stream teacher-forced through the plain backend; with
    ``kernel9``, kernel 9 over the kernel path's dense cache after the
    stream (``dense_kernel9``)."""
    from repro_torch.common.module import leaves
    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, EngineConfig
    from repro_torch.kernels import build

    cfg = get_config(name)
    B, P = 4, 128
    ecfg = EngineConfig(batch=B, max_len=P + gen, kernel_impl="cuda")
    t0 = time.perf_counter()
    eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
    _condition(torch, eng.params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in leaves(eng.params))
    print(f"{name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.dtype}, {n_params / 1e9:.3f} B params "
          f"({time.perf_counter() - t0:.1f} s to init)")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=g,
                            device="cuda", dtype=torch.int32)

    # one warm-up generate at the same shapes, so the timed one below
    # finds the allocator's pools and the kernels' first launches done
    eng.generate({"tokens": prompts}, gen=gen)
    build.reset_launches()
    m0 = _tuner_misses()
    tokens, stats = eng.generate({"tokens": prompts}, gen=gen)
    torch.cuda.synchronize()
    misses = _window_misses(f"{name} generate", m0)
    launches = dict(build.LAUNCHES)
    variants = {k: n for k, n in build.VARIANTS.items()
                if k.startswith(("vwr_matmul.", "vwr_swiglu.",
                                 "vwr_flash_decode."))}
    print(f"  launches in generate: {launches}")
    print(f"  vwr_matmul / vwr_swiglu / vwr_flash_decode by variant: "
          f"{variants}")
    for k, n in {**expected_launches, **expected_variants}.items():
        got = launches[k] if k in launches else variants[k]
        if got != n:
            raise AssertionError(f"{name}: {k} launched {got} times, "
                                 f"expected {n}")
    if tokens.shape != (B, gen) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"{name}: bad tokens {tokens.shape}")
    print(f"  prefill_tok_s {stats['prefill_tok_s']:.1f}  decode_tok_s "
          f"{stats['decode_tok_s']:.1f}  (t_prefill {stats['t_prefill_s']:.4f}"
          f" s, t_decode {stats['t_decode_s']:.4f} s)")

    ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                       params=eng.params, device="cuda")
    rel, cache = _teacher_forced(torch, eng, ref, prompts, tokens, P, gen,
                                 check_greedy=True)
    worst = max(rel)
    print(f"  teacher-forced logits vs plain path: max |d|/max|ref| "
          f"{worst:.3e} over {len(rel)} steps (limit {E2E_BF16_REL:g})")
    if not worst <= E2E_BF16_REL:
        raise AssertionError(f"{name}: logits diverge from the plain path")
    k9 = dense_kernel9(torch, cfg, cache, P + gen - 1) if kernel9 else None
    del eng, ref, cache
    torch.cuda.empty_cache()
    return {"arch": name, "batch": B, "prompt": P, "gen": gen,
            "n_params": n_params, "launches": launches,
            "matmul_variants": variants, "logits_rel_err": rel, "kernel9": k9,
            "tuner_misses": misses, **stats}


def dense_kernel9(torch, cfg, cache, cur_len):
    """Kernel 9 through ``dist.decode.local_decode_attend`` with scales,
    over the dense K/V cache the teacher-forced stream left behind,
    quantized one scale a (batch, KV head) row, against the plain
    dequantize-then-attend op on the same int8 cache; launches counted
    (one a layer)."""
    from repro_torch.dist import decode as DD
    from repro_torch.kernels import build
    from repro_torch.kernels.quant import int8_scale

    g = torch.Generator(device="cuda").manual_seed(12)
    atol, rtol = TOL["float32"]
    work = []
    for i in range(cache["k"].shape[0]):
        q8, sc = [], []
        for x in (cache["k"][i], cache["v"][i]):       # (B, T, KV, D)
            s = int8_scale(x.float().abs().amax(dim=(1, 3)))    # (B, KV)
            q8.append(torch.clamp(torch.round(x.float() / s[:, None, :,
                                                            None]),
                                  -127, 127).to(torch.int8))
            sc.append(s)
        B = q8[0].shape[0]
        q = torch.randn(B, cfg.n_heads, cfg.d_head, generator=g,
                        device="cuda").to(cache["k"].dtype)
        work.append((q, q8, sc))
    torch.cuda.synchronize()
    build.reset_launches()
    got = [DD.local_decode_attend(q, *q8, cur_len, k_scale=sc[0],
                                  v_scale=sc[1], backend="cuda")
           for q, q8, sc in work]
    torch.cuda.synchronize()
    launches = build.LAUNCHES["vwr_flash_decode_q8"]
    err = 0.0
    for (q, q8, sc), x in zip(work, got):
        want = DD.local_decode_attend(q.float(), *q8, cur_len,
                                      k_scale=sc[0], v_scale=sc[1],
                                      backend="torch")
        # the kernel path returns the queries' bf16: one rounding more
        d = (x.float() - want).abs()
        err = max(err, d.max().item())
        atol_, rtol_ = TOL["bfloat16"] if x.dtype == torch.bfloat16 \
            else (atol, rtol)
        if not bool((d <= atol_ + rtol_ * want.abs()).all()):
            raise AssertionError("kernel 9 disagrees with "
                                 "dequantize-then-attend")
    split = build.VARIANTS["vwr_flash_decode_q8.split"]
    print(f"  kernel 9 over the int8 dense cache of the stream "
          f"({len(work)} layers, cur_len {cur_len}): max|err| {err:.3e}, "
          f"{launches} launches ({split} on the split variant)")
    if launches != len(work):
        raise AssertionError(f"kernel 9 launched {launches} times")
    if split != launches:
        raise AssertionError("kernel 9 on bf16 queries must run its split "
                             "variant")
    return {"layers": len(work), "max_abs_err": err, "launches": launches,
            "split": split}


# projections rescaled by ``_condition``: GQA's, the MLPs' and experts',
# the unembedding, MLA's, and the Mamba2 / mLSTM blocks' in and out
# projections (HF Zamba2's Linear init is std 0.02 too)
PROJECTIONS = ("wq", "wk", "wv", "wo", "wi", "wg", "w", "wq_a", "wq_b",
               "wkv_a", "wk_b", "wv_b", "in_proj", "out_proj")
# Mamba2's time steps at init, log-uniform (mamba_ssm's and HF Zamba2's
# time_step_min / time_step_max)
DT_RANGE = (1e-3, 1e-1)


def _std(torch, t, chunk=1 << 24):
    """The standard deviation of ``t``, summed in fp64 over slices of
    ``chunk`` elements: no fp32 copy of a whole (15 GB) expert stack."""
    flat = t.reshape(-1)
    n = flat.numel()
    s = torch.zeros((), dtype=torch.float64, device=t.device)
    s2 = torch.zeros_like(s)
    for i in range(0, n, chunk):
        c = flat[i:i + chunk].double()
        s += c.sum()
        s2 += c.square().sum()
    return ((s2 - s * s / n) / (n - 1)).sqrt().item()


def _condition(torch, params):
    """Rescale random weights to a well-conditioned model, in place.

    The JAX package's fan-in init (mirrored by ``init_params``) takes
    ``shape[-2]`` as the fan-in, which for ``wq``/``wk``/``wv``
    ``(d, H, Dh)`` — and MLA's ``wq_b``/``wk_b``/``wv_b`` ``(rank, H,
    Dh)`` — is the head count: q and k come out with stds of ~8-20,
    attention is close to a hard argmax and the residual stream grows
    layer by layer, so 1-ulp bf16 differences flip attention choices
    and no two rounding orders agree after 22 layers.  Every projection
    is rescaled to std 0.02 (HF Llama's initializer_range) and the QKV
    biases drawn at std 0.02, so the fused bias is not a sum of
    zeros.  Mamba2's ``dt_bias`` is drawn as mamba_ssm and HF Zamba2
    initialize it, softplus^-1 of time steps log-uniform in
    ``DT_RANGE``: the JAX init's constant 0.5 gives steps of ~1, whose
    sums over a 256-token chunk spread a block's output over so wide a
    range that the bf16 rounding of its inputs alone moves it far from
    its fp32 value (phase 6d's block-by-block gaps)."""
    import math

    from repro_torch.common.module import leaves

    g = torch.Generator(device="cuda").manual_seed(3)
    lo, hi = (math.log(v) for v in DT_RANGE)
    for path, t in leaves(params):
        if path[-1] in PROJECTIONS:
            t.mul_(0.02 / _std(torch, t))
        elif path[-1] in ("bq", "bk", "bv"):
            t.copy_(torch.randn(t.shape, generator=g, device=t.device)
                    * 0.02)
        elif path[-1] == "dt_bias":
            dt = torch.exp(torch.rand(t.shape, generator=g, device=t.device)
                           * (hi - lo) + lo)
            t.copy_(dt + torch.log(-torch.expm1(-dt)))


def _decode(eng, tok, pos, cache):
    table = eng.default_block_table() if eng.ecfg.paged else None
    return eng.decode_step(tok, pos, cache, block_table=table)


def _teacher_forced(torch, eng, ref, prompts, tokens, P, gen,
                    check_greedy=False, atol=None):
    """Per-step max |logits error| of ``eng`` against ``ref`` on one
    stream, relative to max|ref|; with ``atol``, absolute, and raising
    past ``atol`` times the logits' scale (max|ref|, at least 1).
    ``prompts``: the prompt tokens, or the prefill batch (with the
    frontend families' ``frontend_emb``); ``P`` the positions the
    prefill occupies.  Returns the errors and ``eng``'s dense cache after
    the stream."""
    out = []
    vocab = eng.cfg.vocab
    batch = prompts if isinstance(prompts, dict) else {"tokens": prompts}
    lc, cc = eng.prefill(batch)
    lr, cr = ref.prefill(batch)
    for i in range(gen):
        if check_greedy and not bool(
                (lc.argmax(-1).to(torch.int32) == tokens[:, i]).all()):
            raise AssertionError(f"step {i}: the kernel path is not "
                                 "deterministic (replay != generate)")
        d = (lc - lr)[:, :vocab]           # padded vocab columns are -1e30
        err, scale = d.abs().max().item(), lr[:, :vocab].abs().max().item()
        if atol is not None:
            if not err <= atol * max(1.0, scale):
                raise AssertionError(f"step {i}: max|d| {err} past "
                                     f"{atol} x {max(1.0, scale)}")
            out.append(err)
        else:
            out.append(err / scale)
        if i + 1 < gen:
            tok = tokens[:, i]
            lc, cc = _decode(eng, tok, P + i, cc)
            lr, cr = _decode(ref, tok, P + i, cr)
    return out, cc


def _reduced(name):
    """``reduced(name)`` as the CPU tests run it: head dim 16 and, for MLA,
    latent rank 16 and rope width 8, which the kernel wrappers zero-pad to
    the kernels' widths on each call."""
    from repro_torch.configs import get_config, reduced

    return reduced(get_config(name))


def serve_reduced_fp32(torch, name):
    """Reduced fp32 config on the card: kernel path against the plain
    path at the Pallas-vs-XLA tolerance, greedy streams identical; kernel
    4 (where the family decodes through it) on its FMA kernel.  The
    frontend families take random embeddings: the vlm's frontend tokens
    ahead of the prompt, 23 encoder frames for audio.  The recurrent
    families' prompts are 32 tokens (two chunks of 16: a prompt must be
    a multiple of the chunk), the others' 31."""
    from repro_torch.engine import DecodeEngine, EngineConfig
    from repro_torch.kernels import build
    from repro_torch.models import lm

    cfg = _reduced(name)
    n_front = cfg.frontend_tokens if cfg.family == "vlm" else 0
    ecfg = EngineConfig(batch=2, max_len=40 + n_front, kernel_impl="cuda")
    eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
    ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                       params=eng.params, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    P = 32 if lm.ssm_decode_supported(cfg) else 31
    prompts = torch.randint(0, cfg.vocab, (2, P), generator=g,
                            device="cuda", dtype=torch.int32)
    batch = {"tokens": prompts}
    if cfg.frontend:
        batch["frontend_emb"] = torch.randn(
            2, n_front or 23, cfg.frontend_dim, generator=g, device="cuda")
    build.reset_launches()
    tok_c, _ = eng.generate(batch, gen=9)
    torch.cuda.synchronize()
    if build.VARIANTS["vwr_flash_decode.split"]:
        raise AssertionError(f"{name} reduced fp32: kernel 4 must keep its "
                             "FMA kernel on fp32 caches")
    tok_r, _ = ref.generate(batch, gen=9)
    if not bool((tok_c == tok_r).all()):
        raise AssertionError(f"{name} reduced fp32: greedy streams differ")
    err, _ = _teacher_forced(torch, eng, ref, batch, tok_c,
                             eng.prefill_len(batch), 9, atol=E2E_FP32_TOL)
    print(f"  {cfg.name} fp32: max|d logits| {max(err):.3e} "
          f"(limit {E2E_FP32_TOL:g} x max(1, max|logits|)), greedy tokens "
          "identical")
    return max(err)


# ----------------------------------------------------------------------
# phases 5-6: continuous batching on the paged pools
# ----------------------------------------------------------------------

# the Scheduler stream: 24 requests with seeded prompt lengths in
# 32-256 and gen 32; 8 submitted at once, then 2 more every 4 steps,
# over 8 slots and 128 pages of 16 (fewer than 8 long requests need,
# so growth can preempt)
N_REQ, FIRST, EVERY, BURST, GEN = 24, 8, 4, 2, 32
PROMPT = (32, 256)
SLOTS, PAGE, N_PAGES = 8, 16, 128
# the full pool never runs dry on this stream (admission waits for
# pages, and 32 tokens grow a request by at most 2 pages); the same
# stream again with this many pages held (``faults.hold_pages``) does,
# so growth preempts at full width
HELD = 40
# the teacher-forced replay runs the same kernels on the same rows as
# the served stream, but its table width and slot mates differ, so the
# partials may round differently and a near-tie flip a greedy pick:
# at least this share of the replayed steps must pick the served token
REPLAY_AGREE = 0.95
# the int8 prefix + chunked stream reads each prefix through quantized
# pages where the replay's whole-prompt prefill reads it in full
# precision, so more near-ties flip: 236/256 steps agreed on an NVIDIA
# H100 80GB HBM3 at 700 W, and this floor leaves room for 5 more flips
REPLAY_AGREE_Q8 = 0.9


def _requests(cfg, n, prompt, gen, seed):
    import numpy as np

    from repro_torch.engine import Request

    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt[0], prompt[1] + 1, n)
    return [Request(rid=i, tokens=rng.integers(0, cfg.vocab, int(p))
                    .astype(np.int32), gen=gen)
            for i, p in enumerate(lens)]


def _drive(sched, reqs):
    """Submit FIRST requests, then BURST more every EVERY steps (or at
    once when the scheduler runs dry), and step until all are done.  Every
    round admits or advances a live request by a token or a chunk unless
    the Scheduler stalls (work held, none admitted or stepped), so twice
    the stream's prompt and generated tokens bound the rounds: past that
    the stall raises with the Scheduler's state instead of spinning."""
    k = min(FIRST, len(reqs))
    for r in reqs[:k]:
        sched.submit(r)
    next_at = EVERY
    cap = 2 * sum(len(r.tokens) + r.gen + 1 for r in reqs)
    rounds = 0
    while (k < len(reqs) or sched.pending or sched.parked
           or sched.n_active):
        rounds += 1
        if rounds > cap:
            raise AssertionError(
                f"the Scheduler stalled: {rounds - 1} rounds (cap {cap}) "
                f"for {len(reqs)} requests, {k} submitted; steps "
                f"{sched.stats['steps']}, pending {len(sched.pending)}, "
                f"parked {len(sched.parked)}, active {sched.n_active}, "
                f"free pages {sched.allocator.free_pages}")
        idle = not (sched.n_active or sched.pending or sched.parked)
        if k < len(reqs) and (sched.stats["steps"] >= next_at or idle):
            for r in reqs[k:k + BURST]:
                sched.submit(r)
            k += BURST
            next_at += EVERY
        sched.admit()
        sched.step()
    return sched.results()


def _swiglu_variants(torch, what, L, prefills, steps, passes=None):
    """``vwr_swiglu``'s launches by variant over a Scheduler stream (the
    counts since the last reset), held: every whole-prompt prefill (or,
    with chunks or suffixes, every pass of them: ``passes``) and every
    decode step on the wgmma tiles, L launches each.  Returns the
    counts."""
    from repro_torch.kernels import build

    got = {k: n for k, n in build.VARIANTS.items()
           if k.startswith("vwr_swiglu.")}
    print(f"    vwr_swiglu by variant: {got}")
    runs = (prefills if passes is None else passes) + steps
    want = {"vwr_swiglu.wgmma": L * runs, "vwr_swiglu.gemm": 0}
    if got != want:
        raise AssertionError(f"{what}: vwr_swiglu by variant {got}, "
                             f"expected {want}")
    return got


def _paged_variants(what, kv_dtype, launches):
    """Kernels 5 and 7's launches by variant over a stream (the counts
    since the last reset), held: every one of the ``launches`` on the mma
    variant, kernel 5's on bf16 pools, kernel 7's on int8 pools, and the
    other kernel none.  Returns the counts."""
    from repro_torch.kernels import build

    got = {k: n for k, n in build.VARIANTS.items()
           if k.startswith("vwr_paged_flash_decode")}
    q8 = kv_dtype == "int8"
    want = {"vwr_paged_flash_decode.mma": 0 if q8 else launches,
            "vwr_paged_flash_decode.fma": 0,
            "vwr_paged_flash_decode_q8.mma": launches if q8 else 0,
            "vwr_paged_flash_decode_q8.fma": 0}
    if got != want:
        raise AssertionError(f"{what}: vwr_paged_flash_decode[_q8] by "
                             f"variant {got}, expected {want}")
    return got


def serve_scheduler(torch, kv_dtype, params=None):
    """Full-width tinyllama-1.1b through the Scheduler on the kernels:
    the stream above, launch counts checked, the stream again with
    pages held so that growth preempts, then finished requests replayed
    teacher-forced through the engine's slots and held against the
    plain path (``_replay_slots``)."""
    from repro_torch.common.module import leaves
    from repro_torch.configs import get_config
    from repro_torch.engine import (DecodeEngine, EngineConfig,
                                    RequestStatus, Scheduler)
    from repro_torch.kernels import build

    cfg = get_config("tinyllama-1.1b")
    ecfg = EngineConfig(batch=SLOTS, max_len=PROMPT[1] + GEN, paged=True,
                        page_size=PAGE, n_pages=N_PAGES, kv_dtype=kv_dtype,
                        kernel_impl="cuda")
    eng = DecodeEngine(cfg, ecfg, params=params, device="cuda", seed=0)
    if params is None:
        _condition(torch, eng.params)
    print(f"Scheduler, tinyllama-1.1b, {kv_dtype} pools: {SLOTS} slots, "
          f"{N_PAGES} pages of {PAGE}, {N_REQ} requests, prompts "
          f"{PROMPT[0]}-{PROMPT[1]}, gen {GEN}")
    # a short warm-up stream, so the counted one finds the allocator's
    # pools and the kernels' first launches done
    _drive(Scheduler(eng), _requests(cfg, 4, PROMPT, 4, seed=5))
    reqs = _requests(cfg, N_REQ, PROMPT, GEN, seed=4)
    sched = Scheduler(eng)
    torch.cuda.synchronize()
    build.reset_launches()
    m0 = _tuner_misses()
    t0 = time.perf_counter()
    out = _drive(sched, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    misses = _window_misses(f"scheduler {kv_dtype}", m0)
    launches = dict(build.LAUNCHES)
    st = sched.stats
    L = cfg.n_layers
    paged = "vwr_paged_flash_decode" + ("_q8" if kv_dtype == "int8"
                                        else "")
    other = ("vwr_paged_flash_decode" if kv_dtype == "int8"
             else "vwr_paged_flash_decode_q8")
    want = {paged: L * st["steps"], other: 0, "vwr_flash_decode": 0,
            "vwr_attention": L * st["prefills"],
            "vwr_swiglu": L * (st["prefills"] + st["steps"]),
            "vwr_matmul": L * (5 * st["prefills"] + st["steps"]),
            "vwr_chunk_prefix_attend": 0, "vwr_chunk_prefix_attend_q8": 0}
    print(f"  launches: {launches}")
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"scheduler {kv_dtype}: {k} launched "
                                 f"{launches[k]} times, expected {n}")
    swiglu = _swiglu_variants(torch, f"scheduler {kv_dtype}", L,
                              st["prefills"], st["steps"])
    paged_variants = _paged_variants(f"scheduler {kv_dtype}", kv_dtype,
                                     L * st["steps"])
    bad = {rid: r.status for rid, r in out.items()
           if r.status is not RequestStatus.FINISHED or len(r) != GEN}
    if len(out) != N_REQ or bad:
        raise AssertionError(f"scheduler {kv_dtype}: unfinished {bad}")
    sched.allocator.check()
    if sched.allocator.free_pages != N_PAGES:
        raise AssertionError("pages left allocated after the drain")
    n_tok = sum(len(r) for r in out.values())
    lat, itl = sched.latency_percentiles(), sched.itl_percentiles()
    summary = {
        "kv_dtype": kv_dtype, "steps": st["steps"],
        "prefills": st["prefills"], "preempted": st["preempted"],
        "parked": st["parked"], "peak_pages": st["peak_pages"],
        "table_widths": {str(k): v for k, v in
                         sorted(st["table_widths"].items())},
        "generated_tokens": n_tok, "wall_s": wall,
        "gen_tok_s": n_tok / wall,
        "latency_p50_s": lat["p50"], "latency_p99_s": lat["p99"],
        "itl_p50_s": itl["p50"], "itl_p99_s": itl["p99"],
        "launches": launches, "swiglu_variants": swiglu,
        "paged_variants": paged_variants, "tuner_misses": misses}
    print(f"  steps {st['steps']}, prefills {st['prefills']}, preempted "
          f"{st['preempted']}, peak pages {st['peak_pages']}/{N_PAGES}, "
          f"table widths {summary['table_widths']}")
    print(f"  {n_tok} tokens in {wall:.4f} s: {summary['gen_tok_s']:.1f} "
          f"generated tok/s; request latency p50 {lat['p50']:.4f} s p99 "
          f"{lat['p99']:.4f} s; ITL p50 {itl['p50'] * 1e3:.3f} ms p99 "
          f"{itl['p99'] * 1e3:.3f} ms")
    summary["held_pages_stream"] = _pressured_stream(torch, eng, cfg, out,
                                                     paged)

    rel, agree, flips = _replay_slots(torch, eng, sched.cache, reqs, out,
                                      kv_dtype)
    summary.update(logits_rel_err=rel, replay_agree=agree,
                   replay_flips=flips,
                   n_params=sum(t.numel() for _, t in leaves(eng.params)))
    params = eng.params
    del eng, sched
    torch.cuda.empty_cache()
    return summary, params


def _prefill_batch(torch, r):
    """The batch-1 prefill batch of request ``r``: its tokens and, for
    the frontend families, its ``frontend_emb``."""
    batch = {"tokens": torch.from_numpy(r.tokens)[None].cuda()}
    if r.frontend_emb is not None:
        batch["frontend_emb"] = torch.from_numpy(r.frontend_emb)[None].cuda()
    return batch


def _replay_slots(torch, eng, cache, reqs, out, kv_dtype,
                  agree_floor=REPLAY_AGREE, min_slots=SLOTS, gen=GEN):
    """Teacher-force finished requests through the serving engine's
    slots, all of them live in one decode batch, on the drained stream's
    pools (stale pages and int8 scales included), and hold each
    request's logits at every step against a batch-1 plain engine: dense
    for model-dtype pools, paged int8 for int8 pools, which reads the
    same quantized pages.  As many requests as fit the pool together, one
    a slot, at least ``min_slots`` of them; an audio request's encoder
    frames go to its slot's row of the cross cache.  A wrong table or
    counts row, a write into another slot's page or a stale scale shows
    here.  ``gen`` is the stream's generation length.  Returns the
    per-step relative errors, the steps whose greedy pick equals the
    served token, which must be at least ``agree_floor`` of them, and
    one record a step where it does not: the replay's gap between its
    top two logits and between its pick and the served token, beside
    that step's max |d| against the plain path (a near-tie flip has a
    gap below the error) and whether the plain path picks the served
    token."""
    import numpy as np

    from repro_torch.engine import DecodeEngine, EngineConfig
    from repro_torch.engine.paged_cache import write_prefill

    cfg, vocab = eng.cfg, eng.cfg.vocab
    slots, ps, n_pages = eng.ecfg.batch, eng.page_size, eng.n_pages
    # the first requests whose pages fit the pool together, one a slot
    picked, need = [], 0
    for r in reqs:
        n = -(-(eng.prefill_positions(len(r.tokens)) + gen - 1) // ps)
        if len(picked) < slots and need + n <= n_pages:
            picked.append((r, n))
            need += n
    if len(picked) < min_slots:
        raise AssertionError(f"only {len(picked)} requests fit the pool")
    perm = np.random.default_rng(7).permutation(n_pages).astype(np.int32)
    table = np.zeros((slots, eng.max_pages), np.int32)
    lens = np.zeros((slots,), np.int32)
    enc_lens = np.zeros((slots,), np.int32)
    served = np.zeros((slots, gen), np.int32)
    got = [[] for _ in picked]
    at = 0
    for b, (r, n) in enumerate(picked):
        table[b, :n] = perm[at:at + n]
        at += n
        logits, caches = eng.prefill_fn(eng.params, _prefill_batch(torch, r))
        write_prefill(cfg, cache, caches, table[b][None], enc_slots=[b])
        got[b].append(logits[0, :vocab])
        lens[b] = eng.prefill_positions(len(r.tokens))
        if cfg.family == "audio":
            enc_lens[b] = len(r.frontend_emb)
        served[b] = out[r.rid].tokens
    for i in range(gen - 1):
        step = {"token": served[:, i], "cur_len": np.where(
            lens > 0, lens + i, 0), "block_table": table, "cache": cache}
        if cfg.family == "audio":
            step["enc_lens"] = enc_lens
        logits, cache = eng.decode_fn(eng.params, step)
        for b in range(len(picked)):
            got[b].append(logits[b, :vocab])

    one = EngineConfig(batch=1, max_len=eng.ecfg.max_len,
                       kernel_impl="torch")
    if kv_dtype == "int8":
        one = one.replace(paged=True, page_size=PAGE, kv_dtype="int8")
    ref = DecodeEngine(cfg, one, params=eng.params, device="cuda")
    rel, agree, flips, where = [], 0, [], []
    for b, (r, _) in enumerate(picked):
        P = eng.prefill_positions(len(r.tokens))
        lr, cr = ref.prefill(_prefill_batch(torch, r))
        for i in range(gen):
            want, x = lr[0, :vocab], got[b][i]
            err = (x - want).abs().max().item()
            rel.append(err / want.abs().max().item())
            where.append((r.rid, i))
            tok = int(served[b, i])
            if int(x.argmax()) == tok:
                agree += 1
            else:
                top2 = x.float().topk(2).values
                flips.append({
                    "rid": r.rid, "step": i,
                    "top2_gap": (top2[0] - top2[1]).item(),
                    "served_gap": (top2[0] - x[tok].float()).item(),
                    "abs_err": err,
                    "plain_picks_served": int(want.argmax()) == tok})
            if i + 1 < gen:
                lr, cr = _decode(ref, served[b, i:i + 1], P + i, cr)
    worst = max(rel)
    worst_rid, worst_step = where[rel.index(worst)]
    print(f"  {len(picked)} requests replayed in {slots} live slots, "
          f"teacher-forced: logits vs the plain "
          f"{'dense' if kv_dtype == 'bf16' else 'paged int8'} path max "
          f"|d|/max|ref| {worst:.3e} over {len(rel)} steps (limit "
          f"{E2E_BF16_REL:g}), the largest at request "
          f"{worst_rid} step {worst_step} "
          f"(step 0: the prefill's logits); greedy == served token at "
          f"{agree}/{len(rel)} steps (floor {agree_floor})")
    for f in flips:
        print(f"    request {f['rid']} step {f['step']}: top-two gap "
              f"{f['top2_gap']:.4g}, pick - served {f['served_gap']:.4g}, "
              f"max |d| vs plain {f['abs_err']:.4g}, plain picks served "
              f"{f['plain_picks_served']}")
    if not worst <= E2E_BF16_REL:
        raise AssertionError(f"scheduler {kv_dtype}: logits diverge from "
                             "the plain path")
    if agree < agree_floor * len(rel):
        raise AssertionError(f"scheduler {kv_dtype}: the replay picks the "
                             f"served token at only {agree}/{len(rel)} "
                             "steps")
    del ref
    return rel, agree, flips


def _pressured_stream(torch, eng, cfg, out, paged):
    """The stream again with HELD pages held out of the pool: growth
    must preempt; every request still finishes, the pages come back,
    and the paged kernel carries every decode step and the batch-1
    ``vwr_attention`` every (re-)admission prefill.  Recompute
    re-admission prefills the generated prefix instead of reading the
    decode-written K/V, so a near-tie may pick another token at bf16:
    the streams equal to the unpressured run are counted, not held."""
    from repro_torch.engine import RequestStatus, Scheduler
    from repro_torch.engine.faults import hold_pages
    from repro_torch.kernels import build

    sched = Scheduler(eng)
    release = hold_pages(sched, HELD)
    build.reset_launches()
    res = _drive(sched, _requests(cfg, N_REQ, PROMPT, GEN, seed=4))
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    release()
    st = sched.stats
    L = cfg.n_layers
    if st["preempted"] < 1:
        raise AssertionError(f"{HELD} held pages: growth never preempted")
    if (launches[paged] != L * st["steps"]
            or launches["vwr_attention"] != L * st["prefills"]
            or launches["vwr_flash_decode"] != 0):
        raise AssertionError(f"{HELD} held pages: launches {launches}")
    _paged_variants(f"{HELD} held pages", "int8" if paged.endswith("_q8")
                    else "bf16", L * st["steps"])
    bad = [rid for rid, r in res.items()
           if r.status is not RequestStatus.FINISHED or len(r) != GEN]
    if len(res) != N_REQ or bad:
        raise AssertionError(f"{HELD} held pages: unfinished {bad}")
    sched.allocator.check()
    if sched.allocator.free_pages != N_PAGES:
        raise AssertionError("pages left allocated after the drain")
    same = sum(bool((res[rid] == out[rid]).all()) for rid in out)
    print(f"  {HELD} pages held: steps {st['steps']}, prefills "
          f"{st['prefills']}, preempted {st['preempted']}, parked "
          f"{st['parked']}, table widths "
          f"{dict(sorted(st['table_widths'].items()))}; {same}/{N_REQ} "
          "streams equal to the unpressured run")
    return {"held": HELD, "steps": st["steps"], "prefills": st["prefills"],
            "preempted": st["preempted"], "parked": st["parked"],
            "streams_equal": same, "launches": launches}


def _replay_streams(torch, eng, ref, reqs, streams, chunk=None):
    """Teacher-force each request's ``streams`` tokens through ``eng`` and
    ``ref`` from fresh pools of their config, as many requests at a time
    as slots and pages allow, in the same slot layout on both paths:
    each prompt whole, or in chunks of ``chunk`` tokens through
    ``lm.prefill_chunk`` (each chunk reading the earlier chunks' pages),
    then one decode step a token.  Idle slots write into a spare page.

    ``ref`` runs each of these steps twice: on a copy of ``eng``'s pools
    just after ``eng``'s step (``"shared"``: it reads the pages ``eng``
    wrote and rewrites only the step's own tokens, on the same int8
    grid), and on pools of its own (``"torch"``).  Returns, per request,
    the logits rows (the prefill's, then each step's) under ``"cuda"``,
    ``"shared"`` and ``"torch"``."""
    import numpy as np

    from repro_torch.engine.paged_cache import write_prefill
    from repro_torch.models import lm

    B, ps, vocab = eng.ecfg.batch, eng.page_size, eng.cfg.vocab
    spare = eng.n_pages - 1
    perm = np.random.default_rng(7).permutation(spare).astype(np.int32)
    groups, group, need = [], [], 0
    for r in reqs:
        n = -(-(len(r.tokens) + len(streams[r.rid]) - 1) // ps)
        if n > spare:
            raise AssertionError(f"request {r.rid} needs {n} pages")
        if len(group) == B or need + n > spare:
            groups.append(group)
            group, need = [], 0
        group.append((r, n))
        need += n
    groups.append(group)
    logits = {r.rid: {"cuda": [], "shared": [], "torch": []} for r in reqs}
    for group in groups:
        table = np.full((B, eng.max_pages), spare, np.int32)
        lens = np.zeros((B,), np.int32)
        at = 0
        for b, (r, n) in enumerate(group):
            table[b, :n] = perm[at:at + n]
            at += n
            lens[b] = len(r.tokens)
        pools = {"cuda": eng.init_paged_cache(),
                 "torch": ref.init_paged_cache()}

        def run(f, rows):
            """One step ``f(engine, cache) -> (logits, cache)`` on the
            three paths; ``rows`` (slot, request id) pairs to keep."""
            out = {}
            out["cuda"], pools["cuda"] = f(eng, pools["cuda"])
            out["shared"], _ = f(ref, lm.map_groups(lambda t: t.clone(),
                                                    pools["cuda"]))
            out["torch"], pools["torch"] = f(ref, pools["torch"])
            for b, rid in rows:
                for path, lg in out.items():
                    logits[rid][path].append(lg[b, :vocab].float())

        for b, (r, _) in enumerate(group):
            toks = torch.from_numpy(r.tokens)[None].cuda()

            def prefill(e, c, row=table[b]):
                lg, caches = e.prefill_fn(e.params, {"tokens": toks})
                write_prefill(e.cfg, c, caches, row[None])
                return lg, c
            if chunk is None:
                run(prefill, [(0, r.rid)])
            for p0 in range(0, len(r.tokens) if chunk else 0, chunk or 1):
                end = min(p0 + chunk, len(r.tokens))
                part = {"tokens": toks[:, p0:end],
                        "pages": table[b, :p0 // ps],
                        "write_pages": table[b, p0 // ps:-(-end // ps)]}
                run(lambda e, c: lm.prefill_chunk(
                    e.params, {**part, "cache": c}, e.cfg),
                    [(0, r.rid)] if end == len(r.tokens) else [])
        gen = max(len(streams[r.rid]) for r, _ in group)
        for i in range(gen - 1):
            tok = np.zeros((B,), np.int32)
            live = [(b, r.rid) for b, (r, _) in enumerate(group)
                    if i + 1 < len(streams[r.rid])]
            for b, rid in live:
                tok[b] = streams[rid][i]
            cur = np.where(lens > 0, lens + i, 0)
            run(lambda e, c: e.decode_step(tok, cur, c, block_table=table),
                live)
    return logits


def _hold_streams(torch, what, eng, ref, reqs, got, want, chunk=None,
                  tol=E2E_FP32_TOL):
    """Greedy Scheduler streams of the kernel path on int8 pools
    (``got``, one token list a request) against the plain path's
    (``want``): equal, or held past the step where they part.

    A pool write quantizes K and V to int8, so a last-bit difference
    between two fp32 products can move a value across a rounding
    boundary (one step of the page's scale); where two candidate tokens
    lie closer than that moves the logits, the picks part.  Every
    request whose streams part is then replayed with the plain path's
    tokens (``_replay_streams``), and at every step, the split and every
    later page included, the kernel path's logits are held at ``tol``
    (E2E_FP32_TOL for the reduced fp32 configs) x max(1, max|logits|) to
    the plain path's on the same int8 pages (``"shared"``).  The plain path on pools of its own is
    reported beside it and not held: there the int8 rounding of the
    whole history differs between the paths, not the kernels alone.
    Returns a summary (empty where the streams are equal)."""
    if got == want:
        return {}
    parted = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if any(len(got[i]) != len(want[i]) for i in parted):
        raise AssertionError(f"{what}: streams of different lengths")
    first = min((next(j for j, (x, y) in enumerate(zip(got[i], want[i]))
                      if x != y), i) for i in parted)
    logits = _replay_streams(torch, eng, ref, [reqs[i] for i in parted],
                             {i: want[i] for i in parted}, chunk)

    def rel(x, y):
        return (x - y).abs().max().item() / max(1.0, y.abs().max().item())
    worst, own, steps, agree, agree_shared = 0.0, 0.0, 0, 0, 0
    for i in parted:
        lg = logits[i]
        for j, (x, y, z) in enumerate(zip(lg["cuda"], lg["shared"],
                                          lg["torch"])):
            err = rel(x, y)
            if not err <= tol:
                raise AssertionError(
                    f"{what}: request {i}, replayed with the plain "
                    f"path's tokens, step {j}: max|d logits| {err:.3e} of "
                    f"scale past {tol:g} on the same int8 pages")
            worst, own = max(worst, err), max(own, rel(x, z))
            steps += 1
            agree += int(x.argmax()) == want[i][j]
            agree_shared += int(y.argmax()) == want[i][j]
    return {"first_split": {"request": first[1], "step": first[0]},
            "parted": parted, "replayed_steps": steps,
            "max_rel_err": worst, "max_rel_err_own_pools": own,
            "kernel_picks_plain_token": agree,
            "plain_on_same_pages_picks_plain_token": agree_shared}


def _stream_note(held):
    if not held:
        return "identical"
    return (f"part at request {held['first_split']['request']} step "
            f"{held['first_split']['step']} ({len(held['parted'])} "
            "streams); replayed with the plain tokens: max|d logits| "
            f"{held['max_rel_err']:.3e} of scale on the same int8 pages "
            f"over {held['replayed_steps']} steps (limit "
            f"{E2E_FP32_TOL:g}; on each path's own pools "
            f"{held['max_rel_err_own_pools']:.3e}, not held); the plain "
            "stream's token is picked by the kernel path at "
            f"{held['kernel_picks_plain_token']}/{held['replayed_steps']} "
            "steps, by the plain path on the same pages at "
            f"{held['plain_on_same_pages_picks_plain_token']}/"
            f"{held['replayed_steps']}")


def scheduler_reduced_fp32(torch, name):
    """Reduced fp32 config on the card: the Scheduler's greedy streams
    on the kernels equal the plain backend's over a stream that
    preempts; on int8 pools a stream that parts is held to its end
    through a replay (``_hold_streams``)."""
    from repro_torch.engine import DecodeEngine, EngineConfig, Scheduler

    cfg = _reduced(name)
    streams, held = {}, {}
    for kv_dtype in ("bf16", "int8"):
        ecfg = EngineConfig(batch=3, max_len=64, paged=True, page_size=8,
                            n_pages=12, kv_dtype=kv_dtype,
                            kernel_impl="cuda")
        eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
        ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                           params=eng.params, device="cuda")
        for e in (eng, ref):
            sched = Scheduler(e)
            reqs = _requests(cfg, 7, (5, 40), 16, seed=6)
            out = _drive(sched, reqs)
            streams[kv_dtype, e.cfg.kernel_impl] = (
                [out[i].tokens.tolist() for i in range(7)],
                sched.stats["preempted"])
        got, want = (streams[kv_dtype, k][0] for k in ("cuda", "torch"))
        if kv_dtype == "int8":
            held[kv_dtype] = _hold_streams(
                torch, f"{name} reduced fp32 int8", eng, ref, reqs, got,
                want)
        elif got != want:
            raise AssertionError(f"{name} reduced fp32 {kv_dtype}: "
                                 "Scheduler streams differ")
        print(f"  {cfg.name} fp32 Scheduler, {kv_dtype} pools: greedy "
              f"streams {_stream_note(held.get(kv_dtype))} "
              f"({streams[kv_dtype, 'cuda'][1]} preemptions)")
    return {"preemptions": {k[0]: v[1] for k, v in streams.items()
                            if k[1] == "cuda"}, "parted": held}


# ----------------------------------------------------------------------
# phase 6: the prefix cache and chunked prefill
# ----------------------------------------------------------------------

# chunked prefill at full width: 64-token chunks (4 pages of 16), the
# default budget of slots + chunk = 72 tokens a step
CHUNK_TOKENS = 64
# the shared-prompt stream: N_SHARED requests open with one SYSTEM-token
# system prompt (8 whole pages) and a unique tail of TAIL tokens; the
# rest have unique prompts of PROMPT tokens; arrivals as in _drive
SYSTEM, TAIL, N_SHARED = 128, (16, 128), 16
# (pool dtype, prefix cache, chunked prefill) of each stream, off/off
# first: the on/on streams are compared with it
PC_MODES = (("bf16", False, False), ("bf16", True, True),
            ("int8", False, False), ("int8", True, True),
            ("bf16", True, False), ("bf16", False, True))


def _shared_requests(cfg, seed=4):
    import numpy as np

    from repro_torch.engine import Request

    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab, SYSTEM)
    prompts = [np.concatenate([system, rng.integers(
        0, cfg.vocab, int(rng.integers(TAIL[0], TAIL[1] + 1)))])
        for _ in range(N_SHARED)]
    prompts += [rng.integers(0, cfg.vocab, int(rng.integers(
        PROMPT[0], PROMPT[1] + 1))) for _ in range(N_REQ - N_SHARED)]
    order = rng.permutation(N_REQ)
    return [Request(rid=i, tokens=prompts[j].astype(np.int32), gen=GEN)
            for i, j in enumerate(order)]


def _stream_launches(st, n_layers, kv_dtype, prefix, chunked):
    """The launches a stream must count: the paged decode kernel of its
    pool dtype every step (a mixed step too), vwr_attention for every
    whole-prompt prefill (none when chunked; a prefix hit prefills its
    suffix on the blockwise path), the matmuls for every prefill pass
    (a whole or suffix prefill, or a chunk) and decode step, and never
    the chunk-prefix kernels: the engine's chunk path, like the JAX
    package's, does not reach them."""
    paged = "vwr_paged_flash_decode" + ("_q8" if kv_dtype == "int8" else "")
    other = ("vwr_paged_flash_decode" if kv_dtype == "int8"
             else "vwr_paged_flash_decode_q8")
    passes = st["chunks"] if chunked else st["prefills"]
    whole = 0 if chunked else (st["prefix_misses"] if prefix
                               else st["prefills"])
    L = n_layers
    return {paged: L * st["steps"], other: 0, "vwr_flash_decode": 0,
            "vwr_attention": L * whole,
            "vwr_swiglu": L * (passes + st["steps"]),
            "vwr_matmul": L * (5 * passes + st["steps"]),
            "vwr_chunk_prefix_attend": 0, "vwr_chunk_prefix_attend_q8": 0}


def chunk_rows(torch, params):
    """Full-width chunk rows: tinyllama-1.1b's layer 0 (conditioned random
    weights) on a 256-token prompt, q/k/v from the port's ``qkv_proj`` on
    the kernels, K/V written into bf16 and int8 pools by
    ``write_prefill``; for chunks at 64, 128 and 192, the chunk's rows
    through ``chunk_prefill_attend`` (bf16) or
    ``dist.decode.local_chunk_prefix_attend`` with the pools' scales,
    merged with ``chunk_self_attn_partial`` (int8), on the 'cuda'
    backend, against the plain fp32 whole-prompt causal pass (bf16) or
    the same math on the dequantized pools (int8).  The launch counts of
    kernels 6 and 8 are read over this phase."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.dist import decode as DD
    from repro_torch.engine import paged_cache as PC
    from repro_torch.kernels import build
    from repro_torch.models import attention as A
    from repro_torch.models import layers as LY
    from repro_torch.models import lm

    cfg = get_config("tinyllama-1.1b")
    lp = lm._layer(params["layers"], 0)
    P, C, n_pages = 256, CHUNK_TOKENS, 64
    g = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (1, P), generator=g, device="cuda",
                         dtype=torch.int32)
    h = lm._norm(cfg, lp["attn_norm"],
                 LY.embed(params["embed"], toks).to(torch.bfloat16))
    q, k, v = A.qkv_proj(lp["attn"], h, torch.arange(P, device="cuda"),
                         cfg.rope_theta, cfg)
    whole = A.full_attn_ref(q.float(), k.float(), v.float(),
                            causal=True)[0]
    one = cfg.replace(n_layers=1)
    pages = np.random.default_rng(8).permutation(n_pages)[:P // PAGE]
    q, k, v = q[0], k[0], v[0]
    torch.cuda.synchronize()
    build.reset_launches()
    out = {}
    for kv_dtype in ("bf16", "int8"):
        cache = PC.init_paged_cache(one, n_pages, PAGE, kv_dtype=kv_dtype,
                                    device="cuda")
        PC.write_prefill(one, cache, (k[None, None], v[None, None]),
                         pages[None].astype(np.int32))
        kp, vp = cache["k"][0], cache["v"][0]
        rel = []
        for c0 in (64, 128, 192):
            jp = c0 // PAGE
            table = torch.from_numpy(pages[:jp].astype(np.int32)).cuda()
            counts = torch.full((jp,), PAGE, dtype=torch.int32,
                                device="cuda")
            qc, kc, vc = q[c0:c0 + C], k[c0:c0 + C], v[c0:c0 + C]
            if kv_dtype == "bf16":
                got = A.chunk_prefill_attend(qc, kc, vc, kp, vp, table,
                                             counts, backend="cuda")
                want = whole[c0:c0 + C]
            else:
                ks, vs = cache["k_scale"][0], cache["v_scale"][0]
                part = DD.local_chunk_prefix_attend(
                    qc, kp, vp, table, counts, k_scale=ks, v_scale=vs,
                    backend="cuda")
                o_t, _, l = A.merge_partials(
                    part, A.chunk_self_attn_partial(qc, kc, vc))
                got = A.normalize_partial(o_t, l, torch.float32)
                kd = kp.float() * ks[:, None, :, None]
                vd = vp.float() * vs[:, None, :, None]
                o_t, _, l = A.merge_partials(
                    A.chunk_prefix_attend_partial(qc.float(), kd, vd,
                                                  table, counts),
                    A.chunk_self_attn_partial(qc.float(), kc.float(),
                                              vc.float()))
                want = A.normalize_partial(o_t, l, torch.float32)
            torch.cuda.synchronize()
            rel.append(((got.float() - want).abs().max()
                        / want.abs().max()).item())
        limit = E2E_BF16_REL if kv_dtype == "bf16" else CHUNK_Q8_REL
        print(f"  {kv_dtype} pools, chunks at 64/128/192 of a {P}-token "
              f"prompt (layer 0, {cfg.n_heads} heads / {cfg.n_kv_heads} KV,"
              f" D {cfg.d_head}): max |d|/max|ref| "
              + ", ".join(f"{r:.3e}" for r in rel)
              + f" (limit {limit:g})")
        if not max(rel) <= limit:
            raise AssertionError(f"chunk rows, {kv_dtype} pools: off the "
                                 "reference")
        out[kv_dtype] = rel
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in
                ("vwr_chunk_prefix_attend", "vwr_chunk_prefix_attend_q8")}
    variants = {k: build.VARIANTS[k] for k in
                ("vwr_chunk_prefix_attend.wgmma",
                 "vwr_chunk_prefix_attend.fma",
                 "vwr_chunk_prefix_attend_q8.wgmma",
                 "vwr_chunk_prefix_attend_q8.fma")}
    print(f"  launches in the chunk phase: {launches}; kernels 6 and 8 by "
          f"variant: {variants}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError("a chunk-prefix kernel was never launched")
    for k in launches:
        if variants[f"{k}.wgmma"] != launches[k]:
            raise AssertionError(f"{k} on bf16 queries must run its wgmma "
                                 "variant")
    return {"rel_err": out, "launches": launches, "variants": variants}


def chunked_prefill_logits(torch, params):
    """Full-width chunked prefill on the engine's chunk path: a 256-token
    prompt through ``lm.prefill_chunk`` 64 tokens at a time on the
    kernels; the final chunk's logits (those that pick a chunked
    request's first token) against the plain path's.  bf16 pools: the
    plain whole-prompt prefill (as the kernels' whole prefill is, shown
    beside it).  int8 pools: the plain chunked prefill over int8 pools
    (a later chunk reads the earlier ones through the quantized pages,
    so against the whole prefill it is shown, not held)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.engine import paged_cache as PC
    from repro_torch.models import lm

    cfg = get_config("tinyllama-1.1b")
    plain = cfg.replace(kernel_impl="torch")
    P, C, n_pages = 256, CHUNK_TOKENS, 32
    g = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(0, cfg.vocab, (1, P), generator=g, device="cuda",
                         dtype=torch.int32)
    pages = np.random.default_rng(9).permutation(n_pages)[:P // PAGE]
    pages = pages.astype(np.int32)
    V = cfg.vocab

    def chunked(c, kv_dtype):
        cache = PC.init_paged_cache(c, n_pages, PAGE, kv_dtype=kv_dtype,
                                    device="cuda")
        for p0 in range(0, P, C):
            logits, cache = lm.prefill_chunk(params, {
                "tokens": toks[:, p0:p0 + C], "pages": pages[:p0 // PAGE],
                "write_pages": pages[p0 // PAGE:(p0 + C) // PAGE],
                "cache": cache}, c)
        return logits[:, :V]

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    whole = lm.prefill(params, {"tokens": toks}, plain)[0][:, :V]
    q8 = chunked(cfg, "int8")
    out = {"whole_kernel": rel(lm.prefill(params, {"tokens": toks},
                                          cfg)[0][:, :V], whole),
           "bf16": rel(chunked(cfg, "bf16"), whole),
           "int8": rel(q8, chunked(plain, "int8")),
           "int8_vs_whole": rel(q8, whole)}
    print(f"  a {P}-token prompt in chunks of {C} through lm.prefill_chunk "
          f"(tinyllama-1.1b, 22 layers), final logits, max |d|/max|ref|: "
          f"bf16 pools vs the plain whole prefill {out['bf16']:.3e} (the "
          f"kernels' whole prefill {out['whole_kernel']:.3e}); int8 pools "
          f"vs the plain chunked prefill {out['int8']:.3e} (vs the plain "
          f"whole prefill {out['int8_vs_whole']:.3e}, shown); limit "
          f"{E2E_BF16_REL:g}")
    if not max(out["bf16"], out["int8"]) <= E2E_BF16_REL:
        raise AssertionError("chunked prefill logits off the plain path")
    return out


def _pc_engines(torch, params):
    """The full-width tinyllama-1.1b engines of phases 6 and 6b, bf16 and
    int8 pools (SLOTS slots, N_PAGES pages of PAGE, chunks of
    CHUNK_TOKENS), each warmed up by a short prefix + chunked stream."""
    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, EngineConfig, Scheduler

    cfg = get_config("tinyllama-1.1b")
    engines = {}
    for kv_dtype in ("bf16", "int8"):
        eng = DecodeEngine(cfg, EngineConfig(
            batch=SLOTS, max_len=PROMPT[1] + GEN, paged=True,
            page_size=PAGE, n_pages=N_PAGES, kv_dtype=kv_dtype,
            chunk_tokens=CHUNK_TOKENS, kernel_impl="cuda"),
            params=params, device="cuda")
        # warm-up: the first launches of the suffix and chunk paths
        _drive(Scheduler(eng, prefix_cache=True, chunked_prefill=True),
               _requests(cfg, 4, PROMPT, 4, seed=5))
        engines[kv_dtype] = eng
    return engines


def serve_prefix_chunked(torch, engines):
    """Full-width tinyllama-1.1b through the Scheduler with the prefix
    cache and chunked prefill, on the shared-prompt stream, in each of
    PC_MODES (on the bf16 and int8 ``engines`` of ``_pc_engines``):
    launch counts checked, every request finished and every page back
    (but the trie's), the on/on streams replayed teacher-forced against
    the plain path (``_replay_slots``) and compared with the off/off
    streams."""
    from repro_torch.engine import RequestStatus, Scheduler
    from repro_torch.kernels import build

    cfg = engines["bf16"].cfg
    print(f"Scheduler with the prefix cache and chunked prefill, "
          f"tinyllama-1.1b: {N_REQ} requests ({N_SHARED} open with one "
          f"{SYSTEM}-token system prompt + {TAIL[0]}-{TAIL[1]} tokens, "
          f"{N_REQ - N_SHARED} unique of {PROMPT[0]}-{PROMPT[1]}), gen "
          f"{GEN}, chunk {CHUNK_TOKENS}")
    summaries, outs = [], {}
    for kv_dtype, prefix, chunked in PC_MODES:
        eng = engines[kv_dtype]
        reqs = _shared_requests(cfg)
        sched = Scheduler(eng, prefix_cache=prefix, chunked_prefill=chunked)
        torch.cuda.synchronize()
        build.reset_launches()
        m0 = _tuner_misses()
        t0 = time.perf_counter()
        out = _drive(sched, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        st = sched.stats
        tag = (f"{kv_dtype} pools, prefix {'on' if prefix else 'off'}, "
               f"chunked {'on' if chunked else 'off'}")
        misses = _window_misses(f"shared-prompt stream, {tag}", m0)
        want = _stream_launches(st, cfg.n_layers, kv_dtype, prefix,
                                chunked)
        for k, n in want.items():
            if launches[k] != n:
                raise AssertionError(f"{tag}: {k} launched {launches[k]} "
                                     f"times, expected {n}")
        _paged_variants(tag, kv_dtype, cfg.n_layers * st["steps"])
        bad = {rid: r.status for rid, r in out.items()
               if r.status is not RequestStatus.FINISHED or len(r) != GEN}
        if len(out) != N_REQ or bad:
            raise AssertionError(f"{tag}: unfinished {bad}")
        sched.allocator.check()
        cached = sched.prefix.cached_pages if prefix else 0
        if sched.allocator.free_pages != N_PAGES - cached:
            raise AssertionError(f"{tag}: pages left allocated")
        if prefix and chunked and not (st["prefix_hits"] > 0
                                       and st["chunks"] > 0):
            raise AssertionError(f"{tag}: no prefix hit or no chunk")
        n_tok = sum(len(r) for r in out.values())
        lat, itl = sched.latency_percentiles(), sched.itl_percentiles()
        keys = ("steps", "prefills", "preempted", "parked", "peak_pages",
                "prefix_hits", "prefix_misses", "prefix_hit_tokens",
                "prefix_evictions", "shared_pages", "cow_forks",
                "mixed_steps", "chunks", "chunked_tokens")
        summary = {"kv_dtype": kv_dtype, "prefix": prefix,
                   "chunked": chunked, **{k: st[k] for k in keys},
                   "table_widths": {str(k): v for k, v in
                                    sorted(st["table_widths"].items())},
                   "generated_tokens": n_tok, "wall_s": wall,
                   "gen_tok_s": n_tok / wall,
                   "latency_p50_s": lat["p50"], "latency_p99_s": lat["p99"],
                   "itl_p50_s": itl["p50"], "itl_p99_s": itl["p99"],
                   "launches": launches, "tuner_misses": misses}
        print(f"  {tag}: steps {st['steps']}, prefills {st['prefills']}, "
              f"preempted {st['preempted']}, peak pages "
              f"{st['peak_pages']}/{N_PAGES}, table widths "
              f"{summary['table_widths']}")
        print("    " + ", ".join(f"{k} {st[k]}" for k in keys[5:]))
        print(f"    {n_tok} tokens in {wall:.4f} s: "
              f"{summary['gen_tok_s']:.1f} generated tok/s; request "
              f"latency p50 {lat['p50']:.4f} s p99 {lat['p99']:.4f} s; "
              f"ITL p50 {itl['p50'] * 1e3:.3f} ms p99 "
              f"{itl['p99'] * 1e3:.3f} ms")
        print(f"    launches: {launches}")
        outs[kv_dtype, prefix, chunked] = out
        if prefix and chunked:
            base = outs[kv_dtype, False, False]
            same = sum(bool((out[rid] == base[rid]).all()) for rid in out)
            print(f"    {same}/{N_REQ} streams equal to the off/off run")
            summary["streams_equal_off"] = same
            rel, agree, flips = _replay_slots(
                torch, eng, sched.cache, reqs, out, kv_dtype,
                agree_floor=(REPLAY_AGREE if kv_dtype == "bf16"
                             else REPLAY_AGREE_Q8))
            summary.update(logits_rel_err=rel, replay_agree=agree,
                           replay_flips=flips)
        summaries.append(summary)
        del sched
    torch.cuda.empty_cache()
    return summaries


# ----------------------------------------------------------------------
# phase 6b: durable serving (snapshots, the request journal, recovery)
# ----------------------------------------------------------------------

# the crash+recover streams snapshot every RECOVER_EVERY steps; the crash
# comes after at least two snapshots, at a step with a chunked prompt in
# flight
RECOVER_EVERY = 4
# fsynced journal appends timed for the cost of one
JOURNAL_APPENDS = 50


def _paged_kernel(eng):
    """The paged decode kernel an engine's steps launch, and the variant
    every launch must take: kernel 5 / 7 on mma, 11 / 13 on wgmma."""
    mla = eng.cfg.mla is not None
    name = ("vwr_mla_paged_flash_decode" if mla
            else "vwr_paged_flash_decode")
    if eng.ecfg.kv_dtype == "int8":
        name += "_q8"
    return name, "wgmma" if mla else "mma"


class _Watch:
    """A snapshotter stand-in for a crash-free run: records after every
    step whether a prompt is part-way through chunked prefill (a
    PREFILLING slot with some of its prompt resident) and how many
    results are finished."""

    def __init__(self):
        self.mid_prompt, self.finished = {}, {}

    def on_step(self, sched):
        from repro_torch.engine import RequestStatus

        k = sched.stats["steps"]
        self.mid_prompt[k] = any(
            s is not None and s.req.status is RequestStatus.PREFILLING
            and s.prefilled > 0 for s in sched.slots)
        self.finished[k] = len(sched.finished)

    def wait(self):
        pass


def _crash_step(watch, journal):
    """The crash step: off the cadence, after at least two snapshots, with
    a prompt part-way through chunked prefill, its last snapshot holding
    such a prompt too where one does (a chunk cut by the snapshot).  With
    ``journal`` a result finished between that snapshot and the crash, so
    recovery takes its terminal verbatim from the journal and frees its
    slot early, and later admissions run beside other slot mates than in
    the crash-free run; without, no result did (and, where one can, some
    finished before the snapshot), so the recovered run repeats the
    crash-free schedule step for step."""
    def snap(k):
        return RECOVER_EVERY * (k // RECOVER_EVERY)

    def cut(k):
        return bool(watch.mid_prompt.get(snap(k)))
    steps = [k for k in sorted(watch.mid_prompt)
             if k > 2 * RECOVER_EVERY and k % RECOVER_EVERY
             and watch.mid_prompt[k]
             and (watch.finished[k] > watch.finished[snap(k)]) == journal]
    if not steps:
        raise AssertionError(
            "no step with a chunk in flight after two snapshots and "
            f"{'a' if journal else 'no'} result finished since the last")
    return min(steps, key=lambda k: (
        not cut(k), journal or not watch.finished[snap(k)], k))


def _recovery_streams(torch, tag, eng, make_reqs, crashes=(False, True)):
    """One stream (``make_reqs()``, all submitted at once, the prefix
    cache and chunked prefill on) on the kernel path: crash-free, then
    through ``serve_with_recovery`` once for each of ``crashes`` (the
    ``journal`` flag of ``_crash_step``), each with a snapshot every
    RECOVER_EVERY steps into a temporary directory outside the repo
    (removed afterwards) and a CrashFault on the fresh run.  Holds for
    every run: every request FINISHED with GEN tokens, the allocator and
    trie invariants, every page but the trie's free; for each recovery:
    the restart taken from a snapshot, and the paged decode kernel
    launched L times a step over both processes' steps, every launch on
    its Hopper variant.  Returns (summaries, crash-free results,
    recovered Schedulers), one summary and Scheduler a crash."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.engine import RequestStatus, Scheduler, faults
    from repro_torch.engine.snapshot import _read_host_state
    from repro_torch.kernels import build
    from repro_torch.runtime.resilience import (RestartPolicy,
                                                serve_with_recovery)

    modes = dict(prefix_cache=True, chunked_prefill=True)
    L = eng.cfg.n_layers
    name, variant = _paged_kernel(eng)

    def check(what, sched, out):
        bad = {rid: r.status for rid, r in out.items()
               if r.status is not RequestStatus.FINISHED or len(r) != GEN}
        if len(out) != N_REQ or bad:
            raise AssertionError(f"{tag}, {what}: unfinished {bad}")
        sched.allocator.check()
        sched.prefix.check()
        if sched.allocator.free_pages != (eng.n_pages
                                          - sched.prefix.cached_pages):
            raise AssertionError(f"{tag}, {what}: pages left allocated")

    watch = _Watch()
    ref = Scheduler(eng, snapshotter=watch, **modes)
    for r in make_reqs():
        ref.submit(r)
    torch.cuda.synchronize()
    m0 = _tuner_misses()
    t0 = time.perf_counter()
    want = ref.run()
    torch.cuda.synchronize()
    wall_ref = time.perf_counter() - t0
    _window_misses(f"recovery {tag}, crash-free", m0)
    check("crash-free", ref, want)
    print(f"  {tag}: crash-free {ref.stats['steps']} steps, "
          f"{wall_ref:.4f} s")

    summaries, scheds = [], []
    for journal in crashes:
        crash = _crash_step(watch, journal)
        d = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
        info, fresh = {}, []

        def on_start(sched, is_fresh, crash=crash, info=info, fresh=fresh):
            if is_fresh:
                fresh.append(sched)
                faults.inject(sched, decode_faults=[
                    faults.CrashFault(step=crash)])
                return
            step = sched.stats["steps"]
            info["restored_step"] = step
            info["in_snapshot"] = (len(_read_host_state(
                sched.snapshotter.store, step)["finished"]) if step else 0)

        def submit(sched):
            for r in make_reqs():
                sched.submit(r)

        try:
            torch.cuda.synchronize()
            build.reset_launches()
            m0 = _tuner_misses()
            t0 = time.perf_counter()
            sched = serve_with_recovery(
                eng, d, submit, snapshot_every=RECOVER_EVERY,
                policy=RestartPolicy(max_restarts=1, backoff_s=0.0),
                on_start=on_start, sched_kwargs=modes)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            misses = _window_misses(f"recovery {tag}, crash at step "
                                    f"{crash}", m0)
            launches, variants = dict(build.LAUNCHES), dict(build.VARIANTS)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        got = sched.finished
        what = f"crash at step {crash}"
        check(what, sched, got)
        if not info.get("restored_step"):
            raise AssertionError(f"{tag}, {what}: no snapshot to restore")
        journaled = len(fresh.pop().finished)
        steps_run = crash + sched.stats["steps"] - info["restored_step"]
        if (launches[name] != L * steps_run
                or variants[f"{name}.{variant}"] != launches[name]):
            raise AssertionError(
                f"{tag}, {what}: {name} launched {launches[name]} times "
                f"({variants[f'{name}.{variant}']} on {variant}), expected "
                f"{L} x {steps_run} steps, all on {variant}")
        parted = [rid for rid in sorted(want)
                  if not np.array_equal(got[rid], want[rid])]
        summary = {
            "crash_step": crash, "snapshot_every": RECOVER_EVERY,
            "snapshot_cut_mid_prompt": bool(watch.mid_prompt.get(
                RECOVER_EVERY * (crash // RECOVER_EVERY))),
            "restored_step": info["restored_step"],
            "snapshots": sched.snapshotter.saved,
            "terminals_journaled_before_crash": journaled,
            "terminals_in_snapshot": info["in_snapshot"],
            "terminals_recovered_from_journal":
                journaled - info["in_snapshot"],
            "steps_crash_free": ref.stats["steps"],
            "steps_recovered": sched.stats["steps"],
            "steps_run": steps_run,
            "wall_crash_free_s": wall_ref, "wall_recovered_s": wall,
            "tuner_misses": misses,
            "launches": {k: v for k, v in launches.items() if v},
            "streams_parted": len(parted), "parted": parted}
        print(f"  {tag}, {what} (a snapshot every {RECOVER_EVERY} steps; "
              "the last before the crash cut a prompt mid-chunk: "
              f"{summary['snapshot_cut_mid_prompt']}): restored from step "
              f"{info['restored_step']}; {journaled} results journaled "
              f"before the crash, {info['in_snapshot']} in the snapshot, "
              f"{summary['terminals_recovered_from_journal']} recovered "
              "verbatim from the journal")
        print(f"    {steps_run} steps over both processes "
              f"({ref.stats['steps']} crash-free); {name} launched "
              f"{launches[name]} times, all on {variant}; wall: crash + "
              f"restore + recovered run {wall:.4f} s against {wall_ref:.4f} "
              f"s crash-free ({summary['snapshots']} snapshots); "
              f"{N_REQ - len(parted)}/{N_REQ} streams equal to the "
              "crash-free run")
        summaries.append(summary)
        scheds.append(sched)
    return summaries, want, scheds


def _bits(torch, t):
    """``t``'s elements as integers of their own width, so that two
    tensors compare bit for bit (-0 and NaN included)."""
    return t.view({1: torch.int8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


class _Tap:
    """Delegating engine proxy that keeps a copy of every decode and
    mixed step's logits (and a final chunk's)."""

    def __init__(self, eng):
        self._eng, self.logits = eng, []

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def decode_fn(self, params, batch):
        out = self._eng.decode_fn(params, batch)
        self.logits.append(out[0].clone())
        return out

    def mixed_fn(self, params, batch):
        out = self._eng.mixed_fn(params, batch)
        self.logits.extend(x.clone() for x in out[:2] if x is not None)
        return out


def snapshot_round_trip(torch, tag, eng, make_reqs, at):
    """The stream of ``make_reqs`` (prefix cache and chunked prefill on)
    run to step ``at`` on the kernel path, snapshotted and restored into a
    fresh Scheduler: every pool leaf (bf16 or int8 pools and fp32 scales),
    the block table, lengths, pending tokens, free-list order, trie,
    chunking queue and slots held bit for bit; then one more step on
    both, every logits row held bit for bit, and the pools again.  Times
    the snapshot's cut (the synchronous host copy), its background write,
    the restore (a fresh Scheduler, its pools, the copy in) and one
    fsynced journal append."""
    import os
    import shutil
    import statistics as st
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.checkpoint.store import _leaf_paths
    from repro_torch.engine import (RequestJournal, Scheduler, restore,
                                    snapshot)

    a = Scheduler(eng, prefix_cache=True, chunked_prefill=True)
    for r in make_reqs():
        a.submit(r)
    while a.stats["steps"] < at:
        a.admit()
        a.step()
    d = tempfile.mkdtemp(prefix="chip_smoke_snapshot_")
    try:
        store = CheckpointStore(d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = snapshot(a, store, async_=True)
        t1 = time.perf_counter()
        store.wait()
        t2 = time.perf_counter()
        sdir = os.path.join(d, f"step_{step}")
        disk = sum(os.path.getsize(os.path.join(sdir, f))
                   for f in os.listdir(sdir))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        b = restore(store, eng)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        journal = RequestJournal(os.path.join(d, "journal.jsonl"))
        reqs, appends = make_reqs(), []
        for i in range(JOURNAL_APPENDS):
            t = time.perf_counter()
            journal.submit(reqs[i % len(reqs)])
            appends.append(time.perf_counter() - t)
        journal.close()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    pools = _leaf_paths(a.cache)
    pool_bytes = sum(t.numel() * t.element_size() for t in pools.values())

    def slots(s):
        return [x and (x.req.rid, x.length, x.pages, x.out, x.steps,
                       x.prefilled, x.order) for x in s.slots]

    def trie(s):
        """The trie as {token path: (page, LRU stamp)}, its clock and
        counters (``to_state`` lists nodes in walk order, which a
        reload may change)."""
        state, paths, out = s.prefix.to_state(), [], {}
        for nd in state["nodes"]:
            path = (paths[nd["parent"]] if nd["parent"] >= 0 else ()) + (
                tuple(nd["key"]),)
            paths.append(path)
            out[path] = (nd["page"], nd["last_used"])
        return out, state["clock"], state["stats"]

    def same_pools():
        pb = _leaf_paths(b.cache)
        return [k for k, t in pools.items()
                if not torch.equal(_bits(torch, t), _bits(torch, pb[k]))]

    host = {"table": np.array_equal(a.table, b.table),
            "lens": np.array_equal(a.lens, b.lens),
            "tokens": np.array_equal(a.tokens, b.tokens),
            "free_list": a.allocator.to_state() == b.allocator.to_state(),
            "trie": trie(a) == trie(b),
            "chunking": list(a._prefilling) == list(b._prefilling),
            "slots": slots(a) == slots(b)}
    differ = same_pools()
    if differ or not all(host.values()):
        raise AssertionError(f"{tag}: the restored Scheduler differs: "
                             f"pools {differ}, host {host}")
    if not a._prefilling:
        raise AssertionError(f"{tag}: no prompt mid-chunk at step {at}")
    a.eng, b.eng = _Tap(eng), _Tap(eng)
    for s in (a, b):
        s.admit()
        s.step()
    la, lb = a.eng.logits, b.eng.logits
    if (len(la) != len(lb) or not la or any(
            not torch.equal(_bits(torch, x), _bits(torch, y))
            for x, y in zip(la, lb))):
        raise AssertionError(f"{tag}: the step after the restore differs")
    differ = same_pools()
    if differ:
        raise AssertionError(f"{tag}: pools differ after the next step: "
                             f"{differ}")
    summary = {
        "step": step, "leaves": sorted(pools), "pool_mb": pool_bytes / 1e6,
        "snapshot_mb": disk / 1e6, "cut_ms": (t1 - t0) * 1e3,
        "write_ms": (t2 - t1) * 1e3, "restore_ms": (t4 - t3) * 1e3,
        "journal_append_ms_mean": st.mean(appends) * 1e3,
        "journal_append_ms_p50": st.median(appends) * 1e3,
        "next_step_logits_rows": sum(x.shape[0] for x in la)}
    print(f"    round trip at step {step} (a prompt mid-chunk): "
          f"{len(pools)} pool leaves ({', '.join(sorted(pools))}), "
          f"table, lengths, tokens, free list, trie and slots bitwise; "
          f"the next step's {len(la)} logits tensors bitwise")
    print(f"    snapshot {summary['snapshot_mb']:.2f} MB on disk (pools "
          f"{summary['pool_mb']:.2f} MB): cut {summary['cut_ms']:.3f} ms, "
          f"background write {summary['write_ms']:.3f} ms; restore "
          f"{summary['restore_ms']:.3f} ms; journal append (fsync) mean "
          f"{summary['journal_append_ms_mean']:.3f} ms, p50 "
          f"{summary['journal_append_ms_p50']:.3f} ms over "
          f"{JOURNAL_APPENDS}")
    del a, b
    return summary


def serve_recovery(torch, engines):
    """Phase 6b on the bf16 and int8 tinyllama-1.1b ``engines`` of
    ``_pc_engines``: the shared-prompt stream crash-free and twice
    crashed + recovered (``_recovery_streams``).  After the crash whose
    journal suffix holds no result, the recovered run repeats the
    crash-free schedule, and its streams must equal the crash-free ones
    on both pools.  After the crash whose suffix holds one, recovery
    takes that result from the journal and frees its slot at the
    snapshot's step, so later requests run beside other slot mates (the
    caveat of ``engine.snapshot``'s docstring): on bf16 pools its streams
    must equal the crash-free ones too; on int8 pools a stream that parts
    at a near-tie is replayed with its recovered tokens and held by
    ``_hold_streams`` at the full-width tolerance, and the count printed.
    Then the bitwise round trip and the costs (``snapshot_round_trip``)
    beside the card."""
    from repro_torch.engine import DecodeEngine

    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(f"durable serving, tinyllama-1.1b: the shared-prompt stream "
          f"({N_REQ} requests submitted at once, gen {GEN}, prefix cache "
          f"and chunks of {CHUNK_TOKENS} on) crash-free and through "
          f"serve_with_recovery; {card}")
    out = {}
    for kv_dtype, eng in engines.items():
        cfg = eng.cfg
        tag = f"tinyllama-1.1b, {kv_dtype} pools"

        def make_reqs(cfg=cfg):
            return _shared_requests(cfg)
        summaries, want, scheds = _recovery_streams(torch, tag, eng,
                                                    make_reqs)
        for summary, sched in zip(summaries, scheds):
            journal = summary["terminals_recovered_from_journal"] > 0
            if not summary["parted"]:
                continue
            if kv_dtype == "bf16" or not journal:
                raise AssertionError(
                    f"{tag}, crash at step {summary['crash_step']}: "
                    f"recovered streams {summary['parted']} differ from "
                    "the crash-free run")
            ref = DecodeEngine(cfg, eng.ecfg.replace(kernel_impl="torch"),
                               params=eng.params, device="cuda")
            held = _hold_streams(
                torch, tag, eng, ref, make_reqs(),
                [want[i].tokens.tolist() for i in range(N_REQ)],
                [sched.finished[i].tokens.tolist() for i in range(N_REQ)],
                chunk=CHUNK_TOKENS, tol=E2E_BF16_REL)
            summary["held"] = held
            print(f"    {len(held['parted'])} streams part from the "
                  f"crash-free run, first at request "
                  f"{held['first_split']['request']} step "
                  f"{held['first_split']['step']}; their recovered tokens "
                  f"replayed: kernel vs plain max|d logits| "
                  f"{held['max_rel_err']:.3e} of scale on the same int8 "
                  f"pages over {held['replayed_steps']} steps (limit "
                  f"{E2E_BF16_REL:g}); the replay picks the recovered "
                  f"token at {held['kernel_picks_plain_token']}/"
                  f"{held['replayed_steps']} steps")
            del ref
        del scheds
        rt = snapshot_round_trip(torch, tag, eng, make_reqs,
                                 summaries[-1]["crash_step"])
        out[kv_dtype] = {"crashes": summaries, "round_trip": rt,
                         "card": card}
    torch.cuda.empty_cache()
    return out


def deepseek_recovery(torch, params, cfg, routes):
    """Phase 6b on DeepSeek-V3 at depth 4 (the phase 7-8 weights): the
    shared-prompt stream on int8 latent pools (kernel 13 reading restored
    pages and per-page latent scales) crash-free and crashed + recovered
    at a step whose journal suffix holds a result
    (``_recovery_streams``).  A recovered stream that parts from the
    crash-free one (after the recovery, requests share the MoE decode
    group's capacity with other slot mates; int8 near-ties) is held by
    replaying the recovered streams through both paths in the served
    slot layout (``_replay_both``), and the count printed."""
    from repro_torch.engine import DecodeEngine, EngineConfig

    ecfg = EngineConfig(batch=SLOTS, max_len=PROMPT[1] + GEN, paged=True,
                        page_size=PAGE, n_pages=N_PAGES, kv_dtype="int8",
                        chunk_tokens=CHUNK_TOKENS, kernel_impl="cuda")
    eng = DecodeEngine(cfg, ecfg, params=params, device="cuda")
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    tag = f"{DEEPSEEK} depth {DEEPSEEK_DEPTH}, int8 latent pools"
    print(f"  durable serving, {tag}: the shared-prompt stream crash-free "
          f"and through serve_with_recovery; {card}")

    def make_reqs():
        return _shared_requests(cfg)
    (summary,), _, (sched,) = _recovery_streams(torch, tag, eng, make_reqs,
                                                crashes=(True,))
    if summary["parted"]:
        ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                           params=params, device="cuda")
        summary["replay"] = _replay_both(
            torch, eng, ref, sched.cache, make_reqs(), sched.finished,
            routes, chunk=CHUNK_TOKENS)
        del ref
    summary["card"] = card
    del eng, sched
    torch.cuda.empty_cache()
    return summary


def _dense_mla():
    """The dense family with MLA attention: reduced tinyllama with the JAX
    matrices' ``mla`` block (latent rank 16, rope width 8)."""
    from repro_torch.common.config import MLAConfig

    return _reduced("tinyllama-1.1b").replace(
        name="tinyllama-1.1b-reduced+mla", mla=MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
            nope_head_dim=16, v_head_dim=16))


def scheduler_reduced_prefix_chunked(torch, name, cfg=None):
    """Reduced fp32 config on the card (``cfg``, or ``name``'s), over a
    pool that preempts and requests that share a 16-token system prompt:
    with model-dtype pools the prefix-cache and chunked streams on the
    kernels equal the prefix-off, unchunked streams on the plain
    backend, token for token; with int8 pools (a hit or a later chunk
    reads the prefix through the quantized pages, so a near-tie may pick
    otherwise than the off/off run), and for the moe family (a chunk or
    a suffix is its own MoE group, whose capacity drops differ from the
    whole prompt's), they equal the plain backend's prefix and chunked
    streams, and the streams equal to the off/off run are counted; on
    int8 pools a stream that parts is held to its end through a replay
    with its prompt in chunks (``_hold_streams``)."""
    import numpy as np

    from repro_torch.engine import (DecodeEngine, EngineConfig, Request,
                                    Scheduler)

    cfg = cfg or _reduced(name)
    rng = np.random.default_rng(6)
    system = rng.integers(0, cfg.vocab, 16)
    prompts = ([np.concatenate([system, rng.integers(0, cfg.vocab, int(n))])
                for n in rng.integers(1, 20, 4)]
               + [rng.integers(0, cfg.vocab, int(n))
                  for n in rng.integers(5, 40, 3)])

    def run(eng, **kw):
        sched = Scheduler(eng, **kw)
        out = _drive(sched, [Request(rid=i, tokens=p.astype(np.int32),
                                     gen=16) for i, p in enumerate(prompts)])
        return ([out[i].tokens.tolist() for i in range(len(prompts))],
                sched)

    summary = {}
    for kv_dtype in ("bf16", "int8"):
        ecfg = EngineConfig(batch=3, max_len=64, paged=True, page_size=8,
                            n_pages=12, kv_dtype=kv_dtype,
                            chunk_tokens=8, kernel_impl="cuda")
        eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
        ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                           params=eng.params, device="cuda")
        on = dict(prefix_cache=True, chunked_prefill=True)
        got, sched = run(eng, **on)
        off, _ = run(ref)
        same_modes = kv_dtype == "int8" or cfg.family == "moe"
        want = run(ref, **on)[0] if same_modes else off
        st = sched.stats
        if not (st["prefix_hits"] > 0 and st["chunks"] > 0):
            raise AssertionError(f"{name} reduced fp32 {kv_dtype}: no "
                                 "prefix hit or no chunk")
        held = {}
        if kv_dtype == "int8":
            reqs = [Request(rid=i, tokens=p.astype(np.int32), gen=16)
                    for i, p in enumerate(prompts)]
            held = _hold_streams(
                torch, f"{cfg.name} reduced fp32 int8 prefix + chunked",
                eng, ref, reqs, got, want, chunk=ecfg.chunk_tokens)
        elif got != want:
            raise AssertionError(
                f"{name} reduced fp32 {kv_dtype}: prefix and chunked "
                "streams on the kernels differ from the plain backend's")
        same = sum(a == b for a, b in zip(got, off))
        print(f"  {cfg.name} fp32 Scheduler, {kv_dtype} pools, prefix + "
              f"chunked on the kernels: {st['prefix_hits']} hits, "
              f"{st['chunks']} chunks, {st['preempted']} preemptions; "
              f"{_stream_note(held)} to the plain "
              f"{'prefix + chunked' if same_modes else 'off/off'}"
              f" streams; {same}/{len(prompts)} equal to the plain off/off")
        summary[kv_dtype] = {k: st[k] for k in (
            "prefix_hits", "chunks", "preempted", "prefix_evictions")}
        summary[kv_dtype].update(streams_equal_off=same, parted=held)
    return summary


# ----------------------------------------------------------------------
# phase 6c: the frontend families (internvl2-2b vlm, seamless-m4t audio)
# ----------------------------------------------------------------------

VLM, AUDIO = "internvl2-2b", "seamless-m4t-large-v2"
# generate: batch 4, gen 32; internvl2's 128-token prompts after its 256
# frontend tokens, seamless's 16-token decoder prompts over 512 frames
FRONT_BATCH, VLM_PROMPT, AUDIO_PROMPT, AUDIO_FRAMES = 4, 128, 16, 512
# the Scheduler streams of ``_drive`` (8 slots, pages of 16): internvl2's
# first VLM_REQS requests at gen VLM_GEN, prompts of PROMPT tokens after
# its frontend, over VLM_PAGES pages, fewer than 8 such requests hold, so
# growth preempts (once: the page accounting alone decides it; cut from
# 24 requests at gen 32 over 192 pages to make room for phase 12's
# tensor-parallel serving); seamless's decoder prompts of AUDIO_PROMPTS
# tokens over AUDIO_FRAME_RANGE frames, under a cross budget of
# AUDIO_ENC_LEN, at gen GEN
VLM_REQS, VLM_GEN, VLM_PAGES = 12, 16, 160
AUDIO_PROMPTS, AUDIO_FRAME_RANGE, AUDIO_ENC_LEN = (4, 32), (160, 960), 1024
AUDIO_PAGES = 64
# seamless's Scheduler stream: the first AUDIO_REQS requests (cut from
# all N_REQ to make room for phase 13)
AUDIO_REQS = 12
# the seamless crash + recover: the first AUDIO_RECOVER_REQS requests of
# the stream, a snapshot every AUDIO_RECOVER_EVERY steps, each ~0.9 GB of
# pools (0.8 GB of it the cross cache) and ~100-260 MB of host JSON
# (every live and queued request's frames as lists, the JAX encoding):
# all 24 requests at a cadence of 12 cut 7 snapshots and took 108.8 s
# against 8.6 s crash-free on an NVIDIA H100 80GB HBM3 at 700 W.  The
# crash comes before any result finishes: a snapshot's write is still in
# flight at the next cadence step, so recovery restores the one before
# (cut from 12 requests to make room for phase 13)
AUDIO_RECOVER_EVERY, AUDIO_RECOVER_REQS = 12, 8
# fsynced journal appends of a vlm request (256 x 1024 floats as JSON;
# cut from 10 to make room for phase 13)
VLM_JOURNAL_APPENDS = 5
# internvl2's floor of replay steps that pick the served token, on bf16
# and int8 pools (seamless keeps REPLAY_AGREE): on an NVIDIA H100 80GB
# HBM3 at 700 W its bf16 replay at gen 32 agreed at 182/192 steps, every
# one of the 10 flips at a top-two gap of 0-2 bf16 steps (0-0.031), below
# that step's max |d| against the plain path; ``_vlm_prefill_layers``
# shows where that |d| comes from
VLM_REPLAY_AGREE = 0.9


def _front_requests(cfg, n, prompt, gen, seed):
    """``_requests`` with each request's frontend: internvl2's 256 patch
    embeddings, or seamless's frames (AUDIO_FRAME_RANGE of them), numpy
    fp32 from the same seed."""
    import numpy as np

    reqs = _requests(cfg, n, prompt, gen, seed)
    rng = np.random.default_rng(seed + 100)
    for r in reqs:
        m = (cfg.frontend_tokens if cfg.family == "vlm" else int(
            rng.integers(AUDIO_FRAME_RANGE[0], AUDIO_FRAME_RANGE[1] + 1)))
        r.frontend_emb = rng.standard_normal(
            (m, cfg.frontend_dim)).astype(np.float32)
    return reqs


def _front_stream(cfg):
    """(prompt range, gen, Scheduler options) of a frontend family's
    stream."""
    if cfg.family == "vlm":
        return PROMPT, VLM_GEN, {}
    return AUDIO_PROMPTS, GEN, {"enc_len": AUDIO_ENC_LEN}


def _no_fallback(what, variants):
    """No launch of kernels 1-5 and 7 on a non-Hopper variant."""
    bad = {k: n for k, n in variants.items() if n and k in (
        "vwr_matmul.gemm", "vwr_swiglu.gemm", "vwr_flash_decode.fma",
        "vwr_paged_flash_decode.fma", "vwr_paged_flash_decode_q8.fma")}
    if bad:
        raise AssertionError(f"{what}: launches off the Hopper variants: "
                             f"{bad}")


def serve_frontend_generate(torch, name):
    """Full-width ``generate`` of a frontend family on the kernels (after
    a warm-up one), launch counts and variants held (prefill products on
    wgmma tiles, decode products on split-K, kernel 4 on its split
    variant: the vlm's over its dense cache, seamless's twice a layer, the
    self cache and the cross cache of the 512 frames), then the stream
    teacher-forced through the plain path at 5e-2 of the logits' scale.
    Returns (summary, the engine's parameters)."""
    from repro_torch.common.module import leaves
    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, EngineConfig
    from repro_torch.kernels import build

    cfg = get_config(name)
    vlm = cfg.family == "vlm"
    B, gen, L = FRONT_BATCH, GEN, cfg.n_layers
    P = VLM_PROMPT if vlm else AUDIO_PROMPT
    n_front = cfg.frontend_tokens if vlm else AUDIO_FRAMES
    ecfg = EngineConfig(batch=B, max_len=(n_front if vlm else 0) + P + gen,
                        kernel_impl="cuda")
    t0 = time.perf_counter()
    eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
    _condition(torch, eng.params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in leaves(eng.params))
    print(f"{name}: {cfg.n_layers} layers"
          + (f" (+ {cfg.enc_layers} encoder)" if cfg.enc_layers else "")
          + f", d {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.d_head}, vocab {cfg.vocab}, {n_params / 1e9:.3f} B params "
          f"({time.perf_counter() - t0:.1f} s to init); batch {B}, "
          + (f"{n_front} frontend tokens + {P}" if vlm
             else f"{n_front} frames, decoder prompt {P}") + f", gen {gen}")
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, P), generator=g,
                                     device="cuda", dtype=torch.int32),
             "frontend_emb": torch.randn(B, n_front, cfg.frontend_dim,
                                         generator=g, device="cuda")}
    eng.generate(batch, gen=gen)
    build.reset_launches()
    tokens, stats = eng.generate(batch, gen=gen)
    torch.cuda.synchronize()
    launches, variants = dict(build.LAUNCHES), dict(build.VARIANTS)
    steps = gen - 1
    if vlm:
        want = {"vwr_matmul": 5 * L + L * steps, "vwr_swiglu": L * gen,
                "vwr_attention": L, "vwr_flash_decode": L * steps,
                "vwr_matmul.wgmma": 5 * L, "vwr_matmul.splitk": L * steps,
                "vwr_swiglu.wgmma": L * gen,
                "vwr_flash_decode.split": L * steps}
    else:
        E = cfg.enc_layers
        want = {"vwr_matmul": 6 * E + 7 * L + 2 * L * steps,
                "vwr_swiglu": 0, "vwr_attention": L,
                "vwr_flash_decode": 2 * L * steps,
                "vwr_matmul.wgmma": 6 * E + 7 * L,
                "vwr_matmul.splitk": 2 * L * steps,
                "vwr_flash_decode.split": 2 * L * steps}
    print(f"  launches in generate: "
          f"{ {k: n for k, n in launches.items() if n} }")
    for k, n in want.items():
        got = launches[k] if k in launches else variants[k]
        if got != n:
            raise AssertionError(f"{name}: {k} launched {got} times, "
                                 f"expected {n}")
    _no_fallback(name, variants)
    if tokens.shape != (B, gen) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"{name}: bad tokens {tokens.shape}")
    print(f"  prefill_tok_s {stats['prefill_tok_s']:.1f}  decode_tok_s "
          f"{stats['decode_tok_s']:.1f}  (t_prefill {stats['t_prefill_s']:.4f}"
          f" s, t_decode {stats['t_decode_s']:.4f} s)")
    ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                       params=eng.params, device="cuda")
    rel, _ = _teacher_forced(torch, eng, ref, batch, tokens,
                             eng.prefill_len(batch), gen, check_greedy=True)
    print(f"  teacher-forced logits vs plain path: max |d|/max|ref| "
          f"{max(rel):.3e} over {len(rel)} steps (limit {E2E_BF16_REL:g}),"
          f" the largest at step {rel.index(max(rel))} (step 0: the "
          "prefill's logits)")
    if not max(rel) <= E2E_BF16_REL:
        raise AssertionError(f"{name}: logits diverge from the plain path")
    layers = _vlm_prefill_layers(torch, eng, ref, batch) if vlm else None
    params = eng.params
    del eng, ref
    torch.cuda.empty_cache()
    return {"arch": name, "batch": B, "prompt": P, "frontend": n_front,
            "gen": gen, "n_params": n_params,
            "launches": {k: n for k, n in launches.items() if n},
            "variants": {k: n for k, n in variants.items() if n},
            "logits_rel_err": rel, "prefill_layers": layers, **stats}, params


def _rel(a, b):
    """max |a - b| / max |b|, in fp32."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def _vlm_prefill_layers(torch, eng, ref, batch):
    """Where internvl2's logits gap against the plain path comes from:
    the prefill of ``batch`` layer by layer on the kernel path, the plain
    bf16 path and the plain path in fp32 over the same weights widened,
    each layer's output hidden states (B, 256 + P, d) held as ``_rel``
    between the paths, and the prefill's logits (``lm.prefill``)
    likewise.  A kernel fault shows as a step at one layer in the kernel
    path's distance to fp32 that the plain bf16 path does not share;
    bf16 rounding as both bf16 paths drifting from fp32 alike.  Raises
    if the kernel path ends farther from fp32 than twice the plain bf16
    path."""
    from repro_torch.common.module import map_tree
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    cfg32 = ref.cfg.replace(dtype="float32")
    p32 = map_tree(lambda t: t.float(), eng.params)

    def hidden(cfg, params):
        x = L.embed(params["embed"], batch["tokens"]).to(L.dt(cfg))
        pre = L.frontend_proj(params["frontend"], batch["frontend_emb"])
        x = torch.cat([pre.to(x.dtype), x], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        hs = []

        def layer(x, lp, key, i, moe):
            x, kv = lm._dense_body(cfg, pos, x, lp)
            hs.append(x.float())
            return x, kv

        lm._run_groups(cfg, params, x, layer, False)
        logits = lm.prefill(params, batch, cfg)[0][:, :cfg.vocab]
        return hs, logits

    out = _path_gaps(torch, "internvl2", "layer",
                     hidden(eng.cfg, eng.params),
                     hidden(ref.cfg, eng.params), hidden(cfg32, p32))
    del p32
    torch.cuda.empty_cache()
    return out


def _path_gaps(torch, what, unit, kernel, plain, fp32):
    """``_rel`` between the kernel path, the plain bf16 path and the plain
    path in fp32, each given as (hidden states after each ``unit``, the
    prefill's logits); printed at five sampled units.  Raises if the
    kernel path's logits end farther from fp32 than twice the plain bf16
    path's."""
    (hk, lk), (hp, lp), (h32, l32) = kernel, plain, fp32
    out = {"kernel_vs_plain": [_rel(a, b) for a, b in zip(hk, hp)],
           "kernel_vs_fp32": [_rel(a, b) for a, b in zip(hk, h32)],
           "plain_vs_fp32": [_rel(a, b) for a, b in zip(hp, h32)],
           "logits": {"kernel_vs_plain": _rel(lk, lp),
                      "kernel_vs_fp32": _rel(lk, l32),
                      "plain_vs_fp32": _rel(lp, l32)}}
    n = len(out["kernel_vs_plain"])
    picks = sorted({0, n // 4, n // 2, 3 * n // 4, n - 1})
    print(f"  prefill {unit} by {unit} (hidden states, max |d|/max|ref|; "
          f"{unit}s {', '.join(str(i + 1) for i in picks)}): " + "; ".join(
              f"{k.replace('_', ' ')} " + ", ".join(
                  f"{out[k][i]:.3e}" for i in picks)
              for k in ("kernel_vs_plain", "kernel_vs_fp32",
                        "plain_vs_fp32")))
    steps = [b - a for a, b in zip([0.0] + out["kernel_vs_fp32"],
                                   out["kernel_vs_fp32"])]
    print(f"    kernel vs fp32: largest rise {max(steps):.3e} at {unit} "
          f"{steps.index(max(steps)) + 1}; prefill logits: kernel vs plain "
          f"{out['logits']['kernel_vs_plain']:.3e}, kernel vs fp32 "
          f"{out['logits']['kernel_vs_fp32']:.3e}, plain vs fp32 "
          f"{out['logits']['plain_vs_fp32']:.3e}")
    if not (out["logits"]["kernel_vs_fp32"]
            <= 2 * out["logits"]["plain_vs_fp32"]):
        raise AssertionError(f"{what} prefill: the kernel path ends "
                             "farther from fp32 than twice the plain path")
    return out


def _front_engine(torch, cfg, params, kv_dtype):
    from repro_torch.engine import DecodeEngine, EngineConfig

    vlm = cfg.family == "vlm"
    prompt, gen, _ = _front_stream(cfg)
    ecfg = EngineConfig(
        batch=SLOTS, max_len=(cfg.frontend_tokens if vlm else 0)
        + prompt[1] + gen, paged=True, page_size=PAGE,
        n_pages=VLM_PAGES if vlm else AUDIO_PAGES, kv_dtype=kv_dtype,
        kernel_impl="cuda")
    return DecodeEngine(cfg, ecfg, params=params, device="cuda")


def serve_frontend_scheduler(torch, name, params, kv_dtype):
    """A frontend family's Scheduler stream at full width on the kernels
    (``_front_requests``; seamless under ``enc_len`` AUDIO_ENC_LEN):
    every request FINISHED, every page free, launches held (kernel 5 or
    7 a layer a step for the vlm's pools, kernel 5 twice for seamless:
    its self pools and the identity-paged cross cache, all on mma;
    ``vwr_attention`` a layer a prefill; no product off its Hopper
    variants), then finished requests replayed teacher-forced in the
    live slots against a batch-1 plain engine at 5e-2
    (``_replay_slots``)."""
    from repro_torch.configs import get_config
    from repro_torch.engine import RequestStatus, Scheduler
    from repro_torch.kernels import build

    cfg = get_config(name)
    vlm = cfg.family == "vlm"
    n_req = VLM_REQS if vlm else AUDIO_REQS
    eng = _front_engine(torch, cfg, params, kv_dtype)
    prompt, gen, kw = _front_stream(cfg)
    print(f"Scheduler, {name}, {kv_dtype} pools: {SLOTS} slots, "
          f"{eng.n_pages} pages of {PAGE}, {n_req} requests, prompts "
          f"{prompt[0]}-{prompt[1]}"
          + (f" after {cfg.frontend_tokens} frontend tokens" if vlm else
             f", {AUDIO_FRAME_RANGE[0]}-{AUDIO_FRAME_RANGE[1]} frames "
             f"(enc_len {AUDIO_ENC_LEN})") + f", gen {gen}")
    _drive(Scheduler(eng, **kw), _front_requests(cfg, 4, prompt, 4, seed=5))
    reqs = _front_requests(cfg, N_REQ, prompt, gen, seed=4)[:n_req]
    sched = Scheduler(eng, **kw)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    out = _drive(sched, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, variants = dict(build.LAUNCHES), dict(build.VARIANTS)
    st, L = sched.stats, cfg.n_layers
    paged = "vwr_paged_flash_decode" + ("_q8" if kv_dtype == "int8" else "")
    other = ("vwr_paged_flash_decode" if kv_dtype == "int8"
             else "vwr_paged_flash_decode_q8")
    per_step = L if vlm else 2 * L
    want = {paged: per_step * st["steps"], other: 0, "vwr_flash_decode": 0,
            "vwr_attention": L * st["prefills"],
            f"{paged}.mma": per_step * st["steps"]}
    if vlm:
        want.update(vwr_swiglu=L * (st["prefills"] + st["steps"]),
                    vwr_matmul=L * (5 * st["prefills"] + st["steps"]))
    else:
        want.update(vwr_swiglu=0, vwr_matmul=(
            (6 * cfg.enc_layers + 7 * L) * st["prefills"]
            + 2 * L * st["steps"]))
    print(f"  launches: {({k: n for k, n in launches.items() if n})}")
    for k, n in want.items():
        got = launches[k] if k in launches else variants[k]
        if got != n:
            raise AssertionError(f"scheduler {name} {kv_dtype}: {k} "
                                 f"launched {got} times, expected {n}")
    _no_fallback(f"scheduler {name} {kv_dtype}", variants)
    bad = {rid: r.status for rid, r in out.items()
           if r.status is not RequestStatus.FINISHED or len(r) != gen}
    if len(out) != n_req or bad:
        raise AssertionError(f"scheduler {name} {kv_dtype}: unfinished "
                             f"{bad}")
    sched.allocator.check()
    if sched.allocator.free_pages != eng.n_pages or sched.enc_lens.any():
        raise AssertionError("pages or encoder rows left after the drain")
    if vlm and st["preempted"] < 1:
        raise AssertionError(f"{VLM_PAGES} pages: growth never preempted")
    n_tok = sum(len(r) for r in out.values())
    lat, itl = sched.latency_percentiles(), sched.itl_percentiles()
    summary = {
        "kv_dtype": kv_dtype, "n_pages": eng.n_pages, "steps": st["steps"],
        "prefills": st["prefills"], "preempted": st["preempted"],
        "parked": st["parked"], "peak_pages": st["peak_pages"],
        "table_widths": {str(k): v for k, v in
                         sorted(st["table_widths"].items())},
        "generated_tokens": n_tok, "wall_s": wall,
        "gen_tok_s": n_tok / wall,
        "latency_p50_s": lat["p50"], "latency_p99_s": lat["p99"],
        "itl_p50_s": itl["p50"], "itl_p99_s": itl["p99"],
        "launches": {k: n for k, n in launches.items() if n},
        "variants": {k: n for k, n in variants.items() if n}}
    print(f"  steps {st['steps']}, prefills {st['prefills']}, preempted "
          f"{st['preempted']}, peak pages {st['peak_pages']}/{eng.n_pages},"
          f" table widths {summary['table_widths']}")
    print(f"  {n_tok} tokens in {wall:.4f} s: {summary['gen_tok_s']:.1f} "
          f"generated tok/s; request latency p50 {lat['p50']:.4f} s p99 "
          f"{lat['p99']:.4f} s; ITL p50 {itl['p50'] * 1e3:.3f} ms p99 "
          f"{itl['p99'] * 1e3:.3f} ms")
    rel, agree, flips = _replay_slots(
        torch, eng, sched.cache, reqs, out, kv_dtype,
        VLM_REPLAY_AGREE if vlm else REPLAY_AGREE, min_slots=4, gen=gen)
    summary.update(logits_rel_err=rel, replay_agree=agree,
                   replay_flips=flips)
    del eng, sched
    torch.cuda.empty_cache()
    return summary


def audio_recovery(torch, params):
    """Phase 6b on seamless-m4t: the first AUDIO_RECOVER_REQS requests of
    its Scheduler stream (all submitted at once, ``enc_len``
    AUDIO_ENC_LEN) crash-free, then through ``serve_with_recovery`` with
    a snapshot every AUDIO_RECOVER_EVERY steps (into a temporary
    directory outside the repo, removed afterwards) and a CrashFault on
    the fresh run at a step after two snapshots with no result finished
    since the one before the last (the last one's write may still be in
    flight, and then recovery restores the one before): the restored
    slots carry their encoder rows and lengths, every stream equals the
    crash-free run's, and kernel 5 launches twice a layer a step over
    both processes, all on mma."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.engine import RequestStatus, Scheduler, faults
    from repro_torch.kernels import build
    from repro_torch.runtime.resilience import (RestartPolicy,
                                                serve_with_recovery)

    cfg = get_config(AUDIO)
    eng = _front_engine(torch, cfg, params, "bf16")
    prompt, _, kw = _front_stream(cfg)

    n_req = AUDIO_RECOVER_REQS

    def make_reqs():
        return _front_requests(cfg, N_REQ, prompt, GEN, seed=4)[:n_req]

    def check(what, sched, out):
        bad = {rid: r.status for rid, r in out.items()
               if r.status is not RequestStatus.FINISHED or len(r) != GEN}
        if len(out) != n_req or bad:
            raise AssertionError(f"{AUDIO} recovery, {what}: unfinished "
                                 f"{bad}")
        sched.allocator.check()
        if sched.allocator.free_pages != eng.n_pages:
            raise AssertionError(f"{AUDIO} recovery, {what}: pages left")

    watch = _Watch()
    ref = Scheduler(eng, snapshotter=watch, **kw)
    for r in make_reqs():
        ref.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref.run()
    torch.cuda.synchronize()
    wall_ref = time.perf_counter() - t0
    check("crash-free", ref, want)
    every = AUDIO_RECOVER_EVERY

    def before_last(k):
        return every * (k // every - 1)
    steps = [k for k in watch.finished if k > 2 * every and k % every
             and watch.finished[k] == watch.finished[before_last(k)]]
    if not steps:
        raise AssertionError(f"{AUDIO}: no crash step after two snapshots "
                             "without a result since the one before")
    crash = min(steps)
    d = tempfile.mkdtemp(prefix="chip_smoke_recovery_")
    info = {}

    def on_start(sched, fresh):
        if fresh:
            faults.inject(sched, decode_faults=[
                faults.CrashFault(step=crash)])
        else:
            step = info["restored_step"] = sched.stats["steps"]
            info["enc_rows"] = int((sched.enc_lens > 0).sum())
            info["host_mb"] = os.path.getsize(os.path.join(
                d, f"step_{step}", "host.s0.npy")) / 1e6

    def submit(sched):
        for r in make_reqs():
            sched.submit(r)
    try:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        sched = serve_with_recovery(
            eng, d, submit, snapshot_every=every,
            policy=RestartPolicy(max_restarts=1, backoff_s=0.0),
            on_start=on_start, sched_kwargs=kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, variants = dict(build.LAUNCHES), dict(build.VARIANTS)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    got = sched.finished
    check(f"crash at step {crash}", sched, got)
    if not info.get("restored_step") or not info["enc_rows"]:
        raise AssertionError(f"{AUDIO}: no snapshot with live encoder rows "
                             "restored")
    steps_run = crash + sched.stats["steps"] - info["restored_step"]
    k5 = "vwr_paged_flash_decode"
    L = cfg.n_layers
    if (launches[k5] != 2 * L * steps_run
            or variants[f"{k5}.mma"] != launches[k5]):
        raise AssertionError(f"{AUDIO} recovery: kernel 5 launched "
                             f"{launches[k5]} times, expected 2 x {L} x "
                             f"{steps_run}, all on mma")
    parted = [rid for rid in sorted(want)
              if not np.array_equal(got[rid], want[rid])]
    print(f"  {AUDIO}, bf16 pools, {n_req} requests: crash-free "
          f"{ref.stats['steps']} steps, "
          f"{wall_ref:.4f} s; crash at step {crash} (a snapshot every "
          f"{every} steps), restored from step {info['restored_step']} "
          f"with {info['enc_rows']} slots holding encoder rows (its host "
          f"JSON {info['host_mb']:.1f} MB); "
          f"{steps_run} steps over both processes, kernel 5 launched "
          f"{launches[k5]} times, all on mma; wall {wall:.4f} s; "
          f"{n_req - len(parted)}/{n_req} streams equal to the crash-free "
          "run")
    if parted:
        raise AssertionError(f"{AUDIO} recovery: streams {parted} differ "
                             "from the crash-free run")
    summary = {"requests": n_req, "crash_step": crash,
               "snapshot_every": every,
               "restored_step": info["restored_step"],
               "enc_rows_restored": info["enc_rows"],
               "restored_host_json_mb": info["host_mb"],
               "steps_crash_free": ref.stats["steps"],
               "steps_run": steps_run, "wall_crash_free_s": wall_ref,
               "wall_recovered_s": wall,
               "snapshots": sched.snapshotter.saved,
               "streams_parted": len(parted)}
    del eng, ref, sched
    torch.cuda.empty_cache()
    return summary


def vlm_journal_append(torch):
    """VLM_JOURNAL_APPENDS fsynced journal appends of an internvl2 submit
    (256 x 1024 frontend floats as JSON, the JAX encoding) into a
    temporary directory outside the repo (removed afterwards), timed;
    the journal replays the request with its embeddings intact."""
    import os
    import shutil
    import statistics as stats_
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.engine import RequestJournal, read_events
    from repro_torch.engine.journal import request_from_event

    cfg = get_config(VLM)
    req = _front_requests(cfg, 1, PROMPT, GEN, seed=9)[0]
    d = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    try:
        path = os.path.join(d, "journal.jsonl")
        journal = RequestJournal(path)
        times = []
        for i in range(VLM_JOURNAL_APPENDS):
            req.rid = i
            t0 = time.perf_counter()
            journal.submit(req)
            times.append(1e3 * (time.perf_counter() - t0))
        journal.close()
        line = os.path.getsize(path) / VLM_JOURNAL_APPENDS
        back = request_from_event(read_events(path)[-1])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if not np.array_equal(back.frontend_emb, req.frontend_emb):
        raise AssertionError("the journal lost a vlm request's frontend")
    out = {"appends": VLM_JOURNAL_APPENDS, "bytes_a_line": line,
           "mean_ms": stats_.fmean(times), "p50_ms": stats_.median(times),
           "max_ms": max(times)}
    print(f"  {VLM} journal append (a submit with {cfg.frontend_tokens} x "
          f"{cfg.frontend_dim} frontend floats, {line / 1e6:.2f} MB a line, "
          f"fsynced): mean {out['mean_ms']:.3f} ms, p50 {out['p50_ms']:.3f}"
          f" ms, max {out['max_ms']:.3f} ms over {VLM_JOURNAL_APPENDS}")
    return out


def serve_frontends(torch):
    """Phase 6c: internvl2-2b and seamless-m4t-large-v2 at full width,
    random conditioned weights: ``generate``, the Scheduler streams
    (internvl2 on bf16 and int8 pools, seamless on bf16 pools; its int8
    pools refused), the seamless crash + recover of phase 6b and the vlm
    journal append, beside the card."""
    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, EngineConfig

    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    out = {"card": card}
    gen_vlm, params = serve_frontend_generate(torch, VLM)
    out[VLM] = {"generate": gen_vlm, "scheduler": [
        serve_frontend_scheduler(torch, VLM, params, kv)
        for kv in ("bf16", "int8")]}
    del params
    torch.cuda.empty_cache()
    out[VLM]["journal_append"] = vlm_journal_append(torch)
    gen_audio, params = serve_frontend_generate(torch, AUDIO)
    out[AUDIO] = {"generate": gen_audio, "scheduler": [
        serve_frontend_scheduler(torch, AUDIO, params, "bf16")]}
    try:
        DecodeEngine(get_config(AUDIO), EngineConfig(
            batch=SLOTS, max_len=64, paged=True, kv_dtype="int8"),
            params=params, device="cuda")
    except ValueError as e:
        out[AUDIO]["int8_refused"] = str(e)
        print(f"  {AUDIO}, int8 pools: refused ({e})")
    else:
        raise AssertionError(f"{AUDIO}: int8 pools must be refused")
    out[AUDIO]["recovery"] = audio_recovery(torch, params)
    del params
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# phase 6d: the recurrent families, zamba2 (hybrid) and xlstm (ssm)
# ----------------------------------------------------------------------

HYBRID, XLSTM = "zamba2-1.2b", "xlstm-350m"
# generate: batch 4, a 256-token prompt (one chunk of 256), gen 32
RECUR_BATCH, RECUR_PROMPT = 4, 256
# the recurrence held in fp32: a 512-token prefill (two chunks) against
# a 256-token prefill and 256 teacher-forced decode steps, batch 2
RECUR_SPLIT, RECUR_CHECK_BATCH = 256, 2
# calls a decode step's part is timed over
SHARE_REPS = 10


def _part_ms(torch, fn, reps=SHARE_REPS):
    """Mean CUDA-event ms of ``fn`` over ``reps`` calls issued back to
    back after one untimed call: host launches included, since a decode
    step's parts are many small kernels each."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _recurrent_layers(lm, cfg, params):
    """Every recurrent block's parameters in model order, with its kind
    ("mamba2", "mlstm", "slstm") and its pre-norm (None for sLSTM, which
    norms its own input)."""
    out = []
    if cfg.family == "hybrid":
        k, n_main, tail, _ = lm._hybrid_groups(cfg)
        for g in range(n_main):
            gp = lm._layer(params["mamba_main"], g)
            gn = lm._layer(params["mamba_norms"], g)
            out += [("mamba2", lm._layer(gp, i), lm._layer(gn, i))
                    for i in range(k)]
        out += [("mamba2", lm._layer(params["mamba_tail"], i),
                 lm._layer(params["tail_norms"], i)) for i in range(tail)]
        return out
    m_per, n_groups = lm._ssm_groups(cfg)
    for g in range(n_groups):
        gp = lm._layer(params["mlstm"], g)
        gn = lm._layer(params["mlstm_norms"], g)
        out += [("mlstm", lm._layer(gp, i), lm._layer(gn, i))
                for i in range(m_per)]
        out.append(("slstm", lm._layer(params["slstm"], g), None))
    return out


def _recurrent_breakdown(torch, eng, cache, prompts, pos):
    """Where a decode step's and a prefill's time goes: a whole decode
    step (at ``pos``, over ``cache``, which it writes) beside each block
    kind's steps alone (every block of the model on one input, states
    read from ``cache`` and not written back), the shared block's decode
    (zamba2: attention + MLP, once an invocation) and kernels 1-4 alone
    as a step launches them (the MLP's swiglu and down projection and
    kernel 4, once an invocation); the prefill of ``prompts`` beside
    each block kind's forward alone.  CUDA-event ms, host launches
    included."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import vwr_decode as KD
    from repro_torch.models import lm
    from repro_torch.models import ssm as SSM
    from repro_torch.models import xlstm as XL

    cfg, params = eng.cfg, eng.params
    B = prompts.shape[0]
    g = torch.Generator(device="cuda").manual_seed(29)
    dt = getattr(torch, cfg.dtype)
    x = torch.randn(B, cfg.d_model, generator=g, device="cuda").to(dt)
    xs = torch.randn(B, prompts.shape[1], cfg.d_model, generator=g,
                     device="cuda").to(dt)
    tok = prompts[:, -1].contiguous()
    layers = _recurrent_layers(lm, cfg, params)
    states = {"mamba2": [], "mlstm": [], "slstm": []}
    if cfg.family == "hybrid":
        k, n_main, tail, n_inv = lm._hybrid_groups(cfg)
        states["mamba2"] = (
            [lm._state_at(cache["mamba_main"], gi, i)
             for gi in range(n_main) for i in range(k)]
            + [lm._state_at(cache["mamba_tail"], i) for i in range(tail)])
    else:
        m_per, n_groups = lm._ssm_groups(cfg)
        n_inv = 0
        states["mlstm"] = [lm._state_at(cache["mlstm"], gi, i)
                           for gi in range(n_groups) for i in range(m_per)]
        states["slstm"] = [lm._state_at(cache["slstm"], gi)
                           for gi in range(n_groups)]
    step_fn = {"mamba2": SSM.mamba2_step, "mlstm": XL.mlstm_step,
               "slstm": XL.slstm_step}
    fwd_fn = {"mamba2": SSM.mamba2_forward, "mlstm": XL.mlstm_forward,
              "slstm": XL.slstm_forward}

    def blocks(kind, decode):
        its = iter(states[kind])
        work = [(p, next(its) if decode else None)
                for kd, p, _ in layers if kd == kind]

        def run():
            for p, st in work:
                if decode:
                    step_fn[kind](p, x, st, cfg)
                else:
                    fwd_fn[kind](p, xs, cfg)
        return run

    out = {"decode_step_ms": _part_ms(
        torch, lambda: eng.decode_step(tok, pos, cache))}
    kinds = sorted({kd for kd, _, _ in layers})
    with torch.no_grad():
        for kind in kinds:
            out[f"{kind}_blocks_ms"] = _part_ms(torch, blocks(kind, True))
        if n_inv:
            sp = params["shared_attn"]
            rope = lm._step_rope(cfg, torch.full((1,), pos,
                                                 dtype=torch.float32,
                                                 device="cuda"))
            ck, cv = cache["attn_k"][0], cache["attn_v"][0]

            def shared():
                for _ in range(n_inv):
                    h = lm._norm(cfg, sp["attn_norm"], x)
                    y = x + lm._decode_gqa(cfg, sp["attn"], h, ck, cv, pos,
                                           rope)
                    lm._ffn_delta(cfg, sp, y, False)
            q = torch.randn(B * cfg.n_kv_heads, cfg.q_per_kv, cfg.d_head,
                            generator=g, device="cuda").to(dt)

            def kernels():
                for _ in range(n_inv):
                    hh = ops.vwr_swiglu(x, sp["mlp"]["wg"], sp["mlp"]["wi"])
                    ops.vwr_matmul(hh, sp["mlp"]["wo"])
                    KD.vwr_flash_decode(q, ck, cv, pos + 1)
            out["shared_block_ms"] = _part_ms(torch, shared)
            out["kernels_1_4_ms"] = _part_ms(torch, kernels)
        else:
            out["kernels_1_4_ms"] = 0.0
        out["prefill_ms"] = _part_ms(
            torch, lambda: eng.prefill({"tokens": prompts}), reps=3)
        for kind in kinds:
            out[f"{kind}_prefill_ms"] = _part_ms(torch, blocks(kind, False),
                                                 reps=3)
    step = out["decode_step_ms"]
    shares = {k[:-3]: v / step for k, v in out.items()
              if k.endswith("_ms") and k not in ("decode_step_ms",
                                                 "prefill_ms")
              and "prefill" not in k}
    print(f"  decode step (B{B}, pos {pos}): {step:.3f} ms; shares of it "
          "(the part alone / the step): "
          + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()))
    print(f"  prefill (B{B} x {prompts.shape[1]}): {out['prefill_ms']:.2f} "
          "ms; " + ", ".join(f"{kind} blocks alone "
                             f"{out[f'{kind}_prefill_ms']:.2f} ms"
                             for kind in kinds))
    out["decode_shares"] = shares
    return out


def _hybrid_prefill_blocks(torch, eng, ref, prompts, p32):
    """zamba2's prefill of ``prompts`` block by block (after each Mamba2
    block and each shared-block invocation) on the kernel path, the plain
    bf16 path and the plain path in fp32 over the same weights widened
    (``p32``), held by ``_path_gaps``: the Mamba2 blocks launch no kernel,
    so there the two bf16 paths part only through the shared blocks'
    kernels, and both drift from fp32 alike."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import ssm as SSM

    def hidden(cfg, params):
        x = L.embed(params["embed"], prompts).to(L.dt(cfg))
        pos = torch.arange(x.shape[1], device=x.device)
        k, hs = cfg.mamba2.attn_every, []
        for n, (_, lp, ln) in enumerate(_recurrent_layers(lm, cfg, params)):
            x = x + SSM.mamba2_forward(lp, lm._norm(cfg, ln, x), cfg)[0]
            hs.append(x.float())
            if (n + 1) % k == 0 or n + 1 == cfg.n_layers:
                x = lm._dense_body(cfg, pos, x, params["shared_attn"])[0]
                hs.append(x.float())
        logits = lm.prefill(params, {"tokens": prompts}, cfg)[0]
        return hs, logits[:, :cfg.vocab]

    with torch.no_grad():
        return _path_gaps(torch, eng.cfg.name, "block",
                          hidden(eng.cfg, eng.params),
                          hidden(ref.cfg, eng.params),
                          hidden(ref.cfg.replace(dtype="float32"), p32))


def recurrence_fp32(torch, name, p32):
    """The recurrence held at full width in fp32 (TF32 off): the logits of
    a 512-token prefill (two chunks of 256) at positions 255-511 against
    a 256-token prefill's and then 256 teacher-forced ``decode_step``s'
    over the same (conditioned) weights widened to fp32 (``p32``), within
    1e-3 of the logits' scale.  It crosses a chunk boundary, so it holds
    the chunk carry and ``mamba2_step`` / ``mlstm_step`` / ``slstm_step``
    against ``_ssd_scan`` / ``mlstm_chunkwise`` / the sLSTM loop."""
    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, EngineConfig
    from repro_torch.models import lm

    cfg = get_config(name).replace(dtype="float32")
    B, S = RECUR_CHECK_BATCH, RECUR_SPLIT
    g = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (B, 2 * S), generator=g,
                         device="cuda", dtype=torch.int32)
    V = cfg.vocab
    t0 = time.perf_counter()
    with torch.no_grad():
        h = lm.backbone(p32, toks, cfg).h
        want = lm._logits(p32, h[:, S - 1:], cfg).float()[..., :V]
    del h
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    eng = DecodeEngine(cfg, EngineConfig(batch=B, max_len=2 * S,
                                         kernel_impl="cuda"),
                       params=p32, device="cuda")
    t0 = time.perf_counter()
    logits, cache = eng.prefill({"tokens": toks[:, :S]})
    errs = [(logits[:, :V] - want[:, 0]).abs().max().item()]
    for i in range(S):
        logits, cache = eng.decode_step(toks[:, S + i], S + i, cache)
        errs.append((logits[:, :V] - want[:, i + 1]).abs().max().item())
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    scale = max(1.0, want.abs().max().item())
    worst = max(errs) / scale
    at = errs.index(max(errs))
    print(f"  {name} fp32 recurrence: prefill {2 * S} vs prefill {S} + {S} "
          f"decode steps, max|d logits| / scale {worst:.3e} (limit "
          f"{E2E_FP32_TOL:g}; scale {scale:.3f}), the largest at position "
          f"{S - 1 + at}; {t_full:.2f} s / {t_steps:.2f} s")
    if not worst <= E2E_FP32_TOL:
        raise AssertionError(f"{name}: decode steps part from the chunked "
                             "prefill")
    del eng, cache, want
    torch.cuda.empty_cache()
    return {"batch": B, "split": S, "rel_err": worst, "at": S - 1 + at,
            "scale": scale, "t_prefill_s": t_full, "t_steps_s": t_steps}


def serve_recurrent_generate(torch, name, expected, variants):
    """Full-width ``generate`` of a recurrent family on the kernel backend
    (after a warm-up one): zamba2's shared block launches kernels 1-4 at
    the dense per-layer counts (``expected`` / ``variants`` of phase 3)
    times its 7 invocations, on their Hopper variants; xlstm launches no
    kernel at all.  The stream teacher-forced through the plain path at
    5e-2 of the logits' scale (zamba2's prefill also block by block
    against the plain path in bf16 and in fp32), where the time goes,
    the fp32 recurrence and the paged engine's refusal.  Returns the
    summary."""
    from repro_torch.common.module import leaves, map_tree
    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, EngineConfig
    from repro_torch.kernels import build
    from repro_torch.models import lm

    cfg = get_config(name)
    hybrid = cfg.family == "hybrid"
    B, P, gen = RECUR_BATCH, RECUR_PROMPT, GEN
    ecfg = EngineConfig(batch=B, max_len=P + gen, kernel_impl="cuda")
    t0 = time.perf_counter()
    eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
    _condition(torch, eng.params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in leaves(eng.params))
    if hybrid:
        mc = cfg.mamba2
        k, n_main, tail, n_inv = lm._hybrid_groups(cfg)
        layout = (f"{cfg.n_layers} Mamba2 blocks ({n_main} x {k} + "
                  f"{tail}; d_inner {mc.expand * cfg.d_model}, "
                  f"{mc.expand * cfg.d_model // mc.head_dim} heads of "
                  f"{mc.head_dim}, d_state {mc.d_state}, chunk {mc.chunk}), "
                  f"the shared block {n_inv} times ({cfg.n_heads} heads of "
                  f"{cfg.d_head}, swiglu {cfg.d_ff})")
    else:
        m_per, n_groups = lm._ssm_groups(cfg)
        n_inv = 0
        layout = (f"{n_groups} groups of {m_per} mLSTM + 1 sLSTM (d "
                  f"{cfg.d_model}, {cfg.n_heads} heads of P "
                  f"{int(cfg.xlstm.proj_factor * cfg.d_model) // cfg.n_heads}"
                  f", chunk {cfg.xlstm.chunk})")
    print(f"{name}: {layout}, vocab {cfg.vocab}, {n_params / 1e9:.3f} B "
          f"params ({time.perf_counter() - t0:.1f} s to init); batch {B}, "
          f"prompt {P}, gen {gen}")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=g,
                            device="cuda", dtype=torch.int32)
    eng.generate({"tokens": prompts}, gen=gen)
    build.reset_launches()
    tokens, stats = eng.generate({"tokens": prompts}, gen=gen)
    torch.cuda.synchronize()
    launches, variant_counts = dict(build.LAUNCHES), dict(build.VARIANTS)
    if hybrid:
        want = {**expected(n_inv, gen), **variants(n_inv, gen)}
    else:
        want = {k: 0 for k in (*launches, *variant_counts)}
    print(f"  launches in generate: "
          f"{ {k: n for k, n in launches.items() if n} }")
    for k, n in want.items():
        got = launches[k] if k in launches else variant_counts[k]
        if got != n:
            raise AssertionError(f"{name}: {k} launched {got} times, "
                                 f"expected {n}")
    _no_fallback(name, variant_counts)
    if tokens.shape != (B, gen) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"{name}: bad tokens {tokens.shape}")
    print(f"  prefill {1e3 * stats['t_prefill_s']:.2f} ms, decode_tok_s "
          f"{stats['decode_tok_s']:.1f} ({1e3 * stats['t_decode_s'] / (gen - 1):.3f}"
          f" ms a step)")
    ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                       params=eng.params, device="cuda")
    rel, cache = _teacher_forced(torch, eng, ref, prompts, tokens, P, gen,
                                 check_greedy=True)
    print(f"  teacher-forced logits vs plain path: max |d|/max|ref| "
          f"{max(rel):.3e} over {len(rel)} steps (limit {E2E_BF16_REL:g})")
    if not max(rel) <= E2E_BF16_REL:
        raise AssertionError(f"{name}: logits diverge from the plain path")
    p32 = map_tree(lambda t: t.float(), eng.params)
    blocks = (_hybrid_prefill_blocks(torch, eng, ref, prompts, p32)
              if hybrid else None)
    del ref
    breakdown = _recurrent_breakdown(torch, eng, cache, prompts,
                                     P + gen - 1)
    del cache
    recurrence = recurrence_fp32(torch, name, p32)
    del p32
    try:
        DecodeEngine(cfg, ecfg.replace(paged=True), params=eng.params,
                     device="cuda")
    except ValueError as e:
        refused = str(e)
        print(f"  paged engine: refused ({e})")
    else:
        raise AssertionError(f"{name}: the paged engine must refuse it")
    del eng
    torch.cuda.empty_cache()
    return {"arch": name, "batch": B, "prompt": P, "gen": gen,
            "n_params": n_params,
            "launches": {k: n for k, n in launches.items() if n},
            "variants": {k: n for k, n in variant_counts.items() if n},
            "logits_rel_err": rel, "prefill_blocks": blocks,
            "breakdown": breakdown, "recurrence_fp32": recurrence,
            "paged_refused": refused,
            **stats}


def serve_recurrent(torch, expected, variants):
    """Phase 6d: zamba2-1.2b and xlstm-350m, reduced fp32 configs first
    (greedy streams identical, 1e-3), then at full width and depth with
    random conditioned bf16 weights, beside the card."""
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    out = {"card": card, "reduced_fp32_max_abs": {
        n: serve_reduced_fp32(torch, n) for n in (HYBRID, XLSTM)}}
    for name in (HYBRID, XLSTM):
        out[name] = serve_recurrent_generate(torch, name, expected, variants)
    print(f"  ({card})")
    return out


# ----------------------------------------------------------------------
# phase 7: DeepSeek-V3, the moe family with MLA
# ----------------------------------------------------------------------

# DeepSeek-V3 at its published widths, cut in depth only: its 3 dense
# layers (d_ff 18,432) and 1 MoE layer (256 experts of 2,048, top-8,
# 1 shared, sigmoid scores, routed scale 2.5): 15.1 G parameters
DEEPSEEK = "deepseek-v3-671b"
DEEPSEEK_DEPTH = 4


class _Routes:
    """Records every MoE FFN call's top-k expert sets (sorted ids, one
    row a token) under the current ``tag``, to count the (token, layer)
    sets that differ between the kernel and the plain path."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.top_k_gates
        self.tag, self.log = None, {}

    def __enter__(self):
        def top_k_gates(probs, sel, cfg):
            gates, idx = self.orig(probs, sel, cfg)
            if self.tag is not None:
                self.log.setdefault(self.tag, []).append(
                    idx.sort(-1).values.reshape(-1, idx.shape[-1]))
            return gates, idx
        self.moe.top_k_gates = top_k_gates
        return self

    def __exit__(self, *exc):
        self.moe.top_k_gates = self.orig

    def take(self, tag):
        return self.log.pop(tag, [])


def _differ(a, b):
    """Rows (tokens) whose expert sets differ between two calls' logs."""
    return (a != b).any(-1)


def _hold_with_flips(what, rel, flipped):
    """Hold every (step, row) relative logits error to E2E_BF16_REL,
    except rows whose MoE group saw an expert set differ between the
    two paths, which are counted and printed with their errors.  Random
    routers put near-ties in the top-8 of 256 sigmoid scores, which the
    two paths' bf16 roundings break apart; a flip moves that token's
    output and, through the capacity drops, its group's (a prefill's
    sequence, a decode step's slots).  The one MoE layer is the last
    layer at depth 4, so a flip reaches no other row.  Returns the
    summary."""
    rel = [float(x) for x in rel]
    held = [x for x, f in zip(rel, flipped) if not f]
    flips = [x for x, f in zip(rel, flipped) if f]
    worst = max(held) if held else 0.0
    print(f"  {what}: logits vs the plain path max |d|/max|ref| "
          f"{max(rel):.3e} over {len(rel)} rows (limit {E2E_BF16_REL:g}); "
          f"{len(flips)} rows with a routing flip between the paths"
          + (f", their max {max(flips):.3e}; without them {worst:.3e}"
             if flips else ""))
    if not worst <= E2E_BF16_REL:
        raise AssertionError(f"{what}: logits diverge from the plain path "
                             "where the routing agrees")
    return {"max_rel": max(rel), "max_rel_routing_agrees": worst,
            "rows": len(rel), "flipped_rows": len(flips),
            "flipped_max_rel": max(flips) if flips else None}


def deepseek_generate(torch, eng, ref, routes, gen=32):
    """``generate`` on the kernels (launches counted: kernel 10 four
    times a decode step), then the stream teacher-forced through both
    paths with their routing compared.  Returns the summary and the
    kernel path's dense latent cache after the stream."""
    from repro_torch.kernels import build

    cfg, vocab = eng.cfg, eng.cfg.vocab
    B, P, L = eng.ecfg.batch, 128, cfg.n_layers
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, vocab, (B, P), generator=g, device="cuda",
                            dtype=torch.int32)
    eng.generate({"tokens": prompts}, gen=gen)          # warm-up
    build.reset_launches()
    tokens, stats = eng.generate({"tokens": prompts}, gen=gen)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    want = {k: 0 for k in launches}
    want.update(vwr_mla_flash_decode=L * (gen - 1), vwr_swiglu=L * gen,
                vwr_matmul=L * gen)
    swiglu = {k: n for k, n in build.VARIANTS.items()
              if k.startswith(("vwr_swiglu.", "vwr_mla_flash_decode."))}
    # the prefill's rows (B x P) and each step's (B, 4) on wgmma tiles;
    # every decode step's kernel 10 on its wgmma variant
    want_sw = {"vwr_swiglu.wgmma": L * gen, "vwr_swiglu.gemm": 0,
               "vwr_mla_flash_decode.wgmma": L * (gen - 1),
               "vwr_mla_flash_decode.fma": 0}
    print(f"  generate batch {B}, prompt {P}, gen {gen}: launches "
          f"{ {k: v for k, v in launches.items() if v} }; vwr_swiglu and "
          f"kernel 10 by variant {swiglu}")
    if launches != want or swiglu != want_sw:
        raise AssertionError(f"deepseek generate: launches {launches} "
                             f"{swiglu}, expected {want} {want_sw}")
    if tokens.shape != (B, gen) or not bool(
            ((tokens >= 0) & (tokens < vocab)).all()):
        raise AssertionError(f"deepseek: bad tokens {tokens.shape}")
    print(f"  prefill_tok_s {stats['prefill_tok_s']:.1f}  decode_tok_s "
          f"{stats['decode_tok_s']:.1f}  (t_prefill {stats['t_prefill_s']:.4f}"
          f" s, t_decode {stats['t_decode_s']:.4f} s)")

    rel, flipped, n_moe = [], [], L - cfg.moe.first_k_dense
    diff_rows = [0] * n_moe
    routes.tag = "cuda"
    lc, cc = eng.prefill({"tokens": prompts})
    routes.tag = "torch"
    lr, cr = ref.prefill({"tokens": prompts})
    for i in range(gen):
        if not bool((lc.argmax(-1).to(torch.int32) == tokens[:, i]).all()):
            raise AssertionError(f"step {i}: the kernel path is not "
                                 "deterministic (replay != generate)")
        d = [_differ(a, b) for a, b in zip(routes.take("cuda"),
                                            routes.take("torch"))]
        for j, x in enumerate(d):
            diff_rows[j] += int(x.sum())
        # a prefill groups each sequence's tokens, a decode step all B
        # rows: a flip anywhere in the group can move capacity drops
        flip = torch.stack(d).any(0).reshape(B, -1).any(-1)
        if i:
            flip[:] = flip.any()
        err = (lc - lr)[:, :vocab].abs().amax(-1)
        scale = lr[:, :vocab].abs().max()
        for b in range(B):
            rel.append((err[b] / scale).item())
            flipped.append(bool(flip[b]))
        if i + 1 < gen:
            tok = tokens[:, i]
            routes.tag = "cuda"
            lc, cc = _decode(eng, tok, P + i, cc)
            routes.tag = "torch"
            lr, cr = _decode(ref, tok, P + i, cr)
    routes.tag = None
    summary = _hold_with_flips("generate, teacher-forced", rel, flipped)
    print(f"  expert sets (token, MoE layer) differing between the paths: "
          f"{diff_rows} of {B * P + B * (gen - 1)} a layer (prefill "
          "tokens and decode rows)")
    del cr
    return {"batch": B, "prompt": P, "gen": gen, "launches": launches,
            "swiglu_variants": swiglu, "expert_sets_differ": diff_rows,
            **summary, **stats}, cc


def deepseek_kernel14(torch, cfg, cache, cur_len):
    """Kernel 14 through ``dist.decode.local_mla_decode_attend`` with
    per-sequence int8 scales over the latent cache ``generate`` left
    behind, quantized one scale a sequence (latent and rope apart),
    held to the plain dequantize-then-attend op; launches counted, every
    one on the wgmma variant."""
    from repro_torch.dist import decode as DD
    from repro_torch.kernels import build
    from repro_torch.kernels.quant import int8_scale

    g = torch.Generator(device="cuda").manual_seed(11)
    atol, rtol = TOL["float32"]
    m = cfg.mla
    scale = 1.0 / (m.nope_head_dim + m.rope_head_dim) ** 0.5
    work = []
    for grp in (cache["dense"], cache["moe"]):
        for i in range(grp["ckv"].shape[0]):
            q8, sc = [], []
            for x in (grp["ckv"][i], grp["krope"][i]):
                s = int8_scale(x.float().abs().amax(dim=(1, 2)))   # (B,)
                q8.append(torch.clamp(torch.round(x.float() / s[:, None,
                                                               None]),
                                      -127, 127).to(torch.int8))
                sc.append(s)
            B = q8[0].shape[0]
            q = (torch.randn(B, cfg.n_heads, m.kv_lora_rank, generator=g,
                             device="cuda"),
                 torch.randn(B, cfg.n_heads, m.rope_head_dim, generator=g,
                             device="cuda"))
            work.append((q, q8, sc))
    build.reset_launches()
    got = [DD.local_mla_decode_attend(*q, *q8, cur_len, scale=scale,
                                      ckv_scale=sc[0], krope_scale=sc[1],
                                      backend="cuda")
           for q, q8, sc in work]
    torch.cuda.synchronize()
    launches = build.LAUNCHES["vwr_mla_flash_decode_q8"]
    variants = {v: build.VARIANTS[f"vwr_mla_flash_decode_q8.{v}"]
                for v in ("wgmma", "fma")}
    err = 0.0
    for (q, q8, sc), x in zip(work, got):
        want = DD.local_mla_decode_attend(*q, *q8, cur_len, scale=scale,
                                          ckv_scale=sc[0],
                                          krope_scale=sc[1],
                                          backend="torch")
        d = (x - want).abs()
        err = max(err, d.max().item())
        if not bool((d <= atol + rtol * want.abs()).all()):
            raise AssertionError("kernel 14 disagrees with "
                                 "dequantize-then-attend")
    print(f"  kernel 14 over the int8 latent cache of generate ({len(work)}"
          f" layers, cur_len {cur_len}): max|err| {err:.3e} (atol {atol:g},"
          f" rtol {rtol:g}), {launches} launches {variants}")
    if launches != len(work) or variants != {"wgmma": len(work), "fma": 0}:
        raise AssertionError(f"kernel 14 launched {launches} times, by "
                             f"variant {variants}: every launch must be on "
                             "its wgmma variant")
    return {"layers": len(work), "max_abs_err": err, "launches": launches,
            "variants": variants}


def deepseek_scheduler(torch, params, cfg, kv_dtype, routes,
                       prefix_chunked=False):
    """Full-width DeepSeek-V3 through the Scheduler on the kernels, launch
    counts checked (kernel 11 or 13 four times a decode or mixed step),
    then 8 finished requests replayed teacher-forced in the 8 live slots
    through both paths.  The stream of ``serve_scheduler`` (8 slots, 128
    pages of 16, 24 requests, prompts 32-256, gen 32); with
    ``prefix_chunked`` the shared-prompt stream of
    ``serve_prefix_chunked`` with the prefix cache and chunked prefill
    (chunks of CHUNK_TOKENS) on, replayed through chunked prefills, and
    kernels 12 and 15 run on the prefix pages it left in its pools
    (``deepseek_chunk_prefix``)."""
    from repro_torch.engine import (DecodeEngine, EngineConfig,
                                    RequestStatus, Scheduler)
    from repro_torch.kernels import build

    ecfg = EngineConfig(batch=SLOTS, max_len=PROMPT[1] + GEN, paged=True,
                        page_size=PAGE, n_pages=N_PAGES, kv_dtype=kv_dtype,
                        chunk_tokens=CHUNK_TOKENS, kernel_impl="cuda")
    eng = DecodeEngine(cfg, ecfg, params=params, device="cuda")
    modes = dict(prefix_cache=prefix_chunked, chunked_prefill=prefix_chunked)
    tag = f"{kv_dtype} pools" + (", prefix cache + chunked prefill"
                                 if prefix_chunked else "")
    print(f"  Scheduler, {tag}: {SLOTS} slots, {N_PAGES} pages of {PAGE}, "
          f"{N_REQ} requests, " + (
              f"{N_SHARED} open with one {SYSTEM}-token system prompt, "
              f"chunk {CHUNK_TOKENS}, " if prefix_chunked else
              f"prompts {PROMPT[0]}-{PROMPT[1]}, ") + f"gen {GEN}")
    _drive(Scheduler(eng, **modes), _requests(cfg, 4, PROMPT, 4, seed=5))
    reqs = (_shared_requests(cfg) if prefix_chunked
            else _requests(cfg, N_REQ, PROMPT, GEN, seed=4))
    sched = Scheduler(eng, **modes)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    out = _drive(sched, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    st = sched.stats
    L = cfg.n_layers
    paged = "vwr_mla_paged_flash_decode" + ("_q8" if kv_dtype == "int8"
                                            else "")
    # a prefill pass: a whole prompt, a suffix, or a chunk
    passes = st["chunks"] if prefix_chunked else st["prefills"]
    want = {k: 0 for k in launches}
    want.update({paged: L * st["steps"],
                 "vwr_swiglu": L * (passes + st["steps"]),
                 "vwr_matmul": L * (passes + st["steps"])})
    print(f"    launches: { {k: v for k, v in launches.items() if v} }")
    if launches != want:
        raise AssertionError(f"deepseek scheduler {tag}: launches "
                             f"{launches}, expected {want}")
    # kernel 11 on bf16 pools and kernel 13 on int8 pools: every launch
    # on the wgmma variant
    mla = {k: n for k, n in build.VARIANTS.items()
           if k.startswith("vwr_mla_paged_flash_decode")}
    want_mla = {f"{k}.{v}": 0 for k in ("vwr_mla_paged_flash_decode",
                                        "vwr_mla_paged_flash_decode_q8")
                for v in ("wgmma", "fma")}
    want_mla[f"{paged}.wgmma"] = launches[paged]
    print(f"    kernels 11 / 13 by variant: {mla}")
    if mla != want_mla:
        raise AssertionError(f"deepseek scheduler {tag}: kernels 11 / 13 "
                             f"by variant {mla}, expected {want_mla}")
    swiglu = _swiglu_variants(torch, f"deepseek scheduler {tag}", L,
                              st["prefills"], st["steps"],
                              passes if prefix_chunked else None)
    bad = {rid: r.status for rid, r in out.items()
           if r.status is not RequestStatus.FINISHED or len(r) != GEN}
    if len(out) != N_REQ or bad:
        raise AssertionError(f"deepseek scheduler {tag}: unfinished {bad}")
    sched.allocator.check()
    cached = sched.prefix.cached_pages if prefix_chunked else 0
    if sched.allocator.free_pages != N_PAGES - cached:
        raise AssertionError(f"{tag}: pages left allocated after the "
                             "drain")
    if prefix_chunked and not (st["prefix_hits"] > 0 and st["chunks"] > 0):
        raise AssertionError(f"{tag}: no prefix hit or no chunk")
    n_tok = sum(len(r) for r in out.values())
    lat, itl = sched.latency_percentiles(), sched.itl_percentiles()
    keys = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
            "prefix_evictions", "shared_pages", "cow_forks", "mixed_steps",
            "chunks", "chunked_tokens")
    summary = {
        "kv_dtype": kv_dtype, "prefix_chunked": prefix_chunked,
        "steps": st["steps"], "prefills": st["prefills"],
        "preempted": st["preempted"], "peak_pages": st["peak_pages"],
        **({k: st[k] for k in keys} if prefix_chunked else {}),
        "table_widths": {str(k): v for k, v in
                         sorted(st["table_widths"].items())},
        "generated_tokens": n_tok, "wall_s": wall,
        "gen_tok_s": n_tok / wall, "latency_p50_s": lat["p50"],
        "latency_p99_s": lat["p99"], "itl_p50_s": itl["p50"],
        "itl_p99_s": itl["p99"], "launches": launches,
        "swiglu_variants": swiglu, "mla_variants": mla}
    print(f"    steps {st['steps']}, prefills {st['prefills']}, preempted "
          f"{st['preempted']}, peak pages {st['peak_pages']}/{N_PAGES}, "
          f"table widths {summary['table_widths']}")
    if prefix_chunked:
        print("    " + ", ".join(f"{k} {st[k]}" for k in keys))
    print(f"    {n_tok} tokens in {wall:.4f} s: {summary['gen_tok_s']:.1f} "
          f"generated tok/s; request latency p50 {lat['p50']:.4f} s p99 "
          f"{lat['p99']:.4f} s; ITL p50 {itl['p50'] * 1e3:.3f} ms p99 "
          f"{itl['p99'] * 1e3:.3f} ms")
    if prefix_chunked:
        summary["chunk_prefix"] = deepseek_chunk_prefix(
            torch, eng.params, cfg, sched, reqs)
        sched.prefix.clear()
        sched.allocator.check()
        if sched.allocator.free_pages != N_PAGES:
            raise AssertionError(f"{tag}: pages left allocated after the "
                                 "trie was cleared")
        print(f"    all {N_PAGES} pages free once the trie's "
              f"{cached} are released")
    ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                       params=params, device="cuda")
    summary["replay"] = _replay_both(
        torch, eng, ref, sched.cache, reqs, out, routes,
        chunk=CHUNK_TOKENS if prefix_chunked else None)
    del eng, ref, sched
    torch.cuda.empty_cache()
    return summary


def deepseek_chunk_prefix(torch, params, cfg, sched, reqs):
    """Kernels 12 and 15 on the stream's own data: the shared system
    prompt's pages, found in the drained Scheduler's prefix trie, and the
    absorbed queries of the next CHUNK_TOKENS tokens of a request that
    opens with it, each layer's from its true input (the suffix prefill
    of those tokens over those pages, on the plain path, run layer by
    layer).  ``chunk_prefix_mla_paged`` (bf16 pools) or its q8 op (int8,
    with the pools' page scales) on the 'cuda' backend against the
    'torch' op; launches counted, one a layer."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.kernels import dispatch as D
    from repro_torch.models import layers as LY
    from repro_torch.models import lm
    from repro_torch.models import mla as MLA

    req = next(r for r in reqs if len(r.tokens) >= SYSTEM + CHUNK_TOKENS
               and len(sched.prefix.match(r.tokens)) * PAGE >= SYSTEM)
    pages = np.asarray(sched.prefix.match(req.tokens)[:SYSTEM // PAGE],
                       np.int32)
    M, C = len(pages) * PAGE, CHUNK_TOKENS
    plain = cfg.replace(kernel_impl="torch")
    cache = sched.cache
    toks = torch.from_numpy(req.tokens[M:M + C]).cuda()[None]
    q_pos = torch.arange(C, device="cuda") + M
    kv_pos = torch.arange(M + C, device="cuda")
    pages_d = torch.from_numpy(pages).cuda()
    x = LY.embed(params["embed"], toks).to(torch.bfloat16)
    table = pages_d.to(torch.int32)
    counts = torch.full((len(pages),), PAGE, dtype=torch.int32,
                        device="cuda")
    work = []
    for stacked, key, moe in lm._groups(cfg, params):
        group = lm._cache_group(cache, key)
        prefix = lm._gather_prefix_kv(group, ("ckv", "krope"),
                                      pages_d.long())
        for i in range(lm._depth(stacked)):
            lp = lm._layer(stacked, i)
            h = lm._norm(cfg, lp["attn_norm"], x)
            q_nope, q_rope = MLA.mla_queries(lp["attn"], h, q_pos, cfg)
            q_abs, q_rope, scale = MLA.mla_absorbed_queries(
                lp["attn"], q_nope[0], q_rope[0], cfg)
            pools = [group[n][i] for n in ("ckv", "krope")]
            scales = [group[n][i] for n in ("ckv_scale", "krope_scale")
                      if n in group]
            work.append((q_abs, q_rope, pools, scales, scale))
            body = lm._moe_suffix_body if moe else lm._dense_suffix_body
            x, _ = body(plain, q_pos, kv_pos, x, lp,
                        tuple(t[i] for t in prefix))
    op = "chunk_prefix_mla_paged" + ("_q8" if work[0][3] else "")
    torch.cuda.synchronize()
    build.reset_launches()
    got = [D.dispatch(op, "cuda", qa, qr, *pools, *scales, table, counts,
                      scale=scale)
           for qa, qr, pools, scales, scale in work]
    torch.cuda.synchronize()
    kernel = "vwr_mla_chunk_prefix_attend" + ("_q8" if work[0][3] else "")
    launches = build.LAUNCHES[kernel]
    variants = {k: n for k, n in build.VARIANTS.items()
                if k.startswith(kernel + ".")}
    atol, rtol = TOL["float32"]
    err = 0.0
    for (qa, qr, pools, scales, scale), part in zip(work, got):
        want = D.dispatch(op, "torch", qa, qr, *pools, *scales, table,
                          counts, scale=scale)
        for a, b in zip(part, want):
            d = (a - b).abs()
            err = max(err, d.max().item())
            if not bool((d <= atol + rtol * b.abs()).all()):
                raise AssertionError(f"{kernel} disagrees with its plain "
                                     "op on the stream's prefix pages")
    print(f"    {kernel} on the stream's {len(pages)} system-prompt pages, "
          f"a {C}-token chunk at position {M}, {len(work)} layers: "
          f"max|err| {err:.3e} (atol {atol:g}, rtol {rtol:g}), "
          f"{launches} launches" + (f", by variant {variants}" if variants
                                    else ""))
    if launches != len(work):
        raise AssertionError(f"{kernel} launched {launches} times")
    if variants and variants != {f"{kernel}.wgmma": len(work),
                                 f"{kernel}.fma": 0}:
        raise AssertionError(f"{kernel}: the bf16 prefix pages take the "
                             f"wgmma variant, launched {variants}")
    return {"kernel": kernel, "pages": len(pages), "chunk": C,
            "layers": len(work), "max_abs_err": err, "launches": launches,
            "variants": variants}


def _replay_both(torch, eng, ref, cache, reqs, out, routes, chunk=None):
    """Replay the first 8 finished requests that fit the pool together,
    one a slot, teacher-forced with their served tokens, through the
    kernel engine on the drained stream's pools (stale pages and scales
    included) and through the plain engine on a copy of them, in the
    same slot layout: the MoE FFN's decode group (and so its capacity
    drops) is then the same on both paths, which a batch-1 reference
    would not share.  Each prompt goes in whole, or with ``chunk`` in
    chunks of that many tokens through ``lm.prefill_chunk`` (each chunk
    its own MoE group, as in the stream).  Logits are held where the
    routing agrees; the served token's agreement is counted for both
    paths (the served stream had other slot mates, so other capacity
    drops)."""
    import numpy as np

    from repro_torch.engine.paged_cache import write_prefill
    from repro_torch.models import lm

    cfg, vocab = eng.cfg, eng.cfg.vocab
    picked, need = [], 0
    for r in reqs:
        n = -(-(len(r.tokens) + GEN - 1) // PAGE)
        if len(picked) < SLOTS and need + n <= N_PAGES:
            picked.append((r, n))
            need += n
    if len(picked) < SLOTS:
        raise AssertionError(f"only {len(picked)} requests fit the pool")
    perm = np.random.default_rng(7).permutation(N_PAGES).astype(np.int32)
    table = np.zeros((SLOTS, eng.max_pages), np.int32)
    lens = np.zeros((SLOTS,), np.int32)
    served = np.zeros((SLOTS, GEN), np.int32)
    at = 0
    for b, (r, n) in enumerate(picked):
        table[b, :n] = perm[at:at + n]
        at += n
        lens[b] = len(r.tokens)
        served[b] = out[r.rid].tokens
    logits = {}
    pools = {"cuda": cache, "torch": lm.map_groups(lambda t: t.clone(),
                                                   cache)}
    for path, e in (("cuda", eng), ("torch", ref)):
        c = pools[path]
        got = [[] for _ in picked]
        for b, (r, _) in enumerate(picked):
            routes.tag = (path, "prefill", b)
            toks = torch.from_numpy(r.tokens)[None].cuda()
            if chunk is None:
                lg, caches = e.prefill_fn(e.params, {"tokens": toks})
                write_prefill(cfg, c, caches, table[b][None])
            for p0 in range(0, len(r.tokens) if chunk else 0, chunk or 1):
                end = min(p0 + chunk, len(r.tokens))
                lg, c = lm.prefill_chunk(e.params, {
                    "tokens": toks[:, p0:end],
                    "pages": table[b, :p0 // PAGE],
                    "write_pages": table[b, p0 // PAGE:-(-end // PAGE)],
                    "cache": c}, e.cfg)
            got[b].append(lg[0, :vocab].float())
        for i in range(GEN - 1):
            routes.tag = (path, "step", i)
            lg, c = e.decode_step(served[:, i], lens + i, c,
                                  block_table=table)
            for b in range(SLOTS):
                got[b].append(lg[b, :vocab].float())
        logits[path] = got
    routes.tag = None
    n_moe = cfg.n_layers - cfg.moe.first_k_dense

    def differ(tag):
        """Per call under ``tag`` (a prefill pass a MoE layer, in order),
        the rows whose expert sets differ between the paths."""
        return [_differ(a, c) for a, c in
                zip(routes.take(("cuda", *tag)), routes.take(("torch",
                                                              *tag)))]

    diff_rows = [0] * n_moe
    rel, flipped, agree = [], [], {"cuda": 0, "torch": 0}
    first_flip, step_flip = [], []
    for b in range(SLOTS):
        d = differ(("prefill", b))
        for k, x in enumerate(d):
            diff_rows[k % n_moe] += int(x.sum())
        # the first logits row comes out of the last pass (the prompt,
        # or its final chunk), which is its own MoE group
        first_flip.append(any(bool(x.any()) for x in d[-n_moe:]))
    for i in range(GEN - 1):
        d = differ(("step", i))
        for j, x in enumerate(d):
            diff_rows[j] += int(x.sum())
        step_flip.append(any(bool(x.any()) for x in d))
    for i in range(GEN):
        for b in range(SLOTS):
            x, want = logits["cuda"][b][i], logits["torch"][b][i]
            rel.append(((x - want).abs().max() / want.abs().max()).item())
            flipped.append(first_flip[b] if i == 0 else step_flip[i - 1])
            for path in agree:
                agree[path] += int(logits[path][b][i].argmax()) == int(
                    served[b, i])
    what = (f"{SLOTS} requests replayed in the live slots" + (
        f" (prompts in chunks of {chunk})" if chunk else "")
        + ", kernel vs plain")
    summary = _hold_with_flips(what, rel, flipped)
    print(f"    served token picked by the replay at {agree['cuda']}/"
          f"{len(rel)} steps (plain replay: {agree['torch']}/{len(rel)}); "
          f"expert sets differing between the paths per MoE layer "
          f"{diff_rows}")
    return {**summary, "agree_served": agree, "expert_sets_differ":
            diff_rows}


def serve_deepseek(torch):
    """Phases 7-8 at full width: DeepSeek-V3 cut to 4 layers, bf16, random
    weights from a seed (conditioned), through ``generate`` (kernel 10),
    kernel 14 over generate's latent cache, the Scheduler with bf16
    (kernel 11) and int8 (kernel 13) latent pools, and the shared-prompt
    stream with the prefix cache and chunked prefill on both pools
    (kernels 12 and 15 on its prefix pages)."""
    from repro_torch.common.module import leaves
    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, EngineConfig

    cfg = get_config(DEEPSEEK)
    print(f"{DEEPSEEK}: full width (d {cfg.d_model}, {cfg.n_heads} heads, "
          f"MLA r {cfg.mla.kv_lora_rank} rope {cfg.mla.rope_head_dim}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, vocab "
          f"{cfg.vocab}, {cfg.dtype})")
    print(f"reduced: n_layers {cfg.n_layers} -> {DEEPSEEK_DEPTH}")
    cfg = cfg.replace(n_layers=DEEPSEEK_DEPTH)
    gen = 32
    ecfg = EngineConfig(batch=4, max_len=128 + gen, kernel_impl="cuda")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
    _condition(torch, eng.params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in leaves(eng.params))
    n_bytes = sum(t.numel() * t.element_size() for _, t in
                  leaves(eng.params))
    print(f"  {cfg.moe.first_k_dense} dense + "
          f"{cfg.n_layers - cfg.moe.first_k_dense} MoE layers, "
          f"{n_params / 1e9:.3f} B params, {n_bytes / 1e9:.1f} GB "
          f"({time.perf_counter() - t0:.1f} s to init, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB)")
    ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                       params=eng.params, device="cuda")
    with _Routes() as routes:
        gen_summary, cache = deepseek_generate(torch, eng, ref, routes,
                                               gen=gen)
        k14 = deepseek_kernel14(torch, cfg, cache, 128 + gen - 1)
        del cache, ref
        params = eng.params
        del eng
        torch.cuda.empty_cache()
        streams = [deepseek_scheduler(torch, params, cfg, kv, routes)
                   for kv in ("bf16", "int8")]
        pc_streams = [deepseek_scheduler(torch, params, cfg, kv, routes,
                                         prefix_chunked=True)
                      for kv in ("bf16", "int8")]
        recovery = deepseek_recovery(torch, params, cfg, routes)
    del params
    torch.cuda.empty_cache()
    return {"arch": DEEPSEEK, "n_layers": DEEPSEEK_DEPTH,
            "n_params": n_params, "generate": gen_summary,
            "kernel14": k14, "scheduler": streams,
            "prefix_chunked": pc_streams, "recovery": recovery}


# ----------------------------------------------------------------------
# phase 9: the paper's CNN path
# ----------------------------------------------------------------------

def serve_cnn(torch):
    """The CNN path at full width, through its user entry points: every
    stride-1 layer of the provet_cnn suite at its published shape, N 1
    and 32, bf16 and fp32, through ``ops.vwr_conv2d`` (bias + relu) and
    ``ops.vwr_depthwise``, and the section 6.1 demo on the card, with
    every launch counter set to 0 just before and read just after; then
    each output held against its plain version (shape, finite, TOL), and
    the fused bias + relu conv timed against the conv followed by the
    bias and the relu as separate passes."""
    from repro_torch.examples import provet_conv_demo
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.vwr_conv2d import vwr_conv2d_ref
    from repro_torch.kernels.vwr_depthwise import vwr_depthwise_ref

    covered, skipped = _cnn_layers()
    for layer in skipped:
        print(f"  {layer.name}: stride {layer.stride}, outside both "
              "kernels' stride-1 contract (as in JAX): not covered")
    gen = torch.Generator(device="cuda").manual_seed(16)
    cases = [(layer, n, dt, _conv_operands(
        torch, gen, n, layer.H_in, layer.W_in, layer.C_in, layer.C_out,
        layer.K, layer.K, dt, depthwise=layer.depthwise))
        for layer in covered for n in CNN_BATCHES
        for dt in (torch.bfloat16, torch.float32)]
    torch.cuda.synchronize()
    build.reset_launches()
    outs = [ops.vwr_depthwise(x, w) if layer.depthwise
            else ops.vwr_conv2d(x, w, b, activation="relu")
            for layer, _, _, (x, w, b) in cases]
    demo = provet_conv_demo.main("cuda")
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in ("vwr_conv2d",
                                               "vwr_depthwise")}
    variants = {k: n for k, n in build.VARIANTS.items()
                if k.startswith(("vwr_conv2d.", "vwr_depthwise."))}
    n_dw = sum(layer.depthwise for layer, *_ in cases)
    n_bf16 = sum(not layer.depthwise and dt == torch.bfloat16
                 for layer, _, dt, _ in cases)
    # the demo's last section launches the conv kernel twice, in fp32
    want = {"vwr_conv2d": len(cases) - n_dw + 2, "vwr_depthwise": n_dw}
    # every depthwise layer of the suite (3 x 3, C % 8 == 0) streams
    want_variants = {"vwr_conv2d.wgmma": n_bf16,
                     "vwr_conv2d.tile": len(cases) - n_dw - n_bf16 + 2,
                     "vwr_depthwise.stream": n_dw, "vwr_depthwise.tile": 0}
    print(f"  launches over the suite and the demo: {launches}; "
          f"by variant: {variants}")
    if launches != want or variants != want_variants:
        raise AssertionError(f"CNN path launches {launches} {variants}, "
                             f"expected {want} {want_variants}")
    if max(demo["6.1_err"], demo["6.2.1_err"], demo["6.2.2_err"],
           demo["fused_err"]) > 1e-4:
        raise AssertionError(f"provet_conv_demo errors {demo}")
    rows = []
    for (layer, n, dt, (x, w, b)), out in zip(cases, outs):
        want_out = (vwr_depthwise_ref(x, w) if layer.depthwise
                    else vwr_conv2d_ref(x, w, b, activation="relu"))
        atol, rtol = TOL[str(dt)[6:]]
        d = (out.float() - want_out.float()).abs()
        ok = (out.shape == want_out.shape and bool(out.isfinite().all())
              and bool((d <= atol + rtol * want_out.float().abs()).all()))
        rows.append({"layer": layer.name, "N": n, "dtype": str(dt)[6:],
                     "shape": list(out.shape),
                     "max_abs_err": d.max().item()})
        print(f"  {layer.name:11s} N{n:<3d} {str(dt)[6:]:9s} out "
              f"{tuple(out.shape)} max|err| {d.max().item():.3e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{layer.name} N{n} {dt}: the CNN path's "
                                 "output is off its plain version")
    layer, n, dt, (x, w, b) = next(
        c for c in cases if (c[0].name, c[1], str(c[2])[6:])
        == CNN_HEADLINE["vwr_conv2d"])
    fused = time_ms(torch, lambda: ops.vwr_conv2d(x, w, b,
                                                  activation="relu"))
    unfused = time_ms(torch, lambda: torch.relu(ops.vwr_conv2d(x, w) + b))
    print(f"  {layer.name} N{n} bf16 conv + bias + relu: fused "
          f"{fused:.4f} ms, conv then bias and relu passes {unfused:.4f} ms")
    return {"launches": launches, "variants": variants, "outputs": rows,
            "not_covered": [l.name for l in skipped],
            "fused_ms": fused, "unfused_ms": unfused,
            "demo_errors": {k: v for k, v in demo.items()
                            if k.endswith("_err")}}


# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# phase 10: training (the 'torch' backend; the kernels are forward-only)
# ----------------------------------------------------------------------

TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_BATCH, TRAIN_SEQ = 4, 1024          # (a): 4096 tokens a step
TRAIN_TIMED = 5
# (b): the bf16 step's loss and grads against the same step in fp32
# (TF32 off): the port's full-width bf16 bounds (E2E_BF16_REL for grads)
TRAIN_LOSS_REL = 1e-2
# (d): a reduced fp32 step on the card against the same step on the CPU
TRAIN_FP32_TOL = 1e-3
# the moe family at capacity factor 4 (no drops), as the CPU tests run it
TRAIN_FAMILIES = ("tinyllama-1.1b", "qwen1.5-0.5b", VLM, AUDIO,
                  "zamba2-1.2b", "xlstm-350m", "olmoe-1b-7b", DEEPSEEK)


def _leaf_gap(got, want):
    """{path: ||got - want|| / ||want||} over two parameter trees (fp32)."""
    from repro_torch.common.module import leaves

    want = dict(leaves(want))
    return {"/".join(k): float((g.float() - want[k].float()).norm()
                               / want[k].float().norm().clamp_min(1e-30))
            for k, g in leaves(got)}


def _hold_adam(got, want, lr, tol, what):
    """Parameters after Adam steps of total learning rate ``lr``: every
    element within ``tol`` of its leaf's max |x|, but for at most 1e-3
    of them, and none farther than 2.5 lr.  A near-zero gradient element
    whose fp32 noise flips its sign moves by up to 2 lr in Adam's early
    steps (the CPU tests saw <= 5.4e-4 of the elements, 1.97 lr)."""
    from repro_torch.common.module import leaves

    want = dict(leaves(want))
    off = total = 0
    worst = 0.0
    for k, g in leaves(got):
        r = want[k].to(g.device).float()
        d = (g.float() - r).abs()
        off += int((d > tol * r.abs().max()).sum())
        total += d.numel()
        worst = max(worst, float(d.max()) / lr)
    if off > 1e-3 * total or worst > 2.5:
        raise AssertionError(f"{what}: {off} of {total} elements off "
                             f"{tol} of scale, worst {worst:.3f} lr")
    return {"off": off, "elements": total, "worst_over_lr": worst}


def _deterministic(torch, on):
    """``torch.use_deterministic_algorithms`` on / off; cuBLAS needs its
    workspace config named (one stream: its results repeat anyway)."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(on)


def train_full_width(torch):
    """(a) tinyllama-1.1b at full width and depth (22 layers, d 2048,
    vocab 32000), bf16 parameters from a seed (``_condition``ed: the
    fan-in init's near-argmax attention turns bf16 rounding into O(1)
    gradient gaps, 1.5x the fp32 gradient on the CPU at reduced width),
    fp32 master copies and moments, remat "full", kernel_impl "torch":
    one warm-up step through
    ``build_train_step``, then 5 timed steps as the train step runs them
    (``value_and_grad``, then ``adamw.update``), CUDA events between;
    (b) the first step's loss and grads again in fp32, after freeing
    (a)'s optimizer state, held to the bf16 ones."""
    from repro_torch.common.module import leaves, map_tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = get_config(TRAIN_ARCH).replace(kernel_impl="torch", remat="full")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=29))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(cfg, seed=29, device="cuda")
    _condition(torch, params)
    opt_cfg = adamw.OptConfig()     # lr 3e-4, 100 warmup steps
    opt = adamw.init(opt_cfg, params)
    state_bytes = sum(t.numel() * t.element_size() for tree in
                      (params, opt.m, opt.v, opt.master)
                      for _, t in leaves(tree))
    n_params = sum(t.numel() for _, t in leaves(params))
    # the first step's loss and grads, kept for (b)
    (loss0, _), g0 = steps.value_and_grad(params, data.batch(0), cfg)
    train_step = steps.build_train_step(cfg, opt_cfg)
    params, opt, m = train_step(params, opt, data.batch(0))
    torch.cuda.synchronize()
    losses, norms = [float(m["loss"])], [float(m["grad_norm"])]
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
          for _ in range(TRAIN_TIMED)]
    t0 = time.perf_counter()
    for i in range(TRAIN_TIMED):
        batch = steps.to_device(data.batch(1 + i), "cuda")
        ev[i][0].record()
        (loss, met), grads = steps.value_and_grad(params, batch, cfg)
        ev[i][1].record()
        params, opt, om = adamw.update(opt_cfg, grads, opt, params)
        ev[i][2].record()
        losses.append(loss)
        norms.append(om["grad_norm"])
        del grads
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    peak = torch.cuda.max_memory_allocated() - base
    fb = [e[0].elapsed_time(e[1]) for e in ev]
    up = [e[1].elapsed_time(e[2]) for e in ev]
    tok_s = TRAIN_TIMED * TRAIN_BATCH * TRAIN_SEQ / wall
    print(f"  (a) {TRAIN_ARCH} bf16, {n_params / 1e9:.3f} B params, "
          f"B{TRAIN_BATCH} S{TRAIN_SEQ}, remat full: {tok_s:.1f} tok/s, "
          f"{1e3 * wall / TRAIN_TIMED:.1f} ms a step (forward + backward "
          f"{statistics.mean(fb):.1f} ms, optimizer "
          f"{statistics.mean(up):.1f} ms); params + grads + optimizer "
          f"state {(state_bytes + n_params * 2) / 1e9:.2f} GB, peak "
          f"{peak / 1e9:.2f} GB over {base / 1e9:.2f} GB held before")
    print(f"      losses {['%.4f' % x for x in losses]}, grad norms "
          f"{['%.3f' % x for x in norms]}")
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"training: a loss or grad norm is not "
                             f"finite: {losses} {norms}")
    del opt, params
    torch.cuda.empty_cache()

    # (b) the fp32 referee of the first step
    p32 = lm.init(cfg, seed=29, device="cuda")
    _condition(torch, p32)
    p32 = map_tree(lambda t: t.float(), p32)
    (loss32, _), g32 = steps.value_and_grad(p32, data.batch(0),
                                            cfg.replace(dtype="float32"))
    del p32
    rel = abs(float(loss0) - float(loss32)) / abs(float(loss32))
    gaps = _leaf_gap(g0, g32)
    worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    print(f"  (b) first step bf16 vs fp32: loss {float(loss0):.5f} / "
          f"{float(loss32):.5f} ({rel:.2e} relative); worst grad leaves "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst))
    if rel > TRAIN_LOSS_REL or worst[0][1] > E2E_BF16_REL:
        raise AssertionError(f"training: the bf16 step is off its fp32 "
                             f"referee: loss {rel:.3e}, grads {worst}")
    del g0, g32
    torch.cuda.empty_cache()
    return {"params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "tok_s": tok_s, "step_ms": 1e3 * wall / TRAIN_TIMED,
            "fwd_bwd_ms": fb, "optimizer_ms": up, "losses": losses,
            "grad_norms": norms, "state_gb": (state_bytes + 2 * n_params)
            / 1e9, "peak_gb": peak / 1e9, "held_before_gb": base / 1e9,
            "fp32_loss_rel": rel, "fp32_worst_leaves": worst}


def train_remat(torch):
    """(c) remat "none", "full" and "dots" at full width and depth 2
    (bf16, deterministic algorithms): the same grads within 1e-6 of each
    leaf's max |g|."""
    from repro_torch.common.module import leaves
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = get_config(TRAIN_ARCH).replace(kernel_impl="torch", n_layers=2)
    params = lm.init(cfg, seed=29, device="cuda")
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH, seed=29)
                        ).batch(0)
    _deterministic(torch, True)
    try:
        grads = {mode: dict(leaves(steps.value_and_grad(
            params, batch, cfg.replace(remat=mode))[1]))
            for mode in ("none", "full", "dots")}
    finally:
        _deterministic(torch, False)
    out = {}
    for mode in ("full", "dots"):
        out[mode] = max(float((grads[mode][k] - g).abs().max()
                              / g.abs().max().clamp_min(1e-30))
                        for k, g in grads["none"].items())
        print(f"  (c) remat {mode} vs none, depth 2: max |d| "
              f"{out[mode]:.3e} of scale")
        if out[mode] > 1e-6:
            raise AssertionError(f"training: remat {mode!r} grads differ "
                                 f"from 'none' by {out[mode]:.3e}")
    return out


def train_families(torch):
    """(d) every family the port serves, reduced fp32 (the moe family at
    capacity factor 4; weights ``_condition``ed): 3 train steps on the
    card, each from the CPU run's state before it, held against the
    CPU's step (``_hold_adam`` at 1e-3 of scale; losses 1e-4
    relative)."""
    import dataclasses

    from repro_torch.common.module import map_tree
    from repro_torch.launch import steps, train
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    def to(tree, dev):
        return (None if tree is None else
                map_tree(lambda t: t.to(dev, copy=True), tree))

    def state_to(st, dev):
        return adamw.OptState(st.step.to(dev, copy=True), to(st.m, dev),
                              to(st.v, dev), to(st.master, dev))

    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=5, total_steps=30)
    out = {}
    for name in TRAIN_FAMILIES:
        cfg = _reduced(name).replace(kernel_impl="torch")
        if cfg.moe is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      capacity_factor=4.0))
        step = steps.build_train_step(cfg, opt_cfg)
        get = train.make_batch_fn(cfg, 2, 32)
        p = lm.init(cfg, seed=29, device="cuda")
        _condition(torch, p)
        p = to(p, "cpu")
        o = adamw.init(opt_cfg, p)
        rows = []
        for s in range(3):
            pc, oc = to(p, "cuda"), state_to(o, "cuda")
            p, o, m = step(p, o, get(s))
            pc, oc, mc = step(pc, oc, get(s))
            rel = abs(float(mc["loss"]) - float(m["loss"])) / float(m["loss"])
            held = _hold_adam(pc, p, float(m["lr"]), TRAIN_FP32_TOL,
                              f"{name} step {s}")
            if rel > 1e-4:
                raise AssertionError(f"{name} step {s}: loss {rel:.3e} "
                                     "off the CPU's")
            rows.append({"loss_rel": rel, **held})
        out[name] = rows
        print(f"  (d) {name} reduced fp32, 3 steps card vs CPU: loss "
              f"{max(r['loss_rel'] for r in rows):.2e}, elements off "
              f"{[r['off'] for r in rows]}, worst "
              f"{max(r['worst_over_lr'] for r in rows):.3f} lr")
    return out


def train_width(torch):
    """(e) width_reduce(tinyllama) fp32 on the card under deterministic
    algorithms: 50 steps, batch 8, seq 256, lr 1e-3, the mean of the last
    5 losses below the first 5's by 0.3 (JAX's test_loss_decreases);
    n_microbatches 4 vs 1 on one
    batch (weights ``_condition``ed) within 5e-5 but for the elements
    ``_hold_adam`` allows; (f) 6 straight steps against 3,
    a CheckpointStore save, a restore into fresh tensors and 3 more,
    under deterministic algorithms: losses and parameters equal; (g)
    ``lm.train_loss`` with kernel_impl "cuda" raises the forward-only
    ValueError."""
    import shutil

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.common.module import leaves, map_tree
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = train.width_reduce(get_config(TRAIN_ARCH)).replace(
        kernel_impl="torch", remat="none")
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=5, total_steps=50)
    get = train.make_batch_fn(cfg, 8, 256)
    step = steps.build_train_step(cfg, opt_cfg)
    p = lm.init(cfg, seed=29, device="cuda")
    o = adamw.init(opt_cfg, p)
    losses = []
    # deterministic algorithms: from this init the summation order alone
    # moves the fall over 50 steps between 0.29 and 0.53 run to run
    # (scripts/train_loss_spread.py), so the hold is made on one
    # reproducible trajectory
    _deterministic(torch, True)
    try:
        for s in range(50):
            p, o, m = step(p, o, get(s))
            losses.append(m["loss"])
        losses = [float(x) for x in losses]
    finally:
        _deterministic(torch, False)
    head, tail = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    print(f"  (e) {cfg.name} fp32, 50 steps B8 S256, deterministic "
          f"algorithms: first 5 {head:.4f}, last 5 {tail:.4f}")
    if not (tail < head - 0.3 and all(map(math.isfinite, losses))):
        raise AssertionError(f"training: the loss did not fall: {losses}")

    mb_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    p0 = lm.init(cfg, seed=30, device="cuda")
    _condition(torch, p0)
    runs = {}
    for nm in (1, 4):
        pp = map_tree(lambda t: t.clone(), p0)
        runs[nm] = steps.build_train_step(cfg.replace(n_microbatches=nm),
                                          mb_cfg)(
            pp, adamw.init(mb_cfg, pp), get(0))
    # within 5e-5 (JAX's test), but for the elements an fp32 sign flip
    # of a near-zero gradient moves by an Adam step (_hold_adam's rule)
    pairs = [(a, b) for (_, a), (_, b) in zip(leaves(runs[4][0]),
                                              leaves(runs[1][0]))]
    lr = float(runs[1][2]["lr"])
    d = max(float((a - b).abs().max()) for a, b in pairs)
    off = sum(int(((a - b).abs() > 5e-5).sum()) for a, b in pairs)
    total = sum(a.numel() for a, _ in pairs)
    mb = {"max_abs": d, "off_5e-5": off, "elements": total, "lr": lr,
          "loss": [float(runs[nm][2]["loss"]) for nm in (4, 1)]}
    print(f"  (e) n_microbatches 4 vs 1: max |d| {d:.3e} ({d / lr:.3f} lr), "
          f"{off} of {total} elements past 5e-5; loss {mb['loss']}")
    if off > 1e-3 * total or d > 2.5 * lr:
        raise AssertionError(f"training: microbatches part: {mb}")

    ck = ROOT / "build" / "train_smoke_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    get4 = train.make_batch_fn(cfg, 4, 256)
    _deterministic(torch, True)
    try:
        p = lm.init(cfg, seed=31, device="cuda")
        o = adamw.init(opt_cfg, p)
        straight = []
        for s in range(6):
            p, o, m = step(p, o, get4(s))
            straight.append(float(m["loss"]))
        q = lm.init(cfg, seed=31, device="cuda")
        r = adamw.init(opt_cfg, q)
        resumed = []
        for s in range(3):
            q, r, m = step(q, r, get4(s))
            resumed.append(float(m["loss"]))
        store = CheckpointStore(str(ck))
        store.save(3, {"params": q, "opt": r})
        q = lm.init(cfg, seed=32, device="cuda")
        r = adamw.init(opt_cfg, q)
        store.restore(3, {"params": q, "opt": r})
        for s in range(3, 6):
            q, r, m = step(q, r, get4(s))
            resumed.append(float(m["loss"]))
    finally:
        _deterministic(torch, False)
        shutil.rmtree(ck, ignore_errors=True)
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(leaves(p), leaves(q)))
    print(f"  (f) 6 straight steps vs 3 + save + restore + 3: losses "
          f"{'equal' if straight == resumed else 'DIFFER'}, parameters "
          f"{'equal' if same else 'DIFFER'}")
    if straight != resumed or not same:
        raise AssertionError(f"training: resume is not exact: {straight} "
                             f"{resumed}")

    try:
        lm.train_loss(p, get(0), cfg.replace(kernel_impl="cuda"))
    except ValueError as e:
        if "forward-only" not in str(e):
            raise
        print(f"  (g) kernel_impl='cuda' refused: {str(e)[:60]}...")
    else:
        raise AssertionError("training on kernel_impl='cuda' was not "
                             "refused")
    return {"losses": losses, "microbatches": mb,
            "resume_losses": straight}


def train_launcher(torch):
    """(h) ``launch.train.main`` on the card: --reduce width, 20 steps,
    a checkpoint every 10; run again to 30 it resumes from step 20."""
    import shutil

    from repro_torch.launch import train

    ck = ROOT / "build" / "train_smoke_launcher"
    shutil.rmtree(ck, ignore_errors=True)
    args = ["--arch", TRAIN_ARCH, "--reduce", "width", "--batch", "8",
            "--seq", "256", "--ckpt", str(ck), "--ckpt-every", "10",
            "--log-every", "5"]
    try:
        first = train.main(args + ["--steps", "20"])
        second = train.main(args + ["--steps", "30"])
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    if [s for s, _ in first] != [0, 5, 10, 15, 19] or \
            [s for s, _ in second] != [20, 25, 29]:
        raise AssertionError(f"launcher steps {first} {second}")
    return {"first": first, "resumed": second}


def serve_training(torch):
    """Phase 10: (a)-(h)."""
    t0 = time.perf_counter()
    out = {"full_width": train_full_width(torch),
           "remat": train_remat(torch),
           "families": train_families(torch),
           "width": train_width(torch),
           "launcher": train_launcher(torch)}
    out["wall_s"] = time.perf_counter() - t0
    print(f"  training phase {out['wall_s']:.1f} s")
    return out


# ----------------------------------------------------------------------
# phase 11: the serving surfaces (launch/serve.py, 'auto', the tuner)
# ----------------------------------------------------------------------

# full-width tinyllama-1.1b at phase 3's generate shapes, through the CLI
AUTO_ARGS = ["--arch", "tinyllama-1.1b", "--batch", "4", "--prompt-len",
             "128", "--gen", "32", "--kernel-impl", "auto"]
# phase 5's stream shape in the CLI's stream mode: 8 slots, 128 pages of
# 16, 24 requests (prompts of 128-256 tokens, gens of 16-32)
AUTO_STREAM = ["--stream", str(N_REQ), "--batch", str(SLOTS),
               "--prompt-len", str(PROMPT[1]), "--gen", str(GEN),
               "--page-size", str(PAGE), "--n-pages", str(N_PAGES)]
# the CLI's own --reduce width (~100M-class, fp32) for its modes
CLI_ARGS = ["--arch", "tinyllama-1.1b", "--reduce", "width", "--batch",
            "4", "--prompt-len", "64", "--gen", "32"]


def _dispatch_winners():
    """The 'auto' choices measured since the tuner's last reset:
    {"dispatch:<op>|shape|dtype|tag": {backend: us, "winner": name}}."""
    from repro_torch.kernels import autotune

    table = autotune._load(autotune.cache_path())
    rows = {}
    for m in autotune.measurements:
        if m["key"].startswith("dispatch:"):
            rows.setdefault(m["key"], {})[m["cand"][0]] = m["us"]
    for key, row in rows.items():
        row["winner"] = table[key]["blocks"][0]
    return rows


def _plan_gains():
    """The plan tuner's keys measured since the tuner's last reset: how
    many, how many moved off the rule's plan (measured first), and the
    sums of the rule's and the winners' device us over them."""
    from repro_torch.kernels import autotune

    table = autotune._load(autotune.cache_path())
    rows = {}
    for m in autotune.measurements:
        if not m["key"].startswith("dispatch:"):
            rows.setdefault(m["key"], []).append(m)
    out = {}
    for key, ms in rows.items():
        op = key.split("|")[0]
        d = out.setdefault(op, {"keys": 0, "moved": 0, "rule_us": 0.0,
                                "tuned_us": 0.0})
        d["keys"] += 1
        d["rule_us"] += ms[0]["us"]
        d["tuned_us"] += table[key]["us"]
        d["moved"] += list(table[key]["blocks"]) != list(ms[0]["cand"])
    for op, d in out.items():
        print(f"  tuning pass, {op}: {d['keys']} keys, {d['moved']} off the "
              f"rule's plan; summed device us rule {d['rule_us']:.1f}, "
              f"tuned {d['tuned_us']:.1f}")
    return out


def _step_enqueue_us(torch, eng, tok, pos, cache, reps=20):
    """Median host microseconds a dense decode step takes to return,
    the device idle as each starts (its work not waited for)."""
    ts = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.decode_step(tok, pos, cache)
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(ts[1:]) * 1e6


def _timed_stream(torch, serve, eng, args):
    """``serve._serve_stream`` on the card: (results, wall s, tok/s,
    tuner misses inside it)."""
    m0 = _tuner_misses()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve._serve_stream(eng, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r) for r in out.values())
    return out, wall, n_tok / wall, _tuner_misses() - m0


def _tuned_case(torch, build, label, served, fn, plain, launch, rule,
                tuned, cands):
    """The tuner's plan at a headline shape: the output through the
    wrapper (served by variant ``served`` alone) held to the plain version
    at TOL and bitwise over two launches, every plan the tuner weighs
    (``cands``) bitwise equal to the rule's; the tuned plan's time beside
    the rule's."""
    before = dict(build.VARIANTS)
    got = fn()
    torch.cuda.synchronize()
    ran = [k for k, n in build.VARIANTS.items() if n != before[k]]
    if ran != [served]:
        raise AssertionError(f"{label}: served by {ran}, the rule's "
                             f"variant is {served}")
    want = plain()
    atol, rtol = TOL[str(got.dtype)[6:]]
    err = (got.float() - want.float()).abs()
    if not bool((err <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"{label}: tuned plan {tuned} off the plain "
                             f"version by {err.max().item():.3e}")
    if not torch.equal(got, fn()):
        raise AssertionError(f"{label}: two launches differ")
    base = launch(rule)
    differ = [p for p in cands if not torch.equal(launch(p), base)]
    if differ:
        raise AssertionError(f"{label}: plans {differ} sum otherwise than "
                             f"the rule's {tuple(rule)}")
    row = {"case": label, "variant": served, "rule_plan": list(rule),
           "tuned_plan": list(tuned), "max_abs_err": err.max().item(),
           "rule_ms": time_ms(torch, lambda: launch(rule)),
           "tuned_ms": time_ms(torch, lambda: launch(tuned))}
    print(f"  {label} ({served}): rule {tuple(rule)} {row['rule_ms']:.4f} "
          f"ms, tuned {tuple(tuned)} {row['tuned_ms']:.4f} ms; max|d| "
          f"{row['max_abs_err']:.3e} from the plain version")
    return row


def _block_tuner(torch, build):
    """(c): kernels 1, 2 and 16 at phase 2's headline shapes through
    their wrappers, on the tuner's plans."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import vwr_conv2d as K16
    from repro_torch.kernels import vwr_matmul as KM

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(30)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(bf16)

    rows = []
    M, K, N = 512, 5632, 2048              # tinyllama down + residual
    x, w, r = randn(M, K), randn(K, N, scale=K ** -0.5), randn(M, N)
    kind = KM.variant(M, N, K, bf16, True)
    rows.append(_tuned_case(
        torch, build, f"vwr_matmul {M}x{K}x{N} +res", f"vwr_matmul.{kind}",
        lambda: KM.vwr_matmul(x, w, residual=r),
        lambda: KM.vwr_matmul_ref(x, w, residual=r),
        lambda p: KM.launch(x, w, None, r, None, kind, p),
        KM.tile_plan(M, N, K),
        autotune.matmul_plan(kind, x, w, None, r, None),
        autotune.retiled(KM.tile_plan(M, N, K), autotune.ROW_TILES)))
    M, K, N = 512, 2048, 5632              # tinyllama gate / up
    x = randn(M, K)
    wg, wi = randn(K, N, scale=K ** -0.5), randn(K, N, scale=K ** -0.5)
    rows.append(_tuned_case(
        torch, build, f"vwr_swiglu {M}x{K}x{N}", "vwr_swiglu.wgmma",
        lambda: KM.vwr_swiglu(x, wg, wi),
        lambda: KM.vwr_swiglu_ref(x, wg, wi),
        lambda p: KM.swiglu_launch(x, wg, wi, "wgmma", p),
        KM.swiglu_tile_plan(M, N, K), autotune.swiglu_plan(x, wg, wi),
        autotune.retiled(KM.swiglu_tile_plan(M, N, K), autotune.TILES)))
    label, n, H, W, C, Fo, KH = CONV_PLAN_SHAPES[0]     # RN_56x56 N32
    x, w, b = _conv_operands(torch, gen, n, H, W, C, Fo, KH, KH, bf16)
    rows.append(_tuned_case(
        torch, build, f"vwr_conv2d {label}", "vwr_conv2d.wgmma",
        lambda: K16.vwr_conv2d(x, w, b, activation="relu"),
        lambda: K16.vwr_conv2d_ref(x, w, b, activation="relu"),
        lambda p: K16.launch(x, w, b, "relu", "wgmma", p),
        K16.plan(n, H, W, C, KH, KH, Fo),
        autotune.conv_plan(x, w, b, "relu"),
        autotune.retiled(K16.plan(n, H, W, C, KH, KH, Fo), autotune.TILES)))
    return rows


def _cli_and_examples(torch, serve):
    """(d): ``serve.main`` at the CLI's --reduce width for generate, a
    stream with --inject, and a durable stream crashed at step 6 against
    a crash-free one; then quickstart, serve_batch (crash recovery) and
    train_100m as subprocesses, each to exit 0."""
    import os
    import shutil
    import tempfile

    import numpy as np

    res = {}
    gen = serve.main(CLI_ARGS)
    if tuple(gen.shape) != (4, 32):
        raise AssertionError(f"serve.main generate: {tuple(gen.shape)}")
    out = serve.main(CLI_ARGS + ["--stream", "24", "--inject"])
    status = {v: sum(r.status.value == v for r in out.values())
              for v in ("FINISHED", "FAILED", "CANCELLED")}
    if len(out) != 24 or sum(status.values()) != 24 or not status["FAILED"]:
        raise AssertionError(f"serve.main --inject: {status}")
    res["inject_status"] = status
    d = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    procs = {}
    try:
        durable = ["--stream", "24", "--snapshot-every", "2"]
        crashed = serve.main(CLI_ARGS + durable + [
            "--snapshot-dir", os.path.join(d, "crash"), "--crash-at", "6"])
        clean = serve.main(CLI_ARGS + durable + [
            "--snapshot-dir", os.path.join(d, "clean")])
        parted = [rid for rid in sorted(clean)
                  if crashed[rid].status is not clean[rid].status
                  or not np.array_equal(crashed[rid], clean[rid])]
        if set(crashed) != set(clean) or parted:
            raise AssertionError(f"serve.main --crash-at 6: streams "
                                 f"{parted} differ from the crash-free run")
        res["durable_equal"] = len(clean)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        mods = {"quickstart": [],
                "serve_batch": ["--stream", "--crash-at", "6",
                                "--snapshot-every", "2"],
                "train_100m": ["--steps", "20", "--ckpt",
                               os.path.join(d, "ckpt")]}
        t0 = time.perf_counter()
        for name, argv in mods.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"repro_torch.examples.{name}",
                 *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        for name, p in procs.items():
            text, _ = p.communicate(timeout=600)
            tail = text.strip().splitlines()[-2:]
            print(f"  examples.{name}: exit {p.returncode}; "
                  + " | ".join(tail))
            if p.returncode:
                raise AssertionError(f"examples.{name} exited "
                                     f"{p.returncode}:\n{text[-4000:]}")
        res["examples_s"] = time.perf_counter() - t0
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(d, ignore_errors=True)
    return res


def serve_surfaces(torch):
    """Phase 11: (a) full-width tinyllama-1.1b through
    ``serve.engine_config_from_args`` on kernel_impl "auto": ``generate``
    (each ``dispatch:<op>`` winner with both backends' measured us, the
    launches by kernel and variant, teacher-forced logits against the
    plain path at 5e-2 of scale) beside "cuda", the host enqueue time of
    a decode step on each, and phase 5's stream shape through
    ``serve._serve_stream`` on bf16 pools on each; (b) the tuner reset and
    the same generate again: nothing measured, the same tokens; (c) the
    block tuner at the headline shapes of kernels 1, 2 and 16; (d) the
    CLI and the examples on the card."""
    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, RequestStatus
    from repro_torch.kernels import autotune, build
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    print(f"autotuner cache {autotune.cache_path()}; misses inside the "
          "timed windows of phases 3-6: "
          + ", ".join(f"{w} {n}" for w, n in TIMED_WINDOWS))
    res = {"timed_window_misses": [list(w) for w in TIMED_WINDOWS]}
    args = serve.build_parser().parse_args(AUTO_ARGS)
    ecfg = serve.engine_config_from_args(args)
    cfg = get_config(args.arch)
    eng = DecodeEngine(cfg, ecfg, device="cuda", seed=0)
    _condition(torch, eng.params)
    engines = {"auto": eng, "cuda": DecodeEngine(
        cfg, ecfg.replace(kernel_impl="cuda"), params=eng.params,
        device="cuda")}
    ref = DecodeEngine(cfg, ecfg.replace(kernel_impl="torch"),
                       params=eng.params, device="cuda")
    B, P, G = args.batch, args.prompt_len, args.gen
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=g,
                            device="cuda", dtype=torch.int32)

    # (a) generate: a warm-up, then a timed run.  On 'auto' the warm-up
    # is a tuning pass: 'auto' measures the backends and the plan hooks
    # the tiles; "cuda" after it looks the plans up
    gens = {}
    for impl, e in engines.items():
        m0 = _tuner_misses()
        with (autotune.tuning() if impl == "auto"
              else contextlib.nullcontext()):
            e.generate({"tokens": prompts}, gen=G)
        warm = _tuner_misses() - m0
        build.reset_launches()
        m0 = _tuner_misses()
        tokens, stats = e.generate({"tokens": prompts}, gen=G)
        torch.cuda.synchronize()
        gens[impl] = {
            "tokens": tokens, "warmup_misses": warm,
            "misses": _tuner_misses() - m0,
            "launches": {k: n for k, n in build.LAUNCHES.items() if n},
            "variants": {k: n for k, n in build.VARIANTS.items() if n},
            **stats}
        print(f"  generate B{B} P{P} gen {G} on {impl!r}: prefill "
              f"{stats['prefill_tok_s']:.1f} tok/s, decode "
              f"{stats['decode_tok_s']:.1f} tok/s; tuner misses: warm-up "
              f"{warm}, timed {gens[impl]['misses']}")
        print(f"    launches {gens[impl]['launches']}")
        print(f"    variants {gens[impl]['variants']}")
        if gens[impl]["misses"]:
            raise AssertionError(f"{impl}: the timed generate missed")
    res["plan_tuning"] = _plan_gains()
    winners = _dispatch_winners()
    print("  'auto' winners (us measured on cuda / torch):")
    for key, row in winners.items():
        op, shape, dtype = key.split("|")[:3]
        print(f"    {op[9:]:<16} {row.get('cuda', float('nan')):9.1f} "
              f"{row.get('torch', float('nan')):9.1f} -> {row['winner']:<5}"
              f" [{shape[:48]}{'...' if len(shape) > 48 else ''}; "
              f"{dtype}]")
    res["winners"] = winners
    rel, cache = _teacher_forced(torch, eng, ref, prompts,
                                 gens["auto"]["tokens"], P, G,
                                 check_greedy=True)
    print(f"  'auto' teacher-forced logits vs plain path: max |d|/max|ref| "
          f"{max(rel):.3e} over {len(rel)} steps (limit {E2E_BF16_REL:g})")
    if not max(rel) <= E2E_BF16_REL:
        raise AssertionError("'auto': logits diverge from the plain path")
    tok = gens["auto"]["tokens"][:, -1]
    enqueue = {}
    for impl, e in engines.items():
        _, c = e.prefill({"tokens": prompts})
        enqueue[impl] = _step_enqueue_us(torch, e, tok, P, c)
    del cache, c
    print(f"  host enqueue of a decode step: auto {enqueue['auto']:.1f} us, "
          f"cuda {enqueue['cuda']:.1f} us")
    res.update(generate={k: {n: v for n, v in d.items() if n != "tokens"}
                         for k, d in gens.items()},
               logits_rel_err=rel, step_enqueue_us=enqueue,
               same_tokens_as_cuda=bool(torch.equal(
                   gens["auto"]["tokens"], gens["cuda"]["tokens"])))

    # the phase-5 stream shape through serve._serve_stream: a warm-up
    # stream (on 'auto' a tuning pass), then a timed one
    streams = {}
    for impl in ("auto", "cuda"):
        sargs = serve.build_parser().parse_args(
            AUTO_ARGS + AUTO_STREAM + ["--kernel-impl", impl])
        se = DecodeEngine(cfg, serve.engine_config_from_args(sargs),
                          params=eng.params, device="cuda")
        with (autotune.tuning() if impl == "auto"
              else contextlib.nullcontext()):
            _, _, _, warm = _timed_stream(torch, serve, se, sargs)
        out, wall, tok_s, misses = _timed_stream(torch, serve, se, sargs)
        bad = [rid for rid, r in out.items()
               if r.status is not RequestStatus.FINISHED]
        if len(out) != N_REQ or bad:
            raise AssertionError(f"stream on {impl!r}: unfinished {bad}")
        streams[impl] = {"out": out, "wall_s": wall, "gen_tok_s": tok_s,
                         "warmup_misses": warm, "tuner_misses": misses}
        print(f"  stream on {impl!r} (bf16 pools): {wall:.4f} s, "
              f"{tok_s:.1f} generated tok/s; tuner misses: warm-up "
              f"{warm}, timed {misses}")
        if misses:
            raise AssertionError(f"{impl}: the timed stream missed")
        del se
    same = sum(bool((streams["auto"]["out"][rid]
                     == streams["cuda"]["out"][rid]).all())
               for rid in streams["cuda"]["out"])
    print(f"  {same}/{N_REQ} 'auto' streams equal to the 'cuda' ones")
    res["streams"] = {k: {n: v for n, v in d.items() if n != "out"}
                      for k, d in streams.items()}
    res["streams_equal"] = same

    # (b) the cache persists: a fresh in-memory tuner reads the file
    autotune.reset()
    again, _ = eng.generate({"tokens": prompts}, gen=G)
    if autotune.stats["misses"] or not torch.equal(
            again, gens["auto"]["tokens"]):
        raise AssertionError(f"after reset: {autotune.stats}, same tokens "
                             f"{torch.equal(again, gens['auto']['tokens'])}")
    print(f"  after autotune.reset(): generate again with "
          f"{autotune.stats['hits']} hits, 0 misses, the same tokens")
    res["reset_hits"] = autotune.stats["hits"]
    del engines, ref, eng
    torch.cuda.empty_cache()

    # (c) the block tuner, in a tuning pass
    with autotune.tuning():
        res["block_tuner"] = _block_tuner(torch, build)
    # (d) the CLI and the examples
    res["cli"] = _cli_and_examples(torch, serve)
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 11: {res['wall_s']:.1f} s")
    return res


# ----------------------------------------------------------------------
# phase 12: distributed serving (sequence-sharded decode over ranks)
# ----------------------------------------------------------------------

# generate at full width on each mesh: B4 P128 gen 16 in a cache of 160
# (cut from gen 32 to make room for phase 13)
DIST_B, DIST_P, DIST_GEN, DIST_MAX = 4, 128, 16, 160
# phase 5's Scheduler stream on (1, 2) seq: its first DIST_REQ requests
# at gen DIST_REQ_GEN (cut from all N_REQ at gen GEN to make room for
# phase 13).  More than FIRST + BURST of them, so requests are still
# admitted mid-stream into the slots and pages that finished ones freed
DIST_REQ, DIST_REQ_GEN = 12, 16
# P16 gen 16 on (1, 2): its 32 positions lie in rank 0's slab [0, 80), so
# rank 1 launches kernel 4 with no valid key at every step
DIST_SHORT = (16, 16)
# a sampled generate at P16 gen 16 on (2, 1) and on the single rank
DIST_TEMP = 0.8
# the reduced dense + MLA config (fp32): generate B4 P16 gen 8 in a cache
# of 32, and the reduced Scheduler geometry of scheduler_reduced_fp32
MLA_GEN = (4, 16, 8, 32)
MLA_PAGED = dict(batch=3, max_len=64, paged=True, page_size=8, n_pages=12)
# n (cut from 7 to make room for phase 13), prompt range, gen, seed
MLA_REQS = (4, (5, 40), 16, 6)
# DeepSeek-V3's attention widths (phase 2's MLA cases)
DS_H, DS_R, DS_RP = 128, 512, 64
# tensor-parallel serving on (1, 2): tinyllama-1.1b's generate (the
# DIST_* shape) and DIST_REQ-request Scheduler stream on bf16 pools, each
# rank its blocks of the weights, beside olmoe-1b-7b at full width cut to
# TP_OLMOE_DEPTH layers (both MoE) with ep="full_ep": 64 experts, 32 a
# rank.  Its random router puts near-ties in the top 8 of 64 that the
# ranks' bf16 partial sums break apart, and every sequence of a 128-token
# prefill meets one, so its teacher-forced run is routed as the single
# rank's (``_ForcedRoutes``), the sets that differed counted, and every
# row held at E2E_BF16_REL
TP_OLMOE_DEPTH = 2
# the rows of a rank's kernel 1 and 2 products held at its local shapes
TP_ROWS = DIST_B * DIST_P


def _param_digest(torch, params):
    """Per leaf, the sum and the sum of squares of its bits read as int16:
    equal digests on two ranks mean the same seeded parameters (no
    broadcast of the weights through the host)."""
    from repro_torch.common.module import leaves

    out = []
    for path, t in leaves(params):
        bits = t.contiguous().view(-1).view(torch.int16).to(torch.int64)
        out.append(("/".join(path), int(bits.sum()),
                    int((bits * bits).sum())))
    return out


def _forced(torch, eng, prompts, tokens, P, gen):
    """Host fp32 logits of ``eng``'s prefill and ``gen - 1`` decode steps
    fed ``tokens`` (the whole batch's (B, gen); each rank feeds its rows,
    ``eng.rows``)."""
    V = eng.cfg.vocab
    lg, cache = eng.prefill({"tokens": prompts})
    out = [lg[:, :V].float().cpu()]
    for i in range(gen - 1):
        lg, cache = eng.decode_step(tokens[eng.rows, i].cuda(), P + i,
                                    cache)
        out.append(lg[:, :V].float().cpu())
    return out


def _rel_errs(got, want, rows, floor=0.0):
    """Per step max|d| / max(floor, max|want|) over this rank's rows."""
    return [(a - b[rows]).abs().max().item()
            / max(floor, b[rows].abs().max().item())
            for a, b in zip(got, want)]


def _combine_share(torch, eng, prompts, gen):
    """One more generate with the host clock around each collective of
    the combine (a device sync before and after, so the time is the
    collective's, the host staging of gloo included): (seconds in the
    collectives, their count, the decode's seconds)."""
    from repro_torch.launch.mesh import Mesh

    spent = [0.0, 0]
    orig = Mesh.all_reduce

    def timed(self, t, axis, op="sum"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(self, t, axis, op)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return t
    Mesh.all_reduce = timed
    try:
        _, stats = eng.generate({"tokens": prompts}, gen=gen)
    finally:
        Mesh.all_reduce = orig
    return {"combine_s": spent[0], "collectives": spent[1],
            "t_decode_s": stats["t_decode_s"],
            "share": spent[0] / stats["t_decode_s"]}


def _dist_generate(torch, eng, prompts, ref, P, gen, tol, floor=0.0,
                   kernel="vwr_flash_decode", share=False, warm=True):
    """Generate on a mesh (after a short warm-up in a fresh process, the
    timed run with the launch counters set to 0 just before it and read
    just after), the single rank's tokens fed back teacher-forced and
    each step's logits held to its at ``tol`` of scale, and the greedy
    tokens counted against its stream."""
    from repro_torch.kernels import build

    p = prompts[:, :P].cuda()
    if warm:
        eng.generate({"tokens": p}, gen=2)
    torch.cuda.synchronize()
    build.reset_launches()
    tokens, stats = eng.generate({"tokens": p}, gen=gen)
    torch.cuda.synchronize()
    launches = build.LAUNCHES[kernel]
    every = {k: n for k, n in build.LAUNCHES.items() if n}
    variants = {k: n for k, n in build.VARIANTS.items()
                if k.startswith(kernel + ".") and n}
    L = eng.cfg.n_layers
    if launches != L * (gen - 1):
        raise AssertionError(f"{kernel} launched {launches} times on "
                             f"{eng.mesh!r}, expected {L * (gen - 1)}")
    rel = _rel_errs(_forced(torch, eng, p, ref["tokens"], P, gen),
                    ref["logits"], eng.rows, floor)
    if not max(rel) <= tol:
        raise AssertionError(f"{eng.mesh!r}: teacher-forced logits "
                             f"{max(rel):.3e} of scale past {tol:g}")
    out = {"tokens": tokens.cpu(), "launches": launches,
           "every_launch": every, "variants": variants,
           "max_rel_err": max(rel),
           "equal_tokens": int((tokens.cpu() == ref["tokens"]).sum()),
           "decode_tok_s": stats["decode_tok_s"]}
    if share:
        out["combine"] = _combine_share(torch, eng, p, gen)
    return out


def _one_rank(mesh):
    """A one-rank mesh on this rank's device (a single-rank engine inside
    a world of several)."""
    from repro_torch.launch.mesh import Mesh

    return Mesh({"data": 1, "model": 1}, {"data": 0, "model": 0},
                device=mesh.device)


def _replay_forced(torch, eng, reqs, streams):
    """Teacher-force each request's ``streams`` tokens through ``eng``
    (sharded or not) from fresh pools, as many requests at a time as
    slots and pages allow, one slot and a run of pages each: the logits
    rows (host fp32) of the prefill and of every decode step."""
    import numpy as np

    from repro_torch.engine.paged_cache import write_prefill

    B, ps, V = eng.ecfg.batch, eng.page_size, eng.cfg.vocab
    need = {r.rid: -(-(len(r.tokens) + len(streams[r.rid])) // ps)
            for r in reqs}
    groups, group = [], []
    for r in reqs:
        if len(group) == B or sum(need[g.rid] for g in group) \
                + need[r.rid] > eng.n_pages:
            groups.append(group)
            group = []
        group.append(r)
    groups.append(group)
    out = {r.rid: [] for r in reqs}
    for group in groups:
        table = np.zeros((B, eng.max_pages), np.int32)
        lens = np.zeros((B,), np.int32)
        at = 0
        for b, r in enumerate(group):
            table[b, :need[r.rid]] = np.arange(at, at + need[r.rid])
            at += need[r.rid]
            lens[b] = len(r.tokens)
        cache = eng.init_paged_cache()
        for b, r in enumerate(group):
            lg, caches = eng.prefill_fn(eng.params, {
                "tokens": torch.from_numpy(r.tokens)[None].cuda()})
            write_prefill(eng.cfg, cache, caches, table[b:b + 1],
                          slab=eng.page_slab)
            out[r.rid].append(lg[0, :V].float().cpu())
        for i in range(max(len(streams[r.rid]) for r in group) - 1):
            tok = np.zeros((B,), np.int32)
            cur = np.zeros((B,), np.int32)
            for b, r in enumerate(group):
                if i + 1 < len(streams[r.rid]):
                    tok[b], cur[b] = streams[r.rid][i], lens[b] + i
            lg, cache = eng.decode_step(tok, cur, cache, block_table=table)
            for b, r in enumerate(group):
                if cur[b]:
                    out[r.rid].append(lg[b, :V].float().cpu())
    return out


def _dist_stream(torch, mesh, cfg, params, ecfg, reqs, want, tol,
                 floor=0.0, shard="seq"):
    """A Scheduler stream on a (1, M) paged engine, seq-sharded or with
    ``shard='none'`` tensor-parallel (launches counted from 0 over the
    stream), its greedy streams against the single rank's ``want``:
    equal, or the parted requests replayed with ``want``'s tokens through
    both engines from fresh pools and their logits held at ``tol`` of
    scale at every step."""
    from repro_torch.engine import DecodeEngine, RequestStatus, Scheduler
    from repro_torch.kernels import build

    eng = DecodeEngine(cfg, ecfg.replace(mesh_shape=(1, mesh.axis_size(
        "model")), decode_shard=shard), params=params, device="cuda",
        mesh=mesh)
    sched = Scheduler(eng)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    out = _drive(sched, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = sched.stats
    mla = cfg.mla is not None
    kernel = ("vwr_mla_paged_flash_decode" if mla
              else "vwr_paged_flash_decode") + (
        "_q8" if ecfg.kv_dtype == "int8" else "")
    L = cfg.n_layers
    if build.LAUNCHES[kernel] != L * st["steps"]:
        raise AssertionError(f"{kernel} launched {build.LAUNCHES[kernel]} "
                             f"times, expected {L * st['steps']}")
    bad = [i for i, r in out.items() if r.status
           is not RequestStatus.FINISHED]
    if bad or len(out) != len(reqs):
        raise AssertionError(f"unfinished requests {bad}")
    sched.allocator.check()
    got = [out[i].tokens.tolist() for i in range(len(reqs))]
    res = {"kv_dtype": ecfg.kv_dtype, "steps": st["steps"],
           "admitted": st["admitted"], "retired": st["retired"],
           "launches": build.LAUNCHES[kernel], "wall_s": wall,
           "gen_tok_s": sum(len(t) for t in got) / wall,
           "equal": got == want,
           "table_digest": hashlib.sha256(
               sched.table.tobytes() + sched.lens.tobytes()).hexdigest()}
    parted = [i for i in range(len(reqs)) if got[i] != want[i]]
    if parted:
        ref = DecodeEngine(cfg, ecfg, params=params, device="cuda",
                           mesh=_one_rank(mesh))
        # every parted request, in groups of as many as the slots and
        # the pool hold at once
        pick = [reqs[i] for i in parted]
        streams = {r.rid: want[r.rid] for r in pick}
        a = _replay_forced(torch, eng, pick, streams)
        b = _replay_forced(torch, ref, pick, streams)
        worst, agree, n = 0.0, 0, 0
        for i in streams:
            for j, (x, y) in enumerate(zip(a[i], b[i])):
                err = (x - y).abs().max().item() / max(
                    floor, y.abs().max().item())
                if not err <= tol:
                    raise AssertionError(
                        f"{kernel} stream, request {i} replayed, step {j}: "
                        f"{err:.3e} of scale past {tol:g}")
                worst = max(worst, err)
                agree += int(x.argmax()) == want[i][j]
                n += 1
        res.update(parted=parted, replayed=sorted(streams),
                   replayed_steps=n, replay_max_rel=worst,
                   replay_picks_single_token=agree)
    return res


def _hold_op(torch, rows, name, shape, got, want, dt):
    """A sharded op's outputs against the unsharded launch's at TOL[dt]
    (normalized outputs; (o~, m, l) partials as o~ / l and m)."""
    atol, rtol = TOL[str(dt).split(".")[-1]]
    if isinstance(got, tuple):
        got = (got[0] / got[2].clamp_min(1e-30)[..., None], got[1])
        want = (want[0] / want[2].clamp_min(1e-30)[..., None], want[1])
    else:
        got, want = (got,), (want,)
    err = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        if not bool(((a - b).abs() <= atol + rtol * b.abs()).all()):
            raise AssertionError(f"{name} {shape}: sharded max|d| "
                                 f"{(a - b).abs().max().item():.3e} past "
                                 f"atol {atol} + rtol {rtol}")
        err = max(err, (a - b).abs().max().item())
    rows.append({"kernel": name, "case": shape, "max_abs_err": err})


def _dist_ops(torch, mesh):
    """Op level on the mesh's 'model' ranks: kernels 10 and 14 (dense
    latent slabs, bf16 and int8) and 11 and 13 (latent pools) at
    DeepSeek-V3's widths (H 128, r 512, rope 64), kernel 9 (the dense
    int8 slab) at tinyllama's, kernels 6 and 8 (the chunk prefix, GQA)
    and 12 and 15 (MLA) over permuted tables, each through
    ``dist.decode``'s sharded function on this rank's block and held to
    the same kernel on the whole operands.  Every kind has a case whose
    rank 1 holds no valid key."""
    import numpy as np

    from repro_torch.dist import decode as DD
    from repro_torch.dist.sharding import PS, block_span, local_block

    g = torch.Generator(device="cuda").manual_seed(27)
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    SC = 1.0 / 192 ** 0.5
    M = mesh.axis_size("model")
    rows = []

    def rnd(*s, dt=f32):
        return torch.randn(*s, generator=g, device="cuda").to(dt)

    def ints(*s):
        return torch.randint(-127, 128, s, generator=g, device="cuda",
                             dtype=i8)

    def scales(*s):
        return torch.rand(*s, generator=g, device="cuda") * 0.02 + 1e-3

    def slab(x):
        return local_block(x, PS(None, "model"), mesh)

    # kernels 10, 14: B, T, cur_len
    for label, B, T, cur in (("B4 T160 cur144", 4, 160, 144),
                             ("B1 T2048", 1, 2048, 2048),
                             ("rank 1 empty", 4, 160, 60)):
        qa, qr = rnd(B, DS_H, DS_R), rnd(B, DS_H, DS_RP)
        for q8 in (False, True):
            if q8:
                ck, kr, sc = ints(B, T, DS_R), ints(B, T, DS_RP), \
                    (scales(B), scales(B))
            else:
                ck, kr, sc = rnd(B, T, DS_R, dt=bf16), \
                    rnd(B, T, DS_RP, dt=bf16), (None, None)
            kw = dict(scale=SC, ckv_scale=sc[0], krope_scale=sc[1])
            want = DD.local_mla_decode_attend(qa, qr, ck, kr, cur, **kw)
            got = DD.sharded_mla_flash_decode(mesh, qa, qr, slab(ck),
                                              slab(kr), cur, **kw)
            _hold_op(torch, rows, "vwr_mla_flash_decode" + (
                "_q8" if q8 else ""), label, got, want, f32)
    # kernels 11, 13: 8 slots over a 1024-page pool, tables permuted over
    # all of it; then every page in rank 0's half (rank 1 empty)
    lens, ps, n_pages, J = (0, 1, 16, 17, 255, 100, 200, 64), 16, 1024, 17
    pp = n_pages // M
    for label, span in (("8 slots", n_pages), ("rank 1 empty", pp)):
        perm = torch.randperm(span, generator=g, device="cuda").cpu()
        table = np.zeros((8, J), np.int32)
        at = 0
        for b, n in enumerate(lens):
            live = -(-n // ps)
            table[b, :live] = perm[at:at + live].numpy()
            at += live
        counts = DD._page_counts(np.array(lens), J, ps)
        qa, qr = rnd(8, DS_H, DS_R), rnd(8, DS_H, DS_RP)
        tl, cl = (torch.from_numpy(a).cuda() for a in DD.own_pages(
            table, counts, *block_span(mesh, "model", n_pages)))
        tw, cw = torch.from_numpy(table).cuda(), \
            torch.from_numpy(counts).cuda()
        for q8 in (False, True):
            if q8:
                pools, sc = [ints(n_pages, ps, w) for w in (DS_R, DS_RP)], \
                    [scales(n_pages) for _ in range(2)]
            else:
                pools, sc = [rnd(n_pages, ps, w, dt=bf16)
                             for w in (DS_R, DS_RP)], [None, None]
            mine = [local_block(p, PS("model"), mesh) for p in pools]
            smine = [None if s is None else local_block(s, PS("model"),
                                                        mesh) for s in sc]
            want = DD.local_mla_paged_decode_attend(
                qa, qr, *pools, tw, cw, scale=SC, ckv_scale=sc[0],
                krope_scale=sc[1])
            got = DD.sharded_mla_paged_flash_decode(
                mesh, qa, qr, *mine, tl, cl, scale=SC, ckv_scale=smine[0],
                krope_scale=smine[1])
            _hold_op(torch, rows, "vwr_mla_paged_flash_decode" + (
                "_q8" if q8 else ""), label, got, want, f32)
    # kernel 9: tinyllama's decode over int8 slabs, (B, KV) scales
    for label, cur in (("tinyllama B4 T160 cur144", 144),
                       ("rank 1 empty", 60)):
        q = rnd(4, 32, 64, dt=bf16)
        k, v = ints(4, 160, 4, 64), ints(4, 160, 4, 64)
        ks, vs = scales(4, 4), scales(4, 4)
        want = DD.local_decode_attend(q, k, v, cur, k_scale=ks, v_scale=vs)
        got = DD.sharded_flash_decode(mesh, q, slab(k), slab(v), cur,
                                      k_scale=ks, v_scale=vs)
        _hold_op(torch, rows, "vwr_flash_decode_q8", label, got, want, bf16)
    # kernels 6, 8 (tinyllama's chunk) and 12, 15 (DeepSeek-V3's): a
    # 64-token chunk over 16 prior pages of 16, permuted over a 64-page
    # pool, then all of them in rank 0's half
    n_pages, pp = 64, 64 // M
    counts = np.full((16,), 16, np.int32)
    for label, span in (("chunk 64, 16 pages", n_pages),
                        ("rank 1 empty", pp)):
        table = torch.randperm(span, generator=g, device="cuda")[:16].cpu() \
            .numpy().astype(np.int32)
        tl, cl = (torch.from_numpy(a).cuda() for a in DD.own_pages(
            table, counts, *block_span(mesh, "model", n_pages)))
        tw, cw = torch.from_numpy(table).cuda(), \
            torch.from_numpy(counts).cuda()
        q = rnd(64, 32, 64, dt=bf16)
        qa, qr = rnd(64, DS_H, DS_R), rnd(64, DS_H, DS_RP)
        for q8 in (False, True):
            if q8:
                kv = [ints(n_pages, 16, 4, 64) for _ in range(2)]
                ksc = [scales(n_pages, 4) for _ in range(2)]
                lat = [ints(n_pages, 16, w) for w in (DS_R, DS_RP)]
                lsc = [scales(n_pages) for _ in range(2)]
            else:
                kv = [rnd(n_pages, 16, 4, 64, dt=bf16) for _ in range(2)]
                lat = [rnd(n_pages, 16, w, dt=bf16) for w in (DS_R, DS_RP)]
                ksc, lsc = [None, None], [None, None]

            def mine(xs):
                return [None if x is None else local_block(x, PS("model"),
                                                           mesh)
                        for x in xs]
            want = DD.local_chunk_prefix_attend(
                q, *kv, tw, cw, k_scale=ksc[0], v_scale=ksc[1])
            got = DD.sharded_chunk_prefix_attend(
                mesh, q, *mine(kv), tl, cl, k_scale=mine(ksc)[0],
                v_scale=mine(ksc)[1])
            _hold_op(torch, rows, "vwr_chunk_prefix_attend" + (
                "_q8" if q8 else ""), label, got, want, bf16)
            from repro_torch.kernels import dispatch as KD
            op = "chunk_prefix_mla_paged" + ("_q8" if q8 else "")
            sc = tuple(s for s in lsc if s is not None)
            want = KD.dispatch(op, "cuda", qa, qr, *lat, *sc, tw, cw,
                               scale=SC)
            got = DD.sharded_mla_chunk_prefix_attend(
                mesh, qa, qr, *mine(lat), tl, cl, scale=SC,
                ckv_scale=mine(lsc)[0], krope_scale=mine(lsc)[1])
            _hold_op(torch, rows, "vwr_mla_chunk_prefix_attend" + (
                "_q8" if q8 else ""), label, got, want, f32)
    return rows


def _nbytes(params) -> int:
    from repro_torch.common.module import leaves
    return sum(t.numel() * t.element_size() for _, t in leaves(params))


def _olmoe_tp(torch):
    """olmoe-1b-7b at full width, TP_OLMOE_DEPTH layers, ep="full_ep",
    with its conditioned weights from seed 0 on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("olmoe-1b-7b")
    cfg = cfg.replace(n_layers=TP_OLMOE_DEPTH,
                      moe=dataclasses.replace(cfg.moe, ep="full_ep"))
    params = lm.init(cfg, seed=0, device="cuda")
    _condition(torch, params)
    return cfg, params


def _forced_routes(torch, eng, prompts, tokens, P, gen):
    """``_forced``'s logits, and every MoE layer's expert sets of each call
    (``_Routes``), host side."""
    with _Routes() as routes:
        routes.tag = "forced"
        logits = _forced(torch, eng, prompts, tokens, P, gen)
        return logits, [r.cpu() for r in routes.take("forced")]


class _ForcedRoutes:
    """Routes every MoE FFN call as the same call of another run did
    (``ref``: its sorted expert sets a call, ``_Routes``' log), each
    assignment gated by this run's own probability, and counts the
    (token, layer) sets this run would have chosen otherwise: two paths'
    logits compared with the routing held equal."""

    def __init__(self, ref):
        from repro_torch.models import moe
        self.moe, self.orig, self.ref = moe, moe.top_k_gates, ref
        self.calls, self.differ = 0, 0

    def __enter__(self):
        import torch

        def top_k_gates(probs, sel, cfg):
            _, idx = self.orig(probs, sel, cfg)
            want = self.ref[self.calls].to(idx.device).view(idx.shape)
            self.calls += 1
            self.differ += int((idx.sort(-1).values != want).any(-1).sum())
            m = cfg.moe
            gates = torch.gather(probs, -1, want)
            if m.norm_topk:
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-20)
            return gates * m.routed_scale, want
        self.moe.top_k_gates = top_k_gates
        return self

    def __exit__(self, *exc):
        self.moe.top_k_gates = self.orig


def _tp_collectives(torch, eng, prompts, tokens, P, gen):
    """Decode steps after a prefill, with the host clock around every
    collective that crosses ranks (the device synchronized before and
    after, so gloo's host staging counts): collectives and their wait a
    step, beside the step's wall under those syncs."""
    from repro_torch.launch.mesh import Mesh, _axes

    spent = [0.0, 0]
    origs = {n: getattr(Mesh, n) for n in ("all_reduce", "all_gather")}

    def wrap(orig):
        def timed(self, t, axis, *a, **kw):
            if all(self.axis_size(x) == 1 for x in _axes(axis)):
                return orig(self, t, axis, *a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(self, t, axis, *a, **kw)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return out
        return timed

    lg, cache = eng.prefill({"tokens": prompts})
    for n, f in origs.items():
        setattr(Mesh, n, wrap(f))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(gen - 1):
            lg, cache = eng.decode_step(tokens[eng.rows, i].cuda(), P + i,
                                        cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for n, f in origs.items():
            setattr(Mesh, n, f)
    return {"collectives_a_step": spent[1] / (gen - 1),
            "wait_ms_a_step": 1e3 * spent[0] / (gen - 1),
            "step_ms": 1e3 * wall / (gen - 1), "share": spent[0] / wall}


def _tp_kernels(torch, eng):
    """Kernels 1 and 2 at this rank's local shapes (tinyllama-1.1b's layer
    0 blocks: q, k / v, o + residual, down + residual at TP_ROWS rows and
    the decode's 4, the gate / up pair) against their plain versions at
    TOL, on random activations."""
    from repro_torch.kernels import vwr_matmul as KM

    g = torch.Generator(device="cuda").manual_seed(31)
    lp = {k: {n: t[0] for n, t in v.items()}
          for k, v in eng.params["layers"].items() if isinstance(v, dict)}
    a, m = lp["attn"], lp["mlp"]
    d = a["wq"].shape[0]

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    x = rnd(TP_ROWS, d)
    o = rnd(TP_ROWS, a["wo"].shape[0] * a["wo"].shape[1])
    h = rnd(TP_ROWS, m["wo"].shape[0])
    res = rnd(TP_ROWS, d)
    cases = [("vwr_matmul", "q", (x, a["wq"].reshape(d, -1), None, None)),
             ("vwr_matmul", "k/v", (x, a["wk"].reshape(d, -1), None, None)),
             ("vwr_matmul", "o+res", (o, a["wo"].reshape(-1, d), None,
                                      res)),
             ("vwr_matmul", "down+res", (h, m["wo"], None, res)),
             ("vwr_matmul", "decode down", (h[:DIST_B], m["wo"], None,
                                            None)),
             ("vwr_swiglu", "gate/up", (x, m["wg"], m["wi"])),
             ("vwr_swiglu", "decode gate/up", (x[:DIST_B], m["wg"],
                                               m["wi"]))]
    atol, rtol = TOL["bfloat16"]
    rows = []
    for kernel, label, args in cases:
        fn, ref = ((KM.vwr_matmul, KM.vwr_matmul_ref) if kernel ==
                   "vwr_matmul" else (KM.vwr_swiglu, KM.vwr_swiglu_ref))
        got, want = fn(*args).float(), ref(*args).float()
        diff = (got - want).abs()
        shape = "x".join(str(n) for n in (args[0].shape[0],
                                          *args[1].shape))
        if not bool((diff <= atol + rtol * want.abs()).all()):
            raise AssertionError(f"{kernel} {label} {shape} at this rank's "
                                 f"shape: max|d| {diff.max().item():.3e}")
        rows.append({"kernel": kernel, "case": label, "shape": shape,
                     "max_abs_err": diff.max().item()})
    return rows


def _tp_olmoe(torch, mesh, prompts, ref):
    """olmoe-1b-7b with ep="full_ep" on (1, M): generate (launches
    counted), then teacher-forced with the single rank's tokens and
    expert sets (``ref``; TP_OLMOE_DEPTH's note), every row's logits held
    at E2E_BF16_REL of scale."""
    from repro_torch.engine import DecodeEngine, EngineConfig
    from repro_torch.kernels import build

    cfg, params = _olmoe_tp(torch)
    eng = DecodeEngine(cfg, EngineConfig(
        batch=DIST_B, max_len=DIST_MAX, kernel_impl="cuda",
        mesh_shape=(1, mesh.axis_size("model"))), params=params,
        device="cuda", mesh=mesh)
    digest = _param_digest(torch, params)
    del params
    torch.cuda.empty_cache()
    p = prompts[:, :DIST_P].cuda()
    eng.generate({"tokens": p}, gen=2)
    torch.cuda.synchronize()
    build.reset_launches()
    tokens, stats = eng.generate({"tokens": p}, gen=DIST_GEN)
    torch.cuda.synchronize()
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    with _ForcedRoutes(ref["routes"]) as routes:
        logits = _forced(torch, eng, p, ref["tokens"], DIST_P, DIST_GEN)
    rel = _rel_errs(logits, ref["logits"], slice(None))
    if routes.calls != len(ref["routes"]) or not max(rel) <= E2E_BF16_REL:
        raise AssertionError(f"olmoe (1, {mesh.axis_size('model')}) "
                             f"full_ep: logits {max(rel):.3e} of scale past "
                             f"{E2E_BF16_REL:g} routed as one rank, or "
                             f"{routes.calls} MoE calls against "
                             f"{len(ref['routes'])}")
    return {"digest": digest == ref["digest"], "tokens": tokens.cpu(),
            "equal_tokens": int((tokens.cpu() == ref["tokens"]).sum()),
            "decode_tok_s": stats["decode_tok_s"], "launches": launches,
            "max_rel": max(rel), "expert_sets_differ": routes.differ,
            "expert_sets": sum(len(r) for r in ref["routes"]),
            "param_bytes": _nbytes(eng.params),
            "experts_a_rank": eng.params["layers"]["moe"]["wi"].shape[1]}


def _tp_world(torch, mesh, cfg, whole, prompts, refs, streams, olmoe):
    """Phase 12's tensor-parallel serving on this (1, M) world (every rank
    runs it): tinyllama-1.1b's DIST_REQ-request Scheduler stream on bf16
    pools (the whole weights kept for replays), then its generate with
    only the rank's blocks on the card (parameter bytes, peak memory,
    collectives a step, launches), kernels 1 and 2 at the rank's shapes,
    and olmoe-1b-7b with ep="full_ep".  ``whole`` is a one-item list
    holding the whole weights, emptied here."""
    from repro_torch.engine import DecodeEngine, EngineConfig

    M = mesh.axis_size("model")
    reqs = _requests(cfg, N_REQ, PROMPT, DIST_REQ_GEN, seed=4)[:DIST_REQ]
    out = {"stream": _dist_stream(
        torch, mesh, cfg, whole[0], EngineConfig(
            batch=SLOTS, max_len=PROMPT[1] + DIST_REQ_GEN, paged=True,
            page_size=PAGE, n_pages=N_PAGES, kernel_impl="cuda"), reqs,
        streams["bf16"], E2E_BF16_REL, shard="none")}
    eng = DecodeEngine(cfg, EngineConfig(
        batch=DIST_B, max_len=DIST_MAX, kernel_impl="cuda",
        mesh_shape=(1, M)), params=whole[0], device="cuda", mesh=mesh)
    out["whole_bytes"] = _nbytes(whole.pop())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["param_bytes"] = _nbytes(eng.params)
    out["generate"] = _dist_generate(torch, eng, prompts, refs["long"],
                                     DIST_P, DIST_GEN, E2E_BF16_REL)
    out["launches"] = out["generate"]["every_launch"]
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    g = out["generate"]["tokens"]
    out["flipped_rows"] = int((g != refs["long"]["tokens"]).any(-1).sum())
    p = prompts[:, :DIST_P].cuda()
    out["collectives"] = _tp_collectives(torch, eng, p, refs["long"][
        "tokens"], DIST_P, DIST_GEN)
    out["kernels"] = _tp_kernels(torch, eng)
    del eng
    torch.cuda.empty_cache()
    out["olmoe"] = _tp_olmoe(torch, mesh, prompts, olmoe)
    torch.cuda.empty_cache()
    return out


def _dist_world(mesh, prompts, refs, digest, streams, mla, olmoe):
    """Everything phase 12 runs on one mesh of ranks (every rank runs
    it): tinyllama-1.1b's generate (and on (1, M) the short run, the
    Scheduler streams and the MLA and op-level checks); the rank's
    results, gathered from every rank."""
    import torch

    from repro_torch.common.config import MLAConfig  # noqa: F401
    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, EngineConfig

    data, model = mesh.axis_size("data"), mesh.axis_size("model")
    cfg = get_config("tinyllama-1.1b")
    seq = "seq" if model > 1 else None
    eng = DecodeEngine(cfg, EngineConfig(
        batch=DIST_B, max_len=DIST_MAX, kernel_impl="cuda",
        mesh_shape=(data, model), decode_shard=seq), device="cuda", seed=0,
        mesh=mesh)
    _condition(torch, eng.params)
    out = {"coords": dict(mesh.coords),
           "same_params": _param_digest(torch, eng.params) == digest}
    out["generate"] = _dist_generate(
        torch, eng, prompts, refs["long"], DIST_P, DIST_GEN, E2E_BF16_REL)
    if model == 1:
        # the batch split over 'data' leaves each row's logits bitwise
        # one rank's, so a sampled stream is one rank's too
        P, G = DIST_SHORT
        out["sampled"] = {"tokens": eng.generate(
            {"tokens": prompts[:, :P].cuda()}, gen=G, temperature=DIST_TEMP,
            seed=7)[0].cpu()}
        if not torch.equal(out["sampled"]["tokens"], refs["sampled"]):
            raise AssertionError(f"{mesh!r}: sampled tokens differ from "
                                 "one rank's")
    if data == 1:
        out["short"] = _dist_generate(torch, eng, prompts, refs["short"],
                                      *DIST_SHORT, E2E_BF16_REL,
                                      share=True, warm=False)
        ecfg = EngineConfig(batch=SLOTS, max_len=PROMPT[1] + DIST_REQ_GEN,
                            paged=True, page_size=PAGE, n_pages=N_PAGES,
                            kernel_impl="cuda")
        reqs = _requests(cfg, N_REQ, PROMPT, DIST_REQ_GEN, seed=4)[:DIST_REQ]
        out["streams"] = [_dist_stream(
            torch, mesh, cfg, eng.params, ecfg.replace(kv_dtype=kv), reqs,
            streams[kv], E2E_BF16_REL) for kv in ("bf16", "int8")]
        whole = [eng.params]
        del eng
        out["tp"] = _tp_world(torch, mesh, cfg, whole, prompts, refs,
                              streams, olmoe)
        for s in out["streams"] + [out["tp"]["stream"]]:
            # continuous batching: admissions past the slots reuse the
            # slots and pages of finished requests
            if s["admitted"] <= SLOTS:
                raise AssertionError(f"(1, {model}) stream: {s['admitted']}"
                                     f" admissions over {SLOTS} slots")
        torch.cuda.empty_cache()
        mcfg = _dense_mla()
        B, P, G, T = MLA_GEN
        meng = DecodeEngine(mcfg, EngineConfig(
            batch=B, max_len=T, kernel_impl="cuda", mesh_shape=(1, model),
            decode_shard="seq"), device="cuda", seed=0, mesh=mesh)
        out["mla_generate"] = _dist_generate(
            torch, meng, mla["prompts"], mla["ref"], P, G, E2E_FP32_TOL,
            floor=1.0, kernel="vwr_mla_flash_decode")
        if out["mla_generate"]["equal_tokens"] != B * G:
            raise AssertionError("MLA generate: greedy tokens differ")
        n, rng, gen, seed = MLA_REQS
        mreqs = _requests(mcfg, n, rng, gen, seed=seed)
        out["mla_streams"] = [_dist_stream(
            torch, mesh, mcfg, meng.params, EngineConfig(
                **MLA_PAGED, kv_dtype=kv, kernel_impl="cuda"), mreqs,
            mla["streams"][kv], E2E_FP32_TOL, floor=1.0)
            for kv in ("bf16", "int8")]
        if not out["mla_streams"][0]["equal"]:
            raise AssertionError("MLA fp32 Scheduler stream differs")
        del meng
        out["ops"] = _dist_ops(torch, mesh)
    ranks = mesh.gather_objects(out)
    for key in ("generate", "short", "sampled"):
        if key in out and not all(torch.equal(r[key]["tokens"],
                                              ranks[0][key]["tokens"])
                                  for r in ranks):
            raise AssertionError(f"{key}: tokens differ across ranks")
    for key in ("streams", "mla_streams"):
        if key in out and len({tuple(s["table_digest"] for s in r[key])
                               for r in ranks}) != 1:
            raise AssertionError(f"{key}: tables differ across ranks")
    if "tp" in out:
        if len({r["tp"]["stream"]["table_digest"] for r in ranks}) != 1:
            raise AssertionError("tensor-parallel stream: tables differ "
                                 "across ranks")
        for key in ("generate", "olmoe"):
            if not all(torch.equal(r["tp"][key]["tokens"],
                                   ranks[0]["tp"][key]["tokens"])
                       for r in ranks):
                raise AssertionError(f"tensor-parallel {key}: tokens "
                                     "differ across ranks")
        if not all(r["tp"]["olmoe"]["digest"] for r in ranks):
            raise AssertionError("olmoe: ranks built other parameters "
                                 "than the single rank")
    if not all(r["same_params"] for r in ranks):
        raise AssertionError("ranks built different parameters")
    return ranks


def serve_distributed(torch):
    """Phase 12: tinyllama-1.1b (full width, bf16) through ``generate``
    on (1, 2) and (2, 2) with the cache sequence-sharded and on (2, 1)
    with the batch split, and P16 gen 16 on (1, 2) (rank 1's slab empty);
    its Scheduler stream on (1, 2) seq over bf16 and int8 pools; the
    reduced dense + MLA config through generate and the Scheduler on
    (1, 2) seq; the sharded ops at DeepSeek-V3's and tinyllama's widths.
    Each rank is a process on this card (``run_ranks``), talking over
    gloo.  Held against the single rank in this process: teacher-forced
    logits, greedy tokens, the streams."""
    from repro_torch.configs import get_config
    from repro_torch.engine import DecodeEngine, EngineConfig, Scheduler
    from repro_torch.launch.mesh import run_ranks, transport

    t_phase = time.perf_counter()
    cfg = get_config("tinyllama-1.1b")
    eng = DecodeEngine(cfg, EngineConfig(batch=DIST_B, max_len=DIST_MAX,
                                         kernel_impl="cuda"),
                       device="cuda", seed=0)
    _condition(torch, eng.params)
    digest = _param_digest(torch, eng.params)
    g = torch.Generator(device="cuda").manual_seed(12)
    prompts = torch.randint(0, cfg.vocab, (DIST_B, DIST_P), generator=g,
                            device="cuda", dtype=torch.int32)
    refs = {}
    for key, (P, G) in (("long", (DIST_P, DIST_GEN)), ("short", DIST_SHORT)):
        p = prompts[:, :P]
        eng.generate({"tokens": p}, gen=2)
        toks, stats = eng.generate({"tokens": p}, gen=G)
        refs[key] = {"tokens": toks.cpu(),
                     "logits": _forced(torch, eng, p, toks, P, G),
                     "decode_tok_s": stats["decode_tok_s"]}
    # a sampled generate: a mesh that splits the batch draws the same
    P, G = DIST_SHORT
    sampled = eng.generate({"tokens": prompts[:, :P]}, gen=G,
                           temperature=DIST_TEMP, seed=7)[0].cpu()
    streams = {}
    for kv in ("bf16", "int8"):
        peng = DecodeEngine(cfg, EngineConfig(
            batch=SLOTS, max_len=PROMPT[1] + DIST_REQ_GEN, paged=True,
            page_size=PAGE, n_pages=N_PAGES, kv_dtype=kv,
            kernel_impl="cuda"), params=eng.params, device="cuda")
        t0 = time.perf_counter()
        out = _drive(Scheduler(peng), _requests(
            cfg, N_REQ, PROMPT, DIST_REQ_GEN, seed=4)[:DIST_REQ])
        torch.cuda.synchronize()
        streams[kv] = [out[i].tokens.tolist() for i in range(DIST_REQ)]
        streams[kv + "_tok_s"] = sum(map(len, streams[kv])) / (
            time.perf_counter() - t0)
        del peng
    del eng
    mcfg = _dense_mla()
    B, P, G, T = MLA_GEN
    meng = DecodeEngine(mcfg, EngineConfig(batch=B, max_len=T,
                                           kernel_impl="cuda"),
                        device="cuda", seed=0)
    mp = torch.randint(0, mcfg.vocab, (B, P), generator=g, device="cuda",
                       dtype=torch.int32)
    mtoks, _ = meng.generate({"tokens": mp}, gen=G)
    mla = {"prompts": mp.cpu(), "ref": {
        "tokens": mtoks.cpu(), "logits": _forced(torch, meng, mp, mtoks, P,
                                                 G)}, "streams": {}}
    n, rng, gen, seed = MLA_REQS
    for kv in ("bf16", "int8"):
        peng = DecodeEngine(mcfg, EngineConfig(**MLA_PAGED, kv_dtype=kv,
                                               kernel_impl="cuda"),
                            params=meng.params, device="cuda")
        out = _drive(Scheduler(peng), _requests(mcfg, n, rng, gen, seed))
        mla["streams"][kv] = [out[i].tokens.tolist() for i in range(n)]
    del meng, peng
    torch.cuda.empty_cache()
    ocfg, oparams = _olmoe_tp(torch)
    odigest = _param_digest(torch, oparams)
    oeng = DecodeEngine(ocfg, EngineConfig(batch=DIST_B, max_len=DIST_MAX,
                                           kernel_impl="cuda"),
                        params=oparams, device="cuda")
    del oparams
    p = prompts[:, :DIST_P]
    oeng.generate({"tokens": p}, gen=2)
    otoks, ostats = oeng.generate({"tokens": p}, gen=DIST_GEN)
    ologits, oroutes = _forced_routes(torch, oeng, p, otoks, DIST_P,
                                      DIST_GEN)
    olmoe = {"tokens": otoks.cpu(), "logits": ologits, "routes": oroutes,
             "digest": odigest}
    single_olmoe = {"decode_tok_s": ostats["decode_tok_s"],
                    "param_bytes": _nbytes(oeng.params)}
    del oeng
    torch.cuda.empty_cache()
    t_single = time.perf_counter() - t_phase
    print(f"  the single rank: {t_single:.1f} s; transport of 2 or 4 ranks "
          f"on this card: {transport(2, 'cuda')} / {transport(4, 'cuda')}")

    single = {k: v["decode_tok_s"] for k, v in refs.items()}
    print(f"  one rank: decode tok/s {single['long']:.1f} (P{DIST_P} gen "
          f"{DIST_GEN}), {single['short']:.1f} (P{DIST_SHORT[0]} gen "
          f"{DIST_SHORT[1]}); Scheduler generated tok/s "
          f"{streams['bf16_tok_s']:.1f} (bf16), "
          f"{streams['int8_tok_s']:.1f} (int8)")
    refs = {k: {"tokens": v["tokens"], "logits": v["logits"]}
            for k, v in refs.items()}
    refs["sampled"] = sampled
    res = {"single": {"decode_tok_s": single, "stream_gen_tok_s": {
        kv: streams[kv + "_tok_s"] for kv in ("bf16", "int8")},
        "olmoe": single_olmoe}, "transport": transport(2, "cuda"),
        "meshes": {}}
    for shape in ((1, 2), (2, 1), (2, 2)):
        t0 = time.perf_counter()
        ranks = run_ranks(_dist_world, *shape, device="cuda",
                          args=(prompts.cpu(), refs, digest, streams, mla,
                                olmoe))
        name = f"({shape[0]}, {shape[1]})" + (" seq" if shape[1] > 1
                                              else "")
        res["meshes"][name] = _dist_report(name, ranks, res["single"],
                                           time.perf_counter() - t0)
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 12: {res['wall_s']:.1f} s")
    return res


def _dist_report(name, ranks, one, wall):
    """Print one mesh's results; return them without the token
    tensors."""
    single = one["decode_tok_s"]
    r0 = ranks[0]
    gen = r0["generate"]
    print(f"  {name}, {len(ranks)} ranks, {wall:.1f} s: decode tok/s "
          f"{gen['decode_tok_s']:.1f} (rank 0; one rank {single['long']:.1f})"
          f"; greedy tokens equal to one rank's {gen['equal_tokens']}/"
          f"{DIST_B * DIST_GEN}; teacher-forced max|d logits| "
          f"{max(r['generate']['max_rel_err'] for r in ranks):.3e} of "
          f"scale (limit {E2E_BF16_REL:g}); kernel 4 launches per rank "
          f"{[r['generate']['launches'] for r in ranks]}, variants "
          f"{gen['variants']}; tokens equal on every rank")
    if "short" in r0:
        s = r0["short"]
        print(f"    P{DIST_SHORT[0]} gen {DIST_SHORT[1]} (rank 1's slab "
              f"empty): decode tok/s {s['decode_tok_s']:.1f} (one rank "
              f"{single['short']:.1f}); greedy tokens equal "
              f"{s['equal_tokens']}/{DIST_B * DIST_SHORT[1]}; max|d logits| "
              f"{max(r['short']['max_rel_err'] for r in ranks):.3e}; "
              f"kernel 4 launches per rank "
              f"{[r['short']['launches'] for r in ranks]}")
        c = s["combine"]
        print(f"    the combine over that run: {c['collectives']} "
              f"collectives, {c['combine_s']:.4f} s of a "
              f"{c['t_decode_s']:.4f} s decode ({100 * c['share']:.1f}%; "
              "host clock, the device synchronized around each)")
    for key, what in (("streams", "tinyllama Scheduler"),
                      ("mla_streams", "dense+MLA fp32 Scheduler")):
        for s in r0.get(key, []):
            note = "equal to one rank's" if s["equal"] else (
                f"part in {len(s['parted'])} requests; {len(s['replayed'])}"
                f" replayed with one rank's tokens: max|d logits| "
                f"{s['replay_max_rel']:.3e} of scale over "
                f"{s['replayed_steps']} steps, its token picked at "
                f"{s['replay_picks_single_token']}")
            print(f"    {what}, {s['kv_dtype']} pools: {s['steps']} steps, "
                  f"{s['admitted']} admissions, {s['retired']} retired, "
                  f"{s['gen_tok_s']:.1f} generated tok/s; streams {note}; "
                  f"paged kernel launches per rank "
                  f"{[r[key][i]['launches'] for r in ranks for i, t in enumerate(r[key]) if t['kv_dtype'] == s['kv_dtype']]}")
    if "sampled" in r0:
        print(f"    sampled generate (temperature {DIST_TEMP:g}, P"
              f"{DIST_SHORT[0]} gen {DIST_SHORT[1]}): tokens equal to one "
              f"rank's and on every rank")
    if "mla_generate" in r0:
        m = r0["mla_generate"]
        print(f"    dense+MLA fp32 generate: greedy tokens equal "
              f"{m['equal_tokens']}, max|d logits| {m['max_rel_err']:.3e} "
              f"(limit {E2E_FP32_TOL:g}); kernel 10 launches per rank "
              f"{[r['mla_generate']['launches'] for r in ranks]}")
    for row in r0.get("ops", []):
        print(f"    {row['kernel']} sharded vs whole, {row['case']}: "
              f"max|d| {row['max_abs_err']:.3e}")
    if "tp" in r0:
        _tp_report(ranks, one)

    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k != "tokens"}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return strip(ranks)


def _tp_report(ranks, one):
    """Print phase 12's tensor-parallel results (``_tp_world``)."""
    tp = [r["tp"] for r in ranks]
    t0, g = tp[0], tp[0]["generate"]
    gb = 1e-9
    print(f"    tensor-parallel (1, {len(ranks)}), no seq: generate B{DIST_B}"
          f" P{DIST_P} gen {DIST_GEN}: decode tok/s {g['decode_tok_s']:.1f}"
          f" (one rank {one['decode_tok_s']['long']:.1f}); greedy tokens "
          f"equal {g['equal_tokens']}/{DIST_B * DIST_GEN}, "
          f"{t0['flipped_rows']} rows flipped; teacher-forced max|d logits| "
          f"{max(t['generate']['max_rel_err'] for t in tp):.3e} of scale "
          f"(limit {E2E_BF16_REL:g}); tokens equal on every rank")
    c = t0["collectives"]
    print(f"    a decode step: {c['collectives_a_step']:.1f} collectives "
          f"crossing ranks, {c['wait_ms_a_step']:.2f} ms in them of a "
          f"{c['step_ms']:.2f} ms step ({100 * c['share']:.1f}%; host "
          "clock, the device synchronized around each)")
    print(f"    parameter bytes per rank "
          f"{[round(t['param_bytes'] * gb, 3) for t in tp]} GB (whole "
          f"{t0['whole_bytes'] * gb:.3f} GB); peak memory per rank over the "
          f"generate {[round(t['peak_bytes'] * gb, 3) for t in tp]} GB")
    print(f"    launches per rank over the generate: "
          f"{[t['launches'] for t in tp]}")
    for row in t0["kernels"]:
        errs = [next(x["max_abs_err"] for x in t["kernels"]
                     if x["case"] == row["case"]) for t in tp]
        print(f"    {row['kernel']} {row['case']} at a rank's shape "
              f"{row['shape']}: max|d| vs plain per rank "
              f"{[f'{e:.3e}' for e in errs]}")
    s = t0["stream"]
    note = "equal to one rank's" if s["equal"] else (
        f"part in {len(s['parted'])} requests; replayed with one rank's "
        f"tokens: max|d logits| {s['replay_max_rel']:.3e} of scale over "
        f"{s['replayed_steps']} steps, its token picked at "
        f"{s['replay_picks_single_token']}")
    print(f"    tinyllama Scheduler, {DIST_REQ} requests, bf16 pools: "
          f"{s['steps']} steps, {s['admitted']} admissions, "
          f"{s['gen_tok_s']:.1f} generated tok/s; streams {note}; paged "
          f"kernel launches per rank {[t['stream']['launches'] for t in tp]}")
    o = t0["olmoe"]
    print(f"    olmoe-1b-7b, {TP_OLMOE_DEPTH} layers, ep='full_ep', "
          f"{o['experts_a_rank']} experts a rank: decode tok/s "
          f"{o['decode_tok_s']:.1f} (one rank "
          f"{one['olmoe']['decode_tok_s']:.1f}); greedy tokens equal "
          f"{o['equal_tokens']}/{DIST_B * DIST_GEN}; teacher-forced and "
          f"routed as one rank, max|d logits| {o['max_rel']:.3e} of scale "
          f"(limit {E2E_BF16_REL:g}); {o['expert_sets_differ']} of "
          f"{o['expert_sets']} (token, layer) expert sets would differ; "
          f"parameter bytes per rank "
          f"{[round(t['olmoe']['param_bytes'] * gb, 3) for t in tp]} GB "
          f"(one rank {one['olmoe']['param_bytes'] * gb:.3f}); launches "
          f"{o['launches']}")


# ----------------------------------------------------------------------
# phase 13: data-parallel training (ZeRO-1) over ranks on this card
# ----------------------------------------------------------------------

# (b): reduced fp32 configs, B4 S32, n_microbatches 2: each rank takes
# one row of each microbatch (rows 0, 2 on rank 0; 1, 3 on rank 1)
DP_REDUCED = ("tinyllama-1.1b", "olmoe-1b-7b")
DP_RANK1_ROWS = [1, 3]
# (c): a tinyllama-1.1b embedding's worth of fp32 gradient
DP_PSUM = (32000, 2048)
# (d): the pipeline's stages, microbatches, rows a microbatch, width
DP_PIPE = (2, 8, 16, 2048)
DP_PIPE_TOL = 1e-5
# (e): the launcher's losses against 1 1's and its resumed moments;
# the resumed step-4 loss (the same state and row blocks)
DP_LAUNCH_REL, DP_RESUME_REL = 1e-3, 1e-5


def _dp_full_width(torch, mesh):
    """(a) tinyllama-1.1b bf16 at full width, remat "full", global B4
    S1024 (phase 10's weights): rank 0 first takes the single-rank step
    (its loss and fp32 master copies kept), then every rank takes the
    (2, 1) step with ZeRO-1 off and on (peak memory, step wall, the
    gradient sync's wall and bytes), each held to the single rank's."""
    from repro_torch.common.module import leaves, map_tree
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = get_config(TRAIN_ARCH).replace(kernel_impl="torch", remat="full")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=29))
    oc = adamw.OptConfig()
    rank0 = mesh.coord("data") == 0

    def weights():
        p = lm.init(cfg, seed=29, device="cuda")
        _condition(torch, p)
        return p

    p = weights()
    digests = mesh.gather_objects(_param_digest(torch, p))
    if any(d != digests[0] for d in digests):
        raise AssertionError("(a): the ranks built different parameters")
    out = {"rank": mesh.coord("data")}
    ref = None
    if rank0:
        o = adamw.init(oc, p)
        p, o, m = steps.build_train_step(cfg, oc)(p, o, data.batch(0))
        # the single rank's master copies wait on the host
        ref = {"loss": float(m["loss"]), "lr": float(m["lr"]),
               "master": map_tree(lambda t: t.cpu(), o.master)}
        del o, m
    del p
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mesh.gather_objects(None)           # rank 0's reference is taken
    held = {}
    for zero1 in (False, True):
        key = "zero1" if zero1 else "whole"
        p = weights()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        o = adamw.init(oc, p, mesh=mesh, zero1=zero1)
        state = sum(t.numel() * t.element_size() for tree in
                    (o.m, o.v, o.master) for _, t in leaves(tree))
        step = steps.build_train_step(cfg, oc, mesh=mesh, zero1=zero1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step(p, o, data.batch(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        held[key] = _dp_hold_master(torch, mesh, oc, o, p, ref, m, zero1)
        out[key] = {
            "peak_gb": peak / 1e9, "held_before_gb": base / 1e9,
            "state_gb": state / 1e9, "step_s": wall,
            "sync_s": step.last_sync["s"],
            "sync_bytes": step.last_sync["bytes"],
            "loss": float(m["loss"]),
            "tok_s": TRAIN_BATCH * TRAIN_SEQ / wall}
        del p, o, step, m
        torch.cuda.empty_cache()
    out["held"] = held
    return out


def _dp_hold_master(torch, mesh, oc, opt, params, ref, metrics, zero1):
    """(a)'s hold: the step's loss within ``TRAIN_LOSS_REL`` of the
    single rank's, and its fp32 master copies (with ``zero1`` every
    rank's blocks, gathered leaf by leaf on each rank) by ``_hold_adam``
    against the single rank's (flipped Adam steps of near-zero gradient
    elements allowed)."""
    from repro_torch.common.module import leaves
    from repro_torch.dist import sharding as SH
    from repro_torch.optim import adamw

    specs = adamw.state_specs(oc, params, mesh, zero1).master
    what = "ZeRO-1" if zero1 else "whole-state"
    got = {}
    for path, t in leaves(opt.master):
        whole = SH.gather_block(t, adamw._at(specs, path), mesh)
        if ref is not None:
            node = got
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = whole
        else:
            del whole
    if ref is None:
        return None
    rel = abs(float(metrics["loss"]) - ref["loss"]) / abs(ref["loss"])
    held = _hold_adam(got, ref["master"], ref["lr"], TRAIN_FP32_TOL,
                      f"(a) {what} master copies")
    if rel > TRAIN_LOSS_REL:
        raise AssertionError(f"(a): the {what} (2, 1) step's loss is "
                             f"{rel:.3e} off the single rank's")
    return {"loss": float(metrics["loss"]), "single_loss": ref["loss"],
            "loss_rel": rel, **held}


def _dp_reduced(torch, mesh):
    """(b) reduced fp32 tinyllama (rank 1's rows half masked) and olmoe
    (capacity factor 4), n_microbatches 2: one (2, 1) step from the
    conditioned seed-29 weights; the losses and parameters to rank 0."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    out = {}
    for name in DP_REDUCED:
        cfg, batch = _dp_reduced_case(name)
        oc = adamw.OptConfig(lr=1e-3, warmup_steps=5, total_steps=30)
        p = lm.init(cfg, seed=29, device="cuda")
        _condition(torch, p)
        o = adamw.init(oc, p, mesh=mesh)
        p, o, m = steps.build_train_step(cfg, oc, mesh=mesh)(p, o, batch)
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "params": {k: t.cpu().numpy() for k, t in _flat(p)}}
    return out


def _flat(tree):
    from repro_torch.common.module import leaves
    return [("/".join(k), t) for k, t in leaves(tree)]


def _dp_reduced_case(name):
    """(b)'s config and global batch."""
    import dataclasses

    from repro_torch.launch import train

    cfg = _reduced(name).replace(kernel_impl="torch", n_microbatches=2)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=4.0))
    batch = train.make_batch_fn(cfg, 4, 32)(0)
    batch["loss_mask"] = batch["loss_mask"].copy()
    batch["loss_mask"][DP_RANK1_ROWS, :16] = 0.0
    return cfg, batch


def _dp_compressed(torch, mesh):
    """(c) ``compressed_psum`` of a 32000 x 2048 fp32 leaf a rank on the
    card: its error against the exact mean (an fp32 all-reduce), the
    residual, and the error-feedback contract (two steps' mean closer
    than one); the wire bytes beside the fp32 ring's."""
    from repro_torch.dist.compression import compressed_psum

    n = mesh.axis_size("data")
    g = torch.Generator(device="cuda").manual_seed(40 + mesh.coord("data"))
    x = torch.randn(DP_PSUM, generator=g, device="cuda")
    exact = mesh.all_reduce(x.clone(), "data") / n
    err = torch.zeros_like(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out1, err1 = compressed_psum(x, err, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out2, _ = compressed_psum(x, err1, mesh)
    one = float((out1 - exact).abs().max())
    two = float(((out1 + out2) / 2 - exact).abs().max())
    res = float(err1.abs().max())
    if not (one < 0.05 and res > 0 and two <= one + 1e-6):
        raise AssertionError(f"(c) compressed_psum: one step {one:.3e}, "
                             f"two {two:.3e}, residual {res:.3e}")
    return {"one_step_max_err": one, "two_step_max_err": two,
            "residual_max": res, "wall_s": wall,
            # every rank's int8 payload and fp32 scale, gathered
            "wire_bytes": n * (x.numel() + 4),
            "fp32_ring_bytes": 2 * 4 * x.numel()}


def _dp_pipeline(torch):
    """(d) ``pipeline_apply`` over a ``{"pipe": 2}`` mesh of the same
    ranks: tanh(x @ w) stages at width 2048, 8 microbatches of 16 rows,
    fp32 (TF32 off), against the sequential composition on this rank."""
    from repro_torch.dist import sharding as SH
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh

    n_stages, n_micro, mb, d = DP_PIPE
    pipe = make_mesh({"pipe": n_stages}, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(41)
    w = torch.randn((n_stages, d, d), generator=g, device="cuda") / d ** 0.5
    x = torch.randn((n_micro * mb, d), generator=g, device="cuda")
    stage = SH.local_block(w, SH.PS("pipe", None, None), pipe)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pipeline_apply(pipe, lambda wt, xb: torch.tanh(xb @ wt), stage,
                         x, n_micro=n_micro)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = x
    for s in range(n_stages):
        want = torch.tanh(want @ w[s])
    err = float((got - want).abs().max())
    if err > DP_PIPE_TOL:
        raise AssertionError(f"(d) pipeline_apply: {err:.3e} off the "
                             "sequential composition")
    return {"max_abs_err": err, "wall_s": wall,
            "ticks": n_micro + n_stages - 1}


def _dp_world(mesh):
    """Phase 13's (a)-(d) on every rank of a (2, 1) world; the results
    of every rank, gathered."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = {"full_width": _dp_full_width(torch, mesh)}
    out["full_width_s"] = time.perf_counter() - t0
    out["reduced"] = _dp_reduced(torch, mesh)
    out["compressed"] = _dp_compressed(torch, mesh)
    out["pipeline"] = _dp_pipeline(torch)
    ranks = mesh.gather_objects({k: v for k, v in out.items()
                                 if k != "reduced"})
    return {"ranks": ranks, "reduced": out["reduced"],
            "transport": mesh.transport}


def _dp_launcher(torch):
    """(e) ``launch/train.py --reduce width --data-model 2 1 --steps 5
    --ckpt`` (checkpoints at steps 4 and 5), then ``1 1`` resumed from
    that step-4 checkpoint for steps 4-5.

    The launcher's weights are its unconditioned seed-0 init, whose
    loss is so sharp (gradient norms ~1e6-1e7) that fp32 summation-order
    noise grows into losses that part by 1e-3 or more after two steps
    (``1 1`` is run twice here: the card's backward is not bitwise
    repeatable), and a step's loss barely sees a wrong m.  So the
    (2, 1) run's steps 0-1 are held against ``1 1``'s, and the restore
    across meshes is held on the state itself: ``1 1 --microbatches 2``
    (the ranks' 4-row blocks) resumed at step 4 takes the (2, 1) run's
    step-4 loss, and its step-5 checkpoint is the (2, 1) run's (m and v
    within ``DP_LAUNCH_REL`` of each leaf's norm, the parameters by
    ``_hold_adam`` at step 5's learning rate)."""
    import shutil

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.common.module import leaves
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    ck = ROOT / "build" / "train_dp_launcher"
    ck4 = ROOT / "build" / "train_dp_launcher_4"
    for d in (ck, ck4):
        shutil.rmtree(d, ignore_errors=True)
    args = ["--arch", TRAIN_ARCH, "--reduce", "width", "--batch", "8",
            "--seq", "256", "--log-every", "1"]
    parsed = train.build_parser().parse_args(args + ["--steps", "6"])
    cfg = train._config(parsed)
    oc = adamw.OptConfig(lr=parsed.lr, warmup_steps=20, total_steps=6)

    def state(d):
        p = lm.init(cfg, seed=0, device="cpu")
        tree = {"params": p, "opt": adamw.init(oc, p)}
        return CheckpointStore(str(d)).restore(5, tree)

    try:
        t0 = time.perf_counter()
        straight = train.main(args + ["--steps", "4"])
        again = train.main(args + ["--steps", "4"])
        t1 = time.perf_counter()
        dp = train.main(args + ["--steps", "5", "--ckpt", str(ck),
                                "--ckpt-every", "4", "--data-model", "2",
                                "1"])
        t2 = time.perf_counter()
        # the step-4 checkpoint alone (the run also saved step 5)
        shutil.copytree(ck / "step_4", ck4 / "step_4")
        resumed = train.main(args + ["--steps", "6", "--microbatches", "2",
                                     "--ckpt", str(ck4), "--ckpt-every",
                                     "1"])
        want, got = state(ck), state(ck4)
    finally:
        for d in (ck, ck4):
            shutil.rmtree(d, ignore_errors=True)
    if [s for s, _ in dp] != list(range(5)) or \
            [s for s, _ in resumed] != [4, 5]:
        raise AssertionError(f"(e) launcher steps {dp} {resumed}")

    def gaps(run, base):
        return [abs(a - b) / abs(b) for (_, a), (_, b) in zip(run, base)]

    moments = {}
    for name in ("m", "v"):
        w = dict(leaves(getattr(want["opt"], name)))
        moments[name] = max(
            float((t - w[k]).norm() / w[k].norm().clamp_min(1e-30))
            for k, t in leaves(getattr(got["opt"], name)))
    out = {"straight": straight, "again": again, "data_parallel": dp,
           "resumed": resumed, "gaps": gaps(dp, straight),
           "again_gaps": gaps(again, straight),
           "resumed_step4": gaps(resumed, dp[4:])[0],
           "moments_rel": moments,
           "params": _hold_adam(got["params"], want["params"],
                                float(adamw.schedule(oc, 5)),
                                TRAIN_FP32_TOL, "(e) step-5 parameters"),
           "one_rank_s": t1 - t0, "two_ranks_s": t2 - t1}
    if (max(out["gaps"][:2]) > DP_LAUNCH_REL
            or out["resumed_step4"] > DP_RESUME_REL
            or max(moments.values()) > DP_LAUNCH_REL
            or int(got["opt"].step) != 5
            or not all(math.isfinite(x) for _, x in dp + resumed)):
        raise AssertionError(f"(e) launcher off: {out}")
    return out


def serve_train_distributed(torch):
    """Phase 13: (a)-(d) in one (2, 1) world of ranks on this card
    (gloo), (b) held against the same step on one rank on the CPU here,
    then (e) the launcher."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    world = run_ranks(_dp_world, 2, 1, device="cuda")
    res = {"transport": world["transport"]}
    fw = [r["full_width"] for r in world["ranks"]]
    print(f"  (a) {TRAIN_ARCH} bf16 B{TRAIN_BATCH} S{TRAIN_SEQ}, remat full,"
          f" (2, 1) over {world['transport']}")
    for key, what in (("whole", "ZeRO-1 off"), ("zero1", "ZeRO-1 on")):
        r, held = fw[0][key], fw[0]["held"][key]
        print(f"      {what}: loss {held['loss']:.5f} vs one rank "
              f"{held['single_loss']:.5f} ({held['loss_rel']:.2e}); master "
              f"copies: {held['off']} of {held['elements']} elements off "
              f"{TRAIN_FP32_TOL:g} of scale, worst "
              f"{held['worst_over_lr']:.3f} lr")
        print(f"      {what}: peak per rank "
              f"{[round(f[key]['peak_gb'], 2) for f in fw]} GB (state "
              f"{[round(f[key]['state_gb'], 2) for f in fw]} GB); step "
              f"{r['step_s']:.3f} s, gradient sync {r['sync_s']:.3f} s, "
              f"{r['sync_bytes'] / 1e9:.3f} GB sent a rank; "
              f"{r['tok_s']:.1f} tok/s")
    res["full_width"] = fw
    res["full_width_s"] = world["ranks"][0]["full_width_s"]

    # (b) the same step on one rank on the CPU
    res["reduced"] = {}
    for name in DP_REDUCED:
        cfg, batch = _dp_reduced_case(name)
        oc = adamw.OptConfig(lr=1e-3, warmup_steps=5, total_steps=30)
        p = lm.init(cfg, seed=29, device="cuda")
        _condition(torch, p)
        p = _nest(_flat(p), "cpu")
        p, o, m = steps.build_train_step(cfg, oc)(p, adamw.init(oc, p),
                                                 batch)
        got = world["reduced"][name]
        rel = max(abs(got["metrics"][k] - float(m[k]))
                  / max(abs(float(m[k])), 1e-30)
                  for k in ("loss", "ce", "z_loss"))
        held = _hold_adam(_nest(list(got["params"].items()), "cpu"), p,
                          float(m["lr"]), TRAIN_FP32_TOL, f"(b) {name}")
        if rel > 1e-4:
            raise AssertionError(f"(b) {name}: loss {rel:.3e} off the "
                                 "CPU's one rank")
        extra = ""
        if "lb_loss" in m:
            lb = abs(got["metrics"]["lb_loss"] - float(m["lb_loss"])) \
                / float(m["lb_loss"])
            extra = f", lb_loss {lb:.2e}"
        res["reduced"][name] = {"loss_rel": rel, **held}
        print(f"  (b) {name} reduced fp32, n_microbatches 2, (2, 1) on the "
              f"card vs one rank on the CPU: loss {rel:.2e}{extra}; "
              f"{held['off']} elements off, worst "
              f"{held['worst_over_lr']:.3f} lr")
    c = world["ranks"][0]["compressed"]
    res["compressed"] = [r["compressed"] for r in world["ranks"]]
    print(f"  (c) compressed_psum {DP_PSUM[0]}x{DP_PSUM[1]} fp32: max err "
          f"{c['one_step_max_err']:.3e} (two steps "
          f"{c['two_step_max_err']:.3e}), {c['wall_s']:.3f} s; wire "
          f"{c['wire_bytes'] / 1e6:.1f} MB vs the fp32 ring's "
          f"{c['fp32_ring_bytes'] / 1e6:.1f} MB")
    d = world["ranks"][0]["pipeline"]
    res["pipeline"] = [r["pipeline"] for r in world["ranks"]]
    print(f"  (d) pipeline_apply over {{'pipe': 2}}, width {DP_PIPE[3]}, "
          f"{DP_PIPE[1]} microbatches: max|d| "
          f"{max(r['pipeline']['max_abs_err'] for r in world['ranks']):.3e}"
          f" of the sequential composition, {d['wall_s']:.3f} s")
    t_world = time.perf_counter() - t_phase
    res["launcher"] = _dp_launcher(torch)
    e = res["launcher"]
    print(f"  (e) launch/train.py --reduce width --data-model 2 1 --steps 5"
          f" --ckpt ({e['two_ranks_s']:.1f} s; 1 1 twice: "
          f"{e['one_rank_s']:.1f} s): losses off 1 1's by "
          f"{['%.1e' % x for x in e['gaps']]} (steps 0-1 held at "
          f"{DP_LAUNCH_REL:g}; 1 1 again off 1 1 by "
          f"{['%.1e' % x for x in e['again_gaps']]})")
    p = e["params"]
    print(f"      1 1 --microbatches 2 resumed from its step-4 checkpoint: "
          f"step 4's loss off by {e['resumed_step4']:.1e} (limit "
          f"{DP_RESUME_REL:g}); the step-5 state against the (2, 1) run's:"
          f" m, v {e['moments_rel']['m']:.1e}, {e['moments_rel']['v']:.1e}"
          f" of a leaf's norm (limit {DP_LAUNCH_REL:g}), parameters "
          f"{p['off']} of {p['elements']} elements off, worst "
          f"{p['worst_over_lr']:.3f} lr")
    res["world_s"] = t_world
    res["wall_s"] = time.perf_counter() - t_phase
    return res


def _nest(pairs, device):
    """A parameter tree from ("a/b/c", tensor) pairs, on ``device``."""
    out = {}
    for key, t in pairs:
        node = out
        path = key.split("/")
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _as_tensor(t, device)
    return out


def _as_tensor(t, device):
    import torch

    return torch.as_tensor(t, device=device)


@contextlib.contextmanager
def _phase(walls, name):
    """Print a phase's name, run it, print its wall on a line of its own
    and keep it in ``walls``."""
    print(f"phase {name}")
    t0 = time.perf_counter()
    yield
    walls[name] = time.perf_counter() - t0
    print(f"phase {name.split()[0]} wall: {walls[name]:.1f} s")


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    # every run tunes from an empty autotuner cache of its own
    OUT.mkdir(exist_ok=True)
    tune_cache = OUT / "autotune.json"
    tune_cache.unlink(missing_ok=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(tune_cache)
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    walls = {}
    phase = functools.partial(_phase, walls)
    with phase("1 build"):
        secs = build.timed_build(ptxas_verbose=True, log_dir=OUT)
        print(f"build: {secs:.1f} s ({', '.join(build.SOURCES)})")

    with phase("2 kernels"):
        results = check_kernels(torch, F)
        two_streams = check_two_streams(torch)

    print("end to end")
    per_step = {  # launches per layer: prefill, decode step
        "vwr_matmul": (5, 1), "vwr_swiglu": (1, 1),
        "vwr_attention": (1, 0), "vwr_flash_decode": (0, 1)}

    def expected(cfg_layers, gen):
        return {k: cfg_layers * (p + d * (gen - 1))
                for k, (p, d) in per_step.items()}

    def variants(cfg_layers, gen):
        """The prefill's 5 products a layer (M = batch x prompt) take
        wgmma tiles, each decode step's down projection (M = batch, 4)
        the split-K variant; swiglu takes wgmma tiles at both; every
        decode step's attention the split variant of kernel 4 (bf16)."""
        return {"vwr_matmul.wgmma": 5 * cfg_layers,
                "vwr_matmul.splitk": cfg_layers * (gen - 1),
                "vwr_matmul.gemm": 0,
                "vwr_swiglu.wgmma": cfg_layers * gen,
                "vwr_swiglu.gemm": 0,
                "vwr_flash_decode.split": cfg_layers * (gen - 1),
                "vwr_flash_decode.fma": 0}

    with phase("3 tinyllama-1.1b generate"):
        fp32 = {n: serve_reduced_fp32(torch, n)
                for n in ("tinyllama-1.1b", "qwen1.5-0.5b")}
        tiny = serve(torch, "tinyllama-1.1b", 32, expected(22, 32),
                     variants(22, 32), kernel9=True)
    with phase("4 qwen1.5-0.5b generate"):
        qwen = serve(torch, "qwen1.5-0.5b", 8, expected(24, 8),
                     variants(24, 8))

    with phase("5 continuous batching"):
        sched_fp32 = {n: scheduler_reduced_fp32(torch, n)
                      for n in ("tinyllama-1.1b", "qwen1.5-0.5b")}
        sched_bf16, params = serve_scheduler(torch, "bf16")
        sched_int8, _ = serve_scheduler(torch, "int8", params=params)

    with phase("6 prefix cache and chunked prefill"):
        pc_fp32 = {n: scheduler_reduced_prefix_chunked(torch, n)
                   for n in ("tinyllama-1.1b", "qwen1.5-0.5b")}
        rows = chunk_rows(torch, params)
        chunk_logits = chunked_prefill_logits(torch, params)
        pc_engines = _pc_engines(torch, params)
        pc_streams = serve_prefix_chunked(torch, pc_engines)

    with phase("6b durable serving: snapshots, the request journal, "
               "recovery"):
        recovery = serve_recovery(torch, pc_engines)
        del pc_engines, params
        torch.cuda.empty_cache()

    with phase("6c the frontend families: internvl2-2b (vlm), seamless-m4t "
               "(audio)"):
        front_fp32 = {n: serve_reduced_fp32(torch, n) for n in (VLM, AUDIO)}
        front = serve_frontends(torch)

    with phase("6d the recurrent families: zamba2-1.2b (hybrid), xlstm-350m "
               "(ssm)"):
        recurrent = serve_recurrent(torch, expected, variants)

    with phase("7-8 the moe family: DeepSeek-V3 (MLA) and OLMoE (GQA), "
               "their prefix cache and chunked prefill"):
        moe_fp32 = {n: serve_reduced_fp32(torch, n)
                    for n in (DEEPSEEK, "olmoe-1b-7b")}
        moe_sched_fp32 = {n: scheduler_reduced_fp32(torch, n)
                          for n in (DEEPSEEK, "olmoe-1b-7b")}
        mla_pc_fp32 = {n: scheduler_reduced_prefix_chunked(torch, n)
                       for n in (DEEPSEEK, "olmoe-1b-7b")}
        dense_mla = _dense_mla()
        mla_pc_fp32[dense_mla.name] = scheduler_reduced_prefix_chunked(
            torch, None, cfg=dense_mla)
        deepseek = serve_deepseek(torch)
        pc = deepseek["prefix_chunked"]

    with phase("9 the paper's CNN path: provet_cnn suite on kernels 16 and "
               "17"):
        cnn = serve_cnn(torch)

    with phase("10 training: the 'torch' backend (the kernels are "
               "forward-only)"):
        training = serve_training(torch)

    with phase("11 the serving surfaces: launch/serve.py, 'auto', the "
               "autotuner"):
        surfaces = serve_surfaces(torch)

    with phase("12 distributed serving: ranks on this card, the KV cache "
               "sequence-sharded, tensor-parallel weights"):
        distributed = serve_distributed(torch)

    with phase("13 distributed training: a (2, 1) world on this card, "
               "ZeRO-1"):
        train_dist = serve_train_distributed(torch)
    launches = {**tiny["launches"],
                "vwr_paged_flash_decode":
                    sched_bf16["launches"]["vwr_paged_flash_decode"],
                "vwr_paged_flash_decode_q8":
                    sched_int8["launches"]["vwr_paged_flash_decode_q8"],
                **rows["launches"],
                "vwr_mla_flash_decode":
                    deepseek["generate"]["launches"]["vwr_mla_flash_decode"],
                "vwr_mla_paged_flash_decode": deepseek["scheduler"][0][
                    "launches"]["vwr_mla_paged_flash_decode"],
                "vwr_mla_paged_flash_decode_q8": deepseek["scheduler"][1][
                    "launches"]["vwr_mla_paged_flash_decode_q8"],
                "vwr_mla_flash_decode_q8": deepseek["kernel14"]["launches"],
                "vwr_flash_decode_q8": tiny["kernel9"]["launches"],
                "vwr_mla_chunk_prefix_attend":
                    pc[0]["chunk_prefix"]["launches"],
                "vwr_mla_chunk_prefix_attend_q8":
                    pc[1]["chunk_prefix"]["launches"],
                **cnn["launches"]}

    kernels = []
    sources = {"vwr_matmul": "vwr_matmul", "vwr_swiglu": "vwr_matmul",
               "vwr_attention": "vwr_attention",
               "vwr_flash_decode": "vwr_decode",
               "vwr_paged_flash_decode": "vwr_paged_decode",
               "vwr_paged_flash_decode_q8": "vwr_paged_decode",
               "vwr_chunk_prefix_attend": "vwr_chunk_prefix",
               "vwr_chunk_prefix_attend_q8": "vwr_chunk_prefix",
               "vwr_mla_flash_decode": "vwr_mla_decode",
               "vwr_mla_paged_flash_decode": "vwr_mla_decode",
               "vwr_mla_paged_flash_decode_q8": "vwr_mla_decode",
               "vwr_mla_flash_decode_q8": "vwr_mla_decode",
               "vwr_flash_decode_q8": "vwr_decode",
               "vwr_mla_chunk_prefix_attend": "vwr_mla_decode",
               "vwr_mla_chunk_prefix_attend_q8": "vwr_mla_decode",
               "vwr_conv2d": "vwr_conv2d", "vwr_depthwise": "vwr_depthwise"}
    replaces = {
        "vwr_matmul": "src/repro/kernels/vwr_matmul.py:120",
        "vwr_swiglu": "src/repro/kernels/vwr_matmul.py:84",
        "vwr_attention": "src/repro/kernels/vwr_attention.py:81",
        "vwr_flash_decode": "src/repro/kernels/vwr_decode.py:1222",
        "vwr_paged_flash_decode": "src/repro/kernels/vwr_decode.py:327",
        "vwr_paged_flash_decode_q8": "src/repro/kernels/vwr_decode.py:542",
        "vwr_chunk_prefix_attend": "src/repro/kernels/vwr_decode.py:870",
        "vwr_chunk_prefix_attend_q8": "src/repro/kernels/vwr_decode.py:967",
        "vwr_mla_flash_decode": "src/repro/kernels/vwr_decode.py:164",
        "vwr_mla_paged_flash_decode": "src/repro/kernels/vwr_decode.py:265",
        "vwr_mla_paged_flash_decode_q8":
            "src/repro/kernels/vwr_decode.py:747",
        "vwr_mla_flash_decode_q8": "src/repro/kernels/vwr_decode.py:649",
        "vwr_flash_decode_q8": "src/repro/kernels/vwr_decode.py:451",
        "vwr_mla_chunk_prefix_attend":
            "src/repro/kernels/vwr_decode.py:1064",
        "vwr_mla_chunk_prefix_attend_q8":
            "src/repro/kernels/vwr_decode.py:1162",
        "vwr_conv2d": "src/repro/kernels/vwr_conv2d.py:57",
        "vwr_depthwise": "src/repro/kernels/vwr_depthwise.py:35"}
    for name in sources:
        head = next(r for r in results if r["kernel"] == name
                    and r["headline"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources[name]}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"]})
    detail = {"card": card, "torch": torch.__version__,
              "build_s": secs, "kernel_cases": results,
              "two_streams": two_streams,
              "reduced_fp32_max_abs": fp32, "serve": [tiny, qwen],
              "scheduler": [sched_bf16, sched_int8],
              "scheduler_reduced_fp32": sched_fp32,
              "prefix_chunked_reduced_fp32": pc_fp32,
              "chunk_rows": rows, "chunked_prefill_logits": chunk_logits,
              "prefix_chunked": pc_streams,
              "recovery": {"tinyllama-1.1b": recovery,
                           DEEPSEEK: deepseek["recovery"],
                           AUDIO: front[AUDIO]["recovery"]},
              "frontend_reduced_fp32_max_abs": front_fp32,
              "frontends": front, "recurrent": recurrent,
              "moe_reduced_fp32_max_abs": moe_fp32,
              "moe_scheduler_reduced_fp32": moe_sched_fp32,
              "mla_moe_prefix_chunked_reduced_fp32": mla_pc_fp32,
              "deepseek": deepseek, "cnn": cnn, "training": training,
              "surfaces": surfaces, "distributed": distributed,
              "train_distributed": train_dist, "phase_walls_s": walls,
              "wall_s": time.perf_counter() - t_start}
    (OUT / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(f"wall {detail['wall_s']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
