#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU, and the quickest proof that the port still starts there.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. device   the card (``nvidia-smi`` name and power limit), the torch and
              CUDA versions, the kernels built from ``kernels/csrc`` (one
              nvcc per source, in parallel); TF32 is switched off.
  2. kernels  each CUDA kernel against its plain PyTorch version at the
              main path's leaf shapes (2 ulp pass; bitwise is expected),
              then the time of one update of diloco_150m's whole 12-leaf
              tree: kernel, plain version, one PyTorch library call (the
              yardstick; the port never calls it) and the bound.
  3. smoke    a k=2, H=2 round of the diloco_150m smoke config on the card
              (kernels) against the same round on the CPU (plain versions):
              every state leaf within atol 1e-5, rtol 1e-4.
  4. train    the main path at full width: ``repro_torch.launch.train
              --full --arch diloco_150m --k 2 --H 4 --rounds 2 --batch 8
              --seq 1024 --eval-batch 8 --trace F``. The launch counters are
              set to 0 just before and read just after: exactly
              k·H·rounds·12 fused_adamw and rounds·12 outer_nesterov
              launches. The trace F must validate (``obs/trace.py``); its
              event count and wire bytes are printed (likewise in phases
              15, 18, 21 and 28, all run with ``--trace``).
  5. profile  inner steps of one replica at full width: the host syncs
              inside a step (``torch.cuda`` sync debug mode), then one
              step under ``torch.profiler``: device time by kernel group
              and the top kernels.
  6. flash    the four flash-attention kernels against their plain
              versions (o and lse within 2e-5, dq, dk, dv within 5e-4,
              as atol = rtol) at diloco_400m's layer shape (B 8, H = G =
              12, S 1024, d 128, causal) and at GQA, sliding-window,
              bidirectional and non-block-aligned cases at d 64 and 128,
              scores of std 8 (the forward held to its plain version run
              in float64), ranges that are multiples of none of the
              kernels' tiles (Sq 333, Sk 1000; Sq 461, Sk 777) and GQA
              with 4 query heads a kv head under a window; then each
              kernel's time at the layer shape beside its plain version,
              one PyTorch library call (the yardstick, which the port
              never calls: ``scaled_dot_product_attention``, whose device
              kernels are named from ``torch.profiler``; its backward
              against dq + dk/dv) and the bound (on the tensor cores as
              three TF32 products per f32 product, beside the f32
              CUDA-core one, ``bound_f32_ms``). Then the same four on
              bf16 operands (their own entry points and counters, all
              four kernels on the bf16 tensor cores, ``wgmma``) against
              their plain versions on the same bf16 tensors (rtol 2^-7,
              two bf16 ulps, beside the f32 atols; lse at 2e-5), a bf16
              CUDA tensor never reaching a plain version, each timed at
              the layer shape in bf16 (one call, and a burst of 20 back
              to back) beside SDPA's bf16 call and the bound on the bf16
              tensor cores, dq + dk/dv by burst beside SDPA's bf16
              backward by burst; and their path: one inner
              step and one eval forward of diloco_400m at full width with
              ``use_pallas=True, compute_dtype="bfloat16"``, the counters
              set to 0 just before and read just after (2·L
              ``fwd_lse_bf16``, L ``bwd_dq_bf16``, L ``bwd_dkv_bf16``, L
              ``fwd_bf16``, 0 for every other kernel).
  7. train_400m  slice 2's path at full width: diloco_400m with
              ``use_pallas=True`` (the flash branch), k=2, H=4, 2 rounds,
              batch 8, seq 1024, through ``core.diloco.make_round`` and
              ``make_eval`` with ``arch.loss(..., cfg=...)`` as a user
              reaches it (the trainer's ``build`` for data and configs).
              The counters are set to 0 just before and read just after:
              per replica step 2·L ``fwd_lse`` (remat runs the forward
              twice), L ``bwd_dq`` and L ``bwd_dkv``, L ``fwd`` per eval,
              and the optimizer kernels' k·H·rounds·12 and rounds·12.
  8. profile_400m  one profiled inner step of that path, as phase 5.
  9. mixed_kernels  ``fused_adamw_mixed`` and the bf16 ``fused_adamw``
              against their plain versions at each diloco_150m leaf shape,
              aligned and misaligned (bitwise expected, 2 ulp pass), and
              ``sign_prune`` against its plain version on each leaf of a
              stacked k=2 delta at frac 0.5 (output, elected sign and
              threshold of every row bit for bit); then each one's time
              for one whole-tree call (the pruning in place, as the outer
              step runs it, from fresh deltas each time) beside its plain
              version, a library call where one exists, and the bound;
              the pruning's resident-row and long-row leaves also timed
              apart, with their GB/s beside the card's memory rate.
 10. smoke_mixed  a k=2, H=2 round of the diloco_150m smoke config on the
              card against the CPU under (bf16, f32) with prune_frac 0.5
              and under (bf16, bf16), with the tolerances of
              ``tests/test_torch_mixed.py`` (``repro_torch.check``).
 11. train_mixed  slice 3's path at full width: ``repro_torch.launch.train
              --full --arch diloco_150m --param-dtype bfloat16
              --master-dtype float32 --prune-frac 0.5`` with phase 4's
              sizes. Counters set to 0 just before and read just after:
              fused_adamw_mixed k·H·rounds·12 = 192, fused_adamw (f32 and
              bf16) 0, outer_nesterov rounds·12 = 24, sign_prune rounds ·
              Σ over the leaves of its launches for (k·R, C) (1 for a row
              of at most RESIDENT_MAX_COLS, 5 for a longer one:
              diloco_150m has five short-row and seven long-row leaves,
              2·(5 + 7·5) = 80).
 12. profile_mixed  one profiled inner step under the mixed policy, as
              phase 5.
 13. train_bf16  the pure (bf16, bf16) policy, and ``--pretrain-steps``
              under both bf16 policies, at full width through the
              trainer: diloco_150m with 2 pretraining steps, then one
              k=2, H=2 round (the mixed run with ``--prune-frac 0.5``);
              counters set to 0 just before and read just after each run:
              (2 + k·H)·12 = 72 launches of the policy's AdamW kernel,
              12 outer_nesterov, one round's sign_prune (40) or 0.
 14. quant_kernels  ``fake_quant`` (int4 and bf16) against its plain
              version, bit for bit (NaN at the same places), at every
              diloco_150m leaf shape stacked k=2, at misaligned and
              ragged shapes and on blocks holding NaN, ±inf, zeros and
              −0.0; then the time of one call over the whole stacked tree
              (434 M float32) beside the plain version, the bf16
              yardstick (``x.to(bfloat16).to(float32)``, two library
              calls; none computes the int4 round trip) and the bound.
 15. train_stream  slice 4's path at full width through the trainer:
              ``--stream-fragments 4 --stream-tau 2 --stream-alpha 0.5
              --outer-grad-dtype int4 --error-feedback`` with phase 4's
              sizes; then one bf16-transport round (P=2, τ=0) through
              ``make_round``. Counters set to 0 just before and read just
              after each: launches computed from ``fragments.schedule``
              and the partition (one ``fake_quant`` per leaf a fragment
              touches at each send; one ``outer_nesterov`` per such leaf
              at each apply after the fragment's first send; int4 run:
              78, 57, and 192 ``fused_adamw``), every other counter 0.
              Then one round of the trainer's streaming config through
              ``make_round`` under the profiler (after a round that arms
              every fragment): the device's busy share across a round
              whose inner segments and events each end in a host sync.
 16. smoke_stream  a k=2 streaming round of the smoke config (P=2, τ=1,
              α=0.5, int4 with error feedback) on the card against the
              CPU, with the tolerance of ``repro_torch.check`` (the flip
              share, and each entry outside within the code steps of
              the CPU's sends); both runs' sends are recorded, and an
              entry whose differing codes were all straddles (the two
              pre-rounding values on either side of one boundary, within
              the float32 bound) is counted apart (printed).

 17. wire_kernels  ``quantize_pack_int4`` and ``unpack_dequantize_int4``
              (the packed int4 wire's sender and receiver) against their
              plain versions, the wire byte for byte and the local values
              and decode bit for bit (NaN at the same places), over
              diloco_150m's whole flat tree (N = 217,012,096), at ragged
              lengths (n ≡ 1, 2, 3 mod 4, n < 128, misaligned inputs) and
              on blocks holding NaN, ±inf, zeros and −0.0; then each one's
              time for one whole-tree call (the sender with and without
              the local values) beside its plain version and the bound.
 18. train_async  slice 5's path at full width through the trainer:
              ``--transport async --speeds 1,2 --staleness-lambda 0.7
              --outer-grad-dtype int4 --error-feedback`` with phase 4's
              sizes (4 ticks: worker 0 arrives at ticks 1-4, worker 1 at
              2 and 4, stale by 0, 0, 2, 1, 0, 2); its trace's transfer
              spans match the engine's events exactly once. Counters set to 0 just
              before and read just after: one ``quantize_pack_int4`` and
              one ``unpack_dequantize_int4`` per arrival (6 and 6), 72
              ``outer_nesterov``, 288 ``fused_adamw``, every other
              counter 0. Prints, over the phases after the first (which
              pays the card's warm-up): tokens/s with and without the
              per-step token sampling, ms per inner step (sampling
              excluded, as phase 4's) and per application (no eval);
              each arrival's staleness, peak memory and the wire bytes
              per application.
 19. smoke_async  an async run of a tiny config whose leaves straddle
              int4 blocks (scenario B of ``tests/test_torch_async*.py``:
              drops with a retry, a preemption and a rejoin), int4 with
              error feedback and bf16, on the card against the CPU, with
              the tolerance of ``repro_torch.check`` (straddles counted
              apart, as in phase 16).

 20. codec_kernels  ``unpack_dequantize_reduce`` (the sharded transport's
              deferred consumer) and the unfused codec pieces
              ``quantize_int4``, ``dequantize_int4``, ``pack_int4`` and
              ``unpack_int4`` against their plain versions, bit for bit
              (NaN at the same places): over diloco_150m's whole flat tree
              (k=2 gathered wires for the reduce, read in place from a
              column slice of a wider buffer), at ragged lengths, k ∈
              {2, 4}, misaligned operands and on blocks holding NaN,
              ±inf, zeros and −0.0, and a NaN scale on a masked-out
              replica; then each one's time for one whole-tree call
              beside its plain version and the bound. No entry point runs
              the four unfused pieces (only JAX tests call them): their
              launches are counted over one call of each through its
              user-facing function, counters set to 0 just before.
 21. train_sharded  slice 6's path at full width through the trainer:
              ``--transport sharded --pods 2`` with phase 15's flags and
              sizes (two pod ranks, one replica each, on the one card over
              gloo, each collective's buffer staged through pinned host
              memory), then float32 rounds (P=2, τ=0: the all-reduce).
              The ranks' counters start at 0 and are read at their end:
              per rank one ``quantize_pack_int4`` per region per send, one
              ``unpack_dequantize_reduce`` per region per deferred apply,
              phase 15's ``outer_nesterov`` and ``fused_adamw`` counts
              over k=1, every other counter 0. The bytes each rank hands
              to ``torch.distributed`` for the outer gradients must equal
              ``sync_plan``'s packed accounting exactly, one gather per
              fragment per sync. Prints the backend, ms per inner step per
              rank and in aggregate, tokens/s, the outer ms per round with
              the wait on the deferred gathers apart, and each rank's peak
              memory. The int4 run's trace carries the issue→consume
              offsets measured on rank 0's deferred gathers: ``ok``, every
              one τ=2 inner steps or more.
 22. smoke_sharded  two sharded rounds of the smoke config (P=2, τ=1,
              α=0.5, int4 with error feedback, the packed wire) on two
              ranks on the card against two gloo ranks on the CPU, with
              the flip share of ``repro_torch.check``.

 23. resume   slice 10's path (``core.diloco.make_run`` in chunks, the
              resilience hooks at their boundaries) on diloco_60m at smoke
              width (full width, d_model 896 and batch 8 × seq 1024,
              before the xLSTM island phase needed the time; k=2, H=4, 4
              rounds, batch 2, seq 32): an uncut run with
              ``--rounds-per-call 2 --checkpoint-dir D --checkpoint-every
              2 --retain 2`` (the snapshots after rounds 2 and 4), the
              same run resumed with ``--resume 2``, and the
              per-round loop (``--legacy-loop``) with no snapshots: the
              three ``--state-hash-out`` digests must be equal (else the
              leaves that differ are named). Prints the snapshot's bytes,
              ms to save (with its device-to-host copy), to verify and to
              load, and the disk left; D is deleted at the end.
 24. guard    diloco_60m at smoke width (full width before the
              hybrid island phase needed the time), 3 rounds (4 before
              the island phase), ``--nan-bomb 1:1 --guard --checkpoint-dir
              D --checkpoint-every 1``: exactly one
              anomaly and one rollback (round index 1), the replay with the
              in-graph guard armed (``guard_rejected`` 1 on the bombed
              round, 0 after), finite losses, and the same guard events as
              a CPU run of the same flags at smoke width.
 25. milestone  diloco_60m at smoke width (full width before the xLSTM
              island phase needed the time), k=2, H=8, 8 rounds,
              ``--warmup 20 --rounds-per-call 4 --eval-every 2`` (128
              replica-steps): every round's inner and val loss beside the
              entropy floor, the last val loss below the first; then ten
              rounds of its smoke config through one ``make_run`` call on
              the card and on the CPU, on the same Markov tokens: every
              round's inner and val loss within ``MILESTONE_CARD_TOL``.
              Every trainer run of phases 23-25 asserts the launches of
              every kernel (k·H·rounds·12 ``fused_adamw``, rounds·12
              ``outer_nesterov``, the guard's replayed round counted).

 26. resume_sharded  slice 11's sharded snapshots at smoke width (full
              width before the hybrid island phase needed the time):
              diloco_60m, k=2, ``--transport sharded --pods 2`` with phase
              15's streaming flags, H=4, 3 rounds (4 before the island
              phase needed the time), ``--rounds-per-call 2``: the uncut
              run with ``--state-hash-out`` and one snapshot, at its end
              (``--checkpoint-every 3``); the same run with
              ``--checkpoint-every 2 --retain 1 --crash-at-round 2`` in a
              trainer subprocess (started before phase 23, so
              that its own Markov tables and rounds overlap phases 23-25),
              which must die by SIGKILL with no rank process left; then
              ``--resume auto`` of its snapshot (writing none of its own:
              phase 23's resumed run neither), whose ``state_sha256``
              must equal the uncut run's (else the leaves that differ are
              named). Each rank's launches asserted (the resumed run's
              fragments all armed). Prints the snapshot's bytes and the ms
              to gather it onto rank 0, save, verify, load and band it.
 27. elastic_sharded  smoke width, k=4, int4 with error feedback, P=2,
              τ=1: a ``--pods 2`` run with a snapshot every 2 rounds, and
              ``--resume 2 --pods 4`` (four gloo ranks on the card), whose
              final state must equal the uncut run's bit for bit (the CPU
              tests find pods 2 and 4 bit-identical); the round-2 snapshot
              banded over four ranks and gathered again with no round must
              equal the file bit for bit; then the sharded guard rollback
              (``--inner-lr 1e30``: round 2's loss is NaN, two rollbacks)
              on the card and on CPU ranks: the same guard events.
 28. train_gossip  the gossip transport at full width through the
              trainer: diloco_150m, k=2, H=4, 2 rounds, batch 8, seq 1024,
              ``--transport gossip --gossip-pairing butterfly --gossip-mix
              0.5 --stream-fragments 2 --outer-grad-dtype bfloat16``:
              exactly k·H·rounds·12 ``fused_adamw``, 12 ``outer_nesterov``
              (on the stacked k leaves) and 12 ``fake_quant`` bf16 a round,
              0 for every other counter; prints tokens/s, ms per inner
              step, the outer ms per round and ``gossip_spread``. Then
              three k=4 smoke-width rounds (random pairing, drops at 0.3)
              on the card against the CPU within ``check.py``'s bf16
              exchange tolerance, with the same edges.

 29. serve_400m  slice 12's serving path at full width: diloco_400m
              (551,327,232 seeded random f32 parameters) written by
              ``checkpoint.save_packed`` in 4 fragments (exactly one
              ``quantize_pack_int4`` per region, 39); 32 requests (prompt
              lengths 64-1024 drawn from the seed, 128 new tokens each)
              through a paged ``ContinuousBatcher`` (16 slots, page 16,
              cache 1152) on the packed int4 weights, counters set to 0
              just before and read just after: exactly 39 ×
              (decode ticks + prefills) ``unpack_dequantize_int4``, every
              other counter 0; the same requests through the contiguous
              engine on the decoded weights: the tokens bit for bit the
              paged run's. Two requests against themselves decoded alone
              (teacher-forced): logits within ``check.SERVE_LOGIT_RTOL``
              of the largest, tokens the argmax but near ties (counted).
              Prints prefill ms per request, ms per decode tick, decode
              tokens/s, peak memory, and the prefill logits of f32 against
              packed weights beside JAX's empirical bound.
 30. serve_smoke  the serve path at smoke width (diloco_150m's smoke
              config, window 0 and 32) on the card against the CPU: the
              paged engine on packed weights, each request's tokens and
              logits within ``check.SERVE_LOGIT_RTOL``; a static greedy
              batch, teacher-forced logits card against CPU.

 31. families_smoke  the ten other configs (dense variants, olmoe,
              deepseek, zamba2, xlstm, llama-vision, whisper) at smoke
              width, card against CPU, every all-zero leaf perturbed: the
              forward's loss and aux, the gradients, prefill + 3 decode
              steps' logits; paged = contiguous through the engine, bit
              for bit (the eight it serves); one k=2, H=2 ``make_round``
              (the eight the trainer takes), every state leaf at phase 3's
              tolerance; xLSTM's smoke train step (loss and gradients)
              timed on the card.
 32. train_zamba2  zamba2 at full width cut to 12 of its 54 layers
              (721,188,160 parameters, 74 leaves), as phase 7 builds
              diloco_400m: the trainer's ``build`` on ``--full --arch
              zamba2_2_7b --k 2 --H 2 --rounds 2 --batch 8 --seq 1024``,
              ``make_round`` and ``make_eval`` on phase 4's tables. Exactly
              2·2·2·74 = 592 ``fused_adamw`` and 2·74 = 148
              ``outer_nesterov``; tokens/s, ms per inner step, peak memory,
              the losses.
 33. serve_families  olmoe_1b_7b at full size (6,919,100,416 seeded
              f32 parameters) written by ``save_packed`` in 4 fragments
              (one ``quantize_pack_int4`` per region), the f32 tree freed;
              16 requests (prompts 64-512 from seed 0, 64 new tokens each)
              through the paged engine on the packed weights (8 slots, page
              16): exactly regions × forwards ``unpack_dequantize_int4``;
              dropped MoE assignments counted by wrapping
              ``moe._dispatch_group`` (0 in decode ticks; prefills'
              printed); the contiguous engine on the decoded values (the
              tokens bit for bit); two requests against themselves
              teacher-forced alone (``check.serve_mismatches``). Then
              deepseek_v2_lite_16b cut to 4 of 27 layers (8 requests × 32
              tokens, 8 slots: the absorbed MLA decode at rank 512) and
              xlstm_350m (4 requests, prompts 16-64, 16 tokens), paged and
              contiguous from f32 weights. Each prints ms per decode tick,
              prefill ms per request, decode tokens/s and peak memory.
 34. dryrun   the dry run's counters against this run: ``op_cost`` of one
              diloco_150m replica step (B 8, S 1024, remat off) on meta
              tensors within 0.1 % of phase 4's FLOP count (remat on
              printed); a ``CountingGroup``'s traffic over phase 21's int4
              round (rank 0 of 2, on meta) equal to each rank's measured
              ``PodGroup.traffic``; the step's peak memory estimate (its
              arguments plus the meta run's peak of live storage) within
              25 % of ``max_memory_allocated`` over a real step on the card.
              Phases 4 and 7 also print the dry run's 6·N model FLOPs per
              token beside their own count.
 35. island   FSDP×TP within an island: one inner train step of
              diloco_150m at full width (B 8, S 1024, f32 params and
              compute through the step's bf16 weight cast) on a (data 1,
              model 2) mesh, two ranks sharing the card (gloo, every
              collective staged through the host), the dry run's sharded
              step (``launch/island.py``) from m = 0 and seeded second
              moments (``island.second_moments``: the update is then
              smooth in the gradient), held to the unsharded step of the
              same params, state and batch on the card: the loss and
              every param after it within atol 1e-5, rtol 1e-4, AdamW's
              first moments leaf by leaf within 2⁻⁷ (a bf16 ulp) of the
              leaf's largest; each rank's collectives,
              as the step issues them, equal to the dry run's count for
              that mesh and step (``dryrun.island_step_cost``, on meta
              tensors); each rank's peak over the step within phase 34's
              25 % of the count's per-chip estimate (the gap printed).
              Then the same for the MoE/MLA family at full width, depth
              cut (``reduced``): olmoe_1b_7b at 2 of its 16 layers and
              deepseek_v2_lite_16b at 1 of its 27 (each rank's own
              unsharded check fits the card beside the other rank's),
              the tokens grouped by the data axis, and the (token, k)
              router choices that differ from the unsharded step's
              printed. Then the hybrid family: zamba2_2_7b at full width,
              12 of its 54 layers (two invocations of the tied SHARED
              block; each rank runs its own Mamba2 heads). Then the xLSTM
              family: xlstm_350m at full width (d_model 1024, 4 heads of
              256, vocab 50304), 4 of its 24 layers (one group: three
              mLSTM blocks and an sLSTM block) and S 256 (both cuts in
              ``reduced``): each rank its own block of the inner width,
              two whole heads, the cells' loop on plain tensors; an
              input-gate bias's first moments, which the loss does not
              depend on (``xlstm.shift_free``), held to the tree's
              largest.

``python3 chip_smoke.py --cards 4`` runs only phases 22 and 21 across
four cards: one pod rank and one replica per card, over NCCL; then phase
35 on a (data 2, model 2) mesh of the four cards over NCCL at
diloco_400m.

The Markov tables are built once per (vocab, k, regime, seed, weighting)
and handed to every trainer run (``train.run(..., sampler=...)``): the
trainer phases' ``data_setup_s`` is then the handing over, and the one
build's seconds are printed on a ``data`` line. Every trainer run asserts
the launches of every kernel (twenty-two counters, the four bf16 flash
kernels' among them), 0 for those its path does not run. Then the
``{"kernels": [...]}`` line (each kernel's launches from its own path's
run: phase 4 for the f32 optimizer kernels, phase 7 for attention, phase
6's bf16 path for the bf16 attention kernels, phase 11 for the mixed
AdamW and the pruning,
phase 13's pure-policy run for the bf16 ``fused_adamw``, phase 15's runs
for ``fake_quant``, phase 18 for the wire codecs, phase 21 for the
reduce, phase 20's calls for the unfused pieces; the two wire codecs also
carry ``serve_launches``, phase 29's, and ``olmoe_serve_launches``, phase
33's), the card's line again, and the last
line ``{"ok": true, "device":
{...}}``. Without a GPU, or run from a directory that holds nothing else
of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the card's peaks and each kernel's operations per element: the port's own
from repro_torch.launch import comm_analysis as CA   # noqa: E402
from repro_torch.launch.op_cost import LEAF_FLOPS     # noqa: E402

K, H, ROUNDS, BATCH, SEQ = 2, 4, 2, 8, 1024
N_LEAVES = 12
FWD_TOL, BWD_TOL = 2e-5, 5e-4     # the JAX package's kernel tolerances
# B, H, G, S, d, causal, window: the 400m layer, then GQA, window,
# bidirectional and non-block-aligned cases at d 64 and 128; then, with S =
# (Sq, Sk) and q, k scaled by a last element amp, the kernels' hard cases:
# scores of std 8 (amp = 8 ** 0.5); ranges that are multiples of none of
# the tiles (128 query and 32 key rows in the forward and dq, 64 key and
# 32 query rows in dk/dv) with Sq != Sk, causal (the queries start at Sk -
# Sq) and bidirectional; GQA with 4 query heads a kv head at d 128 under a
# window that crosses the tile edges
FLASH_LAYER = (BATCH, 12, 12, SEQ, 128, True, 0)
FLASH_CASES = [FLASH_LAYER] + [
    (b, h, g, s, d, c, w) for d in (64, 128)
    for b, h, g, s, c, w in ((2, 8, 2, 512, True, 0),
                             (1, 4, 4, 640, True, 256),
                             (2, 4, 2, 384, False, 0),
                             (2, 4, 2, 1000, True, 0))] + [
    (2, 4, 2, 512, 128, True, 0, 8 ** 0.5),
    (2, 4, 2, (333, 1000), 128, True, 0),
    (1, 4, 2, (461, 777), 64, False, 0),
    (2, 8, 2, 700, 128, True, 200)]
# H100 device-memory rates (NVIDIA data sheets), bytes/s, by card name; the
# SXM part's rate and peaks are the port's (launch/comm_analysis.py)
BANDWIDTH = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", CA.HBM_BW))
PEAK_F32 = CA.PEAK_F32      # f32 FLOP/s outside the tensor cores, H100 SXM
PEAK_TF32 = CA.PEAK_TF32    # dense TF32 FLOP/s of the tensor cores, H100 SXM
# each kernel's operations per element (entry, or entry and replica) are
# the dry run's (``op_cost.LEAF_FLOPS``, with the reasons)
ADAMW_FLOPS, NESTEROV_FLOPS = LEAF_FLOPS["fused_adamw"], \
    LEAF_FLOPS["outer_nesterov"]
ADAMW_BYTES, NESTEROV_BYTES = 28, 20     # 4 reads + 3 writes; 3 + 2
# bf16 p, g, m, v read and p, m, v written; bf16 g, m, v + f32 master read,
# f32 master + bf16 m, v, p written
BF16_ADAMW_BYTES, MIXED_ADAMW_BYTES = 14, 20
# sign_prune per element of the f32 deltas: read once, written once; its
# 60 operations at 67 TFLOP/s are below the bytes at 3.35 TB/s: the bound
# is bytes.
PRUNE_BYTES, PRUNE_OPS = 8, LEAF_FLOPS["sign_prune"]
PRUNE_FRAC = 0.5
# fake_quant per element: read once, written once
QUANT_BYTES = 8
QUANT_OPS = {"int4": LEAF_FLOPS["fake_quant_int4"],
             "bfloat16": LEAF_FLOPS["fake_quant_bf16"]}
# the packed int4 wire's sender and receiver
PACK_OPS, UNPACK_OPS = LEAF_FLOPS["quantize_pack_int4"], \
    LEAF_FLOPS["unpack_dequantize_int4"]
N_150M = 217_012_096        # entries of diloco_150m's flat tree
# the reduce per entry and replica; the unfused codecs per entry or code
REDUCE_OPS, QUANT_INT4_OPS, DEQUANT_OPS = (
    LEAF_FLOPS[n] for n in ("unpack_dequantize_reduce", "quantize_int4",
                            "dequantize_int4"))
PACK_CODE_OPS, UNPACK_CODE_OPS = LEAF_FLOPS["pack_int4"], \
    LEAF_FLOPS["unpack_int4"]
QUANT_KERNELS = ("quantize_pack_int4", "unpack_dequantize_int4",
                 "unpack_dequantize_reduce", "quantize_int4",
                 "dequantize_int4", "pack_int4", "unpack_int4")
_SAMPLERS: dict = {}        # (vocab, k, regime, seed, weighted) -> tables
ASYNC_FLAGS = ["--transport", "async", "--speeds", "1,2",
               "--staleness-lambda", "0.7", "--outer-grad-dtype", "int4",
               "--error-feedback"]
STREAM_FLAGS = ["--stream-fragments", "4", "--stream-tau", "2",
                "--stream-alpha", "0.5", "--outer-grad-dtype", "int4",
                "--error-feedback"]
# device kernels of the profiled inner step, grouped by a name substring
PROFILE_GROUPS = (("flash", "flash_"), ("fused_adamw", "adamw_kernel"),
                  ("fake_quant", "fake_quant_"),
                  ("wire_codecs", "_int4_kernel"),
                  ("outer_nesterov", "nesterov_kernel"), ("matmul", "gemm"),
                  ("softmax", "softmax"), ("reduction", "reduce"),
                  ("elementwise", "elementwise"),
                  ("elementwise", "vectorized"), ("copy", "copy"),
                  ("index", "index"))


T0 = time.perf_counter()


def say(obj):
    """One JSON line; a phase's is stamped with the seconds since the
    script started (``elapsed_s``: where the script's time goes)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def bandwidth(name: str) -> float:
    for key, rate in BANDWIDTH:
        if key in name:
            return rate
    raise SystemExit(f"no memory rate known for {name!r}")


def time_ms(torch, fn, reps=20, warmup=3, setup=None) -> float:
    """Median ms of ``fn`` over ``reps`` runs, each between CUDA events;
    ``setup`` (untimed) runs before each."""
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


BURST = 20       # back-to-back calls in a burst timing (``burst_ms``)


def burst_ms(torch, fn, n=BURST, warmup=3) -> float:
    """Mean ms of ``fn`` over ``n`` calls back to back between two CUDA
    events: the device's time, the host's gaps before the launches hidden
    behind the calls in flight."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def reset_launches():
    """Every launch counter of the port's kernel wrappers to 0."""
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import fused_adamw as FA
    from repro_torch.kernels import outer_nesterov as ON
    from repro_torch.kernels import quantize as QZ
    from repro_torch.kernels import sign_prune as SP
    for counts in (FK.launches, FA.launches, QZ.launches):
        counts.update(dict.fromkeys(counts, 0))
    ON.launches = SP.launches = 0


def flat_launches(counts) -> dict:
    """``ops.launch_counts()`` (of this process or of a pod rank) as
    {kernel name, as in the kernels line: launches}."""
    q = counts["quantize"]
    return {**{f"flash_{n}": c
               for n, c in counts["flash_attention"].items()},
            **counts["fused_adamw"],
            "outer_nesterov": counts["outer_nesterov"],
            "sign_prune": counts["sign_prune"],
            "fake_quant_int4": q["int4"], "fake_quant_bf16": q["bfloat16"],
            **{n: q[n] for n in QUANT_KERNELS}}


def read_launches() -> dict:
    """{kernel name, as in the kernels line: launches since the last
    ``reset_launches``} of this process."""
    from repro_torch.kernels import ops
    return flat_launches(ops.launch_counts())


def shared_sampler(torch, dev, args):
    """The Markov tables of ``args`` on ``dev``, built at their first use
    and handed to every later run with the same (vocab, k, regime, seed,
    weighting)."""
    from repro_torch.launch import train
    from repro_torch.models.registry import get_arch, get_smoke_arch
    vocab = (get_smoke_arch if args.smoke else get_arch)(
        args.arch).cfg.vocab_size
    key = (vocab, args.k, args.regime, args.seed, args.weighted)
    if key not in _SAMPLERS:
        t0 = time.perf_counter()
        _SAMPLERS[key] = train.build(args, dev)[4]
        torch.cuda.synchronize()
        say({"phase": "data", "vocab": vocab, "k": args.k,
             "regime": args.regime, "seed": args.seed,
             "build_s": time.perf_counter() - t0})
    return _SAMPLERS[key]


def expect_launches(**counts) -> dict:
    """``counts``, and 0 for every other kernel."""
    return {**dict.fromkeys(read_launches(), 0), **counts}


def ulps(torch, a, b) -> int:
    """Largest distance of ``a`` from ``b`` in units in the last place of
    their dtype (float32 or bfloat16), over values of one sign."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    d = a.view(view).to(torch.int64) - b.view(view).to(torch.int64)
    return int(d.abs().max()) if a.numel() else 0


def run_trainer(torch, dev, argv, manifest=None):
    """One run of ``repro_torch.launch.train`` with ``argv`` on the shared
    Markov tables, the launch counters set to 0 just before it and read
    just after (a sharded run's pod ranks start at 0 and report theirs:
    they are added). Returns (round records, the recorder's timing, wall
    s, {kernel: launches}); ``manifest`` (a dict) receives the recorder's
    manifest."""
    from repro_torch.launch import train
    from repro_torch.obs.metrics import RunRecorder

    args = train.make_parser().parse_args(argv)
    assert args.device == "cuda" and args.kernel_mode == "auto"
    sampler = shared_sampler(torch, dev, args)
    rec = RunRecorder(log_format="text")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    records = train.run(args, recorder=rec, sampler=sampler)
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    for r in rec.manifest.get("ranks", ()):
        for n, c in flat_launches(r["launches"]).items():
            launches[n] += c
    torch.cuda.synchronize()
    if manifest is not None:
        manifest.update(rec.manifest)
    return records, rec.manifest["timing"], wall_s, launches


def prune_launches_per_round(torch, k):
    """``sign_prune`` launches of one outer step of diloco_150m with k
    replicas: Σ over the leaves of the launches for its (k·R, C) matrix."""
    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.kernels import sign_prune as SP
    from repro_torch.models.registry import get_arch

    return sum(SP.launches_for(*ops.as_rows(
        torch.empty((k,) + tuple(t.shape), device="meta"), 1).shape)
        for t in tree.leaves(get_arch("diloco_150m").init(
            generator=None, device="meta")))


def check_records(records, label, frac, n_pretrain=0, rounds=ROUNDS):
    """Finite losses for every pretraining step and round, the rounds'
    pruned densities in (0, frac]. Returns (losses, densities)."""
    pre = [r for r in records if r["phase"] == "pretrain"]
    rnds = [r for r in records if r["phase"] == "diloco"]
    losses = [(r["inner_loss"], r["val_loss"]) for r in pre + rnds]
    if len(pre) != n_pretrain or len(rnds) != rounds or not all(
            math.isfinite(x) for pair in losses for x in pair):
        raise SystemExit(f"{label}: bad records: {losses}")
    density = [r["prune_density"] for r in rnds if frac > 0]
    if not all(0.0 < d <= frac for d in density):
        raise SystemExit(f"{label}: pruned density {density} outside "
                         f"(0, {frac}]")
    return losses, density


TRACE_DIR = ROOT / "build" / "chip_smoke_traces"


def trace_flag(label: str) -> list:
    """``--trace`` into this run's file under build/."""
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    return ["--trace", str(TRACE_DIR / f"{label}.json")]


def check_trace(label: str, records=None, tau=None) -> dict:
    """The trace ``--trace`` wrote for ``label``: it must validate; with
    ``records`` (an async run's) every transfer span must match its event
    exactly once; with ``tau`` the issue→consume overlap measured on the
    sharded run's deferred gathers must hold (``ok``, every deferred wire
    at least tau inner steps). Returns its event count and wire bytes."""
    from repro_torch.obs import trace as obs_trace
    path = TRACE_DIR / f"{label}.json"
    t = json.loads(path.read_text())
    errors = obs_trace.validate_trace(t)
    if records is not None:
        errors += obs_trace.span_event_correspondence(
            t, [r for r in records if r["kind"] == "event"])
    out = {"events": len(t["traceEvents"]),
           "spans": sum(e["ph"] == "X" for e in t["traceEvents"]),
           "wire_bytes": obs_trace.trace_wire_bytes(t)}
    if tau is not None:
        ov = t["otherData"].get("overlap", {})
        out["overlap"] = {kk: ov.get(kk) for kk in (
            "n_collectives", "n_deferred", "min_steps_between",
            "min_dots_between", "tau", "ok")}
        if not (ov.get("ok") and ov.get("tau") == tau
                and ov["min_steps_between"] >= tau):
            errors.append(f"measured overlap {out['overlap']}")
    if errors:
        raise SystemExit(f"{label}: trace {path}: {errors[:5]}")
    path.unlink()
    return out


# ---------------------------------------------------------------------------

def phase_device(torch):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    for name, log in build.build_log.items():
        print(f"[ptxas {name}] {log['ptxas']}", flush=True)
    say({"phase": "device", "card": card_line(),
         "kind": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count(), "torch": torch.__version__,
         "cuda": torch.version.cuda, "build_s": build_s,
         "built": sorted(built), "tf32": False})


def phase_kernels(torch, dev):
    """Each kernel against its plain version at the main path's leaf
    shapes, then the whole-tree timings. Returns the kernels' rows."""
    from repro_torch import tree
    from repro_torch.kernels import fused_adamw as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import outer_nesterov as ON
    from repro_torch.kernels import ref
    from repro_torch.models.registry import get_arch

    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda shape: torch.randn(shape, generator=gen, device=dev)
    hp = dict(lr=3e-4, c1=0.19, c2=0.0975, b1=0.9, b2=0.95, eps=1e-8,
              weight_decay=0.1)
    err = {"fused_adamw": [0.0, 0], "outer_nesterov": [0.0, 0]}
    shapes = {"stack0.mlp.w_up": (12, 896, 3584),
              "embed.table": (32000, 896), "ln_f.scale": (896,),
              "ragged": (1_000_003,)}
    for leaf, shape in shapes.items():
        for offset in (0, 1):      # 1: unaligned pointers, scalar path
            n = math.prod(shape)
            p, g, m, v = (rnd(n + offset)[offset:].view(shape)
                          for _ in range(4))
            v = v.abs()
            pairs = {
                "fused_adamw": (FA.fused_adamw(p, g, m, v, **hp),
                                ref.fused_adamw(p, g, m, v, **hp)),
                "outer_nesterov": (ON.outer_nesterov(p, g, m, lr=0.7),
                                   ref.outer_nesterov(p, g, m, lr=0.7))}
            torch.cuda.synchronize()
            for name, (got, want) in pairs.items():
                for a, b in zip(got, want):
                    e = err[name]
                    e[0] = max(e[0], float((a - b).abs().max()))
                    e[1] = max(e[1], ulps(torch, a, b))
            say({"phase": "kernels", "leaf": leaf, "shape": list(shape),
                 "offset": offset,
                 **{f"{k}_max_abs_err": v[0] for k, v in err.items()},
                 **{f"{k}_max_ulps": v[1] for k, v in err.items()}})
            del p, g, m, v, pairs
    for name, (e, u) in err.items():
        if u > 2:
            raise SystemExit(f"{name}: kernel differs from its plain version "
                             f"by {u} ulp (max abs {e})")

    # one update of the whole diloco_150m tree (12 leaves, N elements)
    shapes = [tuple(t.shape) for t in tree.leaves(
        get_arch("diloco_150m").init(generator=None, device="meta"))]
    n = sum(math.prod(s) for s in shapes)
    # trees as the port keeps them: dicts, leaves in sorted-key order
    mk = lambda: {f"{i:02d}": rnd(s) for i, s in enumerate(shapes)}
    P, G, M, V = mk(), mk(), mk(), {k: t.abs() for k, t in mk().items()}
    lP, lG, lM, lV = (list(t.values()) for t in (P, G, M, V))
    bw = bandwidth(torch.cuda.get_device_name(0))

    def bound(bytes_per, flops_per):
        by_bytes, by_ops = n * bytes_per / bw, n * flops_per / PEAK_F32
        return (max(by_bytes, by_ops) * 1e3,
                "bytes" if by_bytes >= by_ops else "operations")

    steps = [torch.full((), 5.0, device=dev) for _ in shapes]
    adamw_ms = {
        "ms": time_ms(torch, lambda: ops.adamw_update_tree(
            P, G, M, V, lr=3e-4, count=5, mode="kernel")),
        "plain_ms": time_ms(torch, lambda: [ref.fused_adamw(
            p, g, m, v, **hp) for p, g, m, v in zip(lP, lG, lM, lV)]),
        "library_ms": time_ms(torch, lambda: torch._fused_adamw_(
            lP, lG, lM, lV, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False))}
    nest_ms = {
        "ms": time_ms(torch, lambda: ops.nesterov_update_tree(
            P, G, M, lr=0.7, momentum=0.9, mode="kernel")),
        "plain_ms": time_ms(torch, lambda: [ref.outer_nesterov(
            p, g, b, lr=0.7) for p, g, b in zip(lP, lG, lM)]),
        "library_ms": time_ms(torch, lambda: torch._fused_sgd_(
            lP, lG, lM, weight_decay=0.0, momentum=0.9, lr=0.7, dampening=0.0,
            nesterov=True, maximize=False, is_first_step=False))}
    rows = []
    for name, t, bpe, fpe, src, tpu in (
            ("fused_adamw", adamw_ms, ADAMW_BYTES, ADAMW_FLOPS,
             "src/repro_torch/kernels/csrc/fused_adamw.cu",
             "src/repro/kernels/fused_adamw.py:96"),
            ("outer_nesterov", nest_ms, NESTEROV_BYTES, NESTEROV_FLOPS,
             "src/repro_torch/kernels/csrc/outer_nesterov.cu",
             "src/repro/kernels/outer_nesterov.py:31")):
        b_ms, b_by = bound(bpe, fpe)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": None,
                     "max_abs_err": err[name][0], **t, "bound_ms": b_ms,
                     "bound_by": b_by})
        say({"phase": "kernels", "kernel": name, "tree_elements": n,
             "leaves": len(shapes), "bytes": n * bpe, "kernel_ms": t["ms"],
             **t,
             "bound_ms": b_ms, "bound_by": b_by,
             "kernel_GBps": n * bpe / t["ms"] / 1e6})
    del P, G, M, V, lP, lG, lM, lV
    torch.cuda.empty_cache()
    return rows


def phase_smoke(torch, dev):
    """A k=2, H=2 round of the smoke config on the card and on the CPU."""
    import numpy as np
    from repro_torch import convert, tree
    from repro_torch.configs.base import DiLoCoConfig, TrainConfig
    from repro_torch.core import diloco
    from repro_torch.models.registry import get_smoke_arch

    k, h, b, s = 2, 2, 2, 64
    arch = get_smoke_arch("diloco_150m")
    gen = torch.Generator().manual_seed(0)
    params = arch.init(generator=gen, device="cpu")
    toks = torch.randint(0, arch.cfg.vocab_size, (k, h * b, s),
                         generator=gen)

    def run(device):
        dcfg = DiLoCoConfig(k=k, H=h)
        tcfg = TrainConfig(inner_lr=1e-3, warmup_steps=2, total_steps=8)
        rnd = diloco.make_round(lambda p, bt: arch.loss(p, bt),
                                lambda g, bb, ss: toks.to(device), dcfg,
                                tcfg, batch_size=b, seq_len=s)
        st = diloco.init_state(tree.map(lambda t: t.to(device), params),
                               dcfg)
        st, m = rnd(st, None)
        return convert.state_to_numpy(st), float(m["inner_loss"])

    got, loss_gpu = run(dev)
    want, loss_cpu = run(torch.device("cpu"))
    worst, worst_path = 0.0, ""
    for (path, a), (_, w) in zip(tree.paths(got), tree.paths(want)):
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5,
                                   err_msg=path)
        d = float(np.max(np.abs(np.asarray(a, np.float64) - w),
                         initial=0.0))
        if d > worst:
            worst, worst_path = d, path
    say({"phase": "smoke", "arch": arch.cfg.name, "k": k, "H": h,
         "leaves_compared": len(tree.paths(got)), "max_abs_diff": worst,
         "worst_leaf": worst_path, "inner_loss_cuda": loss_gpu,
         "inner_loss_cpu": loss_cpu, "rtol": 1e-4, "atol": 1e-5})


def flops_per_token(cfg, n_params: int) -> int:
    """Model FLOPs per token (PaLM's count, no recompute): 6 per matmul
    weight (all but the embedding gather) + 12·L·S·H·hd of attention (the
    full S·S) at SEQ tokens."""
    return 6 * (n_params - cfg.vocab_size * cfg.d_model) \
        + 12 * cfg.n_layers * SEQ * cfg.n_heads * cfg.resolved_head_dim


def dryrun_flops_per_token(n_params: int) -> float:
    """The dry run's model FLOPs (6·N·D, ``dryrun.model_flops``) per token
    of a BATCH × SEQ training step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    return dryrun.model_flops(n_params, n_params, ShapeConfig(
        "step", SEQ, BATCH, "train")) / (BATCH * SEQ)


def phase_train(torch, dev):
    """The main path at full width, through the trainer's entry point.
    Returns {kernel name: launches}."""
    from repro_torch import tree
    from repro_torch.models.registry import get_arch

    argv = ["--full", "--arch", "diloco_150m", "--k", str(K), "--H", str(H),
            "--rounds", str(ROUNDS), "--batch", str(BATCH), "--seq",
            str(SEQ), "--eval-batch", "8", *trace_flag("train")]
    records, timing, wall_s, launches = run_trainer(torch, dev, argv)
    want = expect_launches(fused_adamw=K * H * ROUNDS * N_LEAVES,
                           outer_nesterov=ROUNDS * N_LEAVES)
    if launches != want:
        raise SystemExit(f"launch counts {launches}, expected {want}")
    losses, _ = check_records(records, "train", 0.0)
    trace = check_trace("train")
    last = timing["rounds"][-1]
    arch = get_arch("diloco_150m")
    n_params = sum(math.prod(t.shape) for t in tree.leaves(arch.init(
        generator=None, device="meta")))
    flops_tok = flops_per_token(arch.cfg, n_params)
    tok_s = K * H * BATCH * SEQ / last["inner_s"]
    say({"phase": "train", "argv": argv, "launches": launches,
         "trace": trace,
         "losses": losses, "data_setup_s": timing["data_setup_s"],
         "rounds": timing["rounds"],
         "tokens_per_s": tok_s, "model_flops_per_token": flops_tok,
         "dryrun_model_flops_per_token": dryrun_flops_per_token(n_params),
         "mfu_vs_f32_peak": tok_s * flops_tok / PEAK_F32,
         "inner_step_ms": last["inner_s"] * 1e3 / (K * H),
         "outer_step_ms": last["outer_s"] * 1e3,
         "sample_ms": last["sample_s"] * 1e3, "wall_s": wall_s,
         "max_memory_allocated_GB":
             torch.cuda.max_memory_allocated(dev) / 1e9})
    return launches


def device_time(prof, wall_ms):
    """Device time of a ``torch.profiler`` run that took ``wall_ms`` on
    the host's clock: the total, the busy share, by kernel group and the
    top kernels."""
    from torch.autograd import DeviceType
    # the device's own kernel events only: an operator's row (aten::mm)
    # repeats the time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    groups = {}
    for key, ms, _ in rows:
        g = next((name for name, pat in PROFILE_GROUPS if pat in key),
                 "other")
        groups[g] = groups.get(g, 0.0) + ms
    return {"wall_ms": wall_ms,
            "device_ms": device_ms if rows else "not measured",
            "device_busy_share": device_ms / wall_ms if rows else
            "not measured",
            "by_group_ms": groups,
            "top": [{"kernel": key[:100], "ms": ms, "calls": n}
                    for key, ms, n in rows[:12]]}


def phase_profile(torch, dev, arch_name="diloco_150m", label="profile",
                  policy=("float32", "float32"), **cfg_changes):
    """Inner steps of one replica of ``arch_name`` (with ``cfg_changes``,
    under the precision ``policy``) at full width: the host syncs inside
    one step, then one step under the profiler (device time by kernel, and
    the device's busy share)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import diloco
    from repro_torch.models.registry import get_arch
    from repro_torch.optim import adamw, precision

    arch = get_arch(arch_name)
    cfg = arch.cfg.replace(**cfg_changes)
    params = arch.init(generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev, cfg=cfg)
    pol = precision.make_policy(*policy)
    opt = adamw.init(params, policy=pol)
    params = precision.cast_tree(params, pol.param_dtype)
    step = diloco.make_inner_step(
        lambda p, b: arch.loss(p, b, cfg=cfg),
        TrainConfig(inner_lr=1e-3, warmup_steps=2, param_dtype=policy[0],
                    master_dtype=policy[1]))
    toks = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device=dev)
    params, opt, _ = step(params, opt, {"tokens": toks}, 0)   # warm-up
    torch.cuda.synchronize()
    # host syncs inside one step: each drains the device's queue, and the
    # device then idles while the host issues the next kernels
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        params, opt, _ = step(params, opt, {"tokens": toks}, 1)
    torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, {"tokens": toks}, 2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    say({"phase": label, "arch": arch_name, "cfg_changes": cfg_changes,
         "policy": list(policy),
         "host_syncs_per_inner_step": len(syncs),
         "first_sync": syncs[:1], **device_time(prof, wall_ms)})
    del params, opt
    torch.cuda.empty_cache()


def phase_flash(torch, dev):
    """The four flash-attention kernels against their plain versions, then
    their times at diloco_400m's layer shape. Returns the kernels' rows."""
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import ref

    names = ("fwd", "fwd_lse", "bwd_dq", "bwd_dkv")
    err = dict.fromkeys(names, 0.0)
    gen = torch.Generator(device=dev).manual_seed(2)

    def inputs(B, Hh, G, S, d, Sk=None, amp=1.0):
        """q, k, v, dO; q and k times ``amp``."""
        Sk = S if Sk is None else Sk
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       for shape in ((B, Hh, S, d), (B, G, Sk, d),
                                     (B, G, Sk, d), (B, Hh, S, d)))
        return q * amp, k * amp, v, do

    def check(name, got, want, tol):
        """max |got - want|; fails unless within tol·(1 + |want|)."""
        diff = (got - want).abs()
        worst = float(diff.max())
        if not bool((diff <= tol + tol * want.abs()).all()):
            raise SystemExit(f"flash {name} differs from its plain version:"
                             f" max abs {worst} beyond {tol}·(1 + |want|)")
        err[name] = max(err[name], worst)
        return worst

    for case in FLASH_CASES:
        B, Hh, G, S, d, causal, window, *amp = case
        amp = amp[0] if amp else 1.0
        Sq, Sk = S if isinstance(S, tuple) else (S, S)
        q, k, v, do = inputs(B, Hh, G, Sq, d, Sk, amp)
        opts = dict(causal=causal, window=window)
        o_nolse = FK.flash_fwd(q, k, v, **opts)
        o, lse = FK.flash_fwd_lse(q, k, v, **opts)
        dq, dk, dv = FK.flash_bwd(q, k, v, o, lse, do, **opts)
        torch.cuda.synchronize()
        want_o, want_lse = ref.flash_fwd_lse(q, k, v, **opts)
        extra = {}
        if amp != 1.0:
            # scores of std 8: float32's own rounding puts the plain
            # version ~1.5e-5 from its float64 result, which is the one
            # the forward is held to
            o64, lse64 = ref.flash_fwd_lse(q.double(), k.double(),
                                           v.double(), **opts)
            extra["plain_f32_vs_f64"] = max(
                float((want_o - o64).abs().max()),
                float((want_lse - lse64).abs().max()))
            want_o, want_lse = o64.float(), lse64.float()
            del o64, lse64
        # the plain backward from the kernels' own residuals (o, lse)
        delta = (do * o).sum(-1)
        want_dq = ref.flash_bwd_dq(q, k, v, lse, do, delta, **opts)
        want_dk, want_dv = ref.flash_bwd_dkv(q, k, v, lse, do, delta,
                                             **opts)
        say({"phase": "flash", "case": dict(
                B=B, H=Hh, G=G, Sq=Sq, Sk=Sk, d=d, causal=causal,
                window=window, amp=amp), **extra,
             "max_abs_err": {
                 "fwd": check("fwd", o_nolse, want_o, FWD_TOL),
                 "fwd_lse": max(check("fwd_lse", o, want_o, FWD_TOL),
                                check("fwd_lse", lse, want_lse, FWD_TOL)),
                 "bwd_dq": check("bwd_dq", dq, want_dq, BWD_TOL),
                 "bwd_dkv": max(check("bwd_dkv", dk, want_dk, BWD_TOL),
                                check("bwd_dkv", dv, want_dv, BWD_TOL))},
             "fwd_tol": FWD_TOL, "bwd_tol": BWD_TOL})
        del q, k, v, do, o_nolse, o, lse, dq, dk, dv, want_o, want_lse
        del delta, want_dq, want_dk, want_dv
    torch.cuda.empty_cache()

    # times at the 400m layer shape
    B, Hh, G, S, d, causal, window = FLASH_LAYER
    q, k, v, do = inputs(B, Hh, G, S, d)
    opts = dict(causal=causal, window=window)
    o, lse = FK.flash_fwd_lse(q, k, v, **opts)
    delta = (do * o).sum(-1).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    launch = dict(do=do, lse=lse, delta=delta, scale=d ** -0.5, q_offset=0,
                  **opts)
    kernel = {
        "fwd": lambda: FK.flash_fwd(q, k, v, **opts),
        "fwd_lse": lambda: FK.flash_fwd_lse(q, k, v, **opts),
        "bwd_dq": lambda: FK._launch("bwd_dq", q, k, v, out=dq, **launch),
        "bwd_dkv": lambda: FK._launch("bwd_dkv", q, k, v, out=None, dk=dk,
                                      dv=dv, **launch)}
    plain = {
        "fwd": lambda: ref.flash_fwd_lse(q, k, v, **opts)[0],
        "fwd_lse": lambda: ref.flash_fwd_lse(q, k, v, **opts),
        "bwd_dq": lambda: ref.flash_bwd_dq(q, k, v, lse, do, delta, **opts),
        "bwd_dkv": lambda: ref.flash_bwd_dkv(q, k, v, lse, do, delta,
                                             **opts)}
    # the yardstick: PyTorch's fused attention on the same f32 inputs; it
    # computes dq, dk and dv in one backward call
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = sdpa(*leaves, is_causal=causal)
    lib_fwd = time_ms(torch, lambda: sdpa(q, k, v, is_causal=causal))
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True))
    library = {"fwd": lib_fwd, "fwd_lse": lib_fwd, "bwd_dq": lib_bwd,
               "bwd_dkv": lib_bwd}
    # which device kernels the yardstick runs, from one profiled call
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sdpa(q, k, v, is_causal=causal)
        torch.cuda.synchronize()
    sdpa_kernels = sorted({e.key for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA}) \
        or "not measured"
    say({"phase": "flash", "sdpa_fwd_device_kernels": sdpa_kernels})
    flash_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    both = {"kernels": lambda: torch.autograd.grad(FK.flash_attention(
                *flash_leaves, **opts), flash_leaves, do),
            "library": lambda: torch.autograd.grad(sdpa(
                *leaves, is_causal=causal), leaves, do)}
    fwd_bwd_ms = {n: time_ms(torch, fn) for n, fn in both.items()}

    # the bound: visible (query, key) pairs of this run's mask; flops per
    # pair and head: 2·d for each product a kernel computes (forward s and
    # p·v; dq s, dp and ds·k; dk/dv s, dp, pᵀ·dO and dsᵀ·q); bytes: each
    # input read once, each output written once. Every kernel runs each
    # product as three TF32 products on the tensor cores (bound_ms;
    # bound_f32_ms is what the same flops would take on the f32 CUDA cores)
    pairs = int(ref.flash_visible(S, S, causal=causal, window=window,
                                  device=dev).sum()) * B * Hh
    nq, nkv, nrow = 4 * q.numel(), 4 * k.numel(), 4 * lse.numel()
    work = {"fwd": (4 * d * pairs, 2 * nq + 2 * nkv),
            "fwd_lse": (4 * d * pairs, 2 * nq + 2 * nkv + nrow),
            "bwd_dq": (6 * d * pairs, 3 * nq + 2 * nkv + 2 * nrow),
            "bwd_dkv": (8 * d * pairs, 2 * nq + 4 * nkv + 2 * nrow)}
    bw = bandwidth(torch.cuda.get_device_name(0))
    tpu = {"fwd": "src/repro/kernels/flash_attention.py:218",
           "fwd_lse": "src/repro/kernels/flash_attention.py:293",
           "bwd_dq": "src/repro/kernels/flash_attention.py:360",
           "bwd_dkv": "src/repro/kernels/flash_attention.py:380"}
    rows = []
    for n in names:
        flops, nbytes = work[n]
        by_bytes = nbytes / bw
        # printed in this phase's line only; the kernels line has bound_ms
        by_ops = 3 * flops / PEAK_TF32
        bounds = {"bound_f32_ms": max(flops / PEAK_F32, by_bytes) * 1e3}
        t = {"ms": time_ms(torch, kernel[n]),
             "plain_ms": time_ms(torch, plain[n])}
        rows.append({"name": f"flash_{n}", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                     "replaces": tpu[n], "launches": None,
                     "max_abs_err": err[n], **t,
                     "bound_ms": max(by_ops, by_bytes) * 1e3,
                     "bound_by": "operations" if by_ops >= by_bytes
                     else "bytes", "library_ms": library[n]})
        say({"phase": "flash", "kernel": n, "shape": list(FLASH_LAYER),
             "flops": flops, "bytes": nbytes, **t,
             "bound_ms": rows[-1]["bound_ms"],
             "bound_by": rows[-1]["bound_by"], **bounds,
             "library_ms": library[n],
             "kernel_TFLOPs": flops / t["ms"] / 1e9})
    pair = sum(r["ms"] for r in rows if r["name"].startswith("flash_bwd"))
    say({"phase": "flash", "fwd_plus_bwd_ms": fwd_bwd_ms,
         "bwd_dq_plus_dkv_ms": pair, "library_bwd_ms": lib_bwd,
         "shape": list(FLASH_LAYER)})
    del q, k, v, do, o, lse, delta, dq, dk, dv, leaves, out, flash_leaves
    torch.cuda.empty_cache()
    return rows


def phase_train_400m(torch, dev):
    """Slice 2's path at full width: diloco_400m with use_pallas=True
    through ``make_round``/``make_eval``. Returns {kernel: launches}."""
    from repro_torch import tree
    from repro_torch.core import diloco
    from repro_torch.launch import train

    argv = ["--full", "--arch", "diloco_400m", "--k", str(K), "--H", str(H),
            "--rounds", str(ROUNDS), "--batch", str(BATCH), "--seq",
            str(SEQ)]
    args = train.make_parser().parse_args(argv)
    t0 = time.perf_counter()
    arch, cfg, dcfg, tcfg, sampler = train.build(
        args, dev, sampler=shared_sampler(torch, dev, args))
    data_setup_s = time.perf_counter() - t0
    # no trainer flag sets use_pallas: a user reaches it through the loss
    cfg = cfg.replace(use_pallas=True)
    loss_fn = lambda p, b: arch.loss(p, b, cfg=cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = arch.init(generator=gen, device=dev, cfg=cfg)
    n_params = sum(t.numel() for t in tree.leaves(params))
    state = diloco.init_state(params, dcfg)
    del params
    rnd = diloco.make_round(loss_fn, sampler.sample_all_shards, dcfg, tcfg,
                            total_steps=tcfg.total_steps, batch_size=BATCH,
                            seq_len=SEQ)
    ev = diloco.make_eval(loss_fn)
    val = sampler.sample_validation(
        torch.Generator(device=dev).manual_seed(10_000), BATCH, SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    rounds = []
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        state, m = rnd(state, gen)
        rounds.append({"inner_loss": float(m["inner_loss"]),
                       "val_loss": float(ev(state.global_params, val)),
                       **{n: m[n] for n in ("sample_s", "inner_s",
                                            "outer_s")}})
    wall_s = time.perf_counter() - t0
    L, steps = cfg.n_layers, K * H * ROUNDS
    launches = read_launches()
    want = expect_launches(flash_fwd=ROUNDS * L, flash_fwd_lse=2 * L * steps,
                           flash_bwd_dq=L * steps, flash_bwd_dkv=L * steps,
                           fused_adamw=steps * N_LEAVES,
                           outer_nesterov=ROUNDS * N_LEAVES)
    if launches != want:
        raise SystemExit(f"launch counts {launches}, expected {want}")
    if not all(math.isfinite(r[n]) for r in rounds
               for n in ("inner_loss", "val_loss")):
        raise SystemExit(f"bad round records: {rounds}")
    # model FLOPs per token as in phase 4 (no recompute, full S·S)
    flops_tok = flops_per_token(cfg, n_params)
    tok_s = K * H * BATCH * SEQ / rounds[-1]["inner_s"]
    say({"phase": "train_400m", "argv": argv, "use_pallas": True,
         "params": n_params, "launches": launches, "rounds": rounds,
         "data_setup_s": data_setup_s, "tokens_per_s": tok_s,
         "model_flops_per_token": flops_tok,
         "dryrun_model_flops_per_token": dryrun_flops_per_token(n_params),
         "mfu_vs_f32_peak": tok_s * flops_tok / PEAK_F32,
         "inner_step_ms": rounds[-1]["inner_s"] * 1e3 / (K * H),
         "outer_step_ms": rounds[-1]["outer_s"] * 1e3, "wall_s": wall_s,
         "max_memory_allocated_GB":
             torch.cuda.max_memory_allocated(dev) / 1e9})
    del state, sampler, val
    torch.cuda.empty_cache()
    return launches


def phase_mixed_kernels(torch, dev):
    """Slice 3's kernels against their plain versions at the main path's
    shapes, then their whole-tree times. Returns the kernels' rows."""
    from repro_torch import tree
    from repro_torch.kernels import fused_adamw as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import sign_prune as SP
    from repro_torch.models.registry import get_arch

    gen = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda shape: torch.randn(shape, generator=gen, device=dev)
    bf = lambda t: t.to(torch.bfloat16)
    hp = dict(lr=3e-4, c1=0.19, c2=0.0975, b1=0.9, b2=0.95, eps=1e-8,
              weight_decay=0.1)
    leaves = tree.paths(get_arch("diloco_150m").init(generator=None,
                                                     device="meta"))
    shapes = [tuple(t.shape) for _, t in leaves]
    err = {"fused_adamw_mixed": [0.0, 0], "fused_adamw_bf16": [0.0, 0],
           "sign_prune": [0.0, 0]}

    def hold(name, got, want):
        for a, b in zip(got, want):
            e = err[name]
            e[0] = max(e[0], float((a.float() - b.float()).abs().max()))
            e[1] = max(e[1], ulps(torch, a, b))

    for (path, _), shape in zip(leaves, shapes):
        n = math.prod(shape)
        for offset in (0, 1):      # 1: unaligned pointers, scalar path
            # sliced after the cast, so that offset 1 misaligns bf16 too
            g, m, v, p = (bf(rnd(n + offset))[offset:].view(shape)
                          for _ in range(4))
            v = v.abs()
            w = rnd(n + offset)[offset:].view(shape)
            hold("fused_adamw_mixed", FA.fused_adamw_mixed(g, m, v, w, **hp),
                 ref.fused_adamw_mixed(g, m, v, w, **hp))
            hold("fused_adamw_bf16", FA.fused_adamw(p, g, m, v, **hp),
                 ref.fused_adamw(p, g, m, v, **hp))
            torch.cuda.synchronize()
            del g, m, v, w, p
        # the pruning, on this leaf of a stacked k=2 delta: (k·R, C)
        x = ops.as_rows(rnd((K,) + shape), 1)
        sign, hi, out = SP.sign_prune_parts(x, PRUNE_FRAC)
        wsign, whi, wout = ref.sign_prune_parts(x, PRUNE_FRAC)
        torch.cuda.synchronize()
        rows_differ = int((sign != wsign).sum() + (hi != whi).sum())
        hold("sign_prune", (out,), (wout,))
        if rows_differ:
            raise SystemExit(f"sign_prune on {path}: {rows_differ} rows "
                             "elect another sign or threshold")
        say({"phase": "mixed_kernels", "leaf": path, "shape": list(shape),
             "prune_matrix": list(x.shape),
             "prune_launches": SP.launches_for(*x.shape),
             "prune_rows_with_other_sign_or_threshold": rows_differ,
             **{f"{k}_max_abs_err": e[0] for k, e in err.items()},
             **{f"{k}_max_ulps": e[1] for k, e in err.items()}})
        del x, sign, hi, out, wsign, whi, wout
    for name, (e, u) in err.items():
        if u > 2:
            raise SystemExit(f"{name}: kernel differs from its plain version "
                             f"by {u} ulp (max abs {e})")

    # one whole-tree call of each
    n = sum(math.prod(sh) for sh in shapes)
    mk = lambda dtype, stack=(): {f"{i:02d}": rnd(stack + sh).to(dtype)
                                  for i, sh in enumerate(shapes)}
    G, M = mk(torch.bfloat16), mk(torch.bfloat16)
    V = {key: t.abs() for key, t in mk(torch.bfloat16).items()}
    W, P = mk(torch.float32), mk(torch.bfloat16)
    lG, lM, lV, lW, lP = (list(t.values()) for t in (G, M, V, W, P))
    bw = bandwidth(torch.cuda.get_device_name(0))

    def bound(elems, bytes_per, ops_per):
        by_bytes, by_ops = elems * bytes_per / bw, elems * ops_per / PEAK_F32
        return (max(by_bytes, by_ops) * 1e3,
                "bytes" if by_bytes >= by_ops else "operations")

    times = {
        "fused_adamw_mixed": {
            "ms": time_ms(torch, lambda: ops.adamw_update_tree_mixed(
                P, G, M, V, W, lr=3e-4, count=5, mode="kernel")),
            "plain_ms": time_ms(torch, lambda: [ref.fused_adamw_mixed(
                g, m, v, w, **hp) for g, m, v, w in zip(lG, lM, lV, lW)]),
            # no PyTorch call computes a master-copy AdamW step
            "library_ms": None},
        "fused_adamw_bf16": {
            "ms": time_ms(torch, lambda: ops.adamw_update_tree(
                P, G, M, V, lr=3e-4, count=5, mode="kernel")),
            "plain_ms": time_ms(torch, lambda: [ref.fused_adamw(
                p, g, m, v, **hp) for p, g, m, v in zip(lP, lG, lM, lV)])}}
    steps = [torch.full((), 5.0, device=dev) for _ in shapes]
    try:
        times["fused_adamw_bf16"]["library_ms"] = time_ms(
            torch, lambda: torch._fused_adamw_(
                lP, lG, lM, lV, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
                weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False))
    except RuntimeError as e:      # the library's bf16 support is its own
        times["fused_adamw_bf16"]["library_ms"] = None
        say({"phase": "mixed_kernels", "library_refused": str(e)[:200]})
    del G, M, V, W, P, lG, lM, lV, lW, lP
    torch.cuda.empty_cache()
    # stacked k=2 outer deltas, pruned in place as the outer step does;
    # each timed call starts from the same fresh deltas (copied untimed)
    D0 = mk(torch.float32, (K,))
    D = {key: t.clone() for key, t in D0.items()}
    fresh = lambda: [d.copy_(d0) for d, d0 in zip(D.values(), D0.values())]
    times["sign_prune"] = {
        "ms": time_ms(torch, lambda: ops.sign_prune_tree(
            D, PRUNE_FRAC, stacked=True, mode="kernel"), setup=fresh),
        "plain_ms": time_ms(torch, lambda: ops.sign_prune_tree(
            D, PRUNE_FRAC, stacked=True, mode="ref"), reps=5, warmup=1,
            setup=fresh),
        # no PyTorch call computes it (torch.topk or kthvalue per row
        # would select by magnitude only, without the sign election)
        "library_ms": None}
    # the two regimes apart: leaves of rows up to RESIDENT_MAX_COLS, and
    # the long ones
    regimes = {}
    for regime in ("resident", "long"):
        part = {key: d for key, d in D.items()
                if (ops.as_rows(d, 1).shape[1] <= SP.RESIDENT_MAX_COLS)
                == (regime == "resident")}
        ms = time_ms(torch, lambda: ops.sign_prune_tree(
            part, PRUNE_FRAC, stacked=True, mode="kernel"), setup=fresh)
        nbytes = sum(d.numel() for d in part.values()) * PRUNE_BYTES
        regimes[regime] = {
            "leaves": len(part), "ms": ms, "bytes": nbytes,
            "GBps": nbytes / ms / 1e6,
            "launches": sum(SP.launches_for(*ops.as_rows(d, 1).shape)
                            for d in part.values())}
    say({"phase": "mixed_kernels", "kernel": "sign_prune",
         "ms_resident": regimes["resident"]["ms"],
         "ms_long": regimes["long"]["ms"], "regimes": regimes,
         "card_GBps": bandwidth(torch.cuda.get_device_name(0)) / 1e9})
    del D, D0
    torch.cuda.empty_cache()
    work = {"fused_adamw_mixed": (n, MIXED_ADAMW_BYTES, ADAMW_FLOPS,
                                  "src/repro/kernels/fused_adamw.py:136",
                                  "fused_adamw.cu"),
            "fused_adamw_bf16": (n, BF16_ADAMW_BYTES, ADAMW_FLOPS,
                                 "src/repro/kernels/fused_adamw.py:96",
                                 "fused_adamw.cu"),
            "sign_prune": (K * n, PRUNE_BYTES, PRUNE_OPS,
                           "src/repro/kernels/sign_prune.py:53",
                           "sign_prune.cu")}
    rows = []
    for name, (elems, bpe, ope, tpu, src) in work.items():
        b_ms, b_by = bound(elems, bpe, ope)
        t = times[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}",
                     "replaces": tpu, "launches": None,
                     "max_abs_err": err[name][0], **t, "bound_ms": b_ms,
                     "bound_by": b_by})
        say({"phase": "mixed_kernels", "kernel": name, "elements": elems,
             "bytes": elems * bpe, **t, "bound_ms": b_ms, "bound_by": b_by,
             "kernel_GBps": elems * bpe / t["ms"] / 1e6})
    return rows


def phase_smoke_mixed(torch, dev):
    """k=2, H=2 rounds of the smoke config on the card and on the CPU under
    the two bf16 policies."""
    from repro_torch import check, convert, tree
    from repro_torch.configs.base import DiLoCoConfig, TrainConfig
    from repro_torch.core import diloco
    from repro_torch.models.registry import get_smoke_arch

    k, h, b, s = 2, 2, 2, 64
    arch = get_smoke_arch("diloco_150m")
    gen = torch.Generator().manual_seed(0)
    params = arch.init(generator=gen, device="cpu")
    toks = torch.randint(0, arch.cfg.vocab_size, (k, h * b, s),
                         generator=gen)
    for pdt, mdt, frac in (("bfloat16", "float32", PRUNE_FRAC),
                           ("bfloat16", "bfloat16", 0.0)):
        pol = dict(param_dtype=pdt, master_dtype=mdt)

        def run(device):
            dcfg = DiLoCoConfig(k=k, H=h, prune_frac=frac, **pol)
            tcfg = TrainConfig(inner_lr=1e-3, warmup_steps=2, total_steps=8,
                               **pol)
            rnd = diloco.make_round(lambda p, bt: arch.loss(p, bt),
                                    lambda g, bb, ss: toks.to(device), dcfg,
                                    tcfg, batch_size=b, seq_len=s)
            st = diloco.init_state(tree.map(lambda t: t.to(device), params),
                                   dcfg)
            st, m = rnd(st, None)
            return convert.state_to_numpy(st), m

        counts0 = read_launches()
        got, m_gpu = run(dev)
        counts = {n: c - counts0[n] for n, c in read_launches().items()}
        want, m_cpu = run(torch.device("cpu"))
        # the tolerances of tests/test_torch_mixed.py; with pruning at most
        # 0.1% of a leaf's entries outside them (entries at a threshold)
        shares = check.mismatch_shares(got, want, H=h,
                                         pure=mdt == "bfloat16")
        path = max(shares, key=shares.get)
        if shares[path] > (1e-3 if frac else 0.0):
            raise SystemExit(f"smoke_mixed {pdt}/{mdt}: {path}: "
                             f"{shares[path]:.3g} of the entries outside "
                             "the tolerance")
        steps = k * h * N_LEAVES
        adamw = "fused_adamw_mixed" if mdt == "float32" else \
            "fused_adamw_bf16"
        if {**counts, "sign_prune": 0} != expect_launches(
                **{adamw: steps}, outer_nesterov=N_LEAVES) \
                or (counts["sign_prune"] > 0) != (frac > 0):
            raise SystemExit(f"smoke_mixed {pdt}/{mdt}: launches {counts}")
        say({"phase": "smoke_mixed", "policy": [pdt, mdt], "prune_frac": frac,
             "k": k, "H": h, "leaves_compared": len(tree.paths(got)),
             "worst_share_outside_tolerance": shares[path],
             "worst_leaf": path,
             "launches": counts,
             "inner_loss_cuda": float(m_gpu["inner_loss"]),
             "inner_loss_cpu": float(m_cpu["inner_loss"]),
             "prune_density_cuda": float(m_gpu.get("prune_density", 1.0)),
             "prune_density_cpu": float(m_cpu.get("prune_density", 1.0))})


def phase_train_mixed(torch, dev):
    """Slice 3's path at full width through the trainer's entry point.
    Returns {kernel name: launches}."""
    argv = ["--full", "--arch", "diloco_150m", "--param-dtype", "bfloat16",
            "--master-dtype", "float32", "--prune-frac", str(PRUNE_FRAC),
            "--k", str(K), "--H", str(H), "--rounds", str(ROUNDS), "--batch",
            str(BATCH), "--seq", str(SEQ), "--eval-batch", "8"]
    per_round = prune_launches_per_round(torch, K)
    records, timing, wall_s, launches = run_trainer(torch, dev, argv)
    want = expect_launches(fused_adamw_mixed=K * H * ROUNDS * N_LEAVES,
                           outer_nesterov=ROUNDS * N_LEAVES,
                           sign_prune=ROUNDS * per_round)
    if launches != want:
        raise SystemExit(f"launch counts {launches}, expected {want}")
    losses, density = check_records(records, "train_mixed", PRUNE_FRAC)
    last = timing["rounds"][-1]
    tok_s = K * H * BATCH * SEQ / last["inner_s"]
    say({"phase": "train_mixed", "argv": argv, "launches": launches,
         "sign_prune_launches_per_round": per_round,
         "losses": losses, "prune_density": density,
         "data_setup_s": timing["data_setup_s"],
         "rounds": timing["rounds"], "tokens_per_s": tok_s,
         "inner_step_ms": last["inner_s"] * 1e3 / (K * H),
         "outer_step_ms": last["outer_s"] * 1e3,
         "sample_ms": last["sample_s"] * 1e3, "wall_s": wall_s,
         "max_memory_allocated_GB":
             torch.cuda.max_memory_allocated(dev) / 1e9})
    torch.cuda.empty_cache()
    return launches


def phase_train_bf16(torch, dev):
    """The pure (bf16, bf16) policy, and pretraining under both bf16
    policies, at full width through the trainer's entry point: diloco_150m
    with ``--pretrain-steps 2`` (a single worker, whose master then starts
    DiLoCo), k=2, H=2, batch 8, seq 1024, one round (H=2: DiLoCo's
    schedule starts again at step 0, whose learning rate is 0, as in the
    JAX driver). Launches per run: AdamW (pretraining steps + k·H)·12 =
    72 of the policy's kernel, outer_nesterov 12, sign_prune one round's
    under pruning, every other kernel 0. Returns {kernel name: launches}
    of the pure-policy run."""
    n_pre, h, rounds = 2, 2, 1
    out = {}
    for mdt, frac in (("bfloat16", 0.0), ("float32", PRUNE_FRAC)):
        argv = ["--full", "--arch", "diloco_150m", "--param-dtype",
                "bfloat16", "--master-dtype", mdt, "--prune-frac", str(frac),
                "--pretrain-steps", str(n_pre), "--log-every", "1",
                "--k", str(K), "--H", str(h), "--rounds", str(rounds),
                "--batch", str(BATCH), "--seq", str(SEQ), "--eval-batch",
                "8"]
        records, timing, wall_s, launches = run_trainer(torch, dev, argv)
        adamw = "fused_adamw_bf16" if mdt == "bfloat16" else \
            "fused_adamw_mixed"
        want = expect_launches(
            **{adamw: (n_pre + K * h * rounds) * N_LEAVES},
            outer_nesterov=rounds * N_LEAVES,
            sign_prune=rounds * prune_launches_per_round(torch, K)
            if frac else 0)
        if launches != want:
            raise SystemExit(f"train_bf16 ({mdt} master): launch counts "
                             f"{launches}, expected {want}")
        losses, density = check_records(records, "train_bf16", frac,
                                        n_pretrain=n_pre, rounds=rounds)
        last = timing["rounds"][-1]
        say({"phase": "train_bf16", "argv": argv, "launches": launches,
             "losses_pretrain_then_rounds": losses,
             "prune_density": density,
             "data_setup_s": timing["data_setup_s"],
             "tokens_per_s": K * h * BATCH * SEQ / last["inner_s"],
             "inner_step_ms": last["inner_s"] * 1e3 / (K * h),
             "outer_step_ms": last["outer_s"] * 1e3, "wall_s": wall_s,
             "max_memory_allocated_GB":
                 torch.cuda.max_memory_allocated(dev) / 1e9})
        torch.cuda.empty_cache()
        if mdt == "bfloat16":
            out = launches
    return out


def bits_equal(torch, a, b) -> bool:
    """``a`` and ``b`` (float32) bit for bit where ``b`` is not NaN, and
    NaN at the same places (NaN payloads are not compared)."""
    nan = torch.isnan(b)
    return bool(torch.equal(torch.isnan(a), nan)) and bool(torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan]))


def phase_quant_kernels(torch, dev):
    """``fake_quant`` against its plain version at the main path's shapes
    and at edge cases, then its whole-tree times. Returns its rows."""
    from repro_torch import tree
    from repro_torch.kernels import quantize as QZ
    from repro_torch.kernels import ref
    from repro_torch.models.registry import get_arch

    gen = torch.Generator(device=dev).manual_seed(4)
    rnd = lambda shape: torch.randn(shape, generator=gen, device=dev)
    leaves = tree.paths(get_arch("diloco_150m").init(generator=None,
                                                     device="meta"))
    err = {"int4": 0.0, "bfloat16": 0.0}
    cases = 0

    def hold(x, rows, label):
        nonlocal cases
        for dt in err:
            got = QZ.fake_quant(x, dt, rows=rows)
            want = ref.fake_quant_rows(x.reshape(rows, -1), dt).view(x.shape)
            torch.cuda.synchronize()
            if not bits_equal(torch, got, want):
                raise SystemExit(f"fake_quant {dt} on {label}: the kernel "
                                 "differs from its plain version")
            fin = torch.isfinite(want)
            if fin.any():
                err[dt] = max(err[dt], float((got[fin] - want[fin]).abs()
                                             .max()))
        cases += 1

    for path, t in leaves:          # each leaf of a stacked k=2 delta
        hold(rnd((K,) + tuple(t.shape)) * 1e-2, K, path)
    for rows, n in ((2, 1000), (3, 1_000_003), (1, 1), (K, 896 * 3 + 5)):
        for offset in (0, 1):      # 1: unaligned pointers
            hold(rnd(rows * n + offset)[offset:].view(rows, n), rows,
                 f"({rows}, {n}) offset {offset}")
    x = rnd((2, 8 * 128 + 77))
    x[0, 3] = float("nan")
    x[0, 200] = float("inf")
    x[1, 130] = -float("inf")
    x[1, 256:384] = 0.0
    x[1, 384:512] = -0.0
    x[0, 512::3] = -0.0
    hold(x, 2, "NaN, inf, zero and -0.0 blocks")
    got = QZ.fake_quant(x, "int4", rows=2)
    if not (torch.isnan(got[0, :256]).all() and torch.isnan(
            got[1, 128:256]).all() and torch.isfinite(got[1, 256:]).all()):
        raise SystemExit("fake_quant int4: a block with a NaN or an "
                         "infinity is not all NaN, or the NaN spread")
    say({"phase": "quant_kernels", "cases": cases,
         "max_abs_err": err, "bitwise": True})

    # one call over the whole stacked tree, into preallocated outputs
    X = [rnd((K,) + tuple(t.shape)) * 1e-2 for _, t in leaves]
    O = [torch.empty_like(x) for x in X]
    n = sum(x.numel() for x in X)
    bw = bandwidth(torch.cuda.get_device_name(0))
    rows = []
    for dt, name in (("int4", "fake_quant_int4"),
                     ("bfloat16", "fake_quant_bf16")):
        t = {"ms": time_ms(torch, lambda: [QZ.fake_quant(
                x, dt, rows=K, out=o) for x, o in zip(X, O)]),
             "plain_ms": time_ms(torch, lambda: [ref.fake_quant_rows(
                 x.view(K, -1), dt) for x in X], reps=5, warmup=1),
             # no PyTorch call computes the blockwise int4 round trip
             # (torch.fake_quantize_per_channel_affine takes a given scale
             # and multiplies by its inverse); bf16's is two calls
             "library_ms": None if dt == "int4" else time_ms(
                 torch, lambda: [x.to(torch.bfloat16).to(torch.float32)
                                 for x in X])}
        by_bytes, by_ops = n * QUANT_BYTES / bw, n * QUANT_OPS[dt] / PEAK_F32
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/quantize.cu",
               "replaces": "src/repro/kernels/quantize.py:327",
               "launches": None, "max_abs_err": err[dt], **t,
               "bound_ms": max(by_bytes, by_ops) * 1e3,
               "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
        rows.append(row)
        say({"phase": "quant_kernels", "kernel": name, "elements": n,
             "leaves": len(X), "bytes": n * QUANT_BYTES, **t,
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "kernel_GBps": n * QUANT_BYTES / t["ms"] / 1e6})
    del X, O
    torch.cuda.empty_cache()
    return rows


def stream_launches(params, P, H_, tau, rounds, dtype):
    """(fake_quant, outer_nesterov) launches of ``rounds`` streaming rounds
    of ``params``' tree from a fresh state: one fake_quant per leaf a
    fragment touches at each of its sends (0 for float32), one
    outer_nesterov per such leaf at each apply after its first send."""
    from repro_torch.core import fragments
    part = fragments.partition_params(params, P)
    n_leaves = [len(r) for r in fragments.fragment_regions(part, params)]
    armed, quant, nest = set(), 0, 0
    for _ in range(rounds):
        for _, events in fragments.schedule(P, H_, tau).phases:
            for ev in events:
                if ev.kind == "send":
                    armed.add(ev.fragment)
                    quant += n_leaves[ev.fragment] * (dtype != "float32")
                elif ev.fragment in armed:
                    nest += n_leaves[ev.fragment]
    return quant, nest


def phase_train_stream(torch, dev):
    """Slice 4's path at full width through the trainer, then one
    bf16-transport round through ``make_round``. Returns {kernel name:
    launches} of fake_quant (int4 from the first run, bf16 from the
    second)."""
    from repro_torch.configs.base import DiLoCoConfig, TrainConfig
    from repro_torch.core import diloco, streaming
    from repro_torch.models.registry import get_arch

    arch = get_arch("diloco_150m")
    meta = arch.init(generator=None, device="meta")
    argv = ["--full", "--arch", "diloco_150m", *STREAM_FLAGS, "--k", str(K),
            "--H", str(H), "--rounds", str(ROUNDS), "--batch", str(BATCH),
            "--seq", str(SEQ), "--eval-batch", "8",
            *trace_flag("train_stream")]
    quant, nest = stream_launches(meta, 4, H, 2, ROUNDS, "int4")
    records, timing, wall_s, launches = run_trainer(torch, dev, argv)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want = expect_launches(fake_quant_int4=quant, outer_nesterov=nest,
                           fused_adamw=K * H * ROUNDS * N_LEAVES)
    if launches != want:
        raise SystemExit(f"train_stream: launch counts {launches}, expected "
                         f"{want}")
    losses, _ = check_records(records, "train_stream", 0.0)
    trace = check_trace("train_stream")
    rnds = [r for r in records if r["phase"] == "diloco"]
    last = timing["rounds"][-1]
    say({"phase": "train_stream", "argv": argv, "launches": launches,
         "trace": trace,
         "losses": losses, "data_setup_s": timing["data_setup_s"],
         "rounds": timing["rounds"],
         "tokens_per_s": K * H * BATCH * SEQ / last["inner_s"],
         "inner_step_ms": last["inner_s"] * 1e3 / (K * H),
         "outer_ms_per_round": last["outer_s"] * 1e3,
         "sample_ms": last["sample_s"] * 1e3, "wall_s": wall_s,
         "stream_peak_sync_bytes": rnds[-1]["stream_peak_sync_bytes"],
         "stream_round_sync_bytes": rnds[-1]["stream_round_sync_bytes"],
         "outer_gnorm": [r["outer_gnorm"] for r in rnds],
         "max_memory_allocated_GB": peak_gb})
    torch.cuda.empty_cache()

    # one bf16-transport round, P=2, tau=0, on random tokens
    dcfg = DiLoCoConfig(k=K, H=H, streaming_fragments=2,
                        outer_grad_dtype="bfloat16")
    tcfg = TrainConfig(inner_lr=1e-3, warmup_steps=2, total_steps=H)
    gen = torch.Generator(device=dev).manual_seed(5)
    state = streaming.init_state(arch.init(generator=gen, device=dev), dcfg)
    toks = torch.randint(0, arch.cfg.vocab_size, (K, H * BATCH, SEQ),
                         generator=gen, device=dev)
    rnd = diloco.make_round(lambda p, b: arch.loss(p, b),
                            lambda g, b, s: toks, dcfg, tcfg,
                            batch_size=BATCH, seq_len=SEQ)
    torch.cuda.synchronize()
    reset_launches()
    state, m = rnd(state, None)
    bf16 = read_launches()
    torch.cuda.synchronize()
    q2, n2 = stream_launches(meta, 2, H, 0, 1, "bfloat16")
    want = expect_launches(fake_quant_bf16=q2, outer_nesterov=n2,
                           fused_adamw=K * H * N_LEAVES)
    if bf16 != want:
        raise SystemExit(f"train_stream bf16: launch counts {bf16}, "
                         f"expected {want}")
    loss, gnorm = float(m["inner_loss"]), float(m["outer_gnorm"])
    if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
        raise SystemExit(f"train_stream bf16: loss {loss}, gnorm {gnorm}")
    say({"phase": "train_stream", "transport": "bfloat16", "P": 2, "tau": 0,
         "launches": bf16, "inner_loss": loss, "outer_gnorm": gnorm,
         "inner_step_ms": m["inner_s"] * 1e3 / (K * H),
         "outer_ms_per_round": m["outer_s"] * 1e3,
         "stream_round_sync_bytes": m["stream_round_sync_bytes"]})
    del state, toks
    torch.cuda.empty_cache()
    profile_stream_round(torch, dev, arch)
    return {"fake_quant_int4": launches["fake_quant_int4"],
            "fake_quant_bf16": bf16["fake_quant_bf16"]}


def profile_stream_round(torch, dev, arch):
    """One round of the trainer's streaming config (P=4, τ=2, α=0.5, int4
    with error feedback) through ``make_round`` under the profiler, after
    an unprofiled round that arms every fragment: the device's busy share
    across the round's inner segments and events, each closed by a host
    synchronize."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import DiLoCoConfig, TrainConfig
    from repro_torch.core import diloco, streaming

    dcfg = DiLoCoConfig(k=K, H=H, streaming_fragments=4, stream_tau=2,
                        stream_alpha=0.5, outer_grad_dtype="int4",
                        error_feedback=True)
    tcfg = TrainConfig(inner_lr=1e-3, warmup_steps=2, total_steps=2 * H)
    gen = torch.Generator(device=dev).manual_seed(6)
    state = streaming.init_state(arch.init(generator=gen, device=dev), dcfg)
    toks = torch.randint(0, arch.cfg.vocab_size, (K, H * BATCH, SEQ),
                         generator=gen, device=dev)
    rnd = diloco.make_round(lambda p, b: arch.loss(p, b),
                            lambda g, b, s: toks, dcfg, tcfg,
                            batch_size=BATCH, seq_len=SEQ)
    state, _ = rnd(state, None)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = rnd(state, None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    say({"phase": "profile_stream", "P": 4, "tau": 2, "alpha": 0.5,
         "transport": "int4", "error_feedback": True,
         "inner_ms": m["inner_s"] * 1e3, "outer_ms": m["outer_s"] * 1e3,
         **device_time(prof, wall_ms)})
    del state, toks
    torch.cuda.empty_cache()


def phase_smoke_stream(torch, dev):
    """Two k=2 streaming rounds of the smoke config (P=2, τ=1, α=0.5, int4
    with error feedback, so the second round applies the first's wrapped
    send) on the card against the CPU, with the code steps of the CPU's
    sends bounding the entries outside the tolerance."""
    from repro_torch import check, convert, tree
    from repro_torch.configs.base import DiLoCoConfig, TrainConfig
    from repro_torch.core import diloco, streaming
    from repro_torch.models.registry import get_smoke_arch

    k, h, b, s, rounds = 2, 2, 2, 64, 2
    arch = get_smoke_arch("diloco_150m")
    gen = torch.Generator().manual_seed(0)
    params = arch.init(generator=gen, device="cpu")
    toks = torch.randint(0, arch.cfg.vocab_size, (rounds, k, h * b, s),
                         generator=gen)
    dcfg = DiLoCoConfig(k=k, H=h, streaming_fragments=2, stream_tau=1,
                        stream_alpha=0.5, outer_grad_dtype="int4",
                        error_feedback=True)

    def run(device):
        tcfg = TrainConfig(inner_lr=1e-3, warmup_steps=2, total_steps=8)
        rnd = diloco.make_round(lambda p, bt: arch.loss(p, bt),
                                lambda r, bb, ss: toks[r].to(device), dcfg,
                                tcfg, batch_size=b, seq_len=s)
        st = streaming.init_state(tree.map(lambda t: t.to(device), params),
                                  dcfg)
        for r in range(rounds):
            st, m = rnd(st, r)
        return convert.stream_state_to_numpy(st), m

    counts0 = read_launches()
    with check.TransportSteps(params, dcfg) as card_steps:
        got, m_gpu = run(dev)
    counts = {n: c - counts0[n] for n, c in read_launches().items()}
    with check.TransportSteps(params, dcfg) as steps:
        want, m_cpu = run(torch.device("cpu"))
    # a code that differs is explained only as a straddle of the two runs'
    # pre-rounding values within the float32 bound (``check.py``)
    steps.explain(card_steps)
    quant, nest = stream_launches(
        arch.init(generator=None, device="meta"), 2, h, 1, rounds, "int4")
    if counts != expect_launches(fake_quant_int4=quant, outer_nesterov=nest,
                                 fused_adamw=k * h * rounds * N_LEAVES):
        raise SystemExit(f"smoke_stream: launches {counts}")
    shares = check.stream_mismatch_shares(got, want, H=h, steps=steps)
    path = max(shares, key=shares.get)
    if shares[path] > check.TRANSPORT_FLIP_SHARE["int4"]:
        raise SystemExit(f"smoke_stream: {path}: {shares[path]:.3g} of the "
                         "entries outside the tolerance, or one beyond "
                         f"{steps.allow:.3g} code steps")
    say({"phase": "smoke_stream", "k": k, "H": h, "rounds": rounds,
         "P": 2, "tau": 1, "alpha": 0.5, "transport": "int4",
         "error_feedback": True, "leaves_compared": len(shares),
         "worst_share_outside_tolerance": shares[path], "worst_leaf": path,
         "code_steps_allowed": steps.allow,
         "straddles_explained": {p: n for p, n in steps.explained.items()
                                 if n},
         "flips_unexplained": steps.unexplained[:8],
         "launches": counts,
         "inner_loss_cuda": float(m_gpu["inner_loss"]),
         "inner_loss_cpu": float(m_cpu["inner_loss"])})


def phase_wire_kernels(torch, dev):
    """``quantize_pack_int4`` and ``unpack_dequantize_int4`` against their
    plain versions over the whole flat tree and at edge cases, then their
    whole-tree times. Returns their rows."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as QZ
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(7)
    err = {"quantize_pack_int4": 0.0, "unpack_dequantize_int4": 0.0}
    cases = 0

    def hold(x, label):
        nonlocal cases
        n = x.numel()
        want_wire, want_local = ref.wire_encode_int4(x)
        want_dec = ref.wire_decode_int4(want_wire, n)
        wire = torch.empty(ops.wire_elems(n, "int4"), dtype=torch.uint8,
                           device=dev)
        local = torch.empty(n, device=dev)
        QZ.quantize_pack_int4(x, wire, local)
        dec = QZ.unpack_dequantize_int4(want_wire, n)
        torch.cuda.synchronize()
        if not (torch.equal(wire, want_wire) and bits_equal(
                torch, local, want_local)):
            raise SystemExit(f"quantize_pack_int4 on {label}: the kernel "
                             "differs from its plain version")
        if not bits_equal(torch, dec, want_dec):
            raise SystemExit(f"unpack_dequantize_int4 on {label}: the "
                             "kernel differs from its plain version")
        wire.fill_(0xAB)
        QZ.quantize_pack_int4(x, wire)              # without local
        torch.cuda.synchronize()
        if not torch.equal(wire, want_wire):
            raise SystemExit(f"quantize_pack_int4 without local on {label}:"
                             " the wire differs")
        fin = torch.isfinite(want_local)
        if fin.any():
            err["quantize_pack_int4"] = max(err["quantize_pack_int4"], float(
                (local[fin] - want_local[fin]).abs().max()))
            err["unpack_dequantize_int4"] = max(
                err["unpack_dequantize_int4"],
                float((dec[fin] - want_dec[fin]).abs().max()))
        cases += 1
        del want_wire, want_local, want_dec, wire, local, dec

    for n in (1, 2, 3, 5, 127, 128, 129, 300, 1000, 4099, 1_000_003):
        for offset in (0, 1):      # 1: a misaligned input, scalar loads
            hold(torch.randn(n + offset, generator=gen,
                             device=dev)[offset:] * 1e-2,
                 f"n={n} offset {offset}")
    x = torch.randn(8 * 128 + 77, generator=gen, device=dev) * 1e-2
    x[5] = float("nan")
    x[130] = float("inf")
    x[300] = -float("inf")
    x[384:512] = 0.0
    x[512:640] = -0.0
    x[640::3] = -0.0
    hold(x, "NaN, inf, zero and -0.0 blocks")
    dec = QZ.unpack_dequantize_int4(ref.wire_encode_int4(x)[0], x.numel())
    if not (torch.isnan(dec[:384]).all()
            and torch.isfinite(dec[384:]).all()):
        raise SystemExit("wire codecs: a block with a NaN or an infinity "
                         "does not decode all NaN, or the NaN spread")
    X = torch.randn(N_150M, generator=gen, device=dev) * 1e-2
    hold(X, f"the flat diloco_150m tree (n={N_150M})")
    say({"phase": "wire_kernels", "cases": cases, "max_abs_err": err,
         "bitwise": True})

    # one call over the whole flat tree, into preallocated outputs
    n = N_150M
    wire = torch.empty(ops.wire_elems(n, "int4"), dtype=torch.uint8,
                       device=dev)
    local = torch.empty(n, device=dev)
    out = torch.empty(n, device=dev)
    QZ.quantize_pack_int4(X, wire)
    wire_b = wire.numel()
    bw = bandwidth(torch.cuda.get_device_name(0))

    def bound(nbytes, ops_per):
        by_bytes, by_ops = nbytes / bw, n * ops_per / PEAK_F32
        return (max(by_bytes, by_ops) * 1e3,
                "bytes" if by_bytes >= by_ops else "operations")

    pack = {"ms": time_ms(torch, lambda: QZ.quantize_pack_int4(X, wire)),
            "ms_with_local": time_ms(torch, lambda: QZ.quantize_pack_int4(
                X, wire, local)),
            "plain_ms": time_ms(torch, lambda: ref.wire_encode_int4(X),
                                reps=5, warmup=1),
            # no PyTorch call quantizes blockwise and nibble-packs
            "library_ms": None}
    unpack = {"ms": time_ms(torch, lambda: QZ.unpack_dequantize_int4(
                  wire, n, out)),
              "plain_ms": time_ms(torch, lambda: ref.wire_decode_int4(
                  wire, n), reps=5, warmup=1),
              "library_ms": None}
    rows = []
    for name, t, nbytes, nbytes_local, ops_per, line in (
            ("quantize_pack_int4", pack, 4 * n + wire_b,
             8 * n + wire_b, PACK_OPS, 239),
            ("unpack_dequantize_int4", unpack, wire_b + 4 * n, None,
             UNPACK_OPS, 269)):
        b_ms, b_by = bound(nbytes, ops_per)
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/quantize.cu",
               "replaces": f"src/repro/kernels/quantize.py:{line}",
               "launches": None, "max_abs_err": err[name], **t,
               "bound_ms": b_ms, "bound_by": b_by}
        # printed in this phase's line only; the kernels line has bound_ms
        local_bound = {} if nbytes_local is None else {
            "bound_ms_with_local": bound(nbytes_local, ops_per)[0]}
        rows.append(row)
        say({"phase": "wire_kernels", "kernel": name, "elements": n,
             "wire_bytes": wire_b, "bytes": nbytes,
             **{k: v for k, v in row.items() if k.endswith("ms")},
             **local_bound, "bound_by": b_by,
             "kernel_GBps": nbytes / t["ms"] / 1e6})
    del X, wire, local, out
    torch.cuda.empty_cache()
    return rows


def phase_train_async(torch, dev):
    """Slice 5's path at full width through the trainer. Returns {kernel
    name: launches} of the wire codecs."""
    from repro_torch.kernels import ops

    argv = ["--full", "--arch", "diloco_150m", *ASYNC_FLAGS, "--k", str(K),
            "--H", str(H), "--rounds", str(ROUNDS), "--batch", str(BATCH),
            "--seq", str(SEQ), "--eval-batch", "8",
            *trace_flag("train_async")]
    records, timing, wall_s, launches = run_trainer(torch, dev, argv)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    trace = check_trace("train_async", records=records)
    arrivals = [r for r in records if r["event"] == "arrival"]
    n_arr = len(arrivals)
    want = expect_launches(quantize_pack_int4=n_arr,
                           unpack_dequantize_int4=n_arr,
                           outer_nesterov=n_arr * N_LEAVES,
                           fused_adamw=n_arr * H * N_LEAVES)
    if n_arr != 6 or launches != want:
        raise SystemExit(f"train_async: {n_arr} arrivals, launch counts "
                         f"{launches}, expected {want}")
    stale = [r["staleness"] for r in arrivals]
    wire_b = ops.transport_bytes(N_150M, "int4", packed=True)
    if stale != [0, 0, 2, 1, 0, 2] or any(
            r["wire_bytes"] != wire_b or not math.isfinite(r["inner_loss"])
            or not math.isfinite(r["val_loss"]) for r in arrivals):
        raise SystemExit(f"train_async: bad records {arrivals}")
    ev = timing["events"]
    # the first phase pays the card's warm-up; phase 4 reports round 2
    later = ev[1:]
    phase_s = sum(e["phase_s"] for e in later)
    train_s = sum(e["phase_s"] - e["sample_s"] for e in later)
    steps = len(later) * H
    say({"phase": "train_async", "argv": argv, "launches": launches,
         "trace": trace, "staleness": stale,
         "losses": [(r["inner_loss"], r["val_loss"]) for r in arrivals],
         "delta_norm": [r["delta_norm"] for r in arrivals],
         "data_setup_s": timing["data_setup_s"], "events": ev,
         "tokens_per_s": steps * BATCH * SEQ / phase_s,
         "tokens_per_s_without_sampling": steps * BATCH * SEQ / train_s,
         "inner_step_ms": train_s * 1e3 / steps,
         "sample_ms_per_step": (phase_s - train_s) * 1e3 / steps,
         "apply_ms": [e["apply_s"] * 1e3 for e in ev],
         "apply_ms_mean_after_first": sum(e["apply_s"] for e in later)
         * 1e3 / len(later),
         "wire_bytes_per_apply": wire_b,
         "float32_bytes_per_apply": 4 * N_150M, "wall_s": wall_s,
         "max_memory_allocated_GB": peak_gb})
    torch.cuda.empty_cache()
    return {n: launches[n] for n in ("quantize_pack_int4",
                                     "unpack_dequantize_int4")}


def phase_smoke_async(torch, dev):
    """Scenario B of the async parity tests on a tiny config whose leaves
    straddle int4 blocks, int4 with error feedback and bf16, on the card
    against the CPU."""
    from repro_torch import check, convert, tree
    from repro_torch.configs.base import (DiLoCoConfig, ModelConfig,
                                          TrainConfig)
    from repro_torch.core import async_diloco, faults
    from repro_torch.models.registry import Arch

    arch = Arch(cfg=ModelConfig(name="tiny", family="dense", n_layers=2,
                                d_model=40, n_heads=2, n_kv_heads=2,
                                d_ff=72, vocab_size=64, remat=False,
                                attn_chunk=32))
    gen = torch.Generator().manual_seed(0)
    params = arch.init(generator=gen, device="cpu")
    toks = torch.randint(0, 64, (64, 2, 16), generator=gen)
    scen = faults.Scenario(speeds=(1, 2), drop_prob=0.3, max_retries=1,
                           preemptions=((1, 3, 5),), seed=0)
    tcfg = TrainConfig(inner_lr=3e-3, warmup_steps=2, total_steps=64,
                       batch_size=2, seq_len=16)
    for dtype, ef in (("int4", True), ("bfloat16", False)):
        dcfg = DiLoCoConfig(k=2, H=3, transport="async",
                            staleness_lambda=0.7, outer_grad_dtype=dtype,
                            error_feedback=ef)

        def run(device):
            it = iter(toks.to(device))
            eng = async_diloco.AsyncEngine(
                lambda p, b: arch.loss(p, b), lambda g, b, s: next(it),
                dcfg, tcfg, scenario=scen)
            st = eng.init_state(tree.map(lambda t: t.to(device), params))
            st, hist = eng.run(st, ticks=8)
            return convert.async_state_to_numpy(st), hist

        counts0 = read_launches()
        with check.TransportSteps(params, dcfg) as card_steps:
            got, hist = run(dev)
        counts = {n: c - counts0[n] for n, c in read_launches().items()}
        with check.TransportSteps(params, dcfg) as steps:
            want, whist = run(torch.device("cpu"))
        if dtype != "float32":
            steps.explain(card_steps)
        n_arr = sum(r["event"] == "arrival" for r in hist)
        q = n_arr if dtype == "int4" else 0
        phases = sum(r["event"] in ("arrival", "lost") for r in hist)
        leaves = len(tree.leaves(params))
        if counts != expect_launches(quantize_pack_int4=q,
                                     unpack_dequantize_int4=q,
                                     outer_nesterov=n_arr * leaves,
                                     fused_adamw=phases * 3 * leaves):
            raise SystemExit(f"smoke_async {dtype}: launches {counts}")
        if [r["event"] for r in hist] != [r["event"] for r in whist]:
            raise SystemExit(f"smoke_async {dtype}: other events")
        shares = check.async_mismatch_shares(got, want, H=3, steps=steps)
        path = max(shares, key=shares.get)
        if shares[path] > check.TRANSPORT_FLIP_SHARE[dtype]:
            raise SystemExit(f"smoke_async {dtype}: {path}: "
                             f"{shares[path]:.3g} of the entries outside the "
                             "tolerance, or one beyond "
                             f"{steps.allow:.3g} code steps")
        say({"phase": "smoke_async", "transport": dtype,
             "error_feedback": ef, "events": [r["event"] for r in hist],
             "leaves_compared": len(shares),
             "worst_share_outside_tolerance": shares[path],
             "worst_leaf": path, "launches": counts,
             "straddles_explained": sum(steps.explained.values()),
             "flips_unexplained": steps.unexplained[:8],
             "delta_norm_cuda": [r["delta_norm"] for r in hist
                                 if r["event"] == "arrival"],
             "delta_norm_cpu": [r["delta_norm"] for r in whist
                                if r["event"] == "arrival"]})


def phase_codec_kernels(torch, dev):
    """``unpack_dequantize_reduce`` and the four unfused codec pieces
    against their plain versions over the whole flat tree and at edge
    cases, then their whole-tree times. Returns their rows; the unfused
    pieces' launches are those of one call of each through its
    user-facing function."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as QZ
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(8)
    names = ("unpack_dequantize_reduce", "quantize_int4", "dequantize_int4",
             "pack_int4", "unpack_int4")
    err = dict.fromkeys(names, 0.0)
    cases = 0

    def note_err(name, got, want):
        fin = torch.isfinite(want)
        if fin.any():
            err[name] = max(err[name], float((got[fin] - want[fin]).abs()
                                             .max()))

    def hold_reduce(wires, n, m, label):
        nonlocal cases
        k, W = wires.shape
        # the path reads each region in place from a wider gathered buffer
        wide = torch.zeros((k, W + 12), dtype=torch.uint8, device=dev)
        wide[:, 4:4 + W] = wires
        want = ref.wire_reduce_int4(wires, n, m)
        for g in (wires, wide[:, 4:4 + W]):
            got = QZ.unpack_dequantize_reduce(g, n, m)
            torch.cuda.synchronize()
            if not bits_equal(torch, got, want):
                raise SystemExit(f"unpack_dequantize_reduce on {label}: the "
                                 "kernel differs from its plain version")
        note_err("unpack_dequantize_reduce", got, want)
        cases += 1
        return got

    def hold_blocks(x, label):
        nonlocal cases
        codes, scales = QZ.quantize_int4(x)
        wc, ws = ref.quantize_int4(x)
        deq = QZ.dequantize_int4(wc, ws)
        wd = ref.dequantize_int4(wc, ws)
        packed = QZ.pack_int4(wc)
        wp = ref.pack_int4(wc.reshape(-1)).view(-1, 64)
        back = QZ.unpack_int4(wp)
        torch.cuda.synchronize()
        ok = {"quantize_int4": torch.equal(codes, wc) and torch.equal(
                  scales.view(torch.int32), ws.view(torch.int32)),
              "dequantize_int4": bits_equal(torch, deq, wd),
              "pack_int4": torch.equal(packed, wp),
              "unpack_int4": torch.equal(back, wc)}
        bad = [n for n, good in ok.items() if not good]
        if bad:
            raise SystemExit(f"{bad} on {label}: the kernel differs from "
                             "its plain version")
        note_err("dequantize_int4", deq, wd)
        cases += 1

    def wires_of(xs):
        return torch.stack([ref.wire_encode_int4(x)[0] for x in xs])

    for n in (1, 2, 3, 127, 128, 129, 1000, 4099, 1_000_003):
        for k in (2, 4):
            xs = torch.randn(k, n, generator=gen, device=dev) * 1e-2
            m = torch.rand(k, generator=gen, device=dev) + 0.1
            m[k - 1] = 0.0
            hold_reduce(wires_of(xs), n, m, f"n={n} k={k}")
    n = 8 * 128 + 77
    xs = torch.randn(2, n, generator=gen, device=dev) * 1e-2
    xs[0, 5] = float("nan")
    xs[0, 130] = float("inf")
    xs[1, 300] = -float("inf")
    xs[:, 384:512] = 0.0
    xs[:, 512:640] = -0.0
    xs[1, 640::3] = -0.0
    m = torch.tensor([0.75, 0.5], device=dev)
    got = hold_reduce(wires_of(xs), n, m, "NaN, inf, zero and -0.0 blocks")
    if not (torch.isnan(got[:384]).all() and torch.isfinite(got[384:]).all()):
        raise SystemExit("unpack_dequantize_reduce: a block with a NaN or an "
                         "infinity does not reduce to NaN, or the NaN spread")
    wires = wires_of(xs[:1].expand(2, n).contiguous())
    cb, pad, _ = ref.wire_sections(n)
    wires[1, cb + pad:cb + pad + 4] = torch.tensor(
        [float("nan")], device=dev).view(torch.uint8)
    got = hold_reduce(wires, n, torch.tensor([1.0, 0.0], device=dev),
                      "a NaN scale on a masked-out replica")
    if not torch.isnan(got[:128]).all():
        raise SystemExit("unpack_dequantize_reduce: a masked-out replica's "
                         "NaN scale does not poison its block")
    for rows in (1, 3, 1000, 4097):
        for offset in (0, 1):       # 1: misaligned operands, scalar paths
            x = torch.randn(rows * 128 + offset, generator=gen,
                            device=dev)[offset:].view(rows, 128) * 1e-2
            hold_blocks(x, f"{rows} rows offset {offset}")
    x = torch.randn(4, 128, generator=gen, device=dev) * 1e-2
    x[0, 5] = float("nan")
    x[1, 7] = float("inf")
    x[2] = 0.0
    x[3] = -0.0
    hold_blocks(x, "NaN, inf, zero and -0.0 blocks")

    # the whole flat tree: k=2 gathered wires, and its (R, 128) blocks
    N, R = N_150M, N_150M // 128
    X = torch.randn(2, N, generator=gen, device=dev) * 1e-2
    W = ops.wire_elems(N, "int4")
    G = torch.empty((2, W), dtype=torch.uint8, device=dev)
    for j in range(2):
        QZ.quantize_pack_int4(X[j], G[j])
    mk = torch.tensor([0.5, 0.5], device=dev)
    hold_reduce(G, N, mk, f"the flat diloco_150m tree (n={N}, k=2)")
    X2 = X[0].view(R, 128)
    hold_blocks(X2, f"the flat diloco_150m tree (R={R} blocks)")
    say({"phase": "codec_kernels", "cases": cases, "max_abs_err": err,
         "bitwise": True})

    # the unfused pieces' launches: one call of each through its
    # user-facing function (no entry point of either package runs them)
    reset_launches()
    codes, scales = QZ.quantize_int4(X2)
    ops.unpack_int4(ops.pack_int4(codes.reshape(-1)), N)
    QZ.dequantize_int4(codes, scales)
    torch.cuda.synchronize()
    unfused = {n: c for n, c in read_launches().items()
               if n in names[1:]}
    if unfused != dict.fromkeys(names[1:], 1):
        raise SystemExit(f"codec_kernels: launches {unfused}")

    out = torch.empty(N, device=dev)
    packed = QZ.pack_int4(codes)
    bw = bandwidth(torch.cuda.get_device_name(0))

    def bound(nbytes, ops_total):
        by_bytes, by_ops = nbytes / bw, ops_total / PEAK_F32
        return (max(by_bytes, by_ops) * 1e3,
                "bytes" if by_bytes >= by_ops else "operations")

    plain = dict(reps=5, warmup=1)
    timed = {
        "unpack_dequantize_reduce": (
            lambda: QZ.unpack_dequantize_reduce(G, N, mk, out),
            lambda: ref.wire_reduce_int4(G, N, mk),
            2 * W + 4 * N, 2 * N * REDUCE_OPS, 296),
        "quantize_int4": (lambda: QZ.quantize_int4(X2),
                          lambda: ref.quantize_int4(X2),
                          4 * N + N + 4 * R, N * QUANT_INT4_OPS, 143),
        "dequantize_int4": (lambda: QZ.dequantize_int4(codes, scales),
                            lambda: ref.dequantize_int4(codes, scales),
                            N + 4 * R + 4 * N, N * DEQUANT_OPS, 167),
        "pack_int4": (lambda: QZ.pack_int4(codes),
                      lambda: ref.pack_int4(codes.reshape(-1)),
                      N + N // 2, N * PACK_CODE_OPS, 191),
        "unpack_int4": (lambda: QZ.unpack_int4(packed),
                        lambda: ref.unpack_int4(packed.reshape(-1), N),
                        N // 2 + N, N * UNPACK_CODE_OPS, 215),
    }
    rows = []
    for name, (kern, plain_fn, nbytes, ops_total, line) in timed.items():
        t = {"ms": time_ms(torch, kern),
             "plain_ms": time_ms(torch, plain_fn, **plain),
             # no PyTorch call decodes, packs or quantizes int4 blockwise
             "library_ms": None}
        b_ms, b_by = bound(nbytes, ops_total)
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/quantize.cu",
               "replaces": f"src/repro/kernels/quantize.py:{line}",
               "launches": unfused.get(name), "max_abs_err": err[name],
               **t, "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        say({"phase": "codec_kernels", "kernel": name, "elements": N,
             "bytes": nbytes, **{k: v for k, v in row.items()
                                 if k.endswith("ms")},
             "bound_by": b_by, "kernel_GBps": nbytes / t["ms"] / 1e6})
    del X, X2, G, out, codes, scales, packed
    torch.cuda.empty_cache()
    return rows


def sharded_launches(params, P, H_, tau, rounds, dtype, k_loc,
                     resumed=False):
    """Per pod rank, (quantize_pack_int4, unpack_dequantize_reduce,
    outer_nesterov) launches of ``rounds`` sharded rounds of ``params``'
    tree from a fresh state (``resumed``: from one whose every fragment
    has been sent) on the packed int4 wire (0 and 0 for the other
    transports): one encode per local replica and region at each send;
    one reduce per region at each apply when the consume is deferred
    (every apply: the in-flight slots start as zero wires), at the send
    otherwise; one outer_nesterov per region at each apply after the
    fragment's first send."""
    from repro_torch.core import fragments
    part = fragments.partition_params(params, P)
    n_regs = [len(r) for r in fragments.fragment_regions(part, params)]
    int4, deferred = dtype == "int4", tau > 0 and dtype != "float32"
    armed = set(range(P)) if resumed else set()
    enc, red, nest = 0, 0, 0
    for _ in range(rounds):
        for _, events in fragments.schedule(P, H_, tau).phases:
            for ev in events:
                f = ev.fragment
                if ev.kind == "send":
                    armed.add(f)
                    enc += k_loc * n_regs[f] * int4
                    red += n_regs[f] * (int4 and not deferred)
                else:
                    red += n_regs[f] * (int4 and deferred)
                    nest += n_regs[f] * (f in armed)
    return enc, red, nest


def phase_train_sharded(torch, dev, pods=2, k=K):
    """Slice 6's path at full width through the trainer on ``pods`` ranks
    of one replica each (``k`` replicas), then float32 rounds. Returns
    ({kernel name: launches} of unpack_dequantize_reduce, the int4 run's
    ``PodGroup.traffic`` of each rank)."""
    from repro_torch.models.registry import get_arch

    meta = get_arch("diloco_150m").init(generator=None, device="meta")
    sizes = ["--k", str(k), "--H", str(H), "--batch", str(BATCH), "--seq",
             str(SEQ), "--eval-batch", "8"]
    k_loc = k // pods
    out = {}
    for label, flags, rounds, P, tau, dtype in (
            ("int4", STREAM_FLAGS, ROUNDS, 4, 2, "int4"),
            ("float32", ["--stream-fragments", "2", "--stream-alpha", "0.5"],
             ROUNDS, 2, 0, "float32")):
        argv = ["--full", "--arch", "diloco_150m", "--transport",
                "sharded", "--pods", str(pods), *flags, "--rounds",
                str(rounds), *sizes]
        if tau:
            argv += trace_flag(f"train_sharded_{label}_{pods}")
        torch.cuda.empty_cache()
        manifest = {}
        records, timing, wall_s, launches = run_trainer(torch, dev, argv,
                                                        manifest)
        enc, red, nest = sharded_launches(meta, P, H, tau, rounds, dtype,
                                          k_loc)
        per_rank = expect_launches(
            quantize_pack_int4=enc, unpack_dequantize_reduce=red,
            outer_nesterov=nest, fused_adamw=k_loc * H * rounds * N_LEAVES)
        ranks = manifest["ranks"]
        got = [flat_launches(r["launches"]) for r in ranks]
        if len(ranks) != pods or any(g != per_rank for g in got) or \
                launches != {n: c * pods for n, c in per_rank.items()}:
            raise SystemExit(f"train_sharded {label}: launches {got}, "
                             f"expected {per_rank} on each rank")
        losses, _ = check_records(records, f"train_sharded {label}", 0.0,
                                  rounds=rounds)
        trace = check_trace(f"train_sharded_{label}_{pods}", tau=tau) \
            if tau else None
        plan = manifest["wire_plan"]
        per_round = sum(p["wire_bytes"] for p in plan)
        want_traffic = {"wire_bytes": k_loc * rounds * per_round,
                        "gather_wire": rounds * P * (dtype != "float32"),
                        "all_reduce": rounds * (P * (dtype == "float32")
                                                + 2)}
        for r in ranks:
            t = r["traffic"]
            if any(t[n] != v for n, v in want_traffic.items()):
                raise SystemExit(f"train_sharded {label}: rank {r['rank']} "
                                 f"traffic {t}, plan {want_traffic}")
        note = next(n["note"] for n in manifest["notes"]
                    if n["note"].startswith("sharded transport"))
        last = [r["timing"]["rounds"][-1] for r in ranks]
        slowest = max(x["inner_s"] for x in last)
        rnds = [r for r in records if r["phase"] == "diloco"]
        say({"phase": "train_sharded", "transport": label, "pods": pods,
             "argv": argv, "trace": trace,
             "note": note, "launches_per_rank": got[0],
             "losses": losses, "data_setup_s": timing["data_setup_s"],
             "rounds_per_rank": [r["timing"]["rounds"] for r in ranks],
             "inner_step_ms_per_rank": [x["inner_s"] * 1e3 / (k_loc * H)
                                        for x in last],
             "tokens_per_s_per_rank": [k_loc * H * BATCH * SEQ / x["inner_s"]
                                       for x in last],
             "tokens_per_s": k * H * BATCH * SEQ / slowest,
             "inner_step_ms_aggregate": slowest * 1e3 / (k * H),
             "outer_ms_per_round_per_rank": [x["outer_s"] * 1e3
                                             for x in last],
             "gather_wait_ms_per_round_per_rank": [x["wait_s"] * 1e3
                                                   for x in last],
             "sample_ms_per_rank": [x["sample_s"] * 1e3 for x in last],
             "traffic_per_rank": [r["traffic"] for r in ranks],
             "plan_wire_bytes_per_round": per_round,
             "stream_round_sync_bytes": rnds[-1]["stream_round_sync_bytes"],
             "max_memory_allocated_GB_per_rank": [
                 r["max_memory_allocated"] / 1e9 for r in ranks],
             "parent_max_memory_allocated_GB":
                 torch.cuda.max_memory_allocated(dev) / 1e9,
             "wall_s": wall_s})
        out[label] = launches, [r["traffic"] for r in ranks]
    return ({"unpack_dequantize_reduce":
             out["int4"][0]["unpack_dequantize_reduce"]}, out["int4"][1])


def phase_smoke_sharded(torch, dev, pods=2):
    """Two sharded rounds of the smoke config (P=2, τ=1, α=0.5, int4 with
    error feedback, the packed wire) on ``pods`` ranks of one replica
    each on the card(s) against as many gloo ranks on the CPU."""
    import numpy as np
    from repro_torch import check
    from repro_torch.configs.base import DiLoCoConfig, TrainConfig
    from repro_torch.launch import mesh
    from repro_torch.models.registry import get_smoke_arch

    k, h, b, s, rounds = pods, 2, 2, 64, 2
    arch = get_smoke_arch("diloco_150m")
    gen = torch.Generator().manual_seed(0)
    params = arch.init(generator=gen, device="cpu")
    toks = torch.randint(0, arch.cfg.vocab_size, (rounds, k, h * b, s),
                         generator=gen)
    dcfg = DiLoCoConfig(k=k, H=h, streaming_fragments=2, stream_tau=1,
                        stream_alpha=0.5, outer_grad_dtype="int4",
                        error_feedback=True, transport="sharded")
    tcfg = TrainConfig(inner_lr=1e-3, warmup_steps=2, total_steps=8,
                       batch_size=b, seq_len=s)
    ones = np.ones(k, np.float32)
    masks = [(ones, ones, ones / k)] * rounds
    res, backend = {}, None
    for where in ("cuda", "cpu"):
        layout = mesh.make_pod_layout(pods, where)
        backend = backend or mesh.describe(layout)
        res[where] = mesh.spawn("repro_torch.launch.pod_rounds:rounds",
                                layout, arch.cfg, dcfg, tcfg, toks, masks,
                                params, None, None, True)
    enc, red, nest = sharded_launches(
        arch.init(generator=None, device="meta"), 2, h, 1, rounds, "int4",
        k // pods)
    want = expect_launches(quantize_pack_int4=enc,
                           unpack_dequantize_reduce=red, outer_nesterov=nest,
                           fused_adamw=(k // pods) * h * rounds * N_LEAVES)
    counts = [flat_launches(r["launches"]) for r in res["cuda"]]
    if any(c != want for c in counts):
        raise SystemExit(f"smoke_sharded: launches {counts}, expected "
                         f"{want} on each rank")
    for where, rs in res.items():
        if len({r["shared"] for r in rs}) != 1:
            raise SystemExit(f"smoke_sharded: the shared state differs "
                             f"between the {where} ranks")
    # each rank's sends, card against CPU: a code that differs is
    # explained only as a straddle within the float32 bound (``check.py``)
    steps = check.TransportSteps.of_ranks(
        params, dcfg, [r["sends"] for r in res["cpu"]],
        [r["sends"] for r in res["cuda"]])
    shares = check.stream_mismatch_shares(res["cuda"][0]["state"],
                                          res["cpu"][0]["state"], H=h,
                                          steps=steps)
    path = max(shares, key=shares.get)
    if shares[path] > check.TRANSPORT_FLIP_SHARE["int4"]:
        raise SystemExit(f"smoke_sharded: {path}: {shares[path]:.3g} of the "
                         "entries outside the tolerance, or one beyond "
                         f"{steps.allow:.3g} code steps; unexplained flips "
                         f"{steps.unexplained[:8]}")
    say({"phase": "smoke_sharded", "k": k, "pods": pods, "H": h,
         "card_backend": backend,
         "rounds": rounds, "P": 2, "tau": 1, "alpha": 0.5,
         "transport": "int4", "error_feedback": True, "packed": True,
         "leaves_compared": len(shares),
         "worst_share_outside_tolerance": shares[path], "worst_leaf": path,
         "straddles_explained": {p: n for p, n in steps.explained.items()
                                 if n},
         "flips_unexplained": steps.unexplained[:8],
         "launches_per_card_rank": counts[0],
         "inner_loss_cuda": [m["inner_loss"]
                             for m in res["cuda"][0]["metrics"]],
         "inner_loss_cpu": [m["inner_loss"]
                            for m in res["cpu"][0]["metrics"]]})

# ---------------------------------------------------------------------------
# slice 10: the chunked round driver, snapshots, resume, the guard and the
# first milestone, on diloco_60m
# ---------------------------------------------------------------------------

# the snapshot, guard, milestone and sharded snapshots' phases (23-26)
# run diloco_60m at smoke width (cut so that the script's phases fit its
# time: 24 and 26 when the hybrid island phase came, 23 and 25 when the
# xLSTM one did; the snapshots' costs at full width are PERF.md's)
SMOKE_B, SMOKE_S = 2, 32
SMOKE_60M = ["--arch", "diloco_60m", "--k", str(K), "--batch",
             str(SMOKE_B), "--seq", str(SMOKE_S), "--eval-batch", "2"]
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
# the milestone's card-against-CPU bound on every round's inner and val
# loss (absolute): over its ten smoke-width rounds the card (TF32 off)
# and the CPU differ by at most 9.5e-7 in both (NVIDIA H100 80GB HBM3,
# 700 W); the bound is 20 times that, as the CPU test's bound against JAX
MILESTONE_CARD_TOL = 2e-5


def leaves_60m() -> int:
    from repro_torch import tree
    from repro_torch.models.registry import get_arch
    return len(tree.leaves(get_arch("diloco_60m").init(generator=None,
                                                      device="meta")))


def sync_launches(rounds, h=H, k=K) -> dict:
    """The launches of ``rounds`` classic f32 rounds of diloco_60m."""
    n = leaves_60m()
    return expect_launches(fused_adamw=k * h * rounds * n,
                           outer_nesterov=rounds * n)


def read_hash(path) -> dict:
    with open(path) as f:
        return json.load(f)


def phase_resume(torch, dev):
    """Phase 23: an uncut run with snapshots, the same run resumed from its
    snapshot after round 2, and the per-round loop with no snapshots:
    one final state (sha256)."""
    import shutil

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    try:
        argv = SMOKE_60M + ["--H", str(H), "--rounds", "4",
                            "--rounds-per-call", "2"]
        snap = ["--checkpoint-dir", str(CKPT_DIR / "d"),
                "--checkpoint-every", "2", "--retain", "2"]
        out = {}
        # the resumed run reads the uncut run's snapshot 2 and writes none
        # (its final state is checked by the hash, not by a snapshot)
        for name, extra, rounds in (
                ("uncut", snap, 4),
                ("resumed", snap[:2] + ["--resume", "2"], 2),
                ("legacy", ["--legacy-loop"], 4)):
            path = str(CKPT_DIR / f"{name}.json")
            man = {}
            records, timing, wall_s, launches = run_trainer(
                torch, dev, argv + extra + ["--state-hash-out", path], man)
            if launches != sync_launches(rounds):
                raise SystemExit(f"resume: {name}: launches {launches}, "
                                 f"expected {sync_launches(rounds)}")
            check_records(records, f"resume {name}", 0.0, rounds=rounds)
            if name == "uncut":
                kept = sorted(p.name for p in (CKPT_DIR / "d").glob("*.npz"))
                if kept != ["ckpt_00000002.npz", "ckpt_00000004.npz"]:
                    raise SystemExit(f"resume: --retain 2 left {kept}")
            out[name] = (read_hash(path), timing, wall_s)
        want = out["uncut"][0]
        for name in ("resumed", "legacy"):
            got = out[name][0]
            if got["state_sha256"] != want["state_sha256"]:
                diff = sorted(k for k, v in got["leaf_sha256"].items()
                              if want["leaf_sha256"][k] != v)
                raise SystemExit(f"resume: {name} state differs from the "
                                 f"uncut run's in {len(diff)} leaves: "
                                 f"{diff[:8]}")
        snaps = out["uncut"][1]["snapshots"]
        res = out["resumed"][1]
        last = out["uncut"][1]["rounds"][-1]
        say({"phase": "resume", "argv": argv + snap,
             "state_sha256": want["state_sha256"],
             "resumed_from_step": out["resumed"][0]["resumed_from_step"],
             "ingest_calls": {n: o[0]["ingest_calls"]
                              for n, o in out.items()},
             "snapshot_bytes": snaps[0]["bytes"],
             "save_ms": [x["save_s"] * 1e3 for x in snaps],
             "save_parts_ms": [{p: x[f"{p}_s"] * 1e3 for p in (
                 "copy", "write", "manifest")} for x in snaps],
             "verify_ms": res["resume"]["verify_s"] * 1e3,
             "load_ms": res["loads"][0]["load_s"] * 1e3,
             "disk_free_GB": shutil.disk_usage(CKPT_DIR).free / 1e9,
             "inner_step_ms": last["inner_s"] * 1e3 / (K * H),
             "tokens_per_s": K * H * SMOKE_B * SMOKE_S / last["inner_s"],
             "wall_s": {n: o[2] for n, o in out.items()}})
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


def guard_argv(d) -> list:
    return ["--H", str(H), "--rounds", "3", "--nan-bomb", "1:1", "--guard",
            "--checkpoint-dir", str(d), "--checkpoint-every", "1"]


def guard_events(records) -> list:
    return [(r["event"], r["round"]) for r in records
            if r["kind"] == "event"]


def phase_guard(torch, dev):
    """Phase 24: worker 1's outer gradient poisoned in round 2 (index 1):
    the guard sees the NaN val loss, rolls back to the snapshot after
    round 1 and replays round 2 with the in-graph guard armed, which
    rejects the poisoned replica, then runs round 3; the same guard
    events as a CPU run of the same flags at smoke width."""
    import shutil

    from repro_torch.launch import train
    from repro_torch.obs.metrics import RunRecorder

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        man = {}
        records, timing, wall_s, launches = run_trainer(
            torch, dev, SMOKE_60M + guard_argv(CKPT_DIR / "card"), man)
        events = guard_events(records)
        rnds = [r for r in records if r["phase"] == "diloco"]
        replay = [r for r in rnds if "guard_rejected" in r]
        notes = [n["note"] for n in man.get("notes", ())]
        if launches != sync_launches(4):          # round 2 ran twice
            raise SystemExit(f"guard: launches {launches}, expected "
                             f"{sync_launches(4)}")
        if events != [("anomaly", 1), ("rollback", 1)] or not any(
                "in-graph guard armed" in n for n in notes):
            raise SystemExit(f"guard: events {events}, notes {notes}")
        if [(r["round"], r["guard_rejected"]) for r in replay] != [
                (2, 1.0), (3, 0.0)]:
            raise SystemExit(f"guard: replayed rounds {replay}")
        if not all(math.isfinite(r["inner_loss"])
                   and math.isfinite(r["val_loss"]) for r in replay):
            raise SystemExit(f"guard: the replay is not finite: {replay}")
        args = train.make_parser().parse_args(
            ["--device", "cpu", *SMOKE_60M, *guard_argv(CKPT_DIR / "cpu")])
        cpu = guard_events(train.run(args, recorder=RunRecorder(
            printer=lambda *a, **kw: None)))
        if cpu != events:
            raise SystemExit(f"guard: card events {events}, CPU {cpu}")
        say({"phase": "guard", "argv": SMOKE_60M + guard_argv("D"),
             "events": events, "cpu_events": cpu,
             "rounds": [(r["round"], str(r["val_loss"]),
                         r.get("guard_rejected")) for r in rnds],
             "launches": launches, "snapshot_save_ms": [
                 x["save_s"] * 1e3 for x in timing["snapshots"]],
             "rollback_load_ms": timing["loads"][0]["load_s"] * 1e3,
             "wall_s": wall_s})
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


def smoke_milestone(torch, device, params, toks, val, rounds, k, h):
    """``rounds`` rounds of diloco_60m's smoke config through one
    ``make_run`` call on ``device``, on the given tokens. Returns the
    per-round (inner losses, val losses) as lists."""
    from repro_torch import tree
    from repro_torch.configs.base import DiLoCoConfig, TrainConfig
    from repro_torch.core import diloco
    from repro_torch.models.registry import get_smoke_arch

    arch = get_smoke_arch("diloco_60m")
    toks = toks.to(device)
    drawn = iter(range(rounds))
    b, s = toks.shape[2] // h, toks.shape[3]
    dcfg = DiLoCoConfig(k=k, H=h)
    run = diloco.make_run(
        lambda p, bt: arch.loss(p, bt), lambda g, bb, ss: toks[next(drawn)],
        dcfg, TrainConfig(inner_lr=1e-3, warmup_steps=4,
                          total_steps=rounds * h),
        rounds_per_call=rounds, batch_size=b, seq_len=s,
        eval_tokens=val.to(device), eval_every=1)
    st = diloco.init_state(tree.map(lambda t: t.to(device), params), dcfg)
    st, m = run(st, None)
    return m["inner_loss"].tolist(), m["val_loss"].tolist()


MILESTONE_ROUNDS = 8


def phase_milestone(torch, dev):
    """Phase 25: diloco_60m at smoke width for 8 rounds of H=8 (128
    replica-steps), every round's losses beside the entropy floor; then
    ten rounds of its smoke config through ``make_run`` on the card and
    on the CPU, every round's inner and val loss within
    MILESTONE_CARD_TOL."""
    from repro_torch.data.sharding import make_regime
    from repro_torch.models.registry import get_smoke_arch

    argv = SMOKE_60M + ["--H", "8", "--rounds", str(MILESTONE_ROUNDS),
                        "--warmup", "20", "--rounds-per-call", "4",
                        "--eval-every", "2"]
    records, timing, wall_s, launches = run_trainer(torch, dev, argv)
    if launches != sync_launches(MILESTONE_ROUNDS, h=8):
        raise SystemExit(f"milestone: launches {launches}, expected "
                         f"{sync_launches(MILESTONE_ROUNDS, h=8)}")
    rnds = [r for r in records if r["phase"] == "diloco"]
    vals = [r["val_loss"] for r in rnds if r["val_loss"] is not None]
    if len(rnds) != MILESTONE_ROUNDS or not all(math.isfinite(r["inner_loss"])
                                  for r in rnds) \
            or not all(math.isfinite(v) for v in vals) \
            or not vals[-1] < vals[0]:
        raise SystemExit(f"milestone: rounds {rnds}")
    from repro_torch.launch import train
    floor = shared_sampler(torch, dev, train.make_parser().parse_args(
        argv)).entropy_floor()

    rounds, k, h, b, s = 10, 2, 4, 2, 64
    arch = get_smoke_arch("diloco_60m")
    gen = torch.Generator().manual_seed(0)
    params = arch.init(generator=gen, device="cpu")
    markov = make_regime("non_iid", k=k, vocab_size=arch.cfg.vocab_size,
                         device="cpu")
    toks = torch.stack([markov.sample_all_shards(gen, h * b, s)[:k]
                        for _ in range(rounds)])
    val = markov.sample_validation(gen, 4, s)
    got = smoke_milestone(torch, dev, params, toks, val, rounds, k, h)
    want = smoke_milestone(torch, torch.device("cpu"), params, toks, val,
                           rounds, k, h)
    diffs = [max(abs(x - y) for x, y in zip(g, w))
             for g, w in zip(got, want)]
    if not max(diffs) <= MILESTONE_CARD_TOL:
        raise SystemExit(f"milestone: card against CPU {diffs} beyond "
                         f"{MILESTONE_CARD_TOL}: {got} {want}")
    last = timing["rounds"][-1]
    say({"phase": "milestone", "argv": argv, "entropy_floor": floor,
         "inner_loss": [r["inner_loss"] for r in rnds],
         "val_loss": [r["val_loss"] for r in rnds],
         "launches": launches,
         "inner_step_ms": last["inner_s"] * 1e3 / (K * 8),
         "tokens_per_s": K * 8 * SMOKE_B * SMOKE_S / last["inner_s"],
         "wall_s": wall_s,
         "smoke": {"rounds": rounds, "k": k, "H": h, "batch": b, "seq": s,
                   "max_abs_diff_inner": diffs[0],
                   "max_abs_diff_val": diffs[1],
                   "tol": MILESTONE_CARD_TOL,
                   "inner_loss_cuda": got[0], "val_loss_cuda": got[1],
                   "inner_loss_cpu": want[0], "val_loss_cpu": want[1]}})


# ---------------------------------------------------------------------------
# slice 11: snapshots, the crash, the guard and the elastic resume on the
# sharded transport; the gossip transport
# ---------------------------------------------------------------------------

# phase 27's guard: the loss goes non-finite in round 2 under a huge inner
# lr, and rank 0's guard rolls every rank back twice (its budget)
GUARD_NAN = ["--inner-lr", "1e30", "--warmup", "4", "--guard",
             "--checkpoint-every", "1"]


def npz_equal(a, b) -> list:
    """The entries in which two npz files differ (bytes, dtype, shape or
    presence); empty when they are equal bit for bit."""
    import numpy as np
    with np.load(a) as x, np.load(b) as y:
        keys = sorted(set(x.files) | set(y.files))
        return [k for k in keys if k not in x.files or k not in y.files
                or x[k].dtype != y[k].dtype or x[k].shape != y[k].shape
                or x[k].tobytes() != y[k].tobytes()]


def leaves_differ(got, want) -> list:
    return sorted(k for k, v in got["leaf_sha256"].items()
                  if want["leaf_sha256"].get(k) != v)


# phase 26's directory: its crash run starts before phase 23 and must
# outlive the directories phases 23-25 delete
SHARDED_CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt_sharded"
SHARDED_SNAP = ["--rounds-per-call", "2", "--checkpoint-every", "2",
                "--retain", "1"]


# phase 26's rounds: the killed run's snapshot after round 2, then one
# round resumed
SHARDED_RESUME_ROUNDS = 3


def sharded_resume_argv() -> list:
    return SMOKE_60M + ["--H", str(H), "--rounds",
                       str(SHARDED_RESUME_ROUNDS), "--transport", "sharded",
                       "--pods", "2", *STREAM_FLAGS]


class CrashRun:
    """Phase 26's killed run: the trainer subprocess with ``--crash-at-round
    2``, started before phase 23 so that its Markov table build and its
    two rounds overlap phases 23-25; ``stop`` kills it if it still runs
    and closes its logs."""

    def __init__(self):
        import shutil
        import uuid

        from repro_torch.resilience import harness
        shutil.rmtree(SHARDED_CKPT_DIR, ignore_errors=True)
        SHARDED_CKPT_DIR.mkdir(parents=True)
        self.tag = uuid.uuid4().hex
        self.logs = [open(SHARDED_CKPT_DIR / f"crash.{x}", "w+")
                     for x in ("out", "err")]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            harness.train_cmd(sharded_resume_argv() + SHARDED_SNAP + [
                "--checkpoint-dir", str(SHARDED_CKPT_DIR / "c"),
                "--crash-at-round", "2"]),
            env=harness.train_env({"REPRO_CRASH_RUN": self.tag}),
            stdout=self.logs[0], stderr=self.logs[1], text=True)

    def stop(self):
        import shutil
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for f in self.logs:
            f.close()
        shutil.rmtree(SHARDED_CKPT_DIR, ignore_errors=True)


def phase_resume_sharded(torch, dev, crash: CrashRun):
    """Phase 26: diloco_60m at smoke width on two sharded ranks with
    snapshots, 3 rounds: the uncut run, the same run killed by
    ``--crash-at-round 2`` in a trainer subprocess (``crash``, started
    before phase 23), and ``--resume auto`` of the killed run's snapshot
    (which writes none of its own): one final state (sha256)."""
    from repro_torch.models.registry import get_smoke_arch
    from repro_torch.resilience import CheckpointManager, harness

    torch.cuda.empty_cache()
    D = SHARDED_CKPT_DIR
    argv = sharded_resume_argv()
    logs, tag = crash.logs, crash.tag
    try:
        meta = get_smoke_arch("diloco_60m").init(generator=None,
                                                 device="meta")
        n = leaves_60m()
        out = {}
        # the uncut run's one snapshot, at its end, is the one timed
        uncut_snap = ["--rounds-per-call", "2", "--checkpoint-every",
                      str(SHARDED_RESUME_ROUNDS), "--retain", "1"]
        for name, extra, rounds, resumed in (
                ("uncut", uncut_snap + ["--checkpoint-dir", str(D / "u")],
                 SHARDED_RESUME_ROUNDS, False),
                ("resumed", ["--rounds-per-call", "2", "--checkpoint-dir",
                             str(D / "c"), "--resume", "auto"],
                 SHARDED_RESUME_ROUNDS - 2, True)):
            if resumed:
                t_c = time.perf_counter()
                crash.proc.wait(timeout=600)
                crash_wait_s = time.perf_counter() - t_c
                crash_s = time.perf_counter() - crash.t0
                so, se = (f.seek(0) or f.read() for f in logs)
                left = harness.processes_with("REPRO_CRASH_RUN", tag)
                if crash.proc.returncode != harness.SIGKILL_RC or \
                        "crash: SIGKILL at round boundary 3" not in so or left:
                    raise SystemExit(
                        f"resume_sharded: the crash run exited with "
                        f"{crash.proc.returncode}, ranks left {left}\n"
                        f"{so[-2000:]}\n{se[-4000:]}")
                kept = CheckpointManager(str(D / "c")).steps()
                if kept != [2]:
                    raise SystemExit(f"resume_sharded: the crash left "
                                     f"snapshots {kept}")
            path = str(D / f"{name}.json")
            man = {}
            records, timing, wall_s, launches = run_trainer(
                torch, dev, argv + extra + ["--state-hash-out", path], man)
            enc, red, nest = sharded_launches(meta, 4, H, 2, rounds, "int4",
                                              1, resumed=resumed)
            per_rank = expect_launches(
                quantize_pack_int4=enc, unpack_dequantize_reduce=red,
                outer_nesterov=nest, fused_adamw=H * rounds * n)
            got = [flat_launches(r["launches"]) for r in man["ranks"]]
            if any(g != per_rank for g in got):
                raise SystemExit(f"resume_sharded {name}: launches {got}, "
                                 f"expected {per_rank} on each rank")
            check_records(records, f"resume_sharded {name}", 0.0,
                          rounds=rounds)
            out[name] = (read_hash(path), man, wall_s, got[0])
        want, got = out["uncut"][0], out["resumed"][0]
        if got["state_sha256"] != want["state_sha256"]:
            diff = leaves_differ(got, want)
            raise SystemExit(f"resume_sharded: the resumed state differs "
                             f"from the uncut run's in {len(diff)} leaves: "
                             f"{diff[:8]}")
        res = out["resumed"][1]
        r0 = res["ranks"][0]["timing"]
        snaps = {n: o[1]["timing"].get("snapshots", [])
                 for n, o in out.items()}
        say({"phase": "resume_sharded", "argv": argv,
             "state_sha256": want["state_sha256"],
             "resumed_from_step": got["resumed_from_step"],
             "crash_rc": crash.proc.returncode, "crash_s": crash_s,
             "crash_wait_s": crash_wait_s,
             "snapshot_bytes": snaps["uncut"][0]["bytes"],
             "gather_ms": {n: [x["gather_s"] * 1e3 for x in s]
                           for n, s in snaps.items()},
             "save_ms": {n: [x["save_s"] * 1e3 for x in s]
                         for n, s in snaps.items()},
             "verify_ms": res["timing"]["resume"]["verify_s"] * 1e3,
             "load_ms_per_rank": [r["timing"]["loads"][0]["load_s"] * 1e3
                                  for r in res["ranks"]],
             "band_ms_per_rank": [r["timing"]["loads"][0]["band_s"] * 1e3
                                  for r in res["ranks"]],
             "launches_per_rank": {n: o[3] for n, o in out.items()},
             "traffic_per_rank": [r["traffic"] for r in res["ranks"]],
             "inner_step_ms_per_rank": [
                 x["timing"]["rounds"][-1]["inner_s"] * 1e3 / H
                 for x in res["ranks"]],
             "rank0_rounds": r0["rounds"],
             "wall_s": {n: o[2] for n, o in out.items()}})
    finally:
        crash.stop()


def phase_elastic_sharded(torch, dev):
    """Phase 27, smoke width, k=4: a pods=2 run with a snapshot every 2
    rounds; the round-2 snapshot resumed with ``--pods 4`` (four gloo
    ranks on the card) ends bit for bit at the uncut run's state, and the
    snapshot banded over 4 ranks and gathered back is the file bit for
    bit; then the sharded guard rollback on the card against the CPU."""
    import shutil

    from repro_torch import tree
    from repro_torch.configs.base import DiLoCoConfig
    from repro_torch.launch import mesh, train
    from repro_torch.models.registry import get_smoke_arch
    from repro_torch.obs.metrics import RunRecorder

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    try:
        flags = ["--arch", "diloco_60m", "--k", "4", "--H", "2", "--batch",
                 "2", "--seq", "64", "--eval-batch", "2", "--transport",
                 "sharded", "--stream-fragments", "2", "--stream-tau", "1",
                 "--stream-alpha", "0.5", "--outer-grad-dtype", "int4",
                 "--error-feedback", "--rounds-per-call", "2"]
        d = str(CKPT_DIR / "e")
        argv = flags + ["--rounds", "4", "--checkpoint-dir", d,
                        "--checkpoint-every", "2"]
        arch = get_smoke_arch("diloco_60m")
        meta = arch.init(generator=None, device="meta")
        n = len(tree.leaves(meta))

        def per_rank(k_loc, fresh, resumed):
            """The launches on each rank of ``fresh`` rounds from a fresh
            state and then ``resumed`` rounds with every fragment sent."""
            counts = [sharded_launches(meta, 2, 2, 1, r, "int4", k_loc,
                                       resumed=res)
                      for r, res in ((fresh, False), (resumed, True))]
            enc, red, nest = (sum(c) for c in zip(*counts))
            return expect_launches(
                quantize_pack_int4=enc, unpack_dequantize_reduce=red,
                outer_nesterov=nest,
                fused_adamw=k_loc * 2 * (fresh + resumed) * n)

        def trainer(label, argv_, want):
            man = {}
            records, _, wall_s, _ = run_trainer(torch, dev, argv_, man)
            got = [flat_launches(r["launches"]) for r in man["ranks"]]
            if any(g != want for g in got):
                raise SystemExit(f"elastic_sharded {label}: launches "
                                 f"{got}, expected {want} on each rank")
            return records, man, wall_s

        hashes, walls = {}, {}
        for name, extra, pods, fresh, resumed in (
                ("pods2", ["--pods", "2"], 2, 4, 0),
                ("pods4_resumed", ["--pods", "4", "--resume", "2"], 4, 0,
                 2)):
            path = str(CKPT_DIR / f"{name}.json")
            records, man, walls[name] = trainer(
                name, argv + extra + ["--state-hash-out", path],
                per_rank(4 // pods, fresh, resumed))
            check_records(records, f"elastic_sharded {name}", 0.0,
                          rounds=fresh + resumed)
            if len(man["ranks"]) != pods:
                raise SystemExit(f"elastic_sharded {name}: "
                                 f"{len(man['ranks'])} ranks")
            hashes[name] = read_hash(path)
        want, got = hashes["pods2"], hashes["pods4_resumed"]
        if got["state_sha256"] != want["state_sha256"]:
            diff = leaves_differ(got, want)
            raise SystemExit(f"elastic_sharded: pods 4 resumed differs "
                             f"from pods 2 in {len(diff)} leaves: "
                             f"{diff[:8]}")
        dcfg = DiLoCoConfig(k=4, H=2, streaming_fragments=2, stream_tau=1,
                            stream_alpha=0.5, outer_grad_dtype="int4",
                            error_feedback=True, transport="sharded")
        snap = str(CKPT_DIR / "e" / "ckpt_00000002.npz")
        back = str(CKPT_DIR / "back.npz")
        t0 = time.perf_counter()
        bands = mesh.spawn("repro_torch.launch.pod_rounds:reband",
                           mesh.make_pod_layout(4, "cuda"), arch.cfg, dcfg,
                           snap, back)
        reband_s = time.perf_counter() - t0
        diff = npz_equal(snap, back)
        if bands != [1, 1, 1, 1] or diff:
            raise SystemExit(f"elastic_sharded: rebanded over 4 ranks "
                             f"({bands}) the snapshot differs in {diff}")
        # the guard: card ranks against CPU ranks, the same events
        g = flags[:2] + ["--k", "2"] + flags[4:] + ["--rounds", "4",
                                                    "--pods", "2"]
        events = {}
        # round 1 fresh, then rounds 2-4 with round 2 run three times
        records, _, walls["guard"] = trainer(
            "guard", g + GUARD_NAN + ["--checkpoint-dir",
                                      str(CKPT_DIR / "gc")],
            per_rank(1, 1, 5))
        events["cuda"] = guard_events(records)
        args = train.make_parser().parse_args(
            ["--device", "cpu", *g, *GUARD_NAN, "--checkpoint-dir",
             str(CKPT_DIR / "gh")])
        events["cpu"] = guard_events(train.run(args, recorder=RunRecorder(
            printer=lambda *a, **kw: None)))
        want_ev = [("anomaly", 1), ("rollback", 1)] * 2 + [
            ("anomaly", 1), ("anomaly", 2), ("anomaly", 3)]
        if events["cuda"] != want_ev or events["cpu"] != want_ev:
            raise SystemExit(f"elastic_sharded: guard events {events}")
        say({"phase": "elastic_sharded", "argv": argv,
             "state_sha256": want["state_sha256"], "bit_equal": True,
             "reband_s": reband_s, "guard_events": events["cuda"],
             "guard_argv": g + GUARD_NAN, "wall_s": walls})
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)


def gossip_rounds(torch, device, params, toks, drops, rounds, k, h):
    """``rounds`` gossip rounds (random pairing, mix 0.5, P=2, bf16
    exchange) of diloco_60m's smoke config on ``device`` on the given
    tokens and drop masks. Returns (its DiLoCoConfig, the state in
    ``convert``'s numpy form, the edges of each round's partner map)."""
    from repro_torch import convert, tree
    from repro_torch.configs.base import DiLoCoConfig, TrainConfig
    from repro_torch.core import gossip
    from repro_torch.models.registry import get_smoke_arch

    arch = get_smoke_arch("diloco_60m")
    dcfg = DiLoCoConfig(k=k, H=h, transport="gossip",
                        gossip_pairing="random", streaming_fragments=2,
                        outer_grad_dtype="bfloat16")
    b, s = toks.shape[2] // h, toks.shape[3]
    tcfg = TrainConfig(inner_lr=1e-3, warmup_steps=2, total_steps=rounds * h,
                       batch_size=b, seq_len=s)
    edges = []

    def partner_fn(t):
        pm = gossip.partner_map(k, t, "random", seed=tcfg.seed)
        edges.append(gossip.edges_of(pm))
        return pm

    rnd = gossip.make_gossip_round_body(
        lambda p, bt: arch.loss(p, bt), lambda r, bb, ss: toks[r].to(device),
        dcfg, tcfg, partner_fn=partner_fn)
    st = gossip.init_state(tree.map(lambda t: t.to(device), params), dcfg)
    for r in range(rounds):
        st, _ = rnd(st, r, drops[r], None, None)
    return dcfg, convert.gossip_state_to_numpy(st), edges


def phase_train_gossip(torch, dev):
    """Phase 28: the gossip transport at full width through the trainer
    (diloco_150m, butterfly, mix 0.5, P=2, bf16 exchange), every launch
    counted; then k=4 smoke-width rounds (random pairing, drops) on the
    card against the CPU."""
    import numpy as np
    from repro_torch import check
    from repro_torch.core import schedules
    from repro_torch.models.registry import get_smoke_arch

    rounds = ROUNDS
    argv = ["--full", "--arch", "diloco_150m", "--k", str(K), "--H", str(H),
            "--rounds", str(rounds), "--batch", str(BATCH), "--seq",
            str(SEQ), "--eval-batch", "8", "--transport", "gossip",
            "--gossip-pairing", "butterfly", "--gossip-mix", "0.5",
            "--stream-fragments", "2", "--outer-grad-dtype", "bfloat16",
            *trace_flag("train_gossip")]
    records, timing, wall_s, launches = run_trainer(torch, dev, argv)
    want = expect_launches(fused_adamw=K * H * rounds * N_LEAVES,
                           outer_nesterov=rounds * N_LEAVES,
                           fake_quant_bf16=rounds * N_LEAVES)
    if launches != want:
        raise SystemExit(f"train_gossip: launches {launches}, expected "
                         f"{want}")
    losses, _ = check_records(records, "train_gossip", 0.0, rounds=rounds)
    trace = check_trace("train_gossip")
    rnds = [r for r in records if r["phase"] == "diloco"]
    if [r["gossip_edges"] for r in rnds] != [[[0, 1]]] * rounds:
        raise SystemExit(f"train_gossip: edges {rnds}")
    last = timing["rounds"][-1]

    k, h, b, s, n = 4, 2, 2, 64, 3
    arch = get_smoke_arch("diloco_60m")
    gen = torch.Generator().manual_seed(0)
    params = arch.init(generator=gen, device="cpu")
    toks = torch.randint(0, arch.cfg.vocab_size, (n, k, h * b, s),
                         generator=gen)
    drops = schedules.drop_masks(np.random.default_rng(0), 0.3, k, n)
    dcfg, got, e_card = gossip_rounds(torch, dev, params, toks, drops, n,
                                      k, h)
    _, ref, e_cpu = gossip_rounds(torch, torch.device("cpu"), params, toks,
                                  drops, n, k, h)
    shares = check.gossip_mismatch_shares(got, ref, H=h, dcfg=dcfg)
    path = max(shares, key=shares.get)
    if shares[path] > check.TRANSPORT_FLIP_SHARE["bfloat16"] or \
            e_card != e_cpu:
        raise SystemExit(f"train_gossip smoke: {path}: {shares[path]:.3g} "
                         f"outside; edges {e_card} against {e_cpu}")
    say({"phase": "train_gossip", "argv": argv, "launches": launches,
         "trace": trace, "losses": losses, "rounds": timing["rounds"],
         "tokens_per_s": K * H * BATCH * SEQ / last["inner_s"],
         "inner_step_ms": last["inner_s"] * 1e3 / (K * H),
         "outer_ms_per_round": last["outer_s"] * 1e3,
         "sample_ms": last["sample_s"] * 1e3,
         "gossip_spread": [r["gossip_spread"] for r in rnds],
         "exchange_bytes": [r["wire_bytes"] for r in rnds],
         "max_memory_allocated_GB": torch.cuda.max_memory_allocated(dev)
         / 1e9, "wall_s": wall_s,
         "smoke": {"k": k, "H": h, "rounds": n, "drop_prob": 0.3,
                   "pairing": "random", "edges": e_card,
                   "drops": np.asarray(drops).tolist(),
                   "leaves_compared": len(shares),
                   "worst_share_outside_tolerance": shares[path],
                   "worst_leaf": path}})


# ---------------------------------------------------------------------------
# slice 12: the serving path of the dense family
# ---------------------------------------------------------------------------

SERVE_DIR = ROOT / "build" / "chip_smoke_serve"
PARAMS_400M = 551_327_232
# phase 29's load: 32 requests, prompts of 64-1024 tokens drawn from the
# seed, 128 new tokens each, through 16 slots of a 1152-token ring
SERVE_SLOTS, SERVE_REQUESTS, SERVE_NEW, SERVE_CACHE = 16, 32, 128, 1152
SERVE_PAGE = 16
# JAX's packed-weights bound on prefill logits (tests/test_batching.py: two
# 12-token prompts, the weights of its own seeded smoke config), which
# tests/test_torch_serve.py holds on JAX's weights. It is a property of
# those weights, not of the codec: the port's seeded weights break it at
# smoke width and at diloco_400m's full width alike, with the bytes JAX's
# save_packed writes (PERF.md, PR 22). Phases 29 and 30 print the error
# beside it; the packed path is held exactly instead (the paged engine on
# packed weights against the contiguous one on their decoded values, bit
# for bit; the card's packed engine against the CPU's).
PACKED_REL, PACKED_ABS = 0.15, 0.05
# phase 33's olmoe load: 16 requests, prompts of 64-512 tokens, 64 new
# tokens each, 8 slots (at most 8 assignments reach an expert in a decode
# tick, under the capacity floor of 8: no decode tick drops)
FAM_SLOTS, FAM_REQUESTS, FAM_NEW = 8, 16, 64


def serve_requests(engine_of, prompts, n_new, label):
    """One drained run of the engine ``engine_of()`` over ``prompts``,
    the launch counters set to 0 just before it and read just after.
    Returns (the engine, each request's tokens, launches, wall s, device
    GB: {"before": held before the engine was made (the weights, earlier
    phases' Markov tables), "peak": the run's peak})."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 1e9
    eng = engine_of()
    reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, n_new) for p in prompts]
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if sorted(done) != sorted(rids) or any(
            len(done[r]) != n_new for r in rids):
        raise SystemExit(f"{label}: {len(done)} of {len(rids)} requests "
                         "came back whole")
    return (eng, [done[r] for r in rids], launches, wall,
            {"before": before,
             "peak": torch.cuda.max_memory_allocated() / 1e9})


def serve_stats(eng, wall) -> dict:
    """Prefill ms per request, ms per decode tick and decode tokens/s of
    one engine run (host clock around work that ends in a wait)."""
    pre, dec = sorted(eng.timing["prefill_s"]), sorted(eng.timing["decode_s"])
    n_dec = sum(len(t) - 1 for t in eng.finished.values())
    return {"prefill_ms_median": pre[len(pre) // 2] * 1e3,
            "prefill_ms_mean": sum(pre) * 1e3 / len(pre),
            "decode_tick_ms_median": dec[len(dec) // 2] * 1e3,
            "decode_tick_ms_mean": sum(dec) * 1e3 / len(dec),
            "decode_ticks": eng.decode_steps, "prefills": eng.prefills,
            "decode_tokens": n_dec, "decode_tokens_per_s": n_dec / sum(dec),
            "wall_s": wall}


def phase_serve_400m(torch, dev):
    """Phase 29: diloco_400m at full width (seeded random f32 weights)
    served from packed int4 weights by the paged engine, and from their
    dequantized values by the contiguous one; prefill logits of f32
    against packed weights; two requests against themselves decoded
    alone. Returns {kernel name: launches} of the two codec kernels on
    this path."""
    import numpy as np
    from repro_torch import check, tree
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch.batching import ContinuousBatcher
    from repro_torch.launch.serve import forced_logits
    from repro_torch.models.registry import get_arch

    arch = get_arch("diloco_400m")
    V = arch.cfg.vocab_size
    params = arch.init(generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    n_params = sum(t.numel() for t in tree.leaves(params))
    if n_params != PARAMS_400M:
        raise SystemExit(f"serve_400m: {n_params} parameters, expected "
                         f"{PARAMS_400M}")
    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    path = str(SERVE_DIR / "diloco_400m.packed.npz")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    man = ckpt.save_packed(path, params, n_fragments=4)
    save_s = time.perf_counter() - t0
    saved = read_launches()
    regions = sum(len(f) for f in man["fragments"])
    if saved != expect_launches(quantize_pack_int4=regions):
        raise SystemExit(f"serve_400m save_packed: launches {saved}, "
                         f"expected {regions} quantize_pack_int4")
    packed = ckpt.load_packed(path)
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1025, SERVE_REQUESTS)
    prompts = [rng.integers(0, V, int(n)) for n in lens]
    deq = ckpt.unpack_params({k: torch.from_numpy(v).to(dev)
                              for k, v in packed["buffers"].items()},
                             packed["manifest"], params)
    # prefill logits of two prompts: f32 against the packed weights
    prefill = []
    with torch.no_grad():
        for p in prompts[:2]:
            toks = torch.from_numpy(p)[None].to(dev)
            lf = arch.prefill(params, {"tokens": toks})[0]
            lq = arch.prefill(deq, {"tokens": toks})[0]
            scale = float(lf.abs().max())
            err = float((lf - lq).abs().max())
            bound = PACKED_REL * scale + PACKED_ABS
            prefill.append({"prompt": len(p), "max_abs_err": err,
                            "max_abs_logit": scale, "jax_bound": bound,
                            "within_jax_bound": err <= bound})
            if not math.isfinite(err):
                raise SystemExit(f"serve_400m: packed prefill logits "
                                 f"{prefill[-1]}")
    del params
    torch.cuda.empty_cache()
    kw = dict(slots=SERVE_SLOTS, cache_len=SERVE_CACHE,
              page_size=SERVE_PAGE, device=dev)
    eng, paged, launches, wall, peak = serve_requests(
        lambda: ContinuousBatcher(arch, deq, packed_weights=packed,
                                  record_logits=(0, 1), **kw),
        prompts, SERVE_NEW, "serve_400m paged")
    forwards = eng.decode_steps + eng.prefills
    want = expect_launches(unpack_dequantize_int4=regions * forwards)
    if launches != want:
        raise SystemExit(f"serve_400m paged: launches {launches}, "
                         f"expected {want}")
    stats = dict(serve_stats(eng, wall), memory_GB=peak,
                 tokens_per_s_wall=SERVE_REQUESTS * SERVE_NEW / wall)
    alone = []
    for rid in (0, 1):
        ref = forced_logits(arch, deq, prompts[rid], paged[rid])
        res = check.serve_mismatches(paged[rid],
                                     torch.stack(eng.logits[rid]),
                                     ref.cpu(), forced=True)
        alone.append(res)
        if res["bad"] or res["max_logit_err"] > check.SERVE_LOGIT_RTOL:
            raise SystemExit(f"serve_400m: request {rid} against itself "
                             f"alone: {res}")
    del eng
    torch.cuda.empty_cache()
    ceng, contiguous, c_launches, c_wall, c_peak = serve_requests(
        lambda: ContinuousBatcher(arch, deq, paged=False, **kw), prompts,
        SERVE_NEW, "serve_400m contiguous")
    if c_launches != expect_launches():
        raise SystemExit(f"serve_400m contiguous: launches {c_launches}")
    differ = [i for i, (a, b) in enumerate(zip(paged, contiguous))
              if not np.array_equal(a, b)]
    if differ:
        raise SystemExit(f"serve_400m: paged and contiguous tokens differ "
                         f"for requests {differ}")
    c_stats = dict(serve_stats(ceng, c_wall), memory_GB=c_peak,
                   tokens_per_s_wall=SERVE_REQUESTS * SERVE_NEW / c_wall)
    say({"phase": "serve_400m", "params": n_params, "regions": regions,
         "packed_bytes": man["packed_bytes"], "f32_bytes": man["f32_bytes"],
         "save_packed_s": save_s, "save_launches": saved,
         "requests": SERVE_REQUESTS, "prompt_lens": lens.tolist(),
         "new_tokens": SERVE_NEW, "slots": SERVE_SLOTS,
         "cache_len": SERVE_CACHE, "page_size": SERVE_PAGE,
         "launches": launches, "forwards": forwards,
         "paged_packed": stats, "contiguous_f32": c_stats,
         "paged_equals_contiguous": True, "prefill_packed_vs_f32": prefill,
         "alone": [{kk: r[kk] for kk in ("steps_compared", "max_logit_err",
                                         "near_ties")} for r in alone]})
    del ceng, deq
    os.remove(path)
    torch.cuda.empty_cache()
    return {"quantize_pack_int4": saved["quantize_pack_int4"],
            "unpack_dequantize_int4": launches["unpack_dequantize_int4"]}


def phase_serve_smoke(torch, dev):
    """Phase 30: the serve path at smoke width (diloco_150m's smoke config,
    window 0 and 32) on the card against the CPU: greedy decode and the
    paged engine on packed weights, each request's tokens and logits held
    to the CPU's (``check.serve_mismatches``)."""
    import numpy as np
    from repro_torch import check, tree
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch.batching import ContinuousBatcher
    from repro_torch.launch.serve import forced_logits, greedy_decode
    from repro_torch.models.registry import Arch, get_smoke_arch

    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    out = []
    for window in (0, 32):
        arch = Arch(cfg=get_smoke_arch("diloco_150m").cfg.replace(
            window=window))
        cpu = arch.init(generator=torch.Generator().manual_seed(1),
                        device="cpu")
        card = tree.map(lambda t: t.to(dev), cpu)
        path = str(SERVE_DIR / f"smoke_{window}.npz")
        ckpt.save_packed(path, card)
        packed = ckpt.load_packed(path)
        os.remove(path)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, 256, int(n)) for n in (40, 7, 19, 33)]
        res = []
        for dev_ in (dev, torch.device("cpu")):
            eng = ContinuousBatcher(arch, cpu, slots=2, cache_len=96,
                                    packed_weights=packed, device=dev_,
                                    record_logits=range(4))
            rids = [eng.submit(p, 24) for p in prompts]
            done = eng.run_until_drained()
            res.append(([done[r] for r in rids], eng.logits))
        worst = {"steps_compared": 0, "max_logit_err": 0.0,
                 "near_ties": 0}
        for rid in range(4):
            r = check.serve_mismatches(res[0][0][rid],
                                       torch.stack(res[0][1][rid]),
                                       torch.stack(res[1][1][rid]))
            if r["bad"] or r["max_logit_err"] > check.SERVE_LOGIT_RTOL:
                raise SystemExit(f"serve_smoke window {window}: request "
                                 f"{rid}: {r}")
            worst = {"steps_compared": worst["steps_compared"]
                     + r["steps_compared"],
                     "max_logit_err": max(worst["max_logit_err"],
                                          r["max_logit_err"]),
                     "near_ties": worst["near_ties"] + r["near_ties"]}
        # a static batch on the card against the CPU's forced logits
        toks = np.stack([p[:7] for p in prompts])
        g = greedy_decode(arch, card, toks, gen=16).cpu().numpy()
        for i in range(len(toks)):
            r = check.serve_mismatches(
                g[i], forced_logits(arch, card, toks[i], g[i]).cpu(),
                forced_logits(arch, cpu, toks[i], g[i]), forced=True)
            if r["bad"] or r["max_logit_err"] > check.SERVE_LOGIT_RTOL:
                raise SystemExit(f"serve_smoke window {window}: greedy "
                                 f"row {i}: {r}")
        # f32 against packed weights at JAX's test shapes
        toks = torch.from_numpy(np.arange(2 * 12).reshape(2, 12) % 256)
        deq = ckpt.unpack_params({k: torch.from_numpy(v).to(dev)
                                  for k, v in packed["buffers"].items()},
                                 packed["manifest"], card)
        with torch.no_grad():
            lf = arch.prefill(card, {"tokens": toks.to(dev)}, cache_len=16)[0]
            lq = arch.prefill(deq, {"tokens": toks.to(dev)}, cache_len=16)[0]
        scale = float(lf.abs().max())
        err = float((lf - lq).abs().max())
        if not math.isfinite(err):
            raise SystemExit(f"serve_smoke window {window}: packed prefill "
                             f"logits off by {err}")
        bound = PACKED_REL * scale + PACKED_ABS
        out.append({"window": window, "engine": worst,
                    "packed_prefill_max_abs_err": err,
                    "max_abs_logit": scale, "jax_bound": bound,
                    "within_jax_bound": err <= bound})
    say({"phase": "serve_smoke", "cases": out})


# the ten configs of the other families, those the continuous engine
# serves (not the VLM and the encoder-decoder, which need a modality
# input) and those the trainer takes (the same eight)
FAMILY_ARCHS = ("stablelm_1_6b", "starcoder2_7b", "qwen3_32b",
                "command_r_35b", "olmoe_1b_7b", "deepseek_v2_lite_16b",
                "zamba2_2_7b", "xlstm_350m", "llama_3_2_vision_90b",
                "whisper_large_v3")
CROSS_ARCHS = ("llama_3_2_vision_90b", "whisper_large_v3")
SMOKE_TOL = dict(rtol=1e-4, atol=1e-5)     # phase 3's
ZAMBA2_LAYERS, ZAMBA2_LEAVES = 12, 74
DEEPSEEK_LAYERS = 4
OLMOE_PARAMS, ZAMBA2_PARAMS_12 = 6_919_100_416, 721_188_160
DEEPSEEK_PARAMS_4 = 2_758_823_936


def perturbed_smoke_params(torch, arch, seed):
    """Seeded CPU params of a smoke config, every all-zero leaf (biases,
    the VLM's gates, ``conv_b``, ``dt_bias``) given N(0, 0.1²) noise so
    that the card's use of it shows."""
    from repro_torch import tree
    gen = torch.Generator().manual_seed(seed)
    params = arch.init(generator=gen, device="cpu")
    for t in tree.leaves(params):
        if not t.any():
            t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return params


def assert_close(np, got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **SMOKE_TOL)
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want)), initial=0.0))


def phase_families_smoke(torch, dev):
    """Phase 31: the ten other configs at smoke width, card against CPU:
    the forward's logits and aux, loss and gradients, prefill + 3 decode
    steps; paged = contiguous bit for bit through the engine (the eight it
    serves); one k=2, H=2 round through ``make_round`` (the eight the
    trainer takes), every state leaf at phase 3's tolerance."""
    import numpy as np
    from repro_torch import convert, tree
    from repro_torch.configs.base import DiLoCoConfig, TrainConfig
    from repro_torch.core import diloco
    from repro_torch.launch.batching import ContinuousBatcher
    from repro_torch.launch.serve import modality_inputs
    from repro_torch.models.registry import get_smoke_arch

    cpu = torch.device("cpu")
    out = []
    for name in FAMILY_ARCHS:
        t0 = time.perf_counter()
        arch = get_smoke_arch(name)
        cfg = arch.cfg
        params = perturbed_smoke_params(torch, arch, 0)
        gen = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
        batch = {"tokens": toks, **modality_inputs(cfg, 2, 0, cpu)}
        res = {}
        for tag, d in (("card", dev), ("cpu", cpu)):
            p = tree.map(lambda t: t.detach().clone().to(d)
                         .requires_grad_(), params)
            b = {k: v.to(d) for k, v in batch.items()}
            loss, m = arch.loss(p, b)
            grads = torch.autograd.grad(loss, tree.leaves(p),
                                        allow_unused=True)
            with torch.no_grad():
                lg, cache = arch.prefill(p, b, cache_len=27)
                steps = [lg[:, -1]]
                for i in range(3):
                    lg, cache = arch.decode(p, cache, toks[:, i:i + 1]
                                            .to(d), 24 + i)
                    steps.append(lg[:, -1])
            res[tag] = {
                "loss": float(loss.detach()), "aux": float(m["aux"]),
                "grads": [np.zeros(tuple(t.shape), np.float32) if g is None
                          else g.cpu().numpy()
                          for t, g in zip(tree.leaves(p), grads)],
                "logits": [s_.cpu().numpy() for s_ in steps]}
        got, want = res["card"], res["cpu"]
        worst = {"loss": assert_close(np, got["loss"], want["loss"],
                                      f"{name} loss"),
                 "aux": assert_close(np, got["aux"], want["aux"],
                                     f"{name} aux")}
        worst["grads"] = max(assert_close(np, a, w, f"{name} grad {i}")
                             for i, (a, w) in enumerate(zip(
                                 got["grads"], want["grads"])))
        worst["logits"] = max(assert_close(np, a, w, f"{name} logits {i}")
                              for i, (a, w) in enumerate(zip(
                                  got["logits"], want["logits"])))
        row = {"arch": name, "family": cfg.family, "max_abs_diff": worst,
               "loss_card": got["loss"], "aux_card": got["aux"]}
        if name == "xlstm_350m":
            # one smoke train step (loss and gradients) on the card, the
            # cells' per-token inputs unbound once (its backward one stack)
            p = tree.map(lambda t: t.detach().clone().to(dev)
                         .requires_grad_(), params)
            b = {k: v.to(dev) for k, v in batch.items()}
            row["train_step_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                arch.loss(p, b)[0], tree.leaves(p), allow_unused=True),
                reps=5, warmup=1)
            row["train_step_shape"] = list(toks.shape)
            del p, b
        if name not in CROSS_ARCHS:
            card = tree.map(lambda t: t.to(dev), params)
            rng = np.random.default_rng(5)
            prompts = [rng.integers(0, cfg.vocab_size, n)
                       for n in (12, 7, 19, 5, 9)]
            gens = [6, 1, 4, 8, 5]
            served = {}
            for paged in (True, False):
                eng = ContinuousBatcher(arch, card, slots=2, cache_len=64,
                                        paged=paged, page_size=16)
                rids = [eng.submit(q, g) for q, g in zip(prompts, gens)]
                done = eng.run_until_drained()
                served[paged] = [done[r] for r in rids]
            if any(not np.array_equal(a, b_) for a, b_ in zip(
                    served[True], served[False])):
                raise SystemExit(f"families_smoke {name}: paged and "
                                 "contiguous tokens differ")
            row["paged_equals_contiguous"] = True
            k, h, bsz, s = 2, 2, 2, 32
            rtoks = torch.randint(0, cfg.vocab_size, (k, h * bsz, s),
                                  generator=gen)
            states = {}
            for tag, d in (("card", dev), ("cpu", cpu)):
                rnd = diloco.make_round(
                    lambda p_, bt: arch.loss(p_, bt),
                    lambda g_, bb, ss: rtoks.to(d), DiLoCoConfig(k=k, H=h),
                    TrainConfig(inner_lr=1e-3, warmup_steps=2,
                                total_steps=8), batch_size=bsz, seq_len=s)
                st = diloco.init_state(tree.map(lambda t: t.to(d), params),
                                       DiLoCoConfig(k=k, H=h))
                st, _ = rnd(st, None)
                states[tag] = convert.state_to_numpy(st)
            row["round_max_abs_diff"] = max(
                assert_close(np, a, w, f"{name} round {path}")
                for (path, a), (_, w) in zip(tree.paths(states["card"]),
                                             tree.paths(states["cpu"])))
        row["wall_s"] = time.perf_counter() - t0
        out.append(row)
    torch.cuda.empty_cache()
    say({"phase": "families_smoke", **SMOKE_TOL, "archs": out})


def phase_train_zamba2(torch, dev):
    """Phase 32: zamba2 at full width, cut to 12 of its 54 layers, through
    the trainer's ``build``, ``core.diloco.make_round`` and ``make_eval``:
    k=2, H=2, 2 rounds, batch 8, seq 1024 on phase 4's Markov tables.
    Exactly one ``fused_adamw`` per leaf per replica-step and one
    ``outer_nesterov`` per leaf per round."""
    from repro_torch import tree
    from repro_torch.core import diloco
    from repro_torch.launch import train

    h = 2
    argv = ["--full", "--arch", "zamba2_2_7b", "--k", str(K), "--H", str(h),
            "--rounds", str(ROUNDS), "--batch", str(BATCH), "--seq",
            str(SEQ)]
    args = train.make_parser().parse_args(argv)
    arch, cfg, dcfg, tcfg, sampler = train.build(
        args, dev, sampler=shared_sampler(torch, dev, args))
    cfg = cfg.replace(n_layers=ZAMBA2_LAYERS)
    loss_fn = lambda p, b: arch.loss(p, b, cfg=cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = arch.init(generator=gen, device=dev, cfg=cfg)
    n_params = sum(t.numel() for t in tree.leaves(params))
    n_leaves = len(tree.leaves(params))
    if (n_params, n_leaves) != (ZAMBA2_PARAMS_12, ZAMBA2_LEAVES):
        raise SystemExit(f"train_zamba2: {n_params} parameters in "
                         f"{n_leaves} leaves")
    state = diloco.init_state(params, dcfg)
    del params
    rnd = diloco.make_round(loss_fn, sampler.sample_all_shards, dcfg, tcfg,
                            total_steps=tcfg.total_steps, batch_size=BATCH,
                            seq_len=SEQ)
    ev = diloco.make_eval(loss_fn)
    val = sampler.sample_validation(
        torch.Generator(device=dev).manual_seed(10_000), BATCH, SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    rounds = []
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        state, m = rnd(state, gen)
        rounds.append({"inner_loss": float(m["inner_loss"]),
                       "val_loss": float(ev(state.global_params, val)),
                       **{n: m[n] for n in ("sample_s", "inner_s",
                                            "outer_s")}})
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    want = expect_launches(fused_adamw=K * h * ROUNDS * n_leaves,
                           outer_nesterov=ROUNDS * n_leaves)
    if launches != want:
        raise SystemExit(f"train_zamba2: launch counts {launches}, "
                         f"expected {want}")
    if not all(math.isfinite(r[n]) for r in rounds
               for n in ("inner_loss", "val_loss")):
        raise SystemExit(f"train_zamba2: bad round records: {rounds}")
    say({"phase": "train_zamba2", "argv": argv,
         "n_layers": ZAMBA2_LAYERS, "params": n_params, "leaves": n_leaves,
         "launches": {n: c for n, c in launches.items() if c},
         "rounds": rounds,
         "tokens_per_s": K * h * BATCH * SEQ / rounds[-1]["inner_s"],
         "inner_step_ms": rounds[-1]["inner_s"] * 1e3 / (K * h),
         "outer_step_ms": rounds[-1]["outer_s"] * 1e3, "wall_s": wall_s,
         "max_memory_allocated_GB":
             torch.cuda.max_memory_allocated(dev) / 1e9})
    del state, val, rnd, ev
    torch.cuda.empty_cache()
    return launches


class DropCounter:
    """Dropped MoE assignments, counted from outside the package by
    wrapping ``models.moe._dispatch_group`` (the engine has no counter of
    its own, as JAX's has none): a call over ``decode_rows`` tokens is a
    decode tick's, any other a prefill's."""

    def __init__(self, decode_rows: int):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe._dispatch_group
        self.rows = decode_rows
        self.calls = {"prefill": 0, "decode": 0}
        self.dropped = {"prefill": 0, "decode": 0}

    def __enter__(self):
        def counted(x, probs, idx, E, C):
            out = self.orig(x, probs, idx, E, C)
            kind = "decode" if x.shape[0] == self.rows else "prefill"
            self.calls[kind] += 1
            self.dropped[kind] += int((~out[2]).sum())
            return out
        self.moe._dispatch_group = counted
        return self

    def __exit__(self, *exc):
        self.moe._dispatch_group = self.orig


def phase_serve_families(torch, dev):
    """Phase 33: serving at full width. olmoe_1b_7b at full depth from
    packed int4 weights (paged, 8 slots), then from their decoded values
    (contiguous), then two requests teacher-forced alone; deepseek cut to
    4 layers and xlstm_350m from f32 weights, paged and contiguous.
    Returns {kernel name: launches} of the two codec kernels on olmoe's
    path."""
    import numpy as np
    from repro_torch import check, tree
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch.batching import ContinuousBatcher
    from repro_torch.launch.serve import forced_logits
    from repro_torch.models.registry import Arch, get_arch

    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    rows = {}

    def engines(arch, weights, prompts, n_new, slots, label, packed=None,
                record=()):
        """The paged engine (on ``packed`` when given) then the
        contiguous one; their tokens must be equal."""
        cache = -(-(max(len(p) for p in prompts) + n_new) // 16) * 16
        kw = dict(slots=slots, cache_len=cache, page_size=16, device=dev)
        with DropCounter(slots) as drops:
            eng, paged, launches, wall, mem = serve_requests(
                lambda: ContinuousBatcher(arch, weights, packed_weights=packed,
                                          record_logits=record, **kw),
                prompts, n_new, f"{label} paged")
        stats = {"paged": dict(serve_stats(eng, wall), memory_GB=mem),
                 "dropped": dict(drops.dropped),
                 "moe_calls": dict(drops.calls)}
        logits = {r: torch.stack(eng.logits[r]) for r in record}
        forwards = eng.decode_steps + eng.prefills
        del eng
        torch.cuda.empty_cache()
        return paged, launches, forwards, stats, logits, kw

    # ---- olmoe at full depth from packed int4 weights ----
    arch = get_arch("olmoe_1b_7b")
    params = arch.init(generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    n_params = sum(t.numel() for t in tree.leaves(params))
    if n_params != OLMOE_PARAMS:
        raise SystemExit(f"serve_families: olmoe has {n_params} parameters")
    path = str(SERVE_DIR / "olmoe.packed.npz")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    man = ckpt.save_packed(path, params, n_fragments=4)
    save_s = time.perf_counter() - t0
    saved = read_launches()
    regions = sum(len(f) for f in man["fragments"])
    if saved != expect_launches(quantize_pack_int4=regions):
        raise SystemExit(f"serve_families save_packed: launches {saved}, "
                         f"expected {regions} quantize_pack_int4")
    del params                      # the f32 tree goes before any engine
    torch.cuda.empty_cache()
    packed = ckpt.load_packed(path)
    os.remove(path)
    meta = arch.init(generator=None, device="meta")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.cfg.vocab_size, int(n))
               for n in rng.integers(64, 513, FAM_REQUESTS)]
    paged, served, forwards, stats, logits, kw = engines(
        arch, meta, prompts, FAM_NEW, FAM_SLOTS, "olmoe", packed=packed,
        record=(0, 1))
    if served != expect_launches(unpack_dequantize_int4=regions * forwards):
        raise SystemExit(f"serve_families olmoe: launches {served}, "
                         f"expected {regions} × {forwards}")
    if stats["dropped"]["decode"] or not stats["moe_calls"]["decode"]:
        raise SystemExit(f"serve_families olmoe: decode ticks dropped "
                         f"{stats['dropped']} ({stats['moe_calls']})")
    deq = ckpt.unpack_params({k: torch.from_numpy(v).to(dev)
                              for k, v in packed["buffers"].items()},
                             packed["manifest"], meta)
    del packed
    torch.cuda.empty_cache()
    ceng, contiguous, c_launches, c_wall, c_mem = serve_requests(
        lambda: ContinuousBatcher(arch, deq, paged=False, **kw), prompts,
        FAM_NEW, "olmoe contiguous")
    stats["contiguous"] = dict(serve_stats(ceng, c_wall), memory_GB=c_mem)
    del ceng
    differ = [i for i, (a, b) in enumerate(zip(paged, contiguous))
              if not np.array_equal(a, b)]
    if differ or c_launches != expect_launches():
        raise SystemExit(f"serve_families olmoe: paged and contiguous "
                         f"differ for {differ}; launches {c_launches}")
    alone = []
    for rid in (0, 1):
        ref = forced_logits(arch, deq, prompts[rid], paged[rid])
        res = check.serve_mismatches(paged[rid], logits[rid], ref.cpu(),
                                     forced=True)
        alone.append({kk: res[kk] for kk in ("steps_compared",
                                             "max_logit_err", "near_ties")})
        if res["bad"] or res["max_logit_err"] > check.SERVE_LOGIT_RTOL:
            raise SystemExit(f"serve_families olmoe: request {rid} against "
                             f"itself alone: {res}")
    rows["olmoe_1b_7b"] = {
        "params": n_params, "regions": regions,
        "packed_bytes": man["packed_bytes"], "save_packed_s": save_s,
        "forwards": forwards, "launches": {n: c for n, c in served.items()
                                           if c},
        "prompt_lens": [len(p) for p in prompts], **stats, "alone": alone}
    del deq
    torch.cuda.empty_cache()

    # ---- deepseek (4 layers, absorbed MLA decode at rank 512), xlstm ----
    for name, cfg_kw, lo, hi, n_req, n_new, slots, want_params in (
            ("deepseek_v2_lite_16b", {"n_layers": DEEPSEEK_LAYERS}, 64, 257,
             8, 32, 8, DEEPSEEK_PARAMS_4),
            ("xlstm_350m", {}, 16, 65, 4, 16, 4, None)):
        a = get_arch(name)
        a = Arch(cfg=a.cfg.replace(**cfg_kw))
        params = a.init(generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
        n = sum(t.numel() for t in tree.leaves(params))
        if want_params is not None and n != want_params:
            raise SystemExit(f"serve_families: {name} has {n} parameters")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, a.cfg.vocab_size, int(m))
                   for m in rng.integers(lo, hi, n_req)]
        paged, launches, _, stats, _, kw = engines(a, params, prompts, n_new,
                                                   slots, name)
        ceng, contiguous, c_launches, c_wall, c_mem = serve_requests(
            lambda: ContinuousBatcher(a, params, paged=False, **kw),
            prompts, n_new, f"{name} contiguous")
        stats["contiguous"] = dict(serve_stats(ceng, c_wall),
                                   memory_GB=c_mem)
        del ceng
        if any(not np.array_equal(x, y) for x, y in zip(paged, contiguous)) \
                or launches != expect_launches() \
                or c_launches != expect_launches():
            raise SystemExit(f"serve_families {name}: paged and contiguous "
                             f"differ, or launches {launches}")
        if name.startswith("deepseek") and stats["dropped"]["decode"]:
            raise SystemExit(f"serve_families {name}: decode dropped "
                             f"{stats['dropped']}")
        rows[name] = {"params": n, "n_layers": a.cfg.n_layers,
                      "prompt_lens": [len(p) for p in prompts],
                      "new_tokens": n_new, "slots": slots, **stats}
        del params
        torch.cuda.empty_cache()
    say({"phase": "serve_families", "slots": FAM_SLOTS,
         "olmoe_requests": FAM_REQUESTS, "olmoe_new_tokens": FAM_NEW,
         "paged_equals_contiguous": True, "models": rows})
    return {"quantize_pack_int4": saved["quantize_pack_int4"],
            "unpack_dequantize_int4": served["unpack_dequantize_int4"]}


# phase 34's tolerances: the counted FLOPs of a replica step against phase
# 4's formula, the meta run's peak memory estimate against the card's
DRYRUN_FLOPS_TOL, DRYRUN_MEMORY_TOL = 1e-3, 0.25
# the traffic keys of a round's collectives (no control calls)
DRYRUN_TRAFFIC = ("all_reduce", "all_gather", "gather_wire", "exchange",
                  "wire_bytes", "metric_bytes")


def replica_step(torch, remat: bool, device):
    """(step, args_of(gen)) of one diloco_150m replica step at BATCH ×
    SEQ: the trainer's inner step (``diloco.make_inner_step``) and a fresh
    (params, AdamW state, batch) on ``device``."""
    from repro_torch.core import diloco
    from repro_torch.launch import train
    from repro_torch.models.registry import get_arch
    from repro_torch.optim import adamw

    arch = get_arch("diloco_150m")
    cfg = arch.cfg.replace(remat=remat)
    tcfg = train.build(train.make_parser().parse_args(
        ["--full", "--arch", "diloco_150m", "--batch", str(BATCH), "--seq",
         str(SEQ)]), device, sampler=False)[3]
    step = diloco.make_inner_step(lambda p, b: arch.loss(p, b, cfg=cfg),
                                  tcfg)

    def args_of(gen=None):
        params = arch.init(generator=gen, device=device)
        toks = torch.zeros((BATCH, SEQ), dtype=torch.int64, device=device)
        return params, adamw.init(params), {"tokens": toks}

    return step, args_of


def dryrun_counts(torch) -> dict:
    """Phase 34's counts, on meta tensors (no card): ``op_cost`` of one
    replica step with remat off and on, and the ``CountingGroup`` traffic
    of phase 21's int4 round on rank 0 of 2."""
    from repro_torch import tree
    from repro_torch.core import diloco, streaming
    from repro_torch.launch import op_cost, train
    from repro_torch.models.registry import get_arch

    arch = get_arch("diloco_150m")
    meta = arch.init(generator=None, device="meta")
    n_params = sum(t.numel() for t in tree.leaves(meta))
    want_flops = flops_per_token(arch.cfg, n_params) * BATCH * SEQ

    costs = {}
    for remat in (False, True):
        step, args_of = replica_step(torch, remat, "meta")
        costs[remat] = op_cost.op_cost(step, *args_of(), 1)

    # phase 21's int4 round, one rank of two, counted on meta tensors
    argv = ["--full", "--arch", "diloco_150m", "--transport", "sharded",
            "--pods", "2", *STREAM_FLAGS, "--rounds", str(ROUNDS), "--k",
            str(K), "--H", str(H), "--batch", str(BATCH), "--seq", str(SEQ)]
    _, cfg, dcfg, tcfg, _ = train.build(train.make_parser().parse_args(argv),
                                        "meta", sampler=False)
    group = CA.CountingGroup(0, 2)
    rnd = diloco.make_round(
        lambda p, b: arch.loss(p, b, cfg=cfg),
        lambda gen, n, s: torch.zeros((K, n, s), dtype=torch.int64,
                                      device="meta"),
        dcfg, tcfg, total_steps=tcfg.total_steps, batch_size=BATCH,
        seq_len=SEQ, group=group)
    with op_cost.counting():
        state = streaming.init_state(meta, dcfg, group=group)
        for _ in range(ROUNDS):
            state, _ = rnd(state, None)
    return {"costs": costs, "want_flops": want_flops,
            "traffic": {n: group.traffic[n] for n in DRYRUN_TRAFFIC}}


def phase_dryrun(torch, dev, sharded_traffic):
    """The dry run's counts (``dryrun_counts``) held against this run: the
    FLOPs of one diloco_150m replica step (B 8, S 1024, remat off) against
    phase 4's count, the bytes of phase 21's int4 round counted by a
    ``CountingGroup`` against that phase's measured ``PodGroup.traffic``,
    and the step's peak memory estimate against
    ``torch.cuda.max_memory_allocated`` around a real step on the card."""
    from repro_torch import tree

    t0 = time.perf_counter()
    got = dryrun_counts(torch)
    costs, want_flops, counted = got["costs"], got["want_flops"], \
        got["traffic"]
    ratio = costs[False]["flops"] / want_flops
    if abs(ratio - 1.0) > DRYRUN_FLOPS_TOL:
        raise SystemExit(f"dryrun: counted {costs[False]['flops']} FLOPs, "
                         f"phase 4's count {want_flops} (ratio {ratio})")
    measured = [{n: t.get(n, 0) for n in DRYRUN_TRAFFIC}
                for t in sharded_traffic]
    if any(m != counted for m in measured):
        raise SystemExit(f"dryrun: counted traffic {counted}, phase 21 "
                         f"measured {measured}")

    # the peak memory of a real replica step on the card
    step, args_of = replica_step(torch, False, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    p, st, b = args_of(torch.Generator(device=dev).manual_seed(0))
    arg_bytes = sum(t.numel() * t.element_size() for t in
                    tree.leaves(p) + tree.leaves(st.m) + tree.leaves(st.v)
                    + [b["tokens"]])
    step(p, st, b, 1)                       # the workspaces, once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step(p, st, b, 2)
    torch.cuda.synchronize()
    measured_peak = torch.cuda.max_memory_allocated(dev) - base
    estimate = arg_bytes + costs[False]["peak_live_bytes"]
    rel = estimate / measured_peak - 1.0
    del p, st, b
    torch.cuda.empty_cache()
    if abs(rel) > DRYRUN_MEMORY_TOL:
        raise SystemExit(f"dryrun: peak estimate {estimate} B, measured "
                         f"{measured_peak} B ({rel:+.3f})")
    say({"phase": "dryrun", "arch": "diloco_150m", "batch": BATCH,
         "seq": SEQ, "counted_flops": costs[False]["flops"],
         "phase4_flops": want_flops, "flops_ratio": ratio,
         "flops_tol": DRYRUN_FLOPS_TOL,
         "remat_flops_ratio": costs[True]["flops"] / want_flops,
         "dots": costs[False]["dots"],
         "fused_leaves": costs[False]["leaves"],
         "hbm_bytes": costs[False]["bytes"],
         "hbm_bytes_min": costs[False]["bytes_min"],
         "counted_traffic": counted, "phase21_traffic": measured,
         "wire_bytes_per_round_per_replica":
             counted["wire_bytes"] // (ROUNDS * (K // 2)),
         "argument_bytes": arg_bytes,
         "peak_live_bytes": costs[False]["peak_live_bytes"],
         "peak_estimate_bytes": estimate,
         "peak_measured_bytes": measured_peak, "peak_rel_err": rel,
         "memory_tol": DRYRUN_MEMORY_TOL,
         "remat_peak_live_bytes": costs[True]["peak_live_bytes"],
         "elapsed_s": time.perf_counter() - t0})


# the bf16 kernels' tolerance against their plain versions: both compute
# at f32 accuracy and round o, dq, dk, dv to bf16 once; the f32 sums'
# orders differ (bf16 tensor-core chains with split f32 operands, or dq's
# split TF32, against whole rows), and so may the rounding: two bf16 ulps
# relative, beside the f32 kernels' absolute tolerances
BF16_RTOL = 2 ** -7
FLASH_BF16_CASES = FLASH_CASES[:5] + FLASH_CASES[9:]
PEAK_BF16 = CA.PEAK_BF16    # dense bf16 FLOP/s of the tensor cores, H100 SXM


def phase_flash_bf16(torch, dev):
    """Phase 6, bf16: the four flash kernels on bf16 operands (their own
    entry points and counters: ``flash_fwd_bf16_kernel`` with and without
    lse, ``flash_dq_bf16_kernel``, ``flash_dkv_bf16_kernel``, all on
    ``wgmma``) against their plain versions on the same bf16 tensors
    (``BF16_RTOL``; lse, f32, at the forward's 2e-5), a bf16 CUDA tensor
    never reaching a plain version; then each kernel's time
    at ``FLASH_LAYER`` in bf16 beside its plain version, PyTorch's bf16
    ``scaled_dot_product_attention`` (the yardstick, which the port never
    calls) and the bound on the bf16 tensor cores; beside each single
    call's time (``ms``, as every kernel's row: it includes the host's
    gap before the launch) the mean of ``BURST`` calls back to back
    (``burst_ms``: the device's time), SDPA's likewise, and dq + dk/dv by
    burst beside SDPA's whole backward by burst. Returns the kernels'
    rows."""
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import ref

    names = ("fwd", "fwd_lse", "bwd_dq", "bwd_dkv")
    err = dict.fromkeys(names, 0.0)
    gen = torch.Generator(device=dev).manual_seed(6)
    bf16 = torch.bfloat16

    def inputs(B, Hh, G, Sq, Sk, d, amp=1.0):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       for shape in ((B, Hh, Sq, d), (B, G, Sk, d),
                                     (B, G, Sk, d), (B, Hh, Sq, d)))
        return tuple(t.to(bf16) for t in (q * amp, k * amp, v, do))

    def check(name, got, want, tol, rtol=BF16_RTOL):
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        worst = float(diff.max())
        if not bool((diff <= tol + rtol * want.abs()).all()):
            raise SystemExit(f"flash bf16 {name} differs from its plain "
                             f"version: max abs {worst}")
        err[name] = max(err[name], worst)
        return worst

    plain = (ref.flash_fwd_lse, ref.flash_bwd)

    def refuse(*_a, **_k):
        raise SystemExit("flash bf16: a bf16 CUDA tensor reached a plain "
                         "version")
    for case in FLASH_BF16_CASES:
        B, Hh, G, S, d, causal, window, *amp = case
        Sq, Sk = S if isinstance(S, tuple) else (S, S)
        q, k, v, do = inputs(B, Hh, G, Sq, Sk, d, amp[0] if amp else 1.0)
        opts = dict(causal=causal, window=window)
        ref.flash_fwd_lse, ref.flash_bwd = refuse, refuse
        try:
            o_nolse = FK.flash_fwd(q, k, v, **opts)
            o, lse = FK.flash_fwd_lse(q, k, v, **opts)
            dq, dk, dv = FK.flash_bwd(q, k, v, o, lse, do, **opts)
            torch.cuda.synchronize()
        finally:
            ref.flash_fwd_lse, ref.flash_bwd = plain
        if any(t.dtype != bf16 for t in (o_nolse, o, dq, dk, dv)):
            raise SystemExit("flash bf16: an output is not bf16")
        want_o, want_lse = ref.flash_fwd_lse(q, k, v, **opts)
        want_dq, want_dk, want_dv = ref.flash_bwd(q, k, v, o, lse, do,
                                                  **opts)
        say({"phase": "flash_bf16", "case": dict(
                B=B, H=Hh, G=G, Sq=Sq, Sk=Sk, d=d, causal=causal,
                window=window, amp=amp[0] if amp else 1.0),
             "max_abs_err": {
                 "fwd": check("fwd", o_nolse, want_o, FWD_TOL),
                 "fwd_lse": max(check("fwd_lse", o, want_o, FWD_TOL),
                                check("fwd_lse", lse, want_lse, FWD_TOL,
                                      FWD_TOL)),
                 "bwd_dq": check("bwd_dq", dq, want_dq, BWD_TOL),
                 "bwd_dkv": max(check("bwd_dkv", dk, want_dk, BWD_TOL),
                                check("bwd_dkv", dv, want_dv, BWD_TOL))},
             "rtol": BF16_RTOL, "fwd_atol": FWD_TOL, "bwd_atol": BWD_TOL})
        del q, k, v, do, o_nolse, o, lse, dq, dk, dv
    torch.cuda.empty_cache()

    B, Hh, G, S, d, causal, window = FLASH_LAYER
    q, k, v, do = inputs(B, Hh, G, S, S, d)
    opts = dict(causal=causal, window=window)
    o, lse = FK.flash_fwd_lse(q, k, v, **opts)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    launch = dict(do=do, lse=lse, delta=delta, scale=d ** -0.5, q_offset=0,
                  **opts)
    kernel = {
        "fwd": lambda: FK.flash_fwd(q, k, v, **opts),
        "fwd_lse": lambda: FK.flash_fwd_lse(q, k, v, **opts),
        "bwd_dq": lambda: FK._launch("bwd_dq", q, k, v, out=dq, **launch),
        "bwd_dkv": lambda: FK._launch("bwd_dkv", q, k, v, out=None, dk=dk,
                                      dv=dv, **launch)}
    plain_fn = {
        "fwd": lambda: ref.flash_fwd_lse(q, k, v, **opts)[0],
        "fwd_lse": lambda: ref.flash_fwd_lse(q, k, v, **opts),
        "bwd_dq": lambda: ref.flash_bwd_dq(q, k, v, lse, do, delta, **opts),
        "bwd_dkv": lambda: ref.flash_bwd_dkv(q, k, v, lse, do, delta,
                                             **opts)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = sdpa(*leaves, is_causal=causal)
    lib_fwd = time_ms(torch, lambda: sdpa(q, k, v, is_causal=causal))
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True))
    library = {"fwd": lib_fwd, "fwd_lse": lib_fwd, "bwd_dq": lib_bwd,
               "bwd_dkv": lib_bwd}
    lib_burst = {"fwd": burst_ms(torch, lambda: sdpa(q, k, v,
                                                     is_causal=causal)),
                 "bwd": burst_ms(torch, lambda: torch.autograd.grad(
                     out, leaves, do, retain_graph=True))}
    # the bound: this run's visible pairs, 2·d flops per pair and head for
    # each product, on the bf16 tensor cores; bytes: bf16 q, k, v, dO, o,
    # dq, dk, dv read or written once, f32 lse and delta
    pairs = int(ref.flash_visible(S, S, causal=causal, window=window,
                                  device=dev).sum()) * B * Hh
    nq, nkv, nrow = 2 * q.numel(), 2 * k.numel(), 4 * lse.numel()
    work = {"fwd": (4 * d * pairs, 2 * nq + 2 * nkv),
            "fwd_lse": (4 * d * pairs, 2 * nq + 2 * nkv + nrow),
            "bwd_dq": (6 * d * pairs, 3 * nq + 2 * nkv + 2 * nrow),
            "bwd_dkv": (8 * d * pairs, 2 * nq + 4 * nkv + 2 * nrow)}
    bw = bandwidth(torch.cuda.get_device_name(0))
    tpu = {"fwd": "src/repro/kernels/flash_attention.py:218",
           "fwd_lse": "src/repro/kernels/flash_attention.py:293",
           "bwd_dq": "src/repro/kernels/flash_attention.py:360",
           "bwd_dkv": "src/repro/kernels/flash_attention.py:380"}
    rows, bursts = [], {}
    for n in names:
        flops, nbytes = work[n]
        by_ops, by_bytes = flops / PEAK_BF16, nbytes / bw
        t = {"ms": time_ms(torch, kernel[n]),
             "plain_ms": time_ms(torch, plain_fn[n])}
        burst = bursts[n] = burst_ms(torch, kernel[n])
        rows.append({"name": f"flash_{n}_bf16", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                     "replaces": tpu[n], "launches": None,
                     "max_abs_err": err[n], **t,
                     "bound_ms": max(by_ops, by_bytes) * 1e3,
                     "bound_by": "operations" if by_ops >= by_bytes
                     else "bytes", "library_ms": library[n]})
        say({"phase": "flash_bf16", "kernel": n, "shape": list(FLASH_LAYER),
             "flops": flops, "bytes": nbytes, **t,
             "bound_ms": rows[-1]["bound_ms"],
             "bound_by": rows[-1]["bound_by"], "library_ms": library[n],
             "kernel_TFLOPs": flops / t["ms"] / 1e9, "burst_ms": burst,
             "burst_TFLOPs": flops / burst / 1e9,
             "library_burst_ms": lib_burst[n[:3]]})
    say({"phase": "flash_bf16", "shape": list(FLASH_LAYER),
         "bwd_dq_plus_dkv_burst_ms": bursts["bwd_dq"] + bursts["bwd_dkv"],
         "library_bwd_burst_ms": lib_burst["bwd"]})
    del q, k, v, do, o, lse, delta, dq, dk, dv, leaves, out
    torch.cuda.empty_cache()
    return rows


def phase_flash_bf16_path(torch, dev):
    """Phase 6's bf16 kernels on their path: one inner step of diloco_400m
    at full width with ``cfg.replace(use_pallas=True,
    compute_dtype="bfloat16")`` (the loss and its gradients, then one
    no-grad forward), as a user reaches it through ``Arch.loss``. The
    counters are set to 0 just before and read just after: 2·L
    ``fwd_lse_bf16`` (remat runs the forward twice), L ``bwd_dq_bf16``
    and L ``bwd_dkv_bf16``, L ``fwd_bf16``, and 0 for every other
    kernel. Returns the launches."""
    from repro_torch import tree
    from repro_torch.models.registry import get_arch

    arch = get_arch("diloco_400m")
    cfg = arch.cfg.replace(use_pallas=True, compute_dtype="bfloat16")
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(7)
    params = arch.init(generator=gen, device=dev, cfg=cfg)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen,
                         device=dev)
    leaves = [t.requires_grad_(True) for t in tree.leaves(params)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    loss, _ = arch.loss(tree.unflatten(params, leaves), {"tokens": toks},
                        cfg=cfg)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        eval_loss, _ = arch.loss(params, {"tokens": toks}, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches()
    want = expect_launches(flash_fwd_lse_bf16=2 * L, flash_bwd_dq_bf16=L,
                           flash_bwd_dkv_bf16=L, flash_fwd_bf16=L)
    if got != want:
        raise SystemExit(f"flash_bf16_path: launches {got}, want {want}")
    if not (math.isfinite(float(loss)) and math.isfinite(float(eval_loss))
            and all(bool(torch.isfinite(g).all()) for g in grads)):
        raise SystemExit("flash_bf16_path: a loss or gradient is not "
                         "finite")
    say({"phase": "flash_bf16_path", "arch": "diloco_400m",
         "compute_dtype": "bfloat16", "batch": BATCH, "seq": SEQ,
         "loss": float(loss), "eval_loss": float(eval_loss),
         "step_plus_eval_s": wall,
         "launches": {n: c for n, c in got.items() if c}})
    del params, leaves, grads, loss, eval_loss
    torch.cuda.empty_cache()
    return {n: got[n] for n in ("flash_fwd_bf16", "flash_fwd_lse_bf16",
                                "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")}


# phase 35: the island step of diloco_150m at full width on (data 1, model
# 2), two ranks sharing the card; the port's f32 bound against the
# unsharded step, and phase 34's memory gate
ISLAND_SHAPE = (1, 2)
ISLAND_ATOL, ISLAND_RTOL = 1e-5, 1e-4
# AdamW's first moments (0.1 of the clipped gradient, rounded to bf16 once
# after its reduce), leaf by leaf: within one bf16 ulp of the leaf's
# largest entry (2⁻⁷ of it)
ISLAND_M_REL = 2.0 ** -7
# xlstm_350m's sequence in phase 35: its cells step once per token (a
# launch-bound loop), and the unsharded check holds a group's activations
# (``dryrun.island_step_cost`` on meta, B 8, 4 layers, (1, 2): 4.80 GB a
# rank and 9.49 GB unsharded at S 128, about linear in S)
ISLAND_XLSTM_SEQ = 256


def phase_island(torch, dev, shape=ISLAND_SHAPE, arch_name="diloco_150m",
                 cards=1, n_layers=None, seq=SEQ):
    """Phase 35: one inner train step of ``arch_name`` at full width (B 8,
    S 1024, f32 params and compute through the step's bf16 weight cast;
    ``n_layers``: its depth cut to that many layers, ``seq``: the sequence
    cut to that many tokens, both printed as ``reduced``) on an island
    mesh of ``shape`` (data, model): the dry
    run's sharded step (``launch/island.py``; an MoE model's tokens
    grouped by the data axis's size) on one rank per chip of the mesh, on
    this card's ranks (gloo, collectives staged through the host) or one a
    card over NCCL (``cards`` > 1), from m = 0 and
    ``island.second_moments``.
    Held against the unsharded step of the same params, state and batch
    on the card: the loss and every param after the step (atol 1e-5,
    rtol 1e-4), and the first moments leaf by leaf within
    ``ISLAND_M_REL`` of the leaf's largest; each rank's measured
    collectives equal
    to the dry run's count for that mesh and step (op and bytes, in
    order); each rank's peak memory over the step within phase 34's gate
    of the dry run's per-chip estimate (its blocks of the arguments plus
    the meta run's peak of live storage). Of an MoE model it prints how
    many (token, k) router choices of the sharded step differ from the
    unsharded step's (a near-tie decided otherwise by TP's reordered
    sums; no bound is loosened for one)."""
    from repro_torch.launch import dryrun, mesh
    from repro_torch.models.registry import get_arch

    t0 = time.perf_counter()
    arch = get_arch(arch_name)
    cfg = arch.cfg
    from repro_torch import tree
    reduced = {}
    if n_layers is not None and n_layers < cfg.n_layers:
        reduced["n_layers"] = [cfg.n_layers, n_layers]
        cfg = cfg.replace(n_layers=n_layers)
    if seq < SEQ:
        reduced["seq"] = [SEQ, seq]
    reduced = reduced or None
    ranks = shape[0] * shape[1]
    layout = mesh.make_pod_layout(ranks, "cuda")
    # the dry run's count (on meta tensors, on this process's CPU) while
    # the ranks run
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as pool:
        counting = pool.submit(dryrun.island_step_cost, cfg, BATCH, seq,
                               shape)
        t1 = time.perf_counter()
        # every rank also runs the unsharded step of the same params,
        # state and batch (drawn from the same seed) on its card and
        # compares its blocks
        res = mesh.spawn("repro_torch.launch.island:train_steps", layout,
                         shape, [{"cfg": cfg, "init_seed": 35,
                                  "tokens_shape": (BATCH, seq),
                                  "microbatches": 1,
                                  "check": {"atol": ISLAND_ATOL,
                                            "rtol": ISLAND_RTOL,
                                            "m_rel": ISLAND_M_REL}}])
        rank_s = time.perf_counter() - t1
        counted = counting.result()
    got = [r[0] for r in res]
    for g in got:
        chk = g["check"]
        if chk["m_leaves_beyond"] or chk["params_beyond"] or abs(
                g["loss"] - chk["loss"]) > ISLAND_ATOL + ISLAND_RTOL * abs(
                    chk["loss"]):
            raise SystemExit(f"island: the sharded step differs from the "
                             f"unsharded one: {g['loss']} {chk}")
    entries = sum(g["check"]["entries"] for g in got)
    want_coll = [tuple(c) for c in counted["collectives"]]
    for r, g in enumerate(got):
        if [tuple(c) for c in g["collectives"]] != want_coll:
            raise SystemExit(f"island: rank {r}'s collectives differ from "
                             f"the dry run's count")
    estimate = counted["argument_bytes"] + counted["peak_live_bytes"]
    gaps = [g["peak_bytes"] / estimate - 1.0 for g in got]
    if any(abs(x) > DRYRUN_MEMORY_TOL for x in gaps):
        raise SystemExit(f"island: peaks {[g['peak_bytes'] for g in got]} "
                         f"against the estimate {estimate} ({gaps})")
    by_op = {}
    for op, nb in want_coll:
        by_op[op] = by_op.get(op, 0) + nb
    say({"phase": "island", "arch": arch_name, "reduced": reduced,
         "params": sum(math.prod(t.shape) for t in tree.leaves(
             get_arch(arch_name).abstract_params(cfg)[0])),
         "router_choices": [g["check"]["router_choices"] for g in got],
         "router_choices_differ": [g["check"]["router_choices_differ"]
                                   for g in got],
         "mesh": list(shape), "cards": cards, "backend": layout.backend,
         "staged": layout.staged, "batch": BATCH, "seq": seq,
         "loss": got[0]["loss"], "unsharded_loss": got[0]["check"]["loss"],
         "params_max_abs_diff": max(g["check"]["params_max_abs_diff"]
                                    for g in got),
         "m_max_abs_diff": max(g["check"]["m_max_abs_diff"] for g in got),
         "m_rel_max": max(g["check"]["m_rel_max"] for g in got),
         "m_rel_bound": ISLAND_M_REL, "entries_compared": entries,
         "atol": ISLAND_ATOL,
         "rtol": ISLAND_RTOL, "collectives": len(want_coll),
         "intra_bytes_per_rank": sum(nb for _, nb in want_coll),
         "intra_bytes_by_op": by_op,
         "counted_equals_measured": True,
         "peak_measured_bytes": [g["peak_bytes"] for g in got],
         "peak_estimate_bytes": estimate, "peak_rel_err": gaps,
         "memory_tol": DRYRUN_MEMORY_TOL, "counted_flops": counted["flops"],
         "ranks_s": rank_s, "elapsed_s": time.perf_counter() - t0})


def main_cards(torch, dev, cards: int) -> int:
    """``--cards N`` (N > 1): only the sharded transport across N cards,
    one pod rank and one replica per card over NCCL: phase 22 against
    gloo ranks on the CPU, then phase 21 at full width; with four cards,
    phase 35 on (data 2, model 2) at diloco_400m."""
    if torch.cuda.device_count() < cards:
        print(f"chip_smoke: --cards {cards} needs {cards} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    phase_device(torch)
    phase_smoke_sharded(torch, dev, pods=cards)
    phase_train_sharded(torch, dev, pods=cards, k=cards)
    if cards == 4:
        # the island step over NCCL, a rank a card, at diloco_400m
        phase_island(torch, dev, shape=(2, 2), arch_name="diloco_400m",
                     cards=cards)
    print(card_line(), flush=True)
    say({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if sys.argv[1:2] == ["--cards"]:
        return main_cards(torch, dev, int(sys.argv[2]))
    phase_device(torch)
    rows = phase_kernels(torch, dev)
    phase_smoke(torch, dev)
    launches = phase_train(torch, dev)
    phase_profile(torch, dev)
    rows += phase_flash(torch, dev)
    rows += phase_flash_bf16(torch, dev)
    launches.update(phase_flash_bf16_path(torch, dev))
    # each kernel's launches from its own path's run
    launches.update({n: c for n, c in phase_train_400m(torch, dev).items()
                     if n.startswith("flash_") and not n.endswith("_bf16")})
    phase_profile(torch, dev, "diloco_400m", "profile_400m", use_pallas=True)
    rows += phase_mixed_kernels(torch, dev)
    phase_smoke_mixed(torch, dev)
    mixed = phase_train_mixed(torch, dev)
    launches.update({n: mixed[n] for n in ("fused_adamw_mixed",
                                           "sign_prune")})
    phase_profile(torch, dev, label="profile_mixed",
                  policy=("bfloat16", "float32"))
    launches["fused_adamw_bf16"] = \
        phase_train_bf16(torch, dev)["fused_adamw_bf16"]
    rows += phase_quant_kernels(torch, dev)
    launches.update(phase_train_stream(torch, dev))
    phase_smoke_stream(torch, dev)
    rows += phase_wire_kernels(torch, dev)
    launches.update(phase_train_async(torch, dev))
    phase_smoke_async(torch, dev)
    codec_rows = phase_codec_kernels(torch, dev)
    launches.update({r["name"]: r["launches"] for r in codec_rows[1:]})
    rows += codec_rows
    sharded, sharded_traffic = phase_train_sharded(torch, dev)
    launches.update(sharded)
    phase_smoke_sharded(torch, dev)
    crash = CrashRun()
    try:
        phase_resume(torch, dev)
        phase_guard(torch, dev)
        phase_milestone(torch, dev)
        phase_resume_sharded(torch, dev, crash)
    finally:
        crash.stop()
    phase_elastic_sharded(torch, dev)
    phase_train_gossip(torch, dev)
    serve = phase_serve_400m(torch, dev)
    phase_serve_smoke(torch, dev)
    phase_families_smoke(torch, dev)
    phase_train_zamba2(torch, dev)
    families = phase_serve_families(torch, dev)
    phase_dryrun(torch, dev, sharded_traffic)
    phase_island(torch, dev)
    # the MoE/MLA family at full width, depth cut so that both ranks and
    # each rank's unsharded check fit the card beside each other
    phase_island(torch, dev, arch_name="olmoe_1b_7b", n_layers=2)
    phase_island(torch, dev, arch_name="deepseek_v2_lite_16b", n_layers=1)
    # the hybrid family: Mamba2's heads over "model", two invocations of
    # the SHARED block
    phase_island(torch, dev, arch_name="zamba2_2_7b", n_layers=12)
    # the xLSTM family: one group (three mLSTM blocks, an sLSTM block),
    # each rank its own block of the inner width; the per-token loop's
    # launches and the unsharded check's memory cut the sequence
    phase_island(torch, dev, arch_name="xlstm_350m", n_layers=4,
                 seq=ISLAND_XLSTM_SEQ)
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["name"] in serve:        # their launches on the serve paths
            row["serve_launches"] = serve[row["name"]]
            row["olmoe_serve_launches"] = families[row["name"]]
    say({"kernels": rows})
    print(card_line(), flush=True)
    say({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
