#!/usr/bin/env python3
"""Smoke run of repro_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` and
checks, on the card:

  1. device  — the card's name and power limit (``nvidia-smi``);
  2. build   — every kernel source, one ``nvcc`` per source, in parallel;
     each library's ptxas report, kept beside it (read whether the library
     was built now or before), in which every instantiation of K7's bf16
     body, of K7b's two bf16 passes and of K1/K2/K3's tensor-core body
     (``PTXAS_BODIES``) must show no stack frame and no spill stores or
     loads;
  3. kernels — K1 (closure), K2 (fused frontier step), K3 (multi-shard
     map), K4 (multi-shard filter), K5 (contains top-k) and K6 (rules
     top-k) against their plain PyTorch versions on seeded inputs, bit for
     bit: widths whose shared memory needs more than 48 KB up to the
     library's ``max_w`` (refused one word past it),
     K1 and K3 over k ∈ {1, 2, 8} shards in one launch; K4 on K ∈ {1, 2,
     8} shards' partials (``FILTER_EDGE_*``) for every frontier variant,
     W ∈ {1, 4, 5, 11, 33} and B ∈ {1, 255, 8192} (and W 2000), CbO
     generators outside LOW among them; K5 and K6 at S ∈ {8, 64, 1000, 1024}
     queries, tables of 1, 7, 8192 and 2**20 + 3 rows (above the
     reference kernels' 2**22 cells), W ∈ {4, 5}, k ∈ {1, 5, 64} and,
     past one launch's 64 winners, k ∈ {65, 100, 128, C + 1}, live counts
     below the table size, forced ties, min_conf 0.1 and 0.7, and cases
     where no row matches; K5's table split across CTAs at its edges
     (``CONTAINS_SPLIT_*``): S ∈ {1, 8, 63, 64, 1000}, live ∈ {0, 1, 255,
     256, 257, 4282, 2**20 + 3}, k ∈ {1, 5, 64, 65, 130}, ties in support
     across every slice boundary, pad rows never read; the top-k plan both
     kernels share (``check_topk_plan``); K6's table split across CTAs at its edges
     (``RULES_SPLIT_*``): S ∈ {1, 8, 63, 64, 1000}, k ∈ {1, 5, 64, 65,
     100, C + 1}, live counts of 1, of whole slices and one row either side,
     equal (metric, rule id) in different slices, rules firing in every
     slice, in one or in none; K1, K2 and K3's tensor-core body at its
     edges (``TC_EDGE_*``): W ∈ {1, 4, 5, 10, 11} (11: the SIMT body), N
     and B ∈ {1, 63, 65, 8191}, K1 and K3 over k ∈ {1, 2, 8}, every K2
     variant and scalar triple, rows with bit 31 set and all-ones pad rows
     or candidates that match no row, and the row split (B = 8 against
     census-income's 13,056-row shards), each launch through the tensor
     body exactly where W <= TC_MAX_W; K7 (flash attention) against its plain version
     within ``K7_TOL`` in float32 and bfloat16, on every case shape of
     tests/test_flash_attention.py and at gemma2-9b's head shape for
     S ∈ {1, 63, 64, 65, 4097, 5000}, causal or not, window 4096 or none,
     cap 50 or none, through both wrappers, with valid_from all 0, mixed
     and S - 1 (pad rows exactly 0); K7's bf16 body at its edges
     (``K7_EDGE_*``): G ∈ {1, 2, 3, 4, 8}, S and T ∈ {63, 64, 65, 127,
     128, 129, 4097}, hd ∈ {8, 24, 128, 256}, windows 64, 65 and 128,
     valid_from on and beside the 64- and 128-row edges, and q, k and v
     as slices of one fused projection; K2 and K4 with the valid count on
     the card (``COUNT_*``): a 0-dim int32 tensor at 0, 1, B - 1, B and
     B + 5, row_off 0 and B // 4, every variant, K2 on the tensor and the
     SIMT body, K4 at K 1 and 8, each equal to the int form's launch and to
     the plain version;
  4. main path, one shard — MRGanter+ (local pruning) and MRCbo on the
     full-scale mushroom context (8124 x 125) at min_support=406 through
     ``backend="kernel"``: concept, iteration and closure counts equal the
     reference's, concept sets equal the ``backend="torch"`` run's, and
     every kernel of the path was launched, every K1 and K2 launch through
     the tensor-core body; one more kernel run keeps a copy of the operands
     of every launch;
  5. main path, k object shards — the same two drivers through
     ``ClosureEngine(ctx, n_parts=k, reduce_impl=...)`` for every
     AND-allreduce schedule at k = 8 and for rsag at k = 2 and 4: the same
     counts, the reference's modeled wire bytes, concept sets equal the
     ``backend="torch"`` run's at the same plan, K1 and K3 (every launch
     through the tensor-core body) and K4 (folding the shards' partials
     itself) launched and K2 not; MRCbo at k = 8
     through ``backend="matmul"``; census-income at its
     published shape (103,950 x 133) at k = 8, rsag, against the
     reference's counts and bytes; one more kernel run of the k = 8 rsag
     plans keeps a copy of the operands of every K1/K3/K4 launch;
  12. main path, 2-D plans (object × candidate, ``ShardPlan.simulated(k,
     cand_parts=c)``) — MRGanter+ (local pruning, and with closure dedupe)
     and MRCbo on mushroom as in phase 4 for every plan of ``CAND_PLANS``
     (1 × 2 and 1 × 4: K1 and K2 launched, K3/K4 not; 4 × 2 and 2 × 4 under
     rsag and auto: K1, K3 and K4 launched, K2 not), MRGanter+ once more at
     max_batch 1024, census-income at 2 × 4 rsag: counts, modeled wire
     bytes and schedule census equal the reference's (``CAND_EXPECTED``),
     concept sets equal phase 4's and the 2-D ``backend="torch"`` run's;
     warm walls beside phase 5's 1-D walls at as many shards × blocks,
     with the collector's pauses.  Then phase 3's check on this path's own
     chunks: every K2 chunk of a 1 × 4 run and every K4 chunk of a 2 × 4
     run launched per block at ``row_off = c · Bc`` equals the one
     whole-chunk launch bit for bit (``kernels_row_off``, with both
     timings); then the timed runs of phases 4, 5 and 12 that a garbage
     collection of generation 1 or 2 landed in, with its milliseconds
     (``gc_pauses``);
  6. full lattice — MRGanter+ and MRCbo on mushroom at scale 0.01, and all
     three drivers on the paper's example and a seeded synthetic context
     (on one shard and on 8 shards), against the NextClosure / CloseByOne
     oracles;
  8. serve — phase 4's intents in a ConceptStore on one shard and on
     k = 8 (rsag); the reference CLI's seeded batch (4096 closure queries,
     top-5 of the first 256, slots 64) and the lookup, order and extent
     reads through ``backend="kernel"`` and ``"torch"``: answers equal
     between the backends, their SHA-256, the closure hit rate, the
     modeled bytes and the per-schedule rounds equal the reference's, K5
     launched once per top-k micro-batch and K1 once per closure round,
     every K1 launch through the tensor-core body (counts read from a plain
     kernel run; one more run keeps a copy of the operands of every K5 and
     K1 launch and must launch as often); then 8 seeded rows streamed onto
     the full lattice of mushroom at scale 0.01 at k = 1 and 8: the
     reference's grown concept count and intents, version 1, post-update
     lookup hit rate 1.0, every K1 launch through the tensor-core body;
  13. tracing — MRGanter+ at 2 × 4 rsag and phase 8's serve batch (k = 1),
     each untraced, traced and untraced again: traced results bit-identical
     to untraced ones, the trace valid (``validate_trace``), the span
     rollup (count, total ms, p50 of ``mine/round/{expand, dispatch,
     allreduce, filter}`` and ``query/micro_batch``) and the traced against
     untraced walls printed; a ``torch.profiler`` device trace
     (``start_device_trace``) over a 2 × 4 and a 1 × 4 run must start,
     export, and name the K2 and K3 forms of the tensor-core closure body
     and K4's filter kernel;
  14. async rounds — MRGanter+ (local pruning) and MRCbo with
     ``rounds="async"`` on mushroom as in phase 4 at 1 x 1 and 1 x 4 (K1,
     K2), 8 x 1 and 2 x 4 rsag (K1, K3, K4); MRGanter+ at 2 x 4 and max_batch
     1024 (speculative rounds fall back on the card); MRGanter's walk (K1)
     capped at 200 iterations; census-income at 8 x 1 rsag.  Each a guarded
     run (every speculative dispatch under ``set_sync_debug_mode("error")``,
     after a positive control that a host read there raises), a warm async
     run and a warm sync run: counts, bytes, schedule, transfer and
     speculation census equal the reference's async runs
     (``ASYNC_EXPECTED``), concept sets equal phase 4's, iterations the sync
     run's, MRGanter's walk the sync walk in order; the walls, host-blocked
     and dispatch seconds and the collector's pauses of all three.  One
     traced async run: valid, with a ``spec/dispatch`` span inside an
     earlier round's window.  Then MRGanter+ at 1 x 1 and the walk, sync
     and async, under ``torch.profiler``: launches, sorts, copies and
     synchronisations enqueued, the device's self time;
  9. rules — full-scale mushroom mined at min_support=812 on k = 8 rsag,
     the DG and Luxenburger bases at min_conf 0.5, the rule index, and
     1024 seeded rule queries at k = 5 ranked by confidence and by lift
     through ``backend="kernel"`` and ``"torch"``: the reference's concept,
     implication and partial-rule counts, basis SHA-256 and answer SHA-256,
     answers equal between the backends, K6 launched once per micro-batch
     (read as in phase 8, and one more run keeps the K6 operands);
  15. serve under load — the admission queue (``repro_torch.serve``,
     ``backend="kernel"``, slots 64, max_wait 2 ms, depth 512) over phase
     8's stores (k = 1 and 8 rsag), phase 9's store and rule index and
     phase 8's stream lattice (k = 8).  Virtual-clock runs (``run_load`` on
     a clock that only its sleep advances): Poisson at 2,000 qps for 2 s
     with the default mix at k = 1 and 8; burst ×4 at a mean of 2,000 qps
     with rules in the mix; 400 qps for 0.15 s with streamed updates of 2
     rows — counts, dispatch causes, occupancy, kinds, virtual e2e and
     admission-wait views, the SHA-256 of every ticket's answer (and the
     final snapshot's intents) equal the reference's (``LOAD_EXPECTED``).
     Timed runs (``LOAD_WALL``: Poisson at 1,000 qps for 3 s at k = 1 and
     8, burst ×4 at k = 1, 200,000 qps for 0.5 s at k = 1): every answered
     ticket equal to a pre-formed batch's row, submitted = admitted + shed,
     completed = admitted, one e2e and admission-wait observation per
     completion; achieved qps, e2e and admission-wait percentiles,
     occupancy, causes, shed rate and the collector's pauses printed; a
     ``MetricsServer`` scraped once from another thread during the first,
     its text parsed and holding the queue-depth, e2e and service
     families.  The dispatcher thread (2,000 closure and top-k submissions
     at ~2,000 qps, then ``stop(drain=True)``) and the reference's
     concurrent-commit scenario (4 commits on a second thread while 64
     closure tickets dispatch); then ``fca serve --load-qps`` as a
     subprocess, its ``serve_load`` keys the reference CLI's
     (``LOAD_KEYS``) and its ``--metrics-dump`` parsed by ``python -m
     repro_torch.obs.export``.  K1 launched in every run, K5 in every run
     whose mix holds top-k, K6 in every run whose mix holds rules, and
     none where it does not;
  16. analysis — the static checks (``repro_torch.analysis``): ``python -m
     repro_torch.analysis --strict --json`` as a subprocess, exit 0 and no
     findings; then the SPMD audit's sweep on the card, in process: the
     hygiene self-test (a host read inside a recorded step must raise under
     ``set_sync_debug_mode("error")``), every cached frontier step of both
     backends on the 1 x 1, 4 x 1 and 2 x 4 plans under rsag and allgather
     (K2 launched only on 1 x 1, K3 and K4 only on k > 1), the query steps
     at k = 1 and 4 (K1, K5, K6) and the basis passes, each step call under
     the guard, its recorded wire bytes equal to the plan's model; then the
     recorder over whole mining runs (``ANALYSIS_RECORDED``): MRGanter+ and
     MRCbo on phase 5's k = 8 rsag plan and census-income at 2 x 4 rsag,
     ``backend="kernel"``, the recorded closure-word bytes equal to the
     engine's charged census and the reference's (``MULTI_BYTES``,
     ``CAND_EXPECTED``), one recorded reduce per charged round; the walls
     with and without the recorder, in turns after a warm-up run (off, on,
     on, off);
  10. LM serve, reduced — the eight archs of ``LM_REDUCED_ARCHS``
     (attention-only gemma2-9b and codeqwen1.5-7b, qwen2-vl-72b with
     M-RoPE, recurrentgemma-2b's Griffin layers, mamba2-370m's SSD layers,
     arctic's and llama4-scout's MoE FFNs, musicgen-large) ``reduced()``
     through ``ServeEngine`` on numpy weights (``LM_SEED``), prompts
     with token ids V, V + 5, -1, -V and -V - 3 among them (mamba2's long
     prompt 64 tokens, two of its chunks): the reference's greedy tokens
     (``LM_REDUCED_EXPECTED``) exactly, K7 launched once per attention
     layer of the prefill;
  11. LM serve, full width — gemma2-9b at its published width and depth
     (bf16, seeded torch.Generator weights on the card), four prompts of
     7, 1024, 4097 and 5000 tokens, 16 greedy tokens: K7 launched 42 times
     per prefill; the same run through the plain attention; prefill
     logits within ``LM_LOGIT_TOL`` and tokens equal up to the first
     step whose plain top-2 margin is under it; prefill and decode times,
     a torch.profiler breakdown of warm decode steps (device-busy time and
     share, the costliest kernels), peak memory; K7 on every captured
     chunk, the costliest beside its plain version, its bound and
     scaled_dot_product_attention on the cap-free chunk, with K7's share
     of its bound on both and its time over SDPA's;
  17. LM families, full width — ``LM_FAMILIES``: recurrentgemma-2b (26
     layers, prompts 7, 1024, 2049, 3000), mamba2-370m (48 layers, 7,
     300, 1000, 1024), musicgen-large (48 layers, 7, 256, 1024, 1500) and
     llama4-scout (depth cut to 12 layers, 7, 512, 2048, 4096), bf16
     seeded weights, 4 slots, 16 greedy tokens: K7 launched 8 / 0 / 48 /
     12 times per prefill; where K7 runs, the same run through the plain
     attention, prefill logits within ``LM_FAMILY_TOL_FRAC`` of their std
     and tokens equal up to the first close plain margin, and K7's
     costliest chunk beside its plain version, its bound and (musicgen,
     llama4) SDPA on the pad-free chunk; the state caches against the
     chunked forms (recurrentgemma, mamba2; ``LM_STATE_SPLIT``, held in
     float32, reported in bf16); musicgen's
     embeds path bit-equal to its ids path; llama4's MoE drops (> 0 in
     the prefill, none in decode); prefill and decode times, peak memory;
  18. K7b alone — the attention's backward (dq, dk, dv from K7's
     log-sum-exp) against autograd through K7's plain version at
     ``K7B_SHAPES`` (gemma2-9b's heads with the cap, its 4096 window
     reached, and S 1, 7, 130; recurrentgemma-2b's G 10 and window 2048;
     llama4-scout's G 5, hd 128; musicgen-large's G 1, hd 64; hd 24 and 8,
     zero-padded in the bf16 body, at G 3; the bf16 passes' tile edges,
     S 31-33, 63-65 and 127-129 at hd 256 and 128 with G 1, 3 and 5 and
     windows ending inside a key tile), float32 and bfloat16, within
     ``K7B_TOL`` and ``K7B_MIN_COS``; every case run twice on the same
     inputs, bit-equal (no atomics); K7's log-sum-exp against
     torch.logsumexp;
  19. training, reduced — the ten configs ``reduced()`` train 3 steps
     through the Trainer with the arch plan's optimizer on the numpy weights
     of phase 10: each step's loss within ``TRAIN_LOSS_TOL`` of the
     reference's (``TRAIN_REDUCED_EXPECTED``), K7 launched twice per
     attention layer and step (the forward and the backward's recompute),
     K7b once;
  20. training, full width — gemma2-9b at its published width, 12 of 42
     layers, train_4k's 4096 positions at batch 1, AdamW: step 1's
     attention gradients (wq, wk, wv, wo of every layer) through K7/K7b
     non-zero and within ``TRAIN_GRAD_MIN_COS`` of the plain attention's;
     the Trainer's 4 steps (0-based 0 to 3) with a checkpoint after step 1
     (``step_00000002``) and a fault injected at the start of step 3
     (``fault_hook``), the restore, the replayed step 2 (the third)
     bit-identical to its first run; step walls, checkpoint save and
     restore walls and bytes, peak memory;
  21. the partitioner (``repro_torch.dist.partition``) on a one-rank NCCL
     group and its 1 x 1 data x model mesh (see ``PARTITION_EP_ARCH``):
     (a) llama4-scout at phase 17's width and depth through
     ``ServeEngine(partitioner=)`` on phase 17's model (run inside phase
     17): K7 on each of its 12 layers, the expert-parallel MoE body in
     each, its drops the unpartitioned prefill's, logits within
     ``LM_FAMILY_TOL_FRAC`` of the unpartitioned run's and the same
     tokens; (b) phase 19's ten configs through the partitioned train
     step, each plan's FSDP and optimizer, the reference's losses; (c) a
     state of the unpartitioned trainer restored onto the mesh, its next
     loss the unpartitioned next loss; (d) K7 and K7b at query offsets
     (``K7_OFFSET_S``): chunks against the full launch and the plain
     versions;
  22. the dry-run (``repro_torch.launch.dryrun``, ``dryrun_lib``,
     ``op_analysis``): (a) ``python -m repro_torch.launch.dryrun`` as a
     subprocess over its fake group of 256 ranks (the 16 x 16 mesh), fake
     tensors on the card's device type, one cell per shape kind and model
     family (``DRYRUN_CELLS``) and the FCA cell at production scale: every
     applicable cell "ok", long_500k "skipped" on an attention-only arch,
     the records printed and kept in ``build/dryrun/phase22.jsonl``; (b)
     the prediction against the card: phase 20's configuration and phase
     11's prefill traced on a 1 x 1 mesh over a one-rank NCCL group, then
     one more real step of each (built anew, after a warm step) under
     ``op_analysis``: per-device FLOPs equal (K7 and K7b through their
     formulas), no collective, the train state's bytes within
     ``DRYRUN_STATE_TOL`` of the growth of ``memory_allocated`` when it is
     built, the predicted peak within ``DRYRUN_PEAK_TOL`` of
     ``max_memory_allocated`` (the ratio printed); (c) the three FCA
     examples (``EXAMPLE_ARGS``) in this process: their printed lines,
     times masked, equal to the reference examples' (``EXAMPLES_EXPECTED``),
     K1, K3 and K4 (quickstart), K1-K4 (mining), K1, K3, K4 and K5 (the
     query service) launched;
  7. times (run last) — each kernel on every chunk phases 4, 5, 8 and 9
     gave it (CUDA events behind a spin kernel, so that they bracket device
     work alone; median of 25 after warm-up): the sum over the run, by the
     run that gave the chunks, and its bound, and the costliest chunk
     beside its plain version, its bound, and its time without the spin
     kernel (``unqueued_ms``, the host's launch path included); for K1, K2
     and K3 also the bound of their two int8 tensor-core products
     (``tc_bound_ms``), the smaller of the two routes' bounds
     (``table_bound_ms``) and the port's ``closure_matmul`` on the
     costliest chunk (``matmul_backend_ms``); for K4 also the torch ops the
     parent tree ran between K3 and K4 on the same chunks (the simulated
     AND-allreduce, the support sum, the LOW gather), on its costliest
     chunk and summed (``parent_between_ms``, ``run_parent_between_ms``).
     The kernels line's ``launches`` also counts phase 12's kernel runs,
     phase 14's warm async runs, phase 15's load runs, phase 16's sweep
     and recorded runs and phase 22's examples, whose chunks are not
     replayed here; K7's counts phase 10's prefills, phase 11's and phase
     17's kernel runs, phases 19's and 20's train steps, phase 21's (a)-(c)
     and phase 22's real steps.  K7b's record (``attention_backward``):
     its time at gemma2-9b's full-width layer (``K7B_TIMED``, the cap)
     beside autograd through the plain version and its bound (10 hd
     operations per valid pair at the bf16 tensor-core rate), its three
     passes apart (``dot_ms``, ``dkdv_ms``, ``dq_ms``: CUDA events around
     each launch), and SDPA's backward on the cap-free shape as
     ``library_ms``; its launches those of phases 19, 20, 21 and 22.

TF32 is switched off for matmuls and cuDNN (float32 products in full
float32).  Any failed check raises and the script exits non-zero.  The second-to-last
line is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  It needs one card and exits non-zero
without one.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Reference values of the main path and the full lattices (the JAX package,
# backend="jnp", same contexts).
MAIN_MIN_SUPPORT = 406
MAIN_EXPECTED = {
    "mrganter+": {"concepts": 4282, "iterations": 8, "closures": 180_611},
    "mrcbo": {"concepts": 4282, "iterations": 8, "closures": 139_782},
}
LATTICE_EXPECTED = {
    "paper": {"concepts": 21, "iterations": {"mrganter": 21, "mrganter+": 5, "mrcbo": 5}},
    "synthetic": {"concepts": 1751, "iterations": {"mrganter": 1751, "mrganter+": 7, "mrcbo": 8}},
    "mushroom-0.01": {"concepts": 4440, "iterations": {"mrganter+": 7, "mrcbo": 10}},
}
# The multi-shard main path (phase 5): the reference's modeled wire bytes
# per plan and driver (the JAX package, backend="jnp", same context and
# threshold); counts are those of MAIN_EXPECTED on every plan.
MULTI_BYTES = {
    (8, "allgather"): {"mrganter+": 165_272_576, "mrcbo": 131_783_680},
    (8, "rsag"): {"mrganter+": 41_318_144, "mrcbo": 32_945_920},
    (8, "pmin"): {"mrganter+": 5_164_768_000, "mrcbo": 4_118_240_000},
    (8, "auto"): {"mrganter+": 41_409_536, "mrcbo": 33_037_312},
    (2, "rsag"): {"mrganter+": 5_902_592, "mrcbo": 4_706_560},
    (4, "rsag"): {"mrganter+": 17_707_776, "mrcbo": 14_119_680},
}
# census-income at its published shape, MRGanter+ with local pruning at 5 %
# (ceil(0.05 * 103,950)), k = 8, rsag (the same reference; k = 1 gives the
# same counts and 0 bytes).
CENSUS_SHAPE = (103_950, 133, 5)  # objects, attributes, words
CENSUS_PADDED = 104_448  # a multiple of 8 shards x 256-row blocks
CENSUS_MIN_SUPPORT = 5198
# The kernels each main path runs: K1 and K2 on one shard; K1 (the ∅''
# round), K3 and K4 on k > 1 shards, where K2 must not launch.
ONE_SHARD_KERNELS = ("closure", "fused_step")
MULTI_SHARD_KERNELS = ("closure", "map_closure", "filter_step")
CENSUS_EXPECTED = {"concepts": 104, "iterations": 4, "closures": 7_286,
                   "bytes": 2_941_120}
# The 2-D main path (phase 12): mushroom as in phase 4 on object x candidate
# plans (k, c, schedule), three drivers; MRGanter+ once more at a max_batch
# of 1024 (rounds of several chunks); census-income as in phase 5 at 2 x 4.
# K1 and K2 launch on the one-object-shard plans, K1, K3 and K4 (not K2) on
# the others.  CAND_EXPECTED holds the reference's counts, modeled wire
# bytes and schedule census (the JAX package, backend="jnp", on
# ShardPlan.simulated(k, cand_parts=c) with the same context, threshold and
# driver), derived once on the CPU by
# ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_reference.py cand``.
CAND_PLANS = ((1, 2, "rsag"), (1, 4, "rsag"), (4, 2, "rsag"), (4, 2, "auto"),
              (2, 4, "rsag"), (2, 4, "auto"))
CAND_DRIVERS = ("mrganter+", "mrganter+dedupe", "mrcbo")
CAND_SMALL_BATCH = (2, 4, "rsag", 1024)
CAND_CENSUS_PLAN = (2, 4, "rsag")
CAND_EXPECTED = {
    '1x2 rsag mrganter+': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 3049472, 'reduce_rounds': {'rsag': 17}},
    '1x2 rsag mrganter+dedupe': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 3049472, 'reduce_rounds': {'rsag': 17}},
    '1x2 rsag mrcbo': {'concepts': 4282, 'iterations': 8, 'closures': 139782, 'bytes': 2476032, 'reduce_rounds': {'rsag': 15}},
    '1x4 rsag mrganter+': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 9738240, 'reduce_rounds': {'rsag': 12}},
    '1x4 rsag mrganter+dedupe': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 9738240, 'reduce_rounds': {'rsag': 12}},
    '1x4 rsag mrcbo': {'concepts': 4282, 'iterations': 8, 'closures': 139782, 'bytes': 7821312, 'reduce_rounds': {'rsag': 11}},
    '4x2 rsag mrganter+': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 30495488, 'reduce_rounds': {'rsag': 17}},
    '4x2 rsag mrganter+dedupe': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 30495488, 'reduce_rounds': {'rsag': 17}},
    '4x2 rsag mrcbo': {'concepts': 4282, 'iterations': 8, 'closures': 139782, 'bytes': 24761088, 'reduce_rounds': {'rsag': 15}},
    '4x2 auto mrganter+': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 30508544, 'reduce_rounds': {'allgather': 2, 'rsag': 15}},
    '4x2 auto mrganter+dedupe': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 30508544, 'reduce_rounds': {'allgather': 2, 'rsag': 15}},
    '4x2 auto mrcbo': {'concepts': 4282, 'iterations': 8, 'closures': 139782, 'bytes': 24872448, 'reduce_rounds': {'allgather': 3, 'rsag': 12}},
    '2x4 rsag mrganter+': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 25968896, 'reduce_rounds': {'rsag': 12}},
    '2x4 rsag mrganter+dedupe': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 25968896, 'reduce_rounds': {'rsag': 12}},
    '2x4 rsag mrcbo': {'concepts': 4282, 'iterations': 8, 'closures': 139782, 'bytes': 20857088, 'reduce_rounds': {'rsag': 11}},
    '2x4 auto mrganter+': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 25968896, 'reduce_rounds': {'allgather': 12}},
    '2x4 auto mrganter+dedupe': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 25968896, 'reduce_rounds': {'allgather': 12}},
    '2x4 auto mrcbo': {'concepts': 4282, 'iterations': 8, 'closures': 139782, 'bytes': 20857088, 'reduce_rounds': {'allgather': 11}},
    '2x4 rsag mrganter+ max_batch=1024': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 23609600, 'reduce_rounds': {'rsag': 48}},
    'census 2x4 rsag mrganter+': {'concepts': 104, 'iterations': 4, 'closures': 7286, 'bytes': 1679680, 'reduce_rounds': {'rsag': 4}},
}


def cand_key(k: int, c: int, impl: str, driver: str, max_batch: int | None = None) -> str:
    return f"{k}x{c} {impl} {driver}" + (f" max_batch={max_batch}" if max_batch else "")


# The async main path (phase 14): phase 4's context and threshold with
# ``rounds="async"`` on object x candidate plans (k, c, schedule) — K2 on
# 1 x 1 and 1 x 4, K1, K3 and K4 on 8 x 1 and 2 x 4 — for MRGanter+ (local
# pruning) and MRCbo; MRGanter+ at 2 x 4 and a max_batch of 1024, whose
# speculative chunks under-cover and fall back; MRGanter's walk (K1) on one
# shard, capped at 200 iterations; census-income as in phase 5 (8 x 1
# rsag).  ASYNC_EXPECTED holds the reference's async runs on the same
# plans (the JAX package, backend="jnp"): counts, modeled wire bytes,
# schedule census, the H2D / D2H transfer census and the speculation
# census, derived once on the CPU by
# ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_reference.py async``.
ASYNC_PLANS = ((1, 1, "rsag"), (8, 1, "rsag"), (1, 4, "rsag"), (2, 4, "rsag"))
ASYNC_DRIVERS = ("mrganter+", "mrcbo")
ASYNC_SMALL_BATCH = (2, 4, "rsag", 1024)
ASYNC_GANTER = (1, 1, "rsag", 200)  # the plan and max_iterations of MRGanter's walk
ASYNC_CENSUS_PLAN = (8, 1, "rsag")
ASYNC_CENSUS_FIELDS = ("h2d_transfers", "h2d_bytes", "d2h_transfers", "d2h_bytes",
                       "spec_rounds", "spec_fallbacks", "spec_discarded")
ASYNC_EXPECTED = {
    '1x1 rsag mrganter+': {'concepts': 4282, 'iterations': 8, 'closures': 180910, 'bytes': 0, 'reduce_rounds': {'rsag': 28}, 'h2d_transfers': 6, 'h2d_bytes': 29952, 'd2h_transfers': 54, 'd2h_bytes': 1413552, 'spec_rounds': 12, 'spec_fallbacks': 4, 'spec_discarded': 5},
    '1x1 rsag mrcbo': {'concepts': 4282, 'iterations': 8, 'closures': 139782, 'bytes': 0, 'reduce_rounds': {'rsag': 24}, 'h2d_transfers': 3, 'h2d_bytes': 288, 'd2h_transfers': 32, 'd2h_bytes': 1208824, 'spec_rounds': 11, 'spec_fallbacks': 3, 'spec_discarded': 4},
    '8x1 rsag mrganter+': {'concepts': 4282, 'iterations': 8, 'closures': 180910, 'bytes': 42292992, 'reduce_rounds': {'rsag': 28}, 'h2d_transfers': 6, 'h2d_bytes': 29952, 'd2h_transfers': 54, 'd2h_bytes': 1413552, 'spec_rounds': 12, 'spec_fallbacks': 4, 'spec_discarded': 5},
    '8x1 rsag mrcbo': {'concepts': 4282, 'iterations': 8, 'closures': 139782, 'bytes': 35297024, 'reduce_rounds': {'rsag': 24}, 'h2d_transfers': 3, 'h2d_bytes': 288, 'd2h_transfers': 32, 'd2h_bytes': 1208824, 'spec_rounds': 11, 'spec_fallbacks': 3, 'spec_discarded': 4},
    '1x4 rsag mrganter+': {'concepts': 4282, 'iterations': 8, 'closures': 246109, 'bytes': 13486080, 'reduce_rounds': {'rsag': 15}, 'h2d_transfers': 5, 'h2d_bytes': 25856, 'd2h_transfers': 27, 'd2h_bytes': 3889988, 'spec_rounds': 11, 'spec_fallbacks': 3, 'spec_discarded': 4},
    '1x4 rsag mrcbo': {'concepts': 4282, 'iterations': 8, 'closures': 139782, 'bytes': 11864064, 'reduce_rounds': {'rsag': 12}, 'h2d_transfers': 3, 'h2d_bytes': 288, 'd2h_transfers': 16, 'd2h_bytes': 2771576, 'spec_rounds': 9, 'spec_fallbacks': 1, 'spec_discarded': 2},
    '2x4 rsag mrganter+': {'concepts': 4282, 'iterations': 8, 'closures': 246109, 'bytes': 35963136, 'reduce_rounds': {'rsag': 15}, 'h2d_transfers': 5, 'h2d_bytes': 25856, 'd2h_transfers': 27, 'd2h_bytes': 3889988, 'spec_rounds': 11, 'spec_fallbacks': 3, 'spec_discarded': 4},
    '2x4 rsag mrcbo': {'concepts': 4282, 'iterations': 8, 'closures': 139782, 'bytes': 31637760, 'reduce_rounds': {'rsag': 12}, 'h2d_transfers': 3, 'h2d_bytes': 288, 'd2h_transfers': 16, 'd2h_bytes': 2771576, 'spec_rounds': 9, 'spec_fallbacks': 1, 'spec_discarded': 2},
    '2x4 rsag mrganter+ max_batch=1024': {'concepts': 4282, 'iterations': 8, 'closures': 180611, 'bytes': 23609600, 'reduce_rounds': {'rsag': 48}, 'h2d_transfers': 7, 'h2d_bytes': 95488, 'd2h_transfers': 95, 'd2h_bytes': 850184, 'spec_rounds': 13, 'spec_fallbacks': 5, 'spec_discarded': 6},
    '1x1 rsag mrganter max_iterations=200': {'concepts': 200, 'iterations': 200, 'closures': 24474, 'bytes': 0, 'reduce_rounds': {'rsag': 200}, 'h2d_transfers': 2, 'h2d_bytes': 256, 'd2h_transfers': 201, 'd2h_bytes': 4936, 'spec_rounds': 199, 'spec_fallbacks': 0, 'spec_discarded': 0},
    'census 8x1 rsag mrganter+': {'concepts': 104, 'iterations': 4, 'closures': 12767, 'bytes': 4804800, 'reduce_rounds': {'rsag': 5}, 'h2d_transfers': 2, 'h2d_bytes': 320, 'd2h_transfers': 8, 'd2h_bytes': 344768, 'spec_rounds': 4, 'spec_fallbacks': 1, 'spec_discarded': 1},
}


def async_key(k: int, c: int, impl: str, driver: str, max_batch: int | None = None,
              max_iterations: int | None = None) -> str:
    return cand_key(k, c, impl, driver, max_batch) + (
        f" max_iterations={max_iterations}" if max_iterations else "")


def async_record(res, eng) -> dict:
    """What phase 14 holds against the reference's async run (either
    package's MRResult and engine)."""
    s = eng.stats
    return {"concepts": res.n_concepts, "iterations": res.n_iterations,
            "closures": res.n_closures_computed, "bytes": res.modeled_comm_bytes,
            "reduce_rounds": dict(s.reduce_rounds),
            **{f: getattr(s, f) for f in ASYNC_CENSUS_FIELDS}}


# The serving tier (phases 8 and 9).  Serve: phase 4's context, threshold
# and intents, 4096 closure queries of the reference CLI's seeded generator
# (``fca serve``, seed 0), top-5 of the first 256, slots 64.  Stream: 8
# seeded rows onto the full lattice of mushroom at scale 0.01.  Rules: the
# iceberg at 10 % (812) on k = 8 rsag, min_conf 0.5, 1024 queries of
# ``rule_query_mix`` (seed 0), top 5.  The expected values are the
# reference's, derived once on the CPU with the JAX package
# (backend="jnp", under the jax-0.9 binding) by
# ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_reference.py``,
# which drives the reference's ConceptStore, QueryEngine, StreamUpdater,
# extract_bases and RuleIndex through this file's serve_answers,
# rules_answers and digest.
SERVE_QUERIES, SERVE_TOPK, SERVE_K, SERVE_SLOTS = 4096, 256, 5, 64
SERVE_EXPECTED = {1: {'sha256': {'closure': '7215b64640a21ecf51560f0a362b284a9b1d8f99c7ea8a40f04a8851c66afffb',
                'topk': 'f1543e4476017233953139c0d0e2668baa8a4c7894eb794dd78c457417a7cb6e',
                'lookup': '88580779f1f229f5625d4c099b6cbfbf9a37b60c2fe681a7088bdab8551e5783',
                'children': '9d4f710a66f30226dfbabb4e846d8ec8f54a87ec6f12b52b139b42dc801fc4ba',
                'parents': '4725e8d6bf8c42ea1f3a109d2b5b08c0512d848b4db3b8751451de0e7e03222b',
                'supers': '6f1a5d9eda1f4b4892869e0976f04d1d82aac15a53abea14ab72edf21718ca95',
                'subs': 'a5ce2c8b942a4dd004d6cdc44c5b4a1131dc4bbe4e7f20cab105e8c688657740',
                'extents': '7c96fb3e2c523f586d64a787bc5a7202d9da43a5833b0a846a8feeb7a89f064d'},
     'closure_hit_rate': 0.065673828125,
     'modeled_comm_bytes': 0,
     'reduce_rounds': {'rsag': 68}},
 8: {'sha256': {'closure': '7215b64640a21ecf51560f0a362b284a9b1d8f99c7ea8a40f04a8851c66afffb',
                'topk': 'f1543e4476017233953139c0d0e2668baa8a4c7894eb794dd78c457417a7cb6e',
                'lookup': '88580779f1f229f5625d4c099b6cbfbf9a37b60c2fe681a7088bdab8551e5783',
                'children': '9d4f710a66f30226dfbabb4e846d8ec8f54a87ec6f12b52b139b42dc801fc4ba',
                'parents': '4725e8d6bf8c42ea1f3a109d2b5b08c0512d848b4db3b8751451de0e7e03222b',
                'supers': '6f1a5d9eda1f4b4892869e0976f04d1d82aac15a53abea14ab72edf21718ca95',
                'subs': 'a5ce2c8b942a4dd004d6cdc44c5b4a1131dc4bbe4e7f20cab105e8c688657740',
                'extents': '7c96fb3e2c523f586d64a787bc5a7202d9da43a5833b0a846a8feeb7a89f064d'},
     'closure_hit_rate': 0.065673828125,
     'modeled_comm_bytes': 15654912,
     'reduce_rounds': {'rsag': 68, 'allgather': 1}}}
STREAM_ROWS = 8
STREAM_EXPECTED = {'n_concepts_before': 4440,
 'n_concepts_after': 5454,
 'version': 1,
 'post_update_hit_rate': 1.0,
 'intents_sha256': '5b70f92af615ef0f3295b3550ae6f516a122908d8dc0beda4b81abced246063f'}
RULES_MIN_SUPPORT, RULES_MIN_CONF, RULES_QUERIES, RULES_K = 812, 0.5, 1024, 5
RULES_EXPECTED = {'concepts': 558,
 'implications': 4999,
 'partial': 356,
 'basis_sha256': 'b78db8880c2e6ac0c180614fe0b70c1a8c1f0ef389f56b069ac2a55ef333d85d',
 'answers_sha256': {'confidence': 'dd73ad3ce10e0d8b9919324326ab3f8786337209b211226d8db27aac0dd3748b',
                    'lift': '0edeb893bf71971c33f64821562c5b139c86d6adadc3b27f011f62f5bf0460e2'}}
# The serving tier under load (phase 15): the admission queue at
# AdmissionConfig's defaults (max_wait 2 ms, depth 512, top-5) over phase 8's
# stores (k = 1 and 8 rsag), phase 9's store and rule index (k = 8 rsag) and
# the full lattice of phase 8's stream context (k = 8), slots 64.  The
# virtual-clock runs (``virtual_load``: run_load on a clock that only its
# sleep advances, so dispatch costs no virtual time and the schedule is
# deterministic) hold their counts, dispatch causes, occupancy, kinds,
# virtual e2e and admission-wait views and the SHA-256 of every ticket's
# answer, in submission order, against ``LOAD_EXPECTED``: the reference's,
# derived once on the CPU with the JAX package (backend="jnp", under the
# jax-0.9 binding, its run_load livelock repaired as the port's is) by
# ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_reference.py load``
# through this file's virtual_load and load_record.  The stream run is cut
# to 0.15 s (61 events, 4 commits) from 2 s: each commit of 2 rows grows the
# lattice by ~15 % (4440 → 5114 → 5869 → 6826 → 8263 → 9507 concepts over
# the first five), and the ~80 commits of 2 s would grow it past 40k,
# whose snapshot rebuilds the reference does not finish on a CPU in an hour.
# ``LOAD_KEYS`` are the reference CLI's ``serve_load`` keys.
LOAD_SEED = 24
LOAD_UPDATE_ROWS = 2
LOAD_RULES_MIX = {"closure": 0.5, "topk": 0.2, "lookup": 0.1, "rules": 0.2}
LOAD_STREAM_MIX = {"closure": 0.6, "topk": 0.2, "lookup": 0.1, "update": 0.1}
LOAD_VIRTUAL = {
    # run: (store, arrival process, qps, seconds, arrival kw, mix; None = make_workload's default)
    "serve k=1": ("serve", "poisson", 2000.0, 2.0, {}, None),
    "serve k=8": ("serve", "poisson", 2000.0, 2.0, {}, None),
    "rules k=8": ("rules", "burst", 2000.0, 2.0, {"factor": 4.0}, LOAD_RULES_MIX),
    "stream k=8": ("stream", "poisson", 400.0, 0.15, {}, LOAD_STREAM_MIX),
}
LOAD_EXPECTED = {'serve k=1': {'submitted': 4001,
               'admitted': 4001,
               'shed': 0,
               'completed': 4001,
               'dispatches': 1554,
               'dispatch_causes': {'deadline': 1553, 'flush': 1},
               'occupancy_mean': 0.0402,
               'by_kind': {'closure': 2336, 'topk': 1270, 'lookup': 395},
               'updates': 0,
               'e2e': {'count': 4001,
                       'mean': 0.001397,
                       'max': 0.00201,
                       'p50': 0.001722,
                       'p95': 0.00201,
                       'p99': 0.00201},
               'admission_wait': {'count': 4001,
                                  'mean': 0.001397,
                                  'max': 0.00201,
                                  'p50': 0.001722,
                                  'p95': 0.00201,
                                  'p99': 0.00201},
               'answers_sha256': '6a3a3501c7639c1231ed28cd3deb3bdbc2129e2c276577b6d891921202d545b1'},
 'serve k=8': {'submitted': 4001,
               'admitted': 4001,
               'shed': 0,
               'completed': 4001,
               'dispatches': 1554,
               'dispatch_causes': {'deadline': 1553, 'flush': 1},
               'occupancy_mean': 0.0402,
               'by_kind': {'closure': 2336, 'topk': 1270, 'lookup': 395},
               'updates': 0,
               'e2e': {'count': 4001,
                       'mean': 0.001397,
                       'max': 0.00201,
                       'p50': 0.001722,
                       'p95': 0.00201,
                       'p99': 0.00201},
               'admission_wait': {'count': 4001,
                                  'mean': 0.001397,
                                  'max': 0.00201,
                                  'p50': 0.001722,
                                  'p95': 0.00201,
                                  'p99': 0.00201},
               'answers_sha256': '6a3a3501c7639c1231ed28cd3deb3bdbc2129e2c276577b6d891921202d545b1'},
 'rules k=8': {'submitted': 3964,
               'admitted': 3964,
               'shed': 0,
               'completed': 3964,
               'dispatches': 1660,
               'dispatch_causes': {'deadline': 1658, 'flush': 2},
               'occupancy_mean': 0.0373,
               'by_kind': {'closure': 1970, 'rules': 782, 'topk': 805, 'lookup': 407},
               'updates': 0,
               'e2e': {'count': 3964,
                       'mean': 0.001418,
                       'max': 0.00201,
                       'p50': 0.001722,
                       'p95': 0.00201,
                       'p99': 0.00201},
               'admission_wait': {'count': 3964,
                                  'mean': 0.001418,
                                  'max': 0.00201,
                                  'p50': 0.001722,
                                  'p95': 0.00201,
                                  'p99': 0.00201},
               'answers_sha256': '8b99a11dbce877e9e0c0ec486e2fc95a622290daf049240e8f0be962f7ee4795'},
 'stream k=8': {'submitted': 57,
                'admitted': 57,
                'shed': 0,
                'completed': 57,
                'dispatches': 43,
                'dispatch_causes': {'deadline': 41, 'flush': 2},
                'occupancy_mean': 0.0207,
                'by_kind': {'closure': 40, 'lookup': 6, 'topk': 11},
                'updates': 4,
                'e2e': {'count': 57,
                        'mean': 0.001635,
                        'max': 0.00201,
                        'p50': 0.00201,
                        'p95': 0.00201,
                        'p99': 0.00201},
                'admission_wait': {'count': 57,
                                   'mean': 0.001635,
                                   'max': 0.00201,
                                   'p50': 0.00201,
                                   'p95': 0.00201,
                                   'p99': 0.00201},
                'answers_sha256': 'c79ac28431b0f964be1a1b2fd98f8f61e5f7793793c08fa32be631312ca04408',
                'version': 4,
                'intents_sha256': 'ec2e3844d2142593f243fc04b18cbdd32160601617cf175546f1a842de6a2662'}}
LOAD_KEYS = ['achieved_qps', 'admission_wait', 'admitted', 'arrival', 'by_kind', 'completed',
 'dispatch_causes', 'dispatches', 'duration_s', 'e2e', 'max_lag_s', 'mix', 'occupancy_mean',
 'offered_qps', 'queue', 'shed', 'shed_rate', 'slo', 'submitted', 'update_latency', 'updates',
 'wall_s']
# Wall-clock runs (host clock, make_workload's default mix, seed LOAD_SEED + 1):
# (k, arrival process, qps, seconds, arrival kw).  The overload run offers
# more than full 64-slot batches at ~1 ms each can serve; its shedding is
# printed, not required.
LOAD_WALL = {
    "poisson k=1": (1, "poisson", 1000.0, 3.0, {}),
    "poisson k=8": (8, "poisson", 1000.0, 3.0, {}),
    "burst k=1": (1, "burst", 1000.0, 3.0, {"factor": 4.0}),
    "overload k=1": (1, "poisson", 200_000.0, 0.5, {}),
}
LOAD_THREAD_QUERIES, LOAD_THREAD_QPS = 2000, 2000.0
LOAD_KERNELS = ("closure", "contains_topk", "rules_topk")
# The static checks (phase 16): the recorder over whole mining runs
# (dataset, k, c, schedule, driver, the reference's modeled bytes and
# charged reduce rounds) — phase 5's k = 8 rsag plan and phase 12's
# census-income 2 x 4 rsag plan, backend="kernel".
ANALYSIS_RECORDED = (
    ("mushroom", 8, 1, "rsag", "mrganter+", MULTI_BYTES[(8, "rsag")]["mrganter+"], None),
    ("mushroom", 8, 1, "rsag", "mrcbo", MULTI_BYTES[(8, "rsag")]["mrcbo"], None),
    ("census-income", 2, 4, "rsag", "mrganter+",
     CAND_EXPECTED["census 2x4 rsag mrganter+"]["bytes"],
     CAND_EXPECTED["census 2x4 rsag mrganter+"]["reduce_rounds"]),
)
ANALYSIS_KERNELS = ("closure", "fused_step", "map_closure", "filter_step", "contains_topk",
                    "rules_topk")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# 32-bit integer add/compare/bitwise results per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table); times the SM count and the maximum SM clock.
INT32_OPS_PER_CLK_PER_SM = 64
# dense int8 tensor-core operations per second of the H100 SXM (NVIDIA data
# sheet): the rate of K2/K3's two 0/1 products over complement bit-planes
INT8_TENSOR_OPS_PER_S = 1.979e15
TIMING_REPS = 25
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's SM clock: longer than any wrapper's host path
# The LM serving path (phases 10 and 11).  Reduced (phase 10): gemma2-9b
# and codeqwen1.5-7b ``reduced()`` (float32; gemma2's window 32), weights
# ``repro_torch.interop.numpy_params(cfg, LM_SEED)``, the reference CLI's
# prompts plus one 40 tokens long (past the window) and four holding token
# ids outside [0, vocab), 16 greedy tokens in the CLI's ServeConfig.  The expected tokens are the JAX package's
# ServeEngine on those very weights, derived once on the CPU by
# ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_reference.py lm``.
LM_REDUCED_ARCHS = ("gemma2-9b", "codeqwen1.5-7b", "qwen2-vl-72b", "recurrentgemma-2b",
                    "arctic-480b", "llama4-scout-17b-a16e", "musicgen-large", "mamba2-370m")
LM_REDUCED_LONG = {"mamba2-370m": 64}  # its reduced chunk of 32 refuses a 40-token prefill
LM_SEED = 20241016
LM_REDUCED_MAX_LEN = 512  # the reference CLI's --max-len default
LM_MAX_NEW = 16
LM_REDUCED_EXPECTED = {
    "gemma2-9b": [
        [56, 178, 49, 158, 6, 6, 6, 6, 6, 6, 6, 6, 6, 50, 50, 50],
        [193, 106, 84, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [29, 198, 198, 198, 198, 204, 177, 248, 248, 133, 248, 178, 43, 158, 94, 1],
        [224, 224, 224, 84, 91, 224, 37, 114, 180, 137, 79, 79, 79, 137, 79, 79],
        [163, 185, 6, 234, 194, 194, 30, 46, 7, 224, 234, 176, 224, 224, 224, 224],
        [246, 225, 225, 108, 97, 97, 97, 208, 208, 225, 225, 225, 232, 193, 193, 160],
        [127, 52, 52, 225, 225, 225, 225, 225, 225, 225, 180, 169, 169, 114, 214, 214],
    ],
    "codeqwen1.5-7b": [
        [74, 124, 63, 223, 63, 223, 63, 223, 166, 98, 42, 200, 193, 98, 49, 24],
        [126, 147, 24, 236, 97, 207, 180, 207, 154, 236, 97, 97, 31, 223, 22, 166],
        [223, 154, 223, 74, 134, 154, 74, 134, 182, 154, 74, 31, 31, 31, 31, 31],
        [70, 203, 30, 74, 143, 47, 94, 143, 124, 223, 70, 76, 74, 58, 205, 106],
        [134, 154, 134, 74, 170, 170, 170, 170, 170, 154, 154, 177, 154, 108, 108, 108],
        [65, 137, 137, 137, 137, 137, 137, 137, 192, 155, 155, 155, 166, 155, 212, 170],
        [100, 33, 185, 63, 216, 168, 22, 77, 49, 13, 13, 13, 70, 13, 33, 154],
    ],
    "qwen2-vl-72b": [
        [74, 124, 63, 223, 63, 223, 63, 223, 166, 98, 42, 200, 193, 98, 49, 24],
        [126, 147, 24, 236, 97, 207, 180, 207, 154, 236, 97, 97, 31, 223, 22, 166],
        [223, 154, 223, 74, 134, 154, 74, 134, 182, 154, 74, 31, 31, 31, 31, 31],
        [70, 203, 30, 74, 143, 47, 94, 143, 124, 223, 70, 76, 74, 58, 205, 106],
        [134, 154, 134, 74, 170, 170, 170, 170, 170, 154, 154, 177, 154, 108, 108, 108],
        [65, 137, 137, 137, 137, 137, 137, 137, 192, 155, 155, 155, 166, 155, 212, 170],
        [100, 33, 185, 63, 216, 168, 22, 77, 49, 13, 13, 13, 70, 13, 33, 154],
    ],
    "recurrentgemma-2b": [
        [46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46],
        [163, 242, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46],
        [243, 217, 104, 251, 205, 156, 53, 58, 191, 205, 220, 164, 231, 1, 169, 7],
        [21, 146, 195, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46],
        [46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 246],
        [126, 182, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46],
        [193, 244, 1, 62, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46, 46],
    ],
    "arctic-480b": [
        [43, 93, 253, 15, 201, 119, 250, 60, 78, 250, 202, 91, 240, 134, 189, 202],
        [83, 175, 228, 104, 214, 236, 251, 195, 236, 81, 81, 114, 202, 170, 52, 251],
        [163, 22, 214, 26, 116, 53, 199, 181, 235, 201, 214, 33, 74, 62, 251, 24],
        [22, 22, 180, 180, 166, 208, 247, 9, 235, 235, 235, 235, 199, 179, 12, 179],
        [170, 33, 170, 72, 13, 71, 223, 185, 9, 71, 114, 170, 196, 84, 71, 223],
        [97, 97, 97, 97, 24, 24, 24, 43, 142, 24, 33, 53, 140, 214, 71, 24],
        [84, 170, 46, 251, 200, 46, 251, 154, 151, 170, 46, 33, 154, 217, 84, 154],
    ],
    "llama4-scout-17b-a16e": [
        [164, 96, 27, 96, 164, 84, 116, 155, 100, 185, 200, 92, 155, 32, 105, 185],
        [196, 98, 255, 7, 71, 123, 135, 164, 105, 196, 98, 196, 219, 76, 234, 109],
        [74, 0, 202, 206, 114, 53, 69, 74, 63, 134, 234, 209, 247, 63, 63, 63],
        [243, 214, 24, 27, 13, 155, 238, 114, 82, 13, 13, 13, 70, 25, 164, 155],
        [31, 31, 31, 31, 114, 185, 31, 114, 114, 114, 114, 49, 205, 105, 49, 205],
        [137, 137, 137, 137, 150, 71, 137, 137, 208, 185, 50, 240, 150, 114, 240, 150],
        [84, 7, 168, 196, 7, 182, 7, 112, 211, 170, 40, 214, 91, 59, 137, 37],
    ],
    "musicgen-large": [
        [53, 84, 84, 84, 84, 84, 84, 84, 105, 105, 105, 105, 105, 105, 105, 105],
        [140, 25, 140, 140, 140, 140, 140, 140, 224, 224, 224, 224, 224, 224, 224, 224],
        [13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 13, 250],
        [97, 72, 214, 50, 94, 201, 214, 145, 94, 94, 94, 201, 214, 145, 94, 94],
        [216, 94, 145, 94, 185, 97, 185, 97, 185, 94, 185, 223, 216, 216, 216, 216],
        [137, 137, 137, 137, 137, 137, 137, 137, 92, 118, 137, 92, 118, 92, 238, 92],
        [84, 84, 84, 84, 84, 84, 84, 84, 84, 84, 84, 84, 84, 84, 84, 84],
    ],
    "mamba2-370m": [
        [221, 152, 178, 221, 158, 12, 117, 41, 252, 179, 126, 69, 153, 140, 117, 30],
        [153, 221, 236, 67, 1, 84, 241, 86, 57, 109, 0, 53, 133, 179, 250, 89],
        [213, 69, 49, 28, 76, 86, 17, 237, 65, 153, 95, 91, 38, 27, 146, 79],
        [84, 243, 143, 1, 68, 210, 85, 8, 221, 1, 222, 104, 235, 45, 19, 132],
        [221, 167, 223, 68, 233, 169, 137, 205, 8, 14, 210, 117, 22, 109, 86, 21],
        [198, 31, 40, 104, 221, 110, 5, 225, 137, 207, 191, 151, 210, 164, 64, 69],
        [16, 172, 64, 112, 219, 75, 39, 100, 126, 174, 211, 59, 56, 55, 18, 143],
    ],
}
# Full width (phase 11): gemma2-9b at its published shape, bf16 weights from
# a seeded torch.Generator on the card, four seeded prompts in four slots.
LM_FULL_ARCH = "gemma2-9b"
LM_FULL_PROMPTS = (7, 1024, 4097, 5000)  # tokens: one past the 4096 window, one past it by 904
LM_FULL_MAX_LEN = 5120
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
# Kernel and plain runs of phase 11 differ only in the attention's sum order
# and p's bf16 rounding (K7_TOL): about one bf16 step of some attention
# outputs per layer, carried through 42 bf16 layers.  The logits (fp32,
# std ~1.2 here: unit-RMS hidden state times N(0, 0.02^2) embeddings over
# 3584 dims) then move by some percent of their std; the largest of the
# 4 x 256,000 last-position logits by a few times that.  So 0.25, a fifth
# of the logits' std: their largest gap must stay under it, and a greedy
# token may flip only where the plain run's top-2 margin is under it.
LM_LOGIT_TOL = 0.25
# The other LM families at full width (phase 17): published widths, bf16
# weights from a seeded torch.Generator on the card, four seeded prompts in
# four slots, 16 greedy tokens.  (arch, depth, prompt lengths, max_len, K7
# launches per prefill = attention layers).  recurrentgemma-2b: all 26
# layers (8 local-attention layers, window 2048), a prompt one past the
# window and one 952 past it; mamba2-370m: all 48 SSD layers (no
# attention), the padded length 1024 = 4 chunks of 256; musicgen-large: all
# 48 MHA layers (hd 64, no RoPE); llama4-scout: its depth cut from 48 to 12
# layers (4.40 GB of bf16 weights a layer, 4.14 GB of untied embeddings:
# 57.0 GB at 12 layers against 216 GB at 48), 16 experts top-1 plus the
# shared expert at capacity round(16,384 / 16 · 1.25) = 1280 in the prefill.
LM_FAMILIES = (
    ("recurrentgemma-2b", None, (7, 1024, 2049, 3000), 3072, 8),
    ("mamba2-370m", None, (7, 300, 1000, 1024), 1040, 0),
    ("musicgen-large", None, (7, 256, 1024, 1500), 1520, 48),
    ("llama4-scout-17b-a16e", 12, (7, 512, 2048, 4096), 4112, 12),
)
# Tolerances of phase 17, as LM_LOGIT_TOL's: a fraction of the spread (std)
# of the last-position logits the plain run gives.  Kernel and plain runs
# differ only in the attention's sum order and p's bf16 rounding (about one
# bf16 step of some attention outputs a layer), carried through 12-48 bf16
# layers; the logits (fp32; std ~1: unit-RMS hidden states times N(0, 1/d)
# unembedding columns, or recurrentgemma's and mamba2's tied N(0, 0.02^2)
# embeddings over 2560 / 1024 dims: std 1.0 / 0.64) then move by some
# percent of their std, the largest of the 4 x V by a few times that.  So a
# fifth of the std (phase 11's 0.25 against gemma2's 1.2): the largest gap
# must stay under it, and a greedy token may flip only where the plain
# run's top-2 margin is under it.  The state caches against the chunked
# forms (a 768-token prefill and 256 decode steps against one 1024-token
# prefill, batch 1) are held on a float32 copy of the config (the same
# widths and depth, its own seeded weights): there the two differ only in
# the association of float32 sums (a step-by-step state against chunked or
# scanned sums, K7's float32 body against the decode's softmax), ~1e-5 of
# the logits a layer, while a wrong state, conv window or position moves
# them by their std; so a hundredth of the std of the prefill's logits.  In
# bf16 the two forms also round the activations at other places (the decode
# conv's float32 sums against the prefill's bf16 shifted adds, each a bf16
# step) through 26-48 layers: that difference is reported beside it
# (``state_split_bf16``), not held.
LM_FAMILY_TOL_FRAC = 0.2
LM_STATE_TOL_FRAC = 0.01
LM_STATE_SPLIT = (768, 1024)
# K7b, the attention's backward (phase 18), against autograd through K7's
# plain version on seeded standard-normal q, k, v and output gradients, at
# the head shapes of four configs the repo supports (name, H, KV, hd,
# window, cap, sequence lengths): gemma2-9b (G 2, the cap, its 4096 window
# reached at S 4100) with the odd lengths 1, 7 and 130; recurrentgemma-2b
# (G 10, window 2048, reached at 2100); llama4-scout (G 5, hd 128) and
# musicgen-large (G 1, hd 64); two edge shapes whose head dim the bf16
# body zero-pads to a compiled width (hd 24 to 32, hd 8 to 16); and the
# edges of the bf16 passes' tiles at hd 256 and 128, G 1, 3 and 5: S one
# below, at and one above 32 (a warpgroup's rows of a dK/dV stage, the dQ
# pass's key stage at hd 256), 64 (the dK/dV pass's key tile and query
# stage, a dQ warpgroup's rows) and 128 (a G 1 dQ CTA's rows), windows of
# 40 and 100 that end inside a 64-key tile.  Batch 2 below 1024 positions,
# else 1.
K7B_EDGE_LENGTHS = (31, 32, 33, 63, 64, 65, 127, 128, 129)
K7B_SHAPES = (
    ("gemma2-9b", 16, 8, 256, 4096, 50.0, (1, 7, 130, 1024, 4100)),
    ("recurrentgemma-2b", 10, 1, 256, 2048, None, (130, 2100)),
    ("llama4-scout-17b-a16e", 40, 8, 128, None, None, (1024,)),
    ("musicgen-large", 32, 32, 64, None, None, (1024,)),
    ("edge hd 24", 6, 2, 24, 33, 30.0, (65, 200)),
    ("edge hd 8", 3, 1, 8, None, None, (129,)),
    ("edge hd 256 G 1", 2, 2, 256, 40, 50.0, K7B_EDGE_LENGTHS),
    ("edge hd 256 G 3", 3, 1, 256, None, None, (63, 64, 65, 129)),
    ("edge hd 256 G 5", 10, 2, 256, 100, 30.0, (33, 65, 200)),
    ("edge hd 128 G 1", 4, 4, 128, None, 50.0, K7B_EDGE_LENGTHS),
    ("edge hd 128 G 3", 6, 2, 128, 40, None, (65, 129)),
    ("edge hd 128 G 5", 5, 1, 128, 100, None, (33, 64, 200)),
)
# K7b and the plain version's autograd compute one function in another sum
# order (float32: both accumulate in float32, ~1e-6 of the largest
# gradient); in bfloat16 both take bf16 operands and float32 sums, but the
# plain version rounds p against its own running maxima of 1024-key blocks
# and K7b against the row's final log-sum-exp, and each gradient is
# rounded to bf16 (one step: 2^-8 of its value).  Each of dq, dk and dv
# must lie within K7B_TOL of the largest |gradient| of its tensor (plus the
# same fraction of max|dout| * max|v|, the size of the terms whose
# difference dS is, where the exact gradient is 0, as at S = 1), and its
# cosine with the plain gradient must reach K7B_MIN_COS.
K7B_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
K7B_MIN_COS = {"float32": 0.99999, "bfloat16": 0.9995}
# The timed shape (the kernels line): gemma2-9b's full-width layer at
# train_4k's sequence, batch 1, bf16, the cap (the local layers' 4096
# window covers all 4096 positions).
K7B_TIMED = (1, 4096, 16, 8, 256)
# The reduced archs train (phase 19): every config ``reduced()`` (float32) on
# the numpy weights of phase 10 (LM_SEED), launch/train's --reduced shape
# (sequence 64, batch 8) of the step-indexed corpus (seed 0), the arch
# plan's optimizer (AdamW, or Adafactor for qwen2-vl and arctic) with
# warmup-cosine at peak TRAIN_LR after TRAIN_WARMUP step, 3 steps through
# the fault-tolerant Trainer.  TRAIN_REDUCED_EXPECTED holds the reference's
# losses, from ``PYTHONPATH=src JAX_PLATFORMS=cpu python
# tests/_torch_reference.py train`` (its jitted make_train_step on the same
# weights and batches).
TRAIN_REDUCED_SHAPE = (64, 8)
TRAIN_REDUCED_STEPS = 3
TRAIN_LR = 1e-3
TRAIN_WARMUP = 1
TRAIN_REDUCED_EXPECTED = {
    "codeqwen1.5-7b": [5.976838111877441, 6.077302932739258, 6.020037651062012],
    "starcoder2-7b": [5.967672824859619, 6.031289100646973, 5.972609519958496],
    "gemma2-9b": [5.550268173217773, 5.558825492858887, 5.557626247406006],
    "deepseek-coder-33b": [6.0121660232543945, 6.11760950088501, 6.100522994995117],
    "qwen2-vl-72b": [5.993142604827881, 6.120975494384766, 6.044793128967285],
    "recurrentgemma-2b": [5.553887367248535, 5.554987907409668, 5.551780700683594],
    "arctic-480b": [6.101409435272217, 6.091613292694092, 6.020617485046387],
    "llama4-scout-17b-a16e": [5.98423433303833, 6.05871057510376, 6.070639610290527],
    "musicgen-large": [6.056584358215332, 6.083219528198242, 6.02549934387207],
    "mamba2-370m": [5.568517684936523, 5.561522960662842, 5.548760414123535],
}
# The losses of step 1 differ from the reference's in float32 sum order
# alone (~1e-6); steps 2 and 3 follow updates whose first AdamW step is
# g / (|g| + 1e-8): elements whose gradient is near that eps move by up to
# ~1e-3 of the learning rate between the two packages (see
# tests/test_torch_train.py), which moves the loss by far less than this.
TRAIN_LOSS_TOL = 1e-4
# gemma2-9b trains at full width (phase 20): d 3584, 16/8 heads of 256, V
# 256,000, its depth cut 42 -> 12 layers (AdamW's 16 bytes a parameter:
# (917.5 M embedding + 12 x 198 M) x 16 B = 52.6 GB), train_4k's sequence
# 4096 with its batch cut 256 -> 1, bf16 weights from a seeded
# torch.Generator on the card, AdamW at launch/train's schedule (3e-4, 100
# warmup steps).  Through the Trainer: 4 steps, checkpoints every 2, keep 1;
# fault_hook raises once at the start of step 3 (0-based), the trainer
# restores step 2's checkpoint and replays steps 2 and 3.  The card's
# machine has ~75 GB of disk, one full-width checkpoint (46 GB) and not
# two: the hook, on its second call at step 3, deletes the checkpoint it
# was restored from before step 4's save.
TRAIN_FULL_ARCH = "gemma2-9b"
TRAIN_FULL_DEPTH = 12
TRAIN_FULL_SHAPE = (4096, 1)
TRAIN_FULL_STEPS = 4
TRAIN_FULL_CKPT_EVERY = 2
TRAIN_FULL_FAULT_STEP = 3
# step 1's gradients of every attention leaf (wq, wk, wv, wo per layer)
# through K7 and K7b against the plain attention's autograd: the two differ
# in bf16 rounding inside the attention (K7_TOL, K7B_TOL) carried through
# 12 bf16 layers' backward
TRAIN_GRAD_MIN_COS = 0.999

# The dry-run (phase 22).  (a) The production grid: ``python -m
# repro_torch.launch.dryrun`` in a subprocess over its fake group of 256
# ranks (the 16 x 16 mesh), the fake tensors on the card's device type:
# DRYRUN_CELLS, one cell per shape kind and model family (the whole grid
# takes longer than the phase may; it is run and recorded apart), and the
# FCA cell.  Every applicable cell must be "ok"; long_500k on an
# attention-only arch stays "skipped".  (b) The prediction against the
# card: phase 20's configuration (TRAIN_FULL_*: gemma2-9b, 12 layers, 4096
# x 1, AdamW) and phase 11's (gemma2-9b at full depth, a prefill of its
# four prompts left-padded to the longest, caches as long) traced on a
# 1 x 1 mesh over the one-rank NCCL group through ``dryrun_lib.run_cell``,
# then one more real step of each under ``op_analysis``: per-device FLOPs
# equal (K7 and K7b through their formulas), no collective on one rank,
# the train state's bytes within DRYRUN_STATE_TOL of the growth of
# ``memory_allocated`` when it is built, the predicted peak (arguments plus
# temporaries) within DRYRUN_PEAK_TOL of ``max_memory_allocated`` over the
# step (the ratio recorded).
DRYRUN_CELLS = (("gemma2-9b", "train_4k"), ("gemma2-9b", "prefill_32k"),
                ("gemma2-9b", "decode_32k"), ("gemma2-9b", "long_500k"),
                ("mamba2-370m", "long_500k"), ("recurrentgemma-2b", "prefill_32k"),
                ("arctic-480b", "train_4k"), ("qwen2-vl-72b", "prefill_32k"))
DRYRUN_TIMEOUT_S = 240
DRYRUN_STATE_TOL = 0.01
DRYRUN_PEAK_TOL = 0.20

# The FCA examples (phase 22c): examples/quickstart_torch.py,
# fca_mining_torch.py and fca_query_service_torch.py run in this process
# through ``backend="kernel"`` with EXAMPLE_ARGS; each one's printed lines,
# wall times and rates masked (``example_lines``), must equal the reference
# example's at the same arguments (EXAMPLES_EXPECTED: the JAX package's
# examples under the jax binding, their engines at backend="jnp", derived
# once on the CPU by ``PYTHONPATH=src JAX_PLATFORMS=cpu python
# tests/_torch_reference.py examples``), and each kernel of its path
# (EXAMPLE_KERNELS) must launch.  fca_mining runs mushroom at scale 0.01:
# at its default 0.03 (119,298 concepts) the centralized NextClosure it
# checks against takes minutes on the host.
EXAMPLE_ARGS = {
    "quickstart_torch": {},
    "fca_mining_torch": {"dataset": "mushroom", "scale": 0.01, "parts": (1, 2, 4, 8)},
    "fca_query_service_torch": {"dataset": "mushroom", "scale": 0.01, "parts": 4,
                                "reduce_impl": "auto", "queries": 256, "updates": 6},
}
EXAMPLE_KERNELS = {
    "quickstart_torch": ("closure", "map_closure", "filter_step"),
    "fca_mining_torch": ("closure", "fused_step", "map_closure", "filter_step"),
    "fca_query_service_torch": ("closure", "map_closure", "filter_step", "contains_topk"),
}

EXAMPLES_EXPECTED = {
    'quickstart_torch': [
        'context: 6 objects × 7 attributes, density 0.57',
        '',
        'NextClosure: 21 concepts (lectic order)',
        'CloseByOne:  21 concepts in 4 levels',
        'MRGanter  : 21 concepts in 21 MapReduce rounds — matches NextClosure: True',
        'MRGanter+ : 21 concepts in  5 MapReduce rounds — matches NextClosure: True',
        'MRCbo     : 21 concepts in  5 MapReduce rounds — matches NextClosure: True',
        '',
        'concept lattice (intent ← covered intents):',
        '  ⟨{123456}, {}⟩  ←  []',
        '  ⟨{1356}, {f}⟩  ←  [{}]',
        '  ⟨{245}, {e}⟩  ←  [{}]',
        '  ⟨{1345}, {d}⟩  ←  [{}]',
        '  ⟨{1346}, {b}⟩  ←  [{}]',
        '  ⟨{125}, {a}⟩  ←  [{}]',
        '  ⟨{135}, {d,f}⟩  ←  [{f}, {d}]',
        '  ⟨{45}, {d,e}⟩  ←  [{e}, {d}]',
        '  ⟨{236}, {c,g}⟩  ←  [{}]',
        '  ⟨{136}, {b,f}⟩  ←  [{f}, {b}]',
        '  ⟨{134}, {b,d}⟩  ←  [{d}, {b}]',
        '  ⟨{25}, {a,e}⟩  ←  [{e}, {a}]',
        '  ⟨{13}, {b,d,f}⟩  ←  [{d,f}, {b,f}, {b,d}]',
        '  ⟨{4}, {b,d,e}⟩  ←  [{d,e}, {b,d}]',
        '  ⟨{15}, {a,d,f}⟩  ←  [{a}, {d,f}]',
        '  ⟨{36}, {b,c,f,g}⟩  ←  [{c,g}, {b,f}]',
        '  ⟨{5}, {a,d,e,f}⟩  ←  [{d,e}, {a,e}, {a,d,f}]',
        '  ⟨{2}, {a,c,e,g}⟩  ←  [{c,g}, {a,e}]',
        '  ⟨{1}, {a,b,d,f}⟩  ←  [{b,d,f}, {a,d,f}]',
        '  ⟨{3}, {b,c,d,f,g}⟩  ←  [{b,d,f}, {b,c,f,g}]',
        '  ⟨{}, {a,b,c,d,e,f,g}⟩  ←  [{b,d,e}, {a,d,e,f}, {a,c,e,g}, {a,b,d,f}, {b,c,d,f,g}]',
    ],
    'fca_mining_torch': [
        'mushroom: 81 objects × 125 attrs @ 0.174 density (scale=0.01, synthetic)',
        'NextClosure (centralized): 4440 concepts in <s>',
        'MRGanter+ parts=1 reduce=allgather:  7 rounds, <s>, comm=   0.00 MB, match=True',
        'MRGanter+ parts=1 reduce=rsag     :  7 rounds, <s>, comm=   0.00 MB, match=True',
        'MRGanter+ parts=2 reduce=allgather:  7 rounds, <s>, comm=   6.79 MB, match=True',
        'MRGanter+ parts=2 reduce=rsag     :  7 rounds, <s>, comm=   6.79 MB, match=True',
        'MRGanter+ parts=4 reduce=allgather:  7 rounds, <s>, comm=  40.72 MB, match=True',
        'MRGanter+ parts=4 reduce=rsag     :  7 rounds, <s>, comm=  20.36 MB, match=True',
        'MRGanter+ parts=8 reduce=allgather:  7 rounds, <s>, comm= 190.05 MB, match=True',
        'MRGanter+ parts=8 reduce=rsag     :  7 rounds, <s>, comm=  47.51 MB, match=True',
    ],
    'fca_query_service_torch': [
        'mushroom: 81 objects × 125 attrs @ 0.174 density',
        'mined 4440 concepts in 7 rounds ( <s>)',
        "store built in <s>: {'plan': {'mode': 'simulated', 'n_parts': 4, 'axes': "
        "['objpart'], 'cand_parts': 1, 'cand_axes': [], 'mesh_shape': None, 'reduce_impl': "
        "'auto', 'block_n': 256, 'max_batch': 8192, 'auto_hop_bytes': 4096, "
        "'hop_calibrated': False}, 'objects': 81, 'attrs': 125, 'version': 0, "
        "'concepts': 4440, 'cap': 8192, 'max_bucket': 65}",
        "closure×256: <rate> q/s, hit rate 1.00, 5 collective rounds (schedule: {'allgather': 5})",
        'top-5 support of query 0: [2, 1, 1, 0, -1]; children counts sample: [6, 30, 14, 24, 6]',
        'streamed 6 objects: 4440 → 5136 concepts, staged in <s> (|P|=27)',
        'grown lattice == batch NextClosure remine: True',
    ],
}


def example_lines(text: str) -> list:
    """An example's printed lines with its wall times and rates masked, and
    without the port plan's ``describe()`` entry ``backend`` (the process
    group's, None on a simulated plan), which the reference's lacks."""
    import re

    out = []
    for line in text.splitlines():
        line = re.sub(r"\b\d+\.\d+s\b", "<s>", re.sub(r"[\d,]+ q/s", "<rate> q/s", line))
        # a time's field width is its magnitude's: one space before each
        out.append(re.sub(r" *<s>", " <s>", line).replace("'backend': None, ", ""))
    return out


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = TIMING_REPS, warmup: int = 3, queued: bool = True) -> float:
    """Median milliseconds of ``fn()`` on the card, by CUDA events.

    ``queued``: a spin kernel (``torch.cuda._sleep``, ~1 ms) runs first, so
    the host has enqueued the start event, ``fn``'s launches and the end
    event before the card reaches them, and the events bracket the device
    work alone.  Without it the events also hold whatever time the host
    takes to reach each launch (Python, argument checks, allocation)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got, want):
    """Largest absolute difference over the outputs.  Float outputs must
    agree bit for bit: one whose bits differ counts at least the smallest
    float32 step, so that a -0.0 against a 0.0 still fails."""
    import torch

    err = 0
    for g, w in zip(got, want):
        if g is None or w is None:  # an output not asked for (K4's supports)
            if g is not w:
                raise AssertionError("one side returned an output the other did not")
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{g.dtype}{tuple(g.shape)} != {w.dtype}{tuple(w.shape)}")
        if not g.numel():
            continue
        if g.is_floating_point():
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                err = max(err, float((g - w).abs().max()), 2.0**-149)
        else:
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def require_equal(name: str, got, want) -> int:
    import torch

    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max |err| {err})")
    return err


def bitsets(rng, n: int, W: int, density: float):
    """Seeded random packed rows [n, W] as uint32 (bit 31 included)."""
    import numpy as np

    dense = rng.random((n, W * 32)) < density
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (dense.reshape(n, W, 32).astype(np.uint32) * weights).sum(-1, dtype=np.uint32)


def candidates(rng, rows, B: int):
    """Subsets of random rows (so supports are non-trivial), plus the empty
    and the all-ones candidate."""
    import numpy as np

    W = rows.shape[1]
    keep = bitsets(rng, B, W, 0.15)
    cands = rows[rng.integers(0, rows.shape[0], size=B)] & keep
    cands[0] = 0
    if B > 1:
        cands[-1] = 0xFFFFFFFF
    return cands


def check_kernels(device) -> list[dict]:
    """Phase 3: K1 and K2 against their plain versions, bit for bit."""
    import numpy as np
    import torch

    from repro_torch.device import device_bits
    from repro_torch.kernels import closure as k1
    from repro_torch.kernels import frontier as k2
    from repro_torch.kernels import ops

    rng = np.random.default_rng(20121013)
    records = []
    for W in (1, 4, 5, 10, 33):
        for N in (256, 8192):
            rows_np = bitsets(rng, N, W, 0.7)
            rows = device_bits(rows_np, device)
            for B in (1, 8, 8192):
                cands = device_bits(candidates(rng, rows_np, B), device)
                got = k1.closure(rows, cands)
                want = k1.closure_plain(rows, cands)
                require_equal(f"K1 W={W} N={N} B={B}", got, want)
                records.append({"kernel": "closure", "W": W, "N": N, "B": B,
                                "max_support": int(want[1].max())})
    # widths whose shared memory needs more than the 48 KB default (the
    # launch raises the kernel's limit), up to the library's max_w
    max_w = k1.max_w(device)
    if max_w < 3000:
        raise AssertionError(f"the SIMT body takes rows of at most {max_w} words")
    with contextlib.suppress(ValueError):
        k1.closure(device_bits(bitsets(rng, 1, max_w + 1, 0.5), device),
                   device_bits(bitsets(rng, 1, max_w + 1, 0.5), device))
        raise AssertionError(f"K1 took rows of {max_w + 1} words, past max_w")
    for W in (2000, max_w):
        rows_np = bitsets(rng, 256, W, 0.7)
        rows = device_bits(rows_np, device)
        for B in (8, 16):
            cands_np = candidates(rng, rows_np, B)
            cands = device_bits(cands_np, device)
            require_equal(f"K1 W={W} N=256 B={B}", k1.closure(rows, cands),
                          k1.closure_plain(rows, cands))
            records.append({"kernel": "closure", "W": W, "N": 256, "B": B})
            mask = ops.attr_mask_tensor(W * 32 - 5, W, device)[None, :]
            parent = device_bits(cands_np & bitsets(rng, B, W, 0.5), device)
            lowrow = device_bits(bitsets(rng, B, W, 0.3), device)
            sc = k2.pack_scalars(B - 1, 1, 3, 0)
            for variant, (iceberg, cbo, _) in k2.VARIANTS.items():
                kw = dict(iceberg=iceberg, cbo=cbo)
                if cbo:
                    kw.update(parent=parent, lowrow=lowrow)
                require_equal(f"K2 {variant} W={W} N=256 B={B}",
                              k2.fused_step(rows, cands, mask, sc, **kw),
                              k2.fused_step_plain(rows, cands, mask, sc, **kw))
                records.append({"kernel": "fused_step", "variant": variant, "W": W,
                                "N": 256, "B": B})
    # ragged N and B: the batched_closure wrapper hands both to K1 as they are
    for W, N, B, n_valid in ((4, 1000, 13, 990), (5, 8124, 125, 8124), (33, 300, 1, 300)):
        rows_np = bitsets(rng, N, W, 0.7)
        rows = device_bits(rows_np, device)
        cands = device_bits(candidates(rng, rows_np, B), device)
        n_attrs = W * 32 - 3
        got = ops.batched_closure(rows, cands, n_attrs, n_valid_rows=n_valid)
        want = ops.batched_closure(rows, cands, n_attrs, n_valid_rows=n_valid, use_kernel=False)
        require_equal(f"batched_closure W={W} N={N} B={B}", got, want)
        records.append({"kernel": "closure", "ragged": True, "W": W, "N": N, "B": B})
    # K2: every variant, with windows, thresholds and CbO operands
    for W, N, B in ((4, 8192, 8192), (5, 512, 40), (1, 256, 8)):
        rows_np = bitsets(rng, N, W, 0.7)
        rows = device_bits(rows_np, device)
        cands_np = candidates(rng, rows_np, B)
        cands = device_bits(cands_np, device)
        n_attrs = W * 32 - 7
        mask = ops.attr_mask_tensor(n_attrs, W, device)[None, :]
        parent = device_bits(cands_np & bitsets(rng, B, W, 0.5), device)
        lowrow = device_bits(bitsets(rng, B, W, 0.3), device)
        for variant, (iceberg, cbo, _) in k2.VARIANTS.items():
            for n_valid, min_sup, n_pad, row_off in (
                (B, 1, 0, 0), (B - B // 3, N // 50, 5, 0), (B // 2 + 1, 3, 1, B // 4),
            ):
                sc = k2.pack_scalars(n_valid, min_sup, n_pad, row_off)
                kw = dict(iceberg=iceberg, cbo=cbo)
                if cbo:
                    kw.update(parent=parent, lowrow=lowrow)
                got = k2.fused_step(rows, cands, mask, sc, **kw)
                want = k2.fused_step_plain(rows, cands, mask, sc, **kw)
                require_equal(f"K2 {variant} W={W} N={N} B={B} {sc}", got, want)
                records.append({"kernel": "fused_step", "variant": variant, "W": W,
                                "N": N, "B": B, "scalars": list(sc),
                                "kept": int(want[2].sum())})
    return records


def check_sharded_kernels(device) -> list[dict]:
    """Phase 3, multi-shard half: K1 and K3 over k shards in one launch
    against their plain versions, bit for bit."""
    import numpy as np

    from repro_torch.device import device_bits
    from repro_torch.kernels import closure as k1
    from repro_torch.kernels import frontier as fk
    from repro_torch.kernels import ops

    rng = np.random.default_rng(20121014)
    records = []
    for W in (4, 33, 2000):
        n = 256 if W == 2000 else 1024  # rows per shard
        n_attrs = W * 32 - 5
        mask = ops.attr_mask_tensor(n_attrs, W, device)[None, :]
        for k in (1, 2, 8):
            rows_np = bitsets(rng, k * n, W, 0.7)
            rows_np[k * n - 40:] = 0xFFFFFFFF  # all-ones pad rows in the last shard
            rows = device_bits(rows_np, device)
            # k = 1 as a process-group rank holds it ([N, W]); else [k, N/k, W]
            rows = rows if k == 1 else rows.reshape(k, n, W)
            for B in (8, 8192):
                cands = device_bits(candidates(rng, rows_np, B), device)
                got = fk.map_closure(rows, cands, mask)
                want = fk.map_closure_plain(rows, cands, mask)
                require_equal(f"K3 k={k} W={W} n={n} B={B}", got, want)
                if W != 2000:
                    require_equal(f"K1 k={k} W={W} n={n} B={B}", k1.closure(rows, cands),
                                  k1.closure_plain(rows, cands))
                records.append({"kernel": "map_closure", "k": k, "W": W, "n": n, "B": B,
                                "max_support": int(want[1].max())})
    return records


# K4 at its edges (phase 3): K in {1, 2, 8} shards' partials (K = 1 also as
# a process-group rank's [B, W] / [B]); every frontier variant with the
# operands the engine gives it (supports only where iceberg); W at 1, 4, 5,
# 11 and 33, beside the lanes' power-of-two segments and past one warp; B at
# 1, 255 and 8192, and W = 2000 at B = 8; windows, thresholds, pad counts
# and row offsets; some CbO generators outside LOW's rows.
FILTER_EDGE_K = (1, 2, 8)
FILTER_EDGE_W = (1, 4, 5, 11, 33)
FILTER_EDGE_B = (1, 255, 8192)


def check_filter_kernel(device) -> list[dict]:
    """Phase 3: K4 (``FILTER_EDGE_*``) against its plain version, bit for
    bit: closures, supports and keep."""
    import numpy as np
    import torch

    from repro_torch.device import device_bits
    from repro_torch.kernels import frontier as fk
    from repro_torch.kernels import ops
    from repro_torch.kernels.closure import and_reduce

    rng = np.random.default_rng(20121017)

    def words(*shape, n: int, op):
        """Random words, each bit of ``op`` over n fair bits (OR of 2: 3/4
        set; NOT of the AND of 4: 15/16 set, so that 8 shards' AND keeps
        about 60 %; AND of 6: 1/64)."""
        x = rng.integers(0, 2**32, size=(n, *shape), dtype=np.uint32)
        return device_bits(op.reduce(x, 0), device)

    records = []
    shapes = [(W, B) for W in FILTER_EDGE_W for B in FILTER_EDGE_B] + [(2000, 8)]
    for K in FILTER_EDGE_K:
        for W, B in shapes:
            n_attrs = W * 32 - 5
            mask = ops.attr_mask_tensor(n_attrs, W, device)
            lc = ~words(K, B, W, n=4, op=np.bitwise_and) & mask
            ls = torch.from_numpy(rng.integers(0, 300 // K + 2, size=(K, B)).astype(np.int32))
            ls = ls.to(device)
            parent = words(B, W, n=2, op=np.bitwise_or) & and_reduce(lc, 0)
            LOW = words(n_attrs, W, n=6, op=np.bitwise_and) & mask
            gens_np = rng.integers(0, n_attrs, size=B).astype(np.int32)
            gens_np[::97] = np.int32(n_attrs)  # outside LOW: dropped
            gens_np[1::101] = -1
            gens = torch.from_numpy(gens_np).to(device)
            forms = [(lc, ls)] + ([(lc[0], ls[0])] if K == 1 else [])
            for variant, (iceberg, cbo, _) in fk.VARIANTS.items():
                kw = dict(iceberg=iceberg, cbo=cbo)
                if cbo:
                    kw.update(parent=parent, LOW=LOW, gens=gens)
                for sc in ((B, 100, 0, 0), (B - B // 3, 120, 7, 0), (B // 2 + 1, 3, 1, B // 4)):
                    sc = fk.pack_scalars(*sc)
                    for a, s_ in forms:
                        s_ = s_ if iceberg else None  # as the engine passes them
                        got = fk.filter_step(a, s_, sc, **kw)
                        want = fk.filter_step_plain(a, s_, sc, **kw)
                        require_equal(f"K4 {variant} K={K} W={W} B={B} {sc} "
                                      f"{tuple(a.shape)}", got, want)
                        records.append({"kernel": "filter_step", "variant": variant, "K": K,
                                        "W": W, "B": B, "scalars": list(sc),
                                        "kept": int(want[2].sum())})
    return records


# K2 and K4 with the valid count on the device (phase 3): the count as a
# 0-dim int32 tensor on the card at 0, 1, B - 1, B and B + 5, row_off 0 and
# B // 4, every variant; K2 on the tensor body (W 4, 5) and the SIMT body
# (W 11), K4 at K in {1, 8}.  Each launch equals the int form's launch and
# the plain version on the same count, bit for bit.
COUNT_K2_SHAPES = ((4, 8192, 8192), (5, 512, 40), (11, 256, 130))  # W, N, B
COUNT_K4_SHAPES = ((1, 4, 8192), (1, 11, 255), (8, 4, 8192), (8, 11, 255))  # K, W, B


def count_values(B: int) -> tuple[int, ...]:
    return (0, 1, B - 1, B, B + 5)


def check_device_counts(device) -> list[dict]:
    """Phase 3: K2 and K4 reading n_valid from the device (``COUNT_*``)
    against their int form and their plain version, bit for bit."""
    import numpy as np
    import torch

    from repro_torch.device import device_bits
    from repro_torch.kernels import frontier as fk
    from repro_torch.kernels import ops

    rng = np.random.default_rng(20121023)
    records = []

    def check(name, kern, plain, args, sc, kw, **rec):
        dev = (torch.tensor(sc[0], dtype=torch.int32, device=device), *sc[1:])
        got = kern(*args, dev, **kw)
        require_equal(f"{name} device count {sc}", got, kern(*args, sc, **kw))
        require_equal(f"{name} device count {sc} (plain)", got, plain(*args, dev, **kw))
        records.append({"kernel": kern.__name__, "count": "device", "scalars": list(sc),
                        "kept": int(got[2].sum()), **rec})

    for W, N, B in COUNT_K2_SHAPES:
        rows_np = bitsets(rng, N, W, 0.7)
        cands_np = candidates(rng, rows_np, B)
        rows, cands = device_bits(rows_np, device), device_bits(cands_np, device)
        mask = ops.attr_mask_tensor(W * 32 - 7, W, device)[None, :]
        parent = device_bits(cands_np & bitsets(rng, B, W, 0.5), device)
        lowrow = device_bits(bitsets(rng, B, W, 0.3), device)
        for variant, (iceberg, cbo, _) in fk.VARIANTS.items():
            kw = dict(iceberg=iceberg, cbo=cbo)
            if cbo:
                kw.update(parent=parent, lowrow=lowrow)
            for n_valid in count_values(B):
                for row_off in (0, B // 4):
                    check(f"K2 {variant} W={W} N={N} B={B}", fk.fused_step,
                          fk.fused_step_plain, (rows, cands, mask),
                          (n_valid, N // 50, 3, row_off), kw, variant=variant, W=W, B=B)
    for K, W, B in COUNT_K4_SHAPES:
        n_attrs = W * 32 - 5
        mask = ops.attr_mask_tensor(n_attrs, W, device)
        lc = device_bits(bitsets(rng, K * B, W, 0.9), device).reshape(K, B, W) & mask
        ls = torch.from_numpy(rng.integers(0, 300 // K + 2, size=(K, B)).astype(np.int32))
        ls = ls.to(device)
        parent = device_bits(bitsets(rng, B, W, 0.6), device) & lc[0]
        LOW = device_bits(bitsets(rng, n_attrs, W, 0.02), device) & mask
        gens = torch.from_numpy(rng.integers(0, n_attrs, size=B).astype(np.int32)).to(device)
        for variant, (iceberg, cbo, _) in fk.VARIANTS.items():
            kw = dict(iceberg=iceberg, cbo=cbo)
            if cbo:
                kw.update(parent=parent, LOW=LOW, gens=gens)
            for n_valid in count_values(B):
                for row_off in (0, B // 4):
                    check(f"K4 {variant} K={K} W={W} B={B}", fk.filter_step,
                          fk.filter_step_plain, (lc, ls if iceberg else None),
                          (n_valid, 100 // K, 7, row_off), kw, variant=variant, K=K, W=W, B=B)
    return records


# The widest rows, in words, on which K1/K2/K3's launchers must take the
# tensor-core body (TCF_MAX_W in csrc/frontier.cu): phases 3-5 and 8 hold
# the launchers' reports in the wrappers' tc_launches counters to it, and
# the ptxas gate expects its instantiations for W = 1..TC_MAX_W.
TC_MAX_W = 10

# K1/K2/K3's tensor body at its edges (phase 3): W at 1, 4, 5, 10 (TC_MAX_W,
# the widest it takes) and 11 (the SIMT body); N and B at 1, 63, 65 and 8191,
# beside the 64-row stages, the 64-candidate warpgroups and the 128-candidate
# CTAs; K1 and K3 over k in {1, 2, 8} shards; rows with bit 31 set and the
# engine's all-ones pad rows, or candidates that match no row; the row split
# at B = 8 against census-income's shards (CENSUS_PADDED / 8 rows, k = 8).
TC_EDGE_W = (1, 4, 5, 10, 11)
TC_EDGE_NB = ((1, 1), (63, 65), (65, 63), (8191, 8191))
TC_SPLIT_N = CENSUS_PADDED // 8


def tc_case(rng, n_rows: int, W: int, B: int, pad: bool):
    """Rows with bit 31 set in every word of every third row.  ``pad``: the
    last rows all-ones, as the engine pads.  Else bit 30 of word 0 cleared in
    every row and set in every third candidate from the second on, so that
    those candidates match no row (the all-ones candidate matches none
    either)."""
    import numpy as np

    rows = bitsets(rng, n_rows, W, 0.7)
    rows[::3] |= np.uint32(1 << 31)
    if pad:
        rows[-min(5, n_rows):] = 0xFFFFFFFF
    else:
        rows[:, 0] &= ~np.uint32(1 << 30)
    cands = candidates(rng, rows, B)
    if not pad:
        cands[1::3, 0] |= np.uint32(1 << 30)
    return rows, cands


def check_tc_kernels(device) -> list[dict]:
    """Phase 3, the K1/K2/K3 tensor body at its edges (``TC_EDGE_*``) and on
    the row split, against the plain versions, bit for bit; each launch
    took the tensor body exactly where W <= TC_MAX_W."""
    import numpy as np

    from repro_torch.device import device_bits
    from repro_torch.kernels import closure as k1
    from repro_torch.kernels import frontier as fk
    from repro_torch.kernels import ops

    rng = np.random.default_rng(20121015)
    records = []

    def run(name, kern, plain, args, kw, W, rec):
        before = kern.tc_launches
        want = plain(*args, **kw)
        require_equal(name, kern(*args, **kw), want)
        if kern.tc_launches - before != int(W <= TC_MAX_W):
            raise AssertionError(f"{name}: tensor body taken {kern.tc_launches - before} "
                                 f"times at W = {W} (TC_MAX_W = {TC_MAX_W})")
        records.append({"tc_edge": True, "tensor_body": W <= TC_MAX_W,
                        "zero_support": int((want[1] == 0).sum()), **rec})

    def k3_cases(W, n, B, ks, pad):
        mask = ops.attr_mask_tensor(W * 32 - 3, W, device)[None, :]
        for k in ks:
            rows_np, cands_np = tc_case(rng, k * n, W, B, pad(k))
            rows = device_bits(rows_np, device)
            rows = rows if k == 1 else rows.reshape(k, n, W)
            cands = device_bits(cands_np, device)
            rec = {"k": k, "W": W, "n": n, "B": B, "pad": pad(k)}
            run(f"K3 tensor edge k={k} W={W} n={n} B={B}", fk.map_closure,
                fk.map_closure_plain, (rows, cands, mask), {}, W,
                {"kernel": "map_closure", **rec})
            run(f"K1 tensor edge k={k} W={W} n={n} B={B}", k1.closure, k1.closure_plain,
                (rows, cands), {}, W, {"kernel": "closure", **rec})

    def k2_cases(W, N, B, pad):
        rows_np, cands_np = tc_case(rng, N, W, B, pad)
        rows = device_bits(rows_np, device)
        cands = device_bits(cands_np, device)
        mask = ops.attr_mask_tensor(W * 32 - 7, W, device)[None, :]
        parent = device_bits(cands_np & bitsets(rng, B, W, 0.5), device)
        lowrow = device_bits(bitsets(rng, B, W, 0.3), device)
        for variant, (iceberg, cbo, _) in fk.VARIANTS.items():
            for sc in ((B, 1, 0, 0), (B - B // 3, N // 50, 5, 0), (B // 2 + 1, 3, 1, B // 4)):
                sc = fk.pack_scalars(*sc)
                kw = dict(iceberg=iceberg, cbo=cbo)
                if cbo:
                    kw.update(parent=parent, lowrow=lowrow)
                run(f"K2 tensor edge {variant} W={W} N={N} B={B} {sc}", fk.fused_step,
                    fk.fused_step_plain, (rows, cands, mask, sc), kw, W,
                    {"kernel": "fused_step", "variant": variant, "W": W, "N": N, "B": B,
                     "pad": pad, "scalars": list(sc)})

    for W in TC_EDGE_W:
        for i, (N, B) in enumerate(TC_EDGE_NB):
            k3_cases(W, N, B, (1, 2, 8), lambda k: k != 2)
            k2_cases(W, N, B, pad=i % 2 == 0)
    # the row split: few candidate tiles against long shards
    for W in (4, 5):
        k3_cases(W, TC_SPLIT_N, 8, (8,), lambda k: True)
        k2_cases(W, TC_SPLIT_N, 8, pad=True)
    return records


# Every timed main-path run (phases 4, 5 and 12): its wall and the milliseconds
# Python's garbage collector paused the host inside it, by generation; the
# phase after phase 12 reports the runs a collection of generation 1 or 2
# landed in.
GC_PAUSES: list = []


@contextlib.contextmanager
def gc_pauses():
    """Milliseconds of garbage collection, by generation, inside the block."""
    paused = [0.0, 0.0, 0.0]
    start = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            paused[info["generation"]] += (time.perf_counter() - start[0]) * 1e3

    gc.callbacks.append(on_gc)
    try:
        yield paused
    finally:
        gc.callbacks.remove(on_gc)


def drive_main_path(ctx, backend: str, algorithm: str, device, plan_kw: dict | None = None,
                    min_support: int = MAIN_MIN_SUPPORT, rounds: str = "sync",
                    max_iterations: int | None = None):
    """One run of a main path through the port's entry points; launch
    counts are set to 0 just before it and read just after.  ``plan_kw``
    (``n_parts``, ``reduce_impl``, or a whole ``plan``) selects the
    object shards and candidate blocks, ``rounds`` the round mode."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import ClosureEngine, mrcbo, mrganter, mrganter_plus

    eng = ClosureEngine(ctx, backend=backend, device=device, **(plan_kw or {}))
    kw = {"min_support": min_support, "rounds": rounds, "max_iterations": max_iterations}
    kernels.reset_launches()
    torch.cuda.synchronize()
    with gc_pauses() as paused:
        t0 = time.perf_counter()
        if algorithm == "mrcbo":
            res = mrcbo(ctx, eng, **kw)
        elif algorithm == "mrganter":
            res = mrganter(ctx, eng, **kw)
        else:  # mrganter+, mrganter+dedupe (closure dedupe on the card too)
            res = mrganter_plus(ctx, eng, local_prune=True,
                                dedupe_closures=algorithm == "mrganter+dedupe", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    plan = eng.plan
    GC_PAUSES.append({"objects": ctx.n_objects, "backend": backend, "algorithm": algorithm,
                      "rounds": rounds,
                      "plan": {"n_parts": plan.n_parts, "cand_parts": plan.cand_parts,
                               "reduce_impl": plan.reduce_impl,
                               "max_batch": plan.max_batch},
                      "wall_s": wall, "gc_ms": paused})
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    check_tensor_body(ctx.W)
    return res, eng, wall, launches


def check_tensor_body(W: int) -> None:
    """Every K1, K2 and K3 launch of a run whose rows are at most TC_MAX_W
    words wide took the tensor-core body, read just after the run from the
    counters set to 0 before it.  The counters are read on the module-level
    names the wrappers count on: the wrappers themselves, or
    capture_launches' recorders (fresh, at 0) while it runs, so that
    captured runs are checked as well."""
    from repro_torch.kernels import closure as k1
    from repro_torch.kernels import frontier as fk

    if W > TC_MAX_W:
        return
    for module, name in ((k1, "closure"), (fk, "fused_step"), (fk, "map_closure")):
        k = getattr(module, name)
        if k.tc_launches != k.launches:
            raise AssertionError(f"{name}: {k.launches} launches at W = {W}, "
                                 f"{k.tc_launches} of them through the tensor body")


def capture_launches(names, drive):
    """Run ``drive()`` once more with the named kernel wrappers swapped for
    recorders that keep a copy of the operands of every launch, so that
    phase 7 times and bounds the chunks a path really gave each kernel.
    The wrapper counts on its module-level name, which is then the
    recorder: a copy is kept exactly when the wrapper counted a launch,
    and ``check_tensor_body`` reads the recorder's ``tc_launches``.
    Returns what ``drive`` returned and the chunks by name; the caller
    holds the number of chunks against the counts of an unwrapped run."""
    import torch

    from repro_torch import kernels

    modules = {k.__name__: sys.modules[k.__module__] for k in kernels.KERNELS}
    real = {name: getattr(modules[name], name) for name in names}
    chunks = {name: [] for name in names}

    def recorder(name):
        def call(*args, **kw):
            copy = ([a.clone() if torch.is_tensor(a) else a for a in args],
                    {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()})
            before = call.launches
            out = real[name](*args, **kw)
            if call.launches != before:
                chunks[name].append(copy)
            return out
        call.launches = 0
        call.tc_launches = 0
        return call

    for name in names:
        setattr(modules[name], name, recorder(name))
    try:
        out = drive()
    finally:
        for name in names:
            setattr(modules[name], name, real[name])
    return out, chunks


def check_captured(name: str, chunks: dict, counts: dict) -> None:
    """The captured run launched each kernel as often as the unwrapped run."""
    got = {k: len(v) for k, v in chunks.items()}
    want = {k: counts[k] for k in chunks}
    if got != want:
        raise AssertionError(f"{name}: captured {got} launches, the unwrapped run counted {want}")


def intent_set(intents) -> set:
    return {x.tobytes() for x in intents}


def run_main_path(device) -> tuple[dict, dict, dict, list]:
    """Phase 4: full-scale mushroom on one shard, iceberg at 5 %, both
    drivers.  Also returns the mined intents, which the serve phase
    serves."""
    from repro_torch.data import fca_datasets

    ctx, spec = fca_datasets.load("mushroom", scale=1.0)
    if (ctx.n_objects, ctx.n_attrs) != (8124, 125):
        raise AssertionError(f"mushroom context is {ctx.n_objects} x {ctx.n_attrs}")
    launches = {name: 0 for name in ONE_SHARD_KERNELS}
    chunks = {name: [] for name in ONE_SHARD_KERNELS}
    report = {}
    for algorithm, want in MAIN_EXPECTED.items():
        # kernel, torch, torch, kernel: the first run of each backend is cold
        runs = [drive_main_path(ctx, backend, algorithm, device)
                for backend in ("kernel", "torch", "torch", "kernel")]
        if any(n for r in runs[1:3] for n in r[3].values()):
            raise AssertionError(f"main path {algorithm}: the torch backend launched a kernel")
        captured_res, captured = capture_launches(
            ONE_SHARD_KERNELS, lambda: drive_main_path(ctx, "kernel", algorithm, device)[0])
        res, eng, _, counts = runs[0]
        for run_res in [r[0] for r in runs] + [captured_res]:
            got = {"concepts": run_res.n_concepts, "iterations": run_res.n_iterations,
                   "closures": run_res.n_closures_computed}
            if got != want:
                raise AssertionError(f"main path {algorithm}: {got} != reference {want}")
            if intent_set(run_res.intents) != intent_set(res.intents):
                raise AssertionError(f"main path {algorithm}: kernel and torch concept sets differ")
        if runs[3][3] != counts:
            raise AssertionError(f"main path {algorithm}: launch counts differ between runs")
        check_captured(f"main path {algorithm}", captured, counts)
        missing = [k for k in ONE_SHARD_KERNELS if counts[k] == 0]
        if missing:
            raise AssertionError(f"main path {algorithm}: kernels never launched: {missing}")
        stray = [k for k, n in counts.items() if n and k not in ONE_SHARD_KERNELS]
        if stray:
            raise AssertionError(f"main path {algorithm}: other kernels launched: {stray}")
        for k in ONE_SHARD_KERNELS:
            launches[k] += counts[k]
            chunks[k] += [(algorithm, args, kw) for args, kw in captured[k]]
        report[algorithm] = dict(
            got, launches=counts, rounds=eng.stats.rounds,
            kernel_wall_s={"cold": runs[0][2], "warm": runs[3][2]},
            torch_wall_s={"cold": runs[1][2], "warm": runs[2][2]},
            host_blocked_s=runs[3][1].stats.host_blocked_s,
            modeled_comm_bytes=res.modeled_comm_bytes,
        )
        emit({"phase": "main_path", "dataset": spec.name, "objects": ctx.n_objects,
              "attributes": ctx.n_attrs, "min_support": MAIN_MIN_SUPPORT,
              "algorithm": algorithm, **report[algorithm]})
    return report, launches, chunks, res.intents


def check_run(name: str, res, want: dict, want_bytes: int | None = None) -> dict:
    got = {"concepts": res.n_concepts, "iterations": res.n_iterations,
           "closures": res.n_closures_computed}
    if got != want:
        raise AssertionError(f"{name}: {got} != reference {want}")
    if want_bytes is not None and res.modeled_comm_bytes != want_bytes:
        raise AssertionError(
            f"{name}: modeled bytes {res.modeled_comm_bytes} != reference {want_bytes}")
    return got


def check_multi_shard_counts(name: str, counts: dict) -> None:
    missing = [k for k in MULTI_SHARD_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched: {missing}")
    if counts["fused_step"]:
        raise AssertionError(f"{name}: K2 launched {counts['fused_step']} times on k > 1")


def run_multi_shard_path(device):
    """Phase 5: the main path over k object shards, every schedule, both
    drivers, plus the matmul backend and census-income at its published
    shape.  Returns the report, the summed launch counts of the kernel
    runs, and the K1/K3/K4 chunks of one more kernel run of each k = 8 rsag
    plan."""
    from repro_torch.data import fca_datasets

    ctx, spec = fca_datasets.load("mushroom", scale=1.0)
    launches = {name: 0 for name in MULTI_SHARD_KERNELS}
    report = {}
    for (k, impl), want_bytes in MULTI_BYTES.items():
        plan_kw = {"n_parts": k, "reduce_impl": impl}
        for algorithm, want in MAIN_EXPECTED.items():
            name = f"multi-shard {algorithm} k={k} {impl}"
            res, eng, wall, counts = drive_main_path(ctx, "kernel", algorithm, device, plan_kw)
            tres, _, twall, tcounts = drive_main_path(ctx, "torch", algorithm, device, plan_kw)
            got = check_run(name, res, want, want_bytes[algorithm])
            check_run(name + " torch", tres, want, want_bytes[algorithm])
            if intent_set(tres.intents) != intent_set(res.intents):
                raise AssertionError(f"{name}: kernel and torch concept sets differ")
            check_multi_shard_counts(name, counts)
            if any(tcounts.values()):
                raise AssertionError(f"{name}: the torch backend launched a kernel")
            for kname in MULTI_SHARD_KERNELS:
                launches[kname] += counts[kname]
            report[f"{algorithm}/k={k}/{impl}"] = dict(
                got, modeled_comm_bytes=res.modeled_comm_bytes,
                reduce_rounds=eng.stats.reduce_rounds, launches=counts,
                kernel_wall_s=wall, torch_wall_s=twall,
            )
    # warm repeats of the k = 8 rsag plans, kernel then torch
    for algorithm in MAIN_EXPECTED:
        plan_kw = {"n_parts": 8, "reduce_impl": "rsag"}
        key = f"{algorithm}/k=8/rsag"
        res, _, wall, counts = drive_main_path(ctx, "kernel", algorithm, device, plan_kw)
        tres, _, twall, _ = drive_main_path(ctx, "torch", algorithm, device, plan_kw)
        if counts != report[key]["launches"]:
            raise AssertionError(f"multi-shard {key}: launch counts differ between runs")
        report[key]["kernel_wall_s"] = {"cold": report[key]["kernel_wall_s"], "warm": wall}
        report[key]["torch_wall_s"] = {"cold": report[key]["torch_wall_s"], "warm": twall}
    # the matmul backend, MRCbo at k = 8
    mres, _, mwall, mcounts = drive_main_path(
        ctx, "matmul", "mrcbo", device, {"n_parts": 8, "reduce_impl": "rsag"})
    check_run("multi-shard mrcbo k=8 rsag matmul", mres, MAIN_EXPECTED["mrcbo"],
              MULTI_BYTES[(8, "rsag")]["mrcbo"])
    base, _, _, _ = drive_main_path(ctx, "torch", "mrcbo", device,
                                    {"n_parts": 8, "reduce_impl": "rsag"})
    if intent_set(mres.intents) != intent_set(base.intents):
        raise AssertionError("multi-shard mrcbo k=8: matmul and torch concept sets differ")
    report["mrcbo/k=8/rsag/matmul"] = {"wall_s": mwall, "launches": mcounts}
    emit({"phase": "multi_shard_path", "dataset": spec.name, "objects": ctx.n_objects,
          "attributes": ctx.n_attrs, "min_support": MAIN_MIN_SUPPORT, "runs": report})

    # census-income at its published shape
    cctx, cspec = fca_datasets.load("census-income", scale=1.0)
    if (cctx.n_objects, cctx.n_attrs, cctx.W) != CENSUS_SHAPE:
        raise AssertionError(f"census-income context is {cctx.n_objects} x {cctx.n_attrs}")
    plan_kw = {"n_parts": 8, "reduce_impl": "rsag"}
    want = {k: v for k, v in CENSUS_EXPECTED.items() if k != "bytes"}
    runs = [drive_main_path(cctx, "kernel", "mrganter+", device, plan_kw, CENSUS_MIN_SUPPORT)
            for _ in range(2)]
    for res, eng, _, counts in runs:
        check_run("census-income k=8 rsag", res, want, CENSUS_EXPECTED["bytes"])
        check_multi_shard_counts("census-income k=8 rsag", counts)
    if runs[0][1].N_padded != CENSUS_PADDED or runs[0][1].rows.shape[1] != CENSUS_PADDED // 8:
        raise AssertionError(f"census-income padded to {runs[0][1].N_padded} rows")
    for kname in MULTI_SHARD_KERNELS:
        launches[kname] += runs[0][3][kname]
    census = dict(check_run("census", runs[0][0], want),
                  modeled_comm_bytes=runs[0][0].modeled_comm_bytes,
                  launches=runs[0][3], kernel_wall_s={"cold": runs[0][2], "warm": runs[1][2]},
                  n_padded=runs[0][1].N_padded)
    emit({"phase": "multi_shard_census", "dataset": cspec.name, "objects": cctx.n_objects,
          "attributes": cctx.n_attrs, "min_support": CENSUS_MIN_SUPPORT, "n_parts": 8,
          "reduce_impl": "rsag", **census})

    # K1/K3/K4 chunks: one more kernel run of each k = 8 rsag plan
    chunks = {"closure": [], "map_closure": [], "filter_step": []}
    captures = [("mrganter+", ctx, MAIN_MIN_SUPPORT, report["mrganter+/k=8/rsag"]["launches"]),
                ("mrcbo", ctx, MAIN_MIN_SUPPORT, report["mrcbo/k=8/rsag"]["launches"]),
                ("census", cctx, CENSUS_MIN_SUPPORT, census["launches"])]
    for label, c, ms, counts in captures:
        algorithm = "mrganter+" if label == "census" else label
        _, captured = capture_launches(tuple(chunks), lambda: drive_main_path(
            c, "kernel", algorithm, device, plan_kw, ms)[0])
        check_captured(f"multi-shard {label} k=8 rsag", captured, counts)
        for kname in chunks:
            chunks[kname] += [(f"{label} k=8 rsag", args, kw) for args, kw in captured[kname]]
    return report, census, launches, chunks


def run_full_lattices(device) -> dict:
    """Phase 6: full lattices against the centralized oracles."""
    from repro_torch.core import (
        ClosureEngine, FormalContext, all_closures, close_by_one,
        mrcbo, mrganter, mrganter_plus, paper_context,
    )
    from repro_torch.data import fca_datasets

    drivers = {
        "mrganter": lambda c, e: mrganter(c, e),
        "mrganter+": lambda c, e: mrganter_plus(c, e, dedupe_candidates=True),
        "mrcbo": lambda c, e: mrcbo(c, e),
    }
    contexts = {
        "paper": (paper_context(), all_closures),
        "synthetic": (FormalContext.synthetic(60, 24, 0.35, seed=42), all_closures),
        "mushroom-0.01": (fca_datasets.load("mushroom", scale=0.01)[0],
                          lambda c: close_by_one(c).intents),
    }
    report = {}
    for name, (ctx, oracle) in contexts.items():
        want = LATTICE_EXPECTED[name]
        oracle_set = intent_set(oracle(ctx))
        if len(oracle_set) != want["concepts"]:
            raise AssertionError(f"{name}: oracle has {len(oracle_set)} concepts")
        # one shard, and 8 shards under the auto schedule (K1 over shards
        # for the MRGanter walks, K3/K4 for the batched steps)
        for n_parts in (1,) if name == "mushroom-0.01" else (1, 8):
            for algorithm, n_iter in want["iterations"].items():
                eng = ClosureEngine(ctx, backend="kernel", device=device, n_parts=n_parts,
                                    reduce_impl="auto")
                t0 = time.perf_counter()
                res = drivers[algorithm](ctx, eng)
                wall = time.perf_counter() - t0
                run = f"{name} {algorithm} k={n_parts}"
                if res.n_concepts != want["concepts"] or intent_set(res.intents) != oracle_set:
                    raise AssertionError(f"{run}: concept set differs from the oracle")
                if res.n_iterations != n_iter:
                    raise AssertionError(f"{run}: {res.n_iterations} iterations != {n_iter}")
                report[f"{name}/{algorithm}/k={n_parts}"] = {
                    "concepts": res.n_concepts, "iterations": res.n_iterations,
                    "wall_s": wall}
    emit({"phase": "full_lattice", "runs": report})
    return report


# ---------------------------------------------------------------------------
# the 2-D main path (phase 12), row_off on its chunks (phase 3), tracing (13)
# ---------------------------------------------------------------------------

# The span names whose rollup the tracing phase prints.
TRACE_SPANS = ("mine/mrganter_plus", "mine/round", "mine/round/expand",
               "mine/round/dispatch", "mine/round/allreduce", "mine/round/filter",
               "engine/closure", "query/micro_batch")


def cand_plan(k: int, c: int, impl: str, max_batch: int = 8192):
    from repro_torch.dist import ShardPlan

    return ShardPlan.simulated(k, cand_parts=c, reduce_impl=impl, max_batch=max_batch)


def check_cand_counts(name: str, k: int, counts: dict) -> None:
    """A 2-D plan runs the kernels of a 1-D plan with as many object
    shards: K1 and K2 on one; K1, K3 and K4 (not K2) on k > 1; no other."""
    want = ONE_SHARD_KERNELS if k == 1 else MULTI_SHARD_KERNELS
    missing = [n for n in want if counts[n] == 0]
    stray = [n for n, v in counts.items() if v and n not in want]
    if missing or stray:
        raise AssertionError(f"{name}: kernels never launched {missing}, stray {stray}")


def cand_record(res, eng) -> dict:
    return {"concepts": res.n_concepts, "iterations": res.n_iterations,
            "closures": res.n_closures_computed, "bytes": res.modeled_comm_bytes,
            "reduce_rounds": dict(eng.stats.reduce_rounds)}


def run_cand_path(device, main_intents, multi_report) -> tuple[dict, dict, dict]:
    """Phase 12: the main path on 2-D (object x candidate) plans.  For every
    plan of CAND_PLANS and driver of CAND_DRIVERS a kernel run, a torch run
    and a warm kernel run on full-scale mushroom at MAIN_MIN_SUPPORT; counts,
    modeled bytes and the schedule census equal the reference's
    (CAND_EXPECTED); concept sets equal phase 4's (the 1-D kernel run) and
    the 2-D torch run's; K1 and K2 launched on one object shard, K1, K3 and
    K4 (not K2) on k > 1.  MRGanter+ once more at max_batch 1024, and
    census-income at CAND_CENSUS_PLAN.  Warm walls stand beside phase 5's
    1-D walls at the same number of shards x blocks, with the garbage
    collector's pauses.  Returns the report, the launches of the kernel
    runs and the K2 chunks of one more run of the 1 x 4 rsag plan and the
    K3 / K4 chunks of one more run of the 2 x 4 and 4 x 2 rsag plans, each
    driver but the dedupe one (phase 3's check of the 2-D chunks)."""
    from repro_torch.data import fca_datasets

    ctx, spec = fca_datasets.load("mushroom", scale=1.0)
    main_set = intent_set(main_intents)
    launches = {n: 0 for n in ("closure", "fused_step", "map_closure", "filter_step")}
    report = {}

    def check(name, res, eng, want):
        got = cand_record(res, eng)
        if got != want:
            raise AssertionError(f"{name}: {got} != reference {want}")
        return got

    for k, c, impl in CAND_PLANS:
        for algorithm in CAND_DRIVERS:
            key = cand_key(k, c, impl, algorithm)
            want = CAND_EXPECTED[key]
            kw = {"plan": cand_plan(k, c, impl)}
            res, eng, wall, counts = drive_main_path(ctx, "kernel", algorithm, device, kw)
            cold_gc = GC_PAUSES[-1]["gc_ms"]
            tres, teng, twall, tcounts = drive_main_path(ctx, "torch", algorithm, device, kw)
            wres, _, wwall, wcounts = drive_main_path(ctx, "kernel", algorithm, device, kw)
            got = check(key, res, eng, want)
            check(key + " torch", tres, teng, want)
            if not intent_set(res.intents) == intent_set(tres.intents) == main_set:
                raise AssertionError(f"{key}: concept sets differ from the torch run's or "
                                     "phase 4's")
            if intent_set(wres.intents) != main_set or wcounts != counts:
                raise AssertionError(f"{key}: the warm run differs from the first")
            if any(tcounts.values()):
                raise AssertionError(f"{key}: the torch backend launched a kernel")
            check_cand_counts(key, k, counts)
            for n in launches:
                launches[n] += counts[n]
            one_d = multi_report.get(f"{algorithm}/k={k * c}/rsag", {}).get("kernel_wall_s")
            report[key] = dict(
                got, launches=counts,
                kernel_wall_s={"cold": wall, "warm": wwall}, torch_wall_s=twall,
                gc_ms={"cold": cold_gc, "warm": GC_PAUSES[-1]["gc_ms"]},
                one_d_kernel_wall_s=one_d.get("warm") if isinstance(one_d, dict) else one_d,
            )
    k, c, impl, mb = CAND_SMALL_BATCH
    key = cand_key(k, c, impl, "mrganter+", mb)
    runs = [drive_main_path(ctx, "kernel", "mrganter+", device, {"plan": cand_plan(k, c, impl, mb)})
            for _ in range(2)]
    for res, eng, _, counts in runs:
        got = check(key, res, eng, CAND_EXPECTED[key])
        if intent_set(res.intents) != main_set:
            raise AssertionError(f"{key}: concept set differs from phase 4's")
        check_cand_counts(key, k, counts)
    if runs[0][1].stats.closure_calls <= runs[0][0].n_iterations:
        raise AssertionError(f"{key}: no round spanned several chunks")
    for n in launches:
        launches[n] += runs[0][3][n]
    report[key] = dict(got, launches=runs[0][3], closure_calls=runs[0][1].stats.closure_calls,
                       kernel_wall_s={"cold": runs[0][2], "warm": runs[1][2]},
                       gc_ms=GC_PAUSES[-1]["gc_ms"])
    emit({"phase": "cand_path", "dataset": spec.name, "objects": ctx.n_objects,
          "attributes": ctx.n_attrs, "min_support": MAIN_MIN_SUPPORT, "runs": report})

    cctx, cspec = fca_datasets.load("census-income", scale=1.0)
    k, c, impl = CAND_CENSUS_PLAN
    key = "census " + cand_key(k, c, impl, "mrganter+")
    cruns = [drive_main_path(cctx, "kernel", "mrganter+", device, {"plan": cand_plan(k, c, impl)},
                             CENSUS_MIN_SUPPORT) for _ in range(2)]
    for res, eng, _, counts in cruns:
        got = check(key, res, eng, CAND_EXPECTED[key])
        check_cand_counts(key, k, counts)
    for n in launches:
        launches[n] += cruns[0][3][n]
    report[key] = dict(got, launches=cruns[0][3],
                       kernel_wall_s={"cold": cruns[0][2], "warm": cruns[1][2]},
                       gc_ms=GC_PAUSES[-1]["gc_ms"],
                       one_d_kernel_wall_s=None)
    emit({"phase": "cand_census", "dataset": cspec.name, "objects": cctx.n_objects,
          "attributes": cctx.n_attrs, "min_support": CENSUS_MIN_SUPPORT,
          "plan": {"n_parts": k, "cand_parts": c, "reduce_impl": impl}, **report[key]})

    # K2 chunks of a one-shard plan, K3 / K4 chunks of the k-shard plans
    chunks = {}
    for k, c, impl in ((1, 4, "rsag"), (2, 4, "rsag"), (4, 2, "rsag")):
        names = ("fused_step",) if k == 1 else ("map_closure", "filter_step")
        for algorithm in ("mrganter+", "mrcbo"):
            key = cand_key(k, c, impl, algorithm)
            _, captured = capture_launches(names, lambda: drive_main_path(
                ctx, "kernel", algorithm, device, {"plan": cand_plan(k, c, impl)})[0])
            check_captured(key, captured, report[key]["launches"])
            for name in names:
                chunks.setdefault(name, []).extend((key, c, a, kw) for a, kw in captured[name])
    return report, launches, chunks


def check_row_off(chunks: dict) -> dict:
    """Phase 3, on the 2-D path's own chunks (a simulated plan launches
    once over the whole ``[cand_parts·Bc]`` chunk, up to 32,768 rows):
    every whole-chunk launch of K2, K3 and K4 equals its plain version on
    the same operands, bit for bit; K2 and K4 launched once per block at
    ``row_off = c·Bc`` on the block's rows give, bit for bit, what the
    whole-chunk launch at ``row_off = 0`` gave (closures, supports, keep);
    and the two timings of each K2 / K4 chunk's launches."""
    import torch

    from repro_torch.kernels import frontier as fk

    plain = {"fused_step": fk.fused_step_plain, "map_closure": fk.map_closure_plain,
             "filter_step": fk.filter_step_plain}
    out = {}
    for name, recs in chunks.items():
        kern = getattr(fk, name)
        cases, block_cases, whole_ms, blocks_ms = 0, 0, 0.0, 0.0
        for key, cp, args, kw in recs:
            whole = kern(*args, **kw)
            require_equal(f"{name} whole chunk ({key})", whole, plain[name](*args, **kw))
            cases += 1
            if name == "map_closure":  # K3 takes no row_off
                continue
            sc = args[-1]
            B = args[1].shape[0] if name == "fused_step" else args[0].shape[-2]
            if sc[3] != 0 or B % cp:
                raise AssertionError(f"{name} chunk of {key}: row_off {sc[3]}, B {B}")
            Bc = B // cp
            blocks = []  # each block's operands: rows / partials sliced, row_off = c·Bc
            for i in range(cp):
                sl = slice(i * Bc, (i + 1) * Bc)
                bkw = {k: (v[sl].contiguous() if k in ("parent", "lowrow", "gens") else v)
                       for k, v in kw.items()}
                bsc = (sc[0], sc[1], sc[2], i * Bc)
                if name == "fused_step":
                    bargs = (args[0], args[1][sl].contiguous(), args[2], bsc)
                else:
                    bargs = (args[0][..., sl, :].contiguous(),
                             None if args[1] is None else args[1][..., sl].contiguous(), bsc)
                blocks.append((bargs, bkw))
            parts = [kern(*a, **k) for a, k in blocks]
            joined = tuple(None if whole[j] is None else torch.cat([p[j] for p in parts])
                           for j in range(3))
            require_equal(f"{name} per block at row_off = c·Bc ({key})", joined, whole)
            whole_ms += cuda_time_ms(lambda: kern(*args, **kw), reps=5, warmup=1)
            blocks_ms += cuda_time_ms(lambda: [kern(*a, **k) for a, k in blocks], reps=5,
                                      warmup=1)
            block_cases += 1
        out[name] = {"against_plain": cases, "per_block_cases": block_cases,
                     "bit_exact": True}
        if block_cases:
            out[name].update(whole_chunk_ms_sum=whole_ms, per_block_ms_sum=blocks_ms)
    emit({"phase": "kernels_row_off", **out})
    return out


def run_tracing_phase(device, main_intents) -> dict:
    """Phase 13: the tracer on the card.  MRGanter+ at 2 x 4 rsag (K1, K3,
    K4) and phase 8's serve batch at k = 1 (K1, K5), each untraced, traced
    and untraced again: the traced run's results bit-identical to the
    untraced ones, its trace valid, the span rollup (count, total ms, p50)
    and the traced against untraced warm walls printed.  Then a
    torch.profiler device trace (``start_device_trace``) over a 2 x 4 and a
    1 x 4 run: it must start and export, and name the tensor-core closure
    body in its fused (K2) and map (K3) forms and K4's filter kernel."""
    import re

    import numpy as np
    import torch

    from repro_torch.data import fca_datasets
    from repro_torch.dist import ShardPlan
    from repro_torch.launch.fca import serve_queries
    from repro_torch.obs import (Tracer, span_rollup, start_device_trace, stop_device_trace,
                                 use_tracer, validate_trace)
    from repro_torch.obs.trace import DEVICE_TRACE_FILE
    from repro_torch.query import ConceptStore, QueryConfig, QueryEngine

    ctx, _ = fca_datasets.load("mushroom", scale=1.0)
    plan_kw = {"plan": cand_plan(2, 4, "rsag")}

    def fingerprint(res, eng):
        s = eng.stats
        return ([y.tobytes() for y in res.intents], res.n_iterations, s.closure_calls,
                s.closures_computed, s.modeled_comm_bytes, dict(s.reduce_rounds),
                s.h2d_transfers, s.h2d_bytes, s.d2h_transfers, s.d2h_bytes)

    def rollup(tr):
        trace = json.loads(json.dumps(tr.to_dict()))
        summary = validate_trace(trace)
        roll = span_rollup(trace["traceEvents"])
        return summary, {n: {"count": r["count"], "total_ms": r["total_s"] * 1e3,
                             "p50_ms": r["p50_s"] * 1e3}
                         for n, r in roll.items() if n in TRACE_SPANS}

    report = {}
    runs = []
    for traced in (False, True, False):
        tr = Tracer() if traced else None
        with use_tracer(tr):
            res, eng, wall, counts = drive_main_path(ctx, "kernel", "mrganter+", device, plan_kw)
        runs.append((fingerprint(res, eng), wall, tr, counts))
    if not runs[0][0] == runs[1][0] == runs[2][0]:
        raise AssertionError("tracing: the traced mine differs from the untraced ones")
    summary, roll = rollup(runs[1][2])
    report["mine 2x4 rsag mrganter+"] = {
        "trace": summary, "rollup": roll, "launches": runs[1][3],
        "wall_s": {"untraced": runs[0][1], "traced": runs[1][1], "untraced_again": runs[2][1]}}

    store = ConceptStore.build(ctx, main_intents, plan=ShardPlan.simulated(1), device=device)
    queries = serve_queries(ctx, SERVE_QUERIES, np.random.default_rng(0))
    qe = QueryEngine(store, QueryConfig(slots=SERVE_SLOTS, backend="kernel"))
    sruns = []
    for traced in (False, True, False):
        tr = Tracer() if traced else None
        with use_tracer(tr):
            got, wall, counts = drive_queries(lambda: serve_answers(qe, queries), device)
        sruns.append((got, wall, tr))
    if not (same_arrays(flat(sruns[0][0]), flat(sruns[1][0]))
            and same_arrays(flat(sruns[0][0]), flat(sruns[2][0]))):
        raise AssertionError("tracing: the traced serve batch answered otherwise")
    if serve_record(qe, sruns[1][0])["sha256"] != SERVE_EXPECTED[1]["sha256"]:
        raise AssertionError("tracing: the traced serve batch differs from the reference")
    summary, roll = rollup(sruns[1][2])
    report["serve k=1"] = {
        "trace": summary, "rollup": roll,
        "wall_s": {"untraced": sruns[0][1], "traced": sruns[1][1],
                   "untraced_again": sruns[2][1]}}

    trace_dir = ROOT / "build" / "device_trace"
    if not start_device_trace(str(trace_dir)):
        raise AssertionError("tracing: start_device_trace did not start a profiler session")
    try:
        for kw in (plan_kw, {"plan": cand_plan(1, 4, "rsag")}):
            drive_main_path(ctx, "kernel", "mrganter+", device, kw)
        torch.cuda.synchronize()
    finally:
        stopped = stop_device_trace()
    path = trace_dir / DEVICE_TRACE_FILE
    if not stopped or not path.is_file():
        raise AssertionError("tracing: the device trace was not exported")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    symbols = {"K2 closure_tc_kernel<W, true, ...>": r"closure_tc_kernel<\d+, true",
               "K3 closure_tc_kernel<W, false, ...>": r"closure_tc_kernel<\d+, false",
               "K4 filter_kernel": r"filter_kernel"}
    found = {k: sorted(n for n in names if re.search(pat, n))[:2]
             for k, pat in symbols.items()}
    report["device_trace"] = {"events": len(events), "kernel_names": len(names),
                              "bytes": path.stat().st_size, "found": found}
    path.unlink()
    missing = [k for k, v in found.items() if not v]
    if missing:
        raise AssertionError(f"tracing: the device trace names no {missing}")
    emit({"phase": "tracing", **report})
    return report


# ---------------------------------------------------------------------------
# async rounds (phase 14)
# ---------------------------------------------------------------------------

SPEC_DISPATCHES = ("spec_oplus", "spec_cbo", "spec_ganter")


@contextlib.contextmanager
def spec_sync_guard():
    """Run every speculative dispatch (``DeviceFrontier.spec_*``) under
    ``torch.cuda.set_sync_debug_mode("error")``: a host read of a device
    value, a synchronising copy or a stream synchronisation inside one
    raises.  Yields the count of guarded dispatches."""
    import functools

    import torch

    from repro_torch.core.frontier import DeviceFrontier

    count = {"dispatches": 0}
    real = {name: getattr(DeviceFrontier, name) for name in SPEC_DISPATCHES}

    def guarded(fn):
        @functools.wraps(fn)
        def call(self, *args, **kw):
            before = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(self, *args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(before)
            count["dispatches"] += 1
            return out
        return call

    for name, fn in real.items():
        setattr(DeviceFrontier, name, guarded(fn))
    try:
        yield count
    finally:
        for name, fn in real.items():
            setattr(DeviceFrontier, name, fn)


def check_sync_guard(device) -> str:
    """The guard's positive control: a host read of a device count inside
    a guarded dispatch must raise, or the guard proves nothing."""
    import torch

    from repro_torch.core.frontier import DeviceFrontier

    def reads_the_count(self):
        return int(torch.ones((), dtype=torch.int32, device=device) + 1)

    DeviceFrontier.spec_ganter, real = reads_the_count, DeviceFrontier.spec_ganter
    try:
        with spec_sync_guard():
            DeviceFrontier.spec_ganter(None)
    except RuntimeError as e:
        return str(e).splitlines()[0]
    finally:
        DeviceFrontier.spec_ganter = real
    raise AssertionError("sync guard: a host read inside a guarded dispatch did not raise")


def profile_rounds(device, ctx) -> dict:
    """Where a warm run's host time goes, sync beside async: MRGanter+ at
    1 x 1 and MRGanter's walk (ASYNC_GANTER) under ``torch.profiler``
    (CPU and CUDA activities): kernel launches and sorts enqueued, the
    device's self time, the copies and stream synchronisations, the
    costliest host ops by self time.  The profiler slows the host, so
    these walls are not the phase's walls."""
    from torch.profiler import ProfilerActivity, profile

    k, c, impl, cap = ASYNC_GANTER
    out = {}
    for algorithm, max_iterations in (("mrganter+", None), ("mrganter", cap)):
        for rounds in ("sync", "async"):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, eng, wall, _ = drive_main_path(ctx, "kernel", algorithm, device,
                                                  {"plan": cand_plan(k, c, impl)},
                                                  MAIN_MIN_SUPPORT, rounds, max_iterations)
            ops = prof.key_averages()
            by = {e.key: e for e in ops}

            def count(name):
                return by[name].count if name in by else 0

            out[f"{algorithm} {rounds}"] = {
                "wall_ms": wall * 1e3, "host_blocked_ms": eng.stats.host_blocked_s * 1e3,
                "kernel_launches": count("cudaLaunchKernel"), "sorts": count("aten::sort"),
                "memcpy_async": count("cudaMemcpyAsync"),
                "stream_synchronize": count("cudaStreamSynchronize"),
                "event_synchronize": count("cudaEventSynchronize"),
                "device_self_ms": sum(getattr(e, "self_device_time_total",
                                              getattr(e, "self_cuda_time_total", 0))
                                      for e in ops) / 1e3,
                "top_self_cpu_ms": [(e.key, e.count, e.self_cpu_time_total / 1e3) for e in
                                    sorted(ops, key=lambda e: -e.self_cpu_time_total)[:6]]}
    return out


def run_async_path(device, main_intents) -> tuple[dict, dict]:
    """Phase 14: the main path with ``rounds="async"``.  For every plan of
    ASYNC_PLANS and driver of ASYNC_DRIVERS a guarded async run (cold:
    every speculative dispatch under ``set_sync_debug_mode("error")``, the
    guard's positive control first), a warm async run and a warm sync run
    on full-scale mushroom at MAIN_MIN_SUPPORT (the walls are the
    unguarded ones); MRGanter+ at ASYNC_SMALL_BATCH (under-coverage must
    fall back on the card); MRGanter's walk at ASYNC_GANTER beside its sync
    walk; census-income at ASYNC_CENSUS_PLAN.  Every async run's counts,
    bytes, schedule, transfer and speculation census equal the reference's
    async run (ASYNC_EXPECTED); concept sets equal phase 4's (MRGanter's
    walk: its sync walk's intents, in order) and iteration counts the sync
    run's; the kernels of the plan launched (K1 and K2 on one object shard,
    K1, K3 and K4 on k > 1; MRGanter's walk K1 alone), as often in every
    async run.  Then one traced async run (2 x 4): the trace valid, and a
    ``spec/dispatch`` span inside an earlier round's window; and
    ``profile_rounds``.  Returns the report and the launches of the warm
    async kernel runs."""
    import numpy as np

    from repro_torch.data import fca_datasets
    from repro_torch.obs import Tracer, async_overlaps, span_rollup, use_tracer, validate_trace

    ctx, spec = fca_datasets.load("mushroom", scale=1.0)
    cctx, _ = fca_datasets.load("census-income", scale=1.0)
    main_set = intent_set(main_intents)
    launches = {n: 0 for n in ("closure", "fused_step", "map_closure", "filter_step")}
    report = {"sync_guard_control": check_sync_guard(device)}
    guarded_total = 0

    def drive(c, algorithm, plan, ms, rounds, guarded=False, **kw):
        with spec_sync_guard() if guarded else contextlib.nullcontext() as guard:
            run = drive_main_path(c, "kernel", algorithm, device, {"plan": plan}, ms, rounds,
                                  **kw)
        if guarded and guard["dispatches"] != run[1].stats.spec_rounds:
            raise AssertionError(f"{guard['dispatches']} guarded dispatches, "
                                 f"{run[1].stats.spec_rounds} speculative rounds")
        return run, GC_PAUSES[-1]["gc_ms"]

    def runs_of(key, c, algorithm, plan, ms=MAIN_MIN_SUPPORT, **kw):
        """The guarded async run, the warm async run and the warm sync run,
        each async run held against the reference."""
        nonlocal guarded_total
        runs = {"async_guarded": drive(c, algorithm, plan, ms, "async", True, **kw),
                "async": drive(c, algorithm, plan, ms, "async", **kw),
                "sync": drive(c, algorithm, plan, ms, "sync", **kw)}
        for name in ("async_guarded", "async"):
            got = async_record(*runs[name][0][:2])
            if got != ASYNC_EXPECTED[key]:
                raise AssertionError(f"async {key} ({name}): {got} != reference "
                                     f"{ASYNC_EXPECTED[key]}")
        guarded_total += got["spec_rounds"]
        counts = runs["async"][0][3]
        if runs["async_guarded"][0][3] != counts:
            raise AssertionError(f"async {key}: launch counts differ between runs")
        if any(r[0].n_iterations != runs["sync"][0][0].n_iterations for r, _ in runs.values()):
            raise AssertionError(f"async {key}: iterations differ from the sync run's")
        for n in launches:
            launches[n] += counts[n]
        report[key] = dict(got, launches=counts, walls={
            name: {"wall_s": r[2], "host_blocked_s": r[1].stats.host_blocked_s,
                   "dispatch_s": r[1].stats.dispatch_s, "d2h_transfers": r[1].stats.d2h_transfers,
                   "gc_ms": gc_ms}
            for name, (r, gc_ms) in runs.items()})
        return {name: r for name, (r, _) in runs.items()}

    def same_set(key, runs, want):
        if any(intent_set(r[0].intents) != want for r in runs.values()):
            raise AssertionError(f"async {key}: a concept set differs from phase 4's")

    for k, c, impl in ASYNC_PLANS:
        for algorithm in ASYNC_DRIVERS:
            key = async_key(k, c, impl, algorithm)
            runs = runs_of(key, ctx, algorithm, cand_plan(k, c, impl))
            same_set(key, runs, main_set)
            check_cand_counts(f"async {key}", k, runs["async"][3])

    k, c, impl, mb = ASYNC_SMALL_BATCH
    key = async_key(k, c, impl, "mrganter+", mb)
    runs = runs_of(key, ctx, "mrganter+", cand_plan(k, c, impl, mb))
    same_set(key, runs, main_set)
    check_cand_counts(f"async {key}", k, runs["async"][3])
    if report[key]["spec_fallbacks"] == 0:
        raise AssertionError(f"async {key}: no speculative round fell back")

    k, c, impl, cap = ASYNC_GANTER
    key = async_key(k, c, impl, "mrganter", max_iterations=cap)
    runs = runs_of(key, ctx, "mrganter", cand_plan(k, c, impl), max_iterations=cap)
    walk = np.stack(runs["sync"][0].intents).tobytes()
    if any(np.stack(r[0].intents).tobytes() != walk for r in runs.values()):
        raise AssertionError(f"async {key}: the walk differs from the sync walk")
    counts = runs["async"][3]
    if counts["closure"] == 0 or any(v for n, v in counts.items() if n != "closure"):
        raise AssertionError(f"async {key}: launches {counts}, K1 alone expected")

    k, c, impl = ASYNC_CENSUS_PLAN
    key = "census " + async_key(k, c, impl, "mrganter+")
    runs = runs_of(key, cctx, "mrganter+", cand_plan(k, c, impl), CENSUS_MIN_SUPPORT)
    check_cand_counts(f"async {key}", k, runs["async"][3])

    # one traced async run: valid, and a dispatch inside an earlier round
    tracer = Tracer()
    with use_tracer(tracer):
        (tres, _, twall, _), _ = drive(ctx, "mrganter+", cand_plan(2, 4, "rsag"),
                                       MAIN_MIN_SUPPORT, "async")
    trace = json.loads(json.dumps(tracer.to_dict()))
    summary = validate_trace(trace)
    overlaps = [o for o in async_overlaps(trace) if o["span"].startswith("spec/dispatch")]
    earlier = [o for o in overlaps if int(o["span"][len("spec/dispatch["):-1]) > o["round_id"]]
    if not earlier:
        raise AssertionError("async trace: no spec/dispatch span inside an earlier round")
    if intent_set(tres.intents) != main_set:
        raise AssertionError("async trace: the traced run's concept set differs")
    roll = span_rollup(trace["traceEvents"])
    report["traced 2x4 rsag mrganter+"] = {
        "trace": summary, "spec_dispatch_overlaps": len(overlaps),
        "inside_an_earlier_round": len(earlier), "wall_s": twall,
        "rollup": {n: {"count": r["count"], "total_ms": r["total_s"] * 1e3,
                       "p50_ms": r["p50_s"] * 1e3}
                   for n, r in roll.items()
                   if n in ("mine/mrganter_plus", "mine/round", "spec/dispatch",
                            "spec/reconcile")}}
    report["sync_debug_guarded_dispatches"] = guarded_total
    report["profiled"] = profile_rounds(device, ctx)
    emit({"phase": "async_path", "dataset": spec.name, "objects": ctx.n_objects,
          "attributes": ctx.n_attrs, "min_support": MAIN_MIN_SUPPORT, "runs": report,
          "launches": launches})
    return report, launches


# ---------------------------------------------------------------------------
# the serving tier: K5 and K6 (phase 3), serve (phase 8), rules (phase 9)
# ---------------------------------------------------------------------------


def check_serve_kernels(device) -> list[dict]:
    """Phase 3, serving half: K5 and K6 against their plain versions, bit for
    bit, on seeded tables: S not a multiple of 8, a table above the
    reference's 2**22 cells, k from 1 past one launch's 64 to C + 1, live counts below
    the table size, forced ties, thresholds float32 cannot hold exactly, and
    tables where no row matches."""
    import numpy as np
    import torch

    from repro_torch.device import device_bits
    from repro_torch.kernels import serve as sk

    rng = np.random.default_rng(20121015)
    records = []
    big = (1 << 20) + 3
    cases = [(S, C, W, k) for S in (8, 64, 1000, 1024) for C in (1, 7, 8192)
             for W in (4, 5) for k in (1, 5, 64)]
    cases += [(S, big, W, k) for S in (64, 1000) for W in (4, 5) for k in (5, 64)]
    # past one launch's PASS_K winners: k passes of at most 64, each after the
    # previous pass's last winner (k = C + 1: every live row and then pads)
    cases += [(S, C, W, k) for S in (64, 1000) for C in (7, 8192) for W in (4, 5)
              for k in (65, 100, 128)]
    cases += [(S, 7, W, 8) for S in (64, 1000) for W in (4, 5)]
    cases += [(64, 8192, W, 8193) for W in (4, 5)]
    for S, C, W, k in cases:
        live = C if C < 8 else C - 1 - int(rng.integers(0, 5))  # pads past the live rows
        miss = (S, C, W, k) in ((64, 8192, 4, 5), (1000, big, 5, 64))
        intents = bitsets(rng, C, W, 0.6)
        gc = intents[rng.integers(0, C, size=S)] & bitsets(rng, S, W, 0.3)
        gc[0] = 0  # every live concept contains the empty query
        if miss:
            gc[:] = 0xFFFFFFFF
            intents &= np.uint32(0x7FFFFFFF)
        ties = 4 if C > 8 else 10_000
        supports = torch.from_numpy(rng.integers(0, ties, size=C).astype(np.int32)).to(device)
        args = (device_bits(gc, device), device_bits(intents, device), supports, live)
        got = sk.contains_topk(*args, k=k)
        want = sk.contains_topk_plain(*args, k=k)
        require_equal(f"K5 S={S} C={C} W={W} k={k}", got, want)
        hits5 = int((want[0] >= 0).sum())
        if miss and hits5:
            raise AssertionError(f"K5 S={S} C={C}: the no-match case matched")
        prem = bitsets(rng, C, W, 0.06)
        added = bitsets(rng, C, W, 0.2) & ~prem
        conf = rng.choice(np.asarray([0.1, 0.7, 0.5, 1.0], np.float32), size=C)
        metric = rng.choice(np.asarray([0.0, 0.25, 2.0, 1.0], np.float32), size=C)
        queries = bitsets(rng, S, W, 0.85)
        queries[0] = 0xFFFFFFFF
        if miss:
            queries[:] = 0
            prem |= np.uint32(1)
        rargs = (device_bits(prem, device), device_bits(added, device),
                 torch.from_numpy(conf.astype(np.float32)).to(device),
                 torch.from_numpy(metric.astype(np.float32)).to(device),
                 torch.from_numpy(rng.permutation(C).astype(np.int32)).to(device), live,
                 device_bits(queries, device))
        hits6 = 0
        for min_conf in (0.1, 0.7):
            got = sk.rules_topk(*rargs, min_conf, k=k)
            want = sk.rules_topk_plain(*rargs, min_conf, k=k)
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("ids", "scores", "union")):
                if not torch.equal(g, w):
                    raise AssertionError(f"K6 S={S} R={C} W={W} k={k} min_conf={min_conf}: "
                                         f"{what} differ from the plain version")
            hits6 += int((want[0] >= 0).sum())
        if miss and hits6:
            raise AssertionError(f"K6 S={S} R={C}: the no-match case matched")
        records.append({"kernel": "contains_topk", "S": S, "C": C, "W": W, "k": k,
                        "live": live, "hits": hits5})
        records.append({"kernel": "rules_topk", "S": S, "R": C, "W": W, "k": k,
                        "live": live, "hits": hits6})
    return records


# K6's split of the live table at its edges (phase 3): S at 1, 8, 63, 64 (a
# serve micro-batch) and 1000; k at 1, 5 (the serve phase's), 64 (one pass),
# 65 and 100 (two passes) and, at S in {1, 64}, C + 1 (every row); live counts
# of 1, of a whole number of slices under their own plan and one row either
# side, and of the rules phase's table (4,999 + 356 rows).
RULES_SPLIT_S = (1, 8, 63, 64, 1000)
RULES_SPLIT_K = (1, 5, 64, 65, 100)
RULES_LIVE = 4999 + 356
# K5's split at its edges: the same S; live counts of none, 1, one tile and
# one row either side of it, the serve phase's 4,282 intents and 2**20 + 3;
# k at 1, 5, 64, 65 and 130 (three passes).
CONTAINS_SPLIT_LIVE = (0, 1, 255, 256, 257, 4282, 2**20 + 3)
CONTAINS_SPLIT_K = (1, 5, 64, 65, 130)
# The plan of K5 and K6 (topk_plan in csrc/serve.cu) is held at these live
# counts too, on this card and on cards of 1 and 132 SMs.
TOPK_PLAN_LIVE = (-1, 0, 1, 255, 256, 257, 4282, RULES_LIVE, 2**20 + 3)


def check_topk_plan(S: int, live: int, sms: int) -> tuple[int, int, int]:
    """The plan of S queries against ``live`` table rows: at least one
    slice, at most 32 (one per lane of the merging warp) and one per
    256-row tile, every live row in exactly one slice, none empty when
    there are more, and one query block per 8 queries."""
    from repro_torch.kernels import serve as sk

    slice_rows, nslice, blocks = sk.topk_plan(S, live, sms)
    tiles = -(-max(0, live) // 256)
    covered = nslice * slice_rows >= live
    none_empty = nslice == 1 or (nslice - 1) * slice_rows < live
    ok = (slice_rows >= 1 and slice_rows % 256 == 0 and 1 <= nslice <= min(32, max(1, tiles))
          and blocks == -(-S // 8) and covered and none_empty)
    if not ok:
        raise AssertionError(f"top-k plan S={S} live={live} sms={sms}: {slice_rows} rows x "
                             f"{nslice} slices, {blocks} query blocks")
    return slice_rows, nslice, blocks


def check_contains_split(device) -> list[dict]:
    """Phase 3, K5 with its table split across CTAs (``CONTAINS_SPLIT_*``
    and ``RULES_SPLIT_S``) against the plain version, bit for bit: supports
    from 0 to 3 (ties everywhere), and the rows either side of every slice
    boundary containing every query at one higher support (ties across
    slices: the lower index wins); pad rows past the live count that
    contain every query at a support above all (never read); one launch per
    64 columns."""
    import numpy as np
    import torch

    from repro_torch.device import device_bits
    from repro_torch.kernels import serve as sk

    rng = np.random.default_rng(20121018)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if check_topk_plan(64, 4282, 132)[:2] != (256, 17):
        raise AssertionError("K5 plan: 64 slots against the serve phase's 4,282 intents on "
                             "132 SMs is not 17 slices of one tile")
    W = 4
    records = []
    for live in CONTAINS_SPLIT_LIVE:
        C = live + 3
        base = bitsets(rng, C, W, 0.6)
        for S in RULES_SPLIT_S:
            edge, nslice, _ = check_topk_plan(S, live, sms)
            intents = base.copy()
            supports = rng.integers(0, 4, size=C).astype(np.int32)
            ends = sorted({r for j in range(nslice + 1) for r in (j * edge - 1, j * edge)
                           if 0 <= r < live})
            intents[ends] = 0xFFFFFFFF
            supports[ends] = 4
            intents[live:] = 0xFFFFFFFF
            supports[live:] = 1 << 20
            gc = base[rng.integers(0, C, size=S)] & bitsets(rng, S, W, 0.3)
            gc[0] = 0
            args = (device_bits(gc, device), device_bits(intents, device),
                    torch.from_numpy(supports).to(device), live)
            for k in CONTAINS_SPLIT_K:
                name = f"K5 split S={S} live={live} ({nslice} x {edge} rows) k={k}"
                before = sk.contains_topk.launches
                got = sk.contains_topk(*args, k=k)
                want = sk.contains_topk_plain(*args, k=k)
                require_equal(name, got, want)
                if sk.contains_topk.launches - before != -(-k // sk.PASS_K):
                    raise AssertionError(f"{name}: {sk.contains_topk.launches - before} "
                                         "launches")
                if ends and int(want[0][0, 0]) != ends[0]:
                    raise AssertionError(f"{name}: the first tied boundary row is not first")
                records.append({"kernel": "contains_topk", "split_edge": True, "S": S,
                                "live": live, "slices": nslice, "slice_rows": edge, "k": k,
                                "hits": int((want[0] >= 0).sum())})
    return records


def check_rules_split(device) -> list[dict]:
    """Phase 3, K6 with its table split across CTAs (``RULES_SPLIT_*``)
    against the plain version, bit for bit: equal (metric, rule id) at
    positions in different slices (the lower position wins), rules firing in
    every slice, in one slice only or in none, min_conf 0.1 and 0.7."""
    import numpy as np
    import torch

    from repro_torch.device import device_bits
    from repro_torch.kernels import serve as sk

    rng = np.random.default_rng(20121016)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if check_topk_plan(64, RULES_LIVE, 132)[:2] != (256, 21):
        raise AssertionError("K6 plan: 64 slots against the rules phase's table on 132 SMs "
                             "is not 21 slices of one tile")
    W, off = 4, np.uint32(1 << 30)  # bit 30 of word 0: set where a rule must not fire
    records = []
    for S in RULES_SPLIT_S:
        for live in TOPK_PLAN_LIVE:
            for n_sm in (1, 132, sms):
                check_topk_plan(S, live, n_sm)

        def plan(live):
            return check_topk_plan(S, live, sms)

        whole = [L for L in range(2, 6145)
                 if plan(L)[1] > 1 and L % plan(L)[0] == 0]
        lives = sorted({1, RULES_LIVE, *(L + d for L in (whole[0], whole[-1])
                                         for d in (-1, 0, 1))})
        for live in lives:
            edge, nslice, _ = plan(live)
            for fire in ("every", "one slice", "none"):
                R = live + 3  # pad rows past the live count
                prem = bitsets(rng, R, W, 0.06)
                added = bitsets(rng, R, W, 0.2) & ~prem
                conf = rng.choice(np.asarray([0.1, 0.7, 0.5, 1.0], np.float32), size=R)
                metric = rng.choice(np.asarray([0.0, 0.25, 1.0, 2.0], np.float32), size=R)
                rid = rng.integers(0, 8, size=R).astype(np.int32)  # ties at far positions
                queries = bitsets(rng, S, W, 0.85)
                queries[0] = 0xFFFFFFFF
                if fire == "every":
                    # the best entry twice, in the first and in the last slice
                    prem[[0, live - 1]] = 0
                    conf[[0, live - 1]] = 1.0
                    metric[[0, live - 1]] = 3.0
                    rid[[0, live - 1]] = 0
                else:
                    queries[:, 0] &= ~off
                    prem[:, 0] |= off
                    if fire == "one slice":
                        j = nslice // 2
                        prem[j * edge: (j + 1) * edge, 0] &= ~off
                args = (device_bits(prem, device), device_bits(added, device),
                        torch.from_numpy(conf).to(device), torch.from_numpy(metric).to(device),
                        torch.from_numpy(rid).to(device), live, device_bits(queries, device))
                ks = RULES_SPLIT_K + ((R + 1,) if S in (1, 64) else ()) if fire == "every" \
                    else (5,)
                for k in ks:
                    for min_conf in (0.1, 0.7):
                        name = (f"K6 split S={S} live={live} ({nslice} x {edge} rows) "
                                f"fire={fire} k={k} min_conf={min_conf}")
                        before = sk.rules_topk.launches
                        got = sk.rules_topk(*args, min_conf, k=k)
                        want = sk.rules_topk_plain(*args, min_conf, k=k)
                        torch.cuda.synchronize()
                        for g, w, what in zip(got, want, ("ids", "scores", "union")):
                            if not torch.equal(g, w):
                                raise AssertionError(f"{name}: {what} differ from the plain "
                                                     "version")
                        if sk.rules_topk.launches - before != -(-k // sk.PASS_K):
                            raise AssertionError(f"{name}: {sk.rules_topk.launches - before} "
                                                 "launches")
                        hits = int((want[0] >= 0).sum())
                        if fire == "none" and hits:
                            raise AssertionError(f"{name}: a rule fired")
                        if fire == "every" and int(want[0][0, 0]) != 0:
                            raise AssertionError(f"{name}: the tied best entry is missing")
                        records.append({"kernel": "rules_topk", "split_edge": True, "S": S,
                                        "live": live, "slices": nslice, "slice_rows": edge,
                                        "fire": fire, "k": k, "min_conf": min_conf,
                                        "hits": hits})
    return records


# ---------------------------------------------------------------------------
# the static checks (phase 16)
# ---------------------------------------------------------------------------


def analysis_gate() -> dict:
    """``python -m repro_torch.analysis --strict --json`` as a subprocess:
    exit 0 and no findings; returns its checked counts and seconds."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--strict", "--json"],
                         capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    seconds = time.perf_counter() - t0
    if out.returncode:
        raise AssertionError(f"analysis --strict exited {out.returncode}: "
                             f"{out.stdout[-3000:]} {out.stderr[-2000:]}")
    doc = json.loads(out.stdout)
    if not doc["ok"] or doc["findings"]:
        raise AssertionError(f"analysis --strict: findings {doc['findings'][:5]}")
    return {"seconds": seconds, "checked": doc["checked"]}


def analysis_sweep(device) -> tuple[dict, dict]:
    """The SPMD audit's sweep on the card, in this process: the hygiene
    self-test, then each geometry's frontier steps, the query steps and the
    basis passes, every step call under the sync guard.  Returns the
    report (checked counts, launches by geometry) and the summed launches."""
    import torch

    from repro_torch import kernels
    from repro_torch.analysis import Report, spmd_audit

    report = Report()
    blind = spmd_audit.self_test(device)
    if blind:
        raise AssertionError(f"analysis self-test: {[f.format() for f in blind]}")
    launches = {name: 0 for name in ANALYSIS_KERNELS}
    by_geometry = {}
    walls = {}

    def counted(label, run):
        kernels.reset_launches()
        t0 = time.perf_counter()
        found = run()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        if found:
            raise AssertionError(f"analysis sweep {label}: "
                                 f"{[f.format() for f in found[:8]]}")
        counts = {k.__name__: k.launches for k in kernels.KERNELS}
        for name in ANALYSIS_KERNELS:
            launches[name] += counts[name]
        return {name: counts[name] for name in ANALYSIS_KERNELS}

    for k, c in spmd_audit.GEOMETRIES:
        got = counted(f"{k}x{c}", lambda: spmd_audit.audit_frontier_steps(
            report, geometries=((k, c),), device=device))
        if k == 1:
            bad = not got["fused_step"] or got["map_closure"] or got["filter_step"]
        else:
            bad = got["fused_step"] or not got["map_closure"] or not got["filter_step"]
        if bad or not got["closure"]:
            raise AssertionError(f"analysis sweep {k}x{c}: launches {got}")
        by_geometry[f"{k}x{c}"] = got
    got = counted("query", lambda: spmd_audit.audit_query_steps(report, device=device))
    if not (got["closure"] and got["contains_topk"] and got["rules_topk"]):
        raise AssertionError(f"analysis sweep query steps: launches {got}")
    by_geometry["query"] = got
    counted("basis", lambda: spmd_audit.audit_basis_passes(report, device=device))
    return {"checked": report.checked, "launches": by_geometry, "walls_s": walls}, launches


def analysis_recorded(device) -> tuple[dict, dict]:
    """The recorder over whole mining runs at full width: per configuration
    of ANALYSIS_RECORDED, fresh engines run once to warm up, then off, on,
    on, off (``on``: inside ``spmd_audit.recording``); each recorded run's closure-word bytes must
    equal the engine's charged census and the reference's, with one
    recorded AND-allreduce per charged reduce round."""
    import torch

    from repro_torch import kernels
    from repro_torch.analysis import spmd_audit
    from repro_torch.core import ClosureEngine, mrcbo, mrganter_plus
    from repro_torch.data import fca_datasets

    contexts = {}
    launches = {name: 0 for name in ANALYSIS_KERNELS}
    report = {}
    for dataset, k, c, impl, algorithm, want_bytes, want_rounds in ANALYSIS_RECORDED:
        if dataset not in contexts:
            contexts[dataset] = fca_datasets.load(dataset, scale=1.0)[0]
        ctx = contexts[dataset]
        ms = MAIN_MIN_SUPPORT if dataset == "mushroom" else CENSUS_MIN_SUPPORT
        key = f"{dataset} {k}x{c} {impl} {algorithm}"
        walls = {"warm-up": [], "off": [], "on": []}
        for mode in ("warm-up", "off", "on", "on", "off"):
            plan = cand_plan(k, c, impl)
            eng = ClosureEngine(ctx, plan=plan, backend="kernel", device=device)
            kernels.reset_launches()
            torch.cuda.synchronize()
            with (spmd_audit.recording(plan, ctx.W, two_d=c > 1, hygiene=False)
                  if mode == "on" else contextlib.nullcontext()) as rec:
                t0 = time.perf_counter()
                if algorithm == "mrcbo":
                    res = mrcbo(ctx, eng, min_support=ms)
                else:
                    res = mrganter_plus(ctx, eng, local_prune=True, min_support=ms)
                torch.cuda.synchronize()
                walls[mode].append(time.perf_counter() - t0)
            counts = {kk.__name__: kk.launches for kk in kernels.KERNELS}
            check_multi_shard_counts(f"recorded {key}", counts)
            for name in ANALYSIS_KERNELS:
                launches[name] += counts[name]
            census = eng.stats.modeled_comm_bytes
            if census != want_bytes or res.modeled_comm_bytes != want_bytes:
                raise AssertionError(f"recorded {key}: census {census} against the "
                                     f"reference's {want_bytes}")
            if want_rounds is not None and dict(eng.stats.reduce_rounds) != want_rounds:
                raise AssertionError(f"recorded {key}: reduce rounds {eng.stats.reduce_rounds}")
            if mode != "on":
                continue
            recorded = rec.modeled_bytes()
            reduces = [r for r in rec.records if r.op == "and_allreduce"]
            rounds = sum(eng.stats.reduce_rounds.values())
            if recorded != census or len(reduces) != rounds:
                raise AssertionError(f"recorded {key}: {recorded} B in {len(reduces)} reduces "
                                     f"against the census's {census} B in {rounds} rounds")
            report[key] = {"recorded_bytes": recorded, "census_bytes": census,
                           "reference_bytes": want_bytes, "reduces": len(reduces),
                           "folded": sum(r.folded for r in reduces),
                           "gathers": sum(r.op == "all_gather_blocks" for r in rec.records),
                           "records": len(rec.records)}
        report[key]["wall_ms"] = {m: [w * 1e3 for w in v] for m, v in walls.items()}
        report[key]["recorder_overhead_ms"] = (statistics.mean(walls["on"])
                                               - statistics.mean(walls["off"])) * 1e3
    return report, launches


def run_analysis_phase(device) -> tuple[dict, dict]:
    """Phase 16: the strict gate, the SPMD sweep on the card and the
    full-width recorder runs.  Returns the report and the phase's kernel
    launches (the sweep's and the recorded runs')."""
    t0 = time.perf_counter()
    gate = analysis_gate()
    sweep, launches = analysis_sweep(device)
    recorded, more = analysis_recorded(device)
    for name, n in more.items():
        launches[name] += n
    report = {"gate": gate, "sweep": sweep, "recorded": recorded, "launches": launches,
              "seconds": time.perf_counter() - t0}
    emit({"phase": "analysis", **report})
    return report, launches


# ---------------------------------------------------------------------------
# the LM serving path: K7 (phase 3), reduced serve (phase 10), full width (11)
# ---------------------------------------------------------------------------

# K7 tolerances.  float32: 1e-5 absolute — the kernel and its plain version
# compute the same sums of float32 products in another order, so only
# rounding in the last bits differs.  bfloat16: each output element within
# K7_TOL["bfloat16"] times its own query row's rms (over hd), plus one
# bf16 step of the larger of the two values.  Why: both sides round p to
# bf16 (2**-9 relative) after a running max taken over other key blocks
# (64 keys against the plain version's 1024), so each weight w_j of the
# softmax average carries its own relative rounding d_j, and the output
# moves by sum_j w_j d_j (v_j - o): of order 2**-9 times the spread of the
# attended values, which for standard-normal V is the row's rms (both fall
# as 1/sqrt(keys attended), so one relative limit holds at S = 1 and at S =
# 5000).  2**-6 is 8 such steps, about 10 standard deviations of the sum.
# Then each side rounds its output to bf16 once, and two right answers may
# sit one bf16 step (8 significant bits) apart.  An absolute limit alone
# would not scale: at S = 5000 a typical |o| is about 0.02, as large as the
# 2e-2 the S = 1 cases need.  The earlier absolute limits still hold as well
# (K7_BF16_ABS): 2e-2 on standard-normal operands (|o| < ~4, whose bf16
# step is at most 2**-6), plus 2**-7 of |want| on the model's own chunks,
# whose outputs are not so bounded (K7_MODEL_REL: one bf16 step).
K7_TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}
K7_BF16_ABS = 2e-2
K7_MODEL_REL = 2.0**-7
K7_REF_CASES = (  # tests/test_flash_attention.py: every case shape
    (2, 4, 2, 64, 64, 16, True, None, None),
    (1, 6, 2, 100, 100, 32, True, 32, None),
    (2, 2, 1, 48, 48, 16, True, None, 50.0),
    (1, 4, 4, 33, 70, 8, False, None, None),
    (1, 8, 2, 256, 256, 64, True, 64, 30.0),
    (1, 1, 1, 8, 8, 8, True, None, None),
    (1, 4, 2, 128, 128, 32, True, None, None),
    (1, 2, 2, 64, 64, 32, True, None, None),
)
K7_GEMMA_S = (1, 63, 64, 65, 4097, 5000)
# The bf16 body's edges (phase 3): G query heads per KV head (a CTA takes
# two heads of one KV head, or two 64-row query tiles where G = 1; odd G
# leaves its second warpgroup idle on the last head), S and T on and
# beside the 64-row query tiles, the 128 rows of a G = 1 CTA and the
# 64-key stages, and one long case; hd below, between and at the compiled
# widths (8 runs at width 16, 24 at 32, with zero-filled columns);
# valid_from on and beside the 64- and 128-row edges; windows whose reach
# ends on a key-tile edge (64, 128) and beside one (65).
K7_EDGE_G = (1, 2, 3, 4, 8)
K7_EDGE_S = (63, 64, 65, 127, 128, 129, 4097)
K7_EDGE_HD = (8, 24, 128, 256)
K7_EDGE_ST = ((63, 129), (129, 64), (65, 4097), (4097, 127))  # S != T, not causal
K7_EDGE_VF = ((63, 64), (65, 127), (128, 129))
K7_EDGE_WINDOW = (None, 64, 65, 128)
# The edge cases hold the kernel against its plain version at the kernel's
# own 64-key tiles (attention_plain's kv_block), so that both round p
# against the same running maxima and only the sum order differs.  Against
# the plain version's 1024-key blocks, rows of hd 8 fail the row-rms rule
# by chance: their rms over 8 columns can fall well below the output's
# typical size while the p-rounding error does not (the earlier mma.sync
# body gave the same values and failed the same elements; the plain
# version at 1024 keys was as far from a float64 softmax as the kernel).
K7_TILE_KEYS = 64


def k7_require(name: str, got, want, dtype: str, pad=None, rel: float = 0.0) -> dict:
    """K7 against its plain version within K7_TOL (see there), and in
    bfloat16 within K7_BF16_ABS + ``rel`` of |want| too; pad rows exactly 0.  Returns the max absolute error and, for bfloat16, the
    reading held against the limit: the largest excess over one bf16 step,
    in units of the row's rms."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} != "
                             f"{want.dtype}{tuple(want.shape)}")
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    if pad is not None and bool(pad.any()) and not bool((got[pad] == 0).all()):
        raise AssertionError(f"{name}: a pad row is not 0")
    if not got.numel():
        return {"max_abs_err": 0.0}
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    if dtype == "float32":
        if not err <= K7_TOL[dtype]:
            raise AssertionError(f"{name}: max |err| {err} above {K7_TOL[dtype]}")
        return {"max_abs_err": err}
    big = torch.maximum(g.abs(), w.abs())
    step = torch.where(big > 0, torch.ldexp(torch.ones_like(big), torch.frexp(big)[1] - 8), 0.0)
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    over = diff - step
    bad = over > K7_TOL[dtype] * rms
    row_rel = float((over / torch.where(rms > 0, rms, 1.0)).clamp_min(0).max())
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond "
                             f"{K7_TOL[dtype]} x their row's rms + one bf16 step "
                             f"(largest excess {row_rel} rms; max |err| {err})")
    if not bool((diff <= K7_BF16_ABS + rel * w.abs()).all()):
        raise AssertionError(f"{name}: max |err| {err} above {K7_BF16_ABS} + {rel} |want|")
    return {"max_abs_err": err, "row_rel_err": row_rel,
            "rms": float(w.pow(2).mean().sqrt())}


def check_attention_kernel(device) -> list[dict]:
    """Phase 3, attention half: K7 against its plain version on seeded
    standard-normal operands, float32 and bfloat16 — every case shape of
    tests/test_flash_attention.py, and gemma2-9b's head shape (hd 256, 16
    query heads over 8 KV heads) at S in K7_GEMMA_S, causal and not, with
    and without the 4096 window and the cap 50, through both wrappers; the
    model-layout wrapper with valid_from all 0, mixed, and S - 1."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(20240917)

    def normal(*shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)

    records = []
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for B, H, KV, S, T, hd, causal, window, cap in K7_REF_CASES:
            q, k, v = normal(B, H, S, hd, dtype=dt), normal(B, KV, T, hd, dtype=dt), \
                normal(B, KV, T, hd, dtype=dt)
            kw = dict(causal=causal, window=window, logit_cap=cap)
            err = k7_require(f"K7 {dname} {(B, H, KV, S, T, hd)} {kw}",
                             fa.flash_attention(q, k, v, **kw),
                             fa.flash_attention_plain(q, k, v, **kw), dname)
            records.append({"kernel": "flash_attention", "dtype": dname, "B": B, "H": H,
                            "KV": KV, "S": S, "T": T, "hd": hd, **kw, **err})
        for S in K7_GEMMA_S:
            for window in (None, 4096):
                for cap in (None, 50.0):
                    q, k, v = normal(1, 16, S, 256, dtype=dt), normal(1, 8, S, 256, dtype=dt), \
                        normal(1, 8, S, 256, dtype=dt)
                    for causal in (True, False):
                        kw = dict(causal=causal, window=window, logit_cap=cap)
                        err = k7_require(f"K7 {dname} gemma2 S={S} {kw}",
                                         fa.flash_attention(q, k, v, **kw),
                                         fa.flash_attention_plain(q, k, v, **kw), dname)
                        records.append({"kernel": "flash_attention", "dtype": dname, "B": 1,
                                        "H": 16, "KV": 8, "S": S, "T": S, "hd": 256, **kw,
                                        **err})
                    # the model layout, left pads
                    qm, km, vm = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                    qm, km, vm = (torch.cat([x, x.flip(1)]) for x in (qm, km, vm))  # B = 2
                    for vf_name, vf in (("zero", (0, 0)), ("mixed", (S // 3, 0)),
                                        ("S-1", (S - 1, S - 1))):
                        vf = torch.tensor(vf, device=device, dtype=torch.int32)
                        pos = torch.arange(S, device=device, dtype=torch.int32).expand(2, S)
                        pos = torch.where(pos >= vf[:, None], pos, -1)
                        kw = dict(window=window, logit_cap=cap)
                        err = k7_require(
                            f"K7 {dname} gemma2 blockwise S={S} valid_from={vf.tolist()} {kw}",
                            fa.blockwise_attention(qm, km, vm, valid_from=vf, **kw),
                            fa.attention_plain(qm, km, vm, pos, pos, **kw), dname,
                            pad=pos < 0)
                        records.append({"kernel": "blockwise_attention", "dtype": dname,
                                        "B": 2, "S": S, "hd": 256, "valid_from": vf_name,
                                        **kw, **err})
    return records


def check_attention_edges(device) -> list[dict]:
    """Phase 3, K7's bf16 body at its edges (K7_EDGE_*), every case held to
    the bf16 limits of k7_require against the plain version at the
    kernel's 64-key tiles (K7_TILE_KEYS), and pad rows to exactly 0: the
    kernel's layout causal at every G x S x hd (windows and the cap in turn);
    S != T without causal masking; the model layout (B = 2) with
    valid_from on and beside the tile edges at S = 129 and 4097; and the
    model layout as slices of one fused q/k/v projection (strides that no
    contiguous tensor has).  Operands are seeded standard normals made on
    the card."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(20241018)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    KV = 2
    base = {S: (normal(2, max(K7_EDGE_G) * KV, S, 256), normal(2, KV, S, 256),
                normal(2, KV, S, 256)) for S in K7_EDGE_S}
    records = []

    def plain_tiles(q, k, v, *, causal, window, logit_cap):  # the kernel's layout
        S, T = q.shape[2], k.shape[2]
        return fa.attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            torch.arange(S, device=device), torch.arange(T, device=device), causal=causal,
            window=window, logit_cap=logit_cap, kv_block=K7_TILE_KEYS).transpose(1, 2)

    def check(kernel, name, got, want, pad=None, **case):
        err = k7_require(f"K7 edge {kernel} {name}", got, want, "bfloat16", pad=pad)
        records.append({"kernel": kernel, "dtype": "bfloat16", "edge": True, **case, **err})

    n = 0
    for G in K7_EDGE_G:
        for S in K7_EDGE_S:
            for hd in K7_EDGE_HD:
                qb, kb, vb = base[S]
                q = qb[:1, :G * KV, :, :hd].contiguous()
                k, v = kb[:1, :, :, :hd].contiguous(), vb[:1, :, :, :hd].contiguous()
                kw = dict(causal=True, window=K7_EDGE_WINDOW[n % 4],
                          logit_cap=50.0 if n % 3 else None)
                n += 1
                check("flash_attention", f"G={G} S=T={S} hd={hd} {kw}",
                      fa.flash_attention(q, k, v, **kw), plain_tiles(q, k, v, **kw),
                      G=G, S=S, T=S, hd=hd, **kw)
        for S, T in K7_EDGE_ST:
            hd = K7_EDGE_HD[n % 4]
            q = base[S][0][:1, :G * KV, :, :hd].contiguous()
            k, v = (x[:1, :, :, :hd].contiguous() for x in base[T][1:])
            kw = dict(causal=False, window=None, logit_cap=50.0 if n % 2 else None)
            n += 1
            check("flash_attention", f"G={G} S={S} T={T} hd={hd} {kw}",
                  fa.flash_attention(q, k, v, **kw), plain_tiles(q, k, v, **kw),
                  G=G, S=S, T=T, hd=hd, **kw)
        for S in (129, 4097):
            for vf in K7_EDGE_VF:
                for window in K7_EDGE_WINDOW:
                    hd = (256, 128, 24, 8)[n % 4]
                    qb, kb, vb = base[S]
                    q = qb[:, :G * KV, :, :hd].transpose(1, 2).contiguous()
                    k, v = (x[..., :hd].transpose(1, 2).contiguous() for x in (kb, vb))
                    vft = torch.tensor(vf, device=device, dtype=torch.int32)
                    pos = fa.positions_of(vft, 2, S, device)
                    kw = dict(window=window, logit_cap=50.0 if n % 2 else None)
                    n += 1
                    check("blockwise_attention", f"G={G} S={S} hd={hd} valid_from={vf} {kw}",
                          fa.blockwise_attention(q, k, v, valid_from=vft, **kw),
                          fa.attention_plain(q, k, v, pos, pos, kv_block=K7_TILE_KEYS, **kw),
                          pad=pos < 0, G=G, S=S, hd=hd, valid_from=list(vf), **kw)
            # slices of one fused projection [B, S, (G + 2) KV, 256]: q, k and v
            # keep its row stride and their own offsets
            hd = (256, 24)[S > 129]
            qkv = normal(2, S, (G + 2) * KV, 256)[..., :hd]
            q, k, v = qkv[:, :, :G * KV], qkv[:, :, G * KV:(G + 1) * KV], qkv[:, :, (G + 1) * KV:]
            vft = torch.tensor((64, 0), device=device, dtype=torch.int32)
            pos = fa.positions_of(vft, 2, S, device)
            kw = dict(window=64 if S > 129 else None, logit_cap=50.0)
            check("blockwise_attention", f"fused q/k/v G={G} S={S} hd={hd} {kw}",
                  fa.blockwise_attention(q, k, v, valid_from=vft, **kw),
                  fa.attention_plain(q, k, v, pos, pos, kv_block=K7_TILE_KEYS, **kw),
                  pad=pos < 0, G=G, S=S, hd=hd, valid_from=[64, 0], strides=list(q.stride()),
                  **kw)
    return records


# The kernel bodies whose every instantiation must show no stack and no
# spills in its library's ptxas report, with the number of instantiations:
# K7's bf16 body and K7b's two bf16 passes (one per head-dim width) and
# K1/K2/K3's tensor-core body (per W, map or fused, ICEBERG, CBO).
PTXAS_BODIES = {"flash_fwd_wgmma_kernel": ("attention", 5),
                "bwd_dkdv_wgmma_kernel": ("attention", 5),
                "bwd_dq_wgmma_kernel": ("attention", 5),
                "closure_tc_kernel": ("frontier", 5 * TC_MAX_W)}


def body_ptxas(report: str, kernel: str) -> dict:
    """Registers, stack and spill bytes of each instantiation of the
    template ``kernel`` in an ``nvcc -Xptxas -v`` report, keyed
    ``kernel<template arguments>``."""
    import re

    found = re.findall(rf"Function properties for \S*?{kernel}I(\S*?)EEv\S*\n"
                       r"\s*(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                       r"loads\nptxas info\s*: Used (\d+) registers", report)
    return {f"{kernel}<{','.join(re.findall(r'L[ib](\d+)E', args + 'E'))}>": dict(zip(
        ("stack", "spill_stores", "spill_loads", "registers"), map(int, rest)))
        for args, *rest in found}


def digest(*arrays) -> str:
    """SHA-256 over the dtype, shape and bytes of each array in turn."""
    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def ragged(rows) -> "np.ndarray":
    """A list of id arrays as one int32 array: each row's length, then its ids."""
    import numpy as np

    return np.concatenate([np.asarray([len(r), *r], np.int32) for r in rows] or
                          [np.zeros((0,), np.int32)])


def serve_answers(qe, queries) -> dict:
    """The serve phase's query mix through a query engine (the port's, or
    the reference's when the constants are derived): closures of every
    query, top-k of the first SERVE_TOPK, lookups of the closed intents,
    and the order and extent reads of the first 64 hit ids.  Returns the
    answer arrays by kind."""
    closed, supports, ids = qe.closure_batch(queries)
    tops, top_supports = qe.topk_batch(queries[:SERVE_TOPK], k=SERVE_K)
    hit = ids[ids >= 0][:64]
    out = {"closure": (closed, supports, ids), "topk": (tops, top_supports),
           "lookup": (qe.lookup_batch(closed),)}
    for kind in ("children", "parents", "supers", "subs"):
        out[kind] = (ragged(getattr(qe, kind)(hit)),)
    out["extents"] = (qe.extents_batch(hit),)
    return out


def serve_record(qe, answers) -> dict:
    """What the serve phase holds against the reference."""
    stats = qe.describe()["stats"]
    ids = answers["closure"][2]
    return {"sha256": {kind: digest(*arrays) for kind, arrays in answers.items()},
            "closure_hit_rate": float((ids >= 0).mean()),
            "modeled_comm_bytes": stats["modeled_comm_bytes"],
            "reduce_rounds": stats["reduce_rounds"]}


def rules_answers(qe, index, queries, rank_by: str) -> tuple:
    return qe.rules_batch(index, queries, k=RULES_K, min_conf=RULES_MIN_CONF, rank_by=rank_by)


def basis_digest(basis) -> str:
    combined = basis.combined()
    return digest(combined.premise, combined.added, combined.support, combined.confidence,
                  combined.lift)


def flat(answers: dict) -> list:
    return [a for arrays in answers.values() for a in arrays]


def same_arrays(a, b) -> bool:
    """Two sequences of numpy arrays, equal in dtype, shape and bytes."""
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        for x, y in zip(a, b))


def drive_queries(fn, device):
    """Run ``fn()`` with every launch count set to 0 just before it; returns
    its result, the wall seconds and the counts read just after."""
    import torch

    from repro_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k.__name__: k.launches for k in kernels.KERNELS}


def run_serve_phase(device, intents) -> tuple[dict, dict, dict, dict]:
    """Phase 8: the serving tier at phase 4's context, threshold and intents
    — a ConceptStore on one shard and on k = 8 (rsag), the reference CLI's
    seeded query batch through ``backend="kernel"`` and ``"torch"``; then
    streaming updates on the full lattice of mushroom at scale 0.01.
    Returns the report, the K5 and K1 chunks of the kernel runs, their
    launch counts, and what phase 15 serves under load: the context, the
    stores by k, and the stream phase's context and full lattice; every K1
    launch took the tensor-core body."""
    import numpy as np

    from repro_torch.data import fca_datasets
    from repro_torch.dist import ShardPlan
    from repro_torch.launch.fca import serve_queries
    from repro_torch.query import ConceptStore, QueryConfig, QueryEngine

    ctx, spec = fca_datasets.load("mushroom", scale=1.0)
    queries = serve_queries(ctx, SERVE_QUERIES, np.random.default_rng(0))
    n_batches = {"closure": -(-SERVE_QUERIES // SERVE_SLOTS),
                 "topk": -(-SERVE_TOPK // SERVE_SLOTS)}
    report, stores = {}, {}
    chunks = {"contains_topk": [], "closure": []}
    launches = dict.fromkeys(chunks, 0)

    def answer(qe):
        out = serve_answers(qe, queries)
        check_tensor_body(ctx.W)
        return out

    for k, want in SERVE_EXPECTED.items():
        plan = ShardPlan.simulated(k, reduce_impl="rsag")
        t0 = time.perf_counter()
        store = ConceptStore.build(ctx, intents, plan=plan, device=device)
        build_s = time.perf_counter() - t0
        if store.snapshot.n_concepts != MAIN_EXPECTED["mrganter+"]["concepts"]:
            raise AssertionError(f"serve k={k}: {store.snapshot.n_concepts} concepts")
        stores[k] = store
        answers = {}
        for backend in ("kernel", "torch"):
            qe = QueryEngine(store, QueryConfig(slots=SERVE_SLOTS, backend=backend))
            got, wall, counts = drive_queries(lambda: answer(qe), device)
            rec_got = serve_record(qe, got)
            if rec_got != want:
                raise AssertionError(f"serve k={k} {backend}: {rec_got} != reference {want}")
            answers[backend] = got
            stats = qe.describe()["stats"]
            if backend == "kernel":
                if counts["contains_topk"] != n_batches["topk"] or counts["closure"] != (
                        n_batches["closure"] + n_batches["topk"]):
                    raise AssertionError(f"serve k={k}: launches {counts} for {n_batches}")
                if counts["rules_topk"] or counts["fused_step"] or counts["map_closure"]:
                    raise AssertionError(f"serve k={k}: stray launches {counts}")
                again, captured = capture_launches(tuple(chunks), lambda: answer(qe))
                check_captured(f"serve k={k}", captured, counts)
                if not same_arrays(flat(again), flat(got)):
                    raise AssertionError(f"serve k={k}: the captured run answered otherwise")
                for kname in chunks:
                    chunks[kname] += [(f"serve k={k}", args, kw)
                                      for args, kw in captured[kname]]
                    launches[kname] += counts[kname]
            elif any(counts.values()):
                raise AssertionError(f"serve k={k}: the torch backend launched {counts}")
            report[f"k={k}/{backend}"] = {"wall_s": wall, "launches": counts,
                                          "micro_batches": stats["micro_batches"],
                                          "store_build_s": build_s, **rec_got}
        for kind in answers["kernel"]:
            if not same_arrays(answers["kernel"][kind], answers["torch"][kind]):
                raise AssertionError(f"serve k={k}: {kind} differs between the backends")
    emit({"phase": "serve", "dataset": spec.name, "objects": ctx.n_objects,
          "min_support": MAIN_MIN_SUPPORT, "queries": SERVE_QUERIES, "topk": SERVE_TOPK,
          "slots": SERVE_SLOTS, "runs": report})
    report["stream"], stream = run_stream(device)
    return report, chunks, launches, {"ctx": ctx, "stores": stores, "stream": stream}


def run_stream(device) -> tuple[dict, tuple]:
    """The streaming update on a full-lattice store (the reference skips
    updates on iceberg stores): mushroom at scale 0.01, 8 seeded rows
    staged and committed at k = 1 and k = 8.  Returns the report and the
    context with its full lattice (the intents before any update)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import ClosureEngine, bitset, mrcbo
    from repro_torch.data import fca_datasets
    from repro_torch.dist import ShardPlan
    from repro_torch.launch.fca import serve_queries
    from repro_torch.query import ConceptStore, QueryConfig, QueryEngine, StreamUpdater

    ctx, spec = fca_datasets.load("mushroom", scale=0.01)
    intents = mrcbo(ctx, ClosureEngine(ctx, device=device)).intents
    out = {}
    for k in (1, 8):
        store = ConceptStore.build(ctx, intents, plan=ShardPlan.simulated(k), device=device)
        qe = QueryEngine(store, QueryConfig(slots=SERVE_SLOTS, backend="kernel"))
        kernels.reset_launches()
        rng = np.random.default_rng(0)
        closed = qe.closure_batch(serve_queries(ctx, 256, rng))[0]
        rows = bitset.pack_bool(rng.random((STREAM_ROWS, ctx.n_attrs)) < max(0.05, spec.density),
                                ctx.W)
        upd = StreamUpdater(store)
        t0 = time.perf_counter()
        receipt = upd.stage(rows)
        upd.commit()
        wall = time.perf_counter() - t0
        post = qe.lookup_batch(closed)
        check_tensor_body(ctx.W)
        got = {"n_concepts_before": receipt.n_concepts_before,
               "n_concepts_after": receipt.n_concepts_after,
               "version": store.snapshot.version,
               "post_update_hit_rate": float((post >= 0).mean()),
               "intents_sha256": digest(store.snapshot.intents_np)}
        if got != STREAM_EXPECTED:
            raise AssertionError(f"stream k={k}: {got} != reference {STREAM_EXPECTED}")
        out[f"k={k}"] = dict(got, stage_commit_s=wall)
    emit({"phase": "stream", "dataset": spec.name, "objects": ctx.n_objects,
          "rows": STREAM_ROWS, "runs": out})
    return out, (ctx, intents)


def run_rules_phase(device) -> tuple[dict, dict, int, tuple]:
    """Phase 9: the rules tier — full-scale mushroom mined at
    ``min_support=812`` on a k = 8 rsag plan, both bases extracted at
    ``min_conf=0.5``, the rule index, and the CLI's seeded rule-query mix
    through ``backend="kernel"`` and ``"torch"`` for both rank metrics.
    Returns the report, the K6 chunks of the kernel runs, their launch
    count, and the store and rule index phase 15 serves under load."""
    import numpy as np

    from repro_torch.core import ClosureEngine, mrganter_plus
    from repro_torch.data import fca_datasets
    from repro_torch.query import ConceptStore, QueryConfig, QueryEngine
    from repro_torch.rules import RuleIndex, extract_bases, rule_query_mix

    ctx, spec = fca_datasets.load("mushroom", scale=1.0)
    eng = ClosureEngine(ctx, n_parts=8, reduce_impl="rsag", backend="kernel", device=device)
    res = mrganter_plus(ctx, eng, local_prune=True, min_support=RULES_MIN_SUPPORT)
    if res.n_concepts != RULES_EXPECTED["concepts"]:
        raise AssertionError(f"rules: {res.n_concepts} concepts != {RULES_EXPECTED['concepts']}")
    store = ConceptStore.build(ctx, res.intents, plan=eng.plan, device=device)
    t0 = time.perf_counter()
    basis = extract_bases(store, min_conf=RULES_MIN_CONF)
    index = RuleIndex.build(basis, plan=eng.plan, device=device)
    basis_s = time.perf_counter() - t0
    got = {"implications": basis.n_implications, "partial": basis.n_partial,
           "basis_sha256": basis_digest(basis)}
    want = {k: RULES_EXPECTED[k] for k in got}
    if got != want:
        raise AssertionError(f"rules: {got} != reference {want}")
    queries = rule_query_mix(ctx, index, RULES_QUERIES, np.random.default_rng(0))
    n_batches = -(-RULES_QUERIES // SERVE_SLOTS)
    report, chunks, launches = {}, [], 0
    for rank_by in ("confidence", "lift"):
        answers = {}
        for backend in ("kernel", "torch"):
            qe = QueryEngine(store, QueryConfig(slots=SERVE_SLOTS, backend=backend))
            out, wall, counts = drive_queries(
                lambda: rules_answers(qe, index, queries, rank_by), device)
            sha = digest(*out)
            if sha != RULES_EXPECTED["answers_sha256"][rank_by]:
                raise AssertionError(f"rules {rank_by} {backend}: answers differ from the "
                                     "reference's")
            answers[backend] = out
            if backend == "kernel":
                if counts["rules_topk"] != n_batches or counts["contains_topk"]:
                    raise AssertionError(f"rules {rank_by}: launches {counts}, "
                                         f"{n_batches} micro-batches")
                again, captured = capture_launches(
                    ("rules_topk",), lambda: rules_answers(qe, index, queries, rank_by))
                check_captured(f"rules {rank_by}", captured, counts)
                if not same_arrays(again, out):
                    raise AssertionError(f"rules {rank_by}: the captured run answered otherwise")
                chunks += [(f"rules {rank_by}", args, kw) for args, kw in captured["rules_topk"]]
                launches += counts["rules_topk"]
            elif any(counts.values()):
                raise AssertionError(f"rules {rank_by}: the torch backend launched {counts}")
            report[f"{rank_by}/{backend}"] = {
                "wall_s": wall, "launches": counts, "sha256": sha,
                "hit_rate": float((out[0][:, 0] >= 0).mean())}
        if not same_arrays(answers["kernel"], answers["torch"]):
            raise AssertionError(f"rules {rank_by}: answers differ between the backends")
    emit({"phase": "rules", "dataset": spec.name, "objects": ctx.n_objects,
          "min_support": RULES_MIN_SUPPORT, "min_conf": RULES_MIN_CONF, "n_parts": 8,
          "reduce_impl": "rsag", "concepts": res.n_concepts, **got,
          "basis_extract_s": basis_s, "queries": RULES_QUERIES, "runs": report})
    return report, {"rules_topk": chunks}, launches, (store, index)


def record_tickets(queue) -> list:
    """Wrap ``queue.submit`` so that every ticket is kept, in submission
    order; returns the list it fills."""
    tickets = []
    submit = queue.submit

    def record(*args, **kw):
        ticket = submit(*args, **kw)
        tickets.append(ticket)
        return ticket

    queue.submit = record
    return tickets


def result_parts(result) -> list:
    """A ticket's answer as contiguous numpy arrays (none when shed)."""
    import numpy as np

    if result is None:
        return []
    return [np.ascontiguousarray(p) for p in (result if isinstance(result, tuple) else (result,))]


def tickets_digest(tickets) -> str:
    """SHA-256 over every ticket in turn: its kind, whether it was shed, and
    the dtype, shape and bytes of each array of its answer."""
    h = hashlib.sha256()
    for t in tickets:
        h.update(f"{t.kind} {int(t.shed)};".encode())
        for p in result_parts(t.result):
            h.update(f"{p.dtype}{p.shape}".encode())
            h.update(p.tobytes())
    return h.hexdigest()


def virtual_load(serve_mod, ctx, engine, run: str, *, rules_index=None, updater=None,
                 prepare=None):
    """One virtual-clock run of phase 15 through a serve package (the
    port's, or the reference's when LOAD_EXPECTED is derived, ``prepare``
    then repairing its queue): ``LOAD_VIRTUAL[run]``'s seeded arrivals and
    workload, the queue at AdmissionConfig's defaults, ``run_load`` on a
    clock from 0 that only its sleep advances.  Returns the report and the
    tickets in submission order."""
    import numpy as np

    _, name, qps, seconds, kw, mix = LOAD_VIRTUAL[run]
    rng = np.random.default_rng(LOAD_SEED)
    arrivals = serve_mod.ARRIVALS[name](qps, seconds, rng, **kw)
    events = serve_mod.make_workload(ctx, len(arrivals), rng, mix=mix,
                                     update_rows=LOAD_UPDATE_ROWS)
    t = [0.0]

    def clock():
        return t[0]

    def sleep(s):
        t[0] += s

    queue = serve_mod.AdmissionQueue(engine, serve_mod.AdmissionConfig(),
                                     rules_index=rules_index, clock=clock)
    if prepare is not None:
        prepare(queue)
    tickets = record_tickets(queue)
    rep = serve_mod.run_load(queue, arrivals, events, updater=updater, clock=clock, sleep=sleep)
    return rep, tickets


def load_record(rep, tickets) -> dict:
    """What a virtual-clock run holds against the reference."""
    return {"submitted": rep.submitted, "admitted": rep.admitted, "shed": rep.shed,
            "completed": rep.completed, "dispatches": rep.dispatches,
            "dispatch_causes": dict(rep.dispatch_causes), "occupancy_mean": rep.occupancy_mean,
            "by_kind": dict(rep.by_kind), "updates": rep.updates,
            "e2e": dict(rep.e2e), "admission_wait": dict(rep.admission_wait),
            "answers_sha256": tickets_digest(tickets)}


def check_load_accounting(name: str, rep, queue) -> None:
    """submitted == admitted + shed, completed == admitted, and one e2e and
    one admission-wait observation per completion."""
    st = queue.stats
    counts = {kind: st.registry.histogram("latency_s", kind=kind).count
              for kind in ("e2e", "admission_wait")}
    if (rep.submitted != rep.admitted + rep.shed or rep.completed != rep.admitted
            or counts != {"e2e": rep.completed, "admission_wait": rep.completed}
            or (rep.completed and rep.e2e["count"] != rep.completed)):
        raise AssertionError(f"load {name}: submitted {rep.submitted}, admitted "
                             f"{rep.admitted}, shed {rep.shed}, completed {rep.completed}, "
                             f"histogram counts {counts}")


def check_preformed(name: str, qe, tickets, cfg, rules_index=None) -> int:
    """Every answered ticket equals the row of a pre-formed ``*_batch`` call
    on the same queries against the same snapshot; every admitted ticket
    was answered.  Returns the number of tickets checked."""
    import numpy as np

    done = [t for t in tickets if not t.shed]
    if any(t.result is None for t in done):
        raise AssertionError(f"load {name}: an admitted ticket was never answered")
    for kind in ("closure", "topk", "lookup", "rules"):
        ts = [t for t in done if t.kind == kind]
        if not ts:
            continue
        arr = np.stack([t.payload for t in ts])
        if kind == "closure":
            want = list(zip(*qe.closure_batch(arr)))
        elif kind == "topk":
            want = list(zip(*qe.topk_batch(arr, k=cfg.topk_k)))
        elif kind == "lookup":
            want = list(qe.lookup_batch(arr))
        else:
            want = list(zip(*qe.rules_batch(rules_index, arr, k=cfg.rules_k,
                                            min_conf=cfg.rules_min_conf,
                                            rank_by=cfg.rules_rank_by)))
        for t, w in zip(ts, want):
            if not same_arrays(result_parts(t.result), result_parts(w)):
                raise AssertionError(f"load {name}: a {kind} ticket differs from its "
                                     "pre-formed batch")
    return len(done)


def load_view(rep) -> dict:
    """The numbers a timed load run prints."""
    return {"offered_qps": rep.offered_qps, "achieved_qps": rep.achieved_qps,
            "wall_s": rep.wall_s, "submitted": rep.submitted, "admitted": rep.admitted,
            "shed": rep.shed, "shed_rate": rep.shed_rate, "completed": rep.completed,
            "dispatches": rep.dispatches, "dispatch_causes": dict(rep.dispatch_causes),
            "occupancy_mean": rep.occupancy_mean, "e2e": dict(rep.e2e),
            "admission_wait": dict(rep.admission_wait), "max_lag_s": rep.max_lag_s,
            "slo": dict(rep.slo)}


def run_load_phase(device, served: dict, rules_served: tuple) -> tuple[dict, dict]:
    """Phase 15: the serving tier under load, ``backend="kernel"``, slots 64.
    The virtual-clock runs against LOAD_EXPECTED; the timed runs of
    ``LOAD_WALL`` (every ticket equal to its pre-formed batch, the
    accounting held, a ``MetricsServer`` scraped once from another thread
    during the first); the dispatcher thread; the reference's
    concurrent-commit scenario; the ``fca serve --load-qps`` CLI.  Every
    run's launch counts are set to 0 just before it and read just after:
    K1 launched in every run, K5 in every run whose mix holds top-k, K6 in
    every run whose mix holds rules, and none where the mix does not.
    Returns the report and the summed K1/K5/K6 launches of the runs."""
    import os
    import threading
    import urllib.request

    import numpy as np
    import torch

    from repro_torch import kernels, serve
    from repro_torch.core import bitset
    from repro_torch.dist import ShardPlan
    from repro_torch.launch.fca import serve_queries
    from repro_torch.obs import SLO, MetricsServer, parse_openmetrics
    from repro_torch.query import ConceptStore, QueryConfig, QueryEngine, StreamUpdater

    ctx, stores = served["ctx"], served["stores"]
    sctx, sintents = served["stream"]
    rules_store, rules_index = rules_served
    launches = dict.fromkeys(LOAD_KERNELS, 0)
    report = {"virtual": {}, "wall": {}}

    def engine(store, slots=SERVE_SLOTS):
        return QueryEngine(store, QueryConfig(slots=slots, backend="kernel"))

    def engine_s(qe) -> float:
        """Seconds the engine spent in its micro-batches (host clock from
        the batch's entry to its outputs on the host): the sum of its
        ``service_s`` histograms."""
        return sum(h.sum for name, _, series in qe.stats.registry.families()
                   if name == "service_s" for _, h in series)

    def counted(name: str, kinds, fn):
        """``fn()`` with every launch count at 0 before it, read after it
        and held against the kinds the run serves."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k.__name__: k.launches for k in kernels.KERNELS}
        check_tensor_body(ctx.W)
        need = {"closure": bool(kinds & {"closure", "topk"}),
                "contains_topk": "topk" in kinds, "rules_topk": "rules" in kinds}
        wrong = {k: n for k, n in counts.items() if bool(n) != need.get(k, False)}
        if wrong:
            raise AssertionError(f"load {name}: launches {counts} for the kinds {sorted(kinds)}")
        for k in launches:
            launches[k] += counts[k]
        return out, wall, {k: counts[k] for k in LOAD_KERNELS}

    # -- the virtual-clock runs against the reference ------------------------
    for run, (source, *_, mix) in LOAD_VIRTUAL.items():
        kinds = set(mix or serve.DEFAULT_MIX) - {"update"}
        run_ctx, index, updater = ctx, None, None
        if source == "serve":
            store = stores[int(run.split("k=")[1])]
        elif source == "rules":
            store, index = rules_store, rules_index
        else:
            run_ctx = sctx
            store = ConceptStore.build(sctx, sintents, plan=ShardPlan.simulated(8),
                                       device=device)
            updater = StreamUpdater(store)
        qe = engine(store)
        (rep, tickets), wall, counts = counted(run, kinds, lambda: virtual_load(
            serve, run_ctx, qe, run, rules_index=index, updater=updater))
        got = load_record(rep, tickets)
        if updater is not None:
            got.update(version=store.snapshot.version,
                       intents_sha256=digest(store.snapshot.intents_np))
        want = LOAD_EXPECTED[run]
        if got != want:
            diff = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                    if got.get(k) != want.get(k)}
            raise AssertionError(f"load {run}: differs from the reference: {diff}")
        report["virtual"][run] = {"host_wall_s": wall, "engine_s": engine_s(qe),
                                  "launches": counts, "dispatches": rep.dispatches,
                                  "updates": rep.updates}

    # -- wall-clock runs -----------------------------------------------------
    cfg = serve.AdmissionConfig()
    kinds = set(serve.DEFAULT_MIX)
    for run, (k, name, qps, seconds, kw) in LOAD_WALL.items():
        qe = engine(stores[k])
        rng = np.random.default_rng(LOAD_SEED + 1)
        arrivals = serve.ARRIVALS[name](qps, seconds, rng, **kw)
        events = serve.make_workload(ctx, len(arrivals), rng)
        queue = serve.AdmissionQueue(qe, cfg)
        tickets = record_tickets(queue)
        server, scraped, scraper = None, [], None
        if run == "poisson k=1":
            server = MetricsServer(lambda: queue.registry, port=0)

            def scrape():
                time.sleep(seconds / 3)
                with urllib.request.urlopen(server.url, timeout=30) as resp:
                    scraped.append(resp.read().decode())

            scraper = threading.Thread(target=scrape, name="chip-smoke-scrape")
            scraper.start()
        try:
            with gc_pauses() as paused:
                rep, wall, counts = counted(run, kinds, lambda: serve.run_load(
                    queue, arrivals, events, slo=SLO()))
        finally:
            if scraper is not None:
                scraper.join(timeout=60)
            if server is not None:
                server.close()
        busy = engine_s(qe)
        check_load_accounting(run, rep, queue)
        checked = check_preformed(run, qe, tickets, cfg)
        rec = {"launches": counts, "gc_ms": paused, "checked": checked, "engine_s": busy,
               **load_view(rep)}
        if server is not None:
            if not scraped:
                raise AssertionError(f"load {run}: the /metrics scrape returned nothing")
            fams = parse_openmetrics(scraped[0])
            missing = {"serve_queue_depth", "serve_e2e_seconds", "service_seconds"} - set(fams)
            if missing:
                raise AssertionError(f"load {run}: the scrape lacks {sorted(missing)}")
            rec["scrape"] = {"families": len(fams), "bytes": len(scraped[0])}
        report["wall"][run] = rec
        emit({"phase": "load_run", "run": run, "n_parts": k, "arrival": name, **rec})

    # -- the dispatcher thread -----------------------------------------------
    qe = engine(stores[1])
    queue = serve.AdmissionQueue(qe, cfg)
    events = serve.make_workload(ctx, LOAD_THREAD_QUERIES, np.random.default_rng(LOAD_SEED + 2),
                                 mix={"closure": 0.5, "topk": 0.5})

    def threaded():
        tickets = []
        queue.start()
        t0 = time.perf_counter()
        try:
            for i, (kind, payload) in enumerate(events):
                delay = t0 + i / LOAD_THREAD_QPS - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                tickets.append(queue.submit(kind, payload))
        finally:
            queue.stop(drain=True)
        return tickets

    tickets, wall, counts = counted("thread", {"closure", "topk"}, threaded)
    if not all(t.done and not t.shed for t in tickets) or queue.stats.completed != len(events):
        raise AssertionError(f"load thread: {queue.stats.completed} of {len(events)} completed")
    check_preformed("thread", qe, tickets, cfg)
    report["thread"] = {"submissions": len(events), "wall_s": wall, "launches": counts,
                        "dispatch_causes": dict(queue.stats.dispatch_causes),
                        "occupancy_mean": round(queue.stats.occupancy_mean, 4)}

    # -- the reference's concurrent-commit scenario --------------------------
    store = ConceptStore.build(sctx, sintents, plan=ShardPlan.simulated(8), device=device)
    qe = engine(store, slots=4)
    queue = serve.AdmissionQueue(qe, serve.AdmissionConfig(max_wait_s=0.0005))
    updater = StreamUpdater(store)
    v0, n_commits, n = store.snapshot.version, 4, 64
    errs = []

    def churn():
        rng = np.random.default_rng(13)
        try:
            for _ in range(n_commits):
                updater.apply(bitset.pack_bool(rng.random((2, sctx.n_attrs)) < 0.3, sctx.W))
        except Exception as e:  # noqa: BLE001 - raised again below
            errs.append(e)

    def racing():
        th = threading.Thread(target=churn, name="chip-smoke-churn")
        th.start()
        tickets = [queue.submit("closure", q)
                   for q in serve_queries(sctx, n, np.random.default_rng(14))]
        while queue.pending():
            queue.poll()
        queue.flush()
        th.join(timeout=120)
        if th.is_alive() or errs:
            raise AssertionError(f"load commits: the commit thread {errs or 'hung'}")
        return tickets

    tickets, wall, counts = counted("commits", {"closure"}, racing)
    st = queue.stats
    hists = (st.registry.histogram("latency_s", kind="e2e").count,
             st.registry.histogram("latency_s", kind="admission_wait").count,
             queue.registry.histogram("serve_e2e_s", kind="closure").count)
    if (st.admitted, st.completed, st.shed, hists) != (n, n, 0, (n, n, n)) or not all(
            t.done and t.result is not None for t in tickets):
        raise AssertionError(f"load commits: admitted {st.admitted}, completed "
                             f"{st.completed}, histogram counts {hists} for {n} tickets")
    if store.snapshot.version != v0 + n_commits:
        raise AssertionError(f"load commits: version {store.snapshot.version}")
    after = serve_queries(sctx, 4, np.random.default_rng(15))
    post = [queue.submit("closure", q) for q in after]
    queue.flush()
    check_preformed("commits", qe, post, queue.cfg)
    report["commits"] = {"tickets": n, "commits": n_commits, "wall_s": wall,
                         "version": store.snapshot.version,
                         "concepts": store.snapshot.n_concepts, "launches": counts}

    # -- the CLI -------------------------------------------------------------
    dump = ROOT / "build" / "load_metrics.txt"
    dump.parent.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.fca", "serve", "--dataset", "mushroom",
           "--scale", "1.0", "--min-support", str(MAIN_MIN_SUPPORT), "--parts", "8",
           "--load-qps", "1000", "--load-seconds", "2", "--metrics-dump", str(dump)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    cli_s = time.perf_counter() - t0
    if out.returncode:
        raise AssertionError(f"fca serve --load-qps exited {out.returncode}: {out.stderr[-2000:]}")
    got = json.loads(out.stdout)["serve_load"]
    if sorted(got) != LOAD_KEYS or got["completed"] != got["admitted"]:
        raise AssertionError(f"fca serve --load-qps: keys {sorted(got)}, completed "
                             f"{got['completed']} of {got['admitted']} admitted")
    check = subprocess.run([sys.executable, "-m", "repro_torch.obs.export", str(dump)],
                           capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    dump.unlink()
    if check.returncode:
        raise AssertionError(f"the --metrics-dump exposition does not parse: {check.stderr}")
    report["cli"] = {"seconds": cli_s, "exposition": json.loads(check.stdout),
                     **{k: got[k] for k in ("achieved_qps", "completed", "shed_rate",
                                            "dispatch_causes", "occupancy_mean", "e2e")}}
    emit({"phase": "load", "dataset": "mushroom", "slots": SERVE_SLOTS,
          "max_wait_s": cfg.max_wait_s, "depth": cfg.depth, "virtual": report["virtual"],
          "thread": report["thread"], "commits": report["commits"], "cli": report["cli"],
          "launches": launches})
    return report, launches


def lm_reduced_prompts(vocab: int, n_long: int = 40) -> list:
    """The reference CLI's default prompts ("1,2,3;4,5,6,7", as its parser
    reads them), one seeded prompt of ``n_long`` tokens, past the reduced
    window, and four holding ids outside [0, vocab) (V, V + 5, -1, -V, -V -
    3), which the reference's embedding gather maps into the table."""
    import numpy as np

    cli = [[t % vocab for t in chunk] for chunk in ((1, 2, 3), (4, 5, 6, 7))]
    long = np.random.default_rng(LM_SEED + 1).integers(0, vocab, size=n_long).tolist()
    V = vocab
    return cli + [long, [V, 1], [V + 5, -1, 3], [-V, 7], [-V - 3, 9, 2]]


def lm_prompts_for(arch: str, vocab: int) -> list:
    """Phase 10's prompts for one arch: mamba2's long prompt is 64 tokens,
    two of its reduced chunks of 32 (the reference refuses a 40-token
    prefill there: ``L=40 must be divisible by chunk=32``)."""
    return lm_reduced_prompts(vocab, LM_REDUCED_LONG.get(arch, 40))


def attention_layers(cfg) -> int:
    """The attention layers of a config: K7's launches per prefill."""
    kinds = cfg.layer_pattern * cfg.n_periods + cfg.tail_pattern
    return sum(k.startswith("attn") for k in kinds)


def k7_launches() -> int:
    from repro_torch.kernels import flash_attention as fa

    return fa.flash_attention.launches + fa.blockwise_attention.launches


def run_lm_reduced(device) -> tuple[dict, int]:
    """Phase 10: the reduced LM configs through the port's ServeEngine on the
    card (K7 on every attention layer of the prefill), on the numpy weights
    the reference was given: the reference's greedy tokens exactly.
    Returns the report and K7's launches over the phase."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.interop import numpy_params, params_from_jax
    from repro_torch.models.transformer import Decoder
    from repro_torch.serve import ServeConfig, ServeEngine

    report = {}
    total = 0
    for arch in LM_REDUCED_ARCHS:
        cfg = get_config(arch).reduced()
        model = Decoder(cfg, device=device, seed=None)
        model.load_state_dict(params_from_jax(numpy_params(cfg, LM_SEED), cfg))
        prompts = lm_prompts_for(arch, cfg.vocab_size)
        eng = ServeEngine(cfg, model, ServeConfig(max_len=LM_REDUCED_MAX_LEN,
                                                  batch_slots=max(4, len(prompts))))
        kernels.reset_launches()
        got = eng.generate(prompts, LM_MAX_NEW)
        torch.cuda.synchronize()
        launches = k7_launches()
        total += launches
        if got != LM_REDUCED_EXPECTED[arch]:
            raise AssertionError(f"{arch} reduced: tokens {got} != the reference's "
                                 f"{LM_REDUCED_EXPECTED[arch]}")
        if launches != attention_layers(cfg):
            raise AssertionError(f"{arch} reduced: K7 launched {launches} times in one "
                                 f"prefill of {attention_layers(cfg)} attention layers")
        report[arch] = {"tokens_equal_reference": True, "k7_launches": launches,
                        "layers": cfg.n_layers, "prompt_lens": [len(p) for p in prompts]}
    emit({"phase": "lm_reduced", "runs": report})
    return report, total


def attention_pairs(S: int, valid_from, window) -> int:
    """Valid (query, key) pairs of one head of a causal self-attention over
    S positions, per row of ``valid_from``, with an optional window: what
    the chunk's data needs."""
    total = 0
    for vf in valid_from:
        n = S - vf  # real rows i = vf .. S-1 see keys j = vf .. i
        if window is None or window >= n:
            total += n * (n + 1) // 2
        else:  # row r (0-based) sees min(r + 1, window) keys
            total += window * (window + 1) // 2 + (n - window) * window
    return total


# Head shapes at full width of two configs the repo supports
# (src/repro/configs) that take the bf16 body's other branches: G = 1, a
# CTA on two consecutive 64-row query tiles of one head, and odd G, the
# second warpgroup idle on the last head of each KV group.
K7_GROUPINGS = (("codeqwen1.5-7b", 32, 32, 128), ("deepseek-coder-33b", 56, 8, 128))


def time_attention_groupings(B: int, S: int) -> list:
    """K7 and scaled_dot_product_attention on causal, cap-free, pad-free
    chunks of ``K7_GROUPINGS``' head shapes at B rows of S positions
    (seeded normal q, k, v on the card), each with its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for arch, H, KV, hd in K7_GROUPINGS:
        q, k, v = (torch.randn(B, h, S, hd, generator=gen, device="cuda", dtype=torch.bfloat16)
                   for h in (H, KV, KV))
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        k7 = lambda: fa.flash_attention(q, k, v, causal=True)
        err = k7_require(f"K7 against scaled_dot_product_attention ({arch} heads)", k7(), lib(),
                         "bfloat16", rel=K7_MODEL_REL)
        library_ms = cuda_time_ms(lib, reps=10)
        ms = cuda_time_ms(k7, reps=10)
        pairs = B * H * attention_pairs(S, [0], None)
        bound_ms = max(4 * hd * pairs / BF16_FLOPS_PER_S,
                       (2 * q.numel() + k.numel() + v.numel()) * 2 / HBM_BYTES_PER_S) * 1e3
        out.append({"arch": arch, "B": B, "S": S, "H": H, "KV": KV, "G": H // KV, "hd": hd,
                    "pairs": pairs, "k7_ms": ms, "library_ms": library_ms, "bound_ms": bound_ms,
                    "bound_share": bound_ms / ms, "k7_over_library": ms / library_ms,
                    "k7_vs_sdpa_max_abs_err": err})
        del q, k, v
    return out


def k7_chunk_report(chunks: list, library: bool = True) -> dict:
    """K7 on the chunks one full-width prefill gave it: each replayed alone,
    the costliest beside its plain version and its bound.  With
    ``library``, ``library_ms`` is scaled_dot_product_attention on the
    costliest chunk without a window (a global layer) with the cap removed
    and no pads, beside K7 on that same cap-free chunk, so both compute one
    function (``library_chunk``); else ``library_ms`` is None."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    timed = []
    for n, ((q, k, v), kw) in enumerate(chunks):
        ms = cuda_time_ms(lambda: fa.blockwise_attention(q, k, v, **kw), reps=3, warmup=1)
        timed.append((ms, n))
    ms_all = sum(t[0] for t in timed)
    _, n = max(timed)
    (q, k, v), kw = chunks[n]
    B, S, H, hd = q.shape
    pos = fa.positions_of(kw["valid_from"], B, S, q.device)
    plain_kw = dict(window=kw["window"], logit_cap=kw["logit_cap"])
    ms = cuda_time_ms(lambda: fa.blockwise_attention(q, k, v, **kw), reps=10)
    got = fa.blockwise_attention(q, k, v, **kw)
    want = fa.attention_plain(q, k, v, pos, pos, **plain_kw)
    err = k7_require("K7 on its costliest main-path chunk", got, want, "bfloat16",
                     pad=pos < 0, rel=K7_MODEL_REL)
    plain_ms = cuda_time_ms(lambda: fa.attention_plain(q, k, v, pos, pos, **plain_kw), reps=3,
                            warmup=1)
    vf = kw["valid_from"].tolist()
    pairs = H * attention_pairs(S, vf, kw["window"])
    t_ops = 4 * hd * pairs / BF16_FLOPS_PER_S * 1e3
    t_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    out = {"max_abs_err": err["max_abs_err"], "row_rel_err": err["row_rel_err"], "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
           "bound_share": bound_ms / ms,
           "chunk": {"layer": n, "B": B, "S": S, "H": H, "KV": k.shape[2], "hd": hd,
                     "valid_from": vf, **plain_kw, "pairs": pairs},
           "run_launches": len(chunks), "run_ms": ms_all}
    if not library:
        return out
    # the cap-free, pad-free global chunk: K7 and SDPA on one function
    g = next(i for _, i in sorted(timed, reverse=True) if chunks[i][1]["window"] is None)
    (gq, gk, gv), _ = chunks[g]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (gq, gk, gv))
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    k7 = lambda: fa.flash_attention(qt, kt, vt, causal=True)
    lib_err = k7_require("K7 against scaled_dot_product_attention (cap-free chunk)",
                         k7(), lib(), "bfloat16", rel=K7_MODEL_REL)
    library_ms = cuda_time_ms(lib, reps=10)
    k7_free_ms = cuda_time_ms(k7, reps=10)
    free_pairs = qt.shape[0] * qt.shape[1] * attention_pairs(S, [0], None)
    free_bound_ms = max(4 * hd * free_pairs / BF16_FLOPS_PER_S * 1e3, t_bytes)
    out["library_ms"] = library_ms
    out["library_chunk"] = {"layer": g, "cap": None, "valid_from": [0] * qt.shape[0],
                            "k7_ms": k7_free_ms, "pairs": free_pairs,
                            "bound_ms": free_bound_ms, "bound_share": free_bound_ms / k7_free_ms,
                            "k7_over_library": k7_free_ms / library_ms,
                            "k7_vs_sdpa_max_abs_err": lib_err}
    return out


def time_attention(chunks: list, launches: int) -> dict:
    """K7's record of the kernels line from the chunks phase 11's prefill
    gave it (``k7_chunk_report``), with ``groupings``: the same comparison
    with SDPA at the G = 1 and odd-G head shapes of ``K7_GROUPINGS``, at the
    costliest chunk's B and S."""
    report = k7_chunk_report(chunks)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:109", "launches": launches,
            **report,
            "groupings": time_attention_groupings(report["chunk"]["B"],
                                                  report["chunk"]["S"])}


@contextlib.contextmanager
def plain_attention():
    """K7's model-layout wrapper swapped for its plain version while the
    block runs (the model calls the wrapper by its module-level name)."""
    from repro_torch.kernels import flash_attention as fa

    real = fa.blockwise_attention
    def plain(q, k, v, *, valid_from=None, **kw):
        pos = fa.positions_of(valid_from, q.shape[0], q.shape[1], q.device)
        return fa.attention_plain(q, k, v, pos, pos, **kw)

    fa.blockwise_attention = plain
    try:
        yield
    finally:
        fa.blockwise_attention = real


def decode_profile(model, prompts, steps: int = 3) -> dict:
    """Where a warm decode step's device time goes: the engine's left-padded
    prefill and one warm-up step, then ``steps`` decode steps under
    torch.profiler (CPU and CUDA activities).  Returns the device-busy
    milliseconds per step (the sum of the kernels' times) and the kernels
    with the most of it; against the engine's host-clock step time it gives
    the card's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import left_pad

    toks, vf = left_pad(prompts, len(prompts))
    plen = toks.shape[1]
    with torch.inference_mode():
        caches = model.init_caches(len(prompts), LM_FULL_MAX_LEN)
        logits, caches = model.prefill(torch.from_numpy(toks).to(model.device), caches,
                                       torch.from_numpy(vf).to(model.device))
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        logits, caches = model.decode_step(tok, plen, caches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for step in range(1, steps + 1):
                logits, caches = model.decode_step(tok, plen + step, caches)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return {"device_ms_per_step": busy_us / 1e3 / steps,
            "top_kernels_ms_per_step": {e.key[:80]: e.self_device_time_total / 1e3 / steps
                                        for e in top},
            "kernel_launches_per_step": sum(e.count for e in kernels) / steps}


def family_run(eng, prompts, *, plain: bool = False) -> dict:
    """One ServeEngine.generate of phases 11 and 17 (K7, or its plain version when
    ``plain``), counted from 0: tokens, K7 launches, host-clock prefill and
    decode times, peak memory, the prefill logits and each step's top-2."""
    import torch

    from repro_torch import kernels

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with plain_attention() if plain else contextlib.nullcontext():
        out = eng.generate(prompts, LM_MAX_NEW)
    torch.cuda.synchronize()
    st = eng.stats
    return {"tokens": out, "launches": k7_launches(), "prefill_ms": st.prefill_s * 1e3,
            "decode_ms": [x * 1e3 for x in st.decode_s],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "logits": st.prefill_logits, "top2": [t.float().cpu() for t in st.top2]}


def agree_until(kernel: dict, plain: dict, tol: float, name: str) -> list:
    """Per slot, the first step whose plain top-2 margin is under ``tol``;
    the kernel run's tokens must equal the plain run's before it."""
    out = []
    for slot in range(len(kernel["tokens"])):
        margins = [float(t[slot, 0] - t[slot, 1]) for t in plain["top2"]]
        close = next((i for i, m in enumerate(margins[:LM_MAX_NEW]) if m < tol), LM_MAX_NEW)
        if kernel["tokens"][slot][:close] != plain["tokens"][slot][:close]:
            raise AssertionError(f"{name} slot {slot}: kernel tokens {kernel['tokens'][slot]} "
                                 f"and plain {plain['tokens'][slot]} differ before step {close}")
        out.append(close)
    return out


def run_lm_full(device) -> tuple[dict, dict]:
    """Phase 11: gemma2-9b at full width and depth through the port's
    ServeEngine on the card: bf16 weights from a seeded torch.Generator,
    four seeded prompts of LM_FULL_PROMPTS tokens in four slots,
    LM_FULL_MAX_LEN, 16 greedy tokens.  A kernel run (K7 launched once per
    layer of the prefill, counted from 0), the same through the plain
    attention on the same weights, a warm kernel run, and a run that keeps
    K7's operands.  The two runs' last-position prefill logits must agree
    within LM_LOGIT_TOL and their tokens must be equal up to the first step
    at which the plain run's top-2 margin falls under it.  Returns the
    report and K7's record of the kernels line."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Decoder
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_config(LM_FULL_ARCH)
    t0 = time.perf_counter()
    model = Decoder(cfg, device=device, seed=LM_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    rng = np.random.default_rng(LM_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in LM_FULL_PROMPTS]
    eng = ServeEngine(cfg, model, ServeConfig(max_len=LM_FULL_MAX_LEN,
                                              batch_slots=len(prompts)))

    cold = family_run(eng, prompts)
    decode = decode_profile(model, prompts)
    if cold["launches"] != cfg.n_layers:
        raise AssertionError(f"gemma2-9b: K7 launched {cold['launches']} times in one "
                             f"prefill of {cfg.n_layers} layers")
    plain = family_run(eng, prompts, plain=True)
    if plain["launches"] != 0:
        raise AssertionError("the plain run launched K7")
    warm = family_run(eng, prompts)
    _, captured = capture_launches(("blockwise_attention",),
                                   lambda: eng.generate(prompts, LM_MAX_NEW))
    check_captured("gemma2-9b prefill", captured, {"blockwise_attention": cfg.n_layers})

    logit_err = float((cold["logits"] - plain["logits"]).abs().max())
    if not logit_err <= LM_LOGIT_TOL:
        raise AssertionError(f"gemma2-9b: prefill logits of K7 and the plain attention "
                             f"differ by {logit_err} > {LM_LOGIT_TOL}")
    if warm["tokens"] != cold["tokens"]:
        raise AssertionError("gemma2-9b: two kernel runs gave different tokens")
    # per slot: tokens equal up to the first step whose plain top-2 margin is
    # under the tolerance (there a difference in the last bits may flip it)
    until = agree_until(cold, plain, LM_LOGIT_TOL, LM_FULL_ARCH)
    for r in (cold, plain, warm):
        if not all(len(t) == LM_MAX_NEW for t in r["tokens"]):
            raise AssertionError("gemma2-9b: a slot stopped early")
    k7 = time_attention(captured["blockwise_attention"], cold["launches"])
    del captured
    report = {
        "arch": LM_FULL_ARCH, "layers": cfg.n_layers, "params": cfg.param_count(),
        "weight_bytes": weight_bytes, "init_s": init_s, "prompt_lens": list(LM_FULL_PROMPTS),
        "slots": len(prompts), "max_len": LM_FULL_MAX_LEN, "new_tokens": LM_MAX_NEW,
        "k7_launches_per_prefill": cold["launches"],
        "prefill_ms": {"cold": cold["prefill_ms"], "warm": warm["prefill_ms"],
                       "plain": plain["prefill_ms"]},
        "decode_ms_per_token": {
            "cold_first": cold["decode_ms"][0],
            "cold_median": statistics.median(cold["decode_ms"]),
            "warm_median": statistics.median(warm["decode_ms"]),
            "plain_median": statistics.median(plain["decode_ms"])},
        "decode_profile": decode,
        "decode_device_busy_share": decode["device_ms_per_step"]
        / statistics.median(warm["decode_ms"]),
        "peak_bytes": {"kernel": cold["peak_bytes"], "plain": plain["peak_bytes"]},
        "prefill_logits_max_abs_diff": logit_err, "logit_tol": LM_LOGIT_TOL,
        "tokens_agree_until_step": until,
        "first_close_step": min(until),
        "tokens_equal": cold["tokens"] == plain["tokens"],
        "plain_min_margin": min(float((t[:, 0] - t[:, 1]).min()) for t in plain["top2"]),
        "tokens": cold["tokens"],
    }
    emit({"phase": "lm_full", **report})
    del model, eng
    torch.cuda.empty_cache()
    return report, k7


def state_split(model, prompt: list, max_len: int) -> dict:
    """The state caches against the chunked forms, batch 1: a prefill over
    the first LM_STATE_SPLIT[0] tokens of ``prompt`` and then a decode step
    per token up to LM_STATE_SPLIT[1], against one prefill over all
    LM_STATE_SPLIT[1]; the two last-position logits' largest gap and the
    prefill logits' std."""
    import torch

    a, b = LM_STATE_SPLIT
    if len(prompt) < b:
        raise ValueError(f"a prompt of {len(prompt)} tokens is shorter than {b}")
    toks = torch.tensor([prompt[:b]], dtype=torch.int32, device=model.device)
    with torch.inference_mode():
        whole, _ = model.prefill(toks, model.init_caches(1, max_len))
        logits, caches = model.prefill(toks[:, :a], model.init_caches(1, max_len))
        for t in range(a, b):
            logits, caches = model.decode_step(toks[:, t:t + 1], t, caches)
    whole, stepped = whole[0, -1].float(), logits[0, -1].float()
    std = float(whole.std())
    return {"dtype": str(model.dtype).replace("torch.", ""), "prefill_tokens": a,
            "decode_steps": b - a, "max_abs_diff": float((whole - stepped).abs().max()),
            "logit_std": std, "argmax_equal": int(whole.argmax()) == int(stepped.argmax())}


def embeds_equal(model, prompts) -> dict:
    """musicgen's embeds path: the left-padded batch prefilled from
    ``embed[ids]`` as a [B, S, d] input and from the ids; the reference
    applies no emb_scale there, so the logits must be equal bit for bit."""
    import torch

    from repro_torch.serve.engine import left_pad

    toks, vf = left_pad(prompts, len(prompts))
    toks = torch.from_numpy(toks).to(model.device)
    vf = torch.from_numpy(vf).to(model.device)
    with torch.inference_mode():
        by_ids, _ = model.prefill(toks, model.init_caches(len(prompts), toks.shape[1]), vf)
        x = model.embed[toks]
        by_embeds, _ = model.prefill(x, model.init_caches(len(prompts), toks.shape[1]), vf)
    return {"input_shape": list(x.shape), "bit_equal": bool(torch.equal(by_ids, by_embeds)),
            "max_abs_diff": float((by_ids - by_embeds).abs().max())}


def moe_drops(model, prompts, steps: int = 4) -> dict:
    """Dropped assignments over every MoE layer in the left-padded prefill
    (capacity factor; pads take capacity) and in ``steps`` decode steps
    after it (exact capacity: none)."""
    import torch

    from repro_torch.serve.engine import left_pad

    toks, vf = left_pad(prompts, len(prompts))
    plen = toks.shape[1]
    layers = model.moe_layers()

    def dropped():
        return int(sum(m.dropped for m in layers))

    with torch.inference_mode():
        for m in layers:
            m.reset_dropped()
        logits, caches = model.prefill(torch.from_numpy(toks).to(model.device),
                                       model.init_caches(len(prompts), plen + steps),
                                       torch.from_numpy(vf).to(model.device))
        prefill = dropped()
        for m in layers:
            m.reset_dropped()
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        for step in range(steps):
            logits, caches = model.decode_step(tok, plen + step, caches)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        decode = dropped()
    n_tokens = len(prompts) * plen
    return {"prefill_dropped": prefill, "decode_dropped": decode, "decode_steps": steps,
            "prefill_assignments": n_tokens * model.cfg.moe.top_k * len(layers),
            "prefill_capacity": max(1, int(round(n_tokens * model.cfg.moe.top_k
                                                 / model.cfg.moe.n_experts
                                                 * model.cfg.moe.capacity_factor))),
            "moe_layers": len(layers)}


def run_lm_family(device, arch: str, depth, prompt_lens, max_len: int, k7_per_prefill: int):
    """One arch of phase 17 (see LM_FAMILIES): a kernel run (K7 launched
    once per attention layer of the prefill), the same through the plain
    attention where K7 runs, a warm kernel run and a run that keeps K7's
    operands; then the state, embeds and MoE checks.  Every number goes
    into the report before any check raises.  Returns the report and the
    cold run's K7 launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Decoder
    from repro_torch.serve import ServeConfig, ServeEngine

    t_arch = time.perf_counter()
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    t0 = time.perf_counter()
    model = Decoder(cfg, device=device, seed=LM_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(LM_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in prompt_lens]
    eng = ServeEngine(cfg, model, ServeConfig(max_len=max_len, batch_slots=len(prompts)),
                      device=device)

    cold = family_run(eng, prompts)
    plain = family_run(eng, prompts, plain=True) if k7_per_prefill else None
    warm = family_run(eng, prompts)
    std = float((plain or cold)["logits"].float().std())
    tol = LM_FAMILY_TOL_FRAC * std
    report = {
        "arch": arch, "layers": cfg.n_layers, "published_layers": get_config(arch).n_layers,
        "d_model": cfg.d_model, "params": cfg.param_count(),
        "weight_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
        "init_s": init_s, "prompt_lens": list(prompt_lens), "slots": len(prompts),
        "max_len": max_len, "new_tokens": LM_MAX_NEW,
        "k7_launches_per_prefill": cold["launches"],
        "prefill_ms": {"cold": cold["prefill_ms"], "warm": warm["prefill_ms"]},
        "decode_ms_per_token": {"cold_first": cold["decode_ms"][0],
                                "cold_median": statistics.median(cold["decode_ms"]),
                                "warm_median": statistics.median(warm["decode_ms"])},
        "peak_bytes": {"kernel": cold["peak_bytes"]},
        "logit_std": std, "logit_tol": tol, "tokens": cold["tokens"],
        "finite": bool(torch.isfinite(cold["logits"]).all()),
    }
    failures = []
    if cold["launches"] != k7_per_prefill:
        failures.append(f"K7 launched {cold['launches']} times in one prefill, not "
                        f"{k7_per_prefill}")
    if warm["tokens"] != cold["tokens"]:
        failures.append("two kernel runs gave different tokens")
    if not report["finite"]:
        failures.append("non-finite prefill logits")
    if not all(len(t) == LM_MAX_NEW for t in cold["tokens"]):
        failures.append("a slot stopped early")
    if plain is not None:
        logit_err = float((cold["logits"] - plain["logits"]).abs().max())
        report.update({
            "prefill_logits_max_abs_diff": logit_err,
            "plain_min_margin": min(float((t[:, 0] - t[:, 1]).min()) for t in plain["top2"]),
            "tokens_equal": cold["tokens"] == plain["tokens"]})
        report["prefill_ms"]["plain"] = plain["prefill_ms"]
        report["decode_ms_per_token"]["plain_median"] = statistics.median(plain["decode_ms"])
        report["peak_bytes"]["plain"] = plain["peak_bytes"]
        if plain["launches"] != 0:
            failures.append("the plain run launched K7")
        if not logit_err <= tol:
            failures.append(f"prefill logits of K7 and the plain attention differ by "
                            f"{logit_err} > {tol}")
        try:
            report["tokens_agree_until_step"] = agree_until(cold, plain, tol, arch)
        except AssertionError as e:
            failures.append(str(e))
        _, captured = capture_launches(("blockwise_attention",),
                                       lambda: eng.generate(prompts, LM_MAX_NEW))
        try:
            check_captured(f"{arch} prefill", captured, {"blockwise_attention": k7_per_prefill})
            report["k7"] = k7_chunk_report(captured["blockwise_attention"],
                                           library=arch in ("musicgen-large",
                                                            "llama4-scout-17b-a16e"))
        except AssertionError as e:
            failures.append(str(e))
        del captured
    del plain
    recurrent = cfg.griffin is not None or cfg.ssm is not None
    if recurrent:  # reported, not held (see LM_STATE_TOL_FRAC)
        report["state_split_bf16"] = state_split(model, prompts[-1], max_len)
    if cfg.input_mode == "embeds":
        report["embeds"] = emb = embeds_equal(model, prompts)
        if not emb["bit_equal"]:
            failures.append(f"embeds path differs from the ids path by {emb['max_abs_diff']}")
    if cfg.moe is not None:
        report["moe"] = drops = moe_drops(model, prompts)
        if not drops["prefill_dropped"] > 0 or drops["decode_dropped"] != 0:
            failures.append(f"MoE drops {drops}: want > 0 in the prefill and none in decode")
    if arch == PARTITION_EP_ARCH:  # phase 21a, on this model (reported in phase 21)
        PARTITION_EP.update(partition_ep_run(model, cfg, arch, prompts, max_len, cold, tol,
                                             k7_per_prefill, drops["prefill_dropped"], device))
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    if recurrent:
        model = Decoder(dataclasses.replace(cfg, dtype="float32"), device=device, seed=LM_SEED)
        report["state_split"] = st = state_split(model, prompts[-1], max_len)
        st["tol"] = LM_STATE_TOL_FRAC * st["logit_std"]
        del model
        gc.collect()
        torch.cuda.empty_cache()
        if not st["max_abs_diff"] <= st["tol"]:
            failures.append(f"float32 state caches against the chunked forms: "
                            f"{st['max_abs_diff']} > {st['tol']}")
    report["seconds"] = time.perf_counter() - t_arch
    report["failures"] = failures
    emit({"phase": "lm_family", **report})
    if failures:
        raise AssertionError(f"{arch}: {'; '.join(failures)}")
    return report, cold["launches"]


def run_lm_families(device) -> tuple[dict, int]:
    """Phase 17: LM_FAMILIES through the port's ServeEngine at full width
    on the card.  Returns the reports and K7's launches over the phase's
    kernel runs."""
    reports, launches = {}, 0
    for arch, depth, prompt_lens, max_len, k7 in LM_FAMILIES:
        reports[arch], n = run_lm_family(device, arch, depth, prompt_lens, max_len, k7)
        launches += n
    emit({"phase": "lm_families", "k7_launches": launches,
          "archs": {a: {"prefill_ms_warm": r["prefill_ms"]["warm"],
                        "decode_ms_warm": r["decode_ms_per_token"]["warm_median"],
                        "peak_bytes": r["peak_bytes"]["kernel"],
                        "k7_launches_per_prefill": r["k7_launches_per_prefill"],
                        "seconds": r["seconds"]} for a, r in reports.items()}})
    return reports, launches


def k7b_require(name: str, got, want, dout, v, dtype: str) -> dict:
    """K7b's (dq, dk, dv) against the plain version's within K7B_TOL (see
    there) and K7B_MIN_COS; returns each gradient's error over the limit's
    scale and its cosine."""
    import torch

    torch.cuda.synchronize()
    floor = float(dout.float().abs().max()) * float(v.float().abs().max())
    errs, coss = {}, {}
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name} {label}: {g.dtype}{tuple(g.shape)} != "
                                 f"{w.dtype}{tuple(w.shape)}")
        g, w = g.float(), w.float()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} {label}: non-finite gradient")
        err = float((g - w).abs().max())
        limit = K7B_TOL[dtype] * (float(w.abs().max()) + floor)
        if not err <= limit:
            raise AssertionError(f"{name} {label}: max |err| {err} above {limit}")
        wn, gn = float(w.norm()), float(g.norm())
        cos = float((g * w).sum()) / (wn * gn) if wn > 1e-30 and gn > 1e-30 else 1.0
        # a gradient that is 0 exactly (S = 1: dq and dk) holds by the limit alone
        exact_zero = float(w.abs().max()) <= K7B_TOL[dtype] * floor
        if not exact_zero and not cos >= K7B_MIN_COS[dtype]:
            raise AssertionError(f"{name} {label}: cosine {cos} below {K7B_MIN_COS[dtype]}")
        # the error in units of the limit's scale (its largest |gradient|
        # plus the floor), as the limit reads it
        errs[label], coss[label] = err / (float(w.abs().max()) + floor), cos
    return {"rel_err": errs, "cos": coss}


def check_attention_backward(device) -> list[dict]:
    """Phase 18: K7b alone against autograd through the plain version at
    K7B_SHAPES, float32 and bfloat16, each also run twice on the same
    inputs (the outputs must be bit-equal: no atomics); K7's log-sum-exp
    against torch.logsumexp of the float32 scores."""
    import math

    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(20241018)
    records = []
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for arch, H, KV, hd, window, cap, lengths in K7B_SHAPES:
            for S in lengths:
                B = 2 if S < 1024 else 1
                q, k, v, dout = (torch.randn(B, S, h, hd, generator=gen, device=device).to(dt)
                                 for h in (H, KV, KV, H))
                out, lse = fa._blockwise_forward(q, k, v, window, cap, lse=True)
                got = fa.attention_backward(q, k, v, out, lse, dout, window=window,
                                            logit_cap=cap)
                again = fa.attention_backward(q, k, v, out, lse, dout, window=window,
                                              logit_cap=cap)
                torch.cuda.synchronize()
                name = f"K7b {dname} {arch} S={S}"
                if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                           for a, b in zip(got, again)):
                    raise AssertionError(f"{name}: two runs on the same inputs differ")
                want = fa.attention_backward_plain(q, k, v, dout, window=window, logit_cap=cap)
                rec = k7b_require(name, got, want, dout, v, dname)
                # the forward's lse: log-sum-exp of the valid float32 scores
                qf = q.float().transpose(1, 2)
                kf = k.float().transpose(1, 2).repeat_interleave(H // KV, 1)
                sc = qf @ kf.transpose(-1, -2) / math.sqrt(hd)
                if cap is not None:
                    sc = cap * torch.tanh(sc / cap)
                i = torch.arange(S, device=device)
                valid = i[None, :] <= i[:, None]
                if window is not None:
                    valid &= i[:, None] - i[None, :] < window
                lse_err = float((lse - torch.logsumexp(sc.masked_fill(~valid, float("-inf")),
                                                       -1)).abs().max())
                if not lse_err <= (1e-5 if dname == "float32" else 1e-2):
                    raise AssertionError(f"{name}: log-sum-exp off by {lse_err}")
                records.append({"kernel": "attention_backward", "dtype": dname, "arch": arch,
                                "B": B, "S": S, "H": H, "KV": KV, "hd": hd, "window": window,
                                "cap": cap, "bit_equal_rerun": True, "lse_err": lse_err, **rec})
                del q, k, v, dout, out, lse, got, again, want, qf, kf, sc
    torch.cuda.empty_cache()
    return records


# Phase 21d: K7 and K7b at query offsets.  A rank of the partitioner's
# sequence-sharded attention holds the query rows [r S / tp, (r + 1) S / tp)
# against all S keys; the chunks of tp in {2, 4} at S 4100 (not a multiple
# of the 64-row tiles: 1025 rows a chunk at tp 4) for gemma2-9b's head shape
# (16 / 8 heads of 256, cap 50, window 4096) and llama4-scout's (40 / 8
# heads of 128), float32 and bfloat16.  K7 runs each chunk with and without
# valid_from (pads of 0 and 1500 rows; K7b takes none: training has no
# pads), K7b each chunk at the full launch's dO rows.
K7_OFFSET_S = 4100
K7_OFFSET_TP = (2, 4)
K7_OFFSET_SHAPES = (  # arch, H, KV, hd, window, cap
    ("gemma2-9b", 16, 8, 256, 4096, 50.0),
    ("llama4-scout-17b-a16e", 40, 8, 128, None, None),
)


def check_attention_offsets(device) -> list[dict]:
    """Phase 21d (see K7_OFFSET_S): every chunk's K7 rows equal the full
    launch's rows bit for bit (a key tile wholly outside a row's mask adds
    an exact 0 to its sums, so the row's sums are the same whatever tile it
    sits in); K7b's dQ of each chunk matches the full launch's rows within
    K7B_TOL and K7B_MIN_COS (bit-equal where the chunk starts on a 64-row
    tile edge; elsewhere the masked and unmasked bodies of the bf16 dQ pass
    meet a row on other tiles and may round it one bf16 step apart: the
    record counts the bit-equal chunks), its dK and dV summed over the
    chunks (partial sums of the model axis) match the full launch within
    the same tolerances; the last chunk of each case also against the
    plain versions at the shifted query positions (K7_TOL, K7B_TOL)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(20241029)
    S = K7_OFFSET_S
    records = []
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        for arch, H, KV, hd, window, cap in K7_OFFSET_SHAPES:
            B = 2
            q, k, v, dout = (torch.randn(B, S, h, hd, generator=gen, device=device).to(dt)
                             for h in (H, KV, KV, H))
            for vf in (None, torch.tensor([0, 1500], dtype=torch.int32, device=device)):
                full = fa.blockwise_attention(q, k, v, window=window, logit_cap=cap,
                                              valid_from=vf)
                for tp in K7_OFFSET_TP:
                    n = S // tp
                    name = (f"K7 {dname} {arch} tp={tp} "
                            f"{'valid_from' if vf is not None else 'no pads'}")
                    for r in range(tp):
                        lo = r * n
                        got = fa.blockwise_attention(q[:, lo: lo + n].contiguous(), k, v,
                                                     window=window, logit_cap=cap,
                                                     valid_from=vf, q_off=lo)
                        if not torch.equal(got.view(torch.uint8),
                                           full[:, lo: lo + n].contiguous().view(torch.uint8)):
                            raise AssertionError(f"{name}: chunk {r} differs from the full "
                                                 f"launch's rows")
                    pos = fa.positions_of(vf, B, S, device)
                    want = fa.attention_plain(q[:, lo: lo + n], k, v, pos[:, lo: lo + n], pos,
                                              window=window, logit_cap=cap)
                    rec = k7_require(f"{name} last chunk against the plain version", got,
                                     want, dname, pad=(pos[:, lo: lo + n] < 0))
                    records.append({"kernel": "blockwise_attention", "dtype": dname,
                                    "arch": arch, "tp": tp, "S": S, "valid_from": vf is not None,
                                    "chunks_bit_equal": True, **rec})
                    del got, want
                del full
            out, lse = fa._blockwise_forward(q, k, v, window, cap, lse=True)
            fq, fk, fv = fa.attention_backward(q, k, v, out, lse, dout, window=window,
                                               logit_cap=cap)
            for tp in K7_OFFSET_TP:
                n = S // tp
                name = f"K7b {dname} {arch} tp={tp}"
                dk = torch.zeros(k.shape, dtype=torch.float32, device=device)
                dv = torch.zeros(v.shape, dtype=torch.float32, device=device)
                dq = torch.empty_like(fq)
                dq_equal = 0
                for r in range(tp):
                    lo = r * n
                    qc, dc = q[:, lo: lo + n].contiguous(), dout[:, lo: lo + n].contiguous()
                    oc, lc = fa._blockwise_forward(qc, k, v, window, cap, lse=True, q_off=lo)
                    gq, gk, gv = fa.attention_backward(qc, k, v, oc, lc, dc, window=window,
                                                       logit_cap=cap, q_off=lo)
                    dq[:, lo: lo + n] = gq
                    dq_equal += torch.equal(gq.view(torch.uint8),
                                            fq[:, lo: lo + n].contiguous().view(torch.uint8))
                    dk += gk.float()
                    dv += gv.float()
                rec = k7b_require(f"{name} chunks' dQ and dK/dV summed over the chunks",
                                  (dq, dk.to(dt), dv.to(dt)), (fq, fk, fv), dout, v, dname)
                want = fa.attention_backward_plain(
                    qc, k, v, dc, window=window, logit_cap=cap,
                    q_pos=torch.arange(lo, lo + n, device=device))
                plain = k7b_require(f"{name} last chunk against the plain version",
                                    (gq, gk, gv), want, dc, v, dname)
                records.append({"kernel": "attention_backward", "dtype": dname, "arch": arch,
                                "tp": tp, "S": S, "dq_bit_equal_chunks": dq_equal,
                                "chunks": tp, "summed": rec, "plain": plain})
                del dk, dv, dq, want
            del q, k, v, dout, out, lse, fq, fk, fv
    torch.cuda.empty_cache()
    return records


# Phase 21: the partitioner on the card.  The card's machine has one H100
# and NCCL refuses two ranks on one card, so the phase runs a one-rank NCCL
# group and the 1 x 1 data x model mesh (``make_local_mesh()``): every spec
# resolves to replicated, and everything still runs through the
# partitioned entry points on DTensors, with K7 and K7b under
# ``Partitioner.local``.  (a) PARTITION_EP_ARCH at phase 17's width and
# depth, on phase 17's model and prompts (its ~54 GB of bf16 weights are
# wrapped, not copied), prefilled and decoded through
# ``ServeEngine(partitioner=)``: the expert-parallel MoE (the ``model``
# axis, size 1, divides E) in every prefill layer, its drops those of the
# unpartitioned prefill (one data shard: the same capacity), the logits
# within LM_FAMILY_TOL_FRAC of the unpartitioned kernel run's and its
# greedy tokens.  (b) Phase 19's ten reduced configs through
# ``make_train_step(..., partitioner)`` with each plan's FSDP and
# optimizer: the reference's losses within TRAIN_LOSS_TOL.  (c)
# PARTITION_RESTORE_ARCH's state saved by the unpartitioned trainer at step
# 3, restored onto the mesh (``Trainer(state_shardings=)``): its next step's
# loss equal to the unpartitioned trainer's next step from the same
# checkpoint.  (d) K7 and K7b at query offsets (K7_OFFSET_S).
PARTITION_EP_ARCH = "llama4-scout-17b-a16e"
PARTITION_RESTORE_ARCH = "gemma2-9b"
PARTITION_EP: dict = {}  # phase 21a's record, made in phase 17
_PARTITION: dict = {}


def partition_mesh(device):
    """Phase 21's mesh over a one-rank NCCL group (started once, here)."""
    if "mesh" not in _PARTITION:
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.launch.train import ensure_group

        _PARTITION["started"] = ensure_group(device)
        _PARTITION["mesh"] = make_local_mesh()
    return _PARTITION["mesh"]


def close_partition_group() -> None:
    import torch.distributed as dist

    if _PARTITION.get("started"):
        dist.destroy_process_group()
    _PARTITION.clear()


def unshard_model(model) -> None:
    """Phase 21a's DTensor parameters (and MoE drop counts) back to the
    plain tensors they wrap."""
    import torch

    for name, p in list(model.named_parameters()):
        if hasattr(p, "placements"):
            *path, leaf = name.split(".")
            setattr(model.get_submodule(".".join(path)), leaf,
                    torch.nn.Parameter(p.to_local(), requires_grad=p.requires_grad))
    for m in model.moe_layers():
        if hasattr(m.dropped, "placements"):
            m.dropped = m.dropped.to_local()


def partition_ep_run(model, cfg, arch: str, prompts, max_len: int, cold: dict, tol: float,
                     k7_per_prefill: int, prefill_dropped: int, device) -> dict:
    """Phase 21a on phase 17's model (see PARTITION_EP_ARCH): K7 and the
    expert-parallel MoE body counted from 0 over one generate."""
    import torch

    from repro_torch.configs import get_plan
    from repro_torch.dist.partition import Partitioner
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    part = Partitioner(partition_mesh(device), fsdp=get_plan(arch).fsdp)
    before = torch.cuda.memory_allocated()
    eng = ServeEngine(cfg, model, ServeConfig(max_len=max_len, batch_slots=len(prompts)),
                      device=device, partitioner=part)
    placed = torch.cuda.memory_allocated() - before
    for m in model.moe_layers():
        m.reset_dropped()
    ep_calls = []
    real_ep = moe_mod._moe_ep

    def counting(*args, **kw):
        ep_calls.append(1)
        return real_ep(*args, **kw)

    moe_mod._moe_ep = counting
    try:
        run = family_run(eng, prompts)
    finally:
        moe_mod._moe_ep = real_ep
    dropped = int(sum(m.dropped for m in model.moe_layers()))
    all_placed = all(hasattr(p, "placements") for p in model.parameters())
    unshard_model(model)
    logit_err = float((run["logits"] - cold["logits"]).abs().max())
    rec = {"arch": arch, "layers": cfg.n_layers, "mesh": dict(part.shape),
           "fsdp": part.fsdp, "k7_launches": run["launches"],
           "ep_launches": len(ep_calls), "moe_layers": len(model.moe_layers()),
           "dropped": dropped, "unpartitioned_prefill_dropped": prefill_dropped,
           "logits_max_abs_diff": logit_err, "tol": tol,
           "tokens_equal": run["tokens"] == cold["tokens"], "params_placed": all_placed,
           "bytes_allocated_by_placing": placed, "prefill_ms": run["prefill_ms"],
           "decode_ms_median": statistics.median(run["decode_ms"]),
           "peak_bytes": run["peak_bytes"], "seconds": time.perf_counter() - t0}
    failures = []
    if run["launches"] != k7_per_prefill:
        failures.append(f"K7 launched {run['launches']} times, not {k7_per_prefill}")
    if len(ep_calls) != len(model.moe_layers()) or not all_placed:
        failures.append(f"the expert-parallel body ran {len(ep_calls)} times for "
                        f"{len(model.moe_layers())} MoE layers (parameters placed: {all_placed})")
    if dropped != prefill_dropped or not dropped > 0:
        failures.append(f"{dropped} drops, the unpartitioned prefill {prefill_dropped}")
    if not logit_err <= tol or not rec["tokens_equal"]:
        failures.append(f"logits {logit_err} from the unpartitioned run's (tol {tol}), "
                        f"tokens equal: {rec['tokens_equal']}")
    if placed > 2**30:
        failures.append(f"placing the parameters allocated {placed} bytes")
    rec["failures"] = failures
    return rec


def run_partition_phase(device, ep: dict) -> tuple[dict, dict]:
    """Phase 21 (b), (c) and (d), and (a)'s record from phase 17.  Returns
    the report and the phase's K7 / K7b launches on its main path (a-c)."""
    import shutil

    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCH_IDS

    t_phase = time.perf_counter()
    mesh = partition_mesh(device)
    failures = list(ep.get("failures", ["phase 21a did not run"]))
    launches = {"blockwise_attention": ep.get("k7_launches", 0), "attention_backward": 0}
    ckpt = ROOT / "build" / "partition_ckpt"
    train = {}
    for arch in ARCH_IDS:  # (b)
        shutil.rmtree(ckpt, ignore_errors=True)
        kernels.reset_launches()
        rec = train_reduced(arch, device, str(ckpt), mesh=mesh)
        torch.cuda.synchronize()
        rec["launches"] = n = train_launches()
        for name in launches:
            launches[name] += n[name]
        want = TRAIN_REDUCED_EXPECTED[arch]
        rec["max_loss_diff"] = max(abs(a - b) for a, b in zip(rec["losses"], want))
        train[arch] = rec
        layers = rec["attention_layers"]
        if (rec["steps"] != TRAIN_REDUCED_STEPS or rec["restarts"] or not rec["params_placed"]
                or len(rec["losses"]) != len(want) or not rec["max_loss_diff"] <= TRAIN_LOSS_TOL):
            failures.append(f"21b {arch}: {rec}")
        if n != {"blockwise_attention": 2 * TRAIN_REDUCED_STEPS * layers,
                 "attention_backward": TRAIN_REDUCED_STEPS * layers}:
            failures.append(f"21b {arch}: launches {n} over {TRAIN_REDUCED_STEPS} steps of "
                            f"{layers} attention layers")
    # (c) restore onto the mesh
    arch = PARTITION_RESTORE_ARCH
    shutil.rmtree(ckpt, ignore_errors=True)
    saved = train_reduced(arch, device, str(ckpt / "saved"))
    for name in ("plain", "mesh"):
        shutil.copytree(ckpt / "saved", ckpt / name)
    plain = train_reduced(arch, device, str(ckpt / "plain"), total_steps=TRAIN_REDUCED_STEPS + 1)
    kernels.reset_launches()
    placed = train_reduced(arch, device, str(ckpt / "mesh"), mesh=mesh,
                           total_steps=TRAIN_REDUCED_STEPS + 1)
    torch.cuda.synchronize()
    n = train_launches()
    for name in launches:
        launches[name] += n[name]
    shutil.rmtree(ckpt, ignore_errors=True)
    restore = {"arch": arch, "saved_losses": saved["losses"], "next_loss": placed["losses"],
               "unpartitioned_next_loss": plain["losses"], "params_placed": placed["params_placed"],
               "launches": n}
    if (placed["losses"] != plain["losses"] or len(plain["losses"]) != 1
            or not placed["params_placed"] or placed["restarts"]):
        failures.append(f"21c: {restore}")
    # (d) the kernels at query offsets
    t0 = time.perf_counter()
    offsets = check_attention_offsets(device)
    report = {"mesh": {k: v for k, v in zip(mesh.device_mesh.mesh_dim_names,
                                             mesh.device_mesh.shape)},
              "a_ep": ep, "b_train": train, "c_restore": restore,
              "d_offsets": {"cases": len(offsets), "seconds": time.perf_counter() - t0,
                            "records": offsets},
              "launches": launches, "seconds": time.perf_counter() - t_phase,
              "failures": failures}
    emit({"phase": "partition", **report})
    if failures:
        raise AssertionError("; ".join(failures))
    return report, launches


def k7b_bound_ms(B: int, S: int, H: int, KV: int, hd: int, window) -> tuple:
    """K7b's least time: the backward's products, 10 hd operations per valid
    (query, key) pair (2.5 x the forward's 4 hd), at the bf16 tensor-core
    peak; or q, k, v, o, dout read and dq, dk, dv written once (bf16) and
    the log-sum-exp read, at the memory rate.  Returns (ms, bound_by)."""
    pairs = B * H * attention_pairs(S, [0], window)
    t_ops = 10 * hd * pairs / BF16_FLOPS_PER_S * 1e3
    t_bytes = ((4 * B * S * H * hd + 4 * B * S * KV * hd) * 2 + B * H * S * 4) \
        / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def time_attention_backward(device, launches: int, check_records: list) -> dict:
    """K7b's record of the kernels line: its time at K7B_TIMED (gemma2-9b's
    layer at train_4k's sequence, with the cap) beside the plain version's
    autograd on the same inputs and its bound; ``library_ms`` is the
    backward of scaled_dot_product_attention on the same shape without the
    cap (SDPA has none), beside K7b on that cap-free shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    B, S, H, KV, hd = K7B_TIMED
    gen = torch.Generator(device=device).manual_seed(7)
    q, k, v, dout = (torch.randn(B, S, h, hd, generator=gen, device=device,
                                 dtype=torch.bfloat16) for h in (H, KV, KV, H))
    out, lse = fa._blockwise_forward(q, k, v, None, 50.0, lse=True)
    ms = cuda_time_ms(lambda: fa.attention_backward(q, k, v, out, lse, dout, window=None,
                                                    logit_cap=50.0), reps=5, warmup=1)
    # the three passes apart: events before the first launch and after each
    passes = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda._sleep(SPIN_CYCLES)
        fa.attention_backward(q, k, v, out, lse, dout, window=None, logit_cap=50.0, events=ev)
        ev[3].synchronize()
        passes.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    pass_ms = [statistics.median(p[i] for p in passes) for i in range(3)]
    got = fa.attention_backward(q, k, v, out, lse, dout, window=None, logit_cap=50.0)
    want = fa.attention_backward_plain(q, k, v, dout, window=None, logit_cap=50.0)
    err = k7b_require("K7b at the timed shape", got, want, dout, v, "bfloat16")
    max_abs = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    del got, want
    plain_ms = cuda_time_ms(lambda: fa.attention_backward_plain(q, k, v, dout, window=None,
                                                                logit_cap=50.0),
                            reps=3, warmup=1)
    bound_ms, bound_by = k7b_bound_ms(B, S, H, KV, hd, None)
    # the cap-free shape: K7b and SDPA's backward on one function
    out0, lse0 = fa._blockwise_forward(q, k, v, None, None, lse=True)
    free_ms = cuda_time_ms(lambda: fa.attention_backward(q, k, v, out0, lse0, dout, window=None,
                                                         logit_cap=None), reps=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    sd = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    gt = dout.transpose(1, 2)
    library_ms = cuda_time_ms(lambda: torch.autograd.grad(sd, (qt, kt, vt), gt,
                                                          retain_graph=True), reps=5, warmup=1)
    lib = torch.autograd.grad(sd, (qt, kt, vt), gt)
    mine = fa.attention_backward(q, k, v, out0, lse0, dout, window=None, logit_cap=None)
    lib_err = k7b_require("K7b against SDPA's backward (cap-free)", mine,
                          [x.transpose(1, 2) for x in lib], dout, v, "bfloat16")
    del q, k, v, dout, out, lse, out0, lse0, qt, kt, vt, sd, lib, mine
    torch.cuda.empty_cache()
    return {"name": "attention_backward", "route": "cuda",
            "source": "src/repro_torch/csrc/attention.cu",
            "replaces": "src/repro/models/attention.py:73", "launches": launches,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "bound_share": bound_ms / ms,
            "dot_ms": pass_ms[0], "dkdv_ms": pass_ms[1], "dq_ms": pass_ms[2],
            "shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd, "cap": 50.0,
                      "dtype": "bfloat16"},
            "rel_err": err["rel_err"], "cos": err["cos"],
            "library_shape": {"cap": None, "k7b_ms": free_ms,
                              "k7b_over_library": free_ms / library_ms,
                              "k7b_vs_sdpa": lib_err},
            "phase18_cases": len(check_records),
            "phase18_max_rel_err": {d: max(max(r["rel_err"].values()) for r in check_records
                                           if r["dtype"] == d) for d in K7B_TOL},
            "phase18_min_cos": {d: min(min(r["cos"].values()) for r in check_records
                                       if r["dtype"] == d) for d in K7B_TOL}}


def train_launches() -> dict:
    from repro_torch.kernels import flash_attention as fa

    return {"blockwise_attention": fa.blockwise_attention.launches,
            "attention_backward": fa.attention_backward.launches}


def train_reduced(arch: str, device, ckpt_dir: str, mesh=None,
                  total_steps: int = TRAIN_REDUCED_STEPS) -> dict:
    """One arch of phase 19 (see TRAIN_REDUCED_EXPECTED) through the
    Trainer; returns each step's metrics.  ``mesh`` (phase 21): through
    ``Partitioner(mesh, fsdp=plan.fsdp)`` — the model and optimizer state
    placed by ``state_shardings``, a checkpoint in ``ckpt_dir`` restored
    onto the mesh.  ``total_steps`` past the checkpoint in ``ckpt_dir``
    continues from it."""
    from repro_torch.configs import get_config, get_plan
    from repro_torch.data.lm_data import make_batch_iterator
    from repro_torch.dist.partition import Partitioner, replicate_plain
    from repro_torch.interop import numpy_params, params_from_jax
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import Decoder
    from repro_torch.train import step as tstep
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optim import get_optimizer, warmup_cosine

    cfg = get_config(arch).reduced()
    plan = get_plan(arch)
    opt = get_optimizer(plan.optimizer,
                        warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_REDUCED_STEPS))
    model = Decoder(cfg, device=device, seed=None)
    weights = params_from_jax(numpy_params(cfg, LM_SEED), cfg)
    part = sh = None
    if mesh is not None:
        part = Partitioner(mesh, fsdp=plan.fsdp)
        sh = tstep.model_state_shardings(part, model, opt)
        tstep.shard_model(model, part)

    def init():
        with replicate_plain():  # whole values into the placed parameters
            model.load_state_dict(weights)
        return tstep.init_state(model, opt, sh)

    shape = ShapeConfig("reduced", "train", *TRAIN_REDUCED_SHAPE)
    trainer = Trainer(tstep.make_train_step(model, opt, part), init,
                      lambda start: make_batch_iterator(cfg, shape, seed=0, start_step=start),
                      TrainerConfig(total_steps=total_steps,
                                    ckpt_every=TRAIN_REDUCED_STEPS, ckpt_dir=ckpt_dir, keep=1),
                      state_shardings=sh)
    out = trainer.run()
    trainer.ckpt.close()
    return {"steps": out["steps"], "restarts": out["n_restarts"],
            "losses": [h["loss"] for h in out["history"]],
            "grad_norms": [h["grad_norm"] for h in out["history"]],
            "optimizer": plan.optimizer, "fsdp": plan.fsdp,
            "attention_layers": attention_layers(cfg),
            "params_placed": all(hasattr(p, "placements") for p in model.parameters())}


def run_train_reduced(device) -> tuple[dict, dict]:
    """Phase 19: every config reduced trains TRAIN_REDUCED_STEPS steps on the
    card through the Trainer; each step's loss within TRAIN_LOSS_TOL of the
    reference's (TRAIN_REDUCED_EXPECTED); K7 launched twice per attention
    layer and step (the forward and the backward's recompute), K7b once.
    Returns the report and the phase's K7 / K7b launches."""
    import shutil

    import torch

    from repro_torch import kernels
    from repro_torch.configs import ARCH_IDS

    report, total = {}, {"blockwise_attention": 0, "attention_backward": 0}
    ckpt_dir = ROOT / "build" / "train_reduced_ckpt"
    failures = []
    for arch in ARCH_IDS:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        t0 = time.perf_counter()
        kernels.reset_launches()
        rec = train_reduced(arch, device, str(ckpt_dir))
        torch.cuda.synchronize()
        rec["launches"] = n = train_launches()
        rec["seconds"] = time.perf_counter() - t0
        want = TRAIN_REDUCED_EXPECTED[arch]
        rec["max_loss_diff"] = max(abs(a - b) for a, b in zip(rec["losses"], want))
        report[arch] = rec
        for name in total:
            total[name] += n[name]
        layers = rec["attention_layers"]
        if rec["steps"] != TRAIN_REDUCED_STEPS or rec["restarts"]:
            failures.append(f"{arch}: {rec['steps']} steps, {rec['restarts']} restarts")
        if len(rec["losses"]) != len(want) or not rec["max_loss_diff"] <= TRAIN_LOSS_TOL:
            failures.append(f"{arch}: losses {rec['losses']} against the reference's {want}")
        if n != {"blockwise_attention": 2 * TRAIN_REDUCED_STEPS * layers,
                 "attention_backward": TRAIN_REDUCED_STEPS * layers}:
            failures.append(f"{arch}: launches {n} over {TRAIN_REDUCED_STEPS} steps of "
                            f"{layers} attention layers")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit({"phase": "train_reduced", "runs": report, "loss_tol": TRAIN_LOSS_TOL,
          "failures": failures})
    if failures:
        raise AssertionError("; ".join(failures))
    return report, total


def attention_grads(model, batch: dict, plain: bool) -> dict:
    """Step 1's gradients of every attention leaf (``core.w*``) of
    ``model`` on ``batch``, through K7 and K7b or, with ``plain``, through
    the plain attention under autograd."""
    import torch

    from repro_torch.models import transformer

    params = model.trainable()
    names = [n for n in params if ".core.w" in n]
    with plain_attention() if plain else contextlib.nullcontext():
        loss, _ = transformer.train_loss_fn(model, batch)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
    return dict(zip(names, grads)), float(loss.detach())


def run_train_full(device) -> tuple[dict, dict]:
    """Phase 20: gemma2-9b at full width (TRAIN_FULL_*).  Step 1's attention
    gradients through K7/K7b against the plain attention's; then the
    Trainer's 4 steps with a checkpoint at step 2 and a fault at step 3:
    finite losses and gradient norms, the replayed steps bit-identical to
    their first runs, K7 and K7b launched on every layer of every step;
    step walls, checkpoint save and restore walls, peak memory.  Returns
    the report and the phase's K7 / K7b launches."""
    import dataclasses
    import shutil

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import make_batch_iterator
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import Decoder
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optim import get_optimizer, warmup_cosine
    from repro_torch.train.step import batch_to, init_state, make_train_step

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_FULL_ARCH), n_layers=TRAIN_FULL_DEPTH)
    seq, bsz = TRAIN_FULL_SHAPE
    shape = ShapeConfig("train_4k_b1", "train", seq, bsz)
    t0 = time.perf_counter()
    model = Decoder(cfg, device=device, seed=LM_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    layers = attention_layers(cfg)
    report = {"arch": TRAIN_FULL_ARCH, "layers": cfg.n_layers,
              "published_layers": get_config(TRAIN_FULL_ARCH).n_layers, "d_model": cfg.d_model,
              "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.resolved_head_dim,
              "vocab": cfg.vocab_size, "seq": seq, "batch": bsz, "params": n_params,
              "init_s": init_s}
    failures = []

    # step 1's attention gradients: K7/K7b against the plain attention
    _, batch0 = next(make_batch_iterator(cfg, shape, seed=0))
    batch0 = batch_to(batch0, device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    g_k, loss_k = attention_grads(model, batch0, plain=False)
    torch.cuda.synchronize()
    report["grad_check_kernel_s"] = time.perf_counter() - t0
    n = train_launches()
    t0 = time.perf_counter()
    g_p, loss_p = attention_grads(model, batch0, plain=True)
    torch.cuda.synchronize()
    report["grad_check_plain_s"] = time.perf_counter() - t0
    cos = {}
    zero = []
    for name, g in g_k.items():
        a, b = g.float(), g_p[name].float()
        cos[name] = float((a * b).sum() / (a.norm() * b.norm()).clamp_min(1e-30))
        if name.split(".")[-1] in ("wq", "wk", "wv") and not bool((a != 0).any()):
            zero.append(name)
    report["grad_check"] = {
        "loss_kernel": loss_k, "loss_plain": loss_p, "launches": n,
        "min_cos": min(cos.values()), "min_cos_leaf": min(cos, key=cos.get),
        "min_cos_by_kind": {w: min(c for k, c in cos.items() if k.endswith(w))
                            for w in ("wq", "wk", "wv", "wo")},
        "zero_grad_leaves": zero,
        "grad_norm_wq_first_last": [float(g_k["layers.0.core.wq"].float().norm()),
                                    float(g_k[f"layers.{layers - 1}.core.wq"].float().norm())]}
    if zero:
        failures.append(f"zero gradients on {zero}")
    if not min(cos.values()) >= TRAIN_GRAD_MIN_COS:
        failures.append(f"attention gradients' cosine {min(cos.values())} below "
                        f"{TRAIN_GRAD_MIN_COS} ({min(cos, key=cos.get)})")
    if n != {"blockwise_attention": 2 * layers, "attention_backward": layers}:
        failures.append(f"gradient check launches {n} for {layers} layers")
    del g_k, g_p, batch0
    gc.collect()
    torch.cuda.empty_cache()

    # the Trainer: a checkpoint at step 2, a fault at step 3, the replay
    opt = get_optimizer("adamw", warmup_cosine(3e-4, 100, TRAIN_FULL_STEPS))
    ckpt_dir = ROOT / "build" / "train_full_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    calls = {"fault": 0}

    def fault_hook(step):
        if step != TRAIN_FULL_FAULT_STEP:
            return
        calls["fault"] += 1
        if calls["fault"] == 1:
            raise RuntimeError(f"injected fault at step {step}")
        # restored and replayed: free the disk for the next save
        for d in ckpt_dir.glob("step_*"):
            shutil.rmtree(d)

    def init():
        model.reset_parameters(LM_SEED)
        return init_state(model, opt)

    walls = []
    step_fn = make_train_step(model, opt)

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        return out

    trainer = Trainer(timed_step, init,
                      lambda start: make_batch_iterator(cfg, shape, seed=0, start_step=start),
                      TrainerConfig(total_steps=TRAIN_FULL_STEPS,
                                    ckpt_every=TRAIN_FULL_CKPT_EVERY, ckpt_dir=str(ckpt_dir),
                                    keep=1),
                      fault_hook=fault_hook)
    io_walls = {"save": [], "restore": []}
    for kind in io_walls:
        real = getattr(trainer.ckpt, kind)

        def wrapped(*a, _real=real, _kind=kind, **kw):
            t = time.perf_counter()
            out = _real(*a, **kw)
            torch.cuda.synchronize()
            io_walls[_kind].append(time.perf_counter() - t)
            return out

        setattr(trainer.ckpt, kind, wrapped)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = train_launches()
    trainer.ckpt.close()
    hist = out["history"]
    ckpt_bytes = None
    done = sorted(ckpt_dir.glob("step_*"))
    if done:
        ckpt_bytes = sum(f.stat().st_size for f in done[-1].iterdir())
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    by_step = {}
    for h in hist:
        by_step.setdefault(h["step"], []).append(h)
    report["trainer"] = {
        "steps": out["steps"], "restarts": out["n_restarts"], "history": hist,
        "step_walls_s": walls, "save_walls_s": io_walls["save"],
        "restore_walls_s": io_walls["restore"], "run_s": run_s,
        "checkpoint_bytes": ckpt_bytes, "peak_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "replayed_equal": {s: all(h == hs[0] for h in hs[1:]) for s, hs in by_step.items()
                           if len(hs) > 1}}
    steps_run = len(walls)
    if out["steps"] != TRAIN_FULL_STEPS or out["n_restarts"] != 1:
        failures.append(f"trainer: {out['steps']} steps, {out['n_restarts']} restarts")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist):
        failures.append("non-finite loss or gradient norm")
    replayed = report["trainer"]["replayed_equal"]
    if sorted(replayed) != [TRAIN_FULL_CKPT_EVERY] or not all(replayed.values()):
        failures.append(f"replayed steps {replayed}: want step {TRAIN_FULL_CKPT_EVERY} "
                        f"replayed bit for bit")
    if launches != {"blockwise_attention": 2 * layers * steps_run,
                    "attention_backward": layers * steps_run}:
        failures.append(f"launches {launches} over {steps_run} steps of {layers} layers")
    report["seconds"] = time.perf_counter() - t_phase
    report["failures"] = failures
    emit({"phase": "train_full", **report})
    del model, trainer, out
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    total = {k: launches[k] + n[k] for k in launches}
    return report, total


def int32_ops_per_s(device) -> float:
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return sms * INT32_OPS_PER_CLK_PER_SM * mhz * 1e6


def needed_word_ops(rows, cands, kw: dict | None) -> int:
    """Word operations these inputs need: the subset test up to each
    (candidate, row)'s first failing word (AND + compare per word), the
    match count per (candidate, row), the AND-accumulate of every word of
    every matching row, and, for K2 (``kw`` given), ~3 operations per
    closure word for the mask and the support test, and 3 more for CbO's
    canonicity test.  Rows ``[k, n, W]`` count as their k·n rows."""
    import torch

    W = rows.shape[-1]
    rows = rows.reshape(-1, W)
    test = 0
    acc = 0
    B, N = cands.shape[0], rows.shape[0]
    step = max(1, (1 << 24) // max(1, N * W))
    for lo in range(0, B, step):
        c = cands[lo: lo + step]
        ok = (rows[None, :, :] & c[:, None, :]) == c[:, None, :]  # [b, N, W]
        fail = ~ok
        first_fail = torch.where(fail.any(-1), fail.int().argmax(-1) + 1, W)
        test += int(first_fail.sum())
        acc += int(ok.all(-1).sum()) * W
    epilogue = 0 if kw is None else (6 if kw.get("cbo") else 3) * B * W
    return 2 * test + B * N + acc + epilogue


def moved_bytes(rows, cands, kw: dict | None) -> int:
    """Each input read once and each output written once (K1/K2; K1's
    rows [k, n, W] give k closure blocks and support vectors)."""
    W, N, B = rows.shape[-1], rows.numel() // rows.shape[-1], cands.shape[0]
    k = rows.shape[0] if rows.dim() == 3 else 1
    nbytes = (N * W + B * W) * 4 + k * B * (W + 1) * 4  # rows, cands; closures, supports
    if kw is not None:
        nbytes += W * 4 + 4 * 4 + B  # mask, scalars; keep
        if kw.get("cbo"):
            nbytes += 2 * B * W * 4  # parent, lowrow
    return nbytes


def closure_bound(args, kw):
    """K1 and K2: (ops, bytes, census ops, chunk shape); K1's rows may hold
    k shards, whose N counts all k·n rows."""
    rows, cands = args[0], args[1]
    epi = kw if len(args) > 2 else None  # K2 carries mask and scalars
    W, N, B = rows.shape[-1], rows.numel() // rows.shape[-1], cands.shape[0]
    k = rows.shape[0] if rows.dim() == 3 else 1
    census = 4 * B * N * W + B * N + (3 * B * W if epi is not None else 0)
    return (needed_word_ops(rows, cands, epi), moved_bytes(rows, cands, epi), census,
            {"k": k, "B": B, "N": N, "W": W})


def map_bound(args, kw):
    """K3: K1's data-dependent census over all k shards, plus the mask AND
    of every closure word; bytes: rows, candidates and mask in, k closure
    blocks and k support vectors out."""
    rows, cands = args[0], args[1]
    k = rows.shape[0] if rows.dim() == 3 else 1
    W, N, B = rows.shape[-1], rows.numel() // rows.shape[-1], cands.shape[0]
    ops = needed_word_ops(rows, cands, None) + k * B * W
    nbytes = (N * W + B * W + W) * 4 + k * B * (W + 1) * 4
    census = 4 * B * N * W + B * N + k * B * W
    return ops, nbytes, census, {"k": k, "B": B, "N": N, "W": W}


def filter_bound(args, kw):
    """K4 on K shards' partials: K - 1 ANDs per closure word and K - 1 adds
    per support (the fold), and per candidate the pad subtraction, the
    validity test and (iceberg) the support test; for CbO, 3 operations per
    word up to each still-kept candidate's first non-canonical word.
    Bytes: the partials and supports in, the closures (K > 1), supports and
    keep bytes out, and for CbO the gens, and the parent and LOW rows of
    the candidates still kept."""
    import torch

    from repro_torch.kernels import frontier as fk

    lc, ls, sc = args
    K = lc.shape[0] if lc.dim() == 3 else 1
    B, W = lc.shape[-2:]
    sup = ls is not None
    ops = (K - 1) * B * W + ((K - 1) * B if sup else 0) + 2 * B
    ops += B if kw.get("iceberg") else 0
    nbytes = K * B * W * 4 + (K * B * 4 if sup else 0)  # in
    nbytes += (B * W * 4 if K > 1 else 0) + (B * 4 if sup else 0) + B + 4 * 4  # out, scalars
    census = ops
    if kw.get("cbo"):
        gc, _, live = fk.filter_step_plain(lc, ls, sc, iceberg=kw.get("iceberg", False))
        gens, n_low = kw["gens"], kw["LOW"].shape[0]
        live = live & (gens >= 0) & (gens < n_low)
        lowrow = kw["LOW"][gens.long().clamp(0, n_low - 1)]
        bad = ((gc ^ kw["parent"]) & lowrow) != 0  # [B, W]
        first = torch.where(bad.any(-1), bad.int().argmax(-1) + 1, W)
        ops += 3 * int(first[live].sum())
        census += 3 * B * W
        n_live = int(live.sum())
        nbytes += B * 4 + n_live * W * 4 + int(gens[live].unique().numel()) * W * 4
    return ops, nbytes, census, {"K": K, "B": B, "W": W, "supports": sup,
                                 "scalars": list(sc)}


def parent_between_ms(args, kw) -> float:
    """The torch ops the parent tree ran between K3 and K4 on a K4 chunk of
    the k = 8 rsag runs, timed as ``time_kernels`` times a kernel: the
    simulated rsag AND-allreduce of the partials, the support sum − n_pad
    (iceberg), shard 0's copies of both, and CbO's ``LOW[gens]`` gather (or,
    without iceberg, the zero supports it passed instead)."""
    import torch

    from repro_torch.dist import collectives

    lc, ls, sc = args

    def fn():
        gc = collectives.and_allreduce(lc, collectives.SIM_AXIS, impl="rsag")[0]
        gs = None
        if kw.get("iceberg"):
            gs = (collectives.sum_allreduce(ls, collectives.SIM_AXIS) - sc[2])[0]
        if kw.get("cbo"):
            lowrow = kw["LOW"][kw["gens"].long()]
            if gs is None:
                gs = torch.zeros(gc.shape[0], dtype=torch.int32, device=gc.device)
            return gc, gs, lowrow
        return gc, gs

    return cuda_time_ms(fn)


def first_fail_words(small, big, queries_small: bool) -> tuple[int, int]:
    """Σ over (query, row) pairs of the words the subset test reads up to
    the first failing one (all W words for a pair that passes), and the
    number of pairs that pass."""
    import torch

    W = small.shape[1]
    total = passes = 0
    step = max(1, (1 << 24) // max(1, big.shape[0] * W))
    for lo in range(0, small.shape[0], step):
        s = small[lo: lo + step]
        bad = ((s[:, None, :] & ~big[None, :, :]) if queries_small
               else (big[None, :, :] & ~s[:, None, :])) != 0  # [b, rows, W]
        fails = bad.any(-1)
        total += int(torch.where(fails, bad.int().argmax(-1) + 1, W).sum())
        passes += int((~fails).sum())
    return total, passes


def topk_bound(args, kw):
    """K5: two operations per subset-test word up to each (query, live
    concept) pair's first failing word, one select per pair against the
    k-th best so far, and a binary insertion (bit_length(k) compares) of
    each hit among the k best; bytes: the queries, the live intents and
    supports in, ids and supports out."""
    gc, intents, supports, n_concepts = args
    k = kw["k"]
    S, W = gc.shape
    live = max(0, min(int(n_concepts), intents.shape[0]))
    words, hits = first_fail_words(gc, intents[:live], True)
    ops = 2 * words + S * live + hits * k.bit_length()
    nbytes = (S * W + live * W + live) * 4 + S * k * 8
    census = 2 * S * live * W + S * live * (1 + k.bit_length())
    return ops, nbytes, census, {"S": S, "C": intents.shape[0], "live": live, "W": W, "k": k,
                                 "hits": hits}


def rules_bound(args, kw):
    """K6: two operations per premise-test word up to each (query, live
    rule) pair's first failing word, one confidence-and-select per pair,
    and for every firing pair one OR per consequent word and a binary
    insertion (bit_length(k) compares) among the k best; bytes: the
    queries, the live premises, confidences, metrics and rule ids, the
    consequents of the rules that fire for some query, and the ids,
    scores and unions out."""
    import torch

    prem, added, conf, metric, rid, n_rules, queries, min_conf = args
    k = kw["k"]
    S, W = queries.shape
    live = max(0, min(int(n_rules), prem.shape[0]))
    p = prem[:live]
    fits = ((p[None, :, :] & ~queries[:, None, :]) == 0).all(-1)  # [S, live]
    fires = fits & (conf[:live] >= torch.tensor(min_conf, dtype=torch.float32,
                                                 device=conf.device))[None, :]
    n_fire, rules_read = int(fires.sum()), int(fires.any(0).sum())
    words, _ = first_fail_words(queries, p, False)
    ops = 2 * words + S * live + n_fire * (W + k.bit_length())
    nbytes = (S * W + live * W + 3 * live + rules_read * W) * 4 + S * k * 8 + S * W * 4
    census = 2 * S * live * W + S * live * (1 + W + k.bit_length())
    return ops, nbytes, census, {"S": S, "R": prem.shape[0], "live": live, "W": W, "k": k,
                                 "firing_pairs": n_fire}


def tc_ops(args) -> int:
    """K1/K2/K3 as two 0/1 products over complement bit-planes: 2 · B · rows ·
    32W operations each (miss = C·R̄ᵀ, absent = match·R̄), rows summed over
    the shards."""
    rows, cands = args[0], args[1]
    W = rows.shape[-1]
    return 2 * 2 * cands.shape[0] * (rows.numel() // W) * 32 * W


def matmul_backend_ms(name: str, args, kw, got) -> float:
    """The port's library route on a K1/K2/K3 chunk: ``ops.closure_matmul``
    (two bf16 ``torch.matmul`` products over the mask's attributes; for K1
    over all 32W lanes with every row valid, its raw function), held
    against the kernel's closures and supports ``got``, then timed."""
    from repro_torch.kernels import ops

    rows, cands = args[0], args[1]
    n_attrs = 32 * rows.shape[-1] if name == "closure" else sum(
        bin(int(x) & 0xFFFFFFFF).count("1") for x in args[2].flatten().tolist())
    n_pad = args[3][2] if name == "fused_step" else 0

    def fn():
        return ops.closure_matmul(rows, cands, n_attrs, n_valid_rows=rows.shape[-2] - n_pad)

    require_equal(f"{name}: closure_matmul on its costliest chunk", fn(), got[:2])
    return cuda_time_ms(fn)


def time_kernels(device, launches: dict, chunks: dict) -> list[dict]:
    """Phase 7: each kernel on the chunks its main path gave it (captured
    in phases 4, 5, 8 and 9), beside its plain version and its bound.

    Every captured chunk is replayed and timed alone (CUDA events, median
    of TIMING_REPS after warm-up); ``run_ms`` and ``run_bound_ms`` are the
    sums over all of a kernel's captured launches, and ``ms``, ``plain_ms``
    and ``bound_ms`` are those of its costliest chunk.  K1 and K2 time
    their phase-4 chunks (one shard), K1 also those of phases 5 and 8; K3
    and K4 the chunks of the k = 8 rsag runs of phase 5 (both mushroom
    drivers and census-income); K5 and K6 those of the kernel runs of
    phases 8 and 9; ``run_ms_by_run`` splits the run sum by the run that
    gave the chunks.  K1, K2 and K3 also carry ``tc_bound_ms`` (their two
    products over the int8 tensor-core rate, or the bytes if longer),
    ``table_bound_ms`` (the smaller of that and ``bound_ms``: the faster
    route's bound), both summed over the run, and ``matmul_backend_ms``,
    the port's ``closure_matmul`` on the costliest chunk."""
    from repro_torch.kernels import closure as k1
    from repro_torch.kernels import frontier as fk
    from repro_torch.kernels import serve as sk

    rate = int32_ops_per_s(device)
    specs = {
        "closure": (k1.closure, k1.closure_plain, "src/repro_torch/csrc/frontier.cu",
                    "src/repro/kernels/closure.py:99", closure_bound),
        "fused_step": (fk.fused_step, fk.fused_step_plain, "src/repro_torch/csrc/frontier.cu",
                       "src/repro/kernels/frontier.py:173", closure_bound),
        "map_closure": (fk.map_closure, fk.map_closure_plain,
                        "src/repro_torch/csrc/frontier.cu",
                        "src/repro/kernels/frontier.py:273", map_bound),
        "filter_step": (fk.filter_step, fk.filter_step_plain,
                        "src/repro_torch/csrc/frontier.cu",
                        "src/repro/kernels/frontier.py:341", filter_bound),
        "contains_topk": (sk.contains_topk, sk.contains_topk_plain,
                          "src/repro_torch/csrc/serve.cu",
                          "src/repro/kernels/serve.py:100", topk_bound),
        "rules_topk": (sk.rules_topk, sk.rules_topk_plain, "src/repro_torch/csrc/serve.cu",
                       "src/repro/kernels/serve.py:205", rules_bound),
    }
    out = []
    for name, (kern, plain, source, replaces, bound) in specs.items():
        tensor = name in ("closure", "fused_step", "map_closure")
        timed = []
        for label, args, kw in chunks[name]:
            ms = cuda_time_ms(lambda: kern(*args, **kw))
            ops, nbytes, census, shape = bound(args, kw)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_tc = max(tc_ops(args) / INT8_TENSOR_OPS_PER_S * 1e3, t_bytes) if tensor else None
            timed.append((ms, ops / rate * 1e3, t_bytes, label, args, kw, census, shape, t_tc))
        ms, t_ops, t_bytes, label, args, kw, census, shape, t_tc = max(timed, key=lambda t: t[0])
        got = kern(*args, **kw)
        err = require_equal(f"{name} on its costliest main-path chunk", got, plain(*args, **kw))
        plain_ms = cuda_time_ms(lambda: plain(*args, **kw))
        unqueued_ms = cuda_time_ms(lambda: kern(*args, **kw), queued=False)
        scalars = {"fused_step": 3, "filter_step": 2}.get(name)
        # K4: the parent's torch ops between K3 and K4 on the same chunks
        between = {} if name != "filter_step" else {
            "parent_between_ms": parent_between_ms(args, kw),
            "run_parent_between_ms": sum(parent_between_ms(a, k) for _, a, k in chunks[name]),
        }
        routes = {} if not tensor else {
            "tc_bound_ms": t_tc,
            "table_bound_ms": min(max(t_ops, t_bytes), t_tc),
            "matmul_backend_ms": matmul_backend_ms(name, args, kw, got),
            "run_tc_bound_ms": sum(t[8] for t in timed),
            "run_table_bound_ms": sum(min(max(t[1], t[2]), t[8]) for t in timed),
            "int8_tensor_ops_per_s": INT8_TENSOR_OPS_PER_S,
        }
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "unqueued_ms": unqueued_ms,
            "chunk": {"run": label, **shape,
                      "variant": {k: v for k, v in kw.items() if isinstance(v, bool)},
                      "scalars": list(args[scalars]) if scalars else None},
            "census_bound_ms": max(census / rate * 1e3, t_bytes),
            "run_launches": len(timed),
            "run_ms": sum(t[0] for t in timed),
            "run_bound_ms": sum(max(t[1], t[2]) for t in timed),
            "run_ms_by_run": {
                a: sum(t[0] for t in timed if t[3] == a) for a in dict.fromkeys(
                    t[3] for t in timed)
            },
            "int32_ops_per_s": rate,
            **routes,
            **between,
        })
    return out


def add_runs(launches: dict, chunks: dict, more_launches: dict, more_chunks: dict) -> None:
    """Add a phase's main-path launch counts and captured chunks to those of
    the phases before it, kernel by kernel."""
    for name, more in more_chunks.items():
        launches[name] = launches.get(name, 0) + more_launches[name]
        chunks[name] = chunks.get(name, []) + more


def run_dryrun_grid() -> dict:
    """Phase 22a: ``python -m repro_torch.launch.dryrun`` over DRYRUN_CELLS
    and the FCA cell, in a subprocess (the dry-run's fake group of 256
    ranks is that process's default group); its records, also written to
    ``build/dryrun/phase22.jsonl``.  Every applicable cell "ok", long_500k
    "skipped" on an attention-only arch."""
    import os

    from repro_torch.configs import get_config, get_shape
    from repro_torch.models.config import shape_applicable

    out = ROOT / "build" / "dryrun" / "phase22.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--fca", "--out", str(out)]
    for arch, shape in DRYRUN_CELLS:
        cmd += ["--cell", f"{arch}:{shape}"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    seconds = time.perf_counter() - t0
    records = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
    for rec in records:
        emit({"phase": "dryrun_cell", **rec})
    failures = []
    if r.returncode != 0:
        failures.append(f"dryrun exit {r.returncode}: {r.stderr[-3000:]}")
    if len(records) != len(DRYRUN_CELLS) + 1:
        failures.append(f"{len(records)} records for {len(DRYRUN_CELLS) + 1} cells")
    for (arch, shape), rec in zip(DRYRUN_CELLS, records):
        ok, _ = shape_applicable(get_config(arch), get_shape(shape))
        if rec.get("status") != ("ok" if ok else "skipped"):
            failures.append(f"{arch} {shape}: {rec.get('status')} {rec.get('error', '')[:500]}")
    if records and records[-1].get("status") != "ok":
        failures.append(f"fca cell: {records[-1]}")
    report = {"seconds": seconds, "cells": len(records), "file": str(out.relative_to(ROOT)),
              "summary": r.stderr.strip().splitlines()[-1:] if r.stderr else [],
              "failures": failures}
    emit({"phase": "dryrun_grid", **report})
    if failures:
        raise AssertionError("; ".join(failures))
    return report


def dryrun_prediction(name: str, rec: dict, totals, peak: int, before: int) -> dict:
    """A record of phase 22b: the dry-run's prediction against one real
    step's ``op_analysis`` totals and ``max_memory_allocated`` (``peak``;
    ``before``: allocated when the step began)."""
    mem = rec["memory_analysis"]
    predicted = mem["argument_bytes"] + mem["temp_bytes"]
    return {"name": name, "flops_predicted": rec["flops_per_device"],
            "flops_measured": totals.flops, "flops_by_op": dict(totals.flops_by_op),
            "collective_counts": dict(totals.coll_counts),
            "hbm_bytes_predicted": rec["hbm_bytes_per_device"],
            "hbm_bytes_measured": totals.hbm_bytes,
            "ops_predicted": rec["n_ops"], "ops_measured": totals.n_ops,
            "argument_bytes": mem["argument_bytes"], "temp_bytes": mem["temp_bytes"],
            "peak_predicted": predicted, "peak_measured": peak,
            "allocated_before": before, "temp_measured": peak - before,
            "peak_ratio": predicted / peak, "trace_s": rec.get("trace_s")}


def check_prediction(p: dict, failures: list) -> None:
    if p["flops_predicted"] != p["flops_measured"]:
        failures.append(f"{p['name']}: FLOPs predicted {p['flops_predicted']} against "
                        f"{p['flops_measured']} measured")
    if p["collective_counts"]:
        failures.append(f"{p['name']}: collectives on one rank {p['collective_counts']}")
    if not abs(p["peak_ratio"] - 1.0) <= DRYRUN_PEAK_TOL:
        failures.append(f"{p['name']}: predicted peak {p['peak_predicted']} against "
                        f"{p['peak_measured']} (ratio {p['peak_ratio']:.4f})")


def run_dryrun_prediction(device) -> tuple[dict, dict]:
    """Phase 22b: the dry-run's records of phase 20's train step and phase
    11's prefill (``dryrun_lib.run_cell`` on the 1 x 1 mesh over a one-rank
    NCCL group, fake tensors on the card's device type) against one real
    step of each, built anew at the same configuration, under
    ``op_analysis``: FLOPs equal, no collective, the train state's bytes
    within DRYRUN_STATE_TOL of the growth of ``memory_allocated`` when it is
    built, the peak within DRYRUN_PEAK_TOL.  Returns the report and the
    K7 / K7b launches of the real steps."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import make_batch_iterator
    from repro_torch.launch import dryrun_lib, op_analysis
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import Decoder
    from repro_torch.serve.engine import left_pad
    from repro_torch.train.optim import get_optimizer, warmup_cosine
    from repro_torch.train.step import batch_to, init_state, make_train_step

    t_phase = time.perf_counter()
    failures = []
    report = {}
    launches = {"blockwise_attention": 0, "attention_backward": 0}
    try:
        mesh = partition_mesh(device)
        # phase 20's train step
        cfg = dataclasses.replace(get_config(TRAIN_FULL_ARCH), n_layers=TRAIN_FULL_DEPTH)
        seq, bsz = TRAIN_FULL_SHAPE
        shape = ShapeConfig("train_4k_b1", "train", seq, bsz)
        rec = dryrun_lib.run_cell(TRAIN_FULL_ARCH, shape.name, mesh, "1x1", cfg=cfg,
                                  shape=shape)
        emit({"phase": "dryrun_train_record", **rec})
        if rec["status"] != "ok":
            raise AssertionError(f"train cell: {rec}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        model = Decoder(cfg, device=device, seed=LM_SEED)
        opt = get_optimizer("adamw", warmup_cosine(3e-4, 100, TRAIN_FULL_STEPS))
        state = init_state(model, opt)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - m0
        step = make_train_step(model, opt)
        it = make_batch_iterator(cfg, shape, seed=0)
        state, _ = step(state, batch_to(next(it)[1], device))  # warm: workspaces, kernels
        batch = batch_to(next(it)[1], device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        n0 = train_launches()
        (state, metrics), totals = op_analysis.analyze(step, state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        n1 = train_launches()
        for k in launches:
            launches[k] += n1[k] - n0[k]
        train = dryrun_prediction("train", rec, totals, peak, before)
        train.update(state_bytes_predicted=rec["state_bytes_per_device"],
                     state_bytes_measured=grown,
                     state_ratio=rec["state_bytes_per_device"] / grown,
                     loss=float(metrics["loss"]))
        check_prediction(train, failures)
        if not abs(train["state_ratio"] - 1.0) <= DRYRUN_STATE_TOL:
            failures.append(f"train: state {rec['state_bytes_per_device']} B predicted "
                            f"against {grown} B allocated")
        if n1["blockwise_attention"] - n0["blockwise_attention"] != 2 * TRAIN_FULL_DEPTH \
                or n1["attention_backward"] - n0["attention_backward"] != TRAIN_FULL_DEPTH:
            failures.append(f"train: K7 / K7b launches {n0} -> {n1}")
        report["train"] = train
        del model, opt, state, batch, it, metrics, step
        gc.collect()
        torch.cuda.empty_cache()

        # phase 11's prefill: its four prompts left-padded to the longest
        cfg = get_config(LM_FULL_ARCH)
        rng = np.random.default_rng(LM_SEED)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in LM_FULL_PROMPTS]
        toks, valid_from = left_pad(prompts, len(prompts))
        shape = ShapeConfig("prefill_full", "prefill", toks.shape[1], len(prompts))
        rec = dryrun_lib.run_cell(LM_FULL_ARCH, shape.name, mesh, "1x1", cfg=cfg, shape=shape)
        emit({"phase": "dryrun_prefill_record", **rec})
        if rec["status"] != "ok":
            raise AssertionError(f"prefill cell: {rec}")
        model = Decoder(cfg, device=device, seed=LM_SEED)
        tokens = torch.from_numpy(toks).to(device)
        vf = torch.from_numpy(valid_from).to(device)
        with torch.inference_mode():
            model.prefill(tokens, model.init_caches(*toks.shape), vf)  # warm
            caches = model.init_caches(*toks.shape)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            k0 = fa_launches()
            (logits, caches), totals = op_analysis.analyze(model.prefill, tokens, caches, vf)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            k1 = fa_launches()
        launches["blockwise_attention"] += k1 - k0
        prefill = dryrun_prediction("prefill", rec, totals, peak, before)
        prefill["logits_finite"] = bool(torch.isfinite(logits).all())
        check_prediction(prefill, failures)
        if not prefill["logits_finite"] or k1 - k0 != cfg.n_layers:
            failures.append(f"prefill: finite {prefill['logits_finite']}, K7 {k1 - k0}")
        report["prefill"] = prefill
        del model, caches, logits, tokens
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        close_partition_group()
    report["seconds"] = time.perf_counter() - t_phase
    report["failures"] = failures
    emit({"phase": "dryrun_prediction", **report})
    if failures:
        raise AssertionError("; ".join(failures))
    return report, launches


def fa_launches() -> int:
    from repro_torch.kernels import flash_attention as fa

    return fa.blockwise_attention.launches


def run_examples(device) -> tuple[dict, dict]:
    """Phase 22c: the three FCA examples in this process on the card
    (EXAMPLE_ARGS), their printed lines (``example_lines``) equal to the
    reference examples' (EXAMPLES_EXPECTED), each kernel of EXAMPLE_KERNELS
    launched.  Returns the report and the launches by kernel."""
    import importlib.util
    import io

    from repro_torch import kernels

    report, failures, total = {}, [], {}
    for stem, kwargs in EXAMPLE_ARGS.items():
        spec = importlib.util.spec_from_file_location(stem, ROOT / "examples" / f"{stem}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        kernels.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(device=str(device), **kwargs)
        seconds = time.perf_counter() - t0
        print(buf.getvalue(), end="", flush=True)
        launches = {k.__name__: k.launches for k in kernels.KERNELS if k.launches}
        lines = example_lines(buf.getvalue())
        same = lines == EXAMPLES_EXPECTED[stem]
        missing = [k for k in EXAMPLE_KERNELS[stem] if not launches.get(k)]
        report[stem] = {"seconds": seconds, "lines_equal": same, "launches": launches,
                        "missing_kernels": missing}
        if not same:
            diff = [(a, b) for a, b in zip(lines, EXAMPLES_EXPECTED[stem]) if a != b]
            failures.append(f"{stem}: lines differ from the reference's "
                            f"({len(lines)} against {len(EXAMPLES_EXPECTED[stem])}): {diff[:3]}")
        if missing:
            failures.append(f"{stem}: {missing} not launched ({launches})")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    report["failures"] = failures
    emit({"phase": "examples", **report})
    if failures:
        raise AssertionError("; ".join(failures))
    return report, total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # float32 products in full float32 (the K7 float32 tolerance and the
    # reduced LM configs' exact tokens assume it): no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": {k: v["seconds"] for k, v in built.items()}})
    for name in _build.SOURCES:
        print(f"ptxas {name}: {_build.ptxas_report(name)}", flush=True)
    # K7's bf16 body and K1/K2/K3's tensor-core body, from the report of the
    # library in use (built now or before): registers, and no stack frame,
    # spill stores or spill loads in any instantiation
    bodies = {kernel: body_ptxas(_build.ptxas_report(source), kernel)
              for kernel, (source, _) in PTXAS_BODIES.items()}
    emit({"phase": "ptxas", **bodies})
    for kernel, body in bodies.items():
        if len(body) != PTXAS_BODIES[kernel][1]:
            raise AssertionError(f"the ptxas report holds {len(body)} instantiations of "
                                 f"{kernel}, not {PTXAS_BODIES[kernel][1]}")
        spilled = [n for n, r in body.items()
                   if r["stack"] or r["spill_stores"] or r["spill_loads"]]
        if spilled:
            raise AssertionError(f"stack or spills in {spilled}")

    t0 = time.perf_counter()
    records = (check_kernels(device) + check_sharded_kernels(device)
               + check_filter_kernel(device) + check_device_counts(device)
               + check_tc_kernels(device)
               + check_serve_kernels(device) + check_contains_split(device)
               + check_rules_split(device) + check_attention_kernel(device)
               + check_attention_edges(device))
    emit({"phase": "kernels", "cases": len(records), "seconds": time.perf_counter() - t0,
          "by_kernel": {k: sum(r["kernel"] == k for r in records)
                        for k in dict.fromkeys(r["kernel"] for r in records)},
          "bit_exact": "K1-K6",
          "device_count_cases": {k: sum(r["kernel"] == k for r in records
                                        if r.get("count") == "device")
                                 for k in ("fused_step", "filter_step")},
          "tc_edge_cases": {
              k: sum(r["kernel"] == k for r in records if r.get("tc_edge"))
              for k in ("closure", "map_closure", "fused_step")},
          "split_edge_cases": {k: sum(r["kernel"] == k for r in records if r.get("split_edge"))
                               for k in ("contains_topk", "rules_topk")},
          "k7_tolerance": K7_TOL,
          "k7_max_abs_err": {d: max((r["max_abs_err"] for r in records
                                     if r.get("dtype") == d), default=None) for d in K7_TOL},
          "k7_bf16_row_rel_err": max(r.get("row_rel_err", 0.0) for r in records),
          "k7_bf16_by_S": {S: {"max_row_rel_err": max(r["row_rel_err"] for r in recs),
                               "max_abs_err": max(r["max_abs_err"] for r in recs),
                               "min_rms": min(r["rms"] for r in recs)}
                           for S in K7_GEMMA_S
                           for recs in [[r for r in records if r.get("dtype") == "bfloat16"
                                         and r.get("hd") == 256 and r.get("S") == S
                                         and not r.get("edge")]]},
          "k7_edge_cases": {k: sum(r["kernel"] == k for r in records if r.get("edge"))
                            for k in ("flash_attention", "blockwise_attention")},
          "k7_edge_max_row_rel_err": max(r.get("row_rel_err", 0.0) for r in records
                                         if r.get("edge"))})

    t0 = time.perf_counter()
    _, launches, chunks, main_intents = run_main_path(device)
    emit({"phase": "main_path_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    multi_report, _, multi_launches, multi_chunks = run_multi_shard_path(device)
    emit({"phase": "multi_shard_seconds", "seconds": time.perf_counter() - t0,
          "launches": multi_launches})
    add_runs(launches, chunks, multi_launches, multi_chunks)
    t0 = time.perf_counter()
    _, cand_launches, cand_chunks = run_cand_path(device, main_intents, multi_report)
    check_row_off(cand_chunks)
    for name, n in cand_launches.items():  # the 2-D runs' launches, their chunks untimed
        launches[name] += n
    emit({"phase": "cand_path_seconds", "seconds": time.perf_counter() - t0,
          "launches": cand_launches})
    emit({"phase": "gc_pauses", "timed_runs": len(GC_PAUSES),
          "runs_with_gen12": [r for r in GC_PAUSES if r["gc_ms"][1] + r["gc_ms"][2] > 0]})
    t0 = time.perf_counter()
    run_full_lattices(device)
    emit({"phase": "full_lattice_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    _, serve_chunks, serve_launches, served = run_serve_phase(device, main_intents)
    emit({"phase": "serve_seconds", "seconds": time.perf_counter() - t0})
    add_runs(launches, chunks, serve_launches, serve_chunks)
    t0 = time.perf_counter()
    run_tracing_phase(device, main_intents)
    emit({"phase": "tracing_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    _, async_launches = run_async_path(device, main_intents)
    for name, n in async_launches.items():  # the async runs' launches, their chunks untimed
        launches[name] += n
    emit({"phase": "async_path_seconds", "seconds": time.perf_counter() - t0,
          "launches": async_launches})
    t0 = time.perf_counter()
    _, rules_chunks, launches["rules_topk"], rules_served = run_rules_phase(device)
    emit({"phase": "rules_seconds", "seconds": time.perf_counter() - t0})
    chunks.update(rules_chunks)
    t0 = time.perf_counter()
    _, load_launches = run_load_phase(device, served, rules_served)
    for name, n in load_launches.items():  # the load runs' launches, their chunks untimed
        launches[name] = launches.get(name, 0) + n
    emit({"phase": "load_seconds", "seconds": time.perf_counter() - t0,
          "launches": load_launches})
    t0 = time.perf_counter()
    _, analysis_launches = run_analysis_phase(device)
    for name, n in analysis_launches.items():  # the sweep's and the recorded runs' launches
        launches[name] = launches.get(name, 0) + n
    emit({"phase": "analysis_seconds", "seconds": time.perf_counter() - t0,
          "launches": analysis_launches})
    t0 = time.perf_counter()
    _, reduced_k7 = run_lm_reduced(device)
    emit({"phase": "lm_reduced_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    _, k7 = run_lm_full(device)
    emit({"phase": "lm_full_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    _, families_k7 = run_lm_families(device)
    emit({"phase": "lm_families_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    k7b_records = check_attention_backward(device)
    emit({"phase": "attention_backward", "cases": len(k7b_records),
          "seconds": time.perf_counter() - t0, "tolerance": K7B_TOL, "min_cos": K7B_MIN_COS,
          "records": k7b_records})
    t0 = time.perf_counter()
    _, reduced_train = run_train_reduced(device)
    emit({"phase": "train_reduced_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    _, full_train = run_train_full(device)
    emit({"phase": "train_full_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    try:
        _, partition = run_partition_phase(device, PARTITION_EP)
    finally:
        close_partition_group()
    emit({"phase": "partition_seconds", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    run_dryrun_grid()
    _, dryrun_launches = run_dryrun_prediction(device)
    _, example_launches = run_examples(device)
    for name, n in example_launches.items():  # the examples' launches, their chunks untimed
        if name not in ("blockwise_attention", "attention_backward", "flash_attention"):
            launches[name] = launches.get(name, 0) + n
    emit({"phase": "dryrun_seconds", "seconds": time.perf_counter() - t0,
          "launches": {**example_launches, **dryrun_launches}})
    # K7's launches: phase 10's prefills, phase 11's and phase 17's kernel
    # runs, phases 19's and 20's train steps (the forward and the
    # backward's recompute) and phase 21's prefills and train steps
    k7["launches_by_phase"] = {"10": reduced_k7, "11": k7["launches"], "17": families_k7,
                               "19": reduced_train["blockwise_attention"],
                               "20": full_train["blockwise_attention"],
                               "21": partition["blockwise_attention"],
                               "22": dryrun_launches["blockwise_attention"]}
    k7["launches"] = sum(k7["launches_by_phase"].values())
    k7b = time_attention_backward(
        device, reduced_train["attention_backward"] + full_train["attention_backward"]
        + partition["attention_backward"] + dryrun_launches["attention_backward"], k7b_records)
    k7b["launches_by_phase"] = {"19": reduced_train["attention_backward"],
                                "20": full_train["attention_backward"],
                                "21": partition["attention_backward"],
                                "22": dryrun_launches["attention_backward"]}
    emit({"kernels": time_kernels(device, launches, chunks) + [k7, k7b]})

    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
