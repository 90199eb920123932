#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each (seconds on an H100 in brackets):

  1. build    -- compile the kernels in ``src/repro_torch/kernels/csrc`` with
                 nvcc for sm_90a (one process per source, in parallel) [~8].
  2. kernels  -- each kernel against its plain PyTorch version on the card,
                 at the main paths' shapes and at ragged ones, then timed
                 with CUDA events beside its plain version, its bound and
                 (where one exists) a single PyTorch call computing the same
                 function (plane_scores, gram and viterbi_decode, and the
                 PyTorch calls, also with the host out of the loop:
                 graph_ms replays the calls captured in one CUDA graph):
                 plane_scores, viterbi_decode (both launch plans, staged
                 and scratch), plane_select, moe_ffn, flash_attention,
                 gram, and approx_pass (one whole approximate pass per
                 launch, both modes, against the eager per-block loop;
                 the plain mode's gap output build too),
                 viterbi_decode also at serving rounds' shapes (8 rows of
                 a bucket with tails of 0-3 masked steps, 2 of them
                 filler rows) and timed at (8, 16, 26) and (8, 32, 5),
                 each with the launch plan it chose; plane_select at
                 three densities (the path's 2/64, half, all valid) and
                 at k = 64 and 512 rows, each held bit for bit against
                 plane_scores and against 50 relaunches, timed by
                 graph_ms and the event loop beside the two-step addmv
                 + mask + amax/argmax, each with its bound from its
                 valid count; flash_attention also at the trainer's
                 shape and at the four lm_configs' prefill shapes
                 [~70; plane_select ~10].
  3. parity   -- a short Solver run of the port on the card against the same
                 run on the CPU (plain versions), on the CI-sized OCR
                 scenario.
  4. main     -- the main path: Solver + mpbcfw on the full-size OCR chain
                 scenario (n=6877, f=128, C=26, d=4004, cap=64), 3 outer
                 iterations of up to 8 approximate passes, each pass one
                 approx_pass launch gated on the device, the exact pass one
                 replay of a captured CUDA graph per block, one host sync
                 per iteration, with every kernel launch counted (a
                 replay adds the launches its capture counted) [~15].
  5. profile  -- where the main path's time goes: an exact-pass window
                 (one replay of the engine's captured block step per
                 block: host ms to enqueue a block, replays per block, the
                 device span between CUDA events against the profiler's
                 summed kernel time, viterbi_decode's device us per block
                 from the trace) and one whole approximate pass on the
                 trained state, timed plain and then under torch.profiler
                 (device busy share, kernels per block step, device time
                 by kernel); the pass kernel's full-pass ms and us per
                 block beside the eager loop's, with its plan [~15].
  5b. obs     -- main again with a RunRecorder (repro_torch.obs): a fresh
                 mpbcfw at main's settings and seed, every recorder
                 callback under torch.cuda.set_sync_debug_mode("error");
                 rows bit-equal to main's, launch counts equal, the JSONL
                 schema-valid, its summary one sync and one dispatch per
                 iteration within budget, its Chrome-trace export written;
                 the recorder's host ms per iteration beside main's
                 seconds per iteration [~4].
  5c. obs_wall -- the same run in wall mode with approx_batch 2 and at
                 most 8 passes, 2 iterations from the wall-mode defaults
                 reported first, then 3 from profile's measured
                 constants, checked: one sync and one measured segment per
                 dispatch, the Solver's slope-rule constants the
                 recorder's fit of the segments, measured approx_passes
                 spans for the continuations, each iteration's phase spans
                 tiling its outer_iteration span; the fitted (exact_cost,
                 plane_cost) beside profile's exact and approximate pass
                 [~6].
  6. parity_async  -- mpbcfw-async on the card against the CPU on the
                 CI-sized OCR scenario, with the same straggler mask.
  7. main_async    -- the pipelined path: Solver + mpbcfw-async on the
                 full-size OCR scenario, 3 outer iterations, oracle
                 arrivals from repro_torch.ft (stragglers fold their cached
                 fallback), launch counts reset just before, read just after
                 [~10].
  8. profile_async -- the fold alone (one replay per folded block: host
                 ms per block, replays per block, busy share), then the
                 fold, 2 gated passes and the side-stream oracle program
                 on the trained state: each stream's device time and the
                 microseconds in which kernels of the two streams ran at
                 once; plane_select where the fold calls it
                 (fallback_planes), over 512 and over all pending rows of
                 the trained state: valid slots read, graph_ms, event-loop
                 ms, bound and plan [~6].
  9. parity_gram -- mpbcfw-gram (the Sec-3.5 multi-step scheme) on the
                 card against the CPU on the CI-sized OCR scenario.
 10. main_gram -- mpbcfw-gram on the full-size OCR scenario (cap=64,
                 gram_steps=10) at the main cell's settings (3 outer
                 iterations of up to 8 passes), launch counts reset just
                 before; then the gram kernel recomputes every block's Gram
                 matrix and the cache's incrementally kept leaf is held
                 against it; profile_gram reads B1's device us per exact
                 block from a traced exact window, and times a whole gram
                 pass (ms, us per block, plan) and the eager recurrences
                 [~60].
 11. resume   -- mpbcfw-gram on the card, CI-sized OCR: 2 iterations, save,
                 restore, 2 more, bit for bit against 4 uninterrupted ones.
 11b. obs_checkpoint -- SMALL ocr, a recorded mpbcfw run saves after 2
                 iterations, a recorded restore resumes it:
                 checkpoint_save/checkpoint_restore spans, the manifest's
                 metrics the registry snapshot, the restored snapshot
                 equal; then 2 iterations under RunRecorder(profile=True)
                 inside torch.profiler, one outer_iteration range each
                 [~5].
 11c. parity_shard -- the shard engines (repro_torch.shard) at world
                 size 1, card (an NCCL mesh) against CPU (gloo): every
                 mpbcfw-shard* engine and mpbcfw-gram/mpbcfw-gap with a
                 mesh on SMALL ocr, mpbcfw-shard and -shard-tau on usps
                 and horseseg; schedules, collectives and bytes equal,
                 objectives within rtol 1e-4 [~17].
 11d. main_shard -- main's run under mpbcfw-shard: rows bit-equal to
                 main's, launch counts equal, 1 + passes all-reduces
                 charged per iteration (1 + 8 enqueued), every engine
                 dispatch under sync-debug "error"; an all-reduce's
                 device events and ms by CUDA events [~8].
 11e. main_shard_tau -- full OCR under mpbcfw-shard-tau at tau = 23 (299
                 chunks): B3 at B = 23 and B2 on 23 rows per chunk, the
                 fold's steps graph replays; B3 and B2 at those shapes by
                 graph_ms beside their bounds; a tau-nice epoch's seconds
                 beside a sequential exact pass's [~10].
 11f. main_shard_gram -- main_gram's run under mpbcfw-shard-gram: rows
                 bit-equal to main_gram's, launch counts equal [~8].
 11g. shard_stride -- approx_pass at k_stride 2 and 4 over 2 and 4 rank
                 slices of the trained states (plain and Sec-3.5),
                 recombined as the engine does, against its plain
                 version; the stride-1 pass over all blocks by CUDA
                 events beside its bound [~10].
 11h. resume_shard -- a world-size-1 sharded checkpoint (SMALL ocr):
                 restore_resharded gives the saved state, the run resumes
                 bit for bit, and its files resume mpbcfw [~5].
 11i. contracts -- the program-contract checker (repro_torch.analysis)
                 in process, --strict --device cuda: all 14 engines (the
                 mesh-optional two also on the NCCL mesh) and the 3
                 serving trace cases, each dispatch counted and run under
                 sync-debug "error", plus the port's AST lint; the
                 report must be ok; each engine's and serve case's
                 syncs, collectives, programs and kernel launches, and
                 the path's launches (counts set to 0 just before the
                 checker, read just after) [~1].
 12. parity_specs -- the multiclass and graph scenarios (SMALL usps and
                 horseseg), mpbcfw on the card against the CPU.
 13. parity_lm -- the LM substrate on the card against the port on the
                 CPU: reduced OLMoE in float32, same weights and tokens;
                 backbone features, one decode step's logits, and a
                 3-iteration SSVM-head Solver run.
 13b. parity_simple -- the engines fw, ssg, bcfw, bcfw-avg and mpbcfw-avg
                 (one program per outer iteration, and MP-BCFW reporting the
                 averaged primal), SMALL ocr on the card against the CPU:
                 the same schedule and sync counts, objectives within rtol
                 1e-4 (ssg has no dual: NaN on both) [~15].
 13c. main_bcfw, main_ssg, main_fw -- bcfw-avg, ssg and fw on the
                 full-size OCR scenario, 3 outer iterations each through the
                 Solver: one dispatch and one host sync per iteration, B3
                 at B=1 once per exact step (bcfw, ssg: one graph replay
                 per block) or at B=n once per iteration (fw), approx_pass
                 never [~4, ~3, ~1].
 13c'. parity_gap -- mpbcfw-gap (the policy layer: gumbel-top-k schedule
                 on the device, gap-aware eviction, the gap vector written
                 by the exact step and by approx_pass), 4 iterations on
                 SMALL ocr, usps and horseseg, card against CPU with the
                 port's noise: schedules, gap_sampled equal, duals,
                 primals and gap_total within rtol 1e-4; then approx_pass
                 with and without its gap output on a trained state:
                 every other output bit-equal, the gap within 3e-5
                 (|s| + |s_i|) + 64 float32 ulps of the two scores' sum
                 of |terms| of the plain version's, and a zeroed or a
                 stale gap vector failing that check [~15].
 13c''. main_gap -- mpbcfw-gap on the full-size OCR scenario with the
                 reference's defaults, 4 iterations of up to 8 passes:
                 3438 exact blocks per iteration (one graph replay each),
                 iteration 1 the blocks 0..3437 in order, every sampled
                 schedule equal to the CPU's for its gap vector and seed;
                 seconds, n_exact, gap_sampled, gap_total and passes per
                 iteration; approx_pass with its gap output over a full
                 pass of the trained state against the plain version (as
                 in parity_gap, at the main path's shape), its ms per
                 pass with and without the gap output beside main's, the
                 schedule's device ms, an exact window's device ops and
                 B3 us per block [~25].
 13d. wide    -- ROADMAP C6: approx_pass's wide plan (phi and the average
                 in device memory) against the eager pass at d = 20,505 and
                 25,625 in both modes, plain cap 4096 and Sec-3.5 cap 512;
                 then mpbcfw and mpbcfw-gram train 3 iterations on a chain
                 of n=512, f=5120, C=5 (d = 25,625, the SSVM head's width
                 over Mistral-NeMo-12B and Qwen2.5-14B), each with its ms
                 per full wide pass beside its bound [~30].
 13e. serve   -- structured serving of the model ``main`` trained (its
                 weights exported by Solver.servable() right after the
                 3 iterations): saved, loaded onto the card, and all 6877
                 training examples, trimmed to their lengths, served by
                 StructuredServer in rounds of 8 (buckets 4/8/12/16, one
                 captured CUDA graph each, one replay, dispatch and sync
                 per round, B3 once per round), every labeling held to the
                 per-example decode; requests/s, labels/s, latency
                 quantiles, peak memory [~8].
 13e'. serve_obs -- the same model and requests served with a RunRecorder:
                 labels equal to serve's, serve_round spans = rounds = B3
                 launches, one serve_request event per request, the file
                 schema-valid, callbacks under sync-debug "error"; ms per
                 round without and with the recorder on one warmed engine
                 [~8].
 13f. serve_usps, serve_horseseg -- serving at full usps width (n=7291,
                 f=256, C=10; every request held to the per-example
                 decode) and full horseseg width (16x16 lattices, f=649,
                 40 ICM sweeps; n cut to 512, a seeded sample of 256
                 held), random weights as benchmarks/serving_bench.py
                 makes them [~20].
 14. main_lm  -- OLMoE-1B-7B at its published width (16 layers, d_model
                 2048, 64 experts top-8, random weights from a seed): the
                 Server answers 8 requests, then the SSVM head trains on
                 backbone features of the example's tagging task (n=1024,
                 L=32, 5 tags), each with launch counts reset just before
                 and read just after [~15]; routing holds the first and
                 last MoE layers' routing at full width, card against CPU
                 [~5]; then profile_lm traces 8 decode rounds and one
                 feature pass (device busy share, device time by kernel);
                 last, serve_lm serves the trained head over its 1024
                 sequences, B3 at (8, 32, 5) once per round, every
                 labeling held to the per-example decode [~3].  The
                 serving phases run after the OCR training paths.
 14b. train_lm -- LM training through repro_torch.launch.train.train_lm:
                 qwen2-0.5b at its published width and depth (24 layers,
                 d 896, vocab 151,936, bf16 weights from seed 0), 30 steps
                 of 8 x 128 tokens: a finite loss every step, the last
                 below the first, flash_attention launched 24 x 30 times
                 (its backward recomputed in torch), moe_ffn never; then
                 a fresh state's steady steps (one under sync-debug
                 "error"): ms per step, tokens/s, peak memory, busy share
                 and device time by kernel, beside the FLOP bound 6 N
                 tokens / 989 TFLOP/s; ms per step and peak memory under
                 remat_policy "none" and the default "nothing" (whose
                 backward runs each layer's forward again: B5 twice per
                 layer and step) [~35].
 14c. lm_grad -- one full-width step's gradients, leaf by leaf, with the
                 flash kernel in the forward and with the chunked forward,
                 each against the fp32 gradient; reduced qwen2-0.5b,
                 OLMoE-1B-7B, deepseek-v3-671b (MLA through B5's fp32
                 path, MTP in the loss) and internvl2-76b (the vision
                 stub) in fp32, card against CPU, rel. L2 <= 1e-3;
                 reduced zamba2-7b (with and without its window),
                 xlstm-125m and whisper-base likewise at <= 1e-5;
                 reduced qwen2-0.5b, deepseek-v3-671b and zamba2-7b (its
                 window) at attn_score_dtype "bf16" (the bf16-score
                 builds) card against CPU at <= 2e-2; reduced qwen2-0.5b
                 under each remat policy card against CPU at <= 1e-5
                 and against the card's "none" at <= 1e-6 [~12].
 14d. lm_resume -- reduced qwen2-0.5b, 10 steps saving every 5; a fresh
                 run resumed from step 5 gives the same losses [~5].
 14e. train_ssvm -- train_ssvm on SMALL usps, ocr, horseseg, card
                 against CPU, rtol 1e-4 [~10].
 14f. examples -- the five repro_torch.examples main()s on the card at
                 their reference sizes (lm_train at 30 steps), launches
                 read [~15].
 14g. main_mla -- deepseek-v3-671b at its published width (MLA with q/k
                 head dim 192 and v 128, 256 experts top-8, the dense
                 layers, the MTP block's weights), depth cut from 61 to 4
                 (its 3 dense layers, 1 MoE layer), bf16 weights from
                 seed 0: the Server answers 8 requests (absorbed MLA
                 decode, moe_ffn once per round, flash_attention never),
                 then a prefill of 2 x 1024 tokens (flash_attention's MLA
                 build once per layer, each call held to the plain
                 attention on its own inputs, moe_ffn once), then B5's
                 MLA build at (2, 1024, 128, 192/128) and moe_ffn at
                 (256, {1, 64}, 7168, 2048) against their plain versions,
                 timed; the prefill again at attn_score_dtype "bf16"
                 (lm_score_bf16: the MLA build's bf16-score build once per
                 layer, its first call held to plain) [~5].
 14h. lm_configs -- internvl2-76b (256 stub vision tokens), minitron-8b,
                 mistral-nemo-12b and qwen2.5-14b at published width,
                 depth 2: a prefill of 2 x 1024 tokens each
                 (flash_attention twice, logits finite; the kernels phase
                 holds B5 at each config's (2, 1024, H:K, 128) to its
                 plain version and times it), each again at
                 attn_score_dtype "bf16" (lm_score_bf16) [~3].
 14i. kernel (flash_attention_masks) -- B5's builds of the last three
                 families held to its plain version in bf16 and fp32 and
                 timed beside its bound and SDPA: head dim 112 (the padded
                 128 build) causal at zamba2's (2, 1024, 32:32, 112), the
                 window build at (1, 8192, 32:32, 112) with W = 4096 and
                 at (1, 2048) with W = 1000 and 1, the bidirectional build
                 at whisper's encoder (2, 1500, 8:8, 64) [~10].
 14j. main_hybrid -- zamba2-7b at its published width and depth (81
                 layers, 6.75 B parameters, bf16 from seed 0): the Server
                 answers 8 requests (plain decode, B5 never), a prefill
                 of 2 x 1024 tokens (B5's causal build 13 times, once per
                 shared-block invocation), then 1 x 8192 tokens under the
                 long-context override (the window build 13 times), the
                 first B5 call of each prefill held to its plain version;
                 each prefill and 4 more serving rounds traced (busy
                 share, device time by kernel; 2 rounds), as in the two
                 phases below (xlstm's prefill traced on 2 x 256 tokens)
                 [~15-40].
 14k. lm_xlstm -- xlstm-125m at published width and depth: the Server
                 answers 8 requests, a prefill of 2 x 1024 tokens, no
                 kernel launched (none is on this path); float32 prefill
                 logits on 2 x 256 tokens, card against CPU [~5-15].
 14l. lm_whisper -- whisper-base at published width and depth: a prefill
                 of 2 x (1500 frames, 448 tokens) (B5 bidirectional 6
                 times, causal 6 times, one call of each held to its
                 plain version), then the Server answers 8 requests
                 against the zero cross-attention cache [~3-10].
 14m. kernel (flash_attention_score_bf16) -- B5's bf16-score builds
                 (each score rounded to bf16 after the product and after
                 the bf16 scale) at qwen2.5-14b's (2, 1024, 40:8, 128),
                 deepseek-v3's MLA (2, 1024, 128, 192/128) and zamba2's
                 window W = 4096 at (1, 8192, 32:32, 112): held to plain,
                 to their emulated roundings at S = 50, timed beside the
                 fp32-score build, the bound and SDPA [~8].
 14n. host_mesh -- make_host_mesh() on the card: 1 x 1 ('data', 'model')
                 [~1].
 14o. dryrun -- python -m repro_torch.launch.dryrun on qwen2-0.5b,
                 olmoe-1b-7b and xlstm-125m train_4k and zamba2-7b
                 prefill_32k over a fake 256-rank (16, 16) mesh, one
                 process each, side by side, on the host: ok,
                 collectives counted, per-device FLOPs between the
                 model's and the reference's, within 5 % of a CPU
                 host's torch 2.13 count, by op class and collectives by
                 kind; every cell's temporaries at or under the
                 reference compile's, bytes accessed and temporaries
                 printed [~0-60 of waiting on xlstm-125m's trace].
 15. sync_debug line (the paths whose every engine dispatch ran under
     sync-debug "error": main, main_async (both programs), main_gram,
     main_shard, main_shard_tau, main_gap, one train_lm step, and the
     dispatches checked on each, later phases' dispatches of the same
     engine included), the
     kernels line (flash_attention's row also carries its MLA shape,
     the four configs' shapes, the new builds' cases, the bf16-score
     builds' cases and its launches by build on the last three families'
     paths; moe_ffn's the deepseek
     shapes), the
     card's name and power limit, and the result line
     ``{"ok": true, "device": {...}}`` last.

Any failed check raises, so the script exits non-zero and prints no result
line.  It needs a CUDA device and the repository's ``src`` tree beside it.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# The host processes that run beside the card's phases (the dry-run's
# CLI, :func:`start_dryrun`), and the seconds :func:`background_paused`
# has held them stopped.
BACKGROUND = {"procs": [], "paused_s": 0.0}
TOL = 3e-5                      # kernel vs plain: |err| <= TOL*(1+|ref|)
REPEATS = 20                    # approx_pass relaunches that must agree
# A pass's gap output vs the plain version's: |err| <= 3e-5 (|s| + |s_i|)
# + GAP_ULPS 2^-24 T, T the two scores' dots' sum of |terms| (their
# float32 rounding scale; the gap is their difference).
GAP_ULPS = 64
GAP_TOL = (f"gap output |err| <= 3e-5 (|s| + |s_i|) + {GAP_ULPS} 2^-24 T, T "
           "the two scores' sum of |terms|")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, data sheet
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12             # H100 SXM bf16 tensor cores, dense
BF16_REL_L2 = 2e-2              # kernel vs plain at bf16 (they round apart)

# The full-size OCR chain scenario (configs/paper.py::OCR) and the run.
OCR = dict(n=6877, f=128, num_labels=26, mean_len=8, max_len=14, seed=0)
RUN = dict(algo="mpbcfw", cap=64, ttl=10, max_iters=3, approx_batch=8,
           max_approx_passes=8)
RUN_ASYNC = dict(RUN, algo="mpbcfw-async")
# The Sec-3.5 path at the main cell's settings: up to 8 gram passes per
# iteration, so the slope rule decides on this engine at full size.
RUN_GRAM = dict(RUN, algo="mpbcfw-gram", gram_steps=10)
# The gap engine with the reference's defaults (gap_frac 0.5, temperature
# 2.0, floor 0.1), one iteration more: iteration 1 sweeps half the blocks.
RUN_GAP = dict(RUN, algo="mpbcfw-gap", max_iters=4)
ORACLE_COST, PLANE_COST = 0.3, 1e-4
# The shard engine at world size 1 on the card (an NCCL mesh): main's run
# under mpbcfw-shard, tau = 23 under -shard-tau (6877 = 13 x 23^2: 299
# chunks of 23), main_gram's under -shard-gram.
RUN_SHARD = dict(RUN, algo="mpbcfw-shard")
RUN_SHARD_TAU = dict(RUN, algo="mpbcfw-shard-tau", tau=23)
RUN_SHARD_GRAM = dict(RUN_GRAM, algo="mpbcfw-shard-gram")
# Card vs CPU at world size 1 (scenario, engine, RunConfig fields over
# small_run's).  The pipelined engine runs one pass per iteration: from
# its second iteration its dual stalls, and the slope rule's stop turns
# on the last bits of the card's and the CPU's sums (ROADMAP's quirks).
SHARD_PARITY = (("ocr", "mpbcfw-shard", {}), ("ocr", "mpbcfw-shard-avg", {}),
                ("ocr", "mpbcfw-shard-tau", {"tau": 8}),
                ("ocr", "mpbcfw-shard-gram", {}), ("ocr", "mpbcfw-gram", {}),
                ("ocr", "mpbcfw-gap", {}),
                ("ocr", "mpbcfw-shard-async",
                 {"approx_batch": 1, "max_approx_passes": 1}),
                ("usps", "mpbcfw-shard", {}),
                ("usps", "mpbcfw-shard-tau", {"tau": 8}),
                ("horseseg", "mpbcfw-shard", {}),
                ("horseseg", "mpbcfw-shard-tau", {"tau": 8}))
# approx_pass at k_stride S over S rank slices of the trained states: the
# first blocks of main_shard's (plain) and main_shard_gram's (Sec-3.5).
STRIDE_RANKS = (2, 4)
STRIDE_BLOCKS = {"plain": 2048, "sec35": 256}
GRAM_RTOL, GRAM_ATOL = 3e-5, 3e-4  # |err| <= RTOL |p_a| |p_b| + ATOL

# The LM paths: OLMoE-1B-7B serving, and the SSVM head on its features.
LM_ARCH = "olmoe-1b-7b"
SERVE = dict(slots=4, max_seq=256, requests=8, prompt_len=4, max_new=16)
HEAD = dict(n=1024, L=32, tags=5)
# The example's RunConfig (cap=16, CostModel(oracle_cost=0.5)) with depth
# cut to fit the smoke: 3 outer iterations, at most 8 approximate passes.
HEAD_RUN = dict(algo="mpbcfw", max_iters=3, cap=16, approx_batch=8,
                max_approx_passes=8)
HEAD_ORACLE_COST = 0.5

# LM training (repro_torch.launch.train): qwen2-0.5b at its published width
# and depth, bf16 weights from seed 0; the reduced configs for the
# gradient parity and the resume.
TRAIN = dict(arch="qwen2-0.5b", steps=30, batch_size=8, seq_len=128)
TRAIN_PROFILED_STEPS = 3
# A bf16 gradient's distance from the fp32 one (relative L2, per leaf):
# the kernel path's at most 1.25x the chunked path's, + 1e-3.
GRAD_NOISE_RATIO, GRAD_NOISE_ATOL = 1.25, 1e-3
GRAD_RTOL = 1e-3                # card vs CPU in fp32, per leaf (rel. L2)
# The reduced configs held card against CPU: dense, MoE, MLA + MTP, VLM.
GRAD_ARCHS = ("qwen2-0.5b", "olmoe-1b-7b", "deepseek-v3-671b",
              "internvl2-76b")
RESUME = dict(steps=10, save_every=5, batch_size=8, seq_len=32)
EXAMPLES = ("quickstart", "sequence_labeling", "segmentation_distributed",
            "ssvm_head", "lm_train")

# The rest of the transformer family at published width, depth cut: the
# MLA + MoE + MTP config at 4 layers (its published 3 dense layers and 1
# MoE layer of the 58; a second MoE layer's stacked fp32 draw would need 30
# GB over 46 GB of weights), served as main_lm is and prefilled on 2 x 1024
# tokens; the other four configs at 2 layers, each prefilled alone.
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 4
PREFILL = dict(batch=2, seq=1024)
LM_CONFIGS = ("internvl2-76b", "minitron-8b", "mistral-nemo-12b",
              "qwen2.5-14b")
LM_CONFIG_LAYERS = 2

# The last three families at their published width and depth: zamba2-7b
# (81 layers; bf16 weights 13.5 GB, its init's fp32 draw of the largest
# leaf 16.3 GB beside them), served and prefilled on 2 x 1024 tokens, then
# on 1 x 8192 under its long-context override (the 4096-key window);
# xlstm-125m served and prefilled, and held card against CPU in float32 on
# a 2 x 256 prompt; whisper-base prefilled on 2 x (1500 frames, 448
# decoder tokens, its published context) and served.
HYBRID_ARCH, XLSTM_ARCH, WHISPER_ARCH = ("zamba2-7b", "xlstm-125m",
                                         "whisper-base")
LONG_PREFILL = dict(batch=1, seq=8192)
XLSTM_F32_PREFILL = dict(batch=2, seq=256)
XLSTM_F32_RTOL = 1e-4
WHISPER_PREFILL = dict(batch=2, seq=448)
# B5's window, bidirectional and head-dim-112 builds at this slice's shapes:
# (name, (B, S, H, K, D), window, causal, SDPA's mask).
FLASH_MASK_CASES = (
    ("causal_d112", (2, 1024, 32, 32, 112), 0, True, "is_causal"),
    ("window_4096", (1, 8192, 32, 32, 112), 4096, True, "band"),
    ("window_1000", (1, 2048, 32, 32, 112), 1000, True, "band"),
    ("window_1", (1, 2048, 32, 32, 112), 1, True, "band"),
    ("bidirectional", (2, 1500, 8, 8, 64), 0, False, "none"))
F32_FLASH_TOL = 3e-5            # the fp32 path: |err| <= 3e-5 (1 + |ref|)
EMULATED_S = 50                 # one k block with a tail past S
# lm_grad's reduced configs of this slice: card vs CPU per leaf (relative
# L2), the loss likewise.
GRAD_NEW = (("zamba2-7b", {}), ("zamba2-7b", {"sliding_window": 3}),
            ("xlstm-125m", {}), ("whisper-base", {}))
GRAD_NEW_RTOL = 1e-5
# B5's bf16-score builds (attn_score_dtype="bf16") at PERF.md row 5's shapes:
# (name, (B, S, H, K, D, Dv), window); the MLA case reads v as a view of
# the per-head [k_nope ; v] expansion, as the model does.
FLASH_SCORE_CASES = (
    ("causal_qwen2.5-14b", (2, 1024, 40, 8, 128, 128), 0),
    ("mla_deepseek-v3", (2, 1024, 128, 128, 192, 128), 0),
    ("window_4096_zamba2", (1, 8192, 32, 32, 112, 112), 4096))
# lm_grad at bf16 scores (card: the bf16-score build, the backward through
# the bf16 score slab; CPU: the bf16 score slab): loss and per-leaf
# relative L2; and each remat policy card vs CPU in fp32.
GRAD_S16 = (("qwen2-0.5b", {}), ("deepseek-v3-671b", {}),
            ("zamba2-7b", {"sliding_window": 3}))
GRAD_S16_RTOL = 2e-2
REMAT_POLICIES = ("nothing", "dots", "selective", "none")
# The dry-run's CLI on full cells, on the host (no card), one process
# each, side by side, started right after the build so that xlstm-125m's
# sLSTM (4,096 steps a layer, traced op by op) runs beside the card's
# phases: (arch, shape, mesh).
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k", "single"),
                ("olmoe-1b-7b", "train_4k", "single"),
                ("xlstm-125m", "train_4k", "single"),
                ("zamba2-7b", "prefill_32k", "single"))
# Per-device FLOPs of the same cells in the JAX reference's compiled
# program: the reference roofline's counts on a CPU host (``python -m
# repro.launch.roofline --arch A --shape S``, jax 0.9.0 on the CPU, the
# layers unrolled; the baseline compile's record counts a loop's body
# once, zamba2-7b prefill_32k's 6.3476e12); the port's count is held at
# or under them.
DRYRUN_REFERENCE_FLOPS = {"qwen2-0.5b": 5.218e13, "olmoe-1b-7b": 9.105e13,
                          "xlstm-125m": 6.499e12, "zamba2-7b": 5.7724e14}
# The port's own count of each cell on a CPU host (torch 2.13); the GPU
# host's torch traces the same program within DRYRUN_AGREE of it.
DRYRUN_CPU_HOST_FLOPS = {"qwen2-0.5b": 1.9986e13, "olmoe-1b-7b": 5.4209e13,
                         "xlstm-125m": 6.0228e12, "zamba2-7b": 1.2801e14}
DRYRUN_AGREE = 0.05
# The loops each record's while_trip_counts holds: the layer loop;
# xlstm-125m's groups of 3 mLSTM + 1 sLSTM and the sLSTM's time steps;
# zamba2-7b's 13 groups of 6 Mamba2 layers, its tail of 3 and the SSD's
# chunk loop (32,768 tokens in chunks of 256).
DRYRUN_TRIPS = {"qwen2-0.5b": (24,), "olmoe-1b-7b": (16,),
                "xlstm-125m": (3, 4096), "zamba2-7b": (13, 6, 3, 128)}
# qwen2-0.5b train_4k with the vocab on its shards at both ends of the
# step (the loss and the lookup, ROADMAP C11): each rank's temporaries at
# or under the reference compile's (3.6980e11 B, the reference's
# memory_analysis on the same CPU host) and its static all-gather (the
# collectives outside the layer loop) under 1e9 B (it was 2.02e10 when
# the loss gathered the vocab).  olmoe-1b-7b train_4k's temporaries at or
# under the reference compile's (6.8220e10 B): the counter leaves out the
# storage a meta tensor does not hold (it counted the experts' whole
# (E, C, D) slab, made on the meta device to read its stride, 1.0137e11).
# xlstm-125m train_4k's at or under the reference compile's (5.6164e10).
# zamba2-7b prefill_32k's at or under the reference compile's (2.9065e10):
# each (2, 128, 256, 256, 112) fp32 slab of the SSD's intra-chunk step is
# dropped after its last use (4.0323e10 when three stayed live to the end
# of ssd_forward).
DRYRUN_TEMP_MAX = {"qwen2-0.5b": 3.6980e11, "olmoe-1b-7b": 6.8220e10,
                   "xlstm-125m": 5.6164e10, "zamba2-7b": 2.9065e10}
DRYRUN_STATIC_ALL_GATHER_MAX = {"qwen2-0.5b": 1e9}
# The dry-run's temporaries against the card (phase dryrun_memory): one
# dryrun.make_train_step step of TRAIN's arch at full width and depth on
# TRAIN's batch, per remat policy, its peak held within
# DRYRUN_MEMORY_AGREE of the world-size-1 trace's argument + temp bytes.
DRYRUN_MEMORY_POLICIES = ("none", "nothing")
DRYRUN_MEMORY_AGREE = 0.15

# The engines the registry added: card vs CPU on SMALL ocr, and three of
# them at full OCR size (phase, algorithm).
SIMPLE_ALGOS = ("fw", "ssg", "bcfw", "bcfw-avg", "mpbcfw-avg")
SIMPLE_MAIN = (("main_bcfw", "bcfw-avg"), ("main_ssg", "ssg"),
               ("main_fw", "fw"))
# The wide plan (ROADMAP C6): pass shapes (blocks, cap, d, steps) past the
# staged kernel, and a chain at the SSVM head's width over Mistral-NeMo-12B
# and Qwen2.5-14B (d = 5 x 5120 + 5^2 = 25,625) at the head's settings.
WIDE_PASSES = [(12, 16, 20505, None), (12, 16, 20505, 10),
               (12, 16, 25625, None), (12, 16, 25625, 10),
               (3, 4096, 4004, None), (6, 512, 4004, 10)]
WIDE_DATA = dict(n=512, f=5120, num_labels=5, mean_len=8, max_len=14,
                 seed=0)
WIDE_RUN = dict(max_iters=3, cap=16, approx_batch=8, max_approx_passes=8,
                gram_steps=10)
# Structured serving: the reference's and serving_bench.py's batch size and
# bucket grid; full-width usps (configs/paper.py::USPS) and horseseg
# (HORSESEG, n cut from 2376 to 512: generating its 1.58 GB of features
# alone takes ~20 s) with serving_bench.py's weights, RandomState(7).
SERVE_BATCH, SERVE_GRANULARITY = 8, 4
# B3's serving shapes: OCR's largest bucket and the SSVM head's rows.
SERVE_VITERBI = ((16, 26), (32, 5))
SERVE_USPS = dict(n=7291, f=256, num_classes=10, seed=0)
SERVE_HORSESEG = dict(n=512, grid=(16, 16), f=649, seed=0)
HORSESEG_SWEEPS = 40
SERVE_HORSESEG_CHECKED = 256    # per-example decodes held, a seeded sample
SERVE_BITS_LIMIT = 2048         # requests whose unary bits are compared
SERVE_PROFILE = 512             # requests of the round-time breakdown
NEAR_TIE_RTOL = 1e-5            # a differing label allowed only at a tie


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound_ms(nbytes: float, ops: float, flops: float = FP32_FLOPS):
    """Least time for the work: bytes over HBM rate vs ops over the peak
    rate of their type (fp32 by default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, calls: int, warmup: int = 3) -> float:
    """Mean milliseconds per ``fn(k)`` call, k = 0..calls-1, CUDA events."""
    for k in range(warmup):
        fn(k)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(calls):
        fn(k)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def graph_ms(torch, fn, calls: int, warmup: int = 3) -> float:
    """Mean milliseconds per ``fn(k)`` call, k = 0..calls-1, with the host
    out of the loop: the calls are captured in one CUDA graph (on a side
    stream), replayed once to warm up, then once between two CUDA events.
    :func:`time_ms` paces small calls by the host's enqueue; this times
    what the card takes, as inside a captured block step."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for k in range(warmup):
            fn(k)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(calls):
            fn(k)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def phase_build():
    """Build the seven kernel sources (one ``nvcc`` each, all at once),
    then run the checker's kernels layer on this card
    (``repro_torch.analysis.kernels``): H003 over the plans' sweep, and
    H004 over every build of every source table, its attributes read from
    the card and held to its plans and to the ``-Xptxas -v`` log.  One
    ``build_check`` line per kernel: builds checked, registers min-max,
    the largest shared memory a launch takes, spills and waivers; any
    finding fails the run.  ~45-55 s of builds, then ~3 s of checks (the
    sweep ~2 s on the host, the attribute queries well under 1 s)."""
    from repro_torch.analysis.kernels import run_kernel_layer
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    seconds = _build.build()
    emit("build", seconds=time.perf_counter() - t0, per_source=seconds)
    t0 = time.perf_counter()
    findings, facts = run_kernel_layer("cuda")
    summary = facts["kernels"]
    emit("build_check", seconds=time.perf_counter() - t0,
         h003_launches=summary["h003_launches"],
         h003_refused=summary["h003_refused"], h004=summary["h004"],
         findings=[str(f) for f in findings])
    for name in _build.SOURCES:
        f = facts[f"kernels:{name}"]
        emit("build_check", kernel=name, builds=f["builds"],
             registers=f["registers"], max_smem=f["max_smem"],
             spills=f["spills"], waived=f["waived"])
    check(not findings, f"build_check: {len(findings)} finding(s): "
          f"{[str(f) for f in findings[:8]]}")


def check_plane_scores(torch, gen):
    """B1 against its plain version at one cache block read in place and
    at ragged shapes, then timed at (64, 4004) over the blocks of a cold
    131 MB stack by :func:`graph_ms` and :func:`time_ms` beside
    ``torch.addmv``, with the rows per CTA it launches.  ~2 s."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import plane_scores as t_ps

    def case(n, d):
        block = torch.randn((n, d + 1), generator=gen, device="cuda")
        w = torch.randn((d,), generator=gen, device="cuda")
        P, b = block[:, :-1], block[:, -1]       # strided, unaligned views
        out = ops.plane_scores(P, w, b)
        want = ref.plane_scores_ref(P, w, b)
        torch.cuda.synchronize()
        err = (out - want).abs()
        check(bool((err <= TOL * (1 + want.abs())).all()),
              f"plane_scores {n}x{d}: max err {float(err.max())}")
        return float(err.max())

    main_err = case(64, 4004)
    ragged = {f"{n}x{d}": case(n, d) for n in (1, 7, 65, 4096)
              for d in (1, 127, 4004)}

    # Main-path timing: blocks of a 131 MB stack (> the 50 MB L2), as an
    # approximate pass walks the 7 GB cache and finds each block cold.
    nblk, cap, d = 128, 64, 4004
    stack = torch.randn((nblk, cap, d + 1), generator=gen, device="cuda")
    w = torch.randn((d,), generator=gen, device="cuda")

    def kernel(k):
        return ops.plane_scores(stack[k % nblk, :, :-1], w,
                                stack[k % nblk, :, -1])

    def library(k):
        return torch.addmv(stack[k % nblk, :, -1], stack[k % nblk, :, :-1], w)
    calls = 4 * nblk
    bms, by = bound_ms(4.0 * (cap * d + d + 2 * cap), 2.0 * cap * d)
    times = dict(
        ms=graph_ms(torch, kernel, calls),
        library_ms=graph_ms(torch, library, calls),
        event_loop_ms=time_ms(torch, kernel, calls),
        library_event_loop_ms=time_ms(torch, library, calls),
        plain_ms=time_ms(torch, lambda k: ref.plane_scores_ref(
            stack[k % nblk, :, :-1], w, stack[k % nblk, :, -1]), calls),
        bound_ms=bms, bound_by=by, rows_per_cta_stages=list(t_ps.plan(cap)))
    emit("kernel", name="plane_scores", shape=[cap, d], max_abs_err=main_err,
         ragged_max_abs_err=ragged, timing_by="ms, library_ms: graph_ms; "
         "*event_loop_ms, plain_ms: time_ms", **times)
    return dict(name="plane_scores", route="cuda",
                source="src/repro_torch/kernels/csrc/plane_scores.cu",
                replaces="src/repro/kernels/plane_scores.py:52",
                max_abs_err=max([main_err, *ragged.values()]), **times)


def viterbi_work(mask, C: int):
    """(bytes, ops) a decode of these rows needs: unaries, table, mask and
    labels once; 2*C*C max-adds per valid step, C per padded step and for
    the final argmax."""
    B, L = mask.shape
    valid_steps = int(mask[:, 1:].sum())
    padded_steps = B * (L - 1) - valid_steps
    nbytes = 4 * B * L * C + 4 * C * C + B * L + 4 * B * L
    return nbytes, 2 * C * C * valid_steps + C * (padded_steps + B)


def viterbi_plan(L: int, C: int):
    """B3's launch plan at (L, C) (kernels/viterbi.py::plan)."""
    from repro_torch.kernels import viterbi as t_vit
    return t_vit.plan(L, C)._asdict()


def check_viterbi(torch, gen, masks):
    """B3 against its plain version (bit-equal labels, ties included) on
    the OCR masks at B = 1 and B = 6877, at L = 32, C = 109 with ties, on
    the scratch plan (a chain too long to stage), and on serving rounds
    (8 rows of a bucket, tails of 0-3 masked steps, 2 filler rows) at
    ``SERVE_VITERBI``; then timed at B = 1, B = 6877 and the serving
    shapes by :func:`graph_ms` (the calls captured in one CUDA graph, as
    B3 runs inside the captured exact step and serving round) beside the
    event loop, the plain version and the bound, with the plan each shape
    launches.  ~4 s."""
    from repro_torch.kernels import ops, ref
    C = OCR["num_labels"]
    L = masks.shape[1]

    def inputs(B, tie, L=L, C=C, mask=None):
        if mask is None:
            lens = torch.randint(1, L + 1, (B,), generator=gen, device="cuda")
            mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]
        if tie:   # small integers: many exactly equal candidates
            unary = torch.randint(-2, 3, (B, L, C), generator=gen,
                                  device="cuda").float()
            trans = torch.randint(-2, 3, (C, C), generator=gen,
                                  device="cuda").float()
        else:
            unary = torch.randn((B, L, C), generator=gen, device="cuda")
            trans = torch.randn((C, C), generator=gen, device="cuda")
        return unary, trans, mask.contiguous()

    def serve_inputs(L_b, C_s, tie):
        """A serving round's batch: 6 requests padded to the bucket L_b
        (tails of 0-3 masked steps) and 2 filler rows copying the last."""
        tails = torch.randint(0, 4, (6,), generator=gen, device="cuda")
        unary, trans, _ = inputs(SERVE_BATCH, tie, L=L_b, C=C_s,
                                 mask=torch.ones((SERVE_BATCH, L_b),
                                                 dtype=torch.bool,
                                                 device="cuda"))
        mask = (torch.arange(L_b, device="cuda")[None, :]
                < (L_b - tails)[:, None])
        mask = torch.cat([mask, mask[-1:].expand(2, L_b)])
        unary[6:] = unary[5]
        return unary, trans, mask.contiguous()

    results = {}
    cases = [(f"B{B}{'_tie' if tie else ''}",
              inputs(B, tie, mask=masks[:B])) for B in (1, masks.shape[0])
             for tie in (False, True)]
    cases += [("32x109_tie", inputs(9, True, L=32, C=109)),
              ("2000x26_scratch", inputs(3, False, L=2000)),
              ("300x109_scratch_tie", inputs(2, True, L=300, C=109))]
    cases += [(f"serve_{L_b}x{C_s}{'_tie' if tie else ''}",
               serve_inputs(L_b, C_s, tie))
              for L_b, C_s in SERVE_VITERBI for tie in (False, True)]
    for what, (unary, trans, mask) in cases:
        got = ops.viterbi_decode(unary, trans, mask)
        want = ref.viterbi_decode_ref(unary, trans, mask)
        want_cpu = ref.viterbi_decode_ref(unary.cpu(), trans.cpu(),
                                          mask.cpu())
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"viterbi {what}: kernel labels "
              "differ from the plain version on the card")
        check(torch.equal(got.cpu(), want_cpu), f"viterbi {what}: kernel "
              "labels differ from the CPU plain run")
        results[what] = viterbi_plan(*unary.shape[1:])
    check(results["2000x26_scratch"]["staged"] is False
          and results["B1"]["staged"] is True,
          f"viterbi plans: {results}")
    timing = {}
    for B in (1, masks.shape[0]):
        unary, trans, mask = inputs(B, False, mask=masks[:B])
        calls = 200 if B == 1 else 20
        nbytes, ops_n = viterbi_work(mask, C)
        bms, by = bound_ms(nbytes, ops_n)

        def kernel(k):
            return ops.viterbi_decode(unary, trans, mask)
        timing[B] = dict(
            ms=graph_ms(torch, kernel, calls),
            event_loop_ms=time_ms(torch, kernel, calls),
            plain_ms=time_ms(torch, lambda k: ref.viterbi_decode_ref(
                unary, trans, mask), max(calls // 10, 2)),
            bound_ms=bms, bound_by=by, plan=viterbi_plan(L, C))
    for L_b, C_s in SERVE_VITERBI:
        unary, trans, mask = serve_inputs(L_b, C_s, False)
        nbytes, ops_n = viterbi_work(mask, C_s)
        bms, by = bound_ms(nbytes, ops_n)

        def kernel(k):
            return ops.viterbi_decode(unary, trans, mask)
        timing[f"serve_{SERVE_BATCH}x{L_b}x{C_s}"] = dict(
            ms=graph_ms(torch, kernel, 200),
            event_loop_ms=time_ms(torch, kernel, 200),
            plain_ms=time_ms(torch, lambda k: ref.viterbi_decode_ref(
                unary, trans, mask), 20),
            bound_ms=bms, bound_by=by, plan=viterbi_plan(L_b, C_s))
    emit("kernel", name="viterbi_decode", shape=[1, L, C], checks=results,
         timing={(f"B={B}" if isinstance(B, int) else B): t
                 for B, t in timing.items()},
         timing_by="ms: graph_ms; event_loop_ms, plain_ms: time_ms",
         library_ms=None, library_note="no single PyTorch call decodes a "
         "chain; the plain version is a loop of L steps")
    t1 = timing[1]
    return dict(name="viterbi_decode", route="cuda",
                source="src/repro_torch/kernels/csrc/viterbi.cu",
                replaces="src/repro/kernels/viterbi.py:34", max_abs_err=0.0,
                ms=t1["ms"], event_loop_ms=t1["event_loop_ms"],
                plain_ms=t1["plain_ms"], bound_ms=t1["bound_ms"],
                bound_by=t1["bound_by"], library_ms=None, plan=t1["plan"],
                at_6877=timing[masks.shape[0]],
                serving={k: t for k, t in timing.items()
                         if isinstance(k, str)})


SELECT_DENSITIES = (("path", 2.0 / 64), ("half", 0.5), ("full", 1.0))
SELECT_SMALL_K = (64, 512)      # a tau chunk, a window of the fold
SELECT_REPEATS = 50             # plane_select relaunches that must agree


def select_plan(k: int, cap: int, d: int):
    """plane_select's launch plan for k rows of a (., cap, d) cache
    (kernels/plane_select.py::plan)."""
    from repro_torch.kernels import plane_select as t_psel
    return t_psel.plan(k, cap, d)._asdict()


def select_bound(torch, valid, rows, d: int):
    """(valid slots read, bound ms, bound_by) of one plane_select call over
    ``rows``: the least traffic is the valid slots' planes and offsets,
    the selected rows' validity bytes, w, the row indices, and best + idx
    written once; 2d flops per valid slot."""
    k, cap = rows.numel(), valid.shape[1]
    n_valid = int(valid[rows].sum())
    nbytes = 4 * n_valid * (d + 1) + k * cap + 4 * d + 8 * k + 8 * k
    return (n_valid,) + bound_ms(nbytes, 2.0 * n_valid * d)


def check_select_bits(torch, P, w, b, valid, rows, best, idx, what):
    """B2's result against B1's scores of the same planes, bit for bit
    (the order both keep), then SELECT_REPEATS relaunches from one state
    against the first launch."""
    from repro_torch.kernels import ops
    n, cap, d = P.shape
    scores = ops.plane_scores(P.reshape(n * cap, d), w,
                              b.reshape(n * cap)).reshape(n, cap)
    masked = torch.where(valid, scores,
                         torch.full_like(scores, ops.INVALID_SCORE))[rows]
    check(torch.equal(best, masked.amax(dim=1)),
          f"plane_select {what}: scores differ from plane_scores' bits")
    check(torch.equal(idx.long(), masked.argmax(dim=1)),
          f"plane_select {what}: slots differ from plane_scores' argmax")
    for _ in range(SELECT_REPEATS):
        again = ops.plane_select(P, w, b, valid, rows=rows)
        check(torch.equal(again[0], best) and torch.equal(again[1], idx),
              f"plane_select {what}: a relaunch changed the result")


def check_plane_select(torch, gen):
    """The fused score-and-select kernel against its plain version: all n
    rows of the full-size cache selected through a permutation (the
    pipelined path's batched fallback) at three densities (the path's
    2/64, one half, all valid), k = 64 and 512 rows through ``rows``, and
    ragged shapes.  At each density and k: idx equal to the plain
    version's, best within TOL, the scores equal to B1's bit for bit, and
    SELECT_REPEATS relaunches bit-equal.  Timed by :func:`graph_ms` (the
    host out of the loop) and :func:`time_ms`, beside the two-step
    ``addmv`` + mask + ``amax``/``argmax`` over the whole cache, each with
    its own byte bound from its valid count and the plan it launched with.
    Small k reads other rows each call (slices of one permutation), so
    each call finds its rows cold in L2, as a tau chunk does.  ~10 s."""
    from repro_torch.kernels import ops, ref
    n, cap, d = OCR["n"], RUN_ASYNC["cap"], 4004

    def density(stack, p_valid):
        rows_n, cap = stack.shape[:2]
        valid = torch.rand((rows_n, cap), generator=gen,
                           device="cuda") < p_valid
        if p_valid < 1.0:
            valid[::11] = False                 # rows with no valid slot
        if cap > 40:
            valid[1::5, 10] = valid[1::5, 40] = True
        return valid

    def case(rows_n, cap, d, p_valid):
        # Planes scaled by 1/sqrt(d): scores of unit scale, so the absolute
        # part of TOL means the same at every d.  Two fp32 sums of d terms
        # in different orders differ by ~eps*sqrt(d) times the score
        # scale; at d = 4004 with unscaled planes that exceeds 3e-5 where
        # a score cancels to near 0.
        stack = torch.randn((rows_n, cap, d + 1), generator=gen,
                            device="cuda") / math.sqrt(d)
        if cap > 40:                            # duplicate planes: ties
            stack[1::5, 40] = stack[1::5, 10]
        w = torch.randn((d,), generator=gen, device="cuda")
        rows = torch.randperm(rows_n, generator=gen, device="cuda")
        return stack, density(stack, p_valid), w, rows

    def compare(stack, valid, w, rows, what):
        best, idx = ops.plane_select(stack[..., :-1], w, stack[..., -1],
                                     valid, rows=rows)
        want_best, want_idx = ref.plane_select_ref(
            stack[..., :-1], w, stack[..., -1], valid, rows)
        torch.cuda.synchronize()
        check(torch.equal(idx, want_idx),
              f"plane_select {what}: {int((idx != want_idx).sum())} slots "
              "differ from the plain version")
        err = (best - want_best).abs()
        check(bool((err <= TOL * (1 + want_best.abs())).all()),
              f"plane_select {what}: max err {float(err.max())}")
        return float(err.max()), best, idx

    ragged = {}
    for c in (1, 7, 64):
        for dd in (1, 127, 4004):
            ragged[f"{c}x{dd}"] = compare(*case(300, c, dd, 0.3),
                                          f"300x{c}x{dd}")[0]
    stack, path_valid, w, rows = case(n, cap, d, SELECT_DENSITIES[0][1])
    P, b = stack[..., :-1], stack[..., -1]
    flat = stack.reshape(n * cap, d + 1)
    errs, at = [], {}
    for name, p_valid in SELECT_DENSITIES:
        valid = path_valid if name == "path" else density(stack, p_valid)
        what = f"{n}x{cap}x{d} {name}"
        err, best, idx = compare(stack, valid, w, rows, what)
        check_select_bits(torch, P, w, b, valid, rows, best, idx, what)
        errs.append(err)
        # The plain version's gathers leave ~14 GB cached.  A graph capture
        # frees it (empty_cache), and a replay timed just after it read up
        # to 20 % slow at all valid (scripts/plane_select_timing.py
        # --after-plain), so free it first and let the card settle.
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        time.sleep(0.5)

        def kernel(k, valid=valid):
            return ops.plane_select(P, w, b, valid, rows=rows)

        def two_step(k, valid=valid):
            scores = torch.addmv(flat[:, -1], flat[:, :-1], w).reshape(n, cap)
            masked = scores.masked_fill(~valid, ops.INVALID_SCORE)
            return masked.amax(dim=1), masked.argmax(dim=1)
        n_valid, bms, by = select_bound(torch, valid, rows, d)
        calls = 20 if name == "path" else 5
        at[name] = dict(
            valid_slots=n_valid, max_abs_err=err,
            graph_ms=graph_ms(torch, kernel, calls),
            event_loop_ms=time_ms(torch, kernel, calls),
            two_step_graph_ms=graph_ms(torch, two_step, 3, warmup=1),
            two_step_ms=time_ms(torch, two_step, 3, warmup=1),
            plain_ms=time_ms(torch, lambda k, valid=valid:
                             ref.plane_select_ref(P, w, b, valid, rows),
                             2, warmup=1),
            bound_ms=bms, bound_by=by, plan=select_plan(n, cap, d))
        at[name]["graph_over_bound"] = at[name]["graph_ms"] / bms
        del valid, kernel, two_step
    # Small k at the path's density: slices of one permutation, another
    # slice each call.
    small = {}
    for kk in SELECT_SMALL_K:
        slices = [rows[i:i + kk] for i in range(0, n - kk + 1, kk)]
        what = f"k={kk}"
        err, best, idx = compare(stack, path_valid, w, slices[0], what)
        check_select_bits(torch, P, w, b, path_valid, slices[0], best, idx,
                          what)
        errs.append(err)

        def kernel(k, slices=slices):
            return ops.plane_select(P, w, b, path_valid,
                                    rows=slices[k % len(slices)])
        calls = 4 * len(slices) if kk == 64 else 2 * len(slices)
        nv = [select_bound(torch, path_valid, s, d) for s in slices]
        small[kk] = dict(
            max_abs_err=err, slices=len(slices),
            valid_slots_per_call=sum(v[0] for v in nv) / len(nv),
            graph_ms=graph_ms(torch, kernel, calls),
            event_loop_ms=time_ms(torch, kernel, calls),
            bound_ms=sum(v[1] for v in nv) / len(nv), bound_by=nv[0][2],
            plan=select_plan(kk, cap, d))
    path = at["path"]
    full_ms, _ = bound_ms(4.0 * n * cap * (d + 1) + n * cap + 4 * d + 16 * n,
                          2.0 * n * cap * d)
    del stack, path_valid, flat, P, b
    torch.cuda.empty_cache()
    note = ("no single PyTorch call computes a masked first argmax over "
            "slots; two_step_ms is addmv over the whole cache, then "
            "masked_fill, amax and argmax (rows in order, no gather)")
    emit("kernel", name="plane_select", shape=[n, cap, d], rows="permutation",
         densities=at, small_k=small, max_abs_err=max(errs),
         ragged_max_abs_err=ragged, full_read_bound_ms=full_ms,
         library_ms=None, library_note=note,
         timing_by="graph_ms: the calls captured in one CUDA graph; "
         "event_loop_ms, two_step_ms, plain_ms: time_ms")
    return dict(name="plane_select", route="cuda",
                source="src/repro_torch/kernels/csrc/plane_select.cu",
                replaces="src/repro/kernels/plane_select.py:64",
                max_abs_err=max([*errs, *ragged.values()]),
                ms=path["event_loop_ms"], graph_ms=path["graph_ms"],
                plain_ms=path["plain_ms"], bound_ms=path["bound_ms"],
                bound_by=path["bound_by"], valid_slots=path["valid_slots"],
                library_ms=None, full_read_bound_ms=full_ms,
                two_step_ms=path["two_step_ms"],
                two_step_graph_ms=path["two_step_graph_ms"],
                plan=path["plan"], timing_by="ms, two_step_ms: time_ms; "
                "graph_ms, two_step_graph_ms: graph_ms",
                densities={k: {f: v[f] for f in ("valid_slots", "graph_ms",
                                                  "event_loop_ms",
                                                  "bound_ms")}
                           for k, v in at.items()},
                small_k={k: {f: v[f] for f in ("graph_ms", "bound_ms")}
                         for k, v in small.items()},
                library_note=note)


def approx_plan(d: int, cap: int, steps=None):
    """approx_pass's launch plan at (d, cap, steps)
    (kernels/approx_pass.py::plan)."""
    from repro_torch.kernels import approx_pass as t_ap
    return t_ap.plan(d, cap, steps or 0)._asdict()


def approx_pass_work(valid, perm, d: int, steps=None):
    """(bytes, ops) one approximate pass over ``perm`` needs with this
    cache's valid slots: each visited block's valid planes read once, its
    phi_i row read and written, its validity bytes, one activity stamp and
    its id, phi and the average in and out; in the Sec-3.5 mode also the
    valid x valid part of its Gram leaf.  Operations: 2d per valid plane
    scored (twice that for a and b in the Sec-3.5 mode), ~10 (d+1) per
    block for the line search, update and average (~14 (d+1) and 2 (d+1)
    per valid plane mixed in the Sec-3.5 mode)."""
    v = valid[perm].sum(dim=1).double()
    nv, nblk, d1 = float(v.sum()), perm.numel(), d + 1
    cap = valid.shape[1]
    nbytes = (4.0 * nv * d1 + 8.0 * nblk * d1 + nblk * cap + 12.0 * nblk
              + 16.0 * d1)
    if steps is None:
        ops_n = 2.0 * d * nv + 10.0 * d1 * nblk
    else:
        nbytes += 4.0 * float((v * v).sum())
        ops_n = (6.0 * d * nv + 14.0 * d1 * nblk
                 + 20.0 * steps * float(v.sum()))
    return nbytes, ops_n


def _approx_state(torch, gen, n, cap, d, steps, p_valid=2.0 / 64):
    """A synthetic cache of ``n`` blocks (unit-scale scores, empty blocks,
    duplicate planes), phi_i = half of slot 0, phi their sum."""
    planes = torch.randn((n, cap, d + 1), generator=gen, device="cuda") \
        / math.sqrt(d)
    valid = torch.rand((n, cap), generator=gen, device="cuda") < p_valid
    valid[:, 0] |= torch.rand((n,), generator=gen, device="cuda") < 0.8
    valid[::17] = False                         # blocks with no plane
    if cap > 40:                                # duplicate planes: ties
        planes[1::5, 40] = planes[1::5, 10]
        valid[1::5, 10] = valid[1::5, 40] = True
    phi_i = 0.5 * planes[:, 0].clone()
    state = dict(phi=phi_i.sum(0), phi_i=phi_i,
                 bar=0.1 * torch.randn((d + 1,), generator=gen,
                                       device="cuda"),
                 last=torch.zeros((n, cap), dtype=torch.int32,
                                  device="cuda"))
    gram = (torch.bmm(planes[..., :-1], planes[..., :-1].transpose(1, 2))
            if steps else None)
    return planes, valid, gram, state


def _pass_close(torch, got, want, what):
    """One pass, kernel vs plain: activity stamps equal, phi, phi_i and
    the average within TOL (1 + |ref|).  Returns the largest error."""
    check(torch.equal(got["last"], want["last"]),
          f"{what}: {int((got['last'] != want['last']).sum())} activity "
          "stamps differ (an argmax slot moved)")
    errs = []
    for k in ("phi", "phi_i", "bar"):
        err = (got[k] - want[k]).abs()
        check(bool((err <= TOL * (1 + want[k].abs())).all()),
              f"{what}: {k} max err {float(err.max())}")
        errs.append(float(err.max()))
    return max(errs)


def check_approx_pass(torch, gen):
    """The pass kernel against its plain version (the eager per-block
    loop) in both modes: one pass over 512 full-size OCR blocks (d = 4004,
    cap = 64) of a synthetic cache, and one pass plus a 4-pass run_all
    batch on SMALL ocr states trained on the card.  One pass: activity
    stamps equal, phi, phi_i and the average within TOL (1 + |ref|); a
    batch: duals within rtol 1e-4.  REPEATS more launches from the same
    state must give the same bits.  In the plain mode also the gap
    output's build on the same 512 blocks (:func:`check_gap_pass`).  Timed
    at 512 blocks beside the plain version and the bound; the main path's
    full-pass times come from phase_profile.  ~20 s."""
    from repro_torch.core import mpbcfw
    from repro_torch.core.ssvm import dual_value
    from repro_torch.kernels import ops
    lam = 1.0 / OCR["n"]
    errs, timing, gap_checks = {}, {}, {}
    for steps in (None, 10):
        mode = "plain" if steps is None else "gram"
        planes, valid, gram, state = _approx_state(torch, gen, 512, 64, 4004,
                                                   steps)
        perm = torch.randperm(512, generator=gen, device="cuda")
        kw = dict(lam=lam, k0=7000, outer_it=5, gram=gram, steps=steps)

        def run(fn, st):
            fn(st["phi"], st["phi_i"], st["bar"], planes, valid, st["last"],
               perm, **kw)
        got = {k: v.clone() for k, v in state.items()}
        want = {k: v.clone() for k, v in state.items()}
        run(ops.approx_pass, got)
        run(mpbcfw.eager_pass, want)
        torch.cuda.synchronize()
        errs[f"512x64x4004_{mode}"] = _pass_close(torch, got, want,
                                                  f"approx_pass 512 {mode}")
        if steps is None:
            # The gap output's build on the same inputs (every block seen
            # for the first time).
            gap_checks["512x64x4004"] = check_gap_pass(
                torch, "approx_pass 512 plain", planes, valid, state,
                torch.full((512,), 1e30, device="cuda"), perm, lam=lam,
                k0=7000, outer_it=5)
        # A pass is deterministic: the same launch from the same state
        # gives the same bits (resume's bit-for-bit guarantee needs it).
        for _ in range(REPEATS):
            again = {k: v.clone() for k, v in state.items()}
            run(ops.approx_pass, again)
            check(all(torch.equal(again[k], got[k]) for k in got),
                  f"approx_pass 512 {mode}: a repeated launch differs")
        off = {k: v.clone() for k, v in state.items()}
        ops.approx_pass(off["phi"], off["phi_i"], off["bar"], planes, valid,
                        off["last"], perm,
                        go=torch.zeros((), dtype=torch.bool, device="cuda"),
                        **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(off[k], state[k]) for k in state),
              f"approx_pass {mode}: a false flag changed the state")
        tmp = {k: v.clone() for k, v in state.items()}
        nbytes, ops_n = approx_pass_work(valid, perm, 4004, steps)
        bms, by = bound_ms(nbytes, ops_n)
        timing[mode] = dict(
            blocks=512, valid_planes=int(valid[perm].sum()),
            ms=time_ms(torch, lambda k: run(ops.approx_pass, tmp), 10),
            plain_ms=time_ms(torch, lambda k: run(mpbcfw.eager_pass, tmp),
                             1, warmup=1),
            bound_ms=bms, bound_by=by, plan=approx_plan(4004, 64, steps))
        timing[mode]["us_per_block"] = 1e3 * timing[mode]["ms"] / 512
        del planes, valid, gram
    for algo in ("mpbcfw", "mpbcfw-gram"):
        _, solver = small_run("ocr", "cuda", algo, max_iters=2)
        solver.run()
        steps = solver.cfg.gram_steps if algo == "mpbcfw-gram" else None
        mp, slam = solver.state, solver.cfg.lam
        c = mp.cache
        perms = torch.stack([torch.randperm(mp.inner.phi_i.shape[0],
                                            generator=gen, device="cuda")
                             for _ in range(4)])
        base = dict(phi=mp.inner.phi, phi_i=mp.inner.phi_i,
                    bar=mp.avg.bar_approx, last=c.last_active)
        got = {k: v.clone() for k, v in base.items()}
        want = {k: v.clone() for k, v in base.items()}
        duals, first = {"kernel": [], "plain": []}, {}
        for who, st, fn in (("kernel", got, ops.approx_pass),
                            ("plain", want, mpbcfw.eager_pass)):
            for k in range(4):
                fn(st["phi"], st["phi_i"], st["bar"], c.planes, c.valid,
                   st["last"], perms[k], lam=slam,
                   k0=mp.avg.k_approx + k * perms.shape[1],
                   outer_it=mp.outer_it, gram=c.gram, steps=steps)
                duals[who].append(float(dual_value(st["phi"], slam)))
                if k == 0:
                    first[who] = {kk: v.clone() for kk, v in st.items()}
        errs[f"small_ocr_{algo}"] = _pass_close(
            torch, first["kernel"], first["plain"],
            f"approx_pass SMALL {algo}")
        for a, b in zip(duals["kernel"], duals["plain"]):
            check(abs(a - b) <= 1e-4 * abs(b) + 1e-7,
                  f"approx_pass SMALL {algo} run_all: dual {a} vs {b}")
        errs[f"small_ocr_{algo}_run_all_duals"] = duals
        del solver, mp
    torch.cuda.empty_cache()
    emit("kernel", name="approx_pass", timing_512_blocks=timing,
         max_abs_err={k: v for k, v in errs.items()
                      if not k.endswith("duals")},
         run_all_duals={k: v for k, v in errs.items()
                        if k.endswith("duals")},
         library_ms=None, library_note="no single PyTorch call runs a "
         "BCFW pass; the plain version is the eager per-block loop",
         tolerance="one pass: activity stamps equal, |err| <= 3e-5 "
         "(1+|ref|); 4-pass run_all: duals within rtol 1e-4")
    return dict(name="approx_pass", route="cuda",
                source="src/repro_torch/kernels/csrc/approx_pass.cu",
                replaces="src/repro/core/mpbcfw.py:99 (approx_pass, a "
                "lax.scan; no pallas_call)",
                max_abs_err=max(v for k, v in errs.items()
                                if not k.endswith("duals")),
                library_ms=None, at_512_blocks=timing, gap_checks=gap_checks)


def compare_traces(what: str, traces) -> list:
    """Card vs CPU traces of one run: the same schedule, duals and primals
    within rtol 1e-4.  Returns the rows compared."""
    rows = []
    check(len(traces["cuda"]) == len(traces["cpu"]),
          f"{what}: {len(traces['cuda'])} vs {len(traces['cpu'])} rows")
    for g, c in zip(traces["cuda"], traces["cpu"]):
        check((g.n_exact, g.n_approx, g.approx_passes)
              == (c.n_exact, c.n_approx, c.approx_passes),
              f"{what}: schedule differs at iteration {g.iteration}")
        for f in ("dual", "primal", "primal_avg"):
            a, b = getattr(g, f), getattr(c, f)
            if math.isnan(b):        # ssg has no dual certificate
                check(math.isnan(a), f"{what}: {f} {a} where the CPU has "
                      f"NaN at iteration {g.iteration}")
                continue
            check(abs(a - b) <= 1e-4 * abs(b) + 1e-7,
                  f"{what}: {f} {a} vs {b} at iteration {g.iteration}")
        rows.append([g.dual, c.dual, g.primal, c.primal, g.approx_passes])
    return rows


def small_problem(name: str, device: str):
    """The CI-sized scenario ``SMALL[name]`` on ``device``, built by the
    trainer's :func:`repro_torch.trainer.ssvm_head.build_problem`."""
    from repro_torch.configs.paper import SMALL
    from repro_torch.trainer.ssvm_head import build_problem
    sc = SMALL[name]
    return sc, build_problem(sc, device=device)


def small_run(name: str, device: str, algo: str, max_iters: int = 3):
    from repro_torch.api import CostModel, RunConfig, Solver
    sc, prob = small_problem(name, device)
    return prob, Solver(prob, RunConfig(
        lam=1.0 / sc.n, algo=algo, max_iters=max_iters, cap=16,
        approx_batch=4, max_approx_passes=6,
        cost_model=CostModel(sc.oracle_cost, sc.plane_cost)))


def phase_parity(torch):
    """The port on the card vs the port on the CPU (plain versions), on the
    CI-sized OCR scenario: same schedule, duals within rtol 1e-4."""
    traces = {dev: small_run("ocr", dev, "mpbcfw")[1].run().trace
              for dev in ("cuda", "cpu")}
    emit("parity", scenario="SMALL[ocr]",
         rows=compare_traces("parity", traces))


def drive(torch, solver, phase: str, dual: bool = True, after=None):
    """Run ``solver`` to its end, each row timed to a device sync and
    emitted as ``<phase>_row``, then check the rows: all ``max_iters`` ran,
    the dual never decreased, gap >= -1e-5 |primal|, finite objectives.
    Without ``dual`` (an engine with no dual certificate, ssg) only the
    primal is checked.  ``after(row)`` runs after each row, outside its
    timed window.  Returns ``(rows, walls)``."""
    walls, rows = [], []
    rows_iter = solver.iterate()
    while True:
        t0 = time.perf_counter()
        row = next(rows_iter, None)
        torch.cuda.synchronize()
        if row is None:
            break
        walls.append(time.perf_counter() - t0)
        rows.append(row)
        emit(f"{phase}_row", wall_s=walls[-1], **row.__dict__)
        if after is not None:
            after(row)
    check(len(rows) == solver.cfg.max_iters,
          f"{phase}: {len(rows)} iterations ran")
    prev = -float("inf")
    for r in rows:
        check(math.isfinite(r.primal),
              f"{phase}: non-finite primal at iteration {r.iteration}")
        if not dual:
            continue
        check(r.dual >= prev, f"{phase}: dual decreased at iteration "
              f"{r.iteration}")
        check(r.gap >= -1e-5 * abs(r.primal),
              f"{phase}: negative gap {r.gap} at iteration {r.iteration}")
        check(math.isfinite(r.dual) and math.isfinite(r.primal),
              f"{phase}: non-finite objective at iteration {r.iteration}")
        prev = r.dual
    return rows, walls


def check_syncs(phase: str, rows, dispatches: int):
    """The reference's contract: ``dispatches`` program dispatches and one
    host sync per iteration (no overflow batch at these settings)."""
    for r in rows:
        check(r.dispatches == dispatches and r.host_syncs == 1,
              f"{phase}: {r.dispatches} dispatches, {r.host_syncs} host "
              f"syncs at iteration {r.iteration}")


# Paths whose every engine dispatch ran under sync-debug "error": phase ->
# dispatches checked (the sync_debug line).
SYNC_CHECKED = {}


def sync_checked(torch, phase: str, engine) -> None:
    """Run every dispatch of ``engine`` (``outer_iteration``, both
    programs of the async engines included, and ``continue_passes``)
    under the checker's ``sync_debug`` (sync-debug "error"): a hidden host
    sync inside one, a blocking copy from pageable memory included,
    raises.  Counts the dispatches in ``SYNC_CHECKED[phase]``; a raise is
    reported on a ``sync_debug_raised`` line (the phase, the
    ``repro_torch`` line that synced and its caller) before it fails the
    run."""
    from repro_torch.analysis import raise_site, sync_debug
    SYNC_CHECKED.setdefault(phase, 0)
    cuda = torch.device("cuda")

    def wrap(fn):
        def dispatch(*args, **kw):
            try:
                with sync_debug(cuda):
                    out = fn(*args, **kw)
            except RuntimeError as err:
                emit("sync_debug_raised", path=phase, where=raise_site(err),
                     error=str(err).splitlines()[0])
                raise
            SYNC_CHECKED[phase] += 1
            return out
        return dispatch
    engine.outer_iteration = wrap(engine.outer_iteration)
    engine.continue_passes = wrap(engine.continue_passes)


def check_replays(phase: str, solver, steps: int, captured: int) -> int:
    """One graph replay per block step, but for the eager warm-up step of
    each of the ``captured`` bodies.  Returns the replays."""
    replays = solver.engine.graphs.replays
    check(replays == steps - captured,
          f"{phase}: {replays} graph replays for {steps} block steps and "
          f"{captured} captures")
    return replays


def phase_main(torch, data):
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.core.oracles import chain
    from repro_torch.kernels import ops
    X, Y, M = data
    n = OCR["n"]
    problem = chain.make_problem(X, Y, M, OCR["num_labels"], device="cuda")
    check(problem.d == 4004, f"d = {problem.d}, expected 4004")
    torch.cuda.reset_peak_memory_stats()
    solver = Solver(problem, RunConfig(
        lam=1.0 / n, cost_model=CostModel(oracle_cost=ORACLE_COST,
                                          plane_cost=PLANE_COST), **RUN))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    sync_checked(torch, "main", solver.engine)
    rows, walls = drive(torch, solver, "main")
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    last = rows[-1]
    check_syncs("main", rows, dispatches=1)
    check(last.n_exact == n * len(rows), f"n_exact {last.n_exact}")
    passes = sum(r.approx_passes for r in rows)
    check(last.n_approx == n * passes, f"n_approx {last.n_approx}")
    # One gated pass launch per queued pass, run or stopped; the plain
    # cache has no Gram rows, so plane_scores is not on this path.
    check(launches["approx_pass"] == RUN["approx_batch"] * len(rows)
          and passes > 0, f"approx_pass launches {launches['approx_pass']} "
          f"for {passes} passes")
    check(launches["plane_scores"] == 0,
          f"plane_scores launches {launches['plane_scores']}")
    check(launches["viterbi_decode"] >= last.n_exact,
          f"viterbi launches {launches['viterbi_decode']} < n_exact "
          f"{last.n_exact}")
    check(launches["plane_select"] == 0,
          f"plane_select launched {launches['plane_select']} times on the "
          "mpbcfw path, which has no batched fallback")
    replays = check_replays("main", solver, last.n_exact, captured=1)
    w = solver.result().w
    check(w.shape == (4004,) and all(map(math.isfinite, w.tolist())),
          "weights not finite")
    emit("main", scenario="OCR", n=n, d=problem.d, cap=RUN["cap"],
         iterations=len(rows), wall_s_per_iteration=walls,
         max_memory_allocated=peak, launches=launches,
         n_exact=last.n_exact, n_approx=last.n_approx, graph_replays=replays)
    return launches, solver, walls


def graph_window(torch, run, graphs, blocks: int, kernels=()):
    """One window of ``blocks`` block steps replayed from ``graphs``:
    host ms per block to enqueue (``run()`` returns before the device is
    done), wall ms per block to a sync, the device span between CUDA
    events recorded around it, and graph replays per block; then the same
    window under torch.profiler (:func:`traced`), whose summed kernel time
    is held against the events' span (kernels inside graph replays must
    show in the trace).  Two busy shares, each from one run: the events'
    span over the untraced wall time (``event_span_over_wall``: the share
    of the wall during which the stream had work), and the traced kernel
    time over the traced window's own device span, first kernel start to
    last kernel end (``traced_busy_share_of_span``).  ``kernels`` goes to
    :func:`traced`; a trace that shows a named kernel other than once per
    block is taken again, up to four times (``trace_attempts``)."""
    torch.cuda.synchronize()
    r0 = graphs.replays
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replays = graphs.replays - r0
    span_ms = start.elapsed_time(end)
    # Each named kernel runs once per block step.  The profiler can lose
    # events of a replayed graph (seen: 1023 of 1024, and 1022 of 1024 in
    # two traces in a row), so a trace that does not show one per block
    # is taken again, up to four times, after a sync and a pause; the
    # callers still require one per block.
    for attempt in (1, 2, 3, 4):
        if attempt > 1:
            torch.cuda.synchronize()
            time.sleep(0.5)
        tr = traced(torch, run, kernels)
        if all(v["calls"] == blocks for v in tr["kernel_us"].values()):
            break
    check(tr["device_events"] >= blocks,
          f"the trace saw {tr['device_events']} device events in "
          f"{blocks} replayed block steps")
    return dict(blocks=blocks, trace_attempts=attempt,
                host_ms_per_block=1e3 * host / blocks,
                ms_per_block=1e3 * wall / blocks,
                replays_per_block=replays / blocks,
                event_span_ms=span_ms,
                event_span_over_wall=span_ms * 1e-3 / wall,
                traced_ms_per_block=tr["wall_ms"] / blocks,
                device_ops_per_block=tr["device_events"] / blocks,
                device_us_per_block=tr["device_us"] / blocks,
                traced_us_over_event_span=tr["device_us"] * 1e-3 / span_ms,
                traced_busy_share_of_span=(tr["device_us"]
                                           / tr["device_span_us"]),
                **tr)


def phase_profile(torch, solver, n_exact: int = 1024):
    """Where the main path's time goes, on the trained state: an exact-pass
    window of ``n_exact`` blocks (one replay of the engine's captured step
    per block) and one whole approximate pass (one approx_pass launch over
    all n blocks).  The exact window through :func:`graph_window` (host ms
    per block, replays per block, device span and busy share); the pass
    timed untraced, then traced.  Then the pass kernel's time per full pass
    with CUDA events beside the plain version's (the eager per-block loop,
    one pass, ~3-6 s) and the bound on this state's valid slots: the
    numbers of the kernels line.  ~15 s."""
    import numpy as np
    from repro_torch.core import mpbcfw
    from repro_torch.core.types import index_tensor
    from repro_torch.kernels import ops
    problem, lam = solver.problem, solver.cfg.lam
    mp, n = solver.state, solver.problem.n
    graphs = solver.engine.graphs
    perm = np.random.RandomState(2).permutation(n)
    out = {"exact": graph_window(torch, lambda: mpbcfw.exact_pass(
        problem, mp, perm[:n_exact], lam, graphs=graphs), graphs, n_exact,
        kernels=("viterbi",))}
    b3 = out["exact"].pop("kernel_us")["viterbi"]
    check(out["exact"]["replays_per_block"] == 1.0
          and b3["calls"] == n_exact,
          f"exact window: {out['exact']['replays_per_block']} replays and "
          f"{b3['calls']} viterbi kernels per {n_exact} blocks")
    out["exact"]["viterbi_us_per_block"] = b3["us"] / n_exact

    def approx():
        mpbcfw.approx_pass(None, mp, perm, lam)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    approx()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    tr = traced(torch, approx)
    out["approx"] = dict(blocks=n, ms_per_block=1e3 * untraced / n,
                         traced_ms_per_block=tr["wall_ms"] / n,
                         device_ops_per_block=tr["device_events"] / n,
                         device_us_per_block=tr["device_us"] / n, **tr)
    c = mp.cache
    ids = index_tensor(perm, "cuda")

    def one(fn):
        fn(mp.inner.phi, mp.inner.phi_i, mp.avg.bar_approx, c.planes,
           c.valid, c.last_active, ids, lam=lam, k0=mp.avg.k_approx,
           outer_it=mp.outer_it)
    nbytes, ops_n = approx_pass_work(c.valid, ids, problem.d)
    bms, by = bound_ms(nbytes, ops_n)
    timing = dict(blocks=n, valid_planes=int(c.valid.sum()),
                  ms=time_ms(torch, lambda k: one(ops.approx_pass),
                             3, warmup=1),
                  plain_ms=time_ms(torch, lambda k: one(mpbcfw.eager_pass),
                                   1, warmup=0),
                  bound_ms=bms, bound_by=by,
                  plan=approx_plan(problem.d, c.valid.shape[1]))
    timing["us_per_block"] = 1e3 * timing["ms"] / n
    emit("profile", scenario="OCR", approx_pass_full=timing, **out)
    return dict(timing, exact_ms_per_block=out["exact"]["ms_per_block"])


def phase_parity_async(torch):
    """mpbcfw-async on the card (side-stream oracle) vs on the CPU, on the
    CI-sized OCR scenario, with the same straggler mask: same schedule,
    duals and primals within rtol 1e-4, equal modeled overlap."""
    import numpy as np
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.configs.paper import SMALL
    from repro_torch.core.oracles import chain
    from repro_torch.data.synthetic import ocr_like
    from repro_torch.ft import StragglerPolicy, simulate_oracle_outcomes
    sc = SMALL["ocr"]
    X, Y, M = ocr_like(n=sc.n, f=sc.f, num_labels=sc.num_classes,
                       mean_len=sc.mean_len, max_len=sc.max_len, seed=0)
    policy = StragglerPolicy(straggler_prob=0.3, deadline_factor=1.5)
    traces, missed = {}, {}
    for dev in ("cuda", "cpu"):
        cfg = RunConfig(lam=1.0 / sc.n, algo="mpbcfw-async", max_iters=4,
                        cap=16, approx_batch=4, max_approx_passes=6,
                        cost_model=CostModel(sc.oracle_cost, sc.plane_cost))
        solver = Solver(chain.make_problem(X, Y, M, sc.num_classes,
                                           device=dev), cfg)
        masks = []

        def outcome(it, k, masks=masks):
            masks.append(simulate_oracle_outcomes(
                k, policy, np.random.RandomState(it))[0])
            return masks[-1]
        solver.engine.outcome_fn = outcome
        traces[dev] = solver.run().trace
        missed[dev] = int(sum((~m).sum() for m in masks[:-1]))
    check(missed["cuda"] > 0, "parity_async: no straggler fallback folded")
    rows = []
    for g, c in zip(traces["cuda"], traces["cpu"]):
        check((g.n_exact, g.n_approx, g.approx_passes)
              == (c.n_exact, c.n_approx, c.approx_passes),
              f"parity_async: schedule differs at iteration {g.iteration}")
        for f in ("dual", "primal"):
            a, b = getattr(g, f), getattr(c, f)
            check(abs(a - b) <= 1e-4 * abs(b) + 1e-7,
                  f"parity_async: {f} {a} vs {b} at iteration {g.iteration}")
        check(abs(g.oracle_overlap - c.oracle_overlap)
              <= 1e-6 * abs(c.oracle_overlap),
              f"parity_async: overlap at iteration {g.iteration}")
        rows.append([g.dual, c.dual, g.primal, c.primal, g.approx_passes,
                     g.n_exact, g.n_approx])
    emit("parity_async", scenario="SMALL[ocr]", fallbacks_folded=missed,
         rows=rows)


def phase_main_async(torch, data):
    """The pipelined path at full size: oracle arrivals from repro_torch.ft,
    so straggler fallbacks (plane_select) are really folded."""
    import numpy as np
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.core.oracles import chain
    from repro_torch.ft import StragglerPolicy, simulate_oracle_outcomes
    from repro_torch.kernels import ops
    X, Y, M = data
    n = OCR["n"]
    problem = chain.make_problem(X, Y, M, OCR["num_labels"], device="cuda")
    check(problem.d == 4004, f"d = {problem.d}, expected 4004")
    torch.cuda.reset_peak_memory_stats()
    solver = Solver(problem, RunConfig(
        lam=1.0 / n, cost_model=CostModel(oracle_cost=ORACLE_COST,
                                          plane_cost=PLANE_COST),
        **RUN_ASYNC))
    rng, masks = np.random.RandomState(0), []

    def outcome(it, k):
        masks.append(simulate_oracle_outcomes(k, StragglerPolicy(), rng)[0])
        return masks[-1]
    solver.engine.outcome_fn = outcome
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    sync_checked(torch, "main_async", solver.engine)
    rows, walls = drive(torch, solver, "main_async")
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_syncs("main_async", rows, dispatches=2)
    last = rows[-1]
    folded = masks[:len(rows) - 1]        # the last dispatch is not folded
    arrived = int(sum(m.sum() for m in folded))
    fallbacks = int(sum((~m).sum() for m in folded))
    check(last.n_exact == arrived,
          f"n_exact {last.n_exact} != arrived oracles {arrived}")
    check(fallbacks > 0, "no straggler fallback was folded")
    approx_steps = n * sum(r.approx_passes for r in rows)
    check(last.n_approx == approx_steps + fallbacks,
          f"n_approx {last.n_approx} != {approx_steps} + {fallbacks}")
    check(launches["plane_select"] == len(folded),
          f"plane_select launches {launches['plane_select']}")
    check(launches["viterbi_decode"] == 2 * len(rows),
          f"viterbi launches {launches['viterbi_decode']} (one oracle "
          "program and one evaluation sweep per iteration)")
    check(launches["approx_pass"] == RUN_ASYNC["approx_batch"] * len(rows),
          f"approx_pass launches {launches['approx_pass']}")
    check(launches["plane_scores"] == 0,
          f"plane_scores launches {launches['plane_scores']}")
    replays = check_replays("main_async", solver, arrived + fallbacks,
                            captured=(arrived > 0) + (fallbacks > 0))
    w = solver.result().w
    check(w.shape == (4004,) and all(map(math.isfinite, w.tolist())),
          "weights not finite")
    emit("main_async", scenario="OCR", n=n, d=problem.d, cap=RUN_ASYNC["cap"],
         iterations=len(rows), wall_s_per_iteration=walls,
         max_memory_allocated=peak, launches=launches, n_exact=last.n_exact,
         n_approx=last.n_approx, fallbacks_folded=fallbacks,
         graph_replays=replays,
         oracle_overlap=[r.oracle_overlap for r in rows])
    return launches, solver


def _stream_overlap_us(events):
    """Device events grouped by stream; the microseconds during which
    kernels of two different streams ran at once."""
    by_stream = {}
    for e in events:
        by_stream.setdefault(e.device_resource_id, []).append(
            (e.time_range.start, e.time_range.end))

    def union(spans):
        out = []
        for a, b in sorted(spans):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    unions = {k: union(v) for k, v in by_stream.items()}
    keys = sorted(unions, key=str)
    total = 0.0
    for x in range(len(keys)):
        for y in range(x + 1, len(keys)):
            i = j = 0
            u, v = unions[keys[x]], unions[keys[y]]
            while i < len(u) and j < len(v):
                lo, hi = max(u[i][0], v[j][0]), min(u[i][1], v[j][1])
                total += max(0.0, hi - lo)
                if u[i][1] < v[j][1]:
                    i += 1
                else:
                    j += 1
    return {str(k): len(v) for k, v in by_stream.items()}, total


def phase_profile_async(torch, solver, n_fold: int = 512):
    """The fold step, the approximate passes and the oracle program on the
    trained pipelined state.  First the fold alone: ``n_fold`` pending
    blocks (arrived and stragglers) through :func:`graph_window`, one
    replay of the engine's captured fold body per block.  Then one engine
    iteration whose pending buffer is cut to ``n_fold`` blocks, so it
    folds those blocks (and scores their fallback) and queues 2 gated
    passes on the main stream while the oracle program for all n blocks
    runs on the side stream (ROADMAP C4).  Untraced, CUDA events give the
    main stream's span from the cache program's start to the fold's end
    (``fold_device_ms``), the oracle program's span, and the time the two
    spans share (``events_overlap_us``); then the same span in a window
    with no oracle program (``fold_device_ms_without_oracle``: what the
    oracle beside it costs the fold); under torch.profiler, each
    stream's device time, the microseconds during which kernels of the two
    streams ran at once (``cross_stream_overlap_us``) and the host times of
    the first and last graph launch.  The profiler slows each graph launch
    to the device's pace, so there the fold's enqueue ends only as the
    fold does, and the oracle program queued after it cannot overlap it:
    the untraced events are the measurement.  ~5 s."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import mpbcfw
    from repro_torch.core.distributed import fallback_planes, fold_planes
    from repro_torch.core.ssvm import weights_of
    engine, problem, lam = solver.engine, solver.problem, solver.cfg.lam
    graphs = engine.graphs
    n = problem.n
    rng = np.random.RandomState(1)
    perm = rng.permutation(n)
    passes = np.stack([rng.permutation(n) for _ in range(2)])
    clock = mpbcfw.make_slope_clock(0.0, 0.0, ORACLE_COST * n, PLANE_COST,
                                    "cuda")

    mp, p = solver.state.mp, solver.state.pending
    ids, planes, done = p.ids[:n_fold], p.planes[:n_fold], p.done[:n_fold]
    fbp, fbs, _ = fallback_planes(mp.cache, ids,
                                  weights_of(mp.inner.phi, lam))
    fold = graph_window(torch, lambda: fold_planes(
        mp, ids, planes, fbp, fbs, done, lam, graphs=graphs), graphs, n_fold)
    check(fold["replays_per_block"] == 1.0,
          f"fold: {fold['replays_per_block']} replays per block")

    span = {}

    def cut_to_fold(state):
        p = state.pending
        return state._replace(pending=p._replace(
            ids=p.ids[:n_fold], planes=p.planes[:n_fold],
            done=p.done[:n_fold]))

    def window(state):
        cut = cut_to_fold(state)
        m0 = torch.cuda.Event(enable_timing=True)
        m1 = torch.cuda.Event(enable_timing=True)
        m0.record()
        state, _, stats = engine.outer_iteration(cut, perm, passes,
                                                 clock, ttl=RUN["ttl"])
        m1.record()
        state = engine.count_passes(state, engine.read_stats(stats))
        torch.cuda.synchronize()
        (f0, f1), (o0, o1) = engine.fold_span, engine.oracle_span
        span.update(main_ms=m0.elapsed_time(m1),
                    fold_start_ms=m0.elapsed_time(f0),
                    fold_end_ms=m0.elapsed_time(f1),
                    oracle_start_ms=m0.elapsed_time(o0),
                    oracle_end_ms=m0.elapsed_time(o1))
        return state

    def fold_alone(state):
        """The same cache program with no oracle program beside it: the
        main stream's span from its start to the fold's end."""
        cut = cut_to_fold(state)
        f0 = torch.cuda.Event(enable_timing=True)
        f1 = torch.cuda.Event(enable_timing=True)
        f0.record()
        mp, _, stats = mpbcfw.async_cache_program(
            cut.mp, cut.pending, passes, clock, lam=lam, ttl=RUN["ttl"],
            graphs=graphs, after_fold=f1.record)
        state = engine.count_passes(cut._replace(mp=mp),
                                    engine.read_stats(stats))
        torch.cuda.synchronize()
        span["fold_alone_ms"] = f0.elapsed_time(f1)
        return state

    state = solver.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = window(state)
    untraced = time.perf_counter() - t0
    state = fold_alone(state)
    # CUDA events, no profiler: the main stream's cache program from its
    # start to the end of its fold (eviction, fallback scoring, the fold's
    # replays; the event behind the fold is recorded in stream order after
    # its last replay) against the side stream's oracle program.
    spans = dict(span)
    events_overlap_us = 1e3 * max(0.0, min(spans["oracle_end_ms"],
                                           spans["fold_end_ms"])
                                  - max(spans["oracle_start_ms"],
                                        spans["fold_start_ms"]))
    w = weights_of(state.inner.phi, lam)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mpbcfw.async_oracle_program(problem, w, perm)
    torch.cuda.synchronize()
    oracle_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = window(state)
        traced = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    streams, overlap_us = _stream_overlap_us(dev)
    # Host times of the first and last graph launch, in us after the
    # window's first device event: under the profiler the launches keep
    # the device's pace.
    t_dev = min((e.time_range.start for e in dev), default=0.0)
    launches = sorted(e.time_range.start - t_dev for e in prof.events()
                      if e.device_type != torch.autograd.DeviceType.CUDA
                      and e.name == "cudaGraphLaunch")
    stream_us = {}
    for e in dev:
        key = str(e.device_resource_id)
        stream_us[key] = stream_us.get(key, 0.0) + e.time_range.elapsed_us()
    by_kernel = {}
    for e in dev:
        by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                             + e.time_range.elapsed_us())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit("profile_async", scenario="OCR", fold=fold, folded_blocks=n_fold,
         plane_select=select_on_state(torch, solver.state, lam, n_fold),
         approx_passes_queued=len(passes), oracle_blocks=n,
         window_ms=1e3 * untraced,
         ms_per_folded_block=1e3 * untraced / n_fold,
         traced_window_ms=1e3 * traced,
         oracle_program_ms=oracle_ms, device_events=len(dev),
         device_busy_share=(busy_us * 1e-6 / traced) if dev else None,
         events_per_stream=streams, device_us_per_stream=stream_us,
         event_spans_ms=spans,
         fold_device_ms=spans["fold_end_ms"] - spans["fold_start_ms"],
         fold_device_ms_without_oracle=spans["fold_alone_ms"],
         oracle_device_ms=spans["oracle_end_ms"] - spans["oracle_start_ms"],
         events_overlap_us=events_overlap_us,
         streams_overlapped=events_overlap_us > 0.0,
         cross_stream_overlap_us=overlap_us,
         traced_graph_launches=len(launches),
         traced_graph_launch_first_last_us=launches[:1] + launches[-1:],
         top_device_us=[[k[:60], v] for k, v in top])


def select_on_state(torch, state, lam: float, n_fold: int):
    """B2 where the fold calls it (``fallback_planes``) on a trained
    pipelined state: over ``n_fold`` pending rows and over all pending
    rows, at the state's ``w`` and its cache's own validity.  Per call:
    the valid slots read, :func:`graph_ms` and :func:`time_ms`, the bound
    from that count, and the plan.  The ``n_fold`` calls take successive
    windows of the pending ids, so each finds its rows cold in L2."""
    from repro_torch.core.ssvm import weights_of
    from repro_torch.core.types import index_tensor
    from repro_torch.kernels import ops
    cache = state.mp.cache
    P, b = cache.planes[:, :, :-1], cache.planes[:, :, -1]
    cap, d = cache.valid.shape[1], P.shape[2]
    w = weights_of(state.mp.inner.phi, lam)
    pending = index_tensor(state.pending.ids, P.device)
    out = {}
    for name, k in (("n_fold", n_fold), ("all_pending", pending.numel())):
        windows = [pending[i:i + k]
                   for i in range(0, pending.numel() - k + 1, k)]
        nv = [select_bound(torch, cache.valid, r, d) for r in windows]

        def kernel(i, windows=windows):
            return ops.plane_select(P, w, b, cache.valid,
                                    rows=windows[i % len(windows)])
        calls = max(10, 2 * len(windows))
        out[name] = dict(
            rows=k, windows=len(windows),
            valid_slots_per_call=sum(v[0] for v in nv) / len(nv),
            graph_ms=graph_ms(torch, kernel, calls),
            event_loop_ms=time_ms(torch, kernel, calls),
            bound_ms=sum(v[1] for v in nv) / len(nv), bound_by=nv[0][2],
            plan=select_plan(k, cap, d))
        out[name]["graph_over_bound"] = (out[name]["graph_ms"]
                                         / out[name]["bound_ms"])
    return out


def rel_l2(torch, got, want) -> float:
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def close_bf16(torch, got, want, what: str):
    """bf16 kernel vs the same arithmetic in fp32 with the kernel's
    roundings.  The intermediate the kernel rounds to bf16 (h, or p) is
    summed from products in another order than the emulation's, so ~0.1 %
    of its values round to the neighbouring bf16 value, and each such flip
    moves a whole output row by ulp(h) |wd|: relative L2 within one bf16
    unit roundoff (2^-9), each value within 4 bf16 ulps of the row scale."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = float(want.pow(2).mean().sqrt())
    rel = rel_l2(torch, got, want)
    check(rel <= 2.0 ** -9, f"{what}: relative L2 {rel} against the "
          "emulated roundings")
    check(bool((err <= 2.0 ** -5 * (want.abs() + rms)).all()),
          f"{what}: max err {float(err.max())} against the emulated "
          "roundings")
    return float(err.max())


def moe_ffn_emulated(torch, xs, wg, wu, wd):
    """moe_ffn with the kernel's roundings, in fp32 products: g and u in
    fp32, h rounded to wd's type, y rounded to xs's type."""
    F = torch.nn.functional
    g = torch.bmm(xs.float(), wg.float())
    u = torch.bmm(xs.float(), wu.float())
    h = (F.silu(g) * u).to(wd.dtype).float()
    return torch.bmm(h, wd.float()).to(xs.dtype)


def check_moe_ffn(torch, gen):
    """The grouped expert FFN against its plain version: the backbone's and
    the decode's shapes in bf16, ragged shapes in f32 and bf16."""
    from repro_torch.kernels import moe_ffn as kmoe
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional

    def inputs(E, C, D, Fd, dtype):
        xs = torch.randn((E, C, D), generator=gen, device="cuda")
        w = [torch.randn(s, generator=gen, device="cuda") * 0.02
             for s in ((E, D, Fd), (E, D, Fd), (E, Fd, D))]
        return [t.to(dtype) for t in (xs, *w)]

    def compare(E, C, D, Fd, dtype):
        args = inputs(E, C, D, Fd, dtype)
        got = ops.moe_ffn(*args)
        want = ref.moe_ffn_ref(*args)
        torch.cuda.synchronize()
        what = f"moe_ffn {E}x{C}x{D}x{Fd} {str(dtype)[6:]}"
        check(got.shape == want.shape and got.dtype == want.dtype, what)
        if dtype == torch.float32:
            err = (got - want).abs()
            check(bool((err <= 2e-4 * (1 + want.abs())).all()),
                  f"{what}: max err {float(err.max())}")
            return args, {"max_abs_err": float(err.max())}
        emu = close_bf16(torch, got, moe_ffn_emulated(torch, *args), what)
        rel = rel_l2(torch, got, want)
        check(rel <= BF16_REL_L2, f"{what}: relative L2 {rel} vs the plain "
              "bf16 einsums")
        return args, {"max_abs_err": float((got.float() - want.float())
                                           .abs().max()),
                      "rel_l2_vs_plain": rel, "max_abs_err_emulated": emu}

    ragged = {}
    for shape in ((3, 130, 128, 300), (2, 8, 64, 32), (2, 40, 64, 2000),
                  (5, 3, 96, 72), (2, 70, 100, 4000)):
        for dtype in (torch.float32, torch.bfloat16):
            ragged[f"{'x'.join(map(str, shape))}_{str(dtype)[6:]}"] = \
                compare(*shape, dtype)[1]
    out = {}
    for name, shape, calls in (("backbone", (64, 5120, 2048, 1024), 3),
                               ("decode", (64, 1, 2048, 1024), 20)):
        E, C, D, Fd = shape
        args, errs = compare(*shape, torch.bfloat16)
        xs, wg, wu, wd = args

        def library(k):
            g, u = torch.bmm(xs, wg), torch.bmm(xs, wu)
            return torch.bmm(F.silu(g) * u, wd)
        nbytes = 2 * (2 * E * C * D + 3 * E * D * Fd)
        bms, by = bound_ms(nbytes, 6.0 * E * C * D * Fd, BF16_FLOPS)
        out[name] = dict(
            shape=list(shape), plan=list(kmoe.plan(C, D, Fd, xs.dtype)),
            ms=time_ms(torch, lambda k: ops.moe_ffn(*args), calls, warmup=1),
            plain_ms=time_ms(torch, lambda k: ref.moe_ffn_ref(*args), calls,
                             warmup=1),
            library_ms=time_ms(torch, library, calls, warmup=1),
            bound_ms=bms, bound_by=by, **errs)
        del args, xs, wg, wu, wd
        torch.cuda.empty_cache()
    emit("kernel", name="moe_ffn", dtype="bf16", paths=out,
         ragged=ragged, library="torch.bmm x3 + silu (bf16)",
         tolerance="f32: |err| <= 2e-4 (1+|ref|) vs plain; bf16: relative "
         "L2 <= 2^-9 and |err| <= 2^-5 (|ref|+rms) vs the emulated "
         "roundings, relative L2 <= 2e-2 vs plain")
    main = out["backbone"]
    return dict(name="moe_ffn", route="cuda",
                source="src/repro_torch/kernels/csrc/moe_ffn.cu",
                replaces="src/repro/kernels/moe_ffn.py:47",
                max_abs_err=main["max_abs_err"],
                rel_l2_vs_plain=main["rel_l2_vs_plain"],
                max_abs_err_emulated=main["max_abs_err_emulated"],
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"],
                decode={k: out["decode"][k] for k in
                        ("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_by", "max_abs_err")})


def flash_emulated(torch, q, k, v, window: int = 0, causal: bool = True,
                   score_dtype: str = "f32"):
    """Attention with the kernel's roundings for S <= 64 (one k block):
    fp32 scores (``score_dtype="bf16"``: the product rounded to bf16,
    times the bf16-rounded scale, rounded again), p = exp(s - rowmax)
    rounded to v's type for p.v, the unrounded sum as the normaliser;
    causal (within ``window`` keys when > 0) or bidirectional.  (B, S, H,
    D), kv heads = H."""
    D = q.shape[-1]
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    if score_dtype == "bf16":
        scale = float(torch.tensor(D ** -0.5).bfloat16())
        s = torch.matmul(qf, kf.transpose(-1, -2)).bfloat16().float()
        s = (s * scale).bfloat16().float()
    else:
        s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / D ** 0.5)
    S = q.shape[1]
    row = torch.arange(S, device=q.device)[:, None]
    col = torch.arange(S, device=q.device)[None, :]
    mask = row >= col if causal else torch.ones_like(row >= col)
    if window:
        mask &= col > row - window
    s = s.masked_fill(~mask, -3.0e38)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(e.to(v.dtype).float(), vf) / e.sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).to(q.dtype)


def check_flash_attention(torch, gen):
    """Causal flash attention against its plain version: the backbone's
    (B, S, H, D) = (1024, 32, 16, 128) bf16 layout, ragged S, grouped kv
    heads, strided views, (BH, S, D), f32 and bf16."""
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional

    def compare(q, k, v, what):
        got = ops.flash_attention(q, k, v)
        want = ref.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        check(got.shape == q.shape and got.dtype == q.dtype, what)
        err = float((got.float() - want.float()).abs().max())
        if q.dtype == torch.float32:
            check(bool(((got - want).abs() <= 3e-4 * (1 + want.abs())).all()),
                  f"{what}: max err {err}")
            return {"max_abs_err": err}
        rel = rel_l2(torch, got, want)
        check(rel <= BF16_REL_L2, f"{what}: relative L2 {rel} vs plain")
        res = {"max_abs_err": err, "rel_l2_vs_plain": rel}
        if q.shape[1] <= 64 and q.dim() == 4 and k.shape[2] == q.shape[2]:
            res["max_abs_err_emulated"] = close_bf16(
                torch, got, flash_emulated(torch, q, k, v), what)
        return res

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    ragged = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        q, k, v = (rand(2, 200, 4, 128, dtype=dtype) for _ in range(3))
        ragged[f"2x200x4x128_{tag}"] = compare(q, k, v, f"S=200 {tag}")
        q = rand(3, 77, 8, 64, dtype=dtype)
        k, v = (rand(3, 77, 2, 64, dtype=dtype) for _ in range(2))
        ragged[f"gqa_3x77x8:2x64_{tag}"] = compare(q, k, v, f"gqa {tag}")
        qkv = rand(2, 50, 3, 6, 16, dtype=dtype)       # strided views
        ragged[f"views_2x50x6x16_{tag}"] = compare(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], f"views {tag}")
        q, k, v = (rand(5, 130, 32, dtype=dtype) for _ in range(3))
        ragged[f"bh_5x130x32_{tag}"] = compare(q, k, v, f"(BH,S,D) {tag}")
        q, k, v = (rand(4, 64, 2, 128, dtype=dtype) for _ in range(3))
        ragged[f"4x64x2x128_{tag}"] = compare(q, k, v, f"S=64 {tag}")
        for S_ in (1, 31, 33):
            q, k, v = (rand(3, S_, 4, 128, dtype=dtype) for _ in range(3))
            ragged[f"3x{S_}x4x128_{tag}"] = compare(q, k, v,
                                                    f"S={S_} {tag}")

    B, S, H, D = 1024, 32, 16, 128
    q, k, v = (rand(B, S, H, D, dtype=torch.bfloat16) for _ in range(3))
    errs = compare(q, k, v, f"{B}x{S}x{H}x{D} bf16")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    nbytes = 4 * 2 * B * S * H * D
    ops_n = 2 * 2 * B * H * D * S * (S + 1) / 2
    bms, by = bound_ms(nbytes, ops_n, BF16_FLOPS)
    ms = time_ms(torch, lambda i: ops.flash_attention(q, k, v), 20)
    plain_ms = time_ms(torch, lambda i: ref.flash_attention_ref(q, k, v), 5)
    library_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    del q, k, v, qt, kt, vt
    # The trainer's shape (qwen2-0.5b), and the four configs' prefill
    # shapes that lm_configs runs.
    train = flash_gqa_shape(torch, rand, compare, 8, 128, 14, 2, 64, 50, 10)
    from repro_torch import configs
    at_configs = {}
    for arch in LM_CONFIGS:
        c = configs.get_config(arch)
        at_configs[arch] = flash_gqa_shape(
            torch, rand, compare, PREFILL["batch"], PREFILL["seq"],
            c.num_heads, c.num_kv_heads, c.hd, 20, 3)
    emit("kernel", name="flash_attention", shape=[B, S, H, D], dtype="bf16",
         ragged=ragged, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
         train_shape=train, lm_configs=at_configs,
         library="scaled_dot_product_attention(is_causal=True)",
         bound_ms=bms, bound_by=by, tolerance="f32: |err| <= 3e-4 (1+|ref|) "
         "vs plain; bf16: relative L2 <= 2^-9 and |err| <= 2^-5 (|ref|+rms) "
         "vs the emulated roundings (S <= 64), relative L2 <= 2e-2 vs "
         "plain", **errs)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:75",
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms, train_shape=train,
                lm_configs=at_configs, **errs)


def flash_gqa_shape(torch, rand, compare, B, S, H, K, D, calls: int,
                    plain_calls: int):
    """B5 at a model path's shape (q (B, S, H, D), K kv heads, bf16)
    against its plain version, timed beside it, beside SDPA over the kv
    heads repeated (outside the timed call) and beside its bound."""
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    q = rand(B, S, H, D, dtype=torch.bfloat16)
    k, v = (rand(B, S, K, D, dtype=torch.bfloat16) for _ in range(2))
    errs = compare(q, k, v, f"{B}x{S}x{H}:{K}x{D} bf16")
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(H // K, dim=2).transpose(1, 2)
              for t in (k, v))
    bms, by = bound_ms(2 * B * S * D * (2 * H + 2 * K),
                       2 * 2 * B * H * D * S * (S + 1) / 2, BF16_FLOPS)
    return dict(
        shape=[B, S, H, K, D], bound_ms=bms, bound_by=by,
        ms=time_ms(torch, lambda i: ops.flash_attention(q, k, v), calls),
        plain_ms=time_ms(torch, lambda i: ref.flash_attention_ref(q, k, v),
                         plain_calls),
        library_ms=time_ms(torch, lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), calls), **errs)


def gram_close(torch, got, want, what: str):
    """Gram entries within 3e-5 |p_a| |p_b| + 3e-4 (two fp32 sums of d
    products in different orders), norms from ``want``'s diagonal; returns
    the largest error over that allowance's scale."""
    norms = want.diagonal(dim1=-2, dim2=-1).clamp_min(0).sqrt()
    allow = GRAM_RTOL * norms[..., :, None] * norms[..., None, :] + GRAM_ATOL
    err = (got - want).abs()
    check(bool((err <= allow).all()),
          f"{what}: {int((err > allow).sum())} entries beyond tolerance, "
          f"max err {float(err.max())}")
    return float(err.max())


def check_gram(torch, gen):
    """B4 against its plain version at a ragged shape, at one cache block
    read in place (a (64, 4004) view of a (64, 4005) buffer), at two tiles
    with split-K (65, 4004) and at a flattened 64-block working set (4096,
    4004): entries within the gram tolerance, G exactly equal to its
    transpose.  Timed at one block and at (4096, 4004) beside the plain
    version, cuBLAS and the bound, by :func:`graph_ms` and :func:`time_ms`,
    with the plan (tile, split) each shape launches.  ~3 s."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import gram as t_gram
    d = 4004

    def case(n, dd, strided):
        buf = torch.randn((n, dd + 1 if strided else dd), generator=gen,
                          device="cuda")
        P = buf[:, :dd] if strided else buf
        got = ops.gram(P)
        want = ref.gram_ref(P)
        torch.cuda.synchronize()
        check(torch.equal(got, got.T), f"gram {n}x{dd}: G != G^T")
        return P, gram_close(torch, got, want, f"gram {n}x{dd}")

    errs = {}
    for n, dd, strided in ((33, 200, False), (64, d, True), (65, d, True),
                           (4096, d, True)):
        P, errs[f"{n}x{dd}"] = case(n, dd, strided)
    timing = {}
    for n in (64, 4096):
        P = torch.randn((n, d + 1), generator=gen, device="cuda")[:, :d]
        calls = 200 if n == 64 else 10
        # G is symmetric: n(n+1)/2 distinct entries of 2d flops each.
        bms, by = bound_ms(4.0 * (n * d + n * n), float(n * (n + 1) * d))

        def kernel(k):
            return ops.gram(P)

        def library(k):
            return torch.mm(P, P.T)
        timing[n] = dict(
            ms=graph_ms(torch, kernel, calls),
            library_ms=graph_ms(torch, library, calls),
            event_loop_ms=time_ms(torch, kernel, calls),
            library_event_loop_ms=time_ms(torch, library, calls),
            plain_ms=time_ms(torch, lambda k: ref.gram_ref(P), calls),
            bound_ms=bms, bound_by=by, tile_split=list(t_gram.plan(n, d)))
    ptxas = [ln.strip() for ln in _build.build_log("gram").splitlines()
             if "registers" in ln or "spill" in ln]
    emit("kernel", name="gram", max_abs_err=errs,
         timing={f"{n}x{d}": t for n, t in timing.items()},
         library="torch.mm(P, P.T), allow_tf32=False", ptxas=ptxas,
         timing_by="ms, library_ms: graph_ms; *event_loop_ms, plain_ms: "
         "time_ms",
         tolerance="|err| <= 3e-5 |p_a| |p_b| + 3e-4, G == G^T exactly")
    t = timing[64]
    return dict(name="gram", route="cuda",
                source="src/repro_torch/kernels/csrc/gram.cu",
                replaces="src/repro/kernels/gram.py:34",
                shape=[64, d], max_abs_err=max(errs.values()), **t,
                at_4096=timing[4096])


def phase_parity_gram(torch):
    """mpbcfw-gram on the card vs the CPU on SMALL["ocr"]: the same
    schedule, duals within rtol 1e-4."""
    traces = {dev: small_run("ocr", dev, "mpbcfw-gram")[1].run().trace
              for dev in ("cuda", "cpu")}
    emit("parity_gram", scenario="SMALL[ocr]",
         rows=compare_traces("parity_gram", traces))


def phase_main_gram(torch, data):
    """The Sec-3.5 path at full size (RUN_GRAM), then B4 recomputes every
    block's Gram matrix and holds the cache's incrementally kept leaf
    against it on the valid x valid entries (the reference's invariant)."""
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.core.oracles import chain
    from repro_torch.kernels import ops
    X, Y, M = data
    n = OCR["n"]
    problem = chain.make_problem(X, Y, M, OCR["num_labels"], device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    solver = Solver(problem, RunConfig(
        lam=1.0 / n, cost_model=CostModel(oracle_cost=ORACLE_COST,
                                          plane_cost=PLANE_COST),
        **RUN_GRAM))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    sync_checked(torch, "main_gram", solver.engine)
    rows, walls = drive(torch, solver, "main_gram")
    run_launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_syncs("main_gram", rows, dispatches=1)
    last = rows[-1]
    passes = sum(r.approx_passes for r in rows)
    check(passes > 0, "no gram pass ran")
    check(last.n_exact == n * len(rows), f"n_exact {last.n_exact}")
    check(last.n_approx == n * RUN_GRAM["gram_steps"] * passes,
          f"n_approx {last.n_approx}")
    # The Gram row of each insert; the gram passes score inside the pass
    # kernel, one launch per queued pass.
    check(run_launches["plane_scores"] == n * len(rows),
          f"plane_scores launches {run_launches['plane_scores']}")
    check(run_launches["approx_pass"] == RUN_GRAM["approx_batch"] * len(rows),
          f"approx_pass launches {run_launches['approx_pass']}")
    # One B=1 decode per exact step, one B=n sweep per evaluation.
    check(run_launches["viterbi_decode"] == (n + 1) * len(rows),
          f"viterbi launches {run_launches['viterbi_decode']}")
    replays = check_replays("main_gram", solver, last.n_exact, captured=1)
    w = solver.result().w
    check(w.shape == (4004,) and all(map(math.isfinite, w.tolist())),
          "weights not finite")

    # B4 recomputes G_i = P_i P_i^T for every block.
    cache = solver.state.cache
    t0 = time.perf_counter()
    full = torch.empty_like(cache.gram)
    for i in range(n):
        full[i] = ops.gram(cache.planes[i, :, :-1])
    torch.cuda.synchronize()
    recompute_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(launches["gram"] == n, f"gram launches {launches['gram']}")
    check(torch.equal(full, full.transpose(1, 2)), "recomputed G not "
          "symmetric")
    both = cache.valid[:, :, None] & cache.valid[:, None, :]
    kept = torch.where(both, cache.gram, full)
    gram_err = gram_close(torch, kept, full, "main_gram: cache gram leaf")
    emit("main_gram", scenario="OCR", n=n, d=problem.d, cap=RUN_GRAM["cap"],
         gram_steps=RUN_GRAM["gram_steps"], iterations=len(rows),
         wall_s_per_iteration=walls,
         approx_passes=[r.approx_passes for r in rows],
         max_memory_allocated=peak, n_exact=last.n_exact,
         n_approx=last.n_approx, run_launches=run_launches,
         graph_replays=replays, launches=launches,
         valid_pairs=int(both.sum()),
         gram_leaf_max_abs_err=gram_err, recompute_s=recompute_s)
    return launches, solver, run_launches


def phase_profile_gram(torch, solver, blocks: int = 128,
                       n_exact: int = 1024):
    """The Sec-3.5 path on the trained state.  An exact-pass window of
    ``n_exact`` blocks (one replay of the gram engine's captured step per
    block, :func:`graph_window`), with the device us per block of B1
    ``plane_scores`` (each insert's Gram row) read from the trace by kernel
    name.  One whole gram pass (one approx_pass launch over all n blocks)
    timed untraced, then traced, then with CUDA events beside its bound;
    and the plain version (the eager recurrences, ~550 small ops per
    block) over ``blocks`` blocks.  ~6 s."""
    import numpy as np
    from repro_torch.core import mpbcfw
    from repro_torch.core.types import index_tensor
    mp, lam, n = solver.state, solver.cfg.lam, solver.problem.n
    steps = solver.cfg.gram_steps
    graphs = solver.engine.graphs
    perm = np.random.RandomState(2).permutation(n)[:n_exact]
    exact = graph_window(torch, lambda: mpbcfw.exact_pass(
        solver.problem, mp, perm, lam, graphs=graphs), graphs, n_exact,
        kernels=("plane_scores_kernel",))
    b1 = exact.pop("kernel_us")["plane_scores_kernel"]
    check(exact["replays_per_block"] == 1.0 and b1["calls"] == n_exact,
          f"gram exact window: {exact['replays_per_block']} replays and "
          f"{b1['calls']} plane_scores kernels per {n_exact} blocks")
    exact["plane_scores_us_per_block"] = b1["us"] / n_exact
    ids = index_tensor(np.random.RandomState(3).permutation(n), "cuda")

    def run():
        mpbcfw.run_pass(mp, ids, lam, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    tr = traced(torch, run)
    c = mp.cache
    nbytes, ops_n = approx_pass_work(c.valid, ids, solver.problem.d, steps)
    bms, by = bound_ms(nbytes, ops_n)
    ms = time_ms(torch, lambda k: run(), 3, warmup=0)
    sub = ids[:blocks].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mpbcfw.eager_pass(mp.inner.phi, mp.inner.phi_i, mp.avg.bar_approx,
                      c.planes, c.valid, c.last_active, sub, lam=lam,
                      k0=mp.avg.k_approx, outer_it=mp.outer_it, gram=c.gram,
                      steps=steps)
    torch.cuda.synchronize()
    plain_block_ms = 1e3 * (time.perf_counter() - t0) / blocks
    full = dict(ms=ms, us_per_block=1e3 * ms / n, bound_ms=bms, bound_by=by,
                valid_planes=int(c.valid.sum()),
                plan=approx_plan(solver.problem.d, c.valid.shape[1], steps))
    emit("profile_gram", scenario="OCR", exact=exact, blocks=n,
         gram_steps=steps,
         pass_ms=1e3 * untraced, ms_per_block=1e3 * untraced / n,
         traced_ms_per_block=tr["wall_ms"] / n,
         device_ops_per_block=tr["device_events"] / n,
         approx_pass_gram_full=full,
         plain_blocks=blocks, plain_ms_per_block=plain_block_ms, **tr)
    return full


def phase_resume(torch):
    """mpbcfw-gram on the card, SMALL["ocr"]: 4 uninterrupted iterations
    against 2, save, restore, 2 more; traces and weights bit for bit."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.api import Solver
    from repro_torch.checkpoint import CheckpointManager
    prob, full = small_run("ocr", "cuda", "mpbcfw-gram", max_iters=4)
    full_rows = full.run().trace
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(tmp)
        _, head = small_run("ocr", "cuda", "mpbcfw-gram", max_iters=4)
        it = head.iterate()
        rows = [next(it) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = head.save(mgr)
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(p.stat().st_size
                         for p in Path(tmp).rglob("*") if p.is_file())
        t0 = time.perf_counter()
        tail = Solver.restore(prob, head.cfg, mgr)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rows += list(tail.iterate())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(step == 2 and len(rows) == len(full_rows) == 4,
          f"resume: step {step}, {len(rows)} rows")
    for a, b in zip(rows, full_rows):
        check(dataclasses.asdict(a) == dataclasses.asdict(b),
              f"resume: iteration {b.iteration} differs from the "
              f"uninterrupted run: {a} vs {b}")
    ra, rb = tail.result(), full.result()
    check(bool((ra.w == rb.w).all() and (ra.w_avg == rb.w_avg).all()),
          "resume: weights differ from the uninterrupted run")
    emit("resume", scenario="SMALL[ocr]", algo="mpbcfw-gram",
         checkpoint_bytes=ckpt_bytes, save_s=save_s, restore_s=restore_s,
         bitwise=True, duals=[r.dual for r in rows])


def rows_bit_equal(phase: str, rows, want) -> None:
    import dataclasses
    check(len(rows) == len(want), f"{phase}: {len(rows)} rows, "
          f"{len(want)} expected")
    for a, b in zip(rows, want):
        check(dataclasses.asdict(a) == dataclasses.asdict(b),
              f"{phase}: iteration {b.iteration} differs: {a} vs {b}")


def shard_meshes(torch):
    """World-size-1 data meshes of one process group: NCCL on the card,
    gloo on the CPU (repro_torch.launch.mesh)."""
    from repro_torch.launch.mesh import make_data_mesh
    meshes = {"cuda": make_data_mesh(device="cuda"),
              "cpu": make_data_mesh(device="cpu")}
    check(meshes["cuda"].backend == "nccl" and meshes["cuda"].size == 1,
          f"card mesh {meshes['cuda']} on {meshes['cuda'].backend}")
    return meshes


def phase_parity_shard(torch, meshes):
    """The shard engines at world size 1, card (NCCL) against CPU (gloo):
    SHARD_PARITY's cases on the CI-sized scenarios, 3 iterations each:
    the same schedule, duals and primals within rtol 1e-4.  ~15 s."""
    from repro_torch.api import CostModel, RunConfig, Solver
    out = []
    t0 = time.perf_counter()
    for name, algo, kw in SHARD_PARITY:
        traces, coll = {}, {}
        for dev in ("cuda", "cpu"):
            sc, prob = small_problem(name, dev)
            solver = Solver(prob, RunConfig(**{
                **dict(lam=1.0 / sc.n, algo=algo, max_iters=3, cap=16,
                       approx_batch=4, max_approx_passes=6,
                       mesh=meshes[dev], cost_model=CostModel(
                           sc.oracle_cost, sc.plane_cost)), **kw}))
            traces[dev] = solver.run().trace
            coll[dev] = (solver.engine.ledger.collectives,
                         solver.engine.ledger.collective_bytes)
        what = f"parity_shard {name} {algo}"
        check(coll["cuda"] == coll["cpu"], f"{what}: collectives {coll}")
        check([r.gap_sampled for r in traces["cuda"]]
              == [r.gap_sampled for r in traces["cpu"]],
              f"{what}: sampled schedules differ")
        out.append(dict(scenario=f"SMALL[{name}]", algo=algo, **kw,
                        collectives=coll["cuda"],
                        rows=compare_traces(what, traces)))
    emit("parity_shard", seconds=time.perf_counter() - t0,
         backends={d: m.backend for d, m in meshes.items()}, cases=out)


def phase_main_shard(torch, data, mesh, main_rows, main_launches):
    """main's run under mpbcfw-shard on the world-size-1 NCCL mesh: rows
    bit-equal to main's, launch counts equal (B3 once per exact step and
    per evaluation, one approx_pass per queued pass), one sync per
    iteration, 1 + passes all-reduces charged (1 + approx_batch enqueued);
    every engine dispatch (eviction, the exact pass's replays, the
    all-reduces, the gated passes) under sync-debug "error".  Then a
    pass's and the setup's all-reduce alone: the device events the trace
    sees and their us, and ms per call by CUDA events.  ~8 s."""
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.core.oracles import chain
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    X, Y, M = data
    n = OCR["n"]
    problem = chain.make_problem(X, Y, M, OCR["num_labels"], device="cuda")
    solver = Solver(problem, RunConfig(
        lam=1.0 / n, mesh=mesh, cost_model=CostModel(
            oracle_cost=ORACLE_COST, plane_cost=PLANE_COST), **RUN_SHARD))
    eng = solver.engine
    sync_checked(torch, "main_shard", eng)
    torch.cuda.synchronize()
    issued0, bytes0 = mesh.issued, mesh.issued_bytes
    ops.reset_launch_counts()
    rows, walls = drive(torch, solver, "main_shard")
    launches = ops.launch_counts()
    rows_bit_equal("main_shard", rows, main_rows)
    check(launches == main_launches,
          f"main_shard launches {launches}, main's {main_launches}")
    check_syncs("main_shard", rows, dispatches=1)
    passes = sum(r.approx_passes for r in rows)
    led = eng.ledger
    check(led.collectives == len(rows) + passes,
          f"main_shard: {led.collectives} collectives for {passes} passes")
    enqueued = mesh.issued - issued0
    enqueued_bytes = mesh.issued_bytes - bytes0
    check(enqueued == len(rows) * (1 + RUN["approx_batch"]),
          f"main_shard: {enqueued} all-reduces enqueued")
    d1 = problem.d + 1
    payload = {"pass": torch.zeros((2, d1), device="cuda"),
               "setup": torch.zeros((4,), dtype=torch.int32, device="cuda")}
    allreduce = {}
    for tag, buf in payload.items():
        # At world size 1 NCCL may run nothing on the card: the trace
        # counts the device events an all-reduce makes, CUDA events its
        # time on the stream, paced by the host's enqueue.
        tr = traced(torch, lambda: [mesh.all_reduce(buf)
                                    for _ in range(20)])
        allreduce[tag] = dict(bytes=buf.numel() * buf.element_size(),
                              device_events_per_call=tr["device_events"]
                              / 20, device_us_per_call=tr["device_us"] / 20,
                              top_device_us=tr["top_device_us"][:3],
                              event_ms_per_call=time_ms(
                                  torch, lambda k: mesh.all_reduce(buf),
                                  100))
    emit("main_shard", scenario="OCR", n=n, d=problem.d, world_size=1,
         backend=mesh.backend, iterations=len(rows),
         wall_s_per_iteration=walls, launches=launches,
         rows_bit_equal_to="main", sync_debug_mode="error",
         collectives=led.collectives, collective_bytes=led.collective_bytes,
         enqueued_collectives=enqueued, enqueued_bytes=enqueued_bytes,
         graph_replays=eng.graphs.replays, allreduce=allreduce,
         seconds=time.perf_counter() - t_phase)
    return launches, solver


def phase_main_shard_tau(torch, data, mesh):
    """Full OCR under mpbcfw-shard-tau at tau = 23 (299 chunks): the dual
    never decreases, one sync per iteration; per chunk B3 at B = 23 and B2
    on the chunk's 23 rows (plus B3 at B = n per evaluation), the fold's
    steps graph replays.  On the trained state B3 at (23, 14, 26) and B2
    on 23 rows timed by graph_ms beside their bounds, and one tau-nice
    epoch's seconds beside one sequential exact pass's.  ~10 s."""
    import numpy as np
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.core import mpbcfw
    from repro_torch.core.oracles import chain
    from repro_torch.core.ssvm import weights_of
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    X, Y, M = data
    n, tau = OCR["n"], RUN_SHARD_TAU["tau"]
    chunks = n // tau
    problem = chain.make_problem(X, Y, M, OCR["num_labels"], device="cuda")
    solver = Solver(problem, RunConfig(
        lam=1.0 / n, mesh=mesh, cost_model=CostModel(
            oracle_cost=ORACLE_COST, plane_cost=PLANE_COST),
        **RUN_SHARD_TAU))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    sync_checked(torch, "main_shard_tau", solver.engine)
    rows, walls = drive(torch, solver, "main_shard_tau")
    launches = ops.launch_counts()
    check_syncs("main_shard_tau", rows, dispatches=1)
    last = rows[-1]
    check(last.n_exact == n * len(rows), f"n_exact {last.n_exact}")
    check(launches["viterbi_decode"] == (chunks + 1) * len(rows),
          f"main_shard_tau: viterbi launches {launches['viterbi_decode']}")
    check(launches["plane_select"] == chunks * len(rows),
          f"main_shard_tau: plane_select launches "
          f"{launches['plane_select']}")
    check(launches["approx_pass"] == RUN["approx_batch"] * len(rows),
          f"main_shard_tau: approx_pass launches {launches['approx_pass']}")
    eng = solver.engine.eng
    mp, lam = solver.state, solver.cfg.lam
    c = mp.cache
    rng = np.random.RandomState(5)
    ids = torch.from_numpy(rng.permutation(n)[:tau]).cuda()
    w = weights_of(mp.inner.phi, lam)
    _, b2_bms, b2_by = select_bound(torch, c.valid, ids, problem.d)
    b2 = dict(rows=tau, valid_slots=int(c.valid[ids].sum()),
              graph_ms=graph_ms(torch, lambda k: ops.plane_select(
                  c.planes[:, :, :-1], w, c.planes[:, :, -1], c.valid,
                  rows=ids), 50),
              bound_ms=b2_bms, bound_by=b2_by,
              plan=select_plan(tau, c.valid.shape[1], problem.d))
    mask = problem.data["mask"][ids]
    C = OCR["num_labels"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    unary = torch.randn((tau, mask.shape[1], C), generator=gen,
                        device="cuda")
    trans = torch.randn((C, C), generator=gen, device="cuda")
    nbytes, ops_n = viterbi_work(mask, C)
    b3_bms, b3_by = bound_ms(nbytes, ops_n)
    b3 = dict(shape=[tau, int(mask.shape[1]), C],
              graph_ms=graph_ms(torch, lambda k: ops.viterbi_decode(
                  unary, trans, mask), 50),
              bound_ms=b3_bms, bound_by=b3_by,
              plan=viterbi_plan(int(mask.shape[1]), C))
    perm = rng.permutation(n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mp = eng.tau_nice_pass(mp, perm, tau)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    # The sequential step's first pass captures its graph: time the next.
    mp = mpbcfw.exact_pass(problem, mp, perm, lam, graphs=eng.graphs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mpbcfw.exact_pass(problem, mp, perm, lam, graphs=eng.graphs)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    emit("main_shard_tau", scenario="OCR", n=n, tau=tau, chunks=chunks,
         iterations=len(rows), wall_s_per_iteration=walls,
         approx_passes=[r.approx_passes for r in rows],
         duals=[r.dual for r in rows], launches=launches,
         collectives=solver.engine.ledger.collectives,
         fold_gathers=eng.gathers, graph_replays=eng.graphs.replays,
         viterbi_b23=b3, plane_select_23_rows=b2,
         tau_epoch_s=epoch_s, sequential_exact_pass_s=exact_s,
         seconds=time.perf_counter() - t_phase)
    return launches


def phase_main_shard_gram(torch, data, mesh, gram_rows, gram_launches):
    """main_gram's run under mpbcfw-shard-gram on the NCCL mesh: rows
    bit-equal to main_gram's, the run's launch counts equal, one sync per
    iteration.  ~8 s (without main_gram's B4 recompute)."""
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.core.oracles import chain
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    X, Y, M = data
    n = OCR["n"]
    problem = chain.make_problem(X, Y, M, OCR["num_labels"], device="cuda")
    solver = Solver(problem, RunConfig(
        lam=1.0 / n, mesh=mesh, cost_model=CostModel(
            oracle_cost=ORACLE_COST, plane_cost=PLANE_COST),
        **RUN_SHARD_GRAM))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rows, walls = drive(torch, solver, "main_shard_gram")
    launches = ops.launch_counts()
    rows_bit_equal("main_shard_gram", rows, gram_rows)
    check(launches == gram_launches,
          f"main_shard_gram launches {launches}, main_gram's "
          f"{gram_launches}")
    check_syncs("main_shard_gram", rows, dispatches=1)
    led = solver.engine.ledger
    emit("main_shard_gram", scenario="OCR", n=n, iterations=len(rows),
         wall_s_per_iteration=walls, launches=launches,
         rows_bit_equal_to="main_gram", collectives=led.collectives,
         collective_bytes=led.collective_bytes,
         approx_passes=[r.approx_passes for r in rows],
         seconds=time.perf_counter() - t_phase)
    return launches, solver


def ranks_pass(torch, fn, mp, perm, lam, S, steps=None):
    """One pass over ``mp``'s first blocks (``perm`` a permutation of
    them) as S ranks of repro_torch.shard run it: rank r walks its
    contiguous share in perm's visit order from the shared phi, its
    averaging count advancing by S per block (``k_stride``), then the
    engine's damped recombination (phi + sum delta / S, phi_i0 + (phi_i -
    phi_i0) / S, the ranks' mean average).  On copies; returns phi, phi_i,
    the average and the activity stamps."""
    from repro_torch.shard.engine import local_schedules
    nb = perm.numel()
    nl = nb // S
    c, phi0, bar0 = mp.cache, mp.inner.phi, mp.avg.bar_approx
    red0, red1 = torch.zeros_like(phi0), torch.zeros_like(bar0)
    phi_i, last = [], []
    for r in range(S):
        lo, hi = r * nl, (r + 1) * nl
        sched = torch.from_numpy(local_schedules(
            perm.cpu().numpy()[None], lo, nl)[0]).cuda()
        st = dict(phi=phi0.clone(), phi_i=mp.inner.phi_i[lo:hi].clone(),
                  bar=bar0.clone(), last=c.last_active[lo:hi].clone())
        fn(st["phi"], st["phi_i"], st["bar"], c.planes[lo:hi],
           c.valid[lo:hi], st["last"], sched, lam=lam, k0=mp.avg.k_approx,
           outer_it=mp.outer_it,
           gram=None if steps is None else c.gram[lo:hi], steps=steps,
           k_stride=S)
        red0 += st["phi"] - phi0
        red1 += st["bar"] / S
        phi_i.append(mp.inner.phi_i[lo:hi]
                     + (st["phi_i"] - mp.inner.phi_i[lo:hi]) / S)
        last.append(st["last"])
    return dict(phi=phi0 + red0 / S, phi_i=torch.cat(phi_i), bar=red1,
                last=torch.cat(last))


def phase_shard_stride(torch, plain_solver, gram_solver):
    """approx_pass at k_stride 2 and 4 (a rank of S's averaging count)
    against its plain version over S rank slices of the trained states
    (main_shard's first 2048 blocks plain, main_shard_gram's first 256 in
    the Sec-3.5 mode), recombined as the engine recombines them: stamps
    equal, phi, phi_i and the average within TOL (1 + |ref|).  Then the
    stride-1 pass over all blocks of each trained state, ms by CUDA
    events beside its bound (scripts/approx_pass_timing.py times it
    against a parent tree).  ~10 s."""
    import numpy as np
    from repro_torch.core import mpbcfw
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    errs, timing = {}, {}
    for mode, solver, steps in (("plain", plain_solver, None),
                                ("sec35", gram_solver,
                                 gram_solver.cfg.gram_steps)):
        mp, lam = solver.state, solver.cfg.lam
        nb = STRIDE_BLOCKS[mode]
        perm = torch.from_numpy(np.random.RandomState(7).permutation(nb))
        for S in STRIDE_RANKS:
            before = ops.launch_counts()["approx_pass"]
            got = ranks_pass(torch, ops.approx_pass, mp, perm, lam, S, steps)
            check(ops.launch_counts()["approx_pass"] == before + S,
                  f"shard_stride: {S} launches expected")
            want = ranks_pass(torch, mpbcfw.eager_pass, mp, perm, lam, S,
                              steps)
            errs[f"{mode}_S{S}"] = _pass_close(
                torch, got, want, f"shard_stride {mode} S={S}")
        n = solver.problem.n
        ids = torch.from_numpy(np.random.RandomState(8).permutation(n)
                               ).cuda()
        c = mp.cache
        nbytes, ops_n = approx_pass_work(c.valid, ids, solver.problem.d,
                                         steps)
        bms, by = bound_ms(nbytes, ops_n)
        timing[mode] = dict(
            blocks=n, valid_planes=int(c.valid.sum()), bound_ms=bms,
            bound_by=by, ms=time_ms(torch, lambda k: mpbcfw.run_pass(
                mp, ids, lam, steps), 3, warmup=1),
            plan=approx_plan(solver.problem.d, c.valid.shape[1], steps))
    emit("shard_stride", ranks=list(STRIDE_RANKS), blocks=STRIDE_BLOCKS,
         max_abs_err=errs, tolerance=f"{TOL} (1 + |ref|)",
         stride1_full_pass=timing, seconds=time.perf_counter() - t_phase)
    return max(errs.values()), timing


def phase_resume_shard(torch, mesh):
    """A world-size-1 sharded checkpoint (mpbcfw-shard on the card, SMALL
    ocr, 2 of 4 iterations): restore_resharded gives the saved state bit
    for bit, Solver.restore resumes the run bit for bit, and its files
    (the global arrays a single-device run writes), under the
    single-device engine's name, resume mpbcfw as mpbcfw's own run goes
    on.  ~5 s."""
    import shutil
    import tempfile
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.checkpoint import CheckpointManager, restore_resharded
    t_phase = time.perf_counter()
    sc, prob = small_problem("ocr", "cuda")

    def cfg(algo, **kw):
        return RunConfig(lam=1.0 / sc.n, algo=algo, max_iters=4, cap=16,
                         approx_batch=4, max_approx_passes=6,
                         cost_model=CostModel(sc.oracle_cost,
                                              sc.plane_cost), **kw)
    full = Solver(prob, cfg("mpbcfw-shard", mesh=mesh)).run().trace
    twin = Solver(prob, cfg("mpbcfw")).run().trace
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard_ckpt_")
    try:
        mgr = CheckpointManager(str(Path(tmp) / "shard"))
        head = Solver(prob, cfg("mpbcfw-shard", mesh=mesh))
        it = head.iterate()
        rows = [next(it) for _ in range(2)]
        step = head.save(mgr)
        tree, manifest = restore_resharded(mgr, head.state, mesh)
        leaves = [(a, b) for x, y in zip(tree, head.state)
                  for a, b in (zip(x, y) if isinstance(x, tuple)
                               else [(x, y)])]
        check(all(torch.equal(a, b) if isinstance(a, torch.Tensor)
                  else a == b for a, b in leaves),
              "resume_shard: restore_resharded differs from the saved state")
        tail = Solver.restore(prob, cfg("mpbcfw-shard", mesh=mesh), mgr)
        rows += list(tail.iterate())
        rows_bit_equal("resume_shard", rows, full)
        extra = dict(manifest["extra"], algo="mpbcfw")
        single = CheckpointManager(str(Path(tmp) / "single"))
        single.save(step, tree, extra=extra, metrics=manifest["metrics"])
        resumed = Solver.restore(prob, cfg("mpbcfw"), single)
        rows_bit_equal("resume_shard (mpbcfw)", list(resumed.iterate()),
                       twin[2:])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("resume_shard", scenario="SMALL[ocr]", algo="mpbcfw-shard",
         world_size=1, step=step, bitwise=True,
         duals=[r.dual for r in rows], seconds=time.perf_counter() - t_phase)


def phase_contracts(torch):
    """The program-contract checker on the card, in process:
    ``python -m repro_torch.analysis --strict --device cuda --json``.
    Every registered engine (the mesh-optional ones without and with the
    world-size-1 NCCL mesh) runs two outer iterations and an overflow
    batch on the tiny multiclass problem, and every serving trace case one
    decode round, each dispatch under a dispatch counter and sync-debug
    "error"; the AST lint of ``src/repro_torch``.  The report must be ok.
    Emits each engine's and serve case's facts: host syncs, collectives,
    the async programs, kernel launches.  The kernels layer again (H003,
    H004; it launches nothing), as the CLI runs it.  Returns the path's
    launches: the counts set to 0 just before the checker and read just
    after.  ~1 s on an H100 (0.8-1.3 s) before the kernels layer, ~3 s
    more with it; the CLI in a process of its own, with its start-up and
    kernel loads, ~23 s."""
    import contextlib
    import io
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    out = io.StringIO()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = analysis_main(["--strict", "--device", "cuda", "--json"])
    launches = ops.launch_counts()
    seconds = time.perf_counter() - t0
    report = json.loads(out.getvalue())
    check(rc == 0 and report["ok"], "contracts: findings "
          f"{report['findings'][:8]}")
    facts = report["facts"]
    engines = sorted(k for k in facts
                     if not k.startswith(("serve:", "kernels")))
    serve = sorted(k for k in facts if k.startswith("serve:"))
    check(len(engines) == 16 and len(serve) == 3
          and report["layers"] == ["program", "lint", "kernels"],
          f"contracts: ran {engines}, {serve} and {report['layers']}")
    keep = ("outer_syncs", "outer_collectives", "outer_setup", "outer_pass",
            "outer_programs", "continue_syncs", "continue_collectives",
            "launches", "device")
    emit("contracts", seconds=seconds, layers=report["layers"],
         ok=report["ok"], launches=launches,
         engines={k: {f: facts[k][f] for f in keep if f in facts[k]}
                  for k in engines},
         serve={k: v for k, v in facts.items() if k.startswith("serve:")})
    return launches


def phase_parity_specs(torch):
    """The multiclass and graph scenarios, mpbcfw on the card vs the CPU,
    3 iterations: the same schedule, duals within rtol 1e-4."""
    for name in ("usps", "horseseg"):
        traces = {dev: small_run(name, dev, "mpbcfw")[1].run().trace
                  for dev in ("cuda", "cpu")}
        emit("parity_specs", scenario=f"SMALL[{name}]",
             rows=compare_traces(f"parity_specs {name}", traces))


def phase_parity_simple(torch):
    """fw, ssg, bcfw, bcfw-avg and mpbcfw-avg on the card vs the CPU,
    SMALL ocr, 3 iterations: the same schedule, dispatches and host syncs
    (one each for the one-program engines), objectives within rtol 1e-4
    (ssg: NaN duals on both).  ~15 s."""
    out = {}
    for algo in SIMPLE_ALGOS:
        traces = {dev: small_run("ocr", dev, algo)[1].run().trace
                  for dev in ("cuda", "cpu")}
        for g, c in zip(traces["cuda"], traces["cpu"]):
            # One each for the one-program engines; mpbcfw-avg runs an
            # overflow batch where the slope rule wants more than 4 passes.
            check((g.dispatches, g.host_syncs) == (c.dispatches,
                                                   c.host_syncs)
                  and (algo == "mpbcfw-avg"
                       or (g.dispatches, g.host_syncs) == (1, 1)),
                  f"parity_simple {algo}: {g.dispatches} dispatches, "
                  f"{g.host_syncs} syncs at iteration {g.iteration}")
        out[algo] = compare_traces(f"parity_simple {algo}", traces)
    emit("parity_simple", scenario="SMALL[ocr]", rows=out)


def phase_main_simple(torch, data, phase: str, algo: str):
    """``algo`` (bcfw-avg, ssg or fw) on the full-size OCR scenario, 3
    outer iterations through the Solver, launch counts reset just before:
    one dispatch and one host sync per iteration, no approximate pass.
    bcfw and ssg decode each block at B=1 in one graph replay per block,
    fw all blocks at B=n once per iteration; every evaluation sweep is one
    B=n decode (two for bcfw-avg, whose primal_avg is a second sweep).
    Returns the run's launch counts.  ~4 s (bcfw-avg), ~3 (ssg), ~1
    (fw)."""
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.core.oracles import chain
    from repro_torch.kernels import ops
    X, Y, M = data
    n = OCR["n"]
    problem = chain.make_problem(X, Y, M, OCR["num_labels"], device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    solver = Solver(problem, RunConfig(
        lam=1.0 / n, algo=algo, max_iters=RUN["max_iters"], cap=RUN["cap"],
        cost_model=CostModel(oracle_cost=ORACLE_COST,
                             plane_cost=PLANE_COST)))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rows, walls = drive(torch, solver, phase, dual=algo != "ssg")
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_syncs(phase, rows, dispatches=1)
    last, iters = rows[-1], len(rows)
    check(last.n_exact == n * iters and last.n_approx == 0
          and all(r.approx_passes == 0 for r in rows),
          f"{phase}: n_exact {last.n_exact}, n_approx {last.n_approx}")
    check(launches["approx_pass"] == 0,
          f"{phase}: approx_pass launched {launches['approx_pass']} times")
    sweeps = 2 if algo == "bcfw-avg" else 1
    per_iter = (1 if algo == "fw" else n) + sweeps
    check(launches["viterbi_decode"] == per_iter * iters,
          f"{phase}: viterbi launches {launches['viterbi_decode']}, "
          f"expected {per_iter * iters}")
    if algo == "fw":
        replays = solver.engine.graphs.replays
        check(replays == 0, f"{phase}: {replays} graph replays")
    else:
        replays = check_replays(phase, solver, last.n_exact, captured=1)
    w = solver.result().w
    check(w.shape == (problem.d,) and all(map(math.isfinite, w.tolist())),
          f"{phase}: weights not finite")
    emit(phase, scenario="OCR", algo=algo, n=n, d=problem.d,
         iterations=iters, wall_s_per_iteration=walls,
         primal=[r.primal for r in rows], dual=[r.dual for r in rows],
         primal_avg=[r.primal_avg for r in rows],
         max_memory_allocated=peak, launches=launches,
         n_exact=last.n_exact, graph_replays=replays)
    return launches


# -- mpbcfw-gap: the policy layer on the card ------------------------------


class ScheduleLog:
    """Wraps ``GapSampling.schedule`` while active and keeps each call's
    ids (the tensor it returned, on its device), seed and policy: one list
    append per call, nothing copied, timed or read on the host.
    :meth:`snapshot` keeps a copy of the gap vector that the next schedule
    reads; the caller takes it between iterations."""

    def __init__(self, torch):
        from repro_torch.policy import GapSampling
        self.torch, self.cls = torch, GapSampling
        self.inner = GapSampling.schedule
        self.calls, self.gaps = [], []

    def __enter__(self):
        inner, calls = self.inner, self.calls

        def recorded(policy, cache, perm, key):
            ids = inner(policy, cache, perm, key)
            calls.append(dict(ids=ids, key=key, policy=policy))
            return ids
        self.cls.schedule = recorded
        return self

    def __exit__(self, *exc):
        self.cls.schedule = self.inner

    def snapshot(self, gap):
        self.gaps.append(gap.clone())

    def ids(self):
        return [c["ids"].cpu() for c in self.calls]

    def cpu_equal(self) -> bool:
        """Every schedule equal to the CPU's for its seed and the gap
        vector it read (the t-th snapshot for the t-th call)."""
        from repro_torch import cache as tcache
        check(len(self.gaps) >= len(self.calls),
              f"{len(self.gaps)} gap snapshots for {len(self.calls)} "
              "schedules")
        ok = True
        for c, gap in zip(self.calls, self.gaps):
            cpu = tcache.init(tcache.CacheLayout(cap=1, track_gap=True),
                              gap.shape[0], 1, "cpu")
            cpu.gap.copy_(gap.cpu())
            ok &= bool(self.torch.equal(
                self.inner(c["policy"], cpu, None, c["key"]),
                c["ids"].cpu()))
        return ok


def gap_pass_replay(torch, planes, valid, st0, gap0, perm, *, lam, k0,
                    outer_it):
    """The plain version with the gap output over ``perm``, one block per
    call (the same pass), from copies of ``st0`` (phi, phi_i, bar, last)
    and ``gap0``.  Returns the gap vector and, per block, the two scores
    its gap differences (the chosen plane's ``s`` and the iterate's
    ``s_i``): ``|s| + |s_i|`` and their dots' sum of |terms|."""
    from repro_torch import cache as tcache
    from repro_torch.core import mpbcfw
    from repro_torch.core.bcfw import plane_score
    from repro_torch.core.ssvm import weights_of
    st = {k: v.clone() for k, v in st0.items()}
    gap = gap0.clone()
    view = tcache.PlaneCache(planes=planes, valid=valid,
                             last_active=st["last"])
    scale, terms = torch.zeros_like(gap), torch.zeros_like(gap)
    one = gap.new_ones(1)
    for pos, i in enumerate(perm.tolist()):
        w = weights_of(st["phi"], lam)
        p, _, s = tcache.approx_oracle(view, i, w)
        row, wa = st["phi_i"][i], torch.cat([w.abs(), one])
        scale[i] = s.abs() + plane_score(row, w).abs()
        terms[i] = p.abs() @ wa + row.abs() @ wa
        mpbcfw.eager_pass(st["phi"], st["phi_i"], st["bar"], planes, valid,
                          st["last"], perm[pos:pos + 1], lam=lam,
                          k0=k0 + pos, outer_it=outer_it, gap=gap)
    return gap, scale, terms


def check_gap_pass(torch, what, planes, valid, st0, gap0, perm, *, lam, k0,
                   outer_it):
    """approx_pass with and without its gap output from one state ``st0``
    (phi, phi_i, bar, last) and gap vector ``gap0``, one pass over
    ``perm``: every other output bit-equal between the two launches, the
    launch without it leaving the gap vector alone; each visited block's
    gap >= 0 and within 3e-5 (|s| + |s_i|) + GAP_ULPS 2^-24 T of the plain
    version's (:func:`gap_pass_replay`; the gap is a difference of two
    nearly equal scores, so no relative tolerance on it means anything),
    the unvisited blocks' untouched.  The check's power on this state: a
    zeroed gap vector and the stale one (``gap0``: a launch that wrote
    nothing) must each fail it, and the blocks at which they fail are
    counted.  Returns the readings."""
    from repro_torch.kernels import ops
    outs = []
    for with_gap in (False, True):
        st = {k: v.clone() for k, v in st0.items()}
        gap = gap0.clone()
        ops.approx_pass(st["phi"], st["phi_i"], st["bar"], planes, valid,
                        st["last"], perm, lam=lam, k0=k0, outer_it=outer_it,
                        gap=gap if with_gap else None)
        outs.append((st, gap))
    (a, gap_a), (b, got) = outs
    check(all(torch.equal(a[k], b[k]) for k in a),
          f"{what}: the gap output moved another output's bits")
    check(torch.equal(gap_a, gap0),
          f"{what}: a launch without the gap output wrote the gap vector")
    t0 = time.perf_counter()
    want, scale, terms = gap_pass_replay(torch, planes, valid, st0, gap0,
                                         perm, lam=lam, k0=k0,
                                         outer_it=outer_it)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    seen = torch.zeros_like(valid[:, 0])
    seen[perm] = True
    allowed = (3e-5 * scale + GAP_ULPS * 2.0 ** -24 * terms)[seen]
    tiny = torch.finfo(torch.float32).tiny

    def failing(g):
        return int(((g - want).abs()[seen] > allowed).sum())
    err = (got - want).abs()[seen]
    out = dict(
        blocks=int(seen.sum()), max_abs_err=float(err.max()),
        err_over_allowed=float((err / allowed.clamp_min(tiny)).max()),
        err_in_ulps_of_terms=float((err / (2.0 ** -24 * terms[seen])
                                    .clamp_min(tiny)).max()),
        positive=int((want[seen] > 0).sum()),
        median_gap=float(want[seen].median()),
        median_allowed=float(allowed.median()),
        fail_if_zeroed=failing(torch.zeros_like(got)),
        fail_if_stale=failing(gap0), replay_s=replay_s)
    emit("gap_output", what=what, **out)
    check(failing(got) == 0, f"{what}: gap output max err {out['max_abs_err']}"
          f", {out['err_over_allowed']} of the allowance")
    check(bool((got[seen] >= 0).all()), f"{what}: a negative gap")
    check(torch.equal(got[~seen], gap0[~seen]),
          f"{what}: the gap of a block the pass did not visit moved")
    check(out["fail_if_zeroed"] > 0 and out["fail_if_stale"] > 0,
          f"{what}: a zeroed or a stale gap vector passes the check")
    return out


def phase_parity_gap(torch):
    """mpbcfw-gap on the card vs the CPU, 4 iterations on SMALL ocr, usps
    and horseseg with the port's own noise: every iteration's schedule
    equal, the same schedule counts, duals, primals and gap_total within
    rtol 1e-4, gap_sampled equal.  Then approx_pass with and without the
    gap output on the trained SMALL ocr state (check_gap_pass).  ~15 s.
    Returns that check's readings."""
    out, state = {}, None
    for name in ("ocr", "usps", "horseseg"):
        traces, logs = {}, {}
        for dev in ("cuda", "cpu"):
            _, solver = small_run(name, dev, "mpbcfw-gap", max_iters=4)
            with ScheduleLog(torch) as log:
                traces[dev] = solver.run().trace
            logs[dev] = log.ids()
            if name == "ocr" and dev == "cuda":
                state = solver
        rows = compare_traces(f"parity_gap {name}", traces)
        check(len(logs["cuda"]) == len(logs["cpu"]) == 4
              and all(torch.equal(a, b) for a, b in zip(logs["cuda"],
                                                        logs["cpu"])),
              f"parity_gap {name}: the schedules differ")
        for g, c in zip(traces["cuda"], traces["cpu"]):
            check(g.gap_sampled == c.gap_sampled
                  and abs(g.gap_total - c.gap_total)
                  <= 1e-4 * abs(c.gap_total) + 1e-7,
                  f"parity_gap {name}: gap columns {g.gap_total}, "
                  f"{g.gap_sampled} vs {c.gap_total}, {c.gap_sampled}")
        out[name] = dict(rows=rows, gap_total=[[g.gap_total, c.gap_total]
                                               for g, c in zip(
                                                   traces["cuda"],
                                                   traces["cpu"])],
                         gap_sampled=[g.gap_sampled
                                      for g in traces["cuda"]])
    mp = state.state
    c = mp.cache
    n = c.valid.shape[0]
    perm = torch.randperm(n, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(1))
    gap_check = check_gap_pass(
        torch, "parity_gap SMALL ocr", c.planes, c.valid,
        dict(phi=mp.inner.phi, phi_i=mp.inner.phi_i, bar=mp.avg.bar_approx,
             last=c.last_active), c.gap, perm, lam=state.cfg.lam,
        k0=mp.avg.k_approx, outer_it=mp.outer_it)
    emit("parity_gap", scenarios=out, gap_output=gap_check,
         tolerance="duals, primals, gap_total rtol 1e-4; schedules and "
         f"gap_sampled equal; {GAP_TOL}")
    return gap_check


def schedule_cost(torch, policy, cache, calls: int = 10):
    """The gap sampler's schedule on a trained cache: one call under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises), the
    host ms per call to enqueue it (``calls`` calls, one sync after), and
    one call under torch.profiler: its kernels' summed device us, device
    events and span."""
    from repro_torch.analysis import sync_debug
    torch.cuda.synchronize()
    with sync_debug(torch.device("cuda")):
        policy.schedule(cache, None, 12345)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(calls):
        policy.schedule(cache, None, s)
    host = (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    tr = traced(torch, lambda: policy.schedule(cache, None, 7))
    return dict(no_host_sync=True, host_ms_per_call=1e3 * host,
                device_us=tr["device_us"], device_events=tr["device_events"],
                device_span_us=tr["device_span_us"],
                traced_wall_ms=tr["wall_ms"],
                top_device_us=tr["top_device_us"])


def phase_main_gap(torch, data, main_pass_ms: float):
    """mpbcfw-gap on the full-size OCR scenario with the reference's
    defaults (gap_frac 0.5, temperature 2.0, floor 0.1), RUN's cache and
    passes, 4 iterations, launch counts reset just before: one dispatch
    and one sync per iteration, k = round(0.5 n) = 3438 exact blocks per
    iteration (one graph replay each), iteration 1 the blocks 0..3437 in
    order; from iteration 2 on no block is unseen (the approximate passes
    wrote a gap, 0 for the blocks no exact step reached) and each
    schedule, sampled on the card, equals the CPU's for its gap vector and
    seed (the schedules are logged without a copy or a sync; the gap
    vectors they read are copied between iterations, outside the timed
    windows).  Then, on the trained state: approx_pass with its gap output
    over a full pass against the plain version (:func:`check_gap_pass`,
    the main path's shape), its ms per full pass with and without the gap
    output (beside ``main_pass_ms``, main's), the schedule's cost
    (:func:`schedule_cost`), an exact window's device ops and B3 us per
    block.  Returns the run's launch counts, the gap output's timing and
    its check.  ~25 s."""
    import numpy as np
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.core import mpbcfw
    from repro_torch.core.oracles import chain
    from repro_torch.core.types import index_tensor
    from repro_torch.kernels import ops
    X, Y, M = data
    n = OCR["n"]
    problem = chain.make_problem(X, Y, M, OCR["num_labels"], device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    solver = Solver(problem, RunConfig(
        lam=1.0 / n, cost_model=CostModel(oracle_cost=ORACLE_COST,
                                          plane_cost=PLANE_COST),
        **RUN_GAP))
    k = max(1, round(0.5 * n))
    torch.cuda.synchronize()
    log = ScheduleLog(torch)

    def snapshot(row=None):
        log.snapshot(solver.state.cache.gap)
        torch.cuda.synchronize()            # the copy outside the next window
    snapshot()
    ops.reset_launch_counts()
    with log:
        sync_checked(torch, "main_gap", solver.engine)
        rows, walls = drive(torch, solver, "main_gap", after=snapshot)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_syncs("main_gap", rows, dispatches=1)
    for r in rows:
        check(r.gap_sampled == k and r.n_exact == k * (r.iteration + 1),
              f"main_gap: gap_sampled {r.gap_sampled}, n_exact {r.n_exact}"
              f" at iteration {r.iteration}")
        check(r.gap_total is not None and math.isfinite(r.gap_total)
              and r.gap_total >= 0, f"main_gap: gap_total {r.gap_total}")
    last = rows[-1]
    passes = sum(r.approx_passes for r in rows)
    check(last.n_approx == n * passes, f"main_gap: n_approx {last.n_approx}")
    check(launches["approx_pass"] == RUN_GAP["approx_batch"] * len(rows)
          and passes > 0, f"main_gap: approx_pass launches "
          f"{launches['approx_pass']} for {passes} passes")
    check(launches["viterbi_decode"] >= last.n_exact,
          f"main_gap: viterbi launches {launches['viterbi_decode']}")
    check(launches["plane_scores"] == 0 and launches["plane_select"] == 0,
          f"main_gap: plane_scores {launches['plane_scores']}, "
          f"plane_select {launches['plane_select']}")
    replays = check_replays("main_gap", solver, last.n_exact, captured=1)
    ids = log.ids()
    check(len(ids) == len(rows) and torch.equal(ids[0], torch.arange(k)),
          "main_gap: iteration 1 is not the blocks 0..k-1 in order")
    g2 = log.gaps[1]
    check(bool((g2[k:] == 0).all()) and not bool((g2 >= 1e29).any()),
          "main_gap: after iteration 1 a block is still unseen, or a block "
          "no exact step reached has a gap")
    check(log.cpu_equal(), "main_gap: a card schedule differs from the "
          "CPU's for the same gap vector and seed")
    w = solver.result().w
    check(w.shape == (problem.d,) and all(map(math.isfinite, w.tolist())),
          "main_gap: weights not finite")
    # The approximate pass with and without the gap output on the trained
    # state: held against the plain version at this shape, then timed,
    # alternated; then an exact window of the gap step.
    mp, lam = solver.state, solver.cfg.lam
    c = mp.cache
    perm = index_tensor(np.random.RandomState(2).permutation(n), "cuda")
    gap_check = check_gap_pass(
        torch, "main_gap OCR", c.planes, c.valid,
        dict(phi=mp.inner.phi, phi_i=mp.inner.phi_i, bar=mp.avg.bar_approx,
             last=c.last_active), c.gap, perm, lam=lam, k0=mp.avg.k_approx,
        outer_it=mp.outer_it)

    def one(gap):
        ops.approx_pass(mp.inner.phi, mp.inner.phi_i, mp.avg.bar_approx,
                        c.planes, c.valid, c.last_active, perm, lam=lam,
                        k0=mp.avg.k_approx, outer_it=mp.outer_it, gap=gap)
    timing = {"ms_without_gap": [], "ms_with_gap": []}
    for _ in range(2):
        timing["ms_without_gap"].append(time_ms(torch, lambda i: one(None),
                                                3, warmup=1))
        timing["ms_with_gap"].append(time_ms(torch, lambda i: one(c.gap), 3,
                                             warmup=1))
    timing["main_ms_without_gap"] = main_pass_ms
    timing["gap_over_plain"] = (sum(timing["ms_with_gap"])
                                / sum(timing["ms_without_gap"]))
    sched = schedule_cost(torch, log.calls[-1]["policy"], c)
    graphs = solver.engine.graphs
    window = 1024
    exact = graph_window(torch, lambda: mpbcfw.exact_pass(
        problem, mp, perm[:window], lam, graphs=graphs), graphs, window,
        kernels=("viterbi",))
    b3 = exact.pop("kernel_us")["viterbi"]
    check(exact["replays_per_block"] == 1.0 and b3["calls"] == window,
          f"main_gap: exact window {exact['replays_per_block']} replays, "
          f"{b3['calls']} viterbi kernels per {window} blocks")
    emit("main_gap", scenario="OCR", n=n, d=problem.d, k=k,
         iterations=len(rows), wall_s_per_iteration=walls,
         n_exact=[r.n_exact for r in rows],
         gap_sampled=[r.gap_sampled for r in rows],
         gap_total=[r.gap_total for r in rows],
         approx_passes=[r.approx_passes for r in rows],
         dual=[r.dual for r in rows], primal=[r.primal for r in rows],
         schedule_heads=[x[:8].tolist() for x in ids],
         unvisited_in_schedule=[int((x >= k).sum()) for x in ids],
         schedule=sched, max_memory_allocated=peak,
         launches=launches, graph_replays=replays,
         approx_pass_full=timing, gap_output=gap_check,
         exact_window=dict(device_ops_per_block=exact[
             "device_ops_per_block"], viterbi_us_per_block=b3["us"] / window,
             device_us_per_block=exact["device_us_per_block"],
             host_ms_per_block=exact["host_ms_per_block"],
             ms_per_block=exact["ms_per_block"]))
    return launches, timing, gap_check


def phase_wide(torch, gen):
    """ROADMAP C6 on the card.  The wide plan against the eager pass at
    WIDE_PASSES (one pass each: stamps equal, phi, phi_i and the average
    within TOL (1 + |ref|); a block with every slot valid); then mpbcfw
    and mpbcfw-gram, 3 iterations each at the SSVM head's settings on a
    chain of d = 25,625, launch counts reset just before each: one
    dispatch and one sync per iteration, one wide approx_pass launch per
    queued pass; then one full wide pass over each trained state, timed
    beside the eager pass (~0.5 s plain, ~3 s Sec-3.5) and its bound.
    Returns ``(errors, timing, launches by path)``.  ~35 s."""
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.core import mpbcfw
    from repro_torch.core.oracles import chain
    from repro_torch.data.synthetic import ocr_like
    from repro_torch.kernels import approx_pass as t_ap
    from repro_torch.kernels import ops
    lam = 1.0 / OCR["n"]
    errs = {}
    for nb, cap, d, steps in WIDE_PASSES:
        mode = "plain" if steps is None else "gram"
        check(t_ap.plan(d, cap, steps or 0).wide,
              f"wide: ({d}, {cap}, {mode}) is staged")
        planes, valid, gram, state = _approx_state(torch, gen, nb, cap, d,
                                                   steps)
        valid[1] = True                  # every slot valid in one block
        perm = torch.randperm(nb, generator=gen, device="cuda")
        got = {k: v.clone() for k, v in state.items()}
        want = {k: v.clone() for k, v in state.items()}
        for fn, st in ((ops.approx_pass, got), (mpbcfw.eager_pass, want)):
            fn(st["phi"], st["phi_i"], st["bar"], planes, valid, st["last"],
               perm, lam=lam, k0=7000, outer_it=5, gram=gram, steps=steps)
        torch.cuda.synchronize()
        errs[f"{nb}x{cap}x{d}_{mode}"] = _pass_close(
            torch, got, want, f"wide {nb}x{cap}x{d} {mode}")
        del planes, valid, gram, state, got, want
    torch.cuda.empty_cache()

    X, Y, M = ocr_like(**WIDE_DATA)
    n = WIDE_DATA["n"]
    problem = chain.make_problem(X, Y, M, WIDE_DATA["num_labels"],
                                 device="cuda")
    check(problem.d == 25625, f"wide: d = {problem.d}, expected 25625")
    timing, by_path = {}, {}
    for algo, phase in (("mpbcfw", "wide_mpbcfw"),
                        ("mpbcfw-gram", "wide_gram")):
        steps = WIDE_RUN["gram_steps"] if algo == "mpbcfw-gram" else None
        check(t_ap.plan(problem.d, WIDE_RUN["cap"], steps or 0).wide,
              f"{phase}: not the wide plan")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        solver = Solver(problem, RunConfig(
            lam=1.0 / n, algo=algo,
            cost_model=CostModel(oracle_cost=HEAD_ORACLE_COST,
                                 plane_cost=PLANE_COST), **WIDE_RUN))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rows, walls = drive(torch, solver, phase)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_syncs(phase, rows, dispatches=1)
        passes = sum(r.approx_passes for r in rows)
        check(passes > 0 and launches["approx_pass"]
              == WIDE_RUN["approx_batch"] * len(rows),
              f"{phase}: approx_pass launches {launches['approx_pass']} "
              f"for {passes} passes")
        check(launches["viterbi_decode"] >= rows[-1].n_exact,
              f"{phase}: viterbi launches {launches['viterbi_decode']}")
        by_path[phase] = launches
        mp, c = solver.state, solver.state.cache
        ids = torch.randperm(n, generator=gen, device="cuda")
        nbytes, ops_n = approx_pass_work(c.valid, ids, problem.d, steps)
        bms, by = bound_ms(nbytes, ops_n)

        def one(fn):
            fn(mp.inner.phi, mp.inner.phi_i, mp.avg.bar_approx, c.planes,
               c.valid, c.last_active, ids, lam=solver.cfg.lam,
               k0=mp.avg.k_approx, outer_it=mp.outer_it,
               gram=c.gram if steps else None, steps=steps)
        ms = time_ms(torch, lambda k: one(ops.approx_pass), 3, warmup=1)
        plain_ms = time_ms(torch, lambda k: one(mpbcfw.eager_pass), 1,
                           warmup=0)
        timing[phase] = dict(blocks=n, cap=WIDE_RUN["cap"], d=problem.d,
                             valid_planes=int(c.valid.sum()), ms=ms,
                             us_per_block=1e3 * ms / n, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by,
                             plan=approx_plan(problem.d, WIDE_RUN["cap"],
                                              steps))
        emit(phase, scenario="chain n={n} f={f} C={num_labels}".format(
            **WIDE_DATA), d=problem.d,
             iterations=len(rows), wall_s_per_iteration=walls,
             approx_passes=[r.approx_passes for r in rows],
             max_memory_allocated=peak, launches=launches,
             approx_pass_full=timing[phase])
        del solver, mp, c
    emit("wide", max_abs_err=errs, tolerance="one pass: activity stamps "
         "equal, |err| <= 3e-5 (1+|ref|)", timing=timing)
    torch.cuda.empty_cache()
    return errs, timing, by_path


def decode_objective(torch, model, example, labels) -> float:
    """What a decode maximizes, ``<w, psi(x, y)> + Delta(y_true, y) +
    offset(y)``, for one labeling of one example (the spec's own features,
    loss and offset on a batch of one)."""
    import numpy as np
    dev = model.w.device
    batch = {k: torch.from_numpy(np.array(v)).to(dev)[None]
             for k, v in example.items()}
    y = torch.from_numpy(np.array(labels)).to(dev)[None]
    spec = model.spec
    score = (spec.features(batch, y) @ model.w + spec.loss(batch, y)
             + spec.offset(batch, y))
    return float(score[0])


def score_bit_differences(torch, model, engine, reqs):
    """Over ``reqs`` batched as the server batches them (``SERVE_BATCH``
    rows padded to their bucket): how many get scores (``spec.scores``,
    the unaries or class scores, the decode's only sums over features)
    that differ in any bit from their per-example decode's, when the bucket
    is scored as one batch, and when each row is scored alone, as the
    engines do.  ROADMAP §C logs the counts."""
    import numpy as np
    from repro_torch.serve import bucket_key
    spec, w = model.spec, model.w
    groups = {}
    for r in reqs:
        groups.setdefault(bucket_key(engine.shape_key(r), SERVE_GRANULARITY),
                          []).append(r)
    batched = rows = 0
    for bucket, rs in groups.items():
        for s in range(0, len(rs), SERVE_BATCH):
            chunk = [engine.pad(r, bucket) for r in rs[s:s + SERVE_BATCH]]
            padded = chunk + [chunk[-1]] * (SERVE_BATCH - len(chunk))
            batch = {k: torch.from_numpy(np.stack([p[k] for p in padded]))
                     .cuda() for k in padded[0]}
            together = spec.scores(w, batch)
            for i, r in enumerate(rs[s:s + SERVE_BATCH]):
                alone = spec.scores(w, {
                    k: torch.from_numpy(np.array(v)).cuda()[None]
                    for k, v in r.items()})[0]
                row = spec.scores(w, {k: v[i:i + 1]
                                      for k, v in batch.items()})[0]
                m = alone.shape[0]
                batched += not torch.equal(together[i][:m], alone)
                rows += not torch.equal(row[:m], alone)
    return batched, rows


def serve_and_check(torch, phase: str, model, reqs, checked, *,
                    chain: bool, keep=None, **info):
    """Serve ``reqs`` through a :class:`StructuredServer` on the card
    (``SERVE_BATCH`` rows, buckets on a ``SERVE_GRANULARITY`` grid), all
    admitted up front, launch counts reset just before and read just
    after; then hold the served labels of the requests ``checked`` to the
    model's per-example decode (a differing label passes only as a near
    tie, its objective within ``NEAR_TIE_RTOL`` of the per-example one),
    and count the requests whose scores differ in bits from the
    per-example decode's (:func:`score_bit_differences`, the first
    ``SERVE_BITS_LIMIT``).
    Checks one dispatch, one sync and one graph replay per round, one
    captured graph per occupied bucket, and B3 launched once per round on
    a chain model and never otherwise.  Emits ``phase``; returns the
    launch counts, and puts the served labels, in request order, under
    ``keep["served"]`` when ``keep`` is a dict."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import StructuredServer, bucket_key
    server = StructuredServer(model, batch_size=SERVE_BATCH,
                              bucket_granularity=SERVE_GRANULARITY)
    engine = server.engine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        server.submit(r)
    done = server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rounds, dispatches, syncs = server.ledger.counts()
    buckets = sorted({bucket_key(engine.shape_key(r), SERVE_GRANULARITY)
                      for r in reqs})
    check(len(done) == len(reqs), f"{phase}: served {len(done)} of "
          f"{len(reqs)} requests")
    check(dispatches == syncs == engine.replays == rounds,
          f"{phase}: {rounds} rounds, {dispatches} dispatches, {syncs} "
          f"syncs, {engine.replays} graph replays")
    check(len(engine.programs) == len(buckets),
          f"{phase}: {len(engine.programs)} captured graphs for "
          f"{len(buckets)} buckets")
    want = {k: 0 for k in launches}
    want["viterbi_decode"] = rounds if chain else 0
    check(launches == want, f"{phase}: launches {launches}, expected "
          f"{want}")
    served = [r.labels for r in sorted(done, key=lambda r: r.rid)]
    if keep is not None:
        keep["served"] = served
    t1 = time.perf_counter()
    wrong, near_ties = [], []
    for i in checked:
        ref = model.decode(reqs[i]).cpu().numpy()
        if np.array_equal(served[i], ref):
            continue
        a = decode_objective(torch, model, reqs[i], served[i])
        b = decode_objective(torch, model, reqs[i], ref)
        if abs(a - b) <= NEAR_TIE_RTOL * max(abs(a), abs(b)):
            near_ties.append([int(i), a, b])
        else:
            wrong.append([int(i), a, b])
    check_s = time.perf_counter() - t1
    check(not wrong, f"{phase}: {len(wrong)} served labelings differ from "
          f"the per-example decode beyond a near tie: {wrong[:5]}")
    bits_reqs = reqs[:SERVE_BITS_LIMIT]
    bits_batched, bits_rows = score_bit_differences(torch, model, engine,
                                                    bits_reqs)
    lat = np.array([r.latency for r in done])
    labels = sum(int(r.labels.size) for r in done)
    hist = server.metrics.registry.histogram
    result = dict(
        requests=len(reqs), rounds=rounds, dispatches=dispatches,
        host_syncs=syncs, graph_replays=engine.replays,
        captured_graphs=len(engine.programs),
        buckets=[list(b) for b in buckets], batch_size=SERVE_BATCH,
        seconds=wall, requests_per_s=len(reqs) / wall,
        labels_per_s=labels / wall, ms_per_round=1e3 * wall / rounds,
        latency_p50_s=float(np.percentile(lat, 50)),
        latency_p99_s=float(np.percentile(lat, 99)),
        metrics_latency_p50_s=server.metrics.latency_quantile(0.5),
        metrics_latency_p99_s=server.metrics.latency_quantile(0.99),
        metrics_round_p50_s=hist("serve_round_time").quantile(0.5),
        metrics_round_p99_s=hist("serve_round_time").quantile(0.99),
        max_memory_allocated=peak, launches=launches,
        checked=len(checked), near_ties=near_ties, check_s=check_s,
        score_bits_compared=len(bits_reqs),
        score_bits_differ_batched=bits_batched,
        score_bits_differ_by_row=bits_rows,
        profile=profile_rounds(torch, server, reqs[:SERVE_PROFILE]),
        **info)
    emit(phase, **result)
    return launches


def profile_rounds(torch, server, reqs):
    """Where a round's time goes, on the server's captured graphs: ``reqs``
    served again, each round's host time split into padding, stacking,
    ``decode`` (one pinned copy per leaf and the replay's enqueue) and the
    sync (waiting for the card, then the labels' copy), in ms per round;
    then the same rounds traced (device busy share, device us per round).
    """
    engine, ledger = server.engine, server.ledger
    spent = dict(pad=0.0, stack=0.0, decode=0.0, sync=0.0)

    def timed(name, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            spent[name] += time.perf_counter() - t0
            return out
        return run
    engine.pad, engine.stack, engine.decode = (
        timed("pad", engine.pad), timed("stack", engine.stack),
        timed("decode", engine.decode))
    ledger.sync = timed("sync", ledger.sync)
    r0 = ledger.rounds
    t0 = time.perf_counter()
    server.serve(reqs)
    wall = time.perf_counter() - t0
    rounds = ledger.rounds - r0
    del engine.pad, engine.stack, engine.decode, ledger.sync
    r0 = ledger.rounds
    tr = traced(torch, lambda: server.serve(reqs))
    traced_rounds = ledger.rounds - r0
    return dict(requests=len(reqs), rounds=rounds,
                ms_per_round=1e3 * wall / rounds,
                **{f"{k}_ms_per_round": 1e3 * v / rounds
                   for k, v in spent.items()},
                traced_device_us_per_round=tr["device_us"] / traced_rounds,
                traced_device_busy_share=tr["device_busy_share"],
                traced_top_device_us=tr["top_device_us"])


def chain_requests(X, Y, M):
    """Host requests trimmed to their true lengths."""
    return [{"x": X[i, :L], "y": Y[i, :L], "mask": M[i, :L]}
            for i, L in enumerate(M.sum(axis=1).tolist())]


def phase_serve(torch, model, data, keep=None):
    """The trained full-size OCR model (``main``'s 3 iterations, exported
    by ``Solver.servable()`` right after them) saved, loaded onto the card
    and served: all 6877 training examples trimmed to their lengths
    (buckets 4/8/12/16), 8 rows per round, every labeling held to its
    per-example decode.  ~8 s."""
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.serve import ServableModel
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model.save(CheckpointManager(tmp))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = ServableModel.load(CheckpointManager(tmp))
        load_s = time.perf_counter() - t0
    check(loaded.w.device.type == "cuda" and torch.equal(loaded.w, model.w)
          and loaded.spec == model.spec and loaded.meta == model.meta,
          "serve: the loaded model differs from the export")
    return serve_and_check(
        torch, "serve", loaded, chain_requests(*data), range(OCR["n"]),
        chain=True, keep=keep, scenario="OCR",
        d=loaded.d, meta=loaded.meta, save_s=save_s, load_s=load_s)


def phase_serve_specs(torch):
    """Full-width usps (n = 7291, f = 256, C = 10; every request checked)
    and horseseg (16x16 lattices, f = 649, 40 ICM sweeps; n cut to 512,
    a seeded sample of 256 checked), random weights as serving_bench.py
    makes them.  ~20 s."""
    import numpy as np
    from repro_torch.core.oracles.graph import GraphSpec
    from repro_torch.core.oracles.multiclass import MulticlassSpec
    from repro_torch.data import synthetic
    from repro_torch.serve import ServableModel

    def weights(spec, x):
        d = spec.dim({"x": x})
        return torch.from_numpy(np.random.RandomState(7).randn(d).astype(
            np.float32)).cuda()
    out = {}
    x, y = synthetic.usps_like(**SERVE_USPS)
    spec = MulticlassSpec(SERVE_USPS["num_classes"])
    model = ServableModel(spec, weights(spec, x))
    out["serve_usps"] = serve_and_check(
        torch, "serve_usps", model, [{"x": x[i], "y": y[i]}
                                     for i in range(len(x))],
        range(len(x)), chain=False, scenario="USPS", d=model.d)
    t0 = time.perf_counter()
    arrays = synthetic.horseseg_like(**SERVE_HORSESEG)
    data_s = time.perf_counter() - t0
    keys = ("x", "y", "mask", "edges", "edge_mask", "color")
    n = SERVE_HORSESEG["n"]
    reqs = [{k: a[i] for k, a in zip(keys, arrays)} for i in range(n)]
    spec = GraphSpec(num_sweeps=HORSESEG_SWEEPS)
    model = ServableModel(spec, weights(spec, arrays[0]))
    checked = sorted(np.random.RandomState(0).choice(
        n, SERVE_HORSESEG_CHECKED, replace=False).tolist())
    out["serve_horseseg"] = serve_and_check(
        torch, "serve_horseseg", model, reqs, checked, chain=False,
        scenario="HORSESEG",
        d=model.d, data_s=data_s)
    return out


# -- observability on the card ------------------------------------------------


def sync_checked_recorder(torch, path, **kw):
    """A :class:`repro_torch.obs.RunRecorder` whose every callback (the
    Solver's row callback and phase fit, the server's spans and events,
    open and close) runs under ``torch.cuda.set_sync_debug_mode("error")``,
    so a host sync inside one raises; it counts its callbacks and their
    host seconds by callback (outermost calls only; ``host_s`` the rows'
    and phase fits' alone, the per-iteration cost, without open and
    close)."""
    from repro_torch.analysis import sync_debug
    from repro_torch.obs import RunRecorder
    cuda = torch.device("cuda")

    class SyncChecked(RunRecorder):
        def __init__(self, *a, **k):
            self.calls, self._depth, self.host_by = 0, 0, {}
            super().__init__(*a, **k)

        @property
        def host_s(self):
            return sum(v for k, v in self.host_by.items()
                       if k not in ("open_run", "open_custom", "close"))

        def _guard(self, fn, *a, **k):
            if self._depth:
                return fn(*a, **k)
            self._depth += 1
            t0 = time.perf_counter()
            try:
                with sync_debug(cuda):
                    return fn(*a, **k)
            finally:
                name = fn.__name__
                self.host_by[name] = (self.host_by.get(name, 0.0)
                                      + time.perf_counter() - t0)
                self.calls += 1
                self._depth -= 1

        def open_run(self, solver):
            return self._guard(super().open_run, solver)

        def open_custom(self, **k):
            return self._guard(super().open_custom, **k)

        def __call__(self, solver, row):
            return self._guard(super().__call__, solver, row)

        def observe_phases(self, segments):
            return self._guard(super().observe_phases, segments)

        def span_record(self, *a, **k):
            return self._guard(super().span_record, *a, **k)

        def event(self, *a, **k):
            return self._guard(super().event, *a, **k)

        def close(self):
            return self._guard(super().close)
    return SyncChecked(path, **kw)


def check_phase_tiling(phase: str, run) -> float:
    """Each iteration's phase spans tile its ``outer_iteration`` span: the
    first starts at its start, each next one where the previous ended, the
    last no later than its end.  Returns the largest uncovered tail (the
    loop's host work after the iteration's last sync), seconds."""
    tail = 0.0
    for outer in (s for s in run["spans"] if s["name"] == "outer_iteration"):
        it = outer["iteration"]
        ph = sorted(((s["t0"], s["t1"]) for s in run["spans"]
                     if s.get("iteration") == it
                     and s["name"] != "outer_iteration"))
        check(ph and ph[0][0] == outer["t0"],
              f"{phase}: iteration {it}'s phases start at {ph[:1]}, its "
              f"span at {outer['t0']}")
        for (_, a1), (b0, _) in zip(ph, ph[1:]):
            check(abs(b0 - a1) <= 1e-9 * max(1.0, abs(a1)),
                  f"{phase}: iteration {it}'s phases leave a gap "
                  f"{a1}..{b0}")
        check(ph[-1][1] <= outer["t1"] + 1e-9,
              f"{phase}: iteration {it}'s phases end at {ph[-1][1]}, after "
              f"its span's end {outer['t1']}")
        tail = max(tail, outer["t1"] - ph[-1][1])
    return tail


def check_trace_file(phase: str, path, rows: int):
    """The recorded file: valid under the port's schema, its summary's
    contract one sync and one dispatch per iteration within budget, its
    Chrome-trace export holding X, C and M events.  Returns the summary."""
    from repro_torch.obs import (export_chrome_trace, load_run, summarize,
                                 validate_file)
    count, errs = validate_file(path)
    check(not errs, f"{phase}: schema errors {errs[:5]}")
    run = load_run(path)
    s = summarize(run)
    check(s["iterations"] == rows, f"{phase}: {s['iterations']} rows in "
          f"the file for {rows} iterations")
    out = Path(str(path) + ".trace.json")
    n = export_chrome_trace(path, out)
    phs = {e["ph"] for e in json.loads(out.read_text())["traceEvents"]}
    check({"X", "C", "M"} <= phs, f"{phase}: trace event kinds {phs}")
    return run, s, dict(records=count, trace_events=n,
                        trace_kinds=sorted(phs))


def phase_obs(torch, data, main_rows, main_launches, main_walls):
    """``main`` again with a RunRecorder: a fresh mpbcfw on the full-size
    OCR scenario, main's RUN, CostModel and seed, every recorder callback
    under sync-debug "error".  Rows bit-equal to main's, launch counts
    equal, the file schema-valid with one sync and one dispatch per
    iteration within budget, its Chrome-trace export written.  Returns the
    launch counts.  ~6 s."""
    t_phase = time.perf_counter()
    import dataclasses
    import tempfile
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.core.oracles import chain
    from repro_torch.kernels import ops
    X, Y, M = data
    n = OCR["n"]
    problem = chain.make_problem(X, Y, M, OCR["num_labels"], device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "obs.jsonl"
        rec = sync_checked_recorder(torch, path)
        solver = Solver(problem, RunConfig(
            lam=1.0 / n, cost_model=CostModel(oracle_cost=ORACLE_COST,
                                              plane_cost=PLANE_COST),
            **RUN), recorder=rec)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rows, walls = drive(torch, solver, "obs")
        launches = ops.launch_counts()
        rec.close()
        calls, host_s, host_by = rec.calls, rec.host_s, rec.host_by
        check(calls == 2 + len(rows), f"obs: {calls} recorder callbacks "
              f"under sync-debug error for {len(rows)} rows")
        check(len(rows) == len(main_rows) and all(
            dataclasses.astuple(a) == dataclasses.astuple(b)
            for a, b in zip(rows, main_rows)),
            f"obs: rows differ from main's: {rows} vs {main_rows}")
        check(launches == main_launches,
              f"obs: launches {launches}, main's {main_launches}")
        check(launches["viterbi_decode"] > 0 and launches["approx_pass"] > 0,
              f"obs: launches {launches}")
        run, s, info = check_trace_file("obs", path, len(rows))
        c = s["contract"]
        check(c["host_syncs_per_iter_max"] == c["dispatches_per_iter_max"]
              == 1 and c["within_budget"], f"obs: contract {c}")
        tail = check_phase_tiling("obs", run)
    emit("obs", scenario="OCR", iterations=len(rows), launches=launches,
         seconds=time.perf_counter() - t_phase,
         rows_bit_equal_to_main=True, recorder_callbacks=calls,
         sync_debug_mode="error",
         recorder_host_ms_per_iteration=1e3 * host_s / len(rows),
         recorder_host_ms_by_callback={k: 1e3 * v for k, v in
                                       host_by.items()},
         wall_s_per_iteration=walls, main_wall_s_per_iteration=main_walls,
         contract=c, calls_to_gap=s["calls_to_gap"],
         phase_time=s["phase_time"], untiled_tail_s=tail, **info)
    return launches


def phase_obs_wall(torch, data, profile_timing):
    """The recorded run in wall mode (cost_model=None) with approx_batch 2
    and at most 8 passes, so overflow continuations give approximate-only
    segments: one sync per dispatch and one segment per dispatch, the
    Solver's slope-rule constants the recorder's fit whenever it has one,
    measured approx_passes spans once a continuation ran, and each
    iteration's phase spans tiling its outer_iteration span.  Prints the
    fitted (exact_cost, plane_cost) beside profile's exact pass and
    approximate pass on the same card.  Returns the launch counts.
    The wall-mode defaults (1 s per exact pass, 1 ms per plane step) stop
    the slope rule after one pass at this size, so no continuation comes
    and the first segments' plane counts leave the fit unidentified: 2
    iterations from the defaults are run and reported first
    (``from_defaults``).  The checked run then starts from profile's
    measured exact pass and per-plane cost, as a resumed run starts from
    its checkpoint's calibration.  ~10 s."""
    t_phase = time.perf_counter()
    import dataclasses
    import tempfile
    from repro_torch.api import RunConfig, Solver
    from repro_torch.core.oracles import chain
    from repro_torch.kernels import ops
    X, Y, M = data
    n = OCR["n"]
    problem = chain.make_problem(X, Y, M, OCR["num_labels"], device="cuda")
    cfg = RunConfig(lam=1.0 / n, cost_model=None,
                    **dict(RUN, approx_batch=2, max_approx_passes=8))
    with tempfile.TemporaryDirectory() as tmp:
        rec = sync_checked_recorder(torch, Path(tmp) / "defaults.jsonl")
        solver = Solver(problem, dataclasses.replace(cfg, max_iters=2),
                        recorder=rec)
        rows = list(solver.iterate())
        rec.close()
        check(all(r.host_syncs == r.dispatches for r in rows),
              f"obs_wall: syncs and dispatches from the defaults {rows}")
        from_defaults = dict(
            approx_passes=[r.approx_passes for r in rows],
            dispatches=[r.dispatches for r in rows], fit=rec._phase_fit,
            constants=[solver._est_exact, solver._est_plane])
        del solver
        path = Path(tmp) / "obs_wall.jsonl"
        rec = sync_checked_recorder(torch, path)
        segs_seen, fits = [], []
        inner = rec.observe_phases

        def observe(segments):
            segs_seen.append([list(s) for s in segments])
            return inner(segments)
        rec.observe_phases = observe
        solver = Solver(problem, cfg, recorder=rec)
        seed = (profile_timing["exact_ms_per_block"] * n * 1e-3,
                profile_timing["ms"] * 1e-3 / profile_timing["valid_planes"])
        solver._est_exact, solver._est_plane = seed

        def after(row):
            segs = segs_seen[-1]
            check(row.host_syncs == row.dispatches == len(segs),
                  f"obs_wall: {row.host_syncs} syncs, {row.dispatches} "
                  f"dispatches, {len(segs)} segments at iteration "
                  f"{row.iteration}")
            fit = rec._phase_fit
            if fit is not None:
                check((solver._est_exact, solver._est_plane) == fit,
                      f"obs_wall: the solver's constants "
                      f"{(solver._est_exact, solver._est_plane)} are not "
                      f"the recorder's fit {fit}")
            fits.append(fit)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rows, walls = drive(torch, solver, "obs_wall", after=after)
        launches = ops.launch_counts()
        rec.close()
        check(rec.calls == 2 + len(rows) + len(segs_seen),
              f"obs_wall: {rec.calls} recorder callbacks")
        run, s, info = check_trace_file("obs_wall", path, len(rows))
        measured = [sp for sp in run["spans"]
                    if sp["name"] == "approx_passes" and sp.get("measured")]
        continuations = sum(len(sg) - 1 for sg in segs_seen)
        check(len(measured) == continuations,
              f"obs_wall: {len(measured)} measured approx spans for "
              f"{continuations} continuations")
        check(continuations > 0, "obs_wall: no overflow continuation ran")
        tail = check_phase_tiling("obs_wall", run)
    exact_s = profile_timing["exact_ms_per_block"] * n * 1e-3
    emit("obs_wall", scenario="OCR", iterations=len(rows),
         seconds=time.perf_counter() - t_phase,
         launches=launches, segments=segs_seen, fits=fits,
         from_defaults=from_defaults, seeded_constants=seed,
         recorder_host_ms_by_callback={k: 1e3 * v for k, v in
                                       rec.host_by.items()},
         continuations=continuations,
         dispatches=[r.dispatches for r in rows],
         approx_passes=[r.approx_passes for r in rows],
         fitted_exact_cost_s=fits[-1][0] if fits[-1] else None,
         fitted_plane_cost_s=fits[-1][1] if fits[-1] else None,
         profile_exact_pass_s=exact_s,
         profile_approx_pass_ms=profile_timing["ms"],
         profile_valid_planes=profile_timing["valid_planes"],
         profile_plane_cost_s=(profile_timing["ms"] * 1e-3
                               / profile_timing["valid_planes"]),
         recorder_host_ms_per_iteration=1e3 * rec.host_s / len(rows),
         wall_s_per_iteration=walls, untiled_tail_s=tail,
         phase_time=s["phase_time"], **info)
    return launches


def phase_obs_checkpoint(torch):
    """SMALL ocr on the card: a recorded mpbcfw run saves after 2
    iterations and a recorded restore resumes it.  checkpoint_save and
    checkpoint_restore spans written, the manifest's metrics the registry
    snapshot, the restored solver's snapshot equal; then 2 iterations
    under RunRecorder(profile=True) inside torch.profiler, one
    outer_iteration range per iteration.  ~3 s."""
    t_phase = time.perf_counter()
    import shutil
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import Solver
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.obs import load_run
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        mgr = CheckpointManager(str(Path(tmp) / "ckpt"))
        rec = sync_checked_recorder(torch, Path(tmp) / "save.jsonl")
        prob, s1 = small_run("ocr", "cuda", "mpbcfw", max_iters=4)
        s1 = Solver(prob, s1.cfg, recorder=rec)
        it = s1.iterate()
        [next(it) for _ in range(2)]
        step = s1.save(mgr)
        rec.close()
        manifest = mgr.load_manifest(step)
        snap = s1.metrics.snapshot()
        check(manifest["metrics"] == snap and
              snap["iterations"]["value"] == 2,
              f"obs_checkpoint: manifest metrics {manifest['metrics']} vs "
              f"the registry's {snap}")
        rec2 = sync_checked_recorder(torch, Path(tmp) / "restore.jsonl")
        s2 = Solver.restore(prob, s1.cfg, mgr, recorder=rec2)
        check(s2.metrics.snapshot() == snap,
              "obs_checkpoint: the restored snapshot differs")
        rest = list(s2.iterate())
        rec2.close()
        saved = [sp["name"] for sp in load_run(Path(tmp) / "save.jsonl")[
            "spans"]]
        resumed = load_run(Path(tmp) / "restore.jsonl")
        check(saved.count("checkpoint_save") == 1 and [
            sp["name"] for sp in resumed["spans"]].count(
                "checkpoint_restore") == 1 and len(rest) == 2,
            f"obs_checkpoint: spans {saved}, {resumed['spans'][:2]}, "
            f"{len(rest)} resumed rows")
        check(resumed["summary"]["iterations"]["value"] == 4,
              f"obs_checkpoint: resumed series {resumed['summary']}")
        rec3 = sync_checked_recorder(torch, Path(tmp) / "prof.jsonl",
                                     profile=True)
        _, s3 = small_run("ocr", "cuda", "mpbcfw", max_iters=2)
        s3 = Solver(s3.problem, s3.cfg, recorder=rec3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s3.run()
            torch.cuda.synchronize()
        rec3.close()
        # The host ranges; with CUDA activity the profiler also mirrors
        # them onto the device timeline as user annotations (3 for 2
        # ranges on an H100), which are not what is counted here.
        ranges = [e for e in prof.events() if e.name == "outer_iteration"]
        marks = [e for e in ranges
                 if e.device_type == torch.autograd.DeviceType.CPU]
        check(len(marks) == 2, f"obs_checkpoint: {len(marks)} host "
              "outer_iteration ranges for 2 iterations")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("obs_checkpoint", scenario="SMALL[ocr]", step=step,
         seconds=time.perf_counter() - t_phase,
         metrics_in_manifest=True, restored_snapshot_equal=True,
         profile_ranges=len(marks),
         profile_device_annotations=len(ranges) - len(marks),
         profile_range_ms=[e.cpu_time_total * 1e-3 for e in marks])


def phase_serve_obs(torch, model, data, served):
    """``serve`` again with a RunRecorder: main's trained model on the
    same 6877 requests, labels equal to the unrecorded serve's, one
    serve_round span per round (= ledger rounds = B3 launches), one
    serve_request event per request, the file schema-valid, every
    recorder callback under sync-debug "error".  Then ms per round without
    and with a (plain) recorder on one warmed engine, alternated plain,
    recorded, recorded, plain, plain, recorded.  Returns the recorded
    run's launch counts.  ~10 s."""
    t_phase = time.perf_counter()
    import tempfile
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.obs import RunRecorder, load_run, validate_file
    from repro_torch.serve import StructuredServer
    reqs = chain_requests(*data)
    warm = StructuredServer(model, batch_size=SERVE_BATCH,
                            bucket_granularity=SERVE_GRANULARITY)
    warm.serve(reqs)
    engine = warm.engine

    def run(recorder):
        server = StructuredServer(model, batch_size=SERVE_BATCH,
                                  bucket_granularity=SERVE_GRANULARITY,
                                  engine=engine, recorder=recorder)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = server.serve(reqs)
        torch.cuda.synchronize()
        return labels, time.perf_counter() - t0, server.ledger.counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "serve.jsonl"
        rec = sync_checked_recorder(torch, path)
        ops.reset_launch_counts()
        labels, _, (rounds, dispatches, syncs) = run(rec)
        launches = ops.launch_counts()
        rec.close()
        check(all(np.array_equal(a, b) for a, b in zip(labels, served))
              and len(labels) == len(served),
              "serve_obs: labels differ from the unrecorded serve's")
        count, errs = validate_file(path)
        check(not errs, f"serve_obs: schema errors {errs[:5]}")
        tr = load_run(path)
        spans = [s for s in tr["spans"] if s["name"] == "serve_round"]
        events = [e for e in tr["events"] if e["name"] == "serve_request"]
        check(len(spans) == rounds == dispatches == syncs
              == launches["viterbi_decode"],
              f"serve_obs: {len(spans)} serve_round spans, {rounds} "
              f"rounds, {launches['viterbi_decode']} B3 launches")
        check(len(events) == len(reqs), f"serve_obs: {len(events)} "
              f"serve_request events for {len(reqs)} requests")
        want = {k: 0 for k in launches}
        want["viterbi_decode"] = rounds
        check(launches == want, f"serve_obs: launches {launches}")
        check(rec.calls == 2 + len(spans) + len(events),
              f"serve_obs: {rec.calls} recorder callbacks")
        host_ms = 1e3 * rec.host_s / rounds
        # The timed runs record through a plain RunRecorder: the checked
        # one's mode switches (two per callback, 1 + 8 callbacks a round)
        # would be timed with it.
        walls = {"plain": [], "recorded": []}
        for i, kind in enumerate(("plain", "recorded", "recorded", "plain",
                                  "plain", "recorded")):
            r = (RunRecorder(Path(tmp) / f"timed{i}.jsonl")
                 if kind == "recorded" else None)
            walls[kind].append(run(r)[1])
            if r is not None:
                r.close()
    emit("serve_obs", scenario="OCR", requests=len(reqs), rounds=rounds,
         seconds=time.perf_counter() - t_phase,
         launches=launches, records=count, labels_equal_to_serve=True,
         recorder_host_ms_per_round=host_ms,
         ms_per_round={k: [1e3 * w / rounds for w in v]
                       for k, v in walls.items()},
         recorder_share_of_round=(
             (sum(walls["recorded"]) - sum(walls["plain"]))
             / sum(walls["plain"])))
    return launches


def phase_parity_lm(torch):
    """Reduced OLMoE in float32 on the card vs the port on the CPU, from
    the same weights and tokens: backbone features and one decode step's
    logits within 1e-4 (1+|ref|), and a 3-iteration SSVM-head Solver run
    with the same schedule and duals within rtol 1e-4."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.kernels import ops
    from repro_torch.models import common, registry
    from repro_torch.trainer.ssvm_head import (backbone_chain_problem,
                                               tagging_task)
    cfg = dataclasses.replace(configs.reduced_config(LM_ARCH),
                              dtype=torch.float32)
    gen = torch.Generator("cpu")
    gen.manual_seed(0)
    params = {"cpu": common.init_params(registry.param_specs(cfg), gen,
                                        "cpu")}
    params["cuda"] = common.tree_map(lambda t: t.cuda(), params["cpu"])
    n, L, tags = 48, 12, HEAD["tags"]
    tok, gold, mask = tagging_task(cfg.vocab_size, n, L, tags)
    feats, logits, traces = {}, {}, {}
    ops.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        prob = backbone_chain_problem(cfg, params[dev], tok, gold, mask,
                                      tags, device=dev)
        feats[dev] = prob.data["x"].cpu()
        cache = registry.init_cache(cfg, 4, 16, dev)
        lg, _ = registry.decode_step(params[dev], cfg, cache,
                                     torch.from_numpy(tok[:4, :1]).to(dev), 0)
        logits[dev] = lg.cpu()
        traces[dev] = Solver(prob, RunConfig(
            lam=1.0 / n, cost_model=CostModel(oracle_cost=HEAD_ORACLE_COST),
            **HEAD_RUN)).run().trace
    launches = ops.launch_counts()
    for what, got, want in (("features", feats["cuda"], feats["cpu"]),
                            ("decode logits", logits["cuda"],
                             logits["cpu"])):
        err = (got - want).abs()
        check(bool((err <= 1e-4 * (1 + want.abs())).all()),
              f"parity_lm: {what} max err {float(err.max())}")
    rows = compare_traces("parity_lm", traces)
    check(launches["moe_ffn"] > 0 and launches["flash_attention"] > 0,
          f"parity_lm: LM kernels not launched ({launches})")
    emit("parity_lm", arch=cfg.name, reduced=True, dtype="float32", n=n, L=L,
         features_max_abs_err=float((feats["cuda"] - feats["cpu"])
                                    .abs().max()),
         logits_max_abs_err=float((logits["cuda"] - logits["cpu"])
                                  .abs().max()),
         rows=rows, launches=launches)


def phase_main_lm(torch):
    """OLMoE-1B-7B at its published width on the card: the Server answers
    8 requests, then the SSVM head trains on the backbone's features."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.api import CostModel, RunConfig, Solver
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import common, registry
    from repro_torch.trainer.ssvm_head import (backbone_chain_problem,
                                               tagging_task)
    cfg = configs.get_config(LM_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = common.init_params(registry.param_specs(cfg), gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in common.leaves(params))
    check(n_params == cfg.param_count(), f"{n_params} parameters")
    param_bytes = sum(t.numel() * t.element_size()
                      for t in common.leaves(params))

    # 1. Serve.
    server = Server(cfg, params, slots=SERVE["slots"],
                    max_seq=SERVE["max_seq"])
    rng = np.random.RandomState(0)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size,
                                   size=SERVE["prompt_len"]),
                    SERVE["max_new"]) for i in range(SERVE["requests"])]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = server.serve(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = ops.launch_counts()
    tokens_out = sum(len(r.out) for r in done)
    check(len(done) == SERVE["requests"], f"served {len(done)} requests")
    check(all(len(r.out) == SERVE["max_new"] and
              all(0 <= t < cfg.vocab_size for t in r.out) for r in done),
          "generated tokens out of range or missing")
    check(serve_launches["moe_ffn"] == cfg.num_layers * server.rounds,
          f"moe_ffn launches {serve_launches['moe_ffn']} in "
          f"{server.rounds} rounds")
    logits, _ = registry.decode_step(
        params, cfg, server.cache,
        torch.from_numpy(server.tokens).cuda(), server.pos)
    check(logits.shape == (SERVE["slots"], 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "decode logits not finite")
    rounds = server.rounds
    del server, logits
    torch.cuda.empty_cache()

    # 2. The SSVM head on backbone features.
    n, L, tags = HEAD["n"], HEAD["L"], HEAD["tags"]
    tok, gold, mask = tagging_task(cfg.vocab_size, n, L, tags)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    problem = backbone_chain_problem(cfg, params, tok, gold, mask, tags)
    torch.cuda.synchronize()
    feature_s = time.perf_counter() - t0
    feature_launches = ops.launch_counts()
    x = problem.data["x"]
    check(tuple(x.shape) == (n, L, cfg.d_model) and x.dtype == torch.float32
          and bool(torch.isfinite(x).all()), "features not finite")
    check(problem.d == tags * cfg.d_model + tags * tags, f"d {problem.d}")
    check(feature_launches["moe_ffn"] == cfg.num_layers and
          feature_launches["flash_attention"] == cfg.num_layers,
          f"feature pass launches {feature_launches}")
    solver = Solver(problem, RunConfig(
        lam=1.0 / n, cost_model=CostModel(oracle_cost=HEAD_ORACLE_COST),
        **HEAD_RUN))
    torch.cuda.synchronize()
    rows, walls = drive(torch, solver, "main_lm")
    head_launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(rows[-1].n_exact == n * len(rows), f"n_exact {rows[-1].n_exact}")
    check_syncs("main_lm", rows, dispatches=1)
    check(head_launches["approx_pass"] == HEAD_RUN["approx_batch"] * len(rows)
          and head_launches["viterbi_decode"] >= rows[-1].n_exact,
          f"head launches {head_launches}")
    head_replays = check_replays("main_lm", solver, rows[-1].n_exact,
                                 captured=1)
    emit("main_lm", arch=cfg.name, params=n_params, param_bytes=param_bytes,
         init_s=init_s, serve=dict(
             slots=SERVE["slots"], max_seq=SERVE["max_seq"],
             requests=len(done), rounds=rounds,
             tokens=tokens_out, seconds=serve_s,
             tokens_per_s=tokens_out / serve_s, launches=serve_launches),
         head=dict(n=n, L=L, tags=tags, d=problem.d, feature_s=feature_s,
                   feature_launches=feature_launches,
                   iterations=len(rows), wall_s_per_iteration=walls,
                   n_exact=rows[-1].n_exact, n_approx=rows[-1].n_approx,
                   graph_replays=head_replays, launches=head_launches),
         max_memory_allocated=peak)

    head = solver.servable()
    reqs = chain_requests(*(problem.data[k].cpu().numpy()
                            for k in ("x", "y", "mask")))
    del solver, problem, x
    routing = compare_routing(torch, cfg, params, tok)
    emit("routing", arch=cfg.name, **routing)
    profile_lm(torch, cfg, params, tok)
    # 3. Serve the trained head: B3 at (8, 32, tags) once per round.
    serve_head = serve_and_check(
        torch, "serve_lm", head, reqs, range(n), chain=True,
        scenario=f"SSVM head on {cfg.name} features", d=head.d)
    both = {k: serve_launches[k] + head_launches[k] for k in serve_launches}
    return both, {"main_lm_serve": serve_launches,
                  "main_lm_head": head_launches, "serve_lm": serve_head}


@contextlib.contextmanager
def background_paused():
    """The live ``BACKGROUND`` processes stopped (SIGSTOP) for the span of
    the block and continued (SIGCONT) after it.  The profiler drops kernel
    records of replayed graphs when the host is busy: with xlstm-125m's
    dry-run trace running beside it, four traces in a row of a 1024-block
    exact window showed 1021 ``viterbi`` kernels, with one graph replay
    per block."""
    live = [p for p in BACKGROUND["procs"] if p.poll() is None]
    if not live:
        yield
        return
    for p in live:
        p.send_signal(signal.SIGSTOP)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        BACKGROUND["paused_s"] += time.perf_counter() - t0
        for p in live:
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)


def traced(torch, fn, kernels=()):
    """Wall ms of ``fn()`` under torch.profiler, device busy share (device
    time of all kernels and copies / wall time), the device span (first
    start to last end) and device us by kernel; for each name in
    ``kernels``, the device us and calls of the kernels whose names hold
    it (``kernel_us``).  The background host processes are stopped while
    the profiler runs (:func:`background_paused`)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with background_paused(), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = {}
    for e in dev:
        by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                             + e.time_range.elapsed_us())
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    span_us = (max(e.time_range.end for e in dev)
               - min(e.time_range.start for e in dev)) if dev else 0.0
    named = {}
    for k in kernels:
        hits = [e.time_range.elapsed_us() for e in dev if k in e.name]
        named[k] = dict(us=sum(hits), calls=len(hits))
    return dict(wall_ms=1e3 * wall, device_events=len(dev),
                kernel_us=named,
                device_us=busy_us, device_span_us=span_us,
                device_busy_share=(busy_us * 1e-6 / wall) if dev else None,
                top_device_us=[[k[:60], v] for k, v in top])


def compare_routing(torch, cfg, params, tok, layers=(0, -1)):
    """MoE routing at full width, the card against the CPU (ROADMAP C5): a
    backbone pass over the head's 1024 x 32 tokens records the router
    inputs of the first and last MoE layers on the card; the CPU then
    routes the same inputs with the same router weights.  Counts, per
    layer, the (expert, token) slots kept on one side and not the other,
    the tokens whose top-k expert set differs, and the largest router
    logit difference.  ~5 s."""
    from repro_torch.models import moe, registry
    seen = []
    route = moe.route

    def record(p, xf, c):
        seen.append((p["router"], xf))
        return route(p, xf, c)
    model = registry.module_for(cfg)
    tokens = torch.from_numpy(tok).long().cuda()
    moe.route = record
    try:
        with torch.no_grad():
            x, pos = model._embed_inputs(params, cfg, {"tokens": tokens})
            model.backbone(params, cfg, x, pos)
    finally:
        moe.route = route
    out = {"layers": len(seen)}
    for li in layers:
        router, xf = seen[li]
        ev_g, ei_g = route({"router": router}, xf, cfg)
        ev_c, ei_c = route({"router": router.cpu()}, xf.cpu(), cfg)
        T, E = xf.shape[0], cfg.num_experts

        def kept(ev, ei):
            m = torch.zeros((E, T), dtype=torch.bool)
            rows = torch.arange(E)[:, None].expand_as(ei)
            m[rows[ev > 0], ei[ev > 0]] = True
            return m
        kg, kc = kept(ev_g.cpu(), ei_g.cpu()), kept(ev_c, ei_c)
        lg = torch.matmul(xf.float(), router).cpu()
        lc = torch.matmul(xf.cpu().float(), router.cpu())
        k = cfg.experts_per_token
        tg, tc = moe.top_k(lg, k)[1].sort(dim=-1)[0], \
            moe.top_k(lc, k)[1].sort(dim=-1)[0]
        out[f"layer_{li % len(seen)}"] = dict(
            tokens=T, kept_slots=int(kc.sum()),
            kept_differ=int((kg ^ kc).sum()),
            topk_sets_differ=int((tg != tc).any(dim=-1).sum()),
            router_logit_max_abs_diff=float((lg - lc).abs().max()))
    del seen
    return out


def profile_lm(torch, cfg, params, tok):
    """Where the LM cells' time goes, on the full-size model: 8 decode
    rounds of a fresh 4-slot Server, and one backbone feature pass over
    the head's 1024 x 32 tokens, each under torch.profiler."""
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import registry
    server = Server(cfg, params, slots=SERVE["slots"],
                    max_seq=SERVE["max_seq"])
    for i in range(SERVE["slots"]):
        server.add(Request(i, tok[i, :SERVE["prompt_len"]], 64))
    server.decode_round()                     # warm
    decode = traced(torch, lambda: [server.decode_round()
                                    for _ in range(8)])
    decode["rounds"] = 8
    del server
    model = registry.module_for(cfg)
    tokens = torch.from_numpy(tok).long().cuda()

    def features():
        x, pos = model._embed_inputs(params, cfg, {"tokens": tokens})
        model.backbone(params, cfg, x, pos)
    emit("profile_lm", arch=cfg.name, decode_round=decode,
         feature_pass=traced(torch, features))


def quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with its standard output captured: ``(result,
    the captured lines)``, so the smoke's own lines stay readable."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def lm_batch(torch, cfg, batch_size: int, seq_len: int, step: int = 0):
    """The trainer's batch ``step`` (repro_torch.data.lm) on the card."""
    from repro_torch.data.lm import DataConfig, TokenDataset
    data = TokenDataset(DataConfig(vocab_size=cfg.vocab_size,
                                   batch_size=batch_size, seq_len=seq_len))
    return {k: v.cuda() for k, v in data.batch(step).items()}


def phase_train_lm(torch):
    """LM training through the entry point a user calls:
    ``train_lm("qwen2-0.5b", steps=30, batch_size=8, seq_len=128,
    reduced=False)`` at the published width and depth, bf16 weights from
    seed 0, launch counts reset just before and read just after.  Checks:
    a finite loss every step, the last below the first, B5 launched once
    per layer per step (its backward recomputes in torch) and B6 never.
    Then a fresh state's steady steps: ms per step by the host clock to a
    sync, tokens/s, and under torch.profiler the device busy share and the
    device time by kernel, beside the step's FLOP bound 6 N tokens over
    the bf16 peak; and each of remat_policy "none" and the default
    "nothing" on a fresh state: ms per step and peak memory [~25]."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig, cosine_schedule
    cfg = configs.get_config(TRAIN["arch"])
    steps, B, S = TRAIN["steps"], TRAIN["batch_size"], TRAIN["seq_len"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, lines = quiet(train.train_lm, TRAIN["arch"], steps, B, S,
                       reduced=False, log_every=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = out["step_losses"]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"train_lm: losses {losses}")
    check(losses[-1] < losses[0], f"train_lm: loss {losses[0]} -> "
          f"{losses[-1]}")
    # remat_policy "nothing": the backward runs each layer's forward again,
    # B5 included: 2 launches per layer and step.
    check(launches["flash_attention"]
          == remat_launches(cfg, cfg.num_layers) * steps
          and launches["moe_ffn"] == 0, f"train_lm: launches {launches}")
    grad_norms = out["grad_norms"]
    del out
    torch.cuda.empty_cache()

    # Steady state: a fresh state, one warm step, then timed and traced.
    ocfg = AdamWConfig(lr=3e-4)
    batch = lm_batch(torch, cfg, B, S)
    lr = cosine_schedule(25, peak_lr=ocfg.lr, warmup=20, total=steps)

    def steady(c):
        """ms per step (5 steps to a sync, after a warm one) and the peak
        of a fresh state's steps under ``c``'s remat policy."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st = {"s": train.init_state(c, ocfg, torch.device("cuda"))}
        base = torch.cuda.memory_allocated()

        def one():
            st["s"], loss, _ = train.train_step(st["s"], c, batch, ocfg, lr)
            return loss
        one()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            one()
        torch.cuda.synchronize()
        out = dict(remat_policy=c.remat_policy,
                   ms_per_step=(time.perf_counter() - t0) * 1e3 / 5,
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   peak_over_state_bytes=torch.cuda.max_memory_allocated()
                   - base)
        del st
        return out
    remat = {"none": steady(dataclasses.replace(cfg, remat_policy="none"))}
    remat[cfg.remat_policy] = steady(cfg)
    torch.cuda.empty_cache()
    state = {"s": train.init_state(cfg, ocfg, torch.device("cuda"))}

    def step():
        state["s"], loss, _ = train.train_step(state["s"], cfg, batch, ocfg,
                                               lr)
        return loss
    step()
    torch.cuda.synchronize()
    # One step under sync-debug "error": no hidden host sync in a step.
    from repro_torch.analysis import raise_site, sync_debug
    try:
        with sync_debug(torch.device("cuda")):
            step()
    except RuntimeError as err:
        emit("sync_debug_raised", path="train_lm", where=raise_site(err),
             error=str(err).splitlines()[0])
        raise
    SYNC_CHECKED["train_lm"] = 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    prof = traced(torch, lambda: [step() for _ in range(TRAIN_PROFILED_STEPS)],
                  kernels=("flash_attention",))
    del state
    torch.cuda.empty_cache()
    n_params = cfg.param_count()
    tokens = B * S
    bms = 6.0 * n_params * tokens / BF16_FLOPS * 1e3
    emit("train_lm", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, params=n_params,
         steps=steps, batch_size=B, seq_len=S, seconds=wall,
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         grad_norms=grad_norms, launches=launches,
         max_memory_allocated=peak, ms_per_step=ms,
         remat_policy=cfg.remat_policy, remat_vs_none=remat,
         tokens_per_s=tokens / (ms * 1e-3), bound_ms=bms,
         bound_by="operations (6 N tokens / bf16 peak)",
         profiled_steps=TRAIN_PROFILED_STEPS, profile=prof,
         log=lines[-3:])
    return launches


def raw_grads(torch, params, cfg, batch):
    """``(loss, grads)`` by autograd over the parameter leaves, None kept
    for a leaf the loss does not reach (the trainer zero-fills those)."""
    from repro_torch.models import common, registry
    from repro_torch.optim.adamw import tree_zip
    live = tree_zip(lambda p: p.detach().requires_grad_(), params)
    loss = registry.loss_fn(live, cfg, batch)
    return loss.detach(), list(torch.autograd.grad(
        loss, common.leaves(live), allow_unused=True))


def grad_table(torch, got, want):
    """Per-leaf relative L2 of two gradient lists (None for a leaf whose
    ``want`` is all zero), after checking that neither has a leaf without
    a gradient or all zero where the other's is not."""
    rels = []
    for i, (g, w) in enumerate(zip(got, want)):
        check(g is not None and w is not None, f"leaf {i} has no gradient")
        gz, wz = not bool(g.any()), not bool(w.any())
        check(gz == wz, f"leaf {i} all zero on one side only")
        rels.append(None if wz else rel_l2(torch, g, w.to(g.device)))
    return rels


def leaf_names(tree, prefix=""):
    """The parameter tree's leaf paths, in :func:`common.leaves`'s order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}" if prefix
                                    else k)]
    return [prefix]


def phase_lm_grad(torch):
    """Gradients through the kernels.  One step of qwen2-0.5b at full
    width, bf16: every parameter's gradient with the flash kernel in the
    forward (its backward recomputed in torch) and with the all-chunked
    forward on the card, each against the chunked forward in fp32 (the
    same weights widened).  No gradient None or all zero where another's
    is not; per leaf, the kernel path no farther from the fp32 gradient
    than 1.25x the chunked path's distance + 1e-3 (both bf16 paths sit
    1-2.5 % from it: the bf16 rounding of 24 layers, so the two paths'
    distance from each other is no tighter).  Then reduced qwen2-0.5b,
    OLMoE-1B-7B (B6's backward too), deepseek-v3-671b (MLA through B5's
    fp32 path at q/k 24, v 16, MTP in the loss, B6) and internvl2-76b
    (the vision stub) in fp32, card against CPU: the loss and each leaf's
    gradient within relative L2 1e-3; then reduced zamba2-7b (B5's fp32
    causal and window builds), xlstm-125m (no kernel) and whisper-base
    (the fp32 bidirectional and causal builds) within 1e-5; reduced
    qwen2-0.5b, deepseek-v3-671b and zamba2-7b (its window) at
    attn_score_dtype "bf16" (the bf16-score builds) within 2e-2; reduced
    qwen2-0.5b under each remat policy within 1e-5, and within 1e-6 of
    the card's "none".  B5's and B6's launches count each remat'd
    layer twice (its forward runs again in the backward) [~12]."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import common, registry
    t_phase = time.perf_counter()
    cfg = configs.get_config(TRAIN["arch"])
    gen = torch.Generator("cuda")
    gen.manual_seed(0)
    params = common.init_params(registry.param_specs(cfg), gen, "cuda")
    names = leaf_names(params)
    batch = lm_batch(torch, cfg, TRAIN["batch_size"], TRAIN["seq_len"])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    loss_k, g_k = raw_grads(torch, params, cfg, batch)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(launches["flash_attention"] == remat_launches(cfg, cfg.num_layers),
          f"lm_grad: launches {launches}")
    kernel = ops.flash_attention
    ops.flash_attention = ops.attention_math    # the chunked forward
    try:
        loss_c, g_c = raw_grads(torch, params, cfg, batch)
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        p32 = common.tree_map(lambda t: t.float(), params)
        del params
        loss_32, g_32 = raw_grads(torch, p32, cfg32, batch)
        del p32
    finally:
        ops.flash_attention = kernel
    check(ops.launch_counts() == launches, "lm_grad: the chunked forward "
          "launched a kernel")
    k_c = grad_table(torch, g_k, g_c)
    k_32 = grad_table(torch, g_k, g_32)
    c_32 = grad_table(torch, g_c, g_32)
    for n, k, c in zip(names, k_32, c_32):
        check(k <= GRAD_NOISE_RATIO * c + GRAD_NOISE_ATOL,
              f"lm_grad: {n}'s gradient {k} from fp32 through the kernel, "
              f"{c} through the chunked forward")
    full = dict(arch=cfg.name, loss_kernel=float(loss_k),
                loss_chunked=float(loss_c), loss_fp32=float(loss_32),
                leaves=len(g_k), launches=launches,
                max_rel_l2_kernel_vs_chunked=max(k_c),
                max_ratio_to_chunked=max(k / c for k, c in zip(k_32, c_32)),
                rel_l2_kernel_vs_chunked_vs_fp32={
                    n: [a, b, c] for n, a, b, c in zip(names, k_c, k_32,
                                                       c_32)})
    del g_k, g_c, g_32
    torch.cuda.empty_cache()

    def card_vs_cpu(arch, rcfg, tol):
        """One loss_fn and its gradients of ``rcfg`` (fp32 weights from a
        CPU seed) on the card and on the CPU: loss and every leaf within
        relative ``tol``, B5's launches those of the config (doubled in
        the backward under remat)."""
        gen = torch.Generator("cpu")
        gen.manual_seed(0)
        p_cpu = common.init_params(registry.param_specs(rcfg), gen, "cpu")
        p_gpu = common.tree_map(lambda t: t.cuda(), p_cpu)
        b_gpu = lm_batch(torch, rcfg, 4, 32)
        extra = registry.make_train_batch(rcfg, 4, 32, 0)
        for name in ("vision_embeds", "frames"):   # vlm, audio inputs
            if name in extra:
                b_gpu[name] = extra[name].cuda()
        b_cpu = {k: v.cpu() for k, v in b_gpu.items()}
        ops.reset_launch_counts()
        lg, gg = raw_grads(torch, p_gpu, rcfg, b_gpu)
        torch.cuda.synchronize()
        red_launches = ops.launch_counts()
        red_builds = ops.flash_attention_builds()
        lc, gc = raw_grads(torch, p_cpu, rcfg, b_cpu)
        check(abs(float(lg) - float(lc)) <= tol * abs(float(lc)),
              f"lm_grad {arch}: loss {float(lg)} vs {float(lc)}")
        flash = {"hybrid": rcfg.num_layers // max(rcfg.attn_every, 1),
                 "ssm": 0,
                 "audio": rcfg.num_layers + rcfg.encoder_layers}.get(
                     rcfg.family, rcfg.num_layers + int(rcfg.mtp))
        outside = {"audio": rcfg.encoder_layers}.get(rcfg.family,
                                                     int(rcfg.mtp))
        want = {"flash_attention": remat_launches(rcfg, flash, outside),
                "moe_ffn": remat_launches(rcfg, (
                    rcfg.num_layers - rcfg.first_dense_layers
                    if rcfg.moe else 0))}
        check(all(red_launches[k] == v for k, v in want.items()),
              f"lm_grad {arch}: launches {red_launches}")
        if rcfg.attn_score_dtype == "bf16":
            check(all(b.endswith("-s16") for b in red_builds),
                  f"lm_grad {arch}: builds {red_builds}")
        rels = grad_table(torch, [g.cpu() for g in gg], gc)
        worst = max(r for r in rels if r is not None)
        check(worst <= tol, f"lm_grad {arch}: leaf relative L2 {worst} > "
              f"{tol}")
        return dict(loss_cuda=float(lg), loss_cpu=float(lc),
                    leaves=len(rels), max_leaf_rel_l2=worst, tolerance=tol,
                    remat_policy=rcfg.remat_policy,
                    score_dtype=rcfg.attn_score_dtype,
                    launches=red_launches,
                    flash_attention_builds=red_builds), gg

    reduced = {}
    for arch, over, tol in ([(a, {}, GRAD_RTOL) for a in GRAD_ARCHS]
                            + [(a, o, GRAD_NEW_RTOL) for a, o in GRAD_NEW]):
        rcfg = dataclasses.replace(configs.reduced_config(arch),
                                   dtype=torch.float32, **over)
        key = arch + "".join(f" {k}={v}" for k, v in over.items())
        reduced[key], _ = card_vs_cpu(arch, rcfg, tol)
    # bf16 scores: the card's bf16-score builds and the backward through
    # the bf16 score slab, against the CPU's bf16 score slab.
    score_bf16 = {}
    for arch, over in GRAD_S16:
        rcfg = dataclasses.replace(configs.reduced_config(arch),
                                   dtype=torch.float32,
                                   attn_score_dtype="bf16", **over)
        key = arch + "".join(f" {k}={v}" for k, v in over.items())
        score_bf16[key], _ = card_vs_cpu(arch, rcfg, GRAD_S16_RTOL)
    # Each remat policy: card against CPU, and against the card's "none".
    remat, plain = {}, None
    for pol in ("none",) + tuple(p for p in REMAT_POLICIES if p != "none"):
        rcfg = dataclasses.replace(configs.reduced_config(TRAIN["arch"]),
                                   dtype=torch.float32, remat_policy=pol)
        remat[pol], grads = card_vs_cpu(TRAIN["arch"], rcfg, GRAD_NEW_RTOL)
        if plain is None:
            plain = grads
        remat[pol]["max_leaf_rel_l2_vs_card_none"] = max(
            rel_l2(torch, g, w) for g, w in zip(grads, plain)
            if bool(w.any()))
    worst = max(r["max_leaf_rel_l2_vs_card_none"] for r in remat.values())
    check(worst <= 1e-6, f"lm_grad: a remat policy's gradients {worst} "
          "from the card's without remat")
    emit("lm_grad", seconds=time.perf_counter() - t_phase,
         full_width_bf16=full, reduced_fp32=reduced,
         reduced_score_bf16=score_bf16, reduced_remat=remat,
         tolerance="full width bf16, per leaf: relative L2 from the fp32 "
         "gradient through the kernel <= 1.25 x the chunked forward's + "
         "1e-3; reduced fp32, card vs CPU: loss and per-leaf relative L2 "
         "<= 1e-3 (zamba2-7b, xlstm-125m, whisper-base and the remat "
         "policies: <= 1e-5; each remat policy vs the card's 'none' <= "
         "1e-6); bf16 scores card vs CPU <= 2e-2")
    return launches


def phase_lm_resume(torch):
    """Restart: reduced qwen2-0.5b trains 10 steps with save_every=5; a
    fresh train_lm then resumes from the step-5 checkpoint alone and runs
    steps 5-9.  Its losses must equal the uninterrupted run's, bit for bit
    unless an op on the path is not deterministic (then within rtol 1e-3,
    and the phase says so) [~10]."""
    import shutil
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    t_phase = time.perf_counter()
    kw = dict(batch_size=RESUME["batch_size"], seq_len=RESUME["seq_len"],
              reduced=True, save_every=RESUME["save_every"], log_every=100)
    steps, at = RESUME["steps"], RESUME["save_every"]
    with tempfile.TemporaryDirectory() as d:
        ops.reset_launch_counts()
        whole, _ = quiet(train.train_lm, TRAIN["arch"], steps,
                         ckpt_dir=f"{d}/a", **kw)
        launches = ops.launch_counts()
        shutil.copytree(f"{d}/a/step_{at:010d}", f"{d}/b/step_{at:010d}")
        resumed, _ = quiet(train.train_lm, TRAIN["arch"], steps,
                           ckpt_dir=f"{d}/b", **kw)
    want, got = whole["step_losses"][at:], resumed["step_losses"]
    check(len(got) == steps - at, f"lm_resume: resumed {len(got)} steps")
    bit_equal = got == want
    if not bit_equal:
        check(all(abs(a - b) <= 1e-3 * abs(b) for a, b in zip(got, want)),
              f"lm_resume: {got} vs {want}")
    emit("lm_resume", arch=TRAIN["arch"], reduced=True, steps=steps,
         resumed_at=at, losses_whole=want, losses_resumed=got,
         bit_equal=bit_equal,
         tolerance=("bit for bit" if bit_equal else "rtol 1e-3: the "
                    "embedding's backward (index_put_ accumulate) and "
                    "cuBLAS may order their sums differently per run"),
         launches=launches, seconds=time.perf_counter() - t_phase)
    return launches


def phase_train_ssvm(torch):
    """The trainer's ssvm mode: ``train_ssvm`` on SMALL usps, ocr and
    horseseg, 3 iterations, on the card and on the CPU: the same schedule,
    duals and primals within rtol 1e-4; launches read per scenario
    [~10]."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    paths = {}
    for name in ("usps", "ocr", "horseseg"):
        traces = {}
        t0 = time.perf_counter()
        for dev in ("cuda", "cpu"):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            out, _ = quiet(train.train_ssvm, name, 3, device=dev)
            torch.cuda.synchronize()
            traces[dev] = out["trace"]
            if dev == "cuda":
                paths[f"train_ssvm_{name}"] = ops.launch_counts()
        emit("train_ssvm", scenario=f"SMALL[{name}]",
             rows=compare_traces(f"train_ssvm {name}", traces),
             launches=paths[f"train_ssvm_{name}"],
             seconds=time.perf_counter() - t0)
    return paths


def phase_examples(torch):
    """The five examples' ``main()`` on the card at their reference sizes
    (``lm_train`` at 30 steps), each with launch counts reset just before
    and read just after; each must return, and its figures hold [~60]."""
    import importlib
    from repro_torch import configs
    from repro_torch.kernels import ops
    paths = {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        argv = ["--steps", "30"] if name == "lm_train" else []
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out, lines = quiet(mod.main, argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
        paths[f"example_{name}"] = launches
        if name == "quickstart":
            check(out["served_equal"] and out["accuracy"] >= 0.9,
                  f"quickstart: {out}")
        elif name == "sequence_labeling":
            check(out["token_accuracy"] >= 0.9
                  and launches["viterbi_decode"] > 0, f"{name}: {out}")
        elif name == "lm_train":
            check(out["final_loss"] < out["losses"][0][1]
                  and launches["flash_attention"] == remat_launches(
                      configs.reduced_config(TRAIN["arch"]), 4) * 30,
                  f"lm_train: {out['losses']}, {launches}")
        elif name == "ssvm_head":
            check(launches["flash_attention"] == 4 and math.isfinite(
                out["gap"]), f"ssvm_head: {launches}")
        else:
            check(math.isfinite(out["dual"]) and out["host_syncs"]
                  == out["dispatches"], f"{name}: {out}")
        emit("examples", example=name, seconds=seconds, launches=launches,
             lines=len(lines), tail=lines[-2:])
    return paths


def check_flash_mla(torch, gen):
    """B5's MLA build at deepseek-v3's prefill shape, (B, S, H) = (2, 1024,
    128), q/k head dim 192, v 128 read as a strided view of the per-head
    [k_nope ; v] expansion (the model's layout), bf16: against its plain
    version, and at one k block (S = 64) against its roundings emulated in
    fp32; timed by CUDA events beside its bound, the plain version and
    SDPA over the same q, k, v (Ev != E)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional

    def rand(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    def inputs(B, S, H, D, Dv):
        return rand(B, S, H, D), rand(B, S, H, D), \
            rand(B, S, H, 128 + Dv)[..., 128:]
    B, S, H, D, Dv = PREFILL["batch"], PREFILL["seq"], 128, 192, 128
    q, k, v = inputs(3, 64, 4, D, Dv)
    emu = close_bf16(torch, ops.flash_attention(q, k, v),
                     flash_emulated(torch, q, k, v), "flash mla S=64")
    q, k, v = inputs(B, S, H, D, Dv)
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    check(got.shape == (B, S, H, Dv) and got.dtype == q.dtype, "flash mla")
    rel = rel_l2(torch, got, want)
    check(rel <= BF16_REL_L2, f"flash mla: relative L2 {rel} vs plain")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    nbytes = 2 * B * S * H * (2 * D + 2 * Dv)   # q, k, v, o once
    ops_n = 2 * B * H * (D + Dv) * S * (S + 1) / 2
    bms, by = bound_ms(nbytes, ops_n, BF16_FLOPS)
    return dict(shape=[B, S, H, D, Dv], plan=kfa.plan(D, Dv, S, q.dtype),
                max_abs_err=float((got.float() - want.float()).abs().max()),
                rel_l2_vs_plain=rel, max_abs_err_emulated=emu,
                ms=time_ms(torch, lambda i: ops.flash_attention(q, k, v),
                           20),
                plain_ms=time_ms(torch, lambda i: ref.flash_attention_ref(
                    q, k, v), 3),
                library_ms=time_ms(torch, lambda i: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), 20),
                library="scaled_dot_product_attention(is_causal=True), "
                "Ev != E", bound_ms=bms, bound_by=by)


def check_moe_deepseek(torch, gen, moe_p, C: int, calls: int):
    """B6 at deepseek-v3's (E, D, F) = (256, 7168, 2048) on the model's own
    expert weights (22.5 GB), C capacity rows of random bf16 inputs:
    against moe_ffn_math (relative L2) and against the kernel's roundings
    emulated in fp32, 16 experts at a time; timed beside its bound, the
    plain version and three torch.bmm + silu."""
    from repro_torch.kernels import moe_ffn as kmoe
    from repro_torch.kernels import ops, ref
    F = torch.nn.functional
    wg, wu, wd = (moe_p[n][0] for n in ("w_gate", "w_up", "w_down"))
    E, D, Fd = wg.shape
    xs = torch.randn((E, C, D), generator=gen, device="cuda").bfloat16()
    got = ops.moe_ffn(xs, wg, wu, wd)
    rel = rel_l2(torch, got, ops.moe_ffn_math(xs, wg, wu, wd))
    check(rel <= BF16_REL_L2, f"moe_ffn deepseek C={C}: relative L2 {rel} "
          "vs moe_ffn_math")
    emulated = torch.empty_like(got)
    for e0 in range(0, E, 16):
        emulated[e0:e0 + 16] = moe_ffn_emulated(
            torch, *(t[e0:e0 + 16] for t in (xs, wg, wu, wd)))
    emu = close_bf16(torch, got, emulated, f"moe_ffn deepseek C={C}")
    del emulated

    def library(k):
        g, u = torch.bmm(xs, wg), torch.bmm(xs, wu)
        return torch.bmm(F.silu(g) * u, wd)
    nbytes = 2 * (2 * E * C * D + 3 * E * D * Fd)
    bms, by = bound_ms(nbytes, 6.0 * E * C * D * Fd, BF16_FLOPS)
    return dict(
        shape=[E, C, D, Fd], plan=list(kmoe.plan(C, D, Fd, xs.dtype)),
        max_abs_err=float((got.float() - ref.moe_ffn_ref(xs, wg, wu, wd)
                           .float()).abs().max()),
        rel_l2_vs_math=rel, max_abs_err_emulated=emu,
        ms=time_ms(torch, lambda k: ops.moe_ffn(xs, wg, wu, wd), calls,
                   warmup=1),
        plain_ms=time_ms(torch, lambda k: ref.moe_ffn_ref(xs, wg, wu, wd),
                         calls, warmup=1),
        library_ms=time_ms(torch, library, calls, warmup=1),
        bound_ms=bms, bound_by=by)


def phase_main_mla(torch):
    """deepseek-v3-671b at its published width (d_model 7168, 128 MLA heads
    of q/k 192 and v 128, kv rank 512, 256 experts top-8 of F 2048, the
    shared expert, the dense layers' F 18432, vocab 129,280, the MTP
    block), depth cut to 4 (its 3 dense layers and 1 MoE layer), bf16
    weights from seed 0 (15.8 B parameters, ~47 GB at the init's peak):
    the Server answers 8 requests (absorbed MLA decode against the
    compressed cache, B6 at C = 1 once per round, B5 never), then a
    prefill of 2 x 1024 tokens (B5's MLA build once per layer, each call
    held to the plain version on its own inputs; B6 at C = 64 once), its
    logits held to the same prefill through the plain attention; the same
    prefill at attn_score_dtype "bf16" (``lm_score_bf16``: the MLA build's
    bf16-score build once per layer); then B5's MLA build and B6 at (256,
    {1, 64}, 7168, 2048) against their plain versions, timed [~5]."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import registry
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.get_config(MLA_ARCH),
                              num_layers=MLA_LAYERS)
    moe_layers = cfg.num_layers - cfg.first_dense_layers
    params, init = lm_init(torch, cfg)

    def mla_cache(server):
        check([tuple(c.shape[2:]) for c in server.cache["moe_layers"]]
              == [(SERVE["max_seq"], cfg.kv_lora_rank),
                  (SERVE["max_seq"], cfg.qk_rope_dim)], "main_mla: MLA cache")
    serve, serve_launches, _ = lm_serve(torch, cfg, params, "main_mla",
                                        trace=False, check_server=mla_cache)
    check(serve_launches["moe_ffn"] == moe_layers * serve["rounds"]
          and serve_launches["flash_attention"] == 0,
          f"main_mla: serve launches {serve_launches} in {serve['rounds']} "
          "rounds")
    batch = {k: v.cuda() for k, v in registry.make_train_batch(
        cfg, PREFILL["batch"], PREFILL["seq"], 0).items()}
    prefill, prefill_launches, _ = lm_prefill(
        torch, cfg, params, batch, "main_mla", trace=False, hold_all=True,
        vs_plain_attention=True)
    check(prefill_launches["flash_attention"] == cfg.num_layers
          and prefill_launches["moe_ffn"] == moe_layers
          and len(prefill["b5_held_to_plain"]["causal"]) == cfg.num_layers,
          f"main_mla: prefill launches {prefill_launches}")
    s16_launches, s16_builds = score_bf16_prefill(torch, cfg, params, batch,
                                                  "main_mla")
    del batch

    # The kernels at the path's shapes.
    kgen = torch.Generator("cuda")
    kgen.manual_seed(1)
    flash = check_flash_mla(torch, kgen)
    flash["launches"] = prefill_launches["flash_attention"]
    moe_rows = {}
    for name, C, calls in (("decode", 1, 10), ("prefill", 64, 10)):
        moe_rows[name] = check_moe_deepseek(
            torch, kgen, params["moe_layers"]["moe"], C, calls)
    moe_rows["decode"]["launches"] = serve_launches["moe_ffn"]
    moe_rows["prefill"]["launches"] = prefill_launches["moe_ffn"]
    peak = torch.cuda.max_memory_allocated()
    emit("main_mla", arch=cfg.name, num_layers=cfg.num_layers,
         reduced=f"depth {configs.get_config(MLA_ARCH).num_layers} -> "
         f"{cfg.num_layers}", **init, serve=serve, prefill=prefill,
         flash_attention_mla=flash, moe_ffn=moe_rows,
         max_memory_allocated=peak, seconds=time.perf_counter() - t_phase)
    del params
    torch.cuda.empty_cache()
    return flash, moe_rows, {"main_mla_serve": serve_launches,
                             "main_mla_prefill": prefill_launches,
                             f"lm_score_bf16_{MLA_ARCH}": s16_launches}, \
        {MLA_ARCH: s16_builds}


def phase_lm_configs(torch):
    """internvl2-76b (the vision stub: 256 patch embeddings projected over
    the first positions), minitron-8b, mistral-nemo-12b and qwen2.5-14b at
    their published widths, depth cut to 2, bf16 weights from seed 0: each
    prefills 2 x 1024 tokens (B5 once per layer at the config's H:K heads
    of 128, its first call held to the plain version on its own inputs;
    the kernel phase times B5 at that shape), logits finite; then again at
    attn_score_dtype "bf16" (``lm_score_bf16``).  Each config's weights
    are freed before the next [~3]."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import registry
    paths, builds = {}, {}
    for arch in LM_CONFIGS:
        t_arch = time.perf_counter()
        full = configs.get_config(arch)
        cfg = dataclasses.replace(full, num_layers=LM_CONFIG_LAYERS)
        params, init = lm_init(torch, cfg)
        batch = {k: v.cuda() for k, v in registry.make_train_batch(
            cfg, PREFILL["batch"], PREFILL["seq"], 0).items()}
        prefill, launches, _ = lm_prefill(torch, cfg, params, batch, arch,
                                          trace=False)
        check(launches["flash_attention"] == cfg.num_layers
              and launches["moe_ffn"] == 0, f"{arch}: launches {launches}")
        paths[f"lm_score_bf16_{arch}"], builds[arch] = score_bf16_prefill(
            torch, cfg, params, batch, arch)
        del params, batch
        torch.cuda.empty_cache()
        paths[f"lm_configs_{arch}"] = launches
        emit("lm_configs", arch=arch, num_layers=cfg.num_layers,
             reduced=f"depth {full.num_layers} -> {cfg.num_layers}",
             **init, vision_tokens=cfg.vision_tokens, prefill=prefill,
             seconds=time.perf_counter() - t_arch)
    return paths, builds


def flash_plain(torch, q, k, v, window: int = 0, causal: bool = True,
                heads: int = 8, sm_scale=None, score_dtype: str = "f32"):
    """B5's plain version (``kernels/ref.py``) on (B, S, H, D) q and (B,
    S, K, D) k, v (v's head dim its own: MLA), ``heads`` query heads at a
    time: one fp32 score slab of (B heads, S, S), 2.1 GB at S = 8192."""
    from repro_torch.kernels import ref
    H, K = q.shape[2], k.shape[2]
    g = H // K
    heads = max(g, heads - heads % g)
    outs = []
    for h0 in range(0, H, heads):
        kv = slice(h0 // g, (h0 + heads) // g)
        outs.append(ref.flash_attention_ref(
            q[:, :, h0:h0 + heads], k[:, :, kv], v[:, :, kv],
            sm_scale, window, causal, score_dtype))
    return torch.cat(outs, dim=2)


def visible_pairs(S: int, window: int = 0, causal: bool = True) -> int:
    """(query, key) pairs a mask lets through, per (batch, head)."""
    if not causal:
        return S * S
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_bound(B, S, H, K, D, window=0, causal=True):
    """B5's bound: q, k, v read and o written once (bf16) against the bf16
    tensor-core operations of the pairs its mask lets through."""
    return bound_ms(2 * B * S * D * (2 * H + 2 * K),
                    4.0 * B * H * D * visible_pairs(S, window, causal),
                    BF16_FLOPS)


def remat_launches(cfg, forward: int, outside: int = 0) -> int:
    """A kernel's (B5's, B6's) launches in one training step: the
    forward's ``forward``, and again in the backward for those inside
    layers that run under remat (every ``remat_policy`` but "none"
    recomputes the layer's forward, the kernels included); ``outside`` of
    them run outside the remat'd layers (deepseek-v3's MTP block,
    whisper's encoder)."""
    return forward + (forward - outside
                      if cfg.remat_policy != "none" else 0)


def check_flash_scores(torch, gen):
    """B5's bf16-score builds (``score_dtype="bf16"``: each score rounded
    to bf16 after the product and after the bf16 scale) at PERF.md row
    5's shapes: qwen2.5-14b's causal (2, 1024, 40:8, 128), deepseek-v3's
    MLA (2, 1024, 128, q/k 192, v 128 as a strided view) and zamba2's
    window W = 4096 at (1, 8192, 32:32, 112).  Each held to its plain
    version (relative L2 <= 2e-2), and at one k block whose tile runs past
    S (S = 50) within close_bf16's bounds of its roundings emulated in
    fp32; float32 inputs (cast to bf16 for the build) equal the bf16 run
    cast; timed by CUDA events beside the fp32-score build on the same
    inputs, the plain version, the bound and SDPA (no PyTorch call rounds
    the scores to bf16: the nearest call, labelled so) [~8]."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    F = torch.nn.functional

    def rand(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    rows = {}
    for name, (B, S, H, K, D, Dv), window in FLASH_SCORE_CASES:
        q, k = rand(B, S, H, D), rand(B, S, K, D)
        v = rand(B, S, K, 128 + Dv)[..., 128:] if Dv != D else \
            rand(B, S, K, Dv)
        mask = kfa.mask_of(window, True)
        ops.reset_launch_counts()
        got = ops.flash_attention(q, k, v, window=window, score_dtype="bf16")
        builds = ops.flash_attention_builds()
        want = flash_plain(torch, q, k, v, window, score_dtype="bf16")
        torch.cuda.synchronize()
        check(got.shape == (B, S, H, Dv) and got.dtype == q.dtype, name)
        rel = rel_l2(torch, got, want)
        check(rel <= BF16_REL_L2, f"flash s16 {name}: relative L2 {rel} vs "
              "plain")
        build = kfa.plan(D, Dv, S, q.dtype, mask, "bf16")["build"]
        check(builds == {build: 1}, f"flash s16 {name}: builds {builds}")
        # One k block whose tile runs past S, kv heads = q heads.
        qe, ke = (t[:, :EMULATED_S, :4].contiguous() for t in (q, k))
        ve = v[:, :EMULATED_S, :4].contiguous()
        we = min(window, 5)
        emu = close_bf16(torch, ops.flash_attention(
            qe, ke, ve, window=we, score_dtype="bf16"),
            flash_emulated(torch, qe, ke, ve, we, score_dtype="bf16"),
            f"flash s16 {name} S={EMULATED_S}")
        f32in = ops.flash_attention(qe.float(), ke.float(), ve.float(),
                                    window=we, score_dtype="bf16")
        check(f32in.dtype == torch.float32 and torch.equal(
            f32in, ops.flash_attention(qe, ke, ve, window=we,
                                       score_dtype="bf16").float()),
              f"flash s16 {name}: float32 inputs")
        bms, by = bound_ms(2 * B * S * (H * D + K * D + K * Dv + H * Dv),
                           2.0 * B * H * (D + Dv)
                           * visible_pairs(S, window), BF16_FLOPS)
        row = dict(shape=[B, S, H, K, D, Dv], window=window, mask=mask,
                   build=build, bound_ms=bms, bound_by=by,
                   max_abs_err=float((got.float() - want.float()).abs()
                                     .max()),
                   rel_l2_vs_plain=rel, max_abs_err_emulated=emu,
                   rel_l2_vs_f32_scores=rel_l2(torch, got,
                                               ops.flash_attention(
                                                   q, k, v, window=window)))
        del got, want
        calls = 5 if S > 4096 else 20
        row["ms"] = time_ms(torch, lambda i: ops.flash_attention(
            q, k, v, window=window, score_dtype="bf16"), calls)
        row["f32_scores_ms"] = time_ms(torch, lambda i: ops.flash_attention(
            q, k, v, window=window), calls)
        row["ms_2"] = time_ms(torch, lambda i: ops.flash_attention(
            q, k, v, window=window, score_dtype="bf16"), calls)
        row["plain_ms"] = time_ms(torch, lambda i: flash_plain(
            torch, q, k, v, window, score_dtype="bf16"), 1, warmup=1)
        qt = q.transpose(1, 2)
        kt, vt = (t.repeat_interleave(H // K, dim=2).transpose(1, 2)
                  for t in (k, v))
        kw = {"is_causal": True}
        if window:
            i = torch.arange(S, device="cuda")
            kw = {"attn_mask": (i[:, None] >= i[None, :])
                  & (i[None, :] > i[:, None] - window)}
        row["library_ms"] = time_ms(
            torch, lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, **kw), calls)
        row["library"] = ("scaled_dot_product_attention("
                          + ("band" if window else "is_causal")
                          + "), fp32 scores: the nearest PyTorch call, no "
                          "PyTorch call rounds the scores to bf16")
        rows[name] = row
        del q, k, v, qt, kt, vt, kw
        torch.cuda.empty_cache()
    emit("kernel", name="flash_attention_score_bf16", cases=rows,
         tolerance="relative L2 <= 2e-2 vs plain (bf16 scores); at S = 50 "
         "relative L2 <= 2^-9 and |err| <= 2^-5 (|ref|+rms) vs the "
         "emulated roundings; float32 inputs equal the bf16 run cast")
    return rows


def check_flash_masks(torch, gen):
    """B5's builds of this slice held to its plain version and timed:
    head dim 112 (the padded 128 build), causal, at zamba2's prefill
    (2, 1024, 32:32, 112); the window build at its long prefill (1, 8192,
    32:32, 112) with W = 4096, and at W = 1000 and W = 1 on (1, 2048),
    windows that leave a row's first visited block outside its window;
    the bidirectional build at whisper's encoder (2, 1500, 8:8, 64), S
    not a multiple of 64.  Each in bf16 (relative L2 <= 2e-2 against the
    plain version; and at one k block, S = 50, whose tile runs past S,
    within close_bf16's bounds of its roundings emulated in fp32) and in fp32 (|err| <= 3e-5 (1 +
    |ref|)); timed by CUDA events beside its bound and SDPA (is_causal,
    the boolean band as attn_mask, no mask) [~10]."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    F = torch.nn.functional

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    rows = {}
    for name, (B, S, H, K, D), window, causal, sdpa in FLASH_MASK_CASES:
        mask = kfa.mask_of(window, causal)
        q = rand(B, S, H, D)
        k, v = (rand(B, S, K, D) for _ in range(2))
        ops.reset_launch_counts()
        got = ops.flash_attention(q, k, v, window=window, causal=causal)
        builds = ops.flash_attention_builds()
        want = flash_plain(torch, q, k, v, window, causal)
        torch.cuda.synchronize()
        check(got.shape == q.shape and got.dtype == q.dtype, name)
        rel = rel_l2(torch, got, want)
        check(rel <= BF16_REL_L2, f"flash {name}: relative L2 {rel} vs plain")
        q32, k32, v32 = (t.float() for t in (q, k, v))
        got32 = ops.flash_attention(q32, k32, v32, window=window,
                                    causal=causal)
        want32 = flash_plain(torch, q32, k32, v32, window, causal)
        err32 = (got32 - want32).abs()
        check(bool((err32 <= F32_FLASH_TOL * (1 + want32.abs())).all()),
              f"flash {name} f32: max err {float(err32.max())}")
        f32_err = float(err32.max())
        del got32, want32, err32, q32, k32, v32
        # One k block whose tile runs past S: its zero-filled keys must
        # stay out of the softmax, which the 2e-2 bound above would not see
        # at S = 1500 (36 such keys rescale each row by ~1 %).
        qe, ke, ve = (t[:3, :EMULATED_S, :4].contiguous() for t in (q, k, v))
        emu = close_bf16(torch, ops.flash_attention(
            qe, ke, ve, window=min(window, 5), causal=causal),
            flash_emulated(torch, qe, ke, ve, min(window, 5), causal),
            f"flash {name} S={EMULATED_S}")
        bms, by = flash_bound(B, S, H, K, D, window, causal)
        row = dict(shape=[B, S, H, K, D], window=window, mask=mask,
                   build=kfa.plan(D, D, S, q.dtype, mask)["build"],
                   launch_builds=builds, bound_ms=bms, bound_by=by,
                   max_abs_err=float((got.float() - want.float()).abs()
                                     .max()),
                   rel_l2_vs_plain=rel, max_abs_err_emulated=emu,
                   f32_max_abs_err=f32_err)
        del got, want
        row["ms"] = time_ms(torch, lambda i: ops.flash_attention(
            q, k, v, window=window, causal=causal), 10)
        row["plain_ms"] = time_ms(torch, lambda i: flash_plain(
            torch, q, k, v, window, causal), 1, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kw = {"is_causal": True} if sdpa == "is_causal" else {}
        if sdpa == "band":
            i = torch.arange(S, device="cuda")
            kw["attn_mask"] = ((i[:, None] >= i[None, :])
                               & (i[None, :] > i[:, None] - window))
        row["library_ms"] = time_ms(
            torch, lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, **kw), 10)
        row["library"] = f"scaled_dot_product_attention({sdpa})"
        del qt, kt, vt, kw
        rows[name] = row
        del q, k, v
        torch.cuda.empty_cache()
    emit("kernel", name="flash_attention_masks", cases=rows,
         tolerance="bf16: relative L2 <= 2e-2 vs plain, and at S = 50 "
         "relative L2 <= 2^-9 and |err| <= 2^-5 (|ref|+rms) vs the "
         "emulated roundings; f32: |err| <= 3e-5 (1+|ref|) vs plain")
    return rows


def lm_init(torch, cfg, seed: int = 0):
    """bf16 weights of ``cfg`` from a CUDA generator, their count checked
    against ``cfg.param_count()``; (params, init seconds, init peak bytes,
    parameter count, parameter bytes)."""
    from repro_torch.models import common, registry
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator("cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = common.init_params(registry.param_specs(cfg), gen, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(t.numel() for t in common.leaves(params))
    check(n == cfg.param_count(), f"{cfg.name}: {n} parameters, config "
          f"{cfg.param_count()}")
    return params, dict(
        params=n, param_bytes=sum(t.numel() * t.element_size()
                                  for t in common.leaves(params)),
        init_s=init_s, init_peak_bytes=torch.cuda.max_memory_allocated())


def lm_serve(torch, cfg, params, what: str, trace: bool = True,
             check_server=None):
    """The Server (4 slots) answers SERVE's 8 requests of 4 + 16 tokens,
    launch counts set to 0 just before and read just after: every request
    answered in full with in-range tokens, and one more decode step's
    logits finite; then, with ``trace``, 2 more rounds under
    torch.profiler (where a round's time goes).  ``check_server`` is
    called on the new Server before it serves.  Returns (serve dict,
    launches, B5 launches by build)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import registry
    server = Server(cfg, params, slots=SERVE["slots"],
                    max_seq=SERVE["max_seq"])
    if check_server is not None:
        check_server(server)
    rng = np.random.RandomState(0)
    reqs = [Request(i, rng.randint(0, cfg.vocab_size,
                                   size=SERVE["prompt_len"]),
                    SERVE["max_new"]) for i in range(SERVE["requests"])]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = server.serve(reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, builds = ops.launch_counts(), ops.flash_attention_builds()
    check(len(done) == SERVE["requests"] and all(
        len(r.out) == SERVE["max_new"]
        and all(0 <= t < cfg.vocab_size for t in r.out) for r in done),
        f"{what}: served {len(done)} requests, tokens missing or out of "
        "range")
    logits, _ = registry.decode_step(
        params, cfg, server.cache, torch.from_numpy(server.tokens).cuda(),
        server.pos)
    check(logits.shape == (SERVE["slots"], 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{what}: decode logits not finite")
    tokens = sum(len(r.out) for r in done)
    out = dict(slots=SERVE["slots"], max_seq=SERVE["max_seq"],
               requests=len(done), rounds=server.rounds, tokens=tokens,
               seconds=seconds, tokens_per_s=tokens / seconds,
               ms_per_round=1e3 * seconds / server.rounds,
               launches=launches, flash_attention_builds=builds)
    if trace:
        out["trace_2_rounds"] = traced(torch, lambda: [
            server.decode_round() for _ in range(2)])
    del server, logits
    torch.cuda.empty_cache()
    return out, launches, builds


def lm_prefill(torch, cfg, params, batch, what: str, trace: bool = True,
               hold_all: bool = False, vs_plain_attention: bool = False):
    """One ``registry.prefill`` of ``batch``, launch counts set to 0 just
    before and read just after, timed to a synchronize; then again with
    the first B5 call of each mask (every call with ``hold_all``) held to
    the plain version on that call's own q, k, v (chunked over heads);
    with ``vs_plain_attention`` once more through the plain attention, its
    logits' distance reported (two bf16 paths: the kernel rounds p to
    bf16 before p.v, the plain attention does not); and with ``trace``
    once more under torch.profiler (busy share, device time by kernel,
    B5's).  Logits finite.  Returns (prefill dict, launches, B5 launches
    by build)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = registry.prefill(params, cfg, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, builds = ops.launch_counts(), ops.flash_attention_builds()
    peak = torch.cuda.max_memory_allocated()
    B = batch["tokens"].shape[0]
    check(logits.shape == (B, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{what}: prefill logits not finite")
    kernel, held, out = ops.flash_attention, {}, {}

    def hold(q, k, v, sm_scale=None, window=0, causal=True,
             score_dtype="f32"):
        o = kernel(q, k, v, sm_scale, window, causal, score_dtype)
        key = kfa.mask_of(window, causal) + (
            "-s16" if score_dtype == "bf16" else "")
        rows = held.setdefault(key, [])
        if hold_all or not rows:
            rows.append(dict(shape=list(q.shape), kv_heads=k.shape[2],
                             window=window, score_dtype=score_dtype,
                             rel_l2_vs_plain=rel_l2(
                                 torch, o, flash_plain(
                                     torch, q, k, v, window, causal,
                                     sm_scale=sm_scale,
                                     score_dtype=score_dtype))))
        return o
    ops.flash_attention = hold
    try:
        registry.prefill(params, cfg, batch)
        if vs_plain_attention:
            ops.flash_attention = ops.attention_math
            out["logits_rel_l2_vs_plain_attention"] = rel_l2(
                torch, logits, registry.prefill(params, cfg, batch))
    finally:
        ops.flash_attention = kernel
    del logits
    for key, rows in held.items():
        worst = max(r["rel_l2_vs_plain"] for r in rows)
        check(worst <= BF16_REL_L2, f"{what}: B5 ({key}) on the path's own "
              f"inputs, relative L2 {worst} vs plain")
    if trace:
        out["trace"] = traced(
            torch, lambda: registry.prefill(params, cfg, batch),
            kernels=("flash_attention",))
    torch.cuda.empty_cache()
    return dict(shape=list(batch["tokens"].shape), seconds=seconds,
                launches=launches, flash_attention_builds=builds,
                b5_held_to_plain=held, peak_bytes=peak, **out), \
        launches, builds


def score_bf16_prefill(torch, cfg, params, batch, what: str):
    """``lm_score_bf16``: ``batch``'s prefill again at attn_score_dtype
    "bf16" (launch counts set to 0 just before, read just after): every B5
    call the config's bf16-score build, once per layer, its first call
    held to the plain version; logits finite, their relative L2 from the
    fp32-score prefill reported.  Returns (launches, builds)."""
    import dataclasses
    from repro_torch.models import registry
    s16 = dataclasses.replace(cfg, attn_score_dtype="bf16")
    prefill, launches, builds = lm_prefill(torch, s16, params, batch,
                                           f"{what} bf16 scores",
                                           trace=False)
    check(launches["flash_attention"] == cfg.num_layers
          and sum(builds.values()) == cfg.num_layers
          and all(b.endswith("-s16") for b in builds),
          f"{what} bf16 scores: launches {launches}, builds {builds}")
    l16 = registry.prefill(params, s16, batch)
    l32 = registry.prefill(params, cfg, batch)
    prefill["logits_rel_l2_vs_f32_scores"] = rel_l2(torch, l16, l32)
    del l16, l32
    emit("lm_score_bf16", arch=cfg.name, num_layers=cfg.num_layers,
         prefill=prefill)
    return launches, builds


def phase_host_mesh(torch):
    """The LM substrate's host mesh on the card: ``make_host_mesh()``, a 1 x
    1 ('data', 'model') DeviceMesh on CUDA over the default group (world
    size 1), validated, and one DTensor all-reduce over it [~1]."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.mesh import make_host_mesh, validate_mesh
    t0 = time.perf_counter()
    mesh = make_host_mesh()
    validate_mesh(mesh, ("data", "model"))
    check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
          and mesh.mesh_dim_names == ("data", "model"),
          f"host_mesh: {mesh}")
    x = distribute_tensor(torch.arange(6.0, device="cuda").reshape(2, 3),
                          mesh, [Replicate(), Replicate()])
    total = float((x * 2).sum().full_tensor())
    check(total == 30.0, f"host_mesh: {total}")
    emit("host_mesh", shape=list(mesh.shape), device_type=mesh.device_type,
         names=list(mesh.mesh_dim_names),
         seconds=time.perf_counter() - t0)


def start_dryrun() -> dict:
    """Start the dry-run's CLI on each of ``DRYRUN_CELLS``, one process
    each, side by side, on the host (nothing runs on the card), listed in
    ``BACKGROUND`` so that every profiler trace stops them; read by :func:`phase_dryrun`, stopped by
    :func:`stop_dryrun` (also at exit)."""
    import atexit
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    runs = {"out": out, "t0": time.perf_counter(), "procs": [], "logs": []}
    atexit.register(stop_dryrun, runs)
    for arch, shape, mesh in DRYRUN_CELLS:
        # a file, not a pipe: nothing reads the output until the phase
        log = open(Path(out) / f"{arch}.log", "w+")
        runs["logs"].append(log)
        runs["procs"].append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", out],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    BACKGROUND["procs"] += runs["procs"]
    return runs


def stop_dryrun(runs: dict) -> None:
    import shutil
    for p in runs["procs"]:
        p.kill()
        p.wait()
        if p in BACKGROUND["procs"]:
            BACKGROUND["procs"].remove(p)
    for log in runs["logs"]:
        log.close()
    shutil.rmtree(runs["out"], ignore_errors=True)


def phase_dryrun(runs: dict):
    """The dry-run's records of ``DRYRUN_CELLS`` (qwen2-0.5b, olmoe-1b-7b
    and xlstm-125m train_4k, zamba2-7b prefill_32k, on the (16, 16) mesh
    of a fake 256-rank group), started by :func:`start_dryrun`; per
    record: ok, chips,
    collectives (static plus one trip of the loops > 0, no trip whose
    collectives differ from its loop's first, ``DRYRUN_TRIPS`` among the
    loops' trip counts), per-device FLOPs at or under the reference's
    (``DRYRUN_REFERENCE_FLOPS``) and at least the model's, within
    ``DRYRUN_AGREE`` of a CPU host's torch 2.13 count
    (``DRYRUN_CPU_HOST_FLOPS``); every cell's temporaries at or under
    ``DRYRUN_TEMP_MAX``, qwen2-0.5b's static all-gather
    under ``DRYRUN_STATIC_ALL_GATHER_MAX``; FLOPs by op class and
    collectives by kind, each cell's bytes accessed and
    ``memory_analysis`` (its temporaries), its trace seconds, the seconds
    from the start to the
    last record and the seconds the profiler's traces held the processes
    stopped (``paused_s``, within both) [qwen2 and olmoe ~30 s, zamba2
    ~40-60 s (40-57 s on an 8-core CPU host alone), xlstm ~440-540 s:
    476.5 s on the GPU host beside qwen2 and olmoe, 795 s on an 8-core CPU
    host beside the tests; read here, ~8 min after the build, ~0-60 s of
    waiting]."""
    import torch
    try:
        rcs = [p.wait(timeout=900) for p in runs["procs"]]
        seconds = time.perf_counter() - runs["t0"]
        recs = []
        for (arch, shape, mesh), rc, log in zip(DRYRUN_CELLS, rcs,
                                                runs["logs"]):
            log.seek(0)
            check(rc == 0, f"dryrun {arch}: {log.read()[-2000:]}")
            recs.append(json.loads((Path(runs["out"]) / f"{arch}_{shape}_"
                                    f"{mesh}_baseline.json").read_text()))
    finally:
        stop_dryrun(runs)
    for rec in recs:
        arch = rec["arch"]
        ref, cpu = DRYRUN_REFERENCE_FLOPS[arch], DRYRUN_CPU_HOST_FLOPS[arch]
        model = rec["model_flops"] / rec["chips"]
        trips = DRYRUN_TRIPS[arch]
        check(rec["ok"] and rec["chips"] == 256
              and rec["collective_bytes_static"]
              + rec["collective_in_loop_bytes"] > 0
              and not rec["collective_uneven_trips"]
              and all(t in rec["while_trip_counts"] for t in trips),
              f"dryrun: {rec}")
        check(model <= rec["flops"] <= ref,
              f"dryrun {arch}: {rec['flops']:.4e} FLOPs per device, the "
              f"model's {model:.4e}, the reference's {ref:.4e}")
        check(abs(rec["flops"] / cpu - 1) <= DRYRUN_AGREE,
              f"dryrun {arch}: {rec['flops']:.4e} FLOPs per device, the "
              f"CPU host's torch 2.13 {cpu:.4e}")
        temp = rec["memory_analysis"]["temp_size_in_bytes"]
        gather = rec["collective_by_kind"].get("all-gather", 0)
        check(temp <= DRYRUN_TEMP_MAX[arch],
              f"dryrun {arch}: {temp:.4e} B of temporaries per rank, the "
              f"reference's {DRYRUN_TEMP_MAX[arch]}")
        check(gather < DRYRUN_STATIC_ALL_GATHER_MAX.get(arch, math.inf),
              f"dryrun {arch}: {gather:.4e} B of static all-gather")
        emit("dryrun", seconds=seconds,
             paused_s=BACKGROUND["paused_s"],
             torch_version=torch.__version__,
             reference_flops=ref, cpu_host_flops=cpu,
             flops_over_reference=rec["flops"] / ref,
             flops_over_cpu_host=rec["flops"] / cpu,
             model_flops_per_device=model,
             temp_max=DRYRUN_TEMP_MAX[arch],
             static_all_gather_max=DRYRUN_STATIC_ALL_GATHER_MAX.get(arch),
             **{k: rec[k] for k in (
                 "arch", "shape", "mesh", "chips", "params_total", "trace_s",
                 "flops", "flops_source", "flops_by_op", "model_flops",
                 "bytes_accessed", "collective_bytes_static",
                 "collective_by_kind", "collective_counts",
                 "collective_in_loop_bytes", "collective_in_loop_by_kind",
                 "collective_in_loop_counts", "while_trip_counts",
                 "collective_bytes_all_trips", "collective_uneven_trips",
                 "memory_analysis")})


_DRYRUN_MEMORY_TRACE = """
import dataclasses, json, sys
from repro_torch import configs
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import dryrun
arch, batch, seq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
out = {}
for policy in sys.argv[4].split(","):
    cfg = dataclasses.replace(configs.get_config(arch), remat_policy=policy)
    rec = dryrun.run_cell(arch, "train", False, mesh_shape=(1, 1), cfg=cfg,
                          cell=ShapeCell("train", seq, batch, "train"))
    out[policy] = {k: rec[k] for k in ("memory_analysis", "trace_s",
                                       "while_trip_counts", "chips")}
print(json.dumps(out))
"""


def phase_dryrun_memory(torch):
    """The dry-run's per-rank memory against the card: the world-size-1
    trace (``dryrun.run_cell`` on a 1 x 1 mesh, plain fake CPU tensors, in
    a host process started first) of one ``dryrun.make_train_step`` step
    of TRAIN's arch at full width and depth on 8 x 128 tokens, under each
    of ``DRYRUN_MEMORY_POLICIES``; on the card the same step on bf16
    weights from seed 0 and fp32 AdamW state, measured after a warm-up
    step with ``reset_peak_memory_stats`` just before it and
    ``max_memory_allocated`` just after it, less what the process held
    besides the step's arguments.  Checks: a finite loss, B5 once per
    layer per step under "none" and twice under "nothing" (launch counts
    reset just before the measured step), B6 never, the card's argument
    bytes the trace's, and the card's peak within DRYRUN_MEMORY_AGREE of
    the trace's argument + temp bytes [~20-30]."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.optim import AdamWConfig, adamw_init
    t0 = time.perf_counter()
    arch, B, S = TRAIN["arch"], TRAIN["batch_size"], TRAIN["seq_len"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    trace = subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_MEMORY_TRACE, arch, str(B), str(S),
         ",".join(DRYRUN_MEMORY_POLICIES)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    try:
        cfg = configs.get_config(arch)
        ocfg = AdamWConfig(state_dtype=torch.float32)
        batch = lm_batch(torch, cfg, B, S)
        card, paths = {}, {}
        for policy in DRYRUN_MEMORY_POLICIES:
            c = dataclasses.replace(cfg, remat_policy=policy)
            params, _ = lm_init(torch, c)
            opt = adamw_init(params, ocfg)
            step = dryrun.make_train_step(c, ocfg)
            params, opt, loss, _ = step(params, opt, batch)     # warm-up
            torch.cuda.synchronize()
            args = sum(t.numel() * t.element_size() for t in
                       dryrun.tree_leaves((params, opt, batch))
                       if isinstance(t, torch.Tensor))
            other = torch.cuda.memory_allocated() - args
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            ts = time.perf_counter()
            params, opt, loss, _ = step(params, opt, batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - ts
            peak = torch.cuda.max_memory_allocated() - other
            launches = ops.launch_counts()
            loss = float(loss)
            check(math.isfinite(loss), f"dryrun_memory {policy}: loss {loss}")
            check(launches["flash_attention"]
                  == remat_launches(c, c.num_layers)
                  and launches["moe_ffn"] == 0,
                  f"dryrun_memory {policy}: launches {launches}")
            paths[f"dryrun_memory_{policy}"] = launches
            card[policy] = dict(peak_bytes=peak, argument_bytes=args,
                                other_bytes=other, step_s=step_s, loss=loss)
            del params, opt, step
            torch.cuda.empty_cache()
        del batch
        out, err = trace.communicate(timeout=600)
    finally:
        trace.kill()
    check(trace.returncode == 0, f"dryrun_memory trace: {err[-2000:]}")
    traced = json.loads(out.strip().splitlines()[-1])
    for policy in DRYRUN_MEMORY_POLICIES:
        mem = traced[policy]["memory_analysis"]
        want = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        got = card[policy]
        # The trace's batch is int32 tokens and labels, the trainer's
        # batch the same; the step counter is a host int in both.
        check(got["argument_bytes"] == mem["argument_size_in_bytes"],
              f"dryrun_memory {policy}: card arguments "
              f"{got['argument_bytes']}, trace {mem}")
        ratio = got["peak_bytes"] / want
        check(abs(ratio - 1) <= DRYRUN_MEMORY_AGREE,
              f"dryrun_memory {policy}: card peak {got['peak_bytes']}, "
              f"trace argument + temp {want} ({ratio:.4f})")
        emit("dryrun_memory", arch=arch, batch_size=B, seq_len=S,
             remat_policy=policy, card_peak_bytes=got["peak_bytes"],
             trace_argument_plus_temp_bytes=want,
             card_over_trace=ratio, agree=DRYRUN_MEMORY_AGREE,
             memory_analysis=mem, card_argument_bytes=got["argument_bytes"],
             card_other_bytes=got["other_bytes"], step_s=got["step_s"],
             loss=got["loss"], launches=paths[f"dryrun_memory_{policy}"],
             trace_s=traced[policy]["trace_s"],
             while_trip_counts=traced[policy]["while_trip_counts"],
             seconds=time.perf_counter() - t0)
    return paths


def phase_main_hybrid(torch):
    """zamba2-7b at its published width and depth (81 layers: 13 groups
    of 6 Mamba2 layers, each followed by the one shared attention + MLP
    block at 32:32 heads of 112, then a tail of 3; d_model 3584, state
    64, vocab 32,000), bf16 weights from seed 0: the Server answers 8
    requests (Mamba2's state recurrence and the shared block's decode,
    plain torch as the reference: B5 never), a prefill of 2 x 1024 tokens
    (B5's causal build once per shared-block invocation, 13), then one of
    1 x 8192 under the long-context override (its window build, 13), the
    first B5 call of each prefill held to the plain version on its own
    inputs [~15-40]."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import registry
    t_phase = time.perf_counter()
    cfg = configs.get_config(HYBRID_ARCH)
    params, init = lm_init(torch, cfg)
    groups = cfg.num_layers // cfg.attn_every
    serve, serve_launches, serve_builds = lm_serve(torch, cfg, params,
                                                   "main_hybrid")
    check(sum(serve_launches.values()) == 0,
          f"main_hybrid: serve launches {serve_launches}")
    batch = {k: v.cuda() for k, v in registry.make_train_batch(
        cfg, PREFILL["batch"], PREFILL["seq"], 0).items()}
    prefill, pre_launches, pre_builds = lm_prefill(torch, cfg, params, batch,
                                                   "main_hybrid")
    check(pre_builds == {"bf16-128x128-causal": groups}
          and pre_launches["flash_attention"] == groups,
          f"main_hybrid: prefill launches {pre_launches}, {pre_builds}")
    long_cfg = dataclasses.replace(
        cfg, **configs.long_context_overrides(HYBRID_ARCH))
    batch = {k: v.cuda() for k, v in registry.make_train_batch(
        cfg, LONG_PREFILL["batch"], LONG_PREFILL["seq"], 0).items()}
    long, long_launches, long_builds = lm_prefill(
        torch, long_cfg, params, batch, "main_hybrid long")
    check(long_builds == {"bf16-128x128-window": groups}
          and long_launches["flash_attention"] == groups,
          f"main_hybrid: long prefill launches {long_launches}, "
          f"{long_builds}")
    del params, batch
    torch.cuda.empty_cache()
    emit("main_hybrid", arch=cfg.name, num_layers=cfg.num_layers,
         reduced="none (published depth)", groups=groups,
         head_dim=cfg.hd, **init, serve=serve, prefill=prefill,
         long_prefill=dict(long, sliding_window=long_cfg.sliding_window),
         seconds=time.perf_counter() - t_phase)
    return {"main_hybrid_serve": dict(serve_launches, builds=serve_builds),
            "main_hybrid_prefill": dict(pre_launches, builds=pre_builds),
            "main_hybrid_long": dict(long_launches, builds=long_builds)}


def phase_lm_xlstm(torch):
    """xlstm-125m at its published width and depth (12 blocks: 3 groups
    of 3 mLSTM + 1 sLSTM, d_model 768, 4 heads, vocab 50,304), bf16
    weights from seed 0: the Server answers 8 requests and a prefill of 2
    x 1024 tokens runs; every launch count is 0, since no kernel is on
    this path (the reference has none: mLSTM is einsums and a chunk
    scan, sLSTM a loop over time, one step's ops enqueued per token).
    Then float32 weights from a CPU generator: the card's prefill logits
    on a 2 x 256 prompt against the same prefill on the CPU, rtol 1e-4
    [~5-15]."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import common, registry
    t_phase = time.perf_counter()
    cfg = configs.get_config(XLSTM_ARCH)
    params, init = lm_init(torch, cfg)
    serve, serve_launches, _ = lm_serve(torch, cfg, params, "lm_xlstm")
    batch = {k: v.cuda() for k, v in registry.make_train_batch(
        cfg, PREFILL["batch"], PREFILL["seq"], 0).items()}
    prefill, pre_launches, _ = lm_prefill(torch, cfg, params, batch,
                                          "lm_xlstm", trace=False)
    check(sum(serve_launches.values()) == sum(pre_launches.values()) == 0,
          f"lm_xlstm: launches {serve_launches}, {pre_launches}")
    # The sLSTM's loop enqueues ~56,000 ops on 2 x 1024 tokens, too many
    # to trace in the smoke's time: the trace takes a quarter of it.
    short = {k: v[:, :XLSTM_F32_PREFILL["seq"]] for k, v in batch.items()}
    prefill["trace_2x256"] = traced(
        torch, lambda: registry.prefill(params, cfg, short))
    del params, batch, short
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator("cpu")
    gen.manual_seed(0)
    p_cpu = common.init_params(registry.param_specs(cfg32), gen, "cpu")
    p_gpu = common.tree_map(lambda t: t.cuda(), p_cpu)
    b_cpu = registry.make_train_batch(cfg32, XLSTM_F32_PREFILL["batch"],
                                      XLSTM_F32_PREFILL["seq"], 1)
    got = registry.prefill(p_gpu, cfg32, {k: v.cuda()
                                          for k, v in b_cpu.items()}).cpu()
    t0 = time.perf_counter()
    want = registry.prefill(p_cpu, cfg32, b_cpu)
    cpu_s = time.perf_counter() - t0
    err = (got - want).abs()
    check(bool((err <= XLSTM_F32_RTOL * (1 + want.abs())).all()),
          f"lm_xlstm: f32 prefill logits, card vs CPU, max err "
          f"{float(err.max())}")
    del p_cpu, p_gpu
    torch.cuda.empty_cache()
    emit("lm_xlstm", arch=cfg.name, num_layers=cfg.num_layers,
         reduced="none (published depth)", **init, serve=serve,
         prefill=prefill, kernels="none on this path (launches 0)",
         f32_prefill=dict(shape=[XLSTM_F32_PREFILL["batch"],
                                 XLSTM_F32_PREFILL["seq"]],
                          max_abs_err=float(err.max()),
                          tolerance="|err| <= 1e-4 (1 + |cpu|)",
                          cpu_seconds=cpu_s),
         seconds=time.perf_counter() - t_phase)
    return {"lm_xlstm": dict(
        {k: serve_launches[k] + pre_launches[k] for k in pre_launches},
        builds={})}


def phase_lm_whisper(torch):
    """whisper-base at its published width and depth (6 encoder + 6
    decoder layers, d_model 512, 8:8 heads of 64, vocab 51,865, 1500
    stub audio frames), bf16 weights from seed 0: a prefill of 2 x (1500
    frames, 448 tokens) (B5's bidirectional build once per encoder layer
    at (2, 1500, 8:8, 64), its causal build once per decoder layer at (2,
    448, 8:8, 64); the first call of each held to the plain version on its
    own inputs), then the Server answers 8 requests against the zero
    cross-attention cache, as the reference serves (B5 never) [~3-10]."""
    from repro_torch import configs
    from repro_torch.models import registry
    t_phase = time.perf_counter()
    cfg = configs.get_config(WHISPER_ARCH)
    params, init = lm_init(torch, cfg)
    batch = {k: v.cuda() for k, v in registry.make_train_batch(
        cfg, WHISPER_PREFILL["batch"], WHISPER_PREFILL["seq"], 0).items()}
    check(tuple(batch["frames"].shape) == (WHISPER_PREFILL["batch"],
                                           cfg.encoder_seq, cfg.d_model),
          "lm_whisper: frames")
    prefill, pre_launches, pre_builds = lm_prefill(torch, cfg, params, batch,
                                                   "lm_whisper")
    check(pre_builds == {"bf16-64x64-bidirectional": cfg.encoder_layers,
                         "bf16-64x64-causal": cfg.num_layers},
          f"lm_whisper: prefill builds {pre_builds}")
    check(set(prefill["b5_held_to_plain"]) == {"bidirectional", "causal"},
          "lm_whisper: an encoder and a decoder call held")
    serve, serve_launches, serve_builds = lm_serve(torch, cfg, params,
                                                   "lm_whisper")
    check(sum(serve_launches.values()) == 0,
          f"lm_whisper: serve launches {serve_launches}")
    del params, batch
    torch.cuda.empty_cache()
    emit("lm_whisper", arch=cfg.name, num_layers=cfg.num_layers,
         encoder_layers=cfg.encoder_layers, encoder_seq=cfg.encoder_seq,
         reduced="none (published depth)", **init, prefill=prefill,
         serve=dict(serve, cross_cache="zero, as the reference's "
                    "init_cache leaves it"),
         seconds=time.perf_counter() - t_phase)
    return {"lm_whisper": dict(
        {k: pre_launches[k] + serve_launches[k] for k in pre_launches},
        builds=pre_builds)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    dryrun_runs = start_dryrun()

    from repro_torch.data.synthetic import ocr_like
    t0 = time.perf_counter()
    data = ocr_like(**OCR)
    emit("data", seconds=time.perf_counter() - t0, shape=list(data[0].shape))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    masks = torch.from_numpy(data[2]).cuda()
    kernels = [check_plane_scores(torch, gen),
               check_viterbi(torch, gen, masks),
               check_plane_select(torch, gen),
               check_moe_ffn(torch, gen),
               check_flash_attention(torch, gen),
               check_gram(torch, gen),
               check_approx_pass(torch, gen)]
    torch.cuda.empty_cache()
    phase_parity(torch)
    launches, solver, main_walls = phase_main(torch, data)
    main_rows = list(solver.trace)
    # The weights of main's 3 iterations, exported before profile moves
    # the state on.
    ocr_model = solver.servable()
    # The pass kernel's numbers at the main path's shape: a whole pass
    # over the trained full-size state.
    full = phase_profile(torch, solver)
    kernels[-1].update(shape=[full["blocks"], RUN["cap"], solver.problem.d],
                       **{k: full[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "valid_planes",
                                               "us_per_block", "plan")})
    del solver
    torch.cuda.empty_cache()
    # main and main's run in wall mode again, each with a RunRecorder.
    obs_paths = {"obs": phase_obs(torch, data, main_rows, launches,
                                  main_walls)}
    torch.cuda.empty_cache()
    obs_paths["obs_wall"] = phase_obs_wall(torch, data, full)
    torch.cuda.empty_cache()
    phase_parity_async(torch)
    launches_async, solver = phase_main_async(torch, data)
    phase_profile_async(torch, solver)
    del solver
    torch.cuda.empty_cache()
    phase_parity_gram(torch)
    launches_gram, solver, gram_run_launches = phase_main_gram(torch, data)
    gram_rows = list(solver.trace)
    kernels[-1]["sec35_full"] = phase_profile_gram(torch, solver)
    del solver
    torch.cuda.empty_cache()
    phase_resume(torch)
    phase_obs_checkpoint(torch)
    # The shard engine at world size 1 (NCCL on the card).
    meshes = shard_meshes(torch)
    phase_parity_shard(torch, meshes)
    launches_shard, shard_solver = phase_main_shard(
        torch, data, meshes["cuda"], main_rows, launches)
    launches_shard_tau = phase_main_shard_tau(torch, data, meshes["cuda"])
    torch.cuda.empty_cache()
    launches_shard_gram, shard_gram_solver = phase_main_shard_gram(
        torch, data, meshes["cuda"], gram_rows, gram_run_launches)
    stride_err, stride_timing = phase_shard_stride(torch, shard_solver,
                                                   shard_gram_solver)
    kernels[-1].update(stride_max_abs_err=stride_err,
                       stride1_full_pass=stride_timing)
    kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], stride_err)
    del shard_solver, shard_gram_solver
    torch.cuda.empty_cache()
    phase_resume_shard(torch, meshes["cuda"])
    launches_contracts = phase_contracts(torch)
    torch.cuda.empty_cache()
    phase_parity_specs(torch)
    phase_parity_simple(torch)
    simple_paths = {phase: phase_main_simple(torch, data, phase, algo)
                    for phase, algo in SIMPLE_MAIN}
    torch.cuda.empty_cache()
    gap_checks = dict(kernels[-1].pop("gap_checks"))
    gap_checks["small_ocr"] = phase_parity_gap(torch)
    launches_gap, gap_timing, gap_checks["main_gap"] = phase_main_gap(
        torch, data, full["ms"])
    kernels[-1]["gap_output"] = dict(
        max_abs_err=max(v["max_abs_err"] for v in gap_checks.values()),
        tolerance=GAP_TOL, checks=gap_checks, **gap_timing)
    torch.cuda.empty_cache()
    wide_errs, wide_timing, wide_paths = phase_wide(torch, gen)
    kernels[-1].update(wide=wide_timing, wide_max_abs_err=max(
        wide_errs.values()))
    kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                     kernels[-1]["wide_max_abs_err"])
    # Serving after the OCR training paths, so that they run as before:
    # its four OCR captures left 128 MiB more allocated under main_gram.
    kept = {}
    serve_paths = {"serve": phase_serve(torch, ocr_model, data, keep=kept)}
    serve_paths["serve_obs"] = phase_serve_obs(torch, ocr_model, data,
                                               kept["served"])
    del ocr_model, kept
    serve_paths.update(phase_serve_specs(torch))
    torch.cuda.empty_cache()
    phase_parity_lm(torch)
    launches_lm, lm_paths = phase_main_lm(torch)
    torch.cuda.empty_cache()
    # LM training, the trainer's ssvm mode and the examples.
    train_paths = {"train_lm": phase_train_lm(torch)}
    train_paths["lm_grad"] = phase_lm_grad(torch)
    train_paths["lm_resume"] = phase_lm_resume(torch)
    torch.cuda.empty_cache()
    train_paths.update(phase_train_ssvm(torch))
    train_paths.update(phase_examples(torch))
    torch.cuda.empty_cache()
    # The rest of the transformer family, after every earlier path.
    mla_flash, mla_moe, mla_paths, s16_builds = phase_main_mla(torch)
    cfg_paths, cfg_builds = phase_lm_configs(torch)
    s16_builds.update(cfg_builds)
    torch.cuda.empty_cache()
    # The last three families: B5's new builds at their shapes, then the
    # models at published width and depth.
    mask_rows = check_flash_masks(torch, gen)
    family_paths = phase_main_hybrid(torch)
    torch.cuda.empty_cache()
    family_paths.update(phase_lm_xlstm(torch))
    family_paths.update(phase_lm_whisper(torch))
    torch.cuda.empty_cache()
    # This slice: B5's bf16-score builds, the host mesh, the dry-run.
    score_rows = check_flash_scores(torch, gen)
    for name, arch in (("causal_qwen2.5-14b", "qwen2.5-14b"),
                       ("mla_deepseek-v3", MLA_ARCH),
                       ("window_4096_zamba2", None)):
        row = score_rows[name]
        row["launches_path"] = (f"lm_score_bf16_{arch}" if arch
                                else "none: no model path here runs the "
                                "window at bf16 scores")
        row["launches"] = (s16_builds[arch].get(row["build"], 0) if arch
                           else 0)
    phase_host_mesh(torch)
    phase_dryrun(dryrun_runs)
    torch.cuda.empty_cache()
    # This slice: the dry-run's temporaries against the card.
    dryrun_paths = phase_dryrun_memory(torch)
    # Each new case's launches: its build's count on the path it serves.
    for name, path in (("causal_d112", "main_hybrid_prefill"),
                       ("window_4096", "main_hybrid_long"),
                       ("window_1000", "main_hybrid_long"),
                       ("window_1", "main_hybrid_long"),
                       ("bidirectional", "lm_whisper")):
        mask_rows[name]["launches_path"] = path
        mask_rows[name]["launches"] = family_paths[path]["builds"].get(
            mask_rows[name]["build"], 0)
    for k in kernels:
        if k["name"] == "flash_attention":
            k["mla_shape"] = mla_flash
            k["masks"] = mask_rows
            k["score_bf16"] = score_rows
            k["builds_by_path"] = {p: c["builds"]
                                   for p, c in family_paths.items()}
            for arch, row in k["lm_configs"].items():
                row["launches"] = cfg_paths[f"lm_configs_{arch}"][
                    "flash_attention"]
        elif k["name"] == "moe_ffn":
            k["deepseek"] = mla_moe
    # Each kernel's launches on the path it was ported for (B5's is now
    # the trainer's); every path's counts stand beside them.
    path_of = {"plane_scores": "main_gram", "viterbi_decode": "main",
               "plane_select": "main_async", "moe_ffn": "main_lm",
               "flash_attention": "train_lm", "gram": "main_gram",
               "approx_pass": "main"}
    by_path = {"main": launches, **obs_paths, "main_async": launches_async,
               "main_gram": launches_gram,
               "main_shard": launches_shard,
               "main_shard_tau": launches_shard_tau,
               "main_shard_gram": launches_shard_gram,
               "contracts": launches_contracts, **simple_paths,
               "main_gap": launches_gap, **wide_paths,
               **serve_paths, "main_lm": launches_lm, **lm_paths,
               **train_paths, **mla_paths, **cfg_paths, **family_paths,
               **dryrun_paths}
    for k in kernels:
        k["launches"] = by_path[path_of[k["name"]]][k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    emit("sync_debug", mode="error", dispatches_checked=dict(SYNC_CHECKED))
    print(json.dumps({"kernels": kernels}), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
