#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. environment: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, TF32 off; the CUDA kernels are built from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a; one line gives
   the registers, static shared memory and spills (``-Xptxas -v``) of the
   bf16-band fused_iter lanes' row-tile kernel at K = 2..8, which fails
   the run if it spills.
2. the DIA kernels against their plain PyTorch versions on the card, at
   the DIA path's shape (poisson125(128): N = 2,097,152, 125 diagonals)
   and at a ragged poisson27(37) (N = 50,653), padded and unpadded, with
   fused_iter also on a bf16 band (the JAX package's make_fused_iter_core(A,
   data_dtype=bfloat16)); kernel and plain-version times (median of
   CUDA-event timings), the bytes bound, and for spmv_dia a torch.sparse
   CSR matvec as a yardstick.
2b. the general-sparsity kernels: spmv_bell (f32 and bf16) at
   Queen_4147's Block-ELLPACK form (N = 4,147,110, R = 79, above the TPU
   kernel's 2M-row limit) and at the ragged bcsstk15 (N = 3,948), and
   fused_dots at N = 4,147,110 and 3,948 (f32 and bf16), against their
   plain versions; times, bounds, and yardsticks the port never calls
   (torch.mv on a torch.sparse CSR tensor, f32 and, where PyTorch takes
   it, bf16; three torch.dot calls).
3. solves of poisson125(128) through ``repro_torch.plan(A,
   method="pipecg", engine=..., M="jacobi")`` with b = A (1/sqrt(N)),
   atol 0, rtol 1e-3, for engine auto (-> fused_iter), cuda and torch:
   equal iteration counts, histories within rtol 1e-3, true residual
   (float64, scipy) below 1e-2, and the launch counters of each path;
   one spmv_engine="bf16" run is reported, not asserted; one solve through
   ``pipecg(A, b, core=make_fused_iter_core(A, data_dtype=torch.bfloat16))``
   is reported, its launches (2 f32 SPMVs at init, the bf16-band kernel
   every step) asserted.
3b. solves of Queen_4147 (b = A (1/sqrt(N)), atol 0, rtol 1e-3): pipecg
   on the Bell form (auto -> cuda core + spmv_bell, and torch), the CSR
   form (auto -> segsum) and the DIA form (auto -> fused_iter), pcg and
   chronopoulos on the Bell form: one pipecg iteration count, histories
   within rtol 1e-3, the baselines within 2 iterations of it, every true
   residual below 1e-2, the launch counters of each path. A bf16 pcg
   solve of the Bell form is reported, not asserted.
4. a fixed 200 iterations per engine on poisson125(128), median of 5, ms
   per iteration.
2c. fused_adam against its plain version, bit for bit, at a ragged
   n = 4,097 and at internlm2-1.8b's embedding (n = 189,530,112), p f32
   and bf16 (and bf16 p with f32 g at 4,097), nonzero m and v, steps 1
   and 10; one call timed at the embedding size and one whole-model pass
   (219 tensors, bf16 p and g, f32 m and v); torch.optim.AdamW(fused=True)
   on f32 parameters of the same sizes as a yardstick the port never
   calls.
2d. flash_attn against its plain version at (B, T, H, KV, hd) =
   (8, 512, 16, 8, 128) and (1, 4096, 16, 8, 128) in f32 and bf16, one
   non-causal Tk != Tq case, one 4:1 GQA case and stablelm-1.6b's
   (8, 512, 32, 32, 64) (f32 elementwise at 2e-5, bf16 per output row at
   1e-2 of its norm); two calls give equal bits; the bf16 entry's SASS
   must hold tensor-core instructions (HMMA or HGMMA, from cuobjdump); the
   bf16 kernel's per-row distance from an f32-probability result is
   printed; times and TFLOP/s of both entries at (8, 512, 16, 8, 128) and
   of bf16 at (1, 4096, 16, 8, 128), beside F.scaled_dot_product_attention
   as a yardstick and the operations bound. No path calls it.
4b. the same on Queen_4147 for Bell auto, CSR auto, DIA auto, pcg and
   chronopoulos, at the largest count up to 200 that every one of them
   completes (the f32 residual may reach its floor and stop a run early),
   and the marginal ms per iteration of that count's second half; then
   ms per solve to rtol 1e-3 on each path, median of 5.
6. the serving tier at full width, after 4b and before 5, on the
   poisson125(128) DIA operator and Queen_4147's Bell form built above:
   (a) the lane-batched entries (fused_iter at poisson125 with an f32
   band; fused_iter with a bf16 band and spmv_dia in f32 and in bf16 with
   f32 sums at poisson125, at a 200,003-row operator with isolated offsets
   over a span far wider than a window and at poisson125(144), whose
   z-planes take two windows at 8 f32 lanes; fused_vma at Queen's length,
   spmv_bell at Queen and at a 200,000-row Bell operator whose band is far
   wider than the kernel's window) at k = 1, 3 and 8 against their plain
   versions and, lane by lane, against the single-rhs kernel
   (the bf16 one: spmv_dia_cuda with an f32 output), with one inactive
   lane checked bit for bit untouched (an SPMV gives it 0); the script
   prints whether every active lane equals the single kernel bit for bit;
   times at k = 8 (the spmv_bell, fused_iter and spmv_dia lanes and the
   bf16-band fused_iter also at k = 2 and 4)
   beside the plain versions, cuSPARSE's SpMM (torch.sparse CSR @ dense,
   a yardstick the port never calls) and the bytes bound; (b)
   ``plan.solve_batched`` at a fixed 200 iterations (atol = rtol = 0) for
   k = 1, 2, 4, 8 on both operators (auto -> batched fused_iter; auto ->
   batched spmv_bell + fused_vma; no single-rhs kernel may launch), ms per
   batched iteration and per rhs-iteration beside the bound and the
   single solve; buckets of 8 at poisson125 on the "cuda" core in f32 and
   with spmv_engine="bf16" (one lane SPMV a step, launches asserted, ms per
   rhs-iteration); and a bucket of 8 on a spmv_engine="bf16" plan at
   poisson125 (replace_every 5, rtol 1e-2; its init SPMV the bf16 lane
   entry), each lane converged, with plan.solve's iterations and x within
   1e-5, and the lanes freezing at more than one iteration count; (c) one
   ``SolverServer`` (max_batch 8, max_wait_ms 5) fed 64 seeded requests
   per operator (scales over two decades, atol 1e-7 or 1e-6, rtol 1e-3):
   every answer has plan.solve's iteration count, x within 1e-5 relative
   and a float64 true residual below 1e-2; requests/s, p50/p99 latency,
   bucket occupancy, and trace_count 2 per plan; (d) a warm start:
   ``save_manifest`` with builder recipes (poisson125 n=128; a Bell
   builder over table1 Queen_4147, registered here), then
   ``SolverServer.from_manifest`` onto the same pool keys, whose first
   requests build no runner.
5. training through the fused optimizer: (a) the launcher
   ``repro_torch.launch.train.main`` at the reduced internlm2-1.8b config
   for 30 steps with checkpoints, then resumed to 40; (b) the full-size
   internlm2-1.8b (24 layers, bf16) through init_train_state ->
   make_train_step -> batch_for_step (batch 8, seq 512), clip 1.0,
   warmup_cosine (peak lr 6e-4), 20 steps: finite losses, the step-0
   loss within 0.5 of ln V, the last five step losses below the first
   five on average, and a lower mean loss than at init on five held-out
   batches (20-24, never trained on); the initial model's loss on every
   batch 0-24 is recorded beside the step losses; 219 fused_adam
   launches per step, ms per step, tokens/s, the optimizer's ms beside
   its bound, peak memory; (c) 5 steps from the same init with the plain
   (tree) optimizer, held against (b).
7. the paper's hybrid methods on the card and the host's cores, after 5:
   (a) ``plan(A, method="h3", shards=1)`` on the card at poisson125(128):
   the iterations of ``plan(A, engine="cuda").solve(b)``, x within 1e-5,
   spmv_dia and fused_vma launched; (b) the paper's Method 3: h3 on
   ("cuda", "cpu"), ``partition="nnz"`` with weights from
   ``measure_spmv_time`` on each device, each timing its shard's own SPMV
   (the host's raised, if the model gives it fewer rows than the halo
   width, to the least that holds it; both printed), at poisson125(128):
   the model's prediction for each shard's block beside the block's SPMV
   timed alone and the shard's compute per step in the solve; iterations
   against the single card (within 2), the float64 true residual below
   1e-2, ms per iteration and per step, each shard's loop, compute and
   wait ms by collective kind, one reduction per iteration, the card's
   idle share from torch.profiler over one more solve, and ``spmv_dia`` on
   the card shard's operands (its local band and both one-sided
   correction bands) held against the plain SPMV at the kernels
   line's tolerance; (c) h1, h2, pl2, pl3 on ("cuda",
   "cpu") with equal rows and h4 on 4 shards (sub=2) at poisson125(64):
   reductions per iteration 3, 1, 0.5, 1/3 and 2 from the communicator's
   counters, each converged (true residual below 1e-2) within 2
   iterations of the single card; (d) ``solve_batched`` with k = 4 on a
   hybrid h3 plan at poisson125(64): each lane has its ``plan.solve``
   iterations and x within 1e-6, the lane kernels launched, and
   ``spmv_dia_batched`` (one lane inactive) on the card shard's operands
   against the plain SPMV, as in (b); (e) the
   ``SolveReport`` of one Method 3 solve, whose environment names the card
   and its power limit. The kernels line gives spmv_dia, fused_vma and
   their lane entries a ``hybrid_launches`` count from (b) and (d).
8. LM serving at full width, after 7, through ``repro_torch.serve.generate``
   and ``build_model(cfg)``'s ``prefill``, ``init_cache`` and ``decode``:
   internlm2-1.8b and olmoe-1b-7b in bf16 from seeded random weights,
   batch 8 x 512-token seeded prompts, 64 greedy tokens. Each model:
   two ``generate`` calls give equal tokens; prefill ms, the median ms per
   decode step (CUDA events), decode tokens/s and peak memory, beside the
   step's bytes bound (``launch.serve_lm.decode_step_bytes`` at
   ``launch/roofline.py``'s HBM rate); torch.profiler over 4 decode steps
   (kernel time by class, the card's idle share). internlm2-1.8b: a
   496-token prefill, then the last 16 prompt tokens teacher-forced
   through ``decode``, within 5e-2 per row (||d|| / ||ref||) of the full
   forward's logits. olmoe-1b-7b: finite logits; then a 2-layer olmoe at
   full width in f32 on a (2, 32) prompt with 8 new tokens: the card's
   greedy tokens equal the host CPU's, logits within 1e-4 per row. No
   kernel of the port lies on this path (in the JAX package either): the
   phase fails if one launches.
9. SSM and hybrid serving at full width, after 8, through the same entry
   points: zamba2-2.7b (54 Mamba-2 blocks, one shared attention block
   applied 9 times) and xlstm-1.3b (42 mLSTM + 6 sLSTM blocks) in bf16
   from seeded random weights, phase 8's traffic (batch 8 x 512-token
   prompts, 64 greedy tokens). Each model: two ``generate`` calls give
   equal tokens; prefill ms, ms per decode step, tokens/s and peak memory
   beside ``decode_step_bytes``'s bound (the recurrent states read and
   written once); torch.profiler over 4 decode steps (kernel time by
   class, launches per step, the idle share); a 256-token prefill (one
   chunk), then positions 256-271 teacher-forced through ``decode``,
   within 5e-2 per row of the full forward's logits with the weights in
   f32 (TF32 off). In bf16 these random-weight models lie above that
   limit from their own f32 forward at full depth (0.14 and 1.1 per row),
   so the bf16 teacher-forced decode is held to BF16_FLOOR (1.5) x that
   distance, both from the f32 forward and from the bf16 forward. Then
   one group of each at full width in f32 (zamba2 with 6 Mamba blocks and
   the shared block, xlstm with 7 mLSTM and 1 sLSTM) on (2, 256) prompts
   of 3 seeds with 8 new tokens: the card's greedy tokens equal the host
   CPU's, logits within 1e-4 per row (xlstm: 1e-3, F32_ROW_XLSTM). No
   kernel of the port lies on this path either: the phase fails if one
   launches.
10. training at full width, after 9, through ``make_train_step`` and the
   fused optimizer (lr 6e-4, constant): xlstm-1.3b and zamba2-2.7b in bf16
   with ``remat=True``, 4 steps from batch 8 x 512, the batch halved until
   a step fits (the batch is printed); whisper-tiny in bf16, 20 steps at
   batch 8 x 448 decoder tokens x 1,500 stub frames. Each: ms a step (the
   median of steps 1 on), tokens/s, peak memory, fused_adam launches a
   step (one per tensor); the step-0 loss within 0.25 of ln V + 0.5 (the
   loss of unit-variance random logits), every grad norm finite, batch
   0's loss lower after the steps (whisper: also the last five step
   losses below the first five). llama-3.2-vision-11b trains at its
   reduced config only, in f32 (gates 0.5, ``remat="save_collectives"``):
   3 steps on the card and the host, losses and grad norms within 1e-5
   relative; at full width AdamW needs ~12 bytes a parameter, 117 GB.
   The three remat modes on internlm2-1.8b at full width and 4 layers:
   equal loss, grad norms within 1e-6, peak memory ordered False >=
   ``save_collectives`` >= True.
11. encdec and VLM serving at full width, after 10, through ``generate``:
   whisper-tiny (batch 8, 1,500 stub frames, 64-token prompts) and
   llama-3.2-vision-11b (batch 8, 512-token prompts, 1,601 stub image
   tokens, every cross gate 0.5) in bf16 from seeded random weights, 64
   greedy tokens; phase 8's figures, beside ``decode_step_bytes``'s bound
   and the VLM's cross K/V FLOP bound (``decode_step_cross_flops``);
   teacher-forced decode of the prompt's last 16 positions within 5e-2
   per row of the full forward (where the bf16 forward itself lies
   farther from its f32 forward, the gate runs in f32 and bf16 is held to
   BF16_FLOOR x that distance, as in 9); whisper-tiny at full width and
   one VLM group (4 self + 1 cross, gates 0.5) in f32 on (2, 32) prompts:
   the card's greedy tokens equal the host's, logits within 1e-4 per row.
   No kernel of the port lies on these paths: the phase fails if one
   launches.
12. the dry-run tools, after 11: (a) ``launch.dryrun.run_cell`` for the
   10 configs x 4 shapes x both production meshes (meta device): every
   cell ok or the quadratic long_500k skip, whisper-tiny train_4k logs
   its vocab fallback, argument GiB per device and the analytic bound per
   cell to chip_smoke.json; (b) internlm2-1.8b in bf16 at full width:
   ``abstract_params()`` bytes equal the growth of the allocator's
   requested bytes (``torch.cuda.memory_stats()``) across ``init_params``
   exactly, and ``abstract_train_state``'s that across
   ``init_train_state``; the growth of ``memory_allocated()`` is printed
   beside them (blocks: 512-byte rounding, and a cached block handed over
   whole where a split would leave 1 MiB or less); (c)
   ``FlopCounterMode`` over that model's forward at (1, 512) within 2% of
   ``analytic_flops``, the count / analytic ratio of one reduced model of
   each other family (no gate), and ``analytic_hbm_bytes`` of phase 8's
   decode steps beside ``decode_step_bytes`` and the measured ms; (d)
   ``moe_ffn_sharded`` on a (data 2, model 4) mesh of 8 shards on the one
   card (a 2-layer olmoe-1b-7b at full width in f32, no-drop capacity,
   (4, 128) tokens): logits within 1e-4 per row of the unsharded forward,
   aux within 1e-6 (relative) of the mean over the data shards of the
   unsharded aux on each shard's tokens, one ``model`` all-reduce and one
   aux all-reduce a layer, both forwards' ms (one card: no speed-up). No
   kernel of the port lies on (a)-(d): the phase fails if one launches.
   (e) the sharded MoE's backward on that mesh: every parameter's
   gradient of the whole batch's nll + 0.01 x aux within 1e-5 per tensor
   of the unsharded loss's (aux there the mean over the data shards of
   each shard's rows' aux), the backward's all-reduces by tag (grad_x,
   grad_router, 3 grad_experts a layer), both backwards' ms (no gate),
   and three fused-optimizer remat steps under the mesh: losses finite and
   falling, fused_adam once a tensor a step. (f) the traced census
   against the card: ``launch.roofline.analyze_program`` over the dry
   run's internlm2-1.8b train step at 8 x 512 on meta, then the same step
   on the card under ``FlopCounterMode``: FLOPs equal, the growth of the
   allocator's requested-bytes peak 0 to PEAK_TOL above the traced peak
   of live storages; the step's ms against the traced bound (no gate);
   one traced cell of each program kind on the 16 x 16 meta mesh (olmoe
   train_4k with the sharded MoE at 2 layers: its regions' tags count 9
   all-reduces a layer), each counted at one device's share (per-device
   FLOPs, HBM, temp and argument bytes, collectives by kind), with
   trace_s beside the global count's recorded times (TRACE_S_GLOBAL) and
   beside the same program traced in this run as the global count (no
   placements; the best of 3 turns each on the two short cells), no gate.

The last lines are the kernels JSON, the card line, and
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

VEC = dict(rtol=1e-5, atol=1e-5)   # f32 vectors (tests/test_kernels.py)
DOT_RTOL = 1e-4                    # dots; atol 1e-6 * sum|a_i b_i| (f32 sums, another order)
BF16 = dict(rtol=2e-2, atol=1e-3)  # bf16 SPMV
BF16_DOT_RTOL = 1e-3               # f32 sums of the same (exact) bf16 products
SOLVE_RTOL = 1e-3                  # f32 Jacobi-PIPECG stalls near 1e-4 on poisson125
TIMED_ITERS = 200
# fused_adam: p, m and v equal to the plain version's bit for bit (the
# kernel uses IEEE _rn intrinsics in the plain version's order)
ATTN_F32 = 2e-5                          # rtol = atol (tests/test_kernels.py)
# flash_attn bf16: the largest ||got - ref|| / ||ref|| over the hd entries
# of one output row. The plain version rounds the normalised probabilities
# to bf16 before the product with v, the kernel the unnormalised ones
# (dividing at the end), which moves a row by a few 1e-3 of its norm; an
# elementwise atol would have to be as large as the late causal rows
# (|o| ~ sqrt(e / (i + 1))) to pass that
ATTN_BF16_ROW = 1e-2
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 20, 8, 512
# peak lr and warmup of the full-size run: at 1.5e-3 the step losses
# spike above their batches' initial losses; from 1e-3 down to 1.5e-4
# they fall (python -m repro_torch.launch.lr_sweep, PERF.md)
TRAIN_LR, TRAIN_WARMUP = 6e-4, 10
PLAIN_STEPS = 5
# fused vs plain optimizer: the same math, the f32 constants (1 - b1) and
# (1 - b2) rounded once in f32 (kernel) or from double (plain), so m and
# v differ by a few ulp and flip bf16 roundings of a few parameters; that
# moves a loss of ~11.4 by far less than this
PLAIN_LOSS_ATOL = 1e-2
# LM serving (phase 8): batch 8 x 512-token prompts, 64 greedy tokens
LM_BATCH, LM_PROMPT, LM_NEW = 8, 512, 64
# positions decoded teacher-forced: internlm2-1.8b the prompt's last 16;
# zamba2-2.7b and xlstm-1.3b the 16 after their first chunk (256)
TF_STEPS = 16
PROF_STEPS = 4  # decode steps under torch.profiler, per model
# bf16 teacher-forced decode against the full forward, largest per-row
# ||d|| / ||ref|| over the vocabulary: the two paths round to bf16 after
# differently shaped products (8 rows against 4,096; the cache's softmax
# split from the current token's column), which moves a row of logits by
# about a bf16 ulp per layer; a wrong position or mask moves it by O(1)
TF_ROW = 5e-2
# the cut f32 models (a 2-layer olmoe, one group of zamba2 and of xlstm) on
# the card against the host (TF32 off): the same f32 math summed in
# another order. olmoe and zamba2 read up to 1.9e-5. The xlstm group
# carries that rounding through 8 layers of gates: 9.5e-5 to 1.3e-4 over
# prompt seeds 2-7 (launch.precision), and the host against itself on 1
# thread against 8 already 4.7e-5; its limit sits 8x above the largest
# sound reading, far below a fault's O(1)
F32_ROW = 1e-4
F32_ROW_XLSTM = 1e-3
# prompt seeds of the one-group SSM and hybrid checks
CARD_HOST_SEEDS = (2, 3, 4)
# phase 9, bf16 at full depth: random-weight models whose bf16 forward
# lies 0.14 (zamba2) and 1.1 (xlstm) per row from their own f32 forward.
# The bf16 teacher-forced decode must lie no farther from the f32 forward,
# nor from the bf16 forward, than BF16_FLOOR x that distance (readings:
# 1.01x and 0.71x for zamba2, 1.00x and 0.34x for xlstm)
BF16_FLOOR = 1.5
# phase 10, training at full width through the fused optimizer at a
# constant lr (warmup_cosine's is 0 at step 0): xlstm-1.3b and zamba2-2.7b
# with remat, 4 steps from batch 8 x 512, halved until a step fits;
# whisper-tiny 20 steps at batch 8 x 448 decoder tokens (Whisper's limit)
FAM_STEPS, FAM_BATCH, FAM_SEQ, FAM_LR = 4, 8, 512, 6e-4
WHISPER_STEPS, WHISPER_SEQ = 20, 448
# the step-0 loss: a unit-RMS final norm and a head of std 1/sqrt(d) give
# logits of variance ~1, so the expected loss is ln V + 1/2, not ln V
# (one group of each at full width on the host, seeded init: +0.59 xlstm,
# +0.51 zamba2 and whisper, +0.44 internlm2)
STEP0_EXCESS, STEP0_TOL = 0.5, 0.25
# the reduced f32 VLM, card against host: losses and grad norms (relative)
VLM_REL = 1e-5
# phase 11: whisper-tiny takes 64-token prompts (a transcription batch);
# the VLM phase 8's 512. Every cross gate 0.5: at its zero init a cross
# layer adds nothing, and a wrong cross-attention would pass
WHISPER_PROMPT, VLM_GATE = 64, 0.5
# phase 12e: the sharded MoE's gradients against the unsharded loss's,
# ||d|| / ||ref|| per tensor (f32, TF32 off; 12d's forward gate), and the
# train step's load-balance weight (TrainConfig.aux_weight)
GRAD_ROW, MOE_AUX_WEIGHT = 1e-5, 0.01
# phase 12f: the card's requested-bytes peak may exceed the traced peak of
# live storages by cuBLAS/cuBLASLt workspace on a handle's first GEMM and
# kernels' scratch (reduction staging, the embedding backward's sort),
# never fall below it: the same aten ops allocate the same storages
PEAK_TOL = 64 * 2**20
OLMOE_TRACED_GROUPS = 2  # layers of the traced sharded olmoe cell (of 16)
# 12f's traced cells' trace_s as the global count (no placements), recorded on the card's
# host before the census counted one device's share
TRACE_S_GLOBAL = {"olmoe-1b-7b_train_4k": 23.64, "qwen3-8b_prefill_32k": 0.59,
                "internlm2-1.8b_decode_32k": 0.40}
BASELINE_BAND = 2                  # pcg/chronopoulos vs pipecg iterations (tests/test_solvers.py)
REPLACES = {
    "spmv_dia": "src/repro/kernels/spmv_dia/kernel.py:37",
    "fused_vma": "src/repro/kernels/fused_vma/kernel.py:71",
    "fused_iter": "src/repro/kernels/fused_iter/kernel.py:95",
    "spmv_bell": "src/repro/kernels/spmv_bell/kernel.py:30",
    "fused_dots": "src/repro/kernels/fused_dot/kernel.py:27",
    "fused_adam": "src/repro/kernels/fused_adam/kernel.py:34",
    "flash_attn": "src/repro/kernels/flash_attn/kernel.py:65",
}
SOURCES = {
    "spmv_dia": "src/repro_torch/kernels/csrc/spmv_dia.cu",
    "fused_vma": "src/repro_torch/kernels/csrc/fused_vma.cu",
    "fused_iter": "src/repro_torch/kernels/csrc/fused_iter.cu",
    "spmv_bell": "src/repro_torch/kernels/csrc/spmv_bell.cu",
    "fused_dots": "src/repro_torch/kernels/csrc/fused_dot.cu",
    "fused_adam": "src/repro_torch/kernels/csrc/fused_adam.cu",
    "flash_attn": "src/repro_torch/kernels/csrc/flash_attn.cu",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_rates(name: str):
    """(bytes/s, f32 flop/s, dense bf16 tensor flop/s) from the data
    sheets, by the card's name."""
    if "H100" in name and "PCIe" in name:
        return 2.0e12, 51e12, 756e12
    if "H100" in name and "NVL" in name:
        return 3.9e12, 60e12, 835e12
    if "H200" in name:
        return 4.8e12, 67e12, 989e12
    return 3.35e12, 67e12, 989e12  # H100 SXM


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"the port's package is not at {SRC}/repro_torch")
    sys.path.insert(0, SRC)
    import numpy as np

    import repro_torch
    from repro_torch.kernels import (
        adamw_hyper,
        flash_attention,
        flash_attention_ref,
        fused_adamw,
        fused_adamw_ref,
        fused_dots,
        fused_dots_ref,
        fused_iter_ref,
        fused_iter_step,
        fused_vma_dots,
        fused_vma_dots_ref,
        spmv_bell_cuda,
        spmv_bell_ref,
        spmv_dia_cuda,
        spmv_dia_ref,
    )
    from repro_torch.kernels.common import BLOCK, build_info, ceil_to, library, pad1d
    from repro_torch.sparse import (
        DIAMatrix,
        bell_from_csr,
        csr_device_from_host,
        csr_from_dia,
        poisson27,
        poisson125,
        spmv,
        table1_matrix,
    )

    dev = torch.device("cuda")
    record: dict = {}

    # ------------------------------------------------------------------ 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    if not card:
        fail(f"nvidia-smi gave no card line: {smi.stderr.strip()}")
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {name}, "
        f"capability {torch.cuda.get_device_capability(0)}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    library()
    info = build_info()
    log(f"kernel library: {info['path']} built in {info['seconds']:.1f} s (cached={info['cached']})")
    entry = ""  # ptxas names each kernel before its registers and spills
    ptxas: dict = {}  # kernel -> registers, static smem bytes, spill bytes
    for line in info["log"].splitlines():
        if "Compiling entry function" in line and "'" in line:
            entry = line.split("'")[1]
        elif line.startswith("=="):
            log(f"  nvcc: {line.strip()}")
        elif "registers" in line or "spill" in line:
            log(f"  nvcc: {entry}: {line.strip()}")
            for key, pat in (("registers", r"Used (\d+) registers"), ("smem", r"(\d+) bytes smem"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
                m = re.search(pat, line)
                if m:
                    ptxas.setdefault(entry, {})[key] = int(m.group(1))
    # the bf16-band fused_iter lanes' row-tile kernel, one instance a lane count
    tile_ptxas = {int(re.search(r"ILi(\d+)E", e).group(1)): st for e, st in ptxas.items()
                  if "fused_iter_tile_kernel" in e}
    if sorted(tile_ptxas) != list(range(2, 9)):
        fail(f"ptxas reported fused_iter_tile_kernel for lanes {sorted(tile_ptxas)}, not 2-8")
    log("fused_iter_tile_kernel (bf16-band lanes) ptxas: " + "; ".join(
        f"K={k_}: {st.get('registers')} registers, {st.get('smem')} B static smem, spills "
        f"{st.get('spill_stores')} B stored / {st.get('spill_loads')} B loaded"
        for k_, st in sorted(tile_ptxas.items())))
    if any(st.get("spill_stores", 0) or st.get("spill_loads", 0) for st in tile_ptxas.values()):
        fail("fused_iter_tile_kernel spills registers")
    bw_peak, f32_peak, bf16_peak = peak_rates(name)
    record.update(card=card, device=name, torch=torch.__version__, cuda=torch.version.cuda,
                  build_seconds=info["seconds"], fused_iter_tile_ptxas=tile_ptxas,
                  peak_bytes_per_s=bw_peak, peak_f32_flops=f32_peak, peak_bf16_flops=bf16_peak)

    def sync():
        torch.cuda.synchronize()

    def timed(fn, reps: int, repeats: int = 5) -> float:
        """Median over ``repeats`` of the mean ms of ``reps`` calls (CUDA events)."""
        fn()
        sync()
        out = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / reps)
        return statistics.median(out)

    def check(label, got, want, rtol, atol) -> float:
        err = float((got.double() - want.double()).abs().max())
        if not torch.allclose(got.double(), want.double(), rtol=rtol, atol=atol):
            fail(f"{label}: kernel and plain version disagree (max abs err {err:.3e})")
        return err

    def check_rows(label, got, want, limit) -> float:
        """Fails where an output row (last axis) differs from ``want`` by
        more than ``limit`` of its norm; returns the max abs err."""
        d = got.double() - want.double()
        rel = float((d.norm(dim=-1) / want.double().norm(dim=-1).clamp_min(1e-30)).max())
        if not rel <= limit:
            fail(f"{label}: kernel and plain version disagree (row-relative err {rel:.3e} "
                 f"> {limit:.0e})")
        log(f"  {label}: row-relative err {rel:.3e}")
        return float(d.abs().max())

    def check_dots(label, got, want, scale) -> float:
        err = float((got.double() - want.double()).abs().max())
        if not torch.allclose(got.double(), want.double(), rtol=DOT_RTOL, atol=1e-6 * scale):
            fail(f"{label}: dots disagree: {got.tolist()} vs {want.tolist()}")
        return err

    # ------------------------------------------------------------------ 2
    t0 = time.perf_counter()
    A = poisson125(128, device=dev)
    log(f"poisson125(128): N={A.n} diagonals={A.n_diags} bandwidth={A.bandwidth} "
        f"built in {time.perf_counter() - t0:.1f} s")
    A27 = poisson27(37, device=dev)
    N = A.n
    k = A.n_diags
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(n):
        return torch.randn(n, generator=gen, device=dev)

    errs = {"spmv_dia": 0.0, "spmv_dia_bf16": 0.0, "fused_vma": 0.0, "fused_iter": 0.0,
            "fused_iter_bf16band": 0.0}

    def operator_cases(Aop):
        """(label, operator, length) — as given, and padded to the block."""
        cases = [("", Aop, Aop.n)]
        n_pad = ceil_to(Aop.n, BLOCK)
        if n_pad != Aop.n:
            dp = torch.nn.functional.pad(Aop.data, (0, n_pad - Aop.n)).contiguous()
            cases.append(("padded", DIAMatrix(dp, Aop.offsets, n_pad), Aop.n))
        return cases

    for tag, Aop in (("poisson125(128)", A), ("poisson27(37)", A27)):
        for pad_tag, Ak, n_real in operator_cases(Aop):
            label = f"{tag}{' ' + pad_tag if pad_tag else ''}"
            n = Ak.n
            x = pad1d(randn(n_real), n)
            y = spmv_dia_cuda(Ak, x)
            errs["spmv_dia"] = max(errs["spmv_dia"], check(
                f"spmv_dia {label}", y, spmv_dia_ref(Ak.data, Ak.offsets, x), **VEC))
            A16, x16 = Ak.with_dtype(torch.bfloat16), x.to(torch.bfloat16)
            y16 = spmv_dia_cuda(A16, x16, out_dtype=torch.float32)
            errs["spmv_dia_bf16"] = max(errs["spmv_dia_bf16"], check(
                f"spmv_dia bf16 {label}", y16,
                spmv_dia_ref(A16.data, Ak.offsets, x16, torch.float32), **BF16))

            vecs = [pad1d(randn(n_real), n) for _ in range(10)]
            inv = pad1d(1.0 / Ak.diagonal()[:n_real], n)
            want = fused_vma_dots_ref(*vecs, inv, 0.3, 0.6)
            got = fused_vma_dots(*[v.clone() for v in vecs], inv, 0.3, 0.6)
            for g, w in zip(got[:9], want[:9]):
                errs["fused_vma"] = max(errs["fused_vma"], check(f"fused_vma {label}", g, w, **VEC))
            scale = float(torch.stack([(want[5] * want[6]).abs().sum(),
                                       (want[7] * want[6]).abs().sum(),
                                       (want[6] * want[6]).sum()]).max())
            check_dots(f"fused_vma {label}", got[9], want[9], scale)

            vecs = vecs[:9]
            want = fused_iter_ref(Ak.data, Ak.offsets, *vecs, inv, 0.3, 0.6)
            m_out = torch.empty_like(vecs[8])
            got = fused_iter_step(Ak.data, Ak.offsets, *[v.clone() for v in vecs[:8]], vecs[8],
                                  m_out, inv, 0.3, 0.6)
            for g, w in zip(got[:9], want[:9]):
                errs["fused_iter"] = max(errs["fused_iter"], check(f"fused_iter {label}", g, w, **VEC))
            scale = float(torch.stack([(want[5] * want[6]).abs().sum(),
                                       (want[7] * want[6]).abs().sum(),
                                       (want[6] * want[6]).sum()]).max())
            check_dots(f"fused_iter {label}", got[9], torch.stack(list(want[9])), scale)
            # the bf16-band instance: the same vectors, the band stored in bf16
            want16 = fused_iter_ref(A16.data, Ak.offsets, *vecs, inv, 0.3, 0.6)
            got16 = fused_iter_step(A16.data, Ak.offsets, *[v.clone() for v in vecs[:8]], vecs[8],
                                    torch.empty_like(vecs[8]), inv, 0.3, 0.6)
            for g, w in zip(got16[:9], want16[:9]):
                errs["fused_iter_bf16band"] = max(errs["fused_iter_bf16band"], check(
                    f"fused_iter bf16 band {label}", g, w, **VEC))
            check_dots(f"fused_iter bf16 band {label}", got16[9], torch.stack(list(want16[9])),
                       scale)
            if n != n_real:
                for out in (y, y16, *got[:9], *got16[:9]):
                    if out[n_real:].any():
                        fail(f"{label}: the padded tail is not exactly 0")
            sync()
            log(f"kernels agree with their plain versions on {label} (N={n})")
    log("max abs err: " + json.dumps(errs))

    # kernel and plain-version times at the main path's shape
    x = randn(N)
    vecs = [randn(N) * 1e-3 for _ in range(10)]
    inv = 1.0 / A.diagonal()
    m_out = torch.empty_like(vecs[8])
    a_s = torch.tensor(1e-3, device=dev)
    b_s = torch.tensor(1e-3, device=dev)
    A16, x16 = A.with_dtype(torch.bfloat16), x.to(torch.bfloat16)
    times = {
        "spmv_dia": (timed(lambda: spmv_dia_cuda(A, x), 20),
                     timed(lambda: spmv_dia_ref(A.data, A.offsets, x), 2, 3)),
        "spmv_dia_bf16": (timed(lambda: spmv_dia_cuda(A16, x16, out_dtype=torch.float32), 20),
                          timed(lambda: spmv_dia_ref(A16.data, A.offsets, x16, torch.float32), 2, 3)),
        "fused_vma": (timed(lambda: fused_vma_dots(*vecs, inv, a_s, b_s), 50),
                      timed(lambda: fused_vma_dots_ref(*vecs, inv, a_s, b_s), 5, 3)),
        "fused_iter": (timed(lambda: fused_iter_step(A.data, A.offsets, *vecs[:9], m_out, inv,
                                                     a_s, b_s), 20),
                       timed(lambda: fused_iter_ref(A.data, A.offsets, *vecs[:9], inv, a_s, b_s),
                             2, 3)),
    }
    times["fused_iter_bf16band"] = (
        timed(lambda: fused_iter_step(A16.data, A.offsets, *vecs[:9], m_out, inv, a_s, b_s), 20),
        timed(lambda: fused_iter_ref(A16.data, A.offsets, *vecs[:9], inv, a_s, b_s), 2, 3))
    del A16, x16

    # torch.sparse CSR matvec of the same operator: a yardstick the port never calls
    offs = torch.tensor(A.offsets, device=dev)
    cols = torch.arange(N, device=dev)[:, None] + offs[None, :]
    valid = (cols >= 0) & (cols < N)
    crow = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(valid.sum(1), 0)
    csr = torch.sparse_csr_tensor(crow, cols[valid], A.data.t()[valid], size=(N, N),
                                  check_invariants=False)
    del cols, valid
    check("torch.sparse CSR yardstick", torch.mv(csr, x), spmv_dia_cuda(A, x), **VEC)
    library = {"spmv_dia": timed(lambda: torch.mv(csr, x), 20)}
    nnz = csr.values().numel()
    del csr, crow
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- 2b
    t0 = time.perf_counter()
    Q = table1_matrix("Queen_4147", device=dev)
    t_gen = time.perf_counter() - t0
    qcsr = csr_from_dia(Q)
    QB = bell_from_csr(qcsr, device=dev)
    QC = csr_device_from_host(qcsr, device=dev)
    sync()
    QN, R = QB.n, QB.slots_per_row
    log(f"Queen_4147: N={QN} diagonals={Q.n_diags} bandwidth={Q.bandwidth} nnz={qcsr.nnz} "
        f"R={R}; generated in {t_gen:.1f} s, converted (CSR, Bell, device CSR) in "
        f"{time.perf_counter() - t0 - t_gen:.1f} s")
    if QN <= 2 * 1024 * 1024 or qcsr.nnz != Q.nnz():
        fail(f"Queen_4147 is not the full operator (N={QN}, nnz={qcsr.nnz})")
    BK = bell_from_csr(csr_from_dia(table1_matrix("bcsstk15", device=dev)), device=dev)
    errs.update(spmv_bell=0.0, spmv_bell_bf16=0.0, fused_dots=0.0)
    for label, B in (("Queen_4147", QB), ("bcsstk15", BK)):
        x = randn(B.n)
        before = spmv_bell_cuda.launches
        y = spmv_bell_cuda(B, x)
        errs["spmv_bell"] = max(errs["spmv_bell"], check(
            f"spmv_bell {label}", y, spmv_bell_ref(B.cols, B.vals, x), **VEC))
        B16, x16 = B.with_dtype(torch.bfloat16), x.to(torch.bfloat16)
        y16 = spmv_bell_cuda(B16, x16)
        errs["spmv_bell_bf16"] = max(errs["spmv_bell_bf16"], check(
            f"spmv_bell bf16 {label}", y16, spmv_bell_ref(B16.cols, B16.vals, x16), **BF16))
        sync()
        if spmv_bell_cuda.launches != before + 2:
            fail(f"spmv_bell {label}: {spmv_bell_cuda.launches - before} launches, not 2")
        log(f"spmv_bell (f32, bf16) agrees with its plain version on {label} "
            f"(N={B.n}, R={B.slots_per_row}) and launched there")
        del B16, x16
    for n in (QN, BK.n):
        r, u, w = randn(n), randn(n), randn(n)
        before = fused_dots.launches
        got = fused_dots(r, u, w)
        scale = float(torch.stack([(r * u).abs().sum(), (w * u).abs().sum(), (u * u).sum()]).max())
        errs["fused_dots"] = max(errs["fused_dots"], check_dots(
            f"fused_dots N={n}", got, fused_dots_ref(r, u, w), scale))
        h = [v.to(torch.bfloat16) for v in (r, u, w)]
        got16, want16 = fused_dots(*h), fused_dots_ref(*h)
        if not torch.allclose(got16.double(), want16.double(), rtol=BF16_DOT_RTOL,
                              atol=1e-6 * scale):
            fail(f"fused_dots bf16 N={n}: {got16.tolist()} vs {want16.tolist()}")
        sync()
        if fused_dots.launches != before + 2:
            fail(f"fused_dots N={n}: {fused_dots.launches - before} launches, not 2")
        log(f"fused_dots (f32, bf16) agrees with its plain version at N={n}")
    del BK
    log("max abs err: " + json.dumps(errs))

    # kernel and plain-version times at Queen_4147's shape
    x = randn(QN)
    QB16, xq16 = QB.with_dtype(torch.bfloat16), x.to(torch.bfloat16)
    r, u, w = randn(QN), randn(QN), randn(QN)
    times.update({
        "spmv_bell": (timed(lambda: spmv_bell_cuda(QB, x), 20),
                      timed(lambda: spmv_bell_ref(QB.cols, QB.vals, x), 2, 3)),
        "spmv_bell_bf16": (timed(lambda: spmv_bell_cuda(QB16, xq16), 20),
                           timed(lambda: spmv_bell_ref(QB16.cols, QB16.vals, xq16), 2, 3)),
        "fused_dots": (timed(lambda: fused_dots(r, u, w), 50),
                       timed(lambda: fused_dots_ref(r, u, w), 5, 3)),
    })
    queen_dia_ms = timed(lambda: spmv_dia_cuda(Q, x), 20)
    # yardsticks the port never calls: cuSPARSE through torch.mv on the same
    # operator; no single PyTorch call computes the three dots
    qcsr_t = torch.sparse_csr_tensor(
        torch.from_numpy(qcsr.indptr).to(dev), torch.from_numpy(qcsr.indices).to(dev),
        torch.from_numpy(qcsr.data).to(dev), size=(QN, QN), check_invariants=False)
    check("torch.sparse CSR yardstick (Queen_4147)", torch.mv(qcsr_t, x), spmv_bell_cuda(QB, x),
          **VEC)
    library["spmv_bell"] = timed(lambda: torch.mv(qcsr_t, x), 20)
    # the same yardstick in bf16, where this PyTorch build takes it
    qcsr_t16 = torch.sparse_csr_tensor(qcsr_t.crow_indices(), qcsr_t.col_indices(),
                                       qcsr_t.values().to(torch.bfloat16), size=(QN, QN),
                                       check_invariants=False)
    del qcsr_t
    try:
        y_lib16 = torch.mv(qcsr_t16, xq16)
        sync()
    except (RuntimeError, NotImplementedError) as exc:  # no bf16 sparse matvec here
        record["library_bf16_refused"] = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
        log(f"torch.mv on a bf16 sparse CSR tensor: refused ({record['library_bf16_refused']})")
    else:
        # a yardstick only: its accumulation order and type are cuSPARSE's,
        # so it may differ from the kernel by a bf16 rounding step of y
        y16 = spmv_bell_cuda(QB16, xq16).double()
        record["library_bf16_max_abs_err"] = float((y_lib16.double() - y16).abs().max())
        record["library_bf16_max_abs_y"] = float(y16.abs().max())
        library["spmv_bell_bf16"] = timed(lambda: torch.mv(qcsr_t16, xq16), 20)
        log(f"torch.mv on a bf16 sparse CSR tensor: {library['spmv_bell_bf16']:.4f} ms, max abs "
            f"diff from spmv_bell bf16 {record['library_bf16_max_abs_err']:.3e} "
            f"(max |y| {record['library_bf16_max_abs_y']:.3e})")
        del y16
        del y_lib16
    three_dots_ms = timed(lambda: (torch.dot(r, u), torch.dot(w, u), torch.dot(u, u)), 50)
    del qcsr_t16, QB16, xq16, r, u, w
    torch.cuda.empty_cache()

    # least bytes each kernel must move at its shape (inputs read once,
    # outputs written once) and the f32 operations it does: the DIA
    # kernels at poisson125(128), the general-sparsity ones at Queen_4147
    work = {
        "spmv_dia": (k * N * 4 + N * 4 + N * 4, 2 * k * N),
        "spmv_dia_bf16": (k * N * 2 + N * 2 + N * 4, 2 * k * N),
        "fused_vma": (11 * N * 4 + 9 * N * 4 + 8 + 12, 23 * N),
        "fused_iter": (k * N * 4 + 10 * N * 4 + 9 * N * 4 + 8 + 12, 2 * k * N + 23 * N),
        "fused_iter_bf16band": (k * N * 2 + 10 * N * 4 + 9 * N * 4 + 8 + 12, 2 * k * N + 23 * N),
        "spmv_bell": (QN * R * (4 + 4) + QN * 4 + QN * 4, 2 * QN * R),
        "spmv_bell_bf16": (QN * R * (4 + 2) + QN * 2 + QN * 2, 2 * QN * R),
        "fused_dots": (3 * QN * 4 + 12, 6 * QN),
    }
    bounds = {}
    for kname, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / bw_peak * 1e3, ops / f32_peak * 1e3
        bounds[kname] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        log(f"{kname}: {times[kname][0]:.4f} ms (bound {bounds[kname][0]:.4f} ms, "
            f"{nbytes / times[kname][0] / 1e6:.0f} GB/s), plain {times[kname][1]:.3f} ms")
    log(f"torch.sparse CSR matvec (nnz={nnz}): {library['spmv_dia']:.4f} ms")
    log(f"Queen_4147: torch.sparse CSR matvec (nnz={qcsr.nnz}): {library['spmv_bell']:.4f} ms; "
        f"three torch.dot calls: {three_dots_ms:.4f} ms; spmv_dia on its DIA form: "
        f"{queen_dia_ms:.4f} ms (bound {(Q.n_diags * QN * 4 + 8 * QN) / bw_peak * 1e3:.4f} ms)")
    del qcsr

    # ----------------------------------------------------------------- 2c
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model, make_generator

    full_cfg = get_config("internlm2-1.8b")
    full_api = build_model(full_cfg)
    shapes = [tuple(t.shape) for t in full_api.empty_params("meta").parameters()]
    n_model = full_api.n_params()
    n_emb = full_cfg.vocab_size * full_cfg.d_model
    if len(shapes) != 219 or sum(math.prod(s) for s in shapes) != n_model:
        fail(f"internlm2-1.8b has {len(shapes)} tensors, {n_model} parameters")

    def adam_inputs(n, p_dtype, g_dtype, seed):
        """p ~ N(0, 1), g ~ 1e-2 N(0, 1), nonzero m and v (v >= 0)."""
        g_ = torch.Generator(device=dev)
        g_.manual_seed(seed)
        p = torch.randn(n, generator=g_, device=dev).to(p_dtype)
        g = (torch.randn(n, generator=g_, device=dev) * 1e-2).to(g_dtype)
        m = torch.randn(n, generator=g_, device=dev) * 1e-3
        v = torch.rand(n, generator=g_, device=dev) * 1e-4
        return p, g, m, v

    def hyper_at(step):
        return adamw_hyper(3e-4, 0.9, 0.999, 1e-8, 0.1,
                           torch.full((), step, dtype=torch.int32, device=dev))

    t32, t16 = torch.float32, torch.bfloat16
    errs.update(fused_adam=0.0, fused_adam_bf16=0.0)  # bit for bit, or fail
    checked = []
    for n, pairs in ((4_097, ((t32, t32), (t16, t16), (t16, t32))),
                     (n_emb, ((t32, t32), (t16, t16)))):
        for p_dtype, g_dtype in pairs:
            key = "fused_adam" if p_dtype == t32 else "fused_adam_bf16"
            label = f"fused_adam n={n} p={p_dtype} g={g_dtype}"
            p, g, m, v = adam_inputs(n, p_dtype, g_dtype, 7)
            for step in (1, 10):
                hyper = hyper_at(step)
                want = fused_adamw_ref(p, g, m, v, hyper)
                before = fused_adamw.launches
                fused_adamw(p, g, m, v, hyper)
                sync()
                if fused_adamw.launches != before + 1:
                    fail(f"{label}: {fused_adamw.launches - before} launches, not 1")
                for leaf, got, w in zip("pmv", (p, m, v), want):
                    if not torch.equal(got, w):
                        err = float((got.double() - w.double()).abs().max())
                        fail(f"{label} step {step}: {leaf} differs from the plain version "
                             f"(max abs err {err:.3e}), not bit for bit")
            checked.append(label)
            del p, g, m, v, want
    log(f"fused_adam equals its plain version bit for bit: {checked}")
    torch.cuda.empty_cache()

    # one call at the embedding's size, and the torch.optim yardstick there
    import torch.nn as nn

    adam_torch = {}
    for key, dtype in (("fused_adam", t32), ("fused_adam_bf16", t16)):
        p, g, m, v = adam_inputs(n_emb, dtype, dtype, 8)
        hyper = hyper_at(10)
        times[key] = (timed(lambda: fused_adamw(p, g, m, v, hyper), 10),
                      timed(lambda: fused_adamw_ref(p, g, m, v, hyper), 2, 3))
        P = nn.Parameter(p.detach().clone())
        P.grad = g.clone()
        opt = torch.optim.AdamW([P], lr=3e-4, weight_decay=0.1, fused=True)
        adam_torch[key] = timed(opt.step, 10)
        del p, g, m, v, P, opt
        torch.cuda.empty_cache()
    # torch's fused AdamW keeps its moments in the parameters' dtype: only
    # the f32 run computes the kernel's function (bf16 p with f32 m, v)
    library["fused_adam"] = adam_torch["fused_adam"]
    record["torch_adamw_bf16_state_embedding_ms"] = adam_torch["fused_adam_bf16"]

    # one whole-model pass: 219 tensors, bf16 p and g, f32 m and v
    tensors = [adam_inputs(math.prod(s), t16, t16, 100 + i) for i, s in enumerate(shapes)]
    hyper = hyper_at(10)

    def model_pass():
        for p, g, m, v in tensors:
            fused_adamw(p, g, m, v, hyper)

    model_adam_ms = timed(model_pass, 1)
    del tensors
    torch.cuda.empty_cache()
    params_f32 = []
    for i, s in enumerate(shapes):
        P = nn.Parameter(torch.randn(s, device=dev))
        P.grad = torch.randn(s, device=dev) * 1e-2
        params_f32.append(P)
    opt = torch.optim.AdamW(params_f32, lr=3e-4, weight_decay=0.1, fused=True)
    model_torch_adam_ms = timed(opt.step, 1)
    del params_f32, opt
    torch.cuda.empty_cache()
    model_adam_bound = 22 * n_model / bw_peak * 1e3
    log(f"fused_adam, one internlm2-1.8b pass ({len(shapes)} launches, {n_model:,} parameters, "
        f"bf16 p and g): {model_adam_ms:.4f} ms (bound {model_adam_bound:.4f} ms); "
        f"torch.optim.AdamW(fused=True), f32 parameters and moments: {model_torch_adam_ms:.4f} ms")
    record.update(model_adam_ms=model_adam_ms, model_adam_bound_ms=model_adam_bound,
                  model_torch_adamw_f32_ms=model_torch_adam_ms, fused_adam_bit_for_bit=checked)

    # ----------------------------------------------------------------- 2d
    import torch.nn.functional as F

    def attn_inputs(B, Tq, Tk, H, KV, hd, dtype, seed):
        g_ = torch.Generator(device=dev)
        g_.manual_seed(seed)
        q = torch.randn(B, Tq, H, hd, generator=g_, device=dev).to(dtype)
        k = torch.randn(B, Tk, KV, hd, generator=g_, device=dev).to(dtype)
        v = torch.randn(B, Tk, KV, hd, generator=g_, device=dev).to(dtype)
        return q, k, v

    errs.update(flash_attn=0.0, flash_attn_bf16=0.0)
    attn_cases = [((8, 512, 512, 16, 8, 128), True), ((1, 4096, 4096, 16, 8, 128), True),
                  ((2, 512, 1024, 16, 8, 128), False),  # Tk != Tq, full
                  ((2, 1024, 1024, 16, 4, 128), True),  # 4:1 GQA
                  ((8, 512, 512, 32, 32, 64), True)]    # stablelm-1.6b, hd 64
    f32_prob_dist = 0.0
    for dtype in (t32, t16):
        key = "flash_attn" if dtype == t32 else "flash_attn_bf16"
        for (B, Tq, Tk, H, KV, hd), causal in attn_cases:
            q, k, v = attn_inputs(B, Tq, Tk, H, KV, hd, dtype, 9)
            before = flash_attention.launches
            got = flash_attention(q, k, v, causal=causal)
            sync()
            if flash_attention.launches != before + 1:
                fail(f"flash_attn: {flash_attention.launches - before} launches, not 1")
            label = f"flash_attn {dtype} B={B} Tq={Tq} Tk={Tk} H={H} KV={KV} hd={hd} causal={causal}"
            if not torch.equal(got, flash_attention(q, k, v, causal=causal)):
                fail(f"{label}: two calls on the same inputs differ")
            want = flash_attention_ref(q, k, v, causal=causal)
            errs[key] = max(errs[key], check(label, got, want, rtol=ATTN_F32, atol=ATTN_F32)
                            if dtype == t32 else check_rows(label, got, want, ATTN_BF16_ROW))
            if dtype == t16:  # how far the kernel sits from f32 probabilities (the TPU kernel's)
                want32 = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
                d = got.double() - want32.double()
                rel = float((d.norm(dim=-1) / want32.double().norm(dim=-1).clamp_min(1e-30)).max())
                f32_prob_dist = max(f32_prob_dist, rel)
                log(f"  {label}: row-relative distance from f32 probabilities {rel:.3e}")
                del want32, d
            del q, k, v, got, want
        log(f"flash_attn ({dtype}) agrees with its plain version on {len(attn_cases)} shapes")
    record["flash_attn_bf16_row_dist_from_f32_probabilities"] = f32_prob_dist
    torch.cuda.empty_cache()

    # the bf16 entry must run its products on the tensor cores
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", info["path"]], capture_output=True, text=True,
                          timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass failed: {sass.stderr.strip()[:500]}")
    hmma = {}
    for part in sass.stdout.split("Function : ")[1:]:
        fname = part.split(None, 1)[0]
        if "flash_attn_bf16_kernel" in fname:
            hmma[fname] = sum(line.count("HMMA") + line.count("HGMMA") for line in part.splitlines())
    log(f"flash_attn_bf16 SASS tensor-core instructions (HMMA/HGMMA) per instance: {hmma}")
    if not hmma or min(hmma.values()) == 0:
        fail(f"flash_attn_bf16's SASS holds no HMMA/HGMMA: {hmma}")
    record["flash_attn_bf16_sass_hmma"] = hmma

    def attn_flops(B, T, H, hd):  # 2 products of 2 hd flops per (query, key) pair under the mask
        return 4 * hd * B * H * T * (T + 1) // 2

    def attn_bytes(B, T, H, KV, hd, itemsize):  # q, k, v read once, o written once
        return (2 * B * T * H * hd + 2 * B * T * KV * hd) * itemsize

    def bound_of(nbytes, ops, peak_ops):
        t_bytes, t_ops = nbytes / bw_peak * 1e3, ops / peak_ops * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"

    def sdpa_call(q, k, v):
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    B, T, H, KV, hd = 8, 512, 16, 8, 128  # the full-size trainer's attention shape
    attn_ops = attn_flops(B, T, H, hd)
    for key, dtype in (("flash_attn", t32), ("flash_attn_bf16", t16)):
        q, k, v = attn_inputs(B, T, T, H, KV, hd, dtype, 10)
        times[key] = (timed(lambda: flash_attention(q, k, v), 10),
                      timed(lambda: flash_attention_ref(q, k, v), 3, 3))
        sdpa = sdpa_call(q, k, v)
        check_rows(f"scaled_dot_product_attention yardstick ({dtype})", sdpa().transpose(1, 2),
                   flash_attention(q, k, v), 10 * ATTN_BF16_ROW)
        library[key] = timed(sdpa, 10)
        del q, k, v, sdpa
    torch.cuda.empty_cache()
    # bf16 at a long sequence, where the operations bound the work
    BL, TL = 1, 4096
    q, k, v = attn_inputs(BL, TL, TL, H, KV, hd, t16, 11)
    long_flops = attn_flops(BL, TL, H, hd)
    long_bound = bound_of(attn_bytes(BL, TL, H, KV, hd, 2), long_flops, bf16_peak)
    long_attn = {"shape": [BL, TL, H, KV, hd], "flops": long_flops,
                 "ms": timed(lambda: flash_attention(q, k, v), 10),
                 "plain_ms": timed(lambda: flash_attention_ref(q, k, v), 3, 3),
                 "library_ms": timed(sdpa_call(q, k, v), 10),
                 "bound_ms": long_bound[0], "bound_by": long_bound[1]}
    del q, k, v
    torch.cuda.empty_cache()
    record["flash_attn_bf16_long"] = long_attn

    adam_ops = 17 * n_emb  # per element: 5 mul, 4 add/sub, 3 div, 1 sqrt, and the lr step
    bounds["fused_adam"] = bound_of(28 * n_emb, adam_ops, f32_peak)
    bounds["fused_adam_bf16"] = bound_of(22 * n_emb, adam_ops, f32_peak)
    bounds["flash_attn"] = bound_of(attn_bytes(B, T, H, KV, hd, 4), attn_ops, f32_peak)
    bounds["flash_attn_bf16"] = bound_of(attn_bytes(B, T, H, KV, hd, 2), attn_ops, bf16_peak)
    for kname in ("fused_adam", "fused_adam_bf16", "flash_attn", "flash_attn_bf16"):
        log(f"{kname}: {times[kname][0]:.4f} ms (bound {bounds[kname][0]:.4f} ms, "
            f"{bounds[kname][1]}), plain {times[kname][1]:.3f} ms, "
            f"library {library.get(kname, float('nan')):.4f} ms")
    for kname in ("flash_attn", "flash_attn_bf16"):
        log(f"{kname} (8, 512, 16, 8, 128) causal: {times[kname][0]:.4f} ms = "
            f"{attn_ops / times[kname][0] / 1e9:.1f} TFLOP/s; scaled_dot_product_attention "
            f"{library[kname]:.4f} ms = {attn_ops / library[kname] / 1e9:.1f} TFLOP/s")
    log(f"flash_attn_bf16 (1, 4096, 16, 8, 128) causal: {long_attn['ms']:.4f} ms = "
        f"{long_flops / long_attn['ms'] / 1e9:.1f} TFLOP/s (bound {long_attn['bound_ms']:.4f} ms, "
        f"{long_attn['bound_by']}), plain {long_attn['plain_ms']:.3f} ms, scaled_dot_product_attention "
        f"{long_attn['library_ms']:.4f} ms = {long_flops / long_attn['library_ms'] / 1e9:.1f} TFLOP/s")
    log(f"torch.optim.AdamW(fused=True) at the embedding's size: f32 {adam_torch['fused_adam']:.4f} "
        f"ms, bf16 parameters and moments {adam_torch['fused_adam_bf16']:.4f} ms")

    # ------------------------------------------------------------------ 3
    import scipy.sparse as sp

    xstar = torch.full((N,), 1.0 / math.sqrt(N), device=dev)
    b = spmv(A, xstar)
    data64 = A.data.double().cpu().numpy()
    shifted = np.zeros_like(data64)  # scipy's DIA stores A[c - off, c] at column c
    for j, o in enumerate(A.offsets):
        if o >= 0:
            shifted[j, o:] = data64[j, : N - o]
        else:
            shifted[j, : N + o] = data64[j, -o:]
    A64 = sp.dia_matrix((shifted, np.asarray(A.offsets)), shape=(N, N))
    del data64, shifted
    b64 = A64 @ (np.ones(N) / math.sqrt(N))

    def relative_residual(M64, rhs64):
        def fn(xs):
            r = rhs64 - M64 @ xs.double().cpu().numpy()
            return float(np.linalg.norm(r) / np.linalg.norm(rhs64))
        return fn

    true_residual = relative_residual(A64, b64)
    counters = {"spmv_dia": spmv_dia_cuda, "fused_vma": fused_vma_dots,
                "fused_iter": fused_iter_step, "spmv_bell": spmv_bell_cuda,
                "fused_dots": fused_dots}

    def drive(engine, op=None, rhs=None, resid=None, method="pipecg", maxiter=2000, **kw):
        """One solve through the plan API, counters set to 0 just before it."""
        op = A if op is None else op
        rhs = b if rhs is None else rhs
        resid = true_residual if resid is None else resid
        p = repro_torch.plan(op, method=method, engine=engine, M="jacobi", atol=0.0,
                             rtol=SOLVE_RTOL, maxiter=maxiter, **kw)
        for f in counters.values():
            f.launches = 0
        sync()
        t = time.perf_counter()
        res = p.solve(rhs)
        sync()
        wall = time.perf_counter() - t
        launches = {kn: f.launches for kn, f in counters.items()}
        out = dict(describe=p.describe(), iterations=int(res.iterations), steps=res.steps,
                   converged=bool(res.converged), residual_norm=float(res.residual_norm),
                   true_residual=resid(res.x), wall_s=wall, launches=launches,
                   history=res.history[: int(res.iterations) + 1].float().cpu().numpy())
        d = out["describe"]
        log(f"solve {method} {d['operator']} engine={engine} {kw or ''}: core={d.get('core')} "
            f"spmv={d['spmv']} iterations={out['iterations']} steps={out['steps']} "
            f"(no-op steps {out['steps'] - out['iterations']}) converged={out['converged']} "
            f"true_rel_residual={out['true_residual']:.3e} wall={wall:.3f} s launches={launches}")
        return out

    runs = {e: drive(e) for e in ("auto", "cuda", "torch")}
    auto, cuda_run, plain = runs["auto"], runs["cuda"], runs["torch"]
    if auto["describe"]["core"] != "fused_iter":
        fail(f"engine='auto' resolved to {auto['describe']['core']}, not fused_iter")
    for e, r in runs.items():
        if not r["converged"]:
            fail(f"engine={e} did not converge")
        if not r["true_residual"] < 1e-2:
            fail(f"engine={e} true residual {r['true_residual']:.3e} >= 1e-2")
        if r["describe"]["replace_every"] != 0:
            fail(f"engine={e} ran residual replacement")
    its = {e: r["iterations"] for e, r in runs.items()}
    if len(set(its.values())) != 1:
        fail(f"iteration counts differ: {its}")
    h0 = plain["history"][0]
    for e in ("auto", "cuda"):
        if not np.allclose(runs[e]["history"], plain["history"], rtol=1e-3, atol=1e-5 * h0):
            fail(f"history of engine={e} differs from engine=torch")

    def expect(**nonzero):
        """Launch counts of one run: the given ones, 0 for every other kernel."""
        return {kn: nonzero.get(kn, 0) for kn in counters}

    want = {"auto": expect(spmv_dia=2, fused_iter=auto["steps"]),
            "cuda": expect(spmv_dia=3 + cuda_run["steps"], fused_vma=cuda_run["steps"]),
            "torch": expect()}
    for e, r in runs.items():
        if r["launches"] != want[e]:
            fail(f"engine={e}: launches {r['launches']} != expected {want[e]}")
    bf16 = drive("cuda", spmv_engine="bf16")
    log(f"bf16 SPMV run (replace_every={bf16['describe']['replace_every']}): "
        f"converged={bf16['converged']} true_rel_residual={bf16['true_residual']:.3e}")
    if bf16["launches"]["spmv_dia"] == 0:
        fail("the bf16 run launched no spmv_dia kernel")
    # the bf16-band fused_iter core, as the JAX package's make_fused_iter_core(A,
    # data_dtype=bfloat16): one solve through pipecg with that core (init in
    # f32, every step the bf16-band kernel); reported, its launches asserted
    from repro_torch.core.iteration import make_fused_iter_core
    from repro_torch.core.pipecg import pipecg
    from repro_torch.core.preconditioners import jacobi

    core16 = make_fused_iter_core(A, data_dtype=torch.bfloat16)
    for f in counters.values():
        f.launches = 0
    sync()
    t = time.perf_counter()
    res16 = pipecg(A, b, M=jacobi(A), atol=0.0, rtol=SOLVE_RTOL, maxiter=2000, core=core16)
    sync()
    band16 = dict(iterations=int(res16.iterations), steps=res16.steps,
                  converged=bool(res16.converged), true_residual=true_residual(res16.x),
                  wall_s=time.perf_counter() - t,
                  launches={kn: f.launches for kn, f in counters.items()})
    log(f"pipecg with the bf16-band fused_iter core: iterations={band16['iterations']} "
        f"steps={band16['steps']} converged={band16['converged']} "
        f"true_rel_residual={band16['true_residual']:.3e} launches={band16['launches']}")
    if band16["launches"] != expect(spmv_dia=2, fused_iter=band16["steps"]):
        fail(f"bf16-band core: launches {band16['launches']}")
    del core16, res16

    # ----------------------------------------------------------------- 3b
    q64 = Q.data.double().cpu().numpy()
    shifted = np.zeros_like(q64)
    for j, o in enumerate(Q.offsets):
        if o >= 0:
            shifted[j, o:] = q64[j, : QN - o]
        else:
            shifted[j, : QN + o] = q64[j, -o:]
    Q64 = sp.dia_matrix((shifted, np.asarray(Q.offsets)), shape=(QN, QN))
    del q64, shifted
    qb = spmv(Q, torch.full((QN,), 1.0 / math.sqrt(QN), device=dev))
    q_resid = relative_residual(Q64, Q64 @ (np.ones(QN) / math.sqrt(QN)))
    qkw = dict(rhs=qb, resid=q_resid)
    qruns = {
        "bell-auto": drive("auto", QB, **qkw),
        "bell-torch": drive("torch", QB, **qkw),
        "csr-auto": drive("auto", QC, **qkw),
        "dia-auto": drive("auto", Q, **qkw),
        "pcg": drive("auto", QB, method="pcg", **qkw),
        "chronopoulos": drive("auto", QB, method="chronopoulos", **qkw),
    }
    resolved = {label: (r["describe"].get("core"), r["describe"]["spmv"])
                for label, r in qruns.items()}
    want_resolved = {"bell-auto": ("cuda", "cuda"), "bell-torch": ("torch", "torch"),
                     "csr-auto": ("cuda", "segsum"), "dia-auto": ("fused_iter", "cuda"),
                     "pcg": (None, "cuda"), "chronopoulos": (None, "cuda")}
    if resolved != want_resolved:
        fail(f"Queen_4147 paths resolved to {resolved}, expected {want_resolved}")
    for label, r in qruns.items():
        if not r["converged"]:
            fail(f"Queen_4147 {label} did not converge")
        if not r["true_residual"] < 1e-2:
            fail(f"Queen_4147 {label}: true residual {r['true_residual']:.3e} >= 1e-2")
    pipe = ("bell-auto", "bell-torch", "csr-auto", "dia-auto")
    q_its = {label: qruns[label]["iterations"] for label in qruns}
    if len({q_its[label] for label in pipe}) != 1:
        fail(f"Queen_4147 pipecg iteration counts differ: {q_its}")
    q_it = q_its["bell-auto"]
    for label in ("pcg", "chronopoulos"):
        if abs(q_its[label] - q_it) > BASELINE_BAND:
            fail(f"Queen_4147 {label}: {q_its[label]} iterations, pipecg {q_it}")
    qh0 = qruns["bell-torch"]["history"][0]
    for label in pipe:
        if not np.allclose(qruns[label]["history"], qruns["bell-torch"]["history"], rtol=1e-3,
                           atol=1e-5 * qh0):
            fail(f"Queen_4147 history of {label} differs from bell-torch")
    st = {label: r["steps"] for label, r in qruns.items()}
    want = {"bell-auto": expect(spmv_bell=3 + st["bell-auto"], fused_vma=st["bell-auto"]),
            "bell-torch": expect(),
            "csr-auto": expect(fused_vma=st["csr-auto"]),
            "dia-auto": expect(spmv_dia=2, fused_iter=st["dia-auto"]),
            "pcg": expect(spmv_bell=1 + st["pcg"]),
            "chronopoulos": expect(spmv_bell=2 + st["chronopoulos"])}
    for label, r in qruns.items():
        if r["launches"] != want[label]:
            fail(f"Queen_4147 {label}: launches {r['launches']} != expected {want[label]}")
    log(f"Queen_4147 solves agree: pipecg {q_it} iterations on every form, "
        f"pcg {q_its['pcg']}, chronopoulos {q_its['chronopoulos']}")
    QB16 = QB.with_dtype(torch.bfloat16)
    qruns["pcg-bf16"] = drive("auto", QB16, method="pcg", maxiter=200, rhs=qb.to(torch.bfloat16),
                              resid=q_resid)
    log(f"bf16 pcg on the Bell form: converged={qruns['pcg-bf16']['converged']} "
        f"true_rel_residual={qruns['pcg-bf16']['true_residual']:.3e}")
    if qruns["pcg-bf16"]["launches"] != expect(spmv_bell=1 + qruns["pcg-bf16"]["steps"]):
        fail(f"bf16 pcg launches {qruns['pcg-bf16']['launches']}")
    del QB16

    # ------------------------------------------------------------------ 4
    per_iter = {}
    for label, engine, kw in (("auto", "auto", {}), ("cuda", "cuda", {}),
                              ("cuda+bf16", "cuda", {"spmv_engine": "bf16"}),
                              ("torch", "torch", {})):
        p = repro_torch.plan(A, method="pipecg", engine=engine, M="jacobi", atol=0.0, rtol=0.0,
                             maxiter=TIMED_ITERS, **kw)
        res = p.solve(b)
        if int(res.iterations) != TIMED_ITERS:
            fail(f"fixed-count run of {label} ran {int(res.iterations)} iterations")
        ms = timed(lambda: p.solve(b), 1) / TIMED_ITERS
        per_iter[label] = ms
        log(f"engine={label}: {ms:.4f} ms per iteration ({TIMED_ITERS} iterations, median of 5)")

    # ----------------------------------------------------------------- 4b
    qcases = {"bell-auto": (QB, "pipecg"), "csr-auto": (QC, "pipecg"), "dia-auto": (Q, "pipecg"),
              "pcg": (QB, "pcg"), "chronopoulos": (QB, "chronopoulos")}

    def fixed_plan(label, count):
        op, method = qcases[label]
        return repro_torch.plan(op, method=method, engine="auto", M="jacobi", atol=0.0,
                                rtol=0.0, maxiter=count)

    completed = {label: int(fixed_plan(label, TIMED_ITERS).solve(qb).iterations)
                 for label in qcases}
    q_fixed = min(completed.values())
    log(f"Queen_4147 fixed-count runs completed {completed} of {TIMED_ITERS} iterations; "
        f"timing {q_fixed} on every path")
    if q_fixed < 2:
        fail("a Queen_4147 fixed-count run completed fewer than 2 iterations")
    # a short count amortizes set-up (1-3 SPMVs) over few iterations, so the
    # marginal time of the second half of the count is reported beside it
    q_half = q_fixed // 2
    q_per_iter, q_marginal = {}, {}
    for label in qcases:
        solve_ms = {}
        for count in (q_fixed, q_half):
            p = fixed_plan(label, count)
            if int(p.solve(qb).iterations) != count:
                fail(f"Queen_4147 fixed-count run of {label} did not repeat {count} iterations")
            solve_ms[count] = timed(lambda: p.solve(qb), 1)
        q_per_iter[label] = solve_ms[q_fixed] / q_fixed
        q_marginal[label] = (solve_ms[q_fixed] - solve_ms[q_half]) / (q_fixed - q_half)
        log(f"Queen_4147 {label}: {q_per_iter[label]:.4f} ms per iteration "
            f"({q_fixed} iterations, median of 5); marginal {q_marginal[label]:.4f} ms "
            f"(iterations {q_half + 1}-{q_fixed})")

    # what a user pays for one Queen_4147 solve to rtol 1e-3: the converged
    # iterations plus the no-op steps up to the host's poll
    q_solve_ms = {}
    for label, (op, method) in qcases.items():
        p = repro_torch.plan(op, method=method, engine="auto", M="jacobi", atol=0.0,
                             rtol=SOLVE_RTOL, maxiter=2000)
        q_solve_ms[label] = timed(lambda: p.solve(qb), 1)
        log(f"Queen_4147 {label}: {q_solve_ms[label]:.4f} ms per solve to rtol {SOLVE_RTOL} "
            f"({qruns[label]['iterations']} iterations, {qruns[label]['steps']} steps, "
            f"median of 5)")

    # ------------------------------------------------------------------ 6
    # the serving tier at full width, on the operators phases 2-4b built
    import gc
    import tempfile

    from repro_torch.kernels import (
        fused_iter_batched,
        fused_iter_batched_ref,
        fused_vma_dots_batched,
        fused_vma_dots_batched_ref,
        spmv_bell_batched,
        spmv_bell_batched_ref,
        spmv_dia_batched,
        spmv_dia_batched_bf16,
        spmv_dia_batched_bf16_ref,
        spmv_dia_batched_ref,
    )
    from repro_torch.serve import SolverServer, operator_spec, register_operator_builder
    from repro_torch.sparse import synthetic_spd_dia

    del QC, qcases
    gc.collect()
    torch.cuda.empty_cache()
    BATCHED = {"fused_iter_batched": fused_iter_batched, "spmv_dia_batched": spmv_dia_batched,
               "spmv_dia_batched_bf16": spmv_dia_batched_bf16,
               "fused_vma_batched": fused_vma_dots_batched, "spmv_bell_batched": spmv_bell_batched}
    counters.update(BATCHED)
    inv_a = 1.0 / A.diagonal()
    inv_q = 1.0 / QB.diagonal()
    A16 = A.with_dtype(torch.bfloat16)
    # a Bell operator whose band is far wider than the Bell lane kernel's
    # window (halves of at most 256 columns at 8 lanes): its slots outside
    # the window are gathered from X
    WN = 200_000
    WB = bell_from_csr(csr_from_dia(synthetic_spd_dia(WN, nnz_per_row=27, bandwidth=WN // 4,
                                                      seed=5, device=dev)), device=dev)
    log(f"wide-band Bell operator: N={WN}, R={WB.slots_per_row}, column span {WB.column_span} "
        f"(Queen_4147's {QB.column_span})")
    if WB.column_span <= 4 * 256:
        fail(f"the wide-band operator's span {WB.column_span} fits the lane kernel's window")
    # two more operators for the DIA lane kernel: isolated far offsets (runs
    # of 1 beside the near band's run of 13) over a span far wider than a
    # window, at an n that is no multiple of 4 or 8 (each lane's window keeps
    # its own shift); and poisson125(144), whose z-plane span (580) exceeds
    # the 8-lane f32 window's 560 columns, so each z-plane takes two groups
    DS = synthetic_spd_dia(200_003, 27, bandwidth=4_000, seed=6, device=dev)
    P144 = poisson125(144, device=dev)
    dia_ops = {"": (A, A16), " (isolated offsets, N=200,003)": (DS, DS.with_dtype(torch.bfloat16)),
               " (poisson125(144))": (P144, P144.with_dtype(torch.bfloat16))}
    log(f"DIA lane operators: N=200,003 offsets span {max(DS.offsets) - min(DS.offsets)}; "
        f"poisson125(144) N={P144.n}")

    def lanes_of(k, n, seed, scale=1.0):
        g_ = torch.Generator(device=dev)
        g_.manual_seed(seed)
        return torch.randn(k, n, generator=g_, device=dev) * scale

    def dots_scale(vecs, lane):
        r_, u_, w_ = vecs[5][lane], vecs[6][lane], vecs[7][lane]
        return float(torch.stack([(r_ * u_).abs().sum(), (w_ * u_).abs().sum(),
                                  (u_ * u_).sum()]).max())

    def bf16_single(op, x1):  # the single-rhs bf16 kernel with the lane entry's f32 output
        return spmv_dia_cuda(op, x1, out_dtype=torch.float32)

    def check_fused_iter_lanes(kn, op, band, k_l, act, alpha, beta, seed, tag):
        """fused_iter_batched with an f32 or bf16 band of ``op``: against its
        plain version and, lane by lane, the single instance of the same
        band; an inactive lane left bit for bit."""
        n_op, inv_op = op.n, (inv_a if op is A else 1.0 / op.diagonal())
        vecs = [lanes_of(k_l, n_op, seed + i) for i in range(9)]
        want = fused_iter_batched_ref(band, op.offsets, *vecs, inv_op, alpha, beta)
        lanes_work = [v.clone() for v in vecs[:8]]
        m_out = torch.empty_like(vecs[8])
        got = fused_iter_batched(band, op.offsets, *lanes_work, vecs[8], m_out, inv_op, alpha,
                                 beta, act)
        for lane in range(k_l):
            if not act[lane]:
                if not (all(torch.equal(v[lane], v0[lane]) for v, v0 in zip(lanes_work, vecs))
                        and torch.equal(m_out[lane], vecs[8][lane])):
                    fail(f"{kn} {tag}: inactive lane {lane} was touched")
                continue
            s_out = torch.empty(n_op, device=dev)
            single = fused_iter_step(band, op.offsets, *[v[lane].clone() for v in vecs[:8]],
                                     vecs[8][lane], s_out, inv_op, alpha[lane], beta[lane])
            for g_v, w_v, s_v in zip(got[:9], want[:9], single[:9]):
                errs[kn] = max(errs[kn], check(f"{kn} {tag} lane {lane}", g_v[lane], w_v[lane],
                                               **VEC))
                check(f"{kn} {tag} lane {lane} vs the single kernel", g_v[lane], s_v, **VEC)
                bits[kn] &= bool(torch.equal(g_v[lane], s_v))
            check_dots(f"{kn} {tag} lane {lane}", got[9][lane], want[9][lane],
                       dots_scale(want, lane))
            bits[kn] &= bool(torch.equal(got[9][lane], single[9]))

    # (a) each batched entry against its plain version and, lane by lane,
    # against the single-rhs kernel; one inactive lane left bit for bit
    bits = {kn: True for kn in (*BATCHED, "fused_iter_bf16band")}
    errs.update({kn: 0.0 for kn in BATCHED})
    seed = 600
    for k_l, off in ((1, None), (1, 0), (3, 1), (8, 1)):
        act = torch.ones(k_l, dtype=torch.bool, device=dev)
        if off is not None:
            act[off] = False
        tag = f"k={k_l} inactive={off}"
        seed += 10
        # spmv_dia in f32 and bf16 (f32 sums and y) at the three DIA operators,
        # spmv_bell at Queen_4147's Bell form and at the wide-band operator
        cases = []
        for op_tag, (op32, op16) in dia_ops.items():
            cases += [("spmv_dia_batched", spmv_dia_batched, spmv_dia_batched_ref, spmv_dia_cuda,
                       op32, (op32.data, op32.offsets), torch.float32, op_tag),
                      ("spmv_dia_batched_bf16", spmv_dia_batched_bf16, spmv_dia_batched_bf16_ref,
                       bf16_single, op16, (op16.data, op16.offsets), torch.bfloat16, op_tag)]
        cases += [("spmv_bell_batched", spmv_bell_batched, spmv_bell_batched_ref, spmv_bell_cuda,
                   QB, (QB.cols, QB.vals), torch.float32, ""),
                  ("spmv_bell_batched", spmv_bell_batched, spmv_bell_batched_ref, spmv_bell_cuda,
                   WB, (WB.cols, WB.vals), torch.float32, " (wide band)")]
        for kn, fn, ref, single, op, refargs, dtype, op_tag in cases:
            X = lanes_of(k_l, op.n, seed).to(dtype)
            Y = fn(op, X, act)
            label = f"{kn} {tag}{op_tag}"
            errs[kn] = max(errs[kn], check(label, Y, ref(*refargs, X, act), **VEC))
            for lane in range(k_l):
                if not act[lane]:
                    if Y[lane].any():
                        fail(f"{label}: inactive lane {lane} is not 0")
                    continue
                y1 = single(op, X[lane])
                check(f"{label} lane {lane} vs the single kernel", Y[lane], y1, **VEC)
                bits[kn] &= bool(torch.equal(Y[lane], y1))
            del X, Y
        # fused_vma at Queen_4147's length, fused_iter at poisson125(128)'s
        alpha = torch.linspace(0.2, 0.4, k_l, device=dev)
        beta = torch.linspace(0.5, 0.7, k_l, device=dev)
        vecs = [lanes_of(k_l, QN, seed + 1 + i) for i in range(10)]
        want = fused_vma_dots_batched_ref(*vecs, inv_q, alpha, beta)
        lanes_work = [v.clone() for v in vecs]
        got = fused_vma_dots_batched(*lanes_work, inv_q, alpha, beta, act)
        for lane in range(k_l):
            if not act[lane]:
                if not all(torch.equal(v[lane], v0[lane]) for v, v0 in zip(lanes_work, vecs)):
                    fail(f"fused_vma_batched {tag}: inactive lane {lane} was touched")
                continue
            single = fused_vma_dots(*[v[lane].clone() for v in vecs], inv_q, alpha[lane],
                                    beta[lane])
            for g_v, w_v, s_v in zip(got[:9], want[:9], single[:9]):
                errs["fused_vma_batched"] = max(errs["fused_vma_batched"], check(
                    f"fused_vma_batched {tag} lane {lane}", g_v[lane], w_v[lane], **VEC))
                check(f"fused_vma_batched {tag} lane {lane} vs the single kernel", g_v[lane], s_v,
                      **VEC)
                bits["fused_vma_batched"] &= bool(torch.equal(g_v[lane], s_v))
            check_dots(f"fused_vma_batched {tag} lane {lane}", got[9][lane], want[9][lane],
                       dots_scale(want, lane))
            bits["fused_vma_batched"] &= bool(torch.equal(got[9][lane], single[9]))
        del vecs, want, lanes_work, got
        check_fused_iter_lanes("fused_iter_batched", A, A.data, k_l, act, alpha, beta, seed + 20,
                               tag)
        # the bf16-band lanes' row tiles on the three DIA operators (n % 4 of
        # 0, 3 and 0; one, many and two groups of diagonals a z-plane)
        for op_tag, (op32, op16) in dia_ops.items():
            check_fused_iter_lanes("fused_iter_bf16band", op32, op16.data, k_l, act, alpha, beta,
                                   seed + 20, tag + op_tag)
        sync()
        log(f"batched kernels agree with their plain versions and the single kernels ({tag})")
    log(f"batched kernels: each active lane equal bit for bit to the single-rhs kernel: {bits}")
    for kn in ("spmv_dia_batched", "spmv_dia_batched_bf16", "fused_iter_bf16band"):
        if not bits[kn]:  # their designs keep each row's sums in the single kernel's order
            fail(f"{kn}: an active lane differs from the single-rhs kernel's bits")
    record["batched_bits_equal_single"] = bits
    torch.cuda.empty_cache()

    del WB, DS, P144, dia_ops
    # times at the serving bucket (k = 8), all lanes active, beside the plain
    # versions, cuSPARSE's SpMM (torch.sparse CSR @ dense) and the bytes bound;
    # the lane kernels redesigned for Hopper (spmv_bell, fused_iter, spmv_dia
    # in f32 and bf16) and the bf16-band fused_iter also at k = 2 and 4
    KB = 8
    lane_ms = {kn: {} for kn in ("spmv_bell_batched", "fused_iter_batched", "spmv_dia_batched",
                                 "spmv_dia_batched_bf16", "fused_iter_bf16band")}
    for k_t in (2, 4, KB):
        if k_t != KB:
            Xt = lanes_of(k_t, QN, 690)
            lane_ms["spmv_bell_batched"][k_t] = timed(lambda: spmv_bell_batched(QB, Xt), 10)
            Xt = lanes_of(k_t, N, 692)
            lane_ms["spmv_dia_batched"][k_t] = timed(lambda: spmv_dia_batched(A, Xt), 10)
            Xt = Xt.to(torch.bfloat16)
            lane_ms["spmv_dia_batched_bf16"][k_t] = timed(lambda: spmv_dia_batched_bf16(A16, Xt),
                                                          10)
            del Xt
        vt = [lanes_of(k_t, N, 691 + i, 1e-3) for i in range(9)]
        at = torch.full((k_t,), 1e-3, device=dev)
        mt = torch.empty_like(vt[8])
        if k_t != KB:
            lane_ms["fused_iter_batched"][k_t] = timed(
                lambda: fused_iter_batched(A.data, A.offsets, *vt, mt, inv_a, at, at), 10)
        lane_ms["fused_iter_bf16band"][k_t] = timed(
            lambda: fused_iter_batched(A16.data, A.offsets, *vt, mt, inv_a, at, at), 10)
        del vt, mt
    a8 = torch.full((KB,), 1e-3, device=dev)
    Xa, Xq = lanes_of(KB, N, 700), lanes_of(KB, QN, 701)
    vq = [lanes_of(KB, QN, 710 + i, 1e-3) for i in range(10)]
    times["spmv_dia_batched"] = (timed(lambda: spmv_dia_batched(A, Xa), 10),
                                 timed(lambda: spmv_dia_batched_ref(A.data, A.offsets, Xa), 2, 3))
    Xa16 = Xa.to(torch.bfloat16)
    times["spmv_dia_batched_bf16"] = (
        timed(lambda: spmv_dia_batched_bf16(A16, Xa16), 10),
        timed(lambda: spmv_dia_batched_bf16_ref(A16.data, A.offsets, Xa16), 2, 3))
    del Xa16
    times["spmv_bell_batched"] = (timed(lambda: spmv_bell_batched(QB, Xq), 10),
                                  timed(lambda: spmv_bell_batched_ref(QB.cols, QB.vals, Xq), 1, 3))
    times["fused_vma_batched"] = (timed(lambda: fused_vma_dots_batched(*vq, inv_q, a8, a8), 20),
                                  timed(lambda: fused_vma_dots_batched_ref(*vq, inv_q, a8, a8),
                                        2, 3))
    del vq
    va = [lanes_of(KB, N, 730 + i, 1e-3) for i in range(9)]
    m_out = torch.empty_like(va[8])
    times["fused_iter_batched"] = (
        timed(lambda: fused_iter_batched(A.data, A.offsets, *va, m_out, inv_a, a8, a8), 10),
        timed(lambda: fused_iter_batched_ref(A.data, A.offsets, *va, inv_a, a8, a8), 2, 3))
    del va, m_out
    offs_t = torch.tensor(A.offsets, device=dev)
    cols_t = torch.arange(N, device=dev)[:, None] + offs_t[None, :]
    valid = (cols_t >= 0) & (cols_t < N)
    crow = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(valid.sum(1), 0)
    csr_a = torch.sparse_csr_tensor(crow, cols_t[valid], A.data.t()[valid], size=(N, N),
                                    check_invariants=False)
    del cols_t, valid, crow
    # a yardstick, not a kernel of the port: cuSPARSE's SpMM sums each row in
    # its own order, so it is held at 1e-5 of the largest |y| (f32 reordering
    # of 125 products moves y by a few 1e-4 here), which a layout error exceeds
    y_lane = spmv_dia_batched(A, Xa)
    check("torch.sparse SpMM yardstick (poisson125)", (csr_a @ Xa.mT).mT, y_lane, rtol=1e-5,
          atol=1e-5 * float(y_lane.abs().max()))
    del y_lane
    library["spmv_dia_batched"] = timed(lambda: csr_a @ Xa.mT, 10)
    del csr_a
    torch.cuda.empty_cache()
    keep = QB.vals != 0  # the Bell form's real entries (padding slots hold 0)
    q_crow = torch.zeros(QN + 1, dtype=torch.int64, device=dev)
    q_crow[1:] = torch.cumsum(keep.sum(1), 0)
    csr_q = torch.sparse_csr_tensor(q_crow, QB.cols[keep].to(torch.int64), QB.vals[keep],
                                    size=(QN, QN), check_invariants=False)
    del keep, q_crow
    y_lane = spmv_bell_batched(QB, Xq)
    check("torch.sparse SpMM yardstick (Queen_4147)", (csr_q @ Xq.mT).mT, y_lane, rtol=1e-5,
          atol=1e-5 * float(y_lane.abs().max()))
    del y_lane
    library["spmv_bell_batched"] = timed(lambda: csr_q @ Xq.mT, 10)
    del csr_q, Xa, Xq
    torch.cuda.empty_cache()
    kd = A.n_diags

    def lane_work(kn, k_):
        """Least bytes and f32 operations of a lane entry at k_ lanes."""
        return {
            "fused_iter_batched": (kd * N * 4 + N * 4 + k_ * N * 72 + k_ * 21,
                                   k_ * (2 * kd * N + 23 * N)),
            "fused_iter_bf16band": (kd * N * 2 + N * 4 + k_ * N * 72 + k_ * 21,
                                    k_ * (2 * kd * N + 23 * N)),
            "spmv_dia_batched": (kd * N * 4 + k_ * N * 8, k_ * 2 * kd * N),
            "spmv_dia_batched_bf16": (kd * N * 2 + k_ * N * (2 + 4), k_ * 2 * kd * N),
            "fused_vma_batched": (QN * 4 + k_ * QN * 76 + k_ * 21, k_ * 23 * QN),
            "spmv_bell_batched": (QN * R * 8 + k_ * QN * 8, k_ * 2 * QN * R),
        }[kn]

    for kn in BATCHED:
        work[kn] = lane_work(kn, KB)
        bounds[kn] = bound_of(*work[kn], f32_peak)
        log(f"{kn} (k={KB}): {times[kn][0]:.4f} ms (bound {bounds[kn][0]:.4f} ms, "
            f"{bounds[kn][1]}, {100 * bounds[kn][0] / times[kn][0]:.0f}%), plain "
            f"{times[kn][1]:.3f} ms, library {library.get(kn, float('nan')):.4f} ms")
    lane_share: dict = {}
    for kn, by_k in lane_ms.items():
        by_k.setdefault(KB, times[kn][0])
        for k_t, ms in sorted(by_k.items()):
            bd = bound_of(*lane_work(kn, k_t), f32_peak)[0]
            log(f"{kn} k={k_t}: {ms:.4f} ms (bound {bd:.4f} ms, {100 * bd / ms:.1f}% of it)")
            lane_share.setdefault(kn, {})[k_t] = {"ms": ms, "bound_ms": bd, "share": bd / ms}
    record["lane_kernel_ms"] = lane_share

    # (b) solve_batched at a fixed 200 iterations, k = 1, 2, 4, 8, beside the
    # single solve; the bound of a batched iteration is its kernels' bounds
    def iteration_bound(label, k_):
        if label == "poisson125":
            return (kd * N * 4 + N * 4 + k_ * N * 72) / bw_peak * 1e3
        return (QN * R * 8 + k_ * QN * 8 + QN * 4 + k_ * QN * 76) / bw_peak * 1e3

    serve_ops = {"poisson125": (A, b), "Queen_4147 Bell": (QB, qb)}
    want_path = {"poisson125": ("fused_iter", {"fused_iter_batched", "spmv_dia_batched"}),
                 "Queen_4147 Bell": ("cuda", {"fused_vma_batched", "spmv_bell_batched"})}
    batched_ms = {}
    for label, (op, rhs) in serve_ops.items():
        p1 = repro_torch.plan(op, method="pipecg", engine="auto", M="jacobi", atol=0.0, rtol=0.0,
                              maxiter=TIMED_ITERS)
        r1 = p1.solve(rhs)
        single_ms = timed(lambda: p1.solve(rhs), 1) / r1.steps
        rows = {"single": {"ms_per_iteration": single_ms, "iterations": int(r1.iterations),
                           "bound_ms": iteration_bound(label, 1)}}
        for k_ in (1, 2, 4, 8):
            B = torch.stack([(1.0 + 0.25 * lane) * rhs for lane in range(k_)])
            p = repro_torch.plan(op, method="pipecg", engine="auto", M="jacobi", atol=0.0,
                                 rtol=0.0, maxiter=TIMED_ITERS)
            core, kernels_want = want_path[label]
            if p.describe()["core"] != core:
                fail(f"{label}: solve_batched resolved to core {p.describe()['core']}")
            for f in counters.values():
                f.launches = 0
            res = p.solve_batched(B)
            sync()
            launched = {kn for kn, f in counters.items() if f.launches}
            if launched != kernels_want:
                fail(f"{label} k={k_}: solve_batched launched {launched}, not {kernels_want}")
            ms = timed(lambda: p.solve_batched(B), 1)
            per_it = ms / res.steps
            rows[k_] = {"ms_per_iteration": per_it, "ms_per_rhs_iteration": per_it / k_,
                        "bound_ms": iteration_bound(label, k_),
                        "bound_per_rhs_ms": iteration_bound(label, k_) / k_,
                        "steps": res.steps, "lane_iterations": res.iterations.tolist()}
            log(f"{label} solve_batched k={k_}: {per_it:.4f} ms per batched iteration, "
                f"{per_it / k_:.4f} ms per rhs-iteration (bound {iteration_bound(label, k_):.4f} / "
                f"{iteration_bound(label, k_) / k_:.4f}); lanes ran {res.iterations.tolist()} of "
                f"{res.steps} steps; single solve {single_ms:.4f} ms per iteration")
            del p, res, B
            gc.collect()
        batched_ms[label] = rows
        del p1
        gc.collect()
        torch.cuda.empty_cache()
    # the "cuda" core's bucket of 8 on poisson125(128), in f32 and with
    # spmv_engine="bf16": each step one lane SPMV (spmv_dia_batched or
    # spmv_dia_batched_bf16; three more at init, five f32 ones a residual
    # replacement) and one fused_vma lanes call
    B = torch.stack([(1.0 + 0.25 * lane) * b for lane in range(KB)])
    for label, kw, spmv_kn in (("poisson125 cuda", {}, "spmv_dia_batched"),
                               ("poisson125 cuda+bf16", {"spmv_engine": "bf16"},
                                "spmv_dia_batched_bf16")):
        p = repro_torch.plan(A, method="pipecg", engine="cuda", M="jacobi", atol=0.0, rtol=0.0,
                             maxiter=TIMED_ITERS, **kw)
        if p.describe()["core"] != "cuda":
            fail(f"{label}: solve_batched resolved to core {p.describe()['core']}")
        for f in counters.values():
            f.launches = 0
        res = p.solve_batched(B)
        sync()
        got = {kn: f.launches for kn, f in counters.items() if f.launches}
        re_ = p.describe()["replace_every"]
        replaced = sum(1 for it in range(1, res.steps) if re_ and (it + 1) % re_ == 0)
        want = {spmv_kn: res.steps + 3, "fused_vma_batched": res.steps}
        if replaced:
            want["spmv_dia_batched"] = 5 * replaced
        if got != want:
            fail(f"{label}: solve_batched launched {got}, not {want}")
        per_it = timed(lambda: p.solve_batched(B), 1) / res.steps
        bound = (lane_work(spmv_kn, KB)[0] + N * 4 + KB * N * 76) / bw_peak * 1e3
        batched_ms[label] = {KB: {"ms_per_iteration": per_it, "ms_per_rhs_iteration": per_it / KB,
                                  "bound_ms": bound, "bound_per_rhs_ms": bound / KB,
                                  "steps": res.steps, "launches": got}}
        log(f"{label} solve_batched k={KB}: {per_it:.4f} ms per batched iteration, "
            f"{per_it / KB:.4f} ms per rhs-iteration (bound {bound:.4f} / {bound / KB:.4f}); "
            f"launches {got}")
        del p, res
        gc.collect()
    del B
    record["solve_batched"] = batched_ms

    # the "bf16" SPMV engine's bucket of 8 on poisson125(128): its init SPMV
    # is the bf16 lane entry (the f32 one replaces the residual every 5
    # iterations); each lane must converge, with plan.solve's iterations and
    # x. The lanes' bf16 roundings differ with their scale, so they stop at
    # different iterations: the bucket freezes lanes one by one
    pb = repro_torch.plan(A, method="pipecg", engine="auto", M="jacobi", spmv_engine="bf16",
                          replace_every=5, atol=0.0, rtol=1e-2, maxiter=300)
    B = torch.stack([(1.0 + 0.25 * lane) * b for lane in range(KB)])
    singles = [pb.solve(B[lane]) for lane in range(KB)]
    for f in counters.values():
        f.launches = 0
    res = pb.solve_batched(B)
    sync()
    bf16_launches = {kn: f.launches for kn, f in counters.items()}
    launched = {kn for kn, f in bf16_launches.items() if f}
    if not {"spmv_dia_batched_bf16", "fused_iter_batched"} <= launched or launched - set(BATCHED):
        fail(f"poisson125 bf16 bucket launched {launched}")
    bf16_bits = True
    for lane, one in enumerate(singles):
        dx = float((res.x[lane] - one.x).norm() / one.x.norm())
        if int(res.iterations[lane]) != int(one.iterations) or not dx <= 1e-5:
            fail(f"poisson125 bf16 bucket lane {lane}: {int(res.iterations[lane])} iterations, "
                 f"plan.solve {int(one.iterations)}; |dx|/|x| {dx:.3e}")
        if not (bool(one.converged) and bool(res.converged[lane])):
            fail(f"poisson125 bf16 bucket lane {lane}: did not converge in "
                 f"{int(one.iterations)} iterations")
        bf16_bits &= bool(torch.equal(res.x[lane], one.x))
    if len(set(res.iterations.tolist())) < 2:
        fail(f"poisson125 bf16 bucket: every lane ran {res.iterations.tolist()} iterations, "
             f"no lane froze before another")
    record["bf16_bucket"] = {"iterations": res.iterations.tolist(), "x_bits_equal": bf16_bits,
                             "launches": bf16_launches}
    log(f"poisson125 bf16 bucket (k={KB}): lanes converged in {res.iterations.tolist()} iterations, "
        f"each plan.solve's on a spmv_engine='bf16' plan (x bit for bit: {bf16_bits}); launches "
        f"{ {kn: v for kn, v in bf16_launches.items() if v} }")
    del pb, B, singles, res
    gc.collect()

    # (c) a SolverServer on both operators: 64 seeded requests each, scales
    # over two decades, atol in two decades (so two pooled plans each),
    # rtol 1e-3; every answer held against plan.solve of the same rhs
    A64 = A.with_dtype(torch.float64)
    Q64 = Q.with_dtype(torch.float64)

    def true_rel_residual(op64, rhs, x):
        r64 = rhs.double() - spmv(op64, x.double(), engine="torch")
        return float(r64.norm() / rhs.double().norm())

    SERVE_N, SERVE_ATOLS, SERVE_RTOL = 64, (1e-7, 1e-6), 1e-3
    srv = SolverServer(max_batch=8, max_wait_ms=5.0, method="pipecg", engine="auto",
                       M="jacobi", rtol=SERVE_RTOL, maxiter=2000)
    serving = {}
    serve_launches = {}

    def serve_operator(label, op, op64, sd):
        """64 requests through ``srv`` against one operator, each answer held
        against plan.solve; returns the numbers (its locals free on return)."""
        rng = np.random.default_rng(sd)
        scales = 10.0 ** rng.uniform(-1.0, 1.0, SERVE_N)
        atols = [SERVE_ATOLS[i % 2] for i in range(SERVE_N)]
        RHS = lanes_of(SERVE_N, op.n, sd) / math.sqrt(op.n) * torch.tensor(
            scales, dtype=torch.float32, device=dev)[:, None]
        srv.pool.fingerprint(op)  # hashed once here, outside the timed burst
        for f in counters.values():
            f.launches = 0
        sync()
        # one lone request per tolerance decade builds each plan's single runner
        for i in range(2):
            srv.submit(op, RHS[i], atol=atols[i]).result(timeout=600)
        submitted, done = {}, {}
        t0 = time.perf_counter()
        futs = []
        for i in range(2, SERVE_N):
            submitted[i] = time.perf_counter()
            fut = srv.submit(op, RHS[i], atol=atols[i])
            fut.add_done_callback(lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
            futs.append((i, fut))
        results = {i: fut.result(timeout=600) for i, fut in futs}
        wall = time.perf_counter() - t0
        sync()
        serve_launches[label] = {kn: f.launches for kn, f in counters.items()}
        lat = sorted(done[i] - submitted[i] for i in results)
        occ = [r.bucket_occupancy for r in results.values()]
        # every answer against a direct solve of the same rhs on the card
        direct = {a: repro_torch.plan(op, method="pipecg", engine="auto", M="jacobi", atol=a,
                                      rtol=SERVE_RTOL, maxiter=2000) for a in SERVE_ATOLS}
        worst_x, worst_res, iters = 0.0, 0.0, []
        for i, r in results.items():
            ref = direct[atols[i]].solve(RHS[i])
            if r.iterations != int(ref.iterations) or not r.converged:
                fail(f"{label} request {i}: {r.iterations} iterations served, "
                     f"{int(ref.iterations)} by plan.solve (converged={r.converged})")
            dx = float((r.x - ref.x).norm() / ref.x.norm())
            tr = true_rel_residual(op64, RHS[i], r.x)
            if not dx <= 1e-5 or not tr < 1e-2:
                fail(f"{label} request {i}: x differs by {dx:.3e} from plan.solve's, true "
                     f"residual {tr:.3e}")
            worst_x, worst_res = max(worst_x, dx), max(worst_res, tr)
            iters.append(r.iterations)
        plans_here = [e.plan for e in srv.entries() if e.plan is not None and e.plan.A is op]
        tc = sorted(p.trace_count for p in plans_here)
        if tc != [2] * len(SERVE_ATOLS):
            fail(f"{label}: trace_count per plan {tc}, expected 2 each (single + bucket of 8)")
        missing = [kn for kn in want_path[label][1] if not serve_launches[label][kn]]
        if missing:
            fail(f"{label}: the served run launched no {missing}")
        stats = {
            "requests": SERVE_N, "burst": len(results), "requests_per_s": len(results) / wall,
            "p50_ms": lat[len(lat) // 2] * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))] * 1e3,
            "occupancy_mean": sum(occ) / len(occ), "trace_counts": tc,
            "iterations_min": min(iters), "iterations_max": max(iters),
            "max_rel_dx": worst_x, "max_true_residual": worst_res,
            "launches": serve_launches[label],
        }
        log(f"{label} server: {stats['burst']} burst requests in {wall:.3f} s = "
            f"{stats['requests_per_s']:.1f} requests/s, latency p50 {stats['p50_ms']:.2f} ms "
            f"p99 {stats['p99_ms']:.2f} ms, bucket occupancy {stats['occupancy_mean']:.3f}, "
            f"iterations {min(iters)}-{max(iters)}, trace_count per plan {tc}; every answer = "
            f"plan.solve's iterations, max |dx|/|x| {worst_x:.2e}, max true residual "
            f"{worst_res:.2e}; launches {serve_launches[label]}")
        return stats

    for label, op, op64, sd in (("poisson125", A, A64, 800), ("Queen_4147 Bell", QB, Q64, 900)):
        serving[label] = serve_operator(label, op, op64, sd)
    srv.shutdown(drain=True)
    del A64, Q64, op, op64, serve_ops
    record["serving"] = serving

    # (d) a warm start: the server's plans into a manifest of builder recipes
    # (poisson125 n=128; a Bell builder over table1 Queen_4147), then a new
    # server from it, whose first requests must build no runner
    def bell_table1(name, scale=1.0, *, device=None):
        return bell_from_csr(csr_from_dia(table1_matrix(name, scale=scale, device=device)),
                             device=device)

    register_operator_builder("bell_table1", bell_table1, overwrite=True)
    specs = {srv.pool.fingerprint(A): operator_spec(A, "poisson125", n=128),
             srv.pool.fingerprint(QB): operator_spec(QB, "bell_table1", name="Queen_4147")}
    keys_before = sorted(e.key for e in srv.entries())
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as mdir:
        mpath = os.path.join(mdir, "plans.json")
        t0 = time.perf_counter()
        srv.save_manifest(mpath, operator_specs=specs)
        t_save = time.perf_counter() - t0
        del srv
        gc.collect()
        t0 = time.perf_counter()
        srv2 = SolverServer.from_manifest(mpath, device=dev)
        t_load = time.perf_counter() - t0
    keys_after = sorted(e.key for e in srv2.entries())
    if keys_after != keys_before:
        fail(f"warm start: pool keys {keys_after} != the saved server's {keys_before}")
    boot = {id(p): p.trace_count for p in srv2.plans()}
    if sorted(boot.values()) != [2] * len(keys_before):
        fail(f"warm start built {sorted(boot.values())} runners per plan, expected 2 each")
    for p in srv2.plans():
        rhs = lanes_of(1, p.n, 950)[0] / math.sqrt(p.n)
        cfg = p.config()
        srv2.submit(p.A, rhs, **cfg).result(timeout=600)
        for f in srv2.submit_many(p.A, [c * rhs for c in (2.0, 3.0, 5.0, 7.0)], **cfg):
            if not f.result(timeout=600).converged:
                fail("a request after the warm start did not converge")
    added = {str(p.describe()["operator"]) + f" atol={p.atol}": p.trace_count - boot[id(p)]
             for p in srv2.plans()}
    srv2.shutdown(drain=True)
    if any(added.values()):
        fail(f"requests after the warm start built runners: {added}")
    record["warm_start"] = {"save_s": t_save, "load_and_warm_s": t_load,
                            "plans": len(keys_after), "runners_added": added}
    log(f"warm start: manifest of {len(keys_before)} plans saved in {t_save:.1f} s, rebuilt and "
        f"warmed in {t_load:.1f} s onto the same pool keys; first requests added runners {added}")
    del srv2
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 5
    import contextlib
    import gc
    import io
    import tempfile

    from repro_torch.data import SyntheticConfig, batch_for_step
    from repro_torch.launch import train as launcher
    from repro_torch.train import (
        AdamWConfig,
        TrainConfig,
        TrainState,
        adamw_init,
        adamw_update,
        batch_to_device,
        init_train_state,
        make_train_step,
        next_token_loss,
        warmup_cosine,
    )

    del A, A27, Q, QB, b, qb, inv_a, inv_q
    gc.collect()
    torch.cuda.empty_cache()

    # (a) the launcher at the reduced config: 30 steps with checkpoints, then resumed to 40
    def run_launcher(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launcher.main(argv)
        out = buf.getvalue()
        for line in out.splitlines():
            log(f"  launcher: {line}")
        return out

    reduced_tensors = len(list(build_model(reduced(full_cfg)).empty_params("meta").parameters()))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as ckpt:
        args = ["--arch", "internlm2-1.8b", "--fused-optimizer", "--save-every", "10",
                "--ckpt-dir", ckpt]
        fused_adamw.launches = 0
        sync()
        first = run_launcher(args + ["--steps", "30"])
        second = run_launcher(args + ["--steps", "40"])
        sync()
        launches_5a = fused_adamw.launches
    printed = [float(x) for x in re.findall(r"loss=(\S+)", first + second)]
    if not printed or not all(math.isfinite(x) for x in printed):
        fail(f"launcher losses not finite: {printed}")
    for needle in ("device=cuda", "finished at step 30", "resumed from step 30",
                   "finished at step 40"):
        if needle not in first + second:
            fail(f"launcher output lacks {needle!r}")
    if "resumed" in first or launches_5a != 40 * reduced_tensors:
        fail(f"launcher: {launches_5a} fused_adam launches, expected 40 x {reduced_tensors}")
    log(f"launcher (reduced internlm2-1.8b, f32): 30 steps, resumed at 30, ran to 40; "
        f"losses {printed}; {launches_5a} fused_adam launches")
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the full-size trainer through the fused optimizer
    V = full_cfg.vocab_size
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    dc = SyntheticConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab_size=V, seed=0)
    sched = warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)

    def train(state, fused, n_steps):
        """n_steps from ``state``; per-step ms from CUDA events around each step."""
        step_fn = make_train_step(full_api, TrainConfig(
            optimizer=AdamWConfig(lr=TRAIN_LR, clip_norm=1.0, apply_fused=fused)),
            lr_schedule=sched)
        losses, events = [], []
        for s in range(n_steps):
            batch = batch_to_device(batch_for_step(dc, s), dev)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            state, metrics = step_fn(state, batch)
            ev[1].record()
            losses.append(metrics["loss"])
            events.append(ev)
        sync()
        return state, torch.stack(losses).tolist(), [a.elapsed_time(e) for a, e in events]

    held_out = range(TRAIN_STEPS, TRAIN_STEPS + 5)  # batches the 20 steps never see

    def eval_losses(params, steps):
        """The loss on the batches of ``steps`` (forward only)."""
        out = []
        with torch.no_grad():
            for s_ in steps:
                b_ = batch_to_device(batch_for_step(dc, s_), dev)
                out.append(next_token_loss(full_api.forward(params, b_), b_["tokens"]))
        return torch.stack(out).tolist()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(full_api, make_generator(0, dev))
    sync()
    init_s = time.perf_counter() - t0
    at_init = eval_losses(state.params, range(TRAIN_STEPS + 5))
    n_tensors = len(list(state.params.parameters()))
    fused_adamw.launches = flash_attention.launches = 0
    sync()
    t0 = time.perf_counter()
    state, losses, step_ms = train(state, True, TRAIN_STEPS)
    train_wall = time.perf_counter() - t0
    launches_5b = fused_adamw.launches
    flash_5b = flash_attention.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    held_after = eval_losses(state.params, held_out)  # before the profiled steps train on 20-21
    log(f"full internlm2-1.8b ({n_model:,} parameters, bf16, {n_tensors} tensors) trained "
        f"{TRAIN_STEPS} steps at batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: losses {losses}")
    if not all(math.isfinite(x) for x in losses):
        fail("a full-size training loss is not finite")
    if abs(losses[0] - math.log(V)) > 0.5:
        fail(f"step-0 loss {losses[0]:.4f} is not within 0.5 of ln V = {math.log(V):.4f}")
    head, tail = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    held_init = at_init[TRAIN_STEPS:]
    log(f"step losses: first 5 mean {head:.4f}, last 5 mean {tail:.4f}; the initial model's "
        f"loss on batches 0-{TRAIN_STEPS + 4}: {at_init}; held-out batches "
        f"{TRAIN_STEPS}-{TRAIN_STEPS + 4} after {TRAIN_STEPS} steps: {held_after}")
    if not tail < head:
        fail(f"the mean of the last five step losses {tail:.4f} is not below the first five's "
             f"{head:.4f}")
    if not statistics.mean(held_after) < statistics.mean(held_init):
        fail(f"the loss on the held-out batches did not fall: {held_init} -> {held_after}")
    if n_tensors != 219 or launches_5b != TRAIN_STEPS * n_tensors or flash_5b != 0:
        fail(f"full-size run: {launches_5b} fused_adam launches for {n_tensors} tensors x "
             f"{TRAIN_STEPS} steps, {flash_5b} flash_attn launches")
    ms_step = statistics.median(step_ms[5:])
    tok_s = tokens_per_step / (ms_step / 1e3)
    flops_share = 6 * n_model * tokens_per_step / bf16_peak / (ms_step / 1e3)

    # where a step's device time goes: torch.profiler over two more steps
    from torch.profiler import ProfilerActivity, profile

    def kernel_class(kname):
        low = kname.lower()
        for cls, keys in (("fused_adam", ("fused_adamw",)),
                          ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "matmul", "sm90")),
                          ("softmax", ("softmax",)),
                          ("embedding", ("embedding", "index", "scatter", "gather")),
                          ("reduction", ("reduce", "norm")),
                          ("elementwise", ("elementwise", "vectorized", "unrolled"))):
            if any(k in low for k in keys):
                return cls
        return "other"

    step_fn = make_train_step(full_api, TrainConfig(optimizer=AdamWConfig(
        lr=TRAIN_LR, clip_norm=1.0, apply_fused=True)), lr_schedule=sched)
    prof_batches = [batch_to_device(batch_for_step(dc, s_), dev)
                    for s_ in range(TRAIN_STEPS, TRAIN_STEPS + 2)]
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b_ in prof_batches:
            state, _ = step_fn(state, b_)
        sync()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for evt in prof.key_averages():  # the kernels themselves, not the ops that launched them
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            t_us = getattr(evt, "self_device_time_total", None)
            if t_us is None:
                t_us = evt.self_cuda_time_total
            if t_us > 0:
                by_kernel[evt.key] = (t_us / 1e3 / 2, evt.count // 2)
    if by_kernel:
        device_ms = sum(t for t, _ in by_kernel.values())
        by_class = {}
        for kname, (t, c) in by_kernel.items():
            cls = kernel_class(kname)
            by_class[cls] = (by_class.get(cls, (0.0, 0))[0] + t, by_class.get(cls, (0.0, 0))[1] + c)
        breakdown = {"step_wall_ms_profiled": prof_wall_ms / 2, "device_ms": device_ms,
                     "by_class": {k: {"ms": t, "launches": c} for k, (t, c) in
                                  sorted(by_class.items(), key=lambda kv: -kv[1][0])},
                     "top": [{"kernel": k[:120], "ms": t, "launches": c} for k, (t, c) in
                             sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]]}
        log(f"profiled step (torch.profiler, mean of 2; host clock {prof_wall_ms / 2:.2f} ms "
            f"with the profiler on): kernels busy {device_ms:.2f} ms")
        for cls, v in breakdown["by_class"].items():
            log(f"  {cls}: {v['ms']:.2f} ms in {v['launches']} launches")
        for row in breakdown["top"]:
            log(f"  {row['ms']:8.3f} ms x{row['launches']:4d}  {row['kernel']}")
    else:
        breakdown = "not measured: torch.profiler recorded no device time"
        log(f"profiled step: {breakdown}")

    # the optimizer phase alone (global norm, clip, hyper, 219 fused launches)
    named = dict(state.params.named_parameters())
    g_ = torch.Generator(device=dev)
    g_.manual_seed(1)
    grads = {k_: (torch.randn(t.shape, generator=g_, device=dev) * 1e-3).to(t.dtype)
             for k_, t in named.items()}
    holder = {"opt": state.opt}
    lr_t = torch.full((), 1e-4, device=dev)
    fused_cfg = AdamWConfig(lr=TRAIN_LR, clip_norm=1.0, apply_fused=True)

    def optimizer_phase():
        _, holder["opt"], _ = adamw_update(named, grads, holder["opt"], fused_cfg, lr=lr_t)

    opt_ms = timed(optimizer_phase, 1)
    if isinstance(breakdown, dict):
        breakdown["idle_share"] = 1 - breakdown["device_ms"] / ms_step
        log(f"device idle share of a step: {breakdown['idle_share']:.3f} (kernel time of the "
            f"profiled steps against the {ms_step:.2f} ms unprofiled step)")
    log(f"full-size step: {ms_step:.2f} ms (median of steps 5-{TRAIN_STEPS - 1}; all "
        f"{[round(x, 2) for x in step_ms]}), {tok_s:.0f} tokens/s, "
        f"{100 * flops_share:.1f}% of 6 N tokens / {bf16_peak / 1e12:.0f} TFLOP/s; optimizer "
        f"phase {opt_ms:.3f} ms (fused pass bound {model_adam_bound:.3f} ms; the pass alone "
        f"{model_adam_ms:.3f} ms); peak memory {peak_bytes / 2**30:.2f} GiB; init {init_s:.1f} s, "
        f"{TRAIN_STEPS} steps {train_wall:.1f} s on the host clock")
    del state, named, grads, holder
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the plain (tree) optimizer from the same init
    state = init_train_state(full_api, make_generator(0, dev))
    before = fused_adamw.launches
    state, plain_losses, plain_step_ms = train(state, False, PLAIN_STEPS)
    if fused_adamw.launches != before:
        fail("the plain optimizer launched fused_adam")
    if plain_losses[:2] != losses[:2]:
        fail(f"fused and plain paths differ before any lr: {plain_losses[:2]} vs {losses[:2]}")
    loss_diff = max(abs(a - b_) for a, b_ in zip(plain_losses, losses))
    if loss_diff > PLAIN_LOSS_ATOL:
        fail(f"fused and plain losses differ by {loss_diff:.3e}: {plain_losses} vs "
             f"{losses[:PLAIN_STEPS]}")
    log(f"plain optimizer from the same init: losses {plain_losses} (max |diff| {loss_diff:.3e}), "
        f"steps {[round(x, 2) for x in plain_step_ms]} ms")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    record["training"] = {
        "launcher_losses": printed, "launcher_fused_adam_launches": launches_5a,
        "arch": full_cfg.name, "n_params": n_model, "n_tensors": n_tensors,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR, "warmup": TRAIN_WARMUP,
        "losses": losses, "first5_mean": head, "last5_mean": tail,
        "loss_at_init_by_batch": at_init, "held_out_after": held_after,
        "step_ms": step_ms, "ms_per_step": ms_step, "tokens_per_s": tok_s,
        "share_of_6N_tokens_at_peak": flops_share, "optimizer_phase_ms": opt_ms,
        "fused_pass_ms": model_adam_ms, "fused_pass_bound_ms": model_adam_bound,
        "peak_memory_bytes": peak_bytes, "fused_adam_launches": launches_5b,
        "plain_losses": plain_losses, "plain_step_ms": plain_step_ms,
        "plain_max_abs_loss_diff": loss_diff, "init_s": init_s, "train_wall_s": train_wall,
        "profile": breakdown,
    }

    # ------------------------------------------------------------------ 7
    # the paper's hybrid methods on the card and the host's cores
    import repro_torch.obs as obs
    from repro_torch.core.distributed import _local_spmv, reductions_per_iteration
    from repro_torch.core.perfmodel import decompose, measure_spmv_time, relative_weights

    t7 = time.perf_counter()
    # phases 2-4's operator went before training (5): built again, with
    # phase 3's right-hand side
    A = poisson125(128, device=dev)
    b = spmv(A, torch.full((A.n,), 1.0 / math.sqrt(A.n), device=dev))
    hybrid_counters = {"spmv_dia": spmv_dia_cuda, "fused_vma": fused_vma_dots,
                       "spmv_dia_batched": spmv_dia_batched,
                       "fused_vma_batched": fused_vma_dots_batched,
                       "fused_iter": fused_iter_step, "fused_iter_batched": fused_iter_batched}

    def hybrid_run(p, rhs):
        """One solve (or a batched one for (k, n) rhs), the counters at 0
        just before it and read just after."""
        for f in hybrid_counters.values():
            f.launches = 0
        sync()
        t = time.perf_counter()
        res = p.solve(rhs) if rhs.dim() == 1 else p.solve_batched(rhs)
        sync()
        wall = time.perf_counter() - t
        return res, wall, {kn: f.launches for kn, f in hybrid_counters.items() if f.launches}

    def f64_residual(op, rhs):
        """||rhs - A x|| / ||rhs|| in float64 on the card (plain torch ops)."""
        op64 = DIAMatrix(op.data.double(), op.offsets, op.n)
        rhs64 = rhs.double()

        def fn(xs):
            return float(torch.linalg.norm(rhs64 - spmv(op64, xs.double(), engine="torch"))
                         / torch.linalg.norm(rhs64))
        return fn

    def host_weights(op, w_model):
        """The model's weights, the host's raised (if it must be) to the
        least that leaves it the halo width in rows (an unequal shard
        holds at least the bandwidth)."""
        hw_ = op.bandwidth
        w = np.asarray(w_model, dtype=np.float64)
        cut = decompose(op, 2, w)
        if cut[2] - cut[1] >= hw_:
            return w, cut
        cum = np.cumsum((op.data != 0).sum(dim=0).cpu().numpy(), dtype=np.float64)
        w0 = cum[op.n - hw_ - 1] / cum[-1]
        for _ in range(20):
            w = np.array([w0, 1.0 - w0])
            cut = decompose(op, 2, w)
            if cut[2] - cut[1] >= hw_:
                return w, cut
            w0 *= 1.0 - 1e-7
        fail(f"no weight leaves the host {hw_} rows")

    def shard_line(p, res, wall, iters_ref, label):
        st = p.last_stats
        waits = [{kind: round(s * 1e3, 3) for kind, s in w.items()} for w in st["wait_s"]]
        compute = [round((s - sum(w.values())) * 1e3, 3)
                   for s, w in zip(st["shard_s"], st["wait_s"])]
        out = dict(iterations=int(res.iterations), steps=res.steps, wall_s=wall,
                   ms_per_iteration=wall * 1e3 / max(int(res.iterations), 1),
                   ms_per_step=wall * 1e3 / max(res.steps, 1),
                   shard_loop_ms=[s * 1e3 for s in st["shard_s"]], shard_compute_ms=compute,
                   shard_wait_ms=waits, counts=st["counts"],
                   reductions_per_iteration=reductions_per_iteration(st),
                   single_card_iterations=iters_ref)
        log(f"{label}: {out['iterations']} iterations ({out['steps']} steps; single card "
            f"{iters_ref}), {wall * 1e3:.1f} ms, {out['ms_per_iteration']:.3f} ms per iteration, "
            f"{out['ms_per_step']:.3f} ms per step; reductions per iteration "
            f"{out['reductions_per_iteration']:.4f}; per shard loop ms "
            f"{[round(v, 1) for v in out['shard_loop_ms']]}, compute ms {compute}, wait ms {waits}")
        return out

    def check_card_shard(p, A_full, X, tag):
        """The card shard's three DIA operands on the path (the block's
        local band, part 1, and the two correction bands of part 2) through
        the path's wrapper (``_local_spmv``: ``spmv_dia_cuda``, or
        ``spmv_dia_batched`` for (k, n) lanes) and through the plain SPMV
        on the same tensors, with the kernels line's rule. X is the solve's
        x: the card's block of it, and the slabs the halo SPMV would place
        next to the corrections, are the inputs. Rank 0 has no left
        neighbour, so its left band is off the path; it gets the last hw
        entries of X all the same. Then part 1 plus the right correction,
        added as ``spmv_halo`` adds them, against the plain SPMV of the
        whole operator on the card shard's rows (not a kernels-line
        error: the sums run in another order)."""
        shard = p._runner(None if X.dim() == 1 else X.shape[0]).solver.shards[0]
        if not shard.on_card:
            fail(f"{tag}: shard 0 lies on {shard.device}")
        lanes, (lo, R, hw, m) = X.shape[:-1], (shard.lo, shard.rows, shard.hw, shard.edge)
        key = "spmv_dia" if X.dim() == 1 else "spmv_dia_batched"
        # the lanes' flags as the loop passes them: one lane inactive
        act = None if X.dim() == 1 else torch.arange(X.shape[0], device=dev) != 1
        pad = X.new_zeros(*lanes, m)
        cases = (("local", shard.local, X[..., lo: lo + R]),
                 ("left band", shard.left_band, torch.cat([X[..., X.shape[-1] - hw:], pad], -1)),
                 ("right band", shard.right_band, torch.cat([pad, X[..., lo + R: lo + R + hw]], -1)))
        out, got = {}, {}
        for label, op, v in cases:
            if op is None:
                continue
            v = v.contiguous()
            got[label] = _local_spmv(op, v, act)
            want = spmv(op, v, engine="torch")
            if act is not None:
                want = torch.where(act[:, None], want, torch.zeros_like(want))
            err = check(f"{key} {tag}, card shard {label}", got[label], want, **VEC)
            errs[key] = max(errs[key], err)
            out[label] = dict(rows=op.n, diagonals=op.n_diags, max_abs_err=err)
        y = got["local"].clone()
        y[..., R - m:] += got["right band"][..., :m]
        want = spmv(A_full, X, engine="torch")[..., lo: lo + R]
        if act is not None:
            want = torch.where(act[:, None], want, torch.zeros_like(want))
        out["rows of A x"] = dict(rows=R, max_abs_err=check(
            f"{tag}: the card shard's part 1 + correction vs A x", y, want, **VEC))
        log(f"{key} on the card shard's operands, {tag}: "
            + "; ".join(f"{k_} {v_.get('diagonals', A_full.n_diags)} diagonals x {v_['rows']} "
                        f"rows, max abs err {v_['max_abs_err']:.3e}" for k_, v_ in out.items()))
        return out

    hybrid: dict = {}
    # (a) one card shard equals the single-card cuda solve
    ref7 = repro_torch.plan(A, engine="cuda", M="jacobi", atol=0.0, rtol=SOLVE_RTOL,
                            maxiter=2000).solve(b)
    p1 = repro_torch.plan(A, method="h3", shards=1, M="jacobi", atol=0.0, rtol=SOLVE_RTOL,
                          maxiter=2000)
    if p1.describe()["mesh_devices"] != (str(A.device),):
        fail(f"shards=1: mesh {p1.describe()['mesh_devices']}, not the card")
    r1, w1, l1 = hybrid_run(p1, b)
    err1 = float((r1.x - ref7.x).abs().max())
    log(f"h3 shards=1 on the card: {int(r1.iterations)} iterations (plan engine=cuda: "
        f"{int(ref7.iterations)}), max |x - x_cuda| {err1:.3e}, {w1 * 1e3:.1f} ms, "
        f"launches {l1}")
    if int(r1.iterations) != int(ref7.iterations) or not err1 <= 1e-5:
        fail(f"h3 shards=1 differs from plan(A, engine='cuda'): {int(r1.iterations)} vs "
             f"{int(ref7.iterations)} iterations, max |dx| {err1:.3e}")
    if not (l1.get("spmv_dia") and l1.get("fused_vma")):
        fail(f"h3 shards=1 launched {l1}")
    hybrid["one_card_shard"] = dict(iterations=int(r1.iterations), max_abs_dx=err1, wall_s=w1,
                                    launches=l1)

    # (b) the paper's Method 3: h3 on the card and the host, rows cut by nnz
    # in proportion to each device's measured SPMV speed
    A_host = DIAMatrix(A.data.cpu(), A.offsets, A.n)
    t_card, t_host = measure_spmv_time(A), measure_spmv_time(A_host)
    w_model = relative_weights([t_card, t_host])
    w_used, cut = host_weights(A, w_model)
    log(f"Method 3 performance model: SPMV {t_card * 1e3:.4f} ms on the card, "
        f"{t_host * 1e3:.2f} ms on the host (each the shard's own SPMV over the whole operator, "
        f"median of 5); model weights {[round(float(v), 6) for v in w_model]}, used "
        f"{[round(float(v), 6) for v in w_used]} (the host holds at least the halo width "
        f"{A.bandwidth} rows); bounds {cut.tolist()}")
    # the model's prediction for each shard's block (whole-operator time x
    # the block's share of the rows) beside that block's SPMV, timed alone
    rows3 = np.diff(cut)
    block_pred = [t_card * rows3[0] / A.n, t_host * rows3[1] / A.n]
    block_meas = [measure_spmv_time(A, rows=int(rows3[0])),
                  measure_spmv_time(A_host, rows=int(rows3[1]))]
    del A_host
    log("Method 3 block SPMV, predicted by the model / measured alone (ms): card "
        f"{block_pred[0] * 1e3:.4f} / {block_meas[0] * 1e3:.4f} ({int(rows3[0])} rows), host "
        f"{block_pred[1] * 1e3:.4f} / {block_meas[1] * 1e3:.4f} ({int(rows3[1])} rows)")
    p3 = repro_torch.plan(A, method="h3", shards=2, devices=("cuda", "cpu"), partition="nnz",
                          weights=w_used, M="jacobi", atol=0.0, rtol=SOLVE_RTOL, maxiter=2000)
    d3 = p3.describe()
    if d3["shard_cores"] != ("cuda", "torch") or list(d3["shard_bounds"]) != cut.tolist():
        fail(f"Method 3 plan: {d3}")
    hybrid_run(p3, b)  # first solve: the pinned buffers and threads warm up
    r3, w3, l3 = hybrid_run(p3, b)
    tr3 = true_residual(r3.x)
    m3 = shard_line(p3, r3, w3, int(ref7.iterations), "Method 3 (h3, card + host)")
    log(f"Method 3: converged={bool(r3.converged)}, float64 true relative residual {tr3:.3e}, "
        f"launches {l3}")
    if not bool(r3.converged) or not tr3 < 1e-2:
        fail(f"Method 3 did not converge (true residual {tr3:.3e})")
    if abs(int(r3.iterations) - int(ref7.iterations)) > BASELINE_BAND:
        fail(f"Method 3 took {int(r3.iterations)} iterations, the single card "
             f"{int(ref7.iterations)}")
    if not (l3.get("spmv_dia") and l3.get("fused_vma")):
        fail(f"Method 3 launched {l3}")
    if m3["reductions_per_iteration"] != 1.0:
        fail(f"Method 3: {m3['reductions_per_iteration']} reductions per iteration, not 1")
    step_ms = [c / max(r3.steps, 1) for c in m3["shard_compute_ms"]]
    log(f"Method 3 per step, the shard's compute in the solve (ms): card {step_ms[0]:.4f}, host "
        f"{step_ms[1]:.4f} (part 1, the corrections and the core; the model predicts part 1: "
        f"{block_pred[0] * 1e3:.4f}, {block_pred[1] * 1e3:.4f})")
    shard_checks3 = check_card_shard(p3, A, r3.x, "Method 3 poisson125(128)")
    # the card's idle share over one more solve (torch.profiler: kernel time / wall)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof7:
        t = time.perf_counter()
        p3.solve(b)
        sync()
        prof_wall = time.perf_counter() - t
    busy_us = 0.0
    for evt in prof7.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA") and not evt.key.startswith("Mem"):
            t_us = getattr(evt, "self_device_time_total", None)
            busy_us += evt.self_cuda_time_total if t_us is None else t_us
    idle = None if busy_us == 0 else 1.0 - busy_us / 1e3 / (prof_wall * 1e3)
    log(f"Method 3 card idle share: {'not measured' if idle is None else f'{idle:.4f}'} "
        f"(kernels busy {busy_us / 1e3:.2f} ms of {prof_wall * 1e3:.1f} ms, profiler on)")
    hybrid["method3"] = dict(m3, spmv_s_card=t_card, spmv_s_host=t_host,
                             weights_model=[float(v) for v in w_model],
                             weights_used=[float(v) for v in w_used], bounds=cut.tolist(),
                             true_residual=tr3, launches=l3, card_idle_share=idle,
                             card_busy_ms=busy_us / 1e3, profiled_wall_ms=prof_wall * 1e3,
                             block_spmv_ms_predicted=[v * 1e3 for v in block_pred],
                             block_spmv_ms_measured=[v * 1e3 for v in block_meas],
                             shard_compute_ms_per_step=step_ms, card_shard_checks=shard_checks3)

    # (c) the other methods on the card and the host at poisson125(64)
    A7 = poisson125(64, device=dev)
    b7 = spmv(A7, torch.ones(A7.n, device=dev) / math.sqrt(A7.n))
    resid7 = f64_residual(A7, b7)
    ref64 = repro_torch.plan(A7, engine="cuda", M="jacobi", atol=0.0, rtol=SOLVE_RTOL,
                             maxiter=2000).solve(b7)
    card_host = ("cuda", "cpu")
    methods7 = {"h1": (dict(shards=2, devices=card_host), 3.0),
                "h2": (dict(shards=2, devices=card_host), 1.0),
                "pl2": (dict(shards=2, devices=card_host), 0.5),
                "pl3": (dict(shards=2, devices=card_host), 1.0 / 3.0),
                "h4": (dict(shards=4, sub=2, devices=("cuda", "cpu", "cpu", "cpu")), 2.0)}
    hybrid["methods"] = {}
    for m, (kw, want_red) in methods7.items():
        pm = repro_torch.plan(A7, method=m, M="jacobi", atol=0.0, rtol=SOLVE_RTOL, maxiter=2000,
                              **kw)
        rm, wm, lm = hybrid_run(pm, b7)
        row = shard_line(pm, rm, wm, int(ref64.iterations), f"{m} poisson125(64) {kw['devices']}")
        row.update(true_residual=resid7(rm.x), launches=lm, converged=bool(rm.converged))
        if not row["converged"] or not row["true_residual"] < 1e-2:
            fail(f"{m}: converged={row['converged']}, true residual {row['true_residual']:.3e}")
        if abs(row["reductions_per_iteration"] - want_red) > 1e-12:
            fail(f"{m}: {row['reductions_per_iteration']} reductions per iteration, not {want_red}")
        if abs(row["iterations"] - int(ref64.iterations)) > BASELINE_BAND:
            fail(f"{m}: {row['iterations']} iterations, the single card {int(ref64.iterations)}")
        if not lm.get("spmv_dia"):
            fail(f"{m}: the card shard launched no spmv_dia ({lm})")
        hybrid["methods"][m] = row
        del pm

    # (d) solve_batched, k = 4, on the hybrid h3 plan at poisson125(64)
    w7, cut7 = host_weights(A7, w_model)
    pb = repro_torch.plan(A7, method="h3", shards=2, devices=card_host, partition="nnz",
                          weights=w7, M="jacobi", atol=0.0, rtol=SOLVE_RTOL, maxiter=2000)
    gb = torch.Generator(device=dev)
    gb.manual_seed(7)
    B7 = torch.stack([b7, 0.5 * b7] + [spmv(A7, torch.randn(A7.n, generator=gb, device=dev))
                                       for _ in range(2)])
    rb, wb, lb = hybrid_run(pb, B7)
    if not (lb.get("spmv_dia_batched") and lb.get("fused_vma_batched")):
        fail(f"hybrid solve_batched launched {lb}")
    lanes7 = []
    for lane in range(B7.shape[0]):
        one = pb.solve(B7[lane])
        dx = float((rb.x[lane] - one.x).abs().max())
        lanes7.append(dict(iterations=int(rb.iterations[lane]), single=int(one.iterations),
                           max_abs_dx=dx))
        if int(rb.iterations[lane]) != int(one.iterations) or not dx <= 1e-6:
            fail(f"hybrid solve_batched lane {lane}: {lanes7[-1]}")
    log(f"hybrid h3 solve_batched k=4 at poisson125(64), bounds {cut7.tolist()}: "
        f"{wb * 1e3:.1f} ms, lanes {lanes7}, launches {lb}")
    shard_checks_b = check_card_shard(pb, A7, rb.x, "hybrid bucket of 4 poisson125(64)")
    hybrid["batched"] = dict(bounds=cut7.tolist(), weights=[float(v) for v in w7], wall_s=wb,
                             lanes=lanes7, launches=lb, card_shard_checks=shard_checks_b,
                             ms_per_batched_step=wb * 1e3 / max(rb.steps, 1))

    # (e) a SolveReport of one Method 3 solve, stamped with the card and its limit
    obs.enable()
    try:
        p3.solve(b)
        rep = p3.last_report
    finally:
        obs.disable()
    log(rep.summary())
    if rep.env.get("device_kind") != name or not rep.env.get("power_limit") \
            or rep.env["power_limit"] not in card:
        fail(f"the report's environment does not name the card and its limit: {rep.env}")
    hybrid["report"] = rep.to_dict()
    hybrid["phase_s"] = time.perf_counter() - t7
    log(f"phase 7 took {hybrid['phase_s']:.1f} s")
    record["hybrid"] = hybrid
    del p1, p3, pb, A7, b7, B7, A, b

    # ------------------------------------------------------------------ 8
    # LM serving at full width: internlm2-1.8b and olmoe-1b-7b in bf16
    import dataclasses

    from repro_torch.launch import precision
    from repro_torch.launch.precision import as_f32, decode_vs_forward, host_copy, rows_err
    from repro_torch.launch.roofline import HW
    from repro_torch.launch.serve_lm import decode_step_bytes, decode_step_cross_flops, extras_for
    from repro_torch.serve import ServeConfig, generate, prefill_cache

    gc.collect()
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    wrappers = {**counters, "fused_adam": fused_adamw, "flash_attn": flash_attention}
    for w in wrappers.values():
        w.launches = 0
    sync()

    def serve_cell(arch, phase, t_phase, prompt_len=LM_PROMPT, gate=None):
        """Seeded random weights, prompts and (encdec, vlm) stub frames or
        image features; with ``gate``, every cross gate set to it; generate
        twice (equal tokens); prefill ms, ms per decode step (CUDA events,
        greedy tokens fed back), tokens/s, peak memory and the decode step's
        bytes bound (and the cross K/V's FLOP bound). Returns (api, params,
        the batch, the record)."""
        cfg = get_config(arch)
        api = build_model(cfg)
        held = torch.cuda.memory_allocated()  # what earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = api.init_params(make_generator(0, dev))
        if gate is not None:
            with torch.no_grad():
                for lp in params["cross_layers"]:
                    lp["cross"]["gate"].fill_(gate)
        prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, prompt_len), device=dev,
                                generator=make_generator(1, dev), dtype=torch.int32)
        batch = {"tokens": prompts,
                 **extras_for(cfg, LM_BATCH, make_generator(2, dev), api.dtype, dev)}
        sc = ServeConfig(max_new_tokens=LM_NEW)
        sync()
        init_s = time.perf_counter() - t0
        walls, outs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            outs.append(generate(api, params, batch, sc))
            sync()
            walls.append(time.perf_counter() - t0)
        if not torch.equal(outs[0], outs[1]):
            fail(f"{arch}: two generate calls gave different tokens")
        out = outs[0]
        if out.shape != (LM_BATCH, prompt_len + LM_NEW) or not torch.equal(out[:, :prompt_len],
                                                                           prompts):
            fail(f"{arch}: generate returned {tuple(out.shape)} or changed the prompt")
        if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
            fail(f"{arch}: a generated token lies outside the vocabulary")
        with torch.no_grad():
            prefill_ms = timed(lambda: api.prefill(params, batch), 1, 3)
            logits, cache = prefill_cache(api, params, batch, prompt_len + LM_NEW)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            finite = bool(torch.isfinite(logits).all())
            del logits
            step_ms = []
            for i in range(LM_NEW):
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                lg, cache = api.decode(params, tok, cache, prompt_len + i)
                tok = lg[:, -1].argmax(-1, keepdim=True)
                ev[1].record()
                step_ms.append(ev)
            sync()
            step_ms = [a.elapsed_time(e_) for a, e_ in step_ms]
            finite &= bool(torch.isfinite(lg).all())
        if not finite:
            fail(f"{arch}: prefill or decode logits are not finite")
        ms_step = statistics.median(step_ms)
        bound_bytes = decode_step_bytes(cfg, LM_BATCH, prompt_len + LM_NEW)
        bound_ms = bound_bytes / HW["hbm_bw"] * 1e3
        flops = decode_step_cross_flops(cfg, LM_BATCH)
        peak = torch.cuda.max_memory_allocated() - held
        rec = {"arch": arch, "n_params": api.n_params(), "batch": LM_BATCH,
               "prompt": prompt_len, "new_tokens": LM_NEW, "generate_s": walls,
               "prefill_ms": prefill_ms, "decode_step_ms": step_ms, "ms_per_decode_step": ms_step,
               "decode_tokens_per_s": LM_BATCH / (ms_step / 1e3),
               "decode_bound_bytes": bound_bytes, "decode_bound_ms": bound_ms,
               "peak_memory_bytes": peak, "tokens_row0": out[0, prompt_len:].tolist(),
               "init_s": init_s, "held_by_earlier_phases_bytes": held}
        if flops:
            rec.update(cross_kv_flops=flops, cross_kv_flop_bound_ms=flops / bf16_peak * 1e3)
            log(f"  {arch}: the cross K/V recomputed a decode step: {flops:,} FLOPs, "
                f"{flops / bf16_peak * 1e3:.4f} ms at {bf16_peak / 1e12:.0f} TFLOP/s")
        log(f"{arch} ({api.n_params():,} parameters, bf16; init {init_s:.1f} s) served "
            f"{LM_BATCH} x {prompt_len} prompts, {LM_NEW} greedy tokens: generate {walls[0]:.3f} s, "
            f"again {walls[1]:.3f} s (equal tokens; {LM_BATCH * LM_NEW / walls[1]:.1f} tokens/s "
            f"with the prefill); prefill {prefill_ms:.3f} ms; decode step {ms_step:.4f} ms (median "
            f"of {LM_NEW}; bound {bound_ms:.4f} ms: {bound_bytes:,} bytes at "
            f"{HW['hbm_bw'] / 1e12:.2f} TB/s), {LM_BATCH / (ms_step / 1e3):.1f} tokens/s; peak "
            f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB earlier phases hold")

        # where a decode step's time goes: torch.profiler over PROF_STEPS more steps
        t0 = time.perf_counter()
        with torch.no_grad():
            pos0 = prompt_len + LM_NEW - PROF_STEPS  # positions decoded again
            sync()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                for i in range(PROF_STEPS):
                    lg, cache = api.decode(params, tok, cache, pos0 + i)
                    tok = lg[:, -1].argmax(-1, keepdim=True)
                sync()
                wall = (time.perf_counter() - t1) * 1e3 / PROF_STEPS
        by_class, busy = {}, 0.0
        for evt in prof.key_averages():
            if str(getattr(evt, "device_type", "")).endswith("CUDA"):
                t_us = getattr(evt, "self_device_time_total", None)
                t_us = evt.self_cuda_time_total if t_us is None else t_us
                if t_us > 0:
                    cls = kernel_class(evt.key)
                    ms_, n_ = by_class.get(cls, (0.0, 0))
                    by_class[cls] = (ms_ + t_us / 1e3 / PROF_STEPS, n_ + evt.count // PROF_STEPS)
                    busy += t_us / 1e3 / PROF_STEPS
        if busy:
            rec["profile"] = {"step_wall_ms_profiled": wall, "device_ms": busy,
                              "idle_share": 1 - busy / ms_step,
                              "launches_per_step": sum(n_ for _, n_ in by_class.values()),
                              "by_class": {k_: {"ms": t_, "launches": n_} for k_, (t_, n_) in
                                           sorted(by_class.items(), key=lambda kv: -kv[1][0])}}
            log(f"  profiled decode step (mean of {PROF_STEPS}; host clock {wall:.3f} ms with the "
                f"profiler on; {time.perf_counter() - t0:.1f} s with its set-up and tally): "
                f"kernels busy {busy:.4f} ms in {rec['profile']['launches_per_step']} launches, "
                f"idle share {1 - busy / ms_step:.3f} of the {ms_step:.4f} ms step; " + ", ".join(
                    f"{k_} {v_['ms']:.4f} ms x{v_['launches']}"
                    for k_, v_ in rec["profile"]["by_class"].items()))
        else:
            rec["profile"] = "not measured: torch.profiler recorded no device time"
            log(f"  profiled decode step: {rec['profile']}")
        del cache
        log(f"  {time.perf_counter() - t_phase:.1f} s into phase {phase}")
        return api, params, batch, rec

    def teacher_forced(label, forced, full) -> dict:
        """Fails where a teacher-forced row is beyond TF_ROW of the forward's."""
        err = rows_err(forced, full)
        same = float((forced.argmax(-1) == full.argmax(-1)).float().mean())
        log(f"  {label}: teacher-forced decode of {forced.shape[1]} positions against the full "
            f"forward: largest per-row ||d||/||ref|| {err:.3e} (limit {TF_ROW:.0e}); argmax "
            f"equal at {same:.4f} of the positions")
        if not err <= TF_ROW:
            fail(f"{label}: teacher-forced decode differs from the forward by {err:.3e}")
        return {"teacher_forced_row_err": err, "teacher_forced_argmax_equal": same}

    def card_vs_host(label, cfg2, prompt_len, seeds=(2,), limit=F32_ROW, gate=None) -> dict:
        """A cut f32 model at full width (TF32 off) on a (2, prompt_len)
        prompt of each seed (with seeded stub frames or image features
        where the family takes them; every cross gate set to ``gate``): the
        card's 8 greedy tokens equal the host CPU's, prefill and one decode
        step's logits within ``limit`` per row
        (``launch.precision.card_vs_host``)."""
        api = build_model(cfg2)
        t0 = time.perf_counter()
        params = api.init_params(make_generator(0, dev))
        if gate is not None:
            with torch.no_grad():
                for lp in params["cross_layers"]:
                    lp["cross"]["gate"].fill_(gate)
        host = host_copy(api, params)
        log(f"{label}: init and host copy {time.perf_counter() - t0:.1f} s")
        out = {}
        for seed in seeds:
            prompts = torch.randint(0, cfg2.vocab_size, (2, prompt_len), device=dev,
                                    generator=make_generator(seed, dev), dtype=torch.int32)
            extras = extras_for(cfg2, 2, make_generator(seed + 100, dev), api.dtype, dev)
            t0 = time.perf_counter()
            r = precision.card_vs_host(api, params, host, prompts, extras)
            secs = time.perf_counter() - t0
            got, errs = r["tokens"], [r["prefill_row_err"], r["decode_row_err"]]
            same = torch.equal(got, r["host_tokens"])
            log(f"{label}, full width, prompt seed {seed}: the card's greedy tokens "
                f"{'equal' if same else 'DIFFER FROM'} the host's "
                f"({got[:, prompt_len:].tolist()}); logits per-row ||d||/||ref||: prefill "
                f"{errs[0]:.3e}, one decode step {errs[1]:.3e} (limit {limit:.0e}); {secs:.1f} s")
            if not same:
                fail(f"{label}: card tokens {got.tolist()} != host tokens "
                     f"{r['host_tokens'].tolist()}")
            if not max(errs) <= limit:
                fail(f"{label}: card and host logits differ by {max(errs):.3e}")
            out[f"seed{seed}"] = {"tokens": got.tolist(), "prefill_row_err": errs[0],
                                  "decode_row_err": errs[1], "seconds": secs}
        out["limit"] = limit
        return out

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    serving = {}
    # internlm2-1.8b: teacher-forced decode against the full forward
    api, params, batch, serving["internlm2-1.8b"] = serve_cell("internlm2-1.8b", "8", t8)
    serving["internlm2-1.8b"].update(teacher_forced(
        f"internlm2-1.8b, positions {LM_PROMPT - TF_STEPS}-{LM_PROMPT - 1}",
        *decode_vs_forward(api, params, batch["tokens"], LM_PROMPT - TF_STEPS, TF_STEPS)))
    log(f"  {time.perf_counter() - t8:.1f} s into phase 8")
    del api, params, batch
    release()

    api, params, batch, serving["olmoe-1b-7b"] = serve_cell("olmoe-1b-7b", "8", t8)
    del api, params, batch
    release()

    # a 2-layer olmoe-1b-7b at full width in f32 (TF32 off): the card against the host
    serving["olmoe-2layer-f32"] = card_vs_host(
        "2-layer f32 olmoe-1b-7b",
        dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=2, dtype="float32"), 32)
    release()

    launched = {k_: w.launches for k_, w in wrappers.items() if w.launches}
    if launched:
        fail(f"LM serving launched kernels of the port, where no path calls one: {launched}")
    serving["phase_s"] = time.perf_counter() - t8
    log(f"LM serving launched no kernel of the port (none lies on its path, in the JAX package "
        f"either); phase 8 took {serving['phase_s']:.1f} s")
    record["lm_serving"] = serving

    # ------------------------------------------------------------------ 9
    # SSM and hybrid serving at full width: zamba2-2.7b and xlstm-1.3b in bf16
    t9 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    ssm_serving = {}
    for arch in ("zamba2-2.7b", "xlstm-1.3b"):
        api, params, batch, rec = serve_cell(arch, "9", t9)
        prompts = batch["tokens"]
        t0 = api.cfg.chunk  # prefill one chunk, then decode the next positions
        forced16, full16 = decode_vs_forward(api, params, prompts, t0, TF_STEPS)
        # the gate runs in f32: these random-weight models are below bf16's
        # noise floor at full depth (the bf16 forward's own distance from
        # the f32 forward, recorded beside it)
        api32, p32 = as_f32(api, params, dev)
        del params
        release()
        forced32, full32 = decode_vs_forward(api32, p32, prompts, t0, TF_STEPS)
        rec.update(teacher_forced(f"{arch} in f32, positions {t0}-{t0 + TF_STEPS - 1}",
                                  forced32, full32))
        floor = rows_err(full16, full32)
        rec["bf16"] = {"decode_vs_forward_row_err": rows_err(forced16, full16),
                       "forward_vs_f32_forward_row_err": floor,
                       "decode_vs_f32_forward_row_err": rows_err(forced16, full32),
                       "limit": BF16_FLOOR * floor}
        log(f"  {arch} in bf16, per-row ||d||/||ref||: teacher-forced decode against the bf16 "
            f"forward {rec['bf16']['decode_vs_forward_row_err']:.3e}, against the f32 forward "
            f"{rec['bf16']['decode_vs_f32_forward_row_err']:.3e} (limit {BF16_FLOOR} x the bf16 "
            f"forward's own distance from the f32 forward, {floor:.3e})")
        worst = max(rec["bf16"]["decode_vs_forward_row_err"],
                    rec["bf16"]["decode_vs_f32_forward_row_err"])
        if not worst <= BF16_FLOOR * floor:
            fail(f"{arch}: bf16 teacher-forced decode lies {worst:.3e} per row from the forward, "
                 f"beyond {BF16_FLOOR} x the bf16 forward's distance from f32 ({floor:.3e})")
        ssm_serving[arch] = rec
        log(f"  {time.perf_counter() - t9:.1f} s into phase 9")
        del api, api32, p32, batch, prompts, forced16, full16, forced32, full32
        release()
    # one group of each at full width in f32 (TF32 off): the card against the host
    for arch, layers in (("zamba2-2.7b", 6), ("xlstm-1.3b", 8)):
        cfg2 = dataclasses.replace(get_config(arch), n_layers=layers, dtype="float32")
        ssm_serving[f"{arch}-{layers}layer-f32"] = card_vs_host(
            f"{layers}-layer f32 {arch}", cfg2, cfg2.chunk, CARD_HOST_SEEDS,
            F32_ROW_XLSTM if arch == "xlstm-1.3b" else F32_ROW)
        release()
    launched = {k_: w.launches for k_, w in wrappers.items() if w.launches}
    if launched:
        fail(f"SSM and hybrid serving launched kernels of the port, where no path calls one: "
             f"{launched}")
    ssm_serving["phase_s"] = time.perf_counter() - t9
    log(f"SSM and hybrid serving launched no kernel of the port (none lies on its path, in the "
        f"JAX package either); phase 9 took {ssm_serving['phase_s']:.1f} s")
    record["ssm_serving"] = ssm_serving

    # ------------------------------------------------------------------ 10
    # training at full width: the SSM and hybrid families under remat,
    # whisper-tiny, the VLM at its reduced config, the three remat modes
    t10 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    fam_train = {}

    def train_cell(arch, batch0, seq, steps, remat):
        """Seeded init, then ``steps`` fused-optimizer steps of seeded
        batches (extras in the model's dtype), the batch halved from
        ``batch0`` until the first step fits; per-step ms (CUDA events; the
        median of steps 1 on), tokens/s, peak memory above what earlier
        phases hold, fused_adam launches a step. Fails unless the step-0
        loss is within STEP0_TOL of ln V + STEP0_EXCESS, every grad norm is
        finite and the loss
        falls (batch 0's loss after the steps below its step-0 loss)."""
        cfg = get_config(arch)
        api = build_model(cfg)
        step_fn = make_train_step(api, TrainConfig(
            optimizer=AdamWConfig(lr=FAM_LR, clip_norm=1.0, apply_fused=True), remat=remat))
        held = torch.cuda.memory_allocated()

        def attempt(b):
            state = init_train_state(api, make_generator(0, dev))
            dc = SyntheticConfig(batch=b, seq_len=seq, vocab_size=cfg.vocab_size, seed=0)
            losses, gnorms, events = [], [], []
            for s_ in range(steps):
                batch = batch_to_device(batch_for_step(dc, s_, cfg), dev, api.dtype)
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                state, metrics = step_fn(state, batch)
                ev[1].record()
                losses.append(metrics["loss"])
                gnorms.append(metrics["grad_norm"])
                events.append(ev)
                if s_ == 0:
                    sync()  # the first step fits, or raises here
            sync()
            return state, losses, gnorms, events

        b = batch0
        while True:
            release()
            torch.cuda.reset_peak_memory_stats()
            before = fused_adamw.launches
            try:
                state, losses, gnorms, events = attempt(b)
                break
            except torch.cuda.OutOfMemoryError:
                if b == 1:
                    fail(f"{arch}: a training step at batch 1 x {seq} does not fit")
                log(f"  {arch}: batch {b} x {seq} does not fit; halving")
            b //= 2
        peak = torch.cuda.max_memory_allocated() - held
        losses, gnorms = torch.stack(losses).tolist(), torch.stack(gnorms).tolist()
        step_ms = [a.elapsed_time(e_) for a, e_ in events]
        n_tensors = len(list(state.params.parameters()))
        per_step = (fused_adamw.launches - before) / steps
        ms = statistics.median(step_ms[1:])
        rec = {"arch": arch, "n_params": api.n_params(), "remat": remat, "batch": b,
               "seq": seq, "steps": steps, "lr": FAM_LR, "losses": losses,
               "grad_norms": gnorms, "step_ms": step_ms, "ms_per_step": ms,
               "tokens_per_s": b * seq / (ms / 1e3), "peak_memory_bytes": peak,
               "held_by_earlier_phases_bytes": held, "fused_adam_launches_per_step": per_step,
               "n_tensors": n_tensors}
        log(f"{arch} ({api.n_params():,} parameters, {cfg.dtype}, remat={remat!r}) trained "
            f"{steps} steps at batch {b} x {seq}: losses {losses}, grad norms {gnorms}; "
            f"{ms:.2f} ms a step (median of steps 1-{steps - 1}; all "
            f"{[round(x, 2) for x in step_ms]}), {b * seq / (ms / 1e3):.0f} tokens/s, peak "
            f"{peak / 2**30:.2f} GiB above {held / 2**30:.2f} GiB held, {per_step:g} fused_adam "
            f"launches a step ({n_tensors} tensors)")
        if not all(math.isfinite(x) for x in losses + gnorms):
            fail(f"{arch}: a loss or grad norm is not finite")
        expect = math.log(cfg.vocab_size) + STEP0_EXCESS
        if abs(losses[0] - expect) > STEP0_TOL:
            fail(f"{arch}: step-0 loss {losses[0]:.4f} is not within {STEP0_TOL} of ln V + "
                 f"{STEP0_EXCESS} = {expect:.4f}")
        with torch.no_grad():  # batch 0 again, after the steps
            b0 = batch_to_device(batch_for_step(SyntheticConfig(
                batch=b, seq_len=seq, vocab_size=cfg.vocab_size, seed=0), 0, cfg), dev, api.dtype)
            after = float(next_token_loss(api.forward(state.params, b0), b0["tokens"]))
        rec["batch0_loss_after"] = after
        log(f"  {arch}: the loss on batch 0 went from {losses[0]:.4f} to {after:.4f} over the "
            f"{steps} steps")
        if not after < losses[0]:
            fail(f"{arch}: the loss did not fall: batch 0 {losses[0]:.4f} -> {after:.4f}")
        if per_step != n_tensors:
            fail(f"{arch}: {per_step} fused_adam launches a step for {n_tensors} tensors")
        del state
        release()
        return rec

    for arch in ("xlstm-1.3b", "zamba2-2.7b"):
        fam_train[arch] = train_cell(arch, FAM_BATCH, FAM_SEQ, FAM_STEPS, True)
        log(f"  {time.perf_counter() - t10:.1f} s into phase 10")
    fam_train["whisper-tiny"] = train_cell("whisper-tiny", FAM_BATCH, WHISPER_SEQ,
                                           WHISPER_STEPS, False)
    rec = fam_train["whisper-tiny"]
    if not statistics.mean(rec["losses"][-5:]) < statistics.mean(rec["losses"][:5]):
        fail(f"whisper-tiny: the last five losses are not below the first five: {rec['losses']}")
    log(f"  {time.perf_counter() - t10:.1f} s into phase 10")

    # llama-3.2-vision-11b trains at its reduced config only: at full width
    # AdamW needs about 12 bytes a parameter, 117 GB, beyond one 80 GB card
    vcfg = reduced(get_config("llama-3.2-vision-11b"))
    vapi = build_model(vcfg)
    vparams = vapi.init_params(make_generator(0, dev))
    with torch.no_grad():
        for lp in vparams["cross_layers"]:
            lp["cross"]["gate"].fill_(VLM_GATE)
    vhost = host_copy(vapi, vparams)
    vstep = make_train_step(vapi, TrainConfig(
        optimizer=AdamWConfig(lr=1e-3, clip_norm=1.0, apply_fused=True), remat="save_collectives"))
    on = {"card": TrainState(vparams, adamw_init(dict(vparams.named_parameters())),
                             torch.zeros((), dtype=torch.int32, device=dev)),
          "host": TrainState(vhost, adamw_init(dict(vhost.named_parameters())),
                             torch.zeros((), dtype=torch.int32))}
    vdc = SyntheticConfig(batch=4, seq_len=64, vocab_size=vcfg.vocab_size, seed=0)
    vrows, before = [], fused_adamw.launches
    for s_ in range(3):
        hb = batch_for_step(vdc, s_, vcfg)
        on["card"], mc = vstep(on["card"], batch_to_device(hb, dev, vapi.dtype))
        on["host"], mh = vstep(on["host"], batch_to_device(hb, "cpu", vapi.dtype))
        row = {k_: (float(mc[k_]), float(mh[k_])) for k_ in ("loss", "grad_norm")}
        vrows.append(row)
        for k_, (a, b_) in row.items():
            if not abs(a - b_) <= VLM_REL * abs(b_):
                fail(f"reduced llama-3.2-vision-11b step {s_}: card {k_} {a} vs host {b_}")
    v_launches = fused_adamw.launches - before
    n_v = len(list(vparams.parameters()))
    if v_launches != 3 * n_v:
        fail(f"reduced VLM: {v_launches} fused_adam launches for 3 steps x {n_v} tensors")
    fam_train["llama-3.2-vision-11b-reduced-f32"] = {
        "steps": vrows, "limit_rel": VLM_REL, "fused_adam_launches_per_step": v_launches / 3,
        "n_tensors": n_v, "remat": "save_collectives", "batch": 4, "seq": 64,
        "why_reduced": "AdamW at full width needs ~12 bytes a parameter, 117 GB"}
    log(f"reduced llama-3.2-vision-11b (f32, gates {VLM_GATE}, remat='save_collectives'), 3 "
        f"steps, card against host (loss, grad norm): {vrows}; {v_launches // 3} fused_adam "
        f"launches a step. Full width is not trained: AdamW needs ~12 bytes a parameter, "
        f"{12 * 9_775_157_256 / 1e9:.0f} GB, beyond one 80 GB card")
    del vparams, vhost, on
    release()

    # the three remat modes on internlm2-1.8b at full width and 4 layers
    rcfg = dataclasses.replace(get_config("internlm2-1.8b"), n_layers=4)
    rapi = build_model(rcfg)
    rdc = SyntheticConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab_size=rcfg.vocab_size, seed=0)
    modes = {}
    for remat in (False, "save_collectives", True):
        release()
        state = init_train_state(rapi, make_generator(0, dev))
        step_fn = make_train_step(rapi, TrainConfig(
            optimizer=AdamWConfig(lr=FAM_LR, clip_norm=1.0, apply_fused=True), remat=remat))
        batch = batch_to_device(batch_for_step(rdc, 0), dev)
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, metrics = step_fn(state, batch)
        sync()
        modes[str(remat)] = {"loss": float(metrics["loss"]),
                             "grad_norm": float(metrics["grad_norm"]),
                             "peak_above_state_bytes": torch.cuda.max_memory_allocated() - base}
        del state, metrics, batch
    release()
    m_f, m_s, m_t = modes["False"], modes["save_collectives"], modes["True"]
    log(f"internlm2-1.8b, 4 layers at full width, one step at batch {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"per remat mode (loss, grad norm, peak GiB above the state): " + "; ".join(
            f"{k_}: {v_['loss']!r}, {v_['grad_norm']!r}, {v_['peak_above_state_bytes'] / 2**30:.3f}"
            for k_, v_ in modes.items()))
    # the same forward; the backward's recompute runs the same kernels again
    if not m_f["loss"] == m_s["loss"] == m_t["loss"]:
        fail(f"remat modes give different losses: {[v_['loss'] for v_ in modes.values()]}")
    if not max(abs(v_["grad_norm"] - m_f["grad_norm"]) for v_ in (m_s, m_t)) <= (
            1e-6 * m_f["grad_norm"]):
        fail(f"remat modes give different grad norms: "
             f"{[v_['grad_norm'] for v_ in modes.values()]}")
    peaks = [v_["peak_above_state_bytes"] for v_ in (m_f, m_s, m_t)]
    if not peaks[0] >= peaks[1] >= peaks[2]:
        fail(f"peak memory not ordered False >= save_collectives >= True: {peaks}")
    fam_train["internlm2-1.8b-4layer-remat-modes"] = modes
    launched = {k_: w.launches for k_, w in wrappers.items()
                if w.launches and k_ != "fused_adam"}
    if launched:
        fail(f"training launched kernels of the port other than fused_adam: {launched}")
    fam_train["phase_s"] = time.perf_counter() - t10
    log(f"phase 10 took {fam_train['phase_s']:.1f} s")
    record["family_training"] = fam_train

    # ------------------------------------------------------------------ 11
    # encoder-decoder and VLM serving at full width, in bf16
    t11 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    vis_serving = {}

    def forced_gate(arch, cell, t0):
        """Teacher-forced decode of TF_STEPS positions after a t0-token
        prefill against the full forward, in bf16 within TF_ROW; where the
        bf16 forward itself lies beyond TF_ROW from the f32 forward of the
        same weights (random weights at full depth), the gate runs in f32
        and bf16 is held to BF16_FLOOR x that distance, as phase 9 does.
        Takes the parameters out of ``cell`` (the f32 copy needs the room)."""
        api, params, batch, rec = cell["api"], cell.pop("params"), cell["batch"], cell["rec"]
        prompts = batch["tokens"]
        extras = {k_: v_ for k_, v_ in batch.items() if k_ != "tokens"}
        forced16, full16 = decode_vs_forward(api, params, prompts, t0, TF_STEPS, extras)
        err16 = rows_err(forced16, full16)
        label = f"{arch}, positions {t0}-{t0 + TF_STEPS - 1}"
        if err16 <= TF_ROW:
            rec.update(teacher_forced(f"{label}, bf16", forced16, full16))
            return
        log(f"  {label}: bf16 teacher-forced decode {err16:.3e} per row, above {TF_ROW:.0e}: "
            f"the gate runs in f32")
        api32, p32 = as_f32(api, params, dev)
        del params
        release()
        ex32 = {k_: v_.float() for k_, v_ in extras.items()}
        forced32, full32 = decode_vs_forward(api32, p32, prompts, t0, TF_STEPS, ex32)
        del p32
        rec.update(teacher_forced(f"{label}, f32", forced32, full32))
        floor = rows_err(full16, full32)
        worst = max(err16, rows_err(forced16, full32))
        rec["bf16"] = {"decode_vs_forward_row_err": err16, "forward_vs_f32_forward_row_err": floor,
                       "decode_vs_f32_forward_row_err": rows_err(forced16, full32),
                       "limit": BF16_FLOOR * floor}
        log(f"  {label} in bf16: {err16:.3e} from the bf16 forward, "
            f"{rec['bf16']['decode_vs_f32_forward_row_err']:.3e} from the f32 forward (limit "
            f"{BF16_FLOOR} x the bf16 forward's distance from f32, {floor:.3e})")
        if not worst <= BF16_FLOOR * floor:
            fail(f"{arch}: bf16 teacher-forced decode lies {worst:.3e} per row from the forward")

    for arch, prompt_len, gate in (("whisper-tiny", WHISPER_PROMPT, None),
                                   ("llama-3.2-vision-11b", LM_PROMPT, VLM_GATE)):
        cell = dict(zip(("api", "params", "batch", "rec"),
                        serve_cell(arch, "11", t11, prompt_len, gate)))
        forced_gate(arch, cell, prompt_len - TF_STEPS)
        vis_serving[arch] = cell["rec"]
        del cell
        release()
    log(f"  {time.perf_counter() - t11:.1f} s into phase 11")
    # cut f32 models at full width (TF32 off): the card against the host
    vis_serving["whisper-tiny-f32"] = card_vs_host(
        "f32 whisper-tiny", dataclasses.replace(get_config("whisper-tiny"), dtype="float32"), 32)
    release()
    vis_serving["llama-3.2-vision-11b-1group-f32"] = card_vs_host(
        "one f32 group of llama-3.2-vision-11b (4 self + 1 cross)",
        dataclasses.replace(get_config("llama-3.2-vision-11b"), n_layers=5, dtype="float32"), 32,
        gate=VLM_GATE)
    release()
    launched = {k_: w.launches for k_, w in wrappers.items() if w.launches}
    if launched:
        fail(f"encdec and VLM serving launched kernels of the port, where no path calls one: "
             f"{launched}")
    vis_serving["phase_s"] = time.perf_counter() - t11
    log(f"encdec and VLM serving launched no kernel of the port (none lies on its path, in the "
        f"JAX package either); phase 11 took {vis_serving['phase_s']:.1f} s")
    record["encdec_vlm_serving"] = vis_serving

    # ------------------------------------------------------------------ 12
    # the dry-run tools: the sweep, abstract bytes against the card, the
    # analytic model against the port's own forward, the sharded MoE
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import list_configs
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.analytic import analytic_flops, analytic_hbm_bytes
    from repro_torch.launch.mesh import Mesh, make_production_mesh
    from repro_torch.launch.sharding import DEFAULT_RULES, make_resolver
    from repro_torch.models.common import use_sharding_rules
    from repro_torch.train import abstract_train_state

    release()
    t12 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    dry = {"card": card}

    # (a) the sweep: 10 configs x 4 shapes x both production meshes (meta)
    t0 = time.perf_counter()
    sweep = {}
    for arch in list_configs():
        for shape_name in SHAPES:
            for multi in (False, True):
                r = dryrun.run_cell(arch, shape_name, multi, trace=False, verbose=False)
                tag = f"{arch}_{shape_name}_{'multi' if multi else 'single'}"
                if r["status"] == "skipped":
                    if shape_name != "long_500k" or "quadratic" not in r["reason"]:
                        fail(f"dry-run {tag} skipped: {r['reason']}")
                    sweep[tag] = {"status": "skipped"}
                    continue
                if r["status"] != "ok":
                    fail(f"dry-run {tag}: {r}")
                sweep[tag] = {"program": r["program"],
                              "argument_gib_per_device":
                                  r["memory"]["argument_bytes_per_device"] / 2**30,
                              "bound_ms": r["roofline_analytic"]["bound_s"] * 1e3,
                              "dominant": r["roofline_analytic"]["dominant"],
                              "fallbacks": len(r["sharding_fallbacks"])}
                if tag == "whisper-tiny_train_4k_single" and not any(
                        f["axis"] == "vocab" for f in r["sharding_fallbacks"]):
                    fail("dry-run whisper-tiny train_4k logged no vocab fallback")
    n_ok = sum(1 for v in sweep.values() if "program" in v)
    dry["sweep"] = sweep
    log(f"12a. dry-run sweep ({card}): {len(sweep)} cells, {n_ok} ok, {len(sweep) - n_ok} "
        f"quadratic long_500k skips, in {time.perf_counter() - t0:.2f} s (meta device); whisper-"
        f"tiny train_4k logs its vocab fallback. Argument GiB per device and analytic bound ms "
        f"(single pod): " + "; ".join(
            f"{a} {s} {v['argument_gib_per_device']:.3f} GiB {v['bound_ms']:.3f} ms"
            for a in ("internlm2-1.8b", "olmoe-1b-7b", "qwen2.5-14b") for s in ("train_4k",
                                                                                 "decode_32k")
            for v in [sweep[f"{a}_{s}_single"]]))

    # (b) abstract bytes against the card's allocator: internlm2-1.8b, bf16.
    # The allocator's requested bytes must equal them exactly;
    # memory_allocated() counts blocks: each request rounded up to 512
    # bytes, and a cached block handed over whole where splitting it would
    # leave 1 MiB or less (up to 1 MiB more a request)
    def alloc_growth(fn):
        """(fn(), growth of the requested bytes, growth of memory_allocated)."""
        keys = ("requested_bytes.all.current", "allocated_bytes.all.current")
        sync()
        st0 = torch.cuda.memory_stats()
        if any(k_ not in st0 for k_ in keys):
            fail(f"torch.cuda.memory_stats() lacks {keys}")
        out = fn()
        sync()
        st1 = torch.cuda.memory_stats()
        return (out,) + tuple(st1[k_] - st0[k_] for k_ in keys)

    cfg12 = get_config("internlm2-1.8b")
    api12 = build_model(cfg12)
    abs_bytes = sum(p_.numel() * p_.element_size() for p_ in api12.abstract_params().parameters())
    gen12 = make_generator(0, dev)
    params12, req, grown = alloc_growth(lambda: api12.init_params(gen12))
    n_params12 = len(list(params12.parameters()))
    if req != abs_bytes:
        fail(f"abstract_params gives {abs_bytes:,} bytes, init_params requested {req:,}")
    del params12
    release()
    st_abs = abstract_train_state(api12)
    st_leaves = (list(st_abs.params.parameters()) + list(st_abs.opt.m.values())
                 + list(st_abs.opt.v.values()) + [st_abs.opt.step, st_abs.opt.prev_norm,
                                                  st_abs.step])
    st_bytes = sum(t_.numel() * t_.element_size() for t_ in st_leaves)
    gen12 = make_generator(0, dev)
    state12, st_req, st_grown = alloc_growth(lambda: init_train_state(api12, gen12))
    if st_req != st_bytes:
        fail(f"abstract_train_state gives {st_bytes:,} bytes, init_train_state requested "
             f"{st_req:,}")
    dry["abstract_bytes"] = {"params": abs_bytes, "params_requested": req,
                             "params_allocated": grown, "params_tensors": n_params12,
                             "train_state": st_bytes, "train_state_requested": st_req,
                             "train_state_allocated": st_grown,
                             "train_state_tensors": len(st_leaves)}
    log(f"12b. ({card}) internlm2-1.8b bf16: abstract_params {abs_bytes:,} bytes = init_params' requested "
        f"bytes {req:,} (memory_allocated grew {grown:,}: {grown - abs_bytes:,} more over "
        f"{n_params12} tensors); abstract_train_state {st_bytes:,} bytes = init_train_state's "
        f"requested {st_req:,} (memory_allocated grew {st_grown:,}: {st_grown - st_bytes:,} "
        f"more over {len(st_leaves)} tensors)")

    # (c) FlopCounterMode over the port's forward against analytic_flops
    B12, T12 = 1, 512
    toks = torch.randint(0, cfg12.vocab_size, (B12, T12), device=dev,
                         generator=make_generator(1, dev), dtype=torch.int32)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        api12.forward(state12.params, {"tokens": toks})
    counted = fc.get_total_flops()
    want = analytic_flops(cfg12, ShapeConfig("prefill_512", T12, B12, "prefill"))
    ratio = counted / want
    log(f"12c. ({card}) internlm2-1.8b bf16 forward at ({B12}, {T12}): FlopCounterMode {counted:,} FLOPs, "
        f"analytic_flops {want:,.0f}: ratio {ratio:.6f}")
    if not abs(ratio - 1) <= 0.02:
        fail(f"FlopCounterMode / analytic_flops = {ratio:.4f}, beyond 2%")
    del state12, st_abs, st_leaves, toks
    release()
    ratios = {"internlm2-1.8b": ratio}
    for arch in ("olmoe-1b-7b", "xlstm-1.3b", "zamba2-2.7b", "whisper-tiny",
                 "llama-3.2-vision-11b"):
        cfg_r = reduced(get_config(arch))
        api_r = build_model(cfg_r)
        p_r = api_r.init_params(make_generator(0, dev))
        batch_r = {"tokens": torch.randint(0, cfg_r.vocab_size, (2, 64), device=dev,
                                           generator=make_generator(1, dev), dtype=torch.int32),
                   **extras_for(cfg_r, 2, make_generator(2, dev), api_r.dtype, dev)}
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            api_r.forward(p_r, batch_r)
        ratios[f"{arch} (reduced)"] = fc.get_total_flops() / analytic_flops(
            cfg_r, ShapeConfig("prefill_64", 64, 2, "prefill"))
        del p_r, batch_r
    dry["flop_counter_over_analytic"] = ratios
    log("    count / analytic, reduced models at (2, 64), no gate: " + ", ".join(
        f"{k_} {v_:.4f}" for k_, v_ in ratios.items() if k_ != "internlm2-1.8b"))
    hbm = {}
    for arch in ("internlm2-1.8b", "olmoe-1b-7b"):
        cfg_h = get_config(arch)
        seq = LM_PROMPT + LM_NEW
        a_bytes = analytic_hbm_bytes(cfg_h, ShapeConfig("decode", seq, LM_BATCH, "decode"))
        d_bytes = decode_step_bytes(cfg_h, LM_BATCH, seq)
        hbm[arch] = {"analytic_hbm_bytes": a_bytes, "decode_step_bytes": d_bytes,
                     "analytic_ms": a_bytes / HW["hbm_bw"] * 1e3,
                     "decode_step_bytes_ms": d_bytes / HW["hbm_bw"] * 1e3,
                     "measured_ms": serving[arch]["ms_per_decode_step"]}
        log(f"    {arch} decode step (phase 8: batch {LM_BATCH}, {seq}-position cache): "
            f"analytic_hbm_bytes {a_bytes:,.0f} ({hbm[arch]['analytic_ms']:.4f} ms), "
            f"decode_step_bytes {d_bytes:,} ({hbm[arch]['decode_step_bytes_ms']:.4f} ms), "
            f"measured {hbm[arch]['measured_ms']:.4f} ms")
    dry["decode_bytes"] = hbm

    # (d) the sharded MoE on the one card: a (data 2, model 4) mesh of 8 shards
    cfg_m = dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=2, dtype="float32")
    cfg_m = dataclasses.replace(cfg_m, moe_capacity_factor=float(cfg_m.n_experts))
    api_m = build_model(cfg_m)
    p_m = api_m.init_params(make_generator(0, dev))
    toks_m = torch.randint(0, cfg_m.vocab_size, (4, 128), device=dev,
                           generator=make_generator(1, dev), dtype=torch.int32)
    mesh_m = Mesh(np.array([dev] * 8, dtype=object).reshape(2, 4), ("data", "model"))
    with torch.no_grad():
        ref_m, ref_aux = api_m.forward(p_m, {"tokens": toks_m})
        shard_aux = [float(api_m.forward(p_m, {"tokens": toks_m[2 * s:2 * s + 2]})[1])
                     for s in range(2)]
        unsharded_ms = timed(lambda: api_m.forward(p_m, {"tokens": toks_m}), 1, 3)
        with use_sharding_rules(make_resolver(mesh_m, DEFAULT_RULES()), mesh_m):
            got_m, got_aux = api_m.forward(p_m, {"tokens": toks_m})
            counts_m = dict(mesh_m.counts)
            sharded_ms = timed(lambda: api_m.forward(p_m, {"tokens": toks_m}), 1, 3)
    row_m = rows_err(got_m, ref_m)
    aux_want = sum(shard_aux) / 2
    aux_err = abs(float(got_aux) - aux_want) / abs(aux_want)
    dry["sharded_moe"] = {"row_err": row_m, "aux": float(got_aux), "aux_want": aux_want,
                          "aux_rel_err": aux_err, "unsharded_aux": float(ref_aux),
                          "counts": counts_m, "unsharded_ms": unsharded_ms,
                          "sharded_ms": sharded_ms}
    log(f"12d. ({card}) sharded MoE, 2-layer olmoe-1b-7b at full width in f32, no-drop capacity, (4, 128) "
        f"tokens on a (data 2, model 4) mesh of 8 shards on the one card: logits {row_m:.3e} per "
        f"row from the unsharded forward; aux {float(got_aux):.7f} against the data shards' mean "
        f"{aux_want:.7f} (rel {aux_err:.2e}; the whole batch's {float(ref_aux):.7f}); collectives "
        f"{counts_m}; forward {unsharded_ms:.3f} ms unsharded, {sharded_ms:.3f} ms sharded (one "
        f"card: no speed-up claimed)")
    if not row_m <= F32_ROW:
        fail(f"sharded MoE logits lie {row_m:.3e} per row from the unsharded forward")
    if not aux_err <= 1e-6:
        fail(f"sharded MoE aux {float(got_aux)} != the data shards' mean {aux_want}")
    if counts_m != {"allreduce": 2 * cfg_m.n_layers, "allreduce.model": cfg_m.n_layers,
                    "allreduce.aux": cfg_m.n_layers}:
        fail(f"sharded MoE counted {counts_m}: not one model and one aux all-reduce a layer")
    del ref_m, got_m
    release()
    launched = {k_: w.launches for k_, w in wrappers.items() if w.launches}
    if launched:
        fail(f"the dry-run tools launched kernels of the port, where no path calls one: "
             f"{launched}")
    log("12a-12d launched no kernel of the port")

    # (e) the sharded MoE's backward on the card: 12d's model and tokens, every
    # gradient of the whole batch's nll + 0.01 x aux against the unsharded loss
    # (aux there the mean over the data shards of each shard's rows' aux)
    from repro_torch.launch.roofline import analyze_program, roofline_terms

    def moe_mesh():
        return Mesh(np.array([dev] * 8, dtype=object).reshape(2, 4), ("data", "model"))

    named_m = list(p_m.parameters())
    names_m = [k_ for k_, _ in p_m.named_parameters()]
    L_m = cfg_m.n_layers

    def unsharded_loss(shard_aux=True):
        logits_, aux_ = api_m.forward(p_m, {"tokens": toks_m})
        if shard_aux:
            aux_ = sum(api_m.forward(p_m, {"tokens": toks_m[2 * s:2 * s + 2]})[1]
                       for s in range(2)) / 2
        return next_token_loss(logits_, toks_m) + MOE_AUX_WEIGHT * aux_

    def sharded_loss(mesh_):
        with use_sharding_rules(make_resolver(mesh_, DEFAULT_RULES()), mesh_):
            logits_, aux_ = api_m.forward(p_m, {"tokens": toks_m})
        return next_token_loss(logits_, toks_m) + MOE_AUX_WEIGHT * aux_

    def backward_ms(loss_fn, reps=3):
        """Median ms of ``reps`` backwards (CUDA events around autograd.grad alone)."""
        out = []
        for _ in range(reps):
            loss_ = loss_fn()
            sync()
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            torch.autograd.grad(loss_, named_m)
            ev[1].record()
            ev[1].synchronize()
            out.append(ev[0].elapsed_time(ev[1]))
        return statistics.median(out)

    for w in wrappers.values():
        w.launches = 0
    g_ref = torch.autograd.grad(unsharded_loss(), named_m)
    mesh_e = moe_mesh()
    g_sh = torch.autograd.grad(sharded_loss(mesh_e), named_m)
    counts_e = dict(mesh_e.counts)
    grad_err = {}
    for k_, g_, r_ in zip(names_m, g_sh, g_ref):
        r64 = r_.double()
        grad_err[k_] = float((g_.double() - r64).norm() / r64.norm().clamp_min(1e-30))
    worst = max(grad_err, key=grad_err.get)
    want_e = {"allreduce": 7 * L_m, "allreduce.model": L_m, "allreduce.aux": L_m,
              "allreduce.grad_x": L_m, "allreduce.grad_router": L_m,
              "allreduce.grad_experts": 3 * L_m}
    del g_ref, g_sh
    bwd_unsharded_ms = backward_ms(lambda: unsharded_loss(shard_aux=False))
    bwd_sharded_ms = backward_ms(lambda: sharded_loss(moe_mesh()))
    release()
    # three fused-optimizer steps under the mesh, on one batch, with remat: the
    # recompute runs on the autograd engine's device thread, and must take the
    # sharded path again
    state_e = init_train_state(api_m, make_generator(3, dev))
    n_tensors_e = len(list(state_e.params.parameters()))
    step_e = make_train_step(api_m, TrainConfig(
        optimizer=AdamWConfig(lr=FAM_LR, clip_norm=1.0, apply_fused=True), remat=True))
    mesh_t = moe_mesh()
    losses_e = []
    with use_sharding_rules(make_resolver(mesh_t, DEFAULT_RULES()), mesh_t):
        for _ in range(3):
            state_e, met_e = step_e(state_e, {"tokens": toks_m})
            losses_e.append(met_e["loss"])
    losses_e = torch.stack(losses_e).tolist()
    launched_e = {k_: w.launches for k_, w in wrappers.items() if w.launches}
    per_step_e = launched_e.get("fused_adam", 0) / 3
    dry["sharded_moe_backward"] = {
        "grad_rel_err": grad_err, "worst": worst, "gate": GRAD_ROW, "counts": counts_e,
        "backward_ms_unsharded": bwd_unsharded_ms, "backward_ms_sharded": bwd_sharded_ms,
        "train_losses": losses_e, "fused_adam_launches_per_step": per_step_e,
        "n_tensors": n_tensors_e, "train_step_counts": dict(mesh_t.counts)}
    log(f"12e. ({card}) sharded MoE backward, 2-layer olmoe-1b-7b at full width in f32, (4, 128) "
        f"on (data 2, model 4): {len(grad_err)} gradients within {grad_err[worst]:.3e} per tensor "
        f"({worst}) of the unsharded loss's (gate {GRAD_ROW:g}); collectives {counts_e}; backward "
        f"{bwd_unsharded_ms:.3f} ms unsharded (whole-batch aux), {bwd_sharded_ms:.3f} ms sharded "
        f"(no gate); 3 fused remat steps under the mesh: losses {losses_e}, fused_adam "
        f"{per_step_e:g} launches a step for {n_tensors_e} tensors")
    if not grad_err[worst] <= GRAD_ROW:
        fail(f"sharded MoE gradient {worst} lies {grad_err[worst]:.3e} from the unsharded one")
    if counts_e != want_e:
        fail(f"sharded MoE forward + backward counted {counts_e}, expected {want_e}")
    if not all(math.isfinite(x) for x in losses_e) or not losses_e[-1] < losses_e[0]:
        fail(f"sharded MoE training losses {losses_e}: not finite and falling")
    if set(launched_e) != {"fused_adam"} or per_step_e != n_tensors_e:
        fail(f"sharded MoE training launched {launched_e}: not fused_adam once a tensor a step "
             f"({n_tensors_e})")
    del p_m, state_e, step_e
    release()

    # (f) the traced census against the card: the dry run's internlm2-1.8b
    # train step (AdamW unfused, clip 1, remat on) at phase 5's batch
    for w in wrappers.values():
        w.launches = 0
    api_f = build_model(get_config("internlm2-1.8b"))
    shape_f = ShapeConfig("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    census_f = analyze_program(dryrun._step_program(api_f, shape_f, {}))
    trace_f_s = time.perf_counter() - t0
    state_f = init_train_state(api_f, make_generator(0, dev))
    step_f = make_train_step(api_f, dryrun.step_train_config())
    gen_f = make_generator(1, dev)
    batch_f = {k_: torch.randint(0, cfg12.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), device=dev,
                                 generator=gen_f, dtype=torch.int32) for k_ in ("tokens", "labels")}
    release()
    sync()
    torch.cuda.reset_peak_memory_stats()
    req0 = torch.cuda.memory_stats()["requested_bytes.all.current"]
    with FlopCounterMode(display=False) as fc:
        state_f, met_f = step_f(state_f, batch_f)
    sync()
    grown_f = torch.cuda.memory_stats()["requested_bytes.all.peak"] - req0
    card_flops = fc.get_total_flops()
    loss_f = float(met_f["loss"])
    step_f_ms = timed(lambda: step_f(state_f, batch_f), 1, 3)
    terms_f = roofline_terms(census_f.flops, census_f.hbm_bytes, 0.0)
    over = grown_f - census_f.peak_live_bytes
    dry["traced_vs_card"] = {
        "traced_flops": census_f.flops, "card_flops": card_flops,
        "traced_hbm_bytes": census_f.hbm_bytes, "traced_peak_live_bytes": census_f.peak_live_bytes,
        "card_requested_peak_growth": grown_f, "growth_minus_traced": over,
        "peak_tol_bytes": PEAK_TOL, "n_ops": census_f.n_ops, "ops_by_class": census_f.ops_by_class,
        "trace_s": trace_f_s, "loss": loss_f, "step_ms": step_f_ms, "roofline": terms_f,
        "share_of_traced_bound": terms_f["bound_s"] * 1e3 / step_f_ms}
    log(f"12f. ({card}) internlm2-1.8b train step at {TRAIN_BATCH} x {TRAIN_SEQ}, bf16 (the dry "
        f"run's: AdamW unfused, clip 1, remat on): traced on meta in {trace_f_s:.2f} s, "
        f"{census_f.n_ops:,} ops; FLOPs traced {census_f.flops:,.0f}, card FlopCounterMode "
        f"{card_flops:,}; peak live traced {census_f.peak_live_bytes:,} B, card requested-peak "
        f"growth {grown_f:,} B ({over:+,} B; tolerance 0 to {PEAK_TOL:,}); loss {loss_f:.4f}; "
        f"step {step_f_ms:.3f} ms against the traced bound {terms_f['bound_s'] * 1e3:.3f} ms "
        f"({terms_f['dominant']}; compute {terms_f['compute_s'] * 1e3:.3f} ms, memory "
        f"{terms_f['memory_s'] * 1e3:.3f} ms of {census_f.hbm_bytes:,.0f} B): share "
        f"{dry['traced_vs_card']['share_of_traced_bound']:.3f} (no gate)")
    if card_flops != census_f.flops:
        fail(f"traced FLOPs {census_f.flops:,} != the card's FlopCounterMode {card_flops:,}")
    if not 0 <= over <= PEAK_TOL:
        fail(f"the card's requested peak grew {grown_f:,} B, the traced peak is "
             f"{census_f.peak_live_bytes:,} B: {over:+,} B, outside 0 to {PEAK_TOL:,}")
    if not math.isfinite(loss_f):
        fail(f"the traced step's loss on the card is {loss_f}")
    del state_f, step_f, batch_f, met_f
    release()
    cells_f = {}
    # the sharded olmoe cell at 2 of its 16 layer groups: 256 shard threads a
    # region on meta take ~13 s a layer on the card's host
    for arch, shape_name, variant in (("olmoe-1b-7b", "train_4k",
                                       {"moe_shard_map": True, "groups": OLMOE_TRACED_GROUPS}),
                                      ("qwen3-8b", "prefill_32k", None),
                                      ("internlm2-1.8b", "decode_32k", None)):
        r = dryrun.run_cell(arch, shape_name, False, verbose=False, variant=variant)
        if r["status"] != "ok":
            fail(f"traced dry-run {arch} {shape_name}: {r}")
        key_f = f"{arch}_{shape_name}"
        # the same program counted whole (no placements): the placements' cost,
        # the best of 3 turns of each on the short cells (host noise)
        cfg_g = get_config(arch)
        if variant and variant.get("groups"):
            cfg_g = dryrun._with_groups(cfg_g, variant["groups"])
        traced_s, global_s = [r["trace_s"]], []
        for turn in range(1 if variant and variant.get("moe_shard_map") else 3):
            mesh_g, rules_g = make_production_mesh(), DEFAULT_RULES()
            thunk_g = dryrun._step_program(build_model(cfg_g), SHAPES[shape_name],
                                           variant or {})
            gc.collect()
            t0 = time.perf_counter()
            with use_sharding_rules(make_resolver(mesh_g, rules_g),
                                    mesh_g if (variant or {}).get("moe_shard_map") else None):
                analyze_program(thunk_g, mesh=mesh_g)
            global_s.append(time.perf_counter() - t0)
            if turn:
                gc.collect()
                traced_s.append(dryrun._trace_cell(cfg_g, SHAPES[shape_name], mesh_g,
                                                   DEFAULT_RULES(), variant)[3])
        trace_s, global_s = min(traced_s), min(global_s)
        cells_f[key_f] = {
            k_: r[k_] for k_ in ("program", "variant", "trace_s", "memory", "traced",
                                 "collectives", "roofline_traced", "model_vs_traced_flops")}
        cells_f[key_f]["trace_s_best"] = trace_s
        cells_f[key_f]["trace_s_global_count"] = global_s
        cells_f[key_f]["trace_s_global_recorded"] = TRACE_S_GLOBAL[key_f]
        tr_, mem_, col_ = r["traced"], r["memory"], r["collectives"]
        log(f"    traced cell (16 x 16 meta mesh, one device's share) {arch} {shape_name} "
            f"{r['program']}{f' {variant}' if variant else ''}: trace_s {trace_s:.2f} (best of "
            f"{len(traced_s)}; the global count in this run {global_s:.2f} s, ratio "
            f"{trace_s / global_s:.3f}; recorded {TRACE_S_GLOBAL[key_f]:.2f} s), "
            f"{tr_['n_ops']:,} ops; per device "
            f"{tr_['flops_per_chip']:,.0f} FLOPs, {tr_['hbm_bytes_per_chip']:,.0f} HBM B, "
            f"{tr_['wire_bytes_per_chip']:,.0f} wire B, argument "
            f"{mem_['argument_bytes_per_device']:,} B, temp {mem_['temp_bytes_per_device']:,.0f} "
            f"B, peak {mem_['peak_bytes_per_device'] / 2**30:.3f} GiB; collectives by kind "
            f"{col_['by_kind_count']} ({ {k_: round(v_) for k_, v_ in col_['by_kind_bytes'].items()} }"
            f" wire B), of them the regions' {col_['regions']['counts']}; traced bound "
            f"{r['roofline_traced']['bound_s'] * 1e3:.3f} ms ({r['roofline_traced']['dominant']}); "
            f"6ND / traced FLOPs {r['model_vs_traced_flops']:.4f}")
    regions_moe = cells_f["olmoe-1b-7b_train_4k"]["collectives"]["regions"]["counts"]
    n_moe = regions_moe.get("allreduce", 0)
    if n_moe != 9 * OLMOE_TRACED_GROUPS:
        fail(f"the traced olmoe moe_shard_map cell's regions counted {n_moe} all-reduces, "
             f"not 9 a layer ({regions_moe})")
    dry["traced_cells"] = cells_f
    launched = {k_: w.launches for k_, w in wrappers.items() if w.launches}
    if launched:
        fail(f"12f launched kernels of the port (its step runs the plain optimizer): {launched}")
    dry["phase_s"] = time.perf_counter() - t12
    log(f"phase 12 took {dry['phase_s']:.1f} s")
    record["dry_run"] = dry

    # ------------------------------------------------------------------ 6
    # the path whose run each kernel's launches are read from (None: the
    # kernel is on no solver path, in the JAX package either)
    paths = {"spmv_dia": ("poisson125 auto", runs["auto"]),
             "spmv_dia_bf16": ("poisson125 cuda+bf16", bf16),
             "fused_vma": ("poisson125 cuda", runs["cuda"]),
             "fused_iter": ("poisson125 auto", runs["auto"]),
             "spmv_bell": ("Queen_4147 bell-auto", qruns["bell-auto"]),
             "spmv_bell_bf16": ("Queen_4147 pcg-bf16", qruns["pcg-bf16"]),
             "fused_dots": (None, None),
             "fused_adam": ("reduced internlm2-1.8b launcher, 40 steps (5a)",
                            {"launches": {"fused_adam": launches_5a}}),
             "fused_adam_bf16": ("full internlm2-1.8b trainer, 20 steps (5b)",
                                 {"launches": {"fused_adam": launches_5b}}),
             "flash_attn": (None, None),
             "flash_attn_bf16": (None, None),
             "fused_iter_batched": ("poisson125 server, 64 requests (6c)",
                                    {"launches": serve_launches["poisson125"]}),
             "spmv_dia_batched": ("poisson125 server, 64 requests (6c)",
                                  {"launches": serve_launches["poisson125"]}),
             "spmv_dia_batched_bf16": ("poisson125 cuda-core bf16 bucket of 8, 200 steps (6b)",
                                       batched_ms["poisson125 cuda+bf16"][KB]),
             "fused_iter_bf16band": ("poisson125 pipecg, bf16-band fused_iter core (3)", band16),
             "fused_vma_batched": ("Queen_4147 Bell server, 64 requests (6c)",
                                   {"launches": serve_launches["Queen_4147 Bell"]}),
             "spmv_bell_batched": ("Queen_4147 Bell server, 64 requests (6c)",
                                   {"launches": serve_launches["Queen_4147 Bell"]})}
    # phase 7's runs of the kernels on the hybrid path, beside each row's own
    hybrid_paths = {
        "spmv_dia": ("Method 3: h3 on the card + host, poisson125(128) (7b)",
                     hybrid["method3"]["launches"].get("spmv_dia", 0)),
        "fused_vma": ("Method 3: h3 on the card + host, poisson125(128) (7b)",
                      hybrid["method3"]["launches"].get("fused_vma", 0)),
        "spmv_dia_batched": ("hybrid h3 solve_batched k=4, poisson125(64) (7d)",
                             hybrid["batched"]["launches"].get("spmv_dia_batched", 0)),
        "fused_vma_batched": ("hybrid h3 solve_batched k=4, poisson125(64) (7d)",
                              hybrid["batched"]["launches"].get("fused_vma_batched", 0)),
    }
    family_paths = {
        "fused_adam_bf16": {f"{arch} (10)": fam_train[arch]["fused_adam_launches_per_step"]
                            for arch in ("xlstm-1.3b", "zamba2-2.7b", "whisper-tiny")},
        "fused_adam": {"reduced llama-3.2-vision-11b, f32 (10)": fam_train[
            "llama-3.2-vision-11b-reduced-f32"]["fused_adam_launches_per_step"],
                       "2-layer olmoe-1b-7b, f32, sharded MoE on (data 2, model 4) (12e)":
                           dry["sharded_moe_backward"]["fused_adam_launches_per_step"]}}
    kernels = []
    for kname, (path, run) in paths.items():
        base = kname.removesuffix("_bf16").removesuffix("_batched").removesuffix("_bf16band")
        counted = kname if kname in BATCHED else base
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[base], "replaces": REPLACES[base],
            "path": path, "launches": 0 if run is None else run["launches"][counted],
            "max_abs_err": errs[kname], "ms": times[kname][0], "plain_ms": times[kname][1],
            "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1],
            "library_ms": library.get(kname),
        })
        if kname in lane_share:  # times at k = 2, 4, 8 lanes beside their bounds
            kernels[-1]["lanes"] = lane_share[kname]
        if kname in hybrid_paths:
            kernels[-1].update(hybrid_path=hybrid_paths[kname][0],
                               hybrid_launches=hybrid_paths[kname][1])
        if kname in family_paths:  # phase 10's training paths, launches a step
            kernels[-1]["family_training_launches_per_step"] = family_paths[kname]
    summary = {
        "solves": {e: {kk: v for kk, v in r.items() if kk != "history"}
                   for e, r in {**runs, "cuda+bf16": bf16, "fused_iter bf16 band": band16}.items()},
        "queen_solves": {e: {kk: v for kk, v in r.items() if kk != "history"}
                         for e, r in qruns.items()},
        "ms_per_iteration": per_iter, "queen_ms_per_iteration": q_per_iter,
        "queen_marginal_ms_per_iteration": q_marginal, "queen_solve_ms": q_solve_ms,
        "queen_fixed_iterations": q_fixed, "queen_completed": completed,
        "queen_dia_spmv_ms": queen_dia_ms, "three_torch_dots_ms": three_dots_ms,
        "kernels": kernels, **record,
    }
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
