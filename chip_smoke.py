#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card (the first
run builds the kernels from ``src/repro_torch/kernels/*/csrc`` with
``nvcc``):

    python3 chip_smoke.py

Phases, each of which must pass:

0. build every kernel with ``nvcc`` (one process per source, all at
   once) and print its registers and spills, and any wgmma serialization
   ptxas reports; the TMA and wgmma kernels and the sojourn kernels
   (``CLEAN_PTXAS``: attention, the MoE FFN, the SSD scan,
   ``sojourn_dynamic`` and ``sojourn_static``) must show neither;
1. first the kernel regimes of the hybrid, vlm and encdec families,
   each against its plain version with a second call bitwise equal:
   ``flash_fwd`` with one query row and with Sq != Skv over the vision
   model's 1,664 image tokens (D = 128), bidirectional at Sq = Skv =
   2,048 and one query row there (D = 64, Seamless), a ragged five-row
   case, and ``flash_dkv`` / ``flash_dq`` at that case; ``ssd_fwd`` at
   Jamba's N = 16, P = 64, 128 heads, one group (2,048 steps, and 255,
   shorter than a chunk); ``moe_ffn_fwd`` at Jamba's prefill and decode
   shapes (E = 16); the prefill-sized ones timed beside their bounds
   (each kernel's ``regimes``).  Then hold each of the ten kernels
   against its plain PyTorch version on the card at mid sizes: the sojourn kernels to a relative error of at
   most 1e-9 (with one dynamic case whose rank table holds a +inf index,
   ROADMAP fault R2, groups of 65, 80 and 160 jobs, and the dynamic
   kernel's paths on both sides of each limit: N M = 64 and 65, 256 and
   258 entries, W = 8 and 9, W >= N, and state past shared memory in
   device scratch, and tables with NaN and -inf indices on 1 and 2
   servers, each with a second call bitwise equal to the first;
   ``sojourn_enum`` at its suffix's limits: the rule's largest L, L = 0,
   an empty prefix (P = 2^16), M = 2, 3 and 4 and mixed radices, each
   with a second call bitwise equal, NaN on both sides for an order whose
   strides or count are not its radix's, and timed at the OPTIMAL
   search's batches, N=8 M=3 P=512; ``sojourn_mc`` at M = 3 and 4, on a
   CDF with 0, 1 and multiples of 2^-32, at N = 1228 and 1229 (P5) and at
   N = 8000, its tables read through L1; ``sojourn_outcomes`` at P = 1, 8,
   9, 17 and 40, N = 1, 16, 21 and 32, M = 2 to 4, K below one tile and
   ragged, a zero-weight row, N = 191 and 192 (P5) and N = 400 (its direct
   kernel), and timed at N = 16, 21 and 32 (shared-memory banks); each with
   a second call bitwise equal),
   ``flash_fwd`` in bf16 to the tolerances
   ``FLASH_O_ATOL`` / ``FLASH_LSE_ATOL``, ``flash_dkv`` and ``flash_dq``
   (causal, a sliding window, GQA groups 1, 2, 4 and 6, head dims 64, 112
   and 128, ragged lengths, rows that see no key) to ``FLASH_BWD_REL_L2``,
   and a second call of each bitwise equal to the first, ``ssd_fwd`` (two groups,
   several chunks, ragged chunks and padded N and P, a second call bitwise
   equal) and ``moe_ffn_fwd``
   (caps 8, 40 and 320, ragged widths and rows in both tilings, 48
   experts, rows on both sides of its decode tiles' limit, and a second
   call bitwise equal to the first) to ``ssd_scan.kernel``'s ``SSD_REL_L2``
   / ``SSD_STATE_REL`` and ``MOE_REL_L2``.  The MoE and SSD autograd
   Functions (kernel forward, reference backward) give gradients within
   ``MOE_GRAD_REL_L2`` / ``SSD_GRAD_REL_L2`` of autograd through their
   plain versions;
2. replay the paper's worked example (SR 10, SERPT 9.75, OPTIMAL 9.1 with
   order [0, 1], RANK 9.1) through the default-device entry points;
3. drive the evaluator's main path at full size, through the kernels
   only: ``evaluate_many`` at N=26 (K = 2**26, the exact cap), at N=8,
   M=3 with OPTIMAL (8! orders x 3**8 combinations) and at N=27
   (K = 2**27, streamed with 2**23 samples), each's host wall logged,
   and the N=8 cell once more under ``torch.profiler`` for its
   ``sojourn_enum`` kernel time summed over its launches.  Then
   ``evaluate_many`` at
   N=80 two-stage jobs (K = 2**80) must take the streamed tier.  Then a
   constant index table through
   the dynamic kernel must give the static RANK order's value at N=26;
4. drive the explicit-outcome path: ``enumerate_outcomes`` at N=21
   (K = 2**21) evaluated for RANK and SR, and ``sample_outcomes`` with
   2**21 samples at N=27 over RANK plus 16 RANDOM orders, at most one
   ``sojourn_outcomes`` launch for each static call; the host wall split
   into table builds, uploads and calls, and the N=27 call's kernel time
   under ``torch.profiler``; the table values must equal the exact
   (table-free) ones to 1e-9;
4b. run the paper's studies through the entry points a user calls
   (``STUDY_SETS``, ``DES_*``, ``TRACE_SERVERS``): ``evaluate_many`` over
   OPTIMAL, RANK, SERPT, SR and RANDOM for workload sets 1 and 4 at N = 3-8,
   M = 2, each value within 1e-9 of the same call on the CPU (identically
   seeded rngs), ``sojourn_enum`` and ``dynamic_sojourn_enum`` launched and
   no Monte-Carlo kernel; the host wall and launches of each call by N, the
   card's busy share of one N = 8 call under ``torch.profiler``, and the
   study's projected host time at CI and paper scale; ``table_sojourn`` for
   ``TABLE_STUDY`` through ``repro_torch.launch.study`` on the card, its rows
   within 1e-9 of the same table with ``device="cpu"``.  Then an exhaustive
   DES (``simulate`` over every outcome combination of ragged 6-job groups
   with untied, finite SR and SERPT tables) within 1e-9 of
   ``dynamic_sojourn_enum`` on 1, 2 and 3 servers, and ``simulate`` over the
   whole synthetic trace (109,967 jobs) for RANK on 5 servers: the wall,
   events a second, the mean sojourn of successful jobs and their count.
   Last, the seed designs against the fused kernels:
   ``table_eval_perf``, ``table_eval_dynamic`` and ``table_eval_mc``
   through ``repro_torch.launch.study`` on the card at the reference's CI
   sizes, with the reference's own checks and their rows logged;
5. serve seven models with random weights through
   ``repro_torch.launch.serve``, each 4 prompts of 2048 tokens and 32 new
   tokens, each with a decode-against-prefill check and, under
   ``torch.profiler``, the card's busy share of one more prefill and three
   decode steps:

   a. Qwen3-8B at full width and depth: ``flash_fwd`` once per layer (36);
      decode step 1 against a prefill of the prompt plus its token within
      ``SERVE_REL_L2`` / ``SERVE_MAX_ABS``;
   b. Mamba2-1.3B, the whole model: ``ssd_fwd`` once per layer (48);
      decode runs the plain recurrence.  A prefill of the first 1792
      prompt tokens and 256 decode steps over the rest must end within
      ``MAMBA_FLOOR_FACTOR`` times the rounding floor (the prefill in
      chunks of 128 against 256) of the 2048-token prefill's last
      logits, and a ``MAMBA_SHALLOW_LAYERS``-layer copy within
      ``MAMBA_SHALLOW_REL_L2``;
   c. Mixtral-8x22B at full width and ``MIXTRAL_LAYERS`` of its 56 layers:
      ``flash_fwd`` once per layer, ``moe_ffn_fwd`` twice per layer per
      step; one more prefill logs the share of (token, expert) pairs the
      capacity dropped.  Decode step 1 is held to a prefill of the prompt
      plus its token within ``MIXTRAL_REL_L2`` on a copy of the config
      whose capacity drops nothing, with 4 x 512 prompt tokens;
   d. Kimi-K2 at full width (head dim 7168 / 64 = 112) and
      ``KIMI_LAYERS`` of its 61 layers: ``flash_fwd`` once, ``moe_ffn_fwd``
      twice per step over its 384 experts; the peak memory within
      ``KIMI_PEAK_GB``; the drop share logged; decode step 1 against a
      prefill of prompt + 1 token within ``KIMI_REL_L2`` on a no-drop copy,
      with 4 x ``KIMI_NO_DROP_PROMPT`` prompt tokens;
   e. Jamba at full width and ``JAMBA_LAYERS`` of its 32 layers (one
      period): ``flash_fwd`` at its attention layer, ``ssd_fwd`` at its 7
      Mamba layers (prefill), ``moe_ffn_fwd`` twice at each of its 4 MoE
      layers per step; the drop share; decode step 1 against a prefill one
      token longer within ``JAMBA_REL_L2`` on a no-drop copy with
      ``JAMBA_NO_DROP_PROMPT`` prompt tokens;
   f. Llama-3.2-Vision-11B whole over 1,664 stub image tokens, each
      period's gate at ``VISION_GATE``: ``flash_fwd`` at its 32
      self-attention and 8 cross-attention layers in the prefill and at
      the 8 cross layers of each decode step; decode step 1 against a
      longer prefill with the same image within ``VISION_REL_L2``; a
      second image must move decode step 1's logits by more than
      ``VISION_LIVE_FLOOR``;
   g. Seamless-M4T-large-v2 whole over 2,048 stub frames: ``flash_fwd``
      at its 24 encoder, 24 self and 24 cross layers in the prefill, the
      encoder again in ``prime_memory`` and each cross layer of each
      decode step; decode step 1 against a longer prefill with the same
      frames within ``SEAMLESS_REL_L2``;
6. train Qwen3-1.7B at full width and depth through
   ``repro_torch.launch.train`` (``remat="full"``, SyntheticLM seed 0, its
   first batch at every step (``RepeatedBatch``), ``TRAIN_BATCH``
   sequences of ``TRAIN_SEQ`` tokens a step as
   ``TRAIN_ACCUM`` micro-batches, ``TRAIN_STEPS`` optimizer steps, the
   first of them the warm-up): ``flash_fwd`` twice per layer and
   micro-batch (forward and recompute), ``flash_dkv`` and ``flash_dq``
   once; every loss and gradient norm finite and the last loss below the
   first; the step time, tokens per second, peak memory and, under
   ``torch.profiler``, the card's busy share of one more step and its
   largest kernels.  Then a
   ``GRAD_CHECK_LAYERS``-layer copy at full width on one batch of
   ``GRAD_CHECK_TOKENS`` tokens: its loss and every gradient leaf (bf16, on
   the card, through the kernels) within ``TRAIN_LOSS_REL`` /
   ``TRAIN_GRAD_REL_L2`` of the same step on the CPU in float32 through the
   plain path;
7. time each kernel and its plain version with CUDA events at the
   largest shapes of phases 3-6 (and hold the two results against each
   other there too), time ``scaled_dot_product_attention`` beside
   ``flash_fwd`` (at the serving shape, the training shape and Kimi-K2's
   head dim 112), its backward (forward and backward minus forward)
   beside ``flash_dkv`` and ``flash_dq`` (at the training shape, head dim
   112 and head dim 64), and the three-``torch.bmm``
   composition beside ``moe_ffn_fwd`` (at the prefill shapes of Mixtral
   and Kimi-K2; the kernel also at both decode shapes, each shape held
   against those phases 5c and 5d launched) as their library
   yardsticks, and reckon each kernel's bound: the work any kernel that
   meets the bars must do (``static_flops``, ``ssd_work``), with the
   counts of the earlier kernels' way of doing it beside the enumeration's
   and the SSD scan's; the largest of three terms, float64 (or tensor)
   operations, the ALU-only integer operations of the Threefry stream
   (``threefry_alu_ops``, at the card's maximum SM clock) and bytes, each
   printed; both Monte-Carlo kernels also at N=80 and ``sojourn_outcomes``
   at phase 4's N=27 call; the run fails if a kernel's time is below its
   bound at any shape (a share over 100% means a wrong count).  Phase 1
   times each at its mid sizes as well.  Each time is the median of calls timed one by
   one behind a sleep on the card (``PREFILL_CYCLES``), so it measures
   the card and not the host;
8. run the two examples on the card through their ``main(argv)``:
   ``repro_torch.examples.train_early_termination`` (``EXAMPLE_TRAIN_ARGS``:
   the 100m preset) and ``repro_torch.examples.cluster_schedule``
   (``EXAMPLE_CLUSTER_ARGS``; its pool holds Mamba2, Mixtral and Jamba):
   every job a success or terminated, positive walls, each job's
   wall-clock sojourn logged, and every model kernel launched;
9. run the meshed programs on a (1, 1) mesh of one NCCL rank, each
   against its unmeshed run on the same seed, with the launch counts of
   each path equal: (a) Qwen3-8B served as phase 5a, and (a') again in
   the serving-weight layout (``default_serve_plan(tp_weights=True)``),
   the first decode logits within ``MESH_REL_L2``; (b) Qwen3-1.7B's
   train step; (c) Jamba's long_500k sequence-parallel decode; (d)
   Llama-3.2-Vision-11B (gates at ``VISION_GATE``) and Seamless-M4T
   served as phases 5f and 5g, the first decode logits within
   ``MESH_REL_L2``; (e) Seamless-M4T's train step at full width
   (``SEAMLESS_TRAIN_SEQ``), the losses within ``MESH_REL_L2``; (f) a
   meshed ``Trainer`` of Qwen3-1.7B at ``CKPT_LAYERS`` layers that saves,
   a fresh one that restores every leaf bitwise and resumes, the losses
   against an unbroken run's; (g) ``compressed_psum`` through NCCL; (h)
   the dry run of ``DRYRUN_CELLS`` in a subprocess, and in the same one
   ``DRYRUN_TP_CELLS`` under ``REPRO_SERVE_TP_WEIGHTS=1``, then
   ``table_roofline``.

Phases 3, 4, 4b, each serving run of 5, the training run of 6, each
example of 8 and each path of 9 set every
launch count to 0 just before they drive their path and read the counts
just after: every kernel of the path must have launched.

Each kernel's ``bound_by`` is ``operations`` or ``bytes``; ``bound_term``
says which term won (``operations``, ``integer`` or ``bytes``).

It prints the study's measured numbers as one JSON line
(``{"numerical_study": ...}``, tied to no kernel; the projections are only
in its ``[study]`` log line), the new families' and the examples' numbers
as another (``{"families": ..., "examples": ...}``), the kernel report as
one JSON line, the card's
name and power limit from ``nvidia-smi``, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or when a phase fails, it exits non-zero and prints no
result.  It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL = 1e-9
#: flash_fwd against its plain version, both bf16 with f32 accumulation:
#: O may differ by a few bf16 ulps (P is rounded to bf16 after sums taken
#: in another order; one ulp is 2**-8 at |O| in [0.5, 1)), the float32 LSE
#: by float32 rounding.
FLASH_O_ATOL = 1e-2
FLASH_LSE_ATOL = 1e-4
#: The head dims below 64 that the attention kernels take (every SMOKE
#: config's): one 64-column panel that TMA fills with zeros past D.
SMALL_HEAD_DIMS = (16, 32)
#: Qwen3-8B decode step 1 against a prefill of prompt + 1 token, both bf16:
#: the two paths round at different places (the decode's oracle attention
#: normalises P before its bf16 rounding, the prefill's kernel after; the
#: matrix products have other shapes), and 36 layers add the differences.
#: Bars: relative L2 error of the logits, and their largest absolute error
#: (the logits of random weights have a standard deviation near 1).  An
#: H100 run measured 4.5e-2 and 0.23; a wrong cache slot or position gives
#: unrelated logits, a relative L2 error near 1.4.
SERVE_REL_L2 = 0.1
SERVE_MAX_ABS = 0.5
#: moe_ffn_fwd against its plain version: the activation and the output are
#: rounded to bf16 on both sides after float32 sums in another order.
MOE_REL_L2 = 1e-2
#: The plain MoE version's float32 weight copies at once, at most: it runs
#: over chunks of experts within this.
MOE_PLAIN_BYTES = 16 << 30
#: Mamba2-1.3B: 256 decode steps (the plain recurrence, y rounded to bf16
#: a step) after a 1792-token prefill, against a 2048-token prefill (the
#: ssd_fwd kernel, chunks of 256).  The random 48-layer stack amplifies
#: bf16 roundings, so the bar of the whole model is tied to the rounding
#: floor the same run measures: two prefills that differ only in their
#: chunk size (128 or 256, both right) and so only in the order of their
#: roundings.  Decode and prefill differ in more roundings than that (y
#: rounded to bf16 each step, another order of every sum), so the bar is
#: twice the floor.  The bar of a 6-layer copy at full width is fixed
#: instead: its floor is small, and a fault in the cache hand-over or the
#: recurrence shows there undamped.  On the CPU (width cut to 256) decode
#: against prefill reads 4.6e-3 at 1 layer and 2.7e-2 at 6 layers in bf16,
#: and 1e-4 in float32 at 48; so 0.06 at 6 layers, set before its first
#: reading on the card.  Unrelated logits read about 1.4.
MAMBA_FLOOR_FACTOR = 2.0
MAMBA_SHALLOW_LAYERS = 6
MAMBA_SHALLOW_REL_L2 = 0.06
#: Mixtral-8x22B, decode step 1 against a prefill of prompt + 1 token, with
#: a capacity that drops nothing: rounding as for Qwen3-8B over 12 layers,
#: and on top of it a router near a tie may send the token to another
#: expert in one of the two runs, which moves that request's logits by more
#: than rounding does; so a relative L2 bar only, 0.15, set before any
#: reading (a wrong cache slot or position gives about 1.4).
MIXTRAL_REL_L2 = 0.15
#: flash_dkv and flash_dq against their plain versions on bf16 inputs: the
#: kernels round P and dS to bf16 before their tensor-core products (2**-9
#: relative each), the plain versions keep them in float32.  Relative L2
#: error of each of dQ, dK and dV, at the expected scale of those roundings.
FLASH_BWD_REL_L2 = 1e-2
#: The MoE Function's gradients (its backward recomputes through
#: moe_ffn_ref, which rounds x·Wg and x·Wu to bf16: ROADMAP R5) against
#: autograd through the kernel's plain version (float32 products): relative
#: L2 of each input's gradient.  On the CPU in bf16 the two differ by
#: 3.2e-3 to 4.2e-3; about 4 x that, set before the first reading.
MOE_GRAD_REL_L2 = 1.5e-2
#: The SSD Function's gradients (recomputed through ssd_chunked, float32)
#: against autograd through the kernel's plain version (the same float32
#: arithmetic): equal on the CPU; on the card float32 sums may run in
#: another order.
SSD_GRAD_REL_L2 = 1e-3
#: Training's gradient check: a copy of Qwen3-1.7B cut to 2 layers at full
#: width, one batch of 512 tokens, bf16 on the card through the kernels
#: against float32 on the CPU through the plain path.  On the CPU (bf16
#: plain path against float32) the loss reads 1.2e-5 relative and the
#: gradient leaves 1.1e-2 to 1.6e-2 relative L2; the kernels add their P
#: and dS roundings (about 2e-3 on attention's gradients).  Bars about 3 x
#: and 80 x those, set before the first reading on the card.
TRAIN_LOSS_REL = 1e-3
TRAIN_GRAD_REL_L2 = 5e-2
#: Clock cycles the card sleeps ahead of each timed window (about 55 ms at
#: 1.8 GHz), longer than the host takes to enqueue the ten calls of a
#: kernel's window.  Without it a host stall inside the window left the card
#: idle, and flash_dq's mean time at the training shape spread from 0.356 to
#: 0.501 ms over three runs of one tree on an H100; with it, one run in
#: three still read 6.242 ms (a stall longer than the sleep), hence the
#: median of calls timed one by one (cuda_ms).
PREFILL_CYCLES = 100_000_000
#: H100 SXM published peaks (NVIDIA data sheet): float64 vector rate,
#: dense bf16 and TF32 tensor-core rates and HBM bandwidth, at the full
#: 700 W limit.
FP64_FLOPS = 34e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
#: Lanes of an SM's integer ALU pipe (the rotates and xors of Threefry run
#: only there), and the H100's SMs.  The SM clock is the card's own maximum
#: (max_sm_clock_hz), not a data-sheet constant.
ALU_LANES_PER_SM, SM_COUNT = 64, 132
#: Threefry-2x32 work a pair of job and sample needs for the .x word: 20
#: adds, 19 rotates, 19 xors and 9 key injections (the last round's rotate
#: and xor and the last x1 injection feed only .y), 38 of them ALU-only.
THREEFRY_OPS, THREEFRY_ALU_OPS = 67, 38
SOJOURN_SRC = "src/repro_torch/kernels/sojourn_eval/csrc/"
REPLACES = {
    "sojourn_enum": "src/repro/kernels/sojourn_eval/kernel.py:162",
    "sojourn_outcomes": "src/repro/kernels/sojourn_eval/kernel.py:256",
    "sojourn_mc": "src/repro/kernels/sojourn_eval/kernel.py:367",
    "dynamic_sojourn_enum": "src/repro/kernels/sojourn_eval/dynamic.py:351",
    "dynamic_sojourn_mc": "src/repro/kernels/sojourn_eval/dynamic.py:410",
    "flash_fwd": "src/repro/kernels/flash_attention/kernel.py:163",
    "flash_dkv": "src/repro/kernels/flash_attention/kernel.py:267",
    "flash_dq": "src/repro/kernels/flash_attention/kernel.py:364",
    "ssd_fwd": "src/repro/kernels/ssd_scan/kernel.py:106",
    "moe_ffn_fwd": "src/repro/kernels/moe_gemm/kernel.py:74",
}
SOURCES = {
    "sojourn_enum": SOJOURN_SRC + "sojourn_static.cu",
    "sojourn_outcomes": SOJOURN_SRC + "sojourn_static.cu",
    "sojourn_mc": SOJOURN_SRC + "sojourn_static.cu",
    "dynamic_sojourn_enum": SOJOURN_SRC + "sojourn_dynamic.cu",
    "dynamic_sojourn_mc": SOJOURN_SRC + "sojourn_dynamic.cu",
    "flash_fwd": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
    "flash_dkv": "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
    "flash_dq": "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
    "ssd_fwd": "src/repro_torch/kernels/ssd_scan/csrc/ssd_fwd.cu",
    "moe_ffn_fwd": "src/repro_torch/kernels/moe_gemm/csrc/moe_ffn.cu",
}
SEED = 0x5EED_CAFE
#: Sources whose ptxas log must show no spill and no serialized wgmma
#: (info C7518, which makes ptxas wait for each product before the next).
CLEAN_PTXAS = ("flash_fwd", "flash_bwd", "moe_ffn", "sojourn_dynamic", "sojourn_static",
               "ssd_fwd")
WGMMA_SERIALIZED = "wgmma.mma_async instructions are serialized"
#: The serving phases: 4 requests of 2048 prompt tokens, 32 steps each.
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2048, 32
#: Mixtral-8x22B's depth on one card: 12 of 56 layers, about 61 GB of bf16
#: weights at full width.
MIXTRAL_LAYERS = 12
#: Kimi-K2 on one card: 1 of 61 layers at full width, 38.7 GB of bf16
#: weights (384 experts of 3 x 7168 x 2048, 33.8 GB; the untied embedding
#: and head, 4.7 GB).  Its peak must stay within KIMI_PEAK_GB (the weights,
#: the float32 prefill logits of 4 x 2048 x 163,840, 5.4 GB, and the
#: dispatch; 70 leaves a tenth of the card free).  Decode against prefill
#: runs on a no-drop copy (capacity factor E / k = 48, so each of the 384
#: experts holds every token of a group) with 4 x 128 prompt tokens, which
#: keeps its dispatched rows at 2.8 GB.  Its bar is Mixtral's, 0.15 relative
#: L2, set before the first reading: one layer adds less rounding than 12,
#: and the router's near-ties move a request's logits as in Mixtral.
KIMI_LAYERS, KIMI_PEAK_GB, KIMI_NO_DROP_PROMPT, KIMI_REL_L2 = 1, 70.0, 128, 0.15
#: Jamba-v0.1 on one card (phase 5e): JAMBA_LAYERS of its 32 layers, one
#: whole period (1 attention and 7 Mamba layers, 4 MoE and 4 dense FFNs) at
#: full width, 13.3e9 parameters, 26.5 GB of bf16 weights.  Its Mamba scan
#: runs at JAMBA_SSD_SHAPE (B, H, G, S, N, P, chunk) in the prefill.  Decode
#: step 1 against a prefill one token longer runs on a no-drop copy
#: (capacity factor E / k = 8) with JAMBA_NO_DROP_PROMPT prompt tokens: a
#: prompt shorter than one 256-step chunk, and the longer one a whole chunk,
#: as the scan requires.  Its bar, set before the first reading: on the CPU
#: a copy narrowed to d_model 512 reads 1.6e-2 in bf16; the full width adds
#: roundings as Qwen3-8B's 36 layers do (4.5e-2 on the card) and the
#: router's near-ties move a request as in Mixtral, so Mixtral's 0.15.  A
#: wrong cache slot, conv tail or state reads about 1.4.
JAMBA, JAMBA_LAYERS = "jamba-v0.1-52b", 8
JAMBA_SSD_SHAPE = (SERVE_BATCH, 128, 1, SERVE_PROMPT, 16, 64, 256)
JAMBA_NO_DROP_PROMPT, JAMBA_REL_L2 = 255, 0.15
#: Llama-3.2-Vision-11B, the whole model (phase 5f), over the stub's 1,664
#: image tokens.  Every period's cross-attention gate is set to VISION_GATE
#: after init (the init's 0 makes the cross blocks add exactly nothing).
#: Decode step 1 against a prefill one token longer with the same image:
#: bar 0.1, as Qwen3-8B's (40 layers here against 36; the cross attention
#: runs through flash_fwd on both sides); a narrowed copy (d_model 1024, 10
#: layers) reads 1.3e-2 on the CPU.  The cross path is live when decode step
#: 1 at VISION_LIVE_PROMPT against a second image's memory moves the logits
#: by more than VISION_LIVE_FLOOR relative L2: that narrowed copy moves them
#: by 4.3e-2 at 5 layers and 1.8e-2 at 10, a zero gate or an ignored memory
#: by exactly 0; so 1e-3, set before the first reading.
VISION, VISION_IMAGE_TOKENS = "llama-3.2-vision-11b", 1664
VISION_GATE, VISION_REL_L2, VISION_LIVE_PROMPT, VISION_LIVE_FLOOR = 1.0, 0.1, 256, 1e-3
#: Seamless-M4T-large-v2, the whole model (phase 5g), its frames tracking
#: the prompt (frontend_frames = SERVE_PROMPT).  Decode step 1 against a
#: prefill one token longer with the same frames: bar 0.1, as Qwen3-8B's
#: (24 decoder layers); a narrowed copy (d_model 512, 6 + 6 layers) reads
#: 1.4e-2 on the CPU.
SEAMLESS, SEAMLESS_REL_L2 = "seamless-m4t-large-v2", 0.1
#: Phase 8, the examples on the card, through their main(argv).
EXAMPLE_TRAIN_ARGS = ["--preset", "100m", "--stages", "3", "--steps-per-stage", "20"]
EXAMPLE_CLUSTER_ARGS = ["--jobs", "6", "--servers", "2", "--stages", "3",
                        "--steps-per-stage", "3"]
#: The group of evaluate_many past the int64 outcome count: 80 two-stage
#: jobs, streamed with 2**20 samples.
LARGE_GROUP, LARGE_GROUP_SAMPLES = 80, 1 << 20
#: Phase 9, the meshed programs on a (1, 1) mesh of one NCCL rank: the
#: relative L2 error allowed against the unmeshed runs (their logits, the
#: train step's loss); Qwen3-1.7B's meshed train steps (one micro-batch of
#: MESH_TRAIN_BATCH x TRAIN_SEQ each); Jamba's long_500k decode (batch 1, a
#: cache of LONG_CACHE tokens filled from the seed, LONG_STEPS steps); the
#: dry run's cells on the (16, 16) mesh.
MESH_REL_L2 = 1e-3
MESH_TRAIN_BATCH, MESH_TRAIN_STEPS = 2, 2
LONG_CACHE, LONG_STEPS = 524_288, 8
#: Seamless-M4T-large-v2's meshed train step (phase 9e) at full width and
#: depth: MESH_TRAIN_BATCH sequences of SEAMLESS_TRAIN_SEQ tokens over as
#: many frames, so that the unmeshed run and then the meshed one each fit
#: one card (2.03e9 parameters: 4.1 GB of bf16 weights, 16.3 GB of float32
#: AdamW moments, 4.1 GB of bf16 gradients, and the float32 logits of 2 x
#: 2048 x 256,206, 4.2 GB, with their gradient).
SEAMLESS_TRAIN_SEQ = 2048
#: The meshed checkpoint (phase 9f): Qwen3-1.7B at CKPT_LAYERS layers, full
#: width (0.41e9 parameters: 4.1 GB of bf16 weights and float32 moments on
#: disk), CKPT_STEPS steps saved, as many resumed, against an unbroken run.
CKPT_LAYERS, CKPT_STEPS = 2, 2
DRYRUN_CELLS = (("qwen3-8b", "train_4k"), ("qwen3-8b", "decode_32k"),
                ("qwen3-8b", "prefill_32k"), ("mixtral-8x22b", "long_500k"),
                ("seamless-m4t-large-v2", "decode_32k"))
#: Phase 9h's cells in the serving-weight layout, each also among
#: DRYRUN_CELLS in the default one.
DRYRUN_TP_CELLS = (("qwen3-8b", "decode_32k"), ("qwen3-8b", "prefill_32k"))
#: The study phase (4b): the numerical study's sweep (N = 3-8 two-stage
#: jobs) for workload sets STUDY_SETS, STUDY_TRIALS groups a (set, N) and
#: STUDY_TRIALS_LAST at N = 8, each through evaluate_many on the card and
#: again on the CPU.
STUDY_SETS, STUDY_TRIALS, STUDY_TRIALS_LAST = (1, 4), 6, 2
#: (workload sets, N) of the table that phase 4b also drives through
#: ``repro_torch.launch.study``, at its CI-scale trials (400 at N = 3).
TABLE_STUDY = ((1,), (3,))
#: Its DES check: DES_GROUPS ragged groups of DES_JOBS jobs of 1 to
#: DES_MAX_STAGES stages with at least DES_MIN_COMBOS outcome combinations,
#: every combination simulated on each of DES_SERVERS servers.
DES_GROUPS, DES_JOBS, DES_MAX_STAGES, DES_MIN_COMBOS, DES_SERVERS = 3, 6, 3, 64, (1, 2, 3)
#: Its online study: the whole synthetic trace (TRACE.n_jobs, seed 13, as
#: the study's table_trace makes it), one policy on one server count.
TRACE_SERVERS, TRACE_POLICY = 5, "rank"
#: The training phase: Qwen3-1.7B at full width and depth at train_4k's
#: 4,096 tokens, its global batch of 256 sequences cut to 4 a step, as 2
#: micro-batches of 2; 9 optimizer steps, the first the warm-up, the
#: learning rate warmed up over 2.
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = "qwen3-1.7b", 4096, 4, 2
TRAIN_STEPS, TRAIN_LR_WARMUP = 9, 2
#: The gradient check: layers of the cut copy, and tokens of its one batch.
GRAD_CHECK_LAYERS, GRAD_CHECK_TOKENS = 2, 512


class PhaseFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


def rel_err(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


def abs_err(got, want) -> float:
    import numpy as np

    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def cuda_ms(fn, reps: int):
    """(median milliseconds of one ``fn()`` on the card over ``reps`` calls,
    each between its own pair of CUDA events; the last call's result).  The
    card first sleeps for PREFILL_CYCLES while the host enqueues the calls,
    so they run back to back; a host stall longer than that idles the card
    inside the call it delays, which the median leaves out."""
    import statistics

    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(PREFILL_CYCLES)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        out = fn()
        end.record()
    events[-1][1].synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events), out


def launch_counters() -> list[dict]:
    """The launch-count dicts of every kernel wrapper."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.moe_gemm import kernel as MK
    from repro_torch.kernels.sojourn_eval import dynamic as D
    from repro_torch.kernels.sojourn_eval import kernel as K
    from repro_torch.kernels.ssd_scan import kernel as SK

    return [K.launches, D.launches, FK.launches, SK.launches, MK.launches]


def reset_counts() -> None:
    for counter in launch_counters():
        for name in counter:
            counter[name] = 0


def read_counts() -> dict:
    return {name: c for counter in launch_counters() for name, c in counter.items()}


def check_against_plain(report, name, shape, got, want) -> None:
    """Hold a kernel's (e_succ, e_all) against its plain version's."""
    import numpy as np

    got = [t.cpu().numpy() for t in got]
    want = [t.cpu().numpy() for t in want]
    require(all(np.all(np.isfinite(g)) for g in got), f"{name} {shape}: non-finite output")
    rel = max(rel_err(g, w) for g, w in zip(got, want))
    err = max(abs_err(g, w) for g, w in zip(got, want))
    r = report.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["max_rel_err"] = max(r["max_rel_err"], rel)
    log(f"[kernel vs plain] {name} {shape}: e_succ[:3]={got[0][:3]} max rel err {rel:.3e} "
        f"abs {err:.3e}")
    require(rel <= RTOL, f"{name} {shape}: rel err {rel:.3e} > {RTOL}")


# ---------------------------------------------------------------------------
# Kernel inputs from a workload, as the ops build them
# ---------------------------------------------------------------------------


def static_args(jobs, orders, dev, samples=None):
    from repro_torch.core import policies
    from repro_torch.kernels.sojourn_eval import ops

    return ops.static_kernel_args(*policies.padded_arrays(jobs), orders, dev, samples)


def dynamic_args(jobs, tables, dev, samples=None):
    import numpy as np

    from repro_torch.core import policies
    from repro_torch.kernels.sojourn_eval import dynamic as D

    _, probs, num_stages = policies.padded_arrays(jobs)
    return D.dynamic_kernel_args(probs, policies.stage_durations(jobs), num_stages,
                                 np.stack(tables), dev, samples)


# ---------------------------------------------------------------------------
# Bounds: float64 operations per lane x lanes over the float64 peak
# ---------------------------------------------------------------------------


def static_flops(jobs, orders, count: int, mc: bool) -> float:
    """Float64 operations that the static function needs for the orders
    ``orders`` (P, N).  MC: per position M CDF compares, the uniform's
    scaling and the two completion-time adds, per success (in
    expectation) one add, per sample the Eq. (7)/(9) tail (two divides,
    two products, two sums).  Enumeration: a walk that shares service-order
    prefixes serves position q once for each distinct prefix through q,
    prod_{i <= q} M_(i) times (3 operations: the weight product and two
    completion-time adds), adds the success for each such prefix that
    ends in a success at q, prod_{i < q} M_(i) of them, and gives each of
    the K combinations the six-operation tail.  Integer work, Threefry's
    uint32 arithmetic and selects are not counted."""
    import numpy as np

    from repro_torch.core import policies

    _, probs, num_stages = policies.padded_arrays(jobs)
    orders = np.asarray(orders)
    if mc:
        n, m = probs.shape
        p_succ = probs[np.arange(n), num_stages - 1]
        return len(orders) * (count * ((m + 3) * n + 6) + count * float(p_succ.sum()))
    stages = num_stages[orders].astype(np.float64)  # (P, N), in service order
    prefixes = np.cumprod(stages, axis=1)  # distinct prefixes through q
    successes = prefixes / stages  # those of them that succeed at q
    return float(3.0 * prefixes.sum() + successes.sum() + 6.0 * count * len(orders))


def static_flops_full_decode(jobs, n_orders: int, count: int) -> float:
    """The enumeration's float64 count when every combination serves all N
    positions (the weight product and two adds each), plus one add a
    success and the six-operation tail: the bound of a kernel that decodes
    each combination on its own, reported beside :func:`static_flops`'s."""
    from repro_torch.core import policies

    _, _, num_stages = policies.padded_arrays(jobs)
    n = len(num_stages)
    succ_adds = float(sum(count // r for r in num_stages))
    return n_orders * (count * (3 * n + 6) + succ_adds)


def dynamic_flops(jobs, n_pols: int, count: int, mc: bool) -> float:
    """Float64 operations the dynamic function needs on one server (the
    timed runs), per lane: the decode (N weight products, or per job its
    M_i - 1 CDF compares and the uniform's scaling), one clock add per
    seat (job i runs s_i + 1 stages, so sum_i (s_i + 1) seats), one
    completion add per job, one add per success and the six-operation
    tail.  On one server the finished job is the one running, so a pop
    needs no compare.  Seats and successes are exact for the enumeration
    (each stop stage of job i lies in K / M_i combinations) and their
    expectation for MC.  The index compares among queued jobs are not
    counted (their number depends on the data and on how the queue is
    kept), nor are integer ops and selects, so the bound is a lower one."""
    import numpy as np

    from repro_torch.core import policies

    _, probs, num_stages = policies.padded_arrays(jobs)
    n = len(num_stages)
    p_succ = probs[np.arange(n), num_stages - 1]
    if mc:
        decode = float(num_stages.sum())
        seats = count * sum(float((np.arange(r) + 1) @ probs[i, :r])
                            for i, r in enumerate(num_stages))
        succ_adds = count * float(p_succ.sum())
    else:
        decode = float(n)
        seats = count * float((num_stages + 1).sum()) / 2
        succ_adds = float(sum(count // r for r in num_stages))
    return n_pols * (count * (decode + n + 6) + seats + succ_adds)


def outcomes_flops(outcomes, num_stages, n_orders: int) -> float:
    """Float64 operations of ``sojourn_outcomes`` on this table: per
    position two completion-time adds, one add per success (counted in
    the table), and per row the six-operation Eq. (7)/(9) tail."""
    import numpy as np

    k_total, n = outcomes.shape
    successes = int(np.count_nonzero(outcomes == np.asarray(num_stages)[None, :] - 1))
    return n_orders * (k_total * (2 * n + 6) + successes)


def attention_pairs(b: int, hq: int, sq: int, skv: int, causal: bool) -> int:
    """Visible (query, key) pairs of one attention call, over every head."""
    return b * hq * (sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv)


def flash_flops(b: int, hq: int, sq: int, skv: int, d: int, causal: bool) -> float:
    """Tensor-core operations of one attention forward: 2 * D for each
    visible (query, key) pair in each of QK^T and PV."""
    return 4.0 * d * attention_pairs(b, hq, sq, skv, causal)


def ssd_work(b, h, g, s, n, p, chunk) -> dict:
    """What one SSD scan needs, whatever computes it: per chunk, C·Bᵀ (2N)
    and the scores times x (2P) for each visible (t, s) pair, t >= s, and
    the carried-state term and the state update (2 C N P each): ``bf16``
    tensor operations (C·Bᵀ, both operands bf16) and ``tf32`` ones (the
    three products with a float32 operand); ``f32``, the mask's float32
    work for each visible pair (the exponential, the subtraction and two
    multiplies); ``bytes``, x, dt, dA, B, C read once and y and the state
    written once."""
    pairs = chunk * (chunk + 1) / 2
    chunks = b * h * (s // chunk)
    return {
        "bf16": chunks * 2.0 * n * pairs,
        "tf32": chunks * (2.0 * p * pairs + 4.0 * chunk * n * p),
        "f32": chunks * 4.0 * pairs,
        "bytes": (b * h * s * p * 2 * 2 + b * h * s * 4 * 2 + b * g * s * n * 2 * 2
                  + b * h * n * p * 4),
    }


def ssd_bound(work: dict) -> tuple[float, str]:
    """The least time: the largest of the tensor-core part (C·Bᵀ over the
    bf16 peak plus the float32-operand products over the TF32 peak, half
    the bf16 rate), the mask over the float32 vector peak (the two units can
    run at once) and the bytes over the memory rate."""
    times = {"operations": max(work["bf16"] / BF16_FLOPS + work["tf32"] / TF32_FLOPS,
                               work["f32"] / FP32_FLOPS) * 1e3,
             "bytes": work["bytes"] / HBM_BYTES_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def ssd_bound_cuda_cores(work: dict) -> tuple[float, str]:
    """The bound when only C·Bᵀ runs on the tensor cores and the three
    float32-operand products on the float32 vector units (the mask left
    out): reported beside :func:`ssd_bound`'s."""
    times = {"operations": max(work["bf16"] / BF16_FLOPS, work["tf32"] / FP32_FLOPS) * 1e3,
             "bytes": work["bytes"] / HBM_BYTES_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def threefry_alu_ops(n_jobs: int, n_samples: int) -> float:
    """ALU-only operations of the Threefry stream a streamed evaluation
    needs: one block for each pair of job and sample (x0 = sample, x1 =
    original job id, the .x word), whatever the orders or policies (they
    all see the same stream, so a kernel could share the blocks among
    them, and none can shorten a block)."""
    return float(THREEFRY_ALU_OPS) * n_jobs * n_samples


_CLOCK: list[float] = []


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, from ``nvidia-smi`` (read once)."""
    if not _CLOCK:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
        _CLOCK.append(float(out.stdout.split()[0]) * 1e6)
    return _CLOCK[0]


def bound_terms(flops: float, in_bytes: int, out_bytes: int, peak: float = FP64_FLOPS,
                alu_ops: float = 0.0) -> dict[str, float]:
    """Milliseconds of the three terms of a bound: ``operations`` (flops at
    ``peak``), ``integer`` (ALU-only integer operations over 132 SMs x 64
    lanes x the card's maximum SM clock) and ``bytes`` (each input read and
    each output written once at the HBM rate)."""
    terms = {"operations": flops / peak * 1e3,
             "bytes": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3}
    if alu_ops:
        terms["integer"] = alu_ops / (SM_COUNT * ALU_LANES_PER_SM * max_sm_clock_hz()) * 1e3
    return terms


def bound_ms(flops: float, in_bytes: int, out_bytes: int, peak: float = FP64_FLOPS,
             alu_ops: float = 0.0) -> tuple[float, str]:
    """(the largest term of :func:`bound_terms`, its name)."""
    terms = bound_terms(flops, in_bytes, out_bytes, peak, alu_ops)
    by = max(terms, key=terms.get)
    return terms[by], by


def contract_by(by: str) -> str:
    """The kernel line's ``bound_by``: integer operations are operations."""
    return "bytes" if by == "bytes" else "operations"


def tensor_bytes(args) -> int:
    import torch

    return sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build() -> None:
    import re

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} libraries in {time.perf_counter() - t0:.1f} s "
        f"({_build.BUILD_DIR})")
    faults = []
    for stem, out in logs.items():
        for line in out.splitlines():
            if any(key in line for key in ("Compiling entry function", "registers", "spill",
                                            "Potential Performance Loss")):
                log(f"  {stem}: {line.strip()}")
            if stem not in CLEAN_PTXAS:
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if (spill and (int(spill.group(1)) or int(spill.group(2)))) or \
                    WGMMA_SERIALIZED in line:
                faults.append(f"{stem}: {line.strip()}")
    require(not faults, "ptxas reports a spill or serialized wgmmas in "
            f"{CLEAN_PTXAS}: " + "; ".join(faults))


def phase_kernels(dev, report) -> None:
    """Phase 1: every kernel against its plain version on the card, at mid
    sizes and at the N=8, M=3 shapes of the OPTIMAL cell."""
    import numpy as np
    import torch

    from repro_torch.core import evaluator, policies
    from repro_torch.core.jobs import JobSpec, generate_workload
    from repro_torch.kernels.sojourn_eval import dynamic as D
    from repro_torch.kernels.sojourn_eval import kernel as K

    def compare(name, shape, kernel, plain, args, kwargs=None, time_it=False, twice=False):
        kwargs = kwargs or {}
        label = f"{shape} {kwargs}" if kwargs else shape
        got = kernel(*args, **kwargs)
        check_against_plain(report, name, label, got, plain(*args, **kwargs))
        if twice:
            again = kernel(*args, **kwargs)
            require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                    f"{name} {label}: a second call differs from the first")
        if time_it:
            r = report[name]
            r["phase1_shape"] = shape
            r["phase1_ms"], _ = cuda_ms(lambda: kernel(*args, **kwargs), 3)
            r["phase1_plain_ms"], _ = cuda_ms(lambda: plain(*args, **kwargs), 1)
            log(f"  kernel {r['phase1_ms']:.3f} ms, plain {r['phase1_plain_ms']:.3f} ms")

    phase_new_regimes(dev, report)
    phase_small_head_dims(dev, report)
    rng = np.random.default_rng(20)
    jobs = generate_workload(rng, 20)
    rank = policies.rank_order(jobs)
    orders = np.stack([rank, rank[::-1], rng.permutation(20)])
    compare("sojourn_enum", "N=20 M=2 K=2^20 P=3", K.sojourn_enum,
            K.sojourn_enum_torch, static_args(jobs, orders, dev), time_it=True)
    compare("sojourn_mc", "N=20 M=2 S=2^20 P=3", K.sojourn_mc, K.sojourn_mc_torch,
            static_args(jobs, orders, dev, (SEED, 1 << 20)), time_it=True, twice=True)
    # the Monte-Carlo kernel's integer decode and tables: M = 3 and 4; a CDF
    # that starts at 0, reaches 1 early and sits on multiples of 2^-32; N =
    # 1228 and 1229 on both sides of the first kernel's shared-memory limit
    # (P5); N = 8000, whose tables pass a block's shared memory (read
    # through L1)
    edge = [JobSpec(sizes=[1.0, 2.0, 4.0], probs=[0.0, 0.5, 0.5], job_id=0),
            JobSpec(sizes=[0.5, 1.5, 2.5], probs=[0.25, 0.75, 0.0], job_id=1),
            JobSpec(sizes=[2.0, 3.0], probs=[1.0, 0.0], job_id=2),
            JobSpec(sizes=[1.0], probs=[1.0], job_id=3),
            JobSpec(sizes=[0.75, 1.0, 3.0], probs=[2.0**-32, 0.5, 0.5 - 2.0**-32], job_id=4)]
    rng = np.random.default_rng(5)
    for label, mc_jobs, n_orders, log2_samples in (
            ("N=20 M=3", generate_workload(np.random.default_rng(203), 20, 3), 3, 16),
            ("N=12 M=4", generate_workload(np.random.default_rng(124), 12, 4), 3, 16),
            ("N=5 M=3, CDF edges", edge, 4, 16),
            ("N=1228 M=2", generate_workload(np.random.default_rng(1228), 1228), 1, 12),
            ("N=1229 M=2", generate_workload(np.random.default_rng(1229), 1229), 1, 12),
            ("N=8000 M=2, tables through L1", generate_workload(rng, 8000), 1, 10)):
        n = len(mc_jobs)
        orders = np.stack([rng.permutation(n) for _ in range(n_orders)])
        compare("sojourn_mc", f"{label} S=2^{log2_samples} P={n_orders}", K.sojourn_mc,
                K.sojourn_mc_torch, static_args(mc_jobs, orders, dev, (SEED, 1 << log2_samples)),
                twice=True)

    jobs = generate_workload(np.random.default_rng(16), 16)
    tables = [policies.index_table(jobs, "sr"), policies.index_table(jobs, "serpt")]
    for w in (1, 2, 3):
        compare("dynamic_sojourn_enum", "N=16 M=2 K=2^16 P=2 (SR, SERPT)",
                D.dynamic_sojourn_enum, D.dynamic_sojourn_enum_torch,
                dynamic_args(jobs, tables, dev), {"n_servers": w},
                time_it=w == 1, twice=True)
    for w in (1, 2, 3):
        compare("dynamic_sojourn_mc", "N=16 M=2 S=2^18 P=2 (SR, SERPT)",
                D.dynamic_sojourn_mc, D.dynamic_sojourn_mc_torch,
                dynamic_args(jobs, tables, dev, (SEED, 1 << 18)),
                {"n_servers": w}, time_it=w == 1, twice=True)

    # the OPTIMAL cell's shapes: 512-order batches of 8 jobs x 3 stages; the
    # enumeration there is timed too (the median of 10 calls)
    rng = np.random.default_rng(8)
    jobs = generate_workload(rng, 8, 3)
    orders = np.stack([rng.permutation(8) for _ in range(512)])
    optimal_args = static_args(jobs, orders, dev)
    compare("sojourn_enum", "N=8 M=3 K=3^8 P=512", K.sojourn_enum, K.sojourn_enum_torch,
            optimal_args, twice=True)
    cuda_ms(lambda: K.sojourn_enum(*optimal_args), 2)  # warm up
    optimal_ms, _ = cuda_ms(lambda: K.sojourn_enum(*optimal_args), 10)
    report["sojourn_enum"].update(optimal_shape="N=8 M=3 K=3^8 P=512 (the OPTIMAL search's "
                                  "batches)", optimal_shape_ms=optimal_ms)
    log(f"  sojourn_enum N=8 M=3 K=3^8 P=512: {optimal_ms:.4f} ms, median of 10 calls")
    tables = [policies.index_table(jobs, "sr"), policies.index_table(jobs, "serpt")]
    compare("dynamic_sojourn_enum", "N=8 M=3 K=3^8 P=2 (SR, SERPT)",
            D.dynamic_sojourn_enum, D.dynamic_sojourn_enum_torch,
            dynamic_args(jobs, tables, dev), twice=True)

    # fault R2: a job that never succeeds has rank index +inf
    jobs = generate_workload(np.random.default_rng(12), 12)
    jobs[5] = JobSpec(sizes=[1.0, 3.0], probs=[1.0, 0.0], job_id=jobs[5].job_id)
    table = policies.index_table(jobs, "rank")
    require(bool(np.isinf(table).any()), "the R2 case has no +inf rank index")
    compare("dynamic_sojourn_enum", "N=12 M=2 K=2^12 P=1 (rank table with a +inf index)",
            D.dynamic_sojourn_enum, D.dynamic_sojourn_enum_torch,
            dynamic_args(jobs, [table], dev), twice=True)

    # groups past 64 jobs: 65 of which 17 have two stages (K = 2**17)
    # enumerated on 1 and 2 servers; 80 and 160 two-stage jobs streamed
    # (registers and shared memory); R2's +inf index at N = 66
    rng = np.random.default_rng(65)
    mixed = []
    for i in range(65):
        first, two = float(rng.uniform(0.5, 3.0)), i % 4 == 0
        mixed.append(JobSpec(sizes=[first, first + 1.5] if two else [first],
                             probs=[0.3, 0.7] if two else [1.0], job_id=i))
    tables = [policies.index_table(mixed, "sr"), policies.index_table(mixed, "serpt")]
    for w in (1, 2):
        compare("dynamic_sojourn_enum", "N=65 (17 of two stages) K=2^17 P=2 (SR, SERPT)",
                D.dynamic_sojourn_enum, D.dynamic_sojourn_enum_torch,
                dynamic_args(mixed, tables, dev), {"n_servers": w}, twice=True)
    for n, log2_samples in ((80, 16), (160, 14)):
        jobs = generate_workload(np.random.default_rng(n), n)
        tables = [policies.index_table(jobs, "sr"), policies.index_table(jobs, "serpt")]
        compare("dynamic_sojourn_mc", f"N={n} M=2 S=2^{log2_samples} P=2 (SR, SERPT)",
                D.dynamic_sojourn_mc, D.dynamic_sojourn_mc_torch,
                dynamic_args(jobs, tables, dev, (SEED, 1 << log2_samples)), twice=True)
    jobs = generate_workload(np.random.default_rng(66), 66)
    jobs[9] = JobSpec(sizes=[1.0, 3.0], probs=[1.0, 0.0], job_id=jobs[9].job_id)
    compare("dynamic_sojourn_mc", "N=66 M=2 S=2^14 P=1 (rank table with a +inf index)",
            D.dynamic_sojourn_mc, D.dynamic_sojourn_mc_torch,
            dynamic_args(jobs, [policies.index_table(jobs, "rank")], dev, (SEED, 1 << 14)),
            twice=True)

    # the dynamic kernel's limits (csrc/sojourn_dynamic.cu): one and two mask
    # words (N M = 64, 65), the last register template and the shared-memory
    # path (N M = 256, 258), the last register slots and the shared-memory
    # path (W = 8, 9), W >= N in registers and in shared memory, and a
    # block's state past SHARED_STATE_BYTES in device scratch (W = 30 at
    # N = 30; 24 mask words at N = 737)
    def group(n, stages, seed):
        """``n`` jobs, job i of ``stages[i]`` stages (one past the list)."""
        rng = np.random.default_rng(seed)
        out = []
        for i in range(n):
            k = stages[i] if i < len(stages) else 1
            out.append(JobSpec(sizes=np.cumsum(rng.uniform(0.5, 3.0, k)).tolist(),
                               probs=[1.0 / k] * k, job_id=i))
        return out

    def dyn(label, jobs, w, samples=None, pols=("sr", "serpt")):
        mc = samples is not None
        compare("dynamic_sojourn_mc" if mc else "dynamic_sojourn_enum", label,
                D.dynamic_sojourn_mc if mc else D.dynamic_sojourn_enum,
                D.dynamic_sojourn_mc_torch if mc else D.dynamic_sojourn_enum_torch,
                dynamic_args(jobs, [policies.index_table(jobs, p) for p in pols], dev, samples),
                {"n_servers": w}, twice=True)

    dyn("N=32 (16 of two stages) K=2^16, N M = 64", group(32, [2] * 16, 32), 1)
    dyn("N=13 (one of five stages, six of two) K=320, N M = 65", group(13, [5] + [2] * 6, 13),
        2)
    j128 = generate_workload(np.random.default_rng(128), 128)
    dyn("N=128 M=2 S=2^14, N M = 256", j128, 1, (SEED, 1 << 14))
    j129 = generate_workload(np.random.default_rng(129), 129)
    dyn("N=129 M=2 S=2^14, N M = 258: shared memory", j129, 1, (SEED, 1 << 14))
    dyn("N=129 (14 of two stages) K=2^14, N M = 258: shared memory",
        group(129, [2] * 14, 129), 3)
    j16 = generate_workload(np.random.default_rng(16), 16)
    for w in (8, 9):
        dyn(f"N=16 M=2 S=2^16 W={w}", j16, w, (SEED, 1 << 16))
    dyn("N=16 M=2 K=2^16 W=16 (W >= N): shared memory", j16, 16)
    j5 = generate_workload(np.random.default_rng(5), 5, 3)
    for w in (4, 5):
        dyn(f"N=5 M=3 K=3^5 W={w}: registers", j5, w)
    dyn("N=30 (10 of two stages) K=2^10 W=30: device scratch", group(30, [2] * 10, 30), 30)
    j737 = generate_workload(np.random.default_rng(737), 737)
    dyn("N=737 M=2 S=2^12, 24 mask words: device scratch", j737, 1, (SEED, 1 << 12), ("sr",))

    # P4: tables with a NaN and a -inf index, through both dynamic kernels on
    # 1 and 2 servers (the plain version seats a -inf index first and never a
    # NaN one, as the kernel's ranks do): the three-job probe of ROADMAP P4
    # and an 8-job group
    probe = [JobSpec(sizes=[1.0, 3.0], probs=[0.3, 0.7], job_id=0),
             JobSpec(sizes=[1.5, 2.0], probs=[0.5, 0.5], job_id=1),
             JobSpec(sizes=[2.0, 3.0], probs=[0.2, 0.8], job_id=2)]
    j8 = generate_workload(np.random.default_rng(88), 8)
    for label, jobs, base in (("N=3 M=2 (the P4 probe)", probe,
                               np.array([[1.0, 2.0], [0.0, 3.0], [0.7, 0.2]])),
                              ("N=8 M=2", j8, policies.index_table(j8, "sr"))):
        tables = []
        for value, at in ((math.nan, ((1, 0),)), (-math.inf, ((1, 0),)),
                          (math.nan, ((0, 1), (2, 0))), (-math.inf, ((2, 1), (0, 0)))):
            table = np.array(base, dtype=np.float64)
            for j, st in at:
                table[j, st] = value
            tables.append(table)
        for w in (1, 2):
            compare("dynamic_sojourn_enum", f"{label} NaN and -inf tables P=4",
                    D.dynamic_sojourn_enum, D.dynamic_sojourn_enum_torch,
                    dynamic_args(jobs, tables, dev), {"n_servers": w}, twice=True)
            compare("dynamic_sojourn_mc", f"{label} NaN and -inf tables S=2^16 P=4",
                    D.dynamic_sojourn_mc, D.dynamic_sojourn_mc_torch,
                    dynamic_args(jobs, tables, dev, (SEED, 1 << 16)), {"n_servers": w},
                    twice=True)

    # sojourn_enum at its suffix's limits, as kernel.suffix_length picks L
    # from (N, P, K): its largest L (N=24, P=1: MAX_SUFFIX), L = 0 (too few
    # combinations to fill the card), an empty prefix (L = N, P = 2^16) and
    # values between; M = 2, 3 and 4 and mixed radices with single-stage jobs
    def enum_case(label, jobs, n_orders, want_length):
        rng = np.random.default_rng(len(jobs) * n_orders)
        orders = np.stack([rng.permutation(len(jobs)) for _ in range(n_orders)])
        args = static_args(jobs, orders, dev)
        length = K.suffix_length(len(jobs), n_orders, args[-1])
        require(length == want_length, f"sojourn_enum {label}: L={length}, not {want_length}")
        compare("sojourn_enum", f"{label} P={n_orders} L={length}", K.sojourn_enum,
                K.sojourn_enum_torch, args, twice=True)

    enum_case("N=24 M=2 K=2^24", generate_workload(np.random.default_rng(24), 24), 1,
              K.MAX_SUFFIX)
    enum_case("N=12 M=3 K=3^12", generate_workload(np.random.default_rng(12), 12, 3), 1, 1)
    enum_case("N=8 M=4 K=4^8", generate_workload(np.random.default_rng(84), 8, 4), 512, 4)
    enum_case("N=6 M=4 K=4^6, empty prefix", generate_workload(np.random.default_rng(64), 6, 4),
              1 << 16, 6)
    mixed10 = group(10, [3, 2, 4, 1, 2, 3, 2, 4, 2, 3], 10)
    enum_case("N=10 mixed radices K=13824", mixed10, 1, 0)
    enum_case("N=10 mixed radices K=13824", mixed10, 512, 4)
    enum_case("N=7 mixed radices K=288, empty prefix", group(7, [3, 2, 4, 1, 2, 3, 2], 7),
              1 << 16, 7)
    # strides that are not an order's radix's, or a count that is not their
    # product: NaN for those orders on the card as in the plain version, the
    # other orders' results unchanged
    rng = np.random.default_rng(3)
    sizes_p, probs_p, strides_p, radix_p, k_total = static_args(
        mixed10, np.stack([rng.permutation(10) for _ in range(3)]), dev)
    good = K.sojourn_enum(sizes_p, probs_p, strides_p, radix_p, k_total)
    wrong = strides_p.clone()
    wrong[1, 0] += 1
    for label, strides, count, bad in (("a wrong stride in order 1", wrong, k_total, [1]),
                                       ("K - 1", strides_p, k_total - 1, [0, 1, 2])):
        got = K.sojourn_enum(sizes_p, probs_p, strides, radix_p, count)
        plain = K.sojourn_enum_torch(sizes_p, probs_p, strides, radix_p, count)
        for p in range(3):
            for g, pl, gd in zip(got, plain, good):
                want_nan = p in bad
                require(bool(torch.isnan(g[p])) == want_nan == bool(torch.isnan(pl[p])) and
                        (want_nan or bool(g[p] == gd[p])),
                        f"sojourn_enum N=10 mixed radices, {label}: order {p} gives {float(g[p])} "
                        f"on the card, {float(pl[p])} in the plain version")
        log(f"[kernel vs plain] sojourn_enum N=10 mixed radices P=3, {label}: NaN for orders "
            f"{bad} on both, the others unchanged")

    # explicit outcome tables: an enumerated one and a sampled one
    jobs = generate_workload(np.random.default_rng(16), 16)
    rank = policies.rank_order(jobs)
    orders = np.stack([rank, rank[::-1]] + [rng.permutation(16) for _ in range(9)])
    for label, (outcomes, weights) in (
        ("N=16 M=2 K=2^16 enumerated, P=11", evaluator.enumerate_outcomes(jobs)),
        ("N=16 M=2 S=2^18 sampled, P=11", evaluator.sample_outcomes(jobs, 1 << 18, rng)),
    ):
        compare("sojourn_outcomes", label, K.sojourn_outcomes, K.sojourn_outcomes_torch,
                outcomes_args(jobs, orders, outcomes, weights, dev),
                time_it=label.startswith("N=16 M=2 K"), twice=True)

    # the outcome kernel's plan (kernel.outcomes_plan) at its edges: P = 1, 8,
    # 9, 17 and 40 (several groups at N = 192); N = 1, 16, 21 and 32; M = 2 to
    # 4; K below one tile, K not a multiple of the tile's rows and K N 4
    # bytes not a multiple of 16 (50,001 x 21); a zero-weight row in each;
    # N = 191 and 192 on both sides of the first kernel's shared-memory limit
    # (P5); N = 400, the direct kernel
    def outcome_case(n, m, n_orders, n_rows, seed):
        jobs = generate_workload(np.random.default_rng(seed), n, m)
        rng = np.random.default_rng(seed + 1)
        orders = np.stack([policies.rank_order(jobs)]
                          + [rng.permutation(n) for _ in range(n_orders - 1)])
        outcomes, weights = evaluator.sample_outcomes(jobs, n_rows, rng)
        weights = weights.copy()
        weights[n_rows // 2] = 0.0
        plan = K.outcomes_plan(n, m, n_orders)
        compare("sojourn_outcomes", f"N={n} M={m} K={n_rows} P={n_orders} {plan}",
                K.sojourn_outcomes, K.sojourn_outcomes_torch,
                outcomes_args(jobs, orders, outcomes, weights, dev), twice=True)

    for n, m, n_orders, n_rows in ((21, 2, 1, 50_001), (21, 2, 8, 50_001), (21, 2, 9, 50_001),
                                   (21, 2, 17, 50_001), (21, 2, 40, 50_001),
                                   (1, 2, 9, 4099), (16, 2, 9, 4099), (32, 2, 9, 4099),
                                   (16, 3, 17, 3001), (12, 4, 17, 3001), (21, 2, 5, 100),
                                   (191, 2, 9, 3000), (192, 2, 9, 3000), (192, 2, 40, 3000),
                                   (400, 2, 3, 2000)):
        outcome_case(n, m, n_orders, n_rows, n * 1000 + n_orders)
    # shared-memory banks: a warp's threads read consecutive words of the
    # transposed tile whatever gcd(N, 32) is, so the time goes with N
    for n in (16, 21, 32):
        jobs = generate_workload(np.random.default_rng(n), n)
        outcomes, weights = evaluator.sample_outcomes(jobs, 1 << 20, np.random.default_rng(n))
        args = outcomes_args(jobs, policies.rank_order(jobs)[None], outcomes, weights, dev)
        ms, _ = cuda_ms(lambda: K.sojourn_outcomes(*args), 10)
        log(f"  sojourn_outcomes N={n} M=2 K=2^20 P=1: {ms:.4f} ms, median of 10 calls, "
            f"{ms / n * 1e3:.3f} us a job")

    # flash_fwd: causal GQA, a sliding window, ragged non-causal, head dims 64
    # and 112 (Kimi-K2's), rows that see no key
    for shape, time_it in (((2, 8, 2, 512, 512, 128, True, None), True),
                           ((1, 8, 2, 384, 384, 128, True, 100), False),
                           ((1, 4, 1, 100, 300, 64, False, None), False),
                           ((1, 8, 8, 200, 200, 128, True, None), False),
                           ((2, 8, 2, 512, 512, 112, True, None), False),
                           ((1, 8, 4, 384, 384, 112, True, 100), False),
                           ((1, 2, 1, 384, 128, 112, False, 32), False),
                           # Mixtral-8x22B's prefill: group 6, window 4096
                           ((SERVE_BATCH, 48, 8, SERVE_PROMPT, SERVE_PROMPT, 128, True, 4096),
                            False)):
        check_flash(dev, report, shape, time_it)

    # flash_dkv / flash_dq (B, Hq, Hkv, S, D, causal, window): GQA groups 1, 2,
    # 4 and 6, head dims 128, 112 and 64, a sliding window, ragged lengths;
    # then (B, Hq, Hkv, Sq, Skv, D, causal, window) with rows 159 and later
    # seeing no key (their LSE is NEG_INF: the blocks each kernel skips decide
    # them)
    for shape, time_it in (((2, 8, 8, 512, 128, True, None), True),
                           ((1, 8, 4, 384, 128, True, 100), False),
                           ((1, 8, 2, 256, 64, True, None), False),
                           ((1, 12, 2, 320, 128, True, None), False),
                           ((1, 12, 2, 200, 64, True, 64), False),
                           ((1, 8, 4, 384, 112, True, None), False),
                           ((1, 8, 2, 256, 112, True, 64), False),
                           ((1, 12, 2, 200, 112, True, None), False),
                           ((1, 2, 1, 384, 128, 64, False, 32), False)):
        check_flash_bwd(dev, report, shape, time_it)
    check_function_grads(dev)

    # ssd_fwd (B, H, G, S, N, P, chunk): two groups and four chunks; ragged
    # t-blocks (chunk 100); the SMOKE widths (N 16, P 24, chunk 8) padded
    for shape, time_it in (((2, 8, 2, 1024, 128, 64, 256), True),
                           ((1, 4, 1, 300, 64, 64, 100), False),
                           ((1, 6, 3, 96, 16, 24, 8), False)):
        check_ssd(dev, report, shape, time_it)
    # moe_ffn_fwd (E, R, Dm, Dff): caps 8, 40 and 320; widths no tile divides,
    # with rows for each tiling; 48 experts at rows on each side of the decode
    # tiles' limit, and 64 and 65 rows at it
    from repro_torch.kernels.moe_gemm import kernel as MK

    for shape, time_it in (((8, 320, 1024, 2048), True), ((8, 40, 1024, 2048), False),
                           ((8, 8, 1024, 2048), False), ((3, 130, 200, 264), False),
                           ((3, 5, 200, 264), False),
                           ((48, 8, 1024, 256), False), ((48, 72, 1024, 256), False),
                           ((8, MK.DECODE_MAX_ROWS, 512, 1024), False),
                           ((8, MK.DECODE_MAX_ROWS + 1, 512, 1024), False)):
        check_moe(dev, report, shape, time_it)


def outcomes_args(jobs, orders, outcomes, weights, dev):
    from repro_torch.core import policies
    from repro_torch.kernels.sojourn_eval import ops

    sizes, _, num_stages = policies.padded_arrays(jobs)
    tables = ops.outcome_tables(outcomes, weights, num_stages, dev)
    return ops.outcomes_kernel_args(sizes, num_stages, orders, tables, dev)


def flash_inputs(dev, b, hq, hkv, sq, skv, d, seed=0):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
            for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def check_flash(dev, report, shape, time_it=False, qkv=None, reps=10, twice=False,
                phase1=True) -> dict:
    """``flash_fwd`` against its plain version on bf16 inputs of ``shape``
    (B, Hq, Hkv, Sq, Skv, D, causal, window), with ``twice`` a second call
    bitwise equal to the first; returns the timings asked for, which
    become the kernel's phase-1 time if it has none and ``phase1``."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as FK

    b, hq, hkv, sq, skv, d, causal, window = shape
    q, k, v = qkv or flash_inputs(dev, b, hq, hkv, sq, skv, d)
    kw = dict(scale=d**-0.5, causal=causal, window=window)
    out = {}
    if time_it:
        cuda_ms(lambda: FK.flash_fwd(q, k, v, **kw), 2)  # warm up
        out["ms"], (o, lse) = cuda_ms(lambda: FK.flash_fwd(q, k, v, **kw), reps)
        out["plain_ms"], (o_p, lse_p) = cuda_ms(lambda: FK.flash_fwd_torch(q, k, v, **kw), 1)
    else:
        o, lse = FK.flash_fwd(q, k, v, **kw)
        o_p, lse_p = FK.flash_fwd_torch(q, k, v, **kw)
    if twice:
        o2, lse2 = FK.flash_fwd(q, k, v, **kw)
        require(bool(torch.equal(o, o2)) and bool(torch.equal(lse, lse2)),
                f"flash_fwd {shape}: a second call differs from the first")
        del o2, lse2
    torch.cuda.synchronize()
    require(bool(torch.isfinite(o.float()).all()) and bool(torch.isfinite(lse).all()),
            f"flash_fwd {shape}: non-finite output")
    err_o = float((o.float() - o_p.float()).abs().max())
    err_lse = float((lse - lse_p).abs().max())
    r = report.setdefault("flash_fwd", {"max_abs_err": 0.0, "max_lse_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err_o)
    r["max_lse_err"] = max(r["max_lse_err"], err_lse)
    log(f"[kernel vs plain] flash_fwd (B, Hq, Hkv, Sq, Skv, D, causal, window)={shape}: "
        f"O max abs err {err_o:.3e}, LSE {err_lse:.3e}")
    require(err_o <= FLASH_O_ATOL, f"flash_fwd {shape}: O err {err_o:.3e} > {FLASH_O_ATOL}")
    require(err_lse <= FLASH_LSE_ATOL,
            f"flash_fwd {shape}: LSE err {err_lse:.3e} > {FLASH_LSE_ATOL}")
    if time_it and phase1 and "phase1_ms" not in r:
        r.update(phase1_shape=str(shape), phase1_ms=out["ms"], phase1_plain_ms=out["plain_ms"])
        log(f"  kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms")
    return out


def check_flash_bwd(dev, report, shape, time_it=False, reps=10, qkv=None, phase1=True) -> dict:
    """``flash_dkv`` and ``flash_dq`` against their plain versions on bf16
    inputs of ``shape`` (B, Hq, Hkv, S, D, causal, window), Sq = Skv, or
    (B, Hq, Hkv, Sq, Skv, D, causal, window), with the LSE of the
    ``flash_fwd`` kernel; a second call of each on the same inputs must
    give bitwise-equal outputs (each output element is summed by one thread
    in a fixed order).  Returns the timings asked for."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as FK

    if len(shape) == 7:
        b, hq, hkv, sq, d, causal, window = shape
        skv = sq
    else:
        b, hq, hkv, sq, skv, d, causal, window = shape
    q, k, v = qkv or flash_inputs(dev, b, hq, hkv, sq, skv, d)
    gen = torch.Generator(device=dev).manual_seed(1)
    do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(scale=d**-0.5, causal=causal, window=window)
    o, lse = FK.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(dim=-1)
    args = (q, k, v, do, lse, delta)
    out = {}
    if time_it:
        for fn in (FK.flash_dkv, FK.flash_dq):
            cuda_ms(lambda: fn(*args, **kw), 2)  # warm up
        out["dkv_ms"], (dk, dv) = cuda_ms(lambda: FK.flash_dkv(*args, **kw), reps)
        out["dq_ms"], dq = cuda_ms(lambda: FK.flash_dq(*args, **kw), reps)
        out["dkv_plain_ms"], (dk_p, dv_p) = cuda_ms(lambda: FK.flash_dkv_torch(*args, **kw), 1)
        out["dq_plain_ms"], dq_p = cuda_ms(lambda: FK.flash_dq_torch(*args, **kw), 1)
    else:
        dk, dv = FK.flash_dkv(*args, **kw)
        dq = FK.flash_dq(*args, **kw)
        dk_p, dv_p = FK.flash_dkv_torch(*args, **kw)
        dq_p = FK.flash_dq_torch(*args, **kw)
    again = (*FK.flash_dkv(*args, **kw), FK.flash_dq(*args, **kw))
    torch.cuda.synchronize()
    for name, pairs in (("flash_dkv", (("dK", dk, dk_p), ("dV", dv, dv_p))),
                        ("flash_dq", (("dQ", dq, dq_p),))):
        r = report.setdefault(name, {"max_abs_err": 0.0, "max_rel_l2": 0.0})
        for label, got, want in pairs:
            require(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
                    f"{name} {shape}: {label} not finite float32")
            err = rel_l2(got, want)
            r["max_abs_err"] = max(r["max_abs_err"], float((got - want).abs().max()))
            r["max_rel_l2"] = max(r["max_rel_l2"], err)
            log(f"[kernel vs plain] {name} (B, Hq, Hkv, S, D, causal, window)={shape}: "
                f"{label} rel L2 {err:.3e}")
            require(err <= FLASH_BWD_REL_L2,
                    f"{name} {shape}: {label} rel L2 {err:.3e} > {FLASH_BWD_REL_L2}")
        key = "dkv" if name == "flash_dkv" else "dq"
        if time_it and phase1 and "phase1_ms" not in r:
            r.update(phase1_shape=str(shape), phase1_ms=out[f"{key}_ms"],
                     phase1_plain_ms=out[f"{key}_plain_ms"])
            log(f"  {name}: kernel {r['phase1_ms']:.3f} ms, plain {r['phase1_plain_ms']:.3f} ms")
    same = [bool(torch.equal(a, b)) for a, b in zip(again, (dk, dv, dq))]
    log(f"[kernel repeat] flash_dkv, flash_dq {shape}: a second call bitwise equal for dK, dV, "
        f"dQ: {same}")
    require(all(same), f"flash_dkv / flash_dq {shape}: a second call differs ({same})")
    return out


def check_function_grads(dev) -> None:
    """The MoE and SSD autograd Functions (kernel forward, reference
    backward) against autograd through their kernels' plain versions, on
    the same bf16 inputs and cotangent weights, at mid sizes."""
    import torch

    from repro_torch.kernels.moe_gemm import kernel as MK
    from repro_torch.kernels.moe_gemm import moe_ffn
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ssd_scan

    def ssd_plain(x, dt, A, Bm, Cm, D, chunk):
        """ops.ssd_scan's composition around the kernel's plain version."""
        xk, dtk = x.transpose(1, 2).contiguous(), dt.transpose(1, 2).contiguous()
        y, state = SK.ssd_fwd_torch(xk, dtk, dtk * A[None, :, None],
                                    Bm.transpose(1, 2).contiguous(),
                                    Cm.transpose(1, 2).contiguous(), chunk=chunk)
        return (y.transpose(1, 2) + (D[None, None, :, None] * x).to(y.dtype)).to(x.dtype), state

    def grads(fn, inputs, weights):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o.float() * w).sum() for o, w in zip(outs, weights))
        return torch.autograd.grad(loss, leaves)

    gen = torch.Generator(device=dev).manual_seed(3)
    for shape in ((8, 320, 1024, 2048), (3, 130, 200, 264)):
        e, r, _, _ = shape
        args = moe_inputs(dev, *shape, seed=4)
        w = [torch.randn((e, r, shape[2]), generator=gen, device=dev)]
        got, want = grads(moe_ffn, args, w), grads(MK.moe_ffn_fwd_torch, args, w)
        errs = [rel_l2(a, b) for a, b in zip(got, want)]
        log(f"[Function grads] moe_ffn (E, R, Dm, Dff)={shape}: rel L2 of dx, dwg, dwu, dwd "
            f"{', '.join(f'{x:.3e}' for x in errs)}")
        require(all(torch.isfinite(g.float()).all() for g in got) and
                max(errs) <= MOE_GRAD_REL_L2, f"moe_ffn grads {shape}: {errs}")
    for b, h, g, s, n, p, chunk in ((2, 8, 2, 1024, 128, 64, 256), (1, 4, 1, 300, 64, 64, 100)):
        x = torch.randn((b, s, h, p), generator=gen, device=dev).to(torch.bfloat16)
        dt = 0.01 + 0.19 * torch.rand((b, s, h), generator=gen, device=dev)
        A = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device=dev))
        Bm, Cm = (torch.randn((b, s, g, n), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        D = torch.randn((h,), generator=gen, device=dev)
        w = [torch.randn((b, s, h, p), generator=gen, device=dev),
             torch.randn((b, h, n, p), generator=gen, device=dev)]
        args = (x, dt, A, Bm, Cm, D)
        got = grads(lambda *a: ssd_scan(*a, chunk=chunk), args, w)
        want = grads(lambda *a: ssd_plain(*a, chunk), args, w)
        errs = [rel_l2(a, b) for a, b in zip(got, want)]
        log(f"[Function grads] ssd_scan (B, H, G, S, N, P, chunk)={(b, h, g, s, n, p, chunk)}: "
            f"rel L2 of dx, ddt, dA, dB, dC, dD {', '.join(f'{x:.3e}' for x in errs)}")
        require(all(torch.isfinite(t.float()).all() for t in got) and
                max(errs) <= SSD_GRAD_REL_L2, f"ssd_scan grads: {errs}")


def rel_l2(got, want) -> float:
    """Relative L2 error of ``got`` against ``want`` (tensors, in float64)."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-300))


def ssd_inputs(dev, b, h, g, s, n, p, seed=0):
    """Kernel-layout SSD inputs as the model makes them: x, B, C in bf16;
    dt in (0.01, 0.2) and dA = dt * A with A in (-2, -0.5), float32."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, h, s, p), generator=gen, device=dev).to(torch.bfloat16)
    dt = 0.01 + 0.19 * torch.rand((b, h, s), generator=gen, device=dev)
    a = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device=dev))
    bm, cm = (torch.randn((b, g, s, n), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    return x, dt, dt * a[None, :, None], bm, cm


def check_ssd(dev, report, shape, time_it=False, reps=10, phase1=True) -> dict:
    """``ssd_fwd`` against its plain version on inputs of ``shape`` (B, H,
    G, S, N, P, chunk), and a second call bitwise equal to the first (no
    sum is split across CTAs); returns the timings asked for, which
    become the kernel's phase-1 time if it has none and ``phase1``."""
    import torch

    from repro_torch.kernels.ssd_scan import kernel as SK

    b, h, g, s, n, p, chunk = shape
    args = ssd_inputs(dev, b, h, g, s, n, p)
    out = {}
    if time_it:
        cuda_ms(lambda: SK.ssd_fwd(*args, chunk=chunk), 2)  # warm up
        out["ms"], (y, st) = cuda_ms(lambda: SK.ssd_fwd(*args, chunk=chunk), reps)
        out["plain_ms"], (y_p, st_p) = cuda_ms(lambda: SK.ssd_fwd_torch(*args, chunk=chunk), 1)
    else:
        y, st = SK.ssd_fwd(*args, chunk=chunk)
        y_p, st_p = SK.ssd_fwd_torch(*args, chunk=chunk)
    y2, st2 = SK.ssd_fwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    require(bool(torch.equal(y, y2)) and bool(torch.equal(st, st2)),
            f"ssd_fwd {shape}: a second call differs from the first")
    require(bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(st).all()),
            f"ssd_fwd {shape}: non-finite output")
    err_y, err_st = rel_l2(y, y_p), rel_l2(st, st_p)
    r = report.setdefault("ssd_fwd", {"max_abs_err": 0.0, "max_rel_l2": 0.0,
                                      "max_state_rel_l2": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], float((y.float() - y_p.float()).abs().max()))
    r["max_rel_l2"] = max(r["max_rel_l2"], err_y)
    r["max_state_rel_l2"] = max(r["max_state_rel_l2"], err_st)
    log(f"[kernel vs plain] ssd_fwd (B, H, G, S, N, P, chunk)={shape}: y rel L2 {err_y:.3e}, "
        f"state rel L2 {err_st:.3e}")
    require(err_y <= SK.SSD_REL_L2, f"ssd_fwd {shape}: y rel L2 {err_y:.3e} > {SK.SSD_REL_L2}")
    require(err_st <= SK.SSD_STATE_REL,
            f"ssd_fwd {shape}: state rel L2 {err_st:.3e} > {SK.SSD_STATE_REL}")
    if time_it and phase1 and "phase1_ms" not in r:
        r.update(phase1_shape=str(shape), phase1_ms=out["ms"], phase1_plain_ms=out["plain_ms"])
        log(f"  kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms")
    return out


def moe_inputs(dev, e, r, dm, dff, seed=0):
    """Expert rows x (E, R, Dm) of unit scale and fan-in-scaled expert
    weights, bf16, drawn 16 experts at a time (Kimi-K2's 384 experts of
    float32 draws would take 68 GB at once)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, std):
        out = torch.empty(shape, dtype=torch.bfloat16, device=dev)
        for i in range(0, shape[0], 16):
            part = out[i:i + 16]
            part.copy_(torch.randn(part.shape, generator=gen, device=dev).mul_(std))
        return out

    return (draw((e, r, dm), 1.0), draw((e, dm, dff), dm**-0.5), draw((e, dm, dff), dm**-0.5),
            draw((e, dff, dm), dff**-0.5))


def moe_plain(x, wg, wu, wd):
    """``moe_ffn_fwd_torch`` over chunks of experts whose float32 weight
    copies stay within MOE_PLAIN_BYTES (Kimi-K2's 384 experts would need
    68 GB at once); each expert's rows are computed as in one call."""
    import torch

    from repro_torch.kernels.moe_gemm import kernel as MK

    e, _, dm = x.shape
    step = max(1, min(e, MOE_PLAIN_BYTES // (3 * dm * wg.shape[-1] * 4)))
    return torch.cat([MK.moe_ffn_fwd_torch(x[i:i + step], wg[i:i + step], wu[i:i + step],
                                           wd[i:i + step]) for i in range(0, e, step)])


def check_moe(dev, report, shape, time_it=False, reps=3, args=None, phase1=True) -> dict:
    """``moe_ffn_fwd`` against its plain version on inputs of ``shape`` (E,
    R, Dm, Dff), and a second call bitwise equal to the first; returns the
    timings asked for, which become the kernel's phase-1 time if it has
    none and ``phase1``."""
    import torch

    from repro_torch.kernels.moe_gemm import kernel as MK

    args = args or moe_inputs(dev, *shape)
    out = {}
    if time_it:
        cuda_ms(lambda: MK.moe_ffn_fwd(*args), 1)  # warm up
        out["ms"], o = cuda_ms(lambda: MK.moe_ffn_fwd(*args), reps)
        out["plain_ms"], o_p = cuda_ms(lambda: moe_plain(*args), 1)
    else:
        o, o_p = MK.moe_ffn_fwd(*args), moe_plain(*args)
    again = MK.moe_ffn_fwd(*args)
    torch.cuda.synchronize()
    require(bool(torch.equal(o, again)), f"moe_ffn_fwd {shape}: a second call differs")
    del again
    require(bool(torch.isfinite(o.float()).all()), f"moe_ffn_fwd {shape}: non-finite output")
    err = rel_l2(o, o_p)
    r = report.setdefault("moe_ffn_fwd", {"max_abs_err": 0.0, "max_rel_l2": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], float((o.float() - o_p.float()).abs().max()))
    r["max_rel_l2"] = max(r["max_rel_l2"], err)
    log(f"[kernel vs plain] moe_ffn_fwd (E, R, Dm, Dff)={shape}: rel L2 {err:.3e}, max abs "
        f"{float((o.float() - o_p.float()).abs().max()):.3e}")
    require(err <= MOE_REL_L2, f"moe_ffn_fwd {shape}: rel L2 {err:.3e} > {MOE_REL_L2}")
    if time_it and phase1 and "phase1_ms" not in r:
        r.update(phase1_shape=str(shape), phase1_ms=out["ms"], phase1_plain_ms=out["plain_ms"])
        log(f"  kernel {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms")
    return out


def regime_row(shape, t: dict, bound: tuple[float, str], library_ms=None) -> dict:
    """One timed shape of a new regime: the kernel's and the plain version's
    medians (``t``), the bound (ms, by) and the library yardstick."""
    return dict(shape=str(shape), ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bound[0],
                bound_by=bound[1], library_ms=library_ms)


def phase_new_regimes(dev, report) -> None:
    """Phase 1, first: the kernel regimes the hybrid, vlm and encdec
    families bring, each against its plain version with a second call
    bitwise equal: ``flash_fwd`` with one query row and with Sq != Skv
    (the vision model's cross attention over its 1,664 image tokens, D =
    128, in decode and prefill), bidirectional at Sq = Skv = 2,048, D = 64
    (the Seamless encoder) and one query row there (its decode cross
    attention), a ragged few-row case; the backward at that few-row case;
    ``ssd_fwd`` at Jamba's prefill (N = 16, P = 64, 128 heads, one group,
    chunk 256) and a prompt shorter than one chunk; ``moe_ffn_fwd`` at
    Jamba's prefill and decode shapes.  The prefill-sized shapes are timed
    beside their bound (and SDPA for the attention), into each kernel's
    ``regimes``."""
    import torch
    import torch.nn.functional as F

    rows = []
    for shape, time_it in (((SERVE_BATCH, 32, 8, 1, VISION_IMAGE_TOKENS, 128, False, None), False),
                           ((SERVE_BATCH, 32, 8, SERVE_PROMPT, VISION_IMAGE_TOKENS, 128, False,
                             None), True),
                           ((SERVE_BATCH, 16, 16, SERVE_PROMPT, SERVE_PROMPT, 64, False, None),
                            True),
                           ((SERVE_BATCH, 16, 16, 1, SERVE_PROMPT, 64, False, None), False),
                           ((1, 8, 2, 5, 300, 128, False, None), False)):
        b, hq, hkv, sq, skv, d, causal, _ = shape
        q, k, v = flash_inputs(dev, b, hq, hkv, sq, skv, d, seed=3)
        t = check_flash(dev, report, shape, time_it, qkv=(q, k, v), twice=True, phase1=False)
        if time_it:
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=False,  # noqa: E731
                                                          enable_gqa=True)
            cuda_ms(sdpa, 2)  # warm up
            library_ms, _ = cuda_ms(sdpa, 10)
            io_bytes = tensor_bytes((q, k, v)) + q.numel() * q.element_size() + b * hq * sq * 4
            row = regime_row(shape, t, bound_ms(flash_flops(b, hq, sq, skv, d, causal),
                                                io_bytes, 0, peak=BF16_FLOPS), library_ms)
            rows.append(row)
            log(f"[regime] flash_fwd {shape}: {t['ms']:.3f} ms, median of 10, plain "
                f"{t['plain_ms']:.1f} ms, SDPA {library_ms:.3f} ms; bound {row['bound_ms']:.4f} "
                f"ms ({row['bound_by']}): {row['bound_ms'] / t['ms']:.2%} of it")
        del q, k, v
    report["flash_fwd"]["regimes"] = rows
    check_flash_bwd(dev, report, (1, 8, 2, 5, 300, 128, False, None))

    rows = []
    for shape, time_it in ((JAMBA_SSD_SHAPE, True), ((*JAMBA_SSD_SHAPE[:3], 255,
                                                       *JAMBA_SSD_SHAPE[4:]), False)):
        t = check_ssd(dev, report, shape, time_it, phase1=False)
        if time_it:
            row = regime_row(shape, t, ssd_bound(ssd_work(*shape)))
            rows.append(row)
            log(f"[regime] ssd_fwd {shape}: {t['ms']:.3f} ms, median of 10, plain "
                f"{t['plain_ms']:.1f} ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}): "
                f"{row['bound_ms'] / t['ms']:.2%} of it")
    report["ssd_fwd"]["regimes"] = rows

    rows = []
    prefill, decode = moe_serving_shapes(JAMBA)
    args = moe_inputs(dev, *prefill, seed=5)
    for shape in (prefill, decode):
        e, r, dm, dff = shape
        if shape == decode:
            args = (args[0][:, :r].contiguous(), *args[1:])
        t = check_moe(dev, report, shape, time_it=shape == prefill, args=args, phase1=False)
        if shape == prefill:
            from repro_torch.kernels.moe_gemm.ref import moe_ffn_ref

            cuda_ms(lambda: moe_ffn_ref(*args), 1)  # warm up
            library_ms, _ = cuda_ms(lambda: moe_ffn_ref(*args), 3)
            row = regime_row(shape, t, bound_ms(6.0 * e * r * dm * dff, tensor_bytes(args),
                                                e * r * dm * 2, peak=BF16_FLOPS), library_ms)
            rows.append(row)
            log(f"[regime] moe_ffn_fwd {shape}: {t['ms']:.3f} ms, median of 3, plain "
                f"{t['plain_ms']:.1f} ms, three torch.bmm (moe_ffn_ref) {library_ms:.3f} ms; "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}): "
                f"{row['bound_ms'] / t['ms']:.2%} of it")
    report["moe_ffn_fwd"]["regimes"] = rows
    del args
    torch.cuda.empty_cache()


def phase_small_head_dims(dev, report) -> None:
    """Phase 1, second: ``flash_fwd``, ``flash_dkv`` and ``flash_dq`` at head
    dims 16 and 32 (every SMOKE config's; one zero-filled 64-column panel),
    each against its plain version, causal and not, under GQA with a ragged
    S, a second call bitwise equal; then timed beside their bounds and
    SDPA's time, the forward at the serving shape and the backward at the
    training shape with the head dim cut, into each kernel's
    ``head_dims``."""
    import torch
    import torch.nn.functional as F

    for d in SMALL_HEAD_DIMS:
        for causal in (True, False):
            check_flash(dev, report, (2, 8, 2, 300, 300, d, causal, None), twice=True)
            check_flash_bwd(dev, report, (2, 8, 2, 300, d, causal, None))
        shape = (SERVE_BATCH, 32, 8, SERVE_PROMPT, SERVE_PROMPT, d, True, None)
        q, k, v = flash_inputs(dev, *shape[:6], seed=4)
        t = check_flash(dev, report, shape, True, qkv=(q, k, v), twice=True, phase1=False)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,  # noqa: E731
                                                      enable_gqa=True)
        cuda_ms(sdpa, 2)  # warm up
        library_ms, _ = cuda_ms(sdpa, 10)
        b, hq, _, sq, skv = shape[:5]
        io_bytes = tensor_bytes((q, k, v)) + q.numel() * q.element_size() + b * hq * sq * 4
        row = regime_row(shape, t, bound_ms(flash_flops(b, hq, sq, skv, d, True), io_bytes, 0,
                                            peak=BF16_FLOPS), library_ms)
        report["flash_fwd"].setdefault("head_dims", []).append(row)
        log(f"[head dim {d}] flash_fwd {shape}: {t['ms']:.3f} ms, median of 10, plain "
            f"{t['plain_ms']:.1f} ms, SDPA {library_ms:.3f} ms; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}): {row['bound_ms'] / t['ms']:.2%} of it")
        del q, k, v
        bwd = time_flash_bwd(dev, report, (2, 16, 8, TRAIN_SEQ, d, True, None), phase1=False)
        for name, row in bwd.items():
            report[name].setdefault("head_dims", []).append(row)
    torch.cuda.empty_cache()


def phase_worked_example() -> None:
    """Phase 2: paper Section III-A through the default-device entry points."""
    import numpy as np

    from repro_torch.core import evaluator
    from repro_torch.core.jobs import JobSpec

    jobs = [
        JobSpec(sizes=np.array([1.0, 10.0]), probs=np.array([0.25, 0.75]), job_id=0),
        JobSpec(sizes=np.array([3.0, 6.0]), probs=np.array([0.6, 0.4]), job_id=1),
    ]
    sr = evaluator.evaluate(jobs, "sr")
    serpt = evaluator.evaluate(jobs, "serpt")
    order, opt = evaluator.optimal_order(jobs)
    rank = evaluator.evaluate(jobs, "rank")
    log(f"[worked example] SR={sr!r} SERPT={serpt!r} OPTIMAL={opt!r} order={order.tolist()} "
        f"RANK={rank!r}")
    for name, got, want in (("SR", sr, 10.0), ("SERPT", serpt, 9.75),
                            ("OPTIMAL", opt, 9.1), ("RANK", rank, 9.1)):
        require(rel_err(got, want) <= RTOL, f"worked example {name}={got!r}, paper {want}")
    require(order.tolist() == [0, 1], f"worked example OPTIMAL order {order.tolist()}")


def phase_main_path() -> dict:
    """Phase 3: the full-size main path, with the launch counts around it."""
    import numpy as np

    from repro_torch.core import evaluator
    from repro_torch.core.jobs import generate_workload

    cells = [
        ("N=26 M=2 exact (K=2^26)", 31, 26, 2, ("rank", "serpt", "sr", "random"), 4096),
        ("N=8 M=3 exact with OPTIMAL (8! orders x 3^8)", 8, 8, 3,
         ("optimal", "rank", "serpt", "sr"), 4096),
        ("N=27 M=2 streamed MC (K=2^27, S=2^23)", 27, 27, 2,
         ("rank", "serpt", "sr", "random"), 1 << 23),
    ]
    workloads = {}
    reset_counts()
    results, walls = [], []
    for label, seed, n, m, algs, mc_samples in cells:
        rng = np.random.default_rng(seed)
        jobs = generate_workload(rng, n, m)
        workloads[n] = jobs
        t0 = time.perf_counter()
        res = evaluator.evaluate_many(jobs, algs, rng, mc_samples=mc_samples)
        secs = time.perf_counter() - t0
        results.append((label, res))
        walls.append(secs)
        log(f"[main path] {label}: {res} in {secs:.3f} s (host clock, results on host)")
    counts = read_counts()
    log(f"[main path] launches: {counts}")
    for label, res in results:
        for alg, v in res.items():
            require(math.isfinite(v) and v > 0, f"{label}: {alg}={v!r}")
    opt = results[1][1]
    require(opt["optimal"] <= opt["rank"] * (1 + RTOL),
            f"OPTIMAL {opt['optimal']!r} above RANK {opt['rank']!r}")
    for name in ("sojourn_enum", "sojourn_mc", "dynamic_sojourn_enum", "dynamic_sojourn_mc"):
        require(counts[name] > 0, f"kernel {name} was not launched on the main path")
    # the N=8 OPTIMAL cell once more under torch.profiler: its sojourn_enum
    # kernel time summed over its launches, beside the host wall above
    _, seed, n, _, algs, mc_samples = cells[1]
    enum_ms, enum_calls, device_ms = profiled_kernel_ms(
        lambda: evaluator.evaluate_many(workloads[n], algs, np.random.default_rng(seed),
                                        mc_samples=mc_samples), "enum_kernel")
    optimal_cell = {"host_s": walls[1], "enum_kernel_ms": enum_ms, "enum_launches": enum_calls,
                    "device_ms": device_ms}
    log(f"[main path] N=8 OPTIMAL cell, profiled once more: sojourn_enum kernel "
        f"{enum_ms if enum_ms is None else f'{enum_ms:.3f}'} ms over {enum_calls} launches, all "
        f"device time {device_ms if device_ms is None else f'{device_ms:.3f}'} ms, against a "
        f"host wall of {walls[1]:.3f} s unprofiled")
    return {"launches": counts, "workloads": workloads, "optimal_cell": optimal_cell}


def phase_large_group() -> dict:
    """Phase 3b: ``evaluate_many`` over LARGE_GROUP two-stage jobs, K =
    2**80 (an int64 count wraps at 63 such jobs): every policy must take the
    streamed tier (SR and SERPT the dynamic kernel's register path, three
    mask words)."""
    import numpy as np

    from repro_torch.core import evaluator
    from repro_torch.core.jobs import generate_workload

    rng = np.random.default_rng(LARGE_GROUP)
    jobs = generate_workload(rng, LARGE_GROUP)
    require(evaluator.exact_combination_count(jobs) == 2**LARGE_GROUP,
            f"the outcome count of {LARGE_GROUP} two-stage jobs is not 2**{LARGE_GROUP}")
    reset_counts()
    t0 = time.perf_counter()
    res = evaluator.evaluate_many(jobs, ("rank", "serpt", "sr", "random"), rng,
                                  mc_samples=LARGE_GROUP_SAMPLES)
    secs = time.perf_counter() - t0
    counts = read_counts()
    log(f"[main path] N={LARGE_GROUP} M=2 streamed MC (K=2^{LARGE_GROUP}, "
        f"S={LARGE_GROUP_SAMPLES}): {res} in {secs:.3f} s (host clock, results on host)")
    log(f"[main path] N={LARGE_GROUP} launches: {counts}")
    for alg, v in res.items():
        require(math.isfinite(v) and v > 0, f"N={LARGE_GROUP}: {alg}={v!r}")
    require(counts["sojourn_enum"] == 0 and counts["dynamic_sojourn_enum"] == 0,
            f"an exact kernel ran at K=2^{LARGE_GROUP}")
    require(counts["sojourn_mc"] == 2 and counts["dynamic_sojourn_mc"] == 2,
            f"the streamed kernels did not take the N={LARGE_GROUP} group: {counts}")
    return {"launches": counts, "jobs": jobs}


def phase_cross_check(jobs) -> None:
    """Phase 3b: a constant index table (rank values broadcast along M) on
    one server is the static RANK order, at N=26 through both kernels."""
    import numpy as np

    from repro_torch.core import policies
    from repro_torch.kernels.sojourn_eval import sojourn_eval, sojourn_eval_dynamic

    sizes, probs, num_stages = policies.padded_arrays(jobs)
    table = np.broadcast_to(policies.rank_values(jobs)[:, None], probs.shape)
    dyn = sojourn_eval_dynamic(probs, policies.stage_durations(jobs), num_stages, table)
    stat = sojourn_eval(sizes, probs, num_stages, policies.rank_order(jobs)[None])
    rel = max(rel_err(dyn[0], stat[0]), rel_err(dyn[1], stat[1]))
    log(f"[cross-check] N=26 constant-index dynamic {dyn[0][0]!r} vs static RANK "
        f"{stat[0][0]!r}: max rel err {rel:.3e}")
    require(rel <= RTOL, f"constant-index dynamic != static RANK: rel {rel:.3e}")


def phase_outcomes_path() -> dict:
    """Phase 4: the explicit-outcome path at K = 2**21, launch counts
    around it (at most one ``sojourn_outcomes`` launch a static call); the
    host wall split into the table's build, its upload (with the range
    check on the card) and the rest of each call, and the profiled kernel
    time of the N=27 call; then each table value against the table-free
    one."""
    import numpy as np
    import torch

    from repro_torch.core import evaluator, policies
    from repro_torch.core.jobs import generate_workload
    from repro_torch.kernels.sojourn_eval import kernel as K
    from repro_torch.kernels.sojourn_eval import ops

    rng = np.random.default_rng(21)
    j21 = generate_workload(rng, 21)
    j27 = generate_workload(rng, 27)
    rank21 = policies.rank_order(j21)
    walls, per_call = {}, []

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[key] = time.perf_counter() - t0
        return out

    def static_call(key, *args):
        before = K.launches["sojourn_outcomes"]
        out = timed(key, lambda: evaluator.expected_sojourn_static(*args))
        per_call.append(K.launches["sojourn_outcomes"] - before)
        return out

    reset_counts()
    table21 = timed("build21", lambda: evaluator.enumerate_outcomes(j21))
    rank_tab = static_call("static21", j21, rank21, *table21)
    sr_tab = timed("dynamic21", lambda: evaluator.expected_sojourn_dynamic(j21, "sr", *table21))
    table27 = timed("build27", lambda: evaluator.sample_outcomes(j27, 1 << 21, rng))
    orders = np.stack([policies.rank_order(j27)]
                      + [policies.random_order(j27, rng) for _ in range(16)])
    mc27 = static_call("static27", j27, orders, *table27)
    counts = read_counts()
    secs = sum(walls.values())
    log(f"[outcomes path] N=21 K=2^21 enumerated: RANK={rank_tab!r} SR={sr_tab!r}; N=27 "
        f"S=2^21 sampled: RANK={mc27[0]!r}, 16 RANDOM in [{mc27[1:].min()!r}, "
        f"{mc27[1:].max()!r}]; {secs:.3f} s (host clock, tables built on the host)")
    log(f"[outcomes path] launches: {counts}; sojourn_outcomes a static call: {per_call}")
    require(counts["sojourn_outcomes"] > 0, "sojourn_outcomes was not launched on its path")
    require(all(c <= 1 for c in per_call),
            f"a static call launched sojourn_outcomes more than once: {per_call}")
    require(bool(np.all(np.isfinite(mc27))) and bool(np.all(mc27 > 0)), f"MC values {mc27}")
    # the wall's parts: each table's upload and range check alone, then the
    # N=27 call's kernel under torch.profiler
    dev = torch.device("cuda")
    for key, jobs, table in (("upload21", j21, table21), ("upload27", j27, table27)):
        stages = policies.padded_arrays(jobs)[2]
        timed(key, lambda: (ops.outcome_tables(*table, stages, dev), torch.cuda.synchronize()))
    kernel_ms, kernel_calls, device_ms = profiled_kernel_ms(
        lambda: evaluator.expected_sojourn_static(j27, orders, *table27), "outcomes_kernel")
    log("[outcomes path] host wall (s): " + ", ".join(f"{k} {v:.4f}" for k, v in walls.items())
        + f"; the N=27 call profiled once more: outcomes_kernel {kernel_ms} ms over "
        f"{kernel_calls} launch(es), all device time {device_ms} ms")
    rank_exact = evaluator.expected_sojourn_static(j21, rank21)
    sr_exact = evaluator.expected_sojourn_dynamic(j21, "sr")
    rel = max(rel_err(rank_tab, rank_exact), rel_err(sr_tab, sr_exact))
    log(f"[outcomes path] table vs exact at N=21: RANK {rank_exact!r}, SR {sr_exact!r}: "
        f"max rel err {rel:.3e}")
    require(rel <= RTOL, f"table values differ from the exact ones: rel {rel:.3e}")
    return {"launches": counts, "jobs": j21, "table": table21, "j27": j27, "table27": table27,
            "orders27": orders, "walls": walls, "kernel_ms": kernel_ms}


def ragged_group(rng, n_jobs: int, max_stages: int) -> list:
    """``n_jobs`` jobs of 1 to ``max_stages`` stages from ``rng``, each with
    a positive success probability."""
    import numpy as np

    from repro_torch.core.jobs import JobSpec

    jobs = []
    for i in range(n_jobs):
        m = int(rng.integers(1, max_stages + 1))
        w = np.append(rng.uniform(0.0, 1.0, m - 1), rng.uniform(0.05, 1.0))
        jobs.append(JobSpec(sizes=np.cumsum(rng.uniform(0.01, 4.0, m)), probs=w / w.sum(),
                            job_id=i))
    return jobs


def untied(jobs, policy: str) -> bool:
    """Every stage's index finite and no two equal: the DES breaks index
    ties by insertion order where the lockstep kernels break them by job
    position, and serves a +inf index last where they never seat it (R2)."""
    import numpy as np

    from repro_torch.core import policies

    table = policies.index_table(jobs, policy)
    num_stages = policies.padded_arrays(jobs)[2]
    live = table[np.arange(table.shape[1])[None, :] < num_stages[:, None]]
    return bool(np.all(np.isfinite(live))) and len(np.unique(live)) == len(live)


def table_study(study) -> None:
    """Tables IV-VIII through ``repro_torch.launch.study`` at its CI-scale
    trials for one (set, N), TABLE_STUDY: ``_numerical_study`` with
    ``device=None`` (the card) and ``device="cpu"`` from the same seed, both
    written by ``table_sojourn`` to a temporary directory; every row within
    RTOL, its ``rank_vs_optimal_pct`` to the absolute error that two values
    within RTOL allow."""
    import tempfile

    sets, n_jobs = TABLE_STUDY
    before = read_counts()
    t0 = time.perf_counter()
    card = study._numerical_study(False, sets=sets, n_jobs=n_jobs)
    secs = time.perf_counter() - t0
    launched = read_counts()["sojourn_enum"] - before["sojourn_enum"]
    require(launched > 0, "the study's device=None path launched no sojourn_enum")
    plain = study._numerical_study(False, sets=sets, n_jobs=n_jobs, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        rows = study.table_sojourn(study=card, out=os.path.join(tmp, "card"))
        want = study.table_sojourn(study=plain, out=os.path.join(tmp, "cpu"))
        with open(os.path.join(tmp, "card", "table_sojourn.json")) as f:
            saved = json.load(f)
    require(saved["rows"] == rows and "workload_cache" in saved,
            f"table_sojourn's saved layout: {sorted(saved)}")
    worst = 0.0
    for got, ref in zip(rows, want, strict=True):
        require(got.keys() == ref.keys(), f"table_sojourn keys: {got.keys()} != {ref.keys()}")
        for key, value in got.items():
            if key == "rank_vs_optimal_pct":
                allow = 100 * 2 * RTOL * ref["rank"] / ref["optimal"]
                require(abs(value - ref[key]) <= allow, f"table_sojourn {key}: {value!r} "
                        f"!= {ref[key]!r}")
            elif isinstance(value, float):
                worst = max(worst, rel_err(value, ref[key]))
                require(rel_err(value, ref[key]) <= RTOL, f"table_sojourn {key}: card "
                        f"{value!r}, plain {ref[key]!r}")
            else:
                require(value == ref[key], f"table_sojourn {key}: {value!r} != {ref[key]!r}")
    log(f"[study] table_sojourn through repro_torch.launch.study (sets {sets}, N = {n_jobs}, "
        f"{sum(r['trials'] for r in rows)} calls) on the card in {secs:.2f} s, "
        f"{launched} sojourn_enum launches: every row within {worst:.3e} of device=\"cpu\"")


def phase_study() -> dict:
    """Phase 4b: the paper's studies through the entry points a user calls.

    The numerical study: ``evaluate_many`` over the five algorithms for
    workload sets STUDY_SETS at N = 3-8, M = 2 on the card, each value held
    to the same call on the CPU (identically seeded rngs) within RTOL, with
    the launch counts set to 0 just before and read just after; the host
    wall and the launches of each call, and the card's busy share of one
    more N = 8 call under ``torch.profiler``; from the median walls, the
    projected host time of the study at CI scale and at paper scale.  One
    table (``table_study``) also goes through ``repro_torch.launch.study``
    inside the counted window.  Then an exhaustive DES (``simulate`` over every outcome combination, weighted
    by its probability) against ``dynamic_sojourn_enum`` on DES_SERVERS
    servers, and the online study over the whole synthetic trace."""
    import dataclasses
    import statistics

    import numpy as np

    from repro_torch.configs.paper_workloads import NUMERICAL, TRACE
    from repro_torch.core import evaluator, simulator
    from repro_torch.core.jobs import generate_workload
    from repro_torch.core.trace import synthesize_trace
    from repro_torch.launch import study
    from repro_torch.launch.study import STUDY_ALGS, _trials_for

    sweep = NUMERICAL.n_jobs_sweep
    kernels = ("sojourn_enum", "dynamic_sojourn_enum")
    walls = {n: [] for n in sweep}
    per_call = {n: set() for n in sweep}
    worst = 0.0
    reset_counts()
    for ws in STUDY_SETS:
        for n in sweep:
            seed = 1000 * ws + n
            g_card, g_cpu = np.random.default_rng(seed), np.random.default_rng(seed)
            for _ in range(STUDY_TRIALS_LAST if n == max(sweep) else STUDY_TRIALS):
                jobs = generate_workload(g_card, n, NUMERICAL.num_stages, ws)
                before = read_counts()
                t0 = time.perf_counter()
                got = evaluator.evaluate_many(jobs, STUDY_ALGS, g_card)
                walls[n].append(time.perf_counter() - t0)
                after = read_counts()
                per_call[n].add(tuple(after[k] - before[k] for k in kernels))
                want = evaluator.evaluate_many(
                    generate_workload(g_cpu, n, NUMERICAL.num_stages, ws), STUDY_ALGS, g_cpu,
                    device="cpu")
                for alg in STUDY_ALGS:
                    require(math.isfinite(got[alg]) and got[alg] > 0,
                            f"study set {ws} N={n}: {alg}={got[alg]!r}")
                    worst = max(worst, rel_err(got[alg], want[alg]))
                    require(rel_err(got[alg], want[alg]) <= RTOL,
                            f"study set {ws} N={n} {alg}: card {got[alg]!r}, plain {want[alg]!r}")
                require(got["optimal"] <= min(got.values()) * (1 + RTOL),
                        f"study set {ws} N={n}: OPTIMAL above another policy: {got}")
    table_study(study)
    counts = read_counts()
    log(f"[study] launches: {counts}; every value within {worst:.3e} of the plain path")
    for name in kernels:
        require(counts[name] > 0, f"kernel {name} was not launched by the numerical study")
    require(counts["sojourn_mc"] == 0 and counts["dynamic_sojourn_mc"] == 0,
            f"a Monte-Carlo kernel ran at K <= 2^8: {counts}")
    by_n = {}
    for n in sweep:
        require(len(per_call[n]) == 1, f"N={n}: launches differ between calls: {per_call[n]}")
        (launched,) = per_call[n]
        by_n[n] = {"calls": len(walls[n]), "median_s": statistics.median(walls[n]),
                   "min_s": min(walls[n]), "max_s": max(walls[n]),
                   "launches_a_call": dict(zip(kernels, launched))}
        log(f"[study] N={n} M={NUMERICAL.num_stages}: {len(walls[n])} calls, host wall a call "
            f"median {by_n[n]['median_s']:.4f} s (min {by_n[n]['min_s']:.4f}, max "
            f"{by_n[n]['max_s']:.4f}); launches a call {by_n[n]['launches_a_call']}")
    # one more N = 8 call under torch.profiler: the card's busy share of its wall
    n8 = max(sweep)
    jobs8 = generate_workload(np.random.default_rng(8), n8, NUMERICAL.num_stages, 1)
    box = {}

    def call():
        t0 = time.perf_counter()
        evaluator.evaluate_many(jobs8, STUDY_ALGS, np.random.default_rng(9))
        box["s"] = time.perf_counter() - t0

    traced = device_kernels(call)
    device_ms = sum(e.self_device_time_total for e in traced) / 1e3 or None
    busy = device_ms / (box["s"] * 1e3) if device_ms else None
    log(f"[study] N={n8} call under torch.profiler: device time "
        f"{device_ms if device_ms is None else f'{device_ms:.3f}'} ms in a host wall of "
        f"{box['s'] * 1e3:.3f} ms: busy share "
        f"{'not measured' if busy is None else f'{busy:.2%}'}")
    sets = len(NUMERICAL.workload_sets)
    ci_set = sum(_trials_for(n, False) * by_n[n]["median_s"] for n in sweep)
    paper_set = sum(_trials_for(n, True) * by_n[n]["median_s"] for n in sweep)
    calls_ci = sum(_trials_for(n, False) for n in sweep)
    log(f"[study] projected host time from the median walls: CI scale {calls_ci} calls a set, "
        f"{ci_set:.1f} s a set, {ci_set * sets:.1f} s for sets 1-{sets}; paper scale "
        f"{NUMERICAL.trials} trials a (set, N), {paper_set / 3600:.2f} h a set, "
        f"{paper_set * sets / 3600:.2f} h for sets 1-{sets} (projected, not run)")

    # the exhaustive DES against the dynamic kernel on 1-3 servers
    rng = np.random.default_rng(SEED)
    groups = []
    while len(groups) < DES_GROUPS:
        jobs = ragged_group(rng, DES_JOBS, DES_MAX_STAGES)
        if (evaluator.exact_combination_count(jobs) >= DES_MIN_COMBOS and untied(jobs, "sr")
                and untied(jobs, "serpt")):
            groups.append(jobs)
    des_worst, t0 = 0.0, time.perf_counter()
    for jobs in groups:
        outcomes, weights = evaluator.enumerate_outcomes(jobs)
        fixed = [[dataclasses.replace(j, outcome_stage=int(s)) for j, s in zip(jobs, row)]
                 for row in outcomes]
        for policy in ("sr", "serpt"):
            for w in DES_SERVERS:
                des = sum(wt * simulator.simulate(f, w, policy).mean_sojourn_successful
                          for f, wt in zip(fixed, weights))
                card = evaluator.expected_sojourn_dynamic(jobs, policy, n_servers=w)
                des_worst = max(des_worst, rel_err(des, card))
                require(rel_err(des, card) <= RTOL,
                        f"exhaustive DES {des!r} != dynamic_sojourn_enum {card!r} "
                        f"({policy}, W={w}, K={len(outcomes)})")
    log(f"[study] exhaustive DES vs dynamic_sojourn_enum: {DES_GROUPS} ragged groups of "
        f"{DES_JOBS} jobs (K = {[len(evaluator.enumerate_outcomes(j)[0]) for j in groups]}), "
        f"SR and SERPT, W = {DES_SERVERS}: max rel err {des_worst:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")

    # the online study over the whole synthetic trace (host code by design):
    # one policy on one server count
    t0 = time.perf_counter()
    trace = synthesize_trace(np.random.default_rng(13), n_jobs=TRACE.n_jobs,
                             duration_days=TRACE.duration_days)
    events = len(trace) + sum(j.outcome_stage + 1 for j in trace)
    log(f"[study] synthesize_trace: {len(trace)} jobs in {time.perf_counter() - t0:.2f} s; "
        f"{events} heap events a run (each arrival and each served stage)")
    t0 = time.perf_counter()
    res = simulator.simulate(trace, TRACE_SERVERS, policy=TRACE_POLICY,
                             rng=np.random.default_rng(17))
    secs = time.perf_counter() - t0
    require(res.n_jobs == TRACE.n_jobs and math.isfinite(res.mean_sojourn_successful)
            and res.n_success > 0, f"trace W={TRACE_SERVERS} {TRACE_POLICY}: {res}")
    online = [{"servers": TRACE_SERVERS, "policy": TRACE_POLICY, "wall_s": secs,
               "events_per_s": events / secs,
               "mean_sojourn_successful": res.mean_sojourn_successful,
               "n_success": res.n_success}]
    log(f"[study] trace W={TRACE_SERVERS} {TRACE_POLICY}: {secs:.3f} s, {events / secs:.0f} "
        f"events/s, mean sojourn of successful jobs {res.mean_sojourn_successful!r}, "
        f"n_success {res.n_success}")
    eval_tables = phase_eval_tables(study)
    return {"launches": counts, "by_n": by_n, "max_rel_err": worst,
            "n8_device_ms": device_ms, "n8_profiled_wall_s": box["s"], "n8_busy_share": busy,
            "des_max_rel_err": des_worst, "trace": online, "eval_tables": eval_tables}


def phase_eval_tables(study) -> dict:
    """Phase 4b, last: the seed (materialised) designs against the fused
    kernels, ``table_eval_perf``, ``table_eval_dynamic`` and
    ``table_eval_mc`` through ``repro_torch.launch.study`` on the card at
    the reference's CI sizes (K = 2**21; K = 2**27 with 2**23 streamed and
    2**21 materialised samples), with the reference's own checks (fused
    against seed within 1e-9, the streamed estimate within 3 sigma, the
    streamed throughput at least twice the materialised one) and the launch
    counts around them."""
    import tempfile

    out = {}
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("eval_perf", "eval_dynamic", "eval_mc"):
            t0 = time.perf_counter()
            out[name] = study.TABLES[name](out=tmp)
            log(f"[study] table_{name} on the card in {time.perf_counter() - t0:.1f} s: "
                f"{json.dumps(out[name])}")
    counts = read_counts()
    log(f"[study] table_eval_* launches: {counts}")
    for name in ("sojourn_enum", "sojourn_mc", "sojourn_outcomes", "dynamic_sojourn_enum"):
        require(counts[name] > 0, f"the table_eval_* tables launched no {name}")
    return {"rows": out, "launches": counts}


def serve_model(dev, cfg, warm_len: int = 64, setup=None) -> dict:
    """Random weights for ``cfg`` from the seed (then ``setup(params)``, if
    given), the family's extras from the frontend stubs, a short warm-up
    (cuBLAS, the kernels), then one timed ``generate`` of SERVE_BATCH
    prompts of SERVE_PROMPT tokens and SERVE_STEPS decode steps through
    ``repro_torch.launch.serve``, with the launch counts set to 0 just
    before it and read just after."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.frontends import make_extras
    from repro_torch.models.init import tree_bytes

    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, dev)
    if setup is not None:
        setup(params)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                            device=dev)
    extras = make_extras(gen, cfg, SERVE_BATCH)
    torch.cuda.synchronize()
    tag = f"[serving {cfg.name}]"
    log(f"{tag} {cfg.n_layers} layers, {cfg.param_count() / 1e9:.4g} B parameters, "
        f"{tree_bytes(params) / 1e9:.4g} GB of weights made in {time.perf_counter() - t0:.1f} s")
    plan = serve.ServePlan(cfg=cfg, max_len=SERVE_PROMPT + SERVE_STEPS + 1, device=dev)
    serve.generate(plan, params, prompts[:, :warm_len], gen_len=2, extras=extras)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res = serve.generate(plan, params, prompts, gen_len=SERVE_STEPS + 1, extras=extras)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    free = torch.cuda.get_device_properties(dev).total_memory - torch.cuda.max_memory_reserved(dev)
    decode_ms = [t * 1e3 for t in res.decode_s]
    log(f"{tag} prefill {SERVE_BATCH} x {SERVE_PROMPT}: {res.prefill_s * 1e3:.1f} ms; "
        f"{len(decode_ms)} decode steps: mean {sum(decode_ms) / len(decode_ms):.2f} ms, "
        f"min {min(decode_ms):.2f}, max {max(decode_ms):.2f} (host clock, synchronised)")
    log(f"{tag} cache {res.cache_bytes / 1e9:.4g} GB, prefill logits "
        f"{res.logits_bytes / 1e9:.4g} GB, peak allocated {peak / 1e9:.4g} GB, free at the "
        f"peak {free / 1e9:.4g} GB of the card")
    log(f"{tag} launches: {counts}; tokens of req0: {res.tokens[0, :8].tolist()}")
    require(tuple(res.tokens.shape) == (SERVE_BATCH, SERVE_STEPS + 1), "token count")
    require(int(res.tokens.max()) < cfg.vocab_size and int(res.tokens.min()) >= 0,
            "a token outside the vocabulary")
    require(bool(torch.isfinite(res.first_decode_logits).all()), "non-finite decode logits")
    return {"params": params, "prompts": prompts, "extras": extras, "plan": plan, "res": res,
            "counts": counts, "tag": tag, "peak_gb": peak / 1e9}


def logits_err(tag: str, got, want) -> tuple[float, float]:
    """(relative L2, largest absolute) error of float32 logits (B, V)."""
    rel, max_abs = rel_l2(got, want), float((got - want).abs().max())
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    log(f"{tag}: rel L2 {rel:.3e}, max abs {max_abs:.3e} (logit std {float(want.std()):.3f}), "
        f"argmax agrees on {agree}/{want.shape[0]}")
    return rel, max_abs


def busy_shares(run: dict, top: int = 0) -> None:
    """The card's busy share: kernel and copy time under ``torch.profiler``
    of one more prefill and three decode steps, over the wall time of the
    same work in the unprofiled run; with ``top``, the prefill's and the
    decode steps' ``top`` kernels by device time."""
    from repro_torch.launch import serve

    plan, params, prompts, res = run["plan"], run["params"], run["prompts"], run["res"]
    prefill, decode = serve.make_prefill_fn(plan), serve.make_decode_fn(plan)
    batch = {"tokens": prompts, **run["extras"]}
    out = {}

    def prefill_and_prime():
        out["cache"] = prefill(params, batch)[1]
        out["memory"] = serve.make_prime_fn(plan)(params, batch)

    prefill_dev = profiled_device_ms(prefill_and_prime, top, f"{run['tag']} prefill kernel")
    steps = 3
    decode_dev = profiled_device_ms(lambda: [
        decode(params, res.tokens[:, i : i + 1], out["cache"], SERVE_PROMPT + i, out["memory"])
        for i in range(steps)], top, f"{run['tag']} {steps} decode steps' kernel")
    mean_decode_ms = sum(res.decode_s) / len(res.decode_s) * 1e3
    for name, dev_ms, wall_ms in (("prefill", prefill_dev, res.prefill_s * 1e3),
                                  ("decode step", decode_dev and decode_dev / steps,
                                   mean_decode_ms)):
        log(f"{run['tag']} {name}: device busy {dev_ms!r} ms of {wall_ms:.2f} ms wall, share "
            f"{dev_ms and dev_ms / wall_ms!r} (torch.profiler kernel and copy time)")


def release(run: dict) -> None:
    import torch

    run.clear()
    torch.cuda.empty_cache()


def phase_serving(dev) -> dict:
    """Phase 5a: Qwen3-8B at full width and depth."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve

    cfg = get_config("qwen3-8b")
    run = serve_model(dev, cfg)
    counts = run["counts"]
    require(counts["flash_fwd"] == cfg.n_layers,
            f"flash_fwd launched {counts['flash_fwd']} times in one prefill of "
            f"{cfg.n_layers} layers")
    # decode step 1 against a prefill of the prompt plus the prefill's token
    res = run["res"]
    longer = torch.cat([run["prompts"], res.tokens[:, :1]], dim=1)
    want = serve.make_prefill_fn(run["plan"])(run["params"], {"tokens": longer})[0][:, -1].clone()
    rel, max_abs = logits_err(f"{run['tag']} decode step 1 vs prefill of {SERVE_PROMPT + 1} "
                              "tokens", res.first_decode_logits, want)
    require(rel <= SERVE_REL_L2 and max_abs <= SERVE_MAX_ABS,
            f"decode vs prefill: rel L2 {rel:.3e}, max abs {max_abs:.3e}")
    del want
    busy_shares(run)
    unmeshed = unmeshed_of(run)
    release(run)
    return {"launches": counts, "unmeshed": unmeshed}


def unmeshed_of(run: dict) -> dict:
    """What phase 9 holds a meshed ``generate`` to: the timed run's tokens,
    first decode logits, walls and launch counts (on the host)."""
    res = run["res"]
    return {"tokens": res.tokens.cpu(), "first_decode_logits": res.first_decode_logits.cpu(),
            "prefill_s": res.prefill_s, "decode_s": list(res.decode_s),
            "counts": run["counts"]}


def mamba_decode_vs_prefill(tag: str, plan, params, prompts) -> float:
    """Relative L2 error of the last of 256 decode steps, after a prefill
    of the prompts' first tokens, against the whole prompts' prefill."""
    import torch

    from repro_torch.launch import serve

    head = prompts.shape[1] - 256
    want = serve.make_prefill_fn(plan)(params, {"tokens": prompts})[0][:, -1].clone()
    _, cache = serve.make_prefill_fn(plan)(params, {"tokens": prompts[:, :head]})
    decode = serve.make_decode_fn(plan)
    t0 = time.perf_counter()
    for pos in range(head, prompts.shape[1]):
        got, cache = decode(params, prompts[:, pos : pos + 1], cache, pos)
    torch.cuda.synchronize()
    log(f"{tag} 256 decode steps after a {head}-token prefill in "
        f"{time.perf_counter() - t0:.2f} s")
    require(bool(torch.isfinite(got).all()), "non-finite decode logits")
    return logits_err(f"{tag} step 256 vs the {prompts.shape[1]}-token prefill", got[:, 0],
                      want)[0]


def phase_serving_mamba(dev) -> dict:
    """Phase 5b: Mamba2-1.3B, the whole model.  Then a prefill of the first
    1792 prompt tokens and 256 decode steps over the other 256, against the
    2048-token prefill's last logits, for the whole model and a shallow
    copy."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    cfg = get_config("mamba2-1.3b")
    run = serve_model(dev, cfg)
    counts = run["counts"]
    require(counts["ssd_fwd"] == cfg.n_layers,
            f"ssd_fwd launched {counts['ssd_fwd']} times in one prefill of {cfg.n_layers} layers")
    require(counts["flash_fwd"] == 0 and counts["moe_ffn_fwd"] == 0,
            "an attention or MoE kernel ran in an attention-free model")
    plan, params, prompts = run["plan"], run["params"], run["prompts"]
    rel = mamba_decode_vs_prefill(run["tag"], plan, params, prompts)
    # the rounding floor: the same prefill in chunks of 128, as right as 256
    want = serve.make_prefill_fn(plan)(params, {"tokens": prompts})[0][:, -1].clone()
    plan128 = serve.ServePlan(cfg=dataclasses.replace(cfg, ssm_chunk=128), max_len=plan.max_len,
                              device=dev)
    alt = serve.make_prefill_fn(plan128)(params, {"tokens": prompts})[0][:, -1].clone()
    floor, _ = logits_err(f"{run['tag']} floor: the prefill in chunks of 128 vs 256", alt, want)
    log(f"{run['tag']} decode vs prefill {rel:.3e}, bar {MAMBA_FLOOR_FACTOR} x floor "
        f"{floor:.3e} = {MAMBA_FLOOR_FACTOR * floor:.3e}")
    require(rel <= MAMBA_FLOOR_FACTOR * floor,
            f"Mamba decode vs prefill: rel L2 {rel:.3e} > {MAMBA_FLOOR_FACTOR} x floor {floor:.3e}")
    del want, alt
    busy_shares(run)
    release(run)
    # a shallow copy at full width: little rounding to hide a fault behind
    shallow = dataclasses.replace(cfg, n_layers=MAMBA_SHALLOW_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = T.init_params(shallow, gen, dev)
    plan = serve.ServePlan(cfg=shallow, max_len=SERVE_PROMPT + 1, device=dev)
    rel = mamba_decode_vs_prefill(f"[serving {cfg.name}, {shallow.n_layers} layers]", plan,
                                  params, prompts)
    require(rel <= MAMBA_SHALLOW_REL_L2,
            f"Mamba {shallow.n_layers}-layer decode vs prefill: rel L2 {rel:.3e} > "
            f"{MAMBA_SHALLOW_REL_L2}")
    del params, prompts
    torch.cuda.empty_cache()
    return {"launches": counts}


def count_dropped(plan, params, prompts) -> tuple[int, int]:
    """(MoE layer calls, (token, expert) pairs dropped) of one prefill, seen
    by wrapping ``moe._slot_positions`` for that prefill only."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import moe

    dropped = []
    slot_positions = moe._slot_positions

    def counting(*args):
        pos, keep = slot_positions(*args)
        dropped.append((~keep).sum())
        return pos, keep

    moe._slot_positions = counting
    try:
        serve.make_prefill_fn(plan)(params, {"tokens": prompts})
    finally:
        moe._slot_positions = slot_positions
    return len(dropped), int(torch.stack(dropped).sum())


def recording_moe_shapes(fn):
    """(``fn()``, the set of (E, R, Dm, Dff) that ``moe_ffn_fwd`` was called
    with meanwhile), seen by wrapping the wrapper for that call only."""
    from repro_torch.kernels.moe_gemm import kernel as MK

    shapes = set()
    moe_ffn_fwd = MK.moe_ffn_fwd

    def recording(x, wg, wu, wd):
        shapes.add((*x.shape, wg.shape[-1]))
        return moe_ffn_fwd(x, wg, wu, wd)

    MK.moe_ffn_fwd = recording
    try:
        return fn(), shapes
    finally:
        MK.moe_ffn_fwd = moe_ffn_fwd


def phase_serving_mixtral(dev) -> dict:
    """Phase 5c: Mixtral-8x22B at full width and MIXTRAL_LAYERS layers;
    the capacity's drop share; decode step 1 against a longer prefill on
    a copy of the config whose capacity drops nothing."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import moe

    cfg = get_config("mixtral-8x22b", n_layers=MIXTRAL_LAYERS)
    run, moe_shapes = recording_moe_shapes(lambda: serve_model(dev, cfg))
    counts = run["counts"]
    calls = cfg.n_layers * (SERVE_STEPS + 1)  # the prefill and each decode step
    require(counts["flash_fwd"] == cfg.n_layers,
            f"flash_fwd launched {counts['flash_fwd']} times in one prefill of "
            f"{cfg.n_layers} layers")
    require(counts["moe_ffn_fwd"] == 2 * calls,
            f"moe_ffn_fwd launched {counts['moe_ffn_fwd']} times, not twice in each of "
            f"{calls} MoE layer calls")
    require(counts["ssd_fwd"] == 0, "ssd_fwd ran in an attention model")
    g, cap = moe.capacity(cfg, SERVE_BATCH * SERVE_PROMPT)
    pairs = SERVE_BATCH * SERVE_PROMPT * cfg.top_k * cfg.n_layers
    moe_calls, dropped = count_dropped(run["plan"], run["params"], run["prompts"])
    require(moe_calls == cfg.n_layers, f"{moe_calls} MoE layer calls in a prefill")
    log(f"{run['tag']} prefill routing: groups of {g} tokens, cap {cap}; dropped {dropped} of "
        f"{pairs} (token, expert) pairs, share {dropped / pairs:.4%}")
    busy_shares(run, top=6)
    # decode vs prefill where no token can drop: capacity_factor = E / k
    no_drop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    prompt = run["prompts"][:, :512]
    plan = serve.ServePlan(cfg=no_drop, max_len=prompt.shape[1] + 2, device=dev)
    logits, cache = serve.make_prefill_fn(plan)(run["params"], {"tokens": prompt})
    tok = logits[:, -1, : cfg.vocab_size].argmax(dim=-1, keepdim=True)
    del logits
    got, _ = serve.make_decode_fn(plan)(run["params"], tok, cache, prompt.shape[1])
    longer = torch.cat([prompt, tok], dim=1)
    want = serve.make_prefill_fn(plan)(run["params"], {"tokens": longer})[0][:, -1].clone()
    rel, _ = logits_err(f"{run['tag']} no-drop copy: decode step 1 vs prefill of "
                        f"{prompt.shape[1] + 1} tokens", got[:, 0], want)
    require(bool(torch.isfinite(got).all()), "non-finite decode logits")
    require(rel <= MIXTRAL_REL_L2, f"Mixtral decode vs prefill: rel L2 {rel:.3e}")
    del got, want, cache
    release(run)
    return {"launches": counts, "dropped_share": dropped / pairs, "moe_shapes": moe_shapes}


def phase_serving_kimi(dev) -> dict:
    """Phase 5d: Kimi-K2 at full width and KIMI_LAYERS layers, whose head
    dim is 112; its peak memory and the capacity's drop share; decode step
    1 against a longer prefill on a copy of the config whose capacity drops
    nothing."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import moe

    cfg = get_config("kimi-k2-1t-a32b", n_layers=KIMI_LAYERS)
    require(cfg.hd == 112, f"{cfg.name} head dim {cfg.hd}, not 112")
    run, moe_shapes = recording_moe_shapes(lambda: serve_model(dev, cfg))
    counts = run["counts"]
    calls = cfg.n_layers * (SERVE_STEPS + 1)  # the prefill and each decode step
    require(counts["flash_fwd"] == cfg.n_layers,
            f"flash_fwd launched {counts['flash_fwd']} times in one prefill of "
            f"{cfg.n_layers} layers")
    require(counts["moe_ffn_fwd"] == 2 * calls,
            f"moe_ffn_fwd launched {counts['moe_ffn_fwd']} times, not twice in each of "
            f"{calls} MoE layer calls")
    require(counts["ssd_fwd"] == 0, "ssd_fwd ran in an attention model")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    require(peak_gb <= KIMI_PEAK_GB, f"peak {peak_gb:.4g} GB above {KIMI_PEAK_GB} GB")
    g, cap = moe.capacity(cfg, SERVE_BATCH * SERVE_PROMPT)
    pairs = SERVE_BATCH * SERVE_PROMPT * cfg.top_k * cfg.n_layers
    moe_calls, dropped = count_dropped(run["plan"], run["params"], run["prompts"])
    require(moe_calls == cfg.n_layers, f"{moe_calls} MoE layer calls in a prefill")
    require(0 <= dropped < pairs, f"{dropped} of {pairs} (token, expert) pairs dropped")
    log(f"{run['tag']} prefill routing: groups of {g} tokens, cap {cap}; dropped {dropped} of "
        f"{pairs} (token, expert) pairs, share {dropped / pairs:.4%}")
    busy_shares(run, top=6)
    # decode vs prefill where no token can drop: capacity_factor = E / k
    no_drop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    prompt = run["prompts"][:, :KIMI_NO_DROP_PROMPT]
    plan = serve.ServePlan(cfg=no_drop, max_len=prompt.shape[1] + 2, device=dev)
    logits, cache = serve.make_prefill_fn(plan)(run["params"], {"tokens": prompt})
    tok = logits[:, -1, : cfg.vocab_size].argmax(dim=-1, keepdim=True)
    del logits
    got, _ = serve.make_decode_fn(plan)(run["params"], tok, cache, prompt.shape[1])
    longer = torch.cat([prompt, tok], dim=1)
    want = serve.make_prefill_fn(plan)(run["params"], {"tokens": longer})[0][:, -1].clone()
    rel, _ = logits_err(f"{run['tag']} no-drop copy: decode step 1 vs prefill of "
                        f"{prompt.shape[1] + 1} tokens", got[:, 0], want)
    require(bool(torch.isfinite(got).all()), "non-finite decode logits")
    require(rel <= KIMI_REL_L2, f"Kimi-K2 decode vs prefill: rel L2 {rel:.3e}")
    del got, want, cache
    release(run)
    return {"launches": counts, "dropped_share": dropped / pairs, "peak_gb": peak_gb,
            "moe_shapes": moe_shapes}


def longer_prefill_err(run: dict, tag: str) -> float:
    """Relative L2 error of the timed run's decode step 1 against the last
    logits of a prefill of the prompts plus their first new token, with the
    same extras."""
    import torch

    from repro_torch.launch import serve

    res = run["res"]
    longer = torch.cat([run["prompts"], res.tokens[:, :1]], dim=1)
    want = serve.make_prefill_fn(run["plan"])(
        run["params"], {"tokens": longer, **run["extras"]})[0][:, -1].clone()
    rel, _ = logits_err(f"{run['tag']} {tag}: decode step 1 vs prefill of "
                        f"{longer.shape[1]} tokens", res.first_decode_logits, want)
    return rel


def require_launches(tag: str, counts: dict, want: dict) -> None:
    for name, n in want.items():
        require(counts[name] == n, f"{tag} {name} launched {counts[name]} times, not {n}")


def phase_serving_jamba(dev) -> dict:
    """Phase 5e: Jamba at full width and JAMBA_LAYERS layers (one period);
    the capacity's drop share; decode step 1 against a longer prefill on a
    copy of the config whose capacity drops nothing."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve

    cfg = get_config(JAMBA, n_layers=JAMBA_LAYERS)
    run, moe_shapes = recording_moe_shapes(lambda: serve_model(dev, cfg))
    attn_layers = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    # the prefill runs flash_fwd at each attention layer and ssd_fwd at each
    # Mamba layer; decode attends with the plain oracle and runs the Mamba
    # recurrence; moe_ffn_fwd twice at each MoE layer of the prefill and of
    # each decode step
    require_launches(run["tag"], run["counts"], {
        "flash_fwd": attn_layers, "ssd_fwd": cfg.n_layers - attn_layers,
        "moe_ffn_fwd": 2 * moe_layers * (SERVE_STEPS + 1)})
    require(set(moe_serving_shapes(JAMBA)) <= moe_shapes,
            f"moe_ffn_fwd shapes {sorted(moe_shapes)} lack phase 1's {moe_serving_shapes(JAMBA)}")
    pairs = SERVE_BATCH * SERVE_PROMPT * cfg.top_k * moe_layers
    moe_calls, dropped = count_dropped(run["plan"], run["params"], run["prompts"])
    require(moe_calls == moe_layers, f"{moe_calls} MoE layer calls in a prefill")
    log(f"{run['tag']} prefill routing: dropped {dropped} of {pairs} (token, expert) pairs, "
        f"share {dropped / pairs:.4%}")
    busy_shares(run, top=6)
    # decode vs prefill where no token can drop: capacity_factor = E / k
    no_drop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    prompt = run["prompts"][:, :JAMBA_NO_DROP_PROMPT]
    plan = serve.ServePlan(cfg=no_drop, max_len=prompt.shape[1] + 2, device=dev)
    logits, cache = serve.make_prefill_fn(plan)(run["params"], {"tokens": prompt})
    tok = logits[:, -1, : cfg.vocab_size].argmax(dim=-1, keepdim=True)
    del logits
    got, _ = serve.make_decode_fn(plan)(run["params"], tok, cache, prompt.shape[1])
    longer = torch.cat([prompt, tok], dim=1)
    want = serve.make_prefill_fn(plan)(run["params"], {"tokens": longer})[0][:, -1].clone()
    rel, _ = logits_err(f"{run['tag']} no-drop copy: decode step 1 vs prefill of "
                        f"{longer.shape[1]} tokens", got[:, 0], want)
    require(bool(torch.isfinite(got).all()), "non-finite decode logits")
    require(rel <= JAMBA_REL_L2, f"Jamba decode vs prefill: rel L2 {rel:.3e} > {JAMBA_REL_L2}")
    out = {"launches": run["counts"], "dropped_share": dropped / pairs, "moe_shapes": moe_shapes,
           "peak_gb": run["peak_gb"], "decode_vs_prefill": rel}
    del got, want, cache
    release(run)
    return out


def phase_serving_vision(dev) -> dict:
    """Phase 5f: Llama-3.2-Vision-11B, the whole model, each period's gate
    at VISION_GATE; decode step 1 against a longer prefill with the same
    image; the cross path live: a second image's memory moves decode step
    1's logits."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models.frontends import make_extras

    cfg = get_config(VISION)
    require(cfg.num_image_tokens == VISION_IMAGE_TOKENS, f"{cfg.num_image_tokens} image tokens")
    run = serve_model(dev, cfg, setup=lambda p: p["periods"]["pos0"]["attn"]["gate"].fill_(
        VISION_GATE))
    cross = cfg.n_layers // cfg.cross_attn_period
    # flash_fwd at each self-attention and each cross-attention layer of the
    # prefill, none in prime_memory (projections only), and at each cross
    # layer of each decode step (one query row over the image tokens)
    require_launches(run["tag"], run["counts"], {
        "flash_fwd": cfg.n_layers + cross * SERVE_STEPS, "ssd_fwd": 0, "moe_ffn_fwd": 0})
    rel = longer_prefill_err(run, "same image")
    require(rel <= VISION_REL_L2, f"vision decode vs prefill: rel L2 {rel:.3e} > {VISION_REL_L2}")
    # the cross path is live: the same cache, a second image's memory
    plan, params = run["plan"], run["params"]
    prompt = run["prompts"][:, :VISION_LIVE_PROMPT]
    other = make_extras(torch.Generator(device=dev).manual_seed(SEED + 1), cfg, SERVE_BATCH)
    logits, cache = serve.make_prefill_fn(plan)(params, {"tokens": prompt, **run["extras"]})
    tok = logits[:, -1, : cfg.vocab_size].argmax(dim=-1, keepdim=True)
    del logits
    decode, prime = serve.make_decode_fn(plan), serve.make_prime_fn(plan)
    first, _ = decode(params, tok, cache, prompt.shape[1], prime(params, run["extras"]))
    second, _ = decode(params, tok, cache, prompt.shape[1], prime(params, other))
    moved = rel_l2(second[:, 0], first[:, 0])
    log(f"{run['tag']} decode step 1 at {prompt.shape[1]} tokens with a second image: logits "
        f"move by {moved:.3e} relative L2 (floor {VISION_LIVE_FLOOR}, gate {VISION_GATE})")
    require(moved > VISION_LIVE_FLOOR, f"the cross path moves the logits by {moved:.3e}, not "
            f"more than {VISION_LIVE_FLOOR}")
    busy_shares(run)
    out = {"launches": run["counts"], "peak_gb": run["peak_gb"], "decode_vs_prefill": rel,
           "second_image_rel_l2": moved, "unmeshed": unmeshed_of(run)}
    del first, second, cache
    release(run)
    return out


def phase_serving_seamless(dev) -> dict:
    """Phase 5g: Seamless-M4T-large-v2, the whole model, over SERVE_PROMPT
    stub frames; decode step 1 against a longer prefill with the same
    frames."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(SEAMLESS), frontend_frames=SERVE_PROMPT)
    run = serve_model(dev, cfg)
    # the prefill runs flash_fwd at each encoder layer, each decoder
    # self-attention and each cross attention; prime_memory runs the encoder
    # again, as the reference's does; each decode step runs it at each
    # decoder layer's cross attention (one query row over the frames)
    require_launches(run["tag"], run["counts"], {
        "flash_fwd": 2 * cfg.n_enc_layers + 2 * cfg.n_layers + cfg.n_layers * SERVE_STEPS,
        "ssd_fwd": 0, "moe_ffn_fwd": 0})
    rel = longer_prefill_err(run, "same frames")
    require(rel <= SEAMLESS_REL_L2,
            f"Seamless decode vs prefill: rel L2 {rel:.3e} > {SEAMLESS_REL_L2}")
    busy_shares(run)
    out = {"launches": run["counts"], "peak_gb": run["peak_gb"], "decode_vs_prefill": rel,
           "unmeshed": unmeshed_of(run)}
    release(run)
    return out


def phase_examples() -> dict:
    """Phase 8: the two examples on the card through their ``main(argv)``,
    with the reference's configs (the SMOKE ones at head dims 16 and 32),
    the launch counts around each: every attention kernel trains in the
    first, every model kernel runs in the second (whose pool holds Mamba2,
    Mixtral and Jamba); each job ends as a success or terminated, and the
    walls are positive.  Then ``python -m repro_torch.launch.serve --smoke``
    for Qwen3-8B and Mamba2-1.3B (head dim 16; the SSD scan)."""
    import tempfile

    from repro_torch.examples import cluster_schedule, train_early_termination

    out = {}
    reset_counts()
    t0 = time.perf_counter()
    losses = train_early_termination.main(EXAMPLE_TRAIN_ARGS)
    secs = time.perf_counter() - t0
    counts = read_counts()
    log(f"[examples] train_early_termination {' '.join(EXAMPLE_TRAIN_ARGS)}: stage losses "
        f"{losses} in {secs:.1f} s; launches {counts}")
    require(len(losses) >= 1 and all(math.isfinite(x) for x in losses) and secs > 0,
            f"train_early_termination: {losses}")
    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        require(counts[name] > 0, f"train_early_termination launched no {name}")
    out["train"] = {"stage_losses": losses, "wall_s": secs, "launches": counts}

    reset_counts()
    with tempfile.TemporaryDirectory() as cache_dir:
        os.environ["REPRO_CACHE_DIR"] = cache_dir
        try:
            t0 = time.perf_counter()
            res, jobs = cluster_schedule.main(EXAMPLE_CLUSTER_ARGS)
            secs = time.perf_counter() - t0
        finally:
            del os.environ["REPRO_CACHE_DIR"]
    counts = read_counts()
    sojourns = {j.name: j.completed - j.spec.arrival for j in jobs}
    log(f"[examples] cluster_schedule {' '.join(EXAMPLE_CLUSTER_ARGS)} in {secs:.1f} s: "
        f"makespan {res.makespan:.3f} s; wall-clock sojourn of each job (s): "
        + ", ".join(f"{k} {v:.3f} ({'SUCCESS' if j.success else f'terminated@{j.stage - 1}'})"
                    for j, (k, v) in zip(jobs, sojourns.items())) + f"; launches {counts}")
    for j in jobs:
        require(j.success or j.stage > 0, f"{j.name} neither succeeded nor was terminated")
        require(sojourns[j.name] > 0, f"{j.name}: sojourn {sojourns[j.name]!r}")
    require(res.makespan > 0, f"makespan {res.makespan!r}")
    for name in ("flash_fwd", "flash_dkv", "flash_dq", "ssd_fwd", "moe_ffn_fwd"):
        require(counts[name] > 0, f"cluster_schedule launched no {name}")
    out["cluster"] = {"sojourn_s": sojourns, "makespan_s": res.makespan, "wall_s": secs,
                      "launches": counts}

    from repro_torch.launch import serve

    for arch, kernel in (("qwen3-8b", "flash_fwd"), ("mamba2-1.3b", "ssd_fwd")):
        reset_counts()
        t0 = time.perf_counter()
        require(serve.main(["--arch", arch, "--smoke"]) == 0, f"serve --smoke {arch}")
        secs = time.perf_counter() - t0
        counts = read_counts()
        log(f"[examples] python -m repro_torch.launch.serve --arch {arch} --smoke in "
            f"{secs:.1f} s; launches {counts}")
        require(counts[kernel] > 0, f"serve --smoke {arch} launched no {kernel}")
        out[f"serve_smoke {arch}"] = {"wall_s": secs, "launches": counts}
    return out


def mesh_serving(dev, mesh, cfg, unmeshed: dict, tag: str, setup=None,
                 tp_weights: bool = False) -> dict:
    """Phases 9a, 9a' and 9d: ``cfg`` served meshed through
    ``default_serve_plan`` (with ``tp_weights``, the serving-weight layout)
    on the same weights (then ``setup(params, plan)``, if given), prompts,
    extras and token count as its unmeshed phase-5 ``generate``; the first
    decode step's logits held to that phase's, the tokens compared, the
    launch counts equal, both walls logged."""
    import torch

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import serve
    from repro_torch.models.frontends import make_extras

    plan = serve.default_serve_plan(
        cfg, mesh, ShapeSpec("serve", SERVE_PROMPT + SERVE_STEPS + 1, SERVE_BATCH, "prefill"),
        tp_weights=tp_weights)
    gen = torch.Generator(device=dev).manual_seed(SEED)  # phase 5's draws, in its order
    params = serve.init_weights(plan, gen)
    if setup is not None:
        setup(params, plan)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                            device=dev)
    extras = make_extras(gen, cfg, SERVE_BATCH)
    serve.generate(plan, params, prompts[:, :64], gen_len=2, extras=extras)  # warm up
    torch.cuda.synchronize()
    reset_counts()
    res = serve.generate(plan, params, prompts, gen_len=SERVE_STEPS + 1, extras=extras)
    counts = read_counts()
    rel = rel_l2(res.first_decode_logits.float().cpu(), unmeshed["first_decode_logits"].float())
    same_tokens = bool(torch.equal(res.tokens.cpu(), unmeshed["tokens"]))
    mean = lambda xs: sum(xs) / len(xs) * 1e3  # noqa: E731
    log(f"{tag} (1, 1) mesh, batch {plan.rules.resolve(('batch', 'seq'), mesh)}, weight "
        f"{plan.rules.resolve(('embed', 'mlp'), mesh)}, cache "
        f"{plan.cache_ctx.rules.resolve(('batch', 'kv_seq'), mesh)}: prefill "
        f"{res.prefill_s * 1e3:.1f} ms (unmeshed {unmeshed['prefill_s'] * 1e3:.1f}); decode "
        f"{mean(res.decode_s):.2f} ms a token (unmeshed {mean(unmeshed['decode_s']):.2f}); "
        f"first decode logits rel L2 {rel:.3e} against phase 5's; tokens equal {same_tokens}; "
        f"launches {counts} (unmeshed {unmeshed['counts']})")
    require(rel <= MESH_REL_L2, f"{tag} rel L2 {rel:.3e} > {MESH_REL_L2}")
    require(counts["flash_fwd"] == unmeshed["counts"]["flash_fwd"] > 0,
            f"{tag} meshed generate launched flash_fwd {counts['flash_fwd']} times, unmeshed "
            f"{unmeshed['counts']['flash_fwd']}")
    out = {"prefill_ms": res.prefill_s * 1e3, "decode_ms": mean(res.decode_s),
           "unmeshed_prefill_ms": unmeshed["prefill_s"] * 1e3,
           "unmeshed_decode_ms": mean(unmeshed["decode_s"]), "rel_l2": rel,
           "tokens_equal": same_tokens, "launches": counts}
    del params, res
    torch.cuda.empty_cache()
    return out


def vision_gates(params: dict, plan) -> None:
    """Every period's cross-attention gate at VISION_GATE, as phase 5f sets
    it: a new leaf placed from the whole value (not a fill of a shard)."""
    import torch

    from repro_torch.models import transformer as T

    attn = params["periods"]["pos0"]["attn"]
    logical = T.param_logical(plan.cfg)["periods"]["pos0"]["attn"]["gate"]
    attn["gate"] = plan.ctx.distribute(
        torch.full(attn["gate"].shape, VISION_GATE, dtype=attn["gate"].dtype,
                   device=plan.device), logical)


def mesh_training(dev, mesh, cfg, seq: int, tag: str, extras=None) -> dict:
    """Phases 9b and 9e: ``cfg``'s train step on one micro-batch of
    MESH_TRAIN_BATCH x ``seq`` tokens (and the batch's ``extras``),
    unmeshed and then meshed from the same seed and batch,
    MESH_TRAIN_STEPS steps each: the losses within MESH_REL_L2, the
    attention kernels' counts equal."""
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train

    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=MESH_TRAIN_BATCH, seed=0)).batch(0)
    batch = {**train.batch_to_device(batch, dev), **(extras or {})}
    out = {}
    for name, m in (("unmeshed", None), ("meshed", mesh)):
        plan = train.default_plan(cfg, m, device=dev, warmup_steps=TRAIN_LR_WARMUP,
                                  total_steps=TRAIN_STEPS)
        params, state = train.make_init(plan)(0)
        step = train.make_train_step(plan)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        losses, walls = [], []
        for _ in range(MESH_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
            walls.append(time.perf_counter() - t0)
        out[name] = {"losses": losses, "step_ms": [w * 1e3 for w in walls],
                     "launches": read_counts(),
                     "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        log(f"{tag} {name}: losses {losses}, step walls {[round(w * 1e3, 1) for w in walls]} "
            f"ms; peak allocated {out[name]['peak_gb']:.4g} GB; launches "
            f"{out[name]['launches']}")
        del params, state, step
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["meshed"]["losses"],
                                                   out["unmeshed"]["losses"]))
    log(f"{tag} loss rel err {rel:.3e}")
    require(rel <= MESH_REL_L2, f"{tag} loss rel err {rel:.3e} > {MESH_REL_L2}")
    for k in ("flash_fwd", "flash_dkv", "flash_dq"):
        require(out["meshed"]["launches"][k] == out["unmeshed"]["launches"][k] > 0,
                f"{tag} meshed {k} launches {out['meshed']['launches'][k]} != unmeshed "
                f"{out['unmeshed']['launches'][k]}")
    out["loss_rel_err"] = rel
    return out


def mesh_checkpoint(dev, mesh) -> dict:
    """Phase 9f: a meshed ``Trainer`` of Qwen3-1.7B at CKPT_LAYERS layers
    (full width) runs CKPT_STEPS steps and saves; a fresh meshed
    ``Trainer`` restores (every leaf bitwise equal to the saved one) and
    runs CKPT_STEPS more, its launch counts set to 0 just before and read
    just after; the 2 x CKPT_STEPS losses against an unbroken meshed run's
    within MESH_REL_L2.  The bytes written and the save and restore
    seconds are logged."""
    import tempfile

    import torch

    from repro_torch.ckpt.checkpoint import CheckpointManager, _named_leaves
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train

    seconds = {"save": [], "restore": []}

    class Timed(CheckpointManager):
        """The manager, its seconds of each save and restore in ``seconds``."""

        def save(self, step, tree, blocking=False):
            t0 = time.perf_counter()
            super().save(step, tree, blocking=blocking)
            seconds["save"].append(time.perf_counter() - t0)

        def restore(self, step, target, device=None):
            t0 = time.perf_counter()
            out = super().restore(step, target, device=device)
            torch.cuda.synchronize()
            seconds["restore"].append(time.perf_counter() - t0)
            return out

    cfg = get_config(TRAIN_ARCH, n_layers=CKPT_LAYERS)
    tag = f"[mesh checkpoint {cfg.name} at {CKPT_LAYERS} layers]"
    plan = train.default_plan(cfg, mesh, device=dev, warmup_steps=TRAIN_LR_WARMUP,
                              total_steps=2 * CKPT_STEPS)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                  global_batch=MESH_TRAIN_BATCH, seed=0))
    with tempfile.TemporaryDirectory() as tmp:
        saved_params, saved_state, first = train.Trainer(plan, data, Timed(tmp, keep=1)).run(
            CKPT_STEPS, log_every=0)
        path = os.path.join(tmp, f"step_{CKPT_STEPS}.npz")
        written = os.path.getsize(path) + os.path.getsize(path[:-4] + ".json")
        fresh = train.Trainer(plan, data, Timed(tmp, keep=1))
        restore = fresh.restore_or_init
        checked = {}

        def restore_and_check(seed=0):
            params, state, start = restore(seed)
            got = _named_leaves({"params": params, "opt": state})
            want = dict(_named_leaves({"params": saved_params, "opt": saved_state}))
            checked["leaves"] = len(got)
            checked["differ"] = [
                name for name, leaf in got
                if not (leaf == want[name] if isinstance(leaf, int) else
                        leaf.placements == want[name].placements and
                        torch.equal(leaf.full_tensor(), want[name].full_tensor()))]
            checked["start"] = start
            return params, state, start

        fresh.restore_or_init = restore_and_check
        reset_counts()
        _, _, resumed = fresh.run(CKPT_STEPS, log_every=0)
        counts = read_counts()
    del saved_params, saved_state
    torch.cuda.empty_cache()
    _, _, straight = train.Trainer(plan, data).run(2 * CKPT_STEPS, log_every=0)
    torch.cuda.empty_cache()
    losses = first + resumed
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, straight))
    log(f"{tag} wrote {written} bytes; save s {[round(t, 3) for t in seconds['save']]}, "
        f"restore s {[round(t, 3) for t in seconds['restore']]}; {checked['leaves']} "
        f"leaves restored at step {checked['start']}, differing {checked['differ']}; losses "
        f"{losses} against the unbroken run's {straight}: rel err {rel:.3e}, bitwise "
        f"{losses == straight}; resumed run's launches {counts}")
    require(checked["start"] == CKPT_STEPS and not checked["differ"],
            f"{tag} restored leaves differ: {checked['differ']}")
    require(rel <= MESH_REL_L2, f"{tag} losses rel err {rel:.3e} > {MESH_REL_L2}")
    require(counts["flash_fwd"] > 0, f"{tag} the resumed run launched no flash_fwd")
    return {"bytes_written": written, "save_s": seconds["save"],
            "restore_s": seconds["restore"], "losses": losses, "unbroken": straight,
            "loss_rel_err": rel, "bitwise": losses == straight, "launches": counts}


def mesh_long_decode(dev, mesh) -> dict:
    """Phase 9c: Jamba's long_500k cell at JAMBA_LAYERS layers: batch 1, a
    LONG_CACHE-token cache filled from the seed, LONG_STEPS decode steps of
    the same tokens with ``sp=True`` under LONG_CONTEXT_RULES against the
    unmeshed (``sp=False``) decode of a copy of the cache."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.init import tree_bytes, tree_leaves, tree_map

    cfg = get_config(JAMBA, n_layers=JAMBA_LAYERS)
    tag = "[mesh long_500k jamba]"
    spec = SHAPES["long_500k"]
    require(spec.seq_len == LONG_CACHE and spec.global_batch == 1, f"long_500k is {spec}")
    plan = serve.default_serve_plan(cfg, mesh, spec, long_context=True)
    plain_plan = serve.ServePlan(cfg=cfg, max_len=LONG_CACHE, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    params = serve.init_weights(plain_plan, gen)
    cache = T.init_cache(cfg, 1, LONG_CACHE, dev)
    for t in tree_leaves(cache):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev, dtype=torch.float32)
                .mul_(0.5 if t.dtype == torch.float32 else 1.0))
    tokens = torch.randint(0, cfg.vocab_size, (LONG_STEPS, 1, 1), generator=gen, device=dev)
    meshed_cache = tree_map(lambda t, log_: plan.cache_ctx.distribute(t.clone(), log_), cache,
                            T.cache_logical(cfg))
    meshed_params = tree_map(lambda t, log_: plan.ctx.distribute(t, log_), params,
                             T.param_logical(cfg))
    log(f"{tag} {cfg.n_layers} layers, cache {tree_bytes(cache) / 1e9:.4g} GB "
        f"({LONG_CACHE} tokens), kv_seq over {plan.cache_rules.rules['kv_seq']!r}, sp={plan.sp}")
    decode, plain_decode = serve.make_decode_fn(plan), serve.make_decode_fn(plain_plan)
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    wants, walls, counts = [], {"sp": [], "plain": []}, {}
    # each path in a loop of its own, its counts set to 0 just before it
    reset_counts()
    for i in range(LONG_STEPS):
        t0 = time.perf_counter()
        want, cache = plain_decode(params, tokens[i], cache, LONG_CACHE - LONG_STEPS + i)
        torch.cuda.synchronize()
        walls["plain"].append(time.perf_counter() - t0)
        wants.append(want)
    counts["plain"] = read_counts()
    errs = []
    reset_counts()
    for i in range(LONG_STEPS):
        t0 = time.perf_counter()
        got, meshed_cache = decode(meshed_params, tokens[i], meshed_cache,
                                   LONG_CACHE - LONG_STEPS + i)
        got = got.full_tensor()
        torch.cuda.synchronize()
        walls["sp"].append(time.perf_counter() - t0)
        require(bool(torch.isfinite(got).all()), f"{tag} non-finite logits at step {i}")
        errs.append(rel_l2(got.float(), wants[i].float()))
    counts["sp"] = read_counts()
    mean = {k: sum(v) / len(v) * 1e3 for k, v in walls.items()}
    log(f"{tag} decode rel L2 per step {[f'{e:.2e}' for e in errs]}; ms a step: sp "
        f"{mean['sp']:.1f}, unmeshed {mean['plain']:.1f}; launches sp {counts['sp']}, "
        f"unmeshed {counts['plain']}")
    require(max(errs) <= MESH_REL_L2, f"{tag} rel L2 {max(errs):.3e} > {MESH_REL_L2}")
    for path, n in counts.items():
        require(n["moe_ffn_fwd"] == 2 * LONG_STEPS * moe_layers,
                f"{tag} {path} decode: {n['moe_ffn_fwd']} moe_ffn_fwd launches, not "
                f"2 x {LONG_STEPS} steps x {moe_layers} MoE layers")
    del params, meshed_params, cache, meshed_cache, wants
    torch.cuda.empty_cache()
    return {"rel_l2": errs, "sp_step_ms": mean["sp"], "plain_step_ms": mean["plain"],
            "launches": counts["sp"], "plain_launches": counts["plain"]}


def mesh_compress(dev, mesh) -> dict:
    """Phase 9g: ``compressed_psum`` over Qwen3-1.7B's gradient tree (the
    gradients of one 2 x 512 batch) through NCCL, against
    ``dequantize(*quantize(g + r)[:2])`` (one rank: the mean is its own
    dequantized lanes), bit for bit."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.models.init import tree_leaves, tree_map
    from repro_torch.optim import compress

    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    params = T.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device=dev)
    _, _, grads = train.loss_and_grads(params, {"tokens": tokens, "labels": tokens}, cfg)
    del params
    residuals = tree_map(lambda g: torch.randn(g.shape, generator=gen, device=dev) * 1e-4,
                         grads)
    t0 = time.perf_counter()
    mean, new_res = compress.compressed_psum(grads, residuals, mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    same = 0
    for g, r, got, got_r in zip(tree_leaves(grads), tree_leaves(residuals), tree_leaves(mean),
                                tree_leaves(new_res)):
        q, s = compress.quantize(g.float() + r)
        want = compress.dequantize(q, s).to(g.dtype)
        same += bool(torch.equal(got, want)) and bool(
            torch.equal(got_r, g.float() + r - compress.dequantize(q, s)))
    n = len(tree_leaves(grads))
    log(f"[mesh compressed_psum] {n} gradient leaves of {cfg.name} through NCCL in "
        f"{secs * 1e3:.1f} ms: {same} of {n} bitwise equal to dequantize(quantize(g + r))")
    require(same == n, f"compressed_psum: {n - same} leaves differ")
    return {"leaves": n, "ms": secs * 1e3}


def mesh_dryrun() -> dict:
    """Phase 9h: the dry run of DRYRUN_CELLS on the (16, 16) mesh in its own
    process (its ``fake`` group cannot share this one with NCCL), then in
    the same process DRYRUN_TP_CELLS under ``REPRO_SERVE_TP_WEIGHTS=1``
    (tagged ``tp``), then ``table_roofline`` on all their cells; each
    switched cell's terms logged beside its default layout's."""
    import tempfile

    from repro_torch.launch import study

    with tempfile.TemporaryDirectory() as tmp:
        cells = os.path.join(tmp, "cells")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        env.pop("REPRO_SERVE_TP_WEIGHTS", None)
        # one process for every cell: the CLI once a cell, its exit codes summed
        cli = ("dryrun.main(['--arch', a, '--shape', s, '--mesh', 'single', "
               f"'--out', {cells!r}] + tag) for a, s in ")
        code = ("import os, sys\nfrom repro_torch.launch import dryrun\ntag = []\n"
                f"rc = sum({cli}{DRYRUN_CELLS!r})\n"
                "os.environ['REPRO_SERVE_TP_WEIGHTS'] = '1'\ntag = ['--tag', 'tp']\n"
                f"sys.exit(rc + sum({cli}{DRYRUN_TP_CELLS!r}))\n")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                              text=True, timeout=600, cwd=tmp)
        secs = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            if line.startswith("["):
                log(f"[mesh dryrun] {line}")
        require(proc.returncode == 0, f"dry run of {DRYRUN_CELLS} and {DRYRUN_TP_CELLS} "
                f"failed: {proc.stdout[-2000:]} {proc.stderr[-4000:]}")
        rows = study.table_roofline(src=cells, out=os.path.join(tmp, "bench"))
    require(len(rows) == len(DRYRUN_CELLS) + len(DRYRUN_TP_CELLS),
            f"table_roofline gave {len(rows)} rows")
    by_layout = {(r["arch"], r["shape"], r["tp_weights"]): r for r in rows}
    for arch, shape in DRYRUN_TP_CELLS:
        tp, default = by_layout.get((arch, shape, True)), by_layout.get((arch, shape, False))
        require(tp is not None and default is not None,
                f"{arch} {shape}: a layout's row is missing")
        log(f"[mesh dryrun] {arch} {shape} (16, 16): " + "; ".join(
            f"{name} compute {r['compute_ms']:.4g} ms, memory {r['memory_ms']:.4g} ms, "
            f"collective {r['collective_ms']:.4g} ms, dominant {r['dominant']}, state "
            f"{r['state_gib_per_chip']:.4g} GiB/chip" for name, r in (("default", default),
                                                                     ("tp_weights", tp))))
    log(json.dumps({"table_roofline": rows}))
    return {"wall_s": secs, "rows": rows}


def phase_mesh(dev, unmeshed: dict) -> dict:
    """Phase 9: the meshed programs on a (1, 1) ("data", "model") mesh of
    one NCCL rank (a ``file://`` store under a temporary directory), each
    path's launch counts set to 0 just before it and read just after;
    ``unmeshed`` holds phases 5a, 5f and 5g's records by arch.  The group
    is destroyed before the report."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.frontends import make_extras

    t0 = time.perf_counter()
    seamless = dataclasses.replace(get_config(SEAMLESS), frontend_frames=SERVE_PROMPT)
    seamless_train = dataclasses.replace(seamless, frontend_frames=SEAMLESS_TRAIN_SEQ)
    frames = make_extras(torch.Generator(device=dev).manual_seed(SEED + 11), seamless_train,
                         MESH_TRAIN_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}",
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_host_mesh(1, 1, device_type="cuda")
            out = {"serving": mesh_serving(dev, mesh, get_config("qwen3-8b"),
                                           unmeshed["qwen3-8b"], "[mesh qwen3-8b]"),
                   "serving_tp": mesh_serving(dev, mesh, get_config("qwen3-8b"),
                                              unmeshed["qwen3-8b"], "[mesh qwen3-8b tp]",
                                              tp_weights=True),
                   "training": mesh_training(dev, mesh, get_config(TRAIN_ARCH), TRAIN_SEQ,
                                             "[mesh training qwen3-1.7b]"),
                   "long_decode": mesh_long_decode(dev, mesh),
                   "vision_serving": mesh_serving(dev, mesh, get_config(VISION),
                                                  unmeshed[VISION], f"[mesh {VISION}]",
                                                  setup=vision_gates),
                   "seamless_serving": mesh_serving(dev, mesh, seamless, unmeshed[SEAMLESS],
                                                    f"[mesh {SEAMLESS}]"),
                   "seamless_training": mesh_training(dev, mesh, seamless_train,
                                                      SEAMLESS_TRAIN_SEQ,
                                                      f"[mesh training {SEAMLESS}]", frames),
                   "checkpoint": mesh_checkpoint(dev, mesh),
                   "compress": mesh_compress(dev, mesh)}
        finally:
            dist.destroy_process_group()
    del frames
    torch.cuda.empty_cache()
    out["dryrun"] = mesh_dryrun()
    log(f"[mesh] phase 9 in {time.perf_counter() - t0:.1f} s")
    return out


def tree_names(tree, prefix: str = "") -> list[str]:
    """Leaf names of a nested dict, in the sorted order ``tree_map`` walks."""
    names = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            names += tree_names(tree[key], f"{prefix}{key}/")
        else:
            names.append(prefix + key)
    return names


class RepeatedBatch:
    """A data source that gives ``data``'s batch of step 0 at every step.

    SyntheticLM's next token hashes the whole history before it, so a
    fresh batch a step holds nothing a model can learn in a few steps
    (the reference's docstring: the loss drops within hundreds): over
    fresh batches the loss only moves by their noise.  Taking the same
    batch again, the steps must lower its loss, which shows that the
    gradients and the update are right; the work of a step is the same."""

    def __init__(self, data):
        self.data = data

    def batch(self, step: int) -> dict:
        return self.data.batch(0)


def phase_training(dev) -> dict:
    """Phase 6: Qwen3-1.7B at full width and depth trained through
    ``repro_torch.launch.train``, the launch counts around the run; then
    the gradient check of a cut copy against the CPU in float32."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train

    cfg = get_config(TRAIN_ARCH)
    require(cfg.remat == "full", f"{cfg.name} trains with remat={cfg.remat!r}, not 'full'")
    tag = f"[training {cfg.name}]"
    plan = train.default_plan(cfg, device=dev, accum_steps=TRAIN_ACCUM, warmup_steps=TRAIN_LR_WARMUP,
                              total_steps=TRAIN_STEPS)
    data = RepeatedBatch(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                                global_batch=TRAIN_BATCH, seed=0)))
    trainer = train.Trainer(plan, data)
    log(f"{tag} {cfg.n_layers} layers, {cfg.param_count() / 1e9:.4g} B parameters, remat "
        f"{cfg.remat}; {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step as {TRAIN_ACCUM} "
        f"micro-batches; {plan.opt_cfg.moment_dtype} moments")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    params, state, history = trainer.run(TRAIN_STEPS, seed=0, log_every=1,
                                         log=lambda m: log(f"{tag} {m}"))
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    records = trainer.records
    log(f"{tag} losses {[round(r['loss'], 4) for r in records]}")
    log(f"{tag} gradient norms {[round(r['grad_norm'], 4) for r in records]}")
    log(f"{tag} launches: {counts}")
    require(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records),
            "a loss or gradient norm is not finite")
    require(history[-1] < history[0], f"last loss {history[-1]!r} not below first {history[0]!r}")
    per_step = {"flash_fwd": 2 * cfg.n_layers * TRAIN_ACCUM,
                "flash_dkv": cfg.n_layers * TRAIN_ACCUM, "flash_dq": cfg.n_layers * TRAIN_ACCUM}
    for name, n in per_step.items():
        require(counts[name] == n * TRAIN_STEPS,
                f"{name} launched {counts[name]} times in {TRAIN_STEPS} steps, not {n} a step")
    step_s = [r["seconds"] for r in records[1:]]
    mean_s = sum(step_s) / len(step_s)
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / mean_s
    log(f"{tag} step wall time (steps 1-{TRAIN_STEPS - 1}, host clock, synchronised): mean "
        f"{mean_s * 1e3:.1f} ms, min {min(step_s) * 1e3:.1f}, max {max(step_s) * 1e3:.1f}; "
        f"warm-up step {records[0]['seconds'] * 1e3:.1f} ms; {tokens_per_s:.1f} tokens/s; peak "
        f"allocated {peak / 1e9:.4g} GB; straggler events {trainer.straggler_events}")
    batch = train.batch_to_device(data.batch(TRAIN_STEPS), dev)
    dev_ms = profiled_device_ms(lambda: trainer.step_fn(params, state, batch), top=12,
                                tag=f"{tag} profiled step:")
    log(f"{tag} one step under torch.profiler: device busy {dev_ms!r} ms of {mean_s * 1e3:.1f} "
        f"ms wall, share {dev_ms and dev_ms / (mean_s * 1e3)!r} (kernel and copy time)")
    del params, state, trainer, batch
    torch.cuda.empty_cache()
    grad_check(dev, cfg)
    return {"launches": counts, "step_ms": mean_s * 1e3, "tokens_per_s": tokens_per_s,
            "peak_gb": peak / 1e9, "busy_ms": dev_ms}


def grad_check(dev, cfg) -> None:
    """The loss and gradients of a GRAD_CHECK_LAYERS-layer copy of ``cfg``
    at full width on one batch: bf16 on the card through the kernels
    against float32 on the CPU through the plain path."""
    import dataclasses

    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.models.init import tree_leaves, tree_map

    small = dataclasses.replace(cfg, n_layers=GRAD_CHECK_LAYERS)
    f32 = dataclasses.replace(small, param_dtype="float32", compute_dtype="float32")
    tag = f"[gradient check {cfg.name}, {small.n_layers} layers, 1 x {GRAD_CHECK_TOKENS}]"
    params = T.init_params(small, torch.Generator(device=dev).manual_seed(SEED), dev)
    host = SyntheticLM(DataConfig(vocab_size=small.vocab_size, seq_len=GRAD_CHECK_TOKENS,
                                  global_batch=1, seed=0)).batch(0)
    loss, _, grads = train.loss_and_grads(params, train.batch_to_device(host, dev), small)
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    loss_c, _, grads_c = train.loss_and_grads(tree_map(lambda t: t.float().to(cpu), params),
                                              train.batch_to_device(host, cpu), f32)
    log(f"{tag} the float32 CPU step took {time.perf_counter() - t0:.1f} s")
    rel = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    log(f"{tag} loss card {float(loss)!r}, CPU {float(loss_c)!r}: rel err {rel:.3e}")
    require(rel <= TRAIN_LOSS_REL, f"gradient check: loss rel err {rel:.3e} > {TRAIN_LOSS_REL}")
    worst = 0.0
    for name, g, w in zip(tree_names(params), tree_leaves(grads), tree_leaves(grads_c)):
        require(bool(torch.isfinite(g.float()).all()), f"gradient check: {name} not finite")
        err = rel_l2(g.float().cpu(), w)
        worst = max(worst, err)
        log(f"{tag} d{name} ({g.dtype}, {tuple(g.shape)}): rel L2 {err:.3e}")
        require(err <= TRAIN_GRAD_REL_L2,
                f"gradient check: d{name} rel L2 {err:.3e} > {TRAIN_GRAD_REL_L2}")
    log(f"{tag} worst leaf {worst:.3e}, bar {TRAIN_GRAD_REL_L2}")
    del params, grads
    torch.cuda.empty_cache()


def time_flash_bwd(dev, report, shape, phase1=True) -> dict:
    """``flash_dkv`` and ``flash_dq`` timed and held against their plain
    versions at ``shape`` (B, Hq, Hkv, S, D, causal, window); SDPA's
    backward (forward and backward minus forward) beside them; their
    bounds.  Returns ``{kernel: row}``; the first shape timed (one Qwen3-1.7B
    layer's attention backward in training) fills the kernels' report."""
    import torch
    import torch.nn.functional as F

    b, hq, hkv, s_, d, causal, _ = shape
    q, k, v = flash_inputs(dev, b, hq, hkv, s_, s_, d, seed=2)
    t = check_flash_bwd(dev, report, shape, time_it=True, qkv=(q, k, v), phase1=phase1)
    gen = torch.Generator(device=dev).manual_seed(1)
    do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    qs, ks, vs = (x.detach().requires_grad_(True) for x in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), do)

    for fn in (sdpa_fwd, sdpa_fwd_bwd):
        cuda_ms(fn, 2)  # warm up
    fwd_ms, _ = cuda_ms(sdpa_fwd, 10)
    fwd_bwd_ms, _ = cuda_ms(sdpa_fwd_bwd, 10)
    library_ms = fwd_bwd_ms - fwd_ms
    pairs = attention_pairs(b, hq, s_, s_, causal)
    row_bytes = 2 * b * hq * s_ * 4  # LSE and delta, float32
    in_bytes = tensor_bytes((q, k, v, do)) + row_bytes
    rows = {}
    for name, ops, out_bytes in (("flash_dkv", 8.0 * d * pairs, 2 * k.numel() * 4),
                                 ("flash_dq", 6.0 * d * pairs, q.numel() * 4)):
        key = "dkv" if name == "flash_dkv" else "dq"
        b_ms, b_by = bound_ms(ops, in_bytes, out_bytes, peak=BF16_FLOPS)
        rows[name] = dict(shape=str(shape), ms=t[f"{key}_ms"], plain_ms=t[f"{key}_plain_ms"],
                          bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
        log(f"[timing] {name} (B, Hq, Hkv, S, D, causal, window)={shape}: "
            f"{t[f'{key}_ms']:.3f} ms, median of 10 runs, plain "
            f"{t[f'{key}_plain_ms']:.1f} ms; bound "
            f"{b_ms:.4f} ms ({b_by}, {ops:.4g} bf16 tensor ops, "
            f"{(in_bytes + out_bytes) / 1e6:.1f} MB): {b_ms / t[f'{key}_ms']:.2%} of it")
    log(f"[timing] scaled_dot_product_attention at {shape}: forward {fwd_ms:.3f} ms, forward "
        f"and backward {fwd_bwd_ms:.3f} ms, so the backward {library_ms:.3f} ms against "
        f"flash_dkv + flash_dq {t['dkv_ms'] + t['dq_ms']:.3f} ms")
    del q, k, v, qs, ks, vs, do
    torch.cuda.empty_cache()
    return rows


def phase_timing(dev, workloads, outcomes_path, large_group, moe_shapes, report) -> None:
    """Phase 7: each kernel and its plain version at the largest shapes of
    phases 3-6, the kernel's last timed result held against the plain
    one; then the bound, and the library yardsticks.  ``moe_shapes`` maps
    each MoE model to the ``moe_ffn_fwd`` shapes its serving phase
    launched."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import policies
    from repro_torch.kernels.sojourn_eval import dynamic as D
    from repro_torch.kernels.sojourn_eval import kernel as K

    j21, (outcomes, weights) = outcomes_path["jobs"], outcomes_path["table"]
    j26, j27 = workloads[26], workloads[27]
    s = 1 << 23
    rank26, rank27 = policies.rank_order(j26)[None], policies.rank_order(j27)[None]
    cases = [
        ("sojourn_enum", "N=26 M=2 K=2^26 P=1 (RANK)", K.sojourn_enum, K.sojourn_enum_torch,
         static_args(j26, rank26, dev), 3, static_flops(j26, rank26, 1 << 26, mc=False), 0.0),
        ("sojourn_mc", "N=27 M=2 S=2^23 P=1 (RANK)", K.sojourn_mc, K.sojourn_mc_torch,
         static_args(j27, rank27, dev, (SEED, s)), 3, static_flops(j27, rank27, s, mc=True),
         threefry_alu_ops(27, s)),
        # one run: the K=2^26 dynamic enumeration is the slowest kernel call
        ("dynamic_sojourn_enum", "N=26 M=2 K=2^26 P=1 (SR) W=1", D.dynamic_sojourn_enum,
         D.dynamic_sojourn_enum_torch,
         dynamic_args(j26, [policies.index_table(j26, "sr")], dev), 1,
         dynamic_flops(j26, 1, 1 << 26, mc=False), 0.0),
        ("dynamic_sojourn_mc", "N=27 M=2 S=2^23 P=1 (SR) W=1", D.dynamic_sojourn_mc,
         D.dynamic_sojourn_mc_torch,
         dynamic_args(j27, [policies.index_table(j27, "sr")], dev, (SEED, s)), 3,
         dynamic_flops(j27, 1, s, mc=True), threefry_alu_ops(27, s)),
        ("sojourn_outcomes", "N=21 M=2 K=2^21 enumerated table, P=1 (RANK)",
         K.sojourn_outcomes, K.sojourn_outcomes_torch,
         outcomes_args(j21, policies.rank_order(j21)[None], outcomes, weights, dev), 10,
         outcomes_flops(outcomes, policies.padded_arrays(j21)[2], 1), 0.0),
    ]
    for name, shape, fn, plain, args, reps, flops, alu in cases:
        ms, got = cuda_ms(lambda: fn(*args), reps)
        plain_ms, want = cuda_ms(lambda: plain(*args), 1)
        check_against_plain(report, name, shape, got, want)
        if name in ("sojourn_enum", "sojourn_mc", "sojourn_outcomes"):
            again = fn(*args)
            require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
                    f"{name} {shape}: a second call differs from the first")
        terms = bound_terms(flops, tensor_bytes(args), 2 * 8, alu_ops=alu)
        b_ms, b_by = bound_ms(flops, tensor_bytes(args), 2 * 8, alu_ops=alu)
        report[name].update(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=contract_by(b_by), bound_term=b_by, bound_terms_ms=terms,
                            reps=reps)
        log(f"[timing] {name} {shape}: {ms:.4f} ms, median of {reps} run(s), plain "
            f"{plain_ms:.1f} ms; bound {b_ms:.4f} ms ({b_by}; terms "
            + ", ".join(f"{k} {v:.4f}" for k, v in terms.items())
            + f" ms; {flops:.4g} float64 ops, {alu:.4g} ALU-only integer ops at "
            f"{max_sm_clock_hz() / 1e6:.0f} MHz): {b_ms / ms:.2%} of it")
    old_flops = static_flops_full_decode(j26, 1, 1 << 26)
    old_ms, _ = bound_ms(old_flops, tensor_bytes(cases[0][4]), 2 * 8)
    r = report["sojourn_enum"]
    r.update(bound_ms_full_decode=old_ms)
    log(f"[timing] sojourn_enum N=26: the full-decode bound {old_ms:.4f} ms ({old_flops:.4g} "
        f"float64 ops) beside the shared-prefix one {r['bound_ms']:.4f} ms")

    # both Monte-Carlo kernels at phase 3b's group: N=80, S=2^20, RANK and SR
    jobs = large_group["jobs"]
    alu = threefry_alu_ops(LARGE_GROUP, LARGE_GROUP_SAMPLES)
    rank = policies.rank_order(jobs)[None]
    for name, shape, fn, args, flops in (
            ("sojourn_mc", f"N={LARGE_GROUP} M=2 S=2^20 P=1 (RANK)", K.sojourn_mc,
             static_args(jobs, rank, dev, (SEED, LARGE_GROUP_SAMPLES)),
             static_flops(jobs, rank, LARGE_GROUP_SAMPLES, mc=True)),
            ("dynamic_sojourn_mc", f"N={LARGE_GROUP} M=2 S=2^20 P=1 (SR) W=1",
             D.dynamic_sojourn_mc,
             dynamic_args(jobs, [policies.index_table(jobs, "sr")], dev,
                          (SEED, LARGE_GROUP_SAMPLES)),
             dynamic_flops(jobs, 1, LARGE_GROUP_SAMPLES, mc=True))):
        ms, _ = cuda_ms(lambda: fn(*args), 3)
        terms = bound_terms(flops, tensor_bytes(args), 2 * 8, alu_ops=alu)
        b_ms, b_by = bound_ms(flops, tensor_bytes(args), 2 * 8, alu_ops=alu)
        report[name].update(large_group_shape=shape, large_group_ms=ms,
                            large_group_bound_ms=b_ms, large_group_bound_terms_ms=terms)
        log(f"[timing] {name} {shape}: {ms:.4f} ms, median of 3 runs; bound {b_ms:.4f} ms "
            f"({b_by}; terms " + ", ".join(f"{k} {v:.4f}" for k, v in terms.items())
            + f" ms): {b_ms / ms:.2%} of it")

    # sojourn_outcomes at phase 4's N=27 call: one launch for RANK and 16 RANDOM
    # orders over the 2^21 sampled rows
    j27s, (outcomes27, weights27), orders27 = (outcomes_path["j27"], outcomes_path["table27"],
                                               outcomes_path["orders27"])
    args = outcomes_args(j27s, orders27, outcomes27, weights27, dev)
    shape = f"N=27 M=2 K=2^21 sampled table, P={len(orders27)} (phase 4)"
    before = K.launches["sojourn_outcomes"]
    ms, got = cuda_ms(lambda: K.sojourn_outcomes(*args), 10)
    launches = (K.launches["sojourn_outcomes"] - before) // 10
    plain_ms, want = cuda_ms(lambda: K.sojourn_outcomes_torch(*args), 1)
    check_against_plain(report, "sojourn_outcomes", shape, got, want)
    flops = outcomes_flops(outcomes27, policies.padded_arrays(j27s)[2], len(orders27))
    terms = bound_terms(flops, tensor_bytes(args), 2 * 8 * len(orders27))
    b_ms, b_by = bound_ms(flops, tensor_bytes(args), 2 * 8 * len(orders27))
    report["sojourn_outcomes"].setdefault("more_shapes", []).append(
        dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=contract_by(b_by),
             bound_terms_ms=terms, launches_a_call=launches, reps=10))
    log(f"[timing] sojourn_outcomes {shape}: {ms:.4f} ms, median of 10 runs, {launches} "
        f"launch(es) a call, plain {plain_ms:.1f} ms; bound {b_ms:.4f} ms ({b_by}; terms "
        + ", ".join(f"{k} {v:.4f}" for k, v in terms.items()) + f" ms): {b_ms / ms:.2%} of it")

    # flash_fwd at the serving shape (one Qwen3-8B layer's prefill attention,
    # the row's shape), the training shape (one Qwen3-1.7B micro-batch) and
    # Kimi-K2's prefill (head dim 112), each beside SDPA
    more = []
    for shape in ((SERVE_BATCH, 32, 8, SERVE_PROMPT, SERVE_PROMPT, 128, True, None),
                  (TRAIN_BATCH // TRAIN_ACCUM, 16, 8, TRAIN_SEQ, TRAIN_SEQ, 128, True, None),
                  (SERVE_BATCH, 64, 8, SERVE_PROMPT, SERVE_PROMPT, 112, True, None)):
        b, hq, hkv, sq, skv, d, causal, _ = shape
        q, k, v = flash_inputs(dev, b, hq, hkv, sq, skv, d, seed=1)
        t = check_flash(dev, report, shape, time_it=True, qkv=(q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,  # noqa: E731
                                                      enable_gqa=True)
        cuda_ms(sdpa, 2)  # warm up
        library_ms, _ = cuda_ms(sdpa, 10)
        flops = flash_flops(b, hq, sq, skv, d, causal)
        io_bytes = tensor_bytes((q, k, v)) + q.numel() * q.element_size() + b * hq * sq * 4
        b_ms, b_by = bound_ms(flops, io_bytes, 0, peak=BF16_FLOPS)
        row = dict(shape=str(shape), ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=b_ms,
                   bound_by=b_by, library_ms=library_ms)
        if not more:
            report["flash_fwd"].update(reps=10, **row)
        more.append(row)
        log(f"[timing] flash_fwd {shape}: {t['ms']:.3f} ms, median of 10 runs, plain "
            f"{t['plain_ms']:.1f} ms, scaled_dot_product_attention {library_ms:.3f} ms; bound "
            f"{b_ms:.4f} ms ({b_by}, {flops:.4g} bf16 tensor ops, {io_bytes / 1e6:.1f} MB): "
            f"{b_ms / t['ms']:.2%} of it")
        del q, k, v
        torch.cuda.empty_cache()
    report["flash_fwd"]["more_shapes"] = more[1:]

    # flash_dkv and flash_dq at the training shape (one Qwen3-1.7B micro-batch's
    # layer), at head dim 112 (Kimi-K2's, 64 query heads) and at head dim 64
    more = {"flash_dkv": [], "flash_dq": []}
    for shape in ((TRAIN_BATCH // TRAIN_ACCUM, 16, 8, TRAIN_SEQ, 128, True, None),
                  (1, 64, 8, SERVE_PROMPT, 112, True, None),
                  (TRAIN_BATCH // TRAIN_ACCUM, 16, 8, TRAIN_SEQ, 64, True, None)):
        for name, row in time_flash_bwd(dev, report, shape).items():
            more[name].append(row)
    for name, rows in more.items():
        report[name].update(reps=10, library="scaled_dot_product_attention backward (forward "
                            "and backward minus forward): dQ, dK and dV in one call",
                            **rows[0])
        report[name]["more_shapes"] = rows[1:]

    # ssd_fwd at the Mamba2-1.3B prefill shape: one layer's scan
    shape = (SERVE_BATCH, 64, 1, SERVE_PROMPT, 128, 64, 256)
    t = check_ssd(dev, report, shape, time_it=True)
    work = ssd_work(*shape)
    b_ms, b_by = ssd_bound(work)
    old_ms, old_by = ssd_bound_cuda_cores(work)
    report["ssd_fwd"].update(shape=str(shape), ms=t["ms"], plain_ms=t["plain_ms"],
                             bound_ms=b_ms, bound_by=b_by, reps=10, library_ms=None,
                             bound_ms_cuda_cores=old_ms)
    log(f"[timing] ssd_fwd (B, H, G, S, N, P, chunk)={shape}: {t['ms']:.3f} ms, median of 10 runs, "
        f"plain {t['plain_ms']:.1f} ms; bound {b_ms:.4f} ms ({b_by}: {work['bf16']:.4g} bf16 "
        f"and {work['tf32']:.4g} TF32-rate tensor ops, {work['f32']:.4g} f32 ops, "
        f"{work['bytes'] / 1e6:.1f} MB): {b_ms / t['ms']:.2%} of it; with the three float32 "
        f"products on the CUDA cores {old_ms:.4f} ms ({old_by})")

    # moe_ffn_fwd at the serving shapes of phases 5c and 5d
    for i, (name, shapes) in enumerate(moe_shapes.items()):
        time_moe(dev, report, name, shapes, first=i == 0)


def moe_serving_shapes(name: str) -> tuple[tuple, tuple]:
    """(prefill, decode) shapes (E, R, Dm, Dff) of ``moe_ffn_fwd`` in the
    serving phase of ``name``: the dispatch groups of SERVE_BATCH x
    SERVE_PROMPT tokens folded into each expert's rows, then a decode
    step's SERVE_BATCH tokens, with ``models.moe.capacity``'s caps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe

    cfg = get_config(name)
    out = []
    for tokens in (SERVE_BATCH * SERVE_PROMPT, SERVE_BATCH):
        g, cap = moe.capacity(cfg, tokens)
        out.append((cfg.n_experts, tokens // g * cap, cfg.d_model, cfg.d_ff))
    return tuple(out)


def time_moe(dev, report, name, shapes, first) -> None:
    """Phase 7 for ``moe_ffn_fwd`` at one MoE model's prefill and decode
    shapes, each held against the shapes its serving phase launched
    (``shapes``): the kernel's median time, the plain version's, the bound,
    and the three-``torch.bmm`` composition beside the prefill.  The first
    model's prefill is the kernel's row; every shape goes to ``more_shapes``."""
    import torch

    from repro_torch.kernels.moe_gemm.ref import moe_ffn_ref

    prefill, decode = moe_serving_shapes(name)
    require(prefill in shapes and decode in shapes,
            f"{name}: moe_ffn_fwd shapes {sorted(shapes)} lack {prefill} or {decode}")
    r = report["moe_ffn_fwd"]
    args = moe_inputs(dev, *prefill, seed=2)
    for kind, shape in (("prefill", prefill), ("decode", decode)):
        e, rows, dm, dff = shape
        if kind == "decode":
            args = (args[0][:, :rows].contiguous(), *args[1:])
        reps = 3 if kind == "prefill" else 10
        t = check_moe(dev, report, shape, time_it=True, reps=reps, args=args)
        library_ms = None
        if kind == "prefill":
            cuda_ms(lambda: moe_ffn_ref(*args), 1)  # warm up
            library_ms, _ = cuda_ms(lambda: moe_ffn_ref(*args), 3)
        flops = 6.0 * e * rows * dm * dff
        b_ms, b_by = bound_ms(flops, tensor_bytes(args), e * rows * dm * 2, peak=BF16_FLOPS)
        row = dict(model=name, kind=kind, shape=str(shape), ms=t["ms"], plain_ms=t["plain_ms"],
                   bound_ms=b_ms, bound_by=b_by, reps=reps, library_ms=library_ms)
        r.setdefault("more_shapes", []).append(row)
        if first and kind == "prefill":
            r.update(shape=str(shape), ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=b_ms,
                     bound_by=b_by, reps=reps, library_ms=library_ms,
                     library="three torch.bmm (moe_ffn_ref), a yardstick, not a port")
        if first and kind == "decode":
            r.update(decode_shape=str(shape), decode_ms=t["ms"], decode_bound_ms=b_ms,
                     decode_bound_by=b_by)
        yard = f", three torch.bmm {library_ms:.3f} ms" if library_ms is not None else ""
        log(f"[timing] moe_ffn_fwd {name} {kind} (E, R, Dm, Dff)={shape}: {t['ms']:.3f} ms, "
            f"median of {reps} runs, plain {t['plain_ms']:.1f} ms{yard}; bound {b_ms:.4f} ms "
            f"({b_by}, {flops:.4g} bf16 tensor ops, {tensor_bytes(args) / 1e9:.3f} GB in): "
            f"{b_ms / t['ms']:.2%} of it")
    del args
    torch.cuda.empty_cache()


def device_kernels(fn) -> list:
    """``torch.profiler``'s averages of the kernels and copies on the card
    during one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def profiled_device_ms(fn, top: int = 0, tag: str = "") -> float | None:
    """Milliseconds of kernels and copies on the card during one call of
    ``fn``, from ``torch.profiler``; None when the trace holds no device
    time.  With ``top``, logs the ``top`` kernels by device time."""
    kernels = device_kernels(fn)
    us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:top]:
        t = e.self_device_time_total
        log(f"{tag} {t / 1e3:9.2f} ms ({t / us:6.2%}) x{e.count:<5d} {e.key[:100]}")
    return us / 1e3 or None


def profiled_kernel_ms(fn, key: str) -> tuple[float | None, int, float | None]:
    """(milliseconds of the kernels whose name holds ``key``, their
    launches, milliseconds of every kernel and copy) on the card during one
    call of ``fn``, from ``torch.profiler``; the times are None when the
    trace holds no device time."""
    kernels = device_kernels(fn)
    hits = [e for e in kernels if key in e.key]
    total = sum(e.self_device_time_total for e in kernels)
    if not total:
        return None, sum(e.count for e in hits), None
    return (sum(e.self_device_time_total for e in hits) / 1e3, sum(e.count for e in hits),
            total / 1e3)


def check_shares(kernels: list[dict]) -> None:
    """Raise if a bound exceeds the time it bounds, at any shape of the
    report: a share of the bound over 100% means that the bound counts work
    that no kernel has to do."""
    faults = []
    for k in kernels:
        pairs = [("", k["bound_ms"], k["ms"])]
        pairs += [(f" {row['shape']}", row["bound_ms"], row["ms"])
                  for row in k.get("more_shapes", []) + k.get("regimes", []) +
                  k.get("head_dims", [])]
        for prefix in ("decode", "large_group"):
            if f"{prefix}_ms" in k:
                pairs.append((f" {prefix}", k[f"{prefix}_bound_ms"], k[f"{prefix}_ms"]))
        faults += [f"{k['name']}{where}: bound {b:.4f} ms, measured {ms:.4f} ms"
                   for where, b, ms in pairs if b > ms]
    require(not faults, "a share of the bound reads over 100%: " + "; ".join(faults))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.device import resolve_device

    dev = resolve_device()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    report: dict[str, dict] = {}
    phase_build()
    phase_kernels(dev, report)
    phase_worked_example()
    main_path = phase_main_path()
    large_group = phase_large_group()
    phase_cross_check(main_path["workloads"][26])
    outcomes_path = phase_outcomes_path()
    study = phase_study()
    serving = phase_serving(dev)
    mamba = phase_serving_mamba(dev)
    mixtral = phase_serving_mixtral(dev)
    kimi = phase_serving_kimi(dev)
    jamba = phase_serving_jamba(dev)
    vision = phase_serving_vision(dev)
    seamless = phase_serving_seamless(dev)
    training = phase_training(dev)
    phase_timing(dev, main_path["workloads"], outcomes_path, large_group,
                 {"mixtral-8x22b": mixtral["moe_shapes"], "kimi-k2-1t-a32b": kimi["moe_shapes"]},
                 report)
    examples = phase_examples()
    meshed = phase_mesh(dev, {"qwen3-8b": serving["unmeshed"], VISION: vision.pop("unmeshed"),
                              SEAMLESS: seamless.pop("unmeshed")})
    smi = nvidia_smi()
    runs = {"qwen3-8b": serving, "mamba2-1.3b": mamba, "mixtral-8x22b": mixtral,
            "kimi-k2-1t-a32b": kimi, JAMBA: jamba, VISION: vision, SEAMLESS: seamless,
            "qwen3-1.7b training": training,
            "train_early_termination example": examples["train"],
            "cluster_schedule example": examples["cluster"],
            **{name: run for name, run in examples.items() if name.startswith("serve_smoke")},
            "qwen3-8b meshed": meshed["serving"],
            "qwen3-8b meshed tp_weights": meshed["serving_tp"],
            "qwen3-1.7b meshed training": meshed["training"]["meshed"],
            "jamba long_500k sp decode": meshed["long_decode"],
            "jamba long_500k unmeshed decode": {
                "launches": meshed["long_decode"]["plain_launches"]},
            "vision mesh serve": meshed["vision_serving"],
            "seamless mesh serve": meshed["seamless_serving"],
            "seamless mesh train": meshed["seamless_training"]["meshed"],
            "qwen3-1.7b mesh resumed training": meshed["checkpoint"]}

    def by_path(name):
        return {path: run["launches"][name] for path, run in runs.items()
                if run["launches"].get(name)}

    report["flash_fwd"]["launches_by_path"] = by_path("flash_fwd")
    report["moe_ffn_fwd"]["launches_by_path"] = by_path("moe_ffn_fwd")
    report["ssd_fwd"]["launches_by_path"] = by_path("ssd_fwd")
    for name in ("flash_dkv", "flash_dq"):
        report[name]["launches_by_path"] = by_path(name)
    report["moe_ffn_fwd"]["dropped_share"] = {"mixtral-8x22b": mixtral["dropped_share"],
                                              "kimi-k2-1t-a32b": kimi["dropped_share"],
                                              JAMBA: jamba["dropped_share"]}
    report["sojourn_enum"]["optimal_cell"] = main_path["optimal_cell"]
    tables = study["eval_tables"]["launches"]
    sojourn_by_path = {name: main_path["launches"][name] + large_group["launches"][name]
                       for name in ("sojourn_enum", "sojourn_mc", "dynamic_sojourn_enum",
                                    "dynamic_sojourn_mc")}
    for name in ("sojourn_enum", "dynamic_sojourn_enum"):
        report[name]["launches_by_path"] = {"main path": sojourn_by_path[name],
                                            "numerical study": study["launches"][name],
                                            "table_eval_*": tables[name]}
        sojourn_by_path[name] += study["launches"][name] + tables[name]
    sojourn_by_path["sojourn_mc"] += tables["sojourn_mc"]
    launches = {**sojourn_by_path, "sojourn_outcomes":
                outcomes_path["launches"]["sojourn_outcomes"] + tables["sojourn_outcomes"],
                **{name: sum(report[name]["launches_by_path"].values())
                   for name in ("flash_fwd", "flash_dkv", "flash_dq", "ssd_fwd", "moe_ffn_fwd")}}
    kernels = []
    for name in REPLACES:
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "shape": r["shape"],
            **{key: r[key] for key in ("max_rel_err", "max_lse_err", "max_rel_l2",
                                       "max_state_rel_l2", "library", "launches_by_path",
                                       "dropped_share", "decode_shape", "decode_ms",
                                       "decode_bound_ms", "decode_bound_by", "more_shapes",
                                       "large_group_shape", "large_group_ms",
                                       "large_group_bound_ms", "large_group_bound_terms_ms",
                                       "bound_term", "bound_terms_ms", "bound_ms_full_decode",
                                       "bound_ms_cuda_cores", "optimal_shape",
                                       "optimal_shape_ms", "optimal_cell", "regimes",
                                       "head_dims")
               if key in r},
            "phase1_shape": r["phase1_shape"], "phase1_ms": r["phase1_ms"],
            "phase1_plain_ms": r["phase1_plain_ms"],
        })
    check_shares(kernels)
    log(json.dumps({"numerical_study": {key: study[key] for key in (
        "by_n", "max_rel_err", "n8_device_ms", "n8_profiled_wall_s", "n8_busy_share",
        "des_max_rel_err", "trace", "eval_tables")}}))
    log(json.dumps({"families": {name: {k: v for k, v in run.items() if k != "moe_shapes"}
                                 for name, run in ((JAMBA, jamba), (VISION, vision),
                                                   (SEAMLESS, seamless))},
                    "examples": examples}))
    log(json.dumps({"mesh": {k: v for k, v in meshed.items() if k != "dryrun"},
                    "dryrun_wall_s": meshed["dryrun"]["wall_s"]}, default=str))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
