#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository; it needs one CUDA card and nvcc
(``/usr/local/cuda``) and builds every kernel from the sources in
``src/repro_torch``.  Phases, each printing its own lines:

1. device    -- the card's name and power limit (nvidia-smi), torch versions;
2. build     -- nvcc for each CUDA source (all started together), Triton
                JIT of the cross-entropy, build seconds, ptxas register and
                spill lines (RMSNorm's instantiations a line per kernel,
                dtype and layout); each bf16
                tensor-core kernel's spill bytes (ptxas), its tensor-core
                instructions (HMMA/HGMMA in ``cuobjdump -sass``) and its
                asynchronous copies (LDGSTS, i.e. cp.async), failing on a
                spill or on a kernel without either instruction (the SSD
                backward's four bf16 product kernels among them; its float32
                CUDA-core kernels, and its bf16 state pass and sums, which
                hold no product, are built alongside, their registers and
                spills printed, and not held to that check);
3. kernels   -- each of the eight kernels (four forward, four backward)
                against its plain PyTorch version on the card at the
                serving and training shapes, with the stated tolerance;
                kernel, plain and library times (CUDA events) beside the
                card's bound; the flash and SSD kernels' TFLOP/s and share
                of the bound, the flash forward also at the train shape
                beside SDPA's forward, and two calls of the flash backward
                and of the bf16 SSD scan bit-equal; the SSD scan's CUDA
                kernels per call and each one's device time (a
                ``torch.profiler`` trace of ten calls) and the scratch one
                call allocates (``torch.cuda.max_memory_allocated``); the
                SSD scan's backward against autograd through the plain scan
                in bf16 and float32 (a partial chunk, an initial state and
                a d(final state)), timed at mamba2-370m's train shape (B4
                S4096 H32, kernels per call, scratch), two calls
                bit-equal, and checked again at jamba-1.5-large's width
                (H 256, B1 S4096); then
                every kernel of the mixtral paths checked again at
                mixtral-8x22b's widths, and every kernel of the whisper and
                llava paths at theirs (flash attention at the whisper
                encoder's and cross-attention's shapes and llava's prefill,
                the backward without the causal mask at Sq 448 x Sk 1500,
                RMSNorm at D 512 and 7168, the cross-entropy at V 51865
                and 64000; timed beside their bounds and library calls);
                RMSNorm also at mamba2-370m's widths (D 1024 and 2048:
                train rows both ways, decode rows) and whisper's decoder
                backward ([16, 448, 512]), every RMSNorm decode row with the
                host's time per call, an empty kernel of the same library
                timed the same two ways (the launch floor), the backward
                timed on input copies that exceed the L2 and its dx and
                dscale bit-equal across two calls; last, the flash forward
                and backward at head_dim 32 (``launch/train_lm.py``'s tiny
                preset: B4 S64 H4, causal), float32 and bf16, timed beside
                their bounds; then AdamW's three kernels at mixtral-8x22b's
                1-layer and mamba2-370m's leaf sets: the global norm
                against a float64 sum, the step against the plain loop (m
                and v bit-equal with the clip off, p within a step of bf16,
                four of float32; mamba2's set whole, mixtral's a leaf at a
                time), timed beside the plain loop,
                ``torch.optim.AdamW(fused=True)`` and the bound;
4. reference -- small float32 models served on the card (kernels) against
                the same models on the CPU (plain versions): equal greedy
                tokens, logits within 1e-3 (dense qwen2, mixtral with a
                capacity that drops tokens, Mamba-2 with the real SSD head
                sizes at a ragged prompt, the jamba hybrid without and with
                experts; the MoE models' dropped (token, choice) pairs
                equal on both; whisper with 100 frames against a 40-token
                prompt, llava with its prefix); the same eight float32
                smoke models (Mamba-2 and both jamba hybrids through the
                SSD backward kernel) trained three steps on the card and on
                the CPU from the same parameters (gradients, losses, ce and
                aux, launch counts); the train loop on the card, resumed
                from its checkpoint;
5. serve     -- through ``repro_torch.launch.serve``: qwen2-7b at full width
                (28 layers, bf16, batch 4, prompt 512, 32 tokens), then
                mamba2-370m at full width and depth (48 layers, bf16, batch
                4, prompt 2048, 32 tokens), then mixtral-8x22b at full width
                cut to 8 of its 56 layers (bf16, batch 4, prompt 512, 32
                tokens; the prefill's dropped pairs), then whisper-base at
                full width and depth (6 + 6 layers, batch 16, 1500 frames,
                prompt 224, 32 tokens), then llava-next-34b at full width
                cut to 40 of its 60 layers (batch 4, 2880 prefix rows and a
                128-token prompt, 32 tokens); each followed by a traced
                prefill and four decode steps
                (``profile_serve.profile_generate``);
6. train     -- through ``repro_torch.launch.train.setup``, AdamW, one
                warm-up step and three timed steps, then one traced step
                for the device's idle share: qwen2-7b at full width cut to
                8 of its 28 layers and mixtral-8x22b at full width cut to 1
                of its 56 (model FLOPs of the active parameters, k of E
                experts per token), both batch 2 x 4096 tokens; whisper-base
                at full width and depth, batch 16 x (1500 frames, 448
                tokens); llava-next-34b at full width cut to 4 of its 60
                layers, batch 2 x (2880 prefix rows + 1216 tokens);
                mamba2-370m at full width and depth (48 layers), batch 4 x
                4096 tokens (the SSD scan's backward kernel once per layer
                and step);
7. gradient  -- the card's HBM copy and bf16 matmul rates beside
                ``roofline/hw.py``'s data sheet; qwen2-7b at full width cut
                to 8 of its 28 layers, batch 2 x 4096, trained with
                ``--compress`` (int8 error feedback) through
                ``launch.train.setup``: a warm-up and three timed steps
                beside phase 6's plain step, the transform alone (CUDA
                events), peak memory, ``ef_residual_sq``, the plain step's
                launch counts; unit 0's gradients and residual, and a
                seeded mixed-dtype tree with all-zero leaves, compressed on
                the card and on the CPU, bit for bit; then the same model
                through ``launch.train_lm.make_dp_step`` at world size 1 on
                NCCL (a ``FileStore``), its buckets in
                ``plan_step_comm``'s order under the H100 defaults: the
                order read from the all-reduces issued (each call's
                buffer sampled and matched to a bucket, the element counts
                also read from a ``torch.profiler`` trace), the loss and
                parameters after one step bit-equal to the plain step's,
                then two timed steps;
8. engine    -- the lockstep fifo engine (``repro_torch.core.simtorch``) at
                the repo's batched-bench setup: each of the six registered
                scenarios at full size on its registered topology, and
                ``mixed`` on ``fat_tree``, seeds 0-19 as one batch on the
                card (cold and warm walls, host reads per run), held lane
                by lane to the same batch on the CPU (JCT/CCT and makespan
                within 1e-6, equal events); then every one of those cells,
                with msa, varys and fair cells and one chaos cell
                (intensity 1.0) on ``mixed``, through
                ``repro_torch.experiments.run_cells_batched`` on the card:
                the fifo records held to the port's own ``run_cell`` (the
                numpy simulator) within 1e-6 per job JCT and CCT, the
                others equal to it but for ``wall_s``; one warm
                ``pipe_serve`` batch traced (``torch.profiler``: idle
                share, kernels per step); then the sweep's ``--smoke``
                profile through ``repro_torch.launch.sweep``, its
                ``check()`` passed (MSA >= varys), its headline ratio and
                fingerprint printed, the fingerprint equal to the one the
                port and the reference give on a CPU host; then the paper's
                figures (``repro_torch.launch.figures``, each figure's
                ``run()`` and ``check()`` in this process after the sweep,
                numpy on the host): Figure 1, Figure 3b (50 jobs x 3
                DAG topologies x 2 regimes) and the framework-integration
                table (every arch) at full size, the ML-workload table
                and the decision-caching bench at --quick, every
                ``check()`` passed, Figure 1 at MSA 7.000 and Varys 8.000,
                the Figure 3b and table rows equal to the reference's
                (recorded on a CPU host); the frozen
                simulator (``core.simref``) equal to the live core (JCT,
                CCT, service order) for the five policies on the randomized
                50-job batch of the reference's equivalence test; and
                Figure 3b's 150 trace-regime jobs (seed 42) as lanes of one
                fifo lockstep batch on the card, each within 1e-6 of
                ``simulate_reference`` (wall and ms per step printed);
9. layouts   -- the per-card bytes of every architecture's train state
                under ``state_specs`` on the production mesh's shapes
                (data=32, model=8) and (pod=2, data=32, model=8); then
                qwen2-7b at full width cut to 8 of its 28 layers, batch 2 x
                4096, through ``launch.train.setup(..., mesh=...)`` on a
                (data=1, model=1) NCCL mesh (the FSDP x TP layout applied:
                the state built as DTensors from the seed, the kernels on
                the local shards): the loss and parameters after one step
                against the plain step's, bit for bit (or every differing
                leaf named and held within 2e-2), its kernel launches equal
                to the plain step's, then two timed steps beside phase 6's
                plain ms/step;
10. serve layouts -- qwen2-7b at full width and depth (28 layers, bf16,
                batch 4, prompt 512, 32 tokens) through
                ``launch.serve.generate`` on a (data=1, model=1) NCCL mesh:
                the parameters drawn from the seed a part at a time and
                laid out by ``param_specs`` (``init_params``), the caches
                in ``cache_specs``' placements, the kernels on the local
                shards; the greedy tokens equal to phase 5's, the last
                logits bit-equal to phase 5's (or every differing entry
                named and held within 2e-2), the kernel launches equal to
                phase 5's, prefill ms and decode ms/step beside phase 5's;
                then the same prefill and decode dry-run on a fake world of
                one rank (``launch.dryrun``), their H100 roofline bound
                beside the measured times;
11. the ``{"serve": ...}``, ``{"train": ...}``, ``{"grad": ...}``,
   ``{"kernels": [...]}``, ``{"engine": [...]}``, ``{"sweep": ...}``,
   ``{"figures": ...}``, ``{"layouts": ...}`` and
   ``{"serve_layouts": ...}`` summary lines, then the ``{"ok": true, ...}``
   line.

Each run of a main path (phases 5, 6, 7, 9 and 10) zeroes the kernels'
launch counts just before it and reads them just after.

Any failed check raises, so the script exits non-zero and prints no result
line.  Weights are random, drawn on the card from a fixed seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

from repro_torch.roofline import hw  # noqa: E402

# H100 SXM data-sheet peaks (the bound of each kernel is computed from them).
HBM_BYTES_PER_S = hw.HBM_BW
BF16_TENSOR_FLOPS = hw.PEAK_FLOPS
FP32_FLOPS = hw.FP32_FLOPS

SEED = 0
BATCH, GEN = 4, 32
# (arch, batch, prompt, layers, encoder frames).  mixtral-8x22b cut to 8 of
# its 56 layers: 20.4 B parameters, 40.9 GB in bf16, where 56 layers would
# take ~282 GB.  whisper-base at full depth (6 + 6 layers): a 30-s window
# (1500 frames: 30 s of 10-ms mel frames through two convs, the second of
# stride 2) with the previous window's text as a 224-token prompt, as its
# long-form decoding runs.  llava-next-34b cut to 40 of its 60 layers: 23.2 B
# parameters, 46.5 GB in bf16 (60 layers take 68.8 GB of weights alone); its
# prefix is 2880 patch rows (5 tiles x 576) ahead of the prompt.
SERVES = (("qwen2-7b", BATCH, 512, 28, None),
          ("mamba2-370m", BATCH, 2048, 48, None),
          ("mixtral-8x22b", BATCH, 512, 8, None),
          ("whisper-base", 16, 224, 6, 1500),
          ("llava-next-34b", BATCH, 128, 40, None))
PROMPT = SERVES[0][2]
PROFILE_DECODE_STEPS = 4   # decode steps of each serve cell's traced run
RMSNORM_TOL = 2e-2   # bf16: both round one fp32 result to bf16
FLASH_TOL = {torch.bfloat16: 2e-2,   # bf16 output; plain version rounds p
             torch.float32: 2e-5}    # same sums in another order
# SSD scan.  y in bf16: 3e-2 (one rounding of the output; both sides
# compute in fp32).  y in float32: 2e-4, as rtol and times the largest
# |y| as atol: exp of differences of a chunk's cumulative sum of dt*A,
# summed in another order, errs by ~|cumsum| * 2^-24, ~1e-4 of the largest
# term over a 256-row chunk where terms cancel.
SSD_TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-4}
# The fp32 state, as rtol and times its largest entry as atol: a 256-row
# chunk's cumsum reaches ~-1e3 (the tests' A) to ~-3e3 (the model's A, to
# -16); two summation orders differ by ~2.2e-4 of the largest entry
# (measured on the card and on the CPU); 1e-3 leaves a 4x margin.
SSD_STATE_TOL = 1e-3
SSD_LAUNCHES_PER_CALL = 1   # counted launches per call (of the launcher)
REF_LOGIT_TOL = 1e-3  # float32 model, card vs CPU, a few layers
# Backward kernels against autograd through the plain version in float32 on
# the same values, as rtol and times the largest |gradient| as atol: bf16
# 2e-2 (one bf16 rounding of each gradient, and the forward's bf16 output in
# D = rowsum(dO*O)); float32 1e-4 (sums over keys, query rows or rows in
# another order).
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# The SSD scan's backward against autograd through the plain scan, as rtol
# and times the gradient's largest entry as atol, per output: dx, dB and dC
# carry x's dtype, so in bf16 2e-2 (one rounding of each; both sides compute
# in fp32 from the same bf16 values); ddt, dA and d(initial state) are fp32
# on both sides in either dtype, so 1e-3, as the fp32 state above
# (SSD_STATE_TOL): exp of a chunk's cumulative sum of dt*A in another order
# errs by ~|cumsum| * 2^-24, and dA and ddt sum such terms over every row
# (the CPU mirror of the kernel's steps, ssd_scan_bwd_phases, measured
# within ~1e-4 of the largest entry).
SSD_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}
SSD_BWD_ROUNDED = ("x", "Bm", "Cm")   # the outputs in x's dtype
# In bf16 those three take as atol SSD_BWD_MEDIAN_ATOL times their median
# |entry|, not a share of their largest: dx's largest entry is ~140 times its
# median (heads of small |A| carry long sums), so 2e-2 of it passed an error
# three times a median entry.  Sound, an entry at or below the median errs by
# at most 0.0050 times the median (measured on an H100: jamba's dx; 0.0026 to
# 0.0046 in the other bf16 cases: the bf16 rounding, 2^-9, and the hi/lo
# products), so 2e-2 leaves a 4x margin.  Each check prints that reading, and
# planted faults of dx's store (_planted_dx_faults) must fail the limit.
SSD_BWD_MEDIAN_ATOL = 2e-2
# The bf16 SSD backward's kernels that run products (on wgmma); its state
# pass, head-group sums and dA sum hold none.
SSD_BWD_TC_KERNELS = ("ssd_bwd_local_kernel", "ssd_bwd_dc_kernel",
                      "ssd_bwd_dcs_kernel", "ssd_bwd_db_kernel")
CE_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}   # per-row NLL, fp32 out
# The forward's fp32 lse against the plain fp32 logsumexp of the same scores
# (from the same bf16 or fp32 inputs), as rtol and atol: sums over the keys
# in another order.
LSE_TOL = 2e-5
# Train path, float32 smoke models, card vs CPU: losses within 1e-4;
# gradients within 1e-4 relative and 1e-4 of the leaf's largest entry.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-4
# A Mamba mixer's small float32 leaves (dt_bias, D and A_log, one entry a
# head) alone: within 1e-3 of the leaf's largest entry.  Each is a sum over
# batch, rows and head dims that cancels to ~1e-3 of its terms, so the
# card's own float32 elementwise torch (softplus, SiLU, exp), with every
# kernel swapped for its plain version on the CPU, already moves them by
# ~4e-4 of their largest entry;
# tests/test_torch_cuda.py::test_cuda_mamba_grads_gain_no_error_from_kernels
# measures that floor and holds the kernels to it.  Every other leaf of
# every model, the Mamba models' included, stays at TRAIN_GRAD_TOL.
TRAIN_GRAD_TOL_SSM = 1e-3
SSM_SMALL_LEAVES = ("A_log", "D", "dt_bias")
REF_TRAIN_STEPS = 3
# The full-width train runs, (arch, layers, batch, text tokens, encoder
# frames): qwen2-7b cut to 8 of 28 layers (the state of 28 layers, 7.6 B
# parameters at 12 bytes each, exceeds the card's 80 GB); mixtral-8x22b cut
# to 1 of 56 (2.91 B parameters, 34.9 GB of state; two layers' 65 GB plus
# AdamW's fp32 temporaries on its [8, 6144, 16384] expert leaves come too
# close to 80 GB); both batch 2 x 4096 (the repo's train_4k sequence; its
# global batch of 256 cut to 2).  whisper-base at full depth, 16 x (1500
# frames, 448 tokens: its published encoder and text contexts).
# llava-next-34b cut to 4 of 60 layers (3.15 B parameters, 37.8 GB of
# state), 2 x 4096 = 2880 prefix rows + 1216 text tokens (train_4k with the
# VLM split of launch/specs.py).  A warm-up step and three timed steps.
# mamba2-370m at full width and depth (48 layers, 368.4 M parameters, ~4.4
# GB of state), 4 x 4096 (train_4k's global batch of 256 cut to 4).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 3
TRAINS = (("qwen2-7b", 8, TRAIN_BATCH, TRAIN_SEQ, None),
          ("mixtral-8x22b", 1, TRAIN_BATCH, TRAIN_SEQ, None),
          ("whisper-base", 6, 16, 448, 1500),
          ("llava-next-34b", 4, TRAIN_BATCH, TRAIN_SEQ - 2880, None),
          ("mamba2-370m", 48, 4, TRAIN_SEQ, None))
# Copies of a timed kernel's inputs: four prefill-sized sets exceed the L2.
COPIES = {"prefill": 4, "decode": 1}
# AdamW's update in phase 3, at the train cells' leaf sets: (arch, layers).
# mixtral-8x22b's one layer is 2.90 B parameters (34.8 GB of state): two
# more copies of it for the check against the plain loop do not fit beside
# it, so that check runs a leaf at a time there (each at its own size, the
# expert leaves' fp32 moments 3.2 GB), and on mamba2's whole leaf set.
ADAMW_ROWS = (("mixtral-8x22b", 1), ("mamba2-370m", 48))
ADAMW_WHOLE_SET = 1e9   # parameters up to which the check takes the whole set
L2_BYTES = 50e6   # H100 SXM; timed backward copies hold at least twice it
# The engine phase: the batched-bench setup of the repo's simulator-core
# benchmark (every registered scenario at full size, 20 seeds as one batch),
# plus ``mixed`` on ``fat_tree`` (paths of up to six links).  Card lanes
# against CPU lanes: the CPU tests' tolerance against the numpy core.
ENGINE_SEEDS = 20
ENGINE_EXTRA = (("mixed", "fat_tree"),)
ENGINE_TOL = 1e-6
ENGINE_STEPS_PER_SYNC = 16   # lockstep steps between two reads of the flags
# The cells of the same call that the engine does not take: the ordered-rate
# policies on ``mixed`` (seeds 0-2) and one chaos cell, through ``run_cell``
# on worker processes.  Batched fifo records are held to ``run_cell``'s
# within the repo's batched-bench tolerance (BATCHED_TOL of
# benchmarks/perf_sim_core.py), the others equal but for ``wall_s``.
ENGINE_POLICIES = ("msa", "varys", "fair")
ENGINE_POLICY_SEEDS = 3
ENGINE_CHAOS = 1.0
ENGINE_WORKERS = 2
BATCHED_TOL = 1e-6
# The fingerprint of the sweep's --smoke aggregate, as the reference's
# benchmarks/sweep.py and the port's launch/sweep.py both give it on a CPU
# host (tests/test_torch_experiments.py holds the two equal).
SMOKE_FINGERPRINT = ("afc98a0d13e1c04c29eabf8e27ec929a"
                     "ddba113fbeab1388b6869d3bd1a4e52c")

# The figures step of phase 8: the paper's figure harness
# (``repro_torch.launch.figures``; numpy on the host) with Figure 1, Figure
# 3b (50 jobs x 3 DAG topologies x 2 regimes) and the framework-integration
# table (every arch) at full size, the ML-workload table and the
# decision-caching bench at --quick.  The Figure 3b and comm_overlap
# ``derived`` strings are the reference's (``benchmarks/run.py --only ...``
# on a CPU host); tests/test_torch_figures.py holds the port's rows equal to
# the reference's at quick size.
FIGURE_RUNS = (("fig1_motivation", False), ("fig3_topologies", False),
               ("comm_overlap", False), ("ml_workloads", True),
               ("sched_micro", True))
FIG1_AVG_JCT = {"fig1/msa": "avg_jct=7.000;", "fig1/varys": "avg_jct=8.000;"}
FIG3_DERIVED = {
    "fig3/trace/total_order":
        ("msa=1970.77;varys=2076.49;fair=2038.80;varys_over_msa=1.054;"
         "fair_over_msa=1.035"),
    "fig3/trace/partial_order":
        ("msa=1741.09;varys=1795.18;fair=1778.06;varys_over_msa=1.031;"
         "fair_over_msa=1.021"),
    "fig3/trace/disorder":
        ("msa=1642.93;varys=1640.86;fair=1644.86;varys_over_msa=0.999;"
         "fair_over_msa=1.001"),
    "fig3/fanout/total_order":
        ("msa=280.25;varys=403.60;fair=371.94;varys_over_msa=1.440;"
         "fair_over_msa=1.327"),
    "fig3/fanout/partial_order":
        ("msa=259.56;varys=315.77;fair=302.90;varys_over_msa=1.217;"
         "fair_over_msa=1.167"),
    "fig3/fanout/disorder":
        ("msa=269.67;varys=264.21;fair=269.83;varys_over_msa=0.980;"
         "fair_over_msa=1.001"),
}
COMM_OVERLAP_DERIVED = {
    "comm_overlap/mixtral-8x22b":
        ("msa_s=4.8358;varys_s=4.8358;fifo_s=4.8358;flat_s=4.8574;"
         "flat_over_msa=1.004;overlap=0.982;bucket_mb=19.56"),
    "comm_overlap/llama4-maverick-400b-a17b":
        ("msa_s=1.1381;varys_s=1.1381;fifo_s=1.1381;flat_s=1.2568;"
         "flat_over_msa=1.104;overlap=0.979;bucket_mb=126.33"),
    "comm_overlap/llama3-405b":
        ("msa_s=50.1074;varys_s=50.1074;fifo_s=50.1074;flat_s=50.1697;"
         "flat_over_msa=1.001;overlap=0.992;bucket_mb=24.90"),
    "comm_overlap/qwen2-7b":
        ("msa_s=0.8141;varys_s=0.8141;fifo_s=0.8141;flat_s=0.8151;"
         "flat_over_msa=1.001;overlap=0.964;bucket_mb=1.82"),
    "comm_overlap/qwen1.5-4b":
        ("msa_s=0.3958;varys_s=0.3958;fifo_s=0.3958;flat_s=0.3963;"
         "flat_over_msa=1.001;overlap=0.975;bucket_mb=0.62"),
    "comm_overlap/deepseek-coder-33b":
        ("msa_s=4.1021;varys_s=4.1021;fifo_s=4.1021;flat_s=4.1071;"
         "flat_over_msa=1.001;overlap=0.984;bucket_mb=4.14"),
    "comm_overlap/mamba2-370m":
        ("msa_s=0.0395;varys_s=0.0395;fifo_s=0.0395;flat_s=0.0396;"
         "flat_over_msa=1.001;overlap=0.979;bucket_mb=0.05"),
    "comm_overlap/llava-next-34b":
        ("msa_s=4.1758;varys_s=4.1758;fifo_s=4.1758;flat_s=4.1809;"
         "flat_over_msa=1.001;overlap=0.983;bucket_mb=4.36"),
    "comm_overlap/jamba-1.5-large-398b":
        ("msa_s=11.5166;varys_s=11.5166;fifo_s=11.5166;flat_s=11.5717;"
         "flat_over_msa=1.005;overlap=0.889;bucket_mb=344.30"),
}
# The frozen simulator against the live core, every policy, on the
# randomized batch of the reference's tests/test_sim_core_equiv.py
# (``workload.synth_shared_batch``: 50 jobs, seed 11, 32 ports).
SIMREF_POLICIES = ("msa", "varys", "fifo", "fair", "cpath")
SIMREF_BATCH = (50, 11, 32)
# The engine on the card against the frozen simulator: Figure 3b's
# trace-regime jobs (seed 42, 50 per DAG topology), one lane each on a big
# switch sized to the job, all in one lockstep batch.
FIG3_ENGINE_JOBS = 50
FIG3_ENGINE_SEED = 42


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _no_wall(rec: dict) -> dict:
    """A sweep record without its one machine-dependent field."""
    return {**rec, "result": {k: v for k, v in rec["result"].items()
                              if k != "wall_s"}}


def time_ms(fn, inputs: list[tuple], iters: int = 20, warmup: int = 3,
            device_only: bool = True) -> float:
    """Milliseconds per call of ``fn(*args)`` between CUDA events around
    ``iters`` calls, ``args`` cycling through ``inputs``.

    Where ``inputs`` holds copies that together exceed the 50 MB L2 cache,
    each call reads its inputs from device memory, as the bound assumes.
    With ``device_only`` the card first spins (``torch.cuda._sleep``) while
    the host enqueues every call, so the events time the kernels back to
    back and not the host's launch rate; without it they time calls as a
    caller issuing them one after another sees them.
    """
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if device_only:
        torch.cuda._sleep(200_000_000)   # ~0.1 s: outlasts the enqueueing
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _peak(dtype) -> float:
    """The card's peak rate for a flash kernel's products in ``dtype``:
    the bf16 kernels' on the tensor cores, the float32 ones' on the CUDA
    cores."""
    return BF16_TENSOR_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS


def check(label: str, got: torch.Tensor, want: torch.Tensor, tol: float,
          atol: float | None = None) -> float:
    """allclose with rtol ``tol`` and atol ``atol`` (default ``tol``)."""
    got, want = got.float(), want.float()
    atol = tol if atol is None else atol
    err = (got - want).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, rtol=tol,
                                                            atol=atol)
    print(f"  check {label}: max_abs_err={err:.3e} rtol={tol:g} atol={atol:g} "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{label} disagrees with its plain version")
    return err


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print("[1/11] device")
    print(smi)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device0 {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi


# Every bf16 tensor-core kernel, by library: its kernels and the template
# arguments of each instantiation as they appear in the mangled name (the
# flash kernels per head_dim, the SSD kernels per (P, N)), and the
# instantiation phase 3 reports with its kernel.
def _bf16_tensor_core_kernels() -> dict[str, tuple]:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    flash_args = {f"hd{hd}": f"ILi{hd}E" for hd in fa.HEAD_DIMS}
    ssd_args = {f"P{P}_N{N}": f"ILi{P}ELi{N}E" for P, N in ssd.SHAPES}
    return {"flash_attention": (("flash_fwd_bf16_kernel",), flash_args,
                                "hd128"),
            "flash_attention_bwd": (("flash_bwd_dq_bf16_kernel",
                                     "flash_bwd_dkv_bf16_kernel"),
                                    flash_args, "hd128"),
            "ssd_scan": (("ssd_cb_kernel", "ssd_chunk_state_kernel",
                          "ssd_chunk_out_kernel"), ssd_args, "P64_N128"),
            "ssd_scan_bwd": (SSD_BWD_TC_KERNELS, ssd_args, "P64_N128")}


def _ptxas(log: str) -> dict[str, dict]:
    """Registers and spill bytes of each kernel in an ``-Xptxas -v`` log,
    by mangled name."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def _sass_tensor_ops(lib: Path) -> dict[str, dict]:
    """HMMA (mma.sync), HGMMA (wgmma) and LDGSTS (cp.async) instructions of
    each kernel in the library's SASS, by mangled name."""
    from repro_torch.kernels import build

    sass = subprocess.run([str(Path(build._nvcc()).parent / "cuobjdump"),
                           "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    return {name: {"HMMA": len(re.findall(r"\bHMMA\.", body)),
                   "HGMMA": len(re.findall(r"\bHGMMA\.", body)),
                   "LDGSTS": len(re.findall(r"\bLDGSTS\b", body))}
            for name, body in zip(parts[1::2], parts[2::2])}


def _check_bf16_tensor_cores() -> dict[str, dict]:
    """Each bf16 tensor-core kernel at each instantiation: no spill, its
    products on the tensor cores, its loads asynchronous.  Returns the
    reported instantiations' numbers by kernel."""
    from repro_torch.kernels import build

    report = {}
    for lib, (kernels, args, reported) in _bf16_tensor_core_kernels().items():
        ptxas = _ptxas(build.build_log(lib))
        sass = _sass_tensor_ops(build.library_path(lib))
        for kernel in kernels:
            for label, mangled in args.items():
                names = [n for n in ptxas if kernel in n and mangled in n]
                if len(names) != 1 or names[0] not in sass:
                    fail(f"{kernel}<{label}> not found in the ptxas log and "
                         f"the SASS of {lib}")
                info = {**ptxas[names[0]], **sass[names[0]]}
                print(f"  {kernel}<{label}>: {info.get('registers')} "
                      f"registers, {info.get('spill_bytes')} spill bytes, "
                      f"HMMA {info['HMMA']}, HGMMA {info['HGMMA']}, LDGSTS "
                      f"{info['LDGSTS']}")
                if info.get("spill_bytes") != 0:
                    fail(f"{kernel}<{label}> spills ({info.get('spill_bytes')}"
                         " bytes) or ptxas reported nothing")
                if not info["HMMA"] + info["HGMMA"]:
                    fail(f"{kernel}<{label}> runs no tensor-core instruction")
                if not info["LDGSTS"]:
                    fail(f"{kernel}<{label}> has no asynchronous copy")
                if label == reported:
                    report[kernel] = info
    return report


def _rmsnorm_build_lines() -> None:
    """RMSNorm's kernels from its ptxas log, one line per kernel, dtype and
    layout: registers and spill bytes by vectors a thread (NV; "fast" the
    forward's aligned one-dtype path)."""
    from repro_torch.kernels import build

    types = {"f": "float32", "13__nv_bfloat16": "bfloat16", "6__half":
             "float16"}
    rows: dict[tuple, list] = {}
    for name, info in _ptxas(build.build_log("rmsnorm")).items():
        m = re.search(r"(rmsnorm_(?:fwd|bwd)_kernel)"
                      r"I(f|13__nv_bfloat16|6__half)Li(\d+)ELb([01])E"
                      r"(Lb1E)?", name)
        key = ((m.group(1), types[m.group(2)],
                "a block a row" if m.group(4) == "1" else "a warp a row")
               if m else
               (re.search(r"\d(rmsnorm_[a-z0-9_]*kernel)", name).group(1), "",
                ""))
        rows.setdefault(key, []).append(
            (int(m.group(3)) if m else 0, bool(m and m.group(5)),
             info.get("registers"), info.get("spill_bytes", 0)))
    for (kernel, dtype, layout), insts in sorted(rows.items()):
        print(f"  rmsnorm: {kernel} {dtype} {layout}: " + ", ".join(
            (f"NV{nv}{' fast' if fast else ''} " if nv else "")
            + f"{regs} registers {spill} spill bytes"
            for nv, fast, regs, spill in sorted(insts)))


def phase_build() -> dict[str, dict]:
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_ce as ce

    print("[2/11] build")
    t0 = time.perf_counter()
    build.build()
    t_nvcc = time.perf_counter() - t0
    for name in build.SOURCES:
        if name == "rmsnorm":
            _rmsnorm_build_lines()
            continue
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # Triton JIT of the two cross-entropy kernels at the model's widths.
    logits = torch.ones(1, 152064, device="cuda", dtype=torch.bfloat16)
    labels = torch.zeros(1, dtype=torch.int64, device="cuda")
    _, lse = ce.fused_cross_entropy(logits, labels)
    ce.fused_cross_entropy_bwd(logits, labels, lse, lse)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    print(f"  build_s={total:.2f} (nvcc {t_nvcc:.2f}, triton "
          f"{total - t_nvcc:.2f})")
    return _check_bf16_tensor_cores()


def _rmsnorm_row(label: str, x: torch.Tensor, scale: torch.Tensor,
                 eps: float, copies: int) -> dict:
    """RMSNorm of ``x`` against its plain version, then the kernel, the
    plain version and ``F.rms_norm`` timed on ``copies`` input sets beside
    the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    D = x.shape[-1]
    label = f"rmsnorm {label} {list(x.shape)} bf16"
    err = check(label, ops.rmsnorm(x, scale, eps),
                ref.rmsnorm_ref(x, scale, eps), RMSNORM_TOL)
    n = x.numel()
    b_ms, b_by = bound(2 * n * x.element_size() + D * 2, 4 * n, FP32_FLOPS)
    args = [(x, scale, eps)] + [(torch.randn_like(x), scale, eps)
                                for _ in range(copies - 1)]
    t = {"max_abs_err": err,
         "ms": time_ms(ops.rmsnorm, args),
         "call_ms": time_ms(ops.rmsnorm, args, device_only=False),
         "plain_ms": time_ms(ref.rmsnorm_ref, args),
         "library_ms": time_ms(lambda x, s, e: F.rms_norm(x, (D,), s, e),
                               args),
         "bound_ms": b_ms, "bound_by": b_by, "shape": list(x.shape)}
    print(f"  time {label}: kernel {t['ms']:.4f} ms (per call from the host "
          f"{t['call_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, library "
          f"{t['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return t


def _rmsnorm_entry(cfg) -> dict:
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(SEED)
    D, eps = cfg.d_model, cfg.norm_eps
    scale = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).bfloat16()
    entry = {"name": "rmsnorm", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "replaces": "src/repro/kernels/rmsnorm.py:25"}
    for rows, key in (((BATCH, PROMPT), "prefill"), ((BATCH, 1), "decode"),
                      ((TRAIN_BATCH, TRAIN_SEQ), "train")):
        x = torch.randn(*rows, D, generator=g, device="cuda").bfloat16()
        if key == "train":   # compared only; its time is in the train trace
            check(f"rmsnorm {key} {list(x.shape)} bf16",
                  ops.rmsnorm(x, scale, eps), ref.rmsnorm_ref(x, scale, eps),
                  RMSNORM_TOL)
            continue
        t = _rmsnorm_row(key, x, scale, eps, COPIES[key])
        if key == "prefill":
            entry.update(t)
        else:
            entry["decode"] = t
    entry["launch_floor"] = _launch_floor()
    return entry


def _launch_floor() -> dict:
    """The library's empty kernel, timed as the RMSNorm rows are: back to
    back on the card, and per call from the host."""
    from repro_torch.kernels import rmsnorm as rn

    t = {"ms": time_ms(rn.empty_launch, [()]),
         "call_ms": time_ms(rn.empty_launch, [()], device_only=False)}
    print(f"  time rmsnorm launch floor (empty kernel, csrc/rmsnorm.cu): "
          f"{t['ms']:.4f} ms back to back, {t['call_ms']:.4f} ms per call "
          f"from the host")
    return t


def _flash_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    qi = torch.arange(Sq)[:, None] + (Sk - Sq)
    kj = torch.arange(Sk)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    return int(mask.sum())


def _flash_plain(q, k, v, causal: bool, window: int = 0):
    """The plain version of flash attention in the model layout."""
    from repro_torch.kernels import ref

    return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window).transpose(1, 2)


def _sdpa(q, k, v, causal: bool):
    """SDPA, the library call, on the model layout (Sq == Sk where causal:
    its causal mask is aligned top-left)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True).transpose(1, 2)


def _flash_row(label: str, make, causal: bool, copies: int,
               iters: int = 20) -> dict:
    """Flash attention on ``make()``'s (q, k, v) against its plain version,
    then the kernel, the plain version and SDPA timed on ``copies`` input
    sets beside the bound (no window)."""
    from repro_torch.kernels import ops

    q, k, v = make()
    err = check(label, ops.flash_attention(q, k, v, causal=causal),
                _flash_plain(q, k, v, causal), FLASH_TOL[q.dtype])
    B, Sq, H, hd = q.shape
    # q, k and v read once, the output (q's shape) written once.
    n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    flops = 4 * B * H * hd * _flash_pairs(Sq, k.shape[1], causal, 0)
    b_ms, b_by = bound(n_bytes, flops, _peak(q.dtype))
    args = [(q, k, v)] + [make() for _ in range(copies - 1)]

    def kernel(q, k, v):
        return ops.flash_attention(q, k, v, causal=causal)

    row = {"max_abs_err": err,
           "ms": time_ms(kernel, args, iters),
           "call_ms": time_ms(kernel, args, iters, device_only=False),
           "plain_ms": time_ms(lambda q, k, v: _flash_plain(q, k, v, causal),
                               args, iters),
           "library_ms": time_ms(lambda q, k, v: _sdpa(q, k, v, causal),
                                 args, iters),
           "bound_ms": b_ms, "bound_by": b_by, "shape": list(q.shape),
           "kv_shape": list(k.shape)}
    row.update(tflops=flops / row["ms"] / 1e9, bound_share=b_ms / row["ms"])
    print(f"  time {label}: kernel {row['ms']:.4f} ms (per call from the "
          f"host {row['call_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
          f"library {row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
          f"{flops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB); "
          f"{row['tflops']:.1f} TFLOP/s, {100 * row['bound_share']:.1f}% of "
          f"the bound")
    return row


def _flash_entry(cfg) -> dict:
    from repro_torch.kernels import ops

    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def inputs(S, dtype):
        return [torch.randn(BATCH, S, n, hd, generator=g, device="cuda")
                .to(dtype) for n in (H, KV, KV)]

    entry = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:86"}
    cases = [(PROMPT, 0, torch.bfloat16), (200, 0, torch.bfloat16),
             (PROMPT, 128, torch.bfloat16), (200, 0, torch.float32)]
    for S, window, dtype in cases:
        label = (f"flash_attention B{BATCH} H{H} KV{KV} S{S} hd{hd} "
                 f"{str(dtype).split('.')[-1]} causal window={window}")
        if (S, window, dtype) == cases[0]:
            entry.update(_flash_row(label, lambda: inputs(S, dtype), True,
                                    COPIES["prefill"]))
            continue
        q, k, v = inputs(S, dtype)
        check(label, ops.flash_attention(q, k, v, window=window),
              _flash_plain(q, k, v, True, window), FLASH_TOL[dtype])
    return entry


def _ssd_flops(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Operations of one call: C.B^T once per (row, chunk) since B and C are
    shared by the heads, its causal half and diagonal; the decayed scores
    times x*dt per head; the carried-state term and the state update."""
    pairs = sum(q * (q + 1) // 2
                for q in (min(chunk, S - c0) for c0 in range(0, S, chunk)))
    return 2 * B * pairs * (N + H * P) + 4 * B * H * S * N * P


def _ssd_executed_flops(B: int, S: int, H: int, P: int, N: int,
                        chunk: int) -> int:
    """Tensor-core operations the bf16 kernels execute in one call, counted
    from their tiles (``ssd_scan.TILE`` rows, P and N padded to whole
    64-column blocks) with the hi/lo split's second product: C.B^T per
    causal tile pair; the local states (two products); the carried term and
    the dual form per query tile (two products each)."""
    from repro_torch.kernels.ssd_scan import TILE

    PP, NP = max(P, 64), max(N, 64)
    flops = 0
    for c0 in range(0, S, chunk):
        qt = -(-min(chunk, S - c0) // TILE)
        pairs = qt * (qt + 1) // 2
        flops += B * pairs * 2 * TILE * TILE * NP                    # C.B^T
        flops += B * H * qt * 2 * 2 * PP * TILE * NP                 # states
        flops += B * H * (qt * 2 * 2 * TILE * PP * NP                # carried
                          + pairs * 2 * 2 * TILE * TILE * PP)        # dual
    return flops


def _ssd_bwd_flops(B: int, S: int, H: int, P: int, N: int,
                   chunk: int) -> int:
    """Operations of one backward call (the function, not the kernels'
    tiles): C.B^T once per causal pair of rows (B and C are shared by the
    heads); per head and causal pair, dy.x, W.B, W^T.C and (G o L)^T.dy;
    per head and row, the local state and d(state) the backward
    recomputes, S_in^T dy, dS_out B and dS_out^T x (five [P, N]
    products)."""
    pairs = sum(q * (q + 1) // 2
                for q in (min(chunk, S - c0) for c0 in range(0, S, chunk)))
    return (2 * B * pairs * N + 4 * B * H * pairs * (P + N)
            + 10 * B * H * S * P * N)


def _kernels_per_call(fn, inputs: list[tuple], n: int = 10
                      ) -> tuple[float, dict[str, float]]:
    """CUDA kernels launched per call of ``fn(*args)`` and each kernel's
    device microseconds per call, by name, from a ``torch.profiler`` trace
    of ``n`` calls, ``args`` cycling through ``inputs``."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        fail("the profiler traced no device events")
    us: dict[str, float] = defaultdict(float)
    for e in events:
        m = re.search(r"::(\w+)[<(]", e.name)
        us[m.group(1) if m else e.name[:60]] += e.time_range.elapsed_us() / n
    return len(events) / n, dict(sorted(us.items(), key=lambda kv: -kv[1]))


def _ssd_entry() -> dict:
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    cfg = get_config("mamba2-370m")
    H, P, N, Q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    d_in = cfg.d_inner
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def inputs(S, dtype, model_a, init):
        # x, Bm and Cm as mamba_forward passes them: views of one conv output.
        xbc = torch.randn(BATCH, S, d_in + 2 * N, generator=g,
                          device="cuda").to(dtype)
        x = xbc[..., :d_in].reshape(BATCH, S, H, P)
        Bm, Cm = xbc[..., d_in:d_in + N], xbc[..., d_in + N:]
        dt = F.softplus(torch.randn(BATCH, S, H, generator=g, device="cuda"))
        A = (-torch.linspace(1.0, 16.0, H, device="cuda") if model_a else
             -torch.exp(0.5 * torch.randn(H, generator=g, device="cuda")))
        st = (0.5 * torch.randn(BATCH, H, P, N, generator=g, device="cuda")
              if init else None)
        return x, dt, A, Bm, Cm, st

    entry = {"name": "ssd_scan", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "replaces": "src/repro/kernels/ssd_scan.py:82"}
    S_SERVE = SERVES[1][2]
    # (S, dtype, the model's A (else the test cases' A), initial state).  The
    # serve shape, two ragged lengths (a partial chunk), a nonzero initial
    # state in bf16 and in float32, float32 with the tests' A.
    cases = [(S_SERVE, torch.bfloat16, True, False),
             (200, torch.bfloat16, True, False),
             (300, torch.bfloat16, True, False),
             (300, torch.bfloat16, True, True),
             (512, torch.float32, False, False),
             (300, torch.float32, False, True)]
    for S, dtype, model_a, init in cases:
        x, dt, A, Bm, Cm, st0 = inputs(S, dtype, model_a, init)
        label = (f"ssd_scan B{BATCH} S{S} H{H} P{P} N{N} chunk{Q} "
                 f"{str(dtype).split('.')[-1]} A={'model' if model_a else 'test'}"
                 f"{' initial_state' if init else ''}")
        y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q, initial_state=st0)
        want_y, want_st = ref.ssd_scan_ref(x, dt, A, Bm, Cm, Q, st0)
        tol = SSD_TOL[dtype]
        err = check(label + " y", y, want_y, tol, atol=tol * (
            1.0 if dtype == torch.bfloat16 else want_y.abs().max().item()))
        check(label + " state", st, want_st, SSD_STATE_TOL,
              atol=SSD_STATE_TOL * want_st.abs().max().item())
        if dtype == torch.bfloat16 and S in (S_SERVE, 300):
            y2, st2 = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q,
                                   initial_state=st0)
            if not (torch.equal(y, y2) and torch.equal(st, st2)):
                fail(f"{label}: two calls on the same inputs differ")
            print(f"  check {label}: a second call's y and state bit-equal ok")
            del y2, st2
        if (S, dtype, model_a, init) != cases[0]:
            continue
        # x, dt, A, B and C read once; y and the fp32 state written once.
        n_bytes = (sum(t.numel() * t.element_size() for t in (x, dt, A, Bm, Cm))
                   + y.numel() * y.element_size() + st.numel() * 4)
        flops = _ssd_flops(BATCH, S, H, P, N, Q)
        b_ms, b_by = bound(n_bytes, flops, BF16_TENSOR_FLOPS)
        args = [(x, dt, A, Bm, Cm)] + [inputs(S, dtype, model_a, init)[:5]
                                       for _ in range(COPIES["prefill"] - 1)]

        def kernel(x, dt, A, Bm, Cm):
            return ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)

        def plain(x, dt, A, Bm, Cm):
            return ref.ssd_scan_ref(x, dt, A, Bm, Cm, Q)

        entry.update(
            max_abs_err=err,
            ms=time_ms(kernel, args),
            call_ms=time_ms(kernel, args, device_only=False),
            plain_ms=time_ms(plain, args),
            library_ms=None,   # no single PyTorch call computes an SSD scan
            bound_ms=b_ms, bound_by=b_by, shape=list(x.shape),
            launches_per_call=SSD_LAUNCHES_PER_CALL)
        per_call, us = _kernels_per_call(kernel, args)
        if not any(name.startswith("ssd_") for name in us):
            fail(f"{label}: the trace of the calls holds no ssd_ kernel")
        # Bytes the call allocates beyond its outputs: the workspace.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = kernel(*args[0])
        torch.cuda.synchronize()
        scratch = (torch.cuda.max_memory_allocated() - before
                   - sum(t.numel() * t.element_size() for t in out))
        del out
        executed = _ssd_executed_flops(BATCH, S, H, P, N, Q)
        entry.update(
            cuda_kernels_per_call=per_call, device_us_per_call=us,
            tflops=flops / entry["ms"] / 1e9,
            executed_tflops=executed / entry["ms"] / 1e9,
            bound_share=b_ms / entry["ms"], scratch_bytes=scratch)
        print(f"  time {label}: kernel {entry['ms']:.4f} ms (per call from "
              f"the host {entry['call_ms']:.4f} ms), plain "
              f"{entry['plain_ms']:.4f} ms, library none, bound {b_ms:.4f} ms "
              f"({b_by}, {flops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB); "
              f"{entry['tflops']:.1f} TFLOP/s by the bound's count "
              f"({entry['executed_tflops']:.1f} by the {executed / 1e9:.2f} "
              f"GFLOP the tiles execute), "
              f"{100 * entry['bound_share']:.1f}% of the bound; "
              f"{per_call:g} CUDA kernels per call in a trace "
              f"({SSD_LAUNCHES_PER_CALL} counted launch): "
              + ", ".join(f"{k} {v:.1f} us" for k, v in us.items())
              + f"; scratch allocated {scratch / 1e6:.1f} MB")
    return entry


def _grads(fn, inputs: tuple, dout: torch.Tensor, dtype=None) -> tuple:
    """Autograd of ``fn(*inputs)`` against ``dout``, the inputs first cast
    to ``dtype`` (their own where None): the plain version of a backward."""
    xs = tuple((x.detach() if dtype is None else x.detach().to(dtype))
               .requires_grad_(True) for x in inputs)
    return torch.autograd.grad(fn(*xs), xs, dout.to(xs[0].dtype))


def _backward_timer(fn, inputs: tuple, dout: torch.Tensor):
    """A function that runs the backward of one recorded ``fn(*inputs)``
    graph (kept between calls), for timing a plain or library backward."""
    xs = tuple(x.detach().requires_grad_(True) for x in inputs)
    out = fn(*xs)
    return lambda: torch.autograd.grad(out, xs, dout, retain_graph=True)


def _check_grads(label: str, got: tuple, want: tuple, tol: float,
                 names: str) -> float:
    """Each gradient within rtol ``tol`` and ``tol`` times its largest
    entry; returns the largest error."""
    return max(check(f"{label} d{n}", g, w, tol,
                     atol=tol * w.abs().max().item())
               for n, g, w in zip(names, got, want))


def _flash_plain_lse(q, k, causal: bool, window: int):
    """[B, H, Sq] fp32 logsumexp of the plain version's scaled, masked fp32
    scores (queries right-aligned to the keys)."""
    Sq, Sk, h, d = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    kx = k.float().repeat_interleave(h // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) / math.sqrt(d)
    qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kj = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    return torch.logsumexp(s.masked_fill_(~mask, -math.inf), dim=-1)


def _flash_bwd_row(label: str, q, k, v, dout, causal: bool, window: int,
                   timed: bool) -> dict:
    """The flash backward on (q, k, v, dout): the forward with lse against
    its plain version (and equal to the forward without lse), two backward
    calls bit-equal and within ``BWD_TOL`` of autograd through the plain
    version in float32; with ``timed`` the kernel, that autograd and SDPA's
    backward timed beside the bound (no window)."""
    from repro_torch.kernels import flash_attention as fa

    def plain(q, k, v):
        return _flash_plain(q, k, v, causal, window)

    out, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    if not torch.equal(out, fa.flash_attention(q, k, v, causal=causal,
                                               window=window)):
        fail(f"{label}: the forward with lse differs from without it")
    check(f"{label} forward out", out, plain(q, k, v), FLASH_TOL[q.dtype])
    check(f"{label} forward lse", lse, _flash_plain_lse(q, k, causal, window),
          LSE_TOL)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                 window=window)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                   window=window)
    if not all(map(torch.equal, got, again)):
        fail(f"{label}: two backward calls on the same inputs differ")
    del again
    want = _grads(plain, (q, k, v), dout, torch.float32)
    err = _check_grads(label, got, want, BWD_TOL[q.dtype], "qkv")
    print(f"  check {label}: a second call's dq, dk, dv bit-equal ok")
    del want, got
    row = {"max_abs_err": err, "shape": list(q.shape),
           "kv_shape": list(k.shape)}
    if not timed:
        return row
    # q, k, v, o, dO and lse read once; dq, dk, dv written once; five
    # products of the forward's size (scores, dP, dV, dK, dQ).  The two
    # passes execute seven (S and dP in each): 1.4x this count.
    B, Sq, h, d = q.shape
    n_bytes = (sum(t.numel() * t.element_size()
                   for t in (q, k, v, out, dout, q, k, v)) + lse.numel() * 4)
    flops = 10 * B * h * d * _flash_pairs(Sq, k.shape[1], causal, window)
    b_ms, b_by = bound(n_bytes, flops, _peak(q.dtype))
    row.update(
        ms=time_ms(lambda *a: fa.flash_attention_bwd(*a, causal=causal,
                                                     window=window),
                   [(q, k, v, out, lse, dout)], iters=5, warmup=1),
        plain_ms=time_ms(_backward_timer(plain, (q, k, v), dout), [()],
                         iters=5, warmup=1),
        library_ms=time_ms(_backward_timer(
            lambda q, k, v: _sdpa(q, k, v, causal), (q, k, v), dout), [()],
            iters=5, warmup=1),
        bound_ms=b_ms, bound_by=b_by)
    row.update(tflops=flops / row["ms"] / 1e9,
               executed_tflops=1.4 * flops / row["ms"] / 1e9,
               bound_share=b_ms / row["ms"])
    print(f"  time {label}: kernel {row['ms']:.3f} ms, plain "
          f"{row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.1f} GFLOP, "
          f"{n_bytes / 1e6:.1f} MB); {row['tflops']:.1f} TFLOP/s by the "
          f"bound's count ({row['executed_tflops']:.1f} executed), "
          f"{100 * row['bound_share']:.1f}% of the bound")
    return row


def _flash_bwd_entry(cfg, fwd: dict) -> dict:
    """The backward's entry; the forward's train-shape numbers (``*_train``)
    go into ``fwd``, the forward's entry."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    entry = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             "replaces": "src/repro/kernels/flash_attention.py:86",
             "note": "backward of flash_attention; the TPU kernel is "
                     "forward-only, so this kernel has no TPU counterpart"}
    # (B, S, H, KV, hd, window, dtype): the train shape, a ragged window, MQA,
    # float32 with GQA and with a window.
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cases = [(TRAIN_BATCH, TRAIN_SEQ, H, KV, hd, 0, torch.bfloat16),
             (2, 200, H, KV, hd, 32, torch.bfloat16),
             (2, 200, H, 1, hd, 0, torch.bfloat16),
             (2, 200, H, KV, hd, 0, torch.float32),
             (1, 130, 8, 1, 64, 32, torch.float32)]
    for B, S, h, kv, d, window, dtype in cases:
        q, k, v, dout = (torch.randn(B, S, n, d, generator=g, device="cuda")
                         .to(dtype) for n in (h, kv, kv, h))
        label = (f"flash_attention_bwd B{B} S{S} H{h} KV{kv} hd{d} "
                 f"{str(dtype).split('.')[-1]} causal window={window}")
        train = (B, S, dtype) == (TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16)
        row = _flash_bwd_row(label, q, k, v, dout, True, window, train)
        if not train:
            continue
        entry.update(row)
        # The forward with lse at this shape, as the train step runs it.
        f_flops = 4 * B * h * d * _flash_pairs(S, S, True, window)
        f_ms, f_by = bound(sum(t.numel() * t.element_size()
                               for t in (q, k, v, q)) + B * h * S * 4,
                           f_flops, BF16_TENSOR_FLOPS)
        fwd.update(
            ms_train=time_ms(
                lambda q, k, v: fa.flash_attention(q, k, v, return_lse=True),
                [(q, k, v)], iters=5, warmup=1),
            plain_ms_train=time_ms(
                lambda q, k, v: _flash_plain(q, k, v, True), [(q, k, v)],
                iters=3, warmup=1),
            library_ms_train=time_ms(lambda q, k, v: _sdpa(q, k, v, True),
                                     [(q, k, v)], iters=5, warmup=1),
            bound_ms_train=f_ms, bound_by_train=f_by,
            shape_train=list(q.shape))
        fwd.update(tflops_train=f_flops / fwd["ms_train"] / 1e9,
                   bound_share_train=f_ms / fwd["ms_train"])
        print(f"  time flash_attention with lse {list(q.shape)}: kernel "
              f"{fwd['ms_train']:.3f} ms, plain {fwd['plain_ms_train']:.3f} "
              f"ms, library (SDPA) "
              f"{fwd['library_ms_train']:.3f} ms, bound {f_ms:.4f} ms "
              f"({f_by}); {fwd['tflops_train']:.1f} TFLOP/s, "
              f"{100 * fwd['bound_share_train']:.1f}% of the bound")
    return entry


def _rmsnorm_bwd_row(label: str, shape, dtype, g, eps: float,
                     timed: bool) -> dict:
    """The RMSNorm backward on random x, dy and scale of ``shape`` against
    autograd through the plain version in float32, and two calls bit-equal;
    with ``timed`` the kernel, that autograd and ``F.rms_norm``'s backward
    timed beside the bound on input copies that hold at least twice the
    L2."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    x, dy = (torch.randn(*shape, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    scale = (1 + 0.1 * torch.randn(shape[-1], generator=g,
                                   device="cuda")).to(dtype)
    label = f"rmsnorm_bwd {label}{list(shape)} {str(dtype).split('.')[-1]}"
    got = rn.rmsnorm_bwd(x, scale, dy, eps)
    again = rn.rmsnorm_bwd(x, scale, dy, eps)
    if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
        fail(f"{label}: two calls of the backward differ")
    want = _grads(lambda x, s: ref.rmsnorm_ref(x, s, eps), (x, scale), dy,
                  torch.float32)
    row = {"max_abs_err": _check_grads(label, got, want, BWD_TOL[dtype],
                                       ("x", "scale")),
           "shape": list(shape), "bit_equal": True}
    print(f"  check {label}: dx and dscale bit-equal across two calls")
    del got, again, want
    if not timed:
        return row
    # x and dy read, dx written, scale read and dscale written.
    n, D = x.numel(), shape[-1]
    n_bytes = 3 * n * x.element_size() + 2 * D * scale.element_size()
    b_ms, b_by = bound(n_bytes, 10 * n, FP32_FLOPS)
    copies = max(2, math.ceil(2 * L2_BYTES / (3 * n * x.element_size())))
    sets = [(x, scale, dy)] + [(torch.randn_like(x), scale,
                                torch.randn_like(dy))
                               for _ in range(copies - 1)]

    def kernel(x, s, dy):
        return rn.rmsnorm_bwd(x, s, dy, eps)

    def timers(fn):
        return [(_backward_timer(fn, (x, s), dy),) for x, s, dy in sets]

    row.update(
        ms=time_ms(kernel, sets),
        call_ms=time_ms(kernel, sets, device_only=False),
        plain_ms=time_ms(lambda t: t(), timers(
            lambda x, s: ref.rmsnorm_ref(x, s, eps))),
        library_ms=time_ms(lambda t: t(), timers(
            lambda x, s: F.rms_norm(x, (D,), s, eps))),
        bound_ms=b_ms, bound_by=b_by, copies=copies)
    print(f"  time {label}: kernel {row['ms']:.4f} ms (per call from the "
          f"host {row['call_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
          f"library {row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
          f"{n_bytes / 1e6:.1f} MB), {100 * b_ms / row['ms']:.1f}% of the "
          f"bound; {copies} input sets")
    return row


def _rmsnorm_bwd_entry(cfg) -> dict:
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    entry = {"name": "rmsnorm_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
             "replaces": "src/repro/kernels/rmsnorm.py:25",
             "note": "backward of rmsnorm; the TPU kernel is forward-only, so "
                     "this kernel has no TPU counterpart"}
    cases = [((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), torch.bfloat16),
             ((3, 100, cfg.d_model), torch.float32),
             ((7, 256), torch.float32)]
    for shape, dtype in cases:
        train = shape[:2] == (TRAIN_BATCH, TRAIN_SEQ)
        row = _rmsnorm_bwd_row("", shape, dtype, g, cfg.norm_eps, train)
        if train:
            entry.update(row)
    return entry


def _ssd_plain_grads(x, dt, A, Bm, Cm, st, dy, dfinal, chunk: int) -> tuple:
    """Autograd through the plain scan in float32 on the same values, of
    sum(y dy) + sum(final dfinal): the gradients of x, dt, A, Bm, Cm and
    (where given) the initial state."""
    from repro_torch.kernels import ref

    ins = [t.detach().float().requires_grad_(True)
           for t in (x, dt, A, Bm, Cm) + ((st,) if st is not None else ())]
    y, final = ref.ssd_scan_ref(*ins[:5], chunk,
                                ins[5] if st is not None else None)
    loss = (y * dy.float()).sum()
    if dfinal is not None:
        loss = loss + (final * dfinal).sum()
    return torch.autograd.grad(loss, ins)


def _ssd_grad_limit(name: str, want: torch.Tensor, dtype) -> tuple[float,
                                                                    float]:
    """(rtol, atol) of the backward's output ``name`` (SSD_BWD_TOL)."""
    if name in SSD_BWD_ROUNDED and dtype == torch.bfloat16:
        return (SSD_BWD_TOL[dtype],
                SSD_BWD_MEDIAN_ATOL * want.abs().median().item())
    tol = SSD_BWD_TOL[dtype if name in SSD_BWD_ROUNDED else torch.float32]
    return tol, tol * want.abs().max().item()


def _limit_ratio(got: torch.Tensor, want: torch.Tensor, rtol: float,
                 atol: float) -> float:
    """The largest |got - want| over its allclose bound (> 1 fails)."""
    return ((got.float() - want).abs() / (atol + rtol * want.abs())).max().item()


def _planted_dx_faults(dx: torch.Tensor, want: torch.Tensor,
                       dt: torch.Tensor) -> dict:
    """dx as three faults of its store would leave it."""
    dx = dx.float()
    swapped = dx.clone()
    rows = dx.shape[1] // 2 * 2
    swapped[:, 0:rows:2, -1] = dx[:, 1:rows:2, -1]
    swapped[:, 1:rows:2, -1] = dx[:, 0:rows:2, -1]
    small = want.abs() < want.abs().median()
    return {"dt scaling dropped": dx / dt[..., None],
            "last head's rows swapped in pairs": swapped,
            "entries below the median zeroed": dx.masked_fill(small, 0.0)}


def _check_ssd_grads(label: str, got: list, want: tuple, dtype,
                     dt: torch.Tensor) -> float:
    """Each of the backward's outputs within its limit (_ssd_grad_limit),
    with its median |entry| and the largest error of the entries at or below
    the median, over the median, printed beside the atol; in bf16, dx's
    planted faults (_planted_dx_faults) must fail dx's limit.  Returns the
    largest error."""
    errs = []
    for n, g, w in zip(("x", "dt", "A", "Bm", "Cm", "initial_state"), got,
                       want):
        rtol, atol = _ssd_grad_limit(n, w, dtype)
        med = w.abs().median().item()
        small = (g.float() - w).abs()[w.abs() <= med].max().item()
        errs.append(check(f"{label} d{n} (median |d{n}| {med:.4g}, error "
                          f"at or below it {small / med:.3g} x median)", g, w,
                          rtol, atol=atol))
    if dtype != torch.bfloat16:
        return max(errs)
    rtol, atol = _ssd_grad_limit("x", want[0], dtype)
    former = SSD_BWD_TOL[dtype] * want[0].abs().max().item()
    for fault, dx in _planted_dx_faults(got[0], want[0], dt).items():
        ratio = _limit_ratio(dx, want[0], rtol, atol)
        print(f"  check {label} dx with {fault}: {ratio:.3g} x the limit "
              f"(atol {atol:.4g}; {_limit_ratio(dx, want[0], rtol, former):.3g}"
              f" x a limit of atol {former:.4g}, 2e-2 of the largest) "
              f"{'fails as it must' if ratio > 1 else 'PASSES'}")
        if ratio <= 1:
            fail(f"{label}: dx's limit passes a planted fault ({fault})")
    return max(errs)


def _ssd_bwd_entry() -> dict:
    """The SSD scan's backward kernel against autograd through the plain
    scan on the card, in bf16 and float32: at mamba2-370m's train shape
    (timed, with two calls bit-equal), a partial last chunk with an initial
    state and a d(final state) in both dtypes, float32 at the model's A,
    and jamba-1.5-large's width (H 256) at 1 x 4096."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ssd_scan as ssd

    cfg = get_config("mamba2-370m")
    P, N, Q = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    _, _, B_T, S_T, _ = next(t for t in TRAINS if t[0] == cfg.name)
    H_JAMBA = get_config("jamba-1.5-large-398b").ssm_heads

    def inputs(B, S, H, dtype, model_a, init, dfinal):
        # x, Bm and Cm as mamba_forward passes them: views of one conv output.
        xbc = torch.randn(B, S, H * P + 2 * N, generator=g,
                          device="cuda").to(dtype)
        x = xbc[..., :H * P].reshape(B, S, H, P)
        Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        dt = F.softplus(torch.randn(B, S, H, generator=g, device="cuda"))
        A = (-torch.linspace(1.0, 16.0, H, device="cuda") if model_a else
             -torch.exp(0.5 * torch.randn(H, generator=g, device="cuda")))
        st = (0.5 * torch.randn(B, H, P, N, generator=g, device="cuda")
              if init else None)
        dy = torch.randn(B, S, H, P, generator=g, device="cuda").to(dtype)
        df = (torch.randn(B, H, P, N, generator=g, device="cuda")
              if dfinal else None)
        return x, dt, A, Bm, Cm, st, dy, df

    entry = {"name": "ssd_scan_bwd", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
             "replaces": "src/repro/kernels/ssd_scan.py:82",
             "note": "backward of ssd_scan; the TPU kernel is forward-only "
                     "(JAX differentiates the model's jnp scan), so this "
                     "kernel has no TPU counterpart; bf16 runs its products "
                     "on wgmma (seven kernels), float32 on the CUDA cores "
                     "(six)"}
    # Registers and spills of the kernels at the models' (P, N) = (64, 128)
    # (the C.B^T kernel and the sums by N alone), by dtype (phase 2 prints
    # them, and holds the bf16 product kernels to its tensor-core check,
    # HGMMA and no spill); the float32 kernels run on the CUDA cores.
    def dtype_of(kernel: str, name: str) -> str:
        return ("bf16" if kernel in SSD_BWD_TC_KERNELS or "bfloat16" in name
                else "fp32")

    entry["build_P64_N128"] = {}
    for name, info in _ptxas(build.build_log("ssd_scan_bwd")).items():
        if "Li128E" in name:
            kernel = re.search(r"(ssd_bwd_\w+?_kernel)", name).group(1)
            entry["build_P64_N128"][f"{kernel} {dtype_of(kernel, name)}"] = info
    bf16, f32 = torch.bfloat16, torch.float32
    # (B, S, H, dtype, the model's A, initial state, d(final state), role).
    cases = [(B_T, S_T, cfg.ssm_heads, bf16, True, False, False, "train"),
             (2, 300, 8, bf16, True, True, True, "ragged"),
             (2, 300, 8, f32, False, True, True, "ragged"),
             (1, 512, 8, f32, True, False, True, "model A"),
             (1, S_T, H_JAMBA, bf16, True, False, False,
              "jamba-1.5-large-398b")]
    for B, S, H, dtype, model_a, init, dfinal, role in cases:
        x, dt, A, Bm, Cm, st, dy, df = inputs(B, S, H, dtype, model_a, init,
                                              dfinal)
        label = (f"ssd_scan_bwd {role} B{B} S{S} H{H} P{P} N{N} chunk{Q} "
                 f"{str(dtype).split('.')[-1]}"
                 f"{' initial_state' if init else ''}"
                 f"{' dfinal' if dfinal else ''}")
        got = ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=Q,
                               initial_state=st, dfinal=df)
        if role in ("train", "ragged"):
            again = ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=Q,
                                     initial_state=st, dfinal=df)
            if not all(torch.equal(a, b) for a, b in zip(got, again)
                       if a is not None):
                fail(f"{label}: two backward calls on the same inputs differ")
            print(f"  check {label}: a second call's gradients bit-equal ok")
            del again
        want = _ssd_plain_grads(x, dt, A, Bm, Cm, st, dy, df, Q)
        err = _check_ssd_grads(label, [t for t in got if t is not None],
                               want, dtype, dt)
        del want
        if role not in ("train", "jamba-1.5-large-398b"):
            continue
        # x, dt, A, B, C and dy read once; dx, ddt, dA, dB, dC written once.
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (x, dt, A, Bm, Cm, dy, *got[:5]))
        flops = _ssd_bwd_flops(B, S, H, P, N, Q)
        b_ms, b_by = bound(n_bytes, flops, BF16_TENSOR_FLOPS)

        def kernel():
            return ssd.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=Q)

        def plain(x, dt, A, Bm, Cm):
            return ref.ssd_scan_ref(x, dt, A, Bm, Cm, Q)[0]

        row = dict(
            max_abs_err=err, shape=list(x.shape),
            ms=time_ms(kernel, [()], iters=5 if role == "train" else 3,
                       warmup=1),
            plain_ms=time_ms(_backward_timer(plain, (x, dt, A, Bm, Cm), dy),
                             [()], iters=5 if role == "train" else 3,
                             warmup=1),
            library_ms=None,   # no single PyTorch call computes it
            bound_ms=b_ms, bound_by=b_by)
        if role != "train":
            entry[role] = row
            print(f"  time {label}: kernel {row['ms']:.3f} ms, plain "
                  f"{row['plain_ms']:.3f} ms, library none, bound "
                  f"{b_ms:.4f} ms ({b_by}, {flops / 1e9:.1f} GFLOP, "
                  f"{n_bytes / 1e6:.1f} MB), {100 * b_ms / row['ms']:.2f}% "
                  f"of the bound")
            del got
            torch.cuda.empty_cache()
            continue
        entry.update(row)
        per_call, us = _kernels_per_call(kernel, [()], n=3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = kernel()
        torch.cuda.synchronize()
        scratch = (torch.cuda.max_memory_allocated() - before
                   - sum(t.numel() * t.element_size() for t in out
                         if t is not None))
        del out
        entry.update(cuda_kernels_per_call=per_call, device_us_per_call=us,
                     tflops=flops / entry["ms"] / 1e9,
                     bound_share=b_ms / entry["ms"], scratch_bytes=scratch)
        print(f"  time {label}: kernel {entry['ms']:.3f} ms, plain "
              f"{entry['plain_ms']:.3f} ms, library none, bound {b_ms:.4f} ms "
              f"({b_by}, {flops / 1e9:.1f} GFLOP, {n_bytes / 1e6:.1f} MB); "
              f"{entry['tflops']:.1f} TFLOP/s by the bound's count, "
              f"{100 * entry['bound_share']:.2f}% of the bound; {per_call:g} "
              f"CUDA kernels per call: "
              + ", ".join(f"{k} {v:.1f} us" for k, v in us.items())
              + f"; scratch allocated {scratch / 1e6:.1f} MB")
        del got
        torch.cuda.empty_cache()
    return entry


def _ce_rows(label: str, T: int, V: int, dtype, g,
             timed: bool) -> tuple[dict, dict]:
    """The fused cross-entropy and its backward on random [T, V] logits
    (every seventh label negative) against the plain version; with
    ``timed`` the kernels, the plain versions and ``F.cross_entropy``
    timed beside the bounds.  Returns the forward's and the backward's
    rows."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_ce as ce
    from repro_torch.kernels import ref

    logits = (2 * torch.randn(T, V, generator=g, device="cuda")).to(dtype)
    labels = torch.randint(0, V, (T,), generator=g, device="cuda")
    labels[::7] = -1
    gr = torch.rand(T, generator=g, device="cuda")
    label = (f"fused_cross_entropy {label}[{T}, {V}] "
             f"{str(dtype).split('.')[-1]}")
    nll, lse = ce.fused_cross_entropy(logits, labels)
    fwd = {"max_abs_err": check(label, nll,
                                ref.cross_entropy_ref(logits, labels),
                                CE_TOL[dtype]), "shape": [T, V]}
    dx = ce.fused_cross_entropy_bwd(logits, labels, lse, gr)
    (want,) = _grads(lambda x: ref.cross_entropy_ref(x, labels), (logits,),
                     gr, torch.float32)
    bwd = {"max_abs_err": _check_grads(label + " bwd", (dx,), (want,),
                                       BWD_TOL[dtype], ("logits",)),
           "shape": [T, V]}
    del want, dx
    if not timed:
        return fwd, bwd
    n = T * V
    lab0 = labels.clamp(min=0)    # F.cross_entropy has no label -1
    fb_bytes = n * logits.element_size() + T * (8 + 4 + 4)
    fb_ms, fb_by = bound(fb_bytes, 4 * n, FP32_FLOPS)
    fwd.update(
        ms=time_ms(ce.fused_cross_entropy, [(logits, labels)], iters=10),
        plain_ms=time_ms(ref.cross_entropy_ref, [(logits, labels)], iters=10),
        library_ms=time_ms(lambda x, y: F.cross_entropy(
            x.float(), y, reduction="none"), [(logits, lab0)], iters=10),
        bound_ms=fb_ms, bound_by=fb_by)
    b_bytes = 2 * n * logits.element_size() + T * (8 + 4 + 4)
    bb_ms, bb_by = bound(b_bytes, 4 * n, FP32_FLOPS)
    bwd.update(
        ms=time_ms(lambda: ce.fused_cross_entropy_bwd(logits, labels, lse,
                                                      gr), [()], iters=10),
        plain_ms=time_ms(_backward_timer(
            lambda x: ref.cross_entropy_ref(x, labels), (logits,), gr),
            [()], iters=10),
        library_ms=time_ms(_backward_timer(
            lambda x: F.cross_entropy(x.float(), lab0, reduction="none"),
            (logits,), gr), [()], iters=10),
        bound_ms=bb_ms, bound_by=bb_by)
    for name, r, by in ((label, fwd, fb_bytes), (label + " bwd", bwd, b_bytes)):
        print(f"  time {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{by / 1e9:.3f} GB)")
    return fwd, bwd


def _ce_entries(cfg) -> list[dict]:
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    fwd = {"name": "fused_cross_entropy", "route": "triton",
           "source": "src/repro_torch/kernels/fused_ce.py",
           "replaces": "src/repro/kernels/fused_ce.py:60"}
    bwd = {"name": "fused_cross_entropy_bwd", "route": "triton",
           "source": "src/repro_torch/kernels/fused_ce.py",
           "replaces": "src/repro/kernels/fused_ce.py:60",
           "note": "backward of fused_cross_entropy; the TPU kernel is "
                   "forward-only, so this kernel has no TPU counterpart"}
    T_TRAIN, V = TRAIN_BATCH * TRAIN_SEQ, cfg.vocab_size
    # The train shape, the vocabulary 1000 of tests/test_kernels.py (not a
    # power of two, ragged last block), float32; negative labels in each.
    cases = [(T_TRAIN, V, torch.bfloat16), (300, 1000, torch.bfloat16),
             (300, 1000, torch.float32), (64, V, torch.float32)]
    for T, V_, dtype in cases:
        train = (T, V_) == (T_TRAIN, V)
        f, b = _ce_rows("", T, V_, dtype, g, train)
        if train:
            fwd.update(f)
            bwd.update(b)
    return [fwd, bwd]


def _checks_at(cfg) -> dict[str, dict]:
    """Every kernel that ``cfg``'s serve and train paths run, against its
    plain version at the shapes those paths give it (checks only; the timed
    entries are at qwen2-7b's): RMSNorm at the prefill, decode and train
    rows and its backward at the train rows; flash attention at the prefill
    and, with its backward, at the train shape, with ``cfg``'s window; the
    cross-entropy and its backward at the train rows and ``cfg``'s
    vocabulary.  Returns each kernel's largest error and shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ce as ce
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as rn

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    D, eps, W = cfg.d_model, cfg.norm_eps, cfg.sliding_window
    H, KV, hd, V = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.vocab_size
    bf16 = torch.bfloat16
    out: dict[str, dict] = {}

    def record(name: str, err: float, shape) -> None:
        if err >= out.get(name, {}).get("max_abs_err", -1.0):
            out[name] = {"max_abs_err": err, "shape": list(shape)}

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(bf16)

    scale = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(bf16)
    for rows in ((BATCH, PROMPT), (BATCH, 1), (TRAIN_BATCH, TRAIN_SEQ)):
        x = randn(*rows, D)
        record("rmsnorm", check(
            f"{cfg.name} rmsnorm {list(x.shape)} bf16",
            ops.rmsnorm(x, scale, eps), ref.rmsnorm_ref(x, scale, eps),
            RMSNORM_TOL), x.shape)
    dy = randn(*x.shape)
    label = f"{cfg.name} rmsnorm_bwd {list(x.shape)} bf16"
    record("rmsnorm_bwd", _check_grads(
        label, rn.rmsnorm_bwd(x, scale, dy, eps),
        _grads(lambda x, s: ref.rmsnorm_ref(x, s, eps), (x, scale), dy,
               torch.float32), BWD_TOL[bf16], ("x", "scale")), x.shape)
    del x, dy

    def plain(q, k, v):
        return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), causal=True,
                                       window=W).transpose(1, 2)

    for B, S in ((BATCH, PROMPT), (TRAIN_BATCH, TRAIN_SEQ)):
        q, k, v = (randn(B, S, n, hd) for n in (H, KV, KV))
        label = (f"{cfg.name} flash_attention B{B} S{S} H{H} KV{KV} hd{hd} "
                 f"bf16 causal window={W}")
        o, lse = fa.flash_attention(q, k, v, window=W, return_lse=True)
        record("flash_attention", check(label, o, plain(q, k, v),
                                        FLASH_TOL[bf16]), q.shape)
        if S != TRAIN_SEQ:
            continue
        dout = randn(*q.shape)
        got = fa.flash_attention_bwd(q, k, v, o, lse, dout, window=W)
        record("flash_attention_bwd", _check_grads(
            label + " bwd", got, _grads(plain, (q, k, v), dout, torch.float32),
            BWD_TOL[bf16], "qkv"), q.shape)
        del q, k, v, o, lse, dout, got

    T = TRAIN_BATCH * TRAIN_SEQ
    logits = (2 * torch.randn(T, V, generator=g, device="cuda")).to(bf16)
    labels = torch.randint(0, V, (T,), generator=g, device="cuda")
    labels[::7] = -1
    gr = torch.rand(T, generator=g, device="cuda")
    label = f"{cfg.name} fused_cross_entropy [{T}, {V}] bf16"
    nll, lse = ce.fused_cross_entropy(logits, labels)
    record("fused_cross_entropy", check(
        label, nll, ref.cross_entropy_ref(logits, labels), CE_TOL[bf16]),
        logits.shape)
    record("fused_cross_entropy_bwd", _check_grads(
        label + " bwd", (ce.fused_cross_entropy_bwd(logits, labels, lse, gr),),
        _grads(lambda x: ref.cross_entropy_ref(x, labels), (logits,), gr,
               torch.float32), BWD_TOL[bf16], ("logits",)), logits.shape)
    return out


def _family_rows(entries: list[dict]) -> None:
    """Every kernel of the whisper-base and llava-next-34b paths (phases 5
    and 6) against its plain version in bf16 at the shapes those paths give
    it, the prefill, encoder, cross-attention, norm and loss shapes timed
    too (the Sq != Sk backward also checked in float32), and RMSNorm at
    mamba2-370m's two widths.  Each row goes into its kernel's entry under
    the cell's name and the row's role."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    by = {e["name"]: e for e in entries}
    flash, bwd = by["flash_attention"], by["flash_attention_bwd"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    bf16 = torch.bfloat16
    serves, trains = {s[0]: s for s in SERVES}, {t[0]: t for t in TRAINS}

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    def flash_check(label, q, k, v, causal) -> dict:
        return {"max_abs_err": check(
            label, ops.flash_attention(q, k, v, causal=causal),
            _flash_plain(q, k, v, causal), FLASH_TOL[q.dtype]),
            "shape": list(q.shape), "kv_shape": list(k.shape)}

    # whisper-base: MHA at hd 64; serve 16 x (1500 frames, 224 tokens),
    # train 16 x (1500 frames, 448 tokens).
    cfg = get_config("whisper-base")
    name, H, hd = cfg.name, cfg.n_heads, cfg.hd
    D, eps = cfg.d_model, cfg.norm_eps
    _, Bs, P, _, Fs = serves[name]
    _, _, Bt, St, Ft = trains[name]

    def qkv(B, Sq, Sk, dtype=bf16):
        return (randn(B, Sq, H, hd, dtype=dtype),
                randn(B, Sk, H, hd, dtype=dtype),
                randn(B, Sk, H, hd, dtype=dtype))

    pre = f"flash_attention {name}"
    flash[f"{name} encoder"] = _flash_row(
        f"{pre} encoder B{Bs} S{Fs} H{H} hd{hd} bf16 non-causal",
        lambda: qkv(Bs, Fs, Fs), False, 2)
    flash[f"{name} cross"] = _flash_row(
        f"{pre} cross B{Bs} Sq{P} Sk{Fs} H{H} hd{hd} bf16 non-causal",
        lambda: qkv(Bs, P, Fs), False, 2)
    flash[f"{name} decoder"] = flash_check(
        f"{pre} decoder B{Bs} S{P} bf16 causal", *qkv(Bs, P, P), True)
    flash[f"{name} decode cross"] = flash_check(
        f"{pre} decode cross B{Bs} Sq1 Sk{Fs} bf16 non-causal",
        *qkv(Bs, 1, Fs), False)
    pre = f"flash_attention_bwd {name}"
    for role, Sq, Sk, causal, dtype, timed in (
            ("cross", St, Ft, False, bf16, True),
            ("cross float32", St, Ft, False, torch.float32, False),
            ("encoder", Ft, Ft, False, bf16, False),
            ("decoder", St, St, True, bf16, False)):
        label = (f"{pre} {role} B{Bt} Sq{Sq} Sk{Sk} H{H} hd{hd} "
                 f"{str(dtype).split('.')[-1]} "
                 f"{'causal' if causal else 'non-causal'}")
        q, k, v = qkv(Bt, Sq, Sk, dtype)
        bwd[f"{name} {role}"] = _flash_bwd_row(
            label, q, k, v, randn(Bt, Sq, H, hd, dtype=dtype), causal, 0,
            timed)
        del q, k, v
    scale = (1 + 0.1 * randn(D, dtype=torch.float32)).to(bf16)
    by["rmsnorm"][f"{name} encoder"] = _rmsnorm_row(
        f"{name} encoder", randn(Bs, Fs, D), scale, eps, 2)
    by["rmsnorm"][f"{name} decode"] = _rmsnorm_row(
        f"{name} decode", randn(Bs, 1, D), scale, eps, 1)
    by["rmsnorm_bwd"][f"{name} encoder"] = _rmsnorm_bwd_row(
        f"{name} encoder ", (Bt, Ft, D), bf16, g, eps, True)
    by["rmsnorm_bwd"][f"{name} decoder"] = _rmsnorm_bwd_row(
        f"{name} decoder ", (Bt, St, D), bf16, g, eps, True)
    f, b = _ce_rows(f"{name} ", Bt * St, cfg.vocab_size, bf16, g, True)
    by["fused_cross_entropy"][f"{name} train"] = f
    by["fused_cross_entropy_bwd"][f"{name} train"] = b
    torch.cuda.empty_cache()

    # llava-next-34b: GQA 56/8 at hd 128; serve 4 x (2880 patches + 128
    # tokens), train 2 x (2880 + 1216).
    cfg = get_config("llava-next-34b")
    name, H, KV, hd = cfg.name, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    D, eps, N = cfg.d_model, cfg.norm_eps, cfg.n_prefix_tokens
    _, Bs, P, _, _ = serves[name]
    _, _, Bt, St, _ = trains[name]
    Ss, Stt = N + P, N + St

    def gqa(B, S):
        return randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)

    flash[f"{name} prefill"] = _flash_row(
        f"flash_attention {name} prefill B{Bs} S{Ss} H{H} KV{KV} hd{hd} bf16 "
        f"causal", lambda: gqa(Bs, Ss), True, 1, iters=5)
    torch.cuda.empty_cache()
    q, k, v = gqa(Bt, Stt)
    bwd[f"{name} train"] = _flash_bwd_row(
        f"flash_attention_bwd {name} train B{Bt} S{Stt} H{H} KV{KV} hd{hd} "
        f"bf16 causal", q, k, v, randn(Bt, Stt, H, hd), True, 0, False)
    del q, k, v
    torch.cuda.empty_cache()
    scale = (1 + 0.1 * randn(D, dtype=torch.float32)).to(bf16)
    by["rmsnorm"][f"{name} prefill"] = _rmsnorm_row(
        f"{name} prefill", randn(Bs, Ss, D), scale, eps, 1)
    by["rmsnorm"][f"{name} decode"] = _rmsnorm_row(
        f"{name} decode", randn(Bs, 1, D), scale, eps, 1)
    by["rmsnorm_bwd"][f"{name} train"] = _rmsnorm_bwd_row(
        f"{name} train ", (Bt, Stt, D), bf16, g, eps, True)
    f, b = _ce_rows(f"{name} ", Bt * St, cfg.vocab_size, bf16, g, True)
    by["fused_cross_entropy"][f"{name} train"] = f
    by["fused_cross_entropy_bwd"][f"{name} train"] = b
    torch.cuda.empty_cache()

    # mamba2-370m: RMSNorm at d_model 1024 (the blocks' and final norms) and
    # d_inner 2048 (the mixer's gated norm); serve 4 x 2048, train 4 x 4096.
    cfg = get_config("mamba2-370m")
    name, eps = cfg.name, cfg.norm_eps
    _, Bs, _, _, _ = serves[name]
    _, _, Bt, St, _ = trains[name]
    for D in (cfg.d_model, cfg.d_inner):
        scale = (1 + 0.1 * randn(D, dtype=torch.float32)).to(bf16)
        by["rmsnorm"][f"{name} train D{D}"] = _rmsnorm_row(
            f"{name} train", randn(Bt, St, D), scale, eps, 2)
        by["rmsnorm"][f"{name} decode D{D}"] = _rmsnorm_row(
            f"{name} decode", randn(Bs, 1, D), scale, eps, 1)
        by["rmsnorm_bwd"][f"{name} train D{D}"] = _rmsnorm_bwd_row(
            f"{name} train ", (Bt, St, D), bf16, g, eps, True)


def _adamw_check(label: str, opt, params, state, grads, decay) -> dict:
    """The kernels' step against the plain loop's from the same state, the
    clip off (the scale 1 on both), each on its own copy of the leaves: m
    and v bit-equal, p within ``kernels/adamw.py``'s ``P_STEPS``.  The
    whole leaf set at once up to ``ADAMW_WHOLE_SET`` parameters, else a
    leaf at a time (a tree of that leaf alone, its decay flag kept)."""
    from repro_torch.kernels import adamw as tadamw
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.tree import leaves, leaves_with_path

    opt = dataclasses.replace(opt, clip_norm=1e30)
    pairs = leaves_with_path(params)
    flags = [decay(path, p) for path, p in pairs]
    ps, ms, vs = [p for _, p in pairs], leaves(state.m), leaves(state.v)
    gs = leaves(grads)
    n = sum(p.numel() for p in ps)
    sets = ([list(range(len(ps)))] if n <= ADAMW_WHOLE_SET
            else [[i] for i in range(len(ps))])
    equal, differ, total, worst = True, 0, 0, {}
    for idx in sets:
        def copy(ts):
            return [ts[i].clone() for i in idx]

        def sub_decay(path, p):
            return flags[idx[path[0]]]
        kp, pp = copy(ps), copy(ps)
        ks = AdamWState(state.step, copy(ms), copy(vs))
        pls = AdamWState(state.step, copy(ms), copy(vs))
        g = [gs[i] for i in idx]
        _, ks, _ = opt.update(g, ks, kp, sub_decay)
        _, pls, _ = opt.plain_update(g, pls, pp, sub_decay)
        equal &= all(torch.equal(a, b) for a, b in
                     zip(ks.m + ks.v, pls.m + pls.v))
        del ks, pls
        d, t, w = tadamw.p_gap(kp, pp, [ps[i] for i in idx])
        differ, total = differ + d, total + t
        for dt, (steps, leaf, at) in w.items():
            if steps >= worst.get(dt, (-1.0,))[0]:
                worst[dt] = (steps, idx[leaf], at)
        del kp, pp
        torch.cuda.empty_cache()
    ok = equal and all(w <= tadamw.P_STEPS[dt]
                       for dt, (w, *_) in worst.items())
    how = ("the whole set" if len(sets) == 1
           else f"{len(sets)} leaves, each alone")
    print(f"  check {label} against the plain loop ({how}): m and v "
          f"bit-equal {equal}; p: {differ} of {total} elements differ "
          f"({differ / total:.2e}), the widest by " + ", ".join(
              f"{w:g} steps ({str(dt)[6:]}, limit {tadamw.P_STEPS[dt]}, "
              f"leaf {'.'.join(map(str, pairs[leaf][0]))}[{at}])"
              for dt, (w, leaf, at) in worst.items())
          + f" {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{label} disagrees with the plain loop")
    return {"checked": how, "p_share_differing": differ / total,
            "p_widest_steps": {str(dt)[6:]: w
                               for dt, (w, *_) in worst.items()}}


def _adamw_row(arch: str, layers: int) -> dict:
    """The AdamW kernels on ``arch``'s train state cut to ``layers`` layers,
    seeded gradients: the global norm against a float64 sum, the check
    against the plain loop (``_adamw_check``), then the kernels, the
    plain loop and ``torch.optim.AdamW(fused=True)`` (a yardstick the port
    never calls; its moments in the parameters' dtype, so 14 bytes a bf16
    parameter) timed beside the bound."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.tree import leaves, tree_map

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    t = train.setup(cfg, steps=4, batch=1, seq=16, seed=SEED, device="cuda")
    state = t.init()
    params, opt, decay = state.params, t.optimizer, t.model.decays
    g = torch.Generator(device="cuda").manual_seed(SEED)
    grads = tree_map(lambda p: (1e-3 * torch.randn(
        p.shape, generator=g, device="cuda")).to(p.dtype), params)
    flat = leaves(params)
    n = sum(p.numel() for p in flat)
    label = (f"adamw {cfg.name} {layers} layers ({n / 1e9:.3f} B "
             f"parameters, {len(flat)} leaves)")
    # g read twice, p read and written, m and v read and written in fp32.
    b_ms, b_by = bound(sum(p.numel() * (4 * p.element_size() + 16)
                           for p in flat), 0, FP32_FLOPS)
    row = {"arch": cfg.name, "layers": layers, "params_b": n / 1e9,
           "leaves": len(flat), "bound_ms": b_ms, "bound_by": b_by}
    _, _, m = opt.update(grads, state.opt, params, decay)
    want = math.sqrt(sum(float(x.double().square().sum())
                         for x in leaves(grads)))
    row["grad_norm_rel_err"] = abs(float(m["grad_norm"]) - want) / want
    print(f"  check {label}: global norm {float(m['grad_norm'])!r} against "
          f"a float64 sum {want!r}: relative error "
          f"{row['grad_norm_rel_err']:.2e} "
          f"{'ok' if row['grad_norm_rel_err'] <= 1e-6 else 'MISMATCH'}")
    if row["grad_norm_rel_err"] > 1e-6:
        fail(f"{label}: global norm off")
    row.update(_adamw_check(label, opt, params, state.opt, grads, decay))

    def kernels():
        opt.update(grads, state.opt, params, decay)

    def plain():
        opt.plain_update(grads, state.opt, params, decay)

    row["ms"] = time_ms(kernels, [()], iters=10, warmup=2)
    row["call_ms"] = time_ms(kernels, [()], iters=10, warmup=2,
                             device_only=False)
    row["plain_ms"] = time_ms(plain, [()], iters=3, warmup=1)
    fused_params = [torch.nn.Parameter(p) for p in flat]
    for p, gp in zip(fused_params, leaves(grads)):
        p.grad = gp
    fused = torch.optim.AdamW(fused_params, lr=1e-4, fused=True)
    row["library_ms"] = time_ms(fused.step, [()], iters=10, warmup=2)
    del fused, fused_params
    print(f"  time {label}: kernels {row['ms']:.2f} ms (per call from the "
          f"host {row['call_ms']:.2f} ms), plain {row['plain_ms']:.2f} ms, "
          f"torch.optim.AdamW(fused=True) {row['library_ms']:.2f} ms, bound "
          f"{b_ms:.2f} ms ({b_by}): {100 * b_ms / row['ms']:.1f}% of it")
    return row


def _adamw_entry() -> dict:
    entry = {"name": "adamw", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/adamw.cu",
             "replaces": "none: src/repro/optim/adamw.py is plain jnp"}
    for arch, layers in ADAMW_ROWS:
        entry[arch] = _adamw_row(arch, layers)
        torch.cuda.empty_cache()
    return entry


def phase_kernels(cfg, built: dict[str, dict]) -> list[dict]:
    from repro_torch.configs import get_config

    print("[3/11] kernels against their plain versions")
    fwd = _flash_entry(cfg)
    bwd = _flash_bwd_entry(cfg, fwd)
    fwd["build_hd128"] = {"flash_fwd_bf16_kernel":
                          built["flash_fwd_bf16_kernel"]}
    bwd["build_hd128"] = {k: built[k] for k in ("flash_bwd_dq_bf16_kernel",
                                                "flash_bwd_dkv_bf16_kernel")}
    ssd = _ssd_entry()
    ssd["build_P64_N128"] = {k: built[k] for k in (
        "ssd_cb_kernel", "ssd_chunk_state_kernel", "ssd_chunk_out_kernel")}
    ssd_bwd = _ssd_bwd_entry()
    ssd_bwd["build_tensor_cores_P64_N128"] = {k: built[k]
                                              for k in SSD_BWD_TC_KERNELS}
    entries = [fwd, bwd, _rmsnorm_entry(cfg), _rmsnorm_bwd_entry(cfg), ssd,
               ssd_bwd, *_ce_entries(cfg)]
    torch.cuda.empty_cache()
    entries.append(_adamw_entry())
    torch.cuda.empty_cache()
    moe_cfg = get_config("mixtral-8x22b")
    for name, c in _checks_at(moe_cfg).items():
        next(e for e in entries if e["name"] == name)[moe_cfg.name] = c
    torch.cuda.empty_cache()
    _family_rows(entries)
    torch.cuda.empty_cache()
    _head_dim_32_rows(entries)
    return entries


def _head_dim_32_rows(entries: list[dict]) -> None:
    """The flash kernels at head_dim 32, the shape of
    ``launch/train_lm.py``'s tiny preset (float32, causal), forward and
    backward against their plain versions, timed beside the bound; the
    same shape in bf16 (the tensor-core kernels, the tiles padded to 64
    columns) checked."""
    from repro_torch.launch.train_lm import PRESETS

    p = PRESETS["tiny"]
    B, S, H, KV, hd = (p["batch"], p["seq"], p["n_heads"], p["n_kv_heads"],
                       p["head_dim"])
    by = {e["name"]: e for e in entries}
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        shape = f"B{B} S{S} H{H} KV{KV} hd{hd} {name} causal"

        def qkv():
            return (randn(B, S, H, hd, dtype=dtype),
                    randn(B, S, KV, hd, dtype=dtype),
                    randn(B, S, KV, hd, dtype=dtype))

        by["flash_attention"][f"train_lm tiny {name}"] = _flash_row(
            f"flash_attention train_lm tiny {shape}", qkv, True, 1)
        by["flash_attention_bwd"][f"train_lm tiny {name}"] = _flash_bwd_row(
            f"flash_attention_bwd train_lm tiny {shape}", *qkv(),
            randn(B, S, H, hd, dtype=dtype), True, 0, True)


def _expected_launches(cfg, steps: int) -> dict[str, int]:
    """Launches of one prefill and ``steps`` decode steps: flash attention
    and the SSD scan on prefill only, RMSNorm on every pass (each layer's
    mixer norm, FFN norm and Mamba gated norm, and the final norm); no
    backward or cross-entropy kernel.  The encoder-decoder: prefill runs
    the encoder (a flash attention and two norms per layer, its final norm)
    and the decoder (self- and cross-attention, three norms per layer, the
    final norm); each decode step the decoder again, its cross-attention
    through flash attention."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import n_units, unit_layout

    if cfg.family == "encdec":
        E, L = cfg.n_enc_layers, cfg.n_layers
        return {**dict.fromkeys(ops.COUNTERS, 0),
                "flash_attention": E + 2 * L + L * steps,
                "rmsnorm": 2 * E + 1 + (3 * L + 1) * (1 + steps)}
    layout, U = unit_layout(cfg), n_units(cfg)
    n_attn = U * sum(s["mixer"] == "attn" for s in layout)
    n_mamba = U * sum(s["mixer"] == "mamba" for s in layout)
    n_ffn = U * sum(bool(s["ffn"]) for s in layout)
    return {**dict.fromkeys(ops.COUNTERS, 0),
            "flash_attention": n_attn,
            "rmsnorm": (cfg.n_layers + n_ffn + n_mamba + 1) * (1 + steps),
            "ssd_scan": n_mamba * SSD_LAUNCHES_PER_CALL}


def _expected_train_launches(cfg, steps: int,
                             optimizer: bool = True) -> dict[str, int]:
    """Launches of ``steps`` train steps under per-unit activation
    checkpointing: each layer's flash attention or SSD scan and its norms
    (a Mamba mixer's gated norm too) run twice forward (the pass and the
    backward's recompute) and once backward, the final norm and the
    cross-entropy once each way; with ``optimizer``, AdamW's three kernels
    a step.  The
    encoder-decoder checkpoints its decoder layers only: the encoder's
    attention and norms (and its final norm) run once each way, the
    decoder's two attentions and three norms twice forward and once
    backward."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import n_units, unit_layout

    if cfg.family == "encdec":
        E, L = cfg.n_enc_layers, cfg.n_layers
        per_step = {**dict.fromkeys(ops.COUNTERS, 0),
                    "flash_attention": E + 4 * L,
                    "flash_attention_bwd": E + 2 * L,
                    "rmsnorm": 2 * E + 1 + 6 * L + 1,
                    "rmsnorm_bwd": 2 * E + 1 + 3 * L + 1,
                    "fused_cross_entropy": 1, "fused_cross_entropy_bwd": 1,
                    "adamw": 3 * optimizer}
        return {k: v * steps for k, v in per_step.items()}
    layout, U = unit_layout(cfg), n_units(cfg)
    n_attn = U * sum(s["mixer"] == "attn" for s in layout)
    n_mamba = U * sum(s["mixer"] == "mamba" for s in layout)
    n_norms = cfg.n_layers + U * sum(bool(s["ffn"]) for s in layout) + n_mamba
    per_step = {**dict.fromkeys(ops.COUNTERS, 0),
                "flash_attention": 2 * n_attn,
                "flash_attention_bwd": n_attn,
                "ssd_scan": 2 * n_mamba * SSD_LAUNCHES_PER_CALL,
                "ssd_scan_bwd": n_mamba,
                "rmsnorm": 2 * n_norms + 1, "rmsnorm_bwd": n_norms + 1,
                "fused_cross_entropy": 1, "fused_cross_entropy_bwd": 1,
                "adamw": 3 * optimizer}
    return {k: v * steps for k, v in per_step.items()}


REFERENCE_MODELS = (  # (arch, smoke overrides, prompt, encoder frames)
    ("qwen2-7b", {"head_dim": 128, "d_model": 256, "n_kv_heads": 2}, 70,
     None),
    ("qwen2-7b", {"sliding_window": 32, "n_kv_heads": 2}, 100, None),
    # a capacity that binds: 17 slots per expert and row for ~35 picks
    ("mixtral-8x22b", {"capacity_factor": 0.5}, 70, None),
    # the real SSD head sizes; 100 = 64 + a partial chunk of 36
    ("mamba2-370m", {"ssm_head_dim": 64, "ssm_state": 128, "ssm_chunk": 64},
     100, None),
    ("jamba-1.5-large-398b", {"n_experts": 0}, 70, None),
    ("jamba-1.5-large-398b", {}, 70, None),
    # 100 frames against 40 tokens (Sq != Sk, not a multiple of 64)
    ("whisper-base", {}, 40, 100),
    # 8 patch rows ahead of the prompt
    ("llava-next-34b", {}, 40, None),
)


@contextlib.contextmanager
def _router_logits():
    """Collects the router logits of every MoE FFN the model calls inside
    the block (a list, in call order)."""
    from repro_torch.models import transformer

    seen, moe_ffn = [], transformer.moe_ffn

    def recording(p, x, cfg):
        y, logits = moe_ffn(p, x, cfg)
        seen.append(logits)
        return y, logits

    transformer.moe_ffn = recording
    try:
        yield seen
    finally:
        transformer.moe_ffn = moe_ffn


def _dropped(logits: list, cfg) -> int:
    """(token, choice) pairs over their expert's capacity in these calls."""
    from repro_torch.models import moe

    return sum(int((~moe.route(x, cfg).keep).sum()) for x in logits)


def _to(device):
    return lambda x: x.to(device) if isinstance(x, torch.Tensor) else x


def _train_batch(t, step: int, frames: int | None) -> dict:
    """The trainer's pipeline batch at ``step`` (an encoder's frames as many
    as its tokens, as the JAX pipeline draws them), its frames redrawn with
    ``frames`` rows from the seed and the step where given."""
    b = t.pipeline.batch_at(step)
    if frames:
        B, _, D = b["frames"].shape
        b["frames"] = np.random.default_rng((SEED, step)).standard_normal(
            (B, frames, D)).astype(np.float32)
    return b


def _loss_grads(model, params, batch: dict, device) -> tuple:
    from repro_torch.tree import leaves

    for p in leaves(params):
        p.requires_grad_(True)
    loss, _ = model.loss(params, {k: torch.from_numpy(v).to(device)
                                  for k, v in batch.items()})
    return torch.autograd.grad(loss, leaves(params))


def _grad_tol(path: tuple) -> float:
    """TRAIN_GRAD_TOL_SSM for a Mamba mixer's dt_bias, D and A_log leaves,
    TRAIN_GRAD_TOL for every other leaf."""
    return (TRAIN_GRAD_TOL_SSM if "mamba" in path
            and path[-1] in SSM_SMALL_LEAVES else TRAIN_GRAD_TOL)


def _reference_train() -> None:
    """Every reference model (two float32 qwen2 smokes, the dropping
    mixtral one, Mamba-2 with the real SSD head sizes and a partial chunk,
    both jamba hybrids, whisper with its frames longer than its tokens so
    that the float32 Sq != Sk backward runs, llava with its prefix): one
    batch's gradients and three train steps on the card (kernels) against
    the CPU (plain versions), from the same parameters."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.tree import leaves_with_path, tree_map

    def paths(tree) -> list[tuple]:
        return [path for path, _ in leaves_with_path(tree)]

    for arch, overrides, S, frames in REFERENCE_MODELS:
        cfg = get_config(arch).smoke(**overrides)
        label = (f"reference train {cfg.name} {overrides} 2x{S}"
                 + (f" frames {frames}" if frames else ""))
        t_cpu, t_gpu = (train.setup(cfg, steps=REF_TRAIN_STEPS, batch=2,
                                    seq=S, seed=SEED, device=d)
                        for d in ("cpu", "cuda"))
        s_cpu = t_cpu.init()
        s_gpu = tree_map(_to("cuda"), s_cpu)

        batch = _train_batch(t_cpu, 0, frames)
        batch["labels"][0, :5] = -1                  # ignored positions
        g_cpu = _loss_grads(t_cpu.model, s_cpu.params, batch, "cpu")
        ops.reset_launch_counts()
        g_gpu = _loss_grads(t_gpu.model, s_gpu.params, batch, "cuda")
        counts = ops.launch_counts()
        want = _expected_train_launches(cfg, 1, optimizer=False)
        if counts != want:
            fail(f"{label}: launches of one backward {counts}, expected {want}")
        # The worst leaf (relative error, path) and the count of leaves
        # outside their limit, for each limit.
        worst: dict[float, tuple[float, str]] = {}
        bad = 0
        for path, gg, gc in zip(paths(s_cpu.params), g_gpu, g_cpu):
            gg, scale, tol = gg.cpu(), gc.abs().max().item(), _grad_tol(path)
            rel = (gg - gc).abs().max().item() / max(scale, 1e-30)
            if rel >= worst.get(tol, (-1.0, ""))[0]:
                worst[tol] = (rel, "/".join(map(str, path)))
            bad += not torch.allclose(gg, gc, rtol=tol, atol=tol * scale)
        print(f"  check {label} gradients: {len(g_cpu)} leaves; largest "
              f"error of the leaf's largest entry "
              + "; ".join(f"rtol {tol:g}: {rel:.2e} ({where})"
                          for tol, (rel, where) in sorted(worst.items()))
              + f" {'ok' if not bad else 'MISMATCH'}")
        if bad:
            fail(f"{label}: {bad} gradient leaves disagree with the CPU")

        ops.reset_launch_counts()
        for step in range(REF_TRAIN_STEPS):
            b = _train_batch(t_cpu, step, frames)
            s_cpu, m_cpu = t_cpu.train_step(s_cpu, b)
            s_gpu, m_gpu = t_gpu.train_step(s_gpu, b)
            for key in ("loss", "ce", "aux"):
                lc, lg = float(m_cpu[key]), float(m_gpu[key])
                ok = abs(lc - lg) <= TRAIN_LOSS_TOL
                print(f"  check {label} step {step}: {key} card {lg:.6f} cpu "
                      f"{lc:.6f} |diff| {abs(lc - lg):.2e} "
                      f"{'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"{label}: {key} differs at step {step}")
        counts = ops.launch_counts()
        want = _expected_train_launches(cfg, REF_TRAIN_STEPS)
        if counts != want:
            fail(f"{label}: launches {counts}, expected {want}")


def _reference_loop() -> None:
    """The train loop on the card at smoke size: three steps, a checkpoint,
    and a resumed run to six, against six uninterrupted steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.train import loop

    arch, overrides, S, _ = REFERENCE_MODELS[0]
    cfg = get_config(arch).smoke(**overrides)
    t = train.setup(cfg, steps=6, batch=2, seq=S, seed=SEED, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        def run(total: int, sub: str):
            return loop.run(t.train_step, t.init, t.pipeline.batch_at,
                            loop.LoopConfig(total_steps=total, ckpt_every=3,
                                            ckpt_dir=f"{d}/{sub}"))
        whole = run(6, "whole")
        first = run(3, "resumed")
        second = run(6, "resumed")
    if (first.final_step, second.resumed_from, second.steps_run) != (3, 3, 3):
        fail(f"loop resume: first run to {first.final_step}, second resumed "
             f"from {second.resumed_from} and ran {second.steps_run} steps")
    resumed = first.losses + second.losses
    diff = max(abs(a - b) for a, b in zip(resumed, whole.losses))
    ok = len(resumed) == 6 and diff <= 1e-6 * max(whole.losses)
    print(f"  check loop on the card {cfg.name}: resumed at step 3 from its "
          f"checkpoint, losses {['%.6f' % x for x in resumed]} against an "
          f"uninterrupted run's: max |diff| {diff:.2e} (bitwise equal: "
          f"{resumed == whole.losses}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the resumed loop's losses differ from an uninterrupted run's")


def phase_reference() -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.tree import tree_map

    print("[4/11] reference: float32 models on the card vs the CPU")
    for arch, overrides, S, frames in REFERENCE_MODELS:
        cfg = get_config(arch).smoke(**overrides)
        cpu, gpu = get_model(cfg, device="cpu"), get_model(cfg, device="cuda")
        p_cpu = cpu.init(SEED)
        p_gpu = tree_map(_to("cuda"), p_cpu)
        batch = serve.prompt_batch(cfg, 2, S, SEED, "cpu", frames=frames)
        tokens = batch["tokens"]
        max_seq = serve.context_len(batch) + 4
        with _router_logits() as r_cpu:
            lc, cc = cpu.prefill(p_cpu, batch, max_seq)
        ops.reset_launch_counts()
        with _router_logits() as r_gpu:
            lg, cg = gpu.prefill(p_gpu, tree_map(_to("cuda"), batch), max_seq)
        counts, want = ops.launch_counts(), _expected_launches(cfg, 0)
        if counts != want:
            fail(f"{cfg.name} prefill launches {counts}, expected {want}")
        if cfg.is_moe:
            d_cpu, d_gpu = _dropped(r_cpu, cfg), _dropped(r_gpu, cfg)
            pairs = len(r_gpu) * tokens.numel() * cfg.experts_per_token
            print(f"  {cfg.name} {overrides} prefill: {d_gpu} of {pairs} "
                  f"(token, choice) pairs dropped on the card, {d_cpu} on the "
                  f"CPU")
            if d_cpu != d_gpu:
                fail(f"{cfg.name}: the card and the CPU drop different pairs")
            if cfg.capacity_factor < 1 and not d_gpu:
                fail(f"{cfg.name}: a binding capacity dropped no pair")
        for step in range(4):
            check(f"reference {cfg.name} {overrides} S={S} step {step} "
                  "logits", lg.cpu(), lc, REF_LOGIT_TOL)
            tc, tg = lc.argmax(-1, keepdim=True), lg.argmax(-1, keepdim=True)
            if not torch.equal(tc, tg.cpu()):
                fail(f"{cfg.name}: greedy tokens differ at step {step}")
            lc, cc = cpu.decode(p_cpu, tc, cc)
            lg, cg = gpu.decode(p_gpu, tg, cg)
    _reference_train()
    _reference_loop()


def phase_serve(arch: str, batch: int, prompt: int, layers: int,
                frames: int | None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import profile_serve, serve
    from repro_torch.models import get_model
    from repro_torch.models.moe import capacity
    from repro_torch.tree import leaves

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    print(f"[5/11] serve {cfg.name}: {cfg.n_layers} of {full.n_layers} layers"
          + (f" (+ {cfg.n_enc_layers} encoder layers, {frames} frames)"
             if frames else "")
          + (f" (+ {cfg.n_prefix_tokens} prefix rows)"
             if cfg.n_prefix_tokens else "")
          + f", d_model {cfg.d_model}, {cfg.dtype}, batch {batch}, prompt "
          f"{prompt}, gen {GEN}")
    model = get_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    print(f"  init {n_params / 1e9:.3f} B parameters on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    inputs = serve.prompt_batch(cfg, batch, prompt, SEED, "cuda",
                                frames=frames)
    with _router_logits() as router:    # warm-up: cuBLAS, allocator
        serve.generate(model, params, inputs, 2)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    r = serve.generate(model, params, inputs, GEN)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    steps = r["decode_steps"]
    stats = {"arch": cfg.name, "n_layers": cfg.n_layers,
             "params_b": n_params / 1e9, "batch": batch, "prompt": prompt,
             "context": serve.context_len(inputs), "frames": frames,
             "prefill_ms": r["prefill_s"] * 1e3,
             "decode_ms_per_step": r["decode_s"] * 1e3 / steps,
             "decode_tok_s": batch * steps / r["decode_s"],
             "peak_mem_gb": peak / 1e9, "launches": counts}
    print(f"  prefill {batch}x{stats['context']}: "
          f"{stats['prefill_ms']:.2f} ms")
    print(f"  decode: {steps} steps, {stats['decode_ms_per_step']:.3f} ms/step, "
          f"{stats['decode_tok_s']:.1f} tok/s")
    print(f"  peak memory {stats['peak_mem_gb']:.2f} GB; launches {counts}")
    if cfg.is_moe:
        # The warm-up's prefill routes the same tokens through the same
        # weights as the timed one.
        prefill = [x for x in router if x.shape[1] == prompt]
        stats["moe_prefill"] = {
            "capacity": capacity(cfg, prompt),
            "pairs": len(prefill) * batch * prompt * cfg.experts_per_token,
            "dropped_pairs": _dropped(prefill, cfg)}
        print(f"  prefill routing: capacity {capacity(cfg, prompt)} per row "
              f"and expert; {stats['moe_prefill']['dropped_pairs']} of "
              f"{stats['moe_prefill']['pairs']} (token, choice) pairs dropped")

    # Flash attention (but the encoder-decoder's cross-attention) and the
    # SSD scan launch on prefill only: none of those ran in decode.
    want = _expected_launches(cfg, steps)
    if counts != want:
        fail(f"launch counts {counts}, the path implies {want}")
    seq = r["tokens"]
    if seq.shape != (batch, GEN):
        fail(f"tokens shape {tuple(seq.shape)}")
    if not bool(r["finite"]):
        fail("non-finite logits")
    if not bool(((seq >= 0) & (seq < cfg.vocab_size)).all()):
        fail("token ids out of range")
    print(f"  tokens[0, :8] = {seq[0, :8].tolist()}")
    # Held by phase 10 against the same model served on a mesh; not printed.
    stats["_out"] = {"tokens": seq.cpu(), "logits": r["logits"].cpu()}

    stats["traced"] = profile_serve.profile_generate(model, params, inputs,
                                                     PROFILE_DECODE_STEPS)
    for phase, tr in stats["traced"].items():
        print(f"  traced {phase}"
              f"{f' ({PROFILE_DECODE_STEPS} steps)' if phase == 'decode' else ''}"
              f": wall {tr['wall_ms']:.2f} ms, device busy "
              f"{tr['device_busy_ms']:.2f} ms, idle share {tr['idle_share']:.3f}, "
              f"{tr['kernels']} kernels; by group "
              + ", ".join(f"{k} {v:.2f} ms"
                          for k, v in tr["device_ms_by_group"].items()))
    return stats


def _train_model_flops(cfg, params, batch: dict) -> tuple[float, float,
                                                         float, float]:
    """Model FLOPs of one train step on ``batch``: 6 per active parameter
    per row it multiplies (every position for most; the text positions for
    the LM head, the tied embedding's too; the encoder's frames for the
    encoder's layers and the cross-attention's K/V projections; of a MoE
    layer's experts, the k of E each token is routed to; the input
    embedding, a gather, none), three times the forward's attention (4 * B
    * H * hd per visible query-key pair per attention layer: causal over
    the positions, the encoder's frames against themselves, the text
    against the frames) and three times the forward's SSD scan per Mamba
    layer (``_ssd_flops``).  Returns (total, attention, SSD scans, expert
    products as executed): each expert runs its capacity buffer of C rows
    per sequence whatever the routing, 6 FLOPs per expert parameter per
    buffer row (the recompute not counted), about the capacity factor times
    the active expert FLOPs."""
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import n_units, unit_layout
    from repro_torch.tree import leaves_with_path

    B, St = batch["tokens"].shape
    S = St + (batch["prefix"].shape[1] if "prefix" in batch else 0)
    Se = batch["frames"].shape[1] if "frames" in batch else 0
    dense = experts = 0
    for path, p in leaves_with_path(params):
        if "moe" in path and path[-1] != "router":
            experts += p.numel()
        elif path == ("lm_head",) or (path == ("embed",)
                                      and cfg.tie_embeddings):
            dense += 6 * p.numel() * B * St
        elif path[0] in ("enc_layers", "enc_norm") or path[-2:] in (
                ("cross_attn", "wk"), ("cross_attn", "wv")):
            dense += 6 * p.numel() * B * Se
        elif path != ("embed",):
            dense += 6 * p.numel() * B * S
    if cfg.family == "encdec":
        pairs = (cfg.n_enc_layers * Se * Se
                 + cfg.n_layers * (_flash_pairs(St, St, True, 0) + St * Se))
    else:
        n_attn = n_units(cfg) * sum(s["mixer"] == "attn"
                                    for s in unit_layout(cfg))
        pairs = n_attn * _flash_pairs(S, S, True, cfg.sliding_window)
    attn = 3 * 4 * B * cfg.n_heads * cfg.hd * pairs
    ssd = 0
    if cfg.family in ("ssm", "hybrid"):
        n_mamba = n_units(cfg) * sum(s["mixer"] == "mamba"
                                     for s in unit_layout(cfg))
        ssd = 3 * n_mamba * _ssd_flops(B, S, cfg.ssm_heads, cfg.ssm_head_dim,
                                       cfg.ssm_state, cfg.ssm_chunk)
    if not experts:
        return dense + attn + ssd, attn, ssd, 0.0
    active = 6 * experts * cfg.experts_per_token / cfg.n_experts * B * S
    executed = 6 * experts * B * capacity(cfg, S)
    return dense + active + attn + ssd, attn, ssd, executed


def phase_train(arch: str, layers: int, batch: int, seq: int,
                frames: int | None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import profile_serve, train
    from repro_torch.tree import leaves, tree_map

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    # Positions each step runs through the decoder: the text tokens and a
    # VLM's prefix rows.
    tokens = batch * (seq + cfg.n_prefix_tokens)
    print(f"[6/11] train {cfg.name}: {cfg.n_layers} of {full.n_layers} layers"
          + (f" (+ {cfg.n_enc_layers} encoder layers, {frames} frames)"
             if frames else "")
          + (f" (+ {cfg.n_prefix_tokens} prefix rows)"
             if cfg.n_prefix_tokens else "")
          + f", d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"batch {batch} x seq {seq}, AdamW, {TRAIN_STEPS} timed steps")
    t = train.setup(cfg, steps=TRAIN_STEPS + 2, batch=batch, seq=seq,
                    seed=SEED, device="cuda")
    t0 = time.perf_counter()
    state = t.init()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(state.params))
    print(f"  init {n_params / 1e9:.3f} B parameters and fp32 moments on the "
          f"card in {time.perf_counter() - t0:.2f} s")
    batches = [_train_batch(t, i, frames) for i in range(TRAIN_STEPS + 2)]
    t0 = time.perf_counter()
    state, m = t.train_step(state, batches[0])       # warm-up: cuBLAS, allocator
    losses = [float(m["loss"])]
    print(f"  warm-up step {time.perf_counter() - t0:.2f} s, loss "
          f"{losses[0]:.4f}")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_s = []
    for b in batches[1:TRAIN_STEPS + 1]:
        t0 = time.perf_counter()
        state, m = t.train_step(state, b)
        losses.append(float(m["loss"]))              # waits for the step
        step_s.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    def traced_step():
        nonlocal state
        state, m = t.train_step(state, batches[-1])
        losses.append(float(m["loss"]))

    trace = profile_serve.profile(traced_step)
    # The optimizer alone (the AdamW kernels), on zero gradients, after the
    # measured steps.
    grads = tree_map(torch.zeros_like, state.params)
    adamw_ms = time_ms(lambda: t.optimizer.update(
        grads, state.opt, state.params, t.model.decays), [()], iters=2,
        warmup=1)
    flops, attn_flops, ssd_flops, expert_flops = _train_model_flops(
        cfg, state.params, batches[0])
    ms = 1e3 * sum(step_s) / len(step_s)
    stats = {"arch": cfg.name, "n_layers": cfg.n_layers,
             "batch": batch, "seq": seq, "frames": frames,
             "prefix": cfg.n_prefix_tokens,
             "params_b": n_params / 1e9,
             "ms_per_step": ms, "step_ms": [1e3 * x for x in step_s],
             "tokens_per_s": tokens / (ms / 1e3),
             "model_tflop_per_step": flops / 1e12,
             "attention_tflop_per_step": attn_flops / 1e12,
             "ssd_tflop_per_step": ssd_flops / 1e12,
             "expert_buffer_tflop_per_step": expert_flops / 1e12,
             "share_of_bf16_peak": flops / (ms / 1e3) / BF16_TENSOR_FLOPS,
             "peak_mem_gb": peak / 1e9, "losses": losses,
             "adamw_update_ms": adamw_ms,
             "traced_step": trace, "launches": counts}
    print(f"  {ms:.1f} ms/step ({', '.join(f'{x:.1f}' for x in stats['step_ms'])}),"
          f" {stats['tokens_per_s']:.0f} tokens/s")
    print(f"  model FLOPs {flops / 1e12:.1f} TFLOP/step (attention "
          f"{attn_flops / 1e12:.2f}, SSD scans {ssd_flops / 1e12:.2f}), "
          f"{100 * stats['share_of_bf16_peak']:.1f}%"
          f" of the 989 TFLOP/s bf16 peak"
          + (f"; expert products as executed on the capacity buffers "
             f"{expert_flops / 1e12:.1f} TFLOP/step" if expert_flops else ""))
    print(f"  peak memory {peak / 1e9:.2f} GB; losses "
          f"{['%.4f' % x for x in losses]}")
    print(f"  traced step: wall {trace['wall_ms']:.1f} ms, device busy "
          f"{trace['device_busy_ms']:.1f} ms, idle share "
          f"{trace['idle_share']:.3f}, {trace['kernels']} kernels; by group "
          + ", ".join(f"{k} {v:.1f} ms"
                      for k, v in trace["device_ms_by_group"].items()))
    print(f"  AdamW update alone (CUDA events): {adamw_ms:.1f} ms")
    print(f"  launches over the timed steps {counts}")
    want = _expected_train_launches(cfg, TRAIN_STEPS)
    if counts != want:
        fail(f"train launch counts {counts}, the path implies {want}")
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite train loss {losses}")
    return stats


# The gradient path (phase 7): qwen2-7b at full width cut to 8 of its 28
# layers, batch 2 x 4096, trained with --compress (int8 error feedback)
# through ``launch.train.setup``, then through ``launch.train_lm``'s DP step
# at world size 1 on NCCL.  A world-1 sum is the identity, so the DP step's
# loss and parameters after one step must equal the plain step's bit for
# bit (tolerance 0); the card's compression must equal the CPU's bit for
# bit (the same IEEE operations: abs, max, a correctly rounded division,
# round half to even, a product, a difference).
GRAD_ARCH, GRAD_LAYERS = "qwen2-7b", 8
HW_COPY_BYTES = 1 << 30            # per buffer, twice the 50 MB L2
HW_MATMUL_N = 8192


def _hw_rates() -> dict:
    """The card's HBM copy rate and bf16 matmul rate (CUDA events) beside
    the data sheet's (``roofline/hw.py``)."""
    src = torch.empty(HW_COPY_BYTES // 4, device="cuda").uniform_()
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), [()], iters=20)
    hbm = 2 * HW_COPY_BYTES / (copy_ms / 1e3)
    del src, dst
    n = HW_MATMUL_N
    a = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    mm_ms = time_ms(lambda: a @ b, [()], iters=20)
    flops = 2 * n ** 3 / (mm_ms / 1e3)
    del a, b
    torch.cuda.empty_cache()
    print(f"  HBM copy {hbm / 1e12:.3f} TB/s ({HW_COPY_BYTES >> 20} MiB read "
          f"+ written, {copy_ms:.3f} ms) against the data sheet's "
          f"{hw.HBM_BW / 1e12:.2f}; bf16 matmul {n}^3 {flops / 1e12:.1f} "
          f"TFLOP/s ({mm_ms:.3f} ms) against {hw.PEAK_FLOPS / 1e12:.0f}; "
          f"NVLink ({hw.LINK_BW / 1e9:.0f} GB/s a direction) not measured: "
          f"one card")
    return {"hbm_copy_tb_s": hbm / 1e12, "hbm_sheet_tb_s": hw.HBM_BW / 1e12,
            "bf16_matmul_tflop_s": flops / 1e12,
            "bf16_sheet_tflop_s": hw.PEAK_FLOPS / 1e12,
            "nvlink_sheet_gb_s": hw.LINK_BW / 1e9, "nvlink": "not measured"}


def _mixed_tree(g: torch.Generator) -> tuple[dict, dict]:
    """A seeded (grads, residual) pair: float32 and bf16 leaves with entries
    of magnitude 1e-6 to 1e2, all-zero leaves (the 1e-12 scale floor) and
    two units sharing one scale."""
    from repro_torch.tree import tree_map

    def leaf(shape, dtype):
        mag = 10.0 ** (8 * torch.rand(shape, generator=g) - 6)
        return (torch.randn(shape, generator=g) * mag).to(dtype)

    f32, bf16 = torch.float32, torch.bfloat16
    grads = {"a": leaf((4096, 33), f32), "b": leaf((1000, 7), bf16),
             "zero": torch.zeros(300), "zero_bf16": torch.zeros(17, dtype=bf16),
             "units": [{"w": leaf((512, 64), bf16), "s": leaf((64,), f32)}
                       for _ in range(2)]}
    res = tree_map(lambda x: 1e-3 * torch.randn(x.shape, generator=g), grads)
    res["zero"].zero_()
    res["zero_bf16"].zero_()
    return grads, res


def _compress_card_vs_cpu(label: str, grads: dict, res: dict) -> int:
    """compress_grads on the card against the CPU, bit for bit; returns the
    entries compared."""
    from repro_torch.parallel.compression import EFState, compress_grads
    from repro_torch.tree import leaves, tree_map

    def on(dev, t):
        return tree_map(lambda x: x.to(dev, copy=True), t)

    dc, ec, mc = compress_grads(on("cuda", grads), EFState(on("cuda", res)))
    dh, eh, mh = compress_grads(on("cpu", grads), EFState(on("cpu", res)))
    n = 0
    for a, b, ra, rb in zip(leaves(dc), leaves(dh), leaves(ec.residual),
                            leaves(eh.residual)):
        if not (torch.equal(a.cpu(), b) and torch.equal(ra.cpu(), rb)):
            fail(f"compression {label}: the card's dequantized gradient or "
                 f"residual differs from the CPU's")
        n += a.numel()
    sq_c, sq_h = float(mc["ef_residual_sq"]), float(mh["ef_residual_sq"])
    print(f"  compression {label}: {n} entries bit-equal on the card and the "
          f"CPU; ef_residual_sq {sq_c:.6e} (card) {sq_h:.6e} (CPU)")
    return n


def _train_compressed(cfg, plain: dict) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.parallel import compression
    from repro_torch.tree import leaves, tree_map

    t = train.setup(cfg, steps=TRAIN_STEPS + 2, batch=TRAIN_BATCH,
                    seq=TRAIN_SEQ, seed=SEED, device="cuda", compress=True)
    carry = t.init()
    batches = [t.pipeline.batch_at(i) for i in range(TRAIN_STEPS + 2)]
    t0 = time.perf_counter()
    carry, m = t.train_step(carry, batches[0])
    losses, ef_sq = [float(m["loss"])], [float(m["ef_residual_sq"])]
    print(f"  --compress warm-up step {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    step_s = []
    for b in batches[1:TRAIN_STEPS + 1]:
        t0 = time.perf_counter()
        carry, m = t.train_step(carry, b)
        losses.append(float(m["loss"]))              # waits for the step
        step_s.append(time.perf_counter() - t0)
        ef_sq.append(float(m["ef_residual_sq"]))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    # One more step, unit 0's gradients and residual taken as the
    # transform receives them, for the card-vs-CPU check.
    taken = {}
    real = compression.compress_grads

    def taking(grads, ef):
        taken["grads"] = tree_map(torch.clone, {"units": grads["units"][:1]})
        taken["res"] = tree_map(torch.clone,
                                {"units": ef.residual["units"][:1]})
        return real(grads, ef)

    compression.compress_grads = taking
    try:
        carry, m = t.train_step(carry, batches[-1])
    finally:
        compression.compress_grads = real
    losses.append(float(m["loss"]))
    state, ef = carry
    # The transform alone, on zero gradients, as a caller sees it.
    grads = tree_map(torch.zeros_like, state.params)
    transform_ms = time_ms(lambda: compression.compress_grads(grads, ef),
                           [()], iters=3, warmup=1, device_only=False)
    n_params = sum(p.numel() for p in leaves(state.params))
    del grads, state, ef, carry
    torch.cuda.empty_cache()
    entries = _compress_card_vs_cpu("unit 0's gradients",
                                    taken["grads"], taken["res"])
    del taken
    ms = 1e3 * sum(step_s) / len(step_s)
    stats = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": TRAIN_BATCH,
             "seq": TRAIN_SEQ, "params_b": n_params / 1e9,
             "ms_per_step": ms, "step_ms": [1e3 * x for x in step_s],
             "plain_ms_per_step": plain["ms_per_step"],
             "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
             "transform_ms": transform_ms, "peak_mem_gb": peak / 1e9,
             "plain_peak_mem_gb": plain["peak_mem_gb"],
             "losses": losses, "ef_residual_sq": ef_sq,
             "card_vs_cpu_entries": entries, "launches": counts}
    steps = ", ".join(f"{x:.1f}" for x in stats["step_ms"])
    print(f"  --compress {ms:.1f} ms/step ({steps})"
          f" against the plain step's {plain['ms_per_step']:.1f}; the "
          f"transform alone {transform_ms:.1f} ms (CUDA events)")
    print(f"  peak memory {peak / 1e9:.2f} GB (plain {plain['peak_mem_gb']:.2f});"
          f" losses {['%.4f' % x for x in losses]}; ef_residual_sq "
          f"{['%.4e' % x for x in ef_sq]}")
    print(f"  launches over the timed steps {counts}")
    want = _expected_train_launches(cfg, TRAIN_STEPS)
    if counts != want:
        fail(f"--compress launch counts {counts}, the path implies {want}")
    if not all(map(math.isfinite, losses + ef_sq)):
        fail(f"non-finite --compress loss or residual {losses} {ef_sq}")
    return stats


def _comm_events(prof) -> list[int]:
    """Element counts of the all-reduces in a ``torch.profiler`` trace (the
    process group's ``nccl:all_reduce`` ranges, else its
    ``record_param_comms`` events), in start order; empty where the trace
    records no shapes."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name in ("nccl:all_reduce", "gloo:all_reduce") \
                and e.input_shapes:
            out.append(math.prod(e.input_shapes[0]))   # [] for the loss
    if out:
        return out
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name == "record_param_comms" and e.input_shapes \
                and e.input_shapes[0]:
            shape = e.input_shapes[0]
            out.append(math.prod(shape[0] if isinstance(shape[0], list)
                                 else shape))
    return out


def _dp_world1(cfg) -> dict:
    """``launch.train_lm.make_dp_step`` at world size 1 on NCCL: the
    issue order read from the calls issued, the loss and parameters after
    one step against the plain step's, then two timed steps."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train, train_lm
    from repro_torch.tree import leaves

    shape = ShapeConfig("train", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        kind="train")
    order, plan = train_lm.sync_order(cfg, shape, 1, "msa")
    print(f"  DP step, world 1 on NCCL: plan_step_comm (H100 defaults, 1 "
          f"chip) bucket order {order}; simulated msa "
          f"{plan.dag_steps['msa'] * 1e3:.3f} ms, flat "
          f"{plan.dag_steps['flat'] * 1e3:.3f} ms, overlap "
          f"{plan.overlap_fraction:.3f}")
    t = train.setup(cfg, steps=TRAIN_STEPS + 2, batch=TRAIN_BATCH,
                    seq=TRAIN_SEQ, seed=SEED, device="cuda")
    batches = [t.pipeline.batch_at(i) for i in range(TRAIN_STEPS)]
    state = t.init()
    state, m = t.train_step(state, batches[0])
    plain_loss = float(m["loss"])
    plain = [p.detach().cpu() for p in leaves(state.params)]
    del state, m
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(str(Path(tmp) / "store"), 1)
        dist.init_process_group("nccl", store=store, world_size=1, rank=0)
        try:
            state = t.init()
            step = train_lm.make_dp_step(t.model, t.optimizer, order)
            issued, heads = [], []
            all_reduce, buckets_of = dist.all_reduce, train_lm.unit_grad_buckets

            def sample(flat: torch.Tensor) -> torch.Tensor:
                return flat[::max(1, flat.numel() // 64)].clone()

            def recording_all_reduce(x, *args, **kw):
                issued.append((x.numel(), sample(x.reshape(-1))))
                return all_reduce(x, *args, **kw)

            def recording_buckets(grads):
                out = buckets_of(grads)
                heads[:] = [sample(torch.cat([x.reshape(-1)
                                              for x in leaves(b)]))
                            for b in out]
                return out

            dist.all_reduce = recording_all_reduce
            train_lm.unit_grad_buckets = recording_buckets
            try:
                state, m = step(state, batches[0])
                loss = float(m["loss"])
            finally:
                dist.all_reduce = all_reduce
                train_lm.unit_grad_buckets = buckets_of
            # Each bucket's call carries its leaves flattened in leaf order
            # (one dtype here): 64 entries spread over the buffer name the
            # bucket.  The last call is the loss's.
            got = []
            for n, head in issued[:-1]:
                match = [i for i, h in enumerate(heads)
                         if torch.equal(h, head)]
                if len(match) != 1:
                    fail(f"DP step: an all-reduce of {n} elements matches "
                         f"buckets {match}")
                got.append(match[0])
            print(f"  issued all-reduces, by bucket: {got} (+ the loss's); "
                  f"element counts {[n for n, _ in issued]}")
            if got != order:
                fail(f"DP step issued its buckets in {got}, the plan says "
                     f"{order}")
            if loss != plain_loss:
                fail(f"DP step loss {loss!r} != the plain step's "
                     f"{plain_loss!r}")
            for p, q in zip(leaves(state.params), plain):
                if not torch.equal(p.detach().cpu(), q):
                    fail("DP step parameters differ from the plain step's")
            print(f"  DP step at world 1: loss {loss:.6f} and "
                  f"{sum(q.numel() for q in plain) / 1e9:.3f} B parameters "
                  f"bit-equal to the plain step's (tolerance 0)")
            del plain

            torch.cuda.synchronize()
            ops.reset_launch_counts()
            step_s = []
            for b in batches[1:]:
                t0 = time.perf_counter()
                state, m = step(state, b)
                float(m["loss"])
                step_s.append(time.perf_counter() - t0)
            counts = ops.launch_counts()
            with profile(activities=[ProfilerActivity.CPU],
                         record_shapes=True) as prof:
                state, m = step(state, batches[0])
                float(m["loss"])
            traced = _comm_events(prof)
        finally:
            dist.destroy_process_group()
    want_sizes = [n for n, _ in issued]
    if traced and traced != want_sizes:
        fail(f"the trace's collectives carry {traced} elements, the calls "
             f"{want_sizes}")
    print(f"  profiler: {len(traced)} collectives with shapes in the trace"
          + (", element counts equal to the calls'" if traced else
             " (no shapes recorded; the calls' record stands)"))
    ms = 1e3 * sum(step_s) / len(step_s)
    steps = ", ".join(f"{1e3 * x:.1f}" for x in step_s)
    print(f"  DP step {ms:.1f} ms/step ({steps}); "
          f"launches over {len(step_s)} steps {counts}")
    want = _expected_train_launches(cfg, len(step_s))
    if counts != want:
        fail(f"DP step launch counts {counts}, the path implies {want}")
    del state, m
    torch.cuda.empty_cache()
    return {"order": order, "issued": got, "plan_steps_s": plan.dag_steps,
            "overlap": plan.overlap_fraction, "loss": loss,
            "ms_per_step": ms, "step_ms": [1e3 * x for x in step_s],
            "traced_comm_sizes": traced, "launches": counts}


def phase_grad(plain: dict) -> dict:
    from repro_torch.configs import get_config

    full = get_config(GRAD_ARCH)
    cfg = dataclasses.replace(full, n_layers=GRAD_LAYERS)
    print(f"[7/11] gradient path {cfg.name}: {cfg.n_layers} of "
          f"{full.n_layers} layers, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
          f"--compress (int8 error feedback) and the MSA-ordered DP step")
    rates = _hw_rates()
    stats = {"hw": rates, "compress": _train_compressed(cfg, plain)}
    torch.cuda.empty_cache()
    stats["mixed_tree_entries"] = _compress_card_vs_cpu(
        "seeded mixed-dtype tree", *_mixed_tree(
            torch.Generator().manual_seed(SEED)))
    stats["dp"] = _dp_world1(cfg)
    return stats


# The layouts (phase 9): the gradient path's qwen2-7b (full width, 8 of 28
# layers, 2 x 4096, bf16) through ``launch.train.setup(..., mesh=...)`` on a
# (data=1, model=1) NCCL mesh: the state built as DTensors from the seed
# (``distribute_state``), the batch's rows placed by ``batch_specs``, the
# kernels on the local shards.  At world 1 every collective is the identity
# and every local tensor the whole one, so the loss and the parameters after
# one step are held to the plain step's bit for bit, and the kernel launches
# to the plain step's; the ms/step difference is DTensor's host dispatch.
LAYOUT_ARCH, LAYOUT_LAYERS = GRAD_ARCH, GRAD_LAYERS


def _state_bytes_per_card(multi_pod: bool) -> dict[str, float]:
    """Per-card bytes of each architecture's train state (bf16 params and
    fp32 moments) under ``state_specs`` on the production mesh's shape."""
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.launch.mesh import production_shape
    from repro_torch.launch.specs import state_struct
    from repro_torch.parallel.sharding import state_specs
    from repro_torch.tree import leaves

    shape = production_shape(multi_pod=multi_pod)
    sizes = dict(zip(shape.axis_names, shape.axis_sizes))
    out = {}
    for arch in ARCH_NAMES:
        st = state_struct(get_config(arch))
        total = 0.0
        for x, spec in zip(leaves(st), leaves(state_specs(st, shape))):
            if not isinstance(x, torch.Tensor):
                continue
            split = 1
            for entry in spec:
                for a in (entry if isinstance(entry, tuple)
                          else (entry,) if entry else ()):
                    split *= sizes[a]
            total += x.numel() * x.element_size() / split
        out[arch] = total
    return out


def phase_layouts(plain: dict) -> dict:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tree import leaves

    full = get_config(LAYOUT_ARCH)
    cfg = dataclasses.replace(full, n_layers=LAYOUT_LAYERS)
    print(f"[9/11] layouts: {cfg.name} {cfg.n_layers} of {full.n_layers} "
          f"layers, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, FSDP x TP on a "
          f"(data=1, model=1) NCCL mesh")
    per_card = {pod: _state_bytes_per_card(pod) for pod in (False, True)}
    for arch in per_card[False]:
        print(f"  {arch}: train state per card "
              f"{per_card[False][arch] / 1e9:.2f} GB on (data=32, model=8), "
              f"{per_card[True][arch] / 1e9:.2f} GB on (pod=2, data=32, "
              f"model=8)")
    kw = dict(steps=TRAIN_STEPS + 2, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              seed=SEED, device="cuda")
    t = train.setup(cfg, **kw)
    batches = [t.pipeline.batch_at(i) for i in range(TRAIN_STEPS)]
    state = t.init()
    ops.reset_launch_counts()
    state, m = t.train_step(state, batches[0])
    want_counts = ops.launch_counts()
    plain_loss = float(m["loss"])
    want = [p.detach().cpu() for p in leaves(state.params)]
    del state, m
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(str(Path(tmp) / "store"), 1)
        dist.init_process_group("nccl", store=store, world_size=1, rank=0)
        try:
            mesh = make_test_mesh(1, 1, device_type="cuda")
            ts = train.setup(cfg, mesh=mesh, **kw)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = ts.init()
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            init_peak = torch.cuda.max_memory_allocated()
            ops.reset_launch_counts()
            state, m = ts.train_step(state, batches[0])
            counts = ops.launch_counts()
            loss = float(m["loss"])
            differ = []
            for i, (p, q) in enumerate(zip(leaves(state.params), want)):
                got = p.detach().full_tensor().cpu()
                if not torch.equal(got, q):
                    differ.append((i, float((got.float() - q.float()).abs()
                                            .max()),
                                   float(q.float().abs().max())))
            print(f"  sharded init {init_s:.2f} s, peak "
                  f"{init_peak / 1e9:.2f} GB; one step: loss {loss!r}, the "
                  f"plain step's {plain_loss!r}; launches {counts}")
            if counts != want_counts:
                fail(f"sharded step launches {counts}, the plain step's "
                     f"{want_counts}")
            if loss != plain_loss or differ:
                print(f"  NOT bit-equal: {len(differ)} of {len(want)} leaves"
                      f" differ (index, max |diff|, max |p|): {differ[:8]}")
                if abs(loss - plain_loss) > 2e-2 * abs(plain_loss) or any(
                        d > 2e-2 * s for _, d, s in differ):
                    fail("sharded step outside the bf16 limit (2e-2)")
            else:
                print(f"  loss and {sum(q.numel() for q in want) / 1e9:.3f} "
                      f"B parameters bit-equal to the plain step's "
                      f"(tolerance 0)")
            del want
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            step_s = []
            for b in batches[1:]:
                t0 = time.perf_counter()
                state, m = ts.train_step(state, b)
                float(m["loss"])
                step_s.append(time.perf_counter() - t0)
            timed_counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
        finally:
            dist.destroy_process_group()
    ms = 1e3 * sum(step_s) / len(step_s)
    print(f"  sharded step {ms:.1f} ms/step "
          f"({', '.join(f'{1e3 * x:.1f}' for x in step_s)}) against the plain"
          f" step's {plain['ms_per_step']:.1f} (phase 6): DTensor's host "
          f"dispatch {ms - plain['ms_per_step']:+.1f} ms; peak "
          f"{peak / 1e9:.2f} GB (plain {plain['peak_mem_gb']:.2f})")
    if timed_counts != _expected_train_launches(cfg, len(step_s)):
        fail(f"sharded step launch counts {timed_counts}")
    del state, m
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "bit_equal": not differ and loss == plain_loss,
            "differ": differ[:8], "loss": loss, "plain_loss": plain_loss,
            "ms_per_step": ms, "step_ms": [1e3 * x for x in step_s],
            "plain_ms_per_step": plain["ms_per_step"], "peak_mem_gb":
            peak / 1e9, "init_s": init_s, "init_peak_gb": init_peak / 1e9,
            "state_bytes_per_card": per_card, "launches": timed_counts}


def _lane_diff(a, b) -> float:
    """Largest |difference| of two lanes' per-job JCT/CCT and makespans."""
    if set(a.jct) != set(b.jct) or set(a.cct) != set(b.cct):
        fail("lanes with different jobs")
    return max([abs(a.makespan - b.makespan)]
               + [abs(a.jct[n] - b.jct[n]) for n in b.jct]
               + [abs(a.cct[n] - b.cct[n]) for n in b.cct])


def _engine_row(scenario: str, topology: str, lanes: list) -> tuple[dict, list]:
    from repro_torch.core import simtorch

    walls, reads = [], []
    for _ in range(2):                      # cold, then warm
        torch.cuda.synchronize()
        before = simtorch.sync_count()
        t0 = time.perf_counter()
        card = simtorch.run_fifo_batch(
            lanes, steps_per_sync=ENGINE_STEPS_PER_SYNC, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        reads.append(simtorch.sync_count() - before)
    t0 = time.perf_counter()
    cpu = simtorch.run_fifo_batch(
        lanes, steps_per_sync=ENGINE_STEPS_PER_SYNC, device="cpu")
    cpu_wall = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(card, cpu)):
        if a.events != b.events:
            fail(f"engine {scenario}@{topology} lane {i}: {a.events} events "
                 f"on the card, {b.events} on the CPU")
    diff = max(_lane_diff(a, b) for a, b in zip(card, cpu))
    if not diff <= ENGINE_TOL:
        fail(f"engine {scenario}@{topology}: card lanes differ from the CPU "
             f"by {diff:.3e} > {ENGINE_TOL:g}")
    events = max(r.events for r in card)
    steps = -(-events // ENGINE_STEPS_PER_SYNC) * ENGINE_STEPS_PER_SYNC
    row = {"scenario": scenario, "topology": topology, "lanes": len(lanes),
           "flows_padded": max(p.flow_node.size for p in lanes),
           "max_lane_events": events, "steps_run": steps,
           "card_cold_s": walls[0], "card_warm_s": walls[1],
           "card_warm_ms_per_step": 1e3 * walls[1] / steps,
           "cpu_s": cpu_wall, "host_reads_per_run": reads[1],
           "max_abs_diff_vs_cpu": diff}
    print(f"  {scenario}@{topology}: {len(lanes)} lanes, {row['flows_padded']}"
          f" flows padded, {events} events ({steps} steps); card cold "
          f"{walls[0]:.3f} s, warm {walls[1]:.3f} s "
          f"({row['card_warm_ms_per_step']:.2f} ms/step), CPU {cpu_wall:.3f} s;"
          f" {reads[1]} host reads; max |diff| vs CPU {diff:.3e}")
    return row, cpu


def phase_engine() -> list[dict]:
    from repro_torch.appdag import SCENARIO_TOPOLOGY, SCENARIOS, build_scenario
    from repro_torch.core import simtorch
    from repro_torch.experiments import Cell, run_cell, run_cells_batched
    from repro_torch.launch import profile_serve

    cases = [(name, SCENARIO_TOPOLOGY.get(name, "big_switch"))
             for name in sorted(SCENARIOS)] + list(ENGINE_EXTRA)
    print(f"[8/11] engine: fifo lockstep batches of {ENGINE_SEEDS} seeds at "
          f"full size, card vs CPU (float64)")
    rows, cpu_lanes, packed = [], {}, {}
    for scenario, topology in cases:
        lanes = [simtorch.pack_instance(*build_scenario(
                     scenario, seed=s, topology=topology))
                 for s in range(ENGINE_SEEDS)]
        row, cpu_lanes[scenario, topology] = _engine_row(scenario, topology,
                                                         lanes)
        rows.append(row)
        packed[scenario, topology] = lanes

    # The entry point a sweep calls: every cell above, grouped and batched
    # on the card, and the cells the engine does not take (the ordered-rate
    # policies and a chaos cell), which it hands to the numpy simulator's
    # ``run_cell`` in worker processes.
    fifo = [Cell(sc, "fifo", topo, s) for sc, topo in cases
            for s in range(ENGINE_SEEDS)]
    rest = [Cell("mixed", policy, "big_switch", s)
            for policy in ENGINE_POLICIES for s in range(ENGINE_POLICY_SEEDS)]
    rest.append(Cell("mixed", "msa", "big_switch", 0, ENGINE_CHAOS))
    # Interleaved, so that the records' order is checked across both kinds.
    cells = fifo[:len(fifo) // 2] + rest + fifo[len(fifo) // 2:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = run_cells_batched(cells, workers=ENGINE_WORKERS, device="cuda")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    worst = 0.0
    for cell, rec in zip(cells, recs):
        if (rec["policy"], rec["seed"], rec["scenario"], rec["topology"]) != (
                cell.policy, cell.seed, cell.scenario, cell.topology):
            fail(f"run_cells_batched record out of order: {rec}")
        if cell.policy != "fifo":
            continue
        lane = cpu_lanes[cell.scenario, cell.topology][cell.seed]
        res = rec["result"]
        if rec.get("engine") != "simtorch":
            fail(f"run_cells_batched {cell}: not run on the engine")
        if res["events"] != lane.events:
            fail(f"run_cells_batched {cell}: {res['events']} events, the CPU "
                 f"lane {lane.events}")
        worst = max(worst, abs(res["makespan"] - lane.makespan),
                    *(abs(res["jct"][n] - lane.jct[n]) for n in lane.jct),
                    *(abs(res["cct"][n] - lane.cct[n]) for n in lane.cct))
    if not worst <= ENGINE_TOL:
        fail(f"run_cells_batched on the card differs from the CPU lanes by "
             f"{worst:.3e}")
    print(f"  run_cells_batched: {len(cells)} cells ({len(fifo)} fifo in "
          f"{len(cases)} batches on the card, {len(rest)} through run_cell "
          f"on {ENGINE_WORKERS} worker processes) in {sweep_s:.3f} s "
          f"(building included); max |diff| of the fifo records vs the CPU "
          f"lanes {worst:.3e}")

    # Every record against the numpy simulator's own ``run_cell`` on the
    # same cell: the batched fifo records within ENGINE_TOL per job (JCT
    # and CCT) and in makespan, the others equal but for ``wall_s``.
    t0 = time.perf_counter()
    worst, n_equal = 0.0, 0
    for cell, rec in zip(cells, recs):
        want = run_cell(cell)
        got, ref = rec["result"], want["result"]
        if cell.policy != "fifo":
            if _no_wall(rec) != _no_wall(want):
                fail(f"run_cells_batched {cell}: the record differs from "
                     f"run_cell's")
            n_equal += 1
            continue
        if set(got["jct"]) != set(ref["jct"]):
            fail(f"run_cells_batched {cell}: jobs differ from run_cell's")
        worst = max(worst, abs(got["makespan"] - ref["makespan"]),
                    *(abs(got[k][n] - ref[k][n])
                      for k in ("jct", "cct") for n in ref[k]))
    if not worst <= BATCHED_TOL:
        fail(f"run_cells_batched's fifo records differ from run_cell's by "
             f"{worst:.3e} (limit {BATCHED_TOL})")
    chaos = next(r for r in recs if "fault_intensity" in r)
    check_s = time.perf_counter() - t0
    print(f"  check run_cells_batched against run_cell ({check_s:.1f} s on "
          f"the host): {len(fifo)} fifo records max |diff| "
          f"{worst:.3e} (limit {BATCHED_TOL}) ok; {n_equal} records of "
          f"{', '.join(ENGINE_POLICIES)} and the chaos cell (intensity "
          f"{chaos['fault_intensity']}, {chaos['result'].get('n_faults', 0)} "
          f"faults) equal but for wall_s ok")

    lanes = packed["pipe_serve", "big_switch"]
    trace = profile_serve.profile(lambda: simtorch.run_fifo_batch(
        lanes, steps_per_sync=ENGINE_STEPS_PER_SYNC, device="cuda"))
    row = next(r for r in rows if r["scenario"] == "pipe_serve")
    row["traced_run"] = trace
    row["kernels_per_step"] = trace["kernels"] / row["steps_run"]
    print(f"  traced warm pipe_serve batch: wall {trace['wall_ms']:.1f} ms, "
          f"device busy {trace['device_busy_ms']:.1f} ms, idle share "
          f"{trace['idle_share']:.3f}, {trace['kernels']} kernels "
          f"({row['kernels_per_step']:.1f} per lockstep step) and "
          f"{trace['copies']} copies")
    return rows


def phase_sweep() -> dict:
    """The paper's sweep through the port's entry point
    (``repro_torch.launch.sweep``), its ``--smoke`` profile: the mixed
    cluster, msa, varys and fair, three quick seeds, in one process; its
    ``check()`` (the aggregate's own gates, MSA >= varys among them) must
    pass.  The cells run the numpy simulator on the host."""
    from repro_torch.launch import sweep

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        doc, errs = sweep.run(["--smoke", "--workers", "1", "--no-resume",
                               "--shard-dir", f"{d}/shards",
                               "--out", f"{d}/smoke.json"])
        wall = time.perf_counter() - t0
    if errs:
        fail(f"sweep --smoke: check() failed: {errs}")
    head = doc["headline"]
    r = head["ratio"]
    print(f"  sweep --smoke: headline {head['policy']}-vs-{head['baseline']} "
          f"avg-JCT ratio on {head['scenario']} {r['mean']!r} +/- "
          f"{r['ci95']!r} ({r['n']} seeds), fingerprint "
          f"{doc['fingerprint']}; check() passed; {doc['n_cells']} cells in "
          f"{wall:.2f} s")
    if doc["fingerprint"] != SMOKE_FINGERPRINT:
        fail(f"sweep --smoke: fingerprint {doc['fingerprint']}, the CPU "
             f"host's (and the reference's) {SMOKE_FINGERPRINT}")
    return {"n_cells": doc["n_cells"], "headline_ratio": r,
            "fingerprint": doc["fingerprint"], "wall_s": wall}


def phase_figures(smi: str) -> dict:
    """The paper's figures on the port (phase 8, after the sweep, with
    nothing running beside it): (a) the figure harness's figures at the
    paper's size (``FIGURE_RUNS``; each module's ``run()`` and ``check()``,
    as ``python -m repro_torch.launch.figures --only NAME`` calls them),
    their rows held to the reference's; (b) the frozen simulator
    (``core.simref``) against the live core for every policy; (c) the
    lockstep fifo engine on the card against the frozen simulator on
    Figure 3b's jobs.  (a) and (b) run numpy on the host."""
    from repro_torch.core import (Fabric, make_scheduler, simtorch, simulate,
                                  simulate_reference)
    from repro_torch.core.workload import (TOPOLOGIES, synth_fb_jobs,
                                           synth_shared_batch)
    from repro_torch.launch.figures.run import BENCHES

    print("  figures: the paper's figure harness (repro_torch.launch.figures"
          "; each figure's run() and check() in this process; numpy on the "
          "host)")
    runs, derived = {}, {}
    for only, quick in FIGURE_RUNS:
        mod = BENCHES[only]
        t0 = time.perf_counter()
        rows = mod.run(quick=quick)
        host_s = time.perf_counter() - t0
        for r in rows:
            print(f"    {r[0]},{r[1]:.1f},{r[2]}")
        errs = mod.check(rows)
        if errs:
            fail(f"figures {only}{' --quick' if quick else ''}: check() "
                 f"failed: {errs}")
        runs[only] = {"quick": quick, "rows": len(rows), "host_s": host_s}
        derived[only] = {r[0]: r[2] for r in rows}
        print(f"  {only}{' --quick' if quick else ''}: {len(rows)} rows, "
              f"check() passed, {host_s:.2f} s on the host")
    for name, want in FIG1_AVG_JCT.items():
        if not derived["fig1_motivation"][name].startswith(want):
            fail(f"{name}: {derived['fig1_motivation'][name]}, the paper's "
                 f"{want}")
    for only, want in (("fig3_topologies", FIG3_DERIVED),
                       ("comm_overlap", COMM_OVERLAP_DERIVED)):
        bad = sorted(n for n in set(want) | set(derived[only])
                     if derived[only].get(n) != want.get(n))
        if bad:
            fail(f"{only}: rows {bad} differ from the reference's "
                 f"(CPU host)")
    print(f"  fig1 MSA {FIG1_AVG_JCT['fig1/msa'].rstrip(';')}, Varys "
          f"{FIG1_AVG_JCT['fig1/varys'].rstrip(';')}; the "
          f"{len(FIG3_DERIVED)} Figure 3b and {len(COMM_OVERLAP_DERIVED)} "
          f"comm_overlap rows equal the reference's")

    n_jobs, seed, n_ports = SIMREF_BATCH
    t0 = time.perf_counter()
    for pname in SIMREF_POLICIES:
        live = simulate(synth_shared_batch(*SIMREF_BATCH),
                        make_scheduler(pname), n_ports=n_ports)
        old = simulate_reference(synth_shared_batch(*SIMREF_BATCH),
                                 make_scheduler(pname), n_ports=n_ports)
        for key in ("jct", "cct", "mf_service_order"):
            if getattr(live, key) != getattr(old, key):
                fail(f"simref {pname}: {key} differs from the live core's")
    simref_s = time.perf_counter() - t0
    print(f"  simulate_reference == Simulator (JCT, CCT, service order) on "
          f"{n_jobs} jobs (seed {seed}, {n_ports} ports) for "
          f"{', '.join(SIMREF_POLICIES)}: {simref_s:.2f} s on the host")

    lanes, want = [], []
    for topo in TOPOLOGIES:
        for job, twin in zip(synth_fb_jobs(FIG3_ENGINE_JOBS, topo,
                                           seed=FIG3_ENGINE_SEED),
                             synth_fb_jobs(FIG3_ENGINE_JOBS, topo,
                                           seed=FIG3_ENGINE_SEED)):
            ports = max(job.ports_used(), default=0) + 1
            lanes.append(simtorch.pack_instance(Fabric(n_ports=ports), [job]))
            want.append(simulate_reference([twin], make_scheduler("fifo"),
                                           fabric=Fabric(n_ports=ports)))
    # One run: the engine is eager torch (nothing to compile), and phase 8's
    # batches before it have warmed the card's allocator and kernels.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = simtorch.run_fifo_batch(
        lanes, steps_per_sync=ENGINE_STEPS_PER_SYNC, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    worst = max(max([abs(a.jct[n] - b.jct[n]) for n in b.jct]
                    + [abs(a.cct[n] - b.cct[n]) for n in b.cct])
                for a, b in zip(card, want))
    if not worst <= ENGINE_TOL:
        fail(f"engine on Figure 3b's jobs: lanes differ from "
             f"simulate_reference by {worst:.3e} > {ENGINE_TOL:g}")
    events = max(r.events for r in card)
    steps = -(-events // ENGINE_STEPS_PER_SYNC) * ENGINE_STEPS_PER_SYNC
    engine = {"lanes": len(lanes),
              "flows_padded": max(p.flow_node.size for p in lanes),
              "max_lane_events": events, "steps_run": steps,
              "card_s": wall, "card_ms_per_step": 1e3 * wall / steps,
              "max_abs_diff_vs_simref": worst}
    print(f"  engine: Figure 3b's {len(lanes)} trace-regime jobs (seed "
          f"{FIG3_ENGINE_SEED}) as lanes of one batch, "
          f"{engine['flows_padded']} flows padded, {events} events ({steps} "
          f"steps); card {wall:.3f} s ({engine['card_ms_per_step']:.3f} "
          f"ms/step) on {smi}; max "
          f"|diff| vs simulate_reference {worst:.3e} (limit {ENGINE_TOL:g})")
    return {"harness": runs, "fig1": {n: derived["fig1_motivation"][n]
                                      for n in FIG1_AVG_JCT},
            "fig3": derived["fig3_topologies"],
            "simref_vs_simulator": {"policies": list(SIMREF_POLICIES),
                                    "jobs": n_jobs, "seed": seed,
                                    "ports": n_ports, "host_s": simref_s},
            "engine": engine, "device": smi}


# Serving under the layouts (phase 10): phase 5's qwen2-7b cell (full width
# and depth, bf16, batch 4, prompt 512, 32 tokens) through
# ``launch.serve.generate`` on a (data=1, model=1) NCCL mesh.  At world 1
# every collective is the identity and every local tensor the whole one, so
# the tokens and the last logits are held to phase 5's bit for bit (or each
# differing entry named and held within 2e-2, as phase 9 holds its leaves),
# the kernel launches to phase 5's.  The dry run of the same prefill and
# decode on a fake world of one rank gives their H100 roofline bound.
LAYOUT_SERVE_TOL = 2e-2


def _serve_dry_run(cfg, batch: int, context: int) -> dict:
    """``launch.dryrun`` of the cell's prefill and one decode step against
    a cache of ``context`` rows, on a fake world of one rank: per-device
    FLOPs, collective and argument bytes, and the H100 roofline bound."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.roofline.analysis import (RooflineTerms,
                                               total_collective_bytes)

    out = {}
    for shape in (ShapeConfig("serve_prefill", PROMPT, batch, "prefill"),
                  ShapeConfig("serve_decode", context, batch, "decode")):
        got = dryrun.run(cfg, shape, MeshShape(("data", "model"), (1, 1)))
        terms = RooflineTerms(
            flops=got["flops"], hbm_bytes=got["argument_bytes"]
            + got["output_bytes"],
            coll_bytes=total_collective_bytes(got["collective"]), chips=1)
        out[shape.kind] = {"flops": got["flops"],
                           "argument_bytes": got["argument_bytes"],
                           "output_bytes": got["output_bytes"],
                           "collective_bytes": got["collective"],
                           "bound_ms": terms.bound_s * 1e3,
                           "dominant": terms.dominant,
                           "dry_run_s": got["run_s"]}
    return out


def phase_serve_layouts(plain: dict) -> dict:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import init_params

    arch, batch, prompt, layers, _ = SERVES[0]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    print(f"[10/11] serve layouts: {cfg.name} {cfg.n_layers} layers, "
          f"{cfg.dtype}, batch {batch}, prompt {prompt}, gen {GEN}, "
          f"param_specs on a (data=1, model=1) NCCL mesh")
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(str(Path(tmp) / "store"), 1)
        dist.init_process_group("nccl", store=store, world_size=1, rank=0)
        try:
            mesh = make_test_mesh(1, 1, device_type="cuda")
            model = get_model(cfg, device="cuda")
            t0 = time.perf_counter()
            params = init_params(model, SEED, mesh)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            inputs = serve.prompt_batch(cfg, batch, prompt, SEED, "cuda")
            serve.generate(model, params, inputs, 2)     # warm-up
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            r = serve.generate(model, params, inputs, GEN)
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
        finally:
            dist.destroy_process_group()
    del params
    torch.cuda.empty_cache()
    steps = r["decode_steps"]
    stats = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": batch,
             "prompt": prompt, "init_s": init_s,
             "prefill_ms": r["prefill_s"] * 1e3,
             "decode_ms_per_step": r["decode_s"] * 1e3 / steps,
             "plain_prefill_ms": plain["prefill_ms"],
             "plain_decode_ms_per_step": plain["decode_ms_per_step"],
             "peak_mem_gb": peak / 1e9, "plain_peak_mem_gb":
             plain["peak_mem_gb"], "launches": counts}
    print(f"  init from the seed {init_s:.2f} s; prefill "
          f"{stats['prefill_ms']:.2f} ms (phase 5: {plain['prefill_ms']:.2f}),"
          f" decode {stats['decode_ms_per_step']:.3f} ms/step (phase 5: "
          f"{plain['decode_ms_per_step']:.3f}); peak {peak / 1e9:.2f} GB "
          f"(phase 5: {plain['peak_mem_gb']:.2f}); launches {counts}")
    if counts != plain["launches"]:
        fail(f"serving on a mesh launched {counts}, phase 5 "
             f"{plain['launches']}")
    if not bool(r["finite"]):
        fail("non-finite logits on the mesh")
    want = plain["_out"]
    tokens, logits = r["tokens"].cpu(), r["logits"].cpu()
    if not torch.equal(tokens, want["tokens"]):
        fail(f"tokens on the mesh {tokens[0, :8].tolist()}, phase 5's "
             f"{want['tokens'][0, :8].tolist()}")
    differ = (logits != want["logits"]).nonzero().tolist()
    scale = float(want["logits"].float().abs().max())
    worst = float((logits.float() - want["logits"].float()).abs().max())
    stats.update(tokens_equal=True, logits_bit_equal=not differ,
                 logits_differ=len(differ), logits_max_diff=worst)
    if differ:
        print(f"  logits NOT bit-equal: {len(differ)} entries differ, "
              f"(row, vocab) {differ[:16]}; max |diff| {worst!r} of max "
              f"|logit| {scale!r}")
        if worst > LAYOUT_SERVE_TOL * scale:
            fail(f"logits on the mesh outside {LAYOUT_SERVE_TOL} of the "
                 f"largest")
    else:
        print(f"  tokens and last logits [{batch}, {cfg.vocab_size}] "
              f"bit-equal to phase 5's (tolerance 0)")
    context = serve.context_len(inputs) + GEN
    stats["dry_run"] = _serve_dry_run(cfg, batch, context)
    for kind, d in stats["dry_run"].items():
        measured = (stats["prefill_ms"] if kind == "prefill"
                    else stats["decode_ms_per_step"])
        print(f"  dry run ({d['dry_run_s']:.1f} s on fake tensors) {kind}: "
              f"{d['flops'] / 1e12:.3f} TFLOP of products, "
              f"{(d['argument_bytes'] + d['output_bytes']) / 1e9:.3f} GB "
              f"of arguments and outputs; H100 bound {d['bound_ms']:.3f} ms "
              f"({d['dominant']}) against {measured:.3f} ms measured")
    return stats


def main() -> None:
    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config

    built = phase_build()
    kernels = phase_kernels(get_config("qwen2-7b"), built)
    phase_reference()
    serves = {}
    for arch, *shape in SERVES:
        serves[arch] = phase_serve(arch, *shape)
        torch.cuda.empty_cache()
    trains = {}
    for arch, *shape in TRAINS:
        trains[arch] = phase_train(arch, *shape)
        torch.cuda.empty_cache()
    grad = phase_grad(trains[GRAD_ARCH])
    torch.cuda.empty_cache()
    engine = phase_engine()
    sweep = phase_sweep()
    figures = phase_figures(smi)
    torch.cuda.empty_cache()
    layouts = phase_layouts(trains[LAYOUT_ARCH])
    torch.cuda.empty_cache()
    serve_layouts = phase_serve_layouts(serves[SERVES[0][0]])
    for st in serves.values():
        st.pop("_out")
    paths = {**{f"serve {arch}": st["launches"] for arch, st in serves.items()},
             **{f"train {arch}": st["launches"] for arch, st in trains.items()},
             f"train {GRAD_ARCH} --compress": grad["compress"]["launches"],
             f"train {GRAD_ARCH} DP step": grad["dp"]["launches"],
             f"train {LAYOUT_ARCH} sharded (1x1 mesh)": layouts["launches"],
             f"serve {SERVES[0][0]} on a 1x1 mesh":
             serve_layouts["launches"]}
    for entry in kernels:
        by_path = {path: counts[entry["name"]] for path, counts in paths.items()}
        if not any(by_path.values()):
            fail(f"{entry['name']} launched on no main path")
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
    print("[11/11] summary")
    print(json.dumps({"serve": serves}))
    print(json.dumps({"train": trains}))
    print(json.dumps({"grad": grad}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"engine": engine}))
    print(json.dumps({"sweep": sweep}))
    print(json.dumps({"figures": figures}))
    print(json.dumps({"layouts": layouts}))
    print(json.dumps({"serve_layouts": serve_layouts}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
