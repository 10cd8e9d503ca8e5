"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py

Phases, in the order they run (11, 12 and 13 run between 9 and 10, 14
and 15 after 10); any
failure raises and the script exits nonzero.  Each phase prints its wall
time.

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions.
   There must be a CUDA device.
2. build: the port's kernels K1 (its bf16 tensor-core kernel with its
   plain and LSE entry points, its bf16 backward, its fp32 kernel and its
   fp32 backward, both 3xTF32 on the tensor cores), K2 and K3 (its forward
   and its backward) from their sources in this checkout, one ``nvcc`` per
   source, all started together; ``ptxas``' registers, spills and the
   dynamic shared memory of K1's kernels (both instantiations of the bf16
   forward), of its backwards' launches, of K3's three launches (with
   their grids at mamba2-370m's shape in bf16 and at its training shape
   in fp32) and of K3's five backward launches in both dtypes (with their
   grids at mamba2-370m's training shape, and the blocks an SM of its
   chunk-term and tile launches from
   ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); the TF32
   tensor-core instructions (``HMMA.1688.F32.TF32`` in ``cuobjdump
   -sass``) of each fp32 kernel, K3's fp32 launches and both of K3's
   backward tile launches among them (beside their ``FFMA`` count), and
   the wgmma ones (``HGMMA``) of the bf16 backward's tile kernels, which
   must not be 0, with those kernels' threads, registers and dynamic
   shared memory; ptxas must report no spill in them nor in K3's forward
   or backward.
3. K1 (flash attention) against its plain version on the card, at the
   shapes and tolerances of ``repro_torch.kernels.cases``: the JAX
   package's FLASH_CASES shapes in fp32 (tolerance 2e-5; the fp32 kernel,
   3xTF32, against a plain version with TF32 off) and bf16 (5e-2; the
   bf16 kernel), ragged
   sequence lengths, TENSOR_CORE_CASES (the tensor-core kernel's corners),
   and the main path's shape -- q [1, 32, S, 128], k/v [1, 8, S, 128],
   causal, bf16, at S = 1024 and 2048, contiguous and in the model's
   strided layout, at a tighter limit (1e-2 elementwise, rms error under
   2e-4 of the output's rms).  It counts each route's launches.  At the
   main path's shape it times the kernel, its plain version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls)
   with CUDA events, prints the TFLOP/s of both, and computes the least
   time the card could take.  The batched path's shapes (BATCHED_MAIN_CASES:
   8 rows at S 1024 and 256) are held at the same limits and timed the same
   way.
4. K3 (SSD scan) against its plain version (the token recurrence): the JAX
   package's SSD_CASES, ragged ones and the corners of the chunk-parallel
   kernel's tiles (SSD_CORNER_CASES), y with max error over max |ref|
   below 1e-4 in fp32 and 5e-2 in bf16, the fp32 final state below 1e-4.
   At mamba2-370m's shape (b 1, S 1024, H 32, P 64, N 128, chunk 256,
   bf16), with the JAX test's dt and with a slowly decaying state that
   carries across chunks, y is also held elementwise and by rms and the
   state by rms (SSD_MAIN_TOLERANCE, SSD_MAIN_RMS_LIMIT and
   SSD_STATE_RMS_LIMIT); the model's chunked form passes those limits,
   and with the state it carries between chunks scaled by 0.99 it must
   fail them while it passes the JAX one.  It prints the readings, times
   kernel and plain version (no single PyTorch call computes this
   function), and times the kernel at S 1025 (chunk 256, a one-token last
   chunk), which may take at most 1.2x its time at S 1024.  The batched
   path's shape (SSD_BATCHED_MAIN_CASE, b 8) is held at the main limits and
   timed too.  K3's fp32 route (3xTF32, what every fp32 Mamba2 train step
   runs) is held the same way, with y at the fp32 limit, at
   SSD_FP32_MAIN_CASES (the training shape, b 8 x S 256; S 1024 at 32 and
   at jamba's 256 heads), and timed beside its plain version and its bound.
5. K2 (decode attention) against its plain version: DECODE_CASES, ragged
   ones and the corners of its split (DECODE_CORNER_CASES; 2e-5 in fp32,
   5e-2 in bf16), stale slots past ``index`` set to +-99, and qwen3-4b's
   decode shape read strided from a [B, S, Hkv, D] cache, held at
   DECODE_MAIN_TOLERANCE and DECODE_MAIN_RMS_LIMIT on eight draws, where it
   times the kernel (clusters of 16 blocks), its plain version and
   ``scaled_dot_product_attention`` with the L2 cache flushed before each
   launch (a decode step finds the cache cold).
6. full-width qwen3-4b (36 blocks, bf16, random weights from a seed): one
   block's attention sublayer with the kernel against the same sublayer
   with the plain attention (rms of the difference over rms of the plain
   output), then a ``ServingEngine`` with 4 stages under ODIN serves
   closed-loop queries of 1024 tokens with a 3x slowdown on one stage's
   device for queries 8-19.  It must rebalance, move blocks off the slowed
   stage, conserve blocks, and run every block's attention through K1's
   tensor-core kernel.  A clean query's block time is printed beside the
   one measured when K1 ran bf16 on the CUDA cores.  Then one query
   through ``Model.prefill`` into a cache of 1024 slots is timed (host
   clock, synchronised) with the peak memory around it, for phase 15c.
7. full-width mamba2-370m (48 blocks, bf16, random weights from seed 0):
   K3 at block 0's own scan inputs against the plain scan, with the
   model's dt_bias and with dt_bias drawn as Mamba2's reference init draws
   it, and block 0's Mamba2 sublayer with K3 against the same sublayer with
   the plain scan; then the same
   ODIN serve as phase 6: it must rebalance, move blocks off the slowed
   stage, conserve blocks, launch K3 48 times per query, and give logits
   that do not depend on the stage split.
8. the cached path at full width: qwen3-4b prefills 1024 tokens into a
   2048-slot cache (K1), then decodes 16 tokens (K2, 36 x 16 launches);
   the decode logits are held against the same steps with the plain
   attention, and the prefill's last logits against ``forward``'s.
   mamba2-370m prefills 1024 tokens (K3 with its final state) and decodes
   8; its first decoded logits are held against ``forward``'s, and the
   forward over 1025 tokens (chunk 256 with a one-token last chunk) is
   timed beside the one over 1024.
9. batched and open-loop serving at full width: qwen3-4b and mamba2-370m,
   each on 4 stages under ODIN (alpha 3), serve 32 queries of bimodal
   length (256 or 1024 tokens, a quarter long), bursty arrivals calibrated
   from a closed-loop probe, continuous batching (buckets pow2:256:1024,
   up to 8 rows), with a 3x slowdown on stage 1 for queries 8-20.  Every
   query must be served, ODIN must rebalance and move blocks off stage 1,
   batches must form and at least one query must join a batch in flight,
   every warmed shape must lie in the power-of-two rows x used bucket
   edges family, a second serve must need no warm-up, and the kernel's
   launches must equal the block forwards the executor ran (dispatches x
   blocks, plus each join's catch-up blocks), K1's all on its tensor-core
   kernel.  It prints the summary, the dispatches, occupancy and padding,
   the same arrivals served drained, unbatched and with exploration trials
   riding batches, one drained burst of 8 long queries against the same 8
   served one at a time (host clock and trace clock), one block at 8 x 1024
   tokens (CUDA events), the card's busy share over a drained burst and
   over one query (``torch.profiler``), and the logits of a batch's padded
   rows against each query served alone, which must stay within
   BATCHED_LOGITS_RMS_LIMIT.
11. the rest of the scheduler side, on phase 6's qwen3-4b and traffic
   (run right after phase 9, while qwen3-4b is loaded), every serve
   through ``repro_torch.api.run(RunSpec(engine=...))`` with K1 on its
   tensor-core kernel once per block and query:
   a. the hybrid policy: it must rebalance and move blocks off the slowed
      stage; printed beside phase 6's ODIN run (rebalances, serial_frac,
      mean latency, committed configs);
   b. the DP oracle live, ``OraclePolicy`` with a solver built here
      (``optimal_partition`` over a database with one column per EP, the
      estimated block times times that EP's slowdown): serial_frac must be
      0 and blocks must move off the slowed stage; its bottleneck is
      printed beside 11a's;
   c. ODIN on a modelled mesh of 8 devices (``MeshOdinExplorer``), a
      collective cost of a quarter of the measured mean block time, and a
      3x collective contention window on top of the compute slowdown:
      every assignment must sum to 8 with each stage at least 1 and every
      collective share lie in [0, 1); the modelled bottleneck is printed
      beside the host-clock service latency;
   d. ``measure_block_times`` over the 36 blocks at 1 x 1024 tokens makes
      a ``transformer_database``, simulated for 2000 queries under odin,
      lls, hybrid, oracle and none (each mean throughput as a share of the
      oracle's, which no policy may beat; odin's chunked and scalar runs
      must be equal), then under odin and oracle on a mesh of 8;
   e. the paper's measured interference database (§3.3,
      ``repro_torch.launch.measured_db.measure``) on 11d's executor and
      tokens: the 36 blocks timed 3 times alone and under each Table-1
      stressor row (CPU busy-loops and 64 MiB memory streamers in 1-16
      spawned processes) and each card co-tenant row (a bf16 8192 x 8192
      matmul loop, a 2 GiB HBM copy loop, 1 and 2 processes), K1 on its
      tensor-core kernel 15 x 3 x 36 times.  The (36, 15) database of
      minima, finite and positive, with the reference's 11 names first,
      is saved under ``build/`` and must load back equal; each row's mean
      and median over the passes, the co-tenants' start-up times, card
      memory and iteration rates before and during timing, the compute
      mode, the MPS finding and the host's CPUs are printed, and column
      0's sum beside 11d's (not gated); then 11d's policy comparison over
      it, each share beside 11d's.
   It prints K1's launches in phase 11.
10. the MoE and embedding-input families, each model alone on the card
   (the earlier phases' parameters are freed first), with each model's
   peak device memory:
   0. the kernels at these paths' shapes and at qwen2-0.5b's (phase 12's
      small pool) (``FAMILY_MAIN_CASES``,
      ``DECODE_FAMILY_MAIN_CASES``, ``SSD_FAMILY_MAIN_CASES``) against
      their plain versions at the main limits, timed beside the plain
      versions and the library call;
   a. full-width deepseek-moe-16b (28 blocks, 64 routed experts top-6 and
      2 shared, bf16): block 0's attention with K1 against the plain
      attention, the mean ``dropped_frac`` of one forward, one block and
      its MoE sublayer at 1 and 8 rows of 1024 tokens against their
      bounds; served under ODIN as in phase 6 (a rebalance, K1 28 times a
      query on the tensor cores); 8 long queries arriving at once served
      drained and one at a time, the rows of one dispatch against each
      query alone and 8 copies of one query against each other; the
      cached path (below) from 1024 tokens in 2048 slots, a decode step
      against its byte bound;
   b. full-width hubert-xlarge (an encoder, D 80): ``forward(embeds=)``
      over 1024 frames, K1 bidirectional in all 48 blocks, then 12
      closed-loop queries of fixed length served under ODIN;
   c. full-width llava-next-34b: ``forward(embeds=)`` over 2880 patch
      embeddings and 64 token embeddings, then the cached path from
      ``prefill(embeds=)`` into 4096 slots;
   d. mixtral-8x22b at full width cut to 4 of its 56 blocks: the cached
      path from a 4608-token prefill (past its 4096-token window) into 8192
      slots;
   e. jamba-1.5-large at its smoke width (one published block is 78.7
      GiB): forward, then the cached path, with K1, K3 and K2 in its
      block.
   A cached path holds the prefill's last logits against ``forward``'s,
   then decodes 16 tokens with K2 (timed), with K2 again from the same
   cache while every launch is held against the plain attention on the
   same inputs, and with the plain attention, whose logits the timed
   run's are held against (DECODE_RMS_LIMIT).  Forwards and prefills run
   the same check of every K1 and K3 launch against the plain version.
12. fleets, admission control, faults and QoS tiers (run after phase 11,
   while qwen3-4b is loaded, with full-width qwen2-0.5b loaded beside it),
   every serve through ``serve_cluster`` or the engine's ``serve``; the
   rates, SLOs and fault windows come from a closed-loop probe of one
   clean replica, since the replicas take turns on the one card:
   a. 4 qwen3-4b replicas sharing one executor, a 3x slowdown on stage 1
      of replica 2 only, bursty traffic at 0.8x the probe's fleet rate:
      round_robin, odin_aware, and odin_aware with fleet rebatching
      (``max_batch`` 4, through ``run_batch``).  Every query is served
      exactly once, and odin_aware routes fewer queries to replica 2 than
      round_robin;
   b. the fleet's own capacity C, the completion rate of a drained burst
      of 48 queries through 4 fresh replicas (odin_aware); the fleet at
      2 max(C, R) under slo_shed (an SLO of 3 probe services), then queue_cap, and one
      engine under slo_shed at 2x one replica's probe rate: queries are
      shed, served + shed = offered, and the executors run exactly the
      served queries;
   c. 2 qwen3-4b and 2 qwen2-0.5b replicas (pool ``small``), tiers
      interactive and best_effort, overloaded: downgrade with value_shed,
      then edf.  The summary has every per-tier key, only best_effort is
      downgraded, and the small pool runs K1 at qwen2-0.5b's shape;
   d. a crash of replica 0 for 10 probe services on the arrival clock and
      a flaky window over the run (p 0.1), round_robin (replica 0 takes
      one of the window's first four admitted queries), retries 3 and
      hedging after 2 services, then retries 0: replica 0 took at least
      one query that arrived in its window and failed on the crash (the
      count is printed), its breaker opens and is probed after its window,
      no query served by replica 0 arrived in its window,
      ``on_recover`` fires once per breaker probe,
      availability with retries is at least 0.99 and above the no-retry
      run's, completed + failed = admitted.  Then one engine under the
      query-indexed plan ``crash@5+3,flaky@0+1000:p=0.2`` with retries 2,
      whose failed queries and retries must equal a deterministic
      stand-in's on the host.
   Every K1 launch of the phase is counted by shape (it must equal the
   blocks times the forwards each executor ran), and the first launch of
   each distinct shape is held against the plain version on its own
   inputs at the main limits.
13. training (run after phase 12, with phase 12's models freed first),
   each model's peak device memory printed:
   a. K1's backward (``csrc/flash_attention_bwd.cu``) against the plain
      backward (autograd through the plain attention, TF32 off) on
      BACKWARD_CASES: dq, dk and dv each within BACKWARD_LIMIT of max |ref|;
      the fp32 forward's LSE entry point bit-equal to its plain entry
      point.  Both timed at the training shape (8, 14, 2, 256, 64) and at
      (1, 14, 2, 1024, 64) beside the plain version, fp32
      ``scaled_dot_product_attention`` and autograd's backward of it (a
      yardstick the port never calls), with the operations they execute
      (TFLOP/s) and two bounds: the fp32 CUDA-core peak's and three TF32
      products' at the tensor-core peak (the lesser is the row's bound);
      then K1's bf16 backward (``csrc/flash_attention_bwd_bf16.cu``) on
      BACKWARD_BF16_CASES against the plain backward on the same bf16
      inputs, within BACKWARD_BF16_LIMIT of max |ref| and
      BACKWARD_BF16_RMS_LIMIT of its rms (BACKWARD_BF16_ZERO_ATOL where
      the plain gradient is exactly 0), the bf16 LSE entry's output
      bit-equal to the plain entry point's and its LSE the rows'
      log-sum-exp of the plain fp32 scores to 1e-4; two backward calls
      give the same bits; both timed at (8, 14, 2, 256, 64), (1, 14, 2,
      1024, 64) and (1, 32, 8, 1024, 128) beside the plain version, bf16
      sdpa and autograd's backward of it, the bound (the needed products
      at the bf16 peak, or the bytes) and the executed TFLOP/s, with the
      delta launch alone; then K3's backward (``csrc/ssd_scan_bwd.cu``)
      on SSD_BACKWARD_CASES (every forward case and the main, training
      and smoke shapes, in both dtypes), each with the JAX test's dt and
      a slowly decaying one and random dy and dstate, against the plain
      backward (autograd through the token recurrence): each of dx, ddt,
      dA, dB and dC within SSD_BACKWARD_LIMIT of max |ref| (fp32) or
      SSD_BACKWARD_BF16_LIMIT and SSD_BACKWARD_BF16_RMS_LIMIT (bf16), two
      calls bit-equal; timed at SSD_BACKWARD_TIMED (the training shape,
      mamba2-370m's heads over 1024 tokens, jamba-1.5-large's) in both
      dtypes beside the plain backward and the bound, with each launch's
      device time (``torch.profiler``);
   b. full-width qwen2-0.5b (24 blocks, 0.63 B parameters) in fp32 with
      remat per block, batches of ``SyntheticLM(vocab, 256, 8, seed=0)``:
      step 0's loss and every gradient leaf with K1 against the same with
      ``impl="ref"``; then ``train`` for 30 steps (every loss finite, the
      mean of the last 5 below step 0's), K1 counting exactly 2 x 24 x 30
      fp32 forward launches, 24 x 30 LSE launches and 24 x 30 backward
      launches and no bf16 one; the checkpoint after step 30 loads back
      bit-equal and one more step from it equals the step without the
      reload; the median step time, tokens/s, TFLOP/s from
      ``launch/analytic.py``, the card's busy share over one step and K1's
      forward and backward shares (``torch.profiler``);
   c. one train step of deepseek-moe-16b, mixtral-8x22b (window 64),
      hubert-xlarge (bidirectional, embeddings) and llava-next-34b
      (embeddings) at smoke width, K1 against the plain attention at b's
      limits, then one bf16 step of deepseek-moe-16b and mixtral-8x22b
      (K1's bf16 kernels) at e's limits; mamba2-370m and jamba-1.5-large
      (K3's forward and backward; K1 in jamba's attention sublayer) one
      fp32 step at b's limits and one bf16 step at e's, where in bf16 a
      leaf may also differ by as much as the plain version's own bf16
      gradient differs from its fp32 one (jamba's reach 0.26), K3
      launching its forward twice and its backward once per Mamba2
      sublayer and step;
   d. ``python -m repro_torch.launch.train --arch qwen2-0.5b --full
      --steps 20``;
   e. full-width qwen2-0.5b in bf16, ``train(..., dtype=torch.bfloat16)``
      at b's data and optimizer: step 0's loss and every gradient leaf with
      K1's bf16 kernels against ``impl="ref"`` (TRAIN_BF16_LOSS_RTOL,
      TRAIN_BF16_GRAD_RMS_LIMIT), 30 steps with every loss finite and the
      mean of the last 5 below step 0's, exactly 2 x 24 x 30 bf16 forward
      launches (24 x 30 of them LSE launches) and 24 x 30 bf16 backward
      launches and no fp32 one; the median step time, tokens/s, TFLOP/s,
      the busy share, K1's shares, the five kernels with the most device
      time and the peak memory, beside b's fp32 numbers;
   f. full-width mamba2-370m (48 blocks, 0.42 B parameters) in fp32 with
      remat per block at b's data, optimizer and steps: step 0's loss and
      every gradient leaf with K3 against ``impl="ref"`` at b's limits; 30
      steps (every loss finite, the mean of the last 5 below step 0's), K3
      counting exactly 2 x 48 x 30 forward and 48 x 30 backward launches;
      the median step time, tokens/s, TFLOP/s from ``launch/analytic.py``,
      the busy share, K3's forward and backward shares (and each backward
      launch's; the backward's device time a step beside the 63.9 ms its
      first design, fp32 FMA on the CUDA cores, took there), the five
      kernels with the most device time and the peak memory.
14. the SPMD stage pipeline (``repro_torch.pipeline.spmd``), the
   earlier models freed: full-width qwen3-4b (bf16, seed 0) is drawn once
   in this process and shared with 4 spawned gloo ranks on this card
   through CUDA IPC; each rank keeps its tile of 18 blocks and runs the
   GPipe schedule over 4 microbatches of 1 x 1024 tokens, 3 times under
   each of [9,9,9,9], [6,12,9,9] and [12,0,12,12] (one stage empty),
   handing activations on through host buffers.  Every rank's outputs
   must be bit-equal to this process's blocks run in order on the same
   microbatches, and ``SpmdPipelineExecutor.run_query`` over 3 rows (one
   padding row) on [12,0,12,12] bit-equal to
   ``LocalPipelineExecutor.run_query`` over the 3 rows at once.  Every
   rank must launch K1's tensor-core kernel its blocks x 4 times a run.
   It prints each config's time (the slowest rank's, host clock) beside
   the single process's, the repack of [9,9,9,9] -> [6,12,9,9] (time and
   bytes), each rank's hand-offs, host-buffer copies and peak memory.
   A rank that raises fails the phase.
15. the device examples and the dry run, the earlier models freed:
   a. ``examples/serve_interference_torch.py``'s ``main`` at its defaults
      (8 smoke-width qwen3-4b blocks in fp32, 80 queries of 128 tokens:
      odin, lls, hybrid and none, bursty at max_batch 1 and 8, drain and
      continuous batching over mixed lengths): every section serves every
      query, each scheduler's summary and the batched against unbatched
      accounting are printed, every K1 launch is the fp32 kernel's (its
      plain entry point), counted by shape, each shape's first launch held
      against the plain version at the fp32 tolerance (2e-5);
   b. ``examples/train_small_torch.py``'s ``main`` (qwen3-100m, 300 steps
      of 4 x 128 tokens in fp32, checkpoints at steps 100 and 200 under
      ``build/``, deleted after): the loss falls, K1 launches its fp32
      forward 2 x 8 x 300 times (half of them the LSE entry) and its
      backward 8 x 300 times, the first launch of each entry point and of
      the backward held against the plain version on its inputs (2e-5;
      dq, dk, dv at 1e-4 of max |ref|); the median step time, tokens/s,
      the peak memory;
   c. ``launch/dryrun.py`` on the meta device for 13b, 13e, 13f and a
      phase-6 prefill of qwen3-4b (1 x 1024, timed in phase 6): the
      predicted argument bytes and peak beside ``max_memory_allocated``,
      the roofline bound beside the measured step, and step_mfu (analytic
      FLOPs over the step time times the dtype's peak) beside its
      prediction; a step_mfu above 1.05 fails the phase.
16. the total time, the card line again, one ``{"kernels": [...]}`` line,
   and last ``{"ok": true, "device": {...}}``.

Bounds use the H100 SXM data-sheet peaks (``repro_torch/launch/roofline.py``):
989 TFLOP/s dense bf16 on the tensor cores and 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.llava_next_34b import NUM_PATCH_TOKENS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import decode_attention as k2_lib  # noqa: E402
from repro_torch.kernels import flash_attention as k1_lib  # noqa: E402
from repro_torch.kernels import ssd_scan as k3_lib  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    BACKWARD_BF16_CASES,
    BACKWARD_BF16_LIMIT,
    BACKWARD_BF16_LONG_CASE,
    BACKWARD_BF16_RMS_LIMIT,
    BACKWARD_BF16_TRAIN_CASE,
    BACKWARD_BF16_WIDE_CASE,
    BACKWARD_BF16_ZERO_ATOL,
    BACKWARD_CASES,
    BACKWARD_LIMIT,
    BACKWARD_LONG_CASE,
    BACKWARD_TRAIN_CASE,
    BATCHED_MAIN_CASES,
    DECODE_CASES,
    DECODE_CORNER_CASES,
    DECODE_FAMILY_MAIN_CASES,
    DECODE_MAIN_CASE,
    DECODE_MAIN_RMS_LIMIT,
    DECODE_MAIN_TOLERANCE,
    DECODE_RAGGED_CASES,
    FAMILY_MAIN_CASES,
    FLASH_CASES,
    MAIN_CASES,
    MAIN_RMS_LIMIT,
    MAIN_TOLERANCE,
    RAGGED_CASES,
    SSD_BACKWARD_CASES,
    SSD_BACKWARD_TIMED,
    SSD_BACKWARD_TRAIN_CASE,
    SSD_BATCHED_MAIN_CASE,
    SSD_CASES,
    SSD_CORNER_CASES,
    SSD_FAMILY_MAIN_CASES,
    SSD_FP32_MAIN_CASES,
    SSD_MAIN_CASE,
    SSD_MAIN_RMS_LIMIT,
    SSD_MAIN_TOLERANCE,
    SSD_RAGGED_CASES,
    SSD_STATE_RMS_LIMIT,
    TENSOR_CORE_CASES,
    bf16_backward_check,
    max_ratio,
    ssd_backward_check,
    ssd_limit,
    tolerance,
)
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    decode_attention_ref,
    flash_attention_bwd_ref,
    flash_attention_ref,
    ssd_scan_bwd_ref,
    ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import blocks as blk  # noqa: E402
from repro_torch.models import mamba2 as mamba_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.core import (  # noqa: E402
    InterferenceEvent,
    LayerDatabase,
    generate_events,
    optimal_partition,
    transformer_database,
)
from repro_torch.core.mesh import MeshSpec  # noqa: E402
from repro_torch.models.layers import embed, rms_norm  # noqa: E402
from repro_torch.launch.mesh import spawn_ranks  # noqa: E402
from repro_torch.pipeline import (  # noqa: E402
    LocalPipelineExecutor,
    MeasuredTimeSource,
    SpmdPipelineExecutor,
    make_pipeline_fn,
    stage_mesh,
    stage_tile,
)
from repro_torch.pipeline.executor import next_pow2  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import engine as engine_lib  # noqa: E402
from repro_torch.cluster import cluster as cluster_lib  # noqa: E402
from repro_torch.cluster import serve_cluster  # noqa: E402
from repro_torch.faults.health import (  # noqa: E402
    HALF_OPEN,
    OPEN,
    HealthTracker,
)
from repro_torch.schedulers import OraclePolicy, make_scheduler  # noqa: E402
from repro_torch.schedulers.runtime import (  # noqa: E402
    RebalanceRuntime,
    RuntimeStep,
)
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import measured_db  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW,
    PEAK_BF16_FLOPS,
    PEAK_FP32_FLOPS,
    PEAK_TF32_FLOPS,
)
from repro_torch.launch.analytic import analytic_cost  # noqa: E402
from repro_torch.launch.stressors import (  # noqa: E402
    card_scenarios,
    scenarios_table1,
)
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    init_adamw,
    make_train_step,
    train,
)
from repro_torch.training.checkpoint import (  # noqa: E402
    flatten,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.training.data import SyntheticEmbeds, SyntheticLM  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    loss_and_grads,
    to_batch,
)
from repro_torch.workloads import (  # noqa: E402
    QueryRecord,
    make_lengths,
    make_workload,
    resolve_batching,
    run_pipeline,
)

KERNELS = ("flash_attention_bf16", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_bf16", "decode_attention", "ssd_scan",
           "ssd_scan_bwd")
# A clean query's block time with the first designs of K1 (bf16 on the fp32
# CUDA cores) and K3 (one block per head), chip_smoke.py on an NVIDIA H100
# 80GB HBM3 at 700 W, printed beside this run's.
EARLIER_BLOCKS_MS = {"qwen3-4b": 54.99, "mamba2-370m": 60.27}
# K3 over S + 1 positions at most this many times its time over S (the
# JAX chunk rule cost about 21x on the whole mamba2-370m forward).
CHUNK_CLIFF_LIMIT = 1.2
DECODE_MAIN_DRAWS = 8         # draws of K2's main case held at its limits
SPIN_CYCLES = 1_000_000       # about 0.5 ms at the H100's 1.98 GHz boost

SEQ = 1024                    # tokens per served query (the main path)
NUM_QUERIES = 24
SLOW_EP, SLOW_FROM, SLOW_TO, SLOW_FACTOR = 1, 8, 20, 3.0
# A full-width attention sublayer (K1 then wo) with the kernel against the
# same sublayer with the plain attention: rms of the difference over rms of
# the plain sublayer's output: about 5x the 2.0e-4 measured on an NVIDIA
# H100 80GB HBM3 at 700 W.
SUBLAYER_RMS_LIMIT = 1e-3
# The same for block 0's Mamba2 sublayer (K3 against the token recurrence)
# and for block 0's attention sublayer at the first decode step (K2 against
# the plain attention, on copies of one prefilled cache).  The Mamba2
# sublayer reads exactly 0 on an NVIDIA H100 80GB HBM3 at 700 W: with the
# random weights the scan's y (rms about 1e-5) vanishes in bf16 beside the
# skip term D x, so this is only a check that the sublayer runs and stays
# finite; K3 is held at block 0's own scan inputs by SSD_MAIN_RMS_LIMIT.
MAMBA_SUBLAYER_RMS_LIMIT = 1e-3
DECODE_SUBLAYER_RMS_LIMIT = 1e-3
# The cached path: 2048 cache slots, a 1024-token prompt, 16 decode steps
# (qwen3-4b) and 8 (mamba2-370m).
CACHE_LEN, DECODE_STEPS, MAMBA_DECODE_STEPS = 2048, 16, 8
# qwen3-4b's decode logits with K2 against the same steps with the plain
# attention, rms of the difference over rms of the plain logits: about 5x
# the 1.98e-2 measured (NVIDIA H100 80GB HBM3, 700 W).  The random bf16
# model amplifies one-ulp differences of the attention output through 36
# blocks; the sublayer check above isolates K2.
DECODE_RMS_LIMIT = 1e-1
# Prefill's last logits against forward's at the same position (the same
# kernels on the same inputs: measured 0).
PREFILL_RMS_LIMIT = 1e-3
# mamba2-370m's first decoded logits (bf16 state in the cache, one step of
# the bf16 recurrence) against forward's at the same position (K3): about
# 5x the 2.64e-2 measured (NVIDIA H100 80GB HBM3, 700 W).
MAMBA_DECODE_RMS_LIMIT = 1.3e-1
# Phase 9: batched and open-loop serving.  32 queries of bimodal length
# (256 or 1024 tokens, p_long 0.25, seed 0), buckets pow2:256:1024, up to 8
# rows a dispatch, continuous batching; bursty arrivals calibrated from a
# 4-query closed-loop probe at SEQ tokens (tests/test_serving.py's kwargs);
# a 3x slowdown on stage 1 for queries 8-20.
BATCH_QUERIES, MAX_BATCH, BUCKETS = 32, 8, "pow2:256:1024"
SHORT, LONG, P_LONG = 256, 1024, 0.25
BATCH_SLOW_FROM, BATCH_SLOW_TO = 8, 21
# A continuous dispatch's rows (padded to their bucket edge, one of them
# joined mid-flight) against each query served alone: rms of the logits'
# difference over the real positions, over the rms of the logits alone.
# Both models read exactly 0 on an NVIDIA H100 80GB HBM3 at 700 W (the
# rows are bit-equal); the limit admits the 2e-2 that one-ulp roundings
# reach through 36 random bf16 blocks (the decode check's reading) and
# fails a row that reads its padding or another row (order 1).
BATCHED_LOGITS_RMS_LIMIT = 1e-1
# Phase 10: the MoE and embedding-input families.  hubert-xlarge serves 12
# closed-loop queries of SEQ frames; llava-next-34b reads 2880 patch
# embeddings and 64 token embeddings into a 4096-slot cache;
# mixtral-8x22b keeps 4 of its 56 blocks and prefills 4608 tokens, past
# its 4096-token window, into 8192 slots; every cached path decodes 16.
HUBERT_QUERIES = 12
LLAVA_TEXT, LLAVA_CACHE = 64, 4096
MIXTRAL_BLOCKS, MIXTRAL_SEQ, MIXTRAL_CACHE = 4, 4608, 8192
FAMILY_DECODE_STEPS = 16

# Phase 11: the rest of the scheduler side over phase 6's traffic.  11c's
# collective cost per block is MESH_COLL_FRACTION of the measured mean
# clean block time (11a's estimates), on MESH_DEVICES modelled devices, and
# a coll_factor_schedule multiplies collective time by MESH_CF for queries
# MESH_CF_FROM..MESH_CF_TO, inside the compute slowdown.  11d simulates
# SIM_QUERIES queries over a database built from block times measured here.
MESH_DEVICES, MESH_COLL_FRACTION = 8, 0.25
MESH_CF_FROM, MESH_CF_TO, MESH_CF = 12, 20, 3.0
SIM_QUERIES = 2000
SIM_POLICIES = ("odin", "lls", "hybrid", "oracle", "none")
# 11e: measured_db's passes a scenario (the database keeps the minimum).
MDB_REPEATS = 3

# Phase 12: fleets of FLEET_REPLICAS qwen3-4b engines sharing one executor,
# serving queries of SEQ tokens.  Rates, SLOs and fault windows come from a
# closed-loop probe of one clean replica (service latency s, fleet rate
# R = FLEET_REPLICAS / s), since every replica runs on this one card.
# 12a: bursty at FLEET_LOAD x R, SLOW_FACTOR on stage SLOW_EP of replica
# FLEET_SLOW_REPLICA, FLEET_QUERIES queries (SHORT_QUERIES with fleet
# rebatching); 12b: poisson at FLEET_OVERLOAD x max(C, R), C the fleet's
# measured capacity (see BURST_RATE), slo_shed at FLEET_SLO_SERVICES x s over
# FLEET_QUERIES, queue_cap FLEET_QUEUE_CAP, and one engine under slo_shed
# at FLEET_OVERLOAD x R / FLEET_REPLICAS over SHORT_QUERIES; 12c: 2
# qwen3-4b and 2 SMALL_ARCH replicas at FLEET_OVERLOAD x R, SHORT_QUERIES;
# 12d:
# FAULT_QUERIES poisson arrivals at FAULT_LOAD x R, routed by FAULT_ROUTER,
# replica 0 down FAULT_CRASH_SERVICES x s from the arrival of query
# FAULT_QUERIES // 4, flaky at p FAULT_FLAKY_P throughout, and one engine
# under the query-indexed ENGINE_FAULTS.  Over six runs of 12a on the CPU at smoke
# width, odin_aware's share of 48 queries sent to the slowed replica read
# 0.125-0.25 (round_robin's is 0.25 by construction), of 96 0.18-0.23; and
# on an NVIDIA H100 80GB HBM3 at 700 W a queue at 2R over 48 queries
# stayed under slo_shed's SLO.
FLEET_REPLICAS, FLEET_PROBE_QUERIES = 4, 10
FLEET_QUERIES, SHORT_QUERIES = 96, 48
FLEET_SLOW_REPLICA, FLEET_LOAD, FLEET_MAX_BATCH = 2, 0.8, 4
FLEET_OVERLOAD, FLEET_SLO_SERVICES, FLEET_QUEUE_CAP = 2.0, 3.0, 2
# 12b's overload is FLEET_OVERLOAD x the larger of R and the fleet's own
# capacity C, the completion rate of a drained burst (poisson at
# BURST_RATE: every arrival within a millisecond) through the fleet as 12b
# routes it; C alone read 0.89-1.32 R on the H100, so the larger of the
# two never offers less than FLEET_OVERLOAD x either.
BURST_RATE = 1e5
SMALL_ARCH = "qwen2-0.5b"
FAULT_QUERIES, FAULT_LOAD, FAULT_CRASH_SERVICES = 64, 0.4, 10.0
FAULT_FLAKY_P, FAULT_RETRIES, FAULT_HEDGE_SERVICES = 0.1, 3, 2.0
# The breaker's cooldown outlasts the retry schedule (0.05 + 0.1 + 0.2 s):
# a retried query that arrived inside the window and lands on replica 0
# after it recovers crashes again (the fault clock is its arrival), and the
# breaker then keeps it off replica 0 for the rest of its retries.
FAULT_COOLDOWN, FAULT_MIN_AVAILABILITY = 0.4, 0.99
# 12d's subject is the breaker: round robin hands replica 0 one of the
# first four admitted queries of the window's 16 arrivals whatever the
# host's times; that dispatch fails on the crash, whose known recovery
# time then holds the breaker open to the window's end.  odin_aware
# follows measured times and in one run on the card sent it none (12a
# covers odin_aware).
FAULT_ROUTER = "round_robin"
ENGINE_FAULTS, ENGINE_RETRIES, ENGINE_FAULT_QUERIES = \
    "crash@5+3,flaky@0+1000:p=0.2", 2, 24

# Phase 13: training.  Full-width TRAIN_ARCH in fp32 with remat, batches of
# TRAIN_BATCH x TRAIN_SEQ tokens (the training CLI's defaults), TRAIN_STEPS
# steps of AdamW at TRAIN_OPT; step 0's loss with K1 against the plain
# attention to TRAIN_LOSS_RTOL, each gradient leaf's rms error to
# TRAIN_GRAD_RMS_LIMIT of its rms (set before the first run on the card).
# The families train one step at their smoke width over FAMILY_TRAIN_SEQ
# tokens (past mixtral's smoke window of 64); the CLI runs TRAIN_CLI_STEPS.
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = "qwen2-0.5b", 256, 8, 30
TRAIN_OPT = dict(lr=3e-4, warmup_steps=3, total_steps=30)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RMS_LIMIT = 1e-5, 1e-4
# 13e: the same in bf16, K1's bf16 kernels against the plain attention.
# Both sides round every product and activation to bf16, so a difference
# in one attention output moves the roundings after it.  The limits are
# bf16's own scale, the CPU test's port-against-JAX limits in bf16
# (tests/test_torch_training.py, readings 2.2e-5 in the loss and 1.5e-2 of
# a leaf's rms at smoke width), set before the first run on the card.
TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_GRAD_RMS_LIMIT = 2e-4, 5e-2
# 13c: the families that take a bf16 step (K1's bf16 kernels).
FAMILY_BF16_TRAIN_ARCHS = ("deepseek-moe-16b", "mixtral-8x22b")
FAMILY_TRAIN_ARCHS = ("deepseek-moe-16b", "mixtral-8x22b", "hubert-xlarge",
                      "llava-next-34b")
FAMILY_TRAIN_SEQ, TRAIN_CLI_STEPS = 128, 20
# 13c: the Mamba2 families take one fp32 and one bf16 step at their smoke
# width (K3's forward and backward kernels); 13f trains full-width
# MAMBA_TRAIN_ARCH in fp32 at TRAIN_ARCH's batches, optimizer and steps.
MAMBA_TRAIN_ARCHS = ("mamba2-370m", "jamba-1.5-large-398b")
MAMBA_TRAIN_ARCH = "mamba2-370m"
# K3's backward launches and the forward ones, by kernel name.
K3_FWD_KERNELS = ("ssd_chunk_states", "ssd_state_pass", "ssd_chunk_outputs")
K3_BWD_KERNELS = ("ssd_bwd_chunk_dstates", "ssd_bwd_state_pass",
                  "ssd_bwd_tiles", "ssd_bwd_chunk_finish", "ssd_bwd_sums")
# 13f's K3 backward device time a step (ms) when the backward's products
# ran as fp32 FMA on the CUDA cores (its first design; chip_smoke.py on an
# NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's.
K3_BWD_STEP_MS_CUDA_CORES = 63.9
# Phase 14: the SPMD stage pipeline.  SPMD_STAGES gloo ranks on this one
# card run full-width qwen3-4b (bf16, seed 0) with tiles of SPMD_CAP
# blocks over SPMD_MICROBATCHES microbatches of one row of SEQ tokens,
# under each of SPMD_CONFIGS (the last with one stage empty), each run
# SPMD_REPS times; then SpmdPipelineExecutor.run_query over
# SPMD_QUERY_ROWS rows (one padding row) on the last config.
SPMD_STAGES, SPMD_CAP, SPMD_MICROBATCHES, SPMD_REPS = 4, 18, 4, 3
SPMD_CONFIGS = ([9, 9, 9, 9], [6, 12, 9, 9], [12, 0, 12, 12])
SPMD_QUERY_ROWS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def randn(gen, shape, dtype: str):
    return torch.randn(shape, generator=gen,
                       device="cuda").to(getattr(torch, dtype))


def rms(t: torch.Tensor) -> float:
    return float(t.float().square().mean().sqrt())


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    return rms(got.float() - want.float()) / rms(want)


def compare(out: torch.Tensor, ref: torch.Tensor, tol: dict, what: str,
            rms_limit: float = None) -> dict:
    """Raises unless |out - ref| <= atol + rtol |ref| everywhere and, where
    ``rms_limit`` is given, rms(out - ref) <= rms_limit * rms(ref).
    Returns the max and rms error, the rms of ``ref`` and the least atol
    that would pass at this rtol."""
    torch.cuda.synchronize()
    diff = out.float() - ref.float()
    excess = diff.abs() - tol["rtol"] * ref.float().abs()
    got = dict(max_abs_err=float(diff.abs().max()), rms_err=rms(diff),
               rms_ref=rms(ref), atol_needed=max(float(excess.max()), 0.0))
    limit = tol["atol"] + tol["rtol"] * ref.float().abs()
    bad = (not bool(torch.isfinite(out.float()).all())
           or bool((diff.abs() > limit).any())
           or (rms_limit is not None
               and got["rms_err"] > rms_limit * got["rms_ref"]))
    if bad:
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version: {got} (limits {tol}, rms "
                             f"{rms_limit})")
    return got


def compare_max(out: torch.Tensor, ref: torch.Tensor, limit: float,
                what: str, rms_limit: float = None) -> dict:
    """The JAX SSD check: raises unless max |out - ref| / max |ref| <
    ``limit`` and, where ``rms_limit`` is given, rms(out - ref) <=
    rms_limit * rms(ref).  Returns the max and rms errors, max and rms of
    ``ref``, and the two ratios."""
    torch.cuda.synchronize()
    diff = out.float() - ref.float()
    got = dict(max_abs_err=float(diff.abs().max()), rms_err=rms(diff),
               max_ref=float(ref.float().abs().max()), rms_ref=rms(ref),
               rel=max_ratio(out, ref))
    got["rms_rel"] = got["rms_err"] / got["rms_ref"]
    if not (bool(torch.isfinite(out.float()).all()) and got["rel"] < limit
            and (rms_limit is None or got["rms_rel"] <= rms_limit)):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version: {got} (limit {limit}, rms "
                             f"{rms_limit})")
    return got


def time_ms(fn, reps: int = 30, warmup: int = 3, flush=None) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up;
    ``flush()`` runs before each timed launch, outside the timing.  A spin
    kernel of about 0.5 ms keeps the card busy while the host enqueues the
    start event and ``fn``'s launches, so the time between the events is
    the card's, not the host's enqueue time (for work whose enqueue takes
    longer than the spin, as in a loop of many small launches, it is not)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple:
    """(bound_ms, bound_by): the larger of the operations over the peak
    and the bytes over HBM's rate (``roofline.bound``), in ms."""
    seconds, by = roofline.bound(flops, nbytes, peak_flops)
    return 1e3 * seconds, by


def attention_pairs(S: int, causal: bool, window=None) -> int:
    """The (query, key) pairs a mask keeps."""
    if not causal:
        return S * S
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def attention_bound(B, Hq, Hkv, S, D, causal, elem_bytes,
                    window=None) -> tuple:
    """K1: operations over the bf16 peak, bytes (q, k, v read once, o
    written once) over HBM."""
    pairs = attention_pairs(S, causal, window)
    flops = 2 * 2 * B * Hq * pairs * D          # Q K^T and P V
    nbytes = (2 * Hq + 2 * Hkv) * B * S * D * elem_bytes
    return bound(flops, nbytes, PEAK_BF16_FLOPS)


def ssd_work(b, S, H, P, N, chunk, elem_bytes) -> tuple:
    """K3's (flops, bytes): x, dt, A, B, C read once, y and the fp32 final
    state written once; the products of the chunked form, C.B^T once per
    chunk (it is shared by the heads), per head the masked scores times
    x dt, the state update and, past the first chunk, the state read."""
    flops = 0
    for c0 in range(0, S, chunk):
        cl = min(chunk, S - c0)
        pairs = cl * (cl + 1) // 2
        flops += b * 2 * pairs * N
        flops += b * H * (2 * pairs * P + 2 * cl * P * N
                          + (c0 > 0) * 2 * cl * N * P)
    nbytes = ((2 * b * S * H * P + b * S * H + 2 * b * S * N + H)
              * elem_bytes + b * H * P * N * 4)
    return flops, nbytes


def ssd_executed(b, S, H, chunk, fp32: bool = False) -> int:
    """The operations K3 runs on the tensor cores: 64-row tiles, P padded
    to 64 and N to 128, C.B^T per head and key tile at or before the row
    tile, the products with an fp32 operand three times (the bf16 route's
    three bf16 terms; the fp32 route takes every product, C.B^T too, as
    three TF32 products)."""
    T, PP, NP = 64, 64, 128
    scores = 3 if fp32 else 1
    flops = 0
    for c0 in range(0, S, chunk):
        tiles = -(-min(chunk, S - c0) // T)
        flops += 3 * 2 * PP * NP * T * tiles             # the chunk's state
        flops += (c0 > 0) * tiles * 3 * 2 * T * NP * PP  # state read
        pairs = tiles * (tiles + 1) // 2                 # (row, key) tiles
        flops += pairs * (scores * 2 * T * T * NP + 3 * 2 * T * T * PP)
    return b * H * flops


def decode_work(B, Hq, Hkv, S, D, index, window, elem_bytes) -> tuple:
    """K2's (flops, bytes): the live slots of k and v read once, q read and
    o written once; two products over the live slots."""
    lo = 0 if window is None else max(index - window + 1, 0)
    live = min(index, S - 1) - lo + 1
    flops = 2 * 2 * B * Hq * live * D
    nbytes = (2 * B * Hq * D + 2 * B * Hkv * live * D) * elem_bytes
    return flops, nbytes


ROUTES = ("tensor_core_launches", "fp32_launches")


def reset_counts(wrapper) -> None:
    """Set every launch count of a kernel wrapper to 0."""
    for name in list(vars(wrapper)):
        if name.endswith("launches"):
            setattr(wrapper, name, 0)


def route_counts() -> dict:
    return {r: getattr(flash_attention, r) for r in ROUTES}


def kernel_label(mangled: str) -> str:
    """A K1 fp32 kernel's mangled name as ``function<template args>``."""
    name = re.search(r"\d(flash_fwd|bwd_tiles|bwd_delta|bwd_dkv_sum)",
                     mangled).group(1)
    args = re.findall(r"L[ib](\d+)E", mangled)
    return f"{name}<{', '.join(args)}>" if args else name


def hmma_counts(name: str, op: str) -> dict:
    """Each kernel of ``csrc/<name>.cu``'s library (mangled name) -> its
    tensor-core instructions ``op`` in ``cuobjdump -sass``: TF32 m16n8k8
    (``HMMA.1688.F32.TF32``) or Hopper's wgmma (``HGMMA``)."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.lib_path(name))], capture_output=True,
                          text=True, check=True).stdout
    return {part.split()[0]: part.count(op)
            for part in re.split(r"\n\s*Function : ", sass)[1:]}


def k3_label(mangled: str) -> str:
    """A K3 kernel's mangled name as ``function<float>`` (or
    ``<__nv_bfloat16>``, or the bare name of the state pass)."""
    name = next(k for k in K3_FWD_KERNELS if k in mangled)
    if "IfE" in mangled:
        return f"{name}<float>"
    return f"{name}<__nv_bfloat16>" if "bfloat16" in mangled else name


def ptxas_lines(nvcc_log: str) -> list:
    """One (entry function's mangled name, line) per entry function of an
    ``nvcc -Xptxas=-v`` log; the line gives its registers and spills."""
    lines = []
    for block in nvcc_log.split("Compiling entry function")[1:]:
        name = re.search(r"'(\S+)'", block).group(1)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        lines.append((name,
                      f"{regs.group(1) if regs else '?'} registers, "
                      f"{spill.group(1) if spill else '?'} B spill stores, "
                      f"{spill.group(2) if spill else '?'} B spill loads"))
    return lines


def phase_kernel_check() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    reset_counts(flash_attention)
    expected = {r: 0 for r in ROUTES}
    for case in FLASH_CASES + RAGGED_CASES + TENSOR_CORE_CASES:
        B, Hq, Hkv, S, D, causal, window, dtype = case
        q = randn(gen, (B, Hq, S, D), dtype)
        k = randn(gen, (B, Hkv, S, D), dtype)
        v = randn(gen, (B, Hkv, S, D), dtype)
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="cuda")
        expected[ROUTES[dtype != "bfloat16"]] += 1
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        got = compare(out, ref, tolerance(dtype), str(case))
        log(f"  K1 {case}: max |err| {got['max_abs_err']:.3e}, rms err / "
            f"rms ref {got['rms_err'] / got['rms_ref']:.3e}")
    log(f"  K1 launches by route over these cases: {route_counts()}")
    if route_counts() != expected:
        raise AssertionError(f"K1 routes: {route_counts()}, expected "
                             f"{expected} (bf16 on the bf16 kernel, fp32 on "
                             f"the fp32 kernel)")

    main = {}
    for case in MAIN_CASES:
        B, Hq, Hkv, S, D, _, _, dtype = case
        q = randn(gen, (B, Hq, S, D), dtype)
        k = randn(gen, (B, Hkv, S, D), dtype)
        v = randn(gen, (B, Hkv, S, D), dtype)
        before = route_counts()["tensor_core_launches"]
        got = compare(ops.flash_attention(q, k, v, impl="cuda"),
                      flash_attention_ref(q, k, v), MAIN_TOLERANCE,
                      f"main S={S}", MAIN_RMS_LIMIT)
        if route_counts()["tensor_core_launches"] != before + 1:
            raise AssertionError("the main shape did not run on the "
                                 "tensor-core kernel")
        # The model's layout: [B, S, H, D] projections, read in place.
        x = randn(gen, (B, S, Hq + 2 * Hkv, D), dtype)
        qs = x[:, :, :Hq].transpose(1, 2)
        ks = x[:, :, Hq:Hq + Hkv].transpose(1, 2)
        vs = x[:, :, Hq + Hkv:].transpose(1, 2)
        out = ops.flash_attention(qs, ks, vs, impl="cuda")
        strided = compare(out, flash_attention_ref(qs, ks, vs),
                          MAIN_TOLERANCE, f"main S={S} strided",
                          MAIN_RMS_LIMIT)
        log(f"  K1 main S={S}: contiguous {got}, strided {strided}, rms err "
            f"/ rms ref {got['rms_err'] / got['rms_ref']:.3e} and "
            f"{strided['rms_err'] / strided['rms_ref']:.3e} (limits "
            f"{MAIN_TOLERANCE}, rms {MAIN_RMS_LIMIT})")
        err = max(got["max_abs_err"], strided["max_abs_err"])
        if not out.transpose(1, 2).is_contiguous():
            raise AssertionError("kernel output is not in the model's "
                                 "[B, S, H, D] layout")
        kernel_ms = time_ms(lambda: ops.flash_attention(q, k, v,
                                                        impl="cuda"))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v))
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        bound_ms, bound_by = attention_bound(B, Hq, Hkv, S, D, True, 2)
        flops = 4 * B * Hq * D * (S * (S + 1) // 2)
        fp32_ms = 1e3 * flops / PEAK_FP32_FLOPS
        main[S] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
        log(f"  K1 main S={S}: max |err| {err:.3e}  kernel_ms {kernel_ms:.4f}"
            f"  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}"
            f"  bound_ms {bound_ms:.5f} ({bound_by}; {flops / 1e9:.2f} GFLOP;"
            f" TFLOP/s achieved: kernel {flops / kernel_ms / 1e9:.1f}, "
            f"scaled_dot_product_attention {flops / library_ms / 1e9:.1f}; "
            f"the same products at the fp32 peak: {fp32_ms:.4f} ms)")

    # The batched path: a formed dispatch of 8 rows at a bucket edge.
    for case in BATCHED_MAIN_CASES:
        B, Hq, Hkv, S, D, _, _, dtype = case
        q = randn(gen, (B, Hq, S, D), dtype)
        k = randn(gen, (B, Hkv, S, D), dtype)
        v = randn(gen, (B, Hkv, S, D), dtype)
        before = route_counts()["tensor_core_launches"]
        got = compare(ops.flash_attention(q, k, v, impl="cuda"),
                      flash_attention_ref(q, k, v), MAIN_TOLERANCE,
                      f"batched B={B} S={S}", MAIN_RMS_LIMIT)
        if route_counts()["tensor_core_launches"] != before + 1:
            raise AssertionError(f"the batched shape {case} did not run on "
                                 f"the tensor-core kernel")
        kernel_ms = time_ms(lambda: ops.flash_attention(q, k, v,
                                                        impl="cuda"))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v), reps=10)
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        bound_ms, bound_by = attention_bound(B, Hq, Hkv, S, D, True, 2)
        flops = 4 * B * Hq * D * (S * (S + 1) // 2)
        main[(B, S)] = dict(max_abs_err=got["max_abs_err"], ms=kernel_ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        log(f"  K1 batched {case}: max |err| {got['max_abs_err']:.3e}, rms "
            f"err / rms ref {got['rms_err'] / got['rms_ref']:.3e} (limits "
            f"{MAIN_TOLERANCE}, rms {MAIN_RMS_LIMIT})  kernel_ms "
            f"{kernel_ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
            f"{library_ms:.4f}  bound_ms {bound_ms:.5f} ({bound_by}; "
            f"{flops / 1e9:.2f} GFLOP; TFLOP/s achieved: kernel "
            f"{flops / kernel_ms / 1e9:.1f}, scaled_dot_product_attention "
            f"{flops / library_ms / 1e9:.1f})")
    return main


def ssd_inputs(gen, b, S, H, P, N, dtype: str, slow: bool = False) -> list:
    """x, dt = softplus(normal), A = -exp(normal / 2), B, C as the JAX
    kernel test draws them; with ``slow``, dt log-uniform in [1e-3, 1e-1]
    (the range Mamba2 initialises dt to), where the state decays slowly and
    carries across chunks."""
    x = randn(gen, (b, S, H, P), dtype)
    if slow:
        dt = torch.exp(torch.empty((b, S, H), device="cuda").uniform_(
            float(np.log(1e-3)), float(np.log(1e-1)), generator=gen))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((b, S, H), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((H,), generator=gen, device="cuda") * 0.5)
    B = randn(gen, (b, S, N), dtype)
    C = randn(gen, (b, S, N), dtype)
    t = getattr(torch, dtype)
    return [x, dt.to(t), A.to(t), B, C]


def phase_ssd_check() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    for case in SSD_CASES + SSD_RAGGED_CASES + SSD_CORNER_CASES:
        b, S, H, P, N, chunk, dtype = case
        ins = ssd_inputs(gen, b, S, H, P, N, dtype)
        y, state = ops.ssd_scan(*ins, chunk=chunk, impl="cuda")
        y_ref, s_ref = ssd_scan_ref(*ins)
        gy = compare_max(y, y_ref, ssd_limit(dtype), f"K3 {case} y")
        # The state is fp32 in both versions.
        gs = compare_max(state, s_ref, ssd_limit("float32"),
                         f"K3 {case} state")
        log(f"  K3 {case}: y max|err|/max|ref| {gy['rel']:.3e}, state "
            f"{gs['rel']:.3e}")

    b, S, H, P, N, chunk, dtype = SSD_MAIN_CASE
    errs = []
    for slow in (True, False):           # the times below take JAX's draw
        # The model's layout: x, B and C are views into one conv output.
        xbc = randn(gen, (b, S, H * P + 2 * N), dtype)
        x = xbc[..., :H * P].reshape(b, S, H, P)
        _, dt, A, _, _ = ssd_inputs(gen, b, S, H, P, N, dtype, slow)
        B, C = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        what = f"K3 main, {'slow' if slow else 'JAX'} dt"
        gy, _, y_ref = check_ssd_main(what, x, dt, A, B, C, chunk, dtype)
        errs.append(gy["max_abs_err"])
        check_wrong_carry_fails(what, x, dt, A, B, C, chunk, dtype, y_ref)
    kernel_ms = time_ms(lambda: ops.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                             impl="cuda"))
    # The chunk cliff: one token more (a one-token last chunk of the
    # config's chunk) must cost K3 at most CHUNK_CLIFF_LIMIT times as much.
    xbc1 = randn(gen, (b, S + 1, H * P + 2 * N), dtype)
    _, dt1, A1, _, _ = ssd_inputs(gen, b, S + 1, H, P, N, dtype)
    ins1 = (xbc1[..., :H * P].reshape(b, S + 1, H, P), dt1, A1,
            xbc1[..., H * P:H * P + N], xbc1[..., H * P + N:])
    odd_ms = time_ms(lambda: ops.ssd_scan(*ins1, chunk=chunk, impl="cuda"))
    log(f"  K3 at S {S + 1} (chunk {chunk}, a one-token last chunk): "
        f"{odd_ms:.4f} ms, {odd_ms / kernel_ms:.3f}x the {kernel_ms:.4f} ms "
        f"at S {S} (limit {CHUNK_CLIFF_LIMIT}x)")
    if not odd_ms <= CHUNK_CLIFF_LIMIT * kernel_ms:
        raise AssertionError(f"K3 at S {S + 1} takes {odd_ms / kernel_ms:.3f}"
                             f"x its time at S {S}")
    plain_ms = time_ms(lambda: ssd_scan_ref(x, dt, A, B, C), reps=5,
                       warmup=1)
    flops, nbytes = ssd_work(b, S, H, P, N, chunk, 2)
    executed = ssd_executed(b, S, H, chunk)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"  K3 main: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
        f"library_ms none (no single PyTorch call)  bound_ms {bound_ms:.5f}"
        f" ({bound_by}; {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; "
        f"{nbytes / kernel_ms / 1e6:.1f} GB/s and {flops / kernel_ms / 1e9:.2f}"
        f" TFLOP/s achieved; {executed / 1e9:.3f} GFLOP executed on the "
        f"tensor cores, {executed / kernel_ms / 1e9:.2f} TFLOP/s); three "
        f"launches, "
        f"{grid_line(k3_lib.launch_shape(b, S, H, P, N, chunk, x.dtype))}, "
        f"on {torch.cuda.get_device_properties(0).multi_processor_count} "
        f"SMs")

    # The batched path: a formed dispatch of 8 rows of 1024 tokens.
    b, S, H, P, N, chunk, dtype = SSD_BATCHED_MAIN_CASE
    for slow in (True, False):           # the times below take JAX's draw
        xbc = randn(gen, (b, S, H * P + 2 * N), dtype)
        xb = xbc[..., :H * P].reshape(b, S, H, P)
        _, dtb, Ab, _, _ = ssd_inputs(gen, b, S, H, P, N, dtype, slow)
        Bb, Cb = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        gy, _, _ = check_ssd_main(
            f"K3 batched, {'slow' if slow else 'JAX'} dt", xb, dtb, Ab, Bb,
            Cb, chunk, dtype)
        errs.append(gy["max_abs_err"])
    b_ms = time_ms(lambda: ops.ssd_scan(xb, dtb, Ab, Bb, Cb, chunk=chunk,
                                        impl="cuda"))
    b_plain_ms = time_ms(lambda: ssd_scan_ref(xb, dtb, Ab, Bb, Cb), reps=5,
                         warmup=1)
    b_flops, b_nbytes = ssd_work(b, S, H, P, N, chunk, 2)
    b_bound_ms, b_bound_by = bound(b_flops, b_nbytes, PEAK_BF16_FLOPS)
    log(f"  K3 batched {SSD_BATCHED_MAIN_CASE}: kernel_ms {b_ms:.4f} "
        f"({b_ms / kernel_ms:.2f}x b 1)  plain_ms {b_plain_ms:.4f}  "
        f"library_ms none  bound_ms {b_bound_ms:.5f} ({b_bound_by}; "
        f"{b_nbytes / 1e6:.2f} MB, {b_flops / 1e9:.3f} GFLOP; "
        f"{b_nbytes / b_ms / 1e6:.1f} GB/s and {b_flops / b_ms / 1e9:.2f} "
        f"TFLOP/s achieved; {ssd_executed(b, S, H, chunk) / b_ms / 1e9:.2f}"
        f" TFLOP/s executed); "
        f"{grid_line(k3_lib.launch_shape(b, S, H, P, N, chunk, xb.dtype))}")
    return dict(max_abs_err=max(errs), ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                batched_ms=b_ms, fp32=ssd_fp32_check(gen))


def ssd_fp32_check(gen) -> dict:
    """K3's fp32 route (3xTF32) where the train step runs it
    (SSD_FP32_MAIN_CASES), in the model's strided layout with the JAX
    test's dt and a slowly decaying one: y at the fp32 JAX limit,
    SSD_MAIN_TOLERANCE and SSD_MAIN_RMS_LIMIT, the state at
    SSD_STATE_RMS_LIMIT; then timed beside its plain version and its
    bound (the lesser of the fp32-core and 3xTF32 operation bounds, against
    the bytes).  Returns each case's readings by its shape."""
    out = {}
    for case in SSD_FP32_MAIN_CASES:
        b, S, H, P, N, chunk, dtype = case
        errs = []
        for slow in (True, False):       # the times below take JAX's draw
            xbc = randn(gen, (b, S, H * P + 2 * N), dtype)
            x = xbc[..., :H * P].reshape(b, S, H, P)
            _, dt, A, _, _ = ssd_inputs(gen, b, S, H, P, N, dtype, slow)
            B, C = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
            gy, _, _ = check_ssd_main(
                f"K3 fp32 {case[:6]}, {'slow' if slow else 'JAX'} dt", x, dt,
                A, B, C, chunk, dtype)
            errs.append(gy["max_abs_err"])
        ms = time_ms(lambda: ops.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                          impl="cuda"))
        plain_ms = time_ms(lambda: ssd_scan_ref(x, dt, A, B, C), reps=5,
                           warmup=1)
        needed, nbytes = ssd_work(b, S, H, P, N, chunk, 4)
        (bound_ms, bound_by), cuda, tf32 = fp32_bounds(needed, nbytes)
        executed = ssd_executed(b, S, H, chunk, fp32=True)
        log(f"  K3 fp32 {case[:6]}: kernel_ms {ms:.4f}  plain_ms "
            f"{plain_ms:.4f}  library_ms none (no single PyTorch call)  "
            f"bound_ms {bound_ms:.5f} ({bound_by}: {needed / 1e9:.3f} GFLOP "
            f"needed, as 3xTF32 at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s "
            f"{tf32[0]:.5f} ms, on the fp32 cores at "
            f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s {cuda[0]:.5f} ms; "
            f"{nbytes / 1e6:.2f} MB {1e3 * nbytes / HBM_BW:.5f} ms); "
            f"{executed / 1e9:.3f} GFLOP of TF32 products executed, "
            f"{executed / ms / 1e9:.2f} TFLOP/s; "
            f"{grid_line(k3_lib.launch_shape(b, S, H, P, N, chunk, x.dtype))}")
        out[case[:6]] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=None)
    return out


def grid_line(shapes: dict) -> str:
    return ", ".join(f"{name} {int(np.prod(grid))} blocks of {threads}"
                     for name, (grid, threads, _) in shapes.items())


def main_limits(y: torch.Tensor, y_ref: torch.Tensor) -> tuple:
    """y against the plain scan's ``y_ref`` at the main shape: (rms error
    over rms ref, whether SSD_MAIN_TOLERANCE holds everywhere, whether both
    it and SSD_MAIN_RMS_LIMIT hold)."""
    d, ref = y.float() - y_ref.float(), y_ref.float()
    rms_rel = rms(d) / rms(ref)
    elementwise = bool((d.abs() <= SSD_MAIN_TOLERANCE["atol"]
                        + SSD_MAIN_TOLERANCE["rtol"] * ref.abs()).all())
    return rms_rel, elementwise, elementwise and rms_rel <= SSD_MAIN_RMS_LIMIT


def check_wrong_carry_fails(what: str, x, dt, A, B, C, chunk: int,
                            dtype: str, y_ref: torch.Tensor) -> None:
    """The card's counterpart of test_ssd_main_limits_catch_a_wrong_carry:
    the model's chunked form (``ssd_chunked`` one chunk at a time in fp32,
    y rounded to ``y_ref``'s dtype) passes the main-shape limits against
    the plain scan's ``y_ref``; with the state it carries from chunk to
    chunk scaled by 0.99 it still passes the JAX limit, but fails
    SSD_MAIN_TOLERANCE or SSD_MAIN_RMS_LIMIT."""
    S = x.shape[1]
    xf, dtf, Af, Bf, Cf = (t.float() for t in (x, dt, A, B, C))

    def chunked(carry: float) -> torch.Tensor:
        state, ys = None, []
        for c in range(0, S, chunk):
            sl = slice(c, c + chunk)
            y, state = mamba_lib.ssd_chunked(
                xf[:, sl], dtf[:, sl], Af, Bf[:, sl], Cf[:, sl], chunk=chunk,
                init_state=None if state is None else carry * state)
            ys.append(y.to(y_ref.dtype))
        return torch.cat(ys, dim=1)

    for carry in (1.0, 0.99):
        y = chunked(carry)
        rms_rel, elementwise, passes = main_limits(y, y_ref)
        rel = max_ratio(y, y_ref)
        log(f"  {what}, the chunked form with the state carried x{carry}: "
            f"y max|err|/max|ref| {rel:.3e} (JAX limit {ssd_limit(dtype)}), "
            f"rms err / rms ref {rms_rel:.3e} (limit {SSD_MAIN_RMS_LIMIT}), "
            f"within SSD_MAIN_TOLERANCE everywhere: {elementwise}")
        if not rel < ssd_limit(dtype):
            raise AssertionError(f"{what}: the chunked form with a carry of "
                                 f"{carry} fails the JAX limit")
        if passes != (carry == 1.0):
            raise AssertionError(f"{what}: the main-shape limits "
                                 f"{'fail' if carry == 1.0 else 'pass'} the "
                                 f"chunked form with a carry of {carry}")


def check_ssd_main(what: str, x, dt, A, B, C, chunk: int, dtype: str,
                   elementwise: bool = True) -> tuple:
    """K3 against the token recurrence at a main-path shape: y at the JAX
    limit and by rms, and with ``elementwise`` at SSD_MAIN_TOLERANCE (whose
    atol is set for N(0, 1) inputs); the fp32 final state at the fp32 limit
    and by rms.  Prints the readings; returns the y and state readings and
    the plain scan's y."""
    y, state = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, impl="cuda")
    y_ref, s_ref = ssd_scan_ref(x, dt, A, B, C)
    gy = compare_max(y, y_ref, ssd_limit(dtype), f"{what} y",
                     SSD_MAIN_RMS_LIMIT)
    ge = (compare(y, y_ref, SSD_MAIN_TOLERANCE, f"{what} y") if elementwise
          else dict(atol_needed=float("nan")))
    gs = compare_max(state, s_ref, ssd_limit("float32"), f"{what} state",
                     SSD_STATE_RMS_LIMIT)
    log(f"  {what} {tuple(x.shape)}: y max |err| {gy['max_abs_err']:.3e} "
        f"(max|ref| {gy['max_ref']:.3e}, ratio {gy['rel']:.3e}, limit "
        f"{ssd_limit(dtype)}); y rms err {gy['rms_err']:.3e} of rms ref "
        f"{gy['rms_ref']:.3e} = {gy['rms_rel']:.3e} (limit "
        f"{SSD_MAIN_RMS_LIMIT}); least atol at rtol "
        f"{SSD_MAIN_TOLERANCE['rtol']}: {ge['atol_needed']:.3e} (limit "
        f"{SSD_MAIN_TOLERANCE['atol']}); state max|err|/max|ref| "
        f"{gs['rel']:.3e}, rms err {gs['rms_err']:.3e} of rms ref "
        f"{gs['rms_ref']:.3e} = {gs['rms_rel']:.3e} (limit "
        f"{SSD_STATE_RMS_LIMIT})")
    return gy, gs, y_ref


def phase_decode_check() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    for case in DECODE_CASES + DECODE_RAGGED_CASES + DECODE_CORNER_CASES:
        B, Hq, Hkv, S, D, idx, window, dtype = case
        q = randn(gen, (B, Hq, D), dtype)
        k = randn(gen, (B, Hkv, S, D), dtype)
        v = randn(gen, (B, Hkv, S, D), dtype)
        out = ops.decode_attention(q, k, v, idx, window=window, impl="cuda")
        got = compare(out, decode_attention_ref(q, k, v, idx, window=window),
                      tolerance(dtype), str(case))
        # Stale slots past index must not change the output.
        k[:, :, idx + 1:] = 99.0
        v[:, :, idx + 1:] = -99.0
        stale = ops.decode_attention(q, k, v, idx, window=window,
                                     impl="cuda")
        torch.cuda.synchronize()
        if not torch.equal(stale, out):
            raise AssertionError(f"K2 {case}: stale slots past index "
                                 f"changed the output")
        log(f"  K2 {case}: max |err| {got['max_abs_err']:.3e}; stale slots "
            f"+-99 leave it unchanged")

    B, Hq, Hkv, S, D, idx, window, dtype = DECODE_MAIN_CASE
    index = torch.tensor(idx, dtype=torch.int32, device="cuda")
    # Several draws: one bf16 output a ulp off alone reads an rms over
    # DECODE_MAIN_RMS_LIMIT.  The first draw is the one timed below.
    readings = []
    for draw in range(DECODE_MAIN_DRAWS):
        q = randn(gen, (B, Hq, D), dtype)
        cache_k = randn(gen, (B, S, Hkv, D), dtype)   # the model's layout
        cache_v = randn(gen, (B, S, Hkv, D), dtype)
        k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
        out = ops.decode_attention(q, k, v, index, impl="cuda")
        readings.append(compare(out, decode_attention_ref(q, k, v, idx),
                                DECODE_MAIN_TOLERANCE, f"K2 main, draw {draw}",
                                DECODE_MAIN_RMS_LIMIT))
        if draw == 0:
            timed = (q, k, v)
    q, k, v = timed
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_                          # 64 MB > the 50 MB L2
    mask = (torch.arange(S, device="cuda") <= index)[None, None, None, :]
    q4 = q[:, :, None]
    kernel_ms = time_ms(lambda: ops.decode_attention(q, k, v, index,
                                                     impl="cuda"),
                        flush=flush)
    plain_ms = time_ms(lambda: decode_attention_ref(q, k, v, index),
                       flush=flush)
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=True), flush=flush)
    flops, nbytes = decode_work(B, Hq, Hkv, S, D, idx, window, 2)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"  K2 main {DECODE_MAIN_CASE} (read strided from a [B, S, Hkv, D] "
        f"cache, index on the card), {DECODE_MAIN_DRAWS} draws: max |err| "
        f"{[r['max_abs_err'] for r in readings]}, rms err / rms ref "
        f"{[round(r['rms_err'] / r['rms_ref'], 9) for r in readings]} "
        f"(limits {DECODE_MAIN_TOLERANCE}, rms {DECODE_MAIN_RMS_LIMIT})")
    log(f"  K2 main: one launch of {B * Hkv} clusters of {k2_lib.NSPLIT} "
        f"blocks of 256 threads")
    log(f"  K2 main: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
        f"library_ms {library_ms:.4f}  bound_ms {bound_ms:.5f} ({bound_by};"
        f" {nbytes / 1e6:.2f} MB of live cache, q and o; "
        f"{nbytes / kernel_ms / 1e6:.1f} GB/s achieved); L2 flushed before "
        f"each launch")
    return dict(max_abs_err=max(r["max_abs_err"] for r in readings),
                ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def schedule(q: int) -> list:
    slow = [1.0] * 4
    if SLOW_FROM <= q < SLOW_TO:
        slow[SLOW_EP] = SLOW_FACTOR
    return slow


def serve_under_odin(cfg, params, counter, kernel: str,
                     per_block_ms: float, num_queries: int = NUM_QUERIES,
                     rebalance: bool = True) -> dict:
    """Serve ``num_queries`` closed-loop queries of SEQ tokens on 4 stages
    under ODIN with a 3x slowdown on stage SLOW_EP for queries
    SLOW_FROM..SLOW_TO; raise unless (with ``rebalance``) it rebalances and
    moves blocks off the slowed stage, and unless it conserves blocks,
    launches ``counter``'s kernel once per block and query, and gives
    logits that do not depend on the split."""
    rng = np.random.default_rng(0)
    eng = ServingEngine(cfg, params, num_eps=4, scheduler="odin", alpha=3,
                        device="cuda")
    eng.executor.warmup(1, SEQ)
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, SEQ)),
                               device="cuda")
               for _ in range(num_queries)]

    start_config = eng.config
    reset_counts(counter)
    t0 = time.perf_counter()
    trace = eng.serve(queries, schedule)
    wall = time.perf_counter() - t0
    counts = {name: n for name, n in vars(counter).items()
              if name.endswith("launches")}
    launches = counts.pop("launches")

    summary = trace.summary()
    log(f"  served {num_queries} queries of {SEQ} tokens in {wall:.2f} s: "
        f"{json.dumps(summary)}")
    log(f"  configs: {trace.configs}")
    log(f"  start {start_config}, final {trace.configs[-1]}, "
        f"rebalances {trace.num_rebalances}, trials {trace.total_trials}, "
        f"{kernel} launches {launches}" + (f", by route {counts}" if counts
                                           else ""))
    episode = trace.configs[SLOW_FROM:SLOW_TO]
    if rebalance and trace.num_rebalances < 1:
        raise AssertionError("ODIN never rebalanced")
    if rebalance and not min(c[SLOW_EP] for c in episode) < \
            start_config[SLOW_EP]:
        raise AssertionError(f"no blocks moved off the slowed stage "
                             f"{SLOW_EP}: {episode}")
    if len(trace.latencies) != num_queries:
        raise AssertionError(f"served {len(trace.latencies)} of "
                             f"{num_queries} queries")
    if any(sum(c) != cfg.num_blocks for c in trace.configs):
        raise AssertionError(f"a config lost blocks: {trace.configs}")
    if launches != cfg.num_blocks * num_queries:
        raise AssertionError(f"{kernel} launched {launches} times, expected "
                             f"{cfg.num_blocks} x {num_queries}")

    check_split_logits(eng, queries[0], start_config, trace.configs[-1])

    # Where a clean query's time goes (no slowdown, balanced split).
    x, positions = eng.executor.embed_tokens(queries[1])
    t0 = time.perf_counter()
    x, stages = eng.executor.run_stages(x, positions, start_config, 0,
                                        len(start_config))
    t1 = time.perf_counter()
    eng.executor.head(x)
    t2 = time.perf_counter()
    kern = cfg.num_blocks * per_block_ms
    before = (f"before: {EARLIER_BLOCKS_MS[cfg.name]} ms; "
              if cfg.name in EARLIER_BLOCKS_MS else "")
    log(f"  clean query on {start_config}: blocks {1e3 * (t1 - t0):.2f} ms "
        f"({before}stages "
        f"{[round(1e3 * float(s), 2) for s in stages]}), head "
        f"{1e3 * (t2 - t1):.2f} ms; {kernel} {cfg.num_blocks} x "
        f"{per_block_ms:.4f} = {kern:.2f} ms ({100 * kern / (1e3 * (t2 - t0)):.0f}"
        f"% of blocks + head)")
    return dict(launches=launches, counts=counts, summary=summary,
                committed=committed_configs(trace))


def check_split_logits(eng, query, config_a, config_b) -> None:
    """Finite logits of the right shape, independent of the stage split."""
    cfg = eng.cfg
    with torch.inference_mode():
        a, _ = eng.executor.run_query(query, config_a)
        b, _ = eng.executor.run_query(query, config_b)
    if tuple(a.shape) != (1, SEQ, cfg.vocab_size) or not bool(
            torch.isfinite(a).all()):
        raise AssertionError(f"bad logits {tuple(a.shape)}")
    drift = float((a.float() - b.float()).abs().max())
    if not drift <= 1e-3 * float(a.float().abs().max()):
        raise AssertionError(f"logits depend on the stage split: {drift}")


def committed_configs(trace) -> list:
    """The configs the steady (non-trial) queries ran, in order, each
    once per stretch."""
    out = []
    for c, serial in zip(trace.configs, trace.serial_mask):
        if not serial and (not out or out[-1] != c):
            out.append(list(c))
    return out


def init_model(cfg) -> tuple:
    """``cfg`` with random bf16 weights from seed 0 on the card."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Model(cfg).init_params(seed=0, dtype=torch.bfloat16,
                                    device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.param_count() / 1e9:.2f} B parameters, "
        f"{cfg.num_blocks} blocks, d_model {cfg.d_model}, initialised in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    return cfg, params


def phase_qwen(cfg, params, kernel_ms: float) -> dict:
    rng = np.random.default_rng(0)
    # Block 0's attention sublayer (projections, K1, wo) on its normed
    # input, with the kernel against the same sublayer with the plain
    # attention.  The residual is left out: it would hide the sublayer.
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, SEQ)),
                             device="cuda")
    x = params["embed"]["table"][tokens]
    pos = torch.arange(SEQ, device="cuda").expand(1, SEQ)
    bp = blk.block_params(params["blocks"], 0)
    sub = bp["sub0"]
    with torch.inference_mode():
        h = rms_norm(x, sub["ln1"]["scale"], cfg.rms_eps)
        a_kernel = attn_lib.attention_forward(sub["mixer"], cfg, h, pos)
        a_plain = attn_lib.attention_forward(sub["mixer"], cfg, h, pos,
                                             impl="ref")
        torch.cuda.synchronize()
        diff = a_kernel.float() - a_plain.float()
        ratio = rms(diff) / rms(a_plain)
        rel_max = float(diff.abs().max() / a_plain.float().abs().max())
        block_ms = time_ms(lambda: blk.block_forward(bp, cfg, x, pos),
                           reps=10)
    if (not ratio <= SUBLAYER_RMS_LIMIT
            or not bool(torch.isfinite(a_kernel).all())):
        raise AssertionError(f"block 0's attention with the kernel: rms|d|"
                             f"/rms|ref| {ratio:.3e} (limit "
                             f"{SUBLAYER_RMS_LIMIT})")
    log(f"  block 0's attention sublayer, kernel vs plain attention: "
        f"rms|d|/rms|ref| {ratio:.3e} (limit {SUBLAYER_RMS_LIMIT}), "
        f"max|d|/max|ref| {rel_max:.3e}, rms|ref| {rms(a_plain):.3e}; "
        f"one block {block_ms:.3f} ms, of which attention {kernel_ms:.3f}"
        f" ms ({100 * kernel_ms / block_ms:.0f}%)")
    served = serve_under_odin(cfg, params, flash_attention, "K1", kernel_ms)
    served["prefill"] = time_prefill(cfg, params)
    # Serving launches no training kernel: no LSE forward, no backward.
    want = {"tensor_core_launches": cfg.num_blocks * NUM_QUERIES,
            "fp32_launches": 0, "lse_launches": 0,
            "backward_launches": 0, "bf16_lse_launches": 0,
            "bf16_backward_launches": 0}
    if served["counts"] != want:
        raise AssertionError(f"K1 routes while serving: {served['counts']}, "
                             f"expected {want}")
    d, hd = cfg.d_model, cfg.head_dim
    products = 2 * SEQ * (d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                          + cfg.num_heads * hd * d + 3 * d * cfg.d_ff)
    log(f"  a qwen3-4b block's projection and MLP products are "
        f"{products / 1e9:.1f} GFLOP, {1e3 * products / PEAK_BF16_FLOPS:.3f}"
        f" ms at the bf16 peak")
    return served


def time_prefill(cfg, params) -> dict:
    """One query of SEQ tokens through ``Model.prefill`` into a cache of
    SEQ slots (the dry run's prefill step at B 1): its host-clock time
    (synchronised, median of 5) and the peak device memory around it."""
    model = Model(cfg)
    tokens = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, SEQ)), device="cuda")
    with torch.inference_mode():
        model.prefill(params, tokens,
                      cache=model.init_cache(1, SEQ, device="cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = wall_ms(lambda: model.prefill(
            params, tokens, cache=model.init_cache(1, SEQ, device="cuda")),
            reps=5)
    peak = torch.cuda.max_memory_allocated()
    log(f"  Model.prefill of 1 x {SEQ} tokens into {SEQ} slots: {ms:.2f} ms "
        f"(host clock, synchronised, median of 5); peak device memory "
        f"{peak / 2**30:.2f} GiB")
    return dict(step_s=ms / 1e3, peak=peak)


def phase_mamba(cfg, params, kernel_ms: float) -> dict:
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, SEQ)),
                             device="cuda")
    x = params["embed"]["table"][tokens]
    pos = torch.arange(SEQ, device="cuda").expand(1, SEQ)
    bp = blk.block_params(params["blocks"], 0)
    sub = bp["sub0"]
    # The model's init sets dt_bias to 0, so dt = softplus(normal) and the
    # state decays within a few tokens.  Mamba2's reference init draws
    # dt_bias so that softplus(dt_bias) is log-uniform in [1e-3, 1e-1]:
    # there the state carries across chunks.  Block 0 is checked both ways.
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt0 = torch.exp(torch.empty(sub["mixer"]["dt_bias"].shape,
                                device="cuda").uniform_(
        float(np.log(1e-3)), float(np.log(1e-1)), generator=gen))
    mixers = {"the model's init": sub["mixer"],
              "dt_bias as Mamba2's reference init": dict(
                  sub["mixer"], dt_bias=dt0 + torch.log(-torch.expm1(-dt0)))}
    with torch.inference_mode():
        h = rms_norm(x, sub["ln1"]["scale"], cfg.rms_eps)
        for name, mixer in mixers.items():
            # K3 at block 0's own scan inputs (strided views, as served);
            # y is small there (rms about 1e-5), so it is held by ratios.
            _, _, xs, dt, A, Bm, Cm = mamba_lib.scan_inputs(mixer, cfg, h)
            check_ssd_main(f"K3 at block 0's inputs, {name},", xs, dt, A, Bm,
                           Cm, cfg.ssm.chunk_size, "bfloat16",
                           elementwise=False)
        m_kernel = mamba_lib.mamba_forward(sub["mixer"], cfg, h)
        m_plain = mamba_lib.mamba_forward(sub["mixer"], cfg, h, impl="ref")
        ratio = rel_rms(m_kernel, m_plain)
        log(f"  block 0's Mamba2 sublayer, K3 vs the plain scan: rms|d|/"
            f"rms|ref| {ratio:.3e} (limit {MAMBA_SUBLAYER_RMS_LIMIT}), "
            f"rms|ref| {rms(m_plain):.3e}")
        if (not ratio <= MAMBA_SUBLAYER_RMS_LIMIT
                or not bool(torch.isfinite(m_kernel).all())):
            raise AssertionError(f"block 0's Mamba2 sublayer with K3: "
                                 f"rms|d|/rms|ref| {ratio:.3e}")
        block_ms = time_ms(lambda: blk.block_forward(bp, cfg, x, pos),
                           reps=10)
    log(f"  one block {block_ms:.3f} ms, of which the scan {kernel_ms:.3f} "
        f"ms ({100 * kernel_ms / block_ms:.0f}%)")
    return serve_under_odin(cfg, params, ssd_scan, "K3", kernel_ms)


def clone_tree(tree: dict) -> dict:
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def wall_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of ``fn`` (synchronised), in ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def decode_loop(model, params, cache, tokens, start: int, impl: str) -> tuple:
    """Decode ``tokens`` [1, n] one at a time from position ``start``, with
    the position kept on the card; returns (logits per step, ms per
    step)."""
    index = torch.tensor(start, dtype=torch.int32, device="cuda")
    logits, times = [], []
    for t in range(tokens.shape[1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, tokens[:, t:t + 1], cache,
                                      index, impl=impl)
        index += 1
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        logits.append(lg)
    return logits, times


def phase_cached(qcfg, qparams, mcfg, mparams) -> dict:
    rng = np.random.default_rng(2)
    out = {}
    # qwen3-4b: prefill through K1, decode through K2.
    model = Model(qcfg)
    prompt = torch.as_tensor(rng.integers(0, qcfg.vocab_size, (1, SEQ)),
                             device="cuda")
    cont = torch.as_tensor(
        rng.integers(0, qcfg.vocab_size, (1, DECODE_STEPS)), device="cuda")
    with torch.inference_mode():
        cache = model.init_cache(1, CACHE_LEN, torch.bfloat16, "cuda")
        reset_counts(flash_attention)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = model.prefill(qparams, tokens=prompt, cache=cache)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        k1 = flash_attention.launches
        k1_tensor_cores = flash_attention.tensor_core_launches
        full, _ = model.forward(qparams, prompt)
        prefill_ratio = rel_rms(last[:, 0], full[:, -1])
        del full
        # How much this random bf16 model amplifies one-ulp differences:
        # the same prefill with the plain attention in place of K1.
        plain_last, _ = model.prefill(
            qparams, tokens=prompt, impl="ref",
            cache=model.init_cache(1, SEQ, torch.bfloat16, "cuda"))
        k1_model_ratio = rel_rms(last[:, 0], plain_last[:, 0])
        # K2 alone: block 0's attention sublayer at the first decode step,
        # with the kernel and with the plain attention, on copies of the
        # prefilled cache.
        sub = blk.block_params(qparams["blocks"], 0)["sub0"]
        h = rms_norm(qparams["embed"]["table"][cont[:, :1]],
                     sub["ln1"]["scale"], qcfg.rms_eps)
        c0 = blk.block_params(cache, 0)["sub0"]
        o_kernel, _ = attn_lib.attention_decode(sub["mixer"], qcfg, h,
                                                clone_tree(c0), SEQ)
        o_plain, _ = attn_lib.attention_decode(sub["mixer"], qcfg, h,
                                               clone_tree(c0), SEQ,
                                               impl="ref")
        sub_ratio = rel_rms(o_kernel, o_plain)
        cache_plain = clone_tree(cache)
        reset_counts(decode_attention)
        kern, kern_ms = decode_loop(model, qparams, cache, cont, SEQ, "auto")
        launches = decode_attention.launches
        plain, plain_ms = decode_loop(model, qparams, cache_plain, cont, SEQ,
                                      "ref")
    ratios = [rel_rms(a[:, 0], b[:, 0]) for a, b in zip(kern, plain)]
    log(f"  qwen3-4b prefill of {SEQ} tokens into {CACHE_LEN} slots: "
        f"{prefill_ms:.2f} ms, K1 launches {k1}; last logits vs forward's "
        f"rms|d|/rms|ref| {prefill_ratio:.3e} (limit {PREFILL_RMS_LIMIT})")
    log(f"  the same prefill with the plain attention in place of K1: last "
        f"logits rms|d|/rms|ref| {k1_model_ratio:.3e} (a reading of how far "
        f"36 bf16 blocks carry one-ulp differences); block 0's attention "
        f"sublayer at the first decode step, K2 vs plain: rms|d|/rms|ref| "
        f"{sub_ratio:.3e} (limit {DECODE_SUBLAYER_RMS_LIMIT})")
    log(f"  qwen3-4b {DECODE_STEPS} decode steps: K2 launches {launches}; "
        f"ms per step with K2 {[round(t, 2) for t in kern_ms]} (median "
        f"{np.median(kern_ms):.2f}), with the plain attention median "
        f"{np.median(plain_ms):.2f}; logits K2 vs plain rms|d|/rms|ref| per "
        f"step {[f'{r:.2e}' for r in ratios]} (max {max(ratios):.3e}, limit "
        f"{DECODE_RMS_LIMIT})")
    if not k1 == k1_tensor_cores == qcfg.num_blocks:
        raise AssertionError(f"prefill launched K1 {k1} times, "
                             f"{k1_tensor_cores} on the tensor cores")
    if launches != qcfg.num_blocks * DECODE_STEPS:
        raise AssertionError(f"K2 launched {launches} times, expected "
                             f"{qcfg.num_blocks} x {DECODE_STEPS}")
    if not prefill_ratio <= PREFILL_RMS_LIMIT:
        raise AssertionError(f"prefill's last logits differ from forward's: "
                             f"{prefill_ratio:.3e}")
    if not sub_ratio <= DECODE_SUBLAYER_RMS_LIMIT:
        raise AssertionError(f"block 0's attention at decode with K2: "
                             f"rms|d|/rms|ref| {sub_ratio:.3e}")
    if not (max(ratios) <= DECODE_RMS_LIMIT
            and all(bool(torch.isfinite(a).all()) for a in kern)):
        raise AssertionError(f"decode logits with K2 differ from the plain "
                             f"attention's: {ratios}")
    out["qwen3-4b"] = dict(launches=launches, ms_per_step=kern_ms)

    # mamba2-370m: prefill through K3 (with its final state), decode
    # through the plain one-token recurrence.
    model = Model(mcfg)
    prompt = torch.as_tensor(rng.integers(0, mcfg.vocab_size, (1, SEQ + 1)),
                             device="cuda")
    cont = torch.as_tensor(
        rng.integers(0, mcfg.vocab_size, (1, MAMBA_DECODE_STEPS - 1)),
        device="cuda")
    with torch.inference_mode():
        cache = model.init_cache(1, CACHE_LEN, torch.bfloat16, "cuda")
        reset_counts(ssd_scan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = model.prefill(mparams, tokens=prompt[:, :SEQ],
                                    cache=cache)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        k3 = ssd_scan.launches
        # Forward over the same prompt (the same chunks), then over one
        # more token (an odd length: chunk 256 with a one-token last chunk;
        # the JAX rule would give 1025 chunks of one token).
        # Each is timed as the median of three after one untimed call (the
        # first call at a new length also allocates).
        fwd = model.forward(mparams, prompt[:, :SEQ])[0][:, -1]
        full = model.forward(mparams, prompt)[0][:, SEQ]
        fwd_ms = {n: wall_ms(lambda: model.forward(mparams, prompt[:, :n]))
                  for n in (SEQ, SEQ + 1)}
        prefill_ratio = rel_rms(last[:, 0], fwd)
        steps = torch.cat([prompt[:, SEQ:], cont], dim=1)
        logits, ms = decode_loop(model, mparams, cache, steps, SEQ, "auto")
    first_ratio = rel_rms(logits[0][:, 0], full)
    log(f"  mamba2-370m prefill of {SEQ} tokens: {prefill_ms:.2f} ms, K3 "
        f"launches {k3}; last logits vs forward's rms|d|/rms|ref| "
        f"{prefill_ratio:.3e} (limit {PREFILL_RMS_LIMIT}); first decoded "
        f"logits vs forward's {first_ratio:.3e} (limit "
        f"{MAMBA_DECODE_RMS_LIMIT}); {MAMBA_DECODE_STEPS} decode steps, ms "
        f"per step {[round(t, 2) for t in ms]} (median {np.median(ms):.2f})")
    log(f"  mamba2-370m forward over {SEQ} tokens (chunk 256): "
        f"{fwd_ms[SEQ]:.2f} ms; over {SEQ + 1} tokens (chunk 256, a "
        f"one-token last chunk): {fwd_ms[SEQ + 1]:.2f} ms, "
        f"{fwd_ms[SEQ + 1] / fwd_ms[SEQ]:.3f}x")
    if k3 != mcfg.num_blocks:
        raise AssertionError(f"prefill launched K3 {k3} times")
    if not prefill_ratio <= PREFILL_RMS_LIMIT:
        raise AssertionError(f"mamba prefill's last logits differ from "
                             f"forward's: {prefill_ratio:.3e}")
    if not (first_ratio <= MAMBA_DECODE_RMS_LIMIT
            and all(bool(torch.isfinite(a).all()) for a in logits)):
        raise AssertionError(f"mamba decode logits differ from forward's: "
                             f"{first_ratio:.3e}")
    out["mamba2-370m"] = dict(launches=k3, ms_per_step=ms)
    return out


def batch_schedule(q: int) -> list:
    slow = [1.0] * 4
    if BATCH_SLOW_FROM <= q < BATCH_SLOW_TO:
        slow[SLOW_EP] = SLOW_FACTOR
    return slow


class BlockForwards:
    """Counts, while active, the block forwards the executor ``ex`` runs
    (the blocks of every ``stage_fn`` call), the dispatches (formed
    dispatches finished and queries executed alone) and each join's
    catch-up blocks (the blocks of the fused launch over the joiner)."""

    def __init__(self, ex):
        self.ex = ex
        self.blocks = self.dispatches = self.joins = self.catchup = 0

    def __enter__(self):
        ex, counts = self.ex, self
        stage_fn = ex.stage_fn
        builder, live = engine_lib._LiveDispatchBuilder, \
            engine_lib._LiveQueryExecutor
        self._saved = (builder.join, builder.finish, live.execute)
        join, finish, execute = self._saved

        def counted_stage_fn(x, positions, lo, hi):
            counts.blocks += hi - lo
            return stage_fn(x, positions, lo, hi)

        def counted_join(b, q):
            counts.joins += 1
            counts.catchup += b._bounds[b._stage - 1][1]
            return join(b, q)

        def counted_finish(b):
            counts.dispatches += 1
            return finish(b)

        def counted_execute(lv, q, step):
            counts.dispatches += 1
            return execute(lv, q, step)

        ex.stage_fn = counted_stage_fn
        builder.join, builder.finish = counted_join, counted_finish
        live.execute = counted_execute
        return self

    def __exit__(self, *exc):
        del self.ex.stage_fn
        builder, live = engine_lib._LiveDispatchBuilder, \
            engine_lib._LiveQueryExecutor
        builder.join, builder.finish, live.execute = self._saved
        return False


def load_line(trace) -> str:
    s = trace.summary()
    return (f"mean queue delay {s['mean_queue_delay_s']:.4f} s, p99 "
            f"latency {s['p99_latency_s']:.4f} s, achieved load "
            f"{s['achieved_load_qps']:.2f} of {s['offered_load_qps']:.2f} q/s "
            f"offered, mean occupancy {s['mean_batch_occupancy']:.3f}")


def batched_logits_ratio(eng, cfg, rng) -> list:
    """One continuous dispatch through the engine's builder, two queries
    formed (256 and 200 tokens) and one (230 tokens) joining after stage 1,
    all right-padded to the 256-token bucket edge: per row, rms(batched
    logits - the query's logits alone) over its real positions, over the
    rms of the logits alone."""
    lengths = np.array([256, 200, 230])
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, int(n))),
                               device="cuda") for n in lengths]
    live = eng.query_executor(queries, lambda q: [1.0] * 4)
    former = resolve_batching("continuous", max_batch=MAX_BATCH,
                              buckets=BUCKETS, seq=LONG)
    live.configure_batching(former, lengths, former.padded_lengths(lengths))
    live.begin_query(0)
    builder = live.begin_dispatch(0, RuntimeStep(eng.config, serial=False))
    builder.add(0)
    builder.add(1)
    builder.next_boundary()
    builder.join(2)
    builder.finish()
    ratios = []
    with torch.inference_mode():
        logits = eng.executor.head(builder._x)
        for i, n in enumerate(lengths):
            alone, _ = eng.executor.run_query(queries[i], eng.config)
            ratios.append(rel_rms(logits[i, :n], alone[0]))
            if not bool(torch.isfinite(logits[i, :n]).all()):
                raise AssertionError(f"row {i} of the batch has non-finite "
                                     f"logits")
    return ratios


def device_busy(fn) -> tuple:
    """(host-clock seconds of ``fn``, synchronised; seconds the card spent
    in kernels meanwhile, from ``torch.profiler``'s device times)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(getattr(ev, "device_time_total", None)
               or getattr(ev, "cuda_time_total", 0)
               for ev in prof.key_averages())
    return wall, busy / 1e6


def serve_batched(cfg, params, counter, kernel: str,
                  kernel_ms: float) -> dict:
    """Phase 9 for one model: bursty, continuous-batched traffic under ODIN
    (see the module docstring)."""
    rng = np.random.default_rng(3)
    lengths = make_lengths("bimodal", short=SHORT, long=LONG, p_long=P_LONG,
                           seed=0).sample(BATCH_QUERIES)
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, int(n))),
                               device="cuda") for n in lengths]
    eng = ServingEngine(cfg, params, num_eps=4, scheduler="odin", alpha=3,
                        device="cuda")
    ex = eng.executor
    ex.warmup(1, SEQ)
    probe = eng.serve([torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (1, SEQ)), device="cuda")
                       for _ in range(4)], lambda q: [1.0] * 4)
    service = float(probe.service_latencies[1:].mean())
    eng.reset_policy()
    wl = dict(burst_rate=8.0 / service, base_rate=0.3 / service,
              mean_burst=60 * service, mean_gap=15 * service, seed=0)
    kw = dict(workload="bursty", workload_kwargs=wl, max_batch=MAX_BATCH,
              batching="continuous", buckets=BUCKETS)
    former = resolve_batching("continuous", max_batch=MAX_BATCH,
                              buckets=BUCKETS, seq=LONG)
    edges = sorted({int(e) for e in former.padded_lengths(lengths)})
    # The serve warms this set itself; warmed here, its launches stay out
    # of the counted run.
    ex.warm_buckets(edges, MAX_BATCH)

    start_config = eng.config
    reset_counts(counter)
    with BlockForwards(ex) as fw:
        t0 = time.perf_counter()
        trace = eng.serve(queries, batch_schedule, **kw)
        wall = time.perf_counter() - t0
    counts = {name: n for name, n in vars(counter).items()
              if name.endswith("launches")}
    launches = counts.pop("launches")
    s = trace.summary()
    log(f"  {cfg.name}: probe service {1e3 * service:.2f} ms a 1024-token "
        f"query; bursty burst_rate {wl['burst_rate']:.2f} q/s, base_rate "
        f"{wl['base_rate']:.3f} q/s, mean_burst {wl['mean_burst']:.3f} s, "
        f"mean_gap {wl['mean_gap']:.3f} s; lengths {lengths.tolist()}")
    log(f"  served {len(trace.latencies)} queries in {wall:.2f} s: "
        f"{json.dumps(s)}")
    log(f"  configs: {trace.configs}")
    log(f"  dispatches {fw.dispatches}, joins {fw.joins} (catch-up blocks "
        f"{fw.catchup}), block forwards {fw.blocks}, {kernel} launches "
        f"{launches}" + (f", by route {counts}" if counts else "")
        + f"; mean occupancy {s['mean_batch_occupancy']:.3f}, p99 "
        f"{s['p99_batch_occupancy']:.1f}, padded_token_frac "
        f"{s['padded_token_frac']:.4f}; rebalances {trace.num_rebalances}, "
        f"trials {trace.total_trials}")
    episode = trace.configs[BATCH_SLOW_FROM:BATCH_SLOW_TO]
    checks = {
        "every query served": len(trace.latencies) == BATCH_QUERIES,
        "ODIN rebalanced": trace.num_rebalances >= 1,
        "blocks moved off stage 1": min(c[SLOW_EP] for c in episode)
        < start_config[SLOW_EP],
        "every config conserves blocks": all(
            sum(c) == cfg.num_blocks for c in trace.configs),
        "batches formed": s["mean_batch_occupancy"] > 1.0,
        "a query joined a batch in flight": fw.joins >= 1,
        "only warm shapes": all(seq in edges and rows == next_pow2(rows)
                                for rows, seq in ex._warmed),
        "launches = block forwards = dispatches x blocks + catch-up":
            launches == fw.blocks
            == fw.dispatches * cfg.num_blocks + fw.catchup,
    }
    if counter is flash_attention:
        checks["every K1 launch bf16"] = counts["fp32_launches"] == 0
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{cfg.name} batched serving: {failed}")
    log(f"  warmed shapes {sorted(ex._warmed)}")

    # A second serve over warm shapes must not warm anything.
    def no_warmups(*a, **k):
        raise AssertionError(f"warm-up requested in a warm serve: {a}")

    eng.reset_policy()
    ex.warmup = no_warmups
    try:
        again = eng.serve(queries, batch_schedule, **kw)
    finally:
        del ex.warmup
    if len(again.latencies) != BATCH_QUERIES:
        raise AssertionError("the second serve lost queries")
    eng.reset_policy()
    drain = eng.serve(queries, batch_schedule, **dict(kw, batching="drain"))
    eng.reset_policy()
    solo = eng.serve(queries, batch_schedule, workload="bursty",
                     workload_kwargs=wl, max_batch=1)
    eng.reset_policy()
    riding = eng.serve(queries, batch_schedule,
                       **dict(kw, explore_in_batch=True))
    for name, tr in (("continuous", trace), ("continuous, again", again),
                     ("drain", drain), ("max_batch=1", solo),
                     ("continuous, trials riding batches", riding)):
        log(f"  the same arrivals, {name}: {load_line(tr)}, serial_frac "
            f"{tr.summary()['serial_frac']:.3f}")

    # One drained burst of 8 long queries against the same 8 one at a time,
    # all arriving at once, on a static split.
    static = ServingEngine(cfg, params, num_eps=4, scheduler="none",
                           executor=ex)
    burst = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, LONG)),
                             device="cuda") for _ in range(MAX_BATCH)]
    at_once = dict(workload="trace", workload_kwargs=dict(
        inter_arrivals=[0.0]))
    walls, spans = {}, {}
    for name, opts in (("solo", dict(max_batch=1)),
                       ("drained", dict(batching="drain",
                                        max_batch=MAX_BATCH,
                                        buckets=BUCKETS)),
                       ("drained, again", dict(batching="drain",
                                               max_batch=MAX_BATCH,
                                               buckets=BUCKETS)),
                       ("solo, again", dict(max_batch=1))):
        t0 = time.perf_counter()
        tr = static.serve(burst, lambda q: [1.0] * 4, **at_once, **opts)
        walls[name] = time.perf_counter() - t0
        spans[name] = float(tr.completion_times.max()
                            - tr.arrival_times.min())
    # The trace's clock credits queries served one at a time with
    # pipelined stages (the next starts when the bottleneck stage frees);
    # on one card the stages run one after the other, so the host clock is
    # the burst's real time.
    # Where a drained dispatch's time goes: one block at 8 x LONG tokens
    # (CUDA events), and the card's busy share over a drained burst and
    # over one query served alone.
    with torch.inference_mode():
        x = params["embed"]["table"][torch.cat(burst)]
        pos = torch.arange(LONG, device="cuda").expand(MAX_BATCH, LONG)
        bp = blk.block_params(params["blocks"], 0)
        block_ms = time_ms(lambda: blk.block_forward(bp, cfg, x, pos),
                           reps=10)
    del x
    busy = {
        "drained burst": device_busy(lambda: static.serve(
            burst, lambda q: [1.0] * 4, **at_once, batching="drain",
            max_batch=MAX_BATCH, buckets=BUCKETS)),
        "one query alone": device_busy(lambda: static.serve(
            burst[:1], lambda q: [1.0] * 4)),
    }
    log(f"  one block at {MAX_BATCH} x {LONG} tokens {block_ms:.3f} ms "
        f"(CUDA events), of which {kernel} {kernel_ms:.4f} ms "
        f"({100 * kernel_ms / block_ms:.0f}%); card busy (torch.profiler "
        f"kernel time over the host clock): " + ", ".join(
            f"{name} {b:.4f} of {w:.4f} s ({100 * b / w:.0f}%)"
            for name, (w, b) in busy.items()))
    log(f"  8 queries of {LONG} tokens arriving at once on "
        f"{static.config}, host clock: drained burst {walls['drained']:.4f}"
        f" / {walls['drained, again']:.4f} s, one at a time "
        f"{walls['solo']:.4f} / {walls['solo, again']:.4f} s; the trace's "
        f"last completion: drained {spans['drained']:.4f} / "
        f"{spans['drained, again']:.4f} s, one at a time (pipelined "
        f"stages) {spans['solo']:.4f} / {spans['solo, again']:.4f} s")

    ratios = batched_logits_ratio(eng, cfg, rng)
    log(f"  logits of a continuous dispatch with a join (rows of 256, 200 "
        f"and 230 tokens padded to 256) against each query alone, rms|d|/"
        f"rms|alone| over the real positions: "
        f"{[f'{r:.3e}' for r in ratios]} (limit {BATCHED_LOGITS_RMS_LIMIT})")
    if not max(ratios) <= BATCHED_LOGITS_RMS_LIMIT:
        raise AssertionError(f"{cfg.name}: a batched row's logits differ "
                             f"from the query's alone: {ratios}")
    return dict(launches=launches, summary=s, walls=walls, ratios=ratios,
                block_ms=block_ms, busy=busy)


def phase_batched(qcfg, qparams, mcfg, mparams, k1_ms: float,
                  k3_ms: float) -> dict:
    """``k1_ms`` / ``k3_ms``: each kernel's time at its batched shape
    (phases 3-4)."""
    return {"qwen3-4b": serve_batched(qcfg, qparams, flash_attention, "K1",
                                      k1_ms),
            "mamba2-370m": serve_batched(mcfg, mparams, ssd_scan, "K3",
                                         k3_ms)}


def free_memory() -> None:
    """Release what the last phase's models left behind."""
    gc.collect()
    torch.cuda.empty_cache()


def widened(tree: dict) -> dict:
    """A copy of a parameter tree with every leaf in fp32."""
    return {k: widened(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def tree_bytes(tree: dict) -> int:
    return sum(tree_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def copy_tree(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            copy_tree(dst[k], v)
        else:
            dst[k].copy_(v)


def log_memory(name: str) -> None:
    log(f"  {name}: device memory {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB allocated, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB (torch.cuda.max_memory_allocated)")


class Shadow:
    """While active, holds every launch of K1, K2 and K3 that the models
    make through ``ops`` against the kernel's plain version on the same
    inputs, and records rms(kernel - plain) / rms(plain) per kernel.  K1's
    plain version runs one KV head's group of query heads at a time, so its
    fp32 scores stay small beside a large model.  The plain versions launch
    no kernel, so the launch counts stay those of the path."""

    LIMITS = {"K1": SUBLAYER_RMS_LIMIT, "K2": DECODE_SUBLAYER_RMS_LIMIT,
              "K3 y": SSD_MAIN_RMS_LIMIT, "K3 state": SSD_STATE_RMS_LIMIT}

    def __init__(self):
        self.readings = {name: [] for name in self.LIMITS}

    def __enter__(self):
        self._saved = (ops.flash_attention, ops.decode_attention,
                       ops.ssd_scan)
        fa, da, scan = self._saved
        rec = self.readings

        def flash(q, k, v, *, causal=True, window=None, impl="auto"):
            out = fa(q, k, v, causal=causal, window=window, impl=impl)
            if impl != "ref" and q.is_cuda:
                G = q.shape[1] // k.shape[1]
                ref = torch.cat([flash_attention_ref(
                    q[:, g * G:(g + 1) * G], k[:, g:g + 1], v[:, g:g + 1],
                    causal=causal, window=window)
                    for g in range(k.shape[1])], dim=1)
                rec["K1"].append(rel_rms(out, ref))
            return out

        def decode(q, k, v, index, *, window=None, impl="auto"):
            out = da(q, k, v, index, window=window, impl=impl)
            if impl != "ref" and q.is_cuda:
                rec["K2"].append(rel_rms(out, decode_attention_ref(
                    q, k, v, index, window=window)))
            return out

        def ssd(x, dt, A, B, C, *, chunk=256, impl="auto"):
            y, state = scan(x, dt, A, B, C, chunk=chunk, impl=impl)
            if impl != "ref" and x.is_cuda:
                y_ref, s_ref = ssd_scan_ref(x, dt, A, B, C)
                rec["K3 y"].append(rel_rms(y, y_ref))
                rec["K3 state"].append(rel_rms(state, s_ref))
            return y, state

        ops.flash_attention, ops.decode_attention, ops.ssd_scan = \
            flash, decode, ssd
        return self

    def __exit__(self, *exc):
        ops.flash_attention, ops.decode_attention, ops.ssd_scan = \
            self._saved
        return False

    def check(self, what: str) -> None:
        """Log each kernel's launches and worst reading; raise unless every
        reading is within its limit."""
        worst = {name: (len(vals), float(np.max(vals)))
                 for name, vals in self.readings.items() if vals}
        log(f"  {what}, every kernel launch against its plain version on "
            f"the same inputs: " + "; ".join(
                f"{name} {n} launches, max rms|d|/rms|plain| {w:.3e} (limit "
                f"{self.LIMITS[name]})" for name, (n, w) in worst.items()))
        bad = [name for name, (_, w) in worst.items()
               if not w <= self.LIMITS[name]]
        if bad:
            raise AssertionError(f"{what}: {bad} disagree with their plain "
                                 f"versions: {worst}")


def phase_family_kernels() -> dict:
    """Phase 10's kernel shapes (FAMILY_MAIN_CASES, DECODE_FAMILY_MAIN_CASES,
    SSD_FAMILY_MAIN_CASES) against the plain versions at the main limits,
    each timed beside its plain version and the library call."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for case in FAMILY_MAIN_CASES:
        B, Hq, Hkv, S, D, causal, window, dtype = case
        q = randn(gen, (B, Hq, S, D), dtype)
        k = randn(gen, (B, Hkv, S, D), dtype)
        v = randn(gen, (B, Hkv, S, D), dtype)
        before = route_counts()["tensor_core_launches"]
        got = compare(ops.flash_attention(q, k, v, causal=causal,
                                          window=window, impl="cuda"),
                      flash_attention_ref(q, k, v, causal=causal,
                                          window=window),
                      MAIN_TOLERANCE, f"K1 {case}", MAIN_RMS_LIMIT)
        if route_counts()["tensor_core_launches"] != before + 1:
            raise AssertionError(f"K1 {case} did not run on the tensor-core "
                                 f"kernel")
        mask = None
        if window is not None:
            qp = torch.arange(S, device="cuda")[:, None]
            kp = torch.arange(S, device="cuda")[None, :]
            mask = (kp <= qp) & (qp - kp < window)
        kernel_ms = time_ms(lambda: ops.flash_attention(
            q, k, v, causal=causal, window=window, impl="cuda"))
        plain_ms = time_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window), reps=5, warmup=1)
        library_ms = time_ms(lambda: sdpa(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True))
        bound_ms, bound_by = attention_bound(B, Hq, Hkv, S, D, causal, 2,
                                             window)
        flops = 4 * B * Hq * D * attention_pairs(S, causal, window)
        out[("K1",) + case] = dict(max_abs_err=got["max_abs_err"],
                                   ms=kernel_ms, plain_ms=plain_ms,
                                   library_ms=library_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)
        log(f"  K1 {case}: max |err| {got['max_abs_err']:.3e}, rms err / rms "
            f"ref {got['rms_err'] / got['rms_ref']:.3e} (limits "
            f"{MAIN_TOLERANCE}, rms {MAIN_RMS_LIMIT}); kernel_ms "
            f"{kernel_ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
            f"{library_ms:.4f} (scaled_dot_product_attention"
            f"{'' if mask is None else ', boolean window mask'})  bound_ms "
            f"{bound_ms:.5f} ({bound_by}; {flops / 1e9:.2f} GFLOP; TFLOP/s "
            f"achieved: kernel {flops / kernel_ms / 1e9:.1f}, library "
            f"{flops / library_ms / 1e9:.1f})")
        del q, k, v, mask

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda").zero_
    for case in DECODE_FAMILY_MAIN_CASES:
        B, Hq, Hkv, S, D, idx, window, dtype = case
        q = randn(gen, (B, Hq, D), dtype)
        cache_k = randn(gen, (B, S, Hkv, D), dtype)   # the model's layout
        cache_v = randn(gen, (B, S, Hkv, D), dtype)
        k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
        index = torch.tensor(idx, dtype=torch.int32, device="cuda")
        before = decode_attention.launches
        got = compare(ops.decode_attention(q, k, v, index, window=window,
                                           impl="cuda"),
                      decode_attention_ref(q, k, v, idx, window=window),
                      DECODE_MAIN_TOLERANCE, f"K2 {case}",
                      DECODE_MAIN_RMS_LIMIT)
        if decode_attention.launches != before + 1:
            raise AssertionError(f"K2 {case} launched no kernel")
        kp = torch.arange(S, device="cuda")
        live = kp <= index
        if window is not None:
            live &= kp > index - window
        mask = live[None, None, None, :]
        kernel_ms = time_ms(lambda: ops.decode_attention(
            q, k, v, index, window=window, impl="cuda"), flush=flush)
        plain_ms = time_ms(lambda: decode_attention_ref(
            q, k, v, index, window=window), flush=flush)
        library_ms = time_ms(lambda: sdpa(q[:, :, None], k, v, attn_mask=mask,
                                          enable_gqa=True), flush=flush)
        flops, nbytes = decode_work(B, Hq, Hkv, S, D, idx, window, 2)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        out[("K2",) + case] = dict(max_abs_err=got["max_abs_err"],
                                   ms=kernel_ms, plain_ms=plain_ms,
                                   library_ms=library_ms, bound_ms=bound_ms,
                                   bound_by=bound_by)
        log(f"  K2 {case} (read strided from a [B, S, Hkv, D] cache): max "
            f"|err| {got['max_abs_err']:.3e}, rms err / rms ref "
            f"{got['rms_err'] / got['rms_ref']:.3e} (limits "
            f"{DECODE_MAIN_TOLERANCE}, rms {DECODE_MAIN_RMS_LIMIT}); "
            f"kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
            f"{library_ms:.4f} (sdpa, boolean mask)  bound_ms {bound_ms:.5f} "
            f"({bound_by}; {nbytes / 1e6:.2f} MB; "
            f"{nbytes / kernel_ms / 1e6:.1f} GB/s achieved); L2 flushed "
            f"before each launch")

    for case in SSD_FAMILY_MAIN_CASES:
        b, S, H, P, N, chunk, dtype = case
        errs = []
        for slow in (True, False):       # the times below take JAX's draw
            xbc = randn(gen, (b, S, H * P + 2 * N), dtype)
            x = xbc[..., :H * P].reshape(b, S, H, P)
            _, dt, A, _, _ = ssd_inputs(gen, b, S, H, P, N, dtype, slow)
            B, C = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
            gy, _, _ = check_ssd_main(
                f"K3 {case}, {'slow' if slow else 'JAX'} dt", x, dt, A, B, C,
                chunk, dtype)
            errs.append(gy["max_abs_err"])
        kernel_ms = time_ms(lambda: ops.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                                 impl="cuda"))
        plain_ms = time_ms(lambda: ssd_scan_ref(x, dt, A, B, C), reps=3,
                           warmup=1)
        flops, nbytes = ssd_work(b, S, H, P, N, chunk, 2)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        out[("K3",) + case] = dict(max_abs_err=max(errs), ms=kernel_ms,
                                   plain_ms=plain_ms, library_ms=None,
                                   bound_ms=bound_ms, bound_by=bound_by)
        log(f"  K3 {case}: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}"
            f"  library_ms none  bound_ms {bound_ms:.5f} ({bound_by}; "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; "
            f"{nbytes / kernel_ms / 1e6:.1f} GB/s achieved); "
            f"{grid_line(k3_lib.launch_shape(b, S, H, P, N, chunk, x.dtype))}")
    return out


def cached_path(model, params, what: str, inputs: dict, cache_len: int,
                steps: torch.Tensor, shadow_prefill: bool = True) -> dict:
    """Prefill ``inputs`` (``tokens=`` or ``embeds=``) into a cache of
    ``cache_len`` slots, timed, its last logits held against ``forward``'s
    (the same kernels on the same inputs); then decode ``steps`` [1, n]
    three times from copies of the prefilled cache: with K2, timed; with
    K2 under :class:`Shadow`; with the plain attention, whose logits the
    timed run's are held against.  With ``shadow_prefill`` one more
    prefill runs first, under :class:`Shadow`.  Returns the timed
    prefill's K3 launches, the timed decode's K2 launches and its ms per
    step."""
    cfg = model.cfg
    S = next(iter(inputs.values())).shape[1]
    attn_subs = cfg.layer_pattern.count("attn") * cfg.num_blocks
    mamba_subs = cfg.layer_pattern.count("mamba") * cfg.num_blocks
    with torch.inference_mode():
        cache = model.init_cache(1, cache_len, torch.bfloat16, "cuda")
        if shadow_prefill:
            with Shadow() as shadow:
                model.prefill(params, cache=cache, **inputs)
            shadow.check(f"{what} prefill of {S}")
        reset_counts(flash_attention)
        reset_counts(ssd_scan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = model.prefill(params, cache=cache, **inputs)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        k1, k3 = flash_attention.launches, ssd_scan.launches
        k1_tc = flash_attention.tensor_core_launches
        full, _ = model.forward(params, **inputs)
        prefill_ratio = rel_rms(last[:, 0], full[:, -1])
        del full
        snapshot = clone_tree(cache)
        reset_counts(decode_attention)
        kern, kern_ms = decode_loop(model, params, cache, steps, S, "auto")
        k2 = decode_attention.launches
        copy_tree(cache, snapshot)
        with Shadow() as shadow:
            decode_loop(model, params, cache, steps, S, "auto")
        shadow.check(f"{what} decode")
        plain, plain_ms = decode_loop(model, params, snapshot, steps, S,
                                      "ref")
        del snapshot, cache
    n = steps.shape[1]
    ratios = [rel_rms(a[:, 0], b[:, 0]) for a, b in zip(kern, plain)]
    log(f"  {what} prefill of {S} positions into {cache_len} slots: "
        f"{prefill_ms:.2f} ms, K1 launches {k1} ({k1_tc} on the tensor "
        f"cores), K3 launches {k3}; last logits vs forward's rms|d|/rms|ref| "
        f"{prefill_ratio:.3e} (limit {PREFILL_RMS_LIMIT})")
    log(f"  {what} {n} decode steps from slot {S}: K2 launches {k2}; ms per "
        f"step with K2 {[round(t, 2) for t in kern_ms]} (median "
        f"{np.median(kern_ms):.2f}), with the plain attention median "
        f"{np.median(plain_ms):.2f}; logits K2 vs plain rms|d|/rms|ref| per "
        f"step {[f'{r:.2e}' for r in ratios]} (limit {DECODE_RMS_LIMIT})")
    checks = {
        "K1 once per attention sublayer, on the tensor cores":
            k1 == k1_tc == attn_subs,
        "K3 once per Mamba2 sublayer": k3 == mamba_subs,
        "K2 once per attention sublayer and step": k2 == attn_subs * n,
        "prefill's last logits equal forward's":
            prefill_ratio <= PREFILL_RMS_LIMIT,
        "finite decode logits of the right shape": all(
            tuple(a.shape) == (1, 1, cfg.vocab_size)
            and bool(torch.isfinite(a).all()) for a in kern),
        "decode logits with K2 equal the plain attention's":
            max(ratios) <= DECODE_RMS_LIMIT,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{what} cached path: {failed}")
    return dict(k2=k2, k3=k3, ms_per_step=kern_ms)


def moe_block_work(cfg, rows: int, S: int, weight_bytes: int) -> tuple:
    """One MoE block's (flops, bytes) over ``rows`` x ``S`` tokens with the
    dense capacity dispatch: the attention projections and products, the
    router, the dispatch and combine einsums over every slot, the routed
    experts over every slot ([G, E, C] whatever the routing) and the shared
    experts; the block's weights read once and x read and written once."""
    m, d, hd = cfg.moe, cfg.d_model, cfg.head_dim
    T = rows * S
    Tg = moe_lib._group_tokens(T, S, 512)
    G, C = T // Tg, moe_lib.capacity_per_group(Tg, m)
    flops = 2 * T * (d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                     + cfg.num_heads * hd * d)
    flops += 4 * rows * cfg.num_heads * hd * attention_pairs(
        S, cfg.causal, cfg.sliding_window)
    flops += 2 * T * d * m.num_experts
    flops += 2 * 2 * G * Tg * m.num_experts * C * d
    flops += 3 * 2 * G * m.num_experts * C * d * m.d_expert
    flops += 3 * 2 * T * d * m.num_shared_experts * m.d_shared
    return flops, weight_bytes + 2 * T * d * 2


def burst_rows_alone(cfg, params, burst: list) -> None:
    """``burst``'s queries of LONG tokens arriving at once on a static
    4-stage split, served drained and one at a time (host clock); then the
    rows of one dispatch of all of them against each query alone at the
    same length, and the rows of one dispatch of copies of the first query
    against each other (equal unless a row reads another)."""
    static = ServingEngine(cfg, params, num_eps=4, scheduler="none",
                           device="cuda")
    static.executor.warm_buckets([LONG], MAX_BATCH)
    at_once = dict(workload="trace", workload_kwargs=dict(
        inter_arrivals=[0.0]))
    walls = {}
    for name, opts in (("solo", dict(max_batch=1)),
                       ("drained", dict(batching="drain",
                                        max_batch=MAX_BATCH,
                                        buckets=BUCKETS))):
        t0 = time.perf_counter()
        static.serve(burst, lambda q: [1.0] * 4, **at_once, **opts)
        walls[name] = time.perf_counter() - t0
    ex = static.executor
    with torch.inference_mode():
        batched, _ = ex.run_batch(burst, static.config)
        ratios = [rel_rms(batched[i], ex.run_query(q, static.config)[0][0])
                  for i, q in enumerate(burst)]
        finite = bool(torch.isfinite(batched).all())
        del batched
        copies, _ = ex.run_batch([burst[0]] * len(burst), static.config)
        same = max(rel_rms(copies[i], copies[0])
                   for i in range(1, len(burst)))
        del copies
    log(f"  {len(burst)} queries of {LONG} tokens arriving at once on "
        f"{static.config}, host clock: drained {walls['drained']:.4f} s, one "
        f"at a time {walls['solo']:.4f} s; the rows of one dispatch against "
        f"each query alone, rms|d|/rms|alone|: "
        f"{[f'{r:.3e}' for r in ratios]} (limit {BATCHED_LOGITS_RMS_LIMIT}; "
        f"groups of 512 tokens stay within a row at this power-of-two "
        f"length); {len(burst)} copies of one query in one dispatch, the "
        f"rows against row 0: max rms|d|/rms|row 0| {same:.3e}")
    if not (finite and max(ratios) <= BATCHED_LOGITS_RMS_LIMIT
            and same <= BATCHED_LOGITS_RMS_LIMIT):
        raise AssertionError(f"{cfg.name}: a batched row's logits differ "
                             f"from the query's alone: {ratios}, or from a "
                             f"copy's in the same dispatch: {same}")


def phase_deepseek(k1_ms: float) -> dict:
    """10a: full-width deepseek-moe-16b (see the module docstring)."""
    cfg, params = init_model(get_config("deepseek-moe-16b"))
    model = Model(cfg)
    rng = np.random.default_rng(10)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (MAX_BATCH, SEQ)),
                           device="cuda")
    bp = blk.block_params(params["blocks"], 0)
    sub = bp["sub0"]
    weight_bytes = tree_bytes(bp)
    with torch.inference_mode():
        x = params["embed"]["table"][toks[:1]]
        pos = torch.arange(SEQ, device="cuda").expand(1, SEQ)
        h = rms_norm(x, sub["ln1"]["scale"], cfg.rms_eps)
        a_kernel = attn_lib.attention_forward(sub["mixer"], cfg, h, pos)
        a_plain = attn_lib.attention_forward(sub["mixer"], cfg, h, pos,
                                             impl="ref")
        ratio = rel_rms(a_kernel, a_plain)
        logits, stats = model.forward(params, toks[:1])
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("deepseek-moe-16b: non-finite logits")
        dropped = float(stats["dropped_frac"]) / cfg.num_blocks
        for rows in (1, MAX_BATCH):
            xr = params["embed"]["table"][toks[:rows]]
            posr = torch.arange(SEQ, device="cuda").expand(rows, SEQ)
            hr = rms_norm(xr, sub["ln2"]["scale"], cfg.rms_eps)
            block_ms = time_ms(lambda: blk.block_forward(bp, cfg, xr, posr),
                               reps=10)
            moe_ms = time_ms(lambda: moe_lib.moe_forward(sub["ffn"], cfg.moe,
                                                         hr), reps=10)
            flops, nbytes = moe_block_work(cfg, rows, SEQ, weight_bytes)
            log(f"  one block at {rows} x {SEQ} tokens: {block_ms:.3f} ms "
                f"(CUDA events), of which the MoE sublayer {moe_ms:.3f} ms "
                f"({100 * moe_ms / block_ms:.0f}%); bounds: "
                f"{1e3 * flops / PEAK_BF16_FLOPS:.3f} ms of operations "
                f"({flops / 1e9:.1f} GFLOP at the bf16 peak), "
                f"{1e3 * nbytes / HBM_BW:.3f} ms of bytes "
                f"({weight_bytes / 2**30:.3f} GiB of weights); "
                f"{flops / block_ms / 1e9:.1f} TFLOP/s achieved")
    log(f"  block 0's attention sublayer, K1 vs plain attention: rms|d|/"
        f"rms|ref| {ratio:.3e} (limit {SUBLAYER_RMS_LIMIT}); one forward of "
        f"{SEQ} tokens: mean dropped_frac {dropped:.4f} over "
        f"{cfg.num_blocks} blocks (capacity {moe_lib.capacity_per_group(512, cfg.moe)}"
        f" slots per expert and group of 512), aux_loss "
        f"{float(stats['aux_loss']):.3f}, router_z "
        f"{float(stats['router_z']):.3f} (summed over blocks)")
    if not ratio <= SUBLAYER_RMS_LIMIT:
        raise AssertionError(f"deepseek block 0's attention with K1: "
                             f"{ratio:.3e}")
    served = serve_under_odin(cfg, params, flash_attention, "K1", k1_ms)
    want = {"tensor_core_launches": cfg.num_blocks * NUM_QUERIES,
            "fp32_launches": 0, "lse_launches": 0,
            "backward_launches": 0, "bf16_lse_launches": 0,
            "bf16_backward_launches": 0}
    if served["counts"] != want:
        raise AssertionError(f"K1 routes while serving: {served['counts']}")
    burst_rows_alone(cfg, params, list(toks[:, None]))
    cont = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (1, FAMILY_DECODE_STEPS)),
                           device="cuda")
    cached = cached_path(model, params, "deepseek-moe-16b",
                         dict(tokens=toks[:1]), CACHE_LEN, cont)
    step_bytes = (tree_bytes(params["blocks"]) + tree_bytes(params["head"])
                  + 2 * cfg.num_blocks * (SEQ + FAMILY_DECODE_STEPS)
                  * cfg.num_kv_heads * cfg.head_dim * 2)
    log(f"  a decode step reads every expert of every block (the dense "
        f"dispatch): {step_bytes / 2**30:.2f} GiB, "
        f"{1e3 * step_bytes / HBM_BW:.2f} ms at the HBM peak, "
        f"against a median step of {np.median(cached['ms_per_step']):.2f} ms")
    log_memory("deepseek-moe-16b")
    return dict(served=served, cached=cached)


def phase_hubert(k1_ms: float) -> dict:
    """10b: full-width hubert-xlarge."""
    cfg, params = init_model(get_config("hubert-xlarge"))
    model = Model(cfg)
    rng = np.random.default_rng(11)
    # The frame embeddings of the stubbed feature extractor: rows of the
    # model's own 504-row table, the scale of its embeddings.
    frames = params["embed"]["table"][torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, SEQ)), device="cuda")]
    with torch.inference_mode():
        reset_counts(flash_attention)
        with Shadow() as shadow:
            logits, _ = model.forward(params, embeds=frames)
        counts = route_counts()
        shadow.check(f"hubert-xlarge forward(embeds=) over {SEQ} frames")
        ok = (tuple(logits.shape) == (1, SEQ, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()))
    log(f"  hubert-xlarge forward: K1 launches by route {counts} "
        f"(bidirectional, D {cfg.head_dim})")
    if not ok or counts != {"tensor_core_launches": cfg.num_blocks,
                            "fp32_launches": 0}:
        raise AssertionError(f"hubert-xlarge forward: {counts}, logits ok "
                             f"{ok}")
    served = serve_under_odin(cfg, params, flash_attention, "K1", k1_ms,
                              num_queries=HUBERT_QUERIES, rebalance=False)
    if served["counts"]["fp32_launches"]:
        raise AssertionError(f"K1 routes while serving: {served['counts']}")
    log_memory("hubert-xlarge")
    return dict(served=served)


def phase_llava() -> dict:
    """10c: full-width llava-next-34b, alone on the card."""
    cfg, params = init_model(get_config("llava-next-34b"))
    model = Model(cfg)
    rng = np.random.default_rng(12)
    gen = torch.Generator(device="cuda").manual_seed(12)
    # The anyres frontend is a stub: patch embeddings drawn at the scale of
    # the token embeddings, then the text's token embeddings.
    patches = (torch.randn((1, NUM_PATCH_TOKENS, cfg.d_model), generator=gen,
                           device="cuda") * cfg.d_model ** -0.5)
    text = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, LLAVA_TEXT)),
                           device="cuda")
    embeds = torch.cat([patches.to(torch.bfloat16),
                        params["embed"]["table"][text]], dim=1)
    del patches
    S = embeds.shape[1]
    with torch.inference_mode():
        reset_counts(flash_attention)
        with Shadow() as shadow:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model.forward(params, embeds=embeds)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
        counts = route_counts()
        shadow.check(f"llava-next-34b forward(embeds=) over {S} positions")
        ok = (tuple(logits.shape) == (1, S, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()))
        del logits
    log(f"  llava-next-34b forward over {NUM_PATCH_TOKENS} patch and "
        f"{LLAVA_TEXT} token embeddings: {fwd_s:.3f} s with the checks; K1 "
        f"launches by route {counts}")
    if not ok or counts["tensor_core_launches"] != cfg.num_blocks:
        raise AssertionError(f"llava-next-34b forward: {counts}, logits ok "
                             f"{ok}")
    cont = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (1, FAMILY_DECODE_STEPS)),
                           device="cuda")
    cached = cached_path(model, params, "llava-next-34b",
                         dict(embeds=embeds), LLAVA_CACHE, cont,
                         shadow_prefill=False)
    log_memory("llava-next-34b")
    return dict(cached=cached)


def phase_mixtral() -> dict:
    """10d: mixtral-8x22b at full width, depth cut to MIXTRAL_BLOCKS."""
    full = get_config("mixtral-8x22b")
    log(f"  reduced: mixtral-8x22b depth {MIXTRAL_BLOCKS} of "
        f"{full.num_blocks} blocks at full width ({full.param_count() / 1e9:.1f}"
        f" B parameters, {2 * full.param_count() / 2**30:.1f} GiB in bf16, do "
        f"not fit one 80 GB card)")
    cfg, params = init_model(dataclasses.replace(full,
                                                 num_layers=MIXTRAL_BLOCKS))
    model = Model(cfg)
    rng = np.random.default_rng(13)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, MIXTRAL_SEQ)),
                           device="cuda")
    cont = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (1, FAMILY_DECODE_STEPS)),
                           device="cuda")
    cached = cached_path(model, params, f"mixtral-8x22b (window "
                         f"{cfg.sliding_window})", dict(tokens=toks),
                         MIXTRAL_CACHE, cont)
    log_memory("mixtral-8x22b")
    return dict(cached=cached)


def phase_jamba() -> dict:
    """10e: jamba-1.5-large at its smoke width."""
    full = get_config("jamba-1.5-large-398b")
    cfg = get_smoke_config("jamba-1.5-large-398b")
    per_block = 2 * full.param_count() / full.num_blocks / 2**30
    log(f"  reduced: jamba-1.5-large-398b at its smoke width (d_model "
        f"{cfg.d_model}, {cfg.num_blocks} block of {cfg.layer_pattern}, MoE "
        f"on sublayers {[i for i in range(len(cfg.layer_pattern)) if cfg.sublayer_is_moe(i)]}"
        f", {cfg.moe.num_experts} experts): one published block is "
        f"{per_block:.1f} GiB in bf16, more than one 80 GB card holds")
    cfg, params = init_model(cfg)
    model = Model(cfg)
    rng = np.random.default_rng(14)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, SEQ)),
                           device="cuda")
    with torch.inference_mode():
        reset_counts(flash_attention)
        reset_counts(ssd_scan)
        with Shadow() as shadow:
            logits, stats = model.forward(params, toks)
        k1, k3 = flash_attention.launches, ssd_scan.launches
        shadow.check(f"jamba forward over {SEQ} tokens")
        ok = bool(torch.isfinite(logits).all())
    log(f"  jamba forward: K1 launches {k1}, K3 launches {k3}, dropped_frac "
        f"{float(stats['dropped_frac']):.4f} (summed over its "
        f"{len(cfg.layer_pattern) // cfg.moe.every} MoE sublayers)")
    if not (ok and k1 == cfg.num_blocks and k3 == 7 * cfg.num_blocks):
        raise AssertionError(f"jamba forward: K1 {k1}, K3 {k3}, finite {ok}")
    cont = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (1, FAMILY_DECODE_STEPS)),
                           device="cuda")
    cached = cached_path(model, params, "jamba (smoke width)",
                         dict(tokens=toks), CACHE_LEN, cont)
    log_memory("jamba (smoke width)")
    return dict(cached=cached, k3=k3)


def serve_scheduler(cfg, params, scheduler, label: str,
                    **engine_kw) -> tuple:
    """Phase 6's traffic (NUM_QUERIES closed-loop queries of SEQ tokens on
    4 stages, SLOW_FACTOR on stage SLOW_EP for queries SLOW_FROM..SLOW_TO)
    through ``api.run(RunSpec(engine=...))``.  Every query must be served
    on configs that conserve blocks, with K1's tensor-core kernel once per
    block and query; the logits must not depend on the split."""
    rng = np.random.default_rng(0)
    eng = ServingEngine(cfg, params, num_eps=4, scheduler=scheduler,
                        alpha=3, device="cuda", **engine_kw)
    eng.executor.warmup(1, SEQ)
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, SEQ)),
                               device="cuda")
               for _ in range(NUM_QUERIES)]
    start = eng.config
    reset_counts(flash_attention)
    t0 = time.perf_counter()
    trace = api.run(api.RunSpec(engine=eng, queries=queries,
                                schedule=schedule))
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    want = cfg.num_blocks * NUM_QUERIES
    if not launches == flash_attention.tensor_core_launches == want:
        raise AssertionError(
            f"{label}: K1 launched {launches} times "
            f"({flash_attention.tensor_core_launches} on the tensor cores),"
            f" expected {want}")
    if len(trace.latencies) != NUM_QUERIES:
        raise AssertionError(f"{label}: served {len(trace.latencies)} of "
                             f"{NUM_QUERIES} queries")
    if any(sum(c) != cfg.num_blocks for c in trace.configs):
        raise AssertionError(f"{label}: a config lost blocks: "
                             f"{trace.configs}")
    check_split_logits(eng, queries[0], start, trace.configs[-1])
    s = trace.summary()
    log(f"  {label}: {NUM_QUERIES} queries in {wall:.2f} s, rebalances "
        f"{trace.num_rebalances}, trials {trace.total_trials}, serial_frac "
        f"{s['serial_frac']:.3f}, mean latency {s['mean_latency_s']:.4f} s,"
        f" K1 launches {launches}")
    log(f"  {label} committed configs: {committed_configs(trace)}")
    return eng, trace, launches


def moved_off_slowed_stage(trace, start: list) -> bool:
    return min(c[SLOW_EP] for c in trace.configs[SLOW_FROM:SLOW_TO]) < \
        start[SLOW_EP]


def phase_hybrid(cfg, params, odin: dict) -> dict:
    """11a: the hybrid policy (LLS's move, then ODIN on a plateau)."""
    eng, trace, launches = serve_scheduler(cfg, params, "hybrid", "hybrid")
    s, o = trace.summary(), odin["summary"]
    log(f"  hybrid / phase 6's ODIN: rebalances {s['rebalances']} / "
        f"{o['rebalances']}, serial_frac {s['serial_frac']:.3f} / "
        f"{o['serial_frac']:.3f}, mean latency {s['mean_latency_s']:.4f} / "
        f"{o['mean_latency_s']:.4f} s")
    log(f"  phase 6's ODIN committed configs: {odin['committed']}")
    start = eng._initial_config
    if trace.num_rebalances < 1:
        raise AssertionError("hybrid never rebalanced")
    if not moved_off_slowed_stage(trace, start):
        raise AssertionError(f"hybrid moved no blocks off stage {SLOW_EP}: "
                             f"{trace.configs[SLOW_FROM:SLOW_TO]}")
    return dict(engine=eng, trace=trace, launches=launches)


def phase_oracle(cfg, params, hybrid: dict) -> dict:
    """11b: the DP oracle live, with its solver built here from the
    engine's time source: one database column per EP (the estimated
    block times times that EP's slowdown), EP e on column e."""
    def solver(config, source):
        table = source.block_times[:, None] * source.slowdowns[None, :]
        n = table.shape[1]
        db = LayerDatabase(table, [f"ep{e}" for e in range(n)])
        return optimal_partition(db, list(range(n)), n)[0]

    eng, trace, launches = serve_scheduler(cfg, params, OraclePolicy(solver),
                                           "oracle")
    s = trace.summary()
    changes = sum(a != b for a, b in zip(trace.configs, trace.configs[1:]))
    heng, htrace = hybrid["engine"], hybrid["trace"]
    # Both episode configs priced on the hybrid engine's final clean
    # estimates under the episode's slowdowns.
    src = MeasuredTimeSource(heng._block_times, schedule(SLOW_TO - 1))
    ep_o = float(src.stage_times(trace.configs[SLOW_TO - 1]).max())
    ep_h = float(src.stage_times(htrace.configs[SLOW_TO - 1]).max())
    log(f"  oracle: serial_frac {s['serial_frac']} (0 expected: its trials "
        f"are instant), rebalances {trace.num_rebalances} (the oracle's "
        f"commits cost no serial query and are not counted), "
        f"{changes} config changes over {NUM_QUERIES} queries")
    log(f"  final estimated bottleneck: oracle "
        f"{1e3 * eng.runtime.estimated_bottleneck():.3f} ms, hybrid "
        f"{1e3 * heng.runtime.estimated_bottleneck():.3f} ms; in the "
        f"episode (query {SLOW_TO - 1}, hybrid's estimates): oracle "
        f"{trace.configs[SLOW_TO - 1]} {1e3 * ep_o:.3f} ms, hybrid "
        f"{htrace.configs[SLOW_TO - 1]} {1e3 * ep_h:.3f} ms")
    if s["serial_frac"] != 0.0 or trace.total_trials != 0:
        raise AssertionError(f"the oracle ran serial trials: {s}")
    if not moved_off_slowed_stage(trace, eng._initial_config):
        raise AssertionError(f"the oracle moved no blocks off stage "
                             f"{SLOW_EP}: {trace.configs[SLOW_FROM:SLOW_TO]}")
    return dict(launches=launches, changes=changes)


def coll_schedule(q: int) -> float:
    return MESH_CF if MESH_CF_FROM <= q < MESH_CF_TO else 1.0


def check_mesh_trace(trace, n: int, label: str) -> np.ndarray:
    """Every assignment on MESH_DEVICES with each stage at least 1, and
    each query's collective share in [0, 1)."""
    if trace.mesh_trace is None or len(trace.mesh_trace) != n:
        raise AssertionError(f"{label}: no mesh trace")
    bad = [a for a in trace.mesh_trace
           if sum(a) != MESH_DEVICES or min(a) < 1]
    if bad:
        raise AssertionError(f"{label}: invalid assignments {bad[:4]}")
    fr = np.asarray(trace.collective_fracs, float)
    if fr.shape != (n,) or not bool(np.all((fr >= 0.0) & (fr < 1.0))):
        raise AssertionError(f"{label}: collective shares outside [0, 1): "
                             f"{fr.min()}..{fr.max()}")
    return fr


def phase_mesh(cfg, params, hybrid: dict) -> dict:
    """11c: ODIN over (boundary, slice) moves (MeshOdinExplorer) on a
    modelled mesh of MESH_DEVICES devices, with collective contention on
    top of the compute slowdown.  The card runs every stage as before:
    the mesh is the scheduler's model over the measured times."""
    mean_block = float(np.mean(hybrid["engine"]._block_times))
    mesh = MeshSpec(devices=MESH_DEVICES,
                    coll_cost=MESH_COLL_FRACTION * mean_block)
    log(f"  mesh: {MESH_DEVICES} devices, coll_cost {MESH_COLL_FRACTION} x "
        f"the measured mean clean block time {1e3 * mean_block:.3f} ms = "
        f"{1e3 * mesh.coll_cost:.4f} ms a block; collective contention "
        f"{MESH_CF}x for queries {MESH_CF_FROM}..{MESH_CF_TO - 1}")
    eng, trace, launches = serve_scheduler(
        cfg, params, "odin", "odin + mesh", mesh=mesh,
        coll_factor_schedule=coll_schedule)
    fr = check_mesh_trace(trace, NUM_QUERIES, "11c")
    dedup = [a for i, a in enumerate(trace.mesh_trace)
             if i == 0 or a != trace.mesh_trace[i - 1]]
    modelled = 1.0 / np.asarray(trace.throughputs, float)
    log(f"  num_mesh_resizes {trace.num_mesh_resizes}, mesh trace "
        f"{dedup}, collective_fracs mean {fr.mean():.4f} max "
        f"{fr.max():.4f}")
    log(f"  per query, median: modelled bottleneck stage "
        f"{1e3 * float(np.median(modelled)):.3f} ms (the measured stage "
        f"divided by its devices, plus the collective term); host-clock "
        f"service latency "
        f"{1e3 * float(np.median(trace.service_latencies)):.3f} ms (all "
        f"four stages on the one card)")
    if trace.num_rebalances < 1:
        raise AssertionError("ODIN never rebalanced with the mesh armed")
    return dict(launches=launches, resizes=trace.num_mesh_resizes)


def phase_measured_db(cfg, params) -> dict:
    """11d: block times measured on the card (K1 in every block) make a
    layer database; the simulator compares the policies over it."""
    rng = np.random.default_rng(2)
    eng = ServingEngine(cfg, params, num_eps=4, device="cuda")
    eng.executor.warmup(1, SEQ)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, SEQ)),
                             device="cuda")
    reset_counts(flash_attention)
    bt = eng.executor.measure_block_times(tokens, repeats=3)
    launches = flash_attention.launches
    if not launches == flash_attention.tensor_core_launches == \
            3 * cfg.num_blocks:
        raise AssertionError(f"measure_block_times launched K1 {launches} "
                             f"times, expected 3 x {cfg.num_blocks}")
    if bt.shape != (cfg.num_blocks,) or not bool(np.all(bt > 0)):
        raise AssertionError(f"bad block times {bt}")
    log(f"  block times at 1 x {SEQ} tokens (min of 3, host clock, "
        f"synchronised): sum {1e3 * bt.sum():.3f} ms, per block min "
        f"{1e3 * bt.min():.3f} median {1e3 * float(np.median(bt)):.3f} max "
        f"{1e3 * bt.max():.3f} ms")
    db = transformer_database(bt, seed=0)
    events = generate_events(SIM_QUERIES, 4, db.num_scenarios, 10, 10,
                             seed=0)
    shares = compare_policies(db, events, "11d")

    mesh = MeshSpec(devices=MESH_DEVICES,
                    coll_cost=MESH_COLL_FRACTION * float(np.mean(bt)))
    mesh_events = list(events) + [InterferenceEvent(
        start=SIM_QUERIES // 3, duration=SIM_QUERIES // 4, ep=0,
        scenario=0, kind="mesh", factor=MESH_CF)]
    mesh_runs = {name: simulate_policy(db, name, events=mesh_events,
                                       mesh=mesh)[0]
                 for name in ("odin", "oracle")}
    mbest = mesh_runs["oracle"].summary()["mean_throughput_qps"]
    for name, trace in mesh_runs.items():
        s = trace.summary()
        fr = check_mesh_trace(trace, SIM_QUERIES, f"11d {name}")
        log(f"  mesh {name:>6}: mean throughput "
            f"{s['mean_throughput_qps']:.3f} q/s = "
            f"{s['mean_throughput_qps'] / mbest:.4f} of the mesh oracle's, "
            f"serial_frac {s['serial_frac']:.4f}, rebalances "
            f"{trace.num_rebalances}, mesh resizes "
            f"{trace.num_mesh_resizes}, collective share mean "
            f"{fr.mean():.4f}")
    if mesh_runs["odin"].summary()["mean_throughput_qps"] > mbest * (1 + 1e-9):
        raise AssertionError("odin beat the mesh oracle")
    return dict(launches=launches, shares=shares, bt=bt,
                executor=eng.executor, tokens=tokens)


def simulate_policy(db, name: str, **kw) -> tuple:
    """SIM_QUERIES simulated queries over ``db`` on 4 EPs under ``name``
    through ``api.run``; (trace, seconds)."""
    t0 = time.perf_counter()
    trace = api.run(api.RunSpec(
        db=db, num_eps=4, num_queries=SIM_QUERIES,
        scheduler=api.SchedulerSpec(name=name), **kw))
    if len(trace.latencies) != SIM_QUERIES or not bool(
            np.all(np.isfinite(trace.latencies))):
        raise AssertionError(f"simulation under {name}: bad latencies")
    return trace, time.perf_counter() - t0


def compare_policies(db, events, label: str, beside=None) -> dict:
    """SIM_POLICIES over ``db`` and ``events``: each mean throughput as a
    share of the oracle's (``beside``'s shares printed next to them), which
    no policy may beat; odin's chunked and scalar runs must be equal."""
    runs = {name: simulate_policy(db, name, events=events)
            for name in SIM_POLICIES}
    best = runs["oracle"][0].summary()["mean_throughput_qps"]
    shares = {}
    for name, (trace, secs) in runs.items():
        s = trace.summary()
        shares[name] = s["mean_throughput_qps"] / best
        log(f"  {label} {name:>6}: mean throughput "
            f"{s['mean_throughput_qps']:.3f} q/s = {shares[name]:.4f} of the "
            f"oracle's"
            + ("" if beside is None else f" (11d: {beside[name]:.4f})")
            + f", serial_frac {s['serial_frac']:.4f}, rebalances "
            f"{trace.num_rebalances}, trials {trace.total_trials} "
            f"({secs:.2f} s)")
    if max(shares.values()) > 1.0 + 1e-9:
        raise AssertionError(f"{label}: a policy beat the oracle: {shares}")
    scalar, _ = simulate_policy(db, "odin", events=events,
                                batching=api.BatchingSpec(chunking=False))
    if not np.array_equal(scalar.latencies, runs["odin"][0].latencies):
        raise AssertionError(f"{label}: odin's chunked and scalar "
                             "simulations differ")
    return shares


def phase_interference_db(cfg, d: dict) -> dict:
    """11e: the paper's measured database (§3.3) for full-width qwen3-4b on
    11d's executor and tokens: every block timed alone and under the
    Table-1 stressors and the card co-tenants, MDB_REPEATS passes each
    (``repro_torch.launch.measured_db.measure``); saved, loaded back, and
    the policies compared over it as 11d compares them over the synthetic
    database."""
    scenarios = scenarios_table1() + card_scenarios()
    names = [sc.name for sc in scenarios]
    dev = torch.device("cuda")
    log(f"  card memory before the co-tenants: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated and "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved by this "
        f"process, {torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB free")
    reset_counts(flash_attention)
    m = measured_db.measure(d["executor"], d["tokens"], scenarios,
                            MDB_REPEATS, log=log)
    launches = flash_attention.launches
    want = len(scenarios) * MDB_REPEATS * cfg.num_blocks
    if not launches == flash_attention.tensor_core_launches == want:
        raise AssertionError(
            f"11e: K1 launched {launches} times "
            f"({flash_attention.tensor_core_launches} on the tensor cores), "
            f"expected {len(scenarios)} x {MDB_REPEATS} x {cfg.num_blocks}")
    db = measured_db.database(m, cfg)
    if db.table.shape != (cfg.num_blocks, len(scenarios)) or \
            db.scenario_names != names or names[:11] != [
                sc.name for sc in scenarios_table1()]:
        raise AssertionError(f"11e: database {db.table.shape}, "
                             f"{db.scenario_names}")
    if not bool(np.all(np.isfinite(db.table)) and np.all(db.table > 0)):
        raise AssertionError(f"11e: entries not finite and positive: "
                             f"{db.table}")
    meta = measured_db.run_meta(dev, m)
    out = ROOT / "build" / "chip_smoke_measured_db.json"
    measured_db.save(db, meta, str(out))
    back = LayerDatabase.load(str(out))
    if not (np.array_equal(back.table, db.table)
            and back.scenario_names == names
            and back.unit_names == db.unit_names
            and back.model_name == f"{cfg.name}-measured"):
        raise AssertionError(f"11e: {out} does not load back equal")
    log(f"  database {db.table.shape} -> {out.relative_to(ROOT)} (loads back "
        f"equal), sidecar {Path(measured_db.meta_path(str(out))).name}")
    log(f"  {measured_db.describe(meta)}")
    col0 = m.table[:, 0]
    log(f"  column 0 sum {1e3 * col0.sum():.3f} ms against 11d's clean sum "
        f"{1e3 * d['bt'].sum():.3f} ms (x{col0.sum() / d['bt'].sum():.3f}; "
        f"not gated)")
    events = generate_events(SIM_QUERIES, 4, db.num_scenarios, 10, 10,
                             seed=0)
    shares = compare_policies(db, events, "11e", beside=d["shares"])
    return dict(launches=launches, shares=shares)


# ---------------------------------------------------------------------------
# Phase 12: fleets, admission control, faults and QoS tiers

class RunCounter:
    """Counts an executor's forwards (``run_query``: every query,
    ``run_batch`` dispatch and warm-up goes through it) and the rows they
    carried, while active."""

    def __init__(self, executor):
        self.executor, self.calls, self.rows = executor, 0, 0

    def __enter__(self):
        orig = self.executor.run_query

        def run_query(tokens, *a, **k):
            self.calls += 1
            self.rows += int(tokens.shape[0])
            return orig(tokens, *a, **k)

        self.executor.run_query = run_query
        return self

    def __exit__(self, *exc):
        del self.executor.run_query
        return False


class K1Shapes:
    """While active, counts every K1 launch the models make through
    ``ops`` by shape, and keeps the inputs and output of the first launch
    of each distinct shape; ``check`` then holds each against the plain
    version on those inputs, bf16 at MAIN_TOLERANCE and MAIN_RMS_LIMIT,
    fp32 at ``tolerance("float32")``.  Nothing here launches a kernel, so
    the launch counts stay those of the path."""

    def __init__(self):
        self.counts, self.first = {}, {}

    def __enter__(self):
        self._saved = ops.flash_attention
        fa = self._saved

        def flash(q, k, v, *, causal=True, window=None, impl="auto"):
            out = fa(q, k, v, causal=causal, window=window, impl=impl)
            if impl != "ref":
                key = (int(q.shape[0]), int(q.shape[1]), int(k.shape[1]),
                       int(q.shape[2]), int(q.shape[3]), causal, window,
                       str(q.dtype).replace("torch.", ""))
                self.counts[key] = self.counts.get(key, 0) + 1
                if key not in self.first:
                    self.first[key] = tuple(t.detach().clone()
                                            for t in (q, k, v, out))
            return out

        ops.flash_attention = flash
        return self

    def __exit__(self, *exc):
        ops.flash_attention = self._saved
        return False

    def check(self) -> dict:
        """Each distinct shape's first launch against the plain version,
        bf16 at MAIN_TOLERANCE and MAIN_RMS_LIMIT, fp32 at
        ``tolerance("float32")`` with no rms limit; returns the
        readings."""
        out = {}
        for key, (q, k, v, got) in self.first.items():
            causal, window = key[5], key[6]
            # bf16 at the main path's limits, fp32 at the fp32 cases' one
            tol, rms_limit = ((MAIN_TOLERANCE, MAIN_RMS_LIMIT)
                              if key[7] == "bfloat16"
                              else (tolerance(key[7]), None))
            r = compare(got, flash_attention_ref(q, k, v, causal=causal,
                                                 window=window),
                        tol, f"K1 launch {key}", rms_limit)
            out[key] = dict(r, launches=self.counts[key])
            log(f"  K1 {key}: {self.counts[key]} launches; the first "
                f"against the plain version on its inputs: max |err| "
                f"{r['max_abs_err']:.3e}, rms err / rms ref "
                f"{r['rms_err'] / r['rms_ref']:.3e} (limits "
                f"{tol}, rms {rms_limit})")
        self.first.clear()
        return out


class K1TrainLaunches:
    """While active, keeps the inputs and outputs of the first launch of
    K1's fp32 LSE entry point (``forward_for_backward``) and of its fp32
    backward kernel at each distinct shape, as a training step makes them
    through K1's autograd function; ``check`` then holds each against the
    plain version on those inputs: the output at ``tolerance("float32")``,
    dq, dk and dv at BACKWARD_LIMIT of max |ref|.  Nothing here launches a
    kernel, so the launch counts stay those of the path."""

    def __init__(self):
        self.first = {}

    def _keep(self, kind, q, k, causal, window, ins, outs):
        key = (kind, int(q.shape[0]), int(q.shape[1]), int(k.shape[1]),
               int(q.shape[2]), int(q.shape[3]), causal, window,
               str(q.dtype).replace("torch.", ""))
        if key not in self.first:
            self.first[key] = tuple(tuple(t.detach().clone() for t in ts)
                                    for ts in (ins, outs))

    def __enter__(self):
        self._saved = fwd, bwd = k1_lib.forward_for_backward, k1_lib.backward

        def forward_for_backward(q, k, v, *, causal=True, window=None):
            out = fwd(q, k, v, causal=causal, window=window)
            self._keep("fwd", q, k, causal, window, (q, k, v), out[:1])
            return out

        def backward(q, k, v, o, lse, do, *, causal=True, window=None):
            grads = bwd(q, k, v, o, lse, do, causal=causal, window=window)
            self._keep("bwd", q, k, causal, window, (q, k, v, do), grads)
            return grads

        k1_lib.forward_for_backward, k1_lib.backward = (forward_for_backward,
                                                        backward)
        return self

    def __exit__(self, *exc):
        k1_lib.forward_for_backward, k1_lib.backward = self._saved
        return False

    def check(self) -> dict:
        """Each kept launch against the plain version; returns the worst
        max |err| of each kind ("fwd", "bwd")."""
        worst = dict(fwd=0.0, bwd=0.0)
        for key, (ins, outs) in self.first.items():
            kind, causal, window, dtype = key[0], key[6], key[7], key[8]
            if dtype != "float32":
                raise AssertionError(f"K1 training launch {key}: only the "
                                     f"fp32 route is held here")
            if kind == "fwd":
                q, k, v = ins
                r = compare(outs[0], flash_attention_ref(
                    q, k, v, causal=causal, window=window),
                    tolerance(dtype), f"K1 LSE launch {key}")
                err = r["max_abs_err"]
                log(f"  K1 LSE entry {key[1:]}: the first launch against "
                    f"the plain version on its inputs: max |err| "
                    f"{err:.3e} (limits {tolerance(dtype)})")
            else:
                q, k, v, do = ins
                want = flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                               window=window)
                torch.cuda.synchronize()
                ratios = [max_ratio(g, w) for g, w in zip(outs, want)]
                err = max(float((g - w).abs().max())
                          for g, w in zip(outs, want))
                log(f"  K1 backward {key[1:]}: the first launch against "
                    f"the plain backward on its inputs: max|err|/max|ref| "
                    f"dq {ratios[0]:.3e} dk {ratios[1]:.3e} dv "
                    f"{ratios[2]:.3e} (limit {BACKWARD_LIMIT}), max |err| "
                    f"{err:.3e}")
                if not (max(ratios) <= BACKWARD_LIMIT and all(
                        bool(torch.isfinite(g).all()) for g in outs)):
                    raise AssertionError(f"K1 backward launch {key}: "
                                         f"{ratios} (limit "
                                         f"{BACKWARD_LIMIT})")
            worst[kind] = max(worst[kind], err)
        if not all(any(key[0] == kind for key in self.first)
                   for kind in worst):
            raise AssertionError(f"K1 training launches kept: "
                                 f"{list(self.first)}")
        self.first.clear()
        return worst


class ProbeCounter(HealthTracker):
    """The fleet's circuit breaker, counting its probes: a dispatch to a
    replica whose breaker went half-open (the first ``take_rewarm`` of
    each half-open spell), per replica; and the recovery times its crash
    failures reported.  A time-indexed crash fails exactly the dispatches
    of queries that arrived inside its window, and reports the window's
    end, so ``crash_untils[r]`` holds one entry per such dispatch."""

    made = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.probes = [0] * self.num_replicas
        self._spell = [False] * self.num_replicas
        self.opens = [0] * self.num_replicas
        self.crash_untils = [[] for _ in range(self.num_replicas)]
        ProbeCounter.made.append(self)

    def healthy(self, r, now):
        before = self.state(r)
        ok = super().healthy(r, now)
        if before == OPEN and self.state(r) == HALF_OPEN:
            self._spell[r] = True
        return ok

    def take_rewarm(self, r):
        if self._spell[r]:
            self._spell[r] = False
            self.probes[r] += 1
        return super().take_rewarm(r)

    def record_failure(self, r, now, until=float("nan")):
        if until == until:             # a crash: its known recovery time
            self.crash_untils[r].append(until)
        before = self.state(r)
        super().record_failure(r, now, until=until)
        if before != OPEN and self.state(r) == OPEN:
            self.opens[r] += 1


def fleet_engines(cfg, params, executor, n: int) -> list:
    """``n`` fresh ODIN engines (4 stages, alpha 3) over one shared
    executor: each keeps its own runtime, detector and estimates."""
    return [ServingEngine(cfg, params, num_eps=4, scheduler="odin", alpha=3,
                          executor=executor,
                          device=executor.device) for _ in range(n)]


def fleet_schedules(n: int, slow_replica=None) -> list:
    """Per-replica slowdown schedules: SLOW_FACTOR on stage SLOW_EP of
    ``slow_replica`` for the whole run, every other replica clean."""
    def make(r):
        slow = [1.0] * 4
        if r == slow_replica:
            slow[SLOW_EP] = SLOW_FACTOR
        return lambda q: list(slow)
    return [make(r) for r in range(n)]


def fleet_line(label: str, trace, wall: float) -> dict:
    s = trace.summary()
    log(f"  {label}: {trace.num_queries} offered in {wall:.2f} s, served "
        f"per replica {trace.replica_counts.tolist()}, shed "
        f"{trace.num_shed}, failed {int(s['num_failed'])}; p50 "
        f"{s['p50_latency_s']:.4f} s, p99 {s['p99_latency_s']:.4f} s, mean "
        f"queue delay {s['mean_queue_delay_s']:.4f} s, mean service "
        f"{s['mean_service_latency_s']:.4f} s, achieved load "
        f"{s['achieved_load_qps']:.2f} q/s of {s['offered_load_qps']:.2f} "
        f"offered")
    return s


def serve_fleet(label: str, engines, queries, schedules, counters,
                **kw) -> tuple:
    """``serve_cluster`` over ``engines``; raises unless every query is
    accounted once (served, shed or failed), each replica's local slots
    are filled once in order, and the executors ran exactly the served
    queries (a shed query or a failed attempt runs nothing)."""
    before = [(c.calls, c.rows) for c in counters]
    t0 = time.perf_counter()
    trace = serve_cluster(engines, queries, schedules, **kw)
    wall = time.perf_counter() - t0
    s = fleet_line(label, trace, wall)
    rows = sum(c.rows - r0 for c, (_, r0) in zip(counters, before))
    n = len(queries)
    served = int(trace.replica_counts.sum())
    failed = int(np.count_nonzero(trace.assignments == -2))
    checks = {
        "every query accounted once": trace.num_queries == n
        and served + trace.num_shed + failed == n,
        "failed = the summary's num_failed": failed == int(s["num_failed"]),
        "local slots filled once, in order": all(
            sorted(trace.local_indices[trace.assignments == r].tolist())
            == list(range(int(trace.replica_counts[r])))
            for r in range(len(engines))),
        "each replica trace holds its served queries": all(
            len(t.latencies) == c
            for t, c in zip(trace.replicas, trace.replica_counts)),
        "the executors ran exactly the served queries": rows == served,
    }
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"{label}: {bad} (served {served}, shed "
                             f"{trace.num_shed}, failed {failed}, rows run "
                             f"{rows})")
    return trace, s, rows


def probe_fleet_rate(cfg, params, executor, queries) -> dict:
    """A closed-loop probe of one clean replica: its service latency s.
    The fleet rate is R = FLEET_REPLICAS / s, each replica serving one
    query at a time: ODIN's trials run alone, and they are most of the
    queries of a served run on this card (ROADMAP Queue 3).  The trace's
    pipelined throughput (1 / bottleneck stage) is printed beside it."""
    eng = fleet_engines(cfg, params, executor, 1)[0]
    trace = eng.serve(queries[:FLEET_PROBE_QUERIES], lambda q: [1.0] * 4)
    service = float(np.median(trace.service_latencies[4:]))
    thr = float(np.median(trace.throughputs[4:]))
    rate = FLEET_REPLICAS / service
    log(f"  probe ({FLEET_PROBE_QUERIES} closed-loop queries of {SEQ} "
        f"tokens, one clean replica; medians of the last "
        f"{FLEET_PROBE_QUERIES - 4}): service s = {1e3 * service:.2f} ms, "
        f"pipelined throughput {thr:.2f} q/s (1 / bottleneck stage); "
        f"fleet rate R = {FLEET_REPLICAS} / s = {rate:.2f} q/s")
    return dict(service=service, rate=rate)


def bursty_at(rate: float, seed: int) -> dict:
    """Bursty arrivals of mean rate ``rate``: bursts at 2x it, gaps at a
    quarter of it, mean burst 0.75x the mean gap (12 arrivals)."""
    return dict(workload="bursty", workload_kwargs=dict(
        burst_rate=2.0 * rate, base_rate=0.25 * rate,
        mean_burst=9.0 / rate, mean_gap=12.0 / rate, seed=seed))


def phase_routers(cfg, params, ex, counters, queries, probe) -> dict:
    """12a: FLEET_REPLICAS replicas, SLOW_FACTOR on one stage of replica
    FLEET_SLOW_REPLICA only, bursty traffic at FLEET_LOAD x the probe's
    fleet rate; round_robin, odin_aware, then odin_aware with fleet
    rebatching (max_batch FLEET_MAX_BATCH, through run_batch)."""
    wl = bursty_at(FLEET_LOAD * probe["rate"], seed=1)
    log(f"  bursty at {FLEET_LOAD} x R: mean "
        f"{FLEET_LOAD * probe['rate']:.2f} q/s (bursts "
        f"{wl['workload_kwargs']['burst_rate']:.2f} q/s)")
    out = {}
    for label, kw in (("round_robin", dict(router="round_robin")),
                      ("odin_aware", dict(router="odin_aware")),
                      ("odin_aware, max_batch 4",
                       dict(router="odin_aware",
                            max_batch=FLEET_MAX_BATCH))):
        engines = fleet_engines(cfg, params, ex, FLEET_REPLICAS)
        before = counters[0].calls
        trace, s, rows = serve_fleet(
            f"12a {label}", engines,
            queries[:SHORT_QUERIES] if "max_batch" in kw else queries,
            fleet_schedules(FLEET_REPLICAS, FLEET_SLOW_REPLICA), counters,
            **kw, **wl)
        log(f"    dispatches {counters[0].calls - before} for {rows} rows; "
            f"rebalances per replica "
            f"{[t.num_rebalances for t in trace.replicas]}")
        if trace.num_shed or int(s["num_failed"]):
            raise AssertionError(f"12a {label}: queries shed or failed")
        out[label] = trace
    to_slow = {k: int(t.replica_counts[FLEET_SLOW_REPLICA])
               for k, t in out.items()}
    log(f"  queries routed to the slowed replica {FLEET_SLOW_REPLICA}: "
        f"{to_slow}")
    if not to_slow["odin_aware"] < to_slow["round_robin"]:
        raise AssertionError(f"odin_aware routed no fewer queries to the "
                             f"slowed replica than round_robin: {to_slow}")
    return dict(to_slow=to_slow)


def fleet_capacity(cfg, params, ex, counters, queries) -> float:
    """The fleet's own capacity, measured: FLEET_REPLICAS fresh replicas
    routed as 12b routes them (odin_aware, no admission) drain a burst of
    SHORT_QUERIES queries that all arrive at once (poisson at
    BURST_RATE); the capacity is the burst's completion rate."""
    trace, s, _ = serve_fleet(
        "12b capacity, a drained burst", fleet_engines(
            cfg, params, ex, FLEET_REPLICAS), queries[:SHORT_QUERIES],
        fleet_schedules(FLEET_REPLICAS), counters, router="odin_aware",
        workload="poisson", workload_kwargs=dict(rate=BURST_RATE, seed=4))
    if trace.num_shed or int(s["num_failed"]):
        raise AssertionError("12b capacity: queries shed or failed")
    return float(s["achieved_load_qps"])


def phase_admission(cfg, params, ex, counters, queries, probe) -> dict:
    """12b: the fleet at FLEET_OVERLOAD x the larger of its own capacity C
    (measured here by :func:`fleet_capacity`) and the probe's R, under
    slo_shed (an SLO of FLEET_SLO_SERVICES probe services), then
    queue_cap; then one engine under slo_shed at FLEET_OVERLOAD x one
    replica's rate (R / FLEET_REPLICAS).  R = FLEET_REPLICAS / s from the
    one-replica probe assumes the fleet serves FLEET_REPLICAS queries at a
    time, and the fleet has kept up with 2R on the card, so C is measured
    on the fleet itself; taking the larger of the two means the overload
    never falls below either."""
    slo = FLEET_SLO_SERVICES * probe["service"]
    capacity = fleet_capacity(cfg, params, ex, counters, queries)
    base = max(capacity, probe["rate"])
    wl = dict(workload="poisson", workload_kwargs=dict(
        rate=FLEET_OVERLOAD * base, seed=2))
    log(f"  fleet capacity C = {capacity:.2f} q/s (the probe's R = "
        f"{probe['rate']:.2f} q/s, C / R = {capacity / probe['rate']:.2f}); "
        f"poisson at {FLEET_OVERLOAD} x max(C, R) = "
        f"{FLEET_OVERLOAD * base:.2f} q/s; slo_shed's SLO "
        f"{1e3 * slo:.2f} ms")
    sheds = {}
    for label, kw in (("slo_shed", dict(admission="slo_shed",
                                        admission_kwargs=dict(slo=slo))),
                      ("queue_cap", dict(admission="queue_cap",
                                         admission_kwargs=dict(
                                             cap=FLEET_QUEUE_CAP)))):
        trace, s, _ = serve_fleet(
            f"12b {label}", fleet_engines(cfg, params, ex, FLEET_REPLICAS),
            queries if label == "slo_shed" else queries[:SHORT_QUERIES],
            fleet_schedules(FLEET_REPLICAS), counters,
            router="odin_aware", **kw, **wl)
        log(f"    slo_attainment {s['slo_attainment']:.3f}, goodput "
            f"{s['goodput_qps']:.2f} q/s")
        sheds[label] = trace.num_shed
    if not sheds["slo_shed"] > 0:
        raise AssertionError("slo_shed shed nothing at 2x the fleet rate")
    sheds["capacity_qps"] = capacity

    eng = fleet_engines(cfg, params, ex, 1)[0]
    n = SHORT_QUERIES
    before = counters[0].rows
    t0 = time.perf_counter()
    trace = eng.serve(queries[:n], lambda q: [1.0] * 4, workload="poisson",
                      workload_kwargs=dict(
                          rate=FLEET_OVERLOAD * probe["rate"]
                          / FLEET_REPLICAS, seed=3),
                      admission="slo_shed", admission_kwargs=dict(slo=slo))
    wall = time.perf_counter() - t0
    ran = counters[0].rows - before
    s = trace.summary()
    log(f"  12b one engine under slo_shed: {n} offered in {wall:.2f} s, "
        f"shed {int(s['num_shed'])}, served {len(trace.latencies)}, rows "
        f"run {ran}; p99 {s['p99_latency_s']:.4f} s, slo_attainment "
        f"{s['slo_attainment']:.3f}")
    if not (s["num_shed"] > 0 and len(trace.latencies) + s["num_shed"] == n
            and ran == len(trace.latencies)):
        raise AssertionError(f"12b one engine: shed {s['num_shed']}, served "
                             f"{len(trace.latencies)}, ran {ran} of {n}")
    sheds["engine slo_shed"] = int(s["num_shed"])
    return dict(sheds=sheds)


#: The per-tier keys of a tiered fleet summary, held equal to the JAX
#: package's ClusterTrace.summary() by tests/test_torch_fleet_live.py.
TIER_KEYS = ("num", "shed", "p50_latency_s", "p99_latency_s",
             "deadline_attainment", "downgraded")


def phase_qos(qcfg, qparams, qex, scfg, sparams, sex, counters, queries,
              probe) -> dict:
    """12c: 2 qwen3-4b replicas and 2 qwen2-0.5b replicas (pool "small"),
    tiers interactive and best_effort, poisson at FLEET_OVERLOAD x the
    probe's rate: downgrade with value_shed, then edf with value_shed."""
    wl = dict(workload="poisson", workload_kwargs=dict(
        rate=FLEET_OVERLOAD * probe["rate"], seed=4))
    out = {}
    for router in ("downgrade", "edf"):
        engines = (fleet_engines(qcfg, qparams, qex, 2)
                   + fleet_engines(scfg, sparams, sex, 2))
        small_before = counters[1].rows
        trace, s, _ = serve_fleet(
            f"12c {router}", engines, queries[:SHORT_QUERIES],
            fleet_schedules(4),
            counters, router=router, pools=["default", "default", "small",
                                            "small"],
            tiers="interactive,best_effort", admission="value_shed", **wl)
        small_rows = counters[1].rows - small_before
        keys = ["offered_value", "realized_value"] + [
            f"tier_{t}_{k}" for t in ("interactive", "best_effort")
            for k in TIER_KEYS if k != "downgraded" or router == "downgrade"]
        log("    " + ", ".join(f"{k} {s[k]:.4g}" for k in keys if k in s))
        missing = [k for k in keys if k not in s]
        if missing:
            raise AssertionError(f"12c {router}: summary lacks {missing}")
        if router == "downgrade":
            down = {t: s[f"tier_{t}_downgraded"]
                    for t in ("interactive", "best_effort")}
            if down["interactive"] != 0 or not down["best_effort"] > 0:
                raise AssertionError(f"12c downgrades by tier: {down} (only "
                                     f"best_effort may be downgraded)")
        if not small_rows == int(trace.replica_counts[2:].sum()) > 0:
            raise AssertionError(f"12c {router}: the small pool ran "
                                 f"{small_rows} rows for "
                                 f"{trace.replica_counts[2:].tolist()}")
        out[router] = dict(small=small_rows, shed=trace.num_shed)
    return out


class StandIn:
    """A deterministic executor on the host for the query-indexed fault
    plan: every query takes the same virtual time; it records the queries
    whose execution completed."""

    def __init__(self):
        self.done = []

    def begin_query(self, q):
        return None

    def execute(self, q, step):
        self.done.append(int(q))
        return QueryRecord(service_latency=0.04, throughput=100.0)


class Completed:
    """Wraps an engine's query executor and records the queries whose
    execution completed."""

    def __init__(self, inner):
        self.inner, self.done = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def execute(self, q, step):
        rec = self.inner.execute(q, step)
        self.done.append(int(q))
        return rec


def fault_window(rate: float, service: float, n: int) -> dict:
    """12d's fault plan for ``n`` poisson arrivals at ``rate`` (seed 5): a
    crash of replica 0 for FAULT_CRASH_SERVICES x ``service`` from the
    arrival of query n // 4, on the workload's clock (the fleet loop draws
    the same arrivals), and a flaky window over the whole run; with the
    hedge delay and the serve_cluster options of both runs but retries."""
    arrivals = np.cumsum(make_workload("poisson", rate=rate, seed=5)
                         .inter_arrivals(n))
    start = float(arrivals[n // 4])
    dur = FAULT_CRASH_SERVICES * service
    plan = (f"crash@{start!r}+{dur!r}:r=0,"
            f"flaky@0+{10 * float(arrivals[-1])!r}:p={FAULT_FLAKY_P}")
    hedge = FAULT_HEDGE_SERVICES * service
    return dict(start=start, dur=dur, plan=plan, hedge=hedge,
                span=float(arrivals[-1]),
                kwargs=dict(router=FAULT_ROUTER, workload="poisson",
                            workload_kwargs=dict(rate=rate, seed=5),
                            faults=plan, hedge_after=hedge,
                            health_kwargs=dict(cooldown=FAULT_COOLDOWN)))


def fault_checks(trace, s: dict, tracker, rewarms: int, start: float,
                 dur: float) -> tuple:
    """12d's checks of one fleet run (name -> passed), and replica 0's
    served queries, arrivals and host-ledger starts in its window, and
    its dispatches that failed on the crash (each of a query that arrived
    inside the window)."""
    rep0 = trace.replicas[0]
    crashed = tracker.crash_untils[0]
    in_window = (rep0.arrival_times >= start) & \
        (rep0.arrival_times < start + dur)
    starts = rep0.arrival_times + rep0.queue_delays
    late = int(np.count_nonzero((starts >= start) & (starts < start + dur)))
    admitted = trace.num_queries - trace.num_shed
    completed = int(trace.replica_counts.sum())
    checks = {
        "no dispatch of replica 0 inside its window (the fault "
        "clock is the query's arrival)": not bool(in_window.any()),
        "on_recover once per breaker probe":
            rewarms == sum(tracker.probes),
        "replica 0's breaker opened, and was probed after its "
        "window": tracker.opens[0] >= 1 and tracker.probes[0] >= 1,
        "completed + failed = admitted":
            completed + int(s["num_failed"]) == admitted,
        "replica 0 took a dispatch inside its window, which failed on "
        "the crash":
            len(crashed) >= 1 and all(math.isclose(u, start + dur)
                                      for u in crashed),
    }
    return checks, (len(rep0.arrival_times), int(in_window.sum()), late,
                    len(crashed))


def availability_holds(with_retries: float, without: float) -> bool:
    """12d's availability check: retries keep the fleet available."""
    return with_retries >= FAULT_MIN_AVAILABILITY and with_retries > without


def phase_faults(cfg, params, ex, counters, queries, probe) -> dict:
    """12d: a crash of replica 0 for FAULT_CRASH_SERVICES probe services
    and a flaky window over the whole run (p FAULT_FLAKY_P), poisson at
    FAULT_LOAD x the probe's rate routed by FAULT_ROUTER, retries
    FAULT_RETRIES and hedging after FAULT_HEDGE_SERVICES services; then
    the same with retries 0; then one engine under the query-indexed plan
    ENGINE_FAULTS, held against a deterministic stand-in."""
    rate = FAULT_LOAD * probe["rate"]
    win = fault_window(rate, probe["service"], len(queries))
    start, dur = win["start"], win["dur"]
    log(f"  poisson at {FAULT_LOAD} x R = {rate:.2f} q/s over "
        f"{win['span']:.3f} s of arrivals, {FAULT_ROUTER}; plan "
        f"{win['plan']}; hedge_after {1e3 * win['hedge']:.2f} ms; breaker "
        f"cooldown {FAULT_COOLDOWN} s")
    warms = {"calls": 0}
    orig_warm = ex.warm_buckets

    def warm_buckets(*a, **k):
        warms["calls"] += 1
        return orig_warm(*a, **k)

    runs = {}
    cluster_lib.HealthTracker = ProbeCounter
    ex.warm_buckets = warm_buckets
    try:
        for retries in (FAULT_RETRIES, 0):
            ProbeCounter.made.clear()
            warms["calls"] = 0
            label = f"12d retries {retries}"
            trace, s, _ = serve_fleet(
                label, fleet_engines(cfg, params, ex, FLEET_REPLICAS),
                queries, fleet_schedules(FLEET_REPLICAS), counters,
                retries=retries, **win["kwargs"])
            (tracker,) = ProbeCounter.made
            checks, (served0, arrived, late, crashed) = fault_checks(
                trace, s, tracker, warms["calls"], start, dur)
            log(f"    availability {s['availability']:.4f}, retried "
                f"{int(s['num_retried'])}, hedged {int(s['num_hedged'])}, "
                f"wasted_work_frac {s['wasted_work_frac']:.4f}, downtime "
                f"{s['downtime_s']:.3f} s; breaker opens per replica "
                f"{tracker.opens}, probes {tracker.probes}, on_recover "
                f"re-warms {warms['calls']}; replica 0 served "
                f"{served0}, arrivals in its window "
                f"{arrived}, starts on the host ledger in its "
                f"window {late} (arrived before it), dispatches failed "
                f"on the crash (arrived inside the window) {crashed}")
            bad = [k for k, ok in checks.items() if not ok]
            if bad:
                raise AssertionError(f"{label}: {bad}")
            runs[retries] = s
    finally:
        cluster_lib.HealthTracker = HealthTracker
        del ex.warm_buckets
    a, b = runs[FAULT_RETRIES]["availability"], runs[0]["availability"]
    if not availability_holds(a, b):
        raise AssertionError(f"availability with retries {a}, without {b}")

    # One engine, the query-indexed plan: outcomes depend on (seed, query,
    # attempt) only, so the card run equals a stand-in on the host.
    n = ENGINE_FAULT_QUERIES
    eng = fleet_engines(cfg, params, ex, 1)[0]
    made = []
    orig_qe = eng.query_executor

    def query_executor(*a, **k):
        made.append(Completed(orig_qe(*a, **k)))
        return made[-1]

    eng.query_executor = query_executor
    t0 = time.perf_counter()
    card = eng.serve(queries[:n], lambda q: [1.0] * 4, faults=ENGINE_FAULTS,
                     retries=ENGINE_RETRIES)
    wall = time.perf_counter() - t0
    stand_in = StandIn()
    runtime = RebalanceRuntime(make_scheduler("none"), [9, 9, 9, 9])
    host = run_pipeline(stand_in, runtime, n, faults=ENGINE_FAULTS,
                        retries=ENGINE_RETRIES)

    def outcome(trace, done):
        return (int(trace.num_failed), int(trace.num_retried),
                sorted(set(range(n)) - set(done)))

    got, want = outcome(card, made[0].done), outcome(host, stand_in.done)
    log(f"  12d one engine, plan {ENGINE_FAULTS!r}, retries "
        f"{ENGINE_RETRIES}, {n} closed-loop queries in {wall:.2f} s: "
        f"(num_failed, num_retried, failed queries) on the card {got}, "
        f"the stand-in on the host {want}")
    if got != want or not got[0] >= 3:
        raise AssertionError(f"faulted engine {got} != stand-in {want}")
    return dict(availability=(a, b), engine=got)


def phase_fleet(qcfg, qparams, scfg, sparams) -> dict:
    """Phase 12: qwen3-4b fleets (and a qwen2-0.5b pool) through
    ``serve_cluster`` and the engine's ``serve``; every K1 launch counted,
    each distinct shape held against the plain version."""
    device = qparams["embed"]["table"].device
    qex = ServingEngine(qcfg, qparams, num_eps=4, device=device).executor
    sex = ServingEngine(scfg, sparams, num_eps=4, device=device).executor
    # Every dispatch shape of the phase, warmed before anything is counted
    # (a fleet batch of n rows runs n rows; on_recover re-warms (1, SEQ)).
    for rows in range(1, FLEET_MAX_BATCH + 1):
        qex.ensure_warm(rows, SEQ)
    sex.ensure_warm(1, SEQ)
    rng = np.random.default_rng(12)
    vocab = min(qcfg.vocab_size, scfg.vocab_size)

    def draw(n):
        return [torch.as_tensor(rng.integers(0, vocab, (1, SEQ)),
                                device=device) for _ in range(n)]

    queries = draw(FLEET_QUERIES)
    counters = [RunCounter(qex), RunCounter(sex)]
    reset_counts(flash_attention)
    with counters[0], counters[1], K1Shapes() as shapes:
        probe = probe_fleet_rate(qcfg, qparams, qex, queries)
        routers = phase_routers(qcfg, qparams, qex, counters, queries, probe)
        admission = phase_admission(qcfg, qparams, qex, counters, queries,
                                    probe)
        qos = phase_qos(qcfg, qparams, qex, scfg, sparams, sex, counters,
                        queries, probe)
        faults = phase_faults(qcfg, qparams, qex, counters,
                              queries[:FAULT_QUERIES], probe)
    launches = flash_attention.launches
    want = (qcfg.num_blocks * counters[0].calls
            + scfg.num_blocks * counters[1].calls)
    log(f"  K1 launches in phase 12: {launches} = {qcfg.num_blocks} x "
        f"{counters[0].calls} qwen3-4b forwards ({counters[0].rows} rows) + "
        f"{scfg.num_blocks} x {counters[1].calls} qwen2-0.5b forwards, "
        f"{flash_attention.tensor_core_launches} on the tensor cores; by "
        f"shape {shapes.counts}")
    if not (launches == flash_attention.tensor_core_launches == want
            == sum(shapes.counts.values())):
        raise AssertionError(f"phase 12: K1 launched {launches} times, "
                             f"expected {want}")
    small = (1, scfg.num_heads, scfg.num_kv_heads, SEQ, scfg.head_dim, True,
             None, "bfloat16")
    if not shapes.counts.get(small, 0) == scfg.num_blocks * \
            counters[1].calls > 0:
        raise AssertionError(f"qwen2-0.5b's K1 shape {small} launched "
                             f"{shapes.counts.get(small, 0)} times")
    readings = shapes.check()
    return dict(launches=launches, readings=readings, routers=routers,
                admission=admission, qos=qos, faults=faults)


# -- phase 13: training -------------------------------------------------------


def key_tiles(S, q0, bq, bk, causal, window) -> range:
    """The key tiles of ``bk`` keys that query rows [q0, q0 + bq) see, as
    K1's fp32 kernels cull them."""
    q_last = min(q0 + bq, S) - 1
    end = q_last // bk + 1 if causal else -(-S // bk)
    begin = max(q0 - window + 1, 0) // bk if window else 0
    return range(begin, end)


def query_tiles(S, k0, bk, bq, causal, window) -> range:
    """The query tiles of ``bq`` rows that see keys [k0, k0 + bk)."""
    nq = -(-S // bq)
    begin = k0 // bq if causal else 0
    end = (min(nq, (min(k0 + bk, S) - 1 + window - 1) // bq + 1) if window
           else nq)
    return range(begin, end)


def fp32_width(D: int) -> int:
    """The head-dim width K1's fp32 kernels run their products over (D
    padded with zero columns to their template's 64 or 128)."""
    return 64 if D <= 64 else 128


def fwd_work(B, Hq, Hkv, S, D, causal, window) -> tuple:
    """K1's fp32 forward with its LSE: (operations it needs, fp32
    operations it executes, bytes).  It needs two products over the kept
    (query, key) pairs; it executes them over whole 64 x 64 tiles at the
    padded width, each as three TF32 products on the tensor cores.  Bytes:
    q, k, v read once, o and the lse written once."""
    needed = 2 * 2 * B * Hq * attention_pairs(S, causal, window) * D
    tiles = sum(len(key_tiles(S, q0, 64, 64, causal, window))
                for q0 in range(0, S, 64))
    executed = 2 * 2 * 64 * 64 * fp32_width(D) * B * Hq * tiles
    nbytes = 4 * (2 * Hq + 2 * Hkv) * B * S * D + 4 * B * Hq * S
    return needed, executed, nbytes


def bwd_work(B, Hq, Hkv, S, D, causal, window) -> tuple:
    """K1's backward: (operations it needs, fp32 operations it executes,
    bytes).  It needs five products over the kept (query, key) pairs (S,
    dP, dV, dK, dQ); it executes seven over whole tiles at the padded
    width, each as three TF32 products: four for each (64-key, 32-query)
    tile pair of its dK/dV blocks, three (S and dP again, dQ) for each
    (64-query, 32-key) pair of its dQ blocks.  Bytes: q, k, v, o, dO and
    the fp32 lse read once, dq, dk and dv written once."""
    needed = 5 * 2 * B * Hq * attention_pairs(S, causal, window) * D
    kv_pairs = sum(len(query_tiles(S, k0, 64, 32, causal, window))
                   for k0 in range(0, S, 64))
    q_pairs = sum(len(key_tiles(S, q0, 64, 32, causal, window))
                  for q0 in range(0, S, 64))
    executed = (2 * 64 * 32 * fp32_width(D) * B * Hq
                * (4 * kv_pairs + 3 * q_pairs))
    nbytes = 4 * B * S * D * (4 * Hq + 4 * Hkv) + 4 * B * Hq * S
    return needed, executed, nbytes


def fp32_bounds(needed: float, nbytes: float) -> tuple:
    """K1's fp32 kernels: ((bound_ms, bound_by) the lesser of the two
    bounds, the fp32 CUDA-core bound, the 3xTF32 bound).  Each is the
    larger of the bytes over HBM's rate and the operations over a peak:
    the needed operations at the fp32 CUDA-core peak, or three TF32
    products for each at the TF32 tensor-core peak."""
    cuda = bound(needed, nbytes, PEAK_FP32_FLOPS)
    tf32 = bound(3 * needed, nbytes, PEAK_TF32_FLOPS)
    return min(cuda, tf32), cuda, tf32


def bf16_fwd_work(B, Hq, Hkv, S, D, causal, window) -> tuple:
    """K1's bf16 forward with its LSE: (operations it needs, operations it
    executes, bytes).  It executes S = Q K^T and P V as hi and lo (three
    products) over whole 128 x 128 tiles at the padded width.  Bytes: what
    the function needs, q, k, v read once and o written once in bf16 and
    the fp32 lse written once; the fp32 copy of o this entry also writes
    for the backward is the design's cost, not the function's, and shows
    as kernel time over the bound."""
    needed = 2 * 2 * B * Hq * attention_pairs(S, causal, window) * D
    tiles = sum(len(key_tiles(S, q0, 128, 128, causal, window))
                for q0 in range(0, S, 128))
    executed = 3 * 2 * 128 * 128 * fp32_width(D) * B * Hq * tiles
    nbytes = 2 * (2 * Hq + 2 * Hkv) * B * S * D + 4 * B * Hq * S
    return needed, executed, nbytes


def bf16_bwd_work(B, Hq, Hkv, S, D, causal, window) -> tuple:
    """K1's bf16 backward: (operations it needs, operations it executes,
    bytes).  It needs five products over the kept pairs.  Its blocks fix
    128 rows, 64 a warpgroup, and stream tiles of 64; each warpgroup runs
    the streamed tiles its own rows see, six products for each (64-key,
    64-query) pair of a dK/dV warpgroup (S^T, dP^T, dV and dK as hi and
    lo) and four for each (64-query, 64-key) pair of a dQ warpgroup (S,
    dP, dQ as hi and lo), over the padded width.  Bytes: what the function
    needs, bf16 q, k, v, o and dO and the fp32 lse read once, bf16 dq, dk
    and dv written once (the kernel reads the fp32 o in place of the bf16
    one: its cost shows as kernel time over the bound)."""
    needed = 5 * 2 * B * Hq * attention_pairs(S, causal, window) * D
    kv_pairs = sum(len(query_tiles(S, r0, 64, 64, causal, window))
                   for r0 in range(0, S, 64))
    q_pairs = sum(len(key_tiles(S, r0, 64, 64, causal, window))
                  for r0 in range(0, S, 64))
    executed = (2 * 64 * 64 * fp32_width(D) * B * Hq
                * (6 * kv_pairs + 4 * q_pairs))
    nbytes = 2 * B * S * D * (4 * Hq + 4 * Hkv) + 4 * B * Hq * S
    return needed, executed, nbytes


def bf16_delta_launch(o32, do, Hkv: int):
    """A function that launches the bf16 backward's launch 1 (delta =
    rowsum(dO o O)) alone, through the library's C entry point, for
    timing; it counts no launch of the wrapper's."""
    lib = build.load("flash_attention_bwd_bf16")
    fn = lib.odin_flash_attention_bwd_bf16_delta
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, Hq, S, D = do.shape
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=do.device)
    strides = (ctypes.c_longlong * 3)(*(do.stride(i) for i in (0, 1, 2)))

    def launch():
        err = fn(o32.data_ptr(), do.data_ptr(), delta.data_ptr(), B, Hq,
                 Hkv, S, D, ctypes.addressof(strides),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the bf16 backward's delta launch failed: "
                               f"CUDA error {err}")
    return launch


def masked_lse(q, k, causal: bool, window) -> torch.Tensor:
    """Each row's log-sum-exp of its plain fp32 scaled, masked scores."""
    B, Hq, S, D = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()
                     .repeat_interleave(Hq // k.shape[1], 1)) * D ** -0.5
    i = torch.arange(S, device=q.device)
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        keep &= i[:, None] >= i[None]
    if window is not None:
        keep &= i[:, None] - i[None] < window
    return torch.logsumexp(s.masked_fill(~keep, float("-inf")), dim=-1)


def backward_bf16_check(gen) -> dict:
    """13a in bf16: K1's bf16 backward (csrc/flash_attention_bwd_bf16.cu)
    against the plain backward on BACKWARD_BF16_CASES at
    BACKWARD_BF16_LIMIT and BACKWARD_BF16_RMS_LIMIT, two calls bit-equal;
    the bf16 LSE entry's o bit-equal to the plain entry point's and its
    LSE the rows' log-sum-exp to 1e-4; both timed at three shapes, with
    the delta launch alone."""
    worst = dict(bwd=0.0, fwd=0.0, rms=0.0, lse=0.0)
    for case in BACKWARD_BF16_CASES:
        B, Hq, Hkv, S, D, causal, window, dtype = case
        q, k, v, do = (randn(gen, s, dtype) for s in (
            (B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, Hq, S, D)))
        o, lse, o32 = k1_lib.forward_for_backward(
            q, k, v, causal=causal, window=window)
        o_plain = flash_attention(q, k, v, causal=causal, window=window)
        got = k1_lib.backward(q, k, v, o32, lse, do, causal=causal,
                              window=window)
        want = flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                       window=window)
        lse_err = float((lse - masked_lse(q, k, causal, window)).abs().max())
        torch.cuda.synchronize()
        if not torch.equal(o, o_plain) or not lse_err <= 1e-4:
            raise AssertionError(f"K1 bf16 {case}: the LSE entry point's "
                                 f"output differs from the plain entry "
                                 f"point's, or its LSE is {lse_err:.2e} off")
        fwd = compare(o, flash_attention_ref(q, k, v, causal=causal,
                                             window=window),
                      tolerance(dtype), f"K1 bf16 forward {case}")
        checks = [bf16_backward_check(g, w) for g, w in zip(got, want)]
        again = k1_lib.backward(q, k, v, o32, lse, do, causal=causal,
                                window=window)
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"K1 bf16 backward {case}: two calls gave "
                                 f"different bits")
        log(f"  K1 bf16 backward {case}: max|err|/max|ref|, rms err / rms "
            f"ref: " + ", ".join(
                f"{n} {r:.3e}, {rr:.3e}" if float(w.abs().max()) else
                f"{n} exactly 0 in the plain version: max |got| {r:.3e} "
                f"(limit {BACKWARD_BF16_ZERO_ATOL})"
                for n, (r, rr, _), w in zip(("dq", "dk", "dv"), checks, want))
            + f" (limits {BACKWARD_BF16_LIMIT}, {BACKWARD_BF16_RMS_LIMIT}); "
            f"LSE forward bit-equal to the plain entry point, LSE max |err| "
            f"{lse_err:.2e}")
        if not (all(ok for _, _, ok in checks)
                and all(bool(torch.isfinite(g.float()).all()) for g in got)):
            raise AssertionError(f"K1 bf16 backward {case}: {checks}")
        worst["bwd"] = max([worst["bwd"]] + [
            float((g.float() - w.float()).abs().max())
            for g, w in zip(got, want)])
        worst["rms"] = max([worst["rms"]] + [
            rr for (_, rr, _), w in zip(checks, want)
            if float(w.abs().max())])
        worst["fwd"] = max(worst["fwd"], fwd["max_abs_err"])
        worst["lse"] = max(worst["lse"], lse_err)

    timed = {}
    for case in (BACKWARD_BF16_TRAIN_CASE, BACKWARD_BF16_LONG_CASE,
                 BACKWARD_BF16_WIDE_CASE):
        B, Hq, Hkv, S, D, causal, window, dtype = case
        q, k, v, do = (randn(gen, s, dtype) for s in (
            (B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, Hq, S, D)))
        o, lse, o32 = k1_lib.forward_for_backward(
            q, k, v, causal=causal, window=window)
        bwd_ms = time_ms(lambda: k1_lib.backward(q, k, v, o32, lse, do,
                                                 causal=causal,
                                                 window=window))
        # Launch 1 (delta) alone.
        delta_ms = time_ms(bf16_delta_launch(o32, do, Hkv))
        plain_bwd_ms = time_ms(lambda: flash_attention_bwd_ref(
            q, k, v, do, causal=causal, window=window), reps=10)
        # The yardstick: autograd's backward through sdpa's bf16 forward.
        lq, lk, lv = (t.clone().requires_grad_(True) for t in (q, k, v))
        lo = torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, is_causal=causal, enable_gqa=True)
        library_bwd_ms = time_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True))
        fwd_ms = time_ms(lambda: k1_lib.forward_for_backward(
            q, k, v, causal=causal, window=window))
        plain_fwd_ms = time_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window), reps=10)
        library_fwd_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True))
        plain_entry_ms = time_ms(lambda: flash_attention(
            q, k, v, causal=causal, window=window))
        timed[case] = {}
        lines = {}
        for kind, work, ms, plain_ms, library_ms in (
                ("bwd", bf16_bwd_work, bwd_ms, plain_bwd_ms, library_bwd_ms),
                ("fwd", bf16_fwd_work, fwd_ms, plain_fwd_ms,
                 library_fwd_ms)):
            needed, executed, nbytes = work(*case[:7])
            bound_ms, bound_by = bound(needed, nbytes, PEAK_BF16_FLOPS)
            timed[case][kind] = dict(ms=ms, plain_ms=plain_ms,
                                     library_ms=library_ms,
                                     bound_ms=bound_ms, bound_by=bound_by)
            lines[kind] = (
                f"bound_ms {bound_ms:.4f} ({bound_by}; {needed / 1e9:.3f} "
                f"GFLOP needed at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, "
                f"{nbytes / 1e6:.1f} MB at 3.35 TB/s); it executes "
                f"{executed / 1e9:.3f} GFLOP of bf16 products over whole "
                f"tiles, {executed / ms / 1e9:.1f} TFLOP/s "
                f"({needed / ms / 1e9:.1f} of the needed)")
        log(f"  K1 bf16 backward {case}: kernel_ms {bwd_ms:.4f} (delta, "
            f"the dK/dV and dQ tiles" + (", the GQA shares' sum"
                                         if Hq > Hkv else "")
            + f"; the delta launch alone {delta_ms:.4f})  plain_ms {plain_bwd_ms:.4f} (autograd "
            f"through the plain attention)  library_ms {library_bwd_ms:.4f} (autograd's "
            f"backward of bf16 scaled_dot_product_attention; kernel / "
            f"library {bwd_ms / library_bwd_ms:.2f})  {lines['bwd']}")
        log(f"  K1 bf16 forward with LSE {case}: kernel_ms {fwd_ms:.4f} (the "
            f"plain entry point {plain_entry_ms:.4f})  plain_ms "
            f"{plain_fwd_ms:.4f}  library_ms {library_fwd_ms:.4f} (bf16 "
            f"scaled_dot_product_attention; kernel / library "
            f"{fwd_ms / library_fwd_ms:.2f})  {lines['fwd']}")
    return dict(worst=worst, timed=timed)


def ssd_bwd_work(b, S, H, P, N, chunk, elem_bytes, dstate: bool) -> tuple:
    """K3's backward: (operations it needs, bytes).  Bytes: x, dt, A, B, C
    and dy read once, dx, ddt, dA, dB and dC written once, in the inputs'
    dtype (the forward's scratch that the backward reads, cs and the chunk
    states, is this design's choice and is not counted).  Operations: the
    five products over each chunk's (i, j <= i) pairs, C.B^T once per batch
    row (the heads share it) and dy.u, du, dB and dC per head; and the
    state's products where this run's data needs them, per position and
    head: G B_j and G^T u_j where a gradient leaves the chunk (every chunk
    but the last, and the last with a ``dstate``), h-^T dy_i where a state
    enters it and the chunk's own term of the gradient entering it (every
    chunk but the first)."""
    nc = -(-S // chunk)
    flops = 0
    for c in range(nc):
        cl = min(chunk, S - c * chunk)
        pairs = cl * (cl + 1) // 2
        flops += b * 2 * pairs * N + b * H * 2 * pairs * (2 * P + 2 * N)
        terms = 2 * (c < nc - 1 or dstate) + 2 * (c > 0)
        flops += b * H * cl * 2 * P * N * terms
    nbytes = (3 * b * S * H * P + 2 * b * S * H + 4 * b * S * N + 2 * H) \
        * elem_bytes
    return flops, nbytes


def kernel_times(prof) -> dict:
    """Each kernel of a ``torch.profiler`` run (CPU and CUDA activities):
    name -> (device ms, launches recorded).  Only the device's own events:
    a CPU op's device time repeats its kernels'."""
    from torch.autograd import DeviceType
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        t = (getattr(ev, "device_time_total", None)
             or getattr(ev, "cuda_time_total", 0)) / 1e3
        out[ev.key] = (t, ev.count)
    return out


def by_name(times: dict, names) -> dict:
    """``kernel_times``' entries summed by which of ``names`` each kernel's
    name holds: name -> (device ms, launches)."""
    out = dict.fromkeys(names, (0.0, 0))
    for key, (t, n) in times.items():
        for name in names:
            if name in key:
                out[name] = (out[name][0] + t, out[name][1] + n)
    return out


def ssd_backward_phase(gen) -> dict:
    """13a, K3: the backward kernel (csrc/ssd_scan_bwd.cu) against the
    plain backward (autograd through the token recurrence) on
    SSD_BACKWARD_CASES with the JAX test's dt and a slowly decaying one,
    random dy and dstate: each gradient within cases.py's limits, two calls
    with the same bits; timed at SSD_BACKWARD_TIMED in both dtypes beside
    the plain backward and the bound, with each launch's device time."""
    worst = {"float32": [0.0, 0.0, 0.0], "bfloat16": [0.0, 0.0, 0.0]}
    for case in SSD_BACKWARD_CASES:
        b, S, H, P, N, chunk, dtype = case
        for slow in (False, True):
            ins = ssd_inputs(gen, b, S, H, P, N, dtype, slow)
            dy = randn(gen, (b, S, H, P), dtype)
            dstate = randn(gen, (b, H, P, N), "float32")
            _, _, cs, states = k3_lib.forward_for_backward(*ins, chunk=chunk)
            got = k3_lib.backward(*ins, cs, states, dy, dstate, chunk=chunk)
            again = k3_lib.backward(*ins, cs, states, dy, dstate,
                                    chunk=chunk)
            want = ssd_scan_bwd_ref(*ins, dy, dstate)
            torch.cuda.synchronize()
            readings = [ssd_backward_check(g, w, dtype)
                        for g, w in zip(got, want)]
            same = all(torch.equal(g, g2) for g, g2 in zip(got, again))
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
            log(f"  K3 backward {case} {'slow' if slow else 'JAX'} dt: "
                f"max|err|/max|ref| "
                + " ".join(f"{n} {r[0]:.2e}" for n, r in
                           zip(("dx", "ddt", "dA", "dB", "dC"), readings))
                + "; rms err/rms "
                + " ".join(f"{r[1]:.2e}" for r in readings)
                + f"; two calls bit-equal: {same}")
            if not (all(r[2] for r in readings) and same and finite):
                raise AssertionError(f"K3 backward {case}: {readings}, "
                                     f"bit-equal {same}, finite {finite}")
            w = worst[dtype]
            w[0] = max([w[0]] + [r[0] for r in readings])
            w[1] = max([w[1]] + [r[1] for r in readings])
            w[2] = max([w[2]] + [float((g.float() - r.float()).abs().max())
                                 for g, r in zip(got, want)])
    log(f"  K3 backward, worst over the cases: fp32 max_ratio "
        f"{worst['float32'][0]:.2e} (limit 1e-4), bf16 max_ratio "
        f"{worst['bfloat16'][0]:.2e} and rms {worst['bfloat16'][1]:.2e}")

    from torch.profiler import ProfilerActivity, profile
    timed = {}
    for shape in SSD_BACKWARD_TIMED:
        b, S, H, P, N, chunk = shape
        for dtype in ("float32", "bfloat16"):
            ins = ssd_inputs(gen, b, S, H, P, N, dtype)
            dy = randn(gen, (b, S, H, P), dtype)
            _, _, cs, states = k3_lib.forward_for_backward(*ins, chunk=chunk)

            def run():
                return k3_lib.backward(*ins, cs, states, dy, None,
                                       chunk=chunk)

            ms = time_ms(run)
            plain_ms = time_ms(lambda: ssd_scan_bwd_ref(*ins, dy), reps=3,
                               warmup=1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    run()
                torch.cuda.synchronize()
            # The mean over the launches the profiler recorded.
            launch_ms = {k: t / n for k, (t, n) in
                         by_name(kernel_times(prof), K3_BWD_KERNELS).items()
                         if n}
            elem = 4 if dtype == "float32" else 2
            flops, nbytes = ssd_bwd_work(b, S, H, P, N, chunk, elem, False)
            if dtype == "float32":
                (bound_ms, bound_by), cuda, tf32 = fp32_bounds(flops, nbytes)
                peak = (f"the lesser of the fp32 CUDA-core bound "
                        f"{cuda[0]:.4f} ms and the 3xTF32 bound "
                        f"{tf32[0]:.4f} ms")
            else:
                bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
                peak = f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s of bf16"
            timed[(shape, dtype)] = dict(ms=ms, plain_ms=plain_ms,
                                         bound_ms=bound_ms, bound_by=bound_by,
                                         library_ms=None, launch_ms=launch_ms)
            log(f"  K3 backward {shape} {dtype}: kernel_ms {ms:.4f}  "
                f"plain_ms {plain_ms:.4f} (autograd through the token "
                f"recurrence)  library_ms none (no PyTorch call computes it)"
                f"  bound_ms {bound_ms:.5f} ({bound_by}; {peak}; "
                f"{flops / 1e9:.3f} GFLOP of products, {nbytes / 1e6:.2f} MB;"
                f" {flops / ms / 1e9:.2f} TFLOP/s achieved); device ms per "
                f"launch: " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in launch_ms.items()))
    return dict(worst=worst, timed=timed)


def phase_backward_check() -> dict:
    """13a: K1's backward kernel against the plain backward on
    BACKWARD_CASES, the LSE entry point against the plain entry point; both
    timed at the training shape and at S 1024; then the same in bf16
    (:func:`backward_bf16_check`); then K3's backward
    (:func:`ssd_backward_phase`)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = dict(bwd=0.0, fwd=0.0)
    for case in BACKWARD_CASES:
        B, Hq, Hkv, S, D, causal, window, dtype = case
        q, k, v, do = (randn(gen, s, dtype) for s in (
            (B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, Hq, S, D)))
        o, lse = k1_lib.forward_with_lse(q, k, v, causal=causal,
                                         window=window)
        o_plain = flash_attention(q, k, v, causal=causal, window=window)
        got = k1_lib.backward(q, k, v, o, lse, do, causal=causal,
                              window=window)
        want = flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                       window=window)
        torch.cuda.synchronize()
        if not torch.equal(o, o_plain):
            raise AssertionError(f"K1 {case}: the LSE entry point's output "
                                 f"differs from the plain entry point's")
        fwd = compare(o, flash_attention_ref(q, k, v, causal=causal,
                                             window=window),
                      tolerance(dtype), f"K1 fp32 forward {case}")
        ratios = [max_ratio(g, w) for g, w in zip(got, want)]
        log(f"  K1 backward {case}: max|err|/max|ref| dq {ratios[0]:.3e} dk "
            f"{ratios[1]:.3e} dv {ratios[2]:.3e} (limit {BACKWARD_LIMIT}); "
            f"LSE forward bit-equal to the plain entry point")
        if not (max(ratios) <= BACKWARD_LIMIT
                and all(bool(torch.isfinite(g).all()) for g in got)):
            raise AssertionError(f"K1 backward {case}: {ratios} (limit "
                                 f"{BACKWARD_LIMIT})")
        worst["bwd"] = max([worst["bwd"]] + [float((g - w).abs().max())
                                             for g, w in zip(got, want)])
        worst["fwd"] = max(worst["fwd"], fwd["max_abs_err"])

    timed = {}
    for case in (BACKWARD_TRAIN_CASE, BACKWARD_LONG_CASE):
        B, Hq, Hkv, S, D, causal, window, dtype = case
        q, k, v, do = (randn(gen, s, dtype) for s in (
            (B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, Hq, S, D)))
        o, lse = k1_lib.forward_with_lse(q, k, v, causal=causal,
                                         window=window)
        bwd_ms = time_ms(lambda: k1_lib.backward(q, k, v, o, lse, do,
                                                 causal=causal,
                                                 window=window))
        plain_bwd_ms = time_ms(lambda: flash_attention_bwd_ref(
            q, k, v, do, causal=causal, window=window), reps=10)
        # The yardstick: autograd's backward through sdpa's fp32 forward.
        lq, lk, lv = (t.clone().requires_grad_(True) for t in (q, k, v))
        lo = torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, is_causal=causal, enable_gqa=True)
        library_bwd_ms = time_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True))
        fwd_ms = time_ms(lambda: k1_lib.forward_with_lse(
            q, k, v, causal=causal, window=window))
        plain_fwd_ms = time_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window), reps=10)
        library_fwd_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True))
        lines, timed[case] = {}, {}
        for kind, work, ms, plain_ms, library_ms in (
                ("bwd", bwd_work, bwd_ms, plain_bwd_ms, library_bwd_ms),
                ("fwd", fwd_work, fwd_ms, plain_fwd_ms, library_fwd_ms)):
            needed, executed, nbytes = work(*case[:7])
            (bound_ms, bound_by), cuda, tf32 = fp32_bounds(needed, nbytes)
            timed[case][kind] = dict(ms=ms, plain_ms=plain_ms,
                                     library_ms=library_ms,
                                     bound_ms=bound_ms, bound_by=bound_by)
            lines[kind] = (
                f"bound_ms {bound_ms:.4f} ({bound_by}; the lesser of the "
                f"3xTF32 bound {tf32[0]:.4f} ms, {3 * needed / 1e9:.3f} "
                f"GFLOP of TF32 products at {PEAK_TF32_FLOPS / 1e12:.0f} "
                f"TFLOP/s, and the fp32 CUDA-core bound {cuda[0]:.4f} ms at "
                f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s; {nbytes / 1e6:.1f} "
                f"MB); it executes {executed / 1e9:.3f} GFLOP of fp32 "
                f"products over whole tiles ({needed / 1e9:.3f} needed), "
                f"{executed / ms / 1e9:.1f} TFLOP/s, as "
                f"{3 * executed / ms / 1e9:.1f} TFLOP/s of TF32 products")
        log(f"  K1 backward {case}: kernel_ms {bwd_ms:.4f} (3 launches: "
            f"delta, the dK/dV and dQ tiles, the sum of the GQA shares)  "
            f"plain_ms {plain_bwd_ms:.4f} (autograd through the plain "
            f"attention)  library_ms {library_bwd_ms:.4f} (autograd's "
            f"backward of fp32 scaled_dot_product_attention; kernel / "
            f"library {bwd_ms / library_bwd_ms:.2f})  {lines['bwd']}")
        log(f"  K1 fp32 forward with LSE {case}: kernel_ms {fwd_ms:.4f}  "
            f"plain_ms {plain_fwd_ms:.4f}  library_ms {library_fwd_ms:.4f} "
            f"(fp32 scaled_dot_product_attention; kernel / library "
            f"{fwd_ms / library_fwd_ms:.2f})  {lines['fwd']}")
    return dict(worst=worst, timed=timed, bf16=backward_bf16_check(gen),
                k3=ssd_backward_phase(gen))


def grads_against_ref(model, params, batch, what: str,
                      loss_rtol: float = TRAIN_LOSS_RTOL,
                      grad_limit: float = TRAIN_GRAD_RMS_LIMIT,
                      fp32_params=None) -> tuple:
    """Step 0's loss and every gradient leaf with the kernels against the
    same with ``impl="ref"`` on the card: the loss to ``loss_rtol``, each
    leaf's rms error to ``grad_limit`` of its rms.  With ``fp32_params``
    (bf16 ``params`` widened) a leaf may also differ by as much as the
    plain version's own bf16 gradient differs from its fp32 one there:
    two bf16 gradients are not asked to agree more closely than either
    can agree with the fp32 gradient.  Returns (loss, the worst leaf's
    ratio over its limit)."""
    (loss, _), grads = loss_and_grads(model, params, batch)
    (loss_ref, _), grads_ref = loss_and_grads(model, params, batch,
                                              impl="ref")
    floor = {}
    if fp32_params is not None:
        _, grads_32 = loss_and_grads(model, fp32_params, batch, impl="ref")
        floor = {key: rel_rms(w, w32) for (key, w), w32 in zip(
            flatten(grads_ref).items(), flatten(grads_32).values())}
    torch.cuda.synchronize()
    rel = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
    worst, worst_key, worst_limit = 0.0, None, grad_limit
    for (key, g), w in zip(flatten(grads).items(),
                           flatten(grads_ref).values()):
        err, ref = rms(g.float() - w.float()), rms(w)
        ratio = err / ref if ref > 0 else (0.0 if err == 0 else float("inf"))
        limit = max(grad_limit, floor.get(key, 0.0))
        if ratio / limit > worst / worst_limit:
            worst, worst_key, worst_limit = ratio, key, limit
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: non-finite gradient at {key}")
    if floor:
        above = sorted(((v, k) for k, v in floor.items() if v > grad_limit),
                       reverse=True)
        log(f"  {what}: the plain version's own bf16-vs-fp32 rms gap per "
            f"leaf reads {min(floor.values()):.2e} to "
            f"{max(floor.values()):.2e}, above {grad_limit} at {len(above)} "
            f"of {len(floor)} leaves (largest: "
            + ", ".join(f"{k} {v:.3f}" for v, k in above[:3]) + ")")
    log(f"  {what}: loss {float(loss):.6f} with the kernels, "
        f"{float(loss_ref):.6f} with their plain versions (rel {rel:.2e}, "
        f"limit {loss_rtol}); worst gradient leaf rms err / rms {worst:.2e} "
        f"at {worst_key} (limit {worst_limit:.3g})")
    if not (rel <= loss_rtol and worst <= worst_limit):
        raise AssertionError(f"{what}: the kernels' gradients disagree with "
                             f"the plain versions'")
    return float(loss), worst / worst_limit


def k1_kernel_ms(prof) -> dict:
    """Device ms of K1's forward and backward kernels, of the matrix
    products (cuBLAS kernels: "gemm", or "nvjet" for Hopper's cuBLASLt
    kernels, in their names) and of all kernels in a ``torch.profiler``
    run; ``top``: the five kernels with the most device time."""
    out = dict(fwd=0.0, bwd=0.0, gemm=0.0, total=0.0)
    by_name = []
    for ev in prof.key_averages():
        t = (getattr(ev, "device_time_total", None)
             or getattr(ev, "cuda_time_total", 0)) / 1e3
        out["total"] += t
        by_name.append((t, ev.key))
        if "flash_fwd" in ev.key:
            out["fwd"] += t
        elif any(k in ev.key for k in ("bwd_delta", "bwd_tiles",
                                       "bwd_dkv_sum")):
            out["bwd"] += t
        elif any(k in ev.key.lower() for k in ("gemm", "nvjet")):
            out["gemm"] += t
    out["top"] = sorted(by_name, reverse=True)[:5]
    return out


def phase_train() -> dict:
    """13b: full-width qwen2-0.5b in fp32 with remat: step 0's gradients
    with K1 against the plain attention, TRAIN_STEPS steps of ``train``,
    the checkpoint round trip, the step's time and where it goes."""
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, remat=True)
    params = model.init_params(seed=0, dtype=torch.float32, device="cuda")
    log(f"  {cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters, "
        f"{cfg.num_blocks} blocks, d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, D {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}, fp32, remat per block; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens (SyntheticLM, seed 0)")
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    dev = torch.device("cuda")
    grads_against_ref(model, params, to_batch(data.batch_at(0), dev),
                      "step 0, full width")

    opt = AdamWConfig(**TRAIN_OPT)
    reset_counts(flash_attention)
    out = train(cfg, opt, iter(data), TRAIN_STEPS, device="cuda",
                params=params, log_every=1, log_fn=lambda *_: None)
    counts = {name: n for name, n in vars(flash_attention).items()
              if name.endswith("launches")}
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    steps_s = np.diff([0.0] + [h["wall_s"] for h in hist])
    log(f"  {TRAIN_STEPS} steps: losses {[round(x, 4) for x in losses]}")
    log(f"  K1 launches over the {TRAIN_STEPS} steps: {counts}")
    n = cfg.num_blocks * TRAIN_STEPS
    want = dict(launches=2 * n, fp32_launches=2 * n, lse_launches=n,
                backward_launches=n, tensor_core_launches=0,
                bf16_lse_launches=0, bf16_backward_launches=0)
    if counts != want:
        raise AssertionError(f"K1 launches in training: {counts}, expected "
                             f"{want}")
    if not (all(np.isfinite(losses))
            and np.mean(losses[-5:]) < losses[0]):
        raise AssertionError(f"training did not lower the loss: {losses}")

    # The checkpoint after TRAIN_STEPS updates loads back bit-equal, and one
    # more step from it equals the step taken without the reload.
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    state = {"params": out["params"], "opt": out["opt_state"]}
    t0 = time.perf_counter()
    save_checkpoint(str(ckpt_dir), state, TRAIN_STEPS)
    t1 = time.perf_counter()
    loaded = load_checkpoint(str(ckpt_dir), state)
    torch.cuda.synchronize()
    t_save, t_load = t1 - t0, time.perf_counter() - t1
    ckpt_bytes = sum(p.stat().st_size for p in ckpt_dir.glob("*.npz"))
    if not all(torch.equal(a, b) for a, b in zip(flatten(state).values(),
                                                 flatten(loaded).values())):
        raise AssertionError("the checkpoint did not load back bit-equal")
    step_fn = make_train_step(cfg, opt)
    batch = to_batch(data.batch_at(TRAIN_STEPS), dev)
    p_a, _, m_a = step_fn(state["params"], state["opt"], batch)
    p_a = list(flatten(p_a).values())
    p_b, _, m_b = step_fn(loaded["params"], loaded["opt"], batch)
    same = all(torch.equal(a, b) for a, b in zip(p_a,
                                                 flatten(p_b).values()))
    log(f"  checkpoint at step {TRAIN_STEPS}: {ckpt_bytes / 2**30:.2f} GiB, "
        f"saved in {t_save:.1f} s and loaded in {t_load:.1f} s, bit-equal;"
        f" one more step "
        f"from it: loss {float(m_b['loss']):.6f}, params equal to the step "
        f"without the reload: {same}")
    if not same or float(m_a["loss"]) != float(m_b["loss"]):
        raise AssertionError("a step from the reloaded checkpoint differs")
    shutil.rmtree(ckpt_dir)
    del p_a, p_b, loaded

    # Where a step's time goes: the card's busy share and K1's shares.
    from torch.profiler import ProfilerActivity, profile
    p, s = state["params"], state["opt"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p, s, _ = step_fn(p, s, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms = k1_kernel_ms(prof)
    step_s = float(np.median(steps_s[1:]))
    shape = InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    flops = analytic_cost(cfg, shape).totals("train", remat=True)["flops"]
    tokens = TRAIN_SEQ * TRAIN_BATCH
    log(f"  step time (host clock, synchronised, median of steps 1-"
        f"{TRAIN_STEPS - 1}): {1e3 * step_s:.2f} ms (step 0 "
        f"{1e3 * steps_s[0]:.2f} ms); {tokens / step_s:.0f} tokens/s; "
        f"{flops / 1e12:.3f} TFLOP a step (launch/analytic.py, train, "
        f"remat) = {flops / step_s / 1e12:.2f} TFLOP/s achieved")
    log(f"  one profiled step: {1e3 * wall:.2f} ms on the host clock, the "
        f"card busy {dev_ms['total']:.2f} ms ({100 * dev_ms['total'] / (1e3 * wall):.1f}"
        f"%); K1 forward {dev_ms['fwd']:.2f} ms ({100 * dev_ms['fwd'] / dev_ms['total']:.1f}"
        f"% of busy), K1 backward {dev_ms['bwd']:.2f} ms "
        f"({100 * dev_ms['bwd'] / dev_ms['total']:.1f}%), matrix products "
        f"{dev_ms['gemm']:.2f} ms ({100 * dev_ms['gemm'] / dev_ms['total']:.1f}"
        f"%)")
    log_memory(f"{cfg.name} training")
    return dict(counts=counts, step_s=step_s, losses=losses,
                busy=dev_ms["total"] / (1e3 * wall),
                peak=torch.cuda.max_memory_allocated())


def phase_train_families() -> dict:
    """13c: one train step of each family at its smoke width: K1 against
    the plain attention at 13b's limits, then a step of ``make_train_step``;
    the MoE families again in bf16 at 13e's limits; the Mamba2 families
    (K3's forward and backward) in fp32 and bf16 at 13b's and 13e's
    limits."""
    dev = torch.device("cuda")
    for arch in FAMILY_TRAIN_ARCHS:
        cfg = get_smoke_config(arch)
        torch.cuda.reset_peak_memory_stats()
        params = Model(cfg).init_params(seed=0, device="cuda")
        data = (SyntheticEmbeds(cfg.d_model, cfg.vocab_size, FAMILY_TRAIN_SEQ,
                                2) if cfg.embedding_inputs
                else SyntheticLM(cfg.vocab_size, FAMILY_TRAIN_SEQ, 2))
        batch = to_batch(data.batch_at(0), dev)
        reset_counts(flash_attention)
        grads_against_ref(Model(cfg, remat=True), params, batch,
                          f"{arch} (smoke width, S {FAMILY_TRAIN_SEQ}, "
                          f"causal {cfg.causal}, window {cfg.sliding_window})")
        step = make_train_step(cfg, AdamWConfig(warmup_steps=1))
        _, state, m = step(params, init_adamw(params), batch)
        if not (np.isfinite(float(m["loss"])) and flash_attention.
                backward_launches == 2 * cfg.num_blocks):
            raise AssertionError(f"{arch}: train step loss {float(m['loss'])},"
                                 f" K1 backward launches "
                                 f"{flash_attention.backward_launches}")
        log(f"  {arch}: one train step, loss {float(m['loss']):.4f}, aux_loss"
            f" {float(m['aux_loss']):.4f}, router_z {float(m['router_z']):.4f}"
            f"; device memory peak "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    # bf16: K1's bf16 forward and backward in the MoE families' blocks.
    for arch in FAMILY_BF16_TRAIN_ARCHS:
        cfg = get_smoke_config(arch)
        params = Model(cfg).init_params(seed=0, dtype=torch.bfloat16,
                                        device="cuda")
        batch = to_batch(SyntheticLM(cfg.vocab_size, FAMILY_TRAIN_SEQ, 2)
                         .batch_at(0), dev)
        reset_counts(flash_attention)
        grads_against_ref(Model(cfg, remat=True), params, batch,
                          f"{arch} in bf16 (smoke width, S "
                          f"{FAMILY_TRAIN_SEQ}, window {cfg.sliding_window})",
                          TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_GRAD_RMS_LIMIT)
        step = make_train_step(cfg, AdamWConfig(warmup_steps=1))
        _, state, m = step(params, init_adamw(params), batch)
        n = 2 * cfg.num_blocks
        if not (np.isfinite(float(m["loss"]))
                and flash_attention.bf16_backward_launches == n
                and flash_attention.bf16_lse_launches == n
                and flash_attention.fp32_launches == 0):
            raise AssertionError(f"{arch} bf16: train step loss "
                                 f"{float(m['loss'])}, K1 launches "
                                 f"{vars(flash_attention)}")
        log(f"  {arch} in bf16: one train step, loss {float(m['loss']):.4f},"
            f" K1 bf16 backward launches {n}")
    # The Mamba2 families: K3's forward and backward kernels (and K1 in
    # jamba's attention sublayer), one step in fp32 and one in bf16.
    for arch in MAMBA_TRAIN_ARCHS:
        cfg = get_smoke_config(arch)
        subs = cfg.layer_pattern.count("mamba") * cfg.num_blocks
        for dtype, limits in (
                ("float32", (TRAIN_LOSS_RTOL, TRAIN_GRAD_RMS_LIMIT)),
                ("bfloat16", (TRAIN_BF16_LOSS_RTOL,
                              TRAIN_BF16_GRAD_RMS_LIMIT))):
            params = Model(cfg).init_params(seed=0,
                                            dtype=getattr(torch, dtype),
                                            device="cuda")
            batch = to_batch(SyntheticLM(cfg.vocab_size, FAMILY_TRAIN_SEQ, 2)
                             .batch_at(0), dev)
            reset_counts(ssd_scan)
            # In bf16 each leaf is also allowed the plain version's own
            # bf16-vs-fp32 gap: jamba's leaves read up to 0.26 there (123
            # of 135 above 13e's limit, on an NVIDIA H100 80GB HBM3 at
            # 700 W; this phase prints it).
            grads_against_ref(Model(cfg, remat=True), params, batch,
                              f"{arch} in {dtype} (smoke width, S "
                              f"{FAMILY_TRAIN_SEQ}, {subs} Mamba2 "
                              f"sublayers)", *limits,
                              fp32_params=None if dtype == "float32"
                              else widened(params))
            step = make_train_step(cfg, AdamWConfig(warmup_steps=1))
            _, _, m = step(params, init_adamw(params), batch)
            counts = {name: n for name, n in vars(ssd_scan).items()
                      if name.endswith("launches")}
            # Two steps with the kernels (the check's and this one), each
            # running every Mamba2 sublayer's forward twice (remat) and its
            # backward once.
            want = dict(launches=4 * subs, backward_launches=2 * subs)
            if not (np.isfinite(float(m["loss"])) and counts == want):
                raise AssertionError(f"{arch} {dtype}: train step loss "
                                     f"{float(m['loss'])}, K3 launches "
                                     f"{counts}, expected {want}")
            log(f"  {arch} in {dtype}: one train step, loss "
                f"{float(m['loss']):.4f}, K3 launches {counts}")
    return {}


def phase_train_mamba() -> dict:
    """13f: full-width mamba2-370m in fp32 with remat: step 0's loss and
    every gradient leaf with K3 against ``impl="ref"``, TRAIN_STEPS steps
    of ``train`` with exact K3 launch counts, the step's time and where it
    goes."""
    cfg = get_config(MAMBA_TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, remat=True)
    params = model.init_params(seed=0, dtype=torch.float32, device="cuda")
    s = cfg.ssm
    log(f"  {cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters, "
        f"{cfg.num_blocks} blocks, d_model {cfg.d_model}, heads "
        f"{s.num_heads(cfg.d_model)}, P {s.head_dim}, N {s.d_state}, chunk "
        f"{s.chunk_size}, vocab {cfg.vocab_size}, fp32, remat per block; "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens (SyntheticLM, seed 0)")
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    dev = torch.device("cuda")
    grads_against_ref(model, params, to_batch(data.batch_at(0), dev),
                      "step 0, full width")
    check_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    opt = AdamWConfig(**TRAIN_OPT)
    reset_counts(ssd_scan)
    out = train(cfg, opt, iter(data), TRAIN_STEPS, device="cuda",
                params=params, log_every=1, log_fn=lambda *_: None)
    counts = {name: n for name, n in vars(ssd_scan).items()
              if name.endswith("launches")}
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    steps_s = np.diff([0.0] + [h["wall_s"] for h in hist])
    log(f"  {TRAIN_STEPS} steps: losses {[round(x, 4) for x in losses]}")
    log(f"  K3 launches over the {TRAIN_STEPS} steps: {counts}")
    n = cfg.num_blocks * TRAIN_STEPS
    want = dict(launches=2 * n, backward_launches=n)
    if counts != want:
        raise AssertionError(f"K3 launches in training: {counts}, expected "
                             f"{want}")
    if not (all(np.isfinite(losses))
            and np.mean(losses[-5:]) < losses[0]):
        raise AssertionError(f"training did not lower the loss: {losses}")

    # Where a step's time goes: the card's busy share and K3's shares.
    # CPU and CUDA activities: with CUDA's alone the profiler dropped the
    # first launches of a window (13a in this PR's first run).
    from torch.profiler import ProfilerActivity, profile
    step_fn = make_train_step(cfg, opt)
    batch = to_batch(data.batch_at(TRAIN_STEPS), dev)
    p, st = out["params"], out["opt_state"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p, st, _ = step_fn(p, st, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    times = kernel_times(prof)
    total = sum(t for t, _ in times.values())
    gemm = sum(t for key, (t, _) in times.items()
               if any(k in key.lower() for k in ("gemm", "nvjet")))
    k3 = by_name(times, K3_FWD_KERNELS + K3_BWD_KERNELS)
    fwd = sum(k3[k][0] for k in K3_FWD_KERNELS)
    bwd = sum(k3[k][0] for k in K3_BWD_KERNELS)
    top = sorted(((t, key) for key, (t, _) in times.items()), reverse=True)
    busy = total / (1e3 * wall)
    step_s = float(np.median(steps_s[1:]))
    shape = InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    flops = analytic_cost(cfg, shape).totals("train", remat=True)["flops"]
    tokens = TRAIN_SEQ * TRAIN_BATCH
    log(f"  step time (host clock, synchronised, median of steps 1-"
        f"{TRAIN_STEPS - 1}): {1e3 * step_s:.2f} ms (step 0 "
        f"{1e3 * steps_s[0]:.2f} ms); {tokens / step_s:.0f} tokens/s; "
        f"{flops / 1e12:.3f} TFLOP a step (launch/analytic.py, train, "
        f"remat) = {flops / step_s / 1e12:.2f} TFLOP/s achieved")
    log(f"  one profiled step: {1e3 * wall:.2f} ms on the host clock, the "
        f"card busy {total:.2f} ms ({100 * busy:.1f}%); K3 forward "
        f"{fwd:.2f} ms ({100 * fwd / total:.1f}% of busy), K3 backward "
        f"{bwd:.2f} ms ({100 * bwd / total:.1f}%; "
        f"{K3_BWD_STEP_MS_CUDA_CORES} ms with its products on the CUDA "
        f"cores); by launch (ms, launches "
        f"recorded): " + ", ".join(f"{k} {t:.2f} x{n}"
                                   for k, (t, n) in k3.items() if n)
        + f"; matrix products {gemm:.2f} ms ({100 * gemm / total:.1f}%); "
        f"the five kernels with the most device time: "
        + "; ".join(f"{name[:60]} {t:.2f} ms" for t, name in top[:5]))
    log_memory(f"{cfg.name} training")
    log(f"  peak device memory of step 0's check against the plain scan "
        f"(autograd through the token recurrence): "
        f"{check_peak / 2**30:.2f} GiB")
    return dict(counts=counts, step_s=step_s, losses=losses, busy=busy,
                peak=torch.cuda.max_memory_allocated())


def phase_train_bf16(fp32: dict) -> dict:
    """13e: full-width qwen2-0.5b in bf16 with remat: step 0's gradients
    with K1's bf16 kernels against the plain attention, TRAIN_STEPS steps
    of ``train(dtype=torch.bfloat16)`` with exact launch counts, the step's
    time and where it goes, beside 13b's fp32 numbers."""
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, remat=True)
    params = model.init_params(seed=0, dtype=torch.bfloat16, device="cuda")
    log(f"  {cfg.name}: bf16 weights, remat per block; batch {TRAIN_BATCH} "
        f"x {TRAIN_SEQ} tokens (SyntheticLM, seed 0), 13b's optimizer")
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    dev = torch.device("cuda")
    grads_against_ref(model, params, to_batch(data.batch_at(0), dev),
                      "step 0, full width, bf16", TRAIN_BF16_LOSS_RTOL,
                      TRAIN_BF16_GRAD_RMS_LIMIT)

    opt = AdamWConfig(**TRAIN_OPT)
    reset_counts(flash_attention)
    out = train(cfg, opt, iter(data), TRAIN_STEPS, dtype=torch.bfloat16,
                device="cuda", params=params, log_every=1,
                log_fn=lambda *_: None)
    counts = {name: n for name, n in vars(flash_attention).items()
              if name.endswith("launches")}
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    steps_s = np.diff([0.0] + [h["wall_s"] for h in hist])
    log(f"  {TRAIN_STEPS} steps in bf16: losses "
        f"{[round(x, 4) for x in losses]} (fp32, 13b: "
        f"{[round(x, 4) for x in fp32['losses']]})")
    log(f"  K1 launches over the {TRAIN_STEPS} steps: {counts}")
    n = cfg.num_blocks * TRAIN_STEPS
    want = dict(launches=2 * n, tensor_core_launches=2 * n, lse_launches=n,
                bf16_lse_launches=n, backward_launches=n,
                bf16_backward_launches=n, fp32_launches=0)
    if counts != want:
        raise AssertionError(f"K1 launches in bf16 training: {counts}, "
                             f"expected {want}")
    if not (all(np.isfinite(losses))
            and np.mean(losses[-5:]) < losses[0]):
        raise AssertionError(f"bf16 training did not lower the loss: "
                             f"{losses}")
    if any(p.dtype != torch.bfloat16 for p in flatten(out["params"])
           .values()):
        raise AssertionError("a bf16 parameter changed its dtype")

    # Where a step's time goes: the card's busy share and K1's shares.
    from torch.profiler import ProfilerActivity, profile
    step_fn = make_train_step(cfg, opt)
    batch = to_batch(data.batch_at(TRAIN_STEPS), dev)
    p, s = out["params"], out["opt_state"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p, s, _ = step_fn(p, s, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms = k1_kernel_ms(prof)
    step_s = float(np.median(steps_s[1:]))
    shape = InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    flops = analytic_cost(cfg, shape).totals("train", remat=True)["flops"]
    tokens = TRAIN_SEQ * TRAIN_BATCH
    busy = dev_ms["total"] / (1e3 * wall)
    log(f"  bf16 step time (host clock, synchronised, median of steps 1-"
        f"{TRAIN_STEPS - 1}): {1e3 * step_s:.2f} ms (step 0 "
        f"{1e3 * steps_s[0]:.2f} ms; fp32, 13b: {1e3 * fp32['step_s']:.2f} "
        f"ms, x{fp32['step_s'] / step_s:.2f}); {tokens / step_s:.0f} "
        f"tokens/s (fp32 {tokens / fp32['step_s']:.0f}); {flops / 1e12:.3f} "
        f"TFLOP a step (launch/analytic.py, train, remat) = "
        f"{flops / step_s / 1e12:.2f} TFLOP/s achieved (fp32 "
        f"{flops / fp32['step_s'] / 1e12:.2f})")
    log(f"  one profiled bf16 step: {1e3 * wall:.2f} ms on the host clock, "
        f"the card busy {dev_ms['total']:.2f} ms ({100 * busy:.1f}%; fp32 "
        f"{100 * fp32['busy']:.1f}%); K1 forward {dev_ms['fwd']:.2f} ms "
        f"({100 * dev_ms['fwd'] / dev_ms['total']:.1f}% of busy), K1 "
        f"backward {dev_ms['bwd']:.2f} ms "
        f"({100 * dev_ms['bwd'] / dev_ms['total']:.1f}%), matrix products "
        f"{dev_ms['gemm']:.2f} ms "
        f"({100 * dev_ms['gemm'] / dev_ms['total']:.1f}%); the five "
        f"kernels with the most device time: "
        + "; ".join(f"{name[:60]} {t:.2f} ms" for t, name in dev_ms["top"]))
    log_memory(f"{cfg.name} bf16 training")
    log(f"  peak device memory: bf16 "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, fp32 (13b) "
        f"{fp32['peak'] / 2**30:.2f} GiB")
    # What the fp32 O saved for the bf16 backward's delta costs, beside
    # the bf16 O the function itself needs.
    o_elems = TRAIN_BATCH * cfg.num_heads * TRAIN_SEQ * cfg.head_dim
    log(f"  the fp32 O saved for the backward: {4 * o_elems / 2**20:.2f} "
        f"MiB a layer, {4 * o_elems * cfg.num_blocks / 2**20:.1f} MiB over "
        f"{cfg.num_blocks} layers (a bf16 O: "
        f"{2 * o_elems * cfg.num_blocks / 2**20:.1f} MiB)")
    return dict(counts=counts, step_s=step_s, losses=losses, busy=busy,
                peak=torch.cuda.max_memory_allocated())


def max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in fp32, a leading index at a time (a full-width
    model's logits are 0.9 GiB in bf16)."""
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def spmd_rank(rank: int, cfg, params: dict, inputs: torch.Tensor,
              refs: torch.Tensor, query: torch.Tensor,
              query_ref: torch.Tensor) -> dict:
    """One rank of phase 14 (spawned by ``spawn_ranks``; ``params`` and the
    references are the parent's, through CUDA IPC).  Returns its times,
    errors, K1 launches, repack and peak memory."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    mesh = stage_mesh(SPMD_STAGES, device="cuda:0")
    stage = mesh.axis_index("stage")
    fn = make_pipeline_fn(cfg, mesh, num_microbatches=SPMD_MICROBATCHES,
                          cap=SPMD_CAP)

    def timed(f):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = f()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    # Warm-up (K1's library, the library handles), outside the counts.
    tile = stage_tile(params["blocks"], SPMD_CONFIGS[0], SPMD_CAP, stage)
    fn(tile, SPMD_CONFIGS[0], inputs)
    reset_counts(flash_attention)
    got = dict(device=str(mesh.device), backend=mesh.backend, configs={})
    for i, config in enumerate(SPMD_CONFIGS):
        if i > 0:
            tile, repack_ms = timed(lambda: stage_tile(
                params["blocks"], config, SPMD_CAP, stage))
            if i == 1:
                got["repack"] = dict(ms=repack_ms, bytes=tree_bytes(tile))
        runs = [timed(lambda: fn(tile, config, inputs))
                for _ in range(SPMD_REPS)]
        if not all(torch.equal(y, runs[0][0]) for y, _ in runs[1:]):
            raise AssertionError(f"rank {rank}: {config}'s runs differ")
        got["configs"][str(config)] = dict(
            ms=[ms for _, ms in runs],
            max_abs_err=max_abs_diff(runs[0][0], refs))
    del tile
    ex = SpmdPipelineExecutor(cfg, params, SPMD_STAGES, cap=SPMD_CAP,
                              num_microbatches=SPMD_MICROBATCHES, mesh=mesh)
    logits, got["query_ms"] = timed(
        lambda: ex.run_query(query, SPMD_CONFIGS[-1]))
    got["query_max_abs_err"] = max_abs_diff(logits, query_ref)
    got["query_finite"] = bool(torch.isfinite(logits).all())
    got["launches"] = {name: getattr(flash_attention, name)
                       for name in vars(flash_attention)
                       if name.endswith("launches")}
    got["sends"], got["host_copies"] = fn.sends, fn.host_copies
    got["peak_bytes"] = torch.cuda.max_memory_allocated()
    return got


def phase_spmd() -> dict:
    """14: the SPMD stage pipeline, SPMD_STAGES gloo ranks on this card."""
    cfg, params = init_model(get_config("qwen3-4b"))
    L, M = cfg.num_blocks, SPMD_MICROBATCHES
    rng = np.random.default_rng(14)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (M, 1, SEQ)),
                             device="cuda")
    query = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                         (SPMD_QUERY_ROWS, SEQ)),
                            device="cuda")
    ex = LocalPipelineExecutor(cfg, params, device="cuda")
    pos = torch.arange(SEQ, device="cuda").expand(1, SEQ)
    with torch.no_grad():
        inputs = embed(params["embed"], tokens)
    # The single-process reference: the blocks in order, one microbatch at
    # a time, on this card (the first pass warms it).
    single = []
    for _ in range(SPMD_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = torch.stack([ex.stage_fn(inputs[m], pos, 0, L)
                            for m in range(M)])
        torch.cuda.synchronize()
        single.append(1e3 * (time.perf_counter() - t0))
    single = single[1:]
    refs = refs.clone()             # a normal tensor, for CUDA IPC
    # run_query's reference: LocalPipelineExecutor.run_query over the
    # rows at once (the pipeline runs one row a microbatch).
    logits, _ = ex.run_query(query, [L])
    logits = logits.clone()
    init_file = ROOT / "build" / f"spmd_rendezvous_{os.getpid()}"
    init_file.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(spmd_rank, SPMD_STAGES,
                            (cfg, params, inputs, refs, query, logits),
                            backend="gloo", init_file=str(init_file))
    finally:
        init_file.unlink(missing_ok=True)
    log(f"  {SPMD_STAGES} gloo ranks on {ranks[0]['device']} (cap "
        f"{SPMD_CAP}, M {M}, microbatches of 1 x {SEQ} tokens): spawned, "
        f"run and joined in {time.perf_counter() - t0:.1f} s; the parent's "
        f"params shared through CUDA IPC")
    log(f"  single process, the {M} microbatches through the {L} blocks "
        f"in order: {', '.join(f'{ms:.2f}' for ms in single)} ms (host "
        f"clock, synchronised)")
    failed = []
    launches = 0
    for config in SPMD_CONFIGS:
        key = str(config)
        ms = [max(r["configs"][key]["ms"][i] for r in ranks)
              for i in range(SPMD_REPS)]
        err = max(r["configs"][key]["max_abs_err"] for r in ranks)
        log(f"  {config}: {', '.join(f'{t:.2f}' for t in ms)} ms (the "
            f"slowest rank's, host clock, synchronised; single process "
            f"{np.median(single):.2f}); max|d| against the single process "
            f"{err:.3e} on every rank: "
            f"{[r['configs'][key]['max_abs_err'] for r in ranks]}")
        if err != 0.0:
            failed.append((config, err))
    repack = [r["repack"] for r in ranks]
    repack_ms = ", ".join(f"{p['ms']:.2f}" for p in repack)
    log(f"  repack {list(SPMD_CONFIGS[0])} -> {list(SPMD_CONFIGS[1])}: "
        f"{repack_ms} ms by rank, "
        f"{sum(p['bytes'] for p in repack) / 2**30:.2f} GiB of tiles "
        f"written ({repack[0]['bytes'] / 2**30:.2f} GiB a rank)")
    worst = max(r["query_max_abs_err"] for r in ranks)
    log(f"  run_query, {SPMD_QUERY_ROWS} rows in {M} microbatches on "
        f"{SPMD_CONFIGS[-1]}: max|d| against LocalPipelineExecutor."
        f"run_query {worst:.3e} on every rank; "
        f"{max(r['query_ms'] for r in ranks):.2f} ms")
    if worst != 0.0:
        failed.append(("run_query", worst))
    for stage, r in enumerate(ranks):
        want = (SPMD_REPS * sum(c[stage] for c in SPMD_CONFIGS)
                + SPMD_CONFIGS[-1][stage]) * M
        got = r["launches"]
        log(f"  rank {stage}: K1 {got['tensor_core_launches']} launches on "
            f"its tensor-core kernel (= {want}: its blocks x {M} "
            f"microbatches, {SPMD_REPS} runs a config and run_query), "
            f"{r['sends']} hand-offs, {r['host_copies']} host-buffer "
            f"copies, peak {r['peak_bytes'] / 2**30:.2f} GiB "
            f"(torch.cuda.max_memory_allocated)")
        if (got["tensor_core_launches"] != want or got["launches"] != want
                or not r["query_finite"]):
            failed.append(("rank", stage, got, r["query_finite"]))
        launches += got["tensor_core_launches"]
    if failed:
        raise AssertionError(f"the SPMD pipeline: {failed}")
    return dict(launches=launches)


def phase_train_cli() -> dict:
    """13d: the training CLI once at full width."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           TRAIN_ARCH, "--full", "--steps", str(TRAIN_CLI_STEPS)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ,
                                             PYTHONPATH=str(ROOT / "src")))
    wall = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    log(f"  {' '.join(cmd[1:])}: exit {r.returncode} in {wall:.1f} s")
    for line in lines:
        log(f"    {line}")
    if r.returncode != 0:
        raise AssertionError(f"the training CLI failed:\n{r.stderr[-3000:]}")
    last = float(lines[-1].split("loss=")[1].split()[0])
    if not (lines[-1].startswith(f"step {TRAIN_CLI_STEPS - 1:5d}")
            and np.isfinite(last)):
        raise AssertionError(f"the training CLI's last line: {lines[-1]}")
    return dict(wall=wall)


# -- phase 15: the device examples and the dry run's roofline ---------------


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``__main__`` block stays
    off)."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k1_counts() -> dict:
    return {name: n for name, n in vars(flash_attention).items()
            if name.endswith("launches")}


def phase_serve_example() -> dict:
    """15a: ``examples/serve_interference_torch.py`` at its defaults (8
    smoke-width qwen3-4b blocks in fp32, 80 queries of 128 tokens): every
    section serves every query, every K1 launch is the fp32 kernel's
    plain entry point, and each distinct shape's first launch is held
    against the plain version at the fp32 cases' tolerance."""
    example = load_example("serve_interference_torch")
    reset_counts(flash_attention)
    with K1Shapes() as shapes:
        out = example.main(device="cuda")
    counts = k1_counts()
    launches = counts["launches"]
    for name, s in out["schedulers"].items():
        log(f"  15a {name}: mean latency {1e3 * s['mean_latency_s']:.2f} ms,"
            f" p99 {1e3 * s['p99_latency_s']:.2f} ms, throughput "
            f"{s['mean_throughput_qps']:.1f} q/s, rebalances "
            f"{s['rebalances']}, serial_frac {s['serial_frac']:.3f}")
    log(f"  15a batched (max_batch 8) against unbatched rebalance and trial "
        f"accounting identical: {out['acct_match']}")
    log(f"  15a K1 launches: {launches}, by route {counts}; by shape "
        f"{shapes.counts}")
    short = [k for k, n in out["served"].items()
             if n != example.NUM_QUERIES]
    if short:
        raise AssertionError(f"15a: sections that did not serve all "
                             f"{example.NUM_QUERIES} queries: {short}")
    want = dict(counts, launches=launches, fp32_launches=launches,
                tensor_core_launches=0, lse_launches=0, backward_launches=0,
                bf16_lse_launches=0, bf16_backward_launches=0)
    if not (launches > 0 and counts == want
            and sum(shapes.counts.values()) == launches):
        raise AssertionError(f"15a: K1 launches {counts}, by shape "
                             f"{shapes.counts}")
    readings = shapes.check()
    return dict(launches=launches, readings=readings,
                acct_match=out["acct_match"])


def phase_train_example() -> dict:
    """15b: ``examples/train_small_torch.py`` at its defaults (qwen3-100m,
    4 x 128 tokens, 300 steps, fp32): the loss falls (the example asserts
    it), K1 launches its fp32 forward twice, its LSE entry and its
    backward once a block and step, and the first launch of each at this
    shape is held against the plain version; the median step time,
    tokens/s and the peak memory."""
    example = load_example("train_small_torch")
    ckpt = ROOT / "build" / "chip_smoke_train_small"
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # what earlier phases still hold
    reset_counts(flash_attention)
    with K1Shapes() as shapes, K1TrainLaunches() as train_launches:
        out = example.main(checkpoint_dir=str(ckpt), device="cuda",
                           log_every=1,
                           log_fn=lambda line: line.startswith(
                               ("step     0 ", "step   299 ")) and log(line))
    counts = k1_counts()
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = example.default_config()
    hist = out["history"]
    steps = len(hist)
    steps_s = np.diff([0.0] + [h["wall_s"] for h in hist])
    step_s = float(np.median(steps_s[1:]))
    tokens = 4 * 128
    shape = InputShape("train", 128, 4, "train")
    flops = analytic_cost(cfg, shape).totals("train", remat=True)["flops"]
    log(f"  15b {cfg.name}, {cfg.param_count() / 1e6:.1f} M parameters, "
        f"{steps} steps: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f};"
        f" step time (host clock, synchronised, median of steps 1-"
        f"{steps - 1}) {1e3 * step_s:.2f} ms; {tokens / step_s:.0f} "
        f"tokens/s; {flops / step_s / 1e12:.2f} TFLOP/s of "
        f"{flops / 1e12:.4f} TFLOP a step (launch/analytic.py); peak device "
        f"memory {(peak - held) / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB allocated when the phase began "
        f"({peak / 2**30:.2f} GiB in all); K1 launches {counts}")
    n = cfg.num_blocks * steps
    want = dict(launches=2 * n, fp32_launches=2 * n, lse_launches=n,
                backward_launches=n, tensor_core_launches=0,
                bf16_lse_launches=0, bf16_backward_launches=0)
    if counts != want:
        raise AssertionError(f"15b: K1 launches {counts}, expected {want}")
    if not (np.isfinite(hist[-1]["loss"])
            and hist[-1]["loss"] < hist[0]["loss"]):
        raise AssertionError("15b: the loss did not fall")
    worst = train_launches.check()
    worst["fwd"] = max([worst["fwd"]] + [m["max_abs_err"] for m in
                                         shapes.check().values()])
    return dict(counts=counts, step_s=step_s, peak=peak - held, worst=worst)


#: step_mfu expected before the first card run of phase 15: analytic FLOPs
#: over (the step time the records hold x the dtype's peak) -- PERF.md's
#: 8.18 TFLOP qwen2-0.5b step at 300.61 ms fp32 and 214.26 ms bf16, the
#: 6.881 TFLOP mamba2-370m step at 434.84 ms, and a 7.75 TFLOP qwen3-4b
#: prefill in the 31-46 ms a clean query spends in its blocks.
PREDICTED_STEP_MFU = {"13b": 0.41, "13e": 0.04, "13f": 0.24, "6": 0.20}
STEP_MFU_LIMIT = 1.05          # no card beats its roofline


def phase_roofline(steps: dict) -> dict:
    """15c: the dry run (``launch/dryrun.py``, on the meta device) of the
    steps the card timed: 13b, 13e, 13f and phase 6's prefill.  For each,
    its predicted argument bytes and peak beside the measured peak, the
    roofline bound beside the measured step, and step_mfu = analytic FLOPs
    / (step time x the dtype's peak), which must not pass
    STEP_MFU_LIMIT."""
    out = {}
    for key, (arch, shape, dtype, measured) in steps.items():
        cfg = get_config(arch)
        rep = dryrun.roofline_report(cfg, shape, dtype=dtype)
        terms, mem = rep["terms"], rep["memory"]
        bound_s = max(terms.t_compute, terms.t_memory, terms.t_collective)
        peak = roofline.peak_flops(dtype)
        mfu = terms.flops / (measured["step_s"] * peak)
        log(f"  15c {key}: {arch} {shape.mode} {shape.global_batch} x "
            f"{shape.seq_len} {str(dtype)[6:]}: arguments "
            f"{mem['argument_bytes'] / 2**30:.2f} GiB, predicted peak "
            f"{mem['total_bytes'] / 2**30:.2f} GiB (meta run "
            f"{rep['seconds']:.1f} s) beside max_memory_allocated "
            f"{measured['peak'] / 2**30:.2f} GiB; roofline bound "
            f"{1e3 * bound_s:.2f} ms ({terms.bottleneck}; compute "
            f"{1e3 * terms.t_compute:.2f}, memory {1e3 * terms.t_memory:.2f})"
            f" beside the measured step {1e3 * measured['step_s']:.2f} ms; "
            f"FLOPs analytic {terms.flops / 1e12:.4f} T, FlopCounterMode "
            f"{rep['counted_flops'] / 1e12:.4f} T; step_mfu {mfu:.4f} at "
            f"{peak / 1e12:.0f} TFLOP/s (predicted "
            f"{PREDICTED_STEP_MFU[key]})")
        if not mfu <= STEP_MFU_LIMIT:
            raise AssertionError(f"15c {key}: step_mfu {mfu} above "
                                 f"{STEP_MFU_LIMIT}")
        out[key] = dict(step_mfu=mfu, bound_s=bound_s,
                        total_bytes=mem["total_bytes"])
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    def phase(title: str, fn, *args):
        log(title)
        t0 = time.perf_counter()
        result = fn(*args)
        log(f"  [{title.split(':')[0]}: {time.perf_counter() - t0:.1f} s; "
            f"{time.perf_counter() - t_start:.1f} s since start]")
        return result

    def build_all():
        logs = build.build_kernels(KERNELS)
        for name, (nvcc_log, seconds) in logs.items():
            log(f"  {name}: {build.lib_path(name).name}, nvcc {seconds:.1f} s"
                + ("" if nvcc_log is None else f"\n{nvcc_log}"))
        logs = {name: nvcc_log for name, (nvcc_log, _) in logs.items()}
        lib = build.load("flash_attention_bf16")
        smem = lib.odin_flash_attention_bf16_smem_bytes
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        for name, line in ptxas_lines(logs["flash_attention_bf16"] or ""):
            dp, lse = re.search(r"ILi(\d+)ELb(\d)E", name).groups()
            log(f"  K1 tensor-core kernel, head dims padded to {dp}"
                f"{' (LSE entry)' if lse == '1' else ''}: {line}, "
                f"{smem(int(dp))} B dynamic shared memory")
        # K3's forward: bf16 at the serving shape, fp32 (3xTF32) at the
        # training shape; the state pass is not a template.
        k3_cases = {"bf16": SSD_MAIN_CASE, "fp32": SSD_BACKWARD_TRAIN_CASE}
        spilled = []
        for name, line in ptxas_lines(logs["ssd_scan"] or ""):
            launch = next(k for k in K3_FWD_KERNELS if k in name)
            dtype = "bf16" if "bfloat16" in name else "fp32"
            case = k3_cases[dtype]
            grid, threads, smem_bytes = k3_lib.launch_shape(
                *case[:6], getattr(torch, case[6]))[launch]
            log(f"  K3 {launch}"
                + ("" if launch == "ssd_state_pass" else f" ({dtype})")
                + f" at {case}: grid {grid} = {int(np.prod(grid))} blocks of "
                f"{threads} threads, {line}, {smem_bytes} B dynamic shared "
                f"memory")
            if "0 B spill stores, 0 B spill loads" not in line:
                spilled.append((name, line))
        if spilled:
            raise AssertionError(f"ssd_scan: ptxas spilled: {spilled}")
        # The fp32 route's products are TF32 mma.sync (3xTF32), with no
        # product loop left on the CUDA cores.
        tf32 = hmma_counts("ssd_scan", "HMMA.1688.F32.TF32")
        ffma = hmma_counts("ssd_scan", "FFMA")
        for fn, n in tf32.items():
            log(f"  ssd_scan.cu {k3_label(fn)}: {n} HMMA.1688.F32.TF32, "
                f"{ffma[fn]} FFMA")
        routes = [n for fn, n in tf32.items() if "IfE" in fn]
        if len(routes) != 2 or min(routes) == 0:
            raise AssertionError(f"ssd_scan: an fp32 launch has no TF32 "
                                 f"tensor-core instruction: {tf32}")
        # K3's backward: each launch in both dtypes at the training shape
        # (the chunk-term launch at S 1024, where it runs), the blocks an SM
        # of the two that hold tiles; the tile launches' products are TF32
        # mma.sync, and ptxas keeps every register in place.
        spilled = []
        for name, line in ptxas_lines(logs["ssd_scan_bwd"] or ""):
            launch = next(k for k in K3_BWD_KERNELS if k in name)
            dtype = torch.bfloat16 if "bfloat16" in name else torch.float32
            shapes = k3_lib.backward_launch_shape(
                *SSD_BACKWARD_TRAIN_CASE[:6], dtype)
            long_shapes = k3_lib.backward_launch_shape(
                *SSD_BACKWARD_TIMED[1], dtype)
            grid, threads, smem_bytes = {**long_shapes, **shapes}[launch]
            per_sm = k3_lib.backward_blocks_per_sm(dtype).get(launch)
            log(f"  K3 backward {launch}"
                + ("" if launch == "ssd_bwd_state_pass" else
                   f" ({str(dtype)[6:]})")
                + f" at {SSD_BACKWARD_TRAIN_CASE[:6]}"
                + (" (S 1024)" if launch not in shapes else "")
                + f": grid {grid} = {int(np.prod(grid))} blocks of {threads}"
                f" threads, {line}, {smem_bytes} B dynamic shared memory"
                + ("" if per_sm is None else f", {per_sm} blocks an SM"))
            if "0 B spill stores, 0 B spill loads" not in line:
                spilled.append((name, line))
        if spilled:
            raise AssertionError(f"ssd_scan_bwd: ptxas spilled: {spilled}")
        tf32 = hmma_counts("ssd_scan_bwd", "HMMA.1688.F32.TF32")
        ffma = hmma_counts("ssd_scan_bwd", "FFMA")
        for fn, n in tf32.items():
            launch = next(k for k in K3_BWD_KERNELS if k in fn)
            log(f"  ssd_scan_bwd.cu {launch}"
                + ("<__nv_bfloat16>" if "bfloat16" in fn else
                   "<float>" if "IfE" in fn else "")
                + f": {n} HMMA.1688.F32.TF32, {ffma[fn]} FFMA")
        tiles = [n for fn, n in tf32.items() if "ssd_bwd_tiles" in fn]
        if len(tiles) != 2 or min(tiles) == 0:
            raise AssertionError(f"ssd_scan_bwd: a tile launch has no TF32 "
                                 f"tensor-core instruction: {tf32}")
        for name, line in ptxas_lines(logs["decode_attention"] or ""):
            if "bfloat16" in name:
                log(f"  K2 decode_fwd (bf16): {line}")
        fwd_lib = build.load("flash_attention")
        smem = fwd_lib.odin_flash_attention_smem_bytes
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        for name, line in ptxas_lines(logs["flash_attention"] or ""):
            width, lse = re.search(r"flash_fwdILi(\d+)ELb(\d)", name).groups()
            log(f"  K1 fp32 kernel, head dims padded to {width}"
                f"{' (LSE entry)' if lse == '1' else ''}: {line}, "
                f"{smem(int(width))} B dynamic shared memory")
        bwd_lib = build.load("flash_attention_bwd")
        smem = bwd_lib.odin_flash_attention_bwd_smem_bytes
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        for name, line in ptxas_lines(logs["flash_attention_bwd"] or ""):
            kernel = re.search(r"bwd_(?:dkv_sum|tiles|delta)", name).group()
            width = re.search(r"ILi(\d+)E", name)
            log(f"  K1 backward {kernel}"
                + ("" if width is None else
                   f", head dims padded to {width.group(1)}")
                + f": {line}" + ("" if width is None else
                                 f", {smem(int(width.group(1)))} B "
                                 f"dynamic shared memory"))
        bwd_lib = build.load("flash_attention_bwd_bf16")
        smem = bwd_lib.odin_flash_attention_bwd_bf16_smem_bytes
        threads = bwd_lib.odin_flash_attention_bwd_bf16_threads
        for fn in (smem, threads):
            fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        spilled = []
        for name, line in ptxas_lines(logs["flash_attention_bwd_bf16"]
                                      or ""):
            kernel = re.search(r"bwd_(?:dkv_sum|tiles|delta)", name).group()
            width = re.search(r"ILi(\d+)E", name)
            tiles = kernel == "bwd_tiles"
            log(f"  K1 bf16 backward {kernel}"
                + ("" if width is None else
                   f", head dims padded to {width.group(1)}")
                + f": {line}" + (
                    f", {threads(int(width.group(1)))} threads, "
                    f"{smem(int(width.group(1)))} B dynamic shared memory"
                    if tiles else ""))
            if tiles and "0 B spill stores, 0 B spill loads" not in line:
                spilled.append((name, line))
        # The tile kernels' products are wgmma (HGMMA in SASS), and ptxas
        # keeps every register in place.
        counts = hmma_counts("flash_attention_bwd_bf16", "HGMMA")
        for fn, n in counts.items():
            log(f"  flash_attention_bwd_bf16.cu {kernel_label(fn)}: {n} "
                f"HGMMA")
        if min(n for fn, n in counts.items() if "bwd_tiles" in fn) == 0:
            raise AssertionError(f"flash_attention_bwd_bf16: a tile kernel "
                                 f"has no wgmma (HGMMA): {counts}")
        if spilled:
            raise AssertionError(f"flash_attention_bwd_bf16: ptxas spilled "
                                 f"in a tile kernel: {spilled}")
        # The fp32 kernels' products on the tensor cores: TF32 mma.sync.
        for name in ("flash_attention", "flash_attention_bwd"):
            counts = hmma_counts(name, "HMMA.1688.F32.TF32")
            for fn, n in counts.items():
                log(f"  {name}.cu {kernel_label(fn)}: {n} "
                    f"HMMA.1688.F32.TF32")
            products = [n for fn, n in counts.items()
                        if "flash_fwd" in fn or "bwd_tiles" in fn]
            if not products or min(products) == 0:
                raise AssertionError(f"{name}: a kernel has no TF32 "
                                     f"tensor-core instruction: {counts}")

    phase("phase 2: build K1 (bf16, fp32 and their backwards), K2, K3",
          build_all)
    main_k1 = phase("phase 3: K1 against its plain version",
                    phase_kernel_check)
    k3 = phase("phase 4: K3 against its plain version", phase_ssd_check)
    k2 = phase("phase 5: K2 against its plain version", phase_decode_check)
    qcfg, qparams = init_model(get_config("qwen3-4b"))
    served = phase("phase 6: full-width qwen3-4b under ODIN", phase_qwen,
                   qcfg, qparams, main_k1[SEQ]["ms"])
    mcfg, mparams = init_model(get_config("mamba2-370m"))
    served_m = phase("phase 7: full-width mamba2-370m under ODIN",
                     phase_mamba, mcfg, mparams, k3["ms"])
    cached = phase("phase 8: the cached path (prefill, decode)",
                   phase_cached, qcfg, qparams, mcfg, mparams)
    batched = phase("phase 9: batched and open-loop serving at full width",
                    phase_batched, qcfg, qparams, mcfg, mparams,
                    main_k1[(MAX_BATCH, LONG)]["ms"], k3["batched_ms"])
    hybrid = phase("phase 11a: qwen3-4b under hybrid through api.run",
                   phase_hybrid, qcfg, qparams, served)
    oracle = phase("phase 11b: qwen3-4b under the live DP oracle",
                   phase_oracle, qcfg, qparams, hybrid)
    meshed = phase("phase 11c: qwen3-4b under ODIN on a modelled mesh",
                   phase_mesh, qcfg, qparams, hybrid)
    measured = phase("phase 11d: the simulator over block times measured "
                     "here", phase_measured_db, qcfg, qparams)
    interfered = phase("phase 11e: the measured interference database "
                       "(Table-1 stressors and card co-tenants)",
                       phase_interference_db, qcfg, measured)
    measured_launches = measured["launches"]
    del measured             # 11d's engine and executor
    scfg, sparams = init_model(get_config(SMALL_ARCH))
    fleet = phase("phase 12: fleets, admission, faults and QoS tiers "
                  "(serve_cluster)", phase_fleet, qcfg, qparams, scfg,
                  sparams)
    del sparams
    k1_phase11 = (hybrid["launches"] + oracle["launches"]
                  + meshed["launches"] + measured_launches
                  + interfered["launches"])
    log(f"  K1 launches in phase 11: {k1_phase11} = {hybrid['launches']} "
        f"(11a) + {oracle['launches']} (11b) + {meshed['launches']} (11c) "
        f"+ {measured_launches} (11d) + {interfered['launches']} (11e)")
    del hybrid

    # Phases 13 and 10 load each model alone: the earlier phases' go first.
    del qparams, mparams
    free_memory()
    log(f"  freed qwen3-4b, mamba2-370m and qwen2-0.5b: device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    bwd = phase("phase 13a: K1's backward against its plain version",
                phase_backward_check)
    trained = phase("phase 13b: full-width qwen2-0.5b trains in fp32",
                    phase_train)
    free_memory()
    phase("phase 13c: one train step of each family at smoke width",
          phase_train_families)
    free_memory()
    phase("phase 13d: the training CLI at full width", phase_train_cli)
    free_memory()
    trained_bf16 = phase("phase 13e: full-width qwen2-0.5b trains in bf16",
                         phase_train_bf16, trained)
    free_memory()
    trained_mamba = phase("phase 13f: full-width mamba2-370m trains in fp32",
                          phase_train_mamba)
    free_memory()
    family = phase("phase 10.0: the new paths' kernel shapes against their "
                   "plain versions", phase_family_kernels)
    free_memory()

    def family_ms(kernel: str, *shape) -> float:
        return next(m["ms"] for key, m in family.items()
                    if key[0] == kernel and key[1:1 + len(shape)] == shape)

    ds = phase("phase 10a: full-width deepseek-moe-16b under ODIN",
               phase_deepseek, family_ms("K1", 1, 16, 16, 1024, 128))
    free_memory()
    hub = phase("phase 10b: full-width hubert-xlarge", phase_hubert,
                family_ms("K1", 1, 16, 16, 1024, 80))
    free_memory()
    llava = phase("phase 10c: full-width llava-next-34b", phase_llava)
    free_memory()
    mixtral = phase("phase 10d: mixtral-8x22b, 4 blocks at full width",
                    phase_mixtral)
    free_memory()
    jamba = phase("phase 10e: jamba-1.5-large at its smoke width",
                  phase_jamba)
    cached_10 = [ds["cached"], llava["cached"], mixtral["cached"],
                 jamba["cached"]]
    free_memory()
    spmd = phase("phase 14: the SPMD stage pipeline, 4 gloo ranks on this "
                 "card", phase_spmd)
    free_memory()
    serve_ex = phase("phase 15a: examples/serve_interference_torch.py",
                     phase_serve_example)
    free_memory()
    train_ex = phase("phase 15b: examples/train_small_torch.py",
                     phase_train_example)
    free_memory()
    train_shape = InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    phase("phase 15c: the dry run's roofline of the steps timed here",
          phase_roofline, {
              "13b": (TRAIN_ARCH, train_shape, torch.float32, trained),
              "13e": (TRAIN_ARCH, train_shape, torch.bfloat16, trained_bf16),
              "13f": (MAMBA_TRAIN_ARCH, train_shape, torch.float32,
                      trained_mamba),
              "6": ("qwen3-4b", InputShape("prefill", SEQ, 1, "prefill"),
                    torch.bfloat16, served["prefill"]),
          })

    def worst(kernel: str, readings: list) -> float:
        return max([m["max_abs_err"] for m in readings]
                   + [m["max_abs_err"] for key, m in family.items()
                      if key[0] == kernel])

    k1 = dict(main_k1[SEQ], max_abs_err=worst(
        "K1", list(main_k1.values()) + list(fleet["readings"].values())))
    k2 = dict(k2, max_abs_err=worst("K2", [k2]))
    k3 = dict(k3, max_abs_err=worst("K3", [k3]))
    # Launches on the main paths: the closed-loop serves (qwen3-4b,
    # deepseek-moe-16b, hubert-xlarge), the batched one, phase 11's
    # serves and block-time measurement, phase 12's fleets and phase 14's
    # ranks for K1; the decode steps of every cached path for K2; the
    # closed-loop and batched serves of mamba2-370m and jamba's forward and
    # prefill for K3.
    rows = [
        ("flash_attention", "flash_attention.py:96",
         served["counts"]["tensor_core_launches"]
         + batched["qwen3-4b"]["launches"] + ds["served"]["launches"]
         + hub["served"]["launches"] + k1_phase11 + fleet["launches"]
         + spmd["launches"], k1),
        ("decode_attention", "decode_attention.py:78",
         cached["qwen3-4b"]["launches"] + sum(c["k2"] for c in cached_10),
         k2),
        ("ssd_scan", "ssd_scan.py:71",
         served_m["launches"] + batched["mamba2-370m"]["launches"]
         + jamba["k3"] + jamba["cached"]["k3"], k3),
    ]
    # The training path: K1's fp32 forward (both entry points) and its
    # backward, launched by phase 13b's steps.
    # Phase 15's examples run the same kernels: serving in fp32 (15a) and
    # training in fp32 (15b).
    k1_train = bwd["timed"][BACKWARD_TRAIN_CASE]
    rows += [
        ("flash_attention_fp32", "flash_attention.py:96",
         trained["counts"]["fp32_launches"] + serve_ex["launches"]
         + train_ex["counts"]["fp32_launches"],
         dict(k1_train["fwd"], max_abs_err=max(
             [bwd["worst"]["fwd"], train_ex["worst"]["fwd"]]
             + [m["max_abs_err"] for m in serve_ex["readings"].values()]))),
        ("flash_attention_bwd", "flash_attention.py:96",
         trained["counts"]["backward_launches"]
         + train_ex["counts"]["backward_launches"],
         dict(k1_train["bwd"], max_abs_err=max(bwd["worst"]["bwd"],
                                               train_ex["worst"]["bwd"]))),
    ]
    # The bf16 training path: K1's bf16 LSE entry and its bf16 backward,
    # launched by phase 13e's steps.
    k1_bf16 = bwd["bf16"]["timed"][BACKWARD_BF16_TRAIN_CASE]
    rows += [
        ("flash_attention_bf16_lse", "flash_attention.py:96",
         trained_bf16["counts"]["bf16_lse_launches"],
         dict(k1_bf16["fwd"], max_abs_err=bwd["bf16"]["worst"]["fwd"])),
        ("flash_attention_bwd_bf16", "flash_attention.py:96",
         trained_bf16["counts"]["bf16_backward_launches"],
         dict(k1_bf16["bwd"], max_abs_err=bwd["bf16"]["worst"]["bwd"])),
    ]
    # The Mamba2 training path: K3's backward, launched by phase 13f's
    # steps (its forward launches are counted in the ssd_scan row's path
    # only where it serves).
    k3_train = bwd["k3"]["timed"][(SSD_BACKWARD_TRAIN_CASE[:6], "float32")]
    rows.append(("ssd_scan_bwd", "ssd_scan.py:71",
                 trained_mamba["counts"]["backward_launches"],
                 dict(k3_train, max_abs_err=bwd["k3"]["worst"]["float32"][2])))
    # K3's fp32 forward (3xTF32), launched twice a block by 13f's steps
    # (remat), at the training shape.
    k3_fp32 = k3["fp32"]
    rows.append(("ssd_scan_fp32", "ssd_scan.py:71",
                 trained_mamba["counts"]["launches"],
                 dict(k3_fp32[SSD_BACKWARD_TRAIN_CASE[:6]], max_abs_err=max(
                     m["max_abs_err"] for m in k3_fp32.values()))))
    sources = {"flash_attention": "flash_attention_bf16",
               "flash_attention_fp32": "flash_attention",
               "flash_attention_bf16_lse": "flash_attention_bf16",
               "ssd_scan_fp32": "ssd_scan"}
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{sources.get(name, name)}.cu",
        "replaces": f"src/repro/kernels/{replaces}",
        "launches": launches,
        "max_abs_err": m["max_abs_err"],
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        "library_ms": m["library_ms"],
    } for name, replaces, launches, m in rows]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
