#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device: requires a CUDA card; TF32 off; prints the card's name and power
   limit as nvidia-smi reports them.
2. build: compiles the port's CUDA sources (``src/repro_torch/kernels/csrc``,
   one nvcc per source, all started together) and prints the seconds.
3. kernels: each suff-stats kernel at the streaming path's shapes (N = 2^20
   instances; gmm_large for clg_suffstats, fa_plate for
   clg_suffstats_latent, nb_mixed for clg_disc_counts) against its plain
   PyTorch version, twice for bitwise repeatability, and timed with CUDA
   events against the plain version, one PyTorch library call where there is
   one, and the least time the card could take (bytes over 3.35 TB/s or
   float32 operations over 67 TFLOP/s, whichever is larger);
   each kernel's two stages profiled apart (one kernel of each a call
   counted), clg_suffstats_latent also at a wide row (2^18 instances,
   F = 300, K = 2, L = 4), clg_disc_counts also at a wide row (2^18
   instances, Fd = 400, K = 4, C = 8).
4. streaming main path: for gmm_large, nb_mixed and fa_plate at full width,
   a drifting stream of T = 8 chunks of 2^20 instances whose generator
   switches at chunk 4 goes through ``Model.update_model(stream, sweeps=5,
   tol=0.0)`` with the default (CUDA) backend, then ``posterior_z`` on 2^20
   queries; the same fit is re-run with ``backend="einsum"`` as the
   yardstick.
5. exact serving: ``PGMQueryEngine(mode="exact", pad_pow2=True)`` answers
   B = 1024 queries per evidence schema per flush on three networks -- the
   discrete pipeline on ``random_discrete_bn(32, card=4, max_parents=3)``
   (3 schemas, 4 flushes), the strong pipeline on BENCH_latent's depth-12
   CLG chain and on an FA-style network at fa_plate's widths (Z card 4,
   four latent H, 16 observed leaves) -- with the CUDA backend and the plain
   backend in turns (plain, cuda, cuda, plain), asserting the launches per
   propagation (168 log_product + 48 log_marginalize on the discrete
   network, at least one cg_weak_marg on each strong one) and that the two
   backends agree; then ``factors.reduce_evidence`` on the largest clique
   belief and ``Model.posterior_exact`` on the fitted nb_mixed model,
   against ``posterior_z``.
6. factor kernels: each of the four at the largest shape the serving phase
   launched, against its plain version (same bits for log_product and
   evidence_select), with all -inf rows and dead mixture rows, timed as in
   phase 3; log_marginalize also at the largest short-row shape (N <= 128)
   of another N and the largest long-row shape the serving phase launched,
   each beside torch.logsumexp, its bound, its plan and the blocks an SM
   (the serving phase logs the shapes of one discrete32 propagation's 48
   launches); cg_weak_marg with its profiled device time a launch and its
   plan, also at n = 12 (entry blocks).
7. structure learning, data sampled on the card (N = 2^20): (a)
   ``hill_climb(max_parents=3)`` on ``random_discrete_bn(32, card=4,
   max_parents=3)`` with both backends (same parent sets and score
   asserted), ``chow_liu`` on a 32-node tree; (b) every family of <= 2
   parents (15904, C = 64) scored in one ``family_counts`` call on both
   backends (same scores asserted); (c) ``hill_climb`` on ``clg_tree_bn(32)``
   with both backends (same skeleton, scores within 1e-6), then
   ``clg_suffstats_chunks`` (one launch a group) at the largest call that
   search made, one chunk of it alone and the common shapes d [16384, 1, 2]
   and [16384, 30, 3], each against its plain version, the library einsum
   and its bound, stages apart, and the chunked call against per-chunk
   calls bit for bit; (d)
   ``AdaptiveStructure(learner="hillclimb")`` over 2^21 instances in
   batches of 2^16 whose generator switches halfway (first drift flag at or
   after the switch asserted), its network served exactly on both backends.
   The kernel wrappers' calls are counted by input shape.
8. family_counts: against its plain version at the largest shape that
   hill climbing, Chow-Liu and the adaptive stream each launched, at the
   common shapes (M = 30, C = 64 over 2^20 instances; M = 32, C = 256 over
   2^16) and at the all-candidates shape (same bits with 0/1 weights, also
   with tiles holding values above 255 and below 0; rtol 1e-5 with float
   weights; two launches the same bits), timed as in phase 3 with the
   blocks an SM holds (its row is the all-candidates shape).
9. LM prefill: ``forward`` of zamba2-1.2b at full width and depth (random
   weights from seed 0) on 2 prompts of 8192 tokens (prefill_32k's shape
   cut to one card), on ``"cuda"`` (exactly 38 ``ssd_scan`` and 6
   ``flash_attention`` launches asserted) and on ``"einsum"`` (none), the
   argmax the same at >= 90% of positions (beside the agreement of the
   plain path with itself at half the SSD chunk); then each of the 44 blocks on
   the plain path's own activations: the increment of the sublayer that
   holds a kernel within one bf16 rounding on the two backends, each
   kernel launch held against its plain version on the inputs the block
   fed it, and known-wrong variants (attention's window one kv tile short,
   the SSD state not carried across chunks) shown to fail both bars; warm
   tokens/s per backend, peak memory, a profiled forward per backend (the
   two kernels' device time by name, and ``ssd_scan``'s four kernels a
   launch).
10. LM serving: ``DecodeEngine`` (4 slots, capacity 256) serves 8 greedy
   requests of 32 new tokens (generated tokens/s); a 256-token prompt
   teacher-forced through ``decode_step`` gives the ``"cuda"`` forward's
   argmax at > 85% of positions (decode runs no kernel).
11. LM kernels: ``flash_attention`` (bf16 and fp32, window 4096 and none)
   and ``ssd_scan`` at the largest shapes the prefill launched against
   their plain versions (bf16 attention against the plain version in fp32
   on the same inputs, at a bound tied to bf16 rounding), two launches the
   same bits, timed as in phase 3
   (attention's bound at the bf16 tensor-core peak over the unmasked
   pairs; the SSD scan's at split TF32's 165 TFLOP/s with C B^T counted
   once per group) with one ``scaled_dot_product_attention`` call as
   attention's yardstick.
12. temporal models at the static streams' scale, data sampled on the
   card (B = 2^14 sequences x T = 64 frames, F = 10, S = 4):
   ``clg_seq_suffstats`` at the HMM's (D = 1) and the AR-HMM's (D = 2)
   M-step shapes against its plain version, one launch a call, twice the
   same bits, timed as in phase 3; ``HiddenMarkovModel``,
   ``AutoRegressiveHMM`` and ``InputOutputHMM`` ``update_model(sweeps=5,
   tol=0.0)`` on ``"einsum"`` and ``"cuda"`` in turns (einsum, cuda, cuda,
   einsum; one launch a sweep on cuda, none on einsum; ELBOs within
   1e-4 (1 + |e|), state means within 1e-3 (1 + max|m|)) with
   sequences/s, frames/s, peak memory and a profiled sweep per backend;
   ``FactorialHMMModel`` (C = 2, S = 3; C launches a sweep) with its cuda
   fit held against the plain sweeps in float64; ``seq_stream_fit`` over 8
   batches whose emission means move at batch 4 on both backends (first
   flag at or after it, none before, the same flags); ``PGMQueryEngine(
   mode="temporal")`` answering 1024 filter and 1024 predict (h = 4)
   queries of T = 64 a flush, 4 flushes (cached plans after the first,
   results against ``filtered_posterior`` / ``predictive`` at 1e-5);
   ``KalmanFilter`` (L = 4) and ``SwitchingLDS`` (S = 2, L = 4) at full
   size with a profiled sweep, and the CPU's fit of the first 1024
   sequences against the card's (A, C, q, r within 1e-3 (1 + max|cpu|)).
   Its ``clg_seq_suffstats`` launches count in ``clg_suffstats``'s row.
13. approximate inference: ``svi_step`` x 8 on the main path's 2^20-instance
   chunks of gmm_large, nb_mixed and fa_plate (n_total = 8 x 2^20) on
   ``"cuda"`` (one suff-stats launch of each of the workload's kernels a
   step) and ``"einsum"``, posterior means within 1e-3 (1 + max|m|), with
   instances/s and a profiled step; ``ImportanceSampling`` with 2^20
   particles on chain12 and discrete32 (the serving schemas), each table
   within 5 sqrt(p (1 - p) / ESS) + 1e-3 of the exact engine (plain
   backend), the sampler with its log-weights zeroed failing that bar on
   chain12 given an informative X00; ``PGMQueryEngine(mode="importance",
   n_samples=10_000)`` answering 256 queries a flush, a second engine
   with the same seed giving the same bits; ``map_inference`` on
   discrete32 given D10, D25, D30 (2^14 starts, 20 passes), the card's
   climb against the CPU's from the same starts, and on
   ``random_discrete_bn(12, card=3)`` against enumeration on the card;
   ``LDA`` on a corpus of the UCI NIPS corpus's shape drawn on the card
   (D = 1500, V = 12419, 1.9M tokens, T = 50): 5 ``update_model`` sweeps,
   ``svi_step`` on 250-document minibatches, the card's E-step against
   the CPU's on 64 documents (rtol 1e-4), the bound finite; 2^16 rows of
   gmm_large through ``save_arff`` / ``load_arff`` (equal arrays) and one
   ``GaussianMixture.update_model`` on the card from the file.  Its
   ``svi_step`` and ARFF-fit launches count in the suff-stats rows.

14. d-VMP: one NCCL rank on the card (``init_process_group`` over a
   ``FileStore``, a ``("data",)`` ``DeviceMesh``): ``Model.update_model(
   batch, sweeps=5, tol=0.0, mesh=)`` on one 2^20-instance chunk of
   gmm_large, nb_mixed and fa_plate, with and without the mesh in turns
   (plain, mesh, mesh, plain): the same bits, one ``all_reduce`` a sweep,
   the same kernel launches; instances/s and a profiled sweep of each (the
   device ops the collective adds, NCCL's device time);
   ``stream_update(mesh=)`` over gmm_large's drifting stream (first flag
   at or after chunk 4, means within 1e-3 (1 + max|m|) of the mesh-free
   loop); ``PGMQueryEngine(mode="vmp", mesh=)`` answering 1024 queries a
   flush for 4 flushes (the mesh-free engine's bits);
   ``ImportanceSampling.run_inference(mesh=)`` on chain12 with 2^20
   particles (the shard seeds' draws, bit for bit; within the MC bar of
   exact) and ``map_inference(mesh=)`` on discrete32 (the shard seed's
   climb).  Then two spawned gloo ranks sharing the card run ``dvmp_fit``
   on gmm_large at N = 2^20: the same bits on both, means within
   1e-3 (1 + max|m|) of the single-rank fit, the kernels launched in the
   shards (its time is not a speed figure).  Its mesh runs' launches
   count in the suff-stats rows.

15. the production tier: gmm_large's drifting stream (``stream_fit``,
   8 x 2^20, sweeps=5, tol=0) at obs levels off, basic, trace and off
   again: the same bits at every level, the event files valid, drift
   events at the switch chunk or the next, the ``kernel_dispatch``
   counts equal to the wrappers' ``LAUNCHES`` deltas, the same device
   ops in a profiled sweep; each level's wall seconds and a sweep's wall
   ms; one sweep under ``torch.profiler`` whose trace names ``moments_tile``;
   a warm discrete32 flush (3 x 1024 queries) at each level, the same
   answers.  ``checkpointed_stream_fit(every=2, on_drift=True)`` (each
   npz write timed), a resume from the snapshot of chunk 4 and
   ``FaultInjector.poison_nan`` on two chunks, each the bits of the
   uninterrupted run (or of never seeing the chunks).  ``AsyncPGMServer``
   on discrete32: 4096 queries at once (``max_batch`` 256) at 1, 2, 2, 1
   replicas, then Poisson arrivals at half the 1-replica rate for 5 s
   (50 ms deadlines, 2 replicas), clean and again with a hot swap to
   ``random_discrete_bn(32, card=4, max_parents=3, seed=1)``, a worker
   crash and a slow flush:
   zero lost tickets, a respawn, every answer the bits of a direct
   ``PGMQueryEngine(pad_pow2=True)`` flush of its recorded bucket on the
   network version that served it; chain12 (``cg_weak_marg``) and
   gmm_large's q(Z | x) (2 replicas) through the server the same way;
   ``launch.serve.main(["--mode", "exact", ...])`` in process.

16. mixtral-8x7b at full width, depth cut to 4 of 32 layers (fp32
   weights, ~5.8 GB a layer), random weights from seed 0: ``forward`` on
   2 prompts of 8192 tokens on ``"cuda"`` (exactly 4 ``flash_attention``
   launches) and ``"einsum"`` (none), argmax >= 90%, ``moe_aux`` on both
   and each layer's dropped (token, k) pairs; each block's attention
   increment on both backends and each launch against its plain version
   on the plain path's activations, the window one kv tile short failing
   both bars; warm tokens/s, peak memory and a profiled forward by range
   (``flash_attention``, routing, dispatch and the expert products);
   ``DecodeEngine`` (4 slots) serving 8 greedy requests of 16 tokens; a
   256-token prompt teacher-forced through ``decode_step`` against the
   ``"cuda"`` forward with a capacity that drops no pair (> 85%; decode at
   T = B drops none), and against the config's forward (printed, with the
   share of pairs it dropped).
17. whisper-medium at full width and depth (24 + 24 layers), random frame
   embeddings [8, 1500, 1024] and prompts [8, 448]: ``forward`` on
   ``"cuda"`` (exactly 72 ``flash_attention`` launches) and ``"einsum"``,
   argmax >= 90%; each block on the plain path's activations (the
   encoder's self-attention, the decoder's and its cross attention:
   increments within one bf16 rounding, each launch against its plain
   version; known-wrong: a causal encoder, the last partial kv tile
   unmasked, the decoder without its causal mask); warm forward times;
   ``init_decode_state(enc_input=)`` (24 launches), 32 greedy
   ``decode_step``s (24 launches each, Sq = 1), their tokens the argmax of
   the same steps on ``"einsum"`` at >= 90%, one more step held launch by
   launch, and 4 profiled steps.  Then ``flash_attention`` at the four
   shapes the two phases launched (whisper's encoder, cross attention in
   prefill and in decode, bf16 and fp32; mixtral's [2, 8192, 32, 128]
   GQA, bf16), timed as in phase 11, each with a known-wrong variant that
   must fail; the bf16 ones are kernel rows ``flash_attention/<where>``
   with their launches at that shape, the fp32 ones rows
   ``flash_attention/fp32_<where>`` (the fp32 forward route, beside one
   SDPA call, each first launched through the entry point with the counts
   set to 0).
18. LM training: granite-3-2b at full width and depth (2.53B fp32
   parameters, trainable, random from seed 0) on batches of 2 x 4096
   (train_4k's length; its global batch cut to one card's micro-batch)
   streamed by ``TokenStream`` from ``markov_sequence_fast(200_000,
   49155, seed=0)``. One batch's gradients on ``"cuda"`` (80
   ``flash_attention`` launches under remat, 40
   ``flash_attention_backward``) and on ``"einsum"``: every parameter's
   gradient within 0.1 relative L2, each backward launch held against the
   plain backward in fp32 on its own inputs (relative L2 of dq, dk, dv
   within 2^-7) and launched again for the same bits, the known-wrong
   variants (dK / dV on the wrong kv head, delta left out) failing that
   bar, and the route with attention's output detached failing the
   gradient bar. Then 1 + 5 AdamW steps (CUDA events a step: step ms,
   training tokens/s; peak memory; the loss falling), one profiled step
   (idle share; device time of the backward kernels, the forward kernel,
   the matmuls, the optimizer), 3 streaming-VB steps (loss and
   ``posterior_kl`` finite); one AdamW step of mixtral-8x7b cut to 1
   layer (2 x 8192), of whisper-medium (frames [8, 1500, 1024], prompts
   [8, 448]) and of gemma-2b at full width and depth (D = 256, MQA 8/1,
   2 x 4096), each backward launch watched; every backward launch of
   those runs on the bf16 tensor-core route (``flash_attn.ROUTES``).
   Then zamba2-1.2b at full width and depth (random from seed 0, 2 x
   4096): one batch's gradients on ``"cuda"`` (76 ``ssd_scan``, 38
   ``ssd_scan_backward``, 12 and 6 attention launches) and ``"einsum"``
   within 0.1 relative L2, the losses within 1e-2, the median gap within
   twice einsum's own under a 1e-6 relative error of the scan's y (the
   model's amplification of errors of the kernels' size), each SSD backward
   launch held against the plain backward in fp32 on its inputs
   (relative L2 of dx, ddt, dA, dB, dC within 2e-4) and launched again
   for the same bits, its known-wrong variants (dB / dC of one head a
   group, each chunk alone) failing that bar, the route with
   ``ssd_scan``'s outputs detached failing the gradient bar; one AdamW
   step (those launches asserted, each backward watched), a second timed
   with CUDA events and a profiled one (idle share; device time of the
   SSD backward and forward kernels, attention's, the matmuls, the
   optimizer); the same for mamba2-1.3b at full width and depth (96
   ``ssd_scan``, 48 ``ssd_scan_backward`` a step). Then the attention backward
   kernels at granite's, mixtral's, whisper's encoder and cross-attention
   and gemma's shapes, each against the plain backward, twice the same
   bits, timed beside the plain backward, the bound (10 D flops a live
   pair at the bf16 peak) and one ``scaled_dot_product_attention``
   backward: kernel rows ``flash_attention_bwd/<where>`` with their
   launches in the training steps; the fp32 route (split TF32 on the
   tensor cores; causal MQA [2, 2048, 8/1, 256], non-causal GQA [2, 2048,
   8/2, 144], causal GQA [2, 2048, 8/2, 128]), each through
   ``flash_attention`` and autograd once (the gradients the direct
   launch's bits), held to the fp32 bar (1e-5) likewise, its bound at
   split TF32's rate, rows ``flash_attention_bwd/fp32_d256``, ``/fp32_d144``
   and ``/fp32_d128``, and the fp32 forward at those shapes, rows
   ``flash_attention/fp32_d256``, ``/fp32_d144`` and ``/fp32_d128`` (each
   launched once through the entry point, beside one SDPA call; the
   bound its 4 D flops a live pair at split TF32's rate); and
   ``ssd_scan_backward`` at
   zamba2's and mamba2's training calls, likewise (the bound: the
   function's multiply-adds at split TF32's rate, or the bytes), each
   backward kernel's device ms logged by name: rows
   ``ssd_scan_bwd/zamba2`` and ``ssd_scan_bwd/mamba2``.
19. the LM mesh paths (``repro_torch.sharding``, ``Shardings``): (a) one
   NCCL rank over a ``FileStore`` and its ("data", "model") 1 x 1 mesh:
   zamba2-1.2b at full width and depth, ``forward(sh=)`` of the 2 x 8192
   prefill (38 ``ssd_scan``, 6 ``flash_attention``), 16 ``decode_step(
   sh=)`` past a ring of 8 slots and ``DecodeEngine(sh=)``; mixtral-8x7b
   (4 of 32 layers) through ``forward(sh=)`` with expert parallelism; one
   granite-3-2b AdamW step and one VB step at full width and depth
   (``train_step(sh=)`` / ``vb_train_step(sh=)`` from
   ``sharding.init_sharded``): each the mesh-free run's bits (the loss and
   every updated weight); (b) two spawned gloo ranks sharing the card
   (their time is not a speed figure), full width, reduced depth, 2 x
   2048: zamba2 (6 layers) at model = 2, its prefill and 16 decode steps
   past a ring of 8 slots (4 a rank), ``ssd_scan`` and
   ``flash_attention`` at the rank's heads against their plain versions;
   mixtral (2 layers) at model = 2, experts split; granite (4 layers) at
   model = 2 and at data = 2, one AdamW step; each against the one-rank
   mesh-free run on the same global inputs: argmax >= 90% (phase 16's
   bar), the logits within 2^-5 relative L2 at >= 95% of positions,
   each gradient within 0.1 relative L2, the loss within 1e-3 relative,
   the ranks the same bits where the specs replicate.

The stage splits of phases 3, 7 and 12 time the call with CUDA events just
before each profiled trace and hold the stages to that time, three
attempts in all.

Prints the kernel line ``{"kernels": [...]}`` (launch counts from the main
paths' runs) and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

N = 1 << 20            # instances per chunk and per kernel call
WIDE_N = 1 << 18       # instances of the wide-row clg_suffstats_latent call
T_CHUNKS = 8           # chunks per stream
SWITCH = 4             # the generator changes at this chunk
SWEEPS = 5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
SPLIT_TF32_OPS_PER_S = 495e12 / 3   # fp32-accurate products on the tensor
                               # cores: three TF32 passes (a_hi b_hi +
                               # a_hi b_lo + a_lo b_hi) at 495 TFLOP/s
KERNEL_RTOL, KERNEL_ATOL_REL = 1e-4, 1e-5   # atol = 1e-5 * max|plain|
FIT_TOL_REL = 1e-3             # |m_cuda - m_einsum| <= 1e-3 * (1 + max|m|)
Z_ATOL = 1e-2                  # posterior_z after the cuda and einsum
                               # fits (float32 sum order over ~40 sweeps)
SOURCE = "src/repro_torch/kernels/csrc/clg_stats.cu"
FACTOR_SOURCE = "src/repro_torch/kernels/csrc/factor_ops.cu"
FC_SOURCE = "src/repro_torch/kernels/csrc/family_counts.cu"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attn.cu"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
REPLACES = {"clg_suffstats": "src/repro/kernels/clg_stats.py:108",
            "clg_suffstats_latent": "src/repro/kernels/clg_stats.py:215",
            "clg_disc_counts": "src/repro/kernels/clg_stats.py:289",
            "log_product": "src/repro/kernels/factor_ops.py:60",
            "log_marginalize": "src/repro/kernels/factor_ops.py:114",
            "evidence_select": "src/repro/kernels/factor_ops.py:154",
            "cg_weak_marg": "src/repro/kernels/factor_ops.py:222",
            "family_counts": "src/repro/kernels/family_counts.py:85",
            "flash_attention": "src/repro/kernels/flash_attn.py:117",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:111"}
SERVE_B = 1024         # queries per evidence schema per flush
SERVE_FLUSHES = 4
POST_ATOL = 1e-5       # exact posteriors, cuda vs plain backend
LOGZ_TOL_REL = 1e-4    # |logZ_cuda - logZ_plain| <= 1e-4 (1 + |logZ|)
MOMENT_TOL_REL = 1e-4  # posterior means/variances: 1e-4 (1 + |plain|)
EXACT_VS_VMP_ATOL = 1e-3   # posterior_exact vs posterior_z (point estimate
                           # vs VMP's expected log-likelihoods)
LSE_TOL = 1e-5         # log_marginalize, cg_weak_marg's mass: 1e-5 (1+|x|)
WEAK_ATOL, WEAK_RTOL = 1e-5, 1e-4   # cg_weak_marg's mean and covariance
STRUCT_N = 1 << 20     # instances per structure-learning batch
STREAM_N, STREAM_BATCH, STREAM_WINDOW = 1 << 21, 1 << 16, 1 << 18
CLG_SCORE_TOL_REL = 1e-6   # CLG search score, cuda vs einsum: float64
                           # sums of float32 chunk moments vs float64 ones
FC_RTOL = 1e-5         # family_counts with float weights vs plain
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
LM_ARCH = "zamba2-1.2b"        # full width and depth, random weights
LM_B, LM_S = 2, 8192   # prefill_32k (S 32768, batch 32) cut to one card
LM_ARGMAX_MIN = 0.90   # cuda vs einsum prefill: same argmax at >= 90%
                       # of positions at full depth: 44 bf16 blocks of
                       # random weights carry any fp32-level difference
                       # into the bf16 residual stream: the plain path
                       # with another SSD chunk agrees with itself no
                       # better (printed beside it; PERF.md, Findings);
                       # the increments and the kernels on the path's
                       # activations are held tightly (_increment_check)
INC_REL_MAX = 2.0 ** -8        # a block's increment, same input to both
                               # backends: mean |d| / mean |inc| within
                               # one bf16 rounding
SERVE_SLOTS, SERVE_CAPACITY = 4, 256
SERVE_REQUESTS, SERVE_NEW = 8, 32
DECODE_S = 256         # teacher-forced decode vs the cuda forward
DECODE_ARGMAX_MIN = 0.85       # the JAX package's bar
ATTN_F32_TOL = 2e-5    # fp32 flash_attention vs plain: rtol and atol
BF16_REL, BF16_MEAN = 2.0 ** -7, 2.0 ** -8   # bf16 flash_attention vs the
                       # plain version in fp32 on the same inputs:
                       # |d| <= 2^-7 |exp| + 2^-8 mean |exp| (the output's
                       # bf16 rounding is at most 2^-8 |exp|)
SSD_RTOL = 2e-4        # ssd_scan vs plain: rtol, and atol * max|plain|
LM_KERNEL_NAMES = ("flash_attn_", "ssd_scan_")   # the two LM wrappers'
                       # CUDA kernels, by the start of their names
MOE_ARCH = "mixtral-8x7b"      # full width, random weights
MOE_LAYERS = 4         # of its 32: the port holds weights in fp32, ~5.8 GB
                       # a layer, so 32 layers would not fit 80 GB
MOE_B, MOE_S = 2, 8192 # prefill_32k cut to one card: T = 16384 tokens, 5120
                       # slots an expert, the 4096 window active
MOE_SERVE_NEW = 16     # DecodeEngine: SERVE_REQUESTS greedy requests of 16
AUDIO_ARCH = "whisper-medium"  # full width and depth, random weights
AUDIO_B, AUDIO_S = 8, 448      # decoder prompts: whisper's text context
AUDIO_STEPS = 32       # greedy decode steps after init_decode_state
AUDIO_CAPACITY = 64    # their KV budget
TEMPORAL_B, TEMPORAL_T = 1 << 14, 64   # sequences x frames: 2^20 frames a
                       # batch, the static streams' scale
TEMPORAL_F, TEMPORAL_S = 10, 4         # gmm_large's widths
FHMM_C, FHMM_S = 2, 3  # factorial HMM: chains, states a chain
LDS_L, SLDS_S = 4, 2   # hidden dims (Kalman filter, switching LDS), switch
                       # states
TEMPORAL_SHIFT = 6.0   # seq_stream_fit: emission means move at SWITCH
TEMPORAL_QUERIES, TEMPORAL_H = 1024, 4   # filter and predict queries a
                       # flush, the predictive horizon
TEMPORAL_ELBO_REL = 1e-4   # |e_cuda - e_einsum| <= 1e-4 (1 + |e|)
LDS_CPU_B = 1024       # sequences of the CPU-vs-card LDS / SLDS fit
LDS_TOL_REL = 1e-3     # A, C, q, r: CPU vs card, |d| <= 1e-3 (1 + max|cpu|)
SVI_STEPS = 8          # svi_steps on the main path's 2^20-instance chunks
IS_PARTICLES = 1 << 20         # likelihood-weighting particles a run
IS_SIGMAS, IS_ATOL = 5.0, 1e-3   # |p_is - p_exact| <= 5 sqrt(p(1-p)/ESS)
                               # + 1e-3
IS_SERVE_N, IS_QUERIES = 10_000, 256   # importance serving: samples a
                               # query, queries a flush
MAP_STARTS, MAP_PASSES = 1 << 14, 20
MAP_SMALL_STARTS = 1024        # the enumeration check's starts
MAP_TOL_REL = 1e-4     # MAP log-probs: 1e-4 (1 + |lp|)
LDA_D, LDA_V, LDA_LEN = 1500, 12419, 1267   # UCI Bag of Words "NIPS full
                       # papers": D = 1500, W = 12419, ~1.9M tokens
LDA_T, LDA_ALPHA, LDA_ETA = 50, 0.3, 0.1
LDA_SWEEPS, LDA_SVI_DOCS = 5, 250
LDA_CPU_DOCS, LDA_RTOL = 64, 1e-4   # the E-step, card vs CPU
ARFF_ROWS = 1 << 16
DVMP_QUERIES, DVMP_FLUSHES = 1024, 4   # vmp serving over the mesh
DVMP_RANK_TIMEOUT_S = 300      # the two spawned ranks, start to finish
DVMP_RANKS_TOL_REL = 1e-5      # two ranks vs one: |m - m_1| <= 1e-5 (1 + max|m|)
DVMP_RANKS_ELBO_RTOL = 1e-6    # and |elbo - elbo_1| <= 1e-6 |elbo_1|
DRYRUN_N = 1 << 16             # launch.dryrun_pgm: fits at N and 4N
ASYNC_CLOSED = 4096    # closed loop: queries submitted at once, discrete32
ASYNC_MAX_BATCH = 256  # the server's size trigger
ASYNC_DELAY_MS = 5.0   # its coalescing window
ASYNC_OPEN_S = 5.0     # open loop: Poisson arrivals for this long
ASYNC_DEADLINE_MS = 50.0       # each open-loop request's deadline
CHAIN_ASYNC = 1024     # chain12 queries submitted at once
VMP_ASYNC = 4096       # gmm_large's q(Z | x) queries submitted at once
FA_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attn_bwd.cu"
TRAIN_ARCH = "granite-3-2b"    # full width and depth, random weights
TRAIN_B, TRAIN_S = 2, 4096     # train_4k (S 4096, global batch 256) cut to
                               # one card's micro-batch of 2
TRAIN_CORPUS = 200_000         # markov_sequence_fast tokens (launch.train's)
TRAIN_WARM, TRAIN_TIMED = 1, 5 # AdamW steps: warm-up, then timed
TRAIN_LR = 5e-4                # AdamW: cosine_schedule(TRAIN_LR, 1, 100)
VB_STEPS, VB_LR = 3, 0.1       # streaming-VB steps (the reference's lr)
TRAIN_MOE_LAYERS = 1           # mixtral's training step: 1 of 32 layers
TRAIN_GEMMA_ARCH = "gemma-2b"  # one AdamW step at full width and depth
TRAIN_GEMMA_B, TRAIN_GEMMA_S = 2, 4096   # train_4k's length, one card's
                               # micro-batch of 2 (as granite's)
GRAD_ROUTE_REL = 0.1           # each parameter's gradient on one batch,
                               # "cuda" vs "einsum": relative L2 (the routes
                               # round attention's weights to bf16 at other
                               # places, through 40 blocks)
SSM_NOISE_REL = 1e-6           # zamba2's route gradients are read against
SSM_NOISE_MEDIANS = 2.0        # einsum's own with ssd_chunked's y times
                               # (1 + SSM_NOISE_REL r): the median gap over
                               # the parameters within this many times the
                               # median of that self-gap
BWD_BF16_REL, BWD_F32_REL = 2.0 ** -7, 1e-5   # a backward launch against
                               # the plain backward in fp32 on its inputs:
                               # relative L2 of dq, dk and dv (bf16 outputs
                               # round at ~2^-9 relative)
BWD_F32_CASES = {             # the fp32 backward's kernels (split TF32):
    "fp32_d256": ((2, 2048, 8, 256), (2, 2048, 1, 256), True),   # causal MQA
    "fp32_d144": ((2, 2048, 8, 144), (2, 2048, 2, 144), False),  # GQA 8/2
    "fp32_d128": ((2, 2048, 8, 128), (2, 2048, 2, 128), True),   # causal GQA
}
SSD_BWD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
TRAIN_SSM = {"zamba2": "zamba2-1.2b", "mamba2": "mamba2-1.3b"}   # one
                               # AdamW step each at full width and depth,
                               # TRAIN_B x TRAIN_S (train_4k's length)
SSD_BWD_REL = 2e-4             # an ssd_scan_backward launch against the
                               # plain backward in fp32 on its inputs:
                               # relative L2 of dx, ddt, dA, dB and dC
                               # (split-TF32 products keep ~20 bits; dA sums
                               # b S terms of both signs)
MESH_DECODE_STEPS = 16         # phase 19: decode steps past a ring wrap
MESH_DECODE_CAP = 8            # their KV budget: two wraps (4 slots a rank
                               # on model = 2)
MESH_S = 2048                  # two gloo ranks: prompts of LM_B x MESH_S
MESH_ZAMBA_LAYERS, MESH_MOE_LAYERS, MESH_TRAIN_LAYERS = 6, 2, 4   # their
                               # depth cuts (zamba2: one shared block)
MESH_LOGIT_REL = 2.0 ** -5     # two ranks vs one: logits relative L2 (bf16
                               # partial sums over model; 1e-2 on the CPU)
MESH_WITHIN_MIN = 0.95         # at >= 95% of the positions
MESH_LOSS_RTOL = 1e-3          # and the loss
MESH_RANK_TIMEOUT_S = 600      # the two spawned ranks, start to finish
MESH_SEQ_RANKS = 3             # phase 19 (c): gloo ranks sharing the card
                               # at model = 3, which gemma-2b's 8 q heads do
                               # not divide (the seq-shard route, as its
                               # heads take it at the reference's model = 16)
MESH_SEQ_LAYERS = 4            # of gemma-2b's 18, at full width: at model =
                               # 3 every weight is replicated (8 heads, d_ff
                               # 16384 and the vocab of 256000 divide by no
                               # 3), so a rank holds fp32 weights, gradients,
                               # AdamW moments and AdamW's temporaries of the
                               # 2.1 GB embedding, ~23 GB; the ranks' caching
                               # allocators expand segments so that three fit
                               # 80 GB
MESH_SEQ_B, MESH_SEQ_S = 1, 1536   # 512 positions a rank; [B, S, 256000]
                               # fp32 logits beside the weights
DRYRUN_TIMEOUT_S = 300         # phase 20: the dry run's command


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_per_s
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def compare(got, exp):
    """Max abs error; raises if outside the stated tolerance."""
    import torch

    err = 0.0
    for g, e in zip(got, exp):
        scale = float(e.abs().max())
        torch.testing.assert_close(g, e, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL_REL * scale)
        err = max(err, float((g - e).abs().max()))
    return err


def _stage_ms(fn, stages, b_ms, calls=5, tries=3):
    """Device ms a call of ``fn`` in each stage of ``stages`` ({label: name
    fragments}; a call launches one kernel a stage), from torch.profiler
    over ``calls`` warm calls: a stage's busy time over the number of its
    kernels the profiler recorded.  An attempt times the call with CUDA
    events (``time_ms``) just before its trace, so the two are taken
    together; it fails when the trace holds another number than ``calls``
    of a stage's kernels, or when the stages add up to more than 1.05 x that
    call's time or to less than ``b_ms`` (the least time the card could
    take).  ``tries`` attempts, then raises."""
    import torch

    fn()
    torch.cuda.synchronize()
    frags = tuple(f for fs in stages.values() for f in fs)
    of = lambda d, fs: sum(v for name, v in d.items()
                           if any(f in name for f in fs))
    def run():
        # late in a long process the first kernels of a trace can go
        # missing from it: the trace opens with small kernels and a wait
        # on the card, then the calls
        x = torch.zeros(1, device="cuda")
        for _ in range(16):
            x.add_(1)
        torch.cuda._sleep(10 ** 7)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    failed = None
    for _ in range(tries):
        ms = time_ms(fn)
        us, n = {}, {}
        _profiled(run, frags, us, n)
        count = {label: of(n, fs) for label, fs in stages.items()}
        if not all(c == calls for c in count.values()):
            failed = (f"the profiler recorded {count} stage kernels of "
                      f"{calls} calls")
            continue
        split = {label: of(us, fs) / count[label] / 1e3
                 for label, fs in stages.items()}
        total = sum(split.values())
        if b_ms <= total <= 1.05 * ms:
            return split
        failed = (f"stages {split} add up to {total:.4f} ms, outside [bound "
                  f"{b_ms:.4f}, 1.05 x the call's {ms:.4f}] ms")
    raise AssertionError(f"{failed}, in each of {tries} attempts (a call "
                         f"timed just before each trace)")


CLG_STAGES = {"stage 1": ("moments_tile", "moments_rows"),
              "stage 2": ("moments_reduce",)}
LATENT_STAGES = {"stage 1": ("latent_tile", "latent_rows"),
                 "stage 2": ("latent_reduce",)}
DISC_STAGES = {"stage 1": ("disc_tile",), "stage 2": ("disc_reduce",)}


def clg_suffstats_check(label, d, y, r, chunk=None):
    """``clg_suffstats`` (or, with ``chunk``, ``clg_suffstats_chunks``)
    against its plain version on (d, y, r), twice for bitwise
    repeatability, timed beside the plain version, the one-call library
    yardstick ``einsum("nfa,nfb,nk->fkab")`` over u = [d, y], and the least
    time the card could take; stage 1 and stage 2 profiled apart.  Returns
    the kernel row's numbers."""
    import torch

    from repro_torch.kernels import clg_stats, ref

    (n, F, D), K = d.shape, r.shape[1]
    if chunk is None:
        kern = lambda: clg_stats.clg_suffstats(d, y, r)
        plain = lambda: ref.clg_suffstats_ref(d, y, r)
        u = torch.cat([d, y[..., None]], -1)
        library = lambda: torch.einsum("nfa,nfb,nk->fkab", u, u, r)
        n_chunks = 1
    else:
        kern = lambda: clg_stats.clg_suffstats_chunks(d, y, r, chunk)
        sls = [slice(i, i + chunk) for i in range(0, n, chunk)]
        plain = lambda: [torch.stack(t) for t in zip(*(
            ref.clg_suffstats_ref(d[sl], y[sl], r[sl]) for sl in sls))]
        n_chunks = len(sls)
        library = u = None
        if n % chunk == 0:                 # equal chunks: one einsum
            u = torch.cat([d, y[..., None]], -1).view(n_chunks, chunk, F,
                                                      D + 1)
            rc = r.view(n_chunks, chunk, K)
            library = lambda: torch.einsum("cnfa,cnfb,cnk->cfkab", u, u, rc)
    got, again = kern(), kern()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        # which outputs differ, by how much, and which launch a third one
        # sides with
        third = kern()
        torch.cuda.synchronize()
        how = "; ".join(
            f"{nm}: {int((a != b).sum())} of {a.numel()} entries, max |diff| "
            f"{float((a - b).abs().max())}, third == first "
            f"{torch.equal(a, c)}, third == second {torch.equal(b, c)}"
            for nm, a, b, c in zip(("sxx", "sxy", "syy"), got, again, third))
        raise AssertionError(f"clg_suffstats at {label}: two launches differ "
                             f"in bits ({how})")
    err = compare(got, plain())
    b_ms, b_by = bound(4 * (n * (F * D + F + K)
                            + n_chunks * F * K * (D * D + D + 1)),
                       n * F * K * 3 * (D * D + D + 1))
    few = dict(iters=3, warmup=1) if chunk else {}
    ms, plain_ms = time_ms(kern), time_ms(plain, **few)
    library_ms = None if library is None else time_ms(library, **few)
    del u
    versus = ("no library call (ragged chunks)" if library_ms is None else
              f"{'LOSES to' if ms > library_ms else 'beats'} the library "
              f"call")
    split = _stage_ms(kern, CLG_STAGES, b_ms)
    plan = clg_stats.moments_plan(min(n, chunk or n), F, D, K,
                                  clg_stats.sm_count(d.device))
    log(f"kernel clg_suffstats{'_chunks' if chunk else ''} at {label} "
        f"(d {tuple(d.shape)}, r {tuple(r.shape)}"
        f"{f', chunk {chunk}' if chunk else ''}): max_abs_err {err:.3e} "
        f"(rtol {KERNEL_RTOL}, atol {KERNEL_ATOL_REL}*max|plain|), bitwise "
        f"repeatable; ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{'none' if library_ms is None else f'{library_ms:.4f}'} bound_ms "
        f"{b_ms:.4f} ({b_by}); a call (profiled, each stage's kernels "
        f"counted): stage 1 {split['stage 1']:.4f} ms, stage 2 "
        f"{split['stage 2']:.4f} ms; {versus}; plan {plan}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def clg_latent_check(label, obs, hm, y, r, shh):
    """``clg_suffstats_latent`` against its plain version on (obs, hm, y, r,
    shh), twice for bitwise repeatability, timed beside the plain version
    and the least time the card could take; stage 1 and stage 2 profiled
    apart (one kernel of each a call, counted).  Returns the kernel row's
    numbers."""
    import torch

    from repro_torch.kernels import clg_stats, ref

    (n, F, Do), (K, L) = obs.shape, hm.shape[1:]
    D = Do + L
    kern = lambda: clg_stats.clg_suffstats_latent(obs, hm, y, r, shh)
    plain = lambda: ref.clg_suffstats_latent_ref(obs, hm, y, r, shh)
    before = clg_stats.LAUNCHES["clg_suffstats_latent"]
    got, again = kern(), kern()
    torch.cuda.synchronize()
    per_call = (clg_stats.LAUNCHES["clg_suffstats_latent"] - before) / 2
    if per_call != 1:
        raise AssertionError(f"clg_suffstats_latent at {label}: {per_call} "
                             f"launches a call")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"clg_suffstats_latent at {label}: two launches "
                             f"differ in bits")
    err = compare(got, plain())
    # the work the function needs: each (leaf, component) the observed rows
    # of sxx's upper triangle, sxy and syy; each component the latent rows
    # (the same for every leaf) and rsum_k; ~3 operations an entry
    leaf = Do * D - Do * (Do - 1) // 2 + D + 1
    latent = L * (L + 1) // 2 + 1
    b_ms, b_by = bound(4 * (n * (F * Do + K * L + F + K) + K * L * L
                            + F * K * (D * D + D + 1)),
                       n * 3 * (F * K * leaf + K * latent))
    ms, plain_ms = time_ms(kern), time_ms(plain, iters=5, warmup=1)
    split = _stage_ms(kern, LATENT_STAGES, b_ms)
    plan = clg_stats.latent_plan(n, F, Do, L, K,
                                 clg_stats.sm_count(obs.device))
    log(f"kernel clg_suffstats_latent at {label} (obs {tuple(obs.shape)}, "
        f"h_mean {tuple(hm.shape)}, r {tuple(r.shape)}): max_abs_err "
        f"{err:.3e} (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL_REL}*max|plain|), "
        f"bitwise repeatable; ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms none bound_ms {b_ms:.4f} ({b_by}); {per_call:.0f} "
        f"launch a call; a call (profiled, one kernel a stage counted): "
        f"stage 1 {split['stage 1']:.4f} ms, stage 2 {split['stage 2']:.4f} "
        f"ms; plan {plan}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def disc_counts_check(label, xd, r, C):
    """``clg_disc_counts`` against its plain version on (xd, r), twice for
    bitwise repeatability and one launch a call, timed beside the plain
    version and the least time the card could take; stage 1 and stage 2
    profiled apart.  Returns the kernel row's numbers."""
    import torch

    from repro_torch.kernels import clg_stats, ref

    (n, Fd), K = xd.shape, r.shape[1]
    kern = lambda: [clg_stats.clg_disc_counts(xd, r, C)]
    plain = lambda: [ref.clg_disc_counts_ref(xd, r, C)]
    before = clg_stats.LAUNCHES["clg_disc_counts"]
    got, again = kern(), kern()
    torch.cuda.synchronize()
    if clg_stats.LAUNCHES["clg_disc_counts"] - before != 2:
        raise AssertionError(f"clg_disc_counts at {label}: not one launch a "
                             f"call")
    if not torch.equal(got[0], again[0]):
        raise AssertionError(f"clg_disc_counts at {label}: two launches "
                             f"differ in bits")
    err = compare(got, plain())
    # one add an (instance, leaf, component): the bin x matches
    b_ms, b_by = bound(4 * (n * (Fd + K) + Fd * K * C), n * Fd * K)
    few = dict(iters=3, warmup=1) if Fd * K * C > 1000 else {}
    ms, plain_ms = time_ms(kern), time_ms(plain, **few)
    split = _stage_ms(kern, DISC_STAGES, b_ms)
    p = clg_stats.disc_plan(n, Fd, K, C, clg_stats.sm_count(xd.device))
    log(f"kernel clg_disc_counts at {label} (xd {tuple(xd.shape)}, r "
        f"{tuple(r.shape)}, C = {C}): max_abs_err {err:.3e} (rtol "
        f"{KERNEL_RTOL}, atol {KERNEL_ATOL_REL}*max|plain|), bitwise "
        f"repeatable, one launch a call; ms {ms:.5f} plain_ms "
        f"{plain_ms:.4f} library_ms none bound_ms {b_ms:.5f} ({b_by}); "
        f"device a call (profiled, one kernel a stage counted): stage 1 "
        f"{split['stage 1']:.5f} ms, stage 2 {split['stage 2']:.5f} ms, "
        f"{sum(split.values()):.5f} in all; compare-selects a call "
        f"{n * Fd * p.n_kg * p.KG * p.n_cb * p.CB}; plan {p}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def kernel_phase(dev):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch

    from repro_torch.configs.amidst_pgm import PGM_WORKLOADS
    from repro_torch.core.vmp import layout_of

    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    rows = {}

    # clg_suffstats at gmm_large: d [N, F, 1], y [N, F], r [N, K]
    lay = layout_of(PGM_WORKLOADS["gmm_large"].spec)
    F, K, D = lay.F, lay.K, lay.D
    d, y = randn(N, F, D), randn(N, F)
    r = torch.softmax(randn(N, K), -1)
    rows["clg_suffstats"] = dict(
        name="clg_suffstats", route="cuda", source=SOURCE,
        replaces=REPLACES["clg_suffstats"], launches=0,
        **clg_suffstats_check("streaming (gmm_large)", d, y, r))

    # clg_suffstats_latent at fa_plate: obs [N, F, 1], h_mean [N, K, L]
    lay = layout_of(PGM_WORKLOADS["fa_plate"].spec)
    F, K, L, Do = lay.F, lay.K, lay.L, 1 + lay.P
    D = Do + L
    obs, y = randn(N, F, Do), randn(N, F)
    hm, r = randn(N, K, L), torch.softmax(randn(N, K), -1)
    a = 0.3 * randn(K, L, L)
    shh = a @ a.transpose(-1, -2) + torch.eye(L, device=dev)
    rows["clg_suffstats_latent"] = dict(
        name="clg_suffstats_latent", route="cuda", source=SOURCE,
        replaces=REPLACES["clg_suffstats_latent"], launches=0,
        **clg_latent_check("streaming (fa_plate)", obs, hm, y, r, shh))
    # a wide row, which the shared-memory tile kernel it replaced split by
    # leaves
    n, F, K = WIDE_N, 300, 2
    obs, y = randn(n, F, Do), randn(n, F)
    hm, r = randn(n, K, L), torch.softmax(randn(n, K), -1)
    a = 0.3 * randn(K, L, L)
    shh = a @ a.transpose(-1, -2) + torch.eye(L, device=dev)
    clg_latent_check("a wide row (F = 300, K = 2)", obs, hm, y, r, shh)
    # D > 8: the per-leaf latent model's L = F (CustomGlobalLocalModel)
    n, F, K, L = WIDE_N, 16, 1, 16
    obs, y = randn(n, F, Do), randn(n, F)
    hm, r = randn(n, K, L), torch.softmax(randn(n, K), -1)
    a = 0.3 * randn(K, L, L)
    shh = a @ a.transpose(-1, -2) + torch.eye(L, device=dev)
    clg_latent_check("row blocks (F = L = 16, K = 1: D = 17)", obs, hm, y,
                     r, shh)
    del obs, y, hm, r

    # clg_disc_counts at nb_mixed: xd [N, Fd] int32, r [N, K], C
    lay = layout_of(PGM_WORKLOADS["nb_mixed"].spec)
    Fd, K, C = lay.Fd, lay.K, lay.C
    xd = torch.randint(0, C, (N, Fd), generator=g, device=dev,
                       dtype=torch.int32)
    r = torch.softmax(randn(N, K), -1)
    rows["clg_disc_counts"] = dict(
        name="clg_disc_counts", route="cuda", source=SOURCE,
        replaces=REPLACES["clg_disc_counts"], launches=0,
        **disc_counts_check("streaming (nb_mixed)", xd, r, C))
    # a wide row, which the shared-memory tile kernel it replaced refused
    n, Fd, K, C = WIDE_N, 400, 4, 8
    xd = torch.randint(-1, C + 1, (n, Fd), generator=g, device=dev,
                       dtype=torch.int32)
    r = torch.softmax(randn(n, K), -1)
    disc_counts_check("a wide row (Fd = 400, K = 4, C = 8)", xd, r, C)
    del xd, r
    return rows


# -- drifting streams of the three workloads ---------------------------------


def _gmm(n, seed):
    from repro_torch.data import synthetic as syn

    s, _, _ = syn.gmm_stream(n, 4, 10, seed=seed)
    b = s.collect()
    return s.attributes, b.xc, b.xd


def _nb(n, seed):
    from repro_torch.data import synthetic as syn

    s, _ = syn.nb_stream(n, 3, 10, 2, card=4, seed=seed)
    b = s.collect()
    return s.attributes[:-1], b.xc, b.xd[:, :-1]   # the class is hidden


def _fa(n, seed):
    from repro_torch.data import synthetic as syn

    s, _ = syn.fa_stream(n, 16, 4, seed=seed)
    b = s.collect()
    return s.attributes, b.xc, b.xd


def drifting_stream(make, n, t_chunks, switch):
    """t_chunks chunks of n instances; chunks >= switch come from another
    seed of the generator (new means: a concept drift)."""
    from repro_torch.data.stream import DataStream

    phases = [make(switch * n, 1), make((t_chunks - switch) * n, 2)]

    def src():
        for _, xc, xd in phases:
            for i in range(0, xc.shape[0], n):
                yield xc[i:i + n], xd[i:i + n]

    return DataStream(phases[0][0], src, n_instances=t_chunks * n)


def main_path_phase(card):
    """The three workloads through the public API; returns the launch
    counts of their cuda-backend runs and, by workload, (the cuda-fitted
    model, its queries, their posterior_z, the stream)."""
    import torch

    from repro_torch.configs.amidst_pgm import PGM_WORKLOADS
    from repro_torch.core.streaming import tree_finite, tree_leaves
    from repro_torch.kernels import clg_stats
    from repro_torch.pgm_models import (FactorAnalysis, GaussianMixture,
                                        NaiveBayes)

    cases = [
        # (workload, data, model, kernels it must launch, drift expected)
        ("gmm_large", _gmm,
         lambda a, backend: GaussianMixture(a, n_states=4, backend=backend),
         ("clg_suffstats",), True),
        ("nb_mixed", _nb,
         lambda a, backend: NaiveBayes(a, n_states=3, backend=backend),
         ("clg_suffstats", "clg_disc_counts"), True),
        ("fa_plate", _fa,
         lambda a, backend: FactorAnalysis(a, n_hidden=4, backend=backend),
         ("clg_suffstats_latent",), False),
    ]

    def fit(name, build, attrs, stream, queries, backend):
        model = build(attrs, backend=backend)
        if model.spec != PGM_WORKLOADS[name].spec:
            raise AssertionError(f"{name}: spec {model.spec} differs from "
                                 f"the config's")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        clg_stats.reset_launches()           # counts of this run only
        t0 = time.perf_counter()
        e = model.update_model(stream, sweeps=SWEEPS, tol=0.0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        z = model.posterior_z(queries)
        torch.cuda.synchronize()
        info = model.last_stream_info
        return dict(model=model, elbo=e, seconds=secs, z=z,
                    inst_per_s=T_CHUNKS * N / secs,
                    launches=dict(clg_stats.LAUNCHES),
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                    drifted=[bool(x) for x in info["drifted"].tolist()],
                    sweeps=info["sweeps"].tolist())

    total = dict.fromkeys(clg_stats.LAUNCHES, 0)
    fitted = {}
    for name, make, build, kernels, drifts in cases:
        # warm-up of both backends on a small stream (library handles,
        # allocator, first launches), outside every timed and counted run
        small = drifting_stream(make, 4096, 2, 1)
        for backend in ("cuda", "einsum"):
            build(small.attributes, backend).update_model(small, sweeps=1,
                                                          tol=0.0)
        stream = drifting_stream(make, N, T_CHUNKS, SWITCH)
        attrs = stream.attributes
        _, qx, qd = make(N, 2)              # queries from the new regime
        queries = _batch(qx, qd)
        # in turns: einsum, cuda, cuda, einsum
        runs = {"cuda": [], "einsum": []}
        for backend in ("einsum", "cuda", "cuda", "einsum"):
            runs[backend].append(fit(name, build, attrs, stream, queries,
                                     backend))
        cu, ei = runs["cuda"][0], runs["einsum"][0]
        if not all(torch.equal(a, b) for a, b in zip(
                tree_leaves(cu["model"].posterior),
                tree_leaves(runs["cuda"][1]["model"].posterior))):
            raise AssertionError(f"{name}: two cuda fits differ in bits")
        for k in clg_stats.LAUNCHES:
            total[k] += cu["launches"][k]
            if (k in kernels) != (cu["launches"][k] > 0):
                raise AssertionError(f"{name}: {k} launched "
                                     f"{cu['launches'][k]} times")
        if any(ei["launches"].values()):
            raise AssertionError(f"{name}: the einsum run launched kernels")
        post = cu["model"].posterior
        if not bool(tree_finite(post)):
            raise AssertionError(f"{name}: posterior is not finite")
        z = cu["z"]
        if tuple(z.shape) != (N, post.mix.alpha.shape[0]) or not bool(
                torch.isfinite(z).all()):
            raise AssertionError(f"{name}: posterior_z bad: {tuple(z.shape)}")
        z_err = float((z - ei["z"]).abs().max())
        m_c, m_e = post.reg.m, ei["model"].posterior.reg.m
        m_err = float((m_c - m_e).abs().max())
        m_tol = FIT_TOL_REL * (1.0 + float(m_e.abs().max()))
        first = next((i for i, f in enumerate(cu["drifted"]) if f), None)
        rate = {b: [r["inst_per_s"] for r in runs[b]] for b in runs}
        log(f"{name}: T={T_CHUNKS} x N={N}, switch at {SWITCH}; drift flags "
            f"cuda {cu['drifted']} einsum {ei['drifted']}; sweeps "
            f"{cu['sweeps']}; elbo {cu['elbo']:.6g} (einsum {ei['elbo']:.6g})"
            f"; |m_cuda-m_einsum| {m_err:.3e} (tol {m_tol:.3e}); "
            f"|z_cuda-z_einsum| {z_err:.3e} (tol {Z_ATOL}); two cuda fits "
            f"bitwise equal")
        log(f"{name}: inst/s (einsum, cuda, cuda, einsum) {rate['einsum'][0]}"
            f" {rate['cuda'][0]} {rate['cuda'][1]} {rate['einsum'][1]}; "
            f"peak GB cuda {cu['peak_mem_gb']:.4f} einsum "
            f"{ei['peak_mem_gb']:.4f}; launches {cu['launches']}; "
            f"card {card}")
        if m_err > m_tol:
            raise AssertionError(f"{name}: cuda and einsum posteriors differ")
        if z_err > Z_ATOL:
            raise AssertionError(f"{name}: cuda and einsum posterior_z differ")
        if drifts and first not in (SWITCH, SWITCH + 1):
            raise AssertionError(f"{name}: first drift at {first}, expected "
                                 f"{SWITCH} or {SWITCH + 1}")
        prof = {b: profile_sweeps(runs[b][0]["model"], queries)
                for b in ("cuda", "einsum")}
        log(f"{name}: profiled sweep at N={N} (profiler on) {prof}")
        fitted[name] = (cu["model"], queries, z, stream)
    return total, fitted


def _profiled(run, ours, by_name=None, n_by_name=None):
    """torch.profiler over one call of ``run``: (wall us, device busy us --
    the sum of kernel durations --, device kernels, busy us in kernels whose
    name holds one of ``ours``); ``by_name``, a dict, gets the busy us of
    each of those kernels by name, and ``n_by_name`` the number of every
    device kernel by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy = mine = 0.0
    n = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.time_range.elapsed_us()
            busy += dur
            n += 1
            if n_by_name is not None:
                n_by_name[ev.name] = n_by_name.get(ev.name, 0) + 1
            if any(k in ev.name for k in ours):
                mine += dur
                if by_name is not None:
                    by_name[ev.name] = by_name.get(ev.name, 0.0) + dur
    return wall_us, busy, n, mine


def profile_sweeps(model, batch, sweeps=3, n_by_name=None):
    """torch.profiler over ``sweeps`` local steps + global updates of
    ``model`` on ``batch`` (after the fits, so warm): device busy time (sum
    of kernel durations), its share of the wall time, device kernels per
    sweep, and the share of device time in this repo's kernels;
    ``n_by_name``, a dict, gets the profile's device kernels by name and
    number (:func:`_profiled`)."""
    import torch

    from repro_torch.core import vmp

    b = model._as_batch(batch)

    def run():
        for _ in range(sweeps):
            st, _ = vmp.local_step(model.cp, model.posterior, b.xc, b.xd,
                                   b.mask, backend=model.backend)
            post = vmp.global_update(model.prior, st)
            float(vmp.elbo(model.cp, model.prior, post, st))
        torch.cuda.synchronize()

    run()
    wall_us, busy, n, mine = _profiled(
        run, ("moments_tile", "moments_rows", "moments_reduce",
              "latent_tile", "latent_reduce", "latent_rows", "disc_tile",
              "disc_reduce"), n_by_name=n_by_name)
    return dict(sweep_ms=wall_us / sweeps / 1e3,
                device_busy_ms=busy / sweeps / 1e3,
                idle_share=max(0.0, 1.0 - busy / wall_us),
                device_ops_per_sweep=n / sweeps,
                kernel_share_of_device=mine / busy if busy else 0.0)


# -- exact serving (infer_exact + serve) --------------------------------------


def _chain_net(dev, depth=12):
    """BENCH_latent's strong-JT network: Z (card 3) -> X00 -> ... -> X11, the
    same draws from RandomState(0) as ``benchmarks/run.py``."""
    import torch

    from repro_torch.core.dag import (BayesianNetwork, CLGCPD, DAG,
                                      MultinomialCPD, Variables)

    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)
    vs = Variables()
    Z = vs.new_multinomial("Z", 3)
    xs = [vs.new_gaussian(f"X{i:02d}") for i in range(depth)]
    dag = DAG(vs)
    dag.add_parent(xs[0], Z)
    for a_, b_ in zip(xs, xs[1:]):
        dag.add_parent(b_, a_)
    rng = np.random.RandomState(0)
    cpds = {"Z": MultinomialCPD(t(rng.dirichlet(np.ones(3)))),
            xs[0].name: CLGCPD(t(rng.randn(3)), t(np.zeros((3, 0))),
                               t(np.ones(3)))}
    for a_, b_ in zip(xs, xs[1:]):
        cpds[b_.name] = CLGCPD(t(rng.randn()), t(rng.randn(1) * 0.8),
                               t(0.3 + rng.rand()))
    return BayesianNetwork(dag, cpds)


def _fa_net(dev, K=4, L=4, F=16, seed=0):
    """``tests/test_strong_jt.py::fa_net`` widened to fa_plate's widths:
    Z (card K) mixes L latent H; F observed leaves each regress on all H."""
    import torch

    from repro_torch.core.dag import (BayesianNetwork, CLGCPD, DAG,
                                      MultinomialCPD, Variables)

    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)
    rng = np.random.RandomState(seed)
    vs = Variables()
    Z = vs.new_multinomial("Z", K)
    hs = [vs.new_gaussian(f"H{i + 1}") for i in range(L)]
    xs = [vs.new_gaussian(f"X{i}") for i in range(F)]
    dag = DAG(vs)
    cpds = {"Z": MultinomialCPD(t(rng.dirichlet(np.ones(K))))}
    for h in hs:
        dag.add_parent(h, Z)
        cpds[h.name] = CLGCPD(t(2.0 * rng.randn(K)), t(np.zeros((K, 0))),
                              t(0.5 + rng.rand(K)))
    for x in xs:
        for h in hs:
            dag.add_parent(x, h)
        cpds[x.name] = CLGCPD(t(rng.randn()), t(rng.randn(L)),
                              t(0.3 + rng.rand()))
    return BayesianNetwork(dag, cpds)


def _serving_cases(dev):
    """(name, network, schemas, targets, continuous nodes to query, kernels
    the cuda backend must launch)."""
    from repro_torch.data.synthetic import random_discrete_bn

    disc = random_discrete_bn(32, card=4, max_parents=3, seed=0, device=dev)
    fa = _fa_net(dev)
    return [
        ("discrete32", disc,
         [("D31",), ("D5", "D20"), ("D10", "D25", "D30")], ("D0", "D16"),
         (), ("log_product", "log_marginalize")),
        ("chain12", _chain_net(dev), [("X11",), ("X05", "X11")], ("Z",),
         ("X00", "X08"), ("cg_weak_marg",)),
        ("fa16", fa, [tuple(f"X{i}" for i in range(16)),
                      tuple(f"X{i}" for i in range(8))], ("Z",),
         ("H1", "H4", "X15"), ("cg_weak_marg",)),
    ]


def _draw_queries(dev, bn, schemas, targets, seed):
    """SERVE_FLUSHES flushes of SERVE_B queries per schema: evidence values
    drawn by sampling the network (so none is impossible)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    flushes = []
    for _ in range(SERVE_FLUSHES):
        qs = []
        for schema in schemas:
            s = {k: v.cpu().numpy() for k, v in
                 bn.sample(gen, SERVE_B).items() if k in schema}
            for b in range(SERVE_B):
                qs.append((targets[b % len(targets)],
                           {k: float(s[k][b]) for k in schema}))
        flushes.append(qs)
    return flushes


class _ShapeRecorder:
    """Wraps the kernel wrappers of ``mod`` while a phase runs and keeps,
    for each, what ``keep(args)`` makes of its largest call by
    ``size(args)`` (default: the input shapes, by the first input's size),
    and in ``shapes`` its calls counted by input shapes and int
    arguments."""

    def __init__(self, mod, size=lambda args: np.prod(args[0].shape),
                 keep=lambda args: tuple(tuple(a.shape) if hasattr(a, "shape")
                                         else a for a in args)):
        self.mod, self.largest, self._orig = mod, {}, {}
        self._size, self._keep, self._best = size, keep, {}
        self.shapes = {}
        for name in mod.LAUNCHES:
            self._orig[name] = getattr(mod, name)
            setattr(mod, name, self._wrap(name, self._orig[name]))

    def _wrap(self, name, fn):
        def rec(*args, **kw):
            key = tuple(tuple(a.shape) if hasattr(a, "shape") else a
                        for a in args)
            counts = self.shapes.setdefault(name, {})
            counts[key] = counts.get(key, 0) + 1
            n = self._size(args)
            if n and n > self._best.get(name, 0):
                self._best[name] = n
                self.largest[name] = self._keep(args)
            return fn(*args, **kw)
        return rec

    def close(self):
        for name, fn in self._orig.items():
            setattr(self.mod, name, fn)


def exact_serving_phase(dev, card, fitted):
    """The three networks through ``PGMQueryEngine``; then
    ``factors.reduce_evidence`` and ``Model.posterior_exact``.  Returns the
    launch counts of the cuda-backend runs and the largest kernel shapes."""
    import torch

    from repro_torch.infer_exact import JunctionTreeEngine
    from repro_torch.infer_exact import factors as F
    from repro_torch.kernels import factor_ops

    total = dict.fromkeys(factor_ops.LAUNCHES, 0)
    cases = _serving_cases(dev)
    rec = _ShapeRecorder(factor_ops)
    try:
        for name, bn, schemas, targets, cont, kernels in cases:
            flushes = _draw_queries(dev, bn, schemas, targets, seed=1)
            n_props = SERVE_FLUSHES * len(schemas)
            runs = {"cuda": [], "einsum": []}
            for backend in ("einsum", "cuda", "cuda", "einsum"):
                runs[backend].append(
                    _serve(bn, backend, dev, flushes, schemas, cont))
            cu, ei = runs["cuda"][0], runs["einsum"][0]
            launches = cu["launches"]
            for k in total:
                total[k] += launches[k]
                if (k in kernels) != (launches[k] > 0):
                    raise AssertionError(f"{name}: {k} launched "
                                         f"{launches[k]} times")
            if name == "discrete32" and (
                    launches["log_product"] != 168 * n_props
                    or launches["log_marginalize"] != 48 * n_props):
                raise AssertionError(f"{name}: {launches} in {n_props} "
                                     f"propagations, expected 168 and 48 "
                                     f"per propagation")
            if name == "discrete32":
                # the recorder saw the warm-ups (B = 1) and two cuda runs
                hist = {k[0]: v / (2 * n_props) for k, v in
                        rec.shapes["log_marginalize"].items()
                        if k[0][0] == SERVE_B}
                if sum(hist.values()) != 48:
                    raise AssertionError(f"{name}: log_marginalize shapes "
                                         f"{hist} do not add up to 48")
                log(f"{name}: log_marginalize launches a propagation by "
                    f"[B, M, N]: " + "; ".join(
                        f"{list(k)} x{v:g}" for k, v in sorted(
                            hist.items(), key=lambda kv: -np.prod(kv[0]))))
            if launches["cg_weak_marg"] and launches["cg_weak_marg"] < n_props:
                raise AssertionError(f"{name}: cg_weak_marg launched "
                                     f"{launches['cg_weak_marg']} times in "
                                     f"{n_props} propagations")
            if any(r["launches"][k] for r in runs["einsum"] for k in total):
                raise AssertionError(f"{name}: the plain run launched "
                                     f"kernels")
            errs = _compare_serving(name, cu, ei)
            qps = {b: [r["qps"] for r in runs[b]] for b in runs}
            log(f"{name}: {len(schemas)} schemas x B={SERVE_B} x "
                f"{SERVE_FLUSHES} flushes = {n_props} propagations; launches "
                f"{launches}; cuda vs plain max |d posterior| "
                f"{errs['post']:.3e} (tol {POST_ATOL}), |d logZ| "
                f"{errs['logz']:.3e} (tol {LOGZ_TOL_REL}(1+|logZ|)), "
                f"|d mean/var| {errs['moments']:.3e} (tol "
                f"{MOMENT_TOL_REL}(1+|plain|))")
            log(f"{name}: queries/s (plain, cuda, cuda, plain) "
                f"{qps['einsum'][0]} {qps['cuda'][0]} {qps['cuda'][1]} "
                f"{qps['einsum'][1]}; peak GB cuda {cu['peak_gb']:.4f} plain "
                f"{ei['peak_gb']:.4f}; card {card}")
            prof = {b: profile_flush(bn, b, dev, flushes[0], len(schemas))
                    for b in ("cuda", "einsum")}
            log(f"{name}: profiled flush of {len(schemas)} x {SERVE_B} "
                f"queries (profiler on) {prof}")

        # shrink-style evidence reduction on the largest clique belief of the
        # discrete network (the algebra layer's entry to evidence_select)
        bn = cases[0][1]
        ev = _draw_queries(dev, bn, [("D31",)], ("D0",), seed=2)[0]
        eng = JunctionTreeEngine(bn, device=dev)
        eng.set_evidence({"D31": np.array([e["D31"] for _, e in ev])})
        eng.run_inference()
        ci = max(range(len(eng._scopes)), key=lambda i: eng._beliefs[i].numel())
        scope = eng._scopes[ci]
        belief = F.Factor(scope, tuple(4 for _ in scope), eng._beliefs[ci])
        idx = torch.randint(0, 4, (SERVE_B,), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(3))
        factor_ops.reset_launches()
        got = F.reduce_evidence(belief, scope[-1], idx, backend="cuda")
        torch.cuda.synchronize()
        total["evidence_select"] += factor_ops.LAUNCHES["evidence_select"]
        exp = F.reduce_evidence(belief, scope[-1], idx, backend="einsum")
        if not torch.equal(got.logp, exp.logp) or \
                factor_ops.LAUNCHES["evidence_select"] != 1:
            raise AssertionError("reduce_evidence: cuda and plain differ")
        log(f"reduce_evidence: clique {scope} [{SERVE_B}, "
            f"{tuple(belief.logp.shape[1:])}] clamped on {scope[-1]}: same "
            f"bits as the plain path")

        # exact posteriors of the fitted nb_mixed model vs posterior_z
        model, queries, z, _ = fitted["nb_mixed"]
        nq = 1 << 16
        sub = _batch(queries.xc[:nq], queries.xd[:nq])
        factor_ops.reset_launches()
        t0 = time.perf_counter()
        pe = model.posterior_exact(sub)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for k in total:
            total[k] += factor_ops.LAUNCHES[k]
        if not factor_ops.LAUNCHES["log_product"]:
            raise AssertionError("posterior_exact launched no kernel")
        pp = model.posterior_exact(sub, backend="einsum")
        d_z = float((pe - z[:nq]).abs().max())
        d_p = float((pe - pp).abs().max())
        log(f"posterior_exact(nb_mixed, {nq} queries): {secs:.3f} s; "
            f"|exact - posterior_z| {d_z:.3e} (tol {EXACT_VS_VMP_ATOL}); "
            f"|cuda - plain| {d_p:.3e} (tol {POST_ATOL})")
        if tuple(pe.shape) != tuple(z[:nq].shape) or not bool(
                torch.isfinite(pe).all()):
            raise AssertionError(f"posterior_exact bad: {tuple(pe.shape)}")
        if d_z > EXACT_VS_VMP_ATOL or d_p > POST_ATOL:
            raise AssertionError("posterior_exact disagrees")
    finally:
        rec.close()
    return total, rec.largest, rec.shapes


def _serve(bn, backend, dev, flushes, schemas, cont):
    """Serve every flush through a fresh engine; returns results, launch
    counts, queries/s and the posterior moments of ``cont`` for the first
    schema's last batch."""
    import torch

    from repro_torch.infer_exact import JunctionTreeEngine
    from repro_torch.kernels import factor_ops
    from repro_torch.serve.engine import PGMQueryEngine

    eng = PGMQueryEngine(bn, mode="exact", backend=backend, device=dev,
                         pad_pow2=True)
    for t, ev in flushes[0][:: SERVE_B]:       # warm-up: one per schema
        eng.submit(t, ev)
    eng.flush()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    factor_ops.reset_launches()                # counts of this run only
    t0 = time.perf_counter()
    results = []
    for qs in flushes:
        sub = [eng.submit(t, ev) for t, ev in qs]
        eng.flush()
        results.extend(sub)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    moments = []
    if cont:
        jt = JunctionTreeEngine(bn, backend=backend, device=dev)
        last = [ev for _, ev in flushes[-1][:SERVE_B]]
        jt.set_evidence({k: np.array([e[k] for e in last])
                         for k in schemas[0]})
        jt.run_inference()
        for c in cont:
            if c not in schemas[0]:
                moments.extend(jt.posterior_mean_var(
                    bn.dag.variables.by_name(c)))
        torch.cuda.synchronize()
    return dict(results=results, qps=len(results) / secs,
                launches=dict(factor_ops.LAUNCHES), moments=moments,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def profile_flush(bn, backend, dev, qs, n_props):
    """torch.profiler over one warm flush: device busy time (sum of kernel
    durations), its share of the wall time, device kernels per propagation
    and the share of device time in this repo's factor kernels."""
    import torch

    from repro_torch.serve.engine import PGMQueryEngine

    eng = PGMQueryEngine(bn, mode="exact", backend=backend, device=dev,
                         pad_pow2=True)

    def run():
        for t, ev in qs:
            eng.submit(t, ev)
        eng.flush()
        torch.cuda.synchronize()

    run()
    wall_us, busy, n, mine = _profiled(
        run, ("log_product", "log_marginalize", "evidence_select",
              "cg_weak_marg"))
    return dict(flush_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                idle_share=max(0.0, 1.0 - busy / wall_us),
                device_ops_per_propagation=n / n_props,
                kernel_share_of_device=mine / busy if busy else 0.0)


def _compare_serving(name, cu, ei):
    post = logz = moments = 0.0
    for a, b in zip(cu["results"], ei["results"]):
        if a.result.shape != b.result.shape or not np.isfinite(
                a.result).all() or not np.isfinite(a.log_evidence):
            raise AssertionError(f"{name}: bad result for query {a.qid}")
        post = max(post, float(np.abs(a.result - b.result).max()))
        d = abs(a.log_evidence - b.log_evidence) / (1 + abs(b.log_evidence))
        logz = max(logz, d)
    for a, b in zip(cu["moments"], ei["moments"]):
        moments = max(moments, float(((a - b).abs() / (1 + b.abs())).max()))
    if post > POST_ATOL or logz > LOGZ_TOL_REL or moments > MOMENT_TOL_REL:
        raise AssertionError(f"{name}: cuda and plain backends differ: "
                             f"{post} {logz} {moments}")
    return dict(post=post, logz=logz, moments=moments)


def factor_kernel_phase(dev, largest, shapes):
    """The four factor kernels at the largest shapes the serving phase
    launched, against their plain versions, with -inf entries, all -inf
    rows and dead mixture rows; ``log_marginalize`` also at the largest
    short-row shape of another N and the largest long-row shape among the
    serving phase's calls (``shapes``), ``cg_weak_marg`` also at n = 12."""
    import torch

    from repro_torch.kernels import clg_stats, factor_ops, ref

    g = torch.Generator(device=dev).manual_seed(4)
    rows = {}

    def table(shape):
        x = torch.randn(*shape, generator=g, device=dev)
        x[torch.rand(*shape, generator=g, device=dev) < 0.25] = float("-inf")
        x.view(-1, shape[-1])[0] = float("-inf")     # an all -inf row
        return x

    def record(name, kern, plain, library, check, nbytes, nops):
        got, again = kern(), kern()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name}: two launches differ in bits")
        err = check(got, plain())
        b_ms, b_by = bound(nbytes, nops)
        rows[name] = dict(
            name=name, route="cuda", source=FACTOR_SOURCE,
            replaces=REPLACES[name], launches=0, max_abs_err=err,
            ms=time_ms(kern), plain_ms=time_ms(plain), bound_ms=b_ms,
            bound_by=b_by,
            library_ms=None if library is None else time_ms(library))
        log(f"kernel {name} at {largest[name]}: max_abs_err {err:.3e}, "
            f"bitwise repeatable; ms {rows[name]['ms']:.4f} plain_ms "
            f"{rows[name]['plain_ms']:.4f} library_ms "
            f"{rows[name]['library_ms']} bound_ms {b_ms:.5f} ({b_by})")

    def lse_log(x, ms, plain_ms, library_ms, b_ms, err, what):
        p = factor_ops.lse_plan_of(x)
        versus = "beats" if ms <= library_ms else "LOSES to"
        # the kernel's own time, apart from the wrapper's host work
        calls, us, n = 5, {}, {}

        def run():
            for _ in range(calls):
                factor_ops.log_marginalize(x)
            torch.cuda.synchronize()

        _profiled(run, ("log_marginalize_kernel",), us, n)
        dev_ms = sum(us.values()) / max(1, sum(n.values())) / 1e3
        log(f"kernel log_marginalize, {what}: {list(x.shape)}: max_abs_err "
            f"{err:.3e} (tol {LSE_TOL} (1 + |x|)), bitwise repeatable; ms "
            f"{ms:.5f} (device {dev_ms:.5f} a launch, profiled, "
            f"{sum(n.values())} of {calls} launches traced) plain_ms "
            f"{plain_ms:.5f} library_ms {library_ms:.5f} (torch.logsumexp) "
            f"bound_ms {b_ms:.5f} (bytes); {versus} the library call; plan "
            f"{p}; blocks an SM {factor_ops.log_marginalize_blocks_per_sm(p)}")

    def same_bits(got, exp):
        for a, b in zip(got, exp):
            if not torch.equal(a, b):
                raise AssertionError("kernel and plain differ in bits")
        return 0.0

    def lse_close(a, b):
        if not torch.equal(torch.isneginf(a), torch.isneginf(b)):
            raise AssertionError("-inf pattern differs")
        fin = torch.isfinite(b)
        d = (a[fin] - b[fin]).abs()
        if bool((d > LSE_TOL * (1 + b[fin].abs())).any()):
            raise AssertionError(f"log-mass differs by {float(d.max())}")
        return float(d.max()) if d.numel() else 0.0

    (B, M, N), _ = largest["log_product"]
    a, b = table((B, M, N)), torch.randn(B, N, generator=g, device=dev)
    record("log_product", lambda: [factor_ops.log_product(a, b)],
           lambda: [ref.log_product_ref(a, b)],
           lambda: [a + b[:, None, :]], same_bits,
           4 * (2 * B * M * N + B * N), B * M * N)
    del a, b

    (B, M, N), = largest["log_marginalize"]
    x = table((B, M, N))
    record("log_marginalize", lambda: [factor_ops.log_marginalize(x)],
           lambda: [ref.log_marginalize_ref(x)],
           lambda: [torch.logsumexp(x, -1)],
           lambda got, exp: lse_close(got[0], exp[0]),
           4 * (B * M * N + B * M), 4 * B * M * N)
    row = rows["log_marginalize"]
    lse_log(x, row["ms"], row["plain_ms"], row["library_ms"], row["bound_ms"],
            row["max_abs_err"], "the largest")
    del x
    # the largest short-row shape of another N, the largest long-row shape
    seen = [k[0] for k in shapes["log_marginalize"]]
    size = lambda k: int(np.prod(k))
    short = [k for k in seen if k[2] <= factor_ops.SHORT_N and k[2] != N]
    long_ = [k for k in seen if k[2] > factor_ops.SHORT_N]
    if not short or not long_:
        raise AssertionError(f"log_marginalize: no short-row shape of "
                             f"another N or no long-row shape in {seen}")
    for what, shape in (("short rows", max(short, key=size)),
                        ("long rows", max(long_, key=size))):
        x = table(shape)
        kern = lambda: factor_ops.log_marginalize(x)
        got, again = kern(), kern()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"log_marginalize at {shape}: two launches "
                                 f"differ in bits")
        err = lse_close(got, ref.log_marginalize_ref(x))
        B_, M_, N_ = shape
        b_ms, _ = bound(4 * (B_ * M_ * N_ + B_ * M_), 4 * B_ * M_ * N_)
        lse_log(x, time_ms(kern), time_ms(lambda: ref.log_marginalize_ref(x)),
                time_ms(lambda: torch.logsumexp(x, -1)), b_ms, err, what)
        del x

    (B, M, N), (_,) = largest["evidence_select"]
    x = table((B, M, N))
    idx = torch.randint(0, N, (B,), generator=g, device=dev)
    sel = idx[:, None, None].expand(B, M, 1)
    # bytes: the 32-byte sectors of x the gather must fetch (rows of N
    # floats 4N bytes apart: every sector while 4N <= 32), out, idx
    record("evidence_select", lambda: [factor_ops.evidence_select(x, idx)],
           lambda: [ref.evidence_select_ref(x, idx)],
           lambda: [torch.gather(x, 2, sel)[..., 0]], same_bits,
           B * M * min(4 * N, 32) + 4 * B * M + idx.element_size() * B, 0)
    del x

    def weak_close(got, exp, n):
        err = lse_close(got[0], exp[0])
        for x_, y_ in zip(got[1:], exp[1:]):
            torch.testing.assert_close(x_, y_, atol=WEAK_ATOL, rtol=WEAK_RTOL)
            err = max(err, float((x_ - y_).abs().max()))
        if float(got[1][0, 0].abs().max()) or not torch.equal(
                got[2][0, 0], torch.eye(n, device=dev)):
            raise AssertionError("cg_weak_marg: dead row is not (-inf, 0, I)")
        return err

    def weak_check(B, M, N, n, what):
        """cg_weak_marg at [B, M, N] in n dims against its plain version
        (one row dead), its bound, and the profiled device time a launch;
        returns the row's numbers."""
        lw = table((B, M, N))
        mu = torch.randn(B, M, N, n, generator=g, device=dev)
        q = torch.randn(B, M, N, n, n, generator=g, device=dev)
        sg = q @ q.transpose(-1, -2) + 0.5 * torch.eye(n, device=dev)
        kern = lambda: factor_ops.cg_weak_marg(lw, mu, sg)
        got, again = kern(), kern()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("cg_weak_marg: two launches differ in bits")
        err = weak_close(got, ref.cg_weak_marg_ref(lw, mu, sg), n)
        e = n * n
        b_ms, b_by = bound(4 * (B * M * N * (1 + n + e) + B * M * (1 + n + e)),
                           B * M * N * (2 + 3 * n + 4 * e))
        ms = time_ms(kern)
        plain_ms = time_ms(lambda: ref.cg_weak_marg_ref(lw, mu, sg))
        calls, us, cnt = 5, {}, {}

        def run():
            for _ in range(calls):
                kern()
            torch.cuda.synchronize()

        _profiled(run, ("cg_weak_marg_kernel",), us, cnt)
        dev_ms = sum(us.values()) / max(1, sum(cnt.values())) / 1e3
        p = factor_ops.weak_plan(B * M, n, clg_stats.sm_count(dev))
        log(f"kernel cg_weak_marg, {what}: {[B, M, N]}, n = {n}: max_abs_err "
            f"{err:.3e} (mass {LSE_TOL} (1 + |x|), moments atol {WEAK_ATOL} "
            f"rtol {WEAK_RTOL}), dead row (-inf, 0, I), bitwise repeatable; "
            f"ms {ms:.5f} (device {dev_ms:.5f} a launch, profiled, "
            f"{sum(cnt.values())} of {calls} launches traced) plain_ms "
            f"{plain_ms:.4f} library_ms none bound_ms {b_ms:.6f} ({b_by}); "
            f"plan {p}, {-(-B * M * p.G // p.threads)} blocks")
        return dict(name="cg_weak_marg", route="cuda", source=FACTOR_SOURCE,
                    replaces=REPLACES["cg_weak_marg"], launches=0,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)

    (B, M, N), (_, _, _, n), _ = largest["cg_weak_marg"]
    rows["cg_weak_marg"] = weak_check(B, M, N, n, "the largest")
    # n = 12 (a strong clique of 12 continuous variables): 144 entries a
    # row, the lane group's entry blocks
    weak_check(1024, 1, 4, 12, "n = 12")
    return rows


# -- structure learning (learn_structure) -------------------------------------


def _kernel_modules():
    from repro_torch.kernels import (clg_stats, factor_ops, family_counts,
                                     flash_attn, ssd_scan)

    return clg_stats, factor_ops, family_counts, flash_attn, ssd_scan


def _reset_all_launches():
    for mod in _kernel_modules():
        mod.reset_launches()


def _all_launches():
    out = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def _counted(fn):
    """(result, seconds, launch counts) of ``fn()``: every count set to 0
    just before, read just after a synchronize."""
    import torch

    torch.cuda.synchronize()
    _reset_all_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _all_launches()


def _add(total, launches, name, backend):
    """Add a CUDA-backend run's counts to ``total``; a plain run must have
    launched nothing."""
    if backend != "cuda":
        if any(launches.values()):
            raise AssertionError(f"{name}: the plain run launched {launches}")
        return
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _clg_precision(batch, dev):
    """Every one-parent family of ``batch``'s continuous columns scored by
    the cuda route and by one float32 ``clg_suffstats`` pass over all N
    with float32 NIG algebra, against the einsum route's float64 moments:
    (families, max |error| of each, in nats)."""
    import torch

    from repro_torch.kernels import clg_stats
    from repro_torch.learn_structure import scores as S

    xc = S.to_device(batch.xc, dev, torch.float32)
    F = xc.shape[1]
    fams = [(c, (p,), ()) for c in range(F) for p in range(F) if p != c]
    d, y, r = S.group_design(xc, S.to_device(batch.xd, dev, torch.int32),
                             fams, [], None)
    exact = S.nig_evidence(*S.group_moments(d, y, r, "einsum")).sum(-1)
    routed = S.nig_evidence(*S.group_moments(d, y, r, "cuda")).sum(-1)
    n = r.sum(0)[None].expand(len(fams), r.shape[1])
    one_pass = S.nig_evidence(*clg_stats.clg_suffstats(d, y, r), n).sum(-1)
    err = lambda a: float((a.double() - exact).abs().max())
    return len(fams), err(routed), err(one_pass)


def _by_shape(rec, name, top=3):
    """``name``'s calls under ``rec``: the number of distinct input shapes
    and the ``top`` most frequent with their counts."""
    counts = rec.shapes.get(name, {})
    common = sorted(counts.items(), key=lambda kv: -kv[1])[:top]
    return (f"{sum(counts.values())} calls at {len(counts)} shapes, most "
            f"often " + "; ".join(f"{k} x{v}" for k, v in common))


def _clg_search_kernel(dev, rec):
    """``clg_suffstats`` as the CLG search launched it (``rec``: its
    recorder): the largest ``clg_suffstats_chunks`` call, one of its chunks
    alone (the call each chunk was before one launch took them all) and
    the common shapes d [16384, 1, 2] and [16384, 30, 3], each against its
    plain version and timed (``clg_suffstats_check``); then the chunked
    call against per-chunk calls bit for bit at the largest shape."""
    import torch

    from repro_torch.kernels import clg_stats

    ds, ys, rs, chunk = rec.largest["clg_suffstats_chunks"]
    g = torch.Generator(device=dev).manual_seed(3)

    def inputs(ds, rs):
        d = torch.randn(ds, generator=g, device=dev)
        y = torch.randn(ds[:2], generator=g, device=dev)
        r = torch.softmax(torch.randn(rs, generator=g, device=dev), -1)
        return d, y, r

    d, y, r = inputs(ds, rs)
    clg_suffstats_check("the CLG search's largest call", d, y, r, chunk)
    parts = clg_stats.clg_suffstats_chunks(d, y, r, chunk)
    n = d.shape[0]
    for i in sorted({0, 1, (n - 1) // chunk}):
        sl = slice(i * chunk, (i + 1) * chunk)
        one = clg_stats.clg_suffstats(d[sl], y[sl], r[sl])
        if not all(torch.equal(a[i], b) for a, b in zip(parts, one)):
            raise AssertionError(f"clg_suffstats_chunks: chunk {i} differs "
                                 f"in bits from clg_suffstats of that chunk")
    tail = n - chunk // 2 - 1            # a ragged last chunk
    parts = clg_stats.clg_suffstats_chunks(d[:tail], y[:tail], r[:tail],
                                           chunk)
    i = (tail - 1) // chunk
    one = clg_stats.clg_suffstats(d[i * chunk:tail], y[i * chunk:tail],
                                  r[i * chunk:tail])
    if not all(torch.equal(a[i], b) for a, b in zip(parts, one)):
        raise AssertionError("clg_suffstats_chunks: the ragged last chunk "
                             "differs in bits from clg_suffstats of it")
    log(f"kernel clg_suffstats_chunks at {tuple(ds)} / {chunk}: chunks 0, 1, "
        f"the last and a ragged last chunk the same bits as clg_suffstats "
        f"of each chunk alone")
    del d, y, r, parts
    clg_suffstats_check("one chunk of the CLG search's largest call",
                        *inputs((chunk,) + tuple(ds[1:]), (chunk, rs[1])))
    for F, D in ((1, 2), (30, 3)):
        clg_suffstats_check("a common shape of the CLG search",
                            *inputs((chunk, F, D), (chunk, 1)))
    log(f"clg_suffstats calls of the CLG search by shape: "
        f"{_by_shape(rec, 'clg_suffstats_chunks')}")


def structure_phase(dev, card):
    """Structure learning through the public API on the card: (a) hill
    climbing and Chow-Liu on discrete32, (b) all-candidates scoring,
    (c) hill climbing on a 32-node CLG tree, (d) drift-adaptive structure
    over a switching stream, its network served exactly.  Returns the
    launch counts of the CUDA-backend runs and the ``family_counts``
    inputs that phase (e) checks."""
    import itertools

    import torch

    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import clg_stats, family_counts
    from repro_torch.learn_structure import (AdaptiveStructure, chow_liu,
                                             hill_climb, skeleton_f1,
                                             undirected_edges)
    from repro_torch.learn_structure import scores as S

    total = {}

    # (a) hill climbing on discrete32, both backends; Chow-Liu on a tree
    bn = syn.random_discrete_bn(32, card=4, max_parents=3, seed=0,
                                device=dev)
    data = syn.bn_stream(bn, STRUCT_N, seed=5)
    batch, attrs = data.collect(), data.attributes
    search = lambda backend: _counted(lambda: hill_climb(
        batch, attrs, max_parents=3, backend=backend, device=dev))
    res = {"einsum": search("einsum")}
    fc_recorder = lambda: _ShapeRecorder(  # keep the largest call's inputs
        family_counts, size=lambda a: a[1].shape[0] * a[3],
        keep=lambda a: (a[0], a[1].clone(), a[3]))
    rec = fc_recorder()
    try:
        res["cuda"] = search("cuda")
    finally:
        rec.close()
    for backend, (_, _, launches) in res.items():
        _add(total, launches, "discrete32 hill_climb", backend)
    (cu, cu_s, cu_l), (ei, ei_s, _) = res["cuda"], res["einsum"]
    if cu.parents != ei.parents or cu.score != ei.score:
        raise AssertionError("discrete32 hill_climb: cuda and einsum differ: "
                             f"{cu.score} vs {ei.score}")
    if not cu_l["family_counts"]:
        raise AssertionError("discrete32 hill_climb launched no "
                             "family_counts")
    prof = _profiled(lambda: hill_climb(batch, attrs, max_parents=3,
                                        backend="cuda", device=dev, fit=False),
                     ("family_counts_slab", "slab_reduce"))
    log(f"structure discrete32: hill_climb(max_parents=3) on N={STRUCT_N}: "
        f"same parent sets and score on both backends ({cu.score!r}); "
        f"{cu.n_iters} iterations, {cu.n_scored} families scored, "
        f"{sum(map(len, cu.parents.values()))} edges, skeleton F1 vs the "
        f"generator {skeleton_f1(bn, cu.parents):.4f}; seconds cuda "
        f"{cu_s:.3f} einsum {ei_s:.3f}; launches {cu_l}; profiled search "
        f"(profiler on, fit=False): wall_ms {prof[0] / 1e3:.1f} "
        f"device_busy_ms {prof[1] / 1e3:.2f} idle_share "
        f"{max(0.0, 1 - prof[1] / prof[0]):.4f} device_ops {prof[2]} "
        f"family_counts_share_of_device {prof[3] / max(prof[1], 1e-9):.4f}; "
        f"family_counts by shape {_by_shape(rec, 'family_counts')}")
    largest = {"hill-climb": rec.largest["family_counts"]}

    tree = syn.random_discrete_bn(32, card=4, tree=True, seed=3, device=dev)
    tdata = syn.bn_stream(tree, STRUCT_N, seed=4)
    rec = fc_recorder()
    try:
        (edges, learned), secs, launches = _counted(lambda: chow_liu(
            tdata.collect(), tdata.attributes, device=dev))
    finally:
        rec.close()
    largest["chow-liu"] = rec.largest["family_counts"]
    _add(total, launches, "chow_liu", "cuda")
    if len(edges) != 31 or not launches["family_counts"]:
        raise AssertionError(f"chow_liu: {len(edges)} edges, {launches}")
    log(f"structure tree32: chow_liu on N={STRUCT_N}: edge F1 vs the "
        f"generator {skeleton_f1(tree, edges):.4f}; {secs:.3f} s; launches "
        f"{launches}; family_counts by shape "
        f"{_by_shape(rec, 'family_counts')}")

    # (b) every family of <= 2 parents over discrete32's columns, one call
    cards = [a.card for a in attrs]
    fams = [(ch, pa) for ch in range(32) for k in range(3)
            for pa in itertools.combinations(
                [v for v in range(32) if v != ch], k)]
    xd = S.to_device(batch.xd, dev, torch.int32)
    mask = S.to_device(batch.mask, dev, torch.float32)
    score = lambda backend: S.disc_family_scores(
        xd, fams, cards, mask=mask, backend=backend, device=dev)
    score("cuda")                                   # warm-up
    runs = {"cuda": [], "einsum": []}
    for backend in ("einsum", "cuda", "cuda"):
        runs[backend].append(_counted(lambda: score(backend)))
        _add(total, runs[backend][-1][2], "all-candidates", backend)
    if not all(np.array_equal(r[0], runs["einsum"][0][0])
               for r in runs["cuda"]):
        raise AssertionError("all-candidates: cuda and einsum scores differ")
    fps = {b: [len(fams) / r[1] for r in runs[b]] for b in runs}
    log(f"structure all-candidates: {len(fams)} families (<= 2 parents, "
        f"C = 64) of discrete32 at N={STRUCT_N}, one family_counts call: "
        f"same scores on both backends; families/s einsum "
        f"{fps['einsum'][0]} cuda {fps['cuda'][0]} {fps['cuda'][1]}; "
        f"card {card}")
    strides, _, _, C = S.family_strides(fams, cards)
    all_cands = (xd, torch.as_tensor(strides, device=dev), C)

    # (c) hill climbing on a 32-node CLG tree: the first step scores the
    # 992-family group (one clg_suffstats_chunks launch)
    cbn = syn.clg_tree_bn(32, seed=0, device=dev)
    cdata = syn.bn_stream(cbn, STRUCT_N, seed=6)
    cbatch = cdata.collect()
    res = {}
    for backend in ("einsum", "cuda"):
        torch.cuda.reset_peak_memory_stats()
        rec = _ShapeRecorder(clg_stats)
        try:
            res[backend] = _counted(lambda: hill_climb(
                cbatch, cdata.attributes, max_parents=2, backend=backend,
                device=dev)) + (torch.cuda.max_memory_allocated() / 1e9,)
        finally:
            rec.close()
        _add(total, res[backend][2], "clg32 hill_climb", backend)
    (cu, cu_s, cu_l, cu_gb), (ei, ei_s, _, ei_gb) = res["cuda"], res["einsum"]
    rel = abs(cu.score - ei.score) / abs(ei.score)
    if undirected_edges(cu.parents) != undirected_edges(ei.parents):
        raise AssertionError("clg32 hill_climb: skeletons differ")
    if rel > CLG_SCORE_TOL_REL or not cu_l["clg_suffstats_chunks"]:
        raise AssertionError(f"clg32 hill_climb: scores {cu.score} "
                             f"{ei.score}, launches {cu_l}")
    n_fams, err_cuda, err_one = _clg_precision(cbatch, dev)
    log(f"structure clg32: the first step's {n_fams} one-parent family "
        f"scores against float64 moments: max |error| cuda route "
        f"{err_cuda:.4f} nats, one float32 pass over all N with float32 NIG "
        f"algebra (the JAX package's scheme) {err_one:.4f} nats")
    log(f"structure clg32: hill_climb(max_parents=2) on N={STRUCT_N}: same "
        f"skeleton on both backends, |d score|/|score| {rel:.3e} (tol "
        f"{CLG_SCORE_TOL_REL}); {cu.n_iters} iterations, {cu.n_scored} "
        f"families scored, skeleton F1 vs the generator "
        f"{skeleton_f1(cbn, cu.parents):.4f}; seconds cuda {cu_s:.3f} "
        f"einsum {ei_s:.3f}; peak GB cuda {cu_gb:.2f} einsum {ei_gb:.2f}; "
        f"launches {cu_l}")
    _clg_search_kernel(dev, rec)

    # (d) drift-adaptive structure over a switching stream, then serving
    bn_b = syn.random_discrete_bn(32, card=4, max_parents=3, seed=1,
                                  device=dev)
    half = STREAM_N // 2
    second = syn.bn_stream(bn_b, half, seed=8).collect()
    xd_all = np.concatenate([batch.xd[:half], second.xd])
    n_batches = STREAM_N // STREAM_BATCH
    switch = half // STREAM_BATCH
    ad = AdaptiveStructure(attrs, learner="hillclimb", max_parents=3,
                           window=STREAM_WINDOW, device=dev)

    def stream():
        flags = []
        for i in range(n_batches):
            xd_i = xd_all[i * STREAM_BATCH:(i + 1) * STREAM_BATCH]
            info = ad.update(np.zeros((len(xd_i), 0), np.float32), xd_i)
            flags.append(bool(info["drifted"]))
        return flags

    rec = fc_recorder()
    try:
        flags, secs, launches = _counted(stream)
    finally:
        rec.close()
    largest["adaptive-stream"] = rec.largest["family_counts"]
    _add(total, launches, "adaptive stream", "cuda")
    first = next((i for i, f in enumerate(flags) if f), None)
    log(f"structure stream: {n_batches} batches of {STREAM_BATCH} "
        f"(discrete32, then seed 1 from batch {switch}), window "
        f"{STREAM_WINDOW}: drift flags at "
        f"{[i for i, f in enumerate(flags) if f]}; {ad.n_relearn} searches; "
        f"skeleton F1 vs the new generator "
        f"{skeleton_f1(bn_b, ad.parents):.4f}; {STREAM_N / secs:.1f} inst/s "
        f"({secs:.3f} s); launches {launches}; family_counts by shape "
        f"{_by_shape(rec, 'family_counts')}")
    if first is None or first < switch:
        raise AssertionError(f"adaptive stream: first drift at {first}, "
                             f"expected at or after {switch}")
    schemas = [("D31",), ("D5", "D20"), ("D10", "D25", "D30")]
    flushes = _draw_queries(dev, ad.bn, schemas, ("D0", "D16"), seed=9)
    runs = {"cuda": [], "einsum": []}
    for backend in ("einsum", "cuda", "cuda", "einsum"):
        runs[backend].append(_serve(ad.bn, backend, dev, flushes, schemas,
                                    ()))
    cu, ei = runs["cuda"][0], runs["einsum"][0]
    _add(total, cu["launches"], "adapted serving", "cuda")
    _add(total, ei["launches"], "adapted serving", "einsum")
    if not cu["launches"]["log_product"]:
        raise AssertionError("adapted serving launched no log_product")
    errs = _compare_serving("adapted", cu, ei)
    qps = {b: [r["qps"] for r in runs[b]] for b in runs}
    log(f"structure adapted network served: {len(schemas)} schemas x "
        f"B={SERVE_B} x {SERVE_FLUSHES} flushes; cuda vs plain max |d "
        f"posterior| {errs['post']:.3e} (tol {POST_ATOL}), |d logZ| "
        f"{errs['logz']:.3e}; queries/s (plain, cuda, cuda, plain) "
        f"{qps['einsum'][0]} {qps['cuda'][0]} {qps['cuda'][1]} "
        f"{qps['einsum'][1]}; launches {cu['launches']}")
    # the common shapes: 30 families of 2 parents (C = 64) over hill
    # climbing's 2^20 instances, 32 of 3 parents (C = 256) over a batch of
    # the stream
    rng = np.random.default_rng(7)
    for label, n, M, k in (("common M=30, C=64", STRUCT_N, 30, 2),
                           ("common M=32, C=256", STREAM_BATCH, 32, 3)):
        fams = []
        for _ in range(M):
            ch = int(rng.integers(32))
            pa = rng.choice([v for v in range(32) if v != ch], k,
                            replace=False)
            fams.append((ch, tuple(int(v) for v in pa)))
        strides, _, _, C = S.family_strides(fams, cards)
        largest[label] = (xd[:n], torch.as_tensor(strides, device=dev), C)
    largest["all-candidates"] = all_cands   # last: family_counts' row
    return total, largest


def family_counts_phase(dev, inputs):
    """``family_counts`` against its plain version at each shape of
    ``inputs`` (the largest calls of hill climbing, Chow-Liu and the
    adaptive stream, the common shapes, then the all-candidates shape): 0/1
    weights give the same bits, weights uniform in (0, 1) agree to rtol
    1e-5, two launches give the same bits; timed with CUDA events, with the
    blocks an SM holds."""
    import torch

    from repro_torch.kernels import clg_stats, family_counts, ref

    g = torch.Generator(device=dev).manual_seed(6)
    row = None
    for label, (xd, strides, C) in inputs.items():
        N, Fd = xd.shape
        M = strides.shape[0]
        w01 = (torch.rand(N, generator=g, device=dev) < 0.9).float()
        wf = torch.rand(N, generator=g, device=dev)
        kern = lambda w: family_counts.family_counts(xd, strides, w, C)
        plain = lambda w: ref.family_counts_ref(xd, strides, w, C)
        got, again = kern(w01), kern(w01)
        exp = plain(w01)
        if not (torch.equal(got, again) and torch.equal(got, exp)):
            raise AssertionError(f"family_counts at {label}: not the same "
                                 f"bits as the plain version with 0/1 "
                                 f"weights, or across launches")
        if label == "hill-climb":
            # tiles with values above 255 and below 0 take the int32 path
            wide = xd.clone()
            wide[::997, 0] = 300
            wide[5::1009, 1] = -1
            if not torch.equal(
                    family_counts.family_counts(wide, strides, w01, C),
                    ref.family_counts_ref(wide, strides, w01, C)):
                raise AssertionError("family_counts: tiles with values "
                                     "outside [0, 255] differ from plain")
        gf, pf = kern(wf), plain(wf)
        torch.testing.assert_close(gf, pf, rtol=FC_RTOL, atol=FC_RTOL)
        err = float((gf - pf).abs().max())
        # the largest error over what assert_close allows (<= 1 passes)
        err_tol = float(((gf - pf).abs() / (FC_RTOL + FC_RTOL * pf.abs()))
                        .max())
        k = (strides != 0).sum(1)
        nbytes = 4 * (N * Fd + N + M * Fd + M * C)
        nops = N * float((2 * k + 1).sum())
        b_ms, b_by = bound(nbytes, nops)
        few = dict(iters=2, warmup=1)      # the plain version takes seconds
        row = dict(name="family_counts", route="cuda", source=FC_SOURCE,
                   replaces=REPLACES["family_counts"], launches=0,
                   max_abs_err=err, ms=time_ms(lambda: kern(w01)),
                   plain_ms=time_ms(lambda: plain(w01), **few),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        plan = family_counts.plan(N, Fd, M, C, clg_stats.sm_count(dev))
        log(f"kernel family_counts at {label} (N={N}, Fd={Fd}, M={M}, C={C}, "
            f"k<={int(k.max())}): 0/1 weights bitwise equal to plain and "
            f"repeatable; float weights max_abs_err {err:.3e}, err/tol "
            f"{err_tol:.4f} (rtol and atol {FC_RTOL}); ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
            f"bound_ms {b_ms:.4f} ({b_by}); blocks per SM "
            f"{family_counts.blocks_per_sm(int(k.max()), plan)} (the plan's "
            f"{plan.blocks_per_sm}); plan {plan}")
    return {"family_counts": row}      # the last shape: all candidates



# -- the language-model slice (nn + serve.engine.DecodeEngine) --------------


def _lm_config():
    from repro_torch.configs import get_config

    return get_config(LM_ARCH)


def _peak_gb():
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def lm_prefill_phase(dev):
    """``forward`` of zamba2-1.2b at full width and depth (random weights
    from ``torch.Generator`` seed 0 on the card) on B = LM_B prompts of
    LM_S tokens: on ``"cuda"`` (exactly n_layers ``ssd_scan`` and
    n_layers // hybrid_attn_every ``flash_attention`` launches), then on
    ``"einsum"`` (none); the argmax agrees at >= LM_ARGMAX_MIN of the
    positions, and every block and kernel launch agrees on the same input
    (:func:`_increment_check`).  Warm prefill tokens/s per backend (CUDA
    events, in turns einsum, cuda, cuda, einsum), peak memory, and a
    profiled forward.
    Returns (params, cfg, launch counts, largest kernel inputs)."""
    import torch

    from repro_torch.kernels import flash_attn, ssd_scan
    from repro_torch.nn import transformer as T

    cfg = _lm_config()
    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    log(f"lm {cfg.name}: {n_par} parameters ({cfg.n_params()} by "
        f"ModelConfig.n_params), fp32, built in "
        f"{time.perf_counter() - t0:.2f} s")
    toks = torch.randint(0, cfg.vocab, (LM_B, LM_S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    n_ssd = cfg.n_layers
    n_attn = cfg.n_layers // cfg.hybrid_attn_every
    fwd = {b: (lambda b=b: T.forward(params, toks, cfg, backend=b).logits)
           for b in ("cuda", "einsum")}
    rec = [_ShapeRecorder(mod, keep=lambda args: tuple(
        (tuple(a.shape), str(a.dtype).split(".")[-1]) for a in args
        if hasattr(a, "shape")) + tuple(a for a in args if isinstance(a, int)))
        for mod in (flash_attn, ssd_scan)]
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        cu, secs, launches = _counted(fwd["cuda"])
        peak = {"cuda": _peak_gb()}
        for r in rec:
            r.close()
        largest = {**rec[0].largest, **rec[1].largest}
        if (launches["ssd_scan"], launches["flash_attention"]) \
                != (n_ssd, n_attn):
            raise AssertionError(f"prefill on cuda launched {launches}, "
                                 f"expected {n_ssd} ssd_scan and {n_attn} "
                                 f"flash_attention")
        if any(v for k, v in launches.items()
               if k not in ("ssd_scan", "flash_attention")):
            raise AssertionError(f"prefill launched {launches}")
        total = dict(launches)
        torch.cuda.reset_peak_memory_stats()
        ei, _, ei_launches = _counted(fwd["einsum"])
        peak["einsum"] = _peak_gb()
        if any(ei_launches.values()):
            raise AssertionError(f"prefill on einsum launched {ei_launches}")
        if not (bool(torch.isfinite(cu).all())
                and cu.shape == (LM_B, LM_S, cfg.vocab)):
            raise AssertionError("prefill logits not finite or misshapen")
        agree = _agreement(cu, ei)
        diff = float((cu - ei).abs().max())
        top = float(ei.abs().max())
        top2 = ei.topk(2, -1).values
        ties = float((top2[..., 0] == top2[..., 1]).float().mean())
        del cu, top2
        half = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk=cfg.ssm.chunk // 2))
        floor = _agreement(T.forward(params, toks, half,
                                     backend="einsum").logits, ei)
        del ei
        log(f"lm prefill B={LM_B} S={LM_S}: launches cuda {launches} "
            f"(first forward {secs:.2f} s), einsum none; argmax agreement "
            f"{agree:.5f} (>= {LM_ARGMAX_MIN}); max |d logit| {diff:.4f} "
            f"beside max |logit| {top:.4f}; the plain path with SSD chunk "
            f"{half.ssm.chunk} (the same function, other fp32 roundings) "
            f"agrees with it at {floor:.5f}; exact top-2 ties in the bf16 "
            f"logits {ties:.5f}; peak GB cuda {peak['cuda']:.2f} einsum "
            f"{peak['einsum']:.2f}")
        if agree < LM_ARGMAX_MIN:
            raise AssertionError(f"prefill argmax agreement {agree} < "
                                 f"{LM_ARGMAX_MIN}")
        _increment_check(params, toks, cfg)
        few = dict(iters=2, warmup=1)
        ms = {b: [] for b in fwd}
        for b in ("einsum", "cuda", "cuda", "einsum"):
            ms[b].append(time_ms(fwd[b], **few))
        tps = {b: [round(LM_B * LM_S / (m / 1e3), 1) for m in ms[b]]
               for b in ms}
        log(f"lm prefill tokens/s (einsum, cuda, cuda, einsum order; "
            f"CUDA events, warm, 2 forwards each): cuda {tps['cuda']} "
            f"einsum {tps['einsum']}; ms cuda {ms['cuda']} einsum "
            f"{ms['einsum']}")
        for b in ("cuda", "einsum"):
            names = {}
            wall_us, busy, n, mine = _profiled(
                lambda: (fwd[b](), torch.cuda.synchronize()),
                LM_KERNEL_NAMES, names)
            each = {k: sum(v for nm, v in names.items() if k in nm)
                    for k in LM_KERNEL_NAMES}
            ssd = {re.search(r"ssd_scan_\w+", nm).group(0):
                   round(v / 1e3 / n_ssd, 4)
                   for nm, v in names.items() if "ssd_scan_" in nm}
            log(f"lm prefill profiled ({b}): wall {wall_us / 1e3:.2f} ms, "
                f"device busy {busy / 1e3:.2f} ms, idle share "
                f"{max(0.0, 1 - busy / wall_us):.3f}, {n} device ops, the "
                f"two kernels {mine / busy if busy else 0.0:.3f} of device "
                f"time (ms by kernel name prefix: "
                + ", ".join(f"{k}* {v / 1e3:.2f}" for k, v in each.items())
                + f"; ssd_scan's kernels, ms a launch: {ssd})")
    return params, cfg, total, largest


def _agreement(a, b):
    return float((a.argmax(-1) == b.argmax(-1)).float().mean())


def _tol_ratio(got, exp):
    """The largest |got - exp| over what its tolerance allows (<= 1
    passes), and the largest |got - exp|.  ``exp`` is the plain version in
    fp32; a bf16 ``got`` is allowed BF16_REL |exp| + BF16_MEAN mean |exp|
    (attention), an fp32 one ATTN_F32_TOL (1 + |exp|)."""
    import torch

    d = (got.float() - exp).abs()
    if got.dtype == torch.bfloat16:
        allow = BF16_REL * exp.abs() + BF16_MEAN * exp.abs().mean()
    else:
        allow = ATTN_F32_TOL * (1 + exp.abs())
    return float((d / allow).max()), float(d.max())


def _attn_plain(q, k, v, window, causal=True, q_offset=0):
    from repro_torch.nn import attention as A

    return A.attention_blockwise(q.float(), k.float(), v.float(),
                                 causal=causal, window=window,
                                 q_offset=q_offset)


def _attn_tile(D):
    """Keys per kv tile of the bf16 attention kernel at head dim ``D``."""
    from repro_torch.kernels import flash_attn

    return flash_attn.tile_plan(D)[1]


def _attn_wrong(q, k, v, window, causal=True):
    """Known-wrong: the window one kv tile short (a kernel that dropped the
    window's oldest tile)."""
    w = (window or q.shape[1]) - _attn_tile(q.shape[3])
    return _attn_plain(q, k, v, w, causal).to(q.dtype)


def _ssd_ratio(got, exp):
    """The largest |d| of (y, h_final) over SSD_RTOL (|exp| + max |exp|)."""
    return max(float(((g - e).abs() / (SSD_RTOL * (e.abs() + e.abs().max())))
                     .max()) for g, e in zip(got, exp))


def _ssd_chunk_local(x, dt, A, B, C, chunk):
    """Known-wrong: every chunk scanned alone (the state not carried)."""
    from repro_torch.nn import ssm as S

    b, L = x.shape[:2]
    n = L // chunk

    def fold(t):
        return t.reshape(b * n, chunk, *t.shape[2:])

    y, h = S.ssd_chunked(fold(x), fold(dt), A, fold(B), fold(C), chunk)
    return y.reshape(x.shape), h.reshape(b, n, *h.shape[1:])[:, -1]


def _inc_rel(a, b):
    """mean |a - b| / mean |b|: a sublayer's increment on two backends."""
    return float((a.float() - b.float()).abs().mean() / b.float().abs().mean())


def _pad_keys(t, tile):
    """[B, S, H, D] padded with zero rows to a multiple of ``tile`` in S."""
    import torch.nn.functional as Fnn

    return Fnn.pad(t, (0, 0, 0, 0, 0, -t.shape[1] % tile))


def _attn_causal_encoder(q, k, v, window, causal):
    """Known-wrong for a non-causal call: a causal mask."""
    return None if causal else _attn_plain(q, k, v, window).to(q.dtype)


def _attn_unmasked_tail(q, k, v, window, causal):
    """Known-wrong for a non-causal call whose Sk is not a multiple of the kv
    tile: the last partial tile left unmasked (zero keys and values to the
    tile's end, attended)."""
    tile = _attn_tile(q.shape[3])
    if causal or k.shape[1] % tile == 0:
        return None
    return _attn_plain(q, _pad_keys(k, tile), _pad_keys(v, tile), window,
                       causal).to(q.dtype)


def _attn_window_short(q, k, v, window, causal):
    """Known-wrong for a causal call: :func:`_attn_wrong`."""
    return _attn_wrong(q, k, v, window) if causal else None


def _attn_mask_dropped(q, k, v, window, causal):
    """Known-wrong for a causal call: no causal mask."""
    return _attn_plain(q, k, v, window, False).to(q.dtype) if causal \
        else None


def _attn_kind(q, k, causal, window):
    B, Sq, Hq, D = q.shape
    return (f"{'causal' if causal else 'non-causal'} window={window} "
            f"q[{B}, {Sq}, {Hq}, {D}] k[{k.shape[1]}, {k.shape[2]}] "
            f"{str(q.dtype).split('.')[-1]}")


class _AttnWatch:
    """While open, each ``flash_attention`` call launches the kernel and is
    held against its plain version on the same inputs (:func:`_tol_ratio`),
    and each known-wrong variant in ``wrong`` (name -> fn(q, k, v, window,
    causal), None where it does not apply) is measured by the same bar; by
    the call's kind (:func:`_attn_kind`).  :meth:`check` fails on a launch
    over its bar, a variant under it, or a variant never measured."""

    def __init__(self, wrong):
        self.wrong, self.ratios, self.bad = wrong, {}, {}

    def __enter__(self):
        from repro_torch.kernels import flash_attn

        self._mod, self._fa = flash_attn, flash_attn.flash_attention
        flash_attn.flash_attention = self._call
        return self

    def __exit__(self, *exc):
        self._mod.flash_attention = self._fa

    def _call(self, q, k, v, *, causal=True, window=None, **kw):
        out = self._fa(q, k, v, causal=causal, window=window, **kw)
        exp = _attn_plain(q, k, v, window, causal)
        kind = _attn_kind(q, k, causal, window)
        self.ratios.setdefault(kind, []).append(_tol_ratio(out, exp))
        for name, fn in self.wrong.items():
            w = fn(q, k, v, window, causal)
            if w is not None:
                self.bad.setdefault(name, {}).setdefault(kind, []).append(
                    _tol_ratio(w, exp)[0])
        return out

    def check(self, what):
        for kind, r in self.ratios.items():
            worst = max(a for a, _ in r)
            log(f"{what}: flash_attention {kind} on the path's activations "
                f"({len(r)} launches): |d| over its tolerance worst "
                f"{worst:.3e} (<= 1), max |d| {max(e for _, e in r):.3e}")
            if worst > 1:
                raise AssertionError(f"{what}: flash_attention {kind} "
                                     f"disagrees with its plain version")
        for name in self.wrong:
            if name not in self.bad:
                raise AssertionError(f"{what}: known-wrong variant {name!r} "
                                     f"was never measured")
            for kind, b in self.bad[name].items():
                log(f"{what}: known-wrong variant ({name}) at {kind}: least "
                    f"{min(b):.3e} (> 1)")
                if min(b) <= 1:
                    raise AssertionError(f"{what}: flash_attention's bar does "
                                         f"not separate {name!r} at {kind}")


def _check_increments(what, incs, bad):
    """Each sublayer's increments on the two backends within INC_REL_MAX,
    each known-wrong variant's beyond it."""
    for kind in incs:
        v, w = incs[kind], bad[kind]
        log(f"{what} increments, {kind} ({len(v)} blocks, same input to "
            f"both backends): mean |d| / mean |inc| worst {max(v):.3e} "
            f"median {sorted(v)[len(v) // 2]:.3e} (<= {INC_REL_MAX:.3e}); "
            f"known-wrong variant least {min(w):.3e}")
        if max(v) > INC_REL_MAX:
            raise AssertionError(f"{what}: a {kind} increment differs "
                                 f"between the backends by {max(v)}")
        if min(w) <= INC_REL_MAX:
            raise AssertionError(f"{what}: the {kind} increment bar does not "
                                 f"separate a known-wrong variant")


def _increment_check(params, toks, cfg):
    """Each of the blocks (38 Mamba2, 6 shared attention) on the plain
    path's own activations.  (1) The sublayer that holds a kernel
    (``apply_mamba2``, ``attention_block``) gives its increment on both
    backends from the same input, and the two agree within one bf16
    rounding: mean |d| / mean |inc| <= INC_REL_MAX.  (2) Every kernel
    launch inside those calls is held against its plain version on the
    inputs the block fed it (:class:`_AttnWatch`, :func:`_ssd_ratio`).
    (3) Known-wrong variants of the plain path -- attention's window one kv
    tile short, the Mamba2 block run on each chunk alone -- are measured by
    the same two yardsticks and must fail both, so the bars are shown to
    separate a wrong kernel from a right one on every run."""
    import torch

    from repro_torch.kernels import ssd_scan
    from repro_torch.nn import layers as L
    from repro_torch.nn import ssm as Sm
    from repro_torch.nn import transformer as T

    ssd, wrong_ssd = [], []

    def ssd_watch(*args):
        out = ss(*args)
        exp = Sm.ssd_chunked(*args)
        ssd.append((_ssd_ratio(out, exp),
                    float((out[0] - exp[0]).abs().max())))
        wrong_ssd.append(_ssd_ratio(_ssd_chunk_local(*args), exp))
        return out

    eps, chunk = cfg.norm_eps, min(cfg.ssm.chunk, toks.shape[1])
    short = dataclasses.replace(cfg, sliding_window=cfg.sliding_window
                                - _attn_tile(cfg.head_dim_))

    def mamba(p, xn, b):
        return Sm.apply_mamba2(p["mamba"], xn, cfg.d_model, cfg.ssm, eps,
                               backend=b)

    def mamba_chunk_local(p, xn):
        B_, S_, d = xn.shape
        return mamba(p, xn.reshape(B_ * S_ // chunk, chunk, d),
                     "einsum").reshape(xn.shape)

    def attn(p, xn, b, c=cfg):
        return T.attention_block(p["attn"], xn, c, window=c.sliding_window,
                                 backend=b)

    incs, wrong_incs = {"mamba": [], "attention": []}, \
        {"mamba": [], "attention": []}
    ss = ssd_scan.ssd_scan
    ssd_scan.ssd_scan = ssd_watch
    try:
        with _AttnWatch({"window one kv tile short":
                         _attn_window_short}) as watch:
            x = L.embed(params["embed"], toks)
            for i, p in enumerate(params["blocks"]):
                xn = L.rmsnorm(p["ln"], x, eps)
                ei = mamba(p, xn, "einsum")
                incs["mamba"].append(_inc_rel(mamba(p, xn, "cuda"), ei))
                wrong_incs["mamba"].append(_inc_rel(mamba_chunk_local(p, xn),
                                                    ei))
                x = x + ei                  # mamba_block on the plain path
                if (i + 1) % cfg.hybrid_attn_every == 0:
                    p = params["shared_attn"]
                    xn = L.rmsnorm(p["ln1"], x, eps)
                    ei = attn(p, xn, "einsum")
                    incs["attention"].append(_inc_rel(attn(p, xn, "cuda"),
                                                      ei))
                    wrong_incs["attention"].append(
                        _inc_rel(attn(p, xn, "einsum", short), ei))
                    x = T.dense_block(p, x, cfg, "einsum")
    finally:
        ssd_scan.ssd_scan = ss
    torch.cuda.synchronize()
    _check_increments("lm prefill", incs, wrong_incs)
    watch.check("lm prefill")
    r = [a for a, _ in ssd]
    log(f"lm ssd_scan on the path's activations ({len(r)} launches): |d| "
        f"over its tolerance worst {max(r):.3e} (<= 1), max |d| "
        f"{max(e for _, e in ssd):.3e}; known-wrong variant least "
        f"{min(wrong_ssd):.3e}")
    if max(r) > 1:
        raise AssertionError("ssd_scan disagrees with its plain version on "
                             "the path's activations")
    if min(wrong_ssd) <= 1:
        raise AssertionError("ssd_scan's tolerance does not separate a "
                             "known-wrong variant")


def lm_serving_phase(params, cfg, dev):
    """``DecodeEngine`` (SERVE_SLOTS slots, capacity SERVE_CAPACITY) serves
    SERVE_REQUESTS greedy requests of 4-12 prompt tokens and SERVE_NEW new
    tokens each, as ``launch.serve`` drives it (decode runs no kernel);
    then a DECODE_S-token prompt teacher-forced through ``decode_step``
    agrees with the ``"cuda"`` forward's argmax at > DECODE_ARGMAX_MIN of
    positions.  Returns the launch counts of that forward."""
    import torch

    from repro_torch.nn import transformer as T
    from repro_torch.serve.engine import DecodeEngine, Request

    rng = np.random.default_rng(0)
    eng = DecodeEngine(params, cfg, batch=SERVE_SLOTS,
                       capacity=SERVE_CAPACITY)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, rng.integers(4, 12)).tolist(), max_new=SERVE_NEW)
        for i in range(SERVE_REQUESTS)]
    for r in reqs:
        eng.submit(r)

    def drain():
        steps = 0
        while eng.step() or eng.queue:
            steps += 1
        return steps

    steps, secs, launches = _counted(drain)
    if any(launches.values()):
        raise AssertionError(f"decode launched {launches}")
    if not all(r.done and len(r.out) == SERVE_NEW for r in reqs):
        raise AssertionError("DecodeEngine left requests unserved")
    n_tok = SERVE_REQUESTS * SERVE_NEW
    log(f"lm serving: DecodeEngine batch={SERVE_SLOTS} capacity="
        f"{SERVE_CAPACITY}, {SERVE_REQUESTS} requests x {SERVE_NEW} new "
        f"tokens in {steps + 1} steps, {secs:.3f} s: {n_tok / secs:.1f} "
        f"generated tokens/s (host clock, greedy)")

    toks = torch.randint(0, cfg.vocab, (1, DECODE_S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    with torch.no_grad():
        fwd, _, launches = _counted(
            lambda: T.forward(params, toks, cfg).logits[0])
        if not (launches["ssd_scan"] and launches["flash_attention"]):
            raise AssertionError(f"decode check's forward launched "
                                 f"{launches}")

        def teacher_forced():
            st = T.init_decode_state(params, cfg, 1, capacity=DECODE_S)
            out = []
            for t in range(DECODE_S):
                lg, st = T.decode_step(params, st, toks[:, t:t + 1], cfg)
                out.append(lg[0, 0])
            return torch.stack(out)

        dec, secs, dec_launches = _counted(teacher_forced)
    if any(dec_launches.values()):
        raise AssertionError(f"decode launched {dec_launches}")
    match = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    diff = float((dec - fwd).abs().max())
    if not match > DECODE_ARGMAX_MIN:
        raise AssertionError(f"decode vs prefill argmax match {match} <= "
                             f"{DECODE_ARGMAX_MIN}")
    log(f"lm decode vs cuda prefill, {DECODE_S} teacher-forced tokens: "
        f"argmax match {match:.4f} (> {DECODE_ARGMAX_MIN}), max |d logit| "
        f"{diff:.4f} beside max |logit| {float(fwd.abs().max()):.4f}; "
        f"{DECODE_S / secs:.1f} decode steps/s at B=1; the forward "
        f"launched {launches}")

    st = T.init_decode_state(params, cfg, SERVE_SLOTS, SERVE_CAPACITY)
    tok = toks[:, :1].expand(SERVE_SLOTS, 1).contiguous()

    def steps4():
        nonlocal st
        with torch.no_grad():
            for _ in range(4):
                _, st = T.decode_step(params, st, tok, cfg)
        torch.cuda.synchronize()

    steps4()
    wall_us, busy, n, _ = _profiled(steps4, ())
    log(f"lm decode profiled (4 steps at B={SERVE_SLOTS}): wall "
        f"{wall_us / 4e3:.2f} ms a step, device busy {busy / 4e3:.2f} ms a "
        f"step, idle share {max(0.0, 1 - busy / wall_us):.3f}, {n / 4:.0f} "
        f"device ops a step")
    return launches


def _attn_mask(dev, Sq, Sk, causal, window, q_offset=0):
    """The boolean mask of the live (q, k) pairs (query i at position
    q_offset + i), or None where every pair is live."""
    import torch

    if not causal and window is None:
        return None
    qp = q_offset + torch.arange(Sq, device=dev)[:, None]
    kp = torch.arange(Sk, device=dev)[None, :]
    mask = (kp <= qp) if causal else torch.ones_like(kp > qp)
    return mask & (kp > qp - window) if window is not None else mask


def _attn_case(dev, g, qs, ks, dtype, window, causal, wrong, sdpa, few,
               q_offset=0, entry=False):
    """``flash_attention`` at q shape ``qs``, k/v shape ``ks`` on random
    inputs (query i at position ``q_offset + i``): two launches the same
    bits, against the plain version in fp32 (:func:`_tol_ratio` <= 1) with
    the known-wrong variant ``wrong`` failing that bar, timed (CUDA events)
    beside the plain version, the bound over the unmasked pairs
    (``flash_attn.attention_flops`` at the bf16 peak, or at split TF32's
    on fp32 inputs: the least time for fp32-accurate products) and, with
    ``sdpa``, one ``scaled_dot_product_attention`` call (k and v expanded
    to the q heads beforehand, the mask as a boolean where there is one).
    With ``entry`` the first launch is the entry point's run with the
    counts set to 0 (one launch on the input's route, nothing else), and
    the row's launches are that run's.  Returns the kernel row and logs the
    case."""
    import torch
    import torch.nn.functional as Fnn

    from repro_torch.kernels import flash_attn
    from repro_torch.nn import attention as A

    B, Sq, Hq, D = qs
    Sk, Hkv = ks[1], ks[2]
    dt = getattr(torch, dtype)
    q = torch.randn(qs, generator=g, device=dev).to(dt)
    k = torch.randn(ks, generator=g, device=dev).to(dt)
    v = torch.randn(ks, generator=g, device=dev).to(dt)
    kern = lambda: flash_attn.flash_attention(q, k, v, causal=causal,
                                              window=window,
                                              q_offset=q_offset)
    plain = lambda: A.attention_blockwise(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset)
    launches = 0
    if entry:
        got, _, counted = _counted(kern)
        routes, launches = dict(flash_attn.ROUTES), counted["flash_attention"]
        route = "bf16_wgmma" if dtype == "bfloat16" else "f32_tf32x3"
        if launches != 1 or routes[route] != 1 or any(
                n for name, n in counted.items() if name != "flash_attention"):
            raise AssertionError(f"flash_attention {dtype} q{qs} k{ks}: the "
                                 f"entry point's launches {counted}, routes "
                                 f"{routes}")
        again = kern()
    else:
        got, again = kern(), kern()
    exp = _attn_plain(q, k, v, window, causal, q_offset)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"flash_attention {dtype} q{qs} k{ks}: two "
                             f"launches differ")
    ratio, err = _tol_ratio(got, exp)
    bad = _tol_ratio(wrong(q, k, v, window, causal), exp)[0]
    top, mean = float(exp.abs().max()), float(exp.abs().mean())
    del got, again, exp
    if ratio > 1 or bad <= 1:
        raise AssertionError(f"flash_attention {dtype} q{qs} k{ks} window="
                             f"{window} causal={causal}: |d| over its "
                             f"tolerance {ratio}, the known-wrong variant's "
                             f"{bad}")
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    nops = flash_attn.attention_flops(B, Sq, Sk, Hq, D, causal, window,
                                      q_offset)
    b_ms, b_by = bound(nbytes, nops, BF16_OPS_PER_S if dtype == "bfloat16"
                       else SPLIT_TF32_OPS_PER_S)
    row = dict(name="flash_attention", route="cuda", source=FA_SOURCE,
               replaces=REPLACES["flash_attention"], launches=launches,
               max_abs_err=err, ms=time_ms(kern, **few),
               plain_ms=time_ms(plain, **few), bound_ms=b_ms, bound_by=b_by,
               library_ms=None)
    if sdpa:
        heads = torch.arange(Hq, device=dev) % Hkv     # q head h: kv h % Hkv
        kx, vx = (t[:, :, heads].transpose(1, 2) for t in (k, v))
        mask = _attn_mask(dev, Sq, Sk, causal, window, q_offset) \
            if causal else None
        qx = q.transpose(1, 2)
        row["library_ms"] = time_ms(
            lambda: Fnn.scaled_dot_product_attention(qx, kx, vx,
                                                     attn_mask=mask), **few)
        del kx, vx
    tol = (f"{BF16_REL:.4g} |exp| + {BF16_MEAN:.4g} mean |exp|"
           if dtype == "bfloat16" else f"{ATTN_F32_TOL} (1 + |exp|)")
    kind = ("causal" if causal else "non-causal") + (
        f" q_offset={q_offset}" if q_offset else "")
    log(f"kernel flash_attention {dtype} {kind} window={window} at q [B={B}, "
        f"Sq={Sq}, Hq={Hq}, D={D}], k/v [Sk={Sk}, Hkv={Hkv}]: against the "
        f"plain version in fp32, max_abs_err {err:.3e} beside max |exp| "
        f"{top:.4f} and mean |exp| {mean:.4f}; |d| <= {tol} holds with ratio "
        f"{ratio:.3f} (the known-wrong variant: {bad:.2f}), bitwise "
        f"repeatable; ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
        f"sdpa_ms {row['library_ms']} bound_ms {b_ms:.4f} ({b_by}, peak for "
        f"{dtype}); {nops / row['ms'] / 1e9:.1f} TFLOP/s over the unmasked "
        f"pairs, {b_ms / row['ms']:.3f} of the bound")
    return row


def lm_kernel_phase(dev, largest):
    """``flash_attention`` and ``ssd_scan`` at the largest shapes the
    prefill launched, against their plain versions on the card (attention
    also with no window and on fp32 inputs), two launches the same bits,
    timed against the plain version, the bound and (attention) one
    ``scaled_dot_product_attention`` call with a boolean causal-and-window
    mask.  The rows are the path's own calls: bf16 attention with the
    config's window, the fp32 SSD scan."""
    import torch
    import torch.nn.functional as Fnn

    from repro_torch.kernels import ssd_scan
    from repro_torch.nn import ssm as S

    cfg = _lm_config()
    g = torch.Generator(device=dev).manual_seed(7)
    rows = {}
    (qs, _), (ks, _), _ = largest["flash_attention"]
    few = dict(iters=3, warmup=1)
    for dtype, window in (("float32", None), ("float32", cfg.sliding_window),
                          ("bfloat16", None),
                          ("bfloat16", cfg.sliding_window)):
        path = dtype == "bfloat16" and window == cfg.sliding_window
        row = _attn_case(dev, g, qs, ks, dtype, window, True, _attn_wrong,
                         path, few)
        if path:                              # the path's own call
            rows["flash_attention"] = row

    shapes = largest["ssd_scan"]
    (xs, _), (dts, _), (As, _), (Bs, _), _, chunk = shapes
    b, Sl, H, P = xs
    N = Bs[3]
    x = torch.randn(xs, generator=g, device=dev)
    dt = Fnn.softplus(torch.randn(dts, generator=g, device=dev) - 4.0)
    Av = torch.exp(torch.linspace(0.0, 2.77, H, device=dev))
    Bm = torch.randn(Bs, generator=g, device=dev)
    Cm = torch.randn(Bs, generator=g, device=dev)
    kern = lambda: ssd_scan.ssd_scan(x, dt, Av, Bm, Cm, chunk)
    plain = lambda: S.ssd_chunked(x, dt, Av, Bm, Cm, chunk)
    got, again, exp = kern(), kern(), plain()
    torch.cuda.synchronize()
    if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
        raise AssertionError("ssd_scan: two launches differ")
    ratio = _ssd_ratio(got, exp)
    wrong = _ssd_ratio(_ssd_chunk_local(x, dt, Av, Bm, Cm, chunk), exp)
    err = max(float((a_ - e_).abs().max()) for a_, e_ in zip(got, exp))
    del got, again, exp
    if ratio > 1 or wrong <= 1:
        raise AssertionError(f"ssd_scan: |d| over its tolerance {ratio}, "
                             f"the known-wrong variant's {wrong}")
    nops = ssd_scan.ssd_flops(b, Sl, H, P, Bs[2], N, chunk)
    nbytes = 4 * (2 * x.numel() + dt.numel() + H + 2 * Bm.numel()
                  + b * H * P * N)
    b_ms, b_by = bound(nbytes, nops, SPLIT_TF32_OPS_PER_S)
    rows["ssd_scan"] = dict(
        name="ssd_scan", route="cuda", source=SSD_SOURCE,
        replaces=REPLACES["ssd_scan"], launches=0, max_abs_err=err,
        ms=time_ms(kern, **few), plain_ms=time_ms(plain, **few),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    r = rows["ssd_scan"]
    log(f"kernel ssd_scan at [b={b}, S={Sl}, H={H}, P={P}, N={N}, chunk="
        f"{chunk}]: max_abs_err {err:.3e}; |d| <= {SSD_RTOL} (|exp| + "
        f"max |exp|) holds with ratio {ratio:.4f} (each chunk alone: "
        f"{wrong:.1f}), bitwise repeatable; ms {r['ms']:.4f} "
        f"plain_ms {r['plain_ms']:.4f} bound_ms {b_ms:.4f} ({b_by}; "
        f"{nops / 1e9:.2f} GFLOP at {SPLIT_TF32_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s, {nbytes / 1e6:.1f} MB); blocks per SM "
        f"{ssd_scan.blocks_per_sm(chunk, N)}")
    return rows


# -- temporal models (pgm_models.dynamic) -------------------------------------


def _hmm_params(S, F, seed):
    """Sticky transitions and well-separated emission means, as
    ``synthetic.hmm_sequences`` draws them."""
    rng = np.random.default_rng(seed)
    trans = 0.2 * rng.dirichlet(np.ones(S) * 0.3, size=S) + 0.8 * np.eye(S)
    means = np.arange(S)[:, None] * 4.0 + rng.uniform(-1, 1, (S, F))
    return trans.astype(np.float32), means.astype(np.float32)


def _sample_hmm(g, dev, B, T, trans, means, inputs=False):
    """[B, T, F] sequences of a Gaussian-emission HMM (noise 0.5), sampled
    on the card; with ``inputs`` an exogenous input column u is appended
    and the emissions move by 1.5 u (the IO-HMM's data)."""
    import torch

    S, F = means.shape
    cdf = torch.cumsum(torch.as_tensor(trans, device=dev), -1)
    mu = torch.as_tensor(means, device=dev)
    u = torch.rand(B, T, generator=g, device=dev)
    z = torch.randint(0, S, (B,), generator=g, device=dev)
    zs = []
    for t in range(T):
        zs.append(z)
        z = torch.clamp((u[:, t, None] > cdf[z]).sum(-1), max=S - 1)
    x = mu[torch.stack(zs, 1)] + 0.5 * torch.randn(B, T, F, generator=g,
                                                   device=dev)
    if not inputs:
        return x
    inp = torch.randn(B, T, generator=g, device=dev)
    return torch.cat([x + 1.5 * inp[..., None], inp[..., None]], -1)


def _sample_lds(g, dev, B, T, A_of_t, C, q_std, r_std):
    """[B, T, F] of h_t = A_t h_{t-1} + q_std w, x_t = C h_t + r_std v,
    sampled on the card."""
    import torch

    C = torch.as_tensor(C, device=dev)
    L = C.shape[1]
    h = torch.randn(B, L, generator=g, device=dev)
    xs = []
    for t in range(T):
        A = torch.as_tensor(A_of_t(t), device=dev)
        h = h @ A.T + q_std * torch.randn(B, L, generator=g, device=dev)
        xs.append(h @ C.T + r_std * torch.randn(B, C.shape[0], generator=g,
                                                device=dev))
    return torch.stack(xs, 1)


def _seq(xc):
    import torch

    from repro_torch.data.stream import SequenceBatch

    return SequenceBatch(xc, None, torch.ones(xc.shape[:2], device=xc.device))


def _attrs(n):
    from repro_torch.data.stream import Attribute, REAL

    return [Attribute(f"G{i}", REAL) for i in range(n)]


def clg_seq_check(label, d, y, r):
    """``clg_seq_suffstats`` against its plain version on the flattened
    views, one launch a call, twice for the same bits, timed beside the
    plain version, the library einsum over u = [d, y] and the least time
    the card could take; stage 1 and stage 2 profiled apart."""
    import torch

    from repro_torch.kernels import clg_stats, ref

    B, T, F, D = d.shape
    K, n = r.shape[-1], B * T
    kern = lambda: clg_stats.clg_seq_suffstats(d, y, r)
    d2, y2, r2 = d.view(n, F, D), y.view(n, F), r.view(n, K)
    plain = lambda: ref.clg_suffstats_ref(d2, y2, r2)
    u = torch.cat([d2, y2[..., None]], -1)
    library = lambda: torch.einsum("nfa,nfb,nk->fkab", u, u, r2)
    before = clg_stats.LAUNCHES["clg_seq_suffstats"]
    got, again = kern(), kern()
    torch.cuda.synchronize()
    if clg_stats.LAUNCHES["clg_seq_suffstats"] - before != 2:
        raise AssertionError(f"clg_seq_suffstats at {label}: not one launch "
                             f"a call")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"clg_seq_suffstats at {label}: two launches "
                             f"differ in bits")
    err = compare(got, plain())
    b_ms, b_by = bound(4 * (n * (F * D + F + K) + F * K * (D * D + D + 1)),
                       n * F * K * 3 * (D * D + D + 1))
    ms, plain_ms, library_ms = time_ms(kern), time_ms(plain), time_ms(library)
    split = _stage_ms(kern, CLG_STAGES, b_ms)
    log(f"kernel clg_seq_suffstats at {label} (d {tuple(d.shape)}, r "
        f"{tuple(r.shape)}): max_abs_err {err:.3e} (rtol {KERNEL_RTOL}, atol "
        f"{KERNEL_ATOL_REL}*max|plain|), bitwise repeatable, one launch a "
        f"call; ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); a call (profiled, "
        f"each stage's kernels counted): stage 1 {split['stage 1']:.4f} ms, "
        f"stage 2 {split['stage 2']:.4f} ms; "
        f"{'LOSES to' if ms > library_ms else 'beats'} the library call")


def _close_fits(name, cu, ei):
    """ELBOs within TEMPORAL_ELBO_REL (1 + |e|), the parameter within
    FIT_TOL_REL (1 + max|p|): the two backends' fits."""
    e_err = abs(cu["elbo"] - ei["elbo"])
    e_tol = TEMPORAL_ELBO_REL * (1.0 + abs(ei["elbo"]))
    p_err = float((cu["param"] - ei["param"]).abs().max())
    p_tol = FIT_TOL_REL * (1.0 + float(ei["param"].abs().max()))
    if not (e_err <= e_tol and p_err <= p_tol):
        raise AssertionError(f"{name}: cuda and einsum fits differ: elbo "
                             f"{e_err:.4g} (tol {e_tol:.4g}), means "
                             f"{p_err:.4g} (tol {p_tol:.4g})")
    return (f"|elbo_cuda-elbo_einsum| {e_err:.4g} (tol {e_tol:.4g}), "
            f"|m_cuda-m_einsum| {p_err:.3e} (tol {p_tol:.3e})")


def _profile_steps(run, sweeps):
    """A profiled call of ``run`` (``sweeps`` sweeps): wall and busy ms a
    sweep, the idle share and device ops a sweep."""
    import torch

    torch.cuda.synchronize()
    wall_us, busy, n, mine = _profiled(
        run, ("moments_tile", "moments_rows", "moments_reduce"))
    return dict(sweep_ms=wall_us / sweeps / 1e3,
                device_busy_ms=busy / sweeps / 1e3,
                idle_share=max(0.0, 1.0 - busy / wall_us),
                device_ops_per_sweep=n / sweeps,
                kernel_share_of_device=mine / busy if busy else 0.0)


def temporal_phase(dev, card):
    """Phase 12: the temporal models at the static streams' scale (B = 2^14
    sequences x T = 64 frames a batch).  Returns the launch counts of the
    cuda-backend runs."""
    import torch

    from repro_torch.kernels import clg_stats
    from repro_torch.pgm_models import dynamic as dyn
    from repro_torch.serve.engine import PGMQueryEngine

    t_phase = time.perf_counter()
    laps = {}

    def lap(label):
        laps[label] = round(time.perf_counter() - t_phase - sum(laps.values()),
                            2)

    B, T, F, S = TEMPORAL_B, TEMPORAL_T, TEMPORAL_F, TEMPORAL_S
    g = torch.Generator(device=dev).manual_seed(0)
    total = {}

    # (1) the kernel at the HMM's (D = 1) and the AR-HMM's (D = 2) shapes
    for D, label in ((1, "the HMM M-step"), (2, "the AR-HMM M-step")):
        d = torch.randn(B, T, F, D, generator=g, device=dev)
        y = torch.randn(B, T, F, generator=g, device=dev)
        r = torch.softmax(torch.randn(B, T, S, generator=g, device=dev), -1)
        clg_seq_check(f"{label} (B = {B}, T = {T})", d, y, r)
        del d, y, r

    lap("kernel checks")
    trans, means = _hmm_params(S, F, 1)
    xc = _sample_hmm(g, dev, B, T, trans, means)
    xio = _sample_hmm(g, dev, B, T, trans, means, inputs=True)

    def fit(make, data, backend):
        model = make(backend)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e, secs, launches = _counted(
            lambda: model.update_model(data, sweeps=SWEEPS, tol=0.0))
        _add(total, launches, f"temporal {backend}", backend)
        return dict(model=model, elbo=e, seconds=secs, launches=launches,
                    peak_gb=_peak_gb(), seq_per_s=B / secs,
                    frames_per_s=B * T / secs)

    # (2) the HMM family at full size, einsum, cuda, cuda, einsum
    cases = (("HiddenMarkovModel", dyn.HiddenMarkovModel, xc, F),
             ("AutoRegressiveHMM", dyn.AutoRegressiveHMM, xc, F),
             ("InputOutputHMM", dyn.InputOutputHMM, xio, F + 1))
    fitted = {}
    for name, cls, x, n_attr in cases:
        make = lambda backend: cls(_attrs(n_attr), n_states=S, seed=0,
                                   device=dev, backend=backend)
        data = _seq(x)
        # warm-up of both backends on 256 sequences (library handles, the
        # allocator, first launches), outside every timed and counted run
        for backend in ("cuda", "einsum"):
            make(backend).update_model(_seq(x[:256]), sweeps=1, tol=0.0)
        runs = {"cuda": [], "einsum": []}
        for backend in ("einsum", "cuda", "cuda", "einsum"):
            runs[backend].append(fit(make, data, backend))
        for r_ in runs["cuda"]:
            per_sweep = r_["launches"]["clg_seq_suffstats"] / SWEEPS
            others = sum(v for k, v in r_["launches"].items()
                         if k != "clg_seq_suffstats")
            if per_sweep != 1 or others:
                raise AssertionError(f"{name}: {r_['launches']} on cuda, "
                                     f"expected one clg_seq_suffstats a "
                                     f"sweep")
        cu, ei = runs["cuda"][0], runs["einsum"][0]
        for r_ in (cu, ei):
            r_["param"] = r_["model"].posterior.emis.m[:, :, 0]
            if not math.isfinite(r_["elbo"]):
                raise AssertionError(f"{name}: elbo {r_['elbo']}")
        agree = _close_fits(name, cu, ei)
        prof = {}
        for b in ("cuda", "einsum"):
            m = runs[b][0]["model"]
            xb = _seq(x)
            d, y = m._design(xb.xc), m._emission_target(xb.xc)
            prof[b] = _profile_steps(lambda: dyn._hmm_fit(
                m._chained_prior, m.posterior, d, y, xb.mask, sweeps=2,
                tol=0.0, backend=b), 2)
        log(f"temporal {name}: B={B} x T={T}, F={F}, S={S}, {SWEEPS} "
            f"sweeps; elbo cuda {cu['elbo']:.8g} einsum {ei['elbo']:.8g}; "
            f"{agree}; launches (cuda) {cu['launches']['clg_seq_suffstats']}")
        log(f"temporal {name}: seq/s (einsum, cuda, cuda, einsum) "
            f"{runs['einsum'][0]['seq_per_s']:.1f} "
            f"{runs['cuda'][0]['seq_per_s']:.1f} "
            f"{runs['cuda'][1]['seq_per_s']:.1f} "
            f"{runs['einsum'][1]['seq_per_s']:.1f}; frames/s "
            f"{runs['einsum'][0]['frames_per_s']:.0f} "
            f"{runs['cuda'][0]['frames_per_s']:.0f} "
            f"{runs['cuda'][1]['frames_per_s']:.0f} "
            f"{runs['einsum'][1]['frames_per_s']:.0f}; peak GB cuda "
            f"{cu['peak_gb']:.3f} einsum {ei['peak_gb']:.3f}; profiled "
            f"sweep {prof}; card {card}")
        fitted[name] = cu["model"]

    lap("HMM family")
    # (3) the factorial HMM: C launches a sweep on cuda.  Its numerators
    # sum 2^20 frames a (chain, state): the einsum backend's batched matmul
    # is off by up to ~2e-3 of such a sum, the kernel by ~1e-7
    # (probes/fhmm_sums.py), so the cuda fit is held against the plain
    # sweeps in float64
    C, S2 = FHMM_C, FHMM_S
    make = lambda backend: dyn.FactorialHMMModel(
        _attrs(F), n_chains=C, n_states=S2, seed=0, device=dev,
        backend=backend)
    runs = {b: fit(make, _seq(xc), b) for b in ("einsum", "cuda")}
    cu, ei = runs["cuda"], runs["einsum"]
    if cu["launches"]["clg_seq_suffstats"] != C * SWEEPS:
        raise AssertionError(f"FactorialHMMModel: {cu['launches']} on cuda,"
                             f" expected {C} clg_seq_suffstats a sweep")
    m0 = make("einsum")
    f64 = lambda a: a.double()
    means64, _, _, e64, _ = dyn._fhmm_fit(
        (f64(m0.means), f64(m0.log_trans),
         torch.full((B, T, C, S2), 1.0 / S2, device=dev,
                    dtype=torch.float64)),
        f64(m0.log_init), f64(m0.noise), f64(xc),
        torch.ones(B, T, device=dev, dtype=torch.float64), sweeps=SWEEPS,
        tol=0.0, backend="einsum")
    e_tol = TEMPORAL_ELBO_REL * (1.0 + abs(e64))
    m_tol = FIT_TOL_REL * (1.0 + float(means64.abs().max()))
    errs = {b: (abs(r_["elbo"] - e64),
                float((r_["model"].means.double() - means64).abs().max()))
            for b, r_ in runs.items()}
    log(f"temporal FactorialHMMModel: C={C}, S={S2}, {SWEEPS} sweeps; elbo "
        f"cuda {cu['elbo']:.8g} einsum {ei['elbo']:.8g} float64 {e64:.8g};"
        f" |elbo - elbo64|, |means - means64|: cuda {errs['cuda'][0]:.4g},"
        f" {errs['cuda'][1]:.3e}, einsum {errs['einsum'][0]:.4g}, "
        f"{errs['einsum'][1]:.3e} (tol {e_tol:.4g}, {m_tol:.3e}; held for "
        f"cuda); seq/s einsum {ei['seq_per_s']:.1f} cuda "
        f"{cu['seq_per_s']:.1f}; launches (cuda) "
        f"{cu['launches']['clg_seq_suffstats']}; peak GB cuda "
        f"{cu['peak_gb']:.3f}")
    if errs["cuda"][0] > e_tol or errs["cuda"][1] > m_tol:
        raise AssertionError(f"FactorialHMMModel: the cuda fit differs from "
                             f"the float64 one: {errs['cuda']}")
    if abs(cu["elbo"] - ei["elbo"]) > TEMPORAL_ELBO_REL * (
            1.0 + abs(ei["elbo"])):
        raise AssertionError("FactorialHMMModel: cuda and einsum elbos "
                             "differ")
    del means64

    lap("factorial HMM")
    # (4) seq_stream_fit over 8 batches, the emission means moved at batch 4
    g_stream = torch.Generator(device=dev).manual_seed(7)
    stream = [_seq(_sample_hmm(g_stream, dev, B, T, trans,
                               means + (TEMPORAL_SHIFT if i >= SWITCH
                                        else 0.0)))
              for i in range(T_CHUNKS)]
    flags = {}
    for backend in ("einsum", "cuda"):
        model = dyn.HiddenMarkovModel(_attrs(F), n_states=S, seed=0,
                                      device=dev, backend=backend)
        info, secs, launches = _counted(lambda: dyn.seq_stream_fit(
            model, stream, sweeps=SWEEPS, tol=0.0))
        _add(total, launches, f"seq_stream_fit {backend}", backend)
        want = T_CHUNKS * SWEEPS if backend == "cuda" else 0
        if launches["clg_seq_suffstats"] != want:
            raise AssertionError(f"seq_stream_fit {backend}: {launches}")
        drifted = [bool(v) for v in info["drifted"].tolist()]
        first = next((i for i, f in enumerate(drifted) if f), None)
        if first is None or first < SWITCH or any(drifted[:SWITCH]):
            raise AssertionError(f"seq_stream_fit {backend}: drift flags "
                                 f"{drifted}, switch at {SWITCH}")
        if any(info["quarantined"].tolist()):
            raise AssertionError(f"seq_stream_fit {backend}: quarantined")
        flags[backend] = drifted
        log(f"temporal seq_stream_fit ({backend}): {T_CHUNKS} batches of "
            f"B={B} x T={T}, shift {TEMPORAL_SHIFT} at {SWITCH}; drifted "
            f"{drifted}; score {[round(v, 4) for v in info['score'].tolist()]}"
            f"; {secs:.3f} s, {T_CHUNKS * B * T / secs:.0f} frames/s")
    if flags["cuda"] != flags["einsum"]:
        raise AssertionError(f"seq_stream_fit: drift flags differ {flags}")
    del stream

    lap("seq_stream_fit")
    # (5) temporal serving: 1024 filter + 1024 predict (h = 4) a flush
    model = fitted["HiddenMarkovModel"]
    eng = PGMQueryEngine(model, mode="temporal")
    host = xc[:2 * TEMPORAL_QUERIES].cpu().numpy()
    Q = TEMPORAL_QUERIES
    flush_s = []
    for _ in range(SERVE_FLUSHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qf = [eng.submit("filter", {}, payload=host[i]) for i in range(Q)]
        qp = [eng.submit("predict", {"horizon": TEMPORAL_H}, payload=host[i])
              for i in range(Q, 2 * Q)]
        eng.flush()
        flush_s.append(time.perf_counter() - t0)
    stats = eng.plans.stats()
    if stats["misses"] != 2 or stats["hits"] != 2 * (SERVE_FLUSHES - 1):
        raise AssertionError(f"temporal serving: plan cache {stats}")
    filt = model.filtered_posterior(xc[:Q]).cpu().numpy()
    pred = model.predictive(xc[Q:2 * Q], TEMPORAL_H).cpu().numpy()
    f_err = float(np.abs(np.stack([q.result for q in qf]) - filt).max())
    p_err = float(np.abs(np.stack([q.result for q in qp]) - pred).max())
    if not (f_err <= POST_ATOL and p_err <= POST_ATOL):
        raise AssertionError(f"temporal serving: filter {f_err}, predict "
                             f"{p_err} (atol {POST_ATOL})")
    log(f"temporal serving: {Q} filter + {Q} predict (h = {TEMPORAL_H}) "
        f"queries of T={T} a flush, {SERVE_FLUSHES} flushes; plans {stats};"
        f" |filter - filtered_posterior| {f_err:.3e}, |predict - predictive|"
        f" {p_err:.3e} (atol {POST_ATOL}); queries/s by flush "
        f"{[round(2 * Q / s) for s in flush_s]}")
    del xio, fitted

    lap("serving")
    # (6) the Kalman filter and the switching LDS at full size on the card,
    # then the CPU's fit of the first LDS_CPU_B sequences against the card's
    rng = np.random.default_rng(3)
    L = LDS_L
    A = rng.standard_normal((L, L)) * 0.3
    A = (0.9 * A / np.abs(np.linalg.eigvals(A)).max()).astype(np.float32)
    Cm = rng.standard_normal((F, L)).astype(np.float32)
    x_kf = _sample_lds(g, dev, B, T, lambda t: A, Cm, 0.3, 0.2)
    th = 0.5
    rot = np.eye(L, dtype=np.float32)
    rot[:2, :2] = 0.95 * np.array([[np.cos(th), -np.sin(th)],
                                   [np.sin(th), np.cos(th)]])
    x_sl = _sample_lds(g, dev, B, T, lambda t: rot if t < T // 2 else rot.T,
                       Cm, 0.1, 0.1)
    lds = (("KalmanFilter", lambda d_: dyn.KalmanFilter(
                _attrs(F), n_hidden=L, seed=0, device=d_), x_kf,
            lambda m: m.get_model()),
           ("SwitchingLDS", lambda d_: dyn.SwitchingLDS(
               _attrs(F), n_states=SLDS_S, n_hidden=L, seed=0, device=d_),
            x_sl, lambda m: {"A": m.A, "C": m.C, "q": m.q, "r": m.r}))
    for name, make, x, params in lds:
        model = make(dev)
        e, secs, launches = _counted(
            lambda: model.update_model(_seq(x), sweeps=SWEEPS, tol=0.0))
        if any(launches.values()):
            raise AssertionError(f"{name}: launched {launches}")
        got = params(model)
        if not (math.isfinite(e) and all(bool(torch.isfinite(v).all())
                                          for v in got.values())):
            raise AssertionError(f"{name}: not finite")
        mask = torch.ones(B, T, device=dev)
        if name == "KalmanFilter":
            run = lambda: dyn._kf_fit((model.A, model.C, model.q, model.r),
                                      x, mask, sweeps=2, tol=0.0)
        else:
            resp = torch.full((B, T, SLDS_S), 1.0 / SLDS_S, device=dev)
            run = lambda: dyn._slds_fit(
                (model.A, model.C, model.q, model.r, resp), model.log_trans,
                x, mask, sweeps=2, tol=0.0)
        prof = _profile_steps(run, 2)
        # the same fit of the first LDS_CPU_B sequences on the CPU and here
        part = x[:LDS_CPU_B]
        small = {}
        for where in ("cpu", dev):
            m_ = make(where)
            m_.update_model(_seq(part.to(where)), sweeps=SWEEPS, tol=0.0)
            small[str(where)] = {k: v.cpu() for k, v in params(m_).items()}
        a, b = small["cpu"], small[str(dev)]
        errs = {k: float((a[k] - b[k]).abs().max()) /
                (1.0 + float(a[k].abs().max())) for k in a}
        log(f"temporal {name}: B={B} x T={T}, F={F}, L={L}, {SWEEPS} "
            f"sweeps on the card: elbo {e:.8g}, {secs:.3f} s, "
            f"{B / secs:.1f} seq/s, {B * T / secs:.0f} frames/s; profiled "
            f"sweep {prof}; CPU vs card on the first {LDS_CPU_B} sequences: "
            f"max |d| / (1 + max|cpu|) {errs} (tol {LDS_TOL_REL}); card "
            f"{card}")
        if max(errs.values()) > LDS_TOL_REL:
            raise AssertionError(f"{name}: the CPU's and the card's fits "
                                 f"differ: {errs}")
    lap("LDS models")
    log(f"temporal phase: {time.perf_counter() - t_phase:.1f} s; seconds by "
        f"step {laps}")
    return total


# -- phase 13: approximate inference (SVI, importance sampling, MAP, LDA) ----


def _svi_runs(dev, card, fitted, total):
    """SVI_STEPS ``svi_step``s on the main path's stream chunks (2^20
    instances each, n_total = SVI_STEPS x 2^20) for each workload, on
    ``"cuda"`` then ``"einsum"`` from the same initial posterior."""
    import torch

    from repro_torch.core import svi, vmp

    kernels = {"gmm_large": ("clg_suffstats",),
               "nb_mixed": ("clg_suffstats", "clg_disc_counts"),
               "fa_plate": ("clg_suffstats_latent",)}
    for name, must in kernels.items():
        model, _, _, stream = fitted[name]
        cp, prior = model.cp, model.prior
        init = vmp.symmetry_broken(prior, torch.Generator().manual_seed(0))
        chunks = [(torch.from_numpy(xc).to(dev),
                   torch.from_numpy(np.ascontiguousarray(xd)).to(dev))
                  for xc, xd in stream.chunks()][:SVI_STEPS]
        n_total = float(sum(c[0].shape[0] for c in chunks))
        # warm-up of both backends on one chunk, outside the counted runs
        for backend in ("cuda", "einsum"):
            svi.svi_step(cp, prior, svi.svi_init(init), *chunks[0], n_total,
                         backend=backend)
        out = {}
        for backend in ("cuda", "einsum"):
            def run():
                st = svi.svi_init(init)
                for xc, xd in chunks:
                    st = svi.svi_step(cp, prior, st, xc, xd, n_total,
                                      backend=backend)
                return st
            st, secs, launches = _counted(run)
            _add(total, launches, f"svi {name} {backend}", backend)
            if backend == "cuda":
                for k in ("clg_suffstats", "clg_disc_counts",
                          "clg_suffstats_latent"):
                    if launches[k] != (len(chunks) if k in must else 0):
                        raise AssertionError(f"svi {name}: {k} launched "
                                             f"{launches[k]} times")
            post = svi.svi_posterior(st)
            if int(st.step) != len(chunks) or not all(
                    bool(torch.isfinite(t).all()) for t in st.nat):
                raise AssertionError(f"svi {name} {backend}: bad state")
            xc, xd = chunks[0]
            prof = _profiled(lambda: (svi.svi_step(
                cp, prior, st, xc, xd, n_total, backend=backend),
                torch.cuda.synchronize()), ())
            out[backend] = dict(m=post.reg.m, rate=n_total / secs,
                                launches=launches,
                                ops=prof[2], busy_ms=prof[1] / 1e3,
                                wall_ms=prof[0] / 1e3)
        cu, ei = out["cuda"], out["einsum"]
        err = float((cu["m"] - ei["m"]).abs().max())
        tol = FIT_TOL_REL * (1.0 + float(ei["m"].abs().max()))
        log(f"svi {name}: {len(chunks)} steps x N={N}, n_total={n_total:g}; "
            f"instances/s cuda {cu['rate']} einsum {ei['rate']}; a profiled "
            f"step (profiler on): cuda {cu['wall_ms']:.3f} ms wall, "
            f"{cu['busy_ms']:.3f} busy, {cu['ops']} device ops; einsum "
            f"{ei['wall_ms']:.3f} / {ei['busy_ms']:.3f} / {ei['ops']}; "
            f"launches {cu['launches']}; |m_cuda-m_einsum| {err:.3e} (tol "
            f"{tol:.3e}); card {card}")
        if err > tol:
            raise AssertionError(f"svi {name}: cuda and einsum posterior "
                                 f"means differ")


def _exact_table(bn, dev, evidence, target):
    """The port's exact engine's posterior of ``target`` on one query (its
    plain backend: the factor kernels are held in phases 5 and 6)."""
    from repro_torch.infer_exact import JunctionTreeEngine

    eng = JunctionTreeEngine(bn, backend="einsum", device=dev)
    eng.set_evidence({k: np.array([v]) for k, v in evidence.items()})
    eng.run_inference()
    return eng.posterior_discrete(
        bn.dag.variables.by_name(target)).reshape(-1).cpu().numpy()


def _mc_bar(p, ess):
    return IS_SIGMAS * np.sqrt(p * (1.0 - p) / ess) + IS_ATOL


def _sampled_evidence(bn, dev, names, seed):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    s = bn.sample(gen, 1)
    return {k: float(s[k][0]) for k in names}


def _is_runs(dev, card, nets):
    """Likelihood weighting with IS_PARTICLES particles a run on each
    network's schemas against the exact engine; the known-wrong variant
    (log-weights zeroed) must fail the bar on chain12."""
    import torch

    from repro_torch.core.importance_sampling import ImportanceSampling

    for name, (bn, schemas, targets) in nets.items():
        cases = [_sampled_evidence(bn, dev, sch, 10 + i)
                 for i, sch in enumerate(schemas)]
        if name == "chain12":
            # X00 at the mean of the least likely Z: informative evidence,
            # far from the prior
            z = int(bn.cpds["Z"].table.argmin())
            cases.append({"X00": float(bn.cpds["X00"].alpha[z]),
                          "X11": cases[0]["X11"]})
        for i, ev in enumerate(cases):
            inf = ImportanceSampling(IS_PARTICLES, seed=i, device=dev)
            inf.set_model(bn)
            inf.set_evidence(ev)
            inf.run_inference()              # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inf.run_inference()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            ess = float(inf.effective_sample_size())
            worst, wrong = 0.0, 0.0
            for t in targets:
                var = bn.dag.variables.by_name(t)
                exact = _exact_table(bn, dev, ev, t)
                got = inf.posterior_discrete(var).cpu().numpy()
                bar = _mc_bar(exact, ess)
                worst = max(worst, float((np.abs(got - exact) / bar).max()))
                if not (np.abs(got - exact) <= bar).all():
                    raise AssertionError(f"importance {name} {ev}: {t} "
                                         f"{got} vs exact {exact}, bar {bar}")
                if name == "chain12":
                    logw = inf._logw
                    inf._logw = torch.zeros_like(logw)
                    bad = inf.posterior_discrete(var).cpu().numpy()
                    inf._logw = logw
                    wrong = max(wrong, float((np.abs(bad - exact) /
                                              _mc_bar(exact, ess)).max()))
            log(f"importance {name}: evidence {sorted(ev)}, "
                f"{IS_PARTICLES} particles: {IS_PARTICLES / secs:.6g} "
                f"particles/s ({1e3 * secs:.3f} ms a run), ESS {ess:.6g}; "
                f"max |is - exact| / bar {worst:.4f} (bar "
                f"{IS_SIGMAS} sqrt(p(1-p)/ESS) + {IS_ATOL})"
                + (f"; log-weights zeroed: {wrong:.4f}" if name == "chain12"
                   else "") + f"; card {card}")
            if name == "chain12" and i == len(cases) - 1 and wrong <= 1.0:
                raise AssertionError("importance chain12: the sampler with "
                                     "its log-weights zeroed passes the bar")


def _is_serving(dev, card, nets):
    """PGMQueryEngine(mode="importance") answering IS_QUERIES queries a
    flush; a second engine with the same seed gives the same bits."""
    import torch

    from repro_torch.serve.engine import PGMQueryEngine

    for name, (bn, schemas, targets) in nets.items():
        gen = torch.Generator(device=dev).manual_seed(4)
        per = -(-IS_QUERIES // len(schemas))
        queries = []
        for sch in schemas:
            s = {k: v.cpu().numpy() for k, v in bn.sample(gen, per).items()
                 if k in sch}
            queries += [(targets[b % len(targets)],
                         {k: float(s[k][b]) for k in sch})
                        for b in range(per)]
        queries = queries[:IS_QUERIES]
        warm = PGMQueryEngine(bn, mode="importance", n_samples=IS_SERVE_N,
                              device=dev)
        warm.submit(*queries[0])
        warm.flush()
        flushes, rates = [], []
        for _ in range(2):
            eng = PGMQueryEngine(bn, mode="importance", n_samples=IS_SERVE_N,
                                 seed=0, device=dev)
            qs = [eng.submit(t, ev) for t, ev in queries]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.flush()
            rates.append(len(qs) / (time.perf_counter() - t0))
            flushes.append(np.stack([q.result for q in qs]))
        if not np.array_equal(flushes[0], flushes[1]):
            raise AssertionError(f"importance serving {name}: the second "
                                 f"flush differs from the first")
        if not np.allclose(flushes[0].sum(-1), 1.0, atol=1e-5):
            raise AssertionError(f"importance serving {name}: tables do "
                                 f"not sum to 1")
        log(f"importance serving {name}: {len(queries)} queries a flush, "
            f"{IS_SERVE_N} samples a query, {len(schemas)} schemas: "
            f"queries/s {rates[0]} {rates[1]}; the second flush (same "
            f"seeds) gives the first's bits; card {card}")


def _map_runs(dev, card):
    """MAP on discrete32 (card vs CPU from the same starts) and on a
    12-node network against enumeration on the card."""
    import itertools

    import torch

    from repro_torch.core import map_inference as M
    from repro_torch.data.synthetic import random_discrete_bn

    nets = {where: random_discrete_bn(32, card=4, max_parents=3, seed=0,
                                      device=where) for where in ("cpu", dev)}
    bn = nets[dev]
    ev = _sampled_evidence(bn, dev, ("D10", "D25", "D30"), 7)
    ev = {k: int(v) for k, v in ev.items()}
    M.map_inference(bn, ev, n_starts=64, n_passes=1, device=dev)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    asg, lp = M.map_inference(bn, ev, n_starts=MAP_STARTS,
                              n_passes=MAP_PASSES, seed=0, device=dev)
    secs = time.perf_counter() - t0
    tev = bn.evidence_tensors(ev, dev)
    dvars = M._query_vars(bn, tev)
    init = M._starts(dvars, MAP_STARTS, 0, dev)
    prof = _profiled(lambda: (M._hill_climb(bn, tev, init, 1),
                              torch.cuda.synchronize()), ())
    cbn = nets["cpu"]
    cev = cbn.evidence_tensors(ev, torch.device("cpu"))
    t1 = time.perf_counter()
    cs, cb = M._hill_climb(cbn, cev, init.cpu(), MAP_PASSES)
    cpu_secs = time.perf_counter() - t1
    i = int(cb.argmax())
    casg = {v.name: int(cs[i, j]) for j, v in enumerate(dvars)}
    clp = float(cb[i])
    d_lp = abs(lp - clp)
    tol = MAP_TOL_REL * (1.0 + abs(clp))
    log(f"map discrete32: evidence {ev}, {len(dvars)} query variables, "
        f"{MAP_STARTS} starts x {MAP_PASSES} passes: {secs:.3f} s a query "
        f"on the card ({cpu_secs:.3f} s on the host CPU); a profiled pass "
        f"(profiler on): {prof[0] / 1e3:.2f} ms wall, {prof[1] / 1e3:.3f} "
        f"busy, {prof[2]} device ops; lp card {lp:.8g} CPU {clp:.8g} "
        f"(tol {tol:.3g}); assignments {'equal' if asg == casg else 'DIFFER'}"
        f"; card {card}")
    if d_lp > tol:
        raise AssertionError("map discrete32: card and CPU log-probs differ")
    if asg != casg:
        # a near-tie between two configurations: their log-probs must match
        full = lambda a: {**{k: torch.tensor([v]) for k, v in ev.items()},
                          **{k: torch.tensor([v]) for k, v in a.items()}}
        a, b = (float(cbn.log_prob(full(x))) for x in (asg, casg))
        if abs(a - b) > tol:
            raise AssertionError(f"map discrete32: assignments differ "
                                 f"({a} vs {b})")
    small = random_discrete_bn(12, card=3, seed=0, device=dev)
    sev = {k: int(v) for k, v in
           _sampled_evidence(small, dev, ("D11", "D5"), 8).items()}
    names = [v.name for v in small.order if v.name not in sev]
    grid = torch.tensor(list(itertools.product(range(3), repeat=len(names))),
                        device=dev)
    asg_e = {n: grid[:, j] for j, n in enumerate(names)}
    asg_e.update({k: torch.full((grid.shape[0],), v, device=dev)
                  for k, v in sev.items()})
    lps = small.log_prob(asg_e)
    best = float(lps.max())
    s_asg, s_lp = M.map_inference(small, sev, n_starts=MAP_SMALL_STARTS,
                                  n_passes=MAP_PASSES, device=dev)
    log(f"map enumeration: random_discrete_bn(12, card=3), evidence {sev}: "
        f"MAP lp {s_lp:.8g}, max over {grid.shape[0]} configurations "
        f"{best:.8g}; card {card}")
    if abs(s_lp - best) > MAP_TOL_REL * (1.0 + abs(best)):
        raise AssertionError("map: the MAP is not the enumerated maximum")


def _nips_corpus(dev):
    """A bag-of-words corpus of the UCI NIPS corpus's shape (LDA_D
    documents, LDA_V words, LDA_D x LDA_LEN tokens) drawn on the card from
    LDA's generative model: topics ~ Dirichlet(0.1), theta ~ Dirichlet(
    LDA_ALPHA), each token from theta @ beta."""
    import torch

    g = torch.Generator(device=dev).manual_seed(5)

    def dirichlet(conc, shape):
        x = torch._standard_gamma(torch.full(shape, conc, device=dev),
                                  generator=g)
        return x / x.sum(-1, keepdim=True)

    beta = dirichlet(0.1, (LDA_T, LDA_V))
    theta = dirichlet(LDA_ALPHA, (LDA_D, LDA_T))
    words = torch.multinomial(theta @ beta, LDA_LEN, replacement=True,
                              generator=g)
    counts = torch.zeros(LDA_D, LDA_V, device=dev)
    return counts.scatter_add_(1, words, torch.ones(words.shape,
                                                     device=dev))


def _lda_runs(dev, card):
    import torch

    from repro_torch.pgm_models import LDA

    counts = _nips_corpus(dev)
    lda = LDA(LDA_T, LDA_V, alpha=LDA_ALPHA, eta=LDA_ETA, seed=0, device=dev)
    lam0 = lda.lam.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bound = lda.update_model(counts, sweeps=LDA_SWEEPS)
    secs = time.perf_counter() - t0
    peak = _peak_gb()
    estep_ms = time_ms(lambda: LDA._doc_estep(lda.lam, counts, lda.alpha),
                       iters=1, warmup=0)
    t0 = time.perf_counter()
    for lo in range(0, LDA_D, LDA_SVI_DOCS):
        lda.svi_step(counts[lo:lo + LDA_SVI_DOCS], n_total=LDA_D)
    torch.cuda.synchronize()
    svi_secs = time.perf_counter() - t0
    svi_bound = float(lda.perplexity_bound(counts))
    # the card's E-step against the CPU's on LDA_CPU_DOCS documents
    sl = counts[:LDA_CPU_DOCS]
    got = LDA._doc_estep(lam0, sl, lda.alpha)
    exp = LDA._doc_estep(lam0.cpu(), sl.cpu(), lda.alpha)
    # |d| over the bar rtol |cpu| + 1e-6 max|cpu| (<= 1 holds)
    errs = [float(((a.cpu() - b).abs() / (LDA_RTOL * b.abs() + 1e-6 * float(
        b.abs().max()))).max()) for a, b in zip(got, exp)]
    tokens = int(counts.sum())
    log(f"lda: NIPS-shaped corpus D={LDA_D} V={LDA_V} tokens={tokens}, "
        f"T={LDA_T}: {LDA_SWEEPS} sweeps of update_model (+ the bound's "
        f"E-step) {secs:.3f} s, {LDA_D * LDA_SWEEPS / secs:.6g} documents/s "
        f"a sweep by update_model's wall; one E-step {estep_ms:.2f} ms "
        f"({LDA_D / estep_ms * 1e3:.6g} documents/s); peak "
        f"{peak:.3f} GiB; bound {bound:.8g}; svi_step on "
        f"{LDA_SVI_DOCS}-document minibatches: {LDA_D / svi_secs:.6g} "
        f"documents/s, bound after {svi_bound:.8g}; card vs CPU E-step on "
        f"{LDA_CPU_DOCS} documents: max |d| / (rtol {LDA_RTOL} |cpu| + 1e-6 "
        f"max|cpu|) gamma {errs[0]:.4f}, stats {errs[1]:.4f}; card {card}")
    if not (math.isfinite(bound) and math.isfinite(svi_bound)):
        raise AssertionError("lda: the bound is not finite")
    for a, b in zip(got, exp):
        torch.testing.assert_close(a.cpu(), b, rtol=LDA_RTOL,
                                   atol=1e-6 * float(b.abs().max()))


def _arff_run(dev, card, fitted, total):
    """gmm_large's first ARFF_ROWS instances through save_arff / load_arff
    (equal arrays) and one GaussianMixture fit on the card from the file."""
    import tempfile

    import torch

    from repro_torch.data import io
    from repro_torch.data.stream import DataStream
    from repro_torch.pgm_models import GaussianMixture

    stream = fitted["gmm_large"][3]
    xc = next(stream.chunks())[0][:ARFF_ROWS]
    src = DataStream.from_arrays(stream.attributes, xc)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "gmm_large.arff")
        t0 = time.perf_counter()
        io.save_arff(path, src)
        t1 = time.perf_counter()
        loaded = io.load_arff(path)
        t2 = time.perf_counter()
        nbytes = os.path.getsize(path)
    b = loaded.collect()
    if not (np.array_equal(b.xc, xc) and [a.name for a in loaded.attributes]
            == [a.name for a in stream.attributes]):
        raise AssertionError("arff: the loaded stream differs")
    model = GaussianMixture(loaded.attributes, n_states=4, device=dev)
    e, secs, launches = _counted(lambda: model.update_model(loaded))
    _add(total, launches, "arff fit", "cuda")
    if not (math.isfinite(e) and launches["clg_suffstats"]):
        raise AssertionError(f"arff: fit {e}, launches {launches}")
    log(f"arff: {ARFF_ROWS} rows of gmm_large, {nbytes} bytes: save "
        f"{t1 - t0:.3f} s, load {t2 - t1:.3f} s, arrays equal; "
        f"GaussianMixture.update_model from the file {secs:.3f} s, elbo "
        f"{e:.8g}, launches {launches}; card {card}")


def approx_phase(dev, card, fitted):
    """Phase 13: the paper's approximate inference on the card.  Returns the
    launch counts of the cuda-backend SVI runs and the ARFF fit."""
    from repro_torch.data.synthetic import random_discrete_bn

    t_phase = time.perf_counter()
    laps = {}

    def lap(label):
        laps[label] = round(time.perf_counter() - t_phase - sum(laps.values()),
                            2)

    total = {}
    _svi_runs(dev, card, fitted, total)
    lap("svi")
    nets = {"chain12": (_chain_net(dev), [("X11",), ("X05", "X11")], ("Z",)),
            "discrete32": (random_discrete_bn(32, card=4, max_parents=3,
                                              seed=0, device=dev),
                           [("D31",), ("D5", "D20"), ("D10", "D25", "D30")],
                           ("D0", "D16"))}
    _, _, zero = _counted(lambda: (_is_runs(dev, card, nets),
                                   _is_serving(dev, card, nets)))
    lap("importance")
    _, _, zero2 = _counted(lambda: _map_runs(dev, card))
    lap("map")
    _, _, zero3 = _counted(lambda: _lda_runs(dev, card))
    lap("lda")
    for launches in (zero, zero2, zero3):
        if any(launches.values()):
            raise AssertionError(f"approximate inference launched "
                                 f"{launches}")
    _arff_run(dev, card, fitted, total)
    lap("arff")
    log(f"approximate inference phase: {time.perf_counter() - t_phase:.1f} "
        f"s; seconds by step {laps}")
    return total


# -- phase 14: d-VMP (core.dvmp and the mesh= paths) --------------------------


def _dvmp_models(dev):
    """The main path's three workloads: (a function making the model from
    the attributes, the kernels its sweeps launch)."""
    from repro_torch.pgm_models import (FactorAnalysis, GaussianMixture,
                                        NaiveBayes)

    return {"gmm_large": (lambda a: GaussianMixture(a, n_states=4,
                                                    device=dev),
                          ("clg_suffstats",)),
            "nb_mixed": (lambda a: NaiveBayes(a, n_states=3, device=dev),
                         ("clg_suffstats", "clg_disc_counts")),
            "fa_plate": (lambda a: FactorAnalysis(a, n_hidden=4, device=dev),
                         ("clg_suffstats_latent",))}


def _profile_dvmp_sweeps(model, batch, mesh, sweeps=3):
    """torch.profiler over ``sweeps`` sweeps on ``batch``: ``dvmp_one_sweep``
    over ``mesh``, or with ``mesh=None`` the mesh-free local step, global
    update and ELBO; each ends in one host read of the ELBO, as the fit
    loop does.  Returns profile_sweeps' numbers, the device time a sweep of
    NCCL's kernels, and the device ops a sweep by name."""
    import torch

    from repro_torch.core import dvmp, vmp

    b = model._as_batch(batch)

    def run():
        post = model.posterior
        for _ in range(sweeps):
            if mesh is None:
                st, _ = vmp.local_step(model.cp, post, b.xc, b.xd, b.mask,
                                       backend=model.backend)
                post = vmp.global_update(model.prior, st)
                e = vmp.elbo(model.cp, model.prior, post, st)
            else:
                post, e = dvmp.dvmp_one_sweep(model.cp, model.prior, post,
                                              b.xc, b.xd, b.mask, mesh,
                                              backend=model.backend)
            float(e)
        torch.cuda.synchronize()

    run()
    busy_by, n_by = {}, {}
    wall_us, busy, n, _ = _profiled(run, ("",), busy_by, n_by)
    coll = sum(v for k, v in busy_by.items() if "nccl" in k.lower())
    return dict(sweep_ms=wall_us / sweeps / 1e3,
                device_busy_ms=busy / sweeps / 1e3,
                idle_share=max(0.0, 1.0 - busy / wall_us),
                device_ops_per_sweep=n / sweeps,
                collective_us_per_sweep=coll / sweeps,
                ops={k: v / sweeps for k, v in n_by.items()})


def _dvmp_fits(dev, card, fitted, mesh, total):
    """``Model.update_model(batch, sweeps=5, tol=0.0)`` on one 2^20-instance
    chunk of each workload, without and with the mesh in turns (plain,
    mesh, mesh, plain): the same bits, one all_reduce a sweep, the same
    kernel launches."""
    import torch

    from repro_torch.core import dvmp
    from repro_torch.core.streaming import tree_leaves

    for name, (build, kernels) in _dvmp_models(dev).items():
        stream = fitted[name][3]
        xc, xd = next(stream.chunks())
        batch = _batch(xc, np.ascontiguousarray(xd))
        attrs = stream.attributes
        for m in (None, mesh):                              # warm both
            build(attrs).update_model(_batch(xc[:4096], np.ascontiguousarray(
                xd[:4096])), sweeps=1, tol=0.0, mesh=m)
        runs = {"plain": [], "mesh": []}
        for which in ("plain", "mesh", "mesh", "plain"):
            model = build(attrs)
            dvmp.reset_collectives()
            e, secs, launches = _counted(lambda: model.update_model(
                batch, sweeps=SWEEPS, tol=0.0,
                mesh=mesh if which == "mesh" else None))
            runs[which].append(dict(model=model, elbo=e, rate=N / secs,
                                    launches=launches,
                                    coll=dict(dvmp.COLLECTIVES)))
        plain, meshed = runs["plain"][0], runs["mesh"][0]
        sweeps = meshed["launches"][kernels[0]]
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(plain["model"].posterior),
            tree_leaves(meshed["model"].posterior)))
        prof = {"plain": _profile_dvmp_sweeps(plain["model"], batch, None),
                "mesh": _profile_dvmp_sweeps(meshed["model"], batch, mesh)}
        ops = {w: prof[w].pop("ops") for w in prof}
        short = lambda k: re.sub(r"\(.*$", "", re.sub(
            r"^void |\(anonymous namespace\)::|at::native::|std::", "",
            k))[:80]
        added = {short(k): ops["mesh"].get(k, 0) - ops["plain"].get(k, 0)
                 for k in set(ops["mesh"]) | set(ops["plain"])
                 if ops["mesh"].get(k, 0) != ops["plain"].get(k, 0)}
        _add(total, meshed["launches"], f"dvmp fit {name}", "cuda")
        log(f"dvmp fit {name}: N={N}, {sweeps} sweeps; posterior and elbo "
            f"{'the same bits' if same and plain['elbo'] == meshed['elbo'] else 'DIFFER'}"
            f" with and without the mesh (elbo {meshed['elbo']:.8g}); "
            f"all_reduce {meshed['coll']['all_reduce']} "
            f"({meshed['coll']['bytes']} bytes); launches mesh "
            f"{meshed['launches']} plain {plain['launches']}; inst/s (plain, "
            f"mesh, mesh, plain) {runs['plain'][0]['rate']} "
            f"{runs['mesh'][0]['rate']} {runs['mesh'][1]['rate']} "
            f"{runs['plain'][1]['rate']}; profiled sweep (profiler on) "
            f"{prof}; device ops a sweep the mesh adds (or drops) {added}; "
            f"card {card}")
        if not same or plain["elbo"] != meshed["elbo"]:
            raise AssertionError(f"dvmp fit {name}: the mesh fit differs "
                                 f"from the mesh-free fit")
        if meshed["coll"]["all_reduce"] != sweeps or sweeps < 1:
            raise AssertionError(f"dvmp fit {name}: "
                                 f"{meshed['coll']['all_reduce']} all_reduce "
                                 f"in {sweeps} sweeps")
        if meshed["launches"] != plain["launches"] or not all(
                meshed["launches"][k] == sweeps for k in kernels):
            raise AssertionError(f"dvmp fit {name}: launches "
                                 f"{meshed['launches']} vs "
                                 f"{plain['launches']}")


def _dvmp_stream(dev, card, fitted, mesh, total):
    """stream_update(mesh=) over gmm_large's drifting stream against the
    mesh-free stream_update(tol=0.0) loop."""
    import torch

    from repro_torch.core import streaming, vmp

    model, _, _, stream = fitted["gmm_large"]
    cp, prior = model.cp, model.prior
    init = vmp.symmetry_broken(prior, torch.Generator().manual_seed(0))
    chunks = [(torch.from_numpy(xc).to(dev),
               torch.from_numpy(np.ascontiguousarray(xd)).to(dev))
              for xc, xd in stream.chunks()]
    out = {"plain": [], "mesh": []}
    for which in ("plain", "mesh", "mesh", "plain"):
        def run():
            st, flags, sweeps = streaming.stream_init(prior, init), [], []
            for xc, xd in chunks:
                st, info = streaming.stream_update(
                    cp, prior, st, xc, xd, sweeps=SWEEPS, tol=0.0,
                    mesh=mesh if which == "mesh" else None)
                flags.append(bool(info["drifted"]))
                sweeps.append(int(info["sweeps"]))
            return st, flags, sweeps
        (st, flags, sweeps), secs, launches = _counted(run)
        out[which].append(dict(m=st.post.reg.m, flags=flags, sweeps=sweeps,
                               launches=launches["clg_suffstats"],
                               rate=len(chunks) * N / secs))
    total["clg_suffstats"] = (total.get("clg_suffstats", 0)
                              + out["mesh"][0]["launches"])
    pl, me = out["plain"][0], out["mesh"][0]
    err = float((me["m"] - pl["m"]).abs().max())
    tol = FIT_TOL_REL * (1.0 + float(pl["m"].abs().max()))
    first = next((i for i, f in enumerate(me["flags"]) if f), None)
    log(f"dvmp stream gmm_large: {len(chunks)} x N={N}, switch at {SWITCH}; "
        f"drift flags mesh {me['flags']} plain {pl['flags']}; |m_mesh - "
        f"m_plain| {err:.3e} (tol {tol:.3e}); inst/s (plain, mesh, mesh, "
        f"plain) {pl['rate']} {me['rate']} {out['mesh'][1]['rate']} "
        f"{out['plain'][1]['rate']}; sweeps a chunk mesh {me['sweeps']} "
        f"plain {pl['sweeps']} (tol=0 ends the mesh-free fit when the ELBO "
        f"repeats; the mesh fit runs its sweeps, as in the reference); "
        f"clg_suffstats launches mesh {me['launches']} plain "
        f"{pl['launches']}; card {card}")
    if err > tol:
        raise AssertionError("dvmp stream: mesh and mesh-free means differ")
    if first is None or first < SWITCH:
        raise AssertionError(f"dvmp stream: first drift flag at {first}")


def _dvmp_serving(dev, card, fitted, mesh, total):
    """PGMQueryEngine(mode="vmp", mesh=) answering DVMP_QUERIES queries a
    flush for DVMP_FLUSHES flushes: the mesh-free engine's bits."""
    from repro_torch.serve.engine import PGMQueryEngine

    model, queries, _, _ = fitted["gmm_large"]
    F = queries.xc.shape[1]
    evs = [{f"X{i}": float(row[i]) for i in range(F)}
           for row in queries.xc[:DVMP_QUERIES * DVMP_FLUSHES]]
    res, rates = {}, {"plain": [], "mesh": []}
    for which in ("plain", "mesh", "mesh", "plain"):
        eng = PGMQueryEngine(model, mode="vmp",
                             mesh=mesh if which == "mesh" else None)
        eng.submit("Z", evs[0])
        eng.flush()                                       # warm
        out = []

        def run():
            for f in range(DVMP_FLUSHES):
                qs = [eng.submit("Z", ev)
                      for ev in evs[f * DVMP_QUERIES:(f + 1) * DVMP_QUERIES]]
                eng.flush()
                out.append(np.stack([q.result for q in qs]))
        _, secs, launches = _counted(run)
        rates[which].append(len(evs) / secs)
        if which not in res:
            res[which] = np.concatenate(out)
            if which == "mesh":
                _add(total, launches, "dvmp serving", "cuda")
    same = np.array_equal(res["plain"], res["mesh"])
    log(f"dvmp serving gmm_large: {DVMP_FLUSHES} flushes x {DVMP_QUERIES} "
        f"queries; mesh rows {'the same bits as' if same else 'DIFFER from'}"
        f" the mesh-free engine's; queries/s (plain, mesh, mesh, plain) "
        f"{rates['plain'][0]} {rates['mesh'][0]} {rates['mesh'][1]} "
        f"{rates['plain'][1]}; card {card}")
    if not same:
        raise AssertionError("dvmp serving: mesh and mesh-free rows differ")


def _dvmp_sampling(dev, card, mesh):
    """ImportanceSampling.run_inference(mesh=) on chain12 and
    map_inference(mesh=) on discrete32 against the per-shard contract."""
    import torch

    from repro_torch.core import dvmp
    from repro_torch.core import importance_sampling as IS
    from repro_torch.core import map_inference as M
    from repro_torch.data.synthetic import random_discrete_bn

    bn = _chain_net(dev)
    ev = _sampled_evidence(bn, dev, ("X11",), 10)
    for seed in (1, 0):                 # a warm run, then the timed one
        inf = IS.ImportanceSampling(IS_PARTICLES, seed=seed, device=dev)
        inf.set_model(bn)
        inf.set_evidence(ev)
        if seed:
            inf.run_inference(mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inf.run_inference(mesh=mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    seeds = dvmp.shard_seeds(torch.Generator(device=dev).manual_seed(0),
                             dvmp.data_size(mesh, ("data",)))
    blocks = [IS._sample_or_clamp(bn, torch.Generator(device=dev).manual_seed(
        s), IS_PARTICLES // len(seeds), ev) for s in seeds]
    same = torch.equal(inf._logw, torch.cat([b[1] for b in blocks])) and all(
        torch.equal(inf._particles[k], torch.cat([b[0][k] for b in blocks]))
        for k in inf._particles)
    ess = float(inf.effective_sample_size())
    exact = _exact_table(bn, dev, ev, "Z")
    got = inf.posterior_discrete(bn.dag.variables.by_name("Z")).cpu().numpy()
    worst = float((np.abs(got - exact) / _mc_bar(exact, ess)).max())
    log(f"dvmp importance chain12: {IS_PARTICLES} particles over the mesh, "
        f"{1e3 * secs:.3f} ms; particles {'equal' if same else 'DIFFER from'}"
        f" the shard seeds' draws; ESS {ess:.6g}; max |is - exact| / bar "
        f"{worst:.4f}; card {card}")
    if not same or worst > 1.0:
        raise AssertionError("dvmp importance: contract or MC bar broken")

    dbn = random_discrete_bn(32, card=4, max_parents=3, seed=0, device=dev)
    mev = {k: int(v) for k, v in _sampled_evidence(
        dbn, dev, ("D10", "D25", "D30"), 7).items()}
    M.map_inference(dbn, mev, n_starts=64, n_passes=1, mesh=mesh,
                    device=dev)                                    # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    asg, lp = M.map_inference(dbn, mev, n_starts=MAP_STARTS,
                              n_passes=MAP_PASSES, seed=0, mesh=mesh,
                              device=dev)
    secs = time.perf_counter() - t0
    tev = dbn.evidence_tensors(mev, dev)
    dvars = M._query_vars(dbn, tev)
    (seed,) = dvmp.shard_seeds(torch.Generator().manual_seed(0), 1)
    states, best = M._hill_climb(dbn, tev, M._starts(dvars, MAP_STARTS, seed,
                                                     dev), MAP_PASSES)
    i = int(best.argmax())
    expect = ({v.name: int(states[i, j]) for j, v in enumerate(dvars)},
              float(best[i]))
    log(f"dvmp map discrete32: {MAP_STARTS} starts x {MAP_PASSES} passes "
        f"over the mesh: {secs:.3f} s; lp {lp:.8g}; "
        f"{'equal to' if (asg, lp) == expect else 'DIFFERS from'} the shard "
        f"seed's climb; card {card}")
    if (asg, lp) != expect:
        raise AssertionError("dvmp map: the mesh result breaks the contract")


def _dvmp_rank(rank, world, store, out, n, dev_type):
    """One of the two gloo ranks sharing the card (``dev_type`` "cuda"):
    dvmp_fit on gmm_large's first chunk, saved to ``out``."""
    import datetime

    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.amidst_pgm import PGM_WORKLOADS
    from repro_torch.core import dvmp, vmp
    from repro_torch.core.streaming import tree_map
    from repro_torch.kernels import clg_stats

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev_type, 0 if dev_type == "cuda" else None)
    if dev_type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = init_device_mesh(dev_type, (world,),
                                mesh_dim_names=("data",))
        _, xc, xd = _gmm(n, 1)
        xc = torch.from_numpy(xc).to(dev)
        xd = torch.from_numpy(np.ascontiguousarray(xd)).to(dev)
        cp = vmp.compile_plate(PGM_WORKLOADS["gmm_large"].spec, device=dev)
        prior = vmp.default_prior(cp)
        init = vmp.symmetry_broken(prior, torch.Generator().manual_seed(0))
        dvmp.dvmp_fit(cp, prior, init, xc, xd, mesh, max_sweeps=1)  # warm
        torch.cuda.synchronize()
        clg_stats.reset_launches()
        dvmp.reset_collectives()
        t0 = time.perf_counter()
        st = dvmp.dvmp_fit(cp, prior, init, xc, xd, mesh,
                           max_sweeps=SWEEPS, tol=0.0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        torch.save(dict(post=tree_map(lambda t: t.cpu(), st.post),
                        elbo=float(st.elbo), sweeps=st.sweep, seconds=secs,
                        launches=dict(clg_stats.LAUNCHES),
                        collectives=dict(dvmp.COLLECTIVES),
                        backend=dist.get_backend()), out)
    finally:
        dist.destroy_process_group()


def _dvmp_two_ranks(dev, card, total):
    """Two spawned gloo ranks on the one card: dvmp_fit on gmm_large at
    N = 2^20 (2^19 a rank) against the single-rank fit."""
    import multiprocessing
    import tempfile

    import torch

    from repro_torch.configs.amidst_pgm import PGM_WORKLOADS
    from repro_torch.core import vmp
    from repro_torch.core.streaming import tree_leaves

    world = 2
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        outs = [os.path.join(d, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_dvmp_rank, args=(
            r, world, os.path.join(d, "store"), outs[r], N, dev.type))
            for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + DVMP_RANK_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.1))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        wall = time.perf_counter() - t0
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"dvmp two ranks: exit codes "
                                 f"{[p.exitcode for p in procs]}")
        res = [torch.load(o, weights_only=False) for o in outs]
    a, b = res
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(a["post"]),
                                                 tree_leaves(b["post"])))
    _, xc, xd = _gmm(N, 1)
    cp = vmp.compile_plate(PGM_WORKLOADS["gmm_large"].spec, device=dev)
    prior = vmp.default_prior(cp)
    init = vmp.symmetry_broken(prior, torch.Generator().manual_seed(0))
    one = vmp.vmp_fit(cp, prior, init, torch.from_numpy(xc).to(dev),
                      torch.from_numpy(np.ascontiguousarray(xd)).to(dev),
                      SWEEPS, 0.0)
    m1 = one.post.reg.m.cpu()
    err = float((a["post"].reg.m - m1).abs().max())
    tol = DVMP_RANKS_TOL_REL * (1.0 + float(m1.abs().max()))
    elbo1 = float(one.elbo)
    elbo_err = abs(a["elbo"] - elbo1) / abs(elbo1)
    for r in res:
        _add(total, r["launches"], "dvmp two ranks", "cuda")
    log(f"dvmp two ranks (NOT a speed figure: two processes sharing one "
        f"card over {a['backend']}, a host-copy collective): N={N}, "
        f"{N // world} a rank, {a['sweeps']} / {b['sweeps']} sweeps; fit "
        f"{a['seconds']:.3f} / {b['seconds']:.3f} s, {wall:.1f} s with the "
        f"spawn; ranks {'the same bits' if same else 'DIFFER'}; |m - "
        f"m_single| {err:.3e} (tol {tol:.3e}); elbo {a['elbo']!r} vs "
        f"{elbo1!r} single, rel {elbo_err:.3e} (tol "
        f"{DVMP_RANKS_ELBO_RTOL:.0e}); all_reduce "
        f"{a['collectives']['all_reduce']}; launches {a['launches']} / "
        f"{b['launches']}; card {card}")
    if not same or a["sweeps"] != b["sweeps"] or a["elbo"] != b["elbo"]:
        raise AssertionError("dvmp two ranks: the ranks differ")
    if err > tol or elbo_err > DVMP_RANKS_ELBO_RTOL:
        raise AssertionError("dvmp two ranks: far from the single-rank fit")
    if not all(r["launches"]["clg_suffstats"] == r["sweeps"]
               and r["collectives"]["all_reduce"] == r["sweeps"]
               for r in res):
        raise AssertionError("dvmp two ranks: the shards did not run the "
                             "kernel and one all_reduce a sweep")


def _dvmp_dryrun(dev, card, out, total):
    """``launch.dryrun_pgm`` through its command line on one rank of the
    card (NCCL), on its ``("data",)`` and its ``("pod", "data")`` mesh."""
    from repro_torch.launch import dryrun_pgm

    for mesh, axes in (("single", 1), ("multi", 2)):
        rc, secs, launches = _counted(lambda: dryrun_pgm.main(
            ["--n", str(DRYRUN_N), "--mesh", mesh, "--device", dev.type,
             "--out", out]))
        name = "pgm_gmm_large_" + "x".join("1" * axes) + ".json"
        with open(os.path.join(out, name)) as f:
            rec = json.load(f)
        _add(total, launches, f"dvmp dry run {mesh}", "cuda")
        log(f"dvmp dry run --mesh {mesh}: {rec['backend']} on "
            f"{rec['device']}, mesh {rec['mesh']}; N {rec['n_instances']}; "
            f"all_reduce a sweep {[r['all_reduces_per_sweep'] for r in rec['runs']]}, "
            f"bytes a sweep {[r['bytes_per_sweep'] for r in rec['runs']]}; "
            f"{secs:.3f} s; launches {launches}; card {card}")
        if (rc != 0 or not rec["claim_holds"]
                or rec["runs"][0]["all_reduces_per_sweep"] != axes
                or rec["backend"] != ("nccl" if dev.type == "cuda"
                                      else "gloo")
                or (dev.type == "cuda"
                    and not launches.get("clg_suffstats"))):
            raise AssertionError(f"dvmp dry run --mesh {mesh} failed: {rec}")


def dvmp_phase(dev, card, fitted):
    """Phase 14: d-VMP on the card, one NCCL rank (the fits, the stream,
    serving, sampling and MAP over its mesh), then two gloo ranks sharing
    the card.  Returns the suff-stats launches of its mesh runs."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    t_phase = time.perf_counter()
    laps = {}

    def lap(label):
        laps[label] = round(time.perf_counter() - t_phase - sum(laps.values()),
                            2)

    total = {}
    torch.cuda.set_device(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{d}/store", world_size=1,
                                rank=0,
                                timeout=datetime.timedelta(seconds=300))
        try:
            mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("data",))
            _dvmp_fits(dev, card, fitted, mesh, total)
            lap("fits")
            _dvmp_stream(dev, card, fitted, mesh, total)
            lap("stream")
            _dvmp_serving(dev, card, fitted, mesh, total)
            lap("serving")
            _, _, zero = _counted(lambda: _dvmp_sampling(dev, card, mesh))
            lap("sampling")
            if any(zero.values()):
                raise AssertionError(f"dvmp sampling launched {zero}")
        finally:
            dist.destroy_process_group()
        _dvmp_dryrun(dev, card, d, total)
        lap("dry run")
    _dvmp_two_ranks(dev, card, total)
    lap("two ranks")
    log(f"d-VMP phase: {time.perf_counter() - t_phase:.1f} s; seconds by "
        f"step {laps}; launches {total}")
    return total


# -- the production tier: obs, resilience, the async server ------------------


def _sweep_wall_ms(model, b, sweeps=10):
    """Wall ms a sweep (local step, global update, one host read of the
    ELBO) of ``model`` on batch ``b``, profiler off."""
    import torch

    from repro_torch.core import vmp

    def sweep():
        st, _ = vmp.local_step(model.cp, model.posterior, b.xc, b.xd,
                               b.mask, backend=model.backend)
        post = vmp.global_update(model.prior, st)
        float(vmp.elbo(model.cp, model.prior, post, st))

    sweep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(sweeps):
        sweep()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / sweeps


def _record_buckets(srv):
    """Every bucket ``srv`` flushes, as (network version of the engine that
    served it, its items), drained buckets of a swap included."""
    log_ = []
    flush = srv._flush_bucket

    def rec(eng, bucket, trigger):
        log_.append((eng.network_version, list(bucket.items)))
        return flush(eng, bucket, trigger)

    srv._flush_bucket = rec
    return log_


def _check_buckets(buckets, models, dev, mode="exact"):
    """Each recorded bucket again through a direct ``PGMQueryEngine(
    pad_pow2=True)`` of the model version that served it, on the card: each
    ticket's answer must be those bits.  Returns the answers checked."""
    from repro_torch.serve.engine import PGMQueryEngine

    engines = {v: PGMQueryEngine(m, mode=mode, pad_pow2=True, device=dev)
               for v, m in models.items()}
    checked = 0
    for version, items in buckets:
        eng = engines[version]
        qs = [eng.submit(target, ev, pl) for _, target, ev, pl in items]
        eng.flush()
        for (t, *_), q in zip(items, qs):
            if not np.array_equal(t.result(timeout=0), q.result):
                raise AssertionError(
                    f"async {mode}: request {t.rid} differs from the direct "
                    f"engine's flush of its bucket (network v{version})")
            checked += 1
    return checked


def _latency(tickets):
    lat = np.array([(t.done_s - t.submitted_s) * 1e3 for t in tickets])
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def _obs_levels(dev, card, fitted, d, total):
    """(a): gmm_large's drifting stream and a discrete32 flush at each obs
    level.  Returns the uninterrupted stream's state and the stacked
    chunks."""
    import torch

    from repro_torch import obs
    from repro_torch.core import streaming, vmp
    from repro_torch.core.streaming import tree_leaves
    from repro_torch.kernels import clg_stats, factor_ops
    from repro_torch.serve.engine import PGMQueryEngine

    model, queries, _, stream = fitted["gmm_large"]
    cp, prior = model.cp, model.prior
    init = vmp.symmetry_broken(prior, torch.Generator().manual_seed(0))
    chunks = list(stream.chunks())
    xcs = torch.from_numpy(np.stack([xc for xc, _ in chunks])).to(dev)
    xds = torch.from_numpy(np.stack([xd for _, xd in chunks])).to(dev)
    b = model._as_batch(_batch(np.asarray(chunks[0][0]),
                               np.asarray(chunks[0][1])))
    res = {}
    for level in ("off", "basic", "trace", "off"):
        path = os.path.join(d, f"stream_{level}.jsonl")
        obs.configure(level=level, path=path, reset_counters=True)
        before = dict(clg_stats.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, info = streaming.stream_fit(
            cp, prior, streaming.stream_init(prior, init), xcs, xds,
            sweeps=SWEEPS, tol=0.0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = {k: clg_stats.LAUNCHES[k] - before[k]
                    for k in clg_stats.LAUNCHES}
        kc = obs.kernel_counts()
        ops = {}
        prof = profile_sweeps(model, b, n_by_name=ops)
        wall = _sweep_wall_ms(model, b)
        if level in res:
            res[level + " again"] = dict(secs=secs, wall=wall)
            continue
        res[level] = dict(state=state, secs=secs, prof=prof, wall=wall,
                          kc=kc, launched=launched, path=path, ops=ops,
                          drifted=info["drifted"].tolist())
    obs.configure(level="off")
    base = res["off"]
    _add(total, base["launched"], "obs stream", "cuda")
    for level in ("basic", "trace"):
        r = res[level]
        if not all(torch.equal(a, c) for a, c in zip(
                tree_leaves(base["state"]), tree_leaves(r["state"]))):
            raise AssertionError(f"obs {level}: the stream's state differs "
                                 f"from the run at off")
        counts = obs.validate_obs_events(r["path"])
        with open(r["path"]) as fh:
            evs = [json.loads(line) for line in fh]
        drift_t = [e["t"] for e in evs if e["event"] == "drift"]
        disp = [e["counts"] for e in evs if e["event"] == "kernel_dispatch"]
        cu = {k[:-5]: v for k, v in disp[-1].items() if k.endswith(":cuda")}
        want = {k: v for k, v in r["launched"].items() if v}
        log(f"obs {level}: stream gmm_large T={T_CHUNKS} x N={N}: events "
            f"{counts}; drift at {drift_t}; kernel_dispatch cuda {cu} vs "
            f"LAUNCHES deltas {want}; state the bits of the run at off")
        if cu != want or set(disp[-1]) != {k + ":cuda" for k in want}:
            raise AssertionError(f"obs {level}: kernel_dispatch {disp[-1]} "
                                 f"against LAUNCHES deltas {want}")
        if not drift_t or drift_t[0] not in (SWITCH, SWITCH + 1):
            raise AssertionError(f"obs {level}: drift events at {drift_t}")
        if counts.get("stream_batch") != T_CHUNKS:
            raise AssertionError(f"obs {level}: {counts}")
        if r["prof"]["device_ops_per_sweep"] != \
                base["prof"]["device_ops_per_sweep"]:
            # the profiled sweeps' device kernels by name and number at
            # both levels, those that differ first
            names = sorted(set(r["ops"]) | set(base["ops"]), key=lambda k: (
                r["ops"].get(k, 0) == base["ops"].get(k, 0), k))
            by_name = "; ".join(f"{k}: {base['ops'].get(k, 0)} at off, "
                                f"{r['ops'].get(k, 0)} at {level}"
                                for k in names)
            log(f"obs {level}: device kernels of the three profiled "
                f"sweeps by name and number -- {by_name}")
            raise AssertionError(
                f"obs {level}: {r['prof']['device_ops_per_sweep']} device "
                f"ops a sweep against {base['prof']['device_ops_per_sweep']}"
                f" at off; by name: {by_name}")
    for level in ("off", "basic", "trace", "off again"):
        r = res[level]
        extra = ("" if level == "off again" else
                 f"; profiled sweep {r['prof']}")
        log(f"obs {level}: stream_fit gmm_large {r['secs']:.4f} s wall; "
            f"sweep {r['wall']:.4f} ms wall (profiler off){extra}; card "
            f"{card}")
    # one sweep under torch.profiler: its Chrome trace names the kernel
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        # late in a long process the first kernels of a trace can go
        # missing from it (as in _stage_ms): the trace opens with small
        # kernels and a wait on the card, then the sweep
        x = torch.zeros(1, device=dev)
        for _ in range(16):
            x.add_(1)
        torch.cuda._sleep(10 ** 7)
        st, _ = vmp.local_step(cp, model.posterior, b.xc, b.xd, b.mask,
                               backend=model.backend)
        vmp.global_update(prior, st)
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(d, "trace.json"))
    with open(os.path.join(d, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    if not any("moments_tile" in n for n in names):
        kern = sorted({e.get("name", "") for e in events
                       if e.get("cat") == "kernel"})
        raise AssertionError(
            f"profiled sweep: the trace names no moments_tile; it holds "
            f"{len(events)} events, {len(kern)} kernel names: {kern[:12]}")
    log(f"profiled sweep: one sweep's trace names "
        f"{sorted(n for n in names if 'moments' in n)}")

    # a warm discrete32 flush at each level
    _, disc, schemas, targets, _, _ = _serving_cases(dev)[0]
    qs = _draw_queries(dev, disc, schemas, targets, 5)[0]
    eng = PGMQueryEngine(disc, mode="exact", pad_pow2=True, device=dev)
    flush_ms, answers = {}, {}
    for level in ("off", "basic", "trace", "off"):
        obs.configure(level=level, path=os.path.join(d, "flush.jsonl"),
                      reset_counters=True)
        times = []
        for _ in range(5):
            sub = [eng.submit(t, ev) for t, ev in qs]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.flush()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        key = level if level not in flush_ms else "off again"
        flush_ms[key] = sorted(times)[2]
        answers[key] = np.stack([q.result for q in sub])
    obs.configure(level="off")
    for level in ("basic", "trace", "off again"):
        if not np.array_equal(answers[level], answers["off"]):
            raise AssertionError(f"obs {level}: served answers differ")
    log(f"obs: discrete32 flush of {len(qs)} queries (3 schemas), median of "
        f"5 warm flushes, ms (off, basic, trace, off) {flush_ms['off']:.3f} "
        f"{flush_ms['basic']:.3f} {flush_ms['trace']:.3f} "
        f"{flush_ms['off again']:.3f}; answers the same bits at every level;"
        f" card {card}")
    return base["state"], xcs, xds, (cp, prior, init)


def _resilience(dev, card, d, full, xcs, xds, plate):
    """(b): checkpointed_stream_fit, a resume after chunk 4, NaN chunks."""
    import torch

    from repro_torch.core import streaming
    from repro_torch.core.streaming import tree_leaves
    from repro_torch.resilience import (CheckpointManager, FaultInjector,
                                        checkpointed_stream_fit,
                                        resume_stream_fit)

    cp, prior, init = plate
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a), tree_leaves(b)))
    kw = dict(sweeps=SWEEPS, tol=0.0)
    cdir = os.path.join(d, "ckpt")
    mgr = CheckpointManager(cdir, every=2, on_drift=True, keep=T_CHUNKS)
    writes = []
    save = mgr.save

    def timed_save(t, state, **k):
        t0 = time.perf_counter()
        out = save(t, state, **k)
        writes.append((t, k.get("reason"), round(time.perf_counter() - t0,
                                                  6)))
        return out

    mgr.save = timed_save
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, info = checkpointed_stream_fit(
        cp, prior, streaming.stream_init(prior, init), xcs, xds,
        manager=mgr, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not same(state, full):
        raise AssertionError("checkpointed_stream_fit: not the bits of the "
                             "uninterrupted fit")
    # a crash after chunk 4: the later snapshots are gone
    for p in mgr.paths():
        if int(p[-12:-4]) > SWITCH:
            os.remove(p)
    t1 = time.perf_counter()
    resumed, tail = resume_stream_fit(
        cp, prior, streaming.stream_init(prior, init), xcs, xds,
        manager=CheckpointManager(cdir, every=2, on_drift=True,
                                  keep=T_CHUNKS), **kw)
    torch.cuda.synchronize()
    resume_secs = time.perf_counter() - t1
    if tail["elbo"].shape[0] != T_CHUNKS - SWITCH or not same(resumed, full):
        raise AssertionError("resume_stream_fit after chunk 4: not the bits "
                             "of the uninterrupted fit")
    inj = FaultInjector(seed=0)
    bad, idx = inj.poison_nan(xcs, rate=2 / T_CHUNKS)
    keep = np.setdiff1d(np.arange(T_CHUNKS), idx)
    sp, ip = streaming.stream_fit(cp, prior,
                                  streaming.stream_init(prior, init), bad,
                                  xds, **kw)
    sc, _ = streaming.stream_fit(cp, prior,
                                 streaming.stream_init(prior, init),
                                 xcs[torch.from_numpy(keep).to(dev)],
                                 xds[torch.from_numpy(keep).to(dev)], **kw)
    quar = ip["quarantined"].nonzero().flatten().tolist()
    # all but the quarantine counter is the state of never seeing them
    skipped = same(sp._replace(n_quarantined=sc.n_quarantined), sc)
    if quar != idx.tolist() or int(sp.n_quarantined) != len(idx) \
            or not skipped:
        raise AssertionError(f"poison_nan: chunks {idx.tolist()} poisoned, "
                             f"{quar} quarantined; skip == never seen "
                             f"{skipped}")
    log(f"resilience gmm_large T={T_CHUNKS} x N={N}: checkpointed_stream_fit"
        f"(every=2, on_drift=True) {secs:.4f} s, the uninterrupted bits; npz "
        f"writes (t, reason, s) {writes}; resume after chunk {SWITCH} "
        f"{resume_secs:.4f} s for {T_CHUNKS - SWITCH} chunks, the "
        f"uninterrupted bits; poison_nan chunks {idx.tolist()} quarantined, "
        f"the bits of never seeing them; card {card}")


def _async_exact(dev, card, total):
    """(c): AsyncPGMServer on discrete32: closed loop at 1 and 2 replicas,
    then an open loop clean and one with a hot swap, a worker crash and a
    slow flush."""
    from repro_torch.data.synthetic import random_discrete_bn
    from repro_torch.serve.queue import AsyncPGMServer

    _, disc, schemas, targets, _, _ = _serving_cases(dev)[0]
    # sampled evidence, the three schemas in turn
    pool = [f[(i % 3) * SERVE_B + i // 3]
            for f in _draw_queries(dev, disc, schemas, targets, 6)
            for i in range(len(f))]
    closed = pool[:ASYNC_CLOSED]
    rates = {1: [], 2: []}
    checked = 0
    for replicas in (1, 2, 2, 1):
        srv = AsyncPGMServer(disc, mode="exact", max_batch=ASYNC_MAX_BATCH,
                             max_delay_ms=ASYNC_DELAY_MS,
                             default_deadline_ms=60_000, replicas=replicas,
                             device=dev)
        buckets = _record_buckets(srv)
        try:
            t0 = time.perf_counter()
            tickets = [srv.submit(t, ev) for t, ev in closed]
            for t in tickets:
                t.result(timeout=120)
            rates[replicas].append(len(tickets) / (time.perf_counter() - t0))
        finally:
            srv.stop()
        n_checked = _check_buckets(buckets, {0: disc}, dev)
        if n_checked != len(tickets):
            raise AssertionError(f"async closed loop, {replicas} replicas: "
                                 f"{n_checked} of {len(tickets)} answers "
                                 f"held against the direct engine")
        checked += n_checked
    log(f"async closed loop discrete32: {ASYNC_CLOSED} queries at once, "
        f"max_batch {ASYNC_MAX_BATCH}; queries/s (1, 2, 2, 1 replicas) "
        f"{rates[1][0]} {rates[2][0]} {rates[2][1]} {rates[1][1]}; "
        f"{checked} answers the bits of the direct engine's buckets; card "
        f"{card}")

    # the burst's rate swings with how the buckets form (a lone worker's
    # buckets grow while it flushes): half the mean of the 1-replica runs
    rate = 0.25 * (rates[1][0] + rates[1][1])
    disc2 = random_discrete_bn(32, card=4, max_parents=3, seed=1, device=dev)
    for faults in (False, True):
        _open_loop(dev, card, total, disc, disc2, pool, rate, faults)


def _open_loop(dev, card, total, disc, disc2, pool, rate, faults):
    """Poisson arrivals at ``rate`` for ASYNC_OPEN_S, 2 replicas; with
    ``faults`` a hot swap to ``disc2``, a worker crash and a slow flush
    during it (and traffic until 0.5 s after the swap publishes)."""
    from repro_torch.kernels import factor_ops
    from repro_torch.resilience import FaultInjector
    from repro_torch.serve.queue import AsyncPGMServer

    gaps = np.random.default_rng(1).exponential(
        1.0 / rate, int(12 * rate * ASYNC_OPEN_S) + 16)
    srv = AsyncPGMServer(disc, mode="exact", max_batch=ASYNC_MAX_BATCH,
                         max_delay_ms=ASYNC_DELAY_MS,
                         default_deadline_ms=ASYNC_DEADLINE_MS, replicas=2,
                         device=dev, supervise_interval_ms=5)
    buckets = _record_buckets(srv)
    inj = FaultInjector(seed=0)
    tickets, handle, crash, slow, swapped = [], None, None, None, None
    label = "with a swap, a crash and a slow flush" if faults else "clean"
    factor_ops.reset_launches()
    try:
        t0 = time.perf_counter()
        nxt = t0
        while True:
            now = time.perf_counter()
            if swapped is None and handle is not None and handle.done():
                swapped = now - t0
            # the window, and with faults 0.5 s of traffic after the swap
            if now - t0 >= ASYNC_OPEN_S and (
                    not faults or (swapped is not None
                                   and now - t0 >= swapped + 0.5)):
                break
            if now - t0 > 10 * ASYNC_OPEN_S:
                raise AssertionError("async open loop: the swap never "
                                     "published")
            if now < nxt:
                time.sleep(nxt - now)
                continue
            tickets.append(srv.submit(*pool[len(tickets) % len(pool)],
                                      deadline_ms=ASYNC_DEADLINE_MS))
            nxt += gaps[len(tickets)]
            if not faults:
                continue
            if crash is None and now - t0 >= 0.2 * ASYNC_OPEN_S:
                crash = inj.crash_worker(srv)
            if handle is None and now - t0 >= 0.2 * ASYNC_OPEN_S:
                handle = srv.swap_model(disc2, block=False)
            if slow is None and now - t0 >= 0.5 * ASYNC_OPEN_S:
                slow = inj.slow_flush(srv, delay_s=0.1, n=1)
        offered_s = time.perf_counter() - t0
        swap = handle.wait(timeout=120) if faults else None
        for t in tickets:
            t.result(timeout=120)
        done_s = time.perf_counter() - t0
    finally:
        srv.stop()
    launched = dict(factor_ops.LAUNCHES)
    st = srv.stats()
    _add(total, launched, "async open loop", "cuda")
    p50, p99 = _latency(tickets)
    misses = sum(t.deadline_miss for t in tickets)
    checked = _check_buckets(buckets, {0: disc, 1: disc2}, dev)
    by_version, sizes = {}, []
    for v, items in buckets:
        by_version[v] = by_version.get(v, 0) + len(items)
        sizes.append(len(items))
    extra = (f"; the swap published {swapped:.3f} s in: {swap}; crash "
             f"{crash}, slow flush {slow}" if faults else "")
    log(f"async open loop discrete32, {label}: Poisson at {rate:.1f} "
        f"queries/s offered (half the closed loop's mean 1-replica rate), "
        f"2 replicas, {len(tickets)} queries in {offered_s:.3f} s, all "
        f"answered {done_s:.3f} s after the first; deadline "
        f"{ASYNC_DEADLINE_MS} ms: p50 {p50:.3f} ms p99 {p99:.3f} ms, misses "
        f"{misses}; flushes {st['flushes']}, bucket sizes median "
        f"{int(np.median(sizes))} max {max(sizes)}; worker_restarts "
        f"{st['worker_restarts']}{extra}; answers by network version "
        f"{by_version}; {checked} answers the bits of the direct engine's "
        f"buckets on their version; launches {launched}; card {card}")
    if st["pending"] or checked != len(tickets) or any(
            t.error is not None for t in tickets):
        raise AssertionError(f"async open loop: {st['pending']} pending, "
                             f"{checked} of {len(tickets)} checked")
    for k in ("log_product", "log_marginalize"):
        if not launched[k]:
            raise AssertionError(f"async open loop: {k} never launched")
    if not faults:
        return
    if st["worker_restarts"] < 1 or not crash["fired"]:
        raise AssertionError("async open loop: the crash did not respawn")
    if not slow["fired"] or swap["new_version"] != 1 or 1 not in by_version:
        raise AssertionError("async open loop: a fault did not fire")


def _async_depth(dev, card, fitted, total):
    """(d): chain12 (cg_weak_marg) and gmm_large's q(Z | x) through the
    server, all queries at once."""
    import torch

    from repro_torch.kernels import factor_ops
    from repro_torch.serve.queue import AsyncPGMServer

    _, chain, schemas, targets, _, _ = _serving_cases(dev)[1]
    qs = _draw_queries(dev, chain, schemas, targets, 7)[0]
    qs = [qs[(i % 2) * SERVE_B + i // 2] for i in range(CHAIN_ASYNC)]
    model, zq, _, _ = fitted["gmm_large"]
    xs = np.asarray(zq.xc[:VMP_ASYNC])
    vq = [("Z", {f"X{i}": float(row[i]) for i in range(xs.shape[1])})
          for row in xs]
    runs = (("chain12", chain, "exact", qs, 1, 128),
            ("gmm_large vmp", model, "vmp", vq, 2, ASYNC_MAX_BATCH))
    for name, m, mode, queries, replicas, mb in runs:
        for warm in (True, False):
            srv = AsyncPGMServer(m, mode=mode, max_batch=mb,
                                 max_delay_ms=ASYNC_DELAY_MS,
                                 default_deadline_ms=60_000,
                                 replicas=replicas, device=dev)
            buckets = _record_buckets(srv)
            factor_ops.reset_launches()
            try:
                t0 = time.perf_counter()
                tickets = [srv.submit(t, ev) for t, ev in queries]
                depth = srv.stats()["pending"]
                for t in tickets:
                    t.result(timeout=120)
                secs = time.perf_counter() - t0
            finally:
                srv.stop()
            torch.cuda.synchronize()
        launched = dict(factor_ops.LAUNCHES)
        _add(total, launched, name, "cuda")
        checked = _check_buckets(buckets, {0: m}, dev, mode)
        st = srv.stats()
        p50, p99 = _latency(tickets)
        log(f"async {name}: {len(queries)} queries at once, max_batch {mb}, "
            f"{replicas} replicas; queue depth {depth} after the submits; "
            f"{len(queries) / secs} queries/s; p50 {p50:.3f} ms p99 "
            f"{p99:.3f} ms; flushes {st['flushes']}; {checked} answers the "
            f"bits of the direct engine's buckets; launches {launched}; card "
            f"{card}")
        if checked != len(queries):
            raise AssertionError(f"async {name}: {checked} answers checked")
        if mode == "exact" and not launched["cg_weak_marg"]:
            raise AssertionError("async chain12: cg_weak_marg never launched")


def _driver(dev, card, d):
    """(e): ``launch.serve.main`` in process, its summary read from the
    obs events it writes."""
    from repro_torch import obs
    from repro_torch.launch import serve as driver

    path = os.path.join(d, "driver.jsonl")
    obs.configure(level="basic", path=path, reset_counters=True)
    try:
        rc = driver.main(["--mode", "exact", "--duration", "3", "--load",
                          "500", "--replicas", "2", "--swap", "--device",
                          str(dev)])
        counts = obs.validate_obs_events(path)
    finally:
        obs.configure(level="off", reset_counters=True)
    with open(path) as fh:
        last = [json.loads(line) for line in fh
                if '"event": "log"' in line][-1]
    log(f"launch.serve --mode exact --duration 3 --load 500 --replicas 2 "
        f"--swap: rc {rc}; {last['msg']}; events {counts}; card {card}")
    if rc != 0 or counts.get("serve_swap") != 1:
        raise AssertionError(f"launch.serve: rc {rc}, events {counts}")


def production_phase(dev, card, fitted):
    """Phase 15: obs, resilience and the async serving tier on the card.
    Returns the kernel launches of its runs."""
    import tempfile

    t_phase = time.perf_counter()
    laps = {}

    def lap(label):
        laps[label] = round(time.perf_counter() - t_phase - sum(laps.values()),
                            2)

    total = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        full, xcs, xds, plate = _obs_levels(dev, card, fitted, d, total)
        lap("obs")
        _resilience(dev, card, d, full, xcs, xds, plate)
        del xcs, xds
        lap("resilience")
        _async_exact(dev, card, total)
        lap("async discrete32")
        _async_depth(dev, card, fitted, total)
        lap("async chain12 and vmp")
        _driver(dev, card, d)
        lap("driver")
    log(f"production phase: {time.perf_counter() - t_phase:.1f} s; seconds "
        f"by step {laps}; launches {total}")
    return total


# -- phases 16-17: the mixture-of-experts and encoder-decoder families -------


def _path_run(counts, fn, name="flash_attention"):
    """:func:`_counted` of ``fn`` with its calls of ``flash_attn.<name>``
    added to ``counts`` by (q shape, k shape)."""
    from repro_torch.kernels import flash_attn

    rec = _ShapeRecorder(flash_attn)
    try:
        out = _counted(fn)
    finally:
        rec.close()
    for key, n in rec.shapes.get(name, {}).items():
        counts[key[:2]] = counts.get(key[:2], 0) + n
    return out


def _only_attention(what, launches, n):
    if launches["flash_attention"] != n or any(
            v for k, v in launches.items() if k != "flash_attention"):
        raise AssertionError(f"{what} launched {launches}, expected {n} "
                             f"flash_attention")


def _moe_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)


def _audio_config():
    from repro_torch.configs import get_config

    return get_config(AUDIO_ARCH)


def _profile_ranges(run, ranges, kernels=()):
    """torch.profiler over ``run()`` with each (module, function name) of
    ``ranges`` wrapped in a ``record_function`` of its name: (wall us, device
    busy us, device kernels, {name: device us of the kernels launched inside
    it, and for each fragment of ``kernels`` the device us of the kernels
    whose name holds it}).  The port's own kernels are launched through
    ctypes, outside any PyTorch op, so the profiler ties them to no range:
    they are found by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = {}

    def wrap(fn, label):
        def inner(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return inner

    for mod, name in ranges:
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, wrap(saved[(mod, name)], name))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    by = {name: 0.0 for name in [n for _, n in ranges] + list(kernels)}
    busy, n = 0.0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            if ev.name in by:
                by[ev.name] += ev.device_time_total
        elif ev.name not in by:             # a kernel, not a range's span
            dur = ev.time_range.elapsed_us()
            busy += dur
            n += 1
            for frag in kernels:
                if frag in ev.name:
                    by[frag] += dur
    return wall_us, busy, n, by


def _moe_increment_check(params, toks, cfg):
    """Each mixtral block on the plain path's own activations: the attention
    sublayer's increment on both backends within INC_REL_MAX, its window one
    kv tile short beyond it, and each ``flash_attention`` launch against its
    plain version on the inputs the block fed it (the same variant failing
    that bar)."""
    import torch

    from repro_torch.nn import layers as L
    from repro_torch.nn import transformer as T

    eps = cfg.norm_eps
    short = dataclasses.replace(cfg, sliding_window=cfg.sliding_window
                                - _attn_tile(cfg.head_dim_))
    incs, bad = {"attention": []}, {"attention": []}

    def attn(p, xn, b, c=cfg):
        return T.attention_block(p["attn"], xn, c, window=c.sliding_window,
                                 backend=b)

    with torch.no_grad(), _AttnWatch(
            {"window one kv tile short": _attn_window_short}) as watch:
        x = L.embed(params["embed"], toks)
        for p in params["blocks"]:
            xn = L.rmsnorm(p["ln1"], x, eps)
            ei = attn(p, xn, "einsum")
            incs["attention"].append(_inc_rel(attn(p, xn, "cuda"), ei))
            bad["attention"].append(_inc_rel(attn(p, xn, "einsum", short),
                                             ei))
            x = T.moe_block(p, x, cfg, "einsum")[0]
    torch.cuda.synchronize()
    _check_increments("moe", incs, bad)
    watch.check("moe")


def moe_phase(dev, card, shapes):
    """Phase 16: mixtral-8x7b at full width, depth cut to MOE_LAYERS (random
    weights from seed 0 on the card), on MOE_B prompts of MOE_S tokens:
    ``forward`` on ``"cuda"`` (exactly one ``flash_attention`` launch a
    layer, nothing else) and on ``"einsum"`` (none), the argmax the same at
    >= LM_ARGMAX_MIN, ``moe_aux`` and the dropped (token, k) pairs of each
    layer printed; each block's increment and kernel launches on the plain
    path's activations (:func:`_moe_increment_check`); warm prefill
    tokens/s on both backends (einsum, cuda, cuda, einsum), peak memory and
    a profiled forward's device time by range (``flash_attention``, the
    expert products, routing); ``DecodeEngine`` serving SERVE_REQUESTS
    greedy requests of MOE_SERVE_NEW tokens; a DECODE_S-token prompt
    teacher-forced through ``decode_step`` against the ``"cuda"`` forward,
    asserted > DECODE_ARGMAX_MIN against the forward with a capacity that
    drops no pair (decode at T = B drops none) and printed against the
    config's.  Returns the launch counts of its main-path runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig
    from repro_torch.nn import moe as Mo
    from repro_torch.nn import transformer as T
    from repro_torch.serve.engine import DecodeEngine, Request

    t_phase = time.perf_counter()
    cfg = _moe_config()
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    layer_gb = 4 * sum(p.numel() for p in params["blocks"][0].parameters()) \
        / 1e9
    log(f"[{card}] moe {cfg.name}: full width, depth cut to {cfg.n_layers} "
        f"of {get_config(MOE_ARCH).n_layers} layers (fp32 weights, "
        f"{layer_gb:.2f} GB a layer), {n_par} parameters, built in "
        f"{time.perf_counter() - t0:.2f} s")
    toks = torch.randint(0, cfg.vocab, (MOE_B, MOE_S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    fwd = {b: (lambda b=b: T.forward(params, toks, cfg, backend=b))
           for b in ("cuda", "einsum")}
    routes, route = [], Mo._route

    def recorded(router_w, x, c):
        out = route(router_w, x, c)
        routes.append(out[1])
        return out

    total = {}
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        Mo._route = recorded
        try:
            cu, secs, launches = _path_run(shapes, fwd["cuda"])
        finally:
            Mo._route = route
        peak = {"cuda": _peak_gb()}
        _only_attention("mixtral prefill on cuda", launches, cfg.n_layers)
        _add(total, launches, "moe prefill", "cuda")
        torch.cuda.reset_peak_memory_stats()
        ei, _, ei_launches = _counted(fwd["einsum"])
        peak["einsum"] = _peak_gb()
        if any(ei_launches.values()):
            raise AssertionError(f"prefill on einsum launched {ei_launches}")
        if not (bool(torch.isfinite(cu.logits).all())
                and cu.logits.shape == (MOE_B, MOE_S, cfg.vocab)
                and bool(torch.isfinite(cu.moe_aux))):
            raise AssertionError("mixtral logits or aux not finite or "
                                 "misshapen")
        agree = _agreement(cu.logits, ei.logits)
        diff = float((cu.logits - ei.logits).abs().max())
        top = float(ei.logits.abs().max())
        cap = Mo.capacity(MOE_B * MOE_S, cfg.moe)
        drops = [float((Mo.ranks(i.reshape(-1), E) >= cap).float().mean())
                 for i in routes]
        aux = (float(cu.moe_aux), float(ei.moe_aux))
        del cu, ei
        log(f"moe prefill B={MOE_B} S={MOE_S} (T = {MOE_B * MOE_S} tokens, "
            f"{cap} slots an expert): launches cuda {launches} (first "
            f"forward {secs:.2f} s), einsum none; argmax agreement "
            f"{agree:.5f} (>= {LM_ARGMAX_MIN}); max |d logit| {diff:.4f} "
            f"beside max |logit| {top:.4f}; moe_aux cuda {aux[0]:.6f} einsum "
            f"{aux[1]:.6f}; dropped pairs by layer {drops}; peak GB cuda "
            f"{peak['cuda']:.2f} einsum {peak['einsum']:.2f}")
        if agree < LM_ARGMAX_MIN:
            raise AssertionError(f"mixtral prefill argmax agreement {agree} "
                                 f"< {LM_ARGMAX_MIN}")
        _moe_increment_check(params, toks, cfg)
        few = dict(iters=2, warmup=1)
        ms = {b: [] for b in fwd}
        for b in ("einsum", "cuda", "cuda", "einsum"):
            ms[b].append(time_ms(fwd[b], **few))
        tps = {b: [round(MOE_B * MOE_S / (m / 1e3), 1) for m in ms[b]]
               for b in ms}
        log(f"moe prefill tokens/s (einsum, cuda, cuda, einsum order; CUDA "
            f"events, warm, 2 forwards each): cuda {tps['cuda']} einsum "
            f"{tps['einsum']}; ms cuda {ms['cuda']} einsum {ms['einsum']}")
        wall_us, busy, n, by = _profile_ranges(
            fwd["cuda"], [(Mo, "_route"), (Mo, "_dispatch_compute")],
            ("flash_attn_",))
        experts = by["_dispatch_compute"] - by["_route"]
        rest = busy - by["flash_attn_"] - by["_dispatch_compute"]
        log(f"moe prefill profiled (cuda): wall {wall_us / 1e3:.2f} ms, "
            f"device busy {busy / 1e3:.2f} ms, idle share "
            f"{max(0.0, 1 - busy / wall_us):.3f}, {n} device ops; device ms: "
            f"flash_attention {by['flash_attn_'] / 1e3:.2f}, "
            f"routing (router, softmax, top-k) {by['_route'] / 1e3:.2f}, "
            f"dispatch + expert products + combine {experts / 1e3:.2f}, the "
            f"rest (projections, norms, embedding, head) {rest / 1e3:.2f}")

    rng = np.random.default_rng(0)
    eng = DecodeEngine(params, cfg, batch=SERVE_SLOTS,
                       capacity=SERVE_CAPACITY)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, rng.integers(4, 12)).tolist(), max_new=MOE_SERVE_NEW)
        for i in range(SERVE_REQUESTS)]
    for r in reqs:
        eng.submit(r)

    def drain():
        steps = 0
        while eng.step() or eng.queue:
            steps += 1
        return steps

    steps, secs, launches = _path_run(shapes, drain)
    if any(launches.values()):
        raise AssertionError(f"mixtral decode launched {launches}")
    if not all(r.done and len(r.out) == MOE_SERVE_NEW for r in reqs):
        raise AssertionError("DecodeEngine left mixtral requests unserved")
    n_tok = SERVE_REQUESTS * MOE_SERVE_NEW
    log(f"moe serving: DecodeEngine batch={SERVE_SLOTS} capacity="
        f"{SERVE_CAPACITY}, {SERVE_REQUESTS} requests x {MOE_SERVE_NEW} new "
        f"tokens in {steps + 1} steps, {secs:.3f} s: {n_tok / secs:.1f} "
        f"generated tokens/s (host clock, greedy)")

    toks = torch.randint(0, cfg.vocab, (1, DECODE_S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    no_drop = dataclasses.replace(cfg, moe=MoEConfig(E, K, E / K))
    with torch.no_grad():
        routes.clear()
        Mo._route = recorded
        try:
            fwd1, _, launches = _path_run(
                shapes, lambda: T.forward(params, toks, cfg).logits[0])
        finally:
            Mo._route = route
        _only_attention("the decode check's forward", launches, cfg.n_layers)
        _add(total, launches, "moe decode check", "cuda")
        cap = Mo.capacity(DECODE_S, cfg.moe)
        dropped = float(sum((Mo.ranks(i.reshape(-1), E) >= cap).float()
                            .mean() for i in routes) / len(routes))
        fwd_nd, _, launches = _path_run(
            shapes, lambda: T.forward(params, toks, no_drop).logits[0])
        _add(total, launches, "moe decode check", "cuda")

        def teacher_forced():
            st = T.init_decode_state(params, cfg, 1, capacity=DECODE_S)
            out = []
            for t in range(DECODE_S):
                lg, st = T.decode_step(params, st, toks[:, t:t + 1], cfg)
                out.append(lg[0, 0])
            return torch.stack(out)

        dec, secs, dec_launches = _path_run(shapes, teacher_forced)
    if any(dec_launches.values()):
        raise AssertionError(f"mixtral decode launched {dec_launches}")
    match = _agreement(dec, fwd_nd)
    match_cfg = _agreement(dec, fwd1)
    log(f"moe decode vs cuda prefill, {DECODE_S} teacher-forced tokens: "
        f"argmax match {match:.4f} against the forward that drops no pair "
        f"(capacity factor {E / K:g}; > {DECODE_ARGMAX_MIN}), {match_cfg:.4f} "
        f"against the config's forward (capacity factor "
        f"{cfg.moe.capacity_factor}, {cap} slots an expert), which dropped "
        f"{dropped:.4f} of its pairs (mean over layers; decode at T = B = 1 "
        f"drops none); max |d logit| {float((dec - fwd_nd).abs().max()):.4f}"
        f"; {DECODE_S / secs:.1f} decode steps/s at B=1")
    if not match > DECODE_ARGMAX_MIN:
        raise AssertionError(f"mixtral decode vs prefill argmax match "
                             f"{match} <= {DECODE_ARGMAX_MIN}")
    del params, eng, dec, fwd1, fwd_nd
    torch.cuda.empty_cache()
    log(f"moe phase: {time.perf_counter() - t_phase:.1f} s")
    return total


def _audio_increment_check(params, toks, enc, cfg):
    """Each whisper block on the plain path's own activations: the
    encoder's self-attention, the decoder's self-attention and its cross
    attention, each increment on both backends within INC_REL_MAX, and
    known-wrong variants beyond it (a causal mask on the encoder, the
    decoder's causal mask dropped, the cross attention's last partial kv
    tile unmasked); each ``flash_attention`` launch against its plain
    version on the inputs the block fed it, with the same variants failing
    that bar (the encoder's also with its partial tile unmasked)."""
    import torch

    from repro_torch.nn import layers as L
    from repro_torch.nn import transformer as T

    eps, tile = cfg.norm_eps, _attn_tile(cfg.head_dim_)
    kinds = ("encoder self-attention", "decoder self-attention",
             "cross attention")
    incs, bad = {k: [] for k in kinds}, {k: [] for k in kinds}
    wrong = {"causal mask on the encoder": _attn_causal_encoder,
             "last partial kv tile unmasked": _attn_unmasked_tail,
             "causal mask dropped": _attn_mask_dropped}

    def attn(p, xn, b, causal, window=None):
        return T.attention_block(p["attn"], xn, cfg, causal=causal,
                                 window=window, backend=b)

    with torch.no_grad(), _AttnWatch(wrong) as watch:
        e = L.add_pos(params["enc_pos"], enc.to(torch.bfloat16))
        for p in params["enc_blocks"]:
            xn = L.rmsnorm(p["ln1"], e, eps)
            ei = attn(p, xn, "einsum", False)
            incs[kinds[0]].append(_inc_rel(attn(p, xn, "cuda", False), ei))
            bad[kinds[0]].append(_inc_rel(attn(p, xn, "einsum", True), ei))
            e = T.encoder_block(p, e, cfg, "einsum")
        x = L.add_pos(params["dec_pos"], L.embed(params["embed"], toks))
        for p in params["blocks"]:
            xn = L.rmsnorm(p["ln1"], x, eps)
            ei = attn(p, xn, "einsum", True)
            incs[kinds[1]].append(_inc_rel(attn(p, xn, "cuda", True), ei))
            bad[kinds[1]].append(_inc_rel(attn(p, xn, "einsum", False), ei))
            ek, ev = T.encoder_kv(p["xattn"], e)
            xn = L.rmsnorm(p["ln_x"], x + ei, eps)
            ci = T.cross_attention_block(p["xattn"], xn, ek, ev, "einsum")
            incs[kinds[2]].append(_inc_rel(T.cross_attention_block(
                p["xattn"], xn, ek, ev, "cuda"), ci))
            bad[kinds[2]].append(_inc_rel(T.cross_attention_block(
                p["xattn"], xn, _pad_keys(ek, tile), _pad_keys(ev, tile),
                "einsum"), ci))
            x = T.decoder_block(p, x, e, cfg, "einsum")
    torch.cuda.synchronize()
    _check_increments("whisper", incs, bad)
    watch.check("whisper")


def audio_phase(dev, card, shapes):
    """Phase 17: whisper-medium at full width and depth (random weights
    from seed 0 on the card), random frame embeddings [AUDIO_B, 1500, d]
    from seed 0 (the reference's own stub input) and AUDIO_B decoder
    prompts of AUDIO_S tokens: ``forward`` on ``"cuda"`` (exactly one
    ``flash_attention`` launch an encoder layer and two a decoder layer:
    72) and on ``"einsum"`` (none), the argmax the same at >=
    LM_ARGMAX_MIN; each block on the plain path's activations
    (:func:`_audio_increment_check`); warm forward times on both backends;
    ``init_decode_state(enc_input=...)`` (one launch an encoder layer), then
    AUDIO_STEPS greedy ``decode_step``s (one launch a decoder layer, Sq =
    1), their tokens the argmax of the same steps on ``"einsum"`` at >=
    LM_ARGMAX_MIN, one more step with each launch held against its plain
    version, and 4 profiled steps.  Returns the launch counts of its
    main-path runs."""
    import torch

    from repro_torch.nn import transformer as T

    t_phase = time.perf_counter()
    cfg = _audio_config()
    n_enc, n_dec = cfg.encoder.n_layers, cfg.n_layers
    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    log(f"[{card}] audio {cfg.name}: full width and depth ({n_enc} encoder "
        f"+ {n_dec} decoder layers), {n_par} parameters, fp32, built in "
        f"{time.perf_counter() - t0:.2f} s")
    enc = torch.randn((AUDIO_B, cfg.encoder.enc_len, cfg.d_model),
                      device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (AUDIO_B, AUDIO_S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    fwd = {b: (lambda b=b: T.forward(params, toks, cfg, backend=b,
                                     enc_input=enc).logits)
           for b in ("cuda", "einsum")}
    total = {}
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        cu, secs, launches = _path_run(shapes, fwd["cuda"])
        peak = _peak_gb()
        _only_attention("whisper forward on cuda", launches,
                        n_enc + 2 * n_dec)
        _add(total, launches, "whisper forward", "cuda")
        ei, _, ei_launches = _counted(fwd["einsum"])
        if any(ei_launches.values()):
            raise AssertionError(f"whisper on einsum launched {ei_launches}")
        if not (bool(torch.isfinite(cu).all())
                and cu.shape == (AUDIO_B, AUDIO_S, cfg.vocab)):
            raise AssertionError("whisper logits not finite or misshapen")
        agree = _agreement(cu, ei)
        log(f"audio forward B={AUDIO_B}, {cfg.encoder.enc_len} frames, "
            f"decoder S={AUDIO_S}: launches cuda {launches} (first forward "
            f"{secs:.2f} s), einsum none; argmax agreement {agree:.5f} (>= "
            f"{LM_ARGMAX_MIN}); max |d logit| "
            f"{float((cu - ei).abs().max()):.4f} beside max |logit| "
            f"{float(ei.abs().max()):.4f}; peak GB cuda {peak:.2f}")
        del cu, ei
        if agree < LM_ARGMAX_MIN:
            raise AssertionError(f"whisper argmax agreement {agree} < "
                                 f"{LM_ARGMAX_MIN}")
        _audio_increment_check(params, toks, enc, cfg)
        few = dict(iters=2, warmup=1)
        ms = {b: [] for b in fwd}
        for b in ("einsum", "cuda", "cuda", "einsum"):
            ms[b].append(time_ms(fwd[b], **few))
        log(f"audio forward ms (einsum, cuda, cuda, einsum order; CUDA "
            f"events, warm, 2 forwards each; {AUDIO_B} x "
            f"{cfg.encoder.enc_len} frames and {AUDIO_B} x {AUDIO_S} decoder "
            f"tokens): cuda {ms['cuda']} einsum {ms['einsum']}")

        st, secs, launches = _path_run(shapes, lambda: T.init_decode_state(
            params, cfg, AUDIO_B, AUDIO_CAPACITY, enc_input=enc))
        _only_attention("init_decode_state", launches, n_enc)
        _add(total, launches, "whisper init_decode_state", "cuda")
        log(f"audio init_decode_state: the encoder once and {n_dec} layers' "
            f"cross K/V in {secs:.3f} s (host clock)")
        tok, fed, outs, step_s = toks[:, :1], [], [], 0.0
        for _ in range(AUDIO_STEPS):
            (lg, st), secs, launches = _path_run(
                shapes, lambda: T.decode_step(params, st, tok, cfg))
            _only_attention("a whisper decode step", launches, n_dec)
            _add(total, launches, "whisper decode", "cuda")
            step_s += secs
            fed.append(tok)
            tok = lg.argmax(-1)
            outs.append(tok)
        st_e = T.init_decode_state(params, cfg, AUDIO_B, AUDIO_CAPACITY,
                                   enc_input=enc, backend="einsum")
        same = []
        for t_in, t_out in zip(fed, outs):
            lg, st_e = T.decode_step(params, st_e, t_in, cfg,
                                     backend="einsum")
            same.append(lg.argmax(-1) == t_out)
        match = float(torch.cat(same, 1).float().mean())
        n_tok = AUDIO_B * AUDIO_STEPS
        log(f"audio decode: {AUDIO_STEPS} greedy steps at B={AUDIO_B}, "
            f"{n_dec} launches a step (cross attention at Sq = 1 against "
            f"{cfg.encoder.enc_len} keys), {step_s:.3f} s: "
            f"{n_tok / step_s:.1f} generated tokens/s (host clock); the same "
            f"steps on einsum give the same token at {match:.4f} (>= "
            f"{LM_ARGMAX_MIN})")
        if match < LM_ARGMAX_MIN:
            raise AssertionError(f"whisper decode tokens agree with einsum at "
                                 f"{match} < {LM_ARGMAX_MIN}")
        with _AttnWatch({"last partial kv tile unmasked":
                         _attn_unmasked_tail}) as watch:
            T.decode_step(params, st, tok, cfg)
        watch.check("whisper decode")

        def steps4():
            for _ in range(4):
                T.decode_step(params, st, tok, cfg)
            torch.cuda.synchronize()

        wall_us, busy, n, mine = _profiled(steps4, ("flash_attn_",))
        log(f"audio decode profiled (4 steps at B={AUDIO_B}): wall "
            f"{wall_us / 4e3:.2f} ms a step, device busy {busy / 4e3:.2f} ms "
            f"a step ({mine / 4e3:.3f} ms of it flash_attention), idle share "
            f"{max(0.0, 1 - busy / wall_us):.3f}, {n / 4:.0f} device ops a "
            f"step")
    del params, st, st_e
    torch.cuda.empty_cache()
    log(f"audio phase: {time.perf_counter() - t_phase:.1f} s")
    return total


def attn_shapes_phase(dev, shapes):
    """``flash_attention`` at the shapes phases 16 and 17 launched -- the
    whisper encoder (non-causal, Sq = Sk = 1500), its cross attention in
    prefill (Sq = AUDIO_S, Sk = 1500) and in decode (Sq = 1), bf16 and
    fp32, and mixtral's causal GQA prefill with its window, bf16 -- each
    as phase 11 checks and times its case (:func:`_attn_case`, with a
    known-wrong variant that must fail).  The bf16 cases are the paths'
    own calls and become kernel rows named ``flash_attention/<where>``,
    with their launches at that shape in phases 16 and 17; the fp32 cases
    become rows ``flash_attention/fp32_<where>`` beside one SDPA call, each
    first launched through the entry point with the counts set to 0 (its
    launches that run's)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(8)
    few = dict(iters=3, warmup=1)
    ac, mc = _audio_config(), _moe_config()
    Sk, H, D = ac.encoder.enc_len, ac.n_heads, ac.head_dim_
    kv = (AUDIO_B, Sk, H, D)
    cases = {
        "whisper_encoder": (kv, kv, False, None, _attn_causal_encoder),
        "whisper_cross": ((AUDIO_B, AUDIO_S, H, D), kv, False, None,
                          _attn_unmasked_tail),
        "whisper_decode_cross": ((AUDIO_B, 1, H, D), kv, False, None,
                                 _attn_unmasked_tail),
        "mixtral": ((MOE_B, MOE_S, mc.n_heads, mc.head_dim_),
                    (MOE_B, MOE_S, mc.n_kv_heads, mc.head_dim_), True,
                    mc.sliding_window, _attn_window_short)}
    rows = {}
    for where, (qs, ks, causal, window, wrong) in cases.items():
        for dtype in (("bfloat16",) if where == "mixtral"
                      else ("float32", "bfloat16")):
            path = dtype == "bfloat16"
            row = _attn_case(dev, g, qs, ks, dtype, window, causal, wrong,
                             True, few, entry=not path)
            if path:
                name = f"flash_attention/{where}"
                row.update(name=name, launches=shapes.get((qs, ks), 0))
            else:
                name = f"flash_attention/fp32_{where}"
                row["name"] = name
            rows[name] = row
    return rows


# -- LM training (train.step, train.optimizer, bayes.vb_optimizer) ----------


def _train_config():
    from repro_torch.configs import get_config

    return get_config(TRAIN_ARCH)


def _gemma_config():
    from repro_torch.configs import get_config

    return get_config(TRAIN_GEMMA_ARCH)


def _ssm_config(arch):
    from repro_torch.configs import get_config

    return get_config(arch)


def _bwd_rel(got, exp):
    """Relative L2 error of one gradient."""
    return float((got.float() - exp).norm() / exp.norm().clamp_min(1e-30))


def _bwd_ratios(got, exp):
    """dq, dk and dv's relative L2 errors over their bar (<= 1 passes):
    BWD_BF16_REL on bf16 gradients, BWD_F32_REL on fp32 ones."""
    import torch

    bar = BWD_BF16_REL if got[0].dtype == torch.bfloat16 else BWD_F32_REL
    return tuple(_bwd_rel(a, e) / bar for a, e in zip(got, exp))


def _bwd_ratio(got, exp):
    """The worst of :func:`_bwd_ratios`."""
    return max(_bwd_ratios(got, exp))


def _ssd_bwd_rel(got, exp):
    """Relative L2 error of one SSD gradient, in fp64."""
    return float((got.double() - exp.double()).norm()
                 / exp.double().norm().clamp_min(1e-300))


def _ssd_bwd_ratios(got, exp):
    """dx, ddt, dA, dB and dC's relative L2 errors over SSD_BWD_REL (<= 1
    passes); a gradient that ``got`` leaves out (None) is skipped."""
    return tuple(_ssd_bwd_rel(a, e) / SSD_BWD_REL for a, e in zip(got, exp)
                 if a is not None)


def _ssd_bwd_ratio(got, exp):
    """The worst of :func:`_ssd_bwd_ratios`."""
    return max(_ssd_bwd_ratios(got, exp))


def _bwd_plain(q, k, v, out, lse, dout, causal, window, q_offset=0):
    from repro_torch.kernels import flash_attn

    return flash_attn.flash_attention_backward_plain(
        q, k, v, out, lse, dout, causal=causal, window=window,
        q_offset=q_offset)


def _bwd_wrong_fold(q, k, v, out, lse, dout, causal, window):
    """Known-wrong: dK and dV folded G-minor (q head h onto kv head h // G
    instead of h % Hkv); as the plain backward of the q heads reordered.
    None where G = 1 or Hkv = 1 (the two folds agree: MQA's every q head
    reads kv head 0 either way)."""
    import torch

    Hq, Hkv = q.shape[2], k.shape[2]
    G = Hq // Hkv
    if G == 1 or Hkv == 1:
        return None
    perm = torch.tensor([hk * G + g for g in range(G) for hk in range(Hkv)],
                        device=q.device)
    dq, dk, dv = _bwd_plain(q[:, :, perm], k, v, out[:, :, perm],
                            lse[:, perm], dout[:, :, perm], causal, window)
    return torch.empty_like(dq).index_copy_(2, perm, dq), dk, dv


def _bwd_no_delta(q, k, v, out, lse, dout, causal, window):
    """Known-wrong: delta = rowsum(dO o O) left out (dS = P o dP)."""
    import torch

    return _bwd_plain(q, k, v, torch.zeros_like(out), lse, dout, causal,
                      window)


BWD_WRONG = {"dK/dV on the wrong kv head": _bwd_wrong_fold,
             "delta left out": _bwd_no_delta}


class _BwdWatch:
    """While open, each ``flash_attention_backward`` launch is held against
    the plain backward in fp32 on the inputs it was given
    (:func:`_bwd_ratio`), launched once more for the same bits (that launch
    is taken off the count: it is a comparison, not the path's), and, on
    the first ``variants`` launches of each kind, each of
    :data:`BWD_WRONG` is measured by the same bar.  :meth:`check` fails on
    a launch over its bar, a relaunch with other bits, a variant under the
    bar or never measured."""

    def __init__(self, variants=1):
        self.variants, self.ratios, self.bad, self.same = variants, {}, {}, []
        self.tried = set()

    def __enter__(self):
        from repro_torch.kernels import flash_attn

        self._mod, self._fn = flash_attn, flash_attn.flash_attention_backward
        flash_attn.flash_attention_backward = self._call
        return self

    def __exit__(self, *exc):
        self._mod.flash_attention_backward = self._fn

    def _call(self, q, k, v, out, lse, dout, *, causal=True, window=None,
              **kw):
        import torch

        got = self._fn(q, k, v, out, lse, dout, causal=causal, window=window,
                       **kw)
        counts, routes = self._mod.LAUNCHES, dict(self._mod.ROUTES)
        n = counts["flash_attention_backward"]
        again = self._fn(q, k, v, out, lse, dout, causal=causal,
                         window=window, **kw)
        counts["flash_attention_backward"] = n
        self._mod.ROUTES.update(routes)
        self.same.append(all(torch.equal(a, b) for a, b in zip(got, again)))
        del again
        exp = _bwd_plain(q, k, v, out, lse, dout, causal, window)
        kind = _attn_kind(q, k, causal, window)
        self.ratios.setdefault(kind, []).append(
            (_bwd_ratios(got, exp), max(float((a.float() - e).abs().max())
                                        for a, e in zip(got, exp))))
        if len(self.ratios[kind]) <= self.variants:
            for name, fn in BWD_WRONG.items():
                w = fn(q, k, v, out, lse, dout, causal, window)
                self.tried.add(name)
                if w is not None:
                    self.bad.setdefault(name, {}).setdefault(
                        kind, []).append(_bwd_ratio(w, exp))
        return got

    def check(self, what):
        for kind, r in self.ratios.items():
            each = [max(a[i] for a, _ in r) for i in range(3)]
            worst = max(each)
            log(f"{what}: flash_attention_backward {kind} on the path's "
                f"activations ({len(r)} launches): relative L2 of dq, dk, dv "
                f"over its bar worst {worst:.3e} (<= 1; dq {each[0]:.3e}, dk "
                f"{each[1]:.3e}, dv {each[2]:.3e}), max |d| "
                f"{max(e for _, e in r):.3e}")
            if worst > 1:
                raise AssertionError(f"{what}: flash_attention_backward "
                                     f"{kind} disagrees with the plain "
                                     f"backward")
        if not all(self.same):
            raise AssertionError(f"{what}: a backward launched again gave "
                                 f"other bits")
        for name in BWD_WRONG:
            if name not in self.tried:
                raise AssertionError(f"{what}: known-wrong variant {name!r} "
                                     f"was never tried")
            if name not in self.bad:
                log(f"{what}: backward known-wrong variant ({name}) does not "
                    f"apply at any launch (G = 1 or Hkv = 1)")
                continue
            for kind, b in self.bad[name].items():
                log(f"{what}: backward known-wrong variant ({name}) at "
                    f"{kind}: least {min(b):.3e} (> 1)")
                if min(b) <= 1:
                    raise AssertionError(f"{what}: the backward's bar does "
                                         f"not separate {name!r} at {kind}")


def _bwd_routes(what, launches):
    """The backward's launches of a counted run by route
    (``flash_attn.ROUTES``, reset with the counts): every one on the bf16
    tensor-core kernels; the copies of a dout that broke their layout rule
    logged."""
    from repro_torch.kernels import flash_attn

    r = flash_attn.ROUTES
    log(f"{what}: flash_attention_backward by route: bf16 wgmma "
        f"{r['bwd_bf16_wgmma']}, fp32 split TF32 {r['bwd_f32_tf32x3']}; dout "
        f"copied {r['bwd_dout_copy']} times")
    if (r["bwd_bf16_wgmma"], r["bwd_f32_tf32x3"]) \
            != (launches["flash_attention_backward"], 0):
        raise AssertionError(f"{what}: backward routes {r}, launches "
                             f"{launches}")


class _Detached:
    """Known-wrong path: ``flash_attention``'s output without a gradient
    (the CUDA route before its autograd.Function: wq, wk and wv get no
    gradient from attention)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attn

        self._mod, self._fn = flash_attn, flash_attn.flash_attention
        flash_attn.flash_attention = lambda *a, **kw: self._fn(
            *a, **kw).detach()
        return self

    def __exit__(self, *exc):
        self._mod.flash_attention = self._fn


def _route_grads(params, batch, cfg, counts):
    """Each parameter's gradient on one batch on ``"cuda"`` (every backward
    launch watched, :class:`_BwdWatch`) and on ``"einsum"``: their relative
    L2 error within GRAD_ROUTE_REL, and beyond it for wq / wk / wv when the
    CUDA route's attention output is detached (:class:`_Detached`); a
    second cuda gradient's bits beside the first's (logged).  Returns the
    cuda run's launch counts."""
    import torch

    from repro_torch.train import step as TS

    n = cfg.n_layers
    with _BwdWatch() as watch:
        out, secs, launches = _path_run(
            counts, lambda: TS.grads_of(params, batch, cfg, backend="cuda"),
            name="flash_attention_backward")
    (_, (loss_c, _)), grads_c = out
    if (launches["flash_attention"], launches["flash_attention_backward"]) \
            != (2 * n, n) or any(v for k, v in launches.items() if k not in (
                "flash_attention", "flash_attention_backward")):
        raise AssertionError(f"a gradient on cuda launched {launches}, "
                             f"expected {2 * n} flash_attention (remat runs "
                             f"each block's forward twice) and {n} "
                             f"flash_attention_backward")
    _bwd_routes("train gradients", launches)
    watch.check("train")
    # the step's determinism, as measured: a second cuda gradient bit for
    # bit (PyTorch's embedding and index_put_ backwards sum with atomics)
    (_, (loss_2, _)), grads_2 = TS.grads_of(params, batch, cfg,
                                            backend="cuda")
    differ = {k: _bwd_rel(grads_2[k], g) for k, g in grads_c.items()
              if not torch.equal(grads_2[k], g)}
    del grads_2
    log(f"train gradients on cuda twice on one batch: loss "
        f"{'the same bits' if torch.equal(loss_2, loss_c) else 'differs'}; "
        f"{len(grads_c) - len(differ)} of {len(grads_c)} parameters' "
        f"gradients the same bits; differing: "
        + (", ".join(f"{k} (relative L2 {v:.3e})"
                     for k, v in sorted(differ.items(),
                                        key=lambda kv: -kv[1])[:6])
           or "none"))
    out, _, ei = _counted(
        lambda: TS.grads_of(params, batch, cfg, backend="einsum"))
    if any(ei.values()):
        raise AssertionError(f"a gradient on einsum launched {ei}")
    (_, (loss_e, _)), grads_e = out
    rel = {k: _bwd_rel(grads_c[k], e) for k, e in grads_e.items()}
    del grads_c, out
    with _Detached():
        (_, (loss_d, _)), grads_d = TS.grads_of(params, batch, cfg,
                                                backend="cuda")
    qkv = [k for k in grads_e if ".attn.w" in k and not k.endswith(".wo")]
    bad = {k: _bwd_rel(grads_d[k], grads_e[k]) for k in qkv}
    del grads_d, grads_e
    worst = max(rel, key=rel.get)
    vals = sorted(rel.values())
    log(f"train gradients on one batch, cuda vs einsum ({len(rel)} "
        f"parameters, first gradient {secs:.2f} s): loss {float(loss_c):.5f} "
        f"vs {float(loss_e):.5f}; relative L2 worst {rel[worst]:.4e} "
        f"({worst}), median {vals[len(vals) // 2]:.4e} (<= "
        f"{GRAD_ROUTE_REL}); with attention's output detached on cuda "
        f"(the route before its backward) wq/wk/wv least "
        f"{min(bad.values()):.4e} (> {GRAD_ROUTE_REL})")
    if abs(float(loss_c) - float(loss_e)) > 1e-2:
        raise AssertionError(f"losses differ: {float(loss_c)} cuda, "
                             f"{float(loss_e)} einsum")
    if rel[worst] > GRAD_ROUTE_REL:
        raise AssertionError(f"{worst}: gradients differ between the routes "
                             f"by {rel[worst]}")
    if min(bad.values()) <= GRAD_ROUTE_REL:
        raise AssertionError("the route bar does not separate a route whose "
                             "attention carries no gradient")
    return launches


MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass")   # cuBLAS's kernels


def _profile_train_step(run):
    """torch.profiler over one step: (wall ms, device busy ms, idle share,
    {class: device ms}, top kernels) with the device kernels split into the
    backward kernels (``flash_bwd_*``), the forward kernel (``flash_attn_*``),
    the SSD scan's backward kernels (``ssd_bwd_*``) and forward kernels
    (``ssd_scan_*``: the forward's and the backward's recomputation), the
    matmuls (cuBLAS's kernel names) and the rest, and the optimizer's
    device time read from a ``record_function`` range around
    ``adamw_update``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.train import optimizer as opt

    fn = opt.adamw_update

    def ranged(*a, **kw):
        with record_function("adamw_update"):
            return fn(*a, **kw)

    opt.adamw_update = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
    finally:
        opt.adamw_update = fn
    cls = {"backward kernels": 0.0, "forward kernel": 0.0,
           "ssd backward kernels": 0.0, "ssd forward kernels": 0.0,
           "matmuls": 0.0, "other": 0.0}
    names, busy, optim = {}, 0.0, 0.0
    for ev in prof.events():
        if ev.name == "adamw_update":     # the range (on both timelines)
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                optim += ev.device_time_total / 1e3
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.time_range.elapsed_us() / 1e3
            busy += dur
            names[ev.name] = names.get(ev.name, 0.0) + dur
            low = ev.name.lower()
            key = ("backward kernels" if "flash_bwd_" in low else
                   "forward kernel" if "flash_attn_" in low else
                   "ssd backward kernels" if "ssd_bwd_" in low else
                   "ssd forward kernels" if "ssd_scan_" in low else
                   "matmuls" if any(f in low for f in MATMUL_NAMES)
                   else "other")
            cls[key] += dur
    cls["optimizer (of other)"] = optim
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    return wall, busy, max(0.0, 1 - busy / wall), cls, top


def _adamw_steps(params, cfg, batches, counts, card):
    """TRAIN_WARM + TRAIN_TIMED AdamW steps (CUDA events a step), then one
    profiled step; the loss finite and below the first step's."""
    import torch

    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as TS

    lr_fn = opt.cosine_schedule(TRAIN_LR, 1, 100)
    state = [TS.init_train_state(params)]
    losses, ms = [], []

    def step(b):
        state[0], m = TS.train_step(state[0], b, cfg, lr_fn=lr_fn)
        return m

    def run():
        for i, b in enumerate(batches[:TRAIN_WARM + TRAIN_TIMED]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            m = step(b)
            end.record()
            losses.append(float(m["loss"]))
            if i >= TRAIN_WARM:
                ms.append(start.elapsed_time(end))

    torch.cuda.reset_peak_memory_stats()
    _, secs, launches = _path_run(counts, run, name="flash_attention_backward")
    peak = _peak_gb()
    n = cfg.n_layers * (TRAIN_WARM + TRAIN_TIMED)
    if (launches["flash_attention"], launches["flash_attention_backward"]) \
            != (2 * n, n):
        raise AssertionError(f"{TRAIN_WARM + TRAIN_TIMED} AdamW steps "
                             f"launched {launches}")
    _bwd_routes("train AdamW steps", launches)
    wall, busy, idle, cls, top = _profile_train_step(
        lambda: step(batches[TRAIN_WARM + TRAIN_TIMED]))
    tokens = TRAIN_B * TRAIN_S
    mean_ms = sum(ms) / len(ms)
    log(f"[{card}] train {cfg.name} AdamW B={TRAIN_B} S={TRAIN_S} "
        f"(lr {TRAIN_LR}, warmup 1): losses {[round(x, 5) for x in losses]}; "
        f"step ms {[round(x, 2) for x in ms]} (CUDA events, after "
        f"{TRAIN_WARM} warm-up), mean {mean_ms:.2f}; training tokens/s "
        f"{tokens / (mean_ms / 1e3):.1f}; peak memory {peak:.2f} GB; "
        f"{secs:.2f} s for the {TRAIN_WARM + TRAIN_TIMED} steps")
    log(f"[{card}] train profiled step: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms, idle share {idle:.4f}; device ms by class "
        + ", ".join(f"{k} {v:.2f} ({v / busy:.4f})" for k, v in cls.items())
        + "; top kernels " + ", ".join(f"{k[:60]} {v:.2f}" for k, v in top))
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"AdamW losses {losses}: not finite or not "
                             f"falling")
    del state[0]
    return launches


def _vb_steps(params, cfg, batches, counts, card):
    """VB_STEPS streaming-VB steps: loss and posterior_kl finite."""
    import torch

    from repro_torch.train import step as TS

    state = [TS.init_vb_state(params)]
    out = []

    def run():
        for b in batches:
            state[0], m = TS.vb_train_step(state[0], b, cfg,
                                           n_total=float(TRAIN_CORPUS),
                                           lr=VB_LR)
            out.append((float(m["loss"]), float(m["kl"])))

    torch.cuda.reset_peak_memory_stats()
    _, secs, launches = _path_run(counts, run, name="flash_attention_backward")
    log(f"[{card}] train {cfg.name} streaming VB (n_total {TRAIN_CORPUS}, "
        f"lr {VB_LR}): (loss, posterior_kl) {out}; {secs:.2f} s for "
        f"{len(batches)} steps; peak memory {_peak_gb():.2f} GB")
    if not all(math.isfinite(a) and math.isfinite(b) for a, b in out):
        raise AssertionError(f"VB steps gave {out}")
    del state[0]
    return launches


def _one_train_step(cfg, batch, counts, card, what, timed=False):
    """One AdamW step of a freshly built trainable ``cfg`` on the card, its
    attention and SSD backward launches watched (:class:`_BwdWatch`,
    :class:`_SsdBwdWatch`): the loss finite.  ``timed``: then one more step
    timed with CUDA events and one profiled (:func:`_profile_train_step`),
    outside the counted run."""
    import torch

    from repro_torch.nn import transformer as T
    from repro_torch.train import step as TS

    dev = batch.tokens.device
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          trainable=True)
    state = [TS.init_train_state(params)]
    out = []

    def step():
        state[0], m = TS.train_step(state[0], batch, cfg)
        out.append(m)

    torch.cuda.reset_peak_memory_stats()
    with _BwdWatch() as watch, _SsdBwdWatch() as ssd_watch:
        _, secs, launches = _path_run(counts, step,
                                      name="flash_attention_backward")
    _bwd_routes(f"train {what}", launches)
    if launches["flash_attention_backward"]:
        watch.check(what)
    ssd_watch.check(what)
    loss = float(out[0]["loss"])
    log(f"[{card}] train {what} ({cfg.name}, {cfg.n_layers} layers): one "
        f"AdamW step, loss {loss:.5f}, launches {launches}, {secs:.2f} s "
        f"with the checks, peak memory {_peak_gb():.2f} GB")
    if not math.isfinite(loss):
        raise AssertionError(f"{what}: loss {loss}")
    if timed:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        wall, busy, idle, cls, top = _profile_train_step(step)
        tokens = batch.tokens.numel()
        log(f"[{card}] train {what} second AdamW step: loss "
            f"{float(out[1]['loss']):.5f}, {ms:.2f} ms (CUDA events), "
            f"training tokens/s {tokens / (ms / 1e3):.1f}; profiled step: "
            f"wall {wall:.2f} ms, device busy {busy:.2f} ms, idle share "
            f"{idle:.4f}; device ms by class "
            + ", ".join(f"{k} {v:.2f} ({v / busy:.4f})"
                        for k, v in cls.items())
            + "; top kernels " + ", ".join(f"{k[:60]} {v:.2f}"
                                           for k, v in top))
        if not all(math.isfinite(float(m["loss"])) for m in out):
            raise AssertionError(f"{what}: losses {out}")
    del state[0], params
    return launches


def _ssd_bwd_plain(x, dt, A, B, C, dy, dhfin, chunk):
    from repro_torch.kernels import ssd_scan

    return ssd_scan.ssd_scan_backward_plain(x, dt, A, B, C, dy, dhfin, chunk)


def _ssd_bwd_one_head(x, dt, A, B, C, dy, dhfin, chunk):
    """Known-wrong: dB and dC of each group's first head alone (a group's
    heads not summed); None where every group has one head."""
    import torch

    H, G = x.shape[2], B.shape[2]
    if H == G:
        return None
    idx = torch.arange(G, device=x.device) * (H // G)
    out = _ssd_bwd_plain(x[:, :, idx], dt[:, :, idx], A[idx], B, C,
                         dy[:, :, idx],
                         None if dhfin is None else dhfin[:, idx], chunk)
    return (None, None, None) + tuple(out[3:])


def _ssd_bwd_chunk_local(x, dt, A, B, C, dy, dhfin, chunk):
    """Known-wrong: every chunk alone (no gradient carried back through the
    states; dhfin reaches the last chunk only)."""
    import torch

    b, S = x.shape[:2]
    n = S // chunk
    fold = lambda t: t.reshape(b * n, chunk, *t.shape[2:])
    dh = None
    if dhfin is not None:
        dh = torch.zeros((b, n) + tuple(dhfin.shape[1:]), device=x.device)
        dh[:, -1] = dhfin
        dh = dh.reshape(b * n, *dhfin.shape[1:])
    dx, ddt, dA, dB, dC = _ssd_bwd_plain(fold(x), fold(dt), A, fold(B),
                                         fold(C), fold(dy), dh, chunk)
    back = lambda t, like: t.reshape(like.shape)
    return back(dx, x), back(ddt, dt), dA, back(dB, B), back(dC, C)


SSD_BWD_WRONG = {"dB/dC of one head a group": _ssd_bwd_one_head,
                 "each chunk alone": _ssd_bwd_chunk_local}


class _SsdBwdWatch:
    """While open, each ``ssd_scan_backward`` launch is held against the
    plain backward in fp32 on the inputs it was given
    (:func:`_ssd_bwd_ratio`), launched once more for the same bits (taken
    off the count), and, on the first ``variants`` launches, each of
    :data:`SSD_BWD_WRONG` is measured by the same bar.  :meth:`check`
    fails on a launch over its bar, a relaunch with other bits, or a
    variant under the bar or never measured; it passes a run that
    launched nothing."""

    def __init__(self, variants=1):
        self.variants, self.ratios, self.bad, self.same = variants, [], {}, []
        self.tried = set()

    def __enter__(self):
        from repro_torch.kernels import ssd_scan

        self._mod, self._fn = ssd_scan, ssd_scan.ssd_scan_backward
        ssd_scan.ssd_scan_backward = self._call
        return self

    def __exit__(self, *exc):
        self._mod.ssd_scan_backward = self._fn

    def _call(self, *args):
        import torch

        got = self._fn(*args)
        counts, routes = self._mod.LAUNCHES, dict(self._mod.ROUTES)
        n = counts["ssd_scan_backward"]
        again = self._fn(*args)
        counts["ssd_scan_backward"] = n
        self._mod.ROUTES.update(routes)
        self.same.append(all(torch.equal(a, b) for a, b in zip(got, again)))
        del again
        exp = _ssd_bwd_plain(*args)
        self.ratios.append((_ssd_bwd_ratios(got, exp),
                            max(float((a - e).abs().max())
                                for a, e in zip(got, exp))))
        if len(self.ratios) <= self.variants:
            for name, fn in SSD_BWD_WRONG.items():
                w = fn(*args)
                self.tried.add(name)
                if w is not None:
                    self.bad.setdefault(name, []).append(
                        _ssd_bwd_ratio(w, exp))
        return got

    def check(self, what):
        if not self.ratios:
            return
        each = [max(r[i] for r, _ in self.ratios) for i in range(5)]
        log(f"{what}: ssd_scan_backward on the path's activations "
            f"({len(self.ratios)} launches): relative L2 over its bar worst "
            f"{max(each):.3e} (<= 1; dx {each[0]:.3e}, ddt {each[1]:.3e}, dA "
            f"{each[2]:.3e}, dB {each[3]:.3e}, dC {each[4]:.3e}), max |d| "
            f"{max(e for _, e in self.ratios):.3e}")
        if max(each) > 1:
            raise AssertionError(f"{what}: ssd_scan_backward disagrees with "
                                 f"the plain backward")
        if not all(self.same):
            raise AssertionError(f"{what}: an SSD backward launched again "
                                 f"gave other bits")
        for name in SSD_BWD_WRONG:
            if name not in self.tried:
                raise AssertionError(f"{what}: known-wrong variant {name!r} "
                                     f"was never tried")
            if name not in self.bad:
                log(f"{what}: SSD backward known-wrong variant ({name}) does "
                    f"not apply (one head a group)")
                continue
            b = self.bad[name]
            log(f"{what}: SSD backward known-wrong variant ({name}): least "
                f"{min(b):.3e} (> 1)")
            if min(b) <= 1:
                raise AssertionError(f"{what}: the SSD backward's bar does "
                                     f"not separate {name!r}")


class _SsdNoisyY:
    """The einsum route with ``ssd_chunked``'s y multiplied by (1 +
    SSM_NOISE_REL r), r standard normal from a fixed seed: how far the
    model itself moves its gradients under errors of the SSD kernels'
    size."""

    def __init__(self, dev):
        import torch

        self.g = torch.Generator(device=dev).manual_seed(5)

    def __enter__(self):
        from repro_torch.nn import ssm

        self._mod, self._fn = ssm, ssm.ssd_chunked
        ssm.ssd_chunked = self._call
        return self

    def _call(self, *args, **kw):
        import torch

        y, h = self._fn(*args, **kw)
        r = torch.randn(y.shape, generator=self.g, device=y.device)
        return y * (1 + SSM_NOISE_REL * r), h

    def __exit__(self, *exc):
        self._mod.ssd_chunked = self._fn


class _SsdDetached:
    """Known-wrong path: ``ssd_scan``'s outputs without a gradient (the CUDA
    route before its autograd.Function)."""

    def __enter__(self):
        from repro_torch.kernels import ssd_scan

        self._mod, self._fn = ssd_scan, ssd_scan.ssd_scan
        ssd_scan.ssd_scan = lambda *a: tuple(t.detach()
                                             for t in self._fn(*a))
        return self

    def __exit__(self, *exc):
        self._mod.ssd_scan = self._fn


def _ssm_launches(what, cfg, launches):
    """A hybrid or ssm gradient's launches: ssd_scan twice a Mamba2 block
    (remat) and its backward once; the shared attention block likewise."""
    n = cfg.n_layers
    n_attn = n // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
    exp = {"ssd_scan": 2 * n, "ssd_scan_backward": n,
           "flash_attention": 2 * n_attn, "flash_attention_backward": n_attn}
    if any(launches.get(k, 0) != v for k, v in exp.items()) or any(
            v for k, v in launches.items() if k not in exp):
        raise AssertionError(f"{what} launched {launches}, expected {exp}")


def _ssm_route_grads(params, batch, cfg):
    """zamba2's gradients on one batch on ``"cuda"`` (every SSD and
    attention backward launch watched) and on ``"einsum"``: each
    parameter's relative L2 error within GRAD_ROUTE_REL, the losses within
    1e-2; the median error within SSM_NOISE_MEDIANS times the median of
    einsum's own gap under errors of the kernels' size
    (:class:`_SsdNoisyY`), as this random model amplifies them to near the
    bar; and the Mamba2 weights that only the scan reaches beyond the bar
    when ``ssd_scan``'s outputs are detached on cuda
    (:class:`_SsdDetached`).  Returns the cuda run's launch counts."""
    import torch

    from repro_torch.train import step as TS

    with _SsdBwdWatch() as watch, _BwdWatch() as awatch:
        out, secs, launches = _counted(
            lambda: TS.grads_of(params, batch, cfg, backend="cuda"))
    _ssm_launches(f"{cfg.name} gradient on cuda", cfg, launches)
    watch.check(f"{cfg.name} gradients")
    awatch.check(f"{cfg.name} gradients")
    (_, (loss_c, _)), grads_c = out
    out, _, ei = _counted(
        lambda: TS.grads_of(params, batch, cfg, backend="einsum"))
    if any(ei.values()):
        raise AssertionError(f"a gradient on einsum launched {ei}")
    (_, (loss_e, _)), grads_e = out
    rel = {k: _bwd_rel(grads_c[k], e) for k, e in grads_e.items()}
    del grads_c, out
    with _SsdNoisyY(batch.tokens.device):
        grads_n = TS.grads_of(params, batch, cfg, backend="einsum")[1]
    noise = {k: _bwd_rel(grads_n[k], e) for k, e in grads_e.items()}
    del grads_n
    with _SsdDetached():
        (_, (loss_d, _)), grads_d = TS.grads_of(params, batch, cfg,
                                                backend="cuda")
    # the weights whose gradient flows through the scan alone
    ssd = [k for k in grads_e if k.endswith(("mamba.w_B", "mamba.w_C",
                                             "mamba.w_dt", "mamba.dt_bias",
                                             "mamba.A_log"))]
    bad = {k: _bwd_rel(grads_d[k], grads_e[k]) for k in ssd}
    del grads_d, grads_e
    torch.cuda.empty_cache()
    worst = max(rel, key=rel.get)
    med = sorted(rel.values())[len(rel) // 2]
    n_worst = max(noise, key=noise.get)
    n_med = sorted(noise.values())[len(noise) // 2]
    most = max(rel, key=lambda k: rel[k] / max(noise[k], 1e-30))
    log(f"train {cfg.name} gradients on one batch, cuda vs einsum "
        f"({len(rel)} parameters, first gradient {secs:.2f} s): loss "
        f"{float(loss_c):.5f} vs {float(loss_e):.5f}; relative L2 worst "
        f"{rel[worst]:.4e} ({worst}), median {med:.4e} (<= "
        f"{GRAD_ROUTE_REL}); einsum vs einsum with y (1 + {SSM_NOISE_REL:g} "
        f"r): worst {noise[n_worst]:.4e} ({n_worst}), median {n_med:.4e}; "
        f"the medians' ratio {med / n_med:.4f} (<= {SSM_NOISE_MEDIANS:g}), "
        f"a parameter's most {rel[most] / max(noise[most], 1e-30):.4f} "
        f"({most}); with ssd_scan's outputs detached on cuda the "
        f"Mamba2 weights (w_B, w_C, w_dt, dt_bias, A_log) least "
        f"{min(bad.values()):.4e} (> {GRAD_ROUTE_REL})")
    if abs(float(loss_c) - float(loss_e)) > 1e-2:
        raise AssertionError(f"{cfg.name}: losses differ: {float(loss_c)} "
                             f"cuda, {float(loss_e)} einsum")
    if rel[worst] > GRAD_ROUTE_REL:
        raise AssertionError(f"{cfg.name} {worst}: gradients differ between "
                             f"the routes by {rel[worst]}")
    if not med <= SSM_NOISE_MEDIANS * n_med:
        raise AssertionError(f"{cfg.name}: the routes' median gap {med} is "
                             f"beyond {SSM_NOISE_MEDIANS} x einsum's own "
                             f"under errors of {SSM_NOISE_REL}, {n_med}")
    if min(bad.values()) <= GRAD_ROUTE_REL:
        raise AssertionError("the route bar does not separate a route whose "
                             "SSD scan carries no gradient")
    return launches


def train_phase(dev, card):
    """Phase 18: granite-3-2b at full width and depth, trainable, random
    weights from seed 0, on TRAIN_B x TRAIN_S batches streamed from
    ``markov_sequence_fast(TRAIN_CORPUS, vocab, seed=0)``: the gradients of
    one batch on both routes (:func:`_route_grads`), AdamW steps
    (:func:`_adamw_steps`), VB steps (:func:`_vb_steps`); then one AdamW
    step of mixtral-8x7b cut to TRAIN_MOE_LAYERS layer (B = MOE_B, S =
    MOE_S), of whisper-medium (B = AUDIO_B frames and prompts of AUDIO_S)
    and of gemma-2b at full width and depth (D = 256, MQA; TRAIN_GEMMA_B x
    TRAIN_GEMMA_S), each backward launch watched; then zamba2-1.2b's
    gradients on one batch on both routes (:func:`_ssm_route_grads`) and
    one AdamW step each of zamba2-1.2b and mamba2-1.3b at full width and
    depth on TRAIN_B x TRAIN_S, every SSD and attention backward launch
    watched, each followed by a timed and a profiled step.  Returns (launch totals, backward
    launches by (q shape, k shape) and ``("ssd_scan_backward", what)``)."""
    import torch

    from repro_torch.data.tokens import TokenStream, markov_sequence_fast
    from repro_torch.nn import transformer as T

    cfg = _train_config()
    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          trainable=True)
    corpus = markov_sequence_fast(TRAIN_CORPUS, cfg.vocab, seed=0)
    stream = TokenStream(corpus, TRAIN_B, TRAIN_S, device=dev)
    n_batches = 1 + TRAIN_WARM + TRAIN_TIMED + 1 + VB_STEPS
    batches = list(stream.batches(n_batches))
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    log(f"[{card}] train {cfg.name}: {n_par} parameters, fp32, trainable; "
        f"{n_batches} batches of [{TRAIN_B}, {TRAIN_S}] from a "
        f"{TRAIN_CORPUS}-token Markov corpus; {time.perf_counter() - t0:.2f} "
        f"s")
    total, counts = {}, {}
    for launches in (_route_grads(params, batches[0], cfg, counts),
                     _adamw_steps(params, cfg, batches[1:-VB_STEPS], counts,
                                  card),
                     _vb_steps(params, cfg, batches[-VB_STEPS:], counts,
                               card)):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    del params, batches
    torch.cuda.empty_cache()

    mc = dataclasses.replace(_moe_config(), n_layers=TRAIN_MOE_LAYERS)
    moe_batch = next(TokenStream(markov_sequence_fast(
        TRAIN_CORPUS, mc.vocab, seed=0), MOE_B, MOE_S, device=dev
    ).batches(1))
    ac = _audio_config()
    audio_batch = next(TokenStream(markov_sequence_fast(
        TRAIN_CORPUS, ac.vocab, seed=0), AUDIO_B, AUDIO_S,
        enc_stub=(ac.encoder.enc_len, ac.d_model), device=dev).batches(1))
    gc = _gemma_config()
    gemma_batch = next(TokenStream(markov_sequence_fast(
        TRAIN_CORPUS, gc.vocab, seed=0), TRAIN_GEMMA_B, TRAIN_GEMMA_S,
        device=dev).batches(1))
    for cfg_, batch, what, n_attn in (
            (mc, moe_batch, "mixtral", mc.n_layers),
            (ac, audio_batch, "whisper", ac.encoder.n_layers
             + 2 * ac.n_layers),
            (gc, gemma_batch, "gemma", gc.n_layers)):
        launches = _one_train_step(cfg_, batch, counts, card, what)
        if (launches["flash_attention"], launches["flash_attention_backward"]
                ) != (2 * n_attn, n_attn):
            raise AssertionError(f"{what}'s step launched {launches}, "
                                 f"expected {2 * n_attn} and {n_attn}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        torch.cuda.empty_cache()

    for what, arch in TRAIN_SSM.items():
        sc = _ssm_config(arch)
        batch = next(TokenStream(markov_sequence_fast(
            TRAIN_CORPUS, sc.vocab, seed=0), TRAIN_B, TRAIN_S, device=dev
        ).batches(1))
        runs = []
        if what == "zamba2":
            params = T.init_model(torch.Generator(device=dev).manual_seed(0),
                                  sc, trainable=True)
            runs.append(_ssm_route_grads(params, batch, sc))
            del params
            torch.cuda.empty_cache()
        runs.append(_one_train_step(sc, batch, counts, card, what,
                                    timed=True))
        _ssm_launches(f"{what}'s step", sc, runs[-1])
        for launches in runs:
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
        counts[("ssd_scan_backward", what)] = sum(
            r["ssd_scan_backward"] for r in runs)
        torch.cuda.empty_cache()
    return total, counts


def _bwd_case(dev, g, qs, ks, causal, window, few, q_offset=0,
              dtype="bfloat16"):
    """The backward kernels at q shape ``qs``, k/v shape ``ks`` on random
    inputs of ``dtype`` (query i at position ``q_offset + i``), from the
    forward kernel's output and lse: two launches the same bits, against
    the plain backward in fp32 (:func:`_bwd_ratio` <= 1: BWD_BF16_REL or
    BWD_F32_REL) with each known-wrong variant failing that bar (at an
    offset, the kernels at offset 0 on the same output and lse), timed
    (CUDA events) beside the plain backward, the bound (10 D flops a live
    pair at the bf16 tensor-core peak, or at split TF32's peak on fp32
    inputs (the least time for fp32-accurate products), or the bytes) and
    the backward of one
    ``scaled_dot_product_attention`` call (``is_causal`` without a window,
    a boolean mask with one; k and v expanded to the q heads beforehand;
    its backend the one PyTorch's dispatcher picks, ``_fused_sdp_choice``).
    On fp32 inputs the entry point a user calls, ``flash_attention`` on
    inputs that require grad and ``torch.autograd.grad`` of its output, is
    run with the counts set to 0 (one forward and one backward launch, on
    the fp32 route): the forward's output and the gradients the bits of
    the direct calls, and the row's launches that run's.  Returns the
    kernel row."""
    import torch
    import torch.nn.functional as Fnn
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels import flash_attn

    B, Sq, Hq, D = qs
    Sk, Hkv = ks[1], ks[2]
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(dt)
               for s in (qs, ks, ks))
    dout = torch.randn(qs, generator=g, device=dev).to(dt)
    out, lse = flash_attn._forward(q, k, v, causal, window, None, True,
                                   q_offset)
    kern = lambda: flash_attn.flash_attention_backward(
        q, k, v, out, lse, dout, causal=causal, window=window,
        q_offset=q_offset)
    got, again = kern(), kern()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_attention_backward q{qs} k{ks}: two "
                             f"launches differ")
    del again
    exp = _bwd_plain(q, k, v, out, lse, dout, causal, window, q_offset)
    ratio = _bwd_ratio(got, exp)
    err = max(float((a.float() - e).abs().max()) for a, e in zip(got, exp))
    bad = {}
    for name, fn in BWD_WRONG.items():
        w = fn(q, k, v, out, lse, dout, causal, window) if not q_offset \
            else None
        if w is not None:   # the wrong fold is no variant at G = 1, Hkv = 1
            bad[name] = _bwd_ratio(w, exp)
    if q_offset:
        bad["the kernels at offset 0"] = _bwd_ratio(
            flash_attn.flash_attention_backward(
                q, k, v, out, lse, dout, causal=causal, window=window), exp)
    del exp
    if ratio > 1 or min(bad.values()) <= 1:
        raise AssertionError(f"flash_attention_backward q{qs} k{ks} window="
                             f"{window} causal={causal}: relative L2 over "
                             f"its bar {ratio}, the known-wrong variants' "
                             f"{bad}")
    launches = 0
    if dtype == "float32":
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))

        def entry():
            o = flash_attn.flash_attention(qr, kr, vr, causal=causal,
                                           window=window, q_offset=q_offset)
            return o, torch.autograd.grad(o, (qr, kr, vr), dout)

        (o, auto), _, counted = _counted(entry)
        routes = dict(flash_attn.ROUTES)
        same = torch.equal(o, out) and all(
            torch.equal(a, b) for a, b in zip(auto, got))
        launches = counted["flash_attention_backward"]
        if not same or (counted["flash_attention"], launches,
                        routes["f32_tf32x3"], routes["bwd_f32_tf32x3"]) \
                != (1, 1, 1, 1) or any(n for name, n in counted.items()
                                       if not name.startswith("flash_")):
            raise AssertionError(f"flash_attention fp32 q{qs} k{ks} through "
                                 f"autograd: the direct calls' bits {same}, "
                                 f"launches {counted}, routes {routes}")
        del o, auto, qr, kr, vr
    del got
    nops = flash_attn.attention_flops(B, Sq, Sk, Hq, D, causal, window,
                                      q_offset, backward=True)
    nbytes = q.element_size() * (4 * q.numel() + 4 * k.numel()) \
        + 4 * lse.numel()
    peak = BF16_OPS_PER_S if dtype == "bfloat16" else SPLIT_TF32_OPS_PER_S
    b_ms, b_by = bound(nbytes, nops, peak)
    row = dict(name="flash_attention_bwd", route="cuda",
               source=FA_BWD_SOURCE, replaces=REPLACES["flash_attention"],
               launches=launches, max_abs_err=err, ms=time_ms(kern, **few),
               plain_ms=time_ms(lambda: _bwd_plain(q, k, v, out, lse, dout,
                                                   causal, window, q_offset),
                                iters=2, warmup=1),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    heads = torch.arange(Hq, device=dev) % Hkv
    qx = q.transpose(1, 2).detach().requires_grad_()
    kx, vx = (t[:, :, heads].transpose(1, 2).detach().requires_grad_()
              for t in (k, v))
    mask = _attn_mask(dev, Sq, Sk, causal, window, q_offset) \
        if window is not None or q_offset else None
    o = Fnn.scaled_dot_product_attention(
        qx, kx, vx, attn_mask=mask, is_causal=causal and mask is None)
    gx = dout.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(o, (qx, kx, vx), gx,
                                           retain_graph=True)
    row["library_ms"] = time_ms(sdpa_bwd, **few)
    backend = SDPBackend(torch._fused_sdp_choice(
        qx, kx, vx, mask, 0.0, causal and mask is None)).name.lower()
    del o, qx, kx, vx
    kind = ("causal" if causal else "non-causal") + (
        f" q_offset={q_offset}" if q_offset else "")
    bar = BWD_BF16_REL if dtype == "bfloat16" else BWD_F32_REL
    log(f"kernel flash_attention_backward {dtype} {kind} window={window} at "
        f"q [B={B}, Sq={Sq}, Hq={Hq}, "
        f"D={D}], k/v [Sk={Sk}, Hkv={Hkv}]: against the plain backward in "
        f"fp32 on the kernel's output and lse, relative L2 of dq, dk, dv "
        f"over {bar:.4g} worst {ratio:.3f} (known-wrong: "
        + ", ".join(f"{k} {v:.1f}" for k, v in bad.items())
        + f"), max_abs_err {err:.3e}, bitwise repeatable"
        + (", through autograd the same bits (launches: 1 forward, 1 "
           "backward)" if launches else "")
        + f"; ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
        f"sdpa_backward_ms {row['library_ms']:.4f} (backend {backend}) "
        f"bound_ms {b_ms:.4f} ({b_by}: {nops / 1e9:.1f} GFLOP at the "
        f"{'bf16' if dtype == 'bfloat16' else 'split TF32'} peak); "
        f"{nops / row['ms'] / 1e9:.1f} TFLOP/s, {b_ms / row['ms']:.4f} of "
        f"the bound")
    return row



def train_rows_phase(dev, counts):
    """``flash_attention_backward`` at the shapes phase 18's steps launched
    it -- granite's causal GQA [2, 4096, 32/8, 64], mixtral's [2, 8192,
    32/8, 128] with its 4096 window, whisper's encoder (non-causal, 1500 x
    1500) and cross attention (448 x 1500) at B = 8, gemma's causal MQA
    [2, 4096, 8/1, 256] -- as kernel rows ``flash_attention_bwd/<where>``
    (:func:`_bwd_case`), each with its launches at that shape in phase
    18; then the fp32 route at BWD_F32_CASES, each driven once through
    ``flash_attention`` and autograd, and its forward there as rows
    ``flash_attention/<where>`` (:func:`_attn_case`, launched once through
    the entry point, beside one SDPA call; known-wrong: the causal mask
    dropped, or one added)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(9)
    few = dict(iters=3, warmup=1)
    tc, mc, ac = _train_config(), _moe_config(), _audio_config()
    gc = _gemma_config()
    kv = (AUDIO_B, ac.encoder.enc_len, ac.n_heads, ac.head_dim_)
    cases = {
        "granite": ((TRAIN_B, TRAIN_S, tc.n_heads, tc.head_dim_),
                    (TRAIN_B, TRAIN_S, tc.n_kv_heads, tc.head_dim_), True,
                    tc.sliding_window),
        "mixtral": ((MOE_B, MOE_S, mc.n_heads, mc.head_dim_),
                    (MOE_B, MOE_S, mc.n_kv_heads, mc.head_dim_), True,
                    mc.sliding_window),
        "whisper_encoder": (kv, kv, False, None),
        "whisper_cross": ((AUDIO_B, AUDIO_S, ac.n_heads, ac.head_dim_), kv,
                          False, None),
        "gemma": ((TRAIN_GEMMA_B, TRAIN_GEMMA_S, gc.n_heads, gc.head_dim_),
                  (TRAIN_GEMMA_B, TRAIN_GEMMA_S, gc.n_kv_heads, gc.head_dim_),
                  True, gc.sliding_window)}
    rows = {}
    for where, (qs, ks, causal, window) in cases.items():
        row = _bwd_case(dev, g, qs, ks, causal, window, few)
        name = f"flash_attention_bwd/{where}"
        row.update(name=name, launches=counts.get((qs, ks), 0))
        rows[name] = row
    # the fp32 route, each through the entry point once (its launches are
    # that run's)
    for where, (qs, ks, causal) in BWD_F32_CASES.items():
        row = _bwd_case(dev, g, qs, ks, causal, None, few, dtype="float32")
        row["name"] = name = f"flash_attention_bwd/{where}"
        rows[name] = row
        wrong = _attn_mask_dropped if causal else _attn_causal_encoder
        row = _attn_case(dev, g, qs, ks, "float32", None, causal, wrong, True,
                         few, entry=True)
        row["name"] = name = f"flash_attention/{where}"
        rows[name] = row
    for what, arch in TRAIN_SSM.items():
        row = _ssd_bwd_case(dev, g, _ssm_config(arch), few)
        name = f"ssd_scan_bwd/{what}"
        row.update(name=name,
                   launches=counts.get(("ssd_scan_backward", what), 0))
        rows[name] = row
    return rows


def _ssd_bwd_case(dev, g, cfg, few):
    """``ssd_scan_backward`` at the call a Mamba2 block of ``cfg`` makes on
    TRAIN_B x TRAIN_S (x [b, S, H, P], B/C strided views [b, S, G, N], no
    dhfin) on random inputs with the prefill phase's dt = softplus(randn -
    4): two launches the same bits, against the plain backward in fp32
    (:func:`_ssd_bwd_ratio` <= 1) with each known-wrong variant beyond the
    bar, timed (CUDA events) beside the plain backward and the bound: the
    bytes of the inputs read once and the gradients written once, or the
    function's multiply-adds, 2 flops each, at split TF32's rate -- per
    (batch, head, chunk) 5 l P N (the chunk states, the pull on h_prev,
    dxd's, dB's and dC's carried-state parts; dcum's carried terms reuse
    dC's and dB's) + 2 T P (dxd's intra part, D formed once) + 2 T N (L ⊙ D
    times B and C) with T = l (l + 1) / 2 pairs j <= i, and C B^T once per
    (batch, group, chunk), T N.
    No one PyTorch call computes it: library_ms None.  A profiled call logs
    each kernel's device ms by name (the recomputation's ``ssd_scan_*``
    kernels and the six ``ssd_bwd_*``).  Returns the kernel row."""
    import torch
    import torch.nn.functional as Fnn
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import clg_stats, ssd_scan

    b, S = TRAIN_B, TRAIN_S
    d_in = cfg.ssm.expand * cfg.d_model
    P, G, N, l = cfg.ssm.head_dim, cfg.ssm.n_groups, cfg.ssm.state_dim, \
        cfg.ssm.chunk
    H = d_in // P
    rn = lambda *sh: torch.randn(*sh, generator=g, device=dev)
    x, dy = rn(b, S, H, P), rn(b, S, H, P)
    dt = Fnn.softplus(rn(b, S, H) - 4.0)
    A = torch.exp(torch.linspace(0.0, 2.77, H, device=dev))
    B, C = (t.reshape(b, S, G, N) for t in rn(b, S, 2 * G * N).chunk(2, -1))
    args = (x, dt, A, B, C, dy, None, l)
    kern = lambda: ssd_scan.ssd_scan_backward(*args)
    got, again = kern(), kern()
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        raise AssertionError(f"ssd_scan_backward {cfg.name}: two launches "
                             f"differ")
    del again
    exp = _ssd_bwd_plain(*args)
    ratio = _ssd_bwd_ratio(got, exp)
    err = max(float((u - e).abs().max()) for u, e in zip(got, exp))
    bad = {name: _ssd_bwd_ratio(w, exp) for name, fn in SSD_BWD_WRONG.items()
           if (w := fn(*args)) is not None}
    del got, exp
    if ratio > 1 or not bad or min(bad.values()) <= 1:
        raise AssertionError(f"ssd_scan_backward {cfg.name}: relative L2 over "
                             f"its bar {ratio}, the known-wrong variants' "
                             f"{bad}")
    nops = ssd_scan.ssd_bwd_flops(b, S, H, P, G, N, l)
    nbytes = 4 * (3 * x.numel() + 2 * dt.numel() + 2 * H + 4 * B.numel())
    b_ms, b_by = bound(nbytes, nops, SPLIT_TF32_OPS_PER_S)
    row = dict(name="ssd_scan_bwd", route="cuda", source=SSD_BWD_SOURCE,
               replaces=REPLACES["ssd_scan"], launches=0, max_abs_err=err,
               ms=time_ms(kern, **few),
               plain_ms=time_ms(lambda: _ssd_bwd_plain(*args), **few),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    stages = {}
    for _ in range(3):     # a profile may come back without device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kern()
            torch.cuda.synchronize()
        for ev in prof.events():
            m = re.search(r"(ssd_\w+)", ev.name)
            if ev.device_type == torch.autograd.DeviceType.CUDA and m:
                stages[m.group(1)] = stages.get(m.group(1), 0.0) \
                    + ev.time_range.elapsed_us() / 1e3
        if stages:
            break
    log(f"kernel ssd_scan_backward ({cfg.name}) at x [b={b}, S={S}, H={H}, "
        f"P={P}], B/C [G={G}, N={N}], chunk {l}: against the plain backward "
        f"in fp32, relative L2 of dx, ddt, dA, dB, dC over {SSD_BWD_REL:g} "
        f"worst {ratio:.3f} (known-wrong: "
        + ", ".join(f"{k} {v:.1f}" for k, v in bad.items())
        + f"), max_abs_err {err:.3e}, bitwise repeatable; ms {row['ms']:.4f} "
        f"plain_ms {row['plain_ms']:.4f} bound_ms {b_ms:.4f} ({b_by}: "
        f"{nops / 1e9:.1f} GFLOP at split TF32's "
        f"{SPLIT_TF32_OPS_PER_S / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.1f} MB); "
        f"{b_ms / row['ms']:.4f} of the bound; blocks per SM "
        f"{ssd_scan.bwd_blocks_per_sm(l, N)}; dB/dC slices "
        f"{ssd_scan.bwd_slices(b, S, H, G, N, l, clg_stats.sm_count(dev))}"
        f" in clusters of {ssd_scan.dbc_ranks(N)}; device ms by kernel "
        + ", ".join(f"{k} {v:.4f}" for k, v in
                    sorted(stages.items(), key=lambda kv: -kv[1])))
    return row


# -- the LM mesh paths: one NCCL rank, then two gloo ranks -------------------


def _mesh_config(cfg, layers):
    return dataclasses.replace(cfg, n_layers=layers)


def _mesh_rel(got, exp):
    """Relative L2 of ``got`` against ``exp`` (float64 sums)."""
    return float((got.double() - exp.double()).norm()
                 / exp.double().norm())


def _mesh_within(got, exp):
    """The share of positions whose logits lie within MESH_LOGIT_REL
    relative L2 of ``exp``'s (a route of the mixture of experts that flips
    on a near-tie moves a few positions further)."""
    d = (got.double() - exp.double()).norm(dim=-1)
    return float((d <= MESH_LOGIT_REL * exp.double().norm(dim=-1))
                 .double().mean())


def _nccl_zamba(dev, card, sh, total):
    """zamba2-1.2b at full width and depth: forward(sh=) of the LM_B x LM_S
    prefill, decode_step(sh=) and DecodeEngine(sh=), each against the
    mesh-free run on the same inputs: the same bits."""
    import torch

    from repro_torch.nn import transformer as T
    from repro_torch.serve.engine import DecodeEngine, Request
    from repro_torch.sharding import mesh_specs, shard_params

    cfg = _lm_config()
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    loc = shard_params(params, mesh_specs(params, sh, "serve"), sh.mesh)
    toks = torch.randint(0, cfg.vocab, (LM_B, LM_S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        ref = T.forward(params, toks, cfg).logits
        got, secs, launches = _counted(
            lambda: T.forward(loc, toks, cfg, sh).logits)
        same = torch.equal(got, ref)
        del got, ref
        _add(total, launches, "mesh zamba2 prefill", "cuda")
        if launches["ssd_scan"] != cfg.n_layers or launches[
                "flash_attention"] != cfg.n_layers // cfg.hybrid_attn_every:
            raise AssertionError(f"mesh zamba2 prefill launched {launches}")
        st = [T.init_decode_state(p, cfg, LM_B, MESH_DECODE_CAP, sh=s)
              for p, s in ((params, T.NO_SHARD), (loc, sh))]
        steps_same = True
        for t in range(MESH_DECODE_STEPS):
            outs = []
            for i, (p, s) in enumerate(((params, T.NO_SHARD), (loc, sh))):
                lg, st[i] = T.decode_step(p, st[i], toks[:, t:t + 1], cfg,
                                          sh=s)
                outs.append(lg)
            steps_same &= torch.equal(*outs)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 6).tolist()
               for _ in range(SERVE_REQUESTS)]
    served = []
    for p, s in ((params, T.NO_SHARD), (loc, sh)):
        eng = DecodeEngine(p, cfg, batch=SERVE_SLOTS,
                           capacity=MESH_DECODE_CAP, sh=s)
        reqs = [Request(rid=i, prompt=list(pr), max_new=MESH_DECODE_STEPS)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        _, esecs, elaunch = _counted(eng.run)
        served.append([r.out for r in reqs])
    log(f"[{card}] mesh 1 x 1 (NCCL) zamba2 {cfg.n_layers} layers: prefill "
        f"{LM_B} x {LM_S} forward(sh=) {secs:.2f} s, launches {launches}, "
        f"logits {'the same bits' if same else 'DIFFER'}; "
        f"{MESH_DECODE_STEPS} decode_step(sh=) past a ring of "
        f"{MESH_DECODE_CAP} slots: {'the same bits' if steps_same else 'DIFFER'}; "
        f"DecodeEngine(sh=) {SERVE_REQUESTS} requests x {MESH_DECODE_STEPS} "
        f"tokens in {esecs:.2f} s: "
        f"{'the same tokens' if served[0] == served[1] else 'DIFFER'}")
    if not (same and steps_same and served[0] == served[1]):
        raise AssertionError("mesh zamba2 on one NCCL rank: not the "
                             "mesh-free bits")
    del params, loc, st
    torch.cuda.empty_cache()


def _nccl_mixtral(dev, card, sh, total):
    """mixtral-8x7b, MOE_LAYERS layers at full width: forward(sh=) with
    expert parallelism against the mesh-free forward (built one after the
    other, the same draws)."""
    import torch

    from repro_torch.nn import transformer as T
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import init_sharded

    cfg = _moe_config()
    toks = torch.randint(0, cfg.vocab, (MOE_B, MOE_S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg)
        ref = T.forward(params, toks, cfg).logits
        del params
        torch.cuda.empty_cache()
        loc = init_sharded(torch.Generator(device=dev).manual_seed(0), cfg,
                           sh, "serve")
        C.reset_collectives()
        got, secs, launches = _counted(
            lambda: T.forward(loc, toks, cfg, sh).logits)
        coll = C.collectives()
        _add(total, launches, "mesh mixtral prefill", "cuda")
        same = torch.equal(got, ref)
        agree = _agreement(got, ref)
        del got, ref, loc
    torch.cuda.empty_cache()
    log(f"[{card}] mesh 1 x 1 (NCCL) mixtral {cfg.n_layers} layers, expert "
        f"parallel: prefill {MOE_B} x {MOE_S} {secs:.2f} s, launches "
        f"{launches}, collectives {coll}; logits "
        f"{'the same bits' if same else 'differ'} (argmax agreement "
        f"{agree:.5f}; the combine rounds y to bf16 before its sum over "
        f"model, phase 16's bar >= {LM_ARGMAX_MIN} where the bits differ)")
    if launches["flash_attention"] != cfg.n_layers \
            or coll["all_reduce"]["calls"] != cfg.n_layers:
        raise AssertionError(f"mesh mixtral: {launches}, {coll}")
    if not same and agree < LM_ARGMAX_MIN:
        raise AssertionError(f"mesh mixtral argmax agreement {agree}")


def _nccl_granite(dev, card, sh, total):
    """granite-3-2b at full width and depth: one AdamW step and one VB step
    through train_step(sh=) / vb_train_step(sh=) from init_sharded, against
    the mesh-free steps from init_model (one after the other, the updated
    weights held on the host): the loss and every weight the same bits."""
    import torch

    from repro_torch.data.tokens import TokenStream, markov_sequence_fast
    from repro_torch.nn import transformer as T
    from repro_torch.sharding import init_sharded
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as TS

    cfg = _train_config()
    batch = next(TokenStream(markov_sequence_fast(TRAIN_CORPUS, cfg.vocab,
                                                  seed=0), TRAIN_B, TRAIN_S,
                             device=dev).batches(1))
    lr_fn = opt.cosine_schedule(TRAIN_LR, 1, 100)

    def fresh(mesh):
        g = torch.Generator(device=dev).manual_seed(0)
        return init_sharded(g, cfg, sh, "train", trainable=True) if mesh \
            else T.init_model(g, cfg, trainable=True)

    def adamw(mesh):
        s, m = TS.train_step(TS.init_train_state(fresh(mesh)), batch, cfg,
                             sh if mesh else T.NO_SHARD, lr_fn=lr_fn)
        return s, m

    def vb(mesh):
        s, m = TS.vb_train_step(TS.init_vb_state(fresh(mesh)), batch, cfg,
                                sh if mesh else T.NO_SHARD,
                                n_total=float(TRAIN_CORPUS), lr=VB_LR)
        return s, m

    for name, run in (("AdamW", adamw), ("VB", vb)):
        s, m = run(False)
        host = {k: p.detach().cpu() for k, p in s.params.named_parameters()}
        loss = m["loss"].cpu()
        del s, m
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (s, m), secs, launches = _counted(lambda: run(True))
        peak = _peak_gb()
        _add(total, launches, f"mesh granite {name}", "cuda")
        same = torch.equal(m["loss"].cpu(), loss) and all(
            torch.equal(p.detach().cpu(), host[k])
            for k, p in s.params.named_parameters())
        log(f"[{card}] mesh 1 x 1 (NCCL) granite {name} step (sh=, "
            f"{TRAIN_B} x {TRAIN_S}, full width and depth): loss "
            f"{float(loss):.6f}, {secs:.2f} s with the init, launches "
            f"{launches}, peak {peak:.2f} GB; the loss and every updated "
            f"weight {'the same bits' if same else 'DIFFER'}")
        del s, m, host
        torch.cuda.empty_cache()
        if not same or launches["flash_attention_backward"] != cfg.n_layers:
            raise AssertionError(f"mesh granite {name}: not the mesh-free "
                                 f"bits, or launches {launches}")


def _mesh_rank(rank, world, store, out, dev_type):
    """One of the two gloo ranks sharing the card: the runs of
    :func:`_mesh_two_ranks`, saved to ``out``."""
    import datetime

    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data.tokens import TokenStream, markov_sequence_fast
    from repro_torch.kernels import flash_attn, ssd_scan
    from repro_torch.nn import ssm as S
    from repro_torch.nn import transformer as T
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import gather_tensor, init_sharded
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev_type, 0 if dev_type == "cuda" else None)
    if dev_type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=MESH_RANK_TIMEOUT_S))
    res = {}
    try:
        names = ("data", "model")
        meshes = {"1x2": init_device_mesh(dev_type, (1, 2),
                                          mesh_dim_names=names),
                  "2x1": init_device_mesh(dev_type, (2, 1),
                                          mesh_dim_names=names)}
        sh = T.Shardings(mesh=meshes["1x2"])

        def gen():
            return torch.Generator(device=dev).manual_seed(0)

        def counted(fn):
            torch.cuda.synchronize()
            _reset_all_launches()
            C.reset_collectives()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0, _all_launches(), \
                C.collectives()

        # zamba2, model = 2: prefill, then decode past a ring wrap
        cfg = _mesh_config(_lm_config(), MESH_ZAMBA_LAYERS)
        toks = torch.randint(0, cfg.vocab, (LM_B, MESH_S), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(1))
        loc = init_sharded(gen(), cfg, sh, "serve")
        with torch.no_grad():
            lg, secs, launches, coll = counted(lambda: T.gather_logits(
                loc, T.forward(loc, toks, cfg, sh).logits, cfg, sh, LM_B))
            st = T.init_decode_state(loc, cfg, LM_B, MESH_DECODE_CAP, sh=sh)
            steps = []
            for t in range(MESH_DECODE_STEPS):
                d, st = T.decode_step(loc, st, toks[:, t:t + 1], cfg, sh=sh)
                steps.append(d[:, 0].cpu())
            # the kernels at this rank's shapes against their plain versions
            g = torch.Generator(device=dev).manual_seed(3)
            H = loc["blocks"][0]["mamba"]["w_x"].shape[1] // cfg.ssm.head_dim
            x = torch.randn((LM_B, MESH_S, H, cfg.ssm.head_dim), device=dev,
                            generator=g)
            dt = torch.rand((LM_B, MESH_S, H), device=dev, generator=g) * 0.1
            A = torch.rand(H, device=dev, generator=g) + 0.5
            B_, C_ = (torch.randn((LM_B, MESH_S, 1, cfg.ssm.state_dim),
                                  device=dev, generator=g) for _ in range(2))
            ssd = _ssd_ratio(ssd_scan.ssd_scan(x, dt, A, B_, C_,
                                               cfg.ssm.chunk),
                             S.ssd_chunked(x, dt, A, B_, C_, cfg.ssm.chunk))
            Hq = loc["shared_attn"]["attn"]["wq"].shape[1]
            q, k, v = (torch.randn((LM_B, MESH_S, Hq, cfg.head_dim_),
                                   device=dev, generator=g
                                   ).to(torch.bfloat16) for _ in range(3))
            attn = _tol_ratio(flash_attn.flash_attention(
                q, k, v, causal=True, window=cfg.sliding_window),
                _attn_plain(q, k, v, cfg.sliding_window))[0]
        res["zamba2"] = dict(logits=lg.cpu(), decode=torch.stack(steps, 1),
                             seconds=secs, launches=launches,
                             collectives=coll, ssd_ratio=ssd,
                             attn_ratio=attn, heads=(H, Hq),
                             ring=tuple(st.shared_kv[0].k.shape))
        del loc, st, lg
        # mixtral, model = 2 (experts split)
        cfg = _mesh_config(_moe_config(), MESH_MOE_LAYERS)
        loc = init_sharded(gen(), cfg, sh, "serve")
        with torch.no_grad():
            lg, secs, launches, coll = counted(lambda: T.gather_logits(
                loc, T.forward(loc, toks, cfg, sh).logits, cfg, sh, LM_B))
        res["mixtral"] = dict(logits=lg.cpu(), seconds=secs,
                              launches=launches, collectives=coll,
                              experts=tuple(loc["blocks"][0]["moe"]["w_gate"]
                                            .shape))
        del loc, lg
        # granite, model = 2 and data = 2: gradients and one AdamW step
        cfg = _mesh_config(_train_config(), MESH_TRAIN_LAYERS)
        batch = next(TokenStream(markov_sequence_fast(
            TRAIN_CORPUS, cfg.vocab, seed=0), LM_B, MESH_S,
            device=dev).batches(1))
        for name in ("1x2", "2x1"):
            shx = T.Shardings(mesh=meshes[name])
            loc = init_sharded(gen(), cfg, shx, "train", trainable=True)
            named = dict(loc.named_parameters())
            (_, (loss, _)), grads = TS.grads_of(loc, batch, cfg, sh=shx)
            full = {k: gather_tensor(g_, named[k].shard_spec,
                                     shx.mesh).cpu()
                    for k, g_ in grads.items()}
            del grads
            (s, m), secs, launches, coll = counted(lambda: TS.train_step(
                TS.init_train_state(loc), batch, cfg, shx,
                lr_fn=opt.cosine_schedule(TRAIN_LR, 1, 100)))
            replicated = {k: p.detach().cpu()
                          for k, p in s.params.named_parameters()
                          if not C.split_axes(p.shard_spec, shx.mesh)}
            res[f"granite/{name}"] = dict(
                grads=full if rank == 0 else None, loss=float(loss),
                step_loss=float(m["loss"]), seconds=secs, launches=launches,
                collectives=coll, replicated=replicated)
            del loc, s, m, named
        res["backend"] = dist.get_backend()
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _mesh_two_ranks(dev, card, total):
    """Two spawned gloo ranks sharing the card (NCCL takes one device a
    rank; their time is not a speed figure), at full width and reduced
    depth: zamba2 at model = 2 (prefill, then MESH_DECODE_STEPS decode
    steps past a ring of MESH_DECODE_CAP slots), mixtral at model = 2
    (experts split), granite at model = 2 and at data = 2 (one AdamW step,
    its gradients gathered); each against the one-rank mesh-free run on
    the same global inputs: argmax >= LM_ARGMAX_MIN (phase 16's bar) and
    >= MESH_WITHIN_MIN of the positions' logits within MESH_LOGIT_REL
    relative L2; each gradient within GRAD_ROUTE_REL, the loss
    within MESH_LOSS_RTOL; the ranks the same bits where the specs
    replicate.  Returns the granite AdamW step's collectives by mesh
    (rank 0's)."""
    import torch

    from repro_torch.data.tokens import TokenStream, markov_sequence_fast
    from repro_torch.nn import transformer as T
    from repro_torch.train import step as TS

    world = 2
    res, wall = _spawn_ranks(_mesh_rank, world, "mesh two ranks", dev.type)
    a, b = res
    for r in res:
        for k, v in r.items():
            if isinstance(v, dict) and "launches" in v:
                _add(total, v["launches"], f"mesh two ranks {k}", "cuda")
    fails = []

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    toks = torch.randint(0, _lm_config().vocab, (LM_B, MESH_S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    for key, cfg in (("zamba2", _mesh_config(_lm_config(),
                                             MESH_ZAMBA_LAYERS)),
                     ("mixtral", _mesh_config(_moe_config(),
                                              MESH_MOE_LAYERS))):
        params = T.init_model(gen(), cfg)
        with torch.no_grad():
            ref = T.forward(params, toks, cfg).logits.cpu()
            dec = None
            if key == "zamba2":
                st = T.init_decode_state(params, cfg, LM_B, MESH_DECODE_CAP)
                steps = []
                for t in range(MESH_DECODE_STEPS):
                    lg, st = T.decode_step(params, st, toks[:, t:t + 1], cfg)
                    steps.append(lg[:, 0].cpu())
                dec = torch.stack(steps, 1)
        del params
        torch.cuda.empty_cache()
        same = torch.equal(a[key]["logits"], b[key]["logits"])
        rel = _mesh_rel(a[key]["logits"], ref)
        within = _mesh_within(a[key]["logits"], ref)
        agree = _agreement(a[key]["logits"], ref)
        msg = (f"[{card}] mesh two gloo ranks (1 x 2) {key} {cfg.n_layers} "
               f"layers, prefill {LM_B} x {MESH_S}: ranks "
               f"{'the same bits' if same else 'DIFFER'}; vs one rank: "
               f"logits relative L2 {rel:.3e}, positions within "
               f"{MESH_LOGIT_REL:.3e} {within:.5f} (>= {MESH_WITHIN_MIN}), "
               f"argmax {agree:.5f} (>= {LM_ARGMAX_MIN}); "
               f"{a[key]['seconds']:.2f} s, launches {a[key]['launches']}, "
               f"collectives {a[key]['collectives']}")
        ok = same and agree >= LM_ARGMAX_MIN and within >= MESH_WITHIN_MIN
        if key == "zamba2":
            drel = max(_mesh_rel(a[key]["decode"][:, t], dec[:, t])
                       for t in range(MESH_DECODE_STEPS))
            dwithin = _mesh_within(a[key]["decode"], dec)
            dagree = _agreement(a[key]["decode"], dec)
            ok &= (torch.equal(a[key]["decode"], b[key]["decode"])
                   and dwithin >= MESH_WITHIN_MIN
                   and dagree >= LM_ARGMAX_MIN
                   and a[key]["ssd_ratio"] <= 1 and b[key]["ssd_ratio"] <= 1
                   and a[key]["attn_ratio"] <= 1
                   and a[key]["ring"][1] == MESH_DECODE_CAP // world)
            msg += (f"; {MESH_DECODE_STEPS} decode steps past a ring of "
                    f"{MESH_DECODE_CAP} slots ({a[key]['ring'][1]} a rank): "
                    f"worst step relative L2 {drel:.3e}, positions within "
                    f"{dwithin:.5f}, argmax {dagree:.5f}"
                    f"; at the rank's heads {a[key]['heads']} ssd_scan "
                    f"{a[key]['ssd_ratio']:.3f} / {b[key]['ssd_ratio']:.3f} "
                    f"of SSD_RTOL, flash_attention {a[key]['attn_ratio']:.3f}"
                    f" of its bf16 bar")
        else:
            msg += f"; expert block a rank {a[key]['experts']}"
        log(msg + f"; card {card}")
        if not ok:
            fails.append(key)
    cfg = _mesh_config(_train_config(), MESH_TRAIN_LAYERS)
    batch = next(TokenStream(markov_sequence_fast(
        TRAIN_CORPUS, cfg.vocab, seed=0), LM_B, MESH_S,
        device=dev).batches(1))
    params = T.init_model(gen(), cfg, trainable=True)
    (_, (loss, _)), grads = TS.grads_of(params, batch, cfg)
    grads = {k: g.cpu() for k, g in grads.items()}
    loss = float(loss)
    del params
    torch.cuda.empty_cache()
    for name in ("1x2", "2x1"):
        ra, rb = a[f"granite/{name}"], b[f"granite/{name}"]
        worst = max((_mesh_rel(ra["grads"][k], g), k)
                    for k, g in grads.items())
        lrel = abs(ra["loss"] - loss) / abs(loss)
        same = ra["step_loss"] == rb["step_loss"] and all(
            torch.equal(v, rb["replicated"][k])
            for k, v in ra["replicated"].items())
        log(f"[{card}] mesh two gloo ranks ({name}) granite "
            f"{cfg.n_layers} layers, {LM_B} x {MESH_S}: loss {ra['loss']:.6f}"
            f" vs one rank {loss:.6f} (rel {lrel:.2e} <= {MESH_LOSS_RTOL}); "
            f"worst gradient relative L2 {worst[0]:.3e} ({worst[1]}; <= "
            f"{GRAD_ROUTE_REL}); AdamW step {ra['seconds']:.2f} s, launches "
            f"{ra['launches']}, collectives {ra['collectives']}; "
            f"{len(ra['replicated'])} replicated weights "
            f"{'the same bits' if same else 'DIFFER'} on the ranks")
        if not (same and worst[0] <= GRAD_ROUTE_REL
                and lrel <= MESH_LOSS_RTOL):
            fails.append(f"granite/{name}")
    log(f"mesh two ranks (NOT a speed figure: two processes sharing one card "
        f"over {a['backend']}, a host-copy collective): {wall:.1f} s with "
        f"the spawn")
    if fails:
        raise AssertionError(f"mesh two ranks failed: {fails}")
    return {name: a[f"granite/{name}"]["collectives"]
            for name in ("1x2", "2x1")}


def _seq_shard_rank(rank, world, store, out, dev_type):
    """One of the MESH_SEQ_RANKS gloo ranks of :func:`_mesh_seq_shard`:
    gemma-2b's prefill and one AdamW step on the 1 x world mesh with
    attn_seq_shard, then this rank's offset launches against the plain
    versions; saved to ``out`` (rank 0 also its gradients, on the host)."""
    import datetime

    # three processes share the card: release freed blocks to the others
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data.tokens import TokenStream, markov_sequence_fast
    from repro_torch.kernels import flash_attn
    from repro_torch.nn import transformer as T
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import init_sharded
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev_type, 0 if dev_type == "cuda" else None)
    if dev_type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=MESH_RANK_TIMEOUT_S))
    try:
        sh = T.Shardings(mesh=init_device_mesh(
            dev_type, (1, world), mesh_dim_names=("data", "model")),
            attn_seq_shard=True)
        cfg = _mesh_config(_gemma_config(), MESH_SEQ_LAYERS)
        batch = next(TokenStream(markov_sequence_fast(
            TRAIN_CORPUS, cfg.vocab, seed=0), MESH_SEQ_B, MESH_SEQ_S,
            device=dev).batches(1))

        def gen():
            return torch.Generator(device=dev).manual_seed(0)

        def counted(fn):
            torch.cuda.synchronize()
            _reset_all_launches()
            C.reset_collectives()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return r, time.perf_counter() - t0, _all_launches(), \
                C.collectives()

        res = {}
        loc = init_sharded(gen(), cfg, sh, "serve")
        with torch.no_grad():
            lg, secs, launches, coll = counted(lambda: T.gather_logits(
                loc, T.forward(loc, batch.tokens, cfg, sh).logits, cfg, sh,
                MESH_SEQ_B))
        res["prefill"] = dict(argmax=lg.argmax(-1).cpu(), seconds=secs,
                              launches=launches, collectives=coll,
                              wq=tuple(loc["blocks"][0]["attn"]["wq"].shape))
        del loc, lg
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        loc = init_sharded(gen(), cfg, sh, "train", trainable=True)
        (_, (loss, _)), grads = TS.grads_of(loc, batch, cfg, sh=sh)
        host = {k: g.cpu() for k, g in grads.items()} if rank == 0 else None
        del grads
        (s, m), secs, launches, coll = counted(lambda: TS.train_step(
            TS.init_train_state(loc), batch, cfg, sh,
            lr_fn=opt.cosine_schedule(TRAIN_LR, 1, 100)))
        res["train"] = dict(grads=host, loss=float(loss),
                            step_loss=float(m["loss"]), seconds=secs,
                            launches=launches, collectives=coll,
                            peak_gb=_peak_gb())
        del loc, s, m
        torch.cuda.empty_cache()
        # this rank's block against the whole K and V, at its offset
        n = MESH_SEQ_S // world
        off = rank * n
        g = torch.Generator(device=dev).manual_seed(10 + rank)
        bf = torch.bfloat16
        q, dout = (torch.randn((MESH_SEQ_B, n, cfg.n_heads, cfg.head_dim_),
                               generator=g, device=dev).to(bf)
                   for _ in range(2))
        k, v = (torch.randn((MESH_SEQ_B, MESH_SEQ_S, cfg.n_kv_heads,
                             cfg.head_dim_), generator=g, device=dev).to(bf)
                for _ in range(2))
        exp = _attn_plain(q, k, v, None, True, off)
        fwd = _tol_ratio(flash_attn.flash_attention(q, k, v, q_offset=off),
                         exp)[0]
        wrong = _tol_ratio(flash_attn.flash_attention(q, k, v), exp)[0] \
            if off else None
        out_, lse = flash_attn._forward(q, k, v, True, None, None, True, off)
        bwd = _bwd_ratio(flash_attn.flash_attention_backward(
            q, k, v, out_, lse, dout, q_offset=off),
            _bwd_plain(q, k, v, out_, lse, dout, True, None, off))
        res["kernels"] = dict(offset=off, fwd=fwd, wrong=wrong, bwd=bwd)
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _spawn_ranks(target, world, label, dev_type):
    """``world`` spawned processes running ``target(rank, world, store,
    out, dev_type)`` within MESH_RANK_TIMEOUT_S; their saved results and
    the wall time."""
    import multiprocessing
    import tempfile

    import torch

    ctx = multiprocessing.get_context("spawn")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        outs = [os.path.join(d, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=target, args=(
            r, world, os.path.join(d, "store"), outs[r], dev_type))
            for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + MESH_RANK_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.1))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        wall = time.perf_counter() - t0
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"{label}: exit codes "
                                 f"{[p.exitcode for p in procs]}")
        return [torch.load(o, weights_only=False) for o in outs], wall


def _attn_offset_zero(q, k, v, window, causal=True):
    """Known-wrong for a block at an offset: the kernel at offset 0."""
    from repro_torch.kernels import flash_attn

    return flash_attn.flash_attention(q, k, v, causal=causal, window=window)


def _mesh_seq_shard(dev, card, total):
    """Phase 19 (c): attention split over the sequence.  MESH_SEQ_RANKS
    gloo ranks share the card at model = 3 (gemma-2b's 8 q heads do not
    divide, so wq and wo stay whole and each rank runs its block of the
    sequence at q_offset = rank S / 3): a prefill and one AdamW step of
    gemma-2b at full width, MESH_SEQ_LAYERS layers, MESH_SEQ_B x
    MESH_SEQ_S, against the one-rank mesh-free run on the same draws:
    argmax >= LM_ARGMAX_MIN, each gradient within GRAD_ROUTE_REL relative
    L2, the loss within MESH_LOSS_RTOL; each rank's offset launches against
    the plain versions at the bf16 bars (forward :func:`_tol_ratio`,
    backward BWD_BF16_REL), the kernel at offset 0 failing the forward's.
    Then the offset route's kernel rows at the last rank's block.  Returns
    the rows."""
    import torch

    from repro_torch.data.tokens import TokenStream, markov_sequence_fast
    from repro_torch.nn import transformer as T
    from repro_torch.train import step as TS

    import gc

    world = MESH_SEQ_RANKS
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0] / 2**30 if dev.type == "cuda" \
        else 0.0
    res, wall = _spawn_ranks(_seq_shard_rank, world, "mesh seq-shard ranks",
                             dev.type)
    fwd_launches = bwd_launches = 0
    for r in res:
        for part in ("prefill", "train"):
            _add(total, r[part]["launches"], f"mesh seq-shard {part}", "cuda")
            fwd_launches += r[part]["launches"]["flash_attention"]
            bwd_launches += r[part]["launches"]["flash_attention_backward"]
    cfg = _mesh_config(_gemma_config(), MESH_SEQ_LAYERS)
    batch = next(TokenStream(markov_sequence_fast(
        TRAIN_CORPUS, cfg.vocab, seed=0), MESH_SEQ_B, MESH_SEQ_S,
        device=dev).batches(1))
    g0 = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        params = T.init_model(g0, cfg)
        ref_argmax = T.forward(params, batch.tokens, cfg).logits.argmax(-1)
    del params
    torch.cuda.empty_cache()
    params = T.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                          trainable=True)
    (_, (loss, _)), grads = TS.grads_of(params, batch, cfg)
    loss = float(loss)
    a = res[0]
    worst = max((_mesh_rel(a["train"]["grads"][k], g.cpu()), k)
                for k, g in grads.items())
    del params, grads
    torch.cuda.empty_cache()
    agree = float((a["prefill"]["argmax"] == ref_argmax.cpu()).double()
                  .mean())
    lrel = abs(a["train"]["loss"] - loss) / abs(loss)
    same = all(torch.equal(r["prefill"]["argmax"], a["prefill"]["argmax"])
               and r["train"]["step_loss"] == a["train"]["step_loss"]
               for r in res)
    kern = [r["kernels"] for r in res]
    ok = (same and agree >= LM_ARGMAX_MIN and worst[0] <= GRAD_ROUTE_REL
          and lrel <= MESH_LOSS_RTOL
          and all(x["fwd"] <= 1 and x["bwd"] <= 1 for x in kern)
          and all(x["wrong"] > 1 for x in kern if x["offset"]))
    log(f"[{card}] mesh seq-shard ({world} gloo ranks, 1 x {world}, "
        f"attn_seq_shard) gemma-2b {cfg.n_layers} layers at full width, "
        f"{MESH_SEQ_B} x {MESH_SEQ_S} ({MESH_SEQ_S // world} positions a "
        f"rank), wq a rank {a['prefill']['wq']}: ranks "
        f"{'the same argmax and loss' if same else 'DIFFER'}; prefill "
        f"{a['prefill']['seconds']:.2f} s, launches "
        f"{a['prefill']['launches']}, collectives "
        f"{a['prefill']['collectives']}, argmax vs one rank {agree:.5f} "
        f"(>= {LM_ARGMAX_MIN}); AdamW step {a['train']['seconds']:.2f} s, "
        f"launches {a['train']['launches']}, collectives "
        f"{a['train']['collectives']}, loss {a['train']['loss']:.6f} vs one "
        f"rank {loss:.6f} (rel {lrel:.2e} <= {MESH_LOSS_RTOL}), worst "
        f"gradient relative L2 {worst[0]:.3e} ({worst[1]}; <= "
        f"{GRAD_ROUTE_REL}), peak a rank "
        f"{max(r['train']['peak_gb'] for r in res):.2f} GB; the ranks' "
        f"offset launches against the plain versions: "
        + "; ".join(f"q_offset {x['offset']}: forward {x['fwd']:.3f}, "
                    f"backward {x['bwd']:.3f} of the bf16 bars"
                    + (f", offset 0 {x['wrong']:.1f}" if x["offset"] else "")
                    for x in kern)
        + f"; {wall:.1f} s with the spawn (NOT a speed figure: three "
        f"processes sharing one card; {free:.2f} GB free at the spawn)")
    if not ok:
        raise AssertionError("mesh seq-shard route failed its bars")
    n = MESH_SEQ_S // world
    g = torch.Generator(device=dev).manual_seed(12)
    few = dict(iters=3, warmup=1)
    qs = (MESH_SEQ_B, n, cfg.n_heads, cfg.head_dim_)
    ks = (MESH_SEQ_B, MESH_SEQ_S, cfg.n_kv_heads, cfg.head_dim_)
    off = (world - 1) * n
    fwd = _attn_case(dev, g, qs, ks, "bfloat16", None, True,
                     _attn_offset_zero, True, few, q_offset=off)
    bwd = _bwd_case(dev, g, qs, ks, True, None, few, q_offset=off)
    fwd.update(name="flash_attention/seq_shard", launches=fwd_launches)
    bwd.update(name="flash_attention_bwd/seq_shard", launches=bwd_launches)
    return {r["name"]: r for r in (fwd, bwd)}


def dryrun_phase(dev, card, real):
    """Phase 20: the LM dry run.  ``python -m repro_torch.launch.dryrun
    --arch granite-3-2b --shape train_4k --mesh single`` (a fake 256-rank
    world, fake CUDA tensors, ranks 0 and 255) in a subprocess, its record
    checked and logged; then the dry run of phase 19 (b)'s granite AdamW
    step on each of its meshes, rank 0, whose collectives must equal the
    real run's (``real``: {mesh: collectives})."""
    import tempfile

    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.sharding import collectives as C

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               TRAIN_ARCH, "--shape", "train_4k", "--mesh", "single",
               "--out", d]
        env = dict(os.environ, PYTHONPATH=SRC)
        p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=DRYRUN_TIMEOUT_S)
        path = os.path.join(d, f"{TRAIN_ARCH}__train_4k__16x16.json")
        rec = json.load(open(path)) if os.path.exists(path) else {}
    secs = time.perf_counter() - t0
    last = rec.get("last_rank", {})
    ok = (p.returncode == 0 and "error" not in rec
          and rec.get("device") == f"{dev} (fake)"
          and rec.get("collectives") == last.get("collectives")
          and rec.get("memory") == last.get("memory"))
    if not ok:
        raise AssertionError(f"dry run: rc {p.returncode}, record {rec}\n"
                             f"{p.stderr[-3000:]}")
    log(f"dry run {' '.join(cmd[2:-2])}: {secs:.1f} s with the start "
        f"(rank 0's step {rec['run_s']:.1f} s, rank 255's "
        f"{last['run_s']:.1f} s; {rec['device']}): flops "
        f"{rec['flops']['total']:.4g} a rank (kernels "
        f"{rec['flops']['kernels']}), argument "
        f"{rec['memory']['argument_bytes'] / 1e9:.3f} GB, peak "
        f"{rec['memory']['peak_bytes'] / 1e9:.3f} GB a rank, collectives "
        f"{rec['collectives']}; ranks 0 and 255 the same memory and "
        f"collectives")
    cfg = _mesh_config(_train_config(), MESH_TRAIN_LAYERS)
    shape = InputShape("train_4k", MESH_S, LM_B, "train")
    for name, dims in (("1x2", (1, 2)), ("2x1", (2, 1))):
        fake = dryrun.run_rank(cfg, shape, dims, 0, dev)
        got = {k: fake["collectives"][k] for k in C.KINDS}
        log(f"dry run of phase 19 (b)'s granite AdamW step ({name}, rank 0, "
            f"{fake['run_s']:.2f} s): collectives {got}, the real run's "
            f"{real[name]}: {'equal' if got == real[name] else 'DIFFER'}")
        if got != real[name]:
            raise AssertionError(f"dry run {name}: collectives {got} != the "
                                 f"real run's {real[name]}")
    log(f"dry run phase: {time.perf_counter() - t0:.1f} s")


def mesh_phase(dev, card):
    """Phase 19: the LM mesh paths.  (a) One NCCL rank over a FileStore and
    its ("data", "model") 1 x 1 mesh: zamba2 prefill and decode, mixtral
    with expert parallelism, granite's AdamW and VB steps, each through its
    entry point against the mesh-free run (the same bits); (b) two gloo
    ranks sharing the card (:func:`_mesh_two_ranks`); (c) three gloo ranks
    on the seq-shard route (:func:`_mesh_seq_shard`).  Returns the kernel
    launches of its mesh runs, the seq-shard route's kernel rows and (b)'s
    granite collectives by mesh."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.nn import transformer as T

    t_phase = time.perf_counter()
    total = {}
    torch.cuda.set_device(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{d}/store", world_size=1,
                                rank=0,
                                timeout=datetime.timedelta(seconds=300))
        try:
            sh = T.Shardings(mesh=init_device_mesh(
                dev.type, (1, 1), mesh_dim_names=("data", "model")))
            _nccl_zamba(dev, card, sh, total)
            _nccl_mixtral(dev, card, sh, total)
            _nccl_granite(dev, card, sh, total)
        finally:
            dist.destroy_process_group()
    t_one = time.perf_counter() - t_phase
    real = _mesh_two_ranks(dev, card, total)
    t_two = time.perf_counter() - t_phase
    rows = _mesh_seq_shard(dev, card, total)
    log(f"mesh phase: {time.perf_counter() - t_phase:.1f} s (one NCCL rank "
        f"{t_one:.1f} s, two ranks {t_two - t_one:.1f} s, seq-shard "
        f"{time.perf_counter() - t_phase - t_two:.1f} s); launches {total}")
    return total, rows, real


def _batch(xc, xd):
    from repro_torch.data.stream import Batch

    return Batch(xc, xd, np.ones(xc.shape[0], np.float32))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(card)
    dev = torch.device("cuda:0")

    from repro_torch.kernels import build

    secs, _ = build.build_all()
    log(f"build: {secs:.2f} s")
    rows = kernel_phase(dev)
    total, fitted = main_path_phase(card)
    serve_total, largest, shapes = exact_serving_phase(dev, card, fitted)
    total.update(serve_total)
    rows.update(factor_kernel_phase(dev, largest, shapes))
    struct_total, fc_inputs = structure_phase(dev, card)
    for k, v in struct_total.items():
        total[k] = total.get(k, 0) + v
    rows.update(family_counts_phase(dev, fc_inputs))
    params, cfg, lm_total, lm_largest = lm_prefill_phase(dev)
    decode_check = lm_serving_phase(params, cfg, dev)
    del params
    for k, v in list(lm_total.items()) + list(decode_check.items()):
        total[k] = total.get(k, 0) + v
    rows.update(lm_kernel_phase(dev, lm_largest))
    temporal_total = temporal_phase(dev, card)
    for k, v in temporal_total.items():
        total[k] = total.get(k, 0) + v
    for k, v in approx_phase(dev, card, fitted).items():
        total[k] = total.get(k, 0) + v
    for k, v in dvmp_phase(dev, card, fitted).items():
        total[k] = total.get(k, 0) + v
    for k, v in production_phase(dev, card, fitted).items():
        total[k] = total.get(k, 0) + v
    del fitted
    shapes = {}
    for phase in (moe_phase, audio_phase):
        for k, v in phase(dev, card, shapes).items():
            total[k] = total.get(k, 0) + v
    rows.update(attn_shapes_phase(dev, shapes))
    train_total, train_counts = train_phase(dev, card)
    for k, v in train_total.items():
        total[k] = total.get(k, 0) + v
    rows.update(train_rows_phase(dev, train_counts))
    mesh_total, mesh_rows, mesh_coll = mesh_phase(dev, card)
    for k, v in mesh_total.items():
        total[k] = total.get(k, 0) + v
    rows.update(mesh_rows)
    dryrun_phase(dev, card, mesh_coll)
    # one kernel, three entries: clg_suffstats_chunks is the CLG search's,
    # clg_seq_suffstats the temporal models'
    total["clg_suffstats"] += (total.pop("clg_suffstats_chunks", 0)
                               + total.pop("clg_seq_suffstats", 0))
    for name, row in rows.items():
        if name in total:       # a kernel's row: every launch of the paths
            row["launches"] = total[name]
        if not row["launches"]:
            raise AssertionError(f"{name} was never launched on the main path")
    kernels = {"kernels": list(rows.values())}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
