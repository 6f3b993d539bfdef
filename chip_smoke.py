#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and hold each
hand-written kernel against its plain PyTorch version.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (every one unguarded: any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``);
3. K1 (fused-dequant GEMM), K2 (implicit-GEMM conv), K3 (two-phase PAS
   GEMM) and K4 (implicit-GEMM PAS conv) against their plain versions at the
   five full-width AlexNet conv stages, shared and packed dictionaries, plus
   a ``groups=2`` case (K1/K2), 4- and 256-bin dictionaries and indices past
   the dictionary (K3/K4) on conv3, an NHWC SAME conv1 case and the
   3×512×512 ``bigimg_conv1`` shape on K2/K4; K1 ≡ K2 and K3 ≡ K4 bitwise on
   each stage, K1's and K3's rows independent of M (a slice of whole pool
   windows off the block tiles against the full call, bitwise; conv3–conv5
   run split-K on both), and on integer-valued images and dictionaries
   K3 == K1 bitwise (paper §5.3);
4. the full-width AlexNet (3×224×224, 1000 classes, 16 bins, seeded weights,
   k-means on the card) serving mixed-size requests through ``CnnBatcher``
   with ``impl="kernel"``, ``"kernel_implicit"`` and ``"pas_kernel"``, then
   one batch through the five stages on ``conv2d(engine=
   "pas_kernel_implicit")``; launch counts are read around each run and the
   logits are held against the ``einsum`` engine on the card;
5. CUDA-event timings at batch 32 per stage: kernel, plain version, a
   library yardstick (timed only: ``torch.matmul`` on the dequantized weight
   for K1/K3, ``F.conv2d`` with TF32 off for K2/K4) and the bound
   ``max(flops / 67 TFLOP/s, bytes / 3.35 TB/s)`` of the function
   (``repro_torch.roofline.bound_ms``, every bound of the script; K3's is
   K1's, K4's is K2's); K3/K4 also print their rate in adds/s (flops / 2:
   one add per (m, k, n)), K1/K2 their plan (tile, split-K count, blocks:
   ``pasm_matmul.simt_plan``);
6. K5 (flash attention) against its plain version, f32 (SIMT route) and
   bf16 (tensor-core route), causal and not, at the ``tests/test_kernels.py``
   shapes (GQA, MHA with a ragged S, MQA), stablelm-3b's hd 80 over 32 heads,
   hd 64, 192 and 256 (so bf16 runs at every head dim the kernel is built
   for) and qwen3-32b's prefill shape (64 heads over 8 KV heads, hd 128) at
   S = 512 and 1000, and against the port's ``gqa_attention`` with
   ``chunk < S`` (the online-softmax loop); the f32 route timed at each;
7. LM serving: qwen3-32b at full width (d_model 5120, 64/8 heads, hd 128,
   qk-norm, SwiGLU d_ff 25600, vocab 151936) cut to 4 of its 64 layers,
   seeded weights drawn on the card and quantized there (16 bins, int4
   packed), 8 requests (prompts of 8–384 tokens, 16 new tokens each,
   staggered submits) through ``Engine(batch_slots=4, max_seq=512)`` on
   ``impl="kernel"`` (K1 on every linear: 7 per layer + the head per model
   call, counted) and on ``impl="dequant"``, the oracle; the per-step logits
   of both, teacher-forced on the kernel run's tokens, within
   ``LM_LOGIT_TOL``, and a second kernel run's logits bitwise equal to the
   first's (K1's split-K adds in a fixed order); K1's launches by route
   (``stream`` at decode, ``mma`` at prefill); then K5 through
   ``ops.flash_attention`` on the served
   model's own attention operands (what each layer handed ``gqa_attention``
   at that prefill), counted, and held against ``gqa_attention`` and K5's
   plain version;
8. CUDA-event timings at the LM's shapes: K5 at the qwen3 prefill shape
   (B 1, S 4096, causal) in bf16 and f32 against its plain version, the
   library yardstick ``F.scaled_dot_product_attention`` (timed only) and the
   bound (f32 beside its first design's time); K1 at the decode (M = 4) and prefill (M = 384) rows of ``wq``,
   ``w1``, ``w2`` and ``lm_head`` with bf16 activations against
   ``torch.matmul`` on the dequantized bf16 weight and the bound, warm (as
   before) and with the L2 cache flushed before every call (cold: the
   served model streams every other layer's weights between two uses); then
   a K1 M-sweep on ``w2`` and ``lm_head`` (cold): the routed kernel beside
   the old route (the same call on ``x.float()``, the f32 SIMT kernel) and
   the bf16 ``torch.matmul``, with the route taken at each M.  Every timing
   window (phases 5 and 8) opens behind a spin kernel that lasts longer than
   the host takes to enqueue the timed calls, so the events read device
   time; K1's LM rows also print the host's µs a call; (b) K6 (split-KV
   decode attention, ``kernels/decode_attention.py``) at phi3-medium-14b's
   serving shape (16 slots x 4096 bf16 positions, 10 KV heads, G 4, hd
   128) against its plain version, bitwise on a repeat, then timed warm
   and cold at the closed chat mix's live lengths and with every slot full,
   beside its plain version, ``F.scaled_dot_product_attention`` on the
   masked cache (timed only) and the bound, the live K/V rows read once
   (phase 7 also counts K6's launches: one a layer a decode call).  Every
   phase that decodes (7, 10, 12, and the ranks of 14 and 16) records the
   operands its runs hand K6, both ``impl`` runs alike, and holds K6 to its
   plain version on them (``held_k6``: qwen3's G 8, deepseek's and
   whisper's self and cross G 1, internvl2's G 6, the sharded runs' blocks
   and sequence-sharded partials);
9. training, under ``torch.use_deterministic_algorithms(True)`` (cuBLAS's
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` is set before the first cuBLAS
   call of the run): (a) the K1/K2 autograd Functions' dx, dcodebook and
   dbias against ``torch.autograd`` through the plain chain (dequantize,
   dot, epilogue) through ``conv2d(engine="kernel" | "kernel_implicit")``
   at AlexNet's conv1 (pooled; shared and packed) and conv3 (shared,
   packed, ``groups=2``), and through ``ops.pasm_matmul`` at the LM's
   ``w2`` and ``lm_head`` with bf16 x at M = 1024; (b) qwen3-32b at full
   width (phase 7's 4 quantized layers, ``remat``) trained: one step's
   loss and grads on ``impl="kernel"`` against ``"dequant"`` with exactly
   57 K1 launches, all ``mma`` (29 forward + 28 recomputed), the step
   timed on both with its peak memory, the codebook-gradient pass and
   ``lm_head``'s backward timed, 3 steps of ``run_loop``, and a poisoned
   step bitwise a no-op; (c) the smoke config (layers weight-shared, K1)
   trained 6 steps with checkpoints, then again under ``ft.Supervisor``
   with a crash at step 3: the resumed run's params and optimizer state
   bitwise the uninterrupted run's; (d) the full-width AlexNet QAT-trained
   2 steps at batch 8, frozen with ``qat_requantize`` and served on K1
   and K2 within ``TOL`` of ``qat_forward``; (e) mamba2-130m,
   recurrentgemma-2b and whisper-tiny at full width and full depth, one
   train step each at 8 × 128: loss and grads on ``kernel`` against
   ``dequant`` within ``LM_GRAD_TOL`` or the one-ulp floor measured in the
   run (``kernel`` with the embeddings moved by one bf16 ulp), the step
   timed with its peak memory, K1 launches counted;
10. the MoE family and the vit prefix at full width, depth cut: (a)
    deepseek-moe-16b (d_model 2048, 16/16 heads of hd 128, layer 0 dense
    with SwiGLU d_ff 10944, then 64 routed experts top-6 of d_expert 1408
    and 2 shared experts fused to 2816, vocab 102400) cut to 4 of its 28
    layers, weights drawn and quantized on the card (16 bins, int4 packed,
    each expert's matrices their own dictionaries), served as phase 7
    serves qwen3 on ``kernel`` (K1 once per expert: exactly 605 launches a
    model call, by route) and ``dequant``; the teacher-forced logits in
    batches of 4 (a 4 × 384 prefill has T > 512, so the dropless cap is 180
    rows an expert) bitwise on a second kernel run and within
    ``LM_LOGIT_TOL`` of ``dequant`` on the kernel run's experts with its own
    gates (on its own activations a bf16 near-tie can rank another expert
    first, and the cap then moves other tokens: each expert set that
    differs must be a near-tie, within ``MOE_TIE`` of dequant's k-th
    probability); the (token,
    expert) entries the cap dropped at each prefill; K5 on the served
    prefill's attention operands; a decode step and a 4 × 384 prefill on
    each impl and the engine's own 512-token bucket timed (wall and host
    clocks, device time and K1's share from a ``torch.profiler`` trace),
    and K1 at the expert shapes;
    (b) internvl2-26b (d_model 6144, 48/8 heads, d_ff 16384, vocab 92553,
    a 256 × 3200 vit prefix through ``vproj``) cut to 4 of its 48 layers:
    one prefill of 2 sequences behind 256 seeded patch embeddings each
    (prompts of 64 and 40 tokens, right-padded) and 8 decode steps on
    ``kernel`` and ``dequant``: cache positions 320 / 296, 29 K1 launches a
    model call (``vproj`` dequantizes), logits within ``LM_LOGIT_TOL``, K5
    on the prefill's attention operands;
11. the recurrent families at full width and full depth, 16 bins int4,
    weights drawn and quantized on the card: (a) mamba2-130m (24 SSD
    layers, d_model 768, d_inner 1536, 24 heads of 64, d_state 128, vocab
    50280) and (b) recurrentgemma-2b (26 layers: 8 groups of (R, R, A) and
    a 2-layer recurrent tail, d_model 2560, 10 query heads over one KV
    head of 256, d_ff 7680, vocab 256000, a 2048-slot local-attention
    ring), each serving the qwen3 traffic and a 2-token prompt (the
    hybrid also a 2040-token prompt whose 16 new tokens cross the ring)
    through ``Engine`` at the exact prompt length on ``kernel`` (exactly
    49 / 147 K1 launches a model call, and 36 gate dequantizations for
    the hybrid) and ``dequant``; teacher-forced logits, each prompt alone,
    bitwise on a second kernel run and, against ``dequant``, within the
    oracle's own noise floor measured in the same run (``dequant`` with
    every embedding moved by up to one bf16 ulp: at full depth it exceeds
    ``LM_LOGIT_TOL``); the ring prompt's decode against ``forward`` at the
    same positions (the error after the wrap at most 4× the error before
    it); K5 on the ring prompt's prefill attention operands (G 10, hd
    256); a 4-slot decode step and a 4 × 384 prefill timed on each impl
    (wall, host, device and the largest kernels from a ``torch.profiler``
    trace); K1 at the new shapes warm and cold beside ``torch.matmul``
    and the bound;
12. the encoder-decoder family at full width and full depth: whisper-tiny
    (4 encoder and 4 decoder layers, d_model 384, 6 heads of 64, d_ff
    1536, vocab 51865, 1500 encoder frames from a (B, 80, 3000) log-mel
    stem of two k 1×3 convs, the second at stride 2; 33000 learned decoder
    positions), its linears 16 bins int4 and its stem 16 bins
    (``quantize_frontend``), weights drawn and quantized on the card: (a)
    the qwen3 traffic served through ``Engine`` on ``kernel`` (exactly 66
    K1 launches a prefill call: the stem's 2 on ``simt``, 24 encoder, 40
    decoder; 32 a decode call) and ``dequant``, every request encoded from
    silence as the JAX engine does; teacher-forced logits, each prompt
    alone, bitwise on a second kernel run and within ``LM_LOGIT_TOL`` of
    ``dequant`` (or the oracle's own one-ulp noise floor, measured in the
    run, where that is larger); (b) a seeded random mel (2, 80, 3000)
    through ``prefill`` with right-padded prompts and 8 decode steps, the
    same counts and tolerance; (c) the stem's dictionaries at batch 4 on
    K1-K4 against their plain versions and through ``conv2d`` on the four
    kernel engines against ``einsum`` (K1 ≡ K2, K3 ≡ K4 bitwise); (d) K5
    on (a)'s and (b)'s prefill attention operands with their own causal
    flags (the encoder's non-causal self-attention at S = 1500, the
    decoder's non-causal cross-attention onto 1500 keys, its causal
    self-attention); (e) a 4-slot decode step and a 4 × 384 prefill timed
    on each impl, K1 at the stem (f32, beside ``torch.matmul`` and
    ``F.conv2d``) and at ``wq``/``w1``/``w2``/cross ``wk`` for M = 4 and
    1500, and K5 bf16 at the encoder's shape beside SDPA and the bound;
13. the sharded CNN at full width: the AlexNet of phase 4 through
    ``cnn.quantize(mesh=)`` and ``cnn.forward(mesh=)`` (a ``("data",
    "model")`` mesh of ``launch/mesh.py``): (a) world size 1 on NCCL, mesh
    (1, 1), at batch 32 on ``kernel``, ``kernel_implicit``, ``pas_kernel``,
    ``pas_kernel_implicit`` and ``einsum``, each bitwise the unsharded
    forward, its K1–K4 launches counted, both timed (the phase-5 method);
    (b) two ranks spawned on gloo, both on the one card, meshes (2, 1) and
    (1, 2) at batch 32 and (2, 1) at batch 6 (an uneven remainder): each
    rank's weight bytes (at (1, 2) half of every idx and of the head), the
    five stages through ``conv2d(mesh=)`` on K1–K4 bitwise (a)'s single-device
    stages at (a)'s split-K counts (recorded, printed), the logits bitwise
    (a)'s or within ``TOL``, launches counted, the forward timed; a rank
    that fails or outlives ``SHARD_RANK_TIMEOUT_S`` fails the run;
14. the sharded LM at full width: qwen3-32b and deepseek-moe-16b (4
    layers each, 16 bins int4) through ``prefill``/``decode_step`` under an
    active ``ShardCtx`` (tensor and expert parallelism, params placed by
    ``models/sharding.py::place_params``): a 4 × 384 prefill and 8 decode
    steps (deepseek also a 2 × 2304 prefill, past the MoE regime switch at
    4096 tokens), one device's logits computed with each mesh's dispatch
    groups and its one-ulp floor (the embeddings moved by one bf16 ulp);
    (a) NCCL at world size 1, mesh (1, 1): qwen3's traffic bitwise the
    unsharded calls, 29 K1 a call (``stream`` at decode; ``mma`` at prefill
    but the head's), the dispatch timed in turns; (b)/(c) two gloo ranks
    sharing the card, meshes (1, 2) and (2, 1), the quantized trees handed
    over through ``build/phase14`` (each rank memory-maps them and copies
    out its blocks): each rank's idx and expert bytes, its K1 launches a
    call (every linear once on its block: 29 for qwen3, 317 / 605 for
    deepseek), collective bytes and wall time a call, its logits held to
    one device's within ``max(LM_LOGIT_TOL, the floor)`` (the MoE calls
    replay one device's experts, each place a rank's own top-k differs a
    near-tie within ``MOE_TIE``); a rank that fails or outlives
    ``SHARD_RANK_TIMEOUT_S`` fails the run;
15. sharded training (``train_shard_phase``), under deterministic
    algorithms: (a) NCCL at world size 1, mesh (1, 1): the full-width
    AlexNet's QAT step at batch 32 (``make_cnn_train_step(mesh=)``) and
    qwen3-32b's train step (4 of 64 layers, 8 × 128, remat, K1) under an
    active ``ShardCtx`` bitwise the unsharded steps, 57 K1 launches a step,
    all ``mma``; (b) two gloo ranks sharing the card at (1, 2) and (2, 1),
    one device's loss and grads handed over through ``build/phase15``:
    the AlexNet's loss within ``QAT_LOSS_TOL`` and every gradient leaf
    (gathered) within ``QAT_GRAD_TOL`` of max, its step timed, a NaN
    ``loss_scale`` skipped with the tree bitwise, a crash after step 4 of 6
    resumed from the gathered checkpoints bitwise the uninterrupted run;
    qwen3's loss within ``LM_LOSS_TOL`` and every float leaf's gradient
    (codebooks, norms, the embedding's rows) within ``LM_GRAD_TOL`` of max,
    57 K1 launches a step, every distinct block K1 ran held to the plain
    version (``check_blocks``), the collective bytes of a forward and of a
    step, the step's wall time and peak memory a rank (and the peak of its
    loss and gradients, before the update);
16. tensor parallelism of the recurrent and encoder-decoder families and
    the sequence-sharded KV cache (``rec_shard_phase``), under an active
    ``ShardCtx`` at full width: (a) NCCL at world size 1, mesh (1, 1):
    mamba2-130m, recurrentgemma-2b and whisper-tiny at full depth, a 4 ×
    384 prefill (whisper's with 4 encodes of 1500 frames) and 8 decode
    steps, and the hybrid's 2040-token prompt with 16 steps past its
    2048-slot ring, bitwise the unsharded calls at their K1 launch counts
    (49, 147, 66 / 32 a call); (b) two gloo ranks sharing the card at (1,
    2) and (2, 1) (the ring prompt at (1, 2), its slots split over the
    two ranks), the trees handed over through ``build/phase16``: each
    rank's weight bytes and each split leaf's share, its K1 launches a
    call, every distinct block K1 ran held to the plain version
    (``check_blocks``), collective bytes a prefill and a decode step by
    key, wall ms, the logits within ``max(LM_LOGIT_TOL, the one-ulp
    floor)`` of one device's; (c) phi3-medium-14b at full width, 4 of its
    40 layers, on four gloo ranks at (1, 4): its 10 KV heads do not divide
    4, so k and v are gathered, a rank's attention runs on its block of
    the q heads (``models/common.py::head_block``: 10 of 40, reading KV
    heads 0-2, 2-4, 5-7, 7-9) and the KV cache's positions split over the
    ranks; the same traffic on the bf16 and the int8 KV cache, held the
    same way; every rank of (b) and (c) prints its head block and the
    heads its attention ran on (recurrentgemma at (1, 2): 5 of 10);
17. sharded training of the other families (``family_train_shard_phase``),
    under deterministic algorithms, 16 bins int4 on K1, 8 × 128 a step:
    (a) NCCL at world size 1, mesh (1, 1): deepseek-moe-16b (4 of 28
    layers), internvl2-26b (4 of 48, behind 256 seeded patch embeddings),
    recurrentgemma-2b (8 of 26), mamba2-130m and whisper-tiny (seeded
    3000-frame mels) at full depth, one train step each bitwise the
    unsharded step;
    one device's loss and every float gradient leaf (the MoE's experts
    recorded, for 1 and 2 dispatch groups) and its one-ulp floor (the
    embeddings moved by a bf16 ulp) handed over through ``build/phase17``;
    (b) two gloo ranks sharing the card at (1, 2) and (2, 1): each model's
    loss and gradients (the MoE on one device's experts for its rows)
    within ``max(LM_GRAD_TOL, the floor)`` of one device's by leaf kind,
    K1 launches a step, every distinct block K1 ran held to the plain
    version (``check_blocks``), collective bytes, the step's wall time and
    peak memory (and its loss and gradients' peak, before the update); at
    (2, 1) the step with JAX's ZeRO-1 moments (``init_opt_state(mesh=)``),
    from the same bytes on the card (the first step's result moved to the
    host), bitwise the step with whole ones, its
    moment bytes beside theirs, ``compress_grads(mesh=)`` bitwise the block
    of the compressed gathered gradient, and whisper's ZeRO crash-resume
    bitwise the uninterrupted run; (c) phi3-medium-14b (4 of 40 layers) on
    four gloo ranks at (1, 4), its 10 KV heads cut by ``model``, one step
    held the same way; every rank prints its head block and the heads its
    attention ran on;
18. the tooling (``tooling_phase``): (a) ``examples/torch/quickstart.py``,
    ``paper_conv.py`` (the paper's §4 accelerator on the four kernel
    engines: K1–K4 launch, counted) and ``train_lm.py`` (the ~100M-param
    LM, ``TOOL_TRAIN_STEPS`` steps, then served on K1) and
    ``serve_pasm.py`` (stablelm-3b's smoke config, dense and 256-bin
    weight-shared on K1, 6 LM requests over 3 slots beside 4 staggered CNN
    images) on the card through their own checks; (b) ``launch/dryrun.py`` on phase 7's qwen3-32b (4 of
    64 layers) at mesh (1, 1), its 4 × 384 prefill and a decode step:
    its argument bytes within ``TOOL_ARG_TOL`` of the ``memory_allocated``
    growth as those params, caches and tokens are built on the card (a
    check), its peak live bytes beside ``max_memory_allocated``; (c) the
    roofline terms of both steps beside their wall and device ms on
    ``kernel`` (``time_step``, K1 counted) — printed, not checked;
19. one ``{"kernels": [...]}`` JSON line;
20. last line: ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when CUDA is unavailable or when the
repository's ``src/`` is not beside it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = 1e-4  # kernel vs plain: |Δ| <= TOL + TOL·|plain| (f32 summation order)
# K5 vs plain: f32 sums in another order, |Δ| <= 1e-5·|plain| + 1e-5; the
# bf16 tensor-core route rounds P to bf16 before P·V (the JAX kernel keeps
# it f32), 2**-9·Σ_j p_j·|v_j| at most, and both round the output to bf16:
# |Δ| <= t·(|plain| + Σ_j p_j·|v_j|) + 1e-5, the sum being the plain version
# on |v| (k5_pv_scale)
K5_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# K5 vs gqa_attention: gqa rounds the softmax weights to v's dtype before the
# value product (2**-9 each in bf16), then both round the output:
# |Δ| <= t·(|gqa| + max|v|)
K5_GQA_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# served LM logits, kernel vs dequant: the same products summed in another
# order in f32, then rounded to bf16 after every linear; a one-ulp flip
# moves through 4 layers and the head: |Δ| <= LM_LOGIT_TOL · max|logit|
LM_LOGIT_TOL = 0.025
# the K1 M-sweep (phase 8): decode slots up to the Engine's largest bucket
K1_SWEEP_M = (1, 2, 4, 8, 16, 32, 64, 128, 256, 384, 512)
L2_FLUSH_BYTES = 128 << 20  # over the H100's 50 MB L2
# the LM cell: qwen3-32b at full width, its depth cut to 4 of 64 layers
LM_LAYERS = 4
LM_SLOTS = 4
LM_MAX_SEQ = 512
LM_NEW = 16
LM_PROMPTS = (8, 384, 37, 200, 100, 17, 300, 64)
K5_TIME_S = 4096
# K6's timed shape: phi3-medium-14b served (slots, positions, KV heads, G, hd),
# at the live rows of phi3-serve-closed's mix
K6_SHAPE = (16, 4096, 10, 4, 128)
K6_MIX = Path(__file__).resolve().parent / "portbench" / "traffic" / "chat-closed-16.json"
# K5's f32 route at that shape before its register-blocked redesign (four
# threads a query row, one LDS.128 per four FMAs): phase 8 of this script on
# an H100 80GB HBM3 at 700 W, printed beside the new time
K5_F32_FIRST_MS = 20.4523
LOGIT_TOL = 1e-3  # served logits vs the einsum engine (five layers + head)
TIME_BATCH = 32
KERNELS = ("pasm_matmul", "pasm_conv", "pas_matmul", "pas_conv")
ALL_KERNELS = KERNELS + ("flash_attention",)
# the kernel each served engine launches (five per batch, and no other)
SERVED_KERNEL = {"kernel": "pasm_matmul", "kernel_implicit": "pasm_conv",
                 "pas_kernel": "pas_matmul"}
# phase 9(a): the Functions' dx, dcodebook and dbias against autograd through
# the plain chain, |Δ| <= t·max|plain| per tensor.  f32: the same products
# summed in another order (the chain's codebook gradient is an index
# scatter-add, the Function's a masked sum per bin).  bf16 x: dx = g·Wᵀ is
# rounded to bf16 on both sides, the Function rounding g to bf16 first (the
# JAX VJP's g.astype(x.dtype)), and the chain's codebook gradient comes back
# through its bf16 rounding of the codebook (2**-9 relative each)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# the upstream gradient is zeroed where the two sides may take different
# valid subgradients: within KINK of the ReLU's kink, and in pool windows
# whose two largest inputs lie within KINK of each other
KINK = 1e-3
# phase 9(b): kernel vs dequant loss and grads at full width, |Δ| <= t·max
# per leaf: the same products in another order in f32, rounded to bf16
# after every linear and every backward op, so a one-ulp flip (2**-8)
# moves through 4 layers and the head — PERF.md's LM logit tolerance
LM_GRAD_TOL = LM_LOGIT_TOL
LM_LOSS_TOL = 1e-3  # relative; the loss is a mean over 1024 rows
TRAIN_BATCH, TRAIN_SEQ = 8, 128  # the JAX launcher's defaults: M = 1024
# K1 launches of one qwen3 train step with remat: 7 a layer + the head in
# the forward, 7 a layer again in the backward's recompute
TRAIN_K1 = 7 * LM_LAYERS + 1 + 7 * LM_LAYERS
QAT_BATCH = 8
# phase 10: the MoE family and the vit prefix at full width, depth cut
MOE_LAYERS = 4  # of deepseek-moe-16b's 28: the dense layer 0 and 3 MoE layers
# a kernel-run expert that dequant did not rank in its own top-k lies at most
# this far below dequant's k-th probability, relative (a near-tie)
MOE_TIE = 2.0 ** -5
VLM_LAYERS = 4  # of internvl2-26b's 48
VLM_PROMPTS = (64, 40)  # right-padded behind 256 patch tokens each
VLM_DECODE = 8
MOE_TIME_B, MOE_TIME_S = LM_SLOTS, 384  # the timed prefill: one full bucket
# phase 11: the recurrent families at full width and full depth
SSM_K1, HYBRID_K1, HYBRID_GATES = 49, 147, 36  # a model call (recurrent_per_call)
REC_PROMPTS = LM_PROMPTS + (2,)  # the qwen3 traffic and a 2-token prompt
RING_PROMPT = 2040  # + 16 new tokens: past recurrentgemma-2b's 2048-slot ring
RING_MAX_SEQ = RING_PROMPT + LM_NEW  # so the ring is min(2048, max_seq) = 2048
# phase 12: whisper-tiny at full width and full depth
WHISPER_K1 = (66, 32)  # K1 launches of a prefill / a decode call (whisper_per_call)
WHISPER_MEL_B, WHISPER_PROMPTS, WHISPER_DECODE = 2, (64, 40), 8  # (b): a real mel
WHISPER_STEM_B = 4  # (c): the stem alone on K1-K4
# phase 13: the sharded CNN at full width
SHARD_BATCH = 32
SHARD_RUNS = (((2, 1), 32), ((1, 2), 32), ((2, 1), 6))  # (b): mesh, batch
SHARD_ENGINES = ("kernel", "kernel_implicit", "pas_kernel", "pas_kernel_implicit")
SHARD_TIME_REPS = 5
SHARD_TIME_BUDGET_S = 0.02  # (a): a few forwards a window, behind one spin
SHARD_RANK_TIMEOUT_S = 300  # both ranks of (b), every check
SHARD_COLLECTIVE_TIMEOUT_S = 120
# phase 14: the sharded LM at full width (qwen3-32b, deepseek-moe-16b, 4 layers)
LM_SHARD_BATCH, LM_SHARD_PROMPT = 4, 384
LM_SHARD_STEPS = 8
LM_SHARD_MESHES = ((1, 2), (2, 1))
MOE_SHARD_BIG = (2, 2304)  # 4608 tokens: past the MoE regime switch (> 4096)
# phase 9(e): the recurrent and encoder-decoder families trained at full depth
FAMILY_TRAIN = (("mamba2-130m", 24), ("recurrentgemma-2b", 26), ("whisper-tiny", 4))
# phase 15: sharded training (the AlexNet QAT step, the qwen3 train step)
TRAIN_SHARD_MESHES = ((1, 2), (2, 1))
QAT_SHARD_BATCH = 32
TRAIN_SHARD_STEPS, TRAIN_SHARD_CRASH = 6, 4  # the AlexNet crash-resume, ckpt every 2
TRAIN_SHARD_TIMEOUT_S = 900  # both ranks of (b), every check
# phase 16: TP for the recurrent and encdec families, the sequence-sharded cache
REC_SHARD_MODELS = (("mamba2-130m", 24), ("recurrentgemma-2b", 26), ("whisper-tiny", 4))
REC_SHARD_MESHES = ((1, 2), (2, 1))
RING_SHARD_STEPS = 16  # the hybrid's ring prompt at (1, 2): slots 2040..2055 wrap
SEQ_SHARD_ARCH, SEQ_SHARD_LAYERS, SEQ_SHARD_MESH = "phi3-medium-14b", 4, (1, 4)
REC_SHARD_TIMEOUT_S = 420  # the ranks of (b) or (c), every check
# phase 17: sharded training of the other families: (arch, layers run (0:
# all), the config's layers); recurrentgemma-2b cut to 8 of its 26 layers
# (two groups and the recurrent tail) to keep the phase inside the run's
# time limit (at 26 its steps and build took ~60 of the phase's 302 s);
# (c) phi3's KV heads cut by model 4
FAM_SHARD_MODELS = (("deepseek-moe-16b", MOE_LAYERS, 28), ("internvl2-26b", VLM_LAYERS, 48),
                    ("mamba2-130m", 0, 24), ("recurrentgemma-2b", 8, 26),
                    ("whisper-tiny", 0, 4))
FAM_SHARD_MESHES = ((1, 2), (2, 1))
FAM_SEQ_MODEL, FAM_SEQ_MESH = ("phi3-medium-14b", 4, 40), (1, 4)
FAM_SHARD_TIMEOUT_S = 600  # the ranks of (b) or (c), every check
# AlexNet sharded vs one device, f32: the loss (a mean over the batch) and
# each gradient leaf (|Δ| <= t·max) sum the same products in another order:
# the rows split over data, the GEMMs planned by cuBLAS for the blocks
QAT_LOSS_TOL = 1e-5
QAT_GRAD_TOL = BWD_TOL["float32"]
# phase 18: the tooling; train_lm's steps on the card, the dry-run cells (phase
# 7's 4 x 384 prefill, a decode step against its 512-slot cache), and the
# argument-bytes check: the dry run's bytes against the card's allocation
TOOL_TRAIN_STEPS = 20
# k-means iterations of every LM's dictionaries drawn here (build_lm, phase
# 18): the weights are random and every hold compares two paths on the same
# dictionaries, so two Lloyd iterations (the CPU tests' count) serve; at the
# library's 8 the run spent ~170 s in k-means
QUANT_ITERS = 2
TOOL_PREFILL = (LM_SLOTS, 384)
TOOL_ARG_TOL = 0.01


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def kernel_instance(mangled: str) -> str:
    """``ns::kernel<args>`` of a mangled kernel name: its function name and
    its integer, bool and type template arguments, so that the ptxas lines
    name every template instance."""
    if not mangled.startswith("_ZN"):
        return mangled
    names, pos = [], 3
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:]).group()
        pos += len(n)
        names.append(mangled[pos:pos + int(n)])
        pos += int(n)
    args = []
    if mangled[pos:pos + 1] == "I":
        pos += 1
        while pos < len(mangled) and mangled[pos] != "E":
            m = re.match(r"L[ib](\d+)E|13__nv_bfloat16|f", mangled[pos:])
            if not m:
                break
            args.append(m.group(1) or ("bf16" if m.group().startswith("13") else "f32"))
            pos += len(m.group())
    return "::".join(names) + (f"<{','.join(args)}>" if args else "")


def counted() -> dict:
    """The launch counts of K1–K5 (``ALL_KERNELS``); K6's are checked on
    their own (``lm_phase``, ``k6_phase``)."""
    from repro_torch.kernels import pasm_matmul as pm

    return {k: pm.launches[k] for k in ALL_KERNELS}


def max_err(got, want) -> float:
    """Max |Δ|; raises when an element is over ``TOL + TOL·|want|``."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite kernel output")
    d = (got - want).abs()
    bad = d > TOL + TOL * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} elements over tolerance, "
                             f"max |Δ| {float(d.max()):.3e}")
    return float(d.max())


_SPIN_CYCLES_PER_MS: list = []


def cover_host(host_s: float) -> None:
    """Keep the card busy for 1.5·host_s + 20 µs (a spin kernel) so that
    what the host enqueues meanwhile then runs back to back: the CUDA events
    around it time the device, not the wrappers' Python and launch cost
    (which, at tens of µs a call, is as long as a small kernel)."""
    import torch

    if not _SPIN_CYCLES_PER_MS:  # the spin's clock, once per run
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(2_000_000)
        b.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS.append(2_000_000 / a.elapsed_time(b))
    ms = min(1.5 * host_s * 1e3 + 0.02, 50.0)
    torch.cuda._sleep(int(ms * _SPIN_CYCLES_PER_MS[0]))


def time_ms_host(fn, budget_s: float = 0.25) -> tuple:
    """(mean device ms per call over back-to-back calls after warm-up, host
    µs per call to enqueue one).  The window opens behind cover_host, so a
    call's host cost does not show in its device time."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = max(time.perf_counter() - t0, 1e-5)
    reps = int(min(50, max(3, budget_s / once)))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cover_host(host)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host / reps * 1e6


def time_ms(fn, budget_s: float = 0.25) -> float:
    """Mean device ms per call (:func:`time_ms_host`)."""
    return time_ms_host(fn, budget_s)[0]


def time_cold_ms(fn, budget_s: float = 0.25) -> float:
    """Median device ms per call with the L2 cache flushed before each (a
    read of 128 MiB: a write would leave dirty lines for the timed call to
    write back), every call between its own CUDA events, after warm-up, each
    window behind cover_host.  The median, as single calls of tens of µs
    scatter."""
    import torch

    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    reps = int(min(30, max(3, budget_s / max(time.perf_counter() - t0, 1e-5))))
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for start, end in ev:
        flush.amax()
        cover_host(host)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def check_k1_bf16(y, x, t, bias=None, relu=False, what: str = "") -> tuple:
    """K1's bf16 routes against the plain version: the same exact products
    summed in another order, so |Δ| <= K1_BF16_TOL·(|x|@|W|) + 1e-6 (not
    scaled by |plain|, which cancels at K = 25600).  Returns (max |Δ|, the
    largest |Δ| / (|x|@|W|), i.e. the measured t)."""
    import torch

    from repro_torch.kernels import pasm_matmul as pm

    want = pm.pasm_matmul_plain(x, t.idx, t.codebook, bias, packed=t.packed, relu=relu)
    scale = pm.pasm_matmul_plain(x.abs(), t.idx, t.codebook.abs(), packed=t.packed)
    torch.cuda.synchronize()
    if y.shape != want.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{what}: shape {tuple(y.shape)} or non-finite output")
    d = (y - want).abs()
    bad = d > pm.K1_BF16_TOL * scale + 1e-6
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements over tolerance, "
                             f"max |Δ| {float(d.max()):.3e}")
    return float(d.max()), float((d / scale.clamp_min(1e-30)).max())


@dataclasses.dataclass
class Case:
    """One conv stage on the kernels: inputs on the card plus operands."""

    name: str
    conv: object  # Conv2D
    pool: int
    params: object  # ConvParams (shared / packed)
    img: object  # (B, C, H, W) or (B, H, W, C) on the card

    def geom(self):
        from repro_torch.core import conv as cv

        nhwc = self.conv.layout == "NHWC"
        ih, iw = (self.img.shape[1], self.img.shape[2]) if nhwc \
            else (self.img.shape[2], self.img.shape[3])
        return cv.conv_geom(self.conv, ih, iw, pool=self.pool)

    def patches(self):
        """K1's operand: the window-major im2col patch matrix (+ pad_k)."""
        import torch.nn.functional as F

        from repro_torch.core import conv as cv

        g = self.geom()
        p, _ = cv._im2col(self.img, self.conv)
        if self.pool > 1:
            p = cv._pool_order_patches(p, self.img.shape[0], g.oh, g.ow, self.pool)
        if self.params.pad_k:
            p = F.pad(p, (0, self.params.pad_k))
        return p.contiguous()


def check_case(case: Case, errs: dict, *, k1: bool = True, pasm: bool = True,
               pas: bool = True) -> None:
    """K1 and K2 (``pasm``) and K3 and K4 (``pas``, one dictionary) against
    their plain versions, K1 ≡ K2 and K3 ≡ K4 bitwise; ``k1=False`` skips
    the explicit kernels."""
    import torch

    from repro_torch.core import pasm as _pasm
    from repro_torch.kernels import ops, pas_histogram as ph, pasm_matmul as pm

    t = case.params.gemm_tensor(case.conv.layout)
    bias = case.params.bias
    g = case.geom()
    x = case.patches() if k1 else None
    line = f"  {case.name:<30}"
    if pas and case.params.groups == 1:
        li = _pasm.logical_idx(t)
        y4 = ops.pas_conv2d(case.img, t, g, bias=bias, relu=True)
        p4 = ph.pas_conv_plain(case.img.contiguous(), li, t.codebook, bias,
                               geom=g, relu=True)
        torch.cuda.synchronize()
        e4 = max_err(y4, p4)
        errs["pas_conv"] = max(errs["pas_conv"], e4)
        line += f" K4 {e4:.2e}"
        if k1:
            y3 = ops.pas_matmul(x, t, bias=bias, relu=True, pool=case.pool)
            p3 = ph.pas_matmul_plain(x, li, t.codebook, bias, relu=True,
                                     pool=case.pool)
            torch.cuda.synchronize()
            e3 = max_err(y3, p3)
            errs["pas_matmul"] = max(errs["pas_matmul"], e3)
            same = torch.equal(y3.reshape(y4.shape), y4)
            line += f" K3 {e3:.2e} K3≡K4 {same}"
            if not same:
                raise AssertionError(f"{case.name}: K3 and K4 differ bitwise")
            # a row's result does not depend on M: a slice of whole pool
            # windows, off the block tiles, gives the full call's rows
            pw = case.pool * case.pool
            w0, nw = 1, max(1, x.shape[0] // pw // 2)
            part = ops.pas_matmul(x[w0 * pw:(w0 + nw) * pw].contiguous(), t,
                                  bias=bias, relu=True, pool=case.pool)
            indep = torch.equal(part, y3[w0:w0 + nw])
            line += f" rows⊥M {indep}"
            if not indep:
                raise AssertionError(f"{case.name}: K3 rows depend on M")
    if not pasm:
        log(line)
        return
    y2 = ops.pasm_conv2d(case.img, t, g, bias=bias, relu=True)
    p2 = pm.pasm_conv_plain(case.img.contiguous(), t.idx, t.codebook, bias,
                            geom=g, packed=t.packed, relu=True)
    torch.cuda.synchronize()
    e2 = max_err(y2, p2)
    errs["pasm_conv"] = max(errs["pasm_conv"], e2)
    line += f" K2 {e2:.2e}"
    if k1:
        y1 = ops.pasm_matmul(x, t, bias=bias, relu=True, pool=case.pool)
        p1 = pm.pasm_matmul_plain(x, t.idx, t.codebook, bias, packed=t.packed,
                                  relu=True, pool=case.pool)
        torch.cuda.synchronize()
        e1 = max_err(y1, p1)
        errs["pasm_matmul"] = max(errs["pasm_matmul"], e1)
        same = torch.equal(y1.reshape(y2.shape), y2)
        line += f" K1 {e1:.2e} K1≡K2 {same}"
        if not same:
            raise AssertionError(f"{case.name}: K1 and K2 differ bitwise")
        # K1 simt's rows do not depend on M either (split-K by K and N only)
        pw = case.pool * case.pool
        w0, nw = 1, max(1, x.shape[0] // pw // 2)
        part = ops.pasm_matmul(x[w0 * pw:(w0 + nw) * pw].contiguous(), t,
                               bias=bias, relu=True, pool=case.pool)
        indep = torch.equal(part, y1[w0:w0 + nw])
        plan = pm.simt_plan(x.shape[0], x.shape[1], t.shape[1], case.pool)
        line += f" K1 rows⊥M {indep} (splits {plan.splits})"
        if not indep:
            raise AssertionError(f"{case.name}: K1 rows depend on M")
    log(line)


def check_integer(case: Case, gen) -> None:
    """Paper §5.3: on integer-valued images, dictionaries and biases PASM is
    bit-exact against the weight-shared MAC.  |x|, |cb| <= 8 keeps every
    sum below 2^24 (K <= 3456), so f32 holds it exactly: K3 == K1 and
    K4 == K2 bitwise, whatever order each adds in."""
    import torch

    from repro_torch.core import conv as cv
    from repro_torch.kernels import ops

    p = case.params
    cb = torch.randint(-8, 9, (p.bins,), generator=gen, device="cuda").float()
    bias = torch.randint(-99, 100, (p.c_out,), generator=gen, device="cuda").float()
    ip = cv.ConvParams.shared(p.idx, cb, bias=bias)
    img = torch.randint(-8, 9, tuple(case.img.shape), generator=gen,
                        device="cuda").float()
    c = dataclasses.replace(case, params=ip, img=img)
    t, g, x = ip.gemm_tensor(c.conv.layout), c.geom(), c.patches()
    y1 = ops.pasm_matmul(x, t, bias=bias, relu=True, pool=c.pool)
    y3 = ops.pas_matmul(x, t, bias=bias, relu=True, pool=c.pool)
    y2 = ops.pasm_conv2d(img, t, g, bias=bias, relu=True)
    y4 = ops.pas_conv2d(img, t, g, bias=bias, relu=True)
    torch.cuda.synchronize()
    ok = (torch.equal(y3, y1) and torch.equal(y4, y2)
          and torch.equal(y1.reshape(y2.shape), y2))
    log(f"  {case.name:<30} integer-valued: K3 == K1, K4 == K2 bitwise {ok} "
        f"(|y| max {float(y1.abs().max()):.0f})")
    if not ok:
        raise AssertionError(f"{case.name}: integer PAS differs from the MAC")


def stage_cases(cfg, qparams, batch: int, gen) -> list:
    """The five full-width stages with the served model's dictionaries."""
    import torch

    from repro_torch.core import conv as cv
    from repro_torch.models import cnn

    C, H, W = cfg.in_chw
    out = []
    for i, ((conv, pool), p) in enumerate(zip(cnn.stages(cfg), qparams["conv"])):
        img = torch.randn((batch, C, H, W), generator=gen, device="cuda")
        out.append(Case(f"conv{i + 1} {C}x{H}x{W}", conv, pool, p, img))
        H, W = cv.conv_out_hw(H, W, conv)
        H, W, C = H // pool, W // pool, conv.c_out
    return out


def bound(case: Case, explicit: bool) -> tuple:
    """(ops_ms, bytes_ms, flops) of one stage launch (``roofline.bound_ms``):
    the GEMM's flops (``ops.matmul_flops``) over the f32 peak, and the
    function's plan-free bytes (``hwmodel.conv_hbm_traffic``: the image, or
    on the explicit route the patch matrix, read once; the weights; the
    pooled output) over the memory rate; the bound is the larger."""
    import torch

    from repro_torch import roofline as RL
    from repro_torch.core import hwmodel as hw
    from repro_torch.kernels import ops

    g = case.geom()
    t = case.params.gemm_tensor(case.conv.layout)
    B = case.img.shape[0]
    N = t.shape[1]
    flops = ops.matmul_flops(B * g.P_rows, g.conv_k, N)
    (plh, phh), (plw, phw) = g.pad
    ih, iw = case.img.shape[-2:] if case.conv.layout == "NCHW" else case.img.shape[1:3]
    nbytes = hw.conv_hbm_traffic(
        IH=ih, IW=iw, C=g.c_in, KY=g.ky, KX=g.kx, M=N, stride=g.stride, batch=B,
        bins=t.codebook.shape[-1], pad=(plh, phh, plw, phw), act_bytes=4,
        packed=t.packed, implicit=not explicit, pool=g.pool)
    if explicit:  # K1/K3 read the patch matrix once; its store is the front end's
        nbytes -= B * g.P_rows * g.conv_k * 4
    b = RL.bound_ms(flops, nbytes, torch.float32)
    return b.ops_ms, b.bytes_ms, flops


def k1_bound(t, M: int, act_bytes: int):
    """K1's bound at ``M`` rows of ``x`` (``roofline.bound_ms``): the
    GEMM's flops (``ops.matmul_flops``) over the peak of x's type, and the
    plan-free bytes of ``hwmodel.dense_hbm_traffic`` with K1's store in f32
    (x, the stored indices and dictionaries, the output; no split-K
    partials: the least the card could do).  Returns ``(bound, flops,
    bytes)``."""
    import torch

    from repro_torch import roofline as RL
    from repro_torch.core import hwmodel as hw
    from repro_torch.kernels import ops

    K, N = t.shape
    nbytes = hw.dense_hbm_traffic(T=M, K=K, N=N, bins=t.codebook.shape[-1],
                                  groups=t.codebook.shape[0], act_bytes=act_bytes,
                                  packed=t.packed) + M * N * (4 - act_bytes)
    flops = ops.matmul_flops(M, K, N)
    return (RL.bound_ms(flops, nbytes, torch.bfloat16 if act_bytes == 2 else torch.float32),
            flops, nbytes)


# ---------------------------------------------------------------------------
# K5 and the LM (phases 6-8)
# ---------------------------------------------------------------------------


def check_close(got, want, rtol: float, atol_scale=0.0,
                what: str = "") -> float:
    """Max |Δ| in f32; raises when an element is over
    ``rtol·|want| + 1e-5 + atol_scale`` (a float, or a tensor of want's
    shape)."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite output")
    d = (g - w).abs()
    bad = d > rtol * w.abs() + 1e-5 + atol_scale
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements over tolerance, "
                             f"max |Δ| {float(d.max()):.3e}")
    return float(d.max())


def regroup(q, k, v):
    """ops.flash_attention's layout: (B,Sq,H,hd) → (B·KV, G, Sq, hd) and
    (B,Sk,KV,hd) → (B·KV, Sk, hd), for calling K5 and its plain version
    directly."""
    B, S, H, hd = q.shape
    KV, Sk = k.shape[2], k.shape[1]
    qg = q.reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4).reshape(B * KV, H // KV, S, hd)
    kg = k.permute(0, 2, 1, 3).reshape(B * KV, Sk, hd)
    vg = v.permute(0, 2, 1, 3).reshape(B * KV, Sk, hd)
    return qg.contiguous(), kg.contiguous(), vg.contiguous()


def k5_pv_scale(qg, kg, vg, causal: bool):
    """Σ_j p_j·|v_j| for each output element, in f32, for the bf16 route's
    tolerance: the plain version on |v| (p >= 0); 0 for f32."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    if qg.dtype != torch.bfloat16:
        return 0.0
    return fa.flash_attention_plain(qg, kg, vg.abs(), causal=causal).float()


def check_k5(q, k, v, causal: bool, name: str, errs: dict) -> str:
    """K5 vs its plain version (regrouped operands) and ops.flash_attention
    vs the port's gqa_attention with chunk < S."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.nn import attention as A

    dt = str(q.dtype).split(".")[-1]
    qg, kg, vg = regroup(q, k, v)
    y = fa.flash_attention_kernel_call(qg, kg, vg, causal=causal)
    want = fa.flash_attention_plain(qg, kg, vg, causal=causal)
    torch.cuda.synchronize()
    e = check_close(y, want, K5_TOL[dt], K5_TOL[dt] * k5_pv_scale(qg, kg, vg, causal),
                    what=f"K5 {name}")
    errs["flash_attention"] = max(errs["flash_attention"], e)
    S = q.shape[1]
    o = ops.flash_attention(q, k, v, causal=causal)
    g = A.gqa_attention(q, k, v, causal=causal, chunk=max(4, k.shape[1] // 3))
    torch.cuda.synchronize()
    if not torch.equal(o, y.reshape(q.shape[0], k.shape[2], -1, S, q.shape[3])
                       .permute(0, 3, 1, 2, 4).reshape(q.shape)):
        raise AssertionError(f"K5 {name}: ops.flash_attention differs from the kernel call")
    t = K5_GQA_TOL[dt]
    eg = check_close(o, g, t, t * float(v.float().abs().max()), what=f"K5 vs gqa {name}")
    return f"vs plain {e:.2e}, vs gqa_attention {eg:.2e}"


def k5_phase(gen, errs: dict) -> None:
    import torch

    shapes = [  # (name, B, S, H, KV, hd)
        ("GQA", 2, 64, 4, 2, 16), ("MHA ragged S", 1, 56, 4, 4, 16),
        ("MQA", 1, 128, 8, 1, 32), ("stablelm-3b hd80 MHA", 1, 333, 32, 32, 80),
        ("hd64 GQA", 1, 300, 8, 2, 64), ("hd192 GQA", 1, 200, 4, 2, 192),
        ("hd256 MQA", 1, 160, 4, 1, 256),
        ("qwen3-32b prefill", 1, 512, 64, 8, 128),
        ("qwen3-32b prefill ragged", 1, 1000, 64, 8, 128),
    ]
    log(f"phase 6: K5 vs plain (f32 SIMT route |Δ| <= t·|plain| + 1e-5, bf16 "
        f"tensor-core route |Δ| <= t·(|plain| + Σp|v|) + 1e-5; t = {K5_TOL}) "
        f"and vs gqa_attention (chunk < S; |Δ| <= t·(|gqa| + max|v|) + 1e-5, "
        f"t = {K5_GQA_TOL})")
    from repro_torch.kernels import flash_attention as fa

    for name, B, S, H, KV, hd in shapes:
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda")
        k = torch.randn((B, S, KV, hd), generator=gen, device="cuda")
        v = torch.randn((B, S, KV, hd), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                res = check_k5(q.to(dtype), k.to(dtype), v.to(dtype), causal,
                               f"{name} {dtype} causal={causal}", errs)
                if dtype == torch.float32:  # the redesigned SIMT route, timed
                    qg, kg, vg = regroup(q, k, v)
                    ms = time_ms(lambda: fa.flash_attention_kernel_call(  # noqa: B023
                        qg, kg, vg, causal=causal), 0.05)
                    res += f"; f32 kernel {ms:.4f} ms"
                log(f"  {name:<26} B{B} S{S} H{H}/{KV} hd{hd} "
                    f"{str(dtype).split('.')[-1]:<8} causal={causal!s:<5} {res}")


def lm_config():
    """qwen3-32b at full width, 4 of its 64 layers, 16-bin int4 PASM on K1."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-32b")
    return dataclasses.replace(cfg, n_layers=LM_LAYERS).with_quant(
        enabled=True, bins=16, impl="kernel")


def serve_lm(cfg, params, prompts, impl: str, max_seq: int = LM_MAX_SEQ):
    """Serve ``prompts`` through the Engine on ``impl`` with staggered
    submits: two at tick 0, then one more every second tick.  Returns the
    engine, the requests and the launch counts of the run."""
    import torch

    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.serve.engine import Engine

    eng = Engine(cfg.with_quant(impl=impl), params, batch_slots=LM_SLOTS,
                 max_seq=max_seq)
    torch.cuda.synchronize()
    pm.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=LM_NEW) for p in prompts[:2]]
    live_submits = 0
    for p in prompts[2:]:
        eng.step()
        eng.step()
        live_submits += bool(eng.live)  # admission lands while slots decode
        reqs.append(eng.submit(p, max_new=LM_NEW))
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, reqs, counted(), wall, live_submits, dict(pm.k1_routes)


def padded(prompts) -> tuple:
    """Right-padded ``(B, S)`` tokens on the card and their lengths."""
    import torch

    B, S = len(prompts), max(len(p) for p in prompts)
    toks = np.zeros((B, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device="cuda")
    return torch.from_numpy(toks).cuda(), lengths


def teacher_forced_logits(cfg, params, prompts, tokens, impl: str, batch: int = 0) -> list:
    """Per-step logits of all prompts as right-padded batches of ``batch``
    prompts (0: one batch): prefill, then decode steps fed the given tokens
    (the kernel run's); each step's logits concatenated over the batches."""
    import torch

    from repro_torch.models import transformer as TT

    c = cfg.with_quant(impl=impl)
    batch = batch or len(prompts)
    steps = []
    for i in range(0, len(prompts), batch):
        toks, lengths = padded(prompts[i:i + batch])
        caches = TT.init_caches(c, toks.shape[0], LM_MAX_SEQ, device="cuda")
        logits, caches = TT.prefill(params, toks, caches, c, lengths=lengths)
        out = [logits.float()]
        for j in range(LM_NEW - 1):
            nxt = torch.tensor([[t[j]] for t in tokens[i:i + batch]], dtype=torch.int32,
                               device="cuda")
            logits, caches = TT.decode_step(params, nxt, caches, c)
            out.append(logits.float())
        steps.append(out)
    torch.cuda.synchronize()
    return [torch.cat(s) for s in zip(*steps)]


def lm_phase(gen, errs: dict, card: str) -> dict:
    """Phase 7; returns the launch counts of the kernel run and the K5 run."""
    import torch

    from repro_torch.kernels import pasm_matmul as pm

    cfg = lm_config()
    params = build_lm(cfg, gen, "7", 64)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in LM_PROMPTS]
    per_call = 7 * cfg.n_layers + 1
    runs, decoded = {}, {}
    for impl in ("kernel", "dequant"):
        with DecodeSpy() as dec:
            eng, reqs, counts, wall, live_submits, routes = serve_lm(cfg, params,
                                                                     prompts, impl)
        decoded[impl] = dec.captured
        k6 = pm.launches["decode_attention"]  # K6: every layer of every decode call
        if k6 != cfg.n_layers * eng.calls["decode"]:
            raise AssertionError(f"LM {impl}: K6 launched {k6} times, want "
                                 f"{cfg.n_layers} a decode call ({eng.calls})")
        roll = eng.metrics.rollup()
        calls = eng.calls["prefill"] + eng.calls["decode"]
        want = {k: per_call * calls if (impl == "kernel" and k == "pasm_matmul") else 0
                for k in ALL_KERNELS}
        log(f"  {impl:<8} {len(reqs)} requests, {eng.tick} ticks, model calls "
            f"{eng.calls}, launches {counts}, submits while slots were live "
            f"{live_submits}, n_degraded "
            f"{roll.get('n_degraded', 0)}, K1 launches by route {routes}, "
            f"{wall:.2f} s host clock incl. first calls, {roll['tok_s']:.1f} "
            f"tok/s ({card})")
        if counts != want:
            raise AssertionError(f"LM {impl}: expected launches {want} "
                                 f"({per_call} per model call), got {counts}")
        if roll.get("n_degraded", 0) or not live_submits:
            raise AssertionError(f"LM {impl}: degraded or no continuous admission: {roll}")
        if not all(r.done and len(r.out) == LM_NEW for r in reqs):
            raise AssertionError(f"LM {impl}: a request was not served {LM_NEW} tokens")
        runs[impl] = (counts, [r.out for r in reqs], routes, k6)
    ko, do = runs["kernel"][1], runs["dequant"][1]
    agree = float(np.mean([a == b for x, y in zip(ko, do) for a, b in zip(x, y)]))
    log(f"  greedy tokens agreeing, kernel vs dequant: {agree:.4f} of "
        f"{len(ko) * LM_NEW} (streams: {sum(x == y for x, y in zip(ko, do))}/{len(ko)} equal)")
    # both runs decode on K6: each held to the plain version on its own operands
    for impl, captured in decoded.items():
        held_k6(captured, f"{cfg.name} {impl}")
    del decoded
    # the kernel run also records what the transformer hands gqa_attention
    # at prefill: the served model's own attention operands, every layer
    with AttnSpy() as attn:
        lk = teacher_forced_logits(cfg, params, prompts, ko, "kernel")
    lk2 = teacher_forced_logits(cfg, params, prompts, ko, "kernel")
    if not all(torch.equal(a, b) for a, b in zip(lk, lk2)):
        raise AssertionError("LM logits: a second kernel run differs bitwise")
    log(f"  teacher-forced logits of a second kernel run: bitwise equal to the "
        f"first at all {len(lk)} steps")
    ld = teacher_forced_logits(cfg, params, prompts, ko, "dequant")
    worst, top = 0.0, 0.0
    for j, (a, b) in enumerate(zip(lk, ld)):
        top = max(top, float(b.abs().max()))
        worst = max(worst, check_close(a, b, 0.0, LM_LOGIT_TOL * float(b.abs().max()),
                                       what=f"LM logits step {j}"))
    same = float(np.mean([bool((a.argmax(-1) == b.argmax(-1)).all())
                          for a, b in zip(lk, ld)]))
    log(f"  teacher-forced logits, kernel vs dequant, {len(lk)} steps x "
        f"{len(prompts)} prompts: max |Δ| {worst:.4e} (|logit| max {top:.3f}, "
        f"tolerance {LM_LOGIT_TOL} of it); steps with every argmax equal {same:.3f}")

    # K5 on the served model's attention operands, one prefill call a layer
    if len(attn.captured) != cfg.n_layers:
        raise AssertionError(f"{len(attn.captured)} prefill attention calls recorded")
    k5 = held_k5(attn.captured, cfg.name, errs)
    return {"lm": runs["kernel"][0], "k5": k5, "cfg": cfg, "params": params,
            "routes": runs["kernel"][2], "k6": runs["kernel"][3] + runs["dequant"][3]}


def k5_bound(B, S, H, KV, hd, dtype, causal: bool = True):
    """Attention's bound (``roofline.bound_ms``): QKᵀ and PV over every
    (query, key) pair, half of them causal (``ops.matmul_flops``), at the
    peak of ``dtype``; q, k, v read once and the output written once."""
    import torch

    from repro_torch import roofline as RL
    from repro_torch.kernels import ops

    flops = ops.matmul_flops(B * H * S, hd, S) * (1 if causal else 2)
    moved = B * S * (2 * H + 2 * KV) * hd * torch.empty((), dtype=dtype).element_size()
    return RL.bound_ms(flops, moved, dtype)


def lm_timings(lm: dict, gen, card: str, errs: dict) -> dict:
    """Phase 8: K5 at the qwen3 prefill shape and K1 at the LM's shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch import roofline as RL
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import pasm_matmul as pm

    cfg, params = lm["cfg"], lm["params"]
    B, S, H, KV, hd = 1, K5_TIME_S, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    log(f"phase 8: CUDA-event timings at the LM shapes ({card})")
    rows = {}
    hw_ = RL.HW()
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dtype)
        qg, kg, vg = regroup(q, k, v)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        k_fn = lambda: fa.flash_attention_kernel_call(qg, kg, vg, causal=True)
        p_fn = lambda: fa.flash_attention_plain(qg, kg, vg, causal=True)
        l_fn = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                      enable_gqa=True)
        t = K5_TOL[str(dtype).split(".")[-1]]
        e = check_close(k_fn(), p_fn(), t, t * k5_pv_scale(qg, kg, vg, True),
                        what="K5 timing")
        errs["flash_attention"] = max(errs["flash_attention"], e)
        ms, plain_ms, lib_ms = time_ms(k_fn), time_ms(p_fn), time_ms(l_fn)
        bd = k5_bound(B, S, H, KV, hd, dtype)
        dt = str(dtype).split(".")[-1]
        rows[dt] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=bd.ms, bound_by=bd.by, max_abs_err=e)
        log(f"  K5 B{B} S{S} H{H}/{KV} hd{hd} causal {dt:<8}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f}, library (SDPA) {lib_ms:.4f}, bound "
            f"{bd.ms:.4f} by {bd.by} ({hw_.flops_rate(dtype) / 1e12:.0f} "
            f"TFLOP/s, {hw_.hbm_bw / 1e12} TB/s), {2 * B * H * S * S * hd / ms / 1e9:.1f} "
            f"TFLOP/s, {bd.ms / ms:.1%} of the bound [{card}]"
            + (f"; the f32 route's first design (four threads a query row) took "
               f"{K5_F32_FIRST_MS} ms here" if dtype == torch.float32 else ""))
        del q, k, v, qg, kg, vg, qh, kh, vh
    lp = params["layers"][0]
    mats = {"wq": lp["attn"]["wq"], "w1": lp["mlp"]["w1"], "w2": lp["mlp"]["w2"],
            "lm_head": params["lm_head"]}
    log(f"  K1 tolerance: |Δ| <= {pm.K1_BF16_TOL}·(|x|@|W|) + 1e-6; ms warm = "
        f"back-to-back calls, cold = L2 flushed before every call, both device "
        f"time (behind a spin kernel that covers the host's enqueue); host = "
        f"µs a call takes the host to enqueue")
    k1 = {}  # route -> summed row over the four matrices
    worst_t = 0.0
    for M in (4, 384):
        tot = dict.fromkeys(("ms", "ms_cold", "plain_ms", "library_ms",
                             "library_ms_cold", "bound_ms"), 0.0)
        for name, p in mats.items():
            t = p.gemm_tensor()
            K, N = t.shape
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            w = p.dense_matrix(torch.bfloat16)
            route = pm.k1_plan(M, K, N, x.dtype, packed=t.packed,
                               groups=t.codebook.shape[0]).route
            k_fn = lambda: ops.pasm_matmul(x, t)
            p_fn = lambda: pm.pasm_matmul_plain(x, t.idx, t.codebook, packed=t.packed)
            l_fn = lambda: torch.matmul(x, w)
            e, tm = check_k1_bf16(k_fn(), x, t, what=f"K1 {route} M{M} {name}")
            worst_t = max(worst_t, tm)
            errs["pasm_matmul"] = max(errs["pasm_matmul"], e)
            (ms, host_us), plain_ms = time_ms_host(k_fn), time_ms(p_fn)
            lib_ms, lib_host_us = time_ms_host(l_fn)
            ms_c, lib_c = time_cold_ms(k_fn), time_cold_ms(l_fn)
            bd, flops, moved = k1_bound(t, M, 2)
            for key, val in (("ms", ms), ("ms_cold", ms_c), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("library_ms_cold", lib_c),
                             ("bound_ms", bd.ms)):
                tot[key] += val
            log(f"  K1 M{M:<4} {name:<8} K{K} N{N} bf16 x, route {route}: kernel "
                f"{ms:.4f} ms (cold {ms_c:.4f}, host {host_us:.1f} µs), plain "
                f"{plain_ms:.4f}, library (bf16 matmul) {lib_ms:.4f} (cold "
                f"{lib_c:.4f}, host {lib_host_us:.1f} µs), bound "
                f"{bd.ms:.4f} by {bd.by}, "
                f"{flops / ms / 1e9:.2f} TFLOP/s, {moved / ms_c / 1e6:.1f} GB/s cold, "
                f"max |Δ| vs plain {e:.2e} (|Δ|/(|x|@|W|) {tm:.2e}) [{card}]")
            del w
        tot["bound_by"] = "bytes" if M == 4 else "operations"
        k1[route] = tot
        log(f"  K1 M{M} sum of the four ({route}): kernel {tot['ms']:.4f} ms (cold "
            f"{tot['ms_cold']:.4f}), plain {tot['plain_ms']:.4f}, library "
            f"{tot['library_ms']:.4f} (cold {tot['library_ms_cold']:.4f}), bound "
            f"{tot['bound_ms']:.4f} [{card}]")
    log(f"  K1 bf16 routes: largest |Δ|/(|x|@|W|) over the LM rows {worst_t:.3e} "
        f"(tolerance {pm.K1_BF16_TOL})")

    log(f"  K1 M-sweep, L2 flushed before every call: routed kernel vs the old "
        f"route (the call on x.float(): the f32 SIMT kernel) vs bf16 torch.matmul "
        f"[{card}]")
    for name in ("w2", "lm_head"):
        p = mats[name]
        t = p.gemm_tensor()
        K, N = t.shape
        w = p.dense_matrix(torch.bfloat16)
        for M in K1_SWEEP_M:
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            xf = x.float()
            plan = pm.k1_plan(M, K, N, x.dtype, packed=t.packed,
                              groups=t.codebook.shape[0])
            k_fn = lambda: ops.pasm_matmul(x, t)
            o_fn = lambda: ops.pasm_matmul(xf, t)
            l_fn = lambda: torch.matmul(x, w)
            e, _ = check_k1_bf16(k_fn(), x, t, what=f"K1 sweep {name} M{M}")
            errs["pasm_matmul"] = max(errs["pasm_matmul"], e)
            ms, old_ms, lib_ms = time_cold_ms(k_fn), time_cold_ms(o_fn), time_cold_ms(l_fn)
            bound = k1_bound(t, M, 2)[0].ms
            log(f"    {name:<8} M{M:<4} route {plan.route:<6} (splits {plan.splits}, "
                f"tile {plan.tile}, {plan.blocks} blocks): kernel {ms:.4f} ms, old "
                f"route {old_ms:.4f} ({old_ms / ms:.1f}x), bf16 matmul {lib_ms:.4f} "
                f"({ms / lib_ms:.2f}x of it), bound {bound:.4f}")
            if ms >= old_ms:
                raise AssertionError(f"K1 {name} M{M}: the {plan.route} route "
                                     f"({ms:.4f} ms) is not faster than the old "
                                     f"route ({old_ms:.4f} ms)")
        del w
    rows["k1"] = k1
    return rows


def k6_live_rows(n: int) -> np.ndarray:
    """The rows each of ``n`` slots reads at a tick of ``phi3-serve-closed``:
    the first ``n`` requests of its mix (``K6_MIX``), drawn by the
    benchmark's own generator, each a seeded uniform share of the way
    through its output."""
    from portbench import traffic

    mix = json.loads(K6_MIX.read_text())
    g = traffic.rng(0, "lm_sizes")
    prompt = np.array(traffic.stratified(mix["prompt_len"], n, g))
    out = np.array(traffic.stratified(mix["output_len"], n, g))
    done = np.random.default_rng(SEED).uniform(0, 1, n) * out
    return (prompt + done).astype(np.int64) + 1


def k6_close(y, q, k, v, pos, what: str, *, window=None, offset: int = 0,
             partial: bool = False) -> float:
    """K6's output ``y`` held to ``decode_attention_plain`` on the same
    operands: within ``1e-5 + 1e-5·|plain|`` where the cache and the output
    are f32, else ``|Δ| <= BF16_TOL·(|plain| + Σ p·|v|)`` (K5's form; the sum
    is the plain version on ``|v|``).  A partial ``(m, l, o)`` is folded
    alone (``combine_partials``) on both sides first.  Raises past the
    tolerance; returns the max |Δ|."""
    import torch

    from repro_torch.kernels import decode_attention as K6
    from repro_torch.nn.attention import combine_partials

    def plain(vals):
        r = K6.decode_attention_plain(q, k, vals, pos, window=window, offset=offset,
                                      partial=partial)
        return combine_partials([r]) if partial else r.float()

    got = combine_partials([y]) if partial else y.float()
    want = plain(v)
    d = (got - want).abs()
    if k.dtype == torch.float32 and (partial or y.dtype == torch.float32):
        lim = 1e-5 + 1e-5 * want.abs()
    else:
        lim = K6.BF16_TOL * (want.abs() + plain(v.abs()))
    if not bool(torch.isfinite(got).all()) or not bool((d <= lim).all()):
        raise AssertionError(f"K6 {what}: max |Δ| {float(d.max()):.3e}, "
                             f"{int((d > lim).sum())} over tolerance or not finite")
    return float(d.max())


def k6_phase(gen, card: str) -> dict:
    """Phase 8(b): K6 (split-KV decode attention) at phi3-medium-14b's
    serving shape, 16 slots x 4096 bf16 positions, 10 KV heads, G 4, hd 128:
    held to its plain version (``decode_attention.BF16_TOL``), bitwise on a
    repeat, launches counted; then timed warm and cold (L2 flushed) at the
    closed mix's live lengths and with every slot full (the open mix's dead
    slots read all 4096 rows) beside the bound (the live K/V rows read
    once), the plain version and ``F.scaled_dot_product_attention`` on the
    same masked cache (timed only: the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import roofline as RL
    from repro_torch.kernels import decode_attention as K6
    from repro_torch.kernels import pasm_matmul as pm

    B, S, KV, G, hd = K6_SHAPE
    bf = torch.bfloat16
    q = torch.randn((B, 1, KV * G, hd), generator=gen, device="cuda").to(bf)
    k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(bf)
    v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(bf)
    live = k6_live_rows(B)
    out = {}
    for name, rows in (("closed mix", live), ("every slot full", np.full(B, S))):
        pos = torch.tensor(rows, dtype=torch.int32, device="cuda")
        before = pm.launches["decode_attention"]
        y = K6.decode_attention_kernel_call(q, k, v, pos)
        again = K6.decode_attention_kernel_call(q, k, v, pos)
        torch.cuda.synchronize()
        if pm.launches["decode_attention"] != before + 2:
            raise AssertionError(f"K6 {name}: launches {pm.launches}")
        if not torch.equal(y, again):
            raise AssertionError(f"K6 {name}: a second call differs bitwise")
        err = k6_close(y, q, k, v, pos, name)
        mask = K6.valid_rows(pos, S, None)[:, None, None, :]
        k_fn = lambda: K6.decode_attention_kernel_call(q, k, v, pos)  # noqa: E731
        p_fn = lambda: K6.decode_attention_plain(q, k, v, pos)  # noqa: E731
        l_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=True)
        ms, host_us = time_ms_host(k_fn)
        ms_cold, plain_ms, lib_ms = time_cold_ms(k_fn), time_ms(p_fn), time_ms(l_fn)
        n_rows = int(np.minimum(rows, S).sum()) * KV  # (slot, KV head) rows read
        flops = 4 * n_rows * G * hd
        moved = (2 * n_rows * hd + 2 * B * KV * G * hd) * 2  # K, V rows; q, out
        bd = RL.bound_ms(flops, moved, bf)
        out[name] = dict(ms=ms, ms_cold=ms_cold, host_us=host_us, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bd.ms, bound_by=bd.by,
                         max_abs_err=err)
        log(f"  K6 {name} ({B} slots x {S}, {KV} KV heads, G {G}, hd {hd}, bf16; "
            f"{n_rows // KV} live rows, mean {rows.mean():.0f} a slot): {ms:.4f} ms warm, "
            f"{ms_cold:.4f} cold ({bd.ms / ms_cold:.1%} of the bound), host "
            f"{host_us:.1f} us a call; plain {plain_ms:.4f}, library "
            f"(scaled_dot_product_attention) {lib_ms:.4f}, bound {bd.ms:.4f} by "
            f"{bd.by}; max |Δ| vs plain {err:.3e} [{card}]")
    return out

# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------


def bwd_close(got, want, tol: float, what: str) -> float:
    """Max |Δ| / max|want|; raises when an element is over ``tol·max|want|``."""
    import torch

    if got is None or got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: gradient {None if got is None else got.shape} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite gradient")
    top = float(w.abs().max())
    d = float((g - w).abs().max())
    if d > tol * top:
        raise AssertionError(f"{what}: max |Δ| {d:.3e} over {tol:.1e} of max|want| "
                             f"{top:.3e}")
    return d / max(top, 1e-30)


def kink_free_grad(pre, pool: int, gen):
    """A random upstream gradient for a relu'd, ``pool``-pooled NCHW map,
    zero where either side may pick another valid subgradient: pooled
    windows whose largest pre-activation is within KINK of 0 or of the
    window's second largest (pool 1: pixels within KINK of 0)."""
    import torch

    B, C, oh, ow = pre.shape
    ohp, owp = oh // pool, ow // pool
    win = pre[:, :, : ohp * pool, : owp * pool].reshape(B, C, ohp, pool, owp, pool)
    win = win.permute(0, 1, 2, 4, 3, 5).reshape(B, C, ohp, owp, pool * pool)
    top = torch.topk(win, min(2, pool * pool), dim=-1).values
    keep = top[..., 0].abs() >= KINK
    if pool > 1:
        keep &= (top[..., 0] - top[..., 1]) >= KINK
    g = torch.randn((B, C, ohp, owp), generator=gen, device=pre.device)
    return g * keep, float(keep.float().mean())


def conv_bwd_cases(cfg, params, qparams, gen, errs: dict) -> None:
    """Phase 9(a), AlexNet: conv1 (pooled) shared and packed, conv3 shared,
    packed and groups=2, on both kernel engines, against the einsum engine
    (dequantize, dot, bias, ReLU, unfused pool) under autograd."""
    import torch

    from repro_torch.core import conv as cv
    from repro_torch.kernels import pasm_matmul as pm

    cases = stage_cases(cfg, qparams, 4, gen)
    for i in (0, 2):
        case = cases[i]
        shared = case.params
        variants = [("shared", shared), ("packed", shared.pack(layout=case.conv.layout))]
        if i == 2:
            variants.append(("groups=2", cv.ConvParams.quantize(
                params["conv"][i].kernel, cfg.bins, bias=params["conv"][i].bias,
                groups=2)))
        with torch.no_grad():
            pre = cv.conv2d(case.img, shared,
                            dataclasses.replace(case.conv, relu=False), engine="einsum")
        g, kept = kink_free_grad(pre, case.pool, gen)
        for kind, p in variants:
            want = None
            for engine in ("einsum", "kernel", "kernel_implicit"):
                x = case.img.clone().requires_grad_()
                cb = p.codebook.clone().requires_grad_()
                b = p.bias.clone().requires_grad_()
                pm.reset_launches()
                y = cv.conv2d(x, dataclasses.replace(p, codebook=cb, bias=b), case.conv,
                              engine=engine, pool=case.pool)
                got = torch.autograd.grad(y, (x, cb, b), g)
                torch.cuda.synchronize()
                if engine == "einsum":
                    want = got
                    continue
                key = SERVED_KERNEL[engine]
                if pm.launches[key] != 1 or sum(pm.launches.values()) != 1:
                    raise AssertionError(f"{case.name} {kind} {engine}: launches "
                                         f"{pm.launches}")
                rel = [bwd_close(a, w, BWD_TOL["float32"],
                                 f"{case.name} {kind} {engine} d{n}")
                       for a, w, n in zip(got, want, ("x", "codebook", "bias"))]
                errs["bwd_f32"] = max(errs["bwd_f32"], *rel)
                log(f"  {case.name:<16} pool {case.pool} {kind:<8} {engine:<15} "
                    f"|Δ|/max: dx {rel[0]:.2e}, dcodebook {rel[1]:.2e}, dbias "
                    f"{rel[2]:.2e} (g kept on {kept:.4f} of the outputs)")


def lm_bwd_cases(lm: dict, gen, errs: dict) -> None:
    """Phase 9(a), LM: ``ops.pasm_matmul`` at ``w2`` and ``lm_head`` with bf16
    x at M = 1024 (the ``mma`` route) against the plain chain."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import pasm_matmul as pm

    params = lm["params"]
    M = TRAIN_BATCH * TRAIN_SEQ
    for name, p in (("w2", params["layers"][0]["mlp"]["w2"]),
                    ("lm_head", params["lm_head"])):
        t = p.gemm_tensor()
        K, N = t.shape
        x0 = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        g = torch.randn((M, N), generator=gen, device="cuda")
        grads = {}
        for side in ("kernel", "plain"):
            x = x0.clone().requires_grad_()
            cb = t.codebook.clone().requires_grad_()
            pm.reset_launches()
            if side == "kernel":
                y = ops.pasm_matmul(x, dataclasses.replace(t, codebook=cb))
            else:
                y = pm.pasm_matmul_plain(x, t.idx, cb, packed=t.packed)
            grads[side] = torch.autograd.grad(y, (x, cb), g)
            torch.cuda.synchronize()
            if side == "kernel" and (pm.k1_routes["mma"] != 1 or
                                     sum(pm.launches.values()) != 1):
                raise AssertionError(f"LM {name}: launches {pm.launches} "
                                     f"{pm.k1_routes}")
            del y
        rel = [bwd_close(a, w, BWD_TOL["bfloat16"], f"LM {name} d{n}")
               for a, w, n in zip(grads["kernel"], grads["plain"], ("x", "codebook"))]
        errs["bwd_bf16"] = max(errs["bwd_bf16"], *rel)
        log(f"  LM {name:<8} K{K} N{N} bf16 x M{M} (mma): |Δ|/max dx {rel[0]:.2e}, "
            f"dcodebook {rel[1]:.2e}")
        del grads, x0, g
        torch.cuda.empty_cache()


def leaf_grads(grads) -> dict:
    """The grads of the codebooks, norms and ``embed`` by path."""
    from repro_torch.tree import flatten_with_path

    return {"/".join(path): g for path, g in flatten_with_path(grads)
            if path[-1] == "codebook" or "norm" in path[-1] or path == ("embed",)}


def step_parts(params, gen, card: str) -> dict:
    """CUDA-event times of one train step's large parts at M = 1024, per
    layer (its seven weight-shared linears) and for ``lm_head``: K1's
    forward, the backward's ``dx = g·Wᵀ`` (W dequantized to bf16), its f32
    ``xᵀg`` and the codebook gradient's masked sums over it."""
    import torch

    from repro_torch.core import pasm as _pasm
    from repro_torch.core.qat import bin_sums
    from repro_torch.kernels import ops

    M = TRAIN_BATCH * TRAIN_SEQ
    lp = params["layers"][0]
    groups = {"layer": [lp["attn"][k] for k in ("wq", "wk", "wv", "wo")]
              + [lp["mlp"][k] for k in ("w1", "w3", "w2")],
              "lm_head": [params["lm_head"]]}
    out = {}
    for name, mats in groups.items():
        tot = dict.fromkeys(("k1", "dx", "xg", "bins"), 0.0)
        for p in mats:
            t = p.gemm_tensor()
            K, N = t.shape
            G, B = t.codebook.shape
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            g = torch.randn((M, N), generator=gen, device="cuda")
            tot["k1"] += time_ms(lambda: ops.pasm_matmul(x, t))
            tot["dx"] += time_ms(lambda: ops._pasm_bwd(x, t.idx, t.codebook, t.packed,
                                                       g, True, False))
            tot["xg"] += time_ms(lambda: torch.matmul(x.T.float(), g))
            xg = torch.matmul(x.T.float(), g).reshape(G, K // G, N)
            li = _pasm.unpack_int4(t.idx).reshape(G, K // G, N)
            tot["bins"] += time_ms(lambda: bin_sums(xg, li, B))
            del x, g, xg, li
            torch.cuda.empty_cache()
        out[name] = tot
    h = out["lm_head"]
    K, N = params["lm_head"].shape
    log(f"  lm_head backward parts (K{K} N{N}, M{M}): dx {h['dx']:.3f} ms, "
        f"x^T g {h['xg']:.3f} ms, the codebook gradient's masked sums "
        f"{h['bins']:.3f} ms; its forward on K1 {h['k1']:.3f} ms; a layer's seven "
        f"linears: K1 {out['layer']['k1']:.3f}, dx {out['layer']['dx']:.3f}, x^T g "
        f"{out['layer']['xg']:.3f}, masked sums {out['layer']['bins']:.3f} ms [{card}]")
    return out


def lm_train(lm: dict, gen, card: str, errs: dict) -> dict:
    """Phase 9(b): qwen3-32b at full width (4 of 64 layers) trained."""
    import torch

    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    from repro_torch.train.loop import run_loop
    from repro_torch.tree import tree_leaves

    cfg, params = lm["cfg"], lm["params"]
    if not cfg.remat:
        raise AssertionError(f"{cfg.name}: remat is off")
    cfg_d = cfg.with_quant(impl="dequant")
    dcfg = DataConfig(seed=SEED, vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batch = synthetic_batch(dcfg, 0, device="cuda")
    log(f"phase 9(b): {cfg.name} full width, {cfg.n_layers} of 64 layers, trained "
        f"at batch {TRAIN_BATCH} x seq {TRAIN_SEQ} (M = {TRAIN_BATCH * TRAIN_SEQ} "
        f"rows), remat on [{card}]")
    res = {}
    for impl, c in (("kernel", cfg), ("dequant", cfg_d)):
        torch.cuda.synchronize()
        pm.reset_launches()
        loss, _, grads = st.loss_and_grads(params, batch, c)
        torch.cuda.synchronize()
        res[impl] = (float(loss), leaf_grads(grads), counted(),
                     dict(pm.k1_routes))
        del grads
    want_k = {k: TRAIN_K1 if k == "pasm_matmul" else 0 for k in ALL_KERNELS}
    routes_k = {"simt": 0, "stream": 0, "mma": TRAIN_K1}
    if res["kernel"][2] != want_k or res["kernel"][3] != routes_k:
        raise AssertionError(f"train step on kernel: launches {res['kernel'][2]} "
                             f"routes {res['kernel'][3]}, want {want_k} {routes_k}")
    if any(res["dequant"][2].values()):
        raise AssertionError(f"train step on dequant launched {res['dequant'][2]}")
    lk, ld = res["kernel"][0], res["dequant"][0]
    if not (np.isfinite(lk) and abs(lk - ld) <= LM_LOSS_TOL * abs(ld)):
        raise AssertionError(f"train loss kernel {lk} vs dequant {ld}")
    worst = {}
    for name, gd in res["dequant"][1].items():
        gk = res["kernel"][1][name]
        kind = name.split("/")[-1] if "norm" in name else (
            "embed" if name == "embed" else "codebook")
        worst[kind] = max(worst.get(kind, 0.0),
                          bwd_close(gk, gd, LM_GRAD_TOL, f"train grad {name}"))
    errs["lm_grad"] = max(worst.values())
    log(f"  one step, kernel vs dequant: loss {lk:.6f} vs {ld:.6f}; grads |Δ|/max "
        f"by leaf kind {', '.join(f'{k} {v:.2e}' for k, v in sorted(worst.items()))} "
        f"(tolerance {LM_GRAD_TOL}); K1 launches {res['kernel'][2]['pasm_matmul']} "
        f"(routes {res['kernel'][3]}), on dequant {sum(res['dequant'][2].values())}")
    del res
    torch.cuda.empty_cache()

    parts = step_parts(params, gen, card)
    ocfg = opt.AdamWConfig()
    opt_state = opt.init_opt_state(params)
    timing = {}
    for impl, c in (("kernel", cfg), ("dequant", cfg_d)):
        step = st.make_train_step(c, ocfg)
        out = step(params, opt_state, batch)  # warm
        del out
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        out = step(params, opt_state, batch)
        b.record()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        ms, peak = a.elapsed_time(b), torch.cuda.max_memory_allocated()
        m = out[2]
        if int(m["skipped"]) or not np.isfinite(float(m["loss"])):
            raise AssertionError(f"train step on {impl}: {m}")
        timing[impl] = dict(ms=ms, host_s=host, peak_gb=peak / 1e9)
        log(f"  train step on {impl:<7}: {ms:.1f} ms between CUDA events "
            f"({host:.3f} s host clock), peak memory {peak / 1e9:.2f} GB "
            f"(max_memory_allocated), loss {float(m['loss']):.6f} [{card}]")
        del out, step
        torch.cuda.empty_cache()

    # the step's update (AdamW, the non-finite probe, the select) alone
    _, _, grads = st.loss_and_grads(params, batch, cfg)
    loss = torch.zeros((), device="cuda")
    upd_ms = time_ms(lambda: st._guarded_update(params, opt_state, loss, grads, ocfg,
                                                guard=True))
    del grads
    torch.cuda.empty_cache()
    L = cfg.n_layers
    k1 = (2 * L * parts["layer"]["k1"] + parts["lm_head"]["k1"])
    dx, xg, bins = (L * parts["layer"][k] + parts["lm_head"][k] for k in ("dx", "xg", "bins"))
    rest = timing["kernel"]["ms"] - (k1 + dx + xg + bins + upd_ms)
    log(f"  where the kernel step's {timing['kernel']['ms']:.1f} ms go (each part "
        f"timed alone at the step's shapes, summed over its calls): K1 "
        f"{2 * L * 7 + 1} launches (forward + recompute) {k1:.1f} ms; dx = g·W^T "
        f"(W dequantized to bf16, bf16 cuBLAS) {dx:.1f}; x^T g (f32 cuBLAS, TF32 "
        f"off) {xg:.1f}; codebook masked sums {bins:.1f}; AdamW + probe + select "
        f"{upd_ms:.1f}; the rest (attention, norms, loss, embedding, autograd) "
        f"{rest:.1f} [{card}]")
    parts.update(k1_ms=k1, dx_ms=dx, xg_ms=xg, bins_ms=bins, update_ms=upd_ms,
                 rest_ms=rest)

    step = st.make_train_step(cfg, ocfg)
    res = run_loop(step, (params, opt_state),
                   lambda s: synthetic_batch(dcfg, s, device="cuda"), steps=3)
    losses = [res.losses[s] for s in range(3)]
    if res.n_skipped or not all(np.isfinite(losses)):
        raise AssertionError(f"run_loop: losses {losses}, skipped {res.n_skipped}")
    log(f"  run_loop, 3 steps on kernel: losses {[f'{v:.6f}' for v in losses]}")
    del res
    torch.cuda.empty_cache()

    poisoned = dict(batch, loss_scale=torch.tensor(float("nan"), device="cuda"))
    new_p, new_s, m = step(params, opt_state, poisoned)
    same = all(torch.equal(a.view(torch.uint8) if a.ndim else a,
                           b.view(torch.uint8) if b.ndim else b)
               for a, b in zip(tree_leaves((new_p, new_s)), tree_leaves((params, opt_state))))
    if int(m["skipped"]) != 1 or not same:
        raise AssertionError(f"poisoned step: skipped {int(m['skipped'])}, state "
                             f"bitwise unchanged {same}")
    log(f"  poisoned step (loss_scale NaN): skipped {int(m['skipped'])}, params and "
        f"optimizer state bitwise unchanged ({len(tree_leaves(params))} + "
        f"{len(tree_leaves(opt_state))} leaves)")
    del new_p, new_s, opt_state
    torch.cuda.empty_cache()
    return dict(timing, parts=parts)


def resume_check(card: str) -> dict:
    """Phase 9(c): the smoke config, weight-shared layers on K1, 6 steps with
    checkpoints every 2; again under the supervisor with a crash after step
    3's update: the resumed run equals the uninterrupted one bitwise."""
    import tempfile

    import torch

    from repro_torch import ft
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.models import transformer as TT
    from repro_torch.models.common import quantize_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    from repro_torch.train.faults import TrainFaultPlan, TrainFaultSpec
    from repro_torch.train.loop import run_loop
    from repro_torch.tree import tree_leaves

    cfg = get_config("qwen3-32b", smoke=True).with_quant(
        enabled=True, impl="kernel", min_weight_elems=1 << 10)
    steps = 6
    dcfg = DataConfig(seed=SEED, vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    step = st.make_train_step(cfg, opt.AdamWConfig(total_steps=steps, warmup_steps=5))

    def fresh():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        params = quantize_params(TT.init_params(cfg, gen), cfg)
        return params, opt.init_opt_state(params)

    def batches(s):
        return synthetic_batch(dcfg, s, device="cuda")

    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        pm.reset_launches()
        ref = run_loop(step, fresh(), batches, steps=steps,
                       mgr=ckpt.CheckpointManager(f"{d}/ref"), ckpt_every=2)
        torch.cuda.synchronize()
        k1 = pm.launches["pasm_matmul"]
        mgr = ckpt.CheckpointManager(f"{d}/run")
        plan = TrainFaultPlan([TrainFaultSpec("crash", step=3)])
        sup = ft.Supervisor(ft.RestartPolicy(max_restarts=2, backoff_s=0.0),
                            sleep=lambda _s: None)
        losses, box = {}, {}

        def loop(resume_step):
            state, start = fresh(), 0
            if ckpt.latest_step(mgr.dir) is not None:  # --resume auto
                if resume_step is not None:
                    state, man = ckpt.restore(mgr.dir, state, step=resume_step)
                else:
                    state, man = mgr.restore_latest(state)
                start = man["step"]
                box["resumed_at"] = start
            res = run_loop(step, state, batches, steps=steps, start_step=start,
                           mgr=mgr, ckpt_every=2, faults=plan, losses=losses)
            box["state"] = res.state
            return res.last_step

        last = sup.run(loop)
        saved = ckpt.complete_steps(mgr.dir)
    same = all(torch.equal(a.view(torch.uint8) if a.ndim else a,
                           b.view(torch.uint8) if b.ndim else b)
               for a, b in zip(tree_leaves(box["state"]), tree_leaves(ref.state)))
    same_losses = [losses[s] for s in range(steps)] == [ref.losses[s] for s in range(steps)]
    if last != steps or sup.restarts != 1 or not same or not same_losses or not k1:
        raise AssertionError(f"resume: last {last}, restarts {sup.restarts}, state "
                             f"bitwise equal {same}, losses equal {same_losses}, "
                             f"K1 launches {k1}")
    log(f"phase 9(c): {cfg.name} (layers and head weight-shared, {k1} K1 launches "
        f"in {steps} steps) crashed after step 3's update, restored from step "
        f"{box['resumed_at']} by the supervisor ({sup.restarts} restart; "
        f"checkpoints {saved}): losses and final params + optimizer state "
        f"bitwise equal to the uninterrupted run [{card}]")
    return {"k1": k1}


def qat_check(cfg, params, gen, card: str) -> dict:
    """Phase 9(d): the full-width AlexNet QAT-trained 2 steps at batch 8,
    frozen, and served on K1 and K2 within TOL of ``qat_forward``."""
    import torch

    from repro_torch.data.pipeline import DataConfig, synthetic_image_batch
    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.models import cnn
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st

    dcfg = DataConfig(seed=SEED, global_batch=QAT_BATCH)

    def batch(s):
        return synthetic_image_batch(dcfg, s, chw=cfg.in_chw, classes=cfg.classes,
                                     device="cuda")

    tree = {"params": params, "codebooks": cnn.qat_codebooks(params, cfg)}
    state = opt.init_opt_state(tree)
    step = st.make_cnn_train_step(cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=1))
    losses = []
    t0 = time.perf_counter()
    for s in range(2):
        tree, state, m = step(tree, state, batch(s))
        losses.append(float(m["loss"]))
        if int(m["skipped"]) or not np.isfinite(losses[-1]):
            raise AssertionError(f"QAT step {s}: {m}")
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    frozen = cnn.qat_requantize(tree["params"], tree["codebooks"], cfg)
    imgs = batch(2)["images"]
    with torch.no_grad():
        want = cnn.qat_forward(tree["params"], tree["codebooks"], imgs, cfg)
    counts, worst = {}, 0.0
    for impl in ("kernel", "kernel_implicit"):
        torch.cuda.synchronize()
        pm.reset_launches()
        with torch.no_grad():
            got = cnn.forward(frozen, imgs, dataclasses.replace(cfg, impl=impl))
        torch.cuda.synchronize()
        counts[impl] = counted()
        key = SERVED_KERNEL[impl]
        if counts[impl] != {k: len(cfg.layers) if k == key else 0 for k in ALL_KERNELS}:
            raise AssertionError(f"QAT frozen {impl}: launches {counts[impl]}")
        worst = max(worst, max_err(got, want))
    log(f"phase 9(d): {cfg.name} QAT, 2 steps at batch {QAT_BATCH} (losses "
        f"{[f'{v:.6f}' for v in losses]}, {t_steps:.2f} s host clock incl. first "
        f"calls), frozen by qat_requantize: logits on K1 and K2 vs qat_forward max "
        f"|Δ| {worst:.3e} (|logit| max {float(want.abs().max()):.3f}, tolerance "
        f"{TOL} + {TOL}·|want|), launches {counts} [{card}]")
    return {"k1": counts["kernel"]["pasm_matmul"],
            "k2": counts["kernel_implicit"]["pasm_conv"]}


def family_train(gen, card: str) -> dict:
    """Phase 9(e): mamba2-130m, recurrentgemma-2b and whisper-tiny at full
    width and full depth (16 bins int4, weights drawn and quantized on the
    card), one train step each at phase 9(b)'s batch: the loss and grads on
    ``kernel`` against ``dequant``, held within ``LM_GRAD_TOL`` or, where it
    is larger, the oracle's own one-ulp floor (``kernel`` with every
    embedding moved by up to one bf16 ulp, phase 11's measure: at full
    depth it exceeds ``LM_LOGIT_TOL`` in the forward); the step timed with
    its peak memory and its K1 launches counted."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st

    out = {"launches": 0, "routes": {"simt": 0, "stream": 0, "mma": 0}}
    for arch, full in FAMILY_TRAIN:
        cfg = get_config(arch).with_quant(enabled=True, bins=16, impl="kernel")
        params = build_lm(cfg, gen, "9(e)", full)
        batch = synthetic_batch(DataConfig(seed=SEED, vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                           global_batch=TRAIN_BATCH), 0, device="cuda")
        res = {}
        for impl, c in (("kernel", cfg), ("dequant", cfg.with_quant(impl="dequant"))):
            torch.cuda.synchronize()
            pm.reset_launches()
            r0 = dict(pm.k1_routes)
            t0 = time.perf_counter()
            loss, _, grads = st.loss_and_grads(params, batch, c)
            torch.cuda.synchronize()
            res[impl] = (float(loss), leaf_grads(grads), pm.launches["pasm_matmul"],
                         {k: pm.k1_routes[k] - r0[k] for k in r0},
                         time.perf_counter() - t0)
            del grads
        emb = params["embed"]
        params["embed"] = emb * (1 + 2.0 ** -8 * torch.randint(
            -1, 2, emb.shape, generator=gen, device="cuda", dtype=torch.int8).float())
        loss_m, _, grads = st.loss_and_grads(params, batch, cfg)
        moved = leaf_grads(grads)
        params["embed"] = emb
        del grads
        lk, gk = res["kernel"][0], res["kernel"][1]
        floor = max(rel_err(moved[k], gk[k]) for k in gk)
        loss_floor = abs(float(loss_m) - lk) / abs(lk)
        hold = max(LM_GRAD_TOL, floor)
        ld = res["dequant"][0]
        if not (np.isfinite(lk) and abs(lk - ld) <= max(LM_LOSS_TOL, loss_floor) * abs(ld)):
            raise AssertionError(f"{arch} train loss kernel {lk} vs dequant {ld}")
        worst = max(bwd_close(gk[k], gd, hold, f"{arch} train grad {k}")
                    for k, gd in res["dequant"][1].items())
        if not res["kernel"][2] or res["dequant"][2]:
            raise AssertionError(f"{arch}: K1 launches kernel {res['kernel'][2]}, "
                                 f"dequant {res['dequant'][2]}")
        out["launches"] += res["kernel"][2]
        for k, n in res["kernel"][3].items():
            out["routes"][k] += n
        step = st.make_train_step(cfg, opt.AdamWConfig())
        state = opt.init_opt_state(params)
        step(params, state, batch)  # warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new = step(params, state, batch)
        torch.cuda.synchronize()
        ms, peak = (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated()
        if int(new[2]["skipped"]) or not np.isfinite(float(new[2]["loss"])):
            raise AssertionError(f"{arch} train step: {new[2]}")
        out[arch] = {"ms": ms, "peak_gb": peak / 1e9, "grad_err": worst, "hold": hold}
        log(f"  {arch} (full depth, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}): fits, one "
            f"step {ms:.1f} ms host clock to a synchronize, peak memory {peak / 1e9:.2f} "
            f"GB (max_memory_allocated); kernel vs dequant: loss {lk:.6f} vs {ld:.6f}, "
            f"grads {worst:.2e} of max (held to {hold:.4f} = max(LM_GRAD_TOL, the one-ulp "
            f"floor {floor:.4f})); K1 launches {res['kernel'][2]} in loss_and_grads "
            f"(routes {res['kernel'][3]}), dequant's grads {res['dequant'][4]:.2f} s, "
            f"kernel's {res['kernel'][4]:.2f} s [{card}]")
        del params, state, new, step, res, moved
        torch.cuda.empty_cache()
    return out


def train_phase(cfg, params, qparams, lm: dict, gen, card: str) -> dict:
    """Phase 9; returns the K1/K2 launches of its main paths and its times."""
    import torch

    from repro_torch.train.step import deterministic

    errs = {"bwd_f32": 0.0, "bwd_bf16": 0.0, "lm_grad": 0.0}
    torch.cuda.empty_cache()
    with deterministic(), torch.enable_grad():
        log(f"phase 9(a): K1/K2 backwards vs autograd through the plain chain "
            f"(|Δ| <= {BWD_TOL['float32']}·max|plain| f32, "
            f"{BWD_TOL['bfloat16']:.4g}·max|plain| bf16)")
        conv_bwd_cases(cfg, params, qparams, gen, errs)
        lm_bwd_cases(lm, gen, errs)
        out = lm_train(lm, gen, card, errs)
        out["resume"] = resume_check(card)
        out["qat"] = qat_check(cfg, params, gen, card)
        log(f"phase 9(e): the recurrent and encoder-decoder families trained at full "
            f"width and full depth [{card}]")
        out["families"] = family_train(gen, card)
    log(f"phase 9: largest |Δ|/max: backwards f32 {errs['bwd_f32']:.3e}, bf16 "
        f"{errs['bwd_bf16']:.3e}; train grads kernel vs dequant {errs['lm_grad']:.3e}")
    return dict(out, errs=errs)


# ---------------------------------------------------------------------------
# phase 10: the MoE family and the vit prefix at full width
# ---------------------------------------------------------------------------


def k1_per_call(cfg) -> int:
    """K1 launches of one model call, from the code: each quantized linear
    once (4 attention, 2 or 3 FFN matrices, the untied head), and in a MoE
    layer the shared experts' matrices once and each routed expert's once
    per expert (``nn/moe.py::_expert_matmul``).  ``vproj`` dequantizes."""
    ffn = 3 if cfg.act == "swiglu" else 2
    m = cfg.moe if cfg.moe and cfg.moe.n_experts else None
    n_dense = min(m.first_dense_layers, cfg.n_layers) if m else cfg.n_layers
    moe_layer = 4 + (ffn if m.n_shared else 0) + m.n_experts * ffn if m else 0
    return (n_dense * (4 + ffn) + (cfg.n_layers - n_dense) * moe_layer
            + (0 if cfg.tie_embeddings else 1))


class MoeSpy:
    """Wraps ``nn.moe.moe_ffn`` while active: per call the token count, the
    capacity, the (token, expert) entries the capacity dropped (the first
    ``cap`` of each expert's entries in token order are kept) and the chosen
    experts, as device tensors read after the run.  With ``replay`` (another
    spy's calls) each call takes the recorded call's experts, so the same
    dispatch and the same kept entries, with its gates from its own router
    probabilities; where its own top-k differs (``flips``, token-layers),
    ``gap`` is the largest relative shortfall of an expert taken below its
    own k-th probability, 0 when every taken expert is one it chose."""

    def __init__(self, replay=None):
        self.calls, self.replay = [], replay

    def __enter__(self):
        from repro_torch.nn import moe as M

        self.mod, self.inner = M, M.moe_ffn
        M.moe_ffn = self
        return self

    def __exit__(self, *exc):
        self.mod.moe_ffn = self.inner

    def __call__(self, x, params, cfg, **kw):
        import torch

        M = self.mod
        G, cap = M.capacity(x.shape[0], cfg, dropless=kw.get("dropless", False),
                            n_groups=kw.get("n_groups", 1))
        probs, top_w, top_i = M.route(x, params["router"], cfg.top_k)
        call = {"T": x.shape[0], "cap": cap}
        if self.replay is not None:
            own, top_i = top_i, self.replay[len(self.calls)]["top_i"]
            taken = probs.gather(1, top_i)
            kth = probs.gather(1, own[:, -1:])  # route sorts descending
            top_w = taken / torch.clamp(taken.sum(-1, keepdim=True), min=1e-9)
            call["flips"] = (own.sort(-1).values != top_i.sort(-1).values).any(-1).sum()
            call["gap"] = ((kth - taken) / kth).clamp(min=0).max()
        counts = torch.stack([torch.bincount(g.reshape(-1), minlength=cfg.n_experts)
                              for g in top_i.reshape(G, -1, cfg.top_k)])
        self.calls.append(dict(call, top_i=top_i,
                               dropped=(counts - cap).clamp(min=0).sum()))
        if self.replay is None:
            return self.inner(x, params, cfg, **kw)
        route = M.route
        M.route = lambda *a: (probs, top_w, top_i)
        try:
            return self.inner(x, params, cfg, **kw)
        finally:
            M.route = route

    def dropped(self) -> list:
        """(T, cap, dropped entries) per call."""
        return [(c["T"], c["cap"], int(c["dropped"])) for c in self.calls]


K1_KERNEL_NAMES = ("k1b::", "pasm")  # K1's bf16 routes' namespace, its f32 kernel


def time_step(fn, reps: int = 3, traces: int = 3) -> dict:
    """One call of a whole model step, warm, medians over ``reps``: ``wall_ms``
    from an idle card to the step's end; ``host_ms`` until its last launch
    returns (the host's time, unless the launch queue filled); from one
    ``torch.profiler`` trace of the step, ``device_ms`` the sum of its
    kernels' device times (one stream: the card's busy time), ``k1_ms``
    K1's part of it and ``kernels`` their count.  A step launches more
    kernels than the queue holds, so no spin can cover its host time and
    CUDA events around it would time the host; the profiler reads each
    kernel's own interval.  A trace that holds no kernel (CUPTI at times
    hands back no device events) is taken again, up to ``traces`` times;
    ``device_ms`` is None if none of them holds one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    wall, host = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        host.append(t1 - t0)
    kern: list = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # the device timeline mirrors each record_function (the program's
        # spans among them) as a user annotation: no kernel runs in it
        kern = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        if kern:
            break
    dev = sum(t for _, t in kern) / 1e3
    k1 = sum(t for n, t in kern if any(k in n for k in K1_KERNEL_NAMES)) / 1e3
    by_name: dict = {}
    for n, t in kern:
        ms, count = by_name.get(n, (0.0, 0))
        by_name[n] = (ms + t / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"wall_ms": float(np.median(wall)) * 1e3, "host_ms": float(np.median(host)) * 1e3,
            "device_ms": dev if kern else None, "k1_ms": k1 if kern else None,
            "kernels": len(kern), "top": [(n[:70], ms, c) for n, (ms, c) in top]}


def fmt_step(t: dict) -> str:
    if t["device_ms"] is None:
        dev = "device not measured (the profiler saw no kernel)"
    else:
        dev = (f"device {t['device_ms']:.3f} ms in {t['kernels']} kernels (idle "
               f"{1 - t['device_ms'] / t['wall_ms']:.1%} of the wall time), K1 "
               f"{t['k1_ms']:.3f} ms ({t['k1_ms'] / t['device_ms']:.1%} of the device time)")
    return f"wall {t['wall_ms']:.3f} ms, host {t['host_ms']:.3f} ms, {dev}"


def k1_calls_of(fn) -> list:
    """The K1 wrapper calls one run of ``fn`` makes: (x, t, bias, relu)."""
    from repro_torch.kernels import ops

    calls, inner = [], ops.pasm_matmul

    def rec(x, t, *, bias=None, relu=False, **kw):
        calls.append((x, t, bias, relu))
        return inner(x, t, bias=bias, relu=relu, **kw)

    ops.pasm_matmul = rec
    try:
        fn()
    finally:
        ops.pasm_matmul = inner
    return calls


def k1_replay(calls):
    """A function that makes the recorded K1 calls again, back to back."""
    from repro_torch.kernels import ops

    def run():
        for x, t, bias, relu in calls:
            ops.pasm_matmul(x, t, bias=bias, relu=relu)
    return run


def moe_config():
    """deepseek-moe-16b at full width, 4 of its 28 layers, 16-bin int4 PASM."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=MOE_LAYERS) \
        .with_quant(enabled=True, bins=16, impl="kernel")


def build_lm(cfg, gen, phase: str, full_layers: int) -> dict:
    """Seeded weights drawn on the card and quantized there, logged."""
    import torch

    from repro_torch.models import api
    from repro_torch.models.common import param_count, quantize_params, weight_bytes

    t0 = time.perf_counter()
    dense = api.get_model(cfg).init_params(cfg, gen)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = quantize_params(dense, cfg, iters=QUANT_ITERS)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    del dense
    torch.cuda.empty_cache()
    wb = weight_bytes(params)
    log(f"phase {phase}: {cfg.name} full width (d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
        + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_expert "
           f"{cfg.moe.d_expert}, {cfg.moe.n_shared} shared (fused width "
           f"{cfg.moe.n_shared * cfg.moe.d_shared}), first {cfg.moe.first_dense_layers} "
           f"layer(s) dense" if cfg.moe else "")
        + (f", vit prefix {cfg.frontend_tokens} x {cfg.frontend_dim}" if
           cfg.frontend == "vit" else "")
        + (f", SSD d_inner {cfg.ssm.expand * cfg.d_model}, heads of {cfg.ssm.head_dim}, "
           f"d_state {cfg.ssm.d_state}, chunk {cfg.ssm.chunk}" if cfg.ssm else "")
        + (f", pattern {cfg.hybrid.pattern}, lru width {cfg.hybrid.lru_width}, local "
           f"window {cfg.hybrid.local_window}" if cfg.hybrid else "")
        + (f", {cfg.encoder_layers} encoder layers over {cfg.frontend_tokens} frames from "
           f"a {cfg.n_mels} x {2 * cfg.frontend_tokens} mel stem, {cfg.max_seq} decoder "
           f"positions" if cfg.encoder_layers else "")
        + (f"), {cfg.n_layers} of its {full_layers} layers (full depth), "
           if cfg.n_layers == full_layers else
           f"), reduced to {cfg.n_layers} of its {full_layers} layers, ")
        + f"{param_count(params) / 1e9:.3f} B params; weights drawn in {t_init:.2f} s, "
        f"quantized on the card in {t_quant:.2f} s ({cfg.quant.bins} bins, int4 packed"
        + (", each expert's matrices their own dictionaries" if cfg.moe else "")
        + f"); weight bytes dense bf16 "
        f"{wb['dense']} -> stored {wb['stored']} ({wb['ratio']:.2f}x)")
    return params


def held_k5(captured, name: str, errs: dict) -> int:
    """K5 through ops.flash_attention on recorded prefill attention
    operands ``(q, k, v, causal)``, counted, each held against
    gqa_attention and K5's plain version with its own causal flag; returns
    the launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import pasm_matmul as pm

    torch.cuda.synchronize()
    pm.reset_launches()
    for q, k, v, causal in captured:
        ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    counts = counted()
    if counts != {k: len(captured) if k == "flash_attention" else 0 for k in ALL_KERNELS}:
        raise AssertionError(f"K5 on {name}'s attention: launches {counts}")
    q, k = captured[0][:2]
    n_causal = sum(c[3] for c in captured)
    log(f"  K5 through ops.flash_attention on {name}'s prefill attention operands "
        f"({len(captured)} calls, {n_causal} causal; first B{q.shape[0]} Sq{q.shape[1]} "
        f"Sk{k.shape[1]} H{q.shape[2]}/{k.shape[2]} hd{q.shape[3]} {q.dtype}): "
        f"launches {counts}")
    for i, (q, k, v, causal) in enumerate(captured):
        log(f"    call {i} (Sq{q.shape[1]} Sk{k.shape[1]} causal={causal}): "
            + check_k5(q, k, v, causal, f"{name} call {i}", errs))
    return counts["flash_attention"]


class AttnSpy:
    """Records what a model hands ``gqa_attention`` while active: ``(q, k,
    v, causal)`` a call."""

    def __enter__(self):
        from repro_torch.nn import attention as A

        self.mod, self.inner, self.captured = A, A.gqa_attention, []

        def spy(q, k, v, **kw):
            self.captured.append((q, k, v, kw.get("causal", True)))
            return self.inner(q, k, v, **kw)

        A.gqa_attention = spy
        return self

    def __exit__(self, *exc):
        self.mod.gqa_attention = self.inner


class DecodeSpy:
    """Records what ``nn/attention.py`` hands K6's wrapper (``attend``) while
    active: ``(q, k, v, pos, window, offset, partial)`` a call, copied with
    their strides (the engine grafts into its caches in place), the first and
    the last ``keep`` calls of each distinct shape and setting."""

    def __init__(self, keep: int = 8):
        self.keep, self.first, self.last = keep, {}, {}

    def __enter__(self):
        from collections import deque

        import torch

        from repro_torch.kernels import decode_attention as K6

        self.mod, self.inner = K6, K6.attend

        def copy(t):
            return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                       device=t.device).copy_(t)

        def spy(q, k, v, pos, *, window=None, offset=0, partial=False):
            key = (tuple(q.shape), tuple(k.shape), k.stride(0), q.dtype, k.dtype, window,
                   offset, partial)
            ops = (*(copy(t) for t in (q, k, v, pos)), window, offset, partial)
            first = self.first.setdefault(key, [])
            if len(first) < self.keep:
                first.append(ops)
            else:
                self.last.setdefault(key, deque(maxlen=self.keep)).append(ops)
            return self.inner(q, k, v, pos, window=window, offset=offset, partial=partial)

        K6.attend = spy
        return self

    def __exit__(self, *exc):
        self.mod.attend = self.inner

    @property
    def captured(self) -> list:
        return [c for key, first in self.first.items()
                for c in first + list(self.last.get(key, ()))]


def held_k6(captured, name: str, say=log) -> int:
    """K6 on recorded decode-attention operands (``DecodeSpy``): each call
    launched twice, the two bitwise equal, the launches counted, and held to
    its plain version (``k6_close``); returns the calls held."""
    import torch

    from repro_torch.kernels import decode_attention as K6
    from repro_torch.kernels import pasm_matmul as pm

    if not captured:
        raise AssertionError(f"K6 on {name}: no decode attention call recorded")
    torch.cuda.synchronize()
    before, worst, seen = pm.launches["decode_attention"], 0.0, set()
    for i, (q, k, v, pos, window, offset, partial) in enumerate(captured):
        kw = dict(window=window, offset=offset, partial=partial)
        y = K6.decode_attention_kernel_call(q, k, v, pos, **kw)
        again = K6.decode_attention_kernel_call(q, k, v, pos, **kw)
        pair = zip(y, again) if partial else [(y, again)]
        if not all(torch.equal(a, b) for a, b in pair):
            raise AssertionError(f"K6 on {name} call {i}: a second launch differs bitwise")
        worst = max(worst, k6_close(y, q, k, v, pos, f"{name} call {i}", **kw))
        B, S, KV, hd = k.shape
        seen.add(f"B{B} S{S} G{q.shape[2] // KV} hd{hd} {str(k.dtype)[6:]}"
                 + (f" window {window}" if window is not None else "")
                 + (f" offset {offset} partial" if partial else ""))
    torch.cuda.synchronize()
    n = pm.launches["decode_attention"] - before
    if n != 2 * len(captured):
        raise AssertionError(f"K6 on {name}: {n} launches for {len(captured)} calls twice")
    say(f"  K6 on {name}'s decode attention operands ({len(captured)} calls of "
        f"{sorted(seen)}; pos {captured[0][3].tolist()} .. {captured[-1][3].tolist()}): "
        f"each launched twice, bitwise equal, {n} launches; vs plain max |Δ| {worst:.3e} "
        f"(f32: 1e-5 + 1e-5·|plain|; bf16: BF16_TOL·(|plain| + Σp|v|))")
    return len(captured)


class HeadSpy:
    """Records the ``(q heads, KV heads)`` of every ``gqa_attention`` call
    while active (shapes only, no tensors)."""

    def __enter__(self):
        from repro_torch.nn import attention as A

        self.mod, self.inner, self.seen = A, A.gqa_attention, set()

        def spy(q, k, v, **kw):
            self.seen.add((q.shape[2], k.shape[2]))
            return self.inner(q, k, v, **kw)

        A.gqa_attention = spy
        return self

    def __exit__(self, *exc):
        self.mod.gqa_attention = self.inner


def head_line(cfg, sctx, spy: HeadSpy, what: str) -> str:
    """A rank's block of the q heads (``models/common.py::head_block``,
    GSPMD's ``gcd(n_heads, model)`` blocks) and the heads its attention ran
    on; raises where they are not the block's."""
    import math

    from repro_torch.models.common import head_block

    hb = head_block(cfg, sctx)
    g = math.gcd(cfg.n_heads, sctx.tp)
    kv = sorted({h // (cfg.n_heads // cfg.n_kv_heads) for h in range(hb.q0, hb.q0 + hb.nq)})
    if hb.nq != cfg.n_heads // g or any(q != hb.nq for q, _ in spy.seen):
        raise AssertionError(f"{what}: attention on (q, KV) heads {sorted(spy.seen)}, "
                             f"not the block of {cfg.n_heads // g} q heads")
    return (f"q heads {hb.q0}-{hb.q0 + hb.nq - 1} of {cfg.n_heads} (block {hb.q0 // hb.nq} "
            f"of {hb.g} over model {sctx.tp}), reading KV heads {kv[0]}-{kv[-1]} of "
            f"{cfg.n_kv_heads}; attention on (q, KV) heads {sorted(spy.seen)}")


def moe_phase(gen, errs: dict, card: str) -> dict:
    """Phase 10(a): deepseek-moe-16b served at full width on K1."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.models import transformer as TT

    cfg = moe_config()
    params = build_lm(cfg, gen, "10(a)", 28)
    per_call = k1_per_call(cfg)
    if per_call != 605:
        raise AssertionError(f"K1 launches a model call: {per_call}, not 605")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in LM_PROMPTS]
    runs = {}
    for impl in ("kernel", "dequant"):
        with MoeSpy() as spy, DecodeSpy() as dec:
            eng, reqs, counts, wall, live_submits, routes = serve_lm(cfg, params, prompts,
                                                                     impl)
        held_k6(dec.captured, f"{cfg.name} {impl}")
        del dec
        roll = eng.metrics.rollup()
        calls = eng.calls["prefill"] + eng.calls["decode"]
        want = {k: per_call * calls if (impl == "kernel" and k == "pasm_matmul") else 0
                for k in ALL_KERNELS}
        pre = [d for d in spy.dropped() if d[0] > LM_SLOTS]
        log(f"  {impl:<8} {len(reqs)} requests, {eng.tick} ticks, model calls "
            f"{eng.calls}, launches {counts} ({per_call} a model call), K1 by route "
            f"{routes}, submits while slots were live {live_submits}, n_degraded "
            f"{roll.get('n_degraded', 0)}, {wall:.2f} s host clock incl. first calls, "
            f"{roll['tok_s']:.1f} tok/s; prefill MoE calls (T, cap, dropped entries): "
            f"{pre} ({card})")
        if counts != want or (impl == "kernel" and sum(routes.values()) != per_call * calls):
            raise AssertionError(f"MoE {impl}: expected launches {want}, got {counts}, "
                                 f"routes {routes}")
        if roll.get("n_degraded", 0) or not live_submits:
            raise AssertionError(f"MoE {impl}: degraded or no continuous admission: {roll}")
        if not all(r.done and len(r.out) == LM_NEW for r in reqs):
            raise AssertionError(f"MoE {impl}: a request was not served {LM_NEW} tokens")
        runs[impl] = (counts, [r.out for r in reqs], routes)
    ko, do = runs["kernel"][1], runs["dequant"][1]
    agree = float(np.mean([a == b for x, y in zip(ko, do) for a, b in zip(x, y)]))
    log(f"  greedy tokens agreeing, kernel vs dequant: {agree:.4f} of {len(ko) * LM_NEW}")

    # teacher-forced, in batches of the engine's slot count: a 4 x 384 bucket
    # has T > 512 tokens, so the dropless cap is 1.25x the balanced load
    with AttnSpy() as attn, MoeSpy() as spy_k:
        lk = teacher_forced_logits(cfg, params, prompts, ko, "kernel", batch=LM_SLOTS)
    lk2 = teacher_forced_logits(cfg, params, prompts, ko, "kernel", batch=LM_SLOTS)
    if not all(torch.equal(a, b) for a, b in zip(lk, lk2)):
        raise AssertionError("MoE logits: a second kernel run differs bitwise")
    pre = [d for d in spy_k.dropped() if d[0] > LM_SLOTS]
    log(f"  teacher-forced (batches of {LM_SLOTS}): a second kernel run bitwise equal "
        f"at all {len(lk)} steps; prefill MoE calls (T, cap, dropped entries): {pre}")
    # the oracle takes the kernel run's experts (so the same dispatch and
    # drops) with its own gates: every expert's product on dequant against
    # K1.  On its own activations it may rank two experts the other way;
    # each such choice must be a near-tie in its own probabilities
    with MoeSpy(replay=spy_k.calls) as spy_d:
        ld = teacher_forced_logits(cfg, params, prompts, ko, "dequant", batch=LM_SLOTS)
    flips = [int(c["flips"]) for c in spy_d.calls]
    gap = max(float(c["gap"]) for c in spy_d.calls)
    log(f"  dequant on its own activations ranks another expert set than the kernel "
        f"run took at {sum(flips)} of {sum(c['T'] for c in spy_d.calls)} token-layers "
        f"(prefill calls: {flips[:6]}); the expert taken lies at most {gap:.4e} of "
        f"dequant's k-th probability below it (tolerance {MOE_TIE})")
    if gap > MOE_TIE:
        raise AssertionError(f"MoE routing: a kernel-run expert {gap:.4e} below "
                             f"dequant's k-th probability, over {MOE_TIE}")
    worst, top = 0.0, 0.0
    for j, (a, b) in enumerate(zip(lk, ld)):
        top = max(top, float(b.abs().max()))
        worst = max(worst, check_close(a, b, 0.0, LM_LOGIT_TOL * float(b.abs().max()),
                                       what=f"MoE logits step {j}"))
    same = float(np.mean([bool((a.argmax(-1) == b.argmax(-1)).all()) for a, b in zip(lk, ld)]))
    log(f"  teacher-forced logits, kernel vs dequant on the kernel run's experts, "
        f"{len(lk)} steps x {len(prompts)} prompts: max |Δ| {worst:.4e} (|logit| max "
        f"{top:.3f}, tolerance {LM_LOGIT_TOL} of it); steps with every argmax equal "
        f"{same:.3f}")
    k5 = held_k5(attn.captured, cfg.name, errs)
    del attn, lk, lk2, ld, spy_k, spy_d

    # timings: one decode step (4 slots) and one 4 x 384 prefill, each impl
    rows = {}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (MOE_TIME_B, MOE_TIME_S))
                            .astype(np.int32)).cuda()
    for impl in ("kernel", "dequant"):
        c = cfg.with_quant(impl=impl)
        caches = TT.init_caches(c, MOE_TIME_B, LM_MAX_SEQ, device="cuda")
        pre_fn = lambda: TT.prefill(params, toks, caches, c)  # noqa: E731
        _, filled = pre_fn()
        nxt = toks[:, -1:]
        dec_fn = lambda: TT.decode_step(params, nxt, filled, c)  # noqa: E731
        for name, fn in (("decode", dec_fn), ("prefill", pre_fn)):
            row = rows[(impl, name)] = time_step(fn)
            extra = ""
            if impl == "kernel":
                k1 = k1_calls_of(fn)
                if len(k1) != per_call:
                    raise AssertionError(f"MoE {name}: {len(k1)} K1 calls, not {per_call}")
                rep = time_step(k1_replay(k1))
                row["k1_host_ms"] = rep["host_ms"]
                extra = (f"; its {per_call} K1 calls replayed alone: host "
                         f"{rep['host_ms']:.3f} ms ({rep['host_ms'] / per_call * 1e3:.1f} "
                         f"µs a call), wall {rep['wall_ms']:.3f} ms")
                del k1
            log(f"  {name:<7} step ({MOE_TIME_B} x {1 if name == 'decode' else MOE_TIME_S}"
                f" tokens) on {impl:<7}: {fmt_step(row)}{extra} [{card}]")
        del caches, filled
    # the engine's own prefill bucket: one 384-token prompt padded to 512,
    # cap = T = 512 rows an expert (JAX's dropless rule), ~91 % of them empty
    c = cfg
    one = torch.zeros((1, 512), dtype=torch.int32, device="cuda")
    one[0, :MOE_TIME_S] = toks[0]
    caches = TT.init_caches(c, 1, LM_MAX_SEQ, device="cuda")
    lengths = torch.tensor([MOE_TIME_S], dtype=torch.int32, device="cuda")
    fn = lambda: TT.prefill(params, one, caches, c, lengths=lengths)  # noqa: E731
    rows[("kernel", "bucket")] = time_step(fn)
    empty = 1 - 512 * cfg.moe.top_k / (cfg.moe.n_experts * 512)
    log(f"  engine prefill bucket (1 x 512, 384 real) on kernel: "
        f"{fmt_step(rows[('kernel', 'bucket')])}; each expert runs M = 512 rows, "
        f"{empty:.1%} of them empty by the routing's count [{card}]")
    del caches
    # K1 at the expert shapes: the rows an expert gets at decode, at the
    # timed prefill's cap, at the bucket's cap, and at its balanced load
    lp = params["layers"][0]["moe"]
    for name in ("w1", "w2"):
        t = lp[name].select(0).gemm_tensor()
        K, N = t.shape
        w = lp[name].select(0).dense_matrix(torch.bfloat16)
        for M in (4, 48, 180, 512):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            k_fn = lambda: ops.pasm_matmul(x, t)  # noqa: E731
            e, _ = check_k1_bf16(k_fn(), x, t, what=f"K1 expert {name} M{M}")
            errs["pasm_matmul"] = max(errs["pasm_matmul"], e)
            ms_c = time_cold_ms(k_fn)
            lib_c = time_cold_ms(lambda: torch.matmul(x, w))
            bound = k1_bound(t, M, 2)[0].ms
            log(f"    K1 expert {name} K{K} N{N} M{M:<4} route "
                f"{pm.k1_plan(M, K, N, x.dtype, packed=t.packed, groups=t.codebook.shape[0]).route:<6}"
                f": {ms_c:.4f} ms cold (bf16 matmul {lib_c:.4f}), bound {bound:.4f}")
    del params
    torch.cuda.empty_cache()
    return {"launches": runs["kernel"][0]["pasm_matmul"], "routes": runs["kernel"][2],
            "k5": k5, "times": rows}


def vlm_phase(gen, errs: dict, card: str) -> dict:
    """Phase 10(b): internvl2-26b at full width prefills its patch prefix."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.models import transformer as TT

    cfg = dataclasses.replace(get_config("internvl2-26b"), n_layers=VLM_LAYERS) \
        .with_quant(enabled=True, bins=16, impl="kernel")
    params = build_lm(cfg, gen, "10(b)", 48)
    if not hasattr(params["vproj"], "idx"):
        raise AssertionError("vproj is not weight-shared")
    per_call = k1_per_call(cfg)
    if per_call != 29:
        raise AssertionError(f"K1 launches a model call: {per_call}, not 29")
    rng = np.random.default_rng(SEED + 1)
    toks, lengths = padded([rng.integers(0, cfg.vocab, size=n) for n in VLM_PROMPTS])
    fe = torch.randn((len(VLM_PROMPTS), cfg.frontend_tokens, cfg.frontend_dim),
                     generator=gen, device="cuda").to(torch.bfloat16)
    P = cfg.frontend_tokens
    logits, routes, tokens = {}, {}, None
    for impl in ("kernel", "dequant"):
        c = cfg.with_quant(impl=impl)
        caches = TT.init_caches(c, len(VLM_PROMPTS), LM_MAX_SEQ, device="cuda")
        torch.cuda.synchronize()
        pm.reset_launches()
        with AttnSpy() as attn:
            out, caches = TT.prefill(params, toks, caches, c, lengths=lengths,
                                     frontend_embeds=fe)
        steps = [out.float()]
        pos = [x.pos.tolist() for x in caches["dense"] + caches["scan"]]
        want_pos = [[n + P for n in VLM_PROMPTS]] * cfg.n_layers
        if pos != want_pos:
            raise AssertionError(f"VLM {impl}: cache positions {pos}, not {want_pos}")
        if tokens is None:  # the kernel run's greedy tokens feed both runs
            tokens = [out.argmax(-1)]
        with DecodeSpy() as dec:
            for j in range(VLM_DECODE):
                if impl == "kernel" and j:
                    tokens.append(steps[-1].argmax(-1))
                out, caches = TT.decode_step(params, tokens[j].to(torch.int32), caches, c)
                steps.append(out.float())
        torch.cuda.synchronize()
        counts = counted()
        want = {k: per_call * (1 + VLM_DECODE) if (impl == "kernel" and k == "pasm_matmul")
                else 0 for k in ALL_KERNELS}
        log(f"  {impl:<8} prefill of {len(VLM_PROMPTS)} sequences ({P} patch tokens + "
            f"prompts {VLM_PROMPTS}, right-padded) + {VLM_DECODE} decode steps: cache "
            f"positions after the prefill {pos[0]}, launches {counts} ({per_call} a "
            f"model call), K1 by route {dict(pm.k1_routes)}")
        if counts != want:
            raise AssertionError(f"VLM {impl}: expected launches {want}, got {counts}")
        if not all(bool(torch.isfinite(s).all()) for s in steps):
            raise AssertionError(f"VLM {impl}: non-finite logits")
        logits[impl], routes[impl] = steps, dict(pm.k1_routes)
        held_k6(dec.captured, f"{cfg.name} {impl}")
        del dec
        if impl == "kernel":
            captured, launches = attn.captured, counts["pasm_matmul"]
    worst, top = 0.0, 0.0
    for j, (a, b) in enumerate(zip(logits["kernel"], logits["dequant"])):
        top = max(top, float(b.abs().max()))
        worst = max(worst, check_close(a, b, 0.0, LM_LOGIT_TOL * float(b.abs().max()),
                                       what=f"VLM logits step {j}"))
    log(f"  logits, kernel vs dequant, {len(logits['kernel'])} steps x "
        f"{len(VLM_PROMPTS)} sequences: max |Δ| {worst:.4e} (|logit| max {top:.3f}, "
        f"tolerance {LM_LOGIT_TOL} of it)")
    k5 = held_k5(captured, cfg.name, errs)
    del params, captured
    torch.cuda.empty_cache()
    return {"launches": launches, "routes": routes["kernel"], "k5": k5}


# ---------------------------------------------------------------------------
# phase 11: the recurrent families at full width and depth
# ---------------------------------------------------------------------------


def recurrent_per_call(cfg) -> tuple:
    """(K1 launches, gate dequantizations) of one model call, from the
    code: mamba2's ``in_proj`` and ``out_proj`` a layer; the hybrid's
    ``rec_in``, ``rec_out`` and the MLP's three a recurrent layer, whose
    ``w_a`` and ``w_x`` dequantize, and the four attention matrices and the
    MLP's three an attention layer; the head."""
    if cfg.family == "ssm":
        return 2 * cfg.n_layers + 1, 0
    pat = cfg.hybrid.pattern
    n_attn = sum(pat[i % len(pat)] == "attention" for i in range(cfg.n_layers))
    n_rec = cfg.n_layers - n_attn
    return 5 * n_rec + 7 * n_attn + 1, 2 * n_rec


class GateSpy:
    """Counts, while active, the ``dequant`` products of weight-shared
    matrices (under ``kernel``: the RG-LRU gates, ``nn/rglru.py::_gates``)."""

    def __enter__(self):
        from repro_torch.core import params as P
        from repro_torch.nn import layers as L

        self.mod, self.inner, self.n = L, L.linear, 0

        def spy(x, w, impl="dense", **kw):
            self.n += impl == "dequant" and P.is_quantized(w)
            return self.inner(x, w, impl, **kw)

        L.linear = spy
        return self

    def __exit__(self, *exc):
        self.mod.linear = self.inner


def teacher_forced_each(cfg, params, prompts, tokens, impl: str, max_seq: int) -> list:
    """Per prompt, alone at its exact length (these families take no
    right-padded prompt): the prefill's logits and those of the decode
    steps fed the given tokens (the kernel run's), as a list of (1, V) f32
    tensors a prompt."""
    import torch

    from repro_torch.models import api

    m, c = api.get_model(cfg), cfg.with_quant(impl=impl)
    out = []
    for p, toks in zip(prompts, tokens):
        caches = m.init_caches(c, 1, max_seq, device="cuda")
        logits, caches = m.prefill(params, torch.from_numpy(np.asarray(p, np.int32)[None])
                                   .cuda(), caches, c)
        steps = [logits[:, 0].float()]
        for t in toks[:LM_NEW - 1]:
            nxt = torch.tensor([[t]], dtype=torch.int32, device="cuda")
            logits, caches = m.decode_step(params, nxt, caches, c)
            steps.append(logits[:, 0].float())
        out.append(steps)
    torch.cuda.synchronize()
    return out


def recurrent_phase(arch: str, full_layers: int, gen, errs: dict, card: str) -> dict:
    """Phase 11(a) mamba2-130m / 11(b) recurrentgemma-2b at full width and
    depth: served on ``kernel`` and ``dequant`` with exact K1 launch counts,
    teacher-forced logits held, the ring wrap (hybrid), K5 on the hybrid's
    prefill operands, steps timed."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.models import api

    hybrid = arch == "recurrentgemma-2b"
    tag = "11(b)" if hybrid else "11(a)"
    cfg = get_config(arch).with_quant(enabled=True, bins=16, impl="kernel")
    model = api.get_model(cfg)
    params = build_lm(cfg, gen, tag, full_layers)
    per_call, gates = recurrent_per_call(cfg)
    want_k1, want_gates = (HYBRID_K1, HYBRID_GATES) if hybrid else (SSM_K1, 0)
    if (per_call, gates) != (want_k1, want_gates):
        raise AssertionError(f"{arch}: {per_call} K1 launches and {gates} gate "
                             f"dequantizations a model call, not {want_k1} / {want_gates}")
    rng = np.random.default_rng(SEED + 2)
    lens = REC_PROMPTS + ((RING_PROMPT,) if hybrid else ())
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in lens]
    max_seq = RING_MAX_SEQ if hybrid else LM_MAX_SEQ
    runs, failed = {}, []
    for impl in ("kernel", "dequant"):
        with GateSpy() as spy:
            eng, reqs, counts, wall, live_submits, routes = serve_lm(cfg, params, prompts,
                                                                     impl, max_seq)
        roll = eng.metrics.rollup()
        calls = eng.calls["prefill"] + eng.calls["decode"]
        want = {k: per_call * calls if (impl == "kernel" and k == "pasm_matmul") else 0
                for k in ALL_KERNELS}
        log(f"  {impl:<8} {len(reqs)} requests (prompts {lens}), {eng.tick} ticks, model "
            f"calls {eng.calls}, launches {counts} ({per_call} a model call), K1 by route "
            f"{routes}, gate dequantizations {spy.n} ({gates} a call on kernel), submits "
            f"while slots were live {live_submits}, {wall:.2f} s host clock incl. first "
            f"calls, {roll['tok_s']:.1f} tok/s ({card})")
        if counts != want or (impl == "kernel" and (
                sum(routes.values()) != per_call * calls or spy.n != gates * calls)):
            raise AssertionError(f"{arch} {impl}: expected launches {want} and "
                                 f"{gates * calls} gate dequantizations, got {counts}, "
                                 f"{spy.n}, routes {routes}")
        if roll.get("n_degraded", 0) or not live_submits:
            raise AssertionError(f"{arch} {impl}: degraded or no continuous admission")
        if not all(r.done and len(r.out) == LM_NEW for r in reqs):
            raise AssertionError(f"{arch} {impl}: a request was not served {LM_NEW} tokens")
        runs[impl] = (counts, [r.out for r in reqs], routes)
    ko, do = runs["kernel"][1], runs["dequant"][1]
    agree = float(np.mean([a == b for x, y in zip(ko, do) for a, b in zip(x, y)]))
    log(f"  {len(reqs)}/{len(prompts)} served on both; greedy tokens agreeing, kernel vs "
        f"dequant: {agree:.4f} of {len(ko) * LM_NEW}")

    # teacher-forced on the kernel run's tokens, each prompt alone; the
    # hybrid's K5 operands recorded at the ring prompt's prefill (S <= 2048:
    # the local window masks nothing there)
    with AttnSpy() as attn:
        lk = teacher_forced_each(cfg, params, prompts, ko, "kernel", max_seq)
    lk2 = teacher_forced_each(cfg, params, prompts, ko, "kernel", max_seq)
    if not all(torch.equal(a, b) for x, y in zip(lk, lk2) for a, b in zip(x, y)):
        raise AssertionError(f"{arch} logits: a second kernel run differs bitwise")
    log(f"  teacher-forced logits of a second kernel run: bitwise equal at all "
        f"{sum(map(len, lk))} prompt-steps")
    ld = teacher_forced_each(cfg, params, prompts, ko, "dequant", max_seq)
    # the oracle's own noise: dequant against itself with every embedding
    # moved by up to one bf16 ulp (2^-8 of itself, a seeded sign or 0)
    emb = params["embed"]
    params["embed"] = emb * (1 + 2.0 ** -8 * torch.randint(
        -1, 2, emb.shape, generator=gen, device="cuda", dtype=torch.int8).float())
    lp = teacher_forced_each(cfg, params, prompts, ko, "dequant", max_seq)
    params["embed"] = emb

    def rel(a, b):  # max |Δ| over a prompt's steps, over its max |logit|
        return max(float((x - y).abs().max()) for x, y in zip(a, b)) \
            / max(float(t.abs().max()) for t in b)

    dk = [rel(a, b) for a, b in zip(lk, ld)]
    floor = [rel(a, b) for a, b in zip(lp, ld)]
    top = max(float(t.abs().max()) for b in ld for t in b)
    log(f"  teacher-forced logits, {LM_NEW} steps x {len(prompts)} prompts, max |Δ| "
        f"over max |logit| ({top:.3f} at most): kernel vs dequant {max(dk):.4f} (per "
        f"prompt {[round(x, 4) for x in dk]}); the noise floor, dequant against itself "
        f"with the embeddings moved by up to one bf16 ulp, {max(floor):.4f} (per prompt "
        f"{[round(x, 4) for x in floor]}); held: kernel vs dequant <= the floor "
        f"(LM_LOGIT_TOL {LM_LOGIT_TOL} {'met' if max(dk) <= LM_LOGIT_TOL else 'not met'})")
    if max(dk) > max(floor):
        failed.append(f"kernel vs dequant logits {max(dk):.4f} of max |logit|, over the "
                      f"noise floor {max(floor):.4f}")
    k5 = 0
    if hybrid:
        # the ring prompt: decode past the 2048-slot ring vs forward at the
        # same positions (kernel), the error after the wrap against before
        i = lens.index(RING_PROMPT)
        seq = np.concatenate([prompts[i], np.asarray(ko[i][:LM_NEW - 1])]).astype(np.int32)
        full, _ = model.forward(params, torch.from_numpy(seq[None]).cuda(), cfg)
        pos = np.arange(RING_PROMPT - 1, RING_PROMPT - 1 + LM_NEW)
        errs_ring = [float((s[0] - full[0, p].float()).abs().max()) for s, p in zip(lk[i], pos)]
        top = float(full[0, pos].float().abs().max())
        del full
        win = cfg.hybrid.local_window
        pre = max(e for e, p in zip(errs_ring, pos) if p < win)
        post = max(e for e, p in zip(errs_ring, pos) if p >= win)
        log(f"  ring: the {RING_PROMPT}-token prompt decoded to position {pos[-1]} through "
            f"the {win}-slot ring, against forward at positions {pos[0]}..{pos[-1]}: max "
            f"|Δ| {pre:.4e} before the wrap, {post:.4e} after (|logit| max {top:.3f}; "
            f"after <= max(4 x before, {LM_LOGIT_TOL} of max))")
        if post > max(4 * pre, LM_LOGIT_TOL * top):
            failed.append(f"ring wrap: {post:.4e} after vs {pre:.4e} before")
        # K5 on the ring prompt's prefill attention operands (8 layers)
        cap = [c for c in attn.captured if c[0].shape[1] == RING_PROMPT]
        if len(cap) != 8:
            raise AssertionError(f"{len(cap)} attention calls at the ring prompt's prefill")
        k5 = held_k5(cap, cfg.name, errs)
    del attn, lk, lk2, ld, lp

    # timings: one decode step (4 slots) and one 4 x 384 prefill, each impl
    rows = {}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (MOE_TIME_B, MOE_TIME_S))
                            .astype(np.int32)).cuda()
    for impl in ("kernel", "dequant"):
        c = cfg.with_quant(impl=impl)
        caches = model.init_caches(c, MOE_TIME_B, LM_MAX_SEQ, device="cuda")
        pre_fn = lambda: model.prefill(params, toks, caches, c)  # noqa: E731
        _, filled = pre_fn()
        nxt = toks[:, -1:]
        dec_fn = lambda: model.decode_step(params, nxt, filled, c)  # noqa: E731
        for name, fn in (("decode", dec_fn), ("prefill", pre_fn)):
            row = rows[(impl, name)] = time_step(fn)
            extra = ""
            if impl == "kernel":
                k1 = k1_calls_of(fn)
                if len(k1) != per_call:
                    raise AssertionError(f"{arch} {name}: {len(k1)} K1 calls, not {per_call}")
                rep = time_step(k1_replay(k1))
                row["k1_host_ms"] = rep["host_ms"]
                extra = (f"; its {per_call} K1 calls replayed alone: host "
                         f"{rep['host_ms']:.3f} ms ({rep['host_ms'] / per_call * 1e3:.1f} "
                         f"µs a call), wall {rep['wall_ms']:.3f} ms")
                del k1
            log(f"  {name:<7} step ({MOE_TIME_B} x {1 if name == 'decode' else MOE_TIME_S}"
                f" tokens) on {impl:<7}: {fmt_step(row)}{extra} [{card}]")
            log("      the step's largest device times (ms, launches): " + "; ".join(
                f"{n} {ms:.3f} x{c}" for n, ms, c in row["top"]))
        del caches, filled
    # K1 at this family's shapes, warm and cold, beside torch.matmul
    shapes = ([("in_proj", params["layers"][0]["in_proj"]),
               ("out_proj", params["layers"][0]["out_proj"]),
               ("lm_head", params["lm_head"])] if not hybrid else
              [("rec_in", params["tail"][0]["rec_in"]),
               ("w2", params["tail"][0]["mlp"]["w2"]),
               ("wk", params["groups"][0]["l2"]["attn"]["wk"]),
               ("lm_head", params["lm_head"])])
    for name, leaf in shapes:
        t = leaf.gemm_tensor()
        K, N = t.shape
        wd = leaf.dense_matrix(torch.bfloat16)
        for M in (4, 384) if name != "lm_head" else (1, 4):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            k_fn = lambda: ops.pasm_matmul(x, t)  # noqa: E731
            l_fn = lambda: torch.matmul(x, wd)  # noqa: E731
            e, _ = check_k1_bf16(k_fn(), x, t, what=f"K1 {arch} {name} M{M}")
            errs["pasm_matmul"] = max(errs["pasm_matmul"], e)
            ms, host = time_ms_host(k_fn)
            ms_c, lib, lib_c = time_cold_ms(k_fn), time_ms(l_fn), time_cold_ms(l_fn)
            bd = k1_bound(t, M, 2)[0]
            route = pm.k1_plan(M, K, N, x.dtype, packed=t.packed,
                               groups=t.codebook.shape[0]).route
            log(f"    K1 {name} K{K} N{N} M{M:<4} route {route:<6}: {ms:.4f} ms warm / "
                f"{ms_c:.4f} cold (bf16 torch.matmul {lib:.4f} / {lib_c:.4f}), bound "
                f"{bd.ms:.4f} by {bd.by}, host {host:.1f} µs [{card}]")
            del x
        del wd
    del params
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{arch}: " + "; ".join(failed))
    return {"launches": runs["kernel"][0]["pasm_matmul"], "routes": runs["kernel"][2],
            "k5": k5, "times": rows}


# ---------------------------------------------------------------------------
# phase 12: the encoder-decoder family at full width and full depth
# ---------------------------------------------------------------------------


def whisper_per_call(cfg) -> tuple:
    """K1 launches of (a prefill call, a decode call), from the code: at
    prefill the two stem convs (f32, ``simt``), each encoder layer's four
    attention and two MLP matrices, and each decoder layer's four
    self-attention, four cross-attention (``wk``/``wv`` on the encoder's
    output) and two MLP matrices; at decode each decoder layer's four
    self-attention matrices, the cross ``wq`` and ``wo`` (the cross K/V are
    cached) and the MLP's two.  The tied head is a dense product."""
    return 2 + 6 * cfg.encoder_layers + 10 * cfg.n_layers, 8 * cfg.n_layers


def whisper_stem_check(cfg, params, gen, errs: dict) -> list:
    """Phase 12(c): the served stem's dictionaries at B = WHISPER_STEM_B on
    K1-K4 against their plain versions (``check_case``: K1 ≡ K2, K3 ≡ K4
    bitwise, rows ⊥ M) and through ``conv2d`` on the four kernel engines
    against ``einsum``; returns the two stem cases (conv2's image is
    conv1's GELU output)."""
    import torch

    from repro_torch.core import conv as cv
    from repro_torch.models import encdec as TE
    from repro_torch.nn import layers as L

    convs = TE._stem_convs(cfg)
    mel = torch.randn((WHISPER_STEM_B, cfg.n_mels, 2 * cfg.frontend_tokens),
                      generator=gen, device="cuda")
    img = mel[:, :, None, :]
    cases = []
    for name, conv in zip(("conv1", "conv2"), convs):
        p = params["frontend"][name]
        case = Case(f"whisper {name} {conv.c_in}x1x{img.shape[-1]} s{conv.stride}",
                    conv, 1, p, img.contiguous())
        check_case(case, errs)
        want = cv.conv2d(case.img, p, conv, engine="einsum")
        got = {e: cv.conv2d(case.img, p, conv, engine=e) for e in
               ("kernel", "kernel_implicit", "pas_kernel", "pas_kernel_implicit")}
        torch.cuda.synchronize()
        es = {e: max_err(y, want) for e, y in got.items()}
        same = (torch.equal(got["kernel"], got["kernel_implicit"]),
                torch.equal(got["pas_kernel"], got["pas_kernel_implicit"]))
        log(f"    conv2d engines vs einsum {tuple(want.shape)}: " + ", ".join(
            f"{e} {v:.2e}" for e, v in es.items()) + f"; kernel ≡ kernel_implicit "
            f"{same[0]}, pas_kernel ≡ pas_kernel_implicit {same[1]}")
        if not all(same):
            raise AssertionError(f"whisper {name}: an implicit engine differs bitwise")
        cases.append(case)
        img = L.gelu_ffn_act(want)
    return cases


def whisper_phase(gen, errs: dict, card: str) -> dict:
    """Phase 12: whisper-tiny at full width and full depth, served on
    ``kernel`` and ``dequant`` with exact K1 launch counts, a real mel
    through prefill and decode, the stem on K1-K4, K5 on the prefill's
    attention operands (non-causal included), steps and kernels timed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import conv as cv
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.models import encdec as TE

    cfg = get_config("whisper-tiny").with_quant(enabled=True, bins=16, impl="kernel")
    params = build_lm(cfg, gen, "12", cfg.n_layers)
    t0 = time.perf_counter()
    params = TE.quantize_frontend(params, bins=cfg.quant.bins)
    torch.cuda.synchronize()
    stem = params["frontend"]
    log(f"  mel stem weight-shared on the card in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{n} {p.kind} {p.bins} bins, kernel {p.kshape}" for n, p in stem.items()))
    per_pre, per_dec = whisper_per_call(cfg)
    if (per_pre, per_dec) != WHISPER_K1:
        raise AssertionError(f"whisper-tiny: {per_pre} / {per_dec} K1 launches a prefill / "
                             f"decode call, not {WHISPER_K1}")
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in LM_PROMPTS]
    failed, runs = [], {}

    # (a) the qwen3 traffic served: every request encodes silence
    for impl in ("kernel", "dequant"):
        with DecodeSpy() as dec:
            eng, reqs, counts, wall, live_submits, routes = serve_lm(cfg, params, prompts,
                                                                     impl)
        roll = eng.metrics.rollup()
        n_pre, n_dec = eng.calls["prefill"], eng.calls["decode"]
        on = impl == "kernel"
        want = {k: per_pre * n_pre + per_dec * n_dec if (on and k == "pasm_matmul") else 0
                for k in ALL_KERNELS}
        log(f"  {impl:<8} {len(reqs)} requests, {eng.tick} ticks, model calls {eng.calls}, "
            f"launches {counts} ({per_pre} a prefill call, {per_dec} a decode call), K1 "
            f"by route {routes}, submits while slots were live {live_submits}, "
            f"{wall:.2f} s host clock incl. first calls, {roll['tok_s']:.1f} tok/s ({card})")
        if counts != want or (on and routes["simt"] != 2 * n_pre):
            raise AssertionError(f"whisper-tiny {impl}: expected launches {want} "
                                 f"({2 * n_pre} simt), got {counts}, routes {routes}")
        if roll.get("n_degraded", 0) or not live_submits:
            raise AssertionError(f"whisper-tiny {impl}: degraded or no continuous admission")
        if not all(r.done and len(r.out) == LM_NEW for r in reqs):
            raise AssertionError(f"whisper-tiny {impl}: a request was not served "
                                 f"{LM_NEW} tokens")
        runs[impl] = (counts, [r.out for r in reqs], routes)
        held_k6(dec.captured, f"{cfg.name} {impl} (self and cross)")
        del dec
    ko, do = runs["kernel"][1], runs["dequant"][1]
    agree = float(np.mean([a == b for x, y in zip(ko, do) for a, b in zip(x, y)]))
    log(f"  greedy tokens agreeing, kernel vs dequant: {agree:.4f} of {len(ko) * LM_NEW}")

    # teacher-forced on the kernel run's tokens, each prompt alone; the
    # kernel run records each prefill's attention operands (12 calls a
    # prompt: 4 encoder, 4 decoder self, 4 cross)
    with AttnSpy() as attn:
        lk = teacher_forced_each(cfg, params, prompts, ko, "kernel", LM_MAX_SEQ)
    lk2 = teacher_forced_each(cfg, params, prompts, ko, "kernel", LM_MAX_SEQ)
    if not all(torch.equal(a, b) for x, y in zip(lk, lk2) for a, b in zip(x, y)):
        raise AssertionError("whisper-tiny logits: a second kernel run differs bitwise")
    ld = teacher_forced_each(cfg, params, prompts, ko, "dequant", LM_MAX_SEQ)
    emb = params["embed"]  # the oracle's one-ulp noise floor, as in phase 11
    params["embed"] = emb * (1 + 2.0 ** -8 * torch.randint(
        -1, 2, emb.shape, generator=gen, device="cuda", dtype=torch.int8).float())
    lp = teacher_forced_each(cfg, params, prompts, ko, "dequant", LM_MAX_SEQ)
    params["embed"] = emb

    def rel(a, b):  # max |Δ| over a prompt's steps, over its max |logit|
        return max(float((x - y).abs().max()) for x, y in zip(a, b)) \
            / max(float(t.abs().max()) for t in b)

    dk = [rel(a, b) for a, b in zip(lk, ld)]
    floor = [rel(a, b) for a, b in zip(lp, ld)]
    hold = max(LM_LOGIT_TOL, max(floor))
    log(f"  teacher-forced logits, {LM_NEW} steps x {len(prompts)} prompts (a second "
        f"kernel run bitwise equal): kernel vs dequant {max(dk):.4f} of max |logit| (per "
        f"prompt {[round(x, 4) for x in dk]}); the noise floor (dequant with the "
        f"embeddings moved by up to one bf16 ulp) {max(floor):.4f}; held to "
        f"{hold:.4f} = max(LM_LOGIT_TOL {LM_LOGIT_TOL}, the floor)")
    if max(dk) > hold:
        failed.append(f"kernel vs dequant logits {max(dk):.4f} of max |logit|, over {hold:.4f}")
    per_prompt = len(attn.captured) // len(prompts)
    if len(attn.captured) != 12 * len(prompts) or per_prompt != 3 * cfg.n_layers:
        raise AssertionError(f"{len(attn.captured)} prefill attention calls recorded")
    i = LM_PROMPTS.index(max(LM_PROMPTS))
    cap = attn.captured[i * per_prompt:(i + 1) * per_prompt]
    del attn, lk, lk2, ld, lp

    # (b) a seeded random mel: one right-padded prefill of 2 prompts and
    # WHISPER_DECODE steps, the kernel run's greedy tokens feeding both
    mel = torch.randn((WHISPER_MEL_B, cfg.n_mels, 2 * cfg.frontend_tokens),
                      generator=gen, device="cuda").to(torch.bfloat16)
    toks, lengths = padded([rng.integers(0, cfg.vocab, size=n) for n in WHISPER_PROMPTS])
    logits, tokens, b_launches, b_routes = {}, None, 0, {}
    for impl in ("kernel", "dequant"):
        c = cfg.with_quant(impl=impl)
        caches = TE.init_caches(c, WHISPER_MEL_B, LM_MAX_SEQ, device="cuda")
        torch.cuda.synchronize()
        pm.reset_launches()
        with AttnSpy() as attn:
            out, caches = TE.prefill(params, toks, caches, c, lengths=lengths,
                                     frontend_embeds=mel)
        steps = [out.float()]
        if tokens is None:
            tokens = [out.argmax(-1)]
        for j in range(WHISPER_DECODE):
            if impl == "kernel" and j:
                tokens.append(steps[-1].argmax(-1))
            out, caches = TE.decode_step(params, tokens[j].to(torch.int32), caches, c)
            steps.append(out.float())
        torch.cuda.synchronize()
        counts = counted()
        want = {k: per_pre + per_dec * WHISPER_DECODE if (impl == "kernel" and
                                                           k == "pasm_matmul") else 0
                for k in ALL_KERNELS}
        pos = [x["self"].pos.tolist() for x in caches]
        log(f"  {impl:<8} a seeded mel {tuple(mel.shape)}, prompts {WHISPER_PROMPTS} "
            f"right-padded, + {WHISPER_DECODE} decode steps: positions {pos[0]}, launches "
            f"{counts}, K1 by route {dict(pm.k1_routes)}")
        if counts != want or pos != [[n + WHISPER_DECODE for n in WHISPER_PROMPTS]] * cfg.n_layers:
            raise AssertionError(f"whisper-tiny mel {impl}: launches {counts} (want {want}), "
                                 f"positions {pos}")
        if not all(bool(torch.isfinite(s).all()) for s in steps):
            raise AssertionError(f"whisper-tiny mel {impl}: non-finite logits")
        logits[impl] = steps
        if impl == "kernel":
            cap += attn.captured
            b_launches, b_routes = counts["pasm_matmul"], dict(pm.k1_routes)
    rb = max(float((a - b).abs().max()) for a, b in zip(logits["kernel"], logits["dequant"])) \
        / max(float(b.abs().max()) for b in logits["dequant"])
    log(f"  mel logits, kernel vs dequant, {len(logits['kernel'])} steps x "
        f"{WHISPER_MEL_B}: {rb:.4f} of max |logit| (held to {hold:.4f})")
    if rb > hold:
        failed.append(f"mel logits {rb:.4f} of max |logit|, over {hold:.4f}")
    del logits, caches

    # (c) the stem alone on K1-K4; (d) K5 on (a)'s and (b)'s prefill operands
    log(f"  the stem at batch {WHISPER_STEM_B} on K1-K4 (|Δ| <= {TOL} + {TOL}·|plain|):")
    stem_cases = whisper_stem_check(cfg, params, gen, errs)
    k5 = held_k5(cap, cfg.name, errs)
    del cap

    # (e) timings: a 4-slot decode step and a 4 x 384 prefill on each impl
    rows = {}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (MOE_TIME_B, MOE_TIME_S))
                            .astype(np.int32)).cuda()
    for impl in ("kernel", "dequant"):
        c = cfg.with_quant(impl=impl)
        caches = TE.init_caches(c, MOE_TIME_B, LM_MAX_SEQ, device="cuda")
        pre_fn = lambda: TE.prefill(params, toks, caches, c)  # noqa: E731
        _, filled = pre_fn()
        nxt = toks[:, -1:]
        dec_fn = lambda: TE.decode_step(params, nxt, filled, c)  # noqa: E731
        for name, fn, per_call in (("decode", dec_fn, per_dec), ("prefill", pre_fn, per_pre)):
            row = rows[(impl, name)] = time_step(fn)
            extra = ""
            if impl == "kernel":
                k1 = k1_calls_of(fn)
                if len(k1) != per_call:
                    raise AssertionError(f"whisper-tiny {name}: {len(k1)} K1 calls, "
                                         f"not {per_call}")
                rep = time_step(k1_replay(k1))
                row["k1_host_ms"] = rep["host_ms"]
                extra = (f"; its {per_call} K1 calls replayed alone: host "
                         f"{rep['host_ms']:.3f} ms ({rep['host_ms'] / per_call * 1e3:.1f} "
                         f"µs a call), wall {rep['wall_ms']:.3f} ms")
                del k1
            log(f"  {name:<7} step ({MOE_TIME_B} x {1 if name == 'decode' else MOE_TIME_S}"
                f" tokens{'' if name == 'decode' else ', four 1500-frame encodes'}) on "
                f"{impl:<7}: {fmt_step(row)}{extra} [{card}]")
            log("      the step's largest device times (ms, launches): " + "; ".join(
                f"{n} {ms:.3f} x{c_}" for n, ms, c_ in row["top"]))
        del caches, filled

    # K1 at the stem (f32, simt) beside torch.matmul and F.conv2d (TF32 off)
    log(f"  K1 at whisper's shapes: warm / cold ms (L2 flushed), library warm / cold, "
        f"bound [{card}]")
    for case in stem_cases:
        t = case.params.gemm_tensor(case.conv.layout)
        x = case.patches()
        M, K = x.shape
        N = t.shape[1]
        w = case.params.dense_operand(case.conv.layout)
        kern4 = case.params.codebook[case.params.idx.long()]
        _, lo, hi = cv._axis_geometry(case.img.shape[-1], case.conv.kx, case.conv.stride,
                                      case.conv.padding)  # SAME: 0 / 1 at stride 2
        img = F.pad(case.img, (lo, hi))
        bias = case.params.bias
        k_fn = lambda: ops.pasm_matmul(x, t, bias=bias)  # noqa: E731
        l_fn = lambda: torch.matmul(x, w)  # noqa: E731
        c_fn = lambda: F.conv2d(img, kern4, bias, stride=case.conv.stride)  # noqa: E731
        e = max_err(k_fn(), pm.pasm_matmul_plain(x, t.idx, t.codebook, bias,
                                                 packed=t.packed))
        errs["pasm_matmul"] = max(errs["pasm_matmul"], e)
        ms, host = time_ms_host(k_fn)
        ms_c, lib, lib_c, conv_ms = time_cold_ms(k_fn), time_ms(l_fn), time_cold_ms(l_fn), \
            time_ms(c_fn)
        bd = k1_bound(t, M, 4)[0]
        plan = pm.simt_plan(M, K, N, 1)
        log(f"    K1 {case.name} M{M} K{K} N{N} f32, route simt (tile {plan.tile}x"
            f"{plan.cols}, splits {plan.splits}, {plan.blocks} blocks): {ms:.4f} / "
            f"{ms_c:.4f} ms (torch.matmul {lib:.4f} / {lib_c:.4f}, F.conv2d {conv_ms:.4f}), "
            f"bound {bd.ms:.4f} by {bd.by}, host {host:.1f} µs, "
            f"max |Δ| vs plain {e:.2e}")
        del x, w, img
    lp0, dp0 = params["enc_layers"][0], params["dec_layers"][0]
    for name, leaf in (("wq", lp0["attn"]["wq"]), ("w1", lp0["mlp"]["w1"]),
                       ("w2", lp0["mlp"]["w2"]), ("cross wk", dp0["cross"]["wk"])):
        t = leaf.gemm_tensor()
        K, N = t.shape
        wd = leaf.dense_matrix(torch.bfloat16)
        for M in (4, cfg.frontend_tokens):
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            k_fn = lambda: ops.pasm_matmul(x, t)  # noqa: E731
            l_fn = lambda: torch.matmul(x, wd)  # noqa: E731
            e, _ = check_k1_bf16(k_fn(), x, t, what=f"K1 whisper {name} M{M}")
            errs["pasm_matmul"] = max(errs["pasm_matmul"], e)
            ms, host = time_ms_host(k_fn)
            ms_c, lib, lib_c = time_cold_ms(k_fn), time_ms(l_fn), time_cold_ms(l_fn)
            bd = k1_bound(t, M, 2)[0]
            route = pm.k1_plan(M, K, N, x.dtype, packed=t.packed,
                               groups=t.codebook.shape[0]).route
            log(f"    K1 {name:<8} K{K} N{N} M{M:<4} bf16, route {route:<6}: {ms:.4f} / "
                f"{ms_c:.4f} ms (bf16 torch.matmul {lib:.4f} / {lib_c:.4f}), bound "
                f"{bd.ms:.4f} by {bd.by}, host {host:.1f} µs")
            del x
        del wd

    # K5 bf16 at the encoder's attention: B 1, S 1500, 6/6 heads, hd 64
    S, H, hd = cfg.frontend_tokens, cfg.n_heads, cfg.hd
    q, k, v = (torch.randn((1, S, H, hd), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    qg, kg, vg = regroup(q, k, v)
    qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    k_fn = lambda: fa.flash_attention_kernel_call(qg, kg, vg, causal=False)  # noqa: E731
    p_fn = lambda: fa.flash_attention_plain(qg, kg, vg, causal=False)  # noqa: E731
    l_fn = lambda: F.scaled_dot_product_attention(qh, kh, vh)  # noqa: E731
    e = check_close(k_fn(), p_fn(), K5_TOL["bfloat16"],
                    K5_TOL["bfloat16"] * k5_pv_scale(qg, kg, vg, False), what="K5 whisper")
    errs["flash_attention"] = max(errs["flash_attention"], e)
    ms, plain_ms, lib_ms = time_ms(k_fn), time_ms(p_fn), time_ms(l_fn)
    flops = 4 * H * S * S * hd  # QKᵀ and PV over every (query, key) pair
    bd = k5_bound(1, S, H, H, hd, torch.bfloat16, causal=False)
    log(f"  K5 B1 S{S} H{H}/{H} hd{hd} non-causal bf16: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f}, library (SDPA) {lib_ms:.4f}, bound {bd.ms:.4f} by {bd.by}, "
        f"{flops / ms / 1e9:.1f} TFLOP/s, max |Δ| vs plain {e:.2e} [{card}]")
    del params, q, k, v, qg, kg, vg, qh, kh, vh
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("whisper-tiny: " + "; ".join(failed))
    routes = {r: n + b_routes.get(r, 0) for r, n in runs["kernel"][2].items()}
    return {"launches": runs["kernel"][0]["pasm_matmul"] + b_launches, "routes": routes,
            "k5": k5, "times": rows}


# ---------------------------------------------------------------------------
# phase 13: the sharded CNN at full width
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def cnn_forward(params, images, cfg, engine: str, mesh=None):
    """``cnn.forward`` on ``engine`` (``pas_kernel_implicit``, K4, is not a
    ``CNNConfig`` impl: it runs through the forward's own stack)."""
    from repro_torch.models import cnn

    if engine == "pas_kernel_implicit":
        return cnn._stack(params, images, cfg, engine, cfg.pool_impl, mesh)
    return cnn.forward(params, images, dataclasses.replace(cfg, impl=engine),
                       mesh=mesh)


def stage_outputs(params, images, cfg, engine: str) -> list:
    """The five conv stages' outputs on one device (each stage's input is
    the previous one's output)."""
    from repro_torch.core import conv as cv
    from repro_torch.models import cnn

    outs, h = [], images
    for p, (conv, pool) in zip(params["conv"], cnn.stages(cfg)):
        h = cv.conv2d(h, p, conv, engine=engine, pool=pool, pool_impl=cfg.pool_impl)
        outs.append(h)
    return outs


def tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def same_or_close(got, want) -> tuple:
    """(bitwise, max |Δ|); raises past ``TOL + TOL·|want|``."""
    import torch

    if torch.equal(got, want):
        return True, 0.0
    return False, max_err(got, want)


def record_plans():
    """Wrap K1/K2's and K3/K4's plan functions to record each launch's
    ``(K, local N, split count)``; returns (the list, a restore callable)."""
    from repro_torch.kernels import pas_histogram as ph
    from repro_torch.kernels import pasm_matmul as pm

    rec, simt, pas = [], pm.simt_plan, ph.pas_plan

    def rec_simt(M, K, N, pool=1, *, whole=None):
        p = simt(M, K, N, pool, whole=whole)
        rec.append((K, N, p.splits))
        return p

    def rec_pas(M, K, N, B, pool=1, *, whole=None):
        p = pas(M, K, N, B, pool, whole=whole)
        rec.append((K, N, p.splits))
        return p

    pm.simt_plan, ph.pas_plan = rec_simt, rec_pas

    def restore():
        pm.simt_plan, ph.pas_plan = simt, pas

    return rec, restore


def shard_rank(rank: int, world: int, port: int, data_dir: str) -> None:
    """One rank of phase 13(b): gloo on the card every rank shares, the
    five stages on K1–K4 and the forward on each mesh, each held to the
    single-device results of 13(a) in ``data_dir/ref.pt``; a JSON report
    (or the traceback) to ``data_dir/rank<r>.json``."""
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    report = {"lines": [], "launches": dict.fromkeys(KERNELS, 0), "ok": False}
    out = Path(data_dir) / f"rank{rank}.json"
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=SHARD_COLLECTIVE_TIMEOUT_S))
    try:
        shard_rank_checks(rank, torch.load(Path(data_dir) / "ref.pt",
                                           map_location="cuda:0", weights_only=False),
                          report)
        report["ok"] = True
    except Exception:  # reported by the parent, which fails the run
        report["error"] = traceback.format_exc()
        raise
    finally:
        out.write_text(json.dumps(report))
        dist.destroy_process_group()


def gloo_on_cuda(rank: int) -> str:
    """Which collectives gloo takes on CUDA tensors on this machine's torch
    (the mesh's ``all_gather`` is the one the sharded path needs)."""
    import torch
    import torch.distributed as dist

    t = torch.full((2,), float(rank + 1), device="cuda")
    world = dist.get_world_size()
    calls = {
        "all_gather": lambda: dist.all_gather([torch.empty_like(t)
                                               for _ in range(world)], t),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(2 * world, device="cuda"), t),
        "broadcast": lambda: dist.broadcast(t.clone(), 0),
        "all_reduce": lambda: dist.all_reduce(t.clone()),
    }
    took, refused = [], []
    for name, call in calls.items():
        try:
            call()
            took.append(name)
        except (RuntimeError, ValueError) as e:
            refused.append(f"{name} ({type(e).__name__})")
    torch.cuda.synchronize()
    return f"takes {took}, refuses {refused or 'none'}"


def shard_rank_checks(rank: int, ref: dict, report: dict) -> None:
    import torch

    from repro_torch.configs import alexnet_conv
    from repro_torch.core import conv as cv
    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.launch.mesh import make_conv_mesh
    from repro_torch.models import cnn
    from repro_torch.tree import flatten_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    cfg = alexnet_conv.config()
    full = tree_bytes(ref["qparams"])
    say = report["lines"].append
    say(f"rank {rank}: gloo on CUDA tensors (torch {torch.__version__}) "
        f"{gloo_on_cuda(rank)}")
    for shape, batch in SHARD_RUNS:
        mesh = make_conv_mesh(shape, device="cuda")
        qpm = cnn.quantize(ref["params"], cfg, mesh=mesh)
        placed = cnn._place(ref["qparams"], mesh)
        for (pa, la), (_, lb) in zip(flatten_with_path(qpm), flatten_with_path(placed)):
            if not torch.equal(la, lb):
                raise AssertionError(f"{shape}: quantize(mesh=) differs at {pa}")
        mine = tree_bytes(qpm)
        idx = [tuple(p.idx.shape) for p in qpm["conv"]]
        say(f"rank {rank} mesh {shape} batch {batch}: weight bytes {mine} of {full} "
            f"({mine / full:.3f}), idx blocks {idx}, head {tuple(qpm['head']['w'].shape)}")
        imgs = ref[f"imgs{batch}"]
        for eng in SHARD_ENGINES:
            rec, restore = record_plans()
            try:
                h, parts = imgs, []
                for i, (p, (conv, pool)) in enumerate(zip(qpm["conv"], cnn.stages(cfg))):
                    rec.clear()
                    y = cv.conv2d(h, p, conv, engine=eng, mesh=mesh, pool=pool,
                                  pool_impl=cfg.pool_impl)
                    want = ref[f"stages{batch}"][eng][i]
                    torch.cuda.synchronize()
                    if not torch.equal(y, want):
                        raise AssertionError(
                            f"{shape} {eng} conv{i + 1}: not bitwise one device's "
                            f"(max |Δ| {float((y - want).abs().max()):.3e})")
                    (K, n, splits), = rec
                    one = ref[f"plans{batch}"][eng][i]
                    if splits != one:
                        raise AssertionError(f"{shape} {eng} conv{i + 1}: {splits} "
                                             f"splits, one device {one}")
                    parts.append(f"conv{i + 1} K{K} N{n}/{conv.c_out} {splits}")
                    h = want
            finally:
                restore()
            pm.reset_launches()
            got = cnn_forward(qpm, imgs, cfg, eng, mesh)
            torch.cuda.synchronize()
            counts = {k: pm.launches[k] for k in KERNELS}
            for k in KERNELS:
                report["launches"][k] += counts[k]
            bitwise, err = same_or_close(got, ref[f"logits{batch}"][eng])
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            cnn_forward(qpm, imgs, cfg, eng, mesh)
            start.record()
            for _ in range(SHARD_TIME_REPS):
                cnn_forward(qpm, imgs, cfg, eng, mesh)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / SHARD_TIME_REPS
            say(f"  rank {rank} {shape} B{batch} {eng:<19} stages bitwise one device's, "
                f"splits (one device's): {', '.join(parts)}; logits "
                f"{'bitwise' if bitwise else f'max |Δ| {err:.2e}'}; launches "
                f"{ {k: v for k, v in counts.items() if v} }; forward {ms:.3f} ms")


def shard_phase(cfg, params, qparams, gen, card: str) -> dict:
    """Phase 13: the full-width AlexNet through ``cnn.quantize(mesh=)`` and
    ``cnn.forward(mesh=)``: (a) world size 1 on NCCL, mesh (1, 1), every
    engine bitwise the unsharded forward, launches counted, both timed;
    (b) two ranks on gloo sharing the card, meshes (2, 1) and (1, 2) at
    batch 32 and (2, 1) at batch 6, each stage bitwise (a)'s on K1–K4 at
    (a)'s split-K counts, the logits bitwise or within ``TOL``."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.launch.mesh import make_conv_mesh
    from repro_torch.models import cnn
    from repro_torch.tree import flatten_with_path

    log(f"phase 13: the sharded CNN, {cfg.name} {cfg.in_chw} at full width")
    imgs = {b: torch.randn((b, *cfg.in_chw), generator=gen, device="cuda")
            for b in sorted({b for _, b in SHARD_RUNS} | {SHARD_BATCH})}
    launches = dict.fromkeys(KERNELS, 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_conv_mesh((1, 1), device="cuda")
        qpm = cnn.quantize(params, cfg, mesh=mesh)
        for (pa, la), (_, lb) in zip(flatten_with_path(qpm), flatten_with_path(qparams)):
            if not torch.equal(la, lb):
                raise AssertionError(f"quantize(mesh=(1, 1)) differs at {pa}")
        x = imgs[SHARD_BATCH]
        for eng in SHARD_ENGINES + ("einsum",):
            want = cnn_forward(qparams, x, cfg, eng)
            torch.cuda.synchronize()
            pm.reset_launches()
            got = cnn_forward(qpm, x, cfg, eng, mesh)
            torch.cuda.synchronize()
            counts = {k: pm.launches[k] for k in KERNELS}
            for k in KERNELS:
                launches[k] += counts[k]
            if not torch.equal(got, want):
                raise AssertionError(f"(1, 1) {eng}: logits not bitwise the unsharded")
            # in turns (one device, mesh, mesh, one device), each window short
            # enough that the spin covers its host time: the einsum forward
            # enqueues more than the card runs
            one = lambda: cnn_forward(qparams, x, cfg, eng)  # noqa: E731,B023
            shd = lambda: cnn_forward(qpm, x, cfg, eng, mesh)  # noqa: E731,B023
            t = [time_ms(f, SHARD_TIME_BUDGET_S) for f in (one, shd, shd, one)]
            ms1, msm = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            log(f"  (a) NCCL world 1, mesh (1, 1), B{SHARD_BATCH} {eng:<19} logits "
                f"bitwise the unsharded forward; launches "
                f"{ {k: v for k, v in counts.items() if v} }; forward {msm:.4f} ms "
                f"({t[1]:.4f}, {t[2]:.4f}), unsharded {ms1:.4f} ms ({t[0]:.4f}, "
                f"{t[3]:.4f}): {(msm / ms1 - 1) * 100:+.2f} % [{card}]")
    finally:
        dist.destroy_process_group()

    # the single-device results every rank of (b) is held to
    data = ROOT / "build" / "phase13"
    data.mkdir(parents=True, exist_ok=True)
    ref = {"params": params, "qparams": qparams}
    for b, x in imgs.items():
        ref[f"imgs{b}"] = x
        ref[f"stages{b}"], ref[f"plans{b}"] = {}, {}
        for eng in SHARD_ENGINES:
            rec, restore = record_plans()
            try:
                ref[f"stages{b}"][eng] = stage_outputs(qparams, x, cfg, eng)
            finally:
                restore()
            ref[f"plans{b}"][eng] = [splits for _, _, splits in rec]
        ref[f"logits{b}"] = {e: cnn_forward(qparams, x, cfg, e) for e in SHARD_ENGINES}
    torch.cuda.synchronize()
    torch.save(ref, data / "ref.pt")
    for f in data.glob("rank*.json"):
        f.unlink()

    world = 2
    log(f"  (b) {world} ranks on gloo sharing the card (spawned), meshes "
        f"{[s for s, _ in SHARD_RUNS]} at batches {[b for _, b in SHARD_RUNS]}")
    t0 = time.perf_counter()
    ctx = tmp.start_processes(shard_rank, args=(world, free_port(), str(data)),
                              nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SHARD_RANK_TIMEOUT_S
    failure = None
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                failure = f"a rank did not finish within {SHARD_RANK_TIMEOUT_S} s"
                break
    except Exception as e:  # a rank raised: its report holds the traceback
        failure = f"a rank failed: {type(e).__name__}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    reports = []
    for r in range(world):
        f = data / f"rank{r}.json"
        reports.append(json.loads(f.read_text()) if f.exists()
                       else {"ok": False, "lines": [], "error": "no report"})
    for r, rep in enumerate(reports):
        for line in rep["lines"]:
            log("  " + line)
        if not rep["ok"]:
            log(f"  rank {r} failed:\n{rep.get('error', '')}")
            failure = failure or f"rank {r} failed"
    if failure:
        raise AssertionError(f"phase 13(b): {failure}")
    for rep in reports:
        for k in KERNELS:
            launches[k] += rep["launches"][k]
    log(f"  (b) both ranks passed in {time.perf_counter() - t0:.1f} s; two ranks "
        f"share one card, so their times are no speedup [{card}]")
    del ref
    torch.cuda.empty_cache()
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 14: the sharded LM at full width
# ---------------------------------------------------------------------------


class RouteSpy:
    """Wraps ``nn.moe.route`` while active.  Alone it records each MoE
    call's chosen experts.  With ``replay`` (another spy's calls over the
    unsharded rows) each call takes the recorded experts of its own rows
    (block ``part`` of the rows, when the batch is split), so the same
    dispatch and the same drops, gated by its own probabilities (phase 10's
    rule); it records ``(flips, gap)``: the rows whose own top-k differs and
    the largest relative shortfall of a taken expert below its own k-th
    probability (0 with no flip)."""

    def __init__(self, replay=None, part=None):
        self.calls, self.replay, self.part = [], replay, part

    def __enter__(self):
        from repro_torch.nn import moe as M

        self.mod, self.inner = M, M.route
        M.route = self
        return self

    def __exit__(self, *exc):
        self.mod.route = self.inner

    def __call__(self, x, router, k):
        import torch

        probs, top_w, top_i = self.inner(x, router, k)
        if self.replay is None:
            self.calls.append(top_i)
            return probs, top_w, top_i
        n = x.shape[0]
        taken_i = self.replay[len(self.calls)]
        if self.part is not None:
            taken_i = taken_i[self.part * n:(self.part + 1) * n]
        kth = probs.gather(1, top_i[:, -1:])  # route sorts descending
        taken = probs.gather(1, taken_i)
        flips = (top_i.sort(-1).values != taken_i.sort(-1).values).any(-1).sum()
        self.calls.append((flips, ((kth - taken) / kth).clamp(min=0).max()))
        return probs, taken / torch.clamp(taken.sum(-1, keepdim=True), min=1e-9), taken_i


class BlockSpy:
    """Wraps ``params.block_matmul`` while active and keeps the operands of
    the first K1 call of each distinct block (the input's shape, the held
    indices and dictionaries, the leaf's logical shape, the axis and the
    planned rows), to hold each against K1's plain version after the run
    (:func:`check_blocks`).  It launches nothing itself."""

    def __init__(self):
        self.seen = {}

    def __enter__(self):
        from repro_torch.core import params as par

        self.mod, self.inner = par, par.block_matmul
        par.block_matmul = self
        return self

    def __exit__(self, *exc):
        self.mod.block_matmul = self.inner

    def __call__(self, x, w, **kw):
        p = self.mod.as_params(w)
        if kw["impl"] == "kernel" and self.mod.is_quantized(p):
            key = (tuple(x.shape), kw.get("axis", "model"), kw.get("rows"),
                   tuple(p.idx.shape), tuple(p.codebook.shape), p.packed, p.shape, p.pad_k)
            if key not in self.seen:
                self.seen[key] = (x.detach().clone(), w, kw)
        return self.inner(x, w, **kw)


def check_blocks(spy: BlockSpy, what: str) -> dict:
    """Each block ``spy`` kept, through ``params.block_matmul`` again (one
    K1 launch on the card, planned as on the main path), against K1's plain
    version on the same block and its own dictionaries, the operands the
    kernel was given (:func:`check_k1_bf16`'s tolerance).  These launches
    are checks, not the main path's."""
    from repro_torch.core import params as par
    from repro_torch.kernels import pasm_matmul as pm

    operands, inner = [], par._matmul_f32

    def keep(x, p, *args, **kw):
        operands.append((x, p))
        return inner(x, p, *args, **kw)

    n0, err, t_max = pm.launches["pasm_matmul"], 0.0, 0.0
    par._matmul_f32 = keep
    try:
        for x, w, kw in spy.seen.values():
            operands.clear()
            y, _ = par.block_matmul(x, w, **kw)
            (xb, pb), = operands
            t = pb.gemm_tensor()
            K, N = t.shape
            e, tm = check_k1_bf16(y.reshape(-1, N), xb.reshape(-1, K), t,
                                  what=f"{what} block x {tuple(x.shape)} of {pb.shape}")
            err, t_max = max(err, e), max(t_max, tm)
    finally:
        par._matmul_f32 = inner
    launched = pm.launches["pasm_matmul"] - n0
    if launched != len(spy.seen):
        raise AssertionError(f"{what}: {len(spy.seen)} block checks launched K1 "
                             f"{launched} times")
    return {"checks": len(spy.seen), "launches": launched, "max_abs_err": err,
            "t": t_max}


def lm_shard_inputs(cfg, gen) -> dict:
    """Phase 14's traffic: a B × S prefill and its decode steps' tokens
    (teacher-forced: every run feeds the same), and for the MoE config a
    prefill past the regime switch."""
    import torch

    B, S = LM_SHARD_BATCH, LM_SHARD_PROMPT
    tok = lambda *shape: torch.randint(0, cfg.vocab, shape, generator=gen,  # noqa: E731
                                       device="cuda", dtype=torch.int32)
    out = {"prefill": tok(B, S), "steps": [tok(B, 1) for _ in range(LM_SHARD_STEPS)]}
    if cfg.moe:
        out["big"] = tok(*MOE_SHARD_BIG)
    return out


def lm_shard_traffic(cfg, params, sctx, inputs) -> tuple:
    """The prefill and its decode steps (and the MoE config's big prefill)
    under ``sctx``: each call's logits, and its K1 launches by route,
    collective bytes and host wall ms (from an idle card to its end)."""
    import torch

    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as TT

    def caches(B, S):
        c = TT.init_caches(cfg, B, S, device="cuda")
        return sh.place_caches(cfg, c, sctx.mesh, sctx.batch) if sctx.active else c

    logits, calls = [], []

    def call(fn):
        torch.cuda.synchronize()
        pm.reset_launches()
        lmesh.reset_collective_bytes()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        calls.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "k1": dict(pm.k1_routes), "bytes": dict(lmesh.collective_bytes)})
        logits.append(out[0].float())
        return out[1]

    toks = inputs["prefill"]
    c = caches(toks.shape[0], toks.shape[1] + len(inputs["steps"]))
    c = call(lambda: TT.prefill(params, toks, c, cfg, sctx))
    for t in inputs["steps"]:
        c = call(lambda: TT.decode_step(params, t, c, cfg, sctx))  # noqa: B023
    if "big" in inputs:
        big = inputs["big"]
        call(lambda: TT.prefill(params, big, caches(*big.shape), cfg, sctx))
    return logits, calls


def k1_sharded_per_call(cfg, experts: int) -> int:
    """K1 launches of one model call on a rank holding ``experts`` routed
    experts a MoE layer: every linear once on its block (k1_per_call)."""
    m = cfg.moe
    return k1_per_call(dataclasses.replace(cfg, moe=dataclasses.replace(
        m, n_experts=experts))) if m else k1_per_call(cfg)


def k1_split_want(want: int, decode: bool) -> dict:
    """A call's K1 launches by route: every one on ``stream`` at decode; at
    prefill all on ``mma`` but the head's, which sees the last positions
    only (M = the batch)."""
    return {"simt": 0, "stream": want if decode else 1, "mma": 0 if decode else want - 1}


def rel_err(a, b, rows=None) -> float:
    """max |Δ| over max |b| (on the given batch rows)."""
    if rows is not None:
        a, b = a[rows], b[rows]
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) if len(b) else 0.0


def lm_shard_rank(rank: int, world: int, port: int, data_dir: str) -> None:
    """One rank of phase 14(b)/(c): gloo on the card every rank shares; each
    model's quantized tree from ``data_dir`` (memory-mapped: a rank copies
    out only its blocks), placed on each mesh, its traffic held to the
    one-device logits of (a); a JSON report (or the traceback) to
    ``data_dir/rank<r>.json``."""
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    report = {"lines": [], "k1": 0, "routes": {"stream": 0, "mma": 0, "simt": 0},
              "checks": 0, "check_launches": 0, "max_abs_err": 0.0, "ok": False}
    out = Path(data_dir) / f"rank{rank}.json"
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=SHARD_COLLECTIVE_TIMEOUT_S))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_grad_enabled(False)
        for key in ("qwen3", "deepseek"):
            lm_shard_rank_model(rank, key, Path(data_dir), report)
        report["ok"] = True
    except Exception:  # reported by the parent, which fails the run
        report["error"] = traceback.format_exc()
        raise
    finally:
        out.write_text(json.dumps(report))
        dist.destroy_process_group()


def lm_shard_rank_model(rank: int, key: str, data: Path, report: dict) -> None:
    import torch

    from repro_torch.launch.mesh import make_conv_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.common import ShardCtx
    from repro_torch.tree import flatten_with_path

    say = report["lines"].append
    cfg = lm_config() if key == "qwen3" else moe_config()
    tree = torch.load(data / f"{key}.pt", map_location="cpu", mmap=True, weights_only=False)
    ref = torch.load(data / f"{key}_ref.pt", map_location="cuda:0", weights_only=False)
    full = {"/".join(p): leaf for p, leaf in flatten_with_path(tree)}
    for shape in LM_SHARD_MESHES:
        mesh = make_conv_mesh(shape, device="cuda")
        B = LM_SHARD_BATCH
        sctx = ShardCtx.for_mesh(mesh, B)
        placed = sh.place_params(tree, mesh)
        frac, held, whole, ex_held, ex_whole = {}, 0, 0, 0, 0
        for p, leaf in flatten_with_path(placed):
            name = "/".join(p)
            g = full.get(name, full.get("/".join(p[:-1])))
            if p[-1] in ("idx", "w") and leaf.ndim >= 2:
                f = round(leaf.numel() / g.numel(), 4)
                frac[f] = frac.get(f, 0) + 1
            if p[-1] == "idx":
                held += leaf.numel()
                whole += g.numel()
                if "/moe/w" in "/" + name:
                    ex_held += leaf.numel()
                    ex_whole += g.numel()
        cb = sum(leaf.numel() * 4 for p, leaf in flatten_with_path(placed)
                 if p[-1] == "codebook")
        say(f"rank {rank} {cfg.name} mesh {shape}: idx bytes {held} of {whole} "
            f"({held / whole:.3f})"
            + (f", expert idx bytes {ex_held} of {ex_whole} ({ex_held / ex_whole:.3f})"
               if ex_whole else "")
            + f"; each matrix leaf's share {dict(sorted(frac.items()))} (leaves); "
            f"codebooks replicated, {cb} bytes a rank")
        torch.cuda.synchronize()
        # the MoE calls replay one device's experts (its run with this
        # mesh's dispatch groups): the same dispatch and drops
        rank_d = rank // shape[1]
        with RouteSpy(replay=ref["routes"][sctx.dp] if cfg.moe else None,
                      part=rank_d if sctx.batch_split else None) as spy, \
                BlockSpy() as blocks, DecodeSpy() as dec:
            logits, calls = lm_shard_traffic(cfg, placed, sctx, ref["inputs"])
        held_k6(dec.captured, f"rank {rank} {cfg.name} {shape}", say)
        del dec
        # K1 on every block shape this rank's run gave it, against the plain
        # version (its launches are checks: the main path's were counted)
        bc = check_blocks(blocks, f"rank {rank} {cfg.name} {shape}")
        report["checks"] += bc["checks"]
        report["check_launches"] += bc["launches"]
        report["max_abs_err"] = max(report["max_abs_err"], bc["max_abs_err"])
        say(f"  rank {rank} {shape}: K1 on its {bc['checks']} distinct blocks vs the plain "
            f"version on the same block and dictionaries ({bc['launches']} check "
            f"launches): max |Δ| {bc['max_abs_err']:.3e}, largest |Δ| / (|x|@|W|) "
            f"{bc['t']:.2e} <= K1_BF16_TOL")
        del placed, blocks
        torch.cuda.empty_cache()
        # launches: every linear once on its block (the rank's experts)
        experts = cfg.moe.n_experts // shape[1] if cfg.moe else 0
        want = k1_sharded_per_call(cfg, experts)
        for i, c in enumerate(calls):
            split = k1_split_want(want, 0 < i <= len(ref["inputs"]["steps"]))
            if c["k1"] != split:
                raise AssertionError(f"{shape} call {i}: K1 launches {c['k1']}, want "
                                     f"{split}")
            report["k1"] += want
            for r, n in c["k1"].items():
                report["routes"][r] += n
        flips = sum(int(f) for f, _ in spy.calls) if cfg.moe else 0
        gap = max((float(g) for _, g in spy.calls), default=0.0)
        if gap > MOE_TIE:
            raise AssertionError(f"{shape}: a replayed expert lies {gap:.4f} of its own "
                                 f"k-th probability below it (tolerance {MOE_TIE})")
        # held to (a)'s one-device logits on this rank's own rows (each rank
        # returns the same global logits)
        hold = ref["hold"]
        errs = []
        for i, (got, want_l) in enumerate(zip(logits, ref["logits"][sctx.dp])):
            nb = got.shape[0]
            rows = list(range(nb // shape[0] * rank_d, nb // shape[0] * (rank_d + 1))) \
                if sctx.batch_split else list(range(nb))
            if not torch.isfinite(got).all() or tuple(got.shape) != tuple(want_l.shape):
                raise AssertionError(f"{shape} call {i}: logits {tuple(got.shape)} not "
                                     "finite or not the shape of one device's")
            e = rel_err(got, want_l, rows)
            if e > hold:
                raise AssertionError(f"{shape} call {i}: logits {e:.4f} of max |logit| "
                                     f"from one device's, over {hold:.4f}")
            errs.append(0.0 if torch.equal(got[rows], want_l[rows]) else e)
        steps = calls[1:1 + len(ref["inputs"]["steps"])]
        say(f"  rank {rank} {shape}: logits of {len(logits)} calls vs (a)'s one device "
            f"(own rows): {sum(e == 0.0 for e in errs)} bitwise, max {max(errs):.4f} of "
            f"max |logit| (held to {hold:.4f})"
            + (f"; one device's experts replayed: its own top-k differs at {flips} "
               f"token-layers, each a near-tie (largest shortfall {gap:.4f} <= {MOE_TIE})"
               if cfg.moe else "")
            + f"; K1 {want} a call (stream at decode; mma at prefill, the head on stream)"
            f"; prefill {calls[0]['ms']:.1f} ms wall, decode step "
            f"{float(np.median([c['ms'] for c in steps])):.1f} ms median"
            + (f", big prefill {MOE_SHARD_BIG} {calls[-1]['ms']:.1f} ms" if cfg.moe else "")
            + f"; collective bytes a call: prefill {calls[0]['bytes']}, decode step "
            f"{steps[0]['bytes']}"
            + (f", big prefill {calls[-1]['bytes']}" if cfg.moe else ""))
    del tree


def lm_shard_phase(gen, errs: dict, card: str) -> dict:
    """Phase 14: qwen3-32b and deepseek-moe-16b at full width (4 layers)
    through ``prefill``/``decode_step`` under an active ``ShardCtx``: (a) on
    NCCL at world size 1, mesh (1, 1), qwen3's traffic bitwise the unsharded
    calls and timed against them; (b)/(c) two gloo ranks sharing the card,
    meshes (1, 2) and (2, 1), each rank's logits held to (a)'s one-device
    ones (within ``max(LM_LOGIT_TOL, the one-ulp floor)``; MoE rows a
    routing flip reached left out, each flip a near-tie)."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.launch.mesh import make_conv_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.common import ShardCtx

    t_phase = time.perf_counter()
    log(f"phase 14: the sharded LM at full width, a {LM_SHARD_BATCH} x "
        f"{LM_SHARD_PROMPT} prefill and {LM_SHARD_STEPS} decode steps (deepseek also "
        f"a {MOE_SHARD_BIG[0]} x {MOE_SHARD_BIG[1]} prefill, past the MoE regime switch)")
    data = ROOT / "build" / "phase14"
    data.mkdir(parents=True, exist_ok=True)
    for f in list(data.glob("*.pt")) + list(data.glob("rank*.json")):
        f.unlink()
    k1 = {"stream": 0, "mma": 0, "simt": 0}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        for key, cfg, full_layers in (("qwen3", lm_config(), 64),
                                      ("deepseek", moe_config(), 28)):
            params = build_lm(cfg, gen, "14", full_layers)
            inputs = lm_shard_inputs(cfg, gen)
            # one device with each mesh's dispatch groups (JAX's dp: 1 at
            # (1, 2), 2 at (2, 1)), so the same capacity and drops a group
            refs, routes = {}, {}
            for dp in sorted({s[0] for s in LM_SHARD_MESHES}):
                if dp > 1 and not cfg.moe:  # no dispatch groups: the same calls
                    refs[dp], routes[dp] = refs[1], routes[1]
                    continue
                with RouteSpy() as spy:
                    refs[dp], calls = lm_shard_traffic(cfg, params, ShardCtx(dp=dp), inputs)
                routes[dp] = spy.calls
            ref = refs[1]
            # the one-ulp floor: one device with the embeddings moved by up
            # to one bf16 ulp (phase 11's oracle noise), compared as the
            # ranks are: each mesh's dispatch groups, its experts replayed
            emb = params["embed"]
            params["embed"] = emb * (1 + 2.0 ** -8 * torch.randint(
                -1, 2, emb.shape, generator=gen, device="cuda", dtype=torch.int8).float())
            floors = {}
            for dp in refs:
                if dp > 1 and not cfg.moe:  # the same calls as dp 1
                    floors[dp] = floors[1]
                    continue
                with RouteSpy(replay=routes[dp] if cfg.moe else None):
                    moved, _ = lm_shard_traffic(cfg, params, ShardCtx(dp=dp), inputs)
                floors[dp] = max(rel_err(a, b) for a, b in zip(moved, refs[dp]))
            params["embed"] = emb
            hold = max(LM_LOGIT_TOL, *floors.values())
            shown = ", ".join(f"dp {d}: {v:.4f}" for d, v in floors.items())
            log(f"  (a) {cfg.name}: one device, K1 {calls[0]['k1']} at prefill, "
                f"{calls[1]['k1']} a decode step; the one-ulp floor of max |logit| "
                f"({shown}{'; experts replayed' if cfg.moe else ''}), ranks held to "
                f"{hold:.4f} = max(LM_LOGIT_TOL, the floor)")
            if key == "qwen3":
                mesh = make_conv_mesh((1, 1), device="cuda")
                sctx = ShardCtx.for_mesh(mesh, LM_SHARD_BATCH)
                placed = sh.place_params(params, mesh)
                got, mcalls = lm_shard_traffic(cfg, placed, sctx, inputs)
                want = k1_per_call(cfg)
                for i, (a, b, c) in enumerate(zip(got, ref, mcalls)):
                    split = k1_split_want(want, 0 < i <= LM_SHARD_STEPS)
                    if not torch.equal(a, b):
                        raise AssertionError(f"(1, 1) call {i}: logits not bitwise the "
                                             "unsharded call's")
                    if c["k1"] != split:
                        raise AssertionError(f"(1, 1) call {i}: K1 {c['k1']}, want {split}")
                    for r, n in c["k1"].items():
                        k1[r] += n
                # the dispatch's cost, phase 5's method: CUDA events behind
                # a spin, in turns (one device, mesh, mesh, one device)
                from repro_torch.models import transformer as TT

                c0 = TT.prefill(params, inputs["prefill"], TT.init_caches(
                    cfg, LM_SHARD_BATCH, LM_MAX_SEQ, device="cuda"), cfg)[1]
                cm = TT.prefill(placed, inputs["prefill"], sh.place_caches(
                    cfg, TT.init_caches(cfg, LM_SHARD_BATCH, LM_MAX_SEQ, device="cuda"),
                    mesh, sctx.batch), cfg, sctx)[1]
                t = inputs["steps"][0]
                one = lambda: TT.decode_step(params, t, c0, cfg)  # noqa: E731
                shd = lambda: TT.decode_step(placed, t, cm, cfg, sctx)  # noqa: E731
                # a decode step is host-bound: wall, host and the profiler's
                # device time, in turns
                td = [time_step(f) for f in (one, shd, shd, one)]
                pre1 = lambda: TT.prefill(params, inputs["prefill"], c0, cfg)  # noqa: E731
                prem = lambda: TT.prefill(placed, inputs["prefill"], cm, cfg, sctx)  # noqa: E731
                tp = [time_ms(f, SHARD_TIME_BUDGET_S) for f in (pre1, prem, prem, pre1)]

                def pair(key):
                    if any(t[key] is None for t in td):
                        return "not measured (the profiler saw no kernel)"
                    m, o = (td[1][key] + td[2][key]) / 2, (td[0][key] + td[3][key]) / 2
                    return f"{m:.3f} vs {o:.3f} ms ({(m / o - 1) * 100:+.2f} %)"

                log(f"  (a) NCCL world 1, mesh (1, 1): the prefill and {LM_SHARD_STEPS} decode "
                    f"steps bitwise the unsharded calls, K1 {want} a call ({mcalls[0]['k1']} "
                    f"at prefill, the head on stream; {mcalls[1]['k1']} a step); a decode "
                    f"step, mesh vs unsharded in turns: wall {pair('wall_ms')}, host "
                    f"{pair('host_ms')}, device {pair('device_ms')} in {td[1]['kernels']} / "
                    f"{td[0]['kernels']} kernels; the prefill (CUDA events behind a spin) "
                    f"{(tp[1] + tp[2]) / 2:.4f} vs {(tp[0] + tp[3]) / 2:.4f} ms "
                    f"({((tp[1] + tp[2]) / (tp[0] + tp[3]) - 1) * 100:+.2f} %) [{card}]")
                del placed, c0, cm
            torch.save(params, data / f"{key}.pt")
            torch.save({"inputs": inputs, "logits": refs, "hold": hold, "routes": routes},
                       data / f"{key}_ref.pt")
            del params, refs, ref, moved, routes
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    world = 2
    log(f"  (b)/(c) {world} ranks on gloo sharing the card (spawned), meshes "
        f"{list(LM_SHARD_MESHES)}; two ranks on one card time the dispatch and its "
        "collectives, not a speedup")
    t0 = time.perf_counter()
    ctx = tmp.start_processes(lm_shard_rank, args=(world, free_port(), str(data)),
                              nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SHARD_RANK_TIMEOUT_S
    failure = None
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                failure = f"a rank did not finish within {SHARD_RANK_TIMEOUT_S} s"
                break
    except Exception as e:  # a rank raised: its report holds the traceback
        failure = f"a rank failed: {type(e).__name__}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    reports = []
    for r in range(world):
        f = data / f"rank{r}.json"
        reports.append(json.loads(f.read_text()) if f.exists()
                       else {"ok": False, "lines": [], "error": "no report"})
    for r, rep in enumerate(reports):
        for line in rep["lines"]:
            log("  " + line)
        if not rep["ok"]:
            log(f"  rank {r} failed:\n{rep.get('error', '')}")
            failure = failure or f"rank {r} failed"
    if failure:
        raise AssertionError(f"phase 14: {failure}")
    checks = {"checks": 0, "launches": 0}
    for rep in reports:
        for r, n in rep["routes"].items():
            k1[r] += n
        checks["checks"] += rep["checks"]
        checks["launches"] += rep["check_launches"]
        errs["pasm_matmul"] = max(errs.get("pasm_matmul", 0.0), rep["max_abs_err"])
    for f in data.glob("*.pt"):
        f.unlink()
    log(f"  (b)/(c) both ranks passed in {time.perf_counter() - t0:.1f} s; phase 14 took "
        f"{time.perf_counter() - t_phase:.1f} s; K1 launches {k1} (the (1, 1) run and "
        f"both ranks), and {checks['launches']} more holding {checks['checks']} rank "
        f"blocks to the plain version [{card}]")
    return {"launches": sum(k1.values()), "routes": k1}


# ---------------------------------------------------------------------------
# phase 15: sharded training
# ---------------------------------------------------------------------------


def same_tree(a, b) -> bool:
    """Every leaf of two trees bitwise equal (compared where ``b`` lives)."""
    import torch

    from repro_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x.to(y.device), y)
        for x, y in zip(la, lb))


def qat_batch(cfg, batch: int, step: int = 0) -> dict:
    from repro_torch.data.pipeline import DataConfig, synthetic_image_batch

    return synthetic_image_batch(DataConfig(seed=SEED, global_batch=batch), step,
                                 chw=cfg.in_chw, classes=cfg.classes, device="cuda")


def supervised_run(step, fresh, batches, d: Path, *, mesh=None, specs=None) -> tuple:
    """``run_loop`` of ``TRAIN_SHARD_STEPS`` under ``ft.Supervisor`` with a
    crash after step ``TRAIN_SHARD_CRASH``'s update, checkpoints every 2,
    restored as ``--resume auto`` does: ``(last, losses, state, restarts)``."""
    from repro_torch import ft
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.train.faults import TrainFaultPlan, TrainFaultSpec
    from repro_torch.train.loop import run_loop

    mgr = ckpt.CheckpointManager(d, mesh=mesh, specs=specs)
    plan = TrainFaultPlan([TrainFaultSpec("crash", step=TRAIN_SHARD_CRASH)])
    sup = ft.Supervisor(ft.RestartPolicy(max_restarts=2, backoff_s=0.0),
                        sleep=lambda _s: None)
    losses, box = {}, {}

    def loop(resume_step):
        state, start = fresh(), 0
        if ckpt.latest_step(mgr.dir) is not None:
            state, man = mgr.restore_latest(state) if resume_step is None else \
                ckpt.restore(mgr.dir, state, step=resume_step, mesh=mesh, specs=specs)
            start = man["step"]
        res = run_loop(step, state, batches, steps=TRAIN_SHARD_STEPS, start_step=start,
                       mgr=mgr, ckpt_every=2, faults=plan, losses=losses)
        box["state"] = res.state
        return res.last_step

    last = sup.run(loop)
    return last, losses, box["state"], sup.restarts


def train_shard_rank(rank: int, world: int, port: int, data_dir: str) -> None:
    """One rank of phase 15(b): gloo on the card every rank shares, the
    AlexNet QAT step and the qwen3 train step on each mesh, held to (a)'s
    one-device results in ``data_dir``; a JSON report (or the traceback)
    to ``data_dir/rank<r>.json``."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_conv_mesh
    from repro_torch.train.step import deterministic

    report = {"lines": [], "k1": 0, "routes": {"stream": 0, "mma": 0, "simt": 0},
              "checks": 0, "check_launches": 0, "max_abs_err": 0.0, "ok": False}
    data = Path(data_dir)
    out = data / f"rank{rank}.json"
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=SHARD_COLLECTIVE_TIMEOUT_S))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with deterministic():
            for shape in TRAIN_SHARD_MESHES:
                mesh = make_conv_mesh(shape, device="cuda")
                train_shard_cnn(rank, mesh, data, report)
                torch.cuda.empty_cache()
                train_shard_lm(rank, mesh, data, report)
                torch.cuda.empty_cache()
        report["ok"] = True
    except Exception:  # reported by the parent, which fails the run
        report["error"] = traceback.format_exc()
        raise
    finally:
        out.write_text(json.dumps(report))
        dist.destroy_process_group()


def train_shard_cnn(rank: int, mesh, data: Path, report: dict) -> None:
    """The full-width AlexNet's QAT step on ``mesh``: loss and every
    gradient leaf against one device's, the step timed, a poisoned step and
    a crash-resume bitwise."""
    import torch

    from repro_torch.configs import alexnet_conv
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import cnn
    from repro_torch.models import sharding as sh
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    from repro_torch.train.loop import run_loop
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.tree import flatten_with_path

    say = report["lines"].append
    cfg = alexnet_conv.config()
    ref = torch.load(data / "cnn_ref.pt", map_location="cuda:0", weights_only=False)
    specs = cnn.qat_specs(cfg, mesh)
    placed = cnn._place(ref["tree"], mesh)
    batch = ref["batch"]
    torch.cuda.synchronize()
    lmesh.reset_collective_bytes()
    loss, grads = st.cnn_loss_and_grads(placed, batch, cfg, mesh=mesh)
    torch.cuda.synchronize()
    nbytes = dict(lmesh.collective_bytes)
    lerr = abs(float(loss) - float(ref["loss"])) / abs(float(ref["loss"]))
    if lerr > QAT_LOSS_TOL:
        raise AssertionError(f"AlexNet {mesh.shape}: loss {float(loss)} vs one device "
                             f"{float(ref['loss'])}")
    want = dict(flatten_with_path(ref["grads"]))
    got = dict(flatten_with_path(sh.gather_params(grads, mesh, specs)))
    if set(got) != set(want):
        raise AssertionError(f"AlexNet {mesh.shape}: grad leaves {set(got) ^ set(want)}")
    worst = max(bwd_close(got[k], want[k], QAT_GRAD_TOL, f"AlexNet {mesh.shape} grad "
                          f"{'/'.join(k)}") for k in want)
    del grads, got
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1)
    step = st.make_cnn_train_step(cfg, ocfg, mesh=mesh)
    state = (placed, opt.init_opt_state(placed))
    step(*state, batch)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new = step(*state, batch)
    torch.cuda.synchronize()
    ms, peak = (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated()
    if int(new[2]["skipped"]):
        raise AssertionError(f"AlexNet {mesh.shape}: a clean step skipped")
    poisoned = dict(batch, loss_scale=torch.tensor(float("nan"), device="cuda"))
    bad = step(*state, poisoned)
    if int(bad[2]["skipped"]) != 1 or not same_tree(bad[:2], state):
        raise AssertionError(f"AlexNet {mesh.shape}: poisoned step skipped "
                             f"{int(bad[2]['skipped'])}, state bitwise unchanged "
                             f"{same_tree(bad[:2], state)}")
    del new, bad, state
    # crash-resume at the QAT batch of phase 9(d), checkpoints gathered
    sspecs = cnn.qat_specs(cfg, mesh, with_opt=True)
    tag = "x".join(map(str, mesh.shape))

    def fresh():
        p = cnn._place(ref["tree"], mesh)
        return p, opt.init_opt_state(p)

    def batches(s):
        return qat_batch(cfg, QAT_BATCH, s)

    t0 = time.perf_counter()
    full = run_loop(step, fresh(), batches, steps=TRAIN_SHARD_STEPS,
                    mgr=ckpt.CheckpointManager(data / f"cnn{tag}_ref", mesh=mesh,
                                               specs=sspecs), ckpt_every=2)
    last, losses, state, restarts = supervised_run(step, fresh, batches,
                                                   data / f"cnn{tag}_run", mesh=mesh,
                                                   specs=sspecs)
    same_l = [losses[s] for s in range(TRAIN_SHARD_STEPS)] == \
        [full.losses[s] for s in range(TRAIN_SHARD_STEPS)]
    if last != TRAIN_SHARD_STEPS or restarts != 1 or not same_l or \
            not same_tree(state, full.state) or full.n_skipped:
        raise AssertionError(f"AlexNet {mesh.shape} crash-resume: last {last}, restarts "
                             f"{restarts}, losses equal {same_l}, state bitwise "
                             f"{same_tree(state, full.state)}")
    t_resume = time.perf_counter() - t0
    say(f"rank {rank} AlexNet QAT {mesh.shape} batch {QAT_SHARD_BATCH}: loss {float(loss):.6f} "
        f"({lerr:.1e} of one device's), grads {worst:.2e} of max (<= {QAT_GRAD_TOL}, "
        f"{len(want)} leaves, gathered); step {ms:.1f} ms wall, peak {peak / 1e9:.2f} GB; "
        f"collective bytes of loss and grads {nbytes}; a NaN loss_scale skipped with the "
        f"tree bitwise; crashed after step {TRAIN_SHARD_CRASH} of {TRAIN_SHARD_STEPS} at "
        f"batch {QAT_BATCH}: losses and final tree bitwise the uninterrupted run "
        f"({t_resume:.1f} s for both runs)")


def train_shard_lm(rank: int, mesh, data: Path, report: dict) -> None:
    """qwen3-32b's train step (4 layers, remat, K1) on ``mesh``: loss and
    every float leaf's gradient against one device's, K1 launches a step,
    each distinct block K1 ran held to the plain version, collective bytes,
    the step timed with its peak memory."""
    import torch

    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as TT
    from repro_torch.models.common import ShardCtx
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    from repro_torch.tree import flatten_with_path

    say = report["lines"].append
    cfg = lm_config()
    tree = torch.load(data / "qwen3.pt", map_location="cpu", mmap=True, weights_only=False)
    ref = torch.load(data / "qwen3_ref.pt", map_location="cuda:0", weights_only=False)
    placed = sh.place_params(tree, mesh)
    del tree
    sctx = ShardCtx.for_mesh(mesh, TRAIN_BATCH)
    batch = ref["batch"]
    with torch.no_grad():  # the forward's collectives alone
        lmesh.reset_collective_bytes()
        TT.forward(placed, batch["tokens"], cfg, sctx)
        torch.cuda.synchronize()
        fwd = dict(lmesh.collective_bytes)
    pm.reset_launches()
    r0 = dict(pm.k1_routes)
    lmesh.reset_collective_bytes()
    t0 = time.perf_counter()
    with BlockSpy() as blocks:
        loss, _, grads = st.loss_and_grads(placed, batch, cfg, sctx)
        torch.cuda.synchronize()
    t_grads = time.perf_counter() - t0
    both = dict(lmesh.collective_bytes)
    k1 = pm.launches["pasm_matmul"]
    routes = {k: pm.k1_routes[k] - r0[k] for k in r0}
    if k1 != TRAIN_K1 or routes != {"simt": 0, "stream": 0, "mma": TRAIN_K1}:
        raise AssertionError(f"qwen3 {mesh.shape}: K1 {k1} by route {routes}, want "
                             f"{TRAIN_K1} on mma")
    lerr = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
    if lerr > LM_LOSS_TOL:
        raise AssertionError(f"qwen3 {mesh.shape}: loss {float(loss)} vs one device "
                             f"{ref['loss']}")
    worst, seen = {}, 0
    for path, g in flatten_with_path(grads):
        name = "/".join(path)
        if name in ("embed", "embed/w"):  # this rank's vocab block: its rows, zero elsewhere
            n = g.shape[0]
            off = mesh.index("model") * n if n < cfg.vocab else 0
            rows = ref["embed_rows"]
            mine = (rows >= off) & (rows < off + n)
            # the batch's tokens may all lie in the other rank's vocab block
            e = bwd_close(g[rows[mine] - off], ref["embed"][mine], LM_GRAD_TOL,
                          f"qwen3 {mesh.shape} grad embed rows") if bool(mine.any()) else 0.0
            if int(g.abs().amax(-1).count_nonzero()) > int(mine.sum()):
                raise AssertionError(f"qwen3 {mesh.shape}: embed gradient off the batch's rows")
            worst["embed"] = max(worst.get("embed", 0.0), e)
            seen += 1
        elif name in ref["grads"]:
            kind = path[-1] if "norm" in path[-1] else "codebook"
            worst[kind] = max(worst.get(kind, 0.0), bwd_close(
                g, ref["grads"][name], LM_GRAD_TOL, f"qwen3 {mesh.shape} grad {name}"))
            seen += 1
    if seen != len(ref["grads"]) + 1:
        raise AssertionError(f"qwen3 {mesh.shape}: {seen} of {len(ref['grads']) + 1} "
                             "gradient leaves compared")
    del grads, loss
    torch.cuda.empty_cache()
    with torch.no_grad():  # K1 on every block this rank's step gave it: checks
        bc = check_blocks(blocks, f"rank {rank} qwen3 train {mesh.shape}")
    report["checks"] += bc["checks"]
    report["check_launches"] += bc["launches"]
    report["max_abs_err"] = max(report["max_abs_err"], bc["max_abs_err"])
    del blocks
    torch.cuda.empty_cache()
    step = st.make_train_step(cfg, opt.AdamWConfig(), sctx)
    state = opt.init_opt_state(placed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pm.reset_launches()
    t0 = time.perf_counter()
    with GradSpy() as spy:
        new = step(placed, state, batch)
        torch.cuda.synchronize()
    ms, peak = (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated()
    grads_peak = spy.peak
    del spy
    if int(new[2]["skipped"]) or not np.isfinite(float(new[2]["loss"])) or \
            pm.launches["pasm_matmul"] != TRAIN_K1:
        raise AssertionError(f"qwen3 {mesh.shape} step: {new[2]}, K1 "
                             f"{pm.launches['pasm_matmul']}")
    report["k1"] += 2 * TRAIN_K1
    report["routes"]["mma"] += 2 * TRAIN_K1
    say(f"rank {rank} qwen3 train {mesh.shape} batch {TRAIN_BATCH} x {TRAIN_SEQ}: loss "
        f"{lerr:.1e} of one device's; grads |Δ|/max by kind "
        f"{', '.join(f'{k} {v:.2e}' for k, v in sorted(worst.items()))} (<= "
        f"{LM_GRAD_TOL}); K1 {TRAIN_K1} a step, all mma; {bc['checks']} distinct blocks "
        f"vs the plain version: max |Δ| {bc['max_abs_err']:.3e}, |Δ|/(|x|@|W|) "
        f"{bc['t']:.2e}; collective bytes: a forward {fwd}, loss and grads (forward + "
        f"remat's recompute + backward + reduction) {both}; loss and grads {t_grads:.2f} s, "
        f"the step {ms:.1f} ms wall, peak {peak / 1e9:.2f} GB (max_memory_allocated) from "
        f"{base / 1e9:.2f} GB at its start (loss and grads {grads_peak / 1e9:.2f} GB)")
    del new, state, step, placed
    torch.cuda.empty_cache()


def train_shard_phase(cfg, params, gen, card: str) -> dict:
    """Phase 15: sharded training.  (a) NCCL at world size 1, mesh (1, 1):
    the full-width AlexNet QAT step at batch 32 and the qwen3-32b train
    step (4 layers, remat, K1) bitwise the unsharded steps; one device's
    loss and grads saved for (b).  (b) two gloo ranks sharing the card at
    (1, 2) and (2, 1): :func:`train_shard_cnn`, :func:`train_shard_lm`."""
    import shutil

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.launch.mesh import make_conv_mesh
    from repro_torch.models import cnn
    from repro_torch.models import sharding as sh
    from repro_torch.models.common import ShardCtx
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    from repro_torch.train.step import deterministic
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    log(f"phase 15: sharded training, the AlexNet QAT step (batch {QAT_SHARD_BATCH}) and "
        f"qwen3-32b's train step ({LM_LAYERS} layers, {TRAIN_BATCH} x {TRAIN_SEQ}, remat, "
        f"K1) over ('data', 'model') meshes, under deterministic algorithms")
    data = ROOT / "build" / "phase15"
    shutil.rmtree(data, ignore_errors=True)
    data.mkdir(parents=True)
    k1 = {"stream": 0, "mma": 0, "simt": 0}
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        with deterministic(), torch.enable_grad():
            mesh = make_conv_mesh((1, 1), device="cuda")
            # the AlexNet
            tree = {"params": params, "codebooks": cnn.qat_codebooks(params, cfg)}
            batch = qat_batch(cfg, QAT_SHARD_BATCH)
            ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1)
            a = st.make_cnn_train_step(cfg, ocfg)(tree, opt.init_opt_state(tree), batch)
            placed = cnn._place(tree, mesh)
            b = st.make_cnn_train_step(cfg, ocfg, mesh=mesh)(
                placed, opt.init_opt_state(placed), batch)
            if not (same_tree(a[:2], b[:2]) and torch.equal(a[2]["loss"], b[2]["loss"])):
                raise AssertionError("(1, 1) AlexNet QAT step: not bitwise the unsharded")
            loss, grads = st.cnn_loss_and_grads(tree, batch, cfg)
            torch.save({"tree": tree, "batch": batch, "loss": loss, "grads": grads},
                       data / "cnn_ref.pt")
            log(f"  (a) NCCL world 1, mesh (1, 1): the AlexNet QAT step (loss "
                f"{float(a[2]['loss']):.6f}) bitwise the unsharded step: params, "
                f"codebooks and optimizer state [{card}]")
            del a, b, placed, grads
            # qwen3
            lcfg = lm_config()
            lparams = build_lm(lcfg, gen, "15", 64)
            lbatch = synthetic_batch(DataConfig(seed=SEED, vocab=lcfg.vocab, seq_len=TRAIN_SEQ,
                                                global_batch=TRAIN_BATCH), 0, device="cuda")
            loss, _, grads = st.loss_and_grads(lparams, lbatch, lcfg)
            lg = leaf_grads(grads)
            e = lg.pop("embed")
            rows = e.abs().amax(-1).nonzero().flatten()
            torch.save({"batch": lbatch, "loss": float(loss), "grads": lg,
                        "embed_rows": rows, "embed": e[rows]}, data / "qwen3_ref.pt")
            del grads, lg, e
            torch.save(lparams, data / "qwen3.pt")
            ocfg = opt.AdamWConfig()
            a = st.make_train_step(lcfg, ocfg)(lparams, opt.init_opt_state(lparams), lbatch)
            a = (tree_map(lambda t: t.cpu(), a[:2]), a[2]["loss"].cpu())
            torch.cuda.empty_cache()
            placed = sh.place_params(lparams, mesh)
            del lparams
            sctx = ShardCtx.for_mesh(mesh, TRAIN_BATCH)
            torch.cuda.synchronize()
            pm.reset_launches()
            r0 = dict(pm.k1_routes)
            b = st.make_train_step(lcfg, ocfg, sctx)(placed, opt.init_opt_state(placed),
                                                      lbatch)
            torch.cuda.synchronize()
            n, routes = pm.launches["pasm_matmul"], {k: pm.k1_routes[k] - r0[k] for k in r0}
            if n != TRAIN_K1 or routes != {"simt": 0, "stream": 0, "mma": TRAIN_K1}:
                raise AssertionError(f"(1, 1) qwen3 step: K1 {n} by route {routes}")
            for r, c in routes.items():
                k1[r] += c
            if not (same_tree(b[:2], a[0]) and torch.equal(b[2]["loss"].cpu(), a[1])):
                raise AssertionError("(1, 1) qwen3 step: not bitwise the unsharded")
            log(f"  (a) NCCL world 1, mesh (1, 1): the qwen3 train step (loss "
                f"{float(a[1]):.6f}) bitwise the unsharded step (params, optimizer "
                f"state), K1 {n} launches, all mma [{card}]")
            del a, b, placed
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    world = 2
    free, total = torch.cuda.mem_get_info()
    log(f"  (b) {world} ranks on gloo sharing the card (spawned), meshes "
        f"{list(TRAIN_SHARD_MESHES)}, {free / 1e9:.1f} of {total / 1e9:.1f} GB free; two "
        "ranks on one card time the dispatch and its collectives, not a speedup")
    t0 = time.perf_counter()
    ctx = tmp.start_processes(train_shard_rank, args=(world, free_port(), str(data)),
                              nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TRAIN_SHARD_TIMEOUT_S
    failure = None
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                failure = f"a rank did not finish within {TRAIN_SHARD_TIMEOUT_S} s"
                break
    except Exception as e:  # a rank raised: its report holds the traceback
        failure = f"a rank failed: {type(e).__name__}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    reports = []
    for r in range(world):
        f = data / f"rank{r}.json"
        reports.append(json.loads(f.read_text()) if f.exists()
                       else {"ok": False, "lines": [], "error": "no report"})
    for r, rep in enumerate(reports):
        for line in rep["lines"]:
            log(f"  {line} [{card}]")
        if not rep["ok"]:
            log(f"  rank {r} failed:\n{rep.get('error', '')}")
            failure = failure or f"rank {r} failed"
    if failure:
        raise AssertionError(f"phase 15(b): {failure}")
    checks = {"checks": 0, "launches": 0, "max_abs_err": 0.0}
    for rep in reports:
        for r, n in rep["routes"].items():
            k1[r] += n
        checks["checks"] += rep["checks"]
        checks["launches"] += rep["check_launches"]
        checks["max_abs_err"] = max(checks["max_abs_err"], rep["max_abs_err"])
    shutil.rmtree(data, ignore_errors=True)
    log(f"  (b) both ranks passed in {time.perf_counter() - t0:.1f} s; phase 15 took "
        f"{time.perf_counter() - t_phase:.1f} s; K1 launches {k1} (the (1, 1) step and "
        f"both ranks' two steps a mesh), and {checks['launches']} more holding "
        f"{checks['checks']} rank blocks to the plain version (max |Δ| "
        f"{checks['max_abs_err']:.3e}) [{card}]")
    return {"launches": sum(k1.values()), "routes": k1, "max_abs_err": checks["max_abs_err"]}


# ---------------------------------------------------------------------------
# phase 16: TP for the recurrent and encdec families, the sequence-sharded cache
# ---------------------------------------------------------------------------


def rec_shard_config(arch: str, n_layers: int = 0):
    """A phase-16 model at full width, 16 bins int4 on ``kernel`` (depth cut
    to ``n_layers`` when given)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg.with_quant(enabled=True, bins=16, impl="kernel")


def rec_shard_k1(cfg) -> tuple:
    """K1 launches of (a prefill call, a decode call), from the code."""
    if cfg.family == "audio":
        return whisper_per_call(cfg)
    if cfg.family in ("ssm", "hybrid"):
        n = recurrent_per_call(cfg)[0]
        return n, n
    n = k1_per_call(cfg)
    return n, n


def rec_shard_inputs(cfg, gen) -> dict:
    """Phase 16's traffic: a B × S prefill (whisper's behind seeded mels of
    1500 frames) and its decode steps' tokens; the hybrid also its ring
    prompt and the steps that wrap the ring."""
    import torch

    tok = lambda *shape: torch.randint(0, cfg.vocab, shape, generator=gen,  # noqa: E731
                                       device="cuda", dtype=torch.int32)
    B, S = LM_SHARD_BATCH, LM_SHARD_PROMPT
    out = {"prefill": tok(B, S), "steps": [tok(B, 1) for _ in range(LM_SHARD_STEPS)]}
    if cfg.family == "audio":
        out["mel"] = torch.randn((B, cfg.n_mels, 2 * cfg.frontend_tokens), generator=gen,
                                 device="cuda")
    if cfg.family == "hybrid":
        out["ring"] = tok(1, RING_PROMPT)
        out["ring_steps"] = [tok(1, 1) for _ in range(RING_SHARD_STEPS)]
    return out


def rec_shard_traffic(cfg, params, sctx, inputs, ring: bool = True) -> tuple:
    """The prefill and its decode steps (and, with ``ring``, the hybrid's
    ring prompt and its steps) under ``sctx``: each call's logits, and its
    K1 launches, collective bytes and host wall ms (from an idle card to
    its end), and whether it was a decode step."""
    import torch

    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import api
    from repro_torch.models import sharding as sh

    model = api.get_model(cfg)
    logits, calls = [], []

    def caches(B, S):
        c = model.init_caches(cfg, B, S, device="cuda")
        return sh.place_caches(cfg, c, sctx.mesh, sctx.batch) if sctx.active else c

    def call(fn, decode: bool):
        torch.cuda.synchronize()
        pm.reset_launches()
        lmesh.reset_collective_bytes()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        calls.append({"ms": (time.perf_counter() - t0) * 1e3, "decode": decode,
                      "k1": pm.launches["pasm_matmul"], "routes": dict(pm.k1_routes),
                      "bytes": {k: v for k, v in lmesh.collective_bytes.items() if v}})
        logits.append(out[0].float())
        return out[1]

    kw = {"frontend_embeds": inputs["mel"]} if "mel" in inputs else {}
    runs = [(inputs["prefill"], inputs["steps"], LM_SHARD_PROMPT + LM_SHARD_STEPS)]
    if ring and "ring" in inputs:
        runs.append((inputs["ring"], inputs["ring_steps"], RING_MAX_SEQ))
    for toks, steps, max_seq in runs:
        c = caches(toks.shape[0], max_seq)
        c = call(lambda: model.prefill(params, toks, c, cfg, sctx, **kw), False)  # noqa: B023
        for t in steps:
            c = call(lambda: model.decode_step(params, t, c, cfg, sctx), True)  # noqa: B023
    return logits, calls


def rec_shard_build(arch: str, full_layers: int, n_layers: int, gen) -> tuple:
    """A phase-16 model's config and quantized weights, drawn on the card
    (whisper's stem weight-shared too)."""
    from repro_torch.models import encdec as TE

    cfg = rec_shard_config(arch, n_layers)
    params = build_lm(cfg, gen, "16", full_layers)
    if cfg.family == "audio":
        params = TE.quantize_frontend(params, bins=cfg.quant.bins)
    return cfg, params


def rec_shard_refs(cfg, params, inputs, gen) -> tuple:
    """One device's logits and calls on the traffic, and its one-ulp floor:
    the same calls with the embeddings moved by up to one bf16 ulp (phase
    11's oracle noise), max |Δ| over max |logit| of each call.  The calls
    returned (launches, wall ms) are the second, warm run's."""
    import torch

    from repro_torch.models.common import ShardCtx

    ref, _ = rec_shard_traffic(cfg, params, ShardCtx(), inputs)
    emb = params["embed"]
    params["embed"] = emb * (1 + 2.0 ** -8 * torch.randint(
        -1, 2, emb.shape, generator=gen, device="cuda", dtype=torch.int8).float())
    moved, calls = rec_shard_traffic(cfg, params, ShardCtx(), inputs)
    params["embed"] = emb
    return ref, calls, max(rel_err(a, b) for a, b in zip(moved, ref))


def rec_shard_k1_check(cfg, calls, what: str) -> None:
    """Every call launched K1 once a linear (on its block)."""
    pre, dec = rec_shard_k1(cfg)
    for i, c in enumerate(calls):
        want = dec if c["decode"] else pre
        if c["k1"] != want:
            raise AssertionError(f"{what} call {i}: K1 launched {c['k1']} times, want {want}")


def rec_shard_rank(rank: int, world: int, port: int, data_dir: str, keys: list) -> None:
    """One rank of phase 16(b)/(c): gloo on the card every rank shares; each
    model's quantized tree from ``data_dir`` (memory-mapped: a rank copies
    out only its blocks), placed on each mesh, its traffic held to one
    device's logits; a JSON report (or the traceback) to
    ``data_dir/rank<r>.json``."""
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    report = {"lines": [], "routes": {"stream": 0, "mma": 0, "simt": 0}, "checks": 0,
              "check_launches": 0, "max_abs_err": 0.0, "ok": False}
    out = Path(data_dir) / f"rank{rank}.json"
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=SHARD_COLLECTIVE_TIMEOUT_S))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_grad_enabled(False)
        for key in keys:
            rec_shard_rank_model(rank, key, Path(data_dir), report)
        report["ok"] = True
    except Exception:  # reported by the parent, which fails the run
        report["error"] = traceback.format_exc()
        raise
    finally:
        out.write_text(json.dumps(report))
        dist.destroy_process_group()


def rec_shard_rank_model(rank: int, key: str, data: Path, report: dict) -> None:
    import torch

    from repro_torch.launch.mesh import make_conv_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.common import ShardCtx
    from repro_torch.tree import flatten_with_path

    say = report["lines"].append
    tree = torch.load(data / f"{key}.pt", map_location="cpu", mmap=True, weights_only=False)
    ref = torch.load(data / f"{key}_ref.pt", map_location="cuda:0", weights_only=False)
    full = {"/".join(p): leaf for p, leaf in flatten_with_path(tree)}
    for shape, cfg, tag, ring in ref["runs"]:
        mesh = make_conv_mesh(shape, device="cuda")
        sctx = ShardCtx.for_mesh(mesh, LM_SHARD_BATCH)
        placed = sh.place_params(tree, mesh)
        held = whole = 0
        frac = {}
        for p, leaf in flatten_with_path(placed):
            g = full.get("/".join(p), full.get("/".join(p[:-1])))
            held += leaf.numel() * leaf.element_size()
            whole += g.numel() * g.element_size()
            if leaf.numel() != g.numel():
                f = round(leaf.numel() / g.numel(), 4)
                frac[f] = frac.get(f, 0) + 1
        say(f"rank {rank} {cfg.name} {tag} mesh {shape}: weight bytes {held} of {whole} "
            f"({held / whole:.3f}); each split leaf's share {dict(sorted(frac.items()))} "
            f"(leaves)")
        if shape[1] > 1 and set(frac) != {round(1 / shape[1], 4)}:
            raise AssertionError(f"{shape}: a split leaf holds {sorted(frac)} of its bytes, "
                                 f"not 1/{shape[1]}")
        torch.cuda.synchronize()
        with BlockSpy() as blocks, HeadSpy() as heads, DecodeSpy() as dec:
            logits, calls = rec_shard_traffic(cfg, placed, sctx, ref["inputs"], ring)
        kv_int8 = cfg.quant.enabled and cfg.quant.kv_bits == 8
        if cfg.family in ("dense", "moe", "vlm", "audio") and not kv_int8:  # K6's callers
            held_k6(dec.captured, f"rank {rank} {cfg.name} {tag} {shape}", say)
        del dec
        if cfg.n_heads:
            say(f"  rank {rank} {cfg.name} {tag} mesh {shape}: "
                + head_line(cfg, sctx, heads, f"rank {rank} {cfg.name} {shape}"))
        bc = check_blocks(blocks, f"rank {rank} {cfg.name} {tag} {shape}")
        report["checks"] += bc["checks"]
        report["check_launches"] += bc["launches"]
        report["max_abs_err"] = max(report["max_abs_err"], bc["max_abs_err"])
        del placed, blocks
        torch.cuda.empty_cache()
        rec_shard_k1_check(cfg, calls, f"rank {rank} {cfg.name} {tag} {shape}")
        for c in calls:
            for r, n in c["routes"].items():
                report["routes"][r] += n
        hold, errs = ref["hold"][tag], []
        rank_d = rank // shape[1]
        for i, (got, want) in enumerate(zip(logits, ref["logits"][tag])):
            nb = got.shape[0]
            rows = list(range(nb // shape[0] * rank_d, nb // shape[0] * (rank_d + 1))) \
                if sctx.batch_split and nb % shape[0] == 0 else list(range(nb))
            if not torch.isfinite(got).all() or tuple(got.shape) != tuple(want.shape):
                raise AssertionError(f"{shape} call {i}: logits {tuple(got.shape)} not "
                                     "finite or not the shape of one device's")
            e = rel_err(got, want, rows)
            if e > hold:
                raise AssertionError(f"{cfg.name} {tag} {shape} call {i}: logits {e:.4f} "
                                     f"of max |logit| from one device's, over {hold:.4f}")
            errs.append(0.0 if torch.equal(got[rows], want[rows]) else e)
        n_main = 1 + LM_SHARD_STEPS
        dec = [c for c in calls[:n_main] if c["decode"]]
        say(f"  rank {rank} {shape}: logits of {len(logits)} calls vs one device's (own "
            f"rows): {sum(e == 0.0 for e in errs)} bitwise, max {max(errs):.4f} of max "
            f"|logit| (held to {hold:.4f}); K1 {rec_shard_k1(cfg)} a prefill / decode "
            f"call, {bc['checks']} distinct blocks vs the plain version ({bc['launches']} "
            f"check launches): max |Δ| {bc['max_abs_err']:.3e}, |Δ| / (|x|@|W|) "
            f"{bc['t']:.2e}; prefill {calls[0]['ms']:.1f} ms wall, decode step "
            f"{float(np.median([c['ms'] for c in dec])):.1f} ms median"
            + (f", ring prompt ({RING_PROMPT}) prefill {calls[n_main]['ms']:.1f} ms, its "
               f"steps {float(np.median([c['ms'] for c in calls[n_main + 1:]])):.1f} ms"
               if len(calls) > n_main else "")
            + f"; collective bytes: prefill {calls[0]['bytes']}, decode step "
            f"{dec[0]['bytes']}"
            + (f", ring prefill {calls[n_main]['bytes']}, ring step "
               f"{calls[n_main + 1]['bytes']}" if len(calls) > n_main else ""))
    del tree


def rec_shard_spawn(keys: list, world: int, data: Path, what: str) -> dict:
    """The ranks of (b) or (c), spawned on gloo; their reports, every line
    logged, any failure raised."""
    import torch.multiprocessing as tmp

    for f in data.glob("rank*.json"):
        f.unlink()
    t0 = time.perf_counter()
    ctx = tmp.start_processes(rec_shard_rank, args=(world, free_port(), str(data), keys),
                              nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + REC_SHARD_TIMEOUT_S
    failure = None
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                failure = f"a rank did not finish within {REC_SHARD_TIMEOUT_S} s"
                break
    except Exception as e:  # a rank raised: its report holds the traceback
        failure = f"a rank failed: {type(e).__name__}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    total = {"routes": {"stream": 0, "mma": 0, "simt": 0}, "checks": 0, "launches": 0,
             "max_abs_err": 0.0}
    for r in range(world):
        f = data / f"rank{r}.json"
        rep = json.loads(f.read_text()) if f.exists() else \
            {"ok": False, "lines": [], "error": "no report"}
        for line in rep["lines"]:
            log("  " + line)
        if not rep["ok"]:
            log(f"  rank {r} failed:\n{rep.get('error', '')}")
            failure = failure or f"rank {r} failed"
            continue
        for k, n in rep["routes"].items():
            total["routes"][k] += n
        total["checks"] += rep["checks"]
        total["launches"] += rep["check_launches"]
        total["max_abs_err"] = max(total["max_abs_err"], rep["max_abs_err"])
    if failure:
        raise AssertionError(f"phase 16 {what}: {failure}")
    log(f"  {what}: all {world} ranks passed in {time.perf_counter() - t0:.1f} s")
    return total


def rec_shard_phase(gen, errs: dict, card: str) -> dict:
    """Phase 16: mamba2-130m, recurrentgemma-2b and whisper-tiny at full
    width and depth, and phi3-medium-14b (4 of 40 layers) with its KV heads
    cut by ``model``, through ``prefill``/``decode_step`` under an active
    ``ShardCtx``: (a) NCCL at world size 1, mesh (1, 1), bitwise the
    unsharded calls at their K1 counts; (b) two gloo ranks at (1, 2) and
    (2, 1); (c) four gloo ranks at (1, 4) on phi3's bf16 and int8 KV
    caches; each rank's logits held to one device's within
    ``max(LM_LOGIT_TOL, the one-ulp floor)``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_conv_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.common import ShardCtx

    t_phase = time.perf_counter()
    log(f"phase 16: TP for the recurrent and encoder-decoder families and the "
        f"sequence-sharded KV cache, a {LM_SHARD_BATCH} x {LM_SHARD_PROMPT} prefill and "
        f"{LM_SHARD_STEPS} decode steps (recurrentgemma-2b also its {RING_PROMPT}-token "
        f"ring prompt and {RING_SHARD_STEPS} steps)")
    data = ROOT / "build" / "phase16"
    data.mkdir(parents=True, exist_ok=True)
    for f in list(data.glob("*.pt")) + list(data.glob("rank*.json")):
        f.unlink()
    k1 = {"stream": 0, "mma": 0, "simt": 0}
    keys = []
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        for arch, full_layers in REC_SHARD_MODELS:
            cfg, params = rec_shard_build(arch, full_layers, 0, gen)
            inputs = rec_shard_inputs(cfg, gen)
            ref, calls, floor = rec_shard_refs(cfg, params, inputs, gen)
            rec_shard_k1_check(cfg, calls, f"{arch} one device")
            hold = max(LM_LOGIT_TOL, floor)
            mesh = make_conv_mesh((1, 1), device="cuda")
            sctx = ShardCtx.for_mesh(mesh, LM_SHARD_BATCH)
            placed = sh.place_params(params, mesh)
            got, mcalls = rec_shard_traffic(cfg, placed, sctx, inputs)
            for i, (a, b) in enumerate(zip(got, ref)):
                if not torch.equal(a, b):
                    raise AssertionError(f"{arch} (1, 1) call {i}: logits not bitwise the "
                                         "unsharded call's")
            rec_shard_k1_check(cfg, mcalls, f"{arch} (1, 1)")
            for c in mcalls:
                for r, n in c["routes"].items():
                    k1[r] += n
            dec1 = [c["ms"] for c in calls if c["decode"]]
            decm = [c["ms"] for c in mcalls if c["decode"]]
            log(f"  (a) {arch}: NCCL world 1, mesh (1, 1): {len(got)} calls bitwise the "
                f"unsharded calls, K1 {rec_shard_k1(cfg)} a prefill / decode call "
                f"({sum(c['k1'] for c in mcalls)} launches); prefill {mcalls[0]['ms']:.1f} "
                f"vs {calls[0]['ms']:.1f} ms wall, a decode step {np.median(decm):.1f} vs "
                f"{np.median(dec1):.1f} ms median (mesh vs unsharded); the one-ulp floor "
                f"{floor:.4f} of max |logit|, ranks held to {hold:.4f} [{card}]")
            runs = [(s, cfg, "main", s == (1, 2)) for s in REC_SHARD_MESHES]
            logits = {"main": ref}
            if cfg.family == "hybrid":  # the ring run: the last calls of ref
                n = 1 + LM_SHARD_STEPS
                logits = {"main": ref[:n], "ring": ref}
                runs = [(s, cfg, "main" if s != (1, 2) else "ring", s == (1, 2))
                        for s in REC_SHARD_MESHES]
            key = arch.split("-")[0]
            torch.save(params, data / f"{key}.pt")
            torch.save({"inputs": inputs, "logits": logits,
                        "hold": dict.fromkeys(logits, hold), "runs": runs},
                       data / f"{key}_ref.pt")
            keys.append(key)
            del params, placed, ref, got
            torch.cuda.empty_cache()
        # (c)'s model: phi3-medium-14b, 4 layers, one device on both caches
        cfg, params = rec_shard_build(SEQ_SHARD_ARCH, 40, SEQ_SHARD_LAYERS, gen)
        inputs = rec_shard_inputs(cfg, gen)
        logits, holds, runs = {}, {}, []
        for kv in (16, 8):
            c = cfg.with_quant(kv_bits=kv)
            tag = f"kv{kv}"
            logits[tag], calls, floor = rec_shard_refs(c, params, inputs, gen)
            rec_shard_k1_check(c, calls, f"{SEQ_SHARD_ARCH} {tag} one device")
            holds[tag] = max(LM_LOGIT_TOL, floor)
            runs.append((SEQ_SHARD_MESH, c, tag, False))
            log(f"  (c) {SEQ_SHARD_ARCH} ({SEQ_SHARD_LAYERS} of 40 layers) {tag} cache: one "
                f"device's one-ulp floor {floor:.4f} of max |logit|, ranks held to "
                f"{holds[tag]:.4f}; prefill {calls[0]['ms']:.1f} ms wall [{card}]")
        torch.save(params, data / "phi3.pt")
        torch.save({"inputs": inputs, "logits": logits, "hold": holds, "runs": runs},
                   data / "phi3_ref.pt")
        del params, logits
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    log(f"  (b) 2 ranks on gloo sharing the card (spawned), meshes "
        f"{list(REC_SHARD_MESHES)} (the ring prompt at (1, 2)); two ranks on one card time "
        "the dispatch and its collectives, not a speedup")
    tot_b = rec_shard_spawn(keys, 2, data, "(b)")
    log(f"  (c) {SEQ_SHARD_MESH[1]} ranks on gloo sharing the card, mesh {SEQ_SHARD_MESH}: "
        f"{SEQ_SHARD_ARCH}'s 10 KV heads over model {SEQ_SHARD_MESH[1]}: k and v gathered "
        "whole, a rank's attention on its block of the q heads, the KV positions split")
    tot_c = rec_shard_spawn(["phi3"], SEQ_SHARD_MESH[1], data, "(c)")
    checks = {"checks": 0, "launches": 0}
    for tot in (tot_b, tot_c):
        for r, n in tot["routes"].items():
            k1[r] += n
        checks["checks"] += tot["checks"]
        checks["launches"] += tot["launches"]
        errs["pasm_matmul"] = max(errs.get("pasm_matmul", 0.0), tot["max_abs_err"])
    for f in data.glob("*.pt"):
        f.unlink()
    log(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s; K1 launches {k1} (the (1, 1) "
        f"runs and every rank), and {checks['launches']} more holding {checks['checks']} "
        f"rank blocks to the plain version [{card}]")
    return {"launches": sum(k1.values()), "routes": k1}


# ---------------------------------------------------------------------------
# phase 17: sharded training of the MoE, vlm, SSM, hybrid and encdec families
# ---------------------------------------------------------------------------


def fam_inputs(cfg, gen) -> dict:
    """A phase-17 train batch: 8 × 128 tokens (phase 9(b)'s), the vlm's 256
    seeded patch embeddings, whisper's seeded 3000-frame mels."""
    import torch

    from repro_torch.data.pipeline import DataConfig, synthetic_batch

    batch = synthetic_batch(DataConfig(seed=SEED, vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH), 0, device="cuda")
    if cfg.frontend == "vit":
        batch["frontend_embeds"] = torch.randn(
            (TRAIN_BATCH, cfg.frontend_tokens, cfg.frontend_dim), generator=gen, device="cuda")
    if cfg.family == "audio":
        batch["frontend_embeds"] = torch.randn(
            (TRAIN_BATCH, cfg.n_mels, 2 * cfg.frontend_tokens), generator=gen, device="cuda")
    return batch


def fam_grads(grads) -> tuple:
    """One device's float gradient leaves by path but ``embed``'s, and
    ``embed``'s nonzero rows: ``(grads, rows, their gradients)``."""
    from repro_torch.tree import flatten_with_path

    out, rows, vals = {}, None, None
    for path, g in flatten_with_path(grads):
        if not g.is_floating_point():
            continue
        name = "/".join(path)
        if name == "embed":
            rows = g.abs().amax(-1).nonzero().flatten()
            vals = g[rows]
        else:
            out[name] = g
    return out, rows, vals


def fam_ref(cfg, params, batch, dp: int, *, replay=None, update=None) -> dict:
    """One device's loss and gradients with ``dp`` dispatch groups (the MoE's
    experts recorded, or replayed from ``replay``), its K1 launches;
    ``update(loss, grads)``, when given, runs on them before they are cut
    to what the ranks need, its result under ``"step"``."""
    import torch

    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.models.common import ShardCtx
    from repro_torch.train import step as st

    torch.cuda.synchronize()
    n0, r0 = pm.launches["pasm_matmul"], dict(pm.k1_routes)
    with RouteSpy(replay=replay) as spy:
        loss, _, grads = st.loss_and_grads(params, batch, cfg, ShardCtx(dp=dp))
        torch.cuda.synchronize()
    step = None if update is None else update(loss, grads)
    g, rows, vals = fam_grads(grads)
    out = {"loss": float(loss), "grads": g, "embed_rows": rows, "embed": vals,
           "k1": pm.launches["pasm_matmul"] - n0, "step": step,
           "routes": {k: pm.k1_routes[k] - r0[k] for k in r0}}
    if replay is None and cfg.moe:
        out["experts"] = spy.calls
    return out


def fam_floor(cfg, params, batch, ref: dict, gen) -> tuple:
    """The one-ulp floor of the gradients and the loss: one device with the
    embeddings moved by up to one bf16 ulp (phase 9(e)'s measure; the MoE on
    the recorded experts), max |Δ| over max |g| of any leaf."""
    import torch

    emb = params["embed"]
    params["embed"] = emb * (1 + 2.0 ** -8 * torch.randint(
        -1, 2, emb.shape, generator=gen, device="cuda", dtype=torch.int8).float())
    moved = fam_ref(cfg, params, batch, 1, replay=ref.get("experts"))
    params["embed"] = emb
    floor = max(rel_err(moved["grads"][k], g) for k, g in ref["grads"].items())
    return floor, abs(moved["loss"] - ref["loss"]) / abs(ref["loss"])


def fam_build(arch: str, n_layers: int, full_layers: int, gen, data: Path, key: str,
              card: str, dps=(1,)) -> dict:
    """(a) for one model: weights drawn and quantized on the card, one
    device's loss and gradients for each DP degree and the one-ulp floor,
    and the (1, 1) step on NCCL bitwise the unsharded step; the tree and the
    references saved for the ranks.  Returns its K1 launches by route."""
    import torch

    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.launch.mesh import make_conv_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.common import ShardCtx
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    from repro_torch.tree import tree_map

    cfg = rec_shard_config(arch, n_layers)
    params = build_lm(cfg, gen, "17", full_layers)
    batch = fam_inputs(cfg, gen)
    ocfg = opt.AdamWConfig()

    def update(loss, grads):  # the unsharded step's update, from these grads
        new = st._guarded_update(params, opt.init_opt_state(params), loss, grads, ocfg,
                                 guard=True)
        if int(new[2]["skipped"]):
            raise AssertionError(f"{arch}: one device's step skipped (non-finite grads)")
        return tree_map(lambda t: t.cpu(), new[:2]), loss.cpu()

    r_start = dict(pm.k1_routes)
    refs = {dp: fam_ref(cfg, params, batch, dp, update=update if dp == 1 else None)
            for dp in dps}
    a = refs[1].pop("step")
    for r in refs.values():
        r.pop("step", None)
    floor, loss_floor = fam_floor(cfg, params, batch, refs[1], gen)
    torch.cuda.empty_cache()
    mesh = make_conv_mesh((1, 1), device="cuda")
    placed = sh.place_params(params, mesh)
    torch.cuda.synchronize()
    n0 = pm.launches["pasm_matmul"]
    b = st.make_train_step(cfg, ocfg, ShardCtx.for_mesh(mesh, TRAIN_BATCH))(
        placed, opt.init_opt_state(placed, mesh=mesh), batch)
    torch.cuda.synchronize()
    n = pm.launches["pasm_matmul"] - n0
    if n != refs[1]["k1"]:
        raise AssertionError(f"{arch} (1, 1) step: K1 {n}, unsharded {refs[1]['k1']}")
    k1 = {r: pm.k1_routes[r] - c for r, c in r_start.items()}
    if not (same_tree(b[:2], a[0]) and torch.equal(b[2]["loss"].cpu(), a[1])):
        raise AssertionError(f"{arch} (1, 1) step: not bitwise the unsharded step")
    hold = max(LM_GRAD_TOL, floor)
    log(f"  (a) {arch}{' (' + str(n_layers) + ' of ' + str(full_layers) + ' layers)' if n_layers else ''}: "
        f"NCCL world 1, mesh (1, 1): the train step (loss "
        f"{float(a[1]):.6f}) bitwise the unsharded step (params, optimizer state), K1 {n} "
        f"a step {refs[1]['routes']}; one device's grads of {len(refs[1]['grads'])} float "
        f"leaves and embed's {len(refs[1]['embed_rows'])} rows saved"
        + (f" for dispatch groups {list(dps)}" if len(dps) > 1 else "")
        + f"; the one-ulp floor {floor:.4f} of max |g| (loss {loss_floor:.1e}), ranks held "
        f"to {hold:.4f} [{card}]")
    del a, b, placed
    torch.cuda.empty_cache()
    torch.save(params, data / f"{key}.pt")
    torch.save({"cfg": (arch, n_layers), "batch": batch, "refs": refs, "hold": hold,
                "loss_hold": max(LM_LOSS_TOL, 2 * loss_floor)}, data / f"{key}_ref.pt")
    del params, refs
    torch.cuda.empty_cache()
    return k1


def fam_check_grads(cfg, grads, placed, mesh, ref: dict, hold: float, what: str) -> dict:
    """Each float gradient leaf of this rank's blocks against its block of
    one device's, ``embed`` on the batch's rows of its vocab block: the
    worst |Δ| / max by leaf kind."""
    import torch

    from repro_torch.models import sharding as sh

    worst, seen = {}, 0
    specs = sh.placed_specs(placed, mesh)
    for path, g, spec, owner in sh._walked(grads, specs, mesh):
        if not g.is_floating_point():
            continue
        name = "/".join(path)
        if owner is None and path[-1] == "w" and name not in ref["grads"]:
            name = "/".join(path[:-1])  # a dense block place_params wrapped
        if name == "embed":
            n = g.shape[0]
            off = mesh.index("model") * n if n < cfg.vocab else 0
            rows = ref["embed_rows"]
            mine = (rows >= off) & (rows < off + n)
            e = bwd_close(g[rows[mine] - off], ref["embed"][mine], hold,
                          f"{what} grad embed rows") if bool(mine.any()) else 0.0
            if int(g.abs().amax(-1).count_nonzero()) > int(mine.sum()):
                raise AssertionError(f"{what}: embed gradient off the batch's rows")
            kind = "embed"
        else:
            want = sh.local_shard(ref["grads"][name], spec, mesh)
            e = bwd_close(g, want, hold, f"{what} grad {name}")
            kind = path[-1] if path[-1] != "w" else path[-2]
        worst[kind] = max(worst.get(kind, 0.0), e)
        seen += 1
    if seen != len(ref["grads"]) + 1:
        raise AssertionError(f"{what}: {seen} of {len(ref['grads']) + 1} gradient leaves "
                             "compared")
    return worst


class GradSpy:
    """Wraps ``train.step._guarded_update`` while active and keeps the loss
    and the (reduced) gradients of the last step it saw, so a timed train
    step is also the one whose gradients are checked, and ``peak``, the
    card's ``max_memory_allocated`` when the update began: the peak of the
    forward, the loss, the backward and the gradients' reduction."""

    def __enter__(self):
        from repro_torch.train import step as st

        self.mod, self.inner = st, st._guarded_update
        st._guarded_update = self
        return self

    def __exit__(self, *exc):
        self.mod._guarded_update = self.inner

    def __call__(self, params, opt_state, loss, grads, ocfg, **kw):
        import torch

        self.loss, self.grads = loss, grads
        self.peak = torch.cuda.max_memory_allocated()
        return self.inner(params, opt_state, loss, grads, ocfg, **kw)


def fam_rank_model(rank: int, key: str, shape, data: Path, report: dict) -> None:
    """One model on one mesh: a train step timed with its peak memory, its
    loss and gradients against one device's (the MoE on one device's
    experts for its rows), K1 launches, every distinct block K1 ran against
    the plain version, collective bytes; at ``data`` > 1 the step again
    with JAX's ZeRO-1 moments, bitwise the first, and
    ``compress_grads(mesh=)`` bitwise its block of the gathered
    compression."""
    import torch

    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.mesh import make_conv_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.common import ShardCtx
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    from repro_torch.tree import flatten_with_path, tree_leaves, tree_map

    say = report["lines"].append
    tree = torch.load(data / f"{key}.pt", map_location="cpu", mmap=True, weights_only=False)
    ref = torch.load(data / f"{key}_ref.pt", map_location="cuda:0", weights_only=False)
    arch, n_layers = ref["cfg"]
    cfg = rec_shard_config(arch, n_layers)
    batch = ref["batch"]
    mesh = make_conv_mesh(shape, device="cuda")
    sctx = ShardCtx.for_mesh(mesh, TRAIN_BATCH)
    one = ref["refs"][sctx.dp if cfg.moe else 1]
    placed = sh.place_params(tree, mesh)
    del tree
    what = f"rank {rank} {arch} {shape}"
    part = mesh.index("data") if sctx.batch_split else None
    step = st.make_train_step(cfg, opt.AdamWConfig(), sctx)
    nb = lambda s: sum(t.numel() * t.element_size() for t in tree_leaves((s.mu, s.nu)))  # noqa: E731

    def timed(state, spies=()):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pm.reset_launches()
        lmesh.reset_collective_bytes()
        t0 = time.perf_counter()
        with RouteSpy(replay=one.get("experts"), part=part) as rs:
            for s in spies:
                s.__enter__()
            try:
                new = step(placed, state, batch)
                torch.cuda.synchronize()
            finally:
                for s in reversed(spies):
                    s.__exit__(None, None, None)
        ms = (time.perf_counter() - t0) * 1e3
        if int(new[2]["skipped"]) or not np.isfinite(float(new[2]["loss"])):
            raise AssertionError(f"{what} step: {new[2]}")
        return new, {"ms": ms, "peak": torch.cuda.max_memory_allocated(), "base": base,
                     "k1": pm.launches["pasm_matmul"], "routes": dict(pm.k1_routes),
                     "bytes": dict(lmesh.collective_bytes), "moments": nb(new[1]),
                     "replay": rs.calls}

    blocks, grads, heads = BlockSpy(), GradSpy(), HeadSpy()
    new, t = timed(opt.init_opt_state(placed), (blocks, grads, heads))
    if cfg.n_heads:
        say(f"{what}: " + head_line(cfg, sctx, heads, what))
    k1 = t["k1"]
    if not k1 or t["routes"]["simt"] or t["routes"]["stream"]:
        raise AssertionError(f"{what}: K1 {k1} by route {t['routes']}")
    lerr = abs(float(grads.loss) - one["loss"]) / abs(one["loss"])
    if lerr > ref["loss_hold"]:
        raise AssertionError(f"{what}: loss {float(grads.loss)} vs one device {one['loss']}")
    worst = fam_check_grads(cfg, grads.grads, placed, mesh, one, ref["hold"], what)
    flips = ""
    if cfg.moe:
        n_f = int(sum(int(f) for f, _ in t["replay"]))
        gap = max(float(g.detach()) for _, g in t["replay"])
        if gap > MOE_TIE:
            raise AssertionError(f"{what}: a replayed expert {gap:.3e} below the k-th")
        flips = (f"; one device's experts replayed: its own top-k differs at {n_f} "
                 f"token-layers, each within {gap:.2e} of the k-th probability")
    zero = {}
    if mesh.size("data") > 1:  # compressed gradients: every leaf's global max |g|
        specs = sh.placed_specs(placed, mesh)
        lmesh.reset_collective_bytes()
        c = opt.compress_grads(grads.grads, 16, mesh=mesh)
        want = sh.place_tree(opt.compress_grads(sh.gather_params(grads.grads, mesh, specs),
                                                16), specs, mesh, like=grads.grads)
        if not same_tree(c, want):
            raise AssertionError(f"{what}: compress_grads(mesh=) is not the block of the "
                                 "compressed gathered gradient")
        zero["grad_max"] = lmesh.collective_bytes["grad_max"]
        del c, want
    grads_peak = grads.peak
    del grads
    torch.cuda.empty_cache()
    with torch.no_grad():
        bc = check_blocks(blocks, what)
    report["checks"] += bc["checks"]
    report["check_launches"] += bc["launches"]
    report["max_abs_err"] = max(report["max_abs_err"], bc["max_abs_err"])
    del blocks
    torch.cuda.empty_cache()
    if mesh.size("data") > 1:  # JAX's ZeRO-1 moments: the same step, bitwise
        # the whole-moment step's result waits on the host, so both steps
        # start from the same bytes on the card
        new = tuple(tree_map(lambda x: x.cpu(), n) for n in new[:2]) + (new[2],)
        torch.cuda.empty_cache()
        zspy = GradSpy()
        znew, zt = timed(opt.init_opt_state(placed, mesh=mesh), (zspy,))
        zt["grads_peak"] = zspy.peak
        del zspy
        dims, i = sh.zero_dims(placed, mesh), mesh.index("data")
        same = same_tree(znew[0], new[0]) and torch.equal(znew[2]["loss"].cpu(),
                                                          new[2]["loss"].cpu())
        for (path, m), (_, zm) in zip(flatten_with_path(new[1]), flatten_with_path(znew[1])):
            d = dims.get(path[1:])
            if d is not None:
                n = zm.shape[d]
                m = m.narrow(d, i * n, n)
            same = same and torch.equal(m, zm.cpu())
        if not same or zt["k1"] != k1:
            raise AssertionError(f"{what}: the ZeRO-1 step is not bitwise the step with "
                                 f"whole moments (K1 {zt['k1']} vs {k1})")
        zero.update(zt, leaves=len(dims))
        del znew
    report["k1"] += k1 + (k1 if zero.get("ms") else 0)
    report["routes"]["mma"] += k1 + (k1 if zero.get("ms") else 0)
    say(f"{what} batch {TRAIN_BATCH} x {TRAIN_SEQ}: loss {lerr:.1e} of one device's; grads "
        f"|Δ|/max by kind {', '.join(f'{k} {v:.2e}' for k, v in sorted(worst.items()))} "
        f"(<= {ref['hold']:.4f}){flips}; K1 {k1} a step, all mma; {bc['checks']} distinct "
        f"blocks vs the plain version: max |Δ| {bc['max_abs_err']:.3e}, |Δ|/(|x|@|W|) "
        f"{bc['t']:.2e}; the step {t['ms']:.1f} ms wall, peak {t['peak'] / 1e9:.2f} GB "
        f"from {t['base'] / 1e9:.2f} GB at its start (loss and grads "
        f"{grads_peak / 1e9:.2f} GB), moments {t['moments']} B a rank (the params' layout), "
        f"collective bytes {t['bytes']}"
        + (f"; ZeRO-1 ({zero['leaves']} moments cut over data): bitwise, {zero['ms']:.1f} ms "
           f"wall, peak {zero['peak'] / 1e9:.2f} GB from {zero['base'] / 1e9:.2f} GB at its "
           f"start (loss and grads {zero['grads_peak'] / 1e9:.2f} GB), moments "
           f"{zero['moments']} B a rank, "
           f"zero_gather {zero['bytes']['zero_gather']} B; compress_grads(mesh=) bitwise the "
           f"block of the gathered compression (grad_max {zero['grad_max']} B)"
           if zero else ""))
    del new, step, placed
    torch.cuda.empty_cache()


def fam_resume(rank: int, key: str, data: Path, report: dict) -> None:
    """At (2, 1), whisper-tiny with ZeRO-1 moments: 6 steps checkpointed every
    2, then again with a crash after step 4 restored by the supervisor:
    losses and final state bitwise the uninterrupted run."""
    import torch

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.mesh import make_conv_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.common import ShardCtx
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    from repro_torch.train.loop import run_loop

    tree = torch.load(data / f"{key}.pt", map_location="cpu", mmap=True, weights_only=False)
    ref = torch.load(data / f"{key}_ref.pt", map_location="cuda:0", weights_only=False)
    cfg = rec_shard_config(*ref["cfg"])
    mesh = make_conv_mesh((2, 1), device="cuda")
    step = st.make_train_step(cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=1),
                              ShardCtx.for_mesh(mesh, TRAIN_BATCH))

    def fresh():
        p = sh.place_params(tree, mesh)
        return p, opt.init_opt_state(p, mesh=mesh)

    def batches(s):
        b = dict(ref["batch"])
        b["tokens"] = torch.roll(b["tokens"], s, 1)
        return b

    t0 = time.perf_counter()
    full = run_loop(step, fresh(), batches, steps=TRAIN_SHARD_STEPS,
                    mgr=ckpt.CheckpointManager(data / f"{key}_zero_ref", mesh=mesh),
                    ckpt_every=2)
    last, losses, state, restarts = supervised_run(step, fresh, batches,
                                                   data / f"{key}_zero_run", mesh=mesh)
    same_l = [losses[s] for s in range(TRAIN_SHARD_STEPS)] == \
        [full.losses[s] for s in range(TRAIN_SHARD_STEPS)]
    if last != TRAIN_SHARD_STEPS or restarts != 1 or not same_l or \
            not same_tree(state, full.state) or full.n_skipped or \
            not isinstance(state[1], opt.ZeroOptState):
        raise AssertionError(f"rank {rank} {cfg.name} ZeRO crash-resume: last {last}, "
                             f"restarts {restarts}, losses equal {same_l}, state bitwise "
                             f"{same_tree(state, full.state)}")
    report["lines"].append(
        f"rank {rank} {cfg.name} (2, 1) ZeRO-1 moments: crashed after step "
        f"{TRAIN_SHARD_CRASH} of {TRAIN_SHARD_STEPS} (checkpoints every 2, the moments "
        f"gathered from their data blocks, restored onto them): losses and final state "
        f"bitwise the uninterrupted run ({time.perf_counter() - t0:.1f} s for both runs)")


def fam_rank(rank: int, world: int, port: int, data_dir: str, plan: list) -> None:
    """One rank of phase 17(b)/(c): gloo on the card every rank shares; each
    ``(key, mesh)`` of ``plan`` (the key ``resume`` runs :func:`fam_resume`);
    a JSON report (or the traceback) to ``data_dir/rank<r>.json``."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.train.step import deterministic

    report = {"lines": [], "k1": 0, "routes": {"stream": 0, "mma": 0, "simt": 0},
              "checks": 0, "check_launches": 0, "max_abs_err": 0.0, "ok": False}
    data = Path(data_dir)
    out = data / f"rank{rank}.json"
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=SHARD_COLLECTIVE_TIMEOUT_S))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with deterministic(), torch.enable_grad():
            for key, shape in plan:
                n0 = pm.launches["pasm_matmul"]
                if key == "resume":
                    fam_resume(rank, "whisper", data, report)
                    report["k1"] += pm.launches["pasm_matmul"] - n0
                    report["routes"]["mma"] += pm.launches["pasm_matmul"] - n0
                else:
                    fam_rank_model(rank, key, tuple(shape), data, report)
                torch.cuda.empty_cache()
        report["ok"] = True
    except Exception:  # reported by the parent, which fails the run
        report["error"] = traceback.format_exc()
        raise
    finally:
        out.write_text(json.dumps(report))
        dist.destroy_process_group()


def fam_spawn(plan: list, world: int, data: Path, what: str) -> dict:
    """The ranks of (b) or (c), spawned on gloo; their totals, every line
    logged, any failure raised."""
    import torch.multiprocessing as tmp

    for f in data.glob("rank*.json"):
        f.unlink()
    t0 = time.perf_counter()
    ctx = tmp.start_processes(fam_rank, args=(world, free_port(), str(data), plan),
                              nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + FAM_SHARD_TIMEOUT_S
    failure = None
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                failure = f"a rank did not finish within {FAM_SHARD_TIMEOUT_S} s"
                break
    except Exception as e:  # a rank raised: its report holds the traceback
        failure = f"a rank failed: {type(e).__name__}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    total = {"routes": {"stream": 0, "mma": 0, "simt": 0}, "checks": 0, "launches": 0,
             "max_abs_err": 0.0}
    for r in range(world):
        f = data / f"rank{r}.json"
        rep = json.loads(f.read_text()) if f.exists() else \
            {"ok": False, "lines": [], "error": "no report"}
        for line in rep["lines"]:
            log("  " + line)
        if not rep["ok"]:
            log(f"  rank {r} failed:\n{rep.get('error', '')}")
            failure = failure or f"rank {r} failed"
            continue
        for k, n in rep["routes"].items():
            total["routes"][k] += n
        total["checks"] += rep["checks"]
        total["launches"] += rep["check_launches"]
        total["max_abs_err"] = max(total["max_abs_err"], rep["max_abs_err"])
    if failure:
        raise AssertionError(f"phase 17 {what}: {failure}")
    log(f"  {what}: all {world} ranks passed in {time.perf_counter() - t0:.1f} s")
    return total


def family_train_shard_phase(gen, errs: dict, card: str) -> dict:
    """Phase 17: sharded training of the other families.  (a) NCCL at world
    size 1, mesh (1, 1): deepseek-moe-16b and internvl2-26b (4 layers each),
    recurrentgemma-2b (8 of 26 layers), mamba2-130m and whisper-tiny at full
    depth, one train step each bitwise the unsharded step; one device's loss, gradients and
    one-ulp floor saved.  (b) two gloo ranks at (1, 2) and (2, 1): each
    model's loss and every float gradient leaf held to one device's within
    ``max(LM_GRAD_TOL, the floor)``, K1's blocks held to the plain version,
    the step timed; at (2, 1) JAX's ZeRO-1 moments bitwise, compressed
    gradients bitwise the block of the global compression, a ZeRO
    crash-resume bitwise.  (c) phi3-medium-14b (4 of 40 layers) on four
    gloo ranks at (1, 4), its 10 KV heads cut by ``model``."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.train.step import deterministic

    t_phase = time.perf_counter()
    log(f"phase 17: sharded training of the MoE, vlm, SSM, hybrid and encdec families, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} a step, 16 bins int4 on K1, under deterministic "
        f"algorithms")
    data = ROOT / "build" / "phase17"
    shutil.rmtree(data, ignore_errors=True)
    data.mkdir(parents=True)
    k1 = {"stream": 0, "mma": 0, "simt": 0}
    keys = []
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        with deterministic(), torch.enable_grad():
            for arch, n_layers, full in FAM_SHARD_MODELS:
                key = arch.split("-")[0]
                dps = (1, 2) if arch.startswith("deepseek") else (1,)
                for r, n in fam_build(arch, n_layers, full, gen, data, key, card,
                                      dps).items():
                    k1[r] += n
                keys.append(key)
            arch, n_layers, full = FAM_SEQ_MODEL
            for r, n in fam_build(arch, n_layers, full, gen, data, "phi3", card).items():
                k1[r] += n
    finally:
        dist.destroy_process_group()
    log(f"  (b) 2 ranks on gloo sharing the card (spawned), meshes {list(FAM_SHARD_MESHES)}; "
        "two ranks on one card time the dispatch and its collectives, not a speedup")
    plan = [(key, shape) for shape in FAM_SHARD_MESHES for key in keys] + [("resume", None)]
    tot_b = fam_spawn(plan, 2, data, "(b)")
    log(f"  (c) {FAM_SEQ_MESH[1]} ranks on gloo sharing the card, mesh {FAM_SEQ_MESH}: "
        f"{arch}'s 10 KV heads over model {FAM_SEQ_MESH[1]}: k and v gathered whole, a "
        "rank's attention on its block of the q heads")
    tot_c = fam_spawn([("phi3", FAM_SEQ_MESH)], FAM_SEQ_MESH[1], data, "(c)")
    checks = {"checks": 0, "launches": 0}
    for tot in (tot_b, tot_c):
        for r, n in tot["routes"].items():
            k1[r] += n
        checks["checks"] += tot["checks"]
        checks["launches"] += tot["launches"]
        errs["pasm_matmul"] = max(errs.get("pasm_matmul", 0.0), tot["max_abs_err"])
    shutil.rmtree(data, ignore_errors=True)
    log(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s; K1 launches {k1} (one "
        f"device's grads, the (1, 1) steps and every rank's), and {checks['launches']} more "
        f"holding {checks['checks']} rank blocks to the plain version [{card}]")
    return {"launches": sum(k1.values()), "routes": k1}


# ---------------------------------------------------------------------------
# phase 18: the tooling (the examples, the dry run, the roofline terms)
# ---------------------------------------------------------------------------


def run_example(name: str, argv: list) -> tuple:
    """``examples/torch/<name>.py``'s ``main(argv)`` in this process (the
    kernels are built), its output captured: ``(last line, launches by
    kernel, K1 launches by route)``.  A failed check raises."""
    import contextlib
    import importlib.util
    import io

    import torch

    from repro_torch.kernels import pasm_matmul as pm

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    torch.cuda.synchronize()
    pm.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    torch.cuda.synchronize()
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"examples/torch/{name}.py exited {rc}:\n{buf.getvalue()}")
    return lines[-1], counted(), dict(pm.k1_routes)


def tooling_phase(gen, card: str) -> dict:
    """Phase 18: (a) the four examples on the card through their own
    checks, K1–K4 counted (``serve_pasm`` must launch K1); (b) the dry run of phase 7's qwen3-32b (4 of 64
    layers) at mesh (1, 1) for its 4 × 384 prefill and one decode step
    against a 512-slot cache: its argument bytes held within
    ``TOOL_ARG_TOL`` of the growth of ``memory_allocated`` as those params,
    caches and tokens are built on the card, its peak live bytes beside
    ``max_memory_allocated`` of the same call on ``dequant`` (what the dry
    run counts); (c) the roofline terms of those two steps beside their
    measured wall and device ms on ``kernel`` (``time_step``; K1 counted)."""
    import gc

    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.models import api
    from repro_torch.models.common import ShardCtx, quantize_params

    t_phase = time.perf_counter()
    log(f"phase 18: the tooling ({card})")
    launches = dict.fromkeys(ALL_KERNELS, 0)
    routes = dict.fromkeys(pm.K1_ROUTES, 0)

    def add(counts, by_route):
        for k, v in counts.items():
            launches[k] += v
        for k, v in by_route.items():
            routes[k] += v

    # (a) the examples
    for name, argv in (("quickstart", []), ("paper_conv", []),
                       ("train_lm", ["--steps", str(TOOL_TRAIN_STEPS)]), ("serve_pasm", [])):
        t0 = time.perf_counter()
        last, counts, by_route = run_example(name, ["--device", "cuda"] + argv)
        add(counts, by_route)
        log(f"  (a) examples/torch/{name}.py {' '.join(argv)}: {last} ({time.perf_counter() - t0:.1f} s, "
            f"launches {counts}, K1 by route {by_route})")
        if name == "paper_conv" and not all(counts[k] for k in KERNELS):
            raise AssertionError(f"paper_conv: a kernel of K1-K4 never launched: {counts}")
        if name == "serve_pasm" and not counts["pasm_matmul"]:
            raise AssertionError(f"serve_pasm: the weight-shared LM never launched K1: {counts}")

    # (b) the dry run at mesh (1, 1), and the same trees on the card
    cfg = lm_config()
    model = api.get_model(cfg)
    cells = {"prefill": ShapeSpec("prefill_384", TOOL_PREFILL[1], TOOL_PREFILL[0], "prefill"),
             "decode": ShapeSpec("decode_512", LM_MAX_SEQ, TOOL_PREFILL[0], "decode")}
    mesh = M.make_conv_mesh((1, 1), device="meta")
    reports = {}
    for kind, shape in cells.items():
        t0 = time.perf_counter()
        reports[kind] = dryrun.lower_cell(cfg, shape, mesh=mesh, quant="pasm",
                                          verbose=False)["report"]
        log(f"  (b) dry run {cfg.name} ({cfg.n_layers} layers) {shape.name} "
            f"(batch {shape.global_batch}) at mesh 1x1: {time.perf_counter() - t0:.1f} s on "
            f"the CPU (meta tensors), args {reports[kind].extra['argument_bytes_by_kind']}")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = quantize_params(model.init_params(cfg, gen, torch.bfloat16), cfg,
                             iters=QUANT_ITERS)
    torch.cuda.synchronize()
    B = TOOL_PREFILL[0]
    step_inputs = {
        "prefill": lambda: (model.init_caches(cfg, B, TOOL_PREFILL[1], device="cuda"),
                            torch.randint(0, cfg.vocab, TOOL_PREFILL, generator=gen,
                                          device="cuda", dtype=torch.int32)),
        "decode": lambda: (model.init_caches(cfg, B, LM_MAX_SEQ, device="cuda"),
                           torch.randint(0, cfg.vocab, (B, 1), generator=gen,
                                         device="cuda", dtype=torch.int32)),
    }
    run = {"prefill": model.prefill, "decode": model.decode_step}
    out = {"reports": {}, "times": {}}
    for kind, report in reports.items():
        caches, toks = step_inputs[kind]()
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - base
        want = report.extra["argument_bytes_per_device"]
        log(f"  (b) {kind}: dry-run argument bytes {want} vs memory_allocated growth "
            f"{grown} building them on the card ({(grown - want) / want * 100:+.3f} %, "
            f"held to {TOOL_ARG_TOL * 100:.0f} %)")
        if abs(grown - want) > TOOL_ARG_TOL * want:
            raise AssertionError(f"dry run {kind}: argument bytes {want} off the card's {grown}")
        dq = cfg.with_quant(impl="dequant")
        torch.cuda.reset_peak_memory_stats()
        run[kind](params, toks, caches, dq, ShardCtx())
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        log(f"  (b) {kind}: dry-run peak live bytes {report.extra['peak_live_bytes_per_device']} "
            f"beside max_memory_allocated {peak} of the same call on dequant "
            f"({peak / report.extra['peak_live_bytes_per_device']:.3f}x)")
        # (c) the roofline terms beside the step measured on kernel
        pm.reset_launches()
        t = time_step(lambda: run[kind](params, toks, caches, cfg, ShardCtx()))
        add(counted(), dict(pm.k1_routes))
        ideal = report.model_flops / report.n_devices / report.hw.peak_flops
        dev_ms = t["device_ms"]
        log(f"  (c) {kind}: terms compute {report.compute_s * 1e3:.4f} ms | memory "
            f"{report.memory_s * 1e3:.4f} ms | collective {report.collective_s * 1e3:.4f} ms"
            f" → {report.bottleneck}-bound, roofline step {report.step_time_s * 1e3:.4f} ms,"
            f" roofline_fraction {report.roofline_fraction:.4f}; measured on kernel: "
            f"{fmt_step(t)}; model FLOPs at the bf16 peak / device time "
            f"{ideal * 1e3 / dev_ms if dev_ms else float('nan'):.4f} (K1 launches "
            f"{pm.launches['pasm_matmul']}) [{card}]")
        out["reports"][kind] = report
        out["times"][kind] = t
        del caches, toks
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"], out["routes"] = launches, routes
    out["s"] = time.perf_counter() - t_phase
    log(f"  phase 18 took {out['s']:.1f} s; launches {launches}, K1 by route {routes}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # phase 9 trains under torch.use_deterministic_algorithms, which needs
    # cuBLAS's workspace fixed before the run's first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch.nn.functional as F

    from repro_torch.configs import alexnet_conv
    from repro_torch.core import conv as cv
    from repro_torch.core import pasm as _pasm
    from repro_torch.kernels import _build, ops, pas_histogram as ph
    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.models import cnn
    from repro_torch.serve.batcher import CnnBatcher

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    t_run = [time.perf_counter()] * 2

    def lap(what: str) -> None:
        """How long ``what`` took, and the run so far (the run must end
        inside its limit)."""
        now = time.perf_counter()
        log(f"[time] {what}: {now - t_run[1]:.1f} s, {now - t_run[0]:.1f} s into the run")
        t_run[1] = now

    # 1. the card ----------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build ---------------------------------------------------------------
    t_build = _build.build()
    log(f"build: {t_build:.2f} s (nvcc, {len(_build.SOURCES)} sources in parallel)")
    for name in _build.SOURCES:
        entry = ""
        for ln in _build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry = kernel_instance(m.group(1))
            if "registers" in ln or "spill" in ln:
                log(f"  ptxas {name} {entry}: {ln.strip()}")

    # the full-width model: seeded weights, k-means on the card
    cfg = alexnet_conv.config()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = cnn.init_params(cfg, gen, device="cuda")
    qparams = cnn.quantize(params, cfg)
    torch.cuda.synchronize()
    log(f"model: {cfg.name} {cfg.in_chw} -> {cfg.classes} classes, "
        f"{cfg.bins} bins, quantized on the card in {time.perf_counter() - t0:.2f} s")
    packed = [p.pack(layout=cfg.layout) for p in qparams["conv"]]

    lap("phases 1-2 (the card, the build, AlexNet's weights)")

    # 3. kernels vs plain versions -----------------------------------------
    errs = dict.fromkeys(ALL_KERNELS, 0.0)
    log(f"phase 3: kernels vs plain versions (tolerance |Δ| <= {TOL} + {TOL}·|plain|)")
    for kind, plist in (("shared", qparams["conv"]), ("packed", packed)):
        for case in stage_cases(cfg, {"conv": plist}, 4, gen):
            case.name = f"{case.name} {kind}"
            check_case(case, errs)
    for case in stage_cases(cfg, qparams, 4, gen):
        check_integer(case, gen)
    third = stage_cases(cfg, qparams, 4, gen)[2]
    kshape = third.params.kshape
    scale = third.params.codebook.std()  # random dictionaries at the served scale
    for bins, top in ((4, 4), (256, 256), (16, 20)):  # 20: indices past 16 bins
        rp = cv.ConvParams.shared(
            torch.randint(0, top, kshape, generator=gen, device="cuda",
                          dtype=torch.uint8),
            torch.randn(bins, generator=gen, device="cuda") * scale,
            bias=third.params.bias)
        check_case(dataclasses.replace(
            third, name=f"{third.name} B={bins} idx<{top}", params=rp), errs,
            pasm=top == bins)  # K1/K2 clamp an index past B: another function
    first, second = stage_cases(cfg, qparams, 4, gen)[:2]
    g2 = cv.ConvParams.quantize(params["conv"][1].kernel, cfg.bins,
                                bias=params["conv"][1].bias, groups=2)
    check_case(dataclasses.replace(second, name=second.name + " groups=2 shared",
                                   params=g2), errs)
    check_case(dataclasses.replace(second, name=second.name + " groups=2 packed",
                                   params=g2.pack()), errs)
    check_case(dataclasses.replace(
        first, name=first.name + " NHWC same packed",
        conv=dataclasses.replace(first.conv, padding="same", layout="NHWC"),
        params=first.params.pack(layout="NHWC"),
        img=first.img.permute(0, 2, 3, 1).contiguous()), errs)
    C0 = cfg.in_chw[0]
    check_case(dataclasses.replace(
        first, name=f"bigimg_conv1 {C0}x512x512",
        img=torch.randn((2, C0, 512, 512), generator=gen, device="cuda")),
        errs, k1=False)

    lap("phase 3")

    # 4. serve the full-width model ----------------------------------------
    rng = np.random.default_rng(SEED)
    H, W = cfg.in_chw[1:]
    frac = [(0.9, 0.8), (1.0, 0.67), (0.67, 1.0), (0.57, 0.57), (0.45, 0.54),
            (0.43, 0.29), (0.29, 0.29), (0.27, 0.18), (0.14, 0.14), (0.14, 0.08),
            (0.07, 0.07), (0.04, 0.04)]
    sizes = [(H, W)] * 6 + [(max(1, int(H * a)), max(1, int(W * b))) for a, b in frac]
    images = [rng.standard_normal((3, h, w)).astype(np.float32) for h, w in sizes]
    log(f"phase 4: serving {len(images)} requests of {len(set(sizes))} sizes "
        "through CnnBatcher(device='cuda')")
    served, counts = {}, {}
    for impl in ("kernel", "kernel_implicit", "pas_kernel", "einsum"):
        b = CnnBatcher(dataclasses.replace(cfg, impl=impl), qparams, max_batch=8,
                       device="cuda")
        reqs = [b.submit(im) for im in images]
        torch.cuda.synchronize()
        pm.reset_launches()
        b.flush()
        torch.cuda.synchronize()
        counts[impl] = counted()
        n_stages = len(cfg.layers)
        roll = b.metrics.rollup()
        log(f"  {impl:<16} {b.n_batches} batches, launches {counts[impl]}, "
            f"{roll['img_s']:.1f} img/s host clock incl. first-call overheads "
            f"({card})")
        key = SERVED_KERNEL.get(impl)
        want_counts = {k: n_stages * b.n_batches if k == key else 0
                       for k in ALL_KERNELS}
        if counts[impl] != want_counts:
            raise AssertionError(
                f"{impl}: expected launches {want_counts} ({n_stages} per batch "
                f"over {b.n_batches} batches), got {counts[impl]}")
        if not all(r.done and r.logits.shape == (cfg.classes,)
                   and np.isfinite(r.logits).all() for r in reqs):
            raise AssertionError(f"{impl}: a request was not served finite logits")
        served[impl] = np.stack([r.logits for r in reqs])
    want = served["einsum"]
    for impl in SERVED_KERNEL:
        d = np.abs(served[impl] - want)
        agree = float((served[impl].argmax(-1) == want.argmax(-1)).mean())
        log(f"  {impl} logits vs einsum: max|Δ| {d.max():.3e} "
            f"(|logit| max {np.abs(want).max():.3f}), class agreement {agree:.3f}")
        if not np.all(d <= LOGIT_TOL + LOGIT_TOL * np.abs(want)):
            raise AssertionError(f"{impl} logits off the einsum engine")
        if impl == "pas_kernel" and agree != 1.0:
            raise AssertionError(f"{impl} classes differ from the einsum engine")
    log(f"  kernel ≡ kernel_implicit logits bitwise: "
        f"{np.array_equal(served['kernel'], served['kernel_implicit'])}")

    # the five full-width stages through conv2d(engine="pas_kernel_implicit")
    stage_imgs = torch.from_numpy(np.stack(images[:6])).cuda()
    outs = {}
    for engine in ("pas_kernel_implicit", "einsum"):
        torch.cuda.synchronize()
        pm.reset_launches()
        h = stage_imgs
        for p, (conv, pool) in zip(qparams["conv"], cnn.stages(cfg)):
            h = cv.conv2d(h, p, conv, engine=engine, pool=pool)
        outs[engine] = cnn._head(h, qparams["head"])
        torch.cuda.synchronize()
        counts[engine + " stages"] = counted()
    k4_counts = counts["pas_kernel_implicit stages"]
    if k4_counts != {k: n_stages if k == "pas_conv" else 0 for k in ALL_KERNELS}:
        raise AssertionError(f"pas_kernel_implicit stages: launches {k4_counts}")
    got, want4 = outs["pas_kernel_implicit"].cpu().numpy(), outs["einsum"].cpu().numpy()
    d = np.abs(got - want4)
    agree = float((got.argmax(-1) == want4.argmax(-1)).mean())
    log(f"  pas_kernel_implicit stages ({len(stage_imgs)} images): launches "
        f"{k4_counts}, logits vs einsum max|Δ| {d.max():.3e}, class agreement "
        f"{agree:.3f}")
    if not (np.all(d <= LOGIT_TOL + LOGIT_TOL * np.abs(want4)) and agree == 1.0):
        raise AssertionError("pas_kernel_implicit stage logits off the einsum engine")

    lap("phase 4")

    # 5. timings at batch 32 -------------------------------------------------
    log(f"phase 5: CUDA-event timings at batch {TIME_BATCH} ({card})")
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "ops_ms": 0.0, "bytes_ms": 0.0} for k in KERNELS}
    for case in stage_cases(cfg, qparams, TIME_BATCH, gen):
        t = case.params.gemm_tensor(case.conv.layout)
        bias, g = case.params.bias, case.geom()
        x = case.patches()
        w = cv.ConvParams.dense_operand(case.params, case.conv.layout)
        kern4 = cv._unflatten_kernel(w[: case.conv.K], "ckk", case.params.kshape)
        kern4 = kern4.contiguous()
        li = _pasm.logical_idx(t)
        rows, lib = [], {}
        for key in KERNELS:
            explicit = key in ("pasm_matmul", "pas_matmul")
            if key == "pas_matmul":
                k_fn = lambda: ops.pas_matmul(x, t, bias=bias, relu=True, pool=case.pool)
                p_fn = lambda: ph.pas_matmul_plain(x, li, t.codebook, bias, relu=True,
                                                   pool=case.pool)
            elif key == "pas_conv":
                k_fn = lambda: ops.pas_conv2d(case.img, t, g, bias=bias, relu=True)
                p_fn = lambda: ph.pas_conv_plain(case.img, li, t.codebook, bias,
                                                 geom=g, relu=True)
            elif explicit:
                k_fn = lambda: ops.pasm_matmul(x, t, bias=bias, relu=True, pool=case.pool)
                p_fn = lambda: pm.pasm_matmul_plain(x, t.idx, t.codebook, bias,
                                                    packed=t.packed, relu=True,
                                                    pool=case.pool)
                l_fn = lambda: torch.matmul(x, w)
            else:
                k_fn = lambda: ops.pasm_conv2d(case.img, t, g, bias=bias, relu=True)
                p_fn = lambda: pm.pasm_conv_plain(case.img, t.idx, t.codebook, bias,
                                                  geom=g, packed=t.packed, relu=True)
                l_fn = lambda: F.conv2d(case.img, kern4, bias, stride=case.conv.stride)
            errs[key] = max(errs[key], max_err(k_fn(), p_fn()))
            ms, plain_ms = time_ms(k_fn), time_ms(p_fn)
            if explicit not in lib:  # one library call per function (K1/K3, K2/K4)
                lib[explicit] = time_ms(l_fn)
            lib_ms = lib[explicit]
            ops_ms, bytes_ms, flops = bound(case, explicit)
            b_ms = max(ops_ms, bytes_ms)
            b_by = "operations" if ops_ms >= bytes_ms else "bytes"
            r = tot[key]
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", b_ms), ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
                r[k] += v
            if key.startswith("pas_"):
                rate = f", {flops / 2 / ms / 1e9:.3f}e12 adds/s"
            else:  # K1 simt / K2: the plan over the same M = batch · P_rows rows
                p = pm.simt_plan(TIME_BATCH * g.P_rows, t.shape[0], t.shape[1],
                                 case.pool)
                rate = (f", plan {p.tile}x{p.cols} tile, {p.splits} splits, "
                        f"{p.blocks} blocks")
            rows.append(f"{key} {ms:.4f} ms (plain {plain_ms:.4f}, library "
                        f"{lib_ms:.4f}, bound {b_ms:.4f} by {b_by}, "
                        f"{flops / ms / 1e9:.1f} TFLOP/s{rate})")
        log(f"  {case.name:<18} " + "\n    ".join(rows) + f" [{card}]")

    lap("phase 5")

    # 6-8. K5, the LM served on K1, K5 on the served attention, timings --------
    k5_phase(gen, errs)
    lm = lm_phase(gen, errs, card)
    k5_rows = lm_timings(lm, gen, card, errs)
    log(f"phase 8(b): K6 at phi3-medium-14b's serving shape ({card})")
    k6 = k6_phase(gen, card)
    lap("phases 6-8")

    # 9. training --------------------------------------------------------------
    train = train_phase(cfg, params, qparams, lm, gen, card)
    lap("phase 9")

    # 10. the MoE family and the vit prefix at full width ------------------------
    del lm["params"]  # qwen3's weights: the card's memory goes to the next models
    torch.cuda.empty_cache()
    moe = moe_phase(gen, errs, card)
    vlm = vlm_phase(gen, errs, card)
    lap("phase 10")

    # 11. the recurrent families at full width and full depth --------------------
    ssm = recurrent_phase("mamba2-130m", 24, gen, errs, card)
    hyb = recurrent_phase("recurrentgemma-2b", 26, gen, errs, card)
    lap("phase 11")

    # 12. the encoder-decoder family at full width and full depth --------------
    wsp = whisper_phase(gen, errs, card)
    lap("phase 12")

    # 13. the sharded CNN at full width --------------------------------------------
    shd = shard_phase(cfg, params, qparams, gen, card)
    lap("phase 13")

    # 14. the sharded LM at full width ---------------------------------------------
    lsh = lm_shard_phase(gen, errs, card)
    lap("phase 14")

    # 15. sharded training -----------------------------------------------------------
    trs = train_shard_phase(cfg, params, gen, card)
    errs["pasm_matmul"] = max(errs["pasm_matmul"], trs["max_abs_err"])
    lap("phase 15")

    # 16. TP for the recurrent and encdec families, the sequence-sharded cache ----
    rsh = rec_shard_phase(gen, errs, card)
    lap("phase 16")

    # 17. sharded training of the MoE, vlm, SSM, hybrid and encdec families -------
    fsh = family_train_shard_phase(gen, errs, card)
    lap("phase 17")

    # 18. the tooling: the examples, the dry run, the roofline terms ------------
    tool = tooling_phase(gen, card)
    tl = tool["launches"]
    lap("phase 18")

    # the kernels line -----------------------------------------------------------
    replaces = {
        "pasm_matmul": "src/repro/kernels/pasm_matmul.py:308",
        "pasm_conv": "src/repro/kernels/pasm_matmul.py:464",
        "pas_matmul": "src/repro/kernels/pas_histogram.py:101",
        "pas_conv": "src/repro/kernels/pas_histogram.py:184",
        "flash_attention": "src/repro/kernels/flash_attention.py:79",
    }
    sl = shd["launches"]
    launches = {"pasm_matmul": counts["kernel"]["pasm_matmul"] + lm["lm"]["pasm_matmul"]
                + TRAIN_K1 + train["qat"]["k1"] + moe["launches"] + vlm["launches"]
                + ssm["launches"] + hyb["launches"] + wsp["launches"] + sl["pasm_matmul"]
                + lsh["launches"] + train["families"]["launches"] + trs["launches"]
                + rsh["launches"] + fsh["launches"] + tl["pasm_matmul"],
                "pasm_conv": counts["kernel_implicit"]["pasm_conv"] + train["qat"]["k2"]
                + sl["pasm_conv"] + tl["pasm_conv"],
                "pas_matmul": counts["pas_kernel"]["pas_matmul"] + sl["pas_matmul"]
                + tl["pas_matmul"],
                "pas_conv": counts["pas_kernel_implicit stages"]["pas_conv"] + sl["pas_conv"]
                + tl["pas_conv"],
                "flash_attention": lm["k5"] + moe["k5"] + vlm["k5"] + hyb["k5"] + wsp["k5"]}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main paths never launched: {launches}")
    csrc = "src/repro_torch/kernels/csrc/"
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # each kernel's routes with their launches on the main paths and times:
    # K1 simt at the AlexNet sums, stream / mma at the LM's M = 4 / 384 sums
    # (warm, plus cold), K5 bf16 and f32 at the qwen3 prefill shape; the
    # served LMs' launches: qwen3, deepseek-moe-16b, internvl2-26b, the
    # recurrent families and whisper-tiny (its stem on simt)
    routes = {k: {"simt": {"source": csrc + k + ".cu", "launches": launches[k]}}
              for k in KERNELS}
    routes["pasm_matmul"]["simt"]["launches"] = (counts["kernel"]["pasm_matmul"]
                                                 + train["qat"]["k1"] + wsp["routes"]["simt"]
                                                 + sl["pasm_matmul"]
                                                 + train["families"]["routes"]["simt"]
                                                 + rsh["routes"]["simt"]
                                                 + fsh["routes"]["simt"]
                                                 + tool["routes"]["simt"])
    routes["pasm_matmul"]["simt"].update(
        {k: tot["pasm_matmul"][k] for k in timed if k != "bound_by"},
        bound_by="operations")
    for r in ("stream", "mma"):
        routes["pasm_matmul"][r] = dict(
            k5_rows["k1"][r], launches=lm["routes"][r] + moe["routes"][r] + vlm["routes"][r]
            + ssm["routes"][r] + hyb["routes"][r] + wsp["routes"][r] + lsh["routes"][r]
            + train["families"]["routes"][r] + trs["routes"][r] + rsh["routes"][r]
            + fsh["routes"][r] + tool["routes"][r] + (TRAIN_K1 if r == "mma" else 0),
            source=csrc + "pasm_matmul_bf16.cu")
    routes["flash_attention"] = {
        dt: dict(k5_rows[dt], launches=launches["flash_attention"] if dt == "bfloat16" else 0,
                 source=csrc + "flash_attention.cu")
        for dt in ("bfloat16", "float32")}
    kernels = []
    for key in ALL_KERNELS:
        if key == "flash_attention":
            r = dict(k5_rows["bfloat16"])
            r["max_abs_err"] = errs[key]
        else:
            r = dict(tot[key], max_abs_err=errs[key])
            r["bound_by"] = "operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes"
        kernels.append({
            "name": key,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{key}.cu",
            "replaces": replaces[key],
            "launches": launches[key],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "routes": routes[key],
        })
    r = k6["closed mix"]
    kernels.append({  # K6 replaces no TPU kernel: JAX decodes with an XLA einsum
        "name": "decode_attention", "route": "cuda", "source": csrc + "decode_attention.cu",
        "replaces": None, "launches": lm["k6"],
        "max_abs_err": max(x["max_abs_err"] for x in k6.values()),
        **{key: r[key] for key in ("ms", "ms_cold", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}})
    log(f"K1-K4 times are sums over the five AlexNet stages at batch {TIME_BATCH} "
        f"(K1's simt route), K5's the qwen3-32b prefill shape (S {K5_TIME_S}, "
        f"causal, bf16); K1's stream / mma routes are the LM's four matrices "
        f"at M = 4 / 384 summed; "
        f"launches are from the serving runs (K1: AlexNet {counts['kernel']['pasm_matmul']} "
        f"+ qwen3 {lm['lm']['pasm_matmul']} + deepseek-moe-16b {moe['launches']} + "
        f"internvl2-26b {vlm['launches']} + mamba2-130m {ssm['launches']} + "
        f"recurrentgemma-2b {hyb['launches']} + whisper-tiny {wsp['launches']} (its "
        f"stem {wsp['routes']['simt']} on simt) + the sharded qwen3 / deepseek of phase "
        f"14 {lsh['launches']} (its (1, 1) run and both ranks) + the sharded recurrent, "
        f"encdec and phi3 calls of phase 16 {rsh['launches']} (the (1, 1) runs and every "
        f"rank; the stem's {rsh['routes']['simt']} on simt); K2, K3), the stage run "
        f"(K4), the "
        f"sharded AlexNet of phase 13 (K1-K4 {sl}, both of its ranks counted), the "
        f"served attention (K5: qwen3 {lm['k5']}, deepseek "
        f"{moe['k5']}, internvl2 {vlm['k5']}, recurrentgemma {hyb['k5']}, whisper-tiny "
        f"{wsp['k5']}) and training "
        f"(K1: one qwen3 step {TRAIN_K1} + the "
        f"frozen QAT AlexNet {train['qat']['k1']} + the recurrent and encoder-decoder "
        f"families' grads {train['families']['launches']} + the sharded qwen3 steps of "
        f"phase 15 {trs['launches']} + the sharded family steps of phase 17 "
        f"{fsh['launches']}; K2: {train['qat']['k2']}) and the tooling of phase 18 "
        f"(the examples and the timed qwen3 steps: {tl}); K6's time is phi3-medium-14b's "
        f"decode attention at the closed chat mix's live lengths (warm; cold beside it), "
        f"its launches the served qwen3's decode calls (kernel and dequant); "
        f"max_abs_err is the largest over every forward check [{card}]")
    log(f"train step at full width: kernel {train['kernel']['ms']:.1f} ms, dequant "
        f"{train['dequant']['ms']:.1f} ms; peak memory {train['kernel']['peak_gb']:.2f} / "
        f"{train['dequant']['peak_gb']:.2f} GB; codebook-gradient sums "
        f"{train['parts']['bins_ms']:.1f} ms a step, lm_head's "
        f"{train['parts']['lm_head']['bins']:.3f} ms [{card}]")
    for (impl, name), t in moe["times"].items():
        log(f"deepseek-moe-16b ({MOE_LAYERS} of 28 layers) {name} on {impl}: "
            f"{fmt_step(t)} [{card}]")
    for arch, r in (("mamba2-130m", ssm), ("recurrentgemma-2b", hyb), ("whisper-tiny", wsp)):
        for (impl, name), t in r["times"].items():
            log(f"{arch} (full depth) {name} on {impl}: {fmt_step(t)} [{card}]")
        t = train["families"][arch]
        log(f"{arch} (full depth) train step on kernel: {t['ms']:.1f} ms, peak "
            f"{t['peak_gb']:.2f} GB; grads vs dequant {t['grad_err']:.2e} of max (held "
            f"to {t['hold']:.4f}) [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
