#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the five CUDA sources
   (one nvcc per source, started together) and prints the build time;
   reads the wgmma routes' (the fp8 GEMM's and flash attention's)
   registers, spills and shared memory from ``-Xptxas -v`` (a spill or a
   note that ptxas serialized their wgmmas fails) and counts HGMMA in
   each library's SASS (``cuobjdump -sass``, where the toolkit has it;
   none fails); reads the tile routes' (the selection's and
   ``gam_quant``'s) registers, spills and shared memory (a spill fails)
   and holds their Eq. 1 division against
   the IEEE division bit for bit (every f32 numerator significand in
   twelve binades against every bf16 divisor significand, at three
   divisor exponents).
2. Holds each kernel against its plain PyTorch version on the same CUDA
   tensors (``backend='torch'``): ``mor_select_pack`` byte for byte on
   inputs that hit every tag (a real layer shape among them, and a block
   whose ideal GAM scale overflows to Inf), on both of its routes (64 x
   64 generic; the ragged shape and the wi view on the 128 x 128 tile
   route), repeats bit-identical, ``mixed_gemm`` within an
   f32-summation-order tolerance on both of its paths (M <= 64 streams,
   larger M takes the tensor cores; ragged tile edges, a padded K, split
   K at K = 14336, packs of every tag, compact lanes, tiny rows with bf16
   denormals), each call checked to take its path.
3. Times both kernels, their plain versions and a library yardstick at
   the shapes the engine gives them (the selection also on a wi view of
   every sub3 tag and under sub4, with the wrapper's host us per call and
   the generic route on the same view); the stream path also at the prefill
   chunk (M = 32), on a wi weight of every sub3 tag and at the f32 head
   (M = 4 x 128256), each with its bytes per second, bound and
   ``torch.matmul`` on the decoded weight.
4. Serves 8 requests through the llama3-8b engine at full width and
   depth 8 (``ENGINE_LAYERS``; it ran all 32 before tp_serve needed
   the room) with sub3-quantized random weights, and checks that every
   GEMM of the run
   went through ``mixed_gemm``'s stream path and every weight through
   ``mor_select_pack``'s tile route (launch counters), never the plain
   versions.
5. Runs a prefill chunk (M = 32) and a decode step (M = 4) at depth 2
   three ways -- kernel path, plain path, GEMMs summed in f64 -- and
   holds every GEMM of the kernel path (all five weight shapes) against
   the plain version on its real inputs at 1e-5 sum|a||b|; the kernel
   path's logits may be at most twice as far from the f64 path's as
   the plain path's are, and fed the plain version's GEMM outputs must
   equal the plain path's bit for bit (every depth-2 serving check
   below follows this rule: ``depth2_three_ways``). A backward through a
   real-quantized (QTensor)
   weight must raise the reference's NotImplementedError.
6. Training: holds ``gam_quant`` (both of its routes: ``tile`` for 128 x
   128 blocks, ``generic`` for others and, through the module's launcher,
   at 128 x 128 too) and ``mor_select(emit='select')`` against their
   plain versions bit for bit (value lanes, exponents and tags; the
   overflowing-scale block too), repeats bit-identical; times them on the
   wi view (``gam_quant`` on both routes, E4M3 and E5M2, every algo)
   and ``mixed_gemm``'s tensor-core path at the training shapes (fwd,
   dgrad, wgrad of wi at 2048 tokens); trains 4-layer,
   full-width llama3-8b for 3 AdamW steps under each of the tensor,
   sub3 and fused-sub3 policies (2 x 1024 tokens a step), checking
   through the launch counters that every quantization event and every
   fused GEMM went through the kernels (the GEMMs through the
   tensor-core path, the selections and ``gam_quant`` through the tile
   route) and none
   through a plain version; profiles one step of each policy (with the
   step's time in the port's kernels); and runs one
   depth-2 step kernel path against plain path (``backend='torch'`` on
   the same CUDA tensors), holding every fused GEMM against the plain
   version on its real inputs.
7. The kernel API (``ops.flash_attention``, ``ops.fp8_gemm``, which no
   model path calls, as in the JAX package): both kernels against their
   plain versions, each on both of its routes, over layouts, offsets,
   dtypes, head dims and blocks (flash with a long row, large scores and
   NaN in the next batch's v; the fp8 GEMM with mixed formats and tiny
   blocks whose scales' product overflows f32), with a bit-identical
   repeat of every call; then, with the counters zeroed just before and
   read just after, flash attention at llama3-8b's heads (the 2 x 1024
   training batch, the 8192 context, a 4-slot prefill chunk against 512
   positions; all three on the wgmma route) and the fp8 GEMM of 2048
   tokens against the four layer weights (all four on the wgmma route),
   each call checked against its plain version and timed beside its
   bound, its route's own ceiling (flash: p v twice; the fp8 GEMM: f16
   MMAs), the cuda_core route's time (flash in f32; the fp8 GEMM at a
   block of that route) and a library call.

8. The compressed training state (``phase_train_state``): nemotron3-8b
   at full width and depth 4, 2 x 1024 tokens a step under
   ``paper_default("sub3")``: (i) dense f32 moments, (ii)
   ``moments=FP8_MOMENTS`` with ``compress_grads="mor"``, (iii)
   FP8_MOMENTS, ``"mor_ef"`` and ``GuardPolicy()``, 3 AdamW steps each,
   and (iv) one step of ``SUB4_V_MOMENTS``; per run the step ms, peak
   GB, the optimizer state's bytes per parameter counted from its
   tensors, the moment and opt metrics and the launch counters (every
   gradient event on the select kernel's f32 instance, every moment
   encode on ``mor_select_pack``, no plain call); then the skip-step of
   (iii) with a NaN embedding row: master, both packed moments, the EF
   residuals and the step counter bit-identical, ``guard_skip`` 1. The
   select kernel's f32 instance (the generic kernel's, at every block)
   is held bit for bit against the plain version in step 6's parity
   phase, timed on the wi view, and held against it on every gradient
   leaf of one more step of run (ii) (the plain version over stripes of
   block rows, at the whole view's group amax).

9. Fault tolerance (``phase_fault_tolerance``): checkpoint/restart and
   the chaos harness. (a) Run (iii)'s compressed state (FP8_MOMENTS,
   'mor_ef', the guard) on granite-moe-1b-a400m at full width and depth
   1 (the phase's time goes to writing, reading and hashing the
   checkpoints' bytes; see ``FT_ARCH``) with the step rebuilt around
   ``make_grad_fault('nan' | 'inf', seed=3)``: an injected batch is
   dropped with every lane of the state bit-identical (per-leaf sha256
   digests), the next clean one is not; then ``Checkpointer.save``, one
   more step at once (it updates the state in place while the writer
   runs), ``wait()``, and a restore into a CPU target of
   ``init_opt_state``'s structure: bit for bit what was saved (GB, the
   seconds ``save`` blocked, write and restore seconds and GB/s). (b)
   ``Trainer`` on the same model with its dense state: an unbroken
   4-step run; a run with ``ckpt_dir`` that sends
   itself SIGTERM during its second step and must leave only
   ``step_2``; a fresh Trainer that resumes there and reaches step 4
   bit-identical to the unbroken run (digests; losses equal). (c) The
   pack faults (payload bit flips, one on an E4M3 NaN code, a NaN
   scale, a 0xFF micro-scale byte) on a wi-shaped sub4 pack of every
   tag through ``ops.mixed_dot`` on the stream path (M = 4) and the tc
   path (M = 2048) against the plain version: the same nonfinite
   positions, finite values within ``gemm_tol``; ``stale_amax`` through
   ``requantize_with_backoff`` on the wi view (plain PyTorch in both
   packages), CUDA against CPU; a trashed KV page in the llama3-8b
   engine (depth 4, 3 slots): the victim quarantined, the other
   requests' tokens bit-identical. (d) The checkpoint directories
   (``build/ckpt``) are removed at the end, also on a failure. (e) The
   head's forward on the tensor cores (``HeadMatmul``) against the f32
   product at ``gemm_tol`` and its backward bit for bit against the old
   expression, at llama3-8b's and nemotron3-8b's vocabularies, with both
   forwards timed.

10. The generic routes' shared memory (``phase_generic_smem``): the
   static shared bytes of each generic kernel as the card reports them
   within the host's bound; each generic instance (pack, select bf16
   and f32, ``gam_quant``; sub3 and sub4) at the gradient compression's
   blocks at d 64 and at the 48 KB boundary ((128, 192) bf16, (128, 96)
   f32), one row of blocks and a ragged operand, against its plain
   version; one compressed-state step ('mor_ef', ``GuardPolicy()``) of
   reduced nemotron3-8b (d 64) on the card, every f32 select launching.

11. The serving tiers (``phase_serve_tiers``), llama3-8b at full width
   with sub3 QTensor weights, each tree quantized once: (a) at depth 4
   (``SERVE_TIER_LAYERS``) the engine on bf16, kv_fp8, kv_mor and kv_mor
   + kv_mor_cold=64 + kv_guard pools (phase_engine's 8 requests and one
   of 300 + 32 tokens): every GEMM on the stream path, bytes per token
   16,384 / 8,448 / 8,512 / 8,512 (4,096 / 2,112 / 2,128 a layer), pages
   sealed and every sealed slab equal to the CPU's
   ``recompress_kv_nvfp4`` of its hot lanes, step and chunk ms, tokens/s,
   peak GB, the pool's census and the share of tokens equal to the bf16
   run's; (b) layer 0's fp8 and MoR lanes written on the card equal to
   ``quantize_kv`` / ``quantize_kv_mor`` on the CPU on the bf16 run's
   rows, bit for bit (at depth 4 too); (c) at depth 4 as well (full
   depth before tp_serve), ``make_prefill_fn`` on a 2048-token prompt
   with all 4L + 1 GEMMs on the tc path, that prompt served through
   ``_full_prefill`` into a kv_mor pool beside the chunked engine, and a
   depth-2 512-token prefill three ways (step 5's rule); (d)
   the KV-page guard on a trashed page of a MoR and an fp8 pool (4
   layers, 3 slots), beside clean runs: under fp8 the other slots'
   tokens bit-identical; under MoR, whose quantize_kv_mor groups every
   row of a decode step (as the reference's does), those sampled before
   the catching step.

12. The model zoo (``phase_model_zoo``): the MoE family and gemma-2b.
   (a) granite-moe-1b-a400m at full width (32 experts, top-8) and 4 of
   its 24 layers (``GRANITE_LAYERS``) served by the Engine with sub3
   QTensor attention
   weights (the expert stacks and routers stay dense, as in the
   reference) on bf16 and kv_mor pools, phase_engine's 8 requests: every
   attention GEMM on the stream path, every expert event on gam_quant,
   no selection, no plain call, bytes per token 8,192 / 4,416 (49,152 /
   26,496 at full depth), step
   and chunk ms, tokens/s, peak GB, a profiled decode call with its ATen
   operators and launches, each layer's dropped share and aux_loss in a
   prefill chunk;
   then 3 AdamW steps of 2 x 1024 tokens under sub3 and fused sub3:
   finite loss, grad norm and aux_loss > 0, the total equal to loss +
   0.01 aux_loss, the router bf16 after the first step, every event and
   fused GEMM on the kernels. (b) moonshot-v1-16b-a3b at full width and
   depth 2 (``MOONSHOT_LAYERS``): 4 requests on a bf16 pool (16,384
   bytes per token) and one sub3 step. (c) gemma-2b at 6 of its 18
   layers (``GEMMA_LAYERS``; full depth before tp_serve) on bf16 and
   kv_mor pools (6,144 / 3,132 bytes per token; 18,432 / 9,396 at full
   depth), every GEMM but the tied head on the stream path. (d)
   ``moe_sublayer`` alone at granite's width on 2 x 1024 and 4 x 1 inputs, forward and one
   backward, under the tensor recipe, sub3 and fused sub3: kernel path
   against plain path bit for bit (the relative-error lanes within
   1e-6); fused, every expert GEMM (tc at 2 x 1024, stream at 4 x 1)
   held against the plain version and the path bit for bit against
   plain quantizers with the kernel GEMMs. One layer's expert GEMMs at
   decode timed as the stack and as a loop of E mor_dots. granite at
   depth 2 three ways (kernel, plain, f64 GEMMs), every mixed GEMM held
   against the plain version, phase_depth2's 2x rule gated with the
   experts' activation events off; with them on too, the kernel path
   fed the plain GEMM outputs must equal the plain path (under the
   engine's policy the expert stacks whose inputs moved are reported),
   with the share
   of routing decisions the kernel and plain paths share.

13. The frontend families (``phase_frontends``), sub3 QTensor weights
   quantized once (every pack on the tile route), served through
   ``make_prefill_fn`` and then greedy ``make_decode_fn`` steps (the
   engine refuses both families, as the reference's does), and trained
   3 AdamW steps each under sub3 and fused sub3 (finite loss and grad
   norm, every event and fused GEMM on the kernels, the tile route and
   the tc path). (a) paligemma-3b at full width (256 stub patch
   embeddings before the tokens, attending bidirectionally), served at
   6 of its 18 layers (``FRONT_SERVE_LAYERS``): 4 requests of a 128-token
   prompt (4 x 384 prefill rows on the tc path), 32 decode steps (M = 4,
   stream path) on a bf16 and a kv_mor cache (6,144 / 3,132 bytes per
   token; 18,432 / 9,396 at full depth); trained at 6 of its 18 layers
   (``FRONT_TRAIN_LAYERS``) on 2 x (256 + 1024) positions. (b)
   whisper-tiny at full width and depth (4 encoder and 4 decoder layers,
   1500 stub frames): 8 requests of a 32-token prompt, 64 decode steps on the bf16 cache (6,144 bytes per
   token); every GEMM of a full prefill held against the plain version
   at M = 12000 (the encoder's and the cross K/V's, 93.75 blocks of 128)
   on the tc path; the quantized KV tiers refused by name; training on 8
   x 1500 frames by 448 tokens. (c) Each family at depth 2 three ways
   (kernel, plain, f64 GEMMs): a prefill of 4 requests of the main
   path's prompt and a decode step, every mixed GEMM held against the
   plain version, phase_depth2's rule, and the kernel path fed the plain
   GEMM outputs equal to the plain path. (d) Each family at depth 2 on
   the main path's training batch, as step 6's depth-2 step: sub3
   kernel path against plain path (loss, stats rows, gradients); fused
   sub3 with every forward, dgrad and wgrad GEMM held against the plain
   version (whisper's wgrads contracting over the 12000 ragged rows).

14. The recurrent families (``phase_recurrent``), full width and depth
   (hymba-1.5b: 32 layers of sliding-window attention beside the mamba
   mixer; xlstm-350m: 12 units of an mLSTM and an sLSTM layer), random
   seeded weights: (a) served by the Engine (``zoo_serve``) with sub3
   QTensor weights (193 / 72 packs, all ``tile``; the mixers' plain
   leaves dense) on a bf16 pool (4 slots, max_seq 512, one-shot
   prefill) with 8 staggered requests of 32-300 prompt tokens and 32
   new ones: admissions while other slots decode, every GEMM on
   mixed_gemm (the tc path for a prefill of M > 64), no activation
   quantizer launch, no plain call, bytes per token 40,960 / 0 and
   state bytes per slot 7,168,000 / 50,626,752 exactly, the decode
   step's and each prefill's ms, a profiled decode call, the host
   seconds inside the prefills' scans; (b) two AdamW steps on one state
   (``train_run``), 2 x 128 tokens each, at a quarter of the depth
   (``REC_TRAIN_LAYERS``: hymba 8 of 32 layers, xlstm 3 of 12 units)
   under sub3 and fused sub3, and
   at depth 2 one under the tensor recipe (profiled: device ms and idle
   share): every event and fused GEMM on the kernels, each step's ms,
   peak GB and the host ms inside its scans; (c) each family at depth
   2: every weight pack equal to the plain version's, bit for bit; a
   prefill (hymba 2560 tokens, its window masking; xlstm 512) and 4
   decode steps three ways; training on the main path's batch under the
   tensor recipe and sub3, kernel path against plain path, with the
   fused GEMMs held to the plain version.

15. Mesh-aware statistics (``phase_multi_device``, after step 6's
   depth-2 step): the script starts MD_WORLD = 4 processes of itself
   (``--multi-device-rank``) on cuda:0, a gloo world through a
   ``file://`` store (NCCL refuses two ranks on one device), the
   kernels built by this process and only loaded by the ranks. (a)
   ``mor_dot`` at llama3-8b's training wi shape (x 2048 x 4096 sharded
   4 x 512 by rows, dy to match, w 4096 x 28672 replicated) under the
   tensor recipe, sub3 and fused sub3 with ``with_mesh_axes``, against
   the one-rank run of the global batch on the card: y and dx bit for
   bit, the ranks' dw summed within the bf16 roundings' bound
   (``md_dw_bound``: 2^-8 of the partials' and the one-rank dw's
   magnitudes, + 1e-5; it must refuse the sum without a rank), every stats
   row bit for bit but rel_err (rtol 2e-6), every fused pack's lanes
   equal to the one-rank pack's rows. (b) gemma-2b at full width (depth
   2, or 1 where the per-rank memory reckoning leaves under 10 GB of the
   card free), 1 x 1024 tokens a rank: two steps of ``make_train_step(
   TrainConfig(mor_mesh_axes=('data',)))`` on each rank, every forward
   quantization event of the first held against the one-rank
   quantization of the same global operand (the activation's shards
   gathered), and its stats rows compared with the one-rank step's on
   the global 4 x 1024 batch (counted: cuBLAS sums a GEMM of 4096 rows
   in another order than one of 1024); the second step timed beside the
   one-rank step, with the collectives a step and their host seconds;
   then kernel path against
   plain path on the four ranks (``train_depth2`` on the mesh). (c) A
   NaN in one rank's shard: every rank's amax and guard lanes equal the
   one-rank run's, and ``pmax_over`` is NaN on every rank. (d) The
   cross-pod compressed sum (``md_pod_psum``) at (b)'s width and depth on
   a (pod 2, data 2) mesh: each pod's sub3 gradients of its half of the
   batch, a rank's rows of every leaf that splits into whole 128-row
   blocks (the others whole), ``make_pod_compressed_psum('pod', sub3,
   inner_axes=('data',))`` over every leaf: the shipped lanes bit for
   bit the one-rank pack of the pod's whole leaf, the sum bit for bit
   the one-rank decodes' sum, the kernel path bit for bit the plain
   path; the flat path on the largest leaf; wire bytes per gradient
   element, collectives, seconds. (e) Elastic restore (``md_elastic``):
   rank 0 saves (b)'s params with ``Checkpointer``; every rank restores
   them with ``shardings=`` on ``make_elastic_mesh`` over ranks [0, 1,
   2, 3] (2 x 2) and [0, 1, 2] (1 x 2), and through ``elastic_restore``
   on [0, 1, 2] (1 x 3), each leaf bit for bit its block of the redrawn
   params; restore seconds and host peak memory. The card's memory is
   checked against ``launch.mesh.HW.HBM_BYTES``.

16. Tensor-parallel serving (``phase_tp_serve``, after
   ``multi_device``, on its rank machinery): llama3-8b at full width and
   depth 8 (``TP_DEPTHS``: the first the per-rank memory reckoning
   allows; every rank draws and quantizes the global params before it
   cuts them), sub3 weights, a (data 1, model 4) mesh of TP_WORLD = 4
   gloo ranks on cuda:0 (``--tp-serve-rank``); then short runs of
   gemma-2b (the tied head of a vocab-sharded embedding) and
   deepseek-coder-33b (a cut quantized head; mlp/wo left whole), at
   ``TP_EXTRA``'s depths. Two one-rank Engines per run go first, in this
   process, and are freed: the plain one, and one whose row-parallel
   weights sum four K quarters in f32 in rank order (``tp_emulated``),
   which computes what the ranks compute. (a) Layer 0's four GEMMs and
   the head on the same replicated inputs (M = 4 and 512) against the
   one-rank GEMM on the card: wqkv and mlp/wi (column-parallel) bit for
   bit, which gates the planning of a shard's split of K by the whole
   product (``mixed_gemm_blocks``' ``_plan``), and the head, which the
   rules leave whole at 4 ranks (1002 row blocks), too; wo and mlp/wo
   (row-parallel) within one bf16 ulp + 2^-20 sum |x||w|
   (``tp_row_bound``). (b) Engine(mesh=), 4 slots, 8 requests of 32-300
   prompt tokens and 16 new ones (the extra runs: 4 of 32-96 and 8):
   every rank's logits bit for bit the other ranks' (digests of every
   model call), every sampled row and token bit for bit the emulated
   engine's; against the plain engine each row within TP_LOGIT_BOUND of
   its max |logit| and the token equal where the top-2 margin exceeds
   that bound (near-ties counted); one collective a cut weight of a
   layer, plus the embedding's and a cut head's, a decode call. (c) A
   512-token one-shot prefill through ``make_prefill_fn`` on the cut
   weights (the tc path): every layer's K/V and the logits bit for bit
   the emulated prefill's, the logits against the plain one by (b)'s
   bound; a control with layer 1's wo reading layer 2's blocks must
   keep layers 0-1's K/V, change every later layer's and fail the
   bound. (d) A rank's weight bytes: a quarter of the one-rank QTensor
   bytes beside the lanes every rank holds whole, exactly; no live bf16
   tensor of a quantized weight's shape. The line gives each check, the
   decode step's ms on 4 ranks and on one, the collectives a decode
   call and their host seconds, and weight GB a rank.

Prints JSON lines (the ``kernels``, ``engine``, ``serve_tiers``,
``model_zoo``, ``frontends``, ``recurrent``, ``train``, ``train_state``,
``fault_tolerance``, ``generic_smem``, ``kernel_api``,
``multi_device`` and ``tp_serve`` lines among them) and ends with
``{"ok": true, "device":
...}``. Exits non-zero on any failure, without a card, or without the
rest of the repository beside it.
"""
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# The card's roofline constants, defined once (the port's launch.mesh.HW;
# without the rest of the repository beside it the script stops here).
from repro_torch.launch.mesh import HW  # noqa: E402

HBM_BYTES_PER_S = HW.HBM_BW
BF16_FLOPS = HW.PEAK_FLOPS_BF16
FP8_FLOPS = HW.PEAK_FLOPS_FP8
N_LAYERS = 32                 # llama3-8b depth; cut only if time forces it
# The engine phase (item 4) at depth 8 (32 before):
# host-paced (the card idle ~0.9 of a decode call), its time scales with
# depth, and every check it makes (launch counts per layer, paths,
# routes, tokens) holds at any depth; tp_serve needed the room.
ENGINE_LAYERS = 8
# The serving tiers' engine runs (phase_serve_tiers (a), (b)) at depth 4
# (8 before tp_serve's checks grew, 32 before that): they are host-paced
# (the card idle ~0.92 of a decode step), so their time scales with
# depth, and every check they make (lanes, tokens, census, sealing, bytes
# per token) holds at any depth; the script's 1,200 s limit needs the
# room. The 2048-token prefill and the one-shot against chunked prefill
# at the same depth (full depth before tp_serve), their checks too.
SERVE_TIER_LAYERS = 4
# Training: depth cut to 4 layers because the AdamW state (bf16 params,
# f32 master and two f32 moments, bf16 grads, ~18 B/param) of all 32
# layers (~135 GB) does not fit the 80 GB card; 4 layers and the
# untied embedding and head are 1.92 B params, ~35 GB of state.
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 3
# The compressed-state phase: nemotron3-8b at depth 4 for every run (the
# dense-state run fits the 80 GB card there: 2.90 B params, ~16 B/param
# of params, grads, master and moments, the optimizer updating in place).
STATE_LAYERS = 4
ALGOS = ("gam", "e8m0", "fp32_amax")
# Block of the parity operands whose ideal GAM scale overflows (values
# ~1e-37); the NaN and Inf sit in other blocks.
TINY_AT = (0, 1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def select_inputs(ops, x):
    """The selection kernels' prologue of one operand in 128 x 128
    blocks (gam): (padded x, the (4,) kernel scalars)."""
    xp, _, mg = ops._kernel_inputs(x[None], (128, 128), ops.SELECT_FORMATS,
                                   "gam")
    return xp[0], mg[0]

def mixed_tags(shape, seed=0, bf16_blocks=True, dtype=torch.bfloat16):
    """Operand whose blocks hit every tag: normal rows (E4M3), rows of
    huge (BF16) and moderate (E5M2) dynamic range, rows on a
    micro-scaled E2M1 grid (NVFP4 under sub4), single-element outliers
    and an all-zero stripe. ``bf16_blocks=False`` leaves out the huge
    range and the outliers, so no block needs BF16. In f32 (``dtype``)
    the values are the f64 draws rounded once to f32, not bf16-exact."""
    rng = np.random.default_rng(seed)
    m, k = shape
    kp = -(-k // 16) * 16
    x = rng.standard_normal((m, kp))
    q = max(m // 4, 1)
    h = kp // 2 if bf16_blocks else 0
    x[q:2 * q, :h] *= np.exp2(rng.integers(-20, 20, (q, h)))
    # Moderate range, magnitudes kept off zero so the Eq. 4 gate passes.
    x[q:2 * q, h:] = np.sign(x[q:2 * q, h:]) * rng.uniform(
        1, 2, (q, kp - h)) * np.exp2(rng.integers(-12, 4, (q, kp - h)))
    grid = np.array([0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0])
    mm = grid[rng.integers(0, 7, (q, kp))] * np.exp2(
        rng.integers(-9, 9, (q, kp // 16))).repeat(16, axis=1)
    x[2 * q:3 * q] = mm * np.where(rng.standard_normal((q, kp)) > 0, 1, -1)
    if bf16_blocks:
        rows = rng.integers(0, q, 8)
        x[rows, rng.integers(0, kp, 8)] *= 1e4  # outliers in normal blocks
    x[-max(m // 8, 1):] = 0.0
    return torch.from_numpy(x[:, :k].astype(np.float32)).to(dtype)


def add_tiny_block(x, block, at, seed=0):
    """Fill block ``at`` (a block-grid index) of the CUDA operand ``x``
    with sign * U(1, 2) * 1e-37 and four denormals (in x's dtype): the
    block's ideal GAM scale q_amax / amax overflows f32 to +Inf for every
    format, which the kernels' Alg. 1 bit arithmetic must split as the
    plain version's frexp does (exponent -1)."""
    rng = np.random.default_rng(seed)
    r0, c0 = at[0] * block[0], at[1] * block[1]
    r1, c1 = min(r0 + block[0], x.shape[0]), min(c0 + block[1], x.shape[1])
    h, w = r1 - r0, c1 - c0
    t = np.where(rng.standard_normal((h, w)) > 0, 1.0, -1.0) * rng.uniform(
        1, 2, (h, w)) * 1e-37
    t[0, :4] = [1e-39, -2e-39, 5e-40, -9e-41]
    x[r0:r1, c0:c1] = torch.from_numpy(t.astype(np.float32)).to(
        x.dtype).to(x.device)
    return x


def time_ms(fn, iters=10):
    """Mean device time of one call (CUDA events around ``iters`` calls
    after a warm-up)."""
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


_CAPTURE = []


def device_ms(fn, iters=20):
    """Mean device time of one call with no host in between: ``iters``
    calls captured in a CUDA graph, CUDA events around its replay. The
    stream path's kernels take less time than their Python wrapper, so
    eager launches (``time_ms``) would time the host."""
    fn()
    torch.cuda.synchronize()
    if not _CAPTURE:
        _CAPTURE.append(torch.cuda.Stream())
    side = _CAPTURE[0]  # one stream: libraries keep a workspace per stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_us(fn, iters=50):
    """Host wall time of one eager call (no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


def assert_pack_equal(mo_k, mo_t, r_k, r_t, what):
    for lane in ("payload_q", "payload_bf16", "payload_nib",
                 "micro_scales", "tags", "scales"):
        a, b = getattr(mo_k, lane), getattr(mo_t, lane)
        if a.dtype in (torch.bfloat16, torch.float32):
            a, b = a.view(torch.int16 if a.dtype == torch.bfloat16
                          else torch.int32), \
                b.view(torch.int16 if b.dtype == torch.bfloat16
                       else torch.int32)
        check(a.shape == b.shape and torch.equal(a, b),
              f"{what}: lane {lane} differs from the plain version")
    for f in ("e4_sums", "e5_sums", "nv_sums"):
        a, b = getattr(r_k, f), getattr(r_t, f)
        if a is None and b is None:
            continue
        check(torch.allclose(a, b, rtol=1e-5, atol=0.0, equal_nan=True),
              f"{what}: {f} beyond rtol 1e-5")
    check(torch.equal(r_k.counts, r_t.counts), f"{what}: counts differ")


def phase_mor_select(ops, Partition):
    """Kernel vs plain version of the pack-emitting selection, each call
    checked to take the route its block names (64 x 64: generic; the
    ragged 200 x 136 and the wi view at 128 x 128: tile)."""
    from repro_torch.kernels.mor_select import (mor_select_pack,
                                                mor_select_route)
    cases = [((256, 384), (64, 64), 1), ((200, 136), (128, 128), 2),
             ((28672, 4096), (128, 128), 3)]  # the last: the wi view
    want = {"sub2": {0, 2}, "sub3": {0, 1, 2}, "sub4": {0, 1, 2, 3}}
    seen = {mode: set() for mode in want}
    max_err = 0.0
    for shape, block, seed in cases:
        x = mixed_tags(shape, seed).cuda()
        x[5, 7] = float("nan")
        x[shape[0] // 2 + 3, shape[1] - 9] = float("inf")
        add_tiny_block(x, block, TINY_AT, seed)
        for mode in ("sub2", "sub3", "sub4"):
            align = (2, 16) if mode == "sub4" else (1, 1)
            part = Partition("block", block, align=align)
            route = mor_select_route(block, mode)
            before = mor_select_pack.launches_by_route[route]
            mo_k, r_k = ops.quantize_pack(x, part, mode, backend="cuda")
            mo_t, r_t = ops.quantize_pack(x, part, mode, backend="torch")
            torch.cuda.synchronize()
            what = f"mor_select_pack {shape} {mode}"
            check(mor_select_pack.launches_by_route[route] == before + 1,
                  f"{what}: not launched on the {route} route")
            assert_pack_equal(mo_k, mo_t, r_k, r_t, what)
            mo_2, r_2 = ops.quantize_pack(x, part, mode, backend="cuda")
            assert_pack_equal(mo_2, mo_k, r_2, r_k, what + " repeat")
            for f in ("e4_sums", "e5_sums", "nv_sums"):
                a, b = getattr(r_2, f), getattr(r_k, f)
                check(a is None or torch.equal(bits16(a), bits16(b)),
                      f"{what}: repeated {f} not bit-identical")
            tags = set(np.unique(mo_t.tags.cpu().numpy()).tolist())
            seen[mode] |= tags
            d = (mo_k.dequant().float() - mo_t.dequant().float()).abs()
            max_err = max(max_err, float(d.nan_to_num(0.0).max()))
            emit({"parity": "mor_select_pack", "shape": list(shape),
                  "block": list(block), "mode": mode, "route": route,
                  "repeat_bit_identical": True,
                  "tags": sorted(tags), "tiny_block": list(TINY_AT),
                  "tiny_block_tag": int(mo_t.tags[TINY_AT]),
                  "identical": True})
    for mode, tags in want.items():
        check(tags <= seen[mode], f"mor_select_pack {mode}: tags "
              f"{sorted(seen[mode])} miss some of {sorted(tags)}")
    return max_err


def tiny_rows(shape, seed=0):
    """(M, K) bf16 CUDA activation, tiny in every k block: the first half
    of the rows sign * U(1, 2) * 1e-37 with every eighth element a bf16
    denormal, the second half all bf16 denormals (sign * U(1, 2) *
    5e-39). Against a B of magnitude ~1 a product of a denormal keeps
    every bit in f32, and a path that flushed denormals would lose the
    whole result of a denormal row, far beyond ``gemm_tol``."""
    rng = np.random.default_rng(seed)
    m, k = shape
    sign = np.where(rng.standard_normal((m, k)) > 0, 1.0, -1.0)
    x = sign * rng.uniform(1, 2, (m, k)) * 1e-37
    x[:, ::8] *= 5e-2
    x[m // 2:] = sign[m // 2:] * rng.uniform(1, 2, (m - m // 2, k)) * 5e-39
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).cuda()


def phase_mixed_gemm(ops, ref, Partition):
    """Kernel vs plain version of the mixed GEMM on both paths (M <= 64
    streams, larger M takes the tensor cores), on packs that mix every
    tag and compact lanes, ragged tile edges and a padded K, and tiny
    rows with bf16 denormals; f32 and bf16 output, within ``gemm_tol``.
    Each call must take the path its M names. Returns the largest
    err / tol of each path."""
    from repro_torch.kernels.mixed_gemm import gemm_path, mixed_gemm_blocks

    def pack(x, mode, block=(128, 128)):
        align = (2, 16) if mode == "sub4" else (1, 1)
        mo, _ = ops.quantize_pack(x, Partition("block", block, align=align),
                                  mode, backend="cuda")
        return mo.compact()

    K = 4096
    b_mixed = pack(mixed_tags((1024, K), 4).cuda(), "sub4")
    b_fp8 = pack((torch.randn(2048, K, device="cuda") * 0.02).to(
        torch.bfloat16), "sub3")  # all E4M3: bf16 and NVFP4 lanes compact
    check(tuple(b_fp8.payload_bf16.shape) == (128, 128),
          "the all-E4M3 pack should have a compact bf16 lane")
    b_nobf = pack(mixed_tags((1024, K), 6, bf16_blocks=False).cuda(),
                  "sub4")  # E4M3/E5M2/NVFP4, bf16 lane compact
    check(tuple(b_nobf.payload_bf16.shape) == (128, 128) and len(
        np.unique(b_nobf.tags.cpu().numpy())) == 3,
        "the no-BF16 sub4 pack should mix three tags, bf16 lane compact")
    a_mixed = pack(mixed_tags((256, K), 5).cuda(), "sub4")
    # The stream path's other weight paths: a sub3 pack mixing E4M3, E5M2
    # and BF16 blocks, and K = 14336 (split K) at a ragged N.
    b_mix3 = pack(mixed_tags((1024, K), 9).cuda(), "sub3")
    check({0, 1, 2} <= set(np.unique(b_mix3.tags.cpu().numpy())),
          "the mixed sub3 pack should hold E4M3, E5M2 and BF16 blocks")
    b_long = pack((torch.randn(1000, 14336, device="cuda") * 0.02).to(
        torch.bfloat16), "sub3")
    cases = []
    for M in (1, 4, 16, 32, 64, 65, 128, 129, 200):
        x = torch.randn(M, K, device="cuda").to(torch.bfloat16)
        for label, b in (("4 tags", b_mixed), ("no BF16", b_nobf),
                         ("all E4M3", b_fp8), ("E4M3/E5M2/BF16", b_mix3)):
            if label == "E4M3/E5M2/BF16" and M > 64:
                continue
            a = ref.passthrough_mixed(
                x, (ref.activation_row_block(M, 128), 128))
            cases.append((f"passthrough M={M} x {label} N={b.shape[0]}",
                          a, b))
    for M in (4, 32):
        x = torch.randn(M, 14336, device="cuda").to(torch.bfloat16)
        cases.append((f"passthrough M={M} x all E4M3 N=1000 K=14336 "
                      "(split K)", ref.passthrough_mixed(
                          x, (ref.activation_row_block(M, 128), 128)),
                      b_long))
    cases.append(("mixed A (sub4) x mixed B (sub4)", a_mixed, b_mixed))
    cases.append(("mixed A (sub4) M=64 x mixed B (sub4)",
                  pack(mixed_tags((64, K), 15).cuda(), "sub4"), b_mixed))
    cases.append(("mixed A (sub3) M=300 x mixed B (sub3) N=1000 K=4000",
                  pack(mixed_tags((300, 4000), 7).cuda(), "sub3"),
                  pack(mixed_tags((1000, 4000), 8).cuda(), "sub3")))
    b_unit = pack(torch.randn(384, K, device="cuda").to(torch.bfloat16),
                  "sub3")
    cases.append(("tiny passthrough A M=200 (bf16 denormals) x all E4M3 "
                  "N=384", ref.passthrough_mixed(tiny_rows((200, K)),
                                                 (128, 128)), b_unit))
    # The stream path on the same rows: against unit weights and against
    # 0.02-scale ones, where some results are bf16 denormals.
    for M in (4, 32, 64):
        a = ref.passthrough_mixed(tiny_rows((M, K)),
                                  (ref.activation_row_block(M, 128), 128))
        for label, b in (("unit", b_unit), ("0.02-scale", b_fp8)):
            cases.append((f"tiny passthrough A M={M} (bf16 denormals) x all "
                          f"E4M3 {label} N={b.shape[0]}", a, b))
    worst = {"stream": 0.0, "tc": 0.0}
    for name, a, b in cases:
        A = ref.decode_mixed_ref(a)[:a.shape[0]]
        B = ref.decode_mixed_ref(b)[:b.shape[0]]
        path = gemm_path(a.shape[0])
        row = {"parity": "mixed_gemm", "case": name, "path": path}
        for out_dtype in (torch.float32, torch.bfloat16):
            n0 = mixed_gemm_blocks.launches_by_path[path]
            ck = ops.mixed_gemm(a, b, out_dtype=out_dtype, backend="cuda")
            check(mixed_gemm_blocks.launches_by_path[path] == n0 + 1,
                  f"mixed_gemm {name}: did not take the {path} path")
            ct = ops.mixed_gemm(a, b, out_dtype=out_dtype, backend="torch")
            err = (ck.float() - ct.float()).abs()
            tol = gemm_tol(A, B, ct, out_dtype)
            check(bool(torch.all(err <= tol)),
                  f"mixed_gemm {name} {out_dtype}: max err "
                  f"{float(err.max())} beyond tolerance")
            dt = str(out_dtype).split(".")[-1]
            row[f"max_err_over_tol_{dt}"] = float(torch.where(
                err > 0, err / tol, torch.zeros_like(err)).max())
            if out_dtype == torch.float32:
                # Three ways: kernel and plain version against the sum in
                # f64, each as a share of sum |a||b|.
                e = A.double() @ B.double().T
                sab = (A.double().abs() @ B.double().abs().T).clamp_min(
                    1e-300)
                for who, y in (("kernel", ck), ("plain", ct)):
                    row[f"{who}_vs_f64_over_sum_ab"] = float(
                        ((y.double() - e).abs() / sab).max())
                del e, sab
        worst[path] = max(worst[path], row["max_err_over_tol_float32"],
                          row["max_err_over_tol_bfloat16"])
        emit({**row, "ok": True})
    return worst


def bound(nbytes, flops, peak=BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def weight_bytes(mo):
    """Bytes a GEMM must read of a packed weight: each block's named lane
    only (fp8 1 B/elt, BF16 2 B/elt, NVFP4 0.5 + 1/16 B/elt) plus the
    tag and scale grids."""
    counts = np.bincount(mo.tags.reshape(-1).cpu().numpy(), minlength=4)
    per_block = mo.block[0] * mo.block[1]
    bpe = np.array([1.0, 1.0, 2.0, 0.5625])
    return float((counts[:4] * bpe).sum() * per_block + mo.tags.numel() * 8)


def selection_rows(ops, ref, Partition, variant, w):
    """One selection kernel (``variant``: "pack" or "select") on the wi
    view: the tile route on the random weights ``w`` under sub3 (the
    kernels line's row) and sub4, and on a wi view of every sub3 tag
    (``mixed_tags``) under sub3 and sub4; then the generic route on the
    random sub3 view (the previous design, timed only: no caller reaches
    it at this block). Each row: device ms (CUDA events around 20 eager
    calls), the wrapper's host us per call, ``device_ms`` from a replayed
    CUDA graph where the host time per call comes within 2x of the
    kernel's, the byte bound, the tags, and the outputs held bit for bit
    against the plain version."""
    from repro_torch.kernels.mor_select import (_launch, mor_select_pack,
                                                mor_select_select)
    fn = mor_select_pack if variant == "pack" else mor_select_select
    part = {m: Partition("block", (128, 128),
                         align=(2, 16) if m == "sub4" else (1, 1))
            for m in ("sub3", "sub4")}
    n, nblk = w.numel(), w.numel() // (128 * 128)
    wm = mixed_tags(tuple(w.shape), 3).cuda()
    rows = {}
    for label, x, mode in (("sub3", w, "sub3"), ("sub4", w, "sub4"),
                           ("sub3_mixed_tags", wm, "sub3"),
                           ("sub4_mixed_tags", wm, "sub4")):
        xp, mg = select_inputs(ops, x)
        if variant == "pack":
            mo_k, r_k = ops.quantize_pack(x, part[mode], mode, backend="cuda")
            mo_t, r_t = ops.quantize_pack(x, part[mode], mode,
                                          backend="torch")
            assert_pack_equal(mo_k, mo_t, r_k, r_t,
                              f"mor_select_pack timing {label}")
            tags = mo_t.tags
            # x read once; payload_q and the bf16 lane (sub4: nibbles and
            # micro scales too) written; tag, scale, sums, count per block.
            lanes = 3.0 + (0.5 + 1.0 / 16 if mode == "sub4" else 0.0)
        else:
            k = ops.mor_select(x, part[mode], mode, backend="cuda")
            t = ops.mor_select(x, part[mode], mode, backend="torch")
            check(torch.equal(bits16(k.y), bits16(t.y))
                  and torch.equal(k.sel, t.sel),
                  f"mor_select_select timing {label} differs")
            tags = t.sel
            lanes = 2.0  # y
        b = bound((2.0 + lanes) * n + (28 if mode == "sub4" else 24) * nblk,
                  0.0)

        def call():
            return fn(xp, mg, block=(128, 128), mode=mode)
        row = {"ms": time_ms(call, iters=20), "host_us": host_us(call),
               "bound_ms": b[0], "bound_by": b[1],
               "tags": np.bincount(tags.reshape(-1).cpu().numpy(),
                                   minlength=4).tolist()}
        if row["host_us"] * 1e-3 * 2 >= row["ms"]:
            row["device_ms"] = device_ms(call)
        rows[label] = row
    # The generic route on the same view, through the module's launcher
    # (timing only; mor_select_route sends every 128 x 128 call to tile).
    xp, mg = select_inputs(ops, w)
    outs = fn(xp, mg, block=(128, 128), mode="sub3")
    t = {"x": xp, "mg": mg, **outs}
    keys = (("x", "mg", "payload_q", "payload_bf16", "sel", "scales",
             "e4_sums", "e5_sums", "counts", "nv_sums", "payload_nib",
             "micro_scales") if variant == "pack" else
            ("x", "mg", "y", "sel", "scales", "e4_sums", "e5_sums", "counts",
             "nv_sums"))
    tensors = tuple(t.get(k) for k in keys)
    rows["generic_route_sub3_ms"] = time_ms(lambda: _launch(
        variant, "generic", tensors, 1, *xp.shape, (128, 128), "sub3",
        "gam", xp.device), iters=20)
    del wm
    return rows


def phase_timing(ops, ref, Partition, cfg):
    """Kernel, plain and library times at the engine's shapes: the
    quantization of the wi weight view and the decode GEMM against it."""
    from repro_torch.kernels.mixed_gemm import mixed_gemm_blocks
    d, f = cfg.d_model, cfg.d_ff
    w = (torch.randn(2 * f, d, device="cuda") * 0.02).to(torch.bfloat16)
    part = Partition("block", (128, 128))
    shapes = selection_rows(ops, ref, Partition, "pack", w)
    sel_k = shapes["sub3"]["ms"]
    sel_t = time_ms(lambda: ref.quantize_pack_ref(w, part, "sub3"),
                    iters=2)
    mo_k, r_k = ops.quantize_pack(w, part, "sub3", backend="cuda")
    mo_t, r_t = ops.quantize_pack(w, part, "sub3", backend="torch")
    assert_pack_equal(mo_k, mo_t, r_k, r_t, "mor_select_pack timing shape")
    sel_err = float((mo_k.dequant().float()
                     - mo_t.dequant().float()).abs().max())
    sel_bound = (shapes["sub3"]["bound_ms"], shapes["sub3"]["bound_by"])

    wq = mo_k.compact()
    x = torch.randn(4, d, device="cuda").to(torch.bfloat16)
    xa = ref.passthrough_mixed(x, (ref.activation_row_block(4, 128), 128))
    gk = device_ms(lambda: mixed_gemm_blocks(xa, wq))
    gt = time_ms(lambda: ref.mixed_gemm_ref(xa, wq), iters=2)
    wdec = wq.dequant()
    glib = device_ms(lambda: torch.matmul(x, wdec.T))
    yk = ops.mixed_dot(x, wq, out_dtype=torch.float32, backend="cuda")
    yt = ops.mixed_dot(x, wq, out_dtype=torch.float32, backend="torch")
    g_err = float((yk - yt).abs().max())
    check(bool(torch.all((yk - yt).abs() <= gemm_tol(
        x, wdec, yt, torch.float32))),
        f"mixed_gemm timing shape: max err {g_err} beyond 1e-5 sum|a||b|")
    N = w.shape[0]
    g_bound = bound(weight_bytes(wq) + x.numel() * 2 + 4 * N * 2,
                    2.0 * 4 * N * d)
    w_shape = list(w.shape)
    del w, wdec
    stream = {"decode M=4 x wi": stream_row(
        ops, ref, xa, wq, torch.bfloat16, gk)}
    xm = torch.randn(32, d, device="cuda").to(torch.bfloat16)
    stream["prefill M=32 x wi"] = stream_row(ops, ref, ref.passthrough_mixed(
        xm, (ref.activation_row_block(32, 128), 128)), wq, torch.bfloat16)
    del wq
    # Random weights put every block in E4M3: the same shape with blocks
    # of every sub3 tag (E4M3, E5M2, BF16).
    wm = ops.quantize_pack(mixed_tags((2 * f, d), 3).cuda(), part, "sub3",
                           backend="cuda")[0].compact()
    stream["decode M=4 x wi, mixed tags"] = stream_row(ops, ref, xa, wm,
                                                       torch.bfloat16)
    stream["decode M=4 x wi, mixed tags"]["tags"] = np.bincount(
        wm.tags.reshape(-1).cpu().numpy(), minlength=4).tolist()
    del wm
    # The f32 head: M = 4 against the 128256-wide vocabulary.
    wh = (torch.randn(cfg.vocab, d, device="cuda") * 0.02).to(torch.bfloat16)
    wh = ops.quantize_pack(wh, part, "sub3", backend="cuda")[0].compact()
    stream["head M=4 x 128256x4096 (f32)"] = stream_row(ops, ref, xa, wh,
                                                        torch.float32)
    del wh
    # cuBLAS keeps a workspace for the capture stream; later phases'
    # peak memory should not count it.
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    return {
        "mor_select_pack": dict(ms=sel_k, plain_ms=sel_t,
                                bound_ms=sel_bound[0],
                                bound_by=sel_bound[1], library_ms=None,
                                max_abs_err=sel_err,
                                shape=w_shape, shapes=shapes),
        "mixed_gemm": dict(ms=gk, plain_ms=gt, bound_ms=g_bound[0],
                           bound_by=g_bound[1], library_ms=glib,
                           max_abs_err=g_err,
                           shape=[4, N, d]),
        "stream": stream,
    }


def stream_row(ops, ref, a, wq, out_dtype, ms=None):
    """One stream-path shape: the kernel's device time (``device_ms``)
    with the bytes it must move per second, its bound, ``torch.matmul`` on
    the decoded bf16 weight (timed the same way), the eager-launch time
    (``time_ms``, the method of the rows before the CUDA-graph timing) and
    the wrapper's host time per call; the result held against the plain
    version within ``gemm_tol``."""
    from repro_torch.kernels.mixed_gemm import (gemm_path, mixed_gemm_blocks,
                                                stream_plan, _sm_count)
    M, N, K = a.shape[0], wq.shape[0], wq.shape[1]
    check(gemm_path(M) == "stream", f"M={M} is not a stream-path shape")
    call = lambda: mixed_gemm_blocks(a, wq, out_dtype=out_dtype)  # noqa: E731
    if ms is None:
        ms = device_ms(call)
    x = ref.decode_mixed_ref(a)[:M, :K]
    wdec = ref.decode_mixed_ref(wq)[:N, :K]
    lib = device_ms(lambda: torch.matmul(x, wdec.T))
    yk = ops.mixed_gemm(a, wq, out_dtype=out_dtype, backend="cuda")
    yt = ops.mixed_gemm(a, wq, out_dtype=out_dtype, backend="torch")
    err = (yk.float() - yt.float()).abs()
    tol = gemm_tol(x, wdec, yt, out_dtype)
    check(bool(torch.all(err <= tol)),
          f"stream path M={M} N={N} K={K}: max err {float(err.max())} "
          "beyond gemm_tol")
    nbytes = weight_bytes(wq) + M * K * 2 + M * N * (
        4 if out_dtype == torch.float32 else 2)
    b = bound(nbytes, 2.0 * M * N * K)
    return {"M": M, "N": N, "K": K, "out": str(out_dtype).split(".")[-1],
            "ms": ms, "bytes_per_s": nbytes / (ms * 1e-3),
            "bound_ms": b[0], "bound_by": b[1], "share_of_bound": b[0] / ms,
            "library_ms": lib, "vs_library": ms / lib,
            "eager_ms": time_ms(call), "host_us_per_call": host_us(call),
            "splits": stream_plan(M, N, wq.padded_shape[1],
                                  _sm_count(wq.tags.device))[0],
            "max_err_over_tol": float(torch.where(
                err > 0, err / tol, torch.zeros_like(err)).max())}


def phase_engine(cfg, n_layers):
    """The slice: full-width llama3-8b served by the Engine, with the
    launch counters zeroed just before and read just after."""
    from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, Request, ServeConfig
    from repro_torch.serve.quantized import param_bytes, tag_counts

    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    eng = Engine(cfg, MoRDotPolicy(), params,
                 ServeConfig(slots=4, max_seq=512, prefill_chunk=32),
                 quantize=MoRPolicy(recipe="sub3"), device="cuda")
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    del params
    lengths = [5, 7, 19, 33, 48, 64, 77, 100]
    rng = np.random.default_rng(0)
    reqs = []
    for i, L in enumerate(lengths):
        kw = dict(temperature=0.8, top_k=40, seed=1) if i == 3 else {}
        reqs.append(Request(i, rng.integers(0, cfg.vocab, L).astype(
            np.int32), max_tokens=16, **kw))
    step_ms = {"decode": [], "prefill": []}

    def timed(fn, key):
        def wrapper(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            step_ms[key].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    eng._decode_batch = timed(eng._decode_batch, "decode")
    eng._prefill_chunk_step = timed(eng._prefill_chunk_step, "prefill")
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    steps = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counters()

    for r in reqs:
        check(r.done and r.error is None, f"request {r.rid}: {r.error}")
        check(len(r.out) == 16 and all(0 <= t < cfg.vocab for t in r.out),
              f"request {r.rid}: tokens {r.out}")
    check(not eng.quarantined and not eng.rejected, "quarantine/reject")
    calls = eng.prefill_chunks + eng.decode_steps
    L = cfg.n_units
    check(launches["mixed_gemm"] == (4 * L + 1) * calls,
          f"mixed_gemm launches {launches['mixed_gemm']} != (4L+1) x "
          f"{calls} model calls")
    paths = gemm_paths()
    check(paths["stream"] == launches["mixed_gemm"],
          f"engine GEMMs off the stream path: {paths}")
    check(launches["mor_select_pack"] == 4 * L + 1,
          f"mor_select_pack launches {launches['mor_select_pack']} != "
          f"{4 * L + 1} quantized matrices")
    routes = tile_routes()
    check_tile_route(routes, launches, "engine")
    check(not any(plain.values()),
          f"plain versions ran on the main path: {plain}")
    profile = profile_decode(eng)
    tc = tag_counts(eng.params)
    tokens = sum(len(r.out) for r in reqs)
    engine = {
        "arch": cfg.name, "layers": L, "d_model": cfg.d_model,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "n_heads": cfg.n_heads,
        "n_kv": cfg.n_kv, "slots": 4, "max_seq": 512, "prefill_chunk": 32,
        "quantize_s": quantize_s,
        "tag_fractions": {n: float(c) / float(tc.sum()) for n, c in
                          zip(("e4m3", "e5m2", "bf16", "nvfp4"), tc)},
        "weight_bytes": param_bytes(eng.params),
        "steps": steps, "prefill_chunks": eng.prefill_chunks,
        "decode_steps": eng.decode_steps,
        "decode_step_ms": float(np.median(step_ms["decode"])),
        "prefill_chunk_ms": float(np.median(step_ms["prefill"])),
        "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "mixed_gemm_paths": paths,
        "tile_routes": routes,
        "plain_calls": plain, "profile": profile,
    }
    # The timing wrappers above close over eng's bound methods: a cycle
    # that only the collector frees, and it holds the quantized weights.
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return engine, launches, paths, routes


def profile_decode(eng, calls=3):
    """Device time by kernel over ``calls`` decode-shaped model calls
    (all slots on the trash page, the same work as a 4-slot decode
    step), from torch.profiler, and the device's busy share of the host
    wall time. PERF.md's breakdown rests on it, so a profile without
    device time fails the run. Device activity only: the profiler spends
    ~0.2 ms of host time on each event it records, and recording the
    CPU operators too slowed the profiled calls themselves."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    slots = eng.scfg.slots
    bt = torch.full((slots, eng.pool.pages_per_seq), eng.pool.trash,
                    dtype=torch.int64, device=eng.device)
    toks = np.zeros((slots, 1), np.int32)
    cur = np.zeros(slots, np.int32)
    eng._step_fn(bt, toks, cur)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            eng._step_fn(bt, toks, cur)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # Kernel events only: an operator's device time repeats theirs.
        dev_us = ev.self_device_time_total
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    check(any("mixed_gemm" in k for _, k, _ in rows),
          f"the decode profile shows no mixed_gemm kernel: {rows[:8]}")
    return {
        "calls": calls, "wall_ms_per_call": wall_ms / calls,
        "device_ms_per_call": busy_ms / calls,
        "mixed_gemm_ms_per_call": sum(
            us for us, k, _ in rows if "mixed_gemm" in k) / 1e3 / calls,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top": [{"name": k[:60], "ms_per_call": us / 1e3 / calls,
                 "count_per_call": c / calls} for us, k, c in rows[:8]],
    }


@contextlib.contextmanager
def patched(module, name, fn):
    """Temporarily replace ``module.name`` (the model layers look
    ``ops.mixed_dot`` up at call time)."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def gemm_tol(x2, w, y_plain, out_dtype):
    """The kernel-vs-plain limit of one GEMM: 1e-5 * sum_k |a||b| (only
    the f32 summation order differs), plus one bf16 ulp of the result
    for bf16 output: max(2^-7 |c|, 2^-133), the latter the ulp of a bf16
    denormal, so a rounding flip there passes and a flush to zero
    fails."""
    tol = 1e-5 * (x2.double().abs() @ w.double().abs().T).float()
    if out_dtype == torch.bfloat16:
        tol = tol + (2.0**-7 * y_plain.float().abs()).clamp_min(2.0**-133)
    return tol


def checked_dot(ops, ref, seen):
    """``ops.mixed_dot`` that launches the kernel and holds every call
    against the plain version on the same inputs (and against an f64
    sum, for the order-noise figures); returns the kernel's result."""
    orig = ops.mixed_dot

    def dot(x2, mo, *, out_dtype=torch.bfloat16, backend="auto"):
        yk = orig(x2, mo, out_dtype=out_dtype, backend="cuda")
        yt = orig(x2, mo, out_dtype=out_dtype, backend="torch")
        w = ref.decode_mixed_ref(mo)[:mo.shape[0], :x2.shape[1]]
        ye = (x2.double() @ w.double().T).float().to(out_dtype)
        err = (yk.float() - yt.float()).abs()
        key = (x2.shape[0], mo.shape[0], x2.shape[1],
               str(out_dtype).split(".")[-1])
        check(bool(torch.all(err <= gemm_tol(x2, w, yt, out_dtype))),
              f"mixed_gemm M,N,K,out={key}: max err {float(err.max())} "
              "beyond 1e-5 sum|a||b| (+1 bf16 ulp)")
        s = seen.setdefault(key, {"calls": 0, "max_abs_err": 0.0,
                                  "kernel_vs_plain_differ": 0.0,
                                  "plain_vs_f64_differ": 0.0})
        s["calls"] += 1
        s["max_abs_err"] = max(s["max_abs_err"], float(err.max()))
        # Share of outputs whose rounding differs: summation order alone.
        s["kernel_vs_plain_differ"] = max(
            s["kernel_vs_plain_differ"], float((yk != yt).float().mean()))
        s["plain_vs_f64_differ"] = max(
            s["plain_vs_f64_differ"], float((yt != ye).float().mean()))
        return yk
    return dot


def f64_mixed_dot(ref):
    """An ``ops.mixed_dot`` whose GEMM sums the decoded operands in f64
    (the depth-2 checks' third path)."""
    def dot(x2, mo, *, out_dtype=torch.bfloat16, backend="auto"):
        w = ref.decode_mixed_ref(mo)[:mo.shape[0], :x2.shape[1]]
        return (x2.double() @ w.double().T).float().to(out_dtype)
    return dot


def plain_mixed_dot(ops):
    """An ``ops.mixed_dot`` that always runs the plain version."""
    mixed_dot = ops.mixed_dot

    def dot(x2, mo, *, out_dtype=torch.bfloat16, backend="auto"):
        return mixed_dot(x2, mo, out_dtype=out_dtype, backend="torch")
    return dot


def checked_gemm(ops, ref, seen):
    """``ops.mixed_gemm`` that launches the kernel and holds every call
    against the plain version on the same packs (``gemm_tol``), keyed by
    (M, N, K, GEMM path); returns the kernel's result."""
    from repro_torch.kernels.mixed_gemm import gemm_path
    orig = ops.mixed_gemm

    def gemm(a, b, *, out_dtype=torch.bfloat16, backend="auto", tile=None):
        yk = orig(a, b, out_dtype=out_dtype, backend="cuda")
        yt = orig(a, b, out_dtype=out_dtype, backend="torch")
        K = a.shape[1]
        A = ref.decode_mixed_ref(a)[:a.shape[0], :K]
        B = ref.decode_mixed_ref(b)[:b.shape[0], :K]
        err = (yk.float() - yt.float()).abs()
        key = (a.shape[0], b.shape[0], K, gemm_path(a.shape[0]))
        check(bool(torch.all(err <= gemm_tol(A, B, yt, out_dtype))),
              f"mixed_gemm M,N,K,path={key}: max err "
              f"{float(err.max())} beyond 1e-5 sum|a||b| (+1 bf16 ulp)")
        s = seen.setdefault(key, {"calls": 0, "max_abs_err": 0.0,
                                  "kernel_vs_plain_differ": 0.0})
        s["calls"] += 1
        s["max_abs_err"] = max(s["max_abs_err"], float(err.max()))
        s["kernel_vs_plain_differ"] = max(
            s["kernel_vs_plain_differ"], float((yk != yt).float().mean()))
        return yk
    return gemm


DEPTH2_WAYS = ("kernel", "repeat", "plain", "f64", "fed")


def depth2_three_ways(run, ops, ref, what, names, gate=True):
    """phase_depth2's rule on ``run(backend, way)`` -> one tensor for each
    of ``names``, run each way of DEPTH2_WAYS: 'kernel' with every mixed
    GEMM held against the plain version on its real inputs at 1e-5
    sum|a||b| (``checked_dot``); 'repeat', the kernel path again, which
    must repeat bit for bit; 'plain' (backend 'torch'); 'f64', the mixed
    GEMMs summed in f64; 'fed', the kernel path fed the plain version's
    GEMM outputs, which must be the plain path bit for bit (the other
    kernels of the path agree with their plain versions exactly). With
    ``gate``: any two summation orders flip a few bf16 activations, and
    the model carries those flips to its outputs, so the plain path is as
    far from the f64 path as the kernel path is from either; the kernel
    path may be at most twice as far from the f64 path as the plain path
    (a wrong block or lane would be far beyond). Returns ({name: figures,
    'gemms': the checked GEMMs}, those GEMMs by (M, N, K, out))."""
    gemms = {}
    dots = {"kernel": checked_dot(ops, ref, gemms), "f64": f64_mixed_dot(ref),
            "fed": plain_mixed_dot(ops)}
    out, way_s = {}, {}
    for way in DEPTH2_WAYS:
        t = time.perf_counter()
        with patched(ops, "mixed_dot", dots.get(way, ops.mixed_dot)):
            out[way] = run("torch" if way == "plain" else "auto", way)
        way_s[way] = time.perf_counter() - t
    res = {"gemms": [{"M": k[0], "N": k[1], "K": k[2], "out": k[3], **v}
                     for k, v in sorted(gemms.items())], "way_s": way_s}
    for i, name in enumerate(names):
        k, p, e, fed = (out[w][i] for w in ("kernel", "plain", "f64", "fed"))
        check(torch.equal(k, out["repeat"][i]),
              f"{what} {name}: the kernel path does not repeat")
        r = res[name] = {
            "max_abs": float(p.abs().max()),
            "kernel_vs_plain": float((k - p).abs().max()),
            "kernel_vs_f64": float((k - e).abs().max()),
            "plain_vs_f64": float((p - e).abs().max()),
            "argmax_equal": bool(torch.equal(k.argmax(-1), p.argmax(-1))),
            "fed_plain_gemms_equal_plain": bool(torch.equal(bits16(fed),
                                                            bits16(p)))}
        check(not gate or r["kernel_vs_f64"] <= 2.0 * r["plain_vs_f64"],
              f"{what} {name}: kernel path {r['kernel_vs_f64']} from the "
              f"f64 path, plain path {r['plain_vs_f64']}")
        check(r["fed_plain_gemms_equal_plain"],
              f"{what} {name}: the kernel path fed the plain GEMM outputs "
              "differs from the plain path")
    return res, gemms


def phase_depth2(cfg, ops, ref):
    """A prefill chunk (4 rows x 8 tokens: M = 32) and a decode step
    (M = 4) of make_decode_fn at depth 2 and full width, on the same
    sub3 weights, three ways (``depth2_three_ways``); the checked GEMMs
    cover all five weight shapes, the f32 head included, at both M."""
    from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
    from repro_torch.models import init_cache, init_params, make_decode_fn
    from repro_torch.models.transformer import padded_vocab
    from repro_torch.serve.quantized import quantize_params

    cfg = dataclasses.replace(cfg, n_layers=2)
    params, _ = quantize_params(init_params(cfg, seed=1, device="cuda"),
                                MoRPolicy(recipe="sub3"))
    rng = np.random.default_rng(1)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8))).cuda()
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1))).cuda()

    def run(backend, _way):
        fn = make_decode_fn(cfg, MoRDotPolicy(
            weight=MoRPolicy(backend=backend)))
        cache = init_cache(cfg, 4, 64, device="cuda")
        l1, cache, _ = fn(params, cache, chunk, torch.full((4,), 7).cuda())
        l2, cache, _ = fn(params, cache, tok, torch.full((4,), 8).cuda())
        return l1[..., :cfg.vocab], l2[..., :cfg.vocab]

    res, gemms = depth2_three_ways(run, ops, ref, "depth-2",
                                   ("prefill_chunk", "decode_step"))
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    want = {(m, n, k) for m in (32, 4) for n, k in (
        ((cfg.n_heads + 2 * cfg.n_kv) * hd, d), (d, cfg.n_heads * hd),
        (2 * f, d), (d, f), (padded_vocab(cfg), d))}
    check(want <= {key[:3] for key in gemms},
          f"depth-2 GEMM shapes {sorted(gemms)} miss some of {sorted(want)}")
    return res


def phase_serve_grad():
    """``mor_dot`` against a real-quantized weight on the card: the
    forward serves (the kernel's output carries the serving Function's
    grad_fn), and a backward raises the reference's NotImplementedError
    instead of leaving x without a gradient."""
    from repro_torch.core.linear import mor_dot
    from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
    from repro_torch.serve.quantized import quantize_weight
    qt, _ = quantize_weight((torch.randn(512, 384, device="cuda") * 0.02).to(
        torch.bfloat16), MoRPolicy(recipe="sub3"))
    x = torch.randn(4, 512, device="cuda").to(torch.bfloat16)
    x.requires_grad_(True)
    y, st = mor_dot(x, qt, None, MoRDotPolicy())
    check(y.is_cuda and y.requires_grad and not st.requires_grad,
          "mor_dot on a QTensor: the output should carry a grad_fn")
    try:
        y.float().sum().backward()
    except NotImplementedError as e:
        check("QTensor" in str(e), f"unexpected error: {e}")
        return {"raises": "NotImplementedError", "message": str(e),
                "x_grad": x.grad is not None}
    raise AssertionError("backward through a QTensor weight did not raise")


def bits16(t):
    """bf16 / f32 / int tensor -> an integer view for exact comparison."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def gam_quant_on_route(ops, x, block, fmt, algo, route):
    """``ops.gam_quant``'s outputs from the kernel on ``route``, through
    the module's launcher: ``gam_quant_route`` sends every 128 x 128 call
    to ``tile``, so ``generic`` is reached at that block only this way
    (the previous design, for parity and timing; no caller takes it)."""
    from repro_torch.kernels.gam_quant import _launch
    M, K = x.shape
    bm, bk = block
    xp, _, mg = (t[0] for t in ops._kernel_inputs(x[None], block, (fmt,),
                                                  algo))
    nm, nk = xp.shape[0] // bm, xp.shape[1] // bk
    out = (torch.empty_like(xp),
           torch.empty((nm, nk), dtype=torch.int32, device=x.device),
           torch.empty((nm, nk), dtype=torch.float32, device=x.device),
           torch.empty((nm, nk), dtype=torch.float32, device=x.device))

    def launch():
        _launch(route, (xp, mg, *out), 1, *xp.shape, block, algo,
                fmt.amax, fmt.dtype == torch.float8_e5m2, xp.device)
        return (out[0][:M, :K], *out[1:])
    return launch


def check_gam_quant(k, t, what):
    """gam_quant outputs ``k`` against the plain version's ``t``: xq,
    block_exp and counts bit for bit, error sums within 1e-6 relative (the
    kernel accumulates in f64, the plain version in f32 in PyTorch's
    order); returns the sums' largest relative difference."""
    for name, a, b in (("xq", k[0], t[0]), ("block_exp", k[1], t[1]),
                       ("counts", k[3], t[3])):
        check(a.shape == b.shape and torch.equal(bits16(a), bits16(b)),
              f"{what}: {name} differs from the plain version")
    check(torch.equal(k[2].isnan(), t[2].isnan()),
          f"{what}: NaN error sums differ")
    ok = ~t[2].isnan()
    rel = (k[2][ok] - t[2][ok]).abs() / t[2][ok].abs().clamp_min(1e-30)
    r = float(rel.max()) if rel.numel() else 0.0
    check(r <= 1e-6, f"{what}: error sums {r} beyond 1e-6")
    return r


def phase_quant_select(ops, Partition):
    """Kernel vs plain version of ``gam_quant`` (E4M3 and E5M2, all three
    algos) and of ``mor_select(emit='select')`` (sub2/3/4; its bf16
    instances, and its f32 instance, the generic kernel's at every block,
    on f32 operands that are not bf16-exact) on inputs that hit every tag, with zero blocks, a NaN and
    an Inf, a ragged shape and the 28672x4096 wi view: xq, block_exp,
    counts, y and sel bit for bit;
    gam_quant's error sums within 1e-6 relative (the kernel accumulates in
    f64, the plain version in f32 in PyTorch's order), the selection's
    within rtol 1e-5; each call on the route its block names, and
    repeated bit for bit. gam_quant's ``generic`` route is also held
    against the plain version at the 128 x 128 blocks that take ``tile``."""
    from repro_torch.core.formats import E4M3, E5M2
    from repro_torch.kernels.gam_quant import (gam_quant_blocks,
                                               gam_quant_route)
    from repro_torch.kernels.mor_select import (mor_select_route,
                                                mor_select_select)
    cases = [((256, 384), (64, 64), 1), ((200, 136), (128, 128), 2),
             ((28672, 4096), (128, 128), 3)]
    want = {"sub2": {0, 2}, "sub3": {0, 1, 2}, "sub4": {0, 1, 2, 3}}
    seen = {mode: set() for mode in want}
    seen32 = {mode: set() for mode in want}
    sum_rel = 0.0
    for shape, block, seed in cases:
        x = mixed_tags(shape, seed).cuda()
        x[5, 7] = float("nan")
        x[shape[0] // 2 + 3, shape[1] - 9] = float("inf")
        add_tiny_block(x, block, TINY_AT, seed)
        x32 = mixed_tags(shape, seed, dtype=torch.float32).cuda()
        x32[5, 7] = float("nan")
        x32[shape[0] // 2 + 3, shape[1] - 9] = float("inf")
        add_tiny_block(x32, block, TINY_AT, seed)
        route = gam_quant_route(block)
        for fmt in (E4M3, E5M2):
            for algo in ALGOS:
                before = gam_quant_blocks.launches_by_route[route]
                k = ops.gam_quant(x, block=block, fmt=fmt, algo=algo,
                                  backend="cuda")
                t = ops.gam_quant(x, block=block, fmt=fmt, algo=algo,
                                  backend="torch")
                torch.cuda.synchronize()
                what = f"gam_quant {shape} {fmt.name} {algo} ({route})"
                check(gam_quant_blocks.launches_by_route[route] == before + 1,
                      f"{what}: not launched on the {route} route")
                sum_rel = max(sum_rel, check_gam_quant(k, t, what))
                check(int(k[1][TINY_AT]) == -1, f"{what}: the tiny block's "
                      f"exponent is {int(k[1][TINY_AT])}, not frexp(Inf) - 1")
                k2 = ops.gam_quant(x, block=block, fmt=fmt, algo=algo,
                                   backend="cuda")
                check(all(torch.equal(bits16(a), bits16(b))
                          for a, b in zip(k, k2)),
                      f"{what}: repeat not bit-identical")
                if route == "tile":
                    g = gam_quant_on_route(ops, x, block, fmt, algo,
                                           "generic")()
                    sum_rel = max(sum_rel, check_gam_quant(
                        g, t, f"gam_quant {shape} {fmt.name} {algo} "
                        "(generic)"))
        for mode, xx in [(m, x) for m in want] + [(m, x32) for m in want]:
            align = (2, 16) if mode == "sub4" else (1, 1)
            part = Partition("block", block, align=align)
            route = mor_select_route(block, mode, xx.dtype)
            dt = str(xx.dtype).split(".")[-1]
            before = mor_select_select.launches_by_route[route]
            before_dt = mor_select_select.launches_by_dtype[dt]
            k = ops.mor_select(xx, part, mode, backend="cuda")
            t = ops.mor_select(xx, part, mode, backend="torch")
            torch.cuda.synchronize()
            what = f"mor_select_select {shape} {mode} {dt}"
            check(mor_select_select.launches_by_route[route] == before + 1
                  and mor_select_select.launches_by_dtype[dt] == before_dt + 1
                  and k.y.dtype == xx.dtype,
                  f"{what}: not launched on the {route} route's {dt} "
                  "instance")
            k2 = ops.mor_select(xx, part, mode, backend="cuda")
            for name in ("y", "sel", "e4_sums", "e5_sums", "counts",
                         "nv_sums"):
                a, b = getattr(k2, name), getattr(k, name)
                check(a is None or torch.equal(bits16(a), bits16(b)),
                      f"{what}: repeated {name} not bit-identical")
            for f in ("e4_sums", "e5_sums", "nv_sums"):
                a, b = getattr(k, f), getattr(t, f)
                check(a is None or torch.allclose(
                    a, b, rtol=1e-5, atol=0.0, equal_nan=True),
                    f"{what}: {f} beyond rtol 1e-5")
            check(torch.equal(bits16(k.y), bits16(t.y)),
                  f"{what}: y differs from the plain version")
            check(torch.equal(k.sel, t.sel), f"{what}: sel differs")
            check(torch.equal(k.counts, t.counts), f"{what}: counts differ")
            tags = set(np.unique(t.sel.cpu().numpy()).tolist())
            (seen if xx is x else seen32)[mode] |= tags
        emit({"parity": "gam_quant+mor_select_select", "shape": list(shape),
              "block": list(block), "tiny_block": list(TINY_AT),
              "gam_quant_routes": ["tile", "generic"] if route == "tile"
              else [route], "select_dtypes": ["bfloat16", "float32"],
              "identical": True})
        del x, x32
    for mode, tags in want.items():
        for name, got in (("bf16", seen[mode]), ("f32", seen32[mode])):
            check(tags <= got, f"mor_select_select {mode} {name}: tags "
                  f"{sorted(got)} miss some of {sorted(tags)}")
    return {"gam_quant_err_sums_max_rel": sum_rel}


def gam_quant_rows(ops, ref, part, w):
    """gam_quant on the wi view ``w``: the wrapper on the ``tile`` route at
    E4M3 / gam (the kernels line's row: ms, its host us per call, bound,
    plain ms), and through the module's launcher the ``tile`` route at
    E4M3 and E5M2 / gam, E4M3 / e8m0 and E4M3 / fp32_amax (``shapes``)
    and the ``generic`` route at E4M3 / gam (``generic_ms``). Every
    variant's outputs are held against the plain version first (xq,
    block_exp, counts bit for bit; error sums within 1e-6); then all are
    timed in turns (each, then each in reverse, twice: 4 runs of 20
    calls), so drift in the card's clock reaches every row alike."""
    from repro_torch.core.formats import E4M3, E5M2
    from repro_torch.kernels.gam_quant import gam_quant_blocks
    n, nblk = w.numel(), w.numel() // (128 * 128)
    # x read once; xq written; exponent, error sum and count per block.
    b = bound(2 * n + 2 * n + 12 * nblk, 0.0)
    calls, rows = {}, {}
    for label, fmt, algo, route in (
            ("e4m3_gam", E4M3, "gam", "tile"),
            ("e5m2_gam", E5M2, "gam", "tile"),
            ("e4m3_e8m0", E4M3, "e8m0", "tile"),
            ("e4m3_fp32_amax", E4M3, "fp32_amax", "tile"),
            ("generic_e4m3_gam", E4M3, "gam", "generic")):
        calls[label] = gam_quant_on_route(ops, w, (128, 128), fmt, algo, route)
        k = calls[label]()
        t = ref.gam_quant_ref(w, part, fmt, algo)
        torch.cuda.synchronize()
        check_gam_quant(k, t, f"gam_quant timing {label} ({route})")
        rows[label] = {"route": route, "max_abs_err": float(
            (k[0].float() - t[0].float()).abs().max())}
    mg2 = ops._kernel_inputs(w[None], (128, 128), (E4M3,), "gam")[2][0]
    before = dict(gam_quant_blocks.launches_by_route)

    def wrapper():
        return gam_quant_blocks(w, mg2, block=(128, 128))
    calls["wrapper"] = wrapper
    runs = {label: [] for label in calls}
    for label in (list(calls) + list(calls)[::-1]) * 2:
        runs[label].append(time_ms(calls[label], iters=20))
    check(gam_quant_blocks.launches_by_route["tile"] > before["tile"]
          and gam_quant_blocks.launches_by_route["generic"]
          == before["generic"], "gam_quant timing: wrapper off the tile route")
    for label, row in rows.items():
        row.update(ms=float(np.mean(runs[label])), runs=runs[label])
    generic = rows.pop("generic_e4m3_gam")
    return dict(
        ms=float(np.mean(runs["wrapper"])), runs=runs["wrapper"],
        route="tile", host_us=host_us(wrapper), generic_ms=generic["ms"],
        generic_runs=generic["runs"],
        plain_ms=time_ms(lambda: ref.gam_quant_ref(w, part, E4M3), iters=2),
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        max_abs_err=rows["e4m3_gam"]["max_abs_err"], shape=list(w.shape),
        shapes=rows)


def select_f32_rows(ops, ref, Partition, w):
    """The select kernel's f32 instance (the generic kernel's, at every
    block) on the wi view as the gradient compression gives it (f32, not
    bf16-exact): under sub3 and sub4, ms, host us a call and the bound
    (4 B read and 4 B of y written an element, and the block's cells);
    the plain version's time; y and sel held bit for bit."""
    from repro_torch.kernels.mor_select import mor_select_select
    g = torch.Generator(device="cuda").manual_seed(11)
    w32 = w.float() * (1 + torch.rand(w.shape, generator=g, device="cuda")
                       * 2.0**-10)
    n, nblk = w32.numel(), w32.numel() // (128 * 128)
    rows = {}
    for mode in ("sub3", "sub4"):
        part = Partition("block", (128, 128),
                         align=(2, 16) if mode == "sub4" else (1, 1))
        k = ops.mor_select(w32, part, mode, backend="cuda")
        t = ops.mor_select(w32, part, mode, backend="torch")
        check(torch.equal(bits16(k.y), bits16(t.y))
              and torch.equal(k.sel, t.sel),
              f"mor_select_select f32 timing {mode} differs")
        xp, mg = select_inputs(ops, w32)

        def call():
            return mor_select_select(xp, mg, block=(128, 128), mode=mode)
        b = bound(8.0 * n + (28 if mode == "sub4" else 24) * nblk, 0.0)
        rows[mode] = {"route": "generic", "ms": time_ms(call, iters=20),
                      "host_us": host_us(call), "bound_ms": b[0],
                      "bound_by": b[1],
                      "tags": np.bincount(t.sel.reshape(-1).cpu().numpy(),
                                          minlength=4).tolist()}
        del k, t, xp
    part = Partition("block", (128, 128))
    rows["plain_ms"] = time_ms(lambda: ref.mor_select_ref(w32, part, "sub3"),
                               iters=1)
    rows["shape"] = list(w32.shape)
    del w32
    return rows


def phase_train_timing(ops, ref, Partition, cfg):
    """Kernel, plain and library times at the training shapes: gam_quant
    and mor_select_select on the wi view (28672x4096), and mixed_gemm for
    the fwd (M = 2048 tokens), dgrad and wgrad GEMMs of wi on sub3 packs,
    with the wgrad operands transposed packs as the fused backward makes
    them."""
    from repro_torch.kernels.mixed_gemm import mixed_gemm_blocks
    d, f = cfg.d_model, cfg.d_ff
    M = TRAIN_BATCH * TRAIN_SEQ
    part = Partition("block", (128, 128))
    w = (torch.randn(2 * f, d, device="cuda") * 0.02).to(torch.bfloat16)
    n, nblk = w.numel(), w.numel() // (128 * 128)
    out = {}

    out["gam_quant"] = gam_quant_rows(ops, ref, part, w)

    k = ops.mor_select(w, part, "sub3", backend="cuda")
    t = ops.mor_select(w, part, "sub3", backend="torch")
    check(torch.equal(bits16(k.y), bits16(t.y)) and torch.equal(k.sel, t.sel),
          "mor_select_select timing shape differs")
    shapes = selection_rows(ops, ref, Partition, "select", w)
    out["mor_select_select"] = dict(
        ms=shapes["sub3"]["ms"],
        plain_ms=time_ms(lambda: ref.mor_select_ref(w, part, "sub3"),
                         iters=2),
        bound_ms=shapes["sub3"]["bound_ms"],
        bound_by=shapes["sub3"]["bound_by"], library_ms=None,
        max_abs_err=float((k.y.float() - t.y.float()).abs().max()),
        shape=list(w.shape), shapes=shapes,
        f32=select_f32_rows(ops, ref, Partition, w))

    x = torch.randn(M, d, device="cuda").to(torch.bfloat16)
    dy = (torch.randn(M, 2 * f, device="cuda") * 1e-3).to(torch.bfloat16)

    def pack(a):
        return ops.quantize_pack(a, part, "sub3", backend="cuda")[0]

    x_mo, dy_mo = pack(x), pack(dy)
    wt_mo, wkn_mo = pack(w), pack(w.T.contiguous())
    gemms = {"fwd": (x_mo, wt_mo), "dgrad": (dy_mo, wkn_mo),
             "wgrad": (x_mo.transpose(), dy_mo.transpose())}
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    for name, (a, bb) in gemms.items():
        A = ref.decode_mixed_ref(a)[:a.shape[0]]
        B = ref.decode_mixed_ref(bb)[:bb.shape[0]]
        n_tc = mixed_gemm_blocks.launches_by_path["tc"]
        ck = mixed_gemm_blocks(a, bb)
        check(mixed_gemm_blocks.launches_by_path["tc"] == n_tc + 1,
              f"mixed_gemm train {name}: did not take the tc path")
        ct = ref.mixed_gemm_ref(a, bb)
        err = (ck.float() - ct.float()).abs()
        tol = gemm_tol(A, B, ct, torch.bfloat16)
        check(bool(torch.all(err <= tol)),
              f"mixed_gemm train {name}: max err {float(err.max())} beyond "
              "1e-5 sum|a||b| + 1 bf16 ulp")
        ratio = float(torch.where(err > 0, err / tol,
                                  torch.zeros_like(err)).max())
        Mm, Nn, Kk = a.shape[0], bb.shape[0], a.shape[1]
        b = bound(weight_bytes(a) + weight_bytes(bb) + 2 * Mm * Nn,
                  2.0 * Mm * Nn * Kk)
        out[f"mixed_gemm_{name}"] = dict(
            path="tc", ms=time_ms(lambda: mixed_gemm_blocks(a, bb), iters=20),
            plain_ms=time_ms(lambda: ref.mixed_gemm_ref(a, bb), iters=1),
            bound_ms=b[0], bound_by=b[1],
            library_ms=time_ms(lambda: torch.matmul(A, B.T), iters=20),
            max_abs_err=float(err.max()), max_err_over_tol=ratio,
            shape=[Mm, Nn, Kk])
        del A, B, ck, ct, err, tol
    return out


def train_policies():
    from repro_torch.core.policy import paper_default
    return {"tensor": paper_default("tensor"),
            "sub3": paper_default("sub3"),
            "sub3_fused": paper_default("sub3").replace(fuse_gemm=True)}


def with_backend(pol, backend):
    return pol.replace(act=pol.act.replace(backend=backend),
                       weight=pol.weight.replace(backend=backend),
                       grad=pol.grad.replace(backend=backend))


def kernel_counters():
    """(kernel launch counters, plain-version call counters) by name."""
    # The package exports its entry points (gam_quant, mixed_gemm,
    # mor_select, flash_attention, fp8_gemm) under its kernel modules'
    # names, as the reference does, so the wrappers are imported from
    # their modules by path.
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fp8_gemm import fp8_gemm_blocks
    from repro_torch.kernels.gam_quant import gam_quant_blocks
    from repro_torch.kernels.mixed_gemm import mixed_gemm_blocks
    from repro_torch.kernels.mor_select import (mor_select_pack,
                                                mor_select_select)
    kernels = {"gam_quant": gam_quant_blocks,
               "mor_select_select": mor_select_select,
               "mor_select_pack": mor_select_pack,
               "mixed_gemm": mixed_gemm_blocks,
               "flash_attention": flash_attention_fwd,
               "fp8_gemm": fp8_gemm_blocks}
    plain = {"quant_err_ref": ref.quant_err_ref,
             "gam_quant_ref": ref.gam_quant_ref,
             "mor_select_ref": ref.mor_select_ref,
             "quantize_pack_ref": ref.quantize_pack_ref,
             "mixed_gemm_ref": ref.mixed_gemm_ref,
             "flash_attention_ref": ref.flash_attention_ref,
             "fp8_gemm_ref": ref.fp8_gemm_ref}
    return kernels, plain


def reset_counters():
    kernels, plain = kernel_counters()
    for fn in kernels.values():
        fn.launches = 0
    kernels["mixed_gemm"].launches_by_path = {"stream": 0, "tc": 0}
    for name in ("fp8_gemm", "flash_attention") + TILE_KERNELS:
        kernels[name].launches_by_route = {
            r: 0 for r in kernels[name].launches_by_route}
    sel = kernels["mor_select_select"]
    sel.launches_by_dtype = {d: 0 for d in sel.launches_by_dtype}
    for fn in plain.values():
        fn.calls = 0


def read_counters():
    kernels, plain = kernel_counters()
    return ({k: fn.launches for k, fn in kernels.items()},
            {k: fn.calls for k, fn in plain.items()})


TILE_KERNELS = ("mor_select_pack", "mor_select_select", "gam_quant")


def tile_routes():
    """The quantization wrappers' (both selections' and gam_quant's)
    launches by route since the last reset_counters()."""
    kernels, _ = kernel_counters()
    return {k: dict(kernels[k].launches_by_route) for k in TILE_KERNELS}


def check_tile_route(routes, launches, what):
    """Every quantization launch of a main path took the 128 x 128
    route."""
    for k, by_route in routes.items():
        check(by_route["tile"] == launches[k] and by_route["generic"] == 0,
              f"{what}: {k} launches off the tile route: {by_route} of "
              f"{launches[k]}")


def gemm_paths():
    """mixed_gemm's launches by path since the last reset_counters()."""
    from repro_torch.kernels.mixed_gemm import mixed_gemm_blocks
    return dict(mixed_gemm_blocks.launches_by_path)


def train_batch(cfg, step, batch=TRAIN_BATCH, seq=TRAIN_SEQ, device="cuda"):
    """SyntheticLM's tokens and labels of ``step``, (batch, seq) each."""
    from repro_torch.data import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=1234))
    return {k: torch.from_numpy(v.astype(np.int64)).to(device)
            for k, v in data.batch_at(step).items()}


def phase_train(cfg):
    """The training slice: 4-layer, full-width llama3-8b, TRAIN_STEPS AdamW
    steps per policy from the same seeded weights, with the launch
    counters zeroed just before each policy's steps and read just after.
    Every mor_dot has 2 forward events, run twice under the layer remat,
    and 3 backward events (the transposed dy event reuses dgrad's), so a
    step of L layers quantizes 4L * 7 operands; the fused lowering packs
    the same operands and runs 4 GEMMs per mor_dot (the forward twice,
    dgrad, wgrad)."""
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    L = cfg.n_units
    tcfg = TrainConfig(optimizer=AdamWConfig(warmup_steps=1))
    events = 4 * L * (2 * 2 + 3) * TRAIN_STEPS
    expect = {
        "tensor": {"gam_quant": events},
        "sub3": {"mor_select_select": events},
        "sub3_fused": {"mor_select_pack": events,
                       "mixed_gemm": 4 * L * 4 * TRAIN_STEPS},
    }
    res, launches, profiles, train_paths, train_routes = {}, {}, {}, {}, {}
    for name, pol in train_policies().items():
        params = init_params(cfg, seed=0, device="cuda")
        opt = init_opt_state(params)
        step_fn = make_train_step(cfg, pol, tcfg)
        batches = [train_batch(cfg, s) for s in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        rows = []
        for s, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            row = {"policy": name, "step": s, "step_ms": dt * 1e3,
                   "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / dt,
                   **{k: float(m[k]) for k in (
                       "loss", "fwd_frac_bf16", "bwd_frac_bf16",
                       "fwd_rel_err", "bwd_rel_err", "grad_norm", "lr")},
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            emit({"train_step": row})
            # A finite global norm means every gradient element is finite.
            check(np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"]),
                  f"train {name} step {s}: loss {row['loss']} grad_norm "
                  f"{row['grad_norm']}")
            rows.append(row)
        k_counts, p_counts = read_counters()
        paths = gemm_paths()
        routes = tile_routes()
        check_tile_route(routes, k_counts, f"train {name}")
        train_routes[name] = routes
        for kern, n in expect[name].items():
            check(k_counts[kern] == n, f"train {name}: {kern} launched "
                  f"{k_counts[kern]} times, want {n} (every event)")
        check(paths["tc"] == k_counts["mixed_gemm"],
              f"train {name}: fused GEMMs off the tc path: {paths}")
        check(not any(p_counts.values()),
              f"train {name}: plain versions ran on the main path: "
              f"{p_counts}")
        launches[name] = k_counts
        train_paths[name] = paths
        profiles[name] = profile_train_step(
            step_fn, params, opt, batches[0],
            {"tensor": "gam_quant", "sub3": "mor_select",
             "sub3_fused": "mixed_gemm"}[name])
        res[name] = {"steps": rows,
                     "step_ms_median": float(np.median(
                         [r["step_ms"] for r in rows])),
                     "launches": k_counts, "mixed_gemm_paths": paths,
                     "tile_routes": routes, "plain_calls": p_counts}
        del params, opt, step_fn, batches
        gc.collect()
        torch.cuda.empty_cache()
    res["config"] = {"arch": cfg.name, "layers": L, "d_model": cfg.d_model,
                     "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                     "n_heads": cfg.n_heads, "n_kv": cfg.n_kv,
                     "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                     "steps": TRAIN_STEPS, "warmup_steps": 1,
                     "remat": True,
                     "head_gemm": "bf16 tensor cores, f32 out (mm.dtype)"}
    res["profile"] = profiles
    total = {k: sum(launches[p][k] for p in launches)
             for k in next(iter(launches.values()))}
    total_paths = {k: sum(p[k] for p in train_paths.values())
                   for k in ("stream", "tc")}
    total_routes = {k: {r: sum(t[k][r] for t in train_routes.values())
                        for r in ("tile", "generic")}
                    for k in TILE_KERNELS}
    return res, total, total_paths, total_routes


def state_bytes(tree):
    """Device bytes of an optimizer-state tree: every tensor of its dense
    leaves, and every lane, grid and the stats row of its packed ones."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.optim.moments import PackedMoment
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, PackedMoment):
            mo = leaf.mo
            ts = (mo.payload_q, mo.payload_bf16, mo.payload_nib,
                  mo.micro_scales, mo.tags, mo.scales, leaf.stats)
        else:
            ts = (leaf,)
        total += sum(t.numel() * t.element_size() for t in ts)
    return total


def host_copy(tree):
    """The tensors of a state tree (packed lanes included) copied to the
    host, in tree_leaves order."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.optim.moments import PackedMoment
    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, PackedMoment):
            mo = leaf.mo
            out += [t.cpu() for t in (mo.payload_q, mo.payload_bf16,
                                      mo.payload_nib, mo.micro_scales,
                                      mo.tags, mo.scales, leaf.stats)]
        else:
            out.append(leaf.cpu())
    return out


def same_bits(a, b):
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.view(torch.uint8), y.view(torch.uint8))
        for x, y in zip(a, b))


# Elements in a stripe of the plain selection that checked_f32_select runs
# beside the kernel (the embedding's view alone has 1.05 G elements).
PLAIN_STRIPE = 1 << 26


def checked_f32_select(ops, ref, seen):
    """``ops.mor_select`` with every f32 call (the gradient compression's
    views) held against the plain version on its real operand: y, sel and
    counts bit for bit, the error sums within rtol 1e-5. The plain
    version runs over stripes of whole block rows (about PLAIN_STRIPE
    elements) at the whole view's block and group amax, so each stripe's
    blocks decide as they do in the whole and the temporaries stay a
    stripe's size. ``seen`` collects the calls by shape and mode."""
    from repro_torch.core.partition import Partition
    orig = ops.mor_select

    def select(x, part, mode="sub3", algo="gam", *, backend="auto",
               mesh_axes=()):
        k = orig(x, part, mode, algo, backend=backend, mesh_axes=mesh_axes)
        if x.dtype != torch.float32:
            return k
        M, K = x.shape
        bm, bk = part.resolve((M, K))
        exact = Partition("block", (bm, bk), align=(bm, bk))
        step = max(1, PLAIN_STRIPE // (bm * max(K, 1))) * bm
        what = f"train_state f32 select {tuple(x.shape)} {mode}"
        worst = 0.0
        for r0 in range(0, M, step):
            r1, i0 = min(r0 + step, M), r0 // bm
            t = ref.mor_select_ref(x[r0:r1], exact, mode, algo,
                                   group_amax=k.group_amax)
            i1 = i0 + t.sel.shape[0]
            check(torch.equal(bits16(k.y[r0:r1]), bits16(t.y)),
                  f"{what} rows {r0}:{r1}: y differs from the plain version")
            check(torch.equal(k.sel[i0:i1], t.sel)
                  and torch.equal(k.counts[i0:i1], t.counts),
                  f"{what} rows {r0}:{r1}: sel or counts differ")
            for f in ("e4_sums", "e5_sums", "nv_sums"):
                a, b = getattr(k, f), getattr(t, f)
                if a is None:
                    continue
                a = a[i0:i1]
                check(torch.allclose(a, b, rtol=1e-5, atol=0.0,
                                     equal_nan=True),
                      f"{what} rows {r0}:{r1}: {f} beyond rtol 1e-5")
                fin = torch.isfinite(b) & (b != 0)
                if bool(fin.any()):
                    worst = max(worst, float(((a - b).abs() / b.abs())[fin]
                                             .max()))
            del t
        row = seen.setdefault(f"{M}x{K} {mode}", {
            "calls": 0, "block": [bm, bk], "tags": [0, 0, 0, 0],
            "err_sums_max_rel": 0.0})
        row["calls"] += 1
        row["tags"] = (np.array(row["tags"]) + np.bincount(
            k.sel.reshape(-1).cpu().numpy(), minlength=4)).tolist()
        row["err_sums_max_rel"] = max(row["err_sums_max_rel"], worst)
        return k

    return select


def phase_train_state(ops, ref):
    """The compressed training state on nemotron3-8b at full width,
    STATE_LAYERS layers (every run at that depth; 2 x 1024 tokens a step,
    AdamW with warmup_steps=1, paper_default('sub3') GEMMs): (i) dense
    f32 moments, (ii) FP8_MOMENTS with 'mor' gradient compression, (iii)
    FP8_MOMENTS with 'mor_ef' and GuardPolicy() from init_opt_state(
    params, moments=FP8_MOMENTS, ef=True), TRAIN_STEPS steps each, and
    (iv) one step of SUB4_V_MOMENTS. Per run: step ms, peak GB, the
    state's bytes per parameter counted from its tensors, the moment and
    opt metrics and the launch counters (zeroed just before the steps,
    read just after): every gradient event through the select kernel's
    f32 instance, every moment encode through mor_select_pack, no plain
    version. Then the skip-step: a NaN in the embedding row of the
    batch's first token, one step of (iii): master, both packed moments
    (every lane), the EF residuals and the step counter bit-identical to
    before (host copies), guard_skip 1. Run (iii) also profiles one step
    (profile_train_step) before its skip-step. Run (ii) takes one more
    step with every f32 selection held against the plain version on its
    real gradient (checked_f32_select): every leaf's view, the stacked
    layer weights, the embedding and the head among them."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_default
    from repro_torch.kernels.mor_select import mor_select_select
    from repro_torch.models import init_params
    from repro_torch.optim import (FP8_MOMENTS, SUB4_V_MOMENTS, AdamWConfig,
                                   init_opt_state)
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.robust import GuardPolicy
    from repro_torch.train import TrainConfig, make_train_step
    cfg = dataclasses.replace(get_config("nemotron3-8b"),
                              n_layers=STATE_LAYERS)
    L = cfg.n_units
    opt_cfg = AdamWConfig(warmup_steps=1)
    runs = {
        "i_dense": (TrainConfig(optimizer=opt_cfg), {}, TRAIN_STEPS),
        "ii_fp8_moments_mor": (TrainConfig(
            optimizer=opt_cfg, moments=FP8_MOMENTS, compress_grads="mor"),
            {"moments": FP8_MOMENTS}, TRAIN_STEPS),
        "iii_fp8_moments_mor_ef_guard": (TrainConfig(
            optimizer=opt_cfg, moments=FP8_MOMENTS, compress_grads="mor_ef",
            guard=GuardPolicy()), {"moments": FP8_MOMENTS, "ef": True},
            TRAIN_STEPS),
        "iv_sub4_v_moments": (TrainConfig(
            optimizer=opt_cfg, moments=SUB4_V_MOMENTS),
            {"moments": SUB4_V_MOMENTS}, 1),
    }
    events = 4 * L * (2 * 2 + 3)  # GEMM-operand selections a step (bf16)
    res, launches, dtypes, routes = {}, {}, {}, {}
    skip = None
    for name, (tcfg, init_kw, steps) in runs.items():
        params = init_params(cfg, seed=0, device="cuda")
        n_params = sum(p.numel() for p in tree_leaves(params))
        n_leaves = len(tree_leaves(params))
        opt = init_opt_state(params, **init_kw)
        step_fn = make_train_step(cfg, paper_default("sub3"), tcfg)
        batches = [train_batch(cfg, s) for s in range(steps)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        rows = []
        for s, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            row = {"run": name, "step": s, "step_ms": dt * 1e3,
                   "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / dt,
                   **{k: float(v) for k, v in m.items()},
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            emit({"train_state_step": row})
            check(np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])
                  and row.get("guard_skip", 0.0) == 0.0,
                  f"train_state {name} step {s}: {row}")
            rows.append(row)
        k_counts, p_counts = read_counters()
        by_dtype = dict(mor_select_select.launches_by_dtype)
        by_route = tile_routes()
        compress = tcfg.compress_grads != "none"
        # Both moments of every leaf of at least min_leaf elements packed
        # (at full width: every leaf).
        n_packed = 0 if tcfg.moments is None else sum(
            p.numel() >= tcfg.moments.min_leaf for p in tree_leaves(params))
        want = {"mor_select_select": events * steps + (
                    n_leaves * steps if compress else 0),
                "mor_select_pack": 2 * n_packed * steps}
        for kern, n in want.items():
            check(k_counts[kern] == n, f"train_state {name}: {kern} "
                  f"launched {k_counts[kern]} times, want {n}")
        check(by_dtype == {"bfloat16": events * steps,
                           "float32": n_leaves * steps if compress else 0},
              f"train_state {name}: select launches by dtype {by_dtype}")
        check(not any(p_counts.values()), f"train_state {name}: plain "
              f"versions ran on the main path: {p_counts}")
        bpp = {part: state_bytes(getattr(opt, part)) / n_params
               for part in ("master", "m", "v", "ef")
               if getattr(opt, part) is not None}
        res[name] = {
            "steps": rows,
            "step_ms_median": float(np.median([r["step_ms"] for r in rows])),
            "peak_mem_gb": rows[-1]["peak_mem_gb"],
            "state_bytes_per_param": {**bpp, "total": sum(bpp.values())},
            "n_params": n_params, "launches": k_counts,
            "select_launches_by_dtype": by_dtype, "tile_routes": by_route,
            "plain_calls": p_counts,
            **{k: rows[-1].get(k) for k in (
                "moment_bpe_m", "moment_bpe_v", "opt_payload_bpe",
                "opt_frac_bf16", "ef_norm")}}
        emit({"train_state_run": {k: v for k, v in res[name].items()
                                  if k != "steps"}})
        launches[name], dtypes[name], routes[name] = k_counts, by_dtype, \
            by_route
        if name.startswith("ii_"):
            # One more step (its update is kept), every f32 selection of
            # it held against the plain version on its real gradient.
            seen = {}
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            with patched(ops, "mor_select",
                         checked_f32_select(ops, ref, seen)):
                params, opt, m = step_fn(params, opt, train_batch(cfg, steps))
            torch.cuda.synchronize()
            check(sum(v["calls"] for v in seen.values()) == n_leaves,
                  f"train_state {name}: {seen} is not one f32 selection a "
                  f"leaf ({n_leaves})")
            res[name]["f32_select_vs_plain"] = {
                "identical": True, "leaves": n_leaves, "by_shape": seen,
                "s": time.perf_counter() - t0}
            emit({"train_state_f32_select_vs_plain":
                  res[name]["f32_select_vs_plain"]})
        if name.startswith("iii"):
            # One more step under the profiler (its update is kept: the
            # state is updated in place), then the skip-step.
            res[name]["profile"] = profile_train_step(
                step_fn, params, opt, train_batch(cfg, steps), "mor_select")
            emit({"train_state_profile": res[name]["profile"]})
            torch.cuda.empty_cache()
            skip = skip_step_check(step_fn, params, opt, train_batch(cfg, 0))
        del params, opt, step_fn, batches, m
        gc.collect()
        torch.cuda.empty_cache()
    res["skip_step"] = skip
    res["config"] = {"arch": cfg.name, "layers": L, "d_model": cfg.d_model,
                     "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                     "n_heads": cfg.n_heads, "n_kv": cfg.n_kv, "act": cfg.act,
                     "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                     "warmup_steps": 1, "gemm_policy": "sub3", "remat": True}
    total = {k: sum(launches[r][k] for r in launches)
             for k in next(iter(launches.values()))}
    total_routes = {k: {r: sum(t[k][r] for t in routes.values())
                        for r in ("tile", "generic")}
                    for k in TILE_KERNELS}
    total_dtypes = {k: sum(d[k] for d in dtypes.values())
                    for k in ("bfloat16", "float32")}
    return res, total, total_routes, total_dtypes


def skip_step_check(step_fn, params, opt, batch):
    """One step of the guarded run with a NaN in the embedding row the
    batch's first token reads: the step is dropped (guard_skip 1) and
    the master weights, both moments (every packed lane), the EF
    residuals and the step counter come back bit-identical (compared on
    host copies taken before the step)."""
    tok = int(batch["tokens"][0, 0])
    before = {part: host_copy(getattr(opt, part))
              for part in ("master", "m", "v", "ef")}
    torch.cuda.empty_cache()  # the guarded run's fragments
    step_before = int(opt.step)
    params["embed"][tok] = float("nan")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params2, opt2, m = step_fn(params, opt, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    same = {part: same_bits(before[part], host_copy(getattr(opt2, part)))
            for part in before}
    out = {"token": tok, "guard_skip": float(m["guard_skip"]),
           "grad_norm": float(m["grad_norm"]), "step_ms": dt * 1e3,
           "step_before": step_before, "step_after": int(opt2.step),
           "bit_identical": same,
           "guard_flag_events": float(m["guard_flag_events"])}
    emit({"train_state_skip_step": out})
    check(out["guard_skip"] == 1.0 and all(same.values())
          and out["step_after"] == step_before,
          f"skip-step did not keep the state: {out}")
    return out


def profile_train_step(step_fn, params, opt, batch, must, steps=1):
    """Device time by kernel over one train step, from torch.profiler,
    and the device's busy share of the host wall time (as
    profile_decode), with the step's time in each of the port's
    quantization and GEMM kernels (``port_kernels_ms_per_step``). The
    step's results are dropped (it updates the optimizer state in place,
    which no caller reads after it but the skip-step check)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            out = step_fn(params, opt, batch)
            del out
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = ev.self_device_time_total
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    check(any(must in k for _, k, _ in rows),
          f"the train-step profile shows no {must} kernel: {rows[:8]}")
    return {
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": busy_ms / steps,
        f"{must}_ms_per_step": sum(
            us for us, k, _ in rows if must in k) / 1e3 / steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "port_kernels_ms_per_step": {
            name: sum(us for us, k, _ in rows if name in k) / 1e3 / steps
            for name in ("gam_quant", "mor_select", "mixed_gemm")},
        "top": [{"name": k[:60], "ms_per_step": us / 1e3 / steps,
                 "count_per_step": c / steps} for us, k, c in rows[:10]],
    }


# ---------------------------------------------------------------------------
# Fault tolerance: checkpoint/restart and the chaos harness
# ---------------------------------------------------------------------------

# Checkpoints of the fault-tolerance phase go to a directory on the
# checkout's own disk (never /dev/shm or a tmpfs), gitignored, removed at
# the end of the phase.
CKPT_DIR = ROOT / "build" / "ckpt"
# The model of the checkpoints: the card's machine accepts ~45 GiB of
# disk writes a run, and the phase writes three checkpoints (the
# compressed state's, the preempted Trainer's, the resumed Trainer's
# final one), and the phase's time goes mostly to writing, reading and
# hashing (``digest_tree``) them. nemotron3-8b's 256k-vocab embedding and
# head alone make ~29 GB of compressed state at any depth;
# deepseek-coder-33b at full width and one layer (0.99 B params, a 32k
# vocab; PRs 22-26) made 12.4 GB of compressed state and ~13.9 GB of the
# Trainer's dense state, gemma-2b at one layer (0.63 B) 9.7 / 8.9 GB.
# granite-moe-1b-a400m at full width and one layer (0.10 B params: a
# tied 49k-vocab embedding and one layer of 32 experts) makes about a
# tenth of deepseek's bytes, with the MoE leaves (4-D expert stacks, the
# router) in the state.
FT_ARCH, FT_LAYERS, PREEMPT_STEPS = "granite-moe-1b-a400m", 1, 4
_PINNED = [None]  # the host buffer digest_tree copies leaves through


def digest_tree(tree):
    """{key path: sha256 over the leaf's dtype, shape and bytes} for every
    tensor of a state tree (packed lanes too), one leaf on the host at a
    time: a CUDA leaf is copied into one reused pinned buffer, and its
    bytes hashed in 8 slices on threads (the slices' digests hashed
    again)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.tree import flatten_with_path
    out = {}
    with ThreadPoolExecutor(8) as pool:
        for key, t in flatten_with_path(tree):
            t = t.detach().contiguous()
            flat = t.reshape(-1).view(torch.uint8)
            if t.is_cuda:
                n = flat.numel()
                if _PINNED[0] is None or _PINNED[0].numel() < n:
                    _PINNED[0] = None
                    _PINNED[0] = torch.empty(n, dtype=torch.uint8,
                                             pin_memory=True)
                host = _PINNED[0][:n]
                host.copy_(flat)
            else:
                host = flat
            buf = memoryview(host.numpy())
            step = -(-len(buf) // 8) or 1
            parts = pool.map(lambda i: hashlib.sha256(
                buf[i:i + step]).digest(), range(0, max(len(buf), 1), step))
            h = hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode())
            for p in parts:
                h.update(p)
            out[key] = h.hexdigest()
    return out


def host_mem_gb():
    """MemAvailable of the host, GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return None


def dir_gb(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file()) / 1e9


def guarded_step_fn(cfg, fault=None):
    """Run (iii)'s step (``phase_train_state``): FP8_MOMENTS, 'mor_ef', GuardPolicy(), sub3 GEMMs,
    with the chaos harness's gradient hook ``fault``."""
    from repro_torch.core.policy import paper_default
    from repro_torch.optim import FP8_MOMENTS, AdamWConfig
    from repro_torch.robust import GuardPolicy
    from repro_torch.train import TrainConfig, make_train_step
    tcfg = TrainConfig(optimizer=AdamWConfig(warmup_steps=1),
                       moments=FP8_MOMENTS, compress_grads="mor_ef",
                       guard=GuardPolicy())
    return make_train_step(cfg, paper_default("sub3"), tcfg,
                           grad_fault=fault)


def ft_state_phase(smi):
    """Run (iii)'s compressed state on FT_ARCH (full width, FT_LAYERS
    layer(s)) through the gradient faults and a checkpoint.

    Gradient faults: the step rebuilt with make_grad_fault(kind, seed=3)
    for 'nan' and 'inf': a batch with inject=1 is dropped (guard_skip 1;
    every lane of params and state bit-identical, by digests), the next
    with inject=0 is not. Checkpoint: digests of params and the whole
    OptState, Checkpointer(keep=1, async_save=True).save, one more real
    step at once (it rewrites master, m, v and ef in place while the
    writer runs), wait(), then -- the GPU state freed -- restore into a
    CPU target with the structure init_opt_state(..., moments=FP8_MOMENTS,
    ef=True) gives (built on the card, each leaf an unfilled CPU tensor of
    its dtype): every lane bit for bit what was saved, the step, and
    has_nvfp4 read from the tags. Returns (result, launch counts, tile
    routes, GEMM paths) of the steps."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core.tree import map_with_path
    from repro_torch.kernels.ref import TAG_NVFP4
    from repro_torch.models import init_params
    from repro_torch.optim import FP8_MOMENTS, init_opt_state
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.optim.moments import PackedMoment
    from repro_torch.robust import make_grad_fault
    cfg = dataclasses.replace(get_config(FT_ARCH), n_layers=FT_LAYERS)
    params = init_params(cfg, seed=0, device="cuda")
    opt = init_opt_state(params, moments=FP8_MOMENTS, ef=True)
    hooks = {k: guarded_step_fn(cfg, make_grad_fault(k, seed=3))
             for k in ("nan", "inf")}

    def batch(s, inject):
        return {**train_batch(cfg, s),
                "inject": torch.tensor(float(inject), device="cuda")}

    torch.cuda.synchronize()
    reset_counters()
    res = {"grad_faults": {}}
    s = 0
    params, opt, m = hooks["nan"](params, opt, batch(s, 0))
    check(float(m["guard_skip"]) == 0.0, f"clean step skipped: {m}")
    for kind, step_fn in hooks.items():
        before = digest_tree((params, opt))
        s += 1
        t0 = time.perf_counter()
        p2, opt2, m = step_fn(params, opt, batch(s, 1))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = digest_tree((p2, opt2))
        same = before == after
        row = {"kind": kind, "seed": 3, "guard_skip": float(m["guard_skip"]),
               "grad_norm": float(m["grad_norm"]),
               "loss": float(m["loss"]),
               "guard_flag_events": float(m["guard_flag_events"]),
               "state_bit_identical": same, "step_ms": dt * 1e3,
               "leaves_compared": len(before)}
        # The dropped step's params (the master weights cast again) stand
        # in for the old ones, which must not outlive the next step.
        params = p2
        del p2, opt2
        torch.cuda.empty_cache()
        s += 1
        params, opt, m = step_fn(params, opt, batch(s, 0))
        row["next_clean_guard_skip"] = float(m["guard_skip"])
        emit({"fault_tolerance_grad_fault": {**row, "card": smi}})
        check(row["guard_skip"] == 1.0 and same
              and row["next_clean_guard_skip"] == 0.0
              and np.isfinite(row["loss"]),
              f"grad fault {kind} not contained: {row}")
        res["grad_faults"][kind] = row

    # The checkpoint of the compressed state, across an in-place step.
    d = CKPT_DIR / "compressed"
    saved_step = int(opt.step)
    want = digest_tree((params, opt))
    ck = Checkpointer(str(d), keep=1, async_save=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(saved_step, (params, opt))
    t_saved = time.perf_counter()
    s += 1
    params, opt, m = hooks["nan"](params, opt, batch(s, 0))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t_saved
    check(int(opt.step) == saved_step + 1 and float(m["guard_skip"]) == 0.0,
          "the step after the save did not move the state")
    ck.wait()
    t_written = time.perf_counter()
    k_counts, p_counts = read_counters()
    routes, paths = tile_routes(), gemm_paths()
    check(not any(p_counts.values()), "fault tolerance: plain versions ran "
          f"on the compressed-state steps: {p_counts}")
    n_params = sum(p.numel() for p in tree_leaves(params))
    del params, opt, m, hooks
    gc.collect()
    torch.cuda.empty_cache()
    # The target: init_opt_state's structure, with the params in the bf16
    # a step leaves them (as Trainer restores them), its leaves unfilled
    # CPU tensors of their dtypes (restore reads their device and dtype;
    # the shapes come from the file).
    tp = init_params(cfg, seed=0, device="cuda")
    to = init_opt_state(tp, moments=FP8_MOMENTS, ef=True)
    tp = tree_map(lambda p: p.to(torch.bfloat16), tp)
    target = map_with_path(lambda k, t: torch.empty(
        tuple(t.shape), dtype=t.dtype), (tp, to))
    del tp, to
    torch.cuda.empty_cache()
    t0r = time.perf_counter()
    got = ck.restore(saved_step, target)
    restore_s = time.perf_counter() - t0r
    have = digest_tree(got)
    bad = sorted(k for k in want if have.get(k) != want[k])
    nv = [pm.mo.has_nvfp4 == bool((pm.mo.tags == TAG_NVFP4).any())
          for name in ("m", "v") for pm in tree_leaves(getattr(got[1], name))
          if isinstance(pm, PackedMoment)]
    gb = dir_gb(d / f"step_{saved_step}")
    res["checkpoint"] = {
        "arch": cfg.name, "layers": FT_LAYERS, "n_params": n_params,
        "step": saved_step, "restored_step": int(got[1].step),
        "leaves": len(want), "bit_identical": not bad and set(have) ==
        set(want), "differing": bad[:8], "has_nvfp4_from_tags": all(nv),
        "checkpoint_gb": gb, "save_block_s": t_saved - t0,
        "step_during_write_s": step_s, "write_s": t_written - t_saved,
        "write_gb_per_s": gb / (t_written - t_saved),
        "restore_s": restore_s, "restore_gb_per_s": gb / restore_s,
        "host_mem_available_gb_after_restore": host_mem_gb(), "card": smi}
    emit({"fault_tolerance_checkpoint": res["checkpoint"]})
    del got, target
    gc.collect()
    shutil.rmtree(d, ignore_errors=True)
    check(res["checkpoint"]["bit_identical"]
          and res["checkpoint"]["restored_step"] == saved_step and all(nv),
          f"compressed checkpoint round trip: {res['checkpoint']}")
    return res, k_counts, routes, paths


def ft_preempt_phase(smi):
    """Preemption and resume through Trainer: FT_ARCH, full width,
    FT_LAYERS layer(s), paper_default('sub3'), 2 x 1024 tokens
    (SyntheticLM seed 1234), PREEMPT_STEPS steps, the Trainer's dense
    state. Run 1 unbroken, no ckpt_dir. Run 2 with ckpt_dir (ckpt_every
    100, keep 1): SIGTERM to this process from a wrapper of step_fn
    during the second step; it must leave only step_2. Run 3, a fresh
    Trainer on the same directory, resumes at 2 and reaches
    PREEMPT_STEPS: params, master, m, v and step equal to run 1's (by
    digests) and its losses equal run 1's exactly. The SIGTERM handler
    of before the phase is restored."""
    import signal

    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_default
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainConfig, TrainerConfig
    cfg = dataclasses.replace(get_config(FT_ARCH), n_layers=FT_LAYERS)
    d = CKPT_DIR / "preempt"
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=1234)

    def trainer(**kw):
        # The Trainer draws its data with its own seed (as the
        # reference's): 1234 for the weights and the batches.
        return Trainer(cfg, paper_default("sub3"),
                       TrainConfig(optimizer=AdamWConfig(warmup_steps=1)),
                       TrainerConfig(total_steps=PREEMPT_STEPS, seed=1234,
                                     **kw), dcfg, device="cuda")

    def timed(ck, log):
        for name in ("save", "wait", "restore"):
            fn = getattr(ck, name)

            def wrap(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                log.append((_name, time.perf_counter() - t0))
                return out
            setattr(ck, name, wrap)

    def state(out):
        o = out["opt_state"]
        return digest_tree({"params": out["params"], "master": o.master,
                            "m": o.m, "v": o.v, "step": o.step})

    old = signal.getsignal(signal.SIGTERM)
    res = {}
    try:
        reset_counters()
        t0 = time.perf_counter()
        r1 = trainer().run()
        res["run1_s"] = time.perf_counter() - t0
        want, losses = state(r1), [h["loss"] for h in r1["history"]]
        del r1
        gc.collect()
        torch.cuda.empty_cache()

        t2 = trainer(ckpt_dir=str(d), ckpt_every=100, keep=1)
        log2 = []
        timed(t2.ckpt, log2)
        inner, calls = t2.step_fn, [0]

        def preempting(*a):
            if calls[0] == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            calls[0] += 1
            return inner(*a)

        t2.step_fn = preempting
        t0 = time.perf_counter()
        r2 = t2.run()
        res["run2_s"] = time.perf_counter() - t0
        left = sorted(os.listdir(d))
        res["run2"] = {"final_step": r2["final_step"], "dirs": left,
                       "ckpt_s": log2}
        check(r2["final_step"] == 2 and left == ["step_2"],
              f"the preempted run left {left}, final_step "
              f"{r2['final_step']}")
        del r2, t2
        gc.collect()
        torch.cuda.empty_cache()

        t3 = trainer(ckpt_dir=str(d), ckpt_every=100, keep=1)
        log3 = []
        timed(t3.ckpt, log3)
        t0 = time.perf_counter()
        r3 = t3.run()
        res["run3_s"] = time.perf_counter() - t0
        have = state(r3)
        resumed = [h["loss"] for h in r3["history"]]
        res["run3"] = {"steps": [h["step"] for h in r3["history"]],
                       "final_step": r3["final_step"],
                       "dirs": sorted(os.listdir(d)), "ckpt_s": log3}
        res["checkpoint_gb"] = dir_gb(d / f"step_{PREEMPT_STEPS}")
        res["losses_unbroken"], res["losses_resumed"] = losses, resumed
        res["bit_identical"] = have == want
        res["differing"] = sorted(k for k in want
                                  if have.get(k) != want[k])[:8]
        res["leaves"] = len(want)
        k_counts, p_counts = read_counters()
        routes, paths = tile_routes(), gemm_paths()
        del r3, t3
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        signal.signal(signal.SIGTERM, old)
    res.update(arch=cfg.name, layers=FT_LAYERS, steps=PREEMPT_STEPS,
               preempted_during_step=2, card=smi)
    emit({"fault_tolerance_preempt": res})
    check(res["run3"]["steps"] == list(range(2, PREEMPT_STEPS))
          and res["run3"]["dirs"] == [f"step_{PREEMPT_STEPS}"],
          f"the resumed run: {res['run3']}")
    check(res["bit_identical"] and resumed == losses[2:],
          f"the resumed run differs from the unbroken one: {res}")
    check(not any(p_counts.values()), "fault tolerance: plain versions ran "
          f"in the Trainer runs: {p_counts}")
    shutil.rmtree(d, ignore_errors=True)
    return res, k_counts, routes, paths


def bitflip_seeds(mo, n=3):
    """Seeds of payload_bitflip on ``mo``: the first that turns an E4M3
    block's byte into a NaN code, the first that lands in an E5M2 block,
    and the first that lands in an E4M3 block without a NaN code."""
    from repro_torch.kernels.ref import TAG_E4M3, TAG_E5M2
    pay = mo.payload_q.reshape(-1).cpu().numpy()
    tags = mo.tags.cpu().numpy()
    K = mo.payload_q.shape[-1]
    br, bk = mo.block
    want, out = ["nan", "e5m2", "e4m3"], {}
    for seed in range(4096):
        rng = np.random.default_rng(seed)
        idx = int(rng.integers(pay.size))
        b = int(pay[idx]) ^ (1 << int(rng.integers(8)))
        tag = tags[idx // K // br, idx % K // bk]
        kind = ("nan" if tag == TAG_E4M3 and (b & 0x7F) == 0x7F else
                "e5m2" if tag == TAG_E5M2 else
                "e4m3" if tag == TAG_E4M3 else None)
        if kind in want and kind not in out:
            out[kind] = seed
        if len(out) == n:
            break
    check(len(out) == n, f"no payload_bitflip seed for {want}: {out}")
    return out


def lane_seed(mo, lane, ok_tags):
    """The first seed whose scale_corrupt / micro_scale_corrupt element
    lies in a block of one of ``ok_tags``."""
    t = getattr(mo, lane)
    tags = mo.tags.cpu().numpy()
    rows, cols = t.shape[-2:]
    nr, nk = tags.shape
    for seed in range(4096):
        idx = int(np.random.default_rng(seed).integers(t.numel()))
        r, c = divmod(idx, cols)
        if tags[r * nr // rows, c * nk // cols] in ok_tags:
            return seed
    raise AssertionError(f"no {lane} seed lands in {ok_tags}")


def ft_pack_faults(ops, ref, Partition, smi):
    """The pack faults through the mixed GEMM: a wi-shaped weight (28672 x
    4096, llama3-8b's fused w1/w3 view) whose sub4 selection hits every
    tag (mixed_tags), packed by ops.quantize_pack on the card, corrupted
    by payload_bitflip (a seed giving an E4M3 NaN code, one in an E5M2
    block, one in an E4M3 block), scale_corrupt (an fp8 block) and
    micro_scale_corrupt (an NVFP4 block); ops.mixed_dot on the stream
    path (M = 4, bf16 and f32 out) and the tc path (M = 2048, bf16 out)
    against the plain version on the same CUDA tensors: nonfinite
    positions identical, finite values within gemm_tol. Each call must
    take its path (launch counters)."""
    from repro_torch.kernels.mixed_gemm import gemm_path, mixed_gemm_blocks
    from repro_torch.kernels.ref import TAG_E4M3, TAG_E5M2, TAG_NVFP4
    from repro_torch.robust import get_fault
    w = mixed_tags((28672, 4096), 21).cuda()
    mo, _ = ops.quantize_pack(w, Partition("block", (128, 128),
                                           align=(2, 16)), "sub4",
                              backend="cuda")
    mo = mo.compact()
    del w
    present = sorted(np.unique(mo.tags.cpu().numpy()).tolist())
    check(present == [0, 1, 2, 3], f"the wi pack's tags are {present}")
    faults = [("payload_bitflip", s, k)
              for k, s in bitflip_seeds(mo).items()]
    faults.append(("scale_corrupt", lane_seed(mo, "scales", (
        TAG_E4M3, TAG_E5M2, TAG_NVFP4)), "fp8/nvfp4 block"))
    faults.append(("micro_scale_corrupt", lane_seed(
        mo, "micro_scales", (TAG_NVFP4,)), "nvfp4 block"))
    g = torch.Generator(device="cuda").manual_seed(5)
    xs = {M: torch.randn(M, 4096, device="cuda", generator=g).to(
        torch.bfloat16) for M in (4, 2048)}
    rows = []
    for name, seed, where in faults:
        bad = get_fault(name).inject(mo, seed=seed)
        W = ref.decode_mixed_ref(bad)[:bad.shape[0]].float()
        for M, x in xs.items():
            path = gemm_path(M)
            for out_dtype in ((torch.bfloat16, torch.float32) if M == 4
                              else (torch.bfloat16,)):
                n0 = mixed_gemm_blocks.launches_by_path[path]
                yk = ops.mixed_dot(x, bad, out_dtype=out_dtype,
                                   backend="cuda")
                check(mixed_gemm_blocks.launches_by_path[path] == n0 + 1,
                      f"{name}: the kernel did not take the {path} path")
                yt = ops.mixed_dot(x, bad, out_dtype=out_dtype,
                                   backend="torch")
                fk, ft = torch.isfinite(yk), torch.isfinite(yt)
                same_nf = bool(torch.equal(fk, ft))
                tol = gemm_tol(x, torch.nan_to_num(W, 0.0, 0.0, 0.0), yt,
                               out_dtype)
                both = fk & ft
                err = torch.where(both, (yk.float() - yt.float()).abs(), 0.0)
                tol = torch.where(both, tol, 1.0)  # nonfinite: compared above
                ok = same_nf and bool((err <= tol).all())
                row = {"fault": name, "seed": seed, "lands": where,
                       "path": path, "M": M,
                       "out": str(out_dtype).split(".")[-1],
                       "nonfinite_kernel": int((~fk).sum()),
                       "nonfinite_plain": int((~ft).sum()),
                       "same_nonfinite": same_nf,
                       "max_err_over_tol": float(torch.where(
                           err > 0, err / tol, 0.0).max()), "ok": ok}
                emit({"fault_tolerance_pack": row})
                check(ok, f"pack fault not contained as the plain version "
                      f"contains it: {row}")
                rows.append(row)
        del W, bad
    torch.cuda.empty_cache()
    return {"cases": len(rows), "faults": [f[:3] for f in faults],
            "nonfinite_outputs": {f"{r['fault']} {r['lands']} {r['path']} "
                                  f"{r['out']}": r["nonfinite_kernel"]
                                  for r in rows},
            "max_err_over_tol": max(r["max_err_over_tol"] for r in rows),
            "card": smi}


def ft_stale_amax(smi):
    """stale_amax on the wi view (28672 x 4096, f32): the group amax shrunk
    by 8 is past requantize_with_backoff's two doublings, so the event
    passes through with GUARD_STALE_SCALE; shrunk by 4 it recovers after
    two. The function is plain PyTorch in the port as in the reference
    (no kernel on this path): held bit for bit against the same call on
    the CPU."""
    from repro_torch.core.mor import GUARD_STALE_SCALE, STAT_GUARD_FLAGS
    from repro_torch.robust import (get_fault, guard_flag_set,
                                    requantize_with_backoff)
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(28672, 4096, device="cuda", generator=g) * 0.02
    out = {}
    for shrink, want_attempts in ((8.0, 2), (4.0, 2)):
        amax = torch.amax(x.abs())
        stale = get_fault("stale_amax").inject(amax, shrink=shrink)
        y, st, att = requantize_with_backoff(x, stale)
        yc, stc, attc = requantize_with_backoff(x.cpu(), stale.cpu())
        flagged = bool(guard_flag_set(st[STAT_GUARD_FLAGS],
                                      GUARD_STALE_SCALE))
        same = (torch.equal(bits16(y.cpu()), bits16(yc))
                and torch.equal(bits16(st.cpu()), bits16(stc))
                and int(att) == int(attc))
        row = {"shrink": shrink, "attempts": int(att),
               "stale_scale_flag": flagged,
               "passthrough": bool(torch.equal(y, x)),
               "cuda_equals_cpu": same}
        check(same and int(att) == want_attempts
              and flagged == (shrink == 8.0)
              and row["passthrough"] == (shrink == 8.0),
              f"stale_amax: {row}")
        out[f"shrink_{int(shrink)}"] = row
    out["card"] = smi
    return out


def ft_kv_trash(smi):
    """kv_page_trash in the llama3-8b engine at full width, STATE_LAYERS
    layers, sub3 QTensor weights: 3 slots, 3 requests; the victim's first
    page trashed after 5 scheduler steps. The victim is quarantined with
    its reason in req.error; every other request's tokens bit-identical
    to the clean run. Returns (result, launch counts, tile routes, GEMM
    paths) of both engine runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
    from repro_torch.models import init_params
    from repro_torch.robust import get_fault
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=STATE_LAYERS)
    params = init_params(cfg, seed=0, device="cuda")
    reset_counters()

    def serve(inject_after=None):
        eng = Engine(cfg, MoRDotPolicy(), params,
                     ServeConfig(slots=3, max_seq=512, prefill_chunk=32),
                     quantize=MoRPolicy(recipe="sub3"), device="cuda")
        rng = np.random.default_rng(11)
        reqs = [Request(i, rng.integers(0, cfg.vocab, L).astype(np.int32),
                        max_tokens=16) for i, L in enumerate((3, 17, 9))]
        for r in reqs:
            eng.submit(r)
        page = None
        if inject_after is not None:
            for _ in range(inject_after):
                eng.step()
            check(eng.slot_state[0] == "decode",
                  f"the victim is {eng.slot_state[0]}, not decoding")
            page = eng.pool._owned[0][0]
            get_fault("kv_page_trash").inject(eng.pool, page)
        eng.run_to_completion()
        return reqs, eng, page

    ref_reqs, _, _ = serve()
    inj, eng, page = serve(inject_after=5)
    k_counts, p_counts = read_counters()
    routes, paths = tile_routes(), gemm_paths()
    v = inj[0]
    res = {"victim_error": v.error, "victim_tokens": len(v.out),
           "clean_victim_tokens": len(ref_reqs[0].out), "page": page,
           "others_identical": all(a.out == b.out and a.error is None
                                   for a, b in zip(inj[1:], ref_reqs[1:])),
           "quarantined": [r.rid for r in eng.quarantined],
           "pages_free_after": len(eng.pool.free),
           "launches": k_counts, "gemm_paths": paths, "card": smi}
    emit({"fault_tolerance_kv_trash": res})
    check(all(r.error is None for r in ref_reqs)
          and v.error is not None and v.error.startswith("quarantined:")
          and "nonfinite logits" in v.error and res["others_identical"]
          and res["quarantined"] == [0]
          and res["pages_free_after"] == eng.pool.n_pages
          and paths["stream"] == k_counts["mixed_gemm"]
          and not any(p_counts.values()), f"kv_page_trash: {res}")
    del params, eng
    gc.collect()
    torch.cuda.empty_cache()
    return res, k_counts, routes, paths


def ft_head_repair(smi):
    """The head's forward (HeadMatmul: bf16 x bf16 -> f32 on the tensor
    cores, aten::mm.dtype) on the training batch's head input (a
    one-layer model's final-norm output, 2 x 1024 tokens) of llama3-8b
    and nemotron3-8b: logits within gemm_tol of the f32 product; the
    backward bit for bit against autograd through the old f32 expression
    on the same dlogits; the forward's and backward's device times, old
    and new (CUDA events)."""
    from repro_torch.configs import get_config
    from repro_torch.core.device import ieee_f32_matmul
    from repro_torch.core.policy import paper_default
    from repro_torch.models import init_params
    from repro_torch.models import transformer as T
    out = {}
    for arch in ("llama3-8b", "nemotron3-8b"):
        cfg = dataclasses.replace(get_config(arch), n_layers=1)
        params = init_params(cfg, seed=0, device="cuda")
        seen, real = [], T.HeadMatmul

        class Capture:
            @staticmethod
            def apply(x, head):
                seen.append((x.detach(), head.detach()))
                return real.apply(x, head)

        with torch.no_grad(), patched(T, "HeadMatmul", Capture):
            T.forward(cfg, paper_default("sub3"), params,
                      train_batch(cfg, 0), mode="train", remat=False)
        x, head = seen[0]
        del params
        torch.cuda.empty_cache()
        x2 = x.reshape(-1, x.shape[-1])

        def f32_product():
            with ieee_f32_matmul():
                return x2.to(torch.float32) @ head.to(torch.float32)

        y = T.HeadMatmul.apply(x2, head)
        y0 = f32_product()
        tol = gemm_tol(x2, head.T, y0, torch.float32)
        err = (y - y0).abs()
        fwd_ok = bool((err <= tol).all())
        ratio = float(torch.where(err > 0, err / tol, 0.0).max())
        del err, tol
        g = torch.Generator(device="cuda").manual_seed(7)
        dl = torch.randn(y.shape, device="cuda", generator=g) * 1e-4
        xr, hr = x2.clone().requires_grad_(True), \
            head.clone().requires_grad_(True)
        gx, gh = torch.autograd.grad(T.HeadMatmul.apply(xr, hr), (xr, hr),
                                     dl)
        with ieee_f32_matmul():
            y_old = xr.to(torch.float32) @ hr.to(torch.float32)
            gx0, gh0 = torch.autograd.grad(y_old, (xr, hr), dl)
        bwd_ok = torch.equal(gx, gx0) and torch.equal(gh, gh0)
        del gx0, gh0, y_old, y, y0

        def bwd_new():
            torch.autograd.grad(T.HeadMatmul.apply(xr, hr), (xr, hr), dl)

        Mm, K, N = x2.shape[0], x2.shape[1], head.shape[1]
        ms_new = time_ms(lambda: T.HeadMatmul.apply(x2, head), iters=10)
        ms_old = time_ms(f32_product, iters=5)
        ms_fb = time_ms(bwd_new, iters=5)
        b = bound(2 * (Mm * K + K * N) + 4 * Mm * N, 2.0 * Mm * N * K)
        out[arch] = {"shape": [Mm, N, K], "fwd_ok": fwd_ok,
                     "fwd_max_err_over_tol": ratio, "bwd_bit_identical":
                     bool(bwd_ok), "fwd_ms_bf16_tc": ms_new,
                     "fwd_ms_f32": ms_old, "fwd_bound_ms": b[0],
                     "fwd_bwd_ms": ms_fb,
                     "bwd_ms": ms_fb - ms_new, "card": smi}
        emit({"fault_tolerance_head": {"arch": arch, **out[arch]}})
        check(fwd_ok and bwd_ok, f"head repair {arch}: {out[arch]}")
        del x, head, x2, xr, hr, dl, gx, gh, seen
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_fault_tolerance(ops, ref, Partition, smi):
    """Checkpoint/restart and the chaos harness on the card (module
    docstring, step 9): the compressed state's gradient faults and its
    checkpoint round trip, the preempt-and-resume Trainer runs, the pack
    faults through both mixed GEMM paths, stale_amax, a trashed KV page
    in the engine, and the head repair. The counters are zeroed just
    before each main-path part and read just after; the parts' counts
    are summed (the pack faults' kernel-vs-plain calls are not). The
    checkpoint directories are removed at the end, also on a failure
    (which is re-raised). Returns (result, launches, tile routes, GEMM
    paths)."""
    t0 = time.perf_counter()
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    du = shutil.disk_usage(CKPT_DIR)
    res = {"disk_total_gb": du.total / 1e9, "disk_free_gb": du.free / 1e9,
           "host_mem_available_gb": host_mem_gb(), "ckpt_dir": str(CKPT_DIR),
           "card": smi}
    emit({"fault_tolerance_resources": res})
    parts = []
    try:
        st, *c = ft_state_phase(smi)
        parts.append(c)
        res.update(st)
        pre, *c = ft_preempt_phase(smi)
        parts.append(c)
        res["preempt"] = pre
        res["pack_faults"] = ft_pack_faults(ops, ref, Partition, smi)
        res["stale_amax"] = ft_stale_amax(smi)
        kv, *c = ft_kv_trash(smi)
        parts.append(c)
        res["kv_trash"] = kv
        res["head"] = ft_head_repair(smi)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    launches = {k: sum(p[0][k] for p in parts) for k in parts[0][0]}
    routes = {k: {r: sum(p[1][k][r] for p in parts)
                  for r in ("tile", "generic")} for k in TILE_KERNELS}
    paths = {k: sum(p[2][k] for p in parts) for k in ("stream", "tc")}
    for kern in ("mor_select_select", "mor_select_pack", "mixed_gemm"):
        check(launches[kern] > 0,
              f"fault tolerance: {kern} launched no time on its path")
    res["launches"] = launches
    res["phase_s"] = time.perf_counter() - t0
    return res, launches, routes, paths


def flat_tree(tree, path=""):
    """A nested dict's leaves by their '/'-joined key paths, in sorted key
    order."""
    out = {}
    for k in sorted(tree):
        name = f"{path}/{k}" if path else k
        if isinstance(tree[k], dict):
            out.update(flat_tree(tree[k], name))
        else:
            out[name] = tree[k]
    return out


def step_grads(cfg, pol, params, batch):
    """Loss, forward stats rows, parameter gradients and backward stats
    rows (the tokens' gradients) of one loss evaluation; the stats rows
    by key path (``flat_tree``)."""
    from repro_torch.models.api import make_loss_fn, make_tokens
    from repro_torch.optim.adamw import tree_leaves, tree_map
    loss_fn = make_loss_fn(cfg, pol, remat=True)
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    toks = make_tokens(cfg, device=batch["labels"].device)
    total, aux = loss_fn(p, toks, batch)
    pl, tl = tree_leaves(p), flat_tree(toks)
    g = torch.autograd.grad(total, pl + list(tl.values()))
    return (total.detach(), flat_tree(aux["mor_fwd"]), list(g[:len(pl)]),
            dict(zip(tl, g[len(pl):])))


def compare_rows(a, b, what, flips=None):
    """Stats rows of the kernel path (a) and the plain path (b): every
    lane but the relative error bit for bit; the relative error (a ratio
    of error sums the kernels add in another order) within 1e-6. With
    ``flips`` a differing row is recorded there instead of failing."""
    from repro_torch.core.mor import STAT_REL_ERR
    for name in sorted(a):
        ra, rb = a[name].reshape(-1, a[name].shape[-1]), \
            b[name].reshape(-1, b[name].shape[-1])
        lanes = [i for i in range(ra.shape[-1]) if i != STAT_REL_ERR]
        same = (bits16(ra[:, lanes].contiguous())
                == bits16(rb[:, lanes].contiguous())).all(dim=1)
        rel = ((ra[:, STAT_REL_ERR] - rb[:, STAT_REL_ERR]).abs()
               / rb[:, STAT_REL_ERR].abs().clamp_min(1e-30))
        for i in range(ra.shape[0]):
            if bool(same[i]) and float(rel[i]) <= 1e-6:
                continue
            if flips is None:
                raise AssertionError(f"{what} {name} row {i}: kernel path "
                                     f"{ra[i].tolist()} plain {rb[i].tolist()}")
            flips.append(f"{name}[{i}]")


def fused_gemm_shapes(blocks, M, enc_M=None):
    """{(M, N, K)} of a train step's fused GEMMs -- forward (M, N, K),
    dgrad (M, K, N), wgrad (K, N, M) -- for each (L, K, N) weight stack
    in ``blocks`` at M rows (a whisper layer's xwkv at ``enc_M``, the
    encoder output's rows)."""
    out = set()
    for name, w in flat_tree(blocks).items():
        if w.dim() == 3:
            m = enc_M if name.endswith("xwkv") else M
            K, N = w.shape[1:]
            out |= {(m, N, K), (m, K, N), (K, N, m)}
    return out


def train_depth2(cfg, ops, ref, params, batch, recipes, want, dots, what,
                 axes=()):
    """One loss-and-gradient evaluation, kernel path against plain path
    (``backend='torch'`` on the same CUDA tensors), under each of
    ``recipes`` (fake-quant: 'tensor', 'sub3'): loss bit for bit, forward
    stats rows bit for bit but the relative-error lane (1e-6), backward
    stats the same or the flipped events named, gradients within 2^-6
    |g| + 2^-14 max|g| of a leaf (bit for bit where nothing flips; the
    embedding's gather backward accumulates with atomics). Fused sub3:
    every mixed_gemm of the step held against the plain version on its
    real inputs at 1e-5 sum|a||b| + 1 bf16 ulp, its (M, N, K) covering
    ``want``, 4 GEMMs for each of the ``dots`` mor_dots. ``axes``: the
    mesh axes of every event (``with_mesh_axes``; the caller binds the
    mesh)."""
    from repro_torch.core.policy import with_mesh_axes
    pols = {k: with_mesh_axes(p, axes) if axes else p
            for k, p in train_policies().items()}
    res = {}
    for name in recipes:
        k = step_grads(cfg, with_backend(pols[name], "auto"), params, batch)
        t = step_grads(cfg, with_backend(pols[name], "torch"), params, batch)
        check(torch.equal(k[0], t[0]),
              f"{what} {name}: loss {float(k[0])} vs plain {float(t[0])}")
        compare_rows(k[1], t[1], f"{what} {name} fwd stats")
        flips = []
        compare_rows(k[3], t[3], f"{what} {name} bwd stats", flips)
        leaves = []
        for i, (gk, gt) in enumerate(zip(k[2], t[2])):
            d = (gk.float() - gt.float()).abs()
            tol = 2.0**-6 * gt.float().abs() + 2.0**-14 * float(
                gt.float().abs().max())
            check(bool(torch.all(d <= tol)),
                  f"{what} {name}: gradient leaf {i} differs by "
                  f"{float(d.max())}")
            leaves.append({"leaf": i, "identical": bool(torch.equal(
                bits16(gk), bits16(gt))), "max_abs_diff": float(d.max())})
        res[name] = {"loss": float(k[0]), "bwd_flipped_events": flips,
                     "fwd_stats_rows": len(k[1]), "bwd_stats_rows": len(k[3]),
                     "grad_leaves_identical": sum(l["identical"]
                                                  for l in leaves),
                     "grad_leaves": len(leaves),
                     "grad_max_abs_diff": max(l["max_abs_diff"]
                                              for l in leaves)}
        del k, t
    gemms = {}
    with patched(ops, "mixed_gemm", checked_gemm(ops, ref, gemms)):
        loss, _, g, _ = step_grads(cfg, pols["sub3_fused"], params, batch)
    check(np.isfinite(float(loss)) and all(
        bool(torch.isfinite(x).all()) for x in g), f"{what} fused: nonfinite")
    check(want <= {k[:3] for k in gemms}, f"{what} fused GEMM shapes "
          f"{sorted(gemms)} miss some of {sorted(want)}")
    check(sum(v["calls"] for v in gemms.values()) == 4 * dots,
          f"{what} fused: {gemms} is not 4 GEMMs for each of {dots} mor_dots")
    res["sub3_fused"] = {"loss": float(loss), "gemms": [
        {"M": k[0], "N": k[1], "K": k[2], "path": k[3], **v}
        for k, v in sorted(gemms.items())]}
    return res


def phase_train_depth2(cfg, ops, ref):
    """``train_depth2`` on llama3-8b at full width and depth 2, 2 x 1024
    tokens, under the tensor recipe and sub3."""
    from repro_torch.models import init_params
    cfg = dataclasses.replace(cfg, n_layers=2)
    params = init_params(cfg, seed=1, device="cuda")
    res = train_depth2(cfg, ops, ref, params, train_batch(cfg, 0),
                       ("tensor", "sub3"),
                       fused_gemm_shapes(params["blocks"],
                                         TRAIN_BATCH * TRAIN_SEQ),
                       4 * cfg.n_units, "depth-2")
    del params
    torch.cuda.empty_cache()
    return res


# The multi_device phase: four ranks on the one card, each its own process
# over gloo (NCCL refuses two ranks on one device), through a file://
# store; mor_dot at llama3-8b's training wi shape, then data-parallel
# training of MD_ARCH at full width, 1 x MD_SEQ tokens a rank.
MD_WORLD = 4
MD_ARCH = "gemma-2b"
MD_SEQ = 1024
MD_DOT = (2048, 4096, 28672)   # x (M, K), w (K, N): llama3-8b's wi
MD_NAN_AT = 2                  # the rank whose shard holds the NaN
MD_DEV = "cuda"
MD_DIR = ROOT / "build" / "multi_device"
MD_TIMEOUT = 900
# A rank's share of the card beyond its tensors: its CUDA context and
# cuBLAS workspace (the parent keeps one too), and the allocator's slack
# (with expandable segments; without them a first card run of the phase
# at depth 2 held 4.18 GiB reserved but unallocated a rank, and failed
# out of memory).
MD_CONTEXT_BYTES = 0.75e9
MD_SLACK_BYTES = 1e9


def md_depth(cfg):
    """Depth of MD_ARCH's training: 2, or 1 where the per-rank reckoning
    (bf16 params and grads, f32 master and two moments, f32 logits with
    their softmax and gradient, bf16 activations of a layer saved for the
    backward, the f32 copy of the largest leaf that ``global_norm``
    makes, context and slack) leaves less than 10 GB of the card free
    with MD_WORLD ranks and the parent. Returns (depth, the
    reckoning)."""
    total = torch.cuda.get_device_properties(0).total_memory
    for depth in (2, 1):
        c = dataclasses.replace(cfg, n_layers=depth)
        n = c.param_count()
        state = n * (2 + 2 + 4 + 4 + 4)
        logits = MD_SEQ * c.vocab * 4 * 3
        acts = depth * MD_SEQ * (12 * c.d_model + 4 * c.d_ff) * 2
        largest = 4 * max(c.vocab * c.d_model, 2 * c.d_model * c.d_ff)
        per_rank = state + logits + acts + largest + MD_CONTEXT_BYTES + \
            MD_SLACK_BYTES
        free = total - MD_WORLD * per_rank - MD_CONTEXT_BYTES
        row = {"depth": depth, "params": n, "per_rank_gb": per_rank / 1e9,
               "free_gb": free / 1e9, "card_gb": total / 1e9}
        if free >= 10e9:
            return depth, row
    return 1, row


def md_rows_equal(got, want, what):
    """Stats rows of a sharded run against the one-rank run's: every lane
    but the relative error bit for bit, that within rtol 2e-6 (the ranks'
    partial sums associate differently; tests/test_sharded_mor.py)."""
    from repro_torch.core.mor import STAT_REL_ERR
    lanes = [i for i in range(got.shape[-1]) if i != STAT_REL_ERR]
    check(same_bits([got[..., lanes]], [want[..., lanes]]),
          f"{what}: stats {got.tolist()} vs one rank {want.tolist()}")
    g, w = got[..., STAT_REL_ERR], want[..., STAT_REL_ERR]
    check(bool(torch.all((g - w).abs() <= 2e-6 * w.abs() + 1e-7)),
          f"{what}: rel_err {g.tolist()} vs one rank {w.tolist()}")


def md_run_dot(x, w, dy, pol, packs):
    """mor_dot forward and backward: (y, fwd stats, dx, dw, bwd stats),
    the packs quantize_for_gemm made appended to ``packs``."""
    from repro_torch.core import linear
    from repro_torch.core.linear import mor_dot, new_token
    spy = linear.quantize_for_gemm

    def quantize(t, p):
        mo, st = spy(t, p)
        packs.append(mo)
        return mo, st

    x = x.detach().requires_grad_(True)
    w = w.detach().requires_grad_(True)
    tok = new_token(x.device)
    with patched(linear, "quantize_for_gemm", quantize):
        y, st = mor_dot(x, w, tok, pol)
        y.backward(dy)
    return y.detach(), st, x.grad, w.grad, tok.grad


def md_dw_bound(mass, want):
    """Elementwise bound on |sum of the ranks' dw - the one-rank dw|.
    Each rank's partial dw and the one-rank dw are bf16 roundings of f32
    sums over the same quantized products (the row blocks are whole, so
    the ranks quantize exactly as the one rank does): each rounding is
    at most 2^-8 of its value, so the error is within 2^-8 (sum_r |dw_r|
    + |dw|). ``mass`` is sum_r |dw_r|. The f32 sums' own rounding adds
    ~sqrt(2048) 2^-24 of the ~1.3 that |x| |dy| sums to an entry (~4e-6):
    1e-5."""
    return 2.0 ** -8 * (mass + want.abs()) + 1e-5


def md_mor_dot(rank, mesh, totals):
    """(a): mor_dot at the wi shape under TENSOR_MOR, sub3 and fused sub3
    (128 x 128 blocks), x and dy sharded by rows, w replicated, against
    the one-rank run of the global batch that each rank makes itself on
    the same card: y and dx bit for bit, the ranks' dw summed (f32,
    gloo) within ``md_dw_bound`` of the one-rank dw (and that bound
    refusing the sum without this rank's partial, and twice the dw),
    every forward and backward stats row
    (``md_rows_equal``), and under fused sub3 every pack's tags, scales
    and payload lanes equal to the one-rank pack's rows."""
    import torch.distributed as dist

    from repro_torch.core import collectives as col
    from repro_torch.core.policy import with_mesh_axes
    M, K, N = MD_DOT
    g = torch.Generator(device=MD_DEV).manual_seed(7)
    x = torch.randn(M, K, generator=g, device=MD_DEV).to(torch.bfloat16)
    w = (torch.randn(K, N, generator=g, device=MD_DEV) * 0.02).to(
        torch.bfloat16)
    dy = (torch.randn(M, N, generator=g, device=MD_DEV) * 1e-3).to(
        torch.bfloat16)
    m = M // MD_WORLD
    rows = slice(rank * m, (rank + 1) * m)
    res = {}
    for name, pol in train_policies().items():
        one_packs, packs = [], []
        one = md_run_dot(x, w, dy, pol, one_packs)
        reset_counters()
        with col.use_mesh(mesh):
            got = md_run_dot(x[rows], w, dy[rows],
                             with_mesh_axes(pol, ("data",)), packs)
        totals.add_current(f"multi_device mor_dot {name}")
        what = f"multi_device rank {rank} mor_dot {name}"
        check(same_bits([got[0]], [one[0][rows]]), f"{what}: y differs")
        check(same_bits([got[2]], [one[2][rows]]), f"{what}: dx differs")
        md_rows_equal(got[1], one[1], f"{what} fwd")
        md_rows_equal(got[4], one[4], f"{what} bwd")
        part, want = got[3].float(), one[3].float()
        dw, mass = part.clone(), part.abs()
        dist.all_reduce(dw)
        dist.all_reduce(mass)
        bound = md_dw_bound(mass, want)
        err = (dw - want).abs()
        check(bool(torch.all(err <= bound)),
              f"{what}: summed dw off by {float(err.max())}, "
              f"{float((err / bound).max())} of its bound")
        # The gate catches the faults it is there for: a rank's partial
        # left out of the sum, or a dw twice the one-rank one.
        dropped = (dw - part - want).abs()
        check(not bool(torch.all(dropped <= bound)),
              f"{what}: the dw gate passes a sum without this rank")
        check(not bool(torch.all(want.abs() <= bound)),
              f"{what}: the dw gate passes twice the dw")
        check(len(packs) == len(one_packs), f"{what}: pack counts")
        for p, q in zip(packs, one_packs):
            if p.shape != q.shape:  # sharded rows: this rank's block rows
                b = p.shape[-2] // p.block[0]
                q = dataclasses.replace(q, **{
                    k: getattr(q, k)[..., rank * (
                        b if k in ("tags", "scales") else p.shape[-2]):
                        (rank + 1) * (b if k in ("tags", "scales")
                                      else p.shape[-2]), :]
                    for k in ("tags", "scales", "payload_q",
                              "payload_bf16")})
            for k in ("tags", "scales", "payload_q", "payload_bf16"):
                check(same_bits([getattr(p, k)], [getattr(q, k)]),
                      f"{what}: pack {k} differs")
        res[name] = {"packs": len(packs), "dw_max_abs_err": float(err.max()),
                     "dw_err_over_bound": float((err / bound).max()),
                     "dw_dropped_rank_max_err": float(dropped.max()),
                     "y_dx_stats": "bit for bit"}
        del one, got, dw, part, want, mass, bound, err, dropped, one_packs, \
            packs
    return res


def md_step(cfg, pol, params, batch, axes, mesh, steps=2):
    """``steps`` make_train_step steps (TrainConfig(mor_mesh_axes=axes))
    from ``params``: (the first step's forward stats rows by key path,
    its forward quantization events as (operand, policy, stats row) in
    call order, the last step's wall seconds, its collectives and their
    host seconds, the losses)."""
    from repro_torch.core import collectives as col
    from repro_torch.core import linear
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train import train_step as ts
    trees, events = [], []
    summarize, quantize = ts.summarize_mor_stats, linear.mor_quantize

    def tree_spy(fwd, bwd, opt=None):
        trees.append(flat_tree(fwd))
        return summarize(fwd, bwd, opt)

    def event_spy(x, p):
        y, st = quantize(x, p)
        if not trees:  # the first step, before its stats are summarized
            events.append((x.detach(), p, st))
        return y, st

    step = make_train_step(cfg, pol, TrainConfig(
        optimizer=AdamWConfig(warmup_steps=1), mor_mesh_axes=axes))
    opt = init_opt_state(params)
    losses = []
    with patched(ts, "summarize_mor_stats", tree_spy), \
            patched(linear, "mor_quantize", event_spy), col.use_mesh(mesh):
        for _ in range(steps):
            calls, host = col.COLLECTIVES["calls"], col.COLLECTIVES["host_s"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
            wall = time.perf_counter() - t0
    check(all(np.isfinite(losses)), f"multi_device step: losses {losses}")
    del opt, params
    return trees[0], events, wall, col.COLLECTIVES["calls"] - calls, \
        col.COLLECTIVES["host_s"] - host, losses


def md_events_vs_one_rank(events, n_fwd, mesh, what):
    """The first ``n_fwd`` quantization events of a sharded step (the
    forward's: an activation event, then a weight event, a mor_dot) held
    against the one-rank quantization of the same global operand: the
    activation's shards gathered from the ranks in row order, the
    replicated weight as it is (``md_rows_equal``). Returns the rows
    checked."""
    from repro_torch.core import collectives as col
    from repro_torch.core.mor import mor_quantize
    check(len(events) >= n_fwd, f"{what}: {len(events)} events")
    with col.use_mesh(mesh):
        for i, (x, p, st) in enumerate(events[:n_fwd]):
            if i % 2 == 0:  # activation rows, sharded by rank
                g = col.all_gather_over(x, "data")
                x = g.transpose(0, 1).reshape(x.shape[0], -1, x.shape[-1])
            one = mor_quantize(x, p.replace(mesh_axes=()))[1]
            md_rows_equal(st, one, f"{what} event {i}")
    return n_fwd


def md_train(rank, mesh, depth, ops, ref, totals):
    """(b): MD_ARCH at full width and ``depth``, 1 x MD_SEQ tokens a
    rank. Rank 0 first steps the global batch alone (MD_WORLD x MD_SEQ,
    no mesh); then every rank steps its row under
    TrainConfig(mor_mesh_axes=('data',)), twice, the second timed, losses
    finite. Every forward quantization event of the first sharded step
    is held against the one-rank quantization of the same global operand
    (``md_events_vs_one_rank``). The one-rank step's forward stats rows
    are compared too, and the rows equal (``md_rows_equal``'s rule) are
    counted, not gated: cuBLAS sums a bf16 GEMM of 4 x 1024 rows in
    another order than one of 1024, so from the first GEMM on the two
    steps quantize operands a bf16 ulp apart in places. Then
    ``train_depth2`` on the mesh: the kernel path against the plain path
    (``backend='torch'``) under the tensor recipe and sub3, and fused
    sub3 with every mixed_gemm held against the plain version
    (``checked_gemm``)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.mor import STAT_REL_ERR
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config(MD_ARCH), n_layers=depth)
    pol = train_policies()["sub3"]
    batch = train_batch(cfg, 0, batch=MD_WORLD, seq=MD_SEQ, device=MD_DEV)
    mine = {k: v[rank:rank + 1] for k, v in batch.items()}
    res = {"arch": cfg.name, "depth": depth, "tokens_per_rank": MD_SEQ}
    one = [None]
    if rank == 0:
        fwd, _, wall, _, _, losses = md_step(
            cfg, pol, init_params(cfg, seed=1, device=MD_DEV), batch, (),
            mesh)
        one[0] = {k: v.cpu() for k, v in fwd.items()}
        res["one_rank"] = {"step_s": wall, "losses": losses,
                           "tokens": MD_WORLD * MD_SEQ}
        gc.collect()
        torch.cuda.empty_cache()
    dist.broadcast_object_list(one, src=0)
    reset_counters()
    fwd, events, wall, calls, host, losses = md_step(
        cfg, pol, init_params(cfg, seed=1, device=MD_DEV), mine,
        ("data",), mesh)
    totals.add_current(f"multi_device train rank {rank}")
    what = f"multi_device rank {rank}"
    res["fwd_events_vs_one_rank_operand"] = md_events_vs_one_rank(
        events, 2 * 4 * cfg.n_units, mesh, what)
    del events
    check(sorted(fwd) == sorted(one[0]), f"{what}: fwd stats trees")
    lanes = [i for i in range(14) if i != STAT_REL_ERR]
    same = total = 0
    for k, v in fwd.items():
        a = v.cpu().reshape(-1, v.shape[-1])
        b = one[0][k].reshape(-1, a.shape[-1])
        rel = (a[:, STAT_REL_ERR] - b[:, STAT_REL_ERR]).abs() <= \
            2e-6 * b[:, STAT_REL_ERR].abs() + 1e-7
        same += int(((bits16(a[:, lanes]) == bits16(b[:, lanes])).all(1)
                     & rel).sum())
        total += a.shape[0]
    res["ranks"] = {"step_s": wall, "losses": losses,
                    "collectives_per_step": calls,
                    "collective_host_s_per_step": host,
                    "fwd_stats_rows": total,
                    "fwd_rows_equal_to_one_rank_step": same,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=1, device=MD_DEV)
    from repro_torch.core import collectives as col
    with col.use_mesh(mesh):
        res["kernel_vs_plain"] = train_depth2(
            cfg, ops, ref, params, mine, ("tensor", "sub3"),
            fused_gemm_shapes(params["blocks"], MD_SEQ), 4 * cfg.n_units,
            f"multi_device rank {rank}", axes=("data",))
    del params
    return res


def md_nan(rank, mesh, totals):
    """(c): one NaN in rank MD_NAN_AT's shard of a wi-shaped activation:
    every rank's amax and guard-flag lanes (2, 12) under the tensor
    recipe and sub3 equal the one-rank run's on the global operand (NaN
    amax, GUARD_NONFINITE_AMAX set); pmax_over of a NaN on each rank in
    turn is NaN on every rank."""
    from repro_torch.core import collectives as col
    from repro_torch.core.mor import STAT_AMAX, STAT_GUARD_FLAGS, mor_quantize
    from repro_torch.core.policy import MoRPolicy
    M, K, _ = MD_DOT
    g = torch.Generator(device=MD_DEV).manual_seed(11)
    x = torch.randn(M, K, generator=g, device=MD_DEV).to(torch.bfloat16)
    m = M // MD_WORLD
    x[MD_NAN_AT * m + 5, 17] = float("nan")
    res = {}
    lanes = [STAT_AMAX, STAT_GUARD_FLAGS]
    for rec in ("tensor", "sub3"):
        pol = MoRPolicy(recipe=rec)
        _, one = mor_quantize(x, pol)
        reset_counters()
        with col.use_mesh(mesh):
            _, got = mor_quantize(x[rank * m:(rank + 1) * m],
                                  pol.replace(mesh_axes=("data",)))
        totals.add_current(f"multi_device nan {rec}")
        check(same_bits([got[lanes]], [one[lanes]]) and bool(
            torch.isnan(one[STAT_AMAX])) and int(one[STAT_GUARD_FLAGS]) & 1,
              f"multi_device rank {rank} nan {rec}: lanes {got[lanes]} vs "
              f"one rank {one[lanes]}")
        res[rec] = got[lanes].tolist()
    pmax = []
    with col.use_mesh(mesh):
        for at in range(MD_WORLD):
            t = torch.full((1,), float("nan") if rank == at else float(rank),
                           device=MD_DEV)
            pmax.append(float(col.pmax_over(t, ("data",))))
    check(all(np.isnan(pmax)), f"multi_device rank {rank}: pmax {pmax}")
    res["pmax_nan_each_rank"] = "nan"
    return res


def md_leaf_rows(g, data):
    """(this rank's rows of the gradient leaf ``g`` on a data axis of 2,
    whether they are cut): its half of the leaf2d rows where they split
    into whole 128-row blocks, else the whole leaf."""
    from repro_torch.optim.compress import leaf2d
    if leaf2d(g).shape[0] % (2 * 128):
        return g, False
    return leaf2d(g).chunk(2)[data], True


MD_STRIPE_ROWS = 8192  # rows of a one-rank pack decoded at a time


def md_decoded_sum_check(mine, out, what):
    """The pods' one-rank decodes summed in f32 in pod order, bit for bit
    ``out``: this rank's rows of its pod's one-rank pack (``mine``)
    decoded a stripe of MD_STRIPE_ROWS rows at a time, each stripe
    gathered over 'pod' (the other pod's rank at this data index sends
    its stripe)."""
    from repro_torch.core import collectives as col
    out2d = out.reshape(mine.shape)
    lanes = ("payload_q", "payload_bf16", "payload_nib", "micro_scales")
    br = mine.block[0]
    for r0 in range(0, mine.shape[0], MD_STRIPE_ROWS):
        r1 = min(r0 + MD_STRIPE_ROWS, mine.shape[0])
        n_blk = -(-r1 // br)  # block rows through r1, padding included
        part = {}
        for lane in lanes:  # dense lanes by rows, compact ones whole
            t, f = getattr(mine, lane), 2 if lane == "payload_nib" else 1
            dense = t.shape[0] == mine.padded_shape[0] // f
            part[lane] = t[r0 // f:n_blk * br // f] if dense else t
        sub = dataclasses.replace(
            mine, shape=(r1 - r0, mine.shape[1]),
            tags=mine.tags[r0 // br:n_blk],
            scales=mine.scales[r0 // br:n_blk], **part)
        pods = col.all_gather_over(sub.dequant().to(torch.float32), "pod")
        check(same_bits([out2d[r0:r1]], [(pods[0] + pods[1]).to(
            out.dtype)]), f"{what}: the sum differs from the one-rank "
            f"decodes' sum in rows {r0}-{r1}")


def md_pod_psum(rank, depth, totals):
    """(d): the cross-pod compressed sum at full width. MD_ARCH at
    ``depth`` on a (pod 2, data 2) mesh: both ranks of a pod compute the
    sub3 step's gradients on the pod's half of the batch (2 x MD_SEQ
    tokens), each keeps its rows of every leaf whose leaf2d rows split
    into whole 128-row blocks (``md_leaf_rows``) and the other leaves
    whole, and runs make_pod_compressed_psum('pod', sub3, inner_axes=
    ('data',)) over every leaf (counted). Gates, per leaf: the pack
    lanes the collective shipped for this pod bit for bit the one-rank
    pack of the pod's whole leaf (its shards gathered over 'data'), at
    this rank's rows; the sum bit for bit the pods' one-rank decodes
    summed in f32 in pod order; the kernel path bit for bit the plain
    path (``backend='torch'``). The flat path on the largest leaf within
    2^-3 of the pods' amaxes summed of the exact sum (E4M3's rounding).
    Reports the pack launches by route, the bytes a rank sends and
    receives per gradient element (beside a bf16 all-reduce's 2 B), the
    collectives and their host seconds, and the wall time."""
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as col
    from repro_torch.core.mor import quantize_for_gemm
    from repro_torch.core.policy import MoRPolicy
    from repro_torch.models import init_params
    from repro_torch.optim import compress
    from repro_torch.optim.compress import POD_LANES, leaf2d
    mesh = col.make_mesh((2, 2), ("pod", "data"), device=MD_DEV)
    pod, data = mesh.axis_index("pod"), mesh.axis_index("data")
    cfg = dataclasses.replace(get_config(MD_ARCH), n_layers=depth)
    batch = train_batch(cfg, 0, batch=MD_WORLD, seq=MD_SEQ, device=MD_DEV)
    mine = {k: v[2 * pod:2 * pod + 2] for k, v in batch.items()}
    params = init_params(cfg, seed=1, device=MD_DEV)
    names = list(flat_tree(params))
    _, _, grads, _ = step_grads(cfg, train_policies()["sub3"], params, mine)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    pol = MoRPolicy(recipe="sub3")
    psum = compress.make_pod_compressed_psum("pod", pol, inner_axes=("data",))
    plain = compress.make_pod_compressed_psum(
        "pod", pol.replace(backend="torch"), inner_axes=("data",))
    one_pol = pol.replace(mesh_axes=())
    shipped = []
    gather = compress.all_gather_over

    def spy(x, axis):
        out = gather(x, axis)
        shipped.append(out)
        return out

    routes = {"tile": 0, "generic": 0}
    wire = {"calls": 0, "host_s": 0.0, "bytes_out": 0, "bytes_in": 0}
    elts = cut_leaves = 0
    what = f"multi_device rank {rank} pod_psum"
    t_wall = 0.0
    with col.use_mesh(mesh):
        for name, g in zip(names, grads):
            local, cut = md_leaf_rows(g, data)
            cut_leaves += cut
            elts += local.numel()
            reset_counters()
            before = dict(col.COLLECTIVES)
            shipped.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with patched(compress, "all_gather_over", spy):
                out = psum(local)
            torch.cuda.synchronize()
            t_wall += time.perf_counter() - t0
            totals.add_current(f"{what} {name}")
            for k in wire:
                wire[k] += col.COLLECTIVES[k] - before[k]
            for r, n in tile_routes()["mor_select_pack"].items():
                routes[r] += n
            lanes = {k: v[pod] for k, v in zip(POD_LANES, shipped)}
            shipped.clear()
            # The bar: the pod's whole leaf on one rank, packed without a
            # mesh; this rank's rows of it.
            whole = col.all_gather_over(local, "data").reshape(
                -1, local.shape[-1]) if cut else local
            one, _ = quantize_for_gemm(leaf2d(whole).to(torch.bfloat16),
                                       one_pol)
            del whole
            mine = {}
            for lane in POD_LANES:
                got, want = lanes[lane], getattr(one, lane)
                if want.shape != got.shape:  # a cut lane: this rank's rows
                    want = want.chunk(2)[data]
                check(same_bits([got], [want]),
                      f"{what} {name}: {lane} differs from the one-rank "
                      f"pack's")
                mine[lane] = want.clone()
            mine = dataclasses.replace(one, shape=tuple(leaf2d(local).shape),
                                       **mine)
            del one, lanes
            md_decoded_sum_check(mine, out, f"{what} {name}")
            del mine
            check(same_bits([plain(local)], [out]),
                  f"{what} {name}: kernel path differs from plain path")
            del out
            gc.collect()
            torch.cuda.empty_cache()
        res = {"arch": cfg.name, "depth": depth, "leaves": len(names),
               "cut_leaves": cut_leaves, "grad_elements_rank": elts,
               "pack_launches_by_route": routes,
               "bytes_sent_per_elt": wire["bytes_out"] / elts,
               "bytes_received_per_elt": wire["bytes_in"] / elts,
               "bf16_allreduce_bytes_per_elt": 2.0,
               "collectives": wire["calls"],
               "collective_host_s": wire["host_s"], "wall_s": t_wall,
               "lanes_sum_plain": "bit for bit"}
        # The flat path on the largest leaf (this rank's rows of it).
        big = max(range(len(grads)), key=lambda i: grads[i].numel())
        local = md_leaf_rows(grads[big], data)[0]
        flat = compress.make_pod_compressed_psum("pod")
        before = dict(col.COLLECTIVES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = flat(local)
        torch.cuda.synchronize()
        flat_s = time.perf_counter() - t0
        sent = col.COLLECTIVES["bytes_out"] - before["bytes_out"]
        pods = col.all_gather_over(local, "pod").float()
        exact = pods.sum(0)
        err = (out.float() - exact).abs()
        # Each pod's E4M3 round trip is off by at most 2^-4 of its
        # element (2^-10 / scale below E4M3's normal range), the bf16
        # sum by 2^-9 of itself: within 2^-3 of the pods' amaxes summed.
        amax = float(pods.abs().amax(dim=tuple(range(1, pods.ndim))).sum())
        nz = exact != 0
        rel = float((err[nz] / exact[nz].abs()).median()) if bool(
            nz.any()) else 0.0
        check(bool(torch.isfinite(out.float()).all()) and out.shape ==
              local.shape and float(err.max()) <= 2.0 ** -3 * amax,
              f"{what} flat: max error {float(err.max())} of pods' amax "
              f"{amax}")
        res["flat"] = {"leaf": names[big], "elements": local.numel(),
                       "bytes_sent_per_elt": sent / local.numel(),
                       "max_err_over_amax": float(err.max()) / amax,
                       "median_rel_err_nonzero": rel, "wall_s": flat_s}
        del pods, exact, err, out
    del grads
    return res


def md_elastic(rank, depth):
    """(e): elastic restore. Rank 0 saves MD_ARCH's params at ``depth``
    (init_params, seed 1) with Checkpointer; every rank restores them
    with ``shardings=`` onto make_elastic_mesh(ranks=[0, 1, 2, 3],
    prefer_model=2) (2 x 2) and onto ranks=[0, 1, 2] (1 x 2: rank 2
    outside, rank 3 the lost one), and through elastic_restore on ranks
    [0, 1, 2] (1 x 3: every 'model' dimension of gemma-2b demotes to
    replicated). Gates: each rank's leaves bit for bit its block of the
    params init_params redraws; a rank outside gets None. Reports each
    restore's seconds and the host's peak memory (the process's maximum
    resident set)."""
    import resource

    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.sharding import (NamedSharding, elastic_restore,
                                      make_elastic_mesh, rules)
    from repro_torch.sharding.elastic import demoted_spec
    cfg = dataclasses.replace(get_config(MD_ARCH), n_layers=depth)
    ck = Checkpointer(str(MD_DIR / "ckpt"), async_save=False)
    res = {"arch": cfg.name, "depth": depth}
    target = init_params(cfg, seed=1, device=MD_DEV)
    if rank == 0:
        t0 = time.perf_counter()
        ck.save(1, target)
        res["save_s"] = time.perf_counter() - t0
        res["checkpoint_gb"] = dir_gb(MD_DIR / "ckpt")
    dist.barrier()
    specs = rules.param_specs(cfg, target)
    what = f"multi_device rank {rank} elastic"

    def held(tree, mesh, name):
        """Gate ``tree`` against this rank's blocks of ``target``; the
        leaves demoted and the GB this rank holds."""
        demoted, nbytes = 0, 0
        for (k, got), want, spec in zip(flat_tree(tree).items(),
                                        flat_tree(target).values(),
                                        flat_tree(specs).values()):
            fixed = demoted_spec(spec, tuple(want.shape), mesh)
            demoted += any(e is not None for e in spec) and \
                all(e is None for e in fixed)
            check(got.device.type == mesh.device.type and same_bits(
                [got], [NamedSharding(mesh, fixed).shard(want)]),
                f"{what} {name}: {k} differs from its block")
            nbytes += got.numel() * got.element_size()
        return {"mesh": dict(mesh.axis_sizes), "demoted_leaves": demoted,
                "gb": nbytes / 1e9}

    def timed(fn):
        torch.cuda.synchronize()
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {"restore_s": time.perf_counter() - t0,
                     "host_peak_gb": resource.getrusage(
                         resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
                     "host_peak_before_gb": rss * 1024 / 1e9}

    for name, ranks in (("2x2", [0, 1, 2, 3]), ("1x2", [0, 1, 2])):
        mesh = make_elastic_mesh(ranks, prefer_model=2, device=MD_DEV)
        if mesh is None:
            res[name] = "outside"
        else:
            shardings = rules._map2(lambda sp, t: NamedSharding(
                mesh, demoted_spec(sp, tuple(t.shape), mesh)), specs, target)
            tree, row = timed(lambda: ck.restore(1, target, shardings))
            row.update(held(tree, mesh, name))
            res[name] = row
            del tree
        dist.barrier()
    (tree, mesh), row = timed(lambda: elastic_restore(
        ck, 1, target, cfg, ranks=[0, 1, 2], device=MD_DEV))
    if mesh is None:
        check(tree is None, f"{what} 1x3: a tree outside the mesh")
        res["1x3_elastic_restore"] = "outside"
    else:
        row.update(held(tree, mesh, "1x3"))
        res["1x3_elastic_restore"] = row
    del tree, target
    dist.barrier()
    return res


def md_rank(rank, store, depth):
    """One rank of the multi_device phase (``chip_smoke.py
    --multi-device-rank RANK STORE DEPTH``): joins the gloo world, runs
    (a)-(e) on cuda:0 and prints its result as the last line; a failed
    check raises (exit non-zero)."""
    from repro_torch.core import collectives as col
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.ranks import init_world
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_world(rank, MD_WORLD, store)
    mesh = col.make_mesh((MD_WORLD,), ("data",), device=MD_DEV)
    totals = Totals()
    t0 = time.perf_counter()
    res = {"rank": rank, "mor_dot": md_mor_dot(rank, mesh, totals)}
    res["nan"] = md_nan(rank, mesh, totals)
    gc.collect()
    torch.cuda.empty_cache()
    res["train"] = md_train(rank, mesh, depth, ops, ref, totals)
    gc.collect()
    torch.cuda.empty_cache()
    res["pod_psum"] = md_pod_psum(rank, depth, totals)
    gc.collect()
    torch.cuda.empty_cache()
    res["elastic"] = md_elastic(rank, depth)
    res.update(launches=totals.launches, routes=totals.routes,
               paths=totals.paths, s=time.perf_counter() - t0,
               collectives=col.COLLECTIVES)
    print(json.dumps(res), flush=True)


def phase_multi_device(smi):
    """Four ranks on the card (module docstring, item 15): the parent has
    built the kernels; it starts MD_WORLD processes of this script on
    cuda:0 (``md_rank``), each only loading them, and waits for all
    (``launch.ranks.run_ranks``: a failed rank fails the phase, the
    others are killed). Returns (the multi_device line, Totals of the
    ranks' main-path runs summed)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.ranks import rank_env, run_ranks
    t0 = time.perf_counter()
    depth, reckoning = md_depth(get_config(MD_ARCH))
    shutil.rmtree(MD_DIR, ignore_errors=True)
    MD_DIR.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()
    env = rank_env(threads=2)
    # Four processes share the card's memory: no rank may hold large
    # reserved-but-unused blocks.
    env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        outs = run_ranks(
            lambda r: [sys.executable, str(ROOT / "chip_smoke.py"),
                       "--multi-device-rank", str(r), str(MD_DIR / "store"),
                       str(depth)],
            MD_WORLD, MD_TIMEOUT, env=env, cwd=str(ROOT))
    finally:
        shutil.rmtree(MD_DIR, ignore_errors=True)
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    check([r["rank"] for r in ranks] == list(range(MD_WORLD)),
          "multi_device: a rank's result is missing")
    totals = Totals()
    totals.launches = {k: sum(r["launches"][k] for r in ranks)
                       for k in ranks[0]["launches"]}
    totals.routes = {k: {rt: sum(r["routes"][k][rt] for r in ranks)
                         for rt in ("tile", "generic")} for k in TILE_KERNELS}
    totals.paths = {k: sum(r["paths"][k] for r in ranks)
                    for k in ("stream", "tc")}
    for kern in ("gam_quant", "mor_select_select", "mor_select_pack",
                 "mixed_gemm"):
        check(totals.launches[kern] > 0,
              f"multi_device: {kern} launched no time on its path")
    for r in ranks:
        p = r["pod_psum"]
        by = p["pack_launches_by_route"]
        check(by == {"tile": p["cut_leaves"],
                     "generic": p["leaves"] - p["cut_leaves"]},
              f"multi_device rank {r['rank']}: pod_psum packs {by}")
    # (d)'s leaves that do not split into 128-row blocks are the norm
    # scales, (1, d) views, which take the generic route; every other
    # pack of the phase the tile route.
    pod_generic = sum(r["pod_psum"]["pack_launches_by_route"]["generic"]
                      for r in ranks)
    routes = {k: dict(v) for k, v in totals.routes.items()}
    routes["mor_select_pack"]["generic"] -= pod_generic
    check_tile_route(routes, {**totals.launches, "mor_select_pack": (
        totals.launches["mor_select_pack"] - pod_generic)}, "multi_device")
    train = [r["train"] for r in ranks]
    pods = [r["pod_psum"] for r in ranks]
    total = torch.cuda.get_device_properties(0).total_memory
    check(0.9 * HW.HBM_BYTES <= total <= HW.HBM_BYTES,
          f"multi_device: the card's {total} B against HW.HBM_BYTES "
          f"{HW.HBM_BYTES}")
    res = {"world": MD_WORLD, "device": "cuda:0", "backend": "gloo",
           "hw": {"hbm_bytes": HW.HBM_BYTES, "card_total_memory": total,
                  "hbm_bw": HW.HBM_BW, "bf16_flops": HW.PEAK_FLOPS_BF16,
                  "fp8_flops": HW.PEAK_FLOPS_FP8},
           "reckoning": reckoning, "checks": {
               "a_mor_dot_wi": {r["rank"]: r["mor_dot"] for r in ranks},
               "b_train": {"arch": train[0]["arch"], "depth": depth,
                           "fwd_events_vs_one_rank_operand": [
                               t["fwd_events_vs_one_rank_operand"]
                               for t in train],
                           "fwd_rows_equal_to_one_rank_step": [
                               t["ranks"]["fwd_rows_equal_to_one_rank_step"]
                               for t in train],
                           "fwd_stats_rows": train[0]["ranks"][
                               "fwd_stats_rows"],
                           "kernel_vs_plain": {
                               r["rank"]: r["train"]["kernel_vs_plain"]
                               for r in ranks}},
               "c_nan": {r["rank"]: r["nan"] for r in ranks},
               "d_pod_psum": {r["rank"]: r["pod_psum"] for r in ranks},
               "e_elastic": {r["rank"]: r["elastic"] for r in ranks}},
           "pod_psum_bytes_sent_per_elt": [p["bytes_sent_per_elt"]
                                           for p in pods],
           "pod_psum_s_ranks": [p["wall_s"] for p in pods],
           "step_s_one_rank": train[0]["one_rank"]["step_s"],
           "tokens_one_rank": train[0]["one_rank"]["tokens"],
           "step_s_ranks": [t["ranks"]["step_s"] for t in train],
           "collectives_per_step": train[0]["ranks"]["collectives_per_step"],
           "collective_host_s_per_step": [
               t["ranks"]["collective_host_s_per_step"] for t in train],
           "peak_gb_ranks": [t["ranks"]["peak_gb"] for t in train],
           "losses_one_rank": train[0]["one_rank"]["losses"],
           "losses_ranks": [t["ranks"]["losses"] for t in train],
           "rank_s": [r["s"] for r in ranks],
           "collectives_rank0": ranks[0]["collectives"],
           "launches": totals.launches, "card": smi,
           "phase_s": time.perf_counter() - t0}
    return res, totals


# ------------------------------------------------------------- tp_serve --
TP_WORLD = 4
TP_ARCH = "llama3-8b"
TP_DEV = "cuda"
TP_DIR = ROOT / "build" / "tp_serve"
TP_TIMEOUT = 900
TP_DEPTHS = (8, 4, 2)          # the serving tiers' depth, unless memory says less
# Short runs of the paths llama3-8b's cut leaves out at four ranks: a tied
# head over a vocab-sharded embedding (gemma-2b) and a cut quantized head
# beside a layer GEMM the rules leave whole (deepseek-coder-33b: 252 head
# row blocks divide 4, mlp/wo's 150 K blocks do not). arch -> depth.
TP_EXTRA = {"gemma-2b": 2, "deepseek-coder-33b": 1}
# 4 slots, max_seq 512; prompts chunked by 64 (the stream path's largest M).
TP_SCFG = {"slots": 4, "max_seq": 512, "prefill_chunk": 64}
TP_PROMPTS = (32, 300, 96, 200, 64, 256, 128, 160)  # the recurrent phase's
TP_NEW = 16
TP_EXTRA_PROMPTS, TP_EXTRA_NEW = (32, 64, 96, 48), 8   # 5 chunks of 64
TP_PREFILL = 512                # a one-shot prefill on the tc path
TP_GEMM_M = (4, 512)            # check (a): a decode step's rows, the prefill's
# Bound of the ranks' logits against the plain one-rank engine's, in units
# of the one-rank row's max |logit| (checks (b) and (c)): twice the
# largest reading, 0.0211 (llama3-8b depth 8, a decode row; its prefill
# 0.0134, gemma-2b 0.0004, deepseek-coder-33b 0.0026; an H100 80GB HBM3,
# 700 W), which is the row-parallel sums' other association alone (the
# emulated engine reads the same). The control reads 0.394.
TP_LOGIT_BOUND = 0.04


def tp_depth(cfg):
    """Depth of the tp_serve runs: the first of TP_DEPTHS at which the
    per-rank reckoning leaves 10 GB of the card free with TP_WORLD ranks
    and the parent. A rank holds, at its peak, the global bf16 params
    (every rank draws them), their global QTensors (~1 B an element of a
    quantized weight), its quarter of those, a quantization's transients
    (~6 B an element of the largest weight), the prefill's f32 logits
    three times over and the one-rank logits it reads, the paged pool,
    its CUDA context and slack. Returns (depth, the reckoning)."""
    total = torch.cuda.get_device_properties(0).total_memory
    for depth in TP_DEPTHS:
        c = dataclasses.replace(cfg, n_layers=depth)
        n = c.param_count()
        d, f, V = c.d_model, c.d_ff, c.vocab
        per_layer_q = d * (c.n_heads + 2 * c.n_kv) * c.head_dim + d * d + \
            2 * d * f + f * d
        quantized = depth * per_layer_q + d * V
        pool = 2 * depth * TP_SCFG["slots"] * TP_SCFG["max_seq"] * \
            c.n_kv * c.head_dim * 2
        logits = 4 * TP_PREFILL * V * 4
        per_rank = (2 * n + 1.25 * quantized + 6 * 2 * d * f + logits
                    + pool + MD_CONTEXT_BYTES + MD_SLACK_BYTES)
        free = total - TP_WORLD * per_rank - MD_CONTEXT_BYTES
        row = {"depth": depth, "params": n, "quantized_elements": quantized,
               "per_rank_gb": per_rank / 1e9, "free_gb": free / 1e9,
               "card_gb": total / 1e9}
        if free >= 10e9:
            return depth, row
    return TP_DEPTHS[-1], row


def tp_models(depth):
    """(arch, depth, main) of every tp_serve run: llama3-8b at ``depth``
    with checks (a)-(d), then TP_EXTRA with (b) and (d)."""
    return [(TP_ARCH, depth, True)] + [(a, d, False)
                                       for a, d in TP_EXTRA.items()]


def tp_requests(vocab, main):
    from repro_torch.serve import Request
    rng = np.random.default_rng(0)
    prompts = TP_PROMPTS if main else TP_EXTRA_PROMPTS
    new = TP_NEW if main else TP_EXTRA_NEW
    return [Request(i, rng.integers(0, vocab, L).astype(np.int32),
                    max_tokens=new) for i, L in enumerate(prompts)]


def tp_prompt(vocab):
    return torch.from_numpy(np.random.default_rng(7).integers(
        0, vocab, (1, TP_PREFILL))).to(TP_DEV)


def tp_engine_run(eng, vocab, main):
    """Serve tp_requests on ``eng``: every sampled logits row by (request,
    token index), the tokens, each decode call's ms, collectives and
    their host seconds, and a digest of every model call's logits."""
    import hashlib
    from repro_torch.core import collectives as col
    rows, calls, digests = {}, [], []
    sample, decode_batch, model = eng._sample, eng._decode_batch, \
        eng._decode

    def sampled(req, row):
        rows[(req.rid, len(req.out))] = row.copy()
        return sample(req, row)

    def timed(dec):
        torch.cuda.synchronize()
        n0, s0 = col.COLLECTIVES["calls"], col.COLLECTIVES["host_s"]
        t = time.perf_counter()
        decode_batch(dec)
        torch.cuda.synchronize()
        calls.append(((time.perf_counter() - t) * 1e3,
                      col.COLLECTIVES["calls"] - n0,
                      col.COLLECTIVES["host_s"] - s0))

    def digested(*a):
        out = model(*a)
        digests.append(hashlib.sha256(
            out[0].float().cpu().numpy().tobytes()).hexdigest())
        return out

    eng._sample, eng._decode_batch, eng._decode = sampled, timed, digested
    reqs = tp_requests(vocab, main)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        check(r.done and r.error is None and len(r.out) == r.max_tokens,
              f"tp_serve request {r.rid}: {r.error} {r.out}")
    eng._sample, eng._decode_batch, eng._decode = sample, decode_batch, \
        model
    keys = sorted(rows)
    return {"keys": torch.tensor(keys),
            "rows": torch.from_numpy(np.stack([rows[k] for k in keys])),
            "tokens": [r.out for r in reqs], "calls": calls,
            "digests": digests, "wall_s": wall}


class TPCoord:
    """The (data 1, model TP_WORLD) mesh seen from model coordinate ``r``,
    without a process group: what ``sharding.rules`` reads to cut rank
    r's blocks in one process."""

    names, shape = ("data", "model"), (1, TP_WORLD)

    def __init__(self, r):
        self.r = r

    @property
    def axis_sizes(self):
        return dict(zip(self.names, self.shape))

    def axis_index(self, axis):
        return self.r if axis == "model" else 0


class TPSplitK:
    """A row-parallel weight's product as the ranks compute it, on one
    rank and in code of its own: each rank's quarter of K (its blocks,
    cut by ``sharding.rules.local_shards``, against its slice of the
    activation) through ``ops.mixed_gemm`` in f32, the quarters summed in
    rank order, cast once."""

    def __init__(self, cuts, shape):
        self.cuts, self.shape = cuts, shape

    @property
    def is_stacked(self):
        return self.cuts[0].is_stacked

    def to(self, device):
        return self

    def layer(self, l):
        return TPSplitK([c.layer(l) for c in self.cuts], self.shape)

    def serve_dot(self, x2, *, out_dtype, backend="auto"):
        from repro_torch.kernels import ops
        from repro_torch.kernels.ref import (activation_row_block,
                                             passthrough_mixed)
        parts = []
        for r, cut in enumerate(self.cuts):
            mo = cut.mo
            bk, kl = mo.block[1], mo.padded_shape[1]
            a = passthrough_mixed(x2[:, r * kl:(r + 1) * kl],
                                  (activation_row_block(x2.shape[0], bk), bk))
            parts.append(ops.mixed_gemm(a, mo, out_dtype=torch.float32,
                                        backend=backend))
        return torch.stack(parts).sum(dim=0).to(out_dtype)


class TPTiedEmbed:
    """A tied (V, d) embedding on one rank as the ranks use it: rows
    looked up whole (the owner's row), the head ``embed.T`` multiplied
    by quarters of the vocabulary (``HeadMatmul`` each) and
    concatenated."""

    def __init__(self, table):
        self.table = table

    def to(self, device):
        return self

    def lookup(self, ids):
        return self.table[ids]

    def tied_head(self):
        return self

    @property
    def shape(self):
        return (self.table.shape[1], self.table.shape[0])

    def serve_dot(self, x2, *, out_dtype=torch.float32, backend="auto"):
        from repro_torch.models.transformer import HeadMatmul
        q = self.table.shape[0] // TP_WORLD
        return torch.cat([HeadMatmul.apply(x2, self.table[r * q:(r + 1) * q].T)
                          for r in range(TP_WORLD)], dim=1).to(out_dtype)


class TPSwapped:
    """Check (c)'s control: a stacked serving weight whose layer 1 reads
    layer 2's blocks (a wrong layer's shard past layer 0)."""

    def __init__(self, w):
        self.w, self.shape = w, w.shape

    is_stacked = True

    def layer(self, l):
        return self.w.layer(2 if l == 1 else l)

    def serve_dot(self, *a, **kw):
        raise AssertionError("TPSwapped is a stacked weight")


def tp_emulated(cfg, qparams):
    """The one-rank params that compute what the ranks compute: every
    weight the reference's rules cut along K (``quantized_param_specs``)
    becomes a :class:`TPSplitK`, a tied embedding a :class:`TPTiedEmbed`;
    column-parallel weights and the vocab-sharded embedding's lookup stay
    the one-rank ones, which the ranks match bit for bit."""
    from repro_torch.serve.quantized import QTensor
    from repro_torch.sharding.rules import local_shards, quantized_param_specs
    specs = quantized_param_specs(cfg, qparams, TPCoord(0))

    def visit(tree, spec, prefix):
        out = {}
        for key, leaf in tree.items():
            name = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(leaf, dict):
                out[key] = visit(leaf, spec[key], name)
            elif isinstance(leaf, QTensor) and spec[key].mo.tags[
                    leaf.mo.tags.ndim - 1] is not None:
                out[key] = TPSplitK([local_shards(leaf, spec[key], TPCoord(r),
                                                  name)
                                     for r in range(TP_WORLD)], leaf.shape)
            elif key == "embed" and cfg.tie_embed:
                out[key] = TPTiedEmbed(leaf)
            else:
                out[key] = leaf
        return out
    return visit(qparams, specs, "")


def tp_prefill(cfg, params):
    """The 512-token one-shot prefill of check (c): the last position's
    f32 logits and every layer's K and V, on the CPU."""
    from repro_torch.core.policy import MoRDotPolicy
    from repro_torch.models import make_prefill_fn
    with torch.no_grad():
        logits, cache, _ = make_prefill_fn(cfg, MoRDotPolicy())(
            params, {"tokens": tp_prompt(cfg.vocab)})
    torch.cuda.synchronize()
    return {"logits": logits[0, -1, :cfg.vocab].float().cpu(),
            "k": cache["dense"]["k"].cpu(), "v": cache["dense"]["v"].cpu()}


def tp_one_rank(cfg, main):
    """The bars of one tp_serve run, on one rank (parent, before the ranks
    start), from the ranks' seeded weights: the plain one-rank Engine
    and the one-rank Engine on ``tp_emulated`` params, each serving
    tp_requests (its sampled rows and tokens) and, for the main run,
    prefilling check (c)'s prompt; both go to TP_DIR for the ranks.
    Returns the plain engine's decode-step ms, weight bytes and wall,
    and the emulated prefill's K/V against the plain one's by layer.
    Its launches are the bars', not the path's."""
    from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.quantized import param_bytes, quantize_params
    params = init_params(cfg, seed=0, device=TP_DEV)
    qparams, _ = quantize_params(params, MoRPolicy(recipe="sub3"))
    del params
    bars, res = {}, {"weight_bytes": param_bytes(qparams)}
    for kind, tree in (("plain", qparams),
                       ("emulated", tp_emulated(cfg, qparams))):
        eng = Engine(cfg, MoRDotPolicy(), tree, ServeConfig(**TP_SCFG),
                     quantize=None, device=TP_DEV)
        run = tp_engine_run(eng, cfg.vocab, main)
        bars[kind] = {k: run[k] for k in ("keys", "rows", "tokens")}
        if main:
            bars[kind]["prefill"] = tp_prefill(cfg, eng.params)
        if kind == "plain":
            res.update(decode_step_ms=float(np.median(
                [c[0] for c in run["calls"]])), wall_s=run["wall_s"])
        del eng, tree
    torch.save(bars, TP_DIR / f"{cfg.name}.pt")
    if main:
        # What the row-parallel sums' other association alone does to
        # the one-rank prefill, layer by layer.
        emu, plain = bars["emulated"]["prefill"], bars["plain"]["prefill"]
        res["emulated_vs_plain_kv_max_abs"] = {
            n: [float((emu[n][l].float() - plain[n][l].float()).abs().max())
                for l in range(cfg.n_layers)] for n in ("k", "v")}
        res["emulated_vs_plain_logits_max_abs"] = float(
            (emu["logits"] - plain["logits"]).abs().max())
    del qparams, bars
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_row_bound(y_one, mag):
    """A row-parallel GEMM's bound against the one-rank GEMM: one bf16
    ulp of the one-rank output (each side rounds its f32 sum once) plus
    2^-20 of sum |x||w| (the f32 partials summed in another
    association)."""
    return 2.0 ** -7 * y_one.float().abs() + 2.0 ** -20 * mag


def tp_gemm_one_rank(qparams, cfg):
    """Check (a)'s bar, before the weights are cut: layer 0's four
    GEMMs and the head on seeded replicated inputs (M = 4 and 512), one
    rank. Returns {(name, M): (x, y, sum |x||w| or None)}."""
    from repro_torch.core.device import ieee_f32_matmul
    gen = torch.Generator(device=TP_DEV)
    gen.manual_seed(11)
    blk = qparams["blocks"]["dense"]
    weights = {"wqkv": blk["wqkv"], "wo": blk["wo"],
               "mlp/wi": blk["mlp"]["wi"], "mlp/wo": blk["mlp"]["wo"]}
    out = {}
    for name, w in list(weights.items()) + [("lm_head", qparams["lm_head"])]:
        w0 = w.layer(0) if w.is_stacked else w
        f32 = name == "lm_head"
        for m in TP_GEMM_M:
            x = torch.randn((m, w0.shape[0]), generator=gen, device=TP_DEV,
                            dtype=torch.float32).to(torch.bfloat16)
            y = w0.serve_dot(x, out_dtype=torch.float32 if f32
                             else torch.bfloat16)
            mag = None
            if name in ("wo", "mlp/wo"):
                with ieee_f32_matmul():
                    mag = x.float().abs() @ w0.dequant().float().abs()
            out[(name, m)] = (x, y, mag)
    return out


def tp_gemm_check(eng, bar, mesh):
    """Check (a) on the cut weights: column-parallel GEMMs (wqkv, mlp/wi,
    the head) bit for bit with the one-rank GEMM, row-parallel ones (wo,
    mlp/wo) within ``tp_row_bound`` (the worst entry's share printed).
    Also reads, without gating, whether a column shard planned by its own
    local shape (no ``_plan``) would sum K as the one-rank launch does."""
    from repro_torch.core.collectives import use_mesh
    from repro_torch.kernels.mixed_gemm import mixed_gemm_blocks
    from repro_torch.kernels.ref import activation_row_block, passthrough_mixed
    blk = eng.params["blocks"]["dense"]
    weights = {"wqkv": blk["wqkv"], "wo": blk["wo"],
               "mlp/wi": blk["mlp"]["wi"], "mlp/wo": blk["mlp"]["wo"],
               "lm_head": eng.params["lm_head"]}
    res = {}
    with use_mesh(mesh):
        for (name, m), (x, y_one, mag) in bar.items():
            w = weights[name]
            w0 = w.layer(0) if w.is_stacked else w
            y = w0.serve_dot(x, out_dtype=y_one.dtype)
            # A QTensor the rules left whole (its block grid does not
            # divide the axis: llama3-8b's head, 1002 row blocks) runs
            # the one-rank product on every rank.
            row = {"parallel": getattr(w0, "parallel", "replicated"),
                   "m": m}
            if row["parallel"] != "row":
                row["bitwise"] = bool(torch.equal(bits16(y), bits16(y_one)))
                check(row["bitwise"], f"tp_serve (a) {name} M={m}: the "
                      "column-parallel GEMM is not bit for bit the "
                      "one-rank GEMM")
                if m <= 64 and row["parallel"] == "col":
                    mo = w0.local.mo
                    bk = mo.block[1]
                    a = passthrough_mixed(x, (activation_row_block(m, bk), bk))
                    loc = mixed_gemm_blocks(a, mo, out_dtype=y_one.dtype)
                    r = mesh.axis_index("model")
                    n_l = loc.shape[1]
                    want = y_one[:, r * n_l:(r + 1) * n_l]
                    row["local_plan_bitwise"] = bool(torch.equal(
                        bits16(loc[:, :want.shape[1]]), bits16(want)))
            else:
                bound = tp_row_bound(y_one, mag)
                err = (y.float() - y_one.float()).abs()
                row["max_abs_err"] = float(err.max())
                row["worst_share_of_bound"] = float((err / bound).max())
                check(row["worst_share_of_bound"] <= 1.0,
                      f"tp_serve (a) {name} M={m}: {row}")
            res[f"{name}@{m}"] = row
    return res


def tp_against_plain(row, ref, gate, what):
    """One logits row against the plain one-rank engine's: the largest
    difference gated by TP_LOGIT_BOUND max |ref|; the argmax compared
    where the top-2 margin exceeds that bound, else a near-tie. Returns
    (difference / max |ref|, compared)."""
    scale = float(np.abs(ref).max())
    err = float(np.abs(row - ref).max())
    gate(err <= TP_LOGIT_BOUND * scale,
         f"{what}: logits differ by {err} > {TP_LOGIT_BOUND} x {scale}")
    top2 = np.partition(ref, -2)[-2:]
    compared = bool(top2[1] - top2[0] > TP_LOGIT_BOUND * scale)
    if compared:
        gate(int(row.argmax()) == int(ref.argmax()),
             f"{what}: argmax {int(row.argmax())} != {int(ref.argmax())} "
             f"at margin {top2[1] - top2[0]}")
    return err / scale, compared


def tp_compare_rows(run, bar, vocab, gate):
    """Check (b): every sampled row and token bit for bit the emulated
    one-rank engine's; against the plain one-rank engine, while a request
    has sampled the plain engine's tokens, each row by
    ``tp_against_plain``."""
    emu, plain = bar["emulated"], bar["plain"]
    same_keys = torch.equal(run["keys"], emu["keys"])
    differ = (int((bits16(run["rows"]) != bits16(emu["rows"])).any(1).sum())
              if same_keys else None)
    gate(same_keys and differ == 0 and run["tokens"] == emu["tokens"],
         f"tp_serve (b): {differ} of {len(run['rows'])} logits rows (or "
         "the tokens) differ from the emulated one-rank engine's")
    index = {tuple(k): i for i, k in enumerate(plain["keys"].tolist())}
    worst, compared, ties = 0.0, 0, 0
    for i, (rid, j) in enumerate(run["keys"].tolist()):
        if run["tokens"][rid][:j] != plain["tokens"][rid][:j]:
            continue
        rel, cmp = tp_against_plain(
            run["rows"][i, :vocab].numpy(),
            plain["rows"][index[(rid, j)], :vocab].numpy(), gate,
            f"tp_serve (b) request {rid} token {j}")
        worst, compared, ties = max(worst, rel), compared + cmp, \
            ties + (not cmp)
    return {"rows": len(run["rows"]), "rows_differing_from_emulated": differ,
            "plain_worst_share_of_max_logit": worst,
            "plain_tokens_compared": compared, "plain_near_ties": ties,
            "plain_tokens_equal": run["tokens"] == plain["tokens"]}


def tp_prefill_check(eng, cfg, mesh, totals, bar, gate):
    """Check (c): a 512-token one-shot prefill through make_prefill_fn on
    the cut weights (every GEMM on the tc path): the last position's
    logits and every layer's K and V bit for bit the emulated one-rank
    prefill's, and the logits against the plain one-rank prefill by
    ``tp_against_plain``. The control runs the same prefill with layer
    1's row-parallel wo reading layer 2's blocks: layers 0-1 keep their
    K/V, layer 2 on differ, and the logits fail the plain bound."""
    from repro_torch.core.collectives import use_mesh
    reset_counters()
    with use_mesh(mesh):
        got = tp_prefill(cfg, eng.params)
    _, paths = totals.add_current("tp_serve prefill")
    check(paths["tc"] > 0 and paths["stream"] == 0,
          f"tp_serve (c): the prefill's GEMMs took {paths}")
    emu, plain = bar["emulated"]["prefill"], bar["plain"]["prefill"]

    def equal_by_layer(p):
        return [all(torch.equal(bits16(p[n][l]), bits16(emu[n][l]))
                    for n in ("k", "v")) for l in range(cfg.n_layers)]

    kv_equal = equal_by_layer(got)
    logits_equal = torch.equal(bits16(got["logits"]), bits16(emu["logits"]))
    gate(all(kv_equal) and logits_equal,
         f"tp_serve (c): K/V equal by layer {kv_equal}, logits "
         f"{logits_equal}, against the emulated one-rank prefill")
    rel, compared = tp_against_plain(got["logits"].numpy(),
                                     plain["logits"].numpy(), gate,
                                     "tp_serve (c)")
    blk = eng.params["blocks"]["dense"]
    ctl = dict(eng.params, blocks={"dense": dict(blk, wo=TPSwapped(
        blk["wo"]))})
    with use_mesh(mesh):
        bad = tp_prefill(cfg, ctl)
    ctl_equal = equal_by_layer(bad)
    scale = float(plain["logits"].abs().max())
    ctl_rel = float((bad["logits"] - plain["logits"]).abs().max()) / scale
    gate(ctl_equal[:2] == [True, True] and not any(ctl_equal[2:])
         and ctl_rel > TP_LOGIT_BOUND,
         f"tp_serve (c) control: K/V equal by layer {ctl_equal}, logits at "
         f"{ctl_rel} of max |logit| (bound {TP_LOGIT_BOUND})")
    return {"positions": TP_PREFILL, "kv_bitwise_by_layer": kv_equal,
            "logits_bitwise": logits_equal,
            "plain_share_of_max_logit": rel, "plain_argmax_compared": compared,
            "control_kv_bitwise_by_layer": ctl_equal,
            "control_plain_share_of_max_logit": ctl_rel,
            "tc_gemms": paths["tc"]}


def tp_no_dense_copy(eng, cfg):
    """Check (d)'s second half: no live bf16 CUDA tensor has the shape of
    a quantized weight, of a layer of one, or of its (N, K) view, whole
    or cut (gc's view of the process), but the dense params the rules
    keep dense (deepseek-coder-33b's embedding quarter is (N / 4, K) of
    its head)."""
    from repro_torch.serve.quantized import ShardedEmbed, ShardedQTensor
    shapes, dense = set(), set()

    def visit(tree):
        for leaf in tree.values():
            if isinstance(leaf, dict):
                visit(leaf)
            elif isinstance(leaf, ShardedQTensor):
                K, N = leaf.shape
                for k, n in ((K, N), (K, N // TP_WORLD), (K // TP_WORLD, N)):
                    shapes.update({(k, n), (n, k), (cfg.n_units, k, n),
                                   (cfg.n_units, n, k)})
            elif isinstance(leaf, (ShardedEmbed, torch.Tensor)):
                t = leaf.local if isinstance(leaf, ShardedEmbed) else leaf
                dense.add(t.untyped_storage().data_ptr())
    visit(eng.params)
    found = [tuple(o.shape) for o in gc.get_objects()
             if torch.is_tensor(o) and o.is_cuda and o.dtype == torch.bfloat16
             and tuple(o.shape) in shapes
             and o.untyped_storage().data_ptr() not in dense]
    check(not found, f"tp_serve (d): bf16 copies of quantized weights "
          f"alive: {found}")
    return len(shapes)


def tp_collectives_want(params, cfg):
    """Collectives of a decode call: one for each cut GEMM weight of a
    layer (a gather or a sum), the embedding's gather, and the head's
    where it is cut (a quantized head, or the tied head of a cut
    embedding)."""
    from repro_torch.serve.quantized import ShardedEmbed, ShardedQTensor

    def count(tree):
        return sum(count(v) if isinstance(v, dict)
                   else isinstance(v, ShardedQTensor) for v in tree.values())
    embed = isinstance(params["embed"], ShardedEmbed)
    head = embed if cfg.tie_embed else isinstance(params["lm_head"],
                                                  ShardedQTensor)
    return count(params["blocks"]) * cfg.n_units + embed + head


def tp_rank_model(arch, depth, main, mesh, totals):
    """One tp_serve run on this rank: quantize the global params, cut
    them through Engine(mesh=), run checks (a)-(d) (the extra runs: (b)
    and (d)). A gate of (b) or (c) that fails is listed under 'fails'
    and the run goes on, so that every reading is taken."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.quantized import (param_bytes, quantize_params,
                                             replicated_bytes)
    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    fails = []

    def gate(cond, msg):
        if not cond:
            fails.append(msg)

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=TP_DEV)
    reset_counters()
    qparams, _ = quantize_params(params, MoRPolicy(recipe="sub3"))
    torch.cuda.synchronize()
    launches, _ = totals.add_current(f"tp_serve {arch} quantize")
    packs = 4 * cfg.n_units + (not cfg.tie_embed)
    check(launches["mor_select_pack"] == packs,
          f"tp_serve {arch}: {launches['mor_select_pack']} packs, not {packs}")
    del params
    bar = tp_gemm_one_rank(qparams, cfg) if main else None
    eng = Engine(cfg, MoRDotPolicy(), qparams, ServeConfig(**TP_SCFG),
                 quantize=None, mesh=mesh, device=TP_DEV)
    one_bytes = param_bytes(qparams)
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    res = {"depth": depth, "quantize_s": time.perf_counter() - t0}
    if main:
        res["a_gemms"] = tp_gemm_check(eng, bar, mesh)
        del bar
        gc.collect()
        torch.cuda.empty_cache()
    mine, rep = param_bytes(eng.params), replicated_bytes(eng.params)
    check((mine - rep) * TP_WORLD == one_bytes - rep,
          f"tp_serve (d) {arch}: {mine} bytes of which {rep} replicated, "
          f"one rank {one_bytes}")
    res["d_weights"] = {"rank_bytes": mine, "replicated_bytes": rep,
                        "one_rank_bytes": one_bytes,
                        "shapes_checked": tp_no_dense_copy(eng, cfg),
                        "allocated_gb": torch.cuda.memory_allocated() / 1e9}
    reset_counters()
    run = tp_engine_run(eng, cfg.vocab, main)
    launches, paths = totals.add_current(f"tp_serve {arch} engine")
    check(paths["stream"] > 0 and paths["tc"] == 0,
          f"tp_serve (b) {arch}: the engine's GEMMs took {paths}")
    want = tp_collectives_want(eng.params, cfg)
    for ms, n, s in run["calls"]:
        check(n == want, f"tp_serve (b) {arch}: {n} collectives a decode "
              f"call (want {want})")
    bars = torch.load(TP_DIR / f"{cfg.name}.pt")
    res["b_engine"] = tp_compare_rows(run, bars, cfg.vocab, gate)
    res["b_engine"].update(
        decode_step_ms=float(np.median([c[0] for c in run["calls"]])),
        collectives_per_decode_call=run["calls"][0][1],
        collective_host_s_per_decode_call=float(np.median(
            [c[2] for c in run["calls"]])),
        decode_calls=len(run["calls"]), wall_s=run["wall_s"])
    res["digests"] = run["digests"]
    res["tokens"] = run["tokens"]
    if main:
        res["c_prefill"] = tp_prefill_check(eng, cfg, mesh, totals, bars,
                                            gate)
    res["s"] = time.perf_counter() - t0
    res["fails"] = fails
    del eng, bars
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_rank(rank, store, depth):
    """One rank of the tp_serve phase (``chip_smoke.py --tp-serve-rank
    RANK STORE DEPTH``): joins the gloo world and runs every
    ``tp_models`` run; its result is the last line of its output. A
    failed check raises; a failed gate of (b) or (c) is listed in the
    result, which ``phase_tp_serve`` prints before it fails."""
    from repro_torch.core import collectives as col
    from repro_torch.launch.ranks import init_world
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_world(rank, TP_WORLD, store)
    mesh = col.make_mesh((1, TP_WORLD), ("data", "model"), device=TP_DEV)
    totals = Totals()
    t0 = time.perf_counter()
    res = {"rank": rank, "models": {}}
    for arch, d, main in tp_models(depth):
        res["models"][arch] = tp_rank_model(arch, d, main, mesh, totals)
    res.update(launches=totals.launches, routes=totals.routes,
               paths=totals.paths, s=time.perf_counter() - t0,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               collectives=col.COLLECTIVES)
    print(json.dumps(res), flush=True)


def phase_tp_serve(smi):
    """Tensor-parallel serving (module docstring, item 16): the one-rank
    bars in this process, then TP_WORLD ranks of this script on cuda:0
    (``tp_rank``), which only load the kernels this process built.
    Returns (the tp_serve line, Totals of the ranks' main-path runs)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.ranks import rank_env, run_ranks
    t0 = time.perf_counter()
    depth, reckoning = tp_depth(get_config(TP_ARCH))
    models = tp_models(depth)
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    try:
        one = {a: tp_one_rank(dataclasses.replace(get_config(a), n_layers=d),
                              main) for a, d, main in models}
        t_bars = time.perf_counter() - t0
        env = rank_env(threads=2)
        env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        outs = run_ranks(
            lambda r: [sys.executable, str(ROOT / "chip_smoke.py"),
                       "--tp-serve-rank", str(r), str(TP_DIR / "store"),
                       str(depth)],
            TP_WORLD, TP_TIMEOUT, env=env, cwd=str(ROOT))
    finally:
        shutil.rmtree(TP_DIR, ignore_errors=True)
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    check([r["rank"] for r in ranks] == list(range(TP_WORLD)),
          "tp_serve: a rank's result is missing")
    for r in ranks[1:]:
        for a in r["models"]:
            check(r["models"][a]["digests"] == ranks[0]["models"][a]["digests"],
                  f"tp_serve (b) {a}: rank {r['rank']}'s logits differ from "
                  "rank 0's")
            check(r["models"][a]["tokens"] == ranks[0]["models"][a]["tokens"],
                  f"tp_serve (b) {a}: tokens differ")
    totals = Totals()
    totals.launches = {k: sum(r["launches"][k] for r in ranks)
                       for k in ranks[0]["launches"]}
    totals.routes = {k: {rt: sum(r["routes"][k][rt] for r in ranks)
                         for rt in ("tile", "generic")} for k in TILE_KERNELS}
    totals.paths = {k: sum(r["paths"][k] for r in ranks)
                    for k in ("stream", "tc")}
    for kern in ("mor_select_pack", "mixed_gemm"):
        check(totals.launches[kern] > 0,
              f"tp_serve: {kern} launched no time on its path")
    check_tile_route(totals.routes, totals.launches, "tp_serve")
    per_model = {}
    for a, d, main in models:
        rs = [r["models"][a] for r in ranks]
        m = {"depth": d, "checks": {
                 "b_engine": {r["rank"]: r["models"][a]["b_engine"]
                              for r in ranks},
                 "b_logits_equal_across_ranks": True,
                 "d_weights": rs[0]["d_weights"]},
             "decode_step_ms_ranks": [x["b_engine"]["decode_step_ms"]
                                      for x in rs],
             "decode_step_ms_one_rank": one[a]["decode_step_ms"],
             "collectives_per_decode_call":
                 rs[0]["b_engine"]["collectives_per_decode_call"],
             "collective_host_s_per_decode_call": [
                 x["b_engine"]["collective_host_s_per_decode_call"]
                 for x in rs],
             "weight_gb_rank": rs[0]["d_weights"]["rank_bytes"] / 1e9,
             "weight_gb_one_rank": one[a]["weight_bytes"] / 1e9,
             "engine_wall_s_ranks": [x["b_engine"]["wall_s"] for x in rs],
             "engine_wall_s_one_rank": one[a]["wall_s"],
             "rank_s": [x["s"] for x in rs]}
        if main:
            m["checks"]["a_gemms"] = {r["rank"]: r["models"][a]["a_gemms"]
                                      for r in ranks}
            m["checks"]["c_prefill"] = {r["rank"]: r["models"][a]["c_prefill"]
                                        for r in ranks}
            for k in ("emulated_vs_plain_kv_max_abs",
                      "emulated_vs_plain_logits_max_abs"):
                m[k] = one[a][k]
        per_model[a] = m
    res = {"world": TP_WORLD, "device": "cuda:0", "backend": "gloo",
           "mesh": {"data": 1, "model": TP_WORLD}, "reckoning": reckoning,
           "logit_bound_share_of_max_logit": TP_LOGIT_BOUND,
           "models": per_model, "bars_s": t_bars,
           "peak_gb_ranks": [r["peak_gb"] for r in ranks],
           "launches": totals.launches, "paths": totals.paths,
           "card": smi, "phase_s": time.perf_counter() - t0}
    fails = sorted({f for r in ranks for m in r["models"].values()
                    for f in m["fails"]})
    res["fails"] = fails
    if fails:
        emit({"tp_serve": res})
    check(not fails, "; ".join(fails))
    return res, totals


# The kernel API's full-width flash calls (bf16, causal, llama3-8b heads):
# name -> (B, S, T, per-slot query offsets or None).
FLASH_API_CASES = {
    "a_train_2x1024": (2, 1024, 1024, None),      # the training batch
    "b_context_8192": (1, 8192, 8192, None),      # llama3-8b's context
    "c_prefill_chunk": (4, 32, 512, (0, 64, 200, 480)),  # engine chunk
}
FP8_API_M = 2048  # tokens against llama3-8b's four layer GEMMs
CUDA_CORE_BLOCK = (128, 128, 64)  # a block of the cuda_core route


def flash_tol(v, out_plain):
    """Kernel-vs-plain limit of flash attention: 1e-5 max|v| (the order of
    the f32 sums, an online against a two-pass softmax) plus one ulp of
    the output dtype at |out| (a rounding of the result may flip)."""
    bits = 7 if out_plain.dtype == torch.bfloat16 else 23
    o = out_plain.float().abs().clamp_min(2.0**-126)
    return 1e-5 * float(v.float().abs().max()) + torch.exp2(
        torch.floor(torch.log2(o)) - bits)


def visible_pairs(S, T, offs):
    """(query, key) pairs the causal rows of one head need: min(T, off +
    row + 1) each, and all T for a row that sees no key (its result is
    the mean over every key)."""
    rows = np.arange(S)
    n = 0
    for off in offs:
        k = off + rows + 1
        n += int(np.where(k <= 0, T, np.minimum(k, T)).sum())
    return n


def visible_keys(S, T, offs):
    """Key rows the causal rows of one head read, summed over the slots:
    min(T, off + S) for a slot, and all T where a row sees no key."""
    return sum(T if off < 0 else min(T, off + S) for off in offs)


def fp8_operand(x, block, fmt, Partition):
    """x (R, C) as fp8 payload with GAM block scales, clipped and cast as
    the reference suite builds fp8_gemm operands."""
    from repro_torch.core.gam import compute_scales
    s = compute_scales(x, Partition("block", block), fmt).scale.contiguous()
    R, C = x.shape
    br, bc = block
    xs = x.float().reshape(R // br, br, C // bc, bc) * s[:, None, :, None]
    q = xs.clamp(-fmt.amax, fmt.amax).to(fmt.dtype).reshape(R, C)
    return q.contiguous(), s


def dequant(q, s, block):
    R, C = q.shape
    br, bc = block
    return (q.float().reshape(R // br, br, C // bc, bc)
            / s[:, None, :, None]).reshape(R, C)


def flash_case(ops, q, k, v, causal, off, what, rows=slice(None)):
    """One parity case of ``ops.flash_attention``: the kernel twice (the
    repeat must be bit-identical, both on ``flash_route``'s route), the
    plain version once; returns (route, max abs err, max err / tol) over
    the output rows ``rows`` (a NaN case reads only the clean batch)."""
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_route)
    route = flash_route(q.dtype, q.shape[-1])
    before = flash_attention_fwd.launches_by_route[route]
    yk = ops.flash_attention(q, k, v, causal=causal, q_offset=off,
                             backend="cuda")
    again = ops.flash_attention(q, k, v, causal=causal, q_offset=off,
                                backend="cuda")
    yt = ops.flash_attention(q, k, v, causal=causal, q_offset=off,
                             backend="torch")
    what = f"{what} ({route})"
    check(flash_attention_fwd.launches_by_route[route] == before + 2,
          f"{what}: not launched on its route")
    check(yk.shape == yt.shape and yk.dtype == q.dtype, what)
    check(torch.equal(yk[rows], again[rows]), f"{what}: a repeat differs")
    yk, yt, v = yk[rows], yt[rows], v[rows]
    check(bool(torch.isfinite(yk).all()), f"{what}: nonfinite outputs")
    err = (yk.float() - yt.float()).abs()
    tol = flash_tol(v, yt)
    check(bool(torch.all(err <= tol)),
          f"{what}: max err {float(err.max())} beyond 1e-5 max|v| + 1 ulp")
    return route, float(err.max()), float((err / tol).max())


def phase_kernel_api_parity(ops, Partition, cfg):
    """Kernel vs plain version of ``ops.flash_attention`` on both of its
    routes (bf16 at d 128 and 64 on wgmma; f32, and bf16 at d 32, on
    cuda_core; causal and full; S = T, S < T with the default, a scalar, a
    per-batch and a per-row offset with a negative entry, ragged S = 100 /
    T = 300; GQA with G = 4 and G = 1 and the folded 3-D layout; a long row
    of 128 queries against 8192 keys; scores ~8x larger; a ragged T whose
    next batch holds NaN in its first v rows, which must not reach the
    clean batch) and of ``ops.fp8_gemm`` on both routes (E4M3, E5M2 and
    mixed payloads, bf16 and f32 out, blocks (128, 128, 128) and (128,
    256, 128), tiny blocks whose sa * sb overflows, a 64-row block with a
    ragged tile, and two blocks of the cuda_core route), each call twice:
    the repeat must be bit-identical."""
    from repro_torch.core.formats import E4M3, E5M2
    hq, hkv = cfg.n_heads, cfg.n_kv
    g = torch.Generator(device="cuda").manual_seed(0)
    layouts = {"gqa G=4": (2, hq, hkv), "gqa G=1": (2, hkv, hkv),
               "folded": (16, None, None)}
    offsets = [("S=T", 256, 256, True), ("default", 64, 256, True),
               ("scalar", 64, 256, True), ("per_batch", 64, 256, True),
               ("per_row", 64, 256, True), ("ragged", 100, 300, True),
               ("S=T", 256, 256, False), ("default", 64, 256, False),
               ("ragged", 100, 300, False)]
    worst = {"flash_attention": 0.0, "fp8_gemm": 0.0}
    n, by_route, ratio = 0, {}, 0.0

    def run(q, k, v, causal, off, what, rows=slice(None)):
        nonlocal n, ratio
        route, err, r = flash_case(ops, q, k, v, causal, off, what, rows)
        worst["flash_attention"] = max(worst["flash_attention"], err)
        ratio = max(ratio, r)
        by_route[route] = by_route.get(route, 0) + 1
        n += 1

    # The cases the cuda_core kernel was first held to draw from g, as the
    # fp8 cases after them do; those added with the wgmma route from their
    # own generator, so that the fp8 cases' inputs stay as they were.
    g_new = torch.Generator(device="cuda").manual_seed(2)

    def qkv(shapes, scale=1.0, gen=g_new):
        q, k, v = (torch.randn(sh, generator=gen, device="cuda")
                   for sh in shapes)
        return q * scale, k * scale, v

    for dh in (cfg.head_dim, 64, 32):
        for lname, (B, H, Hk) in layouts.items():
            rows = B * (H or 1)
            for oname, S, T, causal in offsets:
                if oname == "per_batch" and H is None:
                    continue  # a per-batch offset is a 4-D layout's
                off = {"scalar": 100,
                       "per_batch": torch.tensor([17, 190], dtype=torch.int32),
                       "per_row": torch.from_numpy(np.random.default_rng(
                           rows).integers(0, T - S + 1, rows).astype(np.int32)),
                       }.get(oname)
                if oname == "per_row":
                    off[1] = -40  # rows 0..39 of folded row 1 see no key
                if H is None:
                    shapes = [(B, S, dh), (B, T, dh), (B, T, dh)]
                else:
                    shapes = [(B, S, H, dh), (B, T, Hk, dh), (B, T, Hk, dh)]
                for dt in (torch.bfloat16, torch.float32):
                    q, k, v = (t.to(dt) for t in qkv(
                        shapes, gen=g if dh == cfg.head_dim else g_new))
                    run(q, k, v, causal, off, f"flash d={dh} {lname} {oname} "
                        f"S={S} T={T} causal={causal} {dt}")
    dh = cfg.head_dim
    for dt in (torch.bfloat16, torch.float32):
        # 128 queries against a long row (the default offset: the last
        # query at the last key).
        shapes = [(1, 128, hq, dh), (1, 8192, hkv, dh), (1, 8192, hkv, dh)]
        q, k, v = (t.to(dt) for t in qkv(shapes))
        run(q, k, v, True, None, f"flash long row S=128 T=8192 {dt}")
        # q and k scaled by 8: scores ~64x larger, softmax near one-hot.
        shapes = [(2, 256, hq, dh), (2, 256, hkv, dh), (2, 256, hkv, dh)]
        q, k, v = (t.to(dt) for t in qkv(shapes, scale=8.0))
        run(q, k, v, True, None, f"flash large scores (q, k x 8) {dt}")
        # A ragged T in the GQA layout with NaN in batch 1's first v rows:
        # batch 0's keys past T must read as zeros, never as batch 1's
        # rows (p = 0 times NaN is NaN).
        shapes = [(2, 100, hq, dh), (2, 300, hkv, dh), (2, 300, hkv, dh)]
        q, k, v = qkv(shapes)
        v[1, :4] = float("nan")
        q, k, v = (t.to(dt) for t in (q, k, v))
        run(q, k, v, True, None, f"flash NaN in the next batch's v {dt}",
            rows=slice(0, 1))
        run(q, k, v, False, None, f"flash NaN in the next batch's v, full "
            f"{dt}", rows=slice(0, 1))
    emit({"parity": "flash_attention", "cases": n, "cases_by_route": by_route,
          "ok": True, "repeats_bit_identical": True,
          "max_abs_err": worst["flash_attention"], "max_err_over_tol": ratio})
    from repro_torch.kernels.fp8_gemm import fp8_gemm_blocks, fp8_gemm_route
    # (M, N, K), block, A's format, B's format, value scale. The first
    # four: both formats and blocks of the reference suite; then mixed
    # formats, tiny blocks (N(0,1) * 1e-18: sa * sb overflows f32), a
    # 64-row block with a ragged last tile, a 256-deep K block, and blocks
    # the route function gives the cuda_core route (bk = 32, bn = 64,
    # bk = 64), tiny blocks there too.
    cases = [((512, 1024, 1024), blk, f, f, 1.0)
             for f in (E4M3, E5M2)
             for blk in ((128, 128, 128), (128, 256, 128))]
    cases += [((512, 1024, 1024), (128, 128, 128), E4M3, E5M2, 1.0),
              ((512, 1024, 1024), (128, 128, 128), E4M3, E4M3, 1e-18),
              ((192, 256, 384), (64, 128, 128), E5M2, E4M3, 1.0),
              ((256, 512, 1024), (128, 128, 256), E5M2, E5M2, 1.0),
              ((512, 1024, 1024), (128, 128, 32), E4M3, E4M3, 1.0),
              ((256, 512, 256), (128, 64, 128), E4M3, E5M2, 1.0),
              ((192, 256, 320), (64, 128, 64), E5M2, E4M3, 1.0),
              ((512, 1024, 1024), (128, 128, 32), E4M3, E4M3, 1e-18)]
    n, by_route, ratio = 0, {}, 0.0
    for (M, N, K), block, fa, fb, scale in cases:
        bm, bn, bk = block
        x = torch.randn(M, K, generator=g, device="cuda") * scale
        w = torch.randn(K, N, generator=g, device="cuda") * scale
        aq, sa = fp8_operand(x, (bm, bk), fa, Partition)
        bq, sb = fp8_operand(w, (bk, bn), fb, Partition)
        A, Bd = dequant(aq, sa, (bm, bk)), dequant(bq, sb, (bk, bn))
        route = fp8_gemm_route(M, N, K, block)
        for out in (torch.bfloat16, torch.float32):
            before = fp8_gemm_blocks.launches_by_route[route]
            ck = ops.fp8_gemm(aq, bq, sa, sb, block=block, out_dtype=out,
                              backend="cuda")
            again = ops.fp8_gemm(aq, bq, sa, sb, block=block, out_dtype=out,
                                 backend="cuda")
            ct = ops.fp8_gemm(aq, bq, sa, sb, block=block, out_dtype=out,
                              backend="torch")
            what = (f"fp8_gemm {(M, N, K)} {block} {fa.name}x{fb.name} "
                    f"scale {scale} {out} ({route})")
            check(fp8_gemm_blocks.launches_by_route[route] == before + 2,
                  f"{what}: not launched on its route")
            check(torch.equal(ck, again), f"{what}: a repeat differs")
            err = (ck.float() - ct.float()).abs()
            tol = gemm_tol(A, Bd.T, ct, out)
            check(bool(torch.all(err <= tol)),
                  f"{what}: max err {float(err.max())} beyond 1e-5 sum|a b| "
                  "(+1 bf16 ulp)")
            if scale < 1.0:
                check(float(ct.float().abs().max()) > 0.0,
                      f"{what}: the plain version is all zeros")
            worst["fp8_gemm"] = max(worst["fp8_gemm"], float(err.max()))
            ratio = max(ratio, float((err / tol).max()))
            by_route[route] = by_route.get(route, 0) + 1
            n += 1
    emit({"parity": "fp8_gemm", "cases": n, "cases_by_route": by_route,
          "ok": True, "repeats_bit_identical": True,
          "max_abs_err": worst["fp8_gemm"], "max_err_over_tol": ratio})
    return worst


def wgmma_build_facts(build, name, smem_bytes):
    """A wgmma route's registers, spills and shared memory (its kernel's
    ``-Xptxas -v`` lines in the build of ``csrc/<name>.cu`` and the
    launcher's dynamic shared memory, ``smem_bytes``), the counts of
    ptxas's notes that it serialized the wgmmas (any fails), and the
    number of HGMMA instructions in the library's SASS (``cuobjdump
    -sass``, where the toolkit has it; none fails)."""
    import os
    import shutil
    log = build.build_log(name).splitlines()
    regs, spills = set(), set()
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "wgmma_kernel" in line:
            for ln in log[i + 1:i + 4]:
                if "registers" in ln:
                    regs.add(int(ln.split("Used ")[1].split()[0]))
                if "spill" in ln:
                    spills.add(ln.strip())
    # ptxas's notes that it serialized the wgmmas or injected a wait
    # (C7514, C7517, C7518): any of them costs the overlap the design needs.
    notes = {c: sum(c in ln for ln in log) for c in ("C7514", "C7517", "C7518")}
    facts = {"wgmma_registers": sorted(regs), "wgmma_spills": sorted(spills),
             "wgmma_smem_bytes": smem_bytes,
             "wgmma_serialized_notes": notes}
    check(regs, f"{name}: no ptxas lines for the wgmma kernel")
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in ln
              for ln in spills), f"{name}: the wgmma kernel spills: {spills}")
    check(not any(notes.values()),
          f"{name}: ptxas serialized the wgmma kernel's wgmmas: {notes}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(cuobjdump):
        sass = subprocess.run(
            [cuobjdump, "-sass", str(build.library_path(name))],
            capture_output=True, text=True, check=True).stdout
        facts["sass"] = {"HGMMA": sass.count("HGMMA")}
        check(facts["sass"]["HGMMA"] > 0,
              f"{name}: the library's SASS holds no HGMMA")
    else:
        facts["sass"] = "not checked"
    return facts


def build_facts(build):
    """wgmma_build_facts of fp8_gemm's and flash_attention's wgmma routes
    (flash's shared memory per head dim of the route) and
    tile_build_facts of the selection's and gam_quant's tile routes."""
    from repro_torch.kernels.flash_attention import WGMMA_HEAD_DIMS
    fl = build.load("flash_attention")
    return {"fp8_gemm": wgmma_build_facts(
                build, "fp8_gemm", build.load("fp8_gemm").fp8_gemm_wgmma_smem()),
            "flash_attention": wgmma_build_facts(
                build, "flash_attention",
                {str(d): fl.flash_attention_wgmma_smem(d)
                 for d in WGMMA_HEAD_DIMS}),
            "mor_select": tile_build_facts(build, "mor_select"),
            "gam_quant": tile_build_facts(build, "gam_quant")}


# The tile kernels' instances: mangled-name pattern -> label.
TILE_INSTANCES = {
    "mor_select": {r"mor_select_tile_kernelILb1ELb0E": "select_sub2_sub3",
                   r"mor_select_tile_kernelILb1ELb1E": "select_sub4",
                   r"mor_select_tile_kernelILb0ELb0E": "pack_sub2_sub3",
                   r"mor_select_tile_kernelILb0ELb1E": "pack_sub4"},
    "gam_quant": {
        r"gam_quant_tile_kernelIL\d+__nv_fp8_interpretation_t0E": "e4m3",
        r"gam_quant_tile_kernelIL\d+__nv_fp8_interpretation_t1E": "e5m2"},
}


def tile_build_facts(build, name):
    """A tile route's registers, spills and static shared memory per
    kernel instance (its ``-Xptxas -v`` lines in the build of
    ``csrc/<name>.cu``) and the launcher's dynamic shared memory; a spill
    fails, and so does an instance without ptxas lines."""
    import re
    log = build.build_log(name).splitlines()
    inst = {}
    for i, line in enumerate(log):
        if "Compiling entry function" not in line:
            continue
        label = next((lb for pat, lb in TILE_INSTANCES[name].items()
                      if re.search(pat, line)), None)
        if label is None:
            continue
        facts = inst.setdefault(label, {})
        for ln in log[i + 1:i + 4]:
            if "registers" in ln:
                facts["registers"] = int(ln.split("Used ")[1].split()[0])
                facts["static_smem_bytes"] = int(
                    ln.split(" bytes smem")[0].split()[-1])
            if "spill" in ln:
                facts["spill"] = ln.strip()
    want = sorted(TILE_INSTANCES[name].values())
    check(sorted(inst) == want, f"{name}: ptxas lines for {sorted(inst)}, "
          f"want the tile kernel's instances {want}")
    for label, f in inst.items():
        check(" 0 bytes spill stores, 0 bytes spill loads" in f.get(
            "spill", ""), f"{name} tile kernel {label} spills: {f}")
    return {"instances": inst, "dynamic_smem_bytes": getattr(
        build.load(name), f"{name}_tile_smem")()}


def phase_div_check(build):
    """The tile route's Eq. 1 division (``div_in_range``) against the
    IEEE division on the card, bit for bit: every f32 significand of the
    numerator in twelve binades, both signs, against every bf16
    significand of the divisor, at divisor exponents -80, 0 and 79 (the
    ends of the range where the kernel uses it)."""
    import ctypes
    f = build.load("mor_select").mor_select_div_check_launch
    f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    res = {}
    for b_exp in (-80, 0, 79):
        bad = torch.zeros(1, dtype=torch.int64, device="cuda")
        t0 = time.perf_counter()
        err = f(b_exp, bad.data_ptr(), torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        check(err == 0, f"div check launch failed: CUDA error {err}")
        res[str(b_exp)] = {"mismatches": int(bad.item()),
                           "s": time.perf_counter() - t0}
        check(res[str(b_exp)]["mismatches"] == 0,
              f"div_in_range differs from the division at b_exp {b_exp}: "
              f"{res[str(b_exp)]}")
    res["pairs_per_exponent"] = 2 * 12 * 2 ** 23 * 128
    return res


def sdpa_yardstick(q, k, v, offs):
    """One ``scaled_dot_product_attention`` call computing the same
    function (timed only; the port never calls it): is_causal where the
    offset is the default T - S = 0, an explicit mask otherwise."""
    import torch.nn.functional as F
    B, S, _, _ = q.shape
    T = k.shape[1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if offs is None and S == T:
        return lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)
    off = torch.as_tensor(T - S if offs is None else offs,
                          dtype=torch.int64, device=q.device).reshape(-1)
    pos = off.expand(B)[:, None] + torch.arange(S, device=q.device)
    mask = (torch.arange(T, device=q.device)[None, None, :]
            <= pos[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=True)


def phase_kernel_api(ops, Partition, cfg):
    """The kernel API slice: ``ops.flash_attention`` and ``ops.fp8_gemm``
    at llama3-8b's widths (the shapes of FLASH_API_CASES; M = 2048 tokens
    against the qkv, proj, fc1 and fc2 weights, E4M3 with GAM block
    scales), with every launch counter zeroed just before and read just
    after (every call on its wgmma route); then each call held against
    its plain version and timed beside its bound, its route's own
    ceiling, the cuda_core route and a library call."""
    from repro_torch.core.formats import E4M3
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.fp8_gemm import fp8_gemm_blocks, fp8_gemm_route
    hq, hkv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    d, f = cfg.d_model, cfg.d_ff
    g = torch.Generator(device="cuda").manual_seed(1)
    flash_in = {}
    for name, (B, S, T, offs) in FLASH_API_CASES.items():
        q = torch.randn(B, S, hq, dh, generator=g, device="cuda")
        k = torch.randn(B, T, hkv, dh, generator=g, device="cuda")
        v = torch.randn(B, T, hkv, dh, generator=g, device="cuda")
        off = None if offs is None else torch.tensor(
            offs, dtype=torch.int32, device="cuda")
        flash_in[name] = [t.to(torch.bfloat16) for t in (q, k, v)] + [off]
        del q, k, v
    gemms = {"qkv": (d, (hq + 2 * hkv) * dh), "proj": (hq * dh, d),
             "fc1": (d, 2 * f), "fc2": (f, d)}
    fp8_in = {}
    for name, (K, N) in gemms.items():
        x = torch.randn(FP8_API_M, K, generator=g, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn(K, N, generator=g, device="cuda") * 0.02).to(
            torch.bfloat16)
        aq, sa = fp8_operand(x, (128, 128), E4M3, Partition)
        bq, sb = fp8_operand(w, (128, 128), E4M3, Partition)
        fp8_in[name] = (aq, bq, sa, sb)
        del x, w
    torch.cuda.synchronize()

    reset_counters()
    outs = {}
    for name, (q, k, v, off) in flash_in.items():
        outs[name] = ops.flash_attention(q, k, v, causal=True, q_offset=off)
    for name, args in fp8_in.items():
        outs[name] = ops.fp8_gemm(*args)
    torch.cuda.synchronize()
    k_counts, p_counts = read_counters()
    fp8_routes = dict(fp8_gemm_blocks.launches_by_route)
    flash_routes = dict(flash_attention_fwd.launches_by_route)
    check(k_counts["flash_attention"] == len(flash_in)
          and k_counts["fp8_gemm"] == len(fp8_in),
          f"kernel_api: launches {k_counts}, want one per call")
    check(flash_routes["wgmma"] == len(flash_in),
          f"kernel_api: flash_attention launches by route {flash_routes}, "
          "want every bf16 call on the wgmma route")
    check(fp8_routes["wgmma"] == len(fp8_in),
          f"kernel_api: fp8_gemm launches by route {fp8_routes}, want "
          "every call on the wgmma route")
    check(not any(p_counts.values()),
          f"kernel_api: plain versions ran on the main path: {p_counts}")

    res = {"flash_attention": {}, "fp8_gemm": {}}
    for name, (q, k, v, off) in flash_in.items():
        B, S, T, offs = FLASH_API_CASES[name]
        y = outs[name]
        yt = ops.flash_attention(q, k, v, causal=True, q_offset=off,
                                 backend="torch")
        check(y.shape == (B, S, hq, dh) and bool(torch.isfinite(y).all()),
              f"flash {name}: shape {tuple(y.shape)} or nonfinite values")
        err = (y.float() - yt.float()).abs()
        check(bool(torch.all(err <= flash_tol(v, yt))),
              f"flash {name}: max err {float(err.max())} beyond tolerance")
        o = [T - S] * B if offs is None else list(offs)
        pairs = visible_pairs(S, T, o)
        flops = 4.0 * dh * hq * pairs
        nbytes = 2 * (2 * B * S * hq * dh
                      + 2 * hkv * dh * visible_keys(S, T, o))
        b = bound(nbytes, flops)
        # The wgmma route's own ceiling: p v runs twice (p = hi + lo).
        b_design = bound(nbytes, 6.0 * dh * hq * pairs)
        lib = sdpa_yardstick(q, k, v, off)
        off_rows = None if off is None else off.repeat_interleave(hq)
        # The cuda_core route (the route every f32 call takes) on the
        # same values in f32.
        q32, k32, v32 = (t.float() for t in (q, k, v))
        res["flash_attention"][name] = dict(
            ms=time_ms(lambda: flash_attention_fwd(q, k, v,
                                                   q_offset=off_rows)),
            route="wgmma",
            cuda_core_f32_ms=time_ms(lambda: flash_attention_fwd(
                q32, k32, v32, q_offset=off_rows), iters=3),
            plain_ms=time_ms(lambda: ops.flash_attention(
                q, k, v, q_offset=off, backend="torch")),
            library_ms=time_ms(lib), bound_ms=b[0], bound_by=b[1],
            bound_design_ms=b_design[0], bound_design_by=b_design[1],
            max_abs_err=float(err.max()),
            max_err_over_tol=float((err / flash_tol(v, yt)).max()),
            shape=[B, S, T, hq, hkv, dh], flops=flops, bytes=nbytes)
        del q32, k32, v32, yt
        torch.cuda.empty_cache()
    for name, (aq, bq, sa, sb) in fp8_in.items():
        (M, K), N = aq.shape, bq.shape[1]
        A, Bd = dequant(aq, sa, (128, 128)), dequant(bq, sb, (128, 128))
        y = outs[name]
        yt = ops.fp8_gemm(aq, bq, sa, sb, backend="torch")
        check(y.shape == (M, N) and bool(torch.isfinite(y).all()),
              f"fp8_gemm {name}: shape {tuple(y.shape)} or nonfinite values")
        err = (y.float() - yt.float()).abs()
        check(bool(torch.all(err <= gemm_tol(A, Bd.T, yt, torch.bfloat16))),
              f"fp8_gemm {name}: max err {float(err.max())} beyond 1e-5 "
              "sum|a b| + 1 bf16 ulp")
        a16, b16 = A.to(torch.bfloat16), Bd.to(torch.bfloat16)
        # PR 13's route, timed beside it at a block the route function
        # gives it (bk = 64: the same products, twice the promotions).
        cq = (fp8_operand(A, CUDA_CORE_BLOCK[::2], E4M3, Partition)
              + fp8_operand(Bd, CUDA_CORE_BLOCK[:0:-1], E4M3, Partition))
        del A, Bd, yt
        flops = 2.0 * M * N * K
        nbytes = M * K + K * N + 4 * (sa.numel() + sb.numel()) + 2 * M * N
        b = bound(nbytes, flops, FP8_FLOPS)
        # The wgmma route's own ceiling: its MMAs run at the f16 rate.
        b_f16 = bound(nbytes, flops, BF16_FLOPS)
        check(fp8_gemm_route(M, N, K, CUDA_CORE_BLOCK) == "cuda_core",
              f"fp8_gemm: block {CUDA_CORE_BLOCK} is not on the cuda_core "
              "route")
        res["fp8_gemm"][name] = dict(
            ms=time_ms(lambda: fp8_gemm_blocks(aq, bq, sa, sb)),
            route="wgmma",
            cuda_core_ms=time_ms(lambda: fp8_gemm_blocks(
                cq[0], cq[2], cq[1], cq[3], block=CUDA_CORE_BLOCK), iters=3),
            cuda_core_block=list(CUDA_CORE_BLOCK),
            plain_ms=time_ms(lambda: ops.fp8_gemm(aq, bq, sa, sb,
                                                  backend="torch")),
            library_ms=time_ms(lambda: torch.matmul(a16, b16)),
            bound_ms=b[0], bound_by=b[1], bound_f16_ms=b_f16[0],
            max_abs_err=float(err.max()), shape=[M, N, K],
            flops=flops, bytes=nbytes)
        del a16, b16, cq
        torch.cuda.empty_cache()
    for kern, head in (("flash_attention", "b_context_8192"),
                       ("fp8_gemm", "fc1")):
        res[kern] = {**res[kern][head], "case": head, "cases": res[kern]}
    del flash_in, fp8_in, outs
    gc.collect()
    torch.cuda.empty_cache()
    res["fp8_gemm"]["launches_by_route"] = fp8_routes
    res["flash_attention"]["launches_by_route"] = flash_routes
    return res, k_counts


# Generic routes' shared memory (the repair): the static bytes the card
# reports, each generic instance at the blocks of the gradient
# compression at reduced widths and at the 48 KB boundary, then one
# compressed-state step of reduced nemotron3-8b.
SMEM_BLOCKS = (((4, 64), torch.float32), ((1, 64), torch.float32),
               ((128, 96), torch.float32), ((128, 64), torch.float32),
               ((128, 192), torch.bfloat16), ((128, 96), torch.bfloat16))


def smem_operand(shape, dtype, seed):
    """N(0, 1) rows with a moderate-range stripe (E5M2 blocks), an
    all-zero row, and in f32 values that are not bf16-exact."""
    rng = np.random.default_rng(seed)
    m, k = shape
    x = rng.standard_normal((m, k))
    n3 = len(range(0, k, 3))
    x[:, ::3] = np.sign(x[:, ::3]) * rng.uniform(1, 2, (m, n3)) * np.exp2(
        rng.integers(-12, 4, (m, n3)))
    if m > 2:
        x[m // 2] = 0.0
    if dtype == torch.float32:
        x = x * (1 + rng.uniform(0, 2.0**-10, x.shape))
    return torch.from_numpy(x.astype(np.float32)).to(dtype).cuda()


def generic_static_smem(build):
    """The generic kernels' static shared bytes as the card reports them
    (cudaFuncGetAttributes), by instance."""
    import ctypes
    sel = build.load("mor_select").mor_select_generic_static_smem
    sel.argtypes, sel.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    gq = build.load("gam_quant").gam_quant_generic_static_smem
    gq.argtypes, gq.restype = [], ctypes.c_int
    return {"pack": sel(0, 0), "select_bf16": sel(1, 0),
            "select_f32": sel(1, 1), "gam_quant": gq()}


def phase_generic_smem(ops, Partition, build, smi):
    """The repair of the generic routes' shared-memory opt-in. (1) The
    static shared bytes of every generic instance as the card reports
    them are within the host's bound (``mor_select_smem_bytes`` /
    ``gam_quant_smem_bytes``), which the wrappers' refusal uses. (2) Each generic instance (pack, select
    bf16, select f32, gam_quant E4M3 and E5M2; sub3 and sub4) at the
    gradient compression's blocks at d 64 -- (4, 64), (1, 64), (128, 96),
    (128, 64) f32 -- and at the 48 KB boundary -- (128, 192) bf16,
    (128, 96) f32 -- (and (128, 96) bf16), on one row of blocks and on a
    ragged multi-block operand: every launch succeeds on the generic
    route and matches its plain version (y, sel, payload lanes, tags,
    scales, xq, block_exp and counts bit for bit; the selection's error
    sums within rtol 1e-5, gam_quant's within 1e-6). (3) One
    compressed-state step ('mor_ef', ``GuardPolicy()``, FP8_MOMENTS) of
    reduced nemotron3-8b (d 64), the call that failed, with the counters
    zeroed just before and read just after: every f32 select launch
    succeeds (one per gradient leaf), no plain version runs. Returns
    (result, launches, tile routes)."""
    from repro_torch.core.formats import E4M3, E5M2
    from repro_torch.kernels.gam_quant import (GENERIC_STATIC_SMEM as GQ_STATIC,
                                               gam_quant_blocks,
                                               gam_quant_smem_bytes)
    from repro_torch.kernels.mor_select import (GENERIC_STATIC_SMEM,
                                                mor_select_pack,
                                                mor_select_route,
                                                mor_select_select,
                                                mor_select_smem_bytes)
    t0 = time.perf_counter()
    static = generic_static_smem(build)
    want = {"pack": GENERIC_STATIC_SMEM, "select_bf16": GENERIC_STATIC_SMEM,
            "select_f32": GENERIC_STATIC_SMEM, "gam_quant": GQ_STATIC}
    emit({"generic_smem_static": static, "host_bound": want, "card": smi})
    check(all(0 < static[k] <= want[k] for k in want),
          f"static shared bytes {static} beyond the host's bound {want}")
    rows = []
    for block, dtype in SMEM_BLOCKS:
        bm, bk = block
        dt = str(dtype).split(".")[-1]
        for shape in ((bm, 3 * bk), (2 * bm + 3, 2 * bk + 5)):
            x = smem_operand(shape, dtype, seed=bm + bk + shape[0])
            row = {"block": list(block), "dtype": dt, "shape": list(shape),
                   "calls": []}
            for mode in ("sub3", "sub4"):
                if mode == "sub4" and (bm % 2 or bk % 16):
                    continue
                check(mor_select_route(block, mode, dtype) == "generic",
                      f"{block} {mode} is not a generic block")
                part = Partition("block", block, align=(
                    (2, 16) if mode == "sub4" else (1, 1)))
                what = f"select {dt} {block} {shape} {mode}"
                before = mor_select_select.launches_by_route["generic"]
                k = ops.mor_select(x, part, mode, backend="cuda")
                t = ops.mor_select(x, part, mode, backend="torch")
                torch.cuda.synchronize()
                check(mor_select_select.launches_by_route["generic"]
                      == before + 1, f"{what}: not on the generic route")
                check(torch.equal(bits16(k.y), bits16(t.y))
                      and torch.equal(k.sel, t.sel)
                      and torch.equal(k.counts, t.counts),
                      f"{what}: differs from the plain version")
                for f in ("e4_sums", "e5_sums", "nv_sums"):
                    a, b = getattr(k, f), getattr(t, f)
                    check(a is None or torch.allclose(
                        a, b, rtol=1e-5, atol=0.0, equal_nan=True),
                        f"{what}: {f} beyond rtol 1e-5")
                row["calls"].append(f"select_{mode}")
                if dtype != torch.bfloat16:
                    continue
                what = f"pack {block} {shape} {mode}"
                before = mor_select_pack.launches_by_route["generic"]
                mo_k, r_k = ops.quantize_pack(x, part, mode, backend="cuda")
                mo_t, r_t = ops.quantize_pack(x, part, mode, backend="torch")
                torch.cuda.synchronize()
                check(mor_select_pack.launches_by_route["generic"]
                      == before + 1, f"{what}: not on the generic route")
                assert_pack_equal(mo_k, mo_t, r_k, r_t, what)
                row["calls"].append(f"pack_{mode}")
            if dtype == torch.bfloat16:
                for fmt in (E4M3, E5M2):
                    what = f"gam_quant {block} {shape} {fmt.name}"
                    before = gam_quant_blocks.launches_by_route["generic"]
                    k = ops.gam_quant(x, block=block, fmt=fmt, backend="cuda")
                    t = ops.gam_quant(x, block=block, fmt=fmt,
                                      backend="torch")
                    torch.cuda.synchronize()
                    check(gam_quant_blocks.launches_by_route["generic"]
                          == before + 1, f"{what}: not on the generic route")
                    check_gam_quant(k, t, what)
                    row["calls"].append(f"gam_quant_{fmt.name}")
            row["smem_bytes"] = {
                "select": sum(mor_select_smem_bytes(block, "sub3", dtype)),
                "gam_quant": sum(gam_quant_smem_bytes(block))}
            rows.append(row)
    emit({"generic_smem_parity": rows, "card": smi})
    step = reduced_state_step()
    res = {"static_smem": static, "parity_cases": len(rows),
           "reduced_step": step[0], "phase_s": time.perf_counter() - t0,
           "card": smi}
    emit({"generic_smem": res})
    return res, step[1], step[2]


def reduced_state_step():
    """One step of reduced nemotron3-8b (d 64, 2 layers) with the
    compressed state (FP8_MOMENTS, 'mor_ef', ``GuardPolicy()``; paper
    sub3 GEMMs; 2 x 64 tokens) with the counters zeroed just before and
    read just after. Returns (result, launches, tile routes)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.policy import paper_default
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels.mor_select import mor_select_select
    from repro_torch.models import init_params
    from repro_torch.optim import FP8_MOMENTS, AdamWConfig, init_opt_state
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.robust import GuardPolicy
    from repro_torch.train import TrainConfig, make_train_step
    cfg = reduced(get_config("nemotron3-8b"))
    params = init_params(cfg, seed=0, device="cuda")
    n_leaves = len(tree_leaves(params))
    opt = init_opt_state(params, moments=FP8_MOMENTS, ef=True)
    step_fn = make_train_step(cfg, paper_default("sub3"), TrainConfig(
        optimizer=AdamWConfig(warmup_steps=1), moments=FP8_MOMENTS,
        compress_grads="mor_ef", guard=GuardPolicy()))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=2, seed=1234))
    batch = {k: torch.from_numpy(v.astype(np.int64)).cuda()
             for k, v in data.batch_at(0).items()}
    torch.cuda.synchronize()
    reset_counters()
    params, opt, m = step_fn(params, opt, batch)
    torch.cuda.synchronize()
    launches, plain = read_counters()
    by_dtype = dict(mor_select_select.launches_by_dtype)
    routes = tile_routes()
    res = {"arch": cfg.name, "d_model": cfg.d_model, "layers": cfg.n_units,
           "loss": float(m["loss"]), "guard_skip": float(m.get(
               "guard_skip", 0.0)), "n_leaves": n_leaves,
           "select_launches_by_dtype": by_dtype, "tile_routes": routes,
           "launches": launches, "plain_calls": plain}
    check(np.isfinite(res["loss"]) and res["guard_skip"] == 0.0
          and by_dtype["float32"] == n_leaves and not any(plain.values()),
          f"reduced nemotron3-8b compressed step: {res}")
    return res, launches, routes


# The serving tiers (phase_serve_tiers): llama3-8b, sub3 QTensor weights.
SERVE_TIERS = {"bf16": {}, "kv_fp8": {"kv_fp8": True},
               "kv_mor": {"kv_mor": True},
               "kv_mor_cold": {"kv_mor": True, "kv_mor_cold": 64,
                               "kv_guard": True}}
SERVE_LENGTHS = (5, 7, 19, 33, 48, 64, 77, 100)  # phase_engine's requests
PREFILL_LEN, PREFILL_DEPTH2_LEN = 2048, 512


def serve_requests(vocab):
    """phase_engine's 8 requests (16 tokens, request 3 sampled) and one
    of 300 prompt tokens and 32 new ones, whose pages go cold."""
    rng = np.random.default_rng(0)
    from repro_torch.serve import Request
    reqs = []
    for i, L in enumerate(SERVE_LENGTHS):
        kw = dict(temperature=0.8, top_k=40, seed=1) if i == 3 else {}
        reqs.append(Request(i, rng.integers(0, vocab, L).astype(np.int32),
                            max_tokens=16, **kw))
    reqs.append(Request(len(reqs), rng.integers(0, vocab, 300).astype(
        np.int32), max_tokens=32))
    return reqs


class Totals:
    """Launch counts, tile routes and GEMM paths summed over the parts of
    a phase: each part zeroes the counters just before it runs and adds
    them just after (``add_current``), which also fails if a plain
    version ran."""

    def __init__(self):
        self.launches, self.routes, self.paths = None, None, None

    def add_current(self, what):
        launches, plain = read_counters()
        check(not any(plain.values()),
              f"{what}: plain versions ran on the main path: {plain}")
        routes, paths = tile_routes(), gemm_paths()
        if self.launches is None:
            self.launches = dict(launches)
            self.routes = {k: dict(v) for k, v in routes.items()}
            self.paths = dict(paths)
        else:
            for k in self.launches:
                self.launches[k] += launches[k]
            for k, by in routes.items():
                for r in by:
                    self.routes[k][r] += by[r]
            for k in self.paths:
                self.paths[k] += paths[k]
        return launches, paths


def raw(t):
    """An integer view of a lane for bit-for-bit comparison."""
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8)
    return bits16(t)


def serve_tier_run(cfg, qparams, name, tier, smi, totals, ref_out=None):
    """(a) One engine run of the 9 requests on the tier's pool: step and
    chunk ms (medians), tokens/s, peak GB, the census of the MoR pool at
    every step, the pages sealed, and every sealing's slab held against
    ``recompress_kv_nvfp4`` on the CPU bit for bit. Returns (row, the
    requests' tokens)."""
    from repro_torch.core.policy import MoRDotPolicy
    from repro_torch.models.attention import recompress_kv_nvfp4
    from repro_torch.serve import Engine, ServeConfig
    reqs = serve_requests(cfg.vocab)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    eng = Engine(cfg, MoRDotPolicy(), qparams,
                 ServeConfig(slots=4, max_seq=512, prefill_chunk=32, **tier),
                 device="cuda")
    step_ms = {"decode": [], "prefill": []}

    def timed(fn, key):
        def wrapper(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            step_ms[key].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    eng._decode_batch = timed(eng._decode_batch, "decode")
    eng._prefill_chunk_step = timed(eng._prefill_chunk_step, "prefill")
    seals = []
    if tier.get("kv_mor_cold"):
        pool, recompress = eng.pool, eng.pool.recompress_pages

        def recompress_checked(pages):
            idx = torch.as_tensor([p for p in pages if p != pool.trash],
                                  device="cuda")
            hot = [tuple(t[:, idx].cpu() for t in g)
                   for g in pool._kv_lane_groups()]
            n = recompress(pages)
            for (p, tg, sc), g in zip(hot, pool._kv_lane_groups()):
                want = recompress_kv_nvfp4(p, tg, sc)
                got = tuple(t[:, idx].cpu() for t in g)
                check(all(torch.equal(raw(a), raw(b))
                          for a, b in zip(got, want)),
                      f"{name}: sealed pages {pages} differ from the CPU's "
                      "recompress_kv_nvfp4 of their hot lanes")
            seals.append(n)
            return n

        pool.recompress_pages = recompress_checked
    for r in reqs:
        eng.submit(r)
    census, census_s, steps = [], 0.0, 0
    t0 = time.perf_counter()
    while eng.step():
        steps += 1
        if tier.get("kv_mor"):
            t = time.perf_counter()
            census.append(eng.kv_cache_stats())
            census_s += time.perf_counter() - t
        check(steps < 1000, f"{name}: the engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - census_s
    launches, paths = totals.add_current(name)
    for r in reqs:
        check(r.done and r.error is None, f"{name} request {r.rid}: "
              f"{r.error}")
        check(len(r.out) == r.max_tokens
              and all(0 <= t < cfg.vocab for t in r.out),
              f"{name} request {r.rid}: tokens {r.out}")
    calls = eng.prefill_chunks + eng.decode_steps
    L = cfg.n_units
    check(launches["mixed_gemm"] == (4 * L + 1) * calls
          and paths["stream"] == launches["mixed_gemm"],
          f"{name}: mixed_gemm {launches['mixed_gemm']} launches, paths "
          f"{paths}, {calls} model calls")
    bpt = eng.pool.bytes_per_token()
    hkv, dh = cfg.n_kv, cfg.head_dim
    want_bpt = 2 * L * {"bf16": hkv * dh * 2, "kv_fp8": hkv * dh + 4 * hkv}.get(
        name, hkv * dh + hkv + 4 * hkv)
    check(bpt == want_bpt, f"{name}: bytes_per_token {bpt} != {want_bpt}")
    check(bpt == L * {"bf16": 4096, "kv_fp8": 2112}.get(name, 2128),
          f"{name}: bytes_per_token {bpt}")
    tokens = sum(len(r.out) for r in reqs)
    row = {"tier": name, **{k: v for k, v in tier.items()},
           "requests": len(reqs), "steps": steps,
           "prefill_chunks": eng.prefill_chunks,
           "decode_steps": eng.decode_steps,
           "decode_step_ms": float(np.median(step_ms["decode"])),
           "prefill_chunk_ms": float(np.median(step_ms["prefill"])),
           "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "bytes_per_token": bpt, "launches": launches,
           "mixed_gemm_paths": paths, "card": smi}
    if census:
        # The pool's census (models.attention.kv_stats_row semantics) at
        # the step with the most written rows and at the step with the
        # largest NVFP4 share.
        for key, stat in (("at_most_written", "written"),
                          ("at_max_nvfp4", "frac_nvfp4")):
            at = max(census, key=lambda c: c.get(stat, 0))
            row[f"kv_cache_stats_{key}"] = {
                k: (v.tolist() if k == "stats_row" else v)
                for k, v in at.items()}
        row["kv_cache_stats_max_frac_nvfp4"] = max(
            c.get("frac_nvfp4", 0.0) for c in census)
        row["census_steps"], row["census_s"] = len(census), census_s
    if tier.get("kv_mor_cold"):
        row["pages_sealed"] = sum(seals)
        row["sealing_calls"] = len(seals)
        check(row["kv_cache_stats_max_frac_nvfp4"] > 0 and sum(seals) > 0
              and not eng._sealed, f"{name}: no page went cold: {row}")
    row["profile"] = profile_decode(eng)
    row["aten_ops_per_decode_call"] = dispatched_ops(eng)
    out = [list(r.out) for r in reqs]
    if ref_out is not None:
        same = sum(a == b for x, y in zip(out, ref_out) for a, b in zip(x, y))
        row["tokens_equal_to_bf16"] = same / tokens
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return row, out


def dispatched_ops(eng):
    """ATen operators dispatched by one decode-shaped model call (all
    slots on the trash page, as profile_decode's calls): what the host
    pays per step, beside the kernels' device time."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    slots = eng.scfg.slots
    bt = torch.full((slots, eng.pool.pages_per_seq), eng.pool.trash,
                    dtype=torch.int64, device=eng.device)
    with Count():
        eng._step_fn(bt, np.zeros((slots, 1), np.int32),
                     np.zeros(slots, np.int32))
    torch.cuda.synchronize()
    return Count.n


def layer0_rows(cfg, qparams, tier, totals, P=100):
    """(b) A one-request engine of the tier run chunk by chunk until the
    P-token prompt is prefilled (and no decode step has written the
    chunks' padding); the slot's layer-0 lanes at its first ceil(P / 32)
    * 32 positions, on the host: {lane: tensor}."""
    from repro_torch.core.policy import MoRDotPolicy
    from repro_torch.serve import Engine, Request, ServeConfig
    reset_counters()
    eng = Engine(cfg, MoRDotPolicy(), qparams,
                 ServeConfig(slots=4, max_seq=512, prefill_chunk=32, **tier),
                 device="cuda")
    req = Request(0, serve_requests(cfg.vocab)[7].prompt, max_tokens=4)
    check(len(req.prompt) == P, f"layer-0 lanes: a {len(req.prompt)}-token "
          "prompt")
    eng.submit(req)
    eng._admit()
    while eng.slot_state[0] == "prefill":
        eng._prefill_chunk_step(0, req)
    n = -(-P // 32) * 32
    pages = eng.pool.block_table[0][:eng.pool.pages_for(n)]
    idx = torch.as_tensor(pages, dtype=torch.int64, device="cuda")
    out = {}
    for key, leaf in eng.pool._by_key():
        lane = leaf[0, idx]  # (pages, page_size, ...)
        out[key.split("/")[-1]] = lane.reshape(-1, *lane.shape[2:])[:n].cpu()
    totals.add_current("layer-0 lanes")
    del eng
    return out


def lanes_vs_cpu(cfg, qparams, smi, totals):
    """(b) Layer 0's K/V rows depend only on the prompt, so they are the
    same in every tier's run; each chunk of 32 rows is quantized as one
    call (one GAM group) by the decode path. The fp8 and MoR lanes the
    card wrote must equal, bit for bit, ``quantize_kv`` /
    ``quantize_kv_mor`` run on the CPU on the bf16 run's rows, chunk by
    chunk."""
    from repro_torch.models.attention import quantize_kv, quantize_kv_mor
    rows = {name: layer0_rows(cfg, qparams, tier, totals)
            for name, tier in SERVE_TIERS.items()}
    bf = rows["bf16"]
    n = bf["k"].shape[0]
    res = {"positions": n, "card": smi}
    for name in ("kv_fp8", "kv_mor", "kv_mor_cold"):
        got = rows[name]
        for lane in ("k", "v"):
            chunks = [bf[lane][c:c + 32][None] for c in range(0, n, 32)]
            if name == "kv_fp8":
                want = [quantize_kv(x) for x in chunks]
                names = ("", "_scale")
            else:
                want = [quantize_kv_mor(x) for x in chunks]
                names = ("", "_tags", "_scale")
            for i, suffix in enumerate(names):
                w = torch.cat([q[i][0] for q in want])
                g = got[lane + suffix]
                same = g.dtype == w.dtype and torch.equal(raw(w), raw(g))
                res[f"{name}/{lane}{suffix}"] = same
                check(same, f"layer-0 lane {lane}{suffix} of {name} differs "
                      "from the CPU's quantizer on the bf16 run's rows")
    emit({"serve_tiers_lanes": res})
    return res


def prefill_full(cfg, qparams, smi, totals):
    """(c) make_prefill_fn on one 2048-token prompt at ``cfg``'s depth: all
    4L + 1 GEMMs on the tc path, the emitted cache (L, 1, 2048, 8, 128)
    bf16; its ms and tokens/s. Then that prompt served by a kv_mor engine
    through _full_prefill (splice) and by a chunked one (max_seq 4096),
    16 tokens each: the first sampled token's logits row of each, and
    their largest difference."""
    from repro_torch.core.policy import MoRDotPolicy
    from repro_torch.models import make_prefill_fn
    from repro_torch.serve import Engine, Request, ServeConfig
    L = cfg.n_units
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, PREFILL_LEN)
    batch = {"tokens": torch.from_numpy(prompt[None]).cuda()}
    fn = make_prefill_fn(cfg, MoRDotPolicy())
    fn(qparams, batch)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    t = time.perf_counter()
    logits, cache, _ = fn(qparams, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches, paths = totals.add_current("prefill")
    shape = tuple(cache["dense"]["k"].shape)
    res = {"prompt": PREFILL_LEN, "prefill_ms": ms,
           "tokens_per_s": PREFILL_LEN / ms * 1e3, "gemm_paths": paths,
           "cache_shape": list(shape), "cache_dtype": str(
               cache["dense"]["k"].dtype), "logits_shape": list(
               logits.shape), "card": smi}
    check(launches["mixed_gemm"] == 4 * L + 1 and paths["tc"] == 4 * L + 1,
          f"prefill GEMMs: {res}")
    check(shape == (L, 1, PREFILL_LEN, cfg.n_kv, cfg.head_dim)
          and cache["dense"]["k"].dtype == torch.bfloat16
          and bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          f"prefill cache / logits: {res}")
    del logits, cache
    rows = {}
    for how in ("full_prefill", "chunked"):
        reset_counters()
        eng = Engine(cfg, MoRDotPolicy(), qparams, ServeConfig(
            slots=1, max_seq=4096, prefill_chunk=32, kv_mor=True),
            device="cuda")
        eng.chunked_prefill = how == "chunked"
        seen = []
        start = eng._start_decode

        def record(slot, req, P, row, start=start):
            seen.append(row.copy())
            return start(slot, req, P, row)

        eng._start_decode = record
        r = Request(0, prompt.astype(np.int32), max_tokens=17)
        eng.submit(r)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.run_to_completion()
        torch.cuda.synchronize()
        totals.add_current(how)
        check(r.done and r.error is None and len(r.out) == 17,
              f"{how}: {r.error}")
        rows[how] = {"wall_s": time.perf_counter() - t,
                     "prefill_chunks": eng.prefill_chunks,
                     "decode_steps": eng.decode_steps, "tokens": r.out}
        rows[how]["logits"] = seen[0][:cfg.vocab]
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    d = np.abs(rows["full_prefill"].pop("logits")
               - rows["chunked"].pop("logits"))
    res.update({"engines": rows, "first_logits_max_diff": float(d.max()),
                "first_token_equal": rows["full_prefill"]["tokens"][0]
                == rows["chunked"]["tokens"][0]})
    emit({"serve_tiers_prefill": res})
    return res


def prefill_depth2(cfg, ops, ref, qparams_fn, smi):
    """(c) At depth 2, full width: a 512-token prompt's prefill logits and
    emitted cache three ways (``depth2_three_ways``), all five GEMM
    shapes at M = 512."""
    from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
    from repro_torch.models import make_prefill_fn
    c2 = dataclasses.replace(cfg, n_layers=2)
    params = qparams_fn(c2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab,
                                             (1, PREFILL_DEPTH2_LEN))
    batch = {"tokens": torch.from_numpy(toks).cuda()}

    def run(backend, _way):
        fn = make_prefill_fn(c2, MoRDotPolicy(
            weight=MoRPolicy(backend=backend)))
        logits, cache, _ = fn(params, batch)
        return (logits[..., :cfg.vocab], cache["dense"]["k"].float(),
                cache["dense"]["v"].float())

    res, gemms = depth2_three_ways(run, ops, ref, "depth-2 prefill",
                                   ("logits", "k", "v"))
    check(all(k[0] == PREFILL_DEPTH2_LEN for k in gemms) and len(gemms) == 5,
          f"depth-2 prefill GEMM shapes {sorted(gemms)}")
    res.update(prompt=PREFILL_DEPTH2_LEN, card=smi)
    emit({"serve_tiers_prefill_depth2": res})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def guard_trash(qparams_fn, smi, totals):
    """(d) ft_kv_trash's setup (llama3-8b, STATE_LAYERS layers, 3 slots,
    prompts of 3, 17 and 9 tokens, 16 new) with the KV-page guard, the
    victim's first page trashed after 5 steps, on the MoR tier and on the
    fp8 tier, each beside a clean run of its tier. The victim's error
    names the guard and the first float lane in key order
    (``'dense/k_scale'`` under MoR, ``'dense/k'`` under fp8). Under fp8
    (per-row scales) the other requests' tokens are bit-identical to the
    clean run. Under MoR every quantize_kv_mor call is one GAM group over
    all the batch's rows, as in the reference, so the victim's NaN row in
    the step that catches it (and its empty slot after) moves the other
    rows' scales: their tokens sampled before that step must equal the
    clean run's, and the step must show a nonfinite row in a group; the
    rest is reported."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MoRDotPolicy
    from repro_torch.models import blocks
    from repro_torch.robust import get_fault
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=STATE_LAYERS)
    params = qparams_fn(cfg)
    nonfinite_groups = []
    quantize = blocks.quantize_kv_mor

    def watched(x, with_stats=False):
        nonfinite_groups.append(not bool(torch.isfinite(x).all()))
        return quantize(x, with_stats)

    def serve(tier, inject):
        reset_counters()
        eng = Engine(cfg, MoRDotPolicy(), params, ServeConfig(
            slots=3, max_seq=512, prefill_chunk=32, kv_guard=inject,
            **tier), device="cuda")
        rng = np.random.default_rng(11)
        reqs = [Request(i, rng.integers(0, cfg.vocab, L).astype(np.int32),
                        max_tokens=16) for i, L in enumerate((3, 17, 9))]
        for r in reqs:
            eng.submit(r)
        before = None
        if inject:
            for _ in range(5):
                eng.step()
            check(eng.slot_state[0] == "decode",
                  f"the victim is {eng.slot_state[0]}, not decoding")
            before = [len(r.out) for r in reqs]
            get_fault("kv_page_trash").inject(eng.pool, eng.pool._owned[0][0])
            nonfinite_groups.clear()
            with patched(blocks, "quantize_kv_mor", watched):
                eng.step()  # the step that catches the victim
        eng.run_to_completion()
        totals.add_current("kv guard")
        return reqs, eng, before

    res = {"card": smi}
    for name, tier, lane in (("kv_mor", {"kv_mor": True}, "dense/k_scale"),
                             ("kv_fp8", {"kv_fp8": True}, "dense/k")):
        clean, _, _ = serve(tier, False)
        inj, eng, before = serve(tier, True)
        v = inj[0]
        same = [a.out == b.out for a, b in zip(inj[1:], clean[1:])]
        prefix = [a.out[:n] == b.out[:n] for a, b, n in
                  zip(inj[1:], clean[1:], before[1:])]
        first_diff = [next((i for i, (x, y) in enumerate(zip(a.out, b.out))
                            if x != y), None)
                      for a, b in zip(inj[1:], clean[1:])]
        row = res[name] = {
            "victim_error": v.error, "victim_tokens": len(v.out),
            "others_identical": all(same),
            "others_tokens_before_catch": before[1:],
            "others_first_differing_token": first_diff,
            "quarantined": [r.rid for r in eng.quarantined],
            "pages_free_after": eng.pool.free_pages(),
            "catching_step_nonfinite_groups": sum(nonfinite_groups)}
        check(all(r.error is None for r in clean + inj[1:])
              and v.error is not None
              and v.error.startswith("quarantined: KV-page guard")
              and repr(lane) in v.error and row["quarantined"] == [0]
              and row["pages_free_after"] == eng.pool.n_pages
              and all(prefix), f"kv guard {name}: {row}")
        if name == "kv_fp8":
            check(all(same), f"kv guard {name}: other slots' tokens "
                  f"differ from the clean run: {row}")
        else:
            check(row["catching_step_nonfinite_groups"] > 0,
                  f"kv guard {name}: no nonfinite row reached a "
                  f"quantize_kv_mor group in the catching step: {row}")
        del eng
    emit({"serve_tiers_kv_guard": res})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_serve_tiers(cfg, ops, ref, smi, n_layers=SERVE_TIER_LAYERS):
    """The serving tiers on llama3-8b at full width with sub3 QTensor
    weights, each tree quantized once (the engines take it with
    ``quantize=None``): at ``SERVE_TIER_LAYERS`` (a) four engine runs
    (bf16, kv_fp8, kv_mor, kv_mor + kv_mor_cold=64 + kv_guard) of the 9
    requests and (b) the layer-0 lanes against the CPU quantizers; at
    ``n_layers`` (c) a 2048-token make_prefill_fn on the tc path and
    _full_prefill against chunked prefill on a kv_mor pool; the depth-2
    three-way prefill; (d) the KV-page guard. The counters are zeroed
    just before each main-path part and read just after (the depth-2
    comparison's calls are not counted). Returns (result, Totals of the
    parts)."""
    from repro_torch.core.policy import MoRPolicy
    from repro_torch.models import init_params
    from repro_torch.serve.quantized import param_bytes, quantize_params
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    totals = Totals()

    def qparams_fn(c):
        params = init_params(c, seed=0, device="cuda")
        q, _ = quantize_params(params, MoRPolicy(recipe="sub3"))
        return q

    def quantized(c):
        """qparams_fn with the counters zeroed just before: one pack a
        weight matrix. Returns (tree, quantize s, weight bytes)."""
        reset_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        q = qparams_fn(c)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        k, _ = totals.add_current(f"weight quantization, {c.n_units} layers")
        check(k["mor_select_pack"] == 4 * c.n_units + 1,
              f"weight packs: {k['mor_select_pack']}")
        return q, dt, param_bytes(q)

    c8 = dataclasses.replace(cfg, n_layers=SERVE_TIER_LAYERS)
    qparams, dt, nbytes = quantized(c8)
    res = {"arch": cfg.name, "layers": cfg.n_units,
           "engine_layers": c8.n_units, "engine_quantize_s": dt,
           "engine_weight_bytes": nbytes, "card": smi}
    runs, ref_out = {}, None
    for name, tier in SERVE_TIERS.items():
        row, out = serve_tier_run(c8, qparams, name, tier, smi, totals,
                                  ref_out)
        emit({"serve_tiers_run": row})
        runs[name] = {k2: v for k2, v in row.items() if k2 not in (
            "launches", "card")}
        if name == "bf16":
            ref_out = out
    res["runs"] = runs
    res["lanes"] = lanes_vs_cpu(c8, qparams, smi, totals)
    if cfg.n_units == c8.n_units:
        res["quantize_s"], res["weight_bytes"] = dt, nbytes
    else:
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
        qparams, res["quantize_s"], res["weight_bytes"] = quantized(cfg)
    pre = prefill_full(cfg, qparams, smi, totals)
    res["prefill"] = {k: v for k, v in pre.items() if k != "card"}
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    res["prefill_depth2"] = prefill_depth2(cfg, ops, ref, qparams_fn, smi)
    res["kv_guard"] = guard_trash(qparams_fn, smi, totals)
    for kern in ("mor_select_pack", "mixed_gemm"):
        check(totals.launches[kern] > 0,
              f"serve tiers: {kern} launched no time on its path")
    check(totals.paths["tc"] >= 4 * cfg.n_units + 1,
          f"serve tiers: the tc path {totals.paths}")
    res["launches"] = totals.launches
    res["gemm_paths"] = totals.paths
    res["phase_s"] = time.perf_counter() - t0
    return res, totals



# ------------------------------------------------------------- model zoo --
ZOO_ARCHS = ("granite-moe-1b-a400m", "gemma-2b", "moonshot-v1-16b-a3b")
# moonshot-v1-16b-a3b at depth 2: its 48 layers are ~27 B params with the
# experts in bf16 (the 4-D expert stacks stay dense under quantize, as
# in the reference), ~55 GB, and a decode call would make 48 x 64 x 2 =
# 6,144 expert mor_dots. Depth 2 keeps every shape (4 until the script's
# time limit needed the room for the recurrent families).
MOONSHOT_LAYERS = 2
# granite-moe-1b-a400m's engine runs and training steps at 4 of its 24
# layers (8 before tp_serve's checks grew; its parity, expert-loop and
# depth-2 checks take one or two layers): host-paced (the card idle
# ~0.88 of a decode call), their time scales with depth, and every check
# they make holds at any depth. At 24 layers they took 116 s of a 264 s
# model_zoo phase on a host where the whole script took 1,093.4 s of its
# 1,200 (an H100 80GB HBM3, 700 W); at 8, 46.0 s, at 4, 25.1 s.
GRANITE_LAYERS = 4
# gemma-2b's engine runs at 6 of its 18 layers (full depth before;
# host-paced, every check of zoo_serve holds at any depth): tp_serve
# needed the room.
GEMMA_LAYERS = 6
ZOO_TRAIN_STEPS = 3
ZOO_DEV = "cuda"


def zoo_requests(vocab, n=len(SERVE_LENGTHS)):
    """phase_engine's requests (16 tokens each, request 3 sampled), the
    first ``n`` of them."""
    from repro_torch.serve import Request
    rng = np.random.default_rng(0)
    reqs = []
    for i, L in enumerate(SERVE_LENGTHS):
        kw = dict(temperature=0.8, top_k=40, seed=1) if i == 3 else {}
        reqs.append(Request(i, rng.integers(0, vocab, L).astype(np.int32),
                            max_tokens=16, **kw))
    return reqs[:n]


def zoo_gemms(cfg):
    """(QTensor GEMMs of one model call, expert mor_dots of one model
    call): the attention GEMMs (and a dense layer's MLP) take the mixed
    GEMM, the untied head too; an MoE layer's experts run E x 2
    mor_dots of two events each (one chunk: S <= 256); the recurrent
    families' ``rec_gemms``."""
    if cfg.family in REC_FAMILIES:
        return rec_gemms(cfg), 0
    per_layer = 2 if cfg.family == "moe" else 4
    n_q = per_layer * cfg.n_units + (0 if cfg.tie_embed else 1)
    experts = 2 * cfg.n_experts * cfg.n_units if cfg.family == "moe" else 0
    return n_q, experts


def zoo_bytes_per_token(cfg, tier):
    hkv, dh = cfg.n_kv, cfg.head_dim
    per = hkv * dh + hkv + 4 * hkv if tier.get("kv_mor") else 2 * hkv * dh
    return 2 * cfg.n_units * per


def zoo_layer_stats(eng):
    """Each layer's dropped share and aux_loss in one 32-token prefill
    chunk of a fresh row (on the trash page, outside the pool)."""
    bt = torch.full((1, eng.pool.pages_per_seq), eng.pool.trash,
                    dtype=torch.int64, device=eng.device)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, eng.cfg.vocab, (1, 32))).to(eng.device)
    _, _, st = eng._decode(eng.params, eng.pool.gather(bt), toks,
                           torch.tensor([31], device=eng.device))
    moe = st["blocks"]["moe"]
    return {k: [float(v) for v in moe[k].cpu()] for k in ("dropped",
                                                          "aux_loss")}


def zoo_serve(cfg, params, name, tier, reqs, smi, totals, profile=True,
              stagger=0, line="model_zoo_serve"):
    """One engine run (sub3 QTensor weights quantized by the Engine, the
    default MoRDotPolicy) with the counters zeroed just before the
    Engine is built and read just after the run, request i submitted at
    engine step ``stagger`` x i: every request done, one pack a weight
    matrix on the tile route, every QTensor GEMM on mixed_gemm (a
    one-shot prefill of M > 64 rows on the tc path, the rest on the
    stream path), every expert event on gam_quant, no selection and no
    plain call; bytes per token and recurrent state bytes per slot as
    computed; the recurrent families' one-shot prefill (with ``stagger``,
    admitted while other slots decode) and the host seconds inside its
    scans. The decode step's, each prefill chunk's and each one-shot
    prefill's ms, tokens/s and peak GB; with ``profile``, a profiled
    decode call with its ATen operators and launches."""
    from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
    from repro_torch.kernels.mixed_gemm import gemm_path
    from repro_torch.serve import Engine, ServeConfig
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    eng = Engine(cfg, MoRDotPolicy(), params,
                 ServeConfig(slots=4, max_seq=512, prefill_chunk=32, **tier),
                 quantize=MoRPolicy(recipe="sub3"), device=ZOO_DEV)
    recurrent = cfg.family in REC_FAMILIES
    check(eng.chunked_prefill != recurrent,
          f"{name}: chunked prefill {eng.chunked_prefill}")
    step_ms = {"decode": [], "prefill": [], "one_shot": []}
    one_shot_m, beside = [], []

    def timed(fn, key):
        def wrapper(*a):
            if key == "one_shot":
                beside.append(sum(s == "decode" for s in eng.slot_state))
                one_shot_m.append(len(a[1].prompt))
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            step_ms[key].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    eng._decode_batch = timed(eng._decode_batch, "decode")
    eng._prefill_chunk_step = timed(eng._prefill_chunk_step, "prefill")
    eng._full_prefill = timed(eng._full_prefill, "one_shot")
    scan = {"s": 0.0, "steps": 0}
    pending, steps = list(reqs), 0
    t0 = time.perf_counter()
    with scan_host_time(scan):
        while pending or eng.queue or any(eng.slot_req):
            while pending and steps >= stagger * (len(reqs) - len(pending)):
                eng.submit(pending.pop(0))
            eng.step()
            steps += 1
            check(steps < 5000, f"{name}: the engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes = tile_routes()
    launches, paths = totals.add_current(name)
    for r in reqs:
        check(r.done and r.error is None, f"{name} request {r.rid}: "
              f"{r.error}")
        check(len(r.out) == r.max_tokens
              and all(0 <= t < cfg.vocab for t in r.out),
              f"{name} request {r.rid}: tokens {r.out}")
    check(not eng.quarantined and not eng.rejected, f"{name}: quarantine")
    check(not stagger or any(beside),
          f"{name}: no admission while a slot decoded")
    calls = eng.prefill_chunks + len(one_shot_m) + eng.decode_steps
    n_q, experts = zoo_gemms(cfg)
    tc = n_q * sum(gemm_path(m) == "tc" for m in one_shot_m)
    check(launches["mixed_gemm"] == n_q * calls and paths["tc"] == tc
          and paths["stream"] == n_q * calls - tc,
          f"{name}: mixed_gemm {launches['mixed_gemm']} launches, paths "
          f"{paths}, want {n_q} x {calls} model calls ({tc} on tc)")
    check(launches["mor_select_pack"] == n_q
          and routes["mor_select_pack"]["tile"] == n_q,
          f"{name}: mor_select_pack {routes['mor_select_pack']}, want "
          f"{n_q} weight matrices on the tile route")
    check(launches["gam_quant"] == 2 * experts * calls
          and launches["mor_select_select"] == 0,
          f"{name}: gam_quant launched {launches['gam_quant']} times, "
          f"want 2 x {experts} expert mor_dots x {calls} calls; "
          f"selections {launches['mor_select_select']}, want 0")
    bpt, sbytes = eng.pool.bytes_per_token(), eng.pool.state_bytes_per_slot()
    want = rec_bytes(cfg) if recurrent else (
        zoo_bytes_per_token(cfg, tier), 0)
    check((bpt, sbytes) == want, f"{name}: bytes per token {bpt}, state "
          f"bytes per slot {sbytes}, want {want}")
    tokens = sum(len(r.out) for r in reqs)
    row = {"run": name, "arch": cfg.name, "layers": cfg.n_layers,
           **tier, "requests": len(reqs), "steps": steps,
           "stagger": stagger, "chunked_prefill": eng.chunked_prefill,
           "prefill_chunks": eng.prefill_chunks,
           "decode_steps": eng.decode_steps,
           "decode_step_ms": float(np.median(step_ms["decode"])),
           "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "bytes_per_token": bpt, "state_bytes_per_slot": sbytes,
           "weights": sorted(eng.qstats), "launches": launches,
           "mixed_gemm_paths": paths, "routes": routes, "card": smi}
    if step_ms["prefill"]:
        row["prefill_chunk_ms"] = float(np.median(step_ms["prefill"]))
    if one_shot_m:
        row.update(
            prefills=len(one_shot_m),
            admissions_beside_decoding=sum(b > 0 for b in beside),
            prefill_ms=dict(zip(map(str, one_shot_m), step_ms["one_shot"])),
            prefill_ms_per_token=float(np.median(
                [t / m for t, m in zip(step_ms["one_shot"], one_shot_m)])))
    if scan["steps"]:
        row.update(scan_host_s=scan["s"], scan_steps=scan["steps"],
                   scan_host_share_of_prefills=scan["s"] / (
                       sum(step_ms["one_shot"]) / 1e3))
    if profile:
        row["profile"] = profile_decode(eng)
        row["aten_ops_per_decode_call"] = dispatched_ops(eng)
        slots = eng.scfg.slots
        bt = torch.full((slots, eng.pool.pages_per_seq), eng.pool.trash,
                        dtype=torch.int64, device=eng.device)
        reset_counters()
        eng._step_fn(bt, np.zeros((slots, 1), np.int32),
                     np.zeros(slots, np.int32))
        torch.cuda.synchronize()
        row["launches_per_decode_call"] = read_counters()[0]
        row["gam_quant_routes_per_decode_call"] = tile_routes()["gam_quant"]
    if cfg.family == "moe":
        row["prefill_chunk_layer_stats"] = zoo_layer_stats(eng)
    out = [list(r.out) for r in reqs]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    emit({line: row})
    return row, out


def train_want(pols, dots):
    """{kernel: launches} of one training step under each of ``pols`` of
    ``dots`` mor_dots a step: each mor_dot's 2 forward events, run twice
    under the layer remat, and 3 backward events on gam_quant (the
    tensor recipe), the selection (sub3) or the pack (fused, with 4
    GEMMs a mor_dot)."""
    want = {}
    for pol in pols:
        if pol.fuse_gemm:
            step = {"mor_select_pack": dots * (2 * 2 + 3),
                    "mixed_gemm": dots * 4}
        elif pol.act.recipe == "tensor":
            step = {"gam_quant": dots * (2 * 2 + 3)}
        else:
            step = {"mor_select_select": dots * (2 * 2 + 3)}
        for kern, n in step.items():
            want[kern] = want.get(kern, 0) + n
    return want


def train_run(cfg, name, pol, steps, smi, totals, *, init, batch_fn, dots,
              line, on_step=None, ctx=None, profile=None):
    """``steps`` AdamW steps of make_train_step from ``init()``'s params on
    ``batch_fn(step)`` (``pol`` a policy, or a sequence of them: one step
    under each, on one state), the counters zeroed just before and read
    just after: finite loss and grad norm, grad norm > 0, every event
    (and, fused, every GEMM) on the kernels: ``dots`` mor_dots a step,
    each with 2 forward events run twice under the layer remat and 3
    backward events (on ``gam_quant`` under the tensor recipe, the
    selection under sub3, packs under the fused lowering), and 4 GEMMs
    under the fused lowering (``train_want``). ``on_step(step, params,
    metrics, row)`` adds a family's figures and checks to each step's
    row (emitted as ``line``), inside ``ctx`` (a context manager, such
    as a spy) around the steps. With ``profile`` (a kernel the profile
    must show), one more step on the last batch under the profiler,
    not counted. Returns (the run's figures, launches, GEMM paths, tile
    routes)."""
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    pols = tuple(pol) if isinstance(pol, (list, tuple)) else (pol,) * steps
    params = init()
    opt = init_opt_state(params)
    fns = {}
    for p in pols:
        if p not in fns:
            fns[p] = make_train_step(cfg, p, TrainConfig(
                optimizer=AdamWConfig(warmup_steps=1)))
    batches = [batch_fn(s) for s in range(len(pols))]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    reset_counters()
    with ctx or contextlib.nullcontext():
        for s, (p, batch) in enumerate(zip(pols, batches)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = fns[p](params, opt, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            row = {"run": name, "step": s, "step_ms": dt * 1e3,
                   "tokens_per_s": batch["labels"].numel() / dt,
                   **{k: float(m[k]) for k in (
                       "loss", "grad_norm", "fwd_frac_bf16", "bwd_frac_bf16",
                       "fwd_rel_err", "bwd_rel_err")},
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            if on_step:
                on_step(s, params, m, row)
            emit({line: row, "card": smi})
            check(np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])
                  and row["grad_norm"] > 0, f"{name} step {s}: {row}")
            rows.append(row)
    routes = tile_routes()
    launches, paths = totals.add_current(name)
    for kern, n in train_want(pols, dots).items():
        check(launches[kern] == n, f"{name}: {kern} launched "
              f"{launches[kern]} times, want {n} (every event)")
    steps = len(pols)
    res = {"arch": cfg.name, "layers": cfg.n_layers, "steps": rows,
           "step_ms_median": float(np.median([r["step_ms"] for r in rows])),
           "peak_mem_gb": max(r["peak_mem_gb"] for r in rows),
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "mixed_gemm_paths_per_step": {k: v / steps
                                         for k, v in paths.items()},
           "routes_per_step": {k: {r: n / steps for r, n in v.items()}
                               for k, v in routes.items()},
           "card": smi}
    if profile:
        res["profile"] = profile_train_step(fns[pols[-1]], params, opt,
                                            batches[-1], profile)
    del params, opt, fns, batches
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches, paths, routes


def zoo_train(cfg, name, pol, steps, smi, totals):
    """``train_run`` of an MoE model on 2 x 1024 SyntheticLM tokens: also
    finite aux_loss > 0, the total the loss plus 0.01 aux_loss as
    computed, the router bf16 after every step, and each step's dropped
    share (the forward's; the remat recompute repeats it). Each layer
    runs 2 attention mor_dots and, in each 256-token chunk, 2 an
    expert."""
    from repro_torch.models import blocks, init_params
    dropped = []
    moe_sublayer = blocks.moe_sublayer

    def spy(*a, **kw):
        y, st = moe_sublayer(*a, **kw)
        dropped.append(st["dropped"].detach())
        return y, st

    def on_step(s, params, m, row):
        row.update(aux_loss=float(m["aux_loss"]),
                   total_loss=float(m["total_loss"]),
                   dropped_mean_over_layers=float(torch.stack(
                       dropped[:cfg.n_units]).mean()))
        dropped.clear()
        check(np.isfinite(row["aux_loss"]) and row["aux_loss"] > 0,
              f"{name} step {s}: {row}")
        check(bool(m["total_loss"] == m["loss"] + 0.01 * m["aux_loss"]),
              f"{name} step {s}: total_loss != loss + 0.01 aux_loss")
        router = params["blocks"]["moe"]["moe"]["router"]
        check(router.dtype == torch.bfloat16,
              f"{name}: router {router.dtype} after step {s}")

    dots = cfg.n_units * (2 + TRAIN_SEQ // 256 * cfg.n_experts * 2)
    return train_run(
        cfg, name, pol, steps, smi, totals,
        init=lambda: init_params(cfg, seed=0, device=ZOO_DEV),
        batch_fn=lambda s: train_batch(cfg, s, TRAIN_BATCH, TRAIN_SEQ,
                                       ZOO_DEV), dots=dots,
        line="model_zoo_train_step", on_step=on_step,
        ctx=patched(blocks, "moe_sublayer", spy))[0]


def zoo_moe_layer(cfg, seed=3):
    """One MoE layer's weights at full width, drawn as init_params draws
    them."""
    gen = torch.Generator(device=ZOO_DEV)
    gen.manual_seed(seed)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    std = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)

    def normal(shape, s, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=ZOO_DEV) * s).to(
            dtype)
    return {"router": normal((d, E), 0.02, torch.float32),
            "w1": normal((E, d, 2 * f), 0.02), "w2": normal((E, f, d), std)}


def zoo_route_spy():
    """(context manager over blocks._route / blocks._slots, the record)."""
    from repro_torch.models import blocks
    seen = []
    slots = blocks._slots

    def spy(ids, E, C):
        out = slots(ids, E, C)
        seen.append((ids, *out[1:]))
        return out
    return patched(blocks, "_slots", spy), seen


def zoo_sublayer_run(p, x, g, pol, cfg):
    """moe_sublayer forward and one backward of sum(y * g) on fresh
    leaves: (routing record, y, stats, {grad name: grad})."""
    from repro_torch.core.linear import N_BWD_EVENTS
    from repro_torch.core.mor import STATS_WIDTH
    from repro_torch.models import blocks
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    xl = x.detach().clone().requires_grad_(True)
    tok = {k: torch.zeros((cfg.n_experts, N_BWD_EVENTS, STATS_WIDTH),
                          device=x.device, requires_grad=True)
           for k in ("w1", "w2")}
    ctx, seen = zoo_route_spy()
    with ctx:
        y, st = blocks.moe_sublayer(leaves, xl, tok, pol, cfg)
    (y.float() * g).sum().backward()
    torch.cuda.synchronize()
    grads = {"dx": xl.grad, **{f"d{k}": v.grad for k, v in leaves.items()},
             **{f"tok_{k}": v.grad for k, v in tok.items()}}
    return seen, y.detach(), {k: v.detach() for k, v in st.items()}, grads


def zoo_same(a, b, what, rel_lane=None):
    """a and b bit for bit; with ``rel_lane`` (a stats row's or a token
    gradient's relative-error lane) that lane within 1e-6 relative.
    Returns that lane's largest relative difference (0.0 without)."""
    if rel_lane is None:
        check(torch.equal(bits16(a), bits16(b)), f"{what} differs")
        return 0.0
    lanes = [i for i in range(a.shape[-1]) if i != rel_lane]
    check(torch.equal(bits16(a[..., lanes]), bits16(b[..., lanes])),
          f"{what} differs")
    r = float(((a[..., rel_lane] - b[..., rel_lane]).abs()
               / b[..., rel_lane].abs().clamp_min(1e-30)).max())
    check(r <= 1e-6, f"{what}: relative-error lane {r} apart")
    return r


def zoo_moe_parity(cfg, ops, ref, smi):
    """(d) moe_sublayer alone at full width, forward and one backward,
    kernel path against plain path (backend='torch') on the same CUDA
    tensors, under the tensor recipe, sub3 and fused sub3, on 2 x 1024
    (fused: the experts' GEMMs at M = B C = 160 on the tc path) and 4 x 1
    (C = 1: the stream path). Routing, slots, keep, aux_loss and dropped
    bit-identical; the tensor and sub3 outputs, stats rows and gradients
    (x, router, w1, w2, the stats tokens) too, but for the
    relative-error lane (gam_quant's f64 error sums: 1e-6 relative).
    Fused, the expert GEMMs sum in another order than the plain version,
    so: every expert GEMM of the kernel path held against the plain
    version on its packs (``gemm_tol``), and the kernel path bit for bit
    against a third path whose quantizers are the plain versions and
    whose GEMMs are the kernel (any pack, slab offset or stats lane of
    the stacked quantizers that differs shows there); its distance from
    the plain path is reported."""
    from repro_torch.core.mor import STAT_REL_ERR
    from repro_torch.core.policy import paper_default
    p = zoo_moe_layer(cfg)
    rng = np.random.default_rng(6)
    pols = {"tensor": paper_default("tensor"), "sub3": paper_default("sub3"),
            "sub3_fused": paper_default("sub3").replace(fuse_gemm=True)}
    res = []
    for shape in ((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model),
                  (4, 1, cfg.d_model)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(ZOO_DEV).to(torch.bfloat16)
        g = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(ZOO_DEV)
        for recipe, pol in pols.items():
            what = f"moe_sublayer {recipe} {tuple(shape)}"
            gemms = {}
            with patched(ops, "mixed_gemm", checked_gemm(ops, ref,
                                                             gemms)):
                kern = zoo_sublayer_run(p, x, g, with_backend(pol, "auto"),
                                        cfg)
            plain = zoo_sublayer_run(p, x, g, with_backend(pol, "torch"),
                                     cfg)
            (rk, yk, sk, gk), (rp, yp, sp, gp) = kern, plain
            check(len(rk) == len(rp) and all(
                all(torch.equal(a, b) for a, b in zip(u, v))
                for u, v in zip(rk, rp)), f"{what}: routing differs")
            for k in ("aux_loss", "dropped"):
                zoo_same(sk[k], sp[k], f"{what}: {k}")
            row = {"recipe": recipe, "shape": list(shape), "chunks": len(rk),
                   "dropped": float(sk["dropped"]),
                   "aux_loss": float(sk["aux_loss"]), "card": smi}
            if not pol.fuse_gemm:
                check(not gemms, f"{what}: a mixed GEMM ran unfused")
                rel = [zoo_same(yk, yp, f"{what}: output")]
                rel += [zoo_same(sk[k], sp[k], f"{what}: {k} stats rows",
                                 STAT_REL_ERR) for k in ("w1", "w2")]
                for k in gk:
                    rel.append(zoo_same(gk[k], gp[k], f"{what}: {k}",
                                        STAT_REL_ERR if k.startswith("tok")
                                        else None))
                row.update(bit_identical=True, rel_err_lane_max_rel_diff=max(
                    rel))
                res.append(row)
                continue
            # 2 x 1024: every expert GEMM at M = B C = 160 or d (tc);
            # 4 x 1: the forward and dgrad at M = 4 (stream).
            fwd_path = "tc" if shape[1] > 1 else "stream"
            check(any(k[3] == fwd_path for k in gemms),
                  f"{what}: no expert GEMM on the {fwd_path} path: "
                  f"{sorted(gemms)}")
            # The experts' first events quantize the same dispatched
            # tokens and weights on both paths.
            rel = [zoo_same(sk["w1"], sp["w1"], f"{what}: w1 stats rows",
                            STAT_REL_ERR)]
            orig = ops.mixed_gemm

            def kernel_gemm(a, b, *, out_dtype=torch.bfloat16,
                            backend="auto", tile=None):
                return orig(a, b, out_dtype=out_dtype, backend="cuda")
            with patched(ops, "mixed_gemm", kernel_gemm):
                rh, yh, sh, gh = zoo_sublayer_run(
                    p, x, g, with_backend(pol, "torch"), cfg)
            rel.append(zoo_same(yk, yh, f"{what}: output vs plain "
                                "quantizers + kernel GEMMs"))
            rel += [zoo_same(sk[k], sh[k], f"{what}: {k} stats rows vs plain "
                             "quantizers + kernel GEMMs", STAT_REL_ERR)
                    for k in ("w1", "w2")]
            for k in gk:
                rel.append(zoo_same(gk[k], gh[k], f"{what}: {k} vs plain "
                                    "quantizers + kernel GEMMs",
                                    STAT_REL_ERR if k.startswith("tok")
                                    else None))
            far = {k: {"max_abs_diff": float((gk[k].float()
                                              - gp[k].float()).abs().max()),
                       "max_abs": float(gp[k].float().abs().max()),
                       "differ_share": float((gk[k] != gp[k]).float().mean())}
                   for k in ("dx", "drouter", "dw1", "dw2")}
            far["y"] = {"max_abs_diff": float((yk.float()
                                               - yp.float()).abs().max()),
                        "max_abs": float(yp.float().abs().max()),
                        "differ_share": float((yk != yp).float().mean())}
            row.update(
                bit_identical_to_plain_quantizers_kernel_gemms=True,
                rel_err_lane_max_rel_diff=max(rel), kernel_vs_plain=far,
                expert_gemms=[{"M": k[0], "N": k[1], "K": k[2],
                               "path": k[3], **v}
                              for k, v in sorted(gemms.items())])
            res.append(row)
    return res


def zoo_expert_loop(cfg, smi, reps=5):
    """One granite layer's expert GEMMs at the decode shape (4 slots, C =
    1: x (E, 4, d) against w1, h (E, 4, f) against w2) under the engine's
    policy, on the kernels, two ways: one ``mor_dot_experts`` a GEMM (the
    expert stack) and a loop of E ``mor_dot`` calls (each a stack of
    one: the loop the stack replaced): wall ms a layer, the median of
    ``reps`` with the card synchronised, and the largest difference of
    their values (the stack multiplies with a batched GEMM)."""
    from repro_torch.core.linear import mor_dot, mor_dot_experts
    from repro_torch.core.policy import MoRDotPolicy
    p = zoo_moe_layer(cfg)
    E = cfg.n_experts
    gen = torch.Generator(device=ZOO_DEV)
    gen.manual_seed(7)
    x = torch.randn((E, 4, cfg.d_model), generator=gen,
                    device=ZOO_DEV).to(torch.bfloat16)
    h = torch.randn((E, 4, cfg.d_ff), generator=gen,
                    device=ZOO_DEV).to(torch.bfloat16)
    pol = MoRDotPolicy()

    def stack():
        return [mor_dot_experts(a, p[w], None, pol)[0]
                for a, w in ((x, "w1"), (h, "w2"))]

    def loop():
        return [torch.stack([mor_dot(a[e], p[w][e], None, pol)[0]
                             for e in range(E)])
                for a, w in ((x, "w1"), (h, "w2"))]
    ms, outs = {}, {}
    with torch.no_grad():
        for name, fn in (("stack", stack), ("loop", loop)):
            fn()
            ts = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[name] = fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            ms[name] = float(np.median(ts))
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(outs["stack"], outs["loop"]))
    check(np.isfinite(diff), f"expert loop: values {diff} apart")
    return {"experts": E, "tokens_per_expert": 4, "layer_ms": ms,
            "decode_call_ms_at_depth": {k: v * cfg.n_units
                                        for k, v in ms.items()},
            "stack_vs_loop_max_abs_diff": diff, "card": smi}


def zoo_quant_spy(ops, seen):
    """``ops.quant_err`` that records (x, group amax, y) of every call."""
    orig = ops.quant_err

    def quant_err(x, *a, **kw):
        q = orig(x, *a, **kw)
        seen.append((x, q.group_amax, q.y))
        return q
    return quant_err


def zoo_flips(qk, qp):
    """The expert stacks of two runs' ``quant_err`` calls (in call order;
    under the engine's policy a model call makes 4 a layer: w1's tokens,
    w1, w2's hidden rows, w2) whose input differs: how many elements of
    the input and of the E4M3 output differ, and whether the group amax
    (hence every scale of the stack's expert) moved."""
    rows = []
    for i, ((xk, ak, yk), (xp, ap, yp)) in enumerate(zip(qk, qp)):
        for e in range(xk.shape[0]):
            dx = int((xk[e] != xp[e]).sum())
            if not dx:
                continue
            xd = (xk[e].float() - xp[e].float()).abs().max()
            yd = (yk[e].float() - yp[e].float()).abs().max()
            rows.append({"call": i, "expert": e, "elements": xk[e].numel(),
                         "amax": float(ap[e]), "x_differ": dx,
                         "x_max_abs_diff": float(xd),
                         "amax_equal": bool(ak[e] == ap[e]),
                         "y_differ": int((yk[e] != yp[e]).sum()),
                         "y_max_abs_diff": float(yd)})
    return rows


def zoo_depth2(cfg, ops, ref, smi):
    """(d) phase_depth2's check on granite at full width and depth 2: a
    prefill chunk (4 x 8 tokens) and a decode step three ways
    (``depth2_three_ways``; the f64 path sums the expert products in f64
    too). With the experts' activation events off, the 2x rule holds.
    Under the engine's policy it does not (a settled divergence, ROADMAP
    Queue 3): an expert buffer's tokens come from the attention's mixed
    GEMMs, whose kernel sums in another order than the plain version,
    and where a bf16 ulp of that moves an expert stack's input the tensor
    recipe's E4M3 rounding of the stack moves by up to its own ulp (2^-3
    relative), which the logits carry. There the gate is that the gap
    closes: the kernel path fed the plain version's GEMM outputs (its
    quantizer kernels unchanged) is the plain path bit for bit; the
    flipped stacks (``zoo_flips``) and the ratio are reported. The
    router is scaled by 10 so that its top-8 margins stand well above
    the noise; the share of routing decisions on which the kernel and
    plain paths agree is reported."""
    from repro_torch.core import linear
    from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
    from repro_torch.models import init_cache, init_params, make_decode_fn
    from repro_torch.serve.quantized import quantize_params
    cfg = dataclasses.replace(cfg, n_layers=2)
    params = init_params(cfg, seed=1, device=ZOO_DEV)
    params["blocks"]["moe"]["moe"]["router"] *= 10.0
    params, _ = quantize_params(params, MoRPolicy(recipe="sub3"))
    rng = np.random.default_rng(1)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8))).to(ZOO_DEV)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1))).to(ZOO_DEV)

    def f64_dot(a, b_t, out_dtype):
        return (a.double() @ b_t.double().mT).float().to(out_dtype)

    def runner(act, routes, quants):
        def run(backend, way):
            p = MoRPolicy(backend=backend)
            fn = make_decode_fn(cfg, MoRDotPolicy(
                act=p.replace(recipe=act), weight=p, grad=p))
            cache = init_cache(cfg, 4, 64, device=ZOO_DEV)
            ctx, routes[way] = zoo_route_spy()
            with contextlib.ExitStack() as stack:
                stack.enter_context(ctx)
                if way in quants:
                    stack.enter_context(patched(
                        ops, "quant_err", zoo_quant_spy(ops, quants[way])))
                if way == "f64":
                    stack.enter_context(patched(linear, "_dot", f64_dot))
                l1, cache, _ = fn(params, cache, chunk,
                                  torch.full((4,), 7, device=ZOO_DEV))
                l2, cache, _ = fn(params, cache, tok,
                                  torch.full((4,), 8, device=ZOO_DEV))
            return l1[..., :cfg.vocab], l2[..., :cfg.vocab]
        return run

    res = {"card": smi}
    for act, gated in (("off", True), ("tensor", False)):
        routes, quants = {}, {"kernel": [], "plain": []}
        r_act, _ = depth2_three_ways(
            runner(act, routes, quants), ops, ref,
            f"zoo depth-2 (expert act {act})",
            ("prefill_chunk", "decode_step"), gate=gated)
        agree = n = 0
        for a, b in zip(routes["kernel"], routes["plain"]):
            agree += int((a[0] == b[0]).sum())
            n += a[0].numel()
        r_act.update(gated_2x=gated, routing_agreement_kernel_plain=agree / n,
                     routing_decisions=n)
        if act != "off":
            flips = zoo_flips(quants["kernel"], quants["plain"])
            r_act["stacks_moved"] = {
                "quant_err_calls": len(quants["kernel"]),
                "stacks_with_input_moved": len(flips),
                "of_which_amax_moved": sum(not f["amax_equal"]
                                           for f in flips),
                "of_which_output_moved": sum(f["y_differ"] > 0
                                             for f in flips),
                "outputs_moved": sum(f["y_differ"] for f in flips),
                "first": flips[:8]}
        res[f"expert_act_{act}"] = r_act
    del params
    return res


def phase_model_zoo(ops, ref, smi, cfgs=None):
    """The MoE family and gemma-2b, serving and training (module
    docstring, item 12). ``cfgs``: {arch: config} overrides (a CPU
    rehearsal passes reduced ones). Returns (the model_zoo line, the
    Totals of its main-path runs)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_default
    from repro_torch.models import init_params
    t_phase = time.perf_counter()
    cfgs = cfgs or {}
    granite, gemma, moonshot = (cfgs.get(a) or get_config(a)
                                for a in ZOO_ARCHS)
    if "moonshot-v1-16b-a3b" not in cfgs:
        moonshot = dataclasses.replace(moonshot, n_layers=MOONSHOT_LAYERS)
    if "gemma-2b" not in cfgs:
        gemma = dataclasses.replace(gemma, n_layers=GEMMA_LAYERS)
    totals = Totals()
    res = {"card": smi}
    res["moe_sublayer_parity"] = zoo_moe_parity(granite, ops, ref, smi)
    res["expert_loop"] = zoo_expert_loop(granite, smi)
    if "granite-moe-1b-a400m" not in cfgs:
        granite = dataclasses.replace(granite, n_layers=GRANITE_LAYERS)
    serve = {}
    params = init_params(granite, seed=0, device=ZOO_DEV)
    ref_out = None
    for tier_name, tier in (("bf16", {}), ("kv_mor", {"kv_mor": True})):
        row, out = zoo_serve(granite, params, f"granite_{tier_name}", tier,
                             zoo_requests(granite.vocab), smi, totals,
                             profile=(tier_name == "bf16"))
        if ref_out is not None:
            row["tokens_equal_to_bf16"] = float(np.mean(
                [a == b for x, y in zip(out, ref_out) for a, b in zip(x, y)]))
        ref_out = out
        serve[row["run"]] = row
    del params
    res["train"] = {}
    for name, pol in (("granite_sub3", paper_default("sub3")),
                      ("granite_sub3_fused",
                       paper_default("sub3").replace(fuse_gemm=True))):
        res["train"][name] = zoo_train(granite, name, pol, ZOO_TRAIN_STEPS,
                                       smi, totals)
    params = init_params(gemma, seed=0, device=ZOO_DEV)
    for tier_name, tier in (("bf16", {}), ("kv_mor", {"kv_mor": True})):
        row, _ = zoo_serve(gemma, params, f"gemma_{tier_name}", tier,
                           zoo_requests(gemma.vocab), smi, totals,
                           profile=(tier_name == "bf16"))
        serve[row["run"]] = row
    del params
    params = init_params(moonshot, seed=0, device=ZOO_DEV)
    row, _ = zoo_serve(moonshot, params, "moonshot_bf16", {},
                       zoo_requests(moonshot.vocab, 4), smi, totals)
    serve[row["run"]] = row
    del params
    res["serve"] = serve
    res["train"]["moonshot_sub3"] = zoo_train(
        moonshot, "moonshot_sub3", paper_default("sub3"), 1, smi, totals)
    res["depth2"] = zoo_depth2(granite, ops, ref, smi)
    res["config"] = {c.name: {"layers": c.n_units, "d_model": c.d_model,
                              "n_experts": c.n_experts, "top_k": c.top_k,
                              "d_ff": c.d_ff, "vocab": c.vocab,
                              "params": c.param_count(),
                              "active_params": c.active_param_count()}
                     for c in (granite, gemma, moonshot)}
    res["launches"] = totals.launches
    res["phase_s"] = time.perf_counter() - t_phase
    return res, totals


FRONT_DEV = "cuda"
FRONT_ARCHS = ("paligemma-3b", "whisper-tiny")
FRONT_TRAIN_STEPS = 3
# Depth of the engine-free serving runs (quantize, prefill, decode; for
# whisper the ragged-GEMM parity too), by arch: paligemma-3b's at 6 of
# its 18 layers (every check holds at any depth, and the runs' time is
# per layer).
FRONT_SERVE_LAYERS = {"paligemma-3b": 6}
# Depth of the training runs (sub3 and fused sub3), by arch:
# paligemma-3b's at 6 of its 18 layers, since multi_device's checks (d)
# and (e) needed the room (every check of a run holds at any depth, and
# its time is per layer; the depth-2 checks are unchanged).
FRONT_TRAIN_LAYERS = {"paligemma-3b": 6}
# paligemma-3b: 4 requests, each 256 stub patches and a 128-token prompt,
# then 32 decode steps; training on 2 x (256 + 1024) positions.
PALI_SERVE = {"batch": 4, "prompt": 128, "steps": 32}
PALI_TRAIN = {"batch": 2, "seq": 1024}
# whisper-tiny: 8 requests of 1500 stub frames and a 32-token prompt, 64
# decode steps; training on 8 x 1500 frames by 448 text tokens.
WHISPER_SERVE = {"batch": 8, "prompt": 32, "steps": 64}
WHISPER_TRAIN = {"batch": 8, "seq": 448}


def front_embeds(shape, seed):
    """Stub frontend embeddings (patches / frames) ~ N(0, 1) in bf16 from
    a seeded generator on the card."""
    g = torch.Generator(device=FRONT_DEV)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=FRONT_DEV).to(
        torch.bfloat16)


def front_params(cfg, seed=0):
    """init_params on the card; for a layer-norm model (whisper) the norm
    scales 1 + N(0, 0.1) and biases N(0, 0.1) from a seeded generator:
    the reference's init zeroes both, which zeroes every normed stream
    (and would leave the GEMMs all-zero blocks)."""
    from repro_torch.models import init_params
    params = init_params(cfg, seed=seed, device=FRONT_DEV)
    if cfg.norm == "ln":
        g = torch.Generator(device=FRONT_DEV)
        g.manual_seed(seed + 100)

        def walk(tree, name):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, k)
                elif name.startswith("ln") or name.endswith("norm"):
                    r = torch.randn(v.shape, generator=g, device=FRONT_DEV)
                    v.copy_(0.1 * r + (1.0 if k == "scale" else 0.0))
        walk(params, "")
    return params


def front_gemms(cfg, mode):
    """The mixed GEMMs of one model call: 4 a dense layer, 7 a whisper
    decoder layer (6 in decode, which reads the cross K/V from the
    cache), 4 an encoder layer (prefill only); the tied heads are not
    quantized."""
    if cfg.family == "audio":
        dec = 6 if mode == "decode" else 7
        return dec * cfg.n_units + (4 * cfg.enc_layers
                                    if mode != "decode" else 0)
    return 4 * cfg.n_units


def front_prompt(cfg, run, seed):
    """The prefill batch of a serving run: tokens and the frontend's
    embeddings."""
    rng = np.random.default_rng(seed)
    B = run["batch"]
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, run["prompt"]))).to(FRONT_DEV)}
    if cfg.family == "vlm":
        batch["patches"] = front_embeds((B, cfg.img_tokens, cfg.d_model),
                                        seed)
    else:
        batch["frames"] = front_embeds((B, cfg.enc_seq, cfg.d_model), seed)
    return batch


def front_cache(cfg, pc, T, tier):
    """A decode cache of T positions holding a prefill cache ``pc``: the
    bf16 lanes copied, or under kv_mor each layer's K/V quantized by
    ``quantize_kv_mor`` (as the engine's splice does); whisper's cross
    K/V copied whole."""
    from repro_torch.models import init_cache
    from repro_torch.models.attention import quantize_kv_mor
    t = next(iter(pc))
    B, P = pc[t]["k"].shape[1:3]
    cache = init_cache(cfg, B, T, device=FRONT_DEV, **tier)
    c = cache[t]
    for name in ("k", "v"):
        if tier.get("kv_mor"):
            for l in range(cfg.n_units):
                lanes = quantize_kv_mor(pc[t][name][l])
                for suf, lane in zip(("", "_tags", "_scale"), lanes):
                    c[name + suf][l, :, :P] = lane
        else:
            c[name][:, :, :P] = pc[t][name]
    for name in ("xk", "xv"):
        if name in c:
            c[name].copy_(pc[t][name])
    return cache


def front_bytes_per_token(cache):
    """Bytes a cached position holds over every layer (the self-attention
    lanes; whisper's cross K/V are per request, not per token)."""
    c = next(iter(cache.values()))
    return sum(v.shape[0] * v.element_size() * int(np.prod(v.shape[3:]))
               for k, v in c.items() if not k.startswith("x"))


def gemm_m_spy(ops, seen):
    """``ops.mixed_dot`` that records (M, N, K) of every call."""
    orig = ops.mixed_dot

    def dot(x2, mo, **kw):
        seen.append((x2.shape[0], mo.shape[0], x2.shape[1]))
        return orig(x2, mo, **kw)
    return dot


def front_quantize(cfg, params, name, totals):
    """quantize_params (sub3) with the counters zeroed just before: one
    mor_select_pack launch a weight matrix, all on the tile route."""
    from repro_torch.core.policy import MoRPolicy
    from repro_torch.serve.quantized import param_bytes, quantize_params
    reset_counters()
    t0 = time.perf_counter()
    qparams, stats = quantize_params(params, MoRPolicy(recipe="sub3"))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    routes = tile_routes()
    launches, _ = totals.add_current(name)
    n_w = front_gemms(cfg, "prefill")
    check(launches["mor_select_pack"] == n_w
          and routes["mor_select_pack"]["tile"] == n_w,
          f"{name}: mor_select_pack {routes['mor_select_pack']}, want "
          f"{n_w} weight matrices on the tile route")
    return qparams, {"quantize_s": dt, "weights": len(stats),
                     "weight_matrices": n_w,
                     "param_bytes": param_bytes(qparams)}


def front_serve(cfg, qparams, name, tier, run, smi, totals, ops):
    """make_prefill_fn on the run's requests, the cache into a decode
    cache (``front_cache``), then ``run['steps']`` greedy make_decode_fn
    steps at each row's position, the counters zeroed just before and
    read just after (after one untimed prefill, so that the timed one
    does not pay the first call's set-up): every GEMM on mixed_gemm (M >
    64 on the tc path, the rest on the stream path), no plain call,
    finite logits, bytes per token as computed."""
    from repro_torch.core.policy import MoRDotPolicy
    from repro_torch.models import make_decode_fn, make_prefill_fn
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch = front_prompt(cfg, run, seed=1)
    B, S, steps = run["batch"], run["prompt"], run["steps"]
    P = S + (cfg.img_tokens if cfg.family == "vlm" else 0)
    prefill = make_prefill_fn(cfg, MoRDotPolicy())
    decode = make_decode_fn(cfg, MoRDotPolicy())
    seen, step_ms, out = [], [], []
    prefill(qparams, batch)
    reset_counters()
    with patched(ops, "mixed_dot", gemm_m_spy(ops, seen)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, pc, _ = prefill(qparams, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        n_prefill = len(seen)
        finite = bool(torch.isfinite(logits[..., :cfg.vocab]).all())
        cache = front_cache(cfg, pc, P + steps, tier)
        del pc
        tok = logits[:, -1:, :cfg.vocab].argmax(-1)
        for i in range(steps):
            cur = torch.full((B,), P + i, device=FRONT_DEV)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache, _ = decode(qparams, cache, tok, cur)
            tok = logits[:, -1:, :cfg.vocab].argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            finite = finite and bool(torch.isfinite(
                logits[..., :cfg.vocab]).all())
            out.append(tok)
    routes = tile_routes()
    launches, paths = totals.add_current(name)
    want_p, want_d = front_gemms(cfg, "prefill"), front_gemms(cfg, "decode")
    check(finite, f"{name}: nonfinite logits")
    check(n_prefill == want_p and len(seen) == want_p + steps * want_d,
          f"{name}: {len(seen)} mixed GEMMs ({n_prefill} in the prefill), "
          f"want {want_p} + {steps} x {want_d}")
    big = sum(m > 64 for m, _, _ in seen)
    check(launches["mixed_gemm"] == len(seen) and paths["tc"] == big
          and paths["stream"] == len(seen) - big,
          f"{name}: mixed_gemm {launches['mixed_gemm']} launches, paths "
          f"{paths}, want {big} on tc (M > 64) of {len(seen)}")
    check(not any(launches[k] for k in ("gam_quant", "mor_select_pack",
                                        "mor_select_select")),
          f"{name}: quantizer launches in serving: {launches}")
    bpt = front_bytes_per_token(cache)
    check(bpt == zoo_bytes_per_token(cfg, tier),
          f"{name}: bytes_per_token {bpt}")
    decode_s = sum(step_ms) / 1e3
    shapes = sorted({(m, n, k) for m, n, k in seen})
    row = {"run": name, "arch": cfg.name, "layers": cfg.n_units, **tier,
           "requests": B, "prompt": S, "cached_prefill_positions": P,
           "prefill_rows": B * P, "prefill_ms": prefill_ms,
           "decode_steps": steps,
           "decode_step_ms": float(np.median(step_ms)),
           "decode_step_ms_first": step_ms[0],
           "tokens_per_s": B * steps / decode_s,
           "prefill_tokens_per_s": B * P / (prefill_ms / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "bytes_per_token": bpt, "launches": launches,
           "mixed_gemm_paths": paths, "routes": routes,
           "gemm_shapes_mnk": shapes, "card": smi}
    if cfg.family == "audio":
        xk = cache["wdec"]["xk"]
        row["cross_kv_bytes_per_request"] = 2 * xk[:, 0].numel() * \
            xk.element_size()
    del cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    emit({"frontends_serve": row})
    return row, torch.cat(out, dim=1)


def front_train_batch(cfg, run, step):
    """SyntheticLM tokens and labels with the frontend's embeddings."""
    batch = train_batch(cfg, step, run["batch"], run["seq"], FRONT_DEV)
    shape = ((run["batch"], cfg.img_tokens, cfg.d_model)
             if cfg.family == "vlm" else
             (run["batch"], cfg.enc_seq, cfg.d_model))
    batch["patches" if cfg.family == "vlm" else "frames"] = front_embeds(
        shape, 10 + step)
    return batch


def front_train(cfg, name, pol, run, smi, totals):
    """``train_run`` of a frontend family (``tokens_per_s``: the text
    tokens), all on the tile route and the tc path; the encoder's layers
    run under the layer remat too."""
    res, launches, paths, routes = train_run(
        cfg, name, pol, FRONT_TRAIN_STEPS, smi, totals,
        init=lambda: front_params(cfg),
        batch_fn=lambda s: front_train_batch(cfg, run, s),
        dots=front_gemms(cfg, "train"), line="frontends_train_step")
    check_tile_route(routes, launches, name)
    check(paths["tc"] == launches["mixed_gemm"],
          f"{name}: fused GEMMs off the tc path: {paths}")
    return res


def front_train_depth2(cfg, run, ops, ref, smi):
    """``train_depth2`` on a frontend family at full width and depth 2
    (whisper: 2 encoder layers too) on the main path's batch (paligemma:
    2 x (256 + 1024) positions; whisper: 8 x 1500 frames by 448 tokens),
    under sub3 and fused sub3: whisper's encoder GEMMs and xkv at M =
    12000 (93.75 blocks of 128), their wgrads contracting over those
    ragged rows."""
    cfg = front_depth2_cfg(cfg)
    params = front_params(cfg, seed=1)
    batch = front_train_batch(cfg, run, 0)
    B = run["batch"]
    M = B * (run["seq"] + (cfg.img_tokens if cfg.family == "vlm" else 0))
    want = fused_gemm_shapes(params["blocks"], M, B * cfg.enc_seq)
    if cfg.family == "audio":
        want |= fused_gemm_shapes(params["enc"]["blocks"], B * cfg.enc_seq)
    res = train_depth2(cfg, ops, ref, params, batch, ("sub3",), want,
                       front_gemms(cfg, "train"), f"{cfg.name} train depth-2")
    res.update(positions=M, card=smi)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def front_ragged_parity(cfg, qparams, ops, ref, smi):
    """Every GEMM of a full-width, full-depth whisper prefill (8 x 1500
    frames: the encoder's and the cross K/V's M = 12000 rows, 93.75
    blocks of 128) held against the plain version on its real inputs at
    ``gemm_tol`` (``checked_dot``), each on the path its M selects."""
    from repro_torch.core.policy import MoRDotPolicy
    from repro_torch.kernels.mixed_gemm import gemm_path
    from repro_torch.models import make_prefill_fn
    batch = front_prompt(cfg, WHISPER_SERVE, seed=1)
    gemms = {}
    reset_counters()
    with patched(ops, "mixed_dot", checked_dot(ops, ref, gemms)):
        make_prefill_fn(cfg, MoRDotPolicy())(qparams, batch)
    torch.cuda.synchronize()
    paths = gemm_paths()
    calls = sum(v["calls"] for v in gemms.values())
    big = sum(v["calls"] for k, v in gemms.items() if k[0] > 64)
    check(paths["tc"] == big and paths["stream"] == calls - big,
          f"whisper ragged parity: paths {paths}, want {big} tc of {calls}")
    M = WHISPER_SERVE["batch"] * cfg.enc_seq
    at_m = sum(v["calls"] for k, v in gemms.items() if k[0] == M)
    check(at_m == 4 * cfg.enc_layers + cfg.n_units and gemm_path(M) == "tc",
          f"whisper ragged parity: {at_m} GEMMs at M = {M} (the encoder's "
          f"and the cross K/V's): {sorted(gemms)}")
    return {"M": M, "M_blocks_of_128": M / 128, "paths": paths,
            "gemms": [{"M": k[0], "N": k[1], "K": k[2], "out": k[3], **v}
                      for k, v in sorted(gemms.items())], "card": smi}


def front_refusal(cfg):
    """The audio family refuses the quantized KV tiers by name, as
    cache_specs, init_cache and a decode call on such a cache."""
    from repro_torch.core.policy import MoRDotPolicy
    from repro_torch.models import cache_specs, init_cache, make_decode_fn
    out = {}
    for tier in ("kv_fp8", "kv_mor"):
        msgs = []
        for call in (lambda: cache_specs(cfg, 1, 8, **{tier: True}),
                     lambda: init_cache(cfg, 1, 8, device=FRONT_DEV,
                                        **{tier: True})):
            try:
                call()
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        # A bf16 cache given the tier's lanes (the decode refusal keys on
        # them: k_scale, and k_tags beside it for kv_mor).
        cache = init_cache(cfg, 1, 8, device=FRONT_DEV)
        c = cache["wdec"]
        c["k_scale"] = torch.zeros(c["k"].shape[:-1], device=FRONT_DEV)
        if tier == "kv_mor":
            c["k_tags"] = torch.zeros(c["k"].shape[:-1], dtype=torch.uint8,
                                      device=FRONT_DEV)
        try:
            make_decode_fn(cfg, MoRDotPolicy())(
                {}, cache, torch.zeros((1, 1), dtype=torch.int64,
                                       device=FRONT_DEV),
                torch.zeros(1, dtype=torch.int64, device=FRONT_DEV))
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
        check(all(m and "'audio'" in m and "_wdec_block" in m and tier in m
                  for m in msgs), f"whisper {tier}: not refused by name: "
              f"{msgs}")
        out[tier] = msgs[0]
    return out


def front_depth2_cfg(cfg):
    """``cfg`` at depth 2 (whisper: 2 encoder layers too)."""
    over = {"n_layers": 2}
    if cfg.family == "audio":
        over["enc_layers"] = 2
    return dataclasses.replace(cfg, **over)


def front_depth2(cfg, run, ops, ref, smi):
    """phase_depth2's check on a frontend family at full width and depth
    2: a make_prefill_fn call on 4 requests of the main path's prompt
    (paligemma: 256 patches + 128 tokens; whisper: 1500 frames + 32
    tokens, the encoder's GEMMs at M = 6000, ragged) and a decode step
    from its cache, three ways (``depth2_three_ways``)."""
    from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
    from repro_torch.models import make_decode_fn, make_prefill_fn
    from repro_torch.serve.quantized import quantize_params
    cfg = front_depth2_cfg(cfg)
    params, _ = quantize_params(front_params(cfg, seed=1),
                                MoRPolicy(recipe="sub3"))
    batch = front_prompt(cfg, {"batch": 4, "prompt": run["prompt"]}, seed=2)
    P = run["prompt"] + (cfg.img_tokens if cfg.family == "vlm" else 0)
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 1))).to(FRONT_DEV)

    def run_path(backend, _way):
        pol = MoRDotPolicy(weight=MoRPolicy(backend=backend))
        l1, pc, _ = make_prefill_fn(cfg, pol)(params, batch)
        cache = front_cache(cfg, pc, P + 8, {})
        l2, _, _ = make_decode_fn(cfg, pol)(
            params, cache, tok, torch.full((4,), P, device=FRONT_DEV))
        return l1[..., :cfg.vocab], l2[..., :cfg.vocab]

    res, gemms = depth2_three_ways(run_path, ops, ref,
                                   f"{cfg.name} depth-2",
                                   ("prefill", "decode_step"))
    if cfg.family == "audio":
        M = 4 * cfg.enc_seq
        at_m = sum(v["calls"] for k, v in gemms.items() if k[0] == M)
        check(at_m == 4 * cfg.enc_layers + cfg.n_units,
              f"{cfg.name} depth-2: {at_m} GEMMs at M = {M}: "
              f"{sorted(gemms)}")
    res.update(prompt=run["prompt"], cached_prefill_positions=P, card=smi)
    del params
    return res


def phase_frontends(ops, ref, smi, cfgs=None):
    """The frontend families, serving and training (module docstring,
    item 13). ``cfgs``: {arch: config} overrides (a CPU rehearsal passes
    reduced ones). Returns (the frontends line, the Totals of its
    main-path runs)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import paper_default
    t_phase = time.perf_counter()
    cfgs = cfgs or {}
    pali, whisper = (cfgs.get(a) or get_config(a) for a in FRONT_ARCHS)
    totals = Totals()
    res = {"card": smi}
    policies = (("sub3", paper_default("sub3")),
                ("sub3_fused", paper_default("sub3").replace(
                    fuse_gemm=True)))
    for cfg, serve_run, train_run, tiers in (
            (pali, PALI_SERVE, PALI_TRAIN,
             (("bf16", {}), ("kv_mor", {"kv_mor": True}))),
            (whisper, WHISPER_SERVE, WHISPER_TRAIN, (("bf16", {}),))):
        key = cfg.name.split("-")[0]
        r = res[key] = {"serve": {}, "train": {}}
        t0 = time.perf_counter()
        scfg = dataclasses.replace(cfg, n_layers=FRONT_SERVE_LAYERS.get(
            cfg.name, cfg.n_layers))
        r["serve_layers"] = scfg.n_layers
        params = front_params(scfg)
        qparams, r["quantize"] = front_quantize(scfg, params,
                                                f"{key}_quantize", totals)
        del params
        ref_out = None
        for tier_name, tier in tiers:
            row, out = front_serve(scfg, qparams, f"{key}_{tier_name}", tier,
                                   serve_run, smi, totals, ops)
            if ref_out is not None:
                row["tokens_equal_to_bf16"] = float(
                    (out == ref_out).float().mean())
            ref_out = out
            r["serve"][row["run"]] = row
        if cfg.family == "audio":
            r["ragged_parity"] = front_ragged_parity(scfg, qparams, ops, ref,
                                                     smi)
            r["kv_tier_refusal"] = front_refusal(scfg)
        del qparams
        tcfg = dataclasses.replace(cfg, n_layers=FRONT_TRAIN_LAYERS.get(
            cfg.name, cfg.n_layers))
        r["train_layers"] = tcfg.n_layers
        for name, pol in policies:
            r["train"][name] = front_train(tcfg, f"{key}_{name}", pol,
                                           train_run, smi, totals)
        r["depth2"] = front_depth2(cfg, serve_run, ops, ref, smi)
        r["train_depth2"] = front_train_depth2(cfg, train_run, ops,
                                               ref, smi)
        r["config"] = {"layers": cfg.n_units, "enc_layers": cfg.enc_layers,
                       "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                       "n_kv": cfg.n_kv, "head_dim": cfg.head_dim,
                       "d_ff": cfg.d_ff, "vocab": cfg.vocab,
                       "img_tokens": cfg.img_tokens,
                       "enc_seq": cfg.enc_seq, "params": cfg.param_count()}
        r["s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    res["launches"] = totals.launches
    res["phase_s"] = time.perf_counter() - t_phase
    return res, totals


# ---------------------------------------------------- recurrent families --
REC_DEV = "cuda"
REC_ARCHS = ("hymba-1.5b", "xlstm-350m")
REC_FAMILIES = ("hybrid", "ssm")
# 8 requests of 32 to 300 prompt tokens and 32 new tokens each on 4 slots
# (max_seq 512); request i is submitted at engine step REC_STAGGER * i, so
# one-shot prefills are admitted while other slots decode.
REC_PROMPTS = (32, 300, 96, 200, 64, 256, 128, 160)
REC_NEW, REC_STAGGER = 32, 4
# Training on 2 x 128 SyntheticLM tokens a step (two scan chunks): two
# AdamW steps on one state at full width and depth, under sub3 and then
# fused sub3; one step at depth 2 under the tensor recipe (its events on
# gam_quant; the QTensor GEMMs of serving take bf16 activations and
# launch none), then profiled. The scans run a Python
# step a token a layer (a hymba step took ~22 s, an xlstm step ~42 s at
# 2 x 256 tokens on an NVIDIA H100 80GB HBM3, 700 W), so the sequence
# and the step count are cut to fit the script's time, and the profiler
# (~0.2 ms of host time an event recorded there; ~2.4 x 10^5 kernels a
# full-depth hymba step) gets the depth-2 step.
REC_TRAIN = {"batch": 2, "seq": 128}
REC_POLICIES = ("sub3", "sub3_fused")
# The two steps at full width and a quarter of the depth (hymba 8 of 32
# layers, xlstm 3 of 12 units): at full depth they took 47 s of a 182 s
# recurrent phase on a host where the whole script took 1,093.4 s of its
# 1,200 (an H100 80GB HBM3, 700 W); every check they make holds at any
# depth.
REC_TRAIN_LAYERS = {"hymba-1.5b": 8, "xlstm-350m": 6}
# Depth 2, three ways: a prefill and 4 decode steps after it (each step
# runs every GEMM three times in the plain version, ~0.1 s each); hymba's
# prompt of 2560 tokens masks with its 2048 window (xlstm has no window:
# 512 tokens).
REC_DEPTH2_PROMPT = {"hybrid": 2560, "ssm": 512}
REC_DEPTH2_DECODE = 4
# At full width and depth: bytes per token, recurrent state bytes per
# slot and weight packs.
REC_EXACT = {"hymba-1.5b": (40960, 7168000, 193),
             "xlstm-350m": (0, 50626752, 72)}
# The recurrent layer types' mor_dot weights, by leaf name.
REC_GEMM_LEAVES = ("wqkv", "wo", "wi", "w_in", "w_out", "w_up", "w_qkv",
                   "w_down", "w_x", "w_ff1", "w_ff2")


def rec_gemms(cfg):
    """Mixed GEMMs of one model call with QTensor weights: 6 a hymba
    layer (qkv, proj, the mixer's in and out, the MLP's two) and its
    untied head; 6 an xLSTM unit (an mLSTM's up, qkv, down; an sLSTM's
    wx, ff1, ff2), the tied head not quantized. Also the mor_dots of a
    training step (less the head). REC_EXACT's count at full depth."""
    n = 6 * cfg.n_units + (0 if cfg.tie_embed else 1)
    check(not rec_full(cfg) or n == REC_EXACT[cfg.name][2],
          f"{cfg.name}: {n} weight matrices")
    return n


def rec_bytes(cfg):
    """(bytes per token of the paged K/V, recurrent state bytes of one
    slot) from the config; REC_EXACT's at full depth."""
    L = cfg.n_units
    if cfg.family == "hybrid":
        di, N, cw = cfg.mamba_d_inner, cfg.ssm_state, cfg.conv_width
        out = (2 * L * cfg.n_kv * cfg.head_dim * 2,
               L * (di * N * 4 + (cw - 1) * di * 2))
    else:
        H, d = cfg.n_heads, cfg.d_model
        dh = 2 * d // H
        out = 0, L * (4 * (H * dh * dh + H * dh + H) + 4 * 4 * d)
    check(not rec_full(cfg) or out == REC_EXACT[cfg.name][:2],
          f"{cfg.name}: {out}")
    return out


@contextlib.contextmanager
def scan_host_time(acc):
    """Adds to ``acc['s']`` the host seconds spent issuing the recurrent
    scans' chunks (the forward's, and the backward's recomputes under the
    chunk checkpoint) and to ``acc['steps']`` their time steps: the
    host's share of a prefill or a training step inside the scans."""
    from repro_torch.models import common
    inner = common._scan_chunk

    def timed(f, n, *args):
        t = time.perf_counter()
        out = inner(f, n, *args)
        acc["s"] += time.perf_counter() - t
        acc["steps"] += args[n].shape[0]
        return out
    with patched(common, "_scan_chunk", timed):
        yield acc


def rec_requests(vocab):
    from repro_torch.serve import Request
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(0, vocab, L).astype(np.int32),
                    max_tokens=REC_NEW) for i, L in enumerate(REC_PROMPTS)]


def rec_full(cfg):
    """Whether ``cfg`` is the registry's own (full width and depth)."""
    from repro_torch.configs import get_config
    return cfg.name in REC_EXACT and cfg == get_config(cfg.name)


def rec_check_weights(cfg, row):
    """The Engine's sub3 tree of a recurrent family: one pack a GEMM
    weight (hymba's K and N of 1600 / 2240 end in padded blocks), the
    mixers' plain leaves dense."""
    w = row["weights"]
    check(len(w) == (7 if cfg.family == "hybrid" else 6)
          and all(k == "lm_head" or k.rsplit("/", 1)[-1] in REC_GEMM_LEAVES
                  for k in w), f"{row['run']}: quantized leaves {w}")


def rec_train(cfg, name, policies, smi, totals, profile=None, seed=0):
    """``train_run`` of a recurrent family from init_params: one AdamW
    step under each of ``policies`` (train_policies' names) on one state,
    REC_TRAIN's SyntheticLM batches, 6 mor_dots a hymba layer or an
    xLSTM unit, every event on the tile route, every fused GEMM on the tc
    path; each step's row also holds the host ms inside its scans."""
    from repro_torch.models import init_params
    pols = train_policies()
    scan = {"s": 0.0, "steps": 0}

    def on_step(s, params, m, row):
        row.update(policy=policies[s], scan_host_ms=scan["s"] * 1e3,
                   scan_steps=scan["steps"],
                   scan_host_share=scan["s"] * 1e3 / row["step_ms"])
        scan.update(s=0.0, steps=0)

    res, launches, paths, routes = train_run(
        cfg, name, [pols[p] for p in policies], len(policies), smi, totals,
        init=lambda: init_params(cfg, seed=seed, device=REC_DEV),
        batch_fn=lambda s: train_batch(cfg, s, REC_TRAIN["batch"],
                                       REC_TRAIN["seq"], REC_DEV),
        dots=6 * cfg.n_units, line="recurrent_train_step", on_step=on_step,
        ctx=scan_host_time(scan), profile=profile)
    check_tile_route(routes, launches, name)
    check(paths["tc"] == launches["mixed_gemm"],
          f"{name}: fused GEMMs off the tc path: {paths}")
    res.update(policies=list(policies), launches=launches,
               mixed_gemm_paths=paths)
    return res


def rec_train_depth2(cfg, ops, ref, smi):
    """``train_depth2`` at full width and depth 2 (hymba: 2 layers;
    xLSTM: one unit) on the main path's batch under the tensor recipe
    (its events on gam_quant) and sub3: kernel path against plain path;
    fused sub3 with every forward, dgrad and wgrad GEMM held against the
    plain version."""
    from repro_torch.models import init_params
    c2 = dataclasses.replace(cfg, n_layers=2)
    params = init_params(c2, seed=1, device=REC_DEV)
    batch = train_batch(c2, 0, REC_TRAIN["batch"], REC_TRAIN["seq"],
                        REC_DEV)
    gemm_w = {k: v for k, v in flat_tree(params["blocks"]).items()
              if k.rsplit("/", 1)[-1] in REC_GEMM_LEAVES}
    want = fused_gemm_shapes(gemm_w,
                             REC_TRAIN["batch"] * REC_TRAIN["seq"])
    res = train_depth2(c2, ops, ref, params, batch, ("tensor", "sub3"),
                       want, 6 * c2.n_units, f"{cfg.name} train depth-2")
    res.update(layers=c2.n_layers, card=smi)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def packs_equal(qk, qp, what):
    """Every QTensor leaf of a tree quantized on the kernels (``qk``)
    against the plain version's (``qp``): each lane bit for bit, the
    stats rows as ``compare_rows``'s. Returns the number of weight
    matrices held (a stacked leaf's layers each)."""
    from repro_torch.serve.quantized import _LANES, QTensor
    fk, fp = flat_tree(qk), flat_tree(qp)
    check(fk.keys() == fp.keys(), f"{what}: leaves differ")
    n = 0
    for key, a in fk.items():
        b = fp[key]
        check(isinstance(a, QTensor) == isinstance(b, QTensor),
              f"{what} {key}: quantized on one path only")
        if not isinstance(a, QTensor):
            continue
        for lane in _LANES:
            la, lb = getattr(a.mo, lane), getattr(b.mo, lane)
            check(la.shape == lb.shape and torch.equal(raw(la), raw(lb)),
                  f"{what} {key}: lane {lane} differs from the plain version")
        compare_rows({key: a.stats}, {key: b.stats}, f"{what} {key} stats")
        n += a.mo.tags.shape[0] if a.is_stacked else 1
    return n


def rec_cache(cfg, pc, T):
    """A decode cache of T positions (batch 1) holding a prefill cache
    ``pc``: its K/V at the first positions, its recurrent state whole."""
    from repro_torch.models import init_cache
    from repro_torch.serve.paged import leaf_paths
    cache = init_cache(cfg, 1, T, device=REC_DEV)
    got = dict(leaf_paths(pc))
    for key, leaf in leaf_paths(cache):
        if key.rsplit("/", 1)[-1] in ("k", "v"):
            leaf[:, :, :got[key].shape[2]] = got[key]
        else:
            leaf.copy_(got[key])
    return cache


def rec_depth2(cfg, ops, ref, smi):
    """At full width and depth 2, sub3 weights, every pack held against
    the plain version's (``packs_equal``): a make_prefill_fn of
    REC_DEPTH2_PROMPT tokens (hymba: its 2048-token window masking) and
    REC_DEPTH2_DECODE decode steps from its cache on tokens drawn from a
    seed, three ways (``depth2_three_ways``)."""
    from repro_torch.core.policy import MoRDotPolicy, MoRPolicy
    from repro_torch.models import (init_params, make_decode_fn,
                                    make_prefill_fn)
    from repro_torch.serve.quantized import quantize_params
    c2 = dataclasses.replace(cfg, n_layers=2)
    dense = init_params(c2, seed=1, device=REC_DEV)
    pol = MoRPolicy(recipe="sub3")
    params, _ = quantize_params(dense, pol)
    packs = packs_equal(params, quantize_params(
        dense, pol.replace(backend="torch"))[0], f"{cfg.name} depth-2")
    check(packs == rec_gemms(c2), f"{cfg.name} depth-2: {packs} packs")
    del dense
    P, n = REC_DEPTH2_PROMPT[cfg.family], REC_DEPTH2_DECODE
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, P))).to(
        REC_DEV)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (n, 1, 1))).to(
        REC_DEV)

    def run_path(backend, _way):
        pol = MoRDotPolicy(weight=MoRPolicy(backend=backend))
        l1, pc, _ = make_prefill_fn(c2, pol)(params, {"tokens": prompt})
        cache = rec_cache(c2, pc, P + n)
        decode = make_decode_fn(c2, pol)
        outs = []
        for i in range(n):
            l2, cache, _ = decode(params, cache, toks[i], torch.full(
                (1,), P + i, device=REC_DEV))
            outs.append(l2[..., :cfg.vocab])
        return l1[..., :cfg.vocab], torch.cat(outs, dim=1)

    res, gemms = depth2_three_ways(run_path, ops, ref,
                                   f"{cfg.name} depth-2",
                                   ("prefill", "decode"))
    n_q = rec_gemms(c2)
    calls = sum(v["calls"] for v in gemms.values())
    at_p = sum(v["calls"] for k, v in gemms.items() if k[0] == P)
    check(calls == n_q * (1 + n) and at_p == n_q,
          f"{cfg.name} depth-2: {calls} GEMMs, {at_p} at M = {P}: "
          f"{sorted(gemms)}")
    res.update(prompt=P, decode_steps=n, window=cfg.window,
               packs_equal_plain=packs, card=smi)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_recurrent(ops, ref, smi, cfgs=None):
    """The recurrent families, serving and training (module docstring,
    item 14). ``cfgs``: {arch: config} overrides (a CPU rehearsal passes
    reduced ones). Returns (the recurrent line, the Totals of its
    main-path runs)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    t_phase = time.perf_counter()
    cfgs = cfgs or {}
    totals = Totals()
    res = {"card": smi}
    for arch in REC_ARCHS:
        cfg = cfgs.get(arch) or get_config(arch)
        key = arch.split("-")[0]
        r = res[key] = {}
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=REC_DEV)
        r["serve"], _ = zoo_serve(cfg, params, f"{key}_serve", {},
                                  rec_requests(cfg.vocab), smi, totals,
                                  stagger=REC_STAGGER,
                                  line="recurrent_serve")
        rec_check_weights(cfg, r["serve"])
        del params
        parts = {"serve": time.perf_counter() - t0}
        t = time.perf_counter()
        tcfg = cfg if arch in cfgs else dataclasses.replace(
            cfg, n_layers=REC_TRAIN_LAYERS[arch])
        r["train"] = rec_train(tcfg, f"{key}_train", REC_POLICIES, smi,
                               totals)
        parts["train"] = time.perf_counter() - t
        t = time.perf_counter()
        r["train"]["tensor_depth2"] = rec_train(
            dataclasses.replace(cfg, n_layers=2), f"{key}_depth2_tensor",
            ("tensor",), smi, totals, profile="gam_quant", seed=1)
        parts["train_tensor_depth2"] = time.perf_counter() - t
        t = time.perf_counter()
        r["depth2"] = rec_depth2(cfg, ops, ref, smi)
        parts["depth2"] = time.perf_counter() - t
        t = time.perf_counter()
        r["train_depth2"] = rec_train_depth2(cfg, ops, ref, smi)
        parts["train_depth2"] = time.perf_counter() - t
        r["parts_s"] = parts
        r["config"] = {"layers": cfg.n_layers, "unit": list(cfg.unit),
                       "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                       "n_kv": cfg.n_kv, "head_dim": cfg.head_dim,
                       "d_ff": cfg.d_ff, "d_inner": cfg.mamba_d_inner,
                       "ssm_state": cfg.ssm_state, "window": cfg.window,
                       "vocab": cfg.vocab, "params": cfg.param_count()}
        r["s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    for kern in ("mor_select_pack", "mor_select_select", "gam_quant",
                 "mixed_gemm"):
        check(totals.launches[kern] > 0,
              f"recurrent: {kern} launched no time on its path")
    check(totals.paths["stream"] > 0 and totals.paths["tc"] > 0,
          f"recurrent: GEMM paths {totals.paths}")
    res["launches"] = totals.launches
    res["gemm_paths"] = totals.paths
    res["routes"] = totals.routes
    res["phase_s"] = time.perf_counter() - t_phase
    return res, totals


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--multi-device-rank"]:
        md_rank(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
        return 0
    if sys.argv[1:2] == ["--tp-serve-rank"]:
        tp_rank(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
        return 0
    t_start = time.perf_counter()
    from repro_torch.configs import get_config
    from repro_torch.core.partition import Partition
    from repro_torch.kernels import build, ops, ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = build.build_all()
    emit({"build_s": time.perf_counter() - t0, "built": sorted(logs),
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in logs.items()},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "card": smi})

    wgmma_build = build_facts(build)
    emit({"mor_select_build": wgmma_build["mor_select"], "card": smi})
    emit({"gam_quant_build": wgmma_build["gam_quant"], "card": smi})
    emit({"mor_select_div_check": phase_div_check(build), "card": smi})
    emit({"fp8_gemm_build": wgmma_build["fp8_gemm"], "card": smi})
    emit({"flash_attention_build": wgmma_build["flash_attention"],
          "card": smi})
    sel_err = phase_mor_select(ops, Partition)
    gemm_parity = phase_mixed_gemm(ops, ref, Partition)
    quant_parity = phase_quant_select(ops, Partition)
    gc.collect()
    torch.cuda.empty_cache()
    generic, generic_launches, generic_routes = phase_generic_smem(
        ops, Partition, build, smi)
    cfg = get_config("llama3-8b")
    api_parity = phase_kernel_api_parity(ops, Partition, cfg)
    t0 = time.perf_counter()
    api, api_launches = phase_kernel_api(ops, Partition, cfg)
    emit({"kernel_api_launches": api_launches,
          "phase_s": time.perf_counter() - t0, "card": smi})
    timing = phase_timing(ops, ref, Partition, cfg)
    timing.update(phase_train_timing(ops, ref, Partition, cfg))
    timing.update(api)
    engine, launches, engine_paths, engine_routes = phase_engine(
        cfg, ENGINE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    serve_tiers, serve_totals = phase_serve_tiers(cfg, ops, ref, smi)
    emit({"serve_tiers": serve_tiers})
    gc.collect()
    torch.cuda.empty_cache()
    zoo, zoo_totals = phase_model_zoo(ops, ref, smi)
    emit({"model_zoo": zoo})
    gc.collect()
    torch.cuda.empty_cache()
    front, front_totals = phase_frontends(ops, ref, smi)
    emit({"frontends": front})
    gc.collect()
    torch.cuda.empty_cache()
    rec, rec_totals = phase_recurrent(ops, ref, smi)
    emit({"recurrent": rec})
    gc.collect()
    torch.cuda.empty_cache()
    depth2 = phase_depth2(cfg, ops, ref)
    serve_grad = phase_serve_grad()
    train, train_launches, train_paths, train_routes = phase_train(cfg)
    train_depth2 = phase_train_depth2(cfg, ops, ref)
    gc.collect()
    torch.cuda.empty_cache()
    md, md_totals = phase_multi_device(smi)
    emit({"multi_device": md})
    gc.collect()
    torch.cuda.empty_cache()
    tp, tp_totals = phase_tp_serve(smi)
    emit({"tp_serve": tp})
    t0 = time.perf_counter()
    state, state_launches, state_routes, state_dtypes = phase_train_state(
        ops, ref)
    state["phase_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    ft, ft_launches, ft_routes, ft_paths = phase_fault_tolerance(
        ops, ref, Partition, smi)

    kernels = []
    for name, src, replaces in (
        ("mor_select_pack", "src/repro_torch/csrc/mor_select.cu",
         "src/repro/kernels/mor_select.py:289"),
        ("mor_select_select", "src/repro_torch/csrc/mor_select.cu",
         "src/repro/kernels/mor_select.py:289"),
        ("gam_quant", "src/repro_torch/csrc/gam_quant.cu",
         "src/repro/kernels/gam_quant.py:96"),
        ("mixed_gemm", "src/repro_torch/csrc/mixed_gemm.cu",
         "src/repro/kernels/mixed_gemm.py:214"),
        ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:113"),
        ("fp8_gemm", "src/repro_torch/csrc/fp8_gemm.cu",
         "src/repro/kernels/fp8_gemm.py:59"),
    ):
        t = timing[name]
        by_path = {"engine": launches.get(name, 0),
                   "serve_tiers": serve_totals.launches[name],
                   "model_zoo": zoo_totals.launches[name],
                   "frontends": front_totals.launches[name],
                   "recurrent": rec_totals.launches[name],
                   "train": train_launches[name],
                   "train_state": state_launches[name],
                   "generic_smem": generic_launches[name],
                   "kernel_api": api_launches[name],
                   "fault_tolerance": ft_launches[name],
                   "multi_device": md_totals.launches[name],
                   "tp_serve": tp_totals.launches[name]}
        check(sum(by_path.values()) > 0,
              f"{name}: no launch on any main path")
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "card": smi,
        }
        if name == "mixed_gemm":
            # ms / bound_ms above: the stream path at the decode shape;
            # train_shapes: the tc path.
            entry["launches_by_gemm_path"] = {
                k: engine_paths[k] + serve_totals.paths[k] + train_paths[k]
                + ft_paths[k] + zoo_totals.paths[k] + front_totals.paths[k]
                + rec_totals.paths[k] + md_totals.paths[k]
                + tp_totals.paths[k]
                for k in ("stream", "tc")}
            entry["serve_tiers_gemm_paths"] = serve_totals.paths
            entry["recurrent_gemm_paths"] = rec_totals.paths
            entry["parity_max_err_over_tol"] = gemm_parity
            entry["train_shapes"] = {g: timing[f"mixed_gemm_{g}"]
                                     for g in ("fwd", "dgrad", "wgrad")}
            entry["stream_shapes"] = timing["stream"]
        if name in engine_routes:
            # ms / bound_ms above: the tile route, wi view, random
            # weights (the selections: sub3; gam_quant: E4M3, gam);
            # shapes: the selections' every sub3 tag, sub4 and generic
            # route; gam_quant's E5M2 and other algos (its generic route:
            # generic_ms).
            entry["launches_by_route"] = {
                r: engine_routes[name][r] + serve_totals.routes[name][r]
                + zoo_totals.routes[name][r]
                + front_totals.routes[name][r]
                + rec_totals.routes[name][r]
                + train_routes[name][r] + state_routes[name][r]
                + generic_routes[name][r] + ft_routes[name][r]
                + md_totals.routes[name][r] + tp_totals.routes[name][r]
                for r in ("tile", "generic")}
            entry["shapes"] = t["shapes"]
            entry["build"] = wgmma_build[
                "gam_quant" if name == "gam_quant" else "mor_select"]
        if name == "mor_select_select":
            # f32: the f32 instance on the wi view (the gradient
            # compression's operands; every train_state gradient event).
            entry["f32"] = t["f32"]
            entry["train_state_launches_by_dtype"] = state_dtypes
        if name == "gam_quant":
            # ms: the wrapper's mean over 4 runs in turns with the shapes'
            # rows (runs); host_us: the wrapper's host time per call.
            for key in ("runs", "host_us", "generic_ms", "generic_runs"):
                entry[key] = t[key]
        if name in api:
            entry["case"] = t["case"]
            entry["cases"] = t["cases"]
        if name == "fp8_gemm":
            # ms / bound_ms above: the wgmma route at fc1; bound_f16_ms:
            # the same work at the f16 rate of its MMAs.
            entry["kernel_route"] = t["route"]
            entry["launches_by_route"] = t["launches_by_route"]
            entry["bound_f16_ms"] = t["bound_f16_ms"]
            entry["cuda_core_ms"] = t["cuda_core_ms"]
            entry["cuda_core_block"] = t["cuda_core_block"]
            entry["build"] = wgmma_build["fp8_gemm"]
        if name == "flash_attention":
            # ms / bound_ms above: the wgmma route at 1 x 8192;
            # bound_design_ms: its ceiling with p v twice (6 d a pair);
            # cuda_core_f32_ms: the cuda_core route on the same values in
            # f32.
            entry["kernel_route"] = t["route"]
            entry["launches_by_route"] = t["launches_by_route"]
            entry["bound_design_ms"] = t["bound_design_ms"]
            entry["cuda_core_f32_ms"] = t["cuda_core_f32_ms"]
            entry["build"] = wgmma_build["flash_attention"]
        kernels.append(entry)
    emit({"parity_max_abs_err": {"mor_select_pack": sel_err, **api_parity},
          **quant_parity})
    emit({"stream_path": timing["stream"], "card": smi})
    emit({"qtensor_backward": serve_grad, "card": smi})
    emit({"depth2": depth2, "card": smi})
    emit({"engine": engine, "card": smi})
    emit({"train_depth2": train_depth2, "card": smi})
    emit({"train": train, "card": smi})
    emit({"train_state": state, "card": smi})
    emit({"fault_tolerance": ft, "card": smi})
    emit({"generic_smem": generic, "card": smi})
    emit({"wall_s": time.perf_counter() - t_start, "card": smi})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
