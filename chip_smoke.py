#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from the sources in the checkout (one ``nvcc``
   per source, all started together), and print the ``-Xptxas -v``
   report (registers, spills, shared memory) of both flash kernels, the
   greedy suppression's two kernels, the batched projection and the
   SphIoU kernels (self and general path); the float32 flash kernel's 8
   instances (float32 and bf16 at D 16, 32, 64, 128) must spill nothing;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes: max |err| against the stated tolerance, the
   kernel's, the plain version's and (where one PyTorch call computes
   the same function) that call's time in ms, and the least time the
   card could take (``bound_ms``).  The batched projection and the greedy
   suppression are also checked and timed at a batched tick's own shapes
   (9 crops at 896 and at 416; 4 rows of 128 on the float32 IoU and on
   the bf16 option's), the gnomonic outputs are printed as digests (two
   builds that print the same digest agree bit for bit), and the greedy
   kernel is held to its plain version on rows with NaN, +inf and signed
   zero scores.  SphIoU's two entries (float32 and bf16) are checked and
   timed at 32x512 and at a tick's 4x128 on the self path (the boxes
   against themselves, as NMS calls it; its output must be exactly
   symmetric) and on the general path (a copy of the boxes), after a
   check over every finite float32 of the trig identities the kernel
   rests on.  Flash attention's two kernels are
   checked on the reference's six test cases (the SIMT kernel in float32
   and bf16 at their head sizes, the tensor-core kernel in bf16 at D=64
   and D=128), at smollm-135m's 4x2048 shape (float32 on the SIMT
   kernel, bf16 on both), at the float32 policy's 1x2048 (the SIMT
   kernel's path shape; it and the float32 4x2048 are launched twice,
   which must give the same bits, and timed beside SDPA in float32 and
   the plain version), at 32k (the
   tensor-core kernel against the SIMT one), and, at D=128, at
   mixtral-8x22b's prefill layout (2x8192, 48/8 heads, window 4096) and
   granite-34b's MQA layout (1x4096, 48/1 heads), each with a control
   that drops one K/V tile and must fail; then the tensor-core kernel,
   the SIMT kernel, SDPA (with a boolean band mask for a window) and the
   plain version are timed in turn.  The bf16 SphIoU option is also checked
   against the float32 kernel's keep masks (the reference's flip gate).
   The detector's norm-activation tail (group norm, Mish and the
   bottleneck's residual add in one kernel) is checked and timed at
   yolo-p6-1280's stem (8 x 64 x 640²) and its 20² level (8 x 1024 x
   20²), with and without the residual, each held to the same tail in
   float64 (at most twice as far from it as the plain version, + 1e-6);
4. a small input through the per-request path on the card and on the
   CPU: the same SRoIs and plans, PIs, detector heads and detection
   scores within tolerance;
5. the main path at full width: the five-rung ``PAPER_LADDER``
   (416-1280 px inputs, published widths, 80 classes, random weights
   from a seeded generator) on synthetic 1920x3840 ERP video.  One
   stream runs ``OmniSenseLoop.process_frame`` for 2 frames (the
   per-request path: gnomonic sampling kernel), and one of its SRoIs goes
   through ``infer_sroi`` at every rung; then 4 streams run 3 pod
   ticks through ``PodServer.step`` under the sync policy (the tick's
   frames staged once, from pinned memory; emission; the variant queues
   drained into bucketed ``launch_srois_batched`` chunks with the fused
   projection and crop cache; ingestion with ``_suppress_tick``'s one
   batched NMS over the padded rows), and each tick's padded rows once
   more through the bf16 SphIoU option (``iou_dtype=torch.bfloat16``),
   its keep flips against the server's float32 suppression reported.
   Each tick line gives the wall ms split into emission, drain and
   ingestion, the requests per variant, the detections before and after
   NMS, the frame uploads (one a stream) and crop-cache hits, and the NMS
   backend and padded rows.  Launch counts are set to 0 just before each
   of the two paths and read just after; every kernel must have run.
   Then the serve launcher (``repro_torch.launch.serve``) runs its
   oracle pod under ``--policy async --pod-allocate``;
6. the mixed-task pod: 4 streams (``stream_tasks_for("mixed", 4)``) on
   the same synthetic 1920x3840 video, built through the task registry
   (``build_task_streams``: the union ladder, each task's latency model)
   and served by the real backends: the 2 detection streams by
   ``TorchDetectorBackend`` on the full ``PAPER_LADDER``, the 2 action
   streams by ``TorchActionBackend`` on all four ``ACTION_LADDER`` rungs
   at their published shapes (d_model 64, seeded random weights).  3
   ticks through ``PodServer.step`` (sync policy, ``max_batch`` 8); each
   tick line gives the wall ms split into emission, drain and ingestion,
   the requests per (task, variant), the action predictions, the
   detections before and after NMS, the frame uploads (one a stream) and
   the action path's ``gnomonic_sample`` launches, counted apart from the
   detection streams'.  Then every action rung runs a batch of 8 at its
   published shape through ``infer_srois_batched``, with the kernel and
   with the plain projection on the card: logits within
   ``ACTION_LOGIT_ATOL``, equal categories, and the kernel's crops held to
   the float64 map.  Then the replay lane on the oracle backends (host
   only): ``repro_torch.launch.replay record`` and ``check`` of a closed
   corpus (8 streams, async, ``--pod-allocate``), a mixed-task open-loop
   corpus (``--slo 2.0 --admission slo``) and a 2-pod fleet corpus
   (``--routing affinity``), each of which must replay bit-identically,
   and the serve launcher's ``--open-loop --pods 2 --tasks mixed`` fleet;
7. the LM serving path at full width: smollm-135m (``full_config()``,
   published widths, 30 layers, bf16 weights from a seeded generator)
   with ``attention_impl="flash"``: ``lm_prefill_step`` on 4 prompts of
   2048 tokens, 32 greedy ``lm_decode_step``s, then one prefill of
   32768 tokens (``prefill_32k``'s length; its batch cut from 32 to 1).
   Prefill ms per request, decode ms per token, the generated tokens'
   digest and the kernels' launches are printed (the tensor-core kernel
   2 x 30 times, the SIMT kernel never); logits must be finite,
   the 4x2048 prefill's logits must agree with the same step under
   ``attention_impl="chunked"``, the attention of each of its layers and
   the 32k prefill's layer-0 attention with the chunked plain version
   within one bf16 ulp and ``ATTN_BF16_ATOL``, a limit that a control
   with one K/V tile dropped must fail.  Launch counts are set to 0 before
   the path and read after it.  Then the same model under the float32
   policy (the reference's float32 path) prefills 1 x 2048 tokens, which
   runs the SIMT kernel 30 times, counted on its own and held to the
   chunked plain version's logits;
8. the MoE LM serving path at published widths (``MOE_RUNS``; its cuts
   are in ``run_moe_path``): mixtral-8x22b (8 of 56 layers, 8 experts
   top-2, window 4096) prefills 2 prompts of 8192 tokens and decodes 32
   greedy tokens; qwen3-moe-235b-a22b (2 of 94 layers, 128 experts
   top-8) prefills 1 x 4096 and decodes 16 greedy tokens.  Prefill ms per request, decode ms per
   token, the generated tokens' digest, the picks each layer dropped in
   prefill and in decode, and the launches are printed (the tensor-core
   kernel once a layer of each prefill, the SIMT kernel never); logits
   must be finite, each layer's attention within one bf16 ulp and
   ``ATTN_BF16_ATOL`` of the chunked plain version (the control drops a
   tile inside the window of the last rows), and layer 0's MoE block
   within its bf16 roundings (``MOE_U``) of a per-token float32
   formulation, which a control with one kept pick zeroed must fail.
   The logits against the chunked step are held to ``LM_LOGIT_ATOL``
   where every layer routed alike;
9. training (no kernel: the reference's train steps reach none, and
   ``flash_attention`` has no backward): smollm-135m ``full_config()``
   (30 layers, bf16, ``chunked`` attention, remat, ``ce_chunk`` 512)
   trains ``TRAIN_STEPS`` ``lm_train_step``s of ``adamw(lr=1e-3,
   warmup_steps=10)`` on 8 x 4096 ``lm_batches`` through ``Prefetcher``
   (``train_4k``'s global batch of 256 cut to ``TRAIN_BATCH``).  Each step
   prints its ms (host clock, ended by ``torch.cuda.synchronize()``),
   tokens/s, loss and grad norm, then the peak memory.  Checks: (a) at the
   initial weights every gradient leaf is finite and every parameter group
   (embed, each projection and norm of layers 0 and 29, ``ln_f``,
   unembed) non-zero; (b) step 1's per-token NLL within ``TRAIN_NLL_ATOL``
   (mean |diff|) of the float32 policy's on the widened weights, a limit
   that the control (targets shifted by one token) must fail; (c) a
   ``save_async`` after step ``TRAIN_SAVE_AT``, restored into a fresh
   ``make_state`` template, equals the saved state bit for bit, leaf by
   leaf; (d) the later steps run again from it, their losses printed
   beside the uninterrupted run's (bit-equal or not).  Then
   yolo-p6-1280 (width and depth 1.0, P6 head) trains
   ``DET_TRAIN_STEPS`` ``detector_train_step``s in float32 (TF32 off,
   the plain norm-activation tail: the kernel has no backward) on
   ``detector_batches`` of the synthetic video at 1920x3840, batch 8 (cut
   to 4 if peak memory passes ``DET_TRAIN_MAX_GB``): ms a step, images/s,
   loss, grad norm, peak memory; every gradient finite, every conv's
   non-zero.  Launch counts are set to 0 before each of the two and read
   after: none may have launched a kernel.  Last, one detector step is
   run twice from one state under cuDNN's defaults and again with
   ``torch.backends.cudnn.deterministic`` on and ``benchmark`` off
   (restored after): whether the loss, grad norm and updated parameters
   are bit-equal, and the ms a step under each;
10. the vision family (no kernel: its attention is the plain
   ``_mha_full``, its convolutions, norms and pools cuDNN's and
   PyTorch's): ViT-B/16, ConvNeXt-B, ResNet-50 and ResNet-152 at their
   published widths and depths (``full_config()``, bf16, seeded random
   weights).  Each serves ``vision_serve_step`` at ``serve_b128`` (128 x
   224²) and ``serve_b1`` (ms a batch, images/s, peak memory), and its
   bf16 logits of 8 images are held to the float32 policy's on the same
   weights within ``VISION_BF16_RTOL`` (relative norm), a limit that the
   control (the float32 logits of another batch) must fail.  A ResNet-50
   and a ConvNeXt-B backbone detector run one forward and ``decode`` at
   640², batch 8, bf16: head grids 80/40/20, finite boxes.  Then each arch
   trains ``VISION_TRAIN_STEPS`` ``vision_train_step``s (remat, ``adamw(lr=
   1e-3, warmup_steps=10)``) at ``cls_224`` (batch 256 x 224²): ms a step,
   images/s, loss, grad norm, accuracy, peak memory.  Checks: at the
   initial weights every gradient leaf finite and every trainable one
   non-zero (the batchnorm ``mean``/``var`` leaves 0 by construction: the
   loss reads the batch's statistics); on ResNet the running stats all
   moved after the steps and a serve step left them bit-equal; the
   ResNet-50 and ConvNeXt-B states (batchnorm stats; ConvNeXt's ``None``
   first downsample) restored from a ``CheckpointManager`` bit for bit.
   Launch counts are set to 0 before the serve runs and before the train
   runs, and read after each: none may have launched a kernel;
11. the diffusion family (no kernel: its attention is the plain ``_mha``,
   its convolutions and norms cuDNN's and PyTorch's): flux-dev and
   unet-sdxl at their published widths (``full_config()``, bf16, seeded
   random weights on the card; flux's AdaLN-Zero modulation drawn
   non-zero, ``perturb_modulation``, since its zeros make every block the
   identity).  Each runs a whole ``gen_fast`` sample through
   ``diffusion_denoise_step`` (16 x 64² latents, 4 Euler or DDIM steps
   after a warm-up step) and ``DIFF_GEN1024_STEPS`` of ``gen_1024``'s 50
   steps (4 x 128²): ms a step, samples/s, peak memory and the sampled
   latents' sha256; then its bf16 step is held to the float32 policy's on
   the same weights within ``DIFF_BF16_RTOL`` (relative norm of the
   step's change of the latents; flux on its first ``FLUX_POLICY_BLOCKS``),
   a limit that the control (the float32 step at another timestep) must
   fail.  Then each trains ``DIFF_TRAIN_STEPS`` ``diffusion_train_step``s
   (remat, ``adamw(lr=1e-3, warmup_steps=10)``) at ``train_256`` (32²
   latents) from the served weights, flux on its first
   ``FLUX_TRAIN_BLOCKS`` and both at ``DIFF_TRAIN_BATCH``: ms a step,
   images/s, loss, grad norm, peak memory.  Checks: at the initial
   weights every gradient leaf finite and non-zero (none is zero by
   construction once the modulation is non-zero); the UNet's trained
   parameters and step (457 leaves, its 5 ``None`` attention entries)
   restored from a ``CheckpointManager`` bit for bit.  Launch counts are
   set to 0 before each arch's serve run and before its train run: none
   may have launched a kernel;
12. the launch layer's cells (``repro_torch.launch.cells``, no kernel:
   every cell's attention is plain or ``chunked``): one cell of each
   family at its published shape (``CELL_RUNS``: vit_b16 ``serve_b128``,
   resnet_50 ``cls_224``, a train step at batch 256, unet_sdxl
   ``gen_fast``, one denoise step, and smollm_135m ``prefill_32k`` with
   its batch of 32 cut to 1).  Each cell's step is counted
   (``repro_torch.launch.hloanalysis``) on fake CUDA tensors
   (``dryrun.count_cell``) and again on real tensors drawn from a seed on
   the card (``cells.materialize``): the two FLOP counts, in total and by
   operand dtype, must be equal (the prefill at 4096 tokens, four
   attention chunks; its full 32768 is counted on the real tensors).
   Then the step runs ``CELL_TIMED_STEPS`` times after that counted run,
   its warm-up (host clock ended by ``torch.cuda.synchronize()``; the
   outputs must be finite): ms a step, TFLOP/s at the counted FLOPs, and
   two bounds with the share of each reached, beside the card's name and
   power limit: the card bound, the larger of the products at their
   operand dtype's peak (bf16 989, float32 67 TFLOP/s) and the least
   traffic (the arguments read and the outputs written once, over 3.35
   TB/s); and the eager-traffic bound, the larger of all the FLOPs over
   989 TFLOP/s and the counted bytes (every dispatched op's operands and
   results) over 3.35 TB/s.  Launch counts are set to 0 before the phase
   and read after: none may have launched a kernel;
13. the multi-device path (no kernel: its products are the MoE block's),
   on one card, so at world size 1: an NCCL process group from a file
   store (no network) and a (1, 1) ``("data", "model")`` ``DeviceMesh``
   (the backend and NCCL's version are printed).  (b) ``moe_block_a2a``
   at mixtral-8x22b's published width (one layer: d_model 6144, 8
   experts top-2, d_ff_expert 16384, bf16, seeded weights) on
   ``MD_MOE_TOKENS`` tokens, at the config's capacity factor and at
   ``MD_DROP_CF`` (which must drop picks), against ``moe_block`` on the
   same tokens: the output, the aux and every leaf's gradient of
   ``sum(out**2)`` bit for bit (at one model rank the exchange moves
   nothing), and both blocks' ms.  (c) ``compressed_psum_step`` over
   ``data`` on smollm-135m's full-width float32 gradients (one
   ``lm_loss`` backward): the bf16 mean equal to the bf16-rounded
   gradients and the residual to the gradients minus them, the top-k
   mean to ``topk_decompress(topk_compress(...))``, bit for bit; the
   step's and its all-reduce's ms (one-rank NCCL calls, not a fabric
   figure).  (d) smollm-135m's parameters saved by ``save_gathered``
   (specs from the LM rules) under ``mesh_signature``, restored by
   ``restore_local`` on the mesh: every leaf bit for bit, the signature
   printed.  (e) with more than one card, a ``PAPER_LADDER`` rung's
   replica forward split over every card against the unsplit forward;
   with one, a line that says the split was not run here and names the
   CPU test that holds it.  Launch counts are set to 0 before the phase
   and read after;
14. the OmniSense server under its other policies, on the full
   ``PAPER_LADDER`` at 1920x3840 (phase 5's set-up, ``tick_server``'s
   tick lines): (a) 4 streams for 3 ticks under ``deadline`` beside the
   same streams under ``sync``: each frame's detections within
   ``POLICY_ATOL`` (equal counts and categories; bit-equality printed);
   (b) 4 streams for 4 ticks under ``async``, then ``flush``: per tick
   the carried requests, the frame uploads (the staged ones, and those of
   chunks holding a carried request, which upload each of their frames
   again) and crop-cache hits; every request served a tick after its
   emission: its crop bit-equal to its own frame's projected again at
   the geometry it was served at, and its detections held to its crop
   run through the detector alone (``PER_REQUEST_ATOL``, the same
   categories in the same order), each with a control on its stream's
   next frame that must fail (the crop, and ``infer_sroi`` there);
   nothing queued, in flight or staged after the flush; the whole pod run twice from the same seeds, its ``ServeStats``
   fingerprint and per-frame detection digests bit-equal; (c) 4 streams
   for 2 ticks with the loops' budget raised (``RUNG_BUDGETS``) until the
   allocator puts two SRoIs of tick 1 on yolo-p6-1280: its chunks through
   ``project_srois_batched`` at S=1280, the crops held to the float64 map
   (twice the plain version's distance + 5e-5), each request's
   detections to its crop run alone, the kernel's ms on the largest chunk
   beside its bound;
   (d) the open-loop fleet: 2 pods over 4 mixed streams (phase 6's
   construction, no placement), affinity routing, SLO admission at 2 s,
   the serve launcher's arrivals (0.5 fps, jitter 0.2, seed 0, 8 frames
   a stream), frames rendered when asked for and dropped once served:
   the fleet report, frames by task and by pod, uploads, the NMS rounds
   by backend (each round the ``auto`` rule sends to the card launches
   the SphIoU and the greedy kernel once), and a second run bit-equal.
   Launch counts are set to 0 before (a)-(c) (``serving_policies``; the
   per-request checks' ``gnomonic_sample`` included) and before (d)'s
   first run (``fleet``, the action path's counted apart).  Then the
   batched NMS is timed on the host and on the card at every
   ``NMS_CROSSOVER`` shape (what ``auto``'s threshold is read from),
   and the kernels' keep mask is held bit for bit to the plain
   version's on the card there and at every shape the rule sent to the
   card in phases 5, 6 and 14;
15. granite-34b's dense serving at published width (8 of 88 layers, MQA:
   48 query heads on one KV head of 128, bf16, ``attention_impl=
   "flash"``): ``lm_prefill_step`` on 1 x 4096 tokens and 32 greedy
   ``lm_decode_step``s, prefill ms a request and decode ms a token beside
   the card, the tokens' digest equal over two runs, the logits within
   ``LM_LOGIT_ATOL`` of ``chunked`` and each layer's attention as phase 7
   holds it; ``flash_attention_wgmma`` 8 launches (``lm_granite``).
   Phase 8 also decodes qwen3-moe 16 greedy tokens and holds its first
   decode step after a 1024-token prompt to a prefill over the prompt and
   that token (``check_moe_decode``: a capacity factor at which no pick
   drops; the control with the token changed fails);
16. mixtral-8x22b's MoE training at published width (``full_config()``,
   bf16, ``chunked`` attention, remat, ``ce_chunk`` 256), ``reduced`` to
   ``MOE_TRAIN_LAYERS`` of its 56 layers and ``train_4k``'s global batch
   to ``MOE_TRAIN_BATCH`` x 4096: the update's reckoned peak with float32
   and with bf16 moments, whole-tree and leaf by leaf (``update_peaks``),
   and the predicted step time are printed (``moe_train_reckoning``),
   then ``MOE_TRAIN_STEPS`` ``lm_train_step``s
   of ``adamw(lr=1e-3, warmup_steps=10, state_dtype=bfloat16)`` on
   ``lm_batches`` through ``Prefetcher``: ms a step, tokens/s, loss, aux
   loss, grad norm, picks dropped and peak memory.  Checks, each with a
   control that must fail: (a) every gradient leaf finite and each group
   (embed, unembed, attention, norms, router, each expert stack)
   non-zero; (b) the first batch's per-token NLL within
   ``TRAIN_NLL_ATOL`` of the float32 policy's (the shifted-target
   control); (c) layer 0's MoE block's gradients (x, the router, the
   three expert stacks) within ``MOE_GRAD_RTOL`` of the float32 policy's
   (another cotangent's as the control); (d) one step run twice from one
   state gives the same sha256 of the new parameters and moments (a
   parameter one ulp up gives another).  Launch counts are set to 0
   before the phase and read after (``moe_train``);
17. the training shapes the card had not run: ``cls_384`` (64 x 384²)
   for the four vision archs (ViT-B/16 through ``config_for_res(384)``):
   the gradient check, ``VISION_TRAIN_STEPS`` steps and the bf16 logits
   against the float32 policy's at 384; ``train_1024`` (128² latents) for
   unet-sdxl and flux-dev (on ``FLUX_TRAIN_BLOCKS``), the batch halved
   until its reckoned peak stays under ``DIFF_1024_PEAK_GB``
   (``reduced``), the gradient check and ``DIFF_1024_STEPS`` steps; and
   unet-sdxl's ``gen_1024`` sample whole (4 x 128², 50 DDIM steps): ms a
   step, samples/s, peak memory and the latents' digest, the digest after
   ``DIFF_GEN1024_STEPS`` steps equal to phase 11's and the one a step
   later not.  Launch counts are set to 0 before each of the three paths
   and read after (``vision_train_384``, ``diffusion_train_1024``,
   ``diffusion_gen_1024``);
18. the launch layer's 33 cells that phase 12 leaves (``CELL_PLAN``),
   each whole where it fits one card, else at the cut beside it, built
   by the launch layer's own cell constructors (``_phase12_cell``: an LM's
   ``n_layers``, flux's double and single blocks, any family's batch)
   and printed as ``reduced``; a train cell whose AdamW update is
   reckoned past ``CELL_UPDATE_SHARE`` of the card prints its ``why``
   instead (``cell_why``), and the table's 3 skipped cells are named.
   Each cell prints phase 12's lines (FLOPs fake = real, held at a
   shallower depth where the run's fake counts would take more than ~3
   s, ``model_flops / FLOPs``, ms a step beside the card bound and the
   eager-traffic bound) and its peak memory; a decode cell decodes each
   step at ``cache_len = S - 1``.  Checks: outputs finite, fake = real,
   and the control (``control_cut``: one layer fewer for an LM, one
   double block fewer for flux, one batch element fewer for vision and
   the UNet, one more at a batch of 1) counting other FLOPs.  2 timed
   steps after the counted warm-up, 1 where the first took over 5 s.
   Launch
   counts are set to 0 before the phase and read after (``cells_plan``);
19. qwen3-moe's training, as phase 16 trains mixtral-8x22b: 1 of its 94
   layers at published width (3.732B parameters, 1.245B of them the
   embeddings), 2 x 4096, bf16 moments, the same checks and controls
   (``moe_train_qwen3``).

``--flash-only`` stops after the flash kernels' checks and times (phase 3
for attention alone), for comparing versions of the kernels; it prints no
result line.

``--frame-kernels-only`` stops after the frame loop's kernels (phase 3 for
the gnomonic sampler, the batched projection, SphIoU, the greedy
suppression and the detector's norm-activation tail), for the same use;
it prints no result line either.

``--profile`` also profiles the last pod tick, the last mixed tick, one
LM prefill step and four decode steps of smollm-135m and of mixtral-8x22b,
one train step of smollm-135m, of yolo-p6-1280, of each vision arch and
of mixtral-8x22b's MoE layer, and one ``gen_fast`` denoise step and one
train step of each diffusion arch:
the card's busy share of each, its host-to-device copies, its top kernels
and the frame loop's kernels among them.

The last lines are the kernels' JSON record (with each kernel's launches
by path: the frame loop of phase 5, the mixed pod of phase 6, the LM of
phase 7, the MoE LM of phase 8, the LM's and the detector's training of
phase 9, the vision serve and train paths of phase 10, the diffusion
serve and train paths of phase 11, the cells of phase 12, the
multi-device path of phase 13, all seven 0 on one card, the serving
policies and the fleet of phase 14, granite of phase 15, and the MoE
training of phase 16, the three paths of phase 17, the cells of phase
18 and qwen3-moe's training of phase 19, all seven 0),
the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import re
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s,
# float32 FLOP/s outside the tensor cores, and the dense bf16 tensor-core
# rate (attention's work is matrix products, which the card runs there)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12

# the reference's bf16 SphIoU gate (tests/test_fused_tick.py): keep flips
# against float32 at most 1%, and none on a row with no IoU pair within
# 0.05 of the 0.6 threshold
BF16_FLIP_BOUND = 0.01
BF16_NEAR_MARGIN = 0.05
# the bf16 SphIoU kernel against its bf16 plain version: both round every
# intermediate to bf16; one float32 ulp of a transcendental can round to
# the other bf16 neighbour, which moves an IoU by a few bf16 ulps
BF16_IOU_ATOL = 2.0 ** -6
# smollm-135m's last-token logits, flash kernel against the chunked plain
# version: both round activations to bf16 in each of 30 layers, at other
# places (the kernel's output once, the chunked version's after its own
# sum order); on the CPU at S=256 the two plain versions differ by 0.031
LM_LOGIT_ATOL = 0.1
# the same under the float32 policy (the SIMT kernel against the chunked
# plain version, TF32 off): only the sums' order differs; on the H100 the
# logits read 2.8e-6 apart
LM_F32_LOGIT_ATOL = 1e-4
# flash attention in bf16 against the float32 plain version rounded to
# bf16: both sum in float32 and round once, so where they agree they
# differ by one bf16 ulp of the value at most (2^-7 of it) plus the
# difference of the two float32 sums.  The check holds
# max(|got - ref| - ATTN_BF16_RTOL |ref|) to ATTN_BF16_ATOL, and also
# holds a control to it, the plain version with one 64-key K/V tile
# dropped, which must fail: a limit that a kernel skipping a tile would
# pass checks nothing.  ATTN_BF16_ATOL is the reference's float32 atol;
# on the H100 the excess read at most 2.6e-7 and the control at least
# 1.3e-3 (at 32k, where one tile is the smallest share of a row)
ATTN_BF16_RTOL = 2.0 ** -7
ATTN_BF16_ATOL = 2e-5
ATTN_DROPPED_TILE = 64

# the pod tick's top batch bucket: the server's and the backend's ladders
MAX_BATCH = 8
# the action head's logits, with the gnomonic sampling kernel against the
# plain projection, both on the card: the crops differ only by the
# sampler's float32 rounding (within 3e-6), which the head's float32
# layers carry through; the CPU parity tests hold the head to the
# reference's within the same 1e-4
ACTION_LOGIT_ATOL = 1e-4

# the kernels and what each replaces in the JAX package
KERNELS = {
    "gnomonic_sample": (
        "src/repro_torch/kernels/gnomonic/csrc/gnomonic.cu",
        "src/repro/kernels/gnomonic/gnomonic.py:123"),
    "project_srois_batched": (
        "src/repro_torch/kernels/gnomonic/csrc/gnomonic.cu",
        "src/repro/kernels/gnomonic/ops.py:80"),
    "sphiou_matrix_batch": (
        "src/repro_torch/kernels/sphiou/csrc/sphiou.cu",
        "src/repro/kernels/sphiou/sphiou.py:120"),
    "greedy_suppress_rows": (
        "src/repro_torch/kernels/nms/csrc/greedy.cu",
        "src/repro/core/sphere.py:417"),
    "sphiou_matrix_batch_bf16": (
        "src/repro_torch/kernels/sphiou/csrc/sphiou.cu",
        "src/repro/kernels/sphiou/sphiou.py:120 (dtype=bfloat16)"),
    "flash_attention": (
        "src/repro_torch/kernels/attention/csrc/attention.cu",
        "src/repro/kernels/attention/attention.py:130"),
    "flash_attention_wgmma": (
        "src/repro_torch/kernels/attention/csrc/attention_wgmma.cu",
        "src/repro/kernels/attention/attention.py:130 (bf16, D 64 and 128)"),
    "groupnorm_mish": (
        "src/repro_torch/kernels/groupnorm/csrc/groupnorm_mish.cu",
        "none: src/repro/models/detector.py:79 _conv_bn's group norm and "
        "Mish, left to XLA"),
}
# the CUDA functions of the frame loop's kernels, as a profile names them
PORT_KERNEL_FUNCTIONS = ("gnomonic_sample_kernel", "project_srois_kernel",
                         "sphiou_self_kernel", "sphiou_cross_kernel",
                         "greedy_", "groupnorm_mish_kernel")
# the kernels the LM serving paths run, dense and MoE (bf16 on the
# tensor-core kernel, the float32 policy on the SIMT one); the frame loop
# runs the others
LM_KERNELS = ("flash_attention", "flash_attention_wgmma")


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


@functools.lru_cache(maxsize=None)
def card_line() -> str:
    """The card's name and power limit (read once: printed beside every
    time)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events).

    A spin kernel ahead of the start event holds the device while the
    host enqueues the calls, so for a function that does not
    synchronise the events see its kernels back to back, not the host's
    launch overhead between them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~30 ms at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def print_ptxas(lines: list[str], kernel: str | tuple[str, ...]) -> None:
    """The ``nvcc -Xptxas -v`` lines of the functions whose mangled name
    holds ``kernel`` (or one of several; registers, spills, shared
    memory), and any warning."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    on = False
    for ln in lines:
        if "Compiling entry function" in ln or "Function properties" in ln:
            on = any(k in ln for k in names)
        elif ln.startswith("ptxas info") and "Used" not in ln:
            on = False
        if on or "warning" in ln.lower():
            print(f"ptxas {ln}")


def check_no_spills(lines: list[str], kernel: str, instances: int) -> None:
    """Every function whose mangled name holds ``kernel`` (``instances``
    of them) compiled with 0 bytes of spill stores and loads."""
    spills, cur = {}, None
    for ln in lines:
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            cur = name if kernel in name else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur:
            spills[cur] = (int(m[1]), int(m[2]))
    check(len(spills) == instances,
          f"ptxas: {len(spills)} {kernel} instances, want {instances}")
    bad = {n: v for n, v in spills.items() if v != (0, 0)}
    check(not bad, f"ptxas: {kernel} spills (stores, loads): {bad}")
    print(f"ptxas: {instances} {kernel} instances, 0 bytes spilled")


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_FLOPS
             ) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def texel_ids(u, v, h: int, w: int):
    """Flat indices of the ERP texels a bilinear pass over maps (u, v)
    reads (with repeats)."""
    import torch

    u0 = torch.remainder(torch.floor(u).long(), w)
    u1 = torch.remainder(u0 + 1, w)
    v0 = torch.clamp(torch.floor(v).long(), 0, h - 1)
    v1 = torch.clamp(v0 + 1, 0, h - 1)
    return torch.cat([(v0 * w + u0).flatten(), (v0 * w + u1).flatten(),
                      (v1 * w + u0).flatten(), (v1 * w + u1).flatten()])


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def check_gnomonic(records: dict) -> None:
    import hashlib

    import torch
    import torch.nn.functional as F

    from repro_torch.core.projection import gnomonic_coords, sample_erp_bilinear
    from repro_torch.kernels.gnomonic import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    h, w, c = 1920, 3840, 3
    erp = torch.rand((h, w, c), generator=gen, device=dev)
    # seam-padded NCHW copy for the library yardstick (F.grid_sample)
    erp_nchw = torch.cat([erp, erp[:, :1]], dim=1).permute(2, 0, 1)[None]
    erp_nchw = erp_nchw.contiguous()
    # the action head's crops (96 and 128), then the detector's
    cases = [("96", (1.2, 0.3), 63, 96), ("128", (-0.7, -0.2), 63, 128),
             ("416", (0.3, 0.2), 60, 416), ("640", (math.pi, -0.4), 75, 640),
             ("1280", (-2.0, 0.1), 100, 1280),
             ("640-pole", (0.0, 1.5), 90, 640)]
    for label, (ct, cp), fov_deg, s in cases:
        fov = (math.radians(fov_deg), math.radians(fov_deg))
        u, v = gnomonic_coords(ct, cp, fov, (s, s), (h, w), dev)
        got = ops.gnomonic_sample(erp, u, v)
        ref = sample_erp_bilinear(erp, u, v)
        err = float((got - ref).abs().max())
        check(bool(torch.allclose(got, ref, atol=3e-6, rtol=1e-5)),
              f"gnomonic_sample {label}: max |err| {err}")
        grid = torch.stack([torch.remainder(u, w) / w * 2 - 1,
                            v / (h - 1) * 2 - 1], dim=-1)[None]
        ms = time_ms(lambda: ops.gnomonic_sample(erp, u, v))
        plain_ms = time_ms(lambda: sample_erp_bilinear(erp, u, v))
        lib_ms = time_ms(lambda: F.grid_sample(
            erp_nchw, grid, mode="bilinear", padding_mode="border",
            align_corners=True))
        # bytes: the distinct texels read, the two maps, the PI written
        n_texels = int(torch.unique(texel_ids(u, v, h, w)).numel())
        n_bytes = n_texels * c * 4 + 2 * s * s * 4 + s * s * c * 4
        b_ms, b_by = bound_ms(n_bytes, s * s * (9 * c + 10))
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"kernel gnomonic_sample {label}: {s}x{s} PI from {h}x{w}x{c} "
              f"f32, max|err| {err:.3g} (tol 3e-6 + 1e-5 rel), "
              f"ms {ms:.4f}, plain_ms {plain_ms:.4f}, library_ms "
              f"{lib_ms:.4f} (F.grid_sample), bound_ms {b_ms:.5f} ({b_by}); "
              f"output sha256 {digest}")
        if label == "1280":
            records["gnomonic_sample"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, shape=f"{s}x{s} from "
                f"{h}x{w}x{c} f32")
    # float16 frames: the kernel blends in f32 and writes f16
    u, v = gnomonic_coords(0.5, 0.2, (1.0, 1.0), (640, 640), (h, w), dev)
    half = erp.half()
    err16 = float((ops.gnomonic_sample(half, u, v).float()
                   - sample_erp_bilinear(half, u, v)).abs().max())
    check(err16 <= 5e-3, f"gnomonic_sample f16: max |err| {err16}")
    print(f"kernel gnomonic_sample f16 640: max|err| {err16:.3g} (tol 5e-3)")


def check_project_srois(records: dict) -> None:
    import hashlib

    import numpy as np
    import torch

    from repro_torch.kernels.gnomonic import ops
    from repro_torch.kernels.gnomonic.ref import (project_sroi_f64,
                                                  project_srois_ref)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    h, w, c = 1920, 3840, 3
    frames = torch.rand((4, h, w, c), generator=gen, device=dev)
    rng = np.random.default_rng(2)
    # the recorded shape, two more, and tick 3's largest chunk (9 crops at
    # 896) and its 416 chunk (9 crops)
    for b, s in ((8, 640), (8, 1280), (4, 416), (9, 896), (9, 416)):
        idx = [i % 4 for i in range(b)]
        # float32 geometry, as both versions read it; |phi| up to 1.4 with
        # FoVs up to 110 degrees puts poles inside some crops
        centers = np.stack([rng.uniform(-math.pi, math.pi, b),
                            rng.uniform(-1.4, 1.4, b)], -1).astype(np.float32)
        fovs = rng.uniform(math.radians(40), math.radians(110),
                           (b, 2)).astype(np.float32)
        got = ops.project_srois_batched(frames, idx, centers, fovs, (s, s))
        ref = project_srois_ref(
            frames, torch.tensor(idx), torch.from_numpy(centers),
            torch.from_numpy(fovs), (s, s))
        err = float((got - ref).abs().max())
        # Tolerance: the two versions fuse the float32 map differently,
        # and at this width (and more so near a pole) a few ulps of (u, v)
        # move a noise frame's PI by more than any fixed bound, so each
        # is held to the crops projected with a float64 map
        # (project_sroi_f64): the kernel may be at most twice as far from
        # it as the plain version, + 5e-5.
        err_k = err_p = 0.0
        for i in range(b):
            exact = project_sroi_f64(frames[idx[i]], float(centers[i, 0]),
                                     float(centers[i, 1]), fovs[i].tolist(), s)
            err_k = max(err_k, float((got[i].double() - exact).abs().max()))
            err_p = max(err_p, float((ref[i].double() - exact).abs().max()))
        # the output's digest: two builds that agree on it agree bit for bit
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
        print(f"kernel project_srois_batched B={b} S={s}: max|kernel - "
              f"plain| {err:.3g}; against the float64 map: kernel "
              f"{err_k:.3g}, plain {err_p:.3g} (tol 2 x plain + 5e-5); "
              f"output sha256 {digest}")
        check(err_k <= 2 * err_p + 5e-5,
              f"project_srois_batched {b}x{s}: {err_k} from the float64 map, "
              f"the plain version {err_p}")
        ms = time_ms(lambda: ops.project_srois_batched(frames, idx, centers,
                                                       fovs, (s, s)), reps=100)
        plain_ms = time_ms(lambda: project_srois_ref(
            frames, torch.tensor(idx), torch.from_numpy(centers),
            torch.from_numpy(fovs), (s, s)), reps=5)
        b_ms, b_by = project_bound(frames, idx, centers, fovs, s)
        print(f"kernel project_srois_batched B={b} S={s}: 4 distinct "
              f"{h}x{w}x{c} frames, ms {ms:.4f}, plain_ms {plain_ms:.4f}, "
              f"library_ms null, bound_ms {b_ms:.5f} ({b_by})")
        if (b, s) == (8, 640):
            records["project_srois_batched"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"B={b} S={s} from 4x{h}x{w}x{c} f32")


def project_bound(frames, idx, centers, fovs, s: int) -> tuple[float, str]:
    """``bound_ms`` of ``project_srois_batched`` on these inputs: the
    distinct texels the crops read (per frame, from the plain version's
    maps), the geometry and the PIs written, against the float32 work of
    the map and the bilinear blend."""
    import torch

    from repro_torch.core.projection import gnomonic_coords

    _, h, w, c = frames.shape
    b = len(idx)
    texels = []
    for i in range(b):
        u, v = gnomonic_coords(float(centers[i][0]), float(centers[i][1]),
                               [float(x) for x in fovs[i]], (s, s), (h, w),
                               frames.device)
        texels.append(texel_ids(u, v, h, w) + idx[i] * h * w)
    n_texels = int(torch.unique(torch.cat(texels)).numel())
    n_bytes = n_texels * c * 4 + b * (4 + 16) + b * s * s * c * 4
    return bound_ms(n_bytes, b * s * s * (60 + 9 * c))


def nms_inputs(b: int, n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    # detection-like SphBBs: clustered around a few objects per row, so
    # suppression has overlaps to remove
    centers = np.stack([rng.uniform(-math.pi, math.pi, (b, 8)),
                        rng.uniform(-1.0, 1.0, (b, 8))], -1)
    pick = rng.integers(0, 8, (b, n))
    ctr = np.take_along_axis(centers, pick[..., None].repeat(2, -1), 1)
    boxes = np.concatenate([ctr + rng.normal(0, 0.03, (b, n, 2)),
                            rng.uniform(0.05, 0.4, (b, n, 2))], -1)
    scores = rng.uniform(0.01, 1.0, (b, n))
    mask = np.arange(n)[None] < rng.integers(n // 2, n + 1, (b, 1))
    boxes[~mask] = 0.0
    return boxes, scores, mask


def check_sphiou_paths(bx, dtype) -> tuple[dict, list[str]]:
    """One SphIoU entry on rows ``bx``: the self path (the tensor twice, as
    NMS calls it) and the general path (a copy), each against its plain
    version and timed; the self path's output must be exactly symmetric.
    Returns the self path's record and the checks that failed, which the
    caller raises after its other shapes' times are printed."""
    import torch

    from repro_torch.kernels.sphiou import ops as iou_ops
    from repro_torch.kernels.sphiou.ref import (sphiou_ref_batch,
                                                sphiou_ref_batch_bf16)

    f32 = dtype == torch.float32
    name = "sphiou_matrix_batch" + ("" if f32 else "_bf16")
    plain = sphiou_ref_batch if f32 else sphiou_ref_batch_bf16
    tol = 5e-6 if f32 else BF16_IOU_ATOL
    b, n, _ = bx.shape
    rec, failed = None, []
    for path, y in (("self", bx), ("cross", bx.clone())):
        got = iou_ops.sphiou_matrix_batch(bx, y, dtype=dtype)
        err = float((got - plain(bx, y)).abs().max())
        if err > tol:
            failed.append(f"{name} {b}x{n} {path} path: max |err| {err}")
        sym = bool(torch.equal(got, got.transpose(1, 2)))
        if path == "self" and not sym:
            failed.append(f"{name} {b}x{n}: the self path is not symmetric")
        ms = time_ms(lambda: iou_ops.sphiou_matrix_batch(bx, y, dtype=dtype))
        plain_ms = time_ms(lambda: plain(bx, y), reps=5)
        # per pair, counted from the source, a transcendental as one
        # operation: one sincos (2), two atan2, two asin, four sin and ~50
        # arithmetic; the self path computes each unordered pair once
        pairs = b * n * (n + 1) // 2 if path == "self" else b * n * n
        b_ms, b_by = bound_ms(b * n * 16 * (1 if path == "self" else 2)
                              + b * n * n * 4, pairs * 60)
        print(f"kernel {name} B={b} N={n} {path} path: max|err| {err:.3g} "
              f"(tol {tol:.3g}), symmetric {sym}, ms {ms:.4f}, plain_ms "
              f"{plain_ms:.4f}, library_ms null, bound_ms {b_ms:.5f} "
              f"({b_by})")
        if path == "self":
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       shape=f"B={b} N={n}, self path")
    return rec, failed


def check_nms(records: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.nms import ops as nms_ops
    from repro_torch.kernels.nms.ref import greedy_suppress_rows_ref
    from repro_torch.kernels.sphiou import ops as iou_ops

    dev = torch.device("cuda")
    failed = []
    # the recorded shapes, then a tick's rows (four streams padded to 128)
    # on the float32 IoU and on the bf16 option's
    for b, n, iou_dtype in ((8, 128, torch.float32), (32, 512, torch.float32),
                            (4, 128, torch.float32), (4, 128, torch.bfloat16)):
        boxes, scores, mask = nms_inputs(b, n, b + n)
        bx = torch.tensor(boxes, dtype=torch.float32, device=dev)
        sc = torch.tensor(scores, dtype=torch.float32, device=dev)
        mk = torch.tensor(mask, device=dev)
        iou = iou_ops.sphiou_matrix_batch(bx, bx, dtype=iou_dtype)
        what = f"B={b} N={n}" + (" (bf16 IoU)" if iou_dtype != torch.float32
                                 else "")
        if iou_dtype == torch.float32:  # the bf16 entry: check_sphiou_bf16
            rec, bad = check_sphiou_paths(bx, torch.float32)
            failed += bad
        keep = nms_ops.greedy_suppress_rows(iou, sc, mk, 0.6)
        keep_ref = greedy_suppress_rows_ref(iou, sc, mk, 0.6)
        check(bool(torch.equal(keep, keep_ref)),
              f"greedy_suppress_rows {what}: keep masks differ")
        g_ms = time_ms(lambda: nms_ops.greedy_suppress_rows(iou, sc, mk, 0.6),
                       reps=100)
        g_plain = time_ms(
            lambda: greedy_suppress_rows_ref(iou, sc, mk, 0.6), reps=5)
        kept = int(keep.sum())
        # this run's data: the kept boxes' IoU rows, plus scores/mask/keep
        gb_ms, gb_by = bound_ms(kept * n * 4 + b * n * 6, kept * n * 3)
        print(f"kernel greedy_suppress_rows {what}: keep masks equal ({kept} "
              f"kept of {int(mask.sum())}), ms {g_ms:.4f}, plain_ms "
              f"{g_plain:.4f}, library_ms null, bound_ms {gb_ms:.6f} "
              f"({gb_by})")
        if (b, n) == (32, 512):
            records["sphiou_matrix_batch"] = rec
            records["greedy_suppress_rows"] = dict(
                max_abs_err=0.0, ms=g_ms, plain_ms=g_plain, bound_ms=gb_ms,
                bound_by=gb_by, library_ms=None, shape=f"B={b} N={n}")
    check(not failed, "; ".join(failed))
    bad = iou_ops.trig_check(dev)
    print(f"sphiou trig premises (sinf odd, cosf even, sincosf equal to "
          f"both, bit for bit): {bad} finite float32 x >= 0 fail")
    check(bad == 0, f"sphiou trig premises fail at {bad} arguments")

    # a tick's rows with NaN scores (argmax ranks NaN above every number,
    # so the reference keeps a NaN-scored box first), +inf, and -0.0
    # beside 0.0 (equal: the lower index first)
    b, n = 4, 128
    boxes, scores, mask = nms_inputs(b, n, 5)
    scores[:, ::9] = np.nan
    scores[:, 4::11] = np.inf
    scores[:, 2::13] = 0.0
    scores[:, 3::13] = -0.0
    bx = torch.tensor(boxes, dtype=torch.float32, device=dev)
    sc = torch.tensor(scores, dtype=torch.float32, device=dev)
    mk = torch.tensor(mask, device=dev)
    iou = iou_ops.sphiou_matrix_batch(bx, bx)
    keep = nms_ops.greedy_suppress_rows(iou, sc, mk, 0.6)
    keep_ref = greedy_suppress_rows_ref(iou, sc, mk, 0.6)
    nan = torch.isnan(sc) & mk
    print(f"kernel greedy_suppress_rows B={b} N={n} with NaN, +inf and "
          f"signed-zero scores: kernel keeps {int(keep.sum())} "
          f"({int((keep & nan).sum())} of {int(nan.sum())} NaN-scored), "
          f"plain version {int(keep_ref.sum())} "
          f"({int((keep_ref & nan).sum())})")
    check(bool(torch.equal(keep, keep_ref)),
          f"greedy_suppress_rows B={b} N={n} with NaN scores: keep masks "
          f"differ")


def bench_box_sets():
    """The reference bench's box sets for the bf16 flip gate
    (``benchmarks/kernels_bench.py``): 10 trials of 8 rows x 24 boxes."""
    import numpy as np

    for trial in range(10):
        rng = np.random.default_rng(trial)
        boxes = np.stack([rng.uniform(-3, 3, (8, 24)),
                          rng.uniform(-1.2, 1.2, (8, 24)),
                          rng.uniform(0.3, 1.2, (8, 24)),
                          rng.uniform(0.3, 1.2, (8, 24))], -1
                         ).astype(np.float32)
        yield boxes, rng.uniform(0.1, 1, (8, 24)).astype(np.float32)


def near_threshold_rows(boxes, thr: float = 0.6):
    """(B,) True where a row holds a pair with float64 IoU within
    ``BF16_NEAR_MARGIN`` of the threshold (self-pairs aside)."""
    import numpy as np

    from repro_torch.core.sphere import sph_iou_matrix_np

    iou = np.stack([sph_iou_matrix_np(r.astype(np.float64),
                                      r.astype(np.float64)) for r in boxes])
    near = np.abs(iou - thr) <= BF16_NEAR_MARGIN
    np.einsum("bii->bi", near)[:] = False
    return near.any(axis=(1, 2))


def check_sphiou_bf16(records: dict) -> None:
    import torch

    from repro_torch.core.sphere import sph_nms_batch
    from repro_torch.kernels.sphiou import ops as iou_ops
    from repro_torch.kernels.sphiou.ref import (sphiou_ref_batch,
                                                sphiou_ref_batch_bf16)

    dev = torch.device("cuda")
    # row 3's inputs, then a tick's rows (four streams padded to 128)
    failed = []
    for b, n in ((32, 512), (4, 128)):
        boxes, _, _ = nms_inputs(b, n, b + n)
        bx = torch.tensor(boxes, dtype=torch.float32, device=dev)
        rec, bad = check_sphiou_paths(bx, torch.bfloat16)
        failed += bad
        if (b, n) != (32, 512):
            continue
        records["sphiou_matrix_batch_bf16"] = rec
        got = iou_ops.sphiou_matrix_batch(bx, bx, dtype=torch.bfloat16)
        exact = sphiou_ref_batch(bx, bx)
        d_kernel = float((got - exact).abs().max())
        d_plain = float((sphiou_ref_batch_bf16(bx, bx) - exact).abs().max())
        print(f"kernel sphiou_matrix_batch_bf16 B={b} N={n}: from the "
              f"float32 IoU: kernel {d_kernel:.3g}, plain {d_plain:.3g}")
    flips = total = far_flips = 0
    for boxes, scores in bench_box_sets():
        k32 = sph_nms_batch(boxes, scores, backend="cuda")
        k16 = sph_nms_batch(boxes, scores, backend="cuda",
                            iou_dtype=torch.bfloat16)
        diff = k32 != k16
        flips += int(diff.sum())
        total += diff.size
        far_flips += int((diff.any(axis=1) & ~near_threshold_rows(boxes)).sum())
    rate = flips / total
    print(f"kernel sphiou_matrix_batch_bf16 keep masks against float32 on the "
          f"reference bench's box sets: {flips} flips of {total} ({rate:.4f}, "
          f"bound {BF16_FLIP_BOUND}), {far_flips} on rows with no pair within "
          f"{BF16_NEAR_MARGIN} of the threshold (bound 0)")
    check(rate <= BF16_FLIP_BOUND and far_flips == 0,
          f"bf16 SphIoU flip gate: rate {rate}, far-row flips {far_flips}")
    records["sphiou_matrix_batch_bf16"]["keep_flip_rate"] = rate
    check(not failed, "; ".join(failed))


def check_groupnorm_mish(records: dict) -> None:
    """The detector's norm-activation tail at yolo-p6-1280's stem and at
    its 20² level: each against the same tail in float64, then its time
    beside the plain composition's (``F.group_norm`` and Mish's three
    kernels, the residual's add) and the bound of one read and one write
    (and one residual read) at the card's memory rate."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.groupnorm import ops
    from repro_torch.kernels.groupnorm.ref import groupnorm_mish_ref
    from repro_torch.models import layers as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    for shape, what in (((8, 64, 640, 640), "p6-1280 stem"),
                        ((8, 1024, 20, 20), "p6-1280 20² level")):
        c = shape[1]
        g = L.num_groups(c)
        x = (torch.randn(shape, generator=gen, device=dev)
             + torch.rand((1, c, 1, 1), generator=gen, device=dev) * 2 - 1)
        scale = torch.rand(c, generator=gen, device=dev) + 0.5
        bias = torch.rand(c, generator=gen, device=dev) - 0.5
        res = torch.randn(shape, generator=gen, device=dev)
        for r in (None, res):
            got = ops.groupnorm_mish(x, scale, bias, residual=r)
            want = groupnorm_mish_ref(x, scale, bias, residual=r)
            y = F.group_norm(x.double(), g, scale.double(), bias.double(),
                             1e-5)
            exact = y * torch.tanh(F.softplus(y))
            if r is not None:
                exact = exact + r.double()
            del y
            err = float((got - want).abs().max())
            err_k = float((got.double() - exact).abs().max())
            err_p = float((want.double() - exact).abs().max())
            del exact, want
            tail = "+ residual" if r is not None else "no residual"
            check(err_k <= 2 * err_p + 1e-6,
                  f"groupnorm_mish {shape} {tail}: {err_k} from float64, the "
                  f"plain version {err_p}")
            ms = time_ms(lambda: ops.groupnorm_mish(x, scale, bias,
                                                    residual=r))
            plain_ms = time_ms(lambda: groupnorm_mish_ref(x, scale, bias,
                                                          residual=r))
            n_bytes = (2 if r is None else 3) * x.numel() * 4
            b_ms, b_by = bound_ms(n_bytes, 0)
            print(f"kernel groupnorm_mish {what} {'x'.join(map(str, shape))} "
                  f"f32, {g} groups ({x.numel() // shape[0] // g} floats a "
                  f"slab), {tail}: max|kernel - plain| {err:.3g}; against "
                  f"float64: kernel {err_k:.3g}, plain {err_p:.3g} (tol 2 x "
                  f"plain + 1e-6); ms {ms:.4f}, plain_ms {plain_ms:.4f}, "
                  f"library_ms null (no one PyTorch call computes it), "
                  f"bound_ms {b_ms:.5f} ({b_by}: {n_bytes / ms / 1e6:.0f} "
                  f"GB/s reached); {card_line()}")
            if r is None:
                records.setdefault("groupnorm_mish", dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None,
                    shape=f"{'x'.join(map(str, shape))} f32, {g} groups"))
        del x, res, got


FLASH_CASES = [  # the reference's (tests/test_kernels.py)
    dict(b=2, sq=64, skv=64, hq=4, hkv=4, d=32, causal=True, window=None),
    dict(b=1, sq=128, skv=128, hq=8, hkv=2, d=64, causal=True, window=None),
    dict(b=1, sq=96, skv=96, hq=2, hkv=2, d=32, causal=True, window=32),
    dict(b=2, sq=1, skv=200, hq=4, hkv=1, d=32, causal=True, window=None),
    dict(b=1, sq=64, skv=64, hq=2, hkv=2, d=32, causal=False, window=None),
    dict(b=1, sq=80, skv=160, hq=2, hkv=2, d=16, causal=True, window=64),
]


def sdpa_call(q, k, v, window: int | None = None):
    """One PyTorch call computing causal GQA attention on (B, S, H, D)
    tensors: the library yardstick, timed only.  With a window, a boolean
    ``attn_mask`` of the causal band (SDPA takes no window of its own), on
    the fused backends only: the math backend would materialise the
    scores."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    i = torch.arange(q.shape[1], device=q.device)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def call():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                                  enable_gqa=True)
    return call


def flash_pairs(s: int, window: int | None = None) -> int:
    """The (query, key) pairs of causal attention over ``s`` tokens that a
    ``window`` (None: none) leaves in: query q sees min(q + 1, window)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_bound(b: int, s: int, hq: int, hkv: int, d: int,
                float32: bool = False, window: int | None = None
                ) -> tuple[float, str]:
    """Causal attention's least time: 4*D operations a (query, key) pair
    in the window at the bf16 tensor-core rate, against q, k, v and the
    output moved once in bf16; for float32, 4-byte elements and the
    float32 rate outside the tensor cores (TF32 would round the inputs)."""
    pairs = b * hq * flash_pairs(s, window)
    elem = 4 if float32 else 2
    n_bytes = elem * d * b * s * (2 * hq + 2 * hkv)
    return bound_ms(n_bytes, 4 * d * pairs,
                    PEAK_F32_FLOPS if float32 else PEAK_BF16_TC_FLOPS)


def attn_excess(got, ref) -> float:
    """How far ``got`` lies outside one bf16 ulp of ``ref``:
    max(|got - ref| - ATTN_BF16_RTOL |ref|), held to ATTN_BF16_ATOL."""
    g, r = got.float(), ref.float()
    return float(((g - r).abs() - ATTN_BF16_RTOL * r.abs()).max())


def attention_rows(q, k, v, *, drop: int | None = None, causal: bool = True,
                   window: int | None = None, q_offset: int = 0,
                   rows: int = 2048):
    """GQA attention in float32, as the plain version computes it, by
    blocks of ``rows`` queries, so the scores of a long sequence fit.
    With ``drop``, the control: blind to keys drop..drop+ATTN_DROPPED_TILE-1,
    as a kernel that skipped that K/V tile would be.  Output in q's
    dtype."""
    import torch

    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    kpos = torch.arange(k.shape[1], device=q.device)
    seen = torch.ones_like(kpos, dtype=torch.bool) if drop is None else \
        (kpos < drop) | (kpos >= drop + ATTN_DROPPED_TILE)
    out = torch.empty_like(q)
    for r0 in range(0, s, rows):
        qb = q[:, r0:r0 + rows].float()
        qpos = q_offset + r0 + torch.arange(qb.shape[1], device=q.device)
        mask = seen[None, :].expand(qb.shape[1], -1)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        sc = torch.einsum("bqhd,bkhd->bhqk", qb, kf) * d ** -0.5
        p = torch.softmax(sc.masked_fill(~mask, -1e30), dim=-1) * mask
        del sc
        out[:, r0:r0 + rows] = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(
            q.dtype)
        del p
    return out


def check_attn_bf16(got, ref, control, what: str) -> str:
    """Hold a bf16 flash output to ATTN_BF16_ATOL past one bf16 ulp of
    the plain version, and check the control fails that limit.  Returns
    the readings, for the printed line."""
    ex, ex_ctl = attn_excess(got, ref), attn_excess(control, ref)
    check(ex <= ATTN_BF16_ATOL,
          f"{what}: |err| exceeds 2^-7 |ref| by {ex}, limit {ATTN_BF16_ATOL}")
    check(ex_ctl > ATTN_BF16_ATOL,
          f"{what}: the control with a K/V tile dropped passes the limit "
          f"({ex_ctl} <= {ATTN_BF16_ATOL})")
    return (f"|err| - 2^-7 |ref| at most {ex:.3g} (limit {ATTN_BF16_ATOL}; "
            f"the control with {ATTN_DROPPED_TILE} keys dropped {ex_ctl:.3g}, "
            f"fails)")


def check_flash(records: dict) -> None:
    import torch

    from repro_torch.kernels.attention import ops
    from repro_torch.kernels.attention.ref import flash_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)

    def qkv(b, sq, skv, hq, hkv, d, dtype):
        return (torch.randn((b, sq, hq, d), generator=gen, device=dev
                            ).to(dtype),
                torch.randn((b, skv, hkv, d), generator=gen, device=dev
                            ).to(dtype),
                torch.randn((b, skv, hkv, d), generator=gen, device=dev
                            ).to(dtype))

    # the reference's six cases: the SIMT kernel in float32 and bf16 at
    # their own head sizes, the tensor-core kernel in bf16 at D=64 and
    # D=128; float32 at the reference's tolerance, bf16 at its 3e-2 and at
    # ATTN_BF16_ATOL past one bf16 ulp; each case with its control
    for kernel, dtype, d in (("simt", torch.float32, None),
                             ("simt", torch.bfloat16, None),
                             ("wgmma", torch.bfloat16, 64),
                             ("wgmma", torch.bfloat16, 128)):
        worst = worst_ex = 0.0
        for c in FLASH_CASES:
            q, k, v = qkv(c["b"], c["sq"], c["skv"], c["hq"], c["hkv"],
                          d or c["d"], dtype)
            kw = dict(causal=c["causal"], window=c["window"],
                      q_offset=c["skv"] - c["sq"] if c["causal"] else 0)
            got = ops.launch(kernel, q, k, v, **kw)
            ref = flash_attention_ref(q, k, v, **kw)
            ctl = attention_rows(q, k, v, drop=c["skv"] // 2, **kw)
            err = float((got.float() - ref.float()).abs().max())
            worst = max(worst, err)
            what = f"{ops.KERNELS[kernel].name} {dtype} case {c} at D={d}"
            if dtype == torch.float32:
                check(bool(torch.allclose(got, ref, atol=2e-5, rtol=1e-4)),
                      f"{what}: max |err| {err}")
                check(not torch.allclose(ctl, ref, atol=2e-5, rtol=1e-4),
                      f"{what}: the control passes")
            else:
                check(err <= 3e-2, f"{what}: max |err| {err}")
                check_attn_bf16(got, ref, ctl, what)
                worst_ex = max(worst_ex, attn_excess(got, ref))
        tol = ("atol 2e-5 + rtol 1e-4" if dtype == torch.float32 else
               f"atol 3e-2; |err| - 2^-7 |ref| at most {worst_ex:.3g}, limit "
               f"{ATTN_BF16_ATOL}")
        print(f"kernel {ops.KERNELS[kernel].name} {str(dtype)[6:]}: the "
              f"reference's six cases at "
              f"{'their head sizes' if d is None else f'D={d}'}, max|err| "
              f"{worst:.3g} ({tol}); each case's control fails")

    # the main path's shape: smollm-135m's 4 x 2048 prefill, one layer, in
    # float32 at the reference's tolerance (the SIMT kernel), then in bf16
    # through both kernels against one bf16 ulp of the plain version, with
    # the control beside it
    # in float32 (the SIMT kernel): smollm-135m's 4 x 2048 and the float32
    # policy's LM prefill (phase 7, 1 x 2048), the shape the SIMT kernel
    # serves on a path.  Each is checked, launched twice (the outputs must
    # be bit-equal: the kernel combines a row tile's split in a fixed
    # order), then the kernel, SDPA in float32 (TF32 off, as the port's
    # policy sets it) and the plain version are timed in turn
    b, s, hq, hkv, d = 4, 2048, 9, 3, 64
    q, k, v = qkv(b, s, s, hq, hkv, d, torch.float32)
    ctl = attention_rows(q, k, v, drop=s // 2)
    for bb in (b, 1):
        q1, k1, v1 = (x[:bb].contiguous() for x in (q, k, v))
        got = ops.flash_attention(q1, k1, v1, causal=True)
        again = ops.flash_attention(q1, k1, v1, causal=True)
        ref = flash_attention_ref(q1, k1, v1, causal=True)
        err1 = float((got - ref).abs().max())
        shape = f"B={bb} S={s} Hq={hq} Hkv={hkv} D={d} float32 causal"
        check(bool(torch.allclose(got, ref, atol=2e-5, rtol=1e-4)),
              f"flash_attention {shape}: max |err| {err1}")
        check(bool(torch.equal(got, again)),
              f"flash_attention {shape}: two launches differ")
        ctl_err = float((ctl[:bb] - ref).abs().max())
        check(not torch.allclose(ctl[:bb], ref, atol=2e-5, rtol=1e-4),
              f"flash_attention {shape}: the control passes")
        ms = time_ms(lambda: ops.flash_attention(q1, k1, v1, causal=True))
        lib = sdpa_call(q1, k1, v1)
        lib_ms = time_ms(lib)
        plain_ms = time_ms(
            lambda: flash_attention_ref(q1, k1, v1, causal=True), reps=5)
        again_ms = time_ms(
            lambda: ops.flash_attention(q1, k1, v1, causal=True))
        b_ms, b_by = flash_bound(bb, s, hq, hkv, d, float32=True)
        lib_err = float((got - lib().transpose(1, 2)).abs().max())
        print(f"kernel flash_attention {shape}: max|err| {err1:.3g} (atol "
              f"2e-5 + rtol 1e-4; the control with {ATTN_DROPPED_TILE} keys "
              f"dropped {ctl_err:.3g}, fails; against SDPA {lib_err:.3g}); "
              f"two launches bit-equal; ms {ms:.4f} (again {again_ms:.4f}), "
              f"plain_ms {plain_ms:.4f}, library_ms {lib_ms:.4f} (SDPA "
              f"float32, TF32 off), bound_ms {b_ms:.5f} ({b_by}); kernel / "
              f"bound {ms / b_ms:.2f}x, kernel / SDPA {ms / lib_ms:.2f}x")
        del q1, k1, v1, lib
    records["flash_attention"] = dict(
        max_abs_err=err1, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, shape=shape)

    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    ref = flash_attention_ref(q, k, v, causal=True)
    ctl = attention_rows(q, k, v, drop=s // 2)
    lib = sdpa_call(q, k, v)
    lib_out = lib().transpose(1, 2).float()
    shape = f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 causal"
    for kernel in ("wgmma", "simt"):
        name = ops.KERNELS[kernel].name
        got = ops.launch(kernel, q, k, v, causal=True)
        err = float((got.float() - ref.float()).abs().max())
        check(err <= 3e-2, f"{name} smollm shape: max |err| {err}")
        readings = check_attn_bf16(got, ref, ctl, f"{name} smollm shape bf16")
        lib_err = float((got.float() - lib_out).abs().max())
        print(f"kernel {name} {shape}: max|err| {err:.3g} (tol 3e-2), "
              f"{readings}; against SDPA {lib_err:.3g}")
        if kernel == "wgmma":  # the SIMT kernel's record: float32, above
            records[name] = dict(max_abs_err=err, shape=shape)
    # times in turn in one call: tensor-core, SIMT, SDPA, plain, and the
    # tensor-core kernel again (its spread)
    times = {}
    for kernel in ("wgmma", "simt"):
        times[kernel] = time_ms(lambda: ops.launch(kernel, q, k, v,
                                                   causal=True))
    lib_ms = time_ms(lib)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                       reps=5)
    again = time_ms(lambda: ops.launch("wgmma", q, k, v, causal=True))
    b_ms, b_by = flash_bound(b, s, hq, hkv, d)
    records["flash_attention_wgmma"].update(
        ms=times["wgmma"], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms)
    print_flash_times(shape, times, lib_ms, b_ms, b_by, plain_ms, again)

    # the 32k prefill's shape (one layer, B=1).  The plain version would
    # materialise ~39 GB of scores, so here the tensor-core kernel is held
    # to the SIMT kernel (both sum in float32 and round once) with the
    # control beside it, and in the LM phase to the chunked plain version
    s = 32768
    q, k, v = qkv(1, s, s, hq, hkv, d, torch.bfloat16)
    lib = sdpa_call(q, k, v)
    got = ops.launch("wgmma", q, k, v, causal=True)
    simt = ops.launch("simt", q, k, v, causal=True)
    lib_err = float((got.float() - lib().transpose(1, 2).float()).abs().max())
    readings = check_attn_bf16(got, simt,
                               attention_rows(q, k, v, drop=s // 2),
                               f"flash_attention_wgmma S={s} against SIMT")
    del simt
    print(f"kernel flash_attention_wgmma B=1 S={s} Hq={hq} Hkv={hkv} D={d} "
          f"bf16 causal, against the SIMT kernel: {readings}; against SDPA "
          f"max|err| {lib_err:.3g}")
    times = {kernel: time_ms(lambda: ops.launch(kernel, q, k, v,
                                                causal=True),
                             reps=3, warmup=1)
             for kernel in ("wgmma", "simt")}
    lib_ms = time_ms(lib, reps=3, warmup=1)
    again = time_ms(lambda: ops.launch("wgmma", q, k, v, causal=True),
                    reps=3, warmup=1)
    b_ms, b_by = flash_bound(1, s, hq, hkv, d)
    print_flash_times(f"B=1 S={s} Hq={hq} Hkv={hkv} D={d} bf16 causal",
                      times, lib_ms, b_ms, b_by, None, again)
    del q, k, v, lib, got
    for layout in FLASH_D128_LAYOUTS:
        check_flash_layout(qkv, *layout)


# the tensor-core kernel at D=128 on the MoE path's layouts (phase 8):
# mixtral-8x22b's prefill (2 x 8192 tokens, a group of 6, a 4096-token
# window: the window's edge and the skip of tiles behind it) and
# granite-34b's MQA (48 query heads on one KV head)
FLASH_D128_LAYOUTS = [
    ("mixtral-8x22b", 2, 8192, 48, 8, 128, 4096),
    ("granite-34b", 1, 4096, 48, 1, 128, None),
]


def check_flash_layout(qkv, name: str, b: int, s: int, hq: int, hkv: int,
                       d: int, window: int | None) -> None:
    """The tensor-core kernel at one layout, bf16: held to the plain
    version (by blocks of query rows: at B=2 and S=8192 its scores would
    take 25.8 GB) with the control, which drops a tile inside the window
    of the last rows; then the kernel, SDPA and the plain version at B=1
    timed in turn, and the kernel again."""
    import torch

    from repro_torch.kernels.attention import ops
    from repro_torch.kernels.attention.ref import flash_attention_ref

    q, k, v = qkv(b, s, s, hq, hkv, d, torch.bfloat16)
    kw = dict(causal=True, window=window)
    got = ops.launch("wgmma", q, k, v, **kw)
    ref = attention_rows(q, k, v, **kw)
    err = float((got.float() - ref.float()).abs().max())
    readings = check_attn_bf16(
        got, ref, attention_rows(q, k, v, drop=s - (window or s) // 2, **kw),
        f"flash_attention_wgmma at {name}'s layout")
    del ref
    lib = sdpa_call(q, k, v, window)
    lib_err = float((got.float() - lib().transpose(1, 2).float()).abs().max())
    win = f"window {window}" if window else "no window"
    shape = f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 causal, {win}"
    print(f"kernel flash_attention_wgmma {shape} ({name}): max|err| "
          f"{err:.3g}, {readings}; against SDPA {lib_err:.3g}")
    ms = time_ms(lambda: ops.launch("wgmma", q, k, v, **kw), reps=10)
    lib_ms = time_ms(lib, reps=10)
    q1, k1, v1 = q[:1], k[:1], v[:1]
    plain_ms = time_ms(lambda: flash_attention_ref(q1, k1, v1, **kw),
                       reps=2, warmup=1)
    again = time_ms(lambda: ops.launch("wgmma", q, k, v, **kw), reps=10)
    b_ms, b_by = flash_bound(b, s, hq, hkv, d, window=window)
    print(f"flash times {shape} ({name}): tensor-core kernel {ms:.4f} ms "
          f"(again {again:.4f}), SDPA {lib_ms:.4f} "
          f"({'a boolean band mask' if window else 'is_causal'}), plain "
          f"{plain_ms:.4f} at B=1, bound {b_ms:.5f} ({b_by}; "
          f"{b * hq * flash_pairs(s, window) / 1e9:.3f} G pairs); "
          f"tensor-core / SDPA {ms / lib_ms:.2f}x, tensor-core / bound "
          f"{ms / b_ms:.1f}x")


def print_flash_times(shape: str, times: dict, lib_ms: float, b_ms: float,
                      b_by: str, plain_ms: float | None, again: float
                      ) -> None:
    ms, simt_ms = times["wgmma"], times["simt"]
    plain = "" if plain_ms is None else f", plain {plain_ms:.4f}"
    print(f"flash times {shape}: tensor-core kernel {ms:.4f} ms (again "
          f"{again:.4f}), SIMT kernel {simt_ms:.4f}, SDPA {lib_ms:.4f}"
          f"{plain}, bound {b_ms:.5f} ({b_by}); SIMT / tensor-core "
          f"{simt_ms / ms:.2f}x, tensor-core / SDPA {ms / lib_ms:.2f}x, "
          f"tensor-core / bound {ms / b_ms:.1f}x")


# --------------------------------------------------------------------------
# phases 4-5: the loop
# --------------------------------------------------------------------------


def make_loops(backend, videos, n_categories: int, n_variants: int,
               explore_costs, budget_s: float = 2.0):
    from repro_torch.core.omnisense import OmniSenseLoop
    from repro_torch.serving import profiles
    from repro_torch.serving.network import NetworkModel
    from repro_torch.serving.scheduler import OmniSenseLatencyModel

    variants = profiles.make_ladder(n_categories=n_categories)[:n_variants]
    lat = OmniSenseLatencyModel(profiles.paper_profile(), NetworkModel())
    loops = []
    for video in videos:
        loop = OmniSenseLoop(variants, lat, backend, budget_s=budget_s,
                             n_categories=n_categories,
                             explore_costs=explore_costs)
        # bootstrap the history with frame 0's objects (a full-ERP pass)
        loop.seed_history(video.visible_objects(0))
        loops.append(loop)
    return variants, loops


def check_small_input() -> None:
    """The per-request path on the card against the same path on the
    CPU (the plain versions), on a small input."""
    import dataclasses

    import torch

    from repro_torch.data.synthetic import make_video, render_erp
    from repro_torch.models import detector as det_mod
    from repro_torch.serving.scheduler import TorchDetectorBackend

    cfgs = [dataclasses.replace(det_mod.PAPER_LADDER[i], input_size=64,
                                n_classes=16) for i in (0, 1)]
    params = [det_mod.init_params(torch.Generator().manual_seed(i), c)
              for i, c in enumerate(cfgs)]
    gpu = TorchDetectorBackend(cfgs, params, conf=0.01, max_det=4)
    cpu = TorchDetectorBackend(cfgs, params, conf=0.01, max_det=4,
                               device="cpu")
    video = make_video(n_frames=4, n_objects=20, seed=7)
    _, (g_loop,) = make_loops(gpu, [video], 16, 2, [0.1, 0.2])
    _, (c_loop,) = make_loops(cpu, [video], 16, 2, [0.1, 0.2])
    frame = render_erp(video, 1, height=192, width=384)
    g_pend, c_pend = g_loop.begin_frame(frame), c_loop.begin_frame(frame)
    check([(r.region.center, r.variant.name) for r in g_pend.requests]
          == [(r.region.center, r.variant.name) for r in c_pend.requests]
          and g_pend.requests, "small input: plans differ or are empty")
    worst = dict(pi=0.0, heads=0.0, scores=0.0)
    with torch.inference_mode():
        for req in g_pend.requests:
            cfg = cfgs[req.variant.index - 1]
            s = cfg.input_size
            g_pi = gpu._project(frame, req.region, s)
            c_pi = cpu._project(frame, req.region, s)
            worst["pi"] = max(worst["pi"], float((g_pi.cpu() - c_pi).abs().max()))
            check(bool(torch.allclose(g_pi.cpu(), c_pi, atol=5e-5)),
                  "small input: PIs differ")
            p_idx = req.variant.index - 1
            g_heads = det_mod.apply(gpu.params[p_idx], c_pi[None].cuda(), cfg)
            c_heads = det_mod.apply(cpu.params[p_idx], c_pi[None], cfg)
            for g, c in zip(g_heads, c_heads):
                worst["heads"] = max(worst["heads"],
                                     float((g.cpu() - c).abs().max()))
                check(bool(torch.allclose(g.cpu(), c, atol=1e-3, rtol=1e-3)),
                      "small input: detector heads differ")
            g_sc = sorted(d.score for d in gpu.infer_sroi(frame, req.region,
                                                          req.variant))
            c_sc = sorted(d.score for d in cpu.infer_sroi(frame, req.region,
                                                          req.variant))
            check(len(g_sc) == len(c_sc), "small input: detection counts")
            if g_sc:
                worst["scores"] = max(worst["scores"], max(
                    abs(a - b) for a, b in zip(g_sc, c_sc)))
    check(worst["scores"] <= 1e-3, "small input: detection scores differ")
    print(f"small input (192x384, 64 px PIs, {len(g_pend.requests)} "
          f"requests): card vs CPU max|err| PI {worst['pi']:.3g} (tol 5e-5), "
          f"heads {worst['heads']:.3g} (tol 1e-3 + 1e-3 rel), sorted scores "
          f"{worst['scores']:.3g} (tol 1e-3)")


def phase_ms(tick) -> tuple[float, float]:
    """The drain's and the ingestion's wall ms in pod tick ``tick``, from
    the server's own spans (``repro_torch.tracing``; ``PodServer.step``
    numbers its tick by the frame it serves)."""
    from repro_torch import tracing

    totals = tracing.tick_totals(tick)
    return tuple(totals.get(name, (0.0,))[0] * 1e3
                 for name in ("drain", "ingest"))


def tick_server(loops, backends, **kw):
    """A ``PodServer`` that records ``_suppress_tick``'s inputs
    (``tick``), through an override that calls the server's own method:
    the raw row lengths, the padding decision, and the padded rows as
    the server builds them, with the float32 keep mask it applied, for
    the bf16 SphIoU flip check."""
    import numpy as np

    from repro_torch.core.sphere import nms_auto_backend, pad_detection_rows
    from repro_torch.serving.server import PodServer

    class TickServer(PodServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.tick = None

        def _suppress_tick(self, plans):
            raw = [len(res.detections) for _, res in plans]
            live = [res for _, res in plans if res.detections]
            rows = [list(res.detections) for res in live]
            pad = self.buckets.pad_nms_rows
            nms = nms_auto_backend(len(plans),
                                   pad(max(map(len, rows), default=0)))
            boxes, scores, mask = (
                pad_detection_rows(rows, pad_n=pad, total_rows=len(plans))
                if nms == "cuda" else pad_detection_rows(rows))
            wall = super()._suppress_tick(plans)
            keep = np.zeros(mask.shape, bool)
            for r, (res, row) in enumerate(zip(live, rows)):
                kept = {id(d) for d in res.detections}
                keep[r, :len(row)] = [id(d) in kept for d in row]
            self.tick = dict(raw=raw, backend=nms, boxes=boxes, scores=scores,
                             mask=mask, keep=keep)
            return wall

    return TickServer(loops, backends, **kw)


def per_variant_requests(server, n_timelines: int) -> dict:
    """The requests per variant of the server's timelines from
    ``n_timelines`` on (a tick's)."""
    out: dict = {}
    for tl in server.timelines[n_timelines:]:
        for ev in tl.events:
            out[ev.variant] = out.get(ev.variant, 0) + ev.b
    return out


def check_detections(results) -> int:
    import numpy as np

    n = 0
    for res in results:
        for d in res.detections:
            check(np.shape(d.box) == (4,) and bool(np.isfinite(d.box).all())
                  and math.isfinite(d.score), "a detection is not finite")
            n += 1
    return n


def ladder_params() -> tuple[list, list]:
    """The five-rung ``PAPER_LADDER`` and its seeded weights on the card."""
    import torch

    from repro_torch.models import detector as det_mod

    cfgs = list(det_mod.PAPER_LADDER)
    return cfgs, [det_mod.init_params(torch.Generator().manual_seed(100 + i),
                                      c, device="cuda")
                  for i, c in enumerate(cfgs)]


def ladder_backend(params):
    """``TorchDetectorBackend`` over the ladder, as the pod tick serves it
    (its crop cache and staging of its own)."""
    from repro_torch.models import detector as det_mod
    from repro_torch.serving.batching import ShapeBuckets
    from repro_torch.serving.scheduler import TorchDetectorBackend

    cfgs = list(det_mod.PAPER_LADDER)
    return TorchDetectorBackend(
        cfgs, params, conf=0.01, max_det=16,
        buckets=ShapeBuckets.for_max_batch(
            MAX_BATCH, tuple(sorted({c.input_size for c in cfgs}))))


def run_main_path(profile: bool = False) -> tuple[dict, list]:
    """Phase 5; returns the launches and the ladder's parameters (the
    mixed pod of phase 6 serves the same detectors)."""
    import numpy as np
    import torch

    from repro_torch.core.sphere import sph_nms_batch
    from repro_torch.data.synthetic import make_video, render_erp
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    cfgs, params = ladder_params()
    backend = ladder_backend(params)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"main path: PAPER_LADDER {[c.input_size for c in cfgs]} px, "
          f"{n_params / 1e6:.1f}M parameters, 80 classes, init "
          f"{time.perf_counter() - t0:.1f}s")
    h, w = 1920, 3840
    counts = {}

    # -- per-request path: one stream, two frames --------------------------
    video = make_video(n_frames=8, n_objects=20, seed=11)
    _, (loop,) = make_loops(backend, [video], 80, 5, None)
    frames = [render_erp(video, f, height=h, width=w) for f in (1, 2)]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for f, frame in zip((1, 2), frames):
        t = time.perf_counter()
        res = loop.process_frame(frame)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        n = check_detections([res])
        print(f"per-request frame {f}: {len(res.srois)} SRoIs, plan "
              f"{res.plan.models if res.plan else None}, {n} detections "
              f"after NMS, wall ms {ms:.1f}")
    # every rung of the ladder, at its published input size, on one SRoI
    # of the last frame (the allocator need not have chosen every rung)
    check(bool(res.srois), "the last per-request frame had no SRoI")
    region = res.srois[0]
    for variant in loop.variants:
        t = time.perf_counter()
        dets = backend.infer_sroi(frames[-1], region, variant)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        check(all(np.shape(d.box) == (4,) and bool(np.isfinite(d.box).all())
                  and math.isfinite(d.score) for d in dets),
              f"a {variant.name} detection is not finite")
        print(f"per-request {variant.name} "
              f"({cfgs[variant.index - 1].input_size} px): {len(dets)} "
              f"detections, wall ms {ms:.1f}")
    counts["per_request"] = _build.launch_counts()
    print(f"per-request launches: {counts['per_request']}")

    # -- the pod tick: four streams, three frames, through PodServer.step ----
    videos = [make_video(n_frames=8, n_objects=20, seed=s)
              for s in (21, 22, 23, 24)]
    _, loops = make_loops(backend, videos, 80, 5, None)
    ticks = {f: [render_erp(v, f, height=h, width=w) for v in videos]
             for f in (1, 2, 3)}
    server = tick_server(loops, [backend] * len(loops), max_batch=MAX_BATCH,
                         buckets=backend.buckets,
                         frame_source=lambda s, f: ticks[f][s])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    total_dets = 0
    for f in (1, 2, 3):
        # the last tick runs under the profiler when asked (--profile)
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if profile and f == 3 else contextlib.nullcontext())
        uploads, hits = backend.frame_uploads, backend.crop_cache_hits
        n_timelines = len(server.timelines)
        with prof:
            t = time.perf_counter()
            server.step(f)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        rec = server.tick
        check(not rec["keep"][~rec["mask"]].any(), "NMS kept a padded entry")
        # the bf16 SphIoU option on the tick's own padded rows, outside the
        # tick's timing: its keep flips against the float32 suppression
        keep16 = sph_nms_batch(rec["boxes"], rec["scores"], rec["mask"],
                               backend="cuda", iou_dtype=torch.bfloat16)
        check(not keep16[~rec["mask"]].any(), "bf16 NMS kept a padded entry")
        flips16 = int((keep16 != rec["keep"]).sum())
        results = [loop._history[-1] for loop in loops]
        n = check_detections([types.SimpleNamespace(detections=r)
                              for r in results])
        total_dets += n
        per_variant = per_variant_requests(server, n_timelines)
        drain, ingest = phase_ms(f)
        print(f"tick {f}: requests per variant {per_variant}, detections "
              f"{rec['raw']} -> {[len(r) for r in results]}, wall ms "
              f"{wall:.1f} (emission {wall - drain - ingest:.1f}, drain "
              f"{drain:.1f}, ingest {ingest:.1f}); frame uploads "
              f"{backend.frame_uploads - uploads}, crop-cache hits "
              f"{backend.crop_cache_hits - hits}; NMS {rec['backend']} on "
              f"rows {rec['boxes'].shape[0]}x{rec['boxes'].shape[1]}; bf16 "
              f"SphIoU option: {flips16} keep flips of {int(rec['mask'].sum())}"
              f" boxes")
        check(backend.frame_uploads - uploads == len(videos),
              f"tick {f} uploaded {backend.frame_uploads - uploads} frames, "
              f"not one a stream ({len(videos)})")
        check(not backend._staged, "a staged frame outlived its tick")
        if profile and f == 3:
            print_profile(prof, wall)
    counts["batched"] = _build.launch_counts()
    print(f"pod tick launches: {counts['batched']}; crop cache "
          f"{backend.crop_cache_hits} hits / {backend.crop_cache_misses} "
          f"misses; {backend.trace_count} (variant, batch) shapes; "
          f"{server.stats.frames} frames, {server.stats.dispatches} "
          f"dispatches, incremental NMS {server._nms_inc.hits} row hits / "
          f"{server._nms_inc.misses} misses")
    check(total_dets > 0, "the pod ticks produced no detections")
    launches = {k: counts["per_request"].get(k, 0) + counts["batched"].get(k, 0)
                for k in KERNELS if k not in LM_KERNELS}
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    return launches, params


# --------------------------------------------------------------------------
# phase 6: the mixed detection + action pod, then replay and fleet
# --------------------------------------------------------------------------


def count_launches_of(obj, method: str, into: dict) -> None:
    """Wrap ``obj.method`` so that the kernel launches made inside it are
    added to ``into`` (the launches of one backend, apart from the
    others that share the global counts)."""
    from repro_torch.kernels import _build

    inner = getattr(obj, method)

    def counted(*args, **kwargs):
        before = _build.launch_counts()
        try:
            return inner(*args, **kwargs)
        finally:
            for k, n in _build.launch_counts().items():
                into[k] = into.get(k, 0) + n - before.get(k, 0)

    setattr(obj, method, counted)


def check_action_rungs(act_cfgs, act_params, buckets, frame, regions) -> None:
    """Every ``ACTION_LADDER`` rung at its published shape, a batch of 8,
    through ``infer_srois_batched`` twice on the card: with the gnomonic
    sampling kernel and with the plain projection.  The logits of the
    two agree within ``ACTION_LOGIT_ATOL``, their categories are equal,
    and each kernel crop is held to the float64 map as
    ``check_project_srois`` holds the batched projection."""
    import numpy as np
    import torch

    from repro_torch.kernels.gnomonic.ref import project_sroi_f64
    from repro_torch.models import action as act_mod
    from repro_torch.serving.tasks import TorchActionBackend, action_ladder

    kern = TorchActionBackend(act_cfgs, act_params, buckets=buckets)
    plain = TorchActionBackend(act_cfgs, act_params, buckets=buckets,
                               use_kernel=False)
    items = [(frame, r) for r in regions]
    # the frame staged once, as a tick stages it (unstaged, every crop
    # would upload its 88.5 MB frame anew, as the reference's backend does)
    kern.stage_frames([frame])
    plain.stage_frames([frame])
    device_frame = torch.from_numpy(frame).cuda()
    for variant, cfg in zip(action_ladder(), act_cfgs):
        idx = variant.index - 1
        # a full window: clip_len frames of the same regions
        t = time.perf_counter()
        for f in range(cfg.clip_len):
            kern.set_frame(f)
            got = kern.infer_srois_batched(items, variant)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / cfg.clip_len
        for f in range(cfg.clip_len):
            plain.set_frame(f)
            want = plain.infer_srois_batched(items, variant)
        check(len(got) == 8 and all(len(d) == 1 for d in got),
              f"{variant.name}: not one prediction an item")
        keys = [(idx, round(r.center[0], 1), round(r.center[1], 1))
                for r in regions]
        k_clips = torch.stack([torch.stack(kern._clips[k]) for k in keys])
        p_clips = torch.stack([torch.stack(plain._clips[k]) for k in keys])
        check(tuple(k_clips.shape) == (8, cfg.clip_len, cfg.input_size,
                                       cfg.input_size, 3),
              f"{variant.name}: batch shape {tuple(k_clips.shape)}")
        with torch.inference_mode():
            k_logits = act_mod.apply(kern.params[idx], k_clips, cfg)
            p_logits = act_mod.apply(plain.params[idx], p_clips, cfg)
        check(bool(torch.isfinite(k_logits).all()),
              f"{variant.name}: logits not finite")
        err = float((k_logits - p_logits).abs().max())
        crop_err = float((k_clips - p_clips).abs().max())
        err_k = err_p = 0.0
        for r, kc, pc in zip(regions, k_clips[:, -1], p_clips[:, -1]):
            exact = project_sroi_f64(device_frame, r.center[0], r.center[1],
                                     r.fov, cfg.input_size)
            err_k = max(err_k, float((kc.double() - exact).abs().max()))
            err_p = max(err_p, float((pc.double() - exact).abs().max()))
        check([d[0].category for d in got] == [d[0].category for d in want],
              f"{variant.name}: categories differ with the plain projection")
        check(err <= ACTION_LOGIT_ATOL,
              f"{variant.name}: logits {err} from the plain projection's")
        check(err_k <= 2 * err_p + 5e-5,
              f"{variant.name}: crops {err_k} from the float64 map, the "
              f"plain projection {err_p}")
        print(f"action rung {variant.name}: batch 8 x {cfg.clip_len} x "
              f"{cfg.input_size}^2 x 3, wall ms {ms:.2f} a batch (8 crops "
              f"and the forward); kernel "
              f"vs plain projection: crops max|err| {crop_err:.3g}, logits "
              f"max|err| {err:.3g} (tol {ACTION_LOGIT_ATOL}), categories "
              f"equal; against the float64 map: kernel {err_k:.3g}, plain "
              f"{err_p:.3g} (tol 2 x plain + 5e-5)")
    check(kern.frame_uploads == plain.frame_uploads == 1,
          "the rungs' batches uploaded their frame more than once")
    kern.release_frames()
    plain.release_frames()


def action_params(act_cfgs) -> list:
    """The action rungs' seeded weights on the card."""
    import torch

    from repro_torch.models import action as act_mod

    return [act_mod.init_params(torch.Generator().manual_seed(200 + i), c,
                                device="cuda")
            for i, c in enumerate(act_cfgs)]


def mixed_streams(det_params, act_params, seeds, n_frames: int,
                  act_launches: dict | None = None):
    """4 mixed streams (``stream_tasks_for("mixed", 4)``) on synthetic
    1920x3840 video from ``seeds``, built through the task registry
    (``build_task_streams``) and served by the real backends: the
    detection streams by one ``TorchDetectorBackend`` on the full
    ``PAPER_LADDER``, the action streams by one ``TorchActionBackend`` on
    ``default_action_configs()``; the action path's launches counted apart
    into ``act_launches``.  Returns (tasks, videos, loops, backends,
    buckets, detection backend, action backend)."""
    from repro_torch.data.synthetic import make_video
    from repro_torch.models import detector as det_mod
    from repro_torch.serving.scheduler import TorchDetectorBackend
    from repro_torch.serving.tasks import (TorchActionBackend,
                                           build_task_streams,
                                           default_action_configs,
                                           shape_buckets_for,
                                           stream_tasks_for)

    tasks = stream_tasks_for("mixed", 4)
    videos = [make_video(n_frames=n_frames, n_objects=20, seed=s)
              for s in seeds]
    _, loops, _, _ = build_task_streams(tasks, videos, [2.0] * len(tasks))
    buckets = shape_buckets_for(tasks, MAX_BATCH)
    det = TorchDetectorBackend(list(det_mod.PAPER_LADDER), det_params,
                               conf=0.01, max_det=16, buckets=buckets)
    act = TorchActionBackend(default_action_configs(), act_params,
                             buckets=buckets)
    if act_launches is not None:
        count_launches_of(act, "infer_srois_batched", act_launches)
    backends = [det if t == "detection" else act for t in tasks]
    # the registry's loops, served by the real backends
    for loop, backend, video in zip(loops, backends, videos):
        loop.backend = backend
        loop.seed_history(video.visible_objects(0))
    return tasks, videos, loops, backends, buckets, det, act


def run_mixed_path(det_params, profile: bool = False) -> dict:
    """The mixed pod: 2 detection streams on the full ``PAPER_LADDER``
    and 2 action streams on the four ``ACTION_LADDER`` rungs, 3 ticks
    through ``PodServer.step``; then every action rung at batch 8.
    Returns the launches of the ticks."""
    import torch

    from repro_torch.core.sroi import SRoI
    from repro_torch.data.synthetic import render_erp
    from repro_torch.kernels import _build
    from repro_torch.serving.tasks import (default_action_configs,
                                           task_for_variant)

    t0 = time.perf_counter()
    act_cfgs = default_action_configs()
    act_params = action_params(act_cfgs)
    act_launches: dict = {}
    tasks, videos, loops, backends, buckets, det, act = mixed_streams(
        det_params, act_params, (31, 32, 33, 34), 8, act_launches)
    h, w = 1920, 3840
    ticks = {f: [render_erp(v, f, height=h, width=w) for v in videos]
             for f in (1, 2, 3)}
    server = tick_server(loops, backends, max_batch=MAX_BATCH,
                         buckets=buckets,
                         frame_source=lambda s, f: ticks[f][s])
    print(f"mixed pod: streams {tasks}; detection PAPER_LADDER "
          f"{[c.input_size for c in det.cfgs]} px, action "
          f"{[(c.name, c.clip_len, c.input_size) for c in act_cfgs]} "
          f"(d_model {act_cfgs[0].d_model}, {act_cfgs[0].n_layers} layer, "
          f"{act_cfgs[0].n_heads} heads), set-up "
          f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    n_actions = 0
    for f in (1, 2, 3):
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if profile and f == 3 else contextlib.nullcontext())
        uploads = (det.frame_uploads, act.frame_uploads)
        act_gs = act_launches.get("gnomonic_sample", 0)
        n_timelines = len(server.timelines)
        with prof:
            t = time.perf_counter()
            server.step(f)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        rec = server.tick
        check(not rec["keep"][~rec["mask"]].any(), "NMS kept a padded entry")
        results = [loop._history[-1] for loop in loops]
        check_detections([types.SimpleNamespace(detections=r)
                          for r in results])
        per_variant = {f"{task_for_variant(v)}/{v}": n for v, n in
                       per_variant_requests(server, n_timelines).items()}
        preds = [(d.category, round(d.score, 3)) for s, r in
                 enumerate(results) if tasks[s] != "detection" for d in r]
        n_actions += len(preds)
        up = (det.frame_uploads - uploads[0], act.frame_uploads - uploads[1])
        drain, ingest = phase_ms(f)
        print(f"mixed tick {f}: wall ms {wall:.1f} (emission "
              f"{wall - drain - ingest:.1f}, drain {drain:.1f}, ingest "
              f"{ingest:.1f}); requests per (task, variant) {per_variant}; "
              f"action predictions (class, score) {preds}; detections "
              f"{rec['raw']} -> {[len(r) for r in results]}; frame uploads "
              f"{sum(up)} (detection {up[0]}, action {up[1]}); action "
              f"gnomonic_sample launches "
              f"{act_launches.get('gnomonic_sample', 0) - act_gs}; NMS "
              f"{rec['backend']} on rows {rec['boxes'].shape[0]}x"
              f"{rec['boxes'].shape[1]}")
        check(up == (2, 2), f"mixed tick {f} uploaded {up} frames, not one "
              f"a stream")
        check(not det._staged and not act._staged,
              "a staged frame outlived its tick")
        if profile and f == 3:
            print_profile(prof, wall, what="mixed tick 3")
    launches = _build.launch_counts()
    print(f"mixed pod launches: {launches}; of them the action path's "
          f"{act_launches}; {server.stats.frames_by_task} frames by task, "
          f"{server.stats.dispatches} dispatches")
    check(n_actions > 0, "the action streams predicted nothing")
    check(act_launches.get("gnomonic_sample", 0) > 0,
          "the action path did not launch gnomonic_sample")
    check(launches.get("project_srois_batched", 0) > 0,
          "the detection streams did not launch project_srois_batched")
    # every rung at its published shape, batch 8, on an action stream's
    # tick-3 frame (the allocator need not have chosen every rung)
    regions = [SRoI(center=(-2.9 + 0.75 * k, 0.35 * math.sin(k)),
                    fov=(1.1, 0.9)) for k in range(8)]
    check_action_rungs(act_cfgs, act_params, buckets, ticks[3][1], regions)
    return launches


def run_replay_lane() -> None:
    """The replay-determinism lane and the fleet, on the oracle backends
    (host only): three corpora recorded with ``repro_torch.launch.replay
    record`` and re-driven with ``check``, each of which must be
    bit-identical, then the serve launcher's mixed-task 2-pod fleet."""
    import io
    import shutil

    from repro_torch.launch import replay as replay_cli
    from repro_torch.launch import serve

    out_dir = ROOT / "build" / "chip_smoke_replay"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    corpora = {
        "closed": ["--streams", "8", "--policy", "async", "--pod-allocate"],
        "mixed": ["--streams", "8", "--open-loop", "--tasks", "mixed",
                  "--slo", "2.0", "--admission", "slo"],
        "fleet": ["--streams", "8", "--open-loop", "--pods", "2",
                  "--routing", "affinity"],
    }
    for name, args in corpora.items():
        path = str(out_dir / f"{name}.jsonl")
        t = time.perf_counter()
        for argv in (["record", "--out", path] + args, ["check", path]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = replay_cli.main(argv)
            lines = buf.getvalue().splitlines()
            for line in lines:
                print(f"replay {name} ({argv[0]}): {line}")
            check(rc == 0, f"replay {argv[0]} of the {name} corpus exited "
                  f"{rc}")
        check(len(lines) == 1 and "bit-identical" in lines[0],
              f"the {name} corpus did not replay bit-identically")
        print(f"replay {name}: {(time.perf_counter() - t) * 1e3:.0f} ms "
              f"wall (record and check)")
    shutil.rmtree(out_dir)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--open-loop", "--pods", "2", "--tasks", "mixed"])
    lines = buf.getvalue().splitlines()
    check(bool(lines) and lines[0].startswith("fleet [least-loaded routing, "
                                              "2 pods]"),
          f"serve launcher fleet: {lines[:1]}")
    for line in lines:
        print(f"serve launcher (oracle, --open-loop --pods 2 --tasks mixed):"
              f" {line}")


# --------------------------------------------------------------------------
# phase 7: the LM serving path
# --------------------------------------------------------------------------


def serve_lm(params, prefill, decode, tokens, n_dec: int, what: str):
    """A batch of prompts through ``prefill`` and ``n_dec`` greedy
    ``decode`` steps, timed; the logits must be finite and the cache as
    long as the prompt and the steps.  Returns (the prefill's logits, the
    generated tokens (B, n_dec), prefill ms, decode ms a token, the last
    step's output)."""
    import torch

    b, s = tokens.shape
    t = time.perf_counter()
    out = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    logits = out["logits"].clone()
    finite = torch.isfinite(logits).all()
    token, generated = logits.argmax(-1), []
    t = time.perf_counter()
    for _ in range(n_dec):
        generated.append(token)
        out = decode(params, {"token": token, "cache_k": out["k"],
                              "cache_v": out["v"], "cache_len": out["length"]})
        finite &= torch.isfinite(out["logits"]).all()
        token = out["logits"].argmax(-1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / max(n_dec, 1)
    check(bool(finite), f"{what}: non-finite logits")
    check(int(out["length"]) == s + n_dec, f"{what}: cache length")
    gen = torch.stack(generated, 1) if generated else tokens[:, :0]
    return logits, gen, prefill_ms, decode_ms, out


def tokens_digest(gen) -> str:
    import hashlib

    return hashlib.sha256(gen.cpu().numpy().astype("int64").tobytes()
                          ).hexdigest()[:16]


def against_chunked(params, cfg, tokens, logits, max_len: int, what: str,
                    routes: list | None = None) -> None:
    """The prefill's ``logits`` against the same step under
    ``attention_impl="chunked"``, within ``LM_LOGIT_ATOL``.  With the
    flash run's MoE ``routes`` the chunked run's are compared too: where a
    token's experts or drops differ the logits are printed, not held."""
    import dataclasses

    from repro_torch.training.steps import lm_prefill_step

    chunked = dataclasses.replace(cfg, attention_impl="chunked")
    routes_c: list = []
    ref = lm_prefill_step(chunked, max_len, routes_c)(
        params, {"tokens": tokens})["logits"]
    err = float((logits - ref).abs().max())
    agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    moved = [int(((a.expert_ids != c.expert_ids) | (a.keep != c.keep))
                 .any(dim=1).sum()) for a, c in zip(routes or [], routes_c)]
    line = (f"{what} prefill logits against attention_impl=chunked: max|err| "
            f"{err:.3g}, next-token agreement {agree:.2f}")
    if any(moved):
        print(f"{line}; not held to {LM_LOGIT_ATOL}: tokens whose experts or "
              f"drops differ, by layer: {moved}")
        return
    agreed = "; every layer's experts and drops agree" if routes else ""
    print(f"{line} (tol {LM_LOGIT_ATOL}{agreed})")
    check(err <= LM_LOGIT_ATOL, f"{what} logits against chunked: {err}")


def run_lm_path(profile: bool = False) -> dict:
    import dataclasses

    import torch

    from repro_torch.configs import smollm_135m
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    from repro_torch.models import layers as L
    from repro_torch.training.steps import lm_decode_step, lm_prefill_step

    t0 = time.perf_counter()
    cfg = dataclasses.replace(smollm_135m.full_config(),
                              attention_impl="flash")
    dev = torch.device("cuda")
    params = T.init_params(torch.Generator(device=dev).manual_seed(12), cfg,
                           device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"LM path: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e6:.1f}M bf16 parameters (random, seeded), "
          f"attention_impl=flash, init {time.perf_counter() - t0:.1f}s")
    b, s, n_dec = 4, 2048, 32
    s_long = LM_SHAPES["prefill_32k"].seq_len
    tok_gen = torch.Generator(device=dev).manual_seed(13)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=tok_gen,
                           device=dev)
    long_tokens = torch.randint(0, cfg.vocab_size, (1, s_long),
                                generator=tok_gen, device=dev)
    prefill = lm_prefill_step(cfg, s + n_dec)
    decode = lm_decode_step(cfg)
    prefill(params, {"tokens": tokens[:, :256]})  # warm-up: handles, library
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    logits, gen, prefill_ms, decode_ms, out = serve_lm(
        params, prefill, decode, tokens, n_dec, "the LM path")
    t = time.perf_counter()
    long_out = lm_prefill_step(cfg, s_long)(params, {"tokens": long_tokens})
    torch.cuda.synchronize()
    long_ms = (time.perf_counter() - t) * 1e3
    launches = _build.launch_counts()
    check(bool(torch.isfinite(long_out["logits"]).all()),
          "the LM path's long prefill gave non-finite logits")
    digest = tokens_digest(gen)
    print(f"LM prefill B={b} S={s}: {prefill_ms:.1f} ms for the step, "
          f"prefill ms per request {prefill_ms / b:.1f}")
    print(f"LM decode B={b}, {n_dec} greedy steps after the {s}-token "
          f"prompt: decode ms per token {decode_ms:.2f}")
    print(f"LM generated tokens (B={b} x {n_dec}) sha256 {digest}; first "
          f"row {gen[0, :8].tolist()}")
    print(f"LM prefill B=1 S={s_long} (prefill_32k's length; its batch of "
          f"32 cut to 1 for the smoke's time): prefill ms per request "
          f"{long_ms:.1f}")
    print(f"LM launches: {launches} over 2 prefill calls of {cfg.n_layers} "
          f"layers ({cfg.n_layers} a call)")
    check(launches.get("flash_attention_wgmma", 0) == 2 * cfg.n_layers,
          f"flash_attention_wgmma launched "
          f"{launches.get('flash_attention_wgmma', 0)} times on the LM path, "
          f"not {2 * cfg.n_layers}")
    check(launches.get("flash_attention", 0) == 0,
          f"the SIMT flash_attention launched "
          f"{launches.get('flash_attention', 0)} times on the bf16 LM path")

    # comparisons, after the counts are read: the same step under the
    # chunked plain version, and layer 0's attention at 32k
    chunked = dataclasses.replace(cfg, attention_impl="chunked")
    against_chunked(params, cfg, tokens, logits, s + n_dec,
                    f"LM B={b} S={s}")
    check_each_layer(params, cfg, tokens, "LM")
    with torch.no_grad():
        lp = T._layer_params(params, 0)
        x = L.embedding(params["embed"], long_tokens, cfg.policy)
        q, k, v = T._qkv(lp, x, cfg, torch.arange(s_long, device=dev))
        a_flash = T.attention(q, k, v, cfg, causal=True)
        a_ref = T.attention(q, k, v, chunked, causal=True)
        err0 = float((a_flash.float() - a_ref.float()).abs().max())
        readings = check_attn_bf16(
            a_flash, a_ref, attention_rows(q, k, v, drop=s_long // 2),
            f"LM prefill S={s_long} layer 0 attention")
    print(f"LM prefill S={s_long} layer-0 attention against the chunked "
          f"plain version: max|err| {err0:.3g}, {readings}")
    if profile:
        profile_lm(prefill, decode, params, tokens)
    del params, long_out, out
    launches.update(run_lm_float32(cfg, tokens[:1]))
    return {k: launches.get(k, 0) for k in LM_KERNELS}


def check_each_layer(params, cfg, tokens, what: str, rows: int = 2048,
                     at_layer0=None):
    """Each layer's attention (``attention_impl="flash"``) on the chunked
    step's own activations against the chunked plain version, within one
    bf16 ulp and ATTN_BF16_ATOL, with the control at layer 0: a K/V tile
    dropped inside the window of the last rows (``rows`` query rows a
    block).  ``at_layer0(lp, x, attn_out, cfg)``, if given, also runs at
    layer 0; its result is returned."""
    import dataclasses

    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    b, s = tokens.shape
    chunked = dataclasses.replace(cfg, attention_impl="chunked")
    kw = dict(causal=True, window=cfg.window)
    worst, worst_at, extra = -1.0, 0, None
    with torch.no_grad():
        x = L.embedding(params["embed"], tokens, cfg.policy)
        positions = torch.arange(s, device=tokens.device)
        for i in range(cfg.n_layers):
            lp = T._layer_params(params, i)
            q, k, v = T._qkv(lp, x, cfg, positions)
            a_ref = T.attention(q, k, v, chunked, **kw)
            a_flash = T.attention(q, k, v, cfg, **kw)
            if i == 0:
                drop = s - (cfg.window or s) // 2
                readings = check_attn_bf16(
                    a_flash, a_ref,
                    attention_rows(q, k, v, drop=drop, rows=rows, **kw),
                    f"{what} prefill B={b} S={s} layer 0 attention")
                if at_layer0 is not None:
                    extra = at_layer0(lp, x, a_flash, cfg)
            ex = attn_excess(a_flash, a_ref)
            if ex > worst:
                worst, worst_at = ex, i
            x, _ = T._finish_block(lp, x, a_ref, chunked)
    print(f"{what} prefill B={b} S={s} attention of each of {cfg.n_layers} "
          f"layers against the chunked plain version: |err| - 2^-7 |ref| at "
          f"most {worst:.3g}, at layer {worst_at} (limit {ATTN_BF16_ATOL}); "
          f"layer 0: {readings}")
    check(worst <= ATTN_BF16_ATOL,
          f"{what} prefill attention of layer {worst_at} against chunked: "
          f"|err| exceeds 2^-7 |ref| by {worst}")
    return extra


def run_lm_float32(cfg, tokens) -> dict:
    """The same model under the float32 policy (the reference's float32
    path, whose attention the SIMT kernel serves): one prefill, counted on
    its own, held to the chunked plain version's logits."""
    import dataclasses

    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    from repro_torch.training.steps import lm_prefill_step

    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(12),
                           cfg32, device="cuda")
    b, s = tokens.shape
    prefill = lm_prefill_step(cfg32, s)
    prefill(params, {"tokens": tokens[:, :256]})  # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})["logits"]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = _build.launch_counts()
    chunked = dataclasses.replace(cfg32, attention_impl="chunked")
    ref = lm_prefill_step(chunked, s)(params, {"tokens": tokens})["logits"]
    check(bool(torch.isfinite(logits).all()),
          "the float32 LM prefill gave non-finite logits")
    err = float((logits - ref).abs().max())
    print(f"LM float32 policy prefill B={b} S={s}: {ms:.1f} ms; logits "
          f"against attention_impl=chunked max|err| {err:.3g} (tol "
          f"{LM_F32_LOGIT_ATOL}); launches {launches}")
    check(err <= LM_F32_LOGIT_ATOL,
          f"float32 LM logits against chunked: {err}")
    check(launches == {"flash_attention": cfg.n_layers},
          f"the float32 LM prefill launched {launches}, not "
          f"{cfg.n_layers} of the SIMT flash_attention")
    return launches


# --------------------------------------------------------------------------
# phase 8: the MoE LM serving path
# --------------------------------------------------------------------------

# phase 8's runs: (config module, layers kept of the published depth,
# batch, prompt tokens, greedy decode steps, and the prompt tokens of the
# decode-against-prefill check, 0 for none)
MOE_RUNS = (("mixtral_8x22b", 8, 2, 8192, 32, 0),
            ("qwen3_moe_235b_a22b", 2, 1, 4096, 16, 1024))
# layer 0's MoE block against the per-token float32 formulation over the
# prompt's first MOE_CHECK_TOKENS tokens.  The formulation rounds the
# SwiGLU's hidden to bf16 where the reference's function does
# (``hidden.astype(cdt)``) and keeps the rest in float32; the block also
# rounds each pick's expert output, its gate and the gated product, and
# each of the k - 1 additions, by at most MOE_U relatively each (bf16's
# unit roundoff).  Hence |got - ref| <= MOE_U ((k + 2) sum_j |c_j| +
# rms(ref)) per element, c_j the picks' float32 contributions (the rms
# term covers the float32 sums' order); a control with one kept pick
# zeroed must fail it
MOE_U = 2.0 ** -8
MOE_CHECK_TOKENS = 1024


def check_moe_block(lp, x, attn_out, cfg) -> str:
    """Layer 0's MoE block on the card (``moe_block``: the dispatch, the
    grouped products, the combine) against a per-token float32
    formulation on the card, from the same bf16 input and weights: for
    each kept (token, expert) pick of the block's routing, the gate times
    that expert's SwiGLU of the token; a dropped pick gives 0.  Returns
    the readings, for the printed line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    b, s, d = x.shape
    moe = lp["moe"]
    xa = x + L.dense({"w": lp["attn"]["wo"]},
                     attn_out.reshape(b, s, cfg.n_heads * cfg.d_head),
                     cfg.policy)
    h2 = L.rmsnorm(lp["ln2"], xa, cfg.norm_eps).reshape(b * s, d)
    routes = []
    got = T.moe_block(moe, h2, cfg, routes)[0][:MOE_CHECK_TOKENS].float()
    n = got.shape[0]
    ids, keep = routes[0].expert_ids[:n], routes[0].keep[:n]
    probs = torch.softmax(L.dense({"w": moe["router"]}, h2[:n],
                                  cfg.policy).float(), dim=-1)
    gates = probs.gather(1, ids)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    h = h2[:n].float()

    def swiglu(e, tok):
        wg, wu, wd = (moe[w][e].float() for w in ("w_gate", "w_up", "w_down"))
        hid = (F.silu(h[tok] @ wg) * (h[tok] @ wu)).to(cfg.compute_dtype)
        return hid.float() @ wd

    ref = torch.zeros((n, d), device=x.device)
    mag = torch.zeros((n, d), device=x.device)  # sum_j |c_j|
    for e in range(cfg.n_experts):
        tok, j = ((ids == e) & keep).nonzero(as_tuple=True)
        if len(tok):
            c = gates[tok, j, None] * swiglu(e, tok)
            ref.index_add_(0, tok, c)
            mag.index_add_(0, tok, c.abs())
    bound = MOE_U * ((cfg.moe_top_k + 2) * mag + ref.pow(2).mean().sqrt())

    def excess(want):
        return float(((got - want).abs() / bound).max())

    ex = excess(ref)
    # the control: the kept pick with the largest gate zeroed
    tok, j = divmod(int(torch.where(keep, gates, -1.0).argmax()), ids.shape[1])
    ctl = ref.clone()
    ctl[tok] -= gates[tok, j] * swiglu(int(ids[tok, j]), [tok])[0]
    ex_ctl = excess(ctl)
    what = f"{cfg.name} layer-0 MoE block over {n} tokens"
    check(ex <= 1.0, f"{what}: |err| exceeds its bound {ex} times")
    check(ex_ctl > 1.0, f"{what}: the control with a kept pick zeroed "
          f"passes ({ex_ctl} <= 1)")
    return (f"max |err| / (2^-8 ((k + 2) sum_j |c_j| + rms(ref))) {ex:.3g} "
            f"(limit 1; the control with the pick of token {tok}, gate "
            f"{float(gates[tok, j]):.3f}, zeroed {ex_ctl:.3g}, fails); "
            f"{int(keep.sum())} kept picks, {int((~keep).sum())} dropped")


def routes_by_layer(routes: list, n_layers: int) -> list[list]:
    """The :class:`Routing` records of successive calls, by layer."""
    return [routes[i::n_layers] for i in range(n_layers)]


def serve_moe(cfg, b: int, s: int, n_dec: int, full_layers: int,
              profile: bool, check_prompt: int = 0) -> dict:
    """One MoE model through ``lm_prefill_step`` (and ``n_dec`` greedy
    ``lm_decode_step``s), launches counted from 0 before and read after;
    then the comparisons; returns the launches."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    from repro_torch.training.steps import lm_decode_step, lm_prefill_step

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(21), cfg,
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    gbytes = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    print(f"MoE path: {cfg.name}, {cfg.n_layers} of its {full_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.d_head}, {cfg.n_experts} experts top-"
          f"{cfg.moe_top_k}, d_ff_expert {cfg.d_ff_expert}, window "
          f"{cfg.window}, vocab {cfg.vocab_size}: {n_params / 1e9:.2f}B bf16 "
          f"parameters ({gbytes:.1f} GB; random, seeded), "
          f"attention_impl=flash, init {time.perf_counter() - t0:.1f}s")
    tok_gen = torch.Generator(device=dev).manual_seed(22)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=tok_gen,
                           device=dev)
    routes_p, routes_d = [], []
    prefill = lm_prefill_step(cfg, s + n_dec, routes_p)
    decode = lm_decode_step(cfg, routes_d)
    prefill(params, {"tokens": tokens[:, :256]})  # warm-up: handles, library
    torch.cuda.synchronize()
    routes_p.clear()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launch_counts()
    logits, gen, prefill_ms, decode_ms, out = serve_lm(
        params, prefill, decode, tokens, n_dec, f"the {cfg.name} MoE path")
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"MoE {cfg.name} prefill B={b} S={s}: {prefill_ms:.1f} ms for the "
          f"step, prefill ms per request {prefill_ms / b:.1f}; peak device "
          f"memory {peak_gb:.1f} GB")
    drops = [int(sum((~r.keep).sum() for r in rs))
             for rs in routes_by_layer(routes_p, cfg.n_layers)]
    print(f"MoE {cfg.name} prefill tokens dropped per layer (of {b * s} x "
          f"{cfg.moe_top_k} picks, capacity {T.moe_capacity(cfg, b * s)} an "
          f"expert): {drops}")
    if n_dec:
        digest = tokens_digest(gen)
        drops = [int(sum((~r.keep).sum() for r in rs))
                 for rs in routes_by_layer(routes_d, cfg.n_layers)]
        print(f"MoE {cfg.name} decode B={b}, {n_dec} greedy steps after the "
              f"{s}-token prompt (positions {s}..{s + n_dec - 1}, ring slots "
              f"pos % {out['k'].shape[2]}): decode ms per token "
              f"{decode_ms:.2f}; {card_line()}")
        print(f"MoE {cfg.name} generated tokens (B={b} x {n_dec}) sha256 "
              f"{digest}; first row {gen[0, :8].tolist()}")
        print(f"MoE {cfg.name} decode tokens dropped per layer over {n_dec} "
              f"steps (of {b} x {cfg.moe_top_k} picks a step, capacity "
              f"{T.moe_capacity(cfg, b)} an expert): {drops}")
    print(f"MoE {cfg.name} launches: {launches} over one prefill call of "
          f"{cfg.n_layers} layers (decode attends with plain einsums)")

    # comparisons, after the counts are read: the same step under the
    # chunked plain version, with its routing
    against_chunked(params, cfg, tokens, logits, s + n_dec,
                    f"MoE {cfg.name}", routes=routes_p)
    moe_readings = check_each_layer(params, cfg, tokens, f"MoE {cfg.name}",
                                    rows=512, at_layer0=check_moe_block)
    print(f"MoE {cfg.name} layer-0 MoE block against the per-token float32 "
          f"formulation: {moe_readings}")
    if check_prompt:
        check_moe_decode(params, cfg, tokens, check_prompt)
    if profile and n_dec:
        profile_lm(prefill, decode, params, tokens)
    return launches


def run_moe_path(profile: bool = False) -> dict:
    """Phase 8: the MoE models at published widths, depth cut to fit one
    card (``MOE_RUNS``), bf16 weights from a seeded generator,
    ``attention_impl="flash"`` (the tensor-core kernel at D=128).

    Cuts (``reduced``): mixtral-8x22b 56 -> 8 layers (a layer is 5.01 GB
    in bf16, 4.83 GB of it experts: 56 layers would take 281 GB), and
    ``prefill_32k``'s 32 x 32768 prompts -> 2 x 8192 (the grouped
    buffers grow with the tokens: 40960 grouped rows at capacity 5120 an
    expert; still two windows of 4096, so the window's mask and the
    kernel's skip of the tiles behind it both act), then 32 greedy decode
    steps at B=2; qwen3-moe-235b-a22b 94 -> 2 layers (12.4 GB with the
    embeddings), one 1 x 4096 prefill (capacity 320, 40960 grouped
    rows), then 16 greedy decode steps at B=1 (capacity 1 an expert: the
    top-8 picks of one token are distinct experts, so none drops).  Launch counts are set to 0 before each model's path and read
    after it: the tensor-core kernel once a layer of each prefill, the
    SIMT kernel never."""
    import dataclasses
    import importlib

    import torch

    torch.cuda.empty_cache()  # phase 7's parameters are freed
    launches: dict = {}
    for module, n_layers, b, s, n_dec, check_prompt in MOE_RUNS:
        full = importlib.import_module(f"repro_torch.configs.{module}"
                                       ).full_config()
        cfg = dataclasses.replace(full, n_layers=n_layers,
                                  attention_impl="flash")
        got = serve_moe(cfg, b, s, n_dec, full.n_layers, profile,
                        check_prompt)
        torch.cuda.empty_cache()  # its parameters are freed
        check(got.get("flash_attention_wgmma", 0) == n_layers,
              f"flash_attention_wgmma launched "
              f"{got.get('flash_attention_wgmma', 0)} times on {cfg.name}'s "
              f"path, not {n_layers}")
        check(got.get("flash_attention", 0) == 0,
              f"the SIMT flash_attention launched "
              f"{got.get('flash_attention', 0)} times on {cfg.name}'s path")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
    return {k: launches.get(k, 0) for k in LM_KERNELS}


# --------------------------------------------------------------------------
# phase 9: training
# --------------------------------------------------------------------------

# smollm-135m's train step: train_4k's sequence, its global batch of 256
# cut to TRAIN_BATCH (one card, and neither package accumulates
# gradients), TRAIN_STEPS steps, an async checkpoint after TRAIN_SAVE_AT
TRAIN_BATCH, TRAIN_STEPS, TRAIN_SAVE_AT = 8, 6, 3
# step 1's per-token NLL (the terms whose mean is its loss) under the bf16
# policy against the float32 policy on the same (widened) weights: mean
# |difference|.  bf16 rounds ~10 activations a layer at 2^-9 relative;
# over 30 layers the final hidden state drifts by a few percent, which
# moves a logit (std ~0.6 at these random weights) and so a token's NLL
# by a few hundredths.  The control (targets shifted by one token)
# changes each token's picked logit, by ~0.6 on average
TRAIN_NLL_ATOL = 0.1
# the detector's train step: the ladder's top rung, float32, TF32 off
DET_TRAIN_BATCH, DET_TRAIN_STEPS, DET_TRAIN_MAX_GB = 8, 3, 60.0


def bits(t):
    """``t``'s bits as an integer tensor (bit-for-bit comparisons)."""
    import torch

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()])


def token_nll(params, batch, cfg):
    """Each token's NLL (``lm_loss``'s CE terms, no aux), no grad."""
    import torch

    from repro_torch.models import transformer as T

    with torch.no_grad():
        hidden, _ = T.forward(params, batch["tokens"], cfg)
        w32 = params["unembed"]["w"].to(cfg.compute_dtype).float()
        out = []
        for lo in range(0, hidden.shape[1], cfg.ce_chunk):
            logits = hidden[:, lo:lo + cfg.ce_chunk].float() @ w32
            t = batch["targets"][:, lo:lo + cfg.ce_chunk].long()
            out.append(torch.logsumexp(logits, -1)
                       - logits.gather(-1, t[..., None])[..., 0])
    return torch.cat(out, 1)


def check_policy_nll(params, batch, cfg, what: str) -> None:
    """The per-token NLL of ``batch`` under ``cfg``'s bf16 policy against
    the float32 policy's on the widened weights (freed before the
    control): mean |diff| within ``TRAIN_NLL_ATOL``, which the control
    (the targets shifted by one token) must fail."""
    import dataclasses

    import torch

    from repro_torch import pytree

    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    nll = token_nll(params, batch, cfg)
    nll32 = token_nll(pytree.tree_map(lambda t: t.float(), params), batch,
                      cfg32)
    shifted = dict(batch, targets=batch["targets"].roll(1, 1))
    nll_ctl = token_nll(params, shifted, cfg)
    err = float((nll - nll32).abs().mean())
    ctl = float((nll_ctl - nll32).abs().mean())
    print(f"{what}: bf16 per-token NLL (mean {float(nll.mean()):.6f}) "
          f"against the float32 policy's (mean {float(nll32.mean()):.6f}): "
          f"mean |diff| {err:.4g}, max {float((nll - nll32).abs().max()):.4g}"
          f" (limit {TRAIN_NLL_ATOL}); the control with the targets shifted "
          f"by one token {ctl:.4g}")
    check(err <= TRAIN_NLL_ATOL, f"{what}: NLL against float32: {err}")
    check(ctl > TRAIN_NLL_ATOL,
          f"the shifted-target control passed the NLL check: {ctl}")


def check_grads(grads, groups: dict, what: str) -> None:
    """Every leaf of ``grads`` finite; each named group's non-zero."""
    import torch

    from repro_torch import pytree

    bad = [i for i, g in enumerate(pytree.leaves(grads))
           if not bool(torch.isfinite(g).all())]
    check(not bad, f"{what}: non-finite gradient leaves {bad}")
    zero = [k for k, g in groups.items() if not bool((g != 0).any())]
    print(f"{what} gradients: {len(pytree.leaves(grads))} leaves finite; "
          f"{len(groups) - len(zero)} of {len(groups)} groups non-zero"
          + (f" (zero: {zero})" if zero else ""))
    check(not zero, f"{what}: zero gradients in {zero}")


def timed_steps(step, state, batches, what: str, unit: str, per_step: int
                ) -> tuple:
    """Runs ``step`` over ``batches``; prints each step's ms (host clock,
    ended by ``torch.cuda.synchronize()``), ``unit``/s, loss and grad
    norm.  Returns (state, losses)."""
    import torch

    losses, norms = [], []
    for batch in batches:
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        print(f"{what} step {int(m['step'])}: {ms:.1f} ms, "
              f"{per_step / ms * 1e3:.0f} {unit}/s, loss {losses[-1]:.6f}, "
              f"grad norm {norms[-1]:.6f}")
    check(all(math.isfinite(x) for x in losses + norms),
          f"{what}: non-finite loss or grad norm {losses} {norms}")
    return state, losses


def run_train_path(profile: bool = False) -> tuple[dict, dict]:
    """Phase 9; returns the launches of the LM train path and of the
    detector's."""
    import torch

    from repro_torch.kernels import _build

    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    run_lm_train(profile)
    lm = _build.launch_counts()
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    run_detector_train(profile)
    det = _build.launch_counts()
    print(f"train launches: LM {lm}, detector {det}")
    check(not lm and not det, "a training path launched a kernel, which "
          "has no backward")
    return lm, det


def run_lm_train(profile: bool) -> None:
    """smollm-135m at published widths (bf16, ``chunked`` attention,
    remat, ``ce_chunk`` 512) trains ``TRAIN_STEPS`` steps of ``adamw(lr=
    1e-3, warmup_steps=10)`` on ``lm_batches`` through ``Prefetcher``;
    ``save_async`` after step ``TRAIN_SAVE_AT``, restored into a fresh
    ``make_state`` template, which runs the later steps again."""
    import tempfile

    import torch

    from repro_torch import pytree
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import smollm_135m
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.data.pipeline import Prefetcher, lm_batches
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod

    cfg = smollm_135m.full_config()
    dev = torch.device("cuda")
    b, s = TRAIN_BATCH, LM_SHAPES["train_4k"].seq_len
    opt = opt_mod.adamw(lr=1e-3, warmup_steps=10)
    params = T.init_params(torch.Generator(device=dev).manual_seed(20), cfg,
                           device=dev)
    print(f"train path: {cfg.name}, {cfg.n_layers} layers, bf16, "
          f"attention_impl={cfg.attention_impl}, remat={cfg.remat}, "
          f"ce_chunk {cfg.ce_chunk}; batch {b} x {s} (train_4k's global "
          f"batch {LM_SHAPES['train_4k'].global_batch} cut to {b}: one "
          f"card, no gradient accumulation), adamw lr 1e-3 warmup 10")
    batches = [pytree.tree_map(lambda v: torch.as_tensor(v, device=dev), x)
               for x in Prefetcher(lm_batches(cfg.vocab_size, b, s, seed=0,
                                              n_batches=TRAIN_STEPS))]

    # (a) the gradient of every parameter group, at the initial weights
    loss0, grads = steps_mod.value_and_grad(
        lambda p: T.lm_loss(p, batches[0], cfg), params)
    lyr = grads["layers"]
    groups = {"embed": grads["embed"]["emb"], "ln_f": grads["ln_f"]["scale"],
              "unembed": grads["unembed"]["w"]}
    for i in (0, cfg.n_layers - 1):
        for part, keys in (("attn", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("w_gate", "w_up", "w_down")),
                           ("ln1", ("scale",)), ("ln2", ("scale",))):
            for k in keys:
                groups[f"layer{i}.{part}.{k}"] = lyr[part][k][i]
    check_grads(grads, groups, "smollm-135m")
    del grads, lyr, groups

    state = steps_mod.make_state(params, opt)
    step = steps_mod.lm_train_step(cfg, opt)
    mgr = CheckpointManager(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, losses = timed_steps(
        step, state, batches[:TRAIN_SAVE_AT], "smollm-135m train",
        "tokens", b * s)
    saved = state
    mgr.save_async(TRAIN_SAVE_AT, saved)
    state, more = timed_steps(
        step, state, batches[TRAIN_SAVE_AT:], "smollm-135m train", "tokens",
        b * s)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"smollm-135m train: peak memory {peak:.2f} GB; step 1 loss "
          f"{losses[0]:.6f} (the gradient check's {float(loss0):.6f})")
    losses += more

    # (b) step 1's per-token NLL against the float32 policy's, and the
    # control with the targets shifted by one token
    check_policy_nll(params, batches[0], cfg,
                     f"{cfg.name} step 1 loss {losses[0]:.6f}")

    # (c) the restored state equals the saved one bit for bit
    mgr.wait()
    template = steps_mod.make_state(
        T.init_params(torch.Generator(device=dev).manual_seed(21), cfg,
                      device=dev), opt)
    restored = mgr.restore(TRAIN_SAVE_AT, template)
    got, want = pytree.leaves(restored), pytree.leaves(saved)
    same = sum(g.dtype == w.dtype and bool(torch.equal(bits(g), bits(w)))
               for g, w in zip(got, want))
    print(f"smollm-135m checkpoint at step {TRAIN_SAVE_AT}: "
          f"{mgr.manifest(TRAIN_SAVE_AT)['n_leaves']} leaves, {same} of "
          f"{len(want)} restored bit for bit; optimizer step "
          f"{int(restored['opt']['step'])}")
    check(same == len(want) == len(got),
          "the restored state differs from the saved one")

    # (d) the later steps again from the restored state
    _, resumed = timed_steps(
        step, restored, batches[TRAIN_SAVE_AT:], "smollm-135m resumed",
        "tokens", b * s)
    equal = resumed == losses[TRAIN_SAVE_AT:]
    print(f"smollm-135m resumed losses {resumed} against the uninterrupted "
          f"run's {losses[TRAIN_SAVE_AT:]}: "
          f"{'bit-equal' if equal else 'not bit-equal'}")
    if profile:
        profile_train_step(step, state, batches[-1], "smollm-135m")
    del state, saved, restored, template, params


def run_detector_train(profile: bool) -> None:
    """The detector's train step at the ladder's top rung (yolo-p6-1280:
    width and depth 1.0, P6 head), float32 with TF32 off, ``adamw``,
    ``DET_TRAIN_STEPS`` steps on ``detector_batches`` of the synthetic
    video at 1920x3840.  The batch is cut from ``DET_TRAIN_BATCH`` to
    half if peak memory passes ``DET_TRAIN_MAX_GB``."""
    import dataclasses

    import torch

    from repro_torch import pytree
    from repro_torch.data.pipeline import Prefetcher, detector_batches
    from repro_torch.data.synthetic import make_video
    from repro_torch.models import detector as det_mod
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod

    # the plain norm-activation tail: the kernel has no backward
    cfg = dataclasses.replace(det_mod.PAPER_LADDER[-1], norm_act_impl="plain")
    dev = torch.device("cuda")
    params = det_mod.init_params(torch.Generator(device=dev).manual_seed(30),
                                 cfg, device=dev)
    video = make_video(n_frames=8, n_objects=20, seed=11)
    opt = opt_mod.adamw(lr=1e-3)
    step = steps_mod.detector_train_step(cfg, opt)
    for b in (DET_TRAIN_BATCH, DET_TRAIN_BATCH // 2):
        t = time.perf_counter()
        batches = [pytree.tree_map(lambda v: torch.as_tensor(v, device=dev),
                                   x)
                   for x in Prefetcher(detector_batches(
                       video, cfg, b, height=1920, width=3840, seed=0,
                       n_batches=DET_TRAIN_STEPS))]
        print(f"detector train path: {cfg.name} ({cfg.input_size} px, width "
              f"{cfg.width_mult}, depth {cfg.depth_mult}, strides "
              f"{cfg.strides}), float32, TF32 off, norm-activation tail "
              f"{cfg.norm_act_impl}, adamw lr 1e-3, batch {b}; "
              f"{DET_TRAIN_STEPS} batches rendered in "
              f"{time.perf_counter() - t:.1f}s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss0, grads = steps_mod.value_and_grad(
            lambda p: det_mod.detection_loss(p, batches[0], cfg), params)
        peak = torch.cuda.max_memory_allocated() / 1e9
        if peak <= DET_TRAIN_MAX_GB:
            break
        print(f"detector train: peak memory {peak:.2f} GB at batch {b} "
              f"passes {DET_TRAIN_MAX_GB} GB: batch cut to {b // 2}")
        del grads, batches
        torch.cuda.empty_cache()
    convs = {}

    def walk(t, path):
        if isinstance(t, dict):
            if "w" in t and t["w"].dim() == 4:
                convs[path] = t["w"]
            for k, v in t.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")
    walk(grads, "")
    check_grads(grads, convs, cfg.name)
    del grads
    state = steps_mod.make_state(params, opt)
    state, losses = timed_steps(step, state, batches, f"{cfg.name} train",
                                "images", b)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{cfg.name} train: batch {b}, peak memory {peak:.2f} GB; step 1 "
          f"loss {losses[0]:.6f} (the gradient check's {float(loss0):.6f})")
    repeat_detector_step(step, state, batches[0], cfg.name)
    if profile:
        profile_train_step(step, state, batches[-1], cfg.name)


def repeat_detector_step(step, state, batch, what: str) -> None:
    """Whether the detector's float32 train step gives the same bits
    twice from one state: under cuDNN's defaults, then with
    ``torch.backends.cudnn.deterministic`` on and ``benchmark`` off (both
    restored after).  Prints whether the two runs' loss, grad norm and
    updated parameters are bit-equal, and each setting's ms a step."""
    import torch

    from repro_torch import pytree

    def twice():
        runs = []
        for _ in range(2):
            t = time.perf_counter()
            new, m = step(state, batch)
            torch.cuda.synchronize()
            runs.append(((time.perf_counter() - t) * 1e3, m, new))
        (ms0, m0, p0), (ms1, m1, p1) = runs
        same = [bool(torch.equal(bits(m0[x]), bits(m1[x])))
                for x in ("loss", "grad_norm")]
        same.append(all(torch.equal(bits(x), bits(y)) for x, y in zip(
            pytree.leaves(p0["params"]), pytree.leaves(p1["params"]))))
        return ms0, ms1, same

    cudnn = torch.backends.cudnn
    default = twice()
    before = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        pinned = twice()
    finally:
        cudnn.deterministic, cudnn.benchmark = before
    for name, (ms0, ms1, same) in (
            (f"cuDNN defaults (deterministic {before[0]}, benchmark "
             f"{before[1]})", default),
            ("cudnn.deterministic True, benchmark False", pinned)):
        print(f"{what} one step twice from one state, {name}: {ms0:.1f} / "
              f"{ms1:.1f} ms; bit-equal: loss {same[0]}, grad norm "
              f"{same[1]}, updated parameters {same[2]}")


def profile_train_step(step, state, batch, what: str) -> None:
    """One train step under the profiler: the card's busy share and its
    top kernels."""
    profile_call(lambda: step(state, batch), f"one {what} train step")


def profile_lm(prefill, decode, params, tokens, n_dec: int = 4) -> None:
    """One prefill step and ``n_dec`` decode steps under the profiler:
    the card's busy share of each, and their top kernels."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        out = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    print_profile(prof, wall, f"one LM prefill step (B={tokens.shape[0]}, "
                  f"S={tokens.shape[1]})", top=8)
    token = out["logits"].argmax(-1)
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(n_dec):
            out = decode(params, {"token": token, "cache_k": out["k"],
                                  "cache_v": out["v"],
                                  "cache_len": out["length"]})
            token = out["logits"].argmax(-1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    print_profile(prof, wall, f"{n_dec} LM decode steps (B="
                  f"{tokens.shape[0]})", top=8)


def print_profile(prof, wall_ms: float, what: str = "tick 3",
                  top: int = 12) -> None:
    """Device busy time of one profiled window, against its wall time,
    and the kernels that took most of it."""
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    n_kernels = sum(r[1] for r in rows)
    print(f"profile of {what}: device busy {busy:.1f} ms of {wall_ms:.1f} ms "
          f"wall ({100 * busy / wall_ms:.1f}%), {n_kernels} device ops")
    h2d = [r for r in rows if r[2].startswith("Memcpy HtoD")]
    print(f"  host-to-device copies {sum(r[0] for r in h2d):.3f} ms in "
          f"{sum(r[1] for r in h2d)} copies "
          f"({', '.join(f'{r[2]} {r[1]}x' for r in h2d) or 'none'})")
    for ms, n, name in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:9.3f} ms  {n:5d}x  {name[:90]}")
    port = [r for r in rows if any(k in r[2] for k in PORT_KERNEL_FUNCTIONS)]
    for ms, n, name in sorted(port, reverse=True):
        print(f"  port kernel {ms:9.4f} ms  {n:5d}x  {name[:90]}")


# --------------------------------------------------------------------------
# phase 10: the vision family
# --------------------------------------------------------------------------

# the four vision archs, each at its published width and depth (bf16)
VISION_ARCHS = ("vit_b16", "convnext_b", "resnet_50", "resnet_152")
VISION_TRAIN_STEPS, VISION_SERVE_REPS = 3, 5
# the bf16 serve logits against the float32 policy's on the same weights
# and images: |l16 - l32| / |l32| (Frobenius norms).  On the CPU at cut
# depths (ViT 3 layers, ConvNeXt depths (1, 1, 3, 1), ResNet-50 depths
# (1, 2, 2, 1); batch 4 at 224) it read 0.0075, 0.0054 and 0.0024, and
# the control (the float32 logits of another image batch) 1.00, 1.45 and
# 0.073; bf16 rounds ~10 activations a block at 2^-9 relative, so the
# full depths sit a few times higher
VISION_BF16_RTOL = 0.03
# the backbone detector: two backbones at 640 px, batch 8, bf16
VISION_DET_RES, VISION_DET_BATCH = 640, 8


def vision_groups(tree, path: str = "") -> list:
    """(path, leaf) of every leaf of a vision parameter tree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in vision_groups(v, f"{path}.{k}" if path else k)]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in vision_groups(v, f"{path}[{i}]")]
    return [(path, tree)]


def is_bn_stat(path: str) -> bool:
    return path.endswith((".mean", ".var"))


def run_vision_path(profile: bool = False) -> tuple[dict, dict]:
    """Phase 10; returns the launches of the vision serve path (the
    backbone detector included) and of the vision train path."""
    import torch

    from repro_torch.kernels import _build

    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    for i, arch in enumerate(VISION_ARCHS):
        serve_vision(arch, seed=40 + i)
    serve_backbone_detectors()
    serve = _build.launch_counts()
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    for i, arch in enumerate(VISION_ARCHS):
        train_vision(arch, seed=50 + i, profile=profile)
    train = _build.launch_counts()
    print(f"vision launches: serve {serve}, train {train}")
    check(not serve and not train, "a vision path launched a kernel: its "
          "attention is the plain one and its convolutions cuDNN's")
    return serve, train


def vision_images(b: int, res: int, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, res, res, 3), generator=gen, device="cuda")


def serve_vision(arch: str, seed: int) -> None:
    """``vision_serve_step`` of ``arch``'s ``full_config()`` at
    ``serve_b128`` and ``serve_b1`` (ms a batch, images/s, peak memory),
    then the bf16 logits against the float32 policy's and the control."""
    import importlib

    import torch

    from repro_torch.configs.base import VISION_SHAPES
    from repro_torch.models import vision as V
    from repro_torch.training import steps as steps_mod

    cfg = importlib.import_module(f"repro_torch.configs.{arch}").full_config()
    dev = torch.device("cuda")
    params = V.init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                           device=dev)
    step = steps_mod.vision_serve_step(cfg)
    print(f"vision serve: {cfg.name} ({cfg.n_params / 1e6:.1f}M parameters, "
          f"bf16, {cfg.img_res}px)")
    for shape in ("serve_b128", "serve_b1"):
        spec = VISION_SHAPES[shape]
        images = vision_images(spec.batch, spec.img_res, seed)
        reps = VISION_SERVE_REPS if spec.batch > 1 else 4 * VISION_SERVE_REPS
        for _ in range(2):
            out = step(params, {"images": images})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(reps):
            out = step(params, {"images": images})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / reps
        peak = torch.cuda.max_memory_allocated() / 1e9
        logits = out["logits"]
        check(tuple(logits.shape) == (spec.batch, cfg.n_classes)
              and logits.dtype == torch.float32
              and bool(torch.isfinite(logits).all()),
              f"{cfg.name} {shape}: logits {tuple(logits.shape)} "
              f"{logits.dtype}")
        print(f"{cfg.name} {shape} ({spec.batch} x {spec.img_res}²): "
              f"{ms:.2f} ms a batch, {spec.batch / ms * 1e3:.0f} images/s, "
              f"peak memory {peak:.2f} GB")

    check_vision_policy(cfg, params, seed)


def check_vision_policy(cfg, params, seed: int,
                        weights_control: bool = False) -> None:
    """The bf16 serve logits of 8 images at ``cfg.img_res`` against the
    float32 policy's on the same weights, within ``VISION_BF16_RTOL``; the
    control is another batch's float32 logits, or with
    ``weights_control`` the same batch's float32 logits from weights drawn
    from another seed (another batch's reading is then printed beside it:
    at random init a ResNet's logits barely depend on the image at 384,
    within 3% from batch to batch)."""
    import dataclasses

    import torch

    from repro_torch import pytree
    from repro_torch.models import vision as V
    from repro_torch.training import steps as steps_mod

    step = steps_mod.vision_serve_step(cfg)
    images = vision_images(8, cfg.img_res, seed + 100)
    other = vision_images(8, cfg.img_res, seed + 200)
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params32 = pytree.tree_map(lambda t: t.float(), params)
    step32 = steps_mod.vision_serve_step(cfg32)
    l16 = step(params, {"images": images})["logits"]
    l32 = step32(params32, {"images": images})["logits"]
    batch_err = float((step32(params32, {"images": other})["logits"]
                       - l32).norm() / l32.norm())
    ctl_err, what = batch_err, "another batch's float32 logits"
    if weights_control:
        del params32
        drawn = V.init_params(torch.Generator(device=images.device)
                              .manual_seed(seed + 300), cfg32,
                              device=images.device)
        ctl = step32(drawn, {"images": images})["logits"]
        ctl_err = float((ctl - l32).norm() / l32.norm())
        what = (f"the float32 logits from weights of another seed (another "
                f"batch's float32 logits {batch_err:.4g})")
    err = float((l16 - l32).norm() / l32.norm())
    print(f"{cfg.name} bf16 logits against the float32 policy's (8 x "
          f"{cfg.img_res}², TF32 off): |l16 - l32| / |l32| {err:.4g} (limit "
          f"{VISION_BF16_RTOL}); the control, {what}, {ctl_err:.4g}")
    check(err <= VISION_BF16_RTOL, f"{cfg.name}: bf16 logits {err} from "
          f"the float32 policy's")
    check(ctl_err > VISION_BF16_RTOL, f"{cfg.name}: the control passed the "
          f"bf16 check: {ctl_err}")


def serve_backbone_detectors() -> None:
    """One forward and ``decode`` of a ResNet-50 and a ConvNeXt-B
    backbone detector at ``VISION_DET_RES`` px, batch
    ``VISION_DET_BATCH``, bf16 (the plain norm-activation tail): the
    heads' grids and finite boxes."""
    import dataclasses

    import torch

    from repro_torch.configs import convnext_b, resnet_50
    from repro_torch.models import detector as det_mod

    dev = torch.device("cuda")
    images = vision_images(VISION_DET_BATCH, VISION_DET_RES, 60)
    for i, mod in enumerate((resnet_50, convnext_b)):
        bb = dataclasses.replace(mod.full_config(), img_res=VISION_DET_RES)
        cfg = det_mod.BackboneDetectorConfig(
            f"{bb.name}-det", bb, VISION_DET_RES,
            param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
            norm_act_impl="plain")  # the kernel takes float32 only
        params = det_mod.backbone_detector_init(
            torch.Generator(device=dev).manual_seed(61 + i), cfg, device=dev)
        with torch.no_grad():
            for _ in range(2):
                outs = det_mod.backbone_detector_apply(params, images, cfg)
                boxes, scores, cls = det_mod.decode(outs, cfg)
            torch.cuda.synchronize()
            t = time.perf_counter()
            outs = det_mod.backbone_detector_apply(params, images, cfg)
            boxes, scores, cls = det_mod.decode(outs, cfg)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        grids = [o.shape[1] for o in outs]
        print(f"backbone detector {cfg.name} ({VISION_DET_BATCH} x "
              f"{VISION_DET_RES}², bf16): heads {[tuple(o.shape) for o in outs]}"
              f", forward + decode {ms:.1f} ms; boxes {tuple(boxes.shape)}, "
              f"{int((scores > 0).sum())} scores above the threshold")
        check(grids == [VISION_DET_RES // s for s in cfg.strides],
              f"{cfg.name}: head grids {grids}")
        check(bool(torch.isfinite(boxes).all()), f"{cfg.name}: non-finite "
              f"boxes")
        del params, outs


def check_vision_grads(cfg, params, batch) -> None:
    """The gradients at ``params`` on ``batch``: every leaf finite, every
    trainable one non-zero; the BN stats' are 0 by construction (the loss
    reads the batch's statistics, not the running ones)."""
    import torch

    from repro_torch.training import steps as steps_mod

    def loss_fn(p):
        logits, _ = steps_mod.vision_apply(p, batch["images"], cfg,
                                           train=True)
        return torch.nn.functional.cross_entropy(logits,
                                                 batch["labels"].long())

    _, grads = steps_mod.value_and_grad(loss_fn, params)
    groups = vision_groups(grads)
    bad = [k for k, g in groups if not bool(torch.isfinite(g).all())]
    zero = [k for k, g in groups if not is_bn_stat(k)
            and not bool((g != 0).any())]
    stats = [k for k, g in groups if is_bn_stat(k)]
    stat_nonzero = [k for k in stats if bool((dict(groups)[k] != 0).any())]
    n_train = len(groups) - len(stats)
    print(f"{cfg.name} gradients: {len(groups)} leaves finite"
          f"{'' if not bad else f' except {bad}'}; {n_train - len(zero)} "
          f"of {n_train} trainable leaves non-zero; {len(stats)} BN "
          f"mean/var leaves zero by construction"
          + (f" (non-zero: {stat_nonzero})" if stat_nonzero else ""))
    check(not bad, f"{cfg.name}: non-finite gradients {bad}")
    check(not zero, f"{cfg.name}: zero gradients in {zero}")
    check(not stat_nonzero, f"{cfg.name}: BN stat gradients {stat_nonzero}")


def vision_train_steps(cfg, step, held: list, batches):
    """``step`` over ``batches`` from the state that ``held`` holds
    (popped: the loop keeps the one reference to the state, so that each
    input state is freed once its successor exists): ms a step, images/s,
    loss, grad norm, accuracy, then the peak memory.  Returns the last
    state."""
    import torch

    state = held.pop()
    b = batches[0]["images"].shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for batch in batches:
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        print(f"{cfg.name} train step {int(m['step'])}: {ms:.1f} ms, "
              f"{b / ms * 1e3:.0f} images/s, loss {float(m['loss']):.6f}, "
              f"grad norm {float(m['grad_norm']):.6f}, accuracy "
              f"{float(m['accuracy']):.4f}")
        check(math.isfinite(float(m["loss"]))
              and math.isfinite(float(m["grad_norm"])),
              f"{cfg.name}: non-finite loss or grad norm")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{cfg.name} train: batch {b}, peak memory {peak:.2f} GB")
    return state


def train_vision(arch: str, seed: int, profile: bool) -> None:
    """``VISION_TRAIN_STEPS`` ``vision_train_step``s of ``arch``'s
    ``full_config()`` (bf16, remat) at ``cls_224`` with ``adamw(lr=1e-3,
    warmup_steps=10)``: ms a step, images/s, peak memory; the gradients at
    the initial weights; the BN stats (ResNet); a checkpoint round trip
    (ResNet-50, ConvNeXt-B)."""
    import importlib
    import tempfile

    import torch

    from repro_torch import pytree
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs.base import VISION_SHAPES
    from repro_torch.models import vision as V
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod

    cfg = importlib.import_module(f"repro_torch.configs.{arch}").full_config()
    spec = VISION_SHAPES["cls_224"]
    b = spec.batch
    dev = torch.device("cuda")
    params = V.init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                           device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batches = [{"images": torch.randn((b, spec.img_res, spec.img_res, 3),
                                      generator=gen, device=dev),
                "labels": torch.randint(0, cfg.n_classes, (b,), generator=gen,
                                        device=dev, dtype=torch.int32)}
               for _ in range(VISION_TRAIN_STEPS)]
    print(f"vision train: {cfg.name}, bf16, remat={cfg.remat}, batch {b} x "
          f"{spec.img_res}² (cls_224), adamw lr 1e-3 warmup 10")

    check_vision_grads(cfg, params, batches[0])
    opt = opt_mod.adamw(lr=1e-3, warmup_steps=10)
    step = steps_mod.vision_train_step(cfg, opt)
    state = vision_train_steps(cfg, step, [steps_mod.make_state(params, opt)],
                               batches)

    if isinstance(cfg, V.ResNetConfig):
        before = [t for k, t in vision_groups(params) if is_bn_stat(k)]
        after = [t for k, t in vision_groups(state["params"])
                 if is_bn_stat(k)]
        moved = sum(not torch.equal(x, y) for x, y in zip(after, before))
        held = [t.clone() for t in after]
        steps_mod.vision_serve_step(cfg)(state["params"], batches[0])
        same = sum(bool(torch.equal(bits(a), bits(h))) for a, h in zip(
            [t for k, t in vision_groups(state["params"]) if is_bn_stat(k)],
            held))
        print(f"{cfg.name} BN running stats: {moved} of {len(after)} moved "
              f"after {VISION_TRAIN_STEPS} train steps; {same} of "
              f"{len(after)} bit-equal across a serve step")
        check(moved == len(after), f"{cfg.name}: BN stats did not move")
        check(same == len(after), f"{cfg.name}: a serve step changed the BN "
              f"stats")

    if arch in ("resnet_50", "convnext_b"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_vision_") as d:
            mgr = CheckpointManager(d)
            t = time.perf_counter()
            mgr.save(VISION_TRAIN_STEPS, state)
            template = steps_mod.make_state(V.init_params(
                torch.Generator(device=dev).manual_seed(seed + 1), cfg,
                device=dev), opt)
            restored = mgr.restore(VISION_TRAIN_STEPS, template)
            ms = (time.perf_counter() - t) * 1e3
            got, want = pytree.leaves(restored), pytree.leaves(state)
            same = sum(g.dtype == w.dtype and bool(torch.equal(bits(g),
                                                               bits(w)))
                       for g, w in zip(got, want))
            nones = [k for k, v in enumerate(
                restored["params"].get("downsample", [])) if v is None]
            print(f"{cfg.name} checkpoint at step {VISION_TRAIN_STEPS}: "
                  f"{mgr.manifest(VISION_TRAIN_STEPS)['n_leaves']} leaves, "
                  f"{same} of {len(want)} restored bit for bit"
                  + (f", downsample{nones} None" if nones else "")
                  + f" ({ms:.0f} ms save and restore)")
            check(same == len(want) == len(got),
                  f"{cfg.name}: the restored state differs from the saved one")
            if isinstance(cfg, V.ConvNeXtConfig):
                check(nones == [0], f"{cfg.name}: downsample None at {nones}")
            del restored, template
    if profile:
        profile_train_step(step, state, batches[-1], cfg.name)
    del state, params, batches
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 11: the diffusion family
# --------------------------------------------------------------------------

# flux-dev and unet-sdxl at their published widths (bf16, seeded weights)
DIFF_ARCHS = ("flux_dev", "unet_sdxl")
# gen_1024 runs this many of its 50 sampler steps (each step is the same
# work); gen_fast runs its 4 whole, after one warm-up step
DIFF_GEN1024_STEPS = 2
# flux at full depth does not train on one card: its bf16 params and
# grads and AdamW's float32 moments take 143 GB.  It trains at the
# published width on the first FLUX_TRAIN_BLOCKS (double, single) blocks
# of the served weights, and checks its precision policy on the first
# FLUX_POLICY_BLOCKS (a float32 copy of all 57 would take 47.5 GB).  A
# train step's AdamW update holds the old and the new state, the bf16
# gradients and their float32 clipped copies at once, 26 bytes a
# parameter whatever the batch: on 4 double and 8 single blocks (2.54B)
# that peak is ~66 GB before the update's temporaries, on 3 and 6 (1.91B)
# ~50 GB, which leaves the batch room under ~70 GB
FLUX_TRAIN_BLOCKS, FLUX_POLICY_BLOCKS = (3, 6), (2, 4)
# train_256's batch of 256 as each arch trains it (flux's cut so that the
# peak stays under ~70 GB)
DIFF_TRAIN_BATCH = {"flux_dev": 64, "unet_sdxl": 256}
DIFF_TRAIN_STEPS = 3
# the bf16 denoise step against the float32 policy's on the same weights
# and inputs: |d16 - d32| / |d32|, d the step's change of the latents
# (Frobenius norms), TF32 off; the control is the float32 step's change
# at half the timestep.  On the CPU at cut widths (flux d_model 128 and
# 512 on 2 double and 3 single blocks; the UNet at ch 64 and 128, depths
# (1, 2, 3); 2 x 32² latents) it read 0.0068 (flux) and 0.0055-0.0065
# (UNet), the controls 0.50 and 0.75-0.76
DIFF_BF16_RTOL = 0.05
# the sampled latents' digests of this run, by (model name, shape)
SERVE_DIGESTS: dict = {}


def run_diffusion_path(profile: bool = False) -> tuple[dict, dict]:
    """Phase 11; returns the launches of the diffusion serve path and of
    the diffusion train path."""
    import torch

    from repro_torch.kernels import _build

    serve, train = {}, {}
    for i, arch in enumerate(DIFF_ARCHS):
        torch.cuda.empty_cache()
        _build.reset_launch_counts()
        # the served model, which the train run takes over (it pops the
        # parameters, so that no reference here keeps them alive)
        held = serve_diffusion(arch, seed=70 + i, profile=profile)
        for k, v in _build.launch_counts().items():
            serve[k] = serve.get(k, 0) + v
        torch.cuda.empty_cache()
        _build.reset_launch_counts()
        train_diffusion(arch, held, seed=80 + i, profile=profile)
        for k, v in _build.launch_counts().items():
            train[k] = train.get(k, 0) + v
    torch.cuda.empty_cache()
    print(f"diffusion launches: serve {serve}, train {train}")
    check(not serve and not train, "a diffusion path launched a kernel: its "
          "attention is the plain _mha and its convolutions cuDNN's")
    return serve, train


def diffusion_inputs(cfg, b: int, res: int, seed: int) -> dict:
    """Latents (b, res, res, C) and the conditioning (``ctx`` and
    ``pooled`` for flux, ``ctx`` and ``add_emb`` for the UNet), drawn on
    the card from ``seed``."""
    import torch

    from repro_torch.models import diffusion as D

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    out = {"latents": randn(b, res, res, cfg.latent_ch)}
    if isinstance(cfg, D.MMDiTConfig):
        out.update(ctx=randn(b, cfg.n_ctx_tokens, cfg.d_ctx),
                   pooled=randn(b, cfg.d_pooled))
    else:
        out.update(ctx=randn(b, cfg.n_ctx_tokens, cfg.ctx_dim),
                   add_emb=randn(b, cfg.d_add))
    return out


def denoise_batch(cfg, inputs: dict, latents, t: float, dt: float) -> dict:
    """A denoise step's batch from ``t`` to ``t - dt``: flux's Euler step
    (t in [0, 1], guidance 3.5) or the UNet's DDIM step (t in [0, 1000),
    ``t_prev`` floored at 0)."""
    import torch

    from repro_torch.models import diffusion as D

    def full(v):
        return torch.full((latents.shape[0],), v, device=latents.device)

    batch = {**inputs, "latents": latents, "t": full(t)}
    if isinstance(cfg, D.MMDiTConfig):
        batch.update(dt=full(dt), guidance=full(3.5))
    else:
        batch["t_prev"] = full(max(t - dt, 0.0))
    return batch


def flux_blocks(params, n_double: int, n_single: int):
    """A flux tree cut to its first ``n_double`` and ``n_single`` blocks
    (views of the stacked leaves)."""
    from repro_torch import pytree

    return {**params,
            "double": pytree.tree_map(lambda t: t[:n_double],
                                      params["double"]),
            "single": pytree.tree_map(lambda t: t[:n_single],
                                      params["single"])}


def sample(step, params, cfg, inputs: dict, t0: float, dt: float,
           steps: int) -> tuple:
    """``steps`` sampler steps of ``dt`` from ``inputs``' latents at
    ``t0``; returns (latents, each step's ms)."""
    import torch

    x, times = inputs["latents"], []
    for i in range(steps):
        batch = denoise_batch(cfg, inputs, x, t0 - i * dt, dt)
        start = time.perf_counter()
        x = step(params, batch)["latents"]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return x, times


def serve_diffusion(arch: str, seed: int, profile: bool) -> tuple:
    """``diffusion_denoise_step`` of ``arch``'s ``full_config()``: a whole
    ``gen_fast`` sample, ``DIFF_GEN1024_STEPS`` steps at ``gen_1024``,
    then the bf16 step against the float32 policy's.  Returns ``{"cfg",
    "params"}`` for the train run."""
    import dataclasses
    import hashlib
    import importlib

    import torch

    from repro_torch import pytree
    from repro_torch.configs.base import DIFFUSION_SHAPES
    from repro_torch.models import diffusion as D
    from repro_torch.training import steps as steps_mod

    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    cfg = mod.full_config()
    is_flux = isinstance(cfg, D.MMDiTConfig)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = time.perf_counter()
    params = D.init_params(gen, cfg, device=dev)
    if is_flux:  # AdaLN-Zero's zeros would make every block the identity
        params = D.perturb_modulation(params, gen)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in pytree.leaves(params))
    print(f"diffusion serve: {cfg.name} ({n / 1e9:.3f}B parameters in "
          f"{len(pytree.leaves(params))} leaves, bf16"
          + (", modulation drawn non-zero" if is_flux else "")
          + f"; init on the card {(time.perf_counter() - t):.1f} s)")
    step = steps_mod.diffusion_denoise_step(cfg)
    t0 = 1.0 if is_flux else 999.0  # from noise down to 0

    for shape in ("gen_fast", "gen_1024"):
        spec = DIFFUSION_SHAPES[shape]
        res = spec.img_res // mod.VAE_FACTOR
        inputs = diffusion_inputs(cfg, spec.batch, res, seed)
        dt = t0 / spec.steps
        steps = spec.steps if shape == "gen_fast" else DIFF_GEN1024_STEPS
        sample(step, params, cfg, inputs, t0, dt, 1)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        x, times = sample(step, params, cfg, inputs, t0, dt, steps)
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(tuple(x.shape) == tuple(inputs["latents"].shape)
              and x.dtype == torch.float32 and bool(torch.isfinite(x).all()),
              f"{cfg.name} {shape}: latents {tuple(x.shape)} {x.dtype}")
        ms = sum(times) / len(times)
        digest = hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]
        SERVE_DIGESTS[(cfg.name, shape)] = digest
        whole = "whole sample" if steps == spec.steps else \
            f"{steps} of its {spec.steps} steps"
        print(f"{cfg.name} {shape} ({spec.batch} x {res}² latents, {whole}): "
              f"{', '.join(f'{v:.1f}' for v in times)} ms a step (mean "
              f"{ms:.1f}), {spec.batch / (ms * spec.steps) * 1e3:.3f} "
              f"samples/s at {spec.steps} steps, peak memory {peak:.2f} GB, "
              f"latents sha256 {digest}")
        if profile and shape == "gen_fast":
            batch = denoise_batch(cfg, inputs, x, dt, dt)
            profile_call(lambda: step(params, batch),
                         f"one {cfg.name} {shape} denoise step")
        del inputs, x

    # the bf16 step against the float32 policy's on the same weights
    pcfg, pparams = cfg, params
    if is_flux:
        nd, ns = FLUX_POLICY_BLOCKS
        pcfg = dataclasses.replace(cfg, n_double_blocks=nd,
                                   n_single_blocks=ns)
        pparams = flux_blocks(params, nd, ns)
    cfg32 = dataclasses.replace(pcfg, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params32 = pytree.tree_map(lambda p: p.float(), pparams)
    step16 = steps_mod.diffusion_denoise_step(pcfg)
    step32 = steps_mod.diffusion_denoise_step(cfg32)
    tm, dt = t0 / 2, t0 / 4
    spec = DIFFUSION_SHAPES["gen_fast"]
    inputs = diffusion_inputs(cfg, 2, spec.img_res // mod.VAE_FACTOR,
                              seed + 1)
    x = inputs["latents"]
    batch = denoise_batch(cfg, inputs, x, tm, dt)
    d16 = step16(pparams, batch)["latents"] - x
    d32 = step32(params32, batch)["latents"] - x
    other = denoise_batch(cfg, inputs, x, tm / 2, dt / 2)
    dctl = step32(params32, other)["latents"] - x
    err = float((d16 - d32).norm() / d32.norm())
    ctl = float((dctl - d32).norm() / d32.norm())
    cut = (f"{pcfg.n_double_blocks} double and {pcfg.n_single_blocks} "
           f"single blocks, " if is_flux else "full depth, ")
    print(f"{cfg.name} bf16 denoise step against the float32 policy's ({cut}"
          f"2 x {x.shape[1]}² latents at t {tm}, TF32 off): |d16 - d32| / "
          f"|d32| {err:.4g} (limit {DIFF_BF16_RTOL}); the control, the "
          f"float32 step at t {tm / 2}, {ctl:.4g}")
    check(err <= DIFF_BF16_RTOL, f"{cfg.name}: the bf16 denoise step {err} "
          f"from the float32 policy's")
    check(ctl > DIFF_BF16_RTOL, f"{cfg.name}: the control passed the bf16 "
          f"check: {ctl}")
    del params32, pparams, d16, d32, dctl
    return {"cfg": cfg, "params": params}


def check_diffusion_grads(cfg, params, batch) -> None:
    """The gradients at ``params`` on ``batch``: every leaf finite, every
    one non-zero (flux's modulation is drawn non-zero, so no block is
    gated off: no leaf is zero by construction)."""
    import torch

    from repro_torch.models import diffusion as D
    from repro_torch.training import steps as steps_mod

    loss_fn = D.flux_rf_loss if isinstance(cfg, D.MMDiTConfig) \
        else D.unet_eps_loss
    _, grads = steps_mod.value_and_grad(
        lambda p: loss_fn(p, batch, cfg, 0), params)
    groups = vision_groups(grads)
    bad = [k for k, g in groups if not bool(torch.isfinite(g).all())]
    zero = [k for k, g in groups if not bool((g != 0).any())]
    print(f"{cfg.name} gradients: {len(groups)} leaves, "
          f"{len(groups) - len(bad)} finite, {len(groups) - len(zero)} "
          f"non-zero; 0 zero by construction")
    check(not bad, f"{cfg.name}: non-finite gradients {bad}")
    check(not zero, f"{cfg.name}: zero gradients in {zero}")


def diffusion_train_steps(cfg, step, held: list, batches):
    """``step`` over ``batches`` from the state that ``held`` holds
    (popped, as :func:`vision_train_steps` pops it): ms a step, images/s,
    loss, grad norm, then the peak memory.  Returns the last state."""
    import torch

    state = held.pop()
    b = batches[0]["latents"].shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for batch in batches:
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        print(f"{cfg.name} train step {int(m['step'])}: {ms:.1f} ms, "
              f"{b / ms * 1e3:.1f} images/s, loss {loss:.6f}, grad norm "
              f"{gnorm:.6f}")
        check(math.isfinite(loss) and math.isfinite(gnorm),
              f"{cfg.name}: non-finite loss or grad norm")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{cfg.name} train: batch {b}, peak memory {peak:.2f} GB")
    return state


def train_diffusion(arch: str, held: dict, seed: int, profile: bool
                    ) -> None:
    """``DIFF_TRAIN_STEPS`` ``diffusion_train_step``s (remat, ``adamw(lr=
    1e-3, warmup_steps=10)``) at ``train_256`` from the served weights
    (flux cut to ``FLUX_TRAIN_BLOCKS``): ms a step, images/s, loss, grad
    norm, peak memory; the gradients at the initial weights; for the UNet
    a checkpoint round trip of the trained parameters.  ``held`` is
    :func:`serve_diffusion`'s result; its parameters are popped."""
    import dataclasses
    import importlib
    import tempfile

    import torch

    from repro_torch import pytree
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs.base import DIFFUSION_SHAPES
    from repro_torch.models import diffusion as D
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod

    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    cfg, params = held["cfg"], held.pop("params")
    is_flux = isinstance(cfg, D.MMDiTConfig)
    dev = torch.device("cuda")
    if is_flux:  # its own copy of the kept blocks: the rest is freed
        nd, ns = FLUX_TRAIN_BLOCKS
        cfg = dataclasses.replace(cfg, n_double_blocks=nd, n_single_blocks=ns)
        params = pytree.tree_map(torch.clone, flux_blocks(params, nd, ns))
        torch.cuda.empty_cache()
    spec = DIFFUSION_SHAPES["train_256"]
    b, res = DIFF_TRAIN_BATCH[arch], spec.img_res // mod.VAE_FACTOR
    gen = torch.Generator(device=dev).manual_seed(seed)
    batches = [{**diffusion_inputs(cfg, b, res, seed + i),
                "seed": torch.randint(0, 2 ** 31, (), generator=gen,
                                      device=dev)}
               for i in range(DIFF_TRAIN_STEPS)]
    n = sum(p.numel() for p in pytree.leaves(params))
    cut = (f"{cfg.n_double_blocks} double and {cfg.n_single_blocks} single "
           f"blocks of the served weights, " if is_flux else "")
    print(f"diffusion train: {cfg.name} ({cut}{n / 1e9:.3f}B parameters, "
          f"bf16, remat={cfg.remat}), batch {b} x {res}² latents (train_256"
          f"{'' if b == spec.batch else f'; its batch {spec.batch} cut to {b}'}"
          f"), adamw lr 1e-3 warmup 10")

    check_diffusion_grads(cfg, params, batches[0])
    opt = opt_mod.adamw(lr=1e-3, warmup_steps=10)
    step = steps_mod.diffusion_train_step(cfg, opt)
    held_state = [steps_mod.make_state(params, opt)]
    del params
    state = diffusion_train_steps(cfg, step, held_state, batches)

    if not is_flux:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_diffusion_") as d:
            mgr = CheckpointManager(d)
            saved = {"params": state["params"], "step": state["step"]}
            t = time.perf_counter()
            mgr.save(DIFF_TRAIN_STEPS, saved)
            restored = mgr.restore(DIFF_TRAIN_STEPS, saved)
            ms = (time.perf_counter() - t) * 1e3
            got, want = pytree.leaves(restored), pytree.leaves(saved)
            same = sum(g.dtype == w.dtype and bool(torch.equal(bits(g),
                                                               bits(w)))
                       for g, w in zip(got, want))
            nones = sum(v is None for lv in restored["params"]["down"]
                        + restored["params"]["up"] for v in lv["attn"])
            print(f"{cfg.name} checkpoint at step {DIFF_TRAIN_STEPS} (the "
                  f"parameters and the step): "
                  f"{mgr.manifest(DIFF_TRAIN_STEPS)['n_leaves']} leaves, "
                  f"{same} of {len(want)} restored bit for bit, {nones} None "
                  f"attention entries kept ({ms:.0f} ms save and restore)")
            check(same == len(want) == len(got),
                  f"{cfg.name}: the restored parameters differ")
            check(nones == 5, f"{cfg.name}: {nones} None attention entries")
            del restored
    if profile:
        profile_train_step(step, state, batches[-1], cfg.name)
    del state, batches
    torch.cuda.empty_cache()


# phase 12: one cell of each family of the launch layer's table
# (repro_torch.launch.cells), at its published shape on the card; the
# batch of a cell whose step would outlast the phase is cut (reduced), and
# the fake count of a cell whose op count would does its fake = real check
# at a shorter sequence (the last field) and counts the full cell on the
# real tensors alone
CELL_RUNS = (("vit_b16", "serve_b128", None, None),
             ("resnet_50", "cls_224", None, None),
             ("unet_sdxl", "gen_fast", None, None),
             # prefill_32k's batch of 32 -> 1: the chunked attention's
             # float32 score passes take ~9.2 s a prompt on the H100; its
             # 26k ops take ~20 s to count on fake tensors, so fake = real
             # is held at 4096 tokens (4 attention chunks of 1024)
             ("smollm_135m", "prefill_32k", 1, 4096))
CELL_TIMED_STEPS = 3
# the product peaks by operand dtype (dense, data sheet): bf16 and fp16 on
# the tensor cores; float32 outside them (the port turns TF32 off)
PEAK_FLOPS_BY_DTYPE = {"bfloat16": PEAK_BF16_TC_FLOPS,
                       "float16": PEAK_BF16_TC_FLOPS,
                       "float32": PEAK_F32_FLOPS}


def _phase12_cell(arch_id: str, shape_name: str, batch: int | None = None,
                  seq_len: int | None = None, **config):
    """The launch layer's cell, or the cell built by its own constructor from
    a cut: ``batch`` (an LM shape's ``global_batch``, a vision or
    diffusion shape's ``batch``), ``seq_len`` (an LM shape's), and any
    field of the arch's published config (``n_layers``, flux's
    ``n_double_blocks`` and ``n_single_blocks``, a ResNet's or a
    ConvNeXt's ``depths``, the UNet's ``transformer_depth``), so that the
    step, the specs and ``model_flops`` are the cut cell's."""
    import dataclasses

    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import cells as cells_mod

    if batch is None and seq_len is None and not config:
        return cells_mod.build_cell(arch_id, shape_name)
    arch = cfgbase.get_arch(arch_id)
    arch = dataclasses.replace(
        arch, config=dataclasses.replace(arch.config, **config))
    shape = arch.shapes[shape_name]
    if arch.family == "lm":
        shape = dataclasses.replace(
            shape, global_batch=shape.global_batch if batch is None
            else batch, seq_len=seq_len or shape.seq_len)
        return cells_mod._lm_cell(arch, shape)
    check(seq_len is None, f"{arch_id}/{shape_name}: no sequence to cut")
    shape = dataclasses.replace(
        shape, batch=shape.batch if batch is None else batch)
    build = (cells_mod._vision_cell if arch.family == "vision"
             else cells_mod._diffusion_cell)
    return build(arch, shape)


def _cut_text(cut: dict) -> str:
    return ", ".join(f"{v} tokens" if k == "seq_len" else f"{k} {v}"
                     for k, v in cut.items())


def published(arch_id: str, shape_name: str, field: str):
    """A cut field's published value: the shape's batch or sequence, or
    the config's field."""
    from repro_torch.configs import base as cfgbase

    arch = cfgbase.get_arch(arch_id)
    shape = arch.shapes[shape_name]
    if field == "batch":
        return shape.global_batch if arch.family == "lm" else shape.batch
    if field == "seq_len":
        return shape.seq_len
    return getattr(arch.config, field)


def control_cut(arch_id: str, shape_name: str, cut: dict) -> dict:
    """The control of a count at ``cut``: one layer fewer (an LM), one
    double block fewer (flux), one batch element fewer (vision and the
    UNet; one more at a batch of 1)."""
    from repro_torch.configs import base as cfgbase

    arch = cfgbase.get_arch(arch_id)
    if arch.family == "lm":
        field = "n_layers"
    elif arch_id == "flux_dev":
        field = "n_double_blocks"
    else:
        field = "batch"
    value = cut.get(field, published(arch_id, shape_name, field))
    return {**cut, field: 2 if field == "batch" and value == 1
            else value - 1}


def run_cell(arch_id: str, shape_name: str, cut: dict,
             held_cut: dict | None, seed: int, card: str,
             timed_steps: int | None = CELL_TIMED_STEPS,
             extra_checks: bool = False) -> None:
    """One cell of the launch layer on the card: built at ``cut``
    (:func:`_phase12_cell`), its fake-tensor count held equal to its real
    one (at ``cut`` plus ``held_cut`` where given: the full cell is then
    counted on real tensors alone), then timed over ``timed_steps`` steps
    after the counted warm-up (None: 2, or 1 where the first step took
    over 5 s).  ``extra_checks`` (phase 18) also
    prints each cut as ``reduced``, runs a decode cell at ``cache_len =
    S - 1``, holds the count at the control's cut (:func:`control_cut`)
    to another count, and prints the peak memory."""
    import torch

    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import cells as cells_mod
    from repro_torch.launch import dryrun
    from repro_torch.launch.hloanalysis import analyze, tensor_bytes

    dev = torch.device("cuda")
    cell = _phase12_cell(arch_id, shape_name, **cut)
    what = f"{arch_id}/{shape_name}"
    if cut:
        what += " (reduced: " + ", ".join(
            f"{k} {published(arch_id, shape_name, k)} -> {v}"
            for k, v in cut.items()) + ")"
    if extra_checks:
        for k, v in cut.items():
            print(f"reduced: {arch_id}/{shape_name} {k} "
                  f"{published(arch_id, shape_name, k)} -> {v}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    held = cell if held_cut is None else _phase12_cell(
        arch_id, shape_name, **{**cut, **held_cut})
    s_dec = cfgbase.get_arch(arch_id).shapes[shape_name].seq_len
    at_end = extra_checks and cell.kind == "decode"

    drawn = []

    def materialize(c):
        t = time.perf_counter()
        first, data = cells_mod.materialize(c, device=dev, seed=seed)
        if at_end:  # the step advances the length in place
            data["cache_len"].fill_(s_dec - 1)
        torch.cuda.synchronize()
        drawn.append(time.perf_counter() - t)
        return first, data

    t = time.perf_counter()
    fake = dryrun.count_cell(held, dev)
    t_fake = time.perf_counter() - t
    first, data = materialize(held)
    t = time.perf_counter()
    real = analyze(held.step, first, data)
    torch.cuda.synchronize()
    t_real = time.perf_counter() - t
    at = "" if held_cut is None else f" at {_cut_text(held_cut)}"
    check(fake["flops"] == real["flops"] > 0
          and fake["flops_by_dtype"] == real["flops_by_dtype"],
          f"{what}{at}: fake-tensor FLOPs {fake['flops']:.6e} "
          f"{fake['flops_by_dtype']} != real {real['flops']:.6e} "
          f"{real['flops_by_dtype']}")
    print(f"cell {what}: {cell.kind}, FLOPs{at} {fake['flops']:.6e} fake "
          f"= {real['flops']:.6e} real (counted in {t_fake:.1f} s and "
          f"{t_real:.1f} s), bytes {fake['hbm_bytes']:.6e} fake / "
          f"{real['hbm_bytes']:.6e} real, {fake['n_ops']} ops")
    if extra_checks:
        ctl_cut = control_cut(arch_id, shape_name, {**cut,
                                                    **(held_cut or {})})
        t = time.perf_counter()
        ctl = dryrun.count_cell(_phase12_cell(arch_id, shape_name,
                                              **ctl_cut), dev)
        print(f"cell {what}: the control at {_cut_text(ctl_cut)} counts "
              f"{ctl['flops']:.6e} FLOPs fake ("
              f"{'differs' if ctl['flops'] != fake['flops'] else 'EQUAL'}; "
              f"{time.perf_counter() - t:.1f} s)")
        check(ctl["flops"] != fake["flops"], f"{what}: the control at "
              f"{_cut_text(ctl_cut)} counts the cell's FLOPs")
        if at_end:
            print(f"cell {what}: each step decodes at cache_len "
                  f"{s_dec - 1} (S - 1; a cache of "
                  f"{data['cache_k'].shape[2]} slots)")
    if held is not cell:  # the full cell, counted on real tensors
        del first, data
        first, data = materialize(cell)
        t = time.perf_counter()
        real = analyze(cell.step, first, data)
        torch.cuda.synchronize()
        t_real = time.perf_counter() - t
        print(f"cell {what}: FLOPs {real['flops']:.6e} real (counted in "
              f"{t_real:.1f} s), bytes {real['hbm_bytes']:.6e}, "
              f"{real['n_ops']} ops")
    print(f"cell {what}: model_flops / FLOPs "
          f"{cell.model_flops / real['flops']:.4f}, FLOPs by operand "
          f"dtype {real['flops_by_dtype']}")
    arg_bytes = sum(tensor_bytes(x) for x in _leaves((first, data))
                    if isinstance(x, torch.Tensor))
    times = [t_real * 1e3]  # the counted run is the warm-up
    while len(times) <= (timed_steps or 1):
        if at_end:
            data["cache_len"].fill_(s_dec - 1)
        t = time.perf_counter()
        out = cell.step(first, data)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if cell.kind == "train":
            first = out[0]
        if timed_steps is None:  # by the first step's time
            timed_steps = 1 if times[1] > 5e3 else 2
    check(all(bool(torch.isfinite(x).all()) for x in _leaves(out)
              if isinstance(x, torch.Tensor) and x.is_floating_point()),
          f"{what}: non-finite output")
    out_bytes = sum(tensor_bytes(x) for x in _leaves(out)
                    if isinstance(x, torch.Tensor))
    ms = sum(times[1:]) / timed_steps
    # the card's bound: each product at its dtype's peak, and the least
    # traffic (the arguments read once, the outputs written once: the
    # parameters, the batch, a train cell's state both ways)
    compute_ms = sum(n / PEAK_FLOPS_BY_DTYPE[d]
                     for d, n in real["flops_by_dtype"].items()) * 1e3
    least_ms = (arg_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    card_ms = max(compute_ms, least_ms)
    card_by = "compute" if compute_ms >= least_ms else "least traffic"
    # the eager-traffic bound: every dispatched op's operands and
    # results through HBM, all products at the bf16 peak
    eager_ms, by = bound_ms(real["hbm_bytes"], real["flops"],
                            PEAK_BF16_TC_FLOPS)
    print(f"cell {what}: {' / '.join(f'{x:.1f}' for x in times[1:])} "
          f"ms a step (the counted warm-up {times[0]:.1f}), {ms:.1f} ms "
          f"mean, {real['flops'] / ms / 1e9:.1f} TFLOP/s; card bound "
          f"{card_ms:.3f} ms ({card_by}: "
          f"products at their dtype's peak {compute_ms:.3f} ms, "
          f"arguments + outputs {arg_bytes + out_bytes:.4e} B "
          f"{least_ms:.3f} ms), {card_ms / ms:.1%} of it reached; "
          f"eager-traffic bound {eager_ms:.3f} ms ({by}: FLOPs / "
          f"989e12, counted bytes / 3.35e12), {eager_ms / ms:.1%} of it "
          f"reached; {card}")
    if extra_checks:
        print(f"cell {what}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (arguments "
              f"{arg_bytes / 1e9:.2f} GB, drawn in "
              f"{' + '.join(f'{x:.1f}' for x in drawn)} s); {card}")
    del first, data, out, cell, held
    torch.cuda.empty_cache()


def run_cells_path() -> dict:
    """Phase 12; returns the launches of the cells' steps (none may
    launch a kernel: every cell's attention is plain or ``chunked``)."""
    import torch

    from repro_torch.kernels import _build

    card = card_line()
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    print(f"cells: {len(CELL_RUNS)} cells of the launch layer, counted on "
          f"fake CUDA tensors and on real seeded ones, then timed")
    for i, (arch_id, shape_name, batch, check_len) in enumerate(CELL_RUNS):
        run_cell(arch_id, shape_name,
                 {} if batch is None else {"batch": batch},
                 None if check_len is None else {"seq_len": check_len},
                 90 + i, card)
    launched = _build.launch_counts()
    print(f"cells launches: {launched}")
    check(not launched, "a cell's step launched a kernel")
    return launched


# the multi-device path (phase 13): mixtral-8x22b's MoE layer at published
# width on MD_MOE_TOKENS tokens, at the config's capacity factor and at
# MD_DROP_CF, which drops picks
MD_MOE_TOKENS = 4096
MD_DROP_CF = 0.5
# smollm-135m's gradients for the compressed all-reduce: one lm_loss
# backward of the float32 policy on MD_GRAD_BATCH x MD_GRAD_SEQ tokens
MD_GRAD_BATCH, MD_GRAD_SEQ = 2, 2048
# the replica forward's CPU twin (one card here)
MD_REPLICA_TEST = ("tests/test_torch_placement_sharded.py::"
                   "test_sharded_forward_matches_unsharded")


def run_multi_device_path() -> dict:
    """Phase 13; returns the phase's launches (none: the multi-device
    path's products are the MoE block's and the detector's, and its
    replica forward runs only with more than one card)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import _build

    card = card_line()
    _build.reset_launch_counts()
    # (a) an NCCL process group of world size 1 from a file store
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_store_")) / "store"
    mesh = C.init_mesh((1, 1), ("data", "model"), "cuda", rank=0,
                       store=str(store))
    nccl = ".".join(map(str, torch.cuda.nccl.version()))
    print(f"multi-device path: {dist.get_backend()} (NCCL {nccl}), world "
          f"size {dist.get_world_size()}, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
          f" on {torch.cuda.device_count()} card(s): one card holds one "
          f"rank, so every collective here is a one-rank NCCL call, not a "
          f"fabric figure; {card}")
    try:
        md_moe_a2a(mesh, card)
        md_compressed_psum(mesh, card)
        md_checkpoint(mesh)
    finally:
        dist.destroy_process_group()
    md_replica_forward(card)
    launched = _build.launch_counts()
    print(f"multi-device launches: {launched}")
    return launched


def md_moe_a2a(mesh, card: str) -> None:
    """(b) ``moe_block_a2a`` on the (1, 1) mesh against ``moe_block`` at
    mixtral-8x22b's published width (one layer, bf16): the output, the
    aux and the gradient of ``sum(out**2)`` of every leaf, bit for bit
    (at one model rank the exchange moves nothing), at the config's
    capacity factor and at one that drops picks; both blocks' ms."""
    import dataclasses

    import torch

    from repro_torch.configs import mixtral_8x22b
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    full = mixtral_8x22b.full_config()
    gen = torch.Generator(device=dev).manual_seed(130)
    p = T._layer_params(T.init_params(
        gen, dataclasses.replace(full, n_layers=1), device=dev), 0)["moe"]
    x = torch.randn(MD_MOE_TOKENS, full.d_model, generator=gen, device=dev,
                    dtype=full.compute_dtype)
    gb = sum(t.numel() * t.element_size() for t in p.values()) / 1e9
    for cf in (full.capacity_factor, MD_DROP_CF):
        cfg = dataclasses.replace(full, capacity_factor=cf)
        res, routes = [], []
        with use_mesh(mesh), torch.no_grad():
            fwd = [T.moe_block(p, x, cfg, routes), T.moe_block_a2a(p, x, cfg)]
            ms = [time_ms(lambda: T.moe_block(p, x, cfg), reps=10),
                  time_ms(lambda: T.moe_block_a2a(p, x, cfg), reps=10)]
        dropped = int((~routes[0].keep).sum())
        for blk in (T.moe_block, T.moe_block_a2a):
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            with use_mesh(mesh):
                out, _ = blk(leaves, x, cfg)
            grads = torch.autograd.grad((out.float() ** 2).sum(),
                                        [leaves[k] for k in sorted(leaves)])
            res.append(grads)
            del out, leaves
        same_fwd = all(torch.equal(bits(a), bits(b))
                       for a, b in zip(fwd[0], fwd[1]))
        same_grad = sum(torch.equal(bits(a), bits(b))
                        for a, b in zip(*res))
        finite = all(bool(torch.isfinite(t).all()) for t in fwd[1])
        cap = T.moe_capacity(cfg, MD_MOE_TOKENS)
        print(f"moe_block_a2a {full.name} (1 layer, d_model {full.d_model}, "
              f"{full.n_experts} experts top-{full.moe_top_k}, d_ff_expert "
              f"{full.d_ff_expert}, bf16, {gb:.2f} GB of weights) on "
              f"{MD_MOE_TOKENS} tokens at capacity factor {cf} (capacity "
              f"{cap}, {dropped} of {MD_MOE_TOKENS * full.moe_top_k} picks "
              f"dropped): output and aux against moe_block "
              f"{'bit-equal' if same_fwd else 'NOT bit-equal'}, gradients "
              f"{same_grad} of {len(res[0])} leaves bit-equal; moe_block "
              f"{ms[0]:.3f} ms, moe_block_a2a {ms[1]:.3f} ms; {card}")
        check(finite, "moe_block_a2a gave a non-finite output or aux")
        check(same_fwd and same_grad == len(res[0]),
              f"moe_block_a2a differs from moe_block at cf {cf}")
        check(cf != MD_DROP_CF or dropped > 0,
              f"capacity factor {cf} dropped no pick")
        del fwd, res
    del p, x
    torch.cuda.empty_cache()


def md_compressed_psum(mesh, card: str) -> None:
    """(c) ``compressed_psum_step`` over ``data`` on smollm-135m's
    full-width float32 gradients: with one rank, the bf16 mean is the
    bf16-rounded gradients and the residual the gradient minus them, bit
    for bit; the top-k mean is ``topk_decompress(topk_compress(...))``,
    bit for bit; the all-reduce's ms."""
    import dataclasses

    import torch

    from repro_torch import pytree
    from repro_torch.configs import smollm_135m
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.distributed import collectives as C
    from repro_torch.models import transformer as T
    from repro_torch.training import compression as comp
    from repro_torch.training import steps as steps_mod

    dev = torch.device("cuda")
    cfg = dataclasses.replace(smollm_135m.full_config(),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    params = T.init_params(torch.Generator(device=dev).manual_seed(131), cfg,
                           device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(iter(
        lm_batches(cfg.vocab_size, MD_GRAD_BATCH, MD_GRAD_SEQ, seed=131,
                   n_batches=1))).items()}
    _, grads = steps_mod.value_and_grad(lambda p: T.lm_loss(p, batch, cfg),
                                        params)
    del params
    g = pytree.leaves(grads)
    n = sum(t.numel() for t in g)
    zero = comp.CompressionState.zeros_like(grads)
    for mode in ("bf16", "topk"):
        mean, new = comp.compressed_psum_step(grads, zero, "data", mode, mesh)
        if mode == "bf16":
            want = [t.to(torch.bfloat16).float() for t in g]
            want_res = [t - w for t, w in zip(g, want)]
        else:
            payload, st = comp.topk_compress(grads, zero)
            want = pytree.leaves(comp.topk_decompress(payload, grads))
            want_res = pytree.leaves(st.residual)
        same = sum(torch.equal(bits(a), bits(b))
                   for a, b in zip(pytree.leaves(mean), want))
        same_res = sum(torch.equal(bits(a), bits(b))
                       for a, b in zip(pytree.leaves(new.residual), want_res))
        nonzero = sum(bool((r != 0).any()) for r in want_res)
        step_ms = time_ms(lambda: comp.compressed_psum_step(
            grads, zero, "data", mode, mesh), reps=5, warmup=1)
        dense = [w.clone() for w in want]
        ar_ms = time_ms(lambda: [C.psum(t, "data", mesh) for t in dense],
                        reps=5, warmup=1)
        print(f"compressed_psum_step {mode} over data, smollm-135m's "
              f"{len(g)} gradient leaves ({n} float32 values, one lm_loss "
              f"backward at {MD_GRAD_BATCH} x {MD_GRAD_SEQ}): mean {same} of "
              f"{len(g)} leaves bit-equal to the compressor's, residual "
              f"{same_res} of {len(g)} ({nonzero} non-zero); the step "
              f"{step_ms:.3f} ms, its float32 all-reduce {ar_ms:.3f} ms "
              f"({4 * n / 1e6:.1f} MB in {len(g)} one-rank NCCL calls, not a "
              f"fabric figure); {card}")
        check(same == same_res == len(g),
              f"compressed_psum_step {mode} differs from its compressor")
        check(nonzero > 0, f"{mode}: every residual is zero")
        del mean, new, dense
    del grads, g, zero
    torch.cuda.empty_cache()


def md_checkpoint(mesh) -> None:
    """(d) smollm-135m's parameters saved through the gathering save
    under ``mesh_signature`` (their specs from the LM rules), restored,
    and each leaf's block on the (1, 1) mesh: bit for bit."""
    import tempfile

    import torch

    from repro_torch import pytree
    from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                                   mesh_signature,
                                                   restore_local,
                                                   save_gathered)
    from repro_torch.configs import smollm_135m
    from repro_torch.distributed import sharding
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    cfg = smollm_135m.full_config()
    params = T.init_params(torch.Generator(device=dev).manual_seed(132), cfg,
                           device=dev)
    specs = sharding.spec_tree(params, sharding.lm_param_rules())
    mgr = CheckpointManager(tempfile.mkdtemp(prefix="chip_smoke_md_ckpt_"))
    t = time.perf_counter()
    save_gathered(mgr, 1, params, mesh, specs)
    save_s = time.perf_counter() - t
    template = T.init_params(torch.Generator(device=dev).manual_seed(133),
                             cfg, device=dev)
    t = time.perf_counter()
    got = pytree.leaves(restore_local(mgr, 1, template, mesh, specs))
    load_s = time.perf_counter() - t
    want = pytree.leaves(params)
    same = sum(a.dtype == b.dtype and torch.equal(bits(a), bits(b))
               for a, b in zip(got, want))
    sig = mgr.manifest(1)["mesh"]
    sharded = sum(any(e is not None for e in s)
                  for s in pytree.flatten(specs, lambda s: isinstance(
                      s, sharding.P))[0])
    print(f"checkpoint through the gathering save: smollm-135m, "
          f"{len(want)} leaves ({sharded} with a sharded spec), signature "
          f"{sig}, saved in {save_s:.2f} s, restored and sharded on the mesh "
          f"in {load_s:.2f} s; {same} of {len(want)} leaves bit for bit")
    check(sig == mesh_signature(mesh) == {"shape": [1, 1],
                                          "axes": ["data", "model"]},
          f"the manifest's signature {sig}")
    check(same == len(want) == len(got),
          "the restored parameters differ from the saved ones")
    del params, template, got, want


def md_replica_forward(card: str) -> None:
    """(e) with more than one card, the replica forward of a
    ``PAPER_LADDER`` rung split over every card against the unsplit
    forward; on one card, the line that says so."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        print(f"replica forward: not run on this machine ({n} card); the "
              f"split over a replica group is held on the CPU by "
              f"{MD_REPLICA_TEST} (8 CPU device identities)")
        return
    import numpy as np

    from repro_torch.core import sroi as sroi_mod
    from repro_torch.models import detector as det_mod
    from repro_torch.serving import placement, profiles
    from repro_torch.serving.scheduler import TorchDetectorBackend

    cfg = det_mod.PAPER_LADDER[0]
    dev = torch.device("cuda", 0)
    params = det_mod.init_params(torch.Generator(device=dev).manual_seed(134),
                                 cfg, device=dev)
    backend = TorchDetectorBackend([cfg], [params], conf=0.01, device=dev)
    v = profiles.make_ladder()[0]
    group = placement.VariantPlacement(
        [v], devices=[torch.device("cuda", i) for i in range(n)]).groups[0]
    rng = np.random.default_rng(134)
    frame = rng.random((960, 1920, 3)).astype(np.float32)
    regions = [sroi_mod.SRoI(center=(float(rng.uniform(-2.5, 2.5)),
                                     float(rng.uniform(-0.9, 0.9))),
                             fov=(1.0, 1.0)) for _ in range(2 * n + 1)]
    items = [(frame, r) for r in regions]
    plain = backend.infer_srois_batched(items, v)
    split = backend.infer_srois_batched(items, v, group=group)
    bad = 0
    for a, b in zip(plain, split):
        bad += len(a) != len(b) or any(
            x.category != y.category
            or not np.allclose(x.box, y.box, rtol=1e-4, atol=1e-4)
            for x, y in zip(a, b))
    t = time.perf_counter()
    backend.infer_srois_batched(items, v, group=group)
    ms = (time.perf_counter() - t) * 1e3
    print(f"replica forward: {cfg.input_size} px rung over {n} cards, "
          f"{len(items)} crops, {sum(map(len, plain))} detections: "
          f"{len(items) - bad} of {len(items)} rows match the unsplit "
          f"forward (rtol/atol 1e-4); {ms:.1f} ms; {card}")
    check(bad == 0, "the replica forward differs from the unsplit one")


# --------------------------------------------------------------------------
# phase 14: the OmniSense server under its policies, the 1280 rung batched,
# the open-loop fleet
# --------------------------------------------------------------------------

# deadline vs sync (ticks), async (ticks before the flush), the 1280 pod
POLICY_TICKS, ASYNC_TICKS, RUNG_TICKS = 3, 4, 2
# the loops' budgets tried, in order, until the allocator puts at least
# two of tick 1's SRoIs on yolo-p6-1280 (at 2.0 s it puts none there)
RUNG_BUDGETS = (2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0)
RUNG_SIZE = 1280
# DeadlineOrderPolicy drains every queue fully and only orders the
# chunks, so its detections are sync's: the same chunks through the same
# kernels, held to the pod-tick parity tests' 1e-4
POLICY_ATOL = 1e-4
# a request's batched detections against its served crop run through the
# detector alone (``detect_crop``): the same input at batch 1, where the
# convolutions may take other algorithms, whose float32 roundings the
# detector's layers carry to its scores and boxes
PER_REQUEST_ATOL = 1e-3
# the fleet: the serve launcher's open-loop defaults (launch/serve.py)
FLEET_PODS, FLEET_FPS, FLEET_JITTER, FLEET_FRAMES = 2, 0.5, 0.2, 8
FLEET_SLO_S = 2.0


def lazy_frames(videos):
    """A frame source that renders each (stream, frame) when first asked
    for it and keeps it (the pods' few frames; the fleet renders its own
    without keeping them)."""
    from repro_torch.data.synthetic import render_erp

    frames: dict = {}

    def source(s: int, f: int):
        if (s, f) not in frames:
            frames[(s, f)] = render_erp(videos[s], f, height=1920,
                                        width=3840)
        return frames[(s, f)]

    source.frames = frames
    return source


def compare_dets(got, want, atol: float) -> tuple[bool, bool, float]:
    """(within ``atol``, bit-equal, max |err|) of two detection lists:
    equal counts and categories, boxes and scores within ``atol``."""
    import numpy as np

    if len(got) != len(want) or [d.category for d in got] != \
            [d.category for d in want]:
        return False, False, math.inf
    err = max((max(float(np.abs(np.asarray(a.box) - np.asarray(b.box)).max()),
                   abs(a.score - b.score)) for a, b in zip(got, want)),
              default=0.0)
    exact = all(np.array_equal(a.box, b.box) and a.score == b.score
                for a, b in zip(got, want))
    return err <= atol, exact, err


def record_chunks(backend, keep_pis=None) -> list:
    """Wrap ``backend``'s chunk projection and batched launch so that
    every served request is recorded: its variant, frame, region, the
    geometry its crop was projected at (the anchor's for a crop-cache
    hit), its batched detections, the launch it was part of and, where
    ``keep_pis(size)`` is true, its crop."""
    project, launch = backend._project_chunk, backend.launch_srois_batched
    seen: list = []
    crops: dict = {}
    n_launches = itertools.count(1)

    def projecting(chunk, size):
        pis, geoms = project(chunk, size)
        for (_, region), geom, pi in zip(chunk, geoms, pis):
            crops[id(region)] = (geom, size, pi if keep_pis and keep_pis(size)
                                 else None)
        return pis, geoms

    def launching(items, variant, group=None):
        resolve = launch(items, variant, group)
        n_launch = next(n_launches)

        def resolved():
            out = resolve()
            for (frame, region), dets in zip(items, out):
                geom, size, pi = crops.pop(id(region))
                seen.append(dict(variant=variant, frame=frame, region=region,
                                 geom=geom, size=size, pi=pi, dets=dets,
                                 launch=(n_launch, variant.name)))
            return out

        return resolved

    backend._project_chunk = projecting
    backend.launch_srois_batched = launching
    return seen


def served_at(rec):
    """The SRoI a recorded request's crop was projected at."""
    from repro_torch.core.sroi import SRoI

    ct, cp, fov = rec["geom"]
    return SRoI(center=(float(ct), float(cp)), fov=tuple(fov))


def detect_crop(backend, rec) -> list:
    """A recorded request's detections from its served crop run through
    its variant alone (batch 1), decoded and lifted as ``infer_sroi``
    does: the batched launch's input, so only the batch differs."""
    import torch

    from repro_torch.models import detector as det_mod

    idx = rec["variant"].index - 1
    cfg = backend.cfgs[idx]
    with torch.inference_mode():
        outs = det_mod.apply(backend.params[idx], rec["pi"][None], cfg)
        boxes, scores, classes = det_mod.decode(outs, cfg, backend.conf,
                                                max_det=backend.max_det)
    return backend._row_to_dets(boxes[0].cpu().numpy(),
                                scores[0].cpu().numpy(),
                                classes[0].cpu().numpy(), served_at(rec),
                                rec["size"])


def reproject(rec, frame_img):
    """A recorded request's crop projected again by the pod's batched
    projection from ``frame_img``, staged as the backend stages a frame,
    at the geometry the request was served at."""
    import numpy as np
    import torch

    from repro_torch.kernels.gnomonic.ops import project_srois_batched

    frame = torch.as_tensor(np.asarray(frame_img, dtype=np.float32),
                            device=rec["pi"].device)
    region = served_at(rec)
    return project_srois_batched(frame[None], [0], [region.center],
                                 [region.fov], (rec["size"], rec["size"]))[0]


def frame_digests(sink) -> list:
    return [(e["stream"], e["frame_idx"], e["det_digest"])
            for e in sink.events if e["event"] == "frame_finish"]


def run_serving_policies() -> tuple[dict, list]:
    """Phase 14 (a)-(c): the pod's deadline and async policies and the
    1280 rung batched, on the full ``PAPER_LADDER`` at 1920x3840.  Returns
    the launches (counted from 0 before and read after) and the ladder's
    parameters, which the fleet serves."""
    import torch

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    cfgs, params = ladder_params()
    torch.cuda.synchronize()
    print(f"serving policies: PAPER_LADDER {[c.input_size for c in cfgs]} "
          f"px at 1920x3840, MAX_BATCH {MAX_BATCH}, init "
          f"{time.perf_counter() - t0:.1f}s")
    _build.reset_launch_counts()
    run_deadline_against_sync(params)
    run_async_pod(params)
    run_rung_1280(params, cfgs)
    launches = _build.launch_counts()
    print(f"serving policies launches: {launches}; "
          f"{time.perf_counter() - t0:.1f}s; {card_line()}")
    for k in KERNELS:
        if k not in LM_KERNELS and k != "sphiou_matrix_batch_bf16":
            check(launches.get(k, 0) > 0,
                  f"kernel {k} was not launched on the serving policies' path")
    return launches, params


def run_deadline_against_sync(params) -> None:
    """4 streams, ``POLICY_TICKS`` ticks under ``deadline`` and, beside it,
    under ``sync`` (each pod its own backend, the same frames): each
    frame's detections equal within ``POLICY_ATOL``."""
    import torch

    from repro_torch.data.synthetic import make_video

    videos = [make_video(n_frames=8, n_objects=20, seed=s)
              for s in (41, 42, 43, 44)]
    source = lazy_frames(videos)
    pods = {}
    for policy in ("sync", "deadline"):
        backend = ladder_backend(params)
        _, loops = make_loops(backend, videos, 80, 5, None)
        pods[policy] = tick_server(loops, [backend] * len(loops),
                                   max_batch=MAX_BATCH,
                                   buckets=backend.buckets,
                                   frame_source=source, policy=policy)
    worst, exact, n = 0.0, True, 0
    for f in range(1, POLICY_TICKS + 1):
        walls = {}
        for policy, server in pods.items():
            n_tl = len(server.timelines)
            t = time.perf_counter()
            server.step(f)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            walls[policy] = (wall, *phase_ms(f),
                             per_variant_requests(server, n_tl))
        for a, b in zip(pods["deadline"].loops, pods["sync"].loops):
            ok, same, err = compare_dets(a._history[-1], b._history[-1],
                                         POLICY_ATOL)
            check(ok, f"deadline tick {f}: a frame's detections differ from "
                  f"sync's ({len(a._history[-1])} vs {len(b._history[-1])}, "
                  f"max|err| {err})")
            worst, exact = max(worst, err), exact and same
            n += len(a._history[-1])
        wall, drain, ingest, per_variant = walls["deadline"]
        order = [ev.variant for ev in pods["deadline"].timelines[-1].events]
        print(f"deadline tick {f}: wall ms {wall:.1f} (emission "
              f"{wall - drain - ingest:.1f}, drain {drain:.1f}, ingest "
              f"{ingest:.1f}); sync's {walls['sync'][0]:.1f}; requests per "
              f"variant {per_variant}; chunk order {order}; {card_line()}")
    check(n > 0, "the deadline pod produced no detections")
    d, s_ = pods["deadline"].stats, pods["sync"].stats
    # the same chunks, launched in another order
    check((d.frames, d.dispatches, sorted(d.batch_sizes)) ==
          (s_.frames, s_.dispatches, sorted(s_.batch_sizes)),
          "deadline and sync dispatched different chunks")
    print(f"deadline against sync: {d.frames} frames, {n} detections, "
          f"{d.dispatches} dispatches each; max|err| {worst:.3g} (tol "
          f"{POLICY_ATOL}); bit-equal {exact}")


def serve_async(params, videos, checks: bool):
    """One async pod: ``ASYNC_TICKS`` ticks, then ``flush``.  With
    ``checks`` each tick prints its line and every carried request is
    recorded.  Returns (server, backend, sink, frame source, carried
    request records)."""
    import torch

    from repro_torch import tracing
    from repro_torch.serving.telemetry import MemorySink

    backend = ladder_backend(params)
    _, loops = make_loops(backend, videos, 80, 5, None)
    source = lazy_frames(videos)
    sink = MemorySink()
    server = tick_server(loops, [backend] * len(loops), max_batch=MAX_BATCH,
                         buckets=backend.buckets, frame_source=source,
                         policy="async", telemetry=sink)
    seen = record_chunks(backend, keep_pis=lambda size: True) if checks \
        else []
    carried: list = []
    execute = server._execute

    def watching(ops, timeline, close):
        aged = {id(it.request.region) for name in server.queues.counts()
                for it in server.queues.peek(name) if it.age > 0}
        n = len(seen)
        execute(ops, timeline, close)
        for r in seen[n:]:
            if id(r["region"]) in aged:
                carried.append(r)
            else:
                r["pi"] = None  # only the carried requests' crops are held

    server._execute = watching
    for f in range(1, ASYNC_TICKS + 2):  # the last round is the flush
        uploads, hits = backend.frame_uploads, backend.crop_cache_hits
        n_carried, n_frames = server.stats.carried_requests, server.stats.frames
        n_tl, n_rec = len(server.timelines), len(carried)
        t = time.perf_counter()
        if f <= ASYNC_TICKS:
            server.step(f)
        else:
            # the flush is no tick of the server's: trace it as tick f
            tracing.begin_tick(f)
            server.flush()
            tracing.end_tick()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        if not checks:
            continue
        up = backend.frame_uploads - uploads
        staged = len(videos) if f <= ASYNC_TICKS else 0
        drain, ingest = phase_ms(f)
        what = f"async tick {f}" if f <= ASYNC_TICKS else "async flush"
        print(f"{what}: wall ms {wall:.1f} (emission "
              f"{wall - drain - ingest:.1f}, drain {drain:.1f}, ingest "
              f"{ingest:.1f}); requests per variant "
              f"{per_variant_requests(server, n_tl)}; carried requests "
              f"{server.stats.carried_requests - n_carried} (left queued "
              f"{len(server.queues)}), served a tick late "
              f"{len(carried) - n_rec}; frame uploads {up} ({staged} staged, "
              f"{up - staged} by chunks holding carried requests, which "
              f"upload each of their frames again); "
              f"crop-cache hits {backend.crop_cache_hits - hits}; frames "
              f"finished {server.stats.frames - n_frames}; {card_line()}")
    return server, backend, sink, source, carried


def run_async_pod(params) -> None:
    """4 streams, ``ASYNC_TICKS`` async ticks and the flush: carried
    requests, each one's crop bit-equal to its own frame's projected again
    (and, a control that must fail, not to its stream's next frame's) and
    its detections held to its crop run alone (and, a control that must
    fail, to ``infer_sroi`` on its stream's next frame), nothing left
    after the flush, and a second run from the same seeds bit-equal."""
    import torch

    from repro_torch.data.synthetic import make_video
    from repro_torch.serving.replay import stats_fingerprint

    def videos():
        return [make_video(n_frames=8, n_objects=20, seed=s)
                for s in (45, 46, 47, 48)]

    server, backend, sink, source, carried = serve_async(params, videos(),
                                                         checks=True)
    n_streams = len(server.loops)
    check(server.stats.carried_requests > 0, "the async pod carried nothing")
    check(bool(carried), "no carried request was served")
    check(not len(server.queues) and not server._inflight
          and not backend._staged,
          f"after flush: {len(server.queues)} queued, "
          f"{len(server._inflight)} in flight, {len(backend._staged)} staged")
    check(server.stats.frames == n_streams * ASYNC_TICKS,
          f"async: {server.stats.frames} frames finished, not "
          f"{n_streams * ASYNC_TICKS}")
    where = {id(img): key for key, img in source.frames.items()}
    worst, worst_ctl, worst_det_ctl, n_ctl = 0.0, math.inf, math.inf, 0
    for rec in carried:
        s, f = where[id(rec["frame"])]
        check(torch.equal(rec["pi"], reproject(rec, rec["frame"])),
              f"a carried request of stream {s} frame {f}: its crop is not "
              f"its own frame's at the geometry it was served at")
        gap = float((rec["pi"] - reproject(rec, source(s, f + 1)))
                    .abs().max())
        check(gap > 0, f"the control (stream {s} frame {f + 1}) passes for "
              f"a carried request of frame {f}")
        worst_ctl = min(worst_ctl, gap)
        ok, _, err = compare_dets(rec["dets"], detect_crop(backend, rec),
                                  PER_REQUEST_ATOL)
        check(ok, f"a carried request of stream {s} frame {f} differs from "
                  f"its crop run alone (max|err| {err})")
        worst = max(worst, err)
        rec["pi"] = None
        nxt = backend.infer_sroi(source(s, f + 1), served_at(rec),
                                 rec["variant"])
        if rec["dets"] or nxt:
            ok_c, _, err_c = compare_dets(rec["dets"], nxt, PER_REQUEST_ATOL)
            check(not ok_c, f"the control (infer_sroi on stream {s} frame "
                  f"{f + 1}) passes for a carried request of frame {f}")
            worst_det_ctl, n_ctl = min(worst_det_ctl, err_c), n_ctl + 1
    check(n_ctl > 0, "no carried request had a detection to control")
    print(f"async: {server.stats.carried_requests} carried requests, "
          f"{len(carried)} served a tick after emission (their frames no "
          f"longer staged); each one's crop bit-equal to its own frame's "
          f"projected again at the geometry it was served at, and at least "
          f"{worst_ctl:.3g} from the stream's next frame's (the control); "
          f"their detections against their crops run alone: max|err| "
          f"{worst:.3g} (tol {PER_REQUEST_ATOL}, the same categories in the "
          f"same order); against infer_sroi on the stream's next frame (the "
          f"control) they fail for all {n_ctl} with detections (least "
          f"max|err| {worst_det_ctl:.3g}, counts or categories differing "
          f"read inf); after flush 0 queued, 0 in flight, 0 staged, "
          f"{server.stats.frames} frames finished")
    fp, digests = stats_fingerprint(server.stats), frame_digests(sink)
    again, _, sink2, _, _ = serve_async(params, videos(), checks=False)
    same_fp = stats_fingerprint(again.stats) == fp
    same_dig = frame_digests(sink2) == digests
    print(f"async run twice from the same seeds: ServeStats fingerprint "
          f"equal {same_fp}; {len(digests)} per-frame detection digests "
          f"equal {same_dig}")
    check(same_fp and same_dig, "the async pod is not deterministic")


def run_rung_1280(params, cfgs) -> None:
    """4 streams, ``RUNG_TICKS`` sync ticks with the loops' budget raised
    until the allocator puts at least two of tick 1's SRoIs on the 1280
    rung: its chunk through ``project_srois_batched`` at S=1280, the crops
    held to the float64 map, the detections to the crops run alone, the
    kernel's time beside its bound."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import make_video
    from repro_torch.kernels.gnomonic import ops
    from repro_torch.kernels.gnomonic.ref import (project_sroi_f64,
                                                  project_srois_ref)

    rung = next(i for i, c in enumerate(cfgs) if c.input_size == RUNG_SIZE)
    videos = [make_video(n_frames=8, n_objects=20, seed=s)
              for s in (49, 50, 51, 52)]
    source = lazy_frames(videos)
    probe = ladder_backend(params)
    on_rung = {}
    for budget in RUNG_BUDGETS:
        _, loops = make_loops(probe, videos, 80, 5, None, budget_s=budget)
        on_rung[budget] = sum(r.variant.index - 1 == rung for s, loop in
                              enumerate(loops) for r in
                              loop.begin_frame(source(s, 1)).requests)
        if on_rung[budget] >= 2:
            break
    check(on_rung[budget] >= 2, f"no budget in {RUNG_BUDGETS} puts two SRoIs "
          f"on the {RUNG_SIZE} rung: {on_rung}")
    backend = ladder_backend(params)
    _, loops = make_loops(backend, videos, 80, 5, None, budget_s=budget)
    server = tick_server(loops, [backend] * len(loops), max_batch=MAX_BATCH,
                         buckets=backend.buckets, frame_source=source)
    seen = record_chunks(backend, keep_pis=lambda size: size == RUNG_SIZE)
    name = loops[0].variants[rung].name
    chunks = []
    for f in range(1, RUNG_TICKS + 1):
        n_tl = len(server.timelines)
        t = time.perf_counter()
        server.step(f)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        sizes = [ev.b for tl in server.timelines[n_tl:] for ev in tl.events
                 if ev.variant == name]
        chunks += sizes
        print(f"rung tick {f}: budget_s {budget} (tried {on_rung}); requests "
              f"per variant {per_variant_requests(server, n_tl)}; {name} "
              f"chunks {sizes}; wall ms {wall:.1f} (drain "
              f"{phase_ms(f)[0]:.1f}); {card_line()}")
    check(max(chunks, default=0) >= 2,
          f"no {name} chunk of batch >= 2: {chunks}")
    recs = [r for r in seen if r["size"] == RUNG_SIZE]
    dev_frames: dict = {}
    err_k = err_p = worst = 0.0
    for rec in recs:
        fid = id(rec["frame"])
        if fid not in dev_frames:
            dev_frames[fid] = torch.from_numpy(rec["frame"]).cuda()
        frame = dev_frames[fid]
        ct, cp, fov = rec["geom"]
        exact = project_sroi_f64(frame, float(ct), float(cp), list(fov),
                                 RUNG_SIZE)
        plain = project_srois_ref(
            frame[None], torch.tensor([0]), torch.tensor([[ct, cp]]),
            torch.tensor([list(fov)]), (RUNG_SIZE, RUNG_SIZE))[0]
        err_k = max(err_k, float((rec["pi"].double() - exact).abs().max()))
        err_p = max(err_p, float((plain.double() - exact).abs().max()))
        ok, _, err = compare_dets(rec["dets"], detect_crop(backend, rec),
                                  PER_REQUEST_ATOL)
        check(ok, f"a {name} request differs from its crop run alone "
              f"(max|err| {err})")
        worst = max(worst, err)
    check(err_k <= 2 * err_p + 5e-5,
          f"{name} crops {err_k} from the float64 map, the plain version "
          f"{err_p}")
    # the kernel alone on the largest launch's crops (at most MAX_BATCH)
    launches: dict = {}
    for rec in recs:
        launches.setdefault(rec["launch"], []).append(rec)
    batch = max(launches.values(), key=len)[:MAX_BATCH]
    order = list(dict.fromkeys(id(r["frame"]) for r in batch))
    stack = torch.stack([dev_frames[i] for i in order])
    idx = [order.index(id(r["frame"])) for r in batch]
    centers = np.array([r["geom"][:2] for r in batch], np.float32)
    fovs = np.array([r["geom"][2] for r in batch], np.float32)
    ms = time_ms(lambda: ops.project_srois_batched(
        stack, idx, centers, fovs, (RUNG_SIZE, RUNG_SIZE)), reps=20)
    b_ms, b_by = project_bound(stack, idx, centers, fovs, RUNG_SIZE)
    print(f"rung {name}: {len(recs)} requests in chunks {chunks}; crops "
          f"against the float64 map: kernel {err_k:.3g}, plain {err_p:.3g} "
          f"(tol 2 x plain + 5e-5); detections against the crops run alone "
          f"max|err| "
          f"{worst:.3g} (tol {PER_REQUEST_ATOL})")
    print(f"kernel project_srois_batched B={len(batch)} S={RUNG_SIZE} (the "
          f"tick's {name} chunk, {len(order)} distinct 1920x3840x3 frames): "
          f"ms {ms:.4f}, bound_ms {b_ms:.5f} ({b_by}); {card_line()}")


def fleet_run(det_params, act_params, sink, act_launches=None):
    """One open-loop run of a ``FLEET_PODS``-pod fleet over 4 mixed
    streams (phase 6's construction), affinity routing, SLO admission,
    no placement; frames rendered when an arrival asks for them and
    dropped once served.  Returns (stats, detection backend, action
    backend, frames rendered)."""
    from repro_torch.data.synthetic import render_erp
    from repro_torch.serving.fleet import FleetServer
    from repro_torch.serving.runtime import make_policy
    from repro_torch.serving.server import PodServer
    from repro_torch.serving.traffic import ArrivalProcess

    tasks, videos, loops, backends, buckets, det, act = mixed_streams(
        det_params, act_params, (53, 54, 55, 56), 16, act_launches)
    rendered = [0]

    def source(s, f):
        rendered[0] += 1
        return render_erp(videos[s], f, height=1920, width=3840)

    def make_pod(pod_id):
        return PodServer(loops, backends, max_batch=MAX_BATCH,
                         buckets=buckets, frame_source=source,
                         policy=make_policy("sync", admission="slo"))

    fleet = FleetServer(make_pod, FLEET_PODS, routing="affinity",
                        telemetry=sink)
    traffic = ArrivalProcess(len(tasks), fps=FLEET_FPS, jitter=FLEET_JITTER,
                             seed=0, horizon_s=FLEET_FRAMES / FLEET_FPS)
    return fleet.run_open_loop(traffic, slo_s=FLEET_SLO_S), det, act, \
        rendered[0]


@contextlib.contextmanager
def nms_rule_rounds(into: dict):
    """Count, into ``into``, every round of ``sph_nms_batch(backend=
    "auto")`` by the backend its rule picks and the shape it is given:
    {(backend, rows, padded length): rounds}."""
    from repro_torch.core import sphere

    rule = sphere.nms_auto_backend

    def counted(b, n):
        got = rule(b, n)
        into[(got, b, n)] = into.get((got, b, n), 0) + 1
        return got

    sphere.nms_auto_backend = counted
    try:
        yield into
    finally:
        sphere.nms_auto_backend = rule


# the shapes at which the NMS crossover is timed: every (rows, padded
# length) of the NMS ladder from 8 to 256 boxes with at most the 512
# boxes from which ``auto`` has always taken the card
NMS_CROSSOVER = tuple((b, n) for b in (1, 2, 4, 8)
                      for n in (8, 16, 32, 64, 128, 256) if b * n <= 512)


def check_nms_rounds(rounds: dict) -> None:
    """The batched NMS at every shape the ``auto`` rule sent to the card
    on the serving paths (``rounds``, from :func:`nms_rule_rounds`) and at
    every ``NMS_CROSSOVER`` shape: the kernels' keep mask (``backend=
    "cuda"``) against the plain version's on the card (``"torch"``), bit
    for bit, on detection-like rows; at the crossover shapes also each
    backend's wall ms a call (the card's with its copies and
    synchronisation), host and card: what the rule weighs."""
    import torch

    from repro_torch.core.sphere import nms_auto_backend, sph_nms_batch

    on_card = {(b, n): k for (got, b, n), k in rounds.items()
               if got == "cuda"}
    by_rows: dict = {}
    for b, n in sorted(set(NMS_CROSSOVER) | set(on_card)):
        boxes, scores, mask = nms_inputs(b, n, 1000 * b + n)
        keep = sph_nms_batch(boxes, scores, mask, backend="cuda")
        plain = sph_nms_batch(boxes, scores, mask, backend="torch",
                              device="cuda")
        check(bool((keep == plain).all()), f"NMS {b}x{n}: the kernels' keep "
              f"mask differs from the plain version's on the card")
        if (b, n) not in NMS_CROSSOVER:
            continue
        ms = {}
        for backend in ("host", "cuda"):
            sph_nms_batch(boxes, scores, mask, backend=backend)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(20):
                sph_nms_batch(boxes, scores, mask, backend=backend)
            ms[backend] = (time.perf_counter() - t) * 1e3 / 20
        by_rows.setdefault(b, []).append(
            f"N={n} host {ms['host']:.3f} card {ms['cuda']:.3f} (rule: "
            f"{nms_auto_backend(b, n)})")
    for b, line in by_rows.items():
        print(f"NMS crossover B={b}, wall ms a call: {'; '.join(line)}; "
              f"{card_line()}")
    print(f"NMS keep masks, kernels against the plain version on the card, "
          f"bit-equal at the {len(NMS_CROSSOVER)} crossover shapes and at "
          f"every shape the auto rule sent to the card on the serving paths "
          f"(phases 5, 6 and 14), by (rows, padded length): rounds "
          f"{dict(sorted(on_card.items()))}")


def run_fleet_path(det_params) -> dict:
    """Phase 14 (d): the open-loop fleet with the real backends, run
    twice (bit-equal); returns the first run's launches."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.serving.fleet import format_fleet_report
    from repro_torch.serving.replay import stats_fingerprint
    from repro_torch.serving.tasks import default_action_configs
    from repro_torch.serving.telemetry import MemorySink

    act_params = action_params(default_action_configs())
    act_launches: dict = {}
    nms_rounds: dict = {}
    sink = MemorySink()
    torch.cuda.synchronize()
    with nms_rule_rounds(nms_rounds):
        _build.reset_launch_counts()
        t = time.perf_counter()
        fstats, det, act, rendered = fleet_run(det_params, act_params,
                                               sink, act_launches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = _build.launch_counts()
    horizon_s = FLEET_FRAMES / FLEET_FPS
    for line in format_fleet_report(fstats, horizon_s):
        print(f"fleet: {line}")
    by_task: dict = {}
    for st in fstats.pod_stats:
        for task, n in st.frames_by_task.items():
            by_task[task] = by_task.get(task, 0) + n
    print(f"fleet: {FLEET_PODS} pods, affinity routing, SLO admission at "
          f"{FLEET_SLO_S}s, arrivals at {FLEET_FPS} fps (jitter "
          f"{FLEET_JITTER}, seed 0, {FLEET_FRAMES} frames a stream); frames "
          f"served by task {by_task}, by pod "
          f"{[st.frames for st in fstats.pod_stats]}; {rendered} frames "
          f"rendered; frame uploads: detection {det.frame_uploads}, action "
          f"{act.frame_uploads} (open-loop rounds stage nothing); wall "
          f"{wall:.1f}s; {card_line()}")
    print(f"fleet launches: {launches}; of them the action path's "
          f"{act_launches}; NMS rounds by (backend, rows, padded length) "
          f"{nms_rounds}")
    check(len(by_task) == 2 and all(by_task.values()),
          f"the fleet served {by_task}, not both tasks")
    check(launches.get("project_srois_batched", 0) > 0,
          "the fleet's detection streams did not launch project_srois_batched")
    check(act_launches.get("gnomonic_sample", 0) > 0,
          "the fleet's action streams did not launch gnomonic_sample")
    # the suppression runs on the card in the rounds whose rule picked it,
    # one SphIoU and one greedy launch each
    on_card = sum(n for (got, _, _), n in nms_rounds.items() if got == "cuda")
    for k in ("sphiou_matrix_batch", "greedy_suppress_rows"):
        check(0 < launches.get(k, 0) == on_card,
              f"fleet: {k} launched {launches.get(k, 0)} times, the rule "
              f"picked the card in {on_card} rounds")
    fp, digests = stats_fingerprint(fstats), frame_digests(sink)
    sink2 = MemorySink()
    again = fleet_run(det_params, act_params, sink2)[0]
    same_fp = stats_fingerprint(again) == fp
    same_dig = frame_digests(sink2) == digests
    print(f"fleet run twice: report fingerprint equal {same_fp}; "
          f"{len(digests)} per-frame detection digests equal {same_dig}")
    check(same_fp and same_dig, "the fleet is not deterministic")
    return launches


# --------------------------------------------------------------------------
# phase 15: granite-34b's dense serving path
# --------------------------------------------------------------------------

# granite-34b's layers kept of its 88, batch, prompt tokens, decode steps
GRANITE_RUN = (8, 1, 4096, 32)


def run_granite_path() -> dict:
    """Phase 15: granite-34b at published width (MQA: 48 query heads on
    one KV head of 128), ``GRANITE_RUN``'s depth, bf16 weights from a
    seeded generator, ``attention_impl="flash"`` (the tensor-core kernel
    at row 6e's layout): prefill and greedy decode, each layer's attention
    and the logits against ``chunked``, the tokens digest over two runs.
    Returns the launches (counted from 0 before the first run, read after
    it)."""
    import dataclasses

    import torch

    from repro_torch.configs import granite_34b
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    from repro_torch.training.steps import lm_decode_step, lm_prefill_step

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    n_layers, b, s, n_dec = GRANITE_RUN
    full = granite_34b.full_config()
    cfg = dataclasses.replace(full, n_layers=n_layers,
                              attention_impl="flash")
    dev = torch.device("cuda")
    params = T.init_params(torch.Generator(device=dev).manual_seed(31), cfg,
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    gbytes = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    print(f"granite path: {cfg.name}, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head} (MQA), d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, attention_impl=flash, init "
          f"{time.perf_counter() - t0:.1f}s")
    print(f"reduced: {cfg.name} {full.n_layers} -> {n_layers} layers "
          f"({n_params / 1e9:.2f}B bf16 parameters, {gbytes:.1f} GB; all "
          f"{full.n_layers} would take {full.n_params * 2 / 1e9:.1f} GB), "
          f"published widths")
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(32))
    prefill = lm_prefill_step(cfg, s + n_dec)
    decode = lm_decode_step(cfg)
    prefill(params, {"tokens": tokens[:, :256]})  # warm-up: handles, library
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    logits, gen, prefill_ms, decode_ms, out = serve_lm(
        params, prefill, decode, tokens, n_dec, "granite")
    launches = _build.launch_counts()
    check(tuple(out["k"].shape) == (n_layers, b, s + n_dec, 1, cfg.d_head),
          f"granite cache {tuple(out['k'].shape)}")
    del out
    digest = tokens_digest(gen)
    print(f"granite prefill B={b} S={s}: prefill ms per request "
          f"{prefill_ms / b:.1f}; decode B={b}, {n_dec} greedy steps: decode "
          f"ms per token {decode_ms:.2f}; {card_line()}")
    print(f"granite generated tokens (B={b} x {n_dec}) sha256 {digest}; "
          f"first {gen[0, :8].tolist()}")
    print(f"granite launches: {launches} over one prefill of {n_layers} "
          f"layers (decode attends with plain einsums)")
    check(launches.get("flash_attention_wgmma", 0) == n_layers,
          f"flash_attention_wgmma launched "
          f"{launches.get('flash_attention_wgmma', 0)} times on granite's "
          f"path, not {n_layers}")
    check(launches.get("flash_attention", 0) == 0,
          "the SIMT flash_attention launched on granite's bf16 path")
    _, gen2, prefill_ms2, decode_ms2, _ = serve_lm(
        params, prefill, decode, tokens, n_dec, "granite")
    same = torch.equal(gen, gen2)
    print(f"granite run twice: tokens digest equal {same}; prefill ms "
          f"{prefill_ms2:.1f}, decode ms per token {decode_ms2:.2f}; "
          f"{card_line()}")
    check(same, "granite's generated tokens differ between two runs")
    against_chunked(params, cfg, tokens, logits, s + n_dec, "granite")
    check_each_layer(params, cfg, tokens, "granite", rows=1024)
    del params
    torch.cuda.empty_cache()
    print(f"granite path: {time.perf_counter() - t0:.1f}s; {card_line()}")
    return {k: launches.get(k, 0) for k in LM_KERNELS}


def check_moe_decode(params, cfg, tokens, n_prompt: int) -> None:
    """The first greedy decode step of a ``n_prompt``-token prompt against
    a prefill over the prompt and that token, at a capacity factor where
    no pick can drop (each expert's capacity is at least the tokens of
    the call: ``n_experts / top_k``); a control with the token changed
    must fail."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as T
    from repro_torch.training.steps import lm_decode_step, lm_prefill_step

    nd = dataclasses.replace(cfg, capacity_factor=float(
        cfg.n_experts // cfg.moe_top_k))
    prompt = tokens[:1, :n_prompt]
    routes: list = []
    out = lm_prefill_step(nd, n_prompt + 1, routes)(params,
                                                    {"tokens": prompt})
    token = out["logits"].argmax(-1)
    dec = lm_decode_step(nd, routes)(params, {
        "token": token, "cache_k": out["k"], "cache_v": out["v"],
        "cache_len": out["length"]})["logits"]

    def prefilled(last):
        return lm_prefill_step(nd, n_prompt + 1, routes)(params, {
            "tokens": torch.cat([prompt, last[:, None]], 1)})["logits"]

    want = prefilled(token)
    control = prefilled((token + 1) % cfg.vocab_size)
    dropped = int(sum(int((~r.keep).sum()) for r in routes))
    err = float((dec - want).abs().max())
    err_c = float((dec - control).abs().max())
    print(f"MoE {cfg.name} decode against prefill: the first decode step "
          f"after a {n_prompt}-token prompt against a prefill over the "
          f"prompt and that token, capacity factor {nd.capacity_factor} "
          f"(capacity {T.moe_capacity(nd, n_prompt + 1)} an expert at "
          f"{n_prompt + 1} tokens, {T.moe_capacity(nd, 1)} in decode): "
          f"max|err| {err:.3g} (tol {LM_LOGIT_ATOL}); picks dropped "
          f"{dropped}; the control with the token changed {err_c:.3g} "
          f"(fails)")
    check(dropped == 0, f"{cfg.name}: {dropped} picks dropped at capacity "
          f"factor {nd.capacity_factor}")
    check(err <= LM_LOGIT_ATOL, f"{cfg.name} decode against prefill: {err}")
    check(err_c > LM_LOGIT_ATOL, f"{cfg.name} decode against prefill: the "
          f"control passes ({err_c})")


def profile_call(fn, what: str) -> None:
    """One call of ``fn`` under the profiler: the card's busy share and
    its top kernels."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    print_profile(prof, wall, what, top=12)


def run_serve_launcher() -> None:
    """The port's serve launcher (``repro_torch.launch.serve``) on its
    oracle pod: the async policy with pod-level allocation over virtual
    replica groups.  No kernel runs there; its summary lines print."""
    import io

    from repro_torch.launch import serve

    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        serve.main(["--streams", "8", "--frames", "8", "--policy", "async",
                    "--pod-allocate", "--devices", "8"])
    lines = out.getvalue().splitlines()
    check(bool(lines) and lines[0].startswith("served 64 frames"),
          f"serve launcher: {lines[:1]}")
    for line in lines:
        print(f"serve launcher (oracle, --policy async --pod-allocate): "
              f"{line}")
    print(f"serve launcher: {(time.perf_counter() - t) * 1e3:.1f} ms wall")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------
# phase 16: mixtral-8x22b's MoE training
# --------------------------------------------------------------------------

# mixtral-8x22b at published width trains on MOE_TRAIN_LAYERS of its 56
# layers (one layer is 2.907B parameters: a second does not fit one card
# with any AdamW state), on train_4k's sequence with its global batch of
# 256 cut to MOE_TRAIN_BATCH, MOE_TRAIN_STEPS steps of adamw with bf16
# moments (moe_train_reckoning: float32 moments do not fit)
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 1, 2, 3
# the step-time prediction's float32 rate: cuBLAS's SGEMM on the H100
# (67 TFLOP/s peak outside the tensor cores), which the expert products
# and the CE's logits run on under autograd (both widen bf16 operands)
MOE_TRAIN_F32_FLOPS = 50e12
# the MoE block's gradients (x, the router, the three expert stacks) under
# bf16 against the float32 policy, on MOE_GRAD_TOKENS of the batch's
# tokens routed alike under both, as relative Frobenius errors.  From the
# same input and weight values, the bf16 path rounds to bf16 (unit
# roundoff 2^-8) on the way to each gradient: the router logits, the
# SwiGLU hidden, each expert output, the gate, the gated product and the
# pick sum in the forward; the cotangent, the gated cotangent, the
# hidden's cotangent, the widened operands' cotangents and the gradient
# itself in the backward.  At most 8 such roundings lie on one path, so
# to first order each gradient lies within 8 u = 2^-5 of the float32
# policy's.  The control is the bf16 gradients under another seeded
# cotangent, which lie ~sqrt(2) away
MOE_GRAD_TOKENS = 512
MOE_GRAD_RTOL = 8 * 2.0 ** -8


# bytes a slice element of the leaf update's temporaries, at most: the
# clipped float32 gradient (4) and up to 8 float32 values of AdamW's upd
# alive at once (the new moments and parameter among them: 32), rounded
# up (an NVIDIA H100 80GB HBM3 at 700.00 W read 36.0 on a 2 GiB float32
# leaf)
LEAF_SLICE_BYTES = 40


def _slice_elems(shape) -> int:
    """The elements of the largest slice the leaf update takes of a leaf
    of ``shape`` (``optimizer._leaf_update``: runs of whole rows of the
    first dimension whose rows fit in ``SLICE_ELEMS``)."""
    from repro_torch.training import optimizer as opt_mod

    n = math.prod(shape)
    if n <= opt_mod.SLICE_ELEMS:
        return n
    dim = next(d for d in range(len(shape))
               if math.prod(shape[d + 1:]) <= opt_mod.SLICE_ELEMS)
    row = math.prod(shape[dim + 1:])
    return min(shape[dim], opt_mod.SLICE_ELEMS // row) * row


def update_peaks(shapes, moment_bytes: int, param_bytes: int = 2
                 ) -> tuple[float, float]:
    """The AdamW update's reckoned peak (bytes) over leaves of ``shapes``
    (``jax.tree.flatten`` order): (the whole-tree composition the train
    steps used before, ``clip_by_global_norm`` then ``update``: the
    caller's state, the gradients that ``_train_step`` kept alive, their
    float32 clipped copies, the new state of the leaves done and ~24
    bytes an element of the leaf in hand; the leaf update,
    ``clip_and_update``: the caller's state, the gradients of the leaves
    not yet done, the new state of the leaves done and of the leaf in
    hand, and ``LEAF_SLICE_BYTES`` an element of its largest slice)."""
    sizes = [math.prod(sh) for sh in shapes]
    n = sum(sizes)
    per = param_bytes + 2 * moment_bytes  # a parameter's state
    whole = leaf = done = 0
    for sh, k in zip(shapes, sizes):
        whole = max(whole, per * n + (param_bytes + 4) * n + per * done
                    + 24 * k)
        leaf = max(leaf, per * n + param_bytes * (n - done)
                   + per * (done + k) + LEAF_SLICE_BYTES * _slice_elems(sh))
        done += k
    return whole, leaf


def moe_train_reckoning(params, cfg, b: int, s: int) -> dict:
    """The train step's predicted update peaks (bytes, :func:`update_peaks`)
    with float32 and with bf16 AdamW moments, and its predicted ms."""
    from repro_torch import pytree
    from repro_torch.models import transformer as T

    shapes = [tuple(t.shape) for t in pytree.leaves(params)]
    whole_f32, leaf_f32 = update_peaks(shapes, 4)
    whole_bf16, leaf_bf16 = update_peaks(shapes, 2)
    # float32 FLOPs a step: each expert product and the CE's logits run
    # four times (forward, remat's forward, two backward products)
    cap = T.moe_capacity(cfg, b * s)
    expert = 3 * 2 * cfg.n_experts * cap * cfg.d_model * cfg.d_ff_expert
    ce = 2 * b * s * cfg.d_model * cfg.vocab_size
    flops = 4 * (expert * cfg.n_layers + ce)
    return {"n": sum(math.prod(sh) for sh in shapes),
            "widest": max(math.prod(sh) for sh in shapes),
            "peak_f32": whole_f32, "peak_bf16": whole_bf16,
            "leaf_f32": leaf_f32, "leaf_bf16": leaf_bf16, "flops": flops,
            "ms": flops / MOE_TRAIN_F32_FLOPS * 1e3}


def state_digest(tree) -> str:
    """A digest of every leaf's bits, computed on the leaves' device: each
    leaf's 16- or 32-bit words, each times a pseudo-random odd 64-bit
    weight of its index (a multiply-xorshift hash), summed wrapping at
    2^64; then sha256 over those sums, the leaves' shapes and dtypes, in
    ``jax.tree.flatten`` order.  A change of any word changes the sum (an
    odd weight times a non-zero difference of under 2^32 is not 0 mod
    2^64).  sha256 of the bytes copied to the host took ~8 s a digest for
    mixtral's 17.4 GB of parameters and moments (beside an NVIDIA H100
    80GB HBM3 at 700.00 W)."""
    import hashlib

    import torch

    from repro_torch import pytree

    k1, k2 = -0x61C8864680B583EB, -0x40A7B892E31B1A47  # odd, as int64
    chunk = 1 << 26
    h = hashlib.sha256()
    for leaf in pytree.leaves(tree):
        flat = leaf.detach().reshape(-1)
        words = flat.view(torch.int16 if flat.element_size() == 2
                          else torch.int32)
        acc = torch.zeros((), dtype=torch.int64, device=flat.device)
        for lo in range(0, words.numel(), chunk):
            w = torch.arange(lo, min(lo + chunk, words.numel()),
                             dtype=torch.int64, device=flat.device) * k1
            w = (w ^ (w >> 29)) * k2
            w |= 1
            acc += (w * words[lo:lo + chunk].to(torch.int64)).sum()
        h.update(f"{tuple(leaf.shape)} {leaf.dtype} {int(acc)};".encode())
    return h.hexdigest()[:16]


def moe_route_stats(params, batch, cfg) -> tuple[float, int, int]:
    """A no-grad forward's (MoE aux loss, picks dropped, picks): the
    routing the train step's forward takes at these parameters."""
    import torch

    from repro_torch.models import transformer as T

    routes: list = []
    with torch.no_grad():
        _, aux = T.forward(params, batch["tokens"], cfg, routes=routes)
    return (float(aux), sum(int((~r.keep).sum()) for r in routes),
            sum(r.keep.numel() for r in routes))


def run_moe_train(profile: bool = False, arch: str = "mixtral_8x22b",
                  seed: int = 160) -> dict:
    """Phase 16 (mixtral-8x22b) and phase 19 (qwen3-moe): ``arch``'s
    MoE training, its weights from ``seed``, its batches from ``seed //
    10``; returns the launches of the MoE train path (none: its attention
    is ``chunked``, and ``flash_attention`` has no backward)."""
    import dataclasses
    import importlib

    import torch

    from repro_torch import pytree
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.data.pipeline import Prefetcher, lm_batches
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod

    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    card = card_line()
    full = importlib.import_module(
        f"repro_torch.configs.{arch}").full_config()
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    spec = LM_SHAPES["train_4k"]
    b, s = MOE_TRAIN_BATCH, spec.seq_len
    dev = torch.device("cuda")
    t = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(seed),
                           cfg, device=dev)
    torch.cuda.synchronize()
    rk = moe_train_reckoning(params, cfg, b, s)
    per_layer = sum(x.numel() for x in pytree.leaves(params["layers"]))
    # two layers: every stacked layer leaf twice as deep
    two_layers = update_peaks(
        [tuple(x.shape) for k, v in params.items() if k != "layers"
         for x in pytree.leaves(v)]
        + [(2 * x.shape[0],) + tuple(x.shape[1:])
           for x in pytree.leaves(params["layers"])], 2)[1]

    print(f"MoE train path: {cfg.name} at published width (d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.d_head}, {cfg.n_experts} experts top-{cfg.moe_top_k}, "
          f"d_ff_expert {cfg.d_ff_expert}, vocab {cfg.vocab_size}, window "
          f"{cfg.window}, bf16, attention_impl={cfg.attention_impl}, "
          f"remat={cfg.remat}, ce_chunk {cfg.ce_chunk}), capacity factor "
          f"{cfg.capacity_factor}; adamw lr 1e-3 warmup 10, bf16 moments; "
          f"init on the card {time.perf_counter() - t:.1f} s")
    print(f"reduced: {cfg.name} {full.n_layers} -> {cfg.n_layers} layers "
          f"({rk['n'] / 1e9:.3f}B parameters, "
          f"{2 * rk['n'] / 1e9:.2f} GB in bf16; two layers hold "
          f"{(rk['n'] + per_layer) / 1e9:.3f}B, whose leaf update alone "
          f"would peak at {two_layers / 1e9:.1f} GB with bf16 moments, "
          f"beside the backward's activations); "
          f"train_4k's global batch {spec.global_batch} -> {b} (sequence "
          f"{s} kept): one card, no gradient accumulation")
    print(f"MoE train reckoning: widest leaf {rk['widest'] / 1e6:.0f}M "
          f"parameters; the whole-tree update (clip_by_global_norm then "
          f"update, as the train steps composed it before the leaf update) "
          f"would peak at {rk['peak_f32'] / 1e9:.1f} GB with float32 "
          f"moments and {rk['peak_bf16'] / 1e9:.1f} GB with bf16 ones (the "
          f"allocator gets ~85 GB); the leaf update (clip_and_update) at "
          f"{rk['leaf_f32'] / 1e9:.1f} and {rk['leaf_bf16'] / 1e9:.1f} GB; "
          f"predicted step {rk['ms']:.0f} ms ({rk['flops'] / 1e12:.1f} "
          f"TFLOP of float32 expert products and CE logits at "
          f"{MOE_TRAIN_F32_FLOPS / 1e12:.0f} TFLOP/s); {card}")
    batches = [pytree.tree_map(lambda v: torch.as_tensor(v, device=dev), x)
               for x in Prefetcher(lm_batches(cfg.vocab_size, b, s,
                                              seed=seed // 10,
                                              n_batches=MOE_TRAIN_STEPS))]

    # (b) step 1's per-token NLL against the float32 policy's, and (c) the
    # MoE block's gradients against the float32 policy's: both before the
    # moments are allocated (a float32 copy of the model, 4 bytes a parameter)
    check_policy_nll(params, batches[0], cfg, f"{cfg.name} step 1 batch")
    torch.cuda.empty_cache()
    check_moe_grads(params, batches[0], cfg, seed + 1)
    torch.cuda.empty_cache()

    # (a) every gradient leaf finite, each group non-zero, at the initial
    # weights
    loss0, grads = steps_mod.value_and_grad(
        lambda p: T.lm_loss(p, batches[0], cfg), params)
    lyr = grads["layers"]
    groups = {"embed": grads["embed"]["emb"], "unembed": grads["unembed"]["w"],
              "ln_f": grads["ln_f"]["scale"]}
    for part, keys in (("attn", ("wq", "wk", "wv", "wo")),
                       ("ln1", ("scale",)), ("ln2", ("scale",)),
                       ("moe", ("router", "w_gate", "w_up", "w_down"))):
        for k in keys:
            groups[f"{part}.{k}"] = lyr[part][k]
    check_grads(grads, groups, cfg.name)
    del grads, lyr, groups
    torch.cuda.empty_cache()

    opt = opt_mod.adamw(lr=1e-3, warmup_steps=10, state_dtype=torch.bfloat16)
    step = steps_mod.lm_train_step(cfg, opt)
    # the one reference to the state: the loop rebinds it, so that a
    # step's input state is freed once the next step has its output
    state = steps_mod.make_state(params, opt)
    del params
    peaks, times = [], []
    for i, batch in enumerate(batches):
        aux, dropped, picks = moe_route_stats(state["params"], batch, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        times.append(ms)
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        print(f"{cfg.name} train step {int(m['step'])}: {ms:.1f} ms, "
              f"{b * s / ms * 1e3:.0f} tokens/s, loss {loss:.6f}"
              + (f" (the gradient check's {float(loss0):.6f})" if i == 0
                 else "")
              + f", aux loss {aux:.6f}, grad norm {gnorm:.6f}, picks dropped "
              f"{dropped} of {picks}, peak memory {peaks[-1]:.2f} GB")
        check(math.isfinite(loss) and math.isfinite(gnorm),
              f"{cfg.name}: non-finite loss or grad norm")
    print(f"{cfg.name} train: batch {b} x {s}, {min(times):.1f} ms a step at "
          f"best ({b * s / min(times) * 1e3:.0f} tokens/s), peak memory "
          f"{max(peaks):.2f} GB; predicted {rk['ms']:.0f} ms; the update "
          f"reckoned at {rk['leaf_bf16'] / 1e9:.1f} GB (the whole-tree "
          f"update's {rk['peak_bf16'] / 1e9:.1f} GB); {card}")
    if profile:
        profile_train_step(step, state, batches[-1], cfg.name)

    # (d) one step twice from the same state: the new parameters' and
    # moments' digest, each result hashed and freed before the next; the
    # control moves one parameter by one ulp
    def digest(st):
        new, _ = step(st, batches[0])
        out = state_digest({"params": new["params"], "mu": new["opt"]["mu"],
                            "nu": new["opt"]["nu"]})
        del new
        return out

    t = time.perf_counter()
    runs = [digest(state), digest(state)]
    scale = state["params"]["ln_f"]["scale"].clone()
    scale[0] = torch.nextafter(scale[0], torch.full_like(scale[0], math.inf))
    moved = dict(state, params=dict(state["params"],
                                    ln_f={"scale": scale}))
    ctl = digest(moved)
    print(f"{cfg.name} one step twice from one state (step "
          f"{int(state['step']) + 1}): the new parameters' and moments' "
          f"digest (state_digest) {runs[0]} / {runs[1]} "
          f"({'bit-equal' if runs[0] == runs[1] else 'NOT bit-equal'}); "
          f"the control with ln_f.scale[0] one ulp up {ctl} "
          f"({'differs' if ctl != runs[0] else 'EQUAL'}); "
          f"{time.perf_counter() - t:.1f} s for the three steps and digests")
    check(runs[0] == runs[1], f"{cfg.name}: one step twice from one state "
          f"differs")
    check(ctl != runs[0], f"{cfg.name}: the moved-parameter control gave "
          f"the same digest")
    del state, moved, scale, batches
    torch.cuda.empty_cache()
    launched = _build.launch_counts()
    print(f"MoE train launches: {launched}")
    check(not launched, "the MoE train path launched a kernel, which has "
          "no backward")
    return launched


def check_moe_grads(params, batch, cfg, seed: int) -> None:
    """(c) Layer 0's ``moe_block`` on ``MOE_GRAD_TOKENS`` of the batch's
    tokens (its input: the first sequence's embeddings through layer 0's
    attention half), bf16 against the float32 policy on the widened
    weights and input: the gradients of ``sum(out * cot)`` with respect to
    x, the router and the three expert stacks, as relative Frobenius
    errors within ``MOE_GRAD_RTOL``.  At a capacity factor with no drops,
    on the tokens both policies route to the same experts; the control is
    the bf16 gradients under another seeded cotangent."""
    import dataclasses

    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    n, keys = MOE_GRAD_TOKENS, ("router", "w_gate", "w_up", "w_down")
    lp = T._layer_params(params, 0)
    with torch.no_grad():
        tokens = batch["tokens"][:1, :n]
        x = L.embedding(params["embed"], tokens, cfg.policy)
        pos = torch.arange(n, device=tokens.device)
        q, k, v = T._qkv(lp, x, cfg, pos)
        att = T.attention(q, k, v, cfg, causal=True, window=cfg.window)
        xa = x + L.dense({"w": lp["attn"]["wo"]},
                         att.reshape(1, n, cfg.n_heads * cfg.d_head),
                         cfg.policy)
        h2 = L.rmsnorm(lp["ln2"], xa, cfg.norm_eps).reshape(n, cfg.d_model)
    nd = dataclasses.replace(cfg, capacity_factor=float(
        cfg.n_experts // cfg.moe_top_k))
    nd32 = dataclasses.replace(nd, param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    moe32 = {k: lp["moe"][k].float() for k in keys}
    routes: list = []
    with torch.no_grad():
        T.moe_block(lp["moe"], h2, nd, routes)
        T.moe_block(moe32, h2.float(), nd32, routes)
    same = (routes[0].expert_ids.sort(1).values
            == routes[1].expert_ids.sort(1).values).all(1)
    x16 = h2[same]
    gen = torch.Generator(device=h2.device).manual_seed(seed)
    cot, cot2 = (torch.randn((x16.shape[0], cfg.d_model), generator=gen,
                             device=h2.device) for _ in range(2))

    def grads(p, x, c, ct):
        leaves = {k: p[k].detach().requires_grad_() for k in keys}
        xx = x.detach().requires_grad_()
        out, _ = T.moe_block(leaves, xx, c)
        return torch.autograd.grad((out.float() * ct).sum(),
                                   [xx] + [leaves[k] for k in keys])

    g32 = grads(moe32, x16.float(), nd32, cot)
    del moe32
    g16 = grads(lp["moe"], x16, nd, cot)
    names = ("x",) + keys
    errs = [float((a.float() - r).norm() / r.norm()) for a, r in zip(g16, g32)]
    del g16
    g16c = grads(lp["moe"], x16, nd, cot2)
    ctls = [float((a.float() - r).norm() / r.norm())
            for a, r in zip(g16c, g32)]
    del g16c, g32
    print(f"{cfg.name} layer-0 MoE block gradients, bf16 against the float32 "
          f"policy ({int(same.sum())} of {n} tokens routed alike, capacity "
          f"factor {nd.capacity_factor}, no drops): |g16 - g32| / |g32| "
          + ", ".join(f"{k} {e:.4g}" for k, e in zip(names, errs))
          + f" (limit {MOE_GRAD_RTOL:.4g}); the control under another "
          f"cotangent " + ", ".join(f"{k} {e:.4g}" for k, e in
                                   zip(names, ctls)))
    check(int(same.sum()) >= n // 2, f"{cfg.name}: only {int(same.sum())} "
          f"of {n} tokens routed alike under bf16 and float32")
    check(max(errs) <= MOE_GRAD_RTOL, f"{cfg.name}: MoE gradients {errs} "
          f"from the float32 policy's")
    check(min(ctls) > MOE_GRAD_RTOL, f"{cfg.name}: the cotangent control "
          f"passed the MoE gradient check: {ctls}")


# --------------------------------------------------------------------------
# phase 17: the cls_384 and train_1024 training shapes, unet-sdxl's whole
# gen_1024 sample
# --------------------------------------------------------------------------

# train_1024's batch of 32 is halved, per arch, until the reckoned
# train-step peak stays under DIFF_1024_PEAK_GB: in the backward, 12 bytes
# a parameter (bf16 parameters and gradients, float32 moments) and, a
# sample, DIFF_SCORE_BUFFERS float32 tensors the size of the largest
# attention call's scores (``diffusion_score_bytes``: flux's (24, 4608,
# 4608) are 2.04 GB a sample a block, the UNet's at its 64² level 0.67 GB
# a sample a call), which lead the activations at 128² latents.  Six
# such buffers live at once in that call's backward (the scores, their
# scaled copy, the probabilities, the gradients of the three); on an
# NVIDIA H100 80GB HBM3 at 700.00 W flux at batch 4 peaked at 67.04 GB
# (5.4 a sample over the 12 bytes) and the UNet at batch 13 ran out of
# memory.  A measure from one- and two-sample gradients was tried first
# and read 3.19 GB a sample for the UNet, 8.47 and 3.27 in two runs for
# flux: too low and not stable.  DIFF_FRAGMENTATION_GB of the line is
# kept for the caching allocator's blocks that a step cannot use after
# the script's earlier phases: in the whole script flux at batch 4
# (reckoned 71.9 GB) ran out of memory at its second step with 29.5 GB
# reserved and unallocated, where alone it had run; the UNet at 8
# (reckoned 63.2 GB) ran in both.  The update's peak (26 bytes a
# parameter) must stay under the line too
DIFF_1024_PEAK_GB, DIFF_FRAGMENTATION_GB = 75.0, 10.0
DIFF_SCORE_BUFFERS = 6
DIFF_1024_STEPS = 2
# unet-sdxl's gen_1024 sample, whole: its latents after DIFF_GEN1024_STEPS
# steps must be phase 11's digest, which read 12ca0e5efbb88f6c in all of
# its chip runs so far (seed 71: phase 11's unet-sdxl seed)
UNET_GEN1024_SEED = 71
UNET_GEN1024_DIGEST = "12ca0e5efbb88f6c"


def run_train_shapes() -> dict:
    """Phase 17; returns the launches of its three paths (none: their
    attention is the plain one, their convolutions cuDNN's)."""
    import torch

    from repro_torch.kernels import _build

    launched = {}
    for path, run in (("vision_train_384", train_vision_384),
                      ("diffusion_train_1024", train_diffusion_1024),
                      ("diffusion_gen_1024", sample_unet_1024)):
        torch.cuda.empty_cache()
        _build.reset_launch_counts()
        t = time.perf_counter()
        run()
        launched[path] = _build.launch_counts()
        print(f"{path}: {time.perf_counter() - t:.1f}s")
    torch.cuda.empty_cache()
    print(f"train shapes launches: {launched}")
    check(not any(launched.values()), "a path of phase 17 launched a kernel")
    return launched


def train_vision_384() -> None:
    """Each vision arch at ``cls_384`` (64 x 384², bf16, remat; ViT-B/16
    through ``config_for_res(384)``, its 577-token position table):
    the gradients at the initial weights, ``VISION_TRAIN_STEPS``
    ``vision_train_step``s, then the bf16 logits against the float32
    policy's at 384."""
    import dataclasses
    import importlib

    import torch

    from repro_torch.configs import vit_b16
    from repro_torch.configs.base import VISION_SHAPES
    from repro_torch.models import vision as V
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod

    spec = VISION_SHAPES["cls_384"]
    b, res = spec.batch, spec.img_res
    dev = torch.device("cuda")
    for i, arch in enumerate(VISION_ARCHS):
        mod = importlib.import_module(f"repro_torch.configs.{arch}")
        cfg = vit_b16.config_for_res(res) if mod is vit_b16 else \
            dataclasses.replace(mod.full_config(), img_res=res)
        seed = 170 + i
        params = V.init_params(torch.Generator(device=dev).manual_seed(seed),
                               cfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        batches = [{"images": torch.randn((b, res, res, 3), generator=gen,
                                          device=dev),
                    "labels": torch.randint(0, cfg.n_classes, (b,),
                                            generator=gen, device=dev,
                                            dtype=torch.int32)}
                   for _ in range(VISION_TRAIN_STEPS)]
        print(f"vision train: {cfg.name}, bf16, remat={cfg.remat}, batch {b} "
              f"x {res}² (cls_384), adamw lr 1e-3 warmup 10")
        check_vision_grads(cfg, params, batches[0])
        opt = opt_mod.adamw(lr=1e-3, warmup_steps=10)
        step = steps_mod.vision_train_step(cfg, opt)
        state = vision_train_steps(
            cfg, step, [steps_mod.make_state(params, opt)], batches)
        del state, batches
        torch.cuda.empty_cache()
        check_vision_policy(cfg, params, seed, weights_control=True)
        del params
        torch.cuda.empty_cache()


def train_diffusion_1024() -> None:
    """unet-sdxl and flux-dev (on ``FLUX_TRAIN_BLOCKS``) at
    ``train_1024`` (128² latents), the batch halved as
    ``DIFF_1024_PEAK_GB`` reckons it: the gradients at the initial
    weights, then ``DIFF_1024_STEPS`` ``diffusion_train_step``s."""
    import dataclasses
    import importlib

    import torch

    from repro_torch import pytree
    from repro_torch.configs.base import DIFFUSION_SHAPES
    from repro_torch.models import diffusion as D
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import steps as steps_mod

    spec = DIFFUSION_SHAPES["train_1024"]
    dev = torch.device("cuda")
    for i, arch in enumerate(("unet_sdxl", "flux_dev")):
        mod = importlib.import_module(f"repro_torch.configs.{arch}")
        cfg = mod.full_config()
        is_flux = isinstance(cfg, D.MMDiTConfig)
        if is_flux:
            nd, ns = FLUX_TRAIN_BLOCKS
            cfg = dataclasses.replace(cfg, n_double_blocks=nd,
                                      n_single_blocks=ns)
        seed = 175 + i
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = D.init_params(gen, cfg, device=dev)
        if is_flux:
            params = D.perturb_modulation(params, gen)
        n = sum(p.numel() for p in pytree.leaves(params))
        res = spec.img_res // mod.VAE_FACTOR

        limit = DIFF_1024_PEAK_GB * 1e9
        act = DIFF_SCORE_BUFFERS * diffusion_score_bytes(cfg, res)
        b = spec.batch
        while b > 1 and 12 * n + b * act + DIFF_FRAGMENTATION_GB * 1e9 \
                > limit:
            b //= 2
        cut = (f"{cfg.n_double_blocks} double and {cfg.n_single_blocks} "
               f"single blocks, " if is_flux else "")
        print(f"diffusion train: {cfg.name} ({cut}{n / 1e9:.3f}B parameters, "
              f"bf16, remat={cfg.remat}) at train_1024 ({res}² latents), "
              f"adamw lr 1e-3 warmup 10")
        print(f"reduced: {cfg.name} train_1024's batch {spec.batch} -> {b}: "
              f"{DIFF_SCORE_BUFFERS} float32 score tensors of "
              f"{act / DIFF_SCORE_BUFFERS / 1e9:.2f} GB a sample, 12 bytes a "
              f"parameter {12 * n / 1e9:.1f} GB -> reckoned peak "
              f"{(12 * n + b * act) / 1e9:.1f} GB (the update, 26 bytes a "
              f"parameter: {26 * n / 1e9:.1f} GB), under {DIFF_1024_PEAK_GB} "
              f"GB less {DIFF_FRAGMENTATION_GB} GB for the allocator's "
              f"fragmentation")
        check(26 * n <= limit, f"{cfg.name}: the update alone passes "
              f"{DIFF_1024_PEAK_GB} GB")
        g = torch.Generator(device=dev).manual_seed(seed)
        batches = [{**diffusion_inputs(cfg, b, res, seed + j),
                    "seed": torch.randint(0, 2 ** 31, (), generator=g,
                                          device=dev)}
                   for j in range(DIFF_1024_STEPS)]
        check_diffusion_grads(cfg, params, batches[0])
        opt = opt_mod.adamw(lr=1e-3, warmup_steps=10)
        step = steps_mod.diffusion_train_step(cfg, opt)
        held = [steps_mod.make_state(params, opt)]
        del params
        state = diffusion_train_steps(cfg, step, held, batches)
        del state, batches
        torch.cuda.empty_cache()


def diffusion_score_bytes(cfg, res: int) -> int:
    """The bytes of one sample's largest float32 attention scores at
    ``res``² latents: flux's joint attention over the image patches and
    the context tokens, or the UNet's self-attention at its finest level
    with attention (level 0 has none; each level halves the resolution)."""
    from repro_torch.models import diffusion as D

    if isinstance(cfg, D.MMDiTConfig):
        tokens = (res // cfg.patch) ** 2 + cfg.n_ctx_tokens
        return 4 * cfg.n_heads * tokens ** 2
    return max(4 * (cfg.ch * m // cfg.head_dim) * (res >> li) ** 4
               for li, m in enumerate(cfg.ch_mult) if li > 0)


def sample_unet_1024() -> None:
    """unet-sdxl's ``gen_1024`` sample whole: 4 x 128² latents, all 50
    DDIM steps of ``diffusion_denoise_step`` from phase 11's weights and
    inputs (seed ``UNET_GEN1024_SEED``), after its warm-up step.  The
    latents after ``DIFF_GEN1024_STEPS`` steps must be phase 11's digest;
    the control, the digest a step later, must differ."""
    import hashlib

    import torch

    from repro_torch.configs import unet_sdxl
    from repro_torch.configs.base import DIFFUSION_SHAPES
    from repro_torch.models import diffusion as D
    from repro_torch.training import steps as steps_mod

    cfg = unet_sdxl.full_config()
    spec = DIFFUSION_SHAPES["gen_1024"]
    res = spec.img_res // unet_sdxl.VAE_FACTOR
    dev = torch.device("cuda")
    params = D.init_params(
        torch.Generator(device=dev).manual_seed(UNET_GEN1024_SEED), cfg,
        device=dev)
    step = steps_mod.diffusion_denoise_step(cfg)
    inputs = diffusion_inputs(cfg, spec.batch, res, UNET_GEN1024_SEED)
    t0 = 999.0
    dt = t0 / spec.steps
    sample(step, params, cfg, inputs, t0, dt, 1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    x, times, digests = inputs["latents"], [], {}
    for i in range(spec.steps):
        batch = denoise_batch(cfg, inputs, x, t0 - i * dt, dt)
        t = time.perf_counter()
        x = step(params, batch)["latents"]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if i + 1 in (DIFF_GEN1024_STEPS, DIFF_GEN1024_STEPS + 1,
                     spec.steps):
            digests[i + 1] = hashlib.sha256(
                x.cpu().numpy().tobytes()).hexdigest()[:16]
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(x.dtype == torch.float32 and bool(torch.isfinite(x).all()),
          f"{cfg.name} gen_1024: latents {x.dtype}, not all finite")
    ms = sum(times) / len(times)
    want = SERVE_DIGESTS.get((cfg.name, "gen_1024"), UNET_GEN1024_DIGEST)
    two, three = digests[DIFF_GEN1024_STEPS], digests[DIFF_GEN1024_STEPS + 1]
    print(f"{cfg.name} gen_1024 ({spec.batch} x {res}² latents, whole "
          f"sample): {spec.steps} steps, {ms:.1f} ms a step (min "
          f"{min(times):.1f}, max {max(times):.1f}), "
          f"{sum(times) / 1e3:.2f} s a sample, "
          f"{spec.batch / sum(times) * 1e3:.3f} samples/s, peak memory "
          f"{peak:.2f} GB, latents sha256 {digests[spec.steps]}; "
          f"{card_line()}")
    print(f"{cfg.name} gen_1024 after {DIFF_GEN1024_STEPS} steps: sha256 "
          f"{two} against phase 11's {want} "
          f"({'equal' if two == want else 'DIFFERS'}); the control after "
          f"{DIFF_GEN1024_STEPS + 1} steps {three} "
          f"({'differs' if three != want else 'EQUAL'})")
    check(two == want, f"{cfg.name} gen_1024: {two} after "
          f"{DIFF_GEN1024_STEPS} steps, phase 11's {want}")
    check(three != want, f"{cfg.name} gen_1024: the 3-step control has "
          f"the 2-step digest")
    del params, inputs, x


# --------------------------------------------------------------------------
# phase 18: the launch layer's cells that phase 12 leaves
# --------------------------------------------------------------------------

# (arch, shape, cut, held): each cell whole where it fits one card, else at
# the cut (printed as reduced); a cell whose fake count and its control's
# would take more than ~3 s together (~1 ms an op on fake tensors: the
# phase's budget) holds both at ``held`` too (a shallower depth) and
# counts the run's size on real tensors alone.  With phase 12's four
# cells these are the reference table's 37 counted cells
_UNET_LEVEL0 = {"ch_mult": (1,), "transformer_depth": (1,),
                "n_res_blocks": 1}
_FLUX_HELD = {"n_double_blocks": 2, "n_single_blocks": 2}
CELL_PLAN = (
    # vision: phases 10 and 17 run these steps at these shapes
    ("vit_b16", "cls_224", {}, {"n_layers": 2}),
    ("vit_b16", "cls_384", {}, {"n_layers": 2}),
    ("vit_b16", "serve_b1", {}, None),
    ("convnext_b", "cls_224", {}, {"depths": (1, 1, 3, 1)}),
    ("convnext_b", "cls_384", {}, {"depths": (1, 1, 3, 1)}),
    ("convnext_b", "serve_b1", {}, None),
    ("convnext_b", "serve_b128", {}, None),
    ("resnet_152", "cls_224", {}, {"depths": (1, 1, 2, 1)}),
    ("resnet_152", "cls_384", {}, {"depths": (1, 1, 2, 1)}),
    ("resnet_152", "serve_b1", {}, {"depths": (1, 1, 2, 1)}),
    ("resnet_152", "serve_b128", {}, {"depths": (1, 1, 2, 1)}),
    ("resnet_50", "cls_384", {}, {"depths": (1, 1, 2, 1)}),
    ("resnet_50", "serve_b1", {}, None),
    ("resnet_50", "serve_b128", {}, None),
    # unet-sdxl: a train step's ~33k ops (the update's ~20 a leaf over 456
    # leaves among them) hold their fake = real check at the first level
    # (its res block, the mid block's transformer), at 128^2 latents on
    # one sample (the mid block's scores at full resolution: 5.4 GB a
    # sample).  For the phase's time the train batches are cut (phases
    # 11 and 17 train the same step at 256 and 8): the count at the run's
    # size is host-bound, the steps are not
    ("unet_sdxl", "gen_1024", {}, {"transformer_depth": (1, 1, 1)}),
    ("unet_sdxl", "train_256", {"batch": 64}, _UNET_LEVEL0),
    ("unet_sdxl", "train_1024", {"batch": 4}, {**_UNET_LEVEL0, "batch": 1}),
    # flux-dev: training (118.8 GB of state at 57 blocks) on 3 double + 6
    # single blocks; for the phase's time every batch is halved (phases
    # 11 and 17 run generation at 4 and 16, training at 64 and 2)
    ("flux_dev", "gen_1024", {"batch": 2}, _FLUX_HELD),
    ("flux_dev", "gen_fast", {"batch": 8}, _FLUX_HELD),
    ("flux_dev", "train_256",
     {"n_double_blocks": 3, "n_single_blocks": 6, "batch": 32}, _FLUX_HELD),
    ("flux_dev", "train_1024",
     {"n_double_blocks": 3, "n_single_blocks": 6, "batch": 2}, _FLUX_HELD),
    # the LMs: train at 2 x 4096; prefill one 32k prompt; decode's batch
    # of 128 cut to what the plain decode attention holds: it widens each
    # layer's cache, its KV heads repeated to the query heads, to float32,
    # ~12 bytes an element of (batch, cache slots, query heads, head dim)
    # at once (smollm at 64: 14.5 GB beside its 48.3 GB cache ran out of
    # memory; granite at 128 would take 412 GB)
    ("smollm_135m", "train_4k", {"batch": 2}, {"n_layers": 2}),
    ("smollm_135m", "decode_32k", {"batch": 32}, {"n_layers": 4}),
    ("granite_34b", "train_4k", {"n_layers": 2, "batch": 2},
     {"n_layers": 1}),
    ("granite_34b", "prefill_32k", {"n_layers": 1, "batch": 1}, None),
    ("granite_34b", "decode_32k", {"n_layers": 8, "batch": 16}, None),
    ("mixtral_8x22b", "train_4k", {"n_layers": 1, "batch": 2}, None),
    ("mixtral_8x22b", "prefill_32k", {"n_layers": 1, "batch": 1}, None),
    ("mixtral_8x22b", "decode_32k", {"n_layers": 8, "batch": 32}, None),
    ("mixtral_8x22b", "long_500k", {"n_layers": 8}, None),
    ("qwen3_moe_235b_a22b", "prefill_32k", {"n_layers": 1, "batch": 1},
     None),
    ("qwen3_moe_235b_a22b", "decode_32k", {"n_layers": 2, "batch": 8},
     None),
    ("qwen3_moe_235b_a22b", "train_4k", {"n_layers": 1, "batch": 2}, None),
)
# the reference's table skips these (full attention at 524k tokens)
CELL_SKIPS = (("granite_34b", "long_500k"), ("smollm_135m", "long_500k"),
              ("qwen3_moe_235b_a22b", "long_500k"))
# a train cell runs where its update's reckoned peak (the cells' AdamW,
# float32 moments: update_peaks) stays under this share of the card: the
# rest is the CUDA context, the batch and the allocator's fragmentation,
# which late in this script has held 29.5 GB reserved and unallocated
# (flux's train_1024 at batch 4, phase 17's first whole runs)
CELL_UPDATE_SHARE = 0.9


def cell_why(cell) -> str | None:
    """Why ``cell`` cannot run on one card, or None: a train cell whose
    leaf update's reckoned peak passes ``CELL_UPDATE_SHARE`` of the
    card's memory."""
    import torch

    from repro_torch import pytree
    from repro_torch.launch import cells as cells_mod

    if cell.kind != "train":
        return None
    specs = pytree.flatten(cell.abstract_args[0]["params"],
                           cells_mod._is_spec)[0]
    whole, leaf = update_peaks([s.shape for s in specs], 4)
    total = torch.cuda.get_device_properties(0).total_memory
    if leaf <= CELL_UPDATE_SHARE * total:
        return None
    return (f"its AdamW update (float32 moments) over "
            f"{sum(math.prod(s.shape) for s in specs) / 1e9:.3f}B "
            f"parameters is reckoned at {leaf / 1e9:.1f} GB one leaf at a "
            f"time ({whole / 1e9:.1f} GB whole-tree), past "
            f"{CELL_UPDATE_SHARE:.0%} of the card's {total / 1e9:.1f} GB")


def run_cells_plan() -> dict:
    """Phase 18; returns the launches of the cells' steps (none may
    launch a kernel, as in phase 12)."""
    import torch

    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels import _build

    card = card_line()
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    print(f"cells plan: {len(CELL_PLAN)} more cells of the launch layer "
          f"(with phase 12's {len(CELL_RUNS)}, the table's "
          f"{len(CELL_PLAN) + len(CELL_RUNS)} counted cells), each whole "
          f"or cut, counted on fake CUDA tensors and on real seeded ones, "
          f"held to a control, then timed")
    for arch_id, shape_name in CELL_SKIPS:
        print(f"cell {arch_id}/{shape_name}: skipped by the table "
              f"({cfgbase.get_arch(arch_id).skip[shape_name]})")
    for i, (arch_id, shape_name, cut, held) in enumerate(CELL_PLAN):
        t = time.perf_counter()
        why = cell_why(_phase12_cell(arch_id, shape_name, **cut))
        if why is not None:
            print(f"cell {arch_id}/{shape_name}: not run: {why}")
            continue
        run_cell(arch_id, shape_name, cut, held, 180 + i, card,
                 timed_steps=None, extra_checks=True)
        print(f"cell {arch_id}/{shape_name}: "
              f"{time.perf_counter() - t:.1f} s in all")
    launched = _build.launch_counts()
    print(f"cells plan launches: {launched}")
    check(not launched, "a cell's step launched a kernel")
    return launched


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from repro_torch.device import set_fp32_policy
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 1
    set_fp32_policy()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, TF32 off "
          f"(cudnn {torch.backends.cudnn.allow_tf32}, matmul "
          f"{torch.backends.cuda.matmul.allow_tf32})")
    t0 = time.perf_counter()
    print(f"build: {_build.build_all():.1f}s for {_build.kernel_names()}")
    print_ptxas(_build.ptxas_report("attention"),
                ("flash_wgmma_kernel", "flash_fwd_kernel"))
    # the SIMT kernel: float32 and bf16 at D 16, 32, 64 and 128
    check_no_spills(_build.ptxas_report("attention"), "flash_fwd_kernel", 8)
    print_ptxas(_build.ptxas_report("nms"), "greedy_")
    print_ptxas(_build.ptxas_report("gnomonic"), "project_srois_kernel")
    print_ptxas(_build.ptxas_report("sphiou"),
                ("sphiou_self_kernel", "sphiou_cross_kernel"))
    print_ptxas(_build.ptxas_report("groupnorm"), "groupnorm_mish_kernel")
    # float4 and one-float-at-a-time instances
    check_no_spills(_build.ptxas_report("groupnorm"), "groupnorm_mish_kernel",
                    2)

    records: dict = {}
    flash_only = "--flash-only" in sys.argv[1:]
    frame_only = "--frame-kernels-only" in sys.argv[1:]
    if not flash_only:
        check_gnomonic(records)
        check_project_srois(records)
        check_sphiou_bf16(records)
        check_nms(records)
        check_groupnorm_mish(records)
    if not frame_only:
        check_flash(records)
    if flash_only or frame_only:
        print(f"total {time.perf_counter() - t0:.1f}s "
              f"(--{'flash' if flash_only else 'frame-kernels'}-only: no "
              f"result)")
        return 0
    check_small_input()
    profile = "--profile" in sys.argv[1:]
    # each path's launches, counted from 0 just before it and read after
    by_path = {}
    nms_rounds: dict = {}  # the serving paths' auto NMS rounds
    with nms_rule_rounds(nms_rounds):
        by_path["frame_loop"], det_params = run_main_path(profile=profile)
        run_serve_launcher()
        by_path["mixed_pod"] = run_mixed_path(det_params, profile=profile)
    del det_params
    run_replay_lane()
    by_path["lm"] = run_lm_path(profile=profile)
    by_path["lm_moe"] = run_moe_path(profile=profile)
    by_path["lm_train"], by_path["detector_train"] = run_train_path(
        profile=profile)
    by_path["vision_serve"], by_path["vision_train"] = run_vision_path(
        profile=profile)
    by_path["diffusion_serve"], by_path["diffusion_train"] = \
        run_diffusion_path(profile=profile)
    by_path["cells"] = run_cells_path()
    by_path["multi_device"] = run_multi_device_path()
    t = time.perf_counter()
    with nms_rule_rounds(nms_rounds):
        by_path["serving_policies"], det_params = run_serving_policies()
        by_path["fleet"] = run_fleet_path(det_params)
    del det_params
    check_nms_rounds(nms_rounds)
    print(f"phase 14: {time.perf_counter() - t:.1f}s; {card}")
    t = time.perf_counter()
    by_path["lm_granite"] = run_granite_path()
    print(f"phase 15: {time.perf_counter() - t:.1f}s; {card}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    by_path["moe_train"] = run_moe_train(profile=profile)
    print(f"phase 16: {time.perf_counter() - t:.1f}s; {card}")
    t = time.perf_counter()
    by_path.update(run_train_shapes())
    print(f"phase 17: {time.perf_counter() - t:.1f}s; {card}")
    t = time.perf_counter()
    by_path["cells_plan"] = run_cells_plan()
    print(f"phase 18: {time.perf_counter() - t:.1f}s; {card}")
    t = time.perf_counter()
    by_path["moe_train_qwen3"] = run_moe_train(
        profile=profile, arch="qwen3_moe_235b_a22b", seed=190)
    print(f"phase 19: {time.perf_counter() - t:.1f}s; {card}")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = records[name]
        paths = {p: c.get(name, 0) for p, c in by_path.items()}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(paths.values()), max_abs_err=rec["max_abs_err"],
            ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            shape=rec["shape"], launches_by_path=paths))
    print(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
