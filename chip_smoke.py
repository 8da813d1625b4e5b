#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # build + per-kernel checks only
    python3 chip_smoke.py --vae      # build + the VAE phases only
    python3 chip_smoke.py --infer    # build + the infer CLI's kernel forms
                                     # and its phase only
    python3 chip_smoke.py --wild-files  # build + K5 at DINOv2's 224^2, the
                                     # TRELLIS phase and [wild-files] only
    python3 chip_smoke.py --encode-latent  # build + [encode-latent] only
    python3 chip_smoke.py --forms    # build + [forms] only
    python3 chip_smoke.py --widths   # build + [widths] only
    python3 chip_smoke.py --wide-heads  # build + [wide-heads] only
    python3 chip_smoke.py --sublayer-widths  # build + [sublayer-widths]
                                     # only (the models and the frames'
                                     # tokens built for it)
    python3 chip_smoke.py --pipeline  # build + the video main path and
                                     # its int8 phases ([main] .. [selfq8])
    python3 chip_smoke.py --split    # build + K1's-K7's device time by
                                     # kernel name
    python3 chip_smoke.py --profile  # the same, then profiled
                                     # denoise (float, int8 cache, int8
                                     # QK), encode, TRELLIS flow forwards
                                     # (also at the defaults) and decode,
                                     # one training micro-step

Phases, each printed on its own lines:
  1. the card (nvidia-smi name and power limit) and the kernel build time;
  2. each fused DiT sublayer kernel (K1-K4) against its plain torch version
     on the card, at the DiT's full shapes in bf16, with both times, the
     time of a library composition of the same sublayer (LayerNorm, cuBLAS
     bf16 matmuls, scaled_dot_product_attention, the residual) and the
     bound; K3's single-context form at the SLat torso's shape ([1, 4096,
     1024] fp32 residual, 16 heads of 64, 1374 image tokens) the same way;
     then K5 (the attention kernel) in each form its callers run: DINOv2's
     [32 frames, 1374 tokens, 16 heads, 64] from a qkv projection, the
     sparse-structure flow's self [1, 512] and cross [1, 512] x [1, 1374]
     attention, and the SLat torso's [1, 4096] self-attention with a -inf
     kv_bias on the padding keys, with scaled_dot_product_attention as the
     library call; and the DiT training path's forms in fp32 (K5 at heads
     of 32: self [48, 512, 16, 32], cross to the 1374 image tokens and to
     the 512 static latents; K6 [2, 24, 512, 16, 32]), forward against the
     plain version and the gradient through each autograd Function against
     autograd of the plain version, with scaled_dot_product_attention (for
     K6 with its transposes) as the library call; K3's int8 form at the
     DiT's shapes on an int8 cache of the same K/V (against its plain int8
     version, and against the float K3 on the dequantized cache); K7 at the
     uncompacted SLat torso's [1, 32768, 16, 64] with 3700 valid keys, as
     a prefix (as the downsample packs parents) and scattered, with
     scaled_dot_product_attention under the boolean key mask as the
     library call; K1 and K2 with int8 QK (quant_qk) at the DiT's shapes,
     against their plain int8-QK versions and against the float kernels;
     then the forms of the DiT's other configurations, each at the shapes
     of the configuration that runs it: K1 / K2 without the q/k RMS norm
     and K3 with the q norm (float and int8), K1-K3 at heads of 64 (8
     heads; float and int8), K4 at M = 1024, K6 at heads of 64 (with
     ptxas's register and spill count of each K6 kernel), and K5 at heads
     of 64 in fp32 (the 8-head DiT's training: self [48, 512, 8, 64],
     cross to 1374 and 512 keys; forward and gradients as at heads of
     32) and at heads of 32 in bf16 (dit-rope's composed inference: self
     [32, 512, 16, 32], cross to 1374 and 512 keys); then the forms of
     TRELLIS as the registry builds it: K7 in fp32 at [1, 32768, 16, 64]
     (3700 valid keys, prefix and scattered) and K3's single context in
     fp32 at [1, 32768, 1024] x 1374 (library: F.layer_norm, cuBLAS fp32,
     SDPA in fp32, the residual), and K7 in bf16 at the torso's other head
     widths, [1, 32768, 32, 32] and [1, 32768, 8, 128]; then the static
     VAE's `full` attention ([vae-kernels]): K7's fp32 forward with its
     logsumexp residual and the dkv and dq backward kernels at [2, 32768,
     12, 64] fp32 (two seeded surface shells, 15721 and 12219 valid keys,
     as prefixes), against the plain forward and backward on every row,
     with SDPA under the boolean key mask (forward; its backward) as the
     library call; then [vae-forms], K7's other forms at the static VAE's
     768 channels on the same shells: the forward with its residual, dkv
     and dq in bf16 at [2, 32768, 24, 32], [2, 32768, 12, 64] and [2,
     32768, 6, 128] and in fp32 at [2, 32768, 24, 32] and [2, 32768, 6,
     128], each driven once through flash_attention under grad (the bf16
     forms' launch counts), then against the plain forward and backward
     on every row (fp32 also against fp64 on a slice), timed beside the
     plain versions and SDPA's forward and backward;
  2a. [forms]: the kernel forms that no path reaches, each at its full
     width against its plain version and a library call, driven once
     through its wrapper for its launch count: K5 with segment_size 32 at
     the packed temporal shape [32, 512, 16, 32] (K6's [1, 32, 512, 16,
     32] voxel-major; also against K6 on the unpacked data, SDPA with the
     block-diagonal mask), K5's int8 forms (quant "qk" and "qk+av") at the
     DiT's self [32, 512, 16, 32] and DINOv2's [32, 1374, 16, 64] at
     DINOv2-like logit scales, "qk" at the torso's [1, 4096, 16, 64] with
     its -inf key bias, K1 with seg 16 on K2's chain at K2's inference x
     viewed as [32, 32 x 16, 512] (float and int8 QK; against K2 on the
     same data), K3's single context at [1, 32768, 1024] x 1374 with the q
     RMS norm (bf16, fp32) and on an int8 cache (q_block 128); the
     backward of K1-K4 at the training shapes (2 x 24 frames) and of K5
     with a key bias, against torch's autograd through the plain
     function; and the 12-block DiT in bf16 with a hoisted bf16 and int8
     cache under autograd (loss sum(output * a seeded tensor), backward()
     for every parameter and the input), against the same DiT's
     impl="plain" run, with the step's time;
  2c. [widths]: K5, K6 and K7 at the head widths their kernels reach by
     zero-padding to 32, 64 or 128 (ops/_widths.py) and K5 / K6 at 128,
     each at full width against its plain version and SDPA: K5's key-bias
     form at [1, 4096, 768 / D, D] for D = 16, 48, 128 (bf16 and fp32
     io), its int8 forms at the DiT's self shape at 16 and 128, its
     segments at 16, K5 and K6 at the DiT's training shapes at 16 and 128
     (fp32 with the gradients; K6 also bf16), K7's residual forward, dkv
     and dq at [2, 32768, 768 / D, D] for D = 48, 96 in both dtypes; then
     cli/main_latent.main one micro-step at --model.num_heads=32 and =4
     (K5 / K6 launches at heads of 16 and 128 checked);
  2d. [wide-heads]: K7 above 128 lanes (csrc/flash_attention_wide.cu):
     the residual forward, dkv and dq in bf16 and fp32 at [2, 32768, 768 /
     D, D] for D = 192 and 768 and at [2, 32768, 1, 1152] (1152 channels
     in one head) on the static VAE's two shells, against the plain
     forward and backward (fp32 also against fp64), timed beside their
     bounds and SDPA's forward and backward (dkv + dq against SDPA's
     backward); the fp32 forward without its residual at one object's [1,
     32768, 768 / D, D], then through the static VAE's encode and decode
     at 4 and 1 heads (its launches counted); a head of 3136 (4 passes of
     clusters) at [2, 1000, 1, 3136] in both dtypes against the plain
     versions, driven once under grad and timed beside SDPA and the
     bound; main_vae at those heads and at 1152 channels runs in
     [vae-train];
  2b. device time by kernel name (torch.profiler, three calls each) inside
     K1 and K2 (float and int8 QK), K4 (M = 2048 and 1024) and K3 (on
     the float and the int8 cache) at the DiT's shape, K3's single
     context at 4096 and 32768 rows, K5 at DINOv2's shape and K6 at the
     training shapes: the --split phase, without its traces;
  3. one full DINOv2 ViT-L/14-reg forward (518^2, 32 frames) and one full
     12x512 DiT forward, kernels against impl="plain";
  4. the main path through the entry points, with seeded random weights:
     32 seeded frames [518, 518, 3] -> encode_video (DINOv2 tokens
     [1, 32, 1374, 1024]) -> VideoTo4DPipeline.run (FPS, KV cache, a
     32-step DPM-Solver++ denoise at guidance 1.0/1.0, the motion-VAE
     decode of 131072 Gaussians) -> render_4d (all 32 frames from one
     orbit view at 512^2), timed stage by stage and whole; the kernel
     launches of K1-K5 are counted in this run only. Then run()'s stages
     called one by one must give what run() gave, and both again for
     4 steps at guidance 2.0/5.0 (the 3-way CFG batch B*T = 96); then
     both guidance modes again on bench.py's int8 KV cache
     (VideoTo4DConfig(kv_quant="int8"): K3's int8 form, its launches
     counted in the 32-step run() alone), held against their stages and
     against the float runs; and both again with the DiT's self and
     temporal QK in int8 on that cache (self_quant="int8": K1 and K2
     with int8 QK, their launches counted in the 32-step run() alone);
  4a. the DiT's other configurations (configs/diffusion.yml at full width
     with DIT_CONFIGS's fields changed: q/k RMS norms off on self and on
     cross, 8 heads of 64, RoPE with share_mod, no temporal attention with
     a learnable PE and MLP ratio 2): for each, one DiT forward against
     impl="plain", then VideoTo4DPipeline.run on the frames' tokens, on the
     float cache and on the int8 cache with int8 QK (32 steps for the two
     that reach new kernel forms, 4 for the others), timed, its launches
     counted and checked, its stages one by one, and the int8 run against
     the float run;
  4b. [sublayer-widths]: K1, K2 and K3 at the head widths their rules
     admit beyond 32 and 64 (a head of 1-16 lanes runs at 32, zero-padded
     in its projections' weights and K3's cache; 128 natively): every form
     at heads of 8, 16 and 128 (K1 float with and without the q/k RMS
     norms, int8 QK, seg 16 float and int8 QK; K2 float with and without
     the norms, int8 QK; K3's two contexts without and with the q norm, on
     the int8 cache without and with it, at the DiT's [1, 32, 512, 512]
     with 512 / D heads; K3's single context in bf16 and fp32, with the q
     norm, and on an int8 cache, at [1, 4096, 1024] x 1374 with 1024 / D
     heads) and the float K1, K2 and K3 at heads of 1, 2 and 4 ([8, 512,
     128], [1, 32, 512, 128]), each against its plain version (fp32 also
     against fp64), timed beside it and the library composition with its
     bound at the true width, driven once for its launch count; then
     VideoTo4DPipeline.run with the 12 x 512 bf16 DiT at 32 heads (of 16)
     and at 4 (of 128), 32 steps under the dual CFG (2.0/5.0) on the float
     cache, the int8 cache and the int8 cache with int8 QK, each with
     render_4d, 384 launches of each sublayer under its width's counter,
     the int8 runs against the float run; the DiT under autograd on a
     hoisted cache at both widths against impl="plain"; K3's single
     context at heads of 16 through one ModulatedSparseCrossBlock (C =
     1024, 64 heads, 4096 slots) in bf16 and fp32, against impl="plain";
  5. the TRELLIS image -> 3D front end at full width (DINOv2, the 24x1024
     sparse-structure flow, the occupancy decoder, the 24x1024 SLat flow
     with its torso compacted to 4096 slots, the 12x768 Gaussian decoder;
     16384 voxel slots): a seeded 768^2 RGBA image -> preprocess_image ->
     the stages one by one (timed, launches counted per stage), then
     TrellisImageTo3DPipeline.run (the launches of K5's forms and of K3's
     single-context form are counted in this run only; it must give what
     the stages gave); the kernels against impl="plain" in two parts (the
     sparse-structure latent and the occupancy flips, then the SLat and
     the Gaussians on the kernel run's structure); then the splat through
     VideoTo4DPipeline.run and render_4d with the video's tokens;
  5a. the in-the-wild entry point: InTheWildPipeline.run on the seeded
     image and the frames' tokens (that TRELLIS, the alignment over 360
     angles through bench.py's early-exit multi-round rasterizer, the
     denoise with int8 KV and int8 QK), whole and stage by stage under
     bench.py's stage keys; the alignment's recovery of a known azimuth
     from the splat's own render; the 24-frame sweep at 512^2 against the
     scan form and one round of K = 256;
  5a'. the in-the-wild chain from files ([wild-files], phase_wild_files):
     a release mirror in the reference's layout loaded through utils/hub
     onto the card, DINOv2 through a .safetensors file, the 32 frames
     through a video file, extract_frames, a full-width MODNet's mattes
     and encode_video_features, DINOv2 at 224^2 (K5 at [32, 261, 16, 64],
     its launches counted, against impl="plain"), InTheWildPipeline.run
     on the image's RGB with MODNet's alpha and a full-width CLIP
     ViT-B/32's score, and render_outputs to the spiral video and
     frames.npy (16 views), timed stage by stage;
  5b. TRELLIS at its defaults (path A): SLatFlowModel(torso_capacity=None)
     and TrellisConfig() (32768 voxel slots), so the torso's full
     self-attention runs K7 over 32768 slots: the same calibration, one
     timed run() (the launches of K7 and K3's single-context form counted
     in it), one SLat forward with the kernels against impl="plain", and
     run()'s SLat against the compacted torso's (torso_capacity=4096, K5)
     on the same structure and noise;
  5c. TRELLIS as the registry builds it ([trellis-fp32]): a pretrained
     directory in the reference's layout (pipeline.json, per model a
     release-style <key>.json with use_fp16 true and the flax-flat <key>.npz
     of seeded weights, build_trellis's; the two flows at 12 blocks, cut
     from 24) written into a temporary directory, every model built by
     registry.from_pretrained (fp32; the SLat torso uncompacted at 32768
     voxel slots), the occupancy calibrated
     as in 5b; the stages one by one (timed, launches per stage), then
     run() (timed; K5 from fp32 inputs, K7 and K3's single context in fp32,
     launches checked), which must equal its stages;
  5d. the drift of the shipped bf16 models from that fp32 run
     ([trellis-drift]), on the same weights, image and noise, each stage on
     the fp32 stage's output: DINOv2's tokens, the ss latent, the occupancy
     flips, the SLat on the fp32 structure with the torso compacted to 4096
     slots and uncompacted at 32768, and each Gaussian attribute (max abs,
     PSNR as docs/PARITY.md), held to DRIFT_BOUNDS;
  5e. the SLat flow at heads of 32 and 128 ([trellis-heads]): built by
     registry.create_model from the release arguments with
     num_head_channels 32 or 128 (fp32, and its bf16 twin), each through
     sample_slat on that structure and conditioning at 32768 slots (1
     step, cut from 12), so K7 and K3's single context run at those
     widths in both dtypes (launches checked), bf16 against fp32;
  6. the DiT's training at full width through cli/main_latent.main on
     configs/diffusion.yml (12 x 512, batch 2 x 24 frames, grad_accum 2,
     fp32) and a seeded synthetic dataset in LatentDataset's layout: 3
     micro-steps (the launches of K5's heads-of-32 forms and K6 are counted
     in this run only; one update, at lr 0, leaves the weights as drawn),
     a resume from its checkpoint to 5 (a second update moves weights and
     EMA); one micro-step from the saved state with the kernels and with
     impl="plain" (loss, gradients, updated parameters); the micro-step's
     time, samples/s and peak memory; then main_latent.main for 3
     micro-steps at two of the other configurations (8 heads of 64: K5 and
     K6 at heads of 64; RoPE with share_mod: K5 at heads of 32 and the
     library attention over T), each from a YAML written from
     configs/diffusion.yml, with losses, step times, peak memory and
     launches (the launches of K5 and K6 at heads of 64 counted in the
     8-head run), and one micro-step of each on seeded random weights,
     kernels against impl="plain" (main()'s losses are the same at every
     configuration: flax's zero final layer makes the output 0);
  7. the VAE's training ([vae-train]) through `python -m
     gvfdiffusion_torch.cli.main_vae --config configs/vae.yml` in a process
     of its own, at full width (static VAE 768 channels, 12 + 12 blocks,
     12 heads of 64, 32768 voxel slots, 8 Gaussians a voxel; motion VAE
     depth 12, dim 768, 8192 points, 512 latents; 512^2 binned renders;
     LPIPS on seeded weights) over a seeded dataset in VAEDataset's layout
     (two objects, 2 frames x 2 views), every block rematerialized and 2
     frames a sample: in the shipped `swin` 1 phase-A and 1 phase-B step
     (no K7 launch), in `full` attention the same at 2 + 2 blocks (K7's
     residual forward, dkv and dq launches read from its log: 8, 4 and 4
     a step); step times, peak memory and every loss term per step;
     then one phase-A
     step at 2 + 2 blocks on random weights, kernels against
     impl="plain" (loss and gradients); then main_vae in `full` with
     --static_vae.num_heads=24 and =6 (fp32 K7 at heads of 32 and 128)
     and =8 (heads of 96, padded to 128), at 2 + 2 blocks, 1 step each,
     the three at once (their step times, on a shared card, not printed),
     the launches a step (8 / 4 / 4) checked against the 12-head run's 4
     / 2 / 2 per block (the kernels line's counts of those forms); then
     the static VAE built in
     bf16 (SparseTransformerVAE(dtype=bfloat16), `full`, 768 channels,
     32768 slots) under autograd, one step at 12 + 12 blocks with the
     kernels (K7's bf16 backward at heads of 64, 48 / 24 / 24 launches),
     and at 2 + 2 blocks kernels against impl="plain" (loss, gradients);
     then K7 above 128 lanes: main_vae in `full` with
     --static_vae.num_heads=4 and =1 (fp32, heads of 192 and 768) and
     with --static_vae.model_channels=1152 --static_vae.num_heads=1 (a
     head of 1152) at 2 + 2 blocks, 1 step each, the six runs at once,
     launches 8 / 4 / 4 a step, and the bf16 static VAE at those heads,
     one step each at 2 + 2 blocks with the kernels (launches counted,
     gradients finite);
  8. the step between the two trainers ([encode-latent]): K7's fp32
     forward without the residual at [1, 32768, 12, 64] (the static VAE
     one object at a time) against its plain version, with SDPA as the
     library call; then a seeded dataset in VAEDataset's layout, vae.yml's
     static VAE at attn_mode=full and motion VAE at full width on seeded
     weights saved as trainer checkpoints, cli/encode_latent.main over the
     two objects (stage times an object, K7's launches counted in this run:
     24 an object) and again with --debug (the same files), the written
     deformation_latent.pt checked, and cli/main_latent.main for 2
     micro-steps on those latents through the prefetcher.
Then one JSON line of per-kernel results and, last, the contract line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
non-zero and no result line is printed. Without a CUDA device, or without
the repository beside this script, it exits 1.

Bounds (bound_ms) are the larger of the operations over the dense bf16
tensor-core peak (the fp32 peak outside the tensor cores for the fp32
forms of K7 and K3) and the bytes (each input read once, each output
written once) over the memory rate, at the H100 SXM datasheet's 989
TFLOP/s, 67 TFLOP/s and 3.35 TB/s: assumed peaks, not measured on the
card.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# (name, TPU kernel body replaced, source, key). K5's self form without
# bias has one launch counter: the DINOv2 entry reads it in the video main
# path, the TRELLIS self entry in TrellisImageTo3DPipeline.run (DINOv2 on
# the image and the sparse-structure flow) and is timed at the flow's shape.
KERNELS = [
    ("fused_self_sublayer", "gvfdiffusion_tpu/ops/fused_sublayer.py:170",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "self"),
    ("fused_temporal_sublayer", "gvfdiffusion_tpu/ops/fused_sublayer.py:373",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "temporal"),
    ("fused_cross_sublayer", "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross"),
    ("fused_mlp_sublayer", "gvfdiffusion_tpu/ops/fused_sublayer.py:881",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "mlp"),
    ("fused_cross_sublayer[single context]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_single"),
    ("fused_attention[DINOv2 self]",
     "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention"),
    ("fused_attention[TRELLIS self: DINOv2 + ss flow]",
     "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention_ss_self"),
    ("fused_attention[ss cross]", "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention_cross"),
    ("fused_attention[torso kv_bias]",
     "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention_bias"),
    ("fused_attention[DiT training self, heads of 32, fp32]",
     "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention_d32"),
    ("fused_attention[DiT training cross, heads of 32, fp32: image 1374 + "
     "static 512]", "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention_cross_d32"),
    ("temporal_attention", "gvfdiffusion_tpu/ops/fused_attention.py:427",
     "gvfdiffusion_torch/csrc/temporal_attention.cu", "temporal_attention"),
    ("fused_cross_sublayer[int8 KV]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_q8"),
    ("flash_attention[uncompacted SLat torso]",
     "gvfdiffusion_tpu/sparse/attention.py:57",
     "gvfdiffusion_torch/csrc/flash_attention.cu", "flash_attention"),
    ("fused_self_sublayer[int8 QK]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:170",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "self_q8"),
    ("fused_temporal_sublayer[int8 QK]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:373",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "temporal_q8"),
    # the forms of the DiT's other configurations ([dit-config], [train])
    ("fused_self_sublayer[rms=False]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:170",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "self_norms_off"),
    ("fused_temporal_sublayer[rms=False]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:373",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "temporal_norms_off"),
    ("fused_cross_sublayer[q RMS norm]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_rms"),
    ("fused_self_sublayer[int8 QK, rms=False]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:170",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "self_q8_norms_off"),
    ("fused_temporal_sublayer[int8 QK, rms=False]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:373",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "temporal_q8_norms_off"),
    ("fused_cross_sublayer[int8 KV, q RMS norm]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_q8_rms"),
    ("fused_self_sublayer[heads of 64]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:170",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "self_d64"),
    ("fused_temporal_sublayer[heads of 64]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:373",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "temporal_d64"),
    ("fused_cross_sublayer[heads of 64]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_d64"),
    ("fused_self_sublayer[int8 QK, heads of 64]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:170",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "self_q8_d64"),
    ("fused_temporal_sublayer[int8 QK, heads of 64]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:373",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "temporal_q8_d64"),
    ("fused_cross_sublayer[int8 KV, heads of 64]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_q8_d64"),
    ("fused_mlp_sublayer[M = 1024]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:881",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "mlp_m1024"),
    ("temporal_attention[heads of 64]",
     "gvfdiffusion_tpu/ops/fused_attention.py:427",
     "gvfdiffusion_torch/csrc/temporal_attention.cu",
     "temporal_attention_d64"),
    ("fused_attention[dit-rope self, heads of 32, bf16]",
     "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "rope_attention_d32"),
    ("fused_attention[dit-rope cross, heads of 32, bf16: image 1374 + "
     "static 512]", "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu",
     "rope_attention_cross_d32"),
    ("fused_attention[DiT training self, heads of 64, fp32]",
     "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "train_attention_d64"),
    ("fused_attention[DiT training cross, heads of 64, fp32: image 1374 + "
     "static 512]", "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu",
     "train_attention_cross_d64"),
    # TRELLIS as the registry builds it (fp32; [trellis-fp32]) and its SLat
    # flow at the torso's other head widths, fp32 and bf16 ([trellis-heads])
    ("flash_attention[fp32, uncompacted SLat torso]",
     "gvfdiffusion_tpu/sparse/attention.py:57",
     "gvfdiffusion_torch/csrc/flash_attention.cu", "flash_attention_fp32"),
    ("fused_cross_sublayer[single context, fp32]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_single_fp32"),
    ("flash_attention[heads of 32, bf16]",
     "gvfdiffusion_tpu/sparse/attention.py:57",
     "gvfdiffusion_torch/csrc/flash_attention.cu", "flash_attention_d32"),
    ("flash_attention[heads of 128, bf16]",
     "gvfdiffusion_tpu/sparse/attention.py:57",
     "gvfdiffusion_torch/csrc/flash_attention.cu", "flash_attention_d128"),
    ("flash_attention[heads of 32, fp32]",
     "gvfdiffusion_tpu/sparse/attention.py:57",
     "gvfdiffusion_torch/csrc/flash_attention.cu", "flash_attention_fp32_d32"),
    ("flash_attention[heads of 128, fp32]",
     "gvfdiffusion_tpu/sparse/attention.py:57",
     "gvfdiffusion_torch/csrc/flash_attention.cu",
     "flash_attention_fp32_d128"),
    ("fused_cross_sublayer[single context, heads of 32, bf16]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_single_d32"),
    ("fused_cross_sublayer[single context, heads of 128, bf16]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_single_d128"),
    ("fused_cross_sublayer[single context, heads of 32, fp32]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_single_fp32_d32"),
    ("fused_cross_sublayer[single context, heads of 128, fp32]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_single_fp32_d128"),
    # the static VAE's training in `full` attention ([vae-kernels],
    # [vae-train]): K7's fp32 forward with its residual and the stock
    # kernel's two backward kernels (jax 0.9.0's site-packages file)
    ("flash_attention[fp32 forward with residual, static VAE]",
     "gvfdiffusion_tpu/sparse/attention.py:57",
     "gvfdiffusion_torch/csrc/flash_attention.cu", "flash_attention_fp32_res"),
    ("flash_attention backward dkv",
     "jax/experimental/pallas/ops/tpu/flash_attention.py:796",
     "gvfdiffusion_torch/csrc/flash_attention_bwd.cu",
     "flash_attention_bwd_dkv"),
    ("flash_attention backward dq",
     "jax/experimental/pallas/ops/tpu/flash_attention.py:1146",
     "gvfdiffusion_torch/csrc/flash_attention_bwd.cu",
     "flash_attention_bwd_dq"),
    # the infer CLI's fp32 DiT on the composed path ([infer]): K5 and K6 at
    # the inference shapes (B*T = 32, T = 32)
    ("fused_attention[DiT inference self, heads of 32, fp32]",
     "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "infer_attention_d32"),
    ("fused_attention[DiT inference cross, heads of 32, fp32: image 1374 + "
     "static 512]", "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu",
     "infer_attention_cross_d32"),
    ("temporal_attention[DiT inference, T = 32]",
     "gvfdiffusion_tpu/ops/fused_attention.py:427",
     "gvfdiffusion_torch/csrc/temporal_attention.cu",
     "infer_temporal_attention"),
    # DINOv2 at 224^2 ([wild-files]): its position embedding resized to a
    # 16^2 patch grid, 261 tokens
    ("fused_attention[DINOv2 self at 224^2]",
     "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention_dino224"),
    # the static VAE's full attention one object at a time, as
    # cli/encode_latent runs it ([encode-latent]): fp32, no residual
    ("flash_attention[fp32, static VAE encode, batch 1, 12 heads]",
     "gvfdiffusion_tpu/sparse/attention.py:57",
     "gvfdiffusion_torch/csrc/flash_attention.cu", "flash_attention_encode"),
    # the forms no path reaches ([forms]): K5's segment_size at the packed
    # temporal shape and its int8 forms (the TPU kernel's quant body), K1's
    # seg on K2's chain, K3's single context with the q RMS norm or on an
    # int8 cache, at the uncompacted torso's shape
    ("fused_attention[segment_size 32, packed temporal, heads of 32, bf16]",
     "gvfdiffusion_tpu/ops/fused_attention.py:108",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention_seg_d32"),
    ("fused_attention[int8 qk, DiT self, heads of 32, bf16]",
     "gvfdiffusion_tpu/ops/fused_attention.py:154",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention_qk_d32"),
    ("fused_attention[int8 qk, DINOv2, heads of 64, bf16]",
     "gvfdiffusion_tpu/ops/fused_attention.py:154",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention_qk"),
    ("fused_attention[int8 qk, torso kv_bias, heads of 64, bf16]",
     "gvfdiffusion_tpu/ops/fused_attention.py:154",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention_qk_bias"),
    ("fused_attention[int8 qk+av, DiT self, heads of 32, bf16]",
     "gvfdiffusion_tpu/ops/fused_attention.py:154",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention_qkav_d32"),
    ("fused_attention[int8 qk+av, DINOv2, heads of 64, bf16]",
     "gvfdiffusion_tpu/ops/fused_attention.py:154",
     "gvfdiffusion_torch/csrc/fused_attention.cu", "attention_qkav"),
    ("fused_self_sublayer[seg 16, on K2's chain]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:170",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "self_seg"),
    ("fused_self_sublayer[seg 16, int8 QK, on K2's chain]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:170",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "self_seg_q8"),
    ("fused_cross_sublayer[single context, q RMS norm, bf16]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_single_rms"),
    ("fused_cross_sublayer[single context, q RMS norm, fp32]",
     "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_single_rms_fp32"),
    ("fused_cross_sublayer[single context, int8 KV, q RMS norm, q_block "
     "128]", "gvfdiffusion_tpu/ops/fused_sublayer.py:589",
     "gvfdiffusion_torch/csrc/fused_sublayer.cu", "cross_single_q8"),
]
# K7's backward in the other forms of its forward ([vae-forms]): the static
# VAE's full attention at its 768 channels in bf16 at heads of 32, 64 and
# 128 (the module built with dtype=bfloat16) and in fp32 at heads of 32 and
# 128 (main_vae --static_vae.num_heads=24 / 6); per form the forward with
# its residual, dkv and dq, under flash_attention.grad_key's names
VAE_C = 768
VAE_FORMS = (("bfloat16", 32), ("bfloat16", 64), ("bfloat16", 128),
             ("float32", 32), ("float32", 128))


def vae_form_keys(dt_name: str, d: int):
    """The (residual forward, dkv, dq) counters of a form."""
    w = "" if d == 64 else f"_d{d}"
    if dt_name == "float32":
        return (f"flash_attention_fp32_res{w}", f"flash_attention_bwd_dkv{w}",
                f"flash_attention_bwd_dq{w}")
    return (f"flash_attention_res{w}", f"flash_attention_bwd_dkv_bf16{w}",
            f"flash_attention_bwd_dq_bf16{w}")


def _vae_form_kernels():
    out = []
    for dt, d in VAE_FORMS:
        what = (f"{'bf16' if dt == 'bfloat16' else 'fp32'}, static VAE, "
                f"{VAE_C // d} heads of {d}")
        src = ("gvfdiffusion_torch/csrc/flash_attention_bwd"
               + ("_bf16" if dt == "bfloat16" else "") + ".cu")
        res, dkv, dq = vae_form_keys(dt, d)
        out += [(f"flash_attention[{what}: forward with residual]",
                 "gvfdiffusion_tpu/sparse/attention.py:57",
                 "gvfdiffusion_torch/csrc/flash_attention.cu", res),
                (f"flash_attention backward dkv[{what}]",
                 "jax/experimental/pallas/ops/tpu/flash_attention.py:796",
                 src, dkv),
                (f"flash_attention backward dq[{what}]",
                 "jax/experimental/pallas/ops/tpu/flash_attention.py:1146",
                 src, dq)]
    return out


KERNELS += _vae_form_kernels()
VAE_FORM_KEYS = tuple(k for dt, d in VAE_FORMS for k in vae_form_keys(dt, d))

# [widths]: K5, K6 and K7 at the head widths their kernels reach by
# zero-padding to 32, 64 or 128 (ops/_widths.py), and K5 / K6 at 128 (new
# instantiations). The DiT at 512 channels with main_latent
# --model.num_heads=32 (heads of 16) and =4 (128) trains its composed path
# through K5 and K6 at those widths; the static VAE at 768 with main_vae
# --static_vae.num_heads=8 (96) and 16 (48) through K7's forward and
# backward
WIDTH_K5 = (16, 48, 128)           # K5's key-bias form, bf16 and fp32 io
WIDTH_DIT = (16, 128)              # main_latent's widths: K5 and K6
WIDTH_VAE_FORMS = (("bfloat16", 48), ("bfloat16", 96), ("float32", 48),
                   ("float32", 96))
WIDTH_VAE_HEADS = 8                # main_vae's heads of 96 ([vae-train])
WIDTH_C = 768                      # the key-bias form's lanes: 768 / D heads
K5_SRC = ("gvfdiffusion_tpu/ops/fused_attention.py:108",
          "gvfdiffusion_torch/csrc/fused_attention.cu")
K5_Q8_SRC = ("gvfdiffusion_tpu/ops/fused_attention.py:154",
             "gvfdiffusion_torch/csrc/fused_attention.cu")
K6_SRC = ("gvfdiffusion_tpu/ops/fused_attention.py:427",
          "gvfdiffusion_torch/csrc/temporal_attention.cu")


def _padded(d: int) -> str:
    """The kernels-line name's note of a padded width (ops/_widths.py's
    card_width; the table is built before the package can be imported)."""
    w = 32 if d <= 32 else 64 if d <= 64 else 128
    return "" if w == d else f", padded to {w}"


def _width_kernels():
    out = []
    for d in WIDTH_K5:
        for dt in ("bf16", "fp32"):
            out.append((f"fused_attention[key bias, heads of {d}, {dt} io"
                        f"{_padded(d)}]", *K5_SRC,
                        f"width_attention_bias_{dt}_d{d}"))
    for d in WIDTH_DIT:
        out += [(f"fused_attention[DiT training self, heads of {d}, fp32"
                 f"{_padded(d)}]", *K5_SRC, f"train_attention_d{d}"),
                (f"fused_attention[DiT training cross, heads of {d}, fp32"
                 f"{_padded(d)}: image 1374 + static 512]", *K5_SRC,
                 f"train_attention_cross_d{d}"),
                (f"temporal_attention[heads of {d}, fp32{_padded(d)}]",
                 *K6_SRC, f"temporal_attention_d{d}"),
                (f"temporal_attention[heads of {d}, bf16{_padded(d)}]",
                 *K6_SRC, f"temporal_attention_bf16_d{d}")]
        for q in ("qk", "qkav"):
            out.append((f"fused_attention[int8 {'qk+av' if q == 'qkav' else q}"
                        f", DiT self, heads of {d}, bf16{_padded(d)}]",
                        *K5_Q8_SRC, f"attention_{q}_d{d}"))
    out.append(("fused_attention[segment_size 32, packed temporal, heads of "
                f"16, bf16{_padded(16)}]", *K5_SRC, "attention_seg_d16"))
    for dt, d in WIDTH_VAE_FORMS:
        what = (f"{'bf16' if dt == 'bfloat16' else 'fp32'}, static VAE, "
                f"{VAE_C // d} heads of {d}{_padded(d)}")
        src = ("gvfdiffusion_torch/csrc/flash_attention_bwd"
               + ("_bf16" if dt == "bfloat16" else "") + ".cu")
        res, dkv, dq = vae_form_keys(dt, d)
        out += [(f"flash_attention[{what}: forward with residual]",
                 "gvfdiffusion_tpu/sparse/attention.py:57",
                 "gvfdiffusion_torch/csrc/flash_attention.cu", res),
                (f"flash_attention backward dkv[{what}]",
                 "jax/experimental/pallas/ops/tpu/flash_attention.py:796",
                 src, dkv),
                (f"flash_attention backward dq[{what}]",
                 "jax/experimental/pallas/ops/tpu/flash_attention.py:1146",
                 src, dq)]
    return out


WIDTH_KERNELS = _width_kernels()
WIDTH_KEYS = tuple(k for *_, k in WIDTH_KERNELS)  # checked in [widths]
KERNELS += WIDTH_KERNELS
# [sublayer-widths]: K1, K2 and K3 at the head widths their rules admit
# beyond 32 and 64 (ops/_widths.py: 1, 2, 4, 8, 16 and 128; a head below
# 32 runs zero-padded to 32 in the projections' weights). Every form at
# heads of 8, 16 and 128 at full width (the DiT's [1, 32, 512, 512] with
# 512 / D heads, K3's single context at the compacted torso's [1, 4096,
# 1024] with 1024 / D heads), the float K1, K2 and K3 at heads of 1, 2
# and 4 at one shape each (C = 128, 128 / D heads). Each form's key
# "sw_<form>_d<D>"; K3's single context at 128 in bf16 and fp32 without
# the q norm has its entries already (cross_single_d128,
# cross_single_fp32_d128).
SW_WIDTHS = (8, 16, 128)
SW_NARROW = (1, 2, 4)
SW_NARROW_FORMS = ("self", "temporal", "cross")
SW_DIT_HEADS = (32, 4)      # VideoTo4DPipeline.run's DiT: heads of 16, 128
SW_NARROW_C = 128           # the narrow widths' channels
SW_NARROW_FRAMES = 8        # and frames (K1, K3: [8, 512, 128])
SW_FORMS = {
    # form: (TPU kernel body, the kernels-line name's form, its counter)
    "self": (170, "", "self"),
    "self_norms_off": (170, "rms=False, ", "self"),
    "self_q8": (170, "int8 QK, ", "self_q8"),
    "self_seg": (170, "seg 16, on K2's chain, ", "self_seg"),
    "self_seg_q8": (170, "seg 16, int8 QK, on K2's chain, ", "self_seg_q8"),
    "temporal": (373, "", "temporal"),
    "temporal_norms_off": (373, "rms=False, ", "temporal"),
    "temporal_q8": (373, "int8 QK, ", "temporal_q8"),
    "cross": (589, "", "cross"),
    "cross_rms": (589, "q RMS norm, ", "cross"),
    "cross_q8": (589, "int8 KV, ", "cross_q8"),
    "cross_q8_rms": (589, "int8 KV, q RMS norm, ", "cross_q8"),
    "cross_single": (589, "single context, bf16, ", None),
    "cross_single_rms": (589, "single context, q RMS norm, bf16, ", None),
    "cross_single_fp32": (589, "single context, fp32, ", None),
    "cross_single_rms_fp32": (589, "single context, q RMS norm, fp32, ",
                              None),
    "cross_single_q8": (589, "single context, int8 KV, q RMS norm, ", None),
}
SW_FUNCS = {170: "fused_self_sublayer", 373: "fused_temporal_sublayer",
            589: "fused_cross_sublayer"}


def _sw_forms(d: int):
    if d in SW_NARROW:
        return SW_NARROW_FORMS
    return tuple(f for f in SW_FORMS if not (
        d == 128 and f in ("cross_single", "cross_single_fp32")))


def _sublayer_width_kernels():
    out = []
    for d in SW_NARROW + SW_WIDTHS:
        for form in _sw_forms(d):
            line, what, _ = SW_FORMS[form]
            out.append((f"{SW_FUNCS[line]}[{what}heads of {d}]",
                        f"gvfdiffusion_tpu/ops/fused_sublayer.py:{line}",
                        "gvfdiffusion_torch/csrc/fused_sublayer.cu",
                        f"sw_{form}_d{d}"))
    return out


SW_KERNELS = _sublayer_width_kernels()
KERNELS += SW_KERNELS
QK8 = {"self_q8": "self", "temporal_q8": "temporal"}  # int8 QK -> float form
# K7 output rel L2 vs plain, both layouts (readings 2.4e-3, 2.4e-3; at
# heads of 32 and 128, prefix, 2.4e-3, 2.4e-3); in fp32, where the kernel
# and its plain version differ by the order of their fp32 sums alone
# (readings 8.5e-7, 9.3e-7)
FLASH_REL_BOUND = 1e-2
FLASH_F32_BOUND = 5e-6
# the fp32 forms of K7 and K3's single context (3xTF32 products on the
# tensor cores) and their plain fp32 versions are also printed against an
# fp64 reference on this many query rows: what the split costs beside fp32
F64_ROWS = 2048
# K7's forms: key -> (dtype, heads, head width) at the torso's C = 1024
FLASH_FORMS = {"flash_attention": ("bfloat16", 16, 64),
               "flash_attention_fp32": ("float32", 16, 64),
               "flash_attention_d32": ("bfloat16", 32, 32),
               "flash_attention_d128": ("bfloat16", 8, 128),
               "flash_attention_fp32_d32": ("float32", 32, 32),
               "flash_attention_fp32_d128": ("float32", 8, 128)}
# K3's single context at the uncompacted torso's [1, 32768, 1024] x 1374
# image tokens: key -> (compute dtype, heads). Its bf16 form at heads of 64
# is the "cross_single" sublayer case (the compacted torso's 4096 rows) in
# the kernels line; at 32768 rows ("cross_single_32k", TRELLIS at its
# defaults) it is checked and printed beside it
SINGLE_FORMS = {"cross_single_32k": ("bfloat16", 16),
                "cross_single_fp32": ("float32", 16),
                "cross_single_fp32_d32": ("float32", 32),
                "cross_single_fp32_d128": ("float32", 8),
                "cross_single_d32": ("bfloat16", 32),
                "cross_single_d128": ("bfloat16", 8)}
# K3's single context at compute_dtype=float32 vs its plain version: (rel
# L2 of y, of the update y - x); readings 6.9e-8, 6.0e-7 at heads of 32, 64
# and 128 alike (its bf16 forms take BOUNDS["cross_single"], read 1.4e-4,
# 1.2e-3 at heads of 32 and 128 too)
CROSS_F32_BOUNDS = (4e-7, 3e-6)
# K3's int8 form vs its plain int8 version at the DiT's shapes: (rel L2 of
# y, of the update y - x); readings 6.2e-4, 3.7e-3
Q8_BOUNDS = (3e-3, 2e-2)
Q8_FLOAT_BOUND = 5e-2      # its update vs the float K3's on the same K/V (1.1e-2)
# the video main path on the int8 cache against the float run (same noise):
# rel L2 of the latent and of the deltas, at guidance 1.0/1.0 and 32 steps
# (readings 1.0e-3, 2.4e-3) and at 2.0/5.0 and 4 steps (6.7e-3, 2.9e-3)
INT8_RUN_BOUNDS = {"latent": 5e-3, "deltas": 1e-2}
INT8_CFG_BOUNDS = {"latent": 3e-2, "deltas": 1.5e-2}
# K1 / K2 with int8 QK vs their plain int8-QK versions at the DiT's shapes:
# (rel L2 of y, of the update y - x), the same for both (readings K1 2.1e-4,
# 1.9e-3; K2 1.7e-4, 1.4e-3); their update vs the float kernel's (9.8e-3,
# 1.4e-2)
QK8_BOUNDS = (8e-4, 8e-3)
QK8_FLOAT_BOUND = 5e-2
# run() with self_quant="int8" on the int8 cache against the float run
# (same noise): rel L2 of the latent and the deltas, at 1.0/1.0 x 32 steps
# (readings 1.030e-3, 2.382e-3) and 2.0/5.0 x 4 steps (6.695e-3, 2.919e-3)
SELFQ8_RUN_BOUNDS = {"latent": 5e-3, "deltas": 1e-2}
SELFQ8_CFG_BOUNDS = {"latent": 3e-2, "deltas": 1.5e-2}
# the in-the-wild phase: the azimuth (degrees) and the scale recovered from
# a render of the splat at WILD_AZIMUTH (readings 137.00, 1.0000); the
# 24-frame sweep through the early-exit multi-round blend against the same
# without early exit (reading 0: no tile of the translucent random-weight
# splat saturates, so early exit stops nothing) and against one round of
# K = 256 (reading 3.5e-8), rel L2
WILD_AZIMUTH = 137
WILD_ANGLE_TOL, WILD_SCALE_TOL = 1.0, 0.02
SWEEP_BOUNDS = {"no_early_exit": 1e-6, "one_round_256": 2e-7}
# early exit where tiles saturate: the canonical splat made opaque, 8
# views through the early-exit blend against its scan form, rel L2 > 0 (a
# tile stopped) and within the bound (reading 4.7e-8 on the H100)
OPAQUE_LOGIT, OPAQUE_SCALE, OPAQUE_SWEEP_BOUND = 6.0, 4.0, 2.5e-7
RENDER_FRAMES = 24
TRAIN_KERNELS = ("attention_d32", "attention_cross_d32", "temporal_attention")
# Kernel vs plain version at the full shapes, per sublayer: (rel L2 of the
# output y, rel L2 of the update y - x). Each is 3-6x the error measured on
# an H100 80GB HBM3 (700 W) with these seeds, which four runs reproduced to
# every digit: y 6.2e-4 / 9.0e-4 / 1.0e-3 / 9.9e-5 and update 6.0e-3 /
# 7.8e-3 / 6.2e-3 / 5.1e-4 for self / temporal / cross / MLP. The single-
# context cross sublayer runs the torso's fp32 residual, hence its tighter
# bounds.
BOUNDS = {"self": (3e-3, 3e-2), "temporal": (3e-3, 3e-2),
          "cross": (3e-3, 3e-2), "mlp": (5e-4, 3e-3),
          "cross_single": (5e-4, 5e-3)}  # readings 1.4e-4, 1.3e-3
ATTN_REL_BOUND = 1e-2      # K5 output rel L2, every form (2.1e-3-2.4e-3)
# TRELLIS at its defaults (32768 slots, K7): rel L2 on the valid voxels of
# one SLat forward, kernels vs plain, and of run()'s SLat vs the compacted
# torso's
TRELLIS32K_BOUNDS = {"forward": 3e-2, "compacted": 1e-2}  # 7.4e-3, 2.5e-3
# TRELLIS, kernels vs impl="plain": rel L2 of the sparse-structure latent
# (same tokens and noise), occupancy flips / occupied voxels, rel L2 of the
# SLat and of the activated Gaussians on the kernel run's structure
TRELLIS_BOUNDS = {"ss_latent": 2e-2, "flips": 0.1, "slat": 1e-2,
                  "gaussians": 1.5e-2}  # readings 4.7e-3, 2.1e-2, 2.6e-3, 3.5e-3
DINO_REL_BOUND = 2e-2      # encode_image tokens, kernels vs plain (3.9e-3)
DIT_REL_BOUND = 3e-2       # rel L2 of the whole 12-block DiT output (9.6e-3)
RUN_REL_BOUND = 1e-6       # run() against the same stages called one by one
# the DiT's training path (kernels vs plain): K5 at heads of 32 and K6
# forward rel L2, their gradients (the Functions' fp32 backward against
# autograd through the bf16-rounded plain forward), and one micro-step:
# loss (relative), gradients, updated parameters, the update itself
TRAIN_ATTN_BOUND = 1.5e-4  # readings 2.6e-5-3.1e-5
TRAIN_GRAD_BOUND = 2e-2    # readings 4.1e-3-4.5e-3
TRAIN_BOUNDS = {"loss": 1e-5, "grads": 1.5e-3, "params": 6e-8,
                "update": 4e-2}  # readings 2.0e-6, 2.6e-4, 1.1e-8, 7.7e-3
TRAIN_B, TRAIN_T = 2, 24   # configs/diffusion.yml: batch_size, sample_timesteps
PEAK_FLOPS = 989e12        # dense bf16, H100 SXM datasheet (assumed)
PEAK_FP32 = 67e12          # fp32 outside the tensor cores, the same
# dense tf32 on the tensor cores, the same: the fp32 forms of K7 and K3's
# single context do each fp32 product as three tf32 products (3xTF32), so
# their bound is three times their fp32 operations at this rate
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12       # HBM3, H100 SXM datasheet (assumed)

B, T, N, C, H, M = 1, 32, 512, 512, 16, 2048   # the DiT at full width
L_IMG = 1374               # DINOv2 tokens at 518^2: 1 + 4 registers + 37^2
L_IMG224 = 261             # DINOv2 tokens at 224^2: 1 + 4 + 16^2
G = 131072                 # Gaussians: 16384 voxels x 8
VOXELS = 16384             # TRELLIS voxel slots (bench.py's L_VOX)
TORSO = 4096               # the SLat torso's compacted capacity
L_TORSO_VALID = 3500       # valid keys of the kernel phase's kv_bias case
SLOTS = 32768              # TrellisConfig().voxel_capacity: the default torso
L_FLASH_VALID = 3700       # valid keys of the kernel phase's K7 case
PEAK_INT8 = 1979e12        # dense int8, H100 SXM datasheet (assumed)
# occupied voxels to aim at, largest first: with random weights the
# occupancy is not spatially coherent, so nearly every voxel has a parent
# of its own and only about 4000 fit the torso
OCC_TARGETS = (12000, 8000, 6000, 4500, 4000, 3500, 3000)
RENDER_DELTA_SCALE = 0.01  # random-weight deltas, scaled as bench.py:395
# The forms of the DiT's other configurations: key -> (the form whose
# checks it takes, its case: heads, q/k RMS norms on the self sublayers, q
# RMS norm on the cross sublayer, MLP width). Each is checked at the
# main-path shape of the configuration that runs it.
FORMS = {
    "self_norms_off": ("self", (H, False, True, M)),
    "temporal_norms_off": ("temporal", (H, False, True, M)),
    "cross_rms": ("cross", (H, False, True, M)),
    "self_q8_norms_off": ("self_q8", (H, False, True, M)),
    "temporal_q8_norms_off": ("temporal_q8", (H, False, True, M)),
    "cross_q8_rms": ("cross_q8", (H, False, True, M)),
    "self_d64": ("self", (8, True, False, M)),
    "temporal_d64": ("temporal", (8, True, False, M)),
    "cross_d64": ("cross", (8, True, False, M)),
    "self_q8_d64": ("self_q8", (8, True, False, M)),
    "temporal_q8_d64": ("temporal_q8", (8, True, False, M)),
    "cross_q8_d64": ("cross_q8", (8, True, False, M)),
    "mlp_m1024": ("mlp", (H, True, False, 1024)),
    "temporal_attention_d64": ("temporal_attention", None),
    "train_attention_d64": ("attention_d32", None),
    "train_attention_cross_d64": ("attention_cross_d32", None),
    # the infer CLI's forms: forward only, the training forms' bounds
    "infer_attention_d32": ("attention_d32", None),
    "infer_attention_cross_d32": ("attention_cross_d32", None),
    "infer_temporal_attention": ("temporal_attention", None),
}
# each new form's bounds: (rel L2 of y, of the update), 3-6x the readings
# on an H100 80GB HBM3 (700 W), in the comments; K5 and K6 at heads of 64
# in fp32 (training): their forward and their gradients (as
# TRAIN_ATTN_BOUND / TRAIN_GRAD_BOUND); K5 in bf16 at heads of 32
# (dit-rope's inference): its output. K5 at heads of 64 takes an online
# softmax (P rounded to bf16 under a running maximum) where its plain
# version takes the row maximum, hence its forward's larger error than at
# heads of 32, whose fixed shift both share
FORM_BOUNDS = {
    "self_norms_off": (3e-3, 3e-2),         # 6.7e-4, 6.0e-3
    "temporal_norms_off": (3e-3, 3e-2),     # 9.8e-4, 7.3e-3
    "cross_rms": (4e-3, 3e-2),              # 1.0e-3, 6.0e-3
    "self_d64": (3e-3, 3e-2),               # 6.5e-4, 5.9e-3
    "temporal_d64": (3e-3, 3e-2),           # 9.3e-4, 7.4e-3
    "cross_d64": (4e-3, 3e-2),              # 1.0e-3, 6.1e-3
    "mlp_m1024": (5e-4, 2e-3),              # 9.1e-5, 4.1e-4
    "self_q8_norms_off": (8e-4, 8e-3),      # 2.5e-4, 2.2e-3
    "temporal_q8_norms_off": (8e-4, 8e-3),  # 2.2e-4, 1.6e-3
    "self_q8_d64": (8e-4, 8e-3),            # 2.3e-4, 2.1e-3
    "temporal_q8_d64": (8e-4, 8e-3),        # 1.8e-4, 1.5e-3
    "cross_q8_rms": (2e-3, 1.2e-2),         # 4.1e-4, 2.4e-3
    "cross_q8_d64": (3e-3, 2e-2),           # 6.3e-4, 3.8e-3
    "temporal_attention_d64": (1.2e-4, 2e-2),  # 2.4e-5, 4.1e-3
    "rope_attention_d32": (4e-4,),              # 7.1e-5
    "rope_attention_cross_d32": (4e-4,),        # 8.5e-5 / 7.1e-5
    "train_attention_d64": (6e-3, 2e-2),        # 1.3e-3, 4.7e-3
    "train_attention_cross_d64": (6e-3, 2e-2),  # 1.5e-3 / 1.3e-3, 4.8e-3
    # [widths]: heads of 128 take the running maximum as heads of 64 do,
    # heads of 16 the fixed shift as heads of 32 (their defaults); K6's
    # bf16 io the output's rounding on top (tests/test_torch_port_k6_edges
    # .py's 1e-3), forward only
    "train_attention_d128": (6e-3, 2e-2),
    "train_attention_cross_d128": (6e-3, 2e-2),
    "temporal_attention_bf16_d16": (1e-3, None),
    "temporal_attention_bf16_d128": (1e-3, None),
}
SUBLAYERS = ("self", "temporal", "cross", "mlp", "cross_single")
# K2's, K4's and K6's forms before their Hopper redesign: kernel ms of the
# parent's run on an H100 80GB HBM3 (700 W), printed beside the new time
WAS_MS = {"temporal": 0.956, "temporal_norms_off": 0.956,
          "temporal_d64": 1.088, "temporal_q8": 0.987,
          "temporal_q8_norms_off": 0.950, "temporal_q8_d64": 0.941,
          "mlp": 0.936, "mlp_m1024": 0.545,
          "temporal_attention": 0.169, "temporal_attention_d64": 0.244}
# The DiT's other configurations (configs/diffusion.yml at full width with
# these fields changed), the steps of their run() (the two that reach new
# kernel forms run the main path's 32; the others 4), and the int8 run
# (int8 cache + int8 QK; dit-rope composes on the dequantized cache) against
# the float run, rel L2 of the latent and the deltas, 3-6x the readings on
# an H100 80GB HBM3 (700 W) in the comments
DIT_CONFIGS = {
    "dit-rms-cross": dict(qk_rms_norm=False, qk_rms_norm_cross=True),
    "dit-d64": dict(num_heads=8),
    "dit-rope": dict(pe_mode="rope", share_mod=True),
    "dit-notemporal": dict(no_temporal_attn=True, pe_mode="learnable",
                           mlp_ratio=2.0),
}
CONFIG_STEPS = {"dit-rms-cross": 32, "dit-d64": 32, "dit-rope": 4,
                "dit-notemporal": 4}
CONFIG_INT8_BOUNDS = {
    "dit-rms-cross": {"latent": 5e-3, "deltas": 1.5e-2},   # 1.1e-3, 3.1e-3
    "dit-d64": {"latent": 5e-3, "deltas": 1e-2},           # 1.3e-3, 2.6e-3
    "dit-rope": {"latent": 1.5e-2, "deltas": 1.2e-2},      # 3.5e-3, 2.8e-3
    "dit-notemporal": {"latent": 1.5e-2, "deltas": 1.5e-2},  # 3.4e-3, 3.1e-3
}
# where each new form's launches are read: (configuration, int8 run, counter)
FORM_RUNS = {
    "self_norms_off": ("dit-rms-cross", None, "self"),
    "temporal_norms_off": ("dit-rms-cross", None, "temporal"),
    "cross_rms": ("dit-rms-cross", None, "cross"),
    "self_q8_norms_off": ("dit-rms-cross", "int8", "self_q8"),
    "temporal_q8_norms_off": ("dit-rms-cross", "int8", "temporal_q8"),
    "cross_q8_rms": ("dit-rms-cross", "int8", "cross_q8"),
    "self_d64": ("dit-d64", None, "self"),
    "temporal_d64": ("dit-d64", None, "temporal"),
    "cross_d64": ("dit-d64", None, "cross"),
    "self_q8_d64": ("dit-d64", "int8", "self_q8"),
    "temporal_q8_d64": ("dit-d64", "int8", "temporal_q8"),
    "cross_q8_d64": ("dit-d64", "int8", "cross_q8"),
    "mlp_m1024": ("dit-notemporal", None, "mlp"),
    "rope_attention_d32": ("dit-rope", None, "attention_d32"),
    "rope_attention_cross_d32": ("dit-rope", None, "attention_cross_d32"),
}
# the trainer at two of them: main_latent.main, 3 micro-steps each, with
# the launches it must make; then one micro-step on seeded random weights,
# kernels against impl="plain": (loss, relative; gradients, rel L2), 3-6x
# the readings on an H100 80GB HBM3 (700 W) in the comments
CONFIG_TRAIN_BOUNDS = {"dit-d64": (1e-5, 1.2e-3),    # 2.7e-6, 2.4e-4
                       "dit-rope": (6e-6, 1.2e-3)}   # 1.4e-6, 2.4e-4
TRAIN_CONFIGS = {
    "dit-d64": {"attention": 36, "attention_cross": 72,
                "temporal_attention": 36},
    "dit-rope": {"attention_d32": 36, "attention_cross_d32": 72},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def rel_l2_64(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def time_ms(fn, iters: int = 10, warm: int = 2) -> float:
    """Mean ms of `iters` calls after `warm` warm-up calls (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*objs) -> int:
    """Bytes of every tensor in objs (nested tuples, lists and dicts)."""
    import torch

    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += nbytes(*o)
        elif isinstance(o, dict):
            total += nbytes(*o.values())
    return total


def bound(flops: float, moved: int, peak: float = PEAK_FLOPS):
    """(bound_ms, bound_by) at the assumed peaks (`peak` the operations'
    rate: bf16 tensor cores, PEAK_FP32 for fp32 work on the CUDA cores,
    PEAK_TF32 for tf32 products)."""
    return _bound_mixed([(flops, peak)], moved)


def _bound_mixed(ops, moved: int):
    """bound() for work of several operand types: ops is [(operations,
    peak rate)], their times added."""
    t_ops = sum(n / peak for n, peak in ops) * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sublayer_cases(dev, g, heads=H, rms=True, rms_cross=False, mlp=M, c=C,
                   rows=B * T):
    """Inputs at the DiT's full shapes: B*T = 32 frames of N = 512 tokens,
    C = 512, `heads` heads (16 of 32 as shipped), MLP `mlp` (2048), image
    KV 1374, static KV 512; `rms` the self sublayers' q/k norms, `rms_cross`
    the cross sublayer's q norm (its gamma joins the parameters). `c` and
    `rows` change the channels and K1's and K3's frames (K2 keeps B x T)."""
    import torch

    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    def w(i, o):
        return rnd(i, o, scale=i ** -0.5)

    def mod(n):
        return rnd(n, c, scale=0.3)

    def gam():
        return (1.0 + 0.1 * torch.randn(c, generator=g, device=dev)).to(bf) \
            * (c // heads) ** 0.5

    self_w = lambda: (w(c, 3 * c), rnd(3 * c, scale=0.1), gam(), gam(),
                      w(c, c), rnd(c, scale=0.1))
    x3 = rnd(rows, N, c)
    x4 = rnd(B, T, N, c)

    def cross_p():
        qg = (gam(),) if rms_cross else ()
        return ((1.0 + 0.1 * rnd(c)).to(bf), rnd(c, scale=0.1), w(c, c),
                rnd(c, scale=0.1), *qg, w(c, c), rnd(c, scale=0.1))

    kv_img = (rnd(rows, L_IMG, c), rnd(rows, L_IMG, c))
    kv_st = (rnd(rows, N, c), rnd(rows, N, c))
    # the SLat torso: fp32 residual [1, 4096, 1024], 16 heads of 64, k/v the
    # halves of the [1, 1374, 2048] projection of the image tokens
    Ct = 1024
    xt = torch.randn(1, TORSO, Ct, generator=g, device=dev)
    pt = ((1.0 + 0.1 * rnd(Ct)).to(bf), rnd(Ct, scale=0.1),
          rnd(Ct, Ct, scale=Ct ** -0.5), rnd(Ct, scale=0.1),
          rnd(Ct, Ct, scale=Ct ** -0.5), rnd(Ct, scale=0.1))
    kvt = rnd(1, L_IMG, 2 * Ct)
    return {
        "cross_single": (xt, dict(args=(xt, pt, (kvt[..., :Ct], kvt[..., Ct:])),
                                  kw=dict(num_heads=16))),
        "self": (x3, dict(args=(x3, mod(B), mod(B), mod(B), *self_w()),
                          kw=dict(num_heads=heads, rms=rms,
                                  mod_repeat=rows // B))),
        "temporal": (x4, dict(args=(x4, mod(B), mod(B), mod(B), *self_w()),
                              kw=dict(num_heads=heads, rms=rms))),
        "cross": (x3, dict(args=(x3, cross_p(), kv_img, cross_p(), kv_st),
                           kw=dict(num_heads=heads, rms=rms_cross))),
        "mlp": (x3, dict(args=(x3, mod(B), mod(B), mod(B), w(c, mlp),
                               rnd(mlp, scale=0.1), w(mlp, c),
                               rnd(c, scale=0.1)),
                         kw=dict(mod_repeat=rows // B))),
    }


def sublayer_flops(key: str, mlp: int = M) -> float:
    """Operations of a sublayer at the DiT's shapes (the same at every head
    width: H * D = C)."""
    if key == "cross_single":
        return 2 * (2 * TORSO * 1024 * 1024) + 4 * TORSO * L_IMG * 1024
    R = B * T * N
    proj = 2 * R * C * 3 * C + 2 * R * C * C  # qkv and output projections
    if key == "self":
        return proj + 4 * B * T * N * N * C
    if key == "temporal":
        return proj + 4 * B * N * T * T * C
    if key == "cross":
        return 2 * 2 * (2 * R * C * C) + 4 * B * T * N * (L_IMG + N) * C
    return 2 * 2 * R * C * mlp


# -- library compositions of K1-K4: a yardstick timed here, never used by
# the port: F.layer_norm / modulate, cuBLAS bf16 matmuls,
# F.scaled_dot_product_attention, the residual.

def _ln_mod(x, sh, sc, rep):
    import torch.nn.functional as F

    h = F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6)
    shape = (-1,) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    sh, sc = (a.repeat_interleave(rep, 0).view(shape) for a in (sh, sc))
    return (h * (1 + sc.float()) + sh.float()).bfloat16()


def _rms(a, g):
    af = a.float()
    return (af * (af.square().sum(-1, keepdim=True) + 1e-12).rsqrt()
            * g.float().view(a.shape[-2], -1)).bfloat16()


def library_self(x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo, num_heads,
                 mod_repeat=1, rms=True):
    import torch.nn.functional as F

    Bx, L, _ = x.shape
    qkv = (_ln_mod(x, sh, sc, mod_repeat) @ wqkv + bqkv).view(
        Bx, L, 3, num_heads, -1)
    q, k = qkv[:, :, 0], qkv[:, :, 1]
    if rms:
        q, k = _rms(q, qg), _rms(k, kg)
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), qkv[:, :, 2].transpose(1, 2))
    out = o.transpose(1, 2).reshape(Bx, L, -1) @ wo + bo
    g = gate.repeat_interleave(mod_repeat, 0)[:, None]
    return (x.float() + out.float() * g.float()).bfloat16()


def library_temporal(x, sh, sc, gate, wqkv, bqkv, qg, kg, wo, bo, num_heads,
                     rms=True):
    import torch.nn.functional as F

    Bx, Tx, Nx, _ = x.shape
    qkv = (_ln_mod(x, sh, sc, 1) @ wqkv + bqkv).view(Bx, Tx, Nx, 3,
                                                     num_heads, -1)
    q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
    if rms:
        q, k = _rms(q, qg), _rms(k, kg)
    o = F.scaled_dot_product_attention(  # [B, N, H, T, D]
        *(a.permute(0, 2, 3, 1, 4) for a in (q, k, v)))
    out = o.permute(0, 3, 1, 2, 4).reshape(Bx, Tx, Nx, -1) @ wo + bo
    return (x.float() + out.float() * gate.float()[:, None, None]).bfloat16()


def library_cross(x, p1, kv1, p2, kv2, num_heads, rms=False):
    import torch.nn.functional as F

    Bx, L, _ = x.shape

    def one(xf, p, kv):
        ns, nb, wq, bq, *qg, wo, bo = p
        h = F.layer_norm(xf, (x.shape[-1],), ns.float(), nb.float(),
                         eps=1e-6)
        q = (h.bfloat16() @ wq + bq).view(Bx, L, num_heads, -1)
        if rms:
            q = _rms(q, qg[0])
        k, v = (a.view(Bx, a.shape[1], num_heads, -1).transpose(1, 2)
                for a in kv)
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k, v)
        return xf + (o.transpose(1, 2).reshape(Bx, L, -1) @ wo
                     + bo).float()

    return one(one(x.float(), p1, kv1), p2, kv2).bfloat16()


def library_cross_single(x, p, kv, num_heads):
    import torch.nn.functional as F

    ns, nb, wq, bq, wo, bo = p
    Bx, L, Cx = x.shape
    h = F.layer_norm(x.float(), (Cx,), ns.float(), nb.float(), eps=1e-6)
    q = (h.bfloat16() @ wq + bq).view(Bx, L, num_heads, -1).transpose(1, 2)
    k, v = (a.reshape(Bx, a.shape[1], num_heads, -1).transpose(1, 2)
            for a in kv)
    o = F.scaled_dot_product_attention(q, k, v)
    out = o.transpose(1, 2).reshape(Bx, L, Cx) @ wo + bo
    return x + out.to(x.dtype)


def library_mlp(x, sh, sc, gate, w1, b1, w2, b2, mod_repeat=1):
    import torch.nn.functional as F

    hid = F.gelu(_ln_mod(x, sh, sc, mod_repeat) @ w1 + b1, approximate="tanh")
    g = gate.repeat_interleave(mod_repeat, 0)[:, None]
    return (x.float() + (hid @ w2 + b2).float() * g.float()).bfloat16()


def _was(key: str) -> str:
    return f" (was {WAS_MS[key]:.3f} ms)" if key in WAS_MS else ""


def phase_kernels(dev):
    import torch
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    fns = {"self": fsl.fused_self_sublayer,
           "temporal": fsl.fused_temporal_sublayer,
           "cross": fsl.fused_cross_sublayer, "mlp": fsl.fused_mlp_sublayer,
           "cross_single": fsl.fused_cross_sublayer}
    libs = {"self": library_self, "temporal": library_temporal,
            "cross": library_cross, "mlp": library_mlp,
            "cross_single": library_cross_single}
    shipped = (H, True, False, M)
    case_sets = {}

    def cases_of(variant):
        """The sublayer cases of one configuration, drawn from one seed."""
        if variant not in case_sets:
            g = torch.Generator(device=dev).manual_seed(1)
            case_sets[variant] = sublayer_cases(dev, g, *variant)
        return case_sets[variant]

    results = {}
    for name, replaces, source, key in KERNELS:
        base, variant = FORMS.get(key, (key, shipped))
        if base not in SUBLAYERS:
            continue
        x, case = cases_of(variant)[base]
        fn, lib = fns[base], libs[base]
        args, kw = case["args"], case["kw"]
        y = fn(*args, **kw)
        torch.cuda.synchronize()
        ref = fn(*args, **kw, impl="plain")
        err = rel_l2(y, ref)
        upd = rel_l2(y.float() - x.float(), ref.float() - x.float())
        mae = float((y.float() - ref.float()).abs().max())
        finite = bool(torch.isfinite(y).all())
        lib_upd = rel_l2(lib(*args, **kw).float() - x.float(),
                         ref.float() - x.float())
        ms = time_ms(lambda: fn(*args, **kw))
        plain_ms = time_ms(lambda: fn(*args, **kw, impl="plain"))
        lib_ms = time_ms(lambda: lib(*args, **kw))
        b_ms, b_by = bound(sublayer_flops(base, variant[3]), nbytes(args, y))
        y_bound, upd_bound = FORM_BOUNDS.get(key) or BOUNDS[key]
        log(f"[kernel] {name}: shape {tuple(x.shape)} {kw} max_abs_err "
            f"{mae:.4g} rel_l2 {err:.3e} (bound {y_bound:g}) update_rel_l2 "
            f"{upd:.3e} (bound {upd_bound:g}) kernel {ms:.3f} ms{_was(key)} "
            f"plain {plain_ms:.3f} ms library {lib_ms:.3f} ms (its update "
            f"rel_l2 {lib_upd:.3e}) bound {b_ms:.4f} ms ({b_by})")
        if not (finite and err <= y_bound and upd <= upd_bound):
            raise AssertionError(f"{name} disagrees with its plain version")
        results[key] = dict(name=name, route="cuda", source=source,
                            replaces=replaces, max_abs_err=mae, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lib_ms)
    for name, replaces, source, key in KERNELS:
        base, variant = FORMS.get(key, (key, shipped))
        if key in VAE_FLASH or key == ENCODE_FLASH or key in FORM_KEYS \
                or key in VAE_FORM_KEYS or key in WIDTH_KEYS:
            continue
        if base in TRAIN_KERNELS:
            results[key] = phase_train_kernel(dev, name, replaces, source,
                                              key)
        elif base == "cross_q8":
            results[key] = phase_cross_q8(dev, name, replaces, source,
                                          cases_of(variant)["cross"], key)
        elif key in FLASH_FORMS:
            results[key] = phase_flash(dev, name, replaces, source, key)
        elif key in SINGLE_FORMS:
            results[key] = phase_cross_single(dev, name, replaces, source,
                                              key)
        elif base in QK8:
            results[key] = phase_qk8(dev, name, replaces, source, key,
                                     base, cases_of(variant)[QK8[base]])
        elif base not in SUBLAYERS:
            results[key] = phase_attention(dev, name, replaces, source, key)
    phase_cross_single(dev, "fused_cross_sublayer[single context, 32768 "
                       "rows, bf16]", "", "", "cross_single_32k")
    results.update(phase_vae_kernels(dev))
    return results


def phase_cross_q8(dev, name, replaces, source, case, key):
    """K3's int8 form at the DiT's shapes: the float case's K/V quantized
    (quantize_kv, k scales transposed), against its plain int8 version and
    against the float K3 on the dequantized cache; the library composition
    (library_cross) runs on the cache it dequantizes itself. The case's
    heads and q RMS norm are the form's."""
    import torch
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    x, c = case
    _, p1, kv1, p2, kv2 = c["args"]
    heads = c["kw"]["num_heads"]

    c1, c2 = int8_cache(kv1, heads), int8_cache(kv2, heads)
    args = (x, p1, c1, p2, c2)
    kw = dict(c["kw"], quant=True)
    deq = lambda c_: tuple(fsl.dequantize_kv(a, s_).bfloat16() for a, s_ in
                           ((c_[0], c_[2].transpose(1, 2)), (c_[1], c_[3])))
    y = fsl.fused_cross_sublayer(*args, **kw)
    torch.cuda.synchronize()
    ref = fsl.fused_cross_sublayer(*args, **kw, impl="plain")
    y_f = fsl.fused_cross_sublayer(x, p1, deq(c1), p2, deq(c2), **c["kw"])
    err = rel_l2(y, ref)
    upd = rel_l2(y.float() - x.float(), ref.float() - x.float())
    f_upd = rel_l2(y.float() - x.float(), y_f.float() - x.float())
    mae = float((y.float() - ref.float()).abs().max())
    lib = lambda: library_cross(x, p1, deq(c1), p2, deq(c2), **c["kw"])
    ms = time_ms(lambda: fsl.fused_cross_sublayer(*args, **kw))
    float_ms = time_ms(lambda: fsl.fused_cross_sublayer(
        x, p1, kv1, p2, kv2, **c["kw"]))
    plain_ms = time_ms(lambda: fsl.fused_cross_sublayer(*args, **kw,
                                                        impl="plain"))
    lib_ms = time_ms(lib)
    # the QK products at the int8 rate, the projections and P V at bf16's
    qk = 2 * B * T * N * (L_IMG + N) * C
    b_ms, b_by = _bound_mixed([(sublayer_flops("cross") - qk, PEAK_FLOPS),
                               (qk, PEAK_INT8)], nbytes(args, y))
    y_bound, upd_bound = FORM_BOUNDS.get(key, Q8_BOUNDS)
    log(f"[kernel] {name}: x {tuple(x.shape)} bf16 {c['kw']}, int8 image KV "
        f"{tuple(c1[0].shape)} + static {tuple(c2[0].shape)} (from the float "
        f"case's K/V) max_abs_err {mae:.4g} rel_l2 {err:.3e} (bound "
        f"{y_bound:g}) update_rel_l2 {upd:.3e} (bound {upd_bound:g}); update "
        f"vs the float K3 on the dequantized cache rel_l2 {f_upd:.3e} (bound "
        f"{Q8_FLOAT_BOUND:g}); kernel {ms:.3f} ms (float K3 on the float "
        f"cache {float_ms:.3f} ms) plain {plain_ms:.3f} ms library "
        f"{lib_ms:.3f} ms bound {b_ms:.4f} ms ({b_by})")
    if not (bool(torch.isfinite(y).all()) and err <= y_bound
            and upd <= upd_bound and f_upd <= Q8_FLOAT_BOUND):
        raise AssertionError(f"{name} disagrees with its plain version")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=mae, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def phase_qk8(dev, name, replaces, source, key, base, case):
    """K1 or K2 with int8 QK at the DiT's shapes, on the float case's
    inputs: against its plain int8-QK version, and against the float
    kernel (the drift the quantization adds); the library composition is
    the float one (library_self / library_temporal). The bound counts the
    QK products at the int8 rate, the projections and P V at bf16's."""
    import torch
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    x, c = case
    fn = {"self_q8": fsl.fused_self_sublayer,
          "temporal_q8": fsl.fused_temporal_sublayer}[base]
    lib = {"self_q8": library_self, "temporal_q8": library_temporal}[base]
    args, kw = c["args"], dict(c["kw"], quant_qk=True)
    y = fn(*args, **kw)
    torch.cuda.synchronize()
    ref = fn(*args, **kw, impl="plain")
    y_f = fn(*args, **c["kw"])
    err = rel_l2(y, ref)
    upd = rel_l2(y.float() - x.float(), ref.float() - x.float())
    f_upd = rel_l2(y.float() - x.float(), y_f.float() - x.float())
    mae = float((y.float() - ref.float()).abs().max())
    ms = time_ms(lambda: fn(*args, **kw))
    float_ms = time_ms(lambda: fn(*args, **c["kw"]))
    plain_ms = time_ms(lambda: fn(*args, **kw, impl="plain"))
    lib_ms = time_ms(lambda: lib(*args, **c["kw"]))
    qk = 2 * B * T * N * (N if base == "self_q8" else T) * C
    b_ms, b_by = _bound_mixed([(sublayer_flops(QK8[base]) - qk, PEAK_FLOPS),
                               (qk, PEAK_INT8)], nbytes(args, y))
    y_bound, upd_bound = FORM_BOUNDS.get(key, QK8_BOUNDS)
    log(f"[kernel] {name}: shape {tuple(x.shape)} bf16 {c['kw']} "
        f"max_abs_err {mae:.4g} "
        f"rel_l2 {err:.3e} (bound {y_bound:g}) update_rel_l2 {upd:.3e} "
        f"(bound {upd_bound:g}); update vs the float kernel rel_l2 "
        f"{f_upd:.3e} (bound {QK8_FLOAT_BOUND:g}); kernel {ms:.3f} ms"
        f"{_was(key)} (float kernel {float_ms:.3f} ms) plain {plain_ms:.3f} "
        f"ms library {lib_ms:.3f} ms bound {b_ms:.4f} ms ({b_by})")
    if not (bool(torch.isfinite(y).all()) and err <= y_bound
            and upd <= upd_bound and f_upd <= QK8_FLOAT_BOUND):
        raise AssertionError(f"{name} disagrees with its plain version")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=mae, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def phase_flash(dev, name, replaces, source, key):
    """K7 at the uncompacted torso's 32768 slots and C = 1024 in the form
    `key` names (FLASH_FORMS: bf16 or fp32, 16 heads of 64, 32 of 32 or 8
    of 128; q/k apart, v the view of a [.., 3, H, D] projection) with 3700
    valid keys: as a prefix (the main path's layout: the downsample packs
    the parents first), timed for the kernels line, and at heads of 64
    scattered too; against the plain version on every row, and SDPA with
    the boolean key mask."""
    import torch
    import torch.nn.functional as F
    from gvfdiffusion_torch.ops import flash_attention as fl

    dtype, heads, width = FLASH_FORMS[key]
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(14)
    rnd = lambda *s_: torch.randn(*s_, generator=g, device=dev).to(dt)
    q, k = rnd(1, SLOTS, heads, width), rnd(1, SLOTS, heads, width)
    v = rnd(1, SLOTS, 3, heads, width)[:, :, 2]
    scale = width ** -0.5
    rel_bound = FLASH_F32_BOUND if dt == torch.float32 else FLASH_REL_BOUND
    # fp32: three tf32 products for each fp32 one
    ops, peak = (3, PEAK_TF32) if dt == torch.float32 else (1, PEAK_FLOPS)
    out = None
    # the torso's forms at both layouts; the other widths as the torso packs
    # its parents (the kernel is the same template)
    layouts = ("prefix", "scattered") if width == 64 else ("prefix",)
    for layout in layouts:
        valid = torch.zeros(1, SLOTS, dtype=torch.bool, device=dev)
        if layout == "prefix":
            valid[:, :L_FLASH_VALID] = True
        else:
            valid[0, torch.randperm(SLOTS, generator=g, device=dev)[
                :L_FLASH_VALID]] = True
        y = fl.flash_attention(q, k, v, valid, scale)
        torch.cuda.synchronize()
        ref = fl.flash_attention(q, k, v, valid, scale, impl="plain")
        err = rel_l2(y, ref)
        mae = float((y.float() - ref.float()).abs().max())
        mask = valid[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask)
        lib_err = rel_l2(sdpa().transpose(1, 2), ref)
        if dt == torch.float32:
            idx = valid[0].nonzero()[:, 0]
            s64 = torch.einsum("bqhd,bkhd->bhqk", q[:, :F64_ROWS].double(),
                               k[:, idx].double()) * scale
            o64 = torch.einsum("bhqk,bkhd->bqhd", s64.softmax(-1),
                               v[:, idx].double())
            del s64
            log(f"[kernel] {name} [{layout}]: against fp64 on the first "
                f"{F64_ROWS} query rows: kernel rel_l2 "
                f"{rel_l2_64(y[:, :F64_ROWS], o64):.3e}, plain fp32 "
                f"{rel_l2_64(ref[:, :F64_ROWS], o64):.3e}")
        iters = 10 if layout == "prefix" else 3
        ms = time_ms(lambda: fl.flash_attention(q, k, v, valid, scale),
                     iters=iters)
        plain_ms = time_ms(lambda: fl.flash_attention(
            q, k, v, valid, scale, impl="plain"), iters=1)
        lib_ms = time_ms(sdpa, iters=iters)
        # the key tiles visited, in the kernel's own tile
        tile = fl.key_tile(dt, width)
        tiles = int((valid.view(1, -1, tile).any(-1)).sum())
        flops = 4 * SLOTS * L_FLASH_VALID * heads * width  # valid keys only
        b_ms, b_by = bound(ops * flops, nbytes(q, k, v, y, valid), peak)
        log(f"[kernel] {name} [{layout}]: q/k/v {tuple(q.shape)} {dtype} "
            f"(v a qkv view), {L_FLASH_VALID} of {SLOTS} keys valid, {tiles} "
            f"of {SLOTS // tile} {tile}-key tiles visited; max_abs_err "
            f"{mae:.4g} "
            f"rel_l2 {err:.3e} (bound {rel_bound:g}) kernel {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s) plain {plain_ms:.3f} ms sdpa "
            f"(boolean key mask) {lib_ms:.3f} ms (its rel_l2 {lib_err:.3e}) "
            f"bound {b_ms:.4f} ms ({b_by})")
        if not (bool(torch.isfinite(y).all()) and err <= rel_bound):
            raise AssertionError(f"{name} [{layout}] disagrees with its "
                                 "plain version")
        if out is None:
            out = dict(name=name, route="cuda", source=source,
                       replaces=replaces, max_abs_err=mae, ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms)
    return out


def library_cross_single_f32(x, p, kv, num_heads):
    """K3's single context in fp32 as library calls: F.layer_norm, cuBLAS
    fp32 products (TF32 off), SDPA in fp32, the residual."""
    import torch.nn.functional as F

    ns, nb, wq, bq, wo, bo = p
    Bx, L, Cx = x.shape
    h = F.layer_norm(x, (Cx,), ns, nb, eps=1e-6)
    q = (h @ wq + bq).view(Bx, L, num_heads, -1).transpose(1, 2)
    k, v = (a.reshape(Bx, a.shape[1], num_heads, -1).transpose(1, 2)
            for a in kv)
    o = F.scaled_dot_product_attention(q, k, v)
    return x + o.transpose(1, 2).reshape(Bx, L, Cx) @ wo + bo


def phase_cross_single(dev, name, replaces, source, key):
    """K3's single context in the form `key` names (SINGLE_FORMS: fp32 or
    bf16 compute, 32, 16 or 8 heads) at the uncompacted torso's shape: x
    [1, 32768, 1024] fp32 (the torso's residual stream in either dtype), k
    and v the halves of the [1, 1374, 2048] projection of the image tokens,
    parameters and k/v in the compute dtype; against its plain version and
    the library composition."""
    import torch
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    dtype, heads = SINGLE_FORMS[key]
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(15)
    r = lambda *s_, sc=1.0: torch.randn(*s_, generator=g, device=dev) * sc
    Cx = 1024
    x = r(1, SLOTS, Cx)
    p = tuple(a.to(dt) for a in (
        1 + 0.1 * r(Cx), 0.1 * r(Cx), r(Cx, Cx, sc=Cx ** -0.5), 0.1 * r(Cx),
        r(Cx, Cx, sc=Cx ** -0.5), 0.1 * r(Cx)))
    kvp = r(1, L_IMG, 2 * Cx).to(dt)
    kv = (kvp[..., :Cx], kvp[..., Cx:])
    kw = dict(num_heads=heads, compute_dtype=dt)
    lib = library_cross_single_f32 if dt == torch.float32 else \
        library_cross_single
    with torch.no_grad():
        y = fsl.fused_cross_sublayer(x, p, kv, **kw)
        torch.cuda.synchronize()
        ref = fsl.fused_cross_sublayer(x, p, kv, **kw, impl="plain")
        err = rel_l2(y, ref)
        upd = rel_l2(y - x, ref - x)
        mae = float((y - ref).abs().max())
        lib_upd = rel_l2(lib(x, p, kv, heads) - x, ref - x)
        ms = time_ms(lambda: fsl.fused_cross_sublayer(x, p, kv, **kw))
        plain_ms = time_ms(lambda: fsl.fused_cross_sublayer(
            x, p, kv, **kw, impl="plain"), iters=3)
        lib_ms = time_ms(lambda: lib(x, p, kv, heads))
    flops = 2 * 2 * SLOTS * Cx * Cx + 4 * SLOTS * L_IMG * Cx
    # fp32: three tf32 products for each fp32 one
    b_ms, b_by = bound(flops * 3, nbytes(x, p, kvp, y), PEAK_TF32) \
        if dt == torch.float32 else bound(flops, nbytes(x, p, kvp, y))
    y_bound, upd_bound = CROSS_F32_BOUNDS if dt == torch.float32 else \
        BOUNDS["cross_single"]
    if dt == torch.float32:
        x64 = x[:, :F64_ROWS].double()
        u64 = single_update_f64(x, p[:4] + (None,) + p[4:], kvp, heads,
                                False)
        log(f"[kernel] {name}: update against fp64 on the first {F64_ROWS} "
            f"rows: kernel rel_l2 "
            f"{rel_l2_64(y[:, :F64_ROWS].double() - x64, u64):.3e}, plain "
            f"fp32 {rel_l2_64(ref[:, :F64_ROWS].double() - x64, u64):.3e}")
    log(f"[kernel] {name}: x {tuple(x.shape)} fp32 x {L_IMG} image tokens, "
        f"{dtype} compute, {heads} heads of {Cx // heads}; max_abs_err "
        f"{mae:.4g} rel_l2 {err:.3e} (bound "
        f"{y_bound:g}) update_rel_l2 {upd:.3e} (bound {upd_bound:g}) kernel "
        f"{ms:.3f} ms plain {plain_ms:.3f} ms library {lib_ms:.3f} ms (its "
        f"update rel_l2 {lib_upd:.3e}) bound {b_ms:.4f} ms ({b_by})")
    if not (bool(torch.isfinite(y).all()) and err <= y_bound
            and upd <= upd_bound):
        raise AssertionError(f"{name} disagrees with its plain version")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=mae, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def attention_case(dev, key):
    """(q, k, v, kv_bias, what) for a K5 form at its caller's shape: the
    views of a qkv projection (DINOv2), separate RMS-normed q/k with a
    contiguous v (the sparse-structure flow's self, the torso), the k/v
    halves of a kv projection (cross); the torso's bias keeps the first
    L_TORSO_VALID keys (a compaction packs the valid voxels first).
    dit-rope's composed inference, 32 frames at 16 heads of 32: self with
    separate q/k/v (RoPE and the RMS norm make q and k, and v joins k's
    strides); cross with the hoisted cache's contiguous k/v, image 1374
    keys or the "_static" key's 512."""
    import torch

    g = torch.Generator(device=dev).manual_seed(8)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).bfloat16()
    if key == "rope_attention_d32":
        return (rnd(T, N, H, C // H), rnd(T, N, H, C // H),
                rnd(T, N, H, C // H), None, "separate q/k/v")
    if key.startswith("rope_attention_cross_d32"):
        lk = N if key.endswith("_static") else L_IMG
        return (rnd(T, N, H, C // H), rnd(T, lk, H, C // H),
                rnd(T, lk, H, C // H), None, "the cache's contiguous k/v")
    if key in ("attention", "attention_dino224"):
        qkv = rnd(T, L_IMG if key == "attention" else L_IMG224, 3, 16, 64)
        return (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], None,
                f"views of qkv {tuple(qkv.shape)}")
    if key == "attention_cross":
        kv = rnd(1, L_IMG, 2, 16, 64)
        return rnd(1, N, 16, 64), kv[:, :, 0], kv[:, :, 1], None, \
            f"k/v views of kv {tuple(kv.shape)}"
    L = N if key == "attention_ss_self" else TORSO
    bias = None
    if key == "attention_bias":
        bias = torch.zeros(1, L, device=dev)
        bias[:, L_TORSO_VALID:] = float("-inf")
    return (rnd(1, L, 16, 64), rnd(1, L, 16, 64), rnd(1, L, 16, 64), bias,
            "separate q/k/v" + ("" if bias is None else
                                f", {L_TORSO_VALID} of {L} keys valid"))


def phase_attention(dev, name, replaces, source, key):
    """K5 in one form against its plain version and SDPA (the bias as a
    float mask). dit-rope's cross entry is timed at the image context's
    1374 keys; the static context's 512 is checked and printed beside
    it."""
    out = None
    for case in ((key, key + "_static") if key == "rope_attention_cross_d32"
                 else (key,)):
        r = _attention_entry(dev, name if case == key else
                             f"{name} [{case}]", case,
                             FORM_BOUNDS.get(key, (ATTN_REL_BOUND,))[0])
        out = out or dict(name=name, route="cuda", source=source,
                          replaces=replaces, **r)
    return out


def _attention_entry(dev, name, key, rel_bound):
    import torch
    import torch.nn.functional as F
    from gvfdiffusion_torch.ops import fused_attention as fa

    q, k, v, bias, what = attention_case(dev, key)
    scale = q.shape[-1] ** -0.5
    y = fa.fused_attention(q, k, v, scale, kv_bias=bias)
    torch.cuda.synchronize()
    ref = fa.fused_attention(q, k, v, scale, kv_bias=bias, impl="plain")
    err = rel_l2(y, ref)
    mae = float((y.float() - ref.float()).abs().max())
    finite = bool(torch.isfinite(y).all())
    mask = None if bias is None else bias[:, None, None, :].bfloat16()
    sdpa = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask)
    lib_err = rel_l2(sdpa().transpose(1, 2), ref)
    ms = time_ms(lambda: fa.fused_attention(q, k, v, scale, kv_bias=bias))
    plain_ms = time_ms(lambda: fa.fused_attention(
        q, k, v, scale, kv_bias=bias, impl="plain"), iters=3)
    lib_ms = time_ms(sdpa)
    Bq, Lq, Hq, D = q.shape
    lk = k.shape[1] if bias is None else int(torch.isfinite(bias[0]).sum())
    flops = 4 * Bq * Hq * Lq * lk * D  # the valid keys only
    b_ms, b_by = bound(flops, nbytes(q, k, v, y, bias))
    log(f"[kernel] {name}: q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 "
        f"({what}) max_abs_err {mae:.4g} rel_l2 {err:.3e} (bound "
        f"{rel_bound:g}) kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
        f"TFLOP/s) plain {plain_ms:.3f} ms sdpa {lib_ms:.3f} ms (its rel_l2 "
        f"{lib_err:.3e}) bound {b_ms:.4f} ms ({b_by})")
    if not (finite and err <= rel_bound):
        raise AssertionError(f"{name} disagrees with its plain version")
    return dict(max_abs_err=mae, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


# -- the DiT's training path: K5 at heads of 32 and K6 (fp32 in and out) --------


def train_attention_case(dev, key):
    """(fn(impl) -> output, inputs, what, flops, library fn) for a form of
    the training path at configs/diffusion.yml's shapes: batch 2 x 24
    frames of 512 latents, 16 heads of 32, or 512 / D heads of D for the
    keys with "_dD" (8 of 64: dit-d64; 32 of 16 and 4 of 128: main_latent
    --model.num_heads=32 / 4), bf16 for the keys with "_bf16", else fp32;
    for the keys with "infer_", the infer CLI's batch 1 x 32 frames. Self: RMS-normed q/k and a contiguous v, [48, 512,
    16, 32]; cross: q apart, k/v the halves of the [48, Lk, 2, 16, 32] kv
    projection (image Lk 1374, the "_static" key 512); K6: q/k [2, 24,
    512, 16, 32] and v the view of the [.., 3, 16, 32] qkv."""
    import re

    import torch
    import torch.nn.functional as F
    from gvfdiffusion_torch.ops import fused_attention as fa

    g = torch.Generator(device=dev).manual_seed(19)
    dt = torch.bfloat16 if "_bf16" in key else torch.float32
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
    # the "infer_" keys: the infer CLI's shapes, batch 1 x 32 frames
    Bk, Tk = (B, T) if key.startswith("infer_") else (TRAIN_B, TRAIN_T)
    width = re.search(r"_d(\d+)", key)
    D = int(width.group(1)) if width else C // H
    BT, Hh = Bk * Tk, C // D
    scale = D ** -0.5
    if "temporal_attention" in key:
        qkv = rnd(Bk, Tk, N, 3, Hh, D)
        q, k, v = rnd(Bk, Tk, N, Hh, D), rnd(Bk, Tk, N, Hh, D), \
            qkv[..., 2, :, :]
        flops = 4 * Bk * N * Tk * Tk * C

        def lib():
            o = F.scaled_dot_product_attention(
                *(a.permute(0, 2, 3, 1, 4) for a in (q, k, v)))
            return o.permute(0, 3, 1, 2, 4).contiguous()

        return (lambda a, impl=None: fa.temporal_attention(*a, scale,
                                                           impl=impl),
                (q, k, v), f"q/k {tuple(q.shape)}, v a qkv view", flops,
                lib)
    cross = "cross" in key
    lk = L_IMG if cross and not key.endswith("_static") else N
    q = rnd(BT, N, Hh, D)
    if not cross:
        k, v, what = rnd(BT, N, Hh, D), rnd(BT, N, Hh, D), "separate q/k/v"
    else:
        kv = rnd(BT, lk, 2, Hh, D)
        k, v, what = kv[:, :, 0], kv[:, :, 1], f"k/v views of kv {tuple(kv.shape)}"
    lib = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(
            1, 2)
    return (lambda a, impl=None: fa.fused_attention(*a, scale, cross=cross,
                                                    impl=impl),
            (q, k, v), what, 4 * BT * Hh * N * lk * D, lib)


def _with_grads(fn, inputs, g, impl=None):
    import torch

    ins = [a.detach().requires_grad_(True) for a in inputs]
    out = fn(ins, impl)
    return out.detach(), torch.autograd.grad(out, ins, g)


def phase_train_kernel(dev, name, replaces, source, key):
    """A training-path form against its plain version, forward and the
    gradient through the autograd Function against autograd of the plain
    version; times of the forward (kernel, plain, library), of forward +
    backward, and the bound. The cross entry is timed at the image
    context's 1374 keys; the static context's 512 is checked and printed
    beside it."""
    import torch
    from gvfdiffusion_torch import _ext

    if key == "temporal_attention_d64":  # registers and spills, per kernel
        report = _ext.ptxas_report("temporal_attention.cu")
        for line in report.splitlines():
            if "temporal_sm90_kernel" in line or "registers" in line \
                    or "spill" in line:
                log(f"[ptxas] {line.strip()}")
    attn_bound, grad_bound = FORM_BOUNDS.get(
        key, (TRAIN_ATTN_BOUND, TRAIN_GRAD_BOUND))
    # inference and the bf16 forms: no backward
    grads_too = not key.startswith("infer_") and "_bf16" not in key
    out = None
    for k in (key, key + "_static") if "cross" in key else (key,):
        fn, ins, what, flops, lib = train_attention_case(dev, k)
        with torch.no_grad():
            y = fn(ins)
            torch.cuda.synchronize()
            ref = fn(ins, "plain")
            err = rel_l2(y, ref)
            mae = float((y.float() - ref.float()).abs().max())
            lib_err = rel_l2(lib(), ref)
            ms = time_ms(lambda: fn(ins))
            plain_ms = time_ms(lambda: fn(ins, "plain"), iters=3)
            lib_ms = time_ms(lib)
        gerr, grad_text = 0.0, ""
        if grads_too:
            go = torch.randn(y.shape, generator=torch.Generator(
                device=dev).manual_seed(20), device=dev)
            _, grads = _with_grads(fn, ins, go)
            _, grads_p = _with_grads(fn, ins, go, "plain")
            gerr = max(rel_l2(a, b) for a, b in zip(grads, grads_p))
            fb_ms = time_ms(lambda: _with_grads(fn, ins, go), iters=3)
            grad_text = (f" gradients vs autograd of plain rel_l2 "
                         f"{gerr:.3e} (bound {grad_bound:g})")
        b_ms, b_by = bound(flops, nbytes(*ins, y))
        dt = "bf16" if ins[0].dtype == torch.bfloat16 else "fp32"
        log(f"[kernel] {name} [{k}]: q {tuple(ins[0].shape)} k/v "
            f"{tuple(ins[1].shape)} {dt} ({what}) max_abs_err {mae:.4g} "
            f"rel_l2 {err:.3e} (bound {attn_bound:g}){grad_text} kernel "
            f"{ms:.3f} ms{_was(k)} plain {plain_ms:.3f} ms sdpa "
            f"{lib_ms:.3f} ms (its rel_l2 {lib_err:.3e})"
            + (f" forward + backward {fb_ms:.3f} ms" if grads_too else "")
            + f" bound {b_ms:.4f} ms ({b_by}; the kernel at "
            f"{b_ms / ms:.0%} of it)")
        if not (bool(torch.isfinite(y).all()) and err <= attn_bound
                and (not grads_too or gerr <= grad_bound)):
            raise AssertionError(f"{name} [{k}] disagrees with its plain "
                                 "version")
        if out is None:
            out = dict(name=name, route="cuda", source=source,
                       replaces=replaces, max_abs_err=mae, ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms)
    return out


def write_latent_dataset(root, items: int, seed: int) -> None:
    """`items` objects in LatentDataset's layout, from a seed:
    deformation_latent.pt (latent_mean / latent_std [32, 512, 16],
    fps_sampled_gs_1024 [1024, 14]) and dinov2_features.npz [32, 1374,
    1024]."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    for i in range(items):
        d = os.path.join(root, f"obj{i:02d}")
        os.makedirs(d)
        torch.save({
            "latent_mean": torch.from_numpy(r.standard_normal(
                (T, N, 16), dtype=np.float32)),
            "latent_std": torch.from_numpy(r.uniform(
                0.05, 0.3, (T, N, 16)).astype(np.float32)),
            "fps_sampled_gs_1024": torch.from_numpy(np.concatenate([
                r.uniform(-0.5, 0.5, (1024, 3)),
                r.standard_normal((1024, 11))], 1).astype(np.float32)),
        }, os.path.join(d, "deformation_latent.pt"))
        np.savez(os.path.join(d, "dinov2_features.npz"),
                 features=r.standard_normal((T, L_IMG, 1024),
                                            dtype=np.float32))


class _Tee:
    """Writes to stdout and keeps a copy."""

    def __init__(self):
        self.parts = []

    def write(self, text):
        self.parts.append(text)
        return sys.__stdout__.write(text)

    def flush(self):
        sys.__stdout__.flush()

    def text(self):
        return "".join(self.parts)


def run_cli(main, args):
    """main(args) of a CLI with its log (stdout and stderr) kept and the
    launches of this call alone: (rc, log, launches, wall ms)."""
    import contextlib

    import torch

    tee = _Tee()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    # the logger's table goes to stdout, its messages to stderr
    with contextlib.redirect_stdout(tee), contextlib.redirect_stderr(tee):
        rc = main(args)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return rc, tee.text(), {k: n for k, n in read_counts().items() if n}, \
        wall


def run_main_latent(args):
    """cli/main_latent.main(args) with its log kept: (rc, log, wall ms)."""
    from gvfdiffusion_torch.cli import main_latent

    rc, text, _, wall = run_cli(main_latent.main, args)
    return rc, text, wall


def _losses(text):
    import re

    return [float(m) for m in re.findall(r"step \d+ loss (\S+)", text)]


def _step_times(text):
    import re

    return [float(m) for m in re.findall(r"step_time (\S+) s", text)]


def phase_training(dev, card):
    """The DiT's training main path, through cli/main_latent.main on
    configs/diffusion.yml at full width (12 x 512, 16 heads of 32, batch 2
    x 24 frames, grad_accum 2) on a seeded synthetic dataset: 3 micro-steps
    (its launches counted in this run only; one update, at lr 0), then a
    resume to 5 (a second update). Then one micro-step from the saved
    optimizer state with seeded random weights, with kernels and with
    impl="plain", and the micro-step's time, samples/s and peak memory.
    Returns the launches of the first run."""
    import shutil
    import tempfile

    import torch
    from gvfdiffusion_torch.cli.main_latent import build_model
    from gvfdiffusion_torch.train.diffusion_trainer import (loss_and_grads,
                                                            make_train_step)
    from gvfdiffusion_torch.train.train_state import (create_train_state,
                                                      make_optimizer)
    from gvfdiffusion_torch.utils.checkpoint import CheckpointManager
    from gvfdiffusion_torch.utils.config import load_config
    from gvfdiffusion_torch.utils.weights import init_random_

    work = tempfile.mkdtemp(prefix="gvf_train_smoke_")
    try:
        data, exp = os.path.join(work, "data"), os.path.join(work, "exp")
        t0 = time.perf_counter()
        write_latent_dataset(data, items=2, seed=21)
        write_ms = (time.perf_counter() - t0) * 1e3
        config = os.path.join(REPO, "configs", "diffusion.yml")
        args = ["--config", config, f"--data_dir={data}", f"--exp_dir={exp}",
                "--train.log_interval=1", "--train.save_interval=1000000"]
        cfg = load_config(config, args[2:])
        ckpt = CheckpointManager(os.path.join(exp, "checkpoints"))

        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        rc, text_a, wall_a = run_main_latent(args + ["--train.total_steps=3"])
        launches = read_counts()
        peak_a = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {"attention_d32": 3 * 12, "attention_cross_d32": 3 * 24,
                "temporal_attention": 3 * 12}
        got = {k: n for k, n in launches.items() if n}
        losses = _losses(text_a)
        log(f"[train] main_latent.main, 3 micro-steps (synthetic data "
            f"written in {write_ms:.0f} ms): rc {rc}, {wall_a:.1f} ms whole "
            f"(model build, data, steps, checkpoint), losses {losses}, peak "
            f"{peak_a:.2f} GiB, launches {got}; {card}")
        if rc != 0 or got != want or len(losses) != 3 or not all(
                math.isfinite(v) for v in losses):
            raise AssertionError(f"training run: rc {rc}, launches {got} "
                                 f"(want {want}), losses {losses}")
        model = build_model(cfg)
        model.init_weights_(torch.Generator().manual_seed(cfg.train.seed))
        init = {k: p.detach().clone() for k, p in model.named_parameters()}
        first = torch.load(os.path.join(ckpt.ckpt_dir, "ckpt_00000003.pt"),
                           map_location="cpu", weights_only=True)
        same = all(torch.equal(first["params"][k], v) for k, v in init.items())
        if not (first["step"] == 3 and first["opt_state"]["count"] == 1
                and same):
            raise AssertionError("after one update (at lr 0) the weights "
                                 "must equal their initial values")

        rc, text, wall_b = run_main_latent(args + ["--train.total_steps=5"])
        second = torch.load(os.path.join(ckpt.ckpt_dir, "ckpt_00000005.pt"),
                            map_location="cpu", weights_only=True)
        moved = sum(int((second["params"][k] != v).sum())
                    for k, v in init.items())
        ema_w = second["ema_params"]["final_layer.linear.weight"]
        ema_moved = sum(int((second["ema_params"][k] != v).sum())
                        for k, v in init.items())
        losses = _losses(text)
        log(f"[train] resumed: rc {rc}, {wall_b:.1f} ms, 'auto-resumed from "
            f"step 3' {'auto-resumed from step 3' in text}, losses {losses}; "
            f"after 2 updates {moved} of {sum(v.numel() for v in init.values())}"
            f" weights moved, EMA: {ema_moved} moved, final layer (zero at "
            f"init) |max| {float(ema_w.abs().max()):.3g}")
        if not (rc == 0 and "auto-resumed from step 3" in text
                and second["step"] == 5 and second["opt_state"]["count"] == 2
                and moved > 0 and float(ema_w.abs().max()) > 0
                and len(losses) == 2
                and all(math.isfinite(v) for v in losses)):
            raise AssertionError("the resumed run did not continue from its "
                                 "checkpoint, or nothing moved")

        # one micro-step, kernels against impl="plain", from one state: the
        # saved optimizer state (its update fires: mini-step 1 of 2) with
        # seeded random weights, as every comparison here uses (at flax's
        # initial weights the zero adaLN gates and final layer hide the
        # attentions from the loss). The plain attention keeps its
        # [48, 16, 512, 1374] fp32 scores for the backward pass, which at
        # 12 blocks passes 80 GB: both runs recompute every block in the
        # backward pass (remat_blocks = 12; the same values, bit for bit)
        model.to(dev)
        model.remat_blocks = len(model.blocks)
        weights = {k: v.detach().clone() for k, v in init_random_(
            build_model(cfg), seed=25).to(dev).named_parameters()}
        diffusion, batch, g, t, noise = train_inputs(cfg, data, dev)
        tx = make_optimizer(lr=cfg.train.lr,
                            warmup_steps=cfg.train.warmup_steps,
                            grad_clip=cfg.train.grad_clip,
                            grad_accum=cfg.train.grad_accum)
        ema_rate = cfg.train.ema_rate ** (1.0 / cfg.train.grad_accum)
        state = create_train_state(model, tx)
        step = make_train_step(model, diffusion, tx, ema_rate)
        runs = {}
        for impl in (None, "plain"):
            ckpt.restore(state, 5)
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(weights[k])
                    state.ema_params[k].copy_(weights[k])
            before = {k: p.detach().clone() for k, p in state.params.items()}
            loss, _, grads = loss_and_grads(model, diffusion, batch, t, noise,
                                            impl=impl)
            grads = torch.cat([v.flatten() for v in grads.values()])
            state, metrics = step(state, batch, g, t=t, noise=noise,
                                  impl=impl)
            params = torch.cat([p.detach().flatten()
                                for p in state.params.values()])
            update = params - torch.cat([v.flatten()
                                         for v in before.values()])
            runs[impl] = (float(loss), grads, params, update, metrics)
        (lk, gk, pk, uk, mk), (lp, gp, pp, up, _) = runs[None], runs["plain"]
        errs = {"loss": abs(lk - lp) / abs(lp), "grads": rel_l2(gk, gp),
                "params": rel_l2(pk, pp), "update": rel_l2(uk, up)}
        log(f"[train] one micro-step from the step-5 optimizer state (its "
            f"update fires) with random weights (remat_blocks 12), kernels vs "
            f"impl=\"plain\": loss {lk:.6g} vs {lp:.6g}, "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (bounds {TRAIN_BOUNDS}); grad_norm "
            f"{float(mk['grad_norm']):.4g}, |update| max "
            f"{float(uk.abs().max()):.3g}")
        if not (math.isfinite(lk) and all(errs[k] <= b
                                          for k, b in TRAIN_BOUNDS.items())):
            raise AssertionError("the training micro-step disagrees with "
                                 "its plain version")

        # the micro-step's device time, samples/s and peak memory: the
        # kernels at the configured remat_blocks, the plain version at 12
        times = {}
        for impl, n in ((None, 3), ("plain", 2)):
            model.remat_blocks = (cfg.model.remat_blocks if impl is None
                                  else len(model.blocks))
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = step(state, batch, g, impl=impl)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            times[impl] = (ms, torch.cuda.max_memory_allocated() / 2 ** 30)
        (ms_k, peak_k), (ms_p, peak_p) = times[None], times["plain"]
        step_ms = sum(ms_k[1:]) / len(ms_k[1:])
        log(f"[train] micro-step (batch {cfg.train.batch_size} x "
            f"{cfg.train.sample_timesteps} frames, fp32, remat_blocks "
            f"{cfg.model.remat_blocks}): {step_ms:.1f} ms with the kernels "
            f"(runs {', '.join(f'{v:.1f}' for v in ms_k)}), "
            f"{cfg.train.batch_size / step_ms * 1e3:.3f} samples/s, peak "
            f"{peak_k:.2f} GiB; impl=\"plain\" (remat_blocks 12) "
            f"{ms_p[-1]:.1f} ms, peak "
            f"{peak_p:.2f} GiB; main()'s logged step times "
            f"{_step_times(text_a)} s (data loading included); {card}")
        counts = {k: launches[k] for k in TRAIN_KERNELS}
        del model, state, step, weights
        torch.cuda.empty_cache()
        d64 = train_configs(work, data, dev, card)["dit-d64"]
        counts.update(temporal_attention_d64=d64["temporal_attention"],
                      train_attention_d64=d64["attention"],
                      train_attention_cross_d64=d64["attention_cross"])
        return counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


def train_inputs(cfg, data, dev):
    """(diffusion, batch, generator, t, noise) of a kernels-vs-plain
    micro-step: the config's diffusion, one batch of the synthetic dataset
    at `data`, two timesteps and noise from seeds."""
    import torch
    from gvfdiffusion_torch.data.dataset_latent import (LatentDataset,
                                                        load_data)
    from gvfdiffusion_torch.diffusion.gaussian_diffusion import (
        create_diffusion)

    diffusion = create_diffusion(
        schedule=cfg.diffusion.noise_schedule, steps=cfg.diffusion.steps,
        mean_type=cfg.diffusion.predict_type,
        rescale_timesteps=cfg.diffusion.rescale_timesteps).to(dev)
    dataset = LatentDataset(data, num_frames=cfg.train.sample_timesteps,
                            uncond_p=0.0, seed=22)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
        load_data(dataset, cfg.train.batch_size)).items()}
    g = torch.Generator(device=dev).manual_seed(23)
    t = torch.tensor([437, 12], device=dev)
    noise = torch.randn(batch["latent"].shape, generator=g, device=dev)
    return diffusion, batch, g, t, noise


def train_configs(work, data, dev, card):
    """main_latent.main at two of the DiT's other configurations, each a
    YAML written from configs/diffusion.yml with its fields changed: 3
    micro-steps on the synthetic dataset at `data` (fp32, batch 2 x 24,
    grad_accum 2), with their launches (checked), losses (finite), step
    times and peak memory. main()'s losses cannot tell the configurations
    apart: at flax's initial weights the zero final layer makes the output
    0 whatever the blocks do. So each configuration then takes one
    micro-step's loss and gradients on seeded random weights, kernels
    against impl="plain" (every block recomputed in the backward pass, as
    for the shipped one). Returns the launches of each run."""
    import torch
    from gvfdiffusion_torch.cli.main_latent import build_model
    from gvfdiffusion_torch.train.diffusion_trainer import loss_and_grads
    from gvfdiffusion_torch.utils.config import (load_config, read_yaml,
                                                 write_yaml)
    from gvfdiffusion_torch.utils.weights import init_random_

    out = {}
    for cfg, want in TRAIN_CONFIGS.items():
        conf = read_yaml(os.path.join(REPO, "configs", "diffusion.yml"))
        conf["model"].update(DIT_CONFIGS[cfg])
        path = os.path.join(work, f"{cfg}.yml")
        write_yaml(conf, path)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        rc, text, wall = run_main_latent([
            "--config", path, f"--data_dir={data}",
            f"--exp_dir={os.path.join(work, 'exp_' + cfg)}",
            "--train.log_interval=1", "--train.save_interval=1000000",
            "--train.total_steps=3"])
        launches = {k: n for k, n in read_counts().items() if n}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = _losses(text)
        log(f"[train] {cfg} {DIT_CONFIGS[cfg]}: main_latent.main, 3 "
            f"micro-steps: rc {rc}, {wall:.1f} ms whole, losses {losses}, "
            f"step times {_step_times(text)} s (the first with the warm-up; "
            f"data loading included), peak {peak:.2f} GiB, launches "
            f"{launches}; {card}")
        if rc != 0 or launches != want or len(losses) != 3 or not all(
                math.isfinite(v) for v in losses):
            raise AssertionError(f"{cfg} training run: rc {rc}, launches "
                                 f"{launches} (want {want}), losses {losses}")
        out[cfg] = launches

        conf = load_config(path)
        model = init_random_(build_model(conf), seed=25).to(dev)
        model.remat_blocks = len(model.blocks)
        diffusion, batch, _, t, noise = train_inputs(conf, data, dev)
        runs = {}
        for impl in (None, "plain"):
            loss, _, grads = loss_and_grads(model, diffusion, batch, t, noise,
                                            impl=impl)
            runs[impl] = float(loss), torch.cat(
                [v.flatten() for v in grads.values()])
        (lk, gk), (lp, gp) = runs[None], runs["plain"]
        errs = (abs(lk - lp) / abs(lp), rel_l2(gk, gp))
        bounds = CONFIG_TRAIN_BOUNDS[cfg]
        log(f"[train] {cfg}: one micro-step on random weights, kernels vs "
            f"impl=\"plain\": loss {lk:.6g} vs {lp:.6g} ({errs[0]:.3e}, "
            f"bound {bounds[0]:g}), gradients rel_l2 {errs[1]:.3e} (bound "
            f"{bounds[1]:g})")
        if not (math.isfinite(lk) and errs[0] <= bounds[0]
                and errs[1] <= bounds[1]):
            raise AssertionError(f"{cfg}'s micro-step disagrees with its "
                                 "plain version")
        del model, runs, gk, gp
        torch.cuda.empty_cache()
    return out



# [wide-heads]: K7 above 128 lanes (csrc/flash_attention_wide.cu: every
# kernel's lanes split over a cluster of CTAs, ops/_widths.py
# `wide_split`, each tile pair's scores formed once and summed through the
# cluster's shared memory) at the static VAE's full attention, 768
# channels in 4 heads of 192 and 1 of 768 (main_vae
# --static_vae.num_heads=4 / 1), and 1152 channels in 1 head of 1152
# (--static_vae.model_channels=1152 --static_vae.num_heads=1, past the old
# cap of 1024 lanes: 6 CTAs of 192): per dtype and width the forward with
# its residual, dkv and dq (vae_form_rows), and in fp32 the forward
# without its residual at one object's [1, 32768, 768 / D, D]
# (cli/encode_latent's form, encode_flash_check). The fp32 forms' launches
# come from main_vae's runs at those heads in [vae-train], the bf16 forms'
# from the static VAE built in bf16 there, the forward without its
# residual from the static VAE's encode in [wide-heads]
WIDE_FORMS = (("bfloat16", 192), ("bfloat16", 768), ("float32", 192),
              ("float32", 768), ("bfloat16", 1152), ("float32", 1152))
WIDE_HEADS = (4, 1)        # main_vae --static_vae.num_heads: heads of 192, 768
WIDE_CHANNELS = 1152       # --static_vae.model_channels in one head
WIDE_SRC = "gvfdiffusion_torch/csrc/flash_attention_wide.cu"
# the short check above one cluster's 3072 lanes: a head of 3136 (padded
# to 3328: 4 passes of clusters of 13 CTAs of 64 lanes) at [2, 1000, 1,
# 3136] against [2, 1000] keys, no path's shape
WIDE_PASSES_D, WIDE_PASSES_L = 3136, 1000


def form_heads(d: int) -> int:
    """The heads of width d at the static VAE's 768 channels, or 1 above
    them (--static_vae.model_channels=d --static_vae.num_heads=1)."""
    return max(1, VAE_C // d)


def _form_what(dt: str, d: int) -> str:
    return (f"{'bf16' if dt == 'bfloat16' else 'fp32'}, static VAE"
            + ("" if d <= VAE_C else f" at {d} channels")
            + f", {form_heads(d)} heads of {d}")


def _wide_kernels():
    out = []
    for dt, d in WIDE_FORMS:
        what = _form_what(dt, d)
        res, dkv, dq = vae_form_keys(dt, d)
        out += [(f"flash_attention[{what}: forward with residual]",
                 "gvfdiffusion_tpu/sparse/attention.py:57", WIDE_SRC, res),
                (f"flash_attention backward dkv[{what}]",
                 "jax/experimental/pallas/ops/tpu/flash_attention.py:796",
                 WIDE_SRC, dkv),
                (f"flash_attention backward dq[{what}]",
                 "jax/experimental/pallas/ops/tpu/flash_attention.py:1146",
                 WIDE_SRC, dq)]
    for h in WIDE_HEADS:
        d = VAE_C // h
        out.append((f"flash_attention[fp32, static VAE encode, one object, "
                    f"{h} heads of {d}]",
                    "gvfdiffusion_tpu/sparse/attention.py:57", WIDE_SRC,
                    f"flash_attention_fp32_d{d}"))
    for dt in ("bfloat16", "float32"):
        what = (f"{'bf16' if dt == 'bfloat16' else 'fp32'}, one head of "
                f"{WIDE_PASSES_D} in passes, [2, {WIDE_PASSES_L}] keys")
        res, dkv, dq = vae_form_keys(dt, WIDE_PASSES_D)
        out += [(f"flash_attention[{what}: forward with residual]",
                 "gvfdiffusion_tpu/sparse/attention.py:57", WIDE_SRC, res),
                (f"flash_attention backward dkv[{what}]",
                 "jax/experimental/pallas/ops/tpu/flash_attention.py:796",
                 WIDE_SRC, dkv),
                (f"flash_attention backward dq[{what}]",
                 "jax/experimental/pallas/ops/tpu/flash_attention.py:1146",
                 WIDE_SRC, dq)]
    return out


WIDE_KERNELS = _wide_kernels()
KERNELS += WIDE_KERNELS

# -- the VAE's training: K7's residual forward and backward, main_vae --------

VAE_B, VAE_H, VAE_D = 2, 12, 64  # configs/vae.yml: batch 2, 12 heads of 64
VAE_FLASH = ("flash_attention_fp32_res", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")
# K7's backward kernels vs the plain backward: fp32 both, so they differ by
# the order of their sums (and exp(s - lse) against exp(s - m) / l)
VAE_FLASH_BOUND = 1e-5
# the seeded training data: 2 frames of 8192 points, 2 views of 512^2 a
# frame; main_vae takes 2 frames a sample (train.sample_timesteps, cut from
# 24), so 4 renders a sample, and the motion VAE decodes 2 frames
VAE_FRAMES, VAE_VIEWS = 2, 2
# one phase-A step, kernels vs impl="plain", at 2 + 2 blocks (depth cut
# from 12 + 12: the plain attention takes ~1 s a call at 32768 slots): rel
# L2 of the loss and of the gradients
VAE_GRAD_BOUNDS = {"loss": 1e-5, "grads": 1e-4}
# main_vae in `full` attention at the static VAE's other head widths
# (--static_vae.num_heads: 24 heads of 32, 6 of 128; fp32 K7), 1 phase-A
# step each
VAE_HEADS = (24, 6)
# the encoder's and decoder's blocks of the main_vae runs at those heads
# and at WIDTH_VAE_HEADS (the shipped 12 + 12 run in `swin`)
VAE_HEAD_BLOCKS = 2
# ... and of the run in `full` attention at 12 heads, all rematerialized
# (the smoke's time limit; 4, 2 and 2 K7 launches a block)
VAE_FULL_BLOCKS = 2
# the static VAE in bf16 under autograd (dtype=bfloat16, `full`): one step
# at 2 + 2 blocks, kernels vs impl="plain", rel L2 of the loss and of the
# gradients (bf16 forward and backward on both sides, rounded at other
# places)
VAE_BF16_GRAD_BOUNDS = {"loss": 2e-4, "grads": 1e-2}  # 4.6e-5, 1.8e-3


def surface_shell(seed: int, radius: float, thickness: float = 2.0):
    """A seeded surface shell in a 64^3 grid (the voxel count of a trained
    TRELLIS structure at 64^3): [N, 3] int32 coords in linear-index order,
    a wobbly sphere around a random centre."""
    import numpy as np

    r = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(64)] * 3, indexing="ij"), -1)
    c = 31.5 + r.uniform(-2, 2, 3)
    d = g - c
    rad = np.linalg.norm(d, axis=-1)
    wobble = 1.5 * np.sin(3 * np.arctan2(d[..., 1], d[..., 0]))
    keep = np.abs(rad - radius - wobble) < thickness / 2
    return np.argwhere(keep).astype(np.int32)


def vae_valid(dev):
    """[2, 32768] key validity of two shells, each a prefix of its row (the
    dataset packs a sample's voxels first)."""
    import torch

    valid = torch.zeros(VAE_B, SLOTS, dtype=torch.bool, device=dev)
    for b, radius in enumerate((25.0, 22.0)):
        valid[b, :min(len(surface_shell(30 + b, radius)), SLOTS)] = True
    return valid


def flash_backward_fp64(q, k, v, valid, scale, do, rows, keys):
    """K7's gradient in fp64 on a slice: dq on the first `rows` query rows,
    dk and dv at key indices keys[b] of each batch row over every query
    row; over each row's valid keys alone (an invalid key's P is 0), in
    chunks of `rows` query rows."""
    import torch

    dq = []
    dk = [torch.zeros(len(kb), *k.shape[2:], dtype=torch.float64,
                      device=k.device) for kb in keys]
    dv = [torch.zeros_like(a) for a in dk]
    for b in range(q.shape[0]):
        idx = valid[b].nonzero()[:, 0]
        pos = torch.full((k.shape[1],), -1, dtype=torch.long, device=k.device)
        pos[idx] = torch.arange(len(idx), device=k.device)
        ok = pos[keys[b]] >= 0  # an invalid key's gradients are 0
        sel = pos[keys[b]][ok]
        kh, vh = (a[b, idx].double().transpose(0, 1) for a in (k, v))
        for i0 in range(0, q.shape[1], rows):
            qh, doh = (a[b, i0:i0 + rows].double().transpose(0, 1)
                       for a in (q, do))
            p = torch.softmax(qh @ kh.transpose(1, 2) * scale, -1)
            di = ((p @ vh) * doh).sum(-1, keepdim=True)
            if i0 == 0:
                ds = p * (doh @ vh.transpose(1, 2) - di) * scale
                dq.append((ds @ kh).transpose(0, 1))
                del ds
            p = p[..., sel]
            ds = p * (doh @ vh[:, sel].transpose(1, 2) - di) * scale
            dv[b][ok] += (p.transpose(1, 2) @ doh).transpose(0, 1)
            dk[b][ok] += (ds.transpose(1, 2) @ qh).transpose(0, 1)
            del p, ds
    return torch.stack(dq), dk, dv


def phase_vae_kernels(dev):
    """K7's fp32 forward with its residual and the dkv and dq kernels at the
    static VAE's `full` attention: [2, 32768, 12, 64] fp32, q/k/v the views
    of one [2, 32768, 3, 12, 64] projection as the VAE passes them, two
    seeded surface shells as the valid keys; against the plain forward and
    backward on every row, with SDPA (forward; its backward) under the
    boolean key mask as the library call."""
    import torch
    import torch.nn.functional as F
    from gvfdiffusion_torch.ops import flash_attention as fl

    g = torch.Generator(device=dev).manual_seed(31)
    qkv = torch.randn(VAE_B, SLOTS, 3, VAE_H, VAE_D, generator=g, device=dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(VAE_B, SLOTS, VAE_H, VAE_D, generator=g, device=dev)
    valid = vae_valid(dev)
    n_valid = [int(n) for n in valid.sum(1)]
    scale = VAE_D ** -0.5
    o, lse, tiles, vld = fl.launch_forward(q, k, v, valid, scale,
                                            residual=True)
    ptrs, sizes, keep = fl.backward_inputs(q, k, v, vld, tiles, lse, o, do)
    dk, dv = fl.launch_dkv(ptrs, sizes, scale, torch.float32)
    dq = fl.launch_dq(ptrs, sizes, scale, torch.float32)
    torch.cuda.synchronize()
    ref_o = fl.flash_attention_reference(q, k, v, valid, scale)
    ref = fl.flash_attention_backward_reference(q, k, v, valid, scale,
                                                ref_o, do)
    errs = {"o": rel_l2(o, ref_o), "dq": rel_l2(dq, ref[0]),
            "dk": rel_l2(dk, ref[1]), "dv": rel_l2(dv, ref[2])}
    maes = {"o": (o - ref_o).abs().max(), "dq": (dq - ref[0]).abs().max(),
            "dk": (dk - ref[1]).abs().max(), "dv": (dv - ref[2]).abs().max()}
    maes = {k_: float(m) for k_, m in maes.items()}
    finite = all(bool(torch.isfinite(t).all()) for t in (o, dq, dk, dv))
    # against fp64: dq on F64_ROWS query rows, dk and dv on the first two
    # listed key tiles of each batch row over every query row
    keys = [torch.cat([torch.arange(64 * int(t_), 64 * int(t_) + 64,
                                    device=dev) for t_ in tiles[b, 1:3]])
            for b in range(VAE_B)]
    dq64, dk64, dv64 = flash_backward_fp64(q, k, v, valid, scale, do,
                                           F64_ROWS, keys)
    def flat(ts):
        return torch.cat([t_.flatten() for t_ in ts])

    f64 = {"dq": (dq[:, :F64_ROWS], ref[0][:, :F64_ROWS], dq64)}
    for name, got, ref_, want in (("dk", dk, ref[1], dk64),
                                  ("dv", dv, ref[2], dv64)):
        f64[name] = tuple(flat([a[b, keys[b]] for b in range(VAE_B)])
                          for a in (got, ref_)) + (flat(want),)
    f64 = {name: (rel_l2_64(got, want), rel_l2_64(ref_, want))
           for name, (got, ref_, want) in f64.items()}
    del ref, dq64, dk64, dv64

    ms_fwd = time_ms(lambda: fl.launch_forward(q, k, v, valid, scale,
                                                residual=True), iters=3)
    ms_dkv = time_ms(lambda: fl.launch_dkv(ptrs, sizes, scale,
                                           torch.float32), iters=2)
    ms_dq = time_ms(lambda: fl.launch_dq(ptrs, sizes, scale, torch.float32),
                    iters=2)
    # the plain versions ran once above (their warm-up)
    plain_fwd = time_ms(lambda: fl.flash_attention_reference(
        q, k, v, valid, scale), iters=1, warm=0)
    plain_bwd = time_ms(lambda: fl.flash_attention_backward_reference(
        q, k, v, valid, scale, ref_o, do), iters=1, warm=0)
    mask = valid[:, None, None, :]
    t = [a.detach().transpose(1, 2).requires_grad_(True) for a in (q, k, v)]
    try:
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            *t, attn_mask=mask).detach(), iters=3)
        lib_o = F.scaled_dot_product_attention(*t, attn_mask=mask)
        lib_err = rel_l2(lib_o.detach().transpose(1, 2), ref_o)
        gdo = do.transpose(1, 2)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lib_o, t, gdo, retain_graph=True), iters=2)
        del lib_o
        lib_note = f"sdpa fwd {lib_fwd:.3f} ms bwd {lib_bwd:.3f} ms"
    except torch.OutOfMemoryError:
        lib_fwd = lib_bwd = lib_err = None
        lib_note = "sdpa does not fit"
    del t
    torch.cuda.empty_cache()

    # bounds: operations over this run's valid keys, each fp32 product as
    # three tf32 products (3xTF32, as the kernels compute it); the
    # backward's also at the fp32 FFMA peak, printed beside
    qk = sum(VAE_H * SLOTS * n * VAE_D for n in n_valid)
    visited = int(tiles[:, 0].sum())
    b_fwd = bound(3 * 4 * qk, nbytes(q, k, v, valid, o, lse), PEAK_TF32)
    moved_dkv = nbytes(q, k, v, valid, lse, do, dk, dv)
    moved_dq = nbytes(q, k, v, valid, lse, do, dq)
    b_dkv = bound(3 * 8 * qk, moved_dkv, PEAK_TF32)
    b_dq = bound(3 * 6 * qk, moved_dq, PEAK_TF32)
    f_dkv = bound(8 * qk, moved_dkv, PEAK_FP32)
    f_dq = bound(6 * qk, moved_dq, PEAK_FP32)
    b_all = bound(3 * 10 * qk, nbytes(q, k, v, valid, o, do, dq, dk, dv),
                  PEAK_TF32)
    log(f"[vae-kernels] K7 at the static VAE's full attention: q/k/v "
        f"{tuple(q.shape)} fp32 (views of a qkv projection), valid keys "
        f"{n_valid} of {SLOTS} (surface shells, prefixes), {visited} of "
        f"{VAE_B * SLOTS // 64} key tiles visited; rel_l2 "
        + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items())
        + f" (bound {VAE_FLASH_BOUND:g}); max_abs_err {maes}")
    log(f"[vae-kernels] backward against fp64 (dq on the first {F64_ROWS} "
        "query rows, dk and dv on each batch row's first two listed key "
        "tiles over every query row): kernels "
        + ", ".join(f"{k_} {a:.3e}" for k_, (a, _) in f64.items())
        + "; plain fp32 "
        + ", ".join(f"{k_} {b_:.3e}" for k_, (_, b_) in f64.items()))
    log(f"[vae-kernels] forward with residual {ms_fwd:.3f} ms (plain "
        f"{plain_fwd:.3f} ms, bound {b_fwd[0]:.4f} ms, {b_fwd[1]}); dkv "
        f"{ms_dkv:.3f} ms (bound {b_dkv[0]:.4f} ms 3xTF32, "
        f"{f_dkv[0]:.4f} fp32 FFMA), dq {ms_dq:.3f} ms (bound "
        f"{b_dq[0]:.4f} ms 3xTF32, {f_dq[0]:.4f} fp32 FFMA), backward "
        f"together {ms_dkv + ms_dq:.3f} ms against the whole gradient's "
        f"bound {b_all[0]:.4f} ms (10 B H Lq Nv D, 3xTF32 at 495 TFLOP/s); "
        f"plain backward {plain_bwd:.3f} ms; {lib_note}"
        + (f" (its rel_l2 {lib_err:.3e})" if lib_err is not None else ""))
    if not (finite and all(e <= VAE_FLASH_BOUND for e in errs.values())):
        raise AssertionError(f"K7's residual forward or backward disagrees "
                             f"with its plain version: {errs}")
    del keep
    rows = {"flash_attention_fp32_res": (maes["o"], ms_fwd, plain_fwd, b_fwd,
                                         lib_fwd),
            "flash_attention_bwd_dkv": (max(maes["dk"], maes["dv"]), ms_dkv,
                                        plain_bwd, b_dkv, lib_bwd),
            "flash_attention_bwd_dq": (maes["dq"], ms_dq, plain_bwd, b_dq,
                                       lib_bwd)}
    out = {}
    for name, replaces, source, key in KERNELS:
        if key in rows:
            mae, ms, plain_ms, (b_ms, b_by), lib_ms = rows[key]
            out[key] = dict(name=name, route="cuda", source=source,
                            replaces=replaces, max_abs_err=mae, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lib_ms)
    return out


# [vae-forms]: each new form's kernels vs the plain forward and backward,
# rel L2 of o, dq, dk and dv: fp32 as at heads of 64 (VAE_FLASH_BOUND;
# readings 9.6e-7-3.0e-6); bf16, where both round P and dS to bf16 from
# fp32 values that differ in their last bits, VAE_BF16_BOUND (readings
# 4.9e-4-2.5e-3, the output's the largest)
VAE_BF16_BOUND = 1e-2


def phase_vae_forms(dev, card):
    """[vae-forms]: K7's forward with its residual and the dkv and dq
    kernels in each form of VAE_FORMS (vae_form_rows). Returns (the
    kernels-line rows of the forms, the bf16 forms' launches from their
    drive: no path of the system builds the static VAE in bf16; the fp32
    forms' count comes from main_vae's runs in [vae-train])."""
    t0 = time.perf_counter()
    rows, drive = vae_form_rows(dev, card, VAE_FORMS, "[vae-forms]")
    log(f"[vae-forms] phase in {time.perf_counter() - t0:.1f} s")
    bf16 = {k for dt, d in VAE_FORMS if dt == "bfloat16"
            for k in vae_form_keys(dt, d)}
    return rows, {k: n for k, n in drive.items() if k in bf16}


def vae_form_rows(dev, card, forms, tag, iters=(3, 2)):
    """K7's forward with its residual and the dkv and dq kernels in each
    (dtype, head width) of `forms` at the static VAE's full attention, [2,
    32768, 768 / D, D], q/k/v the views of one projection, the two surface
    shells of vae_valid as the valid keys; against the plain forward and
    backward on every row (fp32 also against fp64 on F64_ROWS query rows
    and the first two listed key tiles of each batch row), with SDPA under
    the boolean key mask (forward; its backward) as the library call. Each
    form is first driven once through flash_attention under grad with the
    counts at 0, read just after. A head width the kernels are not built
    at runs as the wrapper runs it: q, k, v and dO zero-padded to the card
    width (ops/_widths.py), the pads inside the timed calls, o and the
    gradients cut back to D; its bound counts the true D. `iters`: the
    timed calls of the forward and of each backward kernel (after 2
    warm-ups). Returns (the kernels-line rows, every form's launches from
    its drive)."""
    import torch
    import torch.nn.functional as F
    from gvfdiffusion_torch.ops import flash_attention as fl
    from gvfdiffusion_torch.ops._widths import (flash_card_width, pad_heads,
                                                wide_split)

    valid = vae_valid(dev)
    n_valid = [int(n) for n in valid.sum(1)]
    entries = {e[3]: e for e in KERNELS}
    rows, drive = {}, {}
    for dt_name, D in forms:
        dtype, H, scale = getattr(torch, dt_name), form_heads(D), D ** -0.5
        qk_units = sum(SLOTS * n * H * D for n in n_valid)  # B H Lq Nv D
        W = flash_card_width(D)
        pad = lambda *ts: [pad_heads(t_, W) for t_ in ts]  # noqa: E731
        f32 = dtype == torch.float32
        keys = vae_form_keys(dt_name, D)
        if keys != tuple(fl.grad_key(kind, dtype, D)
                         for kind in fl.GRAD_KINDS):
            raise AssertionError(f"the counters of {dt_name} d{D}: {keys}")
        g = torch.Generator(device=dev).manual_seed(31 + D)
        qkv = torch.randn(VAE_B, SLOTS, 3, H, D, generator=g,
                          device=dev).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.randn(VAE_B, SLOTS, H, D, generator=g,
                         device=dev).to(dtype)
        what = f"{tag} {dt_name} {H} heads of {D}" + (
            "" if W == D else f" (padded to {W})")
        # the drive: once through the wrapper under grad
        leaf = qkv.detach().clone().requires_grad_(True)
        torch.cuda.synchronize()
        fl.reset_launch_counts()
        fl.flash_attention(leaf[:, :, 0], leaf[:, :, 1], leaf[:, :, 2],
                           valid, scale).backward(do)
        torch.cuda.synchronize()
        counts = {k_: n for k_, n in fl.launch_counts.items() if n}
        if counts != {k_: 1 for k_ in keys}:
            raise AssertionError(f"{what}: launches {counts}")
        drive.update(counts)
        del leaf
        # the kernels, then the plain versions, on the same inputs
        qp, kp, vp, dop = pad(q, k, v, do)
        o, lse, tiles, vld = fl.launch_forward(qp, kp, vp, valid, scale,
                                                residual=True, width=D)
        ptrs, sizes, keep = fl.backward_inputs(qp, kp, vp, vld, tiles, lse,
                                               o, dop)
        dk, dv = fl.launch_dkv(ptrs, sizes, scale, dtype, D)
        dq = fl.launch_dq(ptrs, sizes, scale, dtype, D)
        torch.cuda.synchronize()
        o, dq, dk, dv = (t_[..., :D] for t_ in (o, dq, dk, dv))
        # the plain versions, timed in this one call each (CUDA events)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        ref_o = fl.flash_attention_reference(q, k, v, valid, scale)
        ev[1].record()
        ref = fl.flash_attention_backward_reference(q, k, v, valid, scale,
                                                    ref_o, do)
        ev[2].record()
        torch.cuda.synchronize()
        plain_fwd, plain_bwd = (ev[0].elapsed_time(ev[1]),
                                ev[1].elapsed_time(ev[2]))
        got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
        want = {"o": ref_o, "dq": ref[0], "dk": ref[1], "dv": ref[2]}
        errs = {n: rel_l2(got[n], want[n]) for n in got}
        maes = {n: float((got[n].float() - want[n].float()).abs().max())
                for n in got}
        finite = all(bool(torch.isfinite(t_).all()) for t_ in got.values())
        f64_note = ""
        if f32:
            # against fp64: dq on F64_ROWS query rows, dk and dv on the
            # first two listed key tiles of each batch row
            lt = fl.key_tile(dtype, D)
            kidx = [torch.cat([torch.arange(lt * int(t_), lt * int(t_) + lt,
                                            device=dev)
                               for t_ in tiles[b, 1:3]])
                    for b in range(VAE_B)]
            dq64, dk64, dv64 = flash_backward_fp64(q, k, v, valid, scale, do,
                                                   F64_ROWS, kidx)

            def flat(ts):
                return torch.cat([t_.flatten() for t_ in ts])

            f64 = {"dq": (dq[:, :F64_ROWS], ref[0][:, :F64_ROWS], dq64)}
            for n, a_, r_, w_ in (("dk", dk, ref[1], dk64),
                                  ("dv", dv, ref[2], dv64)):
                f64[n] = tuple(flat([x_[b, kidx[b]] for b in range(VAE_B)])
                               for x_ in (a_, r_)) + (flat(w_),)
            f64_note = ("; against fp64 (dq on the first "
                        f"{F64_ROWS} query rows, dk and dv on two listed "
                        f"{lt}-key tiles a batch row): kernels " + ", ".join(
                            f"{n} {rel_l2_64(a_, w_):.3e}"
                            for n, (a_, _, w_) in f64.items())
                        + ", plain fp32 " + ", ".join(
                            f"{n} {rel_l2_64(r_, w_):.3e}"
                            for n, (_, r_, w_) in f64.items()))
            del dq64, dk64, dv64, f64
        del ref
        ms_fwd = time_ms(lambda: fl.launch_forward(
            *pad(q, k, v), valid, scale, residual=True, width=D),
            iters=iters[0])
        ms_dkv = time_ms(lambda: (pad(do), fl.launch_dkv(
            ptrs, sizes, scale, dtype, D)), iters=iters[1])
        ms_dq = time_ms(lambda: fl.launch_dq(ptrs, sizes, scale, dtype, D)[
            ..., :D].contiguous(), iters=iters[1])
        mask = valid[:, None, None, :]
        t = [a.detach().transpose(1, 2).requires_grad_(True)
             for a in (q, k, v)]
        try:
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                *t, attn_mask=mask).detach(), iters=2, warm=1)
            lib_o = F.scaled_dot_product_attention(*t, attn_mask=mask)
            lib_bwd = time_ms(lambda: torch.autograd.grad(
                lib_o, t, do.transpose(1, 2), retain_graph=True), iters=2,
                warm=1)
            del lib_o
            lib_note = f"sdpa fwd {lib_fwd:.3f} ms bwd {lib_bwd:.3f} ms"
        except torch.OutOfMemoryError:
            lib_fwd = lib_bwd = None
            lib_note = "sdpa does not fit"
        del t
        # bounds over this run's valid keys: bf16 at the tensor cores' bf16
        # peak, fp32 as three tf32 products (3xTF32, as the kernels run it)
        ops, peak = (3, PEAK_TF32) if f32 else (1, PEAK_FLOPS)
        b_fwd = bound(ops * 4 * qk_units, nbytes(q, k, v, valid, o, lse),
                      peak)
        b_dkv = bound(ops * 8 * qk_units,
                      nbytes(q, k, v, valid, lse, do, dk, dv), peak)
        b_dq = bound(ops * 6 * qk_units, nbytes(q, k, v, valid, lse, do, dq),
                     peak)
        lim = VAE_FLASH_BOUND if f32 else VAE_BF16_BOUND
        visited = int(tiles[:, 0].sum())
        log(f"{what}: q/k/v {tuple(q.shape)} (views of a qkv projection), "
            f"valid keys {n_valid}, {visited} of "
            f"{VAE_B * -(-SLOTS // fl.key_tile(dtype, D))} "
            f"{fl.key_tile(dtype, D)}-key tiles listed; kernels vs plain "
            "rel_l2 " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (bound {lim:g}); max_abs_err "
            + ", ".join(f"{n} {m:.3g}" for n, m in maes.items()) + f64_note)
        split = ""
        if W > 128:
            lanes, n_cta = wide_split(W)
            split = (f"; forward and backward in clusters of {n_cta} CTA(s) "
                     f"of {lanes} lanes, S (and dP) formed once a tile "
                     f"pair; forward against SDPA's "
                     + (f"{lib_fwd:.3f} ms" if lib_fwd is not None
                        else "(does not fit)") + "; dkv + dq "
                     f"{ms_dkv + ms_dq:.3f} ms against SDPA's backward "
                     + (f"{lib_bwd:.3f} ms" if lib_bwd is not None
                        else "(does not fit)"))
        log(f"{what}: forward with residual {ms_fwd:.3f} ms (plain "
            f"{plain_fwd:.3f} ms, bound {b_fwd[0]:.4f} ms, {b_fwd[1]}); dkv "
            f"{ms_dkv:.3f} ms (bound {b_dkv[0]:.4f} ms), dq {ms_dq:.3f} ms "
            f"(bound {b_dq[0]:.4f} ms); plain backward {plain_bwd:.3f} ms; "
            f"{lib_note}{split}; {card}")
        if not (finite and all(e <= lim for e in errs.values())):
            raise AssertionError(f"{what}: the kernels disagree with their "
                                 f"plain versions: {errs}")
        del keep, got, want
        for key, mae, ms, plain_ms, (b_ms, b_by), lib_ms in (
                (keys[0], maes["o"], ms_fwd, plain_fwd, b_fwd, lib_fwd),
                (keys[1], max(maes["dk"], maes["dv"]), ms_dkv, plain_bwd,
                 b_dkv, lib_bwd),
                (keys[2], maes["dq"], ms_dq, plain_bwd, b_dq, lib_bwd)):
            name, replaces, source, _ = entries[key]
            rows[key] = dict(name=name, route="cuda", source=source,
                             replaces=replaces, max_abs_err=mae, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms)
        del q, k, v, qkv, do, o, lse, tiles, vld, dq, dk, dv, ref_o
        del qp, kp, vp, dop
        torch.cuda.empty_cache()
    return rows, drive


def write_vae_dataset(root: str, objects: int, seed: int) -> int:
    """Seeded objects in VAEDataset's layout at vae.yml's sizes: 8192
    points (static_frame_vertices.pt) moving over VAE_FRAMES frames
    (moving_frame_deltas.pt), a surface shell of DINOv2-width features at
    64^3 (voxel_features.npz: 1024 channels), VAE_VIEWS orbit views of
    512^2 a frame (cameras.json, uint8 .npy images). Returns the voxel
    count of the largest object."""
    import numpy as np
    import torch
    from gvfdiffusion_torch.representations.camera import orbit_camera

    r = np.random.default_rng(seed)
    most = 0
    for o in range(objects):
        d = os.path.join(root, f"obj{o}")
        os.makedirs(d)
        coords = surface_shell(30 + o, (25.0, 22.0)[o % 2])
        most = max(most, len(coords))
        pts = (coords[r.choice(len(coords), 8192)] + r.uniform(0, 1, (8192, 3))
               ) / 64.0 - 0.5
        torch.save(torch.from_numpy(pts.astype(np.float32)),
                   os.path.join(d, "static_frame_vertices.pt"))
        deltas = 0.02 * r.standard_normal((VAE_FRAMES, 8192, 3))
        torch.save(torch.from_numpy(deltas.astype(np.float32)),
                   os.path.join(d, "moving_frame_deltas.pt"))
        np.savez(os.path.join(d, "voxel_features.npz"), coords=coords,
                 features=r.standard_normal((len(coords), 1024)).astype(
                     np.float32), resolution=64)
        cams = {}
        for t in range(VAE_FRAMES):
            views = []
            for v in range(VAE_VIEWS):
                name = f"img_{t}_{v}.npy"
                np.save(os.path.join(d, name),
                        r.integers(0, 256, (512, 512, 3), dtype=np.uint8))
                # the dataset's OpenGL camera-to-world of an orbit view
                cam = orbit_camera(360.0 * v / VAE_VIEWS + 30 * t, 20.0,
                                   radius=1.2)
                c2w = np.linalg.inv(cam.world_view.numpy().astype(np.float64))
                c2w[:3, 1:3] *= -1
                views.append({"image": name, "c2w": c2w.tolist(),
                              "intrinsics": cam.intrinsics.tolist()})
            cams[str(t)] = views
        with open(os.path.join(d, "cameras.json"), "w") as f:
            json.dump(cams, f)
    return most


def write_lpips_npz(path: str, seed: int) -> None:
    """Seeded VGG16 + lin weights in the flat layout of JAX's
    `ops/lpips.convert_torch_lpips` (vgg/conv{j}/kernel, lin{i}); the heads
    non-negative, as the released ones are."""
    import torch
    from gvfdiffusion_torch.models.registry import save_params_npz
    from gvfdiffusion_torch.ops.lpips import LPIPS
    from gvfdiffusion_torch.utils.weights import (init_random_, lpips_table,
                                                  to_flax)

    model = init_random_(LPIPS(), seed=seed)
    with torch.no_grad():
        for i in range(5):
            w = getattr(model, f"lin{i}").model["1"].weight
            w.copy_(w.abs())
    save_params_npz(to_flax(lpips_table(), model.state_dict())["params"], path)


def _vae_steps(text):
    """main_vae's logged steps: [(step, phase, {term: value}, launches)]."""
    import re

    out = []
    for m in re.finditer(r"\[main_vae\] step (\d+) phase (\w) (.*) launches "
                         r"(\{.*\})", text):
        fields = m.group(3).replace(" s peak_gib", " peak_gib").split()
        terms = {fields[i]: float(fields[i + 1])
                 for i in range(0, len(fields) - 1, 2)}
        out.append((int(m.group(1)), m.group(2), terms,
                    json.loads(m.group(4))))
    return out


def start_main_vae(args, work: str, tag: str):
    """`python -m gvfdiffusion_torch.cli.main_vae args` started in a process
    of its own (its device memory is freed when it ends), its stdout and
    stderr into files of `work` named by `tag`; finish_main_vae waits."""
    outs = [open(os.path.join(work, f"main_vae_{tag}.{k}"), "w")
            for k in ("out", "err")]
    p = subprocess.Popen([sys.executable, "-m",
                          "gvfdiffusion_torch.cli.main_vae", *args],
                         cwd=REPO, stdout=outs[0], stderr=outs[1], text=True)
    return p, outs, time.perf_counter()


def finish_main_vae(started):
    """Wait for a start_main_vae process -> (rc, its stderr, wall ms)."""
    p, outs, t0 = started
    rc = p.wait()
    wall = (time.perf_counter() - t0) * 1e3
    text = []
    for f in outs:
        f.close()
        with open(f.name) as r:
            text.append(r.read())
    if rc != 0:
        log(text[0][-4000:] + text[1][-4000:])
    # the logger's messages, each step's line among them, are on stderr
    return rc, text[1], wall


def run_main_vae(args, work: str, card: str):
    """main_vae in a process of its own, waited for -> (rc, log, wall
    ms)."""
    return finish_main_vae(start_main_vae(args, work, "run"))


def phase_vae_train(dev, card):
    """The VAE's training main path: `python -m
    gvfdiffusion_torch.cli.main_vae --config configs/vae.yml` at full width
    (static VAE 768 channels, 12 + 12 blocks, 12 heads of 64, 32768 voxel
    slots, 112 channels; motion VAE depth 12, dim 768, 8192 points, 512
    latents; 512^2 binned renders, 256 per tile; LPIPS on) over a seeded
    dataset in VAEDataset's layout, every block rematerialized and 2
    frames a sample (train.sample_timesteps): in the shipped `swin`, 1
    phase-A and 1 phase-B step (no K7 launch), and in `full` attention at
    VAE_FULL_BLOCKS + VAE_FULL_BLOCKS blocks, the same (K7's residual
    forward, dkv and dq launches counted from this run's log). Then one
    phase-A step at 2 + 2 blocks
    (full attention, random weights) with the kernels and with
    impl="plain": loss and gradients. Then main_vae in `full` attention
    with --static_vae.num_heads at 24 and 6 (fp32 K7 at heads of 32 and
    128), at 8 (heads of 96, padded to 128), at 4 and 1 (WIDE_HEADS:
    heads of 192 and 768, K7 above 128 lanes) and with
    --static_vae.model_channels=1152 in one head (WIDE_CHANNELS: 1152
    lanes, past the old cap of 1024), at VAE_HEAD_BLOCKS + VAE_HEAD_BLOCKS
    blocks, 1 phase-A step each, the six processes at once (their step
    times, taken on a shared card, not printed), its
    launches a step checked against the heads-of-64 run's per block; and
    the static
    VAE built in bf16 (SparseTransformerVAE(dtype=
    bfloat16), `full`, 768 channels) under autograd: one step at 12 + 12
    blocks with the kernels (K7's bf16 backward, launches counted), then at
    2 + 2 blocks kernels vs impl="plain"; then the bf16 static VAE at
    WIDE_HEADS heads and at 1152 channels in one head, one step each at
    VAE_HEAD_BLOCKS + VAE_HEAD_BLOCKS blocks with the kernels, launches
    counted, gradients finite. Returns the launches of the whole `full`
    run, of the runs at 24, 6, 8, 4 and 1 heads and at 1152 channels and
    of the bf16 steps at 4 and 1 heads and at 1152 channels."""
    import re
    import shutil
    import tempfile

    import torch
    from gvfdiffusion_torch.cli.main_vae import build_static_vae, to_device
    from gvfdiffusion_torch.data.dataset_vae import VAEDataset, load_data
    from gvfdiffusion_torch.models.static_vae import SparseTransformerVAE
    from gvfdiffusion_torch.ops.lpips import load_lpips
    from gvfdiffusion_torch.render.renderer import RenderOptions
    from gvfdiffusion_torch.train.train_state import make_optimizer
    from gvfdiffusion_torch.train.vae_trainer import make_static_vae_step
    from gvfdiffusion_torch.utils.config import load_config
    from gvfdiffusion_torch.utils.weights import init_random_

    work = tempfile.mkdtemp(prefix="gvf_vae_smoke_")
    try:
        data, lpips = os.path.join(work, "data"), os.path.join(work, "lp.npz")
        t0 = time.perf_counter()
        voxels = write_vae_dataset(data, objects=2, seed=41)
        write_lpips_npz(lpips, seed=42)
        write_ms = (time.perf_counter() - t0) * 1e3
        config = os.path.join(REPO, "configs", "vae.yml")
        common = ["--config", config, f"--data_dir={data}",
                  f"--loss.lpips_weights={lpips}",
                  "--static_vae.remat_blocks=12",
                  f"--train.sample_timesteps={VAE_FRAMES}",
                  "--train.log_interval=1", "--train.save_interval=1000000"]
        runs = {}
        # `full` at VAE_FULL_BLOCKS + VAE_FULL_BLOCKS blocks and both at
        # 1 + 1 steps, so that the whole smoke keeps to its time limit;
        # every step launches the same
        nf = VAE_FULL_BLOCKS
        depth = {"full": [a for a in common if "remat_blocks" not in a] + [
            f"--static_vae.num_blocks={nf}",
            f"--static_vae.remat_blocks={nf}"], "swin": common}
        for mode, a, b in (("full", 1, 1), ("swin", 1, 1)):
            blocks = nf if mode == "full" else 12
            rc, text, wall = run_main_vae(
                depth[mode] + [f"--exp_dir={os.path.join(work, mode)}",
                          f"--static_vae.attn_mode={mode}",
                          f"--train.static_vae_steps={a}",
                          f"--train.total_steps={a + b}"], work, card)
            steps = _vae_steps(text)
            runs[mode] = steps
            per = {ph: [s[2]["step_time"] for s in steps if s[1] == ph]
                   for ph in "AB"}
            peaks = {ph: max(s[2]["peak_gib"] for s in steps if s[1] == ph)
                     for ph in "AB" if per[ph]}
            losses = [s[2]["loss"] for s in steps]
            launches = [s[3] for s in steps]
            log(f"[vae-train] main_vae {mode} ({blocks} + {blocks} blocks, "
                f"remat_blocks {blocks}, batch 2 x "
                f"{VAE_FRAMES * VAE_VIEWS} views of 512^2, {voxels} voxels "
                f"of 32768 at most; data written in {write_ms:.0f} ms): rc "
                f"{rc}, {wall:.1f} ms whole; step times (s) phase A "
                f"{per['A']}, phase B {per['B']}; peak GiB {peaks}; losses "
                f"{losses}; launches per step {launches}; {card}")
            for s in steps:
                log(f"[vae-train]   step {s[0]} phase {s[1]}: "
                    + ", ".join(f"{k} {v:.6g}" for k, v in s[2].items()))
            want = {"flash_attention_fp32_res": 4 * nf,
                    "flash_attention_bwd_dkv": 2 * nf,
                    "flash_attention_bwd_dq": 2 * nf} if mode == "full" \
                else {}
            done = re.search(r"\[main_vae\] done; launches (\{.*\})", text)
            total = json.loads(done.group(1)) if done else None
            if rc != 0 or len(steps) != a + b or any(
                    not math.isfinite(x) for x in losses) or any(
                    n != want for n in launches) or total != {
                        k: n * (a + b) for k, n in want.items()}:
                raise AssertionError(f"main_vae {mode}: rc {rc}, {len(steps)}"
                                     f" steps, losses {losses}, launches "
                                     f"{launches} (want {want} a step), "
                                     f"in all {total}")
            if mode == "full":
                totals = {k: total.get(k, 0) for k in VAE_FLASH}

        # `full` at 24 heads of 32 and 6 of 128: fp32 K7's other forms,
        # at 8 heads of 96 ([widths]: K7 padded to 128) and at 4 and 1
        # ([wide-heads]: heads of 192 and 768), the launches a
        # block as at 12 heads (4 residual forwards, 2 dkv, 2 dq, every
        # block rematerialized), at VAE_HEAD_BLOCKS + VAE_HEAD_BLOCKS
        # blocks (the smoke's time limit)
        nb = VAE_HEAD_BLOCKS
        shallow = [a for a in common if "remat_blocks" not in a] + [
            f"--static_vae.num_blocks={nb}", f"--static_vae.remat_blocks={nb}"]
        # the six runs at once (with the three above 128 lanes, WIDE_HEADS
        # and one head at WIDE_CHANNELS channels), each in its own process
        # (~10 GiB each): they share the card and the host, so their step
        # times are not those of a run alone and are not printed (each
        # peak is its own process's)
        n_steps = 1
        heads_runs = [(VAE_C, h) for h in VAE_HEADS + (WIDTH_VAE_HEADS,)
                      + WIDE_HEADS] + [(WIDE_CHANNELS, 1)]
        started = {(ch, heads): start_main_vae(
            shallow + [f"--exp_dir={os.path.join(work, f'c{ch}h{heads}')}",
                       "--static_vae.attn_mode=full",
                       f"--static_vae.model_channels={ch}",
                       f"--static_vae.num_heads={heads}",
                       f"--train.static_vae_steps={n_steps}",
                       f"--train.total_steps={n_steps}"], work,
            f"c{ch}h{heads}")
            for ch, heads in heads_runs}
        for (ch, heads), run in started.items():
            keys = vae_form_keys("float32", ch // heads)
            rc, text, wall = finish_main_vae(run)
            steps = _vae_steps(text)
            peak = max((s_[2]["peak_gib"] for s_ in steps), default=None)
            losses = [s_[2]["loss"] for s_ in steps]
            launches = [s_[3] for s_ in steps]
            want = dict(zip(keys, (4 * nb, 2 * nb, 2 * nb)))
            done = re.search(r"\[main_vae\] done; launches (\{.*\})", text)
            total = json.loads(done.group(1)) if done else None
            log(f"[vae-train] main_vae full at {ch} channels in {heads} "
                f"heads of {ch // heads} (fp32, {nb} + {nb} blocks, "
                f"remat_blocks {nb}; run at once with (channels, heads) "
                f"{heads_runs}, so no time is printed): rc {rc}; "
                f"peak GiB {peak}; losses {losses}; launches per step "
                f"{launches}; {card}")
            if rc != 0 or [s_[1] for s_ in steps] != ["A"] * n_steps or any(
                    not math.isfinite(x) for x in losses) or any(
                    n != want for n in launches) or total != {
                        k: n_steps * n for k, n in want.items()}:
                raise AssertionError(f"main_vae at {ch} channels, {heads} "
                                     f"heads: rc {rc}, steps {steps}, "
                                     f"launches {launches} (want {want} a "
                                     f"step), in all {total}")
            totals.update(total)

        # one phase-A step at 2 + 2 blocks, kernels vs impl="plain"
        cfg = load_config(config, ["--static_vae.num_blocks=2",
                                   "--static_vae.attn_mode=full"])
        sv = cfg.static_vae
        vae = init_random_(build_static_vae(cfg), seed=43).to(dev)
        dataset = VAEDataset(data, resolution=sv.resolution,
                             num_points=cfg.motion_vae.num_inputs,
                             num_timesteps=VAE_FRAMES,
                             voxel_capacity=sv.voxel_capacity)
        batch = to_device(next(load_data(dataset, cfg.train.batch_size)), dev)
        r = cfg.render
        step = make_static_vae_step(
            vae, make_optimizer(), render_options=RenderOptions(
                near=r.near, far=r.far, bg_color=tuple(r.bg_color),
                use_mip=r.use_mip, kernel_size_2d=r.kernel_size_2d,
                max_per_tile=r.max_per_tile),
            lpips_fn=load_lpips(lpips, dev))
        g = torch.Generator(device=dev).manual_seed(44)
        noise = torch.randn(batch["feats"].feats.shape[:2]
                            + (sv.latent_channels,), generator=g, device=dev)
        res = {}
        for impl in (None, "plain"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            terms, _, grads = step.loss_and_grads(batch, noise=noise,
                                                  impl=impl)
            torch.cuda.synchronize()
            res[impl] = (float(terms["loss"]),
                         torch.cat([x.flatten() for x in grads.values()]),
                         (time.perf_counter() - t0) * 1e3)
        (lk, gk, mk), (lp, gp, mp) = res[None], res["plain"]
        errs = {"loss": abs(lk - lp) / abs(lp), "grads": rel_l2(gk, gp)}
        log(f"[vae-train] one phase-A step at 2 + 2 blocks (full attention, "
            f"random weights, LPIPS on), kernels vs impl=\"plain\": loss "
            f"{lk:.6g} vs {lp:.6g}, " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items())
            + f" (bounds {VAE_GRAD_BOUNDS}); {mk:.1f} ms with the kernels, "
            f"{mp:.1f} ms plain; {card}")
        if not (math.isfinite(lk) and all(errs[k] <= b
                                          for k, b in VAE_GRAD_BOUNDS.items())):
            raise AssertionError("the VAE step disagrees with its plain "
                                 "version")
        del vae, step, res, gk, gp
        torch.cuda.empty_cache()

        # the static VAE in bf16 under autograd: 12 + 12 blocks with the
        # kernels, then 2 + 2 blocks kernels vs impl="plain"
        from gvfdiffusion_torch.ops import flash_attention as fl

        def bf16_step(blocks, seed, heads=sv.num_heads,
                      channels=sv.model_channels):
            model = init_random_(SparseTransformerVAE(
                resolution=sv.resolution, in_channels=sv.in_channels,
                model_channels=channels,
                out_channels=sv.out_channels,
                latent_channels=sv.latent_channels, num_blocks=blocks,
                num_heads=heads, window_size=sv.window_size,
                attn_mode="full", norm_output=sv.norm_output,
                remat_blocks=12, dtype=torch.bfloat16), seed=seed).to(dev)
            return make_static_vae_step(
                model, make_optimizer(), render_options=RenderOptions(
                    near=r.near, far=r.far, bg_color=tuple(r.bg_color),
                    use_mip=r.use_mip, kernel_size_2d=r.kernel_size_2d,
                    max_per_tile=r.max_per_tile),
                lpips_fn=load_lpips(lpips, dev))

        step = bf16_step(12, 46)
        keys = vae_form_keys("bfloat16", VAE_D)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fl.reset_launch_counts()
        t0 = time.perf_counter()
        terms, _, grads = step.loss_and_grads(batch, noise=noise)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: n for k, n in fl.launch_counts.items() if n}
        loss = float(terms["loss"])
        finite = math.isfinite(loss) and all(
            bool(torch.isfinite(x).all()) for x in grads.values())
        log(f"[vae-train] static VAE in bf16 under autograd (full, 768 "
            f"channels, 12 + 12 blocks, remat_blocks 12, random weights): "
            f"one step {ms:.1f} ms, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, loss "
            f"{loss:.6g}, gradients finite {finite}, launches {counts}; "
            f"{card}")
        if not finite or counts != dict(zip(keys, (48, 24, 24))):
            raise AssertionError(f"the bf16 static VAE's step: loss {loss}, "
                                 f"finite {finite}, launches {counts}")
        del step, terms, grads
        torch.cuda.empty_cache()
        step = bf16_step(2, 47)
        res = {}
        for impl in (None, "plain"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            terms, _, grads = step.loss_and_grads(batch, noise=noise,
                                                  impl=impl)
            torch.cuda.synchronize()
            res[impl] = (float(terms["loss"]),
                         torch.cat([x.flatten() for x in grads.values()]),
                         (time.perf_counter() - t0) * 1e3)
        (lk, gk, mk), (lp, gp, mp) = res[None], res["plain"]
        errs = {"loss": abs(lk - lp) / abs(lp), "grads": rel_l2(gk, gp)}
        log(f"[vae-train] bf16 static VAE, one phase-A step at 2 + 2 blocks, "
            f"kernels vs impl=\"plain\": loss {lk:.6g} vs {lp:.6g}, "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (bounds {VAE_BF16_GRAD_BOUNDS}); {mk:.1f} ms with the "
            f"kernels, {mp:.1f} ms plain; {card}")
        if not (math.isfinite(lk) and all(
                errs[k] <= b for k, b in VAE_BF16_GRAD_BOUNDS.items())):
            raise AssertionError("the bf16 VAE step disagrees with its plain "
                                 "version")
        del step, res, gk, gp
        torch.cuda.empty_cache()

        # K7 above 128 lanes in bf16: the static VAE built in bf16 at
        # WIDE_HEADS heads (heads of 192 and 768) and at WIDE_CHANNELS
        # channels in one head, one step each at nb + nb blocks with the
        # kernels
        for ch, heads in [(VAE_C, h) for h in WIDE_HEADS] + [
                (WIDE_CHANNELS, 1)]:
            step = bf16_step(nb, 48 + heads, heads, ch)
            keys = vae_form_keys("bfloat16", ch // heads)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fl.reset_launch_counts()
            t0 = time.perf_counter()
            terms, _, grads = step.loss_and_grads(batch, noise=noise)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = {k: n for k, n in fl.launch_counts.items() if n}
            loss = float(terms["loss"])
            finite = math.isfinite(loss) and all(
                bool(torch.isfinite(x).all()) for x in grads.values())
            log(f"[vae-train] static VAE in bf16 under autograd at {heads} "
                f"heads of {ch // heads} (full, {ch} channels, {nb} + {nb} "
                f"blocks, remat_blocks 12, random weights): one step "
                f"{ms:.1f} ms, peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, loss "
                f"{loss:.6g}, gradients finite {finite}, launches {counts}; "
                f"{card}")
            if not finite or counts != dict(zip(keys, (4 * nb, 2 * nb,
                                                       2 * nb))):
                raise AssertionError(f"the bf16 static VAE's step at {ch} "
                                     f"channels, {heads} heads: loss {loss}, "
                                     f"finite {finite}, launches {counts}")
            totals.update(counts)
            del step, terms, grads
            torch.cuda.empty_cache()
        return totals
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- [wide-heads]: K7 above 128 lanes ----------------------------------------

# the drive of the fp32 forward without its residual: the static VAE of
# configs/vae.yml at WIDE_HEADS heads, fp32, `full`, at WIDE_ENCODE_BLOCKS
# + WIDE_ENCODE_BLOCKS blocks (depth cut from 12 + 12), encode and decode of
# one object (cli/encode_latent's calls): one launch a block
WIDE_ENCODE_BLOCKS = 2


def wide_encode_drive(dev, card):
    """The static VAE's encode and decode of one seeded object (a surface
    shell of vae_valid's first row, 1024-channel features) under no_grad,
    as cli/encode_latent calls them, at WIDE_HEADS heads: K7's fp32 forward
    without its residual at heads of 192 and 768, counted with the
    counters at 0; the output finite. Returns its launches."""
    import numpy as np
    import torch
    from gvfdiffusion_torch.cli.main_vae import build_static_vae
    from gvfdiffusion_torch.ops import flash_attention as fl
    from gvfdiffusion_torch.sparse.tensor import from_lists
    from gvfdiffusion_torch.utils.config import load_config
    from gvfdiffusion_torch.utils.weights import init_random_

    coords = surface_shell(30, 25.0)[:SLOTS]
    feats = np.random.default_rng(57).standard_normal(
        (len(coords), 1024)).astype(np.float32)
    sv = from_lists([coords], [feats], 64, capacity=SLOTS)
    x = sv.replace(feats=sv.feats.to(dev), coords=sv.coords.to(dev),
                   valid=sv.valid.to(dev))
    nb = WIDE_ENCODE_BLOCKS
    launches = {}
    for heads in WIDE_HEADS:
        cfg = load_config(os.path.join(REPO, "configs", "vae.yml"), [
            f"--static_vae.num_blocks={nb}", f"--static_vae.num_heads={heads}",
            "--static_vae.attn_mode=full"])
        vae = init_random_(build_static_vae(cfg), seed=58).to(dev)
        key = f"flash_attention_fp32_d{VAE_C // heads}"
        torch.cuda.synchronize()
        fl.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            z, _, _ = vae.encode(x)
            out = vae.decode(z)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: n for k, n in fl.launch_counts.items() if n}
        finite = bool(torch.isfinite(out.feats[out.valid]).all())
        log(f"[wide-heads] static VAE encode + decode of one object ({nb} + "
            f"{nb} blocks, {heads} heads of {VAE_C // heads}, fp32, full, "
            f"{len(coords)} voxels of {SLOTS}, random weights): {ms:.1f} ms, "
            f"output finite {finite}, launches {counts}; {card}")
        if not finite or counts != {key: 2 * nb}:
            raise AssertionError(f"the static VAE's encode at {heads} heads: "
                                 f"finite {finite}, launches {counts}")
        launches.update(counts)
        del vae, z, out
        torch.cuda.empty_cache()
    return launches


def wide_passes_check(dev, card):
    """K7 above one cluster's 3072 lanes: a head of WIDE_PASSES_D (padded
    to 3328, 4 passes of clusters of 13 CTAs of 64 lanes), [2, 1000, 1, D]
    against 1000 keys (a prefix of 613, scattered keys at 0.2), in bf16
    and fp32: the residual forward, dkv and dq driven once through the
    wrapper under grad with the counters at 0 (one launch each), then the
    forward without its residual; against the plain forward and backward
    (VAE_FLASH_BOUND, VAE_BF16_BOUND); then each kernel timed (10 calls
    after 2 warm-ups) beside its plain version, SDPA and the bound over
    the valid keys. Returns (the kernels-line rows, the drive's
    launches)."""
    import torch
    import torch.nn.functional as F
    from gvfdiffusion_torch.ops import flash_attention as fl
    from gvfdiffusion_torch.ops._widths import (flash_card_width, pad_heads,
                                                wide_passes, wide_split)

    D, L = WIDE_PASSES_D, WIDE_PASSES_L
    W, scale = flash_card_width(D), D ** -0.5
    (lanes, n), passes = wide_split(W), wide_passes(W)
    entries = {e[3]: e[:3] for e in WIDE_KERNELS}
    g = torch.Generator(device=dev).manual_seed(61)
    valid = torch.zeros(2, L, dtype=torch.bool, device=dev)
    valid[0, :613] = True
    valid[1] = torch.rand(L, generator=g, device=dev) < 0.2
    qk_units = sum(L * int(x) * D for x in valid.sum(1))  # B H Lq Nv D
    rows, drive = {}, {}
    for dt_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dt_name)
        f32 = dtype == torch.float32
        q, k, v, do = (torch.randn(2, L, 1, D, generator=g,
                                   device=dev).to(dtype) for _ in range(4))
        leaves = [t_.clone().requires_grad_(True) for t_ in (q, k, v)]
        torch.cuda.synchronize()
        fl.reset_launch_counts()
        o = fl.flash_attention(*leaves, valid, scale)
        o.backward(do)
        torch.cuda.synchronize()
        counts = {k_: c for k_, c in fl.launch_counts.items() if c}
        keys = tuple(fl.grad_key(kind, dtype, D) for kind in fl.GRAD_KINDS)
        drive.update(counts)
        y = fl.flash_attention(q, k, v, valid, scale)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        ref_o = fl.flash_attention_reference(q, k, v, valid, scale)
        ev[1].record()
        ref = fl.flash_attention_backward_reference(q, k, v, valid, scale,
                                                    ref_o, do)
        ev[2].record()
        torch.cuda.synchronize()
        plain_fwd, plain_bwd = (ev[0].elapsed_time(ev[1]),
                                ev[1].elapsed_time(ev[2]))
        got = {"o": o.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad,
               "dv": leaves[2].grad, "o without residual": y}
        want = {"o": ref_o, "dq": ref[0], "dk": ref[1], "dv": ref[2],
                "o without residual": ref_o}
        errs = {k_: rel_l2(got[k_], want[k_]) for k_ in got}
        maes = {k_: float((got[k_].float() - want[k_].float()).abs().max())
                for k_ in got}
        finite = all(bool(torch.isfinite(t_).all()) for t_ in got.values())
        lim = VAE_FLASH_BOUND if f32 else VAE_BF16_BOUND
        # the kernels alone at the card width, as the wrapper calls them
        qp, kp, vp, dop = (pad_heads(t_, W) for t_ in (q, k, v, do))
        o_, lse, tiles, vld = fl.launch_forward(qp, kp, vp, valid, scale,
                                                residual=True, width=D)
        ptrs, sizes, keep = fl.backward_inputs(qp, kp, vp, vld, tiles, lse,
                                               o_, dop)
        ms_fwd = time_ms(lambda: fl.launch_forward(
            qp, kp, vp, valid, scale, residual=True, width=D))
        ms_dkv = time_ms(lambda: fl.launch_dkv(ptrs, sizes, scale, dtype, D))
        ms_dq = time_ms(lambda: fl.launch_dq(ptrs, sizes, scale, dtype, D))
        t = [a.detach().transpose(1, 2).requires_grad_(True)
             for a in (q, k, v)]
        mask = valid[:, None, None, :]
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            *t, attn_mask=mask).detach(), iters=2, warm=1)
        lib_o = F.scaled_dot_product_attention(*t, attn_mask=mask)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lib_o, t, do.transpose(1, 2), retain_graph=True), iters=2,
            warm=1)
        ops, peak = (3, PEAK_TF32) if f32 else (1, PEAK_FLOPS)
        b_fwd = bound(ops * 4 * qk_units, nbytes(q, k, v, valid, y, lse),
                      peak)
        b_dkv = bound(ops * 8 * qk_units, nbytes(q, k, v, valid, lse, do,
                                                 ref[1], ref[2]), peak)
        b_dq = bound(ops * 6 * qk_units, nbytes(q, k, v, valid, lse, do,
                                                ref[0]), peak)
        log(f"[wide-heads] {dt_name} one head of {D} (padded to {W}: "
            f"{passes} passes of clusters of {n} CTAs of {lanes} lanes), "
            f"[2, {L}, 1, {D}] against {[int(x) for x in valid.sum(1)]} "
            f"valid keys: launches under grad {counts}; kernels vs plain "
            "rel_l2 " + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items())
            + f" (bound {lim:g}); forward with residual {ms_fwd:.3f} ms "
            f"(plain {plain_fwd:.3f}, SDPA {lib_fwd:.3f}, bound "
            f"{b_fwd[0]:.4f}), dkv {ms_dkv:.3f} ms (bound {b_dkv[0]:.4f}), "
            f"dq {ms_dq:.3f} ms (bound {b_dq[0]:.4f}); plain backward "
            f"{plain_bwd:.3f} ms, SDPA's {lib_bwd:.3f}; {card}")
        if counts != dict.fromkeys(keys, 1) or not finite or any(
                e > lim for e in errs.values()):
            raise AssertionError(f"K7 at a head of {D}: launches {counts}, "
                                 f"finite {finite}, errors {errs}")
        for key, mae, ms, plain_ms, (b_ms, b_by), lib_ms in (
                (keys[0], maes["o"], ms_fwd, plain_fwd, b_fwd, lib_fwd),
                (keys[1], max(maes["dk"], maes["dv"]), ms_dkv, plain_bwd,
                 b_dkv, lib_bwd),
                (keys[2], maes["dq"], ms_dq, plain_bwd, b_dq, lib_bwd)):
            name, replaces, source = entries[key]
            rows[key] = dict(name=name, route="cuda", source=source,
                             replaces=replaces, max_abs_err=mae, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms)
        del q, k, v, do, leaves, o, y, ref_o, ref, got, want, lib_o, t
        del qp, kp, vp, dop, o_, lse, tiles, vld, keep
        torch.cuda.empty_cache()
    return rows, drive


def phase_wide_heads(dev, card):
    """[wide-heads]: K7 above 128 lanes (csrc/flash_attention_wide.cu). Each
    form of WIDE_FORMS, the forward with its residual, dkv and dq in bf16
    and fp32 at heads of 192, 768 and 1152, at the static VAE's [2, 32768,
    768 / D, D] ([2, 32768, 1, 1152] at 1152 channels) on vae_valid's
    shells, driven once under grad with the counters
    at 0, then against the plain forward and backward (fp32 also against
    fp64), timed (10 calls after 2 warm-ups) beside SDPA's forward and
    backward under the boolean key mask (vae_form_rows); the fp32 forward
    without its residual at one object's [1, 32768, 768 / D, D] against
    its plain version (encode_flash_check), then driven through the static
    VAE's encode and decode (wide_encode_drive); then the short check above
    3072 lanes (wide_passes_check). main_vae at those heads (and at 1152
    channels) runs in [vae-train]. Returns (the kernels-line rows, the
    launches of the forward without its residual and of the check above
    3072 lanes)."""
    t0 = time.perf_counter()
    rows, _ = vae_form_rows(dev, card, WIDE_FORMS, "[wide-heads]",
                            iters=(10, 10))
    entries = {e[3]: e[:3] for e in WIDE_KERNELS}
    for heads in WIDE_HEADS:
        key = f"flash_attention_fp32_d{VAE_C // heads}"
        rows[key] = encode_flash_check(dev, *entries[key], heads=heads,
                                       d=VAE_C // heads, tag="[wide-heads]")
    launches = wide_encode_drive(dev, card)
    passes_rows, passes_launches = wide_passes_check(dev, card)
    rows.update(passes_rows)
    launches.update(passes_launches)
    log(f"[wide-heads] phase in {time.perf_counter() - t0:.1f} s")
    return rows, launches


# -- the latent encoding between the two trainers: cli/encode_latent ---------

ENCODE_FLASH = "flash_attention_encode"
ENCODE_ITEMS = 2
# K7's launches a item: the static VAE's 12 encoder and 12 decoder blocks
ENCODE_K7_PER_ITEM = 24
ENCODE_LATENT_SHAPE = (VAE_FRAMES, N, 16)   # [T, num_latents, latent_dim]


def encode_flash_check(dev, name, replaces, source, heads=VAE_H, d=VAE_D,
                       tag="[encode-latent]"):
    """K7's fp32 forward without the residual at the shape the static VAE
    gives it when cli/encode_latent runs it one object at a time in `full`
    attention: [1, 32768, 12, 64] (or `heads` of `d`), q/k/v the views of
    one [1, 32768, 3, heads, d] projection, one seeded surface shell's keys
    valid as a prefix; against the plain version on every row, with SDPA
    under the boolean key mask as the library call. Returns the kernels
    line's entry."""
    import torch
    import torch.nn.functional as F
    from gvfdiffusion_torch.ops import flash_attention as fl

    g = torch.Generator(device=dev).manual_seed(55)
    qkv = torch.randn(1, SLOTS, 3, heads, d, generator=g, device=dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    valid = vae_valid(dev)[:1]
    n_valid = int(valid.sum())
    scale = d ** -0.5
    y = fl.flash_attention(q, k, v, valid, scale)
    torch.cuda.synchronize()
    ref = fl.flash_attention(q, k, v, valid, scale, impl="plain")
    err = rel_l2(y, ref)
    mae = float((y - ref).abs().max())
    mask = valid[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask)
    lib_err = rel_l2(sdpa().transpose(1, 2), ref)
    ms = time_ms(lambda: fl.flash_attention(q, k, v, valid, scale))
    plain_ms = time_ms(lambda: fl.flash_attention(q, k, v, valid, scale,
                                                  impl="plain"), iters=1)
    lib_ms = time_ms(sdpa, iters=3)
    tile = fl.key_tile(torch.float32, d)
    tiles = int(valid.view(1, -1, tile).any(-1).sum())
    flops = 4 * SLOTS * n_valid * heads * d  # valid keys only
    # three tf32 products for each fp32 one (3xTF32)
    b_ms, b_by = bound(3 * flops, nbytes(q, k, v, valid, y), PEAK_TF32)
    log(f"{tag} {name}: q/k/v {tuple(q.shape)} fp32 (views of a "
        f"qkv projection), {n_valid} of {SLOTS} keys valid (a surface "
        f"shell, prefix), {tiles} of {SLOTS // tile} {tile}-key tiles "
        f"visited; max_abs_err {mae:.4g} rel_l2 {err:.3e} (bound "
        f"{FLASH_F32_BOUND:g}) kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
        f"TFLOP/s) plain {plain_ms:.3f} ms sdpa (boolean key mask) "
        f"{lib_ms:.3f} ms (its rel_l2 {lib_err:.3e}) bound {b_ms:.4f} ms "
        f"({b_by}, 3xTF32)")
    if not (bool(torch.isfinite(y).all()) and err <= FLASH_F32_BOUND):
        raise AssertionError(f"{name} disagrees with its plain version")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=mae, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def _encoded_items(text):
    """encode_latent's item lines: [(name, {stage: ms}, launches)]."""
    import re

    out = []
    for m in re.finditer(r"\[encode_latent\] (\S+): latent .*?; (.*?); "
                         r"launches (\{.*\})", text):
        ms = {k: float(v) for k, v in re.findall(r"(\w+) ([\d.]+) ms",
                                                 m.group(2))}
        out.append((m.group(1), ms, json.loads(m.group(3))))
    return out


def check_encoded(out_dir, names):
    """Every object's deformation_latent.pt: the six arrays at their
    shapes, finite, std > 0. Returns {name: {key: tensor}}."""
    import torch

    want = {"latent_mean": ENCODE_LATENT_SHAPE,
            "latent_std": ENCODE_LATENT_SHAPE,
            "fps_sampled_gs_1024": (1024, 14),
            "fps_sampled_gs_4096": (4096, 14),
            "static_gs_feats": (SLOTS, 1024), "static_gs_coords": (SLOTS, 3)}
    got = {}
    for name in names:
        d = torch.load(os.path.join(out_dir, name, "deformation_latent.pt"),
                       weights_only=True)
        shapes = {k: tuple(t_.shape) for k, t_ in d.items()}
        ok = (shapes == want
              and all(bool(torch.isfinite(t_.float()).all())
                      for t_ in d.values())
              and bool((d["latent_std"] > 0).all())
              and float(d["latent_mean"].std()) > 0)
        if not ok:
            raise AssertionError(f"[encode-latent] {name}: written {shapes}"
                                 f", want {want}, finite and std > 0")
        got[name] = d
    return got


def phase_encode_latent(dev, card):
    """The step between the two trainers, through the entry points users
    call: a seeded dataset in VAEDataset's layout (write_vae_dataset);
    configs/vae.yml's static VAE at `attn_mode=full` and motion VAE at full
    width on seeded weights (init_random_), built by main_vae's builders and
    saved as trainer checkpoints; cli/encode_latent.main over the objects
    (the static VAE's encode and decode one object at a time: K7 fp32 at
    [1, 32768, 12, 64], 24 launches an object; its launches counted in this
    run), and again with --debug (the latents equal); then
    cli/main_latent.main for 2 micro-steps on the written latents (with
    seeded DINOv2 features beside them) through the prefetcher, losses
    finite. K7 at that shape against its plain version first. Returns
    (the kernels line's entry, its launches in the encode run)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from gvfdiffusion_torch.cli import encode_latent, main_latent
    from gvfdiffusion_torch.cli.main_vae import (build_motion_vae,
                                                 build_static_vae)
    from gvfdiffusion_torch.train.train_state import (create_train_state,
                                                      make_optimizer)
    from gvfdiffusion_torch.utils.checkpoint import CheckpointManager
    from gvfdiffusion_torch.utils.config import load_config
    from gvfdiffusion_torch.utils.weights import init_random_

    t_phase = time.perf_counter()
    name, replaces, source, _ = next(e for e in KERNELS
                                     if e[3] == ENCODE_FLASH)
    entry = encode_flash_check(dev, name, replaces, source)
    work = tempfile.mkdtemp(prefix="gvf_encode_smoke_")
    try:
        data = os.path.join(work, "data")
        t0 = time.perf_counter()
        voxels = write_vae_dataset(data, objects=ENCODE_ITEMS, seed=51)
        data_ms = (time.perf_counter() - t0) * 1e3
        config = os.path.join(REPO, "configs", "vae.yml")
        cfg = load_config(config, ["--static_vae.attn_mode=full"])
        t0 = time.perf_counter()
        for model, what, seed in ((build_static_vae(cfg), "static", 52),
                                  (build_motion_vae(cfg), "motion", 53)):
            state = create_train_state(init_random_(model, seed=seed),
                                       make_optimizer(lr=0.0))
            CheckpointManager(os.path.join(work, what)).save(state, 0)
            del state, model
        ckpt_ms = (time.perf_counter() - t0) * 1e3
        names = sorted(os.listdir(data))
        common = ["--config", config, f"--data_dir={data}",
                  "--static_vae.attn_mode=full",
                  f"--static_ckpt={os.path.join(work, 'static')}",
                  f"--motion_ckpt={os.path.join(work, 'motion')}"]
        runs = {}
        for debug in (False, True):
            out = os.path.join(work, "debug" if debug else "latents")
            torch.cuda.reset_peak_memory_stats()
            rc, text, launches, wall = run_cli(
                encode_latent.main,
                common + [f"--output_dir={out}"] + ["--debug"] * debug)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            items = _encoded_items(text)
            tag = "--debug" if debug else "main path"
            log(f"[encode-latent] encode_latent.main ({tag}; static VAE "
                f"12 + 12 blocks of 768 at attn_mode=full, motion VAE 12 x "
                f"768; {voxels} voxels of {SLOTS} at most, data written in "
                f"{data_ms:.0f} ms, checkpoints in {ckpt_ms:.0f} ms): rc "
                f"{rc}, {wall:.1f} ms whole (models restored, "
                f"{len(items)} objects), peak {peak:.2f} GiB, launches "
                f"{launches}; {card}")
            for item, ms, n in items:
                log(f"[encode-latent]   {item}: "
                    + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
                    + f"; K7 launches {n}")
            if debug:
                for line in text.splitlines():
                    if "delta-xyz" in line:
                        log(f"[encode-latent]   {line.strip()}")
            want = {"flash_attention_fp32": ENCODE_K7_PER_ITEM}
            if rc != 0 or [i[0] for i in items] != names or any(
                    n != want for *_, n in items) or launches != {
                        "flash_attention_fp32":
                            ENCODE_K7_PER_ITEM * len(names)}:
                raise AssertionError(f"[encode-latent] rc {rc}, objects "
                                     f"{[i[0] for i in items]} (want {names})"
                                     f", launches {launches} (want {want} "
                                     "an object)")
            if debug and text.count("delta-xyz ms") != len(names):
                raise AssertionError("[encode-latent] --debug logged no "
                                     "delta-xyz line")
            runs[debug] = check_encoded(out, names)
            if not debug:
                main_launches = launches["flash_attention_fp32"]
        d0 = runs[False][names[0]]
        same = all(torch.equal(runs[False][n][k], runs[True][n][k])
                   for n in names for k in runs[False][n])
        log(f"[encode-latent] written per object: "
            + ", ".join(f"{k} {list(t_.shape)}" for k, t_ in d0.items())
            + f"; latent_mean std {float(d0['latent_mean'].std()):.4g}, "
            f"latent_std mean {float(d0['latent_std'].mean()):.4g}; the "
            f"--debug run's files equal the main path's: {same}")
        if not same:
            raise AssertionError("[encode-latent] the two runs disagree")

        # the DiT's trainer on the written latents
        r = np.random.default_rng(54)
        latents = os.path.join(work, "latents")
        for n in names:
            np.savez(os.path.join(latents, n, "dinov2_features.npz"),
                     features=r.standard_normal((VAE_FRAMES, L_IMG, 1024),
                                                dtype=np.float32))
        exp = os.path.join(work, "dit")
        rc, text, launches, wall = run_cli(main_latent.main, [
            "--config", os.path.join(REPO, "configs", "diffusion.yml"),
            f"--data_dir={latents}", f"--exp_dir={exp}",
            "--train.total_steps=2", "--train.log_interval=1",
            "--train.save_interval=1000000"])
        losses = _losses(text)
        log(f"[encode-latent] main_latent.main on the written latents (12 x "
            f"512 DiT, batch 2 x {VAE_FRAMES} frames, the prefetcher's side "
            f"stream), 2 micro-steps: rc {rc}, {wall:.1f} ms whole, losses "
            f"{losses}, step times {_step_times(text)} s, launches "
            f"{launches}; {card}")
        if rc != 0 or len(losses) != 2 or not all(math.isfinite(x)
                                                   for x in losses):
            raise AssertionError(f"[encode-latent] main_latent rc {rc}, "
                                 f"losses {losses}")
        log(f"[encode-latent] phase in {time.perf_counter() - t_phase:.1f} s")
        return entry, main_launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def build_models(dev):
    import torch
    from gvfdiffusion_torch.models.dinov2 import DinoV2
    from gvfdiffusion_torch.models.dit import DiT
    from gvfdiffusion_torch.models.motion_vae import MotionVAE
    from gvfdiffusion_torch.utils.weights import init_random_

    dino = init_random_(DinoV2(dtype=torch.bfloat16), seed=10).to(dev).eval()
    dit = init_random_(DiT(dtype=torch.bfloat16), seed=0).to(dev).eval()
    vae = init_random_(MotionVAE(dtype=torch.bfloat16), seed=1).to(dev).eval()
    return dino, dit, vae


def seeded_frames():
    """32 video frames [518, 518, 3] uint8, from a seed."""
    import numpy as np

    return (np.random.default_rng(9).uniform(size=(T, 518, 518, 3))
            * 255).astype(np.uint8)


def phase_dinov2(dino, dev, card):
    """The full ViT-L/14-reg forward over 32 frames, kernels vs plain, and
    the host's share of encode_video: normalizing the 32 frames."""
    import torch
    from gvfdiffusion_torch.models.dinov2 import encode_image
    from gvfdiffusion_torch.scripts.process_video import normalize_frame

    g = torch.Generator(device=dev).manual_seed(11)
    images = torch.rand(T, 518, 518, 3, generator=g, device=dev)
    tokens = encode_image(dino, images)
    torch.cuda.synchronize()
    ref = encode_image(dino, images, impl="plain")
    err = rel_l2(tokens, ref)
    ms = time_ms(lambda: encode_image(dino, images), iters=3)
    plain_ms = time_ms(lambda: encode_image(dino, images, impl="plain"),
                       iters=1)
    t0 = time.perf_counter()
    for f in seeded_frames():
        normalize_frame(f)
    host_ms = (time.perf_counter() - t0) * 1e3
    log(f"[dinov2] ViT-L/14-reg 24x1024, 16 heads of 64, 518^2, {T} frames: "
        f"tokens {tuple(tokens.shape)} kernels vs plain rel_l2 {err:.3e} "
        f"(bound {DINO_REL_BOUND:g}), max_abs_err "
        f"{float((tokens - ref).abs().max()):.4g}; encode_image {ms:.1f} ms, "
        f"plain {plain_ms:.1f} ms; normalize_frame of the {T} seeded frames "
        f"on the host {host_ms:.1f} ms; {card}")
    if tuple(tokens.shape) != (T, L_IMG, 1024) or not (
            bool(torch.isfinite(tokens).all()) and err <= DINO_REL_BOUND):
        raise AssertionError("DINOv2 disagrees with its plain version")


def phase_dit(dit, dev, what="12x512"):
    """One full DiT forward on a hoisted cache, kernels vs impl="plain"."""
    import torch

    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(B, T, N, 16, generator=g, device=dev)
    t = torch.tensor([500.0], device=dev)
    ci = torch.randn(B, T, L_IMG, 1024, generator=g, device=dev)
    st = torch.randn(B, N, 14, generator=g, device=dev)
    pos = torch.rand(B, N, 3, generator=g, device=dev) - 0.5
    with torch.no_grad():
        kv = dit(x, t, ci, st, pos, kv_only=True)
        y = dit(x, t, positions=pos, cross_kv=kv)
        ref = dit(x, t, positions=pos, cross_kv=kv, impl="plain")
    torch.cuda.synchronize()
    err = rel_l2(y, ref)
    log(f"[dit] {what} forward [1, 32, 512, 16]: kernels vs plain rel_l2 "
        f"{err:.3e} (bound {DIT_REL_BOUND:g}), max_abs_err "
        f"{float((y - ref).abs().max()):.4g}, |ref| mean "
        f"{float(ref.abs().mean()):.4g}")
    if not (bool(torch.isfinite(y).all()) and err <= DIT_REL_BOUND):
        raise AssertionError("DiT forward disagrees with its plain version")


def config_launches(cfg, steps, quant):
    """The launches one run() of `cfg` must make: the fused sublayers per
    block and step, or for dit-rope (composed on the cache) K5's self and
    two cross forms; no temporal sublayer without temporal attention."""
    n = 12 * steps
    if cfg == "dit-rope":
        return {"attention_d32": n, "attention_cross_d32": 2 * n}
    q8 = "_q8" if quant else ""
    want = {"self" + q8: n, "temporal" + q8: n, "cross" + q8: n, "mlp": n}
    if DIT_CONFIGS[cfg].get("no_temporal_attn"):
        del want["temporal" + q8]
    return want


def phase_dit_configs(vae, ci, dev, card):
    """The DiT's other configurations at full width (12 x 512, seeded
    random weights), each through VideoTo4DPipeline.run on the frames'
    tokens and the canonical splat: its DiT forward against impl="plain"
    (DIT_REL_BOUND); run() on the float cache and on the int8 cache (with
    int8 QK), timed, its launches counted and checked, its stages one by
    one (which must give what run() gave); the int8 run against the float
    run. Returns the launches of each new kernel form, read from the run of
    the configuration that sends it."""
    import torch
    from gvfdiffusion_torch.models.dit import DiT
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)
    from gvfdiffusion_torch.utils.weights import init_random_

    gs, valid = canonical_splat(dev)
    counts = {}
    for cfg, fields in DIT_CONFIGS.items():
        t0 = time.perf_counter()
        dit = init_random_(DiT(dtype=torch.bfloat16, **fields),
                           seed=30).to(dev).eval()
        build_ms = (time.perf_counter() - t0) * 1e3
        phase_dit(dit, dev, f"{cfg} {fields}")
        steps = CONFIG_STEPS[cfg]
        VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=2, order=2)).run(
            gs, valid, ci, generator=torch.Generator(device=dev).manual_seed(
                4))  # warm-up
        outs = {}
        for quant in (None, "int8"):
            pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(
                steps=steps, order=2, kv_quant=quant, self_quant=quant))
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            g = torch.Generator(device=dev).manual_seed(5)
            out = pipe.run(gs, valid, ci, generator=g)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = {k: n for k, n in read_counts().items() if n}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            check_outputs(out, B, T, G)
            staged, st = run_stages(pipe, gs, valid, ci, seed=5)
            mode = "int8 cache + int8 QK" if quant else "float cache"
            log(f"[dit-config] {cfg} ({mode}, guidance 1.0/1.0, {steps} "
                f"steps, G={G}): run() {wall_ms:.1f} ms, stages " + ", ".join(
                    f"{k} {v:.1f} ms" for k, v in st.items())
                + f"; peak {peak:.2f} GiB; launches {launches}; DiT built in "
                f"{build_ms:.0f} ms; {card}")
            check_same(out, staged, f"{cfg}, {mode}")
            want = config_launches(cfg, steps, quant)
            if launches != want:
                raise AssertionError(f"{cfg} {mode}: launches {launches}, "
                                     f"expected {want}")
            outs[quant] = out
            for key, (run_cfg, run_quant, counter) in FORM_RUNS.items():
                if run_cfg == cfg and run_quant == quant:
                    counts[key] = launches[counter]
        bounds = CONFIG_INT8_BOUNDS[cfg]
        errs = {k: rel_l2(outs["int8"][k], outs[None][k]) for k in bounds}
        log(f"[dit-config] {cfg}: the int8 run vs the float run (same "
            "noise) rel_l2 " + ", ".join(f"{k} {v:.3e}" for k, v in
                                           errs.items())
            + f" (bounds {bounds})")
        if any(errs[k] > b for k, b in bounds.items()):
            raise AssertionError(f"{cfg}: the int8 run strays from the float "
                                 "run")
        del dit, outs
        torch.cuda.empty_cache()
    return counts


def canonical_splat(dev):
    """A valid activated splat [1, G, 14]: xyz in [-0.5, 0.5], scales
    0.003-0.02, unit quaternions, SH DC ~ N(0, 0.5^2), opacity in
    (0.1, 0.9); the last 1000 rows are padding (invalid, unit rotation)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(3)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)
    quat = torch.randn(G, 4, generator=g, device=dev)
    gs = torch.cat([u(G, 3) - 0.5, 0.003 + 0.017 * u(G, 3),
                    quat / quat.norm(dim=-1, keepdim=True),
                    0.5 * torch.randn(G, 3, generator=g, device=dev),
                    0.1 + 0.8 * u(G, 1)], -1)[None]
    valid = torch.ones(1, G, dtype=torch.bool, device=dev)
    valid[:, G - 1000:] = False
    gs[:, G - 1000:] = 0.0
    gs[:, G - 1000:, 6] = 1.0
    return gs, valid


def run_stages(pipe, gs, valid, ci, seed):
    """The steps of VideoTo4DPipeline.run, called one by one and timed."""
    import torch

    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    g = torch.Generator(device=gs.device).manual_seed(seed)
    anchors = timed("fps", lambda: pipe.prepare_static_conditioning(gs, valid))
    kv = timed("kv_cache", lambda: pipe.cross_kv(ci, anchors))
    latent = timed("denoise", lambda: pipe.sample_deformation_latent(
        ci, anchors, anchors[..., :3], generator=g, cross_kv=kv))
    deltas = timed("decode", lambda: pipe.decode_deltas(latent, gs))
    return {"latent": latent, "deltas": deltas, "anchors": anchors}, stages


def reset_counts():
    from gvfdiffusion_torch.ops import flash_attention as fl
    from gvfdiffusion_torch.ops import fused_attention as fa
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    fsl.reset_launch_counts()
    fa.reset_launch_counts()
    fl.reset_launch_counts()


def read_counts():
    from gvfdiffusion_torch.ops import flash_attention as fl
    from gvfdiffusion_torch.ops import fused_attention as fa
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    return {**fsl.launch_counts, **fa.launch_counts, **fl.launch_counts}


def main_path(dino, pipe, frames, gs, valid, seed):
    """frames -> encode_video -> run -> render_4d through the entry points,
    timed stage by stage and whole, with the kernel launch counts of this
    run alone."""
    import torch
    from gvfdiffusion_torch.representations.gaussians import from_activated
    from gvfdiffusion_torch.scripts.process_video import encode_video

    g = torch.Generator(device=gs.device).manual_seed(seed)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tokens = encode_video(frames, dino, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = pipe.run(gs, valid, tokens[None], generator=g)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    video = pipe.render_4d(from_activated(gs[0]),
                           out["deltas"][0] * RENDER_DELTA_SCALE, valid[0],
                           num_views=1, resolution=512)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = read_counts()
    stages = {"encode": (t1 - t0) * 1e3, "run": (t2 - t1) * 1e3,
              "render_4d": (t3 - t2) * 1e3, "whole": (t3 - t0) * 1e3}
    return tokens, out, video, launches, stages


def check_outputs(out, batch, frames, gaussians):
    import torch

    shapes = {"latent": (batch, frames, 512, 16),
              "deltas": (batch, frames, gaussians, 14),
              "anchors": (batch, 512, 14)}
    for k, shape in shapes.items():
        v = out[k]
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{k}: shape {tuple(v.shape)} (want {shape}), "
                                 f"finite {bool(torch.isfinite(v).all())}")
    if float(out["deltas"].abs().mean()) == 0.0:
        raise AssertionError("deltas are all zero")


def check_video(video):
    """Finite [32, 1, 512, 512, 3] frames that cover part of the image and
    differ from frame to frame."""
    import torch

    if tuple(video.shape) != (T, 1, 512, 512, 3) or not bool(
            torch.isfinite(video).all()):
        raise AssertionError(f"frames: shape {tuple(video.shape)}, finite "
                             f"{bool(torch.isfinite(video).all())}")
    # share of pixels the splat covers: those off the white background
    coverage = float((video < 1.0 - 1e-3).any(-1).float().mean())
    motion = (video[1:] - video[:-1]).abs().amax(dim=(1, 2, 3, 4))
    log(f"[main] frames {tuple(video.shape)}: finite, coverage "
        f"{coverage:.4f}, frame-to-frame max abs change min "
        f"{float(motion.min()):.4g} / max {float(motion.max()):.4g}, "
        f"mean pixel {float(video.mean()):.4f}")
    if not (coverage > 0.0 and bool((motion > 0).all())):
        raise AssertionError("the frames show no splat or do not move")


def check_same(out, staged, what):
    """run() must give what its stages give when called one by one."""
    errs = {k: rel_l2(out[k], staged[k]) for k in ("anchors", "latent",
                                                   "deltas")}
    log(f"[pipeline] {what}: run() vs staged rel_l2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bound {RUN_REL_BOUND:g})")
    if max(errs.values()) > RUN_REL_BOUND:
        raise AssertionError(f"{what}: run() disagrees with its stages")


def phase_pipeline(dino, dit, vae, dev, card):
    import torch
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)

    frames = seeded_frames()
    gs, valid = canonical_splat(dev)
    warm = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=4, order=2))
    main_path(dino, warm, frames, gs, valid, seed=4)  # warm-up

    # the main path, through the entry points: the kernel launch counts
    # are read from this run only
    pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=32, order=2))
    torch.cuda.reset_peak_memory_stats()
    tokens, out, video, launches, stages = main_path(
        dino, pipe, frames, gs, valid, seed=5)
    main_out = out
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ci = tokens[None]
    if tuple(ci.shape) != (B, T, L_IMG, 1024) or not bool(
            torch.isfinite(ci).all()):
        raise AssertionError(f"tokens: shape {tuple(ci.shape)}")
    check_outputs(out, B, T, G)
    log(f"[main] frames [{T}, 518, 518, 3] -> encode_video -> run "
        f"(guidance 1.0/1.0, 32 steps, G={G}) -> render_4d ({T} frames, one "
        f"orbit view, 512^2, deltas x {RENDER_DELTA_SCALE:g} as bench.py "
        "scales random-weight deltas): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items())
        + f"; peak {peak:.2f} GiB; launches {launches}; {card}")
    log(f"[main] tokens {tuple(ci.shape)}, latent |mean| "
        f"{float(out['latent'].abs().mean()):.4g}, deltas |mean| "
        f"{float(out['deltas'].abs().mean()):.4g}, finite")
    check_video(video)
    missing = [k for k in ("self", "temporal", "cross", "mlp", "attention")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing} kernel")
    if launches["attention"] != 24:
        raise AssertionError(f"{launches['attention']} attention launches; "
                             "one 24-block encode makes 24")

    staged, st = run_stages(pipe, gs, valid, ci, seed=5)
    check_outputs(staged, B, T, G)
    log(f"[pipeline] guidance 1.0/1.0, 32 steps, G={G}, run()'s stages one "
        "by one: " + ", ".join(f"{k} {v:.1f} ms" for k, v in st.items())
        + f"; {card}")
    check_same(out, staged, "guidance 1.0/1.0")

    pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(
        steps=4, order=2, guidance_scale=2.0, guidance_scale2=5.0))
    staged, st = run_stages(pipe, gs, valid, ci, seed=6)
    check_outputs(staged, B, T, G)
    g = torch.Generator(device=dev).manual_seed(6)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = pipe.run(gs, valid, ci, generator=g)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    cfg_launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_outputs(out, B, T, G)
    log(f"[pipeline] guidance 2.0/5.0 (3-way CFG, B*T = 96), 4 steps, stage "
        f"by stage: " + ", ".join(f"{k} {v:.1f} ms" for k, v in st.items())
        + f"; run() {wall_ms:.1f} ms; peak {peak:.2f} GiB; launches "
        f"{cfg_launches}; finite; {card}")
    check_same(out, staged, "guidance 2.0/5.0")
    launches["cross_q8"], int8_out = phase_int8_cache(
        dit, vae, gs, valid, ci, dev, card, main_out, out)
    launches.update(phase_self_q8(dit, vae, gs, valid, ci, dev, card,
                                  main_out, out, int8_out))
    return launches, ci


# the infer CLI ([infer]): its seed, the launches each model call of the
# fp32 DiT on the composed path makes (12 blocks: K5 self, K5 image and
# static cross, K6), and the CLI against the pipeline on the same weights
# and generator (the same program: equal up to nondeterminism, which none
# of its kernels has)
INFER_SEED = 7
INFER_PER_NFE = {"attention_d32": 12, "attention_cross_d32": 24,
                 "temporal_attention": 12}
INFER_REL_BOUND = 1e-6
INFER_CFG_STEPS = 4


def _infer_counts(nfe):
    """The launches `nfe` model calls of the fp32 DiT make: K5 and K6 in
    INFER_PER_NFE's numbers, and no other kernel."""
    want = {k: 0 for k in read_counts()}
    want.update({k: n * nfe for k, n in INFER_PER_NFE.items()})
    return want


def run_infer(args, out_dir):
    """cli/infer.main(args) with its log (stdout and stderr) kept, the
    launches of this call alone and its progress.csv row: (rc, log,
    launches, row, wall s)."""
    import contextlib
    import csv

    import torch
    from gvfdiffusion_torch.cli import infer

    tee = _Tee()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee), contextlib.redirect_stderr(tee):
        rc = infer.main(args + ["--output_dir", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    with open(os.path.join(out_dir, "progress.csv")) as f:
        row = next(csv.DictReader(f))
    return rc, tee.text(), launches, row, wall


def check_infer_outputs(out_dir, what):
    """deformation.npz's latent [1, 32, 512, 16] and deltas [1, 32, G, 14]
    finite; frames.npy [32, 2, 512, 512, 3] finite and moving from frame
    to frame. Returns the latent (a CPU tensor)."""
    import numpy as np
    import torch

    d = np.load(os.path.join(out_dir, "deformation.npz"))
    latent, deltas = d["latent"], d["deltas"]
    frames = np.load(os.path.join(out_dir, "frames.npy"))
    motion = np.abs(frames[1:] - frames[:-1]).max(axis=(1, 2, 3, 4))
    ok = (latent.shape == (B, T, N, 16) and deltas.shape == (B, T, G, 14)
          and frames.shape == (T, 2, 512, 512, 3)
          and all(np.isfinite(a).all() for a in (latent, deltas, frames))
          and float(np.abs(deltas).mean()) > 0 and bool((motion > 0).all()))
    log(f"[infer] {what}: latent {latent.shape}, deltas {deltas.shape}, "
        f"frames {frames.shape}: finite and moving {ok}; frame-to-frame max "
        f"abs change min {float(motion.min()):.4g} / max "
        f"{float(motion.max()):.4g}")
    if not ok:
        raise AssertionError(f"[infer] {what}: bad outputs")
    return torch.from_numpy(latent)


def phase_infer(ci, gs, valid, dev, card):
    """The reference launch through the entry point users call,
    cli/infer.main, at full width: the frames phase's tokens and splat
    written as its input npz, a fp32 DiT and a fp32 motion VAE of the
    default Config on seeded weights written as trainer checkpoints, then
    `--adaptive --use_fp16 --num_timesteps 32` (the fp32 DiT at guidance
    1.0/1.0: the composed path, K5 and K6); its outputs checked, its
    launches against its NFE, its latent against VideoTo4DPipeline.run on
    the same weights and generator; then one call at guidance 2.0/5.0 x 4
    steps (the fp32 DiT composing on its hoisted cache). Returns the
    launches of the adaptive call under the kernels line's infer keys."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from gvfdiffusion_torch.cli.main_latent import build_model
    from gvfdiffusion_torch.cli.main_vae import build_motion_vae
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)
    from gvfdiffusion_torch.train.train_state import (create_train_state,
                                                      make_optimizer)
    from gvfdiffusion_torch.utils.checkpoint import CheckpointManager
    from gvfdiffusion_torch.utils.config import Config
    from gvfdiffusion_torch.utils.weights import init_random_

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="gvf_infer_smoke_")
    try:
        # the CLI's input has no validity mask: the splat's padding rows
        # become copies of its first rows, so that all G rows are Gaussians
        canon = gs[0].clone()
        n_pad = int((~valid[0]).sum())
        canon[~valid[0]] = gs[0, :n_pad]
        npz = os.path.join(work, "cond.npz")
        np.savez(npz, canonical_gs=canon.cpu().numpy(),
                 cond_images=ci[0].float().cpu().numpy())
        cfg = Config()
        dit = init_random_(build_model(cfg), seed=21).eval()
        vae = init_random_(build_motion_vae(cfg), seed=22).eval()
        for model, name in ((dit, "dit"), (vae, "vae")):
            state = create_train_state(model, make_optimizer(lr=0.0))
            CheckpointManager(os.path.join(work, name)).save(state, 0)
            del state
        t_write = time.perf_counter() - t_phase
        common = ["--input", npz, "--dit_ckpt", os.path.join(work, "dit"),
                  "--vae_ckpt", os.path.join(work, "vae"), "--num_views",
                  "2", "--seed", str(INFER_SEED)]

        out = os.path.join(work, "out")
        rc, text, launches, row, wall = run_infer(
            common + ["--adaptive", "--use_fp16", "--num_timesteps", str(T)],
            out)
        if rc != 0:
            raise AssertionError(f"[infer] rc {rc}")
        cli_latent = check_infer_outputs(out, "the reference launch")
        info = {k: int(row[k]) for k in ("nfe", "iters", "accepted",
                                          "rejected", "syncs")}
        secs = {k: float(row[f"{k}_s"]) for k in ("fps", "sample", "decode",
                                                  "render")}
        want = _infer_counts(info["nfe"])
        got = {k: n for k, n in launches.items() if n}
        log(f"[infer] cli/infer.main --adaptive --use_fp16 --num_timesteps "
            f"{T} (fp32 DiT 12x512 at guidance 1.0/1.0, composed path; "
            f"G={G}, 2 views at 512^2): NFE {info['nfe']}, iterations "
            f"{info['iters']} ({info['accepted']} accepted, "
            f"{info['rejected']} rejected), host syncs {info['syncs']}; "
            + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in secs.items())
            + f"; main() {wall * 1e3:.1f} ms; launches {got}; input and "
            f"checkpoints written in {t_write:.1f} s; {card}")
        if launches != want:
            raise AssertionError(f"[infer] launches {got}, expected "
                                 f"{ {k: n for k, n in want.items() if n} }")

        # the pipeline on the same weights and generator
        pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(
            method="adaptive", num_frames=T, num_latents=N, latent_dim=16))
        g = torch.Generator(device=dev).manual_seed(INFER_SEED)
        ref = pipe.run(canon[None], torch.ones_like(valid), ci.float(),
                       generator=g)
        err = rel_l2(cli_latent.to(dev), ref["latent"])
        log(f"[infer] the CLI's latent vs VideoTo4DPipeline(method="
            f"'adaptive').run on the same weights and generator: rel_l2 "
            f"{err:.3e} (bound {INFER_REL_BOUND:g}); the pipeline's sampler "
            f"{pipe.sample_info}")
        if not err <= INFER_REL_BOUND:
            raise AssertionError("[infer] the CLI disagrees with the "
                                 "pipeline")
        del pipe, ref
        torch.cuda.empty_cache()

        out_cfg = os.path.join(work, "out_cfg")
        rc, text, launches, row, wall = run_infer(
            common + ["--guidance_scale", "2.0", "--guidance_scale2", "5.0",
                      "--steps", str(INFER_CFG_STEPS)], out_cfg)
        if rc != 0:
            raise AssertionError(f"[infer] CFG call rc {rc}")
        check_infer_outputs(out_cfg, "guidance 2.0/5.0")
        cfg_want = _infer_counts(int(row["nfe"]))
        got = {k: n for k, n in launches.items() if n}
        log(f"[infer] cli/infer.main --guidance_scale 2.0 --guidance_scale2 "
            f"5.0 --steps {INFER_CFG_STEPS} (the fp32 DiT composing on its "
            f"hoisted cache, B*T = 96): NFE {row['nfe']}, "
            + ", ".join(f"{k} {float(row[f'{k}_s']) * 1e3:.1f} ms"
                        for k in ("fps", "sample", "decode", "render"))
            + f"; main() {wall * 1e3:.1f} ms; launches {got}; {card}")
        if int(row["nfe"]) != INFER_CFG_STEPS or launches != cfg_want:
            raise AssertionError(f"[infer] CFG call: NFE {row['nfe']}, "
                                 f"launches {got}")
        log(f"[infer] phase in {time.perf_counter() - t_phase:.1f} s")
        counts = _infer_counts(info["nfe"])
        return {f"infer_{k}": counts[k] for k in INFER_PER_NFE}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_int8_cache(dit, vae, gs, valid, ci, dev, card, float_out,
                     float_cfg_out):
    """The video main path on bench.py's int8 KV cache
    (VideoTo4DConfig(kv_quant="int8"), K3's int8 form): run() at guidance
    1.0/1.0 and 32 steps with the noise of the float main run, timed, its
    launches counted; its stages one by one must give what run() gave; its
    latent and deltas against the float run's. Then 4 steps at guidance
    2.0/5.0 (B*T = 96: q scales per half cell), against its stages and the
    float CFG run. Returns the K3 int8 launches of the 32-step run()."""
    import torch
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)

    pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=32, order=2,
                                                       kv_quant="int8"))
    g = torch.Generator(device=dev).manual_seed(5)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = pipe.run(gs, valid, ci, generator=g)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: n for k, n in read_counts().items() if n}
    check_outputs(out, B, T, G)
    int8_out = out
    errs = {k: rel_l2(out[k], float_out[k]) for k in INT8_RUN_BOUNDS}
    log(f"[int8] run() on the int8 KV cache (guidance 1.0/1.0, 32 steps, "
        f"G={G}): {wall_ms:.1f} ms; launches {launches}; vs the float run "
        "(same noise) rel_l2 " + ", ".join(f"{k} {v:.3e}"
                                            for k, v in errs.items())
        + f" (bounds {INT8_RUN_BOUNDS}); {card}")
    want = {"self": 384, "temporal": 384, "cross_q8": 384, "mlp": 384}
    if launches != want:
        raise AssertionError(f"int8 run launches {launches}, expected {want}")
    if any(errs[k] > b for k, b in INT8_RUN_BOUNDS.items()):
        raise AssertionError("the int8 run strays from the float run")
    staged, st = run_stages(pipe, gs, valid, ci, seed=5)
    log("[int8] run()'s stages one by one: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in st.items()) + f"; {card}")
    check_same(out, staged, "int8 cache, guidance 1.0/1.0")

    pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(
        steps=4, order=2, guidance_scale=2.0, guidance_scale2=5.0,
        kv_quant="int8"))
    staged, st = run_stages(pipe, gs, valid, ci, seed=6)
    reset_counts()
    out = pipe.run(gs, valid, ci,
                   generator=torch.Generator(device=dev).manual_seed(6))
    torch.cuda.synchronize()
    cfg_launches = {k: n for k, n in read_counts().items() if n}
    check_outputs(out, B, T, G)
    errs = {k: rel_l2(out[k], float_cfg_out[k]) for k in INT8_CFG_BOUNDS}
    log(f"[int8] guidance 2.0/5.0 (B*T = 96, q scales per half cell), 4 "
        "steps, stage by stage: " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in st.items())
        + f"; launches {cfg_launches}; vs the float CFG run rel_l2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bounds {INT8_CFG_BOUNDS}); {card}")
    check_same(out, staged, "int8 cache, guidance 2.0/5.0")
    if cfg_launches.get("cross_q8") != 48 or any(
            errs[k] > b for k, b in INT8_CFG_BOUNDS.items()):
        raise AssertionError("the int8 CFG run: launches or agreement")
    return launches["cross_q8"], int8_out


def phase_self_q8(dit, vae, gs, valid, ci, dev, card, float_out,
                  float_cfg_out, int8_out):
    """The video main path with the DiT's self and temporal QK in int8 on
    the int8 KV cache (VideoTo4DConfig(kv_quant="int8", self_quant="int8"):
    K1 and K2 with int8 QK, K3's int8 form): run() at guidance 1.0/1.0 and
    32 steps with the noise of the float main run, timed, its launches
    counted (exactly 384 of K1 q8, K2 q8, K3 int8 and K4); its stages one
    by one must give what run() gave; its latent and deltas against the
    float run's, and against the int8-cache run's (the int8 QK's own
    share). Then 4 steps at guidance 2.0/5.0 against its stages and the
    float CFG run. Returns the K1 q8 and K2 q8 launches of the 32-step
    run()."""
    import torch
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)

    q8 = dict(kv_quant="int8", self_quant="int8")
    pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=32, order=2,
                                                       **q8))
    g = torch.Generator(device=dev).manual_seed(5)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = pipe.run(gs, valid, ci, generator=g)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: n for k, n in read_counts().items() if n}
    check_outputs(out, B, T, G)
    errs = {k: rel_l2(out[k], float_out[k]) for k in SELFQ8_RUN_BOUNDS}
    own = {k: rel_l2(out[k], int8_out[k]) for k in SELFQ8_RUN_BOUNDS}
    staged, st = run_stages(pipe, gs, valid, ci, seed=5)
    log(f"[selfq8] run() with self_quant=\"int8\" on the int8 KV cache "
        f"(guidance 1.0/1.0, 32 steps, G={G}): {wall_ms:.1f} ms; stages one "
        "by one: " + ", ".join(f"{k} {v:.1f} ms" for k, v in st.items())
        + f"; launches {launches}; vs the float run (same noise) rel_l2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bounds {SELFQ8_RUN_BOUNDS}); vs the int8-cache run without "
        "int8 QK rel_l2 " + ", ".join(f"{k} {v:.3e}" for k, v in own.items())
        + f"; {card}")
    want = {"self_q8": 384, "temporal_q8": 384, "cross_q8": 384, "mlp": 384}
    if launches != want:
        raise AssertionError(f"self_quant run launches {launches}, "
                             f"expected {want}")
    if any(errs[k] > b for k, b in SELFQ8_RUN_BOUNDS.items()):
        raise AssertionError("the self_quant run strays from the float run")
    check_same(out, staged, "self_quant int8, guidance 1.0/1.0")

    pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(
        steps=4, order=2, guidance_scale=2.0, guidance_scale2=5.0, **q8))
    staged, st = run_stages(pipe, gs, valid, ci, seed=6)
    reset_counts()
    t0 = time.perf_counter()
    cfg_out = pipe.run(gs, valid, ci,
                       generator=torch.Generator(device=dev).manual_seed(6))
    torch.cuda.synchronize()
    cfg_ms = (time.perf_counter() - t0) * 1e3
    cfg_launches = {k: n for k, n in read_counts().items() if n}
    check_outputs(cfg_out, B, T, G)
    errs = {k: rel_l2(cfg_out[k], float_cfg_out[k])
            for k in SELFQ8_CFG_BOUNDS}
    log(f"[selfq8] guidance 2.0/5.0 (B*T = 96), 4 steps: run() "
        f"{cfg_ms:.1f} ms; stages: " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in st.items())
        + f"; launches {cfg_launches}; vs the float CFG run rel_l2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bounds {SELFQ8_CFG_BOUNDS}); {card}")
    check_same(cfg_out, staged, "self_quant int8, guidance 2.0/5.0")
    if cfg_launches != {k: 48 for k in want} or any(
            errs[k] > b for k, b in SELFQ8_CFG_BOUNDS.items()):
        raise AssertionError("the self_quant CFG run: launches or agreement")
    return {k: launches[k] for k in QK8}


# -- the TRELLIS front end ------------------------------------------------------


def slat_stats():
    """The SLat normalization of the TRELLIS phases (mean, std), seed 24."""
    import torch

    g = torch.Generator().manual_seed(24)
    return torch.randn(8, generator=g) * 0.3, torch.rand(8, generator=g) + 0.5


def build_trellis(dino, dev, torso=TORSO, voxels=VOXELS):
    """The TRELLIS-image-large configuration at full width with seeded
    random weights (bench.py:216-326, tests/test_fullsize_golden.py:214-240):
    the 24x1024 sparse-structure flow (16 heads of 64, patch 2, q/k RMS
    norm), the (512, 128, 32) occupancy decoder, the 24x1024 SLat flow (io
    channels 128, torso compacted to `torso` slots, or not at all with
    None), the 12x768 Gaussian decoder (swin window 8); `voxels` voxel
    slots."""
    import torch
    from gvfdiffusion_torch.models.trellis.slat_decoders import (
        SLatGaussianDecoder)
    from gvfdiffusion_torch.models.trellis.slat_flow import SLatFlowModel
    from gvfdiffusion_torch.models.trellis.ss_flow import (
        SparseStructureFlowModel)
    from gvfdiffusion_torch.models.trellis.ss_vae import (
        SparseStructureDecoder)
    from gvfdiffusion_torch.pipelines.trellis_image_to_3d import (
        TrellisConfig, TrellisImageTo3DPipeline)
    from gvfdiffusion_torch.utils.weights import init_random_

    bf = torch.bfloat16
    mean, std = slat_stats()
    return TrellisImageTo3DPipeline(
        dino,
        init_random_(SparseStructureFlowModel(qk_rms_norm=True, dtype=bf), 20),
        init_random_(SparseStructureDecoder(dtype=bf), 21),
        init_random_(SLatFlowModel(qk_rms_norm=True, torso_capacity=torso,
                                   dtype=bf), 22),
        init_random_(SLatGaussianDecoder(dtype=bf), 23),
        TrellisConfig(voxel_capacity=voxels), slat_mean=mean, slat_std=std,
        device=dev)


def seeded_image():
    """A 768^2 RGBA image: seeded colours, an elliptic alpha blob."""
    import numpy as np

    r = np.random.default_rng(12)
    yy, xx = np.mgrid[:768, :768]
    alpha = ((yy - 400) / 260.0) ** 2 + ((xx - 370) / 210.0) ** 2 < 1.0
    rgb = r.uniform(0.2, 0.9, (768, 768, 3))
    return (np.concatenate([rgb, alpha[..., None]], -1) * 255).astype(
        np.uint8)


def _parents(occ):
    """Distinct 2x-downsampled cells of the occupied 64^3 cells."""
    import torch

    c = torch.nonzero(occ) // 2
    return int(torch.unique(c[:, 0] * 1024 + c[:, 1] * 32 + c[:, 2]).numel())


def calibrate_occupancy(pipe, z):
    """Random weights make the occupancy arbitrary. Shift the decoder's
    output bias to the middle of the largest logit gap near a target count
    (tests/test_fullsize_golden.py:259-270), the largest target in
    OCC_TARGETS whose 2x parents fit the torso's slots, so that no
    borderline voxel decides the structure and nothing is truncated."""
    import torch

    with torch.no_grad():
        logits = pipe.ss_decoder(z)[0, ..., 0]
    v = torch.sort(logits.flatten(), descending=True).values
    for target in OCC_TARGETS:
        gaps = v[target - 500:target + 500] - v[target - 499:target + 501]
        k = target - 499 + int(torch.argmax(gaps))
        thr = 0.5 * (v[k - 1] + v[k])
        parents = _parents(logits > thr)
        if parents <= TORSO:
            break
    with torch.no_grad():
        pipe.ss_decoder.out_layer[2].bias -= thr
    return k, float(gaps.max()), parents


def _voxel_set(sv):
    return {tuple(c) for c in sv.coords[0][sv.valid[0]].tolist()}


def trellis_stages(pipe, pre, seed, card, calibrate=False, tag="[trellis]"):
    """TrellisImageTo3DPipeline's stages one by one, with the noise drawn
    as run() draws it: timed, and the launches counted per stage; lines
    printed under `tag`."""
    import torch

    g = torch.Generator(device=pipe.device).manual_seed(seed)
    times, counts, out = {}, {}, {}

    def stage(name, fn):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        counts[name] = {k: n for k, n in read_counts().items() if n}
        return r

    out["cond"] = stage("encode", lambda: pipe.encode_image(pre))
    out["z"] = stage("ss_flow", lambda: pipe.sample_ss_latent(out["cond"], g))
    if calibrate:
        k, gap, parents = calibrate_occupancy(pipe, out["z"])
        log(f"{tag} occupancy bias set at rank {k} (largest logit gap "
            f"{gap:.4g}): {parents} parents at 32^3 for a {TORSO}-slot torso")
    out["structure"] = stage("ss_decode",
                             lambda: pipe.decode_structure(out["z"]))
    out["slat"] = stage("slat_flow", lambda: pipe.sample_slat(
        out["structure"], out["cond"], g))
    out["gs"], out["valid"] = stage("gs_decode",
                                    lambda: pipe.decode_slat(out["slat"]))
    log(f"{tag} stages: " + ", ".join(f"{k} {v:.1f} ms"
                                         for k, v in times.items())
        + f"; launches by stage {counts}; {card}")
    return out


def phase_trellis(dino, dit, vae, ci, dev, card):
    """The TRELLIS main path, its agreement with the plain versions, and the
    splat through the video -> 4D path. Returns the launches of K5's forms
    and K3's single-context form in run(), keyed as in KERNELS."""
    import torch
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)
    from gvfdiffusion_torch.representations.gaussians import GaussianSplat

    pipe = build_trellis(dino, dev)
    image = seeded_image()
    t0 = time.perf_counter()
    pre = torch.from_numpy(pipe.preprocess_image(image))[None]
    host_ms = (time.perf_counter() - t0) * 1e3
    staged = trellis_stages(pipe, pre, 31, card, calibrate=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = pipe.run(image, torch.Generator(device=dev).manual_seed(31))
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st, gs, valid = out["structure"], out["gaussians"], out["valid"]
    n_occ = int(st.valid.sum())
    parents = _parents(st.to_dense()[0, ..., 0] != 0) if n_occ else 0
    act = gs.to_activated_tensor()
    log(f"[trellis] run(): 768^2 RGBA -> preprocess_image ({host_ms:.1f} ms "
        f"on the host) -> {run_ms:.1f} ms; n_occ {n_occ}, parents {parents},"
        f" dropped {max(parents - TORSO, 0)}, valid Gaussians "
        f"{int(valid.sum())} of {valid.shape[1]}; peak {peak:.2f} GiB; "
        f"launches {launches}; {card}")
    if not (0 < n_occ <= VOXELS and parents <= TORSO
            and tuple(act.shape) == (1, G, 14)
            and bool(torch.isfinite(act).all())):
        raise AssertionError("TRELLIS run: empty or truncated structure, or "
                             "non-finite Gaussians")
    same = (_voxel_set(st) == _voxel_set(staged["structure"])
            and rel_l2(out["slat"].feats, staged["slat"].feats) <= RUN_REL_BOUND
            and rel_l2(act, staged["gs"].to_activated_tensor())
            <= RUN_REL_BOUND)
    if not same:
        raise AssertionError("TRELLIS run() disagrees with its stages")
    # K5's self form without bias serves DINOv2 on the image (24 blocks)
    # and the sparse-structure flow (24 Euler forwards x 24 blocks): one
    # counter, so one entry of the kernels line
    want = {"attention": 24 + 576, "attention_cross": 576,
            "attention_bias": 528, "cross_single": 528}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"TRELLIS launches {got}, expected {want}")

    # kernels against the plain versions, in two parts: the latent and the
    # occupancy flips; then the SLat and the Gaussians on the kernel run's
    # structure, with the same noise
    g = torch.Generator(device=dev).manual_seed(31)
    n1 = torch.randn(staged["z"].shape, generator=g, device=dev)
    n2 = torch.randn((1, VOXELS, 8), generator=g, device=dev)
    cond_p = pipe.encode_image(pre, impl="plain")
    z_p = pipe.sample_ss_latent(staged["cond"], noise=n1, impl="plain")
    flips = len(_voxel_set(pipe.decode_structure(z_p))
                ^ _voxel_set(staged["structure"])) / n_occ
    slat_p = pipe.sample_slat(staged["structure"], staged["cond"],
                              noise_feats=n2, impl="plain")
    gs_p, _ = pipe.decode_slat(slat_p, impl="plain")
    m = staged["valid"][0]
    errs = {"cond": rel_l2(staged["cond"], cond_p),
            "ss_latent": rel_l2(staged["z"], z_p), "flips": flips,
            "slat": rel_l2(staged["slat"].feats, slat_p.feats),
            "gaussians": rel_l2(staged["gs"].to_activated_tensor()[0][m],
                                gs_p.to_activated_tensor()[0][m])}
    log("[trellis] kernels vs plain: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bounds {TRELLIS_BOUNDS}, cond {DINO_REL_BOUND:g}); valid "
        f"Gaussians |xyz| max {float(act[0, :, :3][valid[0]].abs().max()):.3f}")
    if errs["cond"] > DINO_REL_BOUND or any(
            errs[k] > b for k, b in TRELLIS_BOUNDS.items()):
        raise AssertionError("TRELLIS kernels disagree with the plain path")

    # the splat through the video -> 4D path and the renderer
    pipe4d = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=32, order=2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipe4d.run(act, valid, ci, generator=torch.Generator(
        device=dev).manual_seed(32))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gs0 = GaussianSplat(
        gs._xyz[0], gs._features_dc[0], gs._scaling[0], gs._rotation[0],
        gs._opacity[0], gs.aabb, gs.scaling_bias, gs.opacity_bias,
        gs.scaling_activation, gs.mininum_kernel_size)
    video = pipe4d.render_4d(gs0, res["deltas"][0] * RENDER_DELTA_SCALE,
                             valid[0], num_views=1, resolution=512)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check_outputs(res, B, T, G)
    log(f"[trellis] the splat -> VideoTo4DPipeline.run ({T} frames, 32 "
        f"steps) {(t1 - t0) * 1e3:.1f} ms -> render_4d "
        f"{(t2 - t1) * 1e3:.1f} ms; {card}")
    check_video(video)
    return {"attention_ss_self": got["attention"],
            **{k: got[k] for k in ("attention_cross", "attention_bias",
                                   "cross_single")}}, pipe


def bench_render_options():
    """bench.py's inference rasterizer (bench.py:383-397): the early-exit
    multi-round blend, tiles of 64, 128 Gaussians per round, 2 rounds."""
    from gvfdiffusion_torch.render.renderer import RenderOptions

    return RenderOptions(near=0.1, far=10.0, bg_color=(1.0, 1.0, 1.0),
                         use_mip=True, backend="binned", max_per_tile=128,
                         rounds=2, early_exit=True, tile=64)


def phase_wild(tpipe, dit, vae, ci, dev, card):
    """The whole in-the-wild entry point: InTheWildPipeline.run on the
    seeded 768^2 RGBA image and the 32 seeded frames' DINOv2 tokens, with
    the TRELLIS of phase_trellis (compacted torso, its calibrated
    occupancy), the alignment over 360 angles through bench.py's inference
    rasterizer, and the video pipeline on the int8 KV cache with int8 QK
    (bench.py's settings plus self_quant); timed whole, and stage by stage
    under bench.py's keys. run()'s target is the preprocessed image itself,
    so the alignment's recovery is checked apart: the TRELLIS splat
    rendered at WILD_AZIMUTH degrees (with its alpha) is the canonical
    frame, and align_gaussian_to_canonical must find that azimuth within
    1 degree and a scale within 2% of 1. Then the 24-frame sweep of the
    aligned splat at 512^2 (bench.py's render_24f) through the early-exit
    multi-round blend, against the same without early exit and against one
    round of K = 256."""
    import torch
    from gvfdiffusion_torch.pipelines.in_the_wild import (InTheWildConfig,
                                                          InTheWildPipeline)
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)
    from gvfdiffusion_torch.render.renderer import GaussianRenderer
    from gvfdiffusion_torch.representations.camera import orbit_camera
    from gvfdiffusion_torch.scripts.process_video import resize_bilinear
    from gvfdiffusion_torch.utils.inference_utils import (
        align_gaussian_to_canonical, render_sweep, rotate_gaussians_z)

    opts = bench_render_options()
    renderer = GaussianRenderer(opts)
    v4d = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(
        steps=32, order=2, kv_quant="int8", self_quant="int8"))
    wild = InTheWildPipeline(tpipe, v4d, InTheWildConfig(align_n_angles=360),
                             render_options=opts)
    image, tokens = seeded_image(), ci[0]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # the stages one by one, with run()'s generator draws
    g = torch.Generator(device=dev).manual_seed(31)
    stages = {}
    tout, stages["trellis_run"] = timed(lambda: tpipe.run(image, g))
    gs, valid = tout["gaussians"].select(0), tout["valid"][0]
    target = resize_bilinear(torch.from_numpy(tpipe.preprocess_image(image)),
                             (512, 512))
    (gs_al, angle, scale), stages["alignment_360"] = timed(
        lambda: align_gaussian_to_canonical(gs, target, valid=valid,
                                            n_angles=360, renderer=renderer))
    act = gs_al.to_activated_tensor()[None]
    anchors, stages["fps"] = timed(
        lambda: v4d.prepare_static_conditioning(act, valid[None]))
    kv, stages["kv_cache"] = timed(lambda: v4d.cross_kv(tokens[None], anchors))
    latent, stages["dpm_denoise_32"] = timed(
        lambda: v4d.sample_deformation_latent(
            tokens[None], anchors, anchors[..., :3], generator=g,
            cross_kv=kv))
    deltas, stages["vae_decode"] = timed(lambda: v4d.decode_deltas(latent,
                                                                   act))
    sweep_deltas = deltas[0, :RENDER_FRAMES] * RENDER_DELTA_SCALE
    frames, stages["render_24f"] = timed(lambda: render_sweep(
        renderer, gs_al, sweep_deltas, valid, num_views=1, resolution=512,
        pitch_deg=0.0))

    # run() whole, its launches counted
    reset_counts()
    out, run_ms = timed(lambda: wild.run(
        image, tokens, generator=torch.Generator(device=dev).manual_seed(31)))
    launches = {k: n for k, n in read_counts().items() if n}
    check_outputs(out, B, T, G)
    errs = {"latent": rel_l2(out["latent"], latent),
            "deltas": rel_l2(out["deltas"], deltas)}
    log("[wild] stages (bench.py's keys where they match): " + json.dumps(
        {k: round(v, 1) for k, v in stages.items()}) + f"; run() "
        f"{run_ms:.1f} ms; {card}")
    log(f"[wild] InTheWildPipeline.run: 768^2 RGBA + tokens "
        f"{tuple(tokens.shape)} -> angle {math.degrees(out['align_angle']):.1f}"
        f" deg, scale {out['align_scale']:.4g}, valid Gaussians "
        f"{int(out['valid'].sum())} of {G}, deltas |mean| "
        f"{float(out['deltas'].abs().mean()):.4g}; vs its stages rel_l2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bound {RUN_REL_BOUND:g}); launches {launches}")
    if not (out["align_angle"] == angle and out["align_scale"] == scale
            and max(errs.values()) <= RUN_REL_BOUND):
        raise AssertionError("InTheWildPipeline.run disagrees with its stages")
    want = {"attention": 24 + 576, "attention_cross": 576,
            "attention_bias": 528, "cross_single": 528, "self_q8": 384,
            "temporal_q8": 384, "cross_q8": 384, "mlp": 384}
    if launches != want:
        raise AssertionError(f"wild run launches {launches}, expected {want}")

    # the alignment recovers a known azimuth
    cam = orbit_camera(0.0, 0.0, height=512, width=512)
    shown = renderer.render(rotate_gaussians_z(
        gs, math.radians(WILD_AZIMUTH)), cam, valid=valid)
    (_, rec, rec_scale), rec_ms = timed(lambda: align_gaussian_to_canonical(
        gs, shown["render"], shown["alpha"], valid=valid, n_angles=360,
        renderer=renderer))
    coverage = float((shown["alpha"] > 0.5).float().mean())
    log(f"[wild] alignment to the splat's own render at {WILD_AZIMUTH} deg "
        f"(alpha > 0.5 on {coverage:.3f} of the frame): found "
        f"{math.degrees(rec):.2f} deg, scale {rec_scale:.4f} (bounds "
        f"{WILD_ANGLE_TOL:g} deg, {WILD_SCALE_TOL:g}) in {rec_ms:.1f} ms")
    if not (abs(math.degrees(rec) - WILD_AZIMUTH) <= WILD_ANGLE_TOL
            and abs(rec_scale - 1.0) <= WILD_SCALE_TOL):
        raise AssertionError("the alignment missed the known azimuth")

    # the sweep against the scan form and against one round of K = 256
    others = {}
    for key, o in (("no_early_exit", dict(early_exit=False)),
                   ("one_round_256", dict(rounds=1, max_per_tile=256))):
        r = GaussianRenderer(dataclasses.replace(opts, **o))
        f, ms = timed(lambda: render_sweep(
            r, gs_al, sweep_deltas, valid, num_views=1, resolution=512,
            pitch_deg=0.0))
        others[key] = (rel_l2(frames, f), ms)
    coverage = float((frames < 1.0 - 1e-3).any(-1).float().mean())
    log(f"[wild] render_sweep {tuple(frames.shape)} (deltas x "
        f"{RENDER_DELTA_SCALE:g}): early exit {stages['render_24f']:.1f} ms, "
        f"coverage {coverage:.4f}; " + ", ".join(
            f"{k} {ms:.1f} ms, rel_l2 {e:.3e} (bound {SWEEP_BOUNDS[k]:g})"
            for k, (e, ms) in others.items()) + f"; {card}")
    if not (bool(torch.isfinite(frames).all()) and coverage > 0
            and all(e <= SWEEP_BOUNDS[k] for k, (e, _) in others.items())):
        raise AssertionError("the early-exit sweep disagrees")

    return stages, run_ms


def write_safetensors(state_dict, path: str) -> None:
    """An fp32 state dict as a `.safetensors` file: the 8-byte
    little-endian header length, the JSON header, the raw buffers."""
    import struct

    header, blobs, offset = {}, [], 0
    for k, v in state_dict.items():
        raw = v.detach().float().contiguous().cpu().numpy()
        header[k] = {"dtype": "F32", "shape": list(v.shape),
                     "data_offsets": [offset, offset + raw.nbytes]}
        blobs.append(raw)
        offset += raw.nbytes
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for raw in blobs:
            f.write(raw.tobytes())


def write_release(root: str, models, stats) -> None:
    """The GVF release in MODEL_REPOS's layout under root: each model's
    state dict as a `.pt` with DDP's `module.` prefix, the stats as bare
    tensors."""
    import torch
    from gvfdiffusion_torch.utils.hub import MODEL_REPOS

    info = MODEL_REPOS["GVFDiffusion_v1.0"]
    repo = os.path.join(root, info["repo_id"])
    os.makedirs(repo)
    for key, m in models.items():
        torch.save({"module." + k: v.cpu() for k, v in
                    m.state_dict().items()}, os.path.join(repo, info[key]))
    for key, t in stats.items():
        torch.save(t.cpu(), os.path.join(repo, info[key + "_path"]))


def phase_wild_files(dino, tpipe, dit, vae, dev, card):
    """The in-the-wild chain from files on disk to an mp4 on disk, at full
    width with seeded weights:
      * a release mirror in MODEL_REPOS's layout in a temporary directory
        (the seeded DiT and motion VAE of the main path, a seeded static
        VAE at its defaults, as `.pt` with a `module.` prefix; the stats as
        bare tensors), resolved by hub.download_model_files(local_hub=)
        and loaded by hub.load_gvf_release onto the card: every tensor
        equal to the seeded one;
      * the seeded DINOv2 through a `.safetensors` file written here and
        read by the port's reader (weight_convert.load_torch_checkpoint,
        convert_dinov2) into a fresh DINOv2: every tensor equal;
      * the 32 seeded frames written as a video through
        StreamingVideoWriter (cv2's mp4v), extract_frames (cv2's reader
        where ffmpeg is absent), encode_video_features with a full-width
        seeded MODNet matting_fn (hr_channels 32, width 1.0), held against
        encode_video on the extracted frames and the hook's alphas; where
        no video is written or read (no cv2), the frames in memory;
      * DINOv2 at image_size 224 (its position embedding resized to 16^2
        patches): K5 at [32, 261, 16, 64], launches counted, against
        impl="plain";
      * InTheWildPipeline.run on the seeded image's RGB (no alpha: MODNet's
        matte through TRELLIS's matting_fn; the occupancy calibrated again
        on this image's latent) with the extracted frames' tokens and a
        seeded full-width CLIP ViT-B/32's clip_score_fn;
      * render_outputs at render_views 16 (32 frames x 16 views at 512^2,
        the deltas scaled as bench.py scales random-weight deltas): the
        spiral written as an mp4 or `.npy`, frames.npy.
    Prints the stage times and one JSON line; returns the 224 encode's K5
    launches for the kernels line."""
    import importlib.util
    import shutil
    import tempfile

    import numpy as np
    import torch
    from gvfdiffusion_torch.models.clip import (CLIPImageEncoder,
                                                make_clip_score_fn)
    from gvfdiffusion_torch.models.dinov2 import DinoV2, encode_image
    from gvfdiffusion_torch.models.modnet import MODNet, make_matting_fn
    from gvfdiffusion_torch.models.static_vae import SparseTransformerVAE
    from gvfdiffusion_torch.pipelines.in_the_wild import (InTheWildConfig,
                                                          InTheWildPipeline)
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)
    from gvfdiffusion_torch.scripts.process_video import (
        encode_video, encode_video_features, extract_frames, normalize_frame)
    from gvfdiffusion_torch.utils import hub
    from gvfdiffusion_torch.utils import weight_convert as wc
    from gvfdiffusion_torch.utils.image import read_image, resize_bilinear
    from gvfdiffusion_torch.utils.inference_utils import StreamingVideoWriter
    from gvfdiffusion_torch.utils.weights import init_random_

    # the routes, decided by what is installed
    t_phase = time.perf_counter()
    routes = {"ffmpeg": shutil.which("ffmpeg") is not None,
              **{m: importlib.util.find_spec(m) is not None
                 for m in ("cv2", "imageio", "PIL")}}
    res, times = {"routes": routes}, {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[key] = round((time.perf_counter() - t0) * 1e3, 1)
        return out

    work = tempfile.mkdtemp(prefix="gvf_wild_files_")
    try:
        # the release, from a mirror
        svae = init_random_(SparseTransformerVAE(), seed=42).to(dev).eval()
        g = torch.Generator().manual_seed(43)
        stats = {"static_mean": torch.randn(14, generator=g),
                 "static_std": torch.rand(14, generator=g) + 0.5,
                 "deformation_mean": torch.randn(16, generator=g),
                 "deformation_std": torch.rand(16, generator=g) + 0.5}
        models = {"model_path": dit, "vae_path": vae,
                  "static_vae_path": svae}
        timed("release_write", lambda: write_release(work, models, stats))
        files = hub.download_model_files("GVFDiffusion_v1.0", local_hub=work)
        rel = timed("release_load", lambda: hub.load_gvf_release(
            files, dit_kwargs=dict(num_blocks=12),
            vae_kwargs=dict(depth=12),
            static_vae_kwargs=dict(num_blocks=12, num_heads=12),
            device="cuda"))
        n_equal = 0
        for key, m in (("dit", dit), ("motion_vae", vae),
                       ("static_vae", svae)):
            own = m.state_dict()
            if sorted(rel[key]) != sorted(own) or not all(
                    rel[key][k].is_cuda and torch.equal(rel[key][k], v)
                    for k, v in own.items()):
                raise AssertionError(f"the release's {key} differs from the "
                                     "seeded model")
            n_equal += len(own)
        for key, t in stats.items():
            if not torch.equal(rel[key].cpu(), t):
                raise AssertionError(f"the release's {key} differs")
        res["release_tensors_equal"] = n_equal + len(stats)
        del rel, svae
        torch.cuda.empty_cache()

        # DINOv2 through a .safetensors file and the port's reader
        st = os.path.join(work, "dinov2.safetensors")
        timed("safetensors_write", lambda: write_safetensors(
            dino.state_dict(), st))
        sd = timed("safetensors_read", lambda: wc.convert_dinov2(
            wc.load_torch_checkpoint(st)))
        dino2 = DinoV2(dtype=torch.bfloat16)
        dino2.load_state_dict(sd)
        dino2 = dino2.to(dev).eval()
        if not all(torch.equal(dino2.state_dict()[k], v)
                   for k, v in dino.state_dict().items()):
            raise AssertionError("DINOv2 changed through .safetensors")
        res["safetensors_bytes"] = os.path.getsize(st)
        os.remove(st)
        del sd

        # the video file -> frames -> mattes -> tokens
        modnet = init_random_(MODNet(), seed=40).to(dev).eval()
        matting_fn = make_matting_fn(modnet)
        frames = seeded_frames()
        video = os.path.join(work, "video.mp4")
        frames_dir = os.path.join(work, "frames")
        res["video"] = "none"
        if routes["cv2"]:
            def write_video():
                w = StreamingVideoWriter(video, fps=8)
                for f in frames:
                    w.append(f)
                return w.close()
            res["video"] = "mp4" if timed("video_write",
                                          write_video) else ".npy"
        if res["video"] == "mp4":
            n = timed("extract_frames", lambda: extract_frames(
                video, frames_dir))
            res["frames_from"] = "ffmpeg" if routes["ffmpeg"] else "cv2"
            if n != T:
                raise AssertionError(f"extract_frames gave {n} of {T}")
            reset_counts()
            feats = timed("encode_video_features", lambda: (
                encode_video_features(frames_dir, os.path.join(
                    work, "dinov2_features.npz"), dino,
                    matting_fn=matting_fn, device="cuda")))
            launches = read_counts()
            decoded = [read_image(os.path.join(frames_dir,
                                               f"frame_{i:04d}.png"))
                       for i in range(T)]
            res["decoded_psnr"] = round(float(10 * np.log10(255.0 ** 2 / max(
                np.mean((np.stack(decoded).astype(np.float64)
                         - frames) ** 2), 1e-12))), 2)
        else:
            log(f"[wild-files] no video written ({res['video']}): the "
                "frames in memory stand for the extracted ones")
            res["frames_from"] = "memory"
            decoded = list(frames)
            feats = None
        alphas = timed("matting_32", lambda: [matting_fn(f)
                                              for f in decoded])
        a = np.stack(alphas)
        if not (a.shape == (T, 518, 518) and np.isfinite(a).all()
                and a.min() >= 0.0 and a.max() <= 1.0):
            raise AssertionError(f"mattes: shape {a.shape}, range "
                                 f"[{a.min()}, {a.max()}]")
        res["matte_mean"] = round(float(a.mean()), 4)
        if feats is None:
            reset_counts()
            feats = timed("encode_video", lambda: encode_video(
                decoded, dino, alphas=alphas).cpu().numpy())
            launches = read_counts()
        tokens = torch.from_numpy(feats).to(dev)
        mem = encode_video(decoded, dino, alphas=alphas)
        res["features_vs_encode_video"] = rel_l2(tokens, mem)
        if tuple(tokens.shape) != (T, L_IMG, 1024) or not (
                bool(torch.isfinite(tokens).all())
                and res["features_vs_encode_video"] <= RUN_REL_BOUND):
            raise AssertionError("encode_video_features disagrees with "
                                 "encode_video")
        if launches["attention"] != 24:
            raise AssertionError(f"{launches['attention']} K5 launches in "
                                 "the features' encode, not 24")
        del mem

        # DINOv2 at 224^2: K5 at [32, 261, 16, 64]
        reset_counts()
        t224 = timed("encode_224", lambda: encode_video(
            decoded, dino2, image_size=224, alphas=alphas))
        n224 = read_counts()["attention"]
        batch = resize_bilinear(torch.from_numpy(np.stack(
            [normalize_frame(f, a) for f, a in zip(decoded, alphas)])).to(
                dev), (224, 224))
        res["dino224_vs_plain"] = rel_l2(t224, encode_image(
            dino2, batch, impl="plain"))
        if tuple(t224.shape) != (T, L_IMG224, 1024) or n224 != 24 or not (
                bool(torch.isfinite(t224).all())
                and res["dino224_vs_plain"] <= DINO_REL_BOUND):
            raise AssertionError(f"DINOv2 at 224^2: {tuple(t224.shape)}, "
                                 f"{n224} launches, rel_l2 "
                                 f"{res['dino224_vs_plain']:.3e}")
        del dino2, t224, batch
        torch.cuda.empty_cache()

        # RGB in, MODNet's alpha, CLIP's score, the whole chain
        rgb = seeded_image()[..., :3]
        tpipe.matting_fn = matting_fn
        g = torch.Generator(device=dev).manual_seed(33)
        pre = torch.from_numpy(tpipe.preprocess_image(rgb))[None]
        z = tpipe.sample_ss_latent(tpipe.encode_image(pre), g)
        k, gap, parents = calibrate_occupancy(tpipe, z)
        res["occupancy"] = {"rank": k, "parents": parents}
        clip = init_random_(CLIPImageEncoder(), seed=41).to(dev).eval()
        clip_fn = make_clip_score_fn(clip, tpipe.preprocess_image(rgb))
        opts = bench_render_options()
        v4d = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(
            steps=32, order=2, kv_quant="int8", self_quant="int8"))
        wild = InTheWildPipeline(tpipe, v4d, InTheWildConfig(
            align_n_angles=360, render_views=16), clip_score_fn=clip_fn,
            render_options=opts)
        out = timed("wild_run", lambda: wild.run(
            rgb, tokens, generator=torch.Generator(device=dev).manual_seed(
                33)))
        check_outputs(out, B, T, G)
        res["align_angle_deg"] = round(math.degrees(out["align_angle"]), 2)
        res["valid_gaussians"] = int(out["valid"].sum())
        if res["valid_gaussians"] == 0 or parents > TORSO:
            raise AssertionError(f"{res['valid_gaussians']} Gaussians, "
                                 f"{parents} parents for {TORSO} slots")

        # stage 6: the orbit sweep to the spiral video and frames.npy
        out_dir = os.path.join(work, "out")
        frames_out = timed("render_outputs", lambda: wild.render_outputs(
            dict(out, deltas=out["deltas"] * RENDER_DELTA_SCALE), out_dir))
        spiral = os.path.join(out_dir, "spiral.mp4")
        res["spiral"] = "mp4" if os.path.exists(spiral) else ".npy"
        if res["spiral"] == "mp4":
            res["spiral_bytes"] = os.path.getsize(spiral)
        else:
            res["spiral_frames"] = list(np.load(spiral + ".npy",
                                                mmap_mode="r").shape)
        on_disk = np.load(os.path.join(out_dir, "frames.npy"), mmap_mode="r")
        cover = float((frames_out < 1.0 - 1e-3).any(-1).mean())
        res["frames_npy"] = list(on_disk.shape)
        res["coverage"] = round(cover, 4)
        if not (on_disk.shape == (T, 16, 512, 512, 3)
                and np.isfinite(frames_out).all() and cover > 0
                and (res["spiral"] == ".npy" or res["spiral_bytes"] > 0)):
            raise AssertionError("render_outputs wrote no frames")
    finally:
        tpipe.matting_fn = None
        shutil.rmtree(work, ignore_errors=True)
    res["times_ms"] = times
    res["phase_s"] = round(time.perf_counter() - t_phase, 1)
    log(f"[wild-files] the phase in {res['phase_s']} s; release "
        f"{times['release_write']:.1f} ms written, "
        f"{times['release_load']:.1f} ms loaded ({res['release_tensors_equal']}"
        f" tensors equal); DINOv2 .safetensors {res['safetensors_bytes']} "
        f"bytes; video {res['video']}, frames from {res['frames_from']}; "
        f"features vs encode_video rel_l2 "
        f"{res['features_vs_encode_video']:.3e} (bound {RUN_REL_BOUND:g}); "
        f"DINOv2 224^2 vs plain rel_l2 {res['dino224_vs_plain']:.3e} (bound "
        f"{DINO_REL_BOUND:g}), K5 launches {n224}; wild run "
        f"{times['wild_run']:.1f} ms, angle {res['align_angle_deg']} deg; "
        f"render_outputs {times['render_outputs']:.1f} ms, spiral "
        f"{res['spiral']}; {card}")
    log("[wild-files] " + json.dumps(res))
    return {"attention_dino224": n224}


def phase_early_exit(dev, card):
    """Early exit where tiles saturate, which the random-weight TRELLIS
    splat's tiles do not: the seeded canonical splat with its opacity
    logits raised by OPAQUE_LOGIT and its scales times OPAQUE_SCALE, so
    that the first round's 128 Gaussians cover every pixel of a 64^2 tile.
    Eight orbit views at 512^2 in one render_views batch through bench.py's
    rasterizer, against its scan form: they must differ (a tile stopped)
    by no more than the bound."""
    import torch
    from gvfdiffusion_torch.render.renderer import GaussianRenderer
    from gvfdiffusion_torch.representations.gaussians import from_activated
    from gvfdiffusion_torch.utils.inference_utils import render_sweep

    act, valid = canonical_splat(dev)
    gs = from_activated(act[0])
    gs = dataclasses.replace(
        gs, _opacity=gs._opacity + OPAQUE_LOGIT,
        _scaling=gs._scaling + math.log(OPAQUE_SCALE))
    opts = bench_render_options()
    frames, ms = {}, {}
    for key, ee in (("early_exit", True), ("no_early_exit", False)):
        r = GaussianRenderer(dataclasses.replace(opts, early_exit=ee))
        sweep = lambda: render_sweep(r, gs, None, valid[0], num_views=8,
                                     resolution=512)
        sweep()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames[key] = sweep()
        torch.cuda.synchronize()
        ms[key] = (time.perf_counter() - t0) * 1e3
    err = rel_l2(frames["early_exit"], frames["no_early_exit"])
    coverage = float((frames["early_exit"] < 1.0 - 1e-3).any(-1).float()
                     .mean())
    log(f"[early_exit] opaque splat (opacity logits + {OPAQUE_LOGIT:g}, "
        f"scales x {OPAQUE_SCALE:g}), 8 views at 512^2, coverage "
        f"{coverage:.4f}: early exit {ms['early_exit']:.1f} ms, "
        f"no_early_exit {ms['no_early_exit']:.1f} ms, rel_l2 {err:.3e} "
        f"(bounds (0, {OPAQUE_SWEEP_BOUND:g}]); {card}")
    if not (bool(torch.isfinite(frames["early_exit"]).all())
            and 0 < err <= OPAQUE_SWEEP_BOUND):
        raise AssertionError("early exit on the opaque splat: stopped no tile "
                             "or disagrees")


def phase_trellis_defaults(dino, dev, card):
    """TRELLIS at its defaults: SLatFlowModel(torso_capacity=None) and
    TrellisConfig() (32768 voxel slots), the seeded weights of
    phase_trellis, so the torso's full self-attention takes K7 over all
    32768 slots. The occupancy is calibrated as there (parents <= 4096,
    about a trained model's torso count). One timed run() with its launches
    counted; one SLat forward, kernels vs impl="plain", on run()'s
    structure; run()'s SLat against the compacted torso's (4096 slots, K5)
    on the same structure, conditioning and noise: the same function on
    the valid voxels. Returns K7's launches in run()."""
    import torch
    from gvfdiffusion_torch.models.trellis.slat_flow import SLatFlowModel
    from gvfdiffusion_torch.pipelines.trellis_image_to_3d import TrellisConfig

    if TrellisConfig().voxel_capacity != SLOTS:
        raise AssertionError("TrellisConfig's default voxel capacity moved")
    pipe = build_trellis(dino, dev, torso=None, voxels=SLOTS)
    image = seeded_image()
    pre = torch.from_numpy(pipe.preprocess_image(image))[None]
    g = torch.Generator(device=dev).manual_seed(31)
    z = pipe.sample_ss_latent(pipe.encode_image(pre), g)
    k, gap, parents = calibrate_occupancy(pipe, z)
    log(f"[trellis32k] occupancy bias set at rank {k} (largest logit gap "
        f"{gap:.4g}): {parents} parents at 32^3")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = pipe.run(image, torch.Generator(device=dev).manual_seed(31))
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = {k_: n for k_, n in read_counts().items() if n}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st, cond, gs, valid = (out[k_] for k_ in ("structure", "cond",
                                              "gaussians", "valid"))
    n_occ = int(st.valid.sum())
    act = gs.to_activated_tensor()
    log(f"[trellis32k] run() at the defaults (torso_capacity=None, "
        f"{SLOTS} voxel slots): {run_ms:.1f} ms; n_occ {n_occ}, valid "
        f"Gaussians {int(valid.sum())} of {valid.shape[1]}; peak "
        f"{peak:.2f} GiB; launches {launches}; {card}")
    want = {"attention": 24 + 576, "attention_cross": 576,
            "flash_attention": 528, "cross_single": 528}
    if launches != want:
        raise AssertionError(f"TRELLIS defaults launches {launches}, "
                             f"expected {want}")
    if not (0 < n_occ <= SLOTS and tuple(act.shape) == (1, SLOTS * 8, 14)
            and bool(torch.isfinite(act).all())):
        raise AssertionError("TRELLIS defaults: empty structure or "
                             "non-finite Gaussians")

    # one SLat forward, kernels vs plain, on run()'s structure
    m = st.valid[0]
    ch = pipe.slat_flow.in_channels
    xs = st.replace_feats(torch.randn(1, SLOTS, ch, generator=g, device=dev)
                          * st.valid[..., None])
    t = torch.tensor([1000.0], device=dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = pipe.slat_flow(xs, t, cond).feats
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        y_p = pipe.slat_flow(xs, t, cond, impl="plain").feats
    fwd_err = rel_l2(y[0][m], y_p[0][m])

    # run()'s SLat against the compacted torso's, with run()'s noise
    gen = torch.Generator(device=dev).manual_seed(31)
    torch.randn(z.shape, generator=gen, device=dev)  # the ss noise
    n2 = torch.randn((1, SLOTS, ch), generator=gen, device=dev)
    compacted = SLatFlowModel(qk_rms_norm=True, torso_capacity=TORSO,
                              dtype=torch.bfloat16).to(dev)
    compacted.load_state_dict(pipe.slat_flow.state_dict())
    uncompacted, pipe.slat_flow = pipe.slat_flow, compacted
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slat_c = pipe.sample_slat(st, cond, noise_feats=n2)
    torch.cuda.synchronize()
    comp_ms = (time.perf_counter() - t0) * 1e3
    comp_launches = {k_: n for k_, n in read_counts().items() if n}
    pipe.slat_flow = uncompacted
    slat_err = rel_l2(out["slat"].feats[0][m], slat_c.feats[0][m])
    log(f"[trellis32k] one SLat forward ({n_occ} voxels in {SLOTS} slots) "
        f"{fwd_ms:.1f} ms, kernels vs plain rel_l2 {fwd_err:.3e} (bound "
        f"{TRELLIS32K_BOUNDS['forward']:g}); run()'s SLat vs the compacted "
        f"torso's ({TORSO} slots, K5; sample_slat {comp_ms:.1f} ms, launches "
        f"{comp_launches}) rel_l2 {slat_err:.3e} (bound "
        f"{TRELLIS32K_BOUNDS['compacted']:g}); {card}")
    if not (fwd_err <= TRELLIS32K_BOUNDS["forward"]
            and slat_err <= TRELLIS32K_BOUNDS["compacted"]
            and comp_launches.get("attention_bias") == 528):
        raise AssertionError("TRELLIS defaults disagree with the plain path "
                             "or with the compacted torso")
    return launches["flash_attention"]


# TRELLIS-image-large as the registry builds it from a pretrained directory
# in the reference's layout: per model key, its registry name, release-style
# arguments (the released configs' keys, `use_fp16` included, which the
# registry drops, so every model is fp32; the widths of the JAX classes'
# defaults) and the init_random_ seed of build_trellis's (and DINOv2's
# build_models) weights, so the bf16 runs of [trellis-drift] share them;
# the two flows at FP32_FLOW_BLOCKS blocks, cut from the release's 24 (the
# smoke's time limit: the pretrained directory's size, the build and the
# SLat flow's steps halve)
FP32_FLOW_BLOCKS = 12
PRETRAINED = {
    "image_cond_model": ("DinoV2", {}, 10),
    "ss_flow": ("SparseStructureFlowModel", dict(
        resolution=16, in_channels=8, out_channels=8, model_channels=1024,
        cond_channels=1024, num_blocks=FP32_FLOW_BLOCKS,
        num_head_channels=64,
        mlp_ratio=4, patch_size=2, pe_mode="ape", qk_rms_norm=True,
        use_fp16=True), 20),
    "ss_decoder": ("SparseStructureDecoder", dict(
        out_channels=1, latent_channels=8, num_res_blocks=2,
        num_res_blocks_middle=2, channels=[512, 128, 32], use_fp16=True), 21),
    "slat_flow": ("SLatFlowModel", dict(
        resolution=64, in_channels=8, out_channels=8, model_channels=1024,
        cond_channels=1024, num_blocks=FP32_FLOW_BLOCKS,
        num_head_channels=64,
        mlp_ratio=4, patch_size=2, num_io_res_blocks=2,
        io_block_channels=[128], pe_mode="ape", qk_rms_norm=True,
        use_fp16=True), 22),
    "slat_decoder_gs": ("ElasticSLatGaussianDecoder", dict(
        resolution=64, model_channels=768, latent_channels=8, num_blocks=12,
        num_head_channels=64, mlp_ratio=4, attn_mode="swin", window_size=8,
        use_fp16=True, representation_config={
            "lr": {"_xyz": 1.0, "_features_dc": 1.0, "_opacity": 1.0,
                   "_scaling": 1.0, "_rotation": 0.1},
            "perturb_offset": True, "voxel_size": 1.5, "num_gaussians": 32,
            "2d_filter_kernel_size": 0.1, "3d_filter_kernel_size": 9e-4,
            "scaling_bias": 4e-3, "opacity_bias": 0.1,
            "scaling_activation": "softplus"}), 23),
}
# the launches of one TrellisImageTo3DPipeline.run() of that TRELLIS: K5
# (computing in bf16 from fp32 q/k/v) in DINOv2 (24) and the ss flow (24
# model calls a block, self and cross: 12 steps with CFG), K7 and K3's
# single context in fp32 (22 a block: the SLat flow's CFG interval)
FP32_LAUNCHES = {"attention": 24 + 24 * FP32_FLOW_BLOCKS,
                 "attention_cross": 24 * FP32_FLOW_BLOCKS,
                 "flash_attention_fp32": 22 * FP32_FLOW_BLOCKS,
                 "cross_single_fp32": 22 * FP32_FLOW_BLOCKS}
# the shipped bf16 models against the fp32 run, each stage on the fp32
# stage's output (the same weights, image and noise): rel L2 of the DINOv2
# tokens, the ss latent and the SLat (valid voxels; the torso compacted to
# 4096 slots and uncompacted at 32768), occupancy flips per occupied voxel,
# and a floor in dB on each Gaussian attribute's PSNR (10 log10(range^2 /
# mse) over the fp32 values, valid Gaussians). Bounds at 4-5x the readings
# on an H100 80GB HBM3 (700 W) in the comments; the floor 12 dB under the
# lowest attribute at the release's 32 Gaussians a voxel (62.7 dB; the
# others 62.9-88.5)
DRIFT_BOUNDS = {"cond": 3e-2,            # 6.1e-3
                "ss_latent": 4e-2,       # 9.2e-3
                "flips": 0.06,           # 50 of 4154, 1.2%
                "slat_compacted": 2e-2,  # 4.6e-3
                "slat_32k": 2e-2}        # 4.6e-3
DRIFT_PSNR_FLOOR = 50.0


def write_pretrained(root: str) -> None:
    """A pretrained directory in the reference's layout (pipeline.json;
    per model <key>.json with {"name", "args"} and <key>.npz, the flax-flat
    parameters of the port's seeded weights through the class's weight
    table, registry.flax_params)."""
    from gvfdiffusion_torch.models import registry
    from gvfdiffusion_torch.utils.weights import init_random_

    for key, (name, args, seed) in PRETRAINED.items():
        model = init_random_(registry.create_model(name, **args), seed)
        registry.save_params_npz(registry.flax_params(name, args, model),
                                 os.path.join(root, f"{key}.npz"))
        with open(os.path.join(root, f"{key}.json"), "w") as f:
            json.dump({"name": name, "args": args}, f)
        del model
    with open(os.path.join(root, "pipeline.json"), "w") as f:
        json.dump({"name": "TrellisImageTo3DPipeline",
                   "models": {k: k for k in PRETRAINED}}, f)


def phase_trellis_fp32(dev, card):
    """TRELLIS as the registry builds it: the pretrained directory written
    into a temporary directory, every model from
    `registry.from_pretrained` (fp32, the SLat torso uncompacted at 32768
    voxel slots: TrellisConfig's defaults), the occupancy calibrated as in
    [trellis32k]; the stages one by one (timed, launches per stage), then
    run() (timed, its launches checked), which must give what the stages
    gave. Returns (pipeline, the stages' outputs, preprocessed image, K7's
    and K3's fp32 launches in run())."""
    import tempfile

    import torch
    from gvfdiffusion_torch.models import registry
    from gvfdiffusion_torch.pipelines.trellis_image_to_3d import (
        TrellisConfig, TrellisImageTo3DPipeline)

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_pretrained(root)
        t1 = time.perf_counter()
        spec = registry.load_pipeline_spec(root)
        m = {k: registry.from_pretrained(root, rel, device=dev)
             for k, rel in spec["models"].items()}
        t2 = time.perf_counter()
        size = sum(os.path.getsize(os.path.join(root, f))
                   for f in os.listdir(root)) / 2 ** 30
    if not (all(p.dtype == torch.float32 for mod in m.values()
                for p in mod.parameters())
            and m["slat_flow"].torso_capacity is None
            and m["slat_flow"].dtype == torch.float32):
        raise AssertionError("the registry did not build fp32 TRELLIS with "
                             "an uncompacted torso")
    log(f"[trellis-fp32] pretrained directory ({size:.2f} GiB of .npz) "
        f"written in {t1 - t0:.1f} s, {len(m)} models built by "
        f"registry.from_pretrained in {t2 - t1:.1f} s, every parameter "
        f"fp32; {card}")
    mean, std = slat_stats()
    pipe = TrellisImageTo3DPipeline(
        m["image_cond_model"], m["ss_flow"], m["ss_decoder"], m["slat_flow"],
        m["slat_decoder_gs"], TrellisConfig(), mean, std, device=dev)
    image = seeded_image()
    pre = torch.from_numpy(pipe.preprocess_image(image))[None]
    staged = trellis_stages(pipe, pre, 31, card, calibrate=True,
                            tag="[trellis-fp32]")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = pipe.run(image, torch.Generator(device=dev).manual_seed(31),
                   formats=("gaussian",))
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: n for k, n in read_counts().items() if n}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st, gs, valid = out["structure"], out["gaussians"], out["valid"]
    n_occ = int(st.valid.sum())
    parents = _parents(st.to_dense()[0, ..., 0] != 0) if n_occ else 0
    act = gs.to_activated_tensor()
    per_voxel = PRETRAINED["slat_decoder_gs"][1]["representation_config"][
        "num_gaussians"]
    log(f"[trellis-fp32] run(): {run_ms:.1f} ms; n_occ {n_occ}, parents "
        f"{parents}, dropped {max(n_occ - SLOTS, 0)}, valid Gaussians "
        f"{int(valid.sum())} of {valid.shape[1]}; peak {peak:.2f} GiB; "
        f"launches {launches}; {card}")
    if launches != FP32_LAUNCHES:
        raise AssertionError(f"fp32 TRELLIS launches {launches}, expected "
                             f"{FP32_LAUNCHES}")
    if not (0 < n_occ <= SLOTS
            and tuple(act.shape) == (1, SLOTS * per_voxel, 14)
            and bool(torch.isfinite(act).all())
            and bool(torch.isfinite(out["slat"].feats).all())):
        raise AssertionError("fp32 TRELLIS: empty or dropped structure, or "
                             "non-finite outputs")
    same = (_voxel_set(st) == _voxel_set(staged["structure"])
            and rel_l2(out["slat"].feats, staged["slat"].feats)
            <= RUN_REL_BOUND
            and rel_l2(act, staged["gs"].to_activated_tensor())
            <= RUN_REL_BOUND)
    if not same:
        raise AssertionError("fp32 TRELLIS run() disagrees with its stages")
    return pipe, staged, pre, launches


def _psnr(a, b) -> float:
    """10 log10(range(b)^2 / mse) over b's values, as docs/PARITY.md."""
    mse = float((a.double() - b.double()).square().mean())
    rng = float(b.max() - b.min())
    return 10 * math.log10(rng * rng / max(mse, 1e-300))


def bf16_twin(key, fp32, dev, args=None, **kw):
    """The shipped bf16 form of PRETRAINED's model `key` (its release
    arguments, or `args`, and `kw`), built by registry.create_model with
    dtype bf16 and loaded with the fp32 model's weights."""
    import torch
    from gvfdiffusion_torch.models import registry

    name, release, _ = PRETRAINED[key]
    model = registry.create_model(name, **(args or release), **kw,
                                  dtype=torch.bfloat16)
    model.load_state_dict(fp32.state_dict())
    return model.to(dev).eval()


def phase_trellis_drift(pipe32, staged, pre, dev, card):
    """The shipped bf16 models (the same weights, image and noise) against
    the fp32 run, stage by stage, each stage on the fp32 stage's output so
    that occupancy flips do not hide the flows' drift: DINOv2's tokens, the
    ss latent, the occupancy (flips), the SLat on the fp32 structure with
    the torso compacted to 4096 slots and uncompacted at 32768, and each
    Gaussian attribute of the decode of the fp32 SLat (max abs, PSNR)."""
    import copy

    import torch

    bf = torch.bfloat16
    pipe = copy.copy(pipe32)
    pipe.dinov2 = bf16_twin("image_cond_model", pipe32.dinov2, dev)
    pipe.ss_flow = bf16_twin("ss_flow", pipe32.ss_flow, dev)
    pipe.ss_decoder = bf16_twin("ss_decoder", pipe32.ss_decoder, dev)
    pipe.slat_decoder = bf16_twin("slat_decoder_gs", pipe32.slat_decoder,
                                  dev)
    torsos = {"slat_compacted": TORSO, "slat_32k": None}
    st32, cond32 = staged["structure"], staged["cond"]
    g = torch.Generator(device=dev).manual_seed(31)
    n1 = torch.randn(staged["z"].shape, generator=g, device=dev)
    n2 = torch.randn((1, SLOTS, 8), generator=g, device=dev)
    m = st32.valid[0]
    n_occ = int(m.sum())
    t0 = time.perf_counter()
    errs = {"cond": rel_l2(pipe.encode_image(pre), cond32),
            "ss_latent": rel_l2(pipe.sample_ss_latent(cond32, noise=n1),
                                staged["z"])}
    flipped = len(_voxel_set(pipe.decode_structure(staged["z"]))
                  ^ _voxel_set(st32))
    errs["flips"] = flipped / n_occ
    times = {}
    for k, torso in torsos.items():
        pipe.slat_flow = bf16_twin("slat_flow", pipe32.slat_flow, dev,
                                   torso_capacity=torso)
        t1 = time.perf_counter()
        slat = pipe.sample_slat(st32, cond32, noise_feats=n2)
        torch.cuda.synchronize()
        times[k] = (time.perf_counter() - t1) * 1e3
        errs[k] = rel_l2(slat.feats[0][m], staged["slat"].feats[0][m])
        pipe.slat_flow = None
    gs, valid = pipe.decode_slat(staged["slat"])
    gs32, vm = staged["gs"], staged["valid"][0]
    attrs = {}
    for a in ("_xyz", "_features_dc", "_scaling", "_rotation", "_opacity"):
        x, ref = getattr(gs, a)[0][vm].float(), getattr(gs32, a)[0][vm]
        attrs[a] = (float((x - ref).abs().max()), _psnr(x, ref))
    log(f"[trellis-drift] bf16 vs fp32, each stage on the fp32 stage's "
        f"output ({time.perf_counter() - t0:.1f} s; sample_slat compacted "
        f"{times['slat_compacted']:.1f} ms, at {SLOTS} slots "
        f"{times['slat_32k']:.1f} ms): DINOv2 tokens rel_l2 "
        f"{errs['cond']:.3e}, ss latent {errs['ss_latent']:.3e}, occupancy "
        f"flips {flipped} of {n_occ} ({100 * errs['flips']:.2f}%), SLat on "
        f"the fp32 structure: torso compacted to {TORSO} "
        f"{errs['slat_compacted']:.3e}, uncompacted at {SLOTS} "
        f"{errs['slat_32k']:.3e} (bounds {DRIFT_BOUNDS}); {card}")
    log("[trellis-drift] Gaussian decode of the fp32 SLat, per attribute "
        "(bf16 vs fp32 on the valid Gaussians): " + ", ".join(
            f"{a} max abs {mx:.3e}, {db:.1f} dB" for a, (mx, db)
            in attrs.items()) + f" (floor {DRIFT_PSNR_FLOOR:g} dB)")
    if any(errs[k] > b for k, b in DRIFT_BOUNDS.items()) or any(
            not db >= DRIFT_PSNR_FLOOR for _, db in attrs.values()):
        raise AssertionError("bf16 TRELLIS drifts past its bounds")
    return errs, attrs


HEADS_STEPS = 1  # the SLat flow's steps in [trellis-heads], cut from 12


def phase_trellis_heads(pipe32, staged, dev, card):
    """The SLat flow at the torso's other head widths: for heads of 32 and
    128, the model built by registry.create_model from PRETRAINED's
    release arguments with that `num_head_channels` (init_random_ weights;
    fp32, as the registry builds it) and its shipped bf16 twin, each
    through the pipeline's sample_slat on the fp32 run's structure and
    conditioning, the torso uncompacted at 32768 slots, HEADS_STEPS steps.
    So K7 and K3's single context run at those widths in both dtypes on a
    model's path. Checks: finite; K7 and K3 launched the same number of
    times, a multiple of the blocks, and nothing else; bf16 within
    DRIFT_BOUNDS["slat_32k"] of fp32 on the valid voxels. Returns the
    launches."""
    import copy
    import dataclasses

    import torch
    from gvfdiffusion_torch.models import registry
    from gvfdiffusion_torch.ops import flash_attention as fl
    from gvfdiffusion_torch.ops import fused_sublayer as fsl
    from gvfdiffusion_torch.utils.weights import init_random_

    pipe = copy.copy(pipe32)
    pipe.cfg = dataclasses.replace(pipe32.cfg, slat_steps=HEADS_STEPS)
    st, cond = staged["structure"], staged["cond"]
    m = st.valid[0]
    name, release, seed = PRETRAINED["slat_flow"]
    g = torch.Generator(device=dev).manual_seed(35)
    noise = torch.randn((1, SLOTS, 8), generator=g, device=dev)
    launches = {}
    for width in (32, 128):
        args = dict(release, num_head_channels=width)
        fp32 = init_random_(registry.create_model(name, **args), seed)
        fp32 = fp32.to(dev).eval()
        feats = {}
        for dt in (torch.float32, torch.bfloat16):
            pipe.slat_flow = fp32 if dt == torch.float32 else bf16_twin(
                "slat_flow", fp32, dev, args=args)
            keys = (fl.launch_key(dt, width), fsl.single_launch_key(dt, width))
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            slat = pipe.sample_slat(st, cond, noise_feats=noise)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = {k: n for k, n in read_counts().items() if n}
            feats[dt] = slat.feats[0][m]
            n = got.get(keys[0], 0)
            log(f"[trellis-heads] SLat flow at {1024 // width} heads of "
                f"{width}, {str(dt)[6:]}, {SLOTS} slots ({int(m.sum())} "
                f"valid), sample_slat {HEADS_STEPS} steps: {ms:.1f} ms, "
                f"launches {got}; {card}")
            if not (n > 0 and n % len(fp32.blocks) == 0
                    and got == {k: n for k in keys}
                    and bool(torch.isfinite(slat.feats).all())):
                raise AssertionError(f"the SLat flow at heads of {width} "
                                     f"({dt}) did not run its kernels")
            launches.update(got)
        pipe.slat_flow = None
        del fp32
        err = rel_l2(feats[torch.bfloat16], feats[torch.float32])
        log(f"[trellis-heads] heads of {width}: bf16 vs fp32 SLat rel_l2 "
            f"{err:.3e} (bound {DRIFT_BOUNDS['slat_32k']:g})")
        if not err <= DRIFT_BOUNDS["slat_32k"]:
            raise AssertionError(f"the SLat flow at heads of {width}: bf16 "
                                 "drifts past its bound")
    return launches


def _kernel_group(name: str) -> str:
    for k in ("attn_sm90_q8_kernel", "attn_sm90_kernel", "gemm_sm90_kernel",
              "temporal_sm90_kernel", "attn_tf32_kernel",
              "gemm_tf32_kernel", "ln_affine_f32_kernel", "ln_kernel",
              "split_tf32_kernel",
              "flash_bwd_dkv_tf32_kernel", "flash_bwd_dq_tf32_kernel",
              "tile_list_kernel", "empty_rows_kernel",
              "q8_kernel"):
        if k in name:
            return k
    if any(k in name for k in ("fmha", "flash", "attention")):
        return "SDPA"
    if "conv" in name.lower():
        return "cuDNN conv"
    if any(k in name for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return "cuBLAS GEMM"
    if any(k in name for k in ("gather", "scatter", "index", "Sort", "sort")):
        return "gather/scatter/sort"
    return "other"


def _profile(fn, what: str, trace, card: str) -> None:
    """torch.profiler over one call of fn (after a warm-up): device time by
    kernel group and the device's busy share of the wall time; the Chrome
    trace is written to the file `trace` of the output directory below
    (none when trace is None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, rows = {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3, e.count, e.key))
        k = _kernel_group(e.key)
        groups[k] = groups.get(k, 0.0) + us / 1e3
    busy = sum(groups.values())
    log(f"[profile] {what}: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}% of wall); {card}")
    if busy == 0:
        raise AssertionError("the profiler saw no device time")
    for k, ms in sorted(groups.items(), key=lambda kv_: -kv_[1]):
        log(f"[profile]   {k}: {ms:.1f} ms ({100 * ms / busy:.1f}% of device)")
    for ms, n, name in sorted(rows, reverse=True)[:12]:
        log(f"[profile]   {ms:9.2f} ms  x{n:<5d} {name[:110]}")
    if trace is not None:
        out = os.path.join(REPO, "chiprun_out")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, trace))


def int8_cache(kv, heads):
    """An int8 cache of float (k, v) as the DiT builds it: quantize_kv, the
    k scales transposed to [B, H, Lk]."""
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    kq, ks = fsl.quantize_kv(kv[0], heads)
    vq, vs = fsl.quantize_kv(kv[1], heads)
    return kq, vq, ks.transpose(1, 2).contiguous(), vs


def phase_profile_split(dev, card, traces=True):
    """Device time by kernel name inside K1's-K5's chains (ln_kernel, the
    GEMMs, q8_kernel and the attention kernel), three calls each: K1 at
    the shipped DiT's shape ([32, 512, 512], 16 heads of 32), float and
    with int8 QK; K2 there ([1, 32, 512, 512]), float and with int8 QK; K4
    there at M = 2048 and at dit-notemporal's M = 1024; K3 there (two
    contexts: image KV 1374, static 512), on the float and on the int8
    cache; K3's single context at the
    compacted torso's 4096 rows and at the defaults' 32768 (bf16, 16 heads
    of 64, 1374 image tokens) and in fp32 at 32768 rows (the registry's
    fp32 TRELLIS); K5 at DINOv2's [32, 1374, 16, 64]; K6 at the DiT's
    training shapes, [2, 24, 512, 16, 32] and [2, 24, 512, 8, 64] fp32
    (q / k apart, v a view of a qkv); and K7 at the
    defaults' torso, [1, 32768, 16, 64] with 3700 valid keys as a prefix,
    in bf16 and in fp32; K7's backward kernels, dkv (with the zeroing of
    dK and dV) and dq, at the static VAE's [2, 32768, 12, 64] fp32 over
    its two surface shells (traces split_*_trace.json, with `traces`)."""
    import torch
    from gvfdiffusion_torch.ops import flash_attention as fl
    from gvfdiffusion_torch.ops import fused_attention as fa
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    g = torch.Generator(device=dev).manual_seed(1)
    cases = sublayer_cases(dev, g)
    r = lambda *s_, sc=1.0: torch.randn(*s_, generator=g, device=dev) * sc
    Cx = 1024
    x32k = r(1, SLOTS, Cx)
    p32k = tuple(a.bfloat16() for a in (
        1 + 0.1 * r(Cx), 0.1 * r(Cx), r(Cx, Cx, sc=Cx ** -0.5), 0.1 * r(Cx),
        r(Cx, Cx, sc=Cx ** -0.5), 0.1 * r(Cx)))
    kv32k = r(1, L_IMG, 2 * Cx).bfloat16()
    p32f, kv32f = tuple(a.float() for a in p32k), kv32k.float()
    fq, fk = r(1, SLOTS, 16, 64), r(1, SLOTS, 16, 64)
    fv = r(1, SLOTS, 3, 16, 64)[:, :, 2]
    fvalid = torch.zeros(1, SLOTS, dtype=torch.bool, device=dev)
    fvalid[:, :L_FLASH_VALID] = True
    fq16, fk16, fv16 = fq.bfloat16(), fk.bfloat16(), fv.bfloat16()
    q, k, v, _, _ = attention_case(dev, "attention")
    self_args, self_kw = cases["self"][1]["args"], cases["self"][1]["kw"]
    x3, p1, kv1, p2, kv2 = cases["cross"][1]["args"]
    c1, c2 = int8_cache(kv1, H), int8_cache(kv2, H)
    tmp_args, tmp_kw = (cases["temporal"][1]["args"],
                        cases["temporal"][1]["kw"])
    mlp_args, mlp_kw = cases["mlp"][1]["args"], cases["mlp"][1]["kw"]
    m1024 = sublayer_cases(dev, torch.Generator(device=dev).manual_seed(1),
                           mlp=1024)["mlp"][1]
    k6 = {}
    for Hh in (H, 8):
        k6[Hh] = (r(TRAIN_B, TRAIN_T, N, Hh, C // Hh),
                  r(TRAIN_B, TRAIN_T, N, Hh, C // Hh),
                  r(TRAIN_B, TRAIN_T, N, 3, Hh, C // Hh)[..., 2, :, :])
    vqkv = r(VAE_B, SLOTS, 3, VAE_H, VAE_D)
    vq, vk, vv = vqkv[:, :, 0], vqkv[:, :, 1], vqkv[:, :, 2]
    vo, vlse, vtiles, vvalid = fl.launch_forward(
        vq, vk, vv, vae_valid(dev), VAE_D ** -0.5, residual=True)
    bwd_ptrs, bwd_sizes, bwd_keep = fl.backward_inputs(
        vq, vk, vv, vvalid, vtiles, vlse, vo, r(VAE_B, SLOTS, VAE_H, VAE_D))

    def three(fn):
        def run():
            with torch.no_grad():
                for _ in range(3):
                    fn()
        return run

    for what, trace, fn in (
            (f"K1 x3 (DiT [{B * T}, {N}, {C}], 16 heads of 32)", "split_k1",
             lambda: fsl.fused_self_sublayer(*self_args, **self_kw)),
            (f"K1 q8 x3 (DiT [{B * T}, {N}, {C}], 16 heads of 32, int8 QK)",
             "split_k1_q8",
             lambda: fsl.fused_self_sublayer(*self_args, **self_kw,
                                             quant_qk=True)),
            (f"K2 x3 (DiT [{B}, {T}, {N}, {C}], 16 heads of 32)",
             "split_k2",
             lambda: fsl.fused_temporal_sublayer(*tmp_args, **tmp_kw)),
            (f"K2 q8 x3 (DiT [{B}, {T}, {N}, {C}], 16 heads of 32, int8 "
             "QK)", "split_k2_q8",
             lambda: fsl.fused_temporal_sublayer(*tmp_args, **tmp_kw,
                                                 quant_qk=True)),
            (f"K4 x3 (DiT [{B * T}, {N}, {C}], M = {M})", "split_k4",
             lambda: fsl.fused_mlp_sublayer(*mlp_args, **mlp_kw)),
            (f"K4 x3 (DiT [{B * T}, {N}, {C}], M = 1024)", "split_k4_m1024",
             lambda: fsl.fused_mlp_sublayer(*m1024["args"], **m1024["kw"])),
            ("K3 x3 (DiT, two contexts, 16 heads of 32)", "split_k3",
             lambda: fsl.fused_cross_sublayer(*cases["cross"][1]["args"],
                                              **cases["cross"][1]["kw"])),
            ("K3 int8 x3 (DiT, two contexts on the int8 cache, 16 heads of "
             "32)", "split_k3_q8",
             lambda: fsl.fused_cross_sublayer(x3, p1, c1, p2, c2,
                                              num_heads=H, quant=True)),
            (f"K3 single x3 ([1, {TORSO}, 1024] x {L_IMG}, 16 heads of 64)",
             "split_k3_single",
             lambda: fsl.fused_cross_sublayer(
                 *cases["cross_single"][1]["args"],
                 **cases["cross_single"][1]["kw"])),
            (f"K3 single x3 ([1, {SLOTS}, 1024] x {L_IMG}, 16 heads of 64)",
             "split_k3_single_32k",
             lambda: fsl.fused_cross_sublayer(
                 x32k, p32k, (kv32k[..., :Cx], kv32k[..., Cx:]),
                 num_heads=16)),
            (f"K3 single fp32 x3 ([1, {SLOTS}, 1024] x {L_IMG}, 16 heads "
             "of 64)", "split_k3_single_fp32",
             lambda: fsl.fused_cross_sublayer(
                 x32k, p32f, (kv32f[..., :Cx], kv32f[..., Cx:]),
                 num_heads=16, compute_dtype=torch.float32)),
            (f"K5 x3 (DINOv2 [{T}, {L_IMG}, 16, 64])", "split_k5",
             lambda: fa.fused_attention(q, k, v, 0.125)),
            (f"K6 x3 ([{TRAIN_B}, {TRAIN_T}, {N}, {H}, {C // H}] fp32)",
             "split_k6",
             lambda: fa.temporal_attention(*k6[H], (C // H) ** -0.5)),
            (f"K6 d64 x3 ([{TRAIN_B}, {TRAIN_T}, {N}, 8, {C // 8}] fp32)",
             "split_k6_d64",
             lambda: fa.temporal_attention(*k6[8], (C // 8) ** -0.5)),
            (f"K7 x3 ([1, {SLOTS}, 16, 64] bf16, {L_FLASH_VALID} valid keys "
             "as a prefix)", "split_k7",
             lambda: fl.flash_attention(fq16, fk16, fv16, fvalid, 0.125)),
            (f"K7 fp32 x3 ([1, {SLOTS}, 16, 64], {L_FLASH_VALID} valid keys "
             "as a prefix)", "split_k7_fp32",
             lambda: fl.flash_attention(fq, fk, fv, fvalid, 0.125)),
            (f"K7 backward dkv x3 ([{VAE_B}, {SLOTS}, {VAE_H}, {VAE_D}] fp32, "
             "the static VAE's shells)", "split_k7_dkv",
             lambda: fl.launch_dkv(bwd_ptrs, bwd_sizes, VAE_D ** -0.5,
                                   torch.float32)),
            (f"K7 backward dq x3 ([{VAE_B}, {SLOTS}, {VAE_H}, {VAE_D}] fp32, "
             "the static VAE's shells)", "split_k7_dq",
             lambda: fl.launch_dq(bwd_ptrs, bwd_sizes, VAE_D ** -0.5,
                                  torch.float32))):
        _profile(three(fn), what, f"{trace}_trace.json" if traces else None,
                 card)
    del bwd_keep


def phase_profile(dino, dit, vae, dev, card):
    """Where the time goes, at full width: a 4-step denoise (guidance
    1.0/1.0, KV hoisted; trace denoise_trace.json), the same on the int8
    cache (denoise_int8_trace.json) and with int8 QK on it
    (denoise_selfq8_trace.json), the DINOv2 encode_image of 32 frames
    (trace encode_trace.json), one forward of each TRELLIS flow and the
    Gaussian decode on the main path's structure (ss_flow_trace.json,
    slat_flow_trace.json, gs_decode_trace.json), and one SLat forward at
    the defaults, 32768 slots with K7 (slat_flow_32k_trace.json)."""
    import torch
    from gvfdiffusion_torch.models.dinov2 import encode_image
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)

    gs, valid = canonical_splat(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    ci = torch.randn(B, T, L_IMG, 1024, generator=g, device=dev)
    pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=4, order=2))
    anchors = pipe.prepare_static_conditioning(gs, valid)
    kv = pipe.cross_kv(ci, anchors)
    _profile(lambda: pipe.sample_deformation_latent(
        ci, anchors, anchors[..., :3], generator=g, cross_kv=kv),
        "4-step denoise (4 DiT forwards, B*T = 32)", "denoise_trace.json",
        card)
    pipe8 = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=4, order=2,
                                                        kv_quant="int8"))
    kv8 = pipe8.cross_kv(ci, anchors)
    _profile(lambda: pipe8.sample_deformation_latent(
        ci, anchors, anchors[..., :3], generator=g, cross_kv=kv8),
        "4-step denoise on the int8 KV cache (4 DiT forwards, B*T = 32)",
        "denoise_int8_trace.json", card)
    pipe8q = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(
        steps=4, order=2, kv_quant="int8", self_quant="int8"))
    _profile(lambda: pipe8q.sample_deformation_latent(
        ci, anchors, anchors[..., :3], generator=g, cross_kv=kv8),
        "4-step denoise with int8 QK on the int8 KV cache (4 DiT forwards, "
        "B*T = 32)", "denoise_selfq8_trace.json", card)
    images = torch.rand(T, 518, 518, 3, generator=g, device=dev)
    _profile(lambda: encode_image(dino, images),
             f"DINOv2 encode_image ({T} frames, 518^2)", "encode_trace.json",
             card)

    # TRELLIS: one forward of each flow (the samplers repeat it 24 and 22
    # times) on the main path's structure, and the Gaussian decode
    pipe = build_trellis(dino, dev)
    pre = torch.from_numpy(pipe.preprocess_image(seeded_image()))[None]
    staged = trellis_stages(pipe, pre, 31, card, calibrate=True)
    cond, st = staged["cond"], staged["structure"]
    t = torch.tensor([1000.0], device=dev)
    x = torch.randn(1, 16, 16, 16, 8, generator=g, device=dev)
    xs = st.replace_feats(torch.randn(1, VOXELS, 8, generator=g, device=dev))
    with torch.no_grad():
        _profile(lambda: pipe.ss_flow(x, t, cond),
                 "sparse-structure flow forward (24 x 1024, [1, 512] tokens)",
                 "ss_flow_trace.json", card)
        _profile(lambda: pipe.slat_flow(xs, t, cond),
                 f"SLat flow forward ({int(st.valid.sum())} voxels, torso "
                 f"{TORSO} slots)", "slat_flow_trace.json", card)
        _profile(lambda: pipe.decode_slat(staged["slat"]),
                 f"SLat Gaussian decode ({VOXELS} slots)",
                 "gs_decode_trace.json", card)
    # TRELLIS at its defaults: one SLat forward over 32768 slots (K7)
    pipe32 = build_trellis(dino, dev, torso=None, voxels=SLOTS)
    z = pipe32.sample_ss_latent(cond, torch.Generator(
        device=dev).manual_seed(31))
    calibrate_occupancy(pipe32, z)
    st32 = pipe32.decode_structure(z)
    xs32 = st32.replace_feats(torch.randn(1, SLOTS, 8, generator=g,
                                          device=dev) * st32.valid[..., None])
    with torch.no_grad():
        _profile(lambda: pipe32.slat_flow(xs32, t, cond),
                 f"SLat flow forward at the defaults ({int(st32.valid.sum())}"
                 f" voxels, torso uncompacted: {SLOTS} slots)",
                 "slat_flow_32k_trace.json", card)
    del pipe, pipe32, staged, dino, dit, vae
    torch.cuda.empty_cache()
    phase_profile_training(dev, card)


def phase_profile_training(dev, card):
    """One training micro-step of the full-width DiT (configs/diffusion.yml,
    batch 2 x 24 frames, fp32, flax's initial weights) on a seeded batch
    already on the card (trace train_step_trace.json)."""
    import torch
    from gvfdiffusion_torch.cli.main_latent import build_model
    from gvfdiffusion_torch.diffusion.gaussian_diffusion import (
        create_diffusion)
    from gvfdiffusion_torch.train.diffusion_trainer import make_train_step
    from gvfdiffusion_torch.train.train_state import (create_train_state,
                                                      make_optimizer)
    from gvfdiffusion_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "diffusion.yml"))
    model = build_model(cfg).init_weights_(
        torch.Generator().manual_seed(0)).to(dev)
    diffusion = create_diffusion(mean_type="v", rescale_timesteps=True).to(dev)
    tx = make_optimizer(grad_accum=cfg.train.grad_accum)
    state = create_train_state(model, tx)
    step = make_train_step(model, diffusion, tx)
    g = torch.Generator(device=dev).manual_seed(24)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    batch = {"latent": rnd(TRAIN_B, TRAIN_T, N, 16),
             "cond_images": rnd(TRAIN_B, TRAIN_T, L_IMG, 1024),
             "static_latent": rnd(TRAIN_B, N, 14),
             "positions": rnd(TRAIN_B, N, 3) * 0.3}
    _profile(lambda: step(state, batch, g),
             f"one training micro-step (12 x 512 DiT, batch {TRAIN_B} x "
             f"{TRAIN_T} frames, fp32)", "train_step_trace.json", card)


# -- [forms]: the kernel forms no main path reaches (K5's segment_size and
# int8 forms, K1's seg, K3's single context with the q RMS norm or an int8
# cache) and the fused DiT block under autograd -----------------------------

# the entries of KERNELS that phase_forms checks, times and counts, each
# driven once through its public wrapper with the counters at 0: its
# launches are that drive's
FORM_KEYS = ("attention_seg_d32", "attention_qk_d32", "attention_qk",
             "attention_qk_bias", "attention_qkav_d32", "attention_qkav",
             "self_seg", "self_seg_q8", "cross_single_rms",
             "cross_single_rms_fp32", "cross_single_q8")
SEG_T = 32                 # K5's segment_size: the infer CLI's T = 32 frames
SEG_VOXELS = 16            # voxels a packed sequence: 16 x 32 = 512 rows
DINO_LOGIT_STD = 3.0       # q, k std at DINOv2's shape: scaled logits ~9 std
# kernel vs plain version, rel L2, at 3-6x the readings measured on an
# H100 80GB HBM3 (700 W) with these seeds: K5's segments (3.7e-5) and against K6 on
# the unpacked data (3.5e-5); int8 QK (4.9e-5, 6.8e-5, 1.4e-4); int8 P V
# (0 at both shapes: where exp2's two implementations straddle a midpoint
# one P step moves a row by at most vm / 127), and against the float form
# (2.9e-2, 4.8e-2; the TPU notes report 14-32% at random inputs); K1 seg
# against K2 on the same data (the same chain: 0); K3 single on an int8
# cache (y 1.2e-5, update 1.2e-4)
SEG_REL_BOUND = 2e-4
SEG_K6_BOUND = 2e-4
QK_REL_BOUND = 6e-4
QKAV_REL_BOUND = 1e-3
QKAV_FLOAT_BOUND = 0.2
SEG_K2_BOUND = 1e-6
SINGLE_Q8_BOUNDS = (6e-5, 6e-4)
# the backward of K1-K4 (and K5 with a key bias) against torch's autograd
# through the same plain function, rel L2 of each gradient: the kernels'
# Function recomputes that function in chunks of batch rows, its shared
# gradients rounded to bf16 per chunk (readings: K1 3.1e-3, K3 3.0e-3, K2
# and K4 in one chunk 0); K5 fp32 throughout (2.0e-7)
SUBLAYER_GRAD_BOUND = 1e-2
K5_GRAD_BOUND = 1e-6
# the 12-block DiT under autograd, kernels against impl="plain": rel of the
# loss (readings 9.9e-3 bf16 cache, 1.7e-2 int8), rel L2 of the worst
# parameter gradient (2.0e-2, 2.6e-2) and of the input's (1.2e-2, 1.3e-2)
DIT_GRAD_BOUNDS = {"loss": 5e-2, "params": 0.1, "x": 5e-2}

# [sublayer-widths]'s bounds, 4.5x the readings on an H100 80GB HBM3
# (700 W) in the comments: each form's kernel against its plain version,
# (rel L2 of y, of the update y - x)
SW_BOUNDS = {
    "sw_self_d1": (0.0038, 0.04),  # 8.471e-04, 8.878e-03
    "sw_temporal_d1": (0.0047, 0.032),  # 1.041e-03, 7.008e-03
    "sw_cross_d1": (0.0055, 0.029),  # 1.232e-03, 6.529e-03
    "sw_self_d2": (0.0026, 0.025),  # 5.854e-04, 5.575e-03
    "sw_temporal_d2": (0.0043, 0.028),  # 9.532e-04, 6.201e-03
    "sw_cross_d2": (0.0051, 0.028),  # 1.127e-03, 6.193e-03
    "sw_self_d4": (0.0026, 0.026),  # 5.730e-04, 5.745e-03
    "sw_temporal_d4": (0.004, 0.036),  # 8.902e-04, 7.933e-03
    "sw_cross_d4": (0.0048, 0.026),  # 1.068e-03, 5.745e-03
    "sw_self_d8": (0.0028, 0.03),  # 6.209e-04, 6.579e-03
    "sw_self_norms_off_d8": (0.003, 0.031),  # 6.663e-04, 6.826e-03
    "sw_self_q8_d8": (0.00079, 0.0083),  # 1.745e-04, 1.849e-03
    "sw_self_seg_d8": (0.004, 0.033),  # 8.989e-04, 7.337e-03
    "sw_self_seg_q8_d8": (0.00068, 0.0055),  # 1.507e-04, 1.230e-03
    "sw_temporal_d8": (0.004, 0.033),  # 8.989e-04, 7.337e-03
    "sw_temporal_norms_off_d8": (0.0043, 0.033),  # 9.531e-04, 7.226e-03
    "sw_temporal_q8_d8": (0.00068, 0.0055),  # 1.508e-04, 1.231e-03
    "sw_cross_d8": (0.0047, 0.029),  # 1.050e-03, 6.377e-03
    "sw_cross_rms_d8": (0.0046, 0.028),  # 1.015e-03, 6.277e-03
    "sw_cross_q8_d8": (0.003, 0.018),  # 6.699e-04, 4.070e-03
    "sw_cross_q8_rms_d8": (0.0018, 0.011),  # 4.099e-04, 2.534e-03
    "sw_cross_single_d8": (0.00065, 0.0062),  # 1.451e-04, 1.369e-03
    "sw_cross_single_rms_d8": (0.00061, 0.0059),  # 1.360e-04, 1.301e-03
    "sw_cross_single_fp32_d8": (3.4e-07, 3.2e-06),  # 7.642e-08, 7.213e-07
    "sw_cross_single_rms_fp32_d8": (3e-07, 2.9e-06),  # 6.659e-08, 6.372e-07
    "sw_cross_single_q8_d8": (4.8e-05, 0.00046),  # 1.058e-05, 1.012e-04
    "sw_self_d16": (0.0028, 0.027),  # 6.187e-04, 5.944e-03
    "sw_self_norms_off_d16": (0.003, 0.028),  # 6.569e-04, 6.186e-03
    "sw_self_q8_d16": (0.0008, 0.0077),  # 1.782e-04, 1.712e-03
    "sw_self_seg_d16": (0.0041, 0.035),  # 9.145e-04, 7.725e-03
    "sw_self_seg_q8_d16": (0.00075, 0.0063),  # 1.669e-04, 1.410e-03
    "sw_temporal_d16": (0.0041, 0.035),  # 9.145e-04, 7.725e-03
    "sw_temporal_norms_off_d16": (0.0043, 0.034),  # 9.560e-04, 7.545e-03
    "sw_temporal_q8_d16": (0.00075, 0.0063),  # 1.668e-04, 1.409e-03
    "sw_cross_d16": (0.0046, 0.028),  # 1.033e-03, 6.216e-03
    "sw_cross_rms_d16": (0.0045, 0.028),  # 1.007e-03, 6.137e-03
    "sw_cross_q8_d16": (0.0029, 0.017),  # 6.406e-04, 3.855e-03
    "sw_cross_q8_rms_d16": (0.0021, 0.013),  # 4.730e-04, 2.882e-03
    "sw_cross_single_d16": (0.00064, 0.0057),  # 1.422e-04, 1.267e-03
    "sw_cross_single_rms_d16": (0.00061, 0.0055),  # 1.364e-04, 1.224e-03
    "sw_cross_single_fp32_d16": (3.4e-07, 3.1e-06),  # 7.648e-08, 6.814e-07
    "sw_cross_single_rms_fp32_d16": (3.1e-07, 2.8e-06),  # 6.835e-08, 6.138e-07
    "sw_cross_single_q8_d16": (5.2e-05, 0.00046),  # 1.146e-05, 1.029e-04
    "sw_self_d128": (0.0029, 0.028),  # 6.358e-04, 6.161e-03
    "sw_self_norms_off_d128": (0.003, 0.029),  # 6.653e-04, 6.348e-03
    "sw_self_q8_d128": (0.001, 0.0099),  # 2.279e-04, 2.209e-03
    "sw_self_seg_d128": (0.0043, 0.033),  # 9.460e-04, 7.363e-03
    "sw_self_seg_q8_d128": (0.00093, 0.0072),  # 2.062e-04, 1.604e-03
    "sw_temporal_d128": (0.0043, 0.033),  # 9.460e-04, 7.363e-03
    "sw_temporal_norms_off_d128": (0.0045, 0.033),  # 9.961e-04, 7.233e-03
    "sw_temporal_q8_d128": (0.00093, 0.0072),  # 2.060e-04, 1.604e-03
    "sw_cross_d128": (0.0046, 0.028),  # 1.014e-03, 6.243e-03
    "sw_cross_rms_d128": (0.0045, 0.028),  # 1.007e-03, 6.219e-03
    "sw_cross_q8_d128": (0.0026, 0.016),  # 5.668e-04, 3.490e-03
    "sw_cross_q8_rms_d128": (0.0016, 0.01),  # 3.641e-04, 2.248e-03
    "sw_cross_single_rms_d128": (0.00061, 0.0055),  # 1.349e-04, 1.222e-03
    "sw_cross_single_rms_fp32_d128": (4.1e-07, 3.7e-06),  # 9.1e-08, 8.2e-07
    "sw_cross_single_q8_d128": (6.7e-05, 0.00061),  # 1.490e-05, 1.350e-04
}
# the fp32 single context's update against fp64 on F64_ROWS rows (the
# plain fp32 version's own reads 5.3e-7-6.2e-7)
SW_F64_BOUNDS = {
    "sw_cross_single_fp32_d8": 1.7e-06,  # 3.847e-07
    "sw_cross_single_rms_fp32_d8": 1.4e-06,  # 3.159e-07
    "sw_cross_single_fp32_d16": 1.8e-06,  # 3.899e-07
    "sw_cross_single_rms_fp32_d16": 1.4e-06,  # 3.162e-07
    "sw_cross_single_rms_fp32_d128": 2.8e-06,  # 6.207e-07
}
# VideoTo4DPipeline.run's steps, and its int8 runs against its float run
# (rel L2 of the latent and the deltas, the larger of the two int8 runs'
# readings in the comments) at heads of 16 and 128
SW_RUN_STEPS = 32
SW_RUN_BOUNDS = {16: {"latent": 1.2e-2, "deltas": 1.2e-2},  # 2.68e-3, 2.64e-3
                 128: {"latent": 1.4e-2, "deltas": 1.4e-2}}  # 3.01e-3, 3.02e-3
# the torso block at heads of 16, kernels vs plain on the valid slots
SW_BLOCK_BOUNDS = {"cross_single": 6.3e-3,  # 1.39e-3
                   "cross_single_fp32": 1.6e-5}  # 3.59e-6
# the DiT under autograd at heads of 16 and 128 (forms_dit_grad's checks:
# the loss, the worst parameter gradient, the input's); readings 2.45e-2,
# 2.14e-2, 1.27e-2 at 16 and 8.87e-3, 1.97e-2, 1.27e-2 at 128
SW_GRAD_BOUNDS = {16: {"loss": 0.11, "params": 9.6e-2, "x": 5.7e-2},
                  128: {"loss": 4e-2, "params": 8.9e-2, "x": 5.7e-2}}


def _form_result(name, replaces, source, mae, ms, plain_ms, lib_ms, b):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=mae, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
                bound_by=b[1], library_ms=lib_ms)


def _drive(counts, key, fn):
    """fn() once with every counter at 0; the launches of `key`."""
    import torch

    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    n = counts()[key]
    if n != 1:
        raise AssertionError(f"{key}: {n} launches in its drive, not 1")
    return out, n


def forms_k5(dev, entries, card):
    """K5's segment_size at the packed temporal shape, against its plain
    version and K6 on the unpacked data; its int8 forms at the DiT's self
    shape and DINOv2's (at DINOv2-like logit scales), qk with a -inf key
    bias at the torso's; SDPA (with the block-diagonal or key mask) as the
    library call."""
    import torch
    import torch.nn.functional as F
    from gvfdiffusion_torch.ops import fused_attention as fa

    counts = lambda: fa.launch_counts
    res, launches = {}, {}
    g = torch.Generator(device=dev).manual_seed(31)
    rnd = lambda *s, sc=1.0: (torch.randn(*s, generator=g, device=dev)
                              * sc).bfloat16()
    D = C // H
    scale = D ** -0.5
    # segments: K6's [1, 32, 512, 16, 32] packed voxel-major, 16 voxels of
    # 32 frames a sequence
    q6, k6, v6 = (rnd(B, T, N, H, D) for _ in range(3))
    pack = lambda a: a.permute(0, 2, 1, 3, 4).reshape(
        B * N // SEG_VOXELS, SEG_VOXELS * T, H, D).contiguous()
    qp, kp, vp = map(pack, (q6, k6, v6))
    name, replaces, source = entries["attention_seg_d32"]
    y, launches["attention_seg_d32"] = _drive(
        counts, "attention_seg_d32",
        lambda: fa.fused_attention(qp, kp, vp, scale, segment_size=SEG_T))
    ref = fa.fused_attention(qp, kp, vp, scale, segment_size=SEG_T,
                             impl="plain")
    k6_out = pack(fa.temporal_attention(q6, k6, v6, scale))
    err, k6_err = rel_l2(y, ref), rel_l2(y, k6_out)
    mae = float((y.float() - ref.float()).abs().max())
    rows = torch.arange(SEG_VOXELS * T, device=dev) // SEG_T
    mask = rows[:, None] == rows[None, :]
    sdpa = lambda: F.scaled_dot_product_attention(
        *(a.transpose(1, 2) for a in (qp, kp, vp)), attn_mask=mask)
    ms = time_ms(lambda: fa.fused_attention(qp, kp, vp, scale,
                                            segment_size=SEG_T))
    plain_ms = time_ms(lambda: fa.fused_attention(
        qp, kp, vp, scale, segment_size=SEG_T, impl="plain"), iters=3)
    k6_ms = time_ms(lambda: fa.temporal_attention(q6, k6, v6, scale))
    lib_ms = time_ms(sdpa)
    flops = 4 * qp.shape[0] * H * qp.shape[1] * SEG_T * D  # in-segment keys
    b = bound(flops, nbytes(qp, kp, vp, y))
    log(f"[forms] {name}: q/k/v {tuple(qp.shape)} bf16, segment_size "
        f"{SEG_T}: max_abs_err {mae:.4g} rel_l2 {err:.3e} (bound "
        f"{SEG_REL_BOUND:g}); against K6 on the unpacked {tuple(q6.shape)} "
        f"rel_l2 {k6_err:.3e} (bound {SEG_K6_BOUND:g}); kernel {ms:.4f} ms "
        f"plain {plain_ms:.3f} ms K6 {k6_ms:.4f} ms sdpa (block-diagonal "
        f"mask) {lib_ms:.4f} ms bound {b[0]:.4f} ms ({b[1]}); launches "
        f"{launches['attention_seg_d32']}; {card}")
    if not (bool(torch.isfinite(y).all()) and err <= SEG_REL_BOUND
            and k6_err <= SEG_K6_BOUND):
        raise AssertionError(f"{name} disagrees")
    res["attention_seg_d32"] = _form_result(name, replaces, source, mae, ms,
                                            plain_ms, lib_ms, b)

    def q8_case(key):
        if key.endswith("_d32"):
            return (rnd(T, N, H, D), rnd(T, N, H, D), rnd(T, N, H, D), None,
                    "DiT self")
        if key == "attention_qk_bias":
            bias = torch.zeros(1, TORSO, device=dev)
            bias[:, L_TORSO_VALID:] = float("-inf")
            return (rnd(1, TORSO, 16, 64), rnd(1, TORSO, 16, 64),
                    rnd(1, TORSO, 16, 64), bias,
                    f"torso, {L_TORSO_VALID} of {TORSO} keys valid")
        s = DINO_LOGIT_STD
        return (rnd(T, L_IMG, 16, 64, sc=s), rnd(T, L_IMG, 16, 64, sc=s),
                rnd(T, L_IMG, 16, 64), None, "DINOv2")

    for key in ("attention_qk_d32", "attention_qk", "attention_qk_bias",
                "attention_qkav_d32", "attention_qkav"):
        name, replaces, source = entries[key]
        quant = "qk+av" if "qkav" in key else "qk"
        count_key = fa.launch_key(64 if key in ("attention_qk",
                                                "attention_qkav",
                                                "attention_qk_bias") else 32,
                                  False, False, quant=quant)
        q, k, v, bias, what = q8_case(key)
        sc_ = q.shape[-1] ** -0.5
        kw = dict(kv_bias=bias, quant=quant)
        y, launches[key] = _drive(
            counts, count_key, lambda: fa.fused_attention(q, k, v, sc_, **kw))
        ref = fa.fused_attention(q, k, v, sc_, **kw, impl="plain")
        flt = fa.fused_attention(q, k, v, sc_, kv_bias=bias, impl="plain")
        err, f_err = rel_l2(y, ref), rel_l2(y, flt)
        mae = float((y.float() - ref.float()).abs().max())
        logit = float((torch.einsum("bqhd,bkhd->bhqk", q[:1].float(),
                                    k[:1].float()) * sc_).abs().max())
        mask = None if bias is None else bias[:, None, None, :].bfloat16()
        sdpa = lambda: F.scaled_dot_product_attention(
            *(a.transpose(1, 2) for a in (q, k, v)), attn_mask=mask)
        ms = time_ms(lambda: fa.fused_attention(q, k, v, sc_, **kw))
        plain_ms = time_ms(lambda: fa.fused_attention(q, k, v, sc_, **kw,
                                                      impl="plain"), iters=2)
        float_ms = time_ms(lambda: fa.fused_attention(q, k, v, sc_,
                                                      kv_bias=bias))
        lib_ms = time_ms(sdpa)
        Bq, Lq, Hq, Dq = q.shape
        lk = k.shape[1] if bias is None else L_TORSO_VALID
        prod = 2 * Bq * Hq * Lq * lk * Dq
        b = _bound_mixed([(prod, PEAK_INT8), (prod, PEAK_INT8 if quant ==
                                              "qk+av" else PEAK_FLOPS)],
                         nbytes(q, k, v, y, bias))
        rel_bound = QKAV_REL_BOUND if quant == "qk+av" else QK_REL_BOUND
        log(f"[forms] {name}: q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 "
            f"({what}; largest |scaled logit| of batch row 0 {logit:.1f}): "
            f"max_abs_err {mae:.4g} rel_l2 {err:.3e} (bound {rel_bound:g}); "
            f"against the float form rel_l2 {f_err:.3e}"
            + (f" (bound {QKAV_FLOAT_BOUND:g})" if quant == "qk+av" else "")
            + f"; kernel {ms:.4f} ms (float K5 {float_ms:.4f} ms) plain "
            f"{plain_ms:.3f} ms sdpa {lib_ms:.4f} ms bound {b[0]:.4f} ms "
            f"({b[1]}); launches {launches[key]}; {card}")
        if not (bool(torch.isfinite(y).all()) and err <= rel_bound
                and (quant == "qk" or f_err <= QKAV_FLOAT_BOUND)):
            raise AssertionError(f"{name} disagrees with its plain version")
        res[key] = _form_result(name, replaces, source, mae, ms, plain_ms,
                                lib_ms, b)
    return res, launches


def forms_sublayers(dev, entries, card):
    """K1 with seg = 16 on the x K2 runs at the inference shape, viewed as
    [32, 32 x 16, 512] (mod_repeat 32), float and int8 QK, against its
    plain version and K2 on the same data; K3's single context with the q
    RMS norm (bf16 and fp32) and on an int8 cache (q_block 128) at the
    uncompacted torso's [1, 32768, 1024] x 1374, 16 heads of 64."""
    import torch
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    counts = lambda: fsl.launch_counts
    res, launches = {}, {}
    g = torch.Generator(device=dev).manual_seed(32)
    x4, case = sublayer_cases(dev, g)["temporal"]
    args = case["args"][1:]
    view = lambda a: a.reshape(B, T, N // SEG_VOXELS, SEG_VOXELS, C).permute(
        0, 2, 1, 3, 4).reshape(B * N // SEG_VOXELS, T * SEG_VOXELS,
                               C).contiguous()
    x1 = view(x4)
    for key in ("self_seg", "self_seg_q8"):
        name, replaces, source = entries[key]
        q8 = key.endswith("q8")
        kw = dict(num_heads=H, rms=True, seg=SEG_VOXELS,
                  mod_repeat=x1.shape[0], quant_qk=q8)
        y, launches[key] = _drive(
            counts, key, lambda: fsl.fused_self_sublayer(x1, *args, **kw))
        ref = fsl.fused_self_sublayer(x1, *args, **kw, impl="plain")
        k2 = view(fsl.fused_temporal_sublayer(x4, *args, num_heads=H,
                                              quant_qk=q8))
        err, k2_err = rel_l2(y, ref), rel_l2(y, k2)
        upd = rel_l2(y.float() - x1.float(), ref.float() - x1.float())
        mae = float((y.float() - ref.float()).abs().max())
        ms = time_ms(lambda: fsl.fused_self_sublayer(x1, *args, **kw))
        plain_ms = time_ms(lambda: fsl.fused_self_sublayer(
            x1, *args, **kw, impl="plain"), iters=3)
        k2_ms = time_ms(lambda: fsl.fused_temporal_sublayer(
            x4, *args, num_heads=H, quant_qk=q8))
        lib_ms = time_ms(lambda: library_temporal(x4, *args, num_heads=H))
        qk = 2 * B * T * N * T * C
        b = _bound_mixed([(sublayer_flops("temporal") - qk, PEAK_FLOPS),
                          (qk, PEAK_INT8 if q8 else PEAK_FLOPS)],
                         nbytes(x1, args, y))
        y_bound, upd_bound = QK8_BOUNDS if q8 else BOUNDS["temporal"]
        log(f"[forms] {name}: x {tuple(x1.shape)} bf16 (K2's {tuple(x4.shape)}"
            f" viewed voxel-major), seg {SEG_VOXELS}, mod_repeat "
            f"{x1.shape[0]}: max_abs_err {mae:.4g} rel_l2 {err:.3e} (bound "
            f"{y_bound:g}) update_rel_l2 {upd:.3e} (bound {upd_bound:g}); "
            f"against K2 on the same data rel_l2 {k2_err:.3e} (bound "
            f"{SEG_K2_BOUND:g}); kernel {ms:.3f} ms (K2 {k2_ms:.3f} ms) "
            f"plain {plain_ms:.3f} ms library {lib_ms:.3f} ms bound "
            f"{b[0]:.4f} ms ({b[1]}); launches {launches[key]}; {card}")
        if not (bool(torch.isfinite(y).all()) and err <= y_bound
                and upd <= upd_bound and k2_err <= SEG_K2_BOUND):
            raise AssertionError(f"{name} disagrees")
        res[key] = _form_result(name, replaces, source, mae, ms, plain_ms,
                                lib_ms, b)

    Cx, heads = 1024, 16
    gt = torch.Generator(device=dev).manual_seed(33)
    r = lambda *s_, sc=1.0: torch.randn(*s_, generator=gt, device=dev) * sc
    x = r(1, SLOTS, Cx)
    gamma = (1.0 + 0.1 * r(Cx)) * (Cx // heads) ** 0.5
    p32 = (1 + 0.1 * r(Cx), 0.1 * r(Cx), r(Cx, Cx, sc=Cx ** -0.5),
           0.1 * r(Cx), gamma, r(Cx, Cx, sc=Cx ** -0.5), 0.1 * r(Cx))
    kvp32 = r(1, L_IMG, 2 * Cx)
    flops = 2 * 2 * SLOTS * Cx * Cx + 4 * SLOTS * L_IMG * Cx
    for key in ("cross_single_rms", "cross_single_rms_fp32",
                "cross_single_q8"):
        name, replaces, source = entries[key]
        f32 = key.endswith("fp32")
        dt = torch.float32 if f32 else torch.bfloat16
        p = tuple(a.to(dt) for a in p32)
        kvp = kvp32.to(dt)
        kv = (kvp[..., :Cx], kvp[..., Cx:])
        kw = dict(num_heads=heads, rms=True, compute_dtype=dt)
        q8 = key.endswith("q8")
        if q8:
            kv = int8_cache(tuple(a.contiguous() for a in kv), heads)
            kw.update(quant=True, q_block=128)
        count_key = fsl.single_launch_key(dt, Cx // heads, rms=not q8,
                                          quant=q8)
        with torch.no_grad():
            y, launches[key] = _drive(
                counts, count_key,
                lambda: fsl.fused_cross_sublayer(x, p, kv, **kw))
            ref = fsl.fused_cross_sublayer(x, p, kv, **kw, impl="plain")
            err, upd = rel_l2(y, ref), rel_l2(y - x, ref - x)
            mae = float((y - ref).abs().max())
            ms = time_ms(lambda: fsl.fused_cross_sublayer(x, p, kv, **kw))
            plain_ms = time_ms(lambda: fsl.fused_cross_sublayer(
                x, p, kv, **kw, impl="plain"), iters=2)
            kvf = (kvp[..., :Cx], kvp[..., Cx:])
            lib = lambda: library_cross_single_rms(x, p, kvf, heads)
            lib_upd = rel_l2(lib() - x, ref - x)
            lib_ms = time_ms(lib)
        if f32:
            b = bound(flops * 3, nbytes(x, p, kvp, y), PEAK_TF32)
            y_bound, upd_bound = CROSS_F32_BOUNDS
        elif q8:
            qk = 2 * SLOTS * L_IMG * Cx
            b = _bound_mixed([(flops - qk, PEAK_FLOPS), (qk, PEAK_INT8)],
                             nbytes(x, p, kv, y))
            y_bound, upd_bound = SINGLE_Q8_BOUNDS
        else:
            b = bound(flops, nbytes(x, p, kvp, y))
            y_bound, upd_bound = BOUNDS["cross_single"]
        log(f"[forms] {name}: x {tuple(x.shape)} fp32, "
            f"{'fp32' if f32 else 'bf16'} compute, {heads} heads of "
            f"{Cx // heads}, q RMS norm" + (", int8 cache, q_block 128"
                                            if q8 else "")
            + f": max_abs_err {mae:.4g} rel_l2 {err:.3e} (bound "
            f"{y_bound:g}) update_rel_l2 {upd:.3e} (bound {upd_bound:g}); "
            f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms library "
            f"{lib_ms:.3f} ms (its update rel_l2 {lib_upd:.3e}) bound "
            f"{b[0]:.4f} ms ({b[1]}); launches {launches[key]}; {card}")
        if not (bool(torch.isfinite(y).all()) and err <= y_bound
                and upd <= upd_bound):
            raise AssertionError(f"{name} disagrees with its plain version")
        res[key] = _form_result(name, replaces, source, mae, ms, plain_ms,
                                lib_ms, b)
    return res, launches


def library_cross_single_rms(x, p, kv, num_heads):
    """K3's single context with the q RMS norm as library calls
    (F.layer_norm, cuBLAS products, the norm's elementwise ops, SDPA, the
    residual), in the parameters' dtype."""
    import torch.nn.functional as F

    ns, nb, wq, bq, qg, wo, bo = p
    Bx, L, Cx = x.shape
    dt = wq.dtype
    h = F.layer_norm(x.float(), (Cx,), ns.float(), nb.float(), eps=1e-6)
    q = (h.to(dt) @ wq + bq).float().view(Bx, L, num_heads, -1)
    q = (q * (q.square().sum(-1, keepdim=True) + 1e-12).rsqrt()).view(
        Bx, L, Cx) * qg.float()
    q = q.to(dt).view(Bx, L, num_heads, -1).transpose(1, 2)
    k, v = (a.reshape(Bx, a.shape[1], num_heads, -1).transpose(1, 2)
            for a in kv)
    o = F.scaled_dot_product_attention(q, k, v)
    out = o.transpose(1, 2).reshape(Bx, L, Cx) @ wo + bo
    return x + out.to(x.dtype)


def _input_grads(fn, inputs, gy):
    """The gradients of fn at `inputs` for the cotangent gy (forward and
    backward)."""
    import torch

    ins = [a.detach().requires_grad_(a.is_floating_point()) for a in inputs]
    return torch.autograd.grad(fn(*ins), ins, gy, allow_unused=True)


def _grad_rel(fn, ref_fn, inputs, gy):
    """The worst rel L2 over the inputs' gradients of fn against ref_fn
    (torch's autograd through the plain function) for the cotangent gy,
    and the time of fn's forward + backward."""
    got = _input_grads(fn, inputs, gy)
    want = _input_grads(ref_fn, inputs, gy)
    worst = max(rel_l2(a, b_) for a, b_ in zip(got, want)
                if b_ is not None)
    fb_ms = time_ms(lambda: _input_grads(fn, inputs, gy), iters=3, warm=1)
    return worst, fb_ms


def forms_backward(dev, card):
    """The backward of K1-K4 at the DiT training shapes (B x T = 48 frames
    of 512, 16 heads of 32, bf16), through their autograd Function, against
    torch's autograd through the same plain function; K5's key-bias
    gradient at the torso's [1, 4096, 16, 64] with its -inf padding keys
    (fp32, against autograd of fp32 softmax attention)."""
    import torch
    from gvfdiffusion_torch.ops import fused_attention as fa
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    g = torch.Generator(device=dev).manual_seed(34)
    bt = TRAIN_B * TRAIN_T
    rnd = lambda *s, sc=1.0: (torch.randn(*s, generator=g, device=dev)
                              * sc).bfloat16()
    cases = sublayer_cases(dev, g)
    mr = TRAIN_T
    for key, fn, ref in (
            ("self", fsl.fused_self_sublayer, fsl.self_sublayer_reference),
            ("temporal", fsl.fused_temporal_sublayer,
             fsl.temporal_sublayer_reference),
            ("cross", fsl.fused_cross_sublayer,
             fsl.cross_sublayer_reference),
            ("mlp", fsl.fused_mlp_sublayer, fsl.mlp_sublayer_reference)):
        _, c = cases[key]
        args, kw = list(c["args"]), dict(c["kw"])
        if key == "temporal":
            args[0] = rnd(TRAIN_B, TRAIN_T, N, C)
            args[1:4] = [rnd(TRAIN_B, C, sc=0.3) for _ in range(3)]
        else:
            args[0] = rnd(bt, N, C)
        if key in ("self", "mlp"):
            args[1:4] = [rnd(TRAIN_B, C, sc=0.3) for _ in range(3)]
            kw["mod_repeat"] = mr
        if key == "cross":
            args[2] = tuple(rnd(bt, L_IMG, C) for _ in range(2))
            args[4] = tuple(rnd(bt, N, C) for _ in range(2))
        flat = [args[0], *[t for a in args[1:] for t in
                           (a if isinstance(a, tuple) else (a,))]]
        sizes = [len(a) if isinstance(a, tuple) else None for a in args[1:]]

        def unflat(ts):
            out, i = [ts[0]], 1
            for n in sizes:
                out.append(ts[i] if n is None else tuple(ts[i:i + n]))
                i += 1 if n is None else n
            return out

        if key in ("self", "mlp"):
            rep = lambda a: a.repeat_interleave(mr, 0)  # noqa: E731

            def ref_fn(*ts, ref=ref):
                a = unflat(ts)
                return ref(a[0], *map(rep, a[1:4]), *a[4:], **{
                    k_: v_ for k_, v_ in kw.items() if k_ != "mod_repeat"})
        else:
            def ref_fn(*ts, ref=ref):
                return ref(*unflat(ts), **kw)

        def fn_k(*ts, fn=fn):
            return fn(*unflat(ts), **kw)

        gy = rnd(*args[0].shape)
        worst, fb_ms = _grad_rel(fn_k, ref_fn, flat, gy)
        fb_plain = time_ms(lambda: _input_grads(ref_fn, flat, gy), iters=2,
                           warm=1)
        log(f"[forms] backward of {key} at x {tuple(args[0].shape)} bf16 "
            f"{kw}: gradients vs autograd of the plain function worst rel_l2 "
            f"{worst:.3e} (bound {SUBLAYER_GRAD_BOUND:g}); forward + "
            f"backward kernel {fb_ms:.3f} ms, plain {fb_plain:.3f} ms; {card}")
        if not worst <= SUBLAYER_GRAD_BOUND:
            raise AssertionError(f"the backward of {key} disagrees")
    gk = torch.Generator(device=dev).manual_seed(35)
    r = lambda *s: torch.randn(*s, generator=gk, device=dev)
    q, k, v = (r(1, TORSO, 16, 64) for _ in range(3))
    bias = 0.5 * r(1, TORSO)
    bias[:, L_TORSO_VALID:] = float("-inf")
    scale = 64 ** -0.5

    def plain_fp32(q, k, v, b):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + b[:, None, None]
        return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)

    gy = r(1, TORSO, 16, 64)
    worst, fb_ms = _grad_rel(
        lambda q, k, v, b: fa.fused_attention(q, k, v, scale, kv_bias=b),
        plain_fp32, (q, k, v, bias), gy)
    log(f"[forms] backward of K5 with a key bias at q/k/v {tuple(q.shape)} "
        f"fp32, {L_TORSO_VALID} of {TORSO} keys valid: dq, dk, dv, dbias vs "
        f"autograd of fp32 softmax attention worst rel_l2 {worst:.3e} "
        f"(bound {K5_GRAD_BOUND:g}); forward + backward {fb_ms:.3f} ms; "
        f"{card}")
    if not worst <= K5_GRAD_BOUND:
        raise AssertionError("K5's backward disagrees")


def forms_dit_grad(dev, card, num_heads=H, kv_quants=(None, "int8"),
                   tag="[forms]", bounds=DIT_GRAD_BOUNDS):
    """The fused DiT under autograd: the 12-block, 512-wide DiT in bf16 as
    VideoTo4DPipeline builds it (at `num_heads` heads), at the trainer's
    shape (batch 2 x 24 frames of 512 voxels), its cache hoisted by
    dit.kv_cache from seeded DINOv2-shaped tokens and the static latent (in
    each of `kv_quants`: bf16, int8), under autograd: the loss sum(output *
    a seeded tensor), backward() for every parameter and the input latent;
    the kernels' run against the same DiT's impl="plain" run, within
    `bounds`. Returns the K1-K4 launches of the bf16-cache kernel run."""
    import torch
    from gvfdiffusion_torch.models.dit import DiT
    from gvfdiffusion_torch.ops import fused_sublayer as fsl
    from gvfdiffusion_torch.utils.weights import init_random_

    d = C // num_heads
    dit = init_random_(DiT(dtype=torch.bfloat16, num_heads=num_heads),
                       seed=0).to(dev)
    g = torch.Generator(device=dev).manual_seed(36)
    x = torch.randn(TRAIN_B, TRAIN_T, N, 16, generator=g, device=dev)
    t = 500.0 - 250.0 * torch.arange(TRAIN_B, device=dev)  # one a sample
    ci = torch.randn(TRAIN_B, TRAIN_T, L_IMG, 1024, generator=g, device=dev)
    st = torch.randn(TRAIN_B, N, 14, generator=g, device=dev)
    pos = torch.rand(TRAIN_B, N, 3, generator=g, device=dev) - 0.5
    w = torch.randn(TRAIN_B, TRAIN_T, N, 16, generator=g, device=dev)
    params = [p for p in dit.parameters()]
    launches = None

    def step(kv_quant, impl):
        dit.zero_grad(set_to_none=True)
        xg = x.clone().requires_grad_(True)
        kv = dit.kv_cache(ci, st, kv_quant)
        out = dit(xg, t, positions=pos, cross_kv=kv, impl=impl)
        loss = (out.float() * w).sum()
        loss.backward()
        torch.cuda.synchronize()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                 for p in params]
        return float(loss.detach()), grads, xg.grad

    for kv_quant in kv_quants:
        reset_counts()
        t0 = time.perf_counter()
        loss, grads, gx = step(kv_quant, None)
        step_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: n for k, n in fsl.launch_counts.items() if n}
        if kv_quant is None:
            launches = counts
        want = {fsl.launch_key("self", d), fsl.launch_key("temporal", d),
                "mlp", fsl.launch_key("cross" if kv_quant is None else
                                      "cross_q8", d)}
        if set(counts) != want or any(n != 12 for n in counts.values()):
            raise AssertionError(f"the DiT's fused path launched {counts}")
        t0 = time.perf_counter()
        step(kv_quant, None)
        step_ms2 = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loss_p, grads_p, gx_p = step(kv_quant, "plain")
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs = [rel_l2(a, b_) for a, b_ in zip(grads, grads_p)
                if float(b_.abs().max()) > 0]
        none = sum(1 for b_ in grads_p if float(b_.abs().max()) == 0)
        loss_err = abs(loss - loss_p) / abs(loss_p)
        x_err = rel_l2(gx, gx_p)
        finite = all(bool(torch.isfinite(a).all()) for a in grads) and \
            bool(torch.isfinite(gx).all())
        log(f"{tag} DiT 12x512 bf16 at {num_heads} heads of {d} under "
            f"autograd, cache {kv_quant or 'bf16'}, x {tuple(x.shape)}: loss "
            f"{loss:.6g} "
            f"(plain {loss_p:.6g}, rel {loss_err:.3e}, bound "
            f"{bounds['loss']:g}); parameter gradients vs "
            f"impl=\"plain\" worst rel_l2 {max(errs):.3e}, median "
            f"{sorted(errs)[len(errs) // 2]:.3e} (bound "
            f"{bounds['params']:g}; {len(errs)} tensors, {none} "
            f"with no gradient in both); input gradient rel_l2 {x_err:.3e} "
            f"(bound {bounds['x']:g}); step (kv_cache, forward, "
            f"backward) {step_ms:.1f} ms first, {step_ms2:.1f} ms second, "
            f"plain {plain_ms:.1f} ms; launches {counts}; {card}")
        if not (finite and loss_err <= bounds["loss"]
                and max(errs) <= bounds["params"]
                and x_err <= bounds["x"]):
            raise AssertionError("the DiT's gradients disagree")
    del dit
    torch.cuda.empty_cache()
    return launches


def phase_forms(dev, card):
    """The [forms] phase: each new kernel form against its plain version
    at full width (its kernels-line entry, its launches from its own
    drive), the backward, and the DiT under autograd."""
    import torch

    t0 = time.perf_counter()
    entries = {key: (name, replaces, source)
               for name, replaces, source, key in KERNELS
               if key in FORM_KEYS}
    res, launches = forms_k5(dev, entries, card)
    r2, l2 = forms_sublayers(dev, entries, card)
    res.update(r2)
    launches.update(l2)
    torch.cuda.empty_cache()
    forms_backward(dev, card)
    torch.cuda.empty_cache()
    forms_dit_grad(dev, card)
    log(f"[forms] phase in {time.perf_counter() - t0:.1f} s")
    return res, launches


# -- [widths]: K5, K6 and K7 at the head widths they reach by padding ---------


def phase_widths(dev, card):
    """[widths]: each form of WIDTH_KERNELS at full width against its plain
    version, timed beside it and a library call (SDPA): K5's key-bias form
    at [1, 4096, 768 / D, D] (L_TORSO_VALID keys valid) in bf16 and fp32 io
    at heads of 16, 48 and 128; its int8 forms at the DiT's self shape
    [32, 512, 512 / D, D] and its segments at 16 (against K6 on the
    unpacked data too); K5 and K6 at the DiT's training shapes at heads of
    16 and 128 (phase_train_kernel, with the gradients in fp32; K6 also in
    bf16); K7's residual forward, dkv and dq at heads of 48 and 96 in both
    dtypes (vae_form_rows). The forms no entry point runs are driven once
    through their wrappers with the counters at 0. Then the DiT's trainer,
    cli/main_latent.main on configs/diffusion.yml at full width (12 x 512)
    with --model.num_heads=32 and =4, one micro-step each on a seeded
    dataset: finite losses, and K5's self and cross and K6's launches at
    heads of 16 and 128 (12, 24, 12), the kernels line's counts of those
    forms. (main_vae at --static_vae.num_heads=8 runs in [vae-train], with
    the other head counts: K7 fp32 at heads of 96.) Returns (the rows, the
    launches)."""
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as F
    from gvfdiffusion_torch.ops import fused_attention as fa

    t0 = time.perf_counter()
    entries = {e[3]: e[:3] for e in WIDTH_KERNELS}
    rows, launches = {}, {}
    counts = lambda: fa.launch_counts  # noqa: E731
    g = torch.Generator(device=dev).manual_seed(51)

    def rnd(*s_, dt=torch.bfloat16):
        return torch.randn(*s_, generator=g, device=dev).to(dt)

    bias = torch.zeros(1, TORSO, device=dev)
    bias[:, L_TORSO_VALID:] = float("-inf")
    for D in WIDTH_K5:
        for dt_name, dt in (("bf16", torch.bfloat16),
                            ("fp32", torch.float32)):
            key = f"width_attention_bias_{dt_name}_d{D}"
            name, replaces, source = entries[key]
            Hh, scale = WIDTH_C // D, D ** -0.5
            q, k, v = (rnd(1, TORSO, Hh, D, dt=dt) for _ in range(3))

            def call(impl=None):
                return fa.fused_attention(q, k, v, scale, kv_bias=bias,
                                          impl=impl)

            y, launches[key] = _drive(counts, fa.launch_key(D, False, True),
                                      call)
            ref = call("plain")
            err = rel_l2(y, ref)
            mae = float((y.float() - ref.float()).abs().max())
            mask = bias[:, None, None, :].to(dt)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *(a.transpose(1, 2) for a in (q, k, v)), attn_mask=mask)
            ms, lib_ms = time_ms(call), time_ms(sdpa)
            plain_ms = time_ms(lambda: call("plain"), iters=3)
            b = bound(4 * Hh * TORSO * L_TORSO_VALID * D,
                      nbytes(q, k, v, y, bias))
            log(f"[widths] {name}: q/k/v {tuple(q.shape)} {dt_name}, "
                f"{L_TORSO_VALID} of {TORSO} keys valid: max_abs_err "
                f"{mae:.4g} rel_l2 {err:.3e} (bound {ATTN_REL_BOUND:g}); "
                f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms sdpa "
                f"{lib_ms:.4f} ms bound {b[0]:.4f} ms ({b[1]}, at D = {D}; "
                f"the kernel at {b[0] / ms:.0%} of it); launches "
                f"{launches[key]}; {card}")
            if not (bool(torch.isfinite(y).all()) and err <= ATTN_REL_BOUND):
                raise AssertionError(f"{name} disagrees with its plain "
                                     "version")
            rows[key] = _form_result(name, replaces, source, mae, ms,
                                     plain_ms, lib_ms, b)
            del q, k, v, y, ref

    for D in WIDTH_DIT:
        # K5's int8 forms at the DiT's self shape
        Hh, scale = C // D, D ** -0.5
        q, k, v = (rnd(T, N, Hh, D) for _ in range(3))
        flt = fa.fused_attention(q, k, v, scale, impl="plain")
        for quant in ("qk", "qk+av"):
            key = f"attention_{'qkav' if quant == 'qk+av' else 'qk'}_d{D}"
            name, replaces, source = entries[key]

            def call(impl=None):
                return fa.fused_attention(q, k, v, scale, quant=quant,
                                          impl=impl)

            y, launches[key] = _drive(counts, key, call)
            ref = call("plain")
            err, f_err = rel_l2(y, ref), rel_l2(y, flt)
            mae = float((y.float() - ref.float()).abs().max())
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                *(a.transpose(1, 2) for a in (q, k, v)))
            ms, lib_ms = time_ms(call), time_ms(sdpa)
            plain_ms = time_ms(lambda: call("plain"), iters=2)
            prod = 2 * T * Hh * N * N * D
            b = _bound_mixed([(prod, PEAK_INT8), (prod, PEAK_INT8 if quant
                                                  == "qk+av" else PEAK_FLOPS)],
                             nbytes(q, k, v, y))
            lim = QKAV_REL_BOUND if quant == "qk+av" else QK_REL_BOUND
            log(f"[widths] {name}: q/k/v {tuple(q.shape)} bf16: max_abs_err "
                f"{mae:.4g} rel_l2 {err:.3e} (bound {lim:g}); against the "
                f"float form rel_l2 {f_err:.3e}"
                + (f" (bound {QKAV_FLOAT_BOUND:g})" if quant == "qk+av"
                   else "")
                + f"; kernel {ms:.4f} ms plain {plain_ms:.3f} ms sdpa "
                f"{lib_ms:.4f} ms bound {b[0]:.4f} ms ({b[1]}, at D = {D}); "
                f"launches {launches[key]}; {card}")
            if not (bool(torch.isfinite(y).all()) and err <= lim
                    and (quant == "qk" or f_err <= QKAV_FLOAT_BOUND)):
                raise AssertionError(f"{name} disagrees with its plain "
                                     "version")
            rows[key] = _form_result(name, replaces, source, mae, ms,
                                     plain_ms, lib_ms, b)
        del q, k, v, flt

    # K5's segments at 16: K6's [1, 32, 512, 32, 16] packed voxel-major
    key, D = "attention_seg_d16", 16
    name, replaces, source = entries[key]
    Hh, scale = C // D, D ** -0.5
    q6, k6, v6 = (rnd(B, T, N, Hh, D) for _ in range(3))
    pack = lambda a: a.permute(0, 2, 1, 3, 4).reshape(  # noqa: E731
        B * N // SEG_VOXELS, SEG_VOXELS * T, Hh, D).contiguous()
    qp, kp, vp = map(pack, (q6, k6, v6))

    def call(impl=None):
        return fa.fused_attention(qp, kp, vp, scale, segment_size=SEG_T,
                                  impl=impl)

    y, launches[key] = _drive(counts, key, call)
    ref = call("plain")
    err = rel_l2(y, ref)
    k6_err = rel_l2(y, pack(fa.temporal_attention(q6, k6, v6, scale)))
    mae = float((y.float() - ref.float()).abs().max())
    seg_rows = torch.arange(SEG_VOXELS * T, device=dev) // SEG_T
    mask = seg_rows[:, None] == seg_rows[None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        *(a.transpose(1, 2) for a in (qp, kp, vp)), attn_mask=mask)
    ms, lib_ms = time_ms(call), time_ms(sdpa)
    plain_ms = time_ms(lambda: call("plain"), iters=3)
    b = bound(4 * qp.shape[0] * Hh * qp.shape[1] * SEG_T * D,
              nbytes(qp, kp, vp, y))
    log(f"[widths] {name}: q/k/v {tuple(qp.shape)} bf16, segment_size "
        f"{SEG_T}: max_abs_err {mae:.4g} rel_l2 {err:.3e} (bound "
        f"{SEG_REL_BOUND:g}); against K6 on the unpacked {tuple(q6.shape)} "
        f"rel_l2 {k6_err:.3e} (bound {SEG_K6_BOUND:g}); kernel {ms:.4f} ms "
        f"plain {plain_ms:.3f} ms sdpa {lib_ms:.4f} ms bound {b[0]:.4f} ms "
        f"({b[1]}); launches {launches[key]}; {card}")
    if not (bool(torch.isfinite(y).all()) and err <= SEG_REL_BOUND
            and k6_err <= SEG_K6_BOUND):
        raise AssertionError(f"{name} disagrees")
    rows[key] = _form_result(name, replaces, source, mae, ms, plain_ms,
                             lib_ms, b)
    del q6, k6, v6, qp, kp, vp, y, ref

    # K5 and K6 at the DiT's training shapes; K6's bf16 io driven once
    for D in WIDTH_DIT:
        for key in (f"train_attention_d{D}", f"train_attention_cross_d{D}",
                    f"temporal_attention_d{D}",
                    f"temporal_attention_bf16_d{D}"):
            rows[key] = phase_train_kernel(dev, *entries[key], key)
        key = f"temporal_attention_bf16_d{D}"
        fn, ins, *_ = train_attention_case(dev, key)
        _, launches[key] = _drive(counts, fa.temporal_launch_key(D),
                                  lambda: fn(ins))
    torch.cuda.empty_cache()

    # K7 at heads of 48 and 96; fp32 at 96 counts main_vae's launches
    r, drive = vae_form_rows(dev, card, WIDTH_VAE_FORMS, "[widths]")
    rows.update(r)
    launches.update({k_: n for k_, n in drive.items()
                     if k_ not in vae_form_keys("float32",
                                                VAE_C // WIDTH_VAE_HEADS)})
    torch.cuda.empty_cache()

    # the DiT's trainer at heads of 16 and 128
    work = tempfile.mkdtemp(prefix="gvf_widths_smoke_")
    try:
        data = os.path.join(work, "data")
        write_latent_dataset(data, items=2, seed=52)
        config = os.path.join(REPO, "configs", "diffusion.yml")
        for D in WIDTH_DIT:
            keys = (fa.launch_key(D, False, False),
                    fa.launch_key(D, True, False), fa.temporal_launch_key(D))
            want = dict(zip(keys, (12, 24, 12)))
            torch.cuda.reset_peak_memory_stats()
            rc, text, wall = run_main_latent([
                "--config", config, f"--data_dir={data}",
                f"--exp_dir={os.path.join(work, f'exp_d{D}')}",
                f"--model.num_heads={C // D}", "--train.log_interval=1",
                "--train.save_interval=1000000", "--train.total_steps=1"])
            got = {k_: n for k_, n in read_counts().items() if n}
            losses = _losses(text)
            log(f"[widths] main_latent.main --model.num_heads={C // D} "
                f"(heads of {D}{_padded(D)}), 1 micro-step: rc {rc}, "
                f"{wall:.1f} ms whole, losses {losses}, step times "
                f"{_step_times(text)} s, peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                f"launches {got}; {card}")
            if rc != 0 or got != want or len(losses) != 1 or not all(
                    math.isfinite(x) for x in losses):
                raise AssertionError(f"main_latent at heads of {D}: rc {rc},"
                                     f" launches {got} (want {want}), losses"
                                     f" {losses}")
            launches.update(zip((f"train_attention_d{D}",
                                 f"train_attention_cross_d{D}",
                                 f"temporal_attention_d{D}"),
                                (got[k_] for k_ in keys)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[widths] phase in {time.perf_counter() - t0:.1f} s")
    return rows, launches


# -- [sublayer-widths]: K1, K2 and K3 at every head width their rules admit --


def _sw_seg_view(a):
    """K2's [B, T, N, C] as K1's seg rows: [B N / 16, T x 16, C], 16
    voxels of T frames interleaved (the DiT's packed temporal layout)."""
    return a.reshape(B, T, N // SEG_VOXELS, SEG_VOXELS, a.shape[-1]).permute(
        0, 2, 1, 3, 4).reshape(B * N // SEG_VOXELS, T * SEG_VOXELS,
                               a.shape[-1]).contiguous()


def _sw_single_inputs(dev, d):
    """K3's single context at the compacted torso's [1, 4096, 1024] fp32
    residual, 1024 / d heads, k and v the halves of the [1, 1374, 2048]
    projection of the image tokens; the parameters with the q gamma."""
    import torch

    Cx = 1024
    g = torch.Generator(device=dev).manual_seed(53 + d)
    r = lambda *s_, sc=1.0: torch.randn(*s_, generator=g, device=dev) * sc
    gamma = (1.0 + 0.1 * r(Cx)) * d ** 0.5
    p = (1 + 0.1 * r(Cx), 0.1 * r(Cx), r(Cx, Cx, sc=Cx ** -0.5),
         0.1 * r(Cx), gamma, r(Cx, Cx, sc=Cx ** -0.5), 0.1 * r(Cx))
    return r(1, TORSO, Cx), p, r(1, L_IMG, 2 * Cx)


def single_update_f64(x, p, kvp, heads, rms):
    """K3's single context's update y - x in fp64 on the first F64_ROWS
    rows: affine LN, q (RMS-normed with p's qg when rms), softmax attention
    at D ** -0.5, the out projection; p = (ns, nb, wq, bq, qg, wo, bo), k
    and v the halves of kvp."""
    import torch
    import torch.nn.functional as F

    ns, nb, wq, bq, qg, wo, bo = (None if a is None else a.double()
                                  for a in p)
    Cx = x.shape[-1]
    x64 = x[:, :F64_ROWS].double()
    rows = x64.shape[1]
    q = (F.layer_norm(x64, (Cx,), ns, nb, eps=1e-6) @ wq + bq).view(
        1, rows, heads, -1)
    if rms:
        q = (q * (q.square().sum(-1, keepdim=True) + 1e-12).rsqrt()).view(
            1, rows, Cx) * qg
        q = q.view(1, rows, heads, -1)
    k, v = (a.double().view(1, L_IMG, heads, -1)
            for a in (kvp[..., :Cx], kvp[..., Cx:]))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (Cx // heads) ** -0.5
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    return o.reshape(1, rows, Cx) @ wo + bo


def _sw_case(dev, form, d, cases, single):
    """One form at width d: (x, the call (impl=None: the card), the
    library composition, [(operations, peak)], the tensors moved, what
    it runs on, the counter of its launch)."""
    import torch
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    q8 = form.endswith("q8") or form == "cross_q8_rms"
    if form.startswith("cross_single"):
        x, p, kvp = single
        f32 = form.endswith("fp32")
        rms = "rms" in form or q8
        dt = torch.float32 if f32 else torch.bfloat16
        heads = x.shape[-1] // d
        p = tuple(a.to(dt) for a in p)
        kvp = kvp.to(dt)
        kv = (kvp[..., :x.shape[-1]], kvp[..., x.shape[-1]:])
        kw = dict(num_heads=heads, rms=rms, compute_dtype=dt)
        if q8:
            kv = int8_cache(tuple(a.contiguous() for a in kv), heads)
            kw.update(quant=True, q_block=128)
        p6 = p[:4] + p[5:]
        lib = (lambda: library_cross_single_rms(x, p, (kvp[..., :1024],
                                                       kvp[..., 1024:]),
                                                heads)) if rms else \
            (lambda: (library_cross_single_f32 if f32 else
                      library_cross_single)(x, p6, (kvp[..., :1024],
                                                    kvp[..., 1024:]), heads))
        Cx = x.shape[-1]
        flops = 2 * 2 * TORSO * Cx * Cx + 4 * TORSO * L_IMG * Cx
        qk = 2 * TORSO * L_IMG * Cx
        ops = ([(3 * flops, PEAK_TF32)] if f32 else
               [(flops - qk, PEAK_FLOPS), (qk, PEAK_INT8)] if q8 else
               [(flops, PEAK_FLOPS)])
        return dict(x=x, call=lambda impl=None: fsl.fused_cross_sublayer(
            x, p, kv, **kw, impl=impl), lib=lib, ops=ops,
            moved=(x, p, kv, x), what=f"x {tuple(x.shape)} fp32, "
            f"{'fp32' if f32 else 'bf16'} compute, {heads} heads",
            key=fsl.single_launch_key(dt, d, rms=rms and not q8, quant=q8),
            f64=(p, kvp, heads, rms) if f32 else None)
    rms = not form.endswith("norms_off")
    if form.startswith("self_seg"):
        x4, c = cases["temporal"]
        heads = c["kw"]["num_heads"]
        args = c["args"][1:]
        x = _sw_seg_view(x4)
        kw = dict(num_heads=heads, rms=True, seg=SEG_VOXELS,
                  mod_repeat=x.shape[0], quant_qk=q8)
        Cx = x.shape[-1]
        flops, qk = (4 * B * N * T * T * Cx, 2 * B * N * T * T * Cx)
        flops += 2 * B * T * N * Cx * 4 * Cx
        return dict(x=x, call=lambda impl=None: fsl.fused_self_sublayer(
            x, *args, **kw, impl=impl),
            lib=lambda: library_temporal(x4, *args, num_heads=heads),
            ops=[(flops - qk, PEAK_FLOPS),
                 (qk, PEAK_INT8 if q8 else PEAK_FLOPS)],
            moved=(x, args, x), what=f"x {tuple(x.shape)} bf16 (K2's "
            f"{tuple(x4.shape)} voxel-major), {heads} heads",
            key=fsl.launch_key(SW_FORMS[form][2], d))
    base = form.split("_")[0]
    x, c = cases[base]
    heads = c["kw"]["num_heads"]
    L_, Cx = x.shape[-2], x.shape[-1]
    if base == "cross":
        _, p1, kv1, p2, kv2 = c["args"]
        args = (x, p1, kv1, p2, kv2)
        if q8:
            args = (x, p1, int8_cache(kv1, heads), p2, int8_cache(kv2, heads))
        kw = dict(num_heads=heads, rms=form.endswith("rms"), quant=q8)
        lk = kv1[0].shape[1] + kv2[0].shape[1]
        R = x.shape[0] * L_
        flops = 2 * 2 * (2 * R * Cx * Cx) + 4 * R * lk * Cx
        qk = 2 * R * lk * Cx
        lib = lambda: library_cross(x, p1, kv1, p2, kv2, heads,
                                    rms=kw["rms"])
        fn = fsl.fused_cross_sublayer
    else:
        args = c["args"]
        kw = dict(c["kw"], rms=rms, quant_qk=q8)
        R = x.numel() // Cx
        keys = L_ if base == "self" else x.shape[1]  # N, or T frames
        flops = 2 * R * Cx * 4 * Cx + 4 * R * keys * Cx
        qk = 2 * R * keys * Cx
        libf = library_self if base == "self" else library_temporal
        lib = lambda: libf(*args, **dict(c["kw"], rms=rms))
        fn = fsl.fused_self_sublayer if base == "self" else \
            fsl.fused_temporal_sublayer
    return dict(x=x, call=lambda impl=None: fn(*args, **kw, impl=impl),
                lib=lib, ops=[(flops - qk, PEAK_FLOPS),
                              (qk, PEAK_INT8 if q8 else PEAK_FLOPS)],
                moved=(args, x), what=f"x {tuple(x.shape)} bf16, {heads} "
                f"heads", key=fsl.launch_key(SW_FORMS[form][2], d))


def sw_forms(dev, card, entries, failures):
    """Each form of SW_KERNELS against its plain version (fp32 K3 single
    also against fp64), timed beside it and the library composition,
    driven once through its wrapper with the counters at 0. Returns (the
    rows, the launches of the drives)."""
    import torch
    from gvfdiffusion_torch.ops import fused_sublayer as fsl

    counts = lambda: fsl.launch_counts  # noqa: E731
    rows, launches = {}, {}
    for d in SW_NARROW + SW_WIDTHS:
        g = torch.Generator(device=dev).manual_seed(50 + d)
        if d in SW_NARROW:
            cases = sublayer_cases(dev, g, heads=SW_NARROW_C // d,
                                   rms_cross=True, c=SW_NARROW_C,
                                   rows=SW_NARROW_FRAMES)
        else:
            cases = sublayer_cases(dev, g, heads=C // d, rms_cross=True)
        single = _sw_single_inputs(dev, d) if d in SW_WIDTHS else None
        for form in _sw_forms(d):
            key = f"sw_{form}_d{d}"
            name, replaces, source = entries[key]
            cs = _sw_case(dev, form, d, cases, single)
            x = cs["x"]
            with torch.no_grad():
                y, launches[key] = _drive(counts, cs["key"], cs["call"])
                ref = cs["call"]("plain")
                err = rel_l2(y, ref)
                upd = rel_l2(y.float() - x.float(), ref.float() - x.float())
                mae = float((y.float() - ref.float()).abs().max())
                ms = time_ms(cs["call"])
                plain_ms = time_ms(lambda: cs["call"]("plain"), iters=2,
                                   warm=1)
                lib_ms = time_ms(cs["lib"], iters=5)
                f64 = ""
                f64_ok = True
                if cs.get("f64"):
                    u64 = single_update_f64(x, *cs["f64"])
                    x64 = x[:, :F64_ROWS].double()
                    e_k = rel_l2_64(y[:, :F64_ROWS].double() - x64, u64)
                    e_p = rel_l2_64(ref[:, :F64_ROWS].double() - x64, u64)
                    f64 = (f"; update against fp64 on the first {F64_ROWS} "
                           f"rows: kernel {e_k:.3e} (bound "
                           f"{SW_F64_BOUNDS[key]:g}), plain fp32 {e_p:.3e}")
                    f64_ok = e_k <= SW_F64_BOUNDS[key]
            b = _bound_mixed(cs["ops"], nbytes(*cs["moved"]))
            y_bound, upd_bound = SW_BOUNDS[key]
            log(f"[sublayer-widths] {name}: {cs['what']}: max_abs_err "
                f"{mae:.4g} rel_l2 {err:.3e} (bound {y_bound:g}) "
                f"update_rel_l2 {upd:.3e} (bound {upd_bound:g}){f64}; "
                f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms library "
                f"{lib_ms:.4f} ms bound {b[0]:.4f} ms ({b[1]}, at D = {d});"
                f" launches {launches[key]}; {card}")
            if not (bool(torch.isfinite(y).all()) and err <= y_bound
                    and upd <= upd_bound and f64_ok):
                failures.append(name)
            rows[key] = _form_result(name, replaces, source, mae, ms,
                                     plain_ms, lib_ms, b)
            del y, ref, cs
        del cases, single
        torch.cuda.empty_cache()
    return rows, launches


def sw_runs(vae, ci, dev, card, failures):
    """VideoTo4DPipeline.run with the 12 x 512 bf16 DiT at 32 and 4 heads
    (seeded init_random_ weights) on the frames' tokens and the canonical
    splat: 32 DPM-Solver++ steps under the dual CFG (2.0 / 5.0, the cache
    hoisted), on the float cache, on the int8 cache, and on the int8 cache
    with int8 QK, each followed by render_4d of its deltas; each run's
    launches (384 of each sublayer under its width's counter) and the int8
    runs against the float run. Returns the launches of the kernels-line
    entries these runs drive."""
    import torch
    from gvfdiffusion_torch.models.dit import DiT
    from gvfdiffusion_torch.ops import fused_sublayer as fsl
    from gvfdiffusion_torch.ops._widths import sublayer_card_width
    from gvfdiffusion_torch.pipelines.video_to_4d import (
        VideoTo4DConfig, VideoTo4DPipeline)
    from gvfdiffusion_torch.representations.gaussians import from_activated
    from gvfdiffusion_torch.utils.weights import init_random_

    gs, valid = canonical_splat(dev)
    counts = {}
    modes = ((None, None), ("int8", None), ("int8", "int8"))
    n = 12 * SW_RUN_STEPS
    for heads in SW_DIT_HEADS:
        d = C // heads
        dit = init_random_(DiT(dtype=torch.bfloat16, num_heads=heads),
                           seed=30).to(dev).eval()
        cfg = dict(order=2, guidance_scale=2.0, guidance_scale2=5.0)
        VideoTo4DPipeline(dit, vae, VideoTo4DConfig(steps=2, **cfg)).run(
            gs, valid, ci, generator=torch.Generator(device=dev).manual_seed(
                4))  # warm-up
        outs = {}
        for kv_quant, self_quant in modes:
            pipe = VideoTo4DPipeline(dit, vae, VideoTo4DConfig(
                steps=SW_RUN_STEPS, kv_quant=kv_quant,
                self_quant=self_quant, **cfg))
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            g = torch.Generator(device=dev).manual_seed(5)
            out = pipe.run(gs, valid, ci, generator=g)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = {k: v for k, v in read_counts().items() if v}
            video = pipe.render_4d(from_activated(gs[0]),
                                   out["deltas"][0] * RENDER_DELTA_SCALE,
                                   valid[0], num_views=1, resolution=512)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            check_outputs(out, B, T, G)
            if tuple(video.shape) != (T, 1, 512, 512, 3) or not bool(
                    torch.isfinite(video).all()):
                raise AssertionError(f"render_4d: {tuple(video.shape)}")
            sq = "_q8" if self_quant else ""
            want = {fsl.launch_key("self" + sq, d): n,
                    fsl.launch_key("temporal" + sq, d): n,
                    fsl.launch_key("cross_q8" if kv_quant else "cross", d): n,
                    "mlp": n}
            mode = {None: "float cache", "int8": "int8 cache"}[kv_quant] + (
                " + int8 QK" if self_quant else "")
            log(f"[sublayer-widths] VideoTo4DPipeline.run, DiT 12 x 512 bf16 "
                f"at {heads} heads of {d} (run at {sublayer_card_width(d)}; "
                f"{mode}, guidance "
                f"2.0/5.0, {SW_RUN_STEPS} steps, G={G}): run() "
                f"{(t1 - t0) * 1e3:.1f} ms, render_4d ({T} frames, 512^2) "
                f"{(t2 - t1) * 1e3:.1f} ms; peak {peak:.2f} GiB; launches "
                f"{got}; {card}")
            if got != want:
                raise AssertionError(f"run() at heads of {d} ({mode}): "
                                     f"launches {got}, expected {want}")
            outs[mode] = out
            if kv_quant is None:
                for form in ("self", "temporal", "cross"):
                    counts[f"sw_{form}_d{d}"] = got[fsl.launch_key(form, d)]
            elif self_quant is None:
                counts[f"sw_cross_q8_d{d}"] = got[fsl.launch_key("cross_q8",
                                                                 d)]
            else:
                for form in ("self_q8", "temporal_q8"):
                    counts[f"sw_{form}_d{d}"] = got[fsl.launch_key(form, d)]
        for mode in list(outs)[1:]:
            errs = {k: rel_l2(outs[mode][k], outs["float cache"][k])
                    for k in ("latent", "deltas")}
            bounds = SW_RUN_BOUNDS[d]
            log(f"[sublayer-widths] heads of {d}, {mode} vs the float cache "
                "(same noise) rel_l2 " + ", ".join(
                    f"{k} {v:.3e}" for k, v in errs.items())
                + f" (bounds {bounds})")
            if any(errs[k] > b_ for k, b_ in bounds.items()):
                failures.append(f"run() at heads of {d}, {mode}")
        del dit, outs
        torch.cuda.empty_cache()
    return counts


def sw_block(dev, card, failures):
    """K3's single context at heads of 16 on a model's path: one
    ModulatedSparseCrossBlock of the SLat torso (C = 1024, 64 heads,
    init_random_ weights) at the compacted torso's 4096 slots
    (L_TORSO_VALID valid) against 1374 image tokens, computing in bf16 and
    in fp32, kernels against impl="plain" on the valid slots. Returns the
    launches of K3's single context in each."""
    import torch
    from gvfdiffusion_torch.models.trellis.slat_flow import (
        ModulatedSparseCrossBlock)
    from gvfdiffusion_torch.ops import fused_sublayer as fsl
    from gvfdiffusion_torch.sparse.tensor import SparseVoxels
    from gvfdiffusion_torch.utils.weights import init_random_

    Cx, heads = 1024, 64
    blk = init_random_(ModulatedSparseCrossBlock(Cx, heads, ctx_channels=Cx),
                       seed=37).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(38)
    valid = torch.zeros(1, TORSO, dtype=torch.bool, device=dev)
    valid[:, :L_TORSO_VALID] = True
    feats = torch.randn(1, TORSO, Cx, generator=g, device=dev) * valid[
        ..., None]
    coords = torch.zeros(1, TORSO, 3, dtype=torch.int32, device=dev)
    x = SparseVoxels(feats=feats, coords=coords, valid=valid, resolution=32)
    mod = torch.randn(1, Cx, generator=g, device=dev)
    ctx = torch.randn(1, L_IMG, Cx, generator=g, device=dev)
    counts = {}
    for dt, form in ((torch.bfloat16, "cross_single"),
                     (torch.float32, "cross_single_fp32")):
        key = fsl.single_launch_key(dt, Cx // heads)
        with torch.no_grad():
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            y = blk(x, mod, ctx, dt).feats
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = {k: v for k, v in read_counts().items() if v}
            ref = blk(x, mod, ctx, dt, impl="plain").feats
        err = rel_l2(y[valid], ref[valid])
        bound_ = SW_BLOCK_BOUNDS[form]
        log(f"[sublayer-widths] ModulatedSparseCrossBlock C {Cx}, {heads} "
            f"heads of {Cx // heads}, {str(dt)[6:]}, x {tuple(feats.shape)} "
            f"({L_TORSO_VALID} valid) x {L_IMG} tokens: kernels vs plain "
            f"rel_l2 {err:.3e} (bound {bound_:g}), forward {ms:.1f} ms, "
            f"launches {got}; {card}")
        if got.get(key) != 1 or not bool(torch.isfinite(y).all()) \
                or err > bound_:
            failures.append(f"the block at heads of 16, {dt}")
        counts[f"sw_{form}_d16"] = got.get(key, 0)
    del blk
    torch.cuda.empty_cache()
    return counts


def phase_sublayer_widths(vae, ci, dev, card):
    """[sublayer-widths]: every form of SW_KERNELS at full width against its
    plain version (sw_forms); VideoTo4DPipeline.run with the DiT at 32 and
    4 heads in its three cache / QK modes (sw_runs); the fused DiT block
    under autograd at both (forms_dit_grad); K3's single context at heads
    of 16 through a ModulatedSparseCrossBlock (sw_block). Every check runs;
    the phase fails at its end if any did. Returns (the rows, the
    launches)."""
    import torch

    t0 = time.perf_counter()
    entries = {e[3]: e[:3] for e in SW_KERNELS}
    failures = []
    rows, launches = sw_forms(dev, card, entries, failures)
    launches.update(sw_runs(vae, ci, dev, card, failures))
    for heads in SW_DIT_HEADS:
        forms_dit_grad(dev, card, num_heads=heads, kv_quants=(None,),
                       tag="[sublayer-widths]",
                       bounds=SW_GRAD_BOUNDS[C // heads])
    torch.cuda.empty_cache()
    launches.update(sw_block(dev, card, failures))
    log(f"[sublayer-widths] phase in {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError(f"[sublayer-widths] disagree: {failures}")
    return rows, launches


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from gvfdiffusion_torch import _ext
    except ImportError:
        print("chip_smoke: gvfdiffusion_torch not found beside this script",
              file=sys.stderr)
        return 1
    quick = "--quick" in argv
    t_start = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)  # as nvidia-smi prints it: name, power limit
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda:0")

    t0 = time.perf_counter()
    _ext.load()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({_ext.library_path().name})")

    if "--profile" in argv or "--split" in argv:
        phase_profile_split(dev, card)
        if "--profile" in argv:
            phase_profile(*build_models(dev), dev, card)
        return 0
    if "--vae" in argv:
        phase_vae_kernels(dev)
        phase_vae_forms(dev, card)
        phase_vae_train(dev, card)
        return 0
    if "--encode-latent" in argv:
        phase_encode_latent(dev, card)
        return 0
    if "--forms" in argv:
        phase_forms(dev, card)
        return 0
    if "--widths" in argv:
        phase_widths(dev, card)
        return 0
    if "--wide-heads" in argv:
        phase_wide_heads(dev, card)
        return 0
    if "--sublayer-widths" in argv:
        from gvfdiffusion_torch.scripts.process_video import encode_video

        dino, dit, vae = build_models(dev)
        ci = encode_video(seeded_frames(), dino, device="cuda")[None]
        del dino, dit
        torch.cuda.empty_cache()
        phase_sublayer_widths(vae, ci, dev, card)
        return 0
    if "--pipeline" in argv:
        phase_pipeline(*build_models(dev), dev, card)
        return 0
    if "--infer" in argv:
        for name, replaces, source, key in KERNELS:
            if key.startswith("infer_"):
                phase_train_kernel(dev, name, replaces, source, key)
        dino, dit, vae = build_models(dev)
        from gvfdiffusion_torch.scripts.process_video import encode_video

        ci = encode_video(seeded_frames(), dino, device="cuda")[None]
        del dino, dit, vae
        torch.cuda.empty_cache()
        phase_infer(ci, *canonical_splat(dev), dev, card)
        return 0
    if "--wild-files" in argv:
        name, replaces, source, key = next(e for e in KERNELS
                                           if e[3] == "attention_dino224")
        phase_attention(dev, name, replaces, source, key)
        dino, dit, vae = build_models(dev)
        from gvfdiffusion_torch.scripts.process_video import encode_video

        ci = encode_video(seeded_frames(), dino, device="cuda")[None]
        _, tpipe = phase_trellis(dino, dit, vae, ci, dev, card)
        phase_wild_files(dino, tpipe, dit, vae, dev, card)
        return 0
    # each phase's wall time, printed at the end ([smoke] phase seconds)
    seconds, last = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        seconds[name] = round(now - last[0], 1)
        last[0] = now

    results = phase_kernels(dev)
    mark("kernel")
    vae_forms, vae_form_launches = phase_vae_forms(dev, card)
    results.update(vae_forms)
    mark("vae-forms")
    if quick:
        return 0
    forms, form_launches = phase_forms(dev, card)
    results.update(forms)
    mark("forms")
    widths, width_launches = phase_widths(dev, card)
    results.update(widths)
    mark("widths")
    wide, wide_launches = phase_wide_heads(dev, card)
    results.update(wide)
    mark("wide-heads")
    phase_profile_split(dev, card, traces=False)
    mark("split")
    dino, dit, vae = build_models(dev)
    phase_dinov2(dino, dev, card)
    phase_dit(dit, dev)
    mark("dinov2, dit")
    launches, ci = phase_pipeline(dino, dit, vae, dev, card)
    mark("main .. selfq8")
    launches.update(phase_infer(ci, *canonical_splat(dev), dev, card))
    mark("infer")
    configs = phase_dit_configs(vae, ci, dev, card)
    mark("dit-config")
    sw_rows, sw_launches = phase_sublayer_widths(vae, ci, dev, card)
    results.update(sw_rows)
    mark("sublayer-widths")
    trellis, tpipe = phase_trellis(dino, dit, vae, ci, dev, card)
    mark("trellis")
    phase_wild(tpipe, dit, vae, ci, dev, card)
    mark("wild")
    launches.update(phase_wild_files(dino, tpipe, dit, vae, dev, card))
    mark("wild-files")
    phase_early_exit(dev, card)
    del dit, vae, ci, tpipe
    torch.cuda.empty_cache()
    trellis["flash_attention"] = phase_trellis_defaults(dino, dev, card)
    del dino
    torch.cuda.empty_cache()
    mark("early-exit, trellis32k")
    tpipe32, staged32, pre32, fp32 = phase_trellis_fp32(dev, card)
    trellis.update({k: fp32[k] for k in ("flash_attention_fp32",
                                         "cross_single_fp32")})
    mark("trellis-fp32")
    phase_trellis_drift(tpipe32, staged32, pre32, dev, card)
    trellis.update(phase_trellis_heads(tpipe32, staged32, dev, card))
    del tpipe32, staged32
    torch.cuda.empty_cache()
    mark("trellis-drift, trellis-heads")
    train = phase_training(dev, card)
    torch.cuda.empty_cache()
    mark("train")
    vae = phase_vae_train(dev, card)
    torch.cuda.empty_cache()
    mark("vae-train")
    results[ENCODE_FLASH], vae[ENCODE_FLASH] = phase_encode_latent(dev, card)
    mark("encode-latent")
    # each entry's count comes from one run: the TRELLIS forms from
    # TrellisImageTo3DPipeline.run (K7 from the run at the defaults; K7 and
    # K3's single context in fp32 from the run of the registry's fp32
    # TRELLIS; both at heads of 32 and 128, in fp32 and bf16, from
    # sample_slat of the SLat flow at those widths, [trellis-heads]), the
    # training forms (K5 at heads of 32, K6) from main_latent.main's first
    # run (K6 at heads of 64 from its dit-d64 run), K3's int8 form from
    # run() on the int8 cache, K1 and K2 with int8 QK from run() with
    # self_quant, K7's residual forward and backward kernels from
    # main_vae's run in `full` attention ([vae-train]: its first step's
    # log; every step launches the same), K7's backward forms in fp32 at
    # heads of 32 and 128 from main_vae's runs at 24 and 6 heads, in bf16
    # from their own drive in [vae-forms], K7 at the static VAE's batch of 1
    # from encode_latent's run ([encode-latent]), K7 above 128 lanes from
    # main_vae's runs at 4 and 1 heads and at 1152 channels (fp32) and the
    # bf16 static VAE's steps at those heads ([vae-train]) and, without its
    # residual, from the static VAE's encode in [wide-heads] (at a head of
    # 3136 from its drive there), the forms no path reaches
    # from their own drive in [forms], the forms of the DiT's other
    # configurations from the
    # run() of the configuration that sends them (FORM_RUNS), the others
    # (K1-K4, K5 in DINOv2's video encode) from the video main path
    counts = {**launches, **configs, **trellis, **train, **vae,
              **form_launches, **vae_form_launches, **width_launches,
              **sw_launches, **wide_launches}
    for key, r in results.items():
        r["launches"] = counts[key]
    log(f"[smoke] phase seconds: {seconds}")
    log(f"[smoke] every phase in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [results[k] for *_, k in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
