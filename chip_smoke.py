#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gesturediffusion_tpu_torch) on one
NVIDIA card: ``python3 chip_smoke.py`` from the root of the repository.

Phases, each fatal on failure:
  1. device   card name, count, power limit; TF32 switched off
  2. build    nvcc builds every kernel from csrc/ (in parallel), printing
              the -Xptxas -v register / shared-memory / spill lines, and
              counts the TF32 tensor-core instructions (wgmma's HGMMA,
              mma.sync's HMMA) of each training-layer kernel and of the
              band and local-block kernels in their SASS
  3. parity   each kernel against its plain PyTorch version on the card at
              the main-path shapes, with the tolerance stated: the sampling
              kernels at batch 82, the training layer's forward (rates 0.1
              and 0) and backward (dx and 12 gradients) at microbatch 64 and
              81 rows (80 frames and the token), 121 rows (the train CLI's
              default 120 frames) and 201 rows (off every tile); the local
              block and the band kernel at tile edges (lengths, windows,
              head widths, aliased and separate operands); kernels 1, 4, 5
              and 6 at the head widths the kernels pad (8, 66, 80, 96) and
              at those past 128 that run in 128-column slices (136, 256,
              264, 520, ff 4 D), and at D = 130, F = 1030 (2 heads of 65:
              rows not 16-byte aligned) at T 81 and 1201 (training 81 and
              121); the band kernel and the local block at local heads of
              136 and 264, the local block at heads of 128 and 256 frames
              (past a block's shared memory); the training layer at 81
              rows also at row offset 64 (rank 1's share of phase 18's
              global batch of 128)
  4. sample   the full-width gesture MDM V2 (J=498, D=256, 8 layers) with
              seeded random weights samples a 41-take, 2-chunk CFG take
              (batch 82) through select_sampling_model_fn ->
              autoregressive_sample_loop, counting kernel launches; the same
              take re-runs with the plain versions on the card and the two
              are compared; then the generate CLI runs on a checkpoint
              written here
  5. train    the same model with use_fused_train_encoder takes 5 training
              steps at batch 256 (4 microbatches of 64) with injected
              timesteps and noise, counting 32 forward and 32 backward
              launches a step; the same steps with the plain versions are
              compared with it; then the train CLI trains 20 steps on
              --dataset synthetic at its default --num_frames 120 (launches
              counted again) and the generate CLI samples from the
              checkpoint it wrote
  6. times    kernel, plain and library-call times (CUDA events), take and
              train-step throughput and peak memory, and a profile of a
              denoise step and of a train step, with the card name and
              power limit; the training kernels at 81 and 121 rows and the
              device kernels one forward and backward launch (none of them a
              library kernel); the train-step profile summed by kernel
  7. long     long-chunk sampling at 1200 frames: the band-attention kernel
              at [82, 8, 1200, 32], the flash kernel at [82, 4, 1201, 64]
              (and at a length off its tile), the encoder layer with its
              flash stage at [82, 1201, 256], each against its plain
              version; the same model samples a 41-take, 2-chunk take at
              T = 1200 (20 DDPM steps) with launch counts, against the plain
              take; the generate CLI at --num_frames 1200; kernel, plain and
              library times, the SDPA backend the library yardstick ran
              (from the profiler's kernel names), take throughput and a
              profile of a long denoise step
  8. widths   a --latent_dim 320 model (4 heads of 80, local heads of 40,
              2 layers) takes one denoise step at T = 1200 through the
              kernels (launches counted) against the plain path, then the
              generate CLI samples --num_frames 1200 from its checkpoint;
              a --latent_dim 1024 model (heads of 256) takes the same step;
              the flash kernel's times at heads of 256 and 520 and the
              --latent_dim 1024 encoder layer's, at CFG batch 82, T = 1201
  9. genea    the GENEA data path and streaming serve at full width on the
              phase-4 model: a synthetic GENEA-2023 tree (41 takes of 480
              frames a split, pose 498; the val MFCC cache's build time),
              the generate CLI on it (41 takes x 5 chunks, .bvh, _gt.bvh,
              .wav) against the same take sampled in this process; the
              streaming session at 41 streams (DDPM-50) against that take,
              launches a chunk counted; per-chunk latency at 1 and 4
              streams, DDPM-50 and DDIM-50, and a profile of a streams-1
              chunk; the demo CLI (4 streams, 3 chunks, DDIM-50) from the
              val split and from a wav; the train CLI on the train split (5
              steps, batch 64, 120 frames, launches counted)
 10. t2m      text-to-motion sampling and motion editing: the
              humanml-encoder-512 MotionMDM (263 features, D 512, 8 layers of
              4 heads of 128, 197 rows) with seeded random weights as a
              reference-layout .pt, a random CLIP text tower at ViT-B/32 width
              with a synthetic BPE file (CLIP_CHECKPOINT, CLIP_BPE_PATH), a
              synthetic HumanML3D tree of 30 clips; the encoder layer at
              [6, 197, 512] and [64, 197, 512] against its plain version; a
              predict take (3 repetitions, CFG batch 6, DDPM respaced to 50)
              against the plain take, 8 launches a step; the predict CLI at
              the reference configuration (1000 steps, 196 frames); the edit
              CLI in_between and upper_body on the tree and in_between on the
              phase-9 gesture checkpoint, kept entries against the ground
              truth and launches counted; the tower's and the layer's times,
              a t2m denoise step's time and profile at CFG batch 6 and 64
 11. samplers PLMS (order 2) and DPM++(2M) on the phase-4 model: the
              41-take, 2-chunk take respaced to 20 steps with each, through
              the kernels (launches counted; PLMS's warm-up adds a model
              pass a chunk) against the plain take; the generate CLI with
              --sampler dpmpp; a streams-1 session's chunk latency at
              DPM++-20 beside DDIM-50
 12. t2m-train text-to-motion training of the phase-10 model: kernels 5
              and 6 at [64, 197, 512] (heads of 128, rates 0.1 and 0)
              against their plain versions and their times; 5 steps at batch
              64 with use_fused_train_encoder (8 forward and 8 backward
              launches a step) against the plain steps, a profiled step; the
              train CLI --dataset humanml on a synthetic tree of 240 clips
              (the CLIP tower embedding the captions; launches counted), the
              predict CLI on its checkpoint (kernel 1 counted) and a batch
              of 32 prompts on it (CFG batch 64); the flash kernel alone at
              [6, 4, 197, 128] and [64, 4, 197, 128]
 13. a2m-train action-to-motion training: a synthetic SMPL pickle at 6890
              vertices (SMPL_MODEL_PATH), synthetic HumanAct12 (128 clips)
              and UESTC (160 videos) trees; the training losses' SMPL joints
              (rotation2xyz, the kinematic chain only) on the card against
              the CPU; kernels 5 and 6 at [64, 61, 512] against their plain
              versions and their times; 5 steps of the action-mode MotionMDM
              (25 rows of rot6d, D 512, 8 layers of heads of 128) at batch
              64 with the recipe's lambdas (rcxyz, vel, fc) through the
              kernels against the plain steps, a profiled step with its
              idle share and the fk / SMPL share of its device time; the
              train CLI --dataset humanact12 and uestc with the recipe's
              flags (20 steps each, launches counted); the humanact12
              checkpoint read back in the reference layout, 12 actions
              sampled from it (DDPM respaced to 50: kernel 1 at
              [12, 61, 512]) against the plain take, kernel 1's times there
 14. a2m-eval action-to-motion evaluation: a third checkpoint (humanact12,
              --unconstrained); with PyTorch's TF32 defaults (cuDNN's on),
              the eval CLI --eval_mode debug --batch_size 64 on the
              humanact12, uestc and unconstrained checkpoints (the YAML's
              protocol keys, finite where the protocol is, kernels 1 and 4
              launched 8 x 1000 a generated batch, the wall time); seed 0's
              generated batch (kernel 1 at [64, 61, 512]) against the plain
              path; the GRU, recognition ST-GCN and MoDi ST-GCN features and
              the gt metrics on the card against the CPU (the modules with
              cuDNN's TF32 on as a control that must fail); kernel 1's times at
              [64, 61, 512]; the train CLI --eval_during_training on
              humanact12 (the benchmark after the save at step 10) and on
              the phase-9 GENEA tree (the validation loss), launches counted
 15. t2m-eval text-to-motion evaluation, with PyTorch's TF32 defaults:
              the eval_humanml CLI --eval_mode debug --guidance_param 2.5 on
              the phase-12 humanml checkpoint over its tree's test split (5
              replications of 2 batches of 32; kernels 1 and 4 at CFG batch
              64 launched 8 x 1000 a batch; every metric finite, the wall
              time); one generated batch against the plain path, its ms a
              CFG-64 denoise step; the T2M evaluators' text and motion
              embeddings and the ground truth's metrics on the card against
              the CPU (the modules with cuDNN's TF32 on as a control that must
              fail), their ms a batch; kernel 1 at [64, 197, 512] and
              [32, 197, 512] and its times; the train CLI --dataset humanml
              --eval_during_training (the benchmark at scale 1 after the save
              at step 10: kernel 1 at [32, 197, 512]), launches counted
 16. mesh     the mesh export: the predict CLI on the phase-12 checkpoint at
              3 repetitions of 6 s (120 frames; kernels 1 and 4 at CFG batch
              6 counted 8 x 1000); the render-mesh CLI on sample 0 with the
              phase-13 SMPL at 6890 vertices (13776 synthetic triangles) and
              the synthetic GMM (150 Adam steps a stage): 120 OBJs of 6890
              vertices and their faces, smpl_params.npy, stage 2's keypoint
              error below stage 1's; the joints2smpl CLI's _rot.npy
              [3, 25, 6, 120] and motions2hik's JSON; the fit card against
              CPU teacher-forced (the stage-2 objective's gradient at the
              same states) and free-running (the final keypoint error, a CPU
              fit from a one-ulp-nudged target beside it); ms an iteration of
              each stage, the fit's and the CLIs' wall times, a profiled
              iteration of each stage (launches, idle share)
 17. wav/V1  the last two gesture denoisers: MDMOld (MDM V1: J 498 + MFCC 26,
              D 256, 8 layers) with seeded weights written as a reference-layout
              V1 .pt and read back (the V2 loader refusing it) samples the
              phase-4 take (kernel 1 counted 8 a step, no local block) against
              the plain take; the wav-encoder MDM at the V2 width samples it
              from raw audio (80 x 735 samples a chunk: 59 frames of features
              padded to 80; kernels 1 and 2 counted) against the plain take;
              its wav encoder on the card against the CPU under its own float32
              guard with cuDNN's TF32 on outside it (the stack unguarded with
              TF32 allowed printed as a control); 5 wav-encoder train steps at
              batch 256 (4 x 64) through kernels 5 and 6 against the plain
              steps, the BatchNorm running statistics compared after each (the
              conv biases before the BatchNorms, whose gradient is zero in
              exact arithmetic, held against the model's largest gradient,
              grad_gap); the train CLI
              --use_wav_enc --use_fused_train_encoder on --dataset synthetic
              (launches counted) and the generate CLI on its checkpoint; a
              wav-encoder CFG denoise step's time, idle share and conv-stack
              share, an MDMOld step's and phase 4's fast-path step's
 18. parallel the multi-rank paths, ranks spawned as subprocesses of this
              script (``--parallel-rank``) with the GDT_* variables: the
              train CLI as a world of one rank on NCCL
              (--use_fused_train_encoder, launches counted); two ranks
              sharing the card over gloo (NCCL refuses two ranks on one
              device) take 5 steps of the phase-4 model's training variant
              at global batch 128 through kernels 5 and 6 with dropout on,
              at 2 x 1 (64 rows a rank, rank 1 at row offset 64) and at
              1 x 2 (each weight of the shape rule and its moments as
              halves), each held against the single-process steps on the
              card free-running and teacher-forced under TOL_STEP_LOSS and
              TOL_STEP_GRAD, launches counted per rank; a 42-take, 2-chunk
              take split over the two ranks and a 4-stream mesh= session
              against the single-process ones under TOL_TAKE (kernels 1
              and 2 counted).  The two-ranks-on-one-card times are a
              functional reading, not a scaling figure
 19. evaluators the last modules, on phase 12's humanml tree at the released
              widths: (a) CompV6 (text BiGRU 512, snippet GRUs 1024, movement
              latent 512, z 128, pose 263) on a Text2MotionDatasetBaseline
              batch of 32, lengths drawn from its length estimator, generate
              over max(m_lens) / 4 snippets, card against CPU with the noise
              injected (sub-networks TOL_CV6_NET, the take TOL_CV6_TAKE),
              ms, launches and idle share of a snippet step; (b) the four
              evaluator trainers, 5 steps each at batch 32 (the a2m
              classifier at 64 on phase 14's gt batch), card against CPU:
              the first step's loss and gradients TOL_TRAINER_GRAD, the
              losses TOL_TRAINER_LOSS, ms a step; (c) save_finest's
              finest.tar read by EvaluatorWrapper through T2M_EVALUATOR_PATH
              (a ground-truth batch's embeddings bit for bit the in-memory
              modules', the ground truth's metrics card vs CPU under
              TOL_EVAL_FEATS), a generated batch of 32 from phase 12's
              checkpoint (CFG 64, 1000 steps, kernels 1 and 4 counted) scored
              by evaluation() with the retrained and the random evaluators,
              the a2m tar through A2M_CLASSIFIER_PATH on phase 14's batches;
              (d) 5 gesture train steps at batch 256 (4 x 64) through kernels
              5 and 6 in four runs, GDT_SEED_DROPOUT unset, 1, 1, unset:
              losses, gradients and weights bit for bit equal, peak memory,
              the bytes autograd saved and ms a step of each; (e) the native
              library built with cc, its batch fills byte-equal to
              collate_gesture's numpy fills, ms a batch of both in PAIRS
              pairs of alternating order.  Every reading of (a) and (b) prints float32's one-ulp
              floor (a CPU run from inputs nudged by one ulp) beside it
Every train-step comparison (phases 5, 12, 13, 17) holds the kernel steps
against the plain steps two ways under TOL_STEP_LOSS and TOL_STEP_GRAD:
free-running (the losses of every step, the first step's gradients), with
the gap of a plain run from weights nudged by one ulp printed beside it;
and teacher-forced (each kernel step from the plain run's weights,
optimizer and generator states before it: its loss and every gradient,
with float32's own floor, the plain step from those weights nudged by one
ulp, beside it).  Phase 13's teacher-forced gradients miss TOL_STEP_GRAD
at some steps where the rot6d losses amplify the training GEMM's forward
error (ROADMAP C6): printed as a MISS up to TOL_STEP_GRAD_C6, a FAIL past
it; their losses stay under TOL_STEP_LOSS.
Every kernel's products run on the tensor cores in 3xTF32.  Kernel times
(`ms` in the kernels line) are CUDA events over back-to-back calls, the
wrapper's host work included, for all six kernels; for the band and
local-block kernels, whose calls the host work can outlast, the profiler's
device time of the kernel alone is printed beside it and kept under
`device_ms`.  The bound of
kernels 1, 4, 5 and 6 is the larger of bytes / 3.35 TB/s and 3 x FLOP /
495 TFLOP/s, and their rows print the achieved f32-equivalent TFLOP/s; the
bound of the band and local-block kernels (2, 3) counts the band's own
FLOP at the 67 TFLOP/s f32 rate (bytes bind them either way).  Each time
row prints the achieved share of its bound.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 and prints
no result.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense tensor cores; a 3xTF32 product takes three passes
PEAK_BYTES_PER_S = 3.35e12
B_TAKES, J, T, D, S, A = 41, 498, 80, 256, 10, 26
LAYERS, HEADS, FF, CL_HEADS, WINDOW = 8, 4, 1024, 8, 10
CHUNKS, RESPACING, STEPS, GUIDANCE = 2, "50", 50, 2.5
TOL_LOCAL_BLOCK = 1e-4   # f32; <= 20-term softmax sums, cos/sin within 2 ulp
TOL_ENCODER = 5e-4       # f32; K<=1024 sums in another order, LN rescaling
TOL_TAKE = 1e-3          # f32; 100 chained denoise steps of 8 layers each
MB, BATCH, RATE, TRAIN_STEPS, CLI_STEPS = 64, 256, 0.1, 5, 20
T_CLI = 120              # the train CLI's default --num_frames
PAIRS = 20               # phase 19 (e): timed pairs of the two collate fills
TRAIN_ROWS = (T + 1, T_CLI + 1, 201)  # training-layer parity; 201 = 3 x 64 + 9
TOL_TRAIN_FWD = 1e-4     # f32; as the inference layer, the same dropout masks
TOL_TRAIN_GRAD = 5e-4    # of each gradient's max |value|; weight grads sum 5184 rows
TOL_STEP_LOSS = 5e-4     # relative; 5 steps at batch 256 through 8 layers
TOL_STEP_GRAD = 2e-3     # of each parameter gradient's max |value|, first step
# phase 13's teacher-forced a2m gradients: a hard cap at ~1.3x the kernels' recorded error
# there (ROADMAP C6: worst 7.444e-03, at step 2, where float32's own one-ulp floor is
# 1.255e-03).  Past TOL_STEP_GRAD and within it the step prints a MISS naming C6; past
# it, a FAIL.  Every other step comparison and every teacher-forced loss keep TOL_STEP_*.
TOL_STEP_GRAD_C6 = 1e-2
T_LONG, LONG_RESPACING, LONG_STEPS, LONG_SAMPLES = 1200, "20", 20, 8
TOL_BAND = 1e-4          # f32; <= 20-term softmax sums, as the local block
TOL_FLASH = 2e-4         # f32; sums over 1201 keys in another order, online rescaling
C1_WIDTHS = (8, 66, 80, 96)  # head widths the kernels pad: --latent_dim 32, 264, 320, 384
# head widths past 128, in 128-column slices: --latent_dim 544, 1024, 1056, 2080
WIDE_WIDTHS = (136, 256, 264, 520)
WIDE_LOCAL = (136, 264)      # local heads past 128: --latent_dim 1088, 2112
D_C1, C1_LAYERS = 320, 2     # phase 8's model: 4 heads of 80, 8 local heads of 40
D_WIDE = 1024                # phase 8's second model: 4 heads of 256, 8 local heads of 128
G_TAKES, G_FRAMES = 41, 480  # phase 9's synthetic GENEA split: 5 val chunks of 80 a take
SERVE_CHUNKS = 5
# phase 10: the humanml-encoder-512 MotionMDM (4 heads of 128; 196 frames
# and the conditioning token = 197 rows), CFG at 2 x 3 repetitions for the
# predict CLI and at 64 for the timed step; the CLIP text tower at ViT-B/32
# width; a synthetic HumanML3D tree whose test split holds the edit CLI's
# default 10 clips
T2M_J, T2M_D, T2M_FRAMES, T2M_REPS, T2M_BIG = 263, 512, 196, 3, 32
T2M_RESPACING, T2M_STEPS = "50", 50
HML_CLIPS, EDIT_SAMPLES = 30, 10
CLIP_LAYERS, CLIP_WIDTH, CLIP_HEADS = 12, 512, 8
PROMPT = "a person walks forward and waves"
TOL_KEPT = 1e-5          # an edit's kept entries against the ground truth (x0 at t = 0)
# phase 11: PLMS (order 2, one warm-up pass a chunk) and DPM++(2M) respaced
# to 20 steps on the phase-4 take; a streams-1 session's chunks
SAMPLER_STEPS, SAMPLER_CHUNKS = 20, 5
# phase 12: the phase-10 model trained at batch 64 (196 frames + the token);
# a synthetic HumanML3D tree whose train split holds 80 clips
T2M_TRAIN_STEPS, T2M_TRAIN_CLIPS = 5, 240
# phase 13: the action-mode MotionMDM (25 rows of rot6d, D 512, 8 layers of
# 4 heads of 128) trained at batch 64 on 60 frames + the token, the
# recipe's geometric losses through SMPL at the real asset's 6890 vertices;
# synthetic HumanAct12 (128 clips) and UESTC (160 videos, 80 of them in the
# train split) trees; 12 actions sampled from the trained checkpoint
A2M_J, A2M_F, A2M_FRAMES, A2M_VERTS = 25, 6, 60, 6890
A2M_CLIPS, UESTC_VIDEOS, A2M_STEPS, A2M_ACTIONS = 128, 160, 5, 12
RECIPE = ("--cond_mask_prob", "0", "--lambda_rcxyz", "1", "--lambda_vel", "1",
          "--lambda_fc", "1")
TOL_SMPL = 1e-4          # f32 joints on the card against the CPU: 23 chained 4x4 products
# phase 14: the eval classifiers' features (and the gt metrics) on the card against the
# CPU, relative to their max |value|: f32 GRU over 60 frames and up to ten blocks of
# convolutions, sums in another order (TF32 off by the eval itself).  Between the sound
# readings (<= 2.389e-06) and the modules with cuDNN's TF32 on (>= 9.953e-05), which the
# phase runs as a control that must exceed it
TOL_EVAL_FEATS = 1e-5
# phase 15: the text benchmark's train hook scores this many samples (2 batches of 32)
EVAL_HOOK_SAMPLES = 64
# phase 17: the wav encoder's raw audio at the gesture contract's 22050 Hz / 30 fps, and
# the frames its four strided convolutions give for an 80-frame chunk
WAV_SPF, WAV_FRAMES = 735, 59
# the wav encoder's features on the card against the CPU, of their max |value|: four
# f32 convolutions, sums in another order (as TOL_EVAL_FEATS); the stack with cuDNN's TF32
# allowed and no guard is printed beside it as a control
TOL_WAV = 1e-5
# phase 16: the predict CLI on phase 12's checkpoint at 3 repetitions of 6 s (120 frames at
# 20 fps), then the SMPLify fit at the real SMPL's vertex and triangle counts with the
# synthetic gmm_08 (8 components of 69), 150 Adam steps a stage as the reference's CLIs
MESH_REPS, MESH_SECONDS, MESH_FRAMES, MESH_ITERS, MESH_FACES = 3, 6, 120, 150, 13776
TOL_FIT_GRAD = 1e-5      # the stage-2 gradient card vs CPU at one state, of its max |value|
# the whole fit's final keypoint error card vs CPU, relative: 300 Adam steps, each moving a
# parameter by ~lr whatever its gradient's size, read float32 chaos in the poses (the port
# on the CPU against JAX at T 20: poses 2.7e-2 apart, the error 6e-4 of itself)
TOL_FIT_FREE = 2e-2
# phase 19: the CompV6 baseline and the evaluator trainers at the released widths on phase
# 12's humanml tree, a batch of 32 (R-precision's; the a2m classifier at MB), 5 steps each.
# Card against CPU, of each output's or gradient's max |value|: a sub-network (GRUs over
# <= 49 steps, convolutions, products in another order) and a trainer's first-step loss and
# gradients TOL_CV6_NET / TOL_TRAINER_GRAD, as TOL_EVAL_FEATS; the whole take (<= 49
# chained snippets) TOL_CV6_TAKE; the five losses, relative, TOL_TRAINER_LOSS (each Adam
# step rounds its update in another order).  Each reading prints float32's one-ulp floor
# beside it.  diversity draws 30 pairs of the batch's 32 samples
EV_BATCH, EV_DIVERSITY, TRAINER_STEPS = 32, 30, 5
TOL_CV6_NET, TOL_CV6_TAKE = 1e-5, 1e-4
TOL_TRAINER_GRAD, TOL_TRAINER_LOSS = 1e-5, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def tensor_core_sass(name: str) -> dict:
    """{kernel (mangled name): {"HGMMA": n, "HMMA": n, "all": n}}: the TF32
    tensor-core instructions of each kernel in library ``name``'s SASS
    (cuobjdump -sass) and all its instructions, or {} where the toolkit has
    no cuobjdump."""
    from gesturediffusion_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    sass = subprocess.run([tool, "-sass", _build.library_path(name)], check=True,
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"HGMMA": 0, "HMMA": 0, "all": 0}
        elif fn is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[fn]["all"] += 1
            if "TF32" in line:
                for op in ("HGMMA", "HMMA"):
                    if op in line:
                        counts[fn][op] += 1
    return counts


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, kernel: str, iters: int = 20) -> float:
    """The device time of one launch of the kernels whose name holds
    ``kernel``, from the profiler over ``iters`` calls of ``fn`` (after a
    warm up), per launch it traced: the kernel's own time where the
    wrapper's host work outlasts it, as the local block's does, and CUDA
    events would time the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key and e.device_type != torch.autograd.DeviceType.CPU:
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
            n += e.count
    if us <= 0.0 or n == 0:
        raise AssertionError(f"the profiler traced no {kernel} on the device")
    if n != iters:
        log(f"note: the profiler traced {n} of {iters} {kernel} launches; the time is per "
            f"traced launch")
    return us / n / 1e3


def bound_ms(flops: float, nbytes: float, tf32x3: bool = False) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate against
    operations over the f32 SIMT peak, or, for the 3xTF32 kernels, three
    TF32 passes over the tensor-core peak."""
    t_ops = 3 * flops / PEAK_TF32_FLOPS if tf32x3 else flops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def time_line(name, ms, plain_ms, lib_ms, bound, by, flops, nbytes, card, tf32x3=False):
    rate = f", {flops / ms / 1e9:.1f} TFLOP/s f32-equivalent in 3xTF32" if tf32x3 else ""
    log(f"time {name}: kernel {ms:.4f} ms{rate}, plain {plain_ms:.4f} ms, torch+SDPA "
        f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}; {flops / 1e9:.4f} GFLOP, "
        f"{nbytes / 1e6:.3f} MB), {bound / ms:.3f} of the bound {card}")


def sdpa_backend(q, k, v) -> str:
    """The device kernels of one F.scaled_dot_product_attention call, read
    from the profiler: which backend the library yardstick ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            torch.nn.functional.scaled_dot_product_attention(q, k, v)
        torch.cuda.synchronize()
    names = set()
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type != torch.autograd.DeviceType.CPU and us > 0:
            names.add(e.key)
    return "; ".join(sorted(n[:100] for n in names)) or "not measured (no device kernel traced)"


def local_block_sdpa(xseq, coa, num_heads, window):
    """Yardstick: the local block composed from torch ops with
    F.scaled_dot_product_attention and a boolean band mask."""
    import torch
    import torch.nn.functional as F

    from gesturediffusion_tpu_torch.models.embeddings import apply_rotary_pos_emb, rotary_freqs

    b, t, d = xseq.shape
    dh = d // num_heads
    h = xseq.reshape(b, t, num_heads, dh).transpose(1, 2)
    h, _ = apply_rotary_pos_emb(h, h, rotary_freqs(t, dh, xseq.device))
    i = torch.arange(t, device=xseq.device)
    wi = i // window
    allowed = (i[None, :] <= i[:, None]) & (wi[:, None] - wi[None, :] <= 1)
    h = F.scaled_dot_product_attention(h, h, h, attn_mask=allowed)
    y = torch.cat([coa[:, None], h.transpose(1, 2).reshape(b, t, d)], dim=1)
    h = y.reshape(b, t + 1, num_heads, dh).transpose(1, 2)
    h, _ = apply_rotary_pos_emb(h, h, rotary_freqs(t + 1, dh, xseq.device))
    return h.transpose(1, 2).reshape(b, t + 1, d)


def encoder_layer_sdpa(x, wqkv, bqkv, wo, bo, l1w, l1b, w1, b1, w2, b2, l2w, l2b, num_heads,
                       rate=0.0):
    """Yardstick: the encoder layer composed from torch ops with
    F.scaled_dot_product_attention, and F.dropout at the other three
    dropout sites when ``rate`` > 0."""
    import torch.nn.functional as F

    b, t, d = x.shape
    q, k, v = (y.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)
               for y in F.linear(x, wqkv, bqkv).chunk(3, dim=-1))
    a = F.scaled_dot_product_attention(q, k, v, dropout_p=rate)
    a = a.transpose(1, 2).reshape(b, t, d)
    x = F.layer_norm(x + F.dropout(F.linear(a, wo, bo), rate), (d,), l1w, l1b, 1e-5)
    h = F.dropout(F.gelu(F.linear(x, w1, b1), approximate="tanh"), rate)
    return F.layer_norm(x + F.dropout(F.linear(h, w2, b2), rate), (d,), l2w, l2b, 1e-5)


def band_sdpa(q, window):
    """Yardstick: F.scaled_dot_product_attention of q with itself under a
    boolean causal band mask (the same and the previous window)."""
    import torch
    import torch.nn.functional as F

    i = torch.arange(q.shape[2], device=q.device)
    wi = i // window
    allowed = (i[None, :] <= i[:, None]) & (wi[:, None] - wi[None, :] <= 1)
    return F.scaled_dot_product_attention(q, q, q, attn_mask=allowed)


def band_keys(t, window):
    """Keys the causal look-back-one band scores over T = t queries."""
    return sum(i - max(0, (i // window - 1) * window) + 1 for i in range(t))


def launch_counter(counters: dict):
    """(counted, total): ``counted(fn)`` sets the launch count of every
    wrapper in ``counters`` ({name: wrapper}) to 0, runs ``fn``, waits for
    the card and returns (fn's result, {name: launches}); ``total`` sums
    them over every call."""
    import torch

    total = dict.fromkeys(counters, 0)

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {name: c.launches for name, c in counters.items()}
        for name, n in got.items():
            total[name] += n
        return out, got

    return counted, total


def run_take(model, diffusion, chunk_conds, init_seed, seed, t=None):
    """One chunked-AR CFG take through select_sampling_model_fn ->
    autoregressive_sample_loop, synchronised; ``t`` frames a chunk (by
    default the MFCCs')."""
    import torch

    from gesturediffusion_tpu_torch.diffusion.sampling import autoregressive_sample_loop
    from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn

    precompute, model_fn = select_sampling_model_fn(model, GUIDANCE, 0.1)
    gen = torch.Generator(device=init_seed.device).manual_seed(seed)
    b, t = init_seed.shape[0], t or chunk_conds["mfcc"].shape[-1]
    out = autoregressive_sample_loop(
        diffusion, model_fn, (b, J, 1, t), chunk_conds, init_seed, S,
        generator=gen, cond_precompute=precompute,
    )
    torch.cuda.synchronize()
    return out


def generate_cli(model_path, args, num_frames, num_samples, respacing, out_dir, extra=()):
    """The generate CLI in a subprocess on a checkpoint with its args.json
    (``extra``: more flags); returns the motion of results.npy and the wall
    time."""
    import numpy as np

    ckpt_dir = os.path.dirname(model_path)
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "args.json"), "w") as f:
        json.dump(args, f)
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "gesturediffusion_tpu_torch.sample.generate",
         "--model_path", model_path, "--dataset", "synthetic", "--num_frames", str(num_frames),
         "--num_samples", str(num_samples), "--timestep_respacing", respacing,
         "--guidance_param", str(GUIDANCE), "--output_dir", out_dir, *extra],
        check=True, cwd=HERE, timeout=600,
    )
    res = np.load(os.path.join(out_dir, "results.npy"), allow_pickle=True).item()
    return res["motion"], time.perf_counter() - t0


def long_chunk_phase(model, model_path, enc_w, randn, card):
    """Phase 7: the long-chunk kernels against their plain versions, the
    full-width take at T = 1200 with launch counts against the plain take,
    the generate CLI at --num_frames 1200, then times.  Returns the kernel
    rows of the band and flash kernels (the flash row's launches are the
    long take's) and the long take's launch counts."""
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.ops.band_attention import local_attention_band
    from gesturediffusion_tpu_torch.ops.flash_attention import (
        fused_self_attention,
        self_attention_reference,
    )
    from gesturediffusion_tpu_torch.ops.fused_encoder import (
        encoder_layer_plain,
        fused_encoder_layer,
    )
    from gesturediffusion_tpu_torch.ops.fused_local_block import fused_local_block
    from gesturediffusion_tpu_torch.ops.local_attention import local_attention

    bb, tl, dev = 2 * B_TAKES, T_LONG + 1, torch.device("cuda")

    # the local block's rotated heads are a transposed view of [B, T, H, dh]
    qb = randn(bb, T_LONG, CL_HEADS, D // CL_HEADS).transpose(1, 2)
    got = local_attention_band(qb, qb, qb, window_size=WINDOW)
    band_err = (got - local_attention(qb, qb, qb, window_size=WINDOW)).abs().max().item()
    report(f"band_attention [{bb},{CL_HEADS},{T_LONG},{D // CL_HEADS}] w {WINDOW} "
           f"(strided heads)", band_err, TOL_BAND, got.shape == qb.shape)

    qf, kf, vf = (randn(bb, HEADS, tl, D // HEADS) for _ in range(3))
    got = fused_self_attention(qf, kf, vf)
    flash_err = (got - self_attention_reference(qf, kf, vf)).abs().max().item()
    report(f"flash_attention [{bb},{HEADS},{tl},{D // HEADS}]", flash_err, TOL_FLASH,
           got.shape == qf.shape)
    q2, k2, v2 = (randn(8, 8, 777, 32) for _ in range(3))  # 777 = 12 x 64 + 9
    got = fused_self_attention(q2, k2, v2)
    err2 = (got - self_attention_reference(q2, k2, v2)).abs().max().item()
    report("flash_attention [8,8,777,32] (T off the 64-row tile)", err2, TOL_FLASH)
    flash_err = max(flash_err, err2)

    xl = randn(bb, tl, D)
    fused_self_attention.launches = 0
    got = fused_encoder_layer(xl, *enc_w, num_heads=HEADS)
    in_layer = fused_self_attention.launches
    enc_err = (got - encoder_layer_plain(xl, *enc_w, num_heads=HEADS)).abs().max().item()
    report(f"encoder_layer [{bb},{tl},{D}] with the flash stage (launched {in_layer} "
           f"time, expected 1)", enc_err, TOL_ENCODER, in_layer == 1)

    # ---- the long take ---------------------------------------------------- #
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000,
                                 timestep_respacing=LONG_RESPACING, device=dev)
    assert diffusion.num_timesteps == LONG_STEPS
    conds = {"mfcc": randn(CHUNKS, B_TAKES, A, 1, T_LONG),
             "scale": torch.full((CHUNKS, B_TAKES), GUIDANCE, device=dev)}
    init_seed = randn(B_TAKES, J, 1, S, scale=0.5)
    counters = {"band_attention": local_attention_band, "flash_attention": fused_self_attention,
                "encoder_layer": fused_encoder_layer, "local_block": fused_local_block}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run_take(model, diffusion, conds, init_seed, 1)
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    n_steps = LONG_STEPS * CHUNKS
    want = {"band_attention": n_steps, "flash_attention": n_steps * LAYERS,
            "encoder_layer": n_steps * LAYERS, "local_block": 0}
    finite = bool(torch.isfinite(out).all())
    log(f"long take: out {tuple(out.shape)} finite={finite} launches {launches} (expected "
        f"{want}); first run {first_s:.3f} s; peak memory {peak_mib:.1f} MiB {card}")
    if tuple(out.shape) != (CHUNKS, B_TAKES, J, 1, T_LONG) or not finite:
        raise AssertionError("long take output has the wrong shape or non-finite values")
    if launches != want:
        raise AssertionError(f"long take kernel launches {launches} != {want}")
    t0 = time.perf_counter()
    run_take(model, diffusion, conds, init_seed, 1)
    kernel_take_s = time.perf_counter() - t0
    model.use_kernels = False
    t0 = time.perf_counter()
    out_plain = run_take(model, diffusion, conds, init_seed, 1)
    plain_take_s = time.perf_counter() - t0
    model.use_kernels = True
    take_err = (out - out_plain).abs().max().item()
    ok = take_err <= TOL_TAKE
    log(f"{'OK' if ok else 'FAIL'} long take vs plain versions on the card: max|diff| "
        f"{take_err:.3e} (tol {TOL_TAKE:g}; |out| max {out_plain.abs().max().item():.3f})")
    if not ok:
        raise AssertionError("long kernel take disagrees with the plain take")

    out_dir = os.path.join(os.path.dirname(os.path.dirname(model_path)), "long", "samples")
    long_path = os.path.join(os.path.dirname(out_dir), "model000000000.pt")
    os.makedirs(os.path.dirname(long_path), exist_ok=True)
    torch.save(model.state_dict(), long_path)
    motion, cli_s = generate_cli(
        long_path, {"dataset": "synthetic", "num_frames": T_LONG, "layers": LAYERS,
                    "latent_dim": D, "cond_mask_prob": 0.1, "seed_poses": S,
                    "noise_schedule": "cosine", "diffusion_steps": 1000, "sigma_small": True},
        T_LONG, LONG_SAMPLES, LONG_RESPACING, out_dir)
    ok = motion.shape == (LONG_SAMPLES, J // 6, 3, T_LONG) and np.isfinite(motion).all()
    log(f"{'OK' if ok else 'FAIL'} generate CLI at --num_frames {T_LONG}: motion "
        f"{motion.shape} in {cli_s:.1f} s (process and data set-up included)")
    if not ok:
        raise AssertionError("long generate CLI output has the wrong shape or non-finite values")

    # ---- times ------------------------------------------------------------ #
    copy_ms = cuda_time_ms(lambda: qb.contiguous())
    band_ms = cuda_time_ms(lambda: local_attention_band(qb, qb, qb, window_size=WINDOW))
    band_device_ms = device_ms(lambda: local_attention_band(qb, qb, qb, window_size=WINDOW),
                               "band_attention_kernel")
    band_plain_ms = cuda_time_ms(lambda: local_attention(qb, qb, qb, window_size=WINDOW), 10, 2)
    band_lib_ms = cuda_time_ms(lambda: band_sdpa(qb, WINDOW), 5, 1)
    band_flops = 4 * bb * CL_HEADS * band_keys(T_LONG, WINDOW) * (D // CL_HEADS)
    band_bytes = 4 * 2 * qb.numel()  # q = k = v: the input read once, the output written once
    band_bound, band_by = bound_ms(band_flops, band_bytes)

    flash_ms = cuda_time_ms(lambda: fused_self_attention(qf, kf, vf), 10, 2)
    flash_plain_ms = cuda_time_ms(lambda: self_attention_reference(qf, kf, vf), 5, 1)
    flash_lib_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qf, kf, vf), 10, 2)
    flash_flops = 4 * bb * HEADS * tl**2 * (D // HEADS)
    flash_bytes = 4 * 4 * qf.numel()
    flash_bound, flash_by = bound_ms(flash_flops, flash_bytes, tf32x3=True)
    # the padded width of --latent_dim 320: heads of 80 at the DHP = 80 kernel
    q8, k8, v8 = (randn(bb, HEADS, tl, D_C1 // HEADS) for _ in range(3))
    flash80_ms = cuda_time_ms(lambda: fused_self_attention(q8, k8, v8), 10, 2)
    flash80_plain_ms = cuda_time_ms(lambda: self_attention_reference(q8, k8, v8), 5, 1)
    flash80_lib_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(q8, k8, v8), 10, 2)
    flash80_flops = 4 * bb * HEADS * tl**2 * (D_C1 // HEADS)
    flash80_bytes = 4 * 4 * q8.numel()
    flash80_bound, flash80_by = bound_ms(flash80_flops, flash80_bytes, tf32x3=True)

    enc_ms = cuda_time_ms(lambda: fused_encoder_layer(xl, *enc_w, num_heads=HEADS), 5, 1)
    enc_plain_ms = cuda_time_ms(lambda: encoder_layer_plain(xl, *enc_w, num_heads=HEADS), 5, 1)
    enc_lib_ms = cuda_time_ms(lambda: encoder_layer_sdpa(xl, *enc_w, HEADS), 5, 1)
    m = bb * tl
    enc_flops = 2 * m * (4 * D * D + 2 * D * FF) + 4 * bb * tl**2 * D
    enc_bytes = 4 * (2 * m * D + sum(w.numel() for w in enc_w))
    enc_bound, enc_by = bound_ms(enc_flops, enc_bytes, tf32x3=True)

    time_line(f"band_attention [{bb},{CL_HEADS},{T_LONG},{D // CL_HEADS}]", band_ms,
              band_plain_ms, band_lib_ms, band_bound, band_by, band_flops, band_bytes, card)
    time_line(f"flash_attention [{bb},{HEADS},{tl},{D // HEADS}]", flash_ms, flash_plain_ms,
              flash_lib_ms, flash_bound, flash_by, flash_flops, flash_bytes, card, tf32x3=True)
    time_line(f"flash_attention [{bb},{HEADS},{tl},{D_C1 // HEADS}] (padded width 80)",
              flash80_ms, flash80_plain_ms, flash80_lib_ms, flash80_bound, flash80_by,
              flash80_flops, flash80_bytes, card, tf32x3=True)
    time_line(f"encoder_layer [{bb},{tl},{D}] (flash stage)", enc_ms, enc_plain_ms, enc_lib_ms,
              enc_bound, enc_by, enc_flops, enc_bytes, card, tf32x3=True)
    log(f"SDPA backend of the library yardstick at [{bb},{HEADS},{tl},{D // HEADS}]: "
        f"{sdpa_backend(qf, kf, vf)}")
    log(f"time band input .contiguous() copy (what reading the strides avoids): "
        f"{copy_ms:.4f} ms; band kernel's device time (profiler) {band_device_ms:.4f} ms, "
        f"{band_bound / band_device_ms:.3f} of the bound {card}")
    log(f"time long take ({B_TAKES} takes x {CHUNKS} chunks x {LONG_STEPS} DDPM steps at "
        f"T = {T_LONG}, CFG batch {bb}): kernels {kernel_take_s:.3f} s = "
        f"{B_TAKES * CHUNKS / kernel_take_s:.3f} chunks/s, "
        f"{kernel_take_s / n_steps * 1e3:.3f} ms/step; plain {plain_take_s:.3f} s = "
        f"{B_TAKES * CHUNKS / plain_take_s:.3f} chunks/s, "
        f"{plain_take_s / n_steps * 1e3:.3f} ms/step {card}")
    profile_denoise_step(model, diffusion, conds, init_seed, card, steps=3)

    rows = [
        {"name": "band_attention", "route": "cuda",
         "source": "gesturediffusion_tpu_torch/csrc/band_attention.cu",
         "replaces": "gesturediffusion_tpu/ops/pallas_attention.py:33",
         "launches": launches["band_attention"], "max_abs_err": band_err,
         "ms": band_ms, "device_ms": band_device_ms, "plain_ms": band_plain_ms,
         "bound_ms": band_bound, "bound_by": band_by, "library_ms": band_lib_ms},
        {"name": "flash_attention", "route": "cuda",
         "source": "gesturediffusion_tpu_torch/csrc/flash_attention.cu",
         "replaces": "gesturediffusion_tpu/ops/pallas_flash.py:35",
         "launches": launches["flash_attention"], "max_abs_err": flash_err,
         "ms": flash_ms, "plain_ms": flash_plain_ms, "bound_ms": flash_bound,
         "bound_by": flash_by, "library_ms": flash_lib_ms},
    ]
    return rows, launches


def c1_model_phase(randn, root, card, d=D_C1, cli=True):
    """Phase 8: a --latent_dim d model (C1_LAYERS layers of 4 heads, 8
    local heads) takes one CFG denoise step at T = 1200 through the kernels,
    launches counted, against the same step through the plain versions;
    then, with ``cli``, the generate CLI samples --num_frames 1200 from its
    checkpoint."""
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample
    from gesturediffusion_tpu_torch.models.mdm import MDM
    from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn
    from gesturediffusion_tpu_torch.ops.band_attention import local_attention_band
    from gesturediffusion_tpu_torch.ops.flash_attention import fused_self_attention
    from gesturediffusion_tpu_torch.ops.fused_encoder import fused_encoder_layer
    from gesturediffusion_tpu_torch.ops.fused_local_block import fused_local_block

    dev = torch.device("cuda")
    torch.manual_seed(2)
    model = MDM(njoints=J, latent_dim=d, ff_size=FF, num_layers=C1_LAYERS, num_heads=HEADS,
                cond_mask_prob=0.1, seed_poses=S, mfcc_dim=A, cl_head=CL_HEADS,
                window_size=WINDOW).to(dev).eval()
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000,
                                 timestep_respacing=LONG_RESPACING, device=dev)
    chunk = {"mfcc": randn(B_TAKES, A, 1, T_LONG), "seed": randn(B_TAKES, J, 1, S, scale=0.5),
             "scale": torch.full((B_TAKES,), GUIDANCE, device=dev)}
    x, noise = randn(B_TAKES, J, 1, T_LONG), randn(B_TAKES, J, 1, T_LONG)
    t = torch.full((B_TAKES,), diffusion.num_timesteps // 2, dtype=torch.long, device=dev)

    def step():
        precompute, model_fn = select_sampling_model_fn(model, GUIDANCE, 0.1)
        out = p_sample(diffusion, model_fn, x, t, precompute(chunk), noise)["sample"]
        torch.cuda.synchronize()
        return out

    counters = {"band_attention": local_attention_band, "flash_attention": fused_self_attention,
                "encoder_layer": fused_encoder_layer, "local_block": fused_local_block}
    for fn in counters.values():
        fn.launches = 0
    got = step()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {"band_attention": 1, "flash_attention": C1_LAYERS, "encoder_layer": C1_LAYERS,
            "local_block": 0}
    model.use_kernels = False
    plain = step()
    model.use_kernels = True
    err = (got - plain).abs().max().item()
    ok = launches == want and err <= TOL_TAKE and bool(torch.isfinite(got).all())
    log(f"{'OK' if ok else 'FAIL'} --latent_dim {d} ({HEADS} heads of {d // HEADS}, "
        f"{CL_HEADS} local heads of {d // CL_HEADS}, {C1_LAYERS} layers): one denoise step "
        f"at T = {T_LONG}, CFG batch {2 * B_TAKES}, kernels vs plain versions max|diff| "
        f"{err:.3e} (tol {TOL_TAKE:g}); launches {launches} (expected {want}) {card}")
    if not ok:
        raise AssertionError(f"the --latent_dim {d} step disagrees or missed its kernels")
    if not cli:
        return

    out_dir = os.path.join(root, "c1", "samples")
    path = os.path.join(root, "c1", "model000000000.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(model.state_dict(), path)
    motion, cli_s = generate_cli(
        path, {"dataset": "synthetic", "num_frames": T_LONG, "layers": C1_LAYERS,
               "latent_dim": d, "cond_mask_prob": 0.1, "seed_poses": S,
               "noise_schedule": "cosine", "diffusion_steps": 1000, "sigma_small": True},
        T_LONG, 1, "5", out_dir)
    ok = motion.shape == (1, J // 6, 3, T_LONG) and np.isfinite(motion).all()
    log(f"{'OK' if ok else 'FAIL'} generate CLI at --latent_dim {d} --num_frames {T_LONG} "
        f"(1 take, respacing 5): motion {motion.shape} in {cli_s:.1f} s")
    if not ok:
        raise AssertionError(f"the --latent_dim {d} generate CLI failed")


def wide_times(randn, card):
    """Times past a head width of 128 (the sliced kernels): flash at
    [82, 4, 1201, dh] for dh 256 and 520 (--latent_dim 1024 and 2080), and
    the encoder layer of --latent_dim 1024 (ff 1024) at [82, 1201, 1024],
    against their plain versions and library calls."""
    import torch

    from gesturediffusion_tpu_torch.ops.flash_attention import (
        fused_self_attention,
        self_attention_reference,
    )
    from gesturediffusion_tpu_torch.ops.fused_encoder import (
        encoder_layer_plain,
        fused_encoder_layer,
    )

    bb, tl = 2 * B_TAKES, T_LONG + 1
    for dh in (256, 520):
        q, k, v = (randn(bb, HEADS, tl, dh) for _ in range(3))
        ms = cuda_time_ms(lambda: fused_self_attention(q, k, v), 3, 1)
        plain_ms = cuda_time_ms(lambda: self_attention_reference(q, k, v), 3, 1)
        lib_ms = cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 3, 1)
        flops, nbytes = 4 * bb * HEADS * tl**2 * dh, 4 * 4 * q.numel()
        bound, by = bound_ms(flops, nbytes, tf32x3=True)
        time_line(f"flash_attention [{bb},{HEADS},{tl},{dh}] (128-column slices)", ms, plain_ms,
                  lib_ms, bound, by, flops, nbytes, card, tf32x3=True)
        del q, k, v
    w = layer_weights(randn, D_WIDE, FF)
    x = randn(bb, tl, D_WIDE)
    ms = cuda_time_ms(lambda: fused_encoder_layer(x, *w, num_heads=HEADS), 3, 1)
    plain_ms = cuda_time_ms(lambda: encoder_layer_plain(x, *w, num_heads=HEADS), 3, 1)
    lib_ms = cuda_time_ms(lambda: encoder_layer_sdpa(x, *w, HEADS), 3, 1)
    m = bb * tl
    flops = 2 * m * (4 * D_WIDE * D_WIDE + 2 * D_WIDE * FF) + 4 * bb * tl**2 * D_WIDE
    nbytes = 4 * (2 * m * D_WIDE + sum(t.numel() for t in w))
    bound, by = bound_ms(flops, nbytes, tf32x3=True)
    time_line(f"encoder_layer [{bb},{tl},{D_WIDE}] heads {HEADS} of {D_WIDE // HEADS} ff {FF}",
              ms, plain_ms, lib_ms, bound, by, flops, nbytes, card, tf32x3=True)


def genea_serve_phase(model, model_path, card):
    """Phase 9: the GENEA data path and streaming serve at full width on the
    phase-4 model.  A synthetic GENEA-2023 tree (G_TAKES takes of G_FRAMES
    frames a split) and its val MFCC cache; the generate CLI on it (5
    chunks a take) against the same take sampled in this process; the
    streaming session at 41 streams against that take, and its per-chunk
    latency at 1 and 4 streams (DDPM-50, DDIM-50) with a profile of one
    streams-1 chunk; the demo CLI from the val split and from a wav; the
    train CLI on the train split.  Returns the launches of the kernels on
    these paths (the batch take, the sessions, the train CLI)."""
    import shutil

    import numpy as np
    import torch
    from scipy.io import wavfile

    from gesturediffusion_tpu_torch.data.collate import collate_gesture, device_cond
    from gesturediffusion_tpu_torch.data.genea import Genea2023
    from gesturediffusion_tpu_torch.data.synthetic import make_synthetic_genea2023
    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.sampling import autoregressive_sample_loop
    from gesturediffusion_tpu_torch.diffusion.schedules import respacing_string
    from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn
    from gesturediffusion_tpu_torch.ops.flash_attention import fused_self_attention
    from gesturediffusion_tpu_torch.ops.fused_encoder import fused_encoder_layer
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
    )
    from gesturediffusion_tpu_torch.ops.fused_local_block import fused_local_block
    from gesturediffusion_tpu_torch.sample.generate import split_pose_vector, take_layout
    from gesturediffusion_tpu_torch.serve.streaming import StreamingGestureSession
    from gesturediffusion_tpu_torch.train import train_mdm

    dev = torch.device("cuda")
    counted, total = launch_counter({
        "local_block": fused_local_block, "encoder_layer": fused_encoder_layer,
        "flash_attention": fused_self_attention,
        "encoder_layer_train_fwd": encoder_layer_train_fwd,
        "encoder_layer_train_bwd": encoder_layer_train_bwd})

    # ---- data -------------------------------------------------------------- #
    base = os.path.join(HERE, "build", "chip_smoke")
    root = os.path.join(base, "genea2023")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    make_synthetic_genea2023(root, n_takes=G_TAKES, frames_per_take=G_FRAMES, pose_dim=J, seed=0)
    make_s = time.perf_counter() - t0
    val = Genea2023(root, split="val", window=T, n_seed_poses=S)
    t0 = time.perf_counter()
    for f in range(len(val.takes)):
        val._take_mfcc(f)
    cache_s = time.perf_counter() - t0
    audio_mb = sum(os.path.getsize(os.path.join(val.audiopath, f))
                   for f in os.listdir(val.audiopath)) / 1e6
    counts, starts, _ = take_layout(val)
    chunks = int(counts.min())
    log(f"genea: synthetic GENEA-2023 tree, {G_TAKES} takes a split of {G_FRAMES} frames, pose "
        f"{J}, written in {make_s:.1f} s ({audio_mb:.1f} MB of audio in the val split); val "
        f"split {len(val)} windows, {chunks} chunks of {T} a take; MFCC cache of the val split "
        f"({G_TAKES} takes) built in {cache_s:.2f} s")
    if chunks != (G_FRAMES - T) // T or len(counts) != G_TAKES:
        raise AssertionError(f"val layout: {len(counts)} takes, {chunks} chunks")

    # ---- the generate CLI against the same take in this process ------------ #
    ckpt_dir = os.path.join(base, "genea")
    path = os.path.join(ckpt_dir, "model000000000.pt")
    os.makedirs(ckpt_dir, exist_ok=True)
    shutil.copy(model_path, path)
    out_dir = os.path.join(ckpt_dir, "samples")
    motion, cli_s = generate_cli(
        path, {"dataset": "genea2023", "data_dir": root, "num_frames": T, "layers": LAYERS,
               "latent_dim": D, "cond_mask_prob": 0.1, "seed_poses": S,
               "noise_schedule": "cosine", "diffusion_steps": 1000, "sigma_small": True},
        T, G_TAKES, RESPACING, out_dir)
    res = np.load(os.path.join(out_dir, "results.npy"), allow_pickle=True).item()
    names = os.listdir(out_dir)
    files = (sum(n.endswith(".bvh") and not n.endswith("_gt.bvh") for n in names),
             sum(n.endswith("_gt.bvh") for n in names), sum(n.endswith(".wav") for n in names))
    ok = (motion.shape == (G_TAKES, J // 6, 3, chunks * T) and np.isfinite(motion).all()
          and (np.asarray(res["lengths"]) == chunks * T).all()
          and files == (G_TAKES,) * 3)
    log(f"{'OK' if ok else 'FAIL'} generate CLI --dataset genea2023 ({G_TAKES} takes x {chunks} "
        f"chunks, DDPM respaced to {STEPS}): motion {motion.shape}, lengths "
        f"{sorted(set(int(n) for n in res['lengths']))}, (.bvh, _gt.bvh, .wav) files {files}, "
        f"in {cli_s:.1f} s wall (process start, data, sampling, BVH and wav writing) {card}")
    if not ok:
        raise AssertionError("the genea generate CLI wrote the wrong results")

    dconds = []
    for c in range(chunks):
        _, cond = collate_gesture([val[int(starts[b]) + c] for b in range(G_TAKES)],
                                  max_frames=T)
        dconds.append(device_cond(cond))
    feeds = [{k: v for k, v in dc.items() if k != "seed"} for dc in dconds]
    init_seed = dconds[0]["seed"]
    stacked = {k: torch.from_numpy(np.stack([f[k] for f in feeds])).to(dev) for k in feeds[0]}
    stacked["scale"] = torch.full((chunks, G_TAKES), GUIDANCE, device=dev)
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000,
                                 timestep_respacing=RESPACING, device=dev)
    precompute, model_fn = select_sampling_model_fn(model, GUIDANCE, 0.1)
    batch, launches = counted(lambda: autoregressive_sample_loop(
        diffusion, model_fn, (G_TAKES, J, 1, T), stacked, torch.from_numpy(init_seed).to(dev),
        S, generator=torch.Generator(device=dev).manual_seed(10), cond_precompute=precompute))
    batch = batch.cpu().numpy()
    pos = np.concatenate([
        split_pose_vector(val.inv_transform(batch[c][:, :, 0, :].transpose(0, 2, 1)), J // 6)[0]
        for c in range(chunks)], axis=1).transpose(0, 2, 3, 1)
    report(f"generate CLI's motion vs the take sampled in this process (same conditioning, "
           f"generator seed 10; launches {launches})", float(np.abs(pos - motion).max()),
           TOL_TAKE)

    # ---- streaming ---------------------------------------------------------- #
    motion_s = T / 30.0

    def serve(streams, sampler, label):
        """5 chunks through a fresh session; per-chunk latency (s)."""
        d = create_diffusion(noise_schedule="cosine", steps=1000, device=dev,
                             timestep_respacing=respacing_string(STEPS, sampler))
        session = StreamingGestureSession(
            model, guidance_param=GUIDANCE, cond_mask_prob=0.1, sampler=sampler, diffusion=d,
            streams=streams, chunk_frames=T, seed_poses=S, fps=30.0, device=dev)
        session.start(init_seed[:streams], rng=10)
        outs, lat = [], []
        for f in feeds:
            outs.append(session.feed({k: v[:streams] for k, v in f.items()}))
            lat.append(session.stats().last_latency_s)
        steady = lat[1:]
        mean = sum(steady) / len(steady)
        log(f"serve {label}: streams {streams}, {sampler.upper()}-{STEPS}, {len(lat)} chunks of "
            f"{T} frames: first chunk {lat[0] * 1e3:.2f} ms; steady mean {mean * 1e3:.2f} ms, "
            f"worst {max(steady) * 1e3:.2f} ms, real-time factor {motion_s / mean:.2f} "
            f"(chunk latencies ms {[round(x * 1e3, 2) for x in lat]}) {card}")
        return session, np.stack(outs)

    (_, streamed), launches = counted(lambda: serve(G_TAKES, "ddpm", "batch width"))
    per_chunk = {k: launches[k] // chunks for k in ("local_block", "encoder_layer",
                                                    "flash_attention")}
    want = {"local_block": STEPS, "encoder_layer": STEPS * LAYERS,
            "flash_attention": STEPS * LAYERS}
    report(f"streamed take at {G_TAKES} streams vs the batch take (launches a chunk "
           f"{per_chunk}, expected {want})", float(np.abs(streamed - batch).max()), TOL_TAKE,
           per_chunk == want and launches["local_block"] == chunks * STEPS)
    sessions = {}
    for streams in (1, 4):
        for sampler in ("ddpm", "ddim"):
            (sessions[streams, sampler], _), _ = counted(
                lambda: serve(streams, sampler, "small live batch"))
    one = sessions[1, "ddpm"]
    device_profile(lambda: one.feed({k: v[:1] for k, v in feeds[1].items()}), 2,
                   f"one steady streams-1 chunk (DDPM-{STEPS}, {STEPS} denoise steps)", card,
                   host_rows=8)

    # ---- the demo CLI from the val split and from a wav --------------------- #
    wav = os.path.join(ckpt_dir, "take.wav")
    audio = np.load(os.path.join(val.audiopath, val.takes[0] + ".npy"))
    wavfile.write(wav, 22050, (audio * 32767).astype(np.int16))
    for source, extra in (("val split", []), ("wav", ["--wav", wav])):
        serve_dir = os.path.join(ckpt_dir, "serve_" + ("wav" if extra else "val"))
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "gesturediffusion_tpu_torch.serve.demo", "--model_path", path,
             "--streams", "4", "--num_chunks", "3", "--sampler", "ddim", "--sample_steps",
             str(STEPS), "--guidance_param", str(GUIDANCE), "--output_dir", serve_dir, *extra],
            check=True, cwd=HERE, timeout=600)
        demo_s = time.perf_counter() - t0
        res = np.load(os.path.join(serve_dir, "results.npy"), allow_pickle=True).item()
        with open(os.path.join(serve_dir, "serving_report.json")) as f:
            rep = json.load(f)
        ok = (res["motion"].shape == (4, J // 6, 3, 3 * T) and np.isfinite(res["motion"]).all()
              and rep == res["serving_report"] and rep["chunks_served"] == 3
              and all(os.path.exists(os.path.join(serve_dir, f"stream_{i}.bvh"))
                      for i in range(4)))
        log(f"{'OK' if ok else 'FAIL'} demo CLI from the {source} (4 streams x 3 chunks, "
            f"DDIM-{STEPS}): motion {res['motion'].shape}, report {rep}, {demo_s:.1f} s wall "
            f"{card}")
        if not ok:
            raise AssertionError(f"the demo CLI from the {source} wrote the wrong results")

    # ---- the train CLI on the train split ------------------------------------ #
    save_dir = os.path.join(base, "genea_train")
    t0 = time.perf_counter()
    loop, launches = counted(lambda: train_mdm.main([
        "--dataset", "genea2023", "--data_dir", root, "--save_dir", save_dir, "--overwrite",
        "--num_frames", str(T_CLI), "--batch_size", "64", "--num_steps", "5",
        "--log_interval", "5", "--use_fused_train_encoder"]))
    want = LAYERS * 5
    ok = (loop.state.step == 5 and launches["encoder_layer_train_fwd"] == want
          and launches["encoder_layer_train_bwd"] == want)
    log(f"{'OK' if ok else 'FAIL'} train CLI --dataset genea2023 --num_frames {T_CLI}: 5 steps "
        f"at batch 64 in {time.perf_counter() - t0:.1f} s (data set-up and the train split's "
        f"MFCC cache included); launches fwd {launches['encoder_layer_train_fwd']} bwd "
        f"{launches['encoder_layer_train_bwd']} (expected {want} each) {card}")
    if not ok:
        raise AssertionError("the genea train CLI missed its steps or kernels")
    return total


def t2m_phase(randn, gesture_path, card):
    """Phase 10: text-to-motion sampling and motion editing on the card.
    The humanml-encoder-512 MotionMDM with seeded random weights (a
    reference-layout .pt), a random CLIP text tower at ViT-B/32 width with
    a synthetic BPE file (CLIP_CHECKPOINT / CLIP_BPE_PATH), a synthetic
    HumanML3D tree; kernel 1 at [6, 197, 512] and [64, 197, 512] against its
    plain version; one predict take (3 repetitions, CFG batch 6, DDPM
    respaced to 50) through the kernels against the plain take, launches
    counted; the predict CLI at the reference configuration (1000 steps);
    the edit CLI in_between and upper_body on the tree, and in_between on
    the phase-9 gesture checkpoint (kernels 1 and 2 counted), each with its
    kept entries against the ground truth; then times and profiles.
    Returns the kernel-1 rows of the two t2m shapes (the first counting
    every text-to-motion launch but the CFG-64 step's), the launches of
    every path of the phase and those of the gesture edit."""
    import gzip
    import shutil

    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.data.humanml import make_synthetic_humanml
    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample
    from gesturediffusion_tpu_torch.models.cfg import classifier_free_guidance
    from gesturediffusion_tpu_torch.models.clip_text import CLIPTextEmbedder, CLIPTextEncoder
    from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
    from gesturediffusion_tpu_torch.ops.flash_attention import fused_self_attention
    from gesturediffusion_tpu_torch.ops.fused_encoder import (
        encoder_layer_plain,
        fused_encoder_layer,
    )
    from gesturediffusion_tpu_torch.ops.fused_local_block import fused_local_block
    from gesturediffusion_tpu_torch.sample import edit, predict
    from gesturediffusion_tpu_torch.utils.text_embedder import get_text_encoder

    dev = torch.device("cuda")
    counted, total = launch_counter({
        "local_block": fused_local_block, "encoder_layer": fused_encoder_layer,
        "flash_attention": fused_self_attention})

    # ---- the checkpoint, the CLIP tower and BPE file, the tree ------------- #
    base = os.path.join(HERE, "build", "chip_smoke", "t2m")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    t0 = time.perf_counter()
    torch.manual_seed(4)
    model_path = os.path.join(base, "model000000000.pt")
    torch.save(MotionMDM(njoints=T2M_J, latent_dim=T2M_D, ff_size=FF, num_layers=LAYERS,
                         num_heads=HEADS, cond_mode="text", cond_mask_prob=0.1).state_dict(),
               model_path)
    clip_path, bpe_path = os.path.join(base, "clip.pt"), os.path.join(base, "bpe.txt.gz")
    torch.save(CLIPTextEncoder(width=CLIP_WIDTH, layers=CLIP_LAYERS, heads=CLIP_HEADS,
                               embed_dim=512).state_dict(), clip_path)
    merges = ["t h", "th e</w>", "p e", "pe r", "per s", "o n</w>", "w a", "wa l", "wal k",
              "walk s</w>", "f o", "fo r", "for w", "forw a", "forwa r", "forwar d</w>"]
    with gzip.open(bpe_path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    os.environ["CLIP_CHECKPOINT"], os.environ["CLIP_BPE_PATH"] = clip_path, bpe_path
    root = make_synthetic_humanml(os.path.join(base, "humanml"), n_clips=HML_CLIPS, dim=T2M_J)
    with open(os.path.join(base, "args.json"), "w") as f:
        json.dump({"dataset": "humanml", "data_dir": root, "layers": LAYERS,
                   "latent_dim": T2M_D, "cond_mask_prob": 0.1, "noise_schedule": "cosine",
                   "diffusion_steps": 1000, "sigma_small": True}, f)
    embedder = get_text_encoder(device=dev)
    if not isinstance(embedder, CLIPTextEmbedder):
        raise AssertionError("the CLIP text tower did not load")
    log(f"t2m: humanml-encoder-512 checkpoint ({T2M_J} features, D {T2M_D}, {LAYERS} layers "
        f"of {HEADS} heads of {T2M_D // HEADS}), a CLIP text tower of width {CLIP_WIDTH}, "
        f"{CLIP_LAYERS} layers, {CLIP_HEADS} heads, context 77 ({os.path.getsize(clip_path) / 1e6:.1f}"
        f" MB) and a synthetic HumanML3D tree of {HML_CLIPS} clips written in "
        f"{time.perf_counter() - t0:.1f} s; text embedder: {type(embedder).__name__}")

    # ---- kernel 1 at the t2m shapes ---------------------------------------- #
    w = layer_weights(randn, T2M_D, FF)
    rows = T2M_FRAMES + 1
    xs = {b: randn(b, rows, T2M_D) for b in (2 * T2M_REPS, 2 * T2M_BIG)}
    errs = {}
    for b, x in xs.items():
        got = fused_encoder_layer(x, *w, num_heads=HEADS)
        errs[b] = (got - encoder_layer_plain(x, *w, num_heads=HEADS)).abs().max().item()
        report(f"encoder_layer [{b},{rows},{T2M_D}] heads {HEADS} of {T2M_D // HEADS} ff {FF}",
               errs[b], TOL_ENCODER, got.shape == x.shape)

    # ---- one predict take through the kernels against the plain take ------- #
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000,
                                 timestep_respacing=T2M_RESPACING, device=dev)
    model = MotionMDM(njoints=T2M_J, latent_dim=T2M_D, ff_size=FF, num_layers=LAYERS,
                      num_heads=HEADS, cond_mode="text", cond_mask_prob=0.1)
    predictor = predict.Predictor(model_path, dataset_root=base, model=model,
                                  diffusion=diffusion, device=dev)
    take, launches = counted(lambda: predictor.predict(PROMPT, T2M_REPS, seed=0,
                                                       motion_length=9.8))
    take_launches = launches
    model.use_kernels = False
    plain = predictor.predict(PROMPT, T2M_REPS, seed=0, motion_length=9.8)
    model.use_kernels = True
    want = {"local_block": 0, "encoder_layer": T2M_STEPS * LAYERS,
            "flash_attention": T2M_STEPS * LAYERS}
    take_err = float(np.abs(take["features"] - plain["features"]).max())
    ok = (launches == want and take["features"].shape == (T2M_REPS, T2M_FRAMES, T2M_J)
          and np.isfinite(take["motion_xyz"]).all())
    report(f"predict take ({T2M_REPS} repetitions, CFG batch {2 * T2M_REPS}, DDPM respaced to "
           f"{T2M_STEPS}) vs plain versions on the card; launches {launches} (expected {want}; "
           f"|features| max {np.abs(plain['features']).max():.3f})", take_err, TOL_TAKE, ok)

    # ---- the predict CLI at the reference configuration -------------------- #
    out_dir = os.path.join(base, "predict")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gesturediffusion_tpu_torch.sample.predict", "--model_path",
         model_path, "--text", PROMPT, "--motion_length", "9.8", "--output_dir", out_dir],
        check=True, cwd=HERE, timeout=600, capture_output=True, text=True)
    predict_s = time.perf_counter() - t0
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    res = np.load(os.path.join(out_dir, "results.npy"), allow_pickle=True).item()
    ok = (res["motion"].shape == (T2M_REPS, 22, 3, T2M_FRAMES) and np.isfinite(res["motion"]).all()
          and res["text"] == [PROMPT] * T2M_REPS and sorted(os.listdir(out_dir))
          == ["results.npy", "results.txt"] and line["frames"] == T2M_FRAMES
          and "loading CLIP text tower" in proc.stdout)
    log(f"{'OK' if ok else 'FAIL'} predict CLI (humanml-encoder-512, 1000 DDPM steps, "
        f"{T2M_REPS} repetitions, CFG batch {2 * T2M_REPS}, the CLIP tower): motion "
        f"{res['motion'].shape}, {line}, in {predict_s:.1f} s wall (process start, CLIP and "
        f"model loading included) {card}")
    if not ok:
        raise AssertionError("the predict CLI wrote the wrong results")

    # ---- the edit CLI: text in_between and upper_body, gesture in_between -- #
    def edit_run(path, mode, reps, per_step, label, xyz_joints=None):
        out = os.path.join(os.path.dirname(path), f"edit_{mode}")
        t0 = time.perf_counter()
        run, launches = counted(lambda: edit.run([
            "--model_path", path, "--edit_mode", mode, "--num_repetitions", str(reps),
            "--text_condition", PROMPT if mode == "in_between" else "", "--output_dir", out]))
        wall = time.perf_counter() - t0
        res = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
        n = run["gt"].shape[0]
        mask = np.tile(run["mask"], (reps, 1, 1, 1))
        kept = float(np.abs(run["samples"][mask] - np.tile(run["gt"], (reps, 1, 1, 1))[mask]).max())
        shape = (reps * n, xyz_joints, 3, run["gt"].shape[-1]) if xyz_joints else \
            (reps * n,) + run["gt"].shape[1:]
        want = {k: v * 1000 * reps for k, v in per_step.items()}
        ok = (n == EDIT_SAMPLES and launches == want and res["motion"].shape == shape
              and np.isfinite(res["motion"]).all() and (~run["mask"]).any())
        report(f"edit CLI {label} --edit_mode {mode} ({n} samples x {reps} repetitions, 1000 "
               f"DDPM steps, CFG batch {2 * n}): kept entries vs the ground truth; motion "
               f"{res['motion'].shape}; launches {launches} (expected {want}); {wall:.1f} s "
               f"wall {card}", kept, TOL_KEPT, ok)
        return kept, launches

    t2m_step = {"local_block": 0, "encoder_layer": LAYERS, "flash_attention": LAYERS}
    kept = [edit_run(model_path, "in_between", T2M_REPS, t2m_step, "--dataset humanml", 22),
            edit_run(model_path, "upper_body", 1, t2m_step, "--dataset humanml", 22)]
    gesture_dir = os.path.join(os.path.dirname(os.path.dirname(gesture_path)), "gesture_edit")
    shutil.rmtree(gesture_dir, ignore_errors=True)
    os.makedirs(gesture_dir)
    for name in ("model000000000.pt", "args.json"):
        shutil.copy(os.path.join(os.path.dirname(gesture_path), name), gesture_dir)
    kept.append(edit_run(os.path.join(gesture_dir, "model000000000.pt"), "in_between", 1,
                         {"local_block": 1, "encoder_layer": LAYERS, "flash_attention": LAYERS},
                         "--dataset genea2023 (the phase-4 model)"))
    text_launches = take_launches["encoder_layer"] + sum(k[1]["encoder_layer"] for k in kept[:2])

    # ---- times --------------------------------------------------------------- #
    emb_ms = cuda_time_ms(lambda: embedder([PROMPT] * 10), 10, 2)
    log(f"time CLIP text tower ({CLIP_LAYERS} layers of width {CLIP_WIDTH}, context 77, "
        f"tokenizer included): {emb_ms:.4f} ms for 10 prompts {card}")
    t2m_rows = []
    for b, x in xs.items():
        ms = cuda_time_ms(lambda: fused_encoder_layer(x, *w, num_heads=HEADS), 20, 3)
        plain_ms = cuda_time_ms(lambda: encoder_layer_plain(x, *w, num_heads=HEADS), 10, 2)
        lib_ms = cuda_time_ms(lambda: encoder_layer_sdpa(x, *w, HEADS), 10, 2)
        m = b * rows
        flops = 2 * m * (4 * T2M_D * T2M_D + 2 * T2M_D * FF) + 4 * b * rows**2 * T2M_D
        nbytes = 4 * (2 * m * T2M_D + sum(t.numel() for t in w))
        bound, by = bound_ms(flops, nbytes, tf32x3=True)
        time_line(f"encoder_layer [{b},{rows},{T2M_D}] heads {HEADS} of {T2M_D // HEADS}", ms,
                  plain_ms, lib_ms, bound, by, flops, nbytes, card, tf32x3=True)
        t2m_rows.append({
            "name": f"encoder_layer_t2m_{b}x{rows}x{T2M_D}", "route": "cuda",
            "source": "gesturediffusion_tpu_torch/csrc/encoder_layer.cu",
            "replaces": "gesturediffusion_tpu/ops/pallas_encoder.py:98",
            "launches": 0, "max_abs_err": errs[b], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})

    guided = classifier_free_guidance(model, 0.1)
    text_emb = embedder([PROMPT])
    for b in (T2M_REPS, T2M_BIG):
        x = randn(b, T2M_J, 1, T2M_FRAMES)
        noise = randn(b, T2M_J, 1, T2M_FRAMES)
        cond = {"text_emb": text_emb.expand(b, -1), "scale": torch.full((b,), 2.5, device=dev)}
        t = torch.full((b,), diffusion.num_timesteps // 2, dtype=torch.long, device=dev)

        def step():
            return p_sample(diffusion, guided, x, t, cond, noise)["sample"]

        _, launches = counted(step)
        if launches != t2m_step:
            raise AssertionError(f"t2m denoise step launches {launches} != {t2m_step}")
        t2m_rows[0 if b == T2M_REPS else 1]["launches"] += launches["encoder_layer"]
        ms = cuda_time_ms(step, 20, 3)
        model.use_kernels = False
        plain_ms = cuda_time_ms(step, 10, 2)
        model.use_kernels = True
        log(f"time t2m denoise step (CFG batch {2 * b}, [{2 * b},{rows},{T2M_D}]): kernels "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms {card}")
        device_profile(step, 5, f"t2m denoise step at CFG batch {2 * b}", card, host_rows=4)
    # the predict take ran at [6, 197, 512], the text edits at [20, 197, 512]
    t2m_rows[0]["launches"] += text_launches
    log(f"t2m: the edits' kept entries within {max(k[0] for k in kept):.3e} of the ground truth")
    return t2m_rows, total, kept[2][1]


def samplers_phase(model, model_path, chunk_conds, init_seed, randn, card):
    """Phase 11: the PLMS (order 2) and DPM++(2M) samplers on the phase-4
    model.  The phase-4 take (41 takes, 2 chunks, CFG batch 82) respaced to
    SAMPLER_STEPS steps with each, through the kernels (launches counted:
    PLMS adds one warm-up model pass a chunk) against the same take through
    the plain versions; the generate CLI with --sampler dpmpp; a streams-1
    session's chunk latency at DPM++-20 beside DDIM-50.  Returns the
    launches of these paths."""
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.sampling import (
        autoregressive_sample_loop,
        sample_loop,
    )
    from gesturediffusion_tpu_torch.diffusion.schedules import respacing_string
    from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn
    from gesturediffusion_tpu_torch.ops.flash_attention import fused_self_attention
    from gesturediffusion_tpu_torch.ops.fused_encoder import fused_encoder_layer
    from gesturediffusion_tpu_torch.ops.fused_local_block import fused_local_block
    from gesturediffusion_tpu_torch.serve.streaming import StreamingGestureSession

    dev = torch.device("cuda")
    counted, total = launch_counter({
        "local_block": fused_local_block, "encoder_layer": fused_encoder_layer,
        "flash_attention": fused_self_attention})
    precompute, model_fn = select_sampling_model_fn(model, GUIDANCE, 0.1)

    def diffusion(sampler, steps):
        return create_diffusion(noise_schedule="cosine", steps=1000, device=dev,
                                timestep_respacing=respacing_string(steps, sampler))

    for sampler, warmup in (("plms", 1), ("dpmpp", 0)):
        d = diffusion(sampler, SAMPLER_STEPS)

        def take():
            return autoregressive_sample_loop(
                d, model_fn, (B_TAKES, J, 1, T), chunk_conds, init_seed, S,
                generator=torch.Generator(device=dev).manual_seed(1),
                cond_precompute=precompute, loop=sample_loop(sampler))

        out, launches = counted(take)
        passes = (SAMPLER_STEPS + warmup) * CHUNKS
        want = {"local_block": passes, "encoder_layer": passes * LAYERS,
                "flash_attention": passes * LAYERS}
        t0 = time.perf_counter()
        take()
        torch.cuda.synchronize()
        take_s = time.perf_counter() - t0
        model.use_kernels = False
        plain = take()
        model.use_kernels = True
        report(f"{sampler} take ({B_TAKES} takes x {CHUNKS} chunks, respaced to "
               f"{SAMPLER_STEPS} steps, {passes // CHUNKS} model passes a chunk, CFG batch "
               f"{2 * B_TAKES}) vs plain versions on the card; launches {launches} (expected "
               f"{want}; |out| max {plain.abs().max().item():.3f})",
               (out - plain).abs().max().item(), TOL_TAKE,
               launches == want and bool(torch.isfinite(out).all())
               and tuple(out.shape) == (CHUNKS, B_TAKES, J, 1, T))
        log(f"time {sampler} take: {take_s:.3f} s = {B_TAKES * CHUNKS / take_s:.3f} chunks/s, "
            f"{take_s / passes * 1e3:.3f} ms a model pass {card}")

    motion, cli_s = generate_cli(
        model_path, {"dataset": "synthetic", "num_frames": T, "layers": LAYERS,
                     "latent_dim": D, "cond_mask_prob": 0.1, "seed_poses": S,
                     "noise_schedule": "cosine", "diffusion_steps": 1000,
                     "sigma_small": True},
        T, B_TAKES, str(SAMPLER_STEPS), os.path.join(os.path.dirname(model_path), "dpmpp"),
        extra=("--sampler", "dpmpp"))
    ok = motion.shape == (B_TAKES, J // 6, 3, T) and np.isfinite(motion).all()
    log(f"{'OK' if ok else 'FAIL'} generate CLI --sampler dpmpp --timestep_respacing "
        f"{SAMPLER_STEPS}: motion {motion.shape} in {cli_s:.1f} s (process included) {card}")
    if not ok:
        raise AssertionError("the generate CLI under dpmpp wrote the wrong results")

    feeds = [randn(1, A, 1, T) for _ in range(SAMPLER_CHUNKS)]
    for sampler, steps in (("ddim", STEPS), ("dpmpp", SAMPLER_STEPS)):
        session = StreamingGestureSession(
            model, guidance_param=GUIDANCE, cond_mask_prob=0.1, sampler=sampler,
            diffusion=diffusion(sampler, steps), streams=1, chunk_frames=T, seed_poses=S,
            fps=30.0, device=dev)
        session.start(init_seed[:1], rng=10)

        def serve():
            lat = []
            for f in feeds:
                session.feed({"mfcc": f})
                lat.append(session.stats().last_latency_s)
            return lat

        lat, launches = counted(serve)
        steady = lat[1:]
        mean = sum(steady) / len(steady)
        want = SAMPLER_CHUNKS * steps
        log(f"{'OK' if launches['local_block'] == want else 'FAIL'} serve streams 1, "
            f"{sampler.upper()}-{steps}: first chunk {lat[0] * 1e3:.2f} ms; steady mean "
            f"{mean * 1e3:.2f} ms, worst {max(steady) * 1e3:.2f} ms, real-time factor "
            f"{T / 30.0 / mean:.2f}; launches {launches} ({want} local blocks expected) {card}")
        if launches["local_block"] != want:
            raise AssertionError(f"the {sampler} session missed its kernels")
    return total


def t2m_train_phase(randn, rs, card):
    """Phase 12: text-to-motion training on the card.  Kernels 5 and 6 at
    [64, 197, 512] (heads of 128, ff 1024; rates 0.1 and 0) against their
    plain versions, with their times; T2M_TRAIN_STEPS steps of the
    humanml-encoder-512 MotionMDM at batch 64 with use_fused_train_encoder
    (8 forward and 8 backward launches a step) against the same steps
    through the plain layer, and a profiled step; the train CLI on a
    synthetic HumanML3D tree (the CLIP tower of phase 10 embedding the
    captions; launches counted), the predict CLI in this process on the
    checkpoint it writes (kernel 1 counted) and a batch of T2M_BIG prompts
    on it (CFG batch 64, counted); the flash kernel alone at
    [6, 4, 197, 128] and [64, 4, 197, 128].  Returns the kernel rows of
    these shapes, the launches of the phase's paths and those of its
    CFG-64 take."""
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.data.humanml import make_synthetic_humanml
    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
    from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
    from gesturediffusion_tpu_torch.ops.flash_attention import (
        fused_self_attention,
        self_attention_reference,
    )
    from gesturediffusion_tpu_torch.ops.fused_encoder import fused_encoder_layer
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
    )
    from gesturediffusion_tpu_torch.sample import predict
    from gesturediffusion_tpu_torch.train import train_mdm
    from gesturediffusion_tpu_torch.train.loop import (
        TrainConfig,
        TrainState,
        make_optimizer,
        train_step,
    )

    dev = torch.device("cuda")
    counted, total = launch_counter({
        "encoder_layer": fused_encoder_layer, "flash_attention": fused_self_attention,
        "encoder_layer_train_fwd": encoder_layer_train_fwd,
        "encoder_layer_train_bwd": encoder_layer_train_bwd})
    rows, dh = T2M_FRAMES + 1, T2M_D // HEADS

    # ---- kernels 5 and 6 at the t2m shape ------------------------------------ #
    w = layer_weights(randn, T2M_D, FF)
    xt, gt = randn(MB, rows, T2M_D), randn(MB, rows, T2M_D)
    seed = torch.tensor([20241], dtype=torch.int32, device=dev)
    fwd_err, bwd_err = check_train_layer(xt, gt, w, seed)
    times = train_kernel_times(xt, gt, w, seed, iters=10)
    shape = f"[{MB},{rows},{T2M_D}] heads {HEADS} of {dh}"
    time_line(f"encoder_layer_train_fwd {shape}", *times["fwd"], card, tf32x3=True)
    time_line(f"encoder_layer_train_bwd {shape} (plain and library: forward + backward)",
              *times["bwd"], card, tf32x3=True)

    # ---- train steps through the kernels against the plain steps ----------- #
    torch.manual_seed(5)
    model = MotionMDM(njoints=T2M_J, latent_dim=T2M_D, ff_size=FF, num_layers=LAYERS,
                      num_heads=HEADS, dropout=RATE, cond_mode="text", cond_mask_prob=0.1,
                      use_fused_train_encoder=True).to(dev)
    plain = copy.deepcopy(model)
    plain.use_kernels = False
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000, device=dev)
    cfg = TrainConfig(lr=1e-4, batch_size=MB)
    lengths = rs.randint(40, T2M_FRAMES + 1, size=MB)
    mask = torch.from_numpy(np.arange(T2M_FRAMES)[None] < lengths[:, None])[:, None, None]
    batches = [dict(motion=randn(MB, T2M_J, 1, T2M_FRAMES, scale=0.5),
                    cond={"text_emb": randn(MB, 512, scale=0.1), "mask": mask.to(dev)},
                    t=torch.from_numpy(rs.randint(0, 1000, size=MB)).to(dev),
                    noise=randn(MB, T2M_J, 1, T2M_FRAMES)) for _ in range(T2M_TRAIN_STEPS)]
    compare_train_steps(model, plain, diffusion, cfg, batches, LAYERS,
                        f"batch {MB}, [{MB},{rows},{T2M_D}], heads of {dh}",
                        f"{LAYERS} layers", card)
    total["encoder_layer_train_fwd"] += LAYERS * T2M_TRAIN_STEPS
    total["encoder_layer_train_bwd"] += LAYERS * T2M_TRAIN_STEPS
    state = TrainState(model, *make_optimizer(model.parameters(), cfg), UniformSampler(1000), {})
    gen = torch.Generator(device=dev).manual_seed(3)
    b0 = batches[0]
    device_profile(lambda: train_step(state, diffusion, cfg, b0["motion"], b0["cond"], gen,
                                      b0["t"], b0["noise"]),
                   2, f"t2m train step (batch {MB}, [{MB},{rows},{T2M_D}])", card,
                   host_rows=8, groups=train_kernel_group)

    # ---- the train CLI, then the predict CLI on its checkpoint -------------- #
    base = os.path.join(HERE, "build", "chip_smoke", "t2m_train")
    t0 = time.perf_counter()
    root = make_synthetic_humanml(os.path.join(base, "humanml"), n_clips=T2M_TRAIN_CLIPS,
                                  dim=T2M_J)
    make_s = time.perf_counter() - t0
    save_dir = os.path.join(base, "run")
    t0 = time.perf_counter()
    loop, launches = counted(lambda: train_mdm.main([
        "--dataset", "humanml", "--data_dir", root, "--save_dir", save_dir, "--overwrite",
        "--latent_dim", str(T2M_D), "--batch_size", str(MB), "--use_fused_train_encoder",
        "--num_steps", str(CLI_STEPS), "--log_interval", "10"]))
    cli_s = time.perf_counter() - t0
    want = LAYERS * CLI_STEPS
    ckpt = os.path.join(save_dir, f"model{CLI_STEPS:09d}.pt")
    ok = (loop.state.step == CLI_STEPS and os.path.exists(ckpt)
          and launches["encoder_layer_train_fwd"] == want
          and launches["encoder_layer_train_bwd"] == want
          and type(loop.text_encoder).__name__ == "CLIPTextEmbedder")
    log(f"{'OK' if ok else 'FAIL'} train CLI --dataset humanml --latent_dim {T2M_D} --batch_size "
        f"{MB} --use_fused_train_encoder: {CLI_STEPS} steps in {cli_s:.1f} s (data set-up, the "
        f"CLIP tower's captions included; the tree of {T2M_TRAIN_CLIPS} clips written in "
        f"{make_s:.1f} s); text encoder {type(loop.text_encoder).__name__}; launches fwd "
        f"{launches['encoder_layer_train_fwd']} bwd {launches['encoder_layer_train_bwd']} "
        f"(expected {want} each) {card}")
    if not ok:
        raise AssertionError("the humanml train CLI missed its steps or kernels")
    out_dir = os.path.join(base, "predict")
    t0 = time.perf_counter()
    _, launches = counted(lambda: predict.main([
        "--model_path", ckpt, "--text", PROMPT, "--motion_length", "9.8",
        "--output_dir", out_dir]))
    predict_s = time.perf_counter() - t0
    res = np.load(os.path.join(out_dir, "results.npy"), allow_pickle=True).item()
    want = {"encoder_layer": 1000 * LAYERS, "flash_attention": 1000 * LAYERS}
    ok = (res["motion"].shape == (T2M_REPS, 22, 3, T2M_FRAMES)
          and np.isfinite(res["motion"]).all()
          and {k: launches[k] for k in want} == want)
    log(f"{'OK' if ok else 'FAIL'} predict CLI on the trained checkpoint (1000 DDPM steps, "
        f"{T2M_REPS} repetitions): motion {res['motion'].shape} in {predict_s:.1f} s; launches "
        f"{launches} (expected {want}) {card}")
    if not ok:
        raise AssertionError("the predict CLI on the trained checkpoint failed")
    # a batch of T2M_BIG prompts (CFG batch 64) on the trained checkpoint
    predictor = predict.Predictor(
        ckpt, dataset_root=root, device=dev,
        model=MotionMDM(njoints=T2M_J, latent_dim=T2M_D, ff_size=FF, num_layers=LAYERS,
                        num_heads=HEADS, cond_mode="text", cond_mask_prob=0.1),
        diffusion=create_diffusion(noise_schedule="cosine", steps=1000, device=dev,
                                   timestep_respacing=T2M_RESPACING))
    big, big_launches = counted(lambda: predictor.predict(PROMPT, T2M_BIG, seed=0,
                                                          motion_length=9.8))
    want = {"encoder_layer": T2M_STEPS * LAYERS, "flash_attention": T2M_STEPS * LAYERS}
    ok = (big["features"].shape == (T2M_BIG, T2M_FRAMES, T2M_J)
          and np.isfinite(big["motion_xyz"]).all()
          and {k: big_launches[k] for k in want} == want)
    log(f"{'OK' if ok else 'FAIL'} {T2M_BIG} prompts at once on the trained checkpoint (CFG "
        f"batch {2 * T2M_BIG}, DDPM respaced to {T2M_STEPS}): features {big['features'].shape}; "
        f"launches {big_launches} (expected {want}) {card}")
    if not ok:
        raise AssertionError("the CFG-64 take on the trained checkpoint failed")

    # ---- flash alone at heads of 128 ----------------------------------------- #
    out_rows = [
        {"name": f"encoder_layer_train_{k}_t2m_{MB}x{rows}x{T2M_D}", "route": "cuda",
         "source": "gesturediffusion_tpu_torch/csrc/encoder_layer_train.cu",
         "replaces": f"gesturediffusion_tpu/ops/pallas_encoder_train.py:{line}",
         "launches": total[f"encoder_layer_train_{k}"], "max_abs_err": err,
         **time_keys(times[k])}
        for k, line, err in (("fwd", 249, fwd_err), ("bwd", 273, bwd_err))]
    for b in (2 * T2M_REPS, 2 * T2M_BIG):
        q, k, v = (randn(b, HEADS, rows, dh) for _ in range(3))
        got = fused_self_attention(q, k, v)
        err = (got - self_attention_reference(q, k, v)).abs().max().item()
        report(f"flash_attention [{b},{HEADS},{rows},{dh}]", err, TOL_FLASH, got.shape == q.shape)
        ms = cuda_time_ms(lambda: fused_self_attention(q, k, v), 20, 3)
        plain_ms = cuda_time_ms(lambda: self_attention_reference(q, k, v), 10, 2)
        lib_ms = cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 20, 3)
        flops = 4 * b * HEADS * rows**2 * dh
        nbytes = 4 * 4 * q.numel()
        bound, by = bound_ms(flops, nbytes, tf32x3=True)
        time_line(f"flash_attention [{b},{HEADS},{rows},{dh}]", ms, plain_ms, lib_ms, bound, by,
                  flops, nbytes, card, tf32x3=True)
        out_rows.append({
            "name": f"flash_attention_t2m_{b}x{HEADS}x{rows}x{dh}", "route": "cuda",
            "source": "gesturediffusion_tpu_torch/csrc/flash_attention.cu",
            "replaces": "gesturediffusion_tpu/ops/pallas_flash.py:35",
            # the predict CLI's steps run at CFG batch 6, the 32 prompts' at 64
            "launches": (launches if b == 2 * T2M_REPS else big_launches)["flash_attention"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms})
    return out_rows, total, big_launches


def a2m_train_phase(randn, rs, card):
    """Phase 13: action-to-motion training on the card.  A synthetic SMPL
    pickle at 6890 vertices (SMPL_MODEL_PATH), synthetic HumanAct12 and
    UESTC trees; the training losses' fk_fn (rotation2xyz to SMPL's smpl
    joints) on the card against the CPU under TOL_SMPL; kernels 5 and 6 at
    [64, 61, 512] against their plain versions and their times;
    A2M_STEPS steps of the action-mode MotionMDM at batch 64 with the
    recipe's lambdas through the training kernels against the plain steps,
    a profiled step and the fk / SMPL share of its device time; the train
    CLI on humanact12 and on uestc (20 steps each, launches counted); the
    humanact12 checkpoint read back in the reference layout and 12 actions
    sampled from it (DDPM respaced to 50, kernel 1 at [12, 61, 512])
    against the plain take, and kernel 1's times at that shape.  Returns
    the kernel rows of these shapes and the launches of the phase's
    paths."""
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.data.a2m import make_synthetic_humanact12
    from gesturediffusion_tpu_torch.data.uestc import make_synthetic_uestc
    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample_loop
    from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
    from gesturediffusion_tpu_torch.models.rotation2xyz import rotation2xyz
    from gesturediffusion_tpu_torch.models.smpl import load_smpl_pickle, save_synthetic_smpl_pickle
    from gesturediffusion_tpu_torch.ops.flash_attention import fused_self_attention
    from gesturediffusion_tpu_torch.ops.fused_encoder import (
        encoder_layer_plain,
        fused_encoder_layer,
    )
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
    )
    from gesturediffusion_tpu_torch.ops.rotations import (
        matrix_to_rotation_6d,
        rotation_6d_to_matrix,
    )
    from gesturediffusion_tpu_torch.train import train_mdm
    from gesturediffusion_tpu_torch.train.loop import TrainConfig, TrainState, make_optimizer
    from gesturediffusion_tpu_torch.train.loop import train_step
    from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
    from gesturediffusion_tpu_torch.utils.convert import load_checkpoint

    dev = torch.device("cuda")
    counted, total = launch_counter({
        "encoder_layer": fused_encoder_layer, "flash_attention": fused_self_attention,
        "encoder_layer_train_fwd": encoder_layer_train_fwd,
        "encoder_layer_train_bwd": encoder_layer_train_bwd})
    rows, dh = A2M_FRAMES + 1, T2M_D // HEADS

    # ---- the body model and the trees ---------------------------------------- #
    base = os.path.join(HERE, "build", "chip_smoke", "a2m")
    os.makedirs(base, exist_ok=True)
    t0 = time.perf_counter()
    smpl_path = save_synthetic_smpl_pickle(os.path.join(base, "smpl.pkl"), n_vertices=A2M_VERTS)
    os.environ["SMPL_MODEL_PATH"] = smpl_path
    ha12 = make_synthetic_humanact12(os.path.join(base, "humanact12"), n_clips=A2M_CLIPS)
    uestc = make_synthetic_uestc(os.path.join(base, "uestc"), n_videos=UESTC_VIDEOS,
                                 n_actions=40, min_frames=64, max_frames=100)
    smpl_cpu = load_smpl_pickle(smpl_path)
    smpl = load_smpl_pickle(smpl_path).to(dev)
    log(f"a2m: a synthetic SMPL pickle of {A2M_VERTS} vertices "
        f"({os.path.getsize(smpl_path) / 1e6:.1f} MB), a HumanAct12 tree of {A2M_CLIPS} clips "
        f"and a UESTC tree of {UESTC_VIDEOS} videos written in {time.perf_counter() - t0:.1f} s")

    def fk_on(body):
        def fk_fn(sample):
            return rotation2xyz(body, sample, pose_rep="rot6d", translation=True, glob=True,
                                jointstype="smpl", vertstrans=False)
        return fk_fn

    fk_fn = fk_on(smpl)

    def a2m_motion(b):
        """Rot6d rows of random rotations and a translation row [B, 25, 6, T]."""
        rot = matrix_to_rotation_6d(rotation_6d_to_matrix(randn(b, 24, A2M_FRAMES, 6, scale=0.3)))
        trans = torch.zeros(b, 1, A2M_FRAMES, 6, device=dev)
        trans[..., :3] = torch.cumsum(randn(b, 1, A2M_FRAMES, 3, scale=0.01), dim=2)
        return torch.cat([rot, trans], dim=1).permute(0, 1, 3, 2).contiguous()

    # ---- SMPL's joints on the card against the CPU ---------------------------- #
    motion0 = a2m_motion(MB)
    got = fk_fn(motion0)
    want = fk_on(smpl_cpu)(motion0.cpu())
    smpl_err = (got.cpu() - want).abs().max().item()
    report(f"rotation2xyz smpl joints on the card vs the CPU ([{MB},{A2M_J},{A2M_F},{A2M_FRAMES}]"
           f" rot6d -> [{MB},24,3,{A2M_FRAMES}], {A2M_VERTS} vertices, the chain only; |xyz| max "
           f"{want.abs().max().item():.3f})", smpl_err, TOL_SMPL,
           tuple(got.shape) == (MB, 24, 3, A2M_FRAMES) and bool(torch.isfinite(got).all()))

    # ---- kernels 5 and 6 at the a2m shape -------------------------------------- #
    w = layer_weights(randn, T2M_D, FF)
    xt, gt = randn(MB, rows, T2M_D), randn(MB, rows, T2M_D)
    seed = torch.tensor([20242], dtype=torch.int32, device=dev)
    fwd_err, bwd_err = check_train_layer(xt, gt, w, seed)
    times = train_kernel_times(xt, gt, w, seed, iters=20)
    shape = f"[{MB},{rows},{T2M_D}] heads {HEADS} of {dh}"
    time_line(f"encoder_layer_train_fwd {shape}", *times["fwd"], card, tf32x3=True)
    time_line(f"encoder_layer_train_bwd {shape} (plain and library: forward + backward)",
              *times["bwd"], card, tf32x3=True)

    # ---- train steps through the kernels against the plain steps ------------- #
    torch.manual_seed(6)
    model = MotionMDM(njoints=A2M_J, nfeats=A2M_F, latent_dim=T2M_D, ff_size=FF,
                      num_layers=LAYERS, num_heads=HEADS, dropout=RATE, cond_mode="action",
                      num_actions=A2M_ACTIONS, cond_mask_prob=0.0,
                      use_fused_train_encoder=True).to(dev)
    plain = copy.deepcopy(model)
    plain.use_kernels = False
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000, lambda_rcxyz=1.0,
                                 lambda_vel=1.0, lambda_fc=1.0, device=dev)
    cfg = TrainConfig(lr=1e-4, batch_size=MB)
    lengths = rs.randint(40, A2M_FRAMES + 1, size=MB)
    mask = torch.from_numpy(np.arange(A2M_FRAMES)[None] < lengths[:, None])[:, None, None]
    batches = [dict(motion=motion0 if i == 0 else a2m_motion(MB),
                    cond={"action": torch.from_numpy(rs.randint(0, A2M_ACTIONS, size=MB)).to(dev),
                          "mask": mask.to(dev)},
                    t=torch.from_numpy(rs.randint(0, 1000, size=MB)).to(dev),
                    noise=randn(MB, A2M_J, A2M_F, A2M_FRAMES)) for i in range(A2M_STEPS)]
    compare_train_steps(model, plain, diffusion, cfg, batches, LAYERS,
                        f"batch {MB}, [{MB},{rows},{T2M_D}], heads of {dh}, the recipe's "
                        f"geometric losses through SMPL", f"{LAYERS} layers", card, fk_fn=fk_fn,
                        grad_miss=("ROADMAP C6 (the rot6d losses' conditioning and the "
                                   "training GEMM's forward error; tools/a2m_f64_check.py)",
                                   TOL_STEP_GRAD_C6))
    total["encoder_layer_train_fwd"] += LAYERS * A2M_STEPS
    total["encoder_layer_train_bwd"] += LAYERS * A2M_STEPS
    state = TrainState(model, *make_optimizer(model.parameters(), cfg), UniformSampler(1000), {})
    gen = torch.Generator(device=dev).manual_seed(3)
    b0 = batches[0]

    def fk_spanned(sample):
        with torch.profiler.record_function("fk"):
            return fk_fn(sample)

    step = device_profile(
        lambda: train_step(state, diffusion, cfg, b0["motion"], b0["cond"], gen, b0["t"],
                           b0["noise"], fk_fn=fk_spanned),
        3, f"a2m train step (batch {MB}, [{MB},{rows},{T2M_D}], fk through SMPL)", card,
        host_rows=8, groups=train_kernel_group, ranges=("fk",))
    fk_ms, fk_launches = step["ranges"]["fk"]
    log(f"time a2m train step: fk / SMPL (the target's and the prediction's joints and the "
        f"prediction's backward through them, in the step's own profile) {fk_ms:.4f} of "
        f"{step['busy_ms']:.4f} ms of device time = {fk_ms / step['busy_ms']:.3f} of the "
        f"step's, {fk_launches} of its {step['launches']} launches; idle share "
        f"{step['idle']:.3f}; {MB / step['ms'] * 1e3:.1f} samples/s profiled {card}")
    if not 0 < fk_ms < step["busy_ms"]:
        raise AssertionError("the profile found no fk work in the a2m step")

    # ---- the train CLI on both datasets --------------------------------------- #
    clis = {}
    for name, root in (("humanact12", ha12), ("uestc", uestc)):
        save_dir = os.path.join(base, f"run_{name}")
        t0 = time.perf_counter()
        loop, launches = counted(lambda: train_mdm.main([
            "--dataset", name, "--data_dir", root, "--save_dir", save_dir, "--overwrite",
            "--latent_dim", str(T2M_D), "--batch_size", str(MB), "--num_frames",
            str(A2M_FRAMES), "--use_fused_train_encoder", "--num_steps", str(CLI_STEPS),
            "--log_interval", "10", *RECIPE]))
        cli_s = time.perf_counter() - t0
        want = LAYERS * CLI_STEPS
        ckpt = os.path.join(save_dir, f"model{CLI_STEPS:09d}.pt")
        ok = (loop.state.step == CLI_STEPS and os.path.exists(ckpt) and loop.fk_fn is not None
              and launches["encoder_layer_train_fwd"] == want
              and launches["encoder_layer_train_bwd"] == want
              and loop.state.nonfinite_skips == 0)
        log(f"{'OK' if ok else 'FAIL'} train CLI --dataset {name} --latent_dim {T2M_D} "
            f"--batch_size {MB} --num_frames {A2M_FRAMES} --use_fused_train_encoder "
            f"{' '.join(RECIPE)}: {CLI_STEPS} steps in {cli_s:.1f} s (data set-up included); "
            f"{loop.state.model.embed_action.action_embedding.shape[0]} actions; launches fwd "
            f"{launches['encoder_layer_train_fwd']} bwd {launches['encoder_layer_train_bwd']} "
            f"(expected {want} each) {card}")
        if not ok:
            raise AssertionError(f"the {name} train CLI missed its steps or kernels")
        clis[name] = ckpt

    # ---- the humanact12 checkpoint, read back and sampled ---------------------- #
    sd = load_checkpoint(clis["humanact12"])
    ref = MotionMDM(njoints=A2M_J, nfeats=A2M_F, latent_dim=T2M_D, ff_size=FF,
                    num_layers=LAYERS, num_heads=HEADS, cond_mode="action",
                    num_actions=A2M_ACTIONS, cond_mask_prob=0.0)
    ok = (set(sd) == set(ref.state_dict()) and "embed_action.bias" not in sd
          and tuple(sd["embed_action.action_embedding"].shape) == (A2M_ACTIONS, T2M_D))
    ref.load_state_dict(sd)  # strict: the reference layout, the bias folded
    ref = ref.to(dev).eval()
    log(f"{'OK' if ok else 'FAIL'} the humanact12 checkpoint holds the reference layout "
        f"({len(sd)} tensors, embed_action.action_embedding {tuple(sd['embed_action.action_embedding'].shape)}, "
        f"no bias) and loads strictly")
    if not ok:
        raise AssertionError("the a2m checkpoint is not in the reference layout")
    sampler = create_diffusion(noise_schedule="cosine", steps=1000, timestep_respacing=RESPACING,
                               device=dev)
    cond = {"action": torch.arange(A2M_ACTIONS, device=dev)}
    shape_ = (A2M_ACTIONS, A2M_J, A2M_F, A2M_FRAMES)

    def take():
        gen = torch.Generator(device=dev).manual_seed(11)
        return p_sample_loop(sampler, ref, shape_, cond, generator=gen)

    with torch.no_grad():
        out, launches = counted(take)
        take_launches = launches
        ref.use_kernels = False
        out_plain = take()
        ref.use_kernels = True
    want = {"encoder_layer": STEPS * LAYERS, "flash_attention": STEPS * LAYERS,
            "encoder_layer_train_fwd": 0, "encoder_layer_train_bwd": 0}
    xyz = fk_fn(out)
    take_err = (out - out_plain).abs().max().item()
    report(f"a2m take ({A2M_ACTIONS} actions, one each, DDPM respaced to {STEPS}, "
           f"[{A2M_ACTIONS},{rows},{T2M_D}]) vs plain versions on the card; launches {launches} "
           f"(expected {want}); xyz {tuple(xyz.shape)} (|out| max "
           f"{out_plain.abs().max().item():.3f})", take_err, TOL_TAKE,
           launches == want and bool(torch.isfinite(xyz).all()))

    # ---- kernel 1 at the sampling shape ---------------------------------------- #
    x1 = randn(A2M_ACTIONS, rows, T2M_D)
    got = fused_encoder_layer(x1, *w, num_heads=HEADS)
    enc_err = (got - encoder_layer_plain(x1, *w, num_heads=HEADS)).abs().max().item()
    report(f"encoder_layer [{A2M_ACTIONS},{rows},{T2M_D}] heads {HEADS} of {dh} ff {FF}",
           enc_err, TOL_ENCODER, got.shape == x1.shape)
    ms = cuda_time_ms(lambda: fused_encoder_layer(x1, *w, num_heads=HEADS), 50, 5)
    plain_ms = cuda_time_ms(lambda: encoder_layer_plain(x1, *w, num_heads=HEADS), 20, 3)
    lib_ms = cuda_time_ms(lambda: encoder_layer_sdpa(x1, *w, HEADS), 20, 3)
    m = A2M_ACTIONS * rows
    flops = 2 * m * (4 * T2M_D * T2M_D + 2 * T2M_D * FF) + 4 * A2M_ACTIONS * rows**2 * T2M_D
    nbytes = 4 * (2 * m * T2M_D + sum(t.numel() for t in w))
    bound, by = bound_ms(flops, nbytes, tf32x3=True)
    time_line(f"encoder_layer [{A2M_ACTIONS},{rows},{T2M_D}] heads {HEADS} of {dh}", ms,
              plain_ms, lib_ms, bound, by, flops, nbytes, card, tf32x3=True)

    out_rows = [
        {"name": f"encoder_layer_train_{k}_a2m_{MB}x{rows}x{T2M_D}", "route": "cuda",
         "source": "gesturediffusion_tpu_torch/csrc/encoder_layer_train.cu",
         "replaces": f"gesturediffusion_tpu/ops/pallas_encoder_train.py:{line}",
         "launches": total[f"encoder_layer_train_{k}"], "max_abs_err": err,
         **time_keys(times[k])}
        for k, line, err in (("fwd", 249, fwd_err), ("bwd", 273, bwd_err))]
    out_rows.append({
        "name": f"encoder_layer_a2m_{A2M_ACTIONS}x{rows}x{T2M_D}", "route": "cuda",
        "source": "gesturediffusion_tpu_torch/csrc/encoder_layer.cu",
        "replaces": "gesturediffusion_tpu/ops/pallas_encoder.py:98",
        "launches": take_launches["encoder_layer"], "max_abs_err": enc_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})
    return out_rows, total


def read_metrics_yaml(path: str) -> dict:
    """The eval CLI's flat YAML of floats (.nan, .inf as PyYAML writes them)."""
    special = {".nan": math.nan, ".inf": math.inf, "-.inf": -math.inf}
    out = {}
    with open(path) as f:
        for line in f:
            k, v = line.split(":", 1)
            out[k.strip()] = special.get(v.strip(), None) or float(v)
    return out


def a2m_protocol_keys(name: str) -> set:
    """The metric keys of JAX's a2m protocol in an eval YAML: accuracy, FID,
    diversity, multimodality of gt and gen (per split on UESTC), each with
    its 95% interval, and the unconstrained branch's five."""
    keys = {f"{m}_{k}" for m in ("accuracy", "diversity", "multimodality", "fid")
            for k in ("gt", "gen")}
    if name == "uestc":
        keys = {f"{k}_{split}" for k in keys for split in ("train", "test")}
    keys |= {f"{k}_conf" for k in keys}
    if name == "unconstrained":
        keys |= {f"{k}_unconstrained" for k in ("fid", "kid_mean", "kid_std", "diversity_gen",
                                                "diversity_gt")}
    return keys


def a2m_eval_phase(randn, card):
    """Phase 14: the action-to-motion evaluation on the card.  A third
    phase-13 checkpoint (humanact12, --unconstrained, 20 steps); with
    PyTorch's TF32 defaults back on (cuDNN's TF32 on; restored at the end),
    the eval CLI in debug mode (2 seeds x 64 samples, --batch_size 64) on
    the humanact12, uestc and unconstrained checkpoints: the YAML's keys,
    finite values (NaN only where the protocol makes it: accuracy and
    multimodality under no_cond), kernels 1 and 4 launched 8 x 1000 steps
    a generated batch; seed 0's generated batch against the plain path
    under TOL_TAKE; the GRU, recognition ST-GCN and MoDi ST-GCN features on
    the card against the CPU for the same batches under TOL_EVAL_FEATS (the
    eval's own TF32 guard; the modules called without it, cuDNN's TF32 on,
    are a control the check must fail), and the gt metrics card against
    CPU under the same tolerance; kernel 1 at
    [64, 61, 512] and its times; the train CLI --eval_during_training on
    humanact12 (the benchmark after the save at step 10) and on the phase-9
    GENEA tree (the validation loss).  Returns the kernel row of
    [64, 61, 512] and the launches of the phase's main paths by kernel (the
    training kernels' of the a2m CLIs under ``a2m_``), with seed 0's generated
    and ground-truth batches under ``batches``."""
    import shutil

    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.data.a2m import HumanAct12Poses
    from gesturediffusion_tpu_torch.data.uestc import UESTC
    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample_loop
    from gesturediffusion_tpu_torch.eval import eval_a2m
    from gesturediffusion_tpu_torch.eval.eval_a2m import (
        NUM_FRAMES,
        UNCONSTRAINED_15_JOINTS,
        A2MEvaluation,
        STGCNA2MEvaluation,
        make_fk_fn,
        make_generated_batches,
        make_gt_batches,
    )
    from gesturediffusion_tpu_torch.eval.eval_unconstrained import UnconstrainedEvaluator
    from gesturediffusion_tpu_torch.models.smpl import load_smpl_pickle
    from gesturediffusion_tpu_torch.ops.flash_attention import fused_self_attention
    from gesturediffusion_tpu_torch.ops.fused_encoder import (
        encoder_layer_plain,
        fused_encoder_layer,
    )
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
    )
    from gesturediffusion_tpu_torch.ops.fused_local_block import fused_local_block
    from gesturediffusion_tpu_torch.train import train_mdm
    from gesturediffusion_tpu_torch.utils.convert import load_checkpoint
    from gesturediffusion_tpu_torch.utils.model_factory import create_model_and_diffusion
    from gesturediffusion_tpu_torch.utils.parser import evaluation_args

    dev = torch.device("cuda")
    counted, _ = launch_counter({
        "encoder_layer": fused_encoder_layer, "flash_attention": fused_self_attention,
        "local_block": fused_local_block, "encoder_layer_train_fwd": encoder_layer_train_fwd,
        "encoder_layer_train_bwd": encoder_layer_train_bwd})
    rows, dh = A2M_FRAMES + 1, T2M_D // HEADS
    base = os.path.join(HERE, "build", "chip_smoke", "a2m")
    roots = {name: os.path.join(base, name) for name in ("humanact12", "uestc")}
    smpl_path = os.environ["SMPL_MODEL_PATH"]  # phase 13's
    ckpts = {name: os.path.join(base, f"run_{name}", f"model{CLI_STEPS:09d}.pt") for name in roots}
    args = evaluation_args(["--model_path", ckpts["humanact12"]])
    steps = args.diffusion_steps  # the chain the checkpoints were trained for
    debug = eval_a2m.EVAL_MODES_A2M["debug"]
    per_seed = -(-debug["num_samples"] // MB)  # generated batches a seed and split

    # ---- the unconstrained checkpoint ----------------------------------------- #
    save_dir = os.path.join(base, "run_unconstrained")
    t0 = time.perf_counter()
    loop, launches = counted(lambda: train_mdm.main([
        "--dataset", "humanact12", "--data_dir", roots["humanact12"], "--save_dir", save_dir,
        "--overwrite", "--latent_dim", str(T2M_D), "--batch_size", str(MB), "--num_frames",
        str(A2M_FRAMES), "--use_fused_train_encoder", "--num_steps", str(CLI_STEPS),
        "--log_interval", "10", "--unconstrained", *RECIPE]))
    ckpts["unconstrained"] = os.path.join(save_dir, f"model{CLI_STEPS:09d}.pt")
    uncon = launches
    want = LAYERS * CLI_STEPS
    ok = (loop.state.model.cond_mode == "no_cond" and os.path.exists(ckpts["unconstrained"])
          and launches["encoder_layer_train_fwd"] == want
          and launches["encoder_layer_train_bwd"] == want)
    log(f"{'OK' if ok else 'FAIL'} train CLI --dataset humanact12 --unconstrained: {CLI_STEPS} "
        f"steps in {time.perf_counter() - t0:.1f} s; launches fwd "
        f"{launches['encoder_layer_train_fwd']} bwd {launches['encoder_layer_train_bwd']} "
        f"(expected {want} each) {card}")
    if not ok:
        raise AssertionError("the unconstrained train CLI missed its steps or kernels")

    smoke_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    log(f"a2m-eval: PyTorch's TF32 defaults for the phase: matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")
    try:
        # ---- the eval CLI on the three checkpoints ------------------------------ #
        eval_launches = dict.fromkeys(("encoder_layer", "flash_attention"), 0)
        seeds = debug["num_seeds"]  # the seeds' batches (x 2 splits) (+ the branch's)
        chains = {"humanact12": seeds * per_seed, "uestc": 2 * seeds * per_seed,
                  "unconstrained": (seeds + 1) * per_seed}
        for name, ckpt in ckpts.items():
            argv = ["--model_path", ckpt, "--eval_mode", "debug", "--batch_size", str(MB)]
            t0 = time.perf_counter()
            summary, launches = counted(lambda: eval_a2m.main(argv))
            wall = time.perf_counter() - t0
            dataset = "uestc" if name == "uestc" else "humanact12"
            got = read_metrics_yaml(os.path.join(os.path.dirname(ckpt),
                                                 f"eval_{dataset}_debug.yaml"))
            nan_by_design = {k for k in got if name == "unconstrained"
                             and k.startswith(("accuracy_", "multimodality_"))}
            want = LAYERS * steps * chains[name]
            ok = (set(got) == a2m_protocol_keys(name) and got.keys() == summary.keys()
                  and all(math.isnan(v) == (k in nan_by_design) for k, v in got.items())
                  and all(math.isfinite(v) for k, v in got.items() if k not in nan_by_design)
                  and launches["encoder_layer"] == want and launches["flash_attention"] == want)
            for k in eval_launches:
                eval_launches[k] += launches[k]
            log(f"{'OK' if ok else 'FAIL'} eval CLI {name} --eval_mode debug --batch_size {MB}: "
                f"{len(got)} protocol keys ({len(nan_by_design)} NaN by design), {wall:.1f} s "
                f"wall, {MB * chains[name] / wall:.2f} generated samples/s of CLI wall time; "
                f"launches {launches['encoder_layer']} / {launches['flash_attention']} (expected "
                f"{want} each: {LAYERS} x {steps} steps x {chains[name]} batches); fid_gen "
                f"{got.get('fid_gen', got.get('fid_gen_test'))}, diversity_gt "
                f"{got.get('diversity_gt', got.get('diversity_gt_test'))} {card}")
            if not ok:
                raise AssertionError(f"the eval CLI on {name} wrote the wrong metrics or "
                                     f"missed its kernels: {sorted(got.items())}")

        # ---- seed 0's generated batch against the plain path --------------------- #
        ds = HumanAct12Poses(roots["humanact12"], num_frames=NUM_FRAMES, pose_rep="rot6d",
                             split="test")
        model, diffusion = create_model_and_diffusion(args, ds, dev)
        model.load_state_dict(load_checkpoint(ckpts["humanact12"]))
        model.to(dev).eval()
        smpl = load_smpl_pickle(smpl_path).to(dev)
        fk_fn = make_fk_fn(smpl)

        def sample_fn(generator, shape, cond):
            return p_sample_loop(diffusion, model, shape, cond, generator=generator)

        ds.reset_shuffle()
        ds.shuffle()  # seed 0's order, as evaluate_humanact12 draws it
        order = ds.rng.getstate()

        def generated():
            ds.rng.setstate(order)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = make_generated_batches(sample_fn, fk_fn, ds, MB, MB, NUM_FRAMES, seed=0,
                                         device=dev)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        (gen, kernel_s), launches = counted(generated)
        model.use_kernels = False
        gen_plain, plain_s = generated()
        model.use_kernels = True
        want = {"encoder_layer": LAYERS * steps, "flash_attention": LAYERS * steps,
                "local_block": 0, "encoder_layer_train_fwd": 0, "encoder_layer_train_bwd": 0}
        err = np.abs(gen[0]["output_rot"] - gen_plain[0]["output_rot"]).max()
        xyz_err = np.abs(gen[0]["output_xyz"] - gen_plain[0]["output_xyz"]).max()
        report(f"a2m eval: seed 0's generated batch ({MB} samples, DDPM {steps} steps, "
               f"[{MB},{rows},{T2M_D}]) vs the plain path on the card; launches {launches} "
               f"(expected {want}); SMPL xyz max|diff| {xyz_err:.3e} (|sample| max "
               f"{np.abs(gen_plain[0]['output_rot']).max():.3f})", float(err), TOL_TAKE,
               launches == want and np.isfinite(gen[0]["output_xyz"]).all())
        log(f"time a2m eval sampling ({MB} samples, {steps} DDPM steps, FK included): kernels "
            f"{kernel_s:.3f} s = {MB / kernel_s:.2f} samples/s, {kernel_s / steps * 1e3:.3f} "
            f"ms/step; plain {plain_s:.3f} s = {MB / plain_s:.2f} samples/s, "
            f"{plain_s / steps * 1e3:.3f} ms/step {card}")

        # ---- the classifiers' features, card against CPU ------------------------- #
        ds.rng.setstate(order)
        gt = make_gt_batches(fk_fn, ds, MB, MB, NUM_FRAMES, device=dev)
        ds.rng.setstate(order)
        gt_cpu = make_gt_batches(make_fk_fn(load_smpl_pickle(smpl_path)), ds, MB, MB,
                                 NUM_FRAMES, device="cpu")
        batches = [gen[0], gt[0]]
        modi_in = np.concatenate([b["output_xyz"][:, UNCONSTRAINED_15_JOINTS] for b in batches])
        modi_in = modi_in - modi_in[:, 8:9]
        evaluations = {
            "GRU": [A2MEvaluation(device=d) for d in (dev, "cpu")],
            "recognition ST-GCN": [STGCNA2MEvaluation(device=d) for d in (dev, "cpu")],
            "MoDi ST-GCN": [UnconstrainedEvaluator(device=d) for d in (dev, "cpu")],
        }

        def features(name, ev):
            if name == "MoDi ST-GCN":
                return ev.compute_features(modi_in)[0]
            return ev.compute_features(batches, with_labels=False)[0]

        def module_features(name, ev):
            """The classifier module called directly, without the eval's guard."""
            with torch.no_grad():
                if name == "MoDi ST-GCN":
                    x = torch.as_tensor(modi_in.transpose(0, 2, 3, 1).copy(), device=dev)
                    return ev.model(x, return_features=True)[1].cpu().numpy()
                if name == "GRU":
                    return np.concatenate([ev.classifier(
                        torch.as_tensor(b["output_xyz"], device=dev),
                        torch.as_tensor(b["lengths"], device=dev))[1].cpu().numpy()
                        for b in batches])
                return np.concatenate([ev.model(
                    torch.as_tensor(b["output_rot"], device=dev).permute(0, 2, 3, 1),
                    return_features=True)[1].cpu().numpy() for b in batches])

        feat_errs, clf_ms = {}, {}
        for name, (ev, ev_cpu) in evaluations.items():
            want_f = features(name, ev_cpu)
            scale = np.abs(want_f).max()
            feat_errs[name] = float(np.abs(features(name, ev) - want_f).max() / scale)
            tf32_err = float(np.abs(module_features(name, ev) - want_f).max() / scale)
            one = (lambda: ev.compute_features(modi_in[:MB])) if name == "MoDi ST-GCN" else (
                lambda: ev.forward(batches[0]))
            clf_ms[name] = cuda_time_ms(one, 20, 3)
            report(f"a2m eval: {name} features on the card vs the CPU ({len(want_f)} samples, "
                   f"{want_f.shape[1]} features, the eval's TF32 guard; max|f| {scale:.3f})",
                   feat_errs[name], TOL_EVAL_FEATS, bool(np.isfinite(want_f).all()))
            # the control: without the guard the same check must fail
            caught = tf32_err > TOL_EVAL_FEATS
            log(f"{'OK' if caught else 'FAIL'} control: the {name} module with cuDNN's TF32 on "
                f"vs the CPU: max|diff| {tf32_err:.3e} of max|f| (tol {TOL_EVAL_FEATS:g}): "
                f"{'FAIL, as it must' if caught else 'passes: the check cannot see the fault'}")
            if not caught:
                raise AssertionError(f"TOL_EVAL_FEATS does not separate the {name} with "
                                     "cuDNN's TF32 on")
        log(f"time a2m eval classifiers, one batch of {MB} (host copies included): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in clf_ms.items()) + f" {card}")

        # ---- the gt metrics, card against CPU ------------------------------------ #
        uestc = UESTC(roots["uestc"], num_frames=NUM_FRAMES, pose_rep="rot6d", split="test")
        u_order = uestc.rng.getstate()  # the items' frame windows, alike on both
        u_gt = make_gt_batches(fk_fn, uestc, MB, MB, NUM_FRAMES, device=dev)
        uestc.rng.setstate(u_order)
        u_gt_cpu = make_gt_batches(make_fk_fn(load_smpl_pickle(smpl_path)), uestc, MB, MB,
                                   NUM_FRAMES, device="cpu")
        for name, (on_card, on_cpu) in (("GRU", (gt, gt_cpu)),
                                        ("recognition ST-GCN", (u_gt, u_gt_cpu))):
            ev, ev_cpu = evaluations[name]
            np.random.seed(0)
            m = ev.evaluate({"gt": on_card})
            np.random.seed(0)
            m_cpu = ev_cpu.evaluate({"gt": on_cpu})
            gap = max(abs(m[k] - v) / max(1.0, abs(v)) for k, v in m_cpu.items())
            report(f"a2m eval: gt metrics of the {name} on the card vs the CPU ({MB} samples, "
                   f"SMPL and the classifier on each; {m})", gap, TOL_EVAL_FEATS)

        # ---- kernel 1 at the eval's shape ---------------------------------------- #
        w = layer_weights(randn, T2M_D, FF)
        x1 = randn(MB, rows, T2M_D)
        got_x = fused_encoder_layer(x1, *w, num_heads=HEADS)
        enc_err = (got_x - encoder_layer_plain(x1, *w, num_heads=HEADS)).abs().max().item()
        report(f"encoder_layer [{MB},{rows},{T2M_D}] heads {HEADS} of {dh} ff {FF}", enc_err,
               TOL_ENCODER, got_x.shape == x1.shape)
        ms = cuda_time_ms(lambda: fused_encoder_layer(x1, *w, num_heads=HEADS), 50, 5)
        plain_ms = cuda_time_ms(lambda: encoder_layer_plain(x1, *w, num_heads=HEADS), 20, 3)
        lib_ms = cuda_time_ms(lambda: encoder_layer_sdpa(x1, *w, HEADS), 20, 3)
        m_rows = MB * rows
        flops = 2 * m_rows * (4 * T2M_D * T2M_D + 2 * T2M_D * FF) + 4 * MB * rows**2 * T2M_D
        nbytes = 4 * (2 * m_rows * T2M_D + sum(t.numel() for t in w))
        bound, by = bound_ms(flops, nbytes, tf32x3=True)
        time_line(f"encoder_layer [{MB},{rows},{T2M_D}] heads {HEADS} of {dh}", ms, plain_ms,
                  lib_ms, bound, by, flops, nbytes, card, tf32x3=True)

        # ---- the train CLI's eval hook ------------------------------------------- #
        n_evals = sum(1 for s in range(CLI_STEPS) if s > 0 and s % 10 == 0)
        hook = {}
        for name, data_dir, flags, per_eval in (
                ("humanact12", roots["humanact12"],
                 ["--latent_dim", str(T2M_D), "--num_frames", str(A2M_FRAMES), *RECIPE],
                 {"encoder_layer": LAYERS * steps, "flash_attention": LAYERS * steps,
                  "local_block": 0}),
                ("genea2023", os.path.join(HERE, "build", "chip_smoke", "genea2023"),
                 ["--num_frames", str(T_CLI)],
                 {"encoder_layer": LAYERS, "flash_attention": LAYERS, "local_block": 1})):
            save_dir = os.path.join(base, f"run_hook_{name}")
            shutil.rmtree(save_dir, ignore_errors=True)  # progress.json appends
            t0 = time.perf_counter()
            loop, launches = counted(lambda: train_mdm.main([
                "--dataset", name, "--data_dir", data_dir, "--save_dir", save_dir, "--overwrite",
                "--batch_size", str(MB), "--use_fused_train_encoder", "--num_steps",
                str(CLI_STEPS), "--log_interval", "10", "--save_interval", "10",
                "--eval_during_training", "--eval_num_samples", str(MB), "--eval_batch_size",
                str(MB), "--eval_rep_times", "1", *flags]))
            cli_s = time.perf_counter() - t0
            with open(os.path.join(save_dir, "progress.json")) as f:
                evals = [r for r in map(json.loads, f) if "eval/wall_s" in r]
            key = "eval/fid_gen" if name == "humanact12" else "eval/val_loss"
            want = {k: n_evals * v for k, v in per_eval.items()}
            ok = (len(evals) == n_evals and all(math.isfinite(r.get(key, math.nan)) for r in evals)
                  and all(launches[k] == v for k, v in want.items())
                  and launches["encoder_layer_train_fwd"] == LAYERS * CLI_STEPS)
            hook[name] = launches
            log(f"{'OK' if ok else 'FAIL'} train CLI --dataset {name} --eval_during_training "
                f"--save_interval 10 ({CLI_STEPS} steps, {len(evals)} evals, expected {n_evals}): "
                f"{key} {[r.get(key) for r in evals]}, eval wall "
                f"{[round(r['eval/wall_s'], 3) for r in evals]} s, CLI {cli_s:.1f} s; launches "
                f"{launches} (the eval's expected {want}) {card}")
            if not ok:
                raise AssertionError(f"the {name} train CLI's eval hook misfired")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = smoke_tf32

    row = {"name": f"encoder_layer_a2m_eval_{MB}x{rows}x{T2M_D}", "route": "cuda",
           "source": "gesturediffusion_tpu_torch/csrc/encoder_layer.cu",
           "replaces": "gesturediffusion_tpu/ops/pallas_encoder.py:98",
           "launches": eval_launches["encoder_layer"] + hook["humanact12"]["encoder_layer"],
           "max_abs_err": enc_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by, "library_ms": lib_ms}
    # the main paths' launches (the CLIs and the hooks; not the comparisons), and seed 0's
    # generated and ground-truth batches, which phase 19 scores again
    a2m_train, gesture = (uncon, hook["humanact12"]), hook["genea2023"]
    return row, {"batches": {"gen": gen[0], "gt": gt[0]},
        "encoder_layer": gesture["encoder_layer"], "local_block": gesture["local_block"],
        "flash_attention": (eval_launches["flash_attention"]
                            + hook["humanact12"]["flash_attention"] + gesture["flash_attention"]),
        **{f"a2m_{k}": sum(c[k] for c in a2m_train)
           for k in ("encoder_layer_train_fwd", "encoder_layer_train_bwd")},
        **{k: gesture[k] for k in ("encoder_layer_train_fwd", "encoder_layer_train_bwd")}}


def t2m_eval_phase(randn, card):
    """Phase 15: the text-to-motion benchmark on the card, with PyTorch's
    TF32 defaults back on (cuDNN's TF32 on; restored at the end).  The eval
    CLI --eval_mode debug at --guidance_param 2.5 on phase 12's humanml
    checkpoint over the test split of its tree (5 replications of 2
    batches of 32: kernels 1 and 4 at CFG batch 64 launched 8 x 1000 a
    batch; the mean of every metric finite, the wall time); one generated
    batch (CFG 64, 1000 DDPM steps) against the plain path under TOL_TAKE,
    its ms a denoise step; the T2M evaluators' text and motion embeddings
    on the card against the CPU under TOL_EVAL_FEATS (the modules called
    without the eval's guard, cuDNN's TF32 on, are a control the check must
    fail) and the ground truth's metrics card against CPU under the same
    tolerance, the evaluators' ms a batch of 32; kernel 1 at [64, 197, 512]
    and [32, 197, 512] and its times; the train CLI --dataset humanml
    --eval_during_training (the benchmark at scale 1 after the save at step
    10: kernel 1 at [32, 197, 512]).  Returns the kernel row of
    [32, 197, 512] and the launches of the phase's main paths by kernel."""
    import shutil

    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.data.humanml import HashVectorizer, Text2MotionDatasetV2
    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample_loop
    from gesturediffusion_tpu_torch.eval import eval_humanml
    from gesturediffusion_tpu_torch.eval.eval_humanml import (
        BATCH_SIZE,
        EVAL_MODES,
        GeneratedMotionSet,
        GroundTruthMotionSet,
        evaluate_diversity,
        evaluate_fid,
        evaluate_matching_score,
        load_eval_renorm,
    )
    from gesturediffusion_tpu_torch.eval.evaluator_wrapper import EvaluatorWrapper
    from gesturediffusion_tpu_torch.models.cfg import classifier_free_guidance
    from gesturediffusion_tpu_torch.ops.flash_attention import fused_self_attention
    from gesturediffusion_tpu_torch.ops.fused_encoder import (
        encoder_layer_plain,
        fused_encoder_layer,
    )
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
    )
    from gesturediffusion_tpu_torch.train import train_mdm
    from gesturediffusion_tpu_torch.utils.convert import load_checkpoint
    from gesturediffusion_tpu_torch.utils.model_factory import create_model_and_diffusion
    from gesturediffusion_tpu_torch.utils.parser import evaluation_args
    from gesturediffusion_tpu_torch.utils.text_embedder import get_text_encoder

    dev = torch.device("cuda")
    counted, _ = launch_counter({
        "encoder_layer": fused_encoder_layer, "flash_attention": fused_self_attention,
        "encoder_layer_train_fwd": encoder_layer_train_fwd,
        "encoder_layer_train_bwd": encoder_layer_train_bwd})
    rows, dh = T2M_FRAMES + 1, T2M_D // HEADS
    base = os.path.join(HERE, "build", "chip_smoke", "t2m_train")  # phase 12's
    root = os.path.join(base, "humanml")
    ckpt = os.path.join(base, "run", f"model{CLI_STEPS:09d}.pt")
    args = evaluation_args(["--model_path", ckpt, "--guidance_param", str(GUIDANCE)])
    steps = args.diffusion_steps
    debug = EVAL_MODES["debug"]
    split = Text2MotionDatasetV2(root, split="test")
    per_rep = min(len(split), debug["num_samples_limit"]) // BATCH_SIZE  # generated batches

    smoke_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    log(f"t2m-eval: PyTorch's TF32 defaults for the phase: matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")
    try:
        # ---- the eval CLI in debug mode ----------------------------------------- #
        argv = ["--model_path", ckpt, "--eval_mode", "debug", "--guidance_param", str(GUIDANCE)]
        t0 = time.perf_counter()
        means, cli_launches = counted(lambda: eval_humanml.main(argv))
        wall = time.perf_counter() - t0
        chains = debug["replication_times"] * per_rep
        want = LAYERS * steps * chains
        keys = {f"{m}_{k}" for m in ("Matching Score", "R_precision", "FID", "Diversity")
                for k in ("ground truth", "vald")}
        ok = (set(means) == keys and all(np.isfinite(np.asarray(v)).all() for v in means.values())
              and cli_launches["encoder_layer"] == want and cli_launches["flash_attention"] == want)
        log(f"{'OK' if ok else 'FAIL'} eval_humanml CLI --eval_mode debug --guidance_param "
            f"{GUIDANCE}: {len(means)} means, {wall:.1f} s wall for {chains} generated batches of "
            f"{BATCH_SIZE} (CFG batch {2 * BATCH_SIZE}), {BATCH_SIZE * chains / wall:.2f} "
            f"generated samples/s of CLI wall time; launches {cli_launches['encoder_layer']} / "
            f"{cli_launches['flash_attention']} (expected {want} each: {LAYERS} x {steps} steps x "
            f"{chains} batches); FID_vald {means.get('FID_vald')}, R_precision_vald "
            f"{means.get('R_precision_vald')}, Diversity_ground truth "
            f"{means.get('Diversity_ground truth')} {card}")
        if not ok:
            raise AssertionError(f"the eval_humanml CLI wrote the wrong metrics or missed its "
                                 f"kernels: {means}")

        # ---- one generated batch against the plain path ------------------------- #
        ds = Text2MotionDatasetV2(root, split="test", w_vectorizer=HashVectorizer())
        model, diffusion = create_model_and_diffusion(args, ds, dev)
        model.load_state_dict(load_checkpoint(ckpt))
        model.to(dev).eval()
        model_fn = classifier_free_guidance(model, args.cond_mask_prob)
        text_encoder = get_text_encoder(device=dev)
        shape = (BATCH_SIZE, ds.pose_dim, 1, T2M_FRAMES)

        def sample_fn(generator, cond):
            return p_sample_loop(diffusion, model_fn, shape, cond, generator=generator,
                                 clip_denoised=False)

        order = ds.rng.getstate()

        def generated(renorm=None):
            ds.rng.setstate(order)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = GeneratedMotionSet(sample_fn, ds, text_encoder=text_encoder, scale=GUIDANCE,
                                     renorm=renorm, seed=0, num_samples_limit=BATCH_SIZE,
                                     device=dev)
            torch.cuda.synchronize()
            return gen.batches[0], time.perf_counter() - t0

        (gen, kernel_s), launches = counted(generated)
        model.use_kernels = False
        gen_plain, plain_s = generated()
        model.use_kernels = True
        want = {"encoder_layer": LAYERS * steps, "flash_attention": LAYERS * steps,
                "encoder_layer_train_fwd": 0, "encoder_layer_train_bwd": 0}
        err = float(np.abs(gen["motions"] - gen_plain["motions"]).max())
        report(f"t2m eval: a generated batch ({BATCH_SIZE} captions, CFG batch "
               f"{2 * BATCH_SIZE} at {GUIDANCE}, DDPM {steps} steps, [{2 * BATCH_SIZE},{rows},"
               f"{T2M_D}]) vs the plain path on the card; launches {launches} (expected {want}) "
               f"(|sample| max {np.abs(gen_plain['motions']).max():.3f})", err, TOL_TAKE,
               launches == want and np.isfinite(gen["motions"]).all())
        log(f"time t2m eval sampling (a batch of {BATCH_SIZE}, CFG {2 * BATCH_SIZE}, {steps} "
            f"DDPM steps, CLIP captions included): kernels {kernel_s:.3f} s = "
            f"{BATCH_SIZE / kernel_s:.2f} samples/s, {kernel_s / steps * 1e3:.4f} ms a CFG-"
            f"{2 * BATCH_SIZE} denoise step; plain {plain_s:.3f} s, "
            f"{plain_s / steps * 1e3:.4f} ms a step {card}")

        # ---- the evaluators' embeddings, card against CPU ----------------------- #
        renorm = load_eval_renorm(ds, log)
        ds.rng.setstate(order)
        gt = list(GroundTruthMotionSet(ds, renorm=renorm))
        ds.rng.setstate(order)
        gen_renormed = generated(renorm)[0]
        batches = [*gt, gen_renormed]
        ev, ev_cpu = (EvaluatorWrapper("humanml", dim_pose=ds.pose_dim, device=d)
                      for d in (dev, "cpu"))

        def embeddings(w):
            text, motion = zip(*(w.get_co_embeddings(b["word_embs"], b["pos_ohot"], b["cap_lens"],
                                                     b["motions"], b["m_lens"]) for b in batches))
            kept = [w.get_motion_embeddings(b["motions"], b["m_lens"], keep_order=True)
                    for b in batches]
            return {"text": np.concatenate(text), "motion": np.concatenate(motion),
                    "motion, input order": np.concatenate(kept)}

        def module_embeddings(w, device):
            """The three modules called directly, without the eval's guard."""
            out = {"text": [], "motion, input order": []}
            with torch.no_grad():
                for b in batches:
                    motions, word_embs, pos_ohot = (
                        torch.as_tensor(b[k], dtype=torch.float32, device=device)
                        for k in ("motions", "word_embs", "pos_ohot"))
                    movements = w.movement_encoder(motions[..., :-4])
                    out["motion, input order"].append(w.motion_encoder(
                        movements, b["m_lens"] // w.UNIT_LENGTH).cpu().numpy())
                    out["text"].append(w.text_encoder(word_embs, pos_ohot, b["cap_lens"])
                                       .cpu().numpy())
            return {k: np.concatenate(v) for k, v in out.items()}

        want_e, got_e = embeddings(ev_cpu), embeddings(ev)
        control, control_cpu = module_embeddings(ev, dev), module_embeddings(ev_cpu, "cpu")
        n = sum(len(b["m_lens"]) for b in batches)
        for name, want_f in want_e.items():
            scale = np.abs(want_f).max()
            report(f"t2m eval: {name} embeddings on the card vs the CPU ({n} samples, "
                   f"{want_f.shape[1]} features, the eval's TF32 guard; max|f| {scale:.3f})",
                   float(np.abs(got_e[name] - want_f).max() / scale), TOL_EVAL_FEATS,
                   bool(np.isfinite(want_f).all()))
        for name, want_f in control_cpu.items():
            tf32_err = float(np.abs(control[name] - want_f).max() / np.abs(want_f).max())
            caught = tf32_err > TOL_EVAL_FEATS
            log(f"{'OK' if caught else 'FAIL'} control: the {name} modules with cuDNN's TF32 on "
                f"vs the CPU: max|diff| {tf32_err:.3e} of max|f| (tol {TOL_EVAL_FEATS:g}): "
                f"{'FAIL, as it must' if caught else 'passes: the check cannot see the fault'}")
            if not caught:
                raise AssertionError(f"TOL_EVAL_FEATS does not separate the {name} modules with "
                                     "cuDNN's TF32 on")
        b0 = batches[0]
        co_ms = cuda_time_ms(lambda: ev.get_co_embeddings(
            b0["word_embs"], b0["pos_ohot"], b0["cap_lens"], b0["motions"], b0["m_lens"]), 20, 3)
        motion_ms = cuda_time_ms(lambda: ev.get_motion_embeddings(b0["motions"], b0["m_lens"]),
                                 20, 3)
        log(f"time t2m evaluators, one batch of {BATCH_SIZE} (host copies included): "
            f"co-embeddings {co_ms:.4f} ms, motion embeddings {motion_ms:.4f} ms {card}")

        # ---- the ground truth's metrics, card against CPU ----------------------- #
        metrics = []
        for w in (ev, ev_cpu):
            np.random.seed(0)
            match, rprec, acti = evaluate_matching_score(w, {"ground truth": gt}, lambda *a: None)
            fid = evaluate_fid(w, gt, acti, lambda *a: None)
            div = evaluate_diversity(acti, 300, lambda *a: None)
            metrics.append({"Matching Score": match["ground truth"], "FID": fid["ground truth"],
                            "Diversity": div["ground truth"],
                            **{f"R_precision top {i + 1}": v
                               for i, v in enumerate(rprec["ground truth"])}})
        gap = max(abs(metrics[0][k] - v) / max(1.0, abs(v)) for k, v in metrics[1].items())
        report(f"t2m eval: the ground truth's metrics on the card vs the CPU ({len(gt)} batches "
               f"of {BATCH_SIZE}; {metrics[0]})", gap, TOL_EVAL_FEATS)

        # ---- kernel 1 at the benchmark's two shapes ----------------------------- #
        w = layer_weights(randn, T2M_D, FF)
        out_rows = {}
        for b in (2 * BATCH_SIZE, BATCH_SIZE):
            x1 = randn(b, rows, T2M_D)
            got_x = fused_encoder_layer(x1, *w, num_heads=HEADS)
            enc_err = (got_x - encoder_layer_plain(x1, *w, num_heads=HEADS)).abs().max().item()
            report(f"encoder_layer [{b},{rows},{T2M_D}] heads {HEADS} of {dh} ff {FF}", enc_err,
                   TOL_ENCODER, got_x.shape == x1.shape)
            ms = cuda_time_ms(lambda: fused_encoder_layer(x1, *w, num_heads=HEADS), 50, 5)
            plain_ms = cuda_time_ms(lambda: encoder_layer_plain(x1, *w, num_heads=HEADS), 20, 3)
            lib_ms = cuda_time_ms(lambda: encoder_layer_sdpa(x1, *w, HEADS), 20, 3)
            m_rows = b * rows
            flops = 2 * m_rows * (4 * T2M_D * T2M_D + 2 * T2M_D * FF) + 4 * b * rows**2 * T2M_D
            nbytes = 4 * (2 * m_rows * T2M_D + sum(t.numel() for t in w))
            bound, by = bound_ms(flops, nbytes, tf32x3=True)
            time_line(f"encoder_layer [{b},{rows},{T2M_D}] heads {HEADS} of {dh} (t2m eval)", ms,
                      plain_ms, lib_ms, bound, by, flops, nbytes, card, tf32x3=True)
            out_rows[b] = {"max_abs_err": enc_err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}

        # ---- the train CLI's eval hook on humanml -------------------------------- #
        n_evals = sum(1 for s in range(CLI_STEPS) if s > 0 and s % 10 == 0)
        hook_n = EVAL_HOOK_SAMPLES // BATCH_SIZE  # generated batches an eval
        save_dir = os.path.join(base, "run_hook")
        shutil.rmtree(save_dir, ignore_errors=True)  # progress.json appends
        t0 = time.perf_counter()
        loop, hook = counted(lambda: train_mdm.main([
            "--dataset", "humanml", "--data_dir", root, "--save_dir", save_dir, "--overwrite",
            "--latent_dim", str(T2M_D), "--batch_size", str(MB), "--use_fused_train_encoder",
            "--num_steps", str(CLI_STEPS), "--log_interval", "10", "--save_interval", "10",
            "--eval_during_training", "--eval_num_samples", str(EVAL_HOOK_SAMPLES),
            "--eval_rep_times", "1"]))
        cli_s = time.perf_counter() - t0
        with open(os.path.join(save_dir, "progress.json")) as f:
            evals = [r for r in map(json.loads, f) if "eval/wall_s" in r]
        hook_steps = loop.diffusion.num_timesteps
        want = {"encoder_layer": n_evals * hook_n * LAYERS * hook_steps,
                "flash_attention": n_evals * hook_n * LAYERS * hook_steps,
                "encoder_layer_train_fwd": LAYERS * CLI_STEPS,
                "encoder_layer_train_bwd": LAYERS * CLI_STEPS}
        ok = (len(evals) == n_evals and hook == want
              and all(math.isfinite(r.get("eval/FID_vald", math.nan)) for r in evals))
        log(f"{'OK' if ok else 'FAIL'} train CLI --dataset humanml --eval_during_training "
            f"--eval_num_samples {EVAL_HOOK_SAMPLES} --eval_rep_times 1 ({CLI_STEPS} steps, "
            f"{len(evals)} evals, expected {n_evals}): eval/FID_vald "
            f"{[r.get('eval/FID_vald') for r in evals]}, eval/R_precision_vald_top3 "
            f"{[r.get('eval/R_precision_vald_top3') for r in evals]}, eval wall "
            f"{[round(r['eval/wall_s'], 3) for r in evals]} s, CLI {cli_s:.1f} s; launches "
            f"{hook} (expected {want}) {card}")
        if not ok:
            raise AssertionError("the humanml train CLI's eval hook misfired")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = smoke_tf32

    row = {"name": f"encoder_layer_t2m_eval_{BATCH_SIZE}x{rows}x{T2M_D}", "route": "cuda",
           "source": "gesturediffusion_tpu_torch/csrc/encoder_layer.cu",
           "replaces": "gesturediffusion_tpu/ops/pallas_encoder.py:98",
           "launches": hook["encoder_layer"], **out_rows[BATCH_SIZE]}
    # the main paths' launches (the CLIs and the hook; not the comparisons): kernel 1 and
    # flash at CFG batch 64 (the eval CLI), flash at 32 (the hook), the hook's training
    return row, {"encoder_layer_64": cli_launches["encoder_layer"],
                 "flash_attention_64": cli_launches["flash_attention"],
                 "flash_attention": hook["flash_attention"],
                 **{k: hook[k] for k in ("encoder_layer_train_fwd", "encoder_layer_train_bwd")}}


def mesh_phase(card):
    """Phase 16: the mesh export on the card.  The predict CLI on phase 12's
    humanml-encoder-512 checkpoint at MESH_REPS repetitions of MESH_SECONDS
    (120 frames; CFG batch 6, kernels 1 and 4 counted 8 x 1000); the
    render-mesh CLI (viz.vis_utils) on sample 0 with phase 13's synthetic
    SMPL at 6890 vertices given MESH_FACES triangles and the synthetic GMM
    as GMM_PRIOR_PATH (150 Adam steps a stage): 120 OBJs of 6890 vertices
    and their faces, smpl_params.npy, stage 2's keypoint error below stage
    1's; the joints2smpl CLI's _rot.npy and motions2hik's JSON for the three
    repetitions; the fit card against CPU, teacher-forced (the stage-2
    objective and its gradient where stage 2 starts under TOL_FIT_GRAD; where
    the fit ends, beside float32's floor) and free-running (the final keypoint error under TOL_FIT_FREE, a CPU fit
    from a target nudged by one ulp beside it as float32's floor, max
    |dtheta| of both); ms per iteration of each stage, the fit's and the
    CLIs' wall times, and the launches and idle share of one profiled
    iteration of each stage.  Returns the predict CLI's launches."""
    import pickle

    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.models.smpl import load_smpl_pickle
    from gesturediffusion_tpu_torch.ops.flash_attention import fused_self_attention
    from gesturediffusion_tpu_torch.ops.fused_encoder import fused_encoder_layer
    from gesturediffusion_tpu_torch.sample import predict
    from gesturediffusion_tpu_torch.utils.device import full_f32
    from gesturediffusion_tpu_torch.viz import joints2smpl as j2s
    from gesturediffusion_tpu_torch.viz import vis_utils
    from gesturediffusion_tpu_torch.viz.motions2hik import HIK_JOINT_MAP, motions2hik
    from gesturediffusion_tpu_torch.viz.prior import load_gmm_prior, make_synthetic_gmm

    dev = torch.device("cuda")
    counted, _ = launch_counter({"encoder_layer": fused_encoder_layer,
                                 "flash_attention": fused_self_attention})
    base = os.path.join(HERE, "build", "chip_smoke", "mesh")
    os.makedirs(base, exist_ok=True)
    ckpt = os.path.join(HERE, "build", "chip_smoke", "t2m_train", "run",
                        f"model{CLI_STEPS:09d}.pt")  # phase 12's

    # ---- predict: the joints the fit consumes --------------------------------- #
    out_dir = os.path.join(base, "predict")
    t0 = time.perf_counter()
    _, launches = counted(lambda: predict.main([
        "--model_path", ckpt, "--text", PROMPT, "--num_repetitions", str(MESH_REPS),
        "--motion_length", str(MESH_SECONDS), "--output_dir", out_dir]))
    predict_s = time.perf_counter() - t0
    npy = os.path.join(out_dir, "results.npy")
    res = np.load(npy, allow_pickle=True).item()
    motions = res["motion"]  # [R, 22, 3, T]
    want = {"encoder_layer": 1000 * LAYERS, "flash_attention": 1000 * LAYERS}
    ok = (motions.shape == (MESH_REPS, 22, 3, MESH_FRAMES) and np.isfinite(motions).all()
          and launches == want)
    log(f"{'OK' if ok else 'FAIL'} mesh: predict CLI on phase 12's checkpoint (1000 DDPM steps, "
        f"{MESH_REPS} repetitions of {MESH_SECONDS} s, CFG batch {2 * MESH_REPS}): motion "
        f"{motions.shape} in {predict_s:.1f} s; launches {launches} (expected {want}) {card}")
    if not ok:
        raise AssertionError("the predict CLI of the mesh phase failed")

    # ---- the assets: SMPL with triangles, the synthetic GMM -------------------- #
    with open(os.environ["SMPL_MODEL_PATH"], "rb") as f:  # phase 13's, 6890 vertices
        smpl_data = pickle.load(f)
    smpl_data["f"] = np.random.RandomState(16).randint(
        0, A2M_VERTS, (MESH_FACES, 3)).astype(np.uint32)
    smpl_path = os.path.join(base, "smpl_faces.pkl")
    with open(smpl_path, "wb") as f:
        pickle.dump(smpl_data, f)
    gmm_path = os.path.join(base, "gmm_08.pkl")
    with open(gmm_path, "wb") as f:
        pickle.dump(make_synthetic_gmm(), f)
    os.environ["GMM_PRIOR_PATH"] = gmm_path

    # ---- the render-mesh CLI on sample 0 -------------------------------------- #
    t0 = time.perf_counter()
    conv = vis_utils.main(["--input_path", npy, "--sample_idx", "0", "--smpl_model", smpl_path])
    render_s = time.perf_counter() - t0
    obj_dir = npy[: -len(".npy")] + "_obj"
    objs = sorted(f for f in os.listdir(obj_dir) if f.endswith(".obj"))
    counts, finite = set(), True
    for name in objs:
        with open(os.path.join(obj_dir, name)) as f:
            text = f.read()
        lines = text.splitlines()
        counts.add((sum(ln.startswith("v ") for ln in lines),
                    sum(ln.startswith("f ") for ln in lines)))
        finite = finite and "nan" not in text and "inf" not in text
    params = np.load(os.path.join(obj_dir, "smpl_params.npy"), allow_pickle=True).item()
    loss1, loss2 = conv.fit["loss"]
    ok = (len(objs) == MESH_FRAMES and counts == {(A2M_VERTS, MESH_FACES)} and finite
          and params["vertices"].shape == (MESH_FRAMES, A2M_VERTS, 3)
          and all(np.isfinite(params[k]).all()
                  for k in ("vertices", "thetas", "root_translation"))
          and loss2 < loss1)
    log(f"{'OK' if ok else 'FAIL'} mesh: render-mesh CLI ({MESH_ITERS} Adam steps a stage, "
        f"{A2M_VERTS} vertices, {MESH_FACES} faces, the synthetic GMM): {len(objs)} OBJs of "
        f"(v, f) lines {sorted(counts)}, finite {finite}, smpl_params.npy vertices "
        f"{params['vertices'].shape}; keypoint error stage 1 {loss1:.6e} -> stage 2 "
        f"{loss2:.6e}; {render_s:.2f} s wall (the fit, the vertices, {len(objs)} OBJ files) "
        f"{card}")
    if not ok:
        raise AssertionError("the render-mesh CLI wrote the wrong meshes")

    # ---- the joints2smpl CLI (_rot.npy) and HumanIK --------------------------- #
    t0 = time.perf_counter()
    (rot_path,) = j2s.main(["--input_path", npy, "--smpl_model", smpl_path])
    rot_s = time.perf_counter() - t0
    rot = np.load(rot_path, allow_pickle=True).item()["motion"]
    ok = (rot.shape == (MESH_REPS, 25, 6, MESH_FRAMES) and np.isfinite(rot).all()
          and np.array_equal(rot[:, 24, :3], motions[:, 0]) and not rot[:, 24, 3:].any())
    log(f"{'OK' if ok else 'FAIL'} mesh: joints2smpl CLI -> {os.path.basename(rot_path)} "
        f"{rot.shape} (rot6d rows, the root's xyz in row 24), {MESH_REPS} fits in "
        f"{rot_s:.2f} s wall {card}")
    if not ok:
        raise AssertionError("the joints2smpl CLI wrote the wrong _rot.npy")
    smpl = load_smpl_pickle(smpl_path)
    t0 = time.perf_counter()
    hik = motions2hik(motions, smpl, device=dev)
    hik_s = time.perf_counter() - t0
    frames = hik["frames"]
    ok = (hik["num_repetitions"] == MESH_REPS and hik["num_frames"] == MESH_FRAMES
          and len(frames) == MESH_REPS and all(len(r) == MESH_FRAMES for r in frames)
          and all(sorted(fr) == sorted(HIK_JOINT_MAP + ["HipsTranslation"])
                  for r in frames for fr in r)
          and np.isfinite([v for r in frames for fr in r for x in fr.values() for v in x]).all())
    log(f"{'OK' if ok else 'FAIL'} mesh: motions2hik JSON, {MESH_REPS} repetitions x "
        f"{MESH_FRAMES} frames x {len(HIK_JOINT_MAP)} joints + HipsTranslation "
        f"({len(json.dumps(hik))} bytes) in {hik_s:.2f} s {card}")
    if not ok:
        raise AssertionError("motions2hik produced the wrong structure")

    # ---- the fit card against CPU --------------------------------------------- #
    prior = load_gmm_prior(gmm_path)
    joints = motions[0].transpose(2, 0, 1)  # [T, 22, 3]

    def fit_on(device, target_joints):
        model = load_smpl_pickle(smpl_path).to(device)
        dprior = prior.to(device)
        target, subset, conf = j2s.fit_inputs(target_joints, device)
        pose, transl = j2s.initial_params(model, target)
        times, states = [], []
        for fit_pose in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pose, transl, err = j2s.fit_stage(model, target, subset, conf, pose, transl,
                                              fit_pose=fit_pose, num_iters=MESH_ITERS,
                                              pose_prior=dprior)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            states.append((pose, transl, float(err)))
        return dict(model=model, prior=dprior, inputs=(target, subset, conf), times=times,
                    states=states)

    t0 = time.perf_counter()
    card_fit = fit_on(dev, joints)
    card_wall = time.perf_counter() - t0
    cpu_fit = fit_on("cpu", joints)
    nudged_fit = fit_on("cpu", np.nextafter(joints, np.float32(np.inf)))

    def objective_and_grad(fit, pose, transl):
        pose = pose.detach().clone().requires_grad_(True)
        transl = transl.detach().clone().requires_grad_(True)
        with torch.enable_grad(), full_f32():
            value = j2s.stage_objective(fit["model"], pose, transl, *fit["inputs"],
                                        fit["prior"], True)
            value.backward()
        return float(value.detach()), pose.grad.cpu(), transl.grad.cpu()

    def grad_gap(got, want):
        gmax = max(want[1].abs().max().item(), want[2].abs().max().item())
        return max((got[1] - want[1]).abs().max().item(),
                   (got[2] - want[2]).abs().max().item()) / gmax, gmax

    # the gate: the stage-2 objective and its gradient where stage 2 starts
    pose, transl, _ = cpu_fit["states"][0]
    card_v = objective_and_grad(card_fit, pose.to(dev), transl.to(dev))
    cpu_v = objective_and_grad(cpu_fit, pose, transl)
    tf_gap, gmax = grad_gap(card_v, cpu_v)
    log(f"{'OK' if tf_gap <= TOL_FIT_GRAD else 'FAIL'} mesh: teacher-forced stage-2 objective at "
        f"the CPU fit's state where stage 2 starts, card vs CPU: objective {card_v[0]:.9e} vs "
        f"{cpu_v[0]:.9e} (rel {abs(card_v[0] - cpu_v[0]) / abs(cpu_v[0]):.3e}); gradient "
        f"max|diff| {tf_gap:.3e} of its max {gmax:.4e} (tol {TOL_FIT_GRAD:g})")
    if tf_gap > TOL_FIT_GRAD:
        raise AssertionError("the stage-2 objective's gradient on the card disagrees with the CPU")
    # where the fit ends the gradient is a small difference of large terms (the joint
    # loss against the priors): its gap is printed beside float32's floor there, the
    # CPU's gradient at the parameters nudged by one ulp
    pose, transl, _ = cpu_fit["states"][1]
    cpu_e = objective_and_grad(cpu_fit, pose, transl)
    end_gap, end_max = grad_gap(objective_and_grad(card_fit, pose.to(dev), transl.to(dev)), cpu_e)
    end_floor, _ = grad_gap(objective_and_grad(
        cpu_fit, *(torch.nextafter(x, torch.full_like(x, math.inf)) for x in (pose, transl))),
        cpu_e)
    log(f"mesh: teacher-forced stage-2 gradient at the CPU fit's end state, card vs CPU "
        f"{end_gap:.3e} of its max {end_max:.4e} (the start's max {gmax:.4e}); float32's floor "
        f"there (the CPU at parameters nudged by one ulp) {end_floor:.3e}")

    def final(fit):
        pose, transl, err = fit["states"][1]
        return pose.cpu(), transl.cpu(), err

    (p_card, t_card, e_card), (p_cpu, t_cpu, e_cpu), (p_nud, _, e_nud) = (
        final(card_fit), final(cpu_fit), final(nudged_fit))
    free_gap = abs(e_card - e_cpu) / e_cpu
    floor_gap = abs(e_nud - e_cpu) / e_cpu
    ok = free_gap <= TOL_FIT_FREE
    log(f"{'OK' if ok else 'FAIL'} mesh: free-running fit ({2 * MESH_ITERS} Adam steps, "
        f"T {MESH_FRAMES}), card vs CPU: final keypoint error {e_card:.6e} vs {e_cpu:.6e}, rel "
        f"{free_gap:.3e} (tol {TOL_FIT_FREE:g}), max|dtheta| "
        f"{(p_card - p_cpu).abs().max().item():.3e}, max|dtransl| "
        f"{(t_card - t_cpu).abs().max().item():.3e}; float32's floor (a CPU fit from the target "
        f"nudged by one ulp): rel {floor_gap:.3e}, max|dtheta| "
        f"{(p_nud - p_cpu).abs().max().item():.3e}")
    if not ok:
        raise AssertionError("the fit on the card parts from the CPU's past TOL_FIT_FREE")

    # ---- times: ms an iteration, launches, idle share ------------------------- #
    s1, s2 = card_fit["times"]
    log(f"time mesh fit at T {MESH_FRAMES} ({A2M_VERTS} vertices, the chain only): stage 1 "
        f"{s1 / MESH_ITERS * 1e3:.4f} ms/iteration, stage 2 {s2 / MESH_ITERS * 1e3:.4f} "
        f"ms/iteration, the fit {card_wall:.3f} s wall; the CPU's fit "
        f"{sum(cpu_fit['times']):.3f} s; CLIs: render-mesh {render_s:.2f} s, joints2smpl "
        f"({MESH_REPS} fits) {rot_s:.2f} s, motions2hik ({MESH_REPS} fits) {hik_s:.2f} s, "
        f"predict {predict_s:.2f} s {card}")
    target, subset, conf = card_fit["inputs"]
    for fit_pose, (pose0, transl0, _) in zip((False, True), ((
            *j2s.initial_params(card_fit["model"], target), None), card_fit["states"][0])):
        pose = pose0.detach().clone().requires_grad_(True)
        transl = transl0.detach().clone().requires_grad_(True)
        opt = torch.optim.Adam([pose, transl], lr=0.02)

        def iteration(pose=pose, transl=transl, opt=opt, fit_pose=fit_pose):
            with torch.enable_grad(), full_f32():
                opt.zero_grad(set_to_none=False)
                j2s.stage_objective(card_fit["model"], pose, transl, target, subset, conf,
                                    card_fit["prior"], fit_pose).backward()
                if not fit_pose:
                    pose.grad[:, 1:] = 0.0
                opt.step()

        device_profile(iteration, 10, f"SMPLify stage {2 if fit_pose else 1} iteration (T "
                       f"{MESH_FRAMES}, GMM prior)", card, host_rows=6)
    return launches


def wav_old_phase(fast_model, chunk_conds, init_seed, randn, card):
    """Phase 17: the last two gesture denoisers on the card.  MDMOld (MDM
    V1) at full width with seeded weights, written as a reference-layout V1
    ``.pt`` and read back through utils/convert.py:load_weights (the V2
    loader must refuse it), samples phase 4's 41-take, 2-chunk CFG take
    (kernel 1 counted 8 a step, no local block) against the plain take; the
    wav-encoder MDM at the gesture V2 width samples the same take from raw
    audio (80 x 735 samples a chunk: 59 frames of features, padded to 80;
    kernels 1 and 2 counted) against the plain take, and its wav encoder on
    the card against the CPU under its own float32 guard with PyTorch's
    TF32 default (cuDNN's on) outside it, the stack unguarded printed as a
    control; 5 wav-encoder
    train steps at batch 256 (4 x 64) through the training kernels against
    the plain steps, the BatchNorm running statistics compared after each;
    the train CLI --use_wav_enc --use_fused_train_encoder on --dataset
    synthetic (launches counted) and the generate CLI on its checkpoint;
    the times and profiles of a wav-encoder CFG denoise step (the conv
    stack's share), an MDMOld step and phase 4's fast-path step.  Returns
    the launches of the phase's main paths by kernel."""
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample
    from gesturediffusion_tpu_torch.models.mdm import MDM
    from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn
    from gesturediffusion_tpu_torch.models.mdm_old import MDMOld
    from gesturediffusion_tpu_torch.ops.flash_attention import fused_self_attention
    from gesturediffusion_tpu_torch.ops.fused_encoder import fused_encoder_layer
    from gesturediffusion_tpu_torch.ops.fused_local_block import fused_local_block
    from gesturediffusion_tpu_torch.train.loop import TrainConfig
    from gesturediffusion_tpu_torch.utils.convert import load_checkpoint, load_weights

    dev = torch.device("cuda")
    counted, total = launch_counter({"local_block": fused_local_block,
                                     "encoder_layer": fused_encoder_layer,
                                     "flash_attention": fused_self_attention})
    base = os.path.join(HERE, "build", "chip_smoke", "wav_old")
    os.makedirs(base, exist_ok=True)
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000,
                                 timestep_respacing=RESPACING, device=dev)
    scale = torch.full((CHUNKS, B_TAKES), GUIDANCE, device=dev)
    per_step = {"encoder_layer": STEPS * CHUNKS * LAYERS,
                "flash_attention": STEPS * CHUNKS * LAYERS}

    def take_vs_plain(model, conds, label, want):
        out, launches = counted(lambda: run_take(model, diffusion, conds, init_seed, 1, t=T))
        model.use_kernels = False
        out_plain = run_take(model, diffusion, conds, init_seed, 1, t=T)
        model.use_kernels = True
        ok = (launches == want and tuple(out.shape) == (CHUNKS, B_TAKES, J, 1, T)
              and bool(torch.isfinite(out).all()))
        report(f"{label} take ({B_TAKES} takes x {CHUNKS} chunks x {STEPS} DDPM steps, CFG "
               f"batch {2 * B_TAKES}) vs plain versions on the card; launches {launches} "
               f"(expected {want}; |out| max {out_plain.abs().max().item():.3f})",
               (out - out_plain).abs().max().item(), TOL_TAKE, ok)

    def step_fn(model, conds):
        """One CFG denoise step of ``model`` on chunk 0 of ``conds``."""
        precompute, model_fn = select_sampling_model_fn(model, GUIDANCE, 0.1)
        cond = {**{k: v[0] for k, v in conds.items()}, "seed": init_seed}
        cond = precompute(cond) if precompute is not None else cond
        x = torch.zeros((B_TAKES, J, 1, T), device=dev)
        noise = torch.randn_like(x)
        t = torch.full((B_TAKES,), diffusion.num_timesteps // 2, dtype=torch.long, device=dev)
        return lambda: p_sample(diffusion, model_fn, x, t, cond, noise)

    # ---- MDMOld: a reference-layout V1 file read back, then the take ------- #
    old_kw = dict(njoints=J, latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=HEADS,
                  cond_mask_prob=0.1, seed_poses=S, mfcc_dim=A)
    torch.manual_seed(17)
    v1_path = os.path.join(base, "model000000000.pt")
    torch.save(MDMOld(**old_kw).state_dict(), v1_path)
    old = load_weights(MDMOld(**old_kw), v1_path).to(dev).eval()
    try:
        load_weights(MDM(njoints=J, latent_dim=D, ff_size=FF, num_layers=LAYERS,
                         num_heads=HEADS, seed_poses=S, mfcc_dim=A), v1_path)
        refusal = "none"
    except ValueError as e:
        refusal = str(e)
    ok = "MDM V1" in refusal
    log(f"{'OK' if ok else 'FAIL'} a reference-layout V1 state dict "
        f"({len(load_checkpoint(v1_path))} tensors, no project_to_lat) loads onto MDMOld; the V2 "
        f"loader refuses it: {refusal[:90]}")
    if not ok:
        raise AssertionError("the V2 loader took a V1 state dict")
    old_conds = {"mfcc": chunk_conds["mfcc"], "scale": scale}
    take_vs_plain(old, old_conds, f"MDMOld (J {J} + MFCC {A}, D {D}, {LAYERS} layers)",
                  {"local_block": 0, **per_step})

    # ---- the wav-encoder MDM: the conv stack, the take ---------------------- #
    torch.manual_seed(18)
    wav = MDM(njoints=J, latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=HEADS,
              cond_mask_prob=0.1, seed_poses=S, cl_head=CL_HEADS, window_size=WINDOW,
              mfcc_input=False, use_wav_enc=True)
    with torch.no_grad():  # running statistics off their start, as a trained model's
        for bn in (m for m in wav.modules() if hasattr(m, "running_var")):
            bn.running_mean.normal_(0.0, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
    wav = wav.to(dev).eval()
    audio = randn(CHUNKS, B_TAKES, T * WAV_SPF, scale=0.3)
    wav_conds = {"audio": audio, "scale": scale}
    frames = wav.wav_encoder(audio[0]).shape[-1]
    ok = frames == WAV_FRAMES
    log(f"{'OK' if ok else 'FAIL'} the wav encoder gives {frames} frames for {T} x {WAV_SPF} "
        f"samples (expected {WAV_FRAMES}, zero-padded to {T})")
    if not ok:
        raise AssertionError("the wav encoder's frame count")
    take_vs_plain(wav, wav_conds, f"wav-encoder MDM (J {J}, D {D}, {LAYERS} layers, audio "
                  f"{T} x {WAV_SPF} samples)", {"local_block": STEPS * CHUNKS, **per_step})

    smoke_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default: the encoder's guard must hold
    try:
        enc_cpu = copy.deepcopy(wav.wav_encoder).cpu()
        a0 = audio[0]
        want = enc_cpu(a0.cpu())
        got = wav.wav_encoder(a0).cpu()
        unguarded = wav.wav_encoder.features(a0).cpu()
        still_on = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = smoke_tf32
    mx = want.abs().max().item()
    report(f"wav encoder [{B_TAKES},{T * WAV_SPF}]->[{B_TAKES},32,{WAV_FRAMES}] on the card vs the "
           f"CPU under its float32 guard, cuDNN's TF32 on outside it (max|f| {mx:.3f}; relative)",
           (got - want).abs().max().item() / mx, TOL_WAV, still_on)
    # the control, printed: cuDNN may or may not pick a TF32 algorithm for these
    # convolutions when allowed (on an H100 with torch 2.11 it did not: the same
    # max|diff| as under the guard), so it decides nothing
    tf32_err = (unguarded - want).abs().max().item() / mx
    same = torch.equal(unguarded, got)
    log(f"control: the conv stack with cuDNN's TF32 on, unguarded, vs the CPU: max|diff| "
        f"{tf32_err:.3e} of max|f| (tol {TOL_WAV:g}; "
        + ("bit for bit the guarded output: cuDNN ran it without TF32 here)" if same else
           f"{'over' if tf32_err > TOL_WAV else 'under'} the tolerance, "
           f"{'not ' if not tf32_err > TOL_WAV else ''}separated by it)"))

    # ---- training: steps against the plain steps, the train CLI ------------- #
    torch.manual_seed(19)
    tmodel = MDM(njoints=J, latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=HEADS,
                 dropout=RATE, cond_mask_prob=0.1, seed_poses=S, cl_head=CL_HEADS,
                 window_size=WINDOW, mfcc_input=False, use_wav_enc=True,
                 use_fused_train_encoder=True).to(dev)
    plain = copy.deepcopy(tmodel)
    plain.use_kernels = False
    tdiffusion = create_diffusion(noise_schedule="cosine", steps=1000, device=dev)
    cfg = TrainConfig(lr=1e-4, batch_size=BATCH, microbatch_size=MB)
    mask = torch.ones((BATCH, 1, 1, T), dtype=torch.bool, device=dev)
    rs = np.random.RandomState(17)
    batches = [dict(motion=randn(BATCH, J, 1, T, scale=0.5),
                    cond={"audio": randn(BATCH, T * WAV_SPF, scale=0.3),
                          "seed": randn(BATCH, J, 1, S, scale=0.5), "mask": mask},
                    t=torch.from_numpy(rs.randint(0, 1000, size=BATCH)).to(dev),
                    noise=randn(BATCH, J, 1, T)) for _ in range(TRAIN_STEPS)]
    compare_train_steps(tmodel, plain, tdiffusion, cfg, batches, LAYERS * (BATCH // MB),
                        f"batch {BATCH} ({BATCH // MB} x {MB}), raw audio through the wav "
                        f"encoder", f"{LAYERS} layers x {BATCH // MB} microbatches", card,
                        stats=True, zero_grads=tuple(f"wav_encoder.feat_extractor.{i}.bias"
                                                     for i in (0, 3, 6)))
    del plain, batches
    cli_launches = train_cli_phase(card, extra=("--use_wav_enc",), name="train_wav")
    sd = load_checkpoint(os.path.join(HERE, "build", "chip_smoke", "train_wav",
                                      f"model{CLI_STEPS:09d}.pt"))
    tracked = int(sd["wav_encoder.feat_extractor.1.num_batches_tracked"])
    ok = (tracked == CLI_STEPS * BATCH // MB
          and bool(sd["wav_encoder.feat_extractor.7.running_var"].ne(1).all()))
    log(f"{'OK' if ok else 'FAIL'} the wav-encoder checkpoint carries its running statistics "
        f"(num_batches_tracked {tracked}: {CLI_STEPS} steps x {BATCH // MB} microbatches)")
    if not ok:
        raise AssertionError("the wav-encoder train CLI's running statistics")

    # ---- times ---------------------------------------------------------------- #
    enc_forward = wav.wav_encoder.forward

    def spanned(a):
        with torch.profiler.record_function("wav_encoder"):
            return enc_forward(a)

    wav.wav_encoder.forward = spanned
    try:
        wstep = device_profile(step_fn(wav, wav_conds), 10,
                               f"wav-encoder CFG denoise step (batch {2 * B_TAKES}, T = {T}, "
                               f"{T * WAV_SPF} samples)", card, ranges=("wav_encoder",))
    finally:
        del wav.wav_encoder.forward
    conv_ms, conv_launches = wstep["ranges"]["wav_encoder"]
    ostep = device_profile(step_fn(old, old_conds), 10,
                           f"MDMOld CFG denoise step (batch {2 * B_TAKES}, T = {T})", card)
    fast_ms = cuda_time_ms(step_fn(fast_model, {"mfcc": chunk_conds["mfcc"], "scale": scale}),
                           iters=20, warmup=2)
    log(f"time gesture CFG denoise step (batch {2 * B_TAKES}, T = {T}): wav-encoder MDM "
        f"{wstep['ms']:.4f} ms (idle {wstep['idle']:.3f}; the conv stack {conv_ms:.4f} ms of "
        f"{wstep['busy_ms']:.4f} ms of device time = {conv_ms / wstep['busy_ms']:.3f}, "
        f"{conv_launches} launches), MDMOld {ostep['ms']:.4f} ms (idle {ostep['idle']:.3f}), "
        f"phase 4's fast path {fast_ms:.4f} ms {card}")
    if not 0 < conv_ms < wstep["busy_ms"]:
        raise AssertionError("the profile found no conv-stack work in the wav-encoder step")
    return {**total, "encoder_layer_train_fwd": cli_launches[0],
            "encoder_layer_train_bwd": cli_launches[1]}


def device_profile(step, steps, label, card, host_rows=0, groups=None, ranges=()):
    """Device time by kernel over ``steps`` calls of ``step`` (torch.profiler,
    CUPTI), the device's idle share of an unprofiled call, with ``groups``
    (kernel name -> label or None) the time summed by label and, with
    ``host_rows``, the host ops with the most self CPU time.  Returns the
    call's ms, the device's busy ms, the idle share, the device kernels a
    call launches and, for each ``record_function`` range named in
    ``ranges``, the device ms and launches a call of its work
    (``range_device_time``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step_ms = cuda_time_ms(step, iters=steps, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows, host = [], []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            # an op's device time repeats the time of the kernels it launched
            host.append((e.self_cpu_time_total / steps / 1e3, e.count // steps, e.key))
            continue
        if e.key in ranges:
            continue  # a range's span on the device, not a kernel
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / steps / 1e3, e.count // steps, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    idle = max(0.0, 1 - busy_ms / step_ms)
    log(f"profile: {label} {step_ms:.4f} ms (CUDA events, unprofiled); kernels "
        f"{busy_ms:.4f} ms/step on the device, {sum(r[1] for r in rows)} launches a step -> "
        f"idle share {idle:.3f} {card}")
    for ms, n, name in rows[:14]:
        log(f"  {ms:.4f} ms/step {100 * ms / busy_ms:5.1f}%  x{n}  {name[:90]}")
    if groups is not None:
        summed = {}
        for ms, n, name in rows:
            label = groups(name) or "everything else (PyTorch's kernels)"
            t, c = summed.get(label, (0.0, 0))
            summed[label] = (t + ms, c + n)
        log("  by group:")
        for label, (ms, n) in sorted(summed.items(), key=lambda kv: -kv[1][0]):
            log(f"  {ms:.4f} ms/step {100 * ms / busy_ms:5.1f}%  x{n}  {label}")
    if host_rows:
        host.sort(reverse=True)
        log(f"  host: {sum(h[0] for h in host):.4f} ms/step of self CPU time in ops; top:")
        for ms, n, name in host[:host_rows]:
            log(f"  host {ms:.4f} ms/step  x{n}  {name[:80]}")
    spans = {}
    if ranges:
        events = prof.events()
        for name in ranges:
            ms, n = range_device_time(events, name)
            spans[name] = (ms / steps, n // steps)
    return {"ms": step_ms, "busy_ms": busy_ms, "idle": idle,
            "launches": sum(r[1] for r in rows), "ranges": spans}


def range_device_time(events, name):
    """(device ms, launches) of the kernels that the ops inside the
    ``record_function`` ranges called ``name`` launched, and of those that
    their autograd nodes launched in the backward: a node is the range's
    where its sequence number and forward thread are those of an op inside
    it.  A kernel belongs to the innermost op that launched it."""
    import bisect

    import torch

    by_thread = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and not e.is_async:
            by_thread.setdefault(e.thread, []).append(e)
    starts = {}
    for th, evs in by_thread.items():
        evs.sort(key=lambda e: e.time_range.start)
        starts[th] = [e.time_range.start for e in evs]

    def inside(span):
        evs, st = by_thread[span.thread], starts[span.thread]
        i = bisect.bisect_left(st, span.time_range.start)
        while i < len(evs) and evs[i].time_range.start <= span.time_range.end:
            if evs[i].time_range.end <= span.time_range.end:
                yield evs[i]
            i += 1

    spans = [e for evs in by_thread.values() for e in evs if e.name == name]
    ops = [op for span in spans for op in inside(span)]
    seqs = {(op.thread, op.sequence_nr) for op in ops if op.sequence_nr >= 0}
    nodes = [e for evs in by_thread.values() for e in evs
             if e.name.startswith("autograd::engine::evaluate_function: ")
             and (e.fwd_thread, e.sequence_nr) in seqs]
    kernels = [k for op in ops for k in op.kernels]
    kernels += [k for node in nodes for op in inside(node) for k in op.kernels]
    return sum(k.duration for k in kernels) / 1e3, len(kernels)


def profile_denoise_step(model, diffusion, chunk_conds, init_seed, card, steps=10):
    import torch

    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample
    from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn

    precompute, model_fn = select_sampling_model_fn(model, GUIDANCE, 0.1)
    cond = precompute({"mfcc": chunk_conds["mfcc"][0], "scale": chunk_conds["scale"][0],
                       "seed": init_seed})
    nt = chunk_conds["mfcc"].shape[-1]
    x = torch.zeros((B_TAKES, J, 1, nt), device=init_seed.device)
    noise = torch.randn_like(x)
    t = torch.full((B_TAKES,), diffusion.num_timesteps // 2, dtype=torch.long, device=x.device)
    device_profile(lambda: p_sample(diffusion, model_fn, x, t, cond, noise), steps,
                   f"denoise step at T = {nt}", card)


def layer_weights(randn, d, f):
    """The 12 weights of an encoder layer of width d and ff f, seeded."""
    return (
        randn(3 * d, d, scale=d**-0.5), randn(3 * d, scale=0.02),
        randn(d, d, scale=d**-0.5), randn(d, scale=0.02),
        1.0 + randn(d, scale=0.1), randn(d, scale=0.1),
        randn(f, d, scale=d**-0.5), randn(f, scale=0.02),
        randn(d, f, scale=f**-0.5), randn(d, scale=0.02),
        1.0 + randn(d, scale=0.1), randn(d, scale=0.1),
    )


def report(name, err, tol, ok_shape=True):
    """One parity line; raises where the kernel disagrees."""
    ok = ok_shape and err <= tol
    log(f"{'OK' if ok else 'FAIL'} {name}: max|diff| {err:.3e} (tol {tol:g})")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")


def band_edges_parity(randn):
    """Kernels 2 and 3 off the main path's shapes: the local block at one
    tile (T 10), off the 16-query tile (90), at 16 tiles (256), at heads
    of 6 (a float a copy), 40, 128 at 256 frames and WIDE_LOCAL; the band
    kernel around its 64-query tiles and 40-key chunks (T 20, 70, 1210),
    at windows 5 and 16, head widths 6, 40 and WIDE_LOCAL, with q, k, v one
    tensor, three, and strided views.  Returns the largest differences
    (local block, band)."""
    from gesturediffusion_tpu_torch.ops.band_attention import local_attention_band
    from gesturediffusion_tpu_torch.ops.fused_local_block import (
        fused_local_block,
        pre_encoder_local_block,
    )
    from gesturediffusion_tpu_torch.ops.local_attention import local_attention

    lb_err = 0.0
    # local heads past 128 (WIDE_LOCAL) and of 128 at 256 frames run the
    # kernel's sliced path
    wide = tuple((4, 80, CL_HEADS * dh, CL_HEADS, WINDOW) for dh in WIDE_LOCAL)
    for b, t, d, h, w in ((8, 10, D, CL_HEADS, WINDOW), (8, 90, D, CL_HEADS, WINDOW),
                          (4, 256, D, CL_HEADS, WINDOW), (8, 80, 48, CL_HEADS, 5),
                          (8, 80, 320, CL_HEADS, WINDOW), (2, 256, 1024, CL_HEADS, WINDOW),
                          *wide):
        x, coa = randn(b, t, d), randn(b, d)
        got = fused_local_block(x, coa, num_heads=h, window=w)
        err = (got - pre_encoder_local_block(x, coa, num_heads=h, window_size=w)).abs().max().item()
        report(f"local_block [{b},{t},{d}] heads {h} w {w}", err, TOL_LOCAL_BLOCK,
               got.shape == (b, t + 1, d))
        lb_err = max(lb_err, err)
    band_err = 0.0
    for t, w, dh, layout in ((20, WINDOW, 32, "aliased"), (70, WINDOW, 32, "separate"),
                             (1210, WINDOW, 32, "strided"), (T_LONG, 5, 32, "aliased"),
                             (T_LONG, 16, 32, "separate"), (T_LONG, WINDOW, 6, "strided"),
                             (T_LONG, WINDOW, 40, "aliased"), (1210, WINDOW, 6, "separate"),
                             *((T_LONG, WINDOW, dh, layout) for dh in WIDE_LOCAL
                               for layout in ("strided", "separate"))):
        if layout == "strided":
            q, k = (randn(4, t, CL_HEADS, dh).transpose(1, 2) for _ in range(2))
            v = q
        elif layout == "aliased":
            q = k = v = randn(4, CL_HEADS, t, dh)
        else:
            q, k, v = (randn(4, CL_HEADS, t, dh) for _ in range(3))
        got = local_attention_band(q, k, v, window_size=w)
        err = (got - local_attention(q, k, v, window_size=w)).abs().max().item()
        report(f"band_attention [4,{CL_HEADS},{t},{dh}] w {w} ({layout})", err, TOL_BAND,
               got.shape == q.shape)
        band_err = max(band_err, err)
    return lb_err, band_err


def c1_widths_parity(randn, seed):
    """Kernels 1, 4, 5 and 6 at the head widths the kernels pad (C1_WIDTHS,
    4 heads), at the widths past 128 that run in slices (WIDE_WIDTHS, ff 4
    D), and at D = 130, F = 1030 with 2 heads of 65 (rows not 16-byte
    aligned), at T 81 and 1201 (training 81 and 121), each against its
    plain version under the main path's tolerances.  Returns the largest
    differences {kernel: err}."""
    from gesturediffusion_tpu_torch.ops.flash_attention import (
        fused_self_attention,
        self_attention_reference,
    )
    from gesturediffusion_tpu_torch.ops.fused_encoder import (
        encoder_layer_plain,
        fused_encoder_layer,
    )

    errs = {"flash_attention": 0.0, "encoder_layer": 0.0, "encoder_layer_train_fwd": 0.0,
            "encoder_layer_train_bwd": 0.0}
    layers = [(HEADS * dh, 4 * HEADS * dh, HEADS) for dh in C1_WIDTHS + WIDE_WIDTHS]
    for d, f, heads in layers + [(130, 1030, 2)]:
        dh = d // heads
        w = layer_weights(randn, d, f)
        for t in (T + 1, T_LONG + 1):
            q, k, v = (randn(4, heads, t, dh) for _ in range(3))
            got = fused_self_attention(q, k, v)
            err = (got - self_attention_reference(q, k, v)).abs().max().item()
            report(f"flash_attention [4,{heads},{t},{dh}]", err, TOL_FLASH, got.shape == q.shape)
            errs["flash_attention"] = max(errs["flash_attention"], err)
            x = randn(4, t, d)
            got = fused_encoder_layer(x, *w, num_heads=heads)
            err = (got - encoder_layer_plain(x, *w, num_heads=heads)).abs().max().item()
            report(f"encoder_layer [4,{t},{d}] heads {heads} of {dh} ff {f}", err, TOL_ENCODER,
                   got.shape == x.shape)
            errs["encoder_layer"] = max(errs["encoder_layer"], err)
        for t in (T + 1, T_CLI + 1):
            fwd, bwd = check_train_layer(randn(8, t, d), randn(8, t, d), w, seed, heads=heads)
            errs["encoder_layer_train_fwd"] = max(errs["encoder_layer_train_fwd"], fwd)
            errs["encoder_layer_train_bwd"] = max(errs["encoder_layer_train_bwd"], bwd)
    return errs


def check_train_layer(xt, gt, enc_w, seed, heads=HEADS, row0=0):
    """Training-layer kernels against the plain layer (microbatch 64 on the
    main path): forward at rates 0.1 and 0, rate 0 against the inference
    kernel, and the backward's 13 gradients against autograd; ``row0``: the
    rows' offset in the batch the dropout counts (a data rank's share of a
    global batch).  Returns the forward's and the gradients' largest
    absolute differences."""
    import torch

    from gesturediffusion_tpu_torch.ops.fused_encoder import fused_encoder_layer
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
        encoder_layer_train_plain,
    )

    shape = f"[{xt.shape[0]},{xt.shape[1]},{xt.shape[2]}] heads {heads} ff {enc_w[6].shape[0]}"
    if row0:
        shape += f" row offset {row0}"
    fwd_err = {}
    for rate in (RATE, 0.0):
        got = encoder_layer_train_fwd(xt, *enc_w, seed=seed, num_heads=heads, rate=rate,
                                      row0=row0)
        want = encoder_layer_train_plain(xt, *enc_w, seed=seed, num_heads=heads, rate=rate,
                                         row0=row0)
        torch.cuda.synchronize()
        fwd_err[rate] = (got - want).abs().max().item()
        ok = got.shape == xt.shape and fwd_err[rate] <= TOL_TRAIN_FWD
        log(f"{'OK' if ok else 'FAIL'} encoder_layer_train_fwd {shape} rate {rate}: "
            f"max|diff| {fwd_err[rate]:.3e} (tol {TOL_TRAIN_FWD:g})")
        if not ok:
            raise AssertionError("training forward kernel disagrees with its plain version")
    inf_err = (got - fused_encoder_layer(xt, *enc_w, num_heads=heads)).abs().max().item()
    ok = inf_err <= TOL_TRAIN_FWD
    log(f"{'OK' if ok else 'FAIL'} encoder_layer_train_fwd rate 0 vs the inference kernel "
        f"encoder_layer: max|diff| {inf_err:.3e} (tol {TOL_TRAIN_FWD:g})")
    if not ok:
        raise AssertionError("rate-0 training forward disagrees with the inference kernel")

    got = encoder_layer_train_bwd(xt, *enc_w, seed=seed, g=gt, num_heads=heads, rate=RATE,
                                  row0=row0)
    with torch.enable_grad():
        leaves = [t.detach().clone().requires_grad_() for t in (xt, *enc_w)]
        encoder_layer_train_plain(*leaves, seed=seed, num_heads=heads, rate=RATE,
                                  row0=row0).backward(gt)
    torch.cuda.synchronize()
    names = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dln1_w", "dln1_b", "dw1", "db1",
             "dw2", "db2", "dln2_w", "dln2_b")
    worst, abs_err = (0.0, ""), 0.0
    for name, a, leaf in zip(names, got, leaves):
        err = (a - leaf.grad).abs().max().item()
        abs_err = max(abs_err, err)
        worst = max(worst, (err / leaf.grad.abs().max().item(), name))
    ok = worst[0] <= TOL_TRAIN_GRAD
    log(f"{'OK' if ok else 'FAIL'} encoder_layer_train_bwd {shape} rate {RATE}: dx and 12 "
        f"grads vs autograd through the plain layer, worst max|diff|/max|grad| {worst[0]:.3e} "
        f"({worst[1]}; tol {TOL_TRAIN_GRAD:g}), max|diff| {abs_err:.3e}")
    if not ok:
        raise AssertionError("training backward kernel disagrees with autograd")
    return fwd_err[RATE], abs_err


def train_kernel_times(xt, gt, enc_w, seed, iters=50):
    """Times of the training kernels at xt's shape (D and FF read off the
    weights, HEADS heads), and of the plain layer and the torch+SDPA
    composition (forward; forward and backward), with their work: {"fwd":
    row, "bwd": row}, a row being (ms, plain ms, library ms, bound ms, bound
    by, FLOP, bytes).  FLOP counts the function's products once (the
    backward: the recompute and twice the forward's), whatever the kernels
    recompute besides."""
    import torch

    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
        encoder_layer_train_plain,
    )

    tw = [w.detach().clone().requires_grad_() for w in enc_w]
    tx_ = xt.detach().clone().requires_grad_()

    def plain_fwd_bwd():
        with torch.enable_grad():
            encoder_layer_train_plain(tx_, *tw, seed=seed, num_heads=HEADS, rate=RATE).backward(gt)

    def lib_fwd_bwd():
        with torch.enable_grad():
            encoder_layer_sdpa(tx_, *tw, HEADS, rate=RATE).backward(gt)

    def timed(fn):
        return cuda_time_ms(fn, iters=iters, warmup=min(5, iters))

    ms = {
        "fwd": (timed(lambda: encoder_layer_train_fwd(
                    xt, *enc_w, seed=seed, num_heads=HEADS, rate=RATE)),
                timed(lambda: encoder_layer_train_plain(
                    xt, *enc_w, seed=seed, num_heads=HEADS, rate=RATE)),
                timed(lambda: encoder_layer_sdpa(xt, *enc_w, HEADS, rate=RATE))),
        "bwd": (timed(lambda: encoder_layer_train_bwd(
                    xt, *enc_w, seed=seed, g=gt, num_heads=HEADS, rate=RATE)),
                timed(plain_fwd_bwd), timed(lib_fwd_bwd)),
    }
    b, t, d = xt.shape
    f = enc_w[6].shape[0]
    gemm_flops = 2 * b * t * (4 * d * d + 2 * d * f)
    attn_flops = 4 * b * t**2 * d
    w_bytes = 4 * sum(w.numel() for w in enc_w)
    work = {"fwd": (gemm_flops + attn_flops, 4 * 2 * b * t * d + w_bytes + 4),
            # the backward recomputes the forward, then twice its products
            "bwd": (3 * (gemm_flops + attn_flops), 4 * 3 * b * t * d + 2 * w_bytes + 4)}
    return {k: (*ms[k], *bound_ms(*work[k], tf32x3=True), *work[k]) for k in ms}


def time_keys(row):
    """The timing keys of a kernel's JSON row from a train_kernel_times row."""
    return dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"), row[:5]))


# the port's kernels on the training layer's path, by the profiler's names
# (demangled or mangled), grouped for the train-step profile
TRAIN_KERNEL_GROUPS = (
    ("GEMM forward products (wgmma 3xTF32)",
     ("gemm_tf32x3_kernel<true, true", "gemm_tf32x3_kernelILb1ELb1E")),
    ("GEMM data gradients (wgmma 3xTF32, B transposed)",
     ("gemm_tf32x3_kernel<true, false", "gemm_tf32x3_kernelILb1ELb0E")),
    ("GEMM weight gradients (wgmma 3xTF32, both transposed, split-K)",
     ("gemm_tf32x3_kernel<false, false", "gemm_tf32x3_kernelILb0ELb0E")),
    ("flash attention forward with dropout (mma.sync 3xTF32)", ("flash_attention_kernel",)),
    ("attention backward dQ and dK/dV passes (mma.sync 3xTF32)",
     ("attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel")),
    ("row and column passes (LayerNorm, its backward, column and split sums, D)",
     ("layernorm_kernel", "ln_bwd_kernel", "colsum_kernel", "sum_splits_kernel",
      "attn_bwd_rowdot_kernel")),
)


def train_kernel_group(name: str):
    """The TRAIN_KERNEL_GROUPS label of a device kernel, or None."""
    for label, keys in TRAIN_KERNEL_GROUPS:
        if any(k in name for k in keys):
            return label
    return None


def layer_kernel_names(xt, gt, enc_w, seed) -> set:
    """The device kernels that one training forward and one backward launch
    run, read from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
    )

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        encoder_layer_train_fwd(xt, *enc_w, seed=seed, num_heads=HEADS, rate=RATE)
        encoder_layer_train_bwd(xt, *enc_w, seed=seed, g=gt, num_heads=HEADS, rate=RATE)
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and not e.key.startswith(("Memcpy", "Memset"))}


def train_phase(dev, randn, rs, card):
    """5 training steps of the full-width model at batch 256 with the
    kernels, counted, then the same steps with the plain versions."""
    import torch

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.models.mdm import MDM
    from gesturediffusion_tpu_torch.train.loop import TrainConfig

    torch.manual_seed(1)
    model = MDM(njoints=J, latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=HEADS,
                dropout=RATE, cond_mask_prob=0.1, seed_poses=S, mfcc_dim=A, cl_head=CL_HEADS,
                window_size=WINDOW, use_fused_train_encoder=True).to(dev)
    plain = copy.deepcopy(model)
    plain.use_kernels = False
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000, device=dev)
    cfg = TrainConfig(lr=1e-4, batch_size=BATCH, microbatch_size=MB)
    mask = torch.ones((BATCH, 1, 1, T), dtype=torch.bool, device=dev)
    batches = [dict(motion=randn(BATCH, J, 1, T, scale=0.5),
                    cond={"mfcc": randn(BATCH, A, 1, T), "seed": randn(BATCH, J, 1, S, scale=0.5),
                          "mask": mask},
                    t=torch.from_numpy(rs.randint(0, 1000, size=BATCH)).to(dev),
                    noise=randn(BATCH, J, 1, T)) for _ in range(TRAIN_STEPS)]

    compare_train_steps(model, plain, diffusion, cfg, batches, LAYERS * (BATCH // MB),
                        f"batch {BATCH} ({BATCH // MB} x {MB})",
                        f"{LAYERS} layers x {BATCH // MB} microbatches", card)
    return model, diffusion, cfg, batches[0]


def rank_batch(batch, mesh):
    """This data rank's rows of a global batch (its loader's slice); the
    batch itself without a mesh."""
    if mesh is None or mesh.data == 1:
        return batch
    per = batch["motion"].shape[0] // mesh.data
    rows = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    return {k: {n: x[rows] for n, x in v.items()} if k == "cond" else v[rows]
            for k, v in batch.items()}


def run_train_steps(model, diffusion, cfg, batches, fk_fn=None, record=False, stats_out=None,
                    mesh=None, states=None):
    """train_step over ``batches`` (injected t and noise; ``fk_fn`` to the
    geometric losses) from a fresh optimizer and generator: (losses, the
    first step's gradients, the median ms of steps 2 on, (peak MiB, MiB
    above the start), and with ``record`` each step's record: the weights,
    optimizer, schedule and generator states before it, and its loss and
    gradients after).  A list ``stats_out`` gets the BatchNorm running
    statistics after each step (running_stats).  With ``mesh`` (a rank of
    a multi-rank run) each step takes this rank's rows of the global
    batch, and the gradients are the ranks' average; a list ``states``
    gets the train state."""
    import torch

    from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
    from gesturediffusion_tpu_torch.train.loop import make_train_state, train_step

    dev = next(model.parameters()).device
    state = make_train_state(model, cfg, UniformSampler(1000), mesh)
    if states is not None:
        states.append(state)
    opt, sched = state.optimizer, state.scheduler
    gen = torch.Generator(device=dev).manual_seed(7)
    losses, times, grads, records = [], [], None, []
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for b in (rank_batch(b, mesh) for b in batches):
        if record:  # kept on the host, out of the run's device memory
            records.append({"params": {n: on_host(p) for n, p in model.named_parameters()},
                            "opt": on_host(opt.state_dict()),
                            "sched": copy.deepcopy(sched.state_dict()),
                            "gen": gen.get_state()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(state, diffusion, cfg, b["motion"], b["cond"], gen, b["t"],
                             b["noise"], fk_fn=fk_fn)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if record:
            records[-1].update(loss=losses[-1], grads={n: on_host(p.grad)
                                                       for n, p in model.named_parameters()})
        if stats_out is not None:
            stats_out.append(running_stats(model))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    peak = torch.cuda.max_memory_allocated()
    # the step's working memory above what was allocated before it
    # (models, optimizer state after step 1 aside, the staged batches)
    out = (losses, grads, sorted(times[1:])[len(times[1:]) // 2] * 1e3,
           (peak / 2**20, (peak - base) / 2**20))
    return (*out, records) if record else out


def running_stats(model) -> dict:
    """The model's BatchNorm running statistics, on the host."""
    return {n: on_host(b) for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def stats_gap(got: dict, want: dict) -> float:
    """The worst running statistic's max|diff| over its max|value|."""
    return max((got[k] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
               for k, w in want.items())


def on_host(tree):
    """A copy of a nested dict / list of tensors with every tensor on the host."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: on_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(on_host(v) for v in tree)
    return copy.deepcopy(tree)


def grad_gap(grads, want, zero=()) -> tuple[float, str]:
    """The worst parameter gradient's max|diff| over its max|value|, and its
    name.  A parameter named in ``zero`` has a gradient that is zero in
    exact arithmetic (a bias before a training BatchNorm, which takes the
    mean off), so float32 leaves rounding noise of its own size there: its
    gap is over the model's largest gradient instead."""
    top = max(g.abs().max().item() for g in want.values())
    return max(((grads[k].to(g.device) - g).abs().max().item()
                / max(top if k in zero else g.abs().max().item(), 1e-30), k)
               for k, g in want.items())


def teacher_forced_steps(model, diffusion, cfg, batches, records, fk_fn=None, mesh=None):
    """Each step k of the kernel model from the plain run's weights,
    optimizer, schedule and generator states before its step k (records of
    run_train_steps), on batch k: [(loss, gradients)] a step.  Each step
    reads the kernels' error of one step alone, not the float32 chaos that
    free-running steps amplify (ROADMAP C5).  With ``mesh`` the steps run
    on this rank's rows, a sharded weight and its moments as its block."""
    import torch

    from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
    from gesturediffusion_tpu_torch.train.loop import make_train_state, train_step

    state = make_train_state(model, cfg, UniformSampler(1000), mesh)
    opt, sched = state.optimizer, state.scheduler
    gen = torch.Generator(device=next(model.parameters()).device)
    out = []
    for b, rec in zip((rank_batch(b, mesh) for b in batches), records):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(rec["params"][n])
        opt_state = on_host(rec["opt"])  # moved to the parameters' device
        if state.tp is not None:
            state.tp.refill_shards()
            opt_state = state.tp.local_optimizer_state(opt_state)
        opt.load_state_dict(opt_state)
        sched.load_state_dict(rec["sched"])
        gen.set_state(rec["gen"])
        metrics = train_step(state, diffusion, cfg, b["motion"], b["cond"], gen, b["t"],
                             b["noise"], fk_fn=fk_fn)
        out.append((metrics["loss"].item(), {n: on_host(p.grad)
                                             for n, p in model.named_parameters()}))
    return out


def compare_train_steps(model, plain, diffusion, cfg, batches, per_step, label, why, card,
                        fk_fn=None, grad_miss=None, stats=False, zero_grads=()):
    """The steps through the training kernels (``per_step`` forward and
    backward launches a step, counted) against the same steps through the
    plain layers, two ways under TOL_STEP_LOSS and TOL_STEP_GRAD:
    free-running (the losses of every step, the first step's gradients),
    beside the gap of a plain run from weights nudged by one ulp (what
    float32 chaos alone moves); and teacher-forced (each kernel step from
    the plain run's state before it: its loss and every gradient, at every
    step).  Prints ms a step, samples/s and peak memory of both.  Where
    ``grad_miss`` is (a recorded ROADMAP item, a cap), teacher-forced
    gradients past TOL_STEP_GRAD but within the cap print a MISS naming the
    item and the run goes on; past the cap they fail, and the losses stay
    gated.  With ``stats`` the BatchNorm running statistics after every
    free-running step are held against the plain run's too, relative to
    their max, under TOL_STEP_LOSS (the one-ulp run's gap beside it).
    ``zero_grads`` names the parameters whose gradient is zero in exact
    arithmetic (grad_gap).  Returns the kernels' ms a step."""
    import torch

    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
    )

    n, b = len(batches), batches[0]["motion"].shape[0]
    encoder_layer_train_fwd.launches = encoder_layer_train_bwd.launches = 0
    k_stats, p_stats, n_stats = ([] if stats else None for _ in range(3))
    losses, grads, step_ms, peak = run_train_steps(model, diffusion, cfg, batches, fk_fn,
                                                   stats_out=k_stats)
    launches = (encoder_layer_train_fwd.launches, encoder_layer_train_bwd.launches)
    want = per_step * n
    finite = all(math.isfinite(x) for x in losses)
    log(f"{'OK' if launches == (want, want) and finite else 'FAIL'} train: {n} steps at {label}, "
        f"losses {[round(x, 6) for x in losses]} (finite {finite}); launches fwd {launches[0]} "
        f"bwd {launches[1]} (expected {want} each: {why} a step)")
    if launches != (want, want) or not finite:
        raise AssertionError("train steps: wrong launch counts or a non-finite loss")
    stats0 = running_stats(plain)
    p_losses, p_grads, p_step_ms, p_peak, records = run_train_steps(
        plain, diffusion, cfg, batches, fk_fn, record=True, stats_out=p_stats)
    nudged = copy.deepcopy(plain)
    with torch.no_grad():
        for name, p in nudged.named_parameters():
            w = records[0]["params"][name].to(p.device)
            p.copy_(torch.nextafter(w, torch.full_like(w, math.inf)))
        for name, buf in nudged.named_buffers():  # the statistics the plain run started from
            if name in stats0:
                buf.copy_(stats0[name])
    n_losses, n_grads, _, _ = run_train_steps(nudged, diffusion, cfg, batches, fk_fn,
                                              stats_out=n_stats)
    del nudged
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(losses, p_losses))
    grad_err = grad_gap(grads, p_grads, zero_grads)[0]
    ulp_loss = max(abs(x - y) / abs(y) for x, y in zip(n_losses, p_losses))
    free_ok = loss_err <= TOL_STEP_LOSS and grad_err <= TOL_STEP_GRAD
    log(f"{'OK' if free_ok else 'FAIL'} train steps vs plain versions on the card, free-running "
        f"(same seeds, t, noise): losses rel {loss_err:.3e} (tol {TOL_STEP_LOSS:g}); first step's "
        f"grads worst max|diff|/max|grad| {grad_err:.3e} (tol {TOL_STEP_GRAD:g}); beside it, plain "
        f"from weights nudged by one ulp: losses rel {ulp_loss:.3e}, first step's grads "
        f"{grad_gap(n_grads, p_grads, zero_grads)[0]:.3e}")
    if stats:
        gaps = [stats_gap(k, p) for k, p in zip(k_stats, p_stats)]
        stats_ok = max(gaps) <= TOL_STEP_LOSS
        free_ok = free_ok and stats_ok
        log(f"{'OK' if stats_ok else 'FAIL'} train steps vs plain versions on the card, "
            f"free-running: the BatchNorm running statistics after each step, worst "
            f"max|diff|/max|value| {', '.join(f'{x:.3e}' for x in gaps)} (tol "
            f"{TOL_STEP_LOSS:g}); beside them, the one-ulp run "
            f"{', '.join(f'{stats_gap(n, p):.3e}' for n, p in zip(n_stats, p_stats))}")
    # the teacher-forced pass runs (and prints) before either failure is raised
    forced = teacher_forced_steps(model, diffusion, cfg, batches, records, fk_fn)
    tf_loss = [abs(x - r["loss"]) / abs(r["loss"]) for (x, _), r in zip(forced, records)]
    tf_grad = [grad_gap(g, r["grads"], zero_grads) for (_, g), r in zip(forced, records)]
    # beside it, float32's own floor at each state: the plain step from the
    # recorded weights nudged by one ulp
    floor = [grad_gap(g, r["grads"], zero_grads)[0] for (_, g), r in zip(teacher_forced_steps(
        plain, diffusion, cfg, batches, [{**r, "params": {
            n: torch.nextafter(w, torch.full_like(w, math.inf)) for n, w in r["params"].items()}}
            for r in records], fk_fn), records)]
    loss_ok = max(tf_loss) <= TOL_STEP_LOSS
    worst = max(x for x, _ in tf_grad)
    grad_ok = worst <= TOL_STEP_GRAD
    verdict = ("OK" if loss_ok and grad_ok else
               "MISS" if loss_ok and grad_miss and worst <= grad_miss[1] else "FAIL")
    log(f"{verdict} train steps vs plain versions on the card, teacher-forced "
        f"(each kernel step from the plain run's weights, optimizer and generator before it): "
        f"losses rel {', '.join(f'{x:.3e}' for x in tf_loss)} (tol {TOL_STEP_LOSS:g}); grads "
        f"worst max|diff|/max|grad| {', '.join(f'{x:.3e} ({n})' for x, n in tf_grad)} (tol "
        f"{TOL_STEP_GRAD:g}); beside them, plain from those weights nudged by one ulp: grads "
        f"{', '.join(f'{x:.3e}' for x in floor)} (the kernels' gap "
        f"{', '.join(f'{x / max(f, 1e-30):.1f}' for (x, _), f in zip(tf_grad, floor))} x it)"
        + (f"; the gradients' miss is recorded as {grad_miss[0]}, capped at {grad_miss[1]:g}"
           if grad_miss and not grad_ok else ""))
    if not free_ok:
        raise AssertionError("kernel train steps disagree with the plain steps")
    if verdict == "FAIL":
        raise AssertionError("a teacher-forced kernel train step disagrees with the plain step")
    log(f"time train step ({label}, median of steps 2-{n}): kernels {step_ms:.3f} ms = "
        f"{b / step_ms * 1e3:.1f} samples/s, peak {peak[0]:.1f} MiB ({peak[1]:.1f} above the "
        f"start); plain {p_step_ms:.3f} ms = {b / p_step_ms * 1e3:.1f} samples/s, peak "
        f"{p_peak[0]:.1f} MiB ({p_peak[1]:.1f} above the start) {card}")
    return step_ms


def train_cli_phase(card, extra=(), name="train"):
    """The train CLI in this process (its launches counted; ``extra``: more
    flags), then the generate CLI on the checkpoint it writes; the run under
    build/chip_smoke/``name``."""
    import numpy as np

    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
    )
    from gesturediffusion_tpu_torch.train import train_mdm

    save_dir = os.path.join(HERE, "build", "chip_smoke", name)
    encoder_layer_train_fwd.launches = encoder_layer_train_bwd.launches = 0
    t0 = time.perf_counter()
    loop = train_mdm.main([
        "--dataset", "synthetic", "--save_dir", save_dir, "--overwrite",
        "--num_frames", str(T_CLI), "--batch_size", str(BATCH), "--microbatch_size", str(MB),
        "--num_steps", str(CLI_STEPS), "--log_interval", "10",
        "--use_fused_train_encoder", *extra])
    cli_s = time.perf_counter() - t0
    launches = (encoder_layer_train_fwd.launches, encoder_layer_train_bwd.launches)
    want = LAYERS * (BATCH // MB) * CLI_STEPS
    ckpt = os.path.join(save_dir, f"model{CLI_STEPS:09d}.pt")
    ok = launches == (want, want) and loop.state.step == CLI_STEPS and os.path.exists(ckpt)
    log(f"{'OK' if ok else 'FAIL'} train CLI {' '.join(extra)} on the card: {CLI_STEPS} steps "
        f"at batch {BATCH}, --num_frames {T_CLI}, in {cli_s:.1f} s (data set-up included); "
        f"launches fwd "
        f"{launches[0]} bwd "
        f"{launches[1]} (expected {want} each); wrote {os.path.basename(ckpt)} {card}")
    if not ok:
        raise AssertionError("train CLI: wrong launch counts or no checkpoint")
    out_dir = os.path.join(save_dir, "samples")
    subprocess.run(
        [sys.executable, "-m", "gesturediffusion_tpu_torch.sample.generate",
         "--model_path", ckpt, "--dataset", "synthetic", "--num_samples", "8",
         "--timestep_respacing", RESPACING, "--output_dir", out_dir],
        check=True, cwd=HERE, timeout=600,
    )
    res = np.load(os.path.join(out_dir, "results.npy"), allow_pickle=True).item()
    ok = res["motion"].shape == (8, J // 6, 3, T_CLI) and np.isfinite(res["motion"]).all()
    log(f"{'OK' if ok else 'FAIL'} generate CLI on the trained checkpoint: motion "
        f"{res['motion'].shape}")
    if not ok:
        raise AssertionError("generate CLI on the trained checkpoint failed")
    return launches


# ---- phase 18: the multi-rank paths ---------------------------------------- #

P_BATCH, P_TAKES, P_STREAMS, P_CLI_STEPS = 128, 42, 4, 3


def parallel_model(train: bool):
    """Phase 18's full-width gesture MDM V2 from seed 18 (the training
    variant with dropout and the fused training layer)."""
    import torch

    from gesturediffusion_tpu_torch.models.mdm import MDM

    kw = dict(njoints=J, latent_dim=D, ff_size=FF, num_layers=LAYERS, num_heads=HEADS,
              cond_mask_prob=0.1, seed_poses=S, mfcc_dim=A, cl_head=CL_HEADS,
              window_size=WINDOW)
    if train:
        kw.update(dropout=RATE, use_fused_train_encoder=True)
    torch.manual_seed(18)
    return MDM(**kw)


def parallel_inputs(dev):
    """Phase 18's inputs, the same in every process: TRAIN_STEPS batches of
    P_BATCH at T frames (timesteps and noise injected), a P_TAKES-take,
    CHUNKS-chunk take's conditioning and seed poses, a P_STREAMS-stream
    session's seed poses and MFCC windows."""
    import numpy as np
    import torch

    rs = np.random.RandomState(18)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * scale).to(dev)

    mask = torch.ones((P_BATCH, 1, 1, T), dtype=torch.bool, device=dev)
    batches = [dict(motion=randn(P_BATCH, J, 1, T, scale=0.5),
                    cond={"mfcc": randn(P_BATCH, A, 1, T),
                          "seed": randn(P_BATCH, J, 1, S, scale=0.5), "mask": mask},
                    t=torch.from_numpy(rs.randint(0, 1000, size=P_BATCH)).to(dev),
                    noise=randn(P_BATCH, J, 1, T)) for _ in range(TRAIN_STEPS)]
    take = ({"mfcc": randn(CHUNKS, P_TAKES, A, 1, T),
             "scale": torch.full((CHUNKS, P_TAKES), GUIDANCE, device=dev)},
            randn(P_TAKES, J, 1, S, scale=0.5))
    stream = (randn(P_STREAMS, J, 1, S, scale=0.5).cpu().numpy(),
              [randn(P_STREAMS, A, 1, T).cpu().numpy() for _ in range(CHUNKS)])
    return batches, take, stream


def parallel_session(model, mesh, dev):
    from gesturediffusion_tpu_torch.serve.streaming import StreamingGestureSession

    return StreamingGestureSession(model, guidance_param=GUIDANCE, cond_mask_prob=0.1,
                                   sampler="ddim", sample_steps=STEPS, streams=P_STREAMS,
                                   chunk_frames=T, seed_poses=S, fps=30.0, mesh=mesh,
                                   device=dev)


def parallel_counters():
    from gesturediffusion_tpu_torch.ops.flash_attention import fused_self_attention
    from gesturediffusion_tpu_torch.ops.fused_encoder import fused_encoder_layer
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
    )
    from gesturediffusion_tpu_torch.ops.fused_local_block import fused_local_block

    return launch_counter({
        "local_block": fused_local_block, "encoder_layer": fused_encoder_layer,
        "flash_attention": fused_self_attention,
        "encoder_layer_train_fwd": encoder_layer_train_fwd,
        "encoder_layer_train_bwd": encoder_layer_train_bwd})


def parallel_rank(spec_path: str) -> int:
    """One rank of phase 18 (a subprocess with GDT_COORDINATOR_ADDRESS,
    GDT_NUM_PROCESSES and GDT_PROCESS_ID set): the train CLI (``cli``), or
    the training steps at 2 x 1 and 1 x 2 against the single-process
    reference, the take and the session (``grid``).  Writes its readings
    beside the spec."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.parallel import distributed as pdist
    from gesturediffusion_tpu_torch.parallel.mesh import make_mesh
    from gesturediffusion_tpu_torch.train.loop import TrainConfig

    spec = torch.load(spec_path, weights_only=False)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    pdist.maybe_initialize()
    dev, rank = pdist.rank_device(), pdist.process_index()
    out = {"backend": dist.get_backend(), "world": pdist.process_count(), "device": str(dev)}
    counted, _ = parallel_counters()
    if spec["kind"] == "cli":
        from gesturediffusion_tpu_torch.train import train_mdm

        t0 = time.perf_counter()
        loop, out["launches"] = counted(lambda: train_mdm.main(spec["argv"]))
        out.update(step=loop.state.step, cli_s=time.perf_counter() - t0)
    else:
        batches, (conds, seed0), (stream_seed, stream_mfcc) = parallel_inputs(dev)
        ref = torch.load(spec["reference"], weights_only=False)
        diffusion = create_diffusion(noise_schedule="cosine", steps=1000, device=dev)
        cfg = TrainConfig(lr=1e-4, batch_size=P_BATCH)
        for name, grid in (("dp", (2, 1)), ("tp", (1, 2))):
            mesh = make_mesh(*grid)
            model = parallel_model(True).to(dev)
            model.load_state_dict(ref["state"])
            states = []
            (losses, grads, step_ms, _), launches = counted(lambda: run_train_steps(
                model, diffusion, cfg, batches, mesh=mesh, states=states))
            tp = states[0].tp
            shards = {} if tp is None else {
                n: (tuple(s.shape), tuple(states[0].optimizer.state[s]["exp_avg"].shape))
                for n, s in tp.shards.items()}
            forced = teacher_forced_steps(model, diffusion, cfg, batches, ref["records"],
                                          mesh=mesh)
            out[name] = dict(
                losses=losses, step_ms=step_ms, launches=launches, shards=shards,
                loss_err=max(abs(x - y) / abs(y) for x, y in zip(losses, ref["losses"])),
                grad_err=grad_gap(grads, ref["grads"])[0],
                tf_loss=[abs(x - r["loss"]) / abs(r["loss"])
                         for (x, _), r in zip(forced, ref["records"])],
                tf_grad=[grad_gap(g, r["grads"]) for (_, g), r in zip(forced, ref["records"])])
            del model, states, forced
        mesh = make_mesh(2, 1)
        model = parallel_model(False).to(dev).eval()
        model.load_state_dict(torch.load(spec["model_path"], map_location=dev))
        take_diffusion = create_diffusion(noise_schedule="cosine", steps=1000,
                                          timestep_respacing=RESPACING, device=dev)
        per = P_TAKES // mesh.data
        rows = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
        t0 = time.perf_counter()
        with pdist.global_rows(rows.start, per, P_TAKES):
            take, out["take_launches"] = counted(lambda: run_take(
                model, take_diffusion, {k: v[:, rows] for k, v in conds.items()},
                seed0[rows], 1))
        out["take_s"] = time.perf_counter() - t0
        out["take"] = pdist.all_gather_cat(take.transpose(0, 1), mesh.data_group).transpose(
            0, 1).cpu()
        session = parallel_session(model, mesh, dev)
        session.start(stream_seed, rng=10)
        out["chunks"], out["stream_launches"] = counted(
            lambda: [session.feed({"mfcc": m}) for m in stream_mfcc])
    torch.save(out, spec_path.replace(".pt", f".rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def spawn_ranks(spec_path: str, world: int, backend=None, timeout=900) -> list:
    """Phase 18's ranks as subprocesses of this script on a free localhost
    port; each rank's readings."""
    import socket

    import torch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, GDT_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               GDT_NUM_PROCESSES=str(world))
    env.pop("GDT_DIST_BACKEND", None)
    if backend:
        env["GDT_DIST_BACKEND"] = backend
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                               "--parallel-rank", spec_path],
                              env=dict(env, GDT_PROCESS_ID=str(r)), cwd=HERE)
             for r in range(world)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise AssertionError(f"parallel ranks exited with {codes}")
    return [torch.load(spec_path.replace(".pt", f".rank{r}.pt"), weights_only=False)
            for r in range(world)]


def parallel_phase(model_path, card):
    """Phase 18: the multi-rank paths on the card.  The train CLI on NCCL at
    world size 1; two ranks sharing the card over gloo (NCCL refuses two
    ranks on one device) for TRAIN_STEPS steps at global batch P_BATCH
    through kernels 5 and 6 with dropout on, at 2 x 1 (64 rows a rank, rank
    1 at row offset 64) and at 1 x 2 (each weight of the shape rule as its
    half), each held against the single-process steps on the card
    free-running and teacher-forced under TOL_STEP_LOSS and TOL_STEP_GRAD;
    a P_TAKES-take, CHUNKS-chunk take split over the two ranks and a
    P_STREAMS-stream session on mesh= against the single-process ones under
    TOL_TAKE.  Launches are counted per rank.  Returns the launches of the
    phase's main paths by kernel, summed over the ranks."""
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.train.loop import TrainConfig

    base = os.path.join(HERE, "build", "chip_smoke", "parallel")
    os.makedirs(base, exist_ok=True)
    dev = torch.device("cuda")
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # the train CLI as a world of one rank on NCCL
    cli_dir = os.path.join(base, "cli")
    spec = os.path.join(base, "cli.pt")
    torch.save({"kind": "cli", "argv": [
        "--dataset", "synthetic", "--save_dir", cli_dir, "--overwrite", "--num_frames",
        str(T_CLI), "--batch_size", str(MB), "--num_steps", str(P_CLI_STEPS),
        "--log_interval", "1", "--use_fused_train_encoder"]}, spec)
    (r0,) = spawn_ranks(spec, 1)
    want = LAYERS * P_CLI_STEPS
    got = (r0["launches"]["encoder_layer_train_fwd"], r0["launches"]["encoder_layer_train_bwd"])
    ok = (r0["backend"] == "nccl" and r0["world"] == 1 and r0["step"] == P_CLI_STEPS
          and got == (want, want)
          and os.path.exists(os.path.join(cli_dir, f"model{P_CLI_STEPS:09d}.pt")))
    log(f"{'OK' if ok else 'FAIL'} parallel: train CLI as rank 0 of 1 on {r0['backend']} "
        f"({r0['device']}): {r0['step']} steps at batch {MB}, --num_frames {T_CLI}, in "
        f"{r0['cli_s']:.1f} s; launches fwd {got[0]} bwd {got[1]} (expected {want} each) {card}")
    if not ok:
        raise AssertionError("the train CLI on NCCL at world size 1 failed")
    add(r0["launches"])

    # the single-process references on the card
    batches, (conds, seed0), (stream_seed, stream_mfcc) = parallel_inputs(dev)
    model = parallel_model(True).to(dev)
    state0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000, device=dev)
    cfg = TrainConfig(lr=1e-4, batch_size=P_BATCH)
    losses, grads, step_ms, _, records = run_train_steps(model, diffusion, cfg, batches,
                                                         record=True)
    ref_path = os.path.join(base, "reference.pt")
    torch.save({"state": state0, "losses": losses, "grads": on_host(grads),
                "records": records}, ref_path)
    del model, records
    tmodel = parallel_model(False).to(dev).eval()
    tmodel.load_state_dict(torch.load(model_path, map_location=dev))
    take_diffusion = create_diffusion(noise_schedule="cosine", steps=1000,
                                      timestep_respacing=RESPACING, device=dev)
    t0 = time.perf_counter()
    take = run_take(tmodel, take_diffusion, conds, seed0, 1).cpu()
    take_s = time.perf_counter() - t0
    session = parallel_session(tmodel, None, dev)
    session.start(stream_seed, rng=10)
    chunks = [session.feed({"mfcc": m}) for m in stream_mfcc]
    del tmodel, batches

    # two ranks on the card over gloo
    spec = os.path.join(base, "grid.pt")
    torch.save({"kind": "grid", "reference": ref_path, "model_path": model_path}, spec)
    t0 = time.perf_counter()
    ranks = spawn_ranks(spec, 2, backend="gloo")
    ranks_s = time.perf_counter() - t0
    want = LAYERS * TRAIN_STEPS
    for name, grid in (("dp", f"2 x 1 ({P_BATCH // 2} rows a rank)"),
                       ("tp", f"1 x 2 ({P_BATCH} rows a rank)")):
        runs = [r[name] for r in ranks]
        launches = [(x["launches"]["encoder_layer_train_fwd"],
                     x["launches"]["encoder_layer_train_bwd"]) for x in runs]
        for x in runs:
            add(x["launches"])
        agree = max(abs(a - b) / abs(b) for x in runs for a, b in zip(x["losses"],
                                                                       runs[0]["losses"]))
        # each weight of the shape rule as its half, its moments too
        rule = {n for n, s in shapes.items()
                if len(s) == 2 and s[0] * s[1] >= 1 << 16 and s[0] % 2 == 0}
        shards_ok = name == "dp" or all(set(x["shards"]) == rule and all(
            s == m == (shapes[n][0] // 2, shapes[n][1]) for n, (s, m) in x["shards"].items())
            for x in runs)
        free_ok = all(x["loss_err"] <= TOL_STEP_LOSS and x["grad_err"] <= TOL_STEP_GRAD
                      for x in runs)
        tf_ok = all(max(x["tf_loss"]) <= TOL_STEP_LOSS
                    and max(g for g, _ in x["tf_grad"]) <= TOL_STEP_GRAD for x in runs)
        ok = (free_ok and tf_ok and shards_ok and agree <= TOL_STEP_LOSS
              and all(n == (want, want) for n in launches)
              and all(r["backend"] == "gloo" and r["world"] == 2 for r in ranks))
        x = runs[0]
        log(f"{'OK' if ok else 'FAIL'} parallel: {TRAIN_STEPS} steps at global batch "
            f"{P_BATCH} on 2 ranks over gloo, grid {grid}, against the single-process "
            f"steps on the card: free-running losses rel "
            f"{', '.join(f'{r[name]['loss_err']:.3e}' for r in ranks)} (tol "
            f"{TOL_STEP_LOSS:g}), first step's grads "
            f"{', '.join(f'{r[name]['grad_err']:.3e}' for r in ranks)} (tol {TOL_STEP_GRAD:g}); "
            f"teacher-forced losses rel {', '.join(f'{v:.3e}' for v in x['tf_loss'])}, grads "
            f"{', '.join(f'{v:.3e} ({n})' for v, n in x['tf_grad'])}; the ranks' losses "
            f"{agree:.3e} apart; launches a rank fwd/bwd {launches} (expected {want} each)"
            + ("" if name == "dp" else
               f"; {len(x['shards'])} weights as halves, each block and its moments "
               f"{sorted(set(s for s, _ in x['shards'].values()))}"))
        if not ok:
            raise AssertionError(f"the {grid} multi-rank steps disagree with the "
                                 "single-process steps")
        log(f"time parallel train step ({grid}, 2 ranks sharing one card over gloo, a "
            f"functional reading, not a scaling figure; median of steps 2-{TRAIN_STEPS}): "
            f"{', '.join(f'{r[name]['step_ms']:.3f}' for r in ranks)} ms a rank; the "
            f"single process at batch {P_BATCH}: {step_ms:.3f} ms {card}")
    want = {"local_block": STEPS * CHUNKS, "encoder_layer": STEPS * CHUNKS * LAYERS,
            "flash_attention": STEPS * CHUNKS * LAYERS}
    take_err = max((r["take"] - take).abs().max().item() for r in ranks)
    counts = [{k: r["take_launches"][k] for k in want} for r in ranks]
    for r in ranks:
        add(r["take_launches"])
        add(r["stream_launches"])
    ok = take_err <= TOL_TAKE and all(c == want for c in counts)
    log(f"{'OK' if ok else 'FAIL'} parallel: a {P_TAKES}-take, {CHUNKS}-chunk CFG take split "
        f"over 2 ranks (CFG batch {P_TAKES} a rank) against the single-process take: "
        f"max|diff| {take_err:.3e} (tol {TOL_TAKE:g}); launches a rank {counts} (expected "
        f"{want}); {max(r['take_s'] for r in ranks):.3f} s a rank, single process "
        f"{take_s:.3f} s {card}")
    if not ok:
        raise AssertionError("the multi-rank take disagrees with the single-process take")
    stream_err = max(float(np.abs(g - w).max()) for r in ranks
                     for g, w in zip(r["chunks"], chunks))
    ok = stream_err <= TOL_TAKE and all(len(r["chunks"]) == CHUNKS for r in ranks)
    log(f"{'OK' if ok else 'FAIL'} parallel: a {P_STREAMS}-stream session on mesh= (2 data "
        f"ranks, DDIM-{STEPS}) against the single-process session, every rank the whole "
        f"chunk: max|diff| {stream_err:.3e} (tol {TOL_TAKE:g}); launches a rank "
        f"{[r['stream_launches']['encoder_layer'] for r in ranks]} encoder layers; the "
        f"2-rank run {ranks_s:.1f} s in all")
    if not ok:
        raise AssertionError("the mesh= session disagrees with the single-process session")
    return total


def rel_gap(got, want) -> float:
    """max|got - want| over max|want| (numpy or tensors)."""
    import numpy as np

    got, want = (np.asarray(a.detach().cpu() if hasattr(a, "detach") else a, np.float64)
                 for a in (got, want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def one_ulp_up(a):
    """A float32 array nudged by one ulp (integers as they are): float32's own floor."""
    import numpy as np

    a = np.asarray(a)
    return np.nextafter(a, np.float32(np.inf)).astype(np.float32) if a.dtype == np.float32 else a


def report_floor(name, err, floor, tol, ok_shape=True):
    """``report`` with float32's one-ulp floor (the same CPU run from inputs
    nudged by one ulp) beside the reading."""
    report(f"{name} (one-ulp floor {floor:.3e})", err, tol, ok_shape)


def comp_v6_phase(root, card):
    """Phase 19 (a): CompV6 at the released widths on the card against the
    same module on the CPU, the noise injected: a Text2MotionDatasetBaseline
    batch of EV_BATCH, lengths drawn from the length estimator's softmax as
    the reference draws them (twice more below 10 units), then ``generate``
    over max(m_lens) // 4 snippets.  Sub-networks under TOL_CV6_NET, the take
    under TOL_CV6_TAKE, each beside float32's one-ulp floor; the take's wall
    time, and a snippet step's ms, launches and idle share."""
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.data.humanml import HashVectorizer, Text2MotionDatasetBaseline
    from gesturediffusion_tpu_torch.eval.comp_v6 import CompV6Generator
    from gesturediffusion_tpu_torch.utils.device import full_f32

    dev = torch.device("cuda")
    ds = Text2MotionDatasetBaseline(root, split="test", w_vectorizer=HashVectorizer())
    items = [ds[i] for i in range(EV_BATCH)]
    word = np.stack([it["word_embeddings"] for it in items])
    pos = np.stack([it["pos_one_hots"] for it in items])
    lens = np.asarray([it["sent_len"] for it in items])
    src = np.stack([it["src_motion"] for it in items])
    torch.manual_seed(0)
    cpu = CompV6Generator(device="cpu")
    gpu = CompV6Generator(device=dev)
    gpu.load_state_dict(cpu.state_dict())

    logits = cpu.estimate_length_logits(word, pos, lens)
    report_floor(f"comp_v6 length estimator [{EV_BATCH},{word.shape[1]},300] -> 50 on the card "
                 f"vs the CPU", rel_gap(gpu.estimate_length_logits(word, pos, lens), logits),
                 rel_gap(cpu.estimate_length_logits(one_ulp_up(word), pos, lens), logits),
                 TOL_CV6_NET)
    probs = torch.softmax(logits.double(), -1).numpy()
    rs = np.random.RandomState(0)
    units = np.zeros(EV_BATCH, np.int64)
    for i, p in enumerate(probs):
        for _ in range(3):  # the reference's draw: again while under 10 units, twice at most
            units[i] = rs.choice(len(p), p=p / p.sum())
            if units[i] >= 10:
                break
    m_lens, mov_len = units * 4, int(units.max())
    noise = rs.randn(mov_len, EV_BATCH, 128).astype(np.float32)

    state_c = cpu.begin(word, pos, lens)
    state_g = gpu.begin(word, pos, lens)
    state_n = cpu.begin(one_ulp_up(word), pos, lens)
    report_floor(f"comp_v6 text encoder word outputs [{EV_BATCH},{word.shape[1]},1024] on the "
                 f"card vs the CPU", rel_gap(state_g[1], state_c[1]),
                 rel_gap(state_n[1], state_c[1]), TOL_CV6_NET)
    ml_c, ml_g = torch.as_tensor(m_lens), torch.as_tensor(m_lens, device=dev)
    noise_c, noise_g = torch.as_tensor(noise), torch.as_tensor(noise, device=dev)
    mov_c, _ = cpu.snippet(0, state_c, ml_c, noise=noise_c[0])
    mov_g, _ = gpu.snippet(0, state_g, ml_g, noise=noise_g[0])
    mov_n, _ = cpu.snippet(0, state_n, ml_c, noise=noise_c[0])
    report_floor(f"comp_v6 snippet step (attention, prior, decoder) [{EV_BATCH},512] on the "
                 f"card vs the CPU", rel_gap(mov_g, mov_c), rel_gap(mov_n, mov_c), TOL_CV6_NET)
    lat = rs.randn(EV_BATCH, mov_len, 512).astype(np.float32)
    with torch.no_grad(), full_f32():
        dec_c = cpu.mov_dec(torch.as_tensor(lat))
        dec_g = gpu.mov_dec(torch.as_tensor(lat, device=dev))
        dec_n = cpu.mov_dec(torch.as_tensor(one_ulp_up(lat)))
    report_floor(f"comp_v6 movement decoder [{EV_BATCH},{mov_len},512] -> [{EV_BATCH},"
                 f"{4 * mov_len},263] on the card vs the CPU", rel_gap(dec_g, dec_c),
                 rel_gap(dec_n, dec_c), TOL_CV6_NET)

    take_c = cpu.generate(word, pos, lens, m_lens, mov_len, noise=noise)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    take_g = gpu.generate(word, pos, lens, m_lens, mov_len, noise=noise)
    torch.cuda.synchronize()
    take_s = time.perf_counter() - t0
    take_n = cpu.generate(one_ulp_up(word), pos, lens, m_lens, mov_len, noise=noise)
    shape_ok = (tuple(take_g.shape) == (EV_BATCH, 4 * mov_len, 263)
                and bool(torch.isfinite(take_g).all()) and src.shape == (EV_BATCH, 20, 263))
    report_floor(f"comp_v6 take ({EV_BATCH} captions, {mov_len} snippets, m_lens "
                 f"{int(m_lens.min())}-{int(m_lens.max())}) on the card vs the CPU, the noise "
                 f"injected (|take| max {take_c.abs().max().item():.3f})", rel_gap(take_g, take_c),
                 rel_gap(take_n, take_c), TOL_CV6_TAKE, shape_ok)
    i = min(5, mov_len - 1)
    prof = device_profile(lambda: gpu.snippet(i, state_g, ml_g, noise=noise_g[i]), 20,
                          f"comp_v6 snippet step (batch {EV_BATCH})", card)
    log(f"time comp_v6 take: {take_s:.3f} s for {mov_len} snippets = "
        f"{take_s / mov_len * 1e3:.4f} ms a snippet step (the text encoder and the movement "
        f"decoder included); a snippet step alone {prof['ms']:.4f} ms, {prof['launches']} "
        f"launches, idle share {prof['idle']:.3f} {card}")


def trainers_phase(root, a2m_gt, card):
    """Phase 19 (b): the four evaluator trainers at the released widths,
    TRAINER_STEPS steps each at EV_BATCH (the a2m classifier at MB), on the
    card against the same trainer on the CPU: the first step's loss and
    every gradient under TOL_TRAINER_GRAD, the losses under
    TOL_TRAINER_LOSS relative, each beside a CPU run from one-ulp-nudged
    inputs.  Returns the card's trained modules."""
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.data.humanml import (
        HashVectorizer,
        MotionDatasetV2,
        Text2MotionDatasetV2,
    )
    from gesturediffusion_tpu_torch.eval import trainers as tr
    from gesturediffusion_tpu_torch.eval.comp_v6 import (
        MotionLenEstimatorBiGRU,
        MovementConvDecoder,
    )
    from gesturediffusion_tpu_torch.eval.eval_humanml import collate_humanml_eval
    from gesturediffusion_tpu_torch.eval.networks import (
        MotionDiscriminator,
        MotionEncoderBiGRUCo,
        MovementConvEncoder,
        TextEncoderBiGRUCo,
    )

    dev = torch.device("cuda")
    rs = np.random.RandomState(19)
    windows = MotionDatasetV2(root, "train", window_size=64)
    texts = Text2MotionDatasetV2(root, "train", w_vectorizer=HashVectorizer())
    decomp_b = [(np.stack([windows[int(i)]["motion"]
                           for i in rs.randint(0, len(windows), EV_BATCH)]),)
                for _ in range(TRAINER_STEPS)]
    text_b = [collate_humanml_eval([texts[int(i)] for i in rs.randint(0, len(texts), EV_BATCH)])
              for _ in range(TRAINER_STEPS)]
    len_b = [(b["word_embs"], b["pos_ohot"], b["cap_lens"], b["m_lens"]) for b in text_b]
    match_b = [(b["word_embs"], b["pos_ohot"], b["cap_lens"], b["motions"], b["m_lens"],
                int(rs.randint(1, EV_BATCH))) for b in text_b]
    xyz = np.asarray(a2m_gt["output_xyz"], np.float32)
    clf_b = [(xyz + rs.randn(*xyz.shape).astype(np.float32) * 0.01 * k,
              np.asarray(a2m_gt["lengths"]), np.asarray(a2m_gt["y"]))
             for k in range(TRAINER_STEPS)]

    def seeded(build):
        def make(device):
            torch.manual_seed(19)
            return build(device)
        return make

    trained = {}

    def compare(name, make, batches):
        cpu, gpu, nud = make("cpu"), make(dev), make("cpu")
        first = [t.backward(*b) for t, b in ((cpu, batches[0]), (gpu, batches[0]),
                                             (nud, tuple(one_ulp_up(a) for a in batches[0])))]
        grads = [{n: p.grad.detach().cpu().clone() for n, p in t.named_parameters()}
                 for t in (cpu, gpu, nud)]
        gap, worst = max((rel_gap(grads[1][n], g), n) for n, g in grads[0].items())
        floor = max(rel_gap(grads[2][n], g) for n, g in grads[0].items())
        loss0 = [m["loss"].item() for m in first]
        report_floor(f"trainer {name}: the first step's loss on the card vs the CPU "
                     f"({loss0[0]:.6f})", abs(loss0[1] - loss0[0]) / abs(loss0[0]),
                     abs(loss0[2] - loss0[0]) / abs(loss0[0]), TOL_TRAINER_GRAD)
        report_floor(f"trainer {name}: the first step's {len(grads[0])} gradients on the card "
                     f"vs the CPU, of each one's max (worst {worst})", gap, floor,
                     TOL_TRAINER_GRAD)
        losses = [[x] for x in loss0]
        times = []
        for t in (cpu, gpu, nud):
            t.update()
        for b in batches[1:]:
            for k, (t, bb) in enumerate(((cpu, b), (gpu, b), (nud, tuple(map(one_ulp_up, b))))):
                if k == 1:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                losses[k].append(t.step(*bb)["loss"].item())
                if k == 1:
                    times.append(time.perf_counter() - t0)
        rel = [max(abs(a - w) / abs(w) for a, w in zip(run, losses[0])) for run in losses[1:]]
        report_floor(f"trainer {name}: {len(batches)} losses on the card vs the CPU "
                     f"({', '.join(f'{x:.6f}' for x in losses[1])}), relative", rel[0], rel[1],
                     TOL_TRAINER_LOSS)
        log(f"time trainer {name}: {sorted(times)[len(times) // 2] * 1e3:.3f} ms a step "
            f"(median of steps 2-{len(batches)}, host sync included) {card}")
        return cpu, gpu

    decomp_c, decomp_g = compare("decomp (movement autoencoder 259 -> 512 -> 263, [32,64,263])",
                                 seeded(lambda d: tr.DecompTrainer(
                                     MovementConvEncoder(259, 512, 512),
                                     MovementConvDecoder(512, 512, 263), device=d)), decomp_b)
    compare("length estimator (BiGRU 512, 50 buckets, clip 0.5)",
            seeded(lambda d: tr.LengthEstTrainer(MotionLenEstimatorBiGRU(), device=d)), len_b)
    movement = decomp_c.modules["enc"].state_dict()

    def match(d):
        enc = MovementConvEncoder(259, 512, 512)
        enc.load_state_dict(movement)
        return tr.TextMotionMatchTrainer(TextEncoderBiGRUCo(), MotionEncoderBiGRUCo(), enc,
                                         device=d)

    _, match_g = compare("text-motion match (text BiGRU 512, motion BiGRU 1024, the decomp's "
                         "frozen movement encoder, clip 0.5)", seeded(match), match_b)
    _, clf_g = compare(f"action classifier (GRU 72 -> 128 x 2 -> 12, phase 14's gt batch of "
                       f"{xyz.shape[0]})", seeded(lambda d: tr.ActionClassifierTrainer(
                           MotionDiscriminator(72, 128, 2, 12), device=d)), clf_b)
    trained.update(text_encoder=match_g.modules["text"], motion_encoder=match_g.modules["motion"],
                   movement_encoder=match_g.movement_encoder, a2m=clf_g.modules["classifier"])
    return trained


def closed_loop_phase(root, trained, a2m_batches, card):
    """Phase 19 (c): ``save_finest`` writes finest.tar and the a2m tar; the
    T2M wrapper from T2M_EVALUATOR_PATH embeds a ground-truth batch bit for
    bit as the in-memory modules do and gives the ground truth's metrics on
    the card within TOL_EVAL_FEATS of the CPU; one generated batch of
    EV_BATCH from phase 12's checkpoint (CFG 2 x EV_BATCH, 1000 steps,
    kernels 1 and 4 counted) scored by ``evaluation`` with the retrained
    evaluators beside the random ones; the a2m tar through
    A2M_CLASSIFIER_PATH on phase 14's batches.  Returns the launches."""
    import numpy as np
    import torch

    from gesturediffusion_tpu_torch.data.humanml import HashVectorizer, Text2MotionDatasetV2
    from gesturediffusion_tpu_torch.diffusion.sampling import p_sample_loop
    from gesturediffusion_tpu_torch.eval.eval_a2m import A2MEvaluation, make_a2m_evaluation
    from gesturediffusion_tpu_torch.eval.eval_humanml import (
        GeneratedMotionSet,
        GroundTruthMotionSet,
        evaluate_diversity,
        evaluate_fid,
        evaluate_matching_score,
        evaluation,
        load_eval_renorm,
    )
    from gesturediffusion_tpu_torch.eval.evaluator_wrapper import STATE_DICT_KEYS, EvaluatorWrapper
    from gesturediffusion_tpu_torch.eval.trainers import save_finest
    from gesturediffusion_tpu_torch.models.cfg import classifier_free_guidance
    from gesturediffusion_tpu_torch.ops.flash_attention import fused_self_attention
    from gesturediffusion_tpu_torch.ops.fused_encoder import fused_encoder_layer
    from gesturediffusion_tpu_torch.utils.convert import load_checkpoint
    from gesturediffusion_tpu_torch.utils.model_factory import create_model_and_diffusion
    from gesturediffusion_tpu_torch.utils.parser import evaluation_args
    from gesturediffusion_tpu_torch.utils.text_embedder import get_text_encoder

    dev = torch.device("cuda")
    out_dir = os.path.join(HERE, "build", "chip_smoke", "evaluators")
    os.makedirs(out_dir, exist_ok=True)
    finest, a2m_tar = os.path.join(out_dir, "finest.tar"), os.path.join(out_dir, "gru.tar")
    save_finest(finest, {k: trained[k] for k in STATE_DICT_KEYS})
    save_finest(a2m_tar, {"model": trained["a2m"]})
    saved = {k: os.environ.get(k) for k in ("T2M_EVALUATOR_PATH", "A2M_CLASSIFIER_PATH")}
    try:
        os.environ["T2M_EVALUATOR_PATH"], os.environ["A2M_CLASSIFIER_PATH"] = finest, a2m_tar
        loaded, loaded_cpu = (EvaluatorWrapper("humanml", dim_pose=T2M_J, device=d)
                              for d in (dev, "cpu"))
        a2m_loaded = make_a2m_evaluation("humanact12", device=dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    memory = EvaluatorWrapper("humanml", dim_pose=T2M_J, device=dev, state_dicts={
        k: trained[k].state_dict() for k in STATE_DICT_KEYS})
    random_ev = EvaluatorWrapper("humanml", dim_pose=T2M_J, device=dev)

    ds = Text2MotionDatasetV2(root, split="test", w_vectorizer=HashVectorizer())
    renorm = load_eval_renorm(ds, log)
    order = ds.rng.getstate()
    gt = list(GroundTruthMotionSet(ds, renorm=renorm))
    b0 = gt[0]
    embs = [w.get_co_embeddings(b0["word_embs"], b0["pos_ohot"], b0["cap_lens"], b0["motions"],
                                b0["m_lens"]) for w in (loaded, memory)]
    same = all(np.array_equal(a, b) for a, b in zip(*embs))
    log(f"{'OK' if same else 'FAIL'} closed loop: finest.tar through T2M_EVALUATOR_PATH embeds "
        f"a ground-truth batch of {EV_BATCH} bit for bit as the in-memory trained modules "
        f"(text {embs[0][0].shape}, motion {embs[0][1].shape})")
    if not same:
        raise AssertionError("the retrained finest.tar does not read back as written")
    metrics = []
    for w in (loaded, loaded_cpu):
        np.random.seed(0)
        match, rprec, acti = evaluate_matching_score(w, {"ground truth": gt}, lambda *a: None)
        fid = evaluate_fid(w, gt, acti, lambda *a: None)
        div = evaluate_diversity(acti, EV_DIVERSITY, lambda *a: None)
        metrics.append({"Matching Score": match["ground truth"], "FID": fid["ground truth"],
                        "Diversity": div["ground truth"],
                        **{f"R_precision top {i + 1}": v
                           for i, v in enumerate(rprec["ground truth"])}})
    gap = max(abs(metrics[0][k] - v) / max(1.0, abs(v)) for k, v in metrics[1].items())
    report(f"closed loop: the ground truth's metrics with the retrained evaluators on the card "
           f"vs the CPU ({len(gt)} batches of {EV_BATCH}; {metrics[0]})", gap, TOL_EVAL_FEATS)

    base = os.path.join(HERE, "build", "chip_smoke", "t2m_train")  # phase 12's
    ckpt = os.path.join(base, "run", f"model{CLI_STEPS:09d}.pt")
    args = evaluation_args(["--model_path", ckpt, "--guidance_param", str(GUIDANCE)])
    model, diffusion = create_model_and_diffusion(args, ds, dev)
    model.load_state_dict(load_checkpoint(ckpt))
    model.to(dev).eval()
    model_fn = classifier_free_guidance(model, args.cond_mask_prob)
    shape = (EV_BATCH, ds.pose_dim, 1, T2M_FRAMES)

    def sample_fn(generator, cond):
        return p_sample_loop(diffusion, model_fn, shape, cond, generator=generator,
                             clip_denoised=False)

    counted, _ = launch_counter({"encoder_layer": fused_encoder_layer,
                                 "flash_attention": fused_self_attention})
    ds.rng.setstate(order)
    t0 = time.perf_counter()
    gen, launches = counted(lambda: GeneratedMotionSet(
        sample_fn, ds, text_encoder=get_text_encoder(device=dev), scale=GUIDANCE, renorm=renorm,
        seed=0, num_samples_limit=EV_BATCH, device=dev).batches)
    gen_s = time.perf_counter() - t0
    steps = diffusion.num_timesteps
    want = {"encoder_layer": LAYERS * steps, "flash_attention": LAYERS * steps}
    ok = launches == want and np.isfinite(gen[0]["motions"]).all()
    log(f"{'OK' if ok else 'FAIL'} closed loop: a generated batch of {EV_BATCH} from phase 12's "
        f"checkpoint (CFG batch {2 * EV_BATCH}, {steps} DDPM steps) in {gen_s:.3f} s; launches "
        f"{launches} (expected {want}) {card}")
    if not ok:
        raise AssertionError("the generated batch missed its kernels or is not finite")
    scores = {}
    for name, w in (("retrained", loaded), ("random", random_ev)):
        np.random.seed(0)
        means = evaluation(w, gt, {"vald": lambda rep: (gen, {})},
                           os.path.join(out_dir, f"eval_{name}.log"), replication_times=1,
                           diversity_times=EV_DIVERSITY)
        scores[name] = {k: means[f"{k}_vald"] for k in ("FID", "R_precision", "Matching Score")}
        scores[name]["FID_ground truth"] = means["FID_ground truth"]
    finite = all(np.isfinite(np.asarray(v)).all() for s in scores.values() for v in s.values())
    log(f"{'OK' if finite else 'FAIL'} closed loop: the generated batch scored by evaluation(): "
        + "; ".join(f"{n} evaluators FID {s['FID']:.4f} (ground truth {s['FID_ground truth']:.4f}"
                    f"), R-precision {np.round(s['R_precision'], 4).tolist()}, matching score "
                    f"{s['Matching Score']:.4f}" for n, s in scores.items()) + f" {card}")
    if not finite:
        raise AssertionError("the closed loop's metrics are not finite")

    with torch.no_grad():
        a2m_same = all(torch.equal(a2m_loaded.classifier.state_dict()[k], v.to(dev))
                       for k, v in trained["a2m"].state_dict().items())
    a2m = {}
    for name, ev in (("retrained", a2m_loaded), ("random", A2MEvaluation(device=dev))):
        m = ev.evaluate({"gt": [a2m_batches["gt"]], "gen": [a2m_batches["gen"]]})
        a2m[name] = {k: m[k] for k in ("accuracy_gt", "accuracy_gen", "fid_gen")}
    finite = all(np.isfinite(v) for s in a2m.values() for v in s.values())
    log(f"{'OK' if a2m_same and finite else 'FAIL'} closed loop: the a2m tar through "
        f"A2M_CLASSIFIER_PATH loads the trained classifier bit for bit; phase 14's seed-0 "
        f"batches: " + "; ".join(f"{n} classifier {s}" for n, s in a2m.items()) + f" {card}")
    if not (a2m_same and finite):
        raise AssertionError("the retrained a2m classifier does not read back or score")
    return launches


def seed_dropout_phase(tmodel, diffusion, cfg, randn, rs, card):
    """Phase 19 (d): TRAIN_STEPS gesture train steps at batch BATCH (MB a
    microbatch) through kernels 5 and 6 from the same weights, in four runs
    with GDT_SEED_DROPOUT unset, 1, 1, unset (an order effect falls on both
    sides alike): every run's losses, first-step gradients and weights after
    the last step bit for bit the first's; peak memory and ms a step of each
    run, the bytes autograd saved in a step (saved_tensors_hooks) for both.
    Returns the launches of the four runs."""
    import torch

    from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        encoder_layer_train_bwd,
        encoder_layer_train_fwd,
    )
    from gesturediffusion_tpu_torch.train.loop import make_train_state, train_step

    dev = torch.device("cuda")
    mask = torch.ones((BATCH, 1, 1, T), dtype=torch.bool, device=dev)
    batches = [dict(motion=randn(BATCH, J, 1, T, scale=0.5),
                    cond={"mfcc": randn(BATCH, A, 1, T), "seed": randn(BATCH, J, 1, S, scale=0.5),
                          "mask": mask},
                    t=torch.from_numpy(rs.randint(0, 1000, size=BATCH)).to(dev),
                    noise=randn(BATCH, J, 1, T)) for _ in range(TRAIN_STEPS)]
    counted, total = launch_counter({"encoder_layer_train_fwd": encoder_layer_train_fwd,
                                     "encoder_layer_train_bwd": encoder_layer_train_bwd})
    runs, saved = [], {}
    before = os.environ.pop("GDT_SEED_DROPOUT", None)
    try:
        for flag in ("unset", "1", "1", "unset"):
            os.environ.pop("GDT_SEED_DROPOUT", None)
            if flag == "1":
                os.environ["GDT_SEED_DROPOUT"] = "1"
            model = copy.deepcopy(tmodel)
            (losses, grads, ms, (peak, above)), launches = counted(
                lambda: run_train_steps(model, diffusion, cfg, batches))
            if flag not in saved:
                sizes = []
                probe = copy.deepcopy(tmodel)
                state = make_train_state(probe, cfg, UniformSampler(1000), None)
                gen = torch.Generator(device=dev).manual_seed(7)
                b = batches[0]
                with torch.autograd.graph.saved_tensors_hooks(
                        lambda x: sizes.append(x.numel() * x.element_size()) or x, lambda x: x):
                    train_step(state, diffusion, cfg, b["motion"], b["cond"], gen, b["t"],
                               b["noise"])
                del probe, state
                saved[flag] = sum(sizes)
            runs.append(dict(flag=flag, losses=losses, grads=grads, ms=ms, peak=peak,
                             above=above, launches=launches,
                             weights={k: v.clone() for k, v in model.state_dict().items()}))
    finally:
        os.environ.pop("GDT_SEED_DROPOUT", None)
        if before is not None:
            os.environ["GDT_SEED_DROPOUT"] = before
    a = runs[0]
    want = LAYERS * (BATCH // MB) * TRAIN_STEPS
    same = all(b["losses"] == a["losses"]
               and all(torch.equal(a["grads"][k], b["grads"][k]) for k in a["grads"])
               and all(torch.equal(a["weights"][k], b["weights"][k]) for k in a["weights"])
               for b in runs[1:])
    ok = same and all(r["launches"] == {"encoder_layer_train_fwd": want,
                                        "encoder_layer_train_bwd": want} for r in runs)
    log(f"{'OK' if ok else 'FAIL'} seed-redrawn dropout: {TRAIN_STEPS} gesture train steps at "
        f"batch {BATCH} ({BATCH // MB} x {MB}, [{MB},{T + 1},{D}]) in four runs, "
        f"GDT_SEED_DROPOUT unset, =1, =1, unset: losses "
        + " / ".join(str(r["losses"]) for r in runs) + f", the first step's {len(a['grads'])} "
        f"gradients and the last weights {'bit for bit equal' if same else 'DIFFER'}; launches "
        + " / ".join(str(r["launches"]) for r in runs) + f" (expected {want} each)")
    if not ok:
        raise AssertionError("GDT_SEED_DROPOUT=1 changed the training step or missed kernels 5/6")
    for flag in ("unset", "1"):
        mine = [r for r in runs if r["flag"] == flag]
        log(f"time seed-redrawn dropout, GDT_SEED_DROPOUT {flag}: "
            + " and ".join(f"{r['ms']:.3f}" for r in mine)
            + f" ms a step (median of steps 2-{TRAIN_STEPS}, runs in the order unset, 1, 1, "
            f"unset); peak memory " + " and ".join(f"{r['peak']:.1f}" for r in mine)
            + " MiB (" + " and ".join(f"{r['above']:.1f}" for r in mine)
            + f" above the start); autograd saved {saved[flag] / 2**20:.3f} MiB in a step {card}")
    return total


def native_phase(card):
    """Phase 19 (e): the host C library built with the system compiler, held
    against the port's numpy collate, which it does not serve: the motion
    and MFCC batches and the mask of MB gesture items at the released widths
    (J 498, MFCC 26, 80 frames) as collate_gesture fills them by numpy and
    as JAX's collate fills them through the library (JAX
    data/collate.py:28-31,47-57), byte-equal; ms a batch of both fills, in
    PAIRS pairs whose order alternates, median and range."""
    import numpy as np

    from gesturediffusion_tpu_torch.data import native
    from gesturediffusion_tpu_torch.data.collate import collate_gesture, lengths_to_mask

    lib = native.get_lib()
    if lib is None:
        raise AssertionError("the native data library did not build (see the log line above)")
    rs = np.random.RandomState(190)
    items = [{"motion": rs.randn(int(rs.randint(60, T + 20)), J).astype(np.float32),
              "length": T, "mfcc": rs.randn(T + 20, A).astype(np.float32),
              "seed": rs.randn(S, J).astype(np.float32),
              "audio": rs.randn(T * 735).astype(np.float32), "text": f"take {i}"}
             for i in range(MB)]
    lengths = np.asarray([min(int(it["length"]), T) for it in items], np.int32)

    def fill(by_library):
        out = []
        for key in ("motion", "mfcc"):
            c = items[0][key].shape[1]
            dst = np.zeros((MB, c, 1, T), np.float32)
            zeros, ones = np.zeros(c, np.float32), np.ones(c, np.float32)
            for i, it in enumerate(items):
                src = it[key][:T]
                if by_library:
                    dst[i, :, 0, :] = native.window_znorm_transpose(src, 0, T, zeros, ones)
                else:
                    dst[i, :, 0, :src.shape[0]] = src.T
            out.append(dst)
        out.append(native.lengths_to_mask_native(lengths, T) if by_library
                   else lengths_to_mask(lengths, T))
        return out

    motion, cond = collate_gesture(items, T)
    want = [motion, cond["mfcc"], cond["mask"][:, 0, 0]]
    same = all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
               for side in (fill(True), fill(False)) for a, b in zip(side, want))
    times = {"library": [], "numpy": []}
    for r in range(PAIRS):
        for name in (("library", "numpy") if r % 2 == 0 else ("numpy", "library")):
            t0 = time.perf_counter()
            fill(name == "library")
            times[name].append((time.perf_counter() - t0) * 1e3)
    spans = {n: (sorted(v)[len(v) // 2], min(v), max(v)) for n, v in times.items()}
    log(f"{'OK' if same else 'FAIL'} native: {native.library_path()} built by "
        f"{os.environ.get('CC', 'cc')}; the motion, MFCC and mask fills of {MB} items (J {J}, "
        f"MFCC {A}, {T} frames) through it byte-equal to collate_gesture's numpy fills: {same}; "
        + ", ".join(f"{n} {m:.3f} ms a batch (range {lo:.3f}-{hi:.3f})"
                    for n, (m, lo, hi) in spans.items())
        + f", medians of {PAIRS} pairs in alternating order {card}")
    if not same:
        raise AssertionError("the native library's fills differ from collate_gesture's")


def evaluator_phase(randn, rs, card, a2m_batches, tmodel, tdiffusion, tcfg):
    """Phase 19: the CompV6 baseline, the evaluator trainers and the closed
    loop on phase 12's humanml tree, the seed-redrawn dropout on the phase-5
    model, the native collate library.  Returns the main paths' launches by
    kernel."""
    root = os.path.join(HERE, "build", "chip_smoke", "t2m_train", "humanml")  # phase 12's
    t0 = time.perf_counter()
    comp_v6_phase(root, card)
    trained = trainers_phase(root, a2m_batches["gt"], card)
    loop = closed_loop_phase(root, trained, a2m_batches, card)
    dropout = seed_dropout_phase(tmodel, tdiffusion, tcfg, randn, rs, card)
    native_phase(card)
    log(f"phase 19 in {time.perf_counter() - t0:.1f} s {card}")
    return {**loop, **dropout}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.models.mdm import MDM
    from gesturediffusion_tpu_torch.ops import _build
    from gesturediffusion_tpu_torch.ops.fused_encoder import (
        encoder_layer_plain,
        fused_encoder_layer,
    )
    from gesturediffusion_tpu_torch.ops.flash_attention import fused_self_attention
    from gesturediffusion_tpu_torch.ops.fused_local_block import (
        fused_local_block,
        pre_encoder_local_block,
    )
    from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
    from gesturediffusion_tpu_torch.train.loop import TrainState, make_optimizer, train_step

    # ---- 1. device ----------------------------------------------------- #
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {kind} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)  # name, power limit as nvidia-smi prints them
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    card = f"[{smi}]"
    dev = torch.device("cuda")

    # ---- 2. build ------------------------------------------------------ #
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {len(reports)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "Compiling entry")):
                log(f"  {name}: {line.strip()}")
    for lib in ("encoder_layer_train", "band_attention", "local_block"):
        sass = tensor_core_sass(lib)
        if not sass:
            log(f"sass {lib}: not measured (no cuobjdump beside nvcc)")
        for fn, ops in sorted(sass.items()):
            product = any(k in fn for k in (
                "gemm_tf32x3_kernel", "flash_attention_kernel", "attn_bwd_dq_kernel",
                "attn_bwd_dkdv_kernel", "band_attention_kernel", "local_block_kernel",
                "flash_wide_kernel", "band_wide_kernel", "attn_bwd_dq_wide_kernel",
                "attn_bwd_dkdv_wide_kernel"))
            if not product:
                continue
            log(f"sass {lib} {fn[:110]}: TF32 HGMMA x{ops['HGMMA']}, HMMA x{ops['HMMA']} of "
                f"{ops['all']} instructions")
            if not (ops["HGMMA"] or ops["HMMA"]):
                raise AssertionError(f"{fn}: a product kernel without TF32 tensor-core instructions")

    torch.set_grad_enabled(False)
    rs = np.random.RandomState(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * scale).to(dev)

    # ---- 3. kernel parity at the main-path shapes ---------------------- #
    bb = 2 * B_TAKES
    xs, coa = randn(bb, T, D), randn(bb, D)
    lb_plain = pre_encoder_local_block(xs, coa, num_heads=CL_HEADS, window_size=WINDOW)
    lb_kernel = fused_local_block(xs, coa, num_heads=CL_HEADS, window=WINDOW)
    torch.cuda.synchronize()
    lb_err = (lb_kernel - lb_plain).abs().max().item()
    ok = lb_kernel.shape == (bb, T + 1, D) and lb_err <= TOL_LOCAL_BLOCK
    log(f"{'OK' if ok else 'FAIL'} local_block [{bb},{T},{D}]->[{bb},{T + 1},{D}] "
        f"heads {CL_HEADS} w {WINDOW}: max|diff| {lb_err:.3e} (tol {TOL_LOCAL_BLOCK:g})")
    if not ok:
        raise AssertionError("local_block kernel disagrees with its plain version")

    xe = randn(bb, T + 1, D)
    enc_w = layer_weights(randn, D, FF)
    enc_plain = encoder_layer_plain(xe, *enc_w, num_heads=HEADS)
    enc_kernel = fused_encoder_layer(xe, *enc_w, num_heads=HEADS)
    torch.cuda.synchronize()
    enc_err = (enc_kernel - enc_plain).abs().max().item()
    ok = enc_kernel.shape == xe.shape and enc_err <= TOL_ENCODER
    log(f"{'OK' if ok else 'FAIL'} encoder_layer [{bb},{T + 1},{D}] heads {HEADS} ff {FF}: "
        f"max|diff| {enc_err:.3e} (tol {TOL_ENCODER:g})")
    if not ok:
        raise AssertionError("encoder_layer kernel disagrees with its plain version")

    seed = torch.tensor([20240], dtype=torch.int32, device=dev)
    train_x = {t: (randn(MB, t, D), randn(MB, t, D)) for t in TRAIN_ROWS}
    train_errs = [check_train_layer(x_, g_, enc_w, seed) for x_, g_ in train_x.values()]
    train_fwd_err = max(e[0] for e in train_errs)
    train_bwd_err = max(e[1] for e in train_errs)
    xt, gt = train_x[T + 1]
    # a data rank's share of a global batch: rank 1 of 2 at phase 18's 128 rows
    off_fwd_err, off_bwd_err = check_train_layer(xt, gt, enc_w, seed, row0=MB)
    train_fwd_err = max(train_fwd_err, off_fwd_err)
    train_bwd_err = max(train_bwd_err, off_bwd_err)
    edge_lb_err, edge_band_err = band_edges_parity(randn)
    lb_err = max(lb_err, edge_lb_err)
    c1_errs = c1_widths_parity(randn, seed)
    enc_err = max(enc_err, c1_errs["encoder_layer"])
    train_fwd_err = max(train_fwd_err, c1_errs["encoder_layer_train_fwd"])
    train_bwd_err = max(train_bwd_err, c1_errs["encoder_layer_train_bwd"])

    # ---- 4. main path: full-width CFG chunked-AR take ------------------ #
    torch.manual_seed(0)
    model = MDM(njoints=J, latent_dim=D, ff_size=FF, num_layers=LAYERS,
                num_heads=HEADS, cond_mask_prob=0.1, seed_poses=S, mfcc_dim=A,
                cl_head=CL_HEADS, window_size=WINDOW).to(dev).eval()
    diffusion = create_diffusion(noise_schedule="cosine", steps=1000,
                                 timestep_respacing=RESPACING, device=dev)
    assert diffusion.num_timesteps == STEPS
    chunk_conds = {
        "mfcc": randn(CHUNKS, B_TAKES, A, 1, T),
        "scale": torch.full((CHUNKS, B_TAKES), GUIDANCE, device=dev),
    }
    init_seed = randn(B_TAKES, J, 1, S, scale=0.5)

    def take(seed: int) -> torch.Tensor:
        return run_take(model, diffusion, chunk_conds, init_seed, seed)

    fused_local_block.launches = 0
    fused_encoder_layer.launches = 0
    fused_self_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = take(1)
    first_s = time.perf_counter() - t0
    launches = {"local_block": fused_local_block.launches,
                "encoder_layer": fused_encoder_layer.launches,
                "flash_attention": fused_self_attention.launches}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    # the encoder layer's attention stage is the flash kernel at every length
    want = {"local_block": STEPS * CHUNKS, "encoder_layer": STEPS * CHUNKS * LAYERS,
            "flash_attention": STEPS * CHUNKS * LAYERS}
    log(f"take: out {tuple(out.shape)} finite={bool(torch.isfinite(out).all())} "
        f"launches {launches} (expected {want}); first run {first_s:.3f} s")
    if tuple(out.shape) != (CHUNKS, B_TAKES, J, 1, T) or not torch.isfinite(out).all():
        raise AssertionError("take output has the wrong shape or non-finite values")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")

    t0 = time.perf_counter()
    take(1)
    kernel_take_s = time.perf_counter() - t0
    model.use_kernels = False
    t0 = time.perf_counter()
    out_plain = take(1)
    plain_take_s = time.perf_counter() - t0
    model.use_kernels = True
    take_err = (out - out_plain).abs().max().item()
    ok = take_err <= TOL_TAKE
    log(f"{'OK' if ok else 'FAIL'} take vs plain versions on the card: max|diff| "
        f"{take_err:.3e} (tol {TOL_TAKE:g}; |out| max {out_plain.abs().max().item():.3f})")
    if not ok:
        raise AssertionError("kernel take disagrees with the plain take")

    ckpt_dir = os.path.join(HERE, "build", "chip_smoke", "run")
    os.makedirs(ckpt_dir, exist_ok=True)
    model_path = os.path.join(ckpt_dir, "model000000000.pt")
    torch.save(model.state_dict(), model_path)
    motion, cli_s = generate_cli(
        model_path, {"dataset": "synthetic", "num_frames": T, "layers": LAYERS,
                     "latent_dim": D, "cond_mask_prob": 0.1, "seed_poses": S,
                     "noise_schedule": "cosine", "diffusion_steps": 1000,
                     "sigma_small": True},
        T, B_TAKES, RESPACING, os.path.join(ckpt_dir, "samples"))
    cli_ok = motion.shape == (B_TAKES, J // 6, 3, T) and np.isfinite(motion).all()
    log(f"{'OK' if cli_ok else 'FAIL'} generate CLI on the card: motion "
        f"{motion.shape} in {cli_s:.1f} s (process included)")
    if not cli_ok:
        raise AssertionError("generate CLI output has the wrong shape or non-finite values")

    # ---- 5. training: steps, plain comparison, train CLI -------------- #
    tmodel, tdiffusion, tcfg, tbatch = train_phase(dev, randn, rs, card)
    train_launches = train_cli_phase(card)

    # ---- 6. times ------------------------------------------------------ #
    lb_ms = cuda_time_ms(
        lambda: fused_local_block(xs, coa, num_heads=CL_HEADS, window=WINDOW))
    lb_device_ms = device_ms(
        lambda: fused_local_block(xs, coa, num_heads=CL_HEADS, window=WINDOW),
        "local_block_kernel", iters=100)
    lb_plain_ms = cuda_time_ms(
        lambda: pre_encoder_local_block(xs, coa, num_heads=CL_HEADS, window_size=WINDOW))
    lb_lib_ms = cuda_time_ms(lambda: local_block_sdpa(xs, coa, CL_HEADS, WINDOW))
    dh = D // CL_HEADS
    keys = sum(i - max(0, (i // WINDOW - 1) * WINDOW) + 1 for i in range(T))
    lb_flops = bb * CL_HEADS * keys * dh * 4 + 3 * bb * (2 * T + 1) * D
    lb_bytes = 4 * (bb * T * D + bb * D + bb * (T + 1) * D)
    lb_bound, lb_by = bound_ms(lb_flops, lb_bytes)

    enc_ms = cuda_time_ms(lambda: fused_encoder_layer(xe, *enc_w, num_heads=HEADS))
    enc_plain_ms = cuda_time_ms(lambda: encoder_layer_plain(xe, *enc_w, num_heads=HEADS))
    enc_lib_ms = cuda_time_ms(lambda: encoder_layer_sdpa(xe, *enc_w, HEADS))
    m = bb * (T + 1)
    enc_flops = 2 * m * (4 * D * D + 2 * D * FF) + 4 * bb * (T + 1) ** 2 * D
    enc_bytes = 4 * (2 * m * D + sum(w.numel() for w in enc_w))
    enc_bound, enc_by = bound_ms(enc_flops, enc_bytes, tf32x3=True)

    train_times = {t: train_kernel_times(*train_x[t], enc_w, seed) for t in (T + 1, T_CLI + 1)}
    layer_kernels = layer_kernel_names(xt, gt, enc_w, seed)
    ok = all(train_kernel_group(n) for n in layer_kernels)
    log(f"{'OK' if ok else 'FAIL'} device kernels of one encoder_layer_train_fwd and _bwd "
        f"launch (the port's own, none from a library): {sorted(layer_kernels)}")
    if not ok:
        raise AssertionError("a product of the training layer ran outside the port's kernels")

    time_line("local_block", lb_ms, lb_plain_ms, lb_lib_ms, lb_bound, lb_by, lb_flops, lb_bytes,
              card)
    log(f"time local_block kernel's device time (profiler, the wrapper's host work left out): "
        f"{lb_device_ms:.4f} ms, {lb_bound / lb_device_ms:.3f} of the bound {card}")
    time_line(f"encoder_layer [{bb},{T + 1},{D}]", enc_ms, enc_plain_ms, enc_lib_ms, enc_bound,
              enc_by, enc_flops, enc_bytes, card, tf32x3=True)
    for t, tt in train_times.items():
        time_line(f"encoder_layer_train_fwd [{MB},{t},{D}]", *tt["fwd"], card, tf32x3=True)
        time_line(f"encoder_layer_train_bwd [{MB},{t},{D}] (plain and library: forward + "
                  f"backward)", *tt["bwd"], card, tf32x3=True)
    n_steps = STEPS * CHUNKS
    log(f"time take ({B_TAKES} takes x {CHUNKS} chunks x {STEPS} DDPM steps, CFG batch {bb}): "
        f"kernels {kernel_take_s:.3f} s = {B_TAKES * CHUNKS / kernel_take_s:.3f} chunks/s, "
        f"{kernel_take_s / n_steps * 1e3:.3f} ms/step; plain {plain_take_s:.3f} s = "
        f"{B_TAKES * CHUNKS / plain_take_s:.3f} chunks/s, "
        f"{plain_take_s / n_steps * 1e3:.3f} ms/step {card}")
    log(f"peak memory (counted take): {peak_mib:.1f} MiB {card}")
    profile_denoise_step(model, diffusion, chunk_conds, init_seed, card)
    tstate = TrainState(tmodel, *make_optimizer(tmodel.parameters(), tcfg),
                        UniformSampler(1000), {})
    tgen = torch.Generator(device=dev).manual_seed(3)

    def one_train_step():
        train_step(tstate, tdiffusion, tcfg, tbatch["motion"], tbatch["cond"], tgen,
                   tbatch["t"], tbatch["noise"])

    device_profile(one_train_step, 2, f"train step (batch {BATCH} = {BATCH // MB} x {MB})",
                   card, host_rows=8, groups=train_kernel_group)

    # ---- 7. long chunks: band and flash kernels, T = 1200 take, CLI ---- #
    long_rows, long_launches = long_chunk_phase(model, model_path, enc_w, randn, card)
    # launches of the two sampling paths: the 80-frame take, then the long take
    long_rows[1]["launches"] += launches["flash_attention"]
    long_rows[0]["max_abs_err"] = max(long_rows[0]["max_abs_err"], edge_band_err)
    long_rows[1]["max_abs_err"] = max(long_rows[1]["max_abs_err"], c1_errs["flash_attention"])

    # ---- 8. the widths the kernels pad or slice, end to end ------------ #
    c1_model_phase(randn, os.path.dirname(ckpt_dir), card)
    c1_model_phase(randn, os.path.dirname(ckpt_dir), card, d=D_WIDE, cli=False)
    wide_times(randn, card)

    # ---- 9. the GENEA data path and streaming serve -------------------- #
    genea = genea_serve_phase(model, model_path, card)

    # ---- 10. text-to-motion sampling and motion editing ---------------- #
    t2m_rows, t2m, gesture_edit = t2m_phase(
        randn, os.path.join(HERE, "build", "chip_smoke", "genea", "model000000000.pt"), card)

    # ---- 11. the PLMS and DPM++ samplers -------------------------------- #
    samplers = samplers_phase(model, model_path, chunk_conds, init_seed, randn, card)

    # ---- 12. text-to-motion training ----------------------------------- #
    t2m_train_rows, t2m_train, t2m_big = t2m_train_phase(randn, rs, card)
    # the predict CLI on the trained checkpoint runs at [6, 197, 512], the
    # batch of prompts at [64, 197, 512]
    t2m_rows[0]["launches"] += t2m_train["encoder_layer"] - t2m_big["encoder_layer"]
    t2m_rows[1]["launches"] += t2m_big["encoder_layer"]

    # ---- 13. action-to-motion training ---------------------------------- #
    a2m_rows, a2m = a2m_train_phase(randn, rs, card)

    # ---- 14. action-to-motion evaluation and the train CLI's eval hook -- #
    a2m_eval_row, a2m_eval = a2m_eval_phase(randn, card)
    for row, k in ((a2m_rows[0], "encoder_layer_train_fwd"),
                   (a2m_rows[1], "encoder_layer_train_bwd")):
        row["launches"] += a2m_eval[f"a2m_{k}"]

    # ---- 15. text-to-motion evaluation and the humanml eval hook -------- #
    t2m_eval_row, t2m_eval = t2m_eval_phase(randn, card)
    t2m_rows[1]["launches"] += t2m_eval["encoder_layer_64"]        # [64, 197, 512]
    t2m_train_rows[3]["launches"] += t2m_eval["flash_attention_64"]  # [64, 4, 197, 128]
    t2m_train_rows[0]["launches"] += t2m_eval["encoder_layer_train_fwd"]
    t2m_train_rows[1]["launches"] += t2m_eval["encoder_layer_train_bwd"]

    # ---- 16. the mesh export: predict -> SMPLify -> meshes, rot6d, HumanIK -- #
    mesh = mesh_phase(card)
    t2m_rows[0]["launches"] += mesh["encoder_layer"]          # [6, 197, 512]
    t2m_train_rows[2]["launches"] += mesh["flash_attention"]  # [6, 4, 197, 128]

    # ---- 17. the wav-encoder MDM and MDMOld: takes, training, times ---- #
    wav_old = wav_old_phase(model, chunk_conds, init_seed, randn, card)

    # ---- 18. the multi-rank paths: NCCL at one rank, two ranks on gloo -- #
    par = parallel_phase(model_path, card)

    # ---- 19. CompV6, evaluator retraining, seed-redrawn dropout, native collate -- #
    ev19 = evaluator_phase(randn, rs, card, a2m_eval["batches"], tmodel, tdiffusion, tcfg)
    t2m_rows[1]["launches"] += ev19["encoder_layer"]          # [64, 197, 512]
    t2m_train_rows[3]["launches"] += ev19["flash_attention"]  # [64, 4, 197, 128]

    kernels = [
        {"name": "local_block", "route": "cuda",
         "source": "gesturediffusion_tpu_torch/csrc/local_block.cu",
         "replaces": "gesturediffusion_tpu/ops/pallas_local_block.py:82",
         "launches": launches["local_block"] + genea["local_block"]
                     + gesture_edit["local_block"] + samplers["local_block"]
                     + a2m_eval["local_block"] + wav_old["local_block"]
                     + par["local_block"],
         "max_abs_err": lb_err,
         "ms": lb_ms, "device_ms": lb_device_ms, "plain_ms": lb_plain_ms,
         "bound_ms": lb_bound, "bound_by": lb_by, "library_ms": lb_lib_ms},
        {"name": "encoder_layer", "route": "cuda",
         "source": "gesturediffusion_tpu_torch/csrc/encoder_layer.cu",
         "replaces": "gesturediffusion_tpu/ops/pallas_encoder.py:98",
         "launches": (launches["encoder_layer"] + long_launches["encoder_layer"]
                      + genea["encoder_layer"] + gesture_edit["encoder_layer"]
                      + samplers["encoder_layer"] + a2m_eval["encoder_layer"]
                      + wav_old["encoder_layer"] + par["encoder_layer"]),
         "max_abs_err": enc_err,
         "ms": enc_ms, "plain_ms": enc_plain_ms, "bound_ms": enc_bound,
         "bound_by": enc_by, "library_ms": enc_lib_ms},
        {"name": "encoder_layer_train_fwd", "route": "cuda",
         "source": "gesturediffusion_tpu_torch/csrc/encoder_layer_train.cu",
         "replaces": "gesturediffusion_tpu/ops/pallas_encoder_train.py:249",
         "launches": (train_launches[0] + genea["encoder_layer_train_fwd"]
                      + a2m_eval["encoder_layer_train_fwd"]
                      + wav_old["encoder_layer_train_fwd"]
                      + par["encoder_layer_train_fwd"] + ev19["encoder_layer_train_fwd"]),
         "max_abs_err": train_fwd_err,
         **time_keys(train_times[T + 1]["fwd"])},
        {"name": "encoder_layer_train_bwd", "route": "cuda",
         "source": "gesturediffusion_tpu_torch/csrc/encoder_layer_train.cu",
         "replaces": "gesturediffusion_tpu/ops/pallas_encoder_train.py:273",
         "launches": (train_launches[1] + genea["encoder_layer_train_bwd"]
                      + a2m_eval["encoder_layer_train_bwd"]
                      + wav_old["encoder_layer_train_bwd"]
                      + par["encoder_layer_train_bwd"] + ev19["encoder_layer_train_bwd"]),
         "max_abs_err": train_bwd_err,
         **time_keys(train_times[T + 1]["bwd"])},
        *long_rows,
    ]
    kernels[-1]["launches"] += (genea["flash_attention"] + t2m["flash_attention"]
                                + samplers["flash_attention"] + a2m["flash_attention"]
                                + a2m_eval["flash_attention"] + t2m_eval["flash_attention"]
                                + wav_old["flash_attention"] + par["flash_attention"])
    kernels += t2m_rows + t2m_train_rows + a2m_rows + [a2m_eval_row, t2m_eval_row]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(sys.argv[2]))
    sys.exit(main())
