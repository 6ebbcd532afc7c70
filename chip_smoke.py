#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device   -- needs torch.cuda.is_available(); prints the card's name and
               power limit (nvidia-smi).
2. build    -- compiles every csrc/*.cu with nvcc (first use, one nvcc per
               source, in parallel); prints each kernel's registers and
               spills from ptxas (-Xptxas -v), by kernel and template.
3. kernels  -- each hand-written kernel against its plain PyTorch version on
               the card, in bf16, at the full-width shapes the served path
               gives it (B=64): the block conv at every conv of Mixed_5b and
               Mixed_6b and at both blocks' packed and pooled 1x1 launches
               (tile, ms from Python and graph_ms in CUDA graphs, each with
               its share of the bound, beside bf16 F.conv2d and the cuDNN
               engine's f32-on-bf16 conv), the Inception-A block
               (Mixed_5b/5c/5d) and the Inception-B block (Mixed_6b/6c/6e)
               beside the cuDNN engine's blocks.  Then the bf16 train-mode
               batch norm's Triton kernels (ops/batch_norm: bn_bf16_sums,
               _finish, _normalize, _grad_sums, _grad) at the tower's
               batch-normed conv outputs at 128 rows (149x149x32,
               147x147x64, 35x35x288, 17x17x768, 8x8x2048): the sums within
               f32 summation-order error, the normalisation and the input
               gradient bit-equal, two launches bit-equal; ms and graph_ms
               beside the bytes' bound.
4. e2e      -- the served program image_server(FusedInceptionV3(state,
               use_kernels=True)) on 3 uint8 [64,347,347,3] batches with
               seeded full-width weights; launch counts (5 and 8 block-conv
               launches per Inception-A/B block), probabilities, and
               logits/top-1 against the f32 slim tower (TF32 off); img/s of
               the kernel engine and of the cuDNN engine (use_kernels=False).
5. kernel_check conv_int8 -- the int8 engine's conv kernel against its
               plain version (float64 conv, exact) on the card, bit for bit,
               at one conv of each (kernel shape, stride, padding, epilogue
               kinds, tile configuration) the served int8 path issues, with
               that conv's real input (B=64, full width), and through
               valid_conv3x3_int8_shift at Conv2d_2a and Conv2d_4a; each row
               gives the tile, its time launched from Python between CUDA
               events (ms) and in a CUDA graph (graph_ms, device time), and
               the share of the bound each reaches.
6. kernel_check maxpool3x3s2_int8 -- the int8 max pool, exact, at K4a's own
               shape and the four served shapes (two with the rescale).
7. e2e_int8 -- the default served program build_forward(cfg, state,
               engine="int8", front="s2d", calib_images=...) on the same 3
               batches: launch counts (66 convs + 4 pools per forward, none
               on the conv's byte-load path), every
               stage's int8 activations equal to the same engine's plain
               path on the card (same scales), probabilities within
               INT8_PROB_TOL of it; quantization_delta against the bf16
               kernel engine; img/s of the int8, bf16 kernel and cuDNN
               engines.
8. e2e_joint -- the slice's main path: build_forward(joint_finetune,
               joint_state, engine="int8", front="s2d") (the int8 tower, the
               mean text branch over a 50,000 x 200 embedding, the fusion
               head) on the same 3 batches, each with seeded [64,50] tokens
               (lengths 0 to 50, one row all pad): launch counts (66 convs +
               4 pools per forward, none on the byte-load path), finite rows
               summing to 1, probabilities within INT8_PROB_TOL of the same
               runner on the plain int8 engine; top-1 agreement with the
               parity (f32) joint runner, reported; img/s of the joint and
               the image-only int8 runners, alternating.
9. e2e_uint8 -- the int8 image runner behind the all-int8 uint8 front:
               preprocess_for_eval_int8 on the card (torch._int_mm resize)
               against its CPU plain version, every stage equal to the plain
               engine's, launch counts, img/s beside the s2d front's.
10. pool_int8 -- the engine with pool_mode="int8" against its plain version
               on the card, every stage and the features equal.
11. text_rnn -- the rnn text model at full width (V 50,000, D 200, H 256,
               T 50, batch 64) on the card against the same module on the
               CPU.
12. e2e_http -- the slice-6 main path: EmotionHTTPServer (port 0) over
               BatchedPredictor (batch 64, host_size 347) over
               build_forward(joint_finetune, engine="int8", front="s2d") at
               full width, with a 50,000-word Vocabulary from
               build_vocabulary over a seeded word list.  Every committed
               fixture JPEG (tests/data/jpeg) decodes and resizes on this
               machine's g++ build to the hashes the manifest recorded from
               the JAX package's decode and PIL, at full size and at
               scale_num 1-7 under every dct_method (host decode img/s at 8
               threads at scale_num 1, 2, 4 and 8); 192 concurrent POSTs from 64
               client threads (fixture bodies, seeded captions in ?text= and
               X-Text) each answer the in-process runner's top and
               probabilities (1e-5) on the same decoded image and caption;
               66 conv_int8 + 4 maxpool3x3s2_int8 launches per device batch;
               /healthz reports cuda, /stats at least 3 batches and no error;
               a corrupt body sent with 15 good ones gets a 400 and they
               get their answers; the batch-1 Predictor on two fixtures at native
               size agrees with the f32 parity runner, and its eager program's
               first and repeated calls against the same program captured
               (ms, peak memory).  Prints posts/s, p50
               and p99 latency, and the host decode+resize img/s (8 threads).
13. train_joint -- the training main path: Trainer(joint_finetune,
               preprocess="train") at full width (Inception-v3 depth 1.0, 299
               px, aux head, dropout keep 0.8; vocab 50,000 x 200, mean,
               max_len 50; batch 32; RMSProp lr 1e-4, decay 0.9, eps 1.0,
               momentum 0.9, L2 4e-5) from seeded weights and seeded uint8
               [32,347,347,3] batches made on the card: fit for 8 steps, then
               evaluate over 3 batches, the last half padding (weight 0).
               Every loss finite; every trainable leaf and every BN statistic
               moved, the unused tower Logits bias not, its weights where an
               L2-only replay of the optimizer puts them; evaluate's count,
               accuracy and confusion equal to the CPU's on the same batches
               and state; one step at batch 4 (dropout off, the same
               distortion draws) against the same step on the CPU (loss
               within TRAIN_LOSS_RTOL, the updates within TRAIN_NOISE_FACTOR of
               the CPU's own f32 noise floor); the trained state served by
               the int8 program (66 conv_int8 + 4 maxpool3x3s2_int8 launches
               per forward), top-1 against the f32 parity runner.  Prints
               steps/s, examples/s, peak memory, ms per step split into
               preprocess / forward+backward / update (CUDA events) and the
               step's f32 bound.
14. train_image_frozen -- image_frozen (Logits, AuxLogits trainable) at full
               width, 4 steps: every parameter outside the two scopes
               bit-unchanged, every BN statistic moved.
15. train_text -- text_only (Adam, batch 64) at full width, 4 steps, the
               first held against the CPU.
16. cli     -- the main path: python -m tumblr_emotions_torch.cli at
               full width from records on disk.  A posts CSV of 400 seeded
               captions over the fixture JPEGs -> convert-dataset (4 TFRecord
               shards, a validation split) and build-vocab, in process; train
               --preset joint_finetune --batch-size 32 --steps 6
               --checkpoint-every 3 as run A, and as run B (--steps 3, then
               --steps 6 in a second process that resumes), each a
               subprocess: every logged loss finite, B resumed at step 3 with
               its input position, B's step-3 checkpoint restored on the card
               gives back every saved tensor, the step-6 input positions
               equal, A's and B's step-3 parameters within TRAIN_NOISE_FACTOR
               of train_joint's noise floor (the step-6 distance printed,
               not held: the steps after the resume are not compared here);
               eval (subprocess) equal in count, accuracy and confusion to
               Trainer.evaluate on the CPU; export-checkpoint's slim bundle
               holding the checkpoint's tower bit for bit; infer --engine
               int8 --front s2d in process over the train split (6 device
               batches, img/s of the real rows; 66 conv_int8 + 4
               maxpool3x3s2_int8 per forward, probabilities within
               INT8_PROB_TOL of the plain int8 engine from the same checkpoint
               and calibration batch); the serve stack (cli.build_server) in
               process answering 64 concurrent posts within HTTP_PROB_TOL of
               its runner, 66 + 4 launches per device batch; predict
               (subprocess) against the Predictor.  Prints the time split,
               the checkpoint's bytes and write seconds and infer's img/s.
    analyze -- the CLI's analyze on run A's checkpoint over the validation
               records, with --examples: the circumplex within ANALYZE_TOL of
               the one of the CPU's probabilities, every emotion's section in
               the report.
17. train_perf, train_dp -- perf-mode training of the data_parallel preset
               (every batch-normed conv's batch norm kernels launched on
               each step of fit, no served kernel), and two processes on
               the card.
captured -- run before e2e_http: every served runner (int8 s2d, uint8 and
               float fronts, bf16 cuDNN, bf16 with the block kernels, joint
               int8, text rnn) at full width, batch 64, as one CUDA graph per
               batch (utils/compile_opts.capture) against the same program
               launched op by op: bit-equal on the 3 batches, one graph
               launch per batch, each graph's kernel nodes (read from the
               graph by name) against the eager program's launches per
               forward, img/s of both
               interleaved over CAPTURED_WINDOWS windows on the host clock,
               idle share and kernels per batch from a trace, peak memory.
               e2e_http then serves the captured joint program.
tune     -- cli tune --engine int8 --batch-size 64 (eager against captured),
               then again from its cache.
parity   -- cli parity on a full-width slim checkpoint (1001 classes, aux
               head, seeded weights): goldens saved on the CPU pass on the
               card within PARITY_TOL; goldens moved by 0.01 fail (rc 1).
train_embeddings -- SGNS word2vec at V 50,000, D 200, B 1024, K 5 on a seeded
               Zipf corpus, at the command's learning rate: steps/s, the host
               sampler's share, the loss; the first steps against the CPU at a
               rate whose update stands well above the tolerance.
full_mode -- slim's full-mode train distortions on uint8 [32,347,347,3] on
               the card against the CPU on the same draws; ms against fast
               mode.
divisions -- f32 preprocess_for_eval on the card bit-equal to the CPU's (all
               256 byte values, a seeded [8,347,347,3] batch), the input scale
               of the int8 engine calibrated on the card equal to the CPU's,
               Adam's bias-corrected update equal to the CPU's.
train_captured -- the main path of training: Trainer.compile's train and
               eval steps as captured CUDA graphs, bit-equal to the eager
               steps over 8 steps for f32 joint_finetune (batch 32), the
               image_frozen adam override, text_only and the data_parallel
               preset in perf mode at 128 rows (one process, and on a
               world-size-1 NCCL group); one graph launch per step, no
               served kernel in any train graph, the batch norm kernels
               once a step in the perf cases' train graph and none
               elsewhere, ms per step and peak memory
               captured against eager, the trace's idle share; a restore
               under capture equal to the straight run.
tune_train -- cli tune --step train at batch 64, then from its cache.
accuracy_smoke -- the synthetic accuracy benchmark's text run (200 steps)
               near its Bayes ceiling; 50 steps of its end-to-end image run,
               whose loss falls.
kernels -- one JSON line listing every ported kernel (launches from
               Python by path; on the card, with each CUDA graph's kernel
               nodes times its replays, and the replays, by path).

Launch counts: every served runner is a captured program, so each served
path is counted from its runner's first call, which runs eagerly (the
warm-up, counted by the wrappers); a replay runs no Python, and the graph's
kernels are read from the graph itself (served_launches).

The last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import sys
import time

from tumblr_emotions_torch.timing import cuda_ms, graph_ms

SEED = 0
DEVICE = "cuda"
DEPTH = 1.0                   # full width
BATCH = 64
N_BATCHES = 3
SRC_HW = 347                  # decoded image size; the 0.875 crop is real
H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_INT8_OPS = 1979e12       # dense int8 tensor-core peak
H100_F32_FLOPS = 67e12        # f32 outside the tensor cores
H100_BYTES_S = 3.35e12        # HBM3

# Kernel vs plain version, bf16 on both sides; both accumulate in f32 and
# round once per conv, in another summation order, so an output may land
# one bf16 ulp (at most 2^-7 of its magnitude) apart; a block chains up to 5
# such roundings, where a flipped intermediate moves later outputs by far
# less than an ulp.  Tolerance on max|kernel - plain| / max|plain|:
KERNEL_TOL = 2.0 ** -6
# The bf16 served path against the f32 tower: bf16 is rounded after every
# conv (~0.4% each, ~20 convs deep), measured 0.8% of max|logit| at depth
# 0.5 on the CPU.  Tolerance on max|dlogit| / max|logit_f32|:
LOGIT_TOL = 0.05
# Top-1 must agree on every image whose f32 top-1 margin exceeds twice the
# logit tolerance (images with a smaller margin may legitimately flip), and
# on at least this share of all images:
TOP1_MIN_SHARE = 0.95

# The int8 kernel and the plain engine run the same integer and rounded
# float arithmetic, so the served probabilities agree up to the heads'
# summation order, which is shared too:
INT8_PROB_TOL = 1e-6
STAGES = ("stem", "Mixed_5d", "Mixed_6a", "Mixed_6e", "Mixed_7a")
# The uint8 front on the card (torch._int_mm) against its CPU plain version
# (float64 GEMMs): both GEMMs are exact and the float steps are the same
# rounded multiplies and adds, so equal; allowed, as the CPU tests allow
# against the reference, one int8 level on this share of the elements:
FLOAT_SITE_SHARE = 1e-3
# The rnn text model on the card against the same module on the CPU, f32
# with TF32 off, 50 LSTM steps: max|d| / max|feature|:
TEXT_TOL = 1e-5
TEXT_T = 50                   # joint_finetune's max_len

# e2e_http: posts in the concurrent wave, client threads, the server's
# latency bound, the served answers against the in-process runner (the
# responses are rounded to 5 decimals), and the batch-1 Predictor against
# the f32 parity runner on the same image (both f32 with TF32 off, one
# program, so as close as TEXT_TOL).
HTTP_POSTS = 3 * BATCH
HTTP_CLIENTS = 64
HTTP_MAX_DELAY_MS = 50.0
HOST_SIZE = 347
HTTP_PROB_TOL = 1e-5
PREDICT_TOL = 1e-5
FIXTURES = "tests/data/jpeg"
DCT_METHODS = ("islow", "ifast", "float")

# Training (train_joint, train_image_frozen, train_text).  The card's step
# against the same step on the CPU: the loss is a forward pass, f32 with TF32
# off on both, so it agrees to summation order (TF32 would move it ~1e-3);
# the updates of the whole tower are not that steady in f32 (train-mode
# batch norm over 4 images amplifies rounding: a 1e-7 move of the weights
# moves one step's update by ~1%), so the card's distance to the CPU,
# ||card - cpu|| / ||cpu - init|| over the leaves, is held within
# TRAIN_NOISE_FACTOR of the CPU's own floor: the mean distance of its update
# to its updates from weights moved by TRAIN_NOISE_EPS of themselves and
# each image's brightness by TRAIN_NOISE_EPS (one run per seed of
# TRAIN_NOISE_SEEDS), about the rounding by which cuDNN's f32 convs and the
# CPU's differ (1.0e-6 to 1.7e-6 of the output's scale, tumblr_emotions_torch/
# op_grads.py); the card's rounding differs image by image, which batch
# centring does not cancel as it cancels much of a move of the weights.  The text model is steady: per leaf within TEXT_UPDATE_TOL of
# its update.
TRAIN_STEPS = 8
TRAIN_EVAL_BATCHES = 3
TRAIN_SIDE_STEPS = 4
TRAIN_CPU_BATCH = 4
TRAIN_LOSS_RTOL = 1e-4
TRAIN_NOISE_FACTOR = 3.0
TRAIN_NOISE_EPS = 1e-6
TRAIN_NOISE_SEEDS = (1, 2, 3)
TEXT_UPDATE_TOL = 1e-3
# Phase 17, train_perf: the data_parallel preset (bf16 on f32 masters) at
# full width, PERF_BATCH rows per process (the preset's 1024 over the
# reference's 8-device mesh), PERF_STEPS steps of fit beside a world-size-1
# NCCL group (one process runs the plain step), the profiler hook over
# steps PERF_PROFILE (start, count); a batch-4 perf step on the card held to
# the CPU's within TRAIN_NOISE_FACTOR of the CPU's own floor (bf16 rounding
# flips where the f32 sums differ, and train-mode batch norm over 4 images
# amplifies them).
PERF_BATCH = 128
PERF_STEPS = 8
PERF_PROFILE = (6, 2)
PERF_CPU_BATCH = 4
# the distorted images, f32 in [-1, 1]: two f32 programs of the same
# distortions (tests/test_torch_train_preprocessing.py's JIT_TOL)
PERF_IMAGE_ATOL = 1e-4
# 8 f32 roundings of the larger of a parameter before and after its update
PERF_UPDATE_RTOL = 2.0 ** -20
# Phase 18, train_dp: two processes on the one card (gloo), the joint model
# at DP_DEPTH, global batch DP_BATCH, DP_FIRST steps + checkpoint + restart
# + the rest of DP_STEPS, against one process; DP_LR keeps the steps near
# the initial weights, so gradients are compared, not chaotic trajectories.
DP_DEPTH = 0.25
DP_VOCAB = 1000
DP_BATCH = 16
DP_SRC = 347
DP_LR = 1e-6
DP_FIRST, DP_STEPS = 3, 5
DP_TIMEOUT_S = 600
# Phase 16, cli: the CLI from records on disk at full width.
CLI_POSTS = 400
CLI_SHARDS = 4
CLI_VALID = 0.1               # the validation split's share (md5 of the post id)
CLI_BATCH = 32
CLI_STEPS = 6
CLI_CKPT_EVERY = 3
CLI_SERVE_POSTS = 64
CLI_TIMEOUT_S = 600           # each CLI subprocess
# workers: the record pipeline at each worker count, over this many batches
WORKER_COUNTS = (0, 2, 4)
WORKER_BATCHES = 24
# analyze's circumplex (printed to 4 decimals) against the one of the CPU's
# probabilities over the same split: rounding plus the card's f32 forward
ANALYZE_TOL = 1e-3

# Phase captured: every served runner as one CUDA graph per batch against
# the same program launched op by op (bit for bit), img/s over
# CAPTURED_WINDOWS interleaved windows of CAPTURED_PASSES passes over the
# batches.
CAPTURED_WINDOWS = 5
CAPTURED_PASSES = 2
CAPTURED_TRACE_PASSES = 3
EAGER = {"cuda_graph": "false"}
# Phase parity: the full-width slim tower (1001 classes, aux head) on
# PARITY_N seeded uint8 images, goldens from the CPU, the gate on the card
# at the reference's budget.
PARITY_N = 8
PARITY_TOL = 1e-4
# Phase train_embeddings: SGNS at the width train-embeddings runs (V 50,000,
# D 200, B 1024, K 5) on a seeded Zipf corpus; W2V_STEPS timed steps at the
# command's learning rate (0.025: the objective is a mean over the batch, as
# in the reference, so from 6 ln 2 with W_out at zero the loss moves below
# f32's resolution in 200 steps; the line prints it).  The first
# W2V_CHECK_STEPS against the CPU on the same batches, at W2V_CHECK_LR so
# that the update (update_max_abs, ~1e-4) stands at least W2V_UPDATE_FACTOR
# times above W2V_TOL: the gathers' gradients sum in another order on the
# card, so the two agree to f32 rounding of the updates.
W2V_VOCAB, W2V_DIM, W2V_BATCH, W2V_NEG = 50_000, 200, 1024, 5
W2V_POSTS, W2V_WORDS = 20_000, 20
W2V_STEPS = 200
W2V_CHECK_STEPS = 20
W2V_CHECK_LR = 25.0
W2V_TOL = 1e-6
W2V_UPDATE_FACTOR = 50
# Phase train_captured: each case TRAIN_CAPTURED_STEPS steps eager, then as
# many captured, from one state and seeds, held bit-equal; the f32 joint
# case restored from its step-RESTORE_AT checkpoint under capture.
TRAIN_CAPTURED_STEPS = 8
RESTORE_AT = 4
# Phase tune_train: cli tune --step train at this batch.
TUNE_TRAIN_BATCH = 64
# Phase accuracy_smoke: the synthetic benchmark's text run for ACC_TEXT_STEPS
# steps, within ACC_TEXT_TOL of its Bayes ceiling (68.27%; the reference's
# text run converges by step 200), and ACC_IMAGE_STEPS of its end-to-end
# image run, whose loss falls.
ACC_TEXT_STEPS = 200
ACC_TEXT_TOL = 0.03
ACC_IMAGE_STEPS = 50
# Phase full_mode: slim's full-mode distortions on FULL_BATCH uint8 images
# on the card against the CPU on the same draws, within PERF_IMAGE_ATOL
# away from hue-sector crossings.
FULL_BATCH = 32

REPLACES = "tumblr_emotions_tpu/ops/fused_inception.py"
# The block conv's pooled form (the 3x3 average pool fused into Branch_3's
# 1x1): a template of the same kernel, listed and counted apart.
POOLED = "conv_same_bias_relu pooled"
# Each launch count's kernel functions, by their mangled names in a captured
# CUDA graph (``Captured.kernel_nodes``).  The blocks (fused_inception_a/b)
# are plans of conv_bf16_wgmma launches with no node of their own.
GRAPH_KERNELS = {
    "conv_int8": r"conv_int8_(wgmma|bytes)",
    "conv_int8 byte path": r"conv_int8_bytes",
    "maxpool3x3s2_int8": r"maxpool_(vec|scalar)_kernel",
    "conv_same_bias_relu": r"conv_bf16_wgmma",
    POOLED: r"conv_bf16_wgmmaILi\d+ELi\d+ELb1E",   # template <BM, BN, POOL = true>
}
# Launches per forward of the int8 programs (66 convs, 4 pools) and of the
# bf16 program with the block kernels (3 Inception-A and 4 Inception-B
# blocks, plans of 5 and 8 block-conv launches, 7 of them pooled).
INT8_PER_FORWARD = {"conv_int8": 66, "maxpool3x3s2_int8": 4}
BF16_PER_FORWARD = {"fused_inception_a": 3, "fused_inception_b": 4,
                    "conv_same_bias_relu": 3 * 5 + 4 * 8, POOLED: 7}
# path -> the CUDA graphs' part of its run (``served_launches``).
GRAPH_RUNS: dict = {}
# The bf16 train-mode batch norm's Triton kernels (ops/batch_norm), each
# counted by its wrapper (``_bn_wrappers``): launches per batch-normed conv
# in one train step, forward and backward (two statistics passes, three
# finishing sums, the normalisation, the gradient's sums, the input
# gradient), over the BN_LAYERS batch-normed convs of the tower and aux head.
BN_PER_LAYER = {"bn_bf16_sums": 2, "bn_bf16_finish": 3, "bn_bf16_normalize": 1,
                "bn_bf16_grad_sums": 1, "bn_bf16_grad": 1}
BN_LAYERS = 96
# The tower's batch-normed conv outputs (H = W, C) the kernels are checked
# at, at PERF_BATCH rows; the statistics within BN_SUM_RTOL of the sum of
# the magnitudes summed (f32 summation-order error), as the card test holds.
BN_SHAPES = ((149, 32), (147, 64), (35, 288), (17, 768), (8, 2048))
BN_SUM_RTOL = 1e-5
# path -> the train graphs' batch norm nodes times their replays, with the
# launches from Python (``check_bn_launches``).
BN_GRAPH_RUNS: dict = {}


T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets the seconds since the
    script started (``elapsed_s``)."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.perf_counter() - T0, 1))
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def bound(flops: float, nbytes: float, peak: float = H100_BF16_FLOPS) -> dict:
    """Least time on an H100 SXM: the larger of the operations over the
    peak rate and the bytes (each input read once, each output written
    once) over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes}


def compare(name: str, got, want, tol: float) -> float:
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    if rel > tol:
        fail(f"{name}: max|err| {err} = {rel} of max|plain| > {tol}")
    return err


def served_launches(phase: str, launches: dict, graphs, forwards: int,
                    per_forward: dict, byte_path: int = 0) -> dict:
    """Check what a served program ran over ``forwards`` forwards, counted
    from before its first call: ``per_forward`` launches each (every other
    count 0; ``byte_path`` of the int8 convs on the byte-load kernel).
    ``graphs``: the captured program's ``kernel_nodes()`` (None for a program
    run eagerly).  A captured program's first call of a signature runs
    eagerly, as a warm-up whose launches the wrappers count; its later calls
    replay the graph, whose kernel nodes, read from the graph by name, must
    be one forward's.
    The eager forwards and the replays together are ``forwards``, and the
    wrappers launched each kernel at least once.  Adds the byte-load count to
    ``launches``; returns the graphs' part: their number, replays, kernel
    nodes, and the launches on the card (the wrappers' plus each graph's
    nodes times its replays)."""
    import re

    from tumblr_emotions_torch.ops import int8_conv as ic

    launches["conv_int8 byte path"] = ic.conv_int8.byte_launches
    want = {k: per_forward.get(k, 0) for k in launches}
    want["conv_int8 byte path"] = byte_path if per_forward.get("conv_int8") else 0
    captured = graphs is not None
    graphs = [({k: sum(n for name, n in g["kernels"].items() if re.search(pat, name))
                for k, pat in GRAPH_KERNELS.items()}, g["replays"]) for g in graphs or []]
    replays = sum(r for _, r in graphs)
    eager = forwards - replays
    if eager < 1 or (captured and eager != len(graphs)):
        fail(f"{phase}: {forwards} forwards, {len(graphs)} graphs replayed {replays} times")
    if launches != {k: v * eager for k, v in want.items()}:
        fail(f"{phase}: launch counts {launches}, expected {want} per eager forward "
             f"({eager})")
    for nodes, _ in graphs:
        if nodes != {k: want[k] for k in GRAPH_KERNELS}:
            fail(f"{phase}: a graph holds {nodes}, expected one forward's {want}")
    return {"graphs": len(graphs), "replays": replays,
            "kernel_nodes_per_graph": [nodes for nodes, _ in graphs],
            "device_launches": {k: launches[k] + sum(n[k] * r for n, r in graphs)
                                for k in GRAPH_KERNELS}}


def conv_bound(x, w, outs) -> dict:
    """Least time of one int8 conv: ops at the int8 tensor-core peak, bytes
    of the input, the weights, the outputs and the per-channel constants."""
    B, H, W, cin = x.shape
    cout, kh, kw, _ = w.shape
    _, ho, wo, _ = outs[0].shape
    m = B * ho * wo
    nbytes = B * H * W * cin + w.numel() + sum(o.numel() * o.element_size() for o in outs)
    return bound(2.0 * m * cout * kh * kw * cin, nbytes + 16.0 * cout, peak=H100_INT8_OPS)


def ptxas_report(log: str) -> list:
    """Registers and spills of each kernel in an ``-Xptxas -v`` log, by
    name with its template's arguments (``conv_int8_wgmma<16,128,64>``)."""
    import re

    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            mangled, name = m.group(1), m.group(1)
            # The mangled name holds "<length><name>" then "I...E" template args.
            for n in re.finditer(r"(\d+)(?=[A-Za-z_])", mangled):
                digits, at = n.group(1), n.end()
                lens = [int(digits[i:]) for i in range(len(digits))]
                cand = next((mangled[at:at + k] for k in lens
                             if mangled[at:at + k].startswith(("conv_", "maxpool", "avg_pool"))
                             and at + k <= len(mangled)), None)
                if cand:
                    rest = mangled[at + len(cand):]
                    args = re.findall(r"L[ib](\d+)(?=E)", rest.split("EEv")[0] + "E") \
                        if rest.startswith("I") else []
                    name = cand + (f"<{','.join(args)}>" if args else "")
                    break
            out.append({"kernel": name})
        elif out and "registers" in ln:
            out[-1]["ptxas"] = ln.split(":", 1)[-1].strip()
        elif out and "spill" in ln:
            out[-1]["spills"] = ln.strip()
    return out


def record_calls(obj, name: str, log: list, label):
    """Wrap ``obj.name`` so each call appends (label(), args, kwargs) to
    ``log``; returns a function that restores it."""
    orig = getattr(obj, name)

    def wrapped(*a, **k):
        log.append((label(), a, k))
        return orig(*a, **k)

    setattr(obj, name, wrapped)
    return lambda: setattr(obj, name, orig)


def int8_phases(dev, state, batches, smi, img_s, eng_k, eng_c):
    """Phases 5-7: the int8 kernels at the served shapes, then the served
    int8 program.  Returns ({kernel: [per-shape rows]}, launches, the int8
    runner, its calibration batch)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.data.preprocessing import (
        preprocess_for_eval, preprocess_for_eval_s2d)
    from tumblr_emotions_torch.models.layers import to_nchw
    from tumblr_emotions_torch.ops import int8_conv as ic
    from tumblr_emotions_torch.ops import int8_pool as ip
    from tumblr_emotions_torch.ops import quant
    from tumblr_emotions_torch.ops.serving import build_forward

    cfg = get_preset("fused_inference")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=DEPTH))
    calib = preprocess_for_eval(batches[0])
    runner = build_forward(cfg, state, engine="int8", front="s2d", calib_images=calib,
                           device=dev)
    eng = runner.engine
    rows = {"conv_int8": [], "maxpool3x3s2_int8": []}

    def record(kernel, **r):
        rows[kernel].append(r)
        emit({"phase": "kernel_check", "kernel": kernel, **r})

    # One forward with every conv and pool call recorded, with its input.
    ops = eng.int8_ops()
    scope = ["input"]

    def label():
        return scope[0]

    for meth in ("conv", "conv_s2d", "packed"):
        orig = getattr(ops, meth)

        def tagged(t, scopes, *a, _orig=orig, **k):
            scope[0] = scopes if isinstance(scopes, str) else "+".join(scopes)
            return _orig(t, scopes, *a, **k)

        setattr(ops, meth, tagged)
    convs, pools = [], []
    undo = [record_calls(ops, "_conv", convs, label),
            record_calls(ops, "_pool", pools, label)]
    x0 = preprocess_for_eval_s2d(batches[0])
    eng(x0)
    torch.cuda.synchronize()
    for u in undo:
        u()
    for meth in ("conv", "conv_s2d", "packed"):
        delattr(ops, meth)

    # ---- 5. conv_int8: one conv of each distinct form and tile, and K1's own entry ----
    def check_conv(label_, x, w, epi, strides, pad, fn=None, plain=None, first_of_form=True):
        # ms, library_ms, bf16_conv2d_ms: calls launched from Python between
        # CUDA events (a small conv's time is then its wrapper's host time);
        # the *graph_ms beside them: device time in CUDA graphs.  A given fn
        # (K1's own entry point) uploads constants per call, which a graph
        # cannot capture: its graph time is conv_int8's on the same operands.
        kernel = lambda: ic.conv_int8(x, w, epi, strides, pad)  # noqa: E731
        fn = fn or kernel
        plain = plain or (lambda: ic.conv_int8_plain(x, w, epi, strides, pad))
        got, want = fn(), plain()
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        torch.cuda.synchronize()
        err = 0.0
        for g, wt in zip(got, want):
            if g.dtype != wt.dtype or g.shape != wt.shape:
                fail(f"conv_int8 {label_}: {g.dtype} {tuple(g.shape)} != {wt.dtype} {tuple(wt.shape)}")
            d = (g.float() - wt.float()).abs()
            if g.dtype == torch.bfloat16:    # one bf16 ulp at most
                if (d > wt.float().abs() * 2.0 ** -8).any():
                    fail(f"conv_int8 {label_}: dequant output beyond one bf16 ulp")
            elif d.max().item() != 0:
                fail(f"conv_int8 {label_}: max|kernel - plain| {d.max().item()} != 0")
            err = max(err, d.max().item())
        B, H, W_, cin = x.shape
        cout, kh, kw, _ = w.shape
        lib, lib_graph, lib_note = None, None, None
        if (kh, kw) == (1, 1) and tuple(strides) == (1, 1):
            a2 = x.reshape(-1, cin) if x.is_contiguous() else x.contiguous().reshape(-1, cin)
            b2 = w.reshape(cout, cin).t()
            try:
                lib = cuda_ms(lambda: torch._int_mm(a2, b2))
                lib_graph = graph_ms(lambda: torch._int_mm(a2, b2))
                lib_note = "torch._int_mm of the same [M,Cin]x[Cin,Cout] product (no epilogue)"
            except RuntimeError as e:
                lib_note = f"torch._int_mm refused: {str(e)[:120]}"
        xb = to_nchw(x).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wb = w.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bf16 = lambda: F.conv2d(xb, wb, stride=tuple(strides), padding=tuple(pad))  # noqa: E731
        ms, g_ms, b = cuda_ms(fn), graph_ms(kernel), conv_bound(x, w, got)
        record("conv_int8", shape=f"{label_} [{B},{H},{W_},{cin}]->{cout} k{(kh, kw)} "
               f"s{tuple(strides)} p{tuple(pad)} {'/'.join(epi.kinds)}",
               tile=ic.conv_config(x, w, strides, pad).name, first_of_form=first_of_form,
               max_abs_err=err, tol=0, ms=ms, graph_ms=g_ms,
               timing="ms, library_ms, bf16_conv2d_ms: 20 calls launched from Python "
                      "between CUDA events; graph_ms, library_graph_ms, "
                      "bf16_conv2d_graph_ms: a CUDA graph of 20 calls (device time)",
               plain_ms=cuda_ms(plain, iters=5, warmup=1),
               pct_of_bound=100.0 * b["bound_ms"] / ms,
               graph_pct_of_bound=100.0 * b["bound_ms"] / g_ms,
               library_ms=lib, library_graph_ms=lib_graph, library_note=lib_note,
               bf16_conv2d_ms=cuda_ms(bf16), bf16_conv2d_graph_ms=graph_ms(bf16),
               bf16_conv2d_note="bf16 F.conv2d of the same shape: not the same function", **b)

    # One row per (form, tile); the first of each form is the set of shapes
    # the kernels line sums over (one conv per form, as the check began).
    seen, forms = set(), set()
    for lab, a, k in convs:
        x, w, epi, strides, pad = a[:5]
        form = (tuple(w.shape[1:3]), tuple(strides), tuple(pad), epi.kinds)
        key = form + (ic.conv_config(x, w, strides, pad),)
        if key in seen:
            continue
        seen.add(key)
        check_conv(lab, x, w, epi, strides, pad, first_of_form=form not in forms)
        forms.add(form)
    rng = np.random.RandomState(SEED)
    for lab, a, k in convs:
        if lab not in ("Conv2d_2a_3x3", "Conv2d_4a_3x3"):
            continue
        x, w, epi = a[:3]
        if epi.kinds == ("shift",):
            b_i, k_i = epi.bias_i.cpu().numpy(), epi.shift.cpu().numpy()
        else:    # the site fell back to f32: K1's shift epilogue on made-up constants
            b_i = rng.randint(0, 5000, w.shape[0]).astype(np.int32)
            k_i = rng.randint(6, 12, w.shape[0]).astype(np.int32)
        w_hwio = w.permute(1, 2, 3, 0).contiguous()
        epi_s = ic.Epilogue.build([("shift", w.shape[0], b_i, k_i)], dev)
        check_conv(f"valid_conv3x3_int8_shift {lab}", x, w, epi_s, (1, 1), (0, 0),
                   fn=lambda x=x, w_hwio=w_hwio, b_i=b_i, k_i=k_i:
                   ic.valid_conv3x3_int8_shift(x, w_hwio, b_i, k_i),
                   plain=lambda x=x, w=w, epi_s=epi_s: ic.conv_int8_plain(x, w, epi_s))

    # ---- 6. maxpool3x3s2_int8: K4a's own shape and the served shapes ----
    g = torch.Generator(device=dev).manual_seed(SEED)
    k4a = torch.randint(-128, 128, (BATCH, 147, 147, 32), generator=g, device=dev,
                        dtype=torch.int8)
    served = ("MaxPool_3a_3x3", "MaxPool_5a_3x3", "Mixed_6a/Branch_2", "Mixed_7a/Branch_2")
    for lab, x, r in [("K4a MaxPool_3a shape (random)", k4a, None)] + [
            (name, a[0], a[1]) for name, (_, a, _) in zip(served, pools)]:
        got, want = ip.maxpool3x3s2_int8(x, r), ip.maxpool3x3s2_int8_plain(x, r)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if err != 0:
            fail(f"maxpool3x3s2_int8 {lab}: max|kernel - plain| {err} != 0")
        try:
            lib = cuda_ms(lambda: F.max_pool2d(to_nchw(x), 3, 2))
            lib_note = "F.max_pool2d on int8"
        except RuntimeError as e:
            lib, lib_note = None, f"F.max_pool2d refuses int8 on the card: {str(e)[:120]}"
        b = bound(8.0 * got.numel(), x.numel() + got.numel(), peak=H100_F32_FLOPS)
        ms, g_ms = (cuda_ms(lambda: ip.maxpool3x3s2_int8(x, r)),
                    graph_ms(lambda: ip.maxpool3x3s2_int8(x, r)))
        record("maxpool3x3s2_int8", shape=f"{lab} {list(x.shape)} rescale={r}",
               served=lab in served, max_abs_err=err, tol=0, ms=ms, graph_ms=g_ms,
               pct_of_bound=100.0 * b["bound_ms"] / ms,
               graph_pct_of_bound=100.0 * b["bound_ms"] / g_ms,
               timing="ms: 20 calls launched from Python between CUDA events; graph_ms: "
                      "a CUDA graph of 20 calls (device time)",
               plain_ms=cuda_ms(lambda: ip.maxpool3x3s2_int8_plain(x, r), iters=5, warmup=1),
               library_ms=lib, library_note=lib_note, **b)
    del convs, pools

    # ---- 7. e2e_int8: the default served program, counted from its first
    # call (the warm-up: per-site constants, allocator, the capture) ----
    reset_all_launches()
    for batch in batches:
        runner(batch)
    probs = [runner(raw) for raw in batches]
    torch.cuda.synchronize()
    launches = all_launches()
    GRAPH_RUNS["e2e_int8"] = served_launches("e2e_int8", launches, runner.program.kernel_nodes(),
                                             2 * N_BATCHES, INT8_PER_FORWARD)
    for p in probs:
        if p.shape != (BATCH, 15) or not torch.isfinite(p).all():
            fail(f"int8 probabilities: shape {tuple(p.shape)} or non-finite")
        if (p.sum(-1) - 1).abs().max().item() > 1e-3:
            fail("int8 probability rows do not sum to 1")

    plain = quant.QuantizedInceptionV3(state, calib, stem_s2d="pre", use_kernels=False,
                                       device=dev)
    stage_diff = stage_mismatches("e2e_int8", eng, plain, x0)
    pdiff = 0.0
    for raw, p in zip(batches, probs):
        ref_p, _ = plain(preprocess_for_eval_s2d(raw))
        pdiff = max(pdiff, (p - torch.softmax(ref_p, -1)).abs().max().item())
    if pdiff > INT8_PROB_TOL:
        fail(f"e2e_int8: probabilities {pdiff} from the plain engine > {INT8_PROB_TOL}")
    delta = quant.quantization_delta(state, preprocess_for_eval(batches[1]),
                                     calibration_images=calib, device=dev,
                                     stem_s2d="pre")
    kinds = list(eng.last_epilogue_kinds.values())
    emit({"phase": "e2e_int8", "batch": BATCH, "batches": N_BATCHES, "src_hw": SRC_HW,
          "launches": launches, "graphs": GRAPH_RUNS["e2e_int8"],
          "stage_int8_mismatches_vs_plain": stage_diff,
          "prob_max_abs_diff_vs_plain": pdiff, "prob_tol": INT8_PROB_TOL,
          "epilogue_kinds": {k: kinds.count(k) for k in sorted(set(kinds))},
          "quantization_delta_vs_bf16_kernels": delta,
          "img_s_int8": img_s(eng), "img_s_bf16_kernels": img_s(eng_k),
          "img_s_cudnn": img_s(eng_c), "card": smi})
    return rows, launches, runner, calib


def check_int8_launches(phase: str, launches: dict, byte_path: int = 0,
                        forwards: int = N_BATCHES) -> None:
    """66 conv_int8 and 4 maxpool3x3s2_int8 launches per forward (of
    ``forwards``), no other kernel, and ``byte_path`` of the convs per
    forward on the byte-load kernel."""
    from tumblr_emotions_torch.ops import int8_conv as ic

    want = {"conv_int8": 66 * forwards, "maxpool3x3s2_int8": 4 * forwards}
    if {k: launches[k] for k in want} != want or any(
            v for k, v in launches.items() if k not in want):
        fail(f"{phase}: launch counts {launches}, expected {want} and no others")
    if ic.conv_int8.byte_launches != byte_path * forwards:
        fail(f"{phase}: {ic.conv_int8.byte_launches} launches on conv_int8's byte-load "
             f"kernel, expected {byte_path * forwards}")
    launches["conv_int8 byte path"] = ic.conv_int8.byte_launches


def stage_mismatches(phase: str, eng, plain, x) -> dict:
    """Elements of each stage's int8 activations where the kernel engine and
    the plain engine (same scales) differ; fails unless all are 0."""
    import torch

    from tumblr_emotions_torch.ops import quant

    plain.scales = eng.scales
    diff = {}
    with torch.inference_mode():
        for stop in STAGES:
            got = quant._tower(eng.int8_ops(), x, stop_at=stop)
            ref = quant._tower(plain.int8_ops(), x, stop_at=stop)
            if got[1] != ref[1]:
                fail(f"{phase} {stop}: scale {got[1]} != {ref[1]}")
            diff[stop] = int((got[0] != ref[0]).sum().item())
    if any(diff.values()):
        fail(f"{phase}: int8 activations differ from the plain engine: {diff}")
    return diff


def joint_phases(dev, state, batches, smi, serve_rate, runner, calib):
    """Phases 8-11: the joint program (this slice's main path), the uint8
    front, pool_mode="int8" and the rnn text model.  Returns {path:
    launches}."""
    import numpy as np
    import torch

    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval_s2d
    from tumblr_emotions_torch.data.vocab import synthetic_ids
    from tumblr_emotions_torch.models import build_model, joint_model, text_model
    from tumblr_emotions_torch.ops import quant
    from tumblr_emotions_torch.ops.serving import build_forward, joint_server

    rng = np.random.RandomState(SEED + 1)
    paths = {}

    # ---- 8. e2e_joint: the joint_finetune program, int8 tower ----
    cfg = get_preset("joint_finetune")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=DEPTH))
    t0 = time.perf_counter()
    joint_state = joint_model.init_state(build_model(cfg, device="meta"), SEED)
    tower = joint_model.tower_state(joint_state)   # the image tower served above
    if tower.keys() != state.keys() or any(not torch.equal(tower[k], v) for k, v in state.items()):
        fail("e2e_joint: the joint state's tower differs from the image state")
    tokens = [torch.from_numpy(synthetic_ids(rng, BATCH, TEXT_T, cfg.text.vocab_size)).to(dev)
              for _ in batches]
    jrun = build_forward(cfg, joint_state, engine="int8", front="s2d", calib_images=calib,
                         device=dev)
    setup_s = time.perf_counter() - t0
    reset_all_launches()
    for raw, tok in zip(batches, tokens):      # warm-up, the capture
        jrun(raw, tok)
    probs = [jrun(raw, tok) for raw, tok in zip(batches, tokens)]
    torch.cuda.synchronize()
    launches = all_launches()
    GRAPH_RUNS["e2e_joint"] = served_launches("e2e_joint", launches, jrun.program.kernel_nodes(),
                                              2 * N_BATCHES, INT8_PER_FORWARD)
    paths["e2e_joint"] = launches
    for p in probs:
        if p.shape != (BATCH, 15) or not torch.isfinite(p).all():
            fail(f"e2e_joint probabilities: shape {tuple(p.shape)} or non-finite")
        if (p.sum(-1) - 1).abs().max().item() > 1e-5:
            fail("e2e_joint probability rows do not sum to 1")
    model = build_model(cfg, device=dev)
    model.load_state_dict(joint_state)
    plain = quant.QuantizedInceptionV3(tower, calib, stem_s2d="pre", use_kernels=False,
                                       device=dev)
    plain.scales = jrun.engine.scales
    plain_srv = joint_server(plain, model, device=dev)
    pdiff = max((p - plain_srv(raw, tok)).abs().max().item()
                for p, raw, tok in zip(probs, batches, tokens))
    if pdiff > INT8_PROB_TOL:
        fail(f"e2e_joint: probabilities {pdiff} from the plain engine > {INT8_PROB_TOL}")
    stages = stage_mismatches("e2e_joint", jrun.engine, plain,
                              preprocess_for_eval_s2d(batches[0]))
    parity = build_forward(cfg, joint_state, engine="parity", device=dev)
    agree = sum(int((p.argmax(-1) == parity(raw, tok).argmax(-1)).sum())
                for p, raw, tok in zip(probs, batches, tokens))
    del parity
    lens = torch.cat([(t != 0).sum(-1) for t in tokens])
    rates = {"int8": [], "joint": []}
    for name in ("int8", "joint", "joint", "int8"):
        rates[name].append(serve_rate(
            (lambda i: runner(batches[i])) if name == "int8" else
            (lambda i: jrun(batches[i], tokens[i]))))
    emit({"phase": "e2e_joint", "config": "joint_finetune", "depth": DEPTH,
          "vocab": cfg.text.vocab_size, "embed": cfg.text.embed_dim,
          "aggregator": cfg.text.aggregator, "max_len": TEXT_T, "batch": BATCH,
          "batches": N_BATCHES, "src_hw": SRC_HW, "setup_s": setup_s,
          "lengths_min_max": [int(lens.min()), int(lens.max())],
          "launches": launches, "graphs": GRAPH_RUNS["e2e_joint"],
          "stage_int8_mismatches_vs_plain": stages,
          "prob_max_abs_diff_vs_plain": pdiff, "prob_tol": INT8_PROB_TOL,
          "all_pad_row_finite": all(bool(torch.isfinite(p[0]).all()) for p in probs),
          "top1_agree_vs_parity": agree / (BATCH * N_BATCHES),
          "img_s_joint": rates["joint"], "img_s_int8_image_only": rates["int8"],
          "img_s_order": "int8, joint, joint, int8", "card": smi})
    del jrun, plain, plain_srv, model

    # ---- 9. e2e_uint8: the int8 image runner behind the uint8 front ----
    icfg = get_preset("fused_inference")
    icfg = icfg.replace(image=icfg.image.replace(depth_multiplier=DEPTH))
    urun = build_forward(icfg, state, engine="int8", front="uint8", calib_images=calib,
                         device=dev)
    eng = urun.engine
    s_in = eng.scales["input"]
    q = quant.preprocess_for_eval_int8(batches[0], s_in)
    q_cpu = quant.preprocess_for_eval_int8(batches[0].cpu(), s_in)
    d = (q.cpu().int() - q_cpu.int()).abs()
    if d.max().item() > 1 or (d > 0).double().mean().item() > FLOAT_SITE_SHARE:
        fail(f"e2e_uint8: preprocess_for_eval_int8 on the card off its plain version: "
             f"max {d.max().item()}, {int((d > 0).sum())} elements")
    reset_all_launches()
    for raw in batches:                        # warm-up, the capture
        urun(raw)
    uprobs = [urun(raw) for raw in batches]
    torch.cuda.synchronize()
    launches = all_launches()
    # The stem reads the 3-channel int8 image: the conv's byte-load kernel.
    GRAPH_RUNS["e2e_uint8"] = served_launches("e2e_uint8", launches, urun.program.kernel_nodes(),
                                              2 * N_BATCHES, INT8_PER_FORWARD, byte_path=1)
    paths["e2e_uint8"] = launches
    uplain = quant.QuantizedInceptionV3(state, calib, use_kernels=False, device=dev)
    stages = stage_mismatches("e2e_uint8", eng, uplain, (q, s_in))
    pdiff = 0.0
    for raw, p in zip(batches, uprobs):
        logits, _ = uplain.forward_from_uint8(raw)
        pdiff = max(pdiff, (p - torch.softmax(logits, -1)).abs().max().item())
    if pdiff > INT8_PROB_TOL:
        fail(f"e2e_uint8: probabilities {pdiff} from the plain engine > {INT8_PROB_TOL}")
    rates = {"s2d": [], "uint8": []}
    for name in ("s2d", "uint8", "uint8", "s2d"):
        rates[name].append(serve_rate(lambda i, r=runner if name == "s2d" else urun:
                                      r(batches[i])))
    emit({"phase": "e2e_uint8", "batch": BATCH, "batches": N_BATCHES, "src_hw": SRC_HW,
          "preprocess_max_abs_diff_vs_cpu": d.max().item(),
          "preprocess_mismatches_vs_cpu": int((d > 0).sum()),
          "preprocess_elements": d.numel(), "launches": launches, "graphs": GRAPH_RUNS["e2e_uint8"],
          "stage_int8_mismatches_vs_plain": stages, "prob_max_abs_diff_vs_plain": pdiff,
          "img_s_uint8": rates["uint8"], "img_s_s2d": rates["s2d"],
          "img_s_order": "s2d, uint8, uint8, s2d", "card": smi})
    del urun, uplain

    # ---- 10. pool_int8: pool_mode="int8" against its plain version ----
    peng = quant.QuantizedInceptionV3(state, calib, stem_s2d="pre", pool_mode="int8",
                                      device=dev)
    pplain = quant.QuantizedInceptionV3(state, calib, stem_s2d="pre", pool_mode="int8",
                                        use_kernels=False, device=dev)
    x0 = preprocess_for_eval_s2d(batches[0])
    stages = stage_mismatches("pool_int8", peng, pplain, x0)
    peng(x0)
    torch.cuda.synchronize()
    reset_all_launches()
    feats = [peng(preprocess_for_eval_s2d(raw))[1] for raw in batches]
    torch.cuda.synchronize()
    launches = all_launches()
    check_int8_launches("pool_int8", launches)
    paths["pool_int8"] = launches
    fdiff = max((f - pplain(preprocess_for_eval_s2d(raw))[1]).abs().max().item()
                for f, raw in zip(feats, batches))
    if fdiff != 0:
        fail(f"pool_int8: features {fdiff} from the plain engine")
    emit({"phase": "pool_int8", "batch": BATCH, "stage_int8_mismatches_vs_plain": stages,
          "feature_max_abs_diff_vs_plain": fdiff, "launches": launches, "card": smi})
    del peng, pplain

    # ---- 11. text_rnn: the rnn text model at full width, card vs CPU ----
    tcfg = get_preset("text_only")
    tcfg = tcfg.replace(text=tcfg.text.replace(aggregator="rnn"))
    tstate = text_model.init_state(build_model(tcfg, device="meta"), SEED)
    tok = torch.from_numpy(synthetic_ids(rng, BATCH, TEXT_T, tcfg.text.vocab_size))
    feats = {}
    for where in (dev, "cpu"):
        m = build_model(tcfg, device=where)
        m.load_state_dict(tstate)
        with torch.inference_mode():
            feats[str(where)] = m.represent(tok.to(where)).cpu()
            if where == dev:
                t_ms = cuda_ms(lambda: m.represent(tok.to(dev)), iters=5, warmup=1)
    got, want = feats[str(dev)], feats["cpu"]
    if not torch.isfinite(got).all():
        fail("text_rnn: non-finite features")
    tdiff = (got - want).abs().max().item() / want.abs().max().item()
    if tdiff > TEXT_TOL:
        fail(f"text_rnn: features {tdiff} of max|feature| from the CPU > {TEXT_TOL}")
    emit({"phase": "text_rnn", "vocab": tcfg.text.vocab_size, "embed": tcfg.text.embed_dim,
          "hidden": tcfg.text.rnn_hidden, "T": TEXT_T, "batch": BATCH,
          "feature_rel_diff_vs_cpu": tdiff, "tol": TEXT_TOL, "represent_ms": t_ms,
          "card": smi})
    return paths



def http_phase(dev, smi, calib):
    """Phase 12, the main path: posts over HTTP to the joint int8 program.
    Returns its launches."""
    import hashlib
    import importlib.util
    import json as _json
    import os
    import threading
    import urllib.error
    import urllib.parse
    import urllib.request
    from pathlib import Path

    import numpy as np
    import torch

    from tumblr_emotions_torch import EMOTIONS, get_preset
    from tumblr_emotions_torch.data import jpeg
    from tumblr_emotions_torch.data.pipeline import _host_resize_uint8
    from tumblr_emotions_torch.data.vocab import build_vocabulary
    from tumblr_emotions_torch.models import build_model, joint_model
    from tumblr_emotions_torch.ops.serving import build_forward
    from tumblr_emotions_torch.server import BatchedPredictor, EmotionHTTPServer
    from tumblr_emotions_torch.train.predict import Predictor
    from tumblr_emotions_torch.utils.compile_opts import capture

    # ---- the fixtures and their arithmetic, crafted and corrupt variants
    # decode here, under every dct_method, as the reference does (or are
    # refused where it refuses them), and resize as PIL does ----
    root = Path(__file__).resolve().parent / FIXTURES
    manifest = _json.loads((root / "manifest.json").read_text())
    entries = {**manifest["files"], **manifest["variants"]}
    every = sorted(entries)
    body_of = {n: (root / n).read_bytes() for n in every}
    refused = [n for n in every if entries[n].get("refused")]
    names = [n for n in every if not entries[n].get("refused")]
    bodies = [body_of[n] for n in names]

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    decoded, checked = {}, 0
    for name in every:
        want = entries[name]
        for method in DCT_METHODS:
            try:
                img = jpeg.decode(body_of[name], dct_method=method)
            except ValueError as e:
                if not want.get("refused"):
                    fail(f"e2e_http: {name} refused under {method} ({e}); the reference "
                         f"decodes it")
                checked += 1
                continue
            if want.get("refused"):
                fail(f"e2e_http: {name} decodes under {method}; the reference refuses it")
            if sha(img) != want["decode_sha256_by_method"][method]:
                fail(f"e2e_http: {name} decodes under {method} to another image than the "
                     f"reference's")
            checked += 1
            if method == "islow":
                decoded[name] = _host_resize_uint8(img, HOST_SIZE)
                if sha(decoded[name]) != want["resize_347_sha256"]:
                    fail(f"e2e_http: {name}'s {HOST_SIZE} px resize is not PIL's")
        # ... and at each DCT-domain scale (scale_num 1-7), the scaled IDCTs
        # as this machine's g++ builds them
        for scale, by_method in sorted(want["decode_sha256_by_scale"].items()):
            for method, digest in by_method.items():
                try:
                    got = sha(jpeg.decode(body_of[name], dct_method=method, scale_num=int(scale)))
                except ValueError:
                    got = None
                if got != digest:
                    fail(f"e2e_http: {name} at scale_num {scale} under {method} "
                         f"{'is refused' if got is None else 'decodes'}, not as the reference "
                         f"{'refuses it' if digest is None else 'decodes it'}")
                checked += 1
    host_decode_rates(smi, [body_of[n] for n in sorted(manifest["files"])],
                      [body_of[n] for n in names if n.startswith("arith/")], checked)

    # ---- the served program: joint_finetune at full width, int8 tower ----
    rng = np.random.RandomState(SEED + 2)
    cfg = get_preset("joint_finetune")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=DEPTH))
    t0 = time.perf_counter()
    state = joint_model.init_state(build_model(cfg, device="meta"), SEED)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = sorted({"".join(rng.choice(letters, rng.randint(3, 9)))
                    for _ in range(3 * cfg.text.vocab_size)})
    vocab = build_vocabulary([" ".join(words)] * 2 + list(EMOTIONS),
                             max_size=cfg.text.vocab_size)
    if vocab.size != cfg.text.vocab_size:
        fail(f"e2e_http: vocabulary of {vocab.size}, expected {cfg.text.vocab_size}")
    runner = build_forward(cfg, state, engine="int8", front="s2d", calib_images=calib,
                           device=dev)
    setup_s = time.perf_counter() - t0
    n_posts = HTTP_POSTS
    pick = [i % len(names) for i in range(n_posts)]
    captions = [" ".join(rng.choice(words + list(EMOTIONS) + ["#love", "http://t.co/x"],
                                    rng.randint(0, 60)))
                for _ in range(n_posts)]
    # counted from the runner's first call: the warm-up, which captures it
    reset_all_launches()
    warm = np.zeros((BATCH, HOST_SIZE, HOST_SIZE, 3), np.uint8)
    runner(warm, *vocab.encode_batch(captions[:BATCH], cfg.text.max_len))
    torch.cuda.synchronize()

    # Where a batch's time goes: the batcher thread's decode+resize call and
    # its runner call (synchronised), on the host clock.
    spans = {"decode_resize": [], "runner": []}

    def timed(fn, key, sync=False):
        def call(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            spans[key].append(time.perf_counter() - t)
            return out
        call.device = getattr(fn, "device", None)
        return call

    decode_resize = jpeg.decode_resize_batch
    jpeg.decode_resize_batch = timed(decode_resize, "decode_resize")
    pred = BatchedPredictor(timed(runner, "runner", sync=True), batch_size=BATCH,
                            host_size=HOST_SIZE, vocab=vocab, max_len=cfg.text.max_len,
                            max_delay_ms=HTTP_MAX_DELAY_MS, decode_threads=8)
    server = EmotionHTTPServer(pred, host="127.0.0.1", port=0)
    server.serve_background()
    base = "http://%s:%d" % server.server_address[:2]
    results, client_s = {}, {}

    def post(i, body, text):
        t = time.perf_counter()
        req = urllib.request.Request(
            f"{base}/predict?text={urllib.parse.quote(text)}", data=body, method="POST",
            headers={"X-Text": text, "Content-Type": "image/jpeg"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = (r.status, _json.loads(r.read()))
        except urllib.error.HTTPError as e:
            results[i] = (e.code, _json.loads(e.read()))
        except Exception as e:  # noqa: BLE001 — reported below
            results[i] = (None, {"error": f"{type(e).__name__}: {e}"})
        client_s[i] = time.perf_counter() - t

    def wave(jobs):
        """Send ``jobs`` [(index, body, text)] from HTTP_CLIENTS threads."""
        todo = list(jobs)
        lock = threading.Lock()

        def client():
            while True:
                with lock:
                    if not todo:
                        return
                    job = todo.pop(0)
                post(*job)

        threads = [threading.Thread(target=client) for _ in range(HTTP_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return _json.loads(r.read())

    try:
        # The first urllib request of a process pays a one-time set-up which,
        # taken by 64 threads at once, stalls some of them for ~2 s (the
        # client's cost, not the server's): /healthz pays it first.
        health = get("/healthz")
        t = time.perf_counter()
        wave([(i, bodies[pick[i]], captions[i]) for i in range(n_posts)])
        wall = time.perf_counter() - t
        stats = get("/stats")
        # The bodies both decoders refuse among 15 good posts: their own
        # 400s, the good posts their answers.
        bad = [b"\xff\xd8\xff\xdb corrupt"] + [body_of[n] for n in refused]
        extra = [(n_posts + j, body, "sad") for j, body in enumerate(bad)] + [
            (n_posts + len(bad) + k, bodies[pick[k]], captions[k]) for k in range(15)]
        wave(extra)
        torch.cuda.synchronize()
        launches = all_launches()
        graph_nodes = runner.program.kernel_nodes()
        stats2 = get("/stats")
    finally:
        server.close()
        jpeg.decode_resize_batch = decode_resize
    forwards = stats2["batches"]
    # the warm-up and the served batches, one graph (the batcher pads to
    # one signature)
    captured = served_launches("e2e_http", launches, graph_nodes, forwards + 1,
                               INT8_PER_FORWARD)
    if captured["graphs"] != 1:
        fail(f"e2e_http: the runner served {forwards} device batches with graphs {captured}")
    GRAPH_RUNS["e2e_http"] = captured
    if health.get("platform") != "cuda" or health.get("devices", 0) < 1:
        fail(f"e2e_http: /healthz {health}")
    if stats["batches"] < 3 or stats["errors"] or stats["responses"] != n_posts:
        fail(f"e2e_http: /stats after {n_posts} posts: {stats}")
    bad_status = [results[n_posts + j][0] for j in range(len(bad))]
    if any(st != 400 for st in bad_status) or stats2["errors"] != len(bad):
        fail(f"e2e_http: refused bodies answered {bad_status}, /stats {stats2}")

    # ---- every answer against the in-process runner on the same inputs
    # (the manifest-verified decode of each post, corrupt ones included) ----
    jobs = [(i, pick[i], captions[i]) for i in range(n_posts)] + \
        [(n_posts + len(bad) + k, pick[k], captions[k]) for k in range(15)]
    worst, agree = 0.0, 0
    for s in range(0, len(jobs), BATCH):
        chunk = jobs[s:s + BATCH]
        imgs = np.zeros((BATCH, HOST_SIZE, HOST_SIZE, 3), np.uint8)
        for r, (_, f, _) in enumerate(chunk):
            imgs[r] = decoded[names[f]]
        tok, lens = vocab.encode_batch([c for _, _, c in chunk], cfg.text.max_len)
        tok = np.concatenate([tok, np.zeros((BATCH - len(chunk), tok.shape[1]), np.int32)])
        lens = np.concatenate([lens, np.ones(BATCH - len(chunk), np.int32)])
        want = runner(imgs, tok, lens).cpu().numpy()
        for r, (i, _, _) in enumerate(chunk):
            status, got = results.get(i, (None, {}))
            if status != 200:
                fail(f"e2e_http: post {i} answered {status} {got}")
            if got["top"] != EMOTIONS[int(want[r].argmax())]:
                fail(f"e2e_http: post {i} top {got['top']}, in-process "
                     f"{EMOTIONS[int(want[r].argmax())]}")
            agree += 1
            worst = max(worst, max(abs(got["probs"][e] - float(want[r][k]))
                                   for k, e in enumerate(EMOTIONS)))
    if worst > HTTP_PROB_TOL:
        fail(f"e2e_http: answers {worst} from the in-process runner > {HTTP_PROB_TOL}")

    # ---- the batch-1 Predictor at native size against the parity runner ----
    predictor = Predictor(cfg, state, vocab=vocab, device=dev)
    parity = build_forward(cfg, state, engine="parity", device=dev)
    pdiff = 0.0
    for name, text in (("baseline_420_403x301.jpg", captions[0]),
                       ("progressive_420_161x97.jpg", captions[1])):
        body = (root / name).read_bytes()
        got = predictor.predict(body, text)
        tok, lens = vocab.encode_batch([text], cfg.text.max_len)
        want = parity(jpeg.decode(body)[None], tok, lens)[0].cpu().numpy()
        if next(iter(got)) != EMOTIONS[int(want.argmax())]:
            fail(f"e2e_http: Predictor's top on {name} differs from the parity runner's")
        pdiff = max(pdiff, max(abs(got[e] - float(want[k])) for k, e in enumerate(EMOTIONS)))
    if pdiff > PREDICT_TOL:
        fail(f"e2e_http: Predictor {pdiff} from the parity runner > {PREDICT_TOL}")

    # ---- the Predictor's program, eager as it serves it, against the same
    # program captured (a graph per image size): ms of the first and a
    # repeated call on each of two fixture sizes, peak memory, alternating ----
    inputs = []
    for name, text in (("baseline_420_403x301.jpg", captions[0]),
                       ("progressive_420_161x97.jpg", captions[1])):
        tok, lens = vocab.encode_batch([text], cfg.text.max_len)
        inputs.append((jpeg.decode((root / name).read_bytes())[None], tok, lens))
    predictor_cost = {"eager": [], "captured": []}
    for mode in ("eager", "captured", "eager", "captured"):
        prog = predictor.program if mode == "eager" else capture(predictor.program.fn,
                                                                 device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = []
        for x in inputs:
            for _ in range(2):
                t = time.perf_counter()
                prog(*x)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t))
        predictor_cost[mode].append({"ms_first_repeat_first_repeat": ms,
                                     "peak_mb": (torch.cuda.max_memory_allocated() - base)
                                     / 2**20})
        del prog
    del predictor, parity

    # ---- the host's decode + resize rate, 8 threads ----
    host_bodies = [bodies[f] for f in pick]
    out = np.empty((len(host_bodies), HOST_SIZE, HOST_SIZE, 3), np.uint8)
    jpeg.decode_resize_batch(host_bodies, HOST_SIZE, out, num_threads=8)
    rates = []
    for _ in range(3):
        t = time.perf_counter()
        errors = jpeg.decode_resize_batch(host_bodies, HOST_SIZE, out, num_threads=8)
        rates.append(len(host_bodies) / (time.perf_counter() - t))
    if any(errors):
        fail(f"e2e_http: decode_resize_batch failed: {errors}")
    emit({"phase": "e2e_http", "config": "joint_finetune", "depth": DEPTH,
          "vocab": vocab.size, "embed": cfg.text.embed_dim, "max_len": cfg.text.max_len,
          "batch": BATCH, "host_size": HOST_SIZE, "posts": n_posts, "clients": HTTP_CLIENTS,
          "max_delay_ms": HTTP_MAX_DELAY_MS, "fixtures": len(names),
          "posted_variants": sum(names[f].startswith(("arith/", "corrupt/", "crafted/"))
                                 for f in pick),
          "refused_bodies_400": len(bad), "decodes_checked_against_manifest": checked,
          "fixture_hashes_equal_manifest": True, "setup_s": setup_s,
          "posts_per_s": n_posts / wall, "wall_s": wall, "stats": stats,
          "client_latency_ms": {p: 1e3 * q for p, q in zip(
              ("p50", "p90", "p99", "max"),
              np.quantile([client_s[i] for i in range(n_posts)], [0.5, 0.9, 0.99, 1.0]))},
          "client_posts_over_1s": sum(client_s[i] > 1.0 for i in range(n_posts)),
          "somaxconn": (Path("/proc/sys/net/core/somaxconn").read_text().strip()
                        if Path("/proc/sys/net/core/somaxconn").exists() else None),
          "batcher_s": {k: sum(v) for k, v in spans.items()},
          "batcher_ms_per_batch": {k: 1e3 * sum(v) / max(len(v), 1) for k, v in spans.items()},
          "stats_after_corrupt": stats2, "healthz": health, "device_batches": forwards,
          "launches": launches, "captured_program": captured, "answers_checked": agree,
          "prob_max_abs_diff_vs_in_process": worst, "prob_tol": HTTP_PROB_TOL,
          "refused_body_status": bad_status,
          "predictor_max_abs_diff_vs_parity": pdiff, "predictor_tol": PREDICT_TOL,
          "predictor_cost": predictor_cost,
          "host_decode_resize_img_s_8_threads": rates,
          "host_has_pil": importlib.util.find_spec("PIL") is not None,
          "host_has_jpeglib_h": os.path.exists("/usr/include/jpeglib.h"),
          "card": smi})
    return launches


def host_decode_rates(smi, huffman, arith, checked):
    """The host decoder's img/s at 8 threads (decode only, no resize): the
    Huffman fixtures under each dct_method, islow also at scale_num 1, 2 and
    4, and the arithmetic-coded ones; about 1,000 images per call, the best
    of five rounds that each time every case in turn (200 images took 10 ms
    a call, and the first case timed in a process read up to 5x slow)."""
    from tumblr_emotions_torch.data import jpeg

    huffman = huffman * (-(-1000 // len(huffman)))
    arith = arith * (-(-1000 // len(arith)))
    cases = {m: (huffman, m, 8) for m in DCT_METHODS}
    for scale in (1, 2, 4):
        cases[f"islow_scale_{scale}"] = (huffman, "islow", scale)
    cases["arith_islow"] = (arith, "islow", 8)
    rates = {k: [] for k in cases}
    for round_ in range(6):  # round 0 warms up
        for k, (datas, method, scale) in cases.items():
            t = time.perf_counter()
            jpeg.decode_batch(datas, dct_method=method, scale_num=scale, num_threads=8)
            if round_:
                rates[k].append(len(datas) / (time.perf_counter() - t))
    emit({"phase": "host_decode", "threads": 8, "images": len(huffman),
          "arith_images": len(arith), "img_s": rates,
          "best_img_s": {k: max(v) for k, v in rates.items()},
          "decodes_checked_against_manifest": checked, "card": smi})


def tower_macs(cfg) -> float:
    """Multiply-adds of one image through the config's Inception-v3 (every
    conv, the aux head and the Logits head), counted from the output shapes
    of a forward on the meta device."""
    import torch

    from tumblr_emotions_torch.models import build_model
    from tumblr_emotions_torch.models.layers import ConvBN

    model = build_model(cfg.replace(model="image"), device="meta")
    macs = []

    def hook(mod, args, out):
        macs.append(out[0].numel() * mod.weights[0].numel())

    for mod in model.modules():
        if isinstance(mod, ConvBN):
            mod.register_forward_hook(hook)
    size = cfg.image.image_size
    model(torch.empty(1, size, size, 3, device="meta"))
    return float(sum(macs))


def train_phases(dev, smi):
    """Phases 13-15: training on the card (the main path of training,
    train_joint), the frozen-backbone baseline and the text model.
    Returns {path: launches} for the int8 program served from the trained
    joint state."""
    import dataclasses

    import numpy as np
    import torch

    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.data import preprocessing as pp
    from tumblr_emotions_torch.models import build_model, inception_v3, joint_model, text_model
    from tumblr_emotions_torch.ops.serving import build_forward
    from tumblr_emotions_torch.train.optim import Optimizer
    from tumblr_emotions_torch.train.trainer import Trainer, path_in_scopes

    rng = np.random.RandomState(SEED + 3)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)

    def make_batch(n, vocab, weight=None):
        return train_batch(gen, rng, dev, n, vocab, weight)

    def snapshot(ts):
        return {k: v.detach().clone() for k, v in ts.state.items()}

    distance, one_step = update_distance, train_one_step

    # ---- 13. train_joint: joint_finetune at full width ----
    cfg = get_preset("joint_finetune")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=DEPTH),
                      train=cfg.train.replace(log_every=1))
    t = cfg.train
    vocab = cfg.text.vocab_size
    state0 = joint_model.init_state(build_model(cfg, device="meta"), SEED)
    batches = [make_batch(t.batch_size, vocab) for _ in range(TRAIN_STEPS)]
    tr = Trainer(cfg, preprocess="train", device=dev)
    ts = tr.init_state(state0)
    starts = []
    losses = record_steps(tr, starts, "loss")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    ts = tr.fit(ts, batches, num_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    # fit reads each step's loss (log_every 1), so a step's wall time runs
    # from its start to the next one's
    step_ms = [1e3 * (b - a) for a, b in zip(starts, starts[1:] + [t0 + fit_s])]
    peak = torch.cuda.max_memory_allocated()
    launches = all_launches()
    if any(launches.values()):
        fail(f"train_joint: kernels of the served path launched in training: {launches}")
    losses = [float(x) for x in losses]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"train_joint: losses {losses}")
    if ts.step != TRAIN_STEPS or ts.opt_state["count"] != TRAIN_STEPS:
        fail(f"train_joint: step {ts.step}, optimizer count {ts.opt_state['count']}")
    trained = {k: v.detach().cpu() for k, v in ts.state.items()}
    # The joint model's unused tower Logits head gets no gradient from the
    # loss: its bias none, its weights the L2 term's wd * w alone.
    head = "InceptionV3.Logits/Conv2d_1c_1x1."
    unmoved = [k for k in tr.param_keys
               if torch.equal(trained[k], state0[k]) and not k.startswith(head)]
    if unmoved:
        fail(f"train_joint: trainable leaves did not move: {unmoved[:5]}")
    if not torch.equal(trained[head + "biases"], state0[head + "biases"]):
        fail("train_joint: the unused tower Logits bias moved (it has no gradient)")
    stats = [k for k in state0 if k.endswith(("moving_mean", "moving_variance"))]
    still = [k for k in stats if torch.equal(trained[k], state0[k])]
    if still:
        fail(f"train_joint: BN statistics did not move: {still[:5]}")
    # RMSProp replayed on the card from the L2 gradient alone must land
    # where training put the weights, bit for bit.  (At lr 1e-4 it moves
    # them by ~lr * wd = 4e-9 of themselves per step, below f32's
    # resolution, so both leave them where they started.)
    w = state0[head + "weights"].to(dev)
    sim = Optimizer(t)
    sim_state = sim.init({"w": w})
    for _ in range(TRAIN_STEPS):
        sim.update({"w": w}, {"w": t.weight_decay * w}, sim_state)
    if not torch.equal(w.cpu(), trained[head + "weights"]):
        fail("train_joint: the tower Logits weights differ from an L2-only replay")
    l2_moved = (trained[head + "weights"] - state0[head + "weights"]).abs().max().item()

    # evaluate on 3 batches, the last padded, against the CPU's on the same
    # batches and the same trained state
    n = t.batch_size
    ev_batches = [make_batch(n, vocab) for _ in range(TRAIN_EVAL_BATCHES - 1)]
    ev_batches.append(make_batch(n, vocab, weight=[1] * (n // 2) + [0] * (n - n // 2)))
    t0 = time.perf_counter()
    ev = tr.evaluate(ts, ev_batches)
    eval_s = time.perf_counter() - t0
    tr_cpu = Trainer(cfg, preprocess="train", device="cpu")
    t0 = time.perf_counter()
    ev_cpu = tr_cpu.evaluate(tr_cpu.init_state(trained),
                             [{k: v.cpu() for k, v in b.items()} for b in ev_batches])
    eval_cpu_s = time.perf_counter() - t0
    if ev["count"] != n * (TRAIN_EVAL_BATCHES - 1) + n // 2:
        fail(f"train_joint: evaluate counted {ev['count']}")
    if (ev["count"], ev["accuracy"]) != (ev_cpu["count"], ev_cpu["accuracy"]) or not \
            np.array_equal(ev["confusion"], ev_cpu["confusion"]):
        fail(f"train_joint: evaluate on the card {ev['count']}/{ev['accuracy']} differs from "
             f"the CPU's {ev_cpu['count']}/{ev_cpu['accuracy']} or in the confusion matrix")
    eval_loss_rel = abs(ev["loss"] - ev_cpu["loss"]) / abs(ev_cpu["loss"])

    # one step at batch 4 against the same step on the CPU (dropout off, the
    # same distortion draws), beside the CPU's own f32 noise floor: the mean
    # distance of the CPU's update to its updates from weights moved by
    # TRAIN_NOISE_EPS of themselves (three seeds)
    ccfg = cfg.replace(image=cfg.image.replace(dropout_keep_prob=1.0),
                       train=t.replace(batch_size=TRAIN_CPU_BATCH))
    b4 = {k: v[:TRAIN_CPU_BATCH] for k, v in batches[0].items()}
    draws = pp.draw_train(torch.Generator().manual_seed(SEED), TRAIN_CPU_BATCH,
                          (SRC_HW, SRC_HW))
    t0 = time.perf_counter()
    loss_card, card = one_step(ccfg, state0, b4, draws, dev)
    loss_cpu, cpu = one_step(ccfg, state0, b4, draws, "cpu")
    cpu_step_s = time.perf_counter() - t0
    noise = []
    for seed in TRAIN_NOISE_SEEDS:
        g = torch.Generator().manual_seed(seed)
        moved = {k: v * (1 + TRAIN_NOISE_EPS * torch.randn(v.shape, generator=g))
                 for k, v in state0.items()}
        nudged = dataclasses.replace(draws, delta=draws.delta + TRAIN_NOISE_EPS * torch.randn(
            TRAIN_CPU_BATCH, generator=g))
        noise.append((moved, one_step(ccfg, moved, b4, nudged, "cpu")[1]))
    pkeys = [k for k in tr.param_keys if not torch.equal(cpu[k], state0[k])]
    held = {"loss_rel_diff": abs(loss_card - loss_cpu) / abs(loss_cpu)}
    for what, keys in (("params", pkeys), ("stats", stats)):
        held[what + "_to_cpu"] = distance(card, state0, cpu, state0, keys)
        held[what + "_noise_floors"] = [distance(n, n0, cpu, state0, keys) for n0, n in noise]
        held[what + "_noise_floor"] = float(np.mean(held[what + "_noise_floors"]))
    if held["loss_rel_diff"] > TRAIN_LOSS_RTOL:
        fail(f"train_joint: step loss {loss_card} on the card vs {loss_cpu} on the CPU, "
             f"{held['loss_rel_diff']} > {TRAIN_LOSS_RTOL}")
    for what in ("params", "stats"):
        if held[what + "_to_cpu"] > TRAIN_NOISE_FACTOR * held[what + "_noise_floor"] + 1e-6:
            fail(f"train_joint: {what} after one step {held[what + '_to_cpu']} from the CPU's, "
                 f"above {TRAIN_NOISE_FACTOR} x the f32 noise floor "
                 f"{held[what + '_noise_floor']}")

    # the stages of a step, timed with CUDA events over 3 more steps
    ev_t = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    split = {"preprocess": 0.0, "forward_backward": 0.0, "update": 0.0}
    for b in batches[:3]:
        ev_t[0].record()
        inputs = tr.train_inputs(b, gen)
        ev_t[1].record()
        _, _, grads = tr.loss_and_grads(ts, inputs, gen)
        ev_t[2].record()
        tr.apply_gradients(ts, grads)
        ev_t[3].record()
        ev_t[3].synchronize()
        for i, name in enumerate(split):
            split[name] += ev_t[i].elapsed_time(ev_t[i + 1]) / 3
    del grads, inputs

    # the trained state served by the int8 program: K1 and K4 on weights
    # that are not the initial ones, top-1 against the f32 parity runner
    calib = pp.preprocess_for_eval(ev_batches[0]["image"])
    jrun = build_forward(cfg, trained, engine="int8", front="s2d", calib_images=calib,
                         device=dev)
    parity = build_forward(cfg, trained, engine="parity", device=dev)
    reset_all_launches()
    probs = [jrun(b["image"], b["tokens"]) for b in ev_batches]
    torch.cuda.synchronize()
    int8_launches = all_launches()
    GRAPH_RUNS["train_joint_int8"] = served_launches(
        "train_joint_int8", int8_launches, jrun.program.kernel_nodes(), len(ev_batches),
        INT8_PER_FORWARD)
    agree = sum(int((p.argmax(-1) == parity(b["image"], b["tokens"]).argmax(-1)).sum())
                for p, b in zip(probs, ev_batches))
    del jrun, parity
    steps_s = TRAIN_STEPS / fit_s
    bound_ms = 3 * 2 * tower_macs(cfg) * t.batch_size / H100_F32_FLOPS * 1e3
    emit({"phase": "train_joint", "config": "joint_finetune", "depth": DEPTH,
          "image_size": cfg.image.image_size, "aux": cfg.image.create_aux_logits,
          "dropout_keep": cfg.image.dropout_keep_prob, "vocab": vocab,
          "embed": cfg.text.embed_dim, "aggregator": cfg.text.aggregator, "max_len": TEXT_T,
          "batch": t.batch_size, "optimizer": t.optimizer, "lr": t.learning_rate,
          "preprocess": "train", "src_hw": SRC_HW, "steps": TRAIN_STEPS, "losses": losses,
          "fit_s": fit_s, "steps_per_s": steps_s, "examples_per_s": steps_s * t.batch_size,
          "ms_per_step_fit": 1e3 / steps_s, "ms_per_step_each": step_ms,
          "ms_per_step_steady": float(np.mean(step_ms[1:])),
          "examples_per_s_steady": 1e3 * t.batch_size / float(np.mean(step_ms[1:])),
          "ms_per_step_split": split,
          "ms_per_step_split_sum": sum(split.values()),
          "timing": "fit_s: host clock over the 8 steps of fit, the first included, "
                    "synchronised; each: host clock per step of fit (it reads every loss); "
                    "steady: steps 2-8; split: CUDA events around the three stages of 3 "
                    "more steps",
          "peak_memory_gb": peak / 2 ** 30, "bound_ms_f32": bound_ms,
          "bound_note": "3 x 2 x the tower's multiply-adds x batch over the f32 peak "
                        "(forward, and two products per conv backward)",
          "eval": {"count": ev["count"], "accuracy": ev["accuracy"], "loss": ev["loss"],
                   "seconds": eval_s, "cpu_seconds": eval_cpu_s, "equal_to_cpu": True,
                   "loss_rel_diff_vs_cpu": eval_loss_rel},
          "held_against_cpu": dict(held, batch=TRAIN_CPU_BATCH, loss_rtol=TRAIN_LOSS_RTOL,
                                   noise_factor=TRAIN_NOISE_FACTOR, noise_eps=TRAIN_NOISE_EPS,
                                   noise_seeds=list(TRAIN_NOISE_SEEDS),
                                   cpu_seconds=cpu_step_s),
          "tower_logits_weights_equal_l2_only_replay": True,
          "tower_logits_weights_moved_max_abs": l2_moved,
          "int8_from_trained": {"launches": int8_launches, "top1_agree_vs_parity":
                                agree / (n * len(ev_batches))},
          "card": smi})
    print(smi, flush=True)
    del tr, ts, batches, trained, card, cpu, noise

    # ---- 14. train_image_frozen: the frozen-backbone baseline ----
    fcfg = get_preset("image_frozen")
    fcfg = fcfg.replace(image=fcfg.image.replace(depth_multiplier=DEPTH))
    fstate0 = inception_v3.init_state(build_model(fcfg, device="meta"), SEED)
    ftr = Trainer(fcfg, preprocess="train", device=dev)
    fts = ftr.init_state(fstate0)
    flosses = record_steps(ftr, key="loss")
    fbatches = [make_batch(fcfg.train.batch_size, vocab) for _ in range(TRAIN_SIDE_STEPS)]
    t0 = time.perf_counter()
    fts = ftr.fit(fts, fbatches, num_steps=TRAIN_SIDE_STEPS)
    torch.cuda.synchronize()
    ffit_s = time.perf_counter() - t0
    scopes = ("Logits", "AuxLogits")
    changed = {k for k, v in fts.state.items() if not torch.equal(v.detach().cpu(), fstate0[k])}
    fstats = {k for k in fstate0 if k.endswith(("moving_mean", "moving_variance"))}
    trainable = {k for k in ftr.param_keys if path_in_scopes(k, scopes)}
    if changed - fstats != trainable:
        fail(f"train_image_frozen: moved {sorted(changed - fstats - trainable)[:5]}, "
             f"unmoved trainable {sorted(trainable - changed)[:5]}")
    if not fstats <= changed:
        fail(f"train_image_frozen: BN statistics unmoved: {sorted(fstats - changed)[:5]}")
    flosses = [float(x) for x in flosses]
    if not all(np.isfinite(flosses)):
        fail(f"train_image_frozen: losses {flosses}")
    emit({"phase": "train_image_frozen", "depth": DEPTH, "batch": fcfg.train.batch_size,
          "steps": TRAIN_SIDE_STEPS, "losses": flosses, "trainable_leaves": len(trainable),
          "frozen_leaves_bit_unchanged": len(ftr.param_keys) - len(trainable),
          "bn_statistics_moved": len(fstats), "fit_s": ffit_s,
          "examples_per_s": TRAIN_SIDE_STEPS * fcfg.train.batch_size / ffit_s, "card": smi})
    del ftr, fts, fbatches

    # ---- 15. train_text: text_only (Adam, batch 64) at full width ----
    tcfg = get_preset("text_only")
    tstate0 = text_model.init_state(build_model(tcfg, device="meta"), SEED)
    tbatches = [{k: v for k, v in make_batch(tcfg.train.batch_size, tcfg.text.vocab_size)
                 .items() if k != "image"} for _ in range(TRAIN_SIDE_STEPS)]
    loss_card, card = one_step(tcfg, tstate0, tbatches[0], None, dev)
    loss_cpu, cpu = one_step(tcfg, tstate0, tbatches[0], None, "cpu")
    worst = 0.0
    for k in cpu:
        scale = (cpu[k] - tstate0[k]).abs().max().item()
        err = (card[k] - cpu[k]).abs().max().item()
        if err > TEXT_UPDATE_TOL * scale + 1e-7:
            fail(f"train_text: {k} updated {err} from the CPU's, above {TEXT_UPDATE_TOL} of "
                 f"its update {scale}")
        worst = max(worst, err / max(scale, 1e-30))
    if abs(loss_card - loss_cpu) > TRAIN_LOSS_RTOL * abs(loss_cpu):
        fail(f"train_text: step loss {loss_card} on the card vs {loss_cpu} on the CPU")
    ttr = Trainer(tcfg, device=dev)
    tts = ttr.init_state(tstate0)
    tlosses = record_steps(ttr, key="loss")
    t0 = time.perf_counter()
    tts = ttr.fit(tts, tbatches, num_steps=TRAIN_SIDE_STEPS)
    torch.cuda.synchronize()
    tfit_s = time.perf_counter() - t0
    tlosses = [float(x) for x in tlosses]
    if not all(np.isfinite(tlosses)) or abs(tlosses[0] - loss_card) > 1e-6 * abs(loss_card):
        fail(f"train_text: losses {tlosses} (the held step's {loss_card})")
    emit({"phase": "train_text", "vocab": tcfg.text.vocab_size, "embed": tcfg.text.embed_dim,
          "aggregator": tcfg.text.aggregator, "batch": tcfg.train.batch_size,
          "optimizer": tcfg.train.optimizer, "steps": TRAIN_SIDE_STEPS, "losses": tlosses,
          "held_step_loss_card_cpu": [loss_card, loss_cpu],
          "held_step_worst_leaf_vs_update": worst, "update_tol": TEXT_UPDATE_TOL,
          "fit_s": tfit_s, "card": smi})
    return {"train_joint_int8": int8_launches}, held


def divisions_phase(dev, smi, state):
    """Phase divisions: the card divides as the reference divides.  f32
    ``preprocess_for_eval`` on the card bit-equal to the CPU's on all 256
    byte values and on a seeded [8,347,347,3] batch (beside the old
    ``x / 255.0``, a product with the reciprocal on the card); the int8
    engine calibrated on that batch on the card and on the CPU: the input
    scale bit-equal, the conv sites' scales (f32 conv sums in another
    order) reported; a tensor list divided by a Python float and by a
    device tensor (the optimizer's form) against the CPU's division;
    PyTorch's float32 sqrt on the card and on the CPU and the optimizer's
    correctly rounded one against numpy's (IEEE, as the reference's XLA
    sqrt); Adam's update bit-equal to the CPU's; RMSProp's rsqrt against
    the CPU's, reported."""
    import numpy as np
    import torch

    from tumblr_emotions_torch.config import TrainConfig
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.ops.quant import QuantizedInceptionV3
    from tumblr_emotions_torch.train import optim

    values = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16, 1).expand(1, 16, 16, 3)
    gen = torch.Generator().manual_seed(SEED + 11)
    batch = torch.randint(0, 256, (8, SRC_HW, SRC_HW, 3), generator=gen, dtype=torch.uint8)
    out = {}
    for name, x in (("bytes", values), ("batch", batch)):
        cpu = preprocess_for_eval(x, 16, 16, central_fraction=1.0) if name == "bytes" else \
            preprocess_for_eval(x)
        card = (preprocess_for_eval(x.to(dev), 16, 16, central_fraction=1.0)
                if name == "bytes" else preprocess_for_eval(x.to(dev))).cpu()
        scaled = x.float() / 255.0
        out[name] = {"differ": int((card != cpu).sum()), "elements": cpu.numel(),
                     "max_abs_diff": float((card - cpu).abs().max()),
                     "old_form_differ": int(((x.to(dev).float() / 255.0).cpu()
                                             != scaled).sum())}
        if out[name]["differ"]:
            fail(f"divisions: preprocess_for_eval on the card differs from the CPU's on "
                 f"{name}: {out[name]}")
    calib = preprocess_for_eval(batch)
    s_card = QuantizedInceptionV3(state, calib.to(dev), stem_s2d="pre", device=dev).scales
    s_cpu = QuantizedInceptionV3({k: v.cpu() for k, v in state.items()}, calib, stem_s2d="pre",
                                 device="cpu").scales
    rel = {k: abs(s_card[k] - s_cpu[k]) / s_cpu[k] for k in s_cpu}
    out["int8_scales"] = {"input_card": s_card["input"], "input_cpu": s_cpu["input"],
                          "sites": len(s_cpu), "bit_equal": sum(s_card[k] == s_cpu[k]
                                                                for k in s_cpu),
                          "max_rel_diff": max(rel.values())}
    if s_card["input"] != s_cpu["input"] or sorted(s_card) != sorted(s_cpu):
        fail(f"divisions: the card's calibration scales {out['int8_scales']}")
    # a tensor list divided by a Python float and by a device tensor of
    # the same value (Adam's bias correction after one update), against the
    # CPU's IEEE division
    xs = [torch.rand(4096, generator=gen) + 0.1 for _ in range(4)]
    d = float(np.float32(1) - np.float32(optim.ADAM_B2))
    cpu_q = [x / torch.tensor(d) for x in xs]
    on_card = [x.to(dev) for x in xs]
    out["foreach_div"] = {
        "python_float_differ": sum(int((q.cpu() != c).sum()) for q, c in zip(
            torch._foreach_div(on_card, d), cpu_q)),
        "tensor_differ": sum(int((q.cpu() != c).sum()) for q, c in zip(
            torch._foreach_div(on_card, torch.tensor(d, device=dev)), cpu_q)),
        "elements": 4 * 4096}
    if out["foreach_div"]["tensor_differ"]:
        fail(f"divisions: a tensor list divided by a device tensor on the card differs from "
             f"the CPU's division: {out['foreach_div']}")
    # Adam's update (its bias corrections divided as above) and RMSProp's
    # rsqrt, on the card against the CPU
    t = TrainConfig(optimizer="adam", learning_rate=1e-3)
    opt = optim.Optimizer(t)
    rng = np.random.RandomState(SEED + 12)
    p0 = {k: rng.normal(size=(256, 257)).astype(np.float32) for k in ("a", "b")}
    grads = [{k: rng.normal(size=(256, 257)).astype(np.float32) for k in p0}
             for _ in range(3)]
    runs = []
    for where in ("cpu", dev):
        p = {k: torch.tensor(v, device=where) for k, v in p0.items()}
        st = opt.init(p)
        for g in grads:
            opt.update(p, {k: torch.tensor(v, device=where) for k, v in g.items()}, st)
        runs.append({k: v.cpu() for k, v in p.items()})
    x = torch.from_numpy(np.abs(rng.normal(size=65536)).astype(np.float32)) + 1.0
    out["adam"] = {"differ": sum(int((runs[0][k] != runs[1][k]).sum()) for k in p0),
                   "elements": sum(v.size for v in p0.values()), "updates": len(grads)}
    ieee = torch.from_numpy(np.sqrt(x.numpy()))     # numpy's: correctly rounded
    out["sqrt"] = {"card_torch_sqrt_differ": int((torch.sqrt(x.to(dev)).cpu() != ieee).sum()),
                   "cpu_torch_sqrt_differ": int((torch.sqrt(x) != ieee).sum()),
                   "correctly_rounded_differ": int((optim.correctly_rounded_sqrt(
                       [x.to(dev)])[0].cpu() != ieee).sum()),
                   "elements": x.numel()}
    out["rsqrt"] = {"differ": int((torch.rsqrt(x.to(dev)).cpu() != torch.rsqrt(x)).sum()),
                    "elements": x.numel()}
    if out["adam"]["differ"] or out["sqrt"]["correctly_rounded_differ"]:
        fail(f"divisions: Adam's update on the card differs from the CPU's: {out['adam']}, "
             f"{out['sqrt']}")
    out["dropout"] = dropout_row(dev, rng)
    if out["dropout"]["f32_differ"] or out["dropout"]["bf16_differ"]:
        fail(f"divisions: Dropout on the card differs from the CPU's: {out['dropout']}")
    emit({"phase": "divisions", **out, "card": smi})


def dropout_row(dev, rng) -> dict:
    """Dropout (keep 0.8) on one fixed uniform draw, f32 and bf16, the card
    against the CPU: the port's form (a product with the f32 reciprocal, as
    the reference's jitted step computes it) and, beside it, the old form
    (``x / keep_prob`` by a Python float: the CPU divides, the card
    multiplies by the reciprocal)."""
    from unittest import mock

    import numpy as np
    import torch

    from tumblr_emotions_torch.models.layers import Dropout

    x = torch.from_numpy((rng.normal(size=(64, 1, 1, 2048)) * 4).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=x.shape).astype(np.float32))
    row = {"elements": x.numel(), "keep_prob": 0.8}
    drop = Dropout(0.8).train()
    with mock.patch.object(torch, "rand", lambda *a, device=None, **k: u.to(device)):
        for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            xd = x.to(dtype)
            cpu, card = drop(xd), drop(xd.to(dev)).cpu()
            row[f"{key}_differ"] = int((cpu != card).sum())
            old_cpu = torch.where(u < 0.8, xd / 0.8, torch.zeros((), dtype=dtype))
            old_card = torch.where(u.to(dev) < 0.8, xd.to(dev) / 0.8,
                                   torch.zeros((), dtype=dtype, device=dev)).cpu()
            row[f"{key}_old_form_differ"] = int((old_cpu != old_card).sum())
    return row


@contextlib.contextmanager
def train_options(opts):
    """``TET_TORCH_TRAIN_COMPILER_OPTIONS`` set to ``opts`` (None: unset)
    inside the block."""
    import os

    from tumblr_emotions_torch.utils import compile_opts

    old = os.environ.get(compile_opts.TRAIN_ENV_VAR)
    if opts is None:
        os.environ.pop(compile_opts.TRAIN_ENV_VAR, None)
    else:
        os.environ[compile_opts.TRAIN_ENV_VAR] = json.dumps(opts)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(compile_opts.TRAIN_ENV_VAR, None)
        else:
            os.environ[compile_opts.TRAIN_ENV_VAR] = old


def served_nodes(kernels: dict) -> dict:
    """A graph's kernel nodes of the served kernels (K1-K4), by name."""
    import re

    return {k: sum(n for name, n in kernels.items() if re.search(pat, name))
            for k, pat in GRAPH_KERNELS.items()}


def fit_case(dev, cfg, preprocess, state0, batches, ev_batches, eager, mesh=None):
    """``Trainer.fit`` over ``batches`` from ``state0`` with the compiled
    step eager or captured (``TET_TORCH_TRAIN_COMPILER_OPTIONS``), then
    ``evaluate`` over ``ev_batches``: the trainer, the trained state, each
    step's loss and accuracy, ms per step (host clock; fit reads every
    loss, cfg.train.log_every 1), peak memory, the wrappers' launches (the
    served kernels' and the batch norm's), the eval summary and, captured,
    each graph's replays and kernel nodes (all, the served kernels', the
    batch norm's)."""
    import numpy as np
    import torch

    from tumblr_emotions_torch.ops import int8_conv as ic
    from tumblr_emotions_torch.train.trainer import Trainer

    with train_options(EAGER if eager else None):
        tr = Trainer(cfg, preprocess=preprocess, device=dev, mesh=mesh).compile()
    if tr.step_mode != ("eager" if eager else "captured"):
        fail(f"train_captured: step_mode {tr.step_mode} with eager={eager}")
    ts = tr.init_state(state0)
    starts = []
    metrics = record_steps(tr, starts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    ts = tr.fit(ts, batches, num_steps=len(batches))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = all_launches()
    launches["conv_int8 byte path"] = ic.conv_int8.byte_launches
    ev = tr.evaluate(ts, ev_batches)
    step_ms = [1e3 * (b - a) for a, b in zip(starts, starts[1:] + [t0 + fit_s])]
    run = {"tr": tr, "ts": ts, "losses": [float(m["loss"]) for m in metrics],
           "accs": [float(m["accuracy"]) for m in metrics], "ms_each": step_ms,
           "ms_steady": float(np.median(step_ms[1:])), "peak_gb": peak / 2 ** 30,
           "launches": launches, "eval": ev}
    for which, program in tr._programs.items():
        run[which + "_graphs"] = [
            {"replays": g["replays"], "kernel_nodes": sum(g["kernels"].values()),
             "served_kernel_nodes": served_nodes(g["kernels"]),
             "bn_kernel_nodes": bn_nodes(g["kernels"])}
            for g in program.kernel_nodes()]
    return run


def state_differences(a, b) -> list:
    """The leaves (state dict and optimizer moments) in which two
    TrainStates differ at all."""
    import torch

    out = [k for k in a.state if not torch.equal(a.state[k], b.state[k])]
    for m, leaves in a.opt_state.items():
        if m != "count":
            out += [f"{m}/{k}" for k in leaves if not torch.equal(leaves[k], b.opt_state[m][k])]
    if a.step != b.step or a.opt_state["count"] != b.opt_state["count"]:
        out.append("step")
    return out


def same_eval(a: dict, b: dict) -> bool:
    import numpy as np

    return (a["count"], a["accuracy"], a["loss"]) == (b["count"], b["accuracy"], b["loss"]) \
        and np.array_equal(a["confusion"], b["confusion"])


def train_captured_phase(dev, smi):
    """Phase train_captured: this slice's main path, the train and eval
    steps of ``Trainer.compile`` as captured CUDA graphs.  For each case
    (f32 joint_finetune at batch 32 with RMSProp, image_frozen with the
    adam override, text_only, the data_parallel preset in perf mode at 128
    rows in one process and on a world-size-1 NCCL group), at full width:
    TRAIN_CAPTURED_STEPS steps of fit eager, then as many captured from the
    same state and seeds, and evaluate over TRAIN_EVAL_BATCHES batches (the
    last half padding) after each.  Held bit-equal: parameters, optimizer
    moments, BN statistics, every step's loss and accuracy, the eval
    summary.  One train graph, replayed once per step after the first (the
    warm-up that captures it); no served kernel (K1-K4) among any graph's
    kernel nodes nor launched; in perf mode every batch-normed conv's batch
    norm kernels (BN_PER_LAYER) launched on each eager step and on the
    warm-up, and among the train graph's nodes once, none in eval graphs;
    none in f32.  Prints ms per step and peak memory captured
    and eager, each graph's kernel nodes, and for the f32 joint and perf
    cases the device's busy time, idle share and kernels per step from a
    trace of 2 steps each way, and with cuDNN's nondeterministic algorithms
    allowed: how many leaves two eager runs of two steps differ in, and the
    captured ms per step.  Then
    restore: the f32 joint case captured
    with a checkpoint at step RESTORE_AT, restored into fresh tensors and
    trained on (captured anew) equals the straight captured run."""
    import numpy as np
    import torch

    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch import profile_serving
    from tumblr_emotions_torch.models import build_model, inception_v3, joint_model, text_model
    from tumblr_emotions_torch.parallel import distributed
    from tumblr_emotions_torch.parallel import mesh as mesh_lib
    from tumblr_emotions_torch.train.trainer import step_seed

    init = {"image": inception_v3.init_state, "joint": joint_model.init_state,
            "text": text_model.init_state}
    cases = [("joint_f32", "joint_finetune", {}, None, True),
             ("image_frozen_adam", "image_frozen", {"optimizer": "adam",
                                                   "learning_rate": 1e-3}, None, False),
             ("text", "text_only", {}, None, False),
             ("perf_dp", "data_parallel", {"batch_size": PERF_BATCH}, None, True),
             ("perf_dp_nccl", "data_parallel", {"batch_size": PERF_BATCH}, "nccl", False)]
    rng = np.random.RandomState(SEED + 13)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    launches_total = {}
    for name, preset, extra, group, profiled in cases:
        cfg = get_preset(preset)
        cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=DEPTH),
                          train=cfg.train.replace(log_every=1, **extra))
        t, vocab = cfg.train, cfg.text.vocab_size
        state0 = init[cfg.model](build_model(cfg, device="meta"), SEED)
        preprocess = None if cfg.model == "text" else "train"
        drop = ("image",) if cfg.model == "text" else ()

        def batch(n, weight=None):
            return {k: v for k, v in train_batch(gen, rng, dev, n, vocab, weight).items()
                    if k not in drop}

        batches = [batch(t.batch_size) for _ in range(TRAIN_CAPTURED_STEPS)]
        n = t.batch_size
        ev_batches = [batch(n) for _ in range(TRAIN_EVAL_BATCHES - 1)]
        ev_batches.append(batch(n, weight=[1] * (n // 2) + [0] * (n - n // 2)))
        mesh = None
        if group:
            distributed.init_group(f"127.0.0.1:{free_port()}", 1, 0, device=dev,
                                   backend=group)
            mesh = mesh_lib.Mesh(1, 0, torch.distributed.group.WORLD)
        try:
            eager = fit_case(dev, cfg, preprocess, state0, batches, ev_batches, True, mesh)
            capt = fit_case(dev, cfg, preprocess, state0, batches, ev_batches, False, mesh)
            differ = state_differences(eager["ts"], capt["ts"])
            if differ or eager["losses"] != capt["losses"] or eager["accs"] != capt["accs"]:
                fail(f"train_captured {name}: captured differs from eager in {differ[:5]} "
                     f"({len(differ)} leaves), losses {capt['losses']} vs {eager['losses']}, "
                     f"accuracies {capt['accs']} vs {eager['accs']}")
            if not same_eval(eager["eval"], capt["eval"]):
                fail(f"train_captured {name}: eval {capt['eval']} vs eager {eager['eval']}")
            graphs = capt["train_graphs"]
            if len(graphs) != 1 or graphs[0]["replays"] != TRAIN_CAPTURED_STEPS - 1:
                fail(f"train_captured {name}: train graphs {graphs}")
            served = [g["served_kernel_nodes"] for w in ("train", "eval")
                      for g in capt[w + "_graphs"]]
            if any(any(s.values()) for s in served):
                fail(f"train_captured {name}: served kernels in training: {served}")
            # the bf16 model's batch norm: each step's kernels eagerly, the
            # capturing step's warm-up from Python and one step's in the
            # train graph; none in f32 nor in an eval graph
            bf16 = t.precision_mode == "perf"
            check_bn_launches(f"train_captured {name} eager", eager["launches"],
                              TRAIN_CAPTURED_STEPS if bf16 else 0)
            check_bn_launches(f"train_captured {name} captured", capt["launches"],
                              1 if bf16 else 0)
            per_step = {k: n * BN_LAYERS * bf16 for k, n in BN_PER_LAYER.items()}
            eval_bn = [g["bn_kernel_nodes"] for g in capt["eval_graphs"]]
            if graphs[0]["bn_kernel_nodes"] != per_step or any(any(b.values()) for b in eval_bn):
                fail(f"train_captured {name}: batch norm nodes {graphs[0]['bn_kernel_nodes']} "
                     f"in the train graph, expected {per_step}; in the eval graphs {eval_bn}")
            if bf16:
                BN_GRAPH_RUNS[f"train_captured {name}"] = {
                    "replays": graphs[0]["replays"],
                    "device_launches": {k: capt["launches"][k] + per_step[k] *
                                        graphs[0]["replays"] for k in BN_PER_LAYER}}
            line = {"phase": "train_captured", "case": name, "preset": preset,
                    "precision_mode": t.precision_mode, "optimizer": t.optimizer,
                    "batch": n, "depth": DEPTH, "steps": TRAIN_CAPTURED_STEPS,
                    "group": group, "bit_equal": True, "losses": capt["losses"],
                    "ms_per_step_captured": capt["ms_steady"],
                    "ms_per_step_eager": eager["ms_steady"],
                    "ms_each_captured": capt["ms_each"], "ms_each_eager": eager["ms_each"],
                    "examples_per_s_captured": 1e3 * n / capt["ms_steady"],
                    "examples_per_s_eager": 1e3 * n / eager["ms_steady"],
                    "peak_memory_gb_captured": capt["peak_gb"],
                    "peak_memory_gb_eager": eager["peak_gb"],
                    "train_graphs": graphs, "eval_graphs": capt["eval_graphs"],
                    "launches_eager": eager["launches"], "launches_captured": capt["launches"],
                    "graph_launches_per_step": graphs[0]["replays"]
                    / (TRAIN_CAPTURED_STEPS - 1),
                    "eval": {k: capt["eval"][k] for k in ("count", "accuracy", "loss")},
                    "timing": "host clock per step of fit (it reads every loss); the "
                              "median of steps 2-8 (step 1 is the warm-up that captures)"}
            if name == "joint_f32":
                line["restore"] = restore_check(dev, cfg, preprocess, state0, batches,
                                                capt["ts"])
                line["without_deterministic_convs"] = nondeterminism(
                    dev, cfg, preprocess, state0, batches)
            if profiled:
                # (after the comparisons: these steps move the states on)
                for mode, run in (("captured", capt), ("eager", eager)):
                    tr, st = run["tr"], run["ts"]

                    def step(i, tr=tr, st=st):
                        tr.generator.manual_seed(step_seed(t.seed, 100 + i))
                        tr._compiled_train(st, batches[i], tr.generator)

                    prof = profile_serving.profile_engine(step, 2)
                    line["trace_" + mode] = {
                        k: prof[k] for k in ("wall_ms_per_batch", "device_busy_ms_per_batch",
                                             "idle_share", "kernels_per_batch")}
            for k, v in capt["launches"].items():
                launches_total[k] = launches_total.get(k, 0) + v
            emit(dict(line, card=smi))
            del eager, capt
        finally:
            if group:
                torch.distributed.destroy_process_group()
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return {"train_captured": launches_total}


def nondeterminism(dev, cfg, preprocess, state0, batches) -> dict:
    """The steps with cuDNN free to pick its nondeterministic algorithms:
    how many leaves two eager runs of two steps differ in (why every step
    runs ``_device.deterministic_convs``), and the captured step's ms per
    step that way (the device time the deterministic algorithms cost)."""
    from tumblr_emotions_torch.train import trainer as trainer_lib

    saved = trainer_lib.deterministic_convs
    trainer_lib.deterministic_convs = contextlib.nullcontext
    try:
        runs = [fit_case(dev, cfg, preprocess, state0, batches[:2], [], True)["ts"]
                for _ in range(2)]
        captured = fit_case(dev, cfg, preprocess, state0, batches, [], False)
    finally:
        trainer_lib.deterministic_convs = saved
    return {"leaves_differing_between_two_eager_runs": len(state_differences(*runs)),
            "ms_per_step_captured": captured["ms_steady"]}


def restore_check(dev, cfg, preprocess, state0, batches, straight):
    """The captured f32 joint run checkpointed at step RESTORE_AT, restored
    into fresh tensors (the graphs captured on the old ones dropped) and
    trained on: bit-equal to the straight captured run ``straight``."""
    import os
    import shutil

    from tumblr_emotions_torch.train.trainer import Trainer

    work = os.path.abspath(os.path.join("build", "chip_smoke", "restore"))
    shutil.rmtree(work, ignore_errors=True)
    rcfg = cfg.replace(train=cfg.train.replace(checkpoint_dir=work,
                                               checkpoint_every=RESTORE_AT))
    try:
        with train_options(None):
            tr = Trainer(rcfg, preprocess=preprocess, device=dev).compile()
        if tr.step_mode != "captured":
            fail(f"train_captured restore: step_mode {tr.step_mode}")
        tr.checkpoint_manager()
        ts = tr.fit(tr.init_state(state0), batches[:RESTORE_AT], num_steps=RESTORE_AT)
        program = tr._programs.get("train")
        first = program and program.replays
        restored = tr.restore_latest(tr.init_state(state0))
        if restored.step != RESTORE_AT or any(
                restored.state[k].data_ptr() == ts.state[k].data_ptr() for k in ts.state):
            fail(f"train_captured restore: restored step {restored.step}, or onto the live "
                 "tensors")
        del ts
        ts = tr.fit(restored, batches[RESTORE_AT:], num_steps=len(batches) - RESTORE_AT)
        differ = state_differences(ts, straight)
        graphs = program and program._cache_size()
        if differ or graphs != 1:
            fail(f"train_captured restore: the resumed run differs from the straight one in "
                 f"{differ[:5]} ({len(differ)} leaves); graphs {graphs}")
        return {"at_step": RESTORE_AT, "bit_equal_to_straight": True,
                "replays_before": first, "replays_after": program and program.replays,
                "checkpoint_bytes": tr.last_save and tr.last_save["bytes"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def tune_train_phase(dev, smi):
    """Phase tune_train: ``cli tune --step train`` (joint_finetune in perf
    mode) at full width, batch TUNE_TRAIN_BATCH, on the card: both
    candidates measured, then the winner from its cache."""
    import io
    import shutil
    import tempfile
    from contextlib import redirect_stdout
    from pathlib import Path

    from tumblr_emotions_torch import cli

    tmp = Path(tempfile.mkdtemp(prefix="tet_tune_train_"))
    try:
        argv = ["tune", "--step", "train", "--batch-size", str(TUNE_TRAIN_BATCH),
                "--image-size", str(SRC_HW), "--cache", str(tmp / "tune.json"), "--device",
                DEVICE]
        if DEPTH != 1.0:
            argv += ["--depth-multiplier", str(DEPTH)]
        runs = []
        for _ in range(2):
            t = time.perf_counter()
            out = io.StringIO()
            with redirect_stdout(out):
                cli.main(argv)
            runs.append((json.loads(out.getvalue().splitlines()[-1]), time.perf_counter() - t))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (first, s1), (second, s2) = runs
    keys = {"step", "batch_size", "best_options", "best_images_per_sec",
            "candidates_measured", "from_cache", "apply_hint", "results"}
    if set(first) != keys or first["from_cache"] or first["candidates_measured"] != 2 \
            or not second["from_cache"] or second["best_options"] != first["best_options"] \
            or "TET_TORCH_TRAIN_COMPILER_OPTIONS" not in first["apply_hint"]:
        fail(f"tune_train: first {first}, second {second}")
    emit({"phase": "tune_train", **first, "second_from_cache": second["from_cache"],
          "seconds": [s1, s2], "card": smi})


def accuracy_smoke_phase(dev, smi):
    """Phase accuracy_smoke: the synthetic accuracy benchmark's text run
    (``synthetic_accuracy.run_preset``) for ACC_TEXT_STEPS steps, whose
    final wide eval comes within ACC_TEXT_TOL of the text Bayes ceiling
    (the reference's converges by step 200), and ACC_IMAGE_STEPS of the end-
    to-end image run on the captured step, whose loss falls (the mean of the
    last 10 steps' below the first 10's).  The full run is its own command,
    ``python -m tumblr_emotions_torch.synthetic_accuracy``."""
    import numpy as np

    from tumblr_emotions_torch import synthetic_accuracy as sa

    ceilings = sa.exact_ceilings()
    text, _ = sa.run_preset("text_only", ACC_TEXT_STEPS, dev, log=lambda line: None)
    losses = []
    image, _ = sa.run_preset("image_frozen", ACC_IMAGE_STEPS, dev,
                             extra={"optimizer": "adam", "learning_rate": 3e-4,
                                    "trainable_scopes": ""},
                             tag="image_e2e", log=lambda line: None, losses=losses)
    losses = [float(x) for x in losses]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if text["step_mode"] != "captured" or image["step_mode"] != "captured":
        fail(f"accuracy_smoke: step modes {text['step_mode']}, {image['step_mode']}")
    if text["final_eval_acc"] < ceilings["text"] - ACC_TEXT_TOL:
        fail(f"accuracy_smoke: text top-1 {text['final_eval_acc']} after {ACC_TEXT_STEPS} "
             f"steps, more than {ACC_TEXT_TOL} below its ceiling {ceilings['text']}")
    if not (np.all(np.isfinite(losses)) and last < first):
        fail(f"accuracy_smoke: image e2e losses {losses}")
    emit({"phase": "accuracy_smoke", "bayes_ceilings": ceilings,
          "text": {k: text[k] for k in ("steps", "final_eval_acc", "curve", "img_s")},
          "image_e2e": {"steps": ACC_IMAGE_STEPS, "loss_first_10": first,
                        "loss_last_10": last, "final_eval_acc": image["final_eval_acc"],
                        "img_s": image["img_s"]},
          "card": smi})


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_perf_phase(dev, smi):
    """Phase 17, train_perf: this slice's main path, the data_parallel
    preset trained in perf mode (bf16 on f32 masters) at full width in a
    world-size-1 NCCL group, with the event writer and the profiler hook.
    One process has no group in the trainer (``create_mesh``), so ``fit``
    runs the plain step, as the reference runs plain jit on one device;
    then 3 steps of the collective path (a mesh given the NCCL group) time
    what the collectives cost.  Then a batch-4 perf step on the card against
    the CPU's, and the bf16 model's eval-mode gradients.  Fit's launches:
    every batch-normed conv's batch norm kernels (BN_PER_LAYER) on each of
    the PERF_STEPS steps (fit's step is captured on the card: the first
    step's warm-up from Python, the train graph's nodes on the replays), and
    no served kernel.  Returns the launches from Python."""
    import dataclasses
    import glob
    import os
    import shutil

    import numpy as np
    import torch

    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.data import preprocessing as pp
    from tumblr_emotions_torch.models import build_model, joint_model
    from tumblr_emotions_torch.ops import int8_conv as ic
    from tumblr_emotions_torch.parallel import distributed
    from tumblr_emotions_torch.parallel import mesh as mesh_lib
    from tumblr_emotions_torch.train import noise_floor
    from tumblr_emotions_torch.train.trainer import Trainer
    from tumblr_emotions_torch.utils import summaries

    work = os.path.abspath(os.path.join("build", "chip_smoke", "train_perf"))
    shutil.rmtree(work, ignore_errors=True)
    cfg = get_preset("data_parallel")
    preset_batch = cfg.train.batch_size
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=DEPTH),
                      train=cfg.train.replace(batch_size=PERF_BATCH, log_every=1, log_dir=work,
                                              profile_start_step=PERF_PROFILE[0],
                                              profile_num_steps=PERF_PROFILE[1]))
    t = cfg.train
    vocab = cfg.text.vocab_size
    rng = np.random.RandomState(SEED + 5)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    state0 = joint_model.init_state(build_model(cfg, device="meta"), SEED)
    batches = [train_batch(gen, rng, dev, PERF_BATCH, vocab) for _ in range(PERF_STEPS)]

    distributed.init_group(f"127.0.0.1:{free_port()}", 1, 0, device=dev, backend="nccl")
    try:
        tr = Trainer(cfg, preprocess="train", device=dev)
        if tr.group is not None or torch.distributed.get_backend() != "nccl":
            fail("train_perf: one process must run the plain step beside an NCCL group")
        if tr.model.dtype != torch.bfloat16:
            fail("train_perf: the perf model is not bf16")
        ts = tr.init_state(state0)
        starts = []
        losses = record_steps(tr, starts, "loss")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        t0 = time.perf_counter()
        ts = tr.fit(ts, batches, num_steps=PERF_STEPS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = all_launches()
        launches["conv_int8 byte path"] = ic.conv_int8.byte_launches
        peak = torch.cuda.max_memory_allocated()
        step_ms = [1e3 * (b - a) for a, b in zip(starts, starts[1:] + [t0 + fit_s])]
        losses = [float(x) for x in losses]
        # fit compiles the step: captured, the first step's warm-up runs
        # from Python and the graph's nodes replay the rest
        captured = tr.step_mode == "captured"
        check_bn_launches("train_perf", launches, 1 if captured else PERF_STEPS)
        per_step = {k: n * BN_LAYERS for k, n in BN_PER_LAYER.items()}
        if captured:
            (g,) = tr._programs["train"].kernel_nodes()
            if bn_nodes(g["kernels"]) != per_step or g["replays"] != PERF_STEPS - 1:
                fail(f"train_perf: batch norm nodes {bn_nodes(g['kernels'])} replayed "
                     f"{g['replays']} times, expected {per_step} replayed {PERF_STEPS - 1}")
            BN_GRAPH_RUNS["train_perf"] = {
                "replays": g["replays"],
                "device_launches": {k: launches[k] + per_step[k] * g["replays"]
                                    for k in BN_PER_LAYER}}
        if len(losses) != PERF_STEPS or not all(np.isfinite(losses)):
            fail(f"train_perf: losses {losses}")
        if ts.step != PERF_STEPS or ts.opt_state["count"] != PERF_STEPS:
            fail(f"train_perf: step {ts.step}, optimizer count {ts.opt_state['count']}")
        trained = {k: v.detach().cpu() for k, v in ts.state.items()}
        head = "InceptionV3.Logits/Conv2d_1c_1x1."
        unmoved = [k for k in tr.param_keys
                   if torch.equal(trained[k], state0[k]) and not k.startswith(head)]
        stats = [k for k in state0 if k.endswith(("moving_mean", "moving_variance"))]
        still = [k for k in stats if torch.equal(trained[k], state0[k])]
        if unmoved or still:
            fail(f"train_perf: unmoved leaves {unmoved[:3]}, statistics {still[:3]}")
        # the stages of a step, CUDA events over 3 more steps
        ev_t = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        split = {"preprocess": 0.0, "forward_backward": 0.0, "update": 0.0}
        for b in batches[:3]:
            ev_t[0].record()
            inputs = tr.train_inputs(b, gen)
            ev_t[1].record()
            _, _, grads = tr.loss_and_grads(ts, inputs, gen)
            ev_t[2].record()
            tr.apply_gradients(ts, grads)
            ev_t[3].record()
            ev_t[3].synchronize()
            for i, name in enumerate(split):
                split[name] += ev_t[i].elapsed_time(ev_t[i + 1]) / 3
        del grads, inputs
        # the collective path on the NCCL group (world size 1: every
        # all-reduce returns its input) against the plain step from the
        # trained state: one step to warm up, then 3 timed on the host clock
        collective = {}
        nccl = mesh_lib.Mesh(1, 0, torch.distributed.group.WORLD)
        for name, mesh in (("plain", None), ("collective", nccl)):
            trm = Trainer(cfg.replace(train=t.replace(log_dir="", profile_start_step=0)),
                          preprocess="train", device=dev, mesh=mesh)
            tsm = trm.init_state({k: v.detach() for k, v in ts.state.items()})
            tsm, _ = trm.train_step(tsm, batches[3], gen)
            cl = []
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            for b in batches[:3]:
                tsm, m = trm.train_step(tsm, b, gen)
                cl.append(float(m["loss"]))
            torch.cuda.synchronize()
            collective[name] = {"ms_per_step": 1e3 * (time.perf_counter() - c0) / 3,
                                "losses": cl}
            del trm, tsm
        if (torch.distributed.get_backend(nccl.group) != "nccl"
                or not all(np.isfinite(collective["collective"]["losses"]))):
            fail(f"train_perf: the collective path on NCCL: {collective}")
        collective["overhead_ms_per_step"] = (collective["collective"]["ms_per_step"]
                                              - collective["plain"]["ms_per_step"])
    finally:
        torch.distributed.destroy_process_group()

    # the profiler hook's trace: the card's kernels, steps 6 and 7 only
    trace = json.load(open(tr.last_trace))["traceEvents"]
    kernel_events = [e for e in trace if e.get("cat") == "kernel"]
    kernels = len(kernel_events)
    # where the device time goes: kernel time per step by kernel name
    per_name = {}
    for e in kernel_events:
        per_name[e["name"]] = per_name.get(e["name"], 0.0) + e.get("dur", 0.0) / 1e3
    busy_ms = sum(per_name.values()) / PERF_PROFILE[1]
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    ranges = sorted({e["name"] for e in trace if str(e.get("name", "")).startswith("train_step ")})
    want_ranges = [f"train_step {s}" for s in range(PERF_PROFILE[0], sum(PERF_PROFILE))]
    if kernels == 0 or ranges != want_ranges:
        fail(f"train_perf: trace {tr.last_trace}: {kernels} kernel events, ranges {ranges}")
    # the event file reads back what fit wrote
    (events,) = glob.glob(os.path.join(work, "events.out.tfevents.*"))
    scalars = summaries.read_scalars(events)
    want_loss = [(i + 1, float(np.float32(v))) for i, v in enumerate(losses)]
    if scalars.get("train/loss") != want_loss or sorted(scalars) != sorted(
            ["train/loss", "train/accuracy", "train/examples_per_sec", "train/learning_rate"]):
        fail(f"train_perf: the event file holds {sorted(scalars)}, loss "
             f"{scalars.get('train/loss')} != {want_loss}")

    # one batch-4 perf step on the card against the CPU's (dropout off, the
    # same distortion draws), in three parts.  The distorted images within
    # PERF_IMAGE_ATOL of the CPU's (they still flip some bf16 roundings of
    # the input, which the model amplifies: tumblr_emotions_torch/
    # perf_noise.py).  The model on the CPU's images: the loss, the batch
    # statistics and the gradients within TRAIN_NOISE_FACTOR of the CPU's
    # own floor (its step under float64 accumulation, and from weights moved
    # by TRAIN_NOISE_EPS and brightness nudged as much), the gradients as a
    # whole and each leaf whose floor is under SIGNAL_FLOOR, a check that
    # refuses no gradient and a reversed one.  The update the card's
    # optimizer makes from the CPU's gradients, within PERF_UPDATE_RTOL of
    # each of the CPU's parameters.  Then the eval-mode gradients of the
    # whole bf16 model (batch norm on its moving statistics, so rounding
    # noise is not amplified), within TRAIN_NOISE_FACTOR of the CPU's
    # float64 floor.
    ccfg = cfg.replace(image=cfg.image.replace(dropout_keep_prob=1.0),
                       train=t.replace(batch_size=PERF_CPU_BATCH, log_dir="",
                                       profile_start_step=0))
    b4 = {k: v[:PERF_CPU_BATCH] for k, v in batches[0].items()}
    draws = pp.draw_train(torch.Generator().manual_seed(SEED), PERF_CPU_BATCH,
                          (SRC_HW, SRC_HW))
    t0 = time.perf_counter()
    loss_cpu, g_cpu, st_cpu, tr_p, ts_p, images = perf_grads(ccfg, state0, b4, draws, "cpu")
    loss_own, _, _, _, _, own_images = perf_grads(ccfg, state0, b4, draws, dev)
    loss_card, g_card, st_card, tr_c, ts_c, _ = perf_grads(ccfg, state0, b4, draws, dev, images)
    with noise_floor.float64_accumulation():
        floors = [perf_grads(ccfg, state0, b4, draws, "cpu")[:3]]
    for seed in TRAIN_NOISE_SEEDS:
        g = torch.Generator().manual_seed(seed)
        moved = {k: v * (1 + TRAIN_NOISE_EPS * torch.randn(v.shape, generator=g))
                 for k, v in state0.items()}
        nudged = dataclasses.replace(draws, delta=draws.delta + TRAIN_NOISE_EPS * torch.randn(
            PERF_CPU_BATCH, generator=g))
        floors.append(perf_grads(ccfg, moved, b4, nudged, "cpu")[:3])
    gkeys = [k for k in g_cpu if bool(g_cpu[k].any())]
    grads_held = noise_floor.hold(g_card, g_cpu, g_cpu, [f[1] for f in floors], None, gkeys,
                                  TRAIN_NOISE_FACTOR, 2.0 ** -7, 2.0 ** -6)
    held = {"image_max_abs_diff": float((own_images - images).abs().max()),
            "loss_rel_diff_own_images": abs(loss_own - loss_cpu) / abs(loss_cpu),
            "loss_rel_diff": abs(loss_card - loss_cpu) / abs(loss_cpu),
            "loss_noise_floors": [abs(f[0] - loss_cpu) / abs(loss_cpu) for f in floors],
            "stats_to_cpu": noise_floor.distance(st_card, state0, st_cpu, state0, stats),
            "stats_noise_floors": [noise_floor.distance(f[2], state0, st_cpu, state0, stats)
                                   for f in floors],
            "grads_to_cpu": grads_held["to_ref"], "grads_noise_floor": grads_held["floor"],
            "grads_signal_leaves": grads_held["signal_leaves"],
            "grads_refuse_none_and_reversed": [grads_held["refuses_noop"],
                                               grads_held["refuses_flip"]]}
    if held["image_max_abs_diff"] > PERF_IMAGE_ATOL:
        fail(f"train_perf: the card's distorted images {held['image_max_abs_diff']} from the "
             f"CPU's")
    for what in ("loss", "stats"):
        got, floor = held[what + ("_rel_diff" if what == "loss" else "_to_cpu")], float(
            np.mean(held[what + "_noise_floors"]))
        if got > TRAIN_NOISE_FACTOR * floor + 1e-5:
            fail(f"train_perf: {what} of a batch-4 perf step {got} from the CPU's, above "
                 f"{TRAIN_NOISE_FACTOR} x its floor {floor}")
    if not (grads_held["ok"] and grads_held["refuses_noop"] and grads_held["refuses_flip"]):
        fail(f"train_perf: gradients of a batch-4 perf step {grads_held['to_ref']} from the "
             f"CPU's (limit {grads_held['limit']}), leaves {grads_held['failed_leaves']}, "
             f"refusing no gradient {grads_held['refuses_noop']} and a reversed one "
             f"{grads_held['refuses_flip']}")
    tr_c.apply_gradients(ts_c, {k: v.to(dev) for k, v in g_cpu.items()})
    tr_p.apply_gradients(ts_p, g_cpu)
    after_c = {k: ts_c.state[k].detach().cpu() for k in gkeys}
    after_p = {k: ts_p.state[k].detach() for k in gkeys}
    held["update_from_cpu_grads"] = noise_floor.distance(after_c, state0, after_p, state0,
                                                         gkeys)
    held["update_max_rel_diff"], held["update_worst_leaf"] = max((float((
        (after_c[k] - after_p[k]).abs()
        / torch.maximum(state0[k].abs(), after_p[k].abs()).clamp_min(1e-30)).max()), k)
        for k in gkeys)
    if held["update_max_rel_diff"] > PERF_UPDATE_RTOL:
        fail(f"train_perf: the card's update from the CPU's gradients is "
             f"{held['update_max_rel_diff']} of a parameter from the CPU's "
             f"({held['update_worst_leaf']})")
    del tr_c, ts_c, tr_p, ts_p
    ecfg = ccfg.replace(train=ccfg.train.replace(trainable_scopes=""))
    e_card, e_cpu = eval_mode_grads(ecfg, state0, b4, dev), eval_mode_grads(ecfg, state0, b4,
                                                                          "cpu")
    with noise_floor.float64_accumulation():
        e_f64 = eval_mode_grads(ecfg, state0, b4, "cpu")
    eval_held = noise_floor.hold(e_card, e_cpu, e_cpu, [e_f64], None, list(e_cpu),
                                 TRAIN_NOISE_FACTOR, 2.0 ** -7, 2.0 ** -6)
    held["eval_mode_grads"] = {k: eval_held[k] for k in ("to_ref", "floor", "limit")}
    if not eval_held["ok"] or eval_held["limit"] >= 0.5:
        fail(f"train_perf: eval-mode gradients {eval_held['to_ref']} from the CPU's, limit "
             f"{eval_held['limit']}, leaves {eval_held['failed_leaves']}")
    cpu_s = time.perf_counter() - t0

    traced = range(PERF_PROFILE[0], sum(PERF_PROFILE))
    untraced = [ms for s, ms in enumerate(step_ms, 1) if s > 1 and s not in traced]
    steady = float(np.median(untraced))
    bound_ms = 3 * 2 * tower_macs(cfg) * PERF_BATCH / H100_BF16_FLOPS * 1e3
    emit({"phase": "train_perf", "config": "data_parallel", "precision_mode": "perf",
          "depth": DEPTH, "image_size": cfg.image.image_size, "vocab": vocab,
          "embed": cfg.text.embed_dim, "optimizer": t.optimizer, "lr": t.learning_rate,
          "batch_per_process": PERF_BATCH, "processes": 1, "backend": "nccl",
          "reduced": {"batch": f"{PERF_BATCH} per process: the preset's {preset_batch} over "
                               "the reference's 8-device mesh, on one card",
                      "steps": f"{PERF_STEPS} of {t.num_steps}"},
          "steps": PERF_STEPS, "losses": losses, "fit_s": fit_s,
          "ms_per_step_each": step_ms, "ms_per_step_steady": steady,
          "ms_per_step_steady_mean": float(np.mean(untraced)),
          "examples_per_s_steady": 1e3 * PERF_BATCH / steady,
          "ms_per_step_split": split, "ms_per_step_split_sum": sum(split.values()),
          "timing": "each: host clock per step of fit (it reads every loss); steady: the "
                    "median (and mean) of steps 2-8 but the profiler's (6-7), one step of "
                    "seconds seen among them; split: CUDA events around the three stages of "
                    "3 more steps; trace: device time of the profiled steps",
          "peak_memory_gb": peak / 2 ** 30, "bound_ms_bf16": bound_ms,
          "bound_note": "3 x 2 x the tower's multiply-adds x batch over the bf16 peak",
          "launches": launches,
          "trace": {"path": os.path.relpath(tr.last_trace), "kernel_events": kernels,
                    "ranges": ranges, "kernels_per_step": kernels / PERF_PROFILE[1],
                    "device_busy_ms_per_step": busy_ms,
                    "top_kernels_ms_per_step": {n[:90]: ms / PERF_PROFILE[1] for n, ms in top}},
          "event_file_tags": sorted(scalars),
          "collective_path_world_1": collective,
          "held_against_cpu": dict(held, batch=PERF_CPU_BATCH, noise_factor=TRAIN_NOISE_FACTOR,
                                   noise_eps=TRAIN_NOISE_EPS, cpu_seconds=cpu_s),
          "card": smi})
    print(smi, flush=True)
    return {"train_perf": launches}


def record_steps(tr, starts=None, key=None) -> list:
    """Compile ``tr`` and keep what each step of its compiled train step
    returns (its metrics dict, or the metric ``key``), on the device, in the
    list returned, and in ``starts`` the host clock when each step began."""
    if tr._compiled_train is None:
        tr.compile()
    out, step = [], tr._compiled_train

    def recorded(*a, **k):
        if starts is not None:
            starts.append(time.perf_counter())
        state, m = step(*a, **k)
        out.append(m if key is None else m[key])
        return state, m

    tr._compiled_train = recorded
    return out


def train_batch(gen, rng, dev, n, vocab, weight=None):
    """A seeded uint8 [n,347,347,3] batch made on the card (low-frequency
    colour patterns plus noise), [n,50] ids with lengths 0-50, labels."""
    import torch
    import torch.nn.functional as F

    from tumblr_emotions_torch.data.vocab import synthetic_ids

    lo = torch.rand((n, 3, 8, 8), generator=gen, device=dev) * 255
    im = F.interpolate(lo, size=(SRC_HW, SRC_HW), mode="bilinear", align_corners=False)
    im = im + torch.randn(im.shape, generator=gen, device=dev) * 20
    tokens = torch.from_numpy(synthetic_ids(rng, n, TEXT_T, vocab)).to(dev)
    b = {"image": im.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous(),
         "tokens": tokens, "lengths": (tokens != 0).sum(-1).int(),
         "label": torch.randint(0, 15, (n,), generator=gen, device=dev)}
    if weight is not None:
        b["weight"] = torch.tensor(weight, dtype=torch.int32, device=dev)
    return b


def train_one_step(cfg, state, batch, draws, where):
    """One train step from ``state`` on ``where``: (loss, state on the CPU)."""
    from tumblr_emotions_torch.train.trainer import Trainer

    tr = Trainer(cfg, preprocess="train" if cfg.model != "text" else None, device=where)
    ts = tr.init_state(state)
    ts, m = tr.train_step(ts, {k: v.to(where) for k, v in batch.items()},
                          draws=None if draws is None else draws.to(where))
    return float(m["loss"]), {k: v.detach().cpu() for k, v in ts.state.items()}


def update_distance(a, a0, b, b0, keys):
    """||(a - a0) - (b - b0)|| / ||b - b0|| over ``keys`` (dicts of CPU
    tensors): how far update a is from update b."""
    from tumblr_emotions_torch.train.noise_floor import distance

    return distance(a, a0, b, b0, keys)


def perf_grads(cfg, state, batch, draws, where, images=None):
    """A train step's loss, gradients and moved batch statistics on
    ``where`` (CPU tensors), its trainer and state before the update, and
    its distorted images (on the CPU); ``images``: distorted images to run
    the model on instead."""
    from tumblr_emotions_torch.train.trainer import Trainer

    tr = Trainer(cfg, preprocess="train", device=where)
    ts = tr.init_state(state)
    inputs = tr.train_inputs({k: v.to(where) for k, v in batch.items()}, None,
                             draws.to(where))
    if images is not None:
        inputs = dict(inputs, image=images.to(where))
    loss, _, grads = tr.loss_and_grads(ts, inputs)
    stats = {k: v.detach().cpu() for k, v in ts.state.items()
             if k.endswith(("moving_mean", "moving_variance"))}
    return (float(loss), {k: g.detach().cpu() for k, g in grads.items()}, stats, tr, ts,
            inputs["image"].detach().cpu())


def eval_mode_grads(cfg, state, batch, where):
    """The gradients of the loss (cross-entropy and L2) of every parameter
    the loss reaches, with the model in eval mode, on ``where`` (CPU
    tensors)."""
    import torch

    from tumblr_emotions_torch.train.trainer import Trainer, cross_entropy, l2_regularization

    tr = Trainer(cfg, preprocess="eval", device=where)
    ts = tr.init_state(state)
    keys = tr.trainable_keys(ts)
    with torch.enable_grad():
        tr.model.eval()
        inputs = tr._maybe_preprocess(tr._to_device(batch), False, None, None)
        logits, _ = torch.func.functional_call(tr.model, ts.state, tr._model_args(inputs))
        loss = cross_entropy(logits, inputs["label"]) + l2_regularization(
            ts.state, cfg.train.weight_decay)
        gs = torch.autograd.grad(loss, [ts.state[k] for k in keys], allow_unused=True)
    return {k: g.detach().cpu() for k, g in zip(keys, gs) if g is not None}


def dp_setup():
    """train_dp's configuration, initial state, global train batches and
    eval shards (host arrays made from seeds)."""
    import numpy as np

    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.data.vocab import synthetic_ids
    from tumblr_emotions_torch.models import build_model, joint_model

    cfg = get_preset("joint_finetune")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=DP_DEPTH),
                      text=cfg.text.replace(vocab_size=DP_VOCAB),
                      train=cfg.train.replace(batch_size=DP_BATCH // 2, eval_batch_size=8,
                                              learning_rate=DP_LR, log_every=1,
                                              checkpoint_every=DP_FIRST))
    state = joint_model.init_state(build_model(cfg, device="meta"), SEED)

    def batch(seed, n):
        rng = np.random.RandomState(seed)
        tokens = synthetic_ids(rng, n, TEXT_T, DP_VOCAB)
        return {"image": rng.randint(0, 256, (n, DP_SRC, DP_SRC, 3)).astype(np.uint8),
                "tokens": tokens, "lengths": (tokens != 0).sum(-1).astype(np.int32),
                "label": rng.randint(0, 15, n).astype(np.int32)}

    train = [batch(100 + i, DP_BATCH) for i in range(DP_STEPS)]
    evals = [batch(200 + i, 8) for i in range(5)]
    shards = [evals[0::2], evals[1::2][:-1]]          # 3 and 1 batches: ragged
    return cfg, state, train, shards


def dp_child(rank: int, address: str, work: str) -> int:
    """One of train_dp's two processes: both share the one card over gloo."""
    import os

    import numpy as np
    import torch

    from tumblr_emotions_torch.parallel import distributed
    from tumblr_emotions_torch.train.trainer import Trainer

    torch.set_grad_enabled(False)
    dev = distributed.init_group(address, 2, rank, device="cuda")
    try:
        if torch.distributed.get_backend() != "gloo":
            fail("train_dp: two processes on one card must run on gloo")
        cfg, state0, train, shards = dp_setup()
        cfg = cfg.replace(train=cfg.train.replace(checkpoint_dir=os.path.join(work, "ck")))
        rows = slice(rank * DP_BATCH // 2, (rank + 1) * DP_BATCH // 2)
        local = [{k: v[rows] for k, v in b.items()} for b in train]
        tr = Trainer(cfg, preprocess="train", device=dev)
        tr.checkpoint_manager()
        tr.fit(tr.init_state(state0), local[:DP_FIRST], num_steps=DP_FIRST)
        tr = Trainer(cfg, preprocess="train", device=dev)
        tr.checkpoint_manager()
        ts = tr.restore_latest(tr.init_state(state0))
        if ts is None or ts.step != DP_FIRST:
            fail(f"train_dp: process {rank} restored {None if ts is None else ts.step}")
        ts = tr.fit(ts, local[DP_FIRST:], num_steps=DP_STEPS - DP_FIRST)
        torch.save({k: v.detach().cpu() for k, v in ts.state.items()},
                   os.path.join(work, f"final.{rank}.pt"))
        tr.preprocess = "eval"
        summary = tr.evaluate(ts, shards[rank])
        with open(os.path.join(work, f"eval.{rank}.json"), "w") as f:
            json.dump({k: np.asarray(v).tolist() for k, v in summary.items()}, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def train_dp_phase(dev, smi):
    """Phase 18, train_dp: two processes share the one card over gloo and
    train the joint model (depth DP_DEPTH, global batch DP_BATCH) for
    DP_FIRST steps, checkpoint, restart and train on; their end state
    against one process on the same global batches, and their lockstep
    eval over ragged shards against the unsharded eval."""
    import os
    import shutil
    import subprocess

    import numpy as np
    import torch

    from tumblr_emotions_torch.train.trainer import Trainer

    work = os.path.abspath(os.path.join("build", "chip_smoke", "train_dp"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    address = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=os.path.abspath("."), OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-child", str(r),
                               address, work], env=env) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=DP_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    children_s = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        fail(f"train_dp: child processes exited {[p.returncode for p in procs]}")
    finals = [torch.load(os.path.join(work, f"final.{r}.pt")) for r in range(2)]
    if any(not torch.equal(finals[0][k], finals[1][k]) for k in finals[0]):
        fail("train_dp: the two processes hold different states")
    cfg, state0, train, shards = dp_setup()
    cfg1 = cfg.replace(train=cfg.train.replace(batch_size=DP_BATCH))

    def one_process(state):
        tr = Trainer(cfg1, preprocess="train", device=dev)
        ts = tr.fit(tr.init_state(state), train, num_steps=DP_STEPS)
        return tr, {k: v.detach().cpu() for k, v in ts.state.items()}

    tr, ref = one_process(state0)
    floors = [(state0, one_process(state0)[1])]          # the card's own run to run
    for seed in TRAIN_NOISE_SEEDS[:2]:
        g = torch.Generator().manual_seed(seed)
        moved = {k: v * (1 + TRAIN_NOISE_EPS * torch.randn(v.shape, generator=g))
                 for k, v in state0.items()}
        floors.append((moved, one_process(moved)[1]))
    held = {}
    for what, keys in (("params", [k for k in tr.param_keys
                                   if not torch.equal(ref[k], state0[k])]),
                       ("stats", [k for k in state0
                                  if k.endswith(("moving_mean", "moving_variance"))])):
        got = update_distance(finals[0], state0, ref, state0, keys)
        fl = [update_distance(f, f0, ref, state0, keys) for f0, f in floors]
        held[what] = {"to_one_process": got, "noise_floors": fl}
        if got > TRAIN_NOISE_FACTOR * float(np.mean(fl)) + 1e-6:
            fail(f"train_dp: {what} of two processes {got} from one process's, above "
                 f"{TRAIN_NOISE_FACTOR} x the floor {np.mean(fl)}")
    # lockstep eval over ragged shards against the unsharded eval
    ev = Trainer(cfg, preprocess="eval", device=dev)
    want = ev.evaluate(ev.init_state(finals[0]), shards[0] + shards[1])
    for r in range(2):
        got = json.load(open(os.path.join(work, f"eval.{r}.json")))
        if (got["count"], got["accuracy"]) != (want["count"], want["accuracy"]) or \
                not np.array_equal(got["confusion"], want["confusion"]) or \
                abs(got["loss"] - want["loss"]) > 1e-5 * abs(want["loss"]):
            fail(f"train_dp: process {r}'s sharded eval {got['count']}/{got['accuracy']}/"
                 f"{got['loss']} != the unsharded {want['count']}/{want['accuracy']}/"
                 f"{want['loss']}")
    emit({"phase": "train_dp", "processes": 2, "backend": "gloo (two processes, one card)",
          "config": "joint_finetune", "depth": DP_DEPTH, "global_batch": DP_BATCH,
          "lr": DP_LR, "steps": f"{DP_FIRST} + checkpoint, restart + {DP_STEPS - DP_FIRST}",
          "held_against_one_process": dict(held, noise_factor=TRAIN_NOISE_FACTOR,
                                           noise_eps=TRAIN_NOISE_EPS),
          "eval": {"count": want["count"], "accuracy": want["accuracy"],
                   "loss": want["loss"], "shards": [len(s) for s in shards]},
          "children_s": children_s, "card": smi})


def cli_phase(dev, smi, held):
    """Phase 16, cli: the port's CLI from records on disk, at full width.
    convert-dataset and build-vocab (in process) over a posts CSV of the
    committed fixture JPEGs; train run A (6 steps, checkpoints every 3) and
    run B (3 steps, then resumed to 6 in a second process), each a
    subprocess; eval (subprocess) against Trainer.evaluate on the CPU;
    export-checkpoint read back; infer --engine int8 and the serve stack
    (in process, counting launches); predict (subprocess) against the
    Predictor.  ``held`` is train_joint's noise floor.  Returns {path:
    launches}."""
    import io
    import json as _json
    import os
    import re
    import shutil
    import subprocess
    import tempfile
    import threading
    import urllib.parse
    import urllib.request
    from contextlib import redirect_stdout
    from pathlib import Path

    import numpy as np
    import torch

    from tumblr_emotions_torch import EMOTIONS, analysis, cli, convert
    from tumblr_emotions_torch.data import jpeg, pipeline
    from tumblr_emotions_torch.data.vocab import Vocabulary
    from tumblr_emotions_torch.models import build_model
    from tumblr_emotions_torch.models.joint_model import tower_state
    from tumblr_emotions_torch.ops import quant
    from tumblr_emotions_torch.ops.serving import build_forward, joint_server
    from tumblr_emotions_torch.train.predict import Predictor
    from tumblr_emotions_torch.train.trainer import Trainer
    from tumblr_emotions_torch.utils.checkpoint import BundleReader, CheckpointManager

    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="tet_cli_"))
    times = {}
    try:
        # ---- the dataset: a posts CSV over the fixture JPEGs ----
        t0 = time.perf_counter()
        rng = np.random.RandomState(SEED + 4)
        fixtures = sorted((root / FIXTURES).glob("*.jpg"))
        (tmp / "images").mkdir()
        for f in fixtures:
            shutil.copy(f, tmp / "images" / f.name)
        letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
        words = sorted({"".join(rng.choice(letters, rng.randint(3, 9))) for _ in range(600)})
        captions = [" ".join(rng.choice(words + list(EMOTIONS), rng.randint(1, 30)))
                    for _ in range(CLI_POSTS)]
        with open(tmp / "posts.csv", "w") as f:
            f.write("id,text,label,image\n")
            for i, c in enumerate(captions):
                f.write(f"p{i},{c},{rng.randint(15)},{fixtures[i % len(fixtures)].name}\n")
        data = tmp / "data"
        vocab_path = str(data / "vocab.txt")
        out = io.StringIO()
        with redirect_stdout(out):
            cli.main(["convert-dataset", "--csv", str(tmp / "posts.csv"), "--images-dir",
                      str(tmp / "images"), "--out", str(data), "--num-shards", str(CLI_SHARDS),
                      "--valid-fraction", str(CLI_VALID)])
            cli.main(["build-vocab", "--csv", str(tmp / "posts.csv"), "--out", vocab_path,
                      "--min-freq", "1"])
        counts = _json.loads(out.getvalue().splitlines()[0])
        if counts["skipped"] or counts["train"] + counts["validation"] != CLI_POSTS \
                or counts["validation"] == 0:
            fail(f"cli: convert-dataset counted {counts}")
        vocab = Vocabulary.load(vocab_path)
        times["convert"] = time.perf_counter() - t0

        train_glob = str(data / "train-*.tfrecord")
        val_glob = str(data / "validation-*.tfrecord")
        width = [] if DEPTH == 1.0 else ["--depth-multiplier", str(DEPTH)]
        common = ["--preset", "joint_finetune", "--vocab", vocab_path, "--device", DEVICE,
                  "--batch-size", str(CLI_BATCH), *width]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))

        def run(name, *argv):
            """``python -m tumblr_emotions_torch.cli argv`` as a subprocess;
            its output goes to <tmp>/<name>.log."""
            log_path = tmp / f"{name}.log"
            with open(log_path, "w") as log_f:
                r = subprocess.run([sys.executable, "-m", "tumblr_emotions_torch.cli", *argv],
                                   cwd=root, env=env, stdout=log_f, stderr=subprocess.STDOUT,
                                   timeout=CLI_TIMEOUT_S)
            text = log_path.read_text()
            if r.returncode != 0:
                fail(f"cli: {name} exited {r.returncode}:\n{text[-3000:]}")
            return text

        def beside(name, *argv):
            """``run(name, *argv)`` on a thread beside the caller's work; the
            function returned waits for it: (its output, its seconds)."""
            box = {}

            def go():
                t = time.perf_counter()
                try:
                    box["out"] = run(name, *argv)
                except BaseException as e:  # noqa: BLE001 -- raised again by result()
                    box["error"] = e
                box["s"] = time.perf_counter() - t

            th = threading.Thread(target=go)
            th.start()

            def result():
                th.join(timeout=CLI_TIMEOUT_S + 60)
                if th.is_alive():
                    fail(f"cli: {name} did not end")
                if "error" in box:
                    raise box["error"]
                return box["out"], box["s"]

            return result

        def losses(text):
            return [float(x) for x in re.findall(r"step \d+ loss (\S+)", text)]

        # ---- the host's record pipeline: read, parse, decode+resize ----
        feed = pipeline.batches(train_glob, vocab, pipeline.PipelineConfig(
            batch_size=CLI_BATCH, max_len=50, decode_threads=8))
        next(feed)
        t0 = time.perf_counter()
        for _ in range(5):
            next(feed)
        feed_img_s = 5 * CLI_BATCH / (time.perf_counter() - t0)

        # ---- train: run A straight, run B stopped at 3 and resumed ----
        train = ["train", *common, "--records", train_glob, "--log-every", "1",
                 "--checkpoint-every", str(CLI_CKPT_EVERY)]
        t0 = time.perf_counter()
        log_a = run("train_a", *train, "--steps", str(CLI_STEPS), "--checkpoint-dir",
                    str(tmp / "A"))
        times["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        log_b1 = run("train_b1", *train, "--steps", str(CLI_CKPT_EVERY), "--checkpoint-dir",
                     str(tmp / "B"))
        log_b2 = run("train_b2", *train, "--steps", str(CLI_STEPS), "--checkpoint-dir",
                     str(tmp / "B"))
        times["resume"] = time.perf_counter() - t0
        saves = [(int(a), int(b), float(c), float(d)) for a, b, c, d in re.findall(
            r"checkpoint @ step (\d+): (\d+) bytes in (\S+) s \(written in (\S+) s\)", log_a)]
        all_losses = {"A": losses(log_a), "B": losses(log_b1) + losses(log_b2)}
        # ms per step from the examples/s fit logs each step (host clock
        # between two logs: a checkpoint's write falls in the next step's)
        step_ms = [1e3 * CLI_BATCH / float(x)
                   for x in re.findall(r"step \d+ loss \S+ acc \S+ \((\S+) ex/s", log_a)]
        for run_name, ls in all_losses.items():
            if len(ls) != CLI_STEPS or not all(np.isfinite(ls)):
                fail(f"cli: run {run_name} logged losses {ls}")
        if f"resumed at step {CLI_CKPT_EVERY} (input position restored)" not in log_b2:
            fail("cli: the second process of run B did not resume at step "
                 f"{CLI_CKPT_EVERY} with its input position")
        if [s_[0] for s_ in saves] != list(range(CLI_CKPT_EVERY, CLI_STEPS + 1,
                                                 CLI_CKPT_EVERY)):
            fail(f"cli: run A saved {saves}")
        pos_a = _json.loads((tmp / "A" / f"input_iterator_{CLI_STEPS}.json").read_text())
        pos_b = _json.loads((tmp / "B" / f"input_iterator_{CLI_STEPS}.json").read_text())
        if pos_a != pos_b or pos_a != {"epoch": CLI_STEPS * CLI_BATCH // counts["train"],
                                       "index": CLI_STEPS * CLI_BATCH % counts["train"]}:
            fail(f"cli: input positions at step {CLI_STEPS}: A {pos_a}, B {pos_b}")

        # run B's step-3 checkpoint restores exactly: the restore path the
        # resumed process ran, on the card, gives back every saved tensor
        args = cli.parser().parse_args(["eval", *common, "--records", val_glob])
        cfg = cli._build_config(args)
        cfg = cfg.replace(text=cfg.text.replace(vocab_size=vocab.size))
        state0 = cli._initial_state(cfg)
        tr = Trainer(cfg, preprocess="train", device=dev)
        tr.checkpoint_manager(str(tmp / "B"))
        fresh = tr.init_state(state0)
        b3 = tr.restore(fresh, CLI_CKPT_EVERY)
        saved = tr.checkpoint_manager().reader(CLI_CKPT_EVERY)
        restored = tr.state_tensors(b3)
        if sorted(restored) != sorted(saved.keys()) or any(
                not np.array_equal(v, saved.get_tensor(k)) for k, v in restored.items()):
            fail("cli: run B's step-3 checkpoint does not restore exactly")
        del b3, fresh, restored

        # run A against run B: the same steps, within train_joint's noise floor
        def params_of(directory, step):
            r = CheckpointManager(str(directory)).reader(step)
            return {k: r.get_tensor(k) for k in r.keys() if k.startswith("params/")}

        init = {f"params/{k.replace('.', '/')}": convert.to_jax_leaf(k, v)
                for k, v in state0.items() if not k.endswith(("moving_mean", "moving_variance"))}

        def update_distance(step):
            a, b = params_of(tmp / "A", step), params_of(tmp / "B", step)
            num = sum(float(((a[k].astype(np.float64) - b[k]) ** 2).sum()) for k in a)
            den = sum(float(((a[k].astype(np.float64) - init[k]) ** 2).sum()) for k in a)
            return (num / max(den, 1e-300)) ** 0.5

        d3, d6 = update_distance(CLI_CKPT_EVERY), update_distance(CLI_STEPS)
        floor = held["params_noise_floor"]
        if d3 > TRAIN_NOISE_FACTOR * floor + 1e-6:
            fail(f"cli: runs A and B at step {CLI_CKPT_EVERY} {d3} apart, above "
                 f"{TRAIN_NOISE_FACTOR} x train_joint's noise floor {floor}")

        # ---- eval and predict (subprocesses, beside Trainer.evaluate on the
        # CPU, which eval is held to) ----
        body, text = fixtures[1], captions[1]
        eval_job = beside("eval", "eval", *common, "--records", val_glob, "--checkpoint-dir",
                          str(tmp / "A"), "--out", str(tmp / "eval.json"))
        predict_job = beside("predict", "predict", *common, "--checkpoint-dir", str(tmp / "A"),
                             "--image", str(body), "--text", text)
        cpu_tr = Trainer(cfg, preprocess="eval", device="cpu")
        cpu_tr.checkpoint_manager(str(tmp / "A"))
        cpu_state = cpu_tr.restore_latest(cpu_tr.init_state(state0))
        val_batches = list(cli._make_batches(args, cfg, vocab, train=False))
        ev_cpu = cpu_tr.evaluate(cpu_state, val_batches)
        # the probabilities analyze collects, on the CPU (real rows only)
        cpu_probs = np.concatenate([cpu_tr.predict_step(cpu_state, b).numpy()[b["weight"] == 1]
                                    for b in val_batches])
        cpu_labels = np.concatenate([b["label"][b["weight"] == 1] for b in val_batches])
        times["eval"] = eval_job()[1]
        pred_out = predict_job()[0]
        ev = _json.loads((tmp / "eval.json").read_text().splitlines()[-1])
        if ev["step"] != CLI_STEPS or ev["count"] != counts["validation"] or \
                (ev["count"], ev["accuracy"]) != (ev_cpu["count"], ev_cpu["accuracy"]) or \
                not np.array_equal(np.asarray(ev["confusion"]), ev_cpu["confusion"]):
            fail(f"cli: eval {ev['count']}/{ev['accuracy']} (step {ev['step']}) differs from "
                 f"Trainer.evaluate on the CPU {ev_cpu['count']}/{ev_cpu['accuracy']} or in "
                 "the confusion matrix")
        weights = {k: v.detach() for k, v in cpu_state.state.items()}
        del cpu_tr, cpu_state

        # ---- export-checkpoint: the slim bundle holds the tower, bit for bit ----
        slim = str(tmp / "slim" / "model.ckpt")
        with redirect_stdout(io.StringIO()):
            cli.main(["export-checkpoint", *common, "--checkpoint-dir", str(tmp / "A"),
                      "--out", slim])
        exported, step_r = BundleReader(slim), CheckpointManager(str(tmp / "A")).reader(CLI_STEPS)
        tower_names = [k for k in step_r.keys()
                       if k.startswith(("params/InceptionV3/", "batch_stats/InceptionV3/"))]
        if len(exported.keys()) != len(tower_names) or any(
                not np.array_equal(exported.get_tensor(k.split("/", 1)[1]), step_r.get_tensor(k))
                for k in tower_names):
            fail("cli: the exported slim checkpoint's tower differs from the checkpoint's")

        # ---- infer --engine int8 --front s2d, in process, over the train
        # split (6 device batches; images/s counts only real rows) ----
        # (the runner the command builds is kept, to read its graphs)
        from tumblr_emotions_torch.ops import serving

        made, build = [], serving.build_forward
        serving.build_forward = lambda *a, **k: made.append(build(*a, **k)) or made[-1]
        t0 = time.perf_counter()
        reset_all_launches()
        out = io.StringIO()
        try:
            with redirect_stdout(out):
                cli.main(["infer", *common, "--records", train_glob, "--checkpoint-dir",
                          str(tmp / "A"), "--engine", "int8", "--front", "s2d",
                          "--probs-out", str(tmp / "probs.npy")])
        finally:
            serving.build_forward = build
        torch.cuda.synchronize()
        infer_launches = all_launches()
        times["infer"] = time.perf_counter() - t0
        inf = _json.loads(out.getvalue().splitlines()[-1])
        if len(made) != 1:
            fail(f"cli: infer built {len(made)} runners")
        GRAPH_RUNS["cli_infer"] = served_launches(
            "cli_infer", infer_launches, made[0].program.kernel_nodes(), inf["forwards"],
            INT8_PER_FORWARD)
        del made
        got = np.load(tmp / "probs.npy")
        # the plain int8 engine from the same checkpoint and calibration batch
        infer_batches = list(cli._make_batches(
            cli.parser().parse_args(["infer", *common, "--records", train_glob]),
            cfg, vocab, train=False))
        calib = cli._calibration(cfg, infer_batches[0]["image"], dev)
        w_dev = {k: v.to(dev) for k, v in weights.items()}
        kern = build_forward(cfg, w_dev, engine="int8", front="s2d", calib_images=calib,
                             device=dev)
        plain = quant.QuantizedInceptionV3(tower_state(w_dev), calib, stem_s2d="pre",
                                           use_kernels=False, device=dev)
        plain.scales = kern.engine.scales
        model = build_model(cfg, device=dev)
        model.load_state_dict(w_dev)
        plain_srv = joint_server(plain, model, device=dev)
        want = np.concatenate([
            plain_srv(b["image"], torch.as_tensor(b["tokens"]).to(dev),
                      torch.as_tensor(b["lengths"]).to(dev)).cpu().numpy()[b["weight"] == 1]
            for b in infer_batches])
        if got.shape != want.shape or not np.isfinite(got).all():
            fail(f"cli: infer probabilities {got.shape}, plain {want.shape}")
        infer_diff = float(np.abs(got - want).max())
        if infer_diff > INT8_PROB_TOL:
            fail(f"cli: infer probabilities {infer_diff} from the plain int8 engine > "
                 f"{INT8_PROB_TOL}")
        del kern, plain, plain_srv, model, infer_batches

        # ---- infer --dp: every card of the machine, equal to the run above ----
        out = io.StringIO()
        with redirect_stdout(out):
            cli.main(["infer", *common, "--records", train_glob, "--checkpoint-dir",
                      str(tmp / "A"), "--engine", "int8", "--front", "s2d", "--dp",
                      "--probs-out", str(tmp / "probs_dp.npy")])
        inf_dp = _json.loads(out.getvalue().splitlines()[-1])
        if inf_dp["devices"] != torch.cuda.device_count() or inf["devices"] != 1 or \
                not np.array_equal(np.load(tmp / "probs_dp.npy"), got):
            fail(f"cli: infer --dp took {inf_dp['devices']} devices of "
                 f"{torch.cuda.device_count()}, or its probabilities differ from infer's")

        # ---- serve --engine int8 --port 0, in process through cli.build_server,
        # counted from the server's start (its warm-up, which captures the
        # runner) ----
        t0 = time.perf_counter()
        reset_all_launches()
        sargs_argv = ["serve", *common, "--records", val_glob, "--checkpoint-dir",
                      str(tmp / "A"), "--engine", "int8", "--host", "127.0.0.1", "--port",
                      "0", "--max-delay-ms", str(HTTP_MAX_DELAY_MS)]
        sargs = cli.parser().parse_args(sargs_argv)
        httpd, info = cli.build_server(sargs)
        runner = info["runner"]
        pick = [(fixtures[i % len(fixtures)], captions[i]) for i in range(CLI_SERVE_POSTS)]
        answers = {}

        def post(i):
            body, text = pick[i][0].read_bytes(), pick[i][1]
            req = urllib.request.Request(
                f"http://127.0.0.1:{info['port']}/predict?text={urllib.parse.quote(text)}",
                data=body, method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                answers[i] = _json.loads(r.read())

        try:
            httpd.serve_background()
            with urllib.request.urlopen(f"http://127.0.0.1:{info['port']}/healthz",
                                        timeout=60) as r:
                r.read()
            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(CLI_SERVE_POSTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            torch.cuda.synchronize()
            serve_launches = all_launches()
            serve_graphs = runner.program.kernel_nodes()
            stats = httpd.predictor.stats.snapshot(httpd.predictor.batch_size)
        finally:
            httpd.close()
        times["serve"] = time.perf_counter() - t0
        if len(answers) != CLI_SERVE_POSTS or stats["errors"]:
            fail(f"cli: serve answered {len(answers)} of {CLI_SERVE_POSTS} posts, {stats}")
        # the warm-up and the served batches
        GRAPH_RUNS["cli_serve"] = served_launches("cli_serve", serve_launches, serve_graphs,
                                                  stats["batches"] + 1, INT8_PER_FORWARD)
        imgs = np.empty((CLI_SERVE_POSTS, sargs.host_size, sargs.host_size, 3), np.uint8)
        if any(jpeg.decode_resize_batch([b.read_bytes() for b, _ in pick], sargs.host_size,
                                        imgs)):
            fail("cli: fixture decode failed")
        tok, lens = vocab.encode_batch([c for _, c in pick], cfg.text.max_len)
        in_process = runner(imgs, tok, lens).cpu().numpy()
        serve_diff = max(abs(answers[i]["probs"][e] - float(in_process[i][k]))
                         for i in range(CLI_SERVE_POSTS) for k, e in enumerate(EMOTIONS))
        if serve_diff > HTTP_PROB_TOL:
            fail(f"cli: served answers {serve_diff} from the in-process runner > "
                 f"{HTTP_PROB_TOL}")
        del runner, httpd, info

        # ---- serve --dp: the stack over every card, its runner equal to serve's ----
        dp_httpd, dp_info = cli.build_server(cli.parser().parse_args(
            [*sargs_argv, "--dp"]))
        try:
            dp_httpd.serve_background()
            dp_answer = dp_info["runner"](imgs, tok, lens).cpu().numpy()
        finally:
            dp_httpd.close()
        if dp_info["devices"] != torch.cuda.device_count() or \
                not np.array_equal(dp_answer, in_process):
            fail(f"cli: serve --dp took {dp_info['devices']} devices of "
                 f"{torch.cuda.device_count()}, or its runner's answers differ from serve's")
        del dp_httpd, dp_info

        # ---- predict (run above) against the Predictor on the checkpoint ----
        got_p = _json.loads(pred_out[pred_out.index("{"):pred_out.rindex("}") + 1])
        want_p = Predictor(cfg, w_dev, vocab=vocab, device=dev).predict(body.read_bytes(), text)
        predict_diff = max(abs(got_p[e] - want_p[e]) for e in EMOTIONS)
        if next(iter(got_p)) != next(iter(want_p)) or predict_diff > PREDICT_TOL:
            fail(f"cli: predict {predict_diff} from the Predictor (top {next(iter(got_p))} vs "
                 f"{next(iter(want_p))})")

        # ---- analyze (in process) on run A's checkpoint, with --examples,
        # against the circumplex of the CPU's probabilities ----
        t0 = time.perf_counter()
        out = io.StringIO()
        with redirect_stdout(out):
            cli.main(["analyze", *common, "--records", val_glob, "--checkpoint-dir",
                      str(tmp / "A"), "--examples", str(tmp / "examples.md"), "--top-k", "3"])
        times["analyze"] = time.perf_counter() - t0
        report = (tmp / "examples.md").read_text()
        lines = out.getvalue().splitlines()
        coords = {ln.split()[0]: [float(v) for v in ln.split()[1:3]]
                  for ln in lines[2:2 + len(EMOTIONS)]}
        want_c = analysis.circumplex(cpu_probs, cpu_labels, emotions=EMOTIONS)["coords"]
        analyze_diff = max(abs(a - b) for e in EMOTIONS for a, b in zip(coords[e], want_c[e]))
        if sorted(coords) != sorted(EMOTIONS) or analyze_diff > ANALYZE_TOL or \
                any(f"## {e}" not in report for e in EMOTIONS) or "Confusion pairs" not in report:
            fail(f"analyze: circumplex {analyze_diff} from the CPU's, or a section missing "
                 f"from the report:\n{out.getvalue()[-2000:]}")
        arrayrecord_phase(smi, tmp, run, common, log_b1, np.load(tmp / "probs.npy"))
        workers_phase(smi, train_glob, vocab)
        emit({"phase": "analyze", "config": "joint_finetune", "depth": DEPTH,
              "posts": int(len(cpu_labels)), "explained_variance": lines[0],
              "coords_max_abs_diff_vs_cpu": analyze_diff, "tol": ANALYZE_TOL,
              "report_bytes": len(report), "seconds": times["analyze"], "card": smi})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cli", "config": "joint_finetune", "depth": DEPTH, "batch": CLI_BATCH,
          "posts": CLI_POSTS, "records": counts, "vocab": vocab.size, "steps": CLI_STEPS,
          "checkpoint_every": CLI_CKPT_EVERY, "losses": all_losses,
          "checkpoint_bytes": [s_[1] for s_ in saves],
          "checkpoint_save_s": [s_[2] for s_ in saves],
          "checkpoint_write_s": [s_[3] for s_ in saves],
          "input_position": pos_a, "step3_restore_exact": True,
          "host_feed_img_s_8_threads_small_fixtures": feed_img_s,
          "train_ms_per_step_run_a": step_ms,
          "update_distance_a_vs_b": {str(CLI_CKPT_EVERY): d3, str(CLI_STEPS): d6},
          "noise_floor": floor, "noise_factor": TRAIN_NOISE_FACTOR,
          "eval": {"count": ev["count"], "accuracy": ev["accuracy"], "loss": ev["loss"],
                   "equal_to_cpu": True},
          "exported_tower_tensors": len(tower_names),
          "infer": {k: inf[k] for k in ("examples", "accuracy", "images_per_sec", "forwards",
                                        "devices")},
          "infer_dp": {k: inf_dp[k] for k in ("images_per_sec", "devices")},
          "infer_launches": infer_launches, "infer_graphs": GRAPH_RUNS["cli_infer"],
          "infer_prob_max_abs_diff_vs_plain": infer_diff,
          "serve": {"posts": CLI_SERVE_POSTS, "device_batches": stats["batches"],
                    "latency_ms": stats["latency_ms"]},
          "serve_launches": serve_launches, "serve_graphs": GRAPH_RUNS["cli_serve"],
          "serve_prob_max_abs_diff_vs_in_process": serve_diff,
          "predict_max_abs_diff_vs_predictor": predict_diff,
          "seconds": times,
          "seconds_note": "eval: the subprocess's wall, run beside the predict subprocess and "
                          "the CPU's evaluate",
          "card": smi})
    return {"cli_infer": infer_launches, "cli_serve": serve_launches}


def captured_phase(dev, smi, state, batches, calib):
    """Phase captured: every served runner (int8 s2d, int8 uint8, int8
    float, bf16 cuDNN, bf16 with the block kernels, joint int8, text rnn) at
    full width as one CUDA graph per batch (``utils.compile_opts.capture``)
    against the same program launched op by op: bit for bit on the 3
    batches; the kernels' launches per batch, eager (the wrappers' counts)
    and captured (the graph's kernel nodes, read by name; the graph launches
    per batch from the runner); img/s of each, interleaved; the
    device idle share and kernels per batch from a trace; peak memory.
    Returns {path: launches} of the captured runs."""
    import numpy as np
    import torch

    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.data.vocab import synthetic_ids
    from tumblr_emotions_torch.models import build_model, joint_model, text_model
    from tumblr_emotions_torch.ops.inference import FusedInceptionV3
    from tumblr_emotions_torch.ops.serving import build_forward, image_server
    from tumblr_emotions_torch.profile_serving import profile_engine
    from tumblr_emotions_torch.utils.compile_opts import capture

    img = get_preset("fused_inference")
    img = img.replace(image=img.image.replace(depth_multiplier=DEPTH))
    joint = get_preset("joint_finetune")
    joint = joint.replace(image=joint.image.replace(depth_multiplier=DEPTH))
    text = get_preset("text_only")
    text = text.replace(text=text.text.replace(aggregator="rnn"))
    rng = np.random.RandomState(SEED + 7)
    tokens = [torch.from_numpy(synthetic_ids(rng, BATCH, TEXT_T, joint.text.vocab_size))
              .to(dev) for _ in batches]

    def image_args(i):
        return (batches[i],)

    def make(kind):
        """(program, its arguments for batch i, its probabilities)."""
        if kind == "bf16_kernels":
            srv = image_server(FusedInceptionV3(state, use_kernels=True, device=dev), device=dev)
            return srv.program, image_args, lambda out: out[0]
        if kind in ("joint_int8", "text_rnn"):
            cfg = joint if kind == "joint_int8" else text
            init = joint_model.init_state if kind == "joint_int8" else text_model.init_state
            r = build_forward(cfg, init(build_model(cfg, device="meta"), SEED),
                              engine="int8" if kind == "joint_int8" else "parity",
                              calib_images=calib, device=dev)
            if kind == "joint_int8":
                return r.program, lambda i: (batches[i], tokens[i], None), lambda out: out
            return r.program, lambda i: (None, tokens[i], None), lambda out: out
        engine, front = kind.split("_") if kind.startswith("int8") else ("bf16", "s2d")
        r = build_forward(img, state, engine=engine, front=front, calib_images=calib,
                          device=dev)
        return r.program, image_args, lambda out: out[0]

    results, paths = {}, {}
    for kind in ("int8_s2d", "int8_uint8", "int8_float", "bf16_cudnn", "bf16_kernels",
                 "joint_int8", "text_rnn"):
        t_kind = time.perf_counter()
        prog, args, probs_of = make(kind)
        if not prog.graphed:
            fail(f"captured: the {kind} runner is not captured (options {prog.options})")
        eager = capture(prog.fn, options=EAGER, device=dev)
        per_forward = (INT8_PER_FORWARD if kind.startswith("int8") or kind == "joint_int8"
                       else BF16_PER_FORWARD if kind == "bf16_kernels" else {})
        # the stem over 3 channels (uint8 and float fronts) takes the conv's
        # byte-load path
        byte_path = 1 if kind in ("int8_uint8", "int8_float") else 0

        def serve(p, i):
            return probs_of(p(*args(i)))

        # the path: each program on the 3 batches from its first call (the
        # captured program's warm-up and capture, then two replays), counts
        # from 0
        mem, runs, counted = {}, {}, {}
        for name, p in (("eager", eager), ("captured", prog)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
            reset_all_launches()
            runs[name] = [serve(p, i) for i in range(N_BATCHES)]
            torch.cuda.synchronize()
            launches = all_launches()
            counted[name] = served_launches(
                f"captured {kind} ({name})", launches,
                p.kernel_nodes() if name == "captured" else None, N_BATCHES, per_forward,
                byte_path)
            counted[name]["launches"] = launches
            # peak: above what was allocated before the pass (the capture's
            # allocations included); held: what the pass left allocated (the
            # graph's static inputs and outputs); reserved: what the
            # allocator took from the card over the pass, from an empty cache
            # (the graph's private pool included)
            mem[name] = {"peak_mb": (torch.cuda.max_memory_allocated() - base) / 2**20,
                         "held_mb": (torch.cuda.memory_allocated() - base) / 2**20,
                         "reserved_growth_mb": (torch.cuda.memory_reserved() - reserved) / 2**20}
        paths[f"captured_{kind}"] = counted["captured"]["launches"]
        GRAPH_RUNS[f"captured_{kind}"] = counted["captured"]
        # three replays: one graph launch each, nothing launched from Python
        reset_all_launches()
        r0 = prog.replays
        got = [serve(prog, i) for i in range(N_BATCHES)]
        torch.cuda.synchronize()
        graphs = prog.replays - r0
        if graphs != N_BATCHES or prog._cache_size() != 1 or any(all_launches().values()):
            fail(f"captured: {kind} launched {graphs} graphs for {N_BATCHES} batches "
                 f"({prog._cache_size()} captured), kernels from Python {all_launches()}")
        want = runs["eager"]
        for i, (a, b) in enumerate(zip(got + runs["captured"], want + want)):
            if a.shape != b.shape or not torch.equal(a, b):
                fail(f"captured: {kind} batch {i % N_BATCHES} differs from the eager program by "
                     f"{(a.float() - b.float()).abs().max().item()}")
            if not torch.isfinite(a).all() or (a.sum(-1) - 1).abs().max().item() > 1e-3:
                fail(f"captured: {kind} batch {i} is not a probability distribution")
        rates = {"eager": [], "captured": []}
        for _ in range(CAPTURED_WINDOWS):
            for name, p in (("eager", eager), ("captured", prog)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(CAPTURED_PASSES):
                    for i in range(N_BATCHES):
                        serve(p, i)
                torch.cuda.synchronize()
                rates[name].append(CAPTURED_PASSES * N_BATCHES * BATCH
                                   / (time.perf_counter() - t))
        # the trace over 3 passes of the batches (a few ms of profiler
        # start-up weigh on a shorter window); idle_share_windows: the
        # trace's busy ms against the ms per batch of the img/s windows
        n_trace = CAPTURED_TRACE_PASSES * N_BATCHES
        trace = {name: profile_engine(lambda i, p=p: serve(p, i % N_BATCHES), n_trace)
                 for name, p in (("eager", eager), ("captured", prog))}
        for name, t in trace.items():
            ms_per_batch = 1e3 * BATCH / float(np.median(rates[name]))
            t["idle_share_windows"] = 1.0 - t["device_busy_ms_per_batch"] / ms_per_batch
        results[kind] = {
            "bit_equal_batches": N_BATCHES,
            "graph_launches_per_batch": graphs / N_BATCHES,
            # per batch of the eager program, from the wrappers; in the
            # graph, its kernel nodes read by name
            "kernel_launches_per_batch": {
                "eager": {k: v / N_BATCHES for k, v in counted["eager"]["launches"].items()},
                "captured_graph_nodes": counted["captured"]["kernel_nodes_per_graph"][0]},
            "first_pass_launches": {k: {f: v[f] for f in ("launches", "graphs", "replays",
                                                          "device_launches")}
                                    for k, v in counted.items()},
            "img_s": rates, "img_s_median": {k: float(np.median(v)) for k, v in rates.items()},
            "trace": {k: {f: v[f] for f in ("wall_ms_per_batch", "device_busy_ms_per_batch",
                                             "idle_share", "idle_share_windows",
                                             "kernels_per_batch", "host_launches_per_batch")}
                      for k, v in trace.items()},
            "memory": mem, "seconds": time.perf_counter() - t_kind}
        emit({"phase": "captured", "runner": kind, "batch": BATCH, "src_hw": SRC_HW,
              **results[kind], "card": smi})
        del prog, eager, got, want
    return paths


def arrayrecord_phase(smi, tmp, run, common, log_b1, probs_tf):
    """Phase arrayrecord, inside cli: ``convert-dataset --format
    arrayrecord`` over the cli phase's posts: the same Examples in the same
    shards as its TFRecords, every chunk of every shard walked with its
    hashes checked; ``train`` (subprocess) 3 steps from the .arrayrecord
    shards, its logged losses and its step-3 checkpoint equal to run B's
    first process (the same steps from the TFRecords); ``infer --engine
    int8`` (in process) from them equal to infer's probabilities from the
    TFRecords (``probs_tf``)."""
    import io
    import re
    from contextlib import redirect_stdout

    import numpy as np

    from tumblr_emotions_torch import cli
    from tumblr_emotions_torch.data import records
    from tumblr_emotions_torch.utils import zstd
    from tumblr_emotions_torch.utils.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    ar = tmp / "data_ar"
    with redirect_stdout(io.StringIO()):
        cli.main(["convert-dataset", "--csv", str(tmp / "posts.csv"), "--images-dir",
                  str(tmp / "images"), "--out", str(ar), "--num-shards", str(CLI_SHARDS),
                  "--valid-fraction", str(CLI_VALID), "--format", "arrayrecord"])
    chunks, n_records, n_bytes = {}, 0, 0
    for split in ("train", "validation"):
        tf_paths = sorted((tmp / "data").glob(f"{split}-*.tfrecord"))
        ar_paths = sorted(ar.glob(f"{split}-*.arrayrecord"))
        if [p.stem for p in tf_paths] != [p.stem for p in ar_paths] or not ar_paths:
            fail(f"arrayrecord: shards {[p.name for p in ar_paths]} beside "
                 f"{[p.name for p in tf_paths]}")
        for tf_path, ar_path in zip(tf_paths, ar_paths):
            with records.ArrayRecordReader(str(ar_path)) as r:
                for k, v in r.verify().items():
                    chunks[k] = chunks.get(k, 0) + v
                if r.read() != list(records.read_tfrecords(str(tf_path))):
                    fail(f"arrayrecord: {ar_path.name} does not hold {tf_path.name}'s records")
                n_records += len(r)
            n_bytes += ar_path.stat().st_size
    convert_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    log_c = run("train_ar", "train", *common, "--records", str(ar / "train-*.arrayrecord"),
                "--log-every", "1", "--checkpoint-every", str(CLI_CKPT_EVERY),
                "--steps", str(CLI_CKPT_EVERY), "--checkpoint-dir", str(tmp / "C"))
    train_s = time.perf_counter() - t0
    pattern = r"step \d+ loss (\S+)"
    losses_ar, losses_tf = re.findall(pattern, log_c), re.findall(pattern, log_b1)
    if len(losses_ar) != CLI_CKPT_EVERY or losses_ar != losses_tf:
        fail(f"arrayrecord: train losses {losses_ar}, from the TFRecords {losses_tf}")
    rb = CheckpointManager(str(tmp / "B")).reader(CLI_CKPT_EVERY)
    rc = CheckpointManager(str(tmp / "C")).reader(CLI_CKPT_EVERY)
    if sorted(rb.keys()) != sorted(rc.keys()) or any(
            not np.array_equal(rb.get_tensor(k), rc.get_tensor(k)) for k in rb.keys()):
        fail("arrayrecord: the step-3 checkpoint differs from the TFRecord run's")

    with redirect_stdout(io.StringIO()):
        cli.main(["infer", *common, "--records", str(ar / "train-*.arrayrecord"),
                  "--checkpoint-dir", str(tmp / "A"), "--engine", "int8", "--front", "s2d",
                  "--probs-out", str(tmp / "probs_ar.npy")])
    probs_ar = np.load(tmp / "probs_ar.npy")
    if not np.array_equal(probs_ar, probs_tf):
        fail("arrayrecord: infer's probabilities from the .arrayrecord shards differ from "
             "the TFRecords'")
    emit({"phase": "arrayrecord", "records": n_records, "shard_bytes": n_bytes,
          "chunks_checked": chunks, "zstd": f"{zstd.LIBRARY} {zstd.version()}",
          "train_losses": losses_ar, "train_losses_equal_tfrecord": True,
          "step3_checkpoint_equal_tfrecord": True, "infer_rows": int(len(probs_ar)),
          "infer_probs_equal_tfrecord": True,
          "seconds": {"convert_and_check": convert_s, "train": train_s}, "card": smi})


def workers_phase(smi, pattern, vocab):
    """Phase workers, inside cli: the record pipeline (``data/pipeline.batches``,
    8 decode threads in each process) over the cli phase's train records at
    ``worker_count`` 0, 2 and 4 (spawned processes): the first
    WORKER_BATCHES batches byte-identical, and no process left after
    ``close``; the host feed's img/s of each after its first batch, and the
    first batch's seconds (the workers' start)."""
    import multiprocessing

    import numpy as np

    from tumblr_emotions_torch.data import pipeline

    base, rates = None, {}
    for n in WORKER_COUNTS:
        it = pipeline.batches(pattern, vocab, pipeline.PipelineConfig(
            batch_size=CLI_BATCH, max_len=50, decode_threads=8, worker_count=n))
        t0 = time.perf_counter()
        got = [next(it)]
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got += [next(it) for _ in range(WORKER_BATCHES - 1)]
        rates[n] = {"img_s": (WORKER_BATCHES - 1) * CLI_BATCH / (time.perf_counter() - t0),
                    "first_batch_s": first_s}
        it.close()
        left = multiprocessing.active_children()
        if left:
            fail(f"workers: {len(left)} processes left after close at worker_count {n}")
        if base is None:
            base = got
        elif any(sorted(a) != sorted(b) or any(not np.array_equal(a[k], b[k]) for k in a)
                 for a, b in zip(base, got)):
            fail(f"workers: the batches at worker_count {n} differ from those at 0")
    emit({"phase": "workers", "batch": CLI_BATCH, "batches": WORKER_BATCHES,
          "decode_threads": 8, "byte_identical": True,
          "feed": {str(k): v for k, v in rates.items()},
          "note": "the cli phase's fixture JPEGs (small images)", "card": smi})


def dp_serve_phase(dev, smi, state, batches, calib):
    """Phase dp_serve: the int8 s2d image runner and the joint int8 runner
    at full width, batch 64, split over two runners on the one card
    (``build_forward(..., devices=[dev, dev])``, 32 rows each), bit-equal to
    the one-device runner on the 3 batches; each runner's program counted
    from its first call (66 conv_int8 and 4 maxpool3x3s2_int8 graph nodes
    per runner's graph); img/s of the split beside the one runner's,
    interleaved.  Returns {path: launches} of the split runs."""
    import numpy as np
    import torch

    from tumblr_emotions_torch import get_preset
    from tumblr_emotions_torch.data.vocab import synthetic_ids
    from tumblr_emotions_torch.models import build_model, joint_model
    from tumblr_emotions_torch.ops.serving import build_forward

    img = get_preset("fused_inference")
    img = img.replace(image=img.image.replace(depth_multiplier=DEPTH))
    joint = get_preset("joint_finetune")
    joint = joint.replace(image=joint.image.replace(depth_multiplier=DEPTH))
    rng = np.random.RandomState(SEED + 11)
    tokens = [torch.from_numpy(synthetic_ids(rng, BATCH, TEXT_T, joint.text.vocab_size))
              .to(dev) for _ in batches]
    joint_state = joint_model.init_state(build_model(joint, device="meta"), SEED)
    paths = {}
    for kind, cfg, st in (("int8_s2d", img, state), ("joint_int8", joint, joint_state)):
        def args(i, kind=kind):
            return (batches[i],) if kind == "int8_s2d" else (batches[i], tokens[i], None)

        one = build_forward(cfg, st, engine="int8", calib_images=calib, devices=[dev])
        two = build_forward(cfg, st, engine="int8", calib_images=calib, devices=[dev, dev])
        if len(two.programs) != 2:
            fail(f"dp_serve: {kind} split has {len(two.programs)} programs")
        # two calibrations of one batch on the card: the split is held to the
        # one runner on the same scales (their equality is reported)
        scales_equal = two.engine.scales == one.engine.scales
        two.engine.scales = one.engine.scales
        want = [one(*args(i)) for i in range(N_BATCHES)]
        torch.cuda.synchronize()
        reset_all_launches()
        got = [two(*args(i)) for i in range(N_BATCHES)]
        torch.cuda.synchronize()
        launches = all_launches()
        graphs = [g for p in two.programs for g in p.kernel_nodes()]
        # each runner: its first call eager (the warm-up), then two replays
        GRAPH_RUNS[f"dp_serve_{kind}"] = served_launches(
            f"dp_serve {kind}", launches, graphs, 2 * N_BATCHES, INT8_PER_FORWARD)
        paths[f"dp_serve_{kind}"] = launches
        for i, (a, b) in enumerate(zip(got, want)):
            if a.shape != (BATCH, 15) or a.device != dev or not torch.equal(a, b):
                fail(f"dp_serve: {kind} batch {i} split over two runners differs from one "
                     f"runner by {(a.float() - b.float()).abs().max().item()} "
                     f"({tuple(a.shape)} on {a.device})")
        rates = {"one_runner": [], "two_runners": []}
        for _ in range(CAPTURED_WINDOWS):
            for name, r in (("one_runner", one), ("two_runners", two)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(CAPTURED_PASSES):
                    for i in range(N_BATCHES):
                        r(*args(i))
                torch.cuda.synchronize()
                rates[name].append(CAPTURED_PASSES * N_BATCHES * BATCH
                                   / (time.perf_counter() - t))
        emit({"phase": "dp_serve", "runner": kind, "batch": BATCH, "src_hw": SRC_HW,
              "devices": [str(d) for d in two.devices], "rows_per_runner": BATCH // 2,
              "bit_equal_batches": N_BATCHES, "calibrations_equal": scales_equal,
              "launches": launches, "graphs": GRAPH_RUNS[f"dp_serve_{kind}"], "img_s": rates,
              "img_s_median": {k: float(np.median(v)) for k, v in rates.items()},
              "card": smi})
        del one, two, got, want
    return paths


def tune_phase(dev, smi):
    """Phase tune: ``cli tune --engine int8 --batch-size 64`` at full width
    on the card, then again from its cache."""
    import io
    import json as _json
    import shutil
    import tempfile
    from contextlib import redirect_stdout
    from pathlib import Path

    from tumblr_emotions_torch import cli

    tmp = Path(tempfile.mkdtemp(prefix="tet_tune_"))
    try:
        argv = ["tune", "--engine", "int8", "--batch-size", str(BATCH), "--image-size",
                str(SRC_HW), "--cache", str(tmp / "tune.json"), "--device", DEVICE]
        if DEPTH != 1.0:
            argv += ["--depth-multiplier", str(DEPTH)]
        runs = []
        for _ in range(2):
            t = time.perf_counter()
            out = io.StringIO()
            with redirect_stdout(out):
                cli.main(argv)
            runs.append((_json.loads(out.getvalue().splitlines()[-1]), time.perf_counter() - t))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (first, s1), (second, s2) = runs
    if first["from_cache"] or first["candidates_measured"] != 2 or not second["from_cache"] \
            or second["best_options"] != first["best_options"]:
        fail(f"tune: first {first}, second {second}")
    emit({"phase": "tune", **first, "second_from_cache": second["from_cache"],
          "seconds": [s1, s2], "card": smi})


def parity_phase(dev, smi):
    """Phase parity: ``cli parity`` on a full-width slim checkpoint (1001
    classes, aux head, seeded weights): goldens saved on the CPU, the gate
    on the card at the reference's 1e-4; goldens moved by 0.01 fail it."""
    import io
    import json as _json
    import shutil
    import tempfile
    from contextlib import redirect_stdout
    from pathlib import Path

    import numpy as np

    from tumblr_emotions_torch import cli
    from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
    from tumblr_emotions_torch.utils.checkpoint import save_as_slim_checkpoint

    tmp = Path(tempfile.mkdtemp(prefix="tet_parity_"))
    try:
        t0 = time.perf_counter()
        model = InceptionV3(num_classes=1001, depth_multiplier=DEPTH, create_aux_logits=True,
                            device="meta")
        ckpt = save_as_slim_checkpoint(init_state(model, SEED + 9), str(tmp / "slim.ckpt"))
        np.savez(tmp / "imgs.npz", raw=np.random.RandomState(SEED + 9).randint(
            0, 256, (PARITY_N, SRC_HW, SRC_HW, 3)).astype(np.uint8))
        width = [] if DEPTH == 1.0 else ["--depth-multiplier", str(DEPTH)]

        def parity(*argv, device, rc=0):
            out = io.StringIO()
            with redirect_stdout(out):
                got = cli.main(["parity", "--warmstart", ckpt, *argv, *width, "--device", device])
            if got != rc:
                fail(f"parity: {argv} on {device} exited {got}, expected {rc}: {out.getvalue()}")
            return out.getvalue().splitlines()[-1]

        parity("--images", str(tmp / "imgs.npz"), "--save-goldens", str(tmp / "g.npz"),
               device="cpu")
        t1 = time.perf_counter()
        report = _json.loads(parity("--goldens", str(tmp / "g.npz"), device=DEVICE))
        t2 = time.perf_counter()
        data = dict(np.load(tmp / "g.npz"))
        data["logits"] = data["logits"] + 0.01
        np.savez(tmp / "bad.npz", **data)
        bad = _json.loads(parity("--goldens", str(tmp / "bad.npz"), device=DEVICE, rc=1))
        logit_max = float(np.abs(data["logits"] - 0.01).max())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not report["pass"] or report["num_classes"] != 1001 or \
            report["max_abs_diff"] > PARITY_TOL or bad["pass"]:
        fail(f"parity: {report}, bad goldens {bad}")
    emit({"phase": "parity", **report, "logit_max_abs": logit_max,
          "bad_goldens": {k: bad[k] for k in ("max_abs_diff", "pass")},
          "seconds": {"checkpoint_and_cpu_goldens": t1 - t0, "card_gate": t2 - t1},
          "card": smi})


def train_embeddings_phase(dev, smi):
    """Phase train_embeddings: SGNS word2vec at the width ``cli
    train-embeddings`` runs, on a seeded Zipf corpus over a 50,000-word
    vocabulary, at its learning rate: steps/s and the host sampler's share of
    a step; the first steps against the CPU on the same batches, at a rate
    whose update stands well above the tolerance."""
    import dataclasses

    import numpy as np
    import torch

    from tumblr_emotions_torch.data import word2vec as w2v
    from tumblr_emotions_torch.data.vocab import OOV_TOKEN, PAD_TOKEN, Vocabulary

    t0 = time.perf_counter()
    words = [f"w{i}" for i in range(W2V_VOCAB - 2)]
    toks = [PAD_TOKEN, OOV_TOKEN] + words
    vocab = Vocabulary({t: i for i, t in enumerate(toks)}, toks)
    rng = np.random.RandomState(SEED + 11)
    p = 1.0 / np.arange(1, len(words) + 1)
    ids = rng.choice(len(words), size=W2V_POSTS * W2V_WORDS, p=p / p.sum())
    texts = [" ".join(words[j] for j in ids[k:k + W2V_WORDS])
             for k in range(0, len(ids), W2V_WORDS)]
    cfg = w2v.Word2VecConfig(embed_dim=W2V_DIM, batch_size=W2V_BATCH, num_negatives=W2V_NEG,
                             num_steps=W2V_STEPS, seed=SEED)
    t1 = time.perf_counter()
    sentences = w2v.corpus_ids(texts, vocab)
    sampler = w2v.PairSampler(sentences, vocab.size, cfg)
    setup_s = time.perf_counter() - t1
    it = sampler.batches()
    t = time.perf_counter()
    for _ in range(W2V_STEPS):
        next(it)
    sampler_s = time.perf_counter() - t
    losses = []
    t = time.perf_counter()
    matrix = w2v.train_word2vec(texts, vocab, cfg, device=dev,
                                on_step=lambda i, loss: losses.append(loss))
    train_s = time.perf_counter() - t - setup_s
    losses = torch.stack(losses).cpu().numpy()
    if matrix.shape != (W2V_VOCAB, W2V_DIM) or not np.isfinite(matrix).all() or \
            not np.isfinite(losses).all():
        fail(f"train_embeddings: matrix {matrix.shape}, losses finite "
             f"{np.isfinite(losses).all()}")
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    short = dataclasses.replace(cfg, num_steps=W2V_CHECK_STEPS, learning_rate=W2V_CHECK_LR)
    card = w2v.train_word2vec(texts, vocab, short, device=dev)
    cpu = w2v.train_word2vec(texts, vocab, short, device="cpu")
    diff = float(np.abs(card - cpu).max())
    init = (np.random.RandomState(SEED).rand(W2V_VOCAB, W2V_DIM) - 0.5) / W2V_DIM
    init[0] = 0.0
    update = float(np.abs(cpu - init).max())
    if diff > W2V_TOL or update < W2V_UPDATE_FACTOR * W2V_TOL:
        fail(f"train_embeddings: {W2V_CHECK_STEPS} steps on the card {diff} from the CPU "
             f"(tolerance {W2V_TOL}), the update {update} (at least "
             f"{W2V_UPDATE_FACTOR * W2V_TOL})")
    emit({"phase": "train_embeddings", "vocab": W2V_VOCAB, "dim": W2V_DIM, "batch": W2V_BATCH,
          "negatives": W2V_NEG, "corpus_tokens": int(ids.size), "steps": W2V_STEPS,
          "learning_rate": cfg.learning_rate,
          "steps_per_s": W2V_STEPS / train_s, "sampler_s": sampler_s, "train_s": train_s,
          "sampler_host_share": sampler_s / train_s, "corpus_setup_s": setup_s,
          "loss_first_20": first, "loss_last_20": last,
          "first_steps_vs_cpu": {"steps": W2V_CHECK_STEPS, "learning_rate": W2V_CHECK_LR,
                                 "max_abs_diff": diff,
                                 "matrix_max_abs": float(np.abs(cpu).max()),
                                 "update_max_abs": update, "tol": W2V_TOL,
                                 "update_at_least": W2V_UPDATE_FACTOR * W2V_TOL},
          "seconds": time.perf_counter() - t0, "card": smi})


def hue_sectors(images, d, height, width):
    """The sector ``int(((h + delta) % 1) * 6)`` the hue step of each
    image's colour chain puts each pixel in, [N, height, width], from the
    resized image the chain starts from."""
    import torch

    from tumblr_emotions_torch.data import preprocessing as pp

    x = pp._crop_resize_batch(images, d, height, width, "tf1", 1.0 / 255.0)
    delta, sat_f = d.delta[:, None, None, None], d.factor[:, None, None, None]
    con_f = d.contrast[:, None, None, None]
    inputs = [pp._saturate(x + delta, sat_f),                       # con(hue(sat(bright)))
              pp._contrast(pp._saturate(x, sat_f) + delta, con_f),  # hue(con(bright(sat)))
              x, x]                                                  # ...(con(hue(x)))
    case = d.chain[:, None, None, None]
    h_in = inputs[3]
    for k in reversed(range(3)):
        h_in = torch.where(case == k, inputs[k], h_in)
    h = pp.rgb_to_hsv(h_in.clamp(0.0, 1.0))[..., 0]
    return (pp._floor_mod(h + d.hue[:, None, None], 1.0) * 6.0).to(torch.int32) % 6


def full_mode_phase(dev, smi):
    """Phase full_mode: slim's full-mode train distortions (a resize of four
    per image, brightness, saturation, hue and contrast in one of four
    orders) on uint8 [32,347,347,3] on the card against the CPU on the same
    draws; pixels whose hue sector differs between the two are counted, the
    rest held to PERF_IMAGE_ATOL; ms against fast mode."""
    import torch

    from tumblr_emotions_torch.data import preprocessing as pp

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    raw = torch.randint(0, 256, (FULL_BATCH, SRC_HW, SRC_HW, 3), generator=g, device=dev,
                        dtype=torch.uint8)
    d = pp.draw_train(torch.Generator().manual_seed(SEED + 12), FULL_BATCH, (SRC_HW, SRC_HW),
                      fast_mode=False)
    dd = d.to(dev)
    got = pp.apply_train(raw, dd, 299, 299, fast_mode=False)
    want = pp.apply_train(raw.cpu(), d, 299, 299, fast_mode=False)
    crossed = (hue_sectors(raw, dd, 299, 299).cpu() != hue_sectors(raw.cpu(), d, 299, 299))
    diff = (got.cpu() - want).abs().amax(-1)
    rest = float(diff[~crossed].max())
    if not torch.isfinite(got).all() or rest > PERF_IMAGE_ATOL:
        fail(f"full_mode: {rest} from the CPU away from hue-sector crossings > "
             f"{PERF_IMAGE_ATOL}")
    ms_full = cuda_ms(lambda: pp.apply_train(raw, dd, 299, 299, fast_mode=False), iters=5,
                      warmup=1)
    ms_fast = cuda_ms(lambda: pp.apply_train(raw, dd, 299, 299), iters=5, warmup=1)
    emit({"phase": "full_mode", "batch": FULL_BATCH, "src_hw": SRC_HW, "size": 299,
          "resize_cases": sorted(set(d.resize.tolist())),
          "chains": sorted(set(d.chain.tolist())),
          "hue_sector_crossings": int(crossed.sum()), "pixels": crossed.numel(),
          "max_abs_diff_rest": rest, "tol": PERF_IMAGE_ATOL,
          "max_abs_diff_crossings": float(diff[crossed].max()) if crossed.any() else None,
          "ms_full": ms_full, "ms_fast": ms_fast,
          "timing": "5 calls launched from Python between CUDA events", "card": smi})


def _wrappers():
    from tumblr_emotions_torch.ops import fused_inception as fi
    from tumblr_emotions_torch.ops import int8_conv as ic
    from tumblr_emotions_torch.ops import int8_pool as ip

    return (fi.fused_inception_a, fi.fused_inception_b, fi.conv_same_bias_relu,
            ic.conv_int8, ip.maxpool3x3s2_int8)


def _bn_wrappers() -> dict:
    """The batch norm's kernels (BN_PER_LAYER) by name, each's wrapper."""
    from tumblr_emotions_torch.ops import batch_norm as bn

    return {"bn_bf16_sums": bn.sums, "bn_bf16_finish": bn._finish,
            "bn_bf16_normalize": bn.normalize, "bn_bf16_grad_sums": bn.grad_sums,
            "bn_bf16_grad": bn.grad}


def reset_all_launches() -> None:
    from tumblr_emotions_torch.ops import fused_inception as fi
    from tumblr_emotions_torch.ops import int8_conv as ic

    for fn in (*_wrappers(), *_bn_wrappers().values()):
        fn.launches = 0
    fi.conv_same_bias_relu.pooled_launches = 0
    ic.conv_int8.byte_launches = 0


def all_launches() -> dict:
    """Every wrapper's launches from Python: the served kernels' and the
    batch norm's (each of those 0 wherever the bf16 model does not train)."""
    from tumblr_emotions_torch.ops import fused_inception as fi

    return {**{fn.__name__: fn.launches for fn in _wrappers()},
            POOLED: fi.conv_same_bias_relu.pooled_launches,
            **{name: fn.launches for name, fn in _bn_wrappers().items()}}


def bn_nodes(kernels: dict) -> dict:
    """A graph's kernel nodes of the batch norm's kernels, by name."""
    return {k: sum(n for name, n in kernels.items() if name == k) for k in BN_PER_LAYER}


def check_bn_launches(phase: str, launches: dict, steps: int) -> None:
    """The batch norm's launches from Python in ``launches`` are those of
    ``steps`` train steps of the bf16 model run op by op (BN_PER_LAYER for
    each of BN_LAYERS layers; 0 steps: none), and no served kernel ran."""
    want = {k: n * BN_LAYERS * steps for k, n in BN_PER_LAYER.items()}
    got = {k: launches[k] for k in BN_PER_LAYER}
    served = {k: v for k, v in launches.items() if k not in BN_PER_LAYER and v}
    if got != want or served:
        fail(f"{phase}: batch norm launches {got}, expected {want} ({steps} steps); "
             f"served kernels launched in training: {served}")


def bn_kernels_phase(dev, smi) -> dict:
    """Phase kernel_check bn_bf16_*: the bf16 train-mode batch norm's Triton
    kernels (ops/batch_norm, each through its wrapper) against their plain
    versions on the card at the tower's batch-normed conv outputs at
    PERF_BATCH rows (BN_SHAPES; the gradient's rows at 35x35 a channel slice
    of a wider tensor, as a block's concatenated gradient gives them): the
    statistics and the finishing sum within BN_SUM_RTOL of the magnitudes
    summed, the normalisation and the input gradient bit-equal given the
    same per-channel vectors, a second launch of each bit-equal to the
    first.  ms from Python between CUDA events and graph_ms in CUDA graphs,
    each beside the bytes' bound.  Returns the rows by kernel."""
    import torch

    from tumblr_emotions_torch.ops import batch_norm as bn

    out = {}
    for hw, c in BN_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(SEED + hw)
        R = PERF_BATCH * hw * hw
        x = torch.randn(R, c, generator=gen, device=dev) * 2.0 + 0.5
        beta = torch.randn(c, generator=gen, device=dev) * 0.1
        wide = c + (16 if hw == 35 else 0)
        g = bn.as_rows((torch.randn(PERF_BATCH, hw, hw, wide, generator=gen, device=dev)
                        * 1e-3).to(torch.bfloat16)[..., :c])
        var, mean = torch.var_mean(x, dim=0, correction=0)
        inv = torch.rsqrt(var + 0.001)
        shift = beta - mean * inv
        gm = bn._masked(g, x, inv, shift)
        gs = bn.grad_sums_plain(g, x, inv, shift, mean)
        c1, c2 = -(inv * gs[:c]) / R, -(inv * inv * inv * gs[c:]) / R
        _, _, per_program = bn._blocks(R, c, bn._SUM_TILE)
        part = torch.randn(-(-R // per_program), 2 * c, generator=gen, device=dev)
        e = R * c
        cases = [  # kernel, call, plain, scale of a sum (None: bit-equal), bytes, flops
            ("bn_bf16_sums", lambda: bn.sums(x), lambda: bn.sums_plain(x),
             x.abs().sum(0), 4 * e, e),
            ("bn_bf16_sums", lambda: bn.sums(x, mean), lambda: bn.sums_plain(x, mean),
             bn.sums_plain(x, mean), 4 * e, 3 * e),
            ("bn_bf16_finish", lambda: bn._finish(part), lambda: bn.finish_plain(part),
             part.abs().sum(0), 4 * part.numel(), part.numel()),
            ("bn_bf16_normalize", lambda: bn.normalize(x, inv, shift),
             lambda: bn.normalize_plain(x, inv, shift), None, 6 * e, 3 * e),
            ("bn_bf16_grad_sums", lambda: bn.grad_sums(g, x, inv, shift, mean),
             lambda: bn.grad_sums_plain(g, x, inv, shift, mean),
             torch.cat([gm.abs().sum(0), (gm * (x - mean)).abs().sum(0)]), 6 * e, 7 * e),
            ("bn_bf16_grad", lambda: bn.grad(g, x, inv, shift, mean, c1, c2),
             lambda: bn.grad_plain(g, x, inv, shift, mean, c1, c2), None, 10 * e, 9 * e)]
        for i, (kernel, call, plain, scale, nbytes, flops) in enumerate(cases):
            label = f"{kernel} [{PERF_BATCH},{hw},{hw},{c}]" + (" centred" if i == 1 else "")
            got, again, want = call(), call(), plain()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"{label}: two launches differ")
            if got.dtype != want.dtype or got.shape != want.shape \
                    or not torch.isfinite(got).all():
                fail(f"{label}: {got.dtype} {tuple(got.shape)} against the plain "
                     f"{want.dtype} {tuple(want.shape)}, or not finite")
            err = (got.float() - want.float()).abs()
            if scale is None:
                rel = None
                if not torch.equal(got, want):
                    fail(f"{label}: not bit-equal to the plain version: {int((err > 0).sum())} "
                         f"of {err.numel()} elements differ, max {err.max().item()}")
            else:
                rel = (err / scale.clamp_min(1e-30)).max().item()
                if rel > BN_SUM_RTOL:
                    fail(f"{label}: {rel} of the magnitudes summed > {BN_SUM_RTOL}")
            b = bound(flops, nbytes, H100_F32_FLOPS)
            ms, g_ms = cuda_ms(call), graph_ms(call)
            row = dict(shape=label, max_abs_err=err.max().item(), max_rel_err=rel,
                       tol=BN_SUM_RTOL if scale is not None else "bit-equal",
                       repeat_equal=True, ms=ms, graph_ms=g_ms,
                       pct_of_bound=100.0 * b["bound_ms"] / ms,
                       graph_pct_of_bound=100.0 * b["bound_ms"] / g_ms,
                       plain_ms=cuda_ms(plain, iters=5, warmup=1), library_ms=None,
                       timing="ms, plain_ms: calls launched from Python between CUDA "
                              "events; graph_ms: a CUDA graph of 20 calls (device time)",
                       **b)
            out.setdefault(kernel, []).append(row)
            emit({"phase": "kernel_check", "kernel": kernel, **row})
        del x, g, gm, part
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return out


def main() -> int:
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "--dp-child":
        return dp_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from tumblr_emotions_torch._device import card_line, resolve_device, tf32_convs
    from tumblr_emotions_torch.data import jpeg
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
    from tumblr_emotions_torch.models.layers import to_nchw, to_nhwc
    from tumblr_emotions_torch.ops import _build
    from tumblr_emotions_torch.ops import fused_inception as fi
    from tumblr_emotions_torch.ops.inference import FusedInceptionV3
    from tumblr_emotions_torch.ops.serving import image_server

    torch.set_grad_enabled(False)
    dev = resolve_device(DEVICE)

    # ---- 1. device ----
    smi = card_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    # ---- 2. build: the kernels (nvcc) and, beside them, the host JPEG
    # decoder (g++) ----
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(jpeg.build)
        libs = _build.build()
        for name in libs:
            _build.library(name)
        host_lib = host.result()
    ptxas = {}
    for name, lib_path in libs.items():
        log = lib_path.with_suffix(".log")
        ptxas[name] = ptxas_report(log.read_text()) if log.exists() else []
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": [p.name for p in libs.values()] + [host_lib.name], "ptxas": ptxas})

    # ---- seeded full-width weights (depth 1.0, 15 classes, aux head) ----
    model = InceptionV3(num_classes=15, depth_multiplier=DEPTH,
                        create_aux_logits=True, device=dev)
    state = init_state(model, SEED)
    model.load_state_dict(state)
    eng_k = FusedInceptionV3(state, dtype=torch.bfloat16, use_kernels=True, device=dev)
    eng_c = FusedInceptionV3(state, dtype=torch.bfloat16, use_kernels=False, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def act(*shape):
        return torch.relu(torch.randn(*shape, generator=gen, device=dev)).to(torch.bfloat16)

    rows = {}  # kernel name -> list of per-shape results

    def record(kernel, **r):
        rows.setdefault(kernel, []).append(r)
        emit({"phase": "kernel_check", "kernel": kernel, **r})

    # ---- 3a. the block conv: every conv of Mixed_5b and Mixed_6b, and the
    # packed and pooled launches of both blocks ----
    def conv_rows(scope, hw):
        """(label, form, ConvOp, input, the conv scopes whose cuDNN weights
        compute the same function, kernel) per launch timed."""
        plan = eng_k.block_plans[scope]
        branches = fi.inception_a_branches(False) if scope == "Mixed_5b" else \
            fi.INCEPTION_B_BRANCHES
        out = []
        for _, chain in branches:
            for name, kernel in chain:
                s = f"{scope}/{name}"
                op = fi.ConvOp([eng_k.taps[s]], kernel)
                out.append((s, "conv", op, act(BATCH, hw, hw, op.cin), [s], kernel))
        packed, pooled = plan.launches[0], plan.launches[-1]
        heads = [f"{scope}/{chain[0][0]}" for p, chain in branches if not p]
        out.append((f"{scope} packed 1x1", "packed", packed.op,
                    act(BATCH, hw, hw, packed.op.cin), heads, (1, 1)))
        out.append((f"{scope} pooled 1x1", "pooled", pooled.op,
                    act(BATCH, hw, hw, pooled.op.cin), [f"{scope}/{branches[3][1][0][0]}"],
                    (1, 1)))
        return out

    for scope, hw in (("Mixed_5b", 35), ("Mixed_6b", 17)):
        for label, form, op, x, scopes, kernel in conv_rows(scope, hw):
            got = op(x)
            want = fi.conv_segments_plain(x, op, [torch.empty_like(g) for g in got])
            torch.cuda.synchronize()
            err = max(compare(f"conv {label}", g, w, KERNEL_TOL) for g, w in zip(got, want))
            wmax = max(w.float().abs().max().item() for w in want)
            pad = (kernel[0] // 2, kernel[1] // 2)
            # The same function in one PyTorch call: bf16 F.conv2d (rounds its
            # accumulator before the bias), and the f32-on-bf16 cuDNN conv the
            # cuDNN engine runs (TF32 allowed, one rounding); the pooled form
            # pools first in each.
            w_oihw = torch.cat([eng_c.w[s][0] for s in scopes])
            b32 = torch.cat([eng_c.w[s][1] for s in scopes])
            w16 = w_oihw.to(torch.bfloat16, memory_format=torch.channels_last)
            b16 = b32.to(torch.bfloat16)
            x_nchw = to_nchw(x)
            pool = (lambda t: F.avg_pool2d(t, 3, 1, 1, count_include_pad=False)) \
                if form == "pooled" else (lambda t: t)

            def bf16_conv(x_nchw=x_nchw, w16=w16, b16=b16, pad=pad, pool=pool):
                return F.relu(F.conv2d(pool(x_nchw), w16, b16, padding=pad))

            def cudnn_conv(x_nchw=x_nchw, w_oihw=w_oihw, b32=b32, pad=pad, pool=pool):
                with tf32_convs():
                    y = F.conv2d(pool(x_nchw.float()), w_oihw, padding=pad)
                return to_nhwc(y).add_(b32).relu_().to(torch.bfloat16)

            m = BATCH * hw * hw
            flops = 2.0 * m * op.cout * op.w.shape[1]
            nbytes = 2.0 * (m * op.cin + m * op.cout + op.w.numel()) + 4 * op.cout
            b = bound(flops, nbytes)
            ms, g_ms = cuda_ms(lambda: op(x)), graph_ms(lambda: op(x))
            record("conv_same_bias_relu" if form != "pooled" else POOLED,
                   shape=f"{label} [{BATCH},{hw},{hw},{op.cin}]->{op.cout} k{kernel}",
                   form=form, segments=list(op.widths),
                   tile=fi.pick_tile(m, op.cout, op.w.shape[1], op.pooled,
                                     hw if op.pooled else 0).name,
                   max_abs_err=err, max_rel_err=err / wmax, tol=KERNEL_TOL,
                   ms=ms, graph_ms=g_ms, pct_of_bound=100.0 * b["bound_ms"] / ms,
                   graph_pct_of_bound=100.0 * b["bound_ms"] / g_ms,
                   timing="ms, library_ms, cudnn_f32_ms: 20 calls launched from Python "
                          "between CUDA events; *graph_ms: a CUDA graph of 20 calls "
                          "(device time)",
                   plain_ms=cuda_ms(lambda: fi.conv_segments_plain(x, op, want), iters=5,
                                    warmup=1),
                   library_ms=cuda_ms(bf16_conv), library_graph_ms=graph_ms(bf16_conv),
                   library_note="bf16 F.conv2d + bias + ReLU (rounds twice: not the same "
                                "rounding)",
                   cudnn_f32_ms=cuda_ms(cudnn_conv), cudnn_f32_graph_ms=graph_ms(cudnn_conv),
                   cudnn_f32_note="the cuDNN engine's conv: f32 on the bf16 values, TF32, "
                                  "bias, ReLU, one rounding", **b)

    # ---- 3b. the blocks (K2, K3) against their plain versions ----
    def block_cost(scope, branches, hw, cin):
        m = BATCH * hw * hw
        flops, wbytes, cout = 0.0, 0.0, 0
        for _, chain in branches:
            for name, _ in chain:
                w, _ = eng_k.taps[f"{scope}/{name}"]
                flops += 2.0 * m * w.numel()
                wbytes += 2.0 * w.numel() + 4.0 * w.shape[-1]   # bf16 taps, f32 bias
            cout += w.shape[-1]
        return bound(flops, 2.0 * m * (cin + cout) + wbytes)

    blocks = [("fused_inception_a", scope, 35, cin, fi.inception_a_branches(q),
               lambda x, s=scope, q=q: fi.fused_inception_a(x, eng_k.taps, s, q),
               lambda x, s=scope, q=q: fi.fused_inception_a_plain(x, eng_k.taps, s, q),
               lambda x, s=scope, q=q: eng_c._cudnn_block(x, s, fi.inception_a_branches(q)))
              for scope, q in (("Mixed_5b", False), ("Mixed_5c", True),
                               ("Mixed_5d", False))
              for cin in [eng_k.taps[f"{scope}/Branch_0/Conv2d_0a_1x1"][0].shape[1]]]
    blocks += [("fused_inception_b", scope, 17,
                eng_k.taps[f"{scope}/Branch_0/Conv2d_0a_1x1"][0].shape[1],
                fi.INCEPTION_B_BRANCHES,
                lambda x, s=scope: fi.fused_inception_b(x, eng_k.taps, s),
                lambda x, s=scope: fi.fused_inception_b_plain(x, eng_k.taps, s),
                lambda x, s=scope: eng_c._cudnn_block(x, s, fi.INCEPTION_B_BRANCHES))
               for scope in ("Mixed_6b", "Mixed_6c", "Mixed_6e")]
    for kname, scope, hw, cin, branches, kfn, pfn, lfn in blocks:
        x = act(BATCH, hw, hw, cin)
        got, want = kfn(x), pfn(x)
        torch.cuda.synchronize()
        err = compare(f"{kname} {scope}", got, want, KERNEL_TOL)
        b = block_cost(scope, branches, hw, cin)
        ms, g_ms = cuda_ms(lambda: kfn(x)), graph_ms(lambda: kfn(x))
        record(kname, shape=f"{scope} [{BATCH},{hw},{hw},{cin}]->{got.shape[-1]}",
               max_abs_err=err, max_rel_err=err / want.float().abs().max().item(),
               tol=KERNEL_TOL, ms=ms, graph_ms=g_ms, pct_of_bound=100.0 * b["bound_ms"] / ms,
               graph_pct_of_bound=100.0 * b["bound_ms"] / g_ms,
               plain_ms=cuda_ms(lambda: pfn(x)),
               library_ms=cuda_ms(lambda: lfn(x)), library_graph_ms=graph_ms(lambda: lfn(x)),
               library_note="the cuDNN engine's block (FusedInceptionV3._cudnn_block)", **b)

    # ---- 3c. the bf16 train-mode batch norm's kernels ----
    rows.update(bn_kernels_phase(dev, smi))

    # ---- 4. end to end: the served kernel path ----
    rng = np.random.RandomState(SEED)

    def make_batch():
        # Per-image low-frequency colour patterns of random scale plus noise of
        # random strength, so the images differ in more than their noise.
        grids = rng.randint(2, 33, BATCH)
        imgs = []
        for g in grids:
            lo = torch.from_numpy(rng.uniform(0, 255, (1, 3, g, g)).astype(np.float32))
            im = F.interpolate(lo, size=(SRC_HW, SRC_HW), mode="bilinear",
                               align_corners=False)[0].permute(1, 2, 0)
            im = im + torch.from_numpy(rng.normal(0, rng.uniform(0, 40), im.shape)
                                       .astype(np.float32))
            imgs.append(im.clamp(0, 255).to(torch.uint8))
        return torch.stack(imgs).to(dev)

    batches = [make_batch() for _ in range(N_BATCHES)]
    server = image_server(eng_k, device=dev)
    reset_all_launches()
    outs = [server(raw) for raw in batches]   # the first call captures
    torch.cuda.synchronize()
    launches = all_launches()
    GRAPH_RUNS["e2e"] = served_launches("e2e", launches, server.program.kernel_nodes(),
                                        N_BATCHES, BF16_PER_FORWARD)
    n_feat = eng_k.logits_w[0].shape[0]
    for probs, feature in outs:
        if probs.shape != (BATCH, 15) or feature.shape != (BATCH, n_feat):
            fail(f"output shapes {tuple(probs.shape)} {tuple(feature.shape)}")
        if not (torch.isfinite(probs).all() and torch.isfinite(feature).all()):
            fail("non-finite probabilities or features")
        if (probs.sum(-1) - 1).abs().max().item() > 1e-3:
            fail("probability rows do not sum to 1")

    dmax, agree, decided, decided_agree, lmax = 0.0, 0, 0, 0, 0.0
    for raw in batches:
        ref, _ = model(preprocess_for_eval(raw, dtype=torch.float32))
        got, _ = eng_k(preprocess_for_eval(raw, dtype=torch.bfloat16))
        lmax = max(lmax, ref.abs().max().item())
        dmax = max(dmax, (got - ref).abs().max().item())
        top2 = ref.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        same = got.argmax(-1) == ref.argmax(-1)
        sure = margin > 2 * LOGIT_TOL * ref.abs().max()
        agree += int(same.sum())
        decided += int(sure.sum())
        decided_agree += int((same & sure).sum())
    n_img = BATCH * N_BATCHES
    if dmax / lmax > LOGIT_TOL:
        fail(f"logits vs f32 tower: max|d| {dmax} = {dmax / lmax} of max|logit| > {LOGIT_TOL}")
    if decided_agree != decided:
        fail(f"top-1 differs on {decided - decided_agree} of {decided} images with a clear margin")
    if agree < TOP1_MIN_SHARE * n_img:
        fail(f"top-1 agrees on {agree} of {n_img} images, below {TOP1_MIN_SHARE}")

    def serve_rate(serve):
        """img/s of ``serve(i)`` (serves batch i) over 3 passes of the
        batches, after one pass of warm-up."""
        for i in range(N_BATCHES):
            serve(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            for i in range(N_BATCHES):
                serve(i)
        torch.cuda.synchronize()
        return 3 * n_img / (time.perf_counter() - t)

    def img_s(engine):
        srv = image_server(engine, device=dev)
        return serve_rate(lambda i: srv(batches[i]))

    emit({"phase": "e2e", "batch": BATCH, "batches": N_BATCHES, "src_hw": SRC_HW,
          "launches": launches, "graphs": GRAPH_RUNS["e2e"],
          "logit_max_abs_diff": dmax, "logit_max_abs": lmax,
          "logit_rel_diff": dmax / lmax, "logit_tol": LOGIT_TOL,
          "top1_agree": agree / n_img, "top1_min_share": TOP1_MIN_SHARE,
          "top1_clear_margin_images": decided,
          "top1_clear_margin_agree": decided_agree,
          "img_s_kernels": img_s(eng_k), "img_s_cudnn": img_s(eng_c),
          "card": smi})

    # ---- 5-7. the int8 served program and its kernels ----
    int8_rows, int8_launches, runner, calib = int8_phases(dev, state, batches, smi, img_s,
                                                          eng_k, eng_c)
    rows.update(int8_rows)
    del eng_c

    # ---- 8-11. the joint program (the main path), uint8 front, int8 pool, text ----
    paths = joint_phases(dev, state, batches, smi, serve_rate, runner, calib)
    paths["e2e_int8"] = int8_launches
    del runner

    # ---- captured: every runner as one CUDA graph per batch (this slice's
    # main path) ----
    paths.update(captured_phase(dev, smi, state, batches, calib))

    # ---- dp_serve: one batch split over two runners on the card ----
    paths.update(dp_serve_phase(dev, smi, state, batches, calib))

    # ---- 12. e2e_http: posts over HTTP, on the captured program ----
    paths["e2e_http"] = http_phase(dev, smi, calib)

    # ---- 13-15. training on the card, the main path ----
    train_paths, held = train_phases(dev, smi)
    paths.update(train_paths)

    # ---- 16. cli: the CLI from records on disk, the main path ----
    paths.update(cli_phase(dev, smi, held))

    # ---- 17-18. perf-mode training of the data_parallel preset (this
    # slice's main path) and two processes on the card ----
    paths.update(train_perf_phase(dev, smi))
    train_dp_phase(dev, smi)

    # ---- the CLI's last commands and slim's full-mode distortions ----
    tune_phase(dev, smi)
    parity_phase(dev, smi)
    train_embeddings_phase(dev, smi)
    full_mode_phase(dev, smi)

    # ---- this slice: the card's divisions, then training as the reference
    # trains: the captured train and eval steps (the main path), tune --step
    # train and the accuracy benchmark's smoke run ----
    divisions_phase(dev, smi, state)
    paths.update(train_captured_phase(dev, smi))
    tune_train_phase(dev, smi)
    accuracy_smoke_phase(dev, smi)

    # ---- 19. the kernels line ----
    src = "tumblr_emotions_torch/csrc/inception_blocks.cu"
    paths["e2e"] = launches
    info = {  # name -> (source, replaces, the path whose run gives its launches)
        "fused_inception_a": (src, f"{REPLACES}:230", "e2e"),
        "fused_inception_b": (src, f"{REPLACES}:283", "e2e"),
        "conv_same_bias_relu": (src, f"{REPLACES}:127", "e2e"),
        POOLED: (src, f"{REPLACES}:147", "e2e"),
        "conv_int8": ("tumblr_emotions_torch/csrc/int8_conv.cu",
                      "tumblr_emotions_tpu/ops/pallas_conv.py:105", "cli_serve"),
        "maxpool3x3s2_int8": ("tumblr_emotions_torch/csrc/int8_pool.cu",
                              "experiments/pallas_pool.py:53", "cli_serve"),
    }
    # the bf16 train-mode batch norm (Triton): no TPU kernel, XLA fuses
    # these passes into the convs' neighbours there; launches from
    # train_perf's fit, op by op
    info.update({name: ("tumblr_emotions_torch/ops/batch_norm.py", None, "train_perf")
                 for name in BN_PER_LAYER})
    kernels = []
    for name, (source, replaces, path) in info.items():
        checked = rows[name]
        rs = [r for r in checked if r.get("first_of_form", True)]
        t_ops, t_bytes = sum(r["ops_ms"] for r in rs), sum(r["bytes_ms"] for r in rs)
        libs = [r["library_ms"] for r in rs]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": paths[path][name], "launches_path": path,
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            # Sums over the shapes timed; null where no PyTorch call computes
            # the same function at every shape (int8 conv with its epilogue).
            "library_ms": sum(libs) if all(v is not None for v in libs) else None,
            "shapes": len(rs)}
        # launches: e2e's run for the block kernels, the CLI serve run for
        # the int8 kernels; every other path's run beside it (captured_*:
        # this slice's main path).  Each counts the launches its wrapper
        # made from Python, which on a captured program are the first
        # call's (the warm-up); device_launches_by_path adds the kernel's
        # nodes in the program's CUDA graphs, read from each graph by name,
        # times the graph's replays in that run.
        entry["launches_by_path"] = {p: c[name] for p, c in paths.items() if name in c}
        if name in GRAPH_KERNELS:
            entry["device_launches_by_path"] = {
                p: g["device_launches"][name] for p, g in GRAPH_RUNS.items()}
            entry["graph_replays_by_path"] = {p: g["replays"] for p, g in GRAPH_RUNS.items()}
        if name in BN_PER_LAYER:
            # ms: calls from Python between CUDA events; graph_ms: device
            # time in CUDA graphs; over the BN_SHAPES (the centred sums
            # among bn_bf16_sums').  Device launches: each perf case of
            # train_captured, the train graph's nodes times its replays
            # with the warm-up's from Python.
            entry["route"] = "triton"
            entry["graph_ms"] = sum(r["graph_ms"] for r in rs)
            entry["max_rel_err"] = max((r["max_rel_err"] or 0.0) for r in checked)
            entry["tol"] = checked[0]["tol"]
            entry["device_launches_by_path"] = {
                p: r["device_launches"][name] for p, r in BN_GRAPH_RUNS.items()}
            entry["graph_replays_by_path"] = {p: r["replays"] for p, r in BN_GRAPH_RUNS.items()}
        if name == "maxpool3x3s2_int8":
            entry["also_replaces"] = "experiments/pallas_pool.py:88"
            # graph_ms: device time in CUDA graphs over the 5 shapes; *_served:
            # the four served shapes alone (K4a's random shape left out).
            served = [r for r in rs if r["served"]]
            entry["graph_ms"] = sum(r["graph_ms"] for r in rs)
            entry["graph_ms_served"] = sum(r["graph_ms"] for r in served)
            entry["bound_ms_served"] = sum(r["bound_ms"] for r in served)
            entry["graph_pct_of_bound_served"] = \
                100.0 * entry["bound_ms_served"] / entry["graph_ms_served"]
        if name in ("conv_same_bias_relu", POOLED):
            # ms: calls from Python between CUDA events; graph_ms: device time
            # in CUDA graphs; over Mixed_5b's and 6b's convs and their packed
            # 1x1s (the 17 convs alone in ms_17, graph_ms_17, as the kernels
            # line summed them before the packed launch), or their pooled
            # 1x1s.  cudnn_f32: the cuDNN engine's conv of the same function.
            entry["graph_ms"] = sum(r["graph_ms"] for r in rs)
            entry["library_graph_ms"] = sum(r["library_graph_ms"] for r in rs)
            entry["cudnn_f32_ms"] = sum(r["cudnn_f32_ms"] for r in rs)
            entry["cudnn_f32_graph_ms"] = sum(r["cudnn_f32_graph_ms"] for r in rs)
            entry["tiles"] = sorted({r["tile"] for r in rs})
            if name == "conv_same_bias_relu":
                single = [r for r in rs if r["form"] == "conv"]
                entry["ms_17"] = sum(r["ms"] for r in single)
                entry["graph_ms_17"] = sum(r["graph_ms"] for r in single)
                entry["bound_ms_17"] = sum(r["bound_ms"] for r in single)
        if name in ("fused_inception_a", "fused_inception_b"):
            entry["graph_ms"] = sum(r["graph_ms"] for r in rs)
            entry["library_graph_ms"] = sum(r["library_graph_ms"] for r in rs)
        if name == "conv_int8":
            # ms: calls from Python between CUDA events; graph_ms: device
            # time in CUDA graphs; both over one conv per form (shapes).
            entry["graph_ms"] = sum(r["graph_ms"] for r in rs)
            entry["byte_path_launches"] = {p: c["conv_int8 byte path"]
                                           for p, c in paths.items()}
            entry["rows_checked"] = len(checked)
            entry["tiles"] = sorted({r["tile"] for r in checked})
            # The 1x1 stride-1 forms, where torch._int_mm computes the same
            # product (without the epilogue): the kernel and the library
            # call over those shapes alone.
            mm = [r for r in rs if r["library_ms"] is not None]
            entry["shapes_1x1"] = len(mm)
            entry["ms_1x1"] = sum(r["ms"] for r in mm)
            entry["graph_ms_1x1"] = sum(r["graph_ms"] for r in mm)
            entry["bound_ms_1x1"] = sum(r["bound_ms"] for r in mm)
            entry["library_ms_1x1"] = sum(r["library_ms"] for r in mm)
            entry["library_graph_ms_1x1"] = sum(r["library_graph_ms"] for r in mm)
        kernels.append(entry)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
