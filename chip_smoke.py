#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (`spcl_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):
  1. device  — refuse to run without CUDA; print the card's name and power
               limit (nvidia-smi).
  2. build   — compile spcl_torch/ops/csrc/supcon.cu, convstage.cu, bnrelu.cu
               and wattn.cu with nvcc for sm_90a, one nvcc per source,
               started together.
  3. kernels — hold the supcon kernels against their plain PyTorch versions
               (float32, TF32 off) at 2N in {10, 60, 90, 126, 1024, 3840}, D=256,
               in every weighting mode, correct_grad on and off, and with
               padded (valid=0) rows at 10, 90 and 126 (at 90 with the dense
               InfoNCE's SimCLR-pair labels: each row's only positive is its
               other view, -1 on padding); two runs of each equal to the bit;
               time them beside the plain versions, their float32 and
               3xTF32 bounds and their products alone in float32 `torch.mm`
               (the library yardstick), with the launch plan (cluster size,
               resident clusters, kept s tiles); hold the seven stage kernels against
               theirs at the main path's two shapes (B=60: 224^2 x C16 fed by
               an ordinary first convolution, 112^2 x C16->32), at a small
               odd-batch shape, at the semi path's (B=96 student, B=32
               teacher), with random dp and random non-zero de: the
               forward and the backward as wholes, each pass alone, and two
               runs bit for bit; time kernel vs plain with CUDA events; the
               pool passes (poolsums, dz1) also with de absent, as the
               pretrain path runs them, against their own byte bounds, and
               poolsums also by CUDA-graph replay and at the fine-tune step's
               shapes (B=5), with its launch plan.
  4. slice A — the encoder-pretrain path of main_pretrain_encoder.py at the
               paper's configuration (UNet max_channel=256 to Conv5, crop
               224 of a 256 canvas, 2N=60, self-paced SupCon hard 3->14,
               RAdam, `small_c_layout: nhwc`, `device_data: true`: the
               dataset lives on the card and each step gathers its batch
               there) on synthetic data: 1 epoch x 5
               steps through spcl_torch.entry.build_trainer; checks the
               kernel launch counts, finite losses, sp_weight in [0, 1],
               gamma following PScheduler, and a last.ckpt that reloads
               strictly.
  5. slice B — both phases of main_pretrain_encoder.py under
               `small_c_layout: pallas` at the same width: 5 pretrain steps
               at 2N=60, then `val()` over one labeled ratio — 1 epoch x 5
               fine-tune steps of the whole UNet and one eval epoch on the
               val and test loaders, warm-started from the pretrain
               last.ckpt; checks the stage kernels' launch counts per step
               (none during eval), finite losses, a DSC in [0, 1], and a
               best.ckpt that reloads strictly into a plain UNet; then
               times the fine-tune step and the eval step after a warm-up.
  6. profile — the pretrain step under `pallas` and `nhwc`, each with
               `device_data` true beside false (host batches through the
               pinned prefetch), through the trainers' own epochs: 20 timed
               steps a turn in the turns true, false, false, true (no true
               epoch may build a host batch), 5 under torch.profiler each
               (kernel time by kernel, device busy share, the stage kernels'
               share and launches, matched by their own names: none under
               `nhwc`, no reduce after poolsums under `pallas`); RAdam alone,
               the multi-tensor update beside the per-parameter loop it
               replaced (wall time, launches and kernel time a step); and the
               two stages alone, forward + backward, fused beside cuDNN.
  7. parity  — one small pretrain step, and one small fine-tune step under
               `pallas`, on the card (kernels) against the same step on the
               CPU (plain versions) from the same weights and draws.
  8. strips  — the supcon kernels on ROW-STRIP operands (rows of one rank
               against the columns of all ranks), one process walking the
               ranks of a virtual mesh: 2N=126 over 2 ranks (63 slices
               padded to 64: strip 64 x 128), 2N=60 over 4 (strip 32 x 64),
               2N=3840 over 8 (strip 480 x 3840); every weighting mode,
               correct_grad on and off, an invalid tail; each strip's
               statistics and dz against the plain versions, the assembled
               loss, ratio, dz1, dz2 against the square-form kernels; kernel
               strip, plain strip, library yardstick and naive strip timed
               beside both bounds.
  9. nccl    — a process group of ONE rank on NCCL in this process: the
               row-sharded loss and the cross-rank BatchNorm, forward and
               backward, through the collectives on CUDA tensors, against
               the single-device results.
 10. slice C — multi-GPU training at the production configuration
               (base.yaml + pretrain.yaml + specific/production_pretrain.yaml:
               21 scans x 3 partitions = 63 slices, 2N=126, `global_contrast:
               row_sharded`, `nhwc`) with `Trainer.mesh=2`: two spawned ranks
               run 5 pretrain steps through spcl_torch.entry.build_trainer,
               then `val()` at one labeled ratio under the mesh, then 5 steps
               with `replicated`. With two or more cards the ranks take one
               each over NCCL; on one card both compute on it and the
               collectives go through gloo, staged through host memory. Then
               5 more steps with `Trainer.grad_cache: 2` (each rank's 32
               slices in 2 chunks): finite losses, parameters that moved,
               replicas that agree, 64 x 128 strips. This
               process runs the same padded batches (63 slices + one valid=0
               entry) alone and checks: per rank and step one supcon_fwd and
               one supcon_bwd launch at 64 x 128; losses, sp_weight, Conv5
               weights and the last Conv5 gradient equal to the single
               process's and row_sharded equal to replicated (tolerance
               stated there); files from rank 0 only; last.ckpt reloads
               strictly; the fine-tune DSC in [0, 1].
 11. slice D — config/specific/bigbatch_pretrain.yaml (160 scans x 3
               partitions x 4 slices = 2N=3840, `grad_cache: 30`, 30 chunks
               of 128 views, `global_contrast: row_sharded`, inert on one
               card) at full width, `nhwc`, `device_data: true`, cut in depth
               to 1 epoch of 1 warm-up + 2 timed steps, on a synthetic
               dataset of 160 scans of 13-16 slices handed to build_trainer:
               ms/step, peak memory, the store's bytes, 3840 valid views a
               step, one supcon_fwd and one supcon_bwd a step at 3840 x 3840,
               no host batch, finite losses, a last.ckpt that reloads
               strictly; then the cached gradient against direct autograd at
               2N=240 in 4 chunks on the card.
 12. slice E — the semi-supervised path of main.py (base.yaml +
               specific/production_semi.yaml + mt.yaml + uda.yaml: UNet-256,
               crop 224 of 256, 32 labeled + 32 unlabeled slices a step,
               mean teacher at weight 10 + consistency at 5, RAdam,
               `packed_eval: 96`, `device_data: true`) under `pallas` on
               synthetic data through `spcl_torch.main.run`, cut to 1 epoch
               of 1 warm-up + 5 timed steps and one eval epoch: the stage
               kernels' launches, the student's and the EMA teacher's apart;
               finite losses; the teacher after step 1 equal to 0.5 t0 +
               0.5 s1; BatchNorm statistics moved by the student's forward
               only; a DSC in [0, 1]; last.ckpt (student and teacher)
               reloading strictly; ms/step, slices/s and a profile; then
               `trainer_checkpoint` resume into epoch 2 (teacher and RAdam
               state restored); the same steps under `nhwc`. Then every
               legacy preset name, main_mixup and `two_stage` +
               `disable_bn` at base.yaml's 5 + 5 slices, 2 steps each
               (`infonce` / `infoncemt`: one supcon_fwd and one supcon_bwd a
               step at 2N=10, each call held to its plain version on its own
               operands), and one semi step under `pallas` on the card
               against the CPU: losses, every parameter's gradient, the
               updated student and teacher, running statistics.
 13. slice F — decoder pretraining, both phases of main_pretrain_decoder.py
               (base.yaml + pretrain.yaml + hooks/infonce_dense.yaml: dense
               InfoNCE at Up_conv3, `contrast_on: self`, 3 scans x 3
               partitions = 9 slices, 18 views x 5 points = 2N 90) under
               `pallas` through `spcl_torch.main_pretrain_decoder.run`, warm-
               started from slice B's encoder last.ckpt: 1 warm-up + 5 steps,
               then `val()` at one ratio (5 fine-tune steps, one eval epoch).
               Checks: one supcon_fwd and one supcon_bwd a step at 90 views,
               each call held to its plain version on its own operands; the
               stage kernels forward only (conv 1, bnconv 2, bnpool 2 a step,
               no backward pass), 12 a fine-tune step; Conv1-Conv4 and the
               stages past Up_conv3 bit-equal, Conv5..Up_conv3 moved; finite
               losses, a DSC in [0, 1], pre/last.ckpt reloading strictly;
               ms/step, slices/s, a profile. Then the same pretraining under
               `nhwc` and 2 steps with SPInfonceParams at Up_conv3 (soft).
               The held runs take their steps eagerly (holding a call reads
               the device, which a CUDA graph capture forbids); then 3 steps
               of the pallas decoder pretraining replayed as a CUDA graph
               against the same steps run eagerly (`_graphed_against_eager`).
 14. slice G — the adversarial baseline of main_adv.py (base.yaml +
               hooks/adv.yaml: 5 + 5 slices, reg_weight 0.01) under `pallas`,
               1 warm-up + 5 steps and one eval epoch, then
               `trainer_checkpoint` resume into epoch 2: the stage kernels
               twice a step (labeled and unlabeled forward and backward),
               every discriminator tensor moved, finite gen/dis losses, the
               discriminator and its Adam state restored; ms/step, slices/s,
               a profile. Then one adversarial step on the card against the
               CPU: losses, every gradient, the updated student and
               discriminator, the running statistics.
 15. bf16    — (run after phase 3's stage check) the bf16 instantiation of
               the seven stage kernels against their plain bf16 versions
               (same rounding points) at S1, S2 (B=60), the fine-tune's B=5
               and a small shape: forward and backward as wholes (random dp,
               random non-zero de, de absent), each pass alone, two runs bit
               for bit; bf16-stored tensors within 2^-7 x max|plain|, float
               outputs of one pass within STAGE_TOL, those downstream of a
               stored bf16 intermediate within 2e-3; each pass timed beside
               its bound (2-byte activations; the products at the bf16
               tensor-core peak, and beside it at the TF32 peak, the route
               the kernels take) and the bf16 library call. The same
               function as phase 3's stage check, given the dtype.
 16. slice H — `Arch.dtype: bfloat16` on main_pretrain_encoder.py's path
               (CONFIG, UNet-256, crop 224 of 256, 2N=60, RAdam) through
               build_trainer, under `pallas` then `nhwc`: 2 epochs x 3
               pretrain steps with `Trainer.profile_dir` (epoch 2 traced;
               its device ms/step within 5% of `_profiled`'s) and
               `dump_matrices` (four [60, 60] finite matrices); the bf16
               stage kernels' launches (pallas: 12 a step, none of float32);
               ms/step, kernel ms/step, busy share, stage kernels, peak
               memory beside float32's (slices A and B, this run); then the
               fine-tune (3 epochs of 5 steps at batch 5 and an eval) from
               its last.ckpt eagerly and with `defer_reads`:
               storage rows, the best score and best.ckpt's weights within
               1e-4, each best.ckpt of the first epoch of its run's highest
               val DSC.
 17. slice I — evaluating, inspecting and serving a trained model at the
               paper's width (UNet-256, 4 classes, crop 224 of 256, `nhwc`):
               1 fine-tune epoch of 5 steps from slice B's pretrain last.ckpt;
               `spcl_torch.inference.run_inference` from its last.ckpt, its
               Dice equal to the trainer's own eval epoch on the test loader,
               the forward's and the surface meters' ms per scan apart;
               `spcl_torch.weight_inspection.inspect` from slice B's
               checkpoint at 2N=60 (sp_mask in [0, 1], pos_mask symmetric,
               finite losses, the npz keys of weight_inspection.py, its wall
               time); the fine-tune checkpoint exported with a symbolic
               batch in float32 and in bf16 and served by `make_http_server`
               on 127.0.0.1 in a thread: 3 warm-up requests, then 50 at batch
               1, 8 and 32 of 224^2 uint8 slices with `?outputs=both` and 50
               with `?outputs=pred`, every response held to the live
               module's eval forward on the card (TF32 off; float32 logits
               within 1e-4, bf16 within 2^-7 x max|logits|, pred equal where
               the top two logits are further apart): p50 / p99 latency,
               slices/s and the direct forward's ms at each batch. No kernel
               of spcl_torch.ops runs in eval mode.
 18. slice J — every trainer under `Trainer.mesh=2` at full width (UNet-256,
               crop 224 of 256, `nhwc`; two ranks over NCCL with two or more
               cards, over gloo on one, as slice C), each against this
               process running the same padded batches and draws alone:
               J1 main.py at production_semi + mt + uda (32 + 32 slices, 2
               epochs x 1 warm-up + 3 timed steps, eval epochs) — per-step
               losses and hook metrics, student and teacher weights, replicas
               equal to the bit, files from rank 0 only, last.ckpt reloading
               strictly, ms/step beside one process, then `trainer_checkpoint`
               resume under the mesh into epoch 2 against the uninterrupted
               run; J2 the presets entropy, ucmeanteacher, iic, udaiic, midl,
               mine and infonce (row_sharded: one supcon_fwd and one
               supcon_bwd strip a rank, shape printed) at base.yaml's 5 + 5
               slices padded to 6 + 6, 1 step each; J3 main_mixup at alpha 1
               and 0.4 and main_adv (reg_weight 0.01), 3 steps each, the
               discriminator's update too; J4 main_pretrain_decoder at
               infonce_dense.yaml (9 slices padded to 10) under replicated
               (pretraining) and row_sharded (both phases), 3 steps each, one
               forward and one dz launch a rank and step, each held to the
               plain version; J5 a fine-tune of 2 epochs x 3 steps with
               `defer_reads` against the eager one under the mesh.
               Tolerances (stated at `J_LOSS_TOL`): weights slice C's,
               losses and hook metrics 5e-3 relative (TF32).
 19. slice K — the paper's effect study through spcl_torch.scripts (UNet-128,
               crop 48 of a 64 canvas, `synthetic: hard`, 2 labeled scans,
               Adam 1e-3, `nhwc`), cut to 2 epochs x 10 batches a phase:
               `effect_study.run_arm` for seed 10 at `scratch` and
               `spsoft_corrupt` (80% corrupted meta-labels, SP soft gamma
               8 -> 40: 20 pretrain steps at 2N=60, then the fine-tune from
               its last.ckpt; `run_arm` trains under its
               `backend_corner("deterministic")`), then the probe of that checkpoint
               (`probe_pretrain_features.embed_dataset` + `probe_accuracy`).
               Checks: one supcon_fwd and one supcon_bwd a pretrain step,
               none in the fine-tune, each call held to its plain version
               on its own operands (shape printed); finite losses, DSC in
               [0, 1], pre/last.ckpt reloading strictly; the card's Conv5
               embedding within 1e-2 relative L2 of the CPU's (cuDNN's TF32
               convolutions: 2^-10 a product, through ten of them); under
               60 s.
 20. slice L — (a) `Trainer.name: infoncepretrain` on slice A's path
               (CONFIG with the `infonce` preset's InfonceParams in place
               of SPInfonceParams: UNet-256, crop 224 of 256, 2N=60, `nhwc`),
               1 epoch x 5 steps through build_trainer: the encoder-pretrain
               trainer to Conv5, one supcon_fwd and one supcon_bwd a step,
               each call held to its plain version, finite losses, a
               last.ckpt that reloads strictly. (b) two ranks started by
               hand, `python3 chip_smoke.py --slice-l-rank` with
               SPCL_COORDINATOR, SPCL_NUM_PROCESSES, SPCL_PROCESS_ID,
               SPCL_LOCAL_RANK and SPCL_LOCAL_WORLD_SIZE set, under
               `Trainer.mesh: auto`, beside one process alone, twice
               (cuDNN TF32 off in all four): infoncepretrain 2 epochs x 2 steps at
               RAdam 1e-4, then a fine-tune of 2 steps at batch 4 with eval.
               Two local ranks on one card take gloo and both compute on
               cuda:0 (NCCL with a card each); the ranks report world 2 and
               2 shards; their losses, DSC and pretrain weight moves agree
               to 1e-6 and match the one process to 1e-5 (weight moves
               2e-3); files from rank 0 only. NCCL across hosts is not shown
               (one host).
 21. slice M — `Arch.small_c_layout: packed` (spcl_tpu's lane-packed stages:
               their BatchNorm at Conv1/Conv2, biased running variance, x *
               inv + shift) on slice B's configuration (CONFIG: UNet-256,
               crop 224 of 256, 2N=60) beside `nhwc`, from the same weights
               and draws, cuDNN TF32 off: 1 epoch x 3 pretrain steps each
               through build_trainer, one supcon_fwd and one supcon_bwd a
               step, each call held to its plain version; the losses agree
               (train-mode BatchNorm uses batch statistics); Conv1/Conv2's
               running variances stand in Bessel's ratio n/(n-1) to nhwc's,
               Conv3's equal (at n = 3.0M and 0.75M values a channel the
               factor is within float32's rounding of the statistics: the
               CPU test tests/test_torch_packed_layout.py separates it);
               eval-mode logits equal those of an nhwc copy given packed's
               running statistics; then the step times, 10 steps a turn in
               the turns packed, nhwc, nhwc, packed, and 5 steps of each
               under torch.profiler (kernel time by kernel), where each
               kernel of spcl_torch.ops launches a step what its `LAUNCHES`
               count (the steps replay a CUDA graph there: the counts a
               replay adds are its capture's). The held runs take their steps
               eagerly; then packed and nhwc float32 and pallas bf16, 3 steps
               each, replayed as a CUDA graph against the same steps run
               eagerly (`_graphed_against_eager`: TF32 off, cuDNN
               deterministic; losses and weights within SLICE_GRAPH_RTOL,
               captures 1, replays 2, every kernel's launches equal).
 22. slice N — the last of spcl_tpu's public surface, card against the CPU at
               the main path's shapes, no kernel of spcl_torch.ops launched:
               Cutout (`sample_cutout` boxes 16..112 + `apply_cutout`) and
               Sobel (`sobel_process`, include_origin) on slice A's 2N=60
               one-channel 224^2 slices (Cutout bit-equal, the erased
               pixels 4 half^2 a slice; Sobel within 1e-6 x max|g|);
               `ProjectionHead(pool_name="adaptive_max")` at 1x1 and 2x2 on
               Conv5-shaped [60, 256, 14, 14] features and
               `DenseProjectionHead(pool_name="adaptive_max")` at 10x10 on
               slice F's Up_conv3 shape [18, 32, 112, 112], both on
               relu(N(0, 1) - 2) (tied all-zero windows): forward, input
               and parameter gradients (tolerances at SLICE_N_HEAD_TOL);
               the ms of each call, and of the max pool beside
               F.adaptive_max_pool2d.
 23. slice O — the fused BatchNorm + ReLU (`ops/bnrelu_cuda.py`) at the
               encoder shapes of a 2N=60 pretrain step (Conv1..Conv5, two
               a stage) and at a gradient-cache chunk of 128 views: the four
               kernels against their plain versions (statistics and running
               statistics within BNRELU_TOL, the apply passes equal to the
               bit given the same statistics), then per stage the least
               time of its eight passes at 3.35 TB/s, the kernels' forward +
               backward, the plain versions' and cuDNN's BatchNorm + in-place
               ReLU (the library yardstick, never called by the port), by
               CUDA-graph replay, and the step's totals; then a short run
               of each benchmark cell (`portbench.harness.run_cell`,
               BNRELU_CELL_SECONDS of window) with the train step's
               CUDA-graph counters and the kernels' launches a step.
 24. slice P — Swin-Unet (`Arch.name: swin_unet`): the window-attention
               kernels of `ops/csrc/wattn.cu` at a 2N=60 step's stage shapes
               (56^2 x 96 .. 7^2 x 768, shifted and not) against the plain
               forward and autograd's gradient of it (SWIN_KERNEL_TOL,
               SWIN_GRAD_TOL; two backwards bit-equal), timed by graph
               replay beside the plain version and the bound of
               `portbench/counts/swin_unet.py`;
               the whole model (decoder too) at the published widths,
               forward + backward, against `portbench/reference/
               swin_unet.py` on the card (TF32 off, SWIN_MODEL_TOL); 3
               graphed Swin pretrain steps against 3 eager ones (TF32 off,
               cuDNN deterministic: bit-equal); `LAUNCHES` against the
               profiler's kernel events over 5 graphed steps.
 25. report  — the `kernels` JSON line (the bf16 passes as
               `convstage_<pass>_bf16`; the four `bnrelu_*` kernels with
               slice O's times), the nvidia-smi line, a device line
               with the slices' throughput, and last
               {"ok": true, "device": {...}}.

Development aids: `--stage-kernels-only` stops after the build and the stage
kernel checks (float32, then bf16), `--bf16-only` runs the build and phases
15 and 16, `--supcon-kernels-only` runs the build and phases 3 (supcon
part) and 8, `--mesh-only` the build and phases 8-10, `--bigbatch-only` the
build and phase 11, `--semi-only` the build and phase 12,
`--decoder-adv-only` the build and phases 13 (without the warm start) and 14,
`--serving-only` the build and phase 17 (the fine-tune from a fresh UNet,
weight inspection of its random initialisation), `--semi-mesh-only` the
build and phase 18, `--effect-only` the build and phase 19,
`--multihost-only` the build and phase 20, `--packed-only` the build and
phase 21, `--surface-only` the build and phase 22, `--bnrelu-only` the
build and phase 23, `--swin-only` the build and phase 24.
"""
import contextlib
import copy
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# bytes/s, float32 FLOP/s (no tensor cores), dense TF32 and bf16 tensor-core
# FLOP/s of one H100 SXM (data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
# checked against the plain versions; 10 is the infonce presets' 2N (5 + 5 views)
# and 90 the dense InfoNCE's of decoder pretraining (9 slices x 5 points, two views)
SIZES = (10, 60, 90, 126, 1024, 3840)
TIMING_SIZES = (60, 90, 126, 256, 512, 1024, 3840)
D = 256
MAIN_2N = 60
DENSE_2N = 90
DECODER_VIEWS = 2 * 3 * 3   # two views of 3 scans x 3 ACDC partitions
DEVICE = "cuda"

# base.yaml + pretrain.yaml + specific/selfpaced_infonce.yaml, with
# Data.synthetic, max_epoch 1 and num_batches 5 (the port runs without pyyaml)
CONFIG = {
    "RandomSeed": 10,
    "Arch": {"input_dim": 1, "num_classes": 4, "checkpoint": None, "max_channel": 256,
             "momentum": 0.1, "dtype": "float32", "small_c_layout": "nhwc"},
    "Optim": {"name": "RAdam", "lr": 1e-7, "weight_decay": 1e-5},
    "Scheduler": {"multiplier": 400, "warmup_max": 10},
    "Data": {"name": "acdc", "labeled_scan_num": 1, "canvas": 256, "crop": 224,
             "synthetic": True, "synthetic_scans": 20, "synthetic_test_scans": 8,
             "root": None},
    "LabeledLoader": {"batch_size": 5},
    "UnlabeledLoader": {"batch_size": 5},
    "Trainer": {"save_dir": "runs/chip_smoke", "num_batches": 5, "max_epoch": 1,
                "name": "pretrain_encoder", "save_every": 1, "device_data": True},
    "ContrastiveLoaderParams": {"scan_sample_num": 10, "partition_sample_num": 1},
    "SPInfonceParams": {"feature_names": "Conv5", "weights": 0.1,
                        "contrast_ons": "partition", "temperature": 0.07,
                        "begin_values": 3, "end_values": 14, "p": 0.5, "mode": "hard"},
}


# views per step: 2 x scan_sample_num x 3 ACDC partitions x partition_sample_num
VIEWS = 2 * 3 * CONFIG["ContrastiveLoaderParams"]["scan_sample_num"] \
    * CONFIG["ContrastiveLoaderParams"]["partition_sample_num"]


def phase(name):
    print(f"== {name}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def device_phase():
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — this script runs only on the GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return smi


def build_phase(*modules):
    """One nvcc per source, all started together."""
    phase("build")
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        results = list(pool.map(lambda m: m.build(verbose=True), modules))
    for path, seconds, log in results:
        print(f"built {path.relative_to(ROOT)} in {seconds:.2f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print("  ptxas:", line.strip(), flush=True)
    print(f"build wall time {time.perf_counter() - t0:.2f} s", flush=True)


# (rows, cols) the supcon kernels run at: the square form at 2N in SIZES and
# the strips of the strips phase (and slice C's 64 x 128)
PLAN_SHAPES = ((64, 64), (128, 128), (1024, 1024), (3840, 3840), (32, 64), (64, 128),
               (480, 3840))


def supcon_plans(sc):
    """The launch plan of each supcon kernel at the path's shapes: the
    cluster size chosen, and the clusters of that size the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    for rows, cols in PLAN_SHAPES:
        for name in ("supcon_fwd", "supcon_bwd"):
            print(f"plan {name} {rows}x{cols}: {sc.plan(name, rows, cols, D)}", flush=True)


# ------------------------------------------------------------------ kernels
def _inputs(n2, gen, pad_rows=0, simclr=False):
    """z [2N, D] L2-normalized with label-correlated structure, labels in 3
    partitions (as the batch sampler gives them), valid with `pad_rows`
    zeros at the end of each view. `simclr`: the dense InfoNCE's targets
    instead, each row's only positive its other view (labels 0..N-1, -1 on
    the padded rows), the two views of a row close."""
    n = n2 // 2
    valid = torch.ones(n, device=DEVICE)
    if pad_rows:
        valid[-pad_rows:] = 0.0
    if simclr:
        labels = torch.arange(n, device=DEVICE)
        labels[valid == 0] = -1
        base = torch.randn(n, D, generator=gen, device=DEVICE)
        z = torch.cat([base, base]) + 0.7 * torch.randn(n2, D, generator=gen, device=DEVICE)
    else:
        labels = torch.arange(n, device=DEVICE) % 3
        centers = torch.randn(3, D, generator=gen, device=DEVICE)
        z = torch.cat([centers[labels], centers[labels]]) * 0.3 \
            + torch.randn(n2, D, generator=gen, device=DEVICE)
    z = torch.nn.functional.normalize(z, dim=1)
    return z[:n].contiguous(), z[n:].contiguous(), labels.int(), valid


def _hard_gamma(sc, z1, z2, labels, valid):
    """A hard-mode gamma inside the spread of the pair losses but away from
    ties: the midpoint of the widest gap among the top 1% of the positive
    pairs' -logp (plain computation)."""
    z, t2, v2, n_pad = sc._prepare(z1, z2, labels, valid)
    gid = torch.arange(n_pad, dtype=torch.float32, device=DEVICE)
    s, p, e = sc._pair_terms(z, z, t2, t2, v2, v2, gid, gid, 1 / 0.07)
    nll = -(s - torch.log(e.sum(1) + sc._EPS)[:, None])
    vals = torch.sort(nll[p > 0]).values
    top = vals[min(int(0.99 * (len(vals) - 1)), len(vals) - 3):]
    k = int(torch.argmax(top[1:] - top[:-1]))
    return float((top[k] + top[k + 1]) / 2), float(top[k + 1] - top[k])


def _stats_and_dz(sc, use_kernel, z1, z2, labels, valid, gamma, mode, correct_grad):
    """(loss, ratio, per-row stats, dz1, dz2) through the autograd Function,
    on the kernels or on the plain versions."""
    saved = (sc.fwd_stats_kernel, sc.bwd_dz_kernel)
    if not use_kernel:
        sc.fwd_stats_kernel, sc.bwd_dz_kernel = sc.fwd_stats_plain, sc.bwd_dz_plain
    try:
        a = z1.clone().requires_grad_(True)
        b = z2.clone().requires_grad_(True)
        loss, ratio = sc.FusedSupCon.apply(a, b, labels, valid, gamma, 1 / 0.07, mode,
                                           correct_grad)
        loss.backward()
        z, t2, v2, n_pad = sc._prepare(z1, z2, labels, valid)
        gid = torch.arange(n_pad, dtype=torch.float32, device=DEVICE)
        stats = sc.fwd_stats(z, z, t2, t2, v2, v2, gid, gid, 1 / 0.07, gamma, mode)
        torch.cuda.synchronize()
        return loss.detach(), ratio, stats, a.grad, b.grad
    finally:
        sc.fwd_stats_kernel, sc.bwd_dz_kernel = saved


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SUPCON_LIBRARY_CALLS = {"supcon_fwd": "torch.mm(zr, zc.T)",
                        "supcon_bwd": "torch.mm(zr, zc.T) + torch.mm(g, zc)"}


def _supcon_library(zr, zc):
    """The products of each supcon pass alone, one float32 `torch.mm` each
    with TF32 off (the callers set it): s = zr @ zc.T for the forward, and
    that plus G @ zc for the backward (G of s's shape). Timed as
    yardsticks; the port never calls them."""
    def bwd():
        torch.mm(torch.mm(zr, zc.T), zc)
    return {"supcon_fwd": lambda: torch.mm(zr, zc.T), "supcon_bwd": bwd}


def _graph_ms(fn, reps):
    """Device ms per call of `fn`: `reps` calls captured in one CUDA graph
    and replayed (best of three replays), so that the host's time to issue
    a call (the Python wrapper, the launch) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    return best


def _time_supcon(sc, fargs, bargs, reps):
    """Times (ms) of the forward stats and of dz on these operands: the
    kernel (`ms`), the plain version and the library yardstick as device
    time per call (`_graph_ms`, kernel and plain in turns plain, kernel,
    kernel, plain), and the kernel called eagerly back to back (`eager_ms`:
    CUDA events, the host's time per call included where it is the longer);
    and the launch plan of each kernel."""
    zr, zc = fargs[0], fargs[1]
    library = _supcon_library(zr, zc)
    out = {}
    for name, kernel, plain, args in (
            ("supcon_fwd", sc.fwd_stats_kernel, sc.fwd_stats_plain, fargs),
            ("supcon_bwd", sc.bwd_dz_kernel, sc.bwd_dz_plain, bargs)):
        p1 = _graph_ms(lambda: plain(*args), reps)
        k1 = _graph_ms(lambda: kernel(*args), reps)
        k2 = _graph_ms(lambda: kernel(*args), reps)
        p2 = _graph_ms(lambda: plain(*args), reps)
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "library_ms": _graph_ms(library[name], reps),
                     "library_call": SUPCON_LIBRARY_CALLS[name],
                     "eager_ms": _time_ms(lambda: kernel(*args), reps),
                     "plan": sc.plan(name, zr.shape[0], zc.shape[0], zr.shape[1])}
        torch.cuda.empty_cache()
    return out


def _time_pair(sc, n2, gen):
    """Times of the forward stats and of dz at 2N=n2 (`_time_supcon`), after
    checking that two runs of each kernel give the same bits."""
    z1, z2, labels, valid = _inputs(n2, gen)
    z, t2, v2, n_pad = sc._prepare(z1, z2, labels, valid)
    gid = torch.arange(n_pad, dtype=torch.float32, device=DEVICE)
    inv_t, gamma = 1 / 0.07, 3.0
    fargs = (z, z, t2, t2, v2, v2, gid, gid, inv_t, gamma, "hard")
    _, c, denom, a, _ = sc.fwd_stats(*fargs)
    scale = torch.full((1,), 1.0 / n2, device=DEVICE)
    bargs = (z, z, t2, t2, v2, v2, gid, gid, c, c, denom, denom, a, a, inv_t, gamma,
             scale, "hard")
    same = all(torch.equal(x, y) for x, y in zip(sc.fwd_stats_kernel(*fargs),
                                                 sc.fwd_stats_kernel(*fargs)))
    check(same and torch.equal(sc.bwd_dz_kernel(*bargs), sc.bwd_dz_kernel(*bargs)),
          f"two runs of the supcon kernels differ at 2N={n2}")
    return _time_supcon(sc, fargs, bargs, 200 if n2 <= 1024 else 20)


def _supcon_bounds(rows, cols, fwd_bytes, bwd_bytes):
    """Least ms for the supcon kernels on a rows x cols rectangle at D=256:
    the larger of the bytes over the memory rate and the operations over the
    peak for their type. Operations: the forward one [rows, D] x [D, cols]
    product (2 rows cols D FLOPs), the backward that and G @ z (twice).
    `bound_f32_*`: float32 outside the tensor cores; `bound_3xtf32_*`: the
    kernels' own arithmetic, three TF32 products on the tensor cores, which
    is their `bound_ms`."""
    out = {}
    for name, nbytes, flops in (("supcon_fwd", fwd_bytes, 2.0 * rows * cols * D),
                                ("supcon_bwd", bwd_bytes, 4.0 * rows * cols * D)):
        tb = nbytes / HBM_BYTES_PER_S
        tf, t3 = flops / F32_FLOPS, 3 * flops / TF32_FLOPS
        out[name] = {"bound_ms": max(tb, t3) * 1e3,
                     "bound_by": "operations" if t3 > tb else "bytes",
                     "bound_3xtf32_ms": max(tb, t3) * 1e3,
                     "bound_3xtf32_by": "operations" if t3 > tb else "bytes",
                     "bound_f32_ms": max(tb, tf) * 1e3,
                     "bound_f32_by": "operations" if tf > tb else "bytes"}
    return out


def _bound_ms(n2):
    """`_supcon_bounds` of the square form at 2N=n2. Bytes: z read once, 3
    [2N] row vectors read, outputs written once (4 vectors forward, dz
    backward, which also reads 3 statistics per row)."""
    z_bytes, vec = n2 * D * 4, n2 * 4
    return _supcon_bounds(n2, n2, z_bytes + 7 * vec, 2 * z_bytes + 9 * vec)


def _print_supcon_times(what, t):
    for name, v in t.items():
        pl = v["plan"]
        print(f"time {what} {name}: kernel {v['ms']:.4f} ms (eager {v['eager_ms']:.4f}) | "
              f"plain {v['plain_ms']:.4f} ms | "
              f"library {v['library_call']} (float32, TF32 off) {v['library_ms']:.4f} ms | "
              f"bound (3xTF32) {v['bound_3xtf32_ms']:.6f} ms ({v['bound_3xtf32_by']}) | "
              f"bound (float32) {v['bound_f32_ms']:.6f} ms ({v['bound_f32_by']}) | plan: "
              f"cluster {pl['cluster']} x {pl['row_tiles']} row tiles, {pl['tiles_per_block']} "
              f"column tiles a block" + (f", s of {pl['kept']} kept (room for "
                                        f"{pl['keep_max']})" if name == "supcon_fwd" else "")
              + f", {pl['active_clusters']} clusters resident, {pl['smem_bytes']} B shared",
              flush=True)


def kernel_phase(sc):
    phase("kernels vs plain")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    max_err = {"supcon_fwd": 0.0, "supcon_bwd": 0.0}
    cases = 0
    for n2 in SIZES:
        for pad_rows in {10: (0, 1), DENSE_2N: (0, 5), 126: (0, 5)}.get(n2, (0,)):
            z1, z2, labels, valid = _inputs(n2, gen, pad_rows, simclr=n2 == DENSE_2N)
            hard_gamma, gap = _hard_gamma(sc, z1, z2, labels, valid)
            for mode, correct_grad in (("none", False), ("soft", False), ("soft", True),
                                       ("hard", False), ("hard", True)):
                gamma = {"none": 1e9, "soft": 8.0, "hard": hard_gamma}[mode]
                k = _stats_and_dz(sc, True, z1, z2, labels, valid, gamma, mode, correct_grad)
                p = _stats_and_dz(sc, False, z1, z2, labels, valid, gamma, mode, correct_grad)
                # per-row stats: rowloss, c, log(denom), a — all O(1..10)
                fwd_err = max(float((k[2][0] - p[2][0]).abs().max()),
                              float((k[2][1] - p[2][1]).abs().max()),
                              float((torch.log(k[2][2] + 1e-16)
                                     - torch.log(p[2][2] + 1e-16)).abs().max()),
                              float((k[2][3] - p[2][3]).abs().max()))
                dz_scale = float(torch.cat([p[3], p[4]]).abs().max())
                dz_err = float(torch.cat([k[3] - p[3], k[4] - p[4]]).abs().max())
                loss_err = abs(float(k[0]) - float(p[0]))
                ratio_err = abs(float(k[1]) - float(p[1]))
                # tolerances: float32 sums in another order over D=256 and 2N
                # columns; s carries 1/T = 14.3x the dot-product rounding
                tol_fwd = 2e-4
                tol_dz = 2e-4 * dz_scale
                ok = (fwd_err <= tol_fwd and dz_err <= tol_dz
                      and loss_err <= 2e-4 * max(1.0, abs(float(p[0])))
                      and ratio_err <= 1e-5)
                print(f"2N={n2:5d}{' simclr' if n2 == DENSE_2N else ''} pad={pad_rows} "
                      f"{mode:4s} cg={int(correct_grad)} "
                      f"gamma={gamma:.6g}{f' (gap {gap:.2e})' if mode == 'hard' else ''} "
                      f"loss={float(p[0]):.6f} ratio={float(p[1]):.4f} | err: "
                      f"stats {fwd_err:.2e} dz {dz_err:.2e} (scale {dz_scale:.2e}) "
                      f"loss {loss_err:.2e} ratio {ratio_err:.2e} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"kernel disagrees with plain at 2N={n2} {mode} cg={correct_grad}")
                max_err["supcon_fwd"] = max(max_err["supcon_fwd"], fwd_err)
                max_err["supcon_bwd"] = max(max_err["supcon_bwd"], dz_err)
                cases += 1
    print(f"{cases} cases agree (stats tol 2e-4 abs; dz tol 2e-4 x max|dz|)", flush=True)

    timings = {}
    for n2 in TIMING_SIZES:
        t = _time_pair(sc, n2, gen)
        bound = _bound_ms(n2)
        timings[n2] = {name: {**t[name], **bound[name]} for name in t}
        _print_supcon_times(f"2N={n2:5d}", timings[n2])
    print("two runs of each supcon kernel equal to the bit at every timing size", flush=True)
    print("timings " + json.dumps({str(k): v for k, v in timings.items()}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults again
    torch.backends.cudnn.allow_tf32 = True
    return max_err, timings


# ------------------------------------------------------------------ stage kernels
# (name, B, H, W, Ci, C, external_first): the two shapes of the main path at
# 2N = 60, a small odd-batch shape whose H and W are no tile multiples, and
# the semi, decoder-pretrain and adversarial paths' shapes
STAGE_SHAPES = (
    ("stage1", 60, 224, 224, 16, 16, True),
    ("stage2", 60, 112, 112, 16, 32, False),
    ("small-ext", 3, 20, 36, 16, 16, True),
    ("small", 3, 20, 36, 16, 32, False),
    # slice E: the semi step's student (32 labeled + 2 x 32 unlabeled) and
    # its EMA teacher (32 unlabeled, forward only); checked, not timed
    ("semi student 1", 96, 224, 224, 16, 16, True),
    ("semi student 2", 96, 112, 112, 16, 32, False),
    ("semi teacher 1", 32, 224, 224, 16, 16, True),
    ("semi teacher 2", 32, 112, 112, 16, 32, False),
    # slice F: decoder pretraining's 18 views (forward only on the path);
    # slice G: the adversarial step's labeled and unlabeled passes of 5
    # slices each (forward and backward, skip cotangent present)
    ("decoder F 1", DECODER_VIEWS, 224, 224, 16, 16, True),
    ("decoder F 2", DECODER_VIEWS, 112, 112, 16, 32, False),
    ("adv G 1", 5, 224, 224, 16, 16, True),
    ("adv G 2", 5, 112, 112, 16, 32, False),
)
STAGE_TOL = 2e-4  # x max|plain value| of each tensor
STAGE_REPLACES = {
    "conv": "spcl_tpu/experimental/packed_block_pallas.py:245 _k_conv",
    "bnconv": "spcl_tpu/experimental/packed_block_pallas.py:283 _k_bnconv",
    "bnpool": "spcl_tpu/experimental/packed_block_pallas.py:315 _k_bnpool",
    "poolsums": "spcl_tpu/experimental/packed_block_pallas.py:346 _k_poolsums",
    "dz1": "spcl_tpu/experimental/packed_block_pallas.py:374 _k_dz1",
    "dwprev": "spcl_tpu/experimental/packed_block_pallas.py:412 _k_dwprev",
    "dwdx": "spcl_tpu/experimental/packed_block_pallas.py:471 _k_dwdx",
}


# ------------------------------------------------------------------ stage kernels, bfloat16
# `Arch.dtype: bfloat16`: the main path's two stage shapes (slice H's pretrain
# step, B=60), the fine-tune step's (B=5) and a small odd-batch shape
BF16_STAGE_SHAPES = (
    ("stage1", 60, 224, 224, 16, 16, True),
    ("stage2", 60, 112, 112, 16, 32, False),
    ("finetune stage1", 5, 224, 224, 16, 16, True),
    ("finetune stage2", 5, 112, 112, 16, 32, False),
    ("small-ext", 3, 20, 36, 16, 16, True),
    ("small", 3, 20, 36, 16, 32, False),
)
# Tolerances x max|plain| of each tensor. A tensor stored in bf16 may be one
# rounding apart where the float32 sums before it differ in order (the
# kernels' tensor-core chains against cuDNN's): 2^-7, twice the largest
# relative step of one bf16 rounding. Float32 / float64 statistics and weight
# gradients computed from the same inputs keep the float32 phase's STAGE_TOL.
# In the whole-stage runs, the float outputs downstream of a stored bf16
# intermediate (mean1/var1 after z0; dW0, dW1, dgamma0, dbeta0 after dz1 and
# dy0) see those roundings: one bf16 step is 2^-8 = 3.9e-3 of an element,
# taken by a small share of the elements and averaged in the sums, so
# BF16_CHAINED_TOL = 2e-3.
BF16_STORED_TOL = 2.0 ** -7
BF16_CHAINED_TOL = 2e-3
BF16_STORED = ("p", "e", "z0", "z1", "dz1", "dy0", "dx", "dz0")
BF16_CHAINED = ("mean1", "var1", "dW0", "dgamma0", "dbeta0", "dW1")


def _bf16_tols(chained=False):
    tols = {name: BF16_STORED_TOL for name in BF16_STORED}
    if chained:
        tols.update({name: BF16_CHAINED_TOL for name in BF16_CHAINED})
    return tols


def _stage_inputs(gen, b, h, w, ci, c, external_first):
    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=DEVICE) * scale

    x = rn(b, h, w, c if external_first else ci)
    w0 = None if external_first else rn(3, 3, ci, c, scale=(9 * ci) ** -0.5)
    w1 = rn(3, 3, c, c, scale=(9 * c) ** -0.5)
    args = (x, w0, 1 + rn(c, scale=0.1), rn(c, scale=0.1), w1,
            1 + rn(c, scale=0.1), rn(c, scale=0.1))
    return args, rn(b, h // 2, w // 2, c), rn(b, h, w, c)


def _hold(what, names, kernel_out, plain_out, tols=None):
    """Every tensor of `kernel_out` against `plain_out` within its tolerance
    x max|plain|: `tols[name]`, else STAGE_TOL. Returns the largest absolute
    error."""
    worst, parts, bad = 0.0, [], []
    for name, k, p in zip(names, kernel_out, plain_out):
        tol = (tols or {}).get(name, STAGE_TOL)
        if p is None:
            check(k is None, f"{what}: {name} should be None")
            continue
        check(k.shape == p.shape, f"{what}: {name} shape {k.shape} vs {p.shape}")
        check(bool(torch.isfinite(k).all()), f"{what}: {name} not finite")
        scale = max(float(p.abs().max()), 1e-12)
        err = float((k.double() - p.double()).abs().max())
        parts.append(f"{name} {err:.1e}/{scale:.1e}")
        if err > tol * scale:
            n_bad = int(((k.double() - p.double()).abs() > tol * scale).sum())
            bad.append(f"{name}: {err:.3e} > {tol:.3g} x {scale:.3e} at {n_bad} of "
                       f"{k.numel()} elements")
        worst = max(worst, err)
    print(f"  {what}: " + " | ".join(parts) + " (abs err / max|plain|) "
          + ("FAIL" if bad else "ok"), flush=True)
    check(not bad, f"{what} differs from plain: " + "; ".join(bad))
    return worst


# the passes whose convolutions run on the tensor cores
CONV_PASSES = ("conv", "bnconv", "dwprev", "dwdx")


def _stage_bounds(b, h, w, ci, c, de=True, dtype=torch.float32):
    """Least ms for each pass on the H100: the larger of the bytes it must
    move (each input read once, each output written once; activations in
    `dtype`, weights 4 bytes an element) over the memory rate and its
    operations over the peak rate for their type. Every pass has
    `bound_f32_ms`, its float32 operations outside the tensor cores, which is
    the `bound_ms` of the pool passes. The convolution passes' `bound_ms` is
    that of their products on the tensor cores, as their kernels take them:
    float32 activations as three TF32 products a term (`bound_3xtf32_ms`),
    bfloat16 ones as bf16 products at the bf16 peak (`bound_bf16_ms`). `de=False`:
    the pool passes without the skip cotangent, as the pretrain path runs
    them (z1 and dp read; dz1 written by dz1)."""
    bf16 = dtype == torch.bfloat16
    f = 2 if bf16 else 4
    px = b * h * w
    skip = 1.0 if de else 0.0

    def conv_flops(i, o):
        return 2.0 * 9 * i * o * px

    bytes_ = {"conv": px * (ci + c) * f + 9 * ci * c * 4,
              "bnconv": px * 2 * c * f + 9 * c * c * 4,
              "bnpool": px * c * f * 2.25,              # z1 -> e, p
              "poolsums": px * c * f * (1.25 + skip),   # z1, de, dp
              "dz1": px * c * f * (2.25 + skip),        # z1, de, dp -> dz1
              "dwprev": px * c * f * 3 + 2 * 9 * c * c * 4,   # dz1, z0 -> dy0, dW1
              "dwdx": px * f * (2 * c + 2 * ci) + 2 * 9 * ci * c * 4}  # z0, dy0, x -> dx, dW0
    flops = {"conv": conv_flops(ci, c), "bnconv": conv_flops(c, c) + 3.0 * px * c,
             "bnpool": 4.0 * px * c, "poolsums": 9.0 * px * c, "dz1": 11.0 * px * c,
             "dwprev": 2 * conv_flops(c, c) + 4.0 * px * c,
             "dwdx": 2 * conv_flops(ci, c) + 4.0 * px * c}
    # the products' route: (key, seconds a FLOP)
    key, per_flop = ("bf16", 1 / BF16_FLOPS) if bf16 else ("3xtf32", 3 / TF32_FLOPS)
    out = {}
    for name in bytes_:
        tb, tf = bytes_[name] / HBM_BYTES_PER_S, flops[name] / F32_FLOPS
        out[name] = {"bound_ms": max(tb, tf) * 1e3,
                     "bound_by": "operations" if tf > tb else "bytes",
                     "bound_f32_ms": max(tb, tf) * 1e3,
                     "bound_f32_by": "operations" if tf > tb else "bytes"}
        if name not in CONV_PASSES:
            continue
        t = flops[name] * per_flop
        route = {"ms": max(tb, t) * 1e3, "by": "operations" if t > tb else "bytes"}
        out[name].update({f"bound_{key}_{k}": v for k, v in route.items()},
                         **{f"bound_{k}": v for k, v in route.items()})
    return out


def _library_calls(x, w0, z0, w1, dz1, dy0):
    """One PyTorch call per convolution pass that computes its convolution
    (not the BN, ReLU, mask or sums around it) on the same channels-last
    inputs, in their dtype (float32 with TF32 off, or bfloat16 with the
    weights rounded to it). Timed as yardsticks; the port never calls them."""
    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def oihw(w):
        return w.permute(3, 2, 0, 1).contiguous().to(z0.dtype)

    def conv_backward(grad, inp, w):
        return torch.ops.aten.convolution_backward(
            nchw(grad), nchw(inp), oihw(w), None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [True, True, False])

    calls = {"bnconv": ("F.conv2d Co=Ci", lambda: torch.nn.functional.conv2d(
                 nchw(z0), oihw(w1), padding=1)),
             "dwprev": ("aten.convolution_backward (d_in, dW)",
                        lambda: conv_backward(dz1, z0, w1))}
    if x is not None:
        calls.update({"conv": ("F.conv2d", lambda: torch.nn.functional.conv2d(
                          nchw(x), oihw(w0), padding=1)),
                      "dwdx": ("aten.convolution_backward (d_in, dW)",
                               lambda: conv_backward(dy0, x, w0))})
    return calls


def _best_of_turns(kernel_fn, plain_fn, reps, timer=None):
    """min over the turns plain, kernel, kernel, plain (ms), by CUDA events
    around eager calls (`_time_ms`) or another timer (`_graph_ms`)."""
    timer = timer or _time_ms
    p1 = timer(plain_fn, reps)
    k1 = timer(kernel_fn, reps)
    k2 = timer(kernel_fn, reps)
    p2 = timer(plain_fn, reps)
    return min(k1, k2), min(p1, p2)


L2_BYTES = 50e6  # the H100's L2


def _cycling(fn, input_sets):
    """fn over the input sets in turn: timed calls whose inputs would fit in
    the L2 cycle through enough copies that each finds its inputs in device
    memory."""
    state = {"i": 0}

    def call():
        state["i"] += 1
        return fn(*input_sets[state["i"] % len(input_sets)])
    return call


def stage_kernel_phase(cs, dtype=torch.float32):
    """Hold the stage kernels of `dtype` (float32, or the bf16 instantiation
    against the plain bf16 versions, which round at the same points) against
    their plain versions: the forward as a whole, the backward as a whole
    from the same residuals (random dp and random non-zero de, and de absent
    as on the pretrain path), each pass alone on the same inputs (the pool
    passes also with de absent), and two runs bit for bit; then time each
    pass at the main path's shapes (and bf16 at the fine-tune step's) beside
    its bounds and the library call in the same dtype."""
    bf16 = dtype == torch.bfloat16
    phase("stage kernels, bfloat16, vs plain" if bf16 else "stage kernels vs plain")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2 if bf16 else 1)
    whole_tols, pass_tols = (_bf16_tols(chained=True), _bf16_tols()) if bf16 else (None, None)
    results = {name: {"max_abs_err": 0.0, "shapes": {}} for name in cs.PASSES}
    fwd_names = ("p", "e", "mean0", "var0", "mean1", "var1")
    out_names = {"conv": ("z0", "sums"), "bnconv": ("z1", "sums"), "bnpool": ("e", "p"),
                 "poolsums": ("sums",), "dz1": ("dz1",), "dwprev": ("dy0", "dW1", "sums"),
                 "dwdx": ("dx", "dW0")}
    for shape_name, b, h, w, ci, c, ext in (BF16_STAGE_SHAPES if bf16 else STAGE_SHAPES):
        print(f"{shape_name}: B={b} {h}x{w} C {'(z0) ' if ext else f'{ci}->'}{c} "
              f"{'bf16 ' if bf16 else ''}external_first={ext}", flush=True)
        args, dp, de = _stage_inputs(gen, b, h, w, ci, c, ext)
        args = (args[0].to(dtype),) + args[1:]
        dp, de = dp.to(dtype), de.to(dtype)
        check(float(de.abs().max()) > 0 and float(dp.abs().max()) > 0, "zero cotangents")
        bwd_names = ("dz0" if ext else "dx", "dW0", "dgamma0", "dbeta0", "dW1", "dgamma1",
                     "dbeta1")
        out_k, res = cs.stage_forward(*args, ext)
        _hold("forward", fwd_names, out_k, cs.stage_forward(*args, ext, plain=True)[0],
              whole_tols)
        bwd_k = cs.stage_backward(res, dp, de, ext)
        check(out_k[0].dtype == dtype and bwd_k[0].dtype == dtype
              and out_k[2].dtype == torch.float32 and bwd_k[4].dtype == torch.float32,
              f"stage outputs {out_k[0].dtype}, gradients {bwd_k[0].dtype}, statistics "
              f"{out_k[2].dtype}, dW1 {bwd_k[4].dtype} for {dtype} inputs")
        _hold(f"backward (max|de| {float(de.abs().max()):.2f})", bwd_names, bwd_k,
              cs.stage_backward(res, dp, de, ext, plain=True), whole_tols)
        _hold("backward, de absent", bwd_names, cs.stage_backward(res, dp, None, ext),
              cs.stage_backward(res, dp, None, ext, plain=True), whole_tols)
        # two runs of the same inputs: fixed-order reductions give the same bits
        out_2, res_2 = cs.stage_forward(*args, ext)
        bwd_2 = cs.stage_backward(res_2, dp, de, ext)
        same = all(torch.equal(a, b2) for a, b2 in zip(out_k + bwd_k, out_2 + bwd_2)
                   if a is not None)
        check(same, f"{shape_name}: two runs of the same inputs differ")
        print("  two runs bit for bit: equal", flush=True)
        del out_2, res_2, bwd_2

        # each pass alone, kernel and plain on the same inputs
        x, z0, z1, w0, w1, g0, g1, mean0, var0, coef0, mean1, var1, coef1 = res
        n = b * h * w
        dcoef1, _, _ = cs.bn_bwd_coef(cs.poolsums_kernel(z1, coef1, dp, de), n, mean1, var1, g1)
        dz1 = cs.dz1_kernel(z1, coef1, dcoef1, dp, de)
        dy0, _, sums_dy0 = cs.dwprev_kernel(dz1, z0, coef0, w1)
        dcoef0, _, _ = cs.bn_bwd_coef(sums_dy0, n, mean0, var0, g0)
        pass_inputs = {"bnconv": (z0, coef0, w1), "bnpool": (z1, coef1),
                       "poolsums": (z1, coef1, dp, de), "dz1": (z1, coef1, dcoef1, dp, de),
                       "dwprev": (dz1, z0, coef0, w1)}
        if not ext:
            pass_inputs.update({"conv": (x, w0), "dwdx": (z0, dy0, dcoef0, x, w0)})
        timed = shape_name.startswith(("stage", "finetune"))
        bounds = _stage_bounds(b, h, w, ci, c, dtype=dtype)
        library = _library_calls(None if ext else x, w0, z0, w1, dz1, dy0)
        for name in cs.PASSES:
            if name not in pass_inputs:
                continue
            inputs = pass_inputs[name]
            kernel_fn, plain_fn = cs._KERNEL_PASSES[name], cs._PLAIN_PASSES[name]
            k_out, p_out = kernel_fn(*inputs), plain_fn(*inputs)
            if torch.is_tensor(k_out):
                k_out, p_out = (k_out,), (p_out,)
            err = _hold(f"pass {name}", out_names[name], k_out, p_out, pass_tols)
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            del k_out, p_out
            if name in POOL_PASSES:
                absent = inputs[:-1] + (None,)
                err = _hold(f"pass {name}, de absent", out_names[name][:1],
                            (cs._KERNEL_PASSES[name](*absent),),
                            (cs._PLAIN_PASSES[name](*absent),), pass_tols)
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            if not timed:
                continue
            ms, plain_ms = _best_of_turns(lambda: kernel_fn(*inputs),
                                          lambda: plain_fn(*inputs), 5)
            bd = bounds[name]
            entry = {"at": f"B={b} {h}x{w} C={'' if ext else f'{ci}->'}{c}"
                           + (" bf16" if bf16 else ""),
                     "ms": ms, "plain_ms": plain_ms, **bd}
            if name in CONV_PASSES:  # device time, without the host's launch path
                entry["graph_ms"], entry["plain_graph_ms"] = _best_of_turns(
                    lambda: kernel_fn(*inputs), lambda: plain_fn(*inputs), 5, timer=_graph_ms)
            if name in library:
                what, call = library[name]
                entry["library_ms"] = _time_ms(call, 5)
                entry["library_call"] = what + (" (bfloat16, channels-last)" if bf16 else
                                                " (float32, TF32 off, channels-last)")
            routes = [k[len("bound_"):-len("_ms")] for k in bd
                      if k.endswith("_ms") and k != "bound_ms"]
            graph = (f" (graph replay {entry['graph_ms']:.4f})" if "graph_ms" in entry else "")
            print(f"  time {name}: kernel {ms:.4f} ms{graph} | plain {plain_ms:.4f} ms | bound "
                  f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}; "
                  + ", ".join(f"{r} {bd[f'bound_{r}_ms']:.4f}" for r in routes) + ")"
                  + (f" | library {entry['library_call']} {entry['library_ms']:.4f} ms"
                     if "library_ms" in entry else ""), flush=True)
            results[name]["shapes"][shape_name] = entry
            if name in POOL_PASSES:
                _time_pool_pass(cs, name, entry, inputs, (b, h, w, c), results, shape_name)
        del res, bwd_k, out_k, dz1, dy0, args, dp, de, library
        torch.cuda.empty_cache()
    if not bf16:
        finetune_poolsums(cs, gen, results)
    print(f"poolsums plan{', bf16' if bf16 else ''}: " + " | ".join(
        f"{n}, de {'present' if de else 'absent'} "
        f"{cs.poolsums_plan(b, h, w, c, True, de, dtype)}" for n, b, h, w, c in
        (("stage1", 60, 224, 224, 16), ("stage2", 60, 112, 112, 32)) + FINETUNE_SHAPES
        for de in (True, False)), flush=True)
    print(f"stage_timings{'_bf16' if bf16 else ''} " + json.dumps(results), flush=True)
    torch.backends.cudnn.allow_tf32 = True
    return results


# the pool passes whose skip cotangent de is absent on the pretrain path
# (it stops at Conv5); de is the last input of both
POOL_PASSES = ("poolsums", "dz1")
# the stages of a fine-tune step: batch 5 (LabeledLoader), the whole UNet
FINETUNE_SHAPES = (("finetune stage1", 5, 224, 224, 16), ("finetune stage2", 5, 112, 112, 32))


def _pool_entry(cs, name, inputs, shape, de, reps):
    """Times of a pool pass on `inputs` (kernel against plain, in turns), by
    CUDA events around eager calls (`ms`) and by CUDA-graph replay
    (`graph_ms`: device time, without the host's time to launch a call);
    with its byte bound at the inputs' element size. Inputs that fit in the
    L2 are cycled through copies."""
    b, h, w, c = shape
    bd = _stage_bounds(b, h, w, c, c, de=de, dtype=inputs[0].dtype)[name]
    nbytes = bd["bound_ms"] * 1e-3 * HBM_BYTES_PER_S
    sets = [inputs] + [tuple(None if t is None else t.clone() for t in inputs)
                       for _ in range(math.ceil(3 * L2_BYTES / nbytes) - 1)]
    kernel_fn = _cycling(cs._KERNEL_PASSES[name], sets)
    plain_fn = _cycling(cs._PLAIN_PASSES[name], sets)
    ms, plain_ms = _best_of_turns(kernel_fn, plain_fn, reps)
    graph_ms, plain_graph_ms = _best_of_turns(kernel_fn, plain_fn, reps, timer=_graph_ms)
    entry = {"at": f"B={b} {h}x{w} C={c} de {'present' if de else 'absent'}", "ms": ms,
             "plain_ms": plain_ms, "graph_ms": graph_ms, "plain_graph_ms": plain_graph_ms,
             "input_copies": len(sets), **bd}
    print(f"  time {name} B={b} {h}x{w} C={c}, de {'present' if de else 'absent'}: kernel "
          f"{ms:.4f} ms (graph replay {graph_ms:.4f}) | plain {plain_ms:.3f} ms (graph "
          f"{plain_graph_ms:.3f}) | bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}) | "
          f"{100 * bd['bound_ms'] / graph_ms:.0f}% of the bound by graph replay"
          + (f" | {len(sets)} input copies" if len(sets) > 1 else ""), flush=True)
    return entry


def _time_pool_pass(cs, name, entry, inputs, shape, results, shape_name):
    """At a timed stage shape: the graph-replay time of the pool pass with de
    (poolsums only), and both times with de absent, as the pretrain path
    runs it (entry "<shape> de absent")."""
    if name == "poolsums":
        timed = _pool_entry(cs, name, inputs, shape, True, 5)
        entry.update({k: timed[k] for k in ("graph_ms", "plain_graph_ms")})
    results[name]["shapes"][f"{shape_name} de absent"] = _pool_entry(
        cs, name, inputs[:-1] + (None,), shape, False, 5)


def finetune_poolsums(cs, gen, results):
    """poolsums at the fine-tune step's stage shapes (batch 5, de present):
    held against plain, then timed."""
    for shape_name, b, h, w, c in FINETUNE_SHAPES:
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device=DEVICE)
        coef = torch.stack([1 + 0.1 * rn(c), 0.1 * rn(c)]).contiguous()
        inputs = (rn(b, h, w, c), coef, rn(b, h // 2, w // 2, c), rn(b, h, w, c))
        err = _hold(f"{shape_name}: pass poolsums B={b} {h}x{w} C={c}", ("sums",),
                    (cs.poolsums_kernel(*inputs),), (cs.poolsums_plain(*inputs),))
        results["poolsums"]["max_abs_err"] = max(results["poolsums"]["max_abs_err"], err)
        results["poolsums"]["shapes"][shape_name] = _pool_entry(cs, "poolsums", inputs,
                                                                (b, h, w, c), True, 20)


# ------------------------------------------------------------------ slice
def slice_phase(sc):
    phase("slice A: encoder pretrain, UNet-256, 224^2, 2N=60, small_c_layout nhwc")
    from spcl_torch.entry import build_trainer
    from spcl_torch.models import UNet
    from spcl_torch.schedulers import PScheduler
    from spcl_torch.training import load_model_state_dict

    save_dir = ROOT / CONFIG["Trainer"]["save_dir"]
    shutil.rmtree(save_dir, ignore_errors=True)
    trainer = build_trainer(CONFIG, save_dir=str(save_dir), pretrain=True, device=DEVICE)
    check(trainer._forward_until == "Conv5", trainer._forward_until)
    trainer.init()
    steps = CONFIG["Trainer"]["max_epoch"] * CONFIG["Trainer"]["num_batches"]
    sc.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.start_training()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sc.LAUNCHES)
    print(f"launches in {steps} steps: {launches}", flush=True)
    check(launches == {"supcon_fwd": steps, "supcon_bwd": steps},
          f"expected one forward and one dz launch per step, got {launches}")

    sp = CONFIG["SPInfonceParams"]
    sched = PScheduler(max_epoch=CONFIG["Trainer"]["max_epoch"],
                       begin_value=sp["begin_values"], end_value=sp["end_values"], p=sp["p"])
    check(len(trainer.step_metrics) == steps, len(trainer.step_metrics))
    for rec in trainer.step_metrics:
        hm = rec["hooks"]["spinfonce/Conv5/partition"]
        check(math.isfinite(rec["reg_loss"]), rec)
        check(0.0 <= hm["sp_weight"] <= 1.0, rec)
        # gamma travels as a float32 metric
        check(abs(hm["age_param"] - sched.get_value(rec["epoch"] - 1)) < 1e-5, rec)
        print(f"epoch {rec['epoch']} reg_loss {rec['reg_loss']:.6f} "
              f"sp_weight {hm['sp_weight']:.4f} gamma {hm['age_param']:.4f}", flush=True)
    ckpt = save_dir / "last.ckpt"
    check(ckpt.exists(), f"{ckpt} missing")
    fresh = UNet(input_dim=1, num_classes=4, max_channel=CONFIG["Arch"]["max_channel"])
    fresh.load_state_dict(load_model_state_dict(str(ckpt)), strict=True)
    thr = trainer.last_epoch_stats["tra"]["throughput"]
    print(f"slice: {steps} steps in {wall:.2f} s incl. first-step warm-up; last epoch "
          f"{thr['steps_per_sec']:.3f} steps/s, {thr['slices_per_sec']:.1f} slices/s "
          f"({VIEWS} views per step); last.ckpt reloads strictly", flush=True)
    return launches, thr, trainer


# launches of the stage kernels in one train step: stage 1 (fed by an
# ordinary first convolution) skips `conv` and `dwdx`, stage 2 runs all seven
STAGE_LAUNCHES_PER_STEP = {"convstage_conv": 1, "convstage_bnconv": 2, "convstage_bnpool": 2,
                           "convstage_poolsums": 2, "convstage_dz1": 2,
                           "convstage_dwprev": 2, "convstage_dwdx": 1}


def slice_b_phase(sc, cs):
    phase("slice B: pretrain then fine-tune sweep and eval, small_c_layout pallas")
    import csv
    from spcl_torch.entry import build_trainer, val
    from spcl_torch.models import UNet
    from spcl_torch.training import load_model_state_dict

    config = copy.deepcopy(CONFIG)
    config["Arch"]["small_c_layout"] = "pallas"
    config["Trainer"]["save_dir"] = "runs/chip_smoke_b"
    save_dir = ROOT / config["Trainer"]["save_dir"]
    shutil.rmtree(save_dir, ignore_errors=True)
    steps = config["Trainer"]["max_epoch"] * config["Trainer"]["num_batches"]

    # ---- phase 1 of main_pretrain_encoder.py
    trainer = build_trainer(config, save_dir=str(save_dir / "pre"), pretrain=True,
                            device=DEVICE)
    check(trainer.model.small_c_layout == "pallas", trainer.model.small_c_layout)
    trainer.init()
    sc.reset_launch_counts()
    cs.reset_launch_counts()
    trainer.start_training()
    torch.cuda.synchronize()
    pre_launches = {**sc.LAUNCHES, **cs.LAUNCHES}
    want = {"supcon_fwd": steps, "supcon_bwd": steps,
            **{k: v * steps for k, v in STAGE_LAUNCHES_PER_STEP.items()}}
    print(f"pretrain launches in {steps} steps: {pre_launches}", flush=True)
    check(pre_launches == want, f"pretrain launches: expected {want}, got {pre_launches}")
    for rec in trainer.step_metrics:
        hm = rec["hooks"]["spinfonce/Conv5/partition"]
        check(math.isfinite(rec["reg_loss"]) and 0.0 <= hm["sp_weight"] <= 1.0, rec)
        print(f"pretrain reg_loss {rec['reg_loss']:.6f} sp_weight {hm['sp_weight']:.4f}",
              flush=True)
    ckpt = save_dir / "pre" / "last.ckpt"
    check(ckpt.exists(), f"{ckpt} missing")

    # ---- phase 2: the fine-tune sweep (one ratio), with eval after the epoch
    ft_config = copy.deepcopy(config)
    del ft_config["Trainer"]["name"]
    sc.reset_launch_counts()
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    scores = val(base_config=ft_config, pretrained_checkpoint=str(ckpt),
                 save_dir=str(save_dir), labeled_ratios=[1], device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ft_launches = {**sc.LAUNCHES, **cs.LAUNCHES}
    # what the train steps alone launch: the eval epochs (val and test
    # loaders, eval mode) ran in the same call and added nothing
    want = {"supcon_fwd": 0, "supcon_bwd": 0,
            **{k: v * steps for k, v in STAGE_LAUNCHES_PER_STEP.items()}}
    print(f"fine-tune + eval launches in {steps} train steps: {ft_launches}", flush=True)
    check(ft_launches == want, f"fine-tune launches: expected {want}, got {ft_launches}")
    check(list(scores) == [1] and 0.0 <= scores[1] <= 1.0, f"DSC out of range: {scores}")
    run = save_dir / "tra_1"
    rows = list(csv.DictReader(open(run / "storage.csv")))
    check(len(rows) == 1, rows)
    for key in ("tra/sup_loss/mean", "val/loss/mean", "test/loss/mean",
                "val/dice/DSC_mean", "test/dice/DSC_mean"):
        check(math.isfinite(float(rows[0][key])), f"{key} = {rows[0][key]}")
    fresh = UNet(input_dim=1, num_classes=4, max_channel=config["Arch"]["max_channel"])
    fresh.load_state_dict(load_model_state_dict(str(run / "best.ckpt")), strict=True)
    print(f"fine-tune: {steps} steps + eval in {wall:.2f} s | sup_loss "
          f"{float(rows[0]['tra/sup_loss/mean']):.5f} | val loss "
          f"{float(rows[0]['val/loss/mean']):.5f} | val DSC {scores[1]:.5f} | test DSC "
          f"{float(rows[0]['test/dice/DSC_mean']):.5f} | best.ckpt reloads strictly into a "
          f"plain UNet", flush=True)
    launches = {k: pre_launches[k] + ft_launches[k] for k in {**sc.LAUNCHES, **cs.LAUNCHES}}
    _time_finetune_and_eval(ft_config, ckpt, save_dir / "timing")
    return launches, trainer


def _time_finetune_and_eval(ft_config, ckpt, save_dir):
    """Wall time per fine-tune step and per eval step (one scan) after a
    warm-up epoch, host batch and copy included: a trainer built as `val()`
    builds it, its epochs run outside the launch accounting above."""
    from spcl_torch.entry import build_trainer
    config = copy.deepcopy(ft_config)
    config["Data"]["labeled_scan_num"] = 1
    config["Arch"]["checkpoint"] = str(ckpt)
    config["Trainer"]["name"] = "ft"
    trainer = build_trainer(config, save_dir=str(save_dir), device=DEVICE)
    trainer.init()
    trainer._run_train_epoch()
    thr = trainer._run_train_epoch()[trainer.train_meter_focus]["throughput"]
    loader = trainer._val_loader
    eval_ms = _wall_ms(lambda n: [trainer._run_eval_epoch(loader) for _ in range(n)], 2)
    batches = sum(1 for _ in loader.sampler)
    print(f"fine-tune step (pallas, batch {thr['slices_per_sec'] / thr['steps_per_sec']:.0f}): "
          f"{1e3 / thr['steps_per_sec']:.3f} ms/step wall over "
          f"{config['Trainer']['num_batches']} steps | eval step: {eval_ms / batches:.3f} ms "
          f"per scan over {batches} val scans ({eval_ms:.1f} ms per eval epoch)", flush=True)


# the kernels of csrc/convstage.cu by their own names, whole, as the profiler
# demangles them ("(anonymous namespace)::poolsums_kernel<16>(...)"), so that
# PyTorch's at::native::reduce_kernel is none of them
STAGE_KERNEL_NAMES = ("conv_fwd_kernel", "conv_bwd_kernel", "conv_fwd_bf16_kernel",
                      "conv_bwd_bf16_kernel", "bnpool_kernel", "poolsums_kernel",
                      "poolsums_bf16_kernel", "dz1_kernel", "convstage_reduce_kernel")
STAGE_KERNEL_RE = re.compile(r"(?:^|[\s:])(%s)\b" % "|".join(STAGE_KERNEL_NAMES))
# launches of convstage_reduce_kernel in one train step: one after each
# forward convolution (conv, 2 x bnconv), two after each dwprev, one after
# dwdx; poolsums launches none
STAGE_REDUCES_PER_STEP = 8


def _pretrain_epochs(trainer, device_data=True):
    """run(n): one train epoch of n steps (pretrain, or slice E's semi
    trainer) through the trainer's own data path (`device_data` true: index
    rows gathered from the device store; false: host batches through
    device_prefetch); returns its ms per step, as the trainer measures it
    (synchronised, host work included)."""
    def run(n):
        trainer._device_data = device_data
        trainer._num_batches = n
        thr = trainer._run_train_epoch()[trainer.train_meter_focus]["throughput"]
        return 1e3 / thr["steps_per_sec"]
    return run


class _CountHostBatches:
    """Counts `SliceDataset.batch` calls (host batches) inside the block."""

    def __enter__(self):
        from spcl_torch.data.dataset import SliceDataset
        self._cls, self._orig, self.calls = SliceDataset, SliceDataset.batch, 0

        def counted(ds, indices):
            self.calls += 1
            return self._orig(ds, indices)
        SliceDataset.batch = counted
        return self

    def __exit__(self, *exc):
        self._cls.batch = self._orig


def _wall_ms(run, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _profiled(run, steps):
    """Device time by kernel (ms and launches per step) of run(steps) under
    torch.profiler, by the accounting `Trainer.profile_dir` uses
    (spcl_torch/utils/profiling.py::kernel_times: kernels, copies and sets,
    not the device-side ranges of user annotations)."""
    from spcl_torch.utils import profiling
    return profiling.kernel_times(run, steps)


def _print_profile(title, kernels, wall_ms, top=12):
    """Print kernel time per step, the supcon and stage kernels' shares, the
    largest kernels and every stage kernel. Returns (total, stage kernels'
    ms/step, stage kernels' launches per step by name), or None when the
    profiler recorded no device time."""
    total = sum(ms for ms, _ in kernels.values())
    if total <= 0:
        print(f"profile {title}: the profiler recorded no device time (not measured)",
              flush=True)
        return None
    supcon = sum(ms for k, (ms, _) in kernels.items() if "supcon" in k)
    stage_keys = [k for k in kernels if STAGE_KERNEL_RE.search(k)]
    stage = sum(kernels[k][0] for k in stage_keys)
    n_launches = sum(count for _, count in kernels.values())
    print(f"profile {title}: {total:.3f} ms of kernel time per step in {n_launches} kernel "
          f"launches = {100 * total / wall_ms:.1f}% of the unprofiled wall time; supcon kernels "
          f"{supcon:.4f} ms/step = {100 * supcon / total:.2f}%; stage kernels "
          f"{stage:.3f} ms/step = {100 * stage / total:.1f}% of kernel time", flush=True)
    for key, (ms, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {ms:8.3f} ms/step {100 * ms / total:5.1f}%  x{count:<4d} {key[:80]}",
              flush=True)
    launches = {}
    for key in sorted(stage_keys, key=lambda k: -kernels[k][0]):
        ms, count = kernels[key]
        name = STAGE_KERNEL_RE.search(key).group(1)
        launches[name] = launches.get(name, 0) + count
        print(f"  stage kernel {ms:8.4f} ms/step x{count:<3d} {key[:80]}", flush=True)
    return total, stage, launches


def profile_phase(trainer_a, trainer_b, steps=5, timed_steps=20):
    """More pretrain epochs of both slices after the launch counts were read,
    through the trainers' own data path: per layout, `timed_steps` steps with
    `device_data` true and false in the turns true, false, false, true (the
    trainer's own timing: synchronised, host work included), then `steps`
    steps of each under torch.profiler (kernel time by kernel, device busy
    share). No `device_data: true` epoch may build a host batch."""
    phase(f"profile: pretrain step, nhwc and pallas, device_data true beside false: "
          f"{timed_steps} timed steps x 2 turns each, then {steps} profiled steps each")
    out = {}
    for name, trainer in (("nhwc", trainer_a), ("pallas", trainer_b)):
        on, off = _pretrain_epochs(trainer, True), _pretrain_epochs(trainer, False)
        on(2)
        off(2)  # warm-up
        turns = {True: [], False: []}
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for device_data in (True, False, False, True):
            with _CountHostBatches() as counter:
                turns[device_data].append((on if device_data else off)(timed_steps))
            if device_data:
                check(counter.calls == 0, f"{name}: a device_data step built "
                                          f"{counter.calls} host batches")
            else:
                check(counter.calls == timed_steps, f"{name}: {counter.calls} host batches")
        step_bytes = torch.cuda.max_memory_allocated() - base
        print(f"{name}: the steps' memory above what was allocated before them "
              f"{step_bytes / 2**30:.3f} GiB", flush=True)
        for device_data in (True, False):
            wall = min(turns[device_data])
            label = f"{name} device_data {str(device_data).lower()}"
            print(f"steady state {label}: {wall:.3f} ms/step wall = {1e3 / wall:.2f} steps/s, "
                  f"{VIEWS * 1e3 / wall:.1f} slices/s (turns "
                  f"{', '.join(f'{t:.3f}' for t in turns[device_data])})", flush=True)
            prof = _print_profile(label, _profiled(on if device_data else off, steps), wall)
            out[f"{name}_{str(device_data).lower()}"] = {"ms": wall, "turns": turns[device_data],
                                                         "step_bytes": step_bytes}
            if prof is not None:
                total, stage, launched = prof
                out[f"{name}_{str(device_data).lower()}"].update(
                    {"kernel_ms": total, "busy": total / wall, "stage_ms": stage})
                if name == "nhwc":
                    check(stage == 0, f"the nhwc step ran stage kernels: {stage} ms/step")
                else:
                    check(launched.get("poolsums_kernel")
                          == STAGE_LAUNCHES_PER_STEP["convstage_poolsums"]
                          and launched.get("convstage_reduce_kernel") == STAGE_REDUCES_PER_STEP,
                          f"pallas step: poolsums and reduce launches per step {launched}")
        print(f"{name}: device_data true / false step time "
              f"{out[name + '_true']['ms'] / out[name + '_false']['ms']:.3f}", flush=True)
    out["nhwc_ms"], out["pallas_ms"] = out["nhwc_true"]["ms"], out["pallas_true"]["ms"]
    print("profile " + json.dumps(out), flush=True)
    out["radam"] = radam_phase(trainer_b)
    return out


class _LoopRAdam(torch.optim.Optimizer):
    """The per-parameter RAdam loop that training/optim.py's multi-tensor
    update replaced (optax semantics, the same arithmetic), kept here to time
    the two side by side."""

    def __init__(self, params, lr, weight_decay, betas=(0.9, 0.999), eps=1e-8, threshold=5.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, threshold=threshold))

    @torch.no_grad()
    def step(self):
        f32 = np.float32
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                mu, nu = state["mu"], state["nu"]
                mu.mul_(b1).add_((1 - b1) * g)
                nu.mul_(b2).add_((1 - b2) * (g * g))
                state["step"] += 1
                t = state["step"]
                ro_inf = f32(2.0 / (1.0 - b2) - 1.0)
                b2t = f32(b2) ** f32(t)
                ro = ro_inf - f32(2) * f32(t) * b2t / (f32(1) - b2t)
                mu_hat = mu / float(f32(1) - f32(b1) ** f32(t))
                if ro >= group["threshold"]:
                    nu_hat = nu / float(f32(1) - b2t)
                    r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * ro_inf
                                / ((ro_inf - f32(4)) * (ro_inf - f32(2)) * ro))
                    update = float(r) * mu_hat / (torch.sqrt(nu_hat) + group["eps"])
                else:
                    update = mu_hat
                p.add_(-group["lr"] * update)


def radam_phase(trainer, steps=50, profiled=10):
    """RAdam alone over the pretrain trainer's parameters (UNet to Conv5 and
    the projector): the multi-tensor update beside the per-parameter loop,
    wall ms per step (host clock, synchronised) in the turns foreach, loop,
    loop, foreach, and kernel launches per step under torch.profiler, past
    the rectification threshold (step > 5). The two are held equal to the
    bit after the same steps."""
    phase(f"RAdam alone: multi-tensor update beside the per-parameter loop, {steps} steps "
          "x 2 turns")
    from spcl_torch.training import RAdam
    params = [p for g in trainer._optimizer.param_groups for p in g["params"]]
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    grads = [torch.randn(p.shape, generator=gen, device=DEVICE) * 1e-3 for p in params]
    sets = {}
    for name, cls in (("foreach", RAdam), ("loop", _LoopRAdam)):
        ps = [p.detach().clone().requires_grad_(True) for p in params]
        for p, g in zip(ps, grads):
            p.grad = g.clone()
        opt = cls(ps, lr=1e-3, weight_decay=1e-5)
        sets[name] = (opt, ps)
    runs = {name: (lambda n, o=opt: [o.step() for _ in range(n)])
            for name, (opt, _) in sets.items()}
    for run in runs.values():
        run(6)  # past the threshold: the rectified branch from here on
    turns = {"foreach": [], "loop": []}
    for name in ("foreach", "loop", "loop", "foreach"):
        turns[name].append(_wall_ms(runs[name], steps))
    # on the CPU the two are equal to the bit (tests/test_torch_optim.py); on
    # the card a scalar division may take another rounding path (x * (1/s)
    # in one, x / s in the other): held to 1e-6 of the largest parameter
    new, old = ([p.detach() for p in sets[name][1]] for name in ("foreach", "loop"))
    diff = max(float((a - b).abs().max()) for a, b in zip(new, old))
    scale = max(float(p.abs().max()) for p in old)
    bits = all(torch.equal(a, b) for a, b in zip(new, old))
    print(f"after {6 + 2 * steps} steps: max |foreach - loop| {diff:.3e} (largest parameter "
          f"{scale:.3f}); equal to the bit: {bits}", flush=True)
    check(diff <= 1e-6 * scale, "the multi-tensor RAdam and the loop disagree")
    out = {"params": len(params), "max_abs_diff": diff, "bit_equal": bits}
    for name, run in runs.items():
        kernels = _profiled(run, profiled)
        launches = sum(count for _, count in kernels.values())
        out[name] = {"ms": min(turns[name]), "turns": turns[name], "launches": launches,
                     "kernel_ms": sum(ms for ms, _ in kernels.values())}
        print(f"RAdam {name}: {out[name]['ms']:.3f} ms/step wall (turns "
              f"{', '.join(f'{t:.3f}' for t in turns[name])}), {launches} kernel launches "
              f"and {out[name]['kernel_ms']:.4f} ms of kernel time per step over "
              f"{len(params)} parameters", flush=True)
    print("radam " + json.dumps(out), flush=True)
    return out


def stage_region_phase():
    """Conv1 + pool + Conv2 + pool of the UNet alone at 2N = 60, forward and
    backward, through the fused stages beside the plain modules (cuDNN
    convolution, BatchNorm, max-pool, as the `nhwc` step runs them: TF32
    convolutions on), with the skip cotangents of e1 / e2 present (whole
    UNet) and absent (encoder pretrain). CUDA events and profiler."""
    phase("stage region: Conv1 + Conv2 with pools, forward + backward, B=60, 224^2")
    from spcl_torch.experimental.packed_stage import run_conv_stage
    from spcl_torch.models import UNet
    torch.manual_seed(0)
    net = UNet(max_channel=256).to(DEVICE).train()
    x = torch.rand(VIEWS, 1, 224, 224, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    c_e1 = torch.randn(VIEWS, 16, 224, 224, generator=gen, device=DEVICE)
    c_e2 = torch.randn(VIEWS, 32, 112, 112, generator=gen, device=DEVICE)
    c_p2 = torch.randn(VIEWS, 32, 56, 56, generator=gen, device=DEVICE)

    def region(fused, skips):
        def run():
            net.zero_grad(set_to_none=True)
            if fused:
                p1, e1 = run_conv_stage(net._Conv1, x, first_conv_plain=True)
                p2, e2 = run_conv_stage(net._Conv2, p1)
                e1, e2, p2 = (t.permute(0, 3, 1, 2) for t in (e1, e2, p2))
            else:
                e1 = net._Conv1(x)
                e2 = net._Conv2(net._pool(e1))
                p2 = net._pool(e2)
            loss = (p2 * c_p2).sum()
            if skips:
                loss = loss + (e1 * c_e1).sum() + (e2 * c_e2).sum()
            loss.backward()
        return run

    out = {}
    for skips in (True, False):
        for fused in (False, True, True, False):
            name = f"{'fused' if fused else 'cudnn'}_{'skips' if skips else 'noskips'}"
            ms = _time_ms(region(fused, skips), 5)
            out[name] = min(ms, out.get(name, ms))
        for fused in (False, True):
            name = f"{'fused' if fused else 'cudnn'}_{'skips' if skips else 'noskips'}"
            kernels = _profiled(lambda n, f=fused: [region(f, skips)() for _ in range(n)], 3)
            total = sum(ms for ms, _ in kernels.values())
            # the cotangent products and sums belong to the harness, not the stages
            print(f"{name}: {out[name]:.3f} ms by CUDA events (with the harness's loss); "
                  f"{total:.3f} ms of kernel time", flush=True)
            for key, (ms, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
                print(f"  {ms:8.3f} ms x{count:<3d} {key[:90]}", flush=True)
            out[name + "_kernel"] = total
    print("stage_region " + json.dumps(out), flush=True)
    return out


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


def step_parity_phase():
    """One pretrain step of a UNet-256 to Conv5 at crop 32, 2N=12: on the
    card through the kernels, and on the CPU through the plain versions,
    from the same weights and the same augmentation/flip draws."""
    phase("step parity: card (kernels) vs CPU (plain)")
    import copy
    from spcl_torch.data.augment import ACDC_PRETRAIN, flip_params, sample_twice
    from spcl_torch.hooks import SelfPacedINFONCEHook
    from spcl_torch.models import UNet
    from spcl_torch.models.masking import set_trainable_stages, stages_from_range
    from spcl_torch.training import build_optimizer, build_pretrain_step
    import dataclasses

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(3)
    policy = dataclasses.replace(ACDC_PRETRAIN, crop=32)
    rng = np.random.default_rng(5)
    n = 6
    batch_np = {"image": rng.integers(0, 255, (n, 1, 48, 48), dtype=np.uint8),
                "partition": np.arange(n, dtype=np.int32) % 3,
                "patient": np.zeros(n, np.int32), "cycle": np.zeros(n, np.int32),
                "scan_idx": np.zeros(n, np.int32), "valid": np.ones(n, np.float32)}
    g = torch.Generator().manual_seed(11)
    draws = {"aug": sample_twice(g, n, policy, 48), "flip": flip_params(g, n)}
    base = UNet(max_channel=256)
    results = {}
    for dev in (DEVICE, "cpu"):
        model = copy.deepcopy(base).to(dev)
        set_trainable_stages(model, stages_from_range(None, "Conv5"))
        hook = SelfPacedINFONCEHook(name="sp", feature_name="Conv5", weight=0.1,
                                    mode="hard", begin_value=3, end_value=14, max_epoch=2)
        torch.manual_seed(4)
        hook.build(model, dev)
        params = [p for p in model.parameters() if p.requires_grad] + hook.parameters()
        opt = build_optimizer(params, lr=1e-4, weight_decay=1e-5)
        step = build_pretrain_step(model, [hook], opt, policy=policy, total_freedom=True,
                                   until="Conv5")
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch_np.items()}
        m = step(batch, None, {"sp": {"gamma": 14.0}}, params=_to(draws, dev))
        results[dev] = (float(m["reg_loss"]), float(m["hooks"]["sp"]["sp_weight"]),
                        torch.cat([p.detach().cpu().flatten() for p in params]))
    (lk, rk, pk), (lp, rp, pp) = results[DEVICE], results["cpu"]
    perr = float((pk - pp).abs().max())
    print(f"reg_loss card {lk:.7f} cpu {lp:.7f} | sp_weight {rk:.4f} / {rp:.4f} | "
          f"max |param diff| after one RAdam step {perr:.2e}", flush=True)
    check(abs(lk - lp) <= 1e-4 * max(1.0, abs(lp)), "step loss differs card vs CPU")
    check(abs(rk - rp) <= 1e-6, "sp_weight differs card vs CPU")
    check(perr <= 1e-5, "updated parameters differ card vs CPU")
    torch.backends.cudnn.allow_tf32 = True


def finetune_parity_phase(cs):
    """One fine-tune step of a UNet-256 under `small_c_layout="pallas"` at
    crop 32, batch 6: on the card through the stage kernels, and on the CPU
    through their plain versions, from the same weights and draws."""
    phase("fine-tune step parity under pallas: card (kernels) vs CPU (plain)")
    import dataclasses
    from spcl_torch.data.augment import ACDC_LABEL, sample_once
    from spcl_torch.models import UNet
    from spcl_torch.training import build_finetune_step, build_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(5)
    policy = dataclasses.replace(ACDC_LABEL, crop=32)
    rng = np.random.default_rng(9)
    n = 6
    batch_np = {"image": rng.integers(0, 255, (n, 1, 48, 48), dtype=np.uint8),
                "label": rng.integers(0, 4, (n, 48, 48), dtype=np.uint8),
                "valid": np.ones(n, np.float32)}
    draws = {"aug": sample_once(torch.Generator().manual_seed(13), n, policy, 48)}
    base = UNet(max_channel=256, small_c_layout="pallas")
    results = {}
    for dev in (DEVICE, "cpu"):
        model = copy.deepcopy(base).to(dev)
        params = list(model.parameters())
        opt = build_optimizer(params, lr=1e-4, weight_decay=1e-5)
        step = build_finetune_step(model, opt, num_classes=4, policy=policy)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch_np.items()}
        cs.reset_launch_counts()
        m = step(batch, None, params=_to(draws, dev))
        launched = sum(cs.LAUNCHES.values())
        check(launched == (sum(STAGE_LAUNCHES_PER_STEP.values()) if dev != "cpu" else 0),
              f"{dev}: {launched} stage kernel launches")
        stats = torch.cat([b.detach().float().cpu().flatten() for name, b in
                           model.named_buffers() if "running" in name
                           and ("_Conv1." in name or "_Conv2." in name)])
        results[dev] = (float(m["sup_loss"]), m["inter"].cpu(), stats,
                        torch.cat([p.detach().cpu().flatten() for p in params]))
    (lk, ik, sk, pk), (lp, ip, sp_, pp) = results[DEVICE], results["cpu"]
    perr = float((pk - pp).abs().max())
    serr = float((sk - sp_).abs().max())
    print(f"sup_loss card {lk:.7f} cpu {lp:.7f} | max |running stat diff| of Conv1/Conv2 "
          f"{serr:.2e} | max |param diff| after one RAdam step {perr:.2e} | max |inter diff| "
          f"{float((ik - ip).abs().max()):.0f} px", flush=True)
    check(abs(lk - lp) <= 1e-4 * max(1.0, abs(lp)), "fine-tune loss differs card vs CPU")
    check(serr <= 1e-5, "running statistics differ card vs CPU")
    check(perr <= 1e-5, "updated parameters differ card vs CPU")
    torch.backends.cudnn.allow_tf32 = True


# ------------------------------------------------------------------ strip kernels
# (2N real views, ranks, invalid tail beside the rank padding): 63 slices pad
# to 64 over 2 ranks, 30 to 32 over 4 (the pad entries are invalid), and the
# bigbatch loss (config/specific/bigbatch_pretrain.yaml) over 8
STRIP_SHAPES = ((126, 2, 0), (60, 4, 0), (3840, 8, 5))
MODE_CASES = (("none", False), ("soft", False), ("soft", True), ("hard", False),
              ("hard", True))


def _strip_inputs(n2, world, invalid_tail, gen):
    """`_inputs`, right-padded to a rank multiple as the trainers pad a
    batch: the filler repeats entry 0, label -1, valid 0."""
    z1, z2, labels, valid = _inputs(n2, gen, invalid_tail)
    pad = (-(n2 // 2)) % world
    if pad:
        z1, z2 = torch.cat([z1, z1[:1].expand(pad, -1)]), torch.cat([z2, z2[:1].expand(pad, -1)])
        labels = torch.cat([labels, labels.new_full((pad,), -1)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return z1.contiguous(), z2.contiguous(), labels, valid


def _strip_bound_ms(rows, cols):
    """`_supcon_bounds` of one strip, rows x cols at D=256. Bytes: row and
    column z read once, 3 vectors per row and column, outputs written once;
    the backward also reads 3 statistics per row and column and writes dz."""
    fwd_bytes = (rows + cols) * D * 4 + 3 * (rows + cols) * 4 + 4 * rows * 4
    bwd_bytes = (rows + cols) * D * 4 + 6 * (rows + cols) * 4 + rows * D * 4
    return _supcon_bounds(rows, cols, fwd_bytes, bwd_bytes)


def _strip_ops(strip):
    rows, cols, stats_l, stats_g = strip
    ops = (rows[0], cols[0], rows[1], cols[1], rows[2], cols[2], rows[3], cols[3])
    stats = (stats_l[0], stats_g[0], stats_l[1], stats_g[1], stats_l[2], stats_g[2])
    return ops, stats


def strip_kernel_phase(sc):
    phase("strip kernels: rows of one rank x columns of all ranks, vs plain and vs the "
          "square form")
    from spcl_torch.parallel.contrastive import naive_strip_sums
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    inv_t = 1 / 0.07
    max_err = {"supcon_fwd": 0.0, "supcon_bwd": 0.0}
    shapes, cases = {}, 0
    for n2, world, tail in STRIP_SHAPES:
        z1, z2, labels, valid = _strip_inputs(n2, world, tail, gen)
        hard_gamma, gap = _hard_gamma(sc, z1, z2, labels, valid)
        for mode, correct_grad in MODE_CASES:
            gamma = {"none": 1e9, "soft": 8.0, "hard": hard_gamma}[mode]
            w = sc.walk_strips(z1, z2, labels, valid, world, gamma=gamma, temperature=0.07,
                               weight_update=mode, correct_grad=correct_grad)
            scale = 1.0 / w["m"]
            if correct_grad and mode != "none" and float(w["ratio"]) > 0:
                scale = scale / w["ratio"]
            scale = scale.reshape(1)
            fwd_err = dz_err = 0.0
            for strip in w["strips"]:  # every rank's strip against the plain versions
                ops, stats = _strip_ops(strip)
                k = sc.fwd_stats_kernel(*ops, inv_t, gamma, mode)
                p = sc.fwd_stats_plain(*ops, inv_t, gamma, mode)
                c_safe = torch.clamp(p[1], min=1.0)
                fwd_err = max(fwd_err,
                              float((torch.log(k[0] + 1e-16) - torch.log(p[0] + 1e-16)).abs().max()),
                              float((k[1] - p[1]).abs().max()),
                              float(((k[2] - p[2]) / c_safe).abs().max()),
                              float(((k[3] - p[3]) / c_safe).abs().max()))
                dzk = sc.bwd_dz_kernel(*ops, *stats, inv_t, gamma, scale, mode)
                dzp = sc.bwd_dz_plain(*ops, *stats, inv_t, gamma, scale, mode)
                dz_err = max(dz_err, float((dzk - dzp).abs().max()))
            # the assembled strips against the square-form kernels on the whole batch
            sq = _stats_and_dz(sc, True, z1, z2, labels, valid, gamma, mode, correct_grad)
            dz_scale = float(torch.cat([sq[3], sq[4]]).abs().max())
            sq_dz_err = float(torch.cat([w["dz1"] - sq[3], w["dz2"] - sq[4]]).abs().max())
            loss_err = abs(float(w["loss"]) - float(sq[0]))
            ratio_err = abs(float(w["ratio"]) - float(sq[1]))
            rows_pad, cols_pad = w["strips"][0][0][0].shape[0], w["strips"][0][1][0].shape[0]
            # the tolerances of the square-form phase, for the same reasons
            ok = (fwd_err <= 2e-4 and dz_err <= 2e-4 * dz_scale and sq_dz_err <= 2e-4 * dz_scale
                  and loss_err <= 2e-4 * max(1.0, abs(float(sq[0]))) and ratio_err <= 1e-5)
            print(f"2N={n2:5d} R={world} strip {rows_pad}x{cols_pad} {mode:4s} "
                  f"cg={int(correct_grad)} gamma={gamma:.6g}"
                  f"{f' (gap {gap:.2e})' if mode == 'hard' else ''} loss={float(sq[0]):.6f} "
                  f"ratio={float(sq[1]):.4f} | err vs plain: stats {fwd_err:.2e} dz {dz_err:.2e}"
                  f" | vs square form: dz {sq_dz_err:.2e} (scale {dz_scale:.2e}) loss "
                  f"{loss_err:.2e} ratio {ratio_err:.2e} {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"strip kernels disagree at 2N={n2} R={world} {mode} cg={correct_grad}")
            max_err["supcon_fwd"] = max(max_err["supcon_fwd"], fwd_err)
            max_err["supcon_bwd"] = max(max_err["supcon_bwd"], dz_err)
            cases += 1

        # ---- times of rank 0's strip: kernel, plain, naive (hard, gamma 3)
        w = sc.walk_strips(z1, z2, labels, valid, world, gamma=3.0, weight_update="hard")
        ops, stats = _strip_ops(w["strips"][0])
        rows_pad, cols_pad = ops[0].shape[0], ops[1].shape[0]
        scale = (1.0 / w["m"]).reshape(1)
        fargs = (*ops, inv_t, 3.0, "hard")
        bargs = (*ops, *stats, inv_t, 3.0, scale, "hard")
        reps = 200 if n2 <= 1024 else 20
        t = _time_supcon(sc, fargs, bargs, reps)
        fk, bk = t["supcon_fwd"]["ms"], t["supcon_bwd"]["ms"]
        n_l = z1.shape[0] // world
        a = z1[:n_l].clone().requires_grad_(True)
        b = z2[:n_l].clone().requires_grad_(True)

        def naive():
            a.grad = b.grad = None
            s4 = naive_strip_sums(a, b, labels[:n_l], valid[:n_l], z1, z2, labels, valid, 0,
                                  gamma=3.0, temperature=0.07, weight_update="hard")
            (-s4[0] / s4[1]).backward()

        naive_ms = _time_ms(naive, reps)
        bound = _strip_bound_ms(rows_pad, cols_pad)
        at = f"{rows_pad}x{cols_pad}"
        shapes[at] = {name: {"at": f"2N={n2}, R={world}, strip {at}, D={D}", **t[name],
                             **bound[name]} for name in t}
        shapes[at]["naive_strip_fwd_bwd_ms"] = naive_ms
        _print_supcon_times(f"strip {at} (2N={n2}, R={world})",
                            {name: shapes[at][name] for name in t})
        print(f"time strip {at}: kernel strip forward + backward {fk + bk:.4f} ms | naive "
              f"strip forward + backward (autograd) {naive_ms:.4f} ms", flush=True)
    print(f"{cases} strip cases agree (stats tol 2e-4 abs; dz tol 2e-4 x max|dz|)", flush=True)
    print("strip_timings " + json.dumps(shapes), flush=True)
    torch.backends.cudnn.allow_tf32 = True
    return max_err, shapes


def nccl_phase(sc):
    """A process group of one rank on NCCL in this process: the row-sharded
    loss and the cross-rank BatchNorm run their collectives on CUDA tensors
    and must give the single-device results."""
    phase("NCCL, world size 1: row-sharded loss and cross-rank BatchNorm through the "
          "collectives")
    import torch.distributed as dist
    from spcl_torch.models.norm import BN_EPS, batch_norm
    from spcl_torch.parallel import mesh
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(8)
    z1, z2, labels, valid = _strip_inputs(126, 2, 0, gen)

    def loss_and_grads(fn):
        a, b = z1.clone().requires_grad_(True), z2.clone().requires_grad_(True)
        loss, ratio = fn(a, b)
        loss.backward()
        return loss.detach(), ratio, a.grad, b.grad

    kw = dict(gamma=3.0, temperature=0.07, weight_update="hard", correct_grad=True)
    ref = loss_and_grads(lambda a, b: sc.fused_self_paced_supcon(a, b, target=labels,
                                                                 valid=valid, **kw))
    x = torch.randn(8, 16, 24, 24, generator=gen, device=DEVICE) * 2 + 0.5
    dy = torch.randn(8, 16, 24, 24, generator=gen, device=DEVICE)

    def bn_run(bn):
        bn = bn.to(DEVICE).train()
        xx = x.clone().requires_grad_(True)
        y = bn(xx)
        (y * dy).sum().backward()
        return [y.detach(), xx.grad, bn.weight.grad, bn.bias.grad, bn.running_mean.clone(),
                bn.running_var.clone()]

    bn_ref = bn_run(torch.nn.BatchNorm2d(16, eps=BN_EPS, momentum=0.1))
    check(not mesh.active(), "a process group is already up")
    mesh.initialize_distributed(f"localhost:{mesh.free_port()}", 1, 0, device=DEVICE,
                                timeout_s=120.0)
    try:
        check(dist.get_backend() == "nccl" and mesh.world_size() == 1, dist.get_backend())
        sc.reset_launch_counts()
        got = loss_and_grads(lambda a, b: sc.sharded_fused_self_paced_supcon(
            a, b, labels, valid, **kw))
        torch.cuda.synchronize()
        check(sc.LAUNCHES == {"supcon_fwd": 1, "supcon_bwd": 1}, dict(sc.LAUNCHES))
        bn_got = bn_run(batch_norm(16))
        mesh.host_barrier()
    finally:
        mesh.shutdown()
    dz_scale = float(torch.cat([ref[2], ref[3]]).abs().max())
    dz_err = float(torch.cat([got[2] - ref[2], got[3] - ref[3]]).abs().max())
    print(f"row-sharded loss over NCCL {float(got[0]):.6f} (single device {float(ref[0]):.6f})"
          f" ratio {float(got[1]):.4f} / {float(ref[1]):.4f} | dz err {dz_err:.2e} (scale "
          f"{dz_scale:.2e})", flush=True)
    check(abs(float(got[0]) - float(ref[0])) <= 2e-4 * max(1.0, abs(float(ref[0]))),
          "row-sharded loss over NCCL differs")
    check(abs(float(got[1]) - float(ref[1])) <= 1e-5 and dz_err <= 2e-4 * dz_scale,
          "row-sharded ratio or dz over NCCL differs")
    # one-pass E[x^2] - mean^2 statistics against cuDNN's: float32 rounding
    names = ("y", "dx", "dweight", "dbias", "running_mean", "running_var")
    errs = []
    for name, g, r in zip(names, bn_got, bn_ref):
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        errs.append(f"{name} {err:.1e}/{scale:.1e}")
        check(err <= 1e-4 * scale, f"cross-rank BatchNorm over NCCL: {name} {err} of {scale}")
    print("cross-rank BatchNorm over NCCL vs nn.BatchNorm2d (abs err / max|ref|, tol 1e-4): "
          + " | ".join(errs), flush=True)
    torch.backends.cudnn.allow_tf32 = True


# ------------------------------------------------------------------ slice C
RANKS_C = 2
SLICE_C_TIMED_STEPS = 10


def _config_c(global_contrast):
    """base.yaml + pretrain.yaml + specific/production_pretrain.yaml, with
    Data.synthetic (24 scans) and the depth cut to 1 x 5; the callers set
    Trainer.mesh and hand `build_trainer` the run directory."""
    config = copy.deepcopy(CONFIG)
    config["Data"]["synthetic_scans"] = 24
    config["ContrastiveLoaderParams"]["scan_sample_num"] = 21
    config["SPInfonceParams"]["global_contrast"] = global_contrast
    return config


class _PaddedSampler:
    """The index batches of `base`, right-padded with -1 to a multiple: hands
    the single process the very batches a mesh run pads for its ranks."""

    def __init__(self, base, multiple):
        self._base, self._multiple = base, multiple

    def __iter__(self):
        from spcl_torch.parallel.mesh import pad_multiple
        for idx in self._base:
            yield pad_multiple(np.asarray(idx), self._multiple)


def _conv5(trainer):
    return trainer.model._Conv5.conv[0].weight


def _pretrain_c(sc, config, save_dir, mesh_ranks, recorder):
    """5 pretrain steps of slice C's configuration in this process (one rank
    of a mesh run, or the single process on the same padded batches)."""
    from spcl_torch.data.loader import HostLoader
    from spcl_torch.entry import build_trainer
    from spcl_torch.utils import fix_all_seed
    config = copy.deepcopy(config)
    config["Trainer"]["mesh"] = mesh_ranks
    fix_all_seed(config["RandomSeed"])
    trainer = build_trainer(config, save_dir=save_dir, pretrain=True, device=DEVICE)
    check(trainer._forward_until == "Conv5", trainer._forward_until)
    if not mesh_ranks:
        loader = trainer._contrastive_loader
        trainer._contrastive_loader = HostLoader(loader.dataset,
                                                 _PaddedSampler(loader.sampler, RANKS_C))
    trainer.init()
    before = _conv5(trainer).detach().cpu().clone()
    trainable = [p for p in trainer.model.parameters() if p.requires_grad]
    before_all = [p.detach().clone() for p in trainable]
    sc.reset_launch_counts()
    recorder.clear()
    trainer.start_training()
    torch.cuda.synchronize()
    name = "spinfonce/Conv5/partition"
    return trainer, {
        "params_moved": sum(int(not torch.equal(a, p)) for a, p in zip(before_all, trainable)),
        "params": len(trainable),
        "n_shards": trainer.n_shards, "launches": dict(sc.LAUNCHES), "shapes": list(recorder),
        "reg_loss": [m["reg_loss"] for m in trainer.step_metrics],
        "sp_weight": [m["hooks"][name]["sp_weight"] for m in trainer.step_metrics],
        "conv5_before": before.numpy(),
        "conv5": _conv5(trainer).detach().cpu().numpy().copy(),
        "conv5_grad": _conv5(trainer).grad.detach().cpu().numpy().copy(),
        "files": sorted(str(f.relative_to(save_dir)) for f in Path(save_dir).rglob("*")
                        if f.is_file()) if Path(save_dir).is_dir() else []}


def _record_launch_shapes(sc):
    """Wrap the two kernel launchers of this process so that every launch
    notes (kernel, rows, columns); returns the list they append to."""
    seen = []
    fwd, bwd = sc.fwd_stats_kernel, sc.bwd_dz_kernel

    def fwd_rec(zr, zc, *rest):
        seen.append(("supcon_fwd", zr.shape[0], zc.shape[0]))
        return fwd(zr, zc, *rest)

    def bwd_rec(zr, zc, *rest):
        seen.append(("supcon_bwd", zr.shape[0], zc.shape[0]))
        return bwd(zr, zc, *rest)

    sc.fwd_stats_kernel, sc.bwd_dz_kernel = fwd_rec, bwd_rec
    return seen


def _timed_pretrain_steps(trainer, steps):
    """ms per pretrain step, steady state, through the trainer's own data
    path (host work included)."""
    from spcl_torch.parallel import mesh
    run = _pretrain_epochs(trainer)
    run(2)
    mesh.host_barrier()
    return run(steps)


def slice_c_rank(root, base_dir, device, base_config):
    """One rank of slice C (runs in a spawned process, which is handed the
    parent's device and base configuration)."""
    global DEVICE, CONFIG
    DEVICE, CONFIG = device, base_config
    sys.path.insert(0, root)
    import torch.distributed as dist
    from spcl_torch.entry import val
    from spcl_torch.ops import supcon_cuda as sc
    from spcl_torch.parallel import mesh
    recorder = _record_launch_shapes(sc)
    my_dir = str(Path(base_dir) / f"rank{mesh.rank()}")
    out = {"backend": dist.get_backend(), "rank": mesh.rank()}
    trainer, out["row_sharded"] = _pretrain_c(
        sc, _config_c("row_sharded"), str(Path(my_dir) / "pre"), RANKS_C, recorder)
    out["device"] = str(trainer._device)
    # phase 2 under the mesh, warm-started from what rank 0 wrote
    ft_config = _config_c("row_sharded")
    ft_config["Trainer"]["mesh"] = RANKS_C
    del ft_config["Trainer"]["name"]
    sc.reset_launch_counts()
    out["scores"] = val(base_config=ft_config,
                        pretrained_checkpoint=str(Path(base_dir) / "rank0" / "pre" / "last.ckpt"),
                        save_dir=my_dir, labeled_ratios=[1], device=DEVICE)
    out["val_launches"] = dict(sc.LAUNCHES)
    out["files"] = sorted(str(f.relative_to(my_dir)) for f in Path(my_dir).rglob("*")
                          if f.is_file()) if Path(my_dir).is_dir() else []
    _, out["replicated"] = _pretrain_c(
        sc, _config_c("replicated"), str(Path(my_dir) / "pre_replicated"), RANKS_C,
        recorder)
    gc_config = _config_c("row_sharded")
    gc_config["Trainer"]["grad_cache"] = 2  # 32 slices a rank: 2 chunks of 16
    _, out["grad_cache"] = _pretrain_c(sc, gc_config, str(Path(my_dir) / "pre_grad_cache"),
                                       RANKS_C, recorder)
    out["ms_per_step"] = _timed_pretrain_steps(trainer, SLICE_C_TIMED_STEPS)
    return out


def slice_c_phase(sc):
    phase(f"slice C: Trainer.mesh={RANKS_C}, production configuration (UNet-256, 224^2, "
          "2N=126, row_sharded), pretrain then val() under the mesh")
    from spcl_torch.models import UNet
    from spcl_torch.parallel.mesh import spawn_local
    from spcl_torch.training import load_model_state_dict
    base_dir = ROOT / "runs" / "chip_smoke_c"
    shutil.rmtree(base_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    print(f"{cards} card(s): " + (
        "one rank per card, collectives over NCCL" if cards >= RANKS_C else
        "both ranks compute on this card; collectives over gloo, staged through host "
        "memory (for the collectives only)"), flush=True)
    t0 = time.perf_counter()
    ranks = spawn_local(RANKS_C, slice_c_rank, (str(ROOT), str(base_dir), DEVICE, CONFIG),
                        device=DEVICE,
                        timeout_s=600.0, collective_timeout_s=300.0)
    print(f"two ranks done in {time.perf_counter() - t0:.1f} s (process start, CUDA context and "
          f"warm-up included); backend {ranks[0]['backend']}, devices "
          f"{[r['device'] for r in ranks]}", flush=True)
    check(ranks[0]["backend"] == ("nccl" if cards >= RANKS_C else "gloo"), ranks[0]["backend"])
    check(all(r["device"].startswith(DEVICE) for r in ranks), f"a rank computed off {DEVICE}")

    # ---- the single process on the same padded batches (63 slices + 1 invalid = 64)
    recorder = _record_launch_shapes(sc)
    trainer, one = _pretrain_c(sc, _config_c("row_sharded"),
                               str(base_dir / "single"), 0, recorder)
    steps = CONFIG["Trainer"]["max_epoch"] * CONFIG["Trainer"]["num_batches"]
    # the single process replays its step as a CUDA graph: the launchers run at
    # a layout's first step and at each capture, and every replay launches what
    # its capture recorded (counted in LAUNCHES)
    check(one["n_shards"] == 1
          and set(one["shapes"]) == {("supcon_fwd", 128, 128), ("supcon_bwd", 128, 128)}
          and one["launches"] == {"supcon_fwd": steps, "supcon_bwd": steps},
          f"single process: {one['shapes']}, launches {one['launches']}")

    # ---- launches: per rank and step one forward and one dz launch at 64 x 128
    for r in ranks:
        rs, rp = r["row_sharded"], r["replicated"]
        print(f"rank {r['rank']} on {r['device']}: row_sharded launches {rs['launches']} "
              f"shapes {sorted(set(rs['shapes']))} | val() launches {r['val_launches']} | "
              f"replicated launches {rp['launches']} shapes {sorted(set(rp['shapes']))}",
              flush=True)
        check(rs["n_shards"] == RANKS_C and rp["n_shards"] == RANKS_C, "not a mesh run")
        check(rs["launches"] == {"supcon_fwd": steps, "supcon_bwd": steps}, rs["launches"])
        check(rs["shapes"] == [("supcon_fwd", 64, 128), ("supcon_bwd", 64, 128)] * steps,
              f"row_sharded strip operands: {rs['shapes']}")
        check(rp["shapes"] == [("supcon_fwd", 128, 128), ("supcon_bwd", 128, 128)] * steps,
              f"replicated operands: {rp['shapes']}")
        check(r["val_launches"] == {"supcon_fwd": 0, "supcon_bwd": 0}, r["val_launches"])
        check(list(r["scores"]) == [1] and 0.0 <= r["scores"][1] <= 1.0, r["scores"])
    check(ranks[0]["scores"] == ranks[1]["scores"], "the ranks' DSC differ")
    for r in ranks:  # Trainer.grad_cache=2 under the mesh: chunks of the rank's rows
        gc = r["grad_cache"]
        print(f"rank {r['rank']} grad_cache=2: reg_loss "
              f"{', '.join(f'{v:.6f}' for v in gc['reg_loss'])} | launches {gc['launches']} | "
              f"{gc['params_moved']} of {gc['params']} trainable tensors moved", flush=True)
        check(all(math.isfinite(v) for v in gc["reg_loss"]), "grad_cache: non-finite loss")
        # at lr 1e-7 a step moves a weight of O(0.1) by less than its last bit;
        # the BatchNorm shifts near 0 move
        grad = float(np.linalg.norm(gc["conv5_grad"]))
        check(gc["params_moved"] > 0 and math.isfinite(grad) and grad > 0,
              f"grad_cache: parameters did not move (Conv5 gradient norm {grad})")
        check(gc["shapes"] == [("supcon_fwd", 64, 128), ("supcon_bwd", 64, 128)] * steps,
              f"grad_cache strip operands: {gc['shapes']}")
    check(ranks[0]["grad_cache"]["reg_loss"] == ranks[1]["grad_cache"]["reg_loss"]
          and np.array_equal(ranks[0]["grad_cache"]["conv5"], ranks[1]["grad_cache"]["conv5"]),
          "grad_cache: the ranks' losses or Conv5 weights differ")

    # ---- agreement. Tolerance: the ranks convolve 64 rows each and the single
    # process 128, so cuDNN may pick other TF32 algorithms (TF32 keeps ~3
    # digits) and the BatchNorm sums run in another order; z enters the loss
    # as s = z.z / 0.07, and hard weights are thresholds that may flip (one
    # pair of the 2N=126 batch moves sp_weight by 4e-4). First measured on an
    # H100: 1e-5, 1e-10 and 3e-3.
    tol = {"reg_loss": 1e-3, "sp_weight": 5e-3, "grad": 5e-2}
    for key in ("reg_loss", "sp_weight"):  # the replicas agree to the bit
        for run in ("row_sharded", "replicated"):
            check(ranks[0][run][key] == ranks[1][run][key], f"ranks differ in {run} {key}")
    check(np.array_equal(ranks[0]["row_sharded"]["conv5"], ranks[1]["row_sharded"]["conv5"]),
          "the replicas' Conv5 weights drifted apart")

    def compare(name, a, b):
        reg = max(abs(x - y) / abs(y) for x, y in zip(a["reg_loss"], b["reg_loss"]))
        spw = max(abs(x - y) for x, y in zip(a["sp_weight"], b["sp_weight"]))
        grad = float(np.linalg.norm(a["conv5_grad"] - b["conv5_grad"])
                     / np.linalg.norm(b["conv5_grad"]))
        moved = float(np.abs(b["conv5"] - b["conv5_before"]).max())
        weights = float(np.abs(a["conv5"] - b["conv5"]).max())
        print(f"{name}: max rel diff reg_loss {reg:.2e} (tol {tol['reg_loss']}) | max abs diff "
              f"sp_weight {spw:.2e} (tol {tol['sp_weight']}) | last step's Conv5 gradient rel "
              f"L2 {grad:.2e} (tol {tol['grad']}) | Conv5 weights max abs diff {weights:.2e} "
              f"(they moved by {moved:.2e} in {steps} steps at lr 1e-7)", flush=True)
        check(all(math.isfinite(v) for v in a["reg_loss"] + b["reg_loss"]), "non-finite loss")
        check(reg <= tol["reg_loss"] and spw <= tol["sp_weight"] and grad <= tol["grad"],
              f"{name} disagree")
        check(weights <= max(2.0 * moved, 1e-7), f"{name}: Conv5 weights differ by {weights}")

    for step in range(steps):
        print(f"step {step}: reg_loss 2 ranks row_sharded "
              f"{ranks[0]['row_sharded']['reg_loss'][step]:.6f} | replicated "
              f"{ranks[0]['replicated']['reg_loss'][step]:.6f} | single process "
              f"{one['reg_loss'][step]:.6f} || sp_weight "
              f"{ranks[0]['row_sharded']['sp_weight'][step]:.4f} | "
              f"{ranks[0]['replicated']['sp_weight'][step]:.4f} | {one['sp_weight'][step]:.4f}",
              flush=True)
    compare("2 ranks row_sharded vs single process", ranks[0]["row_sharded"], one)
    compare("2 ranks row_sharded vs 2 ranks replicated", ranks[0]["row_sharded"],
            ranks[0]["replicated"])

    # ---- files: rank 0 wrote, the others did not; last.ckpt reloads strictly here
    print(f"files of rank 0: {ranks[0]['files']} | of rank 1: {ranks[1]['files']}", flush=True)
    check(ranks[1]["files"] == [], f"rank 1 wrote {ranks[1]['files']}")
    for f in ("pre/.success", "pre/last.ckpt", "tra_1/.success", "tra_1/best.ckpt",
              "tra_1/last.ckpt", "tra_1/storage.csv"):
        check(f in ranks[0]["files"], f"rank 0 did not write {f}")
    fresh = UNet(input_dim=1, num_classes=4, max_channel=CONFIG["Arch"]["max_channel"])
    fresh.load_state_dict(load_model_state_dict(str(base_dir / "rank0" / "pre" / "last.ckpt")),
                          strict=True)
    fresh.load_state_dict(load_model_state_dict(str(base_dir / "rank0" / "tra_1" / "best.ckpt")),
                          strict=True)

    # ---- step time, 2 ranks beside the single process (same global batch of 64 + 64 views)
    single_ms = _timed_pretrain_steps(trainer, SLICE_C_TIMED_STEPS)
    mesh_ms = max(r["ms_per_step"] for r in ranks)
    views = 2 * 63
    shared = cards < RANKS_C
    print(f"slice C step, {SLICE_C_TIMED_STEPS} timed steps: {RANKS_C} ranks over "
          f"{ranks[0]['backend']} {mesh_ms:.3f} ms/step = {1e3 / mesh_ms:.3f} steps/s, "
          f"{views * 1e3 / mesh_ms:.1f} slices/s | single process {single_ms:.3f} ms/step = "
          f"{1e3 / single_ms:.3f} steps/s, {views * 1e3 / single_ms:.1f} slices/s"
          + (" | both ranks share ONE card and stage their collectives through the host: "
             "this is no speed-up figure" if shared else ""), flush=True)
    print(f"fine-tune under the mesh: val DSC {ranks[0]['scores'][1]:.5f}; last.ckpt and "
          f"best.ckpt of rank 0 reload strictly", flush=True)
    launches = {k: sum(ranks[0][run]["launches"][k]
                       for run in ("row_sharded", "replicated", "grad_cache"))
                for k in sc.LAUNCHES}
    return launches, {"mesh_ms": mesh_ms, "single_ms": single_ms,
                      "backend": ranks[0]["backend"], "shared_card": shared}


# ------------------------------------------------------------------ slice D
# 160 scans x 3 ACDC partitions x 4 slices = 1920 slices, 2N = 3840 views. A
# scan of 12 slices has only 3 in its last partition (cut 4: 4 + 5 + 3), so
# the sampler would skip that partition: every scan gets 13 to 16
BIGBATCH_SCANS = 160
BIGBATCH_SLICES = (13, 16)
BIGBATCH_VIEWS = 3840


def _config_d():
    """base.yaml + pretrain.yaml + specific/bigbatch_pretrain.yaml, cut in
    depth to 1 epoch of 3 steps (1 warm-up + 2 timed)."""
    config = copy.deepcopy(CONFIG)
    config["Trainer"].update(num_batches=3, max_epoch=1, grad_cache=30,
                             save_dir="runs/chip_smoke_d")
    config["ContrastiveLoaderParams"] = {"scan_sample_num": BIGBATCH_SCANS,
                                         "partition_sample_num": 4}
    config["SPInfonceParams"]["global_contrast"] = "row_sharded"
    return config


class _Datasets:
    """`build_trainer` loads these (train, test) datasets in place of the
    config's synthetic ones inside the block."""

    def __init__(self, tra, test):
        self._data = (tra, test)

    def __enter__(self):
        from spcl_torch.entry import common
        self._orig = common.load_datasets_from_config
        common.load_datasets_from_config = lambda config: self._data

    def __exit__(self, *exc):
        from spcl_torch.entry import common
        common.load_datasets_from_config = self._orig


def slice_d_phase(sc):
    phase(f"slice D: bigbatch_pretrain.yaml, UNet-256, 224^2, 2N={BIGBATCH_VIEWS}, grad_cache "
          "30 (30 chunks of 128 views), device_data, nhwc, 1 warm-up + 2 timed steps")
    from spcl_torch.data import synthetic_dataset
    from spcl_torch.entry import build_trainer
    from spcl_torch.models import UNet
    from spcl_torch.training import load_model_state_dict
    t_phase = time.perf_counter()
    tra = synthetic_dataset("acdc", num_scans=BIGBATCH_SCANS, slices_per_scan=BIGBATCH_SLICES,
                            canvas=CONFIG["Data"]["canvas"], seed=0)
    test = synthetic_dataset("acdc", num_scans=4, canvas=CONFIG["Data"]["canvas"], seed=1,
                             mode="val")
    data_s = time.perf_counter() - t_phase
    config = _config_d()
    save_dir = ROOT / config["Trainer"]["save_dir"]
    shutil.rmtree(save_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live_before = torch.cuda.memory_allocated()  # what earlier phases still hold
    with _Datasets(tra, test):
        trainer = build_trainer(config, save_dir=str(save_dir), pretrain=True, device=DEVICE)
    check(trainer._forward_until == "Conv5" and trainer.model.small_c_layout == "nhwc",
          "slice D: not the nhwc encoder pretrain")
    trainer.init()
    store = trainer._store(trainer._contrastive_loader)
    check(trainer._train_step.num_chunks == 30, "slice D: not the gradient-cache step")

    times, views, indexed = [], [], []
    step = trainer._train_step

    def timed_step(batch, *args, **kwargs):  # synchronised: one step takes seconds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(batch, *args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        indexed.append(torch.is_tensor(batch))
        views.append(2 * int((batch >= 0).sum()) if torch.is_tensor(batch) else -1)
        return out

    trainer._train_step = timed_step
    kernels = sc.fwd_stats_kernel, sc.bwd_dz_kernel
    recorder = _record_launch_shapes(sc)
    steps = config["Trainer"]["num_batches"]
    sc.reset_launch_counts()
    t0 = time.perf_counter()
    with _CountHostBatches() as counter:
        trainer.start_training()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sc.LAUNCHES)
    sc.fwd_stats_kernel, sc.bwd_dz_kernel = kernels
    trainer._train_step = step
    peak = torch.cuda.max_memory_allocated()
    print(f"launches in {steps} steps: {launches}; operands {sorted(set(recorder))}", flush=True)
    check(launches == {"supcon_fwd": steps, "supcon_bwd": steps},
          f"expected one forward and one dz launch per step, got {launches}")
    check(recorder == [("supcon_fwd", BIGBATCH_VIEWS, BIGBATCH_VIEWS),
                       ("supcon_bwd", BIGBATCH_VIEWS, BIGBATCH_VIEWS)] * steps,
          f"supcon operands: {recorder}")
    check(all(indexed) and counter.calls == 0,
          f"slice D built {counter.calls} host batches (steps fed an index: {indexed})")
    check(views == [BIGBATCH_VIEWS] * steps, f"valid views per step {views}")
    check(len(trainer.step_metrics) == steps, len(trainer.step_metrics))
    for rec in trainer.step_metrics:
        hm = rec["hooks"]["spinfonce/Conv5/partition"]
        check(math.isfinite(rec["reg_loss"]) and 0.0 <= hm["sp_weight"] <= 1.0, rec)
        check(abs(hm["age_param"] - 3.0) < 1e-6, rec)  # gamma 3 -> 14 starts at 3
        print(f"reg_loss {rec['reg_loss']:.6f} sp_weight {hm['sp_weight']:.4f} "
              f"gamma {hm['age_param']:.1f}", flush=True)
    ckpt = save_dir / "last.ckpt"
    check(ckpt.exists(), f"{ckpt} missing")
    UNet(input_dim=1, num_classes=4, max_channel=CONFIG["Arch"]["max_channel"]).load_state_dict(
        load_model_state_dict(str(ckpt)), strict=True)
    ms = 1e3 * sum(times[1:]) / len(times[1:])
    out = {"ms": ms, "warmup_ms": 1e3 * times[0], "step_ms": [1e3 * t for t in times],
           "views": views[0], "peak_bytes": peak, "live_before_bytes": live_before,
           "store_bytes": store.nbytes(), "slices": len(tra), "launches": launches,
           "data_s": data_s}
    print(f"slice D: {views[0]} valid views a step ({views[0] // 2} slices of {len(tra)} in the "
          f"store); "
          f"{ms:.1f} ms/step over {steps - 1} timed steps (warm-up step {1e3 * times[0]:.1f} "
          f"ms) = {1e3 / ms:.3f} steps/s, {views[0] * 1e3 / ms:.1f} slices/s | peak memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated; "
          f"{live_before / 2**30:.2f} GiB of it held by earlier phases) | store "
          f"{store.nbytes() / 2**20:.1f} MiB | 0 host batches | last.ckpt reloads strictly",
          flush=True)
    kernels = _profiled(_pretrain_epochs(trainer), 1)  # one more step, after last.ckpt
    kernel_ms = sum(v for v, _ in kernels.values())
    supcon = {k: v for k, v in kernels.items() if "supcon" in k}
    out.update(kernel_ms=kernel_ms, busy=kernel_ms / ms if kernel_ms else None)
    print(f"slice D step under torch.profiler: {kernel_ms:.1f} ms of kernel time = "
          f"{100 * kernel_ms / ms:.1f}% of the unprofiled step; supcon kernels "
          f"{', '.join(f'{k[:40]} {v:.4f} ms x{c}' for k, (v, c) in supcon.items())}",
          flush=True)
    out["equivalence"] = gradcache_equivalence_phase(trainer)
    del trainer, store
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"slice D took {out['phase_s']:.1f} s of this script (dataset {data_s:.1f} s, "
          f"{steps} steps {wall:.1f} s, the equivalence check included)", flush=True)
    print("slice_d " + json.dumps({k: v for k, v in out.items() if k != "launches"}),
          flush=True)
    return out


GRADCACHE_CHECK_SLICES = 120  # 2N = 240 views in 4 chunks of 60


def gradcache_equivalence_phase(trainer):
    """The cached gradient against direct autograd through the same chunked
    computation (`direct_value_and_grad`) on the card, from slice D's
    weights, store and hooks at 2N=240 in 4 chunks (gamma 14), with the same
    draws and the trainer's own settings (cuDNN TF32 convolutions). Both run the same
    convolutions on the same inputs; what differs is the order in which the
    chunks' gradients are added (and cuDNN's own reductions). Tolerance:
    loss and sp_weight rtol 1e-5, every gradient relative L2 1e-4."""
    phase(f"grad_cache equivalence on the card: cached vs direct, 2N="
          f"{2 * GRADCACHE_CHECK_SLICES}, 4 chunks")
    from spcl_torch.training import build_gradcache_pretrain_step
    from spcl_torch.training.steps import draw_pretrain_params
    store = trainer._store(trainer._contrastive_loader)
    step = build_gradcache_pretrain_step(
        trainer.model, trainer.hooks, trainer._optimizer, policy=trainer.train_policy,
        total_freedom=True, until=trainer._forward_until, num_chunks=4, store=store)
    idx = torch.arange(GRADCACHE_CHECK_SLICES, device=DEVICE)
    params = draw_pretrain_params(torch.Generator(device=DEVICE).manual_seed(5), idx, store,
                                  policy=trainer.train_policy, total_freedom=True)
    # at the ramp's start (gamma 3) hard weights drop every pair of the batch
    # (each pair's loss is near log(2N - 1) > 3): loss and gradient are 0.
    # Held at its end value, 14, where every pair counts
    gamma = CONFIG["SPInfonceParams"]["end_values"]
    scalars = {h.name: {"gamma": float(gamma)} for h in trainer.hooks}
    direct = step.direct_value_and_grad(idx, None, scalars, params=params)
    cached = step.cached_value_and_grad(idx, None, scalars, params=params)
    name = "spinfonce/Conv5/partition"
    check(float(direct["loss"]) > 0, f"gamma {gamma}: the loss is {float(direct['loss'])}")
    loss = abs(float(cached["loss"]) - float(direct["loss"])) / abs(float(direct["loss"]))
    ratio = abs(float(cached["hooks"][name]["sp_weight"]) - float(direct["hooks"][name]["sp_weight"]))
    rel = [float((c - d).norm() / d.norm()) for c, d in zip(cached["grads"], direct["grads"])
           if d is not None and float(d.norm()) > 0]
    stats = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(cached["buffers"], direct["buffers"]))
    print(f"loss {float(cached['loss']):.7f} vs {float(direct['loss']):.7f} (rel {loss:.2e}) | "
          f"sp_weight diff {ratio:.2e} | gradients rel L2: max {max(rel):.2e}, median "
          f"{sorted(rel)[len(rel) // 2]:.2e} over {len(rel)} tensors | running statistics max "
          f"|diff| {stats:.2e}", flush=True)
    check(len(rel) == len(cached["grads"]), "a parameter got no gradient")
    check(loss <= 1e-5 and ratio <= 1e-5 and max(rel) <= 1e-4,
          "grad_cache: cached and direct gradients disagree on the card")
    return {"loss_rel": loss, "sp_weight_abs": ratio, "grad_rel_max": max(rel),
            "stats_abs_max": stats}


# ------------------------------------------------------------------ slice E
# The semi-supervised path of main.py. The GPU machine has no pyyaml, so the
# config files are transcribed here (tests/test_torch_semi_trainer.py holds
# each dict to its file) and merged as spcl_torch.main merges them; the runs
# go through spcl_torch.main.run, which main() calls with the parsed config.
BASE_YAML = {
    "RandomSeed": 10, "trainer_checkpoint": None,
    "Arch": {"input_dim": 1, "num_classes": 4, "checkpoint": None, "max_channel": 256,
             "momentum": 0.1, "dtype": "float32", "small_c_layout": "nhwc"},
    "Optim": {"name": "RAdam", "lr": 1e-07, "weight_decay": 1e-05},
    "Scheduler": {"multiplier": 300, "warmup_max": 10},
    "Data": {"name": "acdc", "labeled_scan_num": 1, "canvas": 256, "crop": 224,
             "synthetic": False, "synthetic_scans": 20, "synthetic_test_scans": 8,
             "root": None, "ratios": None},
    "LabeledLoader": {"batch_size": 5}, "UnlabeledLoader": {"batch_size": 5},
    "Trainer": {"save_dir": "tmp", "num_batches": 200, "max_epoch": 75, "two_stage": False,
                "disable_bn": False, "name": None, "profile_dir": None, "save_every": 1,
                "device_data": True, "defer_reads": False, "mesh": 0, "packed_eval": 0,
                "grad_cache": 0, "reg_weight": 0.01, "dis_consider_image": False},
}
CONFIG_FILES = {
    "base.yaml": BASE_YAML,
    "specific/production_semi.yaml": {
        "Trainer": {"name": "semi", "num_batches": 31, "packed_eval": 96},
        "LabeledLoader": {"batch_size": 32}, "UnlabeledLoader": {"batch_size": 32}},
    "specific/mt.yaml": {"MeanTeacherParams": {"weight": 10, "alpha": 0.999}},
    "specific/uda.yaml": {"ConsistencyParams": {"weight": 5.0}},
    "hooks/mixup.yaml": {"MixUpParams": {"weight": 0.01, "enable_bn": True}},
    "pretrain.yaml": {
        "Trainer": {"num_batches": 200, "max_epoch": 75},
        "Optim": {"name": "RAdam", "lr": 1e-07, "weight_decay": 1e-05},
        "Scheduler": {"multiplier": 400, "warmup_max": 10},
        "ContrastiveLoaderParams": {"scan_sample_num": 10, "partition_sample_num": 1}},
    "hooks/infonce_dense.yaml": {
        "InfonceParams": {"feature_names": "Up_conv3", "weights": 1.0, "contrast_ons": "self"},
        "ContrastiveLoaderParams": {"scan_sample_num": 3, "partition_sample_num": 1}},
    "hooks/spinfonce.yaml": {
        "SPInfonceParams": {"feature_names": "Conv5", "weights": 1, "contrast_ons": "partition",
                            "begin_values": 10000, "end_values": 10000, "mode": "soft",
                            "p": 0.5, "correct_grad": True}},
    "hooks/adv.yaml": {"Trainer": {"reg_weight": 0.01}},
}
SEMI_FILES = ("base.yaml", "specific/production_semi.yaml", "specific/mt.yaml",
              "specific/uda.yaml")
SEMI_STEPS = 6              # 1 warm-up + 5 timed, one epoch
SEMI_PROFILED_STEPS = 3
PRESET_STEPS = 2
# the stage kernels of the EMA teacher's forward (train mode, statistics
# frozen) in one semi step; the student's forward and backward launch
# STAGE_LAUNCHES_PER_STEP
TEACHER_LAUNCHES_PER_STEP = {"convstage_conv": 1, "convstage_bnconv": 2,
                             "convstage_bnpool": 2}


def _merged(*files, **cuts):
    """The config files merged in order (as ConfigManager merges them), then
    `cuts`: {block: {key: value}} overrides."""
    from spcl_torch.configure.dictionary_utils import dictionary_merge_by_hierachy
    config = {}
    for f in files:
        config = dictionary_merge_by_hierachy(config, copy.deepcopy(CONFIG_FILES[f]))
    return dictionary_merge_by_hierachy(config, cuts)


class _Recorder:
    """Instruments the runs inside the block: the trainers `init()` made,
    with a CUDA event after each of their train steps; the stage kernels
    launched inside the EMA teacher's forwards, and the first EMA update
    held to 0.5 t0 + 0.5 s1 (alpha of step 0); `resume_from_path` handed,
    with the checkpoint it read, to `on_resume`, whose result is kept in
    `resumed`. Given the supcon module `sc` too, also for each call of a
    trainer's `start_training` the kernels it launched and the UNet's
    parameters (and the adversarial trainer's discriminator's) before and
    after it, in `runs`."""

    def __init__(self, cs, sc=None, on_resume=None):
        self.cs, self.sc, self.on_resume = cs, sc, on_resume

    @staticmethod
    def _snapshot(trainer):
        out = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
        d = getattr(trainer, "_discriminator", None)
        if d is not None:
            out.update({f"discriminator.{k}": p.detach().clone()
                        for k, p in d.named_parameters()})
        return out

    def __enter__(self):
        from spcl_torch.models.ema import EMATeacher
        from spcl_torch.training import load_checkpoint
        from spcl_torch.training.trainer import (FineTuneTrainer, PretrainEncoderTrainer,
                                                 _TrainerBase)
        self.trainers, self.events, self.runs = [], [], []
        self.first_update, self.resumed = None, None
        self.teacher_launches = {k: 0 for k in self.cs.LAUNCHES}
        rec = self

        def init(orig):
            def wrapped(trainer):
                orig(trainer)
                rec.trainers.append(trainer)
                step = trainer._train_step

                def timed(*args, **kwargs):
                    out = step(*args, **kwargs)
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    rec.events.append(ev)
                    return out
                trainer._train_step = timed
            return wrapped

        def start(orig):
            def wrapped(trainer):
                rec.sc.reset_launch_counts()
                rec.cs.reset_launch_counts()
                before = rec._snapshot(trainer)
                first = len(rec.events)
                out = orig(trainer)
                torch.cuda.synchronize()
                rec.runs.append({"trainer": trainer, "before": before,
                                 "after": rec._snapshot(trainer),
                                 "launches": {**rec.sc.LAUNCHES, **rec.cs.LAUNCHES},
                                 "events": rec.events[first:]})
                return out
            return wrapped

        def resume(orig):
            def wrapped(trainer, path):
                orig(trainer, path)
                if rec.on_resume is not None:
                    rec.resumed = rec.on_resume(trainer, load_checkpoint(path))
            return wrapped

        def logits(orig):
            def wrapped(teacher, images):
                before = dict(rec.cs.LAUNCHES)
                out = orig(teacher, images)
                for k in rec.teacher_launches:
                    rec.teacher_launches[k] += rec.cs.LAUNCHES[k] - before[k]
                return out
            return wrapped

        def update(orig):
            def wrapped(teacher, student):
                if teacher.step or rec.first_update is not None:
                    return orig(teacher, student)
                t0 = [p.detach().clone() for p in teacher.model.parameters()]
                s1 = [p.detach().clone() for p in student.parameters()]
                alpha = orig(teacher, student)
                rec.first_update = (alpha, all(torch.equal(t, 0.5 * a + 0.5 * b) for t, a, b
                                               in zip(teacher.model.parameters(), t0, s1)))
                return alpha
            return wrapped

        wraps = [(_TrainerBase, "init", init), (_TrainerBase, "resume_from_path", resume),
                 (EMATeacher, "logits", logits), (EMATeacher, "update", update)]
        if self.sc is not None:
            wraps += [(PretrainEncoderTrainer, "start_training", start),
                      (FineTuneTrainer, "start_training", start)]
        self._saved = [(cls, name, getattr(cls, name), wrap) for cls, name, wrap in wraps]
        for cls, name, fn, wrap in self._saved:
            setattr(cls, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for cls, name, fn, _ in self._saved:
            setattr(cls, name, fn)

    def timed_ms(self, skip=1):
        return _timed_ms(self.events, skip)


def _semi_resumed(trainer, saved):
    """What the semi trainer's resume restored: its teacher and RAdam state."""
    teacher = trainer.teacher.state_dict()
    return {"teacher_step": teacher["step"],
            "teacher_equal": all(torch.equal(v.cpu(), saved["_teacher"]["model"][k])
                                 for k, v in teacher["model"].items()),
            "radam_steps": sorted({int(s["step"]) for s in trainer._optimizer.state.values()}),
            "radam_equal": all(torch.equal(s["mu"].cpu(), saved["_optimizer"]["state"][i]["mu"])
                               for i, s in trainer._optimizer.state_dict()["state"].items())}


def _adv_resumed(trainer, saved):
    """What the adversarial trainer's resume restored: the discriminator
    and its Adam state."""
    adam = trainer._discr_optimizer.state_dict()["state"]
    return {"discriminator": all(torch.equal(v.cpu(), saved["_discriminator"][k])
                                 for k, v in trainer.discriminator.state_dict().items()),
            "adam_steps": sorted({int(s["step"]) for s in adam.values()}),
            "adam": all(torch.equal(s[m].cpu(), saved["_discr_optimizer"]["state"][i][m])
                        for i, s in adam.items() for m in ("mu", "nu"))}


def _check_semi_metrics(trainer, hooks, what):
    for rec in trainer.step_metrics:
        check(math.isfinite(rec["sup_loss"]) and math.isfinite(rec.get("reg_loss", 0.0)),
              f"{what}: non-finite loss {rec}")
        check(sorted(rec["hooks"]) == sorted(hooks), f"{what}: hooks {sorted(rec['hooks'])}")
        for name, m in rec["hooks"].items():
            check(m and all(math.isfinite(v) for v in m.values()), f"{what}: {name} {m}")


def slice_e_phase(cs):
    phase(f"slice E: main.py's semi path (base + production_semi + mt + uda), UNet-256, 224^2, "
          f"32 labeled + 2 x 32 unlabeled slices a step, small_c_layout pallas, 1 epoch of "
          f"1 + {SEMI_STEPS - 1} steps and one eval epoch; resume; the same under nhwc")
    from spcl_torch.main import run
    from spcl_torch.models import UNet
    from spcl_torch.training import load_checkpoint
    base_dir = ROOT / "runs" / "chip_smoke_e"
    shutil.rmtree(base_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    per_step = 32 + 2 * 32
    out = {}

    # ---- the pallas run, then its resume
    config = _merged(*SEMI_FILES, Arch={"small_c_layout": "pallas"},
                     Data={"synthetic": True},
                     Trainer={"save_dir": str(base_dir / "pallas"), "max_epoch": 1,
                              "num_batches": SEMI_STEPS})
    check(config["Trainer"]["name"] == "semi" and config["Trainer"]["packed_eval"] == 96
          and config["LabeledLoader"]["batch_size"] == 32, "slice E configuration")
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    with _Recorder(cs) as rec:
        score = run(config, DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cs.LAUNCHES)
        ms = rec.timed_ms()
    trainer = rec.trainers[0]
    teacher = {k: v for k, v in rec.teacher_launches.items() if v}
    student = {k: launches[k] - rec.teacher_launches[k] for k in launches}
    want_student = {k: v * SEMI_STEPS for k, v in STAGE_LAUNCHES_PER_STEP.items()}
    want_teacher = {k: v * SEMI_STEPS for k, v in TEACHER_LAUNCHES_PER_STEP.items()}
    print(f"stage kernel launches in {SEMI_STEPS} steps + eval: student {student}, "
          f"teacher {teacher}", flush=True)
    check(student == want_student, f"student launches: expected {want_student}")
    check(teacher == want_teacher, f"teacher launches: expected {want_teacher}")
    check(len(trainer.step_metrics) == SEMI_STEPS, len(trainer.step_metrics))
    _check_semi_metrics(trainer, ["consistency", "mt"], "slice E")
    for r in trainer.step_metrics:
        print(f"sup_loss {r['sup_loss']:.6f} reg_loss {r['reg_loss']:.6f} | mt "
              f"{r['hooks']['mt']['loss']:.3e} consistency "
              f"{r['hooks']['consistency']['loss']:.3e}", flush=True)
    alpha, ema_ok = rec.first_update
    check(alpha == 0.5 and ema_ok, f"the teacher after step 1 is not 0.5 t0 + 0.5 s1 "
                                   f"(alpha {alpha})")
    counts = {int(m.num_batches_tracked) for m in trainer.model.modules()
              if isinstance(m, torch.nn.BatchNorm2d)}
    tbn = [m for m in trainer.teacher.model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    check(counts == {SEMI_STEPS}, f"student BatchNorm counts {counts}: one update a step")
    check(all(int(m.num_batches_tracked) == 0 and not m.running_mean.any()
              and bool((m.running_var == 1).all()) for m in tbn),
          "the teacher's running statistics moved")
    check(0.0 <= score <= 1.0, f"DSC {score}")
    ckpt = base_dir / "pallas" / "last.ckpt"
    state = load_checkpoint(str(ckpt))
    UNet(max_channel=256).load_state_dict(state["_model"], strict=True)
    UNet(max_channel=256).load_state_dict(state["_teacher"]["model"], strict=True)
    check(state["_teacher"]["step"] == SEMI_STEPS, state["_teacher"]["step"])
    print(f"ema: alpha {alpha} at step 0, teacher = 0.5 t0 + 0.5 s1 to the bit | student "
          f"BatchNorm counts {counts}, teacher's untouched | val DSC {score:.5f} | last.ckpt "
          f"(student and teacher) reloads strictly | {wall:.1f} s incl. set-up and eval",
          flush=True)
    out["pallas"] = {"ms": ms, "launches": launches, "student": student, "teacher": teacher}
    print(f"slice E pallas: {ms:.3f} ms/step over {SEMI_STEPS - 1} steps after 1 warm-up = "
          f"{per_step * 1e3 / ms:.1f} slices/s ({per_step} a step)", flush=True)
    prof = _print_profile("slice E pallas", _profiled(_pretrain_epochs(trainer),
                                                       SEMI_PROFILED_STEPS), ms, top=15)
    if prof is not None:
        out["pallas"].update(kernel_ms=prof[0], busy=prof[0] / ms, stage_ms=prof[1])
    del trainer, rec
    torch.cuda.empty_cache()

    resume = _merged(*SEMI_FILES, Arch={"small_c_layout": "pallas"},
                     Data={"synthetic": True}, trainer_checkpoint=str(ckpt),
                     Trainer={"save_dir": str(base_dir / "resume"), "max_epoch": 2,
                              "num_batches": SEMI_STEPS})
    cs.reset_launch_counts()
    with _Recorder(cs, on_resume=_semi_resumed) as rec:
        run(resume, DEVICE)
        torch.cuda.synchronize()
    trainer = rec.trainers[0]
    r = rec.resumed
    check(r is not None and r["teacher_step"] == SEMI_STEPS and r["teacher_equal"]
          and r["radam_steps"] == [SEMI_STEPS] and r["radam_equal"],
          f"resume restored {r}")
    check([m["epoch"] for m in trainer.step_metrics] == [2] * SEMI_STEPS,
          f"resume ran epochs {[m['epoch'] for m in trainer.step_metrics]}")
    check(trainer.teacher.step == 2 * SEMI_STEPS, trainer.teacher.step)
    check(sum(cs.LAUNCHES.values()) == SEMI_STEPS * (sum(STAGE_LAUNCHES_PER_STEP.values())
                                                    + sum(TEACHER_LAUNCHES_PER_STEP.values())),
          f"resume launches {cs.LAUNCHES}")
    rows = sorted(load_checkpoint(str(base_dir / "resume" / "last.ckpt"))["storage"]["history"])
    check(rows == [1, 2], f"storage rows {rows}")
    print(f"resume from {ckpt.name}: epoch 2 only ({SEMI_STEPS} steps), teacher step "
          f"{r['teacher_step']} and its weights, RAdam step {r['radam_steps']} and its moments "
          f"restored; teacher step {trainer.teacher.step} after; storage rows {rows}", flush=True)
    del trainer, rec
    torch.cuda.empty_cache()

    # ---- the same 1 + 5 steps under nhwc
    config = _merged(*SEMI_FILES, Data={"synthetic": True},
                     Trainer={"save_dir": str(base_dir / "nhwc"), "max_epoch": 1,
                              "num_batches": SEMI_STEPS})
    cs.reset_launch_counts()
    with _Recorder(cs) as rec:
        run(config, DEVICE)
        torch.cuda.synchronize()
        ms_nhwc = rec.timed_ms()
    check(sum(cs.LAUNCHES.values()) == 0, f"nhwc launched stage kernels {cs.LAUNCHES}")
    _check_semi_metrics(rec.trainers[0], ["consistency", "mt"], "slice E nhwc")
    out["nhwc"] = {"ms": ms_nhwc}
    print(f"slice E nhwc: {ms_nhwc:.3f} ms/step = {per_step * 1e3 / ms_nhwc:.1f} slices/s | "
          f"pallas / nhwc {ms / ms_nhwc:.3f}", flush=True)
    prof = _print_profile("slice E nhwc", _profiled(_pretrain_epochs(rec.trainers[0]),
                                                     SEMI_PROFILED_STEPS), ms_nhwc, top=15)
    if prof is not None:
        out["nhwc"].update(kernel_ms=prof[0], busy=prof[0] / ms_nhwc)
    del rec
    torch.cuda.empty_cache()
    print("slice_e " + json.dumps(out), flush=True)
    return out


class _EagerSteps:
    """Inside the block the train steps run eagerly (`GraphedStep.engages`
    false): no CUDA graph is captured or replayed."""

    def __enter__(self):
        from spcl_torch.training.steps import GraphedStep
        self._cls, self._engages = GraphedStep, GraphedStep.engages
        GraphedStep.engages = lambda step, batch: False
        return self

    def __exit__(self, *exc):
        self._cls.engages = self._engages


# graphed against eager, TF32 off and cuDNN deterministic: each step's
# reg_loss (relative) and each weight after the run (relative L2). The same
# kernels in the same order on the same values, apart from the atomics of
# cuDNN's and the kernels' sums (~1e-7)
SLICE_GRAPH_RTOL = 1e-5


def _graphed_against_eager(what, make_trainer, steps):
    """make_trainer() -> a fresh pretrain trainer (fixed weights and seed, one
    epoch of `steps` steps), trained twice: its steps eager, then replayed
    as a CUDA graph (the first step eager, the second captured). Holds
    reg_loss a step and every weight and buffer after it within
    SLICE_GRAPH_RTOL (integer buffers equal), the graph's counters
    (eager: none; graphed: captures 1, replays steps - 1) and every kernel's
    launches equal."""
    from spcl_torch.utils import profiling
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    b.cudnn.deterministic = True
    runs = {}
    try:
        for mode in ("eager", "graphed"):
            trainer = make_trainer()
            profiling.reset_graph_counts()
            before = [dict(c) for c in profiling.LAUNCH_COUNTERS]
            with _EagerSteps() if mode == "eager" else contextlib.nullcontext():
                trainer.start_training()
            torch.cuda.synchronize()
            runs[mode] = {
                "losses": [r["reg_loss"] for r in trainer.step_metrics],
                "graph": dict(profiling.GRAPH_COUNTS),
                "launches": {k: c[k] - n[k] for c, n in zip(profiling.LAUNCH_COUNTERS, before)
                             for k in c if c[k] != n[k]},
                "state": {k: v.detach().cpu() for k, v in trainer._model.state_dict().items()}}
            del trainer
            torch.cuda.empty_cache()
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic = saved
    e, g = runs["eager"], runs["graphed"]
    loss_rel = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(g["losses"], e["losses"]))
    floats = [k for k, v in e["state"].items() if v.is_floating_point()]
    state_rel = max(_rel_l2(g["state"][k], e["state"][k]) for k in floats)
    ints_equal = all(torch.equal(g["state"][k], v) for k, v in e["state"].items()
                     if not v.is_floating_point())
    print(f"{what} graphed against eager ({steps} steps, TF32 off, cuDNN deterministic): "
          f"reg_loss {g['losses']} | eager {e['losses']} | apart by {loss_rel:.2e}, weights "
          f"and buffers by {state_rel:.2e} (rtol {SLICE_GRAPH_RTOL}) | graph {g['graph']} "
          f"(eager {e['graph']}) | launches {g['launches']}", flush=True)
    check(len(g["losses"]) == len(e["losses"]) == steps, f"{what}: {g['losses']}")
    check(e["graph"] == {"captures": 0, "replays": 0}
          and g["graph"] == {"captures": 1, "replays": steps - 1},
          f"{what}: graph counters {g['graph']}, eager {e['graph']}")
    check(g["launches"] == e["launches"], f"{what}: launches graphed {g['launches']}, eager "
                                          f"{e['launches']}")
    check(loss_rel <= SLICE_GRAPH_RTOL and state_rel <= SLICE_GRAPH_RTOL and ints_equal,
          f"{what}: graphed and eager steps disagree")
    return {"loss_rel": loss_rel, "state_rel": state_rel, "graph": g["graph"],
            "launches": g["launches"]}


def _launches_against_profile(what, run, steps):
    """run(steps) under torch.profiler: each kernel of spcl_torch.ops that its
    `LAUNCHES` counted launches as often a step in the profiler's device
    events (kernel symbol `<name>_kernel`). Returns the profile
    (`_profiled`) and {name: launches a step}."""
    from spcl_torch.utils import profiling
    before = [dict(c) for c in profiling.LAUNCH_COUNTERS]
    graph = dict(profiling.GRAPH_COUNTS)
    kernels = _profiled(run, steps)
    counted = {k: (c[k] - n[k]) / steps for c, n in zip(profiling.LAUNCH_COUNTERS, before)
               for k in c if c[k] != n[k]}
    if not any(ms for ms, _ in kernels.values()):
        print(f"{what}: the profiler recorded no device time; launches not compared (not "
              f"measured)", flush=True)
        return kernels, counted
    seen = {k: sum(n for name, (_, n) in kernels.items() if f"{k}_kernel" in name)
            for k in counted}
    graph = {k: v - graph[k] for k, v in profiling.GRAPH_COUNTS.items()}
    print(f"{what}: launches a step by LAUNCHES {counted} | in the profiler's device events "
          f"{seen} | graph captures and replays in the profiled steps {graph}", flush=True)
    check(counted == seen, f"{what}: LAUNCHES {counted} against the profiler's {seen}")
    return kernels, counted


class _HeldSupcon:
    """Inside the block, each supcon kernel call through the wrappers is
    recorded in `calls` as (kernel, operand rows, real views: label != the
    pad's -7), and in `shapes` as (kernel, rows, columns), and held to the plain version on the same operands at the
    kernels phase's tolerances; `max_err` keeps the largest error per
    kernel. The held calls are not timed. Holding a call reads the device,
    which a CUDA graph capture forbids, and a replay calls no wrapper: inside
    the block the train steps run eagerly (`_EagerSteps`). Slices F and M
    hold the graphed steps to such eager ones (`_graphed_against_eager`)."""

    def __init__(self, sc, what):
        self.sc, self.what = sc, what
        self.calls, self.shapes = [], []
        self.max_err = {"supcon_fwd": 0.0, "supcon_bwd": 0.0}

    def __enter__(self):
        sc = self.sc
        self._saved = (sc.fwd_stats_kernel, sc.bwd_dz_kernel)
        self._eager = _EagerSteps().__enter__()
        plain = {"supcon_fwd": sc.fwd_stats_plain, "supcon_bwd": sc.bwd_dz_plain}

        def noted(kernel, fn):
            def run(zr, zc, lab_r, *rest):
                self.calls.append((kernel, zr.shape[0], int((lab_r != -7).sum())))
                self.shapes.append((kernel, zr.shape[0], zc.shape[0]))
                out = fn(zr, zc, lab_r, *rest)
                ref = plain[kernel](zr, zc, lab_r, *rest)
                if kernel == "supcon_fwd":  # (denom, c, rawloss, spsum); per row / c
                    c = torch.clamp(ref[1], min=1.0)
                    err = max(float((torch.log(out[0] + 1e-16) - torch.log(ref[0] + 1e-16))
                                    .abs().max()),
                              float((out[1] - ref[1]).abs().max()),
                              float(((out[2] - ref[2]) / c).abs().max()),
                              float(((out[3] - ref[3]) / c).abs().max()))
                    tol = 2e-4
                else:
                    err = float((out - ref).abs().max())
                    tol = 2e-4 * float(ref.abs().max())
                check(err <= tol, f"{self.what} {kernel} at {zr.shape[0]} rows: err {err:.2e} "
                                  f"> {tol:.2e}")
                self.max_err[kernel] = max(self.max_err[kernel], err)
                return out
            return run

        sc.fwd_stats_kernel = noted("supcon_fwd", self._saved[0])
        sc.bwd_dz_kernel = noted("supcon_bwd", self._saved[1])
        return self

    def __exit__(self, *exc):
        self.sc.fwd_stats_kernel, self.sc.bwd_dz_kernel = self._saved
        self._eager.__exit__(*exc)


def preset_phase(sc):
    """Every legacy preset name and main_mixup at base.yaml's 5 + 5 slices,
    full width, nhwc, 2 steps each, and the semi trainer once with
    `two_stage` and `disable_bn`."""
    phase(f"slice E presets: the 11 legacy trainer names, main_mixup and two_stage + "
          f"disable_bn, UNet-256, 224^2, 5 + 5 slices, nhwc, {PRESET_STEPS} steps each")
    from spcl_torch.hooks import LEGACY_TRAINER_PRESETS
    from spcl_torch.main import run
    from spcl_torch.main_mixup import mixup_config
    from spcl_torch.ops import convstage_cuda as cs
    base_dir = ROOT / "runs" / "chip_smoke_presets"
    shutil.rmtree(base_dir, ignore_errors=True)
    def cuts(**trainer):
        return dict(Data={"synthetic": True},
                    Trainer={"max_epoch": 1, "num_batches": PRESET_STEPS, **trainer})

    runs = [(name, _merged("base.yaml", **cuts(name=name)))
            for name in sorted(LEGACY_TRAINER_PRESETS)]
    runs.append(("main_mixup", mixup_config(_merged("base.yaml", "hooks/mixup.yaml",
                                                    **cuts()))))
    runs.append(("two_stage + disable_bn", _merged(
        "base.yaml", "specific/mt.yaml", "specific/uda.yaml",
        **cuts(name="semi", two_stage=True, disable_bn=True))))
    launches = {"supcon_fwd": 0, "supcon_bwd": 0}
    with _HeldSupcon(sc, "preset") as held:
        for name, config in runs:
            config["Trainer"]["save_dir"] = str(base_dir / name.replace(" ", ""))
            sc.reset_launch_counts()
            held.calls.clear()
            t0 = time.perf_counter()
            with _Recorder(cs) as rec:
                score = run(config, DEVICE)
                torch.cuda.synchronize()
            trainer = rec.trainers[0]
            hooks = [h.name for h in trainer.hooks]
            check(len(trainer.step_metrics) == PRESET_STEPS and hooks, f"{name}: {hooks}")
            _check_semi_metrics(trainer, hooks, name)
            check(0.0 <= score <= 1.0, f"{name}: DSC {score}")
            if name in ("infonce", "infoncemt"):
                views = [(k, real) for k, _, real in held.calls]
                want = [(k, 10) for _ in range(PRESET_STEPS)
                        for k in ("supcon_fwd", "supcon_bwd")]
                check(sorted(views) == sorted(want), f"{name}: supcon launches {held.calls}")
                print(f"{name}: supcon launches (kernel, operand rows, real views) "
                      f"{held.calls}", flush=True)
                for k in launches:
                    launches[k] += sc.LAUNCHES[k]
            else:
                check(sum(sc.LAUNCHES.values()) == 0, f"{name}: supcon launches {sc.LAUNCHES}")
            if name == "two_stage + disable_bn":
                counts = {int(m.num_batches_tracked) for m in trainer.model.modules()
                          if isinstance(m, torch.nn.BatchNorm2d)}
                check(counts == {PRESET_STEPS},
                      f"two_stage + disable_bn BatchNorm counts {counts}")
            last = trainer.step_metrics[-1]
            print(f"{name:24s} hooks {hooks} | sup_loss {last['sup_loss']:.5f} reg_loss "
                  f"{last.get('reg_loss', 0.0):.5f} | "
                  + " ".join(f"{h}:{','.join(f'{k}={v:.3g}' for k, v in m.items())}"
                             for h, m in last["hooks"].items())
                  + f" | {time.perf_counter() - t0:.1f} s", flush=True)
            del trainer, rec
    max_err = held.max_err
    print(f"presets' supcon calls agree with the plain versions on their own operands: max "
          f"err fwd stats {max_err['supcon_fwd']:.2e} (tol 2e-4), dz "
          f"{max_err['supcon_bwd']:.2e} (tol 2e-4 x max|dz|)", flush=True)
    torch.cuda.empty_cache()
    return launches, max_err


# gradient tolerance of the semi parity step: |card - cpu| / |cpu| (L2) of
# each parameter's gradient. The step's gradients are not smooth at float32's
# scale (max-pool and ReLU route by comparisons): weights moved by 1e-7 of
# themselves move the CPU's by up to 1.7e-2, and card and CPU differ by up to
# 1.6e-2 (H100). 5e-2 is 3x that; a dropped skip cotangent (0.40) or a dW
# off by 10% (0.10) exceeds it (scripts/measure_semi_grad_sensitivity.py).
SEMI_GRAD_TOL = 5e-2


def semi_parity_phase(cs):
    """One semi step (mean teacher + consistency) of a UNet-256 under
    `small_c_layout="pallas"` at crop 32, 4 labeled + 4 unlabeled slices: on
    the card through the stage kernels, and on the CPU through their plain
    versions, from the same weights, teacher and draws."""
    phase("semi step parity under pallas: card (kernels) vs CPU (plain)")
    import dataclasses
    from spcl_torch.data.augment import ACDC_LABEL
    from spcl_torch.hooks import creator
    from spcl_torch.models import EMATeacher, UNet
    from spcl_torch.training import build_optimizer, build_semi_step, draw_semi_params

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(6)
    policy = dataclasses.replace(ACDC_LABEL, crop=32)
    rng = np.random.default_rng(12)
    n = 4
    lab_np = {"image": rng.integers(0, 255, (n, 1, 48, 48), dtype=np.uint8),
              "label": rng.integers(0, 4, (n, 48, 48), dtype=np.uint8),
              "valid": np.ones(n, np.float32)}
    unl_np = {"image": rng.integers(0, 255, (n, 1, 48, 48), dtype=np.uint8),
              "label": np.zeros((n, 48, 48), np.uint8),
              "partition": np.arange(n, dtype=np.int32) % 3, "patient": np.zeros(n, np.int32),
              "cycle": np.zeros(n, np.int32), "scan_idx": np.zeros(n, np.int32),
              "valid": np.array([1, 1, 1, 0], np.float32)}
    draws = draw_semi_params(torch.Generator().manual_seed(14),
                             *[{k: torch.as_tensor(v) for k, v in b.items()}
                               for b in (lab_np, unl_np)], None, policy=policy)
    base = UNet(max_channel=256, small_c_layout="pallas")
    results = {}
    for dev in (DEVICE, "cpu"):
        model = copy.deepcopy(base).to(dev)
        params = list(model.parameters())
        teacher = EMATeacher(model)
        hooks = [creator.create_consistency_hook(5.0), creator.create_mt_hook(10.0)]
        opt = build_optimizer(params, lr=1e-4, weight_decay=1e-5)
        step = build_semi_step(model, hooks, opt, num_classes=4, policy=policy,
                               teacher=teacher)
        batches = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
                   for b in (lab_np, unl_np)]
        cs.reset_launch_counts()
        m = step(*batches, None, {}, params=_to(draws, dev))
        launched = sum(cs.LAUNCHES.values())
        want = sum(STAGE_LAUNCHES_PER_STEP.values()) + sum(TEACHER_LAUNCHES_PER_STEP.values())
        check(launched == (want if dev != "cpu" else 0), f"{dev}: {launched} stage launches")
        stats = torch.cat([b.detach().float().cpu().flatten() for name, b in
                           model.named_buffers() if "running" in name])
        # the step leaves each parameter's gradient in .grad (zeroed before
        # its backward, read, not changed, by the optimizer)
        grads = {name: p.grad.detach().cpu().double() for name, p in model.named_parameters()}
        results[dev] = (float(m["sup_loss"]), float(m["reg_loss"]), stats,
                        torch.cat([p.detach().cpu().flatten() for p in params]),
                        torch.cat([p.detach().cpu().flatten()
                                   for p in teacher.model.parameters()]), grads)
    (lk, rk, sk, pk, tk, gk), (lp, rp, sp_, pp, tp, gp) = results[DEVICE], results["cpu"]
    perr, terr = float((pk - pp).abs().max()), float((tk - tp).abs().max())
    serr = float((sk - sp_).abs().max())
    gerr = {name: float((gk[name] - g).abs().max()) / float(g.abs().max())
            for name, g in gp.items()}
    gl2 = {name: float((gk[name] - g).norm() / g.norm()) for name, g in gp.items()}
    worst = sorted(gl2, key=gl2.get)[-3:]
    print(f"sup_loss card {lk:.7f} cpu {lp:.7f} | reg_loss card {rk:.7f} cpu {rp:.7f} | max "
          f"|running stat diff| {serr:.2e} | max |param diff| after one RAdam step {perr:.2e} "
          f"| max |teacher diff| {terr:.2e}", flush=True)
    print(f"gradients over {len(gl2)} tensors, |card - cpu| / |cpu| (L2): max "
          f"{max(gl2.values()):.2e}, median {sorted(gl2.values())[len(gl2) // 2]:.2e}, largest "
          + ", ".join(f"{n} {gl2[n]:.2e}" for n in worst) + f" (tol {SEMI_GRAD_TOL:g}); "
          f"max|card - cpu| / max|cpu|: max {max(gerr.values()):.2e}, median "
          f"{sorted(gerr.values())[len(gerr) // 2]:.2e}", flush=True)
    check(abs(lk - lp) <= 1e-4 * max(1.0, abs(lp)), "semi sup_loss differs card vs CPU")
    check(abs(rk - rp) <= 1e-4 * max(1.0, abs(rp)), "semi reg_loss differs card vs CPU")
    check(serr <= 1e-5, "running statistics differ card vs CPU")
    check(max(gl2.values()) <= SEMI_GRAD_TOL, f"gradients differ card vs CPU: {worst[-1]}")
    check(perr <= 1e-5 and terr <= 1e-5, "updated student or teacher differs card vs CPU")
    torch.backends.cudnn.allow_tf32 = True


# ------------------------------------------------------------------ slices F and G
# Decoder pretraining (main_pretrain_decoder.py) and the adversarial baseline
# (main_adv.py), from the transcribed config files as slice E runs them.
DECODER_FILES = ("base.yaml", "pretrain.yaml", "hooks/infonce_dense.yaml")
DECODER_STEPS = 6           # 1 warm-up + 5 timed, one epoch
DECODER_FT_STEPS = 5        # the fine-tune run of the val() sweep, one ratio
DECODER_SP_STEPS = 2
DECODER_HOOK = "infonce/Up_conv3/self"
# the fused stages run forward only under decoder pretraining: the encoder
# below Conv5 is frozen, so no input or weight of theirs needs a gradient
DECODER_STAGE_LAUNCHES_PER_STEP = {"convstage_conv": 1, "convstage_bnconv": 2,
                                   "convstage_bnpool": 2}
FROZEN_ENCODER = ("Conv1", "Conv2", "Conv3", "Conv4")
DECODER_TRAINED = ("Conv5", "Up5", "Up_conv5", "Up4", "Up_conv4", "Up3", "Up_conv3")
PAST_UP_CONV3 = ("Up2", "Up_conv2", "Deconv_1x1")
ADV_FILES = ("base.yaml", "hooks/adv.yaml")
ADV_STEPS = 6               # 1 warm-up + 5 timed, one epoch
ADV_SLICES = 5 + 5          # labeled + unlabeled slices a step (base.yaml)
# the adversarial step runs the UNet forward and backward twice: the labeled
# view, then the unlabeled one through the discriminator
ADV_STAGE_LAUNCHES_PER_STEP = {k: 2 * v for k, v in STAGE_LAUNCHES_PER_STEP.items()}


def _timed_ms(events, skip=1):
    """ms per step between the end of step `skip` and the last step's end,
    on the card's clock (host gaps included)."""
    torch.cuda.synchronize()
    return events[skip - 1].elapsed_time(events[-1]) / (len(events) - skip)


def _stage_of(key):
    """"_Up_conv3.conv.0.weight" -> "Up_conv3"."""
    return key.split(".")[0][1:]


def _unchanged(run, stages):
    return all(torch.equal(v, run["after"][k]) for k, v in run["before"].items()
               if _stage_of(k) in stages)


def _stages_moved(run, stages):
    """Each stage has a parameter that moved (at the pretrain learning rate
    of 1e-7 a BatchNorm scale of 1.0 can stay put)."""
    return all(any(not torch.equal(v, run["after"][k]) for k, v in run["before"].items()
                   if _stage_of(k) == stage) for stage in stages)


def _profile_epochs(title, trainer, ms, steps=3):
    """Busy share and top kernels of `steps` more train steps of `trainer`
    under torch.profiler, against its unprofiled `ms` per step."""
    prof = _print_profile(title, _profiled(_pretrain_epochs(trainer), steps), ms, top=12)
    return {} if prof is None else {"kernel_ms": prof[0], "busy": prof[0] / ms,
                                    "stage_ms": prof[1]}


# ------------------------------------------------------------------ slice H
# `Arch.dtype: bfloat16` on main_pretrain_encoder.py's path (the paper's
# configuration, CONFIG): per layout, a pretrain run of 2 epochs x 3 steps
# (epoch 1 the warm-up, epoch 2 traced under Trainer.profile_dir, both with
# Trainer.dump_matrices), then the fine-tune step at batch 5 (3 epochs of 5
# steps and an eval each, so that the best epoch is selected among several)
# from its last.ckpt, eagerly and with Trainer.defer_reads
SLICE_H_EPOCHS, SLICE_H_STEPS = 2, 3
SLICE_H_FT_EPOCHS, SLICE_H_FT_STEPS = 3, 5
SLICE_H_TIMED_STEPS = 5
SLICE_H_HOOK = "spinfonce/Conv5/partition"
# eager against deferred on the card: the same steps from the same checkpoint
# and seed, but cuDNN's backward and the nearest-upsample backward add with
# atomics, in an order that is not fixed from run to run; after 15 steps
# the storage rows, the best score and best.ckpt's weights agree to
# DEFER_REL_TOL x max(1, |value|), and best.ckpt holds the same epoch
DEFER_REL_TOL = 1e-4
PROFILE_AGREE = 0.05        # Trainer.profile_dir's ms/step against _profiled's


def _storage_rows(run_dir):
    """storage.csv's rows as {column: float}, without the throughput columns
    (wall-clock rates differ from run to run)."""
    import csv
    return [{k: float(v) for k, v in row.items() if "throughput" not in k and v != ""}
            for row in csv.DictReader(open(Path(run_dir) / "storage.csv"))]


def _host_syncs(trainer):
    """Run `trainer.start_training()` under torch.cuda's sync debug mode up to
    the deferred loop's drain (the whole run for the eager loop): returns
    (best score, the synchronising calls seen: device -> host copies,
    pageable host -> device copies, stream waits). The loop's own
    `torch.cuda.synchronize` around each epoch (a wait, not a read: spcl_tpu's
    block_until_ready) is not counted."""
    import warnings
    drain, wait = trainer._drain_epochs, trainer._synchronize

    def draining(*args, **kwargs):
        torch.cuda.set_sync_debug_mode(0)
        return drain(*args, **kwargs)

    def waiting():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        wait()
        torch.cuda.set_sync_debug_mode(mode)

    trainer._drain_epochs, trainer._synchronize = draining, waiting
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            score = trainer.start_training()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # each synchronising call warns; one more notice says the mode is a prototype
    return score, [str(w.message)[:120] for w in caught
                   if "synchroniz" in str(w.message).lower()
                   and "prototype" not in str(w.message).lower()]


def _slice_h_finetune(cs, config, ckpt, save_dir, defer):
    """One fine-tune run (SLICE_H_FT_EPOCHS epochs of SLICE_H_FT_STEPS steps
    at batch 5, each with an eval on the val and test loaders) from `ckpt`:
    (bf16 stage launches, storage rows, best score, trainer). The deferred
    run may not synchronise with the host before its drain; the eager one
    must be seen to."""
    from spcl_torch.entry import build_trainer
    ft = copy.deepcopy(config)
    ft["Arch"]["checkpoint"] = str(ckpt)
    ft["Data"]["labeled_scan_num"] = 1
    ft["Trainer"].update(name="ft", max_epoch=SLICE_H_FT_EPOCHS, num_batches=SLICE_H_FT_STEPS,
                         defer_reads=defer, profile_dir=None, dump_matrices=False)
    shutil.rmtree(save_dir, ignore_errors=True)
    trainer = build_trainer(ft, save_dir=str(save_dir), device=DEVICE)
    trainer.init()
    cs.reset_launch_counts()
    score, syncs = _host_syncs(trainer)
    print(f"{'deferred' if defer else 'eager'} fine-tune: {len(syncs)} host "
          f"synchronisations" + (" before the drain" if defer else "")
          + (f": {syncs[:2]}" if syncs else ""), flush=True)
    # the eager loop reads its metrics every epoch: the detector must see it
    check(not syncs if defer else bool(syncs),
          "the deferred loop synchronised with the host before its drain" if defer
          else "the sync detector saw none of the eager loop's reads")
    torch.cuda.synchronize()
    check(sum(cs.LAUNCHES.values()) == 0, f"bf16 fine-tune ran float32 stage kernels "
                                          f"{cs.LAUNCHES}")
    return dict(cs.LAUNCHES_BF16), _storage_rows(save_dir), score, trainer


def slice_h_phase(sc, cs, float32=None):
    """Slice H: the bf16 compute path at full width, under `pallas` and `nhwc`,
    through spcl_torch.entry.build_trainer. `float32`: slice B's and slice
    A's numbers from this run (profile_phase), printed beside."""
    phase("slice H: Arch.dtype bfloat16, encoder pretrain (UNet-256, 224^2, 2N=60) and "
          "fine-tune, small_c_layout pallas and nhwc")
    from spcl_torch.entry import build_trainer
    from spcl_torch.models import UNet
    from spcl_torch.training import load_checkpoint, load_model_state_dict
    out = {"launches_by_path": {}}
    steps = SLICE_H_EPOCHS * SLICE_H_STEPS
    for layout in ("pallas", "nhwc"):
        config = copy.deepcopy(CONFIG)
        config["Arch"].update(dtype="bfloat16", small_c_layout=layout)
        base = ROOT / "runs" / f"chip_smoke_h_{layout}"
        shutil.rmtree(base, ignore_errors=True)
        config["Trainer"].update(max_epoch=SLICE_H_EPOCHS, num_batches=SLICE_H_STEPS,
                                 save_dir=str(base), profile_dir=str(base / "profile"),
                                 dump_matrices=True)
        trainer = build_trainer(config, save_dir=str(base / "pre"), pretrain=True,
                                device=DEVICE)
        check(trainer.model.dtype == torch.bfloat16, trainer.model.dtype)
        trainer.init()
        check(all(p.dtype == torch.float32 for p in trainer.model.parameters())
              and all(b.dtype != torch.bfloat16 for b in trainer.model.buffers()),
              "bf16 model: parameters and buffers must stay float32")
        sc.reset_launch_counts()
        cs.reset_launch_counts()
        trainer.start_training()
        torch.cuda.synchronize()
        stage_bf16 = dict(cs.LAUNCHES_BF16)
        want = {f"{k}_bf16": (v * steps if layout == "pallas" else 0)
                for k, v in STAGE_LAUNCHES_PER_STEP.items()}
        print(f"{layout} bf16 pretrain launches in {steps} steps: {stage_bf16} | supcon "
              f"{dict(sc.LAUNCHES)}", flush=True)
        check(stage_bf16 == want, f"{layout}: bf16 stage launches {stage_bf16}, want {want}")
        check(sum(cs.LAUNCHES.values()) == 0, f"{layout}: float32 stage kernels ran "
                                              f"{cs.LAUNCHES}")
        check(sc.LAUNCHES == {"supcon_fwd": steps, "supcon_bwd": steps}, dict(sc.LAUNCHES))
        for rec in trainer.step_metrics:
            hm = rec["hooks"][SLICE_H_HOOK]
            check(math.isfinite(rec["reg_loss"]) and 0.0 <= hm["sp_weight"] <= 1.0, rec)
        print(f"{layout} bf16 reg_loss " + ", ".join(f"{r['reg_loss']:.6f}"
                                                    for r in trainer.step_metrics), flush=True)
        mats = trainer.last_matrices.get(SLICE_H_HOOK, {})
        check(set(mats) == {"sim_logits", "sim_exp", "pos_mask", "sp_mask"}, sorted(mats))
        for name, m in mats.items():
            check(m.shape == (VIEWS, VIEWS) and bool(np.isfinite(m).all()),
                  f"dump_matrices {name}: {m.shape}, finite {bool(np.isfinite(m).all())}")
        print(f"{layout} dump_matrices: " + ", ".join(f"{k} {tuple(v.shape)}"
                                                     for k, v in sorted(mats.items()))
              + " finite", flush=True)
        ckpt = base / "pre" / "last.ckpt"
        fresh = UNet(input_dim=1, num_classes=4, max_channel=256, dtype=torch.bfloat16)
        fresh.load_state_dict(load_model_state_dict(str(ckpt)), strict=True)

        # steady state, profile and peak memory; the trainer's own profiled epoch beside
        run = _pretrain_epochs(trainer)
        run(1)
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        turns = [_wall_ms(run, SLICE_H_TIMED_STEPS) for _ in range(2)]
        peak = torch.cuda.max_memory_allocated()
        ms = min(turns)
        prof = _print_profile(f"slice H {layout} bf16", _profiled(run, SLICE_H_STEPS), ms)
        check(trainer.profile_ms is not None, "Trainer.profile_dir recorded no device time")
        res = {"ms": ms, "turns": turns, "peak_bytes": peak, "step_bytes": peak - mem0,
               "profile_dir_ms": trainer.profile_ms}
        if prof is not None:
            total, stage_ms, launched = prof
            res.update(kernel_ms=total, busy=total / ms, stage_ms=stage_ms,
                       stage_launches=launched)
            agree = abs(trainer.profile_ms - total) / total
            print(f"{layout} bf16: Trainer.profile_dir epoch {trainer.profile_ms:.3f} ms/step "
                  f"device time beside chip_smoke's accounting {total:.3f} ms/step "
                  f"({100 * agree:.2f}% apart)", flush=True)
            check(agree <= PROFILE_AGREE, f"profile_dir {trainer.profile_ms} vs {total}")
        f32 = (float32 or {}).get(layout, {})
        print(f"slice H {layout} bf16 pretrain step: {ms:.3f} ms/step wall "
              f"({VIEWS * 1e3 / ms:.1f} slices/s)"
              + (f", kernels {res['kernel_ms']:.3f} ms/step, busy "
                 f"{100 * res['busy']:.1f}%, stage kernels {res['stage_ms']:.3f} ms/step "
                 f"{res['stage_launches']}" if "kernel_ms" in res else "")
              + f", peak {peak / 2**30:.2f} GiB, the steps' own "
              f"{(peak - mem0) / 2**30:.3f} GiB"
              + (f" | float32 beside (slice {'B' if layout == 'pallas' else 'A'}, this run): "
                 f"{f32['ms']:.3f} ms/step, kernels {f32.get('kernel_ms', float('nan')):.3f} "
                 f"ms/step, busy {100 * f32.get('busy', float('nan')):.1f}%, the steps' own "
                 f"{f32.get('step_bytes', float('nan')) / 2**30:.3f} GiB" if f32 else ""),
              flush=True)
        del run
        if layout == "pallas":
            out["launches_by_path"]["slice_h"] = stage_bf16

        # fine-tune from the pretrain checkpoint: eager, then deferred
        runs = {}
        for defer in (False, True):
            launches, rows, score, ft = _slice_h_finetune(
                cs, config, ckpt, base / f"ft_{'deferred' if defer else 'eager'}", defer)
            want = {f"{k}_bf16": (v * SLICE_H_FT_EPOCHS * SLICE_H_FT_STEPS
                                  if layout == "pallas" else 0)
                    for k, v in STAGE_LAUNCHES_PER_STEP.items()}
            check(launches == want, f"{layout} fine-tune launches {launches}, want {want}")
            check(len(rows) == SLICE_H_FT_EPOCHS and 0.0 <= score <= 1.0,
                  f"DSC {score}, rows {len(rows)}")
            for row in rows:
                for key in ("tra/sup_loss/mean", "val/loss/mean", "test/loss/mean"):
                    check(math.isfinite(row[key]), f"{key} = {row[key]}")
            best = load_checkpoint(str(Path(ft.save_dir) / "best.ckpt"))
            fresh.load_state_dict(best["_model"], strict=True)
            runs[defer] = (rows, score, best)
            if layout == "pallas":
                out["launches_by_path"]["slice_h_finetune" + ("_deferred" if defer else "")] = \
                    launches
            del ft
        (rows_e, score_e, best_e), (rows_d, score_d, best_d) = runs[False], runs[True]
        check(all(set(e) == set(d) for e, d in zip(rows_e, rows_d)),
              "deferred storage columns differ")
        worst = max(abs(e[k] - d[k]) / max(1.0, abs(e[k]))
                    for e, d in zip(rows_e, rows_d) for k in e)
        dsc_key = next(k for k in rows_e[0] if k.startswith("val/") and k.endswith("DSC_mean"))
        dscs = [row[dsc_key] for row in rows_e]
        # each run's best.ckpt holds the first epoch of its highest val DSC
        kept = {defer: best["cur_epoch"] for defer, (_, _, best) in runs.items()}
        for defer, (rows, _, _) in runs.items():
            at = 1 + max(range(len(rows)), key=lambda i: (rows[i][dsc_key], -i))
            check(kept[defer] == at, f"{layout} {'deferred' if defer else 'eager'}: best.ckpt "
                                     f"of epoch {kept[defer]}, its best val DSC at {at}")
        same_epoch = kept[False] == kept[True]
        worst_w = max(float((best_e["_model"][k].double() - best_d["_model"][k].double())
                            .abs().max()) / max(1.0, float(best_e["_model"][k].abs().max()))
                      for k in best_e["_model"] if best_e["_model"][k].is_floating_point()) \
            if same_epoch else float("nan")
        print(f"{layout} bf16 fine-tune, {SLICE_H_FT_EPOCHS} epochs: sup_loss "
              + ", ".join(f"{r['tra/sup_loss/mean']:.6f}" for r in rows_e)
              + " | val DSC by epoch " + ", ".join(f"{v:.6f}" for v in dscs)
              + f" | best.ckpt of epoch {kept[False]} eager, {kept[True]} deferred (of "
              f"{SLICE_H_FT_EPOCHS}) | best DSC eager {score_e:.6f} deferred {score_d:.6f} | "
              f"storage rows deferred vs eager: worst |diff| / max(1, |value|) {worst:.2e} "
              f"over {len(rows_e)} x {len(rows_e[0])} | best.ckpt weights {worst_w:.2e} "
              f"(tol {DEFER_REL_TOL:g})", flush=True)
        # the two runs may keep different epochs only where their val DSCs tie
        # within the card's run-to-run spread
        check(same_epoch or abs(dscs[kept[False] - 1] - dscs[kept[True] - 1]) <= DEFER_REL_TOL,
              f"{layout}: best.ckpt of epoch {kept[False]} eager, {kept[True]} deferred")
        check(worst <= DEFER_REL_TOL and abs(score_e - score_d) <= DEFER_REL_TOL
              and not worst_w > DEFER_REL_TOL, f"{layout}: deferred fine-tune differs from eager")
        res["finetune"] = {"dsc": score_e, "dsc_deferred": score_d, "row_diff": worst,
                           "best_epoch": {"eager": kept[False], "deferred": kept[True]},
                           "best_ckpt_diff": worst_w}
        out[layout] = res
        del trainer
        torch.cuda.empty_cache()
    print("slice_h " + json.dumps({k: v for k, v in out.items()}, default=str), flush=True)
    return out


SLICE_F_GRAPH_STEPS = 3      # steps of the graphed decoder pretraining, and of its eager twin


def _f_path(run):
    """The kernels line's name of a slice F run."""
    return "slice_f" if run == "pallas" else f"slice_f_{run}"


def slice_f_phase(sc, cs, encoder_ckpt=None):
    """Decoder pretraining (spcl_torch.main_pretrain_decoder.run, both phases)
    under `pallas`, then the same pretraining under `nhwc` and with the
    self-paced hook; each supcon call held to its plain version."""
    phase(f"slice F: main_pretrain_decoder.py (base + pretrain + hooks/infonce_dense), "
          f"UNet-256, 224^2, {DECODER_VIEWS} views x 5 points = 2N {DENSE_2N} at Up_conv3, "
          f"small_c_layout pallas, 1 + {DECODER_STEPS - 1} steps, then val() at one ratio "
          f"({DECODER_FT_STEPS} fine-tune steps and one eval epoch); the same under nhwc; "
          f"{DECODER_SP_STEPS} steps of SPInfonceParams at Up_conv3")
    from spcl_torch.entry import build_trainer, separate_pretrain_finetune_configs
    from spcl_torch.main_pretrain_decoder import run
    from spcl_torch.models import UNet
    from spcl_torch.training import load_checkpoint
    from spcl_torch.utils import fix_all_seed
    base_dir = ROOT / "runs" / "chip_smoke_f"
    shutil.rmtree(base_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    rows = -(-DENSE_2N // sc._TILE) * sc._TILE  # the operands' padded rows
    # each run's own kernel launches: the decoder pretraining under pallas
    # ("pallas"), its val() fine-tune, the nhwc pretraining and the
    # self-paced one
    out = {"launches": {}}

    def config_for(layout, name, steps):
        arch = {"small_c_layout": layout}
        if encoder_ckpt is not None:
            arch["checkpoint"] = str(encoder_ckpt)
        return _merged(*DECODER_FILES, Arch=arch, Data={"synthetic": True, "ratios": [1]},
                       Trainer={"save_dir": str(base_dir / name), "max_epoch": 1,
                                "num_batches": steps, "ft_num_batches": DECODER_FT_STEPS})

    def pretrain_only(config):
        pre, _ = separate_pretrain_finetune_configs(config)
        pre["Trainer"]["name"] = "pretrain_decoder"
        trainer = build_trainer(pre, save_dir=pre["Trainer"]["save_dir"], pretrain=True,
                                device=DEVICE)
        trainer.init()
        trainer.start_training()

    def check_pretraining(what, run_, held, steps, layout):
        trainer = run_["trainer"]
        check(type(trainer).__name__ == "PretrainDecoderTrainer"
              and trainer._forward_until == "Up_conv3", f"{what}: {type(trainer).__name__}")
        want_calls = [(k, rows, DENSE_2N) for _ in range(steps)
                      for k in ("supcon_fwd", "supcon_bwd")]
        check(sorted(held.calls) == sorted(want_calls),
              f"{what}: supcon calls (kernel, rows, views) {held.calls}")
        per_step = DECODER_STAGE_LAUNCHES_PER_STEP if layout == "pallas" else {}
        want = {k: 0 for k in run_["launches"]}
        want.update(supcon_fwd=steps, supcon_bwd=steps,
                    **{k: v * steps for k, v in per_step.items()})
        check(run_["launches"] == want, f"{what}: launches {run_['launches']}, want {want}")
        check(_unchanged(run_, FROZEN_ENCODER), f"{what}: a frozen encoder stage moved")
        check(_unchanged(run_, PAST_UP_CONV3), f"{what}: a stage past Up_conv3 moved")
        check(_stages_moved(run_, DECODER_TRAINED), f"{what}: a trained stage did not move")
        check(len(trainer.step_metrics) == steps, len(trainer.step_metrics))
        for r in trainer.step_metrics:
            m = r["hooks"][trainer.hooks[0].name]
            check(math.isfinite(r["reg_loss"]) and all(math.isfinite(v) for v in m.values()),
                  f"{what}: {r}")
            if "sp_weight" in m:
                check(0.0 <= m["sp_weight"] <= 1.0, f"{what}: {m}")
        return trainer

    # ---- both phases of main_pretrain_decoder.py under pallas
    config = config_for("pallas", "pallas", DECODER_STEPS)
    check(config["InfonceParams"]["feature_names"] == "Up_conv3"
          and config["ContrastiveLoaderParams"]["scan_sample_num"] == 3
          and config["Optim"]["lr"] == 1e-7, "slice F configuration")
    t0 = time.perf_counter()
    with _HeldSupcon(sc, "slice F") as held, _Recorder(cs, sc) as rec:
        scores = run(config, DEVICE)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pre, ft = rec.runs
    trainer = check_pretraining("slice F pallas", pre, held, DECODER_STEPS, "pallas")
    want_ft = {k: 0 for k in ft["launches"]}
    want_ft.update({k: v * DECODER_FT_STEPS for k, v in STAGE_LAUNCHES_PER_STEP.items()})
    check(ft["launches"] == want_ft, f"slice F fine-tune launches {ft['launches']}")
    out["launches"].update(pallas=pre["launches"], finetune=ft["launches"])
    check(list(scores) == [1] and 0.0 <= scores[1] <= 1.0, f"slice F DSC {scores}")
    state = load_checkpoint(str(base_dir / "pallas" / "pre" / "last.ckpt"))
    UNet(max_channel=256).load_state_dict(state["_model"], strict=True)
    check(sorted(state["_hooks"]) == [DECODER_HOOK], sorted(state["_hooks"]))
    ms = _timed_ms(pre["events"])
    for r in trainer.step_metrics:
        print(f"pretrain reg_loss {r['reg_loss']:.6f}", flush=True)
    print(f"slice F pallas: warm start {'from ' + str(encoder_ckpt) if encoder_ckpt else 'none'}"
          f" | supcon calls {DECODER_STEPS} x (fwd, bwd) at {rows} operand rows ({DENSE_2N} "
          f"views), each held to plain: max err fwd stats {held.max_err['supcon_fwd']:.2e}, dz "
          f"{held.max_err['supcon_bwd']:.2e} | pretrain launches {pre['launches']} | Conv1-Conv4 "
          f"and Up2..Deconv_1x1 bit-equal, Conv5..Up_conv3 moved | fine-tune launches "
          f"{ft['launches']} | val DSC {scores[1]:.5f} | pre/last.ckpt reloads strictly | "
          f"{wall:.1f} s incl. set-up, fine-tune and eval", flush=True)
    out["max_err"] = dict(held.max_err)
    steady = _pretrain_epochs(trainer)(DECODER_STEPS)
    out["pallas"] = {"ms": ms, "steady_ms": steady,
                     **_profile_epochs("slice F pallas", trainer, steady)}
    print(f"slice F pallas: {ms:.3f} ms/step over {DECODER_STEPS - 1} steps after 1 warm-up "
          f"(each supcon call held to plain) = {DECODER_VIEWS * 1e3 / ms:.1f} slices/s; a "
          f"further epoch unheld {steady:.3f} ms/step = {DECODER_VIEWS * 1e3 / steady:.1f} "
          f"slices/s", flush=True)
    del trainer, pre, ft, rec
    torch.cuda.empty_cache()

    # ---- the same pretraining under nhwc, then the self-paced hook under pallas
    with _HeldSupcon(sc, "slice F nhwc") as held, _Recorder(cs, sc) as rec:
        pretrain_only(config_for("nhwc", "nhwc", DECODER_STEPS))
    trainer = check_pretraining("slice F nhwc", rec.runs[0], held, DECODER_STEPS, "nhwc")
    out["launches"]["nhwc"] = rec.runs[0]["launches"]
    steady = _pretrain_epochs(trainer)(DECODER_STEPS)
    out["nhwc"] = {"ms": _timed_ms(rec.runs[0]["events"]), "steady_ms": steady,
                   **_profile_epochs("slice F nhwc", trainer, steady)}
    print(f"slice F nhwc: {out['nhwc']['ms']:.3f} ms/step (held), {steady:.3f} ms/step unheld "
          f"= {DECODER_VIEWS * 1e3 / steady:.1f} slices/s | pallas / nhwc "
          f"{out['pallas']['steady_ms'] / steady:.3f}", flush=True)
    del trainer, rec
    torch.cuda.empty_cache()

    config = config_for("pallas", "spinfonce", DECODER_SP_STEPS)
    del config["InfonceParams"]
    config["SPInfonceParams"] = dict(CONFIG_FILES["hooks/spinfonce.yaml"]["SPInfonceParams"],
                                     feature_names="Up_conv3", contrast_ons="self")
    with _HeldSupcon(sc, "slice F spinfonce") as held, _Recorder(cs, sc) as rec:
        pretrain_only(config)
    trainer = check_pretraining("slice F spinfonce", rec.runs[0], held, DECODER_SP_STEPS,
                                "pallas")
    out["launches"]["spinfonce"] = rec.runs[0]["launches"]
    m = trainer.step_metrics[-1]["hooks"]["spinfonce/Up_conv3/self"]
    print(f"slice F spinfonce (soft, correct_grad): reg_loss "
          f"{trainer.step_metrics[-1]['reg_loss']:.6f} sp_weight {m['sp_weight']:.6f} gamma "
          f"{m['age_param']:.1f} | supcon err fwd {held.max_err['supcon_fwd']:.2e} dz "
          f"{held.max_err['supcon_bwd']:.2e}", flush=True)
    for k in out["max_err"]:
        out["max_err"][k] = max(out["max_err"][k], held.max_err[k])
    del trainer, rec
    torch.cuda.empty_cache()

    # ---- the held runs' steps were eager: the pallas decoder pretraining (the
    # hook draws its points every step) replayed as a CUDA graph against eager steps
    start = {}

    def make_trainer():
        pre, _ = separate_pretrain_finetune_configs(config_for("pallas", "graphed",
                                                               SLICE_F_GRAPH_STEPS))
        pre["Trainer"]["name"] = "pretrain_decoder"
        fix_all_seed(pre["RandomSeed"])
        trainer = build_trainer(pre, save_dir=pre["Trainer"]["save_dir"], pretrain=True,
                                device=DEVICE)
        if not start:
            start.update({k: v.clone() for k, v in trainer._model.state_dict().items()})
        trainer._model.load_state_dict(start)
        trainer.init()
        return trainer

    out["graphed"] = _graphed_against_eager("slice F pallas decoder", make_trainer,
                                            SLICE_F_GRAPH_STEPS)
    del start
    torch.cuda.empty_cache()
    print("slice_f " + json.dumps(out), flush=True)
    return out


def slice_g_phase(sc, cs):
    """The adversarial baseline (spcl_torch.main.run with main_adv's config)
    under `pallas`, then its resume into epoch 2."""
    phase(f"slice G: main_adv.py (base + hooks/adv), UNet-256, 224^2, 5 labeled + 5 unlabeled "
          f"slices a step, reg_weight 0.01, small_c_layout pallas, 1 epoch of 1 + "
          f"{ADV_STEPS - 1} steps and one eval epoch; resume into epoch 2")
    from spcl_torch.main import run
    from spcl_torch.main_adv import adv_config
    from spcl_torch.models import Discriminator, UNet
    from spcl_torch.training import load_checkpoint
    base_dir = ROOT / "runs" / "chip_smoke_g"
    shutil.rmtree(base_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    def config_for(name, max_epoch, **extra):
        return adv_config(_merged(*ADV_FILES, Arch={"small_c_layout": "pallas"},
                                  Data={"synthetic": True},
                                  Trainer={"save_dir": str(base_dir / name),
                                           "max_epoch": max_epoch, "num_batches": ADV_STEPS},
                                  **extra))

    def check_run(what, run_, epoch):
        trainer = run_["trainer"]
        check(type(trainer).__name__ == "AdversarialTrainer", type(trainer).__name__)
        want = {k: 0 for k in run_["launches"]}
        want.update({k: v * ADV_STEPS for k, v in ADV_STAGE_LAUNCHES_PER_STEP.items()})
        check(run_["launches"] == want, f"{what}: launches {run_['launches']}, want {want}")
        recs = [r for r in trainer.step_metrics if r["epoch"] == epoch]
        check(len(recs) == ADV_STEPS, f"{what}: {len(recs)} steps")
        for r in recs:
            check(all(math.isfinite(r[k]) for k in ("sup_loss", "gen_loss", "dis_loss"))
                  and r["gen_loss"] > 0 and r["dis_loss"] > 0, f"{what}: {r}")
        moved = [k for k, v in run_["before"].items() if k.startswith("discriminator.")
                 and not torch.equal(v, run_["after"][k])]
        check(len(moved) == len(list(trainer.discriminator.parameters())),
              f"{what}: discriminator tensors moved {moved}")
        return trainer

    config = config_for("pallas", 1)
    check(config["Trainer"]["name"] == "adv" and config["Trainer"]["reg_weight"] == 0.01
          and config["LabeledLoader"]["batch_size"] == 5, "slice G configuration")
    t0 = time.perf_counter()
    with _Recorder(cs, sc) as rec:
        score = run(config, DEVICE)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (r,) = rec.runs
    trainer = check_run("slice G", r, 1)
    counts = {int(m.num_batches_tracked) for m in trainer.model.modules()
              if isinstance(m, torch.nn.BatchNorm2d)}
    check(counts == {2 * ADV_STEPS}, f"BatchNorm counts {counts}: two updates a step")
    check(0.0 <= score <= 1.0, f"slice G DSC {score}")
    ckpt = base_dir / "pallas" / "last.ckpt"
    state = load_checkpoint(str(ckpt))
    UNet(max_channel=256).load_state_dict(state["_model"], strict=True)
    Discriminator(4).load_state_dict(state["_discriminator"], strict=True)
    for m in trainer.step_metrics:
        print(f"sup_loss {m['sup_loss']:.6f} gen_loss {m['gen_loss']:.6f} dis_loss "
              f"{m['dis_loss']:.6f}", flush=True)
    ms = _timed_ms(r["events"])
    out = {"launches": {"pallas": dict(r["launches"])}, "ms": ms}
    print(f"slice G pallas: launches {r['launches']} (eval none) | every discriminator tensor "
          f"moved | BatchNorm counts {counts} | val DSC {score:.5f} | last.ckpt (UNet and "
          f"discriminator) reloads strictly | {wall:.1f} s incl. set-up and eval", flush=True)
    print(f"slice G pallas: {ms:.3f} ms/step over {ADV_STEPS - 1} steps after 1 warm-up = "
          f"{ADV_SLICES * 1e3 / ms:.1f} slices/s ({ADV_SLICES} a step)", flush=True)
    out.update(_profile_epochs("slice G pallas", trainer, ms))
    del trainer, rec, r
    torch.cuda.empty_cache()

    with _Recorder(cs, sc, on_resume=_adv_resumed) as rec:
        run(config_for("resume", 2, trainer_checkpoint=str(ckpt)), DEVICE)
        torch.cuda.synchronize()
    (r,) = rec.runs
    resumed = rec.resumed
    check(resumed is not None and resumed["discriminator"] and resumed["adam"]
          and resumed["adam_steps"] == [ADV_STEPS], f"resume restored {resumed}")
    trainer = check_run("slice G resume", r, 2)
    check([m["epoch"] for m in trainer.step_metrics] == [2] * ADV_STEPS,
          f"resume ran epochs {[m['epoch'] for m in trainer.step_metrics]}")
    adam_steps = {int(s["step"]) for s in trainer._discr_optimizer.state.values()}
    check(adam_steps == {2 * ADV_STEPS}, f"discriminator Adam steps {adam_steps}")
    out["launches"]["resume"] = dict(r["launches"])
    print(f"resume from {ckpt.name}: epoch 2 only ({ADV_STEPS} steps), the discriminator and "
          f"its Adam state (step {resumed['adam_steps']}, moments) restored; Adam step "
          f"{sorted(adam_steps)} after", flush=True)
    del trainer, rec, r
    torch.cuda.empty_cache()
    print("slice_g " + json.dumps(out), flush=True)
    return out


def adv_parity_phase(cs):
    """One adversarial step (reg_weight 0.5, dis_consider_image) of a
    UNet-256 under `small_c_layout="pallas"` at crop 32, 4 labeled + 4
    unlabeled slices: on the card through the stage kernels, and on the CPU
    through their plain versions, from the same weights, discriminator and
    draws."""
    phase("adversarial step parity under pallas: card (kernels) vs CPU (plain)")
    import dataclasses
    from spcl_torch.data.augment import ACDC_LABEL
    from spcl_torch.models import Discriminator, UNet
    from spcl_torch.training import (Adam, build_adversarial_step, build_optimizer,
                                     draw_adversarial_params)

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(8)
    policy = dataclasses.replace(ACDC_LABEL, crop=32)
    rng = np.random.default_rng(13)
    n = 4
    lab_np = {"image": rng.integers(0, 255, (n, 1, 48, 48), dtype=np.uint8),
              "label": rng.integers(0, 4, (n, 48, 48), dtype=np.uint8),
              "valid": np.ones(n, np.float32)}
    unl_np = {"image": rng.integers(0, 255, (n, 1, 48, 48), dtype=np.uint8),
              "label": np.zeros((n, 48, 48), np.uint8),
              "valid": np.array([1, 1, 1, 0], np.float32)}
    draws = draw_adversarial_params(torch.Generator().manual_seed(15),
                                    *[{k: torch.as_tensor(v) for k, v in b.items()}
                                      for b in (lab_np, unl_np)], None, policy=policy)
    base = UNet(max_channel=256, small_c_layout="pallas")
    base_d = Discriminator(5)
    d0 = {k: v.detach().clone() for k, v in base_d.state_dict().items()}
    results = {}
    for dev in (DEVICE, "cpu"):
        model, d = copy.deepcopy(base).to(dev), copy.deepcopy(base_d).to(dev)
        opt = build_optimizer(list(model.parameters()), lr=1e-4, weight_decay=1e-5)
        dopt = Adam(d.parameters(), lr=1e-4, betas=(0.5, 0.999))
        step = build_adversarial_step(model, d, opt, dopt, num_classes=4, policy=policy,
                                      reg_weight=0.5, dis_consider_image=True)
        batches = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
                   for b in (lab_np, unl_np)]
        cs.reset_launch_counts()
        m = step(*batches, None, params=_to(draws, dev))
        launched = dict(cs.LAUNCHES)
        want = ADV_STAGE_LAUNCHES_PER_STEP if dev != "cpu" else {k: 0 for k in launched}
        check(launched == want, f"{dev}: stage launches {launched}")
        stats = torch.cat([b.detach().float().cpu().flatten() for name, b in
                           model.named_buffers() if "running" in name])
        # the gradients are left in .grad (the discriminator's scaled by reg_weight)
        grads = {name: p.grad.detach().cpu().double() for name, p in model.named_parameters()}
        grads.update({f"discriminator.{name}": p.grad.detach().cpu().double()
                      for name, p in d.named_parameters()})
        results[dev] = ({k: float(m[k]) for k in ("sup_loss", "gen_loss", "dis_loss")}, stats,
                        torch.cat([p.detach().cpu().flatten() for p in model.parameters()]),
                        {k: v.detach().cpu() for k, v in d.state_dict().items()}, grads)
    (lk, sk, pk, dk, gk), (lp, sp_, pp, dp, gp) = results[DEVICE], results["cpu"]
    serr, perr = float((sk - sp_).abs().max()), float((pk - pp).abs().max())
    gl2 = {name: float((gk[name] - g).norm() / g.norm()) for name, g in gp.items()}
    derr = {k: float((dk[k] - dp[k]).norm() / (dp[k] - d0[k]).norm()) for k in dp}
    # the card's discriminator step replayed on the CPU from the card's own
    # (reg_weight-scaled) gradients: Adam's update is the same function
    replay = copy.deepcopy(base_d)
    for name, p in replay.named_parameters():
        p.grad = gk[f"discriminator.{name}"].float()
    Adam(replay.parameters(), lr=1e-4, betas=(0.5, 0.999)).step()
    rerr = max(float((dk[k] - v).abs().max()) for k, v in replay.state_dict().items())
    worst = sorted(gl2, key=gl2.get)[-3:]
    print("losses card / cpu: " + ", ".join(f"{k} {lk[k]:.7f} / {lp[k]:.7f}" for k in lk)
          + f" | max |running stat diff| {serr:.2e} | max |student diff| after one RAdam step "
          f"{perr:.2e} | discriminator update |card - cpu| / |cpu| (L2): max "
          f"{max(derr.values()):.2e}; the card's discriminator against its gradients' Adam "
          f"step replayed on the CPU: max {rerr:.2e}", flush=True)
    print(f"gradients over {len(gl2)} tensors (student and discriminator), |card - cpu| / |cpu| "
          f"(L2): max {max(gl2.values()):.2e}, median {sorted(gl2.values())[len(gl2) // 2]:.2e}, "
          f"largest " + ", ".join(f"{n} {gl2[n]:.2e}" for n in worst)
          + f" (tol {SEMI_GRAD_TOL:g})", flush=True)
    for k in lk:
        check(abs(lk[k] - lp[k]) <= 1e-4 * max(1.0, abs(lp[k])), f"{k} differs card vs CPU")
    check(serr <= 1e-5, "running statistics differ card vs CPU")
    check(max(gl2.values()) <= SEMI_GRAD_TOL, f"gradients differ card vs CPU: {worst[-1]}")
    check(perr <= 1e-5, "updated student differs card vs CPU")
    # Adam's first step moves a weight by about lr x sign(g): an element whose
    # gradient sits at its rounding noise may take the other sign and move by
    # up to 2 lr (tests/test_torch_adversarial.py), so the discriminator is
    # held through its gradients (above) and the update they make (replayed),
    # and its update card vs CPU to the gradients' tolerance in L2
    check(rerr <= 1e-7, "the card's discriminator step is not Adam's on its gradients")
    check(max(derr.values()) <= SEMI_GRAD_TOL, "updated discriminator differs card vs CPU")
    torch.backends.cudnn.allow_tf32 = True


# ------------------------------------------------------------------ slice J
# every trainer of main.py, main_mixup.py, main_adv.py and
# main_pretrain_decoder.py under Trainer.mesh=2 at full width (UNet-256,
# crop 224 of 256, nhwc), each against this process running the same padded
# batches and draws alone
RANKS_J = 2
SLICE_J_STEPS = 4            # J1: an epoch of 1 warm-up + 3 timed steps, two epochs
SLICE_J_SHORT = 3            # J3, J4, J5: steps a run
SLICE_J_PRESETS = ("entropy", "ucmeanteacher", "iic", "udaiic", "midl", "mine", "infonce")
MIXUP_ALPHAS = (1.0, 0.4)
J_DECODER_CONTRASTS = ("replicated", "row_sharded")
# slice C's tolerances where they hold (see slice_c_phase: the ranks
# convolve half the rows, so cuDNN may take other TF32 algorithms, and the
# BatchNorm sums run in another order): weights within twice what the run
# moved them. Losses and hook metrics 5e-3 relative, 10x TF32's unit
# roundoff (2^-11): slice C's 1e-3 held for every part in slice J alone
# (at most 3.9e-4), but in the whole script MINE's mutual information,
# which runs its own TF32 statistics network on the rank's rows, moved
# 1.23e-3 (H100). Losses and hook metrics near zero (a mutual information
# of random heads) are held to 5e-3 x max(|value|, J_METRIC_FLOOR).
J_LOSS_TOL = 5e-3
J_METRIC_FLOOR = 1e-2
# the adversarial losses after the first step read the discriminator, whose
# Adam moves a weight by about lr x sign(g): where g sits at its rounding
# noise the two runs move it 2 lr apart (the discriminator's update is held
# within 1e-2 relative L2 for that reason, tests/test_torch_adversarial.py),
# and gen_loss / dis_loss carry that (2.3e-3 on an H100)
J_ADV_TOLS = {"gen_loss": 1e-2, "dis_loss": 1e-2}
# the discriminator's Adam first moments (its summed gradients): 2.4e-2 to
# 4.2e-2 relative L2 on an H100 (the gradients carry the TF32 noise of the
# UNet's softmax and of the discriminator's own convolutions); gradients not
# summed over the ranks, or summed twice, are 0.5 off
J_D_MOMENT_TOL = 0.2
# a gate's share of pixels (UC-MT's entropy threshold) flips where a pixel
# sits at the threshold, as slice C's hard weights do: held in absolute
# value to slice C's sp_weight tolerance (1.99e-3 relative on an H100 in
# the whole script, 0 in slice J alone)
J_GATES = {"ucmt/uc_ratio": 5e-3}


class _PaddedLoaders:
    """Inside the block, every trainer `init()` makes takes its training
    batches right-padded with -1 (valid 0) to a multiple of `multiple`: the
    single process then runs the very batches a mesh run of that many ranks
    pads (eval batches need no padding: every eval output is per slice)."""

    def __init__(self, multiple):
        self.multiple = multiple

    def __enter__(self):
        from spcl_torch.data.loader import HostLoader
        from spcl_torch.training.trainer import _TrainerBase
        self._orig = _TrainerBase.init
        orig, multiple = self._orig, self.multiple

        def init(trainer):
            orig(trainer)
            for attr in ("_labeled_loader", "_unlabeled_loader", "_contrastive_loader"):
                loader = getattr(trainer, attr, None)
                if loader is not None:
                    setattr(trainer, attr, HostLoader(loader.dataset,
                                                      _PaddedSampler(loader.sampler, multiple)))
        _TrainerBase.init = init
        return self

    def __exit__(self, *exc):
        from spcl_torch.training.trainer import _TrainerBase
        _TrainerBase.init = self._orig


class _MixUpAlpha:
    """Inside the block `MixUpParams` makes a MixUp hook of Beta(alpha,
    alpha) (the factory, as spcl_tpu's, passes none: Beta(1, 1))."""

    def __init__(self, alpha):
        self.alpha = alpha

    def __enter__(self):
        from spcl_torch.hooks import creator
        from spcl_torch.hooks.mixup import MixUpHook
        self._orig = creator.create_mixup_hook
        alpha = self.alpha

        def make(weight=1.0, enable_bn=True):
            return MixUpHook(name="mix_reg", weight=weight, enable_bn=enable_bn, alpha=alpha)
        creator.create_mixup_hook = make
        return self

    def __exit__(self, *exc):
        from spcl_torch.hooks import creator
        creator.create_mixup_hook = self._orig


class _KeepEpochCheckpoint:
    """Inside the block, rank 0's last.ckpt of epoch `epoch` is also copied
    to `path` (the resume's starting point)."""

    def __init__(self, epoch, path):
        self.epoch, self.path = epoch, Path(path)

    def __enter__(self):
        from spcl_torch.training.trainer import _TrainerBase
        self._orig = _TrainerBase.save_to
        orig, keep = self._orig, self

        def save_to(trainer, name):
            orig(trainer, name)
            if name == "last.ckpt" and trainer._cur_epoch == keep.epoch and trainer._is_master:
                shutil.copy(Path(trainer.save_dir) / name, keep.path)
        _TrainerBase.save_to = save_to
        return self

    def __exit__(self, *exc):
        from spcl_torch.training.trainer import _TrainerBase
        _TrainerBase.save_to = self._orig


def _j_weights(module, names):
    """{name: numpy} of the named parameters of `module`."""
    params = dict(module.named_parameters())
    return {k: params[k].detach().cpu().numpy().copy() for k in names}


J_WEIGHTS = ("_Conv1.conv.0.weight", "_Conv5.conv.0.weight", "_Up_conv3.conv.0.weight")


def _j_run(trainer, before=None):
    """What is compared of a finished run: its step metrics, a few of the
    UNet's weights (the teacher's, the discriminator's) and what they were
    before it."""
    out = {"steps": [dict(m) for m in trainer.step_metrics], "n_shards": trainer.n_shards,
           "weights": _j_weights(trainer.model, J_WEIGHTS)}
    if trainer.teacher is not None:
        out["teacher"] = _j_weights(trainer.teacher.model, J_WEIGHTS)
    d = getattr(trainer, "_discriminator", None)
    if d is not None:
        out["discriminator"] = {k: v.detach().cpu().numpy().copy()
                                for k, v in d.state_dict().items()}
        state = trainer._discr_optimizer.state_dict()["state"]
        out["d_moments"] = [state[i]["mu"].cpu().numpy().copy() for i in sorted(state)]
        out["d_lr"] = trainer._discr_lr
    if before is not None:
        out["before"] = before
    if hasattr(trainer, "best_score"):
        out["score"] = float(trainer.best_score)
    return out


def _j_before(trainer):
    out = {"weights": _j_weights(trainer.model, J_WEIGHTS)}
    d = getattr(trainer, "_discriminator", None)
    if d is not None:
        out["discriminator"] = {k: v.detach().cpu().numpy().copy()
                                for k, v in d.state_dict().items()}
    return out


class _Before:
    """Records `_j_before` of every trainer right after its `init()`."""

    def __enter__(self):
        from spcl_torch.training.trainer import _TrainerBase
        self._orig, self.records = _TrainerBase.init, []
        orig, rec = self._orig, self

        def init(trainer):
            orig(trainer)
            rec.records.append(_j_before(trainer))
        _TrainerBase.init = init
        return self

    def __exit__(self, *exc):
        from spcl_torch.training.trainer import _TrainerBase
        _TrainerBase.init = self._orig


def _j_configs(base_dir, mesh, shared_dir=None):
    """{part: config} of slice J; `mesh` is Trainer.mesh (0: one process).
    Each part writes under `base_dir` (a rank's own directory, so that which
    rank wrote what shows), J4 under `shared_dir`: main_pretrain_decoder.py's
    fine-tune phase reads the pretraining's last.ckpt from the run's
    save_dir, which rank 0 wrote."""
    from spcl_torch.main_adv import adv_config
    from spcl_torch.main_mixup import mixup_config

    def cut(part, steps, max_epoch=1, **trainer):
        root = shared_dir if part.startswith("j4") and shared_dir is not None else base_dir
        return {"Data": {"synthetic": True},
                "Trainer": {"save_dir": str(Path(root) / part), "max_epoch": max_epoch,
                            "num_batches": steps, "mesh": mesh, **trainer}}

    out = {"j1": _merged(*SEMI_FILES, **cut("j1", SLICE_J_STEPS, max_epoch=2))}
    for name in SLICE_J_PRESETS:
        blocks = cut(f"j2_{name}", 1, name=name)
        if name == "infonce":
            blocks["InfonceParams"] = {"global_contrast": "row_sharded"}
        out[f"j2_{name}"] = _merged("base.yaml", **blocks)
    for alpha in MIXUP_ALPHAS:
        out[f"j3_mixup_{alpha}"] = mixup_config(
            _merged("base.yaml", "hooks/mixup.yaml", **cut(f"j3_mixup_{alpha}", SLICE_J_SHORT)))
    out["j3_adv"] = adv_config(_merged(*ADV_FILES, **cut("j3_adv", SLICE_J_SHORT)))
    for contrast in J_DECODER_CONTRASTS:
        blocks = cut(f"j4_{contrast}", SLICE_J_SHORT, ft_num_batches=2)
        blocks["Data"]["ratios"] = [1]
        blocks["InfonceParams"] = {"global_contrast": contrast}
        out[f"j4_{contrast}"] = _merged(*DECODER_FILES, **blocks)
    for defer in (False, True):
        out[f"j5_{'deferred' if defer else 'eager'}"] = _merged(
            "base.yaml", **cut(f"j5_{defer}", SLICE_J_SHORT, max_epoch=2, name="ft",
                               defer_reads=defer))
    return out


def _j_pretrain_decoder(config):
    """The pretraining phase of main_pretrain_decoder.py alone."""
    from spcl_torch.entry import build_trainer, separate_pretrain_finetune_configs
    from spcl_torch.utils import fix_all_seed
    fix_all_seed(config["RandomSeed"])  # as the entry points seed it
    pre, _ = separate_pretrain_finetune_configs(config)
    pre["Trainer"]["name"] = "pretrain_decoder"
    trainer = build_trainer(pre, save_dir=pre["Trainer"]["save_dir"], pretrain=True,
                            device=DEVICE)
    trainer.init()
    trainer.start_training()
    return trainer


def _j_parts(sc, cs, configs, mesh, keep):
    """Every part of slice J in this process (one rank of the mesh run, or
    the single process): {part: run}. J1's epoch-1 last.ckpt is kept at
    `keep` (rank 0's), which the mesh run resumes from."""
    from spcl_torch.main import run
    from spcl_torch.main_pretrain_decoder import run as run_decoder
    out = {}

    def held(what, fn):
        sc.reset_launch_counts()
        with _HeldSupcon(sc, what) as h, _Recorder(cs) as rec, _Before() as before:
            result = fn()
            torch.cuda.synchronize()
        return result, rec, before.records, h, dict(sc.LAUNCHES)

    # ---- J1: main.py, production_semi + mt + uda, 2 epochs; then the resume into epoch 2
    config = configs["j1"]
    with _KeepEpochCheckpoint(1, keep):
        score, rec, before, _, _ = held("J1", lambda: run(config, DEVICE))
    out["j1"] = _j_run(rec.trainers[0], before[0])
    out["j1"]["ms"] = _timed_ms(rec.events[:SLICE_J_STEPS])
    out["j1"]["dsc"] = float(score)
    del rec
    if mesh:
        resume = copy.deepcopy(config)
        resume["trainer_checkpoint"] = str(keep)
        resume["Trainer"]["save_dir"] = str(Path(config["Trainer"]["save_dir"]) / "resume")
        _, rec, before, _, _ = held("J1 resume", lambda: run(resume, DEVICE))
        out["j1_resume"] = _j_run(rec.trainers[0])
        del rec
    torch.cuda.empty_cache()

    # ---- J2: the presets, one step each (infonce: row_sharded)
    for name in SLICE_J_PRESETS:
        _, rec, before, h, launches = held(f"J2 {name}",
                                           lambda: run(configs[f"j2_{name}"], DEVICE))
        out[f"j2_{name}"] = {**_j_run(rec.trainers[0], before[0]), "calls": list(h.calls),
                             "shapes": list(h.shapes), "launches": launches,
                             "max_err": dict(h.max_err)}
        del rec
    torch.cuda.empty_cache()

    # ---- J3: main_mixup at two alphas, main_adv
    for alpha in MIXUP_ALPHAS:
        with _MixUpAlpha(alpha):
            _, rec, before, _, _ = held(f"J3 mixup {alpha}",
                                        lambda: run(configs[f"j3_mixup_{alpha}"], DEVICE))
        out[f"j3_mixup_{alpha}"] = _j_run(rec.trainers[0], before[0])
        out[f"j3_mixup_{alpha}"]["alpha"] = rec.trainers[0].hooks[0].alpha
        del rec
    _, rec, before, _, _ = held("J3 adv", lambda: run(configs["j3_adv"], DEVICE))
    out["j3_adv"] = _j_run(rec.trainers[0], before[0])
    del rec
    torch.cuda.empty_cache()

    # ---- J4: decoder pretraining, row_sharded through both phases of the entry
    for contrast in J_DECODER_CONTRASTS:
        config = configs[f"j4_{contrast}"]
        if mesh and contrast == "row_sharded":
            fn = lambda: run_decoder(config, DEVICE)  # noqa: E731
        else:
            fn = lambda: _j_pretrain_decoder(config)  # noqa: E731
        _, rec, before, h, launches = held(f"J4 {contrast}", fn)
        out[f"j4_{contrast}"] = {**_j_run(rec.trainers[0], before[0]), "calls": list(h.calls),
                                 "shapes": list(h.shapes), "launches": launches,
                                 "max_err": dict(h.max_err),
                                 "phases": [type(t).__name__ for t in rec.trainers]}
        del rec
    torch.cuda.empty_cache()

    # ---- J5: fine-tuning with defer_reads beside eager (under the mesh)
    if mesh:
        for name in ("j5_eager", "j5_deferred"):
            score, rec, before, _, _ = held(name, lambda: run(configs[name], DEVICE))
            out[name] = _j_run(rec.trainers[0], before[0])
            out[name]["dsc"] = float(score)
            del rec
        torch.cuda.empty_cache()
    return out


def slice_j_rank(root, base_dir, device):
    """One rank of slice J (runs in a spawned process)."""
    global DEVICE
    DEVICE = device
    sys.path.insert(0, root)
    import torch.distributed as dist
    from spcl_torch.ops import convstage_cuda as cs
    from spcl_torch.ops import supcon_cuda as sc
    from spcl_torch.parallel import mesh
    my_dir = Path(base_dir) / f"rank{mesh.rank()}"
    out = _j_parts(sc, cs, _j_configs(my_dir, RANKS_J, shared_dir=base_dir), RANKS_J,
                   Path(base_dir) / "j1_epoch1.ckpt")
    out["backend"], out["rank"] = dist.get_backend(), mesh.rank()
    out["files"] = {part: sorted(str(f.relative_to(my_dir / part))
                                 for f in (my_dir / part).rglob("*") if f.is_file())
                    if (my_dir / part).is_dir() else [] for part in ("j1", "j3_adv", "j5_True")}
    return out


def _rel_diff(a, b, floor=0.0):
    return abs(a - b) / max(abs(b), floor, 1e-30)


def _j_compare(what, got, one, tols=None):
    """Per-step losses and hook metrics of `got` against `one` (relative
    J_LOSS_TOL, or `tols` by loss name; the gates of J_GATES absolute), and
    the kept weights within twice what `one`'s run moved them; prints the
    largest differences, then fails on any beyond the tolerances."""
    tols = {**J_GATES, **(tols or {})}
    check(len(got["steps"]) == len(one["steps"]) > 0,
          f"{what}: {len(got['steps'])} steps against {len(one['steps'])}")
    diffs = {}
    for g, w in zip(got["steps"], one["steps"]):
        for k, v in w.items():
            if k == "hooks":
                for name, m in v.items():
                    for mk, mv in m.items():
                        key = f"{name}/{mk}"
                        diff = (abs(g[k][name][mk] - mv) if key in J_GATES
                                else _rel_diff(g[k][name][mk], mv, J_METRIC_FLOOR))
                        diffs[key] = max(diffs.get(key, 0.0), diff)
            elif k != "epoch":
                diffs[k] = max(diffs.get(k, 0.0), _rel_diff(g[k], v, J_METRIC_FLOOR))
    weights = {}
    for part in ("weights", "teacher"):
        if part not in one:
            continue
        for k, v in one[part].items():
            moved = float(np.abs(v - one["before"]["weights"][k]).max())
            diff = float(np.abs(got[part][k] - v).max())
            weights[f"{part}.{k}"] = (diff, max(2.0 * moved, 1e-7))
    worst = max(weights.items(), key=lambda kv: kv[1][0] / kv[1][1]) if weights else None
    print(f"{what}: max rel diff "
          + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items())
          + f" (tol {J_LOSS_TOL}, {tols}) | "
          + (f"weights worst {worst[0]}: {worst[1][0]:.2e} (moved x2 {worst[1][1]:.2e})"
             if worst else ""), flush=True)
    check(all(v <= tols.get(k, J_LOSS_TOL) for k, v in diffs.items()),
          f"{what}: losses or hook metrics differ")
    check(all(d <= lim for d, lim in weights.values()), f"{what}: weights differ {weights}")


def _j_discriminator(what, got, one, steps):
    """The discriminator: the gradients its Adam saw, summed over the ranks,
    through its first moments, within J_D_MOMENT_TOL relative L2 of one
    process's; its weights within 2 x 1.14 lr a step of one process's (Adam
    moves a weight by about lr x sign(g), and in its first three steps at
    b1 0.5, b2 0.999 by at most 1.14 lr, so where g sits at its rounding
    noise, or at the noise TF32 puts into its inputs, the two runs step it
    apart: tests/test_torch_adversarial.py holds its update in L2 for that
    reason, and after several steps on the card that L2 is no bound; on an
    H100: moments 2.4e-2 to 4.2e-2, weights 4.8e-4 to 6.0e-4 of 6.8e-4,
    update 0.19 to 0.25)."""
    moments = max(float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
                  for g, w in zip(got["d_moments"], one["d_moments"]))
    lim = 2.0 * 1.14 * one["d_lr"] * steps
    weights, update = 0.0, 0.0
    for k, v in one["discriminator"].items():
        b = one["before"]["discriminator"][k]
        weights = max(weights, float(np.abs(got["discriminator"][k] - v).max()))
        if np.any(v - b):
            update = max(update, float(np.linalg.norm((got["discriminator"][k] - b) - (v - b))
                                       / np.linalg.norm(v - b)))
    print(f"{what}: discriminator Adam first moments rel L2 {moments:.2e} (tol "
          f"{J_D_MOMENT_TOL}) | weights max abs diff {weights:.2e} (tol 2 x 1.14 lr x {steps} "
          f"steps = {lim:.1e}) | update rel L2 {update:.2e}", flush=True)
    check(moments <= J_D_MOMENT_TOL and weights <= lim, f"{what}: discriminator differs")


def slice_j_phase(sc, cs):
    phase(f"slice J: every trainer under Trainer.mesh={RANKS_J} (UNet-256, 224^2, nhwc): "
          f"main.py semi (production_semi + mt + uda) 2 epochs x {SLICE_J_STEPS} and its "
          f"resume, the presets {', '.join(SLICE_J_PRESETS)} (infonce row_sharded), main_mixup "
          f"(alpha {MIXUP_ALPHAS}), main_adv, main_pretrain_decoder (replicated, row_sharded), "
          f"fine-tune with defer_reads; each against this process alone")
    from spcl_torch.models import UNet
    from spcl_torch.parallel.mesh import spawn_local
    from spcl_torch.training import load_model_state_dict
    base_dir = ROOT / "runs" / "chip_smoke_j"
    shutil.rmtree(base_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    ranks = spawn_local(RANKS_J, slice_j_rank, (str(ROOT), str(base_dir), DEVICE),
                        device=DEVICE, timeout_s=900.0, collective_timeout_s=300.0)
    print(f"two ranks done in {time.perf_counter() - t0:.1f} s (process start included); "
          f"backend {ranks[0]['backend']}", flush=True)
    check(ranks[0]["backend"] == ("nccl" if cards >= RANKS_J else "gloo"), ranks[0]["backend"])
    t0 = time.perf_counter()
    single_dir = base_dir / "single"
    with _PaddedLoaders(RANKS_J):
        one = _j_parts(sc, cs, _j_configs(single_dir, 0), 0, single_dir / "j1_epoch1.ckpt")
    print(f"the single process done in {time.perf_counter() - t0:.1f} s", flush=True)
    r0, r1 = ranks

    # ---- every part: 2 shards, the replicas agree to the bit, equal to one process
    for part, want in one.items():
        for r in ranks:
            check(r[part]["n_shards"] == RANKS_J and want["n_shards"] == 1, f"{part} shards")
        check(r0[part]["steps"] == r1[part]["steps"], f"{part}: the ranks' metrics differ")
        for key in ("weights", "teacher"):
            if key in want:
                check(all(np.array_equal(r0[part][key][k], r1[part][key][k])
                          for k in want[key]), f"{part}: the replicas' {key} differ")
        _j_compare(f"J {part}: 2 ranks vs one process", r0[part], want,
                   J_ADV_TOLS if part == "j3_adv" else None)
    for part in ("j3_adv",):
        _j_discriminator(f"J {part}", r0[part], one[part], SLICE_J_SHORT)
        check(all(np.array_equal(r0[part]["discriminator"][k], r1[part]["discriminator"][k])
                  for k in r0[part]["discriminator"]), "the replicas' discriminators differ")

    # ---- J1: resume, files, checkpoints, ms/step
    j1, resumed = r0["j1"], r0["j1_resume"]
    check([m["epoch"] for m in resumed["steps"]] == [2] * SLICE_J_STEPS,
          f"J1 resume ran epochs {[m['epoch'] for m in resumed['steps']]}")
    _j_compare("J1 resume into epoch 2 vs the uninterrupted mesh run",
               {**resumed, "steps": resumed["steps"]},
               {**j1, "steps": j1["steps"][SLICE_J_STEPS:]})
    print(f"files of rank 0: {r0['files']['j1']} | of rank 1: {r1['files']}", flush=True)
    check(all(f == [] for f in r1["files"].values()), f"rank 1 wrote {r1['files']}")
    for f in (".success", "best.ckpt", "last.ckpt", "storage.csv", "config.yaml"):
        check(f in r0["files"]["j1"], f"rank 0 did not write j1/{f}")
    ckpt = base_dir / "rank0" / "j1" / "last.ckpt"
    UNet(max_channel=256).load_state_dict(load_model_state_dict(str(ckpt)), strict=True)
    print(f"J1 best val DSC: 2 ranks {j1['dsc']:.6f}, one process {one['j1']['dsc']:.6f} "
          f"(tol 1e-3: argmax near-ties)", flush=True)
    check(0.0 <= j1["dsc"] <= 1.0 and abs(j1["dsc"] - one["j1"]["dsc"]) <= 1e-3,
          f"J1 DSC {j1['dsc']} against {one['j1']['dsc']}")
    mesh_ms = max(r["j1"]["ms"] for r in ranks)
    shared = cards < RANKS_J
    print(f"J1 semi step (32 + 2 x 32 slices), {SLICE_J_STEPS - 1} timed steps after 1 warm-up: "
          f"{RANKS_J} ranks over {r0['backend']} {mesh_ms:.3f} ms/step = "
          f"{96e3 / mesh_ms:.1f} slices/s | single process {one['j1']['ms']:.3f} ms/step = "
          f"{96e3 / one['j1']['ms']:.1f} slices/s"
          + (" | both ranks share ONE card and stage their collectives through the host: "
             "this is no speed-up figure" if shared else ""), flush=True)

    # ---- J2 / J4: the supcon strips, one forward and one dz launch per rank and step
    launches = {"supcon_fwd": 0, "supcon_bwd": 0}
    max_err = {"supcon_fwd": 0.0, "supcon_bwd": 0.0}
    for part, steps in [("j2_infonce", 1)] + [(f"j4_{c}", SLICE_J_SHORT)
                                              for c in J_DECODER_CONTRASTS]:
        for r in ranks:
            run = r[part]
            kinds = sorted(k for k, _, _ in run["calls"])
            check(kinds == ["supcon_bwd"] * steps + ["supcon_fwd"] * steps
                  and run["launches"] == {"supcon_fwd": steps, "supcon_bwd": steps},
                  f"{part} rank {r['rank']}: supcon calls {run['calls']}, launches "
                  f"{run['launches']}")
            print(f"{part} rank {r['rank']}: supcon (kernel, rows, cols) "
                  f"{sorted(set(run['shapes']))}, calls {len(run['calls'])}, held to plain: "
                  f"max err fwd {run['max_err']['supcon_fwd']:.2e} dz "
                  f"{run['max_err']['supcon_bwd']:.2e}", flush=True)
        for k in launches:
            launches[k] += r0[part]["launches"][k]
            max_err[k] = max(max_err[k], *(r[part]["max_err"][k] for r in ranks))
    check(r0["j4_row_sharded"]["phases"] == ["PretrainDecoderTrainer", "FineTuneTrainer"],
          f"J4 phases {r0['j4_row_sharded']['phases']}")
    for part, share in (("j2_infonce", RANKS_J), ("j4_row_sharded", RANKS_J),
                        ("j4_replicated", 1)):
        # the strips hold this rank's rows of the views (the operands pad
        # rows and columns to the kernels' tiles); the replicated loss all
        for r in ranks:
            real = {v for _, _, v in r[part]["calls"]}
            whole = {v for _, _, v in one[part]["calls"]}
            check(len(real) == len(whole) == 1 and real.pop() * share == whole.pop(),
                  f"{part} rank {r['rank']}: operand rows {r[part]['calls']} against one "
                  f"process's {one[part]['calls']}")

    # ---- J3: the alphas took; J5: defer_reads = eager under the mesh
    check([r0[f"j3_mixup_{a}"]["alpha"] for a in MIXUP_ALPHAS] == list(MIXUP_ALPHAS),
          "J3 alphas")
    e, d = r0["j5_eager"], r0["j5_deferred"]
    worst = max(float(np.abs(d["weights"][k] - e["weights"][k]).max()
                      / max(1.0, float(np.abs(e["weights"][k]).max()))) for k in e["weights"])
    print(f"J5 fine-tune under the mesh: best score eager {e['score']:.6f} deferred "
          f"{d['score']:.6f} | weights max rel diff {worst:.2e} (tol {DEFER_REL_TOL})",
          flush=True)
    check(abs(d["score"] - e["score"]) <= DEFER_REL_TOL * max(1.0, abs(e["score"]))
          and worst <= DEFER_REL_TOL, "J5: defer_reads differs from eager")
    out = {"launches": launches, "max_err": max_err, "mesh_ms": mesh_ms,
           "single_ms": one["j1"]["ms"], "backend": r0["backend"], "shared_card": shared}
    print("slice_j " + json.dumps(out), flush=True)
    return out


# ------------------------------------------------------------------ slice I
SLICE_I_FT_STEPS = 5          # the fine-tune that writes the served checkpoint
SLICE_I_WARMUP = 3            # requests before the timed ones
SLICE_I_REQUESTS = 50         # timed requests at each batch size
SERVE_BATCHES = (1, 8, 32)
SERVE_F32_TOL = 1e-4          # float32 logits, TF32 off in both the server and the forward
SERVE_BF16_REL_TOL = 2.0 ** -7  # x max|logits|: one bf16 rounding of the largest logit
SLICE_I_FORWARD_REPS = 20
INSPECT_KEYS = [f"gamma_{g}/{k}" for g in (1.0, 3.0, 10.0, 100.0)
                for k in ("sim_logits", "pos_mask", "sp_mask")]  # weight_inspection.py's


def _slice_i_config(**arch):
    """CONFIG as the fine-tune trainer of the paper's configuration takes it
    (UNet-256, 4 classes, crop 224 of 256, `nhwc`), 1 epoch of 5 steps."""
    config = copy.deepcopy(CONFIG)
    config["Arch"].update(arch)
    config["Trainer"].update(name="ft", max_epoch=1, num_batches=SLICE_I_FT_STEPS)
    return config


def _serving_slices(config, n):
    """n val slices of the synthetic test set, center-cropped to 224^2, uint8."""
    from spcl_torch.entry.common import load_datasets_from_config
    images = load_datasets_from_config(config)[1].images
    canvas, crop = images.shape[-1], config["Data"]["crop"]
    lo = (canvas - crop) // 2
    idx = np.arange(n) % len(images)
    return np.ascontiguousarray(images[idx, lo:lo + crop, lo:lo + crop])


def _direct_logits(model, x_uint8):
    """The live module's NHWC logits on the request's float32 input."""
    x = torch.from_numpy(x_uint8.astype(np.float32) / 255.0).to(DEVICE)
    with torch.no_grad():
        return model(x[:, None])["logits"].permute(0, 2, 3, 1)


def _serve_tol(dtype, ref):
    """The tolerance of a response against the direct forward's logits `ref`."""
    if dtype == "float32":
        return SERVE_F32_TOL
    return SERVE_BF16_REL_TOL * float(ref.abs().max())


def _hold_response(what, logits, pred, ref, tol):
    """Served logits within `tol` of the direct forward's; pred equal wherever
    the top two logits are further apart than `tol`. Returns the error."""
    err = float((torch.from_numpy(logits).to(ref.device) - ref).abs().max()) \
        if logits is not None else 0.0
    check(err <= tol, f"{what}: served logits {err} from the direct forward (tolerance {tol})")
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol
    got = torch.from_numpy(pred).to(ref.device).long()
    check(bool((got == ref.argmax(dim=-1))[clear].all()),
          f"{what}: served pred differs from the direct forward away from ties")
    return err


def _post(port, path, body):
    """One POST on a fresh connection with TCP_NODELAY (as HTTP clients such
    as curl and urllib3 set it; urllib does not, and its body, sent after the
    headers, then waits for the server's delayed ACK); returns the body."""
    import http.client
    import socket
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        data = resp.read()
        check(resp.status == 200, f"POST {path}: HTTP {resp.status} {data[:200]!r}")
        return data
    finally:
        conn.close()


def _serve_requests(port, model, dtype, slices, batch, n, outputs, what):
    """n POST /predict requests of `batch` uint8 slices, each response held
    to the direct forward; returns the latencies in ms and the largest
    error over its tolerance."""
    import io
    lat, err = [], 0.0
    for r in range(n):
        x = slices[(r * batch) % (len(slices) - batch + 1):][:batch]
        buf = io.BytesIO()
        np.save(buf, x)
        body = buf.getvalue()
        t0 = time.perf_counter()
        data = _post(port, f"/predict?outputs={outputs}", body)
        out = np.load(io.BytesIO(data))
        if outputs == "both":
            logits, pred = out["logits"], out["pred"]
        else:
            logits, pred = None, out
        lat.append((time.perf_counter() - t0) * 1e3)
        check(pred.shape == (batch,) + x.shape[1:] and pred.dtype == np.int32,
              f"{what}: pred {pred.shape} {pred.dtype}")
        ref = _direct_logits(model, x)
        tol = _serve_tol(dtype, ref)
        err = max(err, _hold_response(what, logits, pred, ref, tol) / tol)
    return lat, err


def _get_ms(port, path, n=20):
    """Median wall ms of n GET requests (the HTTP round trip alone)."""
    import http.client
    import socket
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.request("GET", path)
            conn.getresponse().read()
        finally:
            conn.close()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(lat))


def _served_call_ms(server, slices, batch, fresh_thread, n=10):
    """Median wall ms of the artifact's call with the copy back of pred:
    through the server's device thread (`server.predict`, as a request runs
    it), or directly, each call in a fresh thread."""
    import threading
    x = slices[:batch].astype(np.float32)[..., None] / 255.0
    lat = []

    def call():
        t0 = time.perf_counter()
        if fresh_thread:
            server.served_model(x)["pred"].cpu()
        else:
            server.predict(x, ("pred",))
        lat.append((time.perf_counter() - t0) * 1e3)

    call()  # warm-up
    lat.clear()
    for _ in range(n):
        if fresh_thread:
            t = threading.Thread(target=call)
            t.start()
            t.join(timeout=60)
        else:
            call()
    return float(np.median(lat))


def _forward_ms(model, slices, batch, reps=SLICE_I_FORWARD_REPS):
    """The direct eval-mode forward of `batch` slices on the card (input
    already there), CUDA events over `reps` calls after a warm-up."""
    x = torch.from_numpy(slices[:batch].astype(np.float32) / 255.0).to(DEVICE)[:, None]
    with torch.no_grad():
        model(x)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            model(x)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _pcts(lat):
    a = np.sort(np.asarray(lat))
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def slice_i_phase(encoder_ckpt=None):
    """Slice I: evaluate, inspect and serve a trained UNet-256 through the
    port's entry points (`spcl_torch.inference`, `spcl_torch.weight_inspection`,
    `spcl_torch.serving`). The eval-mode forward takes the UNet's plain path:
    no kernel of spcl_torch.ops runs here. `encoder_ckpt`: slice B's pretrain
    last.ckpt, the fine-tune's warm start and the inspected weights (None:
    the fresh random initialisation, as `--serving-only` runs it)."""
    phase("slice I: inference, weight inspection and serving (UNet-256, 224^2)")
    import threading
    from spcl_torch import inference, weight_inspection
    from spcl_torch.entry import build_trainer
    from spcl_torch.entry.common import build_model_from_config
    from spcl_torch.serving import export_from_checkpoint, make_http_server
    from spcl_torch.training import load_model_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = ROOT / "runs" / "chip_smoke_i"
    shutil.rmtree(base, ignore_errors=True)
    out = {}

    # ---- the checkpoint: one fine-tune epoch of 5 steps from the encoder
    config = _slice_i_config(checkpoint=str(encoder_ckpt) if encoder_ckpt else None)
    trainer = build_trainer(config, save_dir=str(base / "ft"), device=DEVICE)
    trainer.init()
    trainer.start_training()
    ckpt = base / "ft" / "last.ckpt"
    check(ckpt.exists(), f"{ckpt} missing")
    del trainer

    # ---- inference from it, held to the trainer's own eval epoch
    config = _slice_i_config(checkpoint=str(ckpt))
    report = inference.run_inference(config, str(base / "inference"), device=DEVICE)
    trainer = build_trainer(config, save_dir=str(base / "eval"), device=DEVICE)
    trainer.init()
    stats, dsc = trainer._run_eval_epoch(trainer._test_loader)
    dice = {k: v for k, v in report.items() if k.startswith("DSC")}
    check(dice == {k: stats["dice"][k] for k in dice} and dice["DSC_mean"] == dsc,
          f"inference Dice {dice} != the trainer's eval epoch {stats['dice']}")
    for k, v in report.items():
        check(k.startswith("DSC") or math.isnan(v) or v >= 0.0, f"{k} = {v}")
    loader = trainer._test_loader
    list(inference.predictions(trainer, loader))  # warm-up
    t0 = time.perf_counter()
    preds = list(inference.predictions(trainer, loader))
    fwd = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = inference.score(preds, trainer.model.num_classes)
    meters = time.perf_counter() - t0
    check(list(again) == list(report)
          and np.array_equal(list(again.values()), list(report.values()), equal_nan=True),
          f"a second scoring differs: {again} vs {report}")
    scans = len(preds)
    out["inference"] = {"scans": scans, "slices": sum(len(p) for _, p, _ in preds),
                        "forward_ms_per_scan": fwd * 1e3 / scans,
                        "meters_ms_per_scan": meters * 1e3 / scans, "report": report}
    print(f"inference ({scans} test scans, {out['inference']['slices']} slices, "
          f"{trainer._eval_out_size()}^2): Dice equals the trainer's eval epoch "
          f"(DSC_mean {dsc:.5f}) | HD95_mean {report['HD95_mean']:.4f} ASSD_mean "
          f"{report['ASSD_mean']:.4f} | forward (copy in, crop, eval forward, argmax, "
          f"copy out) {out['inference']['forward_ms_per_scan']:.3f} ms per scan | surface "
          f"meters and Dice on the host {out['inference']['meters_ms_per_scan']:.3f} ms per "
          f"scan", flush=True)
    del trainer, preds

    # ---- weight inspection from the encoder checkpoint, 2N = 60
    inspect_config = copy.deepcopy(CONFIG)
    inspect_config["Arch"]["checkpoint"] = str(encoder_ckpt) if encoder_ckpt else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = weight_inspection.inspect(inspect_config, str(base / "inspect"), device=DEVICE)
    torch.cuda.synchronize()
    out["inspect_s"] = time.perf_counter() - t0
    for g, d in got.items():
        check(d["sim_logits"].shape == (VIEWS, VIEWS), f"{g}: {d['sim_logits'].shape}")
        check(math.isfinite(d["loss"]) and 0.0 <= d["downgrade_ratio"] <= 1.0, f"{g}: {d}")
        check(bool(np.all((d["sp_mask"] >= 0) & (d["sp_mask"] <= 1))), f"{g}: sp_mask")
        check(np.array_equal(d["pos_mask"], d["pos_mask"].T), f"{g}: pos_mask not symmetric")
    with np.load(base / "inspect" / "weight_inspection.npz") as f:
        check(sorted(f.files) == sorted(INSPECT_KEYS), f"npz keys {sorted(f.files)}")
    print(f"weight inspection (2N={VIEWS}): {out['inspect_s']:.2f} s wall (trainer build, "
          f"warm start, one batch, four gammas, the npz) | "
          + " | ".join(f"{g}: loss {d['loss']:.4f} kept {d['downgrade_ratio']:.4f}"
                       for g, d in got.items()), flush=True)

    # ---- serving: the checkpoint exported in float32 and bf16, over HTTP
    slices = _serving_slices(config, max(SERVE_BATCHES) * 4)
    out["serving"] = {}
    for dtype in ("float32", "bfloat16"):
        cfg = _slice_i_config(dtype=dtype)
        path = base / f"unet256_{dtype}.spclt"
        t0 = time.perf_counter()
        crop = cfg["Data"]["crop"]
        meta = export_from_checkpoint(str(ckpt), str(path), config=cfg, height=crop, width=crop)
        export_s = time.perf_counter() - t0
        check(meta["input_shape"] == ["b", str(crop), str(crop), "1"] and meta["dtype"] == dtype,
              meta)
        model = build_model_from_config(cfg)
        model.load_state_dict(load_model_state_dict(str(ckpt)), strict=False)
        model.to(DEVICE).eval()
        server = make_http_server(str(path), host="127.0.0.1", port=0, device=DEVICE)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        try:
            _, err = _serve_requests(port, model, dtype, slices, 1, SLICE_I_WARMUP, "both",
                                     f"{dtype} warm-up")
            healthz_ms = _get_ms(port, "/healthz")
            rows = {}
            for batch in SERVE_BATCHES:
                row = {}
                for outputs in ("both", "pred"):
                    lat, e = _serve_requests(port, model, dtype, slices, batch,
                                             SLICE_I_REQUESTS, outputs, f"{dtype} batch {batch}")
                    err = max(err, e)
                    p50, p99 = _pcts(lat)
                    row[outputs] = {"p50_ms": p50, "p99_ms": p99,
                                    "slices_per_s": batch * len(lat) * 1e3 / sum(lat)}
                row["forward_ms"] = _forward_ms(model, slices, batch)
                row["call_ms"] = _served_call_ms(server, slices, batch, False)
                row["call_fresh_thread_ms"] = _served_call_ms(server, slices, batch, True)
                rows[batch] = row
                print(f"serving {dtype} batch {batch}: ?outputs=pred p50 "
                      f"{row['pred']['p50_ms']:.3f} ms p99 {row['pred']['p99_ms']:.3f} ms "
                      f"{row['pred']['slices_per_s']:.1f} slices/s | ?outputs=both p50 "
                      f"{row['both']['p50_ms']:.3f} ms p99 {row['both']['p99_ms']:.3f} ms "
                      f"{row['both']['slices_per_s']:.1f} slices/s | direct forward "
                      f"{row['forward_ms']:.3f} ms | the artifact's call + pred copied back "
                      f"on the server's device thread {row['call_ms']:.3f} ms, in a fresh thread "
                      f"{row['call_fresh_thread_ms']:.3f} ms ({SLICE_I_REQUESTS} requests each, "
                      f"every response held to the direct forward)", flush=True)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        check(not thread.is_alive(), "the HTTP server thread did not stop")
        out["serving"][dtype] = {"rows": rows, "err_over_tol": err, "export_s": export_s,
                                 "bytes": path.stat().st_size, "healthz_ms": healthz_ms}
        responses = SLICE_I_WARMUP + 2 * SLICE_I_REQUESTS * len(SERVE_BATCHES)
        print(f"serving {dtype}: artifact {path.stat().st_size / 2**20:.1f} MiB exported in "
              f"{export_s:.2f} s | GET /healthz {healthz_ms:.3f} ms (median of 20) | "
              f"largest |served - direct| logits / tolerance {err:.3g} "
              f"({'1e-4' if dtype == 'float32' else '2^-7 x max|logits|'}, TF32 off) over "
              f"{responses} responses, pred equal away from ties", flush=True)
        del model
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ slice K
SLICE_K_ARMS = ("scratch", "spsoft_corrupt")
SLICE_K_SEED = 10
SLICE_K_BUDGET = {"PRE_EPOCHS": 2, "PRE_BATCHES": 10, "FT_EPOCHS": 2, "FT_BATCHES": 10}
SLICE_K_EMBED_TOL = 1e-2    # relative L2, card (TF32 cuDNN) against the CPU
SLICE_K_SECONDS = 60.0


def slice_k_phase(sc):
    """The effect study's pipeline at a cut budget: `run_arm` for two arms,
    then the probe of the pretrained arm's checkpoint, card against CPU."""
    from spcl_torch.models import UNet
    from spcl_torch.scripts import effect_study as es
    from spcl_torch.scripts import probe_pretrain_features as probe
    from spcl_torch.training import load_model_state_dict

    budget = SLICE_K_BUDGET
    phase(f"slice K: the effect study (spcl_torch.scripts.effect_study + "
          f"probe_pretrain_features), UNet-128, crop {es.CROP} of {es.CANVAS}, synthetic hard, "
          f"seed {SLICE_K_SEED}, arms {', '.join(SLICE_K_ARMS)}, {budget['PRE_EPOCHS']} x "
          f"{budget['PRE_BATCHES']} pretrain and {budget['FT_EPOCHS']} x "
          f"{budget['FT_BATCHES']} fine-tune steps")
    out_dir = ROOT / "runs" / "chip_smoke_k"
    shutil.rmtree(out_dir, ignore_errors=True)
    saved = {k: getattr(es, k) for k in budget}
    t0 = time.perf_counter()
    recs = {}
    try:
        for k, v in budget.items():
            setattr(es, k, v)
        sc.reset_launch_counts()
        with _HeldSupcon(sc, "slice K") as held:
            for arm in SLICE_K_ARMS:
                recs[arm] = es.run_arm(arm, SLICE_K_SEED, device=DEVICE, out=out_dir)
                if arm == "scratch":
                    check(sum(sc.LAUNCHES.values()) == 0,
                          f"the fine-tune launched supcon kernels {dict(sc.LAUNCHES)}")
        launches = dict(sc.LAUNCHES)
    finally:
        for k, v in saved.items():
            setattr(es, k, v)
    run_s = time.perf_counter() - t0
    steps = budget["PRE_EPOCHS"] * budget["PRE_BATCHES"]
    check(launches == {"supcon_fwd": steps, "supcon_bwd": steps},
          f"slice K launches {launches}, want {steps} of each")
    shapes = sorted(set(held.shapes))
    views = sorted({v for _, _, v in held.calls})
    print(f"slice K supcon calls: {len(held.calls)} ({launches}), operands (kernel, rows, "
          f"columns) {shapes}, real views a call {views} (2N), each held to the plain "
          f"version: max err {held.max_err}", flush=True)
    for arm, rec in recs.items():
        print(f"slice K {arm}: " + json.dumps(rec), flush=True)
        check(0.0 <= rec["best_val_dice"] <= 1.0, f"{arm} DSC {rec['best_val_dice']}")
    pre_loss = recs["spsoft_corrupt"]["pretrain_loss"]
    check(pre_loss is not None and math.isfinite(pre_loss), f"pretrain loss {pre_loss}")
    check(recs["scratch"]["pretrain_loss"] is None, "scratch pretrained")
    ckpt = out_dir / f"spsoft_corrupt_s{SLICE_K_SEED}" / "pre" / "last.ckpt"
    UNet(max_channel=128).load_state_dict(load_model_state_dict(str(ckpt)), strict=True)

    t1 = time.perf_counter()
    feats, ds = probe.embed_dataset(str(ckpt), es.CANVAS, es.CROP, DEVICE)
    embed_s = time.perf_counter() - t1
    feats_cpu, _ = probe.embed_dataset(str(ckpt), es.CANVAS, es.CROP, "cpu")
    rel = float(np.linalg.norm(feats - feats_cpu) / np.linalg.norm(feats_cpu))
    acc, acc_cpu = probe.probe_accuracy(feats, ds), probe.probe_accuracy(feats_cpu, ds)
    print(f"slice K probe: {feats.shape[0]} slices x {feats.shape[1]} features in "
          f"{embed_s:.3f} s on the card; relative L2 against the CPU {rel:.3e} (tolerance "
          f"{SLICE_K_EMBED_TOL}); probe accuracy card {acc:.4f}, CPU {acc_cpu:.4f}", flush=True)
    check(np.all(np.isfinite(feats)) and rel <= SLICE_K_EMBED_TOL,
          f"card embedding {rel:.3e} from the CPU's")
    phase_s = time.perf_counter() - t0
    print(f"slice K: runs {run_s:.1f} s, whole phase {phase_s:.1f} s", flush=True)
    check(phase_s < SLICE_K_SECONDS, f"slice K took {phase_s:.1f} s")
    out = {"launches": launches, "max_err": held.max_err, "shapes": shapes, "records": recs,
           "embed_rel": rel, "probe": acc, "phase_s": phase_s}
    print("slice_k " + json.dumps(out), flush=True)
    return out


# ------------------------------------------------------------------ slice L
SLICE_L_STEPS = 5           # (a): 1 epoch of slice A's 5 steps
SLICE_L_RANKS = 2           # (b): ranks started by hand, as on several hosts
SLICE_L_RANK_S = 300.0      # a rank process's time limit
SLICE_L_HOOK = "infonce/Conv5/partition"
# (b) holds the ranks to each other and to one process at the bounds of
# tests/test_torch_multihost.py, with cuDNN's TF32 off in all three
# processes (TF32 keeps ~3 digits; slice C, with it on, needs 1e-3)
SLICE_L_RANKS_RTOL = 1e-6
SLICE_L_ONE_RTOL = 1e-5
# (b) pretrains at tests/torch_multihost_worker.py's rate, not CONFIG's
# 1e-7: there a step moves a weight by ~1e-11, under float32's resolution at
# the weights' size, so that neither the losses nor the weights could show a
# wrong reduction of the gradients. The pretrain's weight moves are held
# between the ranks at SLICE_L_RANKS_RTOL and against one process at
# SLICE_L_MOVES_RTOL, above the distance of two runs of one process (cuDNN's
# non-deterministic algorithms), which (b) measures and prints, and far
# below that of ranks that average the gradients instead of summing them
# (PERF.md, slice L). The fine-tune keeps CONFIG's rate:
# at 1e-4 its DSC of ~0.02 moves by ~1e-5 between runs of one process, the
# bound it is held to
SLICE_L_OPTIM = {"name": "RAdam", "lr": 1e-4, "weight_decay": 1e-5}
SLICE_L_MOVES_RTOL = 2e-3
SLICE_L_PROJECTIONS = 4


def _moves(trainer, start):
    """Per tensor of the optimizer: its move since `start` as its L2 norm
    and SLICE_L_PROJECTIONS projections on fixed Gaussian directions (seeded
    by the tensor's index), float64 on the host; two runs' rows differ by
    about the distance of their moves."""
    params = [p for g in trainer._optimizer.param_groups for p in g["params"]]
    out = []
    for i, (p, p0) in enumerate(zip(params, start)):
        d = (p.detach() - p0).double().cpu().reshape(-1)
        dirs = torch.randn(SLICE_L_PROJECTIONS, d.numel(), dtype=torch.float64,
                           generator=torch.Generator().manual_seed(i))
        out.append([float(d.norm())] + (dirs @ d).tolist())
    return out


def _apart(a, b) -> float:
    """Distance of two runs' `_moves` relative to the second's size."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _config_l(name="infoncepretrain", **trainer):
    """CONFIG (selfpaced_infonce.yaml's UNet-256 at 224 of 256, 2N=60)
    without its SPInfonceParams, under `Trainer.name` (infoncepretrain: the
    `infonce` preset's InfonceParams take their place)."""
    config = copy.deepcopy(CONFIG)
    del config["SPInfonceParams"]
    config["Trainer"].update(name=name, **trainer)
    return config


def slice_l_rank(out_dir, nprocs):
    """One process of slice L (b), started as `python3 chip_smoke.py
    --slice-l-rank OUT_DIR NPROCS`: with NPROCS 2 one rank of a run whose
    SPCL_* variables its starter set, joined through
    `initialize_distributed`; with 1 the process alone. A pretrain pair
    under infoncepretrain and a fine-tune with eval, `Trainer.mesh: auto`
    (0 alone); prints one JSON line."""
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    from spcl_torch.entry import build_trainer
    from spcl_torch.ops import supcon_cuda as sc
    from spcl_torch.parallel import mesh
    from spcl_torch.utils import fix_all_seed
    if nprocs > 1:
        mesh.initialize_distributed(device=DEVICE, timeout_s=SLICE_L_RANK_S)
    me = Path(out_dir) / f"p{mesh.rank()}"
    spec = "auto" if nprocs > 1 else 0

    def build(config):
        fix_all_seed(config["RandomSeed"])
        trainer = build_trainer(config, save_dir=config["Trainer"]["save_dir"], device=DEVICE)
        trainer.init()
        start = [p.detach().clone() for g in trainer._optimizer.param_groups
                 for p in g["params"]]
        return trainer, start

    pre_config = _config_l(mesh=spec, max_epoch=2, num_batches=2, save_dir=str(me / "pre"))
    pre_config["Optim"] = dict(SLICE_L_OPTIM)
    pre, pre_start = build(pre_config)
    sc.reset_launch_counts()
    with _HeldSupcon(sc, f"slice L rank {mesh.rank()}") as held:
        pre.start_training()
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    ft_config = _config_l("finetune", mesh=spec, max_epoch=1, num_batches=2,
                          save_dir=str(me / "ft"))
    ft_config["LabeledLoader"]["batch_size"] = 4   # no pad row in the BatchNorm sums
    ft, _ = build(ft_config)
    best = float(ft.start_training())
    print(json.dumps({
        "rank": mesh.rank(), "world": mesh.world_size(),
        "backend": dist.get_backend() if mesh.active() else None,
        "device": str(pre._device), "n_shards": [pre.n_shards, ft.n_shards],
        "trainer": type(pre).__name__, "forward_until": pre._forward_until,
        "hooks": [h.name for h in pre._hooks], "launches": launches, "max_err": held.max_err,
        "pre_losses": [m["reg_loss"] for m in pre.step_metrics],
        "ft_losses": [m["sup_loss"] for m in ft.step_metrics], "best_dice": best,
        "moves": _moves(pre, pre_start),
        "files": sorted(str(f.relative_to(me)) for f in me.rglob("*") if f.is_file())
        if me.is_dir() else []}), flush=True)
    mesh.shutdown()


def _start_ranks_by_hand(out_dir):
    """Slice L (b)'s processes: SLICE_L_RANKS ranks with the SPCL_* and local
    variables set, as a user starts them on each host, and two alone;
    returns their records (ranks in order, then the two alone)."""
    import os
    from spcl_torch.parallel import mesh
    port = mesh.free_port()
    base = {k: v for k, v in os.environ.items() if not k.startswith("SPCL_")}
    starts = [({**base, mesh.ENV_COORDINATOR: f"localhost:{port}",
                mesh.ENV_NUM_PROCESSES: str(SLICE_L_RANKS), mesh.ENV_PROCESS_ID: str(r),
                mesh.ENV_LOCAL_RANK: str(r), mesh.ENV_LOCAL_WORLD_SIZE: str(SLICE_L_RANKS)},
               out_dir / "mh", SLICE_L_RANKS) for r in range(SLICE_L_RANKS)]
    starts += [(base, out_dir / "one", 1), (base, out_dir / "one_again", 1)]
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for i, (env, where, n) in enumerate(starts):
            log = out_dir / f"process{i}.log"
            with open(log, "w") as f:
                procs.append((log, subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--slice-l-rank", str(where),
                     str(n)], env=env, cwd=str(ROOT), stdout=f, stderr=subprocess.STDOUT)))
        for log, p in procs:
            rc = p.wait(timeout=SLICE_L_RANK_S)
            check(rc == 0, f"slice L process {log.name} exited {rc}:\n"
                  + log.read_text()[-4000:])
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return [json.loads([line for line in log.read_text().splitlines()
                        if line.startswith("{")][-1]) for log, _ in procs]


def slice_l_phase(sc):
    """(a) `Trainer.name: infoncepretrain` on slice A's path; (b) ranks
    started by hand with the SPCL_* variables under `Trainer.mesh: auto`,
    against one process."""
    from spcl_torch.entry import build_trainer
    from spcl_torch.models import UNet
    from spcl_torch.training import PretrainEncoderTrainer, load_model_state_dict
    out_dir = ROOT / "runs" / "chip_smoke_l"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    phase(f"slice L (a): Trainer.name infoncepretrain, UNet-256, 224^2, 2N={MAIN_2N}, nhwc, "
          f"{SLICE_L_STEPS} steps")
    config = _config_l(max_epoch=1, num_batches=SLICE_L_STEPS, save_dir=str(out_dir / "a"))
    trainer = build_trainer(config, save_dir=str(out_dir / "a"), device=DEVICE)
    check(type(trainer) is PretrainEncoderTrainer and trainer._forward_until == "Conv5",
          f"infoncepretrain built {type(trainer).__name__} to {trainer._forward_until}")
    check([h.name for h in trainer._hooks] == [SLICE_L_HOOK],
          f"hooks {[h.name for h in trainer._hooks]}")
    trainer.init()
    sc.reset_launch_counts()
    with _HeldSupcon(sc, "slice L") as held:
        trainer.start_training()
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    check(launches == {"supcon_fwd": SLICE_L_STEPS, "supcon_bwd": SLICE_L_STEPS},
          f"slice L launches {launches}, want {SLICE_L_STEPS} of each")
    losses = [m["reg_loss"] for m in trainer.step_metrics]
    check(len(losses) == SLICE_L_STEPS and all(math.isfinite(v) for v in losses),
          f"slice L losses {losses}")
    UNet(input_dim=1, num_classes=4, max_channel=CONFIG["Arch"]["max_channel"]).load_state_dict(
        load_model_state_dict(str(out_dir / "a" / "last.ckpt")), strict=True)
    a_s = time.perf_counter() - t0
    print(f"slice L (a): {type(trainer).__name__}, forward_until {trainer._forward_until}, "
          f"hooks {[h.name for h in trainer._hooks]}; launches {launches}, operands (kernel, "
          f"rows, columns) {sorted(set(held.shapes))}, each call held to the plain version: "
          f"max err {held.max_err}; reg_loss {', '.join(f'{v:.6f}' for v in losses)}; "
          f"last.ckpt reloads strictly; {a_s:.1f} s", flush=True)
    del trainer
    torch.cuda.empty_cache()

    cards = torch.cuda.device_count()
    phase(f"slice L (b): {SLICE_L_RANKS} ranks started by hand (SPCL_COORDINATOR, "
          f"SPCL_NUM_PROCESSES, SPCL_PROCESS_ID, SPCL_LOCAL_RANK, SPCL_LOCAL_WORLD_SIZE) under "
          f"Trainer.mesh: auto beside one process (twice), infoncepretrain 2 x 2 steps at "
          f"RAdam {SLICE_L_OPTIM['lr']:g} then a fine-tune of 2 steps with eval, UNet-256, "
          f"224^2, cuDNN TF32 off")
    t1 = time.perf_counter()
    *ranks, one, again = _start_ranks_by_hand(out_dir / "b")
    b_s = time.perf_counter() - t1
    want_backend = "nccl" if cards >= SLICE_L_RANKS else "gloo"
    print(f"slice L (b): {cards} card(s) on this host, {SLICE_L_RANKS} local ranks: backend "
          f"{ranks[0]['backend']}, devices {[r['device'] for r in ranks]}; NCCL across hosts "
          f"is not shown here (one host)", flush=True)
    for r in ranks + [one]:
        print(f"slice L (b) {'rank ' + str(r['rank']) if r['world'] > 1 else 'one process'}: "
              f"world {r['world']}, n_shards {r['n_shards']}, launches {r['launches']}, "
              f"max err {r['max_err']}, reg_loss {r['pre_losses']}, sup_loss {r['ft_losses']}, "
              f"best DSC {r['best_dice']}", flush=True)
    check(all(r["world"] == SLICE_L_RANKS and r["n_shards"] == [SLICE_L_RANKS] * 2
              for r in ranks), "a rank trained outside the 2-rank run")
    check(one["world"] == 1 and one["n_shards"] == [1, 1], f"one process: {one['n_shards']}")
    check(all(r["backend"] == want_backend for r in ranks),
          f"backends {[r['backend'] for r in ranks]}, want {want_backend}")
    if cards < SLICE_L_RANKS:
        check(all(r["device"] == "cuda:0" for r in ranks), "the ranks do not share card 0")
    steps = 2 * 2
    for r in ranks + [one]:
        check(r["trainer"] == "PretrainEncoderTrainer" and r["forward_until"] == "Conv5"
              and r["hooks"] == [SLICE_L_HOOK], f"process {r['rank']} built {r['trainer']}")
        check(r["launches"] == {"supcon_fwd": steps, "supcon_bwd": steps},
              f"launches {r['launches']}")
        check(0.0 <= r["best_dice"] <= 1.0, f"DSC {r['best_dice']}")
    for key in ("pre_losses", "ft_losses", "best_dice"):
        a, b, c = (np.asarray(x[key], np.float64) for x in (ranks[0], ranks[1], one))
        check(np.all(np.isfinite(a)) and np.all(np.isfinite(c)), f"non-finite {key}")
        ranks_rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
        one_rel = float(np.max(np.abs(a - c) / np.maximum(np.abs(c), 1e-30)))
        print(f"slice L (b) {key}: ranks apart by {ranks_rel:.2e} (rtol {SLICE_L_RANKS_RTOL}), "
              f"rank 0 from one process {one_rel:.2e} (rtol {SLICE_L_ONE_RTOL})", flush=True)
        check(ranks_rel <= SLICE_L_RANKS_RTOL and one_rel <= SLICE_L_ONE_RTOL,
              f"slice L (b) {key} disagree")
    a, b, c = (x["moves"] for x in (ranks[0], ranks[1], one))
    size = float(np.linalg.norm(np.asarray(c)[:, 0]))
    ranks_rel, one_rel = _apart(a, b), _apart(a, c)
    print(f"slice L (b) weights moved by the pretrain: {size:.3e} (L2, one process); ranks "
          f"apart by {ranks_rel:.2e} (rtol {SLICE_L_RANKS_RTOL}), rank 0 from one process "
          f"{one_rel:.2e} (rtol {SLICE_L_MOVES_RTOL}); one process from itself "
          f"{_apart(again['moves'], c):.2e}", flush=True)
    check(size > 0 and ranks_rel <= SLICE_L_RANKS_RTOL and one_rel <= SLICE_L_MOVES_RTOL,
          "slice L (b) pretrain weights disagree")
    print(f"slice L (b) files of rank 0: {ranks[0]['files']} | of rank 1: {ranks[1]['files']}",
          flush=True)
    check(ranks[1]["files"] == [], f"rank 1 wrote {ranks[1]['files']}")
    for f in ("pre/last.ckpt", "ft/best.ckpt", "ft/storage.csv"):
        check(f in ranks[0]["files"], f"rank 0 did not write {f}")
    phase_s = time.perf_counter() - t0
    print(f"slice L: (a) {a_s:.1f} s, (b) {b_s:.1f} s, whole phase {phase_s:.1f} s", flush=True)
    return {"launches": launches, "max_err": held.max_err, "rank_launches": ranks[0]["launches"],
            "rank_max_err": {k: max(r["max_err"][k] for r in ranks + [one])
                             for k in held.max_err},
            "backend": ranks[0]["backend"], "devices": [r["device"] for r in ranks],
            "a_s": a_s, "b_s": b_s}


SLICE_M_STEPS = 3
SLICE_M_TIMED = 10           # steps a turn, in the turns packed, nhwc, nhwc, packed
SLICE_M_PROFILED = 5         # steps under torch.profiler, each layout
SLICE_M_LOSS_RTOL = 1e-4     # per-step reg_loss, packed against nhwc (TF32 off)
SLICE_M_STAT_TOL = 1e-4      # running variances' batch shares, x the layer's largest
SLICE_M_LOGIT_TOL = 1e-4     # x max|logits|: packed against nhwc given its statistics
SLICE_M_EVAL_SLICES = 8


def _bessel_shares(trainer, stage):
    """The batches' share of a BatchNorm pair's running variance after its k
    updates from the initial ones (all 1): r - (1 - m)^k, float64."""
    block = trainer._model.stage(stage).conv
    return [(bn.running_var.double() - (1.0 - bn.momentum) ** int(bn.num_batches_tracked)).cpu()
            for bn in (block[1], block[4])]


def slice_m_phase(sc):
    """`Arch.small_c_layout: packed` on slice B's configuration beside
    `nhwc`, from the same weights and draws, cuDNN TF32 off."""
    from spcl_torch.entry import build_trainer
    from spcl_torch.models import UNet
    from spcl_torch.training import load_model_state_dict
    from spcl_torch.utils import fix_all_seed
    phase(f"slice M: small_c_layout packed beside nhwc, UNet-256, 224^2, 2N={MAIN_2N}, "
          f"{SLICE_M_STEPS} pretrain steps each, cuDNN TF32 off")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "runs" / "chip_smoke_m"
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    trainers, launches, losses, held = {}, {}, {}, {}
    start = None
    for layout in ("packed", "nhwc"):
        config = copy.deepcopy(CONFIG)
        config["Arch"]["small_c_layout"] = layout
        config["Trainer"].update(max_epoch=1, num_batches=SLICE_M_STEPS,
                                 save_dir=str(out_dir / layout))
        fix_all_seed(config["RandomSeed"])  # the same draws in both runs
        trainer = build_trainer(config, save_dir=str(out_dir / layout), pretrain=True,
                                device=DEVICE)
        check(trainer._model.small_c_layout == layout, trainer._model.small_c_layout)
        if start is None:
            start = copy.deepcopy(trainer._model.state_dict())
        trainer._model.load_state_dict(start)
        trainer.init()
        sc.reset_launch_counts()
        with _HeldSupcon(sc, f"slice M {layout}") as h:
            trainer.start_training()
        torch.cuda.synchronize()
        launches[layout], held[layout] = dict(sc.LAUNCHES), h
        check(launches[layout] == {"supcon_fwd": SLICE_M_STEPS, "supcon_bwd": SLICE_M_STEPS},
              f"slice M {layout} launches {launches[layout]}")
        losses[layout] = [m["reg_loss"] for m in trainer.step_metrics]
        check(len(losses[layout]) == SLICE_M_STEPS
              and all(math.isfinite(v) for v in losses[layout]), f"{layout} {losses[layout]}")
        UNet(input_dim=1, num_classes=4, max_channel=CONFIG["Arch"]["max_channel"]).load_state_dict(
            load_model_state_dict(str(out_dir / layout / "last.ckpt")), strict=True)
        trainers[layout] = trainer
    packed, nhwc = trainers["packed"], trainers["nhwc"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["packed"], losses["nhwc"])]
    print(f"slice M reg_loss packed {losses['packed']} | nhwc {losses['nhwc']} | apart by "
          f"{max(rel):.2e} (rtol {SLICE_M_LOSS_RTOL}); launches {launches['packed']} a run, "
          f"each call held to the plain version: max err {held['packed'].max_err}", flush=True)
    check(max(rel) <= SLICE_M_LOSS_RTOL, "slice M losses disagree")

    # running variances: Conv1/Conv2's batch shares stand in Bessel's ratio
    # n/(n-1) (n values a channel: 2N x H x W), Conv3's (nhwc in both) equal
    crop = CONFIG["Data"]["crop"]
    n_values = {"Conv1": VIEWS * crop * crop, "Conv2": VIEWS * (crop // 2) ** 2, "Conv3": None}
    for stage, n in n_values.items():
        ratio = n / (n - 1) if n else 1.0
        got = max(float((b - a * ratio).abs().max() / a.abs().max()) for a, b in zip(
            _bessel_shares(packed, stage), _bessel_shares(nhwc, stage)))
        print(f"slice M {stage} running variance, |nhwc share - packed share x "
              f"{'n/(n-1)' if n else '1'}| / max packed share: {got:.2e} (tol "
              f"{SLICE_M_STAT_TOL}; Bessel's factor - 1 = {ratio - 1:.2e}"
              f"{', n = %d' % n if n else ''})", flush=True)
        check(got <= SLICE_M_STAT_TOL, f"slice M {stage} running variances")
    tracked = {layout: [int(t._model.stage(st).conv[i].num_batches_tracked)
                        for st in ("Conv1", "Conv2", "Conv3") for i in (1, 4)]
               for layout, t in trainers.items()}
    check(tracked["packed"] == tracked["nhwc"] and min(tracked["packed"]) > 0,
          f"slice M BatchNorm updates {tracked}")

    # eval mode: packed's logits are nhwc's given packed's running statistics
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    x = torch.rand(SLICE_M_EVAL_SLICES, 1, crop, crop, device=DEVICE, generator=gen)
    twin = UNet(input_dim=1, num_classes=4, max_channel=CONFIG["Arch"]["max_channel"]).to(DEVICE)
    twin.load_state_dict(packed._model.state_dict(), strict=True)
    logits = {}
    with torch.no_grad():
        for what, model in (("packed", packed._model), ("nhwc", nhwc._model),
                            ("twin", twin)):
            model.eval()
            logits[what] = model(x)["logits"].double()
            model.train()
    scale = float(logits["packed"].abs().max())
    twin_err = float((logits["packed"] - logits["twin"]).abs().max())
    own_err = float((logits["packed"] - logits["nhwc"]).abs().max())
    print(f"slice M eval logits (max {scale:.3f}): packed against nhwc given packed's running "
          f"statistics {twin_err:.2e} (tol {SLICE_M_LOGIT_TOL} x max), against nhwc's own "
          f"run {own_err:.2e}", flush=True)
    check(twin_err <= SLICE_M_LOGIT_TOL * scale, "slice M eval logits disagree")

    # the held runs' steps were eager: the same steps replayed as a CUDA graph
    # against eager ones, both layouts here and the bf16 pallas path
    graphed = {}
    for layout, dtype in (("packed", "float32"), ("nhwc", "float32"), ("pallas", "bfloat16")):
        def make_trainer(layout=layout, dtype=dtype):
            config = copy.deepcopy(CONFIG)
            config["Arch"].update(small_c_layout=layout, dtype=dtype)
            save = out_dir / f"graphed_{layout}_{dtype}"
            config["Trainer"].update(max_epoch=1, num_batches=SLICE_M_STEPS, save_dir=str(save))
            fix_all_seed(config["RandomSeed"])
            trainer = build_trainer(config, save_dir=str(save), pretrain=True, device=DEVICE)
            trainer._model.load_state_dict(start)
            trainer.init()
            return trainer
        graphed[f"{layout}_{dtype}"] = _graphed_against_eager(
            f"slice M {layout} {dtype}", make_trainer, SLICE_M_STEPS)

    ms = {"packed": [], "nhwc": []}
    for layout in ("packed", "nhwc", "nhwc", "packed"):
        run = _pretrain_epochs(trainers[layout])
        run(1)
        ms[layout].append(run(SLICE_M_TIMED))
    steps_ms = {k: min(v) for k, v in ms.items()}
    print(f"slice M step times (H100 card above, TF32 off, {SLICE_M_TIMED} steps a turn, "
          f"turns packed, nhwc, nhwc, packed, best turn): packed {steps_ms['packed']:.3f} "
          f"ms/step, nhwc {steps_ms['nhwc']:.3f} ms/step (turns: packed "
          f"{', '.join(f'{v:.3f}' for v in ms['packed'])}; nhwc "
          f"{', '.join(f'{v:.3f}' for v in ms['nhwc'])})", flush=True)
    # device time by kernel: the wall of this host-bound step moves from run
    # to run by more than the two layouts differ
    kernel_ms, profiled_launches = {}, {}
    for layout in ("packed", "nhwc"):
        kernels, profiled_launches[layout] = _launches_against_profile(
            f"slice M {layout} profiled", _pretrain_epochs(trainers[layout]), SLICE_M_PROFILED)
        prof = _print_profile(f"slice M {layout}", kernels, steps_ms[layout], top=8)
        kernel_ms[layout] = prof[0] if prof else float("nan")
    phase_s = time.perf_counter() - t0
    print(f"slice M kernel time: packed {kernel_ms['packed']:.3f} ms/step, nhwc "
          f"{kernel_ms['nhwc']:.3f} ms/step; phase {phase_s:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults again
    del trainers, packed, nhwc, twin
    torch.cuda.empty_cache()
    return {"launches": launches["packed"], "nhwc_launches": launches["nhwc"],
            "max_err": {k: max(h.max_err[k] for h in held.values())
                        for k in held["packed"].max_err},
            "ms": steps_ms, "kernel_ms": kernel_ms, "phase_s": phase_s, "graphed": graphed,
            "profiled_launches": profiled_launches}


SLICE_N_CUTOUT = (16, 112)   # Cutout box sizes: up to half the 224^2 crop
SLICE_N_PAD = -1.0           # the Cutout fill: no input pixel has it (inputs in [0, 1))
SLICE_N_SOBEL_TOL = 1e-6     # x max|g|, card against the CPU
SLICE_N_SPARSE = 2.0         # features relu(N(0, 1) - 2): 2.3% non-zero, tied zero windows
SLICE_N_DECODER = (18, 32, 112, 112)   # slice F's Up_conv3 features (2 x 3 scans x 3)
# card against the CPU, both in float32 (TF32 off in cuBLAS, PyTorch's default, and in
# cuDNN around the dense head): outputs and the projection head's gradients x the CPU's
# max|.|, float32 sums in another order (~2^-24 x sqrt(K), K <= 1024 summed terms)
SLICE_N_HEAD_TOL = 1e-5
SLICE_N_PARAM_RTOL = 1e-4    # the dense head's parameter gradients, relative L2
# the dense head's input gradient, relative L2: its 1x1 convolutions run before the max,
# so a bin whose top two values lie within float32 rounding may keep its maximum at
# another pixel on the card (~3e-3 of the norm per such bin; their count is printed)
SLICE_N_DX_RTOL = 1e-2
SLICE_N_REPS = 20


def _rel_l2(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30))


def _maxima(heads, y, size):
    """Where each adaptive bin of [B, C, H, W] `y` takes its maximum, as the
    pool's own gathered windows [B, C, oh, kh, ow, kw]."""
    win = heads.bin_windows(y, size)
    return win == torch.amax(win, dim=(3, 5), keepdim=True)


def _head_on_both(head_cpu, feats, ct, pre_pool=None):
    """Forward and backward of `head_cpu` and of its copy on the card on the
    same features and cotangent: {"cpu" | "card": (out, dx, param grads,
    pre-pool)}."""
    head_card = copy.deepcopy(head_cpu).to(DEVICE)
    results = {}
    for where, dev, head in (("cpu", "cpu", head_cpu), ("card", DEVICE, head_card)):
        kept = []
        hook = (getattr(head, pre_pool).register_forward_hook(
            lambda m, i, o: kept.append(o.detach())) if pre_pool else None)
        x = feats.detach().to(dev).requires_grad_(True)
        out = head(x)
        out.backward(ct.to(dev))
        if hook is not None:
            hook.remove()
        results[where] = (out.detach().cpu(), x.grad.cpu(),
                        {n: p.grad.cpu() for n, p in head.named_parameters()},
                        kept[0] if kept else None)
    return results, head_card


def slice_n_phase(sc, cs, smi):
    """The last of spcl_tpu's public surface on the card: Cutout and Sobel on
    slice A's batch, the projection heads pooling by maximum (JAX's tie
    rule) at Conv5's and slice F's Up_conv3's shapes, card against the CPU."""
    from spcl_torch.data import augment as aug
    from spcl_torch.models import heads
    from spcl_torch.models.heads import DenseProjectionHead, ProjectionHead
    crop = CONFIG["Data"]["crop"]
    phase(f"slice N: Cutout and Sobel on 2N={MAIN_2N} one-channel {crop}^2 slices; "
          f"ProjectionHead / DenseProjectionHead pooling by maximum; card against the CPU")
    t0 = time.perf_counter()
    sc.reset_launch_counts()
    cs.reset_launch_counts()
    print(f"slice N precision: cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    ms = {}

    # (a) Cutout and Sobel
    gen = torch.Generator(device=DEVICE).manual_seed(CONFIG["RandomSeed"])
    x = torch.rand(MAIN_2N, 1, crop, crop, device=DEVICE, generator=gen)
    params = aug.sample_cutout(gen, MAIN_2N, crop, crop, *SLICE_N_CUTOUT, device=DEVICE)
    cut = aug.apply_cutout(x, params, pad_value=SLICE_N_PAD)
    cut_cpu = aug.apply_cutout(x.cpu(), {k: v.cpu() for k, v in params.items()},
                               pad_value=SLICE_N_PAD)
    check(torch.equal(cut.cpu(), cut_cpu), "slice N Cutout: card and CPU differ")
    half = params["box"] // 2
    check(((params["box"] >= SLICE_N_CUTOUT[0]) & (params["box"] <= SLICE_N_CUTOUT[1])).all()
          and (params["yc"] - half >= 0).all() and (params["yc"] + half <= crop).all()
          and (params["xc"] - half >= 0).all() and (params["xc"] + half <= crop).all(),
          f"slice N Cutout boxes leave the image: {params}")
    erased = (cut == SLICE_N_PAD).sum(dim=(1, 2, 3))
    check(torch.equal(erased, 4 * half * half), "slice N Cutout erased other pixels")
    sob = aug.sobel_process(cut, include_origin=True)
    sob_cpu = aug.sobel_process(cut_cpu, include_origin=True)
    check(sob.shape == (MAIN_2N, 3, crop, crop) and bool(torch.isfinite(sob).all()),
          f"slice N Sobel {tuple(sob.shape)}")
    scale = float(sob_cpu[:, :2].abs().max())
    sobel_err = float((sob[:, :2].cpu() - sob_cpu[:, :2]).abs().max())
    check(torch.equal(sob[:, 2:].cpu(), cut_cpu), "slice N Sobel's origin channel")
    print(f"slice N Cutout boxes {SLICE_N_CUTOUT[0]}..{SLICE_N_CUTOUT[1]}: card = CPU to the "
          f"bit, {int(erased.sum())} pixels erased in {MAIN_2N} slices; Sobel (include_origin) "
          f"card against CPU {sobel_err:.2e} (max|g| {scale:.3f}, tol {SLICE_N_SOBEL_TOL} x "
          f"max|g|)", flush=True)
    check(sobel_err <= SLICE_N_SOBEL_TOL * scale, "slice N Sobel: card and CPU differ")
    ms["sample_cutout"] = _time_ms(lambda: aug.sample_cutout(
        gen, MAIN_2N, crop, crop, *SLICE_N_CUTOUT, device=DEVICE), SLICE_N_REPS)
    ms["apply_cutout"] = _time_ms(lambda: aug.apply_cutout(x, params), SLICE_N_REPS)
    ms["sobel_process"] = _time_ms(lambda: aug.sobel_process(x), SLICE_N_REPS)

    # (b) the heads, pooling by maximum, on sparse post-ReLU features
    cpu_gen = torch.Generator().manual_seed(CONFIG["RandomSeed"])
    holds = {}
    conv5 = torch.relu(torch.randn(MAIN_2N, 256, 14, 14, generator=cpu_gen) - SLICE_N_SPARSE)
    for spatial in ((1, 1), (2, 2)):
        torch.manual_seed(spatial[0])
        head = ProjectionHead(256, output_dim=256, hidden_dim=256, pool_name="adaptive_max",
                              spatial_size=spatial)
        pooled = heads.adaptive_max_pool(conv5, spatial)
        tied = int((pooled == 0).sum())  # all-zero bins: every position a maximum
        ct = torch.randn(MAIN_2N, 256, generator=cpu_gen)
        res, head_card = _head_on_both(head, conv5, ct)
        (out_c, dx_c, g_c, _), (out_g, dx_g, g_g, _) = res["cpu"], res["card"]
        errs = {"out": float((out_g - out_c).abs().max() / out_c.abs().max()),
                "dx": float((dx_g - dx_c).abs().max() / dx_c.abs().max()),
                "params": max(float((g_g[n] - g_c[n]).abs().max() / g_c[n].abs().max())
                              for n in g_c)}
        what = f"ProjectionHead {spatial[0]}x{spatial[1]}"
        print(f"slice N {what} on [{MAIN_2N}, 256, 14, 14] ({tied} tied all-zero bins of "
              f"{pooled.numel()}): card against CPU, x max|CPU|: out {errs['out']:.2e}, dx "
              f"{errs['dx']:.2e}, parameter grads {errs['params']:.2e} (tol "
              f"{SLICE_N_HEAD_TOL})", flush=True)
        check(tied > 0 and max(errs.values()) <= SLICE_N_HEAD_TOL, f"slice N {what} {errs}")
        holds[what] = errs
        feats = conv5.detach().to(DEVICE).requires_grad_(True)
        ct_card = ct.to(DEVICE)
        ms[f"{what} fwd+bwd"] = _time_ms(
            lambda: head_card(feats).backward(ct_card), SLICE_N_REPS)

    torch.manual_seed(3)
    # slice F's head as the InfoNCE hook builds it (output 256, hidden 256)
    dense = DenseProjectionHead(SLICE_N_DECODER[1], output_dim=256, hidden_dim=256,
                                pool_name="adaptive_max", spatial_size=(10, 10))
    up3 = torch.relu(torch.randn(*SLICE_N_DECODER, generator=cpu_gen) - SLICE_N_SPARSE)
    zero_px = float((up3.abs().sum(dim=1) == 0).float().mean())
    ct = torch.randn(SLICE_N_DECODER[0], 256, 10, 10, generator=cpu_gen)
    torch.backends.cudnn.allow_tf32 = False
    res, dense_card = _head_on_both(dense, up3, ct, pre_pool="conv1")
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default again
    (out_c, dx_c, g_c, y_c), (out_g, dx_g, g_g, y_g) = res["cpu"], res["card"]
    moved = int((_maxima(heads, y_c, (10, 10)) != _maxima(heads, y_g.cpu(), (10, 10)))
                .any(dim=(3, 5)).sum())
    errs = {"out": float((out_g - out_c).abs().max() / out_c.abs().max()),
            "params": max(_rel_l2(g_g[n], g_c[n]) for n in g_c), "dx": _rel_l2(dx_g, dx_c)}
    print(f"slice N DenseProjectionHead 10x10 on {list(SLICE_N_DECODER)} ({zero_px:.1%} of "
          f"pixels all-zero: equal MLP outputs, tied maxima; {moved} of {y_c.shape[0] * 25600} "
          f"bins with their maxima elsewhere on the card), cuDNN TF32 off: out "
          f"{errs['out']:.2e} x max|CPU| (tol {SLICE_N_HEAD_TOL}), parameter grads "
          f"{errs['params']:.2e} relative L2 (tol {SLICE_N_PARAM_RTOL}), dx {errs['dx']:.2e} "
          f"relative L2 (tol {SLICE_N_DX_RTOL})", flush=True)
    check(errs["out"] <= SLICE_N_HEAD_TOL and errs["params"] <= SLICE_N_PARAM_RTOL
          and errs["dx"] <= SLICE_N_DX_RTOL, f"slice N DenseProjectionHead {errs}")
    holds["DenseProjectionHead 10x10"] = dict(errs, moved_bins=moved)
    feats = up3.detach().to(DEVICE).requires_grad_(True)
    ct_card = ct.to(DEVICE)
    ms["DenseProjectionHead 10x10 fwd+bwd"] = _time_ms(
        lambda: dense_card(feats).backward(ct_card), SLICE_N_REPS)
    # the pool alone beside the library's max pool (one index at ties)
    y = y_g.requires_grad_(True)
    g = torch.randn(SLICE_N_DECODER[0], 256, 10, 10, device=DEVICE)
    for name, pool in (("adaptive_max_pool", heads.adaptive_max_pool),
                       ("F.adaptive_max_pool2d", torch.nn.functional.adaptive_max_pool2d)):
        ms[f"{name} 10x10 fwd+bwd"] = _time_ms(lambda: pool(y, (10, 10)).backward(g),
                                               SLICE_N_REPS)
    torch.cuda.synchronize()
    launched = {**sc.LAUNCHES, **cs.LAUNCHES, **cs.LAUNCHES_BF16}
    check(not any(launched.values()), f"slice N launched kernels {launched}")
    phase_s = time.perf_counter() - t0
    print(f"slice N ms a call ({smi}; cuDNN TF32 on, PyTorch's default; CUDA events, "
          f"{SLICE_N_REPS} calls): " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f"; phase {phase_s:.1f} s", flush=True)
    del dense_card, feats, y
    torch.cuda.empty_cache()
    return {"ms": ms, "holds": holds, "sobel_err": sobel_err, "phase_s": phase_s}


STAGE_WHY = ("no single PyTorch call computes this pass: it fuses BatchNorm, ReLU or the "
             "pool with its statistics")


def _stage_entry(cs, name, suffix, results, launches, by_path):
    """The kernels line's entry of stage pass `name` (`suffix` "_bf16" for
    the bf16 instantiation) from its phase's `results`; its own numbers are
    those of the larger main-path shape the pass runs at."""
    shapes = results[name]["shapes"]
    at = "stage1" if "stage1" in shapes else "stage2"
    return {
        "name": f"convstage_{name}{suffix}", "route": "cuda",
        "source": "spcl_torch/ops/csrc/convstage.cu",
        "replaces": STAGE_REPLACES[name] + (' (dtype_name="bfloat16")' if suffix else ""),
        "launches": launches, "launches_by_path": by_path,
        "max_abs_err": results[name]["max_abs_err"], "ms": shapes[at]["ms"],
        "plain_ms": shapes[at]["plain_ms"],
        **{k: v for k, v in shapes[at].items() if k.startswith("bound_")},
        "library_ms": shapes[at].get("library_ms"),
        "library_why": (f"{shapes[at]['library_call']} computes this pass's convolution, "
                        "not the BN, ReLU, mask or sums around it"
                        if "library_ms" in shapes[at] else STAGE_WHY),
        **({"graph_ms": shapes[at]["graph_ms"]} if "graph_ms" in shapes[at] else {}),
        **({"plan": {f"de {'present' if de else 'absent'}":
                     cs.poolsums_plan(60, 224, 224, 16, True, de,
                                      torch.bfloat16 if suffix else torch.float32)
                     for de in (True, False)}}
           if name == "poolsums" else {}),
        "at": shapes[at]["at"], "shapes": shapes}


# the encoder's BatchNorm + ReLU of a 2N=60 pretrain step (two of each shape
# a stage) and one gradient-cache chunk of 128 views
BNRELU_SHAPES = {"Conv1": (60, 16, 224, 224), "Conv2": (60, 32, 112, 112),
                 "Conv3": (60, 64, 56, 56), "Conv4": (60, 128, 28, 28),
                 "Conv5": (60, 256, 14, 14), "chunk128": (128, 16, 224, 224)}
# float64 sums in another order: the statistics and the backward sums round
# to float32 within a few ulps of the plain versions'
BNRELU_TOL = 1e-6
BNRELU_REPS = 20
BNRELU_CELL_SECONDS = 4
BNRELU_CELLS = ("pretrain-2n60-nhwc", "semi-mt-b32-pallas", "pretrain-2n3840-gradcache")
ENCODER_STAGES = ("Conv1", "Conv2", "Conv3", "Conv4", "Conv5")


def _bnrelu_hold(br, shape, gen):
    """The four kernels against their plain versions on one shape."""
    c = shape[1]
    x = torch.randn(shape, generator=gen, device=DEVICE) * 0.7 + 0.3
    dy = torch.randn(shape, generator=gen, device=DEVICE)
    w = torch.rand(c, generator=gen, device=DEVICE) + 0.5
    b = torch.randn(c, generator=gen, device=DEVICE) * 0.2
    start = (torch.randn(c, generator=gen, device=DEVICE) * 0.1,
             torch.rand(c, generator=gen, device=DEVICE) + 0.5,
             torch.zeros((), dtype=torch.int64, device=DEVICE))
    runs = {}
    for name, fn in (("kernel", br.fwd_stats_kernel), ("plain", br.fwd_stats_plain)):
        running = tuple(t.clone() for t in start)
        runs[name] = (fn(x, running, 0.1, 1e-5, True), running)
    (sk, rk), (sp, rp) = runs["kernel"], runs["plain"]
    torch.testing.assert_close(sk, sp, rtol=BNRELU_TOL, atol=0)
    for a, b_ in zip(rk, rp):
        torch.testing.assert_close(a, b_, rtol=BNRELU_TOL, atol=1e-9)
    y = br.fwd_apply_kernel(x, sk, w, b)
    check(torch.equal(y, br.fwd_apply_plain(x, sk, w, b)), f"bnrelu_fwd_apply at {shape}")
    bk, dwk, dbk = br.bwd_sums_kernel(dy, x, sk, w, b)
    bp, dwp, dbp = br.bwd_sums_plain(dy, x, sk, w, b)
    for a, b_ in ((bk, bp), (dwk, dwp), (dbk, dbp)):
        torch.testing.assert_close(a, b_, rtol=BNRELU_TOL, atol=1e-6 * float(b_.abs().max()))
    dx = br.bwd_apply_kernel(dy, x, sk, bk, w, b)
    check(torch.equal(dx, br.bwd_apply_plain(dy, x, sk, bk, w, b)),
          f"bnrelu_bwd_apply at {shape}")
    return x, dy, w, b


def bnrelu_phase(br):
    """Slice O: the fused BatchNorm + ReLU held to its plain versions, timed
    beside its byte bound and cuDNN, and counted in the benchmark's cells."""
    import torch.nn.functional as F
    phase("slice O: fused BatchNorm + ReLU, float32 NCHW, train mode")
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    rows = {}
    for stage, shape in BNRELU_SHAPES.items():
        x, dy, w, b = _bnrelu_hold(br, shape, gen)
        c = shape[1]
        xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
        rm, rv = torch.zeros(c, device=DEVICE), torch.ones(c, device=DEVICE)
        tracked = torch.zeros((), dtype=torch.int64, device=DEVICE)

        def fused():
            torch.autograd.grad(br.bn_relu(xg, wg, bg, (rm, rv, tracked), momentum=0.1,
                                           eps=1e-5), (xg, wg, bg), dy)

        def cudnn():
            y = F.relu(F.batch_norm(xg, rm, rv, wg, bg, True, 0.1, 1e-5), inplace=True)
            torch.autograd.grad(y, (xg, wg, bg), dy)

        def plain():
            stats = br.fwd_stats_plain(x, (rm, rv, tracked), 0.1, 1e-5, True)
            br.fwd_apply_plain(x, stats, w, b)
            bstats, _, _ = br.bwd_sums_plain(dy, x, stats, w, b)
            br.bwd_apply_plain(dy, x, stats, bstats, w, b)

        rows[stage] = {"shape": list(shape),
                       "bound_ms": 8 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
                       "kernel_ms": _graph_ms(fused, BNRELU_REPS),
                       "plain_ms": _time_ms(plain, 3),
                       "cudnn_ms": _graph_ms(cudnn, BNRELU_REPS)}
        r = rows[stage]
        print(f"{stage} {tuple(shape)}: bound {r['bound_ms']:.4f} ms, kernels "
              f"{r['kernel_ms']:.4f} ms ({100 * r['bound_ms'] / r['kernel_ms']:.1f}% of bound), "
              f"plain {r['plain_ms']:.4f} ms, cuDNN + ReLU {r['cudnn_ms']:.4f} ms; "
              "kernels = plain", flush=True)
        del x, dy, xg
        torch.cuda.empty_cache()
    step = {k: 2 * sum(rows[s][k] for s in ENCODER_STAGES)
            for k in ("bound_ms", "kernel_ms", "plain_ms", "cudnn_ms")}
    print(f"2N=60 step (two of each Conv1..Conv5): bound {step['bound_ms']:.4f} ms, kernels "
          f"{step['kernel_ms']:.4f} ms ({100 * step['bound_ms'] / step['kernel_ms']:.1f}% of "
          f"bound), plain {step['plain_ms']:.4f} ms, cuDNN + ReLU {step['cudnn_ms']:.4f} ms",
          flush=True)
    cells = bnrelu_cells(br)
    print("bnrelu " + json.dumps({"stages": rows, "step": step, "cells": cells}), flush=True)
    return {"stages": rows, "step": step, "cells": cells}


def bnrelu_cells(br):
    """A short run of each benchmark cell: its result, the train step's CUDA
    graph captures and replays, and the BatchNorm + ReLU launches a step."""
    import io
    from portbench import harness
    from spcl_torch.utils import profiling
    out = {}
    for cell in BNRELU_CELLS:
        br.reset_launch_counts()
        profiling.reset_graph_counts()
        torch.cuda.reset_peak_memory_stats()
        res = harness.run_cell(cell, 2 ** 31 + 17, BNRELU_CELL_SECONDS, False,
                               out=io.StringIO(), err=io.StringIO())
        steps = res["attempted"]
        out[cell] = {"correct": res["correct"], "failed": res["failed"], "steps": steps,
                     "samples_per_s": res["metrics"]["samples_per_s"]["value"],
                     "graph": dict(profiling.GRAPH_COUNTS), "launches": dict(br.LAUNCHES),
                     "launches_per_step": {k: v / steps for k, v in br.LAUNCHES.items()},
                     "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                     "max_memory_reserved": torch.cuda.max_memory_reserved()}
        o = out[cell]
        print(f"{cell}: {steps} steps, correct {o['correct']}, failed {o['failed']}, "
              f"{o['samples_per_s']:.1f} slices/s, peak allocated (set-up and window) "
              f"{o['memory_peak_bytes'] / 2 ** 30:.4f} GiB, peak reserved (the run and its "
              f"reference) {o['max_memory_reserved'] / 2 ** 30:.4f} GiB, "
              f"graph captures {o['graph']['captures']} "
              f"replays {o['graph']['replays']}, bnrelu launches a step "
              f"{json.dumps({k: round(v, 3) for k, v in o['launches_per_step'].items()})}",
              flush=True)
        check(res["correct"] and res["failed"] == 0, f"{cell}: {res}")
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ slice P
# the stage shapes of a 2N=60 Swin-Unet pretrain step: (side, heads, shift)
SWIN_SHAPES = ((56, 3, 0), (56, 3, 3), (28, 6, 0), (28, 6, 3), (14, 12, 0), (14, 12, 3),
               (7, 24, 0))
SWIN_VIEWS = 60
SWIN_KERNEL_TOL = 1e-5     # forward, x max|plain|: float32 sums in another order
SWIN_GRAD_TOL = 1e-4       # dqkv and dtable, x max|plain|: longer sums (dtable over windows)
# the whole model on the card against portbench's reference, both float32 with
# TF32 off: features x their max, parameter gradients relative L2
SWIN_MODEL_TOL = 1e-4
SWIN_MODEL_VIEWS = 4
SWIN_GRAPH_STEPS = 3
SWIN_PROFILED = 5
SWIN_REPS = 20


def swin_phase(wa):
    """Slice P: the window-attention kernels at the Swin pretrain step's
    shapes against their plain versions and their bound; the whole Swin-Unet
    forward + backward against the plain reference on the card; graphed Swin
    pretrain steps against eager ones, and the kernels' `LAUNCHES` against
    the profiler's kernel events."""
    from portbench.counts import swin_unet as counts
    from portbench.reference import swin_unet as ref
    from spcl_torch.entry import build_trainer
    from spcl_torch.models import SwinUNet
    from spcl_torch.utils import fix_all_seed
    phase(f"slice P: Swin-Unet window attention (wattn.cu), 2N={SWIN_VIEWS} at 224^2, the "
          "whole model against the plain reference, graphed pretrain steps")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(31)
    scale = 32 ** -0.5
    rows, errs = {}, {"fwd": 0.0, "dqkv": 0.0, "dtable": 0.0}
    for side, heads, shift in SWIN_SHAPES:
        c = 32 * heads
        qkv = torch.randn(SWIN_VIEWS, side, side, 3 * c, device=DEVICE, generator=gen)
        table = torch.randn(169, heads, device=DEVICE, generator=gen)
        index = wa.relative_index(7).to(DEVICE)
        mask = wa.shift_mask(side, side, 7, shift)
        mask = None if mask is None else mask.to(DEVICE)
        why = wa.refusal(qkv, table, heads, 7, shift)
        check(why is None, f"wattn refuses {side} {heads} {shift}: {why}")
        out = wa.fwd_kernel(qkv, table, heads, shift, scale)
        qkv_p, table_p = qkv.clone().requires_grad_(True), table.clone().requires_grad_(True)
        want = wa.fwd_plain(qkv_p, table_p, index, mask, heads, 7, shift, scale)
        dout = torch.randn(out.shape, device=DEVICE, generator=gen)
        got_b = wa.bwd_kernel(qkv, dout, table, heads, shift, scale)
        want_b = torch.autograd.grad(want, (qkv_p, table_p), dout)
        want = want.detach()

        def plain():  # the plain forward and autograd's backward of it, timed eagerly
            o = wa.fwd_plain(qkv_p, table_p, index, mask, heads, 7, shift, scale)
            torch.autograd.grad(o, (qkv_p, table_p), dout)
        again = wa.bwd_kernel(qkv, dout, table, heads, shift, scale)
        err = {"fwd": float((out - want).abs().max() / want.abs().max()),
               "dqkv": float((got_b[0] - want_b[0]).abs().max() / want_b[0].abs().max()),
               "dtable": float((got_b[1] - want_b[1]).abs().max() / want_b[1].abs().max())}
        check(err["fwd"] <= SWIN_KERNEL_TOL and err["dqkv"] <= SWIN_GRAD_TOL
              and err["dtable"] <= SWIN_GRAD_TOL, f"wattn at {side} {heads} {shift}: {err}")
        check(torch.equal(again[0], got_b[0]) and torch.equal(again[1], got_b[1]),
              "wattn backward: two runs differ")
        for k in errs:
            errs[k] = max(errs[k], err[k])
        bound_f, bound_b = counts.attention_bound_s(side * side, c, 49, SWIN_VIEWS)
        r = {"bound_fwd_ms": bound_f * 1e3, "bound_bwd_ms": bound_b * 1e3,
             "fwd_ms": _graph_ms(lambda: wa.fwd_kernel(qkv, table, heads, shift, scale),
                                 SWIN_REPS),
             "bwd_ms": _graph_ms(lambda: wa.bwd_kernel(qkv, dout, table, heads, shift, scale),
                                 SWIN_REPS),
             "plain_fwd_ms": _graph_ms(lambda: wa.fwd_plain(qkv, table, index, mask, heads, 7,
                                                            shift, scale), 3),
             "plain_ms": _time_ms(plain, 3),
             **err}
        rows[f"{side}x{side}x{c} shift {shift}"] = r
        print(f"wattn {side}^2 x {c} ({heads} heads) shift {shift}: fwd {r['fwd_ms']:.4f} ms "
              f"({100 * r['bound_fwd_ms'] / r['fwd_ms']:.1f}% of {r['bound_fwd_ms']:.4f}), bwd "
              f"{r['bwd_ms']:.4f} ms ({100 * r['bound_bwd_ms'] / r['bwd_ms']:.1f}% of "
              f"{r['bound_bwd_ms']:.4f}); plain forward {r['plain_fwd_ms']:.4f}, with autograd's "
              f"backward {r['plain_ms']:.4f} ms; err fwd {err['fwd']:.1e} dqkv {err['dqkv']:.1e} "
              f"dtable {err['dtable']:.1e}; two backwards bit-equal", flush=True)
        del qkv, qkv_p, table_p, dout, out, want, got_b, want_b, again
    # a step's eight blocks: one of each row, two of stage 4's unshifted one
    step = {k: sum(r[k] for r in rows.values()) + rows["7x7x768 shift 0"][k]
            for k in ("bound_fwd_ms", "bound_bwd_ms", "fwd_ms", "bwd_ms", "plain_fwd_ms",
                      "plain_ms")}
    bound, kernel = step["bound_fwd_ms"] + step["bound_bwd_ms"], step["fwd_ms"] + step["bwd_ms"]
    print(f"wattn, a 2N={SWIN_VIEWS} step's eight blocks: kernels {kernel:.4f} ms against the "
          f"bound {bound:.4f} ms ({100 * bound / kernel:.1f}%), plain "
          f"{step['plain_ms']:.4f} ms", flush=True)

    # the whole model, decoder too, against the reference (TF32 off)
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    try:
        torch.manual_seed(32)
        model = SwinUNet().to(DEVICE).train()
        x = torch.rand(SWIN_MODEL_VIEWS, 1, 224, 224, device=DEVICE, generator=gen)
        acts = model(x)
        w = {k: v.detach().clone().requires_grad_(True) for k, v in model.named_parameters()}
        shape = dict(ref.PUBLISHED, img_size=224)
        want = ref.forward(x, w, shape)
        feat_err = {k: float((acts[k] - want[k]).detach().abs().max() / want[k].abs().max())
                    for k in model.ARCH_ELEMENTS}
        cot = torch.randn(acts["logits"].shape, device=DEVICE, generator=gen)
        names = [k for k, _ in model.named_parameters()]
        g = torch.autograd.grad(acts["logits"], list(model.parameters()), cot)
        gr = torch.autograd.grad(want["Final"], [w[k] for k in names], cot)
        grad_err = max(float(torch.linalg.vector_norm(a - c) / torch.linalg.vector_norm(c))
                       for a, c in zip(g, gr))
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved
    print(f"Swin-Unet (published widths, {SWIN_MODEL_VIEWS} views, TF32 off) against the "
          f"reference: features and logits x max {max(feat_err.values()):.2e} ({feat_err}), "
          f"parameter gradients relative L2 {grad_err:.2e} (tol {SWIN_MODEL_TOL})", flush=True)
    check(max(feat_err.values()) <= SWIN_MODEL_TOL and grad_err <= SWIN_MODEL_TOL,
          "slice P: the model disagrees with the reference")
    del model, acts, want, w, g, gr
    torch.cuda.empty_cache()

    out_dir = ROOT / "runs" / "chip_smoke_p"
    shutil.rmtree(out_dir, ignore_errors=True)
    config = copy.deepcopy(CONFIG)
    config["Arch"] = {"name": "swin_unet", "input_dim": 1, "num_classes": 4, "dtype": "float32",
                      "checkpoint": None}
    config["SPInfonceParams"]["feature_names"] = "Swin4"
    torch.manual_seed(33)
    start = SwinUNet().state_dict()

    def make_trainer():
        cfg = copy.deepcopy(config)
        cfg["Trainer"].update(max_epoch=1, num_batches=SWIN_GRAPH_STEPS,
                              save_dir=str(out_dir / "graphed"))
        fix_all_seed(cfg["RandomSeed"])
        trainer = build_trainer(cfg, save_dir=str(out_dir / "graphed"), pretrain=True,
                                device=DEVICE)
        trainer._model.load_state_dict(start)
        trainer.init()
        return trainer
    graphed = _graphed_against_eager("slice P Swin-Unet", make_trainer, SWIN_GRAPH_STEPS)
    check(graphed["loss_rel"] == 0.0 and graphed["state_rel"] == 0.0,
          f"slice P: graphed and eager steps not bit-equal {graphed}")
    trainer = make_trainer()
    run = _pretrain_epochs(trainer)
    run(2)
    kernels, launches = _launches_against_profile("slice P Swin-Unet profiled", run,
                                                  SWIN_PROFILED)
    check(all(launches.get(k) == 8 for k in wa.KERNELS), f"slice P launches {launches}")
    ms = run(10)
    prof = _print_profile("slice P Swin-Unet pretrain step", kernels, ms, top=10)
    del trainer
    torch.cuda.empty_cache()
    print("swin " + json.dumps({"rows": rows, "step": step, "errs": errs,
                                "model_feat_err": feat_err, "model_grad_err": grad_err,
                                "graphed": graphed, "launches": launches, "step_ms": ms,
                                "kernel_ms": prof[0] if prof else None,
                                "phase_s": time.perf_counter() - t0}), flush=True)
    return {"rows": rows, "step": step, "errs": errs, "graphed": graphed, "launches": launches}


def main():
    if sys.argv[1:2] == ["--slice-l-rank"]:  # a process of slice L (b)
        slice_l_rank(sys.argv[2], int(sys.argv[3]))
        return
    smi = device_phase()
    sys.path.insert(0, str(ROOT))
    from spcl_torch.ops import bnrelu_cuda as br
    from spcl_torch.ops import convstage_cuda as cs
    from spcl_torch.ops import supcon_cuda as sc
    from spcl_torch.ops import wattn_cuda as wa

    build_phase(sc, cs, br, wa)
    supcon_plans(sc)
    if "--bnrelu-only" in sys.argv[1:]:
        bnrelu_phase(br)
        return
    if "--swin-only" in sys.argv[1:]:
        swin_phase(wa)
        return
    if "--stage-kernels-only" in sys.argv[1:]:  # development aids: one phase
        stage_kernel_phase(cs)
        stage_kernel_phase(cs, torch.bfloat16)
        return
    if "--bf16-only" in sys.argv[1:]:
        stage_kernel_phase(cs, torch.bfloat16)
        slice_h_phase(sc, cs)
        return
    if "--supcon-kernels-only" in sys.argv[1:]:
        kernel_phase(sc)
        strip_kernel_phase(sc)
        return
    if "--mesh-only" in sys.argv[1:]:
        strip_kernel_phase(sc)
        nccl_phase(sc)
        slice_c_phase(sc)
        return
    if "--bigbatch-only" in sys.argv[1:]:
        slice_d_phase(sc)
        return
    if "--semi-only" in sys.argv[1:]:
        slice_e_phase(cs)
        preset_phase(sc)
        semi_parity_phase(cs)
        return
    if "--decoder-adv-only" in sys.argv[1:]:
        slice_f_phase(sc, cs)
        slice_g_phase(sc, cs)
        adv_parity_phase(cs)
        return
    if "--serving-only" in sys.argv[1:]:
        slice_i_phase()
        return
    if "--semi-mesh-only" in sys.argv[1:]:
        slice_j_phase(sc, cs)
        return
    if "--effect-only" in sys.argv[1:]:
        slice_k_phase(sc)
        return
    if "--multihost-only" in sys.argv[1:]:
        slice_l_phase(sc)
        return
    if "--packed-only" in sys.argv[1:]:
        slice_m_phase(sc)
        return
    if "--surface-only" in sys.argv[1:]:
        slice_n_phase(sc, cs, smi)
        return
    max_err, timings = kernel_phase(sc)
    stage = stage_kernel_phase(cs)
    stage_bf16 = stage_kernel_phase(cs, torch.bfloat16)
    launches, thr, trainer_a = slice_phase(sc)
    stage_launches, trainer_b = slice_b_phase(sc, cs)
    steps = profile_phase(trainer_a, trainer_b)
    del trainer_a, trainer_b
    torch.cuda.empty_cache()
    stage_region_phase()
    step_parity_phase()
    finetune_parity_phase(cs)
    strip_err, strip_shapes = strip_kernel_phase(sc)
    nccl_phase(sc)
    launches_c, steps_c = slice_c_phase(sc)
    torch.cuda.empty_cache()
    slice_d = slice_d_phase(sc)
    torch.cuda.empty_cache()
    slice_e = slice_e_phase(cs)
    preset_launches, preset_err = preset_phase(sc)
    semi_parity_phase(cs)
    slice_f = slice_f_phase(sc, cs, ROOT / "runs" / "chip_smoke_b" / "pre" / "last.ckpt")
    slice_g = slice_g_phase(sc, cs)
    adv_parity_phase(cs)
    torch.cuda.empty_cache()
    slice_h = slice_h_phase(sc, cs, float32={"pallas": steps["pallas_true"],
                                             "nhwc": steps["nhwc_true"]})
    torch.cuda.empty_cache()
    slice_i = slice_i_phase(ROOT / "runs" / "chip_smoke_b" / "pre" / "last.ckpt")
    torch.cuda.empty_cache()
    slice_j = slice_j_phase(sc, cs)
    torch.cuda.empty_cache()
    slice_k = slice_k_phase(sc)
    torch.cuda.empty_cache()
    slice_l = slice_l_phase(sc)
    torch.cuda.empty_cache()
    slice_m = slice_m_phase(sc)
    torch.cuda.empty_cache()
    slice_n = slice_n_phase(sc, cs, smi)
    torch.cuda.empty_cache()
    slice_o = bnrelu_phase(br)
    torch.cuda.empty_cache()
    slice_p = swin_phase(wa)

    main_t = timings[MAIN_2N]
    replaces = {
        "supcon_fwd": "spcl_tpu/ops/supcon_pallas.py:121 _denom_kernel + :142 _loss_kernel",
        "supcon_bwd": "spcl_tpu/ops/supcon_pallas.py:167 _bwd_kernel",
    }
    kernels = [{"name": name, "route": "cuda", "source": "spcl_torch/ops/csrc/supcon.cu",
                "replaces": replaces[name],
                "launches": (launches[name] + stage_launches[name] + launches_c[name]
                             + slice_d["launches"][name] + preset_launches[name]
                             + sum(v[name] for v in slice_f["launches"].values())
                             + slice_j["launches"][name] + slice_k["launches"][name]
                             + slice_l["launches"][name] + slice_l["rank_launches"][name]
                             + slice_m["launches"][name] + slice_m["nhwc_launches"][name]),
                "launches_by_path": {"slice_a": launches[name], "slice_b": stage_launches[name],
                                     "slice_c_rank_0": launches_c[name],
                                     "slice_d": slice_d["launches"][name],
                                     "slice_e": preset_launches[name],
                                     **{_f_path(run): v[name]
                                        for run, v in slice_f["launches"].items()
                                        if run != "finetune"},
                                     "slice_j_rank_0": slice_j["launches"][name],
                                     "slice_k": slice_k["launches"][name],
                                     "slice_l": slice_l["launches"][name],
                                     "slice_l_rank_0": slice_l["rank_launches"][name],
                                     "slice_m": slice_m["launches"][name],
                                     "slice_m_nhwc": slice_m["nhwc_launches"][name]},
                "max_abs_err": max(max_err[name], strip_err[name], preset_err[name],
                                   slice_f["max_err"][name], slice_j["max_err"][name],
                                   slice_k["max_err"][name], slice_l["max_err"][name],
                                   slice_l["rank_max_err"][name], slice_m["max_err"][name]),
                "ms": main_t[name]["ms"],
                "plain_ms": main_t[name]["plain_ms"], "bound_ms": main_t[name]["bound_ms"],
                "bound_by": main_t[name]["bound_by"],
                **{k: main_t[name][k] for k in ("bound_f32_ms", "bound_3xtf32_ms")},
                "library_ms": main_t[name]["library_ms"],
                "library_call": main_t[name]["library_call"],
                "library_why": (f"{main_t[name]['library_call']} computes the pass's products "
                                "only, not the masks, exp, weights or row sums around them"),
                "plan": main_t[name]["plan"], "at": f"2N={MAIN_2N}, D={D}",
                "sizes": {str(n2): v[name] for n2, v in timings.items()},
                "shapes": {at: v[name] for at, v in strip_shapes.items()}}
               for name in ("supcon_fwd", "supcon_bwd")]
    for name in cs.PASSES:
        key = f"convstage_{name}"
        kernels.append(_stage_entry(cs, name, "", stage, (
            stage_launches[key] + slice_e["pallas"]["launches"][key]
            + sum(v[key] for v in slice_f["launches"].values())
            + sum(v[key] for v in slice_g["launches"].values())), {
            "slice_b": stage_launches[key],
            "slice_e": slice_e["pallas"]["launches"][key],
            "slice_e_teacher": slice_e["pallas"]["teacher"].get(key, 0),
            **{_f_path(run): v[key] for run, v in slice_f["launches"].items() if run != "nhwc"},
            "slice_g": slice_g["launches"]["pallas"][key],
            "slice_g_resume": slice_g["launches"]["resume"][key]}))
        by_path = {path: v[f"{key}_bf16"] for path, v in slice_h["launches_by_path"].items()}
        kernels.append(_stage_entry(cs, name, "_bf16", stage_bf16, by_path["slice_h"],
                                    by_path))
    for name in br.PASSES:
        key = f"bnrelu_{name}"
        by_path = {"slice_m_" + k: v["launches"].get(key, 0) for k, v in slice_m["graphed"].items()}
        by_path.update({cell: v["launches"][key] for cell, v in slice_o["cells"].items()})
        kernels.append({
            "name": key, "route": "cuda", "source": "spcl_torch/ops/csrc/bnrelu.cu",
            "replaces": ("none in spcl_tpu (TorchBatchNorm + relu, spcl_tpu/models/norm.py:39, "
                         "which XLA fuses); on the card cuDNN's NCHW BatchNorm + ReLU"),
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": f"within BNRELU_TOL ({BNRELU_TOL}) of the plain versions; the apply "
                           "passes bit-equal",
            "ms_four_kernels": {st: r["kernel_ms"] for st, r in slice_o["stages"].items()},
            "plain_ms_four": {st: r["plain_ms"] for st, r in slice_o["stages"].items()},
            "bound_ms_four": {st: r["bound_ms"] for st, r in slice_o["stages"].items()},
            "library_ms_four": {st: r["cudnn_ms"] for st, r in slice_o["stages"].items()},
            "library_call": "F.batch_norm + F.relu(inplace=True), forward + backward (cuDNN)",
            "step": slice_o["step"], "at": "per stage, the four kernels of one BatchNorm + ReLU "
                                           "together; step: a 2N=60 step's ten"})
    for name in wa.KERNELS:
        kernels.append({
            "name": name, "route": "cuda", "source": "spcl_torch/ops/csrc/wattn.cu",
            "replaces": "none in spcl_tpu (no transformer); the plain PyTorch window attention",
            "launches_by_path": {"slice_p": slice_p["launches"].get(name, 0)},
            "max_rel_err": slice_p["errs"], "rows": slice_p["rows"],
            "step": slice_p["step"], "at": "2N=60 Swin-Unet pretrain step, forward + backward"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(f"device: {smi} | slice A (nhwc) {1e3 / steps['nhwc_ms']:.3f} steps/s, "
          f"{VIEWS * 1e3 / steps['nhwc_ms']:.1f} slices/s ({steps['nhwc_ms']:.3f} ms/step) | "
          f"slice B pretrain step (pallas) {1e3 / steps['pallas_ms']:.3f} steps/s, "
          f"{VIEWS * 1e3 / steps['pallas_ms']:.1f} slices/s ({steps['pallas_ms']:.3f} ms/step), "
          f"steady state | slice C (2N=126, {RANKS_C} ranks over {steps_c['backend']}"
          f"{', one shared card' if steps_c['shared_card'] else ''}) "
          f"{1e3 / steps_c['mesh_ms']:.3f} steps/s ({steps_c['mesh_ms']:.3f} ms/step) beside "
          f"the single process {1e3 / steps_c['single_ms']:.3f} steps/s "
          f"({steps_c['single_ms']:.3f} ms/step) | slice D (2N={slice_d['views']}, grad_cache "
          f"30) {slice_d['ms']:.1f} ms/step, {slice_d['views'] * 1e3 / slice_d['ms']:.1f} "
          f"slices/s, peak {slice_d['peak_bytes'] / 2**30:.2f} GiB, store "
          f"{slice_d['store_bytes'] / 2**20:.1f} MiB | slice E semi step (32 + 2 x 32 "
          f"slices) pallas {slice_e['pallas']['ms']:.3f} ms/step, "
          f"{96e3 / slice_e['pallas']['ms']:.1f} slices/s, nhwc "
          f"{slice_e['nhwc']['ms']:.3f} ms/step, {96e3 / slice_e['nhwc']['ms']:.1f} slices/s | "
          f"slice F decoder pretrain step (2N={DENSE_2N}) pallas "
          f"{slice_f['pallas']['steady_ms']:.3f} ms/step, "
          f"{DECODER_VIEWS * 1e3 / slice_f['pallas']['steady_ms']:.1f} slices/s, nhwc "
          f"{slice_f['nhwc']['steady_ms']:.3f} ms/step | slice G adversarial step (5 + 5 "
          f"slices) pallas {slice_g['ms']:.3f} ms/step, "
          f"{ADV_SLICES * 1e3 / slice_g['ms']:.1f} slices/s | slice H bf16 pretrain step "
          f"pallas {slice_h['pallas']['ms']:.3f} ms/step, "
          f"{VIEWS * 1e3 / slice_h['pallas']['ms']:.1f} slices/s, nhwc "
          f"{slice_h['nhwc']['ms']:.3f} ms/step | slice I inference "
          f"{slice_i['inference']['forward_ms_per_scan']:.3f} ms per scan (forward) + "
          f"{slice_i['inference']['meters_ms_per_scan']:.3f} (meters), served batch 32 "
          f"float32 {slice_i['serving']['float32']['rows'][32]['pred']['slices_per_s']:.1f} "
          f"slices/s, bf16 "
          f"{slice_i['serving']['bfloat16']['rows'][32]['pred']['slices_per_s']:.1f} slices/s | "
          f"slice J semi step (32 + 2 x 32 slices, {RANKS_J} ranks over {slice_j['backend']}"
          f"{', one shared card' if slice_j['shared_card'] else ''}) "
          f"{slice_j['mesh_ms']:.3f} ms/step beside the single process "
          f"{slice_j['single_ms']:.3f} | slice K effect study (UNet-128, 48^2, 2N=60) "
          f"pretrain {slice_k['records']['spsoft_corrupt']['pre_ms_per_step']:.3f} ms/step, "
          f"fine-tune {slice_k['records']['spsoft_corrupt']['ft_ms_per_step']:.3f} ms/step, "
          f"phase {slice_k['phase_s']:.1f} s | slice L infoncepretrain (2N={MAIN_2N}) "
          f"{slice_l['a_s']:.1f} s, {SLICE_L_RANKS} ranks started by hand over "
          f"{slice_l['backend']} on {', '.join(slice_l['devices'])} {slice_l['b_s']:.1f} s "
          f"(NCCL across hosts not shown: one host) | slice M pretrain step (TF32 off) packed "
          f"{slice_m['ms']['packed']:.3f} ms/step ({slice_m['kernel_ms']['packed']:.3f} of "
          f"kernels), nhwc {slice_m['ms']['nhwc']:.3f} ({slice_m['kernel_ms']['nhwc']:.3f}) | "
          f"slice N Sobel {slice_n['ms']['sobel_process']:.4f} ms, dense head max-pooled "
          f"10x10 fwd+bwd {slice_n['ms']['DenseProjectionHead 10x10 fwd+bwd']:.3f} ms | "
          f"slice O BatchNorm + ReLU of a 2N=60 step {slice_o['step']['kernel_ms']:.3f} ms "
          f"(bound {slice_o['step']['bound_ms']:.3f}, cuDNN {slice_o['step']['cudnn_ms']:.3f}) "
          f"| slice P window attention of a Swin step "
          f"{slice_p['step']['fwd_ms'] + slice_p['step']['bwd_ms']:.3f} ms (bound "
          f"{slice_p['step']['bound_fwd_ms'] + slice_p['step']['bound_bwd_ms']:.3f})",
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
